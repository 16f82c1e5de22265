"""Authoring and lowering: the port lowers every spawner of the slice to the
same SpawnerStatic and the same parameter tables as the JAX package."""

import json

import numpy as np
import pytest

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from bevy_firework_tpu.settings import spawner_to_json as jax_spawner_to_json
from test_torch_common import PARAM_FIELDS, det_spawner, effect, jax_params_numpy  # noqa: F401
from test_torch_common import _one_torch_thread  # noqa: F401

EFFECTS = ["sparks", "stress_test", "one_shot", "on_demand"]


def _pair(name):
    if name == "det_spawner":
        return det_spawner(jx), det_spawner(pt)
    return effect("jax", name)[0], effect("torch", name)[0]


@pytest.mark.parametrize("name", EFFECTS + ["det_spawner"])
def test_static_and_params_equal(name):
    spj, spp = _pair(name)
    cj, cp = jx.compile_spawner(spj), pt.compile_spawner(spp, device="cpu")
    assert cj.static.__dict__ == cp.static.__dict__
    for prop in ("single_type", "ring_claim", "derived_alive", "any_collision", "any_destroyed_dump"):
        assert getattr(cj.static, prop) == getattr(cp.static, prop), prop
    pj, pp = jax_params_numpy(cj.params), cp.params.to_numpy()
    assert sorted(pj) == sorted(pp) == sorted(PARAM_FIELDS)
    for k in PARAM_FIELDS:
        assert pj[k].shape == pp[k].shape, k
        np.testing.assert_array_equal(pj[k].astype(pp[k].dtype), pp[k], err_msg=k)
    for k in ("starts_enabled", "blend_modes", "pbr_flags", "fade_edges", "fade_scenes", "textures"):
        assert getattr(cj, k) == getattr(cp, k), k


@pytest.mark.parametrize("name", EFFECTS)
def test_effect_transforms_equal(name):
    assert effect("jax", name)[1].__dict__ == effect("torch", name)[1].__dict__


@pytest.mark.parametrize("name", EFFECTS + ["det_spawner"])
def test_jax_written_json_loads_in_port(name):
    spj, spp = _pair(name)
    text = jax_spawner_to_json(spj)
    loaded = pt.spawner_from_json(text)
    assert loaded == spp
    assert json.loads(pt.spawner_to_json(loaded)) == json.loads(text)


def test_main_path_archetypes_share_one_kernel_configuration():
    """sparks, stress_test, one_shot and on_demand all take the fused path
    with 8 active f32 planes (rotation and lifetime elided)."""
    from bevy_firework_tpu_torch.ops.fused_step import can_unroll
    from bevy_firework_tpu_torch.step import active_f32_fields

    for name in EFFECTS:
        c = pt.compile_spawner(effect("torch", name)[0], device="cpu")
        assert can_unroll(c.static) and c.static.single_type and c.static.elide_rotation
        assert c.static.const_lifetime is not None
        assert active_f32_fields(c.static) == ("px", "py", "pz", "vx", "vy", "vz", "initial_scale", "age")
