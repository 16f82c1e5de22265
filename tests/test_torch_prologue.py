"""The step kernel's prologue inputs on the CPU: the emitter rows' offset
that the warp's cadence derives from the type count (so its prologue reads
the emitter rows without first reading the table's header), and the
plain step and render pack of a spawner of uneven curves against the JAX
package (the plain version the card's render pack is held to)."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from bevy_firework_tpu.render import pack_instances_dense as jax_pack_instances_dense
from bevy_firework_tpu.step import step_jit
from bevy_firework_tpu_torch import interop
from bevy_firework_tpu_torch.ops import fused_step as fs
from bevy_firework_tpu_torch.ops import table_layout as L
from bevy_firework_tpu_torch.render import pack_render_planes
from test_torch_common import _one_torch_thread, jax_pool_numpy  # noqa: F401

sys.path.insert(0, str(Path(__file__).parent))
import torch_table_configs as table_cfg  # noqa: E402


@pytest.mark.parametrize("spawner", ["types9", "two_types"])
def test_emitter_rows_start_where_the_warp_cadence_derives(spawner):
    """The warp's cadence (fused_step_kernel_warp) takes the first emitter
    row as TY_AT + n_types * TY_STRIDE instead of reading the header: the
    packed table's H_EM_AT is that offset, and each emitter's row there
    holds its pacing and count."""
    sp = table_cfg.caps_spawner("types9") if spawner == "types9" else table_cfg.two_type_curves_spawner()
    c = pt.compile_spawner(sp, device="cpu")
    w = fs.pack_tables(c.static, c.params)
    fl = w.view(np.float32)
    em_at = L.TY_AT + c.num_types * L.TY_STRIDE
    assert int(w[L.H_EM_AT]) == em_at and int(w[L.H_T]) == c.num_types
    count = c.params.to_numpy()["count"]
    for e in range(c.num_emitters):
        row = em_at + e * L.EM_STRIDE
        assert int(w[row + L.EM_PACING]) == int(c.static.pacing_kinds[e])
        assert fl[row + L.EM_COUNT] == np.float32(count[e])


TS = (0.0, 0.2, 0.45, 0.7, 1.0)


def _uneven_spawner(pkg):
    """A box emitter and an uneven scale curve, base and emissive gradient."""
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(
            lifetime=pkg.RandF32.constant(0.5), initial_scale=pkg.RandF32(0.02, 0.08),
            scale_curve=pkg.FireworkCurve.uneven_samples([(t, 1.0 + 0.5 * math.sin(3 * t)) for t in TS]),
            base_color=pkg.gradient_uneven_samples([(t, (1.0 - t, 0.5 * t, 0.2, 1.0 - 0.5 * t)) for t in TS]),
            emissive_color=pkg.gradient_uneven_samples([(t, (0.3 * t, 0.1, 1.0 - t, 1.0)) for t in TS[1:]]),
            acceleration=(0.0, -9.81, 0.0))],
        emission_settings=[pkg.EmissionSettings(
            emission_pacing=pkg.EmissionPacing.rate(3000.0), emission_shape=pkg.EmissionShape.box((1.5, 0.5, 1.5)),
            initial_velocity=pkg.RandVec3(pkg.RandF32(0.5, 3.0), (0.0, 1.0, 0.0), 0.0))],
    )


def test_plain_pack_of_uneven_curves_matches_jax():
    """The plain step and render pack (which the kernel's render pack is
    held to on the card) of a spawner whose three curves are uneven,
    against the JAX package on a state it stepped: positions exact, the
    curve planes within the 1 ulp of XLA's contracted lerp (as
    test_torch_render.py)."""
    cj, cp = jx.compile_spawner(_uneven_spawner(jx)), pt.compile_spawner(_uneven_spawner(pt), device="cpu")
    sj = jx.init_pool_for(cj, 4096, 0)
    fj = jx.make_frame_input(1 / 60)
    for _ in range(30):
        sj, _o = step_jit(cj.static, cj.params, None, sj, fj)
    sp = interop.pool_from_numpy(jax_pool_numpy(sj), device="cpu")
    want, count = jax_pack_instances_dense(cj.params, sj, 0)
    want = np.asarray(want)
    planes = pack_render_planes(cp.static, cp.params, sp)
    alive = sp.alive.numpy()
    assert int(count) == int(alive.sum()) > 50
    tol = dict(rtol=float(np.finfo(np.float32).eps), atol=float(np.spacing(np.float32(2.0))))
    np.testing.assert_allclose(planes[0].numpy(), want[3], **tol)
    for ch in range(8):
        np.testing.assert_allclose(planes[1 + ch].numpy()[alive], want[8 + ch][alive], **tol)
    for i, k in enumerate(("px", "py", "pz")):
        np.testing.assert_array_equal(getattr(sp, k).numpy(), want[i])
