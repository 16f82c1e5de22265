"""The render contract of the slice: the port's dense pack, its render-pack
planes and its 64-byte rows against the JAX package, on a state the JAX
package stepped and carried over."""

import numpy as np
import pytest
import torch

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from bevy_firework_tpu.render import instances_to_bytes as jax_instances_to_bytes
from bevy_firework_tpu.render import make_uniform as jax_make_uniform
from bevy_firework_tpu.render import pack_instances_dense as jax_pack_instances_dense
from bevy_firework_tpu.render import planes_to_rows as jax_planes_to_rows
from bevy_firework_tpu.step import step_jit
from bevy_firework_tpu_torch import interop
from bevy_firework_tpu_torch.render import pack_render_planes
from test_torch_common import _one_torch_thread, effect, jax_pool_numpy  # noqa: F401

# planes whose values come from a curve lerp: XLA on the CPU contracts
# `v0 + (v1 - v0) * frac` into an FMA, the port rounds twice (1 ulp)
CURVE_PLANES = (3, 8, 9, 10, 11, 12, 13, 14, 15)


def _carried(name, rate, frames=40, n=8192):
    spj, tfj = effect("jax", name, rate)
    spp, _tf = effect("torch", name, rate)
    cj, cp = jx.compile_spawner(spj), pt.compile_spawner(spp, device="cpu")
    sj = jx.init_pool_for(cj, n, 0)
    fj = jx.make_frame_input(1 / 60, translation=tfj.translation)
    for _ in range(frames):
        sj, _o = step_jit(cj.static, cj.params, None, sj, fj)
    return cj, cp, sj, interop.pool_from_numpy(jax_pool_numpy(sj), device="cpu")


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=float(np.finfo(np.float32).eps), atol=float(np.spacing(np.float32(150.0))))


@pytest.mark.parametrize("name,rate", [("sparks", None), ("stress_test", 6000.0)])
def test_dense_pack_matches_jax(name, rate):
    cj, cp, sj, sp = _carried(name, rate)
    want, count_j = jax_pack_instances_dense(cj.params, sj, 0)
    got, count_p = pt.pack_instances_dense(cp.params, sp, 0)
    want, got = np.asarray(want), got.numpy()
    assert int(count_p) == int(count_j) > 0
    for i in range(16):
        if i in CURVE_PLANES:
            _close(got[i], want[i])
        else:
            np.testing.assert_array_equal(got[i], want[i], err_msg=str(i))


def test_render_pack_planes_equal_dense_pack():
    """The plain version of the kernel's render-pack block is the dense pack's
    scale and color planes (base alpha is not zeroed on dead lanes there;
    the zero scale marks them)."""
    _cj, cp, _sj, sp = _carried("sparks", None)
    dense, _n = pt.pack_instances_dense(cp.params, sp, 0)
    planes = pack_render_planes(cp.static, cp.params, sp)
    assert len(planes) == 9
    assert torch.equal(planes[0], dense[3])
    alive = sp.alive
    for c in range(8):
        assert torch.equal(planes[1 + c][alive], dense[8 + c][alive])


def test_rows_and_bytes_match_jax():
    cj, cp, sj, sp = _carried("sparks", None, frames=60)
    dense_j, _n = jax_pack_instances_dense(cj.params, sj, 0)
    dense_j = np.asarray(dense_j)
    rows_j = jax_planes_to_rows(cj.static, sj, [dense_j[3]] + [dense_j[8 + c] for c in range(8)])
    rows_p = pt.planes_to_rows(cp.static, sp, pack_render_planes(cp.static, cp.params, sp))
    assert rows_p.shape == rows_j.shape == (750, 16)
    b_p, b_j = pt.instances_to_bytes(rows_p), jax_instances_to_bytes(rows_j)
    assert len(b_p) == len(b_j) == 750 * 64
    # position and rotation bytes identical; curve-derived columns within 1 ulp
    pos_rot = [0, 1, 2, 4, 5, 6, 7]
    assert rows_p[:, pos_rot].tobytes() == rows_j[:, pos_rot].tobytes()
    _close(rows_p, rows_j)
    for t in range(cj.num_types):
        assert pt.make_uniform(cp, t).to_bytes() == jax_make_uniform(cj, t).to_bytes()
