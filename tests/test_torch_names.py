"""The port's top-level names against the JAX package's `__all__`, and the
JAX package's multi-frame entry points (`multi_step`, `step_jit`) and
cadence functions through the port, on the CPU."""

import numpy as np
import pytest
import torch

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from test_torch_common import _one_torch_thread, det_spawner  # noqa: F401

# The JAX package's names the port does not carry yet (none since the
# lights, shaders, physics-sync and viewer modules were copied).
NOT_YET_PORTED = frozenset()


def test_reference_names_resolve_in_the_port():
    """Every name of the JAX package's __all__ resolves in the port but the
    listed ones, and none of the listed ones does (so the list shrinks as
    they are ported); the port's own __all__ names only what it has."""
    missing = {n for n in jx.__all__ if not hasattr(pt, n)}
    assert missing == NOT_YET_PORTED, (sorted(missing - NOT_YET_PORTED), sorted(NOT_YET_PORTED - missing))
    assert NOT_YET_PORTED <= set(jx.__all__)
    assert all(hasattr(pt, n) for n in pt.__all__) and len(set(pt.__all__)) == len(pt.__all__)
    assert set(jx.__all__) - NOT_YET_PORTED <= set(pt.__all__)


def test_multi_step_and_step_jit():
    """multi_step: n frames of one frame input, the final state and the
    last frame's outputs, == n steps; multi_step below one frame raises
    ValueError; the deterministic spawner's counts and positions equal the
    JAX package's multi_step; and on a random config (sparks: random
    shape, speed and scale draws) multi_step and step_jit equal the JAX
    package's lane for lane (the XLA layout: threefry draws per emitter)."""
    from test_torch_common import effect

    c = pt.compile_spawner(det_spawner(pt), device="cpu")
    s0 = pt.init_pool_for(c, 1024, seed=3)
    f = pt.make_frame_input(1 / 50)
    st, out = pt.multi_step(c.static, c.params, None, s0, f, 9)
    ref = s0
    for _ in range(9):
        ref, ref_out = pt.step(c.static, c.params, None, ref, f)
    for k in ("px", "vy", "age", "alive", "ring_cursor", "time_in_cycle"):
        assert torch.equal(getattr(st, k), getattr(ref, k)), k
    assert int(out.alive_count) == int(ref_out.alive_count) > 0
    with pytest.raises(ValueError, match="n_frames >= 1"):
        pt.multi_step(c.static, c.params, None, s0, f, 0)
    cj = jx.compile_spawner(det_spawner(jx))
    sj, oj = jx.multi_step(cj.static, cj.params, None, jx.init_pool_for(cj, 1024, 3), jx.make_frame_input(1 / 50), 9)
    assert int(oj.alive_count) == int(out.alive_count)
    live = np.asarray(sj.alive)
    np.testing.assert_array_equal(st.alive.numpy(), live)
    np.testing.assert_allclose(st.px.numpy()[live], np.asarray(sj.px)[live], atol=1e-4, rtol=0)

    (spj, tfj), (spp, tfp) = effect("jax", "sparks"), effect("torch", "sparks")
    cj, cp = jx.compile_spawner(spj), pt.compile_spawner(spp, device="cpu")
    fj = jx.make_frame_input(1 / 60, translation=tfj.translation)
    fp = pt.make_frame_input(1 / 60, translation=tfp.translation)
    sj, oj = jx.multi_step(cj.static, cj.params, None, jx.init_pool_for(cj, 1024, 5), fj, 12)
    sp, op = pt.multi_step(cp.static, cp.params, None, pt.init_pool_for(cp, 1024, 5), fp, 12)
    sj, oj = jx.step_jit(cj.static, cj.params, None, sj, fj)
    sp, op = pt.step_jit(cp.static, cp.params, None, sp, fp)
    assert int(op.alive_count) == int(oj.alive_count) == 216
    live = np.asarray(sj.alive)
    np.testing.assert_array_equal(sp.alive.numpy(), live)
    np.testing.assert_array_equal(sp.rng_key.numpy().astype(np.uint32), np.asarray(sj.rng_key))
    for k in ("px", "py", "pz", "vx", "vy", "vz", "initial_scale"):
        # XLA's FMA contractions and sin/cos polynomials on the CPU
        np.testing.assert_allclose(getattr(sp, k).numpy()[live], np.asarray(getattr(sj, k))[live], atol=2e-5,
                                   rtol=1e-5, err_msg=k)


def test_emission_count_names():
    """The cadence functions the JAX package exports at the top level: the
    port's torch and numpy versions agree with the JAX package's numpy
    oracle on seeded inputs."""
    rng = np.random.default_rng(11)
    for _ in range(200):
        args = (np.float32(rng.uniform(0, 2)), np.float32(rng.uniform(0, 1)), np.float32(rng.uniform(0.5, 2)),
                np.float32(rng.uniform(0, 0.3)), np.float32(rng.uniform(0.6, 1)), np.float32(rng.uniform(1, 500)))
        want = jx.np_compute_emission_count(*args)
        assert pt.np_compute_emission_count(*args) == want
        n, last = pt.compute_emission_count(*(torch.tensor(a) for a in args))
        assert (int(n), np.float32(last)) == want
