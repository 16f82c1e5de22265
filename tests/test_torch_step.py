"""The port's step (plain PyTorch, on the CPU) against the JAX package.

Deterministic configs (constant draws) must match the JAX XLA step lane by
lane. Random configs draw from different generators in the two packages
(threefry per emitter there, Philox per lane here), so they are held to
exact bookkeeping and to equal distributions."""

import numpy as np
import pytest
import scipy.stats
import torch
from jax.experimental.pallas import tpu as pltpu

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from bevy_firework_tpu.cadence import np_compute_emission_count
from bevy_firework_tpu.ops.fused_step import fused_step as jax_fused_step
from bevy_firework_tpu.step import step_jit
from bevy_firework_tpu.utils.f32 import np_rem_euclid
from bevy_firework_tpu_torch import interop
from bevy_firework_tpu_torch.ops.fused_step import chain_shape, multi_step_auto
from bevy_firework_tpu_torch.step import plain_step
from test_torch_common import (  # noqa: F401
    _one_torch_thread,
    assert_pools_match,
    det_spawner,
    effect,
    jax_pool_numpy,
    port_pool_numpy,
)

N = 8192


def _det_pair():
    cj = jx.compile_spawner(det_spawner(jx))
    cp = pt.compile_spawner(det_spawner(pt), device="cpu")
    return cj, cp, jx.make_frame_input(1 / 50), pt.make_frame_input(1 / 50)


def _stress_pair(rate=6000.0):
    spj, tfj = effect("jax", "stress_test", rate)
    spp, tfp = effect("torch", "stress_test", rate)
    cj, cp = jx.compile_spawner(spj), pt.compile_spawner(spp, device="cpu")
    return (cj, cp, jx.make_frame_input(1 / 60, translation=tfj.translation),
            pt.make_frame_input(1 / 60, translation=tfp.translation))


def test_det_step_matches_jax_xla_step_lane_by_lane():
    cj, cp, fj, fp = _det_pair()
    sj, sp = jx.init_pool_for(cj, N, 0), pt.init_pool_for(cp, N, 0)
    for _ in range(25):
        sj, oj = step_jit(cj.static, cj.params, None, sj, fj)
        sp, op = plain_step(cp.static, cp.params, None, sp, fp)
        assert_pools_match(jax_pool_numpy(sj), port_pool_numpy(sp))
    assert int(op.alive_count) == int(oj.alive_count) == 600
    np.testing.assert_allclose(op.aabb_min.numpy(), np.asarray(oj.aabb_min), atol=2e-5)
    np.testing.assert_allclose(op.aabb_max.numpy(), np.asarray(oj.aabb_max), atol=2e-5)


def test_det_step_matches_jax_fused_kernel_interpret_mode():
    """The JAX package's Pallas kernel, run as its own tests run it on the
    CPU (interpret mode); fields compare with the same FMA tolerance."""
    import jax

    cj, cp, fj, fp = _det_pair()
    sj, sp = jx.init_pool_for(cj, N, 0), pt.init_pool_for(cp, N, 0)
    fused = jax.jit(jax_fused_step, static_argnums=(0,))
    for _ in range(10):
        with pltpu.force_tpu_interpret_mode():
            sj, oj = fused(cj.static, cj.params, None, sj, fj)
        sp, op = plain_step(cp.static, cp.params, None, sp, fp)
    a, b = jax_pool_numpy(sj), port_pool_numpy(sp)
    a["alive"] = np.asarray(sj.alive)
    assert_pools_match(a, b)
    assert int(op.alive_count) == int(oj.alive_count)


def test_random_config_bookkeeping_and_distributions():
    """stress_test at rate 6000 for 60 frames. The port's cadence stream
    equals the numpy f32 oracle bit for bit, and rng_key advances exactly as
    the JAX package's. Against the JAX XLA step, alive count and cursor may
    differ by 1 and the carry by one emission interval: XLA on the CPU
    contracts `(clamped_last + times * percent_between) * cycle_duration`
    (cadence.py) into an FMA, which drifts its carry by ulps until a count
    flips (frame 30 here); the oracle and the port round each op."""
    cj, cp, fj, fp = _stress_pair()
    sj, sp = jx.init_pool_for(cj, N, 0), pt.init_pool_for(cp, N, 0)
    dt, dur, per = np.float32(1 / 60), np.float32(1.0), np.float32(6000.0)
    tic, last, total = np.float32(0.0), np.float32(0.0), 0
    for _ in range(60):
        sj, oj = step_jit(cj.static, cj.params, None, sj, fj)
        sp, op = plain_step(cp.static, cp.params, None, sp, fp)
        tic = np_rem_euclid(np.float32(tic + dt), dur)
        n, last = np_compute_emission_count(tic, last, dur, 0.0, 1.0, per)
        total += n
        assert sp.time_in_cycle.item() == tic
        assert sp.last_emission.item() == last
        assert int(op.alive_count) == total == int(sp.ring_cursor)
        np.testing.assert_array_equal(sp.rng_key.numpy().astype(np.uint32), np.asarray(sj.rng_key))
        assert abs(int(op.alive_count) - int(oj.alive_count)) <= 1
        assert abs(int(sp.ring_cursor) - int(sj.ring_cursor)) <= 1
        assert abs(sp.last_emission.item() - float(np.asarray(sj.last_emission)[0])) <= 1 / 6000 + 1e-5
    alive_p, alive_j = sp.alive.numpy(), np.asarray(sj.alive)
    scale_p = sp.initial_scale.numpy()[alive_p]
    scale_j = np.asarray(sj.initial_scale)[alive_j]
    # initial_scale ~ U(0.02, 0.08) in both packages
    assert scipy.stats.kstest(scale_p, scipy.stats.uniform(0.02, 0.06).cdf).pvalue > 1e-3
    assert scipy.stats.ks_2samp(scale_p, scale_j).pvalue > 1e-3
    speed_p = np.sqrt(sum(getattr(sp, c).numpy()[alive_p] ** 2 for c in ("vx", "vy", "vz")))
    speed_j = np.sqrt(sum(np.asarray(getattr(sj, c))[alive_j] ** 2 for c in ("vx", "vy", "vz")))
    assert scipy.stats.ks_2samp(speed_p, speed_j).pvalue > 1e-3
    # positions start on the 0.3 circle around the transform: same spread
    r_p = np.hypot(sp.px.numpy()[alive_p], sp.pz.numpy()[alive_p])
    r_j = np.hypot(np.asarray(sj.px)[alive_j], np.asarray(sj.pz)[alive_j])
    assert scipy.stats.ks_2samp(r_p, r_j).pvalue > 1e-3


@pytest.mark.parametrize("config", ["det", "stress_test"])
def test_jax_pool_carried_over_continues_in_port(config):
    """A JAX pool taken at frame 30 continues in the port for 10 frames. On
    the deterministic config every lane matches the JAX run; on stress_test
    the lanes alive at frame 30 (none dies within 10 frames: lifetime 1 s)
    match lane by lane, and the key chain is exact."""
    cj, cp, fj, fp = _det_pair() if config == "det" else _stress_pair()
    sj = jx.init_pool_for(cj, N, 0)
    for _ in range(30):
        sj, _o = step_jit(cj.static, cj.params, None, sj, fj)
    sp = interop.pool_from_numpy(jax_pool_numpy(sj), device="cpu")
    old = np.asarray(sj.alive)
    for _ in range(10):
        sj, _o = step_jit(cj.static, cj.params, None, sj, fj)
        sp, _o = plain_step(cp.static, cp.params, None, sp, fp)
    a, b = jax_pool_numpy(sj), port_pool_numpy(sp)
    if config == "det":
        assert_pools_match(a, b)
    else:
        np.testing.assert_array_equal(a["rng_key"], b["rng_key"])
        for k in ("px", "py", "pz", "vx", "vy", "vz", "age", "initial_scale"):
            np.testing.assert_allclose(a[k][old], b[k][old], atol=2e-5, rtol=1e-6, err_msg=k)


def test_multi_step_auto_equals_single_steps():
    """19 frames = two 8-frame launches and 3 single frames, bit-equal to 19
    single steps (the same ops in the same order on the same bits)."""
    assert chain_shape(19) == [8, 8, 1, 1, 1]
    _cj, cp, _fj, fp = _stress_pair()
    s0 = pt.init_pool_for(cp, N, 3)
    sa, oa = multi_step_auto(cp.static, cp.params, None, s0, fp, 19)
    sb = s0
    for _ in range(19):
        sb, ob = plain_step(cp.static, cp.params, None, sb, fp)
    a, b = port_pool_numpy(sa), port_pool_numpy(sb)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(oa.alive_count) == int(ob.alive_count) == 1900
    assert torch.equal(oa.aabb_min, ob.aabb_min) and torch.equal(oa.aabb_max, ob.aabb_max)


def test_random_lifetime_and_multi_type_chain_equals_single_steps():
    """The kernel's scope beyond the main path (random lifetime, live
    rotation, two types, two emitters of different pacing) through the same
    chain: bit-equal to single steps, bookkeeping as the oracle says."""
    sp = pt.ParticleSpawner(
        particle_settings=[
            pt.ParticleSettings(lifetime=pt.RandF32(0.2, 0.6), initial_scale=pt.RandF32(0.1, 0.2),
                                scale_curve=pt.FireworkCurve.even_samples([1.0, 0.5, 2.0])),
            pt.ParticleSettings(lifetime=pt.RandF32(0.3, 0.4), angular_acceleration=(0.0, 1.0, 0.0)),
        ],
        emission_settings=[
            pt.EmissionSettings(particle_index=0, emission_pacing=pt.EmissionPacing.rate(900.0),
                                emission_shape=pt.EmissionShape.sphere(0.5),
                                initial_velocity=pt.RandVec3(pt.RandF32(1.0, 2.0), (0, 1, 0), 0.4)),
            pt.EmissionSettings(particle_index=1, emission_pacing=pt.EmissionPacing.one_shot(50),
                                emission_shape=pt.EmissionShape.box((0.2, 0.3, 0.4)),
                                initial_angular_velocity=pt.RandVec3(pt.RandF32(1.0, 3.0), (1, 0, 0), 0.3)),
        ],
    )
    c = pt.compile_spawner(sp, device="cpu")
    assert c.static.const_lifetime is None and not c.static.elide_rotation and c.num_types == 2
    f = pt.make_frame_input(1 / 60)
    s0 = pt.init_pool_for(c, N, 7)
    sa, oa = multi_step_auto(c.static, c.params, None, s0, f, 16)
    sb = s0
    for _ in range(16):
        sb, ob = plain_step(c.static, c.params, None, sb, f)
    a, b = port_pool_numpy(sa), port_pool_numpy(sb)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(oa.alive_count_per_type[1]) == 50  # the burst, alive 16 frames < 0.3 s
    assert int(oa.alive_count) == int(ob.alive_count) <= int(sa.ring_cursor) == 15 * 16 + 50
    assert not bool(sa.enabled[1])


def test_out_of_scope_archetypes_raise():
    """Archetypes beyond the global slice step: a nested archetype runs
    hybrid frames (its children appear, counted per type), the
    destroyed-particle dump gives its mask and force fields their table."""
    from bevy_firework_tpu_torch.settings import EmissionMode, ParticleCollisionSettings, ParticleEventHandlers

    f = pt.make_frame_input(1 / 60)
    nested = pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(), pt.ParticleSettings()],
        emission_settings=[pt.EmissionSettings(emission_pacing=pt.EmissionPacing.rate(300.0)),
                           pt.EmissionSettings(particle_index=1, emission_mode=EmissionMode.nested(0),
                                               emission_pacing=pt.EmissionPacing.count_over_duration(
                                                   4.0, 1.0, 0.0, 0.05))],
    )
    c = pt.compile_spawner(nested, device="cpu")
    s = pt.init_pool_for(c, 256)
    for _ in range(6):
        s, out = pt.step_auto(c.static, c.params, None, s, f)
    per_type = out.alive_count_per_type.tolist()  # 6 frames at 300/s and up to 4 children each
    assert 29 <= per_type[0] <= 30 and 0 < per_type[1] <= 4 * per_type[0]
    assert sum(per_type) == int(out.alive_count) and int(out.nested_dropped) == 0
    dump = pt.ParticleSpawner(particle_settings=[pt.ParticleSettings(
        collision_settings=ParticleCollisionSettings(destroy_on_collision=True),
        event_handlers=ParticleEventHandlers(particles_destroyed=print))])
    c = pt.compile_spawner(dump, device="cpu")
    _s, out = pt.step_auto(c.static, c.params, None, pt.init_pool_for(c, 64), f)
    assert out.destroyed_mask.shape == (64,)
    c = pt.compile_spawner(pt.ParticleSpawner(), device="cpu")
    fields = pt.compile_force_fields([pt.ForceField.point((0.0, 0.0, 0.0), 1.0, 2.0)], device="cpu")
    _s, out = pt.step_auto(c.static, c.params, None, pt.init_pool_for(c, 64),
                           pt.make_frame_input(1 / 60, force_fields=fields))
    assert out.alive_count_per_type.shape == (1,)