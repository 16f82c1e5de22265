"""The port's XLA-layout step (`xla_step`; the top-level `step`, `step_jit`
and `multi_step`) against the JAX package's XLA step, lane for lane, on
seeded random configs: the same `init_pool_for(..., seed)`, 180 frames,
every frame compared.

Exact on every frame: alive, ptype, the ring cursor, the cadence scalars,
enabled, the on-demand queue, last_emitted, rng_key and the outputs'
counts. The f32 fields agree within F32_ATOL + F32_RTOL * |x|: XLA on the
CPU contracts multiply-adds into FMAs and evaluates sin/cos by its own
polynomials, which the port's separately rounded torch ops do not (a few
ulp per frame). Where such an expression decides an integer (the cadence,
the uniform ranges of lifetimes), the port evaluates it as XLA does; the
sweeps below hold those forms to the jitted JAX functions on 10^5 seeded
inputs each.
"""

import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from bevy_firework_tpu.cadence import compute_emission_count as j_count
from bevy_firework_tpu.cadence import emission_next_last as j_next_last
from bevy_firework_tpu.utils.f32 import rem_euclid as j_rem_euclid
from bevy_firework_tpu_torch import cadence as pcad
from bevy_firework_tpu_torch import xla_step
from bevy_firework_tpu_torch.utils.f32 import fma32, rem_euclid, rem_euclid_fused
from test_torch_common import _one_torch_thread  # noqa: F401

jstep = importlib.import_module("bevy_firework_tpu.step")  # the module (the package's `step` is its function)

FRAMES = 180
EXACT_STATE = ("alive", "ptype", "ring_cursor", "time_in_cycle", "last_emission", "enabled", "manual_queued",
               "last_emitted", "finished_notified", "rng_key")
EXACT_OUT = ("alive_count", "alive_count_per_type", "finished_event", "aabb_valid", "nested_deferred",
             "nested_dropped", "destroyed_mask")
F32_FIELDS = ("px", "py", "pz", "vx", "vy", "vz", "qx", "qy", "qz", "qw", "wx", "wy", "wz", "initial_scale", "age",
              "lifetime")
# XLA's FMA contractions and sin/cos polynomials on the CPU (module docstring)
F32_ATOL, F32_RTOL = 5e-5, 1e-5


def _two_types(pkg):
    R, V = pkg.RandF32, pkg.RandVec3
    return pkg.ParticleSpawner(
        particle_settings=[
            pkg.ParticleSettings(lifetime=R(0.2, 0.6), initial_scale=R(0.1, 0.2), linear_drag=0.3,
                                 scale_curve=pkg.FireworkCurve.even_samples([1.0, 0.5, 2.0]), acceleration=(0, -3, 0)),
            pkg.ParticleSettings(lifetime=R(0.3, 0.4), angular_acceleration=(0.0, 1.0, 0.0), angular_drag=0.2),
        ],
        emission_settings=[
            pkg.EmissionSettings(particle_index=0, emission_pacing=pkg.EmissionPacing.rate(900.0),
                                 emission_shape=pkg.EmissionShape.sphere(0.5),
                                 initial_velocity=V(R(1.0, 2.0), (0, 1, 0), 0.4)),
            pkg.EmissionSettings(particle_index=1,
                                 emission_pacing=pkg.EmissionPacing.count_over_duration(40.0, 0.7, 0.1, 0.8),
                                 emission_shape=pkg.EmissionShape.box((0.2, 0.3, 0.4)),
                                 initial_angular_velocity=V(R(1.0, 3.0), (1, 0, 0), 0.3),
                                 initial_rotation=(0.1, 0.2, 0.3, 0.927)),
        ],
    ), pkg.Transform(translation=(1.0, 0.5, 0.0))


def _overflow(pkg):
    """A one-shot burst of 1500 and a rate emitter into a 1024-lane ring:
    the first frame asks for more than the pool, and claims drop in
    emitter order."""
    sp, tf = _effects(pkg).sparks()
    es = sp.emission_settings[0]
    burst = dataclasses.replace(es, emission_pacing=pkg.EmissionPacing.one_shot(1500))
    return dataclasses.replace(sp, emission_settings=(burst, es)), tf


def _effects(pkg):
    if pkg is jx:
        from bevy_firework_tpu.models import effects
    else:
        from bevy_firework_tpu_torch.models import effects
    return effects


def _library(pkg):
    if pkg is jx:
        from bevy_firework_tpu.models import library
    else:
        from bevy_firework_tpu_torch.models import library
    return library


def _case(pkg, name):
    """(spawner, transform, colliders, force fields, queue per 30 frames,
    capacity) of a named config, built with either package."""
    eff = _effects(pkg)
    if name == "two_types":
        return (*_two_types(pkg), None, None, 0, 2048)
    if name == "overflow":
        return (*_overflow(pkg), None, None, 0, 1024)
    if name == "on_demand":
        return (*eff.on_demand(), None, None, 40, 2048)
    if name == "collision_destroy":
        sp, tf, cols = eff.collision()
        ps = sp.particle_settings[0]
        ps = dataclasses.replace(ps, collision_settings=dataclasses.replace(ps.collision_settings,
                                                                            destroy_on_collision=True))
        return dataclasses.replace(sp, particle_settings=(ps,)), tf, cols, None, 0, 2048
    if name == "force_fields":
        ff = [pkg.ForceField.vortex((0, 0, 0), (0, 1, 0), strength=12.0, radius=6.0),
              pkg.ForceField.axial((0, 0, 0), (0, 1, 0), strength=25.0, radius=7.0),
              pkg.ForceField.turbulence((0, 2, 0), strength=1.8, radius=8.0, frequency=2.2)]
        return _library(pkg).dust(updraft=2.5, drag=2.0, emit_radius=1.2), pkg.Transform(), None, ff, 0, 2048
    sp, tf = getattr(eff, name)()
    return sp, tf, None, None, 0, 2048


def _first_difference(a: np.ndarray, b: np.ndarray):
    d = np.nonzero(a.ravel() != b.ravel())[0]
    i = int(d[0])
    return i, a.ravel()[i], b.ravel()[i]


def run_against_jax(name, frames=FRAMES, seed=0):
    """Step both packages `frames` frames from the same seed; on the first
    frame where they part, fail naming the field, the lane and the frame."""
    spj, tfj, colj, ffj, queue, n = _case(jx, name)
    spp, tfp, colp, ffp, _q, _n = _case(pt, name)
    cj, cp = jx.compile_spawner(spj), pt.compile_spawner(spp, device="cpu")
    tj = jx.compile_colliders(colj) if colj else None
    tp = pt.compile_colliders(colp, device="cpu") if colp else None
    fj = jx.make_frame_input(1 / 60, translation=tfj.translation, rotation=tfj.rotation,
                             force_fields=jx.compile_force_fields(ffj) if ffj else None)
    fp = pt.make_frame_input(1 / 60, translation=tfp.translation, rotation=tfp.rotation,
                             force_fields=pt.compile_force_fields(ffp, device="cpu") if ffp else None)
    sj, sp = jx.init_pool_for(cj, n, seed), pt.init_pool_for(cp, n, seed)
    seen = 0
    for fi in range(frames):
        if queue and fi % 30 == 0:
            sj = dataclasses.replace(sj, manual_queued=sj.manual_queued + queue)
            sp = dataclasses.replace(sp, manual_queued=sp.manual_queued + queue)
        sj, oj = jx.step_jit(cj.static, cj.params, tj, sj, fj)
        sp, op = pt.step_jit(cp.static, cp.params, tp, sp, fp)
        for k in EXACT_STATE:
            a, b = np.asarray(getattr(sj, k)), getattr(sp, k).numpy()
            if k == "rng_key":
                b = b.astype(np.uint32)
            if not np.array_equal(a, b):
                lane, x, y = _first_difference(a, b)
                pytest.fail(f"{name}: frame {fi}, field {k}, lane {lane}: jax {x} port {y}")
        for k in EXACT_OUT:
            a, b = np.asarray(getattr(oj, k)), getattr(op, k).numpy()
            if not np.array_equal(a, b):
                lane, x, y = _first_difference(a, b)
                pytest.fail(f"{name}: frame {fi}, output {k}, lane {lane}: jax {x} port {y}")
        live = np.asarray(sj.alive)
        if cp.static.ring_claim:  # the stored plane is the derived one
            np.testing.assert_array_equal(live, (sp.age < sp.lifetime).numpy())
        for k in F32_FIELDS:
            a, b = np.asarray(getattr(sj, k))[live], getattr(sp, k).numpy()[live]
            bad = np.abs(a - b) > F32_ATOL + F32_RTOL * np.abs(a)
            if bad.any():
                lane = int(np.nonzero(live)[0][np.argmax(bad)])
                pytest.fail(f"{name}: frame {fi}, field {k}, lane {lane}: jax {np.asarray(getattr(sj, k))[lane]} "
                            f"port {getattr(sp, k).numpy()[lane]}")
        np.testing.assert_allclose(op.aabb_min.numpy(), np.asarray(oj.aabb_min), atol=F32_ATOL, rtol=F32_RTOL)
        np.testing.assert_allclose(op.aabb_max.numpy(), np.asarray(oj.aabb_max), atol=F32_ATOL, rtol=F32_RTOL)
        seen = max(seen, int(op.alive_count))
    return sp, op, seen


CONFIGS = ("sparks", "stress_test", "one_shot", "on_demand", "two_types", "fireworks", "collision_destroy",
           "force_fields", "overflow")


@pytest.mark.parametrize("name", CONFIGS)
def test_random_config_matches_jax_xla_step(name):
    sp, out, seen = run_against_jax(name)
    assert seen > 0
    if name == "fireworks":  # rockets and their bursts, both types live
        assert int(out.alive_count_per_type[0]) > 0 and int(out.alive_count_per_type[1]) > 0
    if name == "collision_destroy":  # a dead-rank archetype carrying its plane
        assert not pt.compile_spawner(_case(pt, name)[0], device="cpu").static.ring_claim


def test_overflow_drops_by_claim_order():
    """The overflow frame: the burst's 1500 ask for more than the 1024
    lanes; the burst takes every lane and the rate emitter's claim, after
    it, drops (the JAX step's order; the kernel's layout ranks the frame's
    spawns as one window)."""
    spp, tfp, *_rest = _case(pt, "overflow")
    cp = pt.compile_spawner(spp, device="cpu")
    s, out = pt.step(cp.static, cp.params, None, pt.init_pool_for(cp, 1024, 0),
                     pt.make_frame_input(1 / 60, translation=tfp.translation))
    assert int(out.alive_count) == 1024
    assert int(s.ring_cursor) == (1500 + 16) % 1024


def test_multi_step_equals_steps_and_the_jax_multi_step():
    """multi_step == n steps bit for bit, and == the JAX package's
    multi_step lane for lane on a nested config."""
    (spj, tfj, *_a), (spp, tfp, *_b) = _case(jx, "fireworks"), _case(pt, "fireworks")
    cj, cp = jx.compile_spawner(spj), pt.compile_spawner(spp, device="cpu")
    fj, fp = jx.make_frame_input(1 / 60), pt.make_frame_input(1 / 60)
    s0 = pt.init_pool_for(cp, 2048, 4)
    sa, oa = pt.multi_step(cp.static, cp.params, None, s0, fp, 70)
    sb = s0
    for _ in range(70):
        sb, ob = xla_step.step(cp.static, cp.params, None, sb, fp)
    for k in F32_FIELDS + EXACT_STATE:
        assert torch.equal(getattr(sa, k), getattr(sb, k)), k
    assert int(oa.alive_count) == int(ob.alive_count)
    sj, oj = jx.multi_step(cj.static, cj.params, None, jx.init_pool_for(cj, 2048, 4), fj, 70)
    np.testing.assert_array_equal(sa.alive.numpy(), np.asarray(sj.alive))
    np.testing.assert_array_equal(sa.last_emitted.numpy(), np.asarray(sj.last_emitted))
    assert oa.alive_count_per_type.tolist() == np.asarray(oj.alive_count_per_type).tolist()


@pytest.mark.parametrize("n", [1, 5, 127, 128, 129, 1000, 4096, 5003])
def test_monotone_inverse_matches_jax(n):
    """p(r) = #(cum <= r) against the JAX package's block-count form on
    seeded non-decreasing arrays, small and odd pools included, queries
    past the total included."""
    rng = np.random.default_rng(n)
    for m in (1, 7, 128, 300):
        for density in (0.0, 0.05, 0.5, 3.0):
            counts = rng.poisson(density, n).astype(np.int32)
            cum = np.cumsum(counts).astype(np.int32)
            want = np.asarray(jstep._monotone_inverse(jax.numpy.asarray(cum), m))
            got = xla_step.monotone_inverse(torch.from_numpy(cum), m).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"n={n} m={m} density={density}")


SWEEP = 100_000


def _cadence_inputs(seed):
    """Seeded cadence inputs: a quarter on exact emission boundaries (t a
    whole number of intervals), an eighth of anchors at f32::MIN (fresh
    parents), counts integral and fractional."""
    rng = np.random.default_rng(seed)
    f = np.float32
    t = rng.uniform(0, 2, SWEEP).astype(f)
    last = rng.uniform(-0.5, 1.5, SWEEP).astype(f)
    dur = rng.uniform(0.2, 3, SWEEP).astype(f)
    os_ = rng.uniform(0, 0.4, SWEEP).astype(f)
    oe = rng.uniform(0.6, 1, SWEEP).astype(f)
    cnt = np.where(rng.random(SWEEP) < 0.5, np.floor(rng.uniform(1, 3000, SWEEP)), rng.uniform(1, 3000, SWEEP))
    cnt = cnt.astype(f)
    q = SWEEP // 4
    k = rng.integers(0, 400, q)
    t[:q] = (k * (oe[:q] - os_[:q]) / cnt[:q] * dur[:q]).astype(f)
    last[q:q + q // 2] = np.finfo(np.float32).min
    return t, last, dur, os_, oe, cnt


@jax.jit
def _jax_global_cadence(tic, dt, last, dur, os_, oe, cnt):
    """The XLA step's rate cadence (step.py:596-600) on [B] inputs."""
    t = j_rem_euclid(tic + dt, dur)
    count, next_last = j_count(t, last, dur, os_, oe, cnt)
    return t, count, next_last


@jax.jit
def _jax_nested_cadence(age, le, life, os_, oe, cnt, emitted):
    """The XLA step's per-parent nested cadence and its deferral
    (step.py:662-684)."""
    counts, next_last = j_count(age, le, life, os_, oe, cnt)
    return counts, next_last, j_next_last(le, life, os_, oe, cnt, emitted)


def test_fused_cadence_matches_xla_on_the_cpu():
    """10^5 seeded inputs through the rate cadence (rem_euclid, then the
    count and its carry) and 10^5 through the nested cadence (the count,
    its carry and the deferral's carry): the port's XLA forms equal the
    jitted JAX functions bit for bit. The separately rounded forms (the
    numpy oracle's, the kernel's) part from XLA on some of them: that is
    the seam the fused forms close."""
    t, last, dur, os_, oe, cnt = _cadence_inputs(0)
    dt = np.float32(1 / 60)
    jt, jc, jl = (np.asarray(v) for v in _jax_global_cadence(t, dt, last, dur, os_, oe, cnt))
    T = {k: torch.from_numpy(v) for k, v in dict(t=t, last=last, dur=dur, os=os_, oe=oe, cnt=cnt).items()}
    pt_t = rem_euclid_fused(T["t"] + torch.tensor(dt), T["dur"])
    pc, pl = pcad.compute_emission_count_xla(pt_t, T["last"], T["dur"], T["os"], T["oe"], T["cnt"])
    np.testing.assert_array_equal(pt_t.numpy(), jt)
    np.testing.assert_array_equal(pc.numpy(), jc)
    np.testing.assert_array_equal(pl.numpy(), jl)
    plain_t = rem_euclid(T["t"] + torch.tensor(dt), T["dur"])
    plain_c, plain_l = pcad.compute_emission_count(pt_t, T["last"], T["dur"], T["os"], T["oe"], T["cnt"])
    assert (plain_t.numpy() != jt).any() and (plain_l.numpy() != jl).any() and (plain_c.numpy() != jc).any()

    age, le, life, os_, oe, cnt = _cadence_inputs(1)
    emitted = np.random.default_rng(2).integers(0, 50, SWEEP).astype(np.int32)
    jc, jl, jd = (np.asarray(v) for v in _jax_nested_cadence(age, le, life, os_, oe, cnt, emitted))
    A = [torch.from_numpy(v) for v in (age, le, life, os_, oe, cnt)]
    pc, pl = pcad.compute_emission_count_xla(*A)
    pd = pcad.emission_next_last(A[1], A[2], A[3], A[4], A[5], torch.from_numpy(emitted), fused=True)
    np.testing.assert_array_equal(pc.numpy(), jc)
    np.testing.assert_array_equal(pl.numpy(), jl)
    np.testing.assert_array_equal(pd.numpy(), jd)
    plain_d = pcad.emission_next_last(A[1], A[2], A[3], A[4], A[5], torch.from_numpy(emitted))
    assert (plain_d.numpy() != jd).any()


def test_fma32_is_one_rounding():
    """fma32 against the exact product-sum in rational arithmetic, rounded
    once to f32 (numpy's float128 where it has 64 bits of mantissa is not
    enough in general, so the check is the definition: the result is the
    f32 nearest to a*b + c, ties to even)."""
    from fractions import Fraction

    rng = np.random.default_rng(5)
    a = (rng.standard_normal(3000) * 10.0 ** rng.integers(-8, 8, 3000)).astype(np.float32)
    b = (rng.standard_normal(3000) * 10.0 ** rng.integers(-8, 8, 3000)).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.standard_normal(3000) * 1e-7)).astype(np.float32)  # cancellation
    got = fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cands = {lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf))}
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact), int(np.float32(v).view(np.int32)) & 1))
        assert g == best, (x, y, z, g, best)


def test_threefry_rows_and_routes_match_jax():
    """threefry_uniform's CPU route (numpy uint32 in cache-sized chunks)
    and its card route (int64 tensor words, here on CPU tensors) give the
    same bits as jax.random.uniform, whole and by rows (the XLA-layout
    step draws only the rows an archetype reads)."""
    from bevy_firework_tpu_torch import prng

    for seed, shape in ((0, (12, 5000)), (7, (12, 20000)), (3, (9, 333))):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.uniform(key, shape, jax.numpy.float32))
        words = np.asarray(key).astype(np.uint32)
        got = prng.threefry_uniform(words, shape)
        np.testing.assert_array_equal(got.numpy(), want)
        idx = torch.arange(int(np.prod(shape)), dtype=torch.int64)
        card_route = prng._uniform_int64(int(words[0]), int(words[1]), idx).reshape(shape)
        np.testing.assert_array_equal(card_route.numpy(), want)
        rows = [0, 2, 5, shape[0] - 1]
        np.testing.assert_array_equal(prng.threefry_uniform(words, shape, rows=rows).numpy(), want[rows])
