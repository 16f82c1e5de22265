"""Nested emission in the port (plain PyTorch, on the CPU) against the JAX
package: the cadence pass, hybrid frames, ports of tests/test_nested.py's
oracle cases, and nested effects through the Scene.

The JAX package's Pallas kernels run in interpret mode, as its own tests run
them. Its hybrid merges children in-kernel on a TPU only;
`_FORCE_NESTED_MERGE_CPU` turns the merge on here for the test and is
restored afterwards, as tests/test_nested.py does. Tolerances: XLA on the
CPU contracts multiply-adds into FMAs and its sinf/cosf differ from
PyTorch's by an ulp on ~5% of inputs, so f32 fields are held lane for lane
within `assert_pools_match`'s 2e-5; counts, claims, types, cursors and keys
are exact."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import bevy_firework_tpu as jx
import bevy_firework_tpu.ops.fused_step as jfs
import bevy_firework_tpu_torch as pt
from bevy_firework_tpu.step import step_jit
from bevy_firework_tpu_torch import interop
from bevy_firework_tpu_torch.step import nested_cadence
from test_torch_common import _one_torch_thread, assert_pools_match  # noqa: F401
from tests.oracle import oracle_init, oracle_step

F32_MIN = np.finfo(np.float32).min


def _ulps(a, b) -> np.ndarray:
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


# ---------------------------------------------------------------- cadence


def _np_cadence(alive, ptype, age, life, le, gate, target, off_s, off_e, cnt, m, fma=False):
    """The nested cadence in numpy f32, one op at a time: (new_le, cum,
    total). fma: the two anchor sums `clamped + x * between` contracted into
    one rounding (f64 product and sum of f32 operands, rounded to f32), as
    XLA on the CPU compiles them."""
    f = np.float32

    def madd(c, x, b):
        if fma:
            return (c.astype(np.float64) + x.astype(np.float64) * np.float64(b)).astype(f)
        return (c + (x * b).astype(f)).astype(f)

    base = np.where(alive, le, F32_MIN).astype(f)
    pm = alive & gate & (ptype == target)
    pct = (age / life).astype(f)
    with np.errstate(over="ignore"):
        last_pct = (base / life).astype(f)
    clamped = np.maximum(last_pct, f(off_s)).astype(f)
    since = (np.minimum(pct, f(off_e)) - clamped).astype(f)
    between = f(f(f(off_e) - f(off_s)) / f(cnt))
    q = np.trunc((since / between).astype(f)).astype(f)
    r = (since - (q * between).astype(f)).astype(f)
    times = np.where(r < 0, (q - f(1)).astype(f), q).astype(f)
    counts = np.where(pm, np.maximum(times, f(0)).astype(np.int32), 0).astype(np.int32)
    full = (madd(clamped, times, between) * life).astype(f)
    cum = np.cumsum(counts).astype(np.int32)
    emitted = np.minimum(cum, m) - np.minimum(cum - counts, m)
    trunc = (madd(clamped, emitted.astype(f), between) * life).astype(f)
    new_le = np.where(pm, np.where(emitted < counts, trunc, full), base).astype(f)
    return new_le, cum, int(cum[-1])


def _cadence_case(n, seed):
    rng = np.random.default_rng(seed)
    life = rng.uniform(0.5, 2.0, n).astype(np.float32)
    age = (rng.uniform(0.0, 1.0, n) * life).astype(np.float32)
    le = np.where(rng.uniform(size=n) < 0.5, F32_MIN, age * rng.uniform(0.0, 1.0, n)).astype(np.float32)
    fields = {k: rng.normal(size=n).astype(np.float32) for k in ("px", "py", "pz", "vx", "vy", "vz")}
    return (rng.uniform(size=n) < 0.6, rng.integers(0, 2, n).astype(np.int32), age, life, le, fields)


def _burst_pair(count=10.0, window=0.001):
    """Two types; emitter 1 is nested on type 0 with a window far shorter
    than a frame, so every parent asks for its children at once."""
    def sp(pkg):
        return pkg.ParticleSpawner(
            particle_settings=[pkg.ParticleSettings(), pkg.ParticleSettings()],
            emission_settings=[pkg.EmissionSettings(), pkg.EmissionSettings(
                particle_index=1, emission_mode=pkg.EmissionMode.nested(0),
                emission_pacing=pkg.EmissionPacing.count_over_duration(count, 1.0, 0.0, window))])
    return jx.compile_spawner(sp(jx)), pt.compile_spawner(sp(pt), device="cpu")


@pytest.mark.parametrize("n", [8192, 24576])
@pytest.mark.parametrize("fetch", [False, True])
def test_nested_cadence_matches_jax_kernel(n, fetch):
    """The port's cadence pass against the JAX `nested_cadence_pass` (Pallas,
    interpret mode; 24576 lanes are three tiles of its grid) on random
    parents of two types with a burst whose total (~48k children) exceeds
    M = 4096: ranks straddle tiles and the deferral cuts a parent. cum,
    total and the fetched parent values are exact; the port's new_le equals
    the numpy f32 cadence bit for bit. The JAX kernel's new_le parts from it
    on about a quarter of the parents, every one of them explained by XLA
    contracting the anchor sum `clamped + times * between` (and the
    deferral's `clamped + emitted * between`) into an FMA: there it equals
    the numpy cadence with that contraction, bit for bit."""
    cj, cp = _burst_pair()
    alive, ptype, age, life, le, fields = _cadence_case(n, 3)
    M = 4096
    pf_j = {k: jax.numpy.asarray(v) for k, v in fields.items()} if fetch else None
    with pltpu.force_tpu_interpret_mode():
        j_le, j_cum, j_total, j_pv = jfs.nested_cadence_pass(
            cj.static, cj.params, 1, jax.numpy.asarray(alive), jax.numpy.asarray(ptype), jax.numpy.asarray(age),
            jax.numpy.asarray(life), jax.numpy.asarray(le), jax.numpy.asarray(True), True, M, parent_fields=pf_j)
    pf_p = {k: torch.from_numpy(v) for k, v in fields.items()} if fetch else None
    p_le, p_cum, p_total, p_pv = pt.nested_cadence_pass(
        cp.static, cp.params, 1, torch.from_numpy(alive), torch.from_numpy(ptype), torch.from_numpy(age),
        torch.from_numpy(life), torch.from_numpy(le), torch.ones((), dtype=torch.bool), M, parent_fields=pf_p)
    want_le, want_cum, want_total = _np_cadence(alive, ptype, age, life, le, True, 0, 0.0, 0.001, 10.0, M)
    assert int(p_total) == int(j_total) == want_total > M
    np.testing.assert_array_equal(p_le.numpy(), want_le)
    fma_le, _c, _t = _np_cadence(alive, ptype, age, life, le, True, 0, 0.0, 0.001, 10.0, M, fma=True)
    j_le = np.asarray(j_le)
    parted = j_le != want_le
    assert parted.any() and (j_le[parted] == fma_le[parted]).all()
    if fetch:
        assert j_cum is None and p_cum is None
        for k in fields:
            np.testing.assert_array_equal(p_pv[k].numpy(), np.asarray(j_pv[k]), err_msg=k)
        parent = np.searchsorted(want_cum, np.arange(M), side="right")
        np.testing.assert_array_equal(p_pv["vx"].numpy(), fields["vx"][parent])
    else:
        np.testing.assert_array_equal(p_cum.numpy(), np.asarray(j_cum))
        np.testing.assert_array_equal(p_cum.numpy(), want_cum)


def test_nested_cadence_gate_and_single_type():
    """A closed gate counts nothing and still resets dead lanes' anchors; a
    single-type archetype skips the type mask."""
    _cj, cp = _burst_pair()
    alive, ptype, age, life, le, _f = _cadence_case(4096, 4)
    t = [torch.from_numpy(x) for x in (alive, ptype, age, life, le)]
    new_le, cum, total, _pv = nested_cadence(cp.static, cp.params, 1, *t, torch.zeros((), dtype=torch.bool), 64)
    assert int(total) == 0 and int(cum.abs().max()) == 0
    np.testing.assert_array_equal(new_le.numpy(), np.where(alive, le, F32_MIN))
    one = pt.compile_spawner(pt.ParticleSpawner(emission_settings=[pt.EmissionSettings(), pt.EmissionSettings(
        emission_mode=pt.EmissionMode.nested(0),
        emission_pacing=pt.EmissionPacing.count_over_duration(10.0, 1.0, 0.0, 0.001))]), device="cpu")
    assert one.static.single_type
    _le, _cum, total1, _pv = nested_cadence(one.static, one.params, 1, *t, torch.ones((), dtype=torch.bool), 64)
    want = _np_cadence(alive, np.zeros_like(ptype), age, life, le, True, 0, 0.0, 0.001, 10.0, 64)[2]
    assert int(total1) == want > int(total)


# ---------------------------------------------------------- hybrid frames


def _chained(pkg, stages=3):
    """tests/test_nested.py:333-354's chained config with constant global
    draws (the JAX kernel's TPU PRNG and the port's Philox differ) at rate
    2000, where XLA's contracted rate cadence agrees with the f32 cadence
    (ROADMAP queue 3); the nested children draw randomly (threefry)."""
    ps = [pkg.ParticleSettings(lifetime=pkg.RandF32.constant(0.6), linear_drag=0.1),
          pkg.ParticleSettings(lifetime=pkg.RandF32.constant(0.5), linear_drag=0.2),
          pkg.ParticleSettings(lifetime=pkg.RandF32.constant(0.4), linear_drag=0.3)]
    es = [pkg.EmissionSettings(particle_index=0, emission_pacing=pkg.EmissionPacing.rate(2000.0),
                               initial_velocity=pkg.RandVec3.constant((0.3, 2.0, 0.1))),
          pkg.EmissionSettings(particle_index=1, emission_mode=pkg.EmissionMode.nested(0),
                               emission_pacing=pkg.EmissionPacing.count_over_duration(6.0, 1.0, 0.1, 1.0),
                               initial_velocity=pkg.RandVec3(magnitude=pkg.RandF32(0.1, 0.6),
                                                             direction=(0, 1, 0), spread=2.0),
                               inherit_parent_velocity=True),
          pkg.EmissionSettings(particle_index=2, emission_mode=pkg.EmissionMode.nested(1),
                               emission_pacing=pkg.EmissionPacing.count_over_duration(3.0, 1.0, 0.2, 0.9),
                               initial_velocity=pkg.RandVec3(magnitude=pkg.RandF32(0.05, 0.3),
                                                             direction=(0, 1, 0), spread=3.0),
                               inherit_parent_velocity=True)]
    return pkg.ParticleSpawner(particle_settings=ps[:stages], emission_settings=es[:stages])


def _canonical_le(le, life, ptype, alive, offs, targets):
    """last_emitted in its observable class: anchors below off_start *
    lifetime of a live parent all clamp alike (tests/test_nested.py:379-398)."""
    le = le.copy()
    for e, off in offs.items():
        m = alive & (ptype == targets[e])
        le[e][m] = np.maximum(le[e][m], (off * life)[m])
    return le


@pytest.mark.parametrize("stages", [2, 3])
def test_hybrid_frames_match_jax_hybrid(stages):
    """70 hybrid frames of the port (step_auto on the CPU: the plain hybrid)
    against the JAX `fused_step_hybrid` with its in-kernel merge (interpret
    mode), 8192 lanes, nested_buffer 128 (the parents ask for more: the
    deferral cuts them from frame ~20): every
    field lane for lane every frame, the ring cursor, rng_key, the per-type
    counts and nested_deferred / nested_dropped exact (the 3-stage pool
    fills near frame 47 and drops children); last_emitted within
    1 ulp, canonicalised on the chained config (its merge formulation)."""
    cj = jx.compile_spawner(_chained(jx, stages), nested_buffer=128)
    cp = pt.compile_spawner(_chained(pt, stages), nested_buffer=128, device="cpu")
    fj, fp = jx.make_frame_input(1 / 50), pt.make_frame_input(1 / 50)
    offs = {1: 0.1, 2: 0.2} if stages == 3 else {1: 0.1}
    targets = {1: 0, 2: 1}
    prev = jfs._FORCE_NESTED_MERGE_CPU
    jfs._FORCE_NESTED_MERGE_CPU = True
    try:
        hybrid = jax.jit(lambda st, p, col, s, f: jfs.fused_step_hybrid(st, p, col, s, f), static_argnums=(0,))
        sj, sp = jx.init_pool_for(cj, 8192, 0), pt.init_pool_for(cp, 8192, 0)
        deferred = 0
        for i in range(70):
            with pltpu.force_tpu_interpret_mode():
                sj, oj = hybrid(cj.static, cj.params, None, sj, fj)
            sp, op = pt.step_auto(cp.static, cp.params, None, sp, fp)
            a = {k: np.asarray(getattr(sj, k)) for k in interop.pool_to_numpy(sp)}
            b = interop.pool_to_numpy(sp)
            assert_pools_match(a, b)
            np.testing.assert_array_equal(a["ptype"][a["alive"]], b["ptype"][b["alive"]], err_msg=f"frame {i}")
            np.testing.assert_array_equal(np.asarray(oj.alive_count_per_type), op.alive_count_per_type.numpy())
            assert int(oj.nested_deferred) == int(op.nested_deferred), i
            assert int(oj.nested_dropped) == int(op.nested_dropped), i
            deferred += int(op.nested_deferred)
            le_j = _canonical_le(a["last_emitted"], a["lifetime"], a["ptype"], a["alive"], offs, targets)
            le_p = _canonical_le(b["last_emitted"], b["lifetime"], b["ptype"], b["alive"], offs, targets)
            assert _ulps(le_j, le_p).max() <= 1, i
    finally:
        jfs._FORCE_NESTED_MERGE_CPU = prev
    assert deferred > 0 and min(op.alive_count_per_type.tolist()) > 0


def test_dead_rank_hybrid_matches_jax_write_back():
    """A destroy-on-collision nested archetype: the JAX hybrid writes its
    children back in place (dead-rank claim, cum mode); the port merges them
    by dead-slot rank. 30 frames, 8192 lanes, rockets dying on a floor: the
    same slots, fields and counts lane for lane."""
    def sp(pkg):
        col = pkg.ParticleCollisionSettings(restitution=0.5, friction=0.2, destroy_on_collision=True)
        return pkg.ParticleSpawner(
            particle_settings=[pkg.ParticleSettings(lifetime=pkg.RandF32.constant(0.6), linear_drag=0.1,
                                                    acceleration=(0.0, -9.81, 0.0), collision_settings=col),
                               pkg.ParticleSettings(lifetime=pkg.RandF32.constant(0.5), linear_drag=0.2)],
            emission_settings=[
                pkg.EmissionSettings(particle_index=0, emission_pacing=pkg.EmissionPacing.rate(2000.0),
                                     initial_velocity=pkg.RandVec3.constant((0.3, 2.0, 0.1))),
                pkg.EmissionSettings(particle_index=1, emission_mode=pkg.EmissionMode.nested(0),
                                     emission_pacing=pkg.EmissionPacing.count_over_duration(6.0, 1.0, 0.1, 1.0),
                                     emission_shape=pkg.EmissionShape.box((0.1, 0.2, 0.1)),
                                     initial_velocity=pkg.RandVec3(pkg.RandF32(0.1, 0.9), (0, 1, 0), 0.0),
                                     inherit_parent_velocity=True)])
    cj, cp = jx.compile_spawner(sp(jx), nested_buffer=512), pt.compile_spawner(sp(pt), nested_buffer=512,
                                                                               device="cpu")
    assert not cp.static.ring_claim
    tj = jx.compile_colliders([jx.Collider.halfspace(position=(0.0, -0.2, 0.0))])
    tp = pt.compile_colliders([pt.Collider.halfspace(position=(0.0, -0.2, 0.0))], device="cpu")
    fj, fp = jx.make_frame_input(1 / 50), pt.make_frame_input(1 / 50)
    hybrid = jax.jit(lambda st, p, col, s, f: jfs.fused_step_hybrid(st, p, col, s, f), static_argnums=(0,))
    sj, sp_ = jx.init_pool_for(cj, 8192, 0), pt.init_pool_for(cp, 8192, 0)
    for i in range(30):
        with pltpu.force_tpu_interpret_mode():
            sj, oj = hybrid(cj.static, cj.params, tj, sj, fj)
        sp_, op = pt.step_auto(cp.static, cp.params, tp, sp_, fp)
        a = {k: np.asarray(getattr(sj, k)) for k in interop.pool_to_numpy(sp_)}
        b = interop.pool_to_numpy(sp_)
        assert_pools_match(a, b)
        np.testing.assert_array_equal(a["ptype"], b["ptype"], err_msg=f"frame {i}")
        np.testing.assert_array_equal(np.asarray(oj.alive_count_per_type), op.alive_count_per_type.numpy())
        assert _ulps(a["last_emitted"], b["last_emitted"]).max() <= 1, i
    live = op.alive_count_per_type.tolist()
    assert live[1] > 0 and live[0] < 2000 * 0.6  # rockets die on the floor before their lifetime


def _epilogue_from_words(cp, s, new, out):
    """The port's epilogue on a hybrid frame's post-frame planes and scalars
    (`new`, `out`: the plain hybrid frame's, which reduces) given a merge
    launch's words instead: the alive plane in the fields and
    `step.merge_latch`'s latch, as the card's merge launch passes them."""
    from bevy_firework_tpu_torch.step import active_f32_fields, epilogue, merge_latch

    fields = {k: getattr(new, k) for k in active_f32_fields(cp.static)}
    fields.update(ptype=new.ptype, alive=new.alive)
    scal = {k: getattr(new, k) for k in ("time_in_cycle", "last_emission", "enabled", "manual_queued",
                                         "ring_cursor")}
    latch = merge_latch(cp.static, s, new.enabled, new.alive)
    return epilogue(cp.static, cp.params, s, fields, scal, new.rng_key, True, None, None, new.last_emitted,
                    lambda: (out.nested_deferred, out.nested_dropped), latch=latch)


@pytest.mark.parametrize("dead_rank", [False, True])
def test_epilogue_given_the_merge_latch_matches_jax(dead_rank):
    """The hybrid frame's epilogue given the card merge launch's words (the
    post-frame alive plane, and any-alive, the finished event and the new
    finished_notified from `step.merge_latch`, in place of `age < life`,
    `alive.any()` and `finished_latch`) equals the epilogue that reduces,
    every pool field and output, frame by frame, and both equal the JAX
    package's hybrid frame (interpret mode) on the alive plane, the finished
    event and notified flag and the AABB's valid flag: 24 frames, then every
    emitter disabled until the pool empties and the event fires once. A
    ring config (`_chained`, 3 stages) and a dead-rank one (destroy on a
    floor), 8192 lanes."""
    if dead_rank:
        def spawner(pkg):
            col = pkg.ParticleCollisionSettings(restitution=0.5, friction=0.2, destroy_on_collision=True)
            sp = _chained(pkg, 2)
            return dataclasses.replace(sp, particle_settings=[dataclasses.replace(
                sp.particle_settings[0], acceleration=(0.0, -9.81, 0.0), collision_settings=col),
                sp.particle_settings[1]])
        tj = jx.compile_colliders([jx.Collider.halfspace(position=(0.0, -0.2, 0.0))])
        tp = pt.compile_colliders([pt.Collider.halfspace(position=(0.0, -0.2, 0.0))], device="cpu")
    else:
        spawner, tj, tp = _chained, None, None
    cj = jx.compile_spawner(spawner(jx), nested_buffer=128)
    cp = pt.compile_spawner(spawner(pt), nested_buffer=128, device="cpu")
    assert cp.static.ring_claim != dead_rank
    fj, fp = jx.make_frame_input(1 / 50), pt.make_frame_input(1 / 50)
    prev = jfs._FORCE_NESTED_MERGE_CPU
    jfs._FORCE_NESTED_MERGE_CPU = True
    fired = 0
    try:
        hybrid = jax.jit(lambda st, p, col, s, f: jfs.fused_step_hybrid(st, p, col, s, f), static_argnums=(0,))
        sj, sp = jx.init_pool_for(cj, 8192, 0), pt.init_pool_for(cp, 8192, 0)
        for i in range(64):
            if i == 24:  # every emitter off: the pool empties, then the spawner finishes
                sj = dataclasses.replace(sj, enabled=jax.numpy.zeros_like(sj.enabled))
                sp = dataclasses.replace(sp, enabled=torch.zeros_like(sp.enabled))
            with pltpu.force_tpu_interpret_mode():
                sj, oj = hybrid(cj.static, cj.params, tj, sj, fj)
            new, out = pt.step_auto(cp.static, cp.params, tp, sp, fp)
            got, got_out = _epilogue_from_words(cp, sp, new, out)
            for f in dataclasses.fields(new):
                assert torch.equal(getattr(got, f.name), getattr(new, f.name)), (i, f.name)
            for f in dataclasses.fields(out):
                assert torch.equal(getattr(got_out, f.name), getattr(out, f.name)), (i, f.name)
            np.testing.assert_array_equal(np.asarray(sj.alive), got.alive.numpy(), err_msg=f"frame {i}")
            for k, v in (("finished_event", got_out.finished_event), ("aabb_valid", got_out.aabb_valid)):
                assert bool(getattr(oj, k)) == bool(v), (i, k)
            assert bool(sj.finished_notified) == bool(got.finished_notified), i
            fired += int(got_out.finished_event)
            sp = new
    finally:
        jfs._FORCE_NESTED_MERGE_CPU = prev
    assert fired == 1 and bool(sp.finished_notified) and not bool(sp.alive.any())


# ------------------------------------------------------ oracle ports


def _nested_spawner(pkg, parent_rate=12.0, children_per_parent=6.0, parent_life=5.0, child_life=2.0, window=0.1):
    return pkg.ParticleSpawner(
        particle_settings=[
            pkg.ParticleSettings(lifetime=pkg.RandF32.constant(parent_life), initial_scale=pkg.RandF32.constant(0.2),
                                 acceleration=(0.0, -9.81, 0.0), linear_drag=0.0),
            pkg.ParticleSettings(lifetime=pkg.RandF32.constant(child_life), initial_scale=pkg.RandF32.constant(0.1),
                                 acceleration=(0.0, 0.3, 0.0), linear_drag=0.0),
        ],
        emission_settings=[
            pkg.EmissionSettings(particle_index=0, emission_pacing=pkg.EmissionPacing.rate(parent_rate),
                                 initial_velocity=pkg.RandVec3.constant((0.5, 3.0, 0.0))),
            pkg.EmissionSettings(particle_index=1, emission_mode=pkg.EmissionMode.nested(0),
                                 emission_pacing=pkg.EmissionPacing.count_over_duration(children_per_parent, 1.0, 0.0,
                                                                                        window),
                                 inherit_parent_velocity=True),
        ],
    )


def _burst_spawner(pkg, n_parents, children_per_parent, window=0.001, child_life=100.0):
    return pkg.ParticleSpawner(
        particle_settings=[
            pkg.ParticleSettings(lifetime=pkg.RandF32.constant(5.0), linear_drag=0.0, acceleration=(0, 0, 0)),
            pkg.ParticleSettings(lifetime=pkg.RandF32.constant(child_life), linear_drag=0.0,
                                 acceleration=(0, 0, 0))],
        emission_settings=[
            pkg.EmissionSettings(particle_index=0, emission_pacing=pkg.EmissionPacing.one_shot(n_parents)),
            pkg.EmissionSettings(particle_index=1, emission_mode=pkg.EmissionMode.nested(0),
                                 emission_pacing=pkg.EmissionPacing.count_over_duration(
                                     float(children_per_parent), 1.0, 0.0, window))])


def _run_port(sp, n_frames, dt, capacity=4096, nested_buffer=4096, snaps=False):
    c = pt.compile_spawner(sp, nested_buffer=nested_buffer, device="cpu")
    s = pt.init_pool_for(c, capacity, 0)
    f = pt.make_frame_input(dt)
    counts, outs, shots = [], [], []
    for _ in range(n_frames):
        s, o = pt.step_auto(c.static, c.params, None, s, f)
        counts.append(o.alive_count_per_type.numpy().copy())
        outs.append(o)
        if snaps:
            a = s.alive
            shots.append({"pos": torch.stack([s.px[a], s.py[a], s.pz[a]], -1).numpy(),
                          "vel": torch.stack([s.vx[a], s.vy[a], s.vz[a]], -1).numpy(), "age": s.age[a].numpy()})
    return counts, outs, shots, s


def _run_oracle(sp, n_frames, dt, snaps=False):
    st = oracle_init(sp)
    counts, shots = [], []
    for _ in range(n_frames):
        oracle_step(sp, st, dt)
        counts.append(np.array([len(p) for p in st.particles]))
        if snaps:
            parts = [p for pl in st.particles for p in pl]
            shots.append({"pos": np.array([p.position for p in parts]).reshape(-1, 3),
                          "vel": np.array([p.velocity for p in parts]).reshape(-1, 3),
                          "age": np.array([p.age for p in parts])})
    return counts, shots


def _run_jax_step(sp, n_frames, dt, capacity=4096, nested_buffer=4096):
    c = jx.compile_spawner(sp, nested_buffer=nested_buffer)
    s = jx.init_pool_for(c, capacity, 0)
    counts = []
    for _ in range(n_frames):
        s, o = step_jit(c.static, c.params, None, s, jx.make_frame_input(dt))
        counts.append(np.asarray(o.alive_count_per_type))
    return counts


def _sorted(a):
    a = np.asarray(a, np.float64)
    if a.ndim == 1:
        return np.sort(a)
    return a[np.lexsort(a.T[::-1])] if a.size else a


def test_nested_counts_and_trajectories_match_oracle():
    """180 frames of the textures-style config: per-type counts equal the
    oracle's and the JAX XLA step's every frame; sorted positions,
    velocities and ages within 3e-4 of the oracle's."""
    dt, n = 1.0 / 60.0, 180
    pc, _o, ps, _s = _run_port(_nested_spawner(pt), n, dt, snaps=True)
    oc, os_ = _run_oracle(_nested_spawner(jx), n, dt, snaps=True)
    jc = _run_jax_step(_nested_spawner(jx), n, dt)
    for fi in range(n):
        np.testing.assert_array_equal(pc[fi], oc[fi], err_msg=f"frame {fi}")
        np.testing.assert_array_equal(pc[fi], jc[fi], err_msg=f"frame {fi}")
        for key in ("pos", "vel", "age"):
            np.testing.assert_allclose(_sorted(ps[fi][key]), _sorted(os_[fi][key]), atol=3e-4,
                                       err_msg=f"frame {fi} {key}")
    assert pc[-1][1] > 0


def test_children_only_in_window():
    """One parent: every child appears within window * parent life; count
    within the reference's own off-by-one (core.rs:830-834)."""
    sp = pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(lifetime=pt.RandF32.constant(2.0), acceleration=(0, 0, 0)),
                           pt.ParticleSettings(lifetime=pt.RandF32.constant(10.0), acceleration=(0, 0, 0))],
        emission_settings=[pt.EmissionSettings(particle_index=0, emission_pacing=pt.EmissionPacing.one_shot(1)),
                           pt.EmissionSettings(particle_index=1, emission_mode=pt.EmissionMode.nested(0),
                                               emission_pacing=pt.EmissionPacing.count_over_duration(6.0, 1.0, 0.0,
                                                                                                     0.1))])
    counts, _o, _s, _st = _run_port(sp, 100, 0.01, capacity=64)
    child = [int(c[1]) for c in counts]
    assert child[-1] in (5, 6) and child[int(0.25 / 0.01)] == child[-1] and child[0] == 0


def test_nested_invalid_pacing_skipped():
    """Nested + OneShot is invalid: the emitter never emits (core.rs:481)."""
    sp = pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(lifetime=pt.RandF32.constant(1.0)),
                           pt.ParticleSettings(lifetime=pt.RandF32.constant(1.0))],
        emission_settings=[pt.EmissionSettings(particle_index=0, emission_pacing=pt.EmissionPacing.one_shot(2)),
                           pt.EmissionSettings(particle_index=1, emission_mode=pt.EmissionMode.nested(0),
                                               emission_pacing=pt.EmissionPacing.one_shot(5))])
    with pytest.warns(UserWarning, match="Nested"):
        counts, _o, _s, _st = _run_port(sp, 30, 1 / 60, capacity=64)
    assert all(int(c[1]) == 0 for c in counts) and max(int(c[0]) for c in counts) == 2


def test_nested_overflow_defers_not_drops():
    """410 parents x 10 children in one frame against M = 4096: 4 deferred,
    none dropped, all 4100 alive a frame later (the oracle's total)."""
    dt = 1.0 / 60.0
    counts, outs, _s, _st = _run_port(_burst_spawner(pt, 410, 10), 6, dt, capacity=8192)
    deferred = [int(o.nested_deferred) for o in outs]
    assert all(int(o.nested_dropped) == 0 for o in outs)
    assert deferred[1] == 4100 - 4096 and counts[1][1] == 4096
    assert counts[-1][1] == 4100 and sum(deferred[2:]) == 0
    assert int(_run_oracle(_burst_spawner(jx, 410, 10), 6, dt)[0][-1][1]) == 4100


def test_nested_capacity_overflow_is_counted():
    """256 slots for 64 parents and 640 children: 192 children live, the
    other 448 are dropped and counted."""
    counts, outs, _s, st = _run_port(_burst_spawner(pt, 64, 10), 4, 1 / 60, capacity=256)
    assert int((st.alive & (st.ptype == 1)).sum()) == 256 - 64
    assert sum(int(o.nested_dropped) for o in outs) == 640 - (256 - 64)


def test_children_inherit_parent_velocity():
    sp = pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(lifetime=pt.RandF32.constant(5.0), linear_drag=0.0,
                                               acceleration=(0, 0, 0)),
                           pt.ParticleSettings(lifetime=pt.RandF32.constant(5.0), linear_drag=0.0,
                                               acceleration=(0, 0, 0))],
        emission_settings=[
            pt.EmissionSettings(particle_index=0, emission_pacing=pt.EmissionPacing.one_shot(1),
                                initial_velocity=pt.RandVec3.constant((2.0, 0.0, 0.0))),
            pt.EmissionSettings(particle_index=1, emission_mode=pt.EmissionMode.nested(0),
                                emission_pacing=pt.EmissionPacing.count_over_duration(10.0, 1.0, 0.0, 1.0),
                                inherit_parent_velocity=True)])
    _c, _o, _s, st = _run_port(sp, 30, 0.05, capacity=128)
    child_vx = st.vx[st.alive & (st.ptype == 1)]
    assert child_vx.numel() > 0
    np.testing.assert_allclose(child_vx.numpy(), 2.0, atol=1e-5)


def test_small_nested_buffer_conserves():
    """nested_buffer = 64 spreads a 160-child burst over three frames and
    loses nothing."""
    counts, outs, _s, _st = _run_port(_burst_spawner(pt, 16, 10), 6, 1 / 60, capacity=1024, nested_buffer=64)
    c1 = [int(c[1]) for c in counts]
    assert c1[1] == 64 and int(outs[1].nested_deferred) == 96
    assert c1[2] == 128 and c1[3] == 160 and c1[-1] == 160


def test_fuzz_nested_buffer_conservation():
    """Random nested archetypes x random tiny buffers: after the settle
    frames the port's children total the unbuffered oracle's, less at most
    one per parent (the f32 re-anchoring's off-by-one, core.rs:830-834)."""
    rng = np.random.default_rng(11)
    for _trial in range(3):
        n_parents = int(rng.integers(3, 20))
        per = float(rng.integers(2, 9))
        window = float(rng.uniform(0.05, 0.3))
        buf = int(rng.integers(4, 40))

        def sp(pkg):
            return pkg.ParticleSpawner(
                particle_settings=[pkg.ParticleSettings(lifetime=pkg.RandF32.constant(4.0), acceleration=(0, 0, 0)),
                                   pkg.ParticleSettings(lifetime=pkg.RandF32.constant(50.0),
                                                        acceleration=(0, 0, 0))],
                emission_settings=[
                    pkg.EmissionSettings(particle_index=0, emission_pacing=pkg.EmissionPacing.one_shot(n_parents)),
                    pkg.EmissionSettings(particle_index=1, emission_mode=pkg.EmissionMode.nested(0),
                                         emission_pacing=pkg.EmissionPacing.count_over_duration(per, 1.0, 0.0,
                                                                                                window))])
        dt = 1.0 / 30.0
        frames = int(window * 4.0 / dt) + 8 + (n_parents * int(per)) // buf + 2
        _c, outs, _s, st = _run_port(sp(pt), frames, dt, capacity=1024, nested_buffer=buf)
        assert all(int(o.nested_dropped) == 0 for o in outs)
        port_children = int((st.alive & (st.ptype == 1)).sum())
        oracle_children = int(_run_oracle(sp(jx), frames, dt)[0][-1][1])
        assert oracle_children - n_parents <= port_children <= oracle_children


# ------------------------------------------------------------------ Scene


def _scene_counts(scene, sid, n, dt=1 / 60):
    out = []
    for _ in range(n):
        scene.step(dt)
        st = scene._spawners[sid].state
        out.append([int((np.asarray(st.alive) & (np.asarray(st.ptype) == t)).sum()) for t in range(2)])
    return np.asarray(out)


def _fireworks(pkg, pinned):
    from bevy_firework_tpu.models import effects as je
    from bevy_firework_tpu_torch.models import effects as pe

    sp, _tf = (je if pkg is jx else pe).fireworks()
    if pinned:  # constant lifetimes: the counts no longer depend on the draws
        ps = [dataclasses.replace(sp.particle_settings[0], lifetime=pkg.RandF32.constant(1.3)),
              dataclasses.replace(sp.particle_settings[1], lifetime=pkg.RandF32.constant(0.9))]
        sp = dataclasses.replace(sp, particle_settings=tuple(ps))
    return sp


@pytest.mark.parametrize("pinned", [True, False])
def test_fireworks_scene_matches_jax_scene(pinned):
    """effects.fireworks() through the port's CPU Scene and the JAX Scene for
    240 frames (four apex bursts of 80 sparkles). With the lifetimes pinned
    to constants every per-type count is within the one-particle cadence
    seam of the JAX Scene's; as authored (random lifetimes, drawn by each
    package's own generator) the rockets match until the first can die
    (1.1 s) and the sparkles agree in their mean over the last 2 s."""
    js, ps = jx.Scene(), pt.Scene(device="cpu")
    cj = _scene_counts(js, js.add_spawner(_fireworks(jx, pinned)), 240)
    cp = _scene_counts(ps, ps.add_spawner(_fireworks(pt, pinned)), 240)
    if pinned:
        for t in range(2):
            diff = np.abs(cp[:, t] - cj[:, t])
            assert diff.max() <= 1 and (diff == 0).mean() >= 0.9, (t, diff)
    else:
        assert np.abs(cp[:66, 0] - cj[:66, 0]).max() <= 1
        assert abs(cp[120:, 1].mean() - cj[120:, 1].mean()) <= 0.2 * cj[120:, 1].mean()
    assert cp[-1, 1] > 100


def test_textures_scene_with_colliders_matches_jax_scene():
    """effects.textures(): spinning shell casings bouncing on a cylinder
    base and a cone, each puffing 6 nested smoke particles in its first
    10% of life, through the port's CPU Scene and the JAX Scene for 420
    frames: per-type counts within the one-particle cadence seam; render
    items of both types."""
    from bevy_firework_tpu.models import effects as je
    from bevy_firework_tpu_torch.models import effects as pe

    spj, tfj, colj = je.textures()
    spp, tfp, colp = pe.textures()
    js, ps = jx.Scene(colliders=colj), pt.Scene(colliders=colp, device="cpu")
    sj = js.add_spawner(spj, transform=tfj)
    sp = ps.add_spawner(spp, transform=tfp)
    cj, cp = _scene_counts(js, sj, 420), _scene_counts(ps, sp, 420)
    for t in range(2):
        diff = np.abs(cp[:, t] - cj[:, t])
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.9, (t, diff)
    assert cp[-1, 0] > 40 and cp[-1, 1] > 100
    st = ps._spawners[sp].state
    shells = st.alive & (st.ptype == 0)
    assert bool((st.py[shells] > -0.2).all())  # nobody through the base
    assert {i.type_index for i in ps.render_items()} == {0, 1}
