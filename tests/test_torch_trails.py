"""The port's ribbon trails (`bevy_firework_tpu_torch.trails` and the Scene's
trail path) against the JAX package's, on the CPU.

The same deterministic spawner (constant draws, point shape) goes through
the JAX Scene and the port's; hcount, head and segment counts are held
exactly, positions and segment rows within the Scene tests' ATOL = 1e-4
(XLA on the CPU contracts multiply-adds, the port rounds each operation).
Frames of 1/64 s, a rate of 256/s and a lifetime of 1/4 s make every
cadence value and age exact in f32, which keeps the rate cadence off the
seam the Scene tests describe. Random spawners (whose draws
differ between the packages) are held to the properties the JAX package's
tests hold, on the port alone."""

import dataclasses

import numpy as np
import pytest
import torch

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from bevy_firework_tpu import trails as jtrails
from bevy_firework_tpu_torch import trails as ptrails
from test_torch_common import _one_torch_thread  # noqa: F401

ATOL = 1e-4
DT = 1 / 64


def ballistic(pkg, n=8, lifetime=1.0):
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(
            lifetime=pkg.RandF32.constant(lifetime), initial_scale=pkg.RandF32.constant(1.0),
            acceleration=(0.0, 0.0, 0.0), linear_drag=0.0)],
        emission_settings=[pkg.EmissionSettings(
            emission_pacing=pkg.EmissionPacing.one_shot(n),
            initial_velocity=pkg.RandVec3.constant((1.0, 0.0, 0.0)))])


def churn(pkg, rate=256.0, speed=4.0, lifetime=0.25):
    """A ring pool re-tenanting its slots every few frames (constant draws)."""
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(
            lifetime=pkg.RandF32.constant(lifetime), initial_scale=pkg.RandF32.constant(1.0),
            acceleration=(0.0, 0.0, 0.0), linear_drag=0.0)],
        emission_settings=[pkg.EmissionSettings(
            emission_pacing=pkg.EmissionPacing.rate(rate),
            initial_velocity=pkg.RandVec3.constant((speed, 0.0, 0.0)))])


def scenes(seed=1):
    return jx.Scene(seed=seed), pt.Scene(seed=seed, device="cpu")


def add_both(js, ps, make, capacity, trail, **kw):
    """The same spawner and trail in both scenes; kw values are functions
    of the package."""
    a = js.add_spawner(make(jx), capacity=capacity, trail=jx.TrailSettings(**trail),
                       **{k: v(jx) for k, v in kw.items()})
    b = ps.add_spawner(make(pt), capacity=capacity, trail=pt.TrailSettings(**trail),
                       **{k: v(pt) for k, v in kw.items()})
    assert a == b
    return a


def same_trails(js, ps):
    """Every trailed spawner's trail state (hcount, head, prev_alive exact;
    prev_age of live lanes within ATOL) and trail items (ids, types,
    counts exact; segment rows within ATOL) agree."""
    for sid in ps.spawner_ids():
        tj, tp = js._spawners[sid].trail_state, ps._spawners[sid].trail_state
        if tj is None:
            assert tp is None
            continue
        np.testing.assert_array_equal(tp.hcount.numpy(), np.asarray(tj.hcount), err_msg=f"{sid} hcount")
        assert int(tp.head) == int(tj.head)
        np.testing.assert_array_equal(tp.prev_alive.numpy(), np.asarray(tj.prev_alive))
        live = np.asarray(tj.prev_alive)
        np.testing.assert_allclose(tp.prev_age.numpy()[live], np.asarray(tj.prev_age)[live], atol=ATOL, rtol=0)
    ij, ip = js.trail_items(), ps.trail_items()
    assert [(i.spawner_id, i.type_index, i.count) for i in ip] == [(i.spawner_id, i.type_index, i.count) for i in ij]
    for a, b in zip(ij, ip):
        assert b.segments.dtype == np.float32 and b.segments.shape == (b.count, 16) and b.layers == a.layers
        assert b.uniform.to_bytes() == a.uniform.to_bytes()
        np.testing.assert_allclose(b.segments, a.segments, atol=ATOL, rtol=0)
    return ip


def step_both(js, ps, n, dt=DT):
    for _ in range(n):
        js.step(dt)
        ps.step(dt)


# ---------------------------------------------------------------- module


def _random_pool(rng, n):
    alive = rng.uniform(size=n) < 0.6
    return {"px": rng.normal(size=n).astype(np.float32), "py": rng.normal(size=n).astype(np.float32),
            "pz": rng.normal(size=n).astype(np.float32), "age": rng.uniform(0, 1, n).astype(np.float32),
            "alive": alive}


@pytest.mark.parametrize("elapsed", [None, 0.02])
def test_update_and_pack_match_jax(elapsed):
    """update_trails over 12 records of seeded random pools (ages that run
    backwards, lanes dying and respawning) and pack_trail_segments of the
    result, with and without taper, both types: == the JAX package's
    functions (history, hcount, head exact; planes within ATOL; counts
    exact); compact_segments == native.compact_dense of the same planes."""
    from bevy_firework_tpu.native import compact_dense

    rng = np.random.default_rng(7)
    n, k = 300, 5
    settings_j, settings_p = jx.TrailSettings(length=k, width=0.4), pt.TrailSettings(length=k, width=0.4)
    tj = jtrails.init_trail_state(settings_j, n)
    tp = ptrails.init_trail_state(settings_p, n, device="cpu")
    base_j = jx.init_pool(n, 1)
    for _ in range(12):
        f = _random_pool(rng, n)
        sj = dataclasses.replace(base_j, **f)
        sp = dataclasses.replace(pt.init_pool(n, 1, device="cpu"), **{k2: torch.from_numpy(v) for k2, v in f.items()})
        tj = jtrails.update_trails(tj, sj, None if elapsed is None else np.float32(elapsed))
        tp = ptrails.update_trails(tp, sp, elapsed)
        for name in ("hx", "hy", "hz", "hcount", "head", "prev_age", "prev_alive"):
            np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(tj, name)), err_msg=name)
    # a two-type spawner to pack: scale and colour curves by type
    sp2 = lambda pkg: pkg.ParticleSpawner(  # noqa: E731
        particle_settings=[pkg.ParticleSettings(scale_curve=pkg.FireworkCurve.uneven_samples([(0.0, 1.0), (1.0, 0.5)])),
                           pkg.ParticleSettings(base_color=pkg.gradient_uneven_samples(
                               [(0.0, (1, 0.5, 0.2, 1)), (1.0, (0, 0, 0, 0.2))]))],
        emission_settings=[pkg.EmissionSettings()])
    cj, cp = jx.compile_spawner(sp2(jx)), pt.compile_spawner(sp2(pt), device="cpu")
    f = _random_pool(rng, n)
    extra = {"ptype": rng.integers(0, 2, n).astype(np.int32), "lifetime": rng.uniform(1.0, 2.0, n).astype(np.float32),
             "initial_scale": rng.uniform(0.1, 0.3, n).astype(np.float32)}
    f.update(extra)
    sj = dataclasses.replace(jx.init_pool(n, 1), **f)
    sp = dataclasses.replace(pt.init_pool(n, 1, device="cpu"), **{k2: torch.from_numpy(v) for k2, v in f.items()})
    for taper in (True, False):
        setj, setp = jx.TrailSettings(length=k, width=0.4, taper=taper), pt.TrailSettings(length=k, width=0.4,
                                                                                           taper=taper)
        for t in (0, 1):
            pj, nj = jtrails.pack_trail_segments(setj, cj.params, sj, tj, t)
            pp, np_ = ptrails.pack_trail_segments(setp, cp.params, sp, tp, t)
            assert pp.shape == (16, (k - 1) * n) and int(np_) == int(nj) > 0
            np.testing.assert_allclose(pp.numpy(), np.asarray(pj), atol=ATOL, rtol=0)
            rows = ptrails.compact_segments(pp).numpy()
            np.testing.assert_array_equal(rows, compact_dense(pp.numpy()))
            assert rows.shape[0] == int(np_)


def test_update_trails_stacked_equals_per_slot():
    """The stacked update (a head per slot) == each slot's own update, bit
    for bit, with the heads out of step."""
    rng = np.random.default_rng(3)
    n, k, s = 64, 4, 3
    settings = pt.TrailSettings(length=k)
    solo = [ptrails.init_trail_state(settings, n, device="cpu") for _ in range(s)]
    solo[1] = ptrails.update_trails(solo[1], dataclasses.replace(pt.init_pool(n, 1, device="cpu"), **{
        k2: torch.from_numpy(v) for k2, v in _random_pool(rng, n).items()}), 0.02)
    stacked = ptrails.stack_trails(solo)
    for _ in range(6):
        pools = [dataclasses.replace(pt.init_pool(n, 1, device="cpu"), **{
            k2: torch.from_numpy(v) for k2, v in _random_pool(rng, n).items()}) for _ in range(s)]
        solo = [ptrails.update_trails(t, p, 0.02) for t, p in zip(solo, pools)]
        stacked = ptrails.update_trails_stacked(stacked, pt.stack_pools(pools), 0.02)
    for j in range(s):
        row = ptrails.trail_slot(stacked, j)
        for name in ptrails.TRAIL_FIELDS:
            assert torch.equal(getattr(row, name), getattr(solo[j], name)), name


def test_trail_settings_validation():
    with pytest.raises(ValueError, match="length"):
        pt.TrailSettings(length=1)
    with pytest.raises(ValueError, match="width"):
        pt.TrailSettings(width=0.0)
    assert pt.TrailSettings() == pt.TrailSettings(length=8, width=0.25, taper=True)


# ----------------------------------------------------------------- Scene


def test_history_matches_past_positions():
    """K = 4 history of a constant-velocity burst in both Scenes: every
    segment endpoint an exact past position, widths and alphas tapered."""
    k = 4
    js, ps = scenes()
    add_both(js, ps, lambda pkg: ballistic(pkg, n=8), 256, dict(length=k, width=0.5))
    step_both(js, ps, 6, 1 / 60)
    items = same_trails(js, ps)
    seg = items[0].segments
    assert items[0].count == 8 * (k - 1)
    dt = 1 / 60
    for s in range(k - 1):
        rows = seg[np.isclose(seg[:, 0], (6 - s) * dt)]
        assert rows.shape[0] == 8
        np.testing.assert_allclose(rows[:, 4], (5 - s) * dt, rtol=1e-6)
        np.testing.assert_allclose(rows[:, 3], 0.5 * (1 - s / (k - 1)), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(rows[:, 7], 0.5 * (1 - (s + 1) / (k - 1)), rtol=1e-6, atol=1e-7)
    assert (seg[:, 11] >= seg[:, 15]).all()


def test_history_saturates_and_rings():
    """After more than K frames the buffer rings: K-1 segments per particle
    over the K most recent positions; no taper: equal widths."""
    k = 3
    js, ps = scenes()
    add_both(js, ps, lambda pkg: ballistic(pkg, n=4, lifetime=5.0), 256, dict(length=k, width=1.0, taper=False))
    step_both(js, ps, 10, 1 / 60)
    seg = same_trails(js, ps)[0].segments
    assert seg.shape[0] == 4 * (k - 1)
    xs = np.sort(np.unique(np.round(np.concatenate([seg[:, 0], seg[:, 4]]), 6)))
    np.testing.assert_allclose(xs, [8 / 60, 9 / 60, 10 / 60], rtol=1e-5)
    np.testing.assert_allclose(seg[:, 3], seg[:, 7])


def test_respawn_resets_history_no_teleport_segments():
    """Ring slot reuse: a re-tenanted slot inherits no history, so no
    segment spans more than one frame's travel; the deterministic churn ==
    the JAX Scene's every 10 frames, and a random-speed churn (the JAX
    package's test) holds the property on the port."""
    js, ps = scenes(2)
    add_both(js, ps, churn, 64, dict(length=6, width=0.2))
    for f in range(60):
        js.step(DT)
        ps.step(DT)
        for item in ps.trail_items():
            d = item.segments[:, 0:3] - item.segments[:, 4:7]
            assert np.sqrt((d * d).sum(axis=1)).max(initial=0.0) <= 4.0 * DT * 1.05, f"teleport at frame {f}"
        if f % 10 == 9:
            same_trails(js, ps)
    sp = pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(lifetime=pt.RandF32.constant(0.2),
                                               initial_scale=pt.RandF32.constant(1.0),
                                               acceleration=(0.0, 0.0, 0.0), linear_drag=0.0)],
        emission_settings=[pt.EmissionSettings(emission_pacing=pt.EmissionPacing.rate(300.0),
                                               initial_velocity=pt.RandVec3(pt.RandF32(min=1.0, max=4.0),
                                                                            (1.0, 0.0, 0.0), 0.3))])
    scene = pt.Scene(seed=2, device="cpu")
    scene.add_spawner(sp, capacity=64, trail=pt.TrailSettings(length=6, width=0.2))
    for f in range(80):
        scene.step(1 / 60)
        for item in scene.trail_items():
            d = item.segments[:, 0:3] - item.segments[:, 4:7]
            assert np.sqrt((d * d).sum(axis=1)).max(initial=0.0) <= 4.0 / 60 * 1.5, f"teleport at frame {f}"


def test_trail_items_empty_and_step_n_cadence():
    """No trail, no items; a step_n window records one point (no segment
    yet), the next step one segment per particle: as the JAX Scene."""
    ps = pt.Scene(seed=1, device="cpu")
    ps.add_spawner(ballistic(pt), capacity=256)
    ps.step(DT)
    assert ps.trail_items() == [] and ps._spawners[0].trail_state is None
    js, ps = scenes()
    add_both(js, ps, ballistic, 256, dict(length=8))
    js.step_n(DT, 5)
    ps.step_n(DT, 5)
    assert ps.trail_items() == [] == js.trail_items()
    step_both(js, ps, 1)
    assert same_trails(js, ps)[0].segments.shape[0] == 8


def test_sorted_trail_segments():
    """camera_pos sorts an order-dependent blend's segments back to front
    (midpoint key); the multiset of rows is unchanged and equals the JAX
    Scene's sorted rows."""
    js, ps = scenes(3)
    add_both(js, ps, lambda pkg: ballistic(pkg, n=16), 256, dict(length=4))
    step_both(js, ps, 8)
    cam = (0.0, 1.0, -4.0)
    seg = ps.trail_items(camera_pos=cam)[0].segments
    mid = 0.5 * (seg[:, 0:3] + seg[:, 4:7]) - np.asarray(cam, np.float32)
    d2 = (mid * mid).sum(axis=1)
    assert (np.diff(d2) <= 1e-6).all()
    np.testing.assert_array_equal(np.sort(seg, axis=0), np.sort(ps.trail_items()[0].segments, axis=0))
    np.testing.assert_allclose(seg, js.trail_items(camera_pos=cam)[0].segments, atol=ATOL, rtol=0)


def test_set_spawner_clears_trails_and_layers_filter():
    js, ps = scenes()
    sid = add_both(js, ps, ballistic, 256, dict(length=4), layers=lambda pkg: 0b10)
    step_both(js, ps, 5)
    assert same_trails(js, ps)
    assert ps.trail_items(view_layers=0b01) == [] and ps.trail_items(view_layers=0b10)
    js.set_spawner(sid, ballistic(jx, n=4))
    ps.set_spawner(sid, ballistic(pt, n=4))
    assert ps.trail_items() == [] == js.trail_items()
    step_both(js, ps, 3)
    assert same_trails(js, ps)[0].count == 4 * 2


def test_step_n_window_retenant_does_not_bridge_history():
    """A slot whose tenant dies inside a step_n window and is re-claimed
    comes back older than the previous record; the elapsed rule cuts its
    history (the emitter moves 100 units between windows, so a bridged
    segment would be unmistakable), == the JAX Scene; continuing tenants
    keep accumulating history across windows."""
    js, ps = scenes(2)
    sid = add_both(js, ps, churn, 64, dict(length=6, width=0.2))
    step_both(js, ps, 1)
    for w in range(6):
        js.set_transform(sid, jx.Transform(translation=(0.0, 0.0, 100.0 * w)))
        ps.set_transform(sid, pt.Transform(translation=(0.0, 0.0, 100.0 * w)))
        js.step_n(DT, 25)
        ps.step_n(DT, 25)
        for item in same_trails(js, ps):
            d = item.segments[:, 0:3] - item.segments[:, 4:7]
            assert np.sqrt((d * d).sum(axis=1)).max(initial=0.0) <= 4.0 * DT * 25 * 1.05
    js, ps = scenes()
    add_both(js, ps, lambda pkg: ballistic(pkg, n=4, lifetime=10.0), 256, dict(length=6))
    step_both(js, ps, 1)
    for _ in range(4):
        js.step_n(DT, 10)
        ps.step_n(DT, 10)
    seg = same_trails(js, ps)[0].segments
    assert seg.shape[0] == 4 * 4
    d = seg[:, 0:3] - seg[:, 4:7]
    np.testing.assert_allclose(np.sqrt((d * d).sum(1)), 10 * DT, rtol=1e-4)


def test_trails_with_archetype_batched_spawners():
    """Two same-archetype trailed spawners step as one group: stacked
    trails on the batch, each member its own history, == the JAX Scene."""
    js, ps = scenes(4)
    a = add_both(js, ps, lambda pkg: ballistic(pkg, n=4), 256, dict(length=4, width=0.3))
    b = add_both(js, ps, lambda pkg: ballistic(pkg, n=4), 256, dict(length=4, width=0.3),
                 transform=lambda pkg: pkg.Transform(translation=(0.0, 10.0, 0.0)))
    step_both(js, ps, 6)
    assert ps._last_step_dispatches == 1 and next(iter(ps._batches.values())).trails is not None
    items = {it.spawner_id: it for it in same_trails(js, ps)}
    assert np.abs(items[a].segments[:, 1]).max() < 1.0 and items[b].segments[:, 1].min() > 9.0
    np.testing.assert_allclose(items[a].segments[:, 0], items[b].segments[:, 0], atol=1e-5)


def _group_scene(seed, taper_b=True):
    sc = pt.Scene(seed=seed, device="cpu")
    a = sc.add_spawner(ballistic(pt, n=6), capacity=256, trail=pt.TrailSettings(length=5, width=0.3))
    b = sc.add_spawner(ballistic(pt, n=6), capacity=256, transform=pt.Transform(translation=(0.0, 7.0, 0.0)),
                       trail=pt.TrailSettings(length=5, width=0.3, taper=taper_b))
    return sc, a, b


def test_group_stacked_trails_match_per_slot_path():
    """The stacked group update == the per-member path bit for bit (a
    member's settings made unequal takes the group off the stacked path),
    through a member's set_spawner (restack), and == the JAX Scene."""
    scene, a, b = _group_scene(9)
    ref, ra, rb = _group_scene(9, taper_b=False)
    js = jx.Scene(seed=9)
    js.add_spawner(ballistic(jx, n=6), capacity=256, trail=jx.TrailSettings(length=5, width=0.3))
    js.add_spawner(ballistic(jx, n=6), capacity=256, transform=jx.Transform(translation=(0.0, 7.0, 0.0)),
                   trail=jx.TrailSettings(length=5, width=0.3))
    for _ in range(8):
        scene.step(DT)
        ref.step(DT)
        js.step(DT)
    assert next(iter(scene._batches.values())).trails is not None
    assert next(iter(ref._batches.values())).trails is None
    for sid in (a, b):
        for name in ptrails.TRAIL_FIELDS:
            assert torch.equal(getattr(scene._spawners[sid].trail_state, name),
                               getattr(ref._spawners[sid].trail_state, name)), name
    got = {it.spawner_id: it.segments for it in scene.trail_items()}
    want = {it.spawner_id: it.segments for it in ref.trail_items()}
    np.testing.assert_array_equal(got[a], want[ra])
    np.testing.assert_array_equal(got[b][:, [0, 1, 2, 4, 5, 6]], want[rb][:, [0, 1, 2, 4, 5, 6]])
    same_trails(js, scene)
    scene.set_spawner(b, ballistic(pt, n=4))
    js.set_spawner(b, ballistic(jx, n=4))
    for _ in range(4):
        scene.step(DT)
        js.step(DT)
    items = {it.spawner_id: it for it in same_trails(js, scene)}
    assert items[b].segments.shape[0] == 4 * 3 and np.abs(items[a].segments[:, 1]).max() < 1.0


def test_group_trail_authority_survives_transitions():
    """The stacked authority hands off at every transition, as the JAX
    Scene's: member removal (the survivor steps alone), addition (restack),
    settings divergence (stacked -> per member), set_spawner mid-group, and
    an edit (queue_particles) that takes a member off the batch."""
    ts = dict(length=5, width=0.3)
    js, ps = scenes(1)
    trailed = lambda pkg: ballistic(pkg, n=4, lifetime=10.0)  # noqa: E731
    a = add_both(js, ps, trailed, 256, ts)
    b = add_both(js, ps, trailed, 256, ts, transform=lambda pkg: pkg.Transform(translation=(0.0, 7.0, 0.0)))
    step_both(js, ps, 3)
    js.remove_spawner(b)
    ps.remove_spawner(b)
    step_both(js, ps, 1)
    assert {it.spawner_id: it.count for it in same_trails(js, ps)} == {a: 4 * 3}
    c = add_both(js, ps, trailed, 256, ts, transform=lambda pkg: pkg.Transform(translation=(0.0, 14.0, 0.0)))
    step_both(js, ps, 2)
    assert next(iter(ps._batches.values())).trails is not None
    assert {it.spawner_id: it.count for it in same_trails(js, ps)} == {a: 4 * 4, c: 4 * 1}
    js._spawners[c].trail_settings = jx.TrailSettings(length=5, width=0.3, taper=False)
    ps._spawners[c].trail_settings = pt.TrailSettings(length=5, width=0.3, taper=False)
    step_both(js, ps, 1)
    assert next(iter(ps._batches.values())).trails is None
    assert {it.spawner_id: it.count for it in same_trails(js, ps)} == {a: 4 * 4, c: 4 * 2}

    js, ps = scenes(2)
    d = add_both(js, ps, trailed, 256, ts)
    e = add_both(js, ps, trailed, 256, ts, transform=lambda pkg: pkg.Transform(translation=(0.0, 7.0, 0.0)))
    step_both(js, ps, 4)
    js.set_spawner(e, ballistic(jx, n=2, lifetime=10.0))
    ps.set_spawner(e, ballistic(pt, n=2, lifetime=10.0))
    step_both(js, ps, 1)
    assert {it.spawner_id: it.count for it in same_trails(js, ps)} == {d: 4 * 4}
    step_both(js, ps, 1)
    assert {it.spawner_id: it.count for it in same_trails(js, ps)} == {d: 4 * 4, e: 2 * 1}
    js.queue_particles(d, 0)
    ps.queue_particles(d, 0)  # a member edit: its row leaves the batch, the next step restacks
    step_both(js, ps, 2)
    assert next(iter(ps._batches.values())).trails is not None
    assert {it.spawner_id: it.count for it in same_trails(js, ps)} == {d: 4 * 4, e: 2 * 3}
