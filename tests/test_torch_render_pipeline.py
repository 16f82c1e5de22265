"""The port's render extract against the JAX package: the pack family on
carried states, the step's f16 render pack against the JAX kernel's (in
interpret mode), `AsyncRenderReader` against the JAX reader, and the
Scene's async render and compact extract against the JAX Scene. Inputs
from numpy seeds; JAX states carried over with `interop.pool_from_numpy`."""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from bevy_firework_tpu.ops.fused_step import fused_step as jax_fused_step
from bevy_firework_tpu.render import pack_instances_dense_f16 as jax_pack_dense_f16
from bevy_firework_tpu.render import pack_instances_planar as jax_pack_planar
from bevy_firework_tpu.render_pipeline import AsyncRenderReader as JaxReader
from bevy_firework_tpu.step import step_jit
from bevy_firework_tpu_torch import interop
from bevy_firework_tpu_torch.render import pack_render_planes
from bevy_firework_tpu_torch.render_pipeline import AsyncRenderReader
from test_torch_common import _one_torch_thread, effect, jax_pool_numpy  # noqa: F401

N = 8192
# contract columns from a curve or gradient lerp: XLA on the CPU contracts
# `v0 + (v1 - v0) * frac` into an FMA, the port rounds twice (1 f32 ulp;
# tests/test_torch_render.py); positions and the quaternion are copied
CURVE_COLS = (3, 8, 9, 10, 11, 12, 13, 14, 15)
EXACT_COLS = (0, 1, 2, 4, 5, 6, 7)


def _close32(a, b):
    np.testing.assert_allclose(a, b, rtol=float(np.finfo(np.float32).eps), atol=float(np.spacing(np.float32(150.0))))


def _jax_rows_of(scene, sid, spawner_j, t=0):
    """The JAX package's pack_instances rows of a port Scene spawner's pool
    (carried over to the JAX package): the reference extract of the same
    state. (Two Scenes stepped apart part by the XLA cadence seam, ROADMAP
    queue 3: a spawn can land a frame apart.)"""
    import jax.numpy as jnp

    slot = scene._spawners[sid]
    sj = jx.PoolState(**{k: jnp.asarray(v) for k, v in interop.pool_to_numpy(slot.state).items()})
    cj = jx.compile_spawner(spawner_j)
    buf, count = jx.pack_instances(cj.params, sj, t)
    return np.asarray(buf)[: int(count)]


def f16_ulps(a, b) -> int:
    """Largest distance in f16 units in the last place."""
    def key(x):
        i = np.asarray(x, np.float16).view(np.int16).astype(np.int32)
        return np.where(i < 0, -(i & 0x7FFF), i)
    return int(np.abs(key(a) - key(b)).max()) if np.size(a) else 0


def _two_types(pkg):
    """Two particle types with their own curves, one rate emitter each."""
    return pkg.ParticleSpawner(
        particle_settings=[
            pkg.ParticleSettings(
                lifetime=pkg.RandF32.constant(0.6), initial_scale=pkg.RandF32(0.05, 0.1),
                scale_curve=pkg.FireworkCurve.uneven_samples([(0.0, 1.0), (0.7, 2.0), (1.0, 0.5)]),
                base_color=pkg.gradient_uneven_samples([(0.0, (1, 0.5, 0.2, 1)), (1.0, (0, 0, 0, 0))])),
            pkg.ParticleSettings(
                lifetime=pkg.RandF32(0.3, 0.9),
                base_color=pkg.gradient_uneven_samples([(0.0, (0.2, 0.4, 1, 1)), (0.5, (1, 1, 1, 0.5)),
                                                        (1.0, (0, 0, 0, 0))]),
                emissive_color=pkg.gradient_uneven_samples([(0.0, (3, 2, 1, 1)), (1.0, (0, 0, 0, 1))])),
        ],
        emission_settings=[
            pkg.EmissionSettings(particle_index=0, emission_pacing=pkg.EmissionPacing.rate(3000.0),
                                 initial_velocity=pkg.RandVec3.constant((1.0, 3.0, 0.2))),
            pkg.EmissionSettings(particle_index=1, emission_pacing=pkg.EmissionPacing.rate(2000.0),
                                 initial_velocity=pkg.RandVec3.constant((-1.0, 2.0, 0.5)),
                                 initial_angular_velocity=pkg.RandVec3.constant((0.0, 2.0, 1.0))),
        ],
    )


def _spawners(pkg, name):
    if name == "two_types":
        return _two_types(pkg), pkg.make_frame_input(1 / 60)
    sp, tf = effect("jax" if pkg is jx else "torch", name, 6000.0 if name == "stress_test" else None)
    return sp, pkg.make_frame_input(1 / 60, translation=tf.translation)


def _carried(name, frames=40, n=N):
    spj, fj = _spawners(jx, name)
    spp, _f = _spawners(pt, name)
    cj, cp = jx.compile_spawner(spj), pt.compile_spawner(spp, device="cpu")
    sj = jx.init_pool_for(cj, n, 0)
    for _ in range(frames):
        sj, _o = step_jit(cj.static, cj.params, None, sj, fj)
    return cj, cp, sj, interop.pool_from_numpy(jax_pool_numpy(sj), device="cpu")


@pytest.mark.parametrize("name", ["sparks", "stress_test", "two_types"])
def test_pack_family_matches_jax(name):
    """pack_instances (rows), pack_instances_planar (planes) and
    pack_instances_dense_f16 of every type: counts and row order exact,
    positions and quaternion exact, curve columns within the 1-ulp FMA seam
    (f16: within 1 f16 ulp)."""
    cj, cp, sj, sp = _carried(name)
    for t in range(cp.num_types):
        rows_p, n_p = pt.pack_instances(cp.params, sp, t)
        rows_j, n_j = jx.pack_instances(cj.params, sj, t)
        count = int(n_j)
        assert int(n_p) == count > 0
        rows_p, rows_j = rows_p.numpy(), np.asarray(rows_j)
        assert rows_p.shape == rows_j.shape == (N, 16)
        assert not rows_p[count:].any()
        assert rows_p[:count, EXACT_COLS].tobytes() == rows_j[:count, EXACT_COLS].tobytes()
        _close32(rows_p[:count], rows_j[:count])
        planes_p, c_p = pt.pack_instances_planar(cp.params, sp, t)
        planes_j, c_j = jax_pack_planar(cj.params, sj, t)
        assert int(c_p) == int(c_j) == count
        np.testing.assert_array_equal(planes_p.numpy().T, rows_p)  # the same compaction, planar
        _close32(planes_p.numpy(), np.asarray(planes_j))
        d16_p, c16_p = pt.pack_instances_dense_f16(cp.params, sp, t)
        d16_j, c16_j = jax_pack_dense_f16(cj.params, sj, t)
        d16_p, d16_j = d16_p.numpy(), np.asarray(d16_j)
        assert d16_p.dtype == d16_j.dtype == np.float16 and int(c16_p) == int(c16_j) == count
        for col in range(16):
            if col in CURVE_COLS:
                assert f16_ulps(d16_p[col], d16_j[col]) <= 1, col
            else:
                assert d16_p[col].tobytes() == d16_j[col].tobytes(), col


def _f16_spawner(pkg, rotating: bool):
    """tests/test_fused_step.py's f16 spawner (rotation elided: 12 planes),
    or with an angular velocity (live rotation: 16 planes)."""
    extra = {"initial_angular_velocity": pkg.RandVec3.constant((0.0, 2.0, 0.0))} if rotating else {}
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(
            lifetime=pkg.RandF32.constant(0.3), initial_scale=pkg.RandF32.constant(0.1),
            scale_curve=pkg.FireworkCurve.uneven_samples([(0.0, 1.0), (1.0, 2.0)]),
            base_color=pkg.gradient_uneven_samples([(0.0, (1, 0.5, 0.2, 1)), (1.0, (0, 0, 0, 0))]))],
        emission_settings=[pkg.EmissionSettings(
            emission_pacing=pkg.EmissionPacing.rate(2000.0), initial_velocity=pkg.RandVec3.constant((1.0, 3.0, 0.2)),
            **extra)],
    )


def assert_record_is_f32_pack_rounded(static, state, p16, p32):
    """The f16 record == the f32 render pack and the state's positions (and
    quaternion) rounded to nearest even, bit for bit."""
    q = () if static.elide_rotation else (state.qx, state.qy, state.qz, state.qw)
    want = (state.px, state.py, state.pz, p32[0], *q, *p32[1:])
    assert len(p16) == len(want) == (12 if static.elide_rotation else 16)
    for i, (a, b) in enumerate(zip(p16, want)):
        assert a.dtype == torch.float16
        assert torch.equal(a.view(torch.int16), b.to(torch.float16).view(torch.int16)), i


@pytest.mark.parametrize("rotating", [False, True], ids=["12_planes", "16_planes"])
def test_fused_step_f16_matches_jax_kernel(rotating):
    """fused_step(pack_render="f16") on the CPU for 10 frames against the JAX
    package's kernel in interpret mode: the record's planes on live lanes
    within 1 f16 ulp (the pools part by the FMA seam, tests/
    test_torch_step.py), dead lanes' scale +-0 in both; and the port's record
    == its f32 pack rounded, exactly."""
    cj = jx.compile_spawner(_f16_spawner(jx, rotating))
    cp = pt.compile_spawner(_f16_spawner(pt, rotating), device="cpu")
    assert cj.static.elide_rotation == cp.static.elide_rotation == (not rotating)
    sj, sp = jx.init_pool_for(cj, N, 0), pt.init_pool_for(cp, N, 0)
    fj, fp = jx.make_frame_input(1 / 50), pt.make_frame_input(1 / 50)
    fused = jax.jit(jax_fused_step, static_argnums=(0, 5))
    for _ in range(10):
        with pltpu.force_tpu_interpret_mode():
            sj, _o, pj = fused(cj.static, cj.params, None, sj, fj, "f16")
        s32, _o32, p32 = pt.fused_step(cp.static, cp.params, None, sp, fp, pack_render=True)
        sp, _op, pp = pt.fused_step(cp.static, cp.params, None, sp, fp, pack_render="f16")
        assert_record_is_f32_pack_rounded(cp.static, sp, pp, p32)
        assert torch.equal(s32.px, sp.px)
    assert len(pj) == len(pp) == (16 if rotating else 12)
    alive = sp.alive.numpy()
    assert np.array_equal(alive, np.asarray(sj.alive)) and 0 < alive.sum() < N
    for i, (a, b) in enumerate(zip(pp, pj)):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype == np.float16
        assert f16_ulps(a[alive], b[alive]) <= 1, i
    for scale in (pp[3].numpy(), np.asarray(pj[3])):
        assert ((scale.view(np.uint16)[~alive] & 0x7FFF) == 0).all()


def test_hybrid_and_fleet_f16_record():
    """The f16 record of a hybrid frame (nested archetype) and of a fleet
    launch on the CPU: each the f32 pack rounded, a fleet slot's record ==
    its solo step's."""
    from bevy_firework_tpu_torch.models import effects

    sp, tf = effects.fireworks()
    c = pt.compile_spawner(sp, device="cpu")
    s = pt.init_pool_for(c, 4096)
    f = pt.make_frame_input(1 / 60, translation=tf.translation)
    for _ in range(60):
        s, _o = pt.step_auto(c.static, c.params, None, s, f)
    s32, _o, p32 = pt.fused_step_hybrid(c.static, c.params, None, s, f, pack_render=True)
    s16, _o, p16 = pt.fused_step_hybrid(c.static, c.params, None, s, f, pack_render="f16")
    assert int(s16.alive.sum()) > 0
    assert_record_is_f32_pack_rounded(c.static, s16, p16, p32)
    c2 = pt.compile_spawner(_two_types(pt), device="cpu")
    pools = [pt.init_pool_for(c2, 2048, seed=i) for i in range(3)]
    frames = pt.stack_frames([pt.make_frame_input(1 / 60, translation=(float(i), 0.0, 0.0)) for i in range(3)])
    states = pt.stack_pools(pools)
    for _ in range(20):
        states, _o = pt.fused_step_fleet(c2.static, c2.params, None, states, frames)
    st, _o, fp16 = pt.fused_step_fleet(c2.static, c2.params, None, states, frames, pack_render="f16")
    assert len(fp16) == 16 and fp16[0].shape == (3, 2048)
    from bevy_firework_tpu_torch.parallel.sharding import frame_slot, state_slot

    for i in range(3):
        solo, _o, p = pt.fused_step(c2.static, c2.params, None, state_slot(states, i), frame_slot(frames, i),
                                    pack_render="f16")
        for a, b in zip(p, fp16):
            assert torch.equal(a.view(torch.int16), b[i].view(torch.int16))


def test_pack_render_rejects_other_modes():
    c = pt.compile_spawner(_f16_spawner(pt, False), device="cpu")
    s = pt.init_pool_for(c, 256)
    with pytest.raises(ValueError, match="pack_render"):
        pt.fused_step(c.static, c.params, None, s, pt.make_frame_input(1 / 60), pack_render="bf16")


def _wait_frame(acquire, release, fid, timeout=10.0):
    """Poll a reader until it delivers frame `fid`; returns (rows copy, fid)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = acquire()
        if got is not None:
            rows, got_fid = got[0].copy(), got[1]
            release()
            if got_fid == fid:
                return rows, got_fid
        time.sleep(0.01)
    raise AssertionError(f"frame {fid} never arrived")


def _rate_spawner(pkg, rate, lifetime):
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(lifetime=pkg.RandF32.constant(lifetime))],
        emission_settings=[pkg.EmissionSettings(emission_pacing=pkg.EmissionPacing.rate(rate))])


@pytest.mark.parametrize("mode", ["dense", "compact"])
def test_async_reader_matches_sync_pack(mode):
    """The port's reader and the JAX package's, fed the same JAX-stepped
    states (carried over) for 30 frames: the last frame's rows equal the
    port's pack_instances exactly and the JAX reader's within the FMA
    seam."""
    cj = jx.compile_spawner(_rate_spawner(jx, 600.0, 5.0))
    cp = pt.compile_spawner(_rate_spawner(pt, 600.0, 5.0), device="cpu")
    sj = jx.init_pool_for(cj, 2048, 0)
    rp, rj = AsyncRenderReader(2048, 1, mode=mode), JaxReader(2048, 1, mode=mode)
    try:
        for f in range(30):
            sj, _o = step_jit(cj.static, cj.params, None, sj, jx.make_frame_input(1 / 60))
            sp = interop.pool_from_numpy(jax_pool_numpy(sj), device="cpu")
            rp.submit(cp.params, sp, frame_id=f)
            rj.submit(cj.params, sj, frame_id=f)
        got, _f = _wait_frame(lambda: rp.acquire(0), lambda: rp.release(0), 29)
        want, _f = _wait_frame(lambda: rj.acquire(0), lambda: rj.release(0), 29)
    finally:
        rp.close()
        rj.close()
    rows, count = pt.pack_instances(cp.params, sp, 0)
    assert got.shape == want.shape == (int(count), 16) and int(count) > 250
    np.testing.assert_array_equal(got, rows.numpy()[: int(count)])
    assert got[:, EXACT_COLS].tobytes() == want[:, EXACT_COLS].tobytes()
    _close32(got, want)


@pytest.mark.parametrize("record", ["f32", "f16"])
def test_submit_packed_roundtrip(record):
    """submit_packed (the step's render pack: 9 f32 planes with the state's
    positions, or the f16 record) delivers the synchronous extract's rows:
    the JAX package's pack_instances of the same state within the FMA seam
    (f16: those rows rounded, within 1 f16 ulp), the port's exactly."""
    cj = jx.compile_spawner(_rate_spawner(jx, 400.0, 2.0))
    cp = pt.compile_spawner(_rate_spawner(pt, 400.0, 2.0), device="cpu")
    sj = jx.init_pool_for(cj, 1024, 0)
    for _ in range(20):
        sj, _o = step_jit(cj.static, cj.params, None, sj, jx.make_frame_input(1 / 60))
    sp = interop.pool_from_numpy(jax_pool_numpy(sj), device="cpu")
    packed = pack_render_planes(cp.static, cp.params, sp, True if record == "f32" else "f16")
    reader = AsyncRenderReader(capacity=1024, num_types=1)
    try:
        reader.submit_packed(cp.static, sp, packed, frame_id=1)
        acquire = (lambda: reader.acquire(0)) if record == "f32" else (lambda: reader.acquire_f16(0))
        rows, _f = _wait_frame(acquire, lambda: reader.release(0), 1)
    finally:
        reader.close()
    buf, count = jx.pack_instances(cj.params, sj, 0)
    want = np.asarray(buf)[: int(count)]
    assert rows.shape == want.shape and int(count) > 0
    np.testing.assert_array_equal(rows, pt.planes_to_rows(cp.static, sp, packed))
    if record == "f32":
        _close32(rows, want)
    else:
        assert rows.dtype == np.float16
        assert f16_ulps(rows, want.astype(np.float16)) <= 1


def _sparks(pkg, rate=1000.0, lifetime=0.75):
    return _rate_spawner(pkg, rate, lifetime)


def _drain_until(scene, want_fid, timeout=10.0):
    """Poll render_async, keeping the newest item per (spawner, type) (rows
    copied out of the ring), until every kept item is at want_fid."""
    deadline = time.time() + timeout
    best = {}
    while time.time() < deadline:
        for it in scene.render_async():
            best[(it.spawner_id, it.type_index)] = dataclasses.replace(it, instances=it.instances.copy())
        if best and all(it.frame_id >= want_fid for it in best.values()):
            break
        time.sleep(0.01)
    scene.release_async()
    return list(best.values())


def _scenes():
    return jx.Scene(), pt.Scene(device="cpu")


def test_async_render_matches_sync_pack():
    """Both Scenes' async item of frame 60 against their synchronous
    render_items: 750 live, equal columns (sorted); the port's async rows ==
    the JAX package's pack_instances of the port's pool within the FMA
    seam."""
    for scene in _scenes():
        pkg = jx if isinstance(scene, jx.Scene) else pt
        scene.enable_async_render()
        sid = scene.add_spawner(_sparks(pkg), capacity=2048)
        for _ in range(60):
            scene.step(1 / 60)
        items = _drain_until(scene, 60)
        assert items and items[0].frame_id == 60
        sync = scene.render_items()
        assert items[0].count == sync[0].count == 750
        for col in range(16):
            np.testing.assert_allclose(np.sort(items[0].instances[:, col]), np.sort(sync[0].instances[:, col]),
                                       atol=1e-6)
        if pkg is pt:
            want = _jax_rows_of(scene, sid, _sparks(jx))
            assert items[0].instances[:, EXACT_COLS].tobytes() == want[:, EXACT_COLS].tobytes()
            _close32(items[0].instances, want)
        scene.disable_async_render()


def test_async_render_one_frame_stale_contract():
    """frame_id never exceeds the steps taken, frame ids strictly increase
    (each frame delivered once), and a waiting consumer reaches the last
    frame, in the loop or in the drain after it (a frame delivered in the
    loop is not delivered again, so the drain may find nothing newer); in
    both Scenes."""
    for scene in _scenes():
        scene.enable_async_render()
        scene.add_spawner(_sparks(jx if isinstance(scene, jx.Scene) else pt), capacity=2048)
        seen = []
        for f in range(1, 31):
            scene.step(1 / 60)
            for it in scene.render_async():
                assert 1 <= it.frame_id <= f
                seen.append(it.frame_id)
        drained = [] if seen and seen[-1] == 30 else [it.frame_id for it in _drain_until(scene, 30)]
        assert all(1 <= fid <= 30 for fid in drained)
        ids = seen + drained
        assert ids == sorted(set(ids))
        assert ids and ids[-1] == 30
        scene.disable_async_render()


def test_async_render_multi_type_and_removal():
    """Multi-type spawners go through the per-type dense pack; removing a
    spawner closes its reader and leaves the others; counts equal the JAX
    Scene's."""
    counts = []
    for pkg, scene in zip((jx, pt), _scenes()):
        scene.enable_async_render()
        multi = scene.add_spawner(pkg.ParticleSpawner(
            particle_settings=[pkg.ParticleSettings(lifetime=pkg.RandF32.constant(0.75)),
                               pkg.ParticleSettings(lifetime=pkg.RandF32.constant(0.75))],
            emission_settings=[
                pkg.EmissionSettings(particle_index=0, emission_pacing=pkg.EmissionPacing.rate(500.0)),
                pkg.EmissionSettings(particle_index=1, emission_pacing=pkg.EmissionPacing.rate(500.0))]),
            capacity=2048)
        single = scene.add_spawner(_sparks(pkg), capacity=2048)
        for _ in range(60):
            scene.step(1 / 60)
        items = _drain_until(scene, 60)
        assert {(it.spawner_id, it.type_index) for it in items} == {(multi, 0), (multi, 1), (single, 0)}
        counts.append({(it.spawner_id, it.type_index): it.count for it in items})
        scene.remove_spawner(multi)
        scene.step(1 / 60)
        items = _drain_until(scene, 61)
        assert {(it.spawner_id, it.type_index) for it in items} == {(single, 0)}
        scene.disable_async_render()
    assert counts[0] == counts[1]
    assert abs(counts[1][(0, 0)] - 375) <= 1 and abs(counts[1][(1, 0)] - 750) <= 1


def test_async_render_layers_filter():
    """render_async(view_layers=...) filters as render_items does."""
    for pkg, scene in zip((jx, pt), _scenes()):
        scene.enable_async_render()
        a = scene.add_spawner(_sparks(pkg), capacity=2048)
        b = scene.add_spawner(_sparks(pkg), capacity=2048, layers=0b10)
        for _ in range(30):
            scene.step(1 / 60)
        for layers, want in ((0b01, {a}), (0b10, {b})):
            deadline, got = time.time() + 10, set()
            while time.time() < deadline and got != want:
                got = {it.spawner_id for it in scene.render_async(view_layers=layers)}
                time.sleep(0.01)
            assert got == want
        scene.disable_async_render()


def test_async_render_in_archetype_groups():
    """Members of an archetype group hand the reader their row of the
    group's render pack: each member's async frame == its synchronous
    items, three members, 20 steps."""
    scene = pt.Scene(device="cpu")
    scene.enable_async_render()
    sids = [scene.add_spawner(_sparks(pt), capacity=2048, transform=pt.Transform(translation=(float(i), 0.0, 0.0)))
            for i in range(3)]
    for _ in range(20):
        scene.step(1 / 60)
    assert len(scene._batches) == 1
    items = {it.spawner_id: it for it in _drain_until(scene, 20)}
    sync = {it.spawner_id: it for it in scene.render_items()}
    assert sorted(items) == sorted(sync) == sids
    for sid in sids:
        assert items[sid].frame_id == 20
        np.testing.assert_array_equal(items[sid].instances, sync[sid].instances)
    scene.disable_async_render()


def test_render_items_dense_default_matches_compact():
    """The dense extract (the render pack, compacted by the ring library)
    returns the compact extract's rows, order and uniforms, in both Scenes;
    the port's == the JAX package's pack_instances of the port's pool
    within the FMA seam."""
    for pkg, scene in zip((jx, pt), _scenes()):
        sid = scene.add_spawner(_rate_spawner(pkg, 500.0, 2.0), capacity=2048)
        for _ in range(30):
            scene.step(1 / 60)
        dense = scene.render_items()
        scene.step(1 / 60)  # the render pack runs from the step after the first render_items
        dense = scene.render_items()
        compact = scene.render_items(method="compact")
        assert len(dense) == len(compact) == 1
        assert dense[0].count == compact[0].count > 0
        np.testing.assert_array_equal(dense[0].instances, compact[0].instances)
        assert dense[0].uniform == compact[0].uniform and dense[0].spawner_id == compact[0].spawner_id == sid
    want = _jax_rows_of(scene, sid, _rate_spawner(jx, 500.0, 2.0))
    assert compact[0].instances[:, EXACT_COLS].tobytes() == want[:, EXACT_COLS].tobytes()
    _close32(compact[0].instances, want)


@pytest.mark.parametrize("record", [True, "f16"])
def test_render_loop_draws_the_plain_pack_on_the_cpu(record):
    """examples/render_loop.py's loop (tests/torch_render_configs.py, the
    loop chip_smoke.py runs on the card) on the CPU: every drawn frame's
    rows == the plain pack of its post-step state, frame ids strictly
    increasing, the last frame published."""
    import torch_render_configs as render_cfg
    from bevy_firework_tpu_torch.models import effects

    sp, _tf = effects.stress_test()
    es = dataclasses.replace(sp.emission_settings[0], emission_pacing=pt.EmissionPacing.rate(30_000.0))
    c = pt.compile_spawner(dataclasses.replace(sp, emission_settings=(es,)), device="cpu")
    res = render_cfg.render_loop(c, pt.make_frame_input(1 / 60), 4096, 40, record, check=True)
    assert res["checked"] == len(res["drawn"]) > 0 and res["drawn"] == sorted(set(res["drawn"]))
    assert res["published"] > 0 and res["copy_ms"] == []
