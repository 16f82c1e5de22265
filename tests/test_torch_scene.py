"""The port's Scene facade against the JAX package's Scene, on the CPU.

Both scenes step the same spawners; the port's runs its plain versions here
(`Scene(device="cpu")`; on a card the kernel, checked by chip_smoke.py's
`scene_flows`). Random draws come from different generators in the two
packages (threefry per emitter there, Philox per lane here), so random
configs are held to counts (which only the cadence decides) and
deterministic ones lane for lane: positions, AABBs and instance rows within
1e-4 (XLA on the CPU contracts multiply-adds into FMAs, the port rounds
every operation; over a few hundred frames of gravity and drag that stays
below 1e-4), counts, events and row layouts exact.

One seam of the reference is allowed for, and no more: XLA on the CPU also
contracts the rate cadence's carry, so at a few frames in a hundred its
count is one particle off the f32 cadence (which the port follows bit for
bit: the numpy oracle `np_compute_emission_count`), and that particle is
born a frame apart (ROADMAP queue 3). Rate-driven counts are therefore held
exactly to the oracle and within one particle of the JAX Scene, and rows
and records of lanes whose ages differ between the scenes (at most 1%) are
left out of the lane-for-lane comparison."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from bevy_firework_tpu.cadence import np_compute_emission_count
from bevy_firework_tpu.utils.f32 import np_rem_euclid
from bevy_firework_tpu.models import effects as jeffects
from bevy_firework_tpu.models import library as jlibrary
from bevy_firework_tpu_torch.models import effects as peffects
from bevy_firework_tpu_torch.models import library as plibrary
from test_torch_common import _one_torch_thread, det_spawner  # noqa: F401

DT = 1 / 60
ATOL = 1e-4


def _sparks(pkg):
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(lifetime=pkg.RandF32.constant(0.75))],
        emission_settings=[pkg.EmissionSettings(emission_pacing=pkg.EmissionPacing.rate(1000.0))],
    )


def _scenes(**kw):
    """(JAX Scene, port Scene on the CPU) built from the same arguments:
    kw values are functions of the package."""
    args = {k: v(jx) for k, v in kw.items()}
    pargs = {k: v(pt) for k, v in kw.items()}
    return jx.Scene(**args), pt.Scene(device="cpu", **pargs)


def _oracle_counts(rate: float, dt: float, n_frames: int) -> list:
    """Per-frame spawn counts of a rate emitter by the numpy f32 cadence
    oracle."""
    tic, last, out = np.float32(0.0), np.float32(0.0), []
    for _ in range(n_frames):
        tic = np_rem_euclid(np.float32(tic + np.float32(dt)), np.float32(1.0))
        n, last = np_compute_emission_count(tic, last, np.float32(1.0), 0.0, 1.0, np.float32(rate))
        out.append(int(n))
    return out


def _within_the_cadence_seam(port: list, ref: list):
    """Per-frame counts of the port and the JAX Scene: within one particle
    on every frame and equal on at least 90% of them (the seam above)."""
    diff = np.abs(np.asarray(port) - np.asarray(ref))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.9, diff


def _same_age_lanes(js, ps, sid, t):
    """Of the live lanes of type t (in lane order, the order of the dense
    rows), those whose age is the same in both scenes."""
    sj, sp = js._spawners[sid].state, ps._spawners[sid].state
    mj = np.asarray(sj.alive) & (np.asarray(sj.ptype) == t)
    mp = (sp.alive & (sp.ptype == t)).numpy()
    assert (mj == mp).all()
    same = np.asarray(sj.age)[mj] == sp.age.numpy()[mp]
    assert same.mean() >= 0.99
    return same


def _rows_match(jitems, pitems, js=None, ps=None, sorted_rows=False):
    """Items equal in (spawner, type, count), layout, uniform and layers;
    rows within ATOL lane for lane (given the scenes: on the lanes whose
    ages agree; with sorted_rows, as multisets)."""
    assert [(i.spawner_id, i.type_index, i.count) for i in pitems] == \
        [(i.spawner_id, i.type_index, i.count) for i in jitems]
    for a, b in zip(jitems, pitems):
        assert b.instances.dtype == np.float32 and b.instances.shape == (b.count, 16)
        assert len(pt.instances_to_bytes(b.instances)) == b.count * 64
        assert b.uniform.to_bytes() == a.uniform.to_bytes() and b.layers == a.layers
        if sorted_rows:
            continue
        keep = slice(None) if js is None else _same_age_lanes(js, ps, b.spawner_id, b.type_index)
        np.testing.assert_allclose(b.instances[keep], a.instances[keep], atol=ATOL, rtol=0)


def test_sparks_flow_scene():
    """The verify skill's flow through both Scenes: 750 live after 120
    frames, one 64-byte row per live particle, rows equal; the next frame's
    rows come from the port's render pack (render demand on) and still
    equal the reference's."""
    js, ps = _scenes()
    js.add_spawner(_sparks(jx), capacity=2048)
    sid = ps.add_spawner(_sparks(pt), capacity=2048)
    for _ in range(120):
        js.step(DT)
        ps.step(DT)
    assert ps.alive_count() == js.alive_count() == 750
    _rows_match(js.render_items(), ps.render_items(), js, ps)
    assert ps._spawners[sid].render_planes is None  # this call turned the pack on
    js.step(DT)
    ps.step(DT)
    assert ps._spawners[sid].render_planes is not None
    _rows_match(js.render_items(), ps.render_items(), js, ps)
    assert ps.spawner_ids() == [0]


def test_combined_signature_limit_is_accepted():
    """Scene(combined_signature_limit=4) constructs in both packages (the
    JAX Scene's keyword; the port ignores it) and the port's steps as
    Scene() does, bit for bit, with the reference's live count."""
    js, ps = _scenes(combined_signature_limit=lambda pkg: 4)
    plain = pt.Scene(device="cpu")
    for scene, pkg in ((js, jx), (ps, pt), (plain, pt)):
        scene.add_spawner(_sparks(pkg), capacity=2048)
    for _ in range(60):
        for scene in (js, ps, plain):
            scene.step(DT)
    assert ps.alive_count() == plain.alive_count() == js.alive_count() == 750
    a, b = ps._spawners[0].state, plain._spawners[0].state
    for k, v in pt.interop.pool_to_numpy(a).items():
        np.testing.assert_array_equal(v, pt.interop.pool_to_numpy(b)[k], err_msg=k)


def test_one_shot_on_finished_fires_on_the_same_frame():
    """effects.one_shot: a 20-particle burst; on_finished fires once, on the
    frame the last particle dies, in both scenes."""
    js, ps = _scenes()
    fired = {"jax": [], "port": []}
    for name, scene, fx in (("jax", js, jeffects), ("port", ps, peffects)):
        sid = scene.add_spawner(fx.one_shot()[0], capacity=64)
        scene.on_finished(sid, lambda s, name=name: fired[name].append((s, frame)))
    for frame in range(200):
        js.step(DT)
        ps.step(DT)
        assert ps.alive_count() == js.alive_count()
    assert fired["port"] == fired["jax"] and len(fired["port"]) == 1 and fired["port"][0][1] > 140


def test_on_demand_queue_particles():
    """effects.on_demand: nothing emits until queue_particles; each queued
    burst spawns on the next step; counts equal every frame."""
    js, ps = _scenes()
    jid = js.add_spawner(jeffects.on_demand()[0], capacity=256)
    pid = ps.add_spawner(peffects.on_demand()[0], capacity=256)
    counts = []
    for frame in range(90):
        if frame in (5, 20, 21, 60):
            js.queue_particles(jid, 7)
            ps.queue_particles(pid, 7)
        js.step(DT)
        ps.step(DT)
        assert ps.alive_count(pid) == js.alive_count(jid)
        counts.append(ps.alive_count(pid))
    assert counts[4] == 0 and counts[5] == 7 and max(counts) == 21


# ----------------------------------------------------- dynamic colliders
# tests/test_dynamic_colliders.py through the port's Scene (the retrace
# checks become checks of the collider table's layout, which is what kept
# the JAX step from recompiling)


def _dripper():
    return pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(
            lifetime=pt.RandF32.constant(0.4), acceleration=(0.0, 0.0, 0.0), linear_drag=0.0,
            collision_settings=pt.ParticleCollisionSettings(restitution=0.8, friction=0.0))],
        emission_settings=[pt.EmissionSettings(emission_pacing=pt.EmissionPacing.rate(600.0),
                                               initial_velocity=pt.RandVec3.constant((0.0, -5.0, 0.0)))],
    )


def _min_live_y(scene):
    st = next(iter(scene._spawners.values())).state
    assert bool(st.alive.any())
    return float(st.py[st.alive].min())


def _steps(scene, n):
    for _ in range(n):
        scene.step(DT)


def test_remove_and_readd_reuses_the_slot():
    scene = pt.Scene(colliders=[pt.Collider.halfspace(position=(0, 0, 0))], device="cpu")
    scene.add_spawner(_dripper(), capacity=512, transform=pt.Transform(translation=(0, 1, 0)))
    _steps(scene, 60)
    assert _min_live_y(scene) >= -1e-3  # the floor holds
    kinds_before = scene._colliders.kinds
    (cid,) = list(scene._collider_ids.keys())
    scene.remove_collider(cid)
    _steps(scene, 30)
    assert _min_live_y(scene) < -0.5  # falls through where the floor was
    cid2 = scene.add_collider(pt.Collider.halfspace(position=(0, 0, 0)))
    _steps(scene, 60)
    assert _min_live_y(scene) >= -1e-3
    assert scene._colliders.kinds == kinds_before and cid2 != cid


def test_move_collider():
    scene = pt.Scene(colliders=[pt.Collider.halfspace(position=(0, 0, 0))], device="cpu")
    scene.add_spawner(_dripper(), capacity=512, transform=pt.Transform(translation=(0, 1, 0)))
    scene.step(DT)
    (cid,) = list(scene._collider_ids.keys())
    scene.set_collider(cid, position=(0, -2.0, 0))
    _steps(scene, 60)
    assert -2.0 - 1e-3 <= _min_live_y(scene) < -0.5  # rests on the lowered floor
    assert scene._colliders.kinds == (pt.colliders.COLLIDER_HALFSPACE,)


def test_new_kind_appends_slot():
    scene = pt.Scene(colliders=[pt.Collider.halfspace(position=(0, 0, 0))], device="cpu")
    scene.add_collider(pt.Collider.sphere(1.0, position=(5, 0, 0)))
    assert len(scene._colliders.kinds) == 2
    cids = list(scene._collider_ids.keys())
    scene.remove_collider(cids[1])
    scene.add_collider(pt.Collider.sphere(2.0, position=(-5, 0, 0)))
    assert len(scene._colliders.kinds) == 2
    np.testing.assert_array_equal(scene._colliders.params[1].numpy(), [2.0, 0.0, 0.0])


def test_rotated_readd_does_not_reuse_identity_slot():
    scene = pt.Scene(device="cpu")
    cid = scene.add_collider(pt.Collider.cuboid((1, 1, 1)))
    scene.remove_collider(cid)
    scene.add_collider(pt.Collider.cuboid((1, 1, 1), rotation=(0.0, 0.0, 0.3826834, 0.9238795)))
    assert len(scene._colliders.kinds) == 2 and scene._colliders.identity_rot == (True, False)


def test_identity_readd_can_reuse_rotated_slot():
    scene = pt.Scene(device="cpu")
    cid = scene.add_collider(pt.Collider.cuboid((1, 1, 1), rotation=(0.0, 0.0, 0.3826834, 0.9238795)))
    scene.remove_collider(cid)
    scene.add_collider(pt.Collider.cuboid((2, 2, 2)))
    assert len(scene._colliders.kinds) == 1 and scene._colliders.identity_rot == (False,)


def test_set_collider_rotation_flips_identity_slot():
    scene = pt.Scene(device="cpu")
    cid = scene.add_collider(pt.Collider.cuboid((1, 1, 1)))
    assert scene._colliders.identity_rot == (True,)
    scene.set_collider(cid, rotation=(0.0, 0.0, 0.3826834, 0.9238795))
    assert scene._colliders.identity_rot == (False,)


def test_inactive_collider_ignores_layers():
    scene = pt.Scene(colliders=[pt.Collider.halfspace(position=(0, 0, 0), layers=0xFFFFFFFF)], device="cpu")
    scene.add_spawner(_dripper(), capacity=512, transform=pt.Transform(translation=(0, 1, 0)))
    (cid,) = list(scene._collider_ids.keys())
    scene.remove_collider(cid)
    _steps(scene, 30)
    assert _min_live_y(scene) < -0.5


def test_collider_tables_match_jax_scene():
    """After the same adds, removes and edits, the port's table equals the
    JAX Scene's row for row (layout and values)."""
    js, ps = _scenes(colliders=lambda pkg: [pkg.Collider.halfspace(position=(0, -1, 0)),
                                            pkg.Collider.sphere(0.5, position=(1, 0, 0))])
    for scene, pkg in ((js, jx), (ps, pt)):
        cid = scene.add_collider(pkg.Collider.hull_from_points([(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)]))
        scene.remove_collider(1)
        scene.add_collider(pkg.Collider.sphere(0.25, position=(0, 2, 0)))
        scene.set_collider(cid, position=(3, 0, 0), rotation=(0.0, 0.3826834, 0.0, 0.9238795))
    jt, ptab = js._colliders, ps._colliders
    assert (ptab.kinds, ptab.identity_rot, ptab.hull_counts) == (jt.kinds, jt.identity_rot, jt.hull_counts)
    for k in ("position", "rotation", "params", "active", "hull_planes"):
        np.testing.assert_array_equal(getattr(ptab, k).numpy(), np.asarray(getattr(jt, k)), err_msg=k)
    np.testing.assert_array_equal(ptab.layers.numpy(), np.asarray(jt.layers).astype(np.int64))


# ---------------------------------------------------------- events, AABBs

FLIP = (1.0, 0.0, 0.0, 0.0)  # half turn about X: a halfspace solid above its plane


def test_destroyed_records_match_jax_scene():
    """A deterministic destroy scene (the constant-draw spawner under a
    ceiling it dies on, with a particles_destroyed handler): every frame
    both scenes hand the handler the same number of records, with
    positions, velocities, ages and scales within 1e-4 and equal colours."""
    got = {"jax": [], "port": []}

    def spawner(pkg, name):
        return det_spawner(pkg, ps=dict(
            collision_settings=pkg.ParticleCollisionSettings(destroy_on_collision=True),
            event_handlers=pkg.ParticleEventHandlers(particles_destroyed=lambda rs: got[name].append(rs))))

    js, ps = _scenes(colliders=lambda pkg: [pkg.Collider.halfspace(position=(0.0, 0.4, 0.0), rotation=FLIP)])
    js.add_spawner(spawner(jx, "jax"), capacity=1024)
    ps.add_spawner(spawner(pt, "port"), capacity=1024)
    for _ in range(40):
        js.step(1 / 50)
        ps.step(1 / 50)
        assert len(got["port"]) == len(got["jax"])
    assert sum(len(r) for r in got["port"]) > 200
    for a, b in zip(got["jax"], got["port"]):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            for k in ("position", "velocity", "rotation", "angular_velocity"):
                np.testing.assert_allclose(getattr(y, k), getattr(x, k), atol=ATOL, rtol=0, err_msg=k)
            for k in ("initial_scale", "scale", "age", "lifetime"):
                assert abs(getattr(y, k) - getattr(x, k)) <= ATOL, k
            assert y.base_color == pytest.approx(x.base_color, abs=ATOL) and y.pbr == x.pbr
            assert y.emissive_color == pytest.approx(x.emissive_color, abs=ATOL)


def test_ring_archetype_handler_sees_deaths_by_age():
    """A ring archetype with a handler (sparks, deaths by age only): each
    frame the port's handler gets one record per particle the oracle's
    cadence spawned 45 frames (0.75 s) earlier, each at age 0.75, and as
    many as the JAX Scene's within its cadence seam."""
    got = {"jax": [], "port": []}

    def spawner(pkg, name):
        sp = _sparks(pkg)
        ps = dataclasses.replace(sp.particle_settings[0], event_handlers=pkg.ParticleEventHandlers(
            particles_destroyed=lambda rs: got[name].append([r.age for r in rs])))
        return dataclasses.replace(sp, particle_settings=(ps,))

    js, ps = _scenes()
    js.add_spawner(spawner(jx, "jax"), capacity=2048)
    ps.add_spawner(spawner(pt, "port"), capacity=2048)
    for _ in range(100):
        js.step(DT)
        ps.step(DT)
    born = _oracle_counts(1000.0, DT, 100)
    assert [len(r) for r in got["port"]] == born[:len(got["port"])]  # the first deaths: frame 45
    _within_the_cadence_seam([len(r) for r in got["port"]], [len(r) for r in got["jax"]])
    assert all(0.75 <= a < 0.75 + DT for r in got["port"] for a in r) and sum(map(len, got["port"])) > 800


def test_aabb_world_and_local_match_jax_scene():
    """The deterministic spawner under a rotated, translated transform: the
    step's AABB (the kernel stats on the card) in world space and in the
    spawner's local frame equal the JAX Scene's within 1e-4."""
    tf = dict(translation=(1.0, 2.0, -0.5), rotation=(0.0, math.sin(0.3), 0.0, math.cos(0.3)))
    js, ps = _scenes()
    jid = js.add_spawner(det_spawner(jx), capacity=1024, transform=jx.Transform(**tf))
    pid = ps.add_spawner(det_spawner(pt), capacity=1024, transform=pt.Transform(**tf))
    assert ps.aabb(pid) is None
    for _ in range(20):
        js.step(1 / 50)
        ps.step(1 / 50)
    for space in ("world", "local"):
        (jmn, jmx), (pmn, pmx) = js.aabb(jid, space=space), ps.aabb(pid, space=space)
        np.testing.assert_allclose(pmn, jmn, atol=ATOL, rtol=0)
        np.testing.assert_allclose(pmx, jmx, atol=ATOL, rtol=0)
    assert not np.allclose(ps.aabb(pid, "world")[0], ps.aabb(pid, "local")[0])


def test_render_items_multi_type_layers_sort_and_cull():
    """Two spawners (one of two types, one single-type) under both Scenes:
    per (spawner x type) items with equal counts and 64-byte rows; the
    layer filter, the back-to-front sort and the frustum cull choose the
    same items in the same order. The two emitters share one ring, so their
    rates are ones at which the reference's cadence has no seam at 1/60
    (250 and 400 per second): every lane then agrees."""
    def two_types(pkg):
        types = [pkg.ParticleSettings(lifetime=pkg.RandF32.constant(1.0 + t), initial_scale=pkg.RandF32.constant(0.2),
                                      blend_mode=pkg.BlendMode.BLEND if t else pkg.BlendMode.ADD) for t in range(2)]
        return pkg.ParticleSpawner(particle_settings=types, emission_settings=[
            pkg.EmissionSettings(particle_index=t, emission_pacing=pkg.EmissionPacing.rate((250.0, 400.0)[t]),
                                 initial_velocity=pkg.RandVec3.constant((0.5 * t, 2.0, 0.1))) for t in range(2)])

    js, ps = _scenes()
    for scene, pkg in ((js, jx), (ps, pt)):
        scene.add_spawner(two_types(pkg), capacity=4096, transform=pkg.Transform(translation=(0.0, 0.0, -5.0)))
        scene.add_spawner(_sparks(pkg), capacity=2048, transform=pkg.Transform(translation=(0.0, 0.0, 5.0)),
                          layers=2)
    for _ in range(50):
        js.step(DT)
        ps.step(DT)
    _rows_match(js.render_items(), ps.render_items(), js, ps)
    for _ in range(3):
        js.step(DT)
        ps.step(DT)
    cam = (0.3, 1.0, -12.0)
    pitems = ps.render_items(camera_pos=cam)
    _rows_match(js.render_items(camera_pos=cam), pitems, sorted_rows=True)
    plain_items = {(i.spawner_id, i.type_index): i for i in ps.render_items()}
    assert [i.spawner_id for i in pitems] == [1, 0, 0]  # farthest spawner first
    for item in pitems:
        plain = plain_items[(item.spawner_id, item.type_index)]
        sort = item.uniform.alpha_mode in pt.render.ORDER_DEPENDENT_ALPHA_MODES
        want = pt.sort_instances_back_to_front(plain.instances, cam) if sort else plain.instances
        np.testing.assert_array_equal(item.instances, want)
    _rows_match(js.render_items(view_layers=2), ps.render_items(view_layers=2), js, ps)
    # a camera at z = 10 looking down -z (60 degrees, depth 0..1, far plane
    # at 12) sees the spawner at z = 5 and not the one at z = -5
    near, far, fy = 1.0, 12.0, 1.0 / math.tan(math.radians(30.0))
    proj = np.array([[fy, 0, 0, 0], [0, fy, 0, 0], [0, 0, far / (near - far), near * far / (near - far)],
                     [0, 0, -1.0, 0]], np.float32)
    view = np.eye(4, dtype=np.float32)
    view[2, 3] = -10.0
    view_proj = proj @ view
    jcull, pcull = js.render_items(view_proj=view_proj), ps.render_items(view_proj=view_proj)
    _rows_match(jcull, pcull, js, ps)
    assert [i.spawner_id for i in pcull] == [1]
    np.testing.assert_array_equal(pt.frustum_planes(view_proj), jx.frustum_planes(view_proj))


def test_tornado_example_matches_jax_scene():
    """examples/force_fields.py: library.dust under a vortex, an axial field
    and turbulence, the funnel wandering by set_force_field every frame, 120
    frames. No dust mote reaches its 2.8 s minimum lifetime, so the live
    count is the cadence's: the oracle's exactly in the port, the JAX
    Scene's within its cadence seam (and equal at the end); every mote
    finite, and the motes swirl about the funnel in the reference's
    sense."""
    def fields(pkg):
        return [pkg.ForceField.vortex((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), strength=12.0, radius=6.0),
                pkg.ForceField.axial((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), strength=25.0, radius=7.0),
                pkg.ForceField.turbulence((0.0, 2.0, 0.0), strength=1.8, radius=8.0, frequency=2.2)]

    js, ps = _scenes(force_fields=fields)
    js.add_spawner(jlibrary.dust(updraft=2.5, drag=2.0, emit_radius=1.2), capacity=8192)
    sid = ps.add_spawner(plibrary.dust(updraft=2.5, drag=2.0, emit_radius=1.2), capacity=8192)
    counts = {"jax": [], "port": []}
    for f in range(120):
        x, z = 0.8 * math.sin(f * 0.02), 0.8 * math.cos(f * 0.017)
        for scene in (js, ps):
            scene.set_force_field(0, position=(x, 0.0, z))
            scene.set_force_field(1, position=(x, 0.0, z))
            scene.step(DT)
        counts["jax"].append(js.alive_count())
        counts["port"].append(ps.alive_count())
    assert counts["port"] == list(np.cumsum(_oracle_counts(900.0, DT, 120)))
    _within_the_cadence_seam(counts["port"], counts["jax"])
    assert ps.alive_count() == js.alive_count() == counts["port"][-1] > 1700
    st = ps._spawners[sid].state
    a = st.alive
    assert bool(torch.isfinite(torch.stack([st.px, st.py, st.pz, st.vx, st.vy, st.vz])[:, a]).all())
    ly = ((st.pz - z) * st.vx - (st.px - x) * st.vz)[a]
    assert float((ly > 0).float().mean()) > 0.9


def test_step_n_and_spawner_edits():
    """step_n runs n frames per spawner (counts equal the JAX Scene's),
    set_spawner resets the pool, set_enabled stops emission, and
    remove_spawner drops the spawner."""
    js, ps = _scenes()
    jid = js.add_spawner(_sparks(jx), capacity=2048)
    pid = ps.add_spawner(_sparks(pt), capacity=2048)
    js.step_n(DT, 50)
    ps.step_n(DT, 50)
    assert ps.alive_count(pid) == sum(_oracle_counts(1000.0, DT, 50)[5:]) and ps.time == pytest.approx(50 * DT)
    assert abs(ps.alive_count(pid) - js.alive_count(jid)) <= 1
    ps.set_enabled(pid, False)
    js.set_enabled(jid, False)
    js.step_n(DT, 10)
    ps.step_n(DT, 10)
    assert ps.alive_count(pid) == sum(_oracle_counts(1000.0, DT, 50)[15:])
    assert abs(ps.alive_count(pid) - js.alive_count(jid)) <= 1
    ps.set_spawner(pid, _sparks(pt))
    assert ps.alive_count(pid) == 0
    ps.remove_spawner(pid)
    assert ps.spawner_ids() == [] and ps.alive_count() == 0


def test_compact_extract_async_render_and_no_card():
    """The compact extract and the async render run on the CPU Scene; a
    Scene or a compile for the card without one raises."""
    scene = pt.Scene(device="cpu")
    scene.add_spawner(_sparks(pt), capacity=2048)
    scene.enable_async_render()
    for _ in range(3):
        scene.step(1 / 60)
    compact = scene.render_items(method="compact")
    assert compact[0].count == scene.alive_count() > 0
    assert all(1 <= it.frame_id <= 3 for it in scene.render_async())
    scene.disable_async_render()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.Scene()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.compile_spawner(_sparks(pt))


def test_estimate_capacity_and_library_match_jax():
    """estimate_capacity sizes every library effect as the JAX package does,
    and each effect lowers to equal tables."""
    from test_torch_common import PARAM_FIELDS

    for name in ("fountain", "rain", "snow", "explosion", "magic_trail", "smoke_plume", "comets", "dust"):
        spj, spp = getattr(jlibrary, name)(), getattr(plibrary, name)()
        assert pt.estimate_capacity(spp) == jx.estimate_capacity(spj), name
        cj, cp = jx.compile_spawner(spj), pt.compile_spawner(spp, device="cpu")
        assert cp.static.__dict__ == cj.static.__dict__, name
        for k in PARAM_FIELDS:
            want = np.asarray(getattr(cj.params, k))
            np.testing.assert_array_equal(getattr(cp.params, k).numpy(), want.astype(getattr(cp.params, k).numpy().dtype),
                                          err_msg=f"{name}.{k}")


def test_step_n_packs_the_last_frame_once_rendering():
    """Once something renders, step_n runs multi_step_auto_packed: the
    render-pack planes of its last frame give the same rows as the dense
    pack of the final state, and the chain equals as many plain frames."""
    from bevy_firework_tpu_torch.ops import fused_step as pfs
    from bevy_firework_tpu_torch.step import plain_frames

    ps = pt.Scene(device="cpu")
    sid = ps.add_spawner(det_spawner(pt), capacity=1024)
    ps.render_items()  # render demand on
    ps.step_n(1 / 50, 12)
    slot = ps._spawners[sid]
    assert slot.render_planes is not None
    dense = pt.render.compact_dense(pt.pack_instances_dense(slot.compiled.params, slot.state, 0)[0].numpy())
    np.testing.assert_array_equal(ps.render_items()[0].instances, dense)
    c = slot.compiled
    s0 = pt.init_pool_for(c, 1024, seed=sid)
    f = pt.make_frame_input(1 / 50)
    st, out, planes = pfs.multi_step_auto_packed(c.static, c.params, None, s0, f, 12)
    ref, _o = plain_frames(c.static, c.params, s0, f, 12)
    for k in ("px", "vy", "age", "alive", "ring_cursor"):
        assert torch.equal(getattr(st, k), getattr(ref, k)) and torch.equal(getattr(slot.state, k), getattr(ref, k)), k
    with pytest.raises(ValueError, match="n_frames"):
        pfs.multi_step_auto_packed(c.static, c.params, None, s0, f, 0)


# ---------------------------------------------------------- archetype groups


def _sparks_like(pkg, rate, lifetime=0.5):
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(lifetime=pkg.RandF32.constant(lifetime))],
        emission_settings=[pkg.EmissionSettings(
            emission_pacing=pkg.EmissionPacing.rate(rate),
            initial_velocity=pkg.RandVec3(pkg.RandF32(1.0, 2.0), (0, 1, 0), 0.4))])


def _same_pool(a, b, label=""):
    """Two port pools equal leaf for leaf, bit for bit."""
    for k, v in pt.interop.pool_to_numpy(a).items():
        np.testing.assert_array_equal(v, pt.interop.pool_to_numpy(b)[k], err_msg=f"{label} {k}")


def _solo_scene(seed, spawner, **kw):
    s = pt.Scene(seed=seed, device="cpu")
    s.add_spawner(spawner, **kw)
    return s


def test_scene_batches_same_archetype_spawners():
    """12 same-archetype spawners (different transforms, rates, seeds) step
    as ONE group whose members equal isolated scenes bit for bit; a
    different archetype makes a second group: two dispatch groups, as in
    the JAX Scene; render items still come per spawner."""
    rates = [100.0 + 25.0 * i for i in range(12)]
    big = pt.Scene(seed=7, device="cpu")
    sids = [big.add_spawner(_sparks_like(pt, r), capacity=256, transform=pt.Transform(translation=(float(i), 0, 0)))
            for i, r in enumerate(rates)]
    other = big.add_spawner(pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(lifetime=pt.RandF32.constant(1.0))],
        emission_settings=[pt.EmissionSettings(emission_pacing=pt.EmissionPacing.one_shot(5))]), capacity=256)
    solos = [_solo_scene(7 + i, _sparks_like(pt, r), capacity=256,
                         transform=pt.Transform(translation=(float(i), 0, 0))) for i, r in enumerate(rates)]
    jbig = jx.Scene(seed=7)
    for i, r in enumerate(rates):
        jbig.add_spawner(_sparks_like(jx, r), capacity=256, transform=jx.Transform(translation=(float(i), 0, 0)))
    for _ in range(30):
        big.step(DT)
        jbig.step(DT)
        for s in solos:
            s.step(DT)
    assert big._last_step_dispatches == 2 and jbig._last_step_dispatches == 1
    assert len(big._batches) == 1  # the 12 sparks; the one-shot steps alone
    for i, sid in enumerate(sids):
        _same_pool(big._spawners[sid].state, solos[i]._spawners[0].state, f"spawner {i}")
        assert abs(big.alive_count(sid) - jbig.alive_count(sid)) <= 1
    assert big.alive_count(other) == 5
    assert len(big.render_items()) == 13


def test_group_churn_restacks_on_the_device():
    """Membership churn in a batched group: adds, removes (one per frame)
    and a set_spawner reset mid-group; after every frame each member equals
    an isolated scene driven through the same edits, bit for bit. The kept
    members' rows are gathered from the last batch (take_insert), not
    restacked from their pools."""
    from bevy_firework_tpu_torch import scene as scenemod

    taken = []
    real = scenemod.take_insert
    scenemod.take_insert = lambda *a: taken.append(len(a[2])) or real(*a)
    try:
        scene = pt.Scene(seed=3, device="cpu")
        solos = {}

        def add(rate, translation):
            sid = scene.add_spawner(_sparks_like(pt, rate), capacity=256, transform=pt.Transform(translation=translation))
            solos[sid] = _solo_scene(3 + sid, _sparks_like(pt, rate), capacity=256,
                                     transform=pt.Transform(translation=translation))
            return sid

        def step():
            scene.step(DT)
            for s in solos.values():
                s.step(DT)
            assert scene._last_step_dispatches == 1
            for sid, s in solos.items():
                _same_pool(scene._spawners[sid].state, s._spawners[0].state, f"sid {sid}")

        sids = [add(100.0 + 20.0 * i, (float(i), 0.0, 0.0)) for i in range(6)]
        for _ in range(5):
            step()
        for k in range(4):
            gone = sids.pop(k % len(sids))
            scene.remove_spawner(gone)
            del solos[gone]
            sids.append(add(300.0 + 10.0 * k, (0.0, float(k), 0.0)))
            step()
        scene.set_spawner(sids[0], _sparks_like(pt, 777.0))
        solos[sids[0]].set_spawner(0, _sparks_like(pt, 777.0))
        for _ in range(4):
            step()
    finally:
        scenemod.take_insert = real
    assert taken == [1, 1, 1, 1, 1]  # each churn frame and the reset insert one new member's rows


def test_scene_batched_events_fire_per_spawner():
    """on_finished per member of a group (one [S] flag read per group)."""
    fired = []
    scene = pt.Scene(device="cpu")
    for i in range(3):
        sid = scene.add_spawner(pt.ParticleSpawner(
            particle_settings=[pt.ParticleSettings(lifetime=pt.RandF32.constant(0.05 * (i + 1)))],
            emission_settings=[pt.EmissionSettings(emission_pacing=pt.EmissionPacing.one_shot(3))]), capacity=64)
        scene.on_finished(sid, fired.append)
    for _ in range(30):
        scene.step(DT)
    assert sorted(fired) == [0, 1, 2]


def test_scene_step_n_batched_matches_step_loop():
    """Grouped step_n (one multi_step_fleet_stacked chain) == the same scene
    stepped frame by frame, bit for bit; one dispatch group."""
    a, b = pt.Scene(seed=3, device="cpu"), pt.Scene(seed=3, device="cpu")
    for i in range(4):
        for s in (a, b):
            s.add_spawner(_sparks_like(pt, 200.0 + 40 * i, 0.4), capacity=128,
                          transform=pt.Transform(translation=(float(i), 0.0, 0.0)))
    for _ in range(25):
        a.step(DT)
    b.step_n(DT, 25)
    assert a._last_step_dispatches == b._last_step_dispatches == 1
    for sid in a.spawner_ids():
        _same_pool(a._spawners[sid].state, b._spawners[sid].state, f"sid {sid}")


def test_batched_group_mutation_restacks_correctly():
    """queue_particles and set_enabled on one member of a stacked group take
    its row off the batch and the next step re-inserts it: every member
    equals an isolated scene doing the same edits; a member's state read
    from a batch stays as it was after later steps (no aliasing)."""
    def sp():
        return pt.ParticleSpawner(
            particle_settings=[pt.ParticleSettings(lifetime=pt.RandF32.constant(5.0))],
            emission_settings=[pt.EmissionSettings(emission_pacing=pt.EmissionPacing.on_demand())])

    big = pt.Scene(seed=2, device="cpu")
    sids = [big.add_spawner(sp(), capacity=64) for _ in range(3)]
    solos = [_solo_scene(2 + i, sp(), capacity=64) for i in range(3)]

    def step_all():
        big.step(DT)
        for s in solos:
            s.step(DT)

    for _ in range(3):
        step_all()
    before = big._spawners[sids[0]].state
    kept = before.px.clone()
    big.queue_particles(sids[1], 7)
    solos[1].queue_particles(0, 7)
    step_all()
    big.set_enabled(sids[2], False)
    solos[2].set_enabled(0, False)
    big.queue_particles(sids[2], 9)  # queued but disabled: no spawn
    solos[2].queue_particles(0, 9)
    for _ in range(2):
        step_all()
    for i, sid in enumerate(sids):
        _same_pool(big._spawners[sid].state, solos[i]._spawners[0].state, f"slot {i}")
    assert big.alive_count(sids[1]) == 7 and big.alive_count(sids[2]) == 0
    assert int(big._spawners[sids[2]].state.manual_queued) == 9
    assert torch.equal(before.px, kept)


def test_grouped_destroyed_records_per_spawner():
    """A group of three destroy-on-collision spawners with handlers: one
    gather per group, and each handler gets exactly the records its
    isolated scene's handler gets, frame by frame."""
    def spawner(sink):
        return det_spawner(pt, ps=dict(
            collision_settings=pt.ParticleCollisionSettings(destroy_on_collision=True),
            event_handlers=pt.ParticleEventHandlers(particles_destroyed=sink.append)))

    ceiling = [pt.Collider.halfspace(position=(0.0, 0.4, 0.0), rotation=FLIP)]
    got, want = [[] for _ in range(3)], [[] for _ in range(3)]
    big = pt.Scene(colliders=ceiling, device="cpu")
    solos = []
    for i in range(3):
        tf = pt.Transform(translation=(float(i), -0.1 * i, 0.0))
        big.add_spawner(spawner(got[i]), capacity=1024, transform=tf)
        solos.append(pt.Scene(colliders=ceiling, seed=i, device="cpu"))
        solos[-1].add_spawner(spawner(want[i]), capacity=1024, transform=tf)
    # the three spawners differ only in their handlers: one archetype
    assert len({s.compiled.static for s in big._spawners.values()}) == 1
    for _ in range(30):
        big.step(1 / 50)
        for s in solos:
            s.step(1 / 50)
        assert big._last_step_dispatches == 1
    for g, w in zip(got, want):
        assert len(g) == len(w) > 5 and sum(map(len, g)) > 100
        assert [[dataclasses.astuple(r) for r in rs] for rs in g] == [[dataclasses.astuple(r) for r in rs] for rs in w]


def test_grouped_scene_matches_jax_scene():
    """Four deterministic spawners of one archetype (rates 1000-2500/s at
    1/50 s: whole counts per frame, no cadence seam) with their own
    transforms, as one group in both Scenes: every member's bookkeeping
    exact and its live lanes within 1e-4 (dead lanes' fields carry no
    meaning), AABBs and render rows within 1e-4, one dispatch group each."""
    js, ps = _scenes()
    for i in range(4):
        tf = dict(translation=(float(i), 0.5 * i, -1.0), rotation=(0.0, math.sin(0.2 * i), 0.0, math.cos(0.2 * i)))
        js.add_spawner(det_spawner(jx, pacing=jx.EmissionPacing.rate(1000.0 + 500 * i)), capacity=2048,
                       transform=jx.Transform(**tf))
        ps.add_spawner(det_spawner(pt, pacing=pt.EmissionPacing.rate(1000.0 + 500 * i)), capacity=2048,
                       transform=pt.Transform(**tf))
    for _ in range(30):
        js.step(1 / 50)
        ps.step(1 / 50)
    assert js._last_step_dispatches == ps._last_step_dispatches == 1
    from test_torch_common import EXACT, F32_LANE, jax_pool_numpy

    for sid in ps.spawner_ids():
        got, want = pt.interop.pool_to_numpy(ps._spawners[sid].state), jax_pool_numpy(js._spawners[sid].state)
        for k in EXACT + ("time_in_cycle", "last_emission"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        live = want["alive"]
        assert live.sum() >= 300
        for k in F32_LANE:
            np.testing.assert_allclose(got[k][live], want[k][live], atol=ATOL, rtol=0, err_msg=k)
        for a, b in zip(ps.aabb(sid), js.aabb(sid)):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    _rows_match(js.render_items(), ps.render_items())
    js.step(1 / 50)
    ps.step(1 / 50)  # the group's in-kernel render pack
    assert all(ps._spawners[sid].render_planes is not None for sid in ps.spawner_ids())
    _rows_match(js.render_items(), ps.render_items())
