"""The port's checkpoints (`bevy_firework_tpu_torch.checkpoint`) on the CPU:
ports of the JAX package's checkpoint tests, loads across the two packages
(a zip saved by either loads in the other and runs on equal to the other's
run), and resumed runs of random configs held bit for bit to the same run
uninterrupted.

Across the packages the spawners are deterministic (constant draws; the
packages' generators differ), frames are 1/64 s at a rate of 256/s (every
cadence value exact in f32), and lanes are compared within the Scene
tests' ATOL = 1e-4, live lanes only."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from bevy_firework_tpu import checkpoint as jck
from bevy_firework_tpu_torch import checkpoint as pck
from bevy_firework_tpu_torch import interop
from bevy_firework_tpu_torch.trails import TRAIL_FIELDS
from test_torch_common import F32_LANE, _one_torch_thread, jax_pool_numpy  # noqa: F401

ATOL = 1e-4
DT = 1 / 64
FLIP = (1.0, 0.0, 0.0, 0.0)  # half turn about X: a halfspace solid above its plane


def spawner(pkg=pt):
    """The JAX package's checkpoint tests' spawner (random lifetimes and
    speeds)."""
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(lifetime=pkg.RandF32(0.2, 0.6))],
        emission_settings=[pkg.EmissionSettings(
            emission_pacing=pkg.EmissionPacing.rate(400.0),
            initial_velocity=pkg.RandVec3(pkg.RandF32(1.0, 3.0), (0, 1, 0), 0.3))])


def det(pkg, collide=False, rate=256.0, handler=None):
    """A deterministic spawner (constant draws, point shape), optionally
    bouncing off colliders and with a particles_destroyed handler."""
    ps = dict(lifetime=pkg.RandF32.constant(0.5), initial_scale=pkg.RandF32.constant(0.1),
              scale_curve=pkg.FireworkCurve.uneven_samples([(0.0, 1.0), (1.0, 2.0)]))
    if collide:
        ps["collision_settings"] = pkg.ParticleCollisionSettings(restitution=0.5, friction=0.1)
    if handler is not None:
        ps["event_handlers"] = pkg.ParticleEventHandlers(particles_destroyed=handler)
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(**ps)],
        emission_settings=[pkg.EmissionSettings(
            emission_pacing=pkg.EmissionPacing.rate(rate),
            initial_velocity=pkg.RandVec3.constant((1.0, 3.0, 0.2)))])


def port_state(scene, sid) -> dict:
    return interop.pool_to_numpy(scene._spawners[sid].state)


def same_port_scenes(a, b):
    """Two port Scenes equal bit for bit: every pool leaf, every trail leaf,
    time and ids."""
    assert a.spawner_ids() == b.spawner_ids() and a.time == b.time
    for sid in a.spawner_ids():
        sa, sb = port_state(a, sid), port_state(b, sid)
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=f"{sid} {k}")
        ta, tb = a._spawners[sid].trail_state, b._spawners[sid].trail_state
        assert (ta is None) == (tb is None)
        if ta is not None:
            for k in TRAIL_FIELDS:
                assert torch.equal(getattr(ta, k), getattr(tb, k)), f"{sid} trail {k}"


def jax_matches_port(js, ps):
    """A JAX Scene and a port Scene on equal runs: bookkeeping exact, live
    lanes within ATOL, trail counts exact and rows within ATOL."""
    assert sorted(js.spawner_ids()) == ps.spawner_ids()
    for sid in ps.spawner_ids():
        got, want = port_state(ps, sid), jax_pool_numpy(js._spawners[sid].state)
        for k in ("alive", "ring_cursor", "enabled", "manual_queued", "time_in_cycle", "last_emission"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{sid} {k}")
        live = want["alive"]
        assert live.any()
        for k in F32_LANE:
            np.testing.assert_allclose(got[k][live], want[k][live], atol=ATOL, rtol=0, err_msg=f"{sid} {k}")
    ij, ip = js.trail_items(), ps.trail_items()
    assert [(i.spawner_id, i.count) for i in ip] == [(i.spawner_id, i.count) for i in ij]
    for a, b in zip(ij, ip):
        np.testing.assert_allclose(b.segments, a.segments, atol=ATOL, rtol=0)


def test_pool_round_trip(tmp_path):
    """save_pool / load_pool keep every leaf in the JAX package's dtypes,
    and a pool file saved by the JAX package loads equal to its arrays."""
    scene = pt.Scene(device="cpu")
    sid = scene.add_spawner(spawner(), capacity=512)
    for _ in range(20):
        scene.step(1 / 60)
    st = scene._spawners[sid].state
    p = os.path.join(tmp_path, "pool.npz")
    pck.save_pool(p, st)
    with np.load(p) as z:
        assert z["rng_key"].dtype == np.uint32 and z["rng_key"].shape == (2,) and z["alive"].dtype == bool
    st2 = pck.load_pool(p, device="cpu")
    for k, v in interop.pool_to_numpy(st).items():
        np.testing.assert_array_equal(v, interop.pool_to_numpy(st2)[k], err_msg=k)
    js = jx.Scene()
    jsid = js.add_spawner(spawner(jx), capacity=512)
    for _ in range(5):
        js.step(1 / 60)
    jp = os.path.join(tmp_path, "jax_pool.npz")
    jck.save_pool(jp, js._spawners[jsid].state)
    want = jax_pool_numpy(js._spawners[jsid].state)
    for k, v in interop.pool_to_numpy(pck.load_pool(jp, device="cpu")).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_scene_resume_continues_exact_trajectory(tmp_path):
    """A random-draw scene saved at frame 15 and loaded continues bit for
    bit (the PRNG key included)."""
    path = os.path.join(tmp_path, "scene.ckpt")
    a = pt.Scene(device="cpu")
    a.add_spawner(spawner(), capacity=512, transform=pt.Transform(translation=(1, 2, 3)))
    for _ in range(15):
        a.step(1 / 60)
    pck.save_scene(path, a)
    b = pck.load_scene(path, device="cpu")
    assert b.time == a.time
    for _ in range(15):
        a.step(1 / 60)
        b.step(1 / 60)
    same_port_scenes(a, b)


def test_scene_restore_non_contiguous_ids(tmp_path):
    """Removals leave id gaps: the restore keeps the surviving ids, fresh
    ids continue past them and an explicit duplicate is refused."""
    path = os.path.join(tmp_path, "gappy.ckpt")
    a = pt.Scene(device="cpu")
    s0 = a.add_spawner(spawner(), capacity=512)
    s1 = a.add_spawner(spawner(), capacity=512)
    s2 = a.add_spawner(spawner(), capacity=512)
    a.remove_spawner(s1)
    for _ in range(10):
        a.step(1 / 60)
    pck.save_scene(path, a)
    b = pck.load_scene(path, device="cpu")
    assert sorted(b.spawner_ids()) == [s0, s2]
    for sid in (s0, s2):
        np.testing.assert_array_equal(port_state(a, sid)["alive"], port_state(b, sid)["alive"])
        assert b._spawners[sid].seed == a._spawners[sid].seed
    assert b.add_spawner(spawner(), capacity=512) == 3
    with pytest.raises(ValueError, match="already in use"):
        b.add_spawner(spawner(), capacity=512, sid=s0)


def test_legacy_checkpoint_ring_cursor_reconstructed():
    """A checkpoint without ring_cursor resumes with the exact cursor
    rebuilt from the ages, and continues equal to the uninterrupted run
    (stepped through step_jit, the JAX package's name)."""
    sp = pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(lifetime=pt.RandF32.constant(0.5))],
        emission_settings=[pt.EmissionSettings(emission_pacing=pt.EmissionPacing.rate(300.0))])
    c = pt.compile_spawner(sp, device="cpu")
    assert c.static.ring_claim
    state = pt.init_pool_for(c, 256, 0)
    frame = pt.make_frame_input(1 / 60)
    for _ in range(40):
        state, _ = pt.step_jit(c.static, c.params, None, state, frame)
    arrays = pck.pool_to_arrays(state)
    true_cursor = int(arrays.pop("ring_cursor"))
    restored = pck.pool_from_arrays(arrays, device="cpu")
    assert int(restored.ring_cursor) == true_cursor
    a, b = state, restored
    for _ in range(40):
        a, oa = pt.step_jit(c.static, c.params, None, a, frame)
        b, ob = pt.step_jit(c.static, c.params, None, b, frame)
        assert int(oa.alive_count) == int(ob.alive_count)
    assert torch.equal(a.alive, b.alive)
    # the JAX package's reconstruction on the same arrays agrees
    assert jck._reconstruct_ring_cursor(arrays) == pck._reconstruct_ring_cursor(arrays) == true_cursor


def test_scene_checkpoint_round_trips_trails_and_nested_buffer(tmp_path):
    """Trail history, nested_buffer and the render layers survive: the
    restored trail items equal the saved scene's and keep extending
    identically."""
    path = os.path.join(tmp_path, "trail.ckpt")
    a = pt.Scene(device="cpu")
    sid = a.add_spawner(spawner(), capacity=512, nested_buffer=2048,
                        trail=pt.TrailSettings(length=5, width=0.4, taper=False), layers=0b110)
    for _ in range(20):
        a.step(1 / 60)
    pck.save_scene(path, a)
    b = pck.load_scene(path, device="cpu")
    assert b._spawners[sid].compiled.static.nested_m == 2048 and b._spawners[sid].layers == 0b110
    assert b._spawners[sid].trail_settings == pt.TrailSettings(length=5, width=0.4, taper=False)
    ia, ib = a.trail_items(), b.trail_items()
    assert len(ia) == len(ib) == 1
    np.testing.assert_array_equal(ia[0].segments, ib[0].segments)
    for _ in range(10):
        a.step(1 / 60)
        b.step(1 / 60)
    np.testing.assert_array_equal(a.trail_items()[0].segments, b.trail_items()[0].segments)
    same_port_scenes(a, b)


def test_scene_checkpoint_round_trips_colliders_and_fields(tmp_path):
    """The collider scene (an edited sphere, a floor, a disabled hull slot,
    live handles) and the force fields survive: identical continuation,
    handles still editable, an explicit collider override wins."""
    sp = pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(
            lifetime=pt.RandF32.constant(1.0),
            collision_settings=pt.ParticleCollisionSettings(restitution=0.5, friction=0.1))],
        emission_settings=[pt.EmissionSettings(
            emission_pacing=pt.EmissionPacing.rate(400.0),
            initial_velocity=pt.RandVec3(pt.RandF32(1.0, 2.0), (0, 1, 0), 0.4))])
    a = pt.Scene(colliders=[pt.Collider.halfspace(position=(0.0, -0.5, 0.0))], device="cpu",
                 force_fields=[pt.ForceField.vortex((0, 0, 0), (0, 1, 0), strength=3.0, radius=2.0)])
    cid = a.add_collider(pt.Collider.sphere(0.4, position=(0.5, 1.0, 0.0)))
    hid = a.add_collider(pt.Collider.hull([(1, 0, 0, 0.5), (-1, 0, 0, 0.5), (0, 1, 0, 0.5),
                                                (0, -1, 0, 0.5), (0, 0, 1, 0.5), (0, 0, -1, 0.5)], position=(0, 3, 0)))
    a.remove_collider(hid)
    a.add_spawner(sp, capacity=1024)
    for _ in range(10):
        a.step(1 / 60)
    a.set_collider(cid, position=(0.7, 1.0, 0.0))
    a.set_force_field(0, strength=5.0)
    path = os.path.join(tmp_path, "col.ckpt")
    pck.save_scene(path, a)
    b = pck.load_scene(path, device="cpu")
    assert b._collider_slots == a._collider_slots and b._field_slots == a._field_slots
    for _ in range(40):
        a.step(1 / 60)
        b.step(1 / 60)
    same_port_scenes(a, b)
    st = b._spawners[0].state
    assert st.py[st.alive].min() >= -0.6  # the floor holds
    b.set_collider(cid, position=(0.0, 5.0, 0.0))
    b.remove_collider(cid)
    b.step(1 / 60)
    c = pck.load_scene(path, colliders=[pt.Collider.halfspace(position=(0.0, -2.0, 0.0))], device="cpu")
    assert len(c._collider_slots) == 1


def _cross_scene(pkg, handler=None):
    """A deterministic scene of both packages: a trailed spawner bouncing
    off a floor and a sphere under a vortex, a second one at its own
    transform, and a third removed (ids 0 and 2 survive)."""
    sc = pkg.Scene(colliders=[pkg.Collider.halfspace(position=(0.0, -0.5, 0.0))], seed=3,
                   force_fields=[pkg.ForceField.vortex((0, 0, 0), (0, 1, 0), strength=3.0, radius=2.0)],
                   **({"device": "cpu"} if pkg is pt else {}))
    sc.add_collider(pkg.Collider.sphere(0.4, position=(0.5, 1.0, 0.0)))
    sc.add_spawner(det(pkg, collide=True), capacity=512, trail=pkg.TrailSettings(length=6, width=0.4))
    gone = sc.add_spawner(det(pkg), capacity=256)
    sc.add_spawner(det(pkg, rate=128.0), capacity=256, transform=pkg.Transform(translation=(2.0, 0.0, 0.0)))
    sc.remove_spawner(gone)
    return sc


def test_jax_saved_zip_loads_in_port(tmp_path):
    """A checkpoint the JAX package saved (trail, collider, field,
    non-contiguous ids) loads in the port, and 30 frames of it equal the
    JAX Scene's 30."""
    js = _cross_scene(jx)
    for _ in range(20):
        js.step(DT)
    path = os.path.join(tmp_path, "jax.ckpt")
    jck.save_scene(path, js)
    ps = pck.load_scene(path, device="cpu")
    assert ps.spawner_ids() == [0, 2] and ps._next_id == 3 and ps.time == js.time
    assert len(ps._collider_slots) == 2 and len(ps._field_slots) == 1
    jax_matches_port(js, ps)
    for _ in range(30):
        js.step(DT)
        ps.step(DT)
    jax_matches_port(js, ps)


def test_port_saved_zip_loads_in_jax(tmp_path):
    """A checkpoint the port saved loads in the JAX package's load_scene,
    whose 30 frames then equal the port's 30."""
    ps = _cross_scene(pt)
    for _ in range(20):
        ps.step(DT)
    path = os.path.join(tmp_path, "port.ckpt")
    pck.save_scene(path, ps)
    js = jck.load_scene(path)
    assert sorted(js.spawner_ids()) == [0, 2] and js._next_id == 3
    jax_matches_port(js, ps)
    for _ in range(30):
        js.step(DT)
        ps.step(DT)
    jax_matches_port(js, ps)


def _random_config(seed):
    """A seeded random scene: a trailed archetype group of three (the
    stacked trails), a destroy-on-collision spawner with a handler and the
    random spawner under a turbulence field, with collider edits."""
    rng = np.random.default_rng(seed)
    sink = []
    sc = pt.Scene(device="cpu", seed=int(rng.integers(0, 1000)),
                  colliders=[pt.Collider.halfspace(position=(0.0, float(rng.uniform(-1.0, -0.3)), 0.0))],
                  force_fields=[pt.ForceField.turbulence((0, 1, 0), strength=float(rng.uniform(0.5, 2.0)),
                                                         radius=3.0)])
    trail = pt.TrailSettings(length=int(rng.integers(2, 9)), width=float(rng.uniform(0.1, 1.0)))
    for i in range(3):
        sc.add_spawner(spawner(), capacity=512, transform=pt.Transform(translation=(float(i), 0.0, 0.0)),
                       trail=trail)
    ceiling = sc.add_collider(pt.Collider.halfspace(position=(0.0, 0.6, 0.0), rotation=FLIP))
    destroy = pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(
            lifetime=pt.RandF32(0.5, 1.0),
            collision_settings=pt.ParticleCollisionSettings(destroy_on_collision=True),
            event_handlers=pt.ParticleEventHandlers(particles_destroyed=sink.append))],
        emission_settings=[pt.EmissionSettings(
            emission_pacing=pt.EmissionPacing.rate(float(rng.uniform(200, 600))),
            initial_velocity=pt.RandVec3(pt.RandF32(2.0, 5.0), (0, 1, 0), 0.5))])
    sc.add_spawner(destroy, capacity=1024, trail=pt.TrailSettings(length=3))
    return sc, sink, ceiling


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_config_resume_is_bit_exact(tmp_path, seed):
    """Seeded random configs saved at frame 12 (a collider edited before),
    loaded, and run 12 more frames with a collider edit and a step_n: ==
    the uninterrupted run bit for bit, pools, trails and destroyed records
    included (the handler registered again after loading)."""
    a, sink_a, ceiling = _random_config(seed)
    for f in range(12):
        a.step(1 / 60)
    a.set_collider(ceiling, position=(0.0, 0.5, 0.0))
    path = os.path.join(tmp_path, "r.ckpt")
    pck.save_scene(path, a)
    b = pck.load_scene(path, device="cpu")
    _ref, sink_b, _c = _random_config(seed)  # the handler of a fresh build
    b._spawners[3].spawner = _ref._spawners[3].spawner  # handlers are code, not saved
    b._spawners[3].compiled = b._compile(b._spawners[3].spawner, 4096)
    sink_a.clear()
    for sc in (a, b):
        for f in range(12):
            sc.step(1 / 60)
            if f == 5:
                sc.set_collider(ceiling, position=(0.0, 0.7, 0.0))
        sc.step_n(1 / 60, 3)
    same_port_scenes(a, b)
    assert len(sink_a) == len(sink_b) > 0
    assert [[dataclasses.astuple(r) for r in rs] for rs in sink_a] == [[dataclasses.astuple(r) for r in rs]
                                                                       for rs in sink_b]
