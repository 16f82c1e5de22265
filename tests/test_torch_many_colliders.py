"""Many-collider scenes and the lifted table caps, against the JAX package, on
the CPU.

The kernel's tables are sized from the spawner and the scene, so the port
takes every count of colliders, knots, emitters, types and force fields the
JAX package takes; from LOOP_MIN_COLLIDERS colliders its narrow phase skips,
per warp and substep, the colliders no active lane can reach
(`collision.broad_phase_keep`, the plain version of the kernel's test).

References. Configs with colliders go through the JAX package's Pallas
kernel in interpret mode (as its own tests run it on the CPU): from 5
colliders that kernel runs its looped narrow phase with the broad phase
(`_collide_tile` :452-563), the kernel block this port's broad phase
replaces. Its XLA step (`step.step_jit`) unrolls every collider into every
substep and takes minutes to compile at 33 colliders on a CPU, so it is the
reference only where no collider runs:
the 17-knot curve, 9 emitters and 9 types, and the Scene with 9 force
fields (the JAX Scene, which steps through it on the CPU).

Inputs: constant draws (tests/test_fused_step.py's deterministic spawner) at
N = 8192 lanes for 12 frames, the emitter moved every frame so the lanes
spread over many trajectories. Tolerances: alive, counts, cursors and
cadence scalars exact; f32 fields within 1e-4, the trajectory rule of
test_torch_collision.py (XLA on the CPU contracts multiply-adds and the
rotated quadratic colliders amplify the rotation's rounding: 1e-4 in world
space; the hull/sphere FMA seam of docs/PARITY.md:69 is 2e-6)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from bevy_firework_tpu.ops import fused_step as jfs
from bevy_firework_tpu.step import step_jit
from bevy_firework_tpu_torch import collision as pcol
from bevy_firework_tpu_torch.colliders import masked_layers
from bevy_firework_tpu_torch.ops import fused_step as pfs
from bevy_firework_tpu_torch.parallel.sharding import stack_frames, stack_pools, state_slot
from bevy_firework_tpu_torch.step import plain_frames, plain_step
from bevy_firework_tpu_torch.utils.quat import quat_rotate_comp
from test_torch_common import (  # noqa: F401
    _one_torch_thread,
    assert_pools_match,
    jax_pool_numpy,
    port_pool_numpy,
)

N = 8192
FRAMES = 12
DT = 1 / 32  # with rate 1024: 32 spawns a frame, every cadence sum exact in f32 (no FMA seam)
ATOL = 1e-4
S8, C8 = math.sin(math.pi / 8), math.cos(math.pi / 8)
ROTS = ((0.1830127, 0.3415064, -0.1294095, 0.9123724), (S8, 0.0, 0.0, C8), (0.0, S8, 0.0, C8), (0.0, 0.0, S8, C8))
DIRS = ((3.0, 4.0, 0.5), (-4.0, 2.0, 1.0), (1.0, -3.0, -4.0), (-1.5, -1.0, 3.5), (4.5, 1.5, 2.5), (-2.5, 5.0, -1.5),
        (0.5, -4.5, 2.0), (-3.0, 3.0, -3.5), (2.5, -2.0, -1.0))


def fan(pkg, n_emitters=4, n_types=1, destroy=False, ps=None):
    """Constant draws: `n_emitters` rate emitters at 1024/s, each with its
    own constant velocity (and angular velocity: live rotation), emitter e
    spawning type e % n_types; the types differ in lifetime, gravity and
    scale curve, and bounce (restitution 0.5, friction 0.1) or, with
    `destroy`, die on contact."""
    col = pkg.ParticleCollisionSettings(restitution=0.5, friction=0.1, destroy_on_collision=destroy)
    types = [pkg.ParticleSettings(
        lifetime=pkg.RandF32.constant(0.5 - 0.02 * t), initial_scale=pkg.RandF32.constant(0.1),
        scale_curve=pkg.FireworkCurve.uneven_samples([(0.0, 1.0), (1.0, 2.0 + t)]),
        acceleration=(0.0, -9.81 + 0.5 * t, 0.0), linear_drag=0.05 * t, collision_settings=col, **(ps or {}))
        for t in range(n_types)]
    emitters = [pkg.EmissionSettings(
        particle_index=e % n_types, emission_pacing=pkg.EmissionPacing.rate(1024.0),
        initial_velocity=pkg.RandVec3.constant(DIRS[e % len(DIRS)]),
        initial_angular_velocity=pkg.RandVec3.constant((0.0, 2.0, 0.3 * e))) for e in range(n_emitters)]
    return pkg.ParticleSpawner(particle_settings=types, emission_settings=emitters)


def translation(k):
    """The emitter's position at frame k: every frame's spawns start on new
    trajectories."""
    return (0.151 * (k % 6) - 0.403, 0.047 * (k % 3), 0.097 * (k % 4) - 0.149)


def six_colliders(pkg):
    """tests/test_fused_step.py:128-135: colliders the fan hits and far ones
    of every kind, one of them rotated."""
    return [
        pkg.Collider.halfspace(position=(0.0, -0.5, 0.0)),
        pkg.Collider.sphere(0.4, position=(0.6, 1.0, 0.1)),
        pkg.Collider.cuboid((0.3, 0.3, 0.3), position=(50.0, 0.0, 0.0)),
        pkg.Collider.capsule(0.2, 0.5, position=(0.0, 40.0, 0.0)),
        pkg.Collider.cylinder(0.3, 0.4, position=(-60.0, 2.0, 3.0), rotation=(0.0, 0.0, 0.3826834, 0.9238795)),
        pkg.Collider.cone(0.5, 0.5, position=(0.0, 0.0, 70.0)),
    ]


def many_colliders(pkg, count, seed):
    """`count` colliders: the six-collider mix, two overlapping colliders at
    the emitter (lanes spawn inside both: distance 0 from each), a tilted
    halfspace far below, then seeded colliders of every kind, a quarter of
    them hulls, two thirds in the fan's path and a third far from it, every
    third one rotated."""
    rng = np.random.default_rng(seed)
    cols = six_colliders(pkg) + [
        pkg.Collider.sphere(0.27, position=(0.013, 0.021, 0.007)),
        pkg.Collider.cuboid((0.21, 0.23, 0.19), position=(0.11, 0.047, 0.013)),
        pkg.Collider.halfspace(position=(0.0, -30.0, 0.0), rotation=ROTS[1]),
    ]
    while len(cols) < count:
        i = len(cols)
        if i % 3:
            p = (rng.uniform(-2.5, 2.5), rng.uniform(-0.3, 2.5), rng.uniform(-2.5, 2.5))
        else:
            p = tuple(rng.uniform(-40.0, 40.0, 3))
        rot = ROTS[i % 4] if i % 3 == 1 else (0.0, 0.0, 0.0, 1.0)
        s = float(rng.uniform(0.15, 0.45))
        kind = i % 8
        if kind == 0:
            cols.append(pkg.Collider.sphere(s, position=p))
        elif kind in (1, 7):
            cols.append(pkg.Collider.cuboid((s, 0.7 * s, 1.2 * s), position=p, rotation=rot))
        elif kind == 2:
            cols.append(pkg.Collider.hull_from_points([(0, 0, 0), (2 * s, 0, 0), (0, 2.5 * s, 0), (0, 0, 2 * s)],
                                                      position=p, rotation=rot))
        elif kind == 3:
            cols.append(pkg.Collider.capsule(0.5 * s, s, position=p, rotation=rot))
        elif kind == 4:
            cols.append(pkg.Collider.cylinder(s, 0.8 * s, position=p, rotation=rot))
        elif kind == 5:
            cols.append(pkg.Collider.hull([(1, 0, 0, s), (-1, 0, 0, s), (0, 1, 0, s), (0, -1, 0, s), (0, 0, 1, s),
                                           (0, 0, -1, s), (1, 1, 0, 1.2 * s), (-1, 1, 0, 1.2 * s)],
                                          position=p, rotation=rot))
        else:
            cols.append(pkg.Collider.cone(s, 0.9 * s, position=p, rotation=rot))
    return cols


def tables(make, disabled=()):
    """The same scene compiled by both packages; the colliders at `disabled`
    switched off (active 0) in both."""
    jt, ptab = jx.compile_colliders(make(jx)), pt.compile_colliders(make(pt), device="cpu")
    if disabled:
        act = np.ones(ptab.count, np.float32)
        act[list(disabled)] = 0.0
        jt = dataclasses.replace(jt, active=jnp.asarray(act))
        ptab = dataclasses.replace(ptab, active=torch.from_numpy(act))
    return jt, ptab


def winners(table, rec):
    """Per lane of a recorded substep (`collision.record_substeps`), the
    collider its nearest hit within max_dist comes from (-1: none), by the
    plain narrow phase's own tests in table order."""
    best = torch.full_like(rec["px"], pcol.BIG)
    win = torch.full(rec["px"].shape, -1, dtype=torch.int64)
    layers = masked_layers(table)
    for ci in range(table.count):
        c, q = table.position[ci], table.rotation[ci]
        ox, oy, oz = rec["px"] - c[0], rec["py"] - c[1], rec["pz"] - c[2]
        dx, dy, dz = rec["dx"], rec["dy"], rec["dz"]
        if not table.identity_rot[ci]:
            ox, oy, oz = quat_rotate_comp(-q[0], -q[1], -q[2], q[3], ox, oy, oz)
            dx, dy, dz = quat_rotate_comp(-q[0], -q[1], -q[2], q[3], dx, dy, dz)
        dist = pcol.ray_collider(table, ci, ox, oy, oz, dx, dy, dz)[0].expand_as(best)
        dist = torch.where((rec["lane_mask"] & layers[ci]) != 0, dist, pcol.BIG)
        closer = (dist <= rec["max_dist"]) & (dist < best)
        best = torch.where(closer, dist, best)
        win = torch.where(closer, ci, win)
    return win


def assert_kept(table, rec):
    """Every active lane's winning collider is kept for the lane's warp;
    returns (tests kept, tests the warps with an active lane would run)."""
    keep = pcol.broad_phase_keep(table, rec["px"], rec["py"], rec["pz"], rec["max_dist"], rec["active"])
    win = winners(table, rec)
    hit = rec["active"] & (win >= 0)
    lanes = torch.nonzero(hit).squeeze(1)
    assert bool(keep[lanes // 32, win[lanes]].all()), "a winning collider was skipped"
    pad = torch.zeros(keep.shape[0] * 32 - rec["active"].shape[0], dtype=torch.bool)
    groups = int(torch.cat([rec["active"], pad]).view(-1, 32).any(1).sum())
    return int(keep.sum()), groups * table.count


_jax_fused = jax.jit(jfs.fused_step, static_argnums=(0,))


def run_interpret(cj, jt, frame, sj):
    """One frame of the JAX package's Pallas kernel in interpret mode."""
    with pltpu.force_tpu_interpret_mode():
        return _jax_fused(cj.static, cj.params, jt, sj, frame)


def compare(sj, oj, sp, op, label):
    """The JAX package's pool and outputs against the port's: alive,
    counts, cursor and cadence scalars exact, f32 fields within ATOL."""
    a, b = jax_pool_numpy(sj), port_pool_numpy(sp)
    assert_pools_match(a, b, atol=ATOL, rtol=0)
    for k in ("ring_cursor", "time_in_cycle", "last_emission"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=f"{label}: {k}")
    assert int(op.alive_count) == int(oj.alive_count), label
    np.testing.assert_array_equal(op.alive_count_per_type.numpy(), np.asarray(oj.alive_count_per_type))


MANY = {
    # (colliders, disabled indices, destroy on contact)
    "six_kinds": (six_colliders, (), False),
    "c33": (lambda pkg: many_colliders(pkg, 33, 1), (9, 16, 23), False),
    "c64": (lambda pkg: many_colliders(pkg, 64, 2), (10, 17, 30, 47, 60), False),
    "c64_destroy": (lambda pkg: many_colliders(pkg, 64, 3), (12,), True),
}


@pytest.mark.parametrize("config", sorted(MANY))
def test_many_colliders_match_jax_looped_kernel(config):
    """The port's step (its plain version) against the JAX package's Pallas
    kernel in interpret mode, whose looped narrow phase with its broad
    phase runs from 5 colliders: every frame, alive, counts and cursor
    exact, fields within 1e-4. On the port's side every substep of every
    frame is recorded, and the broad phase keeps, for each warp, the
    collider each of its active lanes hits (it skips some: the test is not
    vacuous)."""
    make, disabled, destroy = MANY[config]
    cj, cp = jx.compile_spawner(fan(jx, destroy=destroy)), pt.compile_spawner(fan(pt, destroy=destroy), device="cpu")
    assert cp.static.ring_claim == (not destroy)
    jt, ptab = tables(make, disabled)
    assert ptab.count >= pcol.LOOP_MIN_COLLIDERS
    sj, sp = jx.init_pool_for(cj, N, 0), pt.init_pool_for(cp, N, 0)
    free = sp
    kept = tests = 0
    for k in range(FRAMES):
        fj, fp = jx.make_frame_input(DT, translation=translation(k)), pt.make_frame_input(DT, translation=translation(k))
        sj, oj = run_interpret(cj, jt, fj, sj)
        with pcol.record_substeps() as log:
            sp, op = plain_step(cp.static, cp.params, ptab, sp, fp)
        compare(sj, oj, sp, op, f"{config} frame {k}")
        free, _o = plain_step(cp.static, cp.params, None, free, fp)
        for rec in log:
            k_, t_ = assert_kept(ptab, rec)
            kept, tests = kept + k_, tests + t_
    assert int(op.alive_count) > (100 if destroy else 500)
    bent = (sp.alive & ((sp.vx != free.vx) | (sp.vy != free.vy))).sum()
    assert int(bent) > (50 if destroy else 200)
    assert 0 < kept < tests  # the broad phase skipped some tests and kept some


def test_scene_with_40_colliders_matches_jax():
    """A Scene with 40 colliders; colliders moved at frame 3, removed at
    frame 5, re-added into a freed slot and appended at frame 8, and the
    emitter moved every frame. The JAX Scene receives the same edits and
    its collider table steps the JAX kernel (interpret mode) frame by
    frame: both Scenes' tables agree, and the port Scene's pool equals the
    kernel's (alive, cursor exact; fields within 1e-4)."""
    cols = {pkg: many_colliders(pkg, 40, 4) for pkg in (jx, pt)}
    js, ps = jx.Scene(colliders=cols[jx]), pt.Scene(colliders=cols[pt], device="cpu")
    sid = ps.add_spawner(fan(pt), capacity=N)
    cj = jx.compile_spawner(fan(jx))
    sj = jx.init_pool_for(cj, N, 0)
    ids = list(range(40))
    for k in range(FRAMES):
        edits = []
        if k == 3:
            edits = [("set_collider", ids[8], dict(position=(0.3, 0.8, -0.2))),
                     ("set_collider", ids[13], dict(position=(-0.5, 1.2, 0.4), rotation=ROTS[0]))]
        elif k == 5:
            edits = [("remove_collider", ids[1], {}), ("remove_collider", ids[17], {})]
        elif k == 8:
            edits = [("add_collider", None, dict(collider=lambda pkg: pkg.Collider.sphere(0.35, position=(1.0, 1.5, 0.0)))),
                     ("add_collider", None, dict(collider=lambda pkg: pkg.Collider.capsule(
                         0.2, 0.3, position=(-0.6, 0.9, -0.3), rotation=ROTS[2])))]
        for name, cid, kw in edits:
            for scene, pkg in ((js, jx), (ps, pt)):
                if name == "add_collider":
                    got = scene.add_collider(kw["collider"](pkg))
                elif name == "remove_collider":
                    scene.remove_collider(cid)
                else:
                    getattr(scene, name)(cid, **kw)
            if name == "add_collider":
                ids.append(got)
        jt, ptab = js._colliders, ps._colliders
        assert jt.kinds == ptab.kinds and jt.identity_rot == ptab.identity_rot
        for key in ("position", "rotation", "params", "active"):
            np.testing.assert_array_equal(np.asarray(getattr(jt, key)), getattr(ptab, key).numpy(), err_msg=key)
        ps.set_transform(sid, pt.Transform(translation=translation(k)))
        sj, oj = run_interpret(cj, jt, jx.make_frame_input(DT, translation=translation(k)), sj)
        ps.step(DT)
        slot = ps._spawners[sid]
        compare(sj, oj, slot.state, slot.outputs, f"scene frame {k}")
    assert ps._colliders.count == 41 and ps.alive_count() > 1000  # one re-added into a freed slot


def _curve_spawner(pkg, knots):
    """One type whose scale curve and base gradient have `knots` knots (an
    even and an uneven curve), emitted as the fan's first emitter."""
    vals = [0.5 + 0.4 * math.sin(0.7 * i) for i in range(knots)]
    grad = [(i / (knots - 1) if i < knots - 1 else 1.0, (0.1 * (i % 10), 0.5, 1.0 - 0.02 * i, 1.0)) for i in
            range(knots)]
    sp = fan(pkg, n_emitters=2)
    ps = dataclasses.replace(sp.particle_settings[0], scale_curve=pkg.FireworkCurve.even_samples(vals),
                             base_color=pkg.gradient_uneven_samples(grad),
                             emissive_color=pkg.gradient_even_samples([c for _t, c in grad]))
    return dataclasses.replace(sp, particle_settings=(ps,))


CAPS = {
    "knots17": (lambda pkg: _curve_spawner(pkg, 17)),
    "knots40": (lambda pkg: _curve_spawner(pkg, 40)),
    "emitters9_types9": (lambda pkg: fan(pkg, n_emitters=9, n_types=9)),
}


@pytest.mark.parametrize("config", sorted(CAPS))
def test_lifted_caps_match_jax_xla_step(config):
    """Past the old table caps (16 knots, 8 emitters, 8 types), no
    colliders: the port's step against the JAX XLA step every frame
    (alive, per-type counts, cursor exact; fields within 1e-4), the AABB
    (pos +- the curve's scale) within 1e-4, and the dense render rows of
    every type (the curves evaluated per lane) within 1e-4; the kernel's
    table packs every knot at the header's stride."""
    make = CAPS[config]
    cj, cp = jx.compile_spawner(make(jx)), pt.compile_spawner(make(pt), device="cpu")
    w = pfs.pack_tables(cp.static, cp.params)
    assert w[pfs.L.H_K] == cp.params.scale_ts.shape[1] and w[pfs.L.H_E] == cp.num_emitters
    assert w.size == pfs.L.table_words(cp.num_emitters, cp.num_types, w[pfs.L.H_K])
    sj, sp = jx.init_pool_for(cj, N, 0), pt.init_pool_for(cp, N, 0)
    for k in range(FRAMES):
        fj, fp = jx.make_frame_input(DT, translation=translation(k)), pt.make_frame_input(DT, translation=translation(k))
        sj, oj = step_jit(cj.static, cj.params, None, sj, fj)
        sp, op = plain_step(cp.static, cp.params, None, sp, fp)
        compare(sj, oj, sp, op, f"{config} frame {k}")
    for key in ("aabb_min", "aabb_max"):
        np.testing.assert_allclose(getattr(op, key).numpy(), np.asarray(getattr(oj, key)), atol=ATOL, rtol=0)
    assert int((op.alive_count_per_type > 0).sum()) == cp.num_types
    for t in range(cp.num_types):
        a = np.asarray(jx.pack_instances_dense(cj.params, sj, t)[0])
        b = pt.pack_instances_dense(cp.params, sp, t)[0].numpy()
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=0, err_msg=f"type {t} rows")


def _nine_fields(pkg):
    """Nine fields of every kind around the fan, one disabled later."""
    return [pkg.ForceField.point((0.3, 0.8, -0.2), 6.0, 2.5), pkg.ForceField.vortex((0.1, 0.0, 0.2), (0.3, 0.9, 0.1), 5.0, 3.0),
            pkg.ForceField.axial((-0.2, 0.0, 0.1), (0.0, 1.0, 0.0), 8.0, 2.0),
            pkg.ForceField.turbulence((0.0, 0.5, 0.0), 4.0, 6.0, frequency=1.7, phase=0.3),
            pkg.ForceField.point((-0.8, 1.5, 0.6), -4.0, 3.0), pkg.ForceField.vortex((0.5, 1.0, -0.5), (0.0, 0.0, 1.0), 3.0, 2.0),
            pkg.ForceField.axial((0.4, 2.0, 0.3), (1.0, 0.2, 0.0), 5.0, 2.5),
            pkg.ForceField.turbulence((0.6, 1.0, -0.4), 2.0, 4.0, frequency=2.3, phase=1.1),
            pkg.ForceField.point((0.0, 3.0, 0.0), 7.0, 4.0)]


def test_scene_with_nine_force_fields_matches_jax_scene():
    """Past the old 8-field cap: both Scenes with nine fields, one moved
    every frame and one removed at frame 6, the fan stepping 12 frames:
    alive exact, the pools within 1e-4; the kernel's records hold every
    field."""
    js, ps = jx.Scene(force_fields=_nine_fields(jx)), pt.Scene(force_fields=_nine_fields(pt), device="cpu")
    sj_id, sp_id = js.add_spawner(fan(jx), capacity=N), ps.add_spawner(fan(pt), capacity=N)
    for k in range(FRAMES):
        for scene in (js, ps):
            scene.set_force_field(3, position=(0.05 * k, 0.5, -0.03 * k))
            if k == 6:
                scene.remove_force_field(5)
            scene.step(DT)
        assert ps.alive_count() == js.alive_count()
        a, b = jax_pool_numpy(js._spawners[sj_id].state), port_pool_numpy(ps._spawners[sp_id].state)
        assert_pools_match(a, b, atol=ATOL, rtol=0)
    assert pfs.pack_fields(ps._force_fields).size == 9 * pfs.L.FF_STRIDE and ps.alive_count() > 1000


def test_entry_points_take_any_table_size():
    """step_auto, multi_step_auto, fused_step_fleet and Fleet on the CPU with
    200 colliders, a 40-knot curve, 9 emitters and types and 12 force fields
    (every count past an old cap): they run, the chain equals its plain
    frames, and each fleet slot equals its solo plain frames."""
    sp = dataclasses.replace(fan(pt, n_emitters=9, n_types=9), particle_settings=tuple(
        dataclasses.replace(p, scale_curve=pt.FireworkCurve.even_samples([1.0 + 0.01 * i for i in range(40)]))
        for p in fan(pt, n_emitters=9, n_types=9).particle_settings))
    c = pt.compile_spawner(sp, device="cpu")
    table = pt.compile_colliders(many_colliders(pt, 200, 5), device="cpu")
    fields = pt.compile_force_fields(_nine_fields(pt) + _nine_fields(pt)[:3], device="cpu")
    f = pt.make_frame_input(DT, force_fields=fields)
    s0 = pt.init_pool_for(c, 2048, 0)
    s1, o1 = pt.step_auto(c.static, c.params, table, s0, f)
    sa, oa = pt.multi_step_auto(c.static, c.params, table, s1, f, 5)
    sb, ob = plain_frames(c.static, c.params, s1, f, 5, colliders=table)
    for key, v in port_pool_numpy(sa).items():
        np.testing.assert_array_equal(v, port_pool_numpy(sb)[key], err_msg=key)
    assert int(oa.alive_count) == int(ob.alive_count) > 0
    frames = [pt.make_frame_input(DT, translation=translation(i), force_fields=fields) for i in range(3)]
    pools = [pt.init_pool_for(c, 2048, i) for i in range(3)]
    st, _o = pfs.fused_step_fleet(c.static, c.params, table, stack_pools(pools), stack_frames(frames))
    for i in range(3):
        solo, _o = plain_frames(c.static, c.params, pools[i], frames[i], 1, colliders=table)
        for key, v in port_pool_numpy(state_slot(st, i)).items():
            np.testing.assert_array_equal(v, port_pool_numpy(solo)[key], err_msg=(i, key))
    fleet = pt.Fleet(fan(pt), capacity=1024, max_spawners=2, colliders=table, device="cpu")
    fleet.activate(pt.Transform(translation=(0.5, 0.0, 0.0)))
    for _ in range(4):
        fleet.step(DT)
    assert fleet.alive_count() > 100


def test_broad_phase_keep_is_conservative():
    """Random lanes (positions and max_dist with NaN and inf among them,
    20% inactive, random layer masks) against random tables of every kind,
    rotated and not, some disabled: for every active lane whose nearest hit
    within max_dist is collider ci, its 32-lane group keeps ci. Groups
    without an active lane and disabled colliders are never kept; the test
    skips some colliders (it is not vacuous)."""
    rng = np.random.default_rng(11)
    kinds = ("halfspace", "sphere", "cuboid", "capsule", "cylinder", "cone", "hull")
    for trial in range(4):
        cols = [pt.Collider.halfspace(position=(0.0, -3.0, 0.0))]  # unrotated: reached by lanes with NaN x or z
        for i in range(27):
            p = tuple(rng.uniform(-6.0, 6.0, 3))
            rot = ROTS[i % 4] if i % 2 else (0.0, 0.0, 0.0, 1.0)
            s = float(rng.uniform(0.2, 1.5))
            layers = int(rng.choice([0xFFFFFFFF, 0b01, 0b10]))
            kind = kinds[i % 7]
            if kind == "halfspace":
                cols.append(pt.Collider.halfspace(position=(p[0], p[1] - 8.0, p[2]), rotation=ROTS[i % 4], layers=layers))
            elif kind == "sphere":
                cols.append(pt.Collider.sphere(s, position=p, layers=layers))
            elif kind == "cuboid":
                cols.append(pt.Collider.cuboid((s, 0.5 * s, 1.5 * s), position=p, rotation=rot, layers=layers))
            elif kind == "capsule":
                cols.append(pt.Collider.capsule(0.4 * s, s, position=p, rotation=rot, layers=layers))
            elif kind == "cylinder":
                cols.append(pt.Collider.cylinder(s, 0.6 * s, position=p, rotation=rot, layers=layers))
            elif kind == "cone":
                cols.append(pt.Collider.cone(s, s, position=p, rotation=rot, layers=layers))
            else:
                cols.append(pt.Collider.hull_from_points([(0, 0, 0), (2 * s, 0, 0), (0, 2 * s, 0), (0, 0, 2 * s)],
                                                         position=p, rotation=rot, layers=layers))
        table = pt.compile_colliders(cols, device="cpu")
        act = (rng.uniform(size=table.count) > 0.15).astype(np.float32)
        table = dataclasses.replace(table, active=torch.from_numpy(act))
        n = 4096  # 128 groups of 32 lanes, each around its own centre (as a warp's lanes are)
        pos = (np.repeat(rng.uniform(-7.0, 7.0, (n // 32, 3)), 32, 0) + rng.normal(0.0, 0.4, (n, 3))).astype(np.float32)
        bad = rng.integers(0, n, 120)
        pos[bad[:40], rng.integers(0, 3, 40)] = np.nan
        pos[bad[40:80], rng.integers(0, 3, 40)] = np.inf
        pos[bad[80:], rng.integers(0, 3, 40)] = -np.inf
        d = rng.normal(size=(n, 3))
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        md = rng.uniform(0.0, 1.0, n).astype(np.float32)
        md[rng.integers(0, n, 20)] = np.nan
        md[rng.integers(0, n, 5)] = np.inf
        active = rng.uniform(size=n) < 0.8
        active[64 * trial:64 * trial + 32] = False  # one group with no active lane
        rec = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in (
            ("px", pos[:, 0]), ("py", pos[:, 1]), ("pz", pos[:, 2]), ("dx", d[:, 0]), ("dy", d[:, 1]),
            ("dz", d[:, 2]), ("max_dist", md), ("active", active))}
        rec["lane_mask"] = torch.from_numpy(rng.choice(np.array([0xFFFFFFFF, 0b01, 0b10, 0b100], np.int64), n))
        kept, tests = assert_kept(table, rec)
        keep = pcol.broad_phase_keep(table, rec["px"], rec["py"], rec["pz"], rec["max_dist"], rec["active"])
        assert not keep[2 * trial].any() and not keep[:, act == 0].any()
        assert 0 < kept < 0.5 * tests
        assert int((winners(table, rec) >= 0).sum()) > 100  # lanes hit
