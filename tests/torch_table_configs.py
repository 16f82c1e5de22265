"""Configurations past the kernel's old table caps, shared by the port's
checks on the card (chip_smoke.py's many_collider_det, caps_det and
collider_scaling_1M, the `cuda` tests of test_torch_kernel.py): collider
scenes of 6 to 200 colliders, curves of more than 16 knots, 9 emitters, 9
particle types and 9 force fields. Imports torch and the port only, so the
card's checks can use it without JAX.

Every spawner here emits from a box with random speeds and no spread, so
its draws reach the state through +, -, *, / and sqrt only and the kernel
equals its plain version bit for bit; the collider scenes surround that
emission volume (x, z in [-1.5, 1.5], y in [-0.5, 0.5], radial speeds of
1-4 m/s under gravity)."""

import dataclasses
import math

import numpy as np
import torch

import bevy_firework_tpu_torch as pt

S8, C8 = math.sin(math.pi / 8), math.cos(math.pi / 8)
ROTS = ((0.1830127, 0.3415064, -0.1294095, 0.9123724), (S8, 0.0, 0.0, C8), (0.0, S8, 0.0, C8), (0.0, 0.0, S8, C8))


def six_mix():
    """tests/test_fused_step.py:128-135's mix: colliders in the spray and far
    ones of every kind, one of them rotated."""
    return [
        pt.Collider.halfspace(position=(0.0, -0.8, 0.0)),
        pt.Collider.sphere(0.4, position=(0.6, 1.0, 0.1)),
        pt.Collider.cuboid((0.3, 0.3, 0.3), position=(50.0, 0.0, 0.0)),
        pt.Collider.capsule(0.2, 0.5, position=(0.0, 40.0, 0.0)),
        pt.Collider.cylinder(0.3, 0.4, position=(-60.0, 2.0, 3.0), rotation=(0.0, 0.0, 0.3826834, 0.9238795)),
        pt.Collider.cone(0.5, 0.5, position=(0.0, 0.0, 70.0)),
    ]


def prism16(radius, half_height, position, rotation=(0.0, 0.0, 0.0, 1.0)):
    """A 16-plane hull (the most planes a hull takes): a 14-sided prism."""
    planes = [(math.cos(2 * math.pi * i / 14), 0.0, math.sin(2 * math.pi * i / 14), radius) for i in range(14)]
    planes += [(0.0, 1.0, 0.0, half_height), (0.0, -1.0, 0.0, half_height)]
    return pt.Collider.hull(planes, position=position, rotation=rotation)


def mixed(count, seed, hulls=1, hull16=False):
    """`count` colliders around the spray: the floor, two overlapping
    colliders inside the emission box (lanes start inside both: distance 0
    from each), then seeded colliders of every kind, `hulls` in four of
    them hulls (tetrahedra, or with `hull16` 16-plane prisms), two thirds
    near the spray and a third far from it, every third one rotated.
    Returns (colliders, the indices to disable: every eleventh from 5)."""
    rng = np.random.default_rng(seed)
    cols = [pt.Collider.halfspace(position=(0.0, -0.8, 0.0)),
            pt.Collider.sphere(0.6, position=(0.5, 0.0, 0.5)),
            pt.Collider.cuboid((0.5, 0.5, 0.5), position=(0.7, 0.1, 0.5))]
    kinds = ("sphere", "cuboid", "capsule", "cylinder", "cone")
    while len(cols) < count:
        i = len(cols)
        near = i % 3 != 0
        p = (rng.uniform(-3.0, 3.0), rng.uniform(-0.6, 2.5), rng.uniform(-3.0, 3.0)) if near else \
            tuple(rng.uniform(-40.0, 40.0, 3))
        rot = ROTS[i % 4] if i % 3 == 1 else (0.0, 0.0, 0.0, 1.0)
        s = float(rng.uniform(0.2, 0.5))
        if i % 4 < hulls:
            cols.append(prism16(s, 0.8 * s, p, rot) if hull16 else pt.Collider.hull_from_points(
                [(0, 0, 0), (2 * s, 0, 0), (0, 2.5 * s, 0), (0, 0, 2 * s)], position=p, rotation=rot))
            continue
        kind = kinds[i % len(kinds)]
        if kind == "sphere":
            cols.append(pt.Collider.sphere(s, position=p))
        elif kind == "cuboid":
            cols.append(pt.Collider.cuboid((s, 0.7 * s, 1.2 * s), position=p, rotation=rot))
        elif kind == "capsule":
            cols.append(pt.Collider.capsule(0.5 * s, s, position=p, rotation=rot))
        elif kind == "cylinder":
            cols.append(pt.Collider.cylinder(s, 0.8 * s, position=p, rotation=rot))
        else:
            cols.append(pt.Collider.cone(s, 0.9 * s, position=p, rotation=rot))
    return cols, tuple(range(5, count, 11))


def compile_with_disabled(cols, disabled, device):
    """compile_colliders with the colliders at `disabled` switched off."""
    table = pt.compile_colliders(cols, device=device)
    if not disabled:
        return table
    act = torch.ones(table.count, dtype=torch.float32)
    act[list(disabled)] = 0.0
    return dataclasses.replace(table, active=act.to(table.device))


def det_scenes():
    """many_collider_det's scenes: name -> (colliders, disabled indices).
    c200 is 200 colliders, three in four of them 16-plane hulls: its table
    is larger than table_layout.SMEM_COLLIDER_WORDS, so the kernel reads it
    from global memory."""
    return {"six": (six_mix(), ()), "c33": mixed(33, 1), "c64": mixed(64, 2), "c200": mixed(200, 3, 3, True)}


def scaling_colliders(n, hulls=False):
    """tools/collider_scaling_tpu.py's scene (`colliders_n`), with the port's
    Collider: a floor under stress_test_collision's spray, then spheres,
    cuboids and capsules (and with `hulls` every fourth a tetrahedron hull)
    at seeded positions in a 40 m cube."""
    cols = [pt.Collider.halfspace(position=(0.0, -2.0, 0.0))]
    rng = np.random.RandomState(7)
    while len(cols) < n:
        p = rng.uniform(-20, 20, 3)
        k = len(cols) % (4 if hulls else 3)
        if k == 0:
            cols.append(pt.Collider.sphere(radius=1.0, position=tuple(p)))
        elif k == 1:
            cols.append(pt.Collider.cuboid(half_extents=(1.0, 1.0, 1.0), position=tuple(p)))
        elif k == 2:
            cols.append(pt.Collider.capsule(radius=0.5, half_segment=1.0, position=tuple(p)))
        else:
            cols.append(pt.Collider.hull_from_points([(0, 0, 0), (2.0, 0, 0), (0, 2.5, 0), (0, 0, 2.0)],
                                                     position=tuple(p)))
    return cols[:n]


def box_emitter(rate, box=(1.5, 0.5, 1.5), particle_index=0):
    return pt.EmissionSettings(
        particle_index=particle_index, emission_pacing=pt.EmissionPacing.rate(rate),
        emission_shape=pt.EmissionShape.box(box), initial_velocity=pt.RandVec3(pt.RandF32(0.5, 3.0), (0.0, 1.0, 0.0), 0.0),
        initial_velocity_radial=pt.RandF32(1.0, 4.0))


def box_type(t=0, curve=None, base=None, emissive=None):
    """Particle type t: lifetime 0.4 + 0.05 t, gravity, drag, bounces."""
    kw = {k: v for k, v in (("scale_curve", curve), ("base_color", base), ("emissive_color", emissive)) if v}
    return pt.ParticleSettings(
        lifetime=pt.RandF32.constant(0.4 + 0.05 * t), initial_scale=pt.RandF32(0.02, 0.08),
        acceleration=(0.0, -9.81 + 0.7 * t, 0.0), linear_drag=0.1 + 0.02 * t,
        collision_settings=pt.ParticleCollisionSettings(restitution=0.7, friction=0.3), **kw)


CAPS = ("knots17", "knots40", "emitters9", "types9", "types9_knots40", "emitters34")


def caps_spawner(case):
    """knots17 / knots40: a scale curve (even), a base gradient (uneven) and
    an emissive gradient (even) of that many knots; emitters9: nine box
    emitters of one type; types9: nine emitters, one per particle type;
    types9_knots40: types9 with 40-knot curves (a table of 4948 words);
    emitters34: `mixed_pacing_spawner(34)` (past the 32 emitters that the
    step kernel's warp runs on its lanes)."""
    if case == "emitters34":
        return mixed_pacing_spawner(34)
    if case == "types9_knots40":
        emitters = [box_emitter(1e4 + 2e3 * e, (0.5 + 0.1 * e, 0.3, 1.5 - 0.1 * e), e) for e in range(9)]
        types = []
        for t in range(9):
            vals = [0.5 + 0.4 * math.sin(0.7 * i + t) for i in range(40)]
            grad = [(i / 39, (0.1 * ((i + t) % 10), 0.5, 1.0 - 0.02 * i, 1.0)) for i in range(40)]
            types.append(box_type(t, curve=pt.FireworkCurve.even_samples(vals), base=pt.gradient_uneven_samples(grad),
                                  emissive=pt.gradient_even_samples([c for _t, c in grad])))
        return pt.ParticleSpawner(particle_settings=types, emission_settings=emitters)
    if case.startswith("knots"):
        k = int(case[5:])
        vals = [0.5 + 0.4 * math.sin(0.7 * i) for i in range(k)]
        grad = [(i / (k - 1), (0.1 * (i % 10), 0.5, 1.0 - 0.02 * i, 1.0)) for i in range(k)]
        t = box_type(curve=pt.FireworkCurve.even_samples(vals), base=pt.gradient_uneven_samples(grad),
                     emissive=pt.gradient_even_samples([c for _t, c in grad]))
        return pt.ParticleSpawner(particle_settings=[t], emission_settings=[box_emitter(3e5)])
    emitters = [box_emitter(1e4 + 2e3 * e, (0.5 + 0.1 * e, 0.3, 1.5 - 0.1 * e), e if case == "types9" else 0)
                for e in range(9)]
    types = [box_type(t) for t in range(9 if case == "types9" else 1)]
    return pt.ParticleSpawner(particle_settings=types, emission_settings=emitters)


def nine_fields(shift=0.0):
    """Nine force fields (points, vortices, axial fields: no libm call) about
    the spray, shifted along x by `shift`."""
    return [pt.ForceField.point((0.3 + shift, 0.8, -0.2), 6.0, 2.5),
            pt.ForceField.vortex((0.1 + shift, 0.0, 0.2), (0.3, 0.9, 0.1), 5.0, 3.0),
            pt.ForceField.axial((-0.2 + shift, 0.0, 0.1), (0.0, 1.0, 0.0), 8.0, 2.0),
            pt.ForceField.point((-0.8 + shift, 1.5, 0.6), -4.0, 3.0),
            pt.ForceField.vortex((0.5 + shift, 1.0, -0.5), (0.0, 0.0, 1.0), 3.0, 2.0),
            pt.ForceField.axial((0.4 + shift, 2.0, 0.3), (1.0, 0.2, 0.0), 5.0, 2.5),
            pt.ForceField.point((shift, 3.0, 0.0), 7.0, 4.0),
            pt.ForceField.vortex((-0.4 + shift, 0.5, 0.9), (0.6, 0.8, 0.0), 4.0, 2.0),
            pt.ForceField.axial((0.9 + shift, 0.2, -0.9), (0.0, 0.6, 0.8), 6.0, 3.0)]


def lifted_scene(device, frames=6):
    """A Scene past every old cap, on `device`: c200's colliders (200, some
    disabled after the scene is built), nine force fields and the types9
    spawner (9 emitters, 9 types), `frames` steps. Returns (scene, sid)."""
    cols, disabled = det_scenes()["c200"]
    scene = pt.Scene(colliders=cols, force_fields=nine_fields(), device=device)
    for cid in disabled:
        scene.remove_collider(cid)
    sid = scene.add_spawner(caps_spawner("types9"), capacity=65536)
    for _ in range(frames):
        scene.step(1 / 60)
    return scene, sid


def plain_replay(scene, sid, frames=6):
    """The Scene's spawner stepped `frames` times by the plain version on
    the scene's device, from a fresh pool with the scene's tables and
    frame: (state, outputs)."""
    from bevy_firework_tpu_torch.step import plain_frames

    slot = scene._spawners[sid]
    c = slot.compiled
    state = pt.init_pool_for(c, slot.capacity, seed=slot.seed)
    frame = scene._frame_for(slot, 1 / 60)
    out = None
    for _ in range(frames):
        state, out = plain_frames(c.static, c.params, state, frame, 1, colliders=scene._colliders)
    return state, out


def lifted_fleet(device, frames=6):
    """A Fleet of the box spawner against c200's colliders: two active slots
    of 4096 lanes, `frames` steps."""
    cols, disabled = det_scenes()["c200"]
    fleet = pt.Fleet(caps_spawner("emitters9"), capacity=4096, max_spawners=3,
                     colliders=compile_with_disabled(cols, disabled, device), device=device)
    fleet.activate(pt.Transform(translation=(0.5, 0.0, 0.0)))
    fleet.activate(pt.Transform(translation=(-0.5, 0.2, 0.0)))
    for _ in range(frames):
        fleet.step(1 / 60)
    return fleet


def fleet_plain_replay(fleet, slot, frames=6):
    """Active slot `slot` of a Fleet stepped `frames` times by the plain
    version on the fleet's device, from the pool its activation made (a
    fresh enabled pool keeping the slot's key: seed + slot) and its frame."""
    from bevy_firework_tpu_torch.parallel.sharding import frame_slot
    from bevy_firework_tpu_torch.step import plain_frames

    c = fleet.compiled
    state = pt.init_pool_for(c, fleet.capacity, seed=slot)
    frame = frame_slot(fleet._stacked_frames(1 / 60), slot)
    for _ in range(frames):
        state, _o = plain_frames(c.static, c.params, state, frame, 1, colliders=fleet.colliders)
    return state


def two_type_curves_spawner(rate=3e5):
    """Two box emitters, one per particle type, each type with an uneven
    scale curve and uneven base and emissive gradients (type 0's three on
    one knot row, type 1's gradients on another): the render pack's curve
    evaluations, per type."""
    ts = (0.0, 0.2, 0.45, 0.7, 1.0)
    scale0 = pt.FireworkCurve.uneven_samples([(t, 1.0 + 0.5 * math.sin(3 * t)) for t in ts])
    base0 = pt.gradient_uneven_samples([(t, (1.0 - t, 0.5 * t, 0.2, 1.0 - 0.5 * t)) for t in ts])
    emis0 = pt.gradient_uneven_samples([(t, (0.3 * t, 0.1, 1.0 - t, 1.0)) for t in ts])
    ts1 = (0.0, 0.35, 0.6, 1.0)
    scale1 = pt.FireworkCurve.uneven_samples([(0.0, 0.5), (0.5, 1.5), (1.0, 0.25)])
    base1 = pt.gradient_uneven_samples([(t, (t, 1.0 - t, 0.5, 1.0)) for t in ts1])
    emis1 = pt.gradient_uneven_samples([(t, (0.2, t, 0.3 * t, 0.5)) for t in ts1])
    return pt.ParticleSpawner(particle_settings=[box_type(0, scale0, base0, emis0), box_type(1, scale1, base1, emis1)],
                              emission_settings=[box_emitter(rate), box_emitter(0.5 * rate, (0.8, 0.4, 0.8), 1)])


def mixed_pacing_spawner(n_emitters, rate=1e4):
    """`n_emitters` box emitters of one type, their pacing by index mod 4:
    a rate, a one-shot burst, on demand (the first gated one takes the
    queue), and a count over a duration with offsets; the step kernel's
    warp runs up to 32 emitters' cadence on its lanes, more in lane 0."""
    def pacing(e):
        return (pt.EmissionPacing.rate(rate + 500.0 * e), pt.EmissionPacing.one_shot(200 + 10 * e),
                pt.EmissionPacing.on_demand(), pt.EmissionPacing.count_over_duration(40.0 + e, 0.5, 0.1, 0.9))[e % 4]

    emitters = [dataclasses.replace(box_emitter(1.0, (0.5 + 0.02 * e, 0.3, 1.0)), emission_pacing=pacing(e))
                for e in range(n_emitters)]
    return pt.ParticleSpawner(particle_settings=[box_type(0)], emission_settings=emitters)
