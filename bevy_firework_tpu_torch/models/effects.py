"""Prebuilt effect models: the reference examples (sparks, stress_test,
on_demand, pbr, one_shot and its walls, collision, stress_test_collision,
the nested textures scene) and the fireworks showcase, as data. Each
returns the `ParticleSpawner` config and the spawner transform (and the
scene's colliders, for the collision scenes), exactly as
`bevy_firework_tpu.models.effects` does, so both packages build the same
spawners.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

from ..colliders import Collider
from ..curve import FireworkCurve, gradient_constant, gradient_uneven_samples
from ..emission_shape import EmissionShape
from ..rand import RandF32, RandVec3
from ..scene import Transform
from ..settings import (
    BlendMode,
    EmissionMode,
    EmissionPacing,
    EmissionSettings,
    ParticleCollisionSettings,
    ParticleSettings,
    ParticleSpawner,
    SpawnTransformMode,
)
from ..utils.quat import np_quat_from_rotation_arc, np_quat_mul

PI = math.pi

# The 5-keyframe HDR ember gradient shared by sparks/stress/on_demand scenes
# (only the t=0 color differs), `examples/sparks.rs:57-63`.


def _ember_gradient(c0: Tuple[float, float, float, float]):
    return gradient_uneven_samples(
        [
            (0.0, c0),
            (0.7, (3.0, 1.0, 1.0, 1.0)),
            (0.8, (1.0, 0.3, 0.3, 1.0)),
            (0.9, (0.3, 0.3, 0.3, 1.0)),
            (1.0, (0.1, 0.1, 0.1, 0.0)),
        ]
    )


def _cone_up(lo, hi, spread):
    return RandVec3(magnitude=RandF32(lo, hi), direction=(0.0, 1.0, 0.0), spread=spread)


def sparks(rate: float = 1000.0) -> Tuple[ParticleSpawner, Transform]:
    """`examples/sparks.rs:49-87`: continuous ember fountain, ~750 live."""
    spawner = ParticleSpawner(
        particle_settings=[
            ParticleSettings(
                lifetime=RandF32.constant(0.75),
                initial_scale=RandF32(0.02, 0.08),
                scale_curve=FireworkCurve.constant(1.0),
                base_color=_ember_gradient((150.0, 100.0, 15.0, 1.0)),
                blend_mode=BlendMode.BLEND,
                linear_drag=0.1,
                pbr=False,
            )
        ],
        emission_settings=[
            EmissionSettings(
                emission_pacing=EmissionPacing.rate(rate),
                emission_shape=EmissionShape.circle((0, 1, 0), 0.3),
                inherit_parent_velocity=True,
                initial_velocity=_cone_up(0.0, 10.0, 30.0 / 180.0 * PI),
            )
        ],
    )
    return spawner, Transform(translation=(0.0, 0.1, 0.0))


def stress_test() -> Tuple[ParticleSpawner, Transform]:
    """`examples/stress_test.rs:91-129`: sparks at rate 160k, lifetime 1 s
    => ~160 k live steady state. The headline benchmark scene."""
    spawner, tf = sparks(rate=160000.0)
    ps = spawner.particle_settings[0]
    ps = dataclasses.replace(
        ps, lifetime=RandF32.constant(1.0), base_color=_ember_gradient((10.0, 7.0, 1.0, 1.0))
    )
    return ParticleSpawner(
        particle_settings=(ps,),
        emission_settings=spawner.emission_settings,
    ), tf


def on_demand() -> Tuple[ParticleSpawner, Transform]:
    """`examples/on_demand.rs:57-96`: sparks-style burst per click via
    `queue_particles`."""
    spawner, tf = sparks()
    es = spawner.emission_settings[0]
    es = dataclasses.replace(es, emission_pacing=EmissionPacing.on_demand())
    ps = spawner.particle_settings[0]
    ps = dataclasses.replace(ps, lifetime=RandF32.constant(0.75))
    return ParticleSpawner(particle_settings=(ps,), emission_settings=(es,)), tf


def pbr() -> Tuple[ParticleSpawner, Transform]:
    """`examples/pbr.rs:49-84`: buoyant PBR smoke, rate 150, lifetime 5 s."""
    spawner = ParticleSpawner(
        particle_settings=[
            ParticleSettings(
                lifetime=RandF32.constant(5.0),
                scale_curve=FireworkCurve.even_samples([1.0, 2.0]),
                initial_scale=RandF32(0.5, 1.3),
                acceleration=(0.0, 0.3, 0.0),
                linear_drag=0.7,
                base_color=gradient_uneven_samples(
                    [(0.0, (0.6, 0.3, 0.0, 0.0)), (0.1, (0.6, 0.3, 0.0, 0.35)), (1.0, (0.6, 0.3, 0.0, 0.0))]
                ),
                emissive_color=gradient_constant((0, 0, 0, 1)),
                fade_scene=3.5,
                blend_mode=BlendMode.BLEND,
                pbr=True,
            )
        ],
        emission_settings=[
            EmissionSettings(
                emission_pacing=EmissionPacing.rate(150.0),
                emission_shape=EmissionShape.circle((0, 1, 0), 3.5),
                initial_velocity=RandVec3.constant((0, 0, 0)),
                initial_velocity_radial=RandF32.constant(0.0),
                inherit_parent_velocity=True,
            )
        ],
    )
    return spawner, Transform(translation=(0.0, 0.1, 0.0))


def one_shot(impulse: float = 5.0) -> Tuple[ParticleSpawner, Transform]:
    """`examples/one_shot.rs:92-136`: impact burst of 20, impulse-scaled
    size, local spawn transform, finished-despawn pattern."""
    spawner = ParticleSpawner(
        particle_settings=[
            ParticleSettings(
                lifetime=RandF32.constant(2.5),
                initial_scale=RandF32(max(impulse / 10.0 - 0.1, 0.0), min(impulse / 10.0 + 0.1, 1.0)),
                scale_curve=FireworkCurve.even_samples([1.0, 2.0]),
                base_color=gradient_uneven_samples(
                    [(0.0, (0.6, 0.3, 0.0, 0.0)), (0.1, (0.6, 0.3, 0.0, 0.35)), (1.0, (0.6, 0.3, 0.0, 0.0))]
                ),
                blend_mode=BlendMode.BLEND,
                linear_drag=0.7,
                pbr=True,
                acceleration=(0.0, -1.5, 0.0),
                fade_scene=3.5,
            )
        ],
        emission_settings=[
            EmissionSettings(
                emission_pacing=EmissionPacing.one_shot(20),
                emission_shape=EmissionShape.circle((0, 1, 0), 0.4),
                inherit_parent_velocity=True,
                initial_velocity=RandVec3(magnitude=RandF32(0.0, 2.0), direction=(0, 1, 0), spread=0.0),
                initial_velocity_radial=RandF32(0.0, 2.5),
            )
        ],
        spawn_transform_mode=SpawnTransformMode.LOCAL,
    )
    return spawner, Transform()


def collision() -> Tuple[ParticleSpawner, Transform, List[Collider]]:
    """`examples/collision.rs:51-100`: tilted ember fountain bouncing off a
    cuboid base (avian cuboid(8,1,8) = half extents (4,.5,4))."""
    rot_z45 = (0.0, 0.0, math.sin(PI / 8), math.cos(PI / 8))  # Quat::from_rotation_z(PI/4)
    spawner = ParticleSpawner(
        particle_settings=[
            ParticleSettings(
                lifetime=RandF32.constant(6.75),
                scale_curve=FireworkCurve.uneven_samples([(0.0, 1.0), (0.8, 1.0), (1.0, 0.0)]),
                initial_scale=RandF32(0.02, 0.08),
                linear_drag=0.15,
                base_color=gradient_constant((0.1, 0.1, 0.1, 1.0)),
                emissive_color=gradient_uneven_samples(
                    [
                        (0.0, (30.0, 21.0, 1.0, 1.0)),
                        (0.7, (3.0, 1.0, 1.0, 1.0)),
                        (0.75, (1.0, 0.3, 0.3, 1.0)),
                        (0.8, (0.0, 0.0, 0.0, 1.0)),
                    ]
                ),
                blend_mode=BlendMode.BLEND,
                pbr=True,
                collision_settings=ParticleCollisionSettings(restitution=0.6, friction=0.2, destroy_on_collision=False),
            )
        ],
        emission_settings=[
            EmissionSettings(
                emission_pacing=EmissionPacing.rate(100.0),
                emission_shape=EmissionShape.circle((0, 1, 0), 0.3),
                initial_velocity=_cone_up(6.0, 8.0, 30.0 / 180.0 * PI),
                inherit_parent_velocity=True,
            )
        ],
    )
    colliders = [Collider.cuboid((4.0, 0.5, 4.0), position=(0.0, -0.5, 0.0))]
    return spawner, Transform(translation=(5.0, 0.5, 0.0), rotation=rot_z45), colliders


def stress_test_collision() -> Tuple[ParticleSpawner, Transform, List[Collider]]:
    """`examples/stress_test_collision.rs:91-151`: rate 80k with collision
    against a cuboid floor + an angled unit cube. ~160 k live."""
    spawner, tf, _ = collision()
    ps = spawner.particle_settings[0]
    ps = dataclasses.replace(
        ps,
        lifetime=RandF32.constant(2.0),
        scale_curve=FireworkCurve.constant(1.0),
        base_color=_ember_gradient((100.0, 70.0, 10.0, 1.0)),
        emissive_color=gradient_constant((0, 0, 0, 1)),
        pbr=False,
    )
    es = spawner.emission_settings[0]
    es = dataclasses.replace(es, emission_pacing=EmissionPacing.rate(80000.0))
    # angled cube: rot_x(45) * rot_y(45)
    qx = np.array([math.sin(PI / 8), 0, 0, math.cos(PI / 8)], dtype=np.float32)
    qy = np.array([0, math.sin(PI / 8), 0, math.cos(PI / 8)], dtype=np.float32)
    q = np_quat_mul(qx, qy)
    colliders = [
        Collider.cuboid((4.0, 0.5, 4.0), position=(0.0, -0.5, 0.0)),
        Collider.cuboid((0.5, 0.5, 0.5), position=(0.0, 0.5, 0.0), rotation=tuple(float(v) for v in q)),
    ]
    return ParticleSpawner(particle_settings=(ps,), emission_settings=(es,)), tf, colliders


def textures() -> Tuple[ParticleSpawner, Transform, List[Collider]]:
    """`examples/textures.rs:52-225`: textured PBR shell casings (type 0,
    12/s, spinning, colliding with a cylinder base + cone) spawning nested
    smoke puffs (type 1, 6 per parent in the first 10% of parent life)."""
    shell = ParticleSettings(
        lifetime=RandF32.constant(5.0),
        scale_curve=FireworkCurve.constant(1.0),
        initial_scale=RandF32.constant(0.3),
        linear_drag=0.3,
        angular_drag=0.85,
        base_color=gradient_uneven_samples(
            [(0.0, (1, 1, 1, 1)), (0.9, (1, 1, 1, 1)), (1.0, (1, 1, 1, 0))]
        ),
        base_color_texture="textures/bullet_case/diffuse.png",
        normal_map_texture="textures/bullet_case/normal.png",
        orm_texture="textures/bullet_case/orm.png",
        emissive_color=gradient_constant((0, 0, 0, 1)),
        fade_scene=0.0,
        fade_edge=0.0,
        blend_mode=BlendMode.BLEND,
        pbr=True,
        collision_settings=ParticleCollisionSettings(restitution=0.4, friction=0.35, destroy_on_collision=False),
    )
    smoke = ParticleSettings(
        lifetime=RandF32.constant(2.0),
        scale_curve=FireworkCurve.even_samples([1.0, 2.0]),
        initial_scale=RandF32(0.5, 0.8),
        acceleration=(0.0, 0.3, 0.0),
        linear_drag=0.7,
        base_color=gradient_uneven_samples(
            [(0.0, (0.1, 0.1, 0.1, 0.0)), (0.1, (0.1, 0.1, 0.1, 0.15)), (1.0, (0.1, 0.1, 0.1, 0.0))]
        ),
        emissive_color=gradient_constant((0, 0, 0, 1)),
        fade_scene=3.5,
        blend_mode=BlendMode.BLEND,
        pbr=True,
    )
    rot_y90 = (0.0, math.sin(PI / 4), 0.0, math.cos(PI / 4))
    shell_emitter = EmissionSettings(
        particle_index=0,
        emission_mode=EmissionMode.global_(),
        emission_pacing=EmissionPacing.rate(12.0),
        emission_shape=EmissionShape.point(),
        initial_velocity=RandVec3(magnitude=RandF32(2.0, 5.0), direction=(0, 1, 0), spread=0.4),
        initial_velocity_radial=RandF32.constant(0.0),
        inherit_parent_velocity=True,
        initial_rotation=rot_y90,
        initial_angular_velocity=RandVec3(magnitude=RandF32(5.0, 15.0), direction=(0, -1, 0), spread=0.0),
    )
    smoke_emitter = EmissionSettings(
        particle_index=1,
        emission_mode=EmissionMode.nested(0),
        emission_pacing=EmissionPacing.count_over_duration(6.0, 0.0, 0.0, 0.1),
        emission_shape=EmissionShape.point(),
        initial_velocity=RandVec3.constant((0, 0, 0)),
        inherit_parent_velocity=False,
    )
    spawner = ParticleSpawner(
        particle_settings=(shell, smoke),
        emission_settings=(shell_emitter, smoke_emitter),
        spawn_transform_mode=SpawnTransformMode.LOCAL,
    )
    # cannon orientation: rotation_arc(Y -> X)
    q = np_quat_from_rotation_arc(np.array([0, 1, 0], np.float32), np.array([1, 0, 0], np.float32))
    tf = Transform(translation=(-2.0, 2.0, 0.0), rotation=tuple(float(v) for v in q))
    colliders = [
        Collider.cylinder(4.0, 0.1, position=(0.0, 0.0, 0.0)),  # avian cylinder(4, 0.2)
        Collider.cone(0.5, 0.5, position=(0.0, 0.5, 0.0)),  # avian cone(0.5, 1.)
    ]
    return spawner, tf, colliders


def one_shot_walls() -> List[Collider]:
    """The one_shot scene's box room (`examples/one_shot.rs:52-58`): base +
    4 walls, avian cuboids given as full extents."""
    def wall(pos, size):
        return Collider.cuboid(tuple(s / 2 for s in size), position=pos)

    return [
        wall((0.0, -3.0, 0.0), (8.0, 1.0, 8.0)),
        wall((-4.0, 0.0, 0.0), (1.0, 6.0, 8.0)),
        wall((4.0, 0.0, 0.0), (1.0, 6.0, 8.0)),
        wall((0.0, 0.0, -4.0), (8.0, 6.0, 1.0)),
        wall((0.0, 0.0, 4.0), (8.0, 6.0, 1.0)),
    ]


def fireworks() -> Tuple[ParticleSpawner, Transform]:
    """Showcase (no reference counterpart): a real two-stage firework using
    the same primitives the reference exposes. Type 0 rockets rise with low
    drag; a nested emitter with an END-of-life window (offset 0.85..1.0)
    bursts ~80 sparkles from each rocket at its apex — nested emission as a
    timed secondary explosion rather than a continuous trail."""
    rocket = ParticleSettings(
        lifetime=RandF32(1.1, 1.5),
        initial_scale=RandF32.constant(0.06),
        acceleration=(0.0, 2.0, 0.0),  # thrust overcoming gravity is pre-applied in initial velocity
        linear_drag=0.4,
        base_color=gradient_uneven_samples(
            [(0.0, (8.0, 6.0, 3.0, 1.0)), (0.9, (4.0, 2.0, 1.0, 1.0)), (1.0, (0.0, 0.0, 0.0, 0.0))]
        ),
        blend_mode=BlendMode.BLEND,
    )
    sparkle = ParticleSettings(
        lifetime=RandF32(0.6, 1.2),
        initial_scale=RandF32(0.02, 0.05),
        acceleration=(0.0, -4.0, 0.0),
        linear_drag=0.9,
        scale_curve=FireworkCurve.uneven_samples([(0.0, 1.0), (0.8, 0.8), (1.0, 0.0)]),
        base_color=gradient_uneven_samples(
            [
                (0.0, (20.0, 14.0, 4.0, 1.0)),
                (0.5, (6.0, 1.5, 4.0, 1.0)),
                (0.8, (1.0, 0.3, 1.2, 1.0)),
                (1.0, (0.1, 0.05, 0.1, 0.0)),
            ]
        ),
        blend_mode=BlendMode.BLEND,
    )
    launcher = EmissionSettings(
        particle_index=0,
        emission_pacing=EmissionPacing.rate(3.0),
        emission_shape=EmissionShape.circle((0, 1, 0), 1.5),
        initial_velocity=RandVec3(magnitude=RandF32(7.0, 9.5), direction=(0, 1, 0), spread=0.12),
        inherit_parent_velocity=False,
    )
    burst = EmissionSettings(
        particle_index=1,
        emission_mode=EmissionMode.nested(0),
        # all 80 sparkles in the last 15% of the rocket's life = apex burst
        emission_pacing=EmissionPacing.count_over_duration(80.0, 0.0, 0.85, 1.0),
        emission_shape=EmissionShape.sphere(0.05),
        initial_velocity=RandVec3(magnitude=RandF32(0.0, 4.5), direction=(0, 1, 0), spread=PI),
        initial_velocity_radial=RandF32(0.5, 3.0),
        inherit_parent_velocity=False,
    )
    spawner = ParticleSpawner(
        particle_settings=(rocket, sparkle),
        emission_settings=(launcher, burst),
    )
    return spawner, Transform(translation=(0.0, 0.0, 0.0))
