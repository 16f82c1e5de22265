"""Prebuilt effect models of the slice: the reference examples whose
archetypes the fused step covers (sparks, stress_test, one_shot,
on_demand), as data. Each returns the `ParticleSpawner` config and the
spawner transform, exactly as `bevy_firework_tpu.models.effects` does, so
both packages build the same spawners. The collider and nested scenes wait
for their slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from ..curve import FireworkCurve, gradient_uneven_samples
from ..emission_shape import EmissionShape
from ..rand import RandF32, RandVec3
from ..scene import Transform
from ..settings import (
    BlendMode,
    EmissionPacing,
    EmissionSettings,
    ParticleSettings,
    ParticleSpawner,
    SpawnTransformMode,
)

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
