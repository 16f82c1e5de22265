"""Generic effect families beyond the reference's example scenes (port of
`bevy_firework_tpu.models.library`, the same authoring with the port's
types).

Where `effects.py` reproduces the reference's scenes, this module is a small
library of reusable effect archetypes built from the same primitives. Every
constructor returns a ready `ParticleSpawner`; all parameters are plain
floats so callers can tweak without touching curve/gradient plumbing.
"""

from __future__ import annotations

import math

from ..curve import FireworkCurve, gradient_constant, gradient_uneven_samples
from ..emission_shape import EmissionShape
from ..rand import RandF32, RandVec3
from ..settings import (
    BlendMode,
    EmissionPacing,
    EmissionSettings,
    ParticleCollisionSettings,
    ParticleSettings,
    ParticleSpawner,
)

PI = math.pi


def fountain(rate=500.0, speed=6.0, spread_deg=20.0, lifetime=1.5, color=(4.0, 2.5, 0.8, 1.0)):
    """Classic upward particle fountain with gravity and fade-out."""
    return ParticleSpawner(
        particle_settings=[
            ParticleSettings(
                lifetime=RandF32.constant(lifetime),
                initial_scale=RandF32(0.03, 0.08),
                base_color=gradient_uneven_samples([(0.0, color), (0.8, color), (1.0, (*color[:3], 0.0))]),
                linear_drag=0.1,
            )
        ],
        emission_settings=[
            EmissionSettings(
                emission_pacing=EmissionPacing.rate(rate),
                emission_shape=EmissionShape.circle((0, 1, 0), 0.15),
                initial_velocity=RandVec3(RandF32(speed * 0.7, speed), (0, 1, 0), spread_deg / 180.0 * PI),
            )
        ],
    )


def rain(rate=2000.0, area=10.0, fall_speed=9.0):
    """Downward streaks over a square area; particles die on the ground plane
    (destroy-on-collision against a halfspace the caller adds to the scene)."""
    return ParticleSpawner(
        particle_settings=[
            ParticleSettings(
                lifetime=RandF32.constant(3.0),
                initial_scale=RandF32(0.01, 0.02),
                acceleration=(0.0, -2.0, 0.0),
                linear_drag=0.0,
                base_color=gradient_constant((0.5, 0.6, 0.8, 0.6)),
                collision_settings=ParticleCollisionSettings(destroy_on_collision=True),
            )
        ],
        emission_settings=[
            EmissionSettings(
                emission_pacing=EmissionPacing.rate(rate),
                emission_shape=EmissionShape.circle((0, 1, 0), area / 2.0),
                initial_velocity=RandVec3(RandF32(fall_speed * 0.9, fall_speed * 1.1), (0, -1, 0), 0.03),
                inherit_parent_velocity=False,
            )
        ],
    )


def snow(rate=400.0, area=10.0):
    """Slow tumbling flakes with high drag and gentle drift."""
    return ParticleSpawner(
        particle_settings=[
            ParticleSettings(
                lifetime=RandF32(6.0, 10.0),
                initial_scale=RandF32(0.02, 0.05),
                acceleration=(0.15, -0.6, 0.05),
                linear_drag=0.8,
                angular_drag=0.1,
                base_color=gradient_uneven_samples(
                    [(0.0, (0.9, 0.9, 1.0, 0.0)), (0.1, (0.9, 0.9, 1.0, 0.9)), (1.0, (0.9, 0.9, 1.0, 0.0))]
                ),
            )
        ],
        emission_settings=[
            EmissionSettings(
                emission_pacing=EmissionPacing.rate(rate),
                emission_shape=EmissionShape.circle((0, 1, 0), area / 2.0),
                initial_velocity=RandVec3(RandF32(0.2, 0.8), (0, -1, 0), 0.4),
                initial_angular_velocity=RandVec3(RandF32(1.0, 4.0), (0, 1, 0), PI),
                inherit_parent_velocity=False,
            )
        ],
    )


def explosion(count=300, speed=12.0, lifetime=0.8):
    """One-shot radial burst: sphere shell emission with radial velocity,
    hot-to-smoke gradient, rapid scale-out."""
    return ParticleSpawner(
        particle_settings=[
            ParticleSettings(
                lifetime=RandF32(lifetime * 0.6, lifetime),
                initial_scale=RandF32(0.05, 0.15),
                scale_curve=FireworkCurve.uneven_samples([(0.0, 1.0), (0.3, 2.5), (1.0, 3.5)]),
                acceleration=(0.0, 1.0, 0.0),
                linear_drag=2.5,
                base_color=gradient_uneven_samples(
                    [
                        (0.0, (30.0, 18.0, 4.0, 1.0)),
                        (0.25, (6.0, 2.0, 0.5, 0.9)),
                        (0.6, (0.4, 0.35, 0.3, 0.5)),
                        (1.0, (0.2, 0.2, 0.2, 0.0)),
                    ]
                ),
                blend_mode=BlendMode.BLEND,
            )
        ],
        emission_settings=[
            EmissionSettings(
                emission_pacing=EmissionPacing.one_shot(count),
                emission_shape=EmissionShape.sphere(0.3),
                initial_velocity_radial=RandF32(speed * 0.3, speed),
                initial_velocity=RandVec3.constant((0, 0, 0)),
            )
        ],
    )


def magic_trail(rate=300.0):
    """Additive sparkle trail meant to be attached to a moving emitter
    (inherit_parent_velocity + set_parent_velocity)."""
    return ParticleSpawner(
        particle_settings=[
            ParticleSettings(
                lifetime=RandF32(0.4, 0.9),
                initial_scale=RandF32(0.01, 0.04),
                acceleration=(0.0, 0.5, 0.0),
                linear_drag=1.5,
                scale_curve=FireworkCurve.uneven_samples([(0.0, 1.0), (1.0, 0.0)]),
                base_color=gradient_uneven_samples(
                    [(0.0, (2.0, 4.0, 12.0, 1.0)), (0.6, (6.0, 2.0, 10.0, 1.0)), (1.0, (0.5, 0.2, 1.0, 0.0))]
                ),
                blend_mode=BlendMode.ADD,
            )
        ],
        emission_settings=[
            EmissionSettings(
                emission_pacing=EmissionPacing.rate(rate),
                emission_shape=EmissionShape.sphere(0.08),
                initial_velocity=RandVec3(RandF32(0.0, 0.4), (0, 1, 0), PI),
                inherit_parent_velocity=True,
            )
        ],
    )


def smoke_plume(rate=60.0):
    """Rising, expanding smoke column (buoyant, high drag, PBR-lit)."""
    return ParticleSpawner(
        particle_settings=[
            ParticleSettings(
                lifetime=RandF32(2.5, 4.0),
                initial_scale=RandF32(0.3, 0.6),
                scale_curve=FireworkCurve.even_samples([1.0, 2.2, 3.0]),
                acceleration=(0.1, 0.8, 0.0),
                linear_drag=0.9,
                base_color=gradient_uneven_samples(
                    [(0.0, (0.25, 0.24, 0.22, 0.0)), (0.15, (0.25, 0.24, 0.22, 0.45)), (1.0, (0.3, 0.3, 0.3, 0.0))]
                ),
                fade_scene=3.0,
                pbr=True,
            )
        ],
        emission_settings=[
            EmissionSettings(
                emission_pacing=EmissionPacing.rate(rate),
                emission_shape=EmissionShape.circle((0, 1, 0), 0.3),
                initial_velocity=RandVec3(RandF32(0.5, 1.2), (0, 1, 0), 0.25),
                initial_angular_velocity=RandVec3(RandF32(0.2, 0.8), (0, 0, 1), 0.0),
            )
        ],
    )


def comets(rate=6.0, speed=7.5, lifetime=2.5):
    """Bright arcing heads designed for ribbon trails: pair with
    `Scene.add_spawner(..., trail=TrailSettings(length=16, width=0.8))`
    (trails.py — a capability beyond the reference's feature set). Additive
    blend so overlapping trails sum instead of occluding."""
    color = gradient_uneven_samples(
        [
            (0.0, (6.0, 4.5, 1.8, 1.0)),
            (0.7, (3.0, 1.2, 0.6, 1.0)),
            (1.0, (0.3, 0.1, 0.05, 0.0)),
        ]
    )
    return ParticleSpawner(
        particle_settings=[
            ParticleSettings(
                lifetime=RandF32.constant(lifetime),
                initial_scale=RandF32(0.08, 0.14),
                acceleration=(0.0, -4.0, 0.0),
                linear_drag=0.05,
                base_color=color,
                blend_mode=BlendMode.ADD,
            )
        ],
        emission_settings=[
            EmissionSettings(
                emission_pacing=EmissionPacing.rate(rate),
                emission_shape=EmissionShape.circle((0, 1, 0), 0.4),
                initial_velocity=RandVec3(RandF32(speed * 0.8, speed), (0, 1, 0), 0.55),
            )
        ],
    )


def dust(rate=900.0, lifetime=4.0, updraft=0.0, drag=1.2, emit_radius=3.0):
    """Ambient dust motes — pair with scene force fields (e.g. a tornado:
    vortex + axial + `updraft`, `examples/force_fields.py`). High drag so
    the field's acceleration sets the steady-state velocity."""
    return ParticleSpawner(
        particle_settings=[
            ParticleSettings(
                lifetime=RandF32(lifetime * 0.7, lifetime),
                initial_scale=RandF32(0.02, 0.06),
                acceleration=(0.0, float(updraft), 0.0),
                linear_drag=float(drag),
                base_color=gradient_uneven_samples(
                    [(0.0, (2.0, 1.7, 1.2, 0.0)), (0.15, (2.0, 1.7, 1.2, 0.8)),
                     (1.0, (1.2, 1.0, 0.8, 0.0))]
                ),
                blend_mode=BlendMode.ADD,
            )
        ],
        emission_settings=[
            EmissionSettings(
                emission_pacing=EmissionPacing.rate(rate),
                emission_shape=EmissionShape.circle((0, 1, 0), float(emit_radius)),
                initial_velocity=RandVec3(RandF32(0.2, 1.0), (0, 1, 0), 0.4),
            )
        ],
    )
