"""Host-side physics/scene-graph sync helpers (SURVEY.md #12, #13).

The reference pulls these from the ECS every frame:
  * `sync_parent_velocity` (bevy_firework `src/core.rs:705-742`): a spawner
    parented under a rigid body inherits the body's world-space velocity at
    the spawner's position, v = v_lin + omega x (p - center_of_mass).
  * `propagate_particle_spawner_modifier` (`core.rs:690-703`): an
    `EffectModifier` on an ancestor is copied onto every descendant spawner.

This engine has no ECS; the equivalents are explicit: describe the rigid
bodies / hierarchy you have, call the helpers once per frame before
`scene.step(dt)`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

import numpy as np

from .settings import EffectModifier

Vec3 = Tuple[float, float, float]


def linear_velocity_at_point(linvel, angvel, point, center_of_mass) -> np.ndarray:
    """World-space velocity of a rigid body at `point`
    (`core.rs:738-742`): v = v_lin + omega x (point - com)."""
    linvel = np.asarray(linvel, np.float32)
    angvel = np.asarray(angvel, np.float32)
    point = np.asarray(point, np.float32)
    com = np.asarray(center_of_mass, np.float32)
    return (linvel + np.cross(angvel, point - com)).astype(np.float32)


@dataclasses.dataclass
class RigidBodyState:
    """Minimal rigid-body description (the avian LinearVelocity /
    AngularVelocity / CenterOfMass triple)."""

    linear_velocity: Vec3 = (0.0, 0.0, 0.0)
    angular_velocity: Vec3 = (0.0, 0.0, 0.0)
    center_of_mass: Vec3 = (0.0, 0.0, 0.0)  # world space


def sync_parent_velocity(scene, attachments: Dict[int, RigidBodyState]):
    """For each (spawner id -> parent body), set the spawner's inherited
    parent velocity from the body's motion at the spawner's world position."""
    for sid, body in attachments.items():
        slot = scene._spawners[sid]
        v = linear_velocity_at_point(
            body.linear_velocity,
            body.angular_velocity,
            slot.global_transform.translation,
            body.center_of_mass,
        )
        scene.set_parent_velocity(sid, tuple(float(x) for x in v))


def propagate_modifiers(scene, modifier: EffectModifier, spawner_ids: Iterable[int]):
    """Copy one ancestor's EffectModifier onto all descendant spawners
    (`core.rs:690-703`: the reference walks the entity hierarchy; here the
    caller names the descendants)."""
    for sid in spawner_ids:
        scene.set_modifier(sid, modifier)
