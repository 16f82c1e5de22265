"""Authoring/config model — the public data API.

The same frozen dataclasses as `bevy_firework_tpu.settings` (field names,
defaults and JSON layout are identical, so spawner JSON written by either
package loads in the other). Equivalents of the reference's settings types in
`bevy_firework src/core.rs:11-338`, with identical field names, defaults
(Appendix B of SURVEY.md) and JSON round-trip (the reference types are all
serde `Serialize + Deserialize`, so spawner definitions can live in scene
files; same here via to_dict/from_dict).

These types are *authoring only*: `compiled.py` lowers a `ParticleSpawner`
into a hashable structure key + per-emitter parameter tensors.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Callable, Optional, Tuple

from .curve import FireworkCurve, FireworkGradient
from .emission_shape import EmissionShape
from .rand import RandF32, RandVec3

Vec3 = Tuple[float, float, float]
Quat = Tuple[float, float, float, float]  # xyzw

WHITE = (1.0, 1.0, 1.0, 1.0)
BLACK = (0.0, 0.0, 0.0, 1.0)  # bevy LinearRgba::BLACK has alpha 1
GRAVITY = (0.0, -9.81, 0.0)
QUAT_IDENTITY = (0.0, 0.0, 0.0, 1.0)


class BlendMode(enum.Enum):
    """Mirrors the reference BlendMode (`bevy_firework src/core.rs:57-64`);
    the u32 values in `as_u32` are the shader-side alpha_mode codes
    (`bevy_firework src/core.rs:87-97`)."""

    OPAQUE = "opaque"
    BLEND = "blend"
    PREMULTIPLIED = "premultiplied"
    ADD = "add"
    MULTIPLY = "multiply"

    def as_u32(self) -> int:
        return {
            BlendMode.OPAQUE: 0,
            BlendMode.BLEND: 2,
            BlendMode.PREMULTIPLIED: 3,
            BlendMode.ADD: 4,
            BlendMode.MULTIPLY: 5,
        }[self]


class SpawnTransformMode(enum.Enum):
    """Global => spawn origin from the world transform; Local => from the
    local transform (`bevy_firework src/core.rs:66-73`)."""

    GLOBAL = "global"
    LOCAL = "local"


class EmissionPacingKind(enum.Enum):
    ONE_SHOT = "one_shot"
    ON_DEMAND = "on_demand"
    COUNT_OVER_DURATION = "count_over_duration"


@dataclasses.dataclass(frozen=True)
class EmissionPacing:
    """`bevy_firework src/core.rs:11-44`."""

    kind: EmissionPacingKind
    count: float = 0.0
    duration: float = 1.0
    offset_start: float = 0.0
    offset_end: float = 1.0

    @staticmethod
    def one_shot(count: int) -> "EmissionPacing":
        return EmissionPacing(EmissionPacingKind.ONE_SHOT, count=float(count))

    @staticmethod
    def on_demand() -> "EmissionPacing":
        return EmissionPacing(EmissionPacingKind.ON_DEMAND)

    @staticmethod
    def count_over_duration(count: float, duration: float, offset_start: float = 0.0, offset_end: float = 1.0) -> "EmissionPacing":
        return EmissionPacing(EmissionPacingKind.COUNT_OVER_DURATION, float(count), float(duration), float(offset_start), float(offset_end))

    @staticmethod
    def rate(rate: float) -> "EmissionPacing":
        """count=rate over duration 1s, full-cycle window (`core.rs:36-43`)."""
        return EmissionPacing.count_over_duration(float(rate), 1.0, 0.0, 1.0)

    def is_one_shot(self) -> bool:
        return self.kind == EmissionPacingKind.ONE_SHOT


class EmissionModeKind(enum.Enum):
    GLOBAL = "global"
    NESTED = "nested"


@dataclasses.dataclass(frozen=True)
class EmissionMode:
    """Global, or Nested{target_particle_type} — sub-particles spawned from
    live parents of the target type (`bevy_firework src/core.rs:46-54`)."""

    kind: EmissionModeKind = EmissionModeKind.GLOBAL
    target_particle_type: int = 0

    @staticmethod
    def global_() -> "EmissionMode":
        return EmissionMode(EmissionModeKind.GLOBAL)

    @staticmethod
    def nested(target_particle_type: int) -> "EmissionMode":
        return EmissionMode(EmissionModeKind.NESTED, int(target_particle_type))


@dataclasses.dataclass(frozen=True)
class ParticleCollisionSettings:
    """`bevy_firework src/core.rs:240-248`. The avian `SpatialQueryFilter`
    becomes a 32-bit layer mask tested against each collider's `layers`."""

    restitution: float = 0.0
    friction: float = 0.0
    destroy_on_collision: bool = False
    filter_mask: int = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class ParticleEventHandlers:
    """`bevy_firework src/core.rs:164-167`: optional callback receiving the
    full records of particles destroyed this frame. Host-side; enabling it
    turns on the device->host destroyed-particle dump (SURVEY.md hard part 7).
    """

    particles_destroyed: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class ParticleSettings:
    """Per-particle-type settings (`bevy_firework src/core.rs:99-142`),
    defaults from `core.rs:187-211`."""

    lifetime: RandF32 = RandF32.constant(5.0)
    scale_curve: FireworkCurve = FireworkCurve.constant(1.0)
    initial_scale: RandF32 = RandF32.constant(1.0)
    acceleration: Vec3 = GRAVITY
    angular_acceleration: Vec3 = (0.0, 0.0, 0.0)
    linear_drag: float = 0.2
    angular_drag: float = 0.2
    base_color: FireworkGradient = FireworkGradient.constant(WHITE)
    base_color_texture: Optional[str] = None
    emissive_color: FireworkGradient = FireworkGradient.constant(BLACK)
    normal_map_texture: Optional[str] = None
    orm_texture: Optional[str] = None
    fade_edge: float = 0.7
    fade_scene: float = 1.0
    blend_mode: BlendMode = BlendMode.BLEND
    pbr: bool = False
    collision_settings: Optional[ParticleCollisionSettings] = None
    # scene force fields apply to this type (beyond the reference; lets a
    # smoke layer ignore a vortex the sparks ride, etc.)
    affected_by_fields: bool = True
    event_handlers: ParticleEventHandlers = ParticleEventHandlers()


@dataclasses.dataclass(frozen=True)
class EmissionSettings:
    """Per-emitter settings (`bevy_firework src/core.rs:144-162`), defaults
    from `core.rs:213-227` (note inherit_parent_velocity defaults to True)."""

    particle_index: int = 0
    emission_pacing: EmissionPacing = EmissionPacing.rate(5.0)
    emission_mode: EmissionMode = EmissionMode.global_()
    emission_shape: EmissionShape = EmissionShape.point()
    initial_velocity: RandVec3 = RandVec3.constant((0.0, 0.0, 0.0))
    initial_velocity_radial: RandF32 = RandF32.constant(0.0)
    inherit_parent_velocity: bool = True
    initial_rotation: Quat = QUAT_IDENTITY
    initial_angular_velocity: RandVec3 = RandVec3.constant((0.0, 0.0, 0.0))


@dataclasses.dataclass(frozen=True)
class ParticleSpawner:
    """The root authoring component (`bevy_firework src/core.rs:169-238`)."""

    particle_settings: Tuple[ParticleSettings, ...] = (ParticleSettings(),)
    emission_settings: Tuple[EmissionSettings, ...] = (EmissionSettings(),)
    starts_enabled: bool = True
    spawn_transform_mode: SpawnTransformMode = SpawnTransformMode.GLOBAL

    def __post_init__(self):
        object.__setattr__(self, "particle_settings", tuple(self.particle_settings))
        object.__setattr__(self, "emission_settings", tuple(self.emission_settings))
        if not self.particle_settings:
            raise ValueError("ParticleSpawner needs at least one ParticleSettings")
        for e in self.emission_settings:
            if e.particle_index >= len(self.particle_settings):
                raise ValueError("emission_settings.particle_index out of range")
            if e.emission_mode.kind == EmissionModeKind.NESTED and e.emission_mode.target_particle_type >= len(self.particle_settings):
                raise ValueError("nested target_particle_type out of range")


@dataclasses.dataclass(frozen=True)
class EffectModifier:
    """Uniform scale/speed multipliers propagated from ancestors
    (`bevy_firework src/core.rs:323-336`)."""

    scale: float = 1.0
    speed: float = 1.0


# ---------------------------------------------------------------------------
# Serde (JSON round-trip; mirrors the reference's serde support)
# ---------------------------------------------------------------------------


def _vec(v):
    return [float(x) for x in v]


def settings_to_dict(p: ParticleSettings) -> dict:
    return {
        "lifetime": p.lifetime.to_dict(),
        "scale_curve": p.scale_curve.to_dict(),
        "initial_scale": p.initial_scale.to_dict(),
        "acceleration": _vec(p.acceleration),
        "angular_acceleration": _vec(p.angular_acceleration),
        "linear_drag": p.linear_drag,
        "angular_drag": p.angular_drag,
        "base_color": p.base_color.to_dict(),
        "base_color_texture": p.base_color_texture,
        "emissive_color": p.emissive_color.to_dict(),
        "normal_map_texture": p.normal_map_texture,
        "orm_texture": p.orm_texture,
        "fade_edge": p.fade_edge,
        "fade_scene": p.fade_scene,
        "blend_mode": p.blend_mode.value,
        "pbr": p.pbr,
        "affected_by_fields": p.affected_by_fields,
        "collision_settings": None
        if p.collision_settings is None
        else {
            "restitution": p.collision_settings.restitution,
            "friction": p.collision_settings.friction,
            "destroy_on_collision": p.collision_settings.destroy_on_collision,
            "filter_mask": p.collision_settings.filter_mask,
        },
        # event_handlers intentionally not serialized (reference: #[reflect(ignore)],
        # `bevy_firework src/core.rs:140-141`)
    }


def settings_from_dict(d: dict) -> ParticleSettings:
    cs = d.get("collision_settings")
    return ParticleSettings(
        lifetime=RandF32.from_dict(d["lifetime"]),
        scale_curve=FireworkCurve.from_dict(d["scale_curve"]),
        initial_scale=RandF32.from_dict(d["initial_scale"]),
        acceleration=tuple(d["acceleration"]),
        angular_acceleration=tuple(d["angular_acceleration"]),
        linear_drag=float(d["linear_drag"]),
        angular_drag=float(d["angular_drag"]),
        base_color=FireworkGradient.from_dict(d["base_color"]),
        base_color_texture=d.get("base_color_texture"),
        emissive_color=FireworkGradient.from_dict(d["emissive_color"]),
        normal_map_texture=d.get("normal_map_texture"),
        orm_texture=d.get("orm_texture"),
        fade_edge=float(d["fade_edge"]),
        fade_scene=float(d["fade_scene"]),
        blend_mode=BlendMode(d["blend_mode"]),
        pbr=bool(d["pbr"]),
        affected_by_fields=bool(d.get("affected_by_fields", True)),
        collision_settings=None
        if cs is None
        else ParticleCollisionSettings(
            restitution=float(cs["restitution"]),
            friction=float(cs["friction"]),
            destroy_on_collision=bool(cs["destroy_on_collision"]),
            filter_mask=int(cs.get("filter_mask", 0xFFFFFFFF)),
        ),
    )


def emission_to_dict(e: EmissionSettings) -> dict:
    return {
        "particle_index": e.particle_index,
        "emission_pacing": {
            "kind": e.emission_pacing.kind.value,
            "count": e.emission_pacing.count,
            "duration": e.emission_pacing.duration,
            "offset_start": e.emission_pacing.offset_start,
            "offset_end": e.emission_pacing.offset_end,
        },
        "emission_mode": {
            "kind": e.emission_mode.kind.value,
            "target_particle_type": e.emission_mode.target_particle_type,
        },
        "emission_shape": e.emission_shape.to_dict(),
        "initial_velocity": e.initial_velocity.to_dict(),
        "initial_velocity_radial": e.initial_velocity_radial.to_dict(),
        "inherit_parent_velocity": e.inherit_parent_velocity,
        "initial_rotation": _vec(e.initial_rotation),
        "initial_angular_velocity": e.initial_angular_velocity.to_dict(),
    }


def emission_from_dict(d: dict) -> EmissionSettings:
    ep = d["emission_pacing"]
    em = d["emission_mode"]
    return EmissionSettings(
        particle_index=int(d["particle_index"]),
        emission_pacing=EmissionPacing(
            EmissionPacingKind(ep["kind"]),
            float(ep["count"]),
            float(ep["duration"]),
            float(ep["offset_start"]),
            float(ep["offset_end"]),
        ),
        emission_mode=EmissionMode(EmissionModeKind(em["kind"]), int(em["target_particle_type"])),
        emission_shape=EmissionShape.from_dict(d["emission_shape"]),
        initial_velocity=RandVec3.from_dict(d["initial_velocity"]),
        initial_velocity_radial=RandF32.from_dict(d["initial_velocity_radial"]),
        inherit_parent_velocity=bool(d["inherit_parent_velocity"]),
        initial_rotation=tuple(d["initial_rotation"]),
        initial_angular_velocity=RandVec3.from_dict(d["initial_angular_velocity"]),
    )


def spawner_to_dict(s: ParticleSpawner) -> dict:
    return {
        "particle_settings": [settings_to_dict(p) for p in s.particle_settings],
        "emission_settings": [emission_to_dict(e) for e in s.emission_settings],
        "starts_enabled": s.starts_enabled,
        "spawn_transform_mode": s.spawn_transform_mode.value,
    }


def spawner_from_dict(d: dict) -> ParticleSpawner:
    return ParticleSpawner(
        particle_settings=tuple(settings_from_dict(p) for p in d["particle_settings"]),
        emission_settings=tuple(emission_from_dict(e) for e in d["emission_settings"]),
        starts_enabled=bool(d["starts_enabled"]),
        spawn_transform_mode=SpawnTransformMode(d["spawn_transform_mode"]),
    )


def spawner_to_json(s: ParticleSpawner) -> str:
    return json.dumps(spawner_to_dict(s))


def spawner_from_json(j: str) -> ParticleSpawner:
    return spawner_from_dict(json.loads(j))
