"""Lowering: `ParticleSpawner` authoring config -> step parameters.

As in `bevy_firework_tpu.compiled`, a spawner splits into
  * `SpawnerStatic`: hashable structure (type/emitter counts, pacing/mode
    kinds, which features are on). The plain step specialises Python code
    on it; the CUDA kernel reads the same facts from its table buffer.
  * `SpawnerParams`: tensors of per-type physics constants, padded curve
    tables and per-emitter distribution parameters, with `.to(device)`.

The field set, the derived properties and every table's values are the
same as the JAX package's, so a spawner lowers identically in both.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Tuple

import numpy as np
import torch

from .curve import K_MAX, compile_curve
from .settings import EmissionModeKind, EmissionPacingKind, ParticleSpawner, SpawnTransformMode
from .utils.device import DEFAULT_DEVICE, resolve_device

PACING_ONE_SHOT = 0
PACING_ON_DEMAND = 1
PACING_RATE = 2

MODE_GLOBAL = 0
MODE_NESTED = 1


@dataclasses.dataclass(frozen=True)
class SpawnerStatic:
    """Hashable structure key (fields as in the JAX package)."""

    num_types: int
    num_emitters: int
    pacing_kinds: Tuple[int, ...]  # per emitter
    mode_kinds: Tuple[int, ...]  # per emitter
    target_types: Tuple[int, ...]  # per emitter (nested target, else 0)
    particle_indices: Tuple[int, ...]  # per emitter
    collision_types: Tuple[bool, ...]  # per type: collision on?
    destroyed_dump_types: Tuple[bool, ...]  # per type: capture destroyed records?
    spawn_transform_local: bool
    nested_valid: Tuple[bool, ...]  # per emitter: mode/pacing combination legal
    scale_curve_meta: Tuple[Tuple[int, int], ...]  # per type (kind, knot count)
    nested_m: int = 4096  # per-emitter-per-frame nested child buffer size
    color_curve_meta: Tuple[Tuple[int, int, int, int], ...] = ()  # (base kind, n, emis kind, n)
    # every particle keeps q = identity and w = 0 forever: the 7 rotation
    # fields are invariant and the step neither reads nor writes them
    elide_rotation: bool = False
    # every type draws the same constant lifetime: the lifetime field is
    # invariant once filled with it (pools come from init_pool_for)
    const_lifetime: object = None  # Optional[float]
    destroy_types: Tuple[bool, ...] = ()  # per type: destroy_on_collision

    @property
    def any_collision(self) -> bool:
        return any(self.collision_types)

    @property
    def any_destroy(self) -> bool:
        return any(self.destroy_types)

    @property
    def any_destroyed_dump(self) -> bool:
        return any(self.destroyed_dump_types)

    @property
    def single_type(self) -> bool:
        """T == 1: the ptype field is identically zero."""
        return self.num_types == 1

    @property
    def ring_claim(self) -> bool:
        """Deaths happen only by aging, so spawns claim the ring window
        [cursor, cursor + n) mod N (masked by the dead flag) instead of
        ranking dead slots with a prefix sum. Off when a type destroys on
        collision, which punches holes behind the cursor."""
        return not self.any_destroy

    @property
    def derived_alive(self) -> bool:
        """alive == (age < lifetime) for ring archetypes without a destroyed
        dump; pools start with age = lifetime fill."""
        return self.ring_claim and not self.any_destroyed_dump


@dataclasses.dataclass(frozen=True)
class SpawnerParams:
    """Tensor spawner parameters; leaves as in the JAX package. f32 unless
    noted; `*_n`/`*_kind` int32; `collision_mask` int64 holding uint32."""

    lifetime_lo: torch.Tensor
    lifetime_hi: torch.Tensor
    initial_scale_lo: torch.Tensor
    initial_scale_hi: torch.Tensor
    acceleration: torch.Tensor  # [T, 3]
    angular_acceleration: torch.Tensor  # [T, 3]
    linear_drag: torch.Tensor
    angular_drag: torch.Tensor
    scale_ts: torch.Tensor  # [T, K]
    scale_vs: torch.Tensor  # [T, K]
    scale_n: torch.Tensor
    scale_kind: torch.Tensor
    base_ts: torch.Tensor  # [T, K]
    base_vs: torch.Tensor  # [T, K, 4]
    base_n: torch.Tensor
    base_kind: torch.Tensor
    emis_ts: torch.Tensor
    emis_vs: torch.Tensor  # [T, K, 4]
    emis_n: torch.Tensor
    emis_kind: torch.Tensor
    base_color0: torch.Tensor  # [T, 4]
    emis_color0: torch.Tensor  # [T, 4]
    pbr: torch.Tensor
    restitution: torch.Tensor
    friction: torch.Tensor
    destroy_on_collision: torch.Tensor
    collision_mask: torch.Tensor
    field_mask: torch.Tensor
    count: torch.Tensor  # [E]
    duration: torch.Tensor
    off_start: torch.Tensor
    off_end: torch.Tensor
    shape_params: torch.Tensor  # [E, 8]
    ivel_params: torch.Tensor  # [E, 7]
    radial_lo: torch.Tensor
    radial_hi: torch.Tensor
    inherit: torch.Tensor
    init_rot: torch.Tensor  # [E, 4]
    iangvel_params: torch.Tensor  # [E, 7]

    @property
    def device(self) -> torch.device:
        return self.count.device

    def to(self, device) -> "SpawnerParams":
        return SpawnerParams(**{k: getattr(self, k).to(device) for k in _PARAM_FIELDS})

    def to_numpy(self) -> dict:
        return {k: getattr(self, k).cpu().numpy() for k in _PARAM_FIELDS}

    @staticmethod
    def from_numpy(leaves: dict, device=DEFAULT_DEVICE) -> "SpawnerParams":
        device = resolve_device(device)
        out = {}
        for k in _PARAM_FIELDS:
            a = np.asarray(leaves[k])
            if k == "collision_mask":
                a = a.astype(np.int64)
            out[k] = torch.as_tensor(np.array(a, copy=True), device=device)
        return SpawnerParams(**out)


_PARAM_FIELDS = tuple(f.name for f in dataclasses.fields(SpawnerParams))


@dataclasses.dataclass(frozen=True)
class CompiledSpawner:
    static: SpawnerStatic
    params: SpawnerParams
    starts_enabled: bool
    # host-side render metadata, per type
    blend_modes: Tuple[int, ...]
    pbr_flags: Tuple[bool, ...]
    fade_edges: Tuple[float, ...]
    fade_scenes: Tuple[float, ...]
    textures: Tuple[Tuple[object, object, object], ...]
    destroyed_handlers: Tuple[object, ...]

    @property
    def num_types(self) -> int:
        return self.static.num_types

    @property
    def num_emitters(self) -> int:
        return self.static.num_emitters


def compile_spawner(spawner: ParticleSpawner, nested_buffer: int = 4096, device=DEFAULT_DEVICE) -> CompiledSpawner:
    """Lower `spawner`; the params live on `device` (the card unless the
    caller passes "cpu")."""
    device = resolve_device(device)
    types = spawner.particle_settings
    emitters = spawner.emission_settings
    T, E = len(types), len(emitters)

    pacing_map = {
        EmissionPacingKind.ONE_SHOT: PACING_ONE_SHOT,
        EmissionPacingKind.ON_DEMAND: PACING_ON_DEMAND,
        EmissionPacingKind.COUNT_OVER_DURATION: PACING_RATE,
    }
    pacing_kinds = tuple(pacing_map[e.emission_pacing.kind] for e in emitters)
    mode_kinds = tuple(MODE_NESTED if e.emission_mode.kind == EmissionModeKind.NESTED else MODE_GLOBAL
                       for e in emitters)
    # Nested emission requires CountOverDuration pacing (reference core.rs:474-485)
    nested_valid = tuple(not (m == MODE_NESTED and p != PACING_RATE) for m, p in zip(mode_kinds, pacing_kinds))
    if not all(nested_valid):
        warnings.warn(
            "Only CountOverDuration emission pacing is allowed with Nested "
            "emission mode; the offending emitter(s) will never emit",
            stacklevel=2,
        )

    elide_rotation = (
        all(tuple(e.initial_rotation) == (0.0, 0.0, 0.0, 1.0) for e in emitters)
        and all(e.initial_angular_velocity.magnitude.min == 0.0
                and e.initial_angular_velocity.magnitude.max == 0.0 for e in emitters)
        and all(tuple(t.angular_acceleration) == (0.0, 0.0, 0.0) for t in types)
    )
    lifetime_ranges = {(t.lifetime.min, t.lifetime.max) for t in types}
    const_lifetime = None
    if len(lifetime_ranges) == 1:
        lo, hi = next(iter(lifetime_ranges))
        if lo == hi:
            const_lifetime = float(lo)

    static = SpawnerStatic(
        num_types=T,
        num_emitters=E,
        pacing_kinds=pacing_kinds,
        mode_kinds=mode_kinds,
        target_types=tuple(e.emission_mode.target_particle_type for e in emitters),
        particle_indices=tuple(e.particle_index for e in emitters),
        collision_types=tuple(t.collision_settings is not None for t in types),
        destroyed_dump_types=tuple(t.event_handlers.particles_destroyed is not None for t in types),
        spawn_transform_local=spawner.spawn_transform_mode == SpawnTransformMode.LOCAL,
        nested_valid=nested_valid,
        scale_curve_meta=tuple((t.scale_curve.kind, t.scale_curve.n) for t in types),
        color_curve_meta=tuple((t.base_color.kind, t.base_color.n, t.emissive_color.kind, t.emissive_color.n)
                               for t in types),
        nested_m=int(nested_buffer),
        elide_rotation=elide_rotation,
        const_lifetime=const_lifetime,
        destroy_types=tuple(bool(t.collision_settings and t.collision_settings.destroy_on_collision)
                            for t in types),
    )

    def farr(vals):
        return np.asarray(vals, dtype=np.float32)

    def iarr(vals):
        return np.asarray(vals, dtype=np.int32)

    k_pad = max([K_MAX] + [t.scale_curve.n for t in types]
                + [t.base_color.n for t in types] + [t.emissive_color.n for t in types])
    scale_tabs = [compile_curve(t.scale_curve, channels=0, k_pad=k_pad) for t in types]
    base_tabs = [compile_curve(t.base_color, channels=4, k_pad=k_pad) for t in types]
    emis_tabs = [compile_curve(t.emissive_color, channels=4, k_pad=k_pad) for t in types]

    leaves = dict(
        lifetime_lo=farr([t.lifetime.min for t in types]),
        lifetime_hi=farr([t.lifetime.max for t in types]),
        initial_scale_lo=farr([t.initial_scale.min for t in types]),
        initial_scale_hi=farr([t.initial_scale.max for t in types]),
        acceleration=farr([t.acceleration for t in types]),
        angular_acceleration=farr([t.angular_acceleration for t in types]),
        linear_drag=farr([t.linear_drag for t in types]),
        angular_drag=farr([t.angular_drag for t in types]),
        scale_ts=farr([tab[0] for tab in scale_tabs]),
        scale_vs=farr([tab[1] for tab in scale_tabs]),
        scale_n=iarr([tab[2] for tab in scale_tabs]),
        scale_kind=iarr([tab[3] for tab in scale_tabs]),
        base_ts=farr([tab[0] for tab in base_tabs]),
        base_vs=farr([tab[1] for tab in base_tabs]),
        base_n=iarr([tab[2] for tab in base_tabs]),
        base_kind=iarr([tab[3] for tab in base_tabs]),
        emis_ts=farr([tab[0] for tab in emis_tabs]),
        emis_vs=farr([tab[1] for tab in emis_tabs]),
        emis_n=iarr([tab[2] for tab in emis_tabs]),
        emis_kind=iarr([tab[3] for tab in emis_tabs]),
        base_color0=farr([t.base_color.sample_clamped(0.0) for t in types]),
        emis_color0=farr([t.emissive_color.sample_clamped(0.0) for t in types]),
        pbr=farr([1.0 if t.pbr else 0.0 for t in types]),
        restitution=farr([(t.collision_settings.restitution if t.collision_settings else 0.0) for t in types]),
        field_mask=farr([1.0 if t.affected_by_fields else 0.0 for t in types]),
        friction=farr([(t.collision_settings.friction if t.collision_settings else 0.0) for t in types]),
        destroy_on_collision=farr([(1.0 if (t.collision_settings and t.collision_settings.destroy_on_collision)
                                    else 0.0) for t in types]),
        collision_mask=np.asarray([(t.collision_settings.filter_mask if t.collision_settings else 0)
                                   for t in types], dtype=np.int64),
        count=farr([e.emission_pacing.count for e in emitters]),
        duration=farr([e.emission_pacing.duration for e in emitters]),
        off_start=farr([e.emission_pacing.offset_start for e in emitters]),
        off_end=farr([e.emission_pacing.offset_end for e in emitters]),
        shape_params=farr([e.emission_shape.compile() for e in emitters]),
        ivel_params=farr([e.initial_velocity.compile() for e in emitters]),
        radial_lo=farr([e.initial_velocity_radial.min for e in emitters]),
        radial_hi=farr([e.initial_velocity_radial.max for e in emitters]),
        inherit=farr([1.0 if e.inherit_parent_velocity else 0.0 for e in emitters]),
        init_rot=farr([e.initial_rotation for e in emitters]),
        iangvel_params=farr([e.initial_angular_velocity.compile() for e in emitters]),
    )

    return CompiledSpawner(
        static=static,
        params=SpawnerParams.from_numpy(leaves, device),
        starts_enabled=spawner.starts_enabled,
        blend_modes=tuple(t.blend_mode.as_u32() for t in types),
        pbr_flags=tuple(bool(t.pbr) for t in types),
        fade_edges=tuple(t.fade_edge for t in types),
        fade_scenes=tuple(t.fade_scene for t in types),
        textures=tuple((t.base_color_texture, t.normal_map_texture, t.orm_texture) for t in types),
        destroyed_handlers=tuple(t.event_handlers.particles_destroyed for t in types),
    )
