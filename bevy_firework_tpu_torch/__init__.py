"""bevy_firework_tpu_torch: the particle engine on PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of `bevy_firework_tpu` (JAX/Pallas, the reference it is tested
against), module for module. This package imports torch and numpy only. On
CUDA tensors the step runs the fused kernel of `ops/csrc/` (`fused_step_kernel.cuh`),
built with nvcc at first use; on CPU tensors it runs the kernel's plain
PyTorch version.

Ported so far: authoring and lowering, the pool, the global-emitter step
(ring claim, constant or random lifetime, rotation), its multi-frame
chain, the render-pack extract, collision (analytic colliders of 7 kinds,
hulls from planes, points or a decomposed mesh, layer masks, restitution,
friction, the 4-substep bounce, destroy-on-collision with its dead-rank
slot claim), scene force fields, the destroyed-particle mask and its
events, the kernel's stats, nested emission (hybrid frames: the nested
cadence pass, threefry child rows and the in-kernel child merge;
`fused_step_hybrid`, `nested_cadence_pass`; chains of them fold the next
frame's cadence counts into the step, `chain_nested_folded`), fleets (S same-archetype
pools in one launch of the fleet kernel: `fused_step_fleet`,
`multi_step_fleet`, `Fleet`, the stack helpers of `parallel.sharding`),
the effect library and effects (textures and fireworks included), and the
`Scene` facade with archetype groups (one fleet launch per group;
colliders and force fields with slot reuse, `particles_destroyed` and
`on_finished` events, AABBs, render items), and the render extract: the
kernel's f32 or f16 render pack, the pack family (`pack_instances`,
`pack_instances_planar`, `pack_instances_dense_f16`), the native instance
ring (`native`) and `AsyncRenderReader` with the Scene's async render,
and scale-out on torch.distributed (`parallel.sharding`: a pool split over
the particle axis with the step kernel's shard arguments, fleets split
over ranks, and both on a hosts x chips layout).
Also ribbon trails (`trails`: `Scene.add_spawner(trail=)`,
`Scene.trail_items`), checkpoints in the JAX package's file format
(`checkpoint`: `save_scene`, `load_scene`, `save_pool`, `load_pool`) and
the Scene's async events (`enable_async_events`, `flush_events`).
The view's lights, fog and shadow atlas (`render`), the shipped WGSL
shaders with their specializer and checkers (`shaders`), physics sync
(`physics_sync`) and the headless software viewer (`viewer`) are the JAX
package's host numpy, copied.

Two step layouts, on both devices. `step`, `step_jit` and `multi_step`
are the JAX package's XLA step (`xla_step`: threefry draws per emitter,
emitters in declared order), lane for lane with it on random configs;
`step_auto`, `multi_step_auto`, `Fleet` and `Scene` take the CUDA kernel's
layout (`step.advance`: Philox draws per lane), on CPU tensors through its
plain version. Every entry point runs on the card unless given
`device="cpu"`. On the card the chains (`multi_step_auto`,
`multi_step_auto_packed`, `multi_step_fleet_stacked`, `multi_step_fleet`)
replay one captured CUDA graph per static configuration
(`ops.chain_graph`), as the JAX package dispatches each as one `jit`.
"""

from .cadence import compute_emission_count, np_compute_emission_count
from .checkpoint import load_pool, load_scene, save_pool, save_scene
from .colliders import Collider, ColliderTable, compile_colliders, hull_decomposition
from .compiled import CompiledSpawner, SpawnerParams, SpawnerStatic, compile_spawner
from .curve import (
    FireworkCurve,
    FireworkGradient,
    gradient_constant,
    gradient_even_samples,
    gradient_uneven_samples,
)
from .emission_shape import EmissionShape
from .fleet import Fleet
from .force_fields import FieldTable, ForceField, compile_force_fields
from .ops.fused_step import (
    fused_step,
    fused_step_fleet,
    fused_step_hybrid,
    multi_step_auto,
    multi_step_auto_packed,
    multi_step_fleet,
    multi_step_fleet_stacked,
    nested_cadence_pass,
    step_auto,
    step_auto_fleet,
    step_auto_packed,
)
from .parallel.sharding import stack_frames, stack_params, stack_pools
from .pool import FrameInput, PoolState, init_pool, init_pool_for, make_frame_input
from .rand import RandF32, RandVec3
from .physics_sync import RigidBodyState, linear_velocity_at_point, propagate_modifiers, sync_parent_velocity
from .render import (
    EnvironmentLight,
    FireworkUniform,
    FogSettings,
    Light,
    LightTable,
    RenderItem,
    ShadowAtlas,
    aabb_intersects_frustum,
    frustum_planes,
    instances_to_bytes,
    light_view_proj,
    make_shadow_atlas,
    make_uniform,
    pack_instances,
    pack_instances_dense,
    pack_instances_dense_f16,
    pack_instances_planar,
    planes_to_rows,
    sort_instances_back_to_front,
)
from .render_pipeline import AsyncRenderReader
from .scene import DestroyedParticle, Scene, Transform, estimate_capacity
from .shaders.specialize import DummyTextures, PipelineCache, PipelineKey, key_for
from .settings import (
    BlendMode,
    EffectModifier,
    EmissionMode,
    EmissionPacing,
    EmissionSettings,
    ParticleCollisionSettings,
    ParticleEventHandlers,
    ParticleSettings,
    ParticleSpawner,
    SpawnTransformMode,
    spawner_from_dict,
    spawner_from_json,
    spawner_to_dict,
    spawner_to_json,
)
from .step import StepOutputs, multi_step, step, step_jit
from .trails import TrailItem, TrailSettings, TrailState, init_trail_state, pack_trail_segments, update_trails

__all__ = [
    "AsyncRenderReader", "BlendMode", "Collider", "ColliderTable", "CompiledSpawner", "DestroyedParticle",
    "DummyTextures", "EffectModifier", "EnvironmentLight", "FogSettings", "Light", "LightTable", "PipelineCache",
    "PipelineKey", "RigidBodyState", "ShadowAtlas", "key_for", "light_view_proj", "linear_velocity_at_point",
    "make_shadow_atlas", "propagate_modifiers", "sync_parent_velocity",
    "EmissionMode", "EmissionPacing", "EmissionSettings", "EmissionShape", "FieldTable", "FireworkCurve", "Fleet",
    "FireworkGradient", "FireworkUniform", "ForceField", "FrameInput", "ParticleCollisionSettings",
    "ParticleEventHandlers", "ParticleSettings", "ParticleSpawner", "PoolState", "RandF32", "RandVec3", "RenderItem",
    "Scene", "SpawnTransformMode", "SpawnerParams", "SpawnerStatic", "StepOutputs", "Transform",
    "TrailItem", "TrailSettings", "TrailState",
    "aabb_intersects_frustum", "compile_colliders", "compile_force_fields", "compile_spawner", "compute_emission_count",
    "estimate_capacity",
    "frustum_planes", "fused_step", "fused_step_fleet", "fused_step_hybrid", "gradient_constant",
    "gradient_even_samples", "gradient_uneven_samples", "hull_decomposition", "init_pool", "init_pool_for", "init_trail_state",
    "instances_to_bytes", "load_pool", "load_scene",
    "make_frame_input", "make_uniform", "multi_step_auto", "multi_step_auto_packed",
    "multi_step", "multi_step_fleet", "multi_step_fleet_stacked", "nested_cadence_pass", "np_compute_emission_count",
    "pack_instances", "pack_instances_dense", "pack_instances_dense_f16", "pack_instances_planar", "pack_trail_segments",
    "planes_to_rows", "save_pool", "save_scene", "sort_instances_back_to_front", "spawner_from_dict", "spawner_from_json", "spawner_to_dict", "spawner_to_json",
    "stack_frames", "stack_params", "stack_pools", "step", "step_auto", "step_auto_fleet", "step_auto_packed",
    "step_jit", "update_trails",
]
