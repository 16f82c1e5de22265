"""bevy_firework_tpu_torch: the particle engine on PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of `bevy_firework_tpu` (JAX/Pallas, the reference it is tested
against), module for module. This package imports torch and numpy only. On
CUDA tensors the step runs the fused kernel of `ops/csrc/fused_step.cu`,
built with nvcc at first use; on CPU tensors it runs the kernel's plain
PyTorch version.

Ported so far: authoring and lowering, the pool, the global-emitter step
(ring claim, constant or random lifetime, rotation), its multi-frame
chain, the render-pack extract, and collision: analytic colliders of 7
kinds (hulls from planes, points or a decomposed mesh), layer masks,
restitution, friction, the 4-substep bounce, and destroy-on-collision with
its dead-rank slot claim. Not yet: force fields, nested emission, the
destroyed-particle dump and events, the Scene facade, fleets, sharding
(see ROADMAP.md).
"""

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
from .ops.fused_step import fused_step, multi_step_auto, step_auto, step_auto_packed
from .pool import FrameInput, PoolState, init_pool, init_pool_for, make_frame_input
from .rand import RandF32, RandVec3
from .render import FireworkUniform, instances_to_bytes, make_uniform, pack_instances_dense, planes_to_rows
from .scene import Transform
from .settings import (
    BlendMode,
    EmissionMode,
    EmissionPacing,
    EmissionSettings,
    ParticleSettings,
    ParticleSpawner,
    SpawnTransformMode,
    spawner_from_json,
    spawner_to_json,
)
from .step import StepOutputs, step

__all__ = [
    "BlendMode", "Collider", "ColliderTable", "CompiledSpawner", "EmissionMode", "EmissionPacing", "EmissionSettings", "EmissionShape",
    "FireworkCurve", "FireworkGradient", "FireworkUniform", "FrameInput", "ParticleSettings", "ParticleSpawner",
    "PoolState", "RandF32", "RandVec3", "SpawnTransformMode", "SpawnerParams", "SpawnerStatic", "StepOutputs",
    "Transform", "compile_colliders", "compile_spawner", "fused_step", "gradient_constant", "gradient_even_samples",
    "gradient_uneven_samples", "hull_decomposition", "init_pool", "init_pool_for", "instances_to_bytes", "make_frame_input",
    "make_uniform", "multi_step_auto", "pack_instances_dense", "planes_to_rows", "spawner_from_json",
    "spawner_to_json", "step", "step_auto", "step_auto_packed",
]
