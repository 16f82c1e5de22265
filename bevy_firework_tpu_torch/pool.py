"""Fixed-capacity SoA particle pool state and per-frame inputs.

Same fields and conventions as `bevy_firework_tpu.pool`: every per-slot
quantity is its own [N] tensor (component-split), dead particles are masked
lanes, and const-lifetime archetypes hold the constant in both `age` and
`lifetime` of dead lanes, so alive == (age < lifetime) reads dead there.

Two leaves stay on the host by design, whatever the pool's device:
`rng_key` (uint32 words in an int64 CPU tensor; the key chain is threefry
on the host, `prng.threefry_split`, so no frame waits on the card for it)
and every `FrameInput` leaf (host-provided per frame; 0-d CPU tensors act
as scalars in ops with CUDA tensors, and the kernel wrapper passes them as
launch arguments).

A fleet's pools stack on a leading slot axis (`parallel.sharding.
stack_pools`): [S, N] planes, [S, E] and [S] scalars, rng_key [S, 2];
`capacity`, `num_emitters` and `alive_count` read the trailing axes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .utils.device import DEFAULT_DEVICE, resolve_device
from .utils.f32 import F32_MIN


@dataclasses.dataclass(frozen=True)
class PoolState:
    """Physics state; render fields (scale, colors) are recomputed from
    (initial_scale, age, lifetime, ptype) through the curve tables."""

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    qx: torch.Tensor
    qy: torch.Tensor
    qz: torch.Tensor
    qw: torch.Tensor
    wx: torch.Tensor
    wy: torch.Tensor
    wz: torch.Tensor
    initial_scale: torch.Tensor
    age: torch.Tensor
    lifetime: torch.Tensor
    ptype: torch.Tensor  # [N] int32
    alive: torch.Tensor  # [N] bool
    last_emitted: torch.Tensor  # [E, N] f32
    time_in_cycle: torch.Tensor  # [E] f32
    last_emission: torch.Tensor  # [E] f32
    enabled: torch.Tensor  # [E] bool
    manual_queued: torch.Tensor  # int32 scalar
    finished_notified: torch.Tensor  # bool scalar
    ring_cursor: torch.Tensor  # int32 scalar: ring-claim window start
    rng_key: torch.Tensor  # int64 [2] on the host: uint32 key words

    @property
    def capacity(self) -> int:
        return self.px.shape[-1]

    @property
    def num_emitters(self) -> int:
        return self.last_emitted.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.px.device

    def alive_count(self) -> torch.Tensor:
        """Live lanes: a 0-d count, or [S] counts of a stacked pool."""
        return self.alive.sum(-1, dtype=torch.int32)

    def to(self, device) -> "PoolState":
        kw = {k: getattr(self, k).to(device) for k in POOL_FIELDS if k != "rng_key"}
        return PoolState(rng_key=self.rng_key, **kw)


POOL_FIELDS = tuple(f.name for f in dataclasses.fields(PoolState))


def init_pool(capacity: int, num_emitters: int, starts_enabled: bool = True, seed: int = 0,
              lifetime_fill: float = 1.0, device=DEFAULT_DEVICE) -> PoolState:
    """Fresh pool, everything dead. lifetime_fill fills both `age` and
    `lifetime`; const-lifetime archetypes need it to be their constant, which
    `init_pool_for` guarantees."""
    device = resolve_device(device)
    n = int(capacity)
    f32 = dict(dtype=torch.float32, device=device)

    def z():
        return torch.zeros(n, **f32)

    return PoolState(
        px=z(), py=z(), pz=z(), vx=z(), vy=z(), vz=z(),
        qx=z(), qy=z(), qz=z(), qw=torch.ones(n, **f32),
        wx=z(), wy=z(), wz=z(),
        initial_scale=z(),
        age=torch.full((n,), float(lifetime_fill), **f32),
        lifetime=torch.full((n,), float(lifetime_fill), **f32),
        ptype=torch.zeros(n, dtype=torch.int32, device=device),
        alive=torch.zeros(n, dtype=torch.bool, device=device),
        last_emitted=torch.full((num_emitters, n), float(F32_MIN), **f32),
        time_in_cycle=torch.zeros(num_emitters, **f32),
        last_emission=torch.zeros(num_emitters, **f32),
        enabled=torch.full((num_emitters,), bool(starts_enabled), dtype=torch.bool, device=device),
        manual_queued=torch.zeros((), dtype=torch.int32, device=device),
        finished_notified=torch.zeros((), dtype=torch.bool, device=device),
        ring_cursor=torch.zeros((), dtype=torch.int32, device=device),
        # jax.random.PRNGKey(seed): [0, seed mod 2^32]
        rng_key=torch.tensor([0, int(seed) & 0xFFFFFFFF], dtype=torch.int64),
    )


def init_pool_for(compiled, capacity: int, seed: int = 0, device=None) -> PoolState:
    """`init_pool` for a `CompiledSpawner`: honours starts_enabled and the
    const-lifetime contract (age and lifetime pre-filled with the constant).
    device defaults to the device of the compiled params."""
    cl = compiled.static.const_lifetime
    return init_pool(capacity, compiled.num_emitters, compiled.starts_enabled, seed,
                     lifetime_fill=1.0 if cl is None else cl,
                     device=compiled.params.device if device is None else device)


@dataclasses.dataclass(frozen=True)
class FrameInput:
    """Per-frame host inputs for one spawner (0-d / small CPU tensors), and
    the scene's force fields: a `force_fields.FieldTable` on the pool's
    device, or None."""

    dt: torch.Tensor  # f32 scalar
    transform_translation: torch.Tensor  # [3]
    transform_rotation: torch.Tensor  # [4] xyzw
    parent_velocity: torch.Tensor  # [3]
    modifier_scale: torch.Tensor  # f32 scalar
    modifier_speed: torch.Tensor  # f32 scalar
    force_fields: Optional[object] = None


def make_frame_input(dt, translation=(0.0, 0.0, 0.0), rotation=(0.0, 0.0, 0.0, 1.0),
                     parent_velocity=(0.0, 0.0, 0.0), modifier_scale=1.0, modifier_speed=1.0,
                     force_fields=None) -> FrameInput:
    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    return FrameInput(
        dt=f(dt),
        transform_translation=f(translation),
        transform_rotation=f(rotation),
        parent_velocity=f(parent_velocity),
        modifier_scale=f(modifier_scale),
        modifier_speed=f(modifier_speed),
        force_fields=force_fields,
    )
