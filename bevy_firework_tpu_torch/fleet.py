"""Fleet: many same-archetype spawners stepped in ONE launch.

The port of `bevy_firework_tpu.fleet`. The reference parallelises
`update_particles` across spawners with `par_iter_mut` CPU threads
(`core.rs:583-585`); a Fleet owns a fixed slab of S spawner slots of one
archetype, stacked on a leading axis (`parallel.sharding`), and advances
all of them with `ops.fused_step.step_auto_fleet`: one fleet-kernel launch
per frame on the card (per `table_layout.SEED_WORDS` slots), the plain
version on the CPU.

Typical use, the one_shot scene's impact bursts (`examples/one_shot.rs`):

    fleet = Fleet(burst_spawner, capacity=64, max_spawners=256)   # device="cpu" for the CPU
    slot = fleet.activate(Transform(translation=impact_point))
    fleet.step(dt)              # steps every slot at once
    for slot in fleet.drain_finished():
        ...                     # slot auto-deactivated (despawn analog)

Slots are reused; `activate` resets a slot's pool like the reference's
fresh-entity spawn + `sync_spawner_data`, keeping the slot's own key
stream.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .colliders import ColliderTable
from .compiled import CompiledSpawner, compile_spawner
from .ops.fused_step import step_auto_fleet
from .parallel.sharding import replace_slots, stack_frames, stack_pools
from .pool import PoolState, init_pool, make_frame_input
from .render import RenderItem, compact_dense, make_uniform, pack_instances_dense
from .scene import Transform
from .settings import EffectModifier, ParticleSpawner
from .utils.device import DEFAULT_DEVICE, resolve_device


def _reset_slot(states: PoolState, template: PoolState, slot: int, enabled: bool) -> PoolState:
    """The stacked pools with slot `slot` overwritten by a fresh pool, except
    its rng_key, which keeps the slot's own advancing stream (so re-activated
    and sibling spawners draw distinct randomness). Out of place."""
    fresh = dataclasses.replace(template, enabled=torch.full_like(template.enabled, bool(enabled)))
    return replace_slots(states, [slot], stack_pools([fresh]), keep_keys=True)


class Fleet:
    def __init__(self, spawner: ParticleSpawner, capacity: int = 1024, max_spawners: int = 64,
                 colliders: Optional[ColliderTable] = None, seed: int = 0, device=DEFAULT_DEVICE):
        """S = max_spawners slots of `capacity` lanes, all inactive, on
        `device` (the card unless the caller passes "cpu"; raises without a
        card). colliders: a ColliderTable on the same device."""
        self.device = resolve_device(device)
        self.spawner = spawner
        self.compiled: CompiledSpawner = compile_spawner(spawner, device=self.device)
        self.capacity = int(capacity)
        self.max_spawners = int(max_spawners)
        self.colliders = colliders if (colliders is not None and self.compiled.static.any_collision) else None
        cl = self.compiled.static.const_lifetime
        fill = 1.0 if cl is None else cl  # the elision contract (pool.init_pool_for)
        E = self.compiled.num_emitters
        self.states: PoolState = stack_pools([init_pool(capacity, E, False, seed + i, fill, self.device)
                                              for i in range(max_spawners)])
        self._template = init_pool(capacity, E, True, seed, fill, self.device)
        self._active = [False] * max_spawners
        self._transforms: List[Transform] = [Transform() for _ in range(max_spawners)]
        self._modifiers: List[EffectModifier] = [EffectModifier() for _ in range(max_spawners)]
        self._parent_vel = [(0.0, 0.0, 0.0)] * max_spawners
        self._outputs = None
        self._finished_flags = np.zeros(max_spawners, bool)
        self._frames = None  # (dt, stacked FrameInput): rebuilt when a slot's inputs or dt change

    # ------------------------------------------------------------- lifecycle
    def activate(self, transform: Optional[Transform] = None, modifier: Optional[EffectModifier] = None,
                 parent_velocity=(0.0, 0.0, 0.0)) -> int:
        """Claim a free slot and start its spawner (fresh pool, enabled)."""
        try:
            slot = self._active.index(False)
        except ValueError:
            raise RuntimeError("Fleet full: raise max_spawners") from None
        self.states = _reset_slot(self.states, self._template, slot, True)
        self._active[slot] = True
        self._transforms[slot] = transform or Transform()
        self._modifiers[slot] = modifier or EffectModifier()
        self._parent_vel[slot] = tuple(float(v) for v in parent_velocity)
        self._finished_flags[slot] = False
        self._frames = None
        return slot

    def deactivate(self, slot: int):
        self.states = _reset_slot(self.states, self._template, slot, False)
        self._active[slot] = False

    def active_slots(self) -> List[int]:
        return [i for i, a in enumerate(self._active) if a]

    # ------------------------------------------------------------------ step
    def _stacked_frames(self, dt: float):
        if self._frames is None or self._frames[0] != dt:
            frames = [make_frame_input(dt, translation=self._transforms[i].translation,
                                       rotation=self._transforms[i].rotation, parent_velocity=self._parent_vel[i],
                                       modifier_scale=self._modifiers[i].scale, modifier_speed=self._modifiers[i].speed)
                      for i in range(self.max_spawners)]
            self._frames = (dt, stack_frames(frames))
        return self._frames[1]

    def step(self, dt: float):
        """Every slot one frame, in one fleet launch on the card (per SEED_WORDS slots)."""
        c = self.compiled
        self.states, self._outputs = step_auto_fleet(c.static, c.params, self.colliders, self.states,
                                                     self._stacked_frames(dt))

    def drain_finished(self) -> List[int]:
        """Slots whose ParticleSpawnerFinished fired this frame; each is
        deactivated (the reference one_shot pattern: the observer
        despawns). One device-to-host read of the [S] flags per call."""
        if self._outputs is None:
            return []
        fired = self._outputs.finished_event.cpu().numpy()
        out = []
        for i in range(self.max_spawners):
            if self._active[i] and fired[i] and not self._finished_flags[i]:
                self._finished_flags[i] = True
                self.deactivate(i)
                out.append(i)
        return out

    # ----------------------------------------------------------------- query
    def alive_count(self) -> int:
        if self._outputs is None:
            return 0
        return int(self._outputs.alive_count.sum())

    def render_items(self) -> List[RenderItem]:
        """One item per (active slot x non-empty type): per type one dense
        pack of the whole fleet and one copy to the host, compacted per
        slot there."""
        items = []
        active = self.active_slots()
        for t in range(self.compiled.num_types):
            planes, _count = pack_instances_dense(self.compiled.params, self.states, t)  # [16, S, N]
            planes = planes.cpu().numpy()
            for i in active:
                rows = compact_dense(planes[:, i])
                if rows.shape[0] == 0:
                    continue
                items.append(RenderItem(spawner_id=i, type_index=t, instances=rows, count=rows.shape[0],
                                        uniform=make_uniform(self.compiled, t), textures=self.compiled.textures[t]))
        return items
