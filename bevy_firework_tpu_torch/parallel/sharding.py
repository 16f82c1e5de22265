"""Stacked fleets: S spawners of one archetype on a leading slot axis.

The port of `bevy_firework_tpu.parallel.sharding`'s stack helpers
(`stack_pools`, `stack_params`, `stack_frames`). A fleet's step
(`ops.fused_step.fused_step_fleet`) advances every slot in one launch. The
mesh functions of the JAX module (`make_mesh`, the particle-axis and
fleet-axis shardings) wait for ROADMAP queue 1 item 14.

Layouts:
  * a stacked `PoolState` holds [S, N] planes, [S, E] emitter scalars, [S]
    scalars and `rng_key` [S, 2] (int64 on the host, as a solo pool's);
  * stacked `SpawnerParams` hold each leaf with a leading [S];
  * a stacked `FrameInput` holds dt [S], translation [S, 3], rotation
    [S, 4], parent velocity [S, 3] and the modifiers [S] (host tensors), and
    as `force_fields` None or a tuple of S `FieldTable`s of one field count.
A member's view (`state_slot`, `params_slot`, `frame_slot`,
`outputs_slot`) slices the stacked leaves and copies nothing.
"""

from __future__ import annotations

import dataclasses

import torch

from ..compiled import _PARAM_FIELDS, SpawnerParams
from ..pool import POOL_FIELDS, FrameInput, PoolState
from ..step import StepOutputs
from ..utils.device import upload

_OUTPUT_FIELDS = tuple(f.name for f in dataclasses.fields(StepOutputs))

_FRAME_LEAVES = ("dt", "transform_translation", "transform_rotation", "parent_velocity", "modifier_scale",
                 "modifier_speed")


def stack_pools(states) -> PoolState:
    """Stack S pools of one capacity into one [S]-leading PoolState (one
    stack per leaf, on the pools' device; rng_key stays on the host)."""
    return PoolState(**{k: torch.stack([getattr(s, k) for s in states]) for k in POOL_FIELDS})


def stack_params(params_list) -> SpawnerParams:
    """Stack S SpawnerParams of one archetype into [S]-leading leaves. The
    members are kept beside the leaves, so the kernel's stacked table is
    assembled from their cached tables."""
    params_list = tuple(params_list)
    out = SpawnerParams(**{k: torch.stack([getattr(p, k) for p in params_list]) for k in _PARAM_FIELDS})
    out.__dict__["_members"] = params_list
    return out


def stack_frames(frames) -> FrameInput:
    """Stack S FrameInputs (host leaves). Force fields: None for every
    member or one FieldTable each, all of one field count (the fleet
    kernel stages one count of records per slot)."""
    frames = tuple(frames)
    tables = [f.force_fields for f in frames]
    if all(t is None for t in tables):
        ff = None
    elif any(t is None for t in tables) or len({t.count for t in tables}) != 1:
        raise ValueError("stack_frames: the members' force-field tables must all be None or all of one count")
    else:
        ff = tuple(tables)
    return FrameInput(**{k: torch.stack([getattr(f, k) for f in frames]) for k in _FRAME_LEAVES}, force_fields=ff)


def stack_outputs(outputs) -> StepOutputs:
    """Stack S members' StepOutputs into [S]-leading outputs."""
    return StepOutputs(**{k: torch.stack([getattr(o, k) for o in outputs]) for k in _OUTPUT_FIELDS})


def outputs_slot(outputs: StepOutputs, i: int) -> StepOutputs:
    """Slot i of stacked outputs: views."""
    return StepOutputs(**{k: getattr(outputs, k)[i] for k in _OUTPUT_FIELDS})


def is_stacked_params(params: SpawnerParams) -> bool:
    """The params carry a leading slot axis (`count` is [S, E])."""
    return params.count.dim() == 2


def state_slot(states: PoolState, i: int) -> PoolState:
    """Slot i of a stacked pool: views of the stacked leaves."""
    return PoolState(**{k: getattr(states, k)[i] for k in POOL_FIELDS})


def params_slot(params: SpawnerParams, i: int) -> SpawnerParams:
    """Slot i of stacked params (views), or the shared params themselves."""
    if not is_stacked_params(params):
        return params
    members = params.__dict__.get("_members")
    if members is not None:
        return members[i]
    return SpawnerParams(**{k: getattr(params, k)[i] for k in _PARAM_FIELDS})


def frame_slot(frames: FrameInput, i: int) -> FrameInput:
    """Slot i of a stacked FrameInput (views; its own field table)."""
    ff = None if frames.force_fields is None else frames.force_fields[i]
    return FrameInput(**{k: getattr(frames, k)[i] for k in _FRAME_LEAVES}, force_fields=ff)


def num_slots(states: PoolState) -> int:
    """S of a stacked pool."""
    return states.px.shape[0]


def replace_slots(states: PoolState, pos, rows: PoolState, keep_keys: bool = False) -> PoolState:
    """A new stacked pool equal to `states` but for slots `pos` (a list of
    ints), taken from `rows` ([len(pos)]-stacked); with keep_keys those
    slots keep their own rng_key. Out of place: `states` is unchanged; the
    index reaches the card without a wait (`upload`)."""
    dev = states.device
    idx_dev, idx_host = upload(torch.tensor(pos, dtype=torch.int64), dev), torch.tensor(pos, dtype=torch.int64)
    kw = {}
    for k in POOL_FIELDS:
        old, new = getattr(states, k), getattr(rows, k)
        if k == "rng_key":
            kw[k] = old if keep_keys else old.index_copy(0, idx_host, new)
        else:
            kw[k] = old.index_copy(0, idx_dev, new)
    return PoolState(**kw)


def take_insert(states: PoolState, keep, pos, rows) -> PoolState:
    """Membership churn without a host round trip (the JAX Scene's
    `_restack_take_insert`): the new stacked pool gathers old slot keep[j]
    into position j (`index_select` on the device; a don't-care 0 where
    j is in `pos`), then positions `pos` take the changed members' `rows`
    ([len(pos)]-stacked, or None when `pos` is empty). keep, pos: lists
    of ints."""
    dev = states.device
    keep_host = torch.tensor(keep, dtype=torch.int64)
    keep_dev = upload(keep_host, dev)
    base = PoolState(**{k: getattr(states, k).index_select(0, keep_host if k == "rng_key" else keep_dev)
                        for k in POOL_FIELDS})
    return base if not pos else replace_slots(base, pos, rows)
