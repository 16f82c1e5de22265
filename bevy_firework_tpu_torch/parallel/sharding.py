"""Stacked fleets, and scale-out over torch.distributed process groups.

The port of `bevy_firework_tpu.parallel.sharding`. Its stack helpers
(`stack_pools`, `stack_params`, `stack_frames`) put S spawners of one
archetype on a leading slot axis; a fleet's step
(`ops.fused_step.fused_step_fleet`) advances every slot in one launch.

Scale-out (the JAX module's mesh functions, on process groups; one rank per
card, or, as the tests do, ranks on the CPU under `gloo`):
  * sp, the particle axis: `shard_pool` gives each rank of a group the
    contiguous lanes [r N / W, (r + 1) N / W) of one pool, and
    `make_sharded_step` steps them with the fused step's shard arguments
    (kernel row 11: global lane indices, the global capacity, a dead
    offset), so the slots each emitter claims and the draws of every lane
    are the unsharded pool's. The traffic is the epilogue's one small
    collective per launch (AABB, counts and the finished latch of the whole
    pool, `step.group_reduce`) and, for dead-rank archetypes, one int per
    rank per frame before the launch (the shards' dead totals, whose
    exclusive prefix is the shard's dead offset: summed from the claim's
    carried counts and gathered on the device, a word the kernel reads, so
    under nccl no host value waits on the card; gloo's gather crosses the
    host). Ring archetypes need nothing before the launch. Archetypes with
    a nested emitter (or any, with `prefer_fused=False`) step sharded in
    the JAX package's XLA layout instead (`xla_step.step(shard=, group=)`,
    the JAX module's GSPMD step): a few words per frame, and per nested
    emitter the ranks' count totals and a buffer of parent values bounded
    by the child buffer (`step.ShardExchange` lists them).
  * dp, the fleet axis: `shard_fleet` gives each rank its contiguous slots
    [r S / W, (r + 1) S / W) and `make_fleet_step` steps them through the
    fleet kernel (kernel row 7), with no collective at all.
  * 2D: `make_groups_2d` lays the ranks out as hosts x chips (the JAX
    module's `make_mesh_2d`): slots over hosts, each slot's pool sharded
    over its host's chips (`shard_fleet_2d`, `make_fleet_step_2d`);
    collectives run on the particle group only.
Every entry point runs on the card unless the pool is on the CPU; the
collectives' few words live where the group's backend wants them (the card
under nccl, the host under gloo; `step.collective_device`).

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

from ..compiled import _PARAM_FIELDS, SpawnerParams, SpawnerStatic
from ..pool import POOL_FIELDS, FrameInput, PoolState
from ..step import NESTED_SHARD_MESSAGE, Shard, StepOutputs, group_gather, has_nested
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


# --------------------------------------------------------------------------
# scale-out on torch.distributed
# --------------------------------------------------------------------------

# the pool's leaves every shard holds whole (the JAX module's replicated
# specs); the others are per lane (last axis)
REPLICATED = ("time_in_cycle", "last_emission", "enabled", "manual_queued", "finished_notified", "ring_cursor",
              "rng_key")


def init_distributed(backend: str = "gloo", init_method: str = None, world_size: int = None, rank: int = None):
    """Join the process group (the JAX module's `init_distributed`): wraps
    `torch.distributed.init_process_group`; nothing announces a cluster, so
    pass the address (`tcp://host:port`), the world size and this rank."""
    import torch.distributed as dist

    dist.init_process_group(backend=backend, init_method=init_method, world_size=world_size, rank=rank)


def _rank_world(group):
    import torch.distributed as dist

    return dist.get_rank(group), dist.get_world_size(group)


def split_range(n: int, rank: int, world: int) -> tuple:
    """The contiguous share [rank n / world, (rank + 1) n / world) of n items."""
    return rank * n // world, (rank + 1) * n // world


def slice_pool(states: PoolState, slots=None, lanes=None) -> PoolState:
    """A pool's slots [a, b) (a stacked pool's leading axis) and lanes [a, b)
    (the last axis of the per-lane leaves), as copies of their own."""
    kw = {}
    for k in POOL_FIELDS:
        v = getattr(states, k)
        if slots is not None:
            v = v[slots[0]:slots[1]]
        if lanes is not None and k not in REPLICATED:
            v = v[..., lanes[0]:lanes[1]]
        kw[k] = v.clone()
    return PoolState(**kw)


def _slice_params(params: SpawnerParams, a: int, b: int) -> SpawnerParams:
    """Slots [a, b) of stacked params; shared params as they are."""
    if not is_stacked_params(params):
        return params
    out = SpawnerParams(**{k: getattr(params, k)[a:b] for k in _PARAM_FIELDS})
    if "_members" in params.__dict__:
        out.__dict__["_members"] = params.__dict__["_members"][a:b]
    return out


def _slice_frames(frames: FrameInput, a: int, b: int) -> FrameInput:
    """Slots [a, b) of a stacked FrameInput."""
    ff = None if frames.force_fields is None else frames.force_fields[a:b]
    return FrameInput(**{k: getattr(frames, k)[a:b] for k in _FRAME_LEAVES}, force_fields=ff)


def shard_pool(state: PoolState, group=None) -> PoolState:
    """This rank's shard of a pool every rank of `group` holds whole: the
    per-lane leaves' contiguous lanes [r N / W, (r + 1) N / W), the scalar
    state replicated. Any capacity: shards differ by at most a lane."""
    r, w = _rank_world(group)
    return slice_pool(state, lanes=split_range(state.capacity, r, w))


def make_sharded_step(static: SpawnerStatic, group=None, prefer_fused: bool = None):
    """The sp step (the JAX module's `make_sharded_step`): returns
    step(params, colliders, state, frame, n_frames=1) -> (state, outputs)
    over this rank's shard (`shard_pool`) of one pool split over the ranks
    of `group` (None: the default group), params, colliders and frame
    replicated. The shard layout (lane base, global capacity) comes from
    one gather of the shards' capacities, once per capacity. n_frames > 1
    is a chain, stats on its last frame, the finished latch global on every
    one. Two layouts, as the JAX module's two routes:
      * the kernel's (global-only archetypes, unless prefer_fused is
        False): each launch is `fused_step` with this shard's arguments
        (kernel row 11) and the group, launches of `chain_unroll` frames (8
        on ring archetypes without colliders): the shard claims, draws and
        ranks as the unsharded pool's lanes do, and the outputs are the
        whole pool's on every rank. Dead-rank archetypes gather the shards'
        dead totals before every launch (each the sum of the claim's
        carried per-tile counts, `ops.fused_step.claim_counts`), and the
        dead offset, their exclusive prefix at this rank, stays a device
        tensor that the launch reads: no `.item()`, and under nccl nothing
        reaches the host (under gloo the gather itself crosses it); ring
        archetypes gather nothing before a launch;
      * the XLA layout (archetypes with a nested emitter, or any with
        prefer_fused False; the JAX module's GSPMD-jitted step, which it
        runs for nested archetypes on every mesh): each frame is
        `xla_step.step` with this shard and the group, whose words are
        `step.ShardExchange`'s, and the stitched shards equal the
        unsharded `xla_step.step` bit for bit.
    prefer_fused True on a nested archetype raises NotImplementedError
    (`NESTED_SHARD_MESSAGE`: the kernel's layout does not shard it)."""
    import torch.distributed as dist

    from .. import xla_step
    from ..ops.fused_step import chain_shape, chain_unroll, claim_counts, fused_step

    if prefer_fused and has_nested(static):
        raise NotImplementedError(NESTED_SHARD_MESSAGE)
    fused = prefer_fused if prefer_fused is not None else not has_nested(static)
    group = dist.group.WORLD if group is None else group  # fused_step reads None as "not sharded"
    rank = dist.get_rank(group)
    layouts = {}

    def layout(n: int) -> tuple:
        if n not in layouts:
            sizes = group_gather(group, torch.tensor([n], dtype=torch.int64)).view(-1).tolist()
            layouts[n] = (sum(sizes[:rank]), sum(sizes))
        return layouts[n]

    def shard_of(state: PoolState) -> Shard:
        lane_base, global_n = layout(state.capacity)
        dead_offset = 0
        if not static.ring_claim:
            dead = group_gather(group, claim_counts(state.alive).sum(dtype=torch.int32).reshape(1)).view(-1)
            dead_offset = dead[:rank].sum(dtype=torch.int32)
        return Shard(lane_base, global_n, dead_offset)

    def step(params, colliders, state, frame, n_frames: int = 1):
        if n_frames < 1:
            raise ValueError("the sharded step needs n_frames >= 1")
        if not fused:
            return xla_step.multi_step(static, params, colliders, state, frame, n_frames,
                                       shard=Shard(*layout(state.capacity)), group=group)
        shape = chain_shape(n_frames, chain_unroll(static, colliders))
        out = None
        for i, u in enumerate(shape):
            state, out = fused_step(static, params, colliders, state, frame, unroll=u, stats=i == len(shape) - 1,
                                    shard=shard_of(state), group=group)
        return state, out

    return step


def shard_fleet(states: PoolState, params: SpawnerParams, frames: FrameInput, group=None) -> tuple:
    """This rank's slots of a fleet every rank of `group` holds whole: the
    contiguous slots [r S / W, (r + 1) S / W) of the stacked pool, params
    (stacked, or shared as they are) and frames."""
    r, w = _rank_world(group)
    a, b = split_range(num_slots(states), r, w)
    return slice_pool(states, slots=(a, b)), _slice_params(params, a, b), _slice_frames(frames, a, b)


def make_fleet_step(static: SpawnerStatic, group=None):
    """The dp step (the JAX module's `make_fleet_step`): returns
    step(params, states, frames, n_frames=1) -> (states, outputs) over this
    rank's slots (`shard_fleet` with the same group): a
    `multi_step_fleet_stacked` chain of n_frames (kernel row 7; one frame
    is `step_auto_fleet`'s launch). Slots are independent, so the step runs
    no collective: the group only says which slots are this rank's, in
    `shard_fleet` (the parameter keeps the JAX signature's place of the
    mesh)."""
    from ..ops.fused_step import multi_step_fleet_stacked

    def step(params, states, frames, n_frames: int = 1):
        return multi_step_fleet_stacked(static, params, None, states, frames, n_frames)

    return step


@dataclasses.dataclass(frozen=True)
class Groups2D:
    """A rank's place on a hosts x chips layout (`make_groups_2d`): rank =
    host * chips_per_host + chip. fleet: the ranks of this chip index on
    every host (the JAX mesh's "host" axis); particle: this host's ranks
    (its "d" axis), over which each of the host's slots is sharded."""

    fleet: object
    particle: object
    host: int
    chip: int
    n_hosts: int
    chips_per_host: int


def make_groups_2d(n_hosts: int, chips_per_host: int) -> Groups2D:
    """This rank's fleet and particle groups on a hosts x chips layout of
    the default group's ranks (the JAX module's `make_mesh_2d`). Every rank
    must call it: each group is made by all ranks (`dist.new_group`)."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    if n_hosts * chips_per_host != world:
        raise ValueError(f"{n_hosts} hosts x {chips_per_host} chips != {world} ranks")
    rows = [dist.new_group([h * chips_per_host + c for c in range(chips_per_host)]) for h in range(n_hosts)]
    cols = [dist.new_group([h * chips_per_host + c for h in range(n_hosts)]) for c in range(chips_per_host)]
    host, chip = divmod(rank, chips_per_host)
    return Groups2D(cols[chip], rows[host], host, chip, n_hosts, chips_per_host)


def shard_fleet_2d(states: PoolState, params: SpawnerParams, frames: FrameInput, groups: Groups2D) -> tuple:
    """This rank's share of a fleet every rank holds whole: its host's
    contiguous slots [h S / H, (h + 1) S / H), and of each slot's pool its
    chip's lanes [c N / C, (c + 1) N / C)."""
    a, b = split_range(num_slots(states), groups.host, groups.n_hosts)
    lanes = split_range(states.capacity, groups.chip, groups.chips_per_host)
    return slice_pool(states, slots=(a, b), lanes=lanes), _slice_params(params, a, b), _slice_frames(frames, a, b)


def make_fleet_step_2d(static: SpawnerStatic, groups: Groups2D, prefer_fused: bool = None):
    """The 2D step (the JAX module's `make_fleet_step_2d`): returns
    step(params, states, frames, n_frames=1) -> (states, outputs) over this
    rank's share (`shard_fleet_2d`): each of its host's slots is a sharded
    pool stepped by `make_sharded_step` over the particle group with
    `prefer_fused` (the kernel's sharded launch per slot for global-only
    archetypes, the sharded XLA-layout step for nested ones or with
    prefer_fused False); nothing crosses the fleet group."""
    sharded = make_sharded_step(static, groups.particle, prefer_fused)

    def step(params, states, frames, n_frames: int = 1):
        res = [sharded(params_slot(params, i), None, state_slot(states, i), frame_slot(frames, i), n_frames)
               for i in range(num_slots(states))]
        return stack_pools([st for st, _o in res]), stack_outputs([o for _s, o in res])

    return step
