"""The per-frame step in the JAX package's XLA layout: spawn -> integrate ->
notify, composed torch on the state's device.

This is the counterpart of `bevy_firework_tpu.step` (`step`, `step_jit`,
`multi_step`), which the JAX package runs on every backend; its Pallas
kernel runs only behind `step_auto` / `multi_step_auto` on a TPU. The port
keeps the same split: `step`, `step_jit` and `multi_step` (the package's
top level) are this module on CPU and CUDA tensors alike, while
`step_auto`, `multi_step_auto`, the fleet and the `Scene` take the CUDA
kernel's layout (`step.advance`, Philox draws per lane) on both devices.

What follows the XLA step, and where the kernel's layout differs:
  * the key chain: new_key, frame_key = split(rng_key), one split per
    frame (a hybrid kernel frame splits twice);
  * draws: global emitter e draws uniform(fold_in(frame_key, e), (12, N)),
    twelve rows over the whole pool whatever fields the archetype elides
    (the rows of elided fields are not computed: the draw is counter
    based, so the others keep their values);
    nested emitter e draws its 8, 9 or 12 rows over the child buffer under
    fold_in(frame_key, 1000 + e) (`step.nested_child_rows`);
  * emitters run in declared order, one claim each, every claim seeing the
    spawns before it: a ring archetype's window [cursor, cursor + n) with
    the cursor advanced per emitter, any other archetype the exclusive dead
    rank below n, recomputed after each claim. Overflow (one frame asking
    for more than the pool) drops by claim order;
  * `alive` is the stored plane on every archetype (on ring archetypes the
    same set as age < lifetime, which `tests/test_torch_xla_step.py` holds);
  * nested emitters: counts from `compute_emission_count` per parent with
    the deferral through `emission_next_last`, the children's parents and
    dead slots from `monotone_inverse`, the rows written back by an index
    scatter that drops out-of-range slots, `last_emitted` reset to f32::MIN
    on claimed lanes. The write-back has a fixed shape: every child rank
    writes a plane of N + 1 lanes, the dropped ones into lane N, which is
    cut off (no boolean index: nothing waits on the card for a count).
The integrate half is `step.integrate`, shared with the kernel's plain
version, and the outputs are `step.epilogue`'s.

Captured (`step_jit` and `multi_step` on the card, `ops.chain_graph`'s
kind "xla"; the JAX package's jit over lax.scan): `chain_frame` is the
scan body, one frame whose inputs are all device tensors. Its frame comes
from a device frame row (`frame_from_row`) and its draw keys from the
chain's words (`prng.xla_chain_keys`: per frame the fold-ins of
`keyed_data`, computed on the host in one pass, read through
`prng.FrameKeyWords`); it reads no value on the host, so a graph of it
replays any dt, transform and key.

Sharded (`step(shard=, group=)`; the JAX package's GSPMD-jitted step,
which `parallel.sharding.make_sharded_step` runs for nested archetypes on
every mesh): each rank holds the lanes [lane_base, lane_base + n) of a pool
of global_n and steps them with the unsharded pool's semantics, bit for
bit: its global draws are its columns of the pool's (12, global_n) draw,
its ring windows and the cursor run over global lane indices and global_n,
its dead ranks start at the dead lanes of the ranks before it (every rank
derives every rank's dead count after each claim from one gather at the
frame's start), a nested emitter's count cumsum is offset by the ranks'
totals before it, and the child buffer M is the pool's. A child's parent
and its slot may lie on different ranks: the parent values travel in one
all-gather per nested emitter, bounded by M, merged by selection. The
words that cross ranks are `step.ShardExchange`'s.

XLA on the CPU rewrites and contracts some f32 expressions; where the
result feeds an integer (a spawn count, a death), this module computes them
as XLA does (`cadence.compute_emission_count_xla`,
`utils.f32.rem_euclid_fused`, `rand.sample_randf32_fused`), so
counts, claims and the cadence scalars equal the JAX step's on every frame.
The other f32 fields differ from it by XLA's contractions and its sin/cos
polynomials (a few ulp per frame; `tests/test_torch_xla_step.py` names the
tolerance).
"""

from __future__ import annotations

import numpy as np
import torch

from .cadence import compute_emission_count_xla, emission_next_last
from .compiled import MODE_GLOBAL, PACING_ON_DEMAND, PACING_ONE_SHOT, SpawnerParams, SpawnerStatic
from .emission_shape import sample_shape_comp
from .ops import table_layout as L
from .pool import FrameInput, PoolState
from .prng import FrameKeyWords, threefry_fold_in, threefry_split, threefry_uniform
from .rand import sample_randf32_fused, sample_randvec3_comp
from .step import (
    Shard,
    ShardExchange,
    active_f32_fields,
    active_flag,
    epilogue,
    has_nested,
    integrate,
    lifetime_of,
    nested_child_field_rows,
    nested_child_rows,
    nested_parent_fields,
    nested_m,
)
from .utils.f32 import F32_MIN, rem_euclid_fused
from .utils.quat import quat_rotate_comp

def monotone_inverse(cum: torch.Tensor, m: int) -> torch.Tensor:
    """For each query r = 0..m-1 of a non-decreasing int32 array, p(r) =
    #(cum <= r): the index of the first lane with cum > r, or len(cum). The
    JAX package's `_monotone_inverse` (its block counts and MXU row fetch
    are a TPU route to the same integers). int32 [m]."""
    r = torch.arange(m, dtype=cum.dtype, device=cum.device)
    return torch.searchsorted(cum, r, right=True, out_int32=True)


def global_lanes(alive: torch.Tensor, shard: Shard = None):
    """(the pool's lane index of each lane of `alive`, int32 [n]; the pool's
    capacity): lanes [0, n) of an unsharded pool, else the shard's
    [lane_base, lane_base + n) of a pool of global_n."""
    base, n = (0, alive.shape[0]) if shard is None else (shard.lane_base, shard.global_n)
    return torch.arange(base, base + alive.shape[0], dtype=torch.int32, device=alive.device), n


def dead_before(fields: dict, ex: ShardExchange) -> torch.Tensor:
    """A shard's dead lanes before its own: the exclusive prefix of the
    ranks' dead lanes (`fields["rank_dead"]`) at this rank, int32 0-d."""
    return fields["rank_dead"][:ex.rank].sum(dtype=torch.int32)


def take_dead(fields: dict, n_spawn) -> None:
    """A claim of the pool's first n_spawn dead lanes: rank r's dead lanes
    drop by clamp(n_spawn - (its dead prefix), 0, its dead lanes), so every
    rank knows every rank's count after each claim without a word sent."""
    dead = fields["rank_dead"]
    before = torch.cumsum(dead, 0, dtype=torch.int32) - dead
    fields["rank_dead"] = dead - torch.minimum((n_spawn - before).clamp_min(0), dead)


def claim_and_init(static: SpawnerStatic, params: SpawnerParams, frame: FrameInput, fields: dict, e: int, n_spawn,
                   uni, origin_pos, origin_rot, base_vel, shard: Shard = None, ex: ShardExchange = None):
    """Claim `n_spawn` dead slots for global emitter e and initialise them
    (the JAX package's `_claim_and_init`): a ring archetype takes the
    window [cursor, cursor + n) and advances the cursor, any other the dead
    lanes of exclusive dead rank below n; both masked by the dead plane, so
    overflow drops. `fields` is updated in place; returns the spawn mask.
    shard, ex (a sharded frame, `step`): these lanes are the shard's, so
    the ring window is over the pool's lane indices and capacity, and the
    dead rank starts at the ranks' dead lanes before this one
    (`fields["rank_dead"]`, updated for the claim)."""
    alive = fields["alive"]
    dead = ~alive
    if static.ring_claim:
        idx, n = global_lanes(alive, shard)
        dist = torch.remainder(idx - fields["ring_cursor"], n)
        spawn = dead & (dist < n_spawn)
        fields["ring_cursor"] = torch.remainder(fields["ring_cursor"] + n_spawn, n).to(torch.int32)
    else:
        di = dead.to(torch.int32)
        rank = torch.cumsum(di, 0, dtype=torch.int32) - di
        if shard is not None:
            rank = rank + dead_before(fields, ex)
            take_dead(fields, n_spawn)
        spawn = dead & (rank < n_spawn)
    ti = static.particle_indices[e]
    offx, offy, offz = sample_shape_comp(params.shape_params[e], uni[0], uni[1], uni[2])
    ivx, ivy, ivz = sample_randvec3_comp(params.ivel_params[e], uni[3], uni[4], uni[5])
    radial = sample_randf32_fused(uni[6], params.radial_lo[e], params.radial_hi[e])
    l2 = offx * offx + offy * offy + offz * offz
    inv = torch.where(l2 > 0, 1.0 / torch.sqrt(l2), torch.zeros_like(l2))
    rvx, rvy, rvz = offx * inv * radial, offy * inv * radial, offz * inv * radial
    wvx, wvy, wvz = quat_rotate_comp(*origin_rot, ivx, ivy, ivz)
    spd = frame.modifier_speed
    inh = params.inherit[e]
    new = {"px": origin_pos[0] + offx, "py": origin_pos[1] + offy, "pz": origin_pos[2] + offz,
           "vx": spd * (wvx + rvx) + inh * base_vel[0], "vy": spd * (wvy + rvy) + inh * base_vel[1],
           "vz": spd * (wvz + rvz) + inh * base_vel[2]}
    # elided fields hold their pool-wide invariant already; the draw shape
    # stays (12, N) either way
    if not static.elide_rotation:
        avx, avy, avz = sample_randvec3_comp(params.iangvel_params[e], uni[9], uni[10], uni[11])
        rot = params.init_rot[e]
        new.update(qx=rot[0], qy=rot[1], qz=rot[2], qw=rot[3], wx=avx, wy=avy, wz=avz)
    new["initial_scale"] = sample_randf32_fused(uni[7], params.initial_scale_lo[ti], params.initial_scale_hi[ti]) * \
        frame.modifier_scale
    new["age"] = torch.zeros((), dtype=torch.float32, device=alive.device)
    if static.const_lifetime is None:
        new["lifetime"] = sample_randf32_fused(uni[8], params.lifetime_lo[ti], params.lifetime_hi[ti])
    for k, v in new.items():
        fields[k] = torch.where(spawn, v, fields[k])
    if not static.single_type:
        fields["ptype"] = torch.where(spawn, torch.full_like(fields["ptype"], ti), fields["ptype"])
    fields["last_emitted"] = torch.where(spawn[None, :], torch.full_like(fields["last_emitted"], F32_MIN),
                                         fields["last_emitted"])
    fields["alive"] = alive | spawn
    return spawn


def write_children(plane: torch.Tensor, slot: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """`plane` with child rank r's value row[r] at lane slot[r], where
    slot[r] < len(plane); slot[r] == len(plane) drops it. A fixed-shape
    write: every rank writes a plane of N + 1 lanes, the dropped ones lane
    N, which is cut off (the kept slots are distinct), bit for bit the
    write of row[slot < N] into slot[slot < N] without its data-dependent
    shape. A new tensor; `plane` is not written."""
    n = plane.shape[0]
    return torch.cat([plane, plane.new_zeros(1)]).index_put_((slot.long(),), row)[:n]


def nested_spawn(static: SpawnerStatic, params: SpawnerParams, frame: FrameInput, fields: dict, e: int, cum, total,
                 frame_key, shard: Shard = None, ex: ShardExchange = None, rank_totals=None):
    """Nested emitter e's children (the JAX package's `_nested_spawn`, its
    write-back form): child rank r's parent is monotone_inverse(cum)[r]; on
    a ring archetype it takes slot (cursor + r) mod N if that slot is dead,
    else the r-th dead slot; at most the child buffer M per frame. The rows
    (`step.nested_child_rows`, its uniform ranges as XLA fuses them) are
    scattered into their slots; `fields` is updated in place. Returns the
    children dropped for want of a dead slot (int32 0-d).

    shard, ex, rank_totals (a sharded frame, `step`): cum is the pool's
    inclusive count cumsum over this shard's lanes, total the pool's and
    rank_totals each rank's children. A child's parent and its slot may lie
    on different ranks: each rank sends the parent values of the ranks
    whose parent it owns (`ShardExchange.parents`), every rank draws and
    builds all M rows from them, selected by the parent's owner, and writes
    those whose slot is its own; on the ring the slot's owner decides the
    take, and the ranks' taken counts give the pool's dropped children."""
    alive = fields["alive"]
    n_local = alive.shape[0]
    N = n_local if shard is None else shard.global_n
    M = nested_m(static, N)
    dev = alive.device
    dead = ~alive
    di = dead.to(torch.int32)
    n_spawn = total.clamp_max(M)
    rank_ids = torch.arange(M, dtype=torch.int32, device=dev)
    if shard is None:
        child_parent = monotone_inverse(cum, M).clamp(0, N - 1).long()
        parent = {k: fields[k][child_parent] for k in nested_parent_fields(static)}
    if static.ring_claim:
        cursor = fields["ring_cursor"]
        slot_raw = torch.remainder(cursor + rank_ids, N)
        if shard is None:
            take = (rank_ids < n_spawn) & dead[slot_raw.long()]
            slot = torch.where(take, slot_raw, N)
        else:
            local = slot_raw - shard.lane_base
            own = (local >= 0) & (local < n_local)
            take = (rank_ids < n_spawn) & own & dead[local.clamp(0, n_local - 1).long()]
            slot = torch.where(take, local, n_local)
        claimed = dead & (torch.remainder(global_lanes(alive, shard)[0] - cursor, N) < n_spawn)
        fields["ring_cursor"] = torch.remainder(cursor + n_spawn, N).to(torch.int32)
        took = take.sum(dtype=torch.int32)
        dropped = n_spawn - took  # sharded: this rank's take; the pool's from every rank's, below
    else:
        dead_cum = torch.cumsum(di, 0, dtype=torch.int32)
        if shard is None:
            claimed = dead & (dead_cum - di < n_spawn)
            slot = torch.where(rank_ids < n_spawn, monotone_inverse(dead_cum, M), N)
            dropped = n_spawn - torch.minimum(n_spawn, dead_cum[-1])
        else:
            before = dead_before(fields, ex)
            claimed = dead & (dead_cum - di + before < n_spawn)
            own = (rank_ids >= before) & (rank_ids < before + dead_cum[-1]) & (rank_ids < n_spawn)
            slot = torch.where(own, monotone_inverse(dead_cum + before, M), n_local)
            dropped = n_spawn - torch.minimum(n_spawn, fields["rank_dead"].sum(dtype=torch.int32))
            take_dead(fields, n_spawn)
            took = torch.zeros((), dtype=torch.int32, device=dev)  # not read: the dead ranks are global
    if shard is not None:
        first = rank_totals[:ex.rank].sum(dtype=torch.int32)
        mine = (rank_ids >= first) & (rank_ids < cum[-1])
        at = monotone_inverse(cum, M).clamp(0, n_local - 1).long()
        names = nested_parent_fields(static)
        values = torch.stack([torch.where(mine, fields[k][at], torch.zeros((), device=dev)) for k in names])
        every, took_by_rank = ex.parents(values, took)
        owner = torch.searchsorted(torch.cumsum(rank_totals, 0, dtype=torch.int32), rank_ids, right=True)
        owner = owner.clamp_max(ex.world - 1).long()
        parent = {k: every[owner, i, rank_ids.long()] for i, k in enumerate(names)}
        if nested_spawn.crossed is not None:  # the testing seam below (a host read)
            nested_spawn.crossed += int(((slot < n_local) & (owner != ex.rank)).sum())
        if static.ring_claim:
            dropped = n_spawn - took_by_rank.sum(dtype=torch.int32)
    rows = nested_child_rows(static, params, frame, e, parent, frame_key, M, fused=True)
    for k, row in zip(nested_child_field_rows(static), rows):
        fields[k] = write_children(fields[k], slot, row)
    ti = static.particle_indices[e]
    if not static.single_type:
        fields["ptype"] = torch.where(claimed, torch.full_like(fields["ptype"], ti), fields["ptype"])
    fields["alive"] = alive | claimed
    fields["last_emitted"] = torch.where(claimed[None, :], torch.full_like(fields["last_emitted"], F32_MIN),
                                         fields["last_emitted"])
    return dropped


# A testing seam: set to 0 to count, on this rank, the nested children that
# a sharded frame writes on it whose parent lies on another rank.
nested_spawn.crossed = None


def spawn_phase(static: SpawnerStatic, params: SpawnerParams, state: PoolState, frame: FrameInput,
                shard: Shard = None, ex: ShardExchange = None, frame_key=None):
    """spawn_particles (reference core.rs:367-551; the JAX package's
    `_spawn_phase` without its hybrid options): every emitter in declared
    order. Returns (fields, scal, new_key, (deferred, dropped)): fields the
    post-spawn pool planes (the active f32 fields, ptype, alive,
    last_emitted, ring_cursor; elided fields keep their pool-wide
    invariant in the state), scal the cadence scalars. shard, ex (a
    sharded frame, `step`): the pool's any-alive flag and the ranks' dead
    lanes come from `ex.frame_start`, global emitters draw their lanes'
    columns of the pool's (12, N) draw, and each nested emitter's count
    cumsum is offset by the ranks' totals before this one
    (`ex.count_totals`): deferred and dropped are the pool's. frame_key (a
    captured chain's frame, `chain_frame`): the frame's keys as device
    words (`prng.FrameKeyWords`); then the state's key is not split and
    new_key is None."""
    N = state.capacity if shard is None else shard.global_n
    dev = state.device
    dt = frame.dt
    fields = {k: getattr(state, k) for k in active_f32_fields(static)}
    fields.update(ptype=state.ptype, alive=state.alive, last_emitted=state.last_emitted,
                  ring_cursor=state.ring_cursor)
    if shard is None:
        any_alive = state.alive.any()
    elif has_nested(static) or not static.ring_claim:
        any_alive, fields["rank_dead"] = ex.frame_start(state.alive)
    else:
        any_alive = None  # unused by a global-only archetype's active flag
    cols = None if shard is None else (shard.lane_base, shard.lane_base + state.capacity)
    active = active_flag(static, state.enabled, any_alive)
    new_key = None
    if frame_key is None:
        new_key, frame_key = threefry_split(state.rng_key.numpy())
    tic, last, enabled, queued = state.time_in_cycle, state.last_emission, state.enabled, state.manual_queued
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    deferred = dropped = zero
    g_pos = tuple(frame.transform_translation[i] for i in range(3))
    g_rot = tuple(frame.transform_rotation[i] for i in range(4))
    g_vel = tuple(frame.parent_velocity[i] for i in range(3))
    for e in range(static.num_emitters):
        gate = active & enabled[e]
        if static.mode_kinds[e] == MODE_GLOBAL:
            # rows 0-7 shape, velocity, radial, scale; 8 lifetime, 9-11
            # angular velocity where live (the rest of the (12, N) draw,
            # which the JAX step draws and drops, is never read)
            rows = list(range(8)) + ([8] if static.const_lifetime is None else []) + (
                [] if static.elide_rotation else [9, 10, 11])
            uni = dict(zip(rows, threefry_uniform(threefry_fold_in(frame_key, e), (12, N), dev, rows=rows,
                                                  cols=cols)))
            pk = static.pacing_kinds[e]
            if pk == PACING_ONE_SHOT:
                n_spawn = torch.where(gate, params.count[e].to(torch.int32), zero)
                enabled = enabled.clone()
                enabled[e] = enabled[e] & ~gate  # the burst disables its emitter
            elif pk == PACING_ON_DEMAND:
                n_spawn = torch.where(gate, queued, zero)
                queued = torch.where(gate, zero, queued)
            else:  # rate / CountOverDuration
                t = rem_euclid_fused(tic[e] + dt, params.duration[e])
                cnt, next_last = compute_emission_count_xla(t, last[e], params.duration[e], params.off_start[e],
                                                            params.off_end[e], params.count[e])
                n_spawn = torch.where(gate, cnt, zero)
                tic = tic.clone()
                last = last.clone()
                tic[e] = torch.where(gate, t, tic[e])
                last[e] = torch.where(gate, next_last, last[e])
            claim_and_init(static, params, frame, fields, e, n_spawn, uni, g_pos, g_rot, g_vel, shard, ex)
            continue
        if not static.nested_valid[e]:  # an invalid pacing never emits (core.rs:481-484)
            continue
        M = nested_m(static, N)
        alive, lifetime = fields["alive"], lifetime_of(static, fields)
        parent_mask = alive & (fields["ptype"] == static.target_types[e]) & gate
        base_le = fields["last_emitted"][e]
        off_s, off_e, per = params.off_start[e], params.off_end[e], params.count[e]
        counts, next_last = compute_emission_count_xla(fields["age"], base_le, lifetime, off_s, off_e, per)
        counts = torch.where(parent_mask, counts, torch.zeros_like(counts))
        cum = torch.cumsum(counts, 0, dtype=torch.int32)
        rank_totals = None
        if shard is None:
            total = cum[-1]
        else:
            rank_totals = ex.count_totals(cum[-1])
            cum = cum + rank_totals[:ex.rank].sum(dtype=torch.int32)
            total = rank_totals.sum(dtype=torch.int32)
        emitted = cum.clamp_max(M) - (cum - counts).clamp_max(M)
        next_last = torch.where(emitted < counts,
                                emission_next_last(base_le, lifetime, off_s, off_e, per, emitted, fused=True),
                                next_last)
        deferred = deferred + (total - total.clamp_max(M))
        le = fields["last_emitted"].clone()
        le[e] = torch.where(parent_mask, next_last, base_le)
        fields["last_emitted"] = le
        dropped = dropped + nested_spawn(static, params, frame, fields, e, cum, total, frame_key, shard, ex,
                                         rank_totals)
    fields.pop("rank_dead", None)
    scal = {"time_in_cycle": tic, "last_emission": last, "enabled": enabled, "manual_queued": queued,
            "ring_cursor": fields.pop("ring_cursor")}
    return fields, scal, new_key, (deferred, dropped)


def _exchange(state: PoolState, shard: Shard, group):
    """The sharded frame's exchange, or None unsharded; a shard without its
    group (or a group without a shard) raises: the pool's counts and claims
    need every rank's words."""
    if (shard is None) != (group is None):
        raise ValueError("a sharded XLA-layout step needs both the shard and its process group")
    if shard is None:
        return None
    if shard.lane_base + state.capacity > shard.global_n:
        raise ValueError(f"{shard} cannot hold {state.capacity} lanes")
    return ShardExchange(group)


def step(static: SpawnerStatic, params: SpawnerParams, colliders, state: PoolState, frame: FrameInput,
         stats: bool = True, shard: Shard = None, group=None, frame_key=None):
    """Advance one spawner's pool by one frame in the XLA layout, on the
    state's device (the JAX package's `step`). Returns (new_state,
    StepOutputs, or None without `stats`). shard, group (the JAX package's
    GSPMD step over a mesh, on a torch.distributed group): `state` is this
    rank's shard (`parallel.sharding.shard_pool`) of a pool split over the
    group's ranks, the lanes [shard.lane_base, + capacity) of shard.global_n
    (its dead_offset is not read: the frame counts dead lanes itself); the
    frame's claims, draws, nested children and outputs are the unsharded
    pool's, the collectives those of `ShardExchange`. frame_key: the
    frame's keys as device words (`chain_frame`); the state's rng_key then
    passes through (the chain's host key chain gives the next)."""
    ex = _exchange(state, shard, group)
    fields, scal, new_key, (deferred, dropped) = spawn_phase(static, params, state, frame, shard, ex, frame_key)
    last_emitted = fields.pop("last_emitted")
    f, survivor, dump = integrate(static, params, fields, fields["ptype"], fields["alive"], frame, colliders)
    f["alive"] = survivor
    key = state.rng_key if new_key is None else torch.as_tensor(new_key.astype(np.int64))
    return epilogue(static, params, state, f, scal, key, stats, dump, last_emitted=last_emitted,
                    nested_counts=lambda: (deferred, dropped), group=group)


def multi_step(static: SpawnerStatic, params: SpawnerParams, colliders, state: PoolState, frame: FrameInput,
               n_frames: int, shard: Shard = None, group=None):
    """n_frames frames of `step` with one frame input (the JAX package's
    `multi_step`, its scan), one by one: the final state and the last
    frame's outputs; ValueError below one frame. The top-level
    `multi_step` replays this as a captured graph on the card
    (`ops.chain_graph`, kind "xla"); this is its uncaptured form.
    shard, group: as `step`, every frame. The sharded form stays
    uncaptured: its gloo collectives cross the host every frame."""
    if n_frames < 1:
        raise ValueError("multi_step needs n_frames >= 1")
    for _ in range(n_frames - 1):
        state, _out = step(static, params, colliders, state, frame, stats=False, shard=shard, group=group)
    return step(static, params, colliders, state, frame, shard=shard, group=group)


def keyed_data(static: SpawnerStatic) -> tuple:
    """The fold-ins a frame draws under, in emitter order (`spawn_phase`):
    e for global emitter e, 1000 + e for valid nested emitter e. A
    captured chain's words hold, per frame, fold_in(frame_key, d) for each
    (`prng.xla_chain_keys`)."""
    return tuple(e if static.mode_kinds[e] == MODE_GLOBAL else 1000 + e for e in range(static.num_emitters)
                 if static.mode_kinds[e] == MODE_GLOBAL or static.nested_valid[e])


def frame_from_row(row: torch.Tensor, force_fields=None) -> FrameInput:
    """The FrameInput of a frame row (f32 [FRAME_WORDS] in the kernels'
    layout, `ops.fused_step._frame_row`), every leaf a view of the row on
    its device: a captured graph reads the frame that each replay copies
    in."""
    return FrameInput(dt=row[L.FR_DT], transform_translation=row[L.FR_TRANS:L.FR_TRANS + 3],
                      transform_rotation=row[L.FR_ROT:L.FR_ROT + 4], parent_velocity=row[L.FR_PVEL:L.FR_PVEL + 3],
                      modifier_scale=row[L.FR_MOD_SCALE], modifier_speed=row[L.FR_MOD_SPEED],
                      force_fields=force_fields)


def chain_frame(static: SpawnerStatic, params: SpawnerParams, colliders, state: PoolState, frame_row: torch.Tensor,
                force_fields, words: torch.Tensor, stats: bool = True):
    """One frame of `step` as a captured chain replays it (the JAX
    package's scan body): the frame from the device frame row
    (`frame_from_row`), its keys from row t of the chain's words, t then
    advanced in place. words: int32 [1 + R * W] on the pool's device, word
    0 the frame index t, then R rows of W = 2 * len(keyed_data(static))
    words (`prng.xla_chain_keys`, frame by frame). Returns what `step`
    returns, bit for bit, with the state's rng_key passed through; no value
    is read on the host."""
    data = keyed_data(static)
    w = 2 * len(data)
    row = words[1:].view(-1, w).index_select(0, words[:1].long())[0] if w else words[:0]
    out = step(static, params, colliders, state, frame_from_row(frame_row, force_fields), stats,
               frame_key=FrameKeyWords(data, row))
    words[:1].add_(1)
    return out
