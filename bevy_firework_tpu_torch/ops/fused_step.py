"""The fused step: the CUDA kernel wrappers and the dispatch around them.

`fused_step` advances a pool by U <= 8 frames in one launch of the
hand-written Hopper kernel (`csrc/fused_step_kernel.cuh`, which replaces the JAX
package's Pallas `_make_kernel` with its main-path, render-pack, collision,
dead-rank-claim, force-field, dump, kernel-stats and nested-merge blocks),
optionally writing the render-pack planes of the last frame.
Destroy-on-collision archetypes claim by dead-slot rank (kernel row 4): a
solo launch takes the per-tile dead counts of its alive plane that the
launch which wrote the plane left (`claim_counts`; the first frame, or a
plane edited since, is counted first by the seed's count kernel), so a
chain of destroy frames is one launch a frame; fleet and hybrid launches
run the claim's count and scan kernels first (`tile_dead_offsets`). Scene
force fields ride the frame input (`FrameInput.force_fields`); their records
go to the card once per table (`kernel_fields`); archetypes with a destroyed
handler get the dump plane (`StepOutputs.destroyed_mask`).

Archetypes with a nested emitter step hybrid frames (`fused_step_hybrid`,
the JAX package's hybrid with its in-kernel merge): per valid nested
emitter one launch of the nested-stage kernel (`nested_stage`: the cadence
pass of kernel row 8 and the child rows of row 9b, threefry draws, the XLA
child stage of the JAX package), then one step launch whose merge block
(row 9) places the children before the global claim (a frame without
colliders or force fields takes the merge's own instantiations,
`merge_lean`, whose latch leaves the post-frame any-alive word, the
finished event and finished_notified, with the ring's alive plane, for
the epilogue); `nested_cadence_pass` and `nested_child_rows` run the
same kernel's pass or child rows alone.
The frame's nested scalars (totals, children, windows, drops, the
pre-spawn alive flag) stay in one device buffer (`table_layout` NS_*) that
the kernels read and write: no frame waits on the card. A chain of n >= 2
such frames on a ring archetype folds the cadence (`chain_nested_folded`,
as the JAX package's `multi_step_auto` does; `can_fold_nested`): a seed of
one count kernel per nested emitter, then every frame's step launch but
the last also counts the next frame's parents on its post-frame state
(the fold epilogue, kernel row 10) into a `FoldCarry`, whose tile counts
the next frame's nested stage reduces in place of counting its lanes and
waiting at its grid barrier. The unfolded chain stays callable
(`chain_hybrid_unfolded`); both give the same bits.

A pool split over the particle axis steps shard by shard (`fused_step(...,
shard=...)`, kernel row 11, the JAX package's sharded claims): each shard's
launch takes its lane base, the global capacity and its dead offset, so it
claims, ranks and draws as the unsharded pool's lanes do;
`parallel.sharding.make_sharded_step` adds the process group whose epilogue
collective makes the outputs the whole pool's. Archetypes with a nested
emitter do not shard in this layout (`step.NESTED_SHARD_MESSAGE`), as the
JAX package's Pallas kernel does not: `make_sharded_step` steps them in the
XLA layout (`xla_step.step(shard=, group=)`).

Dispatch is by the device of the pool's tensors and nothing else:
  * CUDA tensors: the kernels are launched, or the call raises;
  * CPU tensors: the plain PyTorch versions (`step.plain_frames` over U
    frames or one `step.hybrid_frame`, `step.nested_stage`,
    `step.nested_cadence`, `step.nested_child_rows`, `step.nested_fold_carry`,
    `render.pack_render_planes`, `step.dead_tile_counts` and
    `tile_dead_offsets`' cumsum), which keep
    the kernels' op order and random-bit layout.
The kernel's tables are sized from the spawner and the scene, so the card
takes every count of emitters, types, knots, colliders and force fields
that the CPU takes; nothing falls back. The card's narrow phase skips, per
warp and substep, the colliders no active lane can reach (the JAX package's
looped form, which it takes from LOOP_MIN_COLLIDERS colliders; the skip's
plain version is `collision.broad_phase_keep`).

On the card the chains (`multi_step_auto`, `multi_step_auto_packed`,
`multi_step_fleet_stacked`, `multi_step_fleet`) are captured CUDA graphs
(`chain_graph`): their launches read the frame row, the draw seeds and the
nested stages' keys from device words (`DeviceWords`, `device_words`) in
place of their by-value arguments, which a graph would freeze; the
kernels give the same bits either way.

The stats of a frame (AABB, alive and per-type counts): on the card the
kernel's stats block writes them in one row whenever they are asked for, and
the epilogue only updates the finished latch; on the CPU the torch
reductions of `step.epilogue` (the block's plain version) compute them.
`multi_step_auto` asks for them on the last frame only; earlier launches of
a chain update just the finished latch.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import weakref
from typing import Optional

import numpy as np
import torch

from ..colliders import COLLIDER_HULL, ColliderTable, masked_layers
from ..collision import LOOP_MIN_COLLIDERS, bounding_radius
from ..compiled import SpawnerParams, SpawnerStatic
from ..parallel.sharding import (
    frame_slot,
    is_stacked_params,
    num_slots,
    params_slot,
    stack_outputs,
    stack_pools,
    state_slot,
)
from ..pool import FrameInput, PoolState
from ..prng import frame_seeds, frame_seeds_stacked, threefry_fold_in, threefry_split
from ..render import pack_render_planes
from ..utils.device import upload
from ..step import (
    NESTED_SHARD_MESSAGE,
    Shard,
    active_f32_fields,
    collision_on,
    dead_tile_counts,
    epilogue,
    fields_on,
    has_nested,
    hybrid_frame,
    nested_cadence,
    nested_child_field_rows,
    nested_draw_rows,
    nested_emitters,
    nested_fold_carry,
    nested_m,
    nested_parent_fields,
    nested_parents,
    plain_frames,
)
from ..step import nested_child_rows as plain_child_rows
from ..step import nested_stage as plain_stage
from . import table_layout as L

MAX_UNROLL = L.MAX_U
# Frames per launch of a chain with colliders: the JAX package's
# _chain_with_unroll caps collision archetypes at U = 2, a TPU measurement
# (its narrow phase is VPU-code bound), kept here for equal launch counts.
COLLISION_UNROLL = 2


def can_fuse(static: SpawnerStatic) -> bool:
    """Global-only archetypes (the JAX package's fused-path condition)."""
    return not has_nested(static)


def can_unroll(static: SpawnerStatic) -> bool:
    """U frames per launch are sound where every cross-frame dependency
    lives in the fields and scalars: global emitters only (a nested frame's
    cadence passes and child stage run between launches), ring claims,
    derived alive, no dump (whose mask is per frame)."""
    return can_fuse(static) and static.derived_alive


def looped_form(static: SpawnerStatic, colliders) -> bool:
    """The JAX package's narrow phase takes its looped form with the broad
    phase (LOOP_MIN_COLLIDERS colliders or more; below, its unrolled form).
    The card's narrow phase runs its per-warp broad phase at every count;
    the launch counters split its launches by the reference's two forms."""
    return collision_on(static, colliders) and colliders.count >= LOOP_MIN_COLLIDERS


_SCRATCH: dict = {}


def _stream_scratch(kind: str, device, stream: int, words: int, dtype) -> torch.Tensor:
    key = (kind, torch.device(device), int(stream))
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        buf = _SCRATCH[key] = torch.zeros(words, dtype=dtype, device=device)
    return buf[:words]


def stats_scratch(device, stream: int, words: int) -> torch.Tensor:
    """The stats block's accumulators and tickets for launches on `stream`
    (its handle) of `device`: `words` int32 words that are 0 between
    launches (the last block of a launch decodes its slot's words into the
    stats row and zeroes them and the ticket). Made once per (device,
    stream) and grown, zeroed, when a launch needs more words; launches on
    one stream run in order, so they share it, and two streams get two."""
    return _stream_scratch("stats", device, stream, words, torch.int32)


def nested_scratch(device, stream: int) -> torch.Tensor:
    """The nested stage's scratch for launches on `stream` of `device`: 2 +
    MAX_BLOCKS int32 words, its grid barrier's arrival count (0 between
    launches: the last block to arrive zeroes it) and generation, then one
    sum per block; made once per (device, stream) and kept, as
    `stats_scratch`."""
    return _stream_scratch("nested", device, stream, 2 + L.MAX_BLOCKS, torch.int32)


def merge_scratch(device, stream: int) -> torch.Tensor:
    """The merge launches' latch scratch for launches on `stream` of
    `device`: 2 int32 words at the start of an allocation (one 64-bit word
    to the kernel: the blocks' any-alive votes and their tickets; 0
    between launches: the last block zeroes it); made once per (device,
    stream) and kept, as `stats_scratch`."""
    return _stream_scratch("merge", device, stream, 2, torch.int32)


def prepare_stream_scratch(device, stream: int, slots: int, num_types: int) -> None:
    """Make the scratch of every kind for launches of `slots` slots (1 for
    a solo pool) of `num_types` types on `stream` of `device`, sized for
    them, before a chain is captured there (an allocation made during
    capture would come from the graph's pool)."""
    stats_scratch(device, stream, slots * (L.stats_words(num_types) + 1))
    nested_scratch(device, stream)
    merge_scratch(device, stream)


def release_stream_scratch(device, stream: int) -> list:
    """Forget the scratch of `stream` of `device` (the buffers a captured
    chain recorded: its graph keeps them, and the next launches on that
    stream make their own); returns the buffers."""
    return [_SCRATCH.pop(k) for k in list(_SCRATCH) if k[1] == torch.device(device) and k[2] == int(stream)]


class DeviceWords:
    """The frame rows, draw seeds and nested-stage keys of a run of
    launches, in the order the launches take them, as device words: the
    launches read them in place of their by-value arguments (a captured
    chain's replays copy new words in before each replay; the kernels'
    by-value and device-word launches give the same bits). `words` (uint32
    on the host) are what the launches must ask for, in that order: each
    launch's request is checked against them, so a chain whose launches
    would consume another sequence raises. `buf`: int32 device words of the
    same length."""

    def __init__(self, words: np.ndarray, buf: torch.Tensor):
        if buf.dtype != torch.int32 or buf.dim() != 1 or buf.numel() != words.size:
            raise ValueError(f"device words: an int32 buffer of {words.size} words, got {buf.dtype} {tuple(buf.shape)}")
        self.words, self.buf, self.at = np.asarray(words, np.uint32), buf, 0

    @classmethod
    def upload(cls, words: np.ndarray, device) -> "DeviceWords":
        """`words` copied to a new buffer on `device`."""
        words = np.ascontiguousarray(words, np.uint32)
        return cls(words, upload(torch.from_numpy(words.view(np.int32).copy()), torch.device(device)))

    def take(self, host_words) -> int:
        """The device address of the next len(host_words) words, which must
        equal them."""
        host_words = np.asarray(host_words).astype(np.uint32).reshape(-1)
        k = host_words.size
        if not np.array_equal(self.words[self.at:self.at + k], host_words):
            raise RuntimeError(f"device words: a launch asked for {host_words.tolist()} at word {self.at}, the "
                               f"chain's words hold {self.words[self.at:self.at + k].tolist()}")
        ptr = self.buf.data_ptr() + 4 * self.at
        self.at += k
        return ptr

    def check_done(self) -> None:
        if self.at != self.words.size:
            raise RuntimeError(f"device words: the launches took {self.at} of {self.words.size} words")


_DEVICE_WORDS: Optional[DeviceWords] = None


@contextlib.contextmanager
def device_words(words: DeviceWords):
    """Launches in this block read their frame rows, seeds and nested keys
    from `words` (`DeviceWords`), in order, and every word must be taken."""
    global _DEVICE_WORDS
    prev, _DEVICE_WORDS = _DEVICE_WORDS, words
    try:
        yield words
    finally:
        _DEVICE_WORDS = prev
    words.check_done()


def merge_lean(static: SpawnerStatic, colliders, frame: FrameInput) -> bool:
    """A hybrid frame's step launch takes the merge's own instantiations
    (`fused_step_kernel_merge`: no narrow phase, no field block, the
    cadence on warp 0's lanes): no collider table that the narrow phase
    runs, no force fields and at most 32 emitters. Other hybrid frames take
    `fused_step_kernel`'s merge instantiations."""
    return not collision_on(static, colliders) and not fields_on(frame) and static.num_emitters <= 32


def check_kernel_scope(static: SpawnerStatic, unroll: int = 1) -> None:
    """Raise ValueError for an unroll the archetype cannot take. The tables
    are sized from the spawner and the scene, so every count the plain
    version takes, the kernel takes too."""
    if not 1 <= unroll <= MAX_UNROLL:
        raise ValueError(f"unroll must be in 1..{MAX_UNROLL}, got {unroll}")
    if unroll > 1 and not can_unroll(static):
        raise ValueError("unroll > 1 needs global emitters only, ring claims and no destroyed handler "
                         "(nested, destroy-on-collision and dump archetypes step one frame per launch)")


def pack_tables(static: SpawnerStatic, params: SpawnerParams) -> np.ndarray:
    """The kernel's table buffer (int32 words, f32 values stored bitwise),
    sized by its emitters, types and knots (`table_layout.table_words`): a
    header with the counts and the row offsets that follow from them, then
    type rows, emitter rows and per type a block of curve rows, at the slots
    `table_layout` names."""
    p = params.to_numpy()
    K = p["scale_ts"].shape[1]
    E, T = static.num_emitters, static.num_types
    em_at = L.TY_AT + T * L.TY_STRIDE
    cv_at = em_at + E * L.EM_STRIDE
    words = np.zeros(L.table_words(E, T, K), np.int32)
    fl = words.view(np.float32)
    words[[L.H_E, L.H_T, L.H_K, L.H_SINGLE, L.H_ELIDE_ROT, L.H_CONST_LIFE, L.H_EM_AT, L.H_CV_AT]] = [
        E, T, K, int(static.single_type), int(static.elide_rotation), int(static.const_lifetime is not None), em_at,
        cv_at]
    fl[L.H_CONST_LIFE_VAL] = 0.0 if static.const_lifetime is None else static.const_lifetime
    emitter_slots = ((L.EM_COUNT, "count"), (L.EM_DURATION, "duration"), (L.EM_OFF_START, "off_start"),
                     (L.EM_OFF_END, "off_end"), (L.EM_SHAPE, "shape_params"), (L.EM_IVEL, "ivel_params"),
                     (L.EM_IANG, "iangvel_params"), (L.EM_RADIAL_LO, "radial_lo"), (L.EM_RADIAL_HI, "radial_hi"),
                     (L.EM_INHERIT, "inherit"), (L.EM_INIT_ROT, "init_rot"))
    type_slots = ((L.TY_ISCALE_LO, "initial_scale_lo"), (L.TY_ISCALE_HI, "initial_scale_hi"),
                  (L.TY_LIFE_LO, "lifetime_lo"), (L.TY_LIFE_HI, "lifetime_hi"), (L.TY_ACCEL, "acceleration"),
                  (L.TY_LIN_DRAG, "linear_drag"), (L.TY_ANG_ACCEL, "angular_acceleration"),
                  (L.TY_ANG_DRAG, "angular_drag"), (L.TY_RESTITUTION, "restitution"), (L.TY_FRICTION, "friction"),
                  (L.TY_DESTROY, "destroy_on_collision"), (L.TY_FIELD_MASK, "field_mask"))

    def put(at, value):
        v = np.atleast_1d(value)
        fl[at:at + v.size] = v

    for e in range(E):
        row = em_at + e * L.EM_STRIDE
        for slot, name in emitter_slots:
            put(row + slot, p[name][e])
        words[[row + L.EM_PACING, row + L.EM_PINDEX, row + L.EM_MODE, row + L.EM_TARGET]] = [
            static.pacing_kinds[e], static.particle_indices[e], static.mode_kinds[e], static.target_types[e]]
    for t in range(T):
        row = L.TY_AT + t * L.TY_STRIDE
        for slot, name in type_slots:
            put(row + slot, p[name][t])
        words[row + L.TY_COLL_MASK] = np.uint32(p["collision_mask"][t]).view(np.int32)
        (k, n), (bk, bn, ek, en) = static.scale_curve_meta[t], static.color_curve_meta[t]
        words[[row + s for s in (L.TY_SCALE_KIND, L.TY_SCALE_N, L.TY_BASE_KIND, L.TY_BASE_N, L.TY_EMIS_KIND,
                                 L.TY_EMIS_N, L.TY_HAS_COL, L.TY_DUMP)]] = [
            k, n, bk, bn, ek, en, int(static.collision_types[t]), int(static.destroyed_dump_types[t])]
        curve_rows = {L.CV_SCALE_TS: p["scale_ts"][t], L.CV_SCALE_VS: p["scale_vs"][t],
                      L.CV_BASE_TS: p["base_ts"][t], L.CV_EMIS_TS: p["emis_ts"][t]}
        for c in range(4):
            curve_rows[L.CV_BASE_TS + 1 + c] = p["base_vs"][t][:, c]
            curve_rows[L.CV_EMIS_TS + 1 + c] = p["emis_vs"][t][:, c]
        for r, vals in curve_rows.items():
            put(cv_at + (t * L.CV_ROWS + r) * K, vals)
    return words


def kernel_tables(static: SpawnerStatic, params: SpawnerParams) -> torch.Tensor:
    """`pack_tables` on the params' device, built once per (params, static)
    and kept in the params object (a frozen dataclass; the cache lives in
    its __dict__, beside the fields it is derived from). Stacked params
    (a fleet's) give [S, words]: their members' tables stacked, or one
    table packed per slot (one archetype: one size). The copy to the card
    does not wait."""
    cache = params.__dict__.setdefault("_kernel_tables", {})
    if static not in cache:
        if not is_stacked_params(params):
            cache[static] = upload(torch.from_numpy(pack_tables(static, params)), params.device)
        elif "_members" in params.__dict__:
            cache[static] = torch.stack([kernel_tables(static, p) for p in params.__dict__["_members"]])
        else:
            rows = [pack_tables(static, params_slot(params, i)) for i in range(params.count.shape[0])]
            cache[static] = upload(torch.from_numpy(np.stack(rows)), params.device)
    return cache[static]


def pack_colliders(colliders: ColliderTable) -> np.ndarray:
    """The kernel's collider table (int32 words, f32 values stored bitwise):
    one row per collider at the slots `table_layout` names, then each
    hull's own plane rows, which its row points to (CO_PLANES). Each row
    carries the broad phase's bounding radius (`collision.bounding_radius`,
    f32). Disabled colliders carry layers 0 (`masked_layers`); the uint32
    layers keep their bits."""
    C = colliders.count
    words = np.zeros(C * L.CO_STRIDE + 4 * sum(colliders.hull_counts), np.int32)
    fl = words.view(np.float32)
    pos, rot, par = (getattr(colliders, k).cpu().numpy() for k in ("position", "rotation", "params"))
    layers = masked_layers(colliders).cpu().numpy().astype(np.uint32).view(np.int32)
    planes = colliders.hull_planes.cpu().numpy()
    at = C * L.CO_STRIDE
    for ci, kind in enumerate(colliders.kinds):
        row = ci * L.CO_STRIDE
        words[row + L.CO_KIND] = kind
        words[row + L.CO_IDENT] = int(colliders.identity_rot[ci])
        words[row + L.CO_HULL_N] = colliders.hull_counts[ci]
        words[row + L.CO_LAYERS] = layers[ci]
        fl[row + L.CO_POS:row + L.CO_POS + 3] = pos[ci]
        fl[row + L.CO_ROT:row + L.CO_ROT + 4] = rot[ci]
        fl[row + L.CO_PARAMS:row + L.CO_PARAMS + 3] = par[ci]
        fl[row + L.CO_RADIUS] = bounding_radius(kind, *par[ci])
        if kind == COLLIDER_HULL:
            n = colliders.hull_counts[ci]
            words[row + L.CO_PLANES] = at
            fl[at:at + 4 * n] = planes[ci, :n].reshape(-1)
            at += 4 * n
    return words


def kernel_colliders(colliders: ColliderTable) -> torch.Tensor:
    """`pack_colliders` on the table's device, built once per table and kept
    in it (a frozen dataclass; the cache lives in its __dict__)."""
    if "_kernel_colliders" not in colliders.__dict__:
        colliders.__dict__["_kernel_colliders"] = torch.from_numpy(pack_colliders(colliders)).to(colliders.device)
    return colliders.__dict__["_kernel_colliders"]


def pack_fields(table) -> np.ndarray:
    """The kernel's force-field records (int32 words, f32 values stored
    bitwise): one FF_STRIDE record per field at the slots `table_layout`
    names, from the table's host rows, with the lane-invariant factors of
    `force_fields.field_accel` (strength * active, 1 / radius) rounded in
    f32 as the plain version rounds them."""
    words = np.zeros(table.count * L.FF_STRIDE, np.int32)
    fl = words.view(np.float32)
    rows = table.rows
    for i, kind in enumerate(table.kinds):
        at = i * L.FF_STRIDE
        words[at + L.FF_KIND] = kind
        fl[at + L.FF_POS:at + L.FF_POS + 3] = rows["position"][i]
        fl[at + L.FF_AXIS:at + L.FF_AXIS + 3] = rows["axis"][i]
        fl[at + L.FF_PARAMS:at + L.FF_PARAMS + 4] = rows["params"][i]
        fl[at + L.FF_ACTIVE] = rows["active"][i]
        fl[at + L.FF_STRENGTH] = rows["params"][i, 0] * rows["active"][i]
        fl[at + L.FF_INV_RADIUS] = np.float32(1.0) / rows["params"][i, 1]
    return words


def kernel_fields(table) -> torch.Tensor:
    """`pack_fields` on the table's device, built once per table and kept in
    it; the copy to the card does not wait (a Scene that moves a field
    builds a new table, and so one copy, per edited frame)."""
    if "_kernel_fields" not in table.__dict__:
        table.__dict__["_kernel_fields"] = upload(torch.from_numpy(pack_fields(table)), table.device)
    return table.__dict__["_kernel_fields"]


# the floats of magnitude below the field block's cos_fast bound: the bit
# patterns [0, COS_FAST_BITS) on either sign
COS_FAST_BITS = int(np.float32(L.COS_FAST_BOUND).view(np.uint32))


def cos_fast_mismatches(device="cuda") -> int:
    """How many floats below the field block's cos_fast bound (both signs,
    2 * COS_FAST_BITS of them) its cos_fast maps to other bits than CUDA's
    cosf (`bf_cos_fast_mismatches` on the card): 0 when the turbulence's
    straight-line cosines are cosf's own. Needs a CUDA device; the field
    block's plain version has no such split."""
    from . import _build

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("cos_fast_mismatches compares two CUDA device functions: it needs a CUDA device")
    lib = _build.load()
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    for lo in (0, 0x80000000):
        rc = lib.bf_cos_fast_mismatches(lo, COS_FAST_BITS, bad.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"cos_fast sweep failed to launch: {lib.bf_error_string(rc).decode()}")
    return int(bad.item())


def stats_from_row(static: SpawnerStatic, row: torch.Tensor):
    """(aabb_min, aabb_max, alive count, per-type counts) from the kernel's
    stats row ([stats_words(T)], or a fleet's [S, stats_words(T)]:
    [S]-leading)."""
    f = row.view(torch.float32)
    return (f[..., L.ST_MIN:L.ST_MIN + 3], f[..., L.ST_MAX:L.ST_MAX + 3], row[..., L.ST_ALIVE],
            row[..., L.ST_TYPES:L.ST_TYPES + static.num_types])


def tile_dead_offsets(alive: torch.Tensor) -> torch.Tensor:
    """The dead-rank claim's tile offsets: for each TILE-lane tile of the
    pool, the number of dead lanes before it (int32 [ceil(N / TILE)]); for
    a stacked alive plane [S, N], per slot ([S, ceil(N / TILE)], each
    slot's offsets from 0). On a CUDA tensor the count and scan kernels run
    (`csrc/fused_step.cu`); on a CPU tensor their plain version, a per-tile
    sum and an exclusive cumsum."""
    return _dead_tiles(alive)[1]


def _dead_tiles(alive: torch.Tensor):
    """(per-tile dead counts, exclusive tile offsets) of `tile_dead_offsets`."""
    lead, n = tuple(alive.shape[:-1]), alive.shape[-1]
    n_tiles = -(-n // L.TILE)
    if alive.device.type == "cuda":
        from . import _build

        lib = _build.load()
        alive = _checked(alive, torch.bool, alive.device, lead + (n,))
        counts = torch.empty(lead + (n_tiles,), dtype=torch.int32, device=alive.device)
        offsets = torch.empty_like(counts)
        rc = lib.bf_dead_rank_offsets(alive.data_ptr(), counts.data_ptr(), offsets.data_ptr(), n,
                                      int(np.prod(lead, dtype=np.int64)),
                                      torch.cuda.current_stream(alive.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"dead-rank claim kernels failed to launch: {lib.bf_error_string(rc).decode()}")
        tile_dead_offsets.launches += 1
        return counts, offsets
    if alive.device.type != "cpu":
        raise ValueError(f"no dead-rank claim for device {alive.device}")
    counts = dead_tile_counts(alive)
    return counts, torch.cumsum(counts, -1, dtype=torch.int32) - counts


tile_dead_offsets.launches = 0  # count + scan launches (CUDA path only)

# The carried claim (kernel row 4): per alive plane on the card, the
# per-tile dead counts that the launch which wrote it left (or its seed
# counted), keyed on the tensor by a weak reference and its version: a
# plane edited in place, replaced, restacked or copied from the host has
# no entry, or a stale one, and is counted again.
_CLAIM_CARRY: dict = {}


def _carry_claim(alive: torch.Tensor, counts: torch.Tensor) -> None:
    """Keep `counts` as the carried claim of `alive` (dropped with it)."""
    if alive.is_inference():  # no version counter: never carried
        return
    key = id(alive)

    def drop(ref, key=key):
        if _CLAIM_CARRY.get(key, (None,))[0] is ref:
            del _CLAIM_CARRY[key]

    _CLAIM_CARRY[key] = (weakref.ref(alive, drop), alive._version, counts)


def _forget_claim(alive: torch.Tensor) -> None:
    """Drop the carried claim of `alive`, so that its next solo launch
    seeds (a captured chain's static input: the seed is recorded)."""
    hit = _CLAIM_CARRY.get(id(alive))
    if hit is not None and hit[0]() is alive:
        del _CLAIM_CARRY[id(alive)]


def _carried_claim(alive: torch.Tensor) -> Optional[torch.Tensor]:
    """The counts `_carry_claim` kept for this very tensor at its current
    version, or None."""
    hit = _CLAIM_CARRY.get(id(alive))
    if hit is None or hit[0]() is not alive or hit[1] != alive._version:
        return None
    return hit[2]


def claim_counts(alive: torch.Tensor) -> torch.Tensor:
    """The dead-rank claim's per-tile dead counts of a solo pool's alive
    plane (int32 [ceil(N / TILE)]), which a solo dead-rank launch reduces
    in place of the count and scan kernels. On a CUDA tensor: the counts
    the launch that wrote `alive` left beside it, or, where there are none
    (the chain's first frame, a plane edited in place, replaced, restacked
    or copied from the host), the seed's count kernel (`bf_dead_rank_offsets`
    without its scan; counted in `claim_counts.seeds`), kept for the next
    caller; nothing syncs. On a CPU tensor: `step.dead_tile_counts`."""
    if alive.device.type != "cuda":
        return dead_tile_counts(alive)
    counts = _carried_claim(alive)
    if counts is not None:
        return counts
    from . import _build

    lib = _build.load()
    n = alive.shape[-1]
    alive = _checked(alive, torch.bool, alive.device, (n,))
    counts = torch.empty(-(-n // L.TILE), dtype=torch.int32, device=alive.device)
    rc = lib.bf_dead_rank_offsets(alive.data_ptr(), counts.data_ptr(), None, n, 1,
                                  torch.cuda.current_stream(alive.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dead-rank claim's count kernel failed to launch: {lib.bf_error_string(rc).decode()}")
    claim_counts.seeds += 1
    _carry_claim(alive, counts)
    return counts


claim_counts.seeds = 0  # the seed's count kernel launches (CUDA path only)


def _ptr_array(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr() for t in tensors])


def _from_slot(tensors: list, c0: int) -> list:
    """Slot-stacked tensors from slot c0 on (views; None stays None), for a
    fleet's later launch chunks; at slot 0 the list itself."""
    return tensors if not c0 else [None if t is None else t[c0:] for t in tensors]


def _checked(t: torch.Tensor, dtype, device, shape: tuple) -> torch.Tensor:
    if t.dtype != dtype or t.device != device or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"kernel input must be a contiguous {dtype} tensor of shape {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")
    return t


def _pack_mode(pack_render) -> int:
    """The launch's render-pack mode for a `pack_render` argument, as the JAX
    package reads it: false 0, "f16" L.PACK_F16 (the f16 record), another
    true value L.PACK_F32 (9 f32 planes); another string raises."""
    if isinstance(pack_render, str):
        if pack_render != "f16":
            raise ValueError(f"pack_render must be False, True or 'f16', got {pack_render!r}")
        return L.PACK_F16
    return L.PACK_F32 if pack_render else 0


def _launch(static: SpawnerStatic, params: SpawnerParams, colliders, state: PoolState, frame: FrameInput,
            seeds: list, mode: int, stats: bool, hybrid: Optional[dict] = None, fleet: Optional[dict] = None,
            shard: Optional[Shard] = None, dead_offsets: Optional[torch.Tensor] = None):
    """One step launch on the current stream. Archetypes without ring
    claims claim by dead-slot rank: a solo launch from the carried counts
    of its alive plane (`claim_counts`), leaving those of the plane it
    writes for the next launch, or, given `dead_offsets`, from the scanned
    tile offsets (`tile_dead_offsets`); fleet and hybrid launches after the
    claim's count and scan kernels. Returns (fields,
    scal, render planes or None, dump plane or None, stats row or None,
    latch or None): new tensors; the inputs are not modified. mode: the
    render pack's (`_pack_mode`): none, the 9 f32 planes, or the record's 12 or 16 f16
    planes in contract column order. hybrid (a hybrid frame's
    merge; see `_hybrid_launches`): the nested scalars `ns`, the child rows
    `child`, the records' `emitters`, the pre-spawn flag `any_alive`, the
    ring cursor after the nested claims `cursor`, on dead-rank
    archetypes the claim's tile `offsets` of the pre-spawn alive plane,
    `fold`: None, or (last_emitted after the frame's cadence, the
    `FoldCarry` the fold epilogue fills for the next frame: its counts and
    its NS buffer), and `lean`: `merge_lean`'s choice of instantiation.
    A lean hybrid launch (`fused_step_kernel_merge`) also writes the
    post-frame alive plane on the ring (`fields["alive"]`) and the whole
    next NS buffer, and returns its latch, bool [3]: any lane alive after
    the frame, the finished event and the new finished_notified
    (`step.merge_latch`, its plain version).
    fleet (kernel row 7; `state` stacked over S slots, seeds [S][U] flat):
    the `table` ([S, words] or one shared [words]) and the per-slot records
    `slot_rows` [S, slot_words(F)] on the card; the slots launch in chunks
    of SEED_WORDS // U. shard (kernel row 11; a solo launch of a shard of
    a pool split over the particle axis): its lane base and the global
    capacity, launch arguments, and its dead offset, a launch argument or
    (a device tensor) a word the kernel reads. Returns the number of
    launches last."""
    from . import _build

    lib = _build.load()
    dev = state.device
    if params.device != dev:
        raise ValueError(f"params on {params.device}, pool on {dev}")
    n_col = colliders.count if collision_on(static, colliders) else 0
    N = state.capacity
    S = state.px.shape[0] if fleet is not None else 1
    lead = (S,) if fleet is not None else ()
    unroll = len(seeds) // S
    fields = {}
    ins, outs = [None] * L.N_FIELDS, [None] * L.N_FIELDS
    for name in active_f32_fields(static):
        i = L.FIELD_SLOTS.index(name)
        ins[i] = _checked(getattr(state, name), torch.float32, dev, lead + (N,))
        outs[i] = fields[name] = torch.empty_like(ins[i])
    ptype_in = ptype_out = None
    if not static.single_type:
        ptype_in = _checked(state.ptype, torch.int32, dev, lead + (N,))
        ptype_out = torch.empty_like(ptype_in)
    fields["ptype"] = state.ptype if ptype_out is None else ptype_out
    alive_in = alive_out = offsets = counts = dead_next = None
    if not static.ring_claim:
        alive_in = _checked(state.alive, torch.bool, dev, lead + (N,))
        alive_out = fields["alive"] = torch.empty_like(alive_in)
        if hybrid is not None:
            offsets = hybrid["offsets"]
        elif fleet is not None:
            offsets = tile_dead_offsets(alive_in)
        else:  # a solo launch: the carried claim in, the next one out
            if dead_offsets is None:
                counts = claim_counts(alive_in)
            else:
                offsets = _checked(dead_offsets, torch.int32, dev, (-(-N // L.TILE),))
            dead_next = torch.empty(-(-N // L.TILE), dtype=torch.int32, device=dev)
    elif hybrid is not None and hybrid["lean"]:  # the ring's post-frame alive plane, from the merge launch
        alive_out = fields["alive"] = torch.empty((N,), dtype=torch.bool, device=dev)
    names = ("time_in_cycle", "last_emission", "enabled", "manual_queued", "ring_cursor")
    dtypes = (torch.float32, torch.float32, torch.bool, torch.int32, torch.int32)
    E, T = static.num_emitters, static.num_types
    shapes = (lead + (E,), lead + (E,), lead + (E,), lead, lead)
    s_in = [_checked(getattr(state, k), d, dev, sh) for k, d, sh in zip(names, dtypes, shapes)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    latch = None
    if hybrid is not None:
        s_in[4] = _checked(hybrid["cursor"], torch.int32, dev, ())
        merge = (hybrid["any_alive"].data_ptr(), hybrid["ns"].data_ptr(), hybrid["child"].data_ptr(),
                 len(hybrid["emitters"]), hybrid["child"].shape[2], hybrid["child"].shape[1])
        fold = hybrid["fold"]  # (last_emitted [E, N], the next frame's FoldCarry) or None
        merge += (None, None, None, 0) if fold is None else (
            fold[0].data_ptr(), fold[1].counts.data_ptr(), fold[1].ns.data_ptr(), fold[1].counts.shape[0])
        if hybrid["lean"]:
            latch = torch.empty(3, dtype=torch.bool, device=dev)
            merge += (merge_scratch(dev, stream).data_ptr(), latch.data_ptr(),
                      _checked(state.finished_notified, torch.bool, dev, ()).data_ptr(), 1)
        else:
            merge += (None, None, None, 0)
    else:
        merge = (None, None, None, 0, 0, 0, None, None, None, 0, None, None, None, 0)
    s_out = [torch.empty_like(t) for t in s_in]
    render = None
    if mode == L.PACK_F32:
        render = [torch.empty(lead + (N,), dtype=torch.float32, device=dev) for _ in range(L.N_RENDER)]
    elif mode == L.PACK_F16:  # by contract column, no quaternion planes under rotation elision
        render = [None if static.elide_rotation and 4 <= i < 8 else torch.empty(lead + (N,), dtype=torch.float16,
                                                                                 device=dev) for i in range(L.N_RECORD)]
    dump = torch.empty(lead + (N,), dtype=torch.bool, device=dev) if static.any_destroyed_dump else None
    stats_row = acc = None
    if stats:  # the rows, and per slot the accumulator and its ticket (the stream's scratch, 0 between launches)
        sw = L.stats_words(T)
        stats_row = torch.empty(lead + (sw,), dtype=torch.int32, device=dev)
        acc = stats_scratch(dev, stream, S * (sw + 1)).view(S, sw + 1)
    words = _DEVICE_WORDS
    frame_dev = None
    if fleet is None:
        table, tab_stride, slot_rows = kernel_tables(static, params), 0, None
        records, n_fields = (kernel_fields(frame.force_fields), frame.force_fields.count) if fields_on(frame) \
            else (None, 0)
        row_np = _frame_row(frame)
        frame_row = (ctypes.c_float * L.FRAME_WORDS)(*row_np.tolist())
        frame_dev = None if words is None else words.take(row_np.view(np.uint32))
    else:
        table, slot_rows = fleet["table"], fleet["slot_rows"]
        tab_stride = table.shape[1] if table.dim() == 2 else 0
        records, n_fields, frame_row = None, fleet["n_fields"], None
    col = kernel_colliders(colliders) if n_col else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    shard = Shard(0, N) if shard is None else shard
    dead_offset, dead_offset_dev = shard.dead_offset, None
    if isinstance(dead_offset, torch.Tensor):
        dead_offset, dead_offset_dev = 0, _checked(dead_offset, torch.int32, dev, ()).data_ptr()
    per_launch = L.SEED_WORDS // unroll
    launches = 0
    for c0 in range(0, S, per_launch):  # one chunk for a solo launch
        c1 = min(S, c0 + per_launch)
        c_ins, c_outs, c_s_in, c_s_out = (_from_slot(ts, c0) for ts in (ins, outs, s_in, s_out))
        pi, po, ai, ao, off, dmp, c_acc, row, srows = _from_slot(
            [ptype_in, ptype_out, alive_in, alive_out, offsets, dump, acc, stats_row, slot_rows], c0)
        seed_row = (ctypes.c_uint32 * ((c1 - c0) * unroll))(*seeds[c0 * unroll:c1 * unroll])
        seeds_dev = None if words is None else words.take(seeds[c0 * unroll:c1 * unroll])
        rc = lib.bf_fused_step(
            ptr(table[c0:] if c0 and tab_stride else table), ptr(col), n_col, 0 if col is None else col.numel(),
            _ptr_array(c_ins), _ptr_array(c_outs), ptr(pi), ptr(po), ptr(ai), ptr(ao), ptr(off), _ptr_array(c_s_in),
            _ptr_array(c_s_out), mode, None if render is None else _ptr_array(_from_slot(render, c0)), frame_row,
            seed_row, unroll, N, E, T, ptr(records), n_fields, ptr(dmp), ptr(c_acc), ptr(row), *merge,
            c1 - c0, tab_stride, ptr(srows), 0 if srows is None else srows.shape[1], shard.lane_base,
            shard.global_n, dead_offset, ptr(counts), ptr(dead_next), dead_offset_dev, frame_dev, seeds_dev, stream,
        )
        if rc != 0:
            raise RuntimeError(f"fused_step kernel launch failed: {lib.bf_error_string(rc).decode()}")
        launches += 1
    if dead_next is not None:
        _carry_claim(alive_out, dead_next)
    scal = dict(zip(names, s_out))
    if render is not None:
        render = [p for p in render if p is not None]
    return fields, scal, render, dump, stats_row, latch, launches


def as_shard(shard, capacity: int) -> Optional[Shard]:
    """A `shard` argument ((lane_base, global_n, dead_offset) or a Shard;
    the dead offset an int or an int32 0-d tensor) as a Shard checked
    against the shard's capacity, or None. Reads no tensor."""
    if shard is None:
        return None
    if not isinstance(shard, Shard):
        lane_base, global_n, *dead = shard
        shard = Shard(int(lane_base), int(global_n),
                      *(d if isinstance(d, torch.Tensor) else int(d) for d in dead))
    if shard.lane_base + capacity > shard.global_n:
        raise ValueError(f"{shard} does not hold a shard of {capacity} lanes")
    return shard


def fused_step(static: SpawnerStatic, params: SpawnerParams, colliders, state: PoolState, frame: FrameInput,
               pack_render=False, unroll: int = 1, stats: bool = True, kernel_stats: bool = False, shard=None,
               group=None, _dead_offsets=None):
    """Advance `unroll` frames (bit-equal to that many single frames).
    Returns (state, outputs) or, with pack_render, (state, outputs, planes):
    the render-pack planes of the last frame, for pack_render True the 9
    f32 planes (instance scale, base rgba, emissive rgba), for "f16" the
    instance record's 12 f16 planes (px py pz, instance scale, base rgba,
    emissive rgba) or, with live rotation, 16 (the quaternion after the
    scale), each the f32 value rounded to nearest even. outputs is None when
    `stats` is False (chain frames nobody reads; the finished latch is
    still updated); otherwise, on the card, the kernel's stats block
    computes their AABB and counts. kernel_stats is accepted for parity
    with the JAX package's signature and changes nothing.

    shard (kernel row 11; the JAX package's `_shard_override`): `state` is
    one shard of a pool split over the particle axis, (lane_base, global_n,
    dead_offset) or a `step.Shard`; its lanes claim, rank and draw as the
    global lanes lane_base + [0, capacity) of the global_n-lane pool, its
    dead ranks start at dead_offset (an int, or an int32 0-d tensor on the
    pool's device, which the kernel reads), and the outputs are this
    shard's alone. group (with shard; the JAX package's `shard_axis`): a
    torch.distributed group whose ranks hold the pool's shards: the
    epilogue makes the AABB, the counts and the finished latch the whole
    pool's (`step.group_reduce`). `parallel.sharding.make_sharded_step`
    passes both.

    On the card a solo dead-rank launch claims from the carried per-tile
    dead counts of `state.alive` (`claim_counts`: the previous launch's, or
    the seed's) and leaves those of the plane it writes. _dead_offsets (a
    testing and timing seam, as the JAX package's `_shard_override`): the
    claim's scanned tile offsets of `state.alive` (`tile_dead_offsets`) in
    their place, the count -> scan route."""
    check_kernel_scope(static, unroll)
    shard = as_shard(shard, state.capacity)
    if group is not None and shard is None:
        raise ValueError("a group reduces the shards of one pool: pass the shard too")
    mode = _pack_mode(pack_render)
    if collision_on(static, colliders) and colliders.device != state.device:
        raise ValueError(f"colliders on {colliders.device}, pool on {state.device}")
    if fields_on(frame) and frame.force_fields.device != state.device:
        raise ValueError(f"force fields on {frame.force_fields.device}, pool on {state.device}")
    if has_nested(static):
        if shard is not None:
            raise NotImplementedError(NESTED_SHARD_MESSAGE)
        return fused_step_hybrid(static, params, colliders, state, frame, pack_render, stats)
    if state.device.type == "cuda":
        key, seeds = frame_seeds(state.rng_key.numpy(), unroll)
        fields, scal, planes, dump, row, _l, _n = _launch(static, params, colliders, state, frame, seeds, mode,
                                                          stats, shard=shard, dead_offsets=_dead_offsets)
        fused_step.launches += 1
        fused_step.dead_claim_launches += not static.ring_claim and _dead_offsets is None
        fused_step.shard_launches += shard is not None
        fused_step.render_launches += mode == L.PACK_F32
        fused_step.render_f16_launches += mode == L.PACK_F16
        fused_step.collide_launches += collision_on(static, colliders)
        fused_step.broad_launches += looped_form(static, colliders)
        fused_step.fields_launches += fields_on(frame)
        fused_step.dump_launches += dump is not None
        fused_step.stats_launches += stats
        new_state, out = epilogue(static, params, state, fields, scal, torch.as_tensor(key.astype(np.int64)), stats,
                                  dump, None if row is None else stats_from_row(static, row), group=group)
    elif state.device.type == "cpu":
        new_state, out = plain_frames(static, params, state, frame, unroll, stats, colliders, shard, group)
        planes = pack_render_planes(static, params, new_state, pack_render) if mode else None
    else:
        raise ValueError(f"no step for device {state.device}")
    if mode:
        return new_state, out, tuple(planes)
    return new_state, out


fused_step.launches = 0  # kernel launches (CUDA path only)
fused_step.render_launches = 0  # of which with the f32 render pack
fused_step.render_f16_launches = 0  # of which with the f16 record
fused_step.collide_launches = 0  # of which with the narrow phase
fused_step.broad_launches = 0  # of which with LOOP_MIN_COLLIDERS colliders or more (the JAX package's looped form)
fused_step.fields_launches = 0  # of which with force fields
fused_step.dump_launches = 0  # of which writing the dump plane
fused_step.stats_launches = 0  # of which writing the stats row
fused_step.merge_launches = 0  # of which hybrid frames with the nested merge block
fused_step.fold_launches = 0  # of which with the nested fold epilogue (kernel row 10)
fused_step.merge_lean_launches = 0  # of the merge launches, fused_step_kernel_merge's (no colliders, no fields)
fused_step.merge_wide_launches = 0  # of the merge launches, fused_step_kernel's (colliders or fields)
fused_step.shard_launches = 0  # of which a shard of a pool split over the particle axis (kernel row 11)
fused_step.dead_claim_launches = 0  # of which solo dead-rank launches claiming from carried counts (kernel row 4)


def _stage_launch(lib, static: SpawnerStatic, params: SpawnerParams, e: int, M: int, n: int, *, lanes=None,
                  le_out=None, cum=None, carry=None, any_alive=None, planes=(), fetch_out=None, child=None,
                  frame: Optional[FrameInput] = None, frame_key=None, parent_vals=None, cum_in=None, start=None,
                  dead_tiles=None, record=None):
    """One launch of nested emitter e's nested-stage kernel on the current
    stream (`bf_nested_stage`). lanes: (alive, ptype, age, lifetime or
    None, le_in, gate), the cadence pass over the n lanes' tiles; None:
    the child rows alone, from `parent_vals` [n_parent, M] or `cum_in` [n]
    with `planes`. The other arguments are its outputs or its own inputs,
    device tensors or None (see the launcher). n_parent is the count of
    `planes` (or of `parent_vals`' rows): any in fetch mode, which copies
    them by rank; the archetype's `nested_parent_fields` where child rows
    are built."""
    n_parent = parent_vals.shape[0] if parent_vals is not None else len(planes)
    if child is not None and n_parent != len(nested_parent_fields(static)):
        raise ValueError(f"child rows read the archetype's {len(nested_parent_fields(static))} parent fields "
                         f"(nested_parent_fields), not {n_parent}")
    if n_parent > L.MAX_FETCH:
        raise ValueError(f"a nested stage reads at most {L.MAX_FETCH} parent fields, not {n_parent}")
    dev = (lanes[2] if lanes is not None else child).device
    n_tiles = -(-n // L.TILE) if lanes is not None else 0
    if lanes is not None:
        alive, ptype, age, lifetime, le_in, gate = lanes
        for t, dt_ in ((alive, torch.bool), (age, torch.float32), (le_in, torch.float32)):
            _checked(t, dt_, dev, (n,))
        if not static.single_type:
            _checked(ptype, torch.int32, dev, (n,))
        if lifetime is not None:
            _checked(lifetime, torch.float32, dev, (n,))
        _checked(gate, torch.bool, dev, ())
    else:
        alive = ptype = age = lifetime = le_in = gate = None
    for t in planes:
        _checked(t, torch.float32, dev, (n,))
    key = threefry_fold_in(frame_key, 1000 + e) if child is not None else (0, 0)
    row_np = _frame_row(frame) if child is not None else None
    row = (ctypes.c_float * L.FRAME_WORDS)(*row_np.tolist()) if child is not None else None
    key_dev = frame_dev = None
    if child is not None and _DEVICE_WORDS is not None:
        key_dev = _DEVICE_WORDS.take(np.asarray(key, np.uint32))
        frame_dev = _DEVICE_WORDS.take(row_np.view(np.uint32))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    scratch = nested_scratch(dev, stream)
    # an unfolded stage draws its ranks' parent-free parts before its barrier
    parts = torch.empty((L.CHILD_PARTS, M), dtype=torch.float32, device=dev) \
        if (child is not None and lanes is not None and carry is None) else None
    rc = lib.bf_nested_stage(
        kernel_tables(static, params).data_ptr(), e, ptr(alive), None if static.single_type else ptr(ptype),
        ptr(age), ptr(lifetime), ptr(le_in), ptr(gate), ptr(le_out), ptr(cum), ptr(carry), ptr(any_alive),
        _ptr_array(planes) if planes else None, n_parent, ptr(fetch_out), ptr(child),
        ptr(parts), ptr(parent_vals),
        ptr(cum_in), ptr(start), None if dead_tiles is None else dead_tiles[0].data_ptr(),
        None if dead_tiles is None else dead_tiles[1].data_ptr(), ptr(record), row, int(key[0]), int(key[1]),
        nested_draw_rows(static), scratch.data_ptr(), scratch.numel(), n, M, n_tiles, int(static.ring_claim),
        frame_dev, key_dev, stream)
    if rc != 0:
        raise RuntimeError(f"nested stage kernel failed to launch: {lib.bf_error_string(rc).decode()}")


def nested_stage(static: SpawnerStatic, params: SpawnerParams, frame: FrameInput, e: int, alive, ptype, age,
                 lifetime, le_row, gate, M: int, parents: dict, frame_key, start, counts=None,
                 out: Optional[dict] = None):
    """Kernel rows 8 and 9b: nested emitter e's stage of a hybrid frame in
    one launch, its cadence pass (the JAX package's `nested_cadence_pass`)
    and its child rows (the JAX package's child stage, step.py:411-453).
    Returns (new_le [N] f32, the emitter's NS record int32 [NS_STRIDE],
    child rows [len(nested_child_field_rows), M] f32), as
    `step.nested_stage`, its plain version. alive [N] bool (pre-spawn),
    ptype [N] i32, age [N] f32, lifetime [N] f32 or None (the archetype's
    constant), le_row the emitter's [N] anchors, gate a 0-d bool, parents
    name -> [N] f32 (`nested_parent_fields`), start the window's start
    (int32 0-d). On CUDA tensors the nested-stage kernel runs: counts (a
    folded frame) are the tile counts the previous step launch's fold
    epilogue left (`FoldCarry.counts`), reduced in place of counting; out
    (a hybrid frame's buffers) holds "le" (written in place of a new anchor row),
    "record" (a zeroed view of the frame's NS buffer), "child" ([rows, M]),
    "any_alive" (NS_ANY, or None) and on dead-rank archetypes "dead_tiles"
    (the claim's `_dead_tiles` of `alive`); nothing syncs. On CPU tensors
    the plain version (counts and out must be None)."""
    if age.device.type == "cuda":
        from . import _build

        lib = _build.load()
        dev = age.device
        N = age.shape[0]
        out = dict(out or {})
        le = out.get("le")
        le = torch.empty_like(le_row) if le is None else le
        record = out.get("record")
        record = torch.zeros(L.NS_STRIDE, dtype=torch.int32, device=dev) if record is None else record
        child = out.get("child")
        if child is None:
            child = torch.empty((len(nested_child_field_rows(static)), M), dtype=torch.float32, device=dev)
        if counts is not None:
            _checked(counts, torch.int32, dev, (-(-N // L.TILE),))
        _stage_launch(lib, static, params, e, M, N, lanes=(alive, ptype, age, lifetime, le_row, gate), le_out=le,
                      carry=counts, any_alive=out.get("any_alive"),
                      planes=tuple(parents[k] for k in nested_parent_fields(static)), child=child, frame=frame,
                      frame_key=frame_key, start=start, record=record,
                      dead_tiles=None if static.ring_claim else out.get("dead_tiles") or _dead_tiles(alive))
        nested_stage.launches += 1
        return le, record, child
    if age.device.type != "cpu":
        raise ValueError(f"no nested stage for device {age.device}")
    if counts is not None or out is not None:
        raise ValueError("tile counts and output buffers are the card's: the plain nested stage takes neither")
    life = lifetime if lifetime is not None else torch.full((), float(static.const_lifetime), dtype=torch.float32)
    return plain_stage(static, params, frame, e, alive, ptype, age, life, le_row, gate, M, parents, frame_key, start)


nested_stage.launches = 0  # nested-stage launches of hybrid frames (CUDA path only)


def nested_cadence_pass(static: SpawnerStatic, params: SpawnerParams, e: int, alive, ptype, age, lifetime, le_row,
                        gate, M: int, parent_fields: Optional[dict] = None):
    """Kernel row 8, one nested emitter's cadence pass over the pool (the JAX
    package's `nested_cadence_pass`): returns (new_le [N] f32, cum [N] i32
    or None, total i32 0-d, parent values name -> [M] f32 or None), as
    `step.nested_cadence`, its plain version. alive [N] bool, ptype [N]
    i32, age [N] f32, lifetime [N] f32 or None (the archetype's constant),
    le_row the emitter's [N] anchors, gate a 0-d bool. parent_fields
    (fetch mode): name -> [N] f32, any of the pool's f32 planes (on the
    card at most `table_layout.MAX_FETCH`). On CUDA tensors one launch of the
    nested-stage kernel without child rows (the scalars land in a device
    record; nothing syncs); on CPU tensors the plain version."""
    if age.device.type == "cuda":
        from . import _build

        lib = _build.load()
        dev = age.device
        N = age.shape[0]
        names = tuple(parent_fields) if parent_fields else ()
        record = torch.zeros(L.NS_STRIDE, dtype=torch.int32, device=dev)
        new_le = torch.empty_like(le_row)
        cum = None if names else torch.empty(N, dtype=torch.int32, device=dev)
        fetched = torch.empty((len(names), M), dtype=torch.float32, device=dev) if names else None
        _stage_launch(lib, static, params, e, M, N, lanes=(alive, ptype, age, lifetime, le_row, gate), le_out=new_le,
                      cum=cum, planes=tuple(parent_fields[k] for k in names), fetch_out=fetched, record=record,
                      dead_tiles=None if static.ring_claim else _dead_tiles(alive))
        nested_cadence_pass.launches += 1
        return new_le, cum, record[L.NS_TOTAL], (dict(zip(names, fetched)) if names else None)
    if age.device.type != "cpu":
        raise ValueError(f"no nested cadence pass for device {age.device}")
    life = lifetime if lifetime is not None else torch.full((), float(static.const_lifetime), dtype=torch.float32)
    return nested_cadence(static, params, e, alive, ptype, age, life, le_row, gate, M, parent_fields)


nested_cadence_pass.launches = 0  # nested-stage launches of the cadence pass alone (CUDA path only)


def _frame_row(frame: FrameInput) -> np.ndarray:
    row = np.zeros(L.FRAME_WORDS, np.float32)
    for at, value in ((L.FR_DT, frame.dt), (L.FR_MOD_SCALE, frame.modifier_scale),
                      (L.FR_MOD_SPEED, frame.modifier_speed), (L.FR_PVEL, frame.parent_velocity),
                      (L.FR_TRANS, frame.transform_translation), (L.FR_ROT, frame.transform_rotation)):
        v = value.numpy().reshape(-1)
        row[at:at + v.size] = v
    return row


def nested_child_rows(static: SpawnerStatic, params: SpawnerParams, frame: FrameInput, e: int, frame_key, M: int,
                      parent_vals: Optional[dict] = None, cum=None, parent_planes: Optional[dict] = None):
    """The children of nested emitter e by rank, [len(active_f32_fields), M]
    f32 (the JAX package's child stage, step.py:411-453; threefry draws
    under fold_in(frame_key, 1000 + e)). Parents: `parent_vals` (name -> [M],
    fetch mode), or `cum` [N] with `parent_planes` (name -> [N], cum mode:
    rank r's parent is the first lane whose cum exceeds r). On CUDA tensors
    one launch of the nested-stage kernel's child rows alone; on CPU
    tensors `step.nested_child_rows`."""
    names = nested_parent_fields(static)
    dev = (cum if cum is not None else parent_vals["px"]).device
    if dev.type == "cuda":
        from . import _build

        lib = _build.load()
        out = torch.empty((len(nested_child_field_rows(static)), M), dtype=torch.float32, device=dev)
        if cum is not None:
            N = cum.shape[0]
            _stage_launch(lib, static, params, e, M, N, planes=tuple(parent_planes[k] for k in names), child=out,
                          frame=frame, frame_key=frame_key, cum_in=_checked(cum, torch.int32, dev, (N,)))
        else:
            pv = torch.stack([_checked(parent_vals[k], torch.float32, dev, (M,)) for k in names])
            _stage_launch(lib, static, params, e, M, M, child=out, frame=frame, frame_key=frame_key, parent_vals=pv)
        nested_child_rows.launches += 1
        return out
    if dev.type != "cpu":
        raise ValueError(f"no nested child rows for device {dev}")
    if cum is not None:
        idx = nested_parents(cum, M)
        parent_vals = {k: parent_planes[k][idx] for k in names}
    return plain_child_rows(static, params, frame, e, parent_vals, frame_key, M)


nested_child_rows.launches = 0  # nested-stage launches of the child rows alone (CUDA path only)


@dataclasses.dataclass(frozen=True)
class FoldCarry:
    """A folded chain's carry on the card: what the next frame's nested
    stages reduce in place of counting. counts: [n_fold,
    ceil(N / TILE)] int32, per valid nested emitter the per-tile parent
    counts on the state the next frame starts from (the fold epilogue's,
    or the seed's count kernels); ns: the next frame's nested scalars
    (zeroed, NS_ANY set where a lane lives). Device tensors only: no frame
    reads them on the host."""

    counts: torch.Tensor
    ns: torch.Tensor


def can_fold_nested(static: SpawnerStatic, capacity: int) -> bool:
    """The nested fold applies (the JAX package's `can_fold_nested`): a ring
    claim, at least one valid nested emitter and a pool larger than the
    child buffer M (the reference's conditions on meaning; the merge path,
    which it also asks for, is the port's only hybrid). The reference's
    layout conditions, a capacity that is a multiple of its 64 x 128-lane
    tile and an M that is a multiple of 128, are Mosaic's and are dropped:
    the CUDA epilogue sums any tile of TILE lanes, its last ragged, and the
    nested stage takes any M. A folded chain equals the unfolded one bit
    for bit, so the predicate decides speed only."""
    if not has_nested(static) or not static.ring_claim:
        return False
    return capacity > nested_m(static, capacity) and bool(nested_emitters(static))


def _new_carry(n_fold: int, n_lanes: int, dev, zeroed: bool) -> FoldCarry:
    """A FoldCarry's buffers: the NS buffer zeroed for the seed's count
    kernels and fused_step_kernel's merge, or left to the latch of
    fused_step_kernel_merge's fold epilogue, which writes all of it."""
    return FoldCarry(torch.empty((n_fold, -(-n_lanes // L.TILE)), dtype=torch.int32, device=dev),
                     (torch.zeros if zeroed else torch.empty)(L.NS_AT + n_fold * L.NS_STRIDE, dtype=torch.int32,
                                                              device=dev))


def _seed_nested_carry(static: SpawnerStatic, params: SpawnerParams, state: PoolState):
    """The first frame's carry of a folded chain (the JAX package's
    `_seed_nested_carry`), from the kernel-row-8 pass on the chain's
    initial state: on the card the count kernel per valid nested emitter (a
    `FoldCarry`: the frame's nested stage takes its tile counts); on the
    CPU `step.nested_fold_carry` (per emitter (new_le, total, parent
    values))."""
    dev = state.device
    if dev.type == "cpu":
        return nested_fold_carry(static, params, state)
    if dev.type != "cuda":
        raise ValueError(f"no nested fold for device {dev}")
    from . import _build

    lib = _build.load()
    N = state.capacity
    es = nested_emitters(static)
    carry = _new_carry(len(es), N, dev, zeroed=True)
    lifetime = None if static.const_lifetime is not None else _checked(state.lifetime, torch.float32, dev, (N,))
    alive = _checked(state.alive, torch.bool, dev, (N,))
    ptype = None if static.single_type else _checked(state.ptype, torch.int32, dev, (N,))
    age = _checked(state.age, torch.float32, dev, (N,))
    stream = torch.cuda.current_stream(dev).cuda_stream
    for j, e in enumerate(es):
        rc = lib.bf_nested_counts(kernel_tables(static, params).data_ptr(), e, alive.data_ptr(),
                                  None if ptype is None else ptype.data_ptr(), age.data_ptr(),
                                  None if lifetime is None else lifetime.data_ptr(),
                                  _checked(state.last_emitted[e], torch.float32, dev, (N,)).data_ptr(),
                                  _checked(state.enabled[e], torch.bool, dev, ()).data_ptr(),
                                  carry.counts[j].data_ptr(), carry.ns[L.NS_ANY].data_ptr(), N, stream)
        if rc != 0:
            raise RuntimeError(f"nested count kernel failed to launch: {lib.bf_error_string(rc).decode()}")
        _seed_nested_carry.launches += 1
    return carry


_seed_nested_carry.launches = 0  # count kernel launches of folded chains' seeds (CUDA path only)


def _hybrid_launches(static: SpawnerStatic, params: SpawnerParams, colliders, state: PoolState, frame: FrameInput,
                     pack_render, stats: bool, carry: Optional[FoldCarry] = None, fold_out: bool = False):
    """One hybrid frame on the card: per valid nested emitter one launch of
    the nested-stage kernel (its cadence pass and child rows; with a
    `carry`, on the carried tile counts), then the step launch with the
    merge block (and, with `fold_out`, the fold epilogue); a lean launch's
    alive plane and latch (`merge_lean`) the epilogue takes in place of
    reducing. Returns (new_state, outputs or None, render planes or None,
    the next frame's FoldCarry or None)."""
    dev = state.device
    N = state.capacity
    M = nested_m(static, N)
    es = nested_emitters(static)
    new_key, frame_key = threefry_split(state.rng_key.numpy())
    new_key, kernel_key = threefry_split(new_key)
    if carry is None:
        ns = torch.zeros(L.NS_AT + len(es) * L.NS_STRIDE, dtype=torch.int32, device=dev)
    else:  # zeroed, NS_ANY set, by the previous frame's launch or the seed
        ns = _checked(carry.ns, torch.int32, dev, (L.NS_AT + len(es) * L.NS_STRIDE,))
        _checked(carry.counts, torch.int32, dev, (len(es), -(-N // L.TILE)))
    lean = merge_lean(static, colliders, frame)
    nxt = _new_carry(len(es), N, dev, zeroed=not lean) if fold_out else None
    alive = _checked(state.alive, torch.bool, dev, (N,))
    dead_tiles = None if static.ring_claim else _dead_tiles(alive)
    lifetime = None if static.const_lifetime is not None else state.lifetime
    last_emitted = state.last_emitted.clone()
    child = torch.empty((len(es), len(nested_child_field_rows(static)), M), dtype=torch.float32, device=dev)
    parents = {k: getattr(state, k) for k in nested_parent_fields(static)}
    start = state.ring_cursor if static.ring_claim else None
    for j, e in enumerate(es):
        record = ns[L.NS_AT + j * L.NS_STRIDE:L.NS_AT + (j + 1) * L.NS_STRIDE]
        le = last_emitted[e]
        # the gate is the emitter's enabled bit: where a parent lives (the
        # only lanes the pass counts), active() holds whenever it is set;
        # a folded frame's NS_ANY is the previous launch's
        nested_stage(static, params, frame, e, alive, state.ptype, state.age, lifetime, le, state.enabled[e], M,
                     parents, frame_key, start, None if carry is None else carry.counts[j],
                     {"le": le, "record": record, "child": child[j], "dead_tiles": dead_tiles,
                      "any_alive": ns[L.NS_ANY] if carry is None else None})
        start = record[L.NS_NEXT]
    any_alive = ns[L.NS_ANY] if es else alive.any().to(torch.int32)
    hybrid = {"ns": ns, "child": child, "emitters": es, "any_alive": any_alive,
              "cursor": start if (static.ring_claim and es) else state.ring_cursor,
              "offsets": None if dead_tiles is None else dead_tiles[1],
              "fold": None if nxt is None else (last_emitted, nxt), "lean": lean}
    mode = _pack_mode(pack_render)
    fields, scal, planes_out, dump, row, latch, _n = _launch(static, params, colliders, state, frame,
                                                             [int(kernel_key[1])], mode, stats, hybrid)
    fused_step.launches += 1
    fused_step.merge_launches += 1
    fused_step.merge_lean_launches += lean
    fused_step.merge_wide_launches += not lean
    fused_step.fold_launches += nxt is not None
    fused_step.render_launches += mode == L.PACK_F32
    fused_step.render_f16_launches += mode == L.PACK_F16
    fused_step.collide_launches += collision_on(static, colliders)
    fused_step.broad_launches += looped_form(static, colliders)
    fused_step.fields_launches += fields_on(frame)
    fused_step.dump_launches += dump is not None
    fused_step.stats_launches += stats

    def nested_counts():
        recs = ns[L.NS_AT:].view(len(es), L.NS_STRIDE)
        return ((recs[:, L.NS_TOTAL] - recs[:, L.NS_N]).sum(dtype=torch.int32),
                recs[:, L.NS_DROPPED].sum(dtype=torch.int32))

    new_state, out = epilogue(static, params, state, fields, scal, torch.as_tensor(new_key.astype(np.int64)), stats,
                              dump, None if row is None else stats_from_row(static, row), last_emitted, nested_counts,
                              latch=latch)
    return new_state, out, planes_out, nxt


def fused_step_hybrid(static: SpawnerStatic, params: SpawnerParams, colliders, state: PoolState, frame: FrameInput,
                      pack_render=False, stats: bool = True, nested_carry=None, fold_out: bool = False):
    """One hybrid frame of an archetype with a nested emitter (the JAX
    package's `fused_step_hybrid` with its in-kernel merge): returns
    (state, outputs), with pack_render (True or "f16", as in `fused_step`)
    the planes next, and with `fold_out` the next frame's carry last. On
    the card the nested kernels and one merge-block step launch run; on the
    CPU `step.hybrid_frame`. nested_carry (a folded chain's frame; the
    previous frame's carry or `_seed_nested_carry`'s) stands in for the
    frame's cadence counts: on the card a `FoldCarry` (the nested stages
    take its tile counts), on the CPU the reference's per-emitter
    (new_le, total, parent values). fold_out asks the step launch for the
    next frame's carry (kernel row 10's epilogue). Both need an archetype
    the fold takes (`can_fold_nested`)."""
    check_kernel_scope(static, 1)
    mode = _pack_mode(pack_render)
    if (nested_carry is not None or fold_out) and not can_fold_nested(static, state.capacity):
        raise ValueError("a nested carry or fold_out needs a ring archetype with a valid nested emitter and a pool "
                         "larger than its child buffer (can_fold_nested)")
    carry = None
    if state.device.type == "cuda":
        if nested_carry is not None and not isinstance(nested_carry, FoldCarry):
            raise ValueError(f"a nested carry on the card is a FoldCarry, got {type(nested_carry).__name__}")
        new_state, out, planes, carry = _hybrid_launches(static, params, colliders, state, frame, pack_render, stats,
                                                         nested_carry, fold_out)
    elif state.device.type == "cpu":
        if nested_carry is not None and not isinstance(nested_carry, dict):
            raise ValueError(f"a nested carry on the CPU is a dict, got {type(nested_carry).__name__}")
        res = hybrid_frame(static, params, state, frame, stats, colliders, nested_carry, fold_out)
        new_state, out = res[:2]
        carry = res[2] if fold_out else None
        planes = pack_render_planes(static, params, new_state, pack_render) if mode else None
    else:
        raise ValueError(f"no step for device {state.device}")
    res = (new_state, out)
    if mode:
        res += (tuple(planes),)
    if fold_out:
        res += (carry,)
    return res


def step_auto(static, params, colliders, state, frame, kernel_stats: bool = False):
    """One frame through the fused step (kernel on the card, plain version on
    the CPU). Returns (state, outputs). kernel_stats: as in `fused_step`,
    a no-op kept for the JAX package's signature."""
    return fused_step(static, params, colliders, state, frame)


def step_auto_packed(static, params, colliders, state, frame, kernel_stats: bool = False):
    """step_auto plus the render extract: (state, outputs, planes), planes the
    9 render-pack planes `render.planes_to_rows` assembles into rows."""
    return fused_step(static, params, colliders, state, frame, pack_render=True)


def chain_unroll(static: SpawnerStatic, colliders=None) -> int:
    """Frames per launch in a chain (the JAX package's _chain_with_unroll
    policy): 1 where `can_unroll` is false, COLLISION_UNROLL where the
    narrow phase runs, MAX_UNROLL otherwise."""
    if not can_unroll(static):
        return 1
    return COLLISION_UNROLL if collision_on(static, colliders) else MAX_UNROLL


def chain_shape(n_frames: int, unroll: int = MAX_UNROLL) -> list:
    """Frames per launch of an n-frame chain: q launches of `unroll` frames,
    then the remainder as single frames; all singles when n < unroll."""
    if n_frames < unroll:
        return [1] * n_frames
    q, r = divmod(n_frames, unroll)
    return [unroll] * q + [1] * r


def chain_hybrid_unfolded(static, params, colliders, state, frame, n_frames: int):
    """n hybrid frames of a nested archetype, each with its own cadence
    passes (no fold); stats on the last frame only. Returns (final state,
    outputs of the last frame)."""
    out = None
    for i in range(n_frames):
        state, out = fused_step_hybrid(static, params, colliders, state, frame, stats=i == n_frames - 1)
    return state, out


def chain_nested_folded(static, params, colliders, state, frame, n_frames: int):
    """n >= 1 hybrid frames with the nested fold (the JAX package's
    `_chain_nested_folded`): the carry is seeded once, every frame but the
    last leaves the next frame's carry (the fold epilogue), and the last
    frame consumes its carry without folding. Bit-equal to
    `chain_hybrid_unfolded`: a carry is a function of the state it was
    computed on, and the one a chain's end would leave is dropped (the next
    chain's seed recomputes it). Stats on the last frame only."""
    if not can_fold_nested(static, state.capacity):
        raise ValueError("chain_nested_folded takes the archetypes can_fold_nested accepts")
    carry = _seed_nested_carry(static, params, state)
    for _ in range(n_frames - 1):
        state, _o, carry = fused_step_hybrid(static, params, colliders, state, frame, stats=False, nested_carry=carry,
                                             fold_out=True)
    return fused_step_hybrid(static, params, colliders, state, frame, nested_carry=carry)


def multi_step_auto(static, params, colliders, state, frame, n_frames: int, _captured: bool = True):
    """n frames with the same frame input; returns (final state, outputs of
    the last frame). Launches follow `chain_shape(n, chain_unroll(...))`;
    an archetype with a nested emitter steps hybrid frames, folded
    (`chain_nested_folded`) where `can_fold_nested` and n >= 2, as the JAX
    package's `_multi_step_impl` dispatches, else `chain_hybrid_unfolded`.
    Stats are computed for the last frame only; invariant fields (elided
    rotation/lifetime, single-type ptype, last_emitted) pass through every
    launch untouched.

    On the card the chain is one captured CUDA graph per static
    configuration (`chain_graph`, the JAX package's one `jax.jit` dispatch
    of its `lax.scan`): the first call of a configuration steps the chain
    and records it, later calls replay it, bit-equal to the launches.
    _captured=False (a testing and timing seam, as `fused_step`'s
    _dead_offsets) steps the launches one by one."""
    if n_frames < 1:
        raise ValueError("multi_step_auto needs n_frames >= 1")
    if _captured and state.device.type == "cuda":
        from . import chain_graph

        return chain_graph.replay("auto", static, params, colliders, state, frame, n_frames)
    return _multi_step_auto(static, params, colliders, state, frame, n_frames)


def _multi_step_auto(static, params, colliders, state, frame, n_frames: int):
    """`multi_step_auto`'s launches, one by one (n_frames >= 1)."""
    if has_nested(static):
        if n_frames >= 2 and can_fold_nested(static, state.capacity):
            return chain_nested_folded(static, params, colliders, state, frame, n_frames)
        return chain_hybrid_unfolded(static, params, colliders, state, frame, n_frames)
    shape = chain_shape(n_frames, chain_unroll(static, colliders))
    out = None
    for i, u in enumerate(shape):
        state, out = fused_step(static, params, colliders, state, frame, unroll=u, stats=i == len(shape) - 1)
    return state, out


def multi_step_auto_packed(static, params, colliders, state, frame, n_frames: int, _captured: bool = True):
    """multi_step_auto whose final frame also emits the render-pack planes
    (the only frame a renderer reads): (state, outputs, planes). On the card
    one captured graph per configuration, as `multi_step_auto`."""
    if n_frames < 1:
        raise ValueError("multi_step_auto_packed needs n_frames >= 1")
    if _captured and state.device.type == "cuda":
        from . import chain_graph

        return chain_graph.replay("auto_packed", static, params, colliders, state, frame, n_frames)
    return _multi_step_auto_packed(static, params, colliders, state, frame, n_frames)


def _multi_step_auto_packed(static, params, colliders, state, frame, n_frames: int):
    """`multi_step_auto_packed`'s launches, one by one."""
    if n_frames > 1:
        state, _o = _multi_step_auto(static, params, colliders, state, frame, n_frames - 1)
    return step_auto_packed(static, params, colliders, state, frame)


# --------------------------------------------------------------------------
# fleets: S same-archetype pools in one launch (kernel row 7)
# --------------------------------------------------------------------------


def can_fleet(static: SpawnerStatic) -> bool:
    """The fleet kernel applies (the JAX package's `_fleet_kernel_ok`):
    global-only archetypes (`can_fuse`). The JAX package also asks for a
    TPU and a tile-aligned capacity; this kernel takes any capacity."""
    return can_fuse(static)


def fleet_slot_rows(frames: FrameInput, device: torch.device) -> torch.Tensor:
    """A stacked frame's per-slot records on `device`: [S, SLOT_WORDS]
    int32 (each slot's frame row at SL_FRAME, its F field records at
    SL_FIELDS: SLOT_WORDS = slot_words(F)), built on the host and copied without a wait once per
    (frames, device); a caller that keeps the stacked frame while nothing
    changes (the Scene, Fleet, a chain) copies nothing more."""
    cache = frames.__dict__.setdefault("_slot_rows", {})
    if device not in cache:
        S = frames.dt.shape[0]
        rows = np.zeros((S, L.slot_words(frames.force_fields[0].count if frames.force_fields else 0)), np.int32)
        fl = rows.view(np.float32)
        for at, value in ((L.FR_DT, frames.dt), (L.FR_MOD_SCALE, frames.modifier_scale),
                          (L.FR_MOD_SPEED, frames.modifier_speed), (L.FR_PVEL, frames.parent_velocity),
                          (L.FR_TRANS, frames.transform_translation), (L.FR_ROT, frames.transform_rotation)):
            v = value.numpy().reshape(S, -1)
            fl[:, L.SL_FRAME + at:L.SL_FRAME + at + v.shape[1]] = v
        for i, table in enumerate(frames.force_fields or ()):
            rows[i, L.SL_FIELDS:] = pack_fields(table)
        cache[device] = upload(torch.from_numpy(rows), device)
    return cache[device]


def _fleet_fields(frames: FrameInput, device) -> int:
    """The stacked frame's field count per slot (0 without fields), checked
    against the pool's device."""
    if frames.force_fields is None:
        return 0
    for table in frames.force_fields:
        if table.device != device:
            raise ValueError(f"force fields on {table.device}, pool on {device}")
    return frames.force_fields[0].count


def fused_step_fleet(static: SpawnerStatic, params: SpawnerParams, colliders, states: PoolState,
                     frames: FrameInput, pack_render=False, unroll: int = 1, stats: bool = True):
    """Advance a whole same-archetype group by `unroll` frames in one launch
    (kernel row 7; the JAX package's `fused_step_fleet`): `states` [S]-
    stacked (equal capacities), `params` [S]-stacked or one SpawnerParams
    shared by every slot, `colliders` one shared scene table, `frames`
    [S]-stacked (`parallel.sharding.stack_frames`). Slot for slot bit-equal
    to S solo `fused_step` calls: each slot splits its own key, draws with
    its own seeds by its lane within the slot, and claims and reduces over
    its own pool. Returns (states, outputs) or, with pack_render, (states,
    outputs, planes), every leaf [S]-leading (pack_render True or "f16", as
    in `fused_step`); outputs is None without `stats`. On CUDA tensors the fleet kernel runs (S * unroll seeds per
    launch at most SEED_WORDS: larger fleets launch in chunks); on CPU
    tensors the plain version, S solo plain steps stacked."""
    if not can_fleet(static):
        raise ValueError("fused_step_fleet takes global-only archetypes (can_fleet); archetypes with a nested "
                         "emitter step through step_auto_fleet")
    check_kernel_scope(static, unroll)
    mode = _pack_mode(pack_render)
    S, dev = num_slots(states), states.device
    if tuple(frames.dt.shape) != (S,):
        raise ValueError(f"frames must be stacked over the {S} slots, got dt of shape {tuple(frames.dt.shape)}")
    n_fields = _fleet_fields(frames, dev)
    if collision_on(static, colliders) and colliders.device != dev:
        raise ValueError(f"colliders on {colliders.device}, pool on {dev}")
    if dev.type == "cuda":
        keys, seeds = frame_seeds_stacked(states.rng_key.numpy(), unroll)
        fleet = {"table": kernel_tables(static, params), "slot_rows": fleet_slot_rows(frames, dev),
                 "n_fields": n_fields}
        fields, scal, planes, dump, rows, _l, n = _launch(static, params, colliders, states, frames,
                                                          seeds.reshape(-1).tolist(), mode, stats, fleet=fleet)
        fused_step_fleet.launches += n
        fused_step_fleet.render_launches += n * (mode == L.PACK_F32)
        fused_step_fleet.render_f16_launches += n * (mode == L.PACK_F16)
        fused_step_fleet.collide_launches += n * collision_on(static, colliders)
        fused_step_fleet.broad_launches += n * looped_form(static, colliders)
        fused_step_fleet.fields_launches += n * (n_fields > 0)
        fused_step_fleet.dump_launches += n * (dump is not None)
        fused_step_fleet.stats_launches += n * stats
        new_states, out = epilogue(static, params, states, fields, scal, torch.from_numpy(keys.astype(np.int64)),
                                   stats, dump, None if rows is None else stats_from_row(static, rows))
    elif dev.type == "cpu":
        solo = [plain_frames(static, params_slot(params, i), state_slot(states, i), frame_slot(frames, i), unroll,
                             stats, colliders) for i in range(S)]
        new_states = stack_pools([st for st, _o in solo])
        out = stack_outputs([o for _s, o in solo]) if stats else None
        planes = None
        if mode:
            per_slot = [pack_render_planes(static, params_slot(params, i), st, pack_render)
                        for i, (st, _o) in enumerate(solo)]
            planes = [torch.stack(p) for p in zip(*per_slot)]
    else:
        raise ValueError(f"no step for device {dev}")
    if mode:
        return new_states, out, tuple(planes)
    return new_states, out


fused_step_fleet.launches = 0  # fleet kernel launches (CUDA path only)
fused_step_fleet.render_launches = 0  # of which with the f32 render pack
fused_step_fleet.render_f16_launches = 0  # of which with the f16 record
fused_step_fleet.collide_launches = 0  # of which with the narrow phase
fused_step_fleet.broad_launches = 0  # of which with LOOP_MIN_COLLIDERS colliders or more
fused_step_fleet.fields_launches = 0  # of which with force fields
fused_step_fleet.dump_launches = 0  # of which writing the dump plane
fused_step_fleet.stats_launches = 0  # of which writing the stats rows


def step_auto_fleet(static, params, colliders, states, frames):
    """One frame of an [S]-stacked fleet (the JAX package's
    `step_auto_fleet`): `fused_step_fleet` for global-only archetypes.
    Archetypes with a nested emitter step each member through
    `fused_step_hybrid` and stack the results: the JAX package vmaps its
    hybrid there (its ops/fused_step.py:2903-2905), so this is the
    reference's own dispatch rule, not a fallback. Returns (states,
    outputs)."""
    if can_fleet(static):
        return fused_step_fleet(static, params, colliders, states, frames)
    solo = [fused_step_hybrid(static, params_slot(params, i), colliders, state_slot(states, i),
                              frame_slot(frames, i)) for i in range(num_slots(states))]
    return stack_pools([st for st, _o in solo]), stack_outputs([o for _s, o in solo])


def multi_step_fleet_stacked(static, params, colliders, states, frames, n_frames: int, _captured: bool = True):
    """n frames of a whole fleet ([S]-stacked params or one shared params,
    states and frames): launches follow `chain_shape(n, chain_unroll(...))`,
    each one fleet launch for every slot, with stats on the last launch
    only; nested archetypes step n frames of `step_auto_fleet`. Returns
    (final states, outputs of the last frame). On the card one captured
    graph per configuration, as `multi_step_auto` (the JAX package's
    `multi_step_fleet_stacked` is one `jax.jit` dispatch)."""
    if n_frames < 1:
        raise ValueError("multi_step_fleet_stacked needs n_frames >= 1")
    if _captured and states.device.type == "cuda":
        from . import chain_graph

        return chain_graph.replay("fleet", static, params, colliders, states, frames, n_frames)
    return _multi_step_fleet_stacked(static, params, colliders, states, frames, n_frames)


def _multi_step_fleet_stacked(static, params, colliders, states, frames, n_frames: int):
    """`multi_step_fleet_stacked`'s launches, one by one."""
    if not can_fleet(static):
        out = None
        for _ in range(n_frames):
            states, out = step_auto_fleet(static, params, colliders, states, frames)
        return states, out
    shape = chain_shape(n_frames, chain_unroll(static, colliders))
    out = None
    for i, u in enumerate(shape):
        states, out = fused_step_fleet(static, params, colliders, states, frames, unroll=u,
                                       stats=i == len(shape) - 1)
    return states, out


def multi_step_fleet(static, params, colliders, states, frames, n_frames: int, _captured: bool = True):
    """multi_step_fleet_stacked with ONE params shared by every slot (the
    common fleet: S spawners of one configuration). The kernel reads the
    one table for every slot, so nothing is broadcast."""
    if is_stacked_params(params):
        raise ValueError("multi_step_fleet takes one shared SpawnerParams; stacked params go to "
                         "multi_step_fleet_stacked")
    return multi_step_fleet_stacked(static, params, colliders, states, frames, n_frames, _captured)


# The card's launch counters (the wrappers' attributes), by name
# "function.attribute": a captured chain (`chain_graph`) records how many of
# each its graph holds, and counts its replays by them.
LAUNCH_COUNTERS = {f"{obj.__name__}.{attr}": (obj, attr) for obj, attr in (
    (fused_step, "launches"), (fused_step, "render_launches"), (fused_step, "render_f16_launches"),
    (fused_step, "collide_launches"), (fused_step, "broad_launches"), (fused_step, "fields_launches"),
    (fused_step, "dump_launches"), (fused_step, "stats_launches"), (fused_step, "merge_launches"),
    (fused_step, "fold_launches"), (fused_step, "merge_lean_launches"), (fused_step, "merge_wide_launches"),
    (fused_step, "shard_launches"), (fused_step, "dead_claim_launches"), (tile_dead_offsets, "launches"),
    (claim_counts, "seeds"), (nested_stage, "launches"), (nested_cadence_pass, "launches"),
    (nested_child_rows, "launches"), (_seed_nested_carry, "launches"), (fused_step_fleet, "launches"),
    (fused_step_fleet, "render_launches"), (fused_step_fleet, "render_f16_launches"),
    (fused_step_fleet, "collide_launches"), (fused_step_fleet, "broad_launches"),
    (fused_step_fleet, "fields_launches"), (fused_step_fleet, "dump_launches"),
    (fused_step_fleet, "stats_launches"))}


def launch_counts() -> dict:
    """The launch counters' current values, by name (`LAUNCH_COUNTERS`)."""
    return {k: getattr(obj, attr) for k, (obj, attr) in LAUNCH_COUNTERS.items()}
