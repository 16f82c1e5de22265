"""Captured chains: a chain of step launches as one CUDA graph per static
configuration, replayed on the card; and a Scene's step, every group's
chain in one graph.

In the JAX package a chain is one dispatch: `multi_step_auto`
(`bevy_firework_tpu/ops/fused_step.py:2855`) is `jax.jit` over `lax.scan`
(`_multi_step_impl` :2828, `_chain` :2777, `_chain_with_unroll` :2799), and
so are `_chain_nested_folded` (:2635), `multi_step_auto_packed` (:2723),
`multi_step_fleet_stacked` (:2873) and `multi_step_fleet` (:2908). The
port's counterparts (`ops.fused_step.multi_step_auto`,
`multi_step_auto_packed`, `multi_step_fleet_stacked`, `multi_step_fleet`)
route here on the card: `replay` keeps one `torch.cuda.CUDAGraph` per key,
as `jit` keeps one executable per static arguments and shapes
(`graph_key`: the entry point, the static configuration, the frame count,
the pool's leaf shapes and dtypes (capacity, slots, emitters), the table,
collider and field-record sizes, the device). A value never recaptures:
dt, transforms, params, colliders and field records are arguments of a
replay, as a new frame is a new argument of a `jit`.

The JAX Scene steps every archetype group in one jitted program
(`_scene_step_combined`, `bevy_firework_tpu/scene.py:381`); the port's
Scene replays one graph holding several chains, its segments
(`replay_segments`: one graph per scene signature, or per group past the
Scene's signature limit). A segment is a solo spawner's chain ("auto",
"auto_packed"), a group's fleet chain ("fleet", "fleet_packed": n - 1
fleet frames and one packed fleet launch) or a nested member's chain.

The first call of a key steps the chains' launches uncaptured (its result
is the call's; the same run builds the kernels, fills the occupancy cache
and makes the shared-memory opt-ins, so that nothing in the captured region
makes them), then records the same launches on a side stream into a graph
whose inputs are static buffers. A replay then, on the caller's stream:

  * writes the chains' host words (`chain_words`: the frame rows, each
    launch's draw seeds and each nested stage's key, from the one-pass key
    chains of `prng`; a graph's segments' words joined in segment order)
    into one of two pinned buffers (the other may still feed a pending
    copy: an event guards each) and copies them, one asynchronous copy,
    into the graph's device words, which the kernels read in place of
    their by-value arguments (`fused_step.DeviceWords`);
  * copies the inputs the graph reads by address into its static buffers:
    the pool's leaves (all but those the chain passes through untouched),
    the spawner table, the collider table, the field records or a fleet's
    slot rows (a few KB each);
  * replays the graph and clones its outputs out of the graph's pool, so a
    returned state stays valid after later calls, as the outputs of a
    `jit` without donation; leaves the chain passed through are the
    caller's own tensors, as an uncaptured chain returns them; the new
    `rng_key` is the key chain's, computed on the host.

A caller's input is never written. The chain's first dead-rank launch
seeds its claim counts inside the graph (`fused_step.claim_counts` of the
static alive plane), and after a replay the cloned alive plane carries
the counts the last launch left, as an uncaptured chain leaves them. The
per-stream scratch of the capture stream is made before the capture and
then belongs to the graph. The launch counters (`fused_step.LAUNCH_COUNTERS`)
count a captured launch once, when it is recorded; `COUNTS` counts
captures and replays, `CAPTURED` and `REPLAYED` the launches those hold by
counter. A failed capture raises: nothing steps a chain uncaptured in its
place. Calls of one graph are ordered on the caller's stream; the CPU path
never comes here. At most MAX_GRAPHS graphs are kept, the least recently
used dropped first, and past MAX_GRAPH_BYTES of static inputs and
outputs the same way, but never one that the call names in `keep` (a
Scene's step keeps the graphs of its own groups); a dropped graph is
captured again at its next call.

The XLA layout's chain (kind "xla": the top-level `multi_step` and
`step_jit`, the JAX package's `multi_step`, `jax.jit` over `lax.scan` at
`bevy_firework_tpu/step.py:904-925`, and its `step_jit`) is composed torch,
hundreds of kernels a frame, so it is not unrolled: `_XlaGraph` captures
the scan body (`xla_step.chain_frame` without stats, its state written
back into its own static pool) and the last frame (with stats) as two
graphs under one key that holds no frame count. Its first call warms one
frame of each up on the static inputs, captures both and replays them; a
call of n frames copies in the pool, the spawner params, the collider and
field tensors and one device buffer holding the frame row, a frame
counter and the chain's key words (`prng.xla_chain_keys`, at most XLA_ROWS
frames per copy), replays the body n - 1 times and the last frame once,
and clones the last frame's outputs out. `step_jit` replays the last
frame alone.

A Scene captures a signature only when it comes back (`defer`): its first
call steps the launches one by one and captures nothing (a signature met
once, as a new spawner's while effects of new kinds keep coming, costs no
capture), its second captures the graph, without running the launches
again, and replays it. A step captures at most one graph: in per-group
mode a group met again waits, stepped one by one, for a step with no other
capture.
"""

from __future__ import annotations

import collections
import copy
import ctypes
import dataclasses
import time

import numpy as np
import torch

from .. import xla_step
from ..colliders import TABLE_TENSORS
from ..compiled import SpawnerParams, SpawnerStatic
from ..force_fields import TABLE_SHAPES
from ..parallel.sharding import frame_slot, is_stacked_params, params_slot
from ..pool import FrameInput, PoolState
from ..prng import chain_seeds, chain_seeds_stacked, hybrid_chain_keys, xla_chain_keys
from ..step import ROTATION_FIELDS, active_f32_fields, collision_on, fields_on, has_nested, nested_emitters
from . import fused_step as fs
from . import table_layout as L

KINDS = ("auto", "auto_packed", "unfolded", "fleet", "fleet_packed", "xla")
XLA_ROWS = 256  # frames of key words an XLA chain's graph reads per copy: a longer chain copies them in chunks
MAX_GRAPHS = 32  # graphs kept (least recently used dropped first, with their pools)
MAX_GRAPH_BYTES = 8 << 30  # and the bytes of their static inputs and outputs
MAX_SEEN = 4 * MAX_GRAPHS  # keys met once (defer), the oldest forgotten first

COUNTS = {"captures": 0, "replays": 0, "capture_s": 0.0}  # capture_s: host seconds in captures
CAPTURED: dict = {}  # launches recorded by captures, by launch counter
REPLAYED: dict = {}  # launches run by replays, by launch counter

_GRAPHS: "collections.OrderedDict" = collections.OrderedDict()
_SEEN: "collections.OrderedDict" = collections.OrderedDict()  # keys stepped once uncaptured, awaiting their return
_CAPTURE_STREAMS: dict = {}
_POOL_LEAVES = tuple(f.name for f in dataclasses.fields(PoolState))
_PARAM_LEAVES = tuple(f.name for f in dataclasses.fields(SpawnerParams))
_LANE_F32 = ("px", "py", "pz", "vx", "vy", "vz") + ROTATION_FIELDS + ("initial_scale", "age", "lifetime")


def reset_counts() -> None:
    """Set the capture and replay counts to 0."""
    COUNTS.update(captures=0, replays=0, capture_s=0.0)
    CAPTURED.clear()
    REPLAYED.clear()


def clear() -> None:
    """Drop every graph (and its pool and static buffers) and forget the
    keys met once."""
    _GRAPHS.clear()
    _SEEN.clear()


def _chain(kind: str):
    return {"auto": fs._multi_step_auto, "auto_packed": fs._multi_step_auto_packed,
            "unfolded": fs.chain_hybrid_unfolded, "fleet": fs._multi_step_fleet_stacked,
            "fleet_packed": fs._multi_step_fleet_packed, "xla": xla_step.multi_step}[kind]


def run(kind: str, static: SpawnerStatic, params, colliders, state: PoolState, frame: FrameInput, n_frames: int):
    """The chain `kind` launched one by one (the plain versions on the
    CPU): what its graph's replay returns, bit for bit."""
    return _chain(kind)(static, params, colliders, state, frame, n_frames)


def _is_fleet(kind: str) -> bool:
    return kind in ("fleet", "fleet_packed")


def _field_tables(kind: str, static: SpawnerStatic, frame: FrameInput) -> list:
    """The field tables whose records a chain reads by address (a solo
    chain's one table, a nested fleet's one per slot), or []."""
    if not _is_fleet(kind):
        return [frame.force_fields] if fields_on(frame) else []
    if fs.can_fleet(static) or frame.force_fields is None:
        return []
    return [t for t in frame.force_fields if t.count > 0]


def graph_key(kind: str, static: SpawnerStatic, params, colliders, state: PoolState, frame: FrameInput,
              n_frames: int) -> tuple:
    """The graph a chain replays: the entry point, the static configuration,
    the frame count, the pool's leaf shapes and dtypes (capacity, slots,
    emitters), the table's shape, the collider and field-record counts and
    sizes, and the device. No value enters it. An XLA-layout chain's key
    holds no frame count (one capture serves every n) but the collider and
    field kinds and the params' shapes: its composed torch specialises on
    them."""
    if kind not in KINDS:
        raise ValueError(f"no chain {kind!r}; the chains are {KINDS}")
    leaves = tuple((k, t.shape, t.dtype) for k, t in ((k, getattr(state, k)) for k in _POOL_LEAVES))
    if kind == "xla":
        shapes = tuple(getattr(params, k).shape for k in _PARAM_LEAVES)
        col = (colliders.kinds, colliders.identity_rot, colliders.hull_counts,
               tuple(getattr(colliders, k).shape for k in TABLE_TENSORS)) if collision_on(static, colliders) else None
        fields = frame.force_fields.kinds if fields_on(frame) else None
        return kind, static, None, leaves, shapes, col, fields, str(state.device)
    if kind == "fleet_packed" and not fs.can_fleet(static):
        raise ValueError("a packed fleet chain takes global-only archetypes (can_fleet)")
    table = tuple(fs.kernel_tables(static, params).shape)
    col = (colliders.count, tuple(colliders.hull_counts)) if collision_on(static, colliders) else None
    if _is_fleet(kind) and fs.can_fleet(static):
        fields = (frame.force_fields[0].count if frame.force_fields else 0,)
    else:
        fields = tuple(t.count for t in _field_tables(kind, static, frame))
    return kind, static, int(n_frames), leaves, table, col, fields, str(state.device)


# --------------------------------------------------------------------------
# the chain's host words, in the order its launches take them
# --------------------------------------------------------------------------


def _hybrid_words(row: np.ndarray, seed, stage_keys: np.ndarray) -> list:
    """One hybrid frame's words: per nested emitter its stage's key and
    frame row, then the step launch's frame row and seed."""
    out = []
    for key in stage_keys:
        out += [key, row]
    return out + [row, np.array([seed], np.uint32)]


def chain_words(kind: str, static: SpawnerStatic, colliders, state: PoolState, frame: FrameInput,
                n_frames: int) -> tuple[np.ndarray, np.ndarray]:
    """The words a chain's launches read (uint32: frame rows, draw seeds and
    nested-stage keys, in the order the launches take them) and the key
    after the chain ([2], or a fleet's [S, 2]), in one host pass over the
    key chains (`prng.chain_seeds`, `chain_seeds_stacked`,
    `hybrid_chain_keys`). Launch by launch a chain takes: a solo step launch
    its frame row, then its U seeds; a fleet launch its S * U seeds
    (slot-major; its chunks in turn); a hybrid frame, per nested emitter
    the stage's key and frame row, then the step launch's frame row and
    seed. A nested fleet steps its slots' hybrid frames frame by frame,
    slot by slot. A packed chain's last frame is one more launch of one
    frame. An XLA-layout chain ("xla") takes per frame its fold-ins
    (`prng.xla_chain_keys` of `xla_step.keyed_data`), two words each; its
    frame row goes beside them (`_XlaGraph`)."""
    key = state.rng_key.numpy()
    n = int(n_frames)
    if kind == "xla":
        final, keys = xla_chain_keys(key, n, xla_step.keyed_data(static))
        return keys.reshape(-1), final
    es = nested_emitters(static)
    parts: list = []
    if kind in ("auto", "auto_packed", "unfolded"):
        row = fs._frame_row(frame).view(np.uint32)
        if has_nested(static):
            final, seeds, stage = hybrid_chain_keys(key, n, es)
            for f in range(n):
                parts += _hybrid_words(row, seeds[f], stage[f])
        elif kind == "unfolded":
            raise ValueError("an unfolded chain steps hybrid frames: an archetype with a nested emitter")
        else:
            final, seeds = chain_seeds(key, _launch_shape(kind, static, colliders, n))
            for s in seeds:
                parts += [row, s]
    elif _is_fleet(kind):
        if fs.can_fleet(static):
            final, seeds = chain_seeds_stacked(key, _launch_shape(kind, static, colliders, n))
            parts = [s.reshape(-1) for s in seeds]
        elif kind == "fleet_packed":
            raise ValueError("a packed fleet chain takes global-only archetypes (can_fleet)")
        else:
            S = key.shape[0]
            rows = [fs._frame_row(frame_slot(frame, i)).view(np.uint32) for i in range(S)]
            chains = [hybrid_chain_keys(key[i], n, es) for i in range(S)]
            for f in range(n):
                for i in range(S):
                    parts += _hybrid_words(rows[i], chains[i][1][f], chains[i][2][f])
            final = np.stack([c[0] for c in chains])
    else:
        raise ValueError(f"no chain {kind!r}; the chains are {KINDS}")
    words = np.concatenate([np.asarray(p, np.uint32).reshape(-1) for p in parts]) if parts else \
        np.zeros(0, np.uint32)
    return words, final


def _launch_shape(kind: str, static: SpawnerStatic, colliders, n: int) -> list:
    """Frames per launch of a chain of global-only launches: the chain's
    shape, and for a packed chain the shape of n - 1 frames and one
    packed frame."""
    unroll = fs.chain_unroll(static, colliders)
    if kind in ("auto", "fleet"):
        return fs.chain_shape(n, unroll)
    return (fs.chain_shape(n - 1, unroll) if n > 1 else []) + [1]


def segment_words(segments) -> tuple[np.ndarray, list]:
    """A graph's words, its segments' `chain_words` joined in segment
    order, and each segment's key after its chain. segments: (kind,
    static, params, colliders, state, frame, n_frames) each."""
    parts, finals = [], []
    for kind, static, _params, colliders, state, frame, n in segments:
        w, final = chain_words(kind, static, colliders, state, frame, n)
        parts.append(w)
        finals.append(final)
    return (np.concatenate(parts) if parts else np.zeros(0, np.uint32)), finals


# --------------------------------------------------------------------------
# pytrees of the chain's results
# --------------------------------------------------------------------------


def _flatten(obj, leaves: list):
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return len(leaves) - 1
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return type(obj), tuple((f.name, _flatten(getattr(obj, f.name), leaves)) for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return type(obj), tuple(_flatten(x, leaves) for x in obj)
    raise TypeError(f"a chain's result holds a {type(obj).__name__}")


def _unflatten(spec, leaves: list):
    if spec is None:
        return None
    if isinstance(spec, int):
        return leaves[spec]
    typ, items = spec
    if dataclasses.is_dataclass(typ):
        return typ(**{name: _unflatten(s, leaves) for name, s in items})
    return typ(_unflatten(s, leaves) for s in items)


def _copy_all(dsts: list, srcs: list) -> None:
    """dst.copy_(src) for each pair, grouped by dtype into `_foreach_copy_`
    calls (one multi-tensor copy per group where PyTorch takes its fast
    route)."""
    groups: dict = {}
    for d, s in zip(dsts, srcs):
        groups.setdefault(d.dtype, ([], []))
        groups[d.dtype][0].append(d)
        groups[d.dtype][1].append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def _clone_plan(outs: list) -> list:
    """A graph's outputs grouped for the clone-out: by dtype, the contiguous
    apart from the others (strided views, such as a fleet's stats-row
    outputs), so that each contiguous group's copy takes PyTorch's fast
    route (one multi-tensor copy: its pairs' strides agree) and the few
    strided ones alone take the slow one (a copy per tensor)."""
    groups: dict = {}
    for i, t in enumerate(outs):
        groups.setdefault((t.dtype, t.is_contiguous()), []).append(i)
    return list(groups.values())


def _clone_out(outs: list, plan: list) -> list:
    """Fresh copies of `outs`, one `_foreach_copy_` per `_clone_plan`
    group."""
    cloned = [torch.empty_like(t) for t in outs]
    for idx in plan:
        torch._foreach_copy_([cloned[i] for i in idx], [outs[i] for i in idx])
    return cloned


def _poison(t: torch.Tensor) -> None:
    """Fill a static buffer that no replay copies into, so that a graph that
    did read it could not pass for right."""
    if t.dtype.is_floating_point:
        t.fill_(float("nan"))
    elif t.dtype == torch.bool:
        t.fill_(True)
    else:
        t.fill_(-1)


# --------------------------------------------------------------------------
# the graph
# --------------------------------------------------------------------------


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


def _address_sources(kind: str, static: SpawnerStatic, params, colliders, state: PoolState,
                     frame: FrameInput) -> list:
    """The device tensors a chain reads by address besides the pool, in a
    fixed order: the spawner table, the collider table, then the field
    records (a solo chain's, or a nested fleet's per slot) or a fleet's
    slot rows."""
    out = [fs.kernel_tables(static, params)]
    if collision_on(static, colliders):
        out.append(fs.kernel_colliders(colliders))
    if _is_fleet(kind) and fs.can_fleet(static):
        out.append(fs.fleet_slot_rows(frame, state.device))
    else:
        out += [fs.kernel_fields(t) for t in _field_tables(kind, static, frame)]
    return out


class _Segment:
    """One chain of a graph: its static inputs, the place of its words in
    the graph's device words and the map from its outputs to a call's
    results."""

    def __init__(self, kind, static, params, colliders, state: PoolState, frame: FrameInput, n_frames: int, at: int):
        dev = state.device
        self.kind, self.static, self.n_frames, self.at = kind, static, n_frames, at
        self.slots = state.px.shape[0] if state.px.dim() == 2 else 1
        # the static inputs: the pool's device leaves and the address inputs
        in_leaves: list = []
        self.state_spec = _flatten(state, in_leaves)
        if len(in_leaves) != len(_POOL_LEAVES):  # `inputs` lists a replay's leaves field by field
            raise ValueError("a captured chain's pool holds a tensor in every field")
        self.in_static = [torch.empty_like(t, memory_format=torch.contiguous_format) if t.device.type == "cuda"
                          else t.clone() for t in in_leaves]
        self.state_s = _unflatten(self.state_spec, self.in_static)
        sources = _address_sources(kind, static, params, colliders, state, frame)
        self.addr_static = [torch.empty_like(t) for t in sources]
        self.params_s, self.colliders_s, self.frame_s = self._proxies(params, colliders, frame, dev)
        # the words at the capture's own values
        self.words, _final = chain_words(kind, static, colliders, state, frame, n_frames)
        self.n_words = self.words.size

    def _proxies(self, params, colliders, frame: FrameInput, device: torch.device):
        """params, colliders and frame whose device tables are the static
        buffers (caches set on shallow copies; the caller's objects keep
        theirs)."""
        static, kind = self.static, self.kind
        it = iter(self.addr_static)
        table = next(it)
        params_s = copy.copy(params)
        params_s.__dict__["_kernel_tables"] = {static: table}
        if is_stacked_params(params) and kind == "fleet" and not fs.can_fleet(static):
            members = []
            for i in range(table.shape[0]):  # a nested fleet's slots step solo: a proxy per slot
                m = copy.copy(params_slot(params, i))
                m.__dict__["_kernel_tables"] = {static: table[i]}
                members.append(m)
            params_s.__dict__["_members"] = members
        else:
            params_s.__dict__.pop("_members", None)
        colliders_s = colliders
        if collision_on(static, colliders):
            colliders_s = copy.copy(colliders)
            colliders_s.__dict__["_kernel_colliders"] = next(it)
        if _is_fleet(kind) and fs.can_fleet(static):
            frame_s = copy.copy(frame)
            frame_s.__dict__["_slot_rows"] = {device: next(it)}
            return params_s, colliders_s, frame_s
        tables = _field_tables(kind, static, frame)
        proxies = {}
        for t in tables:
            p = copy.copy(t)
            p.__dict__["_kernel_fields"] = next(it)
            proxies[id(t)] = p
        if kind == "fleet":  # a nested fleet: each slot's table
            ff = None if frame.force_fields is None else [proxies.get(id(t), t) for t in frame.force_fields]
        else:
            ff = proxies.get(id(frame.force_fields), frame.force_fields)
        frame_s = dataclasses.replace(frame, force_fields=ff)
        return params_s, colliders_s, frame_s

    def record(self, words_dev: torch.Tensor):
        """The chain's launches on the static inputs, reading the segment's
        part of the graph's device words (inside the capture)."""
        dw = fs.DeviceWords(self.words, words_dev[self.at:self.at + self.n_words])
        with fs.device_words(dw):
            return _chain(self.kind)(self.static, self.params_s, self.colliders_s, self.state_s, self.frame_s,
                                     self.n_frames)

    def bind(self, out) -> None:
        """Map the recorded chain's outputs: pass-through leaves of the
        input (the caller's own tensors on a replay), the host key (the key
        chain's), graph tensors; poison the static leaves no replay copies
        into."""
        out_leaves: list = []
        self.out_spec = _flatten(out, out_leaves)
        st_out = out[0]
        static_ids = {id(t): i for i, t in enumerate(self.in_static)}
        static_storage = {t.untyped_storage().data_ptr() for t in self.in_static if t.device.type == "cuda"}
        self.out_map = []  # per output leaf: ("in", input index), ("key",) or ("graph", graph index)
        self.graph_out: list = []
        graph_ids: dict = {}
        for t in out_leaves:
            if t is st_out.rng_key:
                self.out_map.append(("key",))
            elif id(t) in static_ids:
                self.out_map.append(("in", static_ids[id(t)]))
            elif t.device.type != "cuda":
                raise RuntimeError(f"a captured chain returned a host tensor other than its key: {tuple(t.shape)}")
            elif t.untyped_storage().data_ptr() in static_storage:
                raise RuntimeError("a captured chain returned a view of its static input")
            else:
                if id(t) not in graph_ids:
                    graph_ids[id(t)] = len(self.graph_out)
                    self.graph_out.append(t)
                self.out_map.append(("graph", graph_ids[id(t)]))
        passed = {m[1] for m in self.out_map if m[0] == "in"}
        # a replay copies the leaves the chain does not pass through; the
        # others it never reads (poisoned here, so a read would show)
        self.copy_in = [i for i, t in enumerate(self.in_static) if t.device.type == "cuda" and i not in passed]
        for i in passed:
            _poison(self.in_static[i])
        self.carry = None  # the carried claim counts of the final alive plane (graph tensor), dead-rank chains
        if not self.static.ring_claim and not _is_fleet(self.kind):
            counts = fs._carried_claim(st_out.alive)
            if counts is not None:
                self.carry = (next(i for i, t in enumerate(self.graph_out) if t is st_out.alive), counts)
        fs._forget_claim(self.state_s.alive)

    def inputs(self, params, colliders, state: PoolState, frame: FrameInput, dsts: list, srcs: list) -> list:
        """Add this replay's copy-in pairs to dsts / srcs; returns the
        input's leaves."""
        in_leaves = [getattr(state, k) for k in _POOL_LEAVES]  # _flatten's order for a PoolState
        dsts += [self.in_static[j] for j in self.copy_in] + self.addr_static
        srcs += [in_leaves[j] for j in self.copy_in] + _address_sources(self.kind, self.static, params, colliders,
                                                                         state, frame)
        return in_leaves

    def result(self, cloned: list, in_leaves: list, final: np.ndarray):
        key = torch.from_numpy(final.astype(np.int64))
        leaves = [key if m[0] == "key" else in_leaves[m[1]] if m[0] == "in" else cloned[m[1]] for m in self.out_map]
        if self.carry is not None:
            fs._carry_claim(cloned[self.carry[0]], self.carry[1].clone())
        return _unflatten(self.out_spec, leaves)


class _Graph:
    """One captured graph: its segments' chains recorded in segment order on
    one stream, their words in one device buffer."""

    def __init__(self, segments):
        dev = segments[0][4].device
        self.segments, at = [], 0
        for args in segments:
            self.segments.append(_Segment(*args, at))
            at += self.segments[-1].n_words
        self.n_words = at
        self.words_dev = torch.empty(max(at, 1), dtype=torch.int32, device=dev)
        self.pinned = [torch.empty(max(at, 1), dtype=torch.int32, pin_memory=True) for _ in range(2)]
        self.events = [torch.cuda.Event(), torch.cuda.Event()]
        self.flip = 0
        # capture on the side stream, after the caller's stream's work
        cap = _capture_stream(dev)
        for seg in self.segments:  # the scratch grows to the largest segment's
            fs.prepare_stream_scratch(dev, cap.cuda_stream, seg.slots, seg.static.num_types)
        cap.wait_stream(torch.cuda.current_stream(dev))
        before = fs.launch_counts()
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(cap):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                outs = [seg.record(self.words_dev) for seg in self.segments]
            except BaseException:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass
                fs.release_stream_scratch(dev, cap.cuda_stream)
                raise
            self.graph.capture_end()
        self.capture_s = time.perf_counter() - t0  # the chains' host code, the recording and the instantiation
        torch.cuda.current_stream(dev).wait_stream(cap)
        after = fs.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        self.scratch = fs.release_stream_scratch(dev, cap.cuda_stream)  # the graph's from now on
        for seg, out in zip(self.segments, outs):
            seg.bind(out)
        self.outs = [t for seg in self.segments for t in seg.graph_out]
        self.clone_plan = _clone_plan(self.outs)
        self.nbytes = sum(t.nbytes for seg in self.segments for t in seg.in_static + seg.addr_static
                          if t.device.type == "cuda") + sum(t.nbytes for t in self.outs)
        COUNTS["captures"] += 1
        COUNTS["capture_s"] += self.capture_s
        for k, v in self.launches.items():
            CAPTURED[k] = CAPTURED.get(k, 0) + v

    @property
    def copy_in_leaves(self) -> int:
        return sum(len(s.copy_in) + len(s.addr_static) for s in self.segments)

    @property
    def clone_out_leaves(self) -> int:
        return sum(len(s.graph_out) for s in self.segments)

    def replay(self, segments) -> list:
        dev = self.words_dev.device
        stream = torch.cuda.current_stream(dev)
        words, finals = segment_words(segments)
        if words.size != self.n_words:
            raise RuntimeError(f"a graph's words changed length ({words.size}, captured {self.n_words})")
        i, self.flip = self.flip, self.flip ^ 1
        if not self.events[i].query():  # the copy two replays back still reads this buffer
            self.events[i].synchronize()
        if words.size:
            self.pinned[i].numpy()[:words.size] = words.view(np.int32)
            self.words_dev.copy_(self.pinned[i], non_blocking=True)
        self.events[i].record(stream)
        dsts: list = []
        srcs: list = []
        ins = [seg.inputs(params, colliders, state, frame, dsts, srcs)
               for seg, (_kind, _static, params, colliders, state, frame, _n) in zip(self.segments, segments)]
        _copy_all(dsts, srcs)
        self.graph.replay()
        cloned = _clone_out(self.outs, self.clone_plan)
        results, at = [], 0
        for seg, in_leaves, final in zip(self.segments, ins, finals):
            results.append(seg.result(cloned[at:at + len(seg.graph_out)], in_leaves, final))
            at += len(seg.graph_out)
        COUNTS["replays"] += 1
        for k, v in self.launches.items():
            REPLAYED[k] = REPLAYED.get(k, 0) + v
        return results


# --------------------------------------------------------------------------
# the XLA layout's chain: its scan body and its last frame
# --------------------------------------------------------------------------


def _xla_sources(static: SpawnerStatic, params, colliders, frame: FrameInput) -> list:
    """The device tensors an XLA-layout frame reads by address besides the
    pool, in a fixed order: the spawner params' leaves, the collider
    table's tensors (where the narrow phase runs), the field table's
    (where the frame has fields)."""
    out = [getattr(params, k) for k in _PARAM_LEAVES]
    if collision_on(static, colliders):
        out += [getattr(colliders, k) for k in TABLE_TENSORS]
    if fields_on(frame):
        out += [frame.force_fields.tensor(k) for k in TABLE_SHAPES]
    return out


def _graph_nodes(graph: torch.cuda.CUDAGraph) -> int | None:
    """The nodes of a graph captured with keep_graph=True and not yet
    instantiated (the driver's cuGraphGetNodes on its cudaGraph_t), or None
    where the driver cannot say."""
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    return int(n.value) if err == 0 else None


def _capture(graph: torch.cuda.CUDAGraph, fn):
    """fn() recorded into `graph` on the current stream; a failure ends the
    capture and raises."""
    graph.capture_begin(capture_error_mode="thread_local")
    try:
        out = fn()
    except BaseException:
        try:
            graph.capture_end()
        except RuntimeError:
            pass
        raise
    graph.capture_end()
    return out


class _XlaGraph:
    """An XLA-layout chain (kind "xla") captured as two graphs on one set of
    static inputs: `body`, one frame without stats (`xla_step.chain_frame`)
    whose new state is copied back into the static pool, and `last`, one
    frame with stats. Each reads the frame row and its key words from one
    device buffer (`words_dev`: FRAME_WORDS f32 words, the frame counter,
    XLA_ROWS rows of key words) and advances the counter. `nodes`: each
    graph's node count (None where it cannot be read); `capture_s`: host
    seconds of the two captures and instantiations; `nbytes`: its static
    inputs, words and outputs."""

    def __init__(self, segments):
        if len(segments) != 1:
            raise ValueError("an XLA-layout chain is captured alone, not among a scene's segments")
        _kind, static, params, colliders, state, frame, _n = segments[0]
        dev = state.device
        self.static = static
        self.w = 2 * len(xla_step.keyed_data(static))
        self.words_dev = torch.zeros(L.FRAME_WORDS + 1 + XLA_ROWS * self.w, dtype=torch.int32, device=dev)
        self.pinned = [None, None]
        self.events = [torch.cuda.Event(), torch.cuda.Event()]
        self.flip = 0
        self.in_static = [torch.empty_like(t, memory_format=torch.contiguous_format) if t.device.type == "cuda"
                          else t.clone() for t in (getattr(state, k) for k in _POOL_LEAVES)]
        state_s = PoolState(**dict(zip(_POOL_LEAVES, self.in_static)))
        self.addr_static = [torch.empty_like(t, memory_format=torch.contiguous_format)
                            for t in _xla_sources(static, params, colliders, frame)]
        it = iter(self.addr_static)
        params_s = SpawnerParams(**{k: next(it) for k in _PARAM_LEAVES})
        colliders_s = colliders
        if collision_on(static, colliders):
            colliders_s = dataclasses.replace(colliders, **{k: next(it) for k in TABLE_TENSORS})
        fields_s = None
        if fields_on(frame):
            fields_s = copy.copy(frame.force_fields)
            fields_s.__dict__["_tensors"] = {k: next(it) for k in TABLE_SHAPES}
        frame_row = self.words_dev[:L.FRAME_WORDS].view(torch.float32)
        words = self.words_dev[L.FRAME_WORDS:]
        static_ptrs = {t.untyped_storage().data_ptr() for t in self.in_static if t.device.type == "cuda"}

        def one(stats: bool):
            return xla_step.chain_frame(static, params_s, colliders_s, state_s, frame_row, fields_s, words, stats)

        def body():
            st, _out = one(False)
            dsts, srcs = [], []
            for j, k in enumerate(_POOL_LEAVES):
                t = getattr(st, k)
                if t is self.in_static[j] or t.device.type != "cuda":
                    continue
                if t.untyped_storage().data_ptr() in static_ptrs:
                    raise RuntimeError(f"a captured XLA frame returned a view of its static input as {k}")
                dsts.append(self.in_static[j])
                srcs.append(t)
            _copy_all(dsts, srcs)
            return st

        # warm-up: one frame of each on the capture's own inputs, on the
        # capture stream (kernels loaded, allocator blocks made), then the
        # two captures
        self.copy_in = [j for j, t in enumerate(self.in_static) if t.device.type == "cuda"]
        i = self._stage(static, state, frame, 1)[0]
        self._copy_in(params, colliders, state, frame, i)
        cap = _capture_stream(dev)
        cap.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(cap):
            one(False)
            one(True)
        t0 = time.perf_counter()
        self.body, self.last = torch.cuda.CUDAGraph(keep_graph=True), torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.stream(cap):
            body_state = _capture(self.body, body)
            out = _capture(self.last, lambda: one(True))
        self.nodes = [_graph_nodes(g) for g in (self.body, self.last)]
        for g in (self.body, self.last):
            g.instantiate()
        self.capture_s = time.perf_counter() - t0
        torch.cuda.current_stream(dev).wait_stream(cap)
        self._bind(static, body_state, out)
        COUNTS["captures"] += 1
        COUNTS["capture_s"] += self.capture_s

    def _bind(self, static: SpawnerStatic, body_state: PoolState, out) -> None:
        """Map the last frame's outputs (the key chain's key, the caller's
        leaves the frames pass through, graph tensors) and copy in only the
        leaves the frames may read: an elided field (rotation where the
        archetype keeps the identity, a constant lifetime) passes through
        both graphs unread, and is poisoned here."""
        st = out[0]
        passed = {j for j, k in enumerate(_POOL_LEAVES) if getattr(st, k) is self.in_static[j]}
        if passed != {j for j, k in enumerate(_POOL_LEAVES) if getattr(body_state, k) is self.in_static[j]}:
            raise RuntimeError("the captured XLA body and last frame pass different leaves through")
        active = set(active_f32_fields(static))
        elided = {j for j, k in enumerate(_POOL_LEAVES)
                  if k in _LANE_F32 and k not in active}
        if not elided <= passed:
            raise RuntimeError("a captured XLA frame wrote a field its archetype elides")
        self.copy_in = [j for j, t in enumerate(self.in_static) if t.device.type == "cuda" and j not in elided]
        for j in elided:
            _poison(self.in_static[j])
        out_leaves: list = []
        self.out_spec = _flatten(out, out_leaves)
        self.out_map, self.outs, ids = [], [], {}
        for t in out_leaves:
            if t is st.rng_key:
                self.out_map.append(("key",))
            elif any(t is s for s in self.in_static):
                self.out_map.append(("in", next(j for j, s in enumerate(self.in_static) if t is s)))
            else:
                if id(t) not in ids:
                    ids[id(t)] = len(self.outs)
                    self.outs.append(t)
                self.out_map.append(("graph", ids[id(t)]))
        self.clone_plan = _clone_plan(self.outs)
        self.nbytes = sum(t.nbytes for t in self.in_static + self.addr_static + self.outs + [self.words_dev]
                          if t.device.type == "cuda")

    def _stage(self, static: SpawnerStatic, state: PoolState, frame: FrameInput, n: int) -> tuple:
        """Write a call's host words into a pinned buffer: per chunk of at
        most XLA_ROWS frames, the frame row, a zero frame counter and the
        chunk's key words (int32 [chunks, len(words_dev)]). Returns (the
        buffer's index, the chunks, the key after the chain)."""
        words, final = chain_words("xla", static, None, state, frame, n)
        chunks = -(-n // XLA_ROWS)
        size = chunks * self.words_dev.numel()
        i, self.flip = self.flip, self.flip ^ 1
        if not self.events[i].query():  # the copy two calls back still reads this buffer
            self.events[i].synchronize()
        if self.pinned[i] is None or self.pinned[i].numel() < size:
            self.pinned[i] = torch.empty(size, dtype=torch.int32, pin_memory=True)
        host = self.pinned[i][:size].view(chunks, -1)
        h = host.numpy()
        h[:, :L.FRAME_WORDS] = fs._frame_row(frame).view(np.int32)
        h[:, L.FRAME_WORDS:] = 0
        rows = words.view(np.int32).reshape(n, self.w)
        for c in range(chunks):
            part = rows[c * XLA_ROWS:(c + 1) * XLA_ROWS].reshape(-1)
            h[c, L.FRAME_WORDS + 1:L.FRAME_WORDS + 1 + part.size] = part
        return i, host, final

    def _copy_in(self, params, colliders, state: PoolState, frame: FrameInput, i: int) -> None:
        srcs = [getattr(state, _POOL_LEAVES[j]) for j in self.copy_in]
        _copy_all([self.in_static[j] for j in self.copy_in] + self.addr_static,
                  srcs + _xla_sources(self.static, params, colliders, frame))
        self.words_dev.copy_(self.pinned[i][:self.words_dev.numel()], non_blocking=True)
        self.events[i].record(torch.cuda.current_stream(self.words_dev.device))

    def replay(self, segments) -> list:
        _kind, static, params, colliders, state, frame, n = segments[0]
        n = int(n)
        if n < 1:
            raise ValueError("an XLA-layout chain steps n >= 1 frames")
        i, host, final = self._stage(static, state, frame, n)
        self._copy_in(params, colliders, state, frame, i)
        for c in range(host.shape[0]):
            if c:
                self.words_dev.copy_(host[c], non_blocking=True)
            for f in range(c * XLA_ROWS, min((c + 1) * XLA_ROWS, n)):
                (self.last if f == n - 1 else self.body).replay()
        self.events[i].record(torch.cuda.current_stream(self.words_dev.device))
        cloned = _clone_out(self.outs, self.clone_plan)
        in_leaves = [getattr(state, k) for k in _POOL_LEAVES]
        key = torch.from_numpy(final.astype(np.int64))
        leaves = [key if m[0] == "key" else in_leaves[m[1]] if m[0] == "in" else cloned[m[1]] for m in self.out_map]
        COUNTS["replays"] += 1
        return [_unflatten(self.out_spec, leaves)]


def graph_of(kind: str, static: SpawnerStatic, params, colliders, state: PoolState, frame: FrameInput,
             n_frames: int) -> "_Graph":
    """The captured chain these arguments replay (KeyError before the first
    call): its `graph` (a torch.cuda.CUDAGraph), `launches` and
    `capture_s`."""
    return _GRAPHS[graph_key(kind, static, params, colliders, state, frame, n_frames)]


def _evict(keep=()) -> None:
    """Drop the least recently used graphs while more than MAX_GRAPHS are
    kept or they hold more than MAX_GRAPH_BYTES, none named in `keep`."""
    held = sum(g.nbytes for g in _GRAPHS.values())
    for k in list(_GRAPHS):
        if len(_GRAPHS) <= MAX_GRAPHS and held <= MAX_GRAPH_BYTES:
            return
        if k not in keep:
            held -= _GRAPHS.pop(k).nbytes


def replay_segments(key: tuple, segments: list, keep=(), defer: bool = False, capture: bool = True) -> list:
    """The chains of `segments` ((kind, static, params, colliders, state,
    frame, n_frames) each, in order) on the card from one graph, the one
    `key` names (which must hold every segment's `graph_key`): the first
    call of a key steps the launches one by one and captures them, later
    calls replay the graph. defer: the first call captures nothing, the
    second captures the graph (its launches built and warmed by the first)
    and replays it; with capture=False as well, a key that would be
    captured steps one by one and stays met (a Scene in per-group mode
    captures one group a step). Returns each segment's result, as `run`
    returns it, bit for bit. keep: keys of graphs not to drop while this
    one is kept."""
    g = _GRAPHS.get(key)
    if g is not None:
        _GRAPHS.move_to_end(key)
        return g.replay(segments)
    if any(s[4].device.type != "cuda" for s in segments):
        raise ValueError("a captured graph runs on a CUDA device")
    if segments[0][0] == "xla":  # warmed up on its static inputs and captured at its first call, then replayed
        _SEEN.pop(key, None)
        g = _GRAPHS[key] = _XlaGraph(segments)
        _evict(set(keep) | {key})
        return g.replay(segments)
    if defer and (key not in _SEEN or not capture):  # met (again): remembered, stepped one by one
        _SEEN[key] = None
        _SEEN.move_to_end(key)
        while len(_SEEN) > MAX_SEEN:
            _SEEN.popitem(last=False)
        return [run(*s) for s in segments]
    _SEEN.pop(key, None)
    results = None if defer else [run(*s) for s in segments]
    g = _GRAPHS[key] = _Graph(segments)
    _evict(set(keep) | {key})
    return g.replay(segments) if defer else results


def replay(kind: str, static: SpawnerStatic, params, colliders, state: PoolState, frame: FrameInput,
           n_frames: int):
    """The chain `kind` ("auto": `multi_step_auto`, "auto_packed":
    `multi_step_auto_packed`, "fleet": `multi_step_fleet_stacked`,
    "fleet_packed": n - 1 fleet frames and one packed fleet launch,
    "unfolded": `chain_hybrid_unfolded`, a nested chain without the fold,
    the uncaptured side of the fold's A/B; "xla": the XLA layout's
    `multi_step`, `_XlaGraph`) of
    n_frames frames on the card, from its graph: the first call of a key
    steps the launches and captures them (an XLA chain warms one frame up
    and captures), later calls replay the graph. Returns what the
    uncaptured chain returns, bit for bit."""
    if state.device.type != "cuda":
        raise ValueError(f"a captured chain runs on a CUDA device, not {state.device}")
    args = (kind, static, params, colliders, state, frame, n_frames)
    return replay_segments(graph_key(*args), [args])[0]
