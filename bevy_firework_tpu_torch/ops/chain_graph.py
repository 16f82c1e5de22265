"""Captured chains: a chain of step launches as one CUDA graph per static
configuration, replayed on the card.

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

The first call of a key steps the chain's launches uncaptured (its result
is the call's; the same run builds the kernels, fills the occupancy cache
and makes the shared-memory opt-ins, so that nothing in the captured region
makes them), then records the same launches on a side stream into a graph
whose inputs are static buffers. A replay then, on the caller's stream:

  * writes the chain's host words (`chain_words`: the frame rows, each
    launch's draw seeds and each nested stage's key, from the one-pass key
    chains of `prng`) into one of two pinned buffers (the other may still
    feed a pending copy: an event guards each) and copies them, one
    asynchronous copy, into the graph's device words, which the kernels
    read in place of their by-value arguments (`fused_step.DeviceWords`);
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
never comes here.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import time

import numpy as np
import torch

from ..compiled import SpawnerStatic
from ..parallel.sharding import frame_slot, is_stacked_params, params_slot
from ..pool import FrameInput, PoolState
from ..prng import chain_seeds, chain_seeds_stacked, hybrid_chain_keys
from ..step import collision_on, fields_on, has_nested, nested_emitters
from . import fused_step as fs

KINDS = ("auto", "auto_packed", "unfolded", "fleet")
MAX_GRAPHS = 32  # graphs kept (least recently used dropped first, with their pools)

COUNTS = {"captures": 0, "replays": 0, "capture_s": 0.0}  # capture_s: host seconds in captures
CAPTURED: dict = {}  # launches recorded by captures, by launch counter
REPLAYED: dict = {}  # launches run by replays, by launch counter

_GRAPHS: "collections.OrderedDict" = collections.OrderedDict()
_CAPTURE_STREAMS: dict = {}


def reset_counts() -> None:
    """Set the capture and replay counts to 0."""
    COUNTS.update(captures=0, replays=0, capture_s=0.0)
    CAPTURED.clear()
    REPLAYED.clear()


def clear() -> None:
    """Drop every graph (and its pool and static buffers)."""
    _GRAPHS.clear()


def _chain(kind: str):
    return {"auto": fs._multi_step_auto, "auto_packed": fs._multi_step_auto_packed,
            "unfolded": fs.chain_hybrid_unfolded, "fleet": fs._multi_step_fleet_stacked}[kind]


def _field_tables(kind: str, static: SpawnerStatic, frame: FrameInput) -> list:
    """The field tables whose records a chain reads by address (a solo
    chain's one table, a nested fleet's one per slot), or []."""
    if kind != "fleet":
        return [frame.force_fields] if fields_on(frame) else []
    if fs.can_fleet(static) or frame.force_fields is None:
        return []
    return [t for t in frame.force_fields if t.count > 0]


def graph_key(kind: str, static: SpawnerStatic, params, colliders, state: PoolState, frame: FrameInput,
              n_frames: int) -> tuple:
    """The graph a chain replays: the entry point, the static configuration,
    the frame count, the pool's leaf shapes and dtypes (capacity, slots,
    emitters), the table's shape, the collider and field-record counts and
    sizes, and the device. No value enters it."""
    if kind not in KINDS:
        raise ValueError(f"no chain {kind!r}; the chains are {KINDS}")
    leaves = tuple((k, tuple(getattr(state, k).shape), str(getattr(state, k).dtype))
                   for k in (f.name for f in dataclasses.fields(PoolState)))
    table = tuple(fs.kernel_tables(static, params).shape)
    col = (colliders.count, tuple(colliders.hull_counts)) if collision_on(static, colliders) else None
    if kind == "fleet" and fs.can_fleet(static):
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
    slot by slot."""
    key = state.rng_key.numpy()
    n = int(n_frames)
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
            unroll = fs.chain_unroll(static, colliders)
            shape = fs.chain_shape(n, unroll) if kind == "auto" else (
                fs.chain_shape(n - 1, unroll) if n > 1 else []) + [1]
            final, seeds = chain_seeds(key, shape)
            for s in seeds:
                parts += [row, s]
    elif kind == "fleet":
        if fs.can_fleet(static):
            final, seeds = chain_seeds_stacked(key, fs.chain_shape(n, fs.chain_unroll(static, colliders)))
            parts = [s.reshape(-1) for s in seeds]
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
    if kind == "fleet" and fs.can_fleet(static):
        out.append(fs.fleet_slot_rows(frame, state.device))
    else:
        out += [fs.kernel_fields(t) for t in _field_tables(kind, static, frame)]
    return out


class _Chain:
    """One captured chain: its graph, static inputs, device words and the
    map from its outputs to a call's results."""

    def __init__(self, kind, static, params, colliders, state: PoolState, frame: FrameInput, n_frames: int):
        dev = state.device
        self.kind, self.static, self.n_frames = kind, static, n_frames
        # the static inputs: the pool's device leaves and the address inputs
        in_leaves: list = []
        self.state_spec = _flatten(state, in_leaves)
        self.in_static = [torch.empty_like(t, memory_format=torch.contiguous_format) if t.device.type == "cuda"
                          else t.clone() for t in in_leaves]
        state_s = _unflatten(self.state_spec, self.in_static)
        sources = _address_sources(kind, static, params, colliders, state, frame)
        self.addr_static = [torch.empty_like(t) for t in sources]
        params_s, colliders_s, frame_s = self._proxies(params, colliders, frame, dev)
        # the device words, at the capture's own values
        words, _final = chain_words(kind, static, colliders, state, frame, n_frames)
        self.n_words = words.size
        self.words_dev = torch.empty(max(words.size, 1), dtype=torch.int32, device=dev)
        self.pinned = [torch.empty(max(words.size, 1), dtype=torch.int32, pin_memory=True) for _ in range(2)]
        self.events = [torch.cuda.Event(), torch.cuda.Event()]
        self.flip = 0
        dw = fs.DeviceWords(words, self.words_dev[:words.size])
        # capture on the side stream, after the caller's stream's work
        cap = _capture_stream(dev)
        S = state.px.shape[0] if state.px.dim() == 2 else 1
        fs.prepare_stream_scratch(dev, cap.cuda_stream, S, static.num_types)
        cap.wait_stream(torch.cuda.current_stream(dev))
        before = fs.launch_counts()
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(cap):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                with fs.device_words(dw):
                    out = _chain(kind)(static, params_s, colliders_s, state_s, frame_s, n_frames)
            except BaseException:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass
                fs.release_stream_scratch(dev, cap.cuda_stream)
                raise
            self.graph.capture_end()
        self.capture_s = time.perf_counter() - t0  # the chain's host code, the recording and the instantiation
        torch.cuda.current_stream(dev).wait_stream(cap)
        after = fs.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        self.scratch = fs.release_stream_scratch(dev, cap.cuda_stream)  # the graph's from now on
        # the outputs: pass-through leaves of the input (the caller's own
        # tensors on a replay), the host key (the key chain's), graph tensors
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
        if not static.ring_claim and kind != "fleet":
            counts = fs._carried_claim(st_out.alive)
            if counts is not None:
                self.carry = (next(i for i, t in enumerate(self.graph_out) if t is st_out.alive), counts)
        fs._forget_claim(state_s.alive)
        COUNTS["captures"] += 1
        COUNTS["capture_s"] += self.capture_s
        for k, v in self.launches.items():
            CAPTURED[k] = CAPTURED.get(k, 0) + v

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
        if kind == "fleet" and fs.can_fleet(static):
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

    def replay(self, params, colliders, state: PoolState, frame: FrameInput):
        dev = state.device
        stream = torch.cuda.current_stream(dev)
        words, final = chain_words(self.kind, self.static, colliders, state, frame, self.n_frames)
        if words.size != self.n_words:
            raise RuntimeError(f"a chain's words changed length ({words.size}, captured {self.n_words})")
        i, self.flip = self.flip, self.flip ^ 1
        if not self.events[i].query():  # the copy two replays back still reads this buffer
            self.events[i].synchronize()
        if words.size:
            self.pinned[i].numpy()[:words.size] = words.view(np.int32)
            self.words_dev.copy_(self.pinned[i], non_blocking=True)
        self.events[i].record(stream)
        in_leaves: list = []
        _flatten(state, in_leaves)
        sources = _address_sources(self.kind, self.static, params, colliders, state, frame)
        _copy_all([self.in_static[j] for j in self.copy_in] + self.addr_static,
                  [in_leaves[j] for j in self.copy_in] + sources)
        self.graph.replay()
        cloned = [torch.empty_like(t) for t in self.graph_out]
        _copy_all(cloned, self.graph_out)
        key = torch.from_numpy(final.astype(np.int64))
        leaves = [key if m[0] == "key" else in_leaves[m[1]] if m[0] == "in" else cloned[m[1]] for m in self.out_map]
        if self.carry is not None:
            fs._carry_claim(cloned[self.carry[0]], self.carry[1].clone())
        COUNTS["replays"] += 1
        for k, v in self.launches.items():
            REPLAYED[k] = REPLAYED.get(k, 0) + v
        return _unflatten(self.out_spec, leaves)


def graph_of(kind: str, static: SpawnerStatic, params, colliders, state: PoolState, frame: FrameInput,
             n_frames: int) -> "_Chain":
    """The captured chain these arguments replay (KeyError before the first
    call): its `graph` (a torch.cuda.CUDAGraph), `launches` and
    `capture_s`."""
    return _GRAPHS[graph_key(kind, static, params, colliders, state, frame, n_frames)]


def replay(kind: str, static: SpawnerStatic, params, colliders, state: PoolState, frame: FrameInput,
           n_frames: int):
    """The chain `kind` ("auto": `multi_step_auto`, "auto_packed":
    `multi_step_auto_packed`, "fleet": `multi_step_fleet_stacked`,
    "unfolded": `chain_hybrid_unfolded`, a nested chain without the fold,
    the uncaptured side of the fold's A/B) of
    n_frames frames on the card, from its graph: the first call of a key
    steps the launches and captures them, later calls replay the graph.
    Returns what the uncaptured chain returns, bit for bit."""
    if state.device.type != "cuda":
        raise ValueError(f"a captured chain runs on a CUDA device, not {state.device}")
    key = graph_key(kind, static, params, colliders, state, frame, n_frames)
    g = _GRAPHS.get(key)
    if g is not None:
        _GRAPHS.move_to_end(key)
        return g.replay(params, colliders, state, frame)
    result = _chain(kind)(static, params, colliders, state, frame, n_frames)
    _GRAPHS[key] = _Chain(kind, static, params, colliders, state, frame, n_frames)
    while len(_GRAPHS) > MAX_GRAPHS:
        _GRAPHS.popitem(last=False)
    return result
