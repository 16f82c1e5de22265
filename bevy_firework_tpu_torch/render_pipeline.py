"""Asynchronous device-to-host render readback into the native instance rings.

Bevy runs simulation and rendering in pipelined worlds: the render world
draws frame N-1 while the main world simulates frame N, with the extract
copy as the hand-off (reference render.rs:52-54). Here:

  sim thread:    step(N) -> submit(N): records an event on the current
                 stream and queues the frame's planes (still on the card);
                 returns at once
  reader thread: takes the oldest queued frame, copies its planes into a
                 pinned host buffer on a copy stream that waits for the
                 event, waits for the copy's done event, then interleaves
                 the planes into 64 B instance records in the ring
                 (compacting live lanes)
  render thread: acquire() -> the newest ready frame -> draw -> release()

The copy runs on its own stream, so it neither waits behind the next
frame's step on the sim's stream nor holds it back: it overlaps it. A
renderer or reader that falls behind skips frames (latest-wins): a full
queue drops its oldest frame, and a busy ring its oldest ready slot. On the
CPU (`device="cpu"` pools) the reader publishes the host tensors directly.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .native import InstanceRing, PlaneSet
from .render import ROW_DEFAULTS, pack_instances_dense, pack_instances_planar, record_columns

QUEUE_FRAMES = 4  # frames queued for the reader; a fifth evicts the oldest


class AsyncRenderReader:
    """Per-spawner async readback into one instance ring per particle type.

    mode "dense" (default): `submit` packs every lane (dead ones at scale 0,
    elementwise), the ring compacts the live lanes while interleaving on
    the host. mode "compact": the card compacts (`pack_instances_planar`: a
    cumsum and a scatter), the ring interleaves the first `count` columns.
    `submit_packed` hands over the step kernel's own render pack instead (no
    pack launch): the 9 f32 planes with the state's positions and
    quaternion, or the f16 record.

    Memory: a queued frame holds its planes on the card (at most
    QUEUE_FRAMES frames); the reader copies one frame at a time into pinned
    staging buffers it keeps and reuses, one frame's planes: with the
    packed f32 record at N lanes and rotation elided 12 x 4 x N bytes (63 MB
    at N = 1310720), the f16 record 12 x 2 x N (31 MB). timing=True keeps
    each frame's span on the copy stream (`copy_ms`, CUDA events: the
    record's stack on the card and its copy, or the pack's copies)."""

    def __init__(self, capacity: int, num_types: int, n_slots: int = 3, mode: str = "dense", timing: bool = False):
        if mode not in ("dense", "compact"):
            raise ValueError(f"mode must be 'dense' or 'compact', got {mode!r}")
        self.capacity = int(capacity)
        self.num_types = int(num_types)
        self.mode = mode
        self.rings: Dict[int, InstanceRing] = {t: InstanceRing(capacity, n_slots) for t in range(num_types)}
        self.timing = timing
        self.copy_ms = collections.deque(maxlen=4096)
        self.published = 0  # frames the reader put into the rings
        self._copy_stream = None
        self._staging: Dict[tuple, object] = {}
        self._q: "queue.Queue" = queue.Queue(maxsize=QUEUE_FRAMES)
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ----------------------------------------------------------------- sim
    def submit(self, params, state, frame_id: int):
        """Pack every type (on the pool's device, the current stream) and
        queue the frame; returns without waiting for the card."""
        entries = []
        for t in range(self.num_types):
            if self.mode == "dense":
                planes, count = pack_instances_dense(params, state, t)
            else:
                planes, count = pack_instances_planar(params, state, t)
            entries.append((self.mode, t, [planes, count]))
        self._enqueue(frame_id, entries)

    def submit_packed(self, static, state, packed, frame_id: int):
        """Queue the step kernel's render pack of a single-type pool: the 9
        f32 planes (`pack_render=True`; positions and quaternion from the
        post-step state, the identity quaternion where rotation is elided),
        or the f16 record (`pack_render="f16"`, 12 or 16 planes; take its
        rows with `acquire_f16`)."""
        if packed[0].dtype == torch.float16:
            self._enqueue(frame_id, [("record_f16", 0, record_columns(packed))])
            return
        q = (None,) * 4 if static.elide_rotation else (state.qx, state.qy, state.qz, state.qw)
        cols = [state.px, state.py, state.pz, packed[0], *q, *packed[1:9]]
        self._enqueue(frame_id, [("record_f32", 0, cols)])

    def _enqueue(self, frame_id, entries):
        """Queue a frame with the event its copies wait for (the current
        stream's work so far: the step and pack that wrote its planes)."""
        device = next(x.device for _k, _t, xs in entries for x in xs if x is not None)
        ready = None
        if device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
        item = (frame_id, entries, ready)
        while True:
            try:
                self._q.put_nowait(item)
                return
            except queue.Full:
                try:  # the reader is behind: drop the oldest queued frame (latest-wins)
                    self._q.get_nowait()
                except queue.Empty:
                    pass

    # -------------------------------------------------------------- reader
    def _to_host(self, entries, ready):
        """Each entry's host form: a record's PlaneSet, or the dense or
        compact planes and count as numpy. From the card, on the copy
        stream after `ready`: a record's planes stacked on the card into one
        buffer and copied at once, the pack's planes and count copied, into
        pinned staging buffers that are kept from frame to frame (the reader
        copies and publishes one frame at a time), then waited for; the
        queued frame keeps its device planes referenced until then."""
        if ready is None:
            return [(k, t, PlaneSet([None if x is None else x.numpy() for x in xs], ROW_DEFAULTS,
                                    f16=k == "record_f16") if k.startswith("record") else [x.numpy() for x in xs])
                    for k, t, xs in entries]
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(next(x.device for _k, _t, xs in entries for x in xs if x is not None))
        stream = self._copy_stream
        start = torch.cuda.Event(enable_timing=True) if self.timing else None
        done = torch.cuda.Event(enable_timing=self.timing)
        out = []
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            if start is not None:
                start.record(stream)
            for i, (kind, t, xs) in enumerate(entries):
                if kind.startswith("record"):
                    host, dev, planes = self._record_staging(i, kind, xs)
                    torch.stack([x for x in xs if x is not None], out=dev)
                    host.copy_(dev, non_blocking=True)
                    out.append((kind, t, planes))
                    continue
                host = [self._pinned((i, j), x) for j, x in enumerate(xs)]
                for h, x in zip(host, xs):
                    h.copy_(x, non_blocking=True)
                out.append((kind, t, [h.numpy() for h in host]))
            done.record(stream)
        done.synchronize()
        if start is not None:
            self.copy_ms.append(start.elapsed_time(done))
        return out

    def _pinned(self, key, like: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer of `like`'s shape and type, kept per key."""
        key = key + (tuple(like.shape), like.dtype)
        if key not in self._staging:
            self._staging[key] = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        return self._staging[key]

    def _record_staging(self, i, kind, xs):
        """The pinned host buffer, the device buffer the planes are stacked
        into and the PlaneSet over the host buffer's rows, for entry i of a
        record of this layout; made at its first frame."""
        live = [x for x in xs if x is not None]
        key = (i, kind, tuple(x is None for x in xs), live[0].shape[0])
        if key not in self._staging:
            shape = (len(live), live[0].shape[0])
            host = torch.empty(shape, dtype=live[0].dtype, pin_memory=True)
            rows = iter(host.numpy())
            planes = PlaneSet([None if x is None else next(rows) for x in xs], ROW_DEFAULTS, f16=kind == "record_f16")
            self._staging[key] = (host, torch.empty(shape, dtype=live[0].dtype, device=live[0].device), planes)
        return self._staging[key]

    def _run(self):
        while not self._stop:
            try:
                frame_id, entries, ready = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            for kind, t, host in self._to_host(entries, ready):
                ring = self.rings[t]
                if kind.startswith("record"):
                    ring.publish_planes(host, frame_id)
                    continue
                planes, count = host
                c = int(count)
                if c == 0:
                    continue
                if kind == "dense":
                    ring.publish_dense(planes, frame_id)
                else:
                    ring.publish(planes[:, :c], c, frame_id)
            self.published += 1

    # -------------------------------------------------------------- render
    def acquire(self, type_index: int) -> Optional[Tuple[np.ndarray, int]]:
        """The newest ready frame of one type: (rows [count, 16] f32, a view
        into the ring, frame_id) or None. `release(type_index)` after
        drawing."""
        return self.rings[type_index].acquire()

    def acquire_f16(self, type_index: int = 0) -> Optional[Tuple[np.ndarray, int]]:
        """acquire() of frames submitted as the f16 record: f16 rows."""
        return self.rings[type_index].acquire_f16()

    def release(self, type_index: int):
        self.rings[type_index].release()

    def close(self):
        """Stop the reader thread (after the frame it is publishing) and free
        the rings."""
        self._stop = True
        self._worker.join()
        for r in self.rings.values():
            r.close()
