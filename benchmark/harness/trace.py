"""The traced slice of a `--trace 1` run: torch.profiler over a fixed
number of the traffic's calls after the window, read back from its Chrome
trace.

The profiler traces the device alone. After a few calls whose records it
drops, a synchronize and a marker kernel open the slice, a fixed number of
calls follow, and a second marker and a synchronize close it, so that the
device work of those calls lies between the markers. What is read:

  * device operations: the trace's kernel, memcpy and memset records, by
    name, their busy union and the idle gaps between them;
  * for each idle gap, the device operation that ends it: what the host
    was enqueueing while the device waited;
  * the step kernel's records (names holding STEP_KERNEL).

A slice is checked by the driver's `check(slice)`: a trace that holds
fewer or more step-kernel records than the launch counters say were made,
or reads faster than their bound, is faulty and is traced again, TRIES
slices at most. The trace goes to a file in TMPDIR, is read and is
deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STEP_KERNEL = "fused_step_kernel"
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel: the slice's two markers
MARK_CYCLES = 1000
TRIES = 3


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def short_name(name: str) -> str:
    """A device record's name without its return type, namespaces,
    template arguments and arguments ("fused_step_kernel_warp"); a copy's
    name as it is ("Memcpy HtoD (Pinned -> Device)")."""
    if not name.startswith("void "):
        return name
    base = name[5:].replace("(anonymous namespace)::", "")
    return base.split("(")[0].split("<")[0].split("::")[-1] or name


def summarize(events: list) -> dict:
    """The slice's device records between its two markers (MARKER kernels
    launched after the synchronize that opens the slice and before the one
    that closes it), their busy union, and the idle gaps, each labelled by
    the device operation that ends it: the work the host was enqueueing
    while the device waited. Times in seconds; {} without both markers."""
    dev = sorted((e for e in events if e.get("ph") == "X" and "dur" in e and e.get("cat") in DEVICE_CATS),
                 key=lambda e: float(e["ts"]))
    marks = [e for e in dev if MARKER in str(e.get("name", ""))]
    if len(marks) < 2:
        return {}
    w0 = float(marks[0]["ts"]) + float(marks[0]["dur"])
    w1 = float(marks[-1]["ts"])
    dev = [e for e in dev if MARKER not in str(e.get("name", "")) and w0 <= float(e["ts"]) < w1]
    busy_iv = _merge([(float(e["ts"]), min(w1, float(e["ts"]) + float(e["dur"]))) for e in dev])
    by_label: dict = {}
    edge, k = w0, 0
    for a, b in busy_iv + [[w1, w1]]:
        if a > edge:
            while k < len(dev) and float(dev[k]["ts"]) < a:
                k += 1
            label = "host enqueueing " + (short_name(str(dev[k]["name"])) if k < len(dev) else "the slice's end")
            n, t = by_label.get(label, (0, 0.0))
            by_label[label] = (n + 1, t + (a - edge) * 1e-6)
        edge = max(edge, b)
    ops: dict = {}
    for e in dev:
        name = str(e.get("name", ""))[:120]
        ops[name] = ops.get(name, 0.0) + float(e["dur"]) * 1e-6
    step = [e for e in dev if e.get("cat") == "kernel" and STEP_KERNEL in str(e.get("name", ""))]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy_iv) * 1e-6,
        "device_s": sum(float(e["dur"]) for e in dev) * 1e-6,
        "step_s": sum(float(e["dur"]) for e in step) * 1e-6,
        "step_records": len(step),
        "ops": sorted(ops.items(), key=lambda kv: -kv[1]),
        "idle_gaps": sorted(((f"{k} ({n} gaps)", t) for k, (n, t) in by_label.items()), key=lambda kv: -kv[1]),
    }


class Slicer:
    """Traces a slice of calls after the window (the window itself runs
    untraced, so that trace runs and timed runs step alike): `prime()`
    starts the device tracer once (its first start, CUPTI's, took seconds
    to tens of seconds on the card), then for each slice `warm` calls run
    with the profiler on and their records dropped, and `calls` calls are
    recorded between two markers and two synchronizes. The driver calls
    `tick()` before each call and `count(frames)` after it until `done`.
    Only the device is traced: host-side profiling of the Scene's step
    took seconds a frame on the card."""

    def __init__(self, enabled: bool, counters=None, check=None, calls: int = 200, warm: int = 3):
        self.n_calls, self.n_warm = int(calls), int(warm)
        self.counters = counters  # () -> {name: launches}
        self.check = check  # slice -> bool
        self.slices = []  # dicts: calls, frames, host_s, counters, summary, ok
        self.prof = None
        self.done = not enabled
        self.recording = False

    @property
    def good(self):
        """The last slice if it passed its check, else None."""
        return self.slices[-1] if self.slices and self.slices[-1]["ok"] else None

    def prime(self):
        if self.done:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()

    def tick(self):
        """Before a call."""
        if self.prof is None:
            self._start()
        if not self.recording and self._k == self.n_warm:
            self._record()

    def count(self, frames: int):
        """After a call."""
        self._k += 1
        if self.recording:
            self._calls += 1
            self._frames += frames
            if self._calls == self.n_calls:
                self._stop()
                return
        self.prof.step()

    def _start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule

        torch.cuda.synchronize()
        self._events = None
        self.prof = profile(activities=[ProfilerActivity.CUDA],
                            schedule=schedule(wait=0, warmup=self.n_warm, active=self.n_calls + 1, repeat=1),
                            on_trace_ready=self._ready)
        self.prof.__enter__()
        self._k = self._calls = self._frames = 0

    def _record(self):
        import torch

        torch.cuda.synchronize()
        self._c0 = self.counters() if self.counters else {}
        torch.cuda._sleep(MARK_CYCLES)
        self._ts = time.perf_counter()
        self.recording = True

    def _ready(self, prof):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                self._events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)

    def _stop(self):
        import torch

        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - self._ts
        c1 = self.counters() if self.counters else {}
        self.prof.__exit__(None, None, None)
        self.prof = None
        self.recording = False
        sl = {"calls": self._calls, "frames": self._frames, "host_s": host_s,
              "counters": {k: c1[k] - self._c0.get(k, 0) for k in c1}, "summary": summarize(self._events or [])}
        sl["ok"] = bool(sl["summary"]) and (self.check(sl) if self.check else True)
        self.slices.append(sl)
        self.done = sl["ok"] or len(self.slices) >= TRIES
