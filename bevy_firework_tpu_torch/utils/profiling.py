"""Tracing / profiling / observability (the JAX package's
`utils/profiling.py` on torch).

The reference's only observability is Bevy's FrameTimeDiagnosticsPlugin FPS
overlay plus live-particle counts queried from spawner data
(bevy_firework `examples/stress_test.rs:169-202`). Here:

  * `FrameStats` — smoothed frame timing + particle throughput, the FPS
    overlay analog (exponential smoothing like Bevy's diagnostics); the
    JAX package's, copied.
  * `trace(logdir)` — context manager around `torch.profiler` (CPU and, on
    a machine with a card, CUDA activities) that writes a Chrome trace into
    `logdir` (view with tensorboard's PyTorch profiler plugin, Perfetto or
    chrome://tracing).
  * `annotate(name)` — a named span inside a trace.
  * `device_memory_stats()` — the card's allocator statistics of the live
    pools.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from .device import DEFAULT_DEVICE, resolve_device


@dataclass
class FrameStats:
    """Smoothed per-frame diagnostics (EMA, like FrameTimeDiagnosticsPlugin)."""

    smoothing: float = 0.9
    frame_ms: float = 0.0
    fps: float = 0.0
    particles: int = 0
    particle_steps_per_sec: float = 0.0
    frames: int = 0
    _last: Optional[float] = field(default=None, repr=False)

    def tick(self, particles: int = 0):
        now = time.perf_counter()
        if self._last is not None:
            dt_ms = (now - self._last) * 1e3
            a = self.smoothing if self.frames > 1 else 0.0
            self.frame_ms = a * self.frame_ms + (1 - a) * dt_ms
            self.fps = 1e3 / self.frame_ms if self.frame_ms > 0 else 0.0
            sps = particles / (dt_ms * 1e-3) if dt_ms > 0 else 0.0
            self.particle_steps_per_sec = a * self.particle_steps_per_sec + (1 - a) * sps
        self._last = now
        self.particles = particles
        self.frames += 1

    def overlay(self) -> str:
        """The stress_test-style on-screen text (`stress_test.rs:47-67`)."""
        return (
            f"FPS: {self.fps:7.1f} | frame: {self.frame_ms:7.3f} ms | "
            f"particles: {self.particles:9d} | steps/s: {self.particle_steps_per_sec:14,.0f}"
        )


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block with torch.profiler and write its Chrome
    trace into `logdir` (`<host>_<pid>.<ns>.pt.trace.json`, the name
    tensorboard's plugin reads) when the block ends. The CUDA activity
    (kernel launches with their device times) is recorded where the
    process has a card. Yields the profiler (`key_averages()`)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir))) as prof:
        yield prof


def annotate(name: str):
    """Named sub-span inside a trace (`torch.profiler.record_function`, a
    context manager)."""
    return torch.profiler.record_function(name)


def device_memory_stats(device=DEFAULT_DEVICE) -> dict:
    """Per-card allocator statistics (`torch.cuda.memory_stats`), keyed by
    card, for `device` "cuda" (every card of the process; raises without
    one, as every entry point does). A device without such statistics maps
    to None, as the JAX function gives for a backend without them:
    `device="cpu"` gives {"cpu": None}."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {str(dev): None}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
