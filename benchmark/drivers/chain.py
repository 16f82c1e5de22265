"""The `chain` driver: a closed loop with one caller that steps the pool in
back-to-back `multi_step_auto` calls of `frames_per_call` frames at a
fixed dt and a fixed transform, each call taking the previous call's
pool; the only synchronizes are at the window's ends. `frames_per_call`
is a number, or "lifetime": the configuration's particle lifetime in
frames, so that each call steps one lifetime of the effect.

Set-up: the fresh pool (checked against the reference's), then calls until
the pool has lived a lifetime plus the traffic's margin, two at least: the
first call steps uncaptured and captures the chain's graph, the rest
replay it. The window replays it. The judge compares the window's last
call, and the pool the window started from at lanes drawn from the seed.
A traced run's slice comes after the window (`harness.trace`), and then
the host probe: calls each after a synchronize, timed from call to
return, so that no wait on the card falls into the host's time; the
median call stands for them, against the host's own stalls."""

from __future__ import annotations

import math
import statistics
import time

import torch

from benchmark.harness import base, judge, program


class Run(base.Run):
    def setup(self):
        p = self.build()
        bt = p.bt
        state = bt.init_pool_for(p.compiled, p.capacity, seed=program.pool_seed(self.seed))
        self.check_fresh(state)
        self.F = self.frames_per_call()
        self.frame = bt.make_frame_input(self.dt, translation=p.translation, rotation=p.rotation)
        self.ref_frame = self.ref.Frame(self.dt, self.ref_cfg.translation, self.ref_cfg.rotation)
        calls = max(2, math.ceil(self.warm_frames() / self.F))
        for _ in range(calls):
            state, _out = self._call(state)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.state = state
        self.frames_before = calls * self.F
        self.keep_start(state, [self.ref_frame] * self.frames_before)

    def frames_per_call(self) -> int:
        f = self.traffic["frames_per_call"]
        if f == "lifetime":
            return max(1, round(self.ref_cfg.lifetime / self.dt))
        return int(f)

    def _call(self, state):
        p = self.prog
        return p.bt.multi_step_auto(p.static, p.params, p.colliders, state, self.frame, self.F)

    def window(self, seconds: float):
        state, self.state = self.state, None  # only the loop holds the pool
        prev = out = None
        calls = 0
        t_start = time.perf_counter()
        t_end = t_start + seconds
        now = t_start
        while now < t_end:
            prev = state
            state, out = self._call(prev)
            now = time.perf_counter()
            calls += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - t_start
        self.state = state
        self.frames_before += (calls - 1) * self.F
        self.compared = (program.state_dict(prev), program.state_dict(state), judge.outputs_stats(out), None,
                         self.ref_frame, self.F)
        self.live = int(out.alive_count)
        self.window_result = {"window_s": window_s, "frames": calls * self.F, "calls": calls}
        return self.window_result

    def trace(self, slicer, probe_calls: int = 100):
        """More calls of the traffic, after the window, until the slicer
        has its slice; then the host probe: the median call's host seconds
        over its frames."""
        state = self.state
        while not slicer.done:
            slicer.tick()
            state, _out = self._call(state)
            slicer.count(self.F)
        spans = []
        for _ in range(probe_calls):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            state, _out = self._call(state)
            spans.append(time.perf_counter() - t0)
        self.host = {"host_s": statistics.median(spans), "host_frames": self.F}
        self.state = None

    def end_to_end(self) -> dict:
        w = self.window_result
        return {"frame_ms": w["window_s"] * 1e3 / w["frames"]}
