"""The `frame` driver: a closed loop with one client that steps a Scene one
frame at a time, as a game's render loop does: each frame moves the
spawner's transform on a horizontal circle (`circle_radius_m` about the
configured position, one turn per `circle_period_s`, starting at a phase
drawn from the seed), calls `Scene.step(dt)` with the render pack on, and
waits for an event recorded after the step on the sim stream: the frame's
render record is then complete on the device. The next frame starts after
that wait. The copy of the record to the host is the renderer's and stays
out.

Set-up: a Scene on the card with the one spawner (seed = the run's), the
render demand turned on by a `render_items` call that extracts nothing
(view layers 0), then frames until the pool has lived a lifetime plus the
traffic's margin: the scene's signature steps uncaptured once, is captured
at its second step and replays from then on. The judge compares the
window's last frame (its pool and its render planes) and the pool the
window started from, at lanes drawn from the seed. A traced run's slice
comes after the window (`harness.trace`).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.harness import base, judge, program


class Run(base.Run):
    def setup(self):
        bt = self.build().bt
        t = self.traffic
        self.radius, self.period = float(t["circle_radius_m"]), float(t["circle_period_s"])
        self.phase = 2.0 * math.pi * ((self.seed * 0x9E3779B1) % 4096) / 4096.0
        spawner = bt.spawner_from_dict(self.cell.config["spawner"])
        self.scene = bt.Scene(colliders=self._colliders(bt), seed=program.pool_seed(self.seed), device=self.device)
        self.sid = self.scene.add_spawner(spawner, capacity=self.prog.capacity,
                                          transform=bt.Transform(self.prog.translation, self.prog.rotation))
        if self.sid != 0:
            raise RuntimeError("the frame driver's pool key is the Scene's seed: its one spawner has id 0")
        self.check_fresh(self._slot().state)
        self.scene.render_items(view_layers=0)
        self.frames_done = 0
        for _ in range(self.warm_frames()):
            self._frame(self._event())
        self.keep_start(self._slot().state, [self._ref_frame(i) for i in range(self.frames_done)])

    def _colliders(self, bt):
        cols = self.cell.config.get("colliders", ())
        return [program.collider(bt, c) for c in cols] or None

    def _event(self):
        return torch.cuda.Event() if self.device.type == "cuda" else None

    def _translation(self, i: int) -> tuple:
        return self.ref.circle_translation(self.ref_cfg.translation, self.radius, self.period, self.phase, i * self.dt)

    def _ref_frame(self, i: int):
        return self.ref.Frame(self.dt, self._translation(i), self.ref_cfg.rotation)

    def _move(self):
        """This frame's transform: its point on the circle."""
        bt = self.prog.bt
        self.scene.set_transform(self.sid, bt.Transform(self._translation(self.frames_done), self.prog.rotation))

    def _frame(self, ev):
        """One frame: move, step, wait for the render record."""
        self._move()
        self.scene.step(self.dt)
        if ev is not None:
            ev.record()
            ev.synchronize()
        self.frames_done += 1

    def _slot(self):
        # the spawner's pool and render planes after the last step (the
        # Scene's per-spawner record)
        return self.scene._spawners[self.sid]

    def window(self, seconds: float):
        ev = self._event()
        lat = []
        host_s = 0.0
        prev = None
        t_start = time.perf_counter()
        t_end = t_start + seconds
        now = t_start
        while now < t_end:
            prev = self._slot().state
            t0 = time.perf_counter()
            self._move()
            self.scene.step(self.dt)
            t1 = time.perf_counter()
            if ev is not None:
                ev.record()
                ev.synchronize()
            now = time.perf_counter()
            self.frames_done += 1
            lat.append(now - t0)
            host_s += t1 - t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - t_start
        slot = self._slot()
        self.frames_before = self.frames_done - 1
        self.compared = (program.state_dict(prev), program.state_dict(slot.state), judge.outputs_stats(slot.outputs),
                         list(slot.render_planes), self._ref_frame(self.frames_before), 1)
        self.live = int(slot.outputs.alive_count)
        self.window_result = {"window_s": window_s, "frames": len(lat), "latencies": lat}
        self.host = {"host_s": host_s, "host_frames": len(lat)}
        return self.window_result

    def trace(self, slicer):
        """More frames, after the window, until the slicer has its slice."""
        ev = self._event()
        while not slicer.done:
            slicer.tick()
            self._frame(ev)
            slicer.count(1)

    def release(self):
        self.scene = None
        super().release()

    def end_to_end(self) -> dict:
        w = self.window_result
        lat = np.sort(np.asarray(w["latencies"]))
        p95 = float(lat[max(0, math.ceil(0.95 * lat.size) - 1)])
        return {"step_ms": w["window_s"] * 1e3 / w["frames"], "step_ms_p95": p95 * 1e3}
