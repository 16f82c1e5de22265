"""What every driver shares: the program built from the cell's
configuration, the check of the fresh pool, the window's start pool kept
for the check of the set-up, the warm-up length, and the reference's runs
that the judge reads."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from . import judge, program, spec

SAMPLE_LANES = 1 << 19  # lanes of the window's start pool that the set-up's check steps
SAMPLE_BLOCKS = 4


def sample_ranges(capacity: int, seed: int, lanes: int = SAMPLE_LANES, blocks: int = SAMPLE_BLOCKS) -> list:
    """`blocks` disjoint lane ranges, `lanes` lanes in all, at offsets drawn
    from the seed; the whole pool where it holds no more than `lanes`."""
    if capacity <= lanes:
        return [(0, capacity)]
    size = lanes // blocks
    slots = capacity // size
    rng = np.random.default_rng(int(seed) & 0xFFFFFFFFFFFFFFFF)
    picks = sorted(int(i) for i in rng.choice(slots, size=blocks, replace=False))
    return [(i * size, (i + 1) * size) for i in picks]


def _take(d: dict, ranges: list) -> dict:
    """A state dict's lane planes at `ranges`, on the host, and its scalars."""
    out = dict(d)
    for k in (*judge.LANE_FIELDS, "alive"):
        if k in d:
            out[k] = torch.cat([d[k][a:b] for a, b in ranges]).cpu()
    return out


class Run:
    """One run of a cell: `setup()`, `window(seconds)`, in a traced run
    `trace(slicer)`, then `numbers()` (the program's outputs against the
    reference) or `control_numbers()` (the control against the reference).

    Drivers fill `compared`: (input state dict, output state dict, output
    stats or None, output render planes or None, the reference Frame, frames)
    of the call the judge reads; `frames_before`: the frames stepped from
    the fresh pool up to that call's input; and, through `keep_start`, the
    window's start pool with the reference Frames of the set-up that made
    it. `check_s` counts the seconds that set-up spends on the check (the
    reference's parse and fresh pool, the comparison, the kept start), which
    `setup_s` leaves out. `host` is the record a host-span metric reads:
    seconds and frames of the program's calls."""

    def __init__(self, cell, seed: int, device):
        t0 = time.perf_counter()
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.traffic = cell.traffic
        self.dt = float(self.traffic["dt"])
        self.ref = spec.reference(cell.config.get("reference", "plain"))
        self.ref_cfg = self.ref.parse_config(cell.config)
        self.compared = None
        self.frames_before = 0
        self.window_result = None
        self.host = None
        self.start = None
        self.check_s = time.perf_counter() - t0

    def build(self):
        """The program for the cell's configuration."""
        self.prog = program.build(self.cell.config, self.device)
        return self.prog

    def check_fresh(self, state) -> None:
        """The pool the timed path starts from, against the reference's
        fresh pool (`start_off`)."""
        t0 = time.perf_counter()
        fresh = self.ref.initial_state(self.ref_cfg, program.pool_seed(self.seed), self.device)
        self.start_off = judge.compare_start(program.state_dict(state), fresh)
        del fresh
        self.check_s += time.perf_counter() - t0

    def keep_start(self, state, frames: list) -> None:
        """The window's start pool, at the lanes the set-up's check steps
        (drawn from the seed), kept on the host; `frames`: the reference
        Frames of every set-up frame from the fresh pool."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        ranges = sample_ranges(self.ref_cfg.capacity, self.seed)
        self.start = (_take(program.state_dict(state), ranges), ranges, list(frames))
        self.check_s += time.perf_counter() - t0

    def warm_frames(self) -> int:
        """Frames to step before the window: the lifetime in frames (so the
        pool reaches its steady live count) plus the traffic's margin."""
        return math.ceil(self.ref_cfg.lifetime / self.dt) + int(self.traffic["warmup_margin_frames"])

    def release(self):
        """Drop the program's objects; `compared` and `start` stay."""
        self.prog = None

    def _setup_run(self, dtype=torch.float32) -> tuple:
        """The reference from its fresh pool over the set-up's frames, at the
        kept lanes: (its state, the program's kept start)."""
        kept, ranges, frames = self.start
        fresh = self.ref.initial_state(self.ref_cfg, program.pool_seed(self.seed), self.device)
        ref, _p = self.ref.run_frames(self.ref_cfg, fresh, frames, len(frames), dtype=dtype, ranges=ranges)
        del fresh
        prog = {k: (v.to(self.device) if torch.is_tensor(v) else v) for k, v in kept.items()}
        return ref, prog

    def numbers(self) -> dict:
        """The compared call stepped by the reference from its input state,
        and the set-up stepped by the reference from its fresh pool; the
        numbers of `judge`."""
        inp, out, out_stats, out_planes, frame, n = self.compared
        ref, planes = self.ref.run_frames(self.ref_cfg, inp, frame, n, pack=out_planes is not None)
        nums = judge.compare_state(out, ref, out_stats, self.ref.stats(self.ref_cfg, ref))
        del ref
        if out_planes is not None:
            nums["record_gap"] = judge.compare_planes(out_planes, planes)
        del planes
        run = self.ref.scalar_chain(self.ref_cfg, self.frames_before, self.dt)
        nums["run_scalars_off"] = judge.scalars_off(inp, run, key=False)
        nums["start_off"] = self.start_off
        ref, prog = self._setup_run()
        nums.update(judge.prefixed("setup_", judge.compare_state(prog, ref)))
        return nums

    def control_numbers(self) -> dict:
        """The control put in the program's place: the reference in bfloat16
        from the same inputs (the compared call's, and the fresh pool for the
        set-up), judged against the reference in float32."""
        inp, _out, _s, out_planes, frame, n = self.compared
        pack = out_planes is not None
        ctl, ctl_planes = self.ref.run_frames(self.ref_cfg, inp, frame, n, dtype=torch.bfloat16, pack=pack)
        ref, planes = self.ref.run_frames(self.ref_cfg, inp, frame, n, pack=pack)
        nums = judge.compare_state(ctl, ref, self.ref.stats(self.ref_cfg, ctl), self.ref.stats(self.ref_cfg, ref))
        if pack:
            nums["record_gap"] = judge.compare_planes(ctl_planes, planes)
        del ctl, ref, ctl_planes, planes
        ctl, _prog = self._setup_run(torch.bfloat16)
        ref, _prog = self._setup_run()
        nums.update(judge.prefixed("setup_", judge.compare_state(ctl, ref)))
        return nums
