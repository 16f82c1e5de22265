"""Shared headless example runner of the port's examples (the counterpart
of `examples/_common.py`; its own module name, so that both packages'
scripts can run in one process).

The reference's examples are interactive Bevy apps with an FPS overlay
(`examples/stress_test.rs:169-202`); here each example builds the same scene
config, steps it headless on the card, and prints the live-count / timing
overlay to stdout. `--cpu` runs it on the CPU instead (the kernels' plain
PyTorch versions); without it a machine with no card raises RuntimeError.
`--slowmo` runs the second half at 0.05x time scale — like the examples'
Space toggle, dt is just an input (`examples/sparks.rs:112-126`). Files an
example writes (PNG, HTML) go under `--out`."""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")


def add_device_args(p: argparse.ArgumentParser):
    """--cpu and --out, as every example takes them."""
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--out", default=OUT_DIR, help="directory for the files the example writes")


def device_of(args) -> str:
    """The device the example runs on: "cpu" under --cpu, else the card
    (RuntimeError where the process has none)."""
    from bevy_firework_tpu_torch.utils.device import resolve_device

    device = "cpu" if args.cpu else "cuda"
    resolve_device(device)
    return device


def parse_args(description, frames=240):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--frames", type=int, default=frames)
    p.add_argument("--dt", type=float, default=1.0 / 60.0)
    p.add_argument("--slowmo", action="store_true", help="0.05x time scale for the second half")
    add_device_args(p)
    args = p.parse_args()
    args.device = device_of(args)
    return args


def run(scene, args, report_every=60, on_frame=None):
    t0 = time.perf_counter()
    for f in range(args.frames):
        dt = args.dt * (0.05 if (args.slowmo and f >= args.frames // 2) else 1.0)
        scene.step(dt)
        if on_frame:
            on_frame(f)
        if (f + 1) % report_every == 0:
            alive = scene.alive_count()
            wall = time.perf_counter() - t0
            print(f"frame {f + 1:5d} | t={scene.time:7.3f}s | live particles: {alive:7d} | wall {wall:6.2f}s")
    return time.perf_counter() - t0
