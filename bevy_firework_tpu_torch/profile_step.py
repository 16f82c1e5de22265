"""Where a main-path frame's time goes on the card.

    python -m bevy_firework_tpu_torch.profile_step [--out FILE]

Runs stress_test through `multi_step_auto` at 100k and 1M live (as
chip_smoke.py's phases 6 and 7 do) and, for each, traces 8-frame chain
calls with torch.profiler: `multi_step_auto` over 8 frames (one launch with
the stats block) and over 64 frames (8 launches, stats once), one
render-pack launch, and 8 frames of the plain version. Prints one JSON line
per size with, for each: wall and device ms per frame, the fused_step
kernel's device ms per launch, and the device's busy share of the wall
time; then the host functions that take most of an 8-frame call
(cProfile). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import cProfile
import dataclasses
import io
import json
import pstats
import subprocess
import time


def device_times(prof, kernel_substr: str):
    """(kernel device us, all-kernel device us, kernel launches) summed over
    a trace; the launch count lets a caller see a trace that lost events."""
    import torch

    kern = total = 0.0
    count = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        total += t
        if kernel_substr in e.key:
            kern += t
            count += e.count
    return kern, total, count


def profile_size(rate: float, capacity: int, calls: int = 30):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import bevy_firework_tpu_torch as bt
    from bevy_firework_tpu_torch.models import effects
    from bevy_firework_tpu_torch.ops import fused_step as fs
    from bevy_firework_tpu_torch.settings import EmissionPacing
    from bevy_firework_tpu_torch.step import plain_frames

    sp, _tf = effects.stress_test()
    es = dataclasses.replace(sp.emission_settings[0], emission_pacing=EmissionPacing.rate(rate))
    c = bt.compile_spawner(dataclasses.replace(sp, emission_settings=(es,)), device="cuda")
    f = bt.make_frame_input(1 / 60)
    s, out = fs.multi_step_auto(c.static, c.params, None, bt.init_pool_for(c, capacity), f, 140)
    live = int(out.alive_count)

    def kernel_call():
        return fs.multi_step_auto(c.static, c.params, None, s, f, 8)

    def chain_call():  # 8 launches, stats on the last frame only
        return fs.multi_step_auto(c.static, c.params, None, s, f, 64)

    def render_call():
        return fs.fused_step(c.static, c.params, None, s, f, pack_render=True, stats=False)

    def plain_call():
        return plain_frames(c.static, c.params, s, f, 8)

    res = {"rate": rate, "capacity": capacity, "live": live}
    runs = (("kernel", kernel_call, calls, 8), ("chain_64", chain_call, max(3, calls // 5), 64),
            ("render_u1", render_call, calls, 1), ("plain", plain_call, max(3, calls // 10), 8))
    for name, fn, n, frames in runs:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / n
        kern, total, _count = device_times(prof, "fused_step_kernel")
        launches = {"kernel": 1, "chain_64": 8, "render_u1": 1, "plain": 0}[name]
        res[name] = {"frames": frames, "wall_ms_per_frame": wall * 1e3 / frames,
                     "device_ms_per_frame": total / n / 1e3 / frames,
                     "fused_kernel_ms_per_launch": kern / n / 1e3 / launches if launches else None,
                     "device_busy_share": (total / n / 1e6) / wall if wall > 0 else None}
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(calls):
        kernel_call()
    torch.cuda.synchronize()
    pr.disable()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(12)
    res["host_top"] = [ln.strip() for ln in buf.getvalue().splitlines() if "{" in ln or ".py:" in ln][:12]
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    lines = []
    for rate, cap in ((100_000.0, 1 << 17), (1_000_000.0, 160 * 8192)):
        r = profile_size(rate, cap)
        r["card"] = card
        lines.append(json.dumps(r))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
