"""The benchmark of bevy_firework_tpu_torch: one cell of BENCHMARK.json per
run, in a new process.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In order: the kernel library is loaded from the port's build directory in
the checkout (`bevy_firework_tpu_torch/ops/_build/`; a checkout's first run
builds it with nvcc), the cell's program and pool are made from the seed,
the cell's own shapes are warmed to steady state and captured, the
traffic's loop runs for `--seconds`, and one JSON line is printed last on
standard output. Set-up (`setup_s`) runs from the start of this script to
the first timed frame, less the seconds set-up spends on the check (the
reference's fresh pool and the window's start pool kept for it). After the
window the program's state is let go and the plain reference steps the
window's last call again from its input, and the set-up from its own
fresh pool at lanes drawn from the seed; the numbers it is judged by, each
beside its limit, are the last lines on standard error and the result
line's last key, `checks`.

`--trace 0` reports the cell's end-to-end metrics; `--trace 1` its
per-layer metrics, read by `benchmark/metrics/<name>.py` from the
benchmark's own spans around the program's calls (in the window, or in a
host probe after it where the window's calls wait on the card), the
port's launch counters, and torch.profiler over a slice of the traffic's
calls after the window (`harness.trace`), with `device.busy_s`,
`device.window_s`, a `breakdown`, and `notes` (which bound a roofline
share is of). The window runs alike in both.

Without a CUDA device, with fewer than the cell asks for, or with JAX or
the JAX package loaded once the window has closed, the run exits non-zero
and prints no result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# whole top-level module names that no run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "bevy_firework_tpu")
CACHE = ROOT / ".bench_cache"  # fixed cache directories inside the checkout
GIB = float(1 << 30)


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _finite(v):
    return v if isinstance(v, int) or math.isfinite(v) else 1e300


def _launch_counter():
    """The port's launches run so far, by counter: those launched one by
    one and those its captured chains' replays ran."""
    from bevy_firework_tpu_torch.ops import chain_graph
    from bevy_firework_tpu_torch.ops import fused_step

    def counts() -> dict:
        c = fused_step.launch_counts()
        return {k: v + chain_graph.REPLAYED.get(k, 0) for k, v in c.items()}

    return counts


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda", t0: float = None) -> dict:
    """One run of `cell` (a `spec.Cell`, or a cell's name); returns the
    result line's object."""
    import torch

    from benchmark.harness import counts, judge, spec
    from benchmark.harness.trace import Slicer

    t0 = _T0 if t0 is None else t0
    if isinstance(cell, str):
        cell = spec.cell(cell)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    drv = spec.driver(cell.traffic["driver"]).Run(cell, seed, device)
    drv.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0 - drv.check_s

    win = drv.window(seconds)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    metrics = {}
    slicer = None
    if not trace:
        values = dict(drv.end_to_end(), peak_mem_gib=peak / GIB, setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        def check(sl) -> bool:  # a trace that holds every launch, none faster than its bound
            c, s = sl["counters"], sl["summary"]
            n = c.get("fused_step.launches", 0)
            packed = c.get("fused_step.render_launches", 0) + c.get("fused_step.render_f16_launches", 0)
            least = counts.step_bound_s(cell.config, n, packed, sl["frames"], 0)["bound_s"]
            return n > 0 and s["step_records"] == n and s["step_s"] >= least

        slicer = Slicer(on_card, counters=_launch_counter() if on_card else None, check=check)
        slicer.prime()
        drv.trace(slicer)
        ctx = {"config": cell.config, "window": win, "host": drv.host, "slice": slicer.good, "live": drv.live,
               "notes": {}}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    drv.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = drv.numbers()
    correct, checks = judge.verdict(numbers, cell.limits)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(win.get("calls", win["frames"])),
           "failed": 0 if correct else 1, "metrics": metrics, "device": dev}
    if slicer is not None:
        good = slicer.good
        if good is not None:
            s = good["summary"]
            dev.update(busy_s=s["busy_s"], window_s=s["window_s"])
            out["breakdown"] = {"device_ops": [[k, v] for k, v in s["ops"][:10]],
                                "idle_gaps": [[k, v] for k, v in s["idle_gaps"][:10]]}
        if ctx["notes"]:
            out["notes"] = ctx["notes"]
        out["trace_slices"] = [{"ok": sl["ok"], "frames": sl["frames"], "counters": sl["counters"].get(
            "fused_step.launches"), "step_records": sl["summary"].get("step_records")} for sl in slicer.slices]
    out["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]} for k, v in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; the benchmark runs only on a card", file=sys.stderr)
        return 2
    from benchmark.harness import spec

    cell = spec.cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} devices, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; nothing the benchmark runs may", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
