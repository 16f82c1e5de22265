"""The readings that the correctness limits are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 ... [--seconds 2] [--control-seeds 3]

For each seed, in one process: the cell's set-up and a short window of its
traffic at the cell's own size (the graphs captured at the first seed
serve the rest), then the judge's numbers of the program against the
reference (the lower readings), and for the first `--control-seeds` seeds
the control's: the reference computed in bfloat16 put in the program's
place, against the reference in float32 (the upper readings). One JSON
line per seed and kind; the benchmark's own runs do not run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from benchmark.harness import spec

    cell = spec.cell(args.workload)
    for i, seed in enumerate(args.seeds):
        drv = spec.driver(cell.traffic["driver"]).Run(cell, seed, "cuda")
        t0 = time.perf_counter()
        drv.setup()
        drv.window(args.seconds)
        drv.release()
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        nums = drv.numbers()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(json.dumps({"workload": cell.name, "seed": seed, "kind": "program", "numbers": nums,
                          "run_s": t1 - t0, "reference_s": t2 - t1}), flush=True)
        if i < args.control_seeds:
            print(json.dumps({"workload": cell.name, "seed": seed, "kind": "control",
                              "numbers": drv.control_numbers()}), flush=True)
        drv.compared = None
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
