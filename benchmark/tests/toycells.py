"""Cells of BENCHMARK.json cut to a toy size for the CPU tests: the same
configuration, traffic and limits, at `capacity` lanes with the rate cut
so that the same share of the pool lives."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import spec  # noqa: E402


def toy(name: str, capacity: int = 4096) -> spec.Cell:
    c = spec.cell(name)
    cfg = copy.deepcopy(c.config)
    life = cfg["spawner"]["particle_settings"][0]["lifetime"]["min"]
    rate = float(cfg["rate"]) * capacity / float(cfg["capacity"])
    rate = min(rate, 0.9 * capacity / life)
    cfg.update(capacity=capacity, rate=rate)
    for e in cfg["spawner"]["emission_settings"]:
        e["emission_pacing"]["count"] = rate
    return spec.Cell(c.name, c.config_name, c.traffic_name, c.chips, cfg, c.traffic, c.end_to_end, c.per_layer,
                     c.limits)


def cells() -> list:
    return [w["name"] for w in spec.benchmark()["workloads"]]
