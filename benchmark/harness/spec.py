"""The benchmark's data: `BENCHMARK.json` and the files it names.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell is a file of its own, found by its name:

  * a configuration: `benchmark/configs/<name>.json` (also named by the
    configuration's `file` in BENCHMARK.json);
  * a traffic mix: `benchmark/traffic/<name>.json`, parameters for the
    driver it names (`benchmark/drivers/<driver>.py`);
  * a per-layer metric: `benchmark/metrics/<name>.py`, a reader with
    `read(ctx)` returning a number or None;
  * a cell's correctness limits: `benchmark/limits/<cell>.json`;
  * a configuration's plain reference: `benchmark/reference/<name>.py`,
    named by the configuration's `reference` key (default `plain`).

So a later cell, configuration, traffic mix or metric is new files plus new
entries in BENCHMARK.json, with no edit to a file that is here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict  # the configuration file as written
    traffic: dict  # the traffic file as written
    end_to_end: tuple  # BENCHMARK.json entries that this cell reports
    per_layer: tuple
    limits: dict  # number name -> limit


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return load_json(path)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its files read."""
    spec = benchmark(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[w["config"]]
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits_path = BENCH_DIR / "limits" / f"{name}.json"
    limits = load_json(limits_path)["limits"] if limits_path.exists() else {}
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), config, traffic,
                tuple(m for m in spec["end_to_end"] if _reports(m, name)),
                tuple(m for m in spec["per_layer"] if _reports(m, name)), limits)


def _module(path: Path, name: str):
    """The module at `path`, loaded once under `name`."""
    if name in sys.modules:
        return sys.modules[name]
    if not path.exists():
        raise FileNotFoundError(f"no {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def driver(name: str):
    """The driver module `benchmark/drivers/<name>.py`."""
    return _module(BENCH_DIR / "drivers" / f"{name}.py", f"bench_driver_{name}")


def reference(name: str):
    """The plain reference module `benchmark/reference/<name>.py` that a
    configuration names (`"reference"`, default `plain`)."""
    return _module(BENCH_DIR / "reference" / f"{name}.py", f"bench_reference_{name}")


def metric_reader(name: str):
    """The reader module of per-layer metric `name`
    (`benchmark/metrics/<name>.py`; the name may hold dots)."""
    return _module(BENCH_DIR / "metrics" / f"{name}.py", "bench_metric_" + name.replace(".", "_").replace("-", "_"))
