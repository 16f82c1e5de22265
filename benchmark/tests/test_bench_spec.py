"""BENCHMARK.json against the benchmark's contract, and every entry
resolved to its files."""

from __future__ import annotations

import json
import re

import pytest

from toycells import ROOT  # noqa: F401  (puts the repo root on sys.path)

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (spec.ROOT / p).is_dir()
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert (spec.ROOT / bench["command"][1]).exists()


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"]) and c["source"].startswith("https://")
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        data = spec.load_json(spec.ROOT / c["file"])
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not k.endswith(("_dim", "_rank")) for k in c["reduced"])


def test_workloads(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
        cell = spec.cell(w["name"])
        assert spec.driver(cell.traffic["driver"]).Run
        assert (spec.BENCH_DIR / "limits" / f"{w['name']}.json").exists()


def test_metrics(bench):
    e2e, layers = bench["end_to_end"], bench["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(layers) <= 128
    names = [m["name"] for m in e2e + layers]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in bench["workloads"]}
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        bound = m["bound"]
        assert 0.01 <= bound <= 0.25
    for m in e2e + layers:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
    by_name = {m["name"]: m for m in e2e}
    for m in layers:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in by_name
        reporting = set(by_name[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", cells)) <= reporting
        assert callable(spec.metric_reader(m["name"]).read)
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:  # every cell reports setup_s, one other end-to-end metric and a per-layer metric
        cell = spec.cell(w)
        assert "setup_s" in {m["name"] for m in cell.end_to_end} and len(cell.end_to_end) >= 2
        assert cell.per_layer


def test_layers_match_perf_md(bench):
    text = (spec.ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in bench["per_layer"]}:
        assert layer in text


def test_traffic_files_are_data():
    for path in (spec.BENCH_DIR / "traffic").iterdir():
        assert path.suffix in (".json", ".jsonl", ".toml", ".txt", ".csv")
        data = json.loads(path.read_text())
        assert (spec.BENCH_DIR / "drivers" / f"{data['driver']}.py").exists()


def test_file_names_are_names():
    for path in spec.BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        assert PATH.match(str(path.relative_to(spec.ROOT))), path
