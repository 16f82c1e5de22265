"""The traffic loops at a toy size on the CPU (the port's plain step): a
run's result line, the control and the faults that `correct` must catch.
These skip the harness's look for a card and drive the rest of a run."""

from __future__ import annotations

import json
import time

import pytest
import torch

from toycells import cells, toy

from benchmark import run as bench_run
from benchmark.harness import spec

CONTRACT = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", cells())
def test_run_prints_the_contracts_line(name):
    out = bench_run.run_cell(toy(name), 2**31 + 7, 0.3, False, device="cpu", t0=time.perf_counter())
    line = json.loads(json.dumps(out))
    assert CONTRACT <= set(line) and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    cell = spec.cell(name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def _driven(name, seed=12345, seconds=0.3):
    cell = toy(name)
    drv = spec.driver(cell.traffic["driver"]).Run(cell, seed, "cpu")
    drv.setup()
    drv.window(seconds)
    drv.release()
    return cell, drv


@pytest.mark.parametrize("name", cells())
def test_control_is_not_correct(name):
    """The reference in bfloat16 in the program's place fails the limits."""
    cell, drv = _driven(name)
    ok, _checks = bench_run_verdict(drv.numbers(), cell.limits)
    assert ok
    ok, checks = bench_run_verdict(drv.control_numbers(), cell.limits)
    assert not ok, checks


def bench_run_verdict(numbers, limits):
    from benchmark.harness import judge

    return judge.verdict(numbers, limits)


def _unchanged(inp, out):
    return {k: (inp[k] if k in inp else v) for k, v in out.items()}


def _half(inp, out):
    n = out["px"].shape[0] // 2
    res = dict(out)
    for k in ("px", "py", "pz", "vx", "vy", "vz", "initial_scale", "age", "alive"):
        res[k] = torch.cat([out[k][:n], inp[k][n:]])
    return res


def _altered(inp, out):
    res = dict(out)
    alive = (out["age"] < out["lifetime"]).nonzero()
    i = int(alive[len(alive) // 2])
    res["px"] = out["px"].clone()
    res["px"][i] += 1e-3 * max(1.0, abs(float(out["px"][i])))
    return res


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered], ids=["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", cells())
def test_faults_are_not_correct(name, fault):
    """A step that returns its state unchanged, one that steps half the pool,
    and one lane's answer altered where it is produced: each fails."""
    cell, drv = _driven(name)
    inp, out, stats, planes, frame, n = drv.compared
    drv.compared = (inp, fault(inp, out), stats, planes, frame, n)
    ok, checks = bench_run_verdict(drv.numbers(), cell.limits)
    assert not ok, checks


def _kept_lane_altered(kept):
    res = dict(kept)
    alive = (kept["age"] < kept["lifetime"]).nonzero()
    i = int(alive[len(alive) // 2])
    res["vy"] = kept["vy"].clone()
    res["vy"][i] += 1e-3 * max(1.0, abs(float(kept["vy"][i])))
    return res


def _kept_key_altered(kept):
    return dict(kept, rng_key=(kept["rng_key"][0] ^ 1, kept["rng_key"][1]))


def _kept_lanes_dead(kept):
    return dict(kept, age=torch.maximum(kept["age"], kept["lifetime"]), alive=torch.zeros_like(kept["alive"]))


@pytest.mark.parametrize("fault", [_kept_lane_altered, _kept_key_altered, _kept_lanes_dead],
                         ids=["lane", "key", "dead"])
@pytest.mark.parametrize("name", cells())
def test_setup_faults_are_not_correct(name, fault):
    """The pool the window started from, with one lane's answer altered, the
    key chain off by a bit, or its lanes left dead, fails the check of the
    set-up against the reference from its fresh pool."""
    cell, drv = _driven(name)
    kept, ranges, frames = drv.start
    drv.start = (fault(kept), ranges, frames)
    ok, checks = bench_run_verdict(drv.numbers(), cell.limits)
    assert not ok, checks
    assert any(not (c["value"] <= c["limit"]) for k, c in checks.items() if k.startswith("setup_")), checks


@pytest.mark.cuda
def test_cell_on_the_card_at_a_toy_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name in cells():
        out = bench_run.run_cell(toy(name, 65536), 3, 0.5, True, device="cuda", t0=time.perf_counter())
        assert out["correct"], out["checks"]
