"""The traced slice's reading: records between the two markers, the busy
union, idle gaps labelled by the operation that ends them."""

from __future__ import annotations

import pytest

from toycells import ROOT  # noqa: F401  (puts the repo root on sys.path)

from benchmark.harness import trace

SPIN = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
STEP = "void (anonymous namespace)::fused_step_kernel_warp<true>(int const*, (anonymous namespace)::Args)"
COPY = "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::X<1>>(int)"


def _ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize_reads_between_the_markers():
    events = [_ev(STEP, -50, 10),  # a dropped call's, before the first marker
              _ev(SPIN, 0, 1),
              _ev("Memcpy HtoD (Pinned -> Device)", 5, 1, "gpu_memcpy"),
              _ev(STEP, 6, 10), _ev(COPY, 12, 8), _ev(STEP, 30, 10),
              _ev(SPIN, 50, 1)]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(49e-6)
    assert s["step_records"] == 2 and s["step_s"] == pytest.approx(20e-6)
    assert s["busy_s"] == pytest.approx(25e-6)  # [5, 20] and [30, 40]
    assert s["device_s"] == pytest.approx(29e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps["host enqueueing Memcpy HtoD (Pinned -> Device) (1 gaps)"] == pytest.approx(4e-6)
    assert gaps["host enqueueing fused_step_kernel_warp (1 gaps)"] == pytest.approx(10e-6)
    assert gaps["host enqueueing the slice's end (1 gaps)"] == pytest.approx(10e-6)
    assert sum(gaps.values()) + s["busy_s"] == pytest.approx(s["window_s"])


def test_summarize_without_markers_reads_nothing():
    assert trace.summarize([_ev(STEP, 0, 10)]) == {}


@pytest.mark.parametrize("name, short", [(STEP, "fused_step_kernel_warp"), (COPY, "multi_tensor_apply_kernel"),
                                         ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD (Device -> Device)")])
def test_short_names(name, short):
    assert trace.short_name(name) == short
