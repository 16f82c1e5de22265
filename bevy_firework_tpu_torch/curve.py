"""Curves and gradients over normalized particle lifetime.

Authoring types (`FireworkCurve`, the gradient builders) and the numpy
lowering (`compile_curve`) are the same as `bevy_firework_tpu.curve`, so a
spawner authored in either package lowers to identical tables. Evaluation
is the compile-time-specialised compare-select form the step kernel uses
(`eval_curve_static` / `eval_gradient_static`): the curve's (kind, n) are
Python ints, so a constant curve is one broadcast and an n-knot curve
selects among n-1 segments. The CUDA kernel reads the same tables at run
time and keeps the same op order.

Semantics (f32):
  * Constant: same value everywhere.
  * Even: n keyframes at i/(n-1); t clamped to [0, 1]; segment
    i = min(floor(t*(n-1)), n-2); lerp with the local fraction.
  * Uneven: explicit sorted knots; t clamped to [t0, t_last]; lerp within
    the containing segment.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

CURVE_CONSTANT = 0
CURVE_EVEN = 1
CURVE_UNEVEN = 2

# Default keyframe-table width; compile_spawner widens it per archetype to
# the largest knot count of its curves.
K_MAX = 8


@dataclasses.dataclass(frozen=True)
class FireworkCurve:
    """Scalar (or vector) keyframe curve with unit domain.

    kind: one of CURVE_CONSTANT / CURVE_EVEN / CURVE_UNEVEN.
    ts:   knot positions, len n (ignored for constant/even).
    vs:   knot values, shape (n,) scalars or (n, C) vectors.
    """

    kind: int
    ts: tuple
    vs: tuple

    @staticmethod
    def constant(value) -> "FireworkCurve":
        return FireworkCurve(CURVE_CONSTANT, (0.0, 1.0), (_tup(value), _tup(value)))

    @staticmethod
    def even_samples(samples: Sequence) -> "FireworkCurve":
        samples = list(samples)
        if len(samples) == 0:
            raise ValueError("Cannot create curve from 0 samples")
        if len(samples) == 1:
            return FireworkCurve.constant(samples[0])
        ts = tuple(float(i) / (len(samples) - 1) for i in range(len(samples)))
        return FireworkCurve(CURVE_EVEN, ts, tuple(_tup(v) for v in samples))

    @staticmethod
    def uneven_samples(samples: Sequence) -> "FireworkCurve":
        samples = list(samples)
        if len(samples) == 0:
            raise ValueError("Cannot create curve from 0 samples")
        if len(samples) == 1:
            return FireworkCurve.constant(samples[0][1])
        ts = tuple(float(t) for t, _ in samples)
        if any(b <= a for a, b in zip(ts, ts[1:])):
            raise ValueError("Uneven curve knots must be strictly increasing")
        return FireworkCurve(CURVE_UNEVEN, ts, tuple(_tup(v) for _, v in samples))

    @property
    def n(self) -> int:
        return len(self.ts)

    @property
    def channels(self) -> int:
        v0 = self.vs[0]
        return len(v0) if isinstance(v0, tuple) else 0

    def sample_clamped(self, t: float):
        """Host-side numpy f32 evaluation (spawn-time colors, test oracle)."""
        t = np.float32(t)
        vs = np.asarray(self.vs, dtype=np.float32)
        if self.kind == CURVE_CONSTANT:
            return vs[0]
        if self.kind == CURVE_EVEN:
            n = len(self.vs)
            tc = min(max(float(t), 0.0), 1.0)
            x = np.float32(tc) * np.float32(n - 1)
            i = min(int(np.floor(x)), n - 2)
            frac = np.float32(x - np.float32(i))
            return (vs[i] + (vs[i + 1] - vs[i]) * frac).astype(np.float32)
        ts = np.asarray(self.ts, dtype=np.float32)
        tc = np.float32(min(max(float(t), float(ts[0])), float(ts[-1])))
        i = int(np.clip(np.searchsorted(ts, tc, side="right") - 1, 0, len(ts) - 2))
        frac = np.float32((tc - ts[i]) / (ts[i + 1] - ts[i]))
        return (vs[i] + (vs[i + 1] - vs[i]) * frac).astype(np.float32)

    def to_dict(self) -> dict:
        return {"kind": ["constant", "even", "uneven"][self.kind], "ts": list(self.ts),
                "vs": [list(v) if isinstance(v, tuple) else v for v in self.vs]}

    @staticmethod
    def from_dict(d: dict) -> "FireworkCurve":
        kind = {"constant": CURVE_CONSTANT, "even": CURVE_EVEN, "uneven": CURVE_UNEVEN}[d["kind"]]
        vs = tuple(_tup(v) for v in d["vs"])
        return FireworkCurve(kind, tuple(float(t) for t in d["ts"]), vs)


# A gradient is a 4-channel curve (componentwise lerp in linear space).
FireworkGradient = FireworkCurve


def gradient_constant(rgba) -> FireworkCurve:
    return FireworkCurve.constant(tuple(float(c) for c in rgba))


def gradient_uneven_samples(samples) -> FireworkCurve:
    return FireworkCurve.uneven_samples([(t, tuple(float(c) for c in v)) for t, v in samples])


def gradient_even_samples(samples) -> FireworkCurve:
    return FireworkCurve.even_samples([tuple(float(c) for c in v) for v in samples])


def _tup(v) -> Any:
    if isinstance(v, (tuple, list, np.ndarray)):
        return tuple(float(c) for c in v)
    return float(v)


def compile_curve(curve: FireworkCurve, channels: int = 0, k_pad: int = None):
    """Pack a curve into fixed-width (ts[K], vs[K(,C)], n, kind) numpy
    arrays, K = k_pad (default max(K_MAX, n)). ts beyond n-1 are +inf; vs
    beyond n-1 repeat the last value."""
    n = curve.n
    if k_pad is None:
        k_pad = max(K_MAX, n)
    if n > k_pad:
        raise ValueError(f"curve has {n} knots, table width is {k_pad}")
    if curve.kind == CURVE_EVEN:
        ts = np.array([i / (n - 1) for i in range(n)], dtype=np.float32)
    else:
        ts = np.asarray(curve.ts, dtype=np.float32)
    ts_pad = np.full((k_pad,), np.inf, dtype=np.float32)
    ts_pad[:n] = ts
    vs = np.asarray(curve.vs, dtype=np.float32)
    if channels and vs.ndim == 1:
        vs = np.broadcast_to(vs[:, None], (n, channels)).copy()
    shape = (k_pad, channels) if channels else (k_pad,)
    vs_pad = np.zeros(shape, dtype=np.float32)
    vs_pad[:n] = vs
    vs_pad[n:] = vs[-1]
    return ts_pad, vs_pad, np.int32(n), np.int32(curve.kind)


def _segment(ts: torch.Tensor, kind: int, n: int, t: torch.Tensor):
    """Shared index/fraction stage: returns (sels, frac) where sels[k-1] is
    the lane mask of segment k (k = 1..n-2; segment 0 is the default)."""
    if kind == CURVE_EVEN:
        x = torch.clamp(t, 0.0, 1.0) * float(n - 1)
        i = torch.clamp(torch.floor(x), 0.0, float(n - 2))
        frac = x - i
        return [i == k for k in range(1, n - 1)], frac
    tun = torch.clamp(t, ts[0], ts[n - 1])
    i = torch.zeros_like(t)
    for k in range(1, n - 1):
        i = i + (tun >= ts[k]).to(t.dtype)
    sels = [i == k for k in range(1, n - 1)]
    t0 = ts[0].expand_as(t)
    t1 = ts[1].expand_as(t)
    for k, sel in zip(range(1, n - 1), sels):
        t0 = torch.where(sel, ts[k], t0)
        t1 = torch.where(sel, ts[k + 1], t1)
    return sels, (tun - t0) / (t1 - t0)


def _lerp_rows(vs: torch.Tensor, sels, frac: torch.Tensor) -> torch.Tensor:
    v0 = vs[0].expand_as(frac)
    v1 = vs[1].expand_as(frac)
    for k, sel in enumerate(sels, start=1):
        v0 = torch.where(sel, vs[k], v0)
        v1 = torch.where(sel, vs[k + 1], v1)
    return v0 + (v1 - v0) * frac


def eval_curve_static(ts: torch.Tensor, vs: torch.Tensor, kind: int, n: int, t: torch.Tensor) -> torch.Tensor:
    """sample_clamped of one scalar curve table (ts, vs: [K]) at lanes t,
    specialised on the Python ints (kind, n)."""
    if kind == CURVE_CONSTANT:
        return vs[0].expand_as(t).clone()
    sels, frac = _segment(ts, kind, n, t)
    return _lerp_rows(vs, sels, frac)


def eval_gradient_static(ts: torch.Tensor, vs: torch.Tensor, kind: int, n: int, t: torch.Tensor):
    """4-channel gradient (vs: [K, 4]) sharing one index/fraction stage;
    returns a list of 4 lane tensors."""
    if kind == CURVE_CONSTANT:
        return [vs[0, c].expand_as(t).clone() for c in range(4)]
    sels, frac = _segment(ts, kind, n, t)
    return [_lerp_rows(vs[:, c], sels, frac) for c in range(4)]
