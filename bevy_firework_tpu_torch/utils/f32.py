"""f32-exact scalar math helpers matching Rust float semantics.

The emission cadence relies on Rust's `f32::div_euclid` / `f32::rem_euclid`
(truncating `%`, Euclidean adjustment), reproduced here in f32 on torch
tensors with the same op order as `bevy_firework_tpu.utils.f32`. The numpy
twins are the scalar oracles the tests hold both packages to.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = np.float32


def trunc_rem(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rust's `%` on floats: truncating remainder, a - trunc(a/b)*b."""
    return a - torch.trunc(a / b) * b


def rem_euclid(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rust `f32::rem_euclid`: r = a % b; if r < 0 { r + |b| } else { r }."""
    r = trunc_rem(a, b)
    return torch.where(r < 0, r + torch.abs(b), r)


def div_euclid(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rust `f32::div_euclid`: q = trunc(a/b); adjust when a % b < 0."""
    q = torch.trunc(a / b)
    r = trunc_rem(a, b)
    adj = torch.where(b > 0, q - 1, q + 1)
    return torch.where(r < 0, adj, q)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c on f32 tensors with one rounding, as a fused multiply-add
    gives it: the product is exact in float64, the sum is rounded to odd
    (TwoSum's error term picks the odd neighbour of an inexact float64
    sum), and the one rounding to f32 of that is the correctly rounded
    result. IEEE float64 ops, so the same bits on the CPU and the card."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")), torch.full_like(s, -float("inf")))
    odd = torch.where((err != 0) & even & torch.isfinite(s), torch.nextafter(s, toward), s)
    return odd.to(torch.float32)


def rem_euclid_fused(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`rem_euclid` with the truncating remainder's a - trunc(a/b)*b as one
    fused multiply-add: how XLA compiles `bevy_firework_tpu.utils.f32.
    rem_euclid` for the CPU (LLVM contracts the product into the
    subtraction)."""
    r = fma32(-torch.trunc(a / b), b, a)
    return torch.where(r < 0, r + torch.abs(b), r)


def np_trunc_rem(a, b) -> np.float32:
    a, b = F32(a), F32(b)
    return F32(a - F32(np.trunc(F32(a / b))) * b)


def np_rem_euclid(a, b) -> np.float32:
    r = np_trunc_rem(a, b)
    return F32(r + abs(F32(b))) if r < 0 else r


def np_div_euclid(a, b) -> np.float32:
    a, b = F32(a), F32(b)
    q = F32(np.trunc(F32(a / b)))
    r = np_trunc_rem(a, b)
    if r < 0:
        return F32(q - 1) if b > 0 else F32(q + 1)
    return q


F32_MIN = np.float32(np.finfo(np.float32).min)  # Rust f32::MIN = -3.4028235e38
