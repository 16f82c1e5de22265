"""Emission cadence math: the exact f32 port of the reference's
`compute_emission_count` (bevy_firework `src/core.rs:553-575`), the
carry-based conversion from elapsed cycle time to an integer emit count.

  * `compute_emission_count`: torch, broadcasting (the plain step);
  * `np_compute_emission_count`: numpy f32 scalar oracle;
  * `emission_next_last`: the carry for an explicit (deferral-truncated)
    count, the same op order as the count's tail;
  * `compute_emission_count_xla` and `emission_next_last(..., fused=True)`:
    the same functions as XLA compiles the JAX package's `cadence.py` for
    the CPU, which the XLA-layout step (`xla_step`) follows. XLA's
    algebraic simplifier rewrites `passed_since / ((end - start) / count)`
    as `(passed_since * count) / (end - start)`, and LLVM contracts
    `clamped_last + times * percent_between` into one fused multiply-add
    (`utils.f32.fma32`); the remainder's sign test in `div_euclid` folds
    into a compare of the unfused product, so it keeps its rounding.

The CUDA kernel (`ops/csrc/fused_step_kernel.cuh`, `emission_count`) keeps this op
order and is compiled without FMA contraction, so all three agree bit for
bit. Rust's `as usize` saturates negative floats to 0; the carry still uses
the raw (possibly negative) float count.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.f32 import div_euclid, fma32, np_div_euclid

F32 = np.float32


def compute_emission_count(time_passed_in_cycle, last_emission, cycle_duration, offset_start, offset_end,
                           particles_per_cycle):
    """Returns (count: int32, next_last_emission: f32); broadcasts."""
    percent_passed = time_passed_in_cycle / cycle_duration
    last_emission_percent = last_emission / cycle_duration
    clamped_last = torch.maximum(last_emission_percent, offset_start)
    percent_passed_since = torch.minimum(percent_passed, offset_end) - clamped_last
    percent_between = (offset_end - offset_start) / particles_per_cycle
    times = div_euclid(percent_passed_since, percent_between)
    count = torch.clamp_min(times, 0.0).to(torch.int32)
    next_last = (clamped_last + times * percent_between) * cycle_duration
    return count, next_last


def compute_emission_count_xla(time_passed_in_cycle, last_emission, cycle_duration, offset_start, offset_end,
                               particles_per_cycle):
    """`compute_emission_count` as XLA compiles it for the CPU (module
    docstring). Returns (count: int32, next_last_emission: f32)."""
    percent_passed = time_passed_in_cycle / cycle_duration
    last_emission_percent = last_emission / cycle_duration
    clamped_last = torch.maximum(last_emission_percent, offset_start)
    percent_passed_since = torch.minimum(percent_passed, offset_end) - clamped_last
    percent_between = (offset_end - offset_start) / particles_per_cycle
    q = torch.trunc(percent_passed_since * particles_per_cycle / (offset_end - offset_start))
    adj = torch.where(percent_between > 0, q - 1, q + 1)
    times = torch.where(percent_passed_since < q * percent_between, adj, q)
    count = torch.clamp_min(times, 0.0).to(torch.int32)
    next_last = fma32(times, percent_between, clamped_last) * cycle_duration
    return count, next_last


def emission_next_last(last_emission, cycle_duration, offset_start, offset_end, particles_per_cycle, times,
                       fused: bool = False):
    """`next_last_emission` for an explicit (possibly truncated) emission
    count `times` (the JAX package's `cadence.emission_next_last`): a
    parent whose children were cut by the per-frame child buffer advances
    its anchor by those it emitted, so the rest emerge next frame. fused:
    as XLA compiles it for the CPU, the sum one fused multiply-add."""
    last_pct = last_emission / cycle_duration
    clamped_last = torch.maximum(last_pct, offset_start)
    percent_between = (offset_end - offset_start) / particles_per_cycle
    t = times.to(torch.float32)
    inner = fma32(t, percent_between, clamped_last) if fused else clamped_last + t * percent_between
    return inner * cycle_duration


def np_compute_emission_count(time_passed_in_cycle, last_emission, cycle_duration, offset_start, offset_end,
                              particles_per_cycle):
    """Scalar numpy-f32 oracle with identical op order."""
    t = F32(time_passed_in_cycle)
    duration = F32(cycle_duration)
    percent_passed = F32(t / duration)
    last_pct = F32(F32(last_emission) / duration)
    clamped_last = F32(max(last_pct, F32(offset_start)))
    passed_since = F32(F32(min(percent_passed, F32(offset_end))) - clamped_last)
    between = F32(F32(F32(offset_end) - F32(offset_start)) / F32(particles_per_cycle))
    times = np_div_euclid(passed_since, between)
    count = int(max(times, 0.0))
    next_last = F32(F32(clamped_last + F32(times * between)) * duration)
    return count, next_last
