"""Shared configs of the kernel stats checks (the `cuda` tests in
tests/test_torch_kernel.py and chip_smoke.py's stats_det): a pool whose
live lanes sit at the float edges the stats row must reduce as the plain
reductions do, and the NaN-aware comparison of two stats rows.

Imports torch and the port only."""

import dataclasses

import numpy as np
import torch

import bevy_firework_tpu_torch as pt

EDGE_CASES = ("nan", "signed")


def edge_spawner():
    """One type: constant lifetime 1 s, initial scale 0 (so the AABB is the
    positions themselves), no acceleration or drag."""
    return pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(lifetime=pt.RandF32.constant(1.0),
                                               initial_scale=pt.RandF32.constant(0.0))],
        emission_settings=[pt.EmissionSettings(emission_pacing=pt.EmissionPacing.rate(1000.0))])


def edge_pool(case: str, device, n: int = 131072, live: int = 1500, seed: int = 3):
    """(compiled, state, frame): `live` lanes alive at seeded lanes of an
    n-lane pool (spread over its tiles), the emitter disabled so nothing
    spawns. "nan": finite positions, one lane's x NaN (the row's x bounds
    must be NaN). "signed": every x is -0 or +0 (its velocity the same
    zero, so the move keeps it), one y +inf and one z -inf, the rest
    finite."""
    c = pt.compile_spawner(edge_spawner(), device=device)
    s = pt.init_pool_for(c, n)
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(n, live, replace=False))
    pos = rng.uniform(-5.0, 5.0, (3, live)).astype(np.float32)
    vel = rng.uniform(-1.0, 1.0, (3, live)).astype(np.float32)
    if case == "nan":
        pos[0, live // 2] = np.nan
    elif case == "signed":
        pos[0] = np.where(rng.uniform(size=live) < 0.5, np.float32(-0.0), np.float32(0.0))
        vel[0] = pos[0]
        pos[1, live // 3], vel[1, live // 3] = np.inf, 0.0
        pos[2, 2 * live // 3], vel[2, 2 * live // 3] = -np.inf, 0.0
    else:
        raise ValueError(f"unknown edge case {case!r}")
    planes = {k: getattr(s, k).clone() for k in ("px", "py", "pz", "vx", "vy", "vz", "age", "alive")}
    at = torch.from_numpy(idx).to(device)
    for i, k in enumerate(("px", "py", "pz")):
        planes[k][at] = torch.from_numpy(pos[i]).to(device)
        planes["v" + k[1]][at] = torch.from_numpy(vel[i]).to(device)
    planes["age"][at] = 0.0
    planes["alive"][at] = True
    s = dataclasses.replace(s, enabled=torch.zeros_like(s.enabled), **planes)
    return c, s, pt.make_frame_input(1 / 60)


def rows_equal(a, b) -> bool:
    """Two stats values equal by value, NaN where the other is NaN (-0 ==
    +0: the plain min/max keep either zero)."""
    if a.dtype.is_floating_point:
        na, nb = torch.isnan(a), torch.isnan(b)
        return torch.equal(na, nb) and torch.equal(torch.where(na, 0.0, a), torch.where(nb, 0.0, b))
    return torch.equal(a, b)
