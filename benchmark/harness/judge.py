"""How `correct` is decided: the program's outputs against the plain
reference's, as numbers each held to a limit of its own.

  * `scalars_off`: the scalars a call hands on that differ bit for bit from
    the reference's: the key words after the call, the cadence
    (time_in_cycle, last_emission per emitter) and the ring cursor; and
    (`run_scalars_off`) the cadence and the cursor of the pool the window
    started from, against the reference's from the pool's start over every
    frame stepped before. Exact: limit 0.
  * `alive_off`: lanes whose alive flag differs (age < lifetime, and the
    pool's alive plane). Exact: limit 0.
  * `state_gap`: over the lanes alive on both sides, the widest gap of a
    lane plane (position, velocity, initial scale, age, lifetime) as a
    share of the reference's value, or of 1 where that is smaller in
    magnitude; a NaN reads as infinite.
  * `record_gap` (a packing call): the same over the render planes, on
    every lane.
  * `start_off`: the fresh pool's lanes and scalars that differ from the
    reference's fresh pool. Exact: limit 0.
  * `setup_scalars_off`, `setup_alive_off`, `setup_state_gap`: the same
    three of the pool the window started from (at lanes drawn from the
    seed), against the reference stepped from its fresh pool over every
    frame of the set-up: the lanes and keys that the set-up's uncaptured
    first call and the capture wrote.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LANE_FIELDS = ("px", "py", "pz", "vx", "vy", "vz", "initial_scale", "age", "lifetime")
EXACT = ("scalars_off", "run_scalars_off", "alive_off", "start_off", "setup_scalars_off", "setup_alive_off")


def _bits_differ(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.uint32)
    b = np.asarray(b, np.float32).view(np.uint32)
    return int((a != b).sum())


def scalars_off(prog: dict, ref: dict, key: bool = True) -> int:
    off = _bits_differ(prog["time_in_cycle"], ref["time_in_cycle"])
    off += _bits_differ(prog["last_emission"], ref["last_emission"])
    off += int(int(prog["ring_cursor"]) != int(ref["ring_cursor"]))
    if key:
        off += sum(int(int(a) != int(b)) for a, b in zip(prog["rng_key"], ref["rng_key"]))
    return off


def _gap(p: torch.Tensor, r: torch.Tensor, mask=None) -> float:
    p, r = (x if x.dtype == torch.float64 else x.float() for x in (p, r))
    d = (p - r).abs() / torch.clamp_min(r.abs(), 1.0)
    d = torch.where(torch.isnan(d), torch.full_like(d, math.inf), d)
    if mask is not None:
        d = torch.where(mask, d, torch.zeros_like(d))
    return float(d.max()) if d.numel() else 0.0


def compare_state(prog: dict, ref: dict, prog_stats=None, ref_stats=None) -> dict:
    """`scalars_off`, `alive_off` and `state_gap` of a call's output state
    and, given both, of its stats (the live count counts into `alive_off`,
    the AABB's six bounds into `state_gap`)."""
    alive_r = ref["age"] < ref["lifetime"]
    alive_p = prog["age"] < prog["lifetime"]
    alive_off = int((alive_r != alive_p).sum())
    if "alive" in prog:
        alive_off += int((prog["alive"] != alive_r).sum())
    both = alive_r & alive_p
    gap = max(_gap(prog[k], ref[k], both) for k in LANE_FIELDS)
    if prog_stats is not None and ref_stats is not None:
        alive_off += abs(int(prog_stats["alive_count"]) - int(ref_stats["alive_count"]))
        gap = max(gap, _gap(torch.tensor(prog_stats["aabb"], dtype=torch.float64),
                            torch.tensor(ref_stats["aabb"], dtype=torch.float64)))
    return {"scalars_off": scalars_off(prog, ref), "alive_off": alive_off, "state_gap": gap}


def prefixed(prefix: str, numbers: dict) -> dict:
    return {prefix + k: v for k, v in numbers.items()}


def outputs_stats(out) -> dict:
    """A StepOutputs' live count and AABB, as numbers."""
    lo = [float(v) for v in out.aabb_min.tolist()]
    hi = [float(v) for v in out.aabb_max.tolist()]
    return {"alive_count": int(out.alive_count), "aabb": lo + hi}


def compare_planes(prog: list, ref: list) -> float:
    """`record_gap`: the render planes' widest gap, every lane."""
    if len(prog) != len(ref):
        return math.inf
    return max(_gap(p, r) for p, r in zip(prog, ref))


def compare_start(prog: dict, ref: dict) -> int:
    """`start_off`: lanes and scalars of the fresh pools that differ."""
    off = scalars_off(prog, ref)
    for k in LANE_FIELDS:
        off += int((prog[k].float().view(torch.int32) != ref[k].float().view(torch.int32)).sum())
    off += int(prog["alive"].sum())
    return off


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): every number beside its limit, exact numbers at 0
    whatever the limits file says. A number with no limit fails."""
    checks = {}
    ok = True
    for name, value in numbers.items():
        limit = 0 if name in EXACT else limits.get(name)
        passed = limit is not None and value <= limit
        ok = ok and passed
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
