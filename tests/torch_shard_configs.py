"""Sharded pools in one process, shared by the port's sharding tests, its
distributed worker and chip_smoke.py (imports torch and the port only, so
the card's tests can use it without JAX).

A pool split into S contiguous shards steps one `fused_step(..., shard=...)`
per shard (kernel row 11 on the card, its plain version on the CPU), the
dead offsets the exclusive prefix of the shards' dead totals, device
tensors (the claim's carried counts summed, then a cumsum: nothing waits on
the card), as `parallel.sharding.make_sharded_step` computes them over a
process group; stitched along the lanes, the shards must be the unsharded
pool."""

import dataclasses

import torch

import bevy_firework_tpu_torch as pt
from bevy_firework_tpu_torch.models import effects
from bevy_firework_tpu_torch.ops import fused_step as fs
from bevy_firework_tpu_torch.parallel.sharding import REPLICATED, slice_pool, split_range
from bevy_firework_tpu_torch.pool import POOL_FIELDS
from bevy_firework_tpu_torch.step import Shard
from torch_fleet_configs import box_spawner, det_spawner

CONFIGS = ("det", "stress", "destroy")


def rated(spawner, rate):
    es = dataclasses.replace(spawner.emission_settings[0], emission_pacing=pt.EmissionPacing.rate(float(rate)))
    return dataclasses.replace(spawner, emission_settings=(es,))


def config(name: str, device, rate=None):
    """(compiled spawner, collider table or None, frame) of a config:
    det, the deterministic spawner (constant draws, live rotation; 2000/s);
    stress, stress_test (random draws; 1e5/s); destroy, the box emitter
    destroying on a halfspace (dead-rank claim; 3e5/s)."""
    if name == "det":
        sp, cols = det_spawner(rate or 2000.0), None
    elif name == "stress":
        sp, cols = rated(effects.stress_test()[0], rate or 1e5), None
    elif name == "destroy":
        sp, cols = box_spawner(rate or 3e5, destroy=True), [pt.Collider.halfspace(position=(0.0, -0.8, 0.0))]
    else:
        raise ValueError(name)
    c = pt.compile_spawner(sp, device=device)
    table = None if cols is None else pt.compile_colliders(cols, device=device)
    return c, table, pt.make_frame_input(1 / 60)


def split(state, n_shards: int) -> list:
    """The pool's S contiguous shards [r N / S, (r + 1) N / S)."""
    return [slice_pool(state, lanes=split_range(state.capacity, r, n_shards)) for r in range(n_shards)]


def shard_args(static, shards) -> list:
    """Each shard's `step.Shard`: lane base, global capacity, dead offset
    (0 on the ring; else an int32 0-d tensor on the shards' device, the
    exclusive cumsum of their dead totals, each summed from the claim's
    per-tile counts, `fs.claim_counts`: no value reaches the host)."""
    n = sum(s.capacity for s in shards)
    bases = [sum(s.capacity for s in shards[:r]) for r in range(len(shards))]
    if static.ring_claim:
        return [Shard(b, n, 0) for b in bases]
    totals = torch.stack([fs.claim_counts(s.alive).sum(dtype=torch.int32) for s in shards])
    offsets = torch.cumsum(totals, 0, dtype=torch.int32) - totals
    return [Shard(b, n, offsets[r]) for r, b in enumerate(bases)]


def step_shards(c, table, shards, frame, unroll=1, stats=True, pack_render=False):
    """One launch per shard; returns (shards, outputs, planes or None)."""
    res = [fs.fused_step(c.static, c.params, table, s, frame, pack_render=pack_render, unroll=unroll, stats=stats,
                         shard=a) for s, a in zip(shards, shard_args(c.static, shards))]
    return [r[0] for r in res], [r[1] for r in res], ([r[2] for r in res] if pack_render else None)


def stitch(shards):
    """The shards as one pool: the per-lane leaves concatenated; the
    replicated leaves, equal on every shard, from the first."""
    for k in REPLICATED:
        for s in shards[1:]:
            if not torch.equal(getattr(s, k), getattr(shards[0], k)):
                raise AssertionError(f"replicated {k} differs between shards")
    return pt.PoolState(**{k: getattr(shards[0], k) if k in REPLICATED else
                           torch.cat([getattr(s, k) for s in shards], -1) for k in POOL_FIELDS})


def reduce_outputs(outs) -> dict:
    """The shards' local stats reduced as the group's epilogue reduces them."""
    return {"aabb_min": torch.stack([o.aabb_min for o in outs]).amin(0),
            "aabb_max": torch.stack([o.aabb_max for o in outs]).amax(0),
            "alive_count": torch.stack([o.alive_count for o in outs]).sum().to(torch.int32),
            "alive_count_per_type": torch.stack([o.alive_count_per_type for o in outs]).sum(0).to(torch.int32)}


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits (f32 as int32, so NaN == NaN), where it lies."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def pool_mismatch(a, b) -> list:
    """The leaves in which two pools differ, bit for bit."""
    return [k for k in POOL_FIELDS if not torch.equal(bits(getattr(a, k)), bits(getattr(b, k)))]


def outputs_mismatch(whole, reduced: dict) -> list:
    """The stats in which reduced shard outputs differ from a whole pool's."""
    return [k for k, v in reduced.items() if not torch.equal(bits(getattr(whole, k)), bits(v))]
