"""One rank of the port's scale-out checks over a torch.distributed group.

    python tests/torch_distributed_worker.py --rank R --world W --init tcp://127.0.0.1:PORT \\
        --device cpu|cuda --size small|card \\
        --cases sp,sp_destroy,dp,2d,sp_nested,2d_nested,jax_ref [--out DIR]

Imports torch and the port only. Every rank builds the same pools from the
same seeds, steps its share through `parallel.sharding` (sp:
`make_sharded_step` over `shard_pool`; sp_destroy: the same on the
dead-rank claim, a chain whose dead offsets stay on the device; dp:
`make_fleet_step` over
`shard_fleet`; 2d: `make_fleet_step_2d` over `shard_fleet_2d` on 2 hosts x
W / 2 chips; sp_nested and 2d_nested: the same two on nested archetypes,
which step in the sharded XLA layout; jax_ref: the runs
tests/test_torch_xla_shard.py holds against the JAX package, each rank's
final share written to --out) and holds it bit for bit against the same
lanes and slots of the unsharded step run in the same process (the
kernel's layout, or `xla_step.step` for the XLA layout): every leaf of its
share, the outputs (AABB, counts, finished latch, the nested counts) on
every launch a case checks. The collectives are `gloo`'s (CPU tensors) or
`nccl`'s (the backend flag).
size small: small pools for the CPU tests (tests/test_torch_distributed.py);
size card: chip_smoke.py's dist_gloo (main_1M's cell for sp over 140 frames,
fleet_16x55k's 16 slots for dp, 2 slots of main_100k's config for 2d,
nested_60k's cell and the fireworks at 131072 lanes for sp_nested), with
ms/frame and the host time of the collectives per launch. Prints one JSON
line; a mismatch raises (exit code 1)."""

import argparse
import dataclasses
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import bevy_firework_tpu_torch as pt  # noqa: E402
import torch_shard_configs as sc  # noqa: E402
from bevy_firework_tpu_torch.models import effects  # noqa: E402
from bevy_firework_tpu_torch.ops import fused_step as fs  # noqa: E402
from bevy_firework_tpu_torch.parallel import sharding as psh  # noqa: E402
from bevy_firework_tpu_torch.step import group_gather  # noqa: E402

OUTPUTS = ("aabb_min", "aabb_max", "alive_count", "alive_count_per_type", "finished_event", "aabb_valid")


def burst():
    """A one-shot burst of 60 (lifetime 0.1 s, constant velocity): it lands
    in the first lanes, so in one shard, and its finished event must fire
    on every rank on the frame the unsharded pool fires it."""
    return pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(lifetime=pt.RandF32.constant(0.1),
                                               initial_scale=pt.RandF32.constant(0.1))],
        emission_settings=[pt.EmissionSettings(emission_pacing=pt.EmissionPacing.one_shot(60),
                                               initial_velocity=pt.RandVec3.constant((0.0, 1.0, 0.0)))])


def same(label, a, b):
    if not torch.equal(sc.bits(a), sc.bits(b)):
        raise AssertionError(f"{label} differs from the unsharded step")


def check_share(label, share, whole, lanes=None, slots=None):
    """share == the same slots and lanes of the unsharded pool, every leaf."""
    want = psh.slice_pool(whole, slots=slots, lanes=lanes)
    bad = sc.pool_mismatch(share, want)
    if bad:
        raise AssertionError(f"{label}: {bad} differ from the unsharded step")


def check_outputs(label, out, want, slots=None):
    for k in OUTPUTS:
        w = getattr(want, k)
        same(f"{label}: {k}", getattr(out, k), w if slots is None else w[slots[0]:slots[1]])


def timed(fn):
    """fn() ending in a synchronize; (result, seconds, collective calls, their seconds)."""
    dev_sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    dev_sync()
    c0, s0, t0 = group_gather.calls, group_gather.seconds, time.perf_counter()
    res = fn()
    dev_sync()
    return res, time.perf_counter() - t0, group_gather.calls - c0, group_gather.seconds - s0


def case_sp(dev, size, rank, world):
    """Particle axis: a ring chain, a burst's finished latch frame by frame
    and a dead-rank archetype frame by frame (size small); main_1M's
    140-frame chain (size card)."""
    res = {}
    if size == "card":
        runs = [("main_1M", sc.config("stress", dev, rate=1e6), 160 * 8192, 140, True)]
    else:
        runs = [("ring_chain", sc.config("stress", dev, rate=4e3), 3001, 30, True),
                ("burst_latch", (pt.compile_spawner(burst(), device=dev), None, pt.make_frame_input(1 / 60)), 1000,
                 20, False),
                ("destroy", sc.config("destroy", dev, rate=2e4), 2000, 12, False)]
    for name, (c, table, frame), cap, n, chain in runs:
        whole = pt.init_pool_for(c, cap, device=dev)
        if name == "ring_chain":
            whole = dataclasses.replace(whole, ring_cursor=torch.tensor(cap - 500, dtype=torch.int32, device=dev))
        share = psh.shard_pool(whole, None)
        lanes = psh.split_range(cap, rank, world)
        step = psh.make_sharded_step(c.static)
        fired = 0
        if chain:
            (share, out), secs, calls, csecs = timed(lambda: step(c.params, table, share, frame, n))
            whole, want = fs.multi_step_auto(c.static, c.params, table, whole, frame, n)
            check_share(f"sp {name}", share, whole, lanes=lanes)
            check_outputs(f"sp {name}", out, want)
            res[name] = {"frames": n, "launches": len(fs.chain_shape(n, fs.chain_unroll(c.static, table))),
                         "live": int(out.alive_count), "first_chain_s": secs}
            if size == "card":  # the timed chain, from the checked state
                (_s, _o), secs, calls, csecs = timed(lambda: step(c.params, table, share, frame, n))
                res[name].update(ms_per_frame=secs * 1e3 / n, collective_calls=calls,
                                 collective_us_per_launch=csecs * 1e6 / res[name]["launches"])
        else:
            for i in range(n):
                share, out = step(c.params, table, share, frame)
                whole, want = fs.fused_step(c.static, c.params, table, whole, frame)
                check_share(f"sp {name} frame {i}", share, whole, lanes=lanes)
                check_outputs(f"sp {name} frame {i}", out, want)
                fired += int(out.finished_event)
            res[name] = {"frames": n, "live": int(out.alive_count), "finished_events": fired}
            if name == "burst_latch" and fired != 1:
                raise AssertionError(f"sp burst_latch: {fired} finished events, want 1")
    return res


def case_sp_destroy(dev, size, rank, world):
    """Particle axis on the dead-rank claim: the destroy config as one
    30-frame `make_sharded_step` chain (single launches, each shard's dead
    offset the device-side exclusive prefix of the gathered dead totals,
    summed from the claim's carried counts) == the unsharded chain; then
    10 frames one by one, every leaf and output checked each frame. size
    small: 2000 lanes; size card: 1310720."""
    c, table, frame = sc.config("destroy", dev, rate=2e4 if size == "small" else 5e5)
    cap = 2000 if size == "small" else 160 * 8192
    whole = pt.init_pool_for(c, cap, device=dev)
    share = psh.shard_pool(whole, None)
    lanes = psh.split_range(cap, rank, world)
    step = psh.make_sharded_step(c.static)
    (share, out), secs, calls, _cs = timed(lambda: step(c.params, table, share, frame, 30))
    whole, want = fs.multi_step_auto(c.static, c.params, table, whole, frame, 30)
    check_share("sp_destroy chain", share, whole, lanes=lanes)
    check_outputs("sp_destroy chain", out, want)
    for i in range(10):
        share, out = step(c.params, table, share, frame)
        whole, want = fs.fused_step(c.static, c.params, table, whole, frame)
        check_share(f"sp_destroy frame {i}", share, whole, lanes=lanes)
        check_outputs(f"sp_destroy frame {i}", out, want)
    dead = int((~whole.alive).sum())
    if not 0 < dead < cap:
        raise AssertionError(f"sp_destroy: {dead} dead lanes of {cap}")
    return {"frames": 40, "live": int(out.alive_count), "dead": dead, "chain_s": secs, "chain_collectives": calls}


def fleet_setup(dev, size, n_slots):
    """(compiled, stacked pools, stacked frames, capacity) of a fleet: the
    burst (size small) or stress_test at 55000/s in 65536 lanes per slot
    (fleet_16x55k) / at 1e5/s in 131072 (main_100k's config)."""
    if size == "card":
        rate, cap = (55_000.0, 65536) if n_slots == 16 else (1e5, 1 << 17)
        c = pt.compile_spawner(sc.rated(effects.stress_test()[0], rate), device=dev)
    else:
        c, cap = pt.compile_spawner(burst(), device=dev), 500
    pools = [pt.init_pool_for(c, cap, seed=i, device=dev) for i in range(n_slots)]
    frames = [pt.make_frame_input(1 / 60, translation=(float(i), 0.0, 0.0)) for i in range(n_slots)]
    return c, psh.stack_pools(pools), psh.stack_frames(frames), cap


def case_fleet(dev, size, rank, world, two_d):
    """dp (two_d False): each rank's S / W slots; 2d: 2 hosts x W / 2
    chips, each host's slots sharded over its chips. Against the unsharded
    fleet chain (size card: 140 frames; size small: 20 single frames, the
    burst's finished latch checked on each)."""
    n_slots = (16 if not two_d else 2) if size == "card" else (4 if not two_d else 2)
    c, states, frames, cap = fleet_setup(dev, size, n_slots)
    if two_d:
        groups = psh.make_groups_2d(2, world // 2)
        slots = psh.split_range(n_slots, groups.host, 2)
        lanes = psh.split_range(cap, groups.chip, world // 2)
        share, params, fr = psh.shard_fleet_2d(states, c.params, frames, groups)
        step = psh.make_fleet_step_2d(c.static, groups)
    else:
        slots, lanes = psh.split_range(n_slots, rank, world), None
        share, params, fr = psh.shard_fleet(states, c.params, frames)
        step = psh.make_fleet_step(c.static)
    label = "2d" if two_d else "dp"
    if size == "card":
        n = 140
        (share, out), secs, _calls, _cs = timed(lambda: step(params, share, fr, n))
        states, want = fs.multi_step_fleet(c.static, c.params, None, states, frames, n)
        check_share(label, share, states, lanes=lanes, slots=slots)
        check_outputs(label, out, want, slots)
        (_s, _o), secs, calls, csecs = timed(lambda: step(params, share, fr, n))
        launches = len(fs.chain_shape(n, fs.chain_unroll(c.static))) * (slots[1] - slots[0] if two_d else 1)
        return {"slots": n_slots, "local_slots": slots[1] - slots[0], "capacity": cap, "frames": n,
                "live": int(out.alive_count.sum()), "ms_per_frame": secs * 1e3 / n, "collective_calls": calls,
                "collective_us_per_launch": csecs * 1e6 / launches}
    fired = 0
    for i in range(20):
        share, out = step(params, share, fr)
        states, want = fs.step_auto_fleet(c.static, c.params, None, states, frames)
        check_share(f"{label} frame {i}", share, states, lanes=lanes, slots=slots)
        check_outputs(f"{label} frame {i}", out, want, slots)
        fired += int(out.finished_event.sum())
    if fired != slots[1] - slots[0]:
        raise AssertionError(f"{label}: {fired} finished events on {slots[1] - slots[0]} slots")
    return {"slots": n_slots, "local_slots": slots[1] - slots[0], "finished_events": fired}


NESTED_OUTPUTS = OUTPUTS + ("nested_deferred", "nested_dropped")


FLOOR_Y = 8.0  # below the fireworks' apex: a share of the falling sparkles hit it


def fireworks_floor(pkg=pt):
    """effects.fireworks() with its sparkles destroyed on a floor at
    FLOOR_Y (the dead-rank claim: deaths punch holes behind the claims) and
    a second launcher after the burst emitter, so a frame claims global,
    nested, global: (spawner, colliders), in `pkg`'s types (the port's or
    the JAX package's)."""
    sp, _tf = (effects if pkg is pt else importlib.import_module("bevy_firework_tpu.models.effects")).fireworks()
    rocket, sparkle = sp.particle_settings
    sparkle = dataclasses.replace(sparkle, collision_settings=pkg.ParticleCollisionSettings(
        restitution=0.3, friction=0.1, destroy_on_collision=True))
    launcher, burst = sp.emission_settings
    second = dataclasses.replace(launcher, emission_pacing=pkg.EmissionPacing.rate(20.0))
    return dataclasses.replace(sp, particle_settings=(rocket, sparkle), emission_settings=(launcher, burst, second)), \
        [pkg.Collider.halfspace(position=(0.0, FLOOR_Y, 0.0))]


def nested_configs(dev, size):
    """(name, compiled, collider table, frame, capacity, frames) of the
    nested sp runs: bench.py's nested_60k spawner and effects.fireworks()
    (ring claims; fireworks' lifetimes random), and fireworks_floor (the
    dead-rank claim). size small: nested_60k in 3001 lanes with a child
    buffer of 64 (the parents ask for more: frames defer; the pool fills:
    children drop), the fireworks in 101 lanes (their bursts fill the
    pool); size card: nested_60k's cell (131072 lanes, nested_buffer 1024)
    and fireworks in 131072 lanes, 150 frames each, fireworks_floor 100
    (its sparkles reach the floor from frame ~70)."""
    import torch_nested_configs as nc

    small = size == "small"
    fw, floor = fireworks_floor()
    frame = pt.make_frame_input(1 / 60)  # fireworks' transform is the identity
    return [("nested_60k", pt.compile_spawner(nc.bench_nested(False), nested_buffer=64 if small else 1024, device=dev),
             None, frame, 3001 if small else 1 << 17, 60 if small else 150),
            ("fireworks", pt.compile_spawner(effects.fireworks()[0], device=dev), None, frame,
             101 if small else 1 << 17, 150),
            ("fireworks_floor", pt.compile_spawner(fw, device=dev), pt.compile_colliders(floor, device=dev), frame,
             101 if small else 1 << 17, 150 if small else 100)]


def check_xla_frame(label, share, out, whole, want, lanes):
    """A sharded XLA-layout frame == the same lanes of the unsharded one:
    every leaf, the outputs with the nested counts, the destroyed mask."""
    check_share(label, share, whole, lanes=lanes)
    for k in NESTED_OUTPUTS:
        same(f"{label}: {k}", getattr(out, k), getattr(want, k))
    same(f"{label}: destroyed_mask", out.destroyed_mask, want.destroyed_mask[lanes[0]:lanes[1]])


def case_sp_nested(dev, size, rank, world):
    """Nested archetypes on the particle axis (`make_sharded_step`, the
    sharded XLA-layout step): each config frame by frame, every frame
    checked against the unsharded `xla_step.step` run in this process; the
    children written on this rank whose parent lies on another
    (`xla_step.nested_spawn.crossed`), the largest deferred and dropped
    counts. size card: then a 30-frame sharded chain timed from the
    checked state (ms/frame, the gathers per frame and their host µs),
    beside the unsharded `multi_step` on rank 0 while the others wait."""
    from bevy_firework_tpu_torch import xla_step

    res = {}
    for name, c, table, frame, cap, n in nested_configs(dev, size):
        whole = pt.init_pool_for(c, cap, seed=1, device=dev)
        share = psh.shard_pool(whole, None)
        lanes = psh.split_range(cap, rank, world)
        step = psh.make_sharded_step(c.static)
        xla_step.nested_spawn.crossed = 0
        deferred = dropped = 0
        t_shard, calls, csecs = 0.0, 0, 0.0
        for i in range(n):
            (share, out), dt, dc, ds = timed(lambda: step(c.params, table, share, frame))
            t_shard, calls, csecs = t_shard + dt, calls + dc, csecs + ds
            whole, want = xla_step.step(c.static, c.params, table, whole, frame)
            check_xla_frame(f"sp_nested {name} frame {i}", share, out, whole, want, lanes)
            deferred, dropped = max(deferred, int(out.nested_deferred)), max(dropped, int(out.nested_dropped))
        res[name] = {"capacity": cap, "frames": n, "live": int(out.alive_count), "ring_claim": c.static.ring_claim,
                     "live_per_type": out.alive_count_per_type.tolist(), "crossed": xla_step.nested_spawn.crossed,
                     "max_deferred": deferred, "max_dropped": dropped,
                     "checked_ms_per_frame": t_shard * 1e3 / n, "gathers_per_frame": calls / n}
        xla_step.nested_spawn.crossed = None
        if size == "card":
            n_t = 30
            dist.barrier()
            if rank == 0:
                (_s, _o), secs, _c, _cs = timed(lambda: xla_step.multi_step(c.static, c.params, table, whole, frame,
                                                                            n_t))
                res[name]["unsharded_ms_per_frame"] = secs * 1e3 / n_t
            dist.barrier()
            (_s, _o), secs, calls, csecs = timed(lambda: step(c.params, table, share, frame, n_t))
            res[name].update(ms_per_frame=secs * 1e3 / n_t, timed_frames=n_t, gathers_per_frame=calls / n_t,
                             gather_us_per_frame=csecs * 1e6 / n_t)
    return res


def case_2d_nested(dev, size, rank, world):
    """A fleet of a nested archetype on 2 hosts x W / 2 chips
    (`make_fleet_step_2d`: each slot a sharded XLA-layout pool over its
    host's chips): 2 slots of nested_60k's config, each rank's share ==
    the same slots and lanes of every slot stepped unsharded by
    `xla_step.step`, frame by frame."""
    from bevy_firework_tpu_torch import xla_step

    _name, c, _t, _f, cap, n = nested_configs(dev, size)[0]
    n = min(n, 30)
    pools = [pt.init_pool_for(c, cap, seed=i, device=dev) for i in range(2)]
    frames = [pt.make_frame_input(1 / 60, translation=(float(i), 0.0, 0.0)) for i in range(2)]
    groups = psh.make_groups_2d(2, world // 2)
    slots, lanes = psh.split_range(2, groups.host, 2), psh.split_range(cap, groups.chip, world // 2)
    share, params, fr = psh.shard_fleet_2d(psh.stack_pools(pools), c.params, psh.stack_frames(frames), groups)
    step = psh.make_fleet_step_2d(c.static, groups)
    for i in range(n):
        share, out = step(params, share, fr)
        stepped = [xla_step.step(c.static, c.params, None, p, f) for p, f in zip(pools, frames)]
        pools = [s for s, _o in stepped]
        for j, slot in enumerate(range(*slots)):
            label = f"2d_nested frame {i} slot {slot}"
            check_xla_frame(label, psh.state_slot(share, j), psh.outputs_slot(out, j), pools[slot],
                            stepped[slot][1], lanes)
    return {"slots": 2, "local_slots": slots[1] - slots[0], "capacity": cap, "frames": n,
            "live": int(out.alive_count.sum())}


def jax_ref_configs(dev):
    """(name, compiled, collider table, frame, capacity, seed, frames,
    prefer_fused) of the runs tests/test_torch_xla_shard.py holds against
    the JAX package's make_sharded_step: tests/test_sharding.py's sp
    spawner through the XLA layout (prefer_fused False), its nested
    spawner, fireworks and fireworks_floor."""
    R, V = pt.RandF32, pt.RandVec3
    sp = pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(lifetime=R.constant(0.4), initial_scale=R.constant(0.1))],
        emission_settings=[pt.EmissionSettings(emission_pacing=pt.EmissionPacing.rate(300.0),
                                               initial_velocity=V.constant((0.5, 2.0, 0.0)))])
    nested = pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(lifetime=R.constant(1.0)), pt.ParticleSettings(lifetime=R.constant(0.5))],
        emission_settings=[
            pt.EmissionSettings(particle_index=0, emission_pacing=pt.EmissionPacing.rate(50.0)),
            pt.EmissionSettings(particle_index=1, emission_mode=pt.EmissionMode.nested(0),
                                emission_pacing=pt.EmissionPacing.count_over_duration(4.0, 1.0, 0.0, 0.5))])
    fw, floor = fireworks_floor()
    frame = pt.make_frame_input(1 / 60)
    return [("sp_xla", pt.compile_spawner(sp, device=dev), None, frame, 8 * 256, 7, 30, False),
            ("nested", pt.compile_spawner(nested, device=dev), None, frame, 8 * 128, 3, 40, None),
            ("fireworks", pt.compile_spawner(effects.fireworks()[0], device=dev), None, frame, 8 * 128, 0, 100, None),
            ("fireworks_floor", pt.compile_spawner(fw, device=dev), pt.compile_colliders(floor, device=dev), frame,
             8 * 128, 0, 100, None)]


def case_jax_ref(dev, size, rank, world, out_dir):
    """The runs of `jax_ref_configs` through `make_sharded_step`, each frame
    == the unsharded `xla_step.step`; the final share and outputs written
    to out_dir/{name}_{rank}.npz for the test to stitch."""
    from bevy_firework_tpu_torch import interop, xla_step

    res = {}
    for name, c, table, frame, cap, seed, n, prefer in jax_ref_configs(dev):
        whole = pt.init_pool_for(c, cap, seed=seed, device=dev)
        share = psh.shard_pool(whole, None)
        lanes = psh.split_range(cap, rank, world)
        step = psh.make_sharded_step(c.static, prefer_fused=prefer)
        for i in range(n):
            share, out = step(c.params, table, share, frame)
            whole, want = xla_step.step(c.static, c.params, table, whole, frame)
            check_xla_frame(f"jax_ref {name} frame {i}", share, out, whole, want, lanes)
        np.savez(Path(out_dir) / f"{name}_{rank}.npz", lanes=np.asarray(lanes),
                 **{f"pool_{k}": v for k, v in interop.pool_to_numpy(share).items()},
                 **{f"out_{k}": getattr(out, k).numpy() for k in NESTED_OUTPUTS})
        res[name] = {"frames": n, "live": int(out.alive_count)}
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True, help="tcp://127.0.0.1:PORT")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--size", choices=("small", "card"), default="small")
    ap.add_argument("--cases", default="sp,dp,2d")
    ap.add_argument("--out", help="directory for the jax_ref case's final shares")
    args = ap.parse_args()
    torch.set_num_threads(1)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)  # every rank on the one card
        dev = torch.device("cuda", 0)
    psh.init_distributed(args.backend, args.init, args.world, args.rank)
    out = {"rank": args.rank, "world": args.world, "device": str(dev), "backend": args.backend, "size": args.size}
    try:
        for case in args.cases.split(","):
            t0 = time.perf_counter()
            if case == "sp":
                out[case] = case_sp(dev, args.size, args.rank, args.world)
            elif case == "sp_destroy":
                out[case] = case_sp_destroy(dev, args.size, args.rank, args.world)
            elif case == "sp_nested":
                out[case] = case_sp_nested(dev, args.size, args.rank, args.world)
            elif case == "2d_nested":
                out[case] = case_2d_nested(dev, args.size, args.rank, args.world)
            elif case == "jax_ref":
                out[case] = case_jax_ref(dev, args.size, args.rank, args.world, args.out)
            elif case in ("dp", "2d"):
                out[case] = case_fleet(dev, args.size, args.rank, args.world, case == "2d")
            else:
                raise ValueError(f"no case {case}")
            out[case]["seconds"] = time.perf_counter() - t0
            dist.barrier()
    finally:
        dist.destroy_process_group()
    out["shard_launches"] = fs.fused_step.shard_launches
    out["ok"] = True
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
