"""Multi-rank scaling demo (the counterpart of `examples/multichip.py`, whose
mesh is 8 virtual CPU devices): `--ranks` processes on torch.distributed.

  sp: one pool's particle axis sharded over the ranks (each shard a launch
      of the step kernel with its lane base and the global capacity; the
      epilogue's reduction is one gather of the shards' stats)
  dp: a fleet of independent spawners, zero cross-rank communication
  2d: hosts x chips: the fleet axis over hosts (zero traffic), each slot's
      particle axis over the host's chips
  nested sp: a nested archetype's pool sharded over the ranks, through the
      sharded XLA-layout step (the JAX package shards nested archetypes
      through its XLA step only)

Run without --rank it is the launcher: it starts `--ranks` copies of itself
(one process per rank, `--rank r`, joined over tcp://127.0.0.1 on a free
port), waits for them and prints rank 0's lines. Backends: `gloo` (the
default; on a machine with one card every rank shares it, cuda:0; with
--cpu every rank runs on the CPU) or `nccl`, which needs one card per rank
(rank r on cuda:r) and has not been run: the machine it was written on has
one card, and NCCL refuses two ranks on one card.

Run: python examples_torch/multichip.py [--cpu] [--ranks 4] [--backend gloo|nccl] [--frames 90]
"""

import argparse
import os
import socket
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _common_torch import add_device_args, device_of  # noqa: E402

RANKS_TIMEOUT_S = 600  # the launcher's wait for its ranks

p = argparse.ArgumentParser(description=__doc__)
p.add_argument("--ranks", type=int, default=4)
p.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
p.add_argument("--frames", type=int, default=90, help="sp and dp frames (2d: two thirds, nested sp: 4 thirds)")
p.add_argument("--rank", type=int, help="run as this rank (set by the launcher)")
p.add_argument("--init", help="tcp://127.0.0.1:PORT (set by the launcher)")
add_device_args(p)
args = p.parse_args()
device = device_of(args)

import torch  # noqa: E402

if args.backend == "nccl" and (device == "cpu" or torch.cuda.device_count() < args.ranks):
    raise RuntimeError(f"nccl needs one card per rank: {args.ranks} ranks, "
                       f"{0 if device == 'cpu' else torch.cuda.device_count()} card(s)")


def launch():
    """Start the ranks, wait for them, print rank 0's lines."""
    if device == "cuda":
        from bevy_firework_tpu_torch.ops import _build

        _build.build()  # once, before the ranks load it
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *sys.argv[1:], "--rank", str(r),
                               "--init", f"tcp://127.0.0.1:{port}"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(args.ranks)]
    outs, deadline = [], time.time() + RANKS_TIMEOUT_S
    try:
        for r, proc in enumerate(procs):
            try:
                outs.append(proc.communicate(timeout=max(1.0, deadline - time.time())))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {r} did not finish within {RANKS_TIMEOUT_S} s") from None
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = [f"rank {r} exited {proc.returncode}:\n{err[-3000:]}" for r, (proc, (_o, err)) in
              enumerate(zip(procs, outs)) if proc.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    print(outs[0][0], end="", flush=True)


# -------------------------------------------------------------- one rank
import torch.distributed as dist  # noqa: E402

from bevy_firework_tpu_torch import compile_spawner, init_pool_for, make_frame_input, multi_step  # noqa: E402
from bevy_firework_tpu_torch.models import effects  # noqa: E402
from bevy_firework_tpu_torch.ops.fused_step import fused_step, multi_step_auto  # noqa: E402
from bevy_firework_tpu_torch.parallel.sharding import (  # noqa: E402
    init_distributed,
    make_fleet_step,
    make_fleet_step_2d,
    make_groups_2d,
    make_sharded_step,
    shard_fleet,
    shard_fleet_2d,
    shard_pool,
    split_range,
    stack_frames,
    stack_params,
    stack_pools,
)


def rank_main(device):
    """One rank: the four cases, rank 0 printing each line."""
    if device == "cuda":
        device = torch.device("cuda", args.rank if args.backend == "nccl" else 0)
        torch.cuda.set_device(device)
    init_distributed(args.backend, args.init, args.ranks, args.rank)
    n, rank = dist.get_world_size(), dist.get_rank()

    def say(line):
        if rank == 0:
            print(line, flush=True)

    say(f"ranks: {n} x {torch.device(device).type} ({args.backend})")

    # --- sp: one big pool sharded over the ranks
    spawner, _ = effects.sparks(rate=3000.0)
    c = compile_spawner(spawner, device=device)
    pool = init_pool_for(c, n * 8192, 0)
    state = shard_pool(pool)
    sharded = make_sharded_step(c.static)
    frame = make_frame_input(1 / 60)
    for _ in range(args.frames):
        state, out = sharded(c.params, None, state, frame)
    shard_launches = fused_step.shard_launches  # this rank's kernel launches of its shard (0 on the CPU)
    lanes = split_range(pool.capacity, rank, n)
    if rank == 0:  # the same pool unsharded, for comparison
        whole = int(multi_step_auto(c.static, c.params, None, pool, frame, args.frames)[1].alive_count)
    say(f"sp: {int(out.alive_count)} live particles sharded over {n} ranks "
        f"(shard: lanes [{lanes[0]}, {lanes[1]}) of {pool.capacity} on rank 0, {shard_launches} shard launches; "
        f"unsharded multi_step_auto: {whole if rank == 0 else None})")

    # --- dp: fleet of independent spawners, two per rank
    S = n * 2
    states = stack_pools([init_pool_for(c, 4096, i) for i in range(S)])
    params = stack_params([c.params] * S)
    frames = stack_frames([make_frame_input(1 / 60, translation=(float(i), 0, 0)) for i in range(S)])
    share, share_params, share_frames = shard_fleet(states, params, frames)
    fleet = make_fleet_step(c.static)
    for _ in range(args.frames):
        share, outs = fleet(share_params, share, share_frames)
    say(f"dp: {S} spawners x {int(outs.alive_count[0])} live each, "
        f"sharded {n}-way with zero cross-rank communication")

    # --- 2D hosts x chips: fleet axis over hosts, particle axis over each host's chips
    n_hosts, chips = (2, n // 2) if n % 2 == 0 and n >= 4 else (1, n)
    groups = make_groups_2d(n_hosts, chips)
    S2 = n_hosts * 2
    pool_n = chips * 1024
    states2 = stack_pools([init_pool_for(c, pool_n, 100 + i) for i in range(S2)])
    params2 = stack_params([c.params] * S2)
    frames2 = stack_frames([make_frame_input(1 / 60) for _ in range(S2)])
    share2, share_params2, share_frames2 = shard_fleet_2d(states2, params2, frames2, groups)
    fleet2d = make_fleet_step_2d(c.static, groups)
    for _ in range(args.frames * 2 // 3):
        share2, outs2 = fleet2d(share_params2, share2, share_frames2)
    # each slot's outputs are its whole pool's on every rank of its host: sum
    # the host's slots on its chip-0 rank and add the hosts up
    host_live = torch.tensor([int(outs2.alive_count.sum()) if groups.chip == 0 else 0], dtype=torch.int64,
                             device=device if args.backend == "nccl" else "cpu")
    dist.all_reduce(host_live)
    say(f"2d: {S2} spawners over {n_hosts} host(s) (fleet groups, zero traffic) x "
        f"{chips} chips (particle groups), {pool_n // chips} lanes per slot per rank, "
        f"{int(host_live)} live total")

    # --- nested sp: a nested archetype's pool, sharded through the XLA-layout step
    spawner_n, tf_n = effects.fireworks()
    cn = compile_spawner(spawner_n, device=device)
    pool_f = init_pool_for(cn, n * 2048, 0)
    frame_n = make_frame_input(1 / 60, translation=tf_n.translation)
    sharded_n = make_sharded_step(cn.static)
    state_n = shard_pool(pool_f)
    for _ in range(args.frames * 4 // 3):
        state_n, out_n = sharded_n(cn.params, None, state_n, frame_n)
    if rank == 0:
        whole_n = multi_step(cn.static, cn.params, None, pool_f, frame_n, args.frames * 4 // 3)[1]
    say(f"nested sp: {int(out_n.alive_count)} live {out_n.alive_count_per_type.tolist()} (rockets, sparkles) in "
        f"{pool_f.capacity} lanes sharded over {n} ranks through the sharded XLA-layout step "
        f"(unsharded xla_step.multi_step: {whole_n.alive_count_per_type.tolist() if rank == 0 else None})")
    dist.barrier()
    dist.destroy_process_group()


if args.rank is None:
    launch()
else:
    rank_main(device)
