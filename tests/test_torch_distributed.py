"""The port's scale-out over gloo process groups on the CPU: 2-rank sp (a
ring, a burst and a dead-rank archetype), 2-rank sp on the dead-rank
claim's chain (sp_destroy: the dead offsets device tensors), 2-rank dp and
4-rank 2 x 2 groups, nested archetypes through the sharded XLA-layout step
in 2- and 3-rank groups (sp_nested: bench.py's nested_60k spawner, its
child buffer lowered so frames defer, and fireworks on the ring claim,
fireworks with its sparkles destroyed on a floor on the dead-rank claim,
each in a pool that fills; 3 ranks give uneven shards) and a
4-rank 2 x 2 fleet of them (2d_nested), each rank a subprocess running
tests/torch_distributed_worker.py (imports torch and the port only) with
its own 120 s limit. Each rank holds its share bit for bit against the
same lanes and slots of the unsharded port step, outputs and finished
latch included (the worker's docstring); chip_smoke.py's dist_gloo runs the
same worker on the card at the cells' sizes."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

WORKER = Path(__file__).resolve().parent / "torch_distributed_worker.py"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(world: int, cases: str, *extra) -> list:
    """Start `world` ranks of the worker on the CPU (extra: more worker
    arguments); their JSON lines."""
    init = f"tcp://127.0.0.1:{free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), "--rank", str(r), "--world", str(world), "--init", init,
                               "--device", "cpu", "--size", "small", "--cases", cases, *extra],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    done = []
    try:
        done = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r} exited {p.returncode}:\n{err[-2000:]}" for r, (p, (_o, err)) in enumerate(zip(procs, done))
              if p.returncode != 0]
    assert not failed, "\n".join(failed)
    return [json.loads(out.strip().splitlines()[-1]) for out, _e in done]


@pytest.mark.parametrize("world,case", [(2, "sp"), (2, "sp_destroy"), (2, "dp"), (4, "2d"), (2, "sp_nested"),
                                        (3, "sp_nested"), (4, "2d_nested")])
def test_gloo_group_equals_unsharded(world, case):
    outs = run_group(world, case)
    assert [o["rank"] for o in outs] == list(range(world)) and all(o["ok"] for o in outs)
    if case == "sp_nested":  # the seams the frames must have crossed
        for name in ("nested_60k", "fireworks", "fireworks_floor"):
            runs = [o[case][name] for o in outs]
            assert sum(r["crossed"] for r in runs) > 0, f"{name}: no child landed off its parent's rank"
            assert runs[0]["max_dropped"] > 0, f"{name}: the pool never filled"
            assert all(r["live"] == runs[0]["live"] > 0 for r in runs)
        assert outs[0][case]["nested_60k"]["max_deferred"] > 0  # the child buffer overflowed
        for name in ("fireworks", "fireworks_floor"):  # rockets and their bursts
            assert min(outs[0][case][name]["live_per_type"]) > 0
        assert not outs[0][case]["fireworks_floor"]["ring_claim"]
    elif case == "2d_nested":
        assert sum(o[case]["local_slots"] for o in outs) == outs[0][case]["slots"] * (world // 2)
    elif case == "sp":
        for o in outs:
            assert o["sp"]["burst_latch"]["finished_events"] == 1
            assert o["sp"]["ring_chain"]["live"] == outs[0]["sp"]["ring_chain"]["live"] > 0
    elif case == "sp_destroy":
        for o in outs:
            assert o[case]["live"] == outs[0][case]["live"] > 0 and o[case]["dead"] > 0
    else:
        assert sum(o[case]["local_slots"] for o in outs) == outs[0][case]["slots"] * (1 if case == "dp" else world // 2)
