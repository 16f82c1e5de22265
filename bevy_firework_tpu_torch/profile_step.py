"""Where a main-path frame's time goes on the card.

    python -m bevy_firework_tpu_torch.profile_step [--out FILE]
    python3 bevy_firework_tpu_torch/profile_step.py --launch [--only GROUPS] [--root DIR]
    python3 bevy_firework_tpu_torch/profile_step.py --flows [--root DIR]

Runs stress_test through `multi_step_auto` at 100k and 1M live (as
chip_smoke.py's phases 6 and 7 do) and, for each, traces 8-frame chain
calls with torch.profiler: `multi_step_auto` over 8 frames (one launch with
the stats block) and over 64 frames (8 launches, stats once), one
render-pack launch, and 8 frames of the plain version. Prints one JSON line
per size with, for each: wall and device ms per frame, the fused_step
kernel's device ms per launch, and the device's busy share of the wall
time; then the host functions that take most of an 8-frame call
(cProfile). Needs a CUDA device.

With --launch it prints only device times per launch (stats off, as
chip_smoke.py's `*_kernel_device_ms`, unless named), one JSON line per
group that --only names (all by default): `kernels`, ptxas's registers,
stack frame and spills per kernel, each step-kernel instantiation's
resident blocks per SM and its SASS instruction count (cuobjdump), and
the field and fleet instantiations' rows at a glance (`fields_fleet`);
`main`, the main path's U = 8 launch at both sizes and its U = 1 launch at
the sparks pool (2048 lanes); `render`, kernel rows 1 and 2 at their own
shapes: the U = 1 and U = 8 launches with no pack, the f32 pack and the
f16 record at the sparks pool, main_100k's state (131072 lanes) and
main_1M's (1310720); `stats`, kernel row 6:
the U = 1 launch with and without the stats block at main_1M's state and
at the sparks pool (2048 lanes); `fleet`, kernel row 7: fleet_16x55k's U =
8 launch and its U = 1 launch with stats, the fleet's U = 2 collision
launch (16 slots of stress_test_collision), a field fleet's U = 8 launch
(16 slots of dust under the tornado's fields) and a dead-rank fleet's U =
1 launch (3 slots of 1310720 lanes, stats and the dump plane); `fields`,
kernel row 5: fields_1M's U = 8 launch at its state under the tornado's
three fields, under each alone and under none, and the share of warps a
per-warp cull of each field could skip; `cells`, the U = 2 and U = 8
launches of the collision cells (collision_1M and hull8_1M:
stress_test_collision at 1M live against its two cuboids and against
bench.py's 8 hulls) and the unfolded hybrid step launch of nested_60k
(bench.py's nested cell after 150 frames); `scaling`, kernel row 3 below
LOOP_MIN_COLLIDERS: the U = 2 launch against
tools/collider_scaling_tpu.py's scenes at C = 1, 2, 4 and collision_1M;
`nested`, kernel rows 8, 9, 9b and 10: every kernel of unfolded and
folded hybrid frames (the nested stage, the hybrid step launch without
and with the fold epilogue, PyTorch's kernels counted apart) at
nested_60k, nested_chained, a dead-rank nested archetype, a burst and
nested_60k's spawner at 1310720 lanes, the cadence and child-rows entry
points, and the launch floor (three empty launches); `claim`, kernel rows
4 and 11: every kernel of a destroy frame (tests/torch_shard_configs.py's
destroy config after 30 frames) at 131072 and 1310720 lanes, on the
counts the chain's last launch left (a tree without the carried claim:
its count and scan kernels, then the step), on a fresh copy of the alive
plane (the seed, then the step) and given the scanned offsets, and the S =
4 sharded destroy frame at 1310720 lanes (the shards' dead offsets, then
four launches); `words`, kernel rows 1, 7, 8/9b and 9/10 launched with
their frame rows, seeds and nested keys by value and as device words (the
words a captured chain's replays copy in), in turns (`words_ms`).
With --flows it prints one JSON line of the solo path's end-to-end times:
main_100k and main_1M ms/frame and the tornado and fireworks flows' ms per
Scene.step (`flows_ms`). --root DIR imports bevy_firework_tpu_torch from
DIR instead of this file's checkout (run the file, not the module): two
trees, such as a parent commit unpacked beside this checkout, are then
timed by the same code on one card; alternate the trees' runs (parent,
this, this, parent) to spread drift.
"""

from __future__ import annotations

import argparse
import cProfile
import dataclasses
import io
import json
import pstats
import subprocess
import time


def device_times(prof, kernel_substr: str):
    """(kernel device us, all-kernel device us, kernel launches) summed over
    a trace; the launch count lets a caller see a trace that lost events."""
    import torch

    kern = total = 0.0
    count = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        total += t
        if kernel_substr in e.key:
            kern += t
            count += e.count
    return kern, total, count


def profile_size(rate: float, capacity: int, calls: int = 30):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import bevy_firework_tpu_torch as bt
    from bevy_firework_tpu_torch.models import effects
    from bevy_firework_tpu_torch.ops import fused_step as fs
    from bevy_firework_tpu_torch.settings import EmissionPacing
    from bevy_firework_tpu_torch.step import plain_frames

    sp, _tf = effects.stress_test()
    es = dataclasses.replace(sp.emission_settings[0], emission_pacing=EmissionPacing.rate(rate))
    c = bt.compile_spawner(dataclasses.replace(sp, emission_settings=(es,)), device="cuda")
    f = bt.make_frame_input(1 / 60)
    s, out = fs.multi_step_auto(c.static, c.params, None, bt.init_pool_for(c, capacity), f, 140)
    live = int(out.alive_count)

    def kernel_call():
        return fs.multi_step_auto(c.static, c.params, None, s, f, 8)

    def chain_call():  # 8 launches, stats on the last frame only
        return fs.multi_step_auto(c.static, c.params, None, s, f, 64)

    def render_call():
        return fs.fused_step(c.static, c.params, None, s, f, pack_render=True, stats=False)

    def plain_call():
        return plain_frames(c.static, c.params, s, f, 8)

    res = {"rate": rate, "capacity": capacity, "live": live}
    runs = (("kernel", kernel_call, calls, 8), ("chain_64", chain_call, max(3, calls // 5), 64),
            ("render_u1", render_call, calls, 1), ("plain", plain_call, max(3, calls // 10), 8))
    for name, fn, n, frames in runs:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / n
        kern, total, _count = device_times(prof, "fused_step_kernel")
        launches = {"kernel": 1, "chain_64": 8, "render_u1": 1, "plain": 0}[name]
        res[name] = {"frames": frames, "wall_ms_per_frame": wall * 1e3 / frames,
                     "device_ms_per_frame": total / n / 1e3 / frames,
                     "fused_kernel_ms_per_launch": kern / n / 1e3 / launches if launches else None,
                     "device_busy_share": (total / n / 1e6) / wall if wall > 0 else None}
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(calls):
        kernel_call()
    torch.cuda.synchronize()
    pr.disable()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(12)
    res["host_top"] = [ln.strip() for ln in buf.getvalue().splitlines() if "{" in ln or ".py:" in ln][:12]
    return res


def launch_device_ms(launch, calls: int, traces: int = 3, all_kernels: bool = False):
    """(median, per trace) over `traces` torch.profiler traces of `calls`
    calls of `launch` of the step kernel's device time per launch, averaged
    over the launches each trace holds; with all_kernels, also the median
    device time of every kernel per call (a launch's fills and copies)."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    per, per_call = [], []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                launch()
            torch.cuda.synchronize()
        kern, total, count = device_times(prof, "fused_step_kernel")
        if count:
            per.append(kern / count / 1e3)
            per_call.append(total / calls / 1e3)
    ms = statistics.median(per) if per else None
    if all_kernels:
        return ms, per, (statistics.median(per_call) if per_call else None)
    return ms, per


def stats_ms(calls: int = 50, traces: int = 3) -> dict:
    """Kernel row 6: device time of a U = 1 launch with the stats block and
    of the same launch without it, at main_1M's state (stress_test at 1e6/s,
    1310720 lanes, after 140 frames) and at the sparks pool (the README's
    sparks spawner, 2048 lanes, after 120 frames: 750 live, the Scene's
    size): the step kernel's time per launch and every kernel's per call."""
    import bevy_firework_tpu_torch as bt
    from bevy_firework_tpu_torch.models import effects
    from bevy_firework_tpu_torch.ops import fused_step as fs
    from bevy_firework_tpu_torch.settings import EmissionPacing

    f = bt.make_frame_input(1 / 60)
    sp, _tf = effects.stress_test()
    es = dataclasses.replace(sp.emission_settings[0], emission_pacing=EmissionPacing.rate(1_000_000.0))
    c1m = bt.compile_spawner(dataclasses.replace(sp, emission_settings=(es,)), device="cuda")
    s1m, _o = fs.multi_step_auto(c1m.static, c1m.params, None, bt.init_pool_for(c1m, 160 * 8192, seed=0), f, 140)
    sparks, s_sp = sparks_pool()
    res = {}
    for label, c, s in (("stats_1M", c1m, s1m), ("stats_sparks", sparks, s_sp)):
        res[label] = {"capacity": s.capacity, "live": int(s.alive.sum())}
        for key, on in (("u1_stats", True), ("u1_no_stats", False)):
            ms, per, call_ms = launch_device_ms(lambda: fs.fused_step(c.static, c.params, None, s, f, stats=on),
                                                calls, traces, all_kernels=True)
            res[label].update({f"{key}_kernel_device_ms": ms, f"{key}_traces": per,
                               f"{key}_all_kernels_ms_per_call": call_ms})
    return res


def sparks_pool():
    """The README's sparks spawner on the card and its 2048-lane pool after
    120 frames (750 live, the Scene's size): (compiled, state)."""
    import bevy_firework_tpu_torch as bt
    from bevy_firework_tpu_torch.ops import fused_step as fs
    from bevy_firework_tpu_torch.settings import EmissionPacing

    c = bt.compile_spawner(bt.ParticleSpawner(
        particle_settings=[bt.ParticleSettings(lifetime=bt.RandF32.constant(0.75))],
        emission_settings=[bt.EmissionSettings(emission_pacing=EmissionPacing.rate(1000.0))]), device="cuda")
    s, _o = fs.multi_step_auto(c.static, c.params, None, bt.init_pool_for(c, 2048), bt.make_frame_input(1 / 60), 120)
    return c, s


def sparks_launch_ms(calls: int = 50, traces: int = 3) -> dict:
    """The main path's U = 1 launch (stats off) at the sparks pool
    (`sparks_pool`): the interactive path's step."""
    import bevy_firework_tpu_torch as bt
    from bevy_firework_tpu_torch.ops import fused_step as fs

    c, s = sparks_pool()
    f = bt.make_frame_input(1 / 60)
    ms, per = launch_device_ms(lambda: fs.fused_step(c.static, c.params, None, s, f, stats=False), calls, traces)
    return {"sparks": {"capacity": s.capacity, "live": int(s.alive.sum()), "u1_kernel_device_ms": ms,
                       "traces": per}}


def render_ms(calls: int = 30, traces: int = 3) -> dict:
    """Kernel rows 1 and 2 at their own shapes: device time per launch
    (stats off) of the U = 1 and U = 8 launches with no pack, the f32 pack
    and the f16 record, at the sparks pool (`sparks_pool`: 2048 lanes),
    main_100k's state (stress_test at 1e5/s, 131072 lanes) and main_1M's
    (1e6/s, 1310720), each after 140 frames."""
    import bevy_firework_tpu_torch as bt
    from bevy_firework_tpu_torch.models import effects
    from bevy_firework_tpu_torch.ops import fused_step as fs
    from bevy_firework_tpu_torch.settings import EmissionPacing

    f = bt.make_frame_input(1 / 60)
    pools = {"sparks_2048": sparks_pool()}
    sp, _tf = effects.stress_test()
    for label, rate, cap in (("main_100k", 1e5, 1 << 17), ("main_1M", 1e6, 160 * 8192)):
        es = dataclasses.replace(sp.emission_settings[0], emission_pacing=EmissionPacing.rate(rate))
        c = bt.compile_spawner(dataclasses.replace(sp, emission_settings=(es,)), device="cuda")
        s, _o = fs.multi_step_auto(c.static, c.params, None, bt.init_pool_for(c, cap, seed=0), f, 140)
        pools[label] = (c, s)
    res = {}
    for label, (c, s) in pools.items():
        res[label] = {"capacity": s.capacity, "live": int(s.alive.sum())}
        for u in (1, 8):
            for name, pack in (("none", False), ("f32", True), ("f16", "f16")):
                ms, per = launch_device_ms(lambda: fs.fused_step(c.static, c.params, None, s, f, unroll=u,
                                                                 pack_render=pack, stats=False), calls, traces)
                res[label][f"u{u}_{name}_kernel_device_ms"] = ms
                res[label][f"u{u}_{name}_traces"] = per
    return res


def scaling_ms(calls: int = 20, traces: int = 3) -> dict:
    """Kernel row 3 below LOOP_MIN_COLLIDERS colliders (where the JAX
    package unrolls its narrow phase per lane), at 1310720 lanes of
    stress_test_collision at 5e5/s after 140 frames: the U = 2 launch's
    device time against tools/collider_scaling_tpu.py's scenes at C = 1, 2
    and 4 (tests/torch_table_configs.py) and against collision_1M's two
    cuboids."""
    import sys
    from pathlib import Path

    import bevy_firework_tpu_torch as bt
    from bevy_firework_tpu_torch.models import effects
    from bevy_firework_tpu_torch.ops import fused_step as fs
    from bevy_firework_tpu_torch.settings import EmissionPacing

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))
    import torch_table_configs as table_cfg

    f = bt.make_frame_input(1 / 60)
    sp, _tf, cuboids = effects.stress_test_collision()
    es = dataclasses.replace(sp.emission_settings[0], emission_pacing=EmissionPacing.rate(500_000.0))
    c = bt.compile_spawner(dataclasses.replace(sp, emission_settings=(es,)), device="cuda")
    scenes = {f"scaling_C{n}": table_cfg.scaling_colliders(n) for n in (1, 2, 4)}
    scenes["collision_1M"] = cuboids
    res = {}
    for label, cols in scenes.items():
        table = bt.compile_colliders(cols, device="cuda")
        s, out = fs.multi_step_auto(c.static, c.params, table, bt.init_pool_for(c, 160 * 8192, seed=0), f, 140)
        ms, per = launch_device_ms(lambda: fs.fused_step(c.static, c.params, table, s, f, unroll=2, stats=False),
                                   calls, traces)
        res[label] = {"colliders": len(cols), "live": int(out.alive_count), "u2_kernel_device_ms": ms,
                      "u2_traces": per}
    return res


def ptxas_summary(report: str) -> list:
    """Per kernel of ptxas's report: its name (the step kernel's template
    arguments ring, collide, fields, stats, merge, fleet spelled out, and
    `args` those six as ints; the warp-cadence kernel's stats flag, and
    `warp_stats` that flag as an int; the merge kernel's ring and stats
    flags, and `merge_args` those two as ints), its mangled `symbol`,
    registers, stack, spill bytes and shared memory."""
    import re

    out = []
    for block in report.split("Compiling entry function")[1:]:
        name = re.search(r"'(\S+)'", block).group(1)
        t = re.search(r"fused_step_kernelILb(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)E", name)
        w = re.search(r"fused_step_kernel_warpILb(\d)E", name)
        mg = re.search(r"fused_step_kernel_mergeILb(\d)ELb(\d)E", name)
        ns = re.search(r"nested_stage_kernelILb(\d)E", name)
        row = {"symbol": name}
        if ns:
            name = f"nested_stage_kernel<barrier={ns.group(1)}>"
        elif mg:
            name = "fused_step_kernel_merge<ring={},stats={}>".format(*mg.groups())
            row["merge_args"] = [int(v) for v in mg.groups()]
        elif t:
            name = "fused_step_kernel<ring={},collide={},fields={},stats={},merge={},fleet={}>".format(*t.groups())
            row["args"] = [int(v) for v in t.groups()]
        elif w:
            name = f"fused_step_kernel_warp<stats={w.group(1)}>"
            row["warp_stats"] = int(w.group(1))
        else:
            name = re.search(r"([a-z_]+_kernel)E", name).group(1)
        row = {"kernel": name, **row, "registers": int(re.search(r"Used (\d+) registers", block).group(1))}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", block)
        row.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"(\d+) bytes smem", block)
        row["smem"] = int(m.group(1)) if m else 0
        out.append(row)
    return out


# opcodes whose counts `sass_counts` reports beside each kernel's total
SASS_OPCODES = ("MUFU", "BRA", "CALL", "LDS", "LDG", "FFMA", "FMUL", "FADD")


def sass_counts(library) -> dict:
    """Per kernel symbol of the built library's SASS (`cuobjdump -sass`,
    from nvcc's directory): its instructions (NOPs left out) and the counts
    of SASS_OPCODES among them."""
    import re
    from pathlib import Path

    from bevy_firework_tpu_torch.ops import _build

    dump = subprocess.run([str(Path(_build.nvcc_path()).parent / "cuobjdump"), "-sass", str(library)],
                          capture_output=True, text=True, timeout=600, check=True).stdout
    out, row = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            row = out.setdefault(m.group(1), {"instructions": 0, **{k: 0 for k in SASS_OPCODES}})
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and row is not None and m.group(1) != "NOP":
            row["instructions"] += 1
            if m.group(1) in row:
                row[m.group(1)] += 1
    return out


def kernel_report(sass: bool = False) -> list:
    """`ptxas_summary` of the imported tree's kernel library (built if
    missing), with each step-kernel instantiation's resident blocks of 256
    threads per SM at no dynamic shared memory: asked of the card
    (`bf_step_occupancy`, `blocks_per_sm_from` "card") where the library
    exports it, else from its registers and static shared memory alone
    ("registers"); with `sass`, each kernel's `sass_counts`. The
    warp-cadence and merge kernels' rows likewise (`bf_step_warp_occupancy`,
    `bf_step_merge_occupancy`)."""
    from bevy_firework_tpu_torch.ops import _build

    rows = ptxas_summary(_build.ptxas_report())
    counts = sass_counts(_build.build()) if sass else {}
    for row in rows:
        symbol = row.pop("symbol")
        if sass:
            row["sass"] = counts.get(symbol)
    lib = _build.load()
    occupancy = getattr(lib, "bf_step_occupancy", None)
    warp_occupancy = getattr(lib, "bf_step_warp_occupancy", None)
    merge_occupancy = getattr(lib, "bf_step_merge_occupancy", None)
    for row in rows:
        if "args" not in row and "warp_stats" not in row and "merge_args" not in row:
            continue
        if "warp_stats" in row and warp_occupancy is not None:
            row["blocks_per_sm"], row["blocks_per_sm_from"] = int(warp_occupancy(row["warp_stats"], 0)), "card"
        elif "merge_args" in row and merge_occupancy is not None:
            row["blocks_per_sm"], row["blocks_per_sm_from"] = int(merge_occupancy(*row["merge_args"], 0)), "card"
        elif "args" in row and occupancy is not None:
            row["blocks_per_sm"], row["blocks_per_sm_from"] = int(occupancy(*row["args"], 0)), "card"
        else:  # 64K registers and 228 KB of shared memory per SM, 8 warps of 256-register granules per block
            regs = -(-row["registers"] * 32 // 256) * 256 * 8
            row["blocks_per_sm"] = min(8, 65536 // regs, 233472 // max(row["smem"] + 1024, 1))
            row["blocks_per_sm_from"] = "registers"
    return rows


def launch_ms(rate: float, capacity: int, calls: int = 50, traces: int = 3) -> dict:
    """Device time of one U = 8 launch (stats off) of stress_test after a
    140-frame chain at this size (`launch_device_ms`)."""
    import bevy_firework_tpu_torch as bt
    from bevy_firework_tpu_torch.models import effects
    from bevy_firework_tpu_torch.ops import fused_step as fs
    from bevy_firework_tpu_torch.settings import EmissionPacing

    sp, _tf = effects.stress_test()
    es = dataclasses.replace(sp.emission_settings[0], emission_pacing=EmissionPacing.rate(rate))
    c = bt.compile_spawner(dataclasses.replace(sp, emission_settings=(es,)), device="cuda")
    f = bt.make_frame_input(1 / 60)
    s, out = fs.multi_step_auto(c.static, c.params, None, bt.init_pool_for(c, capacity), f, 140)

    ms, per = launch_device_ms(lambda: fs.fused_step(c.static, c.params, None, s, f, unroll=8, stats=False), calls,
                               traces)
    return {"rate": rate, "capacity": capacity, "live": int(out.alive_count), "u8_kernel_device_ms": ms, "traces": per}


def fleet_ms(calls: int = 20, traces: int = 3) -> dict:
    """Kernel row 7: device time per launch (stats off unless named) of the
    fleet's launches: fleet_16x55k (stress_test at 55000/s, 16 slots of
    65536 lanes, after a 140-frame multi_step_fleet chain) at U = 8 and at
    U = 1 with the stats block; the fleet's U = 2 launch of
    stress_test_collision at 31250/s in 16 slots of 65536 lanes against its
    two cuboids (the fleet's narrow phase); a field fleet (library.dust at
    30000/s in 16 slots of 65536 lanes, each under the tornado's three
    fields about its own centre, after 140 frames) at U = 8; and the
    dead-rank fleet (tests/torch_fleet_configs.py's destroy_dump case at
    3 slots of 1310720 lanes, after 12 frames) at U = 1 with the stats
    block and the dump plane, its claim's count and scan kernels not
    counted."""
    import sys
    from pathlib import Path

    import bevy_firework_tpu_torch as bt
    from bevy_firework_tpu_torch.models import effects, library
    from bevy_firework_tpu_torch.ops import fused_step as fs
    from bevy_firework_tpu_torch.parallel.sharding import stack_frames, stack_pools
    from bevy_firework_tpu_torch.settings import EmissionPacing

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))
    import torch_fleet_configs as fleet_cfg

    res = fleet16_ms(calls, traces)
    fr = stack_frames([bt.make_frame_input(1 / 60, translation=(float(i), 0.0, 0.0)) for i in range(16)])
    sp, _tf, cuboids = effects.stress_test_collision()
    es = dataclasses.replace(sp.emission_settings[0], emission_pacing=EmissionPacing.rate(31250.0))
    cf = bt.compile_spawner(dataclasses.replace(sp, emission_settings=(es,)), device="cuda")
    table = bt.compile_colliders(cuboids, device="cuda")
    st = stack_pools([bt.init_pool_for(cf, 65536, seed=i) for i in range(16)])
    st, _o = fs.multi_step_fleet(cf.static, cf.params, table, st, fr, 140)
    ms, per = launch_device_ms(lambda: fs.fused_step_fleet(cf.static, cf.params, table, st, fr, unroll=2,
                                                           stats=False), calls, traces)
    res["fleet_collision_16x65k"] = {"u2_fleet_kernel_device_ms": ms, "u2_traces": per}
    cd = bt.compile_spawner(library.dust(rate=30000.0, lifetime=4.0, updraft=2.5, drag=2.0, emit_radius=1.2),
                            device="cuda")
    frd = stack_frames([bt.make_frame_input(1 / 60, translation=(float(i), 0.0, 0.0), force_fields=bt.compile_force_fields(
        tornado_fields(float(i), 0.0), device="cuda")) for i in range(16)])
    st = stack_pools([bt.init_pool_for(cd, 65536, seed=i) for i in range(16)])
    st, out = fs.multi_step_fleet(cd.static, cd.params, None, st, frd, 140)
    ms, per = launch_device_ms(lambda: fs.fused_step_fleet(cd.static, cd.params, None, st, frd, unroll=8,
                                                           stats=False), calls, traces)
    res["fleet_fields_16x65k"] = {"live": int(out.alive_count.sum()), "u8_fleet_kernel_device_ms": ms,
                                  "u8_traces": per}
    static, params, col, pools, frames, _u, _p = fleet_cfg.build("destroy_dump", "cuda", 1310720)
    st, frs = fleet_cfg.stacked(pools, frames)
    for _ in range(12):
        st, out = fs.fused_step_fleet(static, params, col, st, frs)
    ms, per = launch_device_ms(lambda: fs.fused_step_fleet(static, params, col, st, frs), calls, traces)
    res["fleet_dead_rank_3x1M"] = {"live": out.alive_count.tolist(), "u1_stats_fleet_kernel_device_ms": ms,
                                   "u1_traces": per}
    return res


def fleet16_ms(calls: int = 20, traces: int = 3) -> dict:
    """fleet_16x55k's U = 8 launch (stats off) and U = 1 launch with the
    stats block: `fleet_ms`'s first cell, alone so that it can time a tree
    older than the rest of that group."""
    import bevy_firework_tpu_torch as bt
    from bevy_firework_tpu_torch.models import effects
    from bevy_firework_tpu_torch.ops import fused_step as fs
    from bevy_firework_tpu_torch.parallel.sharding import stack_frames, stack_pools
    from bevy_firework_tpu_torch.settings import EmissionPacing

    sp, _tf = effects.stress_test()
    es = dataclasses.replace(sp.emission_settings[0], emission_pacing=EmissionPacing.rate(55000.0))
    c16 = bt.compile_spawner(dataclasses.replace(sp, emission_settings=(es,)), device="cuda")
    st = stack_pools([bt.init_pool_for(c16, 65536, seed=i) for i in range(16)])
    fr = stack_frames([bt.make_frame_input(1 / 60, translation=(float(i), 0.0, 0.0)) for i in range(16)])
    st, _o = fs.multi_step_fleet(c16.static, c16.params, None, st, fr, 140)
    ms, per = launch_device_ms(lambda: fs.fused_step_fleet(c16.static, c16.params, None, st, fr, unroll=8,
                                                           stats=False), calls, traces)
    ms1, per1 = launch_device_ms(lambda: fs.fused_step_fleet(c16.static, c16.params, None, st, fr), calls, traces)
    return {"fleet_16x55k": {"u8_fleet_kernel_device_ms": ms, "u8_traces": per,
                             "u1_stats_fleet_kernel_device_ms": ms1, "u1_stats_traces": per1}}


def tornado_fields(x: float = 0.0, z: float = 0.0) -> list:
    """examples/force_fields.py's funnel: a vortex and an axial field about
    the vertical line through (x, 0, z), and turbulence about (0, 2, 0)."""
    import bevy_firework_tpu_torch as bt

    return [bt.ForceField.vortex((x, 0.0, z), (0.0, 1.0, 0.0), strength=12.0, radius=6.0),
            bt.ForceField.axial((x, 0.0, z), (0.0, 1.0, 0.0), strength=25.0, radius=7.0),
            bt.ForceField.turbulence((0.0, 2.0, 0.0), strength=1.8, radius=8.0, frequency=2.2)]


def field_zero_warps(fields: list, state) -> dict:
    """Per field of `fields`, the share of warps (32 consecutive lanes) with
    a live lane in which every live lane of `state` gets 0 from it: w == 0
    at a finite distance (the f32 ops of `force_fields.field_accel`), so
    its term is +-0 and a per-warp cull could skip it. `state` is a frame's
    output: its live lanes are the frame's survivors at their post-move
    positions, where the field block evaluated them."""
    import torch

    live = state.alive
    groups = -(-live.shape[0] // 32)
    pad = groups * 32 - live.shape[0]
    live_g = torch.cat([live, live.new_zeros(pad)]).view(groups, 32)
    any_live = live_g.any(1)
    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=live.device)

    out = {}
    for i, fld in enumerate(fields):
        rx, ry, rz = state.px - f32(fld.position[0]), state.py - f32(fld.position[1]), state.pz - f32(fld.position[2])
        if fld.kind in (1, 2):  # FIELD_VORTEX, FIELD_AXIAL: distance to the axis line
            ux, uy, uz = (f32(v) for v in fld.axis)
            tx, ty, tz = uy * rz - uz * ry, uz * rx - ux * rz, ux * ry - uy * rx
            d = torch.sqrt(tx * tx + ty * ty + tz * tz)
        else:
            d = torch.sqrt(rx * rx + ry * ry + rz * rz)
        w = torch.clamp_min(1.0 - d * (f32(1.0) / f32(fld.radius)), 0.0)
        zero = (w == 0) & torch.isfinite(d)
        zero_g = torch.cat([zero | ~live, zero.new_ones(pad)]).view(groups, 32).all(1) & any_live
        out[f"{i}:{('point', 'vortex', 'axial', 'turbulence')[fld.kind]}"] = float(zero_g.sum()) / max(
            int(any_live.sum()), 1)
    return out


def fields_ms(calls: int = 20, traces: int = 3) -> dict:
    """Kernel row 5: device time per launch (stats off) of fields_1M's U = 8
    launch (chip_smoke.py's phase 20: library.dust at 3e5/s, lifetime 4 s,
    capacity 1310720, after a 300-frame multi_step_auto chain under
    examples/force_fields.py's three fields) at that state: under the three
    fields, under each alone, and under none (the main-path instantiation);
    and `field_zero_warps` of one plain frame from that state."""
    import bevy_firework_tpu_torch as bt
    from bevy_firework_tpu_torch.models import library
    from bevy_firework_tpu_torch.ops import fused_step as fs
    from bevy_firework_tpu_torch.step import plain_frames

    c = bt.compile_spawner(library.dust(rate=3e5, lifetime=4.0, updraft=2.5, drag=2.0, emit_radius=1.2),
                           device="cuda")
    tornado = tornado_fields(0.0, 0.0)
    f3 = bt.make_frame_input(1 / 60, force_fields=bt.compile_force_fields(tornado, device="cuda"))
    s, out = fs.multi_step_auto(c.static, c.params, None, bt.init_pool_for(c, 160 * 8192, seed=0), f3, 300)
    res = {"capacity": 160 * 8192, "live": int(out.alive_count)}
    sets = {"three": tornado, "vortex": tornado[:1], "axial": tornado[1:2], "turbulence": tornado[2:], "none": None}
    for label, fields in sets.items():
        fr = bt.make_frame_input(1 / 60, force_fields=None if fields is None else bt.compile_force_fields(
            fields, device="cuda"))
        ms, per = launch_device_ms(lambda: fs.fused_step(c.static, c.params, None, s, fr, unroll=8, stats=False),
                                   calls, traces)
        res[label] = {"u8_kernel_device_ms": ms, "u8_traces": per}
    s1, _o = plain_frames(c.static, c.params, s, f3, 1, stats=False)
    res["zero_warp_share"] = field_zero_warps(tornado, s1)
    return res


def cells_ms(calls: int = 20, traces: int = 3) -> dict:
    """Device time per launch (stats off) of one U = 2 and one U = 8 launch
    of stress_test_collision at 5e5/s, capacity 1310720, against its two
    cuboids and against bench.py's 8 hulls (a 6-plane floor and 7
    tetrahedra), each after a 140-frame chain, and of nested_60k's step
    launch in an unfolded hybrid frame (bench.py's `_measure_nested`
    spawner, capacity 131072, nested_buffer 1024, after 150 frames)."""
    import bevy_firework_tpu_torch as bt
    from bevy_firework_tpu_torch.models import effects
    from bevy_firework_tpu_torch.ops import fused_step as fs
    from bevy_firework_tpu_torch.settings import EmissionPacing

    f = bt.make_frame_input(1 / 60)
    sp, _tf, cuboids = effects.stress_test_collision()
    res = {}
    hulls = [bt.Collider.hull([(1, 0, 0, 60.0), (-1, 0, 0, 60.0), (0, 1, 0, 1.0), (0, -1, 0, 1.0), (0, 0, 1, 60.0),
                               (0, 0, -1, 60.0)], position=(0.0, -1.5, 0.0))]
    hulls += [bt.Collider.hull_from_points([(0, 0, 0), (2.0, 0, 0), (0, 2.5, 0), (0, 0, 2.0)],
                                           position=(float(i * 3 - 9), -0.5, float((i % 3) * 3 - 3))) for i in range(7)]
    es = dataclasses.replace(sp.emission_settings[0], emission_pacing=EmissionPacing.rate(500_000.0))
    c = bt.compile_spawner(dataclasses.replace(sp, emission_settings=(es,)), device="cuda")
    for label, cols in (("collision_1M", cuboids), ("hull8_1M", hulls)):
        table = bt.compile_colliders(cols, device="cuda")
        s, out = fs.multi_step_auto(c.static, c.params, table, bt.init_pool_for(c, 160 * 8192, seed=0), f, 140)
        res[label] = {"live": int(out.alive_count)}
        for u in (2, 8):
            ms, per = launch_device_ms(lambda: fs.fused_step(c.static, c.params, table, s, f, unroll=u, stats=False),
                                       calls, traces)
            res[label].update({f"u{u}_kernel_device_ms": ms, f"u{u}_traces": per})
    nested = bt.ParticleSpawner(
        particle_settings=[bt.ParticleSettings(lifetime=bt.RandF32.constant(2.0), linear_drag=0.1),
                           bt.ParticleSettings(lifetime=bt.RandF32.constant(2.0), linear_drag=0.3)],
        emission_settings=[
            bt.EmissionSettings(particle_index=0, emission_pacing=EmissionPacing.rate(4000.0),
                                initial_velocity=bt.RandVec3(bt.RandF32(2.0, 6.0), (0, 1, 0), 0.5)),
            bt.EmissionSettings(particle_index=1, emission_mode=bt.EmissionMode.nested(0),
                                emission_pacing=EmissionPacing.count_over_duration(10.0, 1.0, 0.0, 1.0),
                                initial_velocity=bt.RandVec3(bt.RandF32(0.2, 1.0), (0, 1, 0), 3.14),
                                inherit_parent_velocity=True)])
    cn = bt.compile_spawner(nested, nested_buffer=1024, device="cuda")
    s, out = fs.multi_step_auto(cn.static, cn.params, None, bt.init_pool_for(cn, 16 * 8192, seed=0), f, 150)
    ms, per = launch_device_ms(lambda: fs.fused_step(cn.static, cn.params, None, s, f, stats=False), calls, traces)
    res["nested_60k"] = {"live": int(out.alive_count), "hybrid_step_kernel_device_ms": ms, "traces": per}
    return res


# the port's own kernels of a hybrid frame's nested stage (the step kernel
# and PyTorch's fills and copies are reported beside them, not in it)
NESTED_STAGE_KERNELS = ("nested_stage_kernel", "nested_count_kernel", "tile_scan_kernel", "nested_apply_kernel",
                        "nested_child_rows_kernel", "dead_count_kernel")
# the port's own kernels (every other kernel of a trace is PyTorch's: its
# elementwise, reduction and fill kernels, memsets and copies)
PORT_KERNELS = NESTED_STAGE_KERNELS + ("fused_step_kernel", "fused_step_kernel_warp", "fused_step_kernel_merge",
                                       "empty_kernel")


def kernel_table(prof, calls: int) -> dict:
    """Per CUDA kernel of a torch.profiler trace of `calls` calls (its name
    up to its argument list, without the anonymous namespace): device us
    per launch, launches per call and device us per call."""
    import torch

    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or not e.count:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        name = e.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0].strip()[:72]
        row = out.setdefault(name, {"us": 0.0, "launches": 0})
        row["us"] += t
        row["launches"] += e.count
    return {k: {"us_per_launch": v["us"] / v["launches"], "launches_per_call": v["launches"] / calls,
                "us_per_call": v["us"] / calls} for k, v in out.items()}


def traced_kernels(call, calls: int, traces: int) -> dict:
    """`kernel_table` of `traces` traces of `calls` calls of `call`, each
    number the median over the traces, `stage_us_per_call`: the
    NESTED_STAGE_KERNELS' device us per call (a trace that lost launches
    reads low: launches_per_call shows it), and `torch_kernels_per_call`
    and `torch_us_per_call`: PyTorch's kernels (all but PORT_KERNELS)."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    tables = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        tables.append(kernel_table(prof, calls))
    names = {k for t in tables for k in t}
    res = {k: {m: statistics.median(t[k][m] for t in tables if k in t)
               for m in ("us_per_launch", "launches_per_call", "us_per_call")} for k in sorted(names)}
    stage = [sum(v["us_per_call"] for k, v in t.items() if k.split("<")[0] in NESTED_STAGE_KERNELS) for t in tables]
    torch_rows = [[v for k, v in t.items() if k.split("<")[0] not in PORT_KERNELS] for t in tables]
    return {"kernels": res, "stage_us_per_call": statistics.median(stage), "stage_traces": stage,
            "us_per_call": statistics.median(sum(v["us_per_call"] for v in t.values()) for t in tables),
            "torch_kernels_per_call": statistics.median(sum(v["launches_per_call"] for v in r) for r in torch_rows),
            "torch_us_per_call": statistics.median(sum(v["us_per_call"] for v in r) for r in torch_rows)}


def nested_ms(calls: int = 20, traces: int = 3) -> dict:
    """Kernel rows 8, 9, 9b and 10, a hybrid frame's nested stage and step
    launch, per call and per kernel, PyTorch's counted apart
    (`traced_kernels`, stats off) on states of 131072 lanes
    with child buffer 1024: nested_60k and nested_chained (bench.py's
    nested cells after 150 frames; a ring, fetch mode), chip_smoke's
    dead-rank nested_det archetype after 30 frames (cum mode), and a burst
    (tests/torch_nested_configs.burst_nested after 30 frames: the total
    exceeds the buffer and one tile owns every rank); and nested_60k's
    spawner in a pool of 1310720 lanes (5120 tiles). Per state: the
    unfolded hybrid frame, and on the ring states the folded frame (a copy
    of the seed's carry per call, made before the trace; the fold epilogue
    on); on nested_60k also the
    entry points `nested_cadence_pass` (fetch and cum mode) and
    `nested_child_rows` (both parent modes). `launch_floor`: three launches
    of an empty kernel per call (device us, and CUDA-event wall us per
    call), where the tree's library has them."""
    import sys
    from pathlib import Path

    import numpy as np
    import torch

    import bevy_firework_tpu_torch as bt
    from bevy_firework_tpu_torch.ops import _build
    from bevy_firework_tpu_torch.ops import fused_step as fs
    from bevy_firework_tpu_torch.step import nested_cadence, nested_parents

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))
    import torch_nested_configs as nested_cfg

    f = bt.make_frame_input(1 / 60)
    floor = bt.compile_colliders(nested_cfg.DET_FLOOR, device="cuda")
    states = {"nested_60k": (nested_cfg.bench_nested(False), None, 150, 16 * 8192),
              "nested_chained": (nested_cfg.bench_nested(True), None, 150, 16 * 8192),
              "dead_rank": (nested_cfg.det_nested(destroy=True), floor, 30, 16 * 8192),
              "burst": (nested_cfg.burst_nested(), None, 30, 16 * 8192),
              "nested_60k_1310720": (nested_cfg.bench_nested(False), None, 150, 160 * 8192)}
    res = {}
    for label, (sp, table, warm, capacity) in states.items():
        c = bt.compile_spawner(sp, nested_buffer=1024, device="cuda")
        s, out = fs.multi_step_auto(c.static, c.params, table, bt.init_pool_for(c, capacity, seed=0), f, warm)
        life = torch.full((), float(c.static.const_lifetime), device="cuda") if c.static.const_lifetime is not None \
            else s.lifetime
        ranks = {}
        for e in fs.nested_emitters(c.static):
            _le, cum, total, _pv = nested_cadence(c.static, c.params, e, s.alive, s.ptype, s.age, life,
                                                  s.last_emitted[e], s.enabled[e], 1024)
            ranks[e] = {"total": int(total), "max_tile_ranks": nested_cfg.tile_ranks(cum, 1024)}
        row = res[label] = {"live": int(out.alive_count), "per_type": out.alive_count_per_type.tolist(),
                            "emitters": ranks,
                            "unfolded": traced_kernels(lambda: fs.fused_step(c.static, c.params, table, s, f,
                                                                             stats=False), calls, traces)}
        if fs.can_fold_nested(c.static, s.capacity):
            carry = fs._seed_nested_carry(c.static, c.params, s)
            # one copy of the seed's carry per call, made before the traces
            # (the frame writes its records into the carry's NS buffer)
            copies = iter([fs.FoldCarry(carry.counts.clone(), carry.ns.clone()) for _ in range(1 + calls * traces)])
            row["folded"] = traced_kernels(lambda: fs.fused_step_hybrid(
                c.static, c.params, table, s, f, stats=False, fold_out=True, nested_carry=next(copies)), calls,
                traces)
        if label == "nested_60k":
            par = {k: getattr(s, k) for k in fs.nested_parent_fields(c.static)}
            gate = s.enabled[1]
            args = (c.static, c.params, 1, s.alive, s.ptype, s.age, None, s.last_emitted[1], gate, 1024)
            _le, cum, _t, _pv = nested_cadence(*args[:6], life, *args[7:])
            pv = {k: v[nested_parents(cum, 1024)] for k, v in par.items()}
            key = np.array([1, 2], np.uint32)
            row["pass_fetch"] = traced_kernels(lambda: fs.nested_cadence_pass(*args, parent_fields=par), calls, traces)
            row["pass_cum"] = traced_kernels(lambda: fs.nested_cadence_pass(*args), calls, traces)
            row["child_fetch"] = traced_kernels(lambda: fs.nested_child_rows(c.static, c.params, f, 1, key, 1024,
                                                                             parent_vals=pv), calls, traces)
            row["child_cum"] = traced_kernels(lambda: fs.nested_child_rows(c.static, c.params, f, 1, key, 1024,
                                                                           cum=cum, parent_planes=par), calls, traces)
    lib = _build.load()
    if hasattr(lib, "bf_empty_launches"):
        stream = torch.cuda.current_stream().cuda_stream
        floor_call = lambda: lib.bf_empty_launches(3, stream)  # noqa: E731
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        floor_call()
        start.record()
        for _ in range(200):
            floor_call()
        end.record()
        torch.cuda.synchronize()
        res["launch_floor"] = {"three_empty": traced_kernels(floor_call, calls, traces),
                               "wall_us_per_call": start.elapsed_time(end) / 200 * 1e3}
    return res


def words_ms(calls: int = 20, traces: int = 3) -> dict:
    """Kernel rows 1, 7, 8/9b and 9/10 launched with their frame rows, seeds
    and nested keys by value and, where the tree has them
    (`fused_step.DeviceWords`, the words a captured chain's replays copy
    in), as device words, in turns (value, words, words, value; medians of
    each side's traces): main_100k's U = 8 launch after 140 frames (stats
    off), fleet_16x55k's U = 8 launch after 140 frames, and nested_60k's
    unfolded and folded hybrid frames after 150 frames (the nested-stage
    launch, rows 8/9b, and the step launch, rows 9/10, per kernel,
    `traced_kernels`). A tree without device words gives the by-value
    times alone."""
    import statistics
    import sys
    from pathlib import Path

    import bevy_firework_tpu_torch as bt
    from bevy_firework_tpu_torch.models import effects
    from bevy_firework_tpu_torch.ops import fused_step as fs
    from bevy_firework_tpu_torch.parallel.sharding import stack_frames, stack_pools
    from bevy_firework_tpu_torch.settings import EmissionPacing

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))
    import torch_nested_configs as nested_cfg

    has_words = hasattr(fs, "DeviceWords")
    if has_words:
        from bevy_firework_tpu_torch.ops import chain_graph

    def words_call(kind, static, state, frame, n, call):
        dw = fs.DeviceWords.upload(chain_graph.chain_words(kind, static, None, state, frame, n)[0], "cuda")

        def run():
            dw.at = 0
            with fs.device_words(dw):
                return call()
        return run

    def turns(value_call, word_call, measure):
        """measure() of value, words, words, value: {"value": median, "words": median, "traces": [...]}."""
        seq = [measure(value_call)] + ([measure(word_call), measure(word_call)] if word_call else []) + [
            measure(value_call)]
        res = {"value": statistics.median(seq[0][1] + seq[-1][1]), "value_traces": seq[0][1] + seq[-1][1]}
        if word_call:
            res.update(words=statistics.median(seq[1][1] + seq[2][1]), words_traces=seq[1][1] + seq[2][1])
            res["words_over_value"] = res["words"] / res["value"]
        return res

    def launch(call):
        return launch_device_ms(call, calls, traces)

    out = {"device_words": has_words}
    sp, _tf = effects.stress_test()
    es = dataclasses.replace(sp.emission_settings[0], emission_pacing=EmissionPacing.rate(1e5))
    c = bt.compile_spawner(dataclasses.replace(sp, emission_settings=(es,)), device="cuda")
    f = bt.make_frame_input(1 / 60)
    s, _o = fs.multi_step_auto(c.static, c.params, None, bt.init_pool_for(c, 1 << 17), f, 140)
    call = lambda: fs.fused_step(c.static, c.params, None, s, f, unroll=8, stats=False)  # noqa: E731
    out["row1_main_100k_u8_ms"] = turns(call, words_call("auto", c.static, s, f, 8, call) if has_words else None,
                                        launch)
    es16 = dataclasses.replace(sp.emission_settings[0], emission_pacing=EmissionPacing.rate(55000.0))
    c16 = bt.compile_spawner(dataclasses.replace(sp, emission_settings=(es16,)), device="cuda")
    st = stack_pools([bt.init_pool_for(c16, 65536, seed=i) for i in range(16)])
    fr = stack_frames([bt.make_frame_input(1 / 60, translation=(float(i), 0.0, 0.0)) for i in range(16)])
    st, _o = fs.multi_step_fleet(c16.static, c16.params, None, st, fr, 140)
    call = lambda: fs.fused_step_fleet(c16.static, c16.params, None, st, fr, unroll=8, stats=False)  # noqa: E731
    out["row7_fleet_16x55k_u8_ms"] = turns(call, words_call("fleet", c16.static, st, fr, 8, call) if has_words
                                           else None, launch)
    cn = bt.compile_spawner(nested_cfg.bench_nested(False), nested_buffer=1024, device="cuda")
    sn, _o = fs.multi_step_auto(cn.static, cn.params, None, bt.init_pool_for(cn, 16 * 8192, seed=0), f, 150)
    carry = fs._seed_nested_carry(cn.static, cn.params, sn)
    n_copies = 4 * traces * (1 + calls)  # the folded frame's four turns of traces
    copies = iter([fs.FoldCarry(carry.counts.clone(), carry.ns.clone()) for _ in range(n_copies)])
    frames = {"unfolded": lambda: fs.fused_step(cn.static, cn.params, None, sn, f, stats=False),
              "folded": lambda: fs.fused_step_hybrid(cn.static, cn.params, None, sn, f, stats=False, fold_out=True,
                                                     nested_carry=next(copies))}
    for label, call in frames.items():
        def per_kernel(fn):
            tab = [traced_kernels(fn, calls, 1)["kernels"] for _ in range(traces)]
            return tab, [{k.split("<")[0]: v["us_per_launch"] for k, v in t.items()} for t in tab]

        seq = [per_kernel(call)]
        if has_words:
            wcall = words_call("auto", cn.static, sn, f, 1, call)
            seq += [per_kernel(wcall), per_kernel(wcall)]
        seq.append(per_kernel(call))
        row = {}
        for kern, key in (("nested_stage_kernel", "rows_8_9b_stage_us"),
                          ("fused_step_kernel_merge", "rows_9_10_step_us")):
            value = [t.get(kern) for t in seq[0][1] + seq[-1][1] if t.get(kern)]
            row[key] = {"value": statistics.median(value), "value_traces": value}
            if has_words:
                words = [t.get(kern) for t in seq[1][1] + seq[2][1] if t.get(kern)]
                row[key].update(words=statistics.median(words), words_traces=words,
                                words_over_value=statistics.median(words) / statistics.median(value))
        out[f"nested_60k_{label}"] = row
    return out


def flows_ms(windows: int = 3) -> dict:
    """The solo path's end-to-end times, as chip_smoke.py measures them:
    ms/frame of stress_test's multi_step_auto chain at 100k and 1M live
    ((t(2n) - t(n)) / n with CUDA events after 140 warm-up frames, median
    of 5), and ms per Scene.step of the tornado flow (dust under three
    force fields moved every frame) and the fireworks flow (nested
    emission), each the median of `windows` windows (300 and 600 frames)
    after 60 warm-up frames; `min` beside each median (host-bound times
    only lose to contention, so the least is the host's own cost)."""
    import math
    import statistics

    import torch

    import bevy_firework_tpu_torch as bt
    from bevy_firework_tpu_torch.models import effects, library
    from bevy_firework_tpu_torch.ops import fused_step as fs
    from bevy_firework_tpu_torch.settings import EmissionPacing

    def event_ms(fn):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    res = {}
    sp, _tf = effects.stress_test()
    for label, rate, cap, n in (("main_100k", 100_000.0, 1 << 17, 400), ("main_1M", 1_000_000.0, 160 * 8192, 150)):
        es = dataclasses.replace(sp.emission_settings[0], emission_pacing=EmissionPacing.rate(rate))
        c = bt.compile_spawner(dataclasses.replace(sp, emission_settings=(es,)), device="cuda")
        f = bt.make_frame_input(1 / 60)
        s, out = fs.multi_step_auto(c.static, c.params, None, bt.init_pool_for(c, cap, seed=0), f, 140)

        def run(k):
            return fs.multi_step_auto(c.static, c.params, None, s, f, k)

        run(n)
        diffs = [(event_ms(lambda: run(2 * n)) - event_ms(lambda: run(n))) / n for _ in range(5)]
        res[label] = {"live": int(out.alive_count), "ms_per_frame": statistics.median(diffs), "min": min(diffs),
                      "runs": diffs}

    def scene_windows(sc, frames, before_step=lambda f: None):
        def steps(f0, k):
            for f in range(f0, f0 + k):
                before_step(f)
                sc.step(1 / 60)

        steps(0, 60)
        per = []
        for w in range(windows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps(60 + w * frames, frames)
            torch.cuda.synchronize()
            per.append((time.perf_counter() - t0) / frames * 1e3)
        return {"live": sc.alive_count(), "ms_per_scene_step": statistics.median(per), "min": min(per),
                "windows": per}

    tornado = bt.Scene(force_fields=tornado_fields(0.0, 0.0), device="cuda")
    tornado.add_spawner(library.dust(updraft=2.5, drag=2.0, emit_radius=1.2), capacity=8192)

    def wander(f):
        x, z = 0.8 * math.sin(f * 0.02), 0.8 * math.cos(f * 0.017)
        tornado.set_force_field(0, position=(x, 0.0, z))
        tornado.set_force_field(1, position=(x, 0.0, z))

    res["tornado"] = scene_windows(tornado, 300, wander)
    fsp, ftf = effects.fireworks()
    fireworks = bt.Scene(device="cuda")
    fireworks.add_spawner(fsp, transform=ftf)
    res["fireworks"] = scene_windows(fireworks, 600)
    return res


def claim_ms(calls: int = 20, traces: int = 3) -> dict:
    """Kernel rows 4 and 11, a destroy frame's kernels per call
    (`traced_kernels`, stats off; `us_per_call` every kernel, PyTorch's
    included): tests/torch_shard_configs.py's destroy config (the box
    emitter destroying on a halfspace) after 30 frames at 131072 lanes
    (3e5/s) and at 1310720 (5e5/s). `frame`: one frame from that state (a
    tree with the carried claim: the step launch on the counts the chain's
    last launch left; an older tree: the claim's count and scan kernels,
    then the step); `seed_frame`: the same on a copy of the alive plane (a
    carried tree: the seed's count kernel, then the step; copies made before
    the traces); `scanned_step` (trees with `_dead_offsets`): the step
    launch given the scanned offsets. At 1310720 lanes, `sharded_s4`: the
    S = 4 sharded destroy frame, the shards' dead offsets (a carried tree:
    the exclusive cumsum of their carried dead totals on the device; an
    older tree: each shard's dead lanes read on the host) then four launches,
    with its CUDA-event wall time per call (`wall_us_per_call`)."""
    import dataclasses
    import inspect
    import sys
    from pathlib import Path

    import torch

    import bevy_firework_tpu_torch as bt
    from bevy_firework_tpu_torch.ops import fused_step as fs

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))
    import torch_shard_configs as sc

    carried = hasattr(fs, "claim_counts")
    seam = "_dead_offsets" in inspect.signature(fs.fused_step).parameters
    res = {"carried_claim": carried}
    for cap, rate in ((16 * 8192, 3e5), (160 * 8192, 5e5)):
        c, table, f = sc.config("destroy", "cuda", rate=rate)
        s, out = fs.multi_step_auto(c.static, c.params, table, bt.init_pool_for(c, cap, seed=0), f, 30)
        row = res[f"destroy_{cap}"] = {"live": int(out.alive_count), "dead": int((~s.alive).sum())}
        row["frame"] = traced_kernels(lambda: fs.fused_step(c.static, c.params, table, s, f, stats=False), calls,
                                      traces)
        copies = iter([dataclasses.replace(s, alive=s.alive.clone()) for _ in range(1 + calls * traces)])
        row["seed_frame"] = traced_kernels(lambda: fs.fused_step(c.static, c.params, table, next(copies), f,
                                                                 stats=False), calls, traces)
        if seam:
            offs = fs.tile_dead_offsets(s.alive)
            row["scanned_step"] = traced_kernels(lambda: fs.fused_step(c.static, c.params, table, s, f, stats=False,
                                                                       _dead_offsets=offs), calls, traces)
        if cap < 160 * 8192:
            continue
        shards = sc.split(s, 4)
        bases = [sum(sh.capacity for sh in shards[:r]) for r in range(4)]

        def sharded_frame():
            if carried:
                totals = torch.stack([fs.claim_counts(sh.alive).sum(dtype=torch.int32) for sh in shards])
                offsets = list(torch.cumsum(totals, 0, dtype=torch.int32) - totals)
            else:
                dead = [int((~sh.alive).sum()) for sh in shards]
                offsets = [sum(dead[:r]) for r in range(4)]
            for sh, b, o in zip(shards, bases, offsets):
                fs.fused_step(c.static, c.params, table, sh, f, stats=False, shard=(b, cap, o))

        row["sharded_s4"] = traced_kernels(sharded_frame, calls, traces)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            sharded_frame()
        end.record()
        torch.cuda.synchronize()
        row["sharded_s4"]["wall_us_per_call"] = start.elapsed_time(end) / calls * 1e3
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON lines to this file")
    ap.add_argument("--launch", action="store_true",
                    help="time launches only: the groups --only names (all by default)")
    ap.add_argument("--only", default=",".join(LAUNCH_GROUPS),
                    help=f"with --launch, a comma list of {', '.join(LAUNCH_GROUPS)}")
    ap.add_argument("--flows", action="store_true",
                    help="time the solo path end to end (main_100k, main_1M, tornado, fireworks), nothing else")
    ap.add_argument("--root", help="import bevy_firework_tpu_torch from this directory")
    args = ap.parse_args()
    import sys
    from pathlib import Path

    # the tree to import, in place of this file's own directory: --root, or
    # the checkout this file is in
    sys.path[0] = str(Path(args.root or Path(__file__).resolve().parent.parent).resolve())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    lines = []

    def put(r):
        r.update(root=args.root or ".", card=card)
        lines.append(json.dumps(r))
        print(lines[-1], flush=True)

    if args.flows:
        put({"flows": flows_ms()})
    elif args.launch:
        groups = args.only.split(",")
        unknown = set(groups) - set(LAUNCH_GROUPS)
        if unknown:
            ap.error(f"unknown --only groups {sorted(unknown)}")
        if "kernels" in groups:
            rows = kernel_report(sass=True)
            # the field and fleet instantiations at a glance: registers,
            # stack frame, spills, blocks per SM and SASS instructions
            put({"kernels": rows, "fields_fleet": [
                {k: r[k] for k in ("kernel", "registers", "stack", "spill_stores", "spill_loads", "blocks_per_sm")}
                | {"sass_instructions": (r["sass"] or {}).get("instructions")}
                for r in rows if "args" in r and (r["args"][2] or r["args"][5])]})
        if "main" in groups:
            for rate, cap in ((100_000.0, 1 << 17), (1_000_000.0, 160 * 8192)):
                put(launch_ms(rate, cap))
            put(sparks_launch_ms())
        if "render" in groups:
            put({"render": render_ms()})
        if "stats" in groups:
            put({"stats": stats_ms()})
        if "fleet" in groups:
            put({"fleet": fleet_ms()})
        if "fields" in groups:
            put({"fields": fields_ms()})
        if "cells" in groups:
            put({"cells": cells_ms()})
        if "scaling" in groups:
            put({"scaling": scaling_ms()})
        if "nested" in groups:
            put({"nested": nested_ms()})
        if "words" in groups:
            put({"words": words_ms()})
        if "claim" in groups:
            put({"claim": claim_ms()})
    else:
        for rate, cap in ((100_000.0, 1 << 17), (1_000_000.0, 160 * 8192)):
            put(profile_size(rate, cap))
    if args.out:
        with open(args.out, "a") as fh:
            fh.write("\n".join(lines) + "\n")


# --launch's groups, in the order they run
LAUNCH_GROUPS = ("kernels", "main", "render", "stats", "fleet", "fields", "cells", "scaling", "nested", "claim",
                 "words")


if __name__ == "__main__":
    main()
