"""Run an example script in this process, as `python script.py args` would,
for tests/test_torch_examples*.py and chip_smoke.py's examples phase.

`run_example(path, *args)` executes the script through runpy as __main__
with `sys.argv` set and its own directory first on `sys.path` (the
examples import their common module from it), captures what it prints and
returns (stdout, the script's globals). The examples of both packages run
so: `examples/*.py` (the JAX package's) and `examples_torch/*.py` (the
port's; their common module is `_common_torch`, so the two never meet in
`sys.modules`)."""

from __future__ import annotations

import contextlib
import io
import runpy
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
EXAMPLES_TORCH = REPO / "examples_torch"
# every script of the JAX package's examples/ has its counterpart here
SCRIPTS = tuple(sorted(p.name for p in EXAMPLES.glob("*.py") if not p.name.startswith("_")))


def run_example(path, *args) -> tuple:
    """(stdout, globals) of `path` run with `args`; the script's exceptions
    propagate."""
    path = Path(path)
    argv, syspath = sys.argv, list(sys.path)
    sys.argv = [str(path), *map(str, args)]
    sys.path.insert(0, str(path.parent))
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            globs = runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = argv
        sys.path[:] = syspath
    return buf.getvalue(), globs


def overlay_live(stdout: str) -> list:
    """The live counts of the overlay lines `run()` prints every 60 frames."""
    return [int(line.split("live particles:")[1].split("|")[0]) for line in stdout.splitlines()
            if "live particles:" in line]


def lines_without_overlay(stdout: str) -> list:
    """The printed lines but the overlay's (which carry wall times)."""
    return [line for line in stdout.splitlines() if "live particles:" not in line]


# ---------------------------------------------------------------- on the card
# chip_smoke.py's examples phase: every script of examples_torch/ on the
# card, at its JAX counterpart's default frames, each under its own
# deadline and held to what its JAX counterpart prints or asserts.

# examples/one_shot.py's printout (600 frames): the ball is host numpy and
# the bursts' lifetime constant, so the port prints the same on any device
ONE_SHOT_LINES = [
    "frame 60: impact (impulse 10.0) -> burst slot 0",
    "frame 182: impact (impulse 10.0) -> burst slot 1",
    "frame 210: burst slot 0 finished -> despawned",
    "frame 304: impact (impulse 10.0) -> burst slot 0",
    "frame 332: burst slot 1 finished -> despawned",
    "frame 426: impact (impulse 10.0) -> burst slot 1",
    "frame 454: burst slot 0 finished -> despawned",
    "frame 548: impact (impulse 10.0) -> burst slot 0",
    "frame 576: burst slot 1 finished -> despawned",
    "end: live=20, active slots=[0]",
]
# examples/on_demand.py's clicks and end (240 frames; constant lifetime)
ON_DEMAND_LINES = [f"frame {f}: click -> queue_particles(1)" for f in range(0, 240, 30)] + ["end: live=1"]
PNG = b"\x89PNG\r\n\x1a\n"


@contextlib.contextmanager
def deadline(seconds: float, what: str):
    """Raise TimeoutError in the main thread once `seconds` have passed
    (SIGALRM; Python code is interrupted, a native call when it returns)."""
    import signal

    def expired(_sig, _frame):
        raise TimeoutError(f"{what}: past its deadline of {seconds} s")

    old = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _live(g):
    return g["scene"].alive_count()


def _pngs(out_dir, names):
    return all((Path(out_dir) / n).read_bytes()[:8] == PNG for n in names)


def card_checks(name, out, g, out_dir, require):
    """Hold one script's run on the card to what its JAX counterpart prints
    or asserts (`require(cond, msg)` raises); returns what the phase line
    reports of it (its live count and the numbers checked)."""
    from bevy_firework_tpu_torch import instances_to_bytes

    lines = out.splitlines()
    if name == "sparks.py":
        items = g["items"]
        require(len(items) == 1 and items[0].count == 750 == _live(g)
                and len(instances_to_bytes(items[0].instances)) == 750 * 64
                and lines[-1] == "render items: 1; instances: 750 x 64 B", f"sparks: {lines[-1]}")
        return {"live": _live(g), "instances": items[0].count}
    if name == "pbr.py":
        u = g["item"].uniform
        require((u.pbr, u.fade_scene) == (1, 3.5), f"pbr: uniform {u}")
        return {"live": _live(g), "uniform": str(u)}
    if name == "collision.py":
        low = float(g["ys"][g["over_floor"]].min())
        require(g["over_floor"].sum() > 0 and low >= -1e-4, f"collision: min y over the floor {low}")
        return {"live": _live(g), "over_floor": int(g["over_floor"].sum()), "min_y_over_floor": low}
    if name == "dynamic_colliders.py":
        r = g["readings"]
        require(len(r) == 4 and abs(r[0]) < 1e-3 and r[1] < -1.0 and abs(r[2]) < 1e-3 and abs(r[3] + 1.0) < 1e-3,
                f"dynamic_colliders: min y readings {r}")
        require(g["rebuilds"] == 0 and g["slot_reused"], f"dynamic_colliders: {lines[-1]}")
        return {"live": g["scene"].alive_count(), "min_y": r, "library_loads_in_edits": g["rebuilds"]}
    if name == "on_demand.py":
        got = [line for line in lines if "live particles:" not in line]
        require(got == ON_DEMAND_LINES and _live(g) == 1, f"on_demand: {got}")
        return {"live": _live(g), "clicks": len(got) - 1}
    if name == "one_shot.py":
        require(lines == ONE_SHOT_LINES, f"one_shot: {lines}")
        return {"live": g["fleet"].alive_count(), "impacts": sum("impact" in line for line in lines),
                "finished": sum("finished" in line for line in lines)}
    if name == "textures.py":
        per_type = [int((g["tys"] == t).sum()) for t in (0, 1)]
        require(min(per_type) > 0 and [i.type_index for i in g["scene"].render_items()] == [0, 1],
                f"textures: live per type {per_type}")
        return {"live": _live(g), "per_type": per_type}
    if name == "trails.py":
        require(g["n_seg"] > 0, f"trails: {lines[-1]}")
        return {"live": _live(g), "segments": g["n_seg"]}
    if name in ("stress_test.py", "stress_test_collision.py"):
        require(_live(g) > 100_000 and f"steady-state live: {_live(g)}" in out, f"{name}: {lines[-2:]}")
        return {"live": _live(g), "wall_ms_per_frame": g["wall"] / g["args"].frames * 1e3}
    if name == "force_fields.py":
        require(len(g["scene"]._field_slots) == 3 and _live(g) > 0, f"force_fields: {lines[-1]}")
        return {"live": _live(g)}
    if name == "fireworks.py":
        require(_live(g) > 0 and _pngs(out_dir, ["firework_showcase.png"]), f"fireworks: {lines[-1]}")
        return {"live": _live(g)}
    if name == "render_loop.py":
        rows, fid, live = g["final"]
        require(g["drawn"] > 0 and rows == live > 0 and f"dtype float{16 if g['f16'] else 32}" in out,
                f"{name} (f16={g['f16']}): drawn {g['drawn']}, final frame {fid}: {rows} rows, {live} live")
        return {"live": live, "drawn": g["drawn"], "final_frame": fid}
    if name == "web_viewer.py":
        last = g["frames"][-1]
        require(len(g["frames"]) == 90 and last[0]["count"] == _live(g) > 0
                and (Path(out_dir) / "web_viewer.html").stat().st_size > 0, f"web_viewer: {lines[-1]}")
        return {"live": _live(g)}
    if name == "webgpu_viewer.py":
        import dataclasses
        import json
        import re

        from bevy_firework_tpu_torch.shaders.specialize import ALPHA_BLEND, PipelineCache, key_for

        want = dataclasses.asdict(PipelineCache().specialize(key_for(ALPHA_BLEND, depth_prepass=True,
                                                                     shadow_map=True)))
        del want["key"]
        page = (Path(out_dir) / "webgpu_viewer.html").read_text()
        desc = json.loads(re.search(r"const DESC = (.*?);      // SpecializedPipeline", page).group(1))
        require(desc == json.loads(json.dumps(want)), "webgpu_viewer: DESC != PipelineCache's")
        return {"live": _live(g), "shader_defs": list(want["shader_defs"])}
    if name == "lights.py":
        require(_pngs(out_dir, ["lights.png", "lights_shadow.png", "lights_builtin.png", "lights_env.png"]),
                "lights: PNGs")
        return {"live": _live(g)}
    if name == "render_preview.py":
        require(_pngs(out_dir, [f"firework_{n}.png" for n in ("sparks", "collision", "textures")])
                and all(s.alive_count() > 0 for s, _cam in g["scenes"].values()), f"render_preview: {lines}")
        return {"live": {k: s.alive_count() for k, (s, _cam) in g["scenes"].items()}}
    if name == "multichip.py":
        import re

        sp = re.search(r"sp: (\d+) live .*?(\d+) shard launches; unsharded multi_step_auto: (\d+)\)", lines[1])
        nested = re.search(r"nested sp: (\d+) live (\[\d+, \d+\]) .*unsharded xla_step.multi_step: (\[\d+, \d+\])\)",
                           lines[4])
        require(lines[0] == "ranks: 4 x cuda (gloo)" and sp and int(sp.group(1)) == int(sp.group(3)) > 0
                and int(sp.group(2)) > 0 and nested and nested.group(2) == nested.group(3)
                and int(nested.group(1)) > 0, f"multichip: {lines}")
        return {"live": int(sp.group(1)), "rank0_shard_launches": int(sp.group(2)),
                "nested_live_per_type": nested.group(2)}
    raise KeyError(name)


# (script, its arguments, deadline in seconds, launch counters that must
# have counted) for run_on_card: every script at its JAX counterpart's
# default frames; render_loop once per record
CARD_RUNS = (
    ("sparks.py", (), 30, ("fused_step",)),
    ("on_demand.py", (), 30, ("fused_step",)),
    ("pbr.py", (), 30, ("fused_step",)),
    ("collision.py", (), 30, ("collide",)),
    ("textures.py", (), 60, ("nested_stage", "merge", "collide")),
    ("stress_test.py", (), 30, ("fused_step",)),
    ("stress_test_collision.py", (), 30, ("collide",)),
    ("force_fields.py", (), 30, ("fields",)),
    ("trails.py", (), 30, ("fused_step",)),
    ("fireworks.py", (), 60, ("nested_stage", "merge")),
    ("one_shot.py", (), 60, ("fleet",)),
    ("dynamic_colliders.py", (), 30, ("collide",)),
    ("render_loop.py", (), 30, ("render",)),
    ("render_loop.py", ("--f16",), 30, ("render_f16",)),
    ("lights.py", (), 60, ("fused_step",)),
    ("render_preview.py", (), 60, ("fused_step", "collide", "nested_stage")),
    ("web_viewer.py", (), 30, ("fused_step",)),
    ("webgpu_viewer.py", (), 30, ("fused_step",)),
    ("multichip.py", (), 150, ()),  # its ranks launch in their own processes
)


def run_on_card(out_dir, counted, require) -> dict:
    """Every CARD_RUNS script on the card in this process, files under
    `out_dir`: `counted(fn)` returns (fn(), {counter: launches}) with the
    kernels' launch counters set to 0 just before; each run under its
    deadline, held by card_checks, and the counters it needs counted.
    Returns per run its seconds, what card_checks reports and its nonzero
    launch counts."""
    res = {}
    for name, args, seconds, need in CARD_RUNS:
        label = " ".join((name, *map(str, args)))
        t0 = time.perf_counter()
        with deadline(seconds, f"examples {label}"):
            (out, g), counts = counted(lambda: run_example(EXAMPLES_TORCH / name, "--out", out_dir, *args))
            facts = card_checks(name, out, g, out_dir, require)
        launched = {k: v for k, v in counts.items() if v}
        require(all(counts.get(k, 0) > 0 for k in need), f"examples {label}: launches {launched}")
        res[label] = {"seconds": time.perf_counter() - t0, **facts, "launches": launched}
    return res


def card_profile(trace_dir, require) -> dict:
    """utils.profiling on the card: `trace` around 30 frames of the sparks
    scene (each in an `annotate` span, one step kernel launch each, counted
    by the wrapper or by the Scene's graph replays) writes a Chrome trace that holds the 30 spans and the
    step kernel's launches (CUPTI may drop some launch records of a trace,
    as chip_smoke's device_ms finds; the count in the trace is reported);
    `device_memory_stats` reports the card's allocated bytes."""
    import json

    import torch

    import bevy_firework_tpu_torch as bt
    from bevy_firework_tpu_torch.models import effects
    from bevy_firework_tpu_torch.ops import chain_graph
    from bevy_firework_tpu_torch.ops.fused_step import fused_step
    from bevy_firework_tpu_torch.utils import profiling

    def run():  # step launches made: one by one, and by the Scene's graph replays
        key = "fused_step.launches"
        return fused_step.launches - chain_graph.CAPTURED.get(key, 0) + chain_graph.REPLAYED.get(key, 0)

    spawner, tf = effects.sparks()
    scene = bt.Scene()
    scene.add_spawner(spawner, capacity=2048, transform=tf)
    for _ in range(60):
        scene.step(1 / 60)
    torch.cuda.synchronize()
    launches = run()
    with profiling.trace(str(trace_dir)):
        for _ in range(30):
            with profiling.annotate("examples.sparks.step"):
                scene.step(1 / 60)
        torch.cuda.synchronize()
    launches = run() - launches
    (path,) = Path(trace_dir).glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "fused_step_kernel" in e.get("name", "")]
    spans = [e for e in events if e.get("name") == "examples.sparks.step" and e.get("cat") == "user_annotation"]
    stats = profiling.device_memory_stats()
    allocated = stats[f"cuda:{torch.cuda.current_device()}"]["allocated_bytes.all.current"]
    require(launches == 30 and 0 < len(kernels) <= 30 and len(spans) == 30 and allocated > 0,
            f"profiling: {launches} step launches, {len(kernels)} in the trace, {len(spans)} spans, {allocated} bytes "
            f"allocated")
    return {"step_launches": launches, "step_kernels_in_trace": len(kernels),
            "kernel_names": sorted({e["name"] for e in kernels}),
            "annotate_spans": len(spans), "trace_bytes": path.stat().st_size, "allocated_bytes": allocated,
            "live": scene.alive_count()}
