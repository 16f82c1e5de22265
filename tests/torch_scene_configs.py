"""Scene configurations for the captured scene step and the checks shared by
the port's card tests and chip_smoke.py (imports torch and the port only,
so the card's tests and chip_smoke can use it without JAX).

`build(name, device, size)` makes one cell: a Scene and the edits its
script makes before each step, at the test size ("test": small pools,
short scripts) or the card size ("card": the reference examples' and
bench.py's settings). The cells are the sparks flow (the render pack
turned on mid-run), the events scene (a destroy-on-collision group with a
handler, sync and async), the tornado (its fields moved every frame), a
trailed group of comets beside a solo comet, bench.py's scene_batch_12 and
scene_hetero_100 (in combined and in per-group mode) and group_churn_12
(one member out and one in per frame).

`run_pair` steps two scenes of a cell built alike, one captured (the
default) and one with `Scene._captured = False`, through the cell's
script, and holds them equal: the destroyed records each step delivers,
the finished events, and at checkpoints every spawner's pool, outputs,
render planes, trail and render rows, bit for bit. It counts the
captured scene's graph captures and replays (a signature's first step
uncaptured, then one replay per step in combined mode, one per group in
per-group mode, where the groups are captured one a step; a capture is
followed by its replay) and the launches its steps made, one by one (none
in a step that replays) and in replays.
`time_steps` times Scene.step in interleaved windows, `churn_storm` is
bench.py's `_measure_churn_storm` on the port's Scene.

Run as a script, it times the cells and churn_storm on the card for the
package on the path and prints one JSON object (the A/B of two trees:
one process per tree, in turns):
    PYTHONPATH=<tree> python tests/torch_scene_configs.py [--label NAME] [--out FILE]
with --label, the Scene as that tree steps it, under that name; without,
the Scene captured and uncaptured."""

import collections
import dataclasses
import gc
import itertools
import math
import time

import numpy as np
import torch

import bevy_firework_tpu_torch as bt
from bevy_firework_tpu_torch.models import effects, library
from bevy_firework_tpu_torch.ops import chain_graph
from bevy_firework_tpu_torch.ops import fused_step as fs
from bevy_firework_tpu_torch.pool import POOL_FIELDS
from bevy_firework_tpu_torch.settings import (
    EmissionMode,
    EmissionPacing,
    EmissionSettings,
    EmissionShape,
    ParticleCollisionSettings,
    ParticleEventHandlers,
    ParticleSettings,
    ParticleSpawner,
)
from bevy_firework_tpu_torch.trails import TRAIL_FIELDS, TrailSettings

DT = 1 / 60
CHURN_FROM = 2  # group_churn_12's first churn frame
CELLS = ("sparks", "events", "events_async", "tornado", "trails", "scene_batch_12", "scene_hetero_100",
         "scene_hetero_100_per_group", "group_churn_12")
# frames of each cell's script (card, test)
FRAMES = {"sparks": (150, 40), "events": (100, 80), "events_async": (100, 80), "tornado": (120, 30),
          "trails": (80, 30), "scene_batch_12": (40, 12), "scene_hetero_100": (30, 8),
          "scene_hetero_100_per_group": (30, 8), "group_churn_12": (40, 16)}


@dataclasses.dataclass
class Cell:
    name: str
    scene: object
    edit: object  # edit(scene, frame) before each step
    records: list  # per step: the destroyed records delivered (their count) and the finished sids, in order
    frames: int
    log: list  # the events delivered since the last edit


def _sparks2k():
    return effects.sparks(rate=2000.0)[0]


def hetero_archetypes() -> list:
    """bench.py's scene_hetero_100 archetypes: sparks at 2000/s, pbr smoke
    at 800/s, a bouncing archetype and sparks of random lifetime."""
    sparks2k = _sparks2k()
    pbr = effects.pbr()[0]
    smoke = dataclasses.replace(pbr, emission_settings=tuple(
        dataclasses.replace(e, emission_pacing=EmissionPacing.rate(800.0)) for e in pbr.emission_settings))
    bouncy = ParticleSpawner(
        particle_settings=[ParticleSettings(lifetime=bt.RandF32.constant(2.0), collision_settings=(
            ParticleCollisionSettings(restitution=0.6, friction=0.2)))],
        emission_settings=[EmissionSettings(emission_pacing=EmissionPacing.rate(500.0), initial_velocity=(
            bt.RandVec3(magnitude=bt.RandF32(2.0, 5.0), direction=(0, 1, 0), spread=0.6)))])
    randlife = dataclasses.replace(sparks2k, particle_settings=tuple(
        dataclasses.replace(p, lifetime=bt.RandF32(0.5, 1.5)) for p in sparks2k.particle_settings))
    return [sparks2k, smoke, bouncy, randlife]


def events_spawner(handler):
    """bench.py's events_dump_overhead spawner: 3000/s upward, destroyed on
    the floor, with a particles_destroyed handler."""
    return ParticleSpawner(
        particle_settings=[ParticleSettings(
            lifetime=bt.RandF32.constant(1.0),
            collision_settings=ParticleCollisionSettings(restitution=0.0, friction=0.0, destroy_on_collision=True),
            event_handlers=ParticleEventHandlers(particles_destroyed=handler))],
        emission_settings=[EmissionSettings(
            emission_pacing=EmissionPacing.rate(3000.0),
            initial_velocity=bt.RandVec3(magnitude=bt.RandF32(2.0, 5.0), direction=(0, 1, 0), spread=0.7))])


def _wander(f):
    return 0.8 * math.sin(f * 0.02), 0.8 * math.cos(f * 0.017)


def build(name: str, device, size: str = "card", observe: bool = True, **scene_kw) -> Cell:
    """One cell's Scene on `device` and its script; observe: an on_finished
    observer on every spawner the cell starts with (each step then reads
    the finished flags)."""
    card = size == "card"
    cap = 8192 if card else 1024
    frames = FRAMES[name][0 if card else 1]
    records: list = []
    step_log: list = []

    def none(sc, f):
        pass

    def render_on_at(k):
        def edit(sc, f):
            if f == k:
                sc.render_items()  # the render pack on from the next step: a new signature
        return edit

    if name == "sparks":
        sc = bt.Scene(device=device, **scene_kw)
        sc.add_spawner(effects.sparks()[0], capacity=2048)
        edit = render_on_at(frames // 2)
    elif name in ("events", "events_async"):
        sc = bt.Scene(colliders=[bt.Collider.halfspace(position=(0.0, -1.0, 0.0))], device=device, **scene_kw)
        sp = events_spawner(lambda rs: step_log.append(len(rs)))
        for i in range(4):
            sc.add_spawner(sp, capacity=cap, transform=bt.Transform(translation=(float(i), 0.0, 0.0)))
        if name == "events_async":
            sc.enable_async_events()
        edit = none
    elif name == "tornado":
        from bevy_firework_tpu_torch.profile_step import tornado_fields

        sc = bt.Scene(force_fields=tornado_fields(), device=device, **scene_kw)
        sc.add_spawner(library.dust(updraft=2.5, drag=2.0, emit_radius=1.2), capacity=cap)

        def edit(sc, f):
            x, z = _wander(f)
            sc.set_force_field(0, position=(x, 0.0, z))
            sc.set_force_field(1, position=(x, 0.0, z))
    elif name == "trails":
        sc = bt.Scene(device=device, **scene_kw)
        ts = TrailSettings(length=16, width=0.8)
        for i in range(4):
            sc.add_spawner(library.comets(), capacity=256, trail=ts,
                           transform=bt.Transform(translation=(float(i), 0.0, 0.0)))
        sc.add_spawner(library.comets(rate=9.0), capacity=512, trail=TrailSettings(length=8, width=0.5))
        edit = render_on_at(frames // 3)
    elif name == "scene_batch_12":
        sc = bt.Scene(device=device, **scene_kw)
        for i in range(12):
            sc.add_spawner(effects.sparks(rate=6000.0)[0], capacity=cap,
                           transform=bt.Transform(translation=(float(i), 0.0, 0.0)))
        edit = render_on_at(frames // 4)
    elif name in ("scene_hetero_100", "scene_hetero_100_per_group"):
        if name.endswith("per_group"):
            scene_kw = dict(scene_kw, combined_signature_limit=0)  # per-group mode from the first step
        sc = bt.Scene(colliders=[bt.Collider.halfspace(position=(0.0, -1.0, 0.0))], device=device, **scene_kw)
        arch = hetero_archetypes()
        for i in range(100):
            sc.add_spawner(arch[i % 4], capacity=cap,
                           transform=bt.Transform(translation=(float(i % 10), 0.0, float(i // 10))))
        edit = render_on_at(frames // 3)
    elif name == "group_churn_12":
        sc = bt.Scene(device=device, **scene_kw)
        sp = effects.sparks(rate=6000.0)[0]
        for i in range(12):
            sc.add_spawner(sp, capacity=cap, transform=bt.Transform(translation=(float(i), 0.0, 0.0)))

        def edit(sc, f):
            if f >= 2:  # one member out, a new one in (its hole), every frame
                sc.remove_spawner(min(sc._spawners))
                sc.add_spawner(sp, capacity=cap, transform=bt.Transform(translation=(float(100 + f), 0.0, 0.0)))
    else:
        raise ValueError(f"no scene cell {name!r}; the cells are {CELLS}")

    if observe:
        for sid in list(sc._spawners):
            sc.on_finished(sid, lambda s: step_log.append(("finished", s)))

    def logged_edit(sc_, f):
        edit(sc_, f)
        records.append(list(step_log))
        step_log.clear()

    return Cell(name, sc, logged_edit, records, frames, step_log)


# ---------------------------------------------------------------------------
# the captured scene against the uncaptured one
# ---------------------------------------------------------------------------


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().cpu()
    if t.dtype.is_floating_point:
        return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)
    return t


def assert_same_tensor(a, b, label):
    if a is None or b is None:
        assert a is None and b is None, f"{label}: one is None"
        return
    assert a.shape == b.shape and a.dtype == b.dtype, f"{label}: {a.shape} {a.dtype} against {b.shape} {b.dtype}"
    assert torch.equal(_bits(a), _bits(b)), f"{label}: differs"


def assert_scenes_equal(a, b, label: str) -> int:
    """Every spawner of two scenes equal bit for bit: pool leaves, outputs,
    render planes, trail, alive count; and their render rows. Returns the
    leaves compared."""
    assert list(a._spawners) == list(b._spawners), f"{label}: spawner ids differ"
    n = 0
    for sid in a._spawners:
        x, y = a._spawners[sid], b._spawners[sid]
        for k in POOL_FIELDS:
            assert_same_tensor(getattr(x.state, k), getattr(y.state, k), f"{label} sid {sid} {k}")
            n += 1
        if x.outputs is not None or y.outputs is not None:
            for f in dataclasses.fields(x.outputs):
                assert_same_tensor(getattr(x.outputs, f.name), getattr(y.outputs, f.name),
                                   f"{label} sid {sid} outputs.{f.name}")
                n += 1
        px, py = x.render_planes, y.render_planes
        assert (px is None) == (py is None), f"{label} sid {sid}: render planes on one side"
        for i, (p, q) in enumerate(zip(px or (), py or ())):
            assert_same_tensor(p, q, f"{label} sid {sid} plane {i}")
            n += 1
        if x.trail_settings is not None:
            for k in TRAIL_FIELDS:
                assert_same_tensor(getattr(x.trail_state, k), getattr(y.trail_state, k), f"{label} sid {sid} trail {k}")
                n += 1
    assert a.alive_count() == b.alive_count(), f"{label}: alive counts differ"
    return n


def assert_render_equal(a, b, label: str) -> int:
    """render_items of two scenes: the same items, their rows byte for byte
    (turns the render pack on in both)."""
    ia, ib = a.render_items(), b.render_items()
    assert [(i.spawner_id, i.type_index, i.count) for i in ia] == [(i.spawner_id, i.type_index, i.count) for i in ib], \
        f"{label}: render items differ"
    for x, y in zip(ia, ib):
        assert bt.instances_to_bytes(x.instances) == bt.instances_to_bytes(y.instances), \
            f"{label}: rows of sid {x.spawner_id} differ"
    return sum(i.count for i in ia)


def padding_rows_dead(sc) -> int:
    """In every padded group batch of a scene, the padding rows (rows no
    member holds whose emitters are all disabled) hold no live lane and are
    nobody's; returns how many were checked."""
    n = 0
    for batch in sc._batches.values():
        if batch.pad is None:
            continue
        for r in set(range(batch.pad)) - set(batch.rows):
            if not bool(batch.states.enabled[r].any()):
                assert not bool(batch.states.alive[r].any()), f"padding row {r} holds live lanes"
                n += 1
    owners = [s._batch for s in sc._spawners.values() if s._batch is not None]
    assert len({(id(b), r) for b, r in owners}) == len(owners), "two members on one row"
    return n


def counted_step(step) -> tuple[dict, dict]:
    """step() and the launches it made, by launch counter
    (`fused_step.LAUNCH_COUNTERS`): those launched one by one (not those a
    capture recorded without running them, `chain_graph.CAPTURED`), and
    those its graph replays ran (`chain_graph.REPLAYED`). Only what step()
    made counts."""
    before, cap0, rep0 = fs.launch_counts(), dict(chain_graph.CAPTURED), dict(chain_graph.REPLAYED)
    step()
    after = fs.launch_counts()
    one_by_one = {k: after[k] - before[k] - (chain_graph.CAPTURED.get(k, 0) - cap0.get(k, 0)) for k in after}
    replayed = {k: v - rep0.get(k, 0) for k, v in chain_graph.REPLAYED.items()}
    return {k: v for k, v in one_by_one.items() if v}, {k: v for k, v in replayed.items() if v}


def _add_to(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _graph_bytes() -> int:
    return sum(getattr(g, "nbytes", 0) for g in chain_graph._GRAPHS.values())


def scene_pool_bytes(sc) -> int:
    """The device bytes of a scene's pools: each group batch once, each
    spawner stepping alone its own."""
    held = [b.states for b in sc._batches.values()]
    held += [s.state for s in sc._spawners.values() if s._batch is None]
    return sum(getattr(st, k).nbytes for st in held for k in POOL_FIELDS if getattr(st, k).device.type == "cuda")


def run_pair(name: str, device, size: str = "card") -> dict:
    """The cell's script through a captured and an uncaptured Scene (see the
    module docstring); returns the captured scene's counts (`launches`:
    what its steps ran, one by one and in replays, by launch counter;
    `replayed`: those in replays), the checks' sizes and, on the card, the
    device memory with both scenes and the graphs held. Drops every graph
    first (`chain_graph.clear`)."""
    chain_graph.clear()
    a, b = build(name, device, size), build(name, device, size)
    b.scene._captured = False
    per_group = a.scene._combined_limit == 0
    checkpoints = {0, 1, a.frames // 2, a.frames - 1}
    c0, r0 = chain_graph.COUNTS["captures"], chain_graph.COUNTS["replays"]
    replay_steps = uncaptured_in_replays = leaves = 0
    uncaptured_steps, capture_frames, packs = [], [], []
    launches: dict = {}
    replayed: dict = {}
    for f in range(a.frames):
        for cell in (a, b):
            cell.edit(cell.scene, f)
        packs.append(bool(a.scene._render_demand or a.scene._async_enabled))
        caps, reps = chain_graph.COUNTS["captures"], chain_graph.COUNTS["replays"]
        one_by_one, in_replays = counted_step(lambda: a.scene.step(DT))
        _add_to(launches, one_by_one)
        _add_to(launches, in_replays)
        _add_to(replayed, in_replays)
        b.scene.step(DT)
        groups = a.scene._last_step_dispatches
        assert groups == b.scene._last_step_dispatches, f"{name} frame {f}: dispatch groups differ"
        n_caps = chain_graph.COUNTS["captures"] - caps
        n_reps = chain_graph.COUNTS["replays"] - reps
        full = groups if per_group else 1
        assert n_reps <= full and n_caps <= min(n_reps, 1), \
            f"{name} frame {f}: {n_caps} captures and {n_reps} replays for {groups} groups"
        if n_reps == full:  # a step that replays runs no launch one by one
            replay_steps += 1
            uncaptured_in_replays += sum(one_by_one.values())
        else:
            uncaptured_steps.append(f)
        if n_caps:
            capture_frames.append(f)
        assert a.records[-1] == b.records[-1], f"{name} frame {f}: events {a.records[-1]} against {b.records[-1]}"
        if f in checkpoints:
            if a.scene._async_events:
                a.scene.flush_events()
                b.scene.flush_events()
            leaves += assert_scenes_equal(a.scene, b.scene, f"{name} frame {f}")
    if a.scene._async_events:
        a.scene.flush_events()
        b.scene.flush_events()
    assert a.log == b.log, f"{name}: the last events differ"
    rows = assert_render_equal(a.scene, b.scene, name)
    items = a.scene.render_items()
    assert {i.spawner_id for i in items} <= set(a.scene._spawners), f"{name}: an item of no member"
    padding = padding_rows_dead(a.scene)
    assert a.scene._per_group_mode == per_group, f"{name}: per-group mode {a.scene._per_group_mode}"
    # not all replayed: each signature's first step only; per group (whose
    # keys change with the pack flag alone here) each flag's first step and
    # the steps its groups wait for their capture, one a step, while the
    # flag lasts
    runs = [len(list(g)) for _k, g in itertools.groupby(packs)]
    met = sum(min(groups, n) for n in runs) if per_group else len(a.scene._combined_signatures)
    assert len(uncaptured_steps) == met, f"{name}: steps {uncaptured_steps} not all replayed for {met}"
    memory = {}
    if torch.device(device).type == "cuda":
        memory = {"graph_bytes": _graph_bytes(), "scene_pool_bytes": scene_pool_bytes(a.scene),
                  "memory_allocated": torch.cuda.memory_allocated(device),
                  "max_memory_reserved": torch.cuda.max_memory_reserved(device)}
    return {"frames": a.frames, "captures": chain_graph.COUNTS["captures"] - c0,
            "replays": chain_graph.COUNTS["replays"] - r0, "replay_steps": replay_steps,
            "uncaptured_steps": uncaptured_steps, "capture_frames": capture_frames,
            "uncaptured_launches_in_replay_steps": uncaptured_in_replays, "launches": launches,
            "replayed": replayed, "memory": memory, "leaves_compared": leaves, "render_rows": rows,
            "padding_rows_checked": padding,
            "records": sum(len([r for r in rs if not isinstance(r, tuple)]) for rs in a.records),
            "finished": sum(len([r for r in rs if isinstance(r, tuple)]) for rs in a.records),
            "groups": a.scene._last_step_dispatches, "spawners": len(a.scene._spawners),
            "live": a.scene.alive_count(), "per_group_mode": a.scene._per_group_mode}


def steady_no_sync(device, size: str = "card", steps: int = 10) -> int:
    """scene_batch_12 (no observer, no handler) warmed up, then `steps`
    steady steps under torch.cuda.set_sync_debug_mode("error"): a step
    that replays makes no host sync. Returns the steps run."""
    cell = build("scene_batch_12", device, size)
    for sid in cell.scene._spawners:
        cell.scene._spawners[sid].finished_observers.clear()
    for f in range(3):
        cell.scene.step(DT)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(steps):
            cell.scene.step(DT)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return steps


# ---------------------------------------------------------------------------
# churn_storm: bench.py's `_measure_churn_storm` (:670) on the port's Scene
# ---------------------------------------------------------------------------


def storm_rotation() -> list:
    """The six structurally distinct archetypes bench.py rotates."""
    sparks = effects.sparks(rate=3000.0)[0]
    randlife = dataclasses.replace(sparks, particle_settings=tuple(
        dataclasses.replace(p, lifetime=bt.RandF32(0.4, 1.2)) for p in sparks.particle_settings))
    bouncy = hetero_archetypes()[2]
    twoemit = ParticleSpawner(
        particle_settings=[ParticleSettings(lifetime=bt.RandF32.constant(1.0))],
        emission_settings=[EmissionSettings(emission_pacing=EmissionPacing.rate(1000.0),
                                            emission_shape=EmissionShape.sphere(0.5)),
                           EmissionSettings(emission_pacing=EmissionPacing.rate(500.0))])
    burst = ParticleSpawner(
        particle_settings=[ParticleSettings(lifetime=bt.RandF32.constant(1.5))],
        emission_settings=[EmissionSettings(emission_pacing=EmissionPacing.one_shot(300))])
    nested = ParticleSpawner(
        particle_settings=[ParticleSettings(lifetime=bt.RandF32.constant(1.2)),
                           ParticleSettings(lifetime=bt.RandF32.constant(0.6))],
        emission_settings=[
            EmissionSettings(particle_index=0, emission_pacing=EmissionPacing.rate(800.0)),
            EmissionSettings(particle_index=1, emission_mode=EmissionMode.nested(0),
                             emission_pacing=EmissionPacing.count_over_duration(4.0, 1.0, 0.0, 1.0))])
    return [sparks, randlife, bouncy, twoemit, burst, nested]


def churn_storm(device, n_frames: int = 60, capacity: int = 8192, **seams) -> dict:
    """Every frame a spawner of the rotating six archetypes is added (the
    oldest removed beyond 12 live) and the scene steps; each frame's
    enqueue wall by host clock, no fence (captures and the uncaptured
    first steps of signatures land in it), then 20 frames of settled churn
    between two fences. Reports the worst, p90 and median frames, the
    hitches (frames over 5x the median), the worst frame of the second
    half, the captures (and the frames that made them), the worst frame's
    collector ms and device allocations and frees, the settled
    frames' captures, replays and launches one by one, whether the scene
    crossed its signature limit and,
    on the card, the device memory after it with its graphs held. seams:
    Scene attributes set before the first step (`_captured=False`,
    `_padded=False`)."""
    rotation = storm_rotation()
    sc = bt.Scene(colliders=[bt.Collider.halfspace(position=(0.0, -1.0, 0.0))], device=device)
    for k, v in seams.items():
        setattr(sc, k, v)
    live, walls = [], []
    c0, s0 = chain_graph.COUNTS["captures"], chain_graph.COUNTS["capture_s"]
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    sync()
    capture_frames, detail = {}, []
    gc_ms, gc_t0 = [0.0], [0.0]

    def on_gc(phase, _info):  # the collector's time inside each frame
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - gc_t0[0]) * 1e3

    def device_counts():  # the caching allocator's device allocations, frees and retries
        if not on_card:
            return {}
        st = torch.cuda.memory_stats(device)
        return {k: st.get(k, 0) for k in ("num_device_alloc", "num_device_free", "num_alloc_retries")}

    gc.callbacks.append(on_gc)
    try:
        for k in range(n_frames):
            live.append(sc.add_spawner(rotation[k % len(rotation)], capacity=capacity,
                                       transform=bt.Transform(translation=(float(k % 8), 0.0, float(k // 8)))))
            if len(live) > 12:
                sc.remove_spawner(live.pop(0))
            caps, gc0, dev0 = chain_graph.COUNTS["captures"], gc_ms[0], device_counts()
            t0 = time.perf_counter()
            sc.step(DT)
            walls.append((time.perf_counter() - t0) * 1e3)
            dev1 = device_counts()
            detail.append({"gc_ms": gc_ms[0] - gc0, **{k: dev1[k] - dev0[k] for k in dev1}})
            if chain_graph.COUNTS["captures"] > caps:
                capture_frames[k] = chain_graph.COUNTS["captures"] - caps
    finally:
        gc.callbacks.remove(on_gc)
    sync()
    caps, reps, launched = chain_graph.COUNTS["captures"], chain_graph.COUNTS["replays"], fs.launch_counts()
    recorded = sum(chain_graph.CAPTURED.values())
    t0 = time.perf_counter()
    for k in range(n_frames, n_frames + 20):
        live.append(sc.add_spawner(rotation[k % len(rotation)], capacity=capacity,
                                   transform=bt.Transform(translation=(float(k % 8), 0.0, float(k // 8)))))
        sc.remove_spawner(live.pop(0))
        sc.step(DT)
    sync()
    settled = (time.perf_counter() - t0) / 20 * 1e3
    settled_counts = {"captures": chain_graph.COUNTS["captures"] - caps,
                      "replays": chain_graph.COUNTS["replays"] - reps,
                      "launched_one_by_one": sum(v - launched[k] for k, v in fs.launch_counts().items())
                      - (sum(chain_graph.CAPTURED.values()) - recorded)}
    w = np.asarray(walls)
    med = float(np.median(w))
    worst = int(w.argmax())
    memory = {}
    if on_card:
        memory = {"graph_bytes": _graph_bytes(), "scene_pool_bytes": scene_pool_bytes(sc),
                  "memory_allocated": torch.cuda.memory_allocated(device),
                  "max_memory_allocated": torch.cuda.max_memory_allocated(device),
                  "max_memory_reserved": torch.cuda.max_memory_reserved(device)}
    return {"frames": n_frames, "capacity": capacity, "archetypes_rotated": len(rotation), "live_spawners": len(live),
            "seams": seams, "worst_ms": float(w.max()), "p90_ms": float(np.percentile(w, 90)),
            "median_ms": med, "hitches_gt_5x_median": int((w > 5 * max(med, 1e-6)).sum()),
            "second_half_worst_ms": float(w[len(w) // 2:].max()), "settled_churn_ms": settled,
            "captures": chain_graph.COUNTS["captures"] - c0, "capture_s": chain_graph.COUNTS["capture_s"] - s0,
            "capture_frames": capture_frames, "worst_frame": {"frame": worst, **detail[worst]},
            "gc_ms_in_frames": sum(d["gc_ms"] for d in detail), "settled": settled_counts,
            "graphs_held": len(chain_graph._GRAPHS),
            "scene_signatures": len(getattr(sc, "_combined_signatures", ())),
            "per_group_mode": getattr(sc, "_per_group_mode", None), "memory": memory, "walls_ms": walls}


# ---------------------------------------------------------------------------
# ms per Scene.step in interleaved windows, and the A/B of two trees
# ---------------------------------------------------------------------------


def time_steps(name: str, device, modes: dict, windows: int = 3, steps: int = 40, churn: bool = True) -> tuple:
    """ms per Scene.step of the cell's scene (no observers) in each mode
    (label: Scene attributes set on it, e.g. {"captured": {},
    "uncaptured": {"_captured": False}}), after the cell's whole script
    once (signatures met and captured, the render pack on): interleaved
    windows of `steps` steps, each between two synchronizes, the modes'
    order reversed every other window; churn=False steps without the
    cell's edits. Returns ({label: median window ms, "windows": {label:
    [ms]}, "groups", "spawners", "per_group_mode"}, {label: Scene})."""
    cells = {}
    for label, seams in modes.items():
        cells[label] = build(name, device, "card", observe=False)
        for k, v in seams.items():
            setattr(cells[label].scene, k, v)
    for f in range(FRAMES[name][0]):
        for c in cells.values():
            c.edit(c.scene, f)
            c.scene.step(DT)
    frame = [FRAMES[name][0]]
    got = {label: [] for label in modes}
    order = list(modes)
    for w in range(windows):
        for label in (order if w % 2 == 0 else order[::-1]):
            c = cells[label]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for k in range(steps):
                if churn:
                    c.edit(c.scene, frame[0] + k)
                c.scene.step(DT)
            torch.cuda.synchronize()
            got[label].append((time.perf_counter() - t0) / steps * 1e3)
        frame[0] += steps
    first = cells[order[0]].scene
    row = {label: float(np.median(v)) for label, v in got.items()}
    row.update(windows=got, groups=first._last_step_dispatches, spawners=len(first._spawners),
               per_group_mode=getattr(first, "_per_group_mode", None))
    return row, {label: c.scene for label, c in cells.items()}


def cyclic_garbage() -> dict:
    """The cyclic garbage the process holds now: the objects a collection
    finds, their commonest types, and the ms a collection then takes to
    free them."""
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        found = gc.collect()
    finally:
        gc.set_debug(0)
    types = collections.Counter(type(o).__name__ for o in gc.garbage).most_common(8)
    gc.garbage.clear()
    t0 = time.perf_counter()
    gc.collect()
    return {"objects": found, "types": types, "free_ms": (time.perf_counter() - t0) * 1e3}


TIMED = ("sparks", "events", "tornado", "scene_batch_12", "scene_hetero_100", "scene_hetero_100_per_group")


def main(argv=None) -> dict:
    """The script's run (see the module docstring)."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default=None, help="one mode: the Scene as the tree on the path steps it")
    ap.add_argument("--out", default=None, help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the Scene's timings are taken on the card")
    dev = torch.device("cuda")
    modes = {args.label: {}} if args.label else {"captured": {}, "uncaptured": {"_captured": False}}
    out = {"modes": list(modes), "ms_per_scene_step": {}, "churn_storm": {}}
    for name in TIMED:
        out["ms_per_scene_step"][name], _ = time_steps(name, dev, modes)
        chain_graph.clear()
    out["ms_per_scene_step"]["group_churn_12_churn"], _ = time_steps("group_churn_12", dev, modes)
    out["ms_per_scene_step"]["group_churn_12_steady"], _ = time_steps("group_churn_12", dev, modes, churn=False)
    chain_graph.clear()
    out["garbage_before_storms"] = cyclic_garbage()  # what the timed cells left
    for again in ("", "_again"):  # each mode's storm twice, in turns: a process's first-time costs show apart
        for label, seams in modes.items():
            chain_graph.clear()
            out["churn_storm"][label + again] = churn_storm(dev, **seams)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh)
    return out


if __name__ == "__main__":
    main()
