"""Captured-chain configurations and the check shared by the port's card
tests and chip_smoke.py (imports torch and the port only, so the card's
tests and chip_smoke can use it without JAX).

`build(name, device, size)` makes one chain case: the entry point, the
archetype, its colliders, a pool and two frame inputs (the second with
another dt and transform) at the test size ("test": small pools, short
chains) or the card size ("card": bench.py's cells). `check_captured`
steps the case through its entry point on the card, captured and with
`_captured=False`, and holds every leaf of the results (pool, key,
outputs, render planes) bit for bit: the first call, a replay from the
first call's state, a replay with the second frame, and a replay from the
first call's state again; the earlier results still hold their values
after the later calls, the caller's input is never written, and a
dead-rank chain's final alive plane carries the counts an uncaptured
chain leaves."""

import dataclasses

import torch

import bevy_firework_tpu_torch as pt
from bevy_firework_tpu_torch.models import effects, library
from bevy_firework_tpu_torch.ops import chain_graph
from bevy_firework_tpu_torch.ops import fused_step as fs
from bevy_firework_tpu_torch.parallel.sharding import stack_frames, stack_params, stack_pools
from bevy_firework_tpu_torch.profile_step import tornado_fields
from bevy_firework_tpu_torch.settings import EmissionPacing

import torch_fleet_configs as fleet_cfg
import torch_nested_configs as nested_cfg

# the cases: (the card size's label, its chain kind)
CASES = {"main": "main_100k", "main_1M": "main_1M", "collision": "collision_1M", "fields": "fields_1M",
         "destroy": "destroy", "packed": "main_100k packed", "nested_folded": "nested_60k folded",
         "nested_unfolded": "nested_60k unfolded", "nested_chained": "nested_chained",
         "nested_dead_rank": "nested dead-rank", "nested_packed": "nested_60k packed", "fleet": "fleet_16x55k",
         "fleet_destroy": "destroy fleet with a dump", "nested_fleet": "nested fleet, stacked params"}
TEST_CASES = ("main", "collision", "fields", "destroy", "packed", "nested_folded", "nested_unfolded",
              "nested_dead_rank", "nested_packed", "fleet", "fleet_destroy", "nested_fleet")


@dataclasses.dataclass
class Case:
    name: str
    kind: str  # chain_graph's kind: "auto", "auto_packed", "unfolded" or "fleet"
    static: object
    params: object
    colliders: object
    state: object
    frame: object
    frame2: object
    n: int


def _rated(spawner, rate):
    es = dataclasses.replace(spawner.emission_settings[0], emission_pacing=EmissionPacing.rate(float(rate)))
    return dataclasses.replace(spawner, emission_settings=(es,))


def build(name: str, device, size: str = "test") -> Case:
    """The chain case `name` (CASES) on `device` at `size` ("test" or
    "card")."""
    card = size == "card"
    dev = torch.device(device)
    cols = None
    ff = None
    kind = "auto"
    if name in ("main", "main_1M", "packed"):
        cap, rate, n = (1310720, 1e6, 140) if name == "main_1M" else (131072, 1e5, 140) if card else (16384, 1.2e4, 20)
        sp = _rated(effects.stress_test()[0], rate)
        kind = "auto_packed" if name == "packed" else "auto"
    elif name == "collision":
        cap, rate, n = (1310720, 5e5, 150) if card else (16384, 6e3, 12)
        sp = _rated(effects.stress_test_collision()[0], rate)
        cols = pt.compile_colliders(effects.stress_test_collision()[2], device=dev)
    elif name == "fields":
        cap, rate, n = (1310720, 3e5, 300) if card else (16384, 4e3, 16)
        sp = _rated(library.dust(rate=rate, lifetime=4.0, updraft=2.5, drag=2.0, emit_radius=1.2), rate)
        ff = tornado_fields()
    elif name == "destroy":
        cap, n = (131072, 30) if card else (16384, 12)
        sp = fleet_cfg.box_spawner(3e5 if card else 4e4, destroy=True)
        cols = pt.compile_colliders([pt.Collider.halfspace(position=(0.0, -0.8, 0.0)),
                                     pt.Collider.sphere(0.5, position=(-1.4, 0.6, 0.2))], device=dev)
    elif name in ("nested_folded", "nested_unfolded", "nested_chained", "nested_packed"):
        cap, n = (16 * 8192, 150) if card else (16384, 8)
        sp = nested_cfg.bench_nested(name == "nested_chained")
        kind = {"nested_unfolded": "unfolded", "nested_packed": "auto_packed"}.get(name, "auto")
    elif name == "nested_dead_rank":
        cap, n = (131072, 30) if card else (16384, 6)
        sp = nested_cfg.det_nested(destroy=True)
        cols = pt.compile_colliders(nested_cfg.DET_FLOOR, device=dev)
    elif name == "fleet":
        S, cap, n = (16, 8 * 8192, 140) if card else (4, 4096, 20)
        c = pt.compile_spawner(_rated(effects.stress_test()[0], 55_000.0 if card else 3e3), device=dev)
        pools = [pt.init_pool_for(c, cap, seed=i) for i in range(S)]
        frames = [pt.make_frame_input(1 / 60, translation=(float(i), 0.0, 0.0)) for i in range(S)]
        frames2 = [pt.make_frame_input(1 / 45, translation=(float(i), 0.5, 0.0)) for i in range(S)]
        return Case(name, "fleet", c.static, c.params, None, stack_pools(pools), stack_frames(frames),
                    stack_frames(frames2), n)
    elif name == "fleet_destroy":  # dead-rank claims (count + scan in the graph), the dump plane, colliders
        n_lanes, n = (131072, 30) if card else (4096, 12)
        static, params, col, pools, frames, _u, _p = fleet_cfg.build("destroy_dump", dev, n_lanes)
        frames2 = [dataclasses.replace(f, dt=torch.tensor(1 / 45, dtype=torch.float32)) for f in frames]
        return Case(name, "fleet", static, params, col, stack_pools(pools), stack_frames(frames),
                    stack_frames(frames2), n)
    elif name == "nested_fleet":  # hybrid frames slot by slot, each slot its own table of stacked params
        S, cap, n = (4, 32768, 60) if card else (3, 16384, 6)
        rates = [2000.0 * (1 + i) for i in range(S)]
        base = nested_cfg.bench_nested(False)
        cs = [pt.compile_spawner(dataclasses.replace(base, emission_settings=(dataclasses.replace(
            base.emission_settings[0], emission_pacing=EmissionPacing.rate(r)),) + tuple(base.emission_settings[1:])),
            nested_buffer=256, device=dev) for r in rates]
        pools = [pt.init_pool_for(c, cap, seed=i) for i, c in enumerate(cs)]
        frames = [pt.make_frame_input(1 / 60, translation=(float(i), 0.0, 0.0)) for i in range(S)]
        frames2 = [pt.make_frame_input(1 / 45, translation=(float(i), 0.3, 0.0)) for i in range(S)]
        return Case(name, "fleet", cs[0].static, stack_params([c.params for c in cs]), None, stack_pools(pools),
                    stack_frames(frames), stack_frames(frames2), n)
    else:
        raise ValueError(f"no chain case {name!r}")
    nb = {"nested_buffer": 1024 if card else 256} if name.startswith("nested") and name != "nested_dead_rank" else {}
    c = pt.compile_spawner(sp, device=dev, **nb)
    fields = None if ff is None else pt.compile_force_fields(ff, device=dev)
    frame = pt.make_frame_input(1 / 60, force_fields=fields)
    fields2 = None if ff is None else pt.compile_force_fields(tornado_fields(0.3, -0.2), device=dev)
    frame2 = pt.make_frame_input(1 / 45, translation=(0.2, 0.1, -0.3), rotation=(0.0, 0.0998, 0.0, 0.995),
                                 force_fields=fields2)
    return Case(name, kind, c.static, c.params, cols, pt.init_pool_for(c, cap, seed=3), frame, frame2, n)


def step_chain(case: Case, state, frame, captured: bool):
    """The case's chain from `state` under `frame`, captured or not, under
    sync debug mode "error" (no call of a chain waits for the card)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return _step_chain(case, state, frame, captured)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _step_chain(case: Case, state, frame, captured: bool):
    if case.kind == "unfolded":
        if captured:
            return chain_graph.replay("unfolded", case.static, case.params, case.colliders, state, frame, case.n)
        return fs.chain_hybrid_unfolded(case.static, case.params, case.colliders, state, frame, case.n)
    fn = {"auto": fs.multi_step_auto, "auto_packed": fs.multi_step_auto_packed,
          "fleet": fs.multi_step_fleet_stacked}[case.kind]
    return fn(case.static, case.params, case.colliders, state, frame, case.n, _captured=captured)


def leaves(result) -> list:
    out: list = []
    chain_graph._flatten(result, out)
    return out


def assert_results_equal(a, b, label: str) -> None:
    """Every leaf of two chain results equal bit for bit (f32 compared by
    their bits: NaN payloads and -0 too)."""
    la, lb = leaves(a), leaves(b)
    if len(la) != len(lb):
        raise AssertionError(f"{label}: {len(la)} leaves against {len(lb)}")
    for i, (x, y) in enumerate(zip(la, lb)):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"{label}: leaf {i} {tuple(x.shape)} {x.dtype} against {tuple(y.shape)} {y.dtype}")
        if x.dtype.is_floating_point:
            x, y = x.contiguous().view(torch.int32 if x.element_size() == 4 else torch.int16), \
                y.contiguous().view(torch.int32 if y.element_size() == 4 else torch.int16)
        if not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{label}: leaf {i} ({tuple(x.shape)} {x.dtype}) differs")


def check_captured(case: Case) -> dict:
    """The captured chain == the uncaptured chain bit for bit (see the
    module docstring); raises AssertionError where not. Returns the capture
    and replay counts of the run and the leaves compared."""
    # set-up: the tables' one host-to-device copy each (packing reads the host)
    fs.kernel_tables(case.static, case.params)
    if case.colliders is not None:
        fs.kernel_colliders(case.colliders)
    if case.kind == "fleet":
        fs.fleet_slot_rows(case.frame, case.state.device)
        fs.fleet_slot_rows(case.frame2, case.state.device)
    snapshot = [t.clone() for t in leaves(case.state)]
    before = dict(chain_graph.COUNTS)
    ref1 = step_chain(case, case.state, case.frame, False)
    got1 = step_chain(case, case.state, case.frame, True)
    assert_results_equal(got1, ref1, f"{case.name} first call")
    ref2 = step_chain(case, ref1[0], case.frame, False)
    got2 = step_chain(case, got1[0], case.frame, True)
    assert_results_equal(got2, ref2, f"{case.name} replay")
    ref3 = step_chain(case, ref2[0], case.frame2, False)
    got3 = step_chain(case, got2[0], case.frame2, True)
    assert_results_equal(got3, ref3, f"{case.name} replay with another dt and transform")
    got2b = step_chain(case, got1[0], case.frame, True)
    assert_results_equal(got2b, ref2, f"{case.name} replay from the first call's state again")
    assert_results_equal(got2, ref2, f"{case.name} an earlier replay's result after later replays")
    assert_results_equal(got1, ref1, f"{case.name} the first call's result after the replays")
    for i, (t, s) in enumerate(zip(leaves(case.state), snapshot)):
        if not torch.equal(t, s):
            raise AssertionError(f"{case.name}: the caller's input leaf {i} was written")
    a, b = fs._carried_claim(got3[0].alive), fs._carried_claim(ref3[0].alive)
    if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
        raise AssertionError(f"{case.name}: the final alive plane's carried counts differ ({a is None}, {b is None})")
    counts = {k: chain_graph.COUNTS[k] - before[k] for k in before}
    if counts["replays"] != 3 or counts["captures"] > 1:
        raise AssertionError(f"{case.name}: captures and replays {counts}")
    return {**counts, "leaves": len(leaves(got1)), "live": int(got3[1].alive_count.sum()), "state": got3[0]}
