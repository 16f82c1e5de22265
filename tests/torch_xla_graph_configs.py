"""The XLA layout's captured chain (`multi_step` and `step_jit` on the card,
`ops.chain_graph`'s kind "xla"): its cases and the check shared by the
port's card tests and chip_smoke.py (imports torch and the port only, so
both can use it without JAX).

`build(name, device, size)` makes one case at the test size ("test": 2048
lanes) or the card size ("card": 131072 lanes, 1310720 for stress_test_1M):
the spawner, its colliders, two pools of different seeds and two frame
inputs (the second with another dt, translation, rotation and, with
fields, field positions). `check_captured` holds the captured calls to the
uncaptured ones (`_captured=False`: `xla_step.multi_step`, the frames one
by one with their keys on the host) bit for bit."""

import dataclasses

import torch

import bevy_firework_tpu_torch as pt
from bevy_firework_tpu_torch.models import effects, library
from bevy_firework_tpu_torch.ops import chain_graph
from bevy_firework_tpu_torch.profile_step import tornado_fields
from bevy_firework_tpu_torch.settings import EmissionPacing

import torch_chain_configs as chain_cfg

# the cells: stress_test as bench.py's headline (1e5/s and 1e6/s), sparks,
# the nested fireworks, stress_test_collision (two cuboids) and dust under
# the tornado's three fields
CELLS = ("stress_test", "stress_test_1M", "sparks", "fireworks", "collision", "fields")


@dataclasses.dataclass
class Case:
    name: str
    static: object
    params: object
    colliders: object
    state: object
    state2: object
    frame: object
    frame2: object
    n: int
    long_n: int = 0  # a further chain of long_n frames, past the graph's XLA_ROWS word rows, where > 0


def _rated(spawner, rate):
    es = dataclasses.replace(spawner.emission_settings[0], emission_pacing=EmissionPacing.rate(float(rate)))
    return dataclasses.replace(spawner, emission_settings=(es,))


def build(name: str, device, size: str = "test") -> Case:
    """The case `name` (CELLS) on `device` at `size`."""
    card = size == "card"
    dev = torch.device(device)
    cap = 131072 if card else 2048
    cols, ff, ff2, n = None, None, None, 30 if card else 8
    if name in ("stress_test", "stress_test_1M"):
        big = name == "stress_test_1M" and card
        cap = 1310720 if big else cap
        sp = _rated(effects.stress_test()[0], 1e6 if big else 1e5 if card else 1.5e3)
    elif name == "sparks":
        sp = effects.sparks()[0]
    elif name == "fireworks":  # rockets burst at 85-100% of a 1.1-1.5 s life: children from frame ~60
        sp, n = effects.fireworks()[0], 120 if card else 100
    elif name == "collision":
        sp, _tf, col = effects.stress_test_collision()
        sp = sp if card else _rated(sp, 1.5e3)
        cols = pt.compile_colliders(col, device=dev)
    elif name == "fields":
        sp = library.dust(rate=3e4 if card else 1.5e3, lifetime=4.0, updraft=2.5, drag=2.0, emit_radius=1.2)
        ff = pt.compile_force_fields(tornado_fields(), device=dev)
        ff2 = pt.compile_force_fields(tornado_fields(0.3, -0.2), device=dev)
    else:
        raise ValueError(f"no XLA chain case {name!r}")
    c = pt.compile_spawner(sp, device=dev)
    frame = pt.make_frame_input(1 / 60, translation=(0.0, 0.1, 0.0), force_fields=ff)
    frame2 = pt.make_frame_input(1 / 45, translation=(0.2, 0.1, -0.3), rotation=(0.0, 0.0998, 0.0, 0.995),
                                 parent_velocity=(0.5, 0.0, -0.25), modifier_scale=1.25, modifier_speed=0.8,
                                 force_fields=ff2)
    long_n = chain_graph.XLA_ROWS + 44 if name == "sparks" and not card else 0
    return Case(name, c.static, c.params, cols, pt.init_pool_for(c, cap, seed=3), pt.init_pool_for(c, cap, seed=11),
                frame, frame2, n, long_n)


def multi_step(case: Case, state, frame, n: int, captured: bool):
    """`pt.multi_step` of the case, captured or not; captured under sync
    debug mode "error" (no call waits for the card)."""
    if not captured:
        return pt.multi_step(case.static, case.params, case.colliders, state, frame, n, _captured=False)
    torch.cuda.set_sync_debug_mode("error")
    try:
        return pt.multi_step(case.static, case.params, case.colliders, state, frame, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def step_jit(case: Case, state, frame, captured: bool):
    if not captured:
        return pt.step_jit(case.static, case.params, case.colliders, state, frame, _captured=False)
    torch.cuda.set_sync_debug_mode("error")
    try:
        return pt.step_jit(case.static, case.params, case.colliders, state, frame)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def check_captured(case: Case) -> dict:
    """Captured == uncaptured bit for bit (every leaf: the pool, rng_key,
    the outputs): the first call (the capture), a call from its state, a
    call from another seed's pool under the second frame (nothing frozen:
    dt, transform, speed, scale, parent velocity, fields and keys are the
    new ones), a call of one frame (the last-frame graph alone), a step_jit
    call from the first call's state, and with `long_n` a chain longer than
    the graph's word rows (sparks at the test size: XLA_ROWS + 44 frames,
    its words copied in two chunks); the earlier results still hold their values after the later
    calls and the caller's pools are never written. Raises AssertionError
    where not. Returns the run's capture and replay counts, the captured
    calls made and the live lanes of the first call's result."""
    equal = chain_cfg.assert_results_equal
    snapshot = [t.clone() for s in (case.state, case.state2) for t in chain_cfg.leaves(s)]
    before = dict(chain_graph.COUNTS)
    ref1 = multi_step(case, case.state, case.frame, case.n, False)
    got1 = multi_step(case, case.state, case.frame, case.n, True)
    equal(got1, ref1, f"{case.name} first call")
    ref2 = multi_step(case, ref1[0], case.frame, case.n, False)
    got2 = multi_step(case, got1[0], case.frame, case.n, True)
    equal(got2, ref2, f"{case.name} second call")
    ref3 = multi_step(case, case.state2, case.frame2, case.n, False)
    got3 = multi_step(case, case.state2, case.frame2, case.n, True)
    equal(got3, ref3, f"{case.name} another seed, dt and transform")
    ref4 = multi_step(case, ref3[0], case.frame, 1, False)
    got4 = multi_step(case, got3[0], case.frame, 1, True)
    equal(got4, ref4, f"{case.name} one frame")
    refj = step_jit(case, ref1[0], case.frame2, False)
    gotj = step_jit(case, got1[0], case.frame2, True)
    equal(gotj, refj, f"{case.name} step_jit")
    calls = 5
    if case.long_n:
        equal(multi_step(case, got1[0], case.frame, case.long_n, True),
              multi_step(case, ref1[0], case.frame, case.long_n, False), f"{case.name} {case.long_n} frames")
        calls += 1
    equal(got1, ref1, f"{case.name} the first call's result after the later calls")
    equal(got2, ref2, f"{case.name} the second call's result after the later calls")
    now = [t for s in (case.state, case.state2) for t in chain_cfg.leaves(s)]
    for i, (t, s) in enumerate(zip(now, snapshot)):
        if not torch.equal(t, s):
            raise AssertionError(f"{case.name}: the caller's pool leaf {i} was written")
    return {"captures": chain_graph.COUNTS["captures"] - before["captures"],
            "replays": chain_graph.COUNTS["replays"] - before["replays"], "calls": calls,
            "live": int(got1[0].alive.sum()), "live_per_type": got2[1].alive_count_per_type.tolist()}
