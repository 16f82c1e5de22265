"""Fleet configurations shared by the port's fleet tests (imports torch and
the port only, so the card's tests can use it without JAX).

Each case stacks S = 3 pools of one archetype whose params, seeds, frames
and force fields differ per slot, so that the slots' draws, claims and
stats differ: a slot that drew or claimed with another slot's lanes or
seeds would not equal its solo launch."""

import math

import torch

import bevy_firework_tpu_torch as pt
from bevy_firework_tpu_torch.ops import fused_step as fs
from bevy_firework_tpu_torch.parallel.sharding import (
    frame_slot,
    num_slots,
    outputs_slot,
    params_slot,
    stack_frames,
    stack_outputs,
    stack_params,
    stack_pools,
    state_slot,
)
from bevy_firework_tpu_torch.pool import POOL_FIELDS
from bevy_firework_tpu_torch.render import pack_render_planes
from bevy_firework_tpu_torch.settings import ParticleCollisionSettings, ParticleEventHandlers
from bevy_firework_tpu_torch.step import active_f32_fields, plain_frames

S = 3
CASES = ("ring", "destroy_dump", "three_types_stats", "fields", "render_u8")


def det_spawner(rate):
    """The deterministic spawner (constant draws, live rotation) at `rate`."""
    return pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(
            lifetime=pt.RandF32.constant(0.3), initial_scale=pt.RandF32.constant(0.1),
            scale_curve=pt.FireworkCurve.uneven_samples([(0.0, 1.0), (1.0, 2.0)]),
            base_color=pt.gradient_uneven_samples([(0.0, (1, 0.5, 0.2, 1)), (1.0, (0, 0, 0, 0))]))],
        emission_settings=[pt.EmissionSettings(
            emission_pacing=pt.EmissionPacing.rate(rate), initial_velocity=pt.RandVec3.constant((1.0, 3.0, 0.2)),
            initial_angular_velocity=pt.RandVec3.constant((0.0, 2.0, 0.0)))])


def box_spawner(rate, destroy=False, handler=None, lifetime=2.0):
    """Box emission with random speeds and no spread: draws reach the state
    through +, -, *, / and sqrt only (no sinf/cosf)."""
    return pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(
            lifetime=pt.RandF32.constant(lifetime), initial_scale=pt.RandF32(0.02, 0.08),
            acceleration=(0.0, -9.81, 0.0), linear_drag=0.1,
            collision_settings=ParticleCollisionSettings(restitution=0.7, friction=0.3, destroy_on_collision=destroy),
            event_handlers=ParticleEventHandlers(particles_destroyed=handler))],
        emission_settings=[pt.EmissionSettings(
            emission_pacing=pt.EmissionPacing.rate(rate), emission_shape=pt.EmissionShape.box((1.5, 0.5, 1.5)),
            initial_velocity=pt.RandVec3(pt.RandF32(0.5, 3.0), (0.0, 1.0, 0.0), 0.0),
            initial_velocity_radial=pt.RandF32(1.0, 4.0))])


def three_types(scale):
    types = [pt.ParticleSettings(lifetime=pt.RandF32.constant(0.5 + 0.2 * t), initial_scale=pt.RandF32(0.02, 0.08),
                                 scale_curve=pt.FireworkCurve.uneven_samples([(0.0, 1.0), (1.0, 0.5 + t)]),
                                 acceleration=(0.0, -1.0 * t, 0.0)) for t in range(3)]
    return pt.ParticleSpawner(particle_settings=types, emission_settings=[
        pt.EmissionSettings(particle_index=t, emission_pacing=pt.EmissionPacing.rate(scale * (t + 1)),
                            emission_shape=pt.EmissionShape.box((1.0 + t, 0.5, 1.0)),
                            initial_velocity=pt.RandVec3(pt.RandF32(0.5, 3.0), (0.0, 1.0, 0.0), 0.0),
                            initial_velocity_radial=pt.RandF32(1.0, 4.0)) for t in range(3)])


def build(case: str, device, n: int):
    """(static, stacked params, colliders or None, pools [S], frames [S],
    unrolls, pack_render) of `case` on `device` at n lanes per slot. Rates
    scale with n so that the slots fill to different shares of the pool,
    none of them full."""
    per_s = n * 1.0  # spawns per second: n / 30 lanes a frame at 1/30 s
    col = None
    if case in ("ring", "render_u8"):
        spawners = [det_spawner(per_s * (1.0 + 0.5 * i)) for i in range(S)]
        unrolls = [1, 1, 8, 1, 8] if case == "ring" else [8, 1, 8]
    elif case == "destroy_dump":
        spawners = [box_spawner(per_s * (0.4 + 0.2 * i), destroy=True, handler=lambda rs: None, lifetime=0.4)
                    for i in range(S)]
        col = pt.compile_colliders([pt.Collider.halfspace(position=(0.0, -0.2, 0.0)),
                                    pt.Collider.sphere(0.5, position=(-1.4, 0.6, 0.2))], device=device)
        unrolls = [1] * 16
    elif case == "three_types_stats":
        spawners = [three_types(per_s * (0.08 + 0.04 * i)) for i in range(S)]
        unrolls = [1, 8, 1]
    elif case == "fields":
        spawners = [box_spawner(per_s * (0.2 + 0.1 * i), lifetime=0.8) for i in range(S)]
        unrolls = [1, 1, 8, 1]
    else:
        raise ValueError(case)
    compiled = [pt.compile_spawner(sp, device=device) for sp in spawners]
    static = compiled[0].static
    assert all(c.static == static for c in compiled)
    pools = [pt.init_pool_for(c, n, seed=11 + 7 * i) for i, c in enumerate(compiled)]
    frames = []
    for i in range(S):
        ff = None
        if case == "fields":
            # a point attractor and a vortex (no cosf), moved per slot
            ff = pt.compile_force_fields([pt.ForceField.point((0.3 * i, 0.8, -0.2), 6.0 + i, 2.5),
                                          pt.ForceField.vortex((0.1, 0.0, 0.2 * i), (0.3, 0.9, 0.1), 5.0, 3.0)],
                                         device=device)
        frames.append(pt.make_frame_input(1 / 30, translation=(float(i), 0.5 * i, 0.0),
                                          rotation=(0.0, math.sin(0.1 * i), 0.0, math.cos(0.1 * i)),
                                          parent_velocity=(0.1 * i, 0.0, 0.0), modifier_scale=1.0 + 0.1 * i,
                                          modifier_speed=1.0 - 0.1 * i, force_fields=ff))
    params = stack_params([c.params for c in compiled])
    return static, params, col, pools, frames, unrolls, case == "render_u8"


def stacked(pools, frames):
    return stack_pools(pools), stack_frames(frames)


def check_fleet_equals_solo(case: str, device, n: int, plain: bool = False) -> dict:
    """Step `case` through `fused_step_fleet` and each slot through solo
    `fused_step` calls, launch for launch: every pool leaf (rng_key too),
    every output and every render plane equal bit for bit, slot by slot.
    plain: each slot's launch also against the plain frames from the same
    state (`step.plain_frames`, the render pack's plain version): exact but
    for the rotation fields, within 2 ulp (sinf/cosf of the quaternion
    update against PyTorch's). Returns {"live": per-slot live counts,
    "destroyed": dumped lanes, "max_abs_err_plain": the largest difference
    from the plain frames over the f32 fields and render planes}."""
    static, params, col, pools, frames, unrolls, pack = build(case, device, n)
    states, F = stacked(pools, frames)
    dumped, err = 0, 0.0
    for u in unrolls:
        res = fs.fused_step_fleet(static, params, col, states, F, pack_render=pack, unroll=u)
        for i in range(S):
            solo = fs.fused_step(static, params_slot(params, i), col, pools[i], frames[i],
                                 pack_render=pack, unroll=u)
            si, oi = state_slot(res[0], i), outputs_slot(res[1], i)
            for k in POOL_FIELDS:
                assert torch.equal(getattr(si, k), getattr(solo[0], k)), f"{case} U={u} slot {i}: {k}"
            for k, v in vars(solo[1]).items():
                assert torch.equal(getattr(oi, k), v), f"{case} U={u} slot {i}: outputs.{k}"
            if pack:
                for j, (a, b) in enumerate(zip(res[2], solo[2])):
                    assert torch.equal(a[i], b), f"{case} U={u} slot {i}: render plane {j}"
            if plain:
                sp, op = plain_frames(static, params_slot(params, i), pools[i], frames[i], u, colliders=col)
                for k in POOL_FIELDS:
                    a, b = getattr(si, k), getattr(sp, k)
                    if k in active_f32_fields(static):
                        err = max(err, float((a - b).abs().max()))
                    if k in ("qx", "qy", "qz", "qw") and k in active_f32_fields(static):
                        assert ulps(a, b) <= 2, f"{case} U={u} slot {i}: plain {k}"
                    else:
                        assert torch.equal(a.cpu(), b.cpu()), f"{case} U={u} slot {i}: plain {k}"
                for k in ("alive_count", "alive_count_per_type", "finished_event", "destroyed_mask"):
                    assert torch.equal(getattr(oi, k), getattr(op, k)), f"{case} U={u} slot {i}: plain {k}"
                if pack:
                    for j, (a, b) in enumerate(zip(res[2], pack_render_planes(static, params_slot(params, i), sp))):
                        assert torch.equal(a[i], b), f"{case} U={u} slot {i}: plain render plane {j}"
            pools[i] = solo[0]
        states = res[0]
        dumped += int(res[1].destroyed_mask.sum())
    return {"live": res[1].alive_count.tolist(), "destroyed": dumped, "max_abs_err_plain": err}


FLOW_SNAPSHOTS = (1, 30, 100, 160)
FLOW_RENDERS = (1, 100)
FLOW_SHAPES = ("circle", "box")


def _plain_step_auto_fleet(static, params, colliders, states, frames):
    """`step_auto_fleet` through fused_step_fleet's plain version on the
    pool's device (its CPU branch: S solo plain frames stacked)."""
    solo = [plain_frames(static, params_slot(params, i), state_slot(states, i), frame_slot(frames, i), 1,
                         colliders=colliders) for i in range(num_slots(states))]
    return stack_pools([st for st, _o in solo]), stack_outputs([o for _s, o in solo])


def one_shot_fleet_flow(device, shape: str = "circle", frames: int = 200, plain: bool = False) -> dict:
    """The README's one-shot Fleet flow on `device`, extended:
    effects.one_shot() bursts in a fleet of 8 slots of 64 lanes; three
    slots activated at frame 0, two more (one with an effect modifier, one
    moving) at frame 30; `drain_finished` after every step, so slots
    finish at different frames and are recycled. shape "box" swaps the burst's circle emission
    (sinf/cosf of a drawn angle) for a box, so that no draw meets libm.
    plain: the Fleet steps through the plain version on `device` in place
    of the fleet kernel (the card's replay). Returns the finished slots and
    live count per frame, the activated slots, host copies of the stacked
    pool at the FLOW_SNAPSHOTS frames and at the end, and the render items
    at the FLOW_RENDERS frames."""
    import dataclasses

    from bevy_firework_tpu_torch import fleet as fleet_mod
    from bevy_firework_tpu_torch.models import effects

    sp = effects.one_shot()[0]
    if shape == "box":
        es = dataclasses.replace(sp.emission_settings[0], emission_shape=pt.EmissionShape.box((0.4, 0.05, 0.4)))
        sp = dataclasses.replace(sp, emission_settings=(es,))
    fleet = pt.Fleet(sp, capacity=64, max_spawners=8, device=device)
    res = {"activated": [], "finished": [], "live": [], "states": {}, "items": {}}
    kernel_step = fleet_mod.step_auto_fleet
    if plain:
        fleet_mod.step_auto_fleet = _plain_step_auto_fleet
    try:
        for f in range(frames):
            if f == 0:
                res["activated"] += [fleet.activate(pt.Transform(translation=(float(i), 0.0, 0.5 * i)))
                                     for i in range(3)]
            elif f == 30:
                res["activated"].append(fleet.activate(pt.Transform(translation=(-2.0, 1.0, 0.0)),
                                                       modifier=pt.EffectModifier(scale=1.5, speed=0.5)))
                res["activated"].append(fleet.activate(parent_velocity=(0.5, 0.0, -0.25)))
            fleet.step(1 / 60)
            res["finished"].append(fleet.drain_finished())
            res["live"].append(fleet.alive_count())
            if f + 1 in FLOW_SNAPSHOTS or f + 1 == frames:
                res["states"][f + 1] = {k: getattr(fleet.states, k).cpu().clone() for k in POOL_FIELDS}
            if f + 1 in FLOW_RENDERS:
                res["items"][f + 1] = fleet.render_items()
    finally:
        fleet_mod.step_auto_fleet = kernel_step
    return res


def compare_fleet_flows(a: dict, b: dict) -> dict:
    """Two runs of `one_shot_fleet_flow` (the card's against a reference):
    the finished slots and live counts of every frame, every non-f32 pool
    leaf at each snapshot, and the render items' slots, types and counts
    must be equal. Returns the largest f32 pool difference in ulp and in
    value and the largest render-row difference, for the caller's rule."""
    assert a["activated"] == b["activated"] and a["finished"] == b["finished"], (a["finished"], b["finished"])
    assert a["live"] == b["live"], (a["live"], b["live"])
    worst_ulp, worst_abs, worst_row = 0, 0.0, 0.0
    for f, sa in a["states"].items():
        for k, x in sa.items():
            y = b["states"][f][k]
            if x.dtype == torch.float32:
                worst_ulp = max(worst_ulp, ulps(x, y))
                worst_abs = max(worst_abs, float((x - y).abs().max()) if x.numel() else 0.0)
            else:
                assert torch.equal(x, y), f"frame {f}: {k}"
    for f, ia in a["items"].items():
        ib = b["items"][f]
        assert [(i.spawner_id, i.type_index, i.count) for i in ia] == [(i.spawner_id, i.type_index, i.count)
                                                                      for i in ib], f"frame {f}: render items"
        for x, y in zip(ia, ib):
            worst_row = max(worst_row, float(abs(x.instances - y.instances).max()) if x.count else 0.0)
    return {"max_ulp": worst_ulp, "max_abs": worst_abs, "rows_max_abs": worst_row}


def flow_rule_holds(shape: str, reference: str, diff: dict) -> bool:
    """The card's Fleet against `reference`. "plain", the plain version
    replayed on the card: bit for bit where no draw meets libm ("box"),
    f32 within 4 ulp with the circle's sinf/cosf (the kernel's against
    PyTorch's CUDA ops, the rule of chip_smoke.py's random phase). "cpu",
    the Fleet on the CPU: f32 within 1e-5, the rule of the port's other
    flows (the card's CUDA ops and libm against the CPU's part by a few ulp
    even without sinf/cosf: 2 ulp in the box flow on an H100)."""
    if reference == "plain" and shape == "box":
        return diff == {"max_ulp": 0, "max_abs": 0.0, "rows_max_abs": 0.0}
    if reference == "plain":
        return diff["max_ulp"] <= 4 and diff["rows_max_abs"] <= 1e-5
    return diff["max_abs"] <= 1e-5 and diff["rows_max_abs"] <= 1e-5


def ulps(a, b) -> int:
    """Largest distance in units in the last place between two f32 tensors."""
    def key(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((key(a) - key(b)).abs().max()) if a.numel() else 0
