"""The per-frame step, plain PyTorch: spawn -> integrate (+ collide) -> stats.

This is the plain version of the CUDA step kernel (`ops/csrc/fused_step.cu`)
and follows it, not the JAX package's XLA step, wherever the two differ:
  * randomness is the kernel's layout (`prng`): one Philox draw set per
    lane per frame, seeded by word 0 of the frame key; the XLA step draws
    threefry uniforms per emitter, so the packages agree on random configs
    only in distribution (and exactly on deterministic ones);
  * claims: emitter e claims the dead lanes whose rank r lies in
    [S_{e-1}, S_e) of the frame's cumulative spawn counts. Ring archetypes
    (deaths only by age) rank by ring distance, r = (g - cursor) mod N;
    destroy-on-collision archetypes by dead-slot rank, r = the exclusive
    count of dead lanes before g (`dead_rank`);
  * alive is derived from age (alive == age < lifetime) on every ring
    archetype, a `particles_destroyed` handler or not (deaths there are by
    age only, so the survivor plane is the same set), and is the survivor
    plane of the previous frame on the dead-rank ones: the kernel keys the
    alive plane on the claim kind, and so does this version;
  * collision (`collision.particle_collision`) and the force fields
    (`force_fields.field_accel`) keep the op order of the JAX package's
    Pallas kernel.
Every expression keeps the op order of `bevy_firework_tpu.step` and of the
kernel, so on the card the kernel and this function agree bit for bit up to
libm (`sinf`/`cosf`).

Scope: the global branch of the reference's spawn/update chain, with
colliders of every kind, destroy-on-collision, scene force fields and the
destroyed-particle mask. Nested emitters raise NotImplementedError naming
the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

from .cadence import compute_emission_count
from .collision import particle_collision
from .compiled import MODE_NESTED, PACING_ON_DEMAND, PACING_ONE_SHOT, SpawnerParams, SpawnerStatic
from .curve import eval_curve_static
from .emission_shape import sample_shape_comp
from .force_fields import field_accel
from .pool import FrameInput, PoolState
from .prng import frame_seeds, lane_uniforms
from .rand import sample_randf32, sample_randvec3_comp
from .utils.f32 import rem_euclid
from .utils.quat import quat_from_scaled_axis_comp, quat_mul_comp, quat_rotate_comp

ROTATION_FIELDS = ("qx", "qy", "qz", "qw", "wx", "wy", "wz")


@dataclasses.dataclass(frozen=True)
class StepOutputs:
    """Per-frame outputs surfaced to the host."""

    alive_count: torch.Tensor  # int32 scalar
    alive_count_per_type: torch.Tensor  # [T] int32
    finished_event: torch.Tensor  # bool scalar
    aabb_valid: torch.Tensor  # bool scalar (any live particle)
    aabb_min: torch.Tensor  # [3] min(pos - scale) over live
    aabb_max: torch.Tensor  # [3] max(pos + scale)
    destroyed_mask: torch.Tensor  # [N] bool: died this frame, of a type with a destroyed handler
    nested_deferred: torch.Tensor  # int32 scalar (0: no nested emitters here)
    nested_dropped: torch.Tensor  # int32 scalar


def check_scope(static: SpawnerStatic) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    if any(m == MODE_NESTED for m in static.mode_kinds):
        raise NotImplementedError("nested emitters: ROADMAP queue 1 item 12 is not ported yet")


def fields_on(frame: FrameInput) -> bool:
    """The frame carries a non-empty scene force-field table."""
    return frame.force_fields is not None and frame.force_fields.count > 0


def collision_on(static: SpawnerStatic, colliders) -> bool:
    """The narrow phase runs: a type collides and the table is not empty."""
    return static.any_collision and colliders is not None and colliders.count > 0


def dead_rank(dead: torch.Tensor) -> torch.Tensor:
    """Exclusive rank of each lane among the dead lanes, in lane order (the
    JAX step's `cumsum(dead) - dead`): the plain version of the kernel's
    dead-rank claim."""
    di = dead.to(torch.int32)
    return torch.cumsum(di, 0, dtype=torch.int32) - di


def active_f32_fields(static: SpawnerStatic) -> tuple:
    """The f32 fields the step reads and writes; elided fields (rotation when
    every particle keeps the identity, lifetime when it is constant) are
    invariant and pass through untouched."""
    names = ["px", "py", "pz", "vx", "vy", "vz"]
    if not static.elide_rotation:
        names += list(ROTATION_FIELDS)
    names += ["initial_scale", "age"]
    if static.const_lifetime is None:
        names.append("lifetime")
    return tuple(names)


def n_draws(static: SpawnerStatic) -> int:
    """Uniforms per spawned lane: 3 shape + 3 velocity + 1 radial + 1 scale,
    then lifetime and angular velocity only where those fields are live."""
    return 8 + (0 if static.const_lifetime is not None else 1) + (0 if static.elide_rotation else 3)


def lifetime_of(static: SpawnerStatic, fields: dict):
    """Per-lane lifetime: the field, or the archetype's constant as a 0-d
    tensor on the pool's device. Not a Python float: PyTorch's CUDA division
    by a host scalar multiplies by its reciprocal, which is not IEEE
    division and would part the plain version from the kernel. Made with
    torch.full (a fill on the device), not torch.tensor (a host copy that
    waits for the stream)."""
    if static.const_lifetime is None:
        return fields["lifetime"]
    return torch.full((), float(static.const_lifetime), dtype=torch.float32, device=fields["age"].device)


def _by_type(values: torch.Tensor, ptype, num_types: int):
    """Per-lane value of a [T] table: an unrolled compare-select."""
    out = values[0]
    for t in range(1, num_types):
        out = torch.where(ptype == t, values[t], out)
    return out


def scale_factor(static: SpawnerStatic, params: SpawnerParams, ptype, age_pct):
    k0, n0 = static.scale_curve_meta[0]
    sf = eval_curve_static(params.scale_ts[0], params.scale_vs[0], k0, n0, age_pct)
    for t in range(1, static.num_types):
        kt, nt = static.scale_curve_meta[t]
        sf = torch.where(ptype == t, eval_curve_static(params.scale_ts[t], params.scale_vs[t], kt, nt, age_pct), sf)
    return sf


def cadence(static: SpawnerStatic, params: SpawnerParams, scal: dict, dt):
    """One frame of the reference's spawn bookkeeping (core.rs:395-427) on
    the scalar state: returns (bounds, new scalars) with bounds[e] the
    cumulative spawn count before emitter e (int32 0-d tensors)."""
    tic, last, en, mq = scal["time_in_cycle"], scal["last_emission"], scal["enabled"], scal["manual_queued"]
    E = static.num_emitters
    active = en.any()  # every emitter is global in this slice
    zero_i = torch.zeros((), dtype=torch.int32, device=tic.device)
    bounds = [zero_i]
    new_tic, new_last, new_en = [], [], []
    for e in range(E):
        gate = active & en[e]
        pk = static.pacing_kinds[e]
        if pk == PACING_ONE_SHOT:
            n_sp = torch.where(gate, params.count[e].to(torch.int32), zero_i)
            new_en.append(en[e] & ~gate)  # disable after the burst
            new_tic.append(tic[e])
            new_last.append(last[e])
        elif pk == PACING_ON_DEMAND:
            n_sp = torch.where(gate, mq, zero_i)
            mq = torch.where(gate, zero_i, mq)
            new_en.append(en[e])
            new_tic.append(tic[e])
            new_last.append(last[e])
        else:  # rate / CountOverDuration
            t = rem_euclid(tic[e] + dt, params.duration[e])
            cnt, next_last = compute_emission_count(t, last[e], params.duration[e], params.off_start[e],
                                                    params.off_end[e], params.count[e])
            n_sp = torch.where(gate, cnt, zero_i)
            new_en.append(en[e])
            new_tic.append(torch.where(gate, t, tic[e]))
            new_last.append(torch.where(gate, next_last, last[e]))
        bounds.append(bounds[-1] + n_sp)
    n = scal["capacity"]
    cursor = scal["ring_cursor"]
    if static.ring_claim:  # the dead-rank claim leaves the cursor alone
        cursor = torch.remainder(cursor + bounds[-1], n).to(torch.int32)
    new = dict(scal, time_in_cycle=torch.stack(new_tic), last_emission=torch.stack(new_last),
               enabled=torch.stack(new_en), manual_queued=mq, ring_cursor=cursor)
    return bounds, new


def advance(static: SpawnerStatic, params: SpawnerParams, fields: dict, scal: dict, frame: FrameInput, seed: int,
            colliders=None):
    """One sub-frame on the active fields (+ ptype, + alive on dead-rank
    archetypes) and the scalar state. Returns the new (fields, scal, dump):
    dump is the sub-frame's destroyed mask (lanes alive after the spawn and
    not surviving it, of a type with a destroyed handler), None when no type
    has one."""
    T = static.num_types
    dt = frame.dt
    f = dict(fields)
    N = f["age"].shape[0]
    ptype = f["ptype"]
    life = lifetime_of(static, f)
    alive0 = f["age"] < life if static.ring_claim else f["alive"]
    dead = ~alive0

    cursor0 = scal["ring_cursor"]
    bounds, scal = cadence(static, params, scal, dt)
    total = bounds[-1]
    lanes = torch.arange(N, dtype=torch.int64, device=f["age"].device)
    rank = torch.remainder(lanes - cursor0, N) if static.ring_claim else dead_rank(dead)
    spawned = dead & (rank < total)

    # ---- spawn init (kernel spawn block; draws in prng's lane layout) ----
    u = lane_uniforms(seed, lanes, n_draws(static))
    trans = frame.transform_translation
    orot = frame.transform_rotation
    pvel = frame.parent_velocity
    for e in range(static.num_emitters):
        m = spawned & (rank >= bounds[e]) & (rank < bounds[e + 1])
        offx, offy, offz = sample_shape_comp(params.shape_params[e], u[0], u[1], u[2])
        ivx, ivy, ivz = sample_randvec3_comp(params.ivel_params[e], u[3], u[4], u[5])
        radial = sample_randf32(u[6], params.radial_lo[e], params.radial_hi[e])
        l2 = offx * offx + offy * offy + offz * offz
        inv = torch.where(l2 > 0, 1.0 / torch.sqrt(l2), torch.zeros_like(l2))
        wvx, wvy, wvz = quat_rotate_comp(orot[0], orot[1], orot[2], orot[3], ivx, ivy, ivz)
        spd = frame.modifier_speed
        inh = params.inherit[e]
        velx = spd * (wvx + offx * inv * radial) + inh * pvel[0]
        vely = spd * (wvy + offy * inv * radial) + inh * pvel[1]
        velz = spd * (wvz + offz * inv * radial) + inh * pvel[2]
        ti = static.particle_indices[e]
        iscale = sample_randf32(u[7], params.initial_scale_lo[ti], params.initial_scale_hi[ti]) * frame.modifier_scale
        ui = 8
        new = {"px": trans[0] + offx, "py": trans[1] + offy, "pz": trans[2] + offz,
               "vx": velx, "vy": vely, "vz": velz, "initial_scale": iscale, "age": 0.0}
        if static.const_lifetime is None:
            new["lifetime"] = sample_randf32(u[ui], params.lifetime_lo[ti], params.lifetime_hi[ti])
            ui += 1
        if not static.elide_rotation:
            avx, avy, avz = sample_randvec3_comp(params.iangvel_params[e], u[ui], u[ui + 1], u[ui + 2])
            rot = params.init_rot[e]
            new.update(qx=rot[0], qy=rot[1], qz=rot[2], qw=rot[3], wx=avx, wy=avy, wz=avz)
        for k, v in new.items():
            f[k] = torch.where(m, v, f[k])
        if not static.single_type:
            ptype = torch.where(m, torch.full_like(ptype, ti), ptype)
    alive_sp = alive0 | spawned

    # ---- integrate (reference core.rs:594-650, op order of step.py) ----
    life = lifetime_of(static, f)
    age_new = f["age"] + dt
    dead_by_age = age_new >= life
    age_pct = age_new / life
    px, py, pz = f["px"], f["py"], f["pz"]
    vx, vy, vz = f["vx"], f["vy"], f["vz"]
    npx, npy, npz = px + vx * dt, py + vy * dt, pz + vz * dt
    nvx, nvy, nvz = vx, vy, vz
    moved = alive_sp & ~dead_by_age
    survivor = moved
    if collision_on(static, colliders):
        # narrow phase (kernel :1421-1456) on lanes of a collision type
        has_col = torch.zeros_like(moved)
        for t in range(T):
            if static.collision_types[t]:
                has_col = has_col | (ptype == t)
        cpx, cpy, cpz, cvx, cvy, cvz, destroyed = particle_collision(
            colliders, px, py, pz, vx, vy, vz, dt, _by_type(params.restitution, ptype, T),
            _by_type(params.friction, ptype, T), _by_type(params.destroy_on_collision, ptype, T),
            _by_type(params.collision_mask, ptype, T), moved & has_col)
        npx, npy, npz = (torch.where(has_col, c, n) for c, n in ((cpx, npx), (cpy, npy), (cpz, npz)))
        nvx, nvy, nvz = (torch.where(has_col, c, v) for c, v in ((cvx, vx), (cvy, vy), (cvz, vz)))
        survivor = moved & ~(has_col & destroyed)
    ax = _by_type(params.acceleration[:, 0], ptype, T)
    ay = _by_type(params.acceleration[:, 1], ptype, T)
    az = _by_type(params.acceleration[:, 2], ptype, T)
    if fields_on(frame):
        # scene force fields at the post-move position, onto the per-type
        # acceleration before drag, weighted by the type's opt-in (kernel
        # :1462-1472)
        ffx, ffy, ffz = field_accel(frame.force_fields, npx, npy, npz)
        fm = _by_type(params.field_mask, ptype, T)
        ax, ay, az = ax + fm * ffx, ay + fm * ffy, az + fm * ffz
    lin_drag = _by_type(params.linear_drag, ptype, T)
    dvx = nvx + (ax - nvx * lin_drag) * dt
    dvy = nvy + (ay - nvy * lin_drag) * dt
    dvz = nvz + (az - nvz * lin_drag) * dt

    # A destroyed lane keeps its age; ring archetypes never destroy, so age
    # < lifetime stays their alive flag, and the others carry `alive`.
    dump = None
    if static.any_destroyed_dump:  # kernel :1567-1576
        destroyed = alive_sp & ~survivor
        dump = torch.zeros_like(destroyed)
        for t in range(T):
            if static.destroyed_dump_types[t]:
                dump = dump | (destroyed & (ptype == t))
    f["age"] = torch.where(alive_sp, age_new, f["age"])
    f["px"] = torch.where(moved, npx, px)
    f["py"] = torch.where(moved, npy, py)
    f["pz"] = torch.where(moved, npz, pz)
    f["vx"] = torch.where(survivor, dvx, torch.where(moved, nvx, vx))
    f["vy"] = torch.where(survivor, dvy, torch.where(moved, nvy, vy))
    f["vz"] = torch.where(survivor, dvz, torch.where(moved, nvz, vz))
    if not static.ring_claim:
        f["alive"] = survivor
    if not static.elide_rotation:
        aax = _by_type(params.angular_acceleration[:, 0], ptype, T)
        aay = _by_type(params.angular_acceleration[:, 1], ptype, T)
        aaz = _by_type(params.angular_acceleration[:, 2], ptype, T)
        ang_drag = _by_type(params.angular_drag, ptype, T)
        wx, wy, wz = f["wx"], f["wy"], f["wz"]
        sqx, sqy, sqz, sqw = quat_from_scaled_axis_comp(wx * dt, wy * dt, wz * dt)
        rq = quat_mul_comp(sqx, sqy, sqz, sqw, f["qx"], f["qy"], f["qz"], f["qw"])
        for k, v in zip(("qx", "qy", "qz", "qw"), rq):
            f[k] = torch.where(survivor, v, f[k])
        f["wx"] = torch.where(survivor, wx + (aax - ang_drag * wx) * dt, wx)
        f["wy"] = torch.where(survivor, wy + (aay - ang_drag * wy) * dt, wy)
        f["wz"] = torch.where(survivor, wz + (aaz - ang_drag * wz) * dt, wz)
    f["ptype"] = ptype
    return f, scal, dump


def split_state(static: SpawnerStatic, state: PoolState):
    """(fields, scal): the step's working set of a pool."""
    fields = {k: getattr(state, k) for k in active_f32_fields(static)}
    fields["ptype"] = state.ptype
    if not static.ring_claim:
        fields["alive"] = state.alive
    scal = {k: getattr(state, k) for k in ("time_in_cycle", "last_emission", "enabled", "manual_queued",
                                           "ring_cursor")}
    scal["capacity"] = state.capacity
    return fields, scal


def finished_latch(static: SpawnerStatic, state: PoolState, enabled, alive_any):
    """notify_finished (core.rs:674-688): all empty, no active emitter, not
    yet notified. Returns (finished_event, finished_notified)."""
    active_now = enabled.any()  # every emitter is global in this slice
    finished = ~alive_any & ~active_now & ~state.finished_notified
    return finished, state.finished_notified | finished


def epilogue(static: SpawnerStatic, params: SpawnerParams, state: PoolState, fields: dict, scal: dict,
             new_key: torch.Tensor, stats: bool = True, dump=None, stats_row=None):
    """Assemble the post-frame PoolState, and with `stats` the StepOutputs
    (AABB over pos ± scale, alive and per-type counts, finished latch, the
    destroyed mask `dump` of the last sub-frame). The stats are torch
    reductions here, or, given the kernel's stats row (`stats_row`, the
    in-kernel stats of `ops.fused_step`), read from it: then only the
    finished latch is computed. Without `stats` only the finished latch is
    computed (chain frames whose outputs nobody reads)."""
    kw = {k: getattr(state, k) for k in ("px", "py", "pz", "vx", "vy", "vz", "qx", "qy", "qz", "qw",
                                         "wx", "wy", "wz", "initial_scale", "age", "lifetime")}
    kw.update({k: v for k, v in fields.items() if k not in ("ptype", "alive")})
    ptype = fields["ptype"]
    life = lifetime_of(static, kw)
    alive = kw["age"] < life if static.ring_claim else fields["alive"]
    if stats_row is not None:
        aabb_min, aabb_max, alive_count, per_type = stats_row
        alive_any = alive_count > 0
    else:
        alive_any = alive.any()
    finished, notified = finished_latch(static, state, scal["enabled"], alive_any)
    new_state = PoolState(
        **kw, ptype=ptype, alive=alive, last_emitted=state.last_emitted,
        time_in_cycle=scal["time_in_cycle"], last_emission=scal["last_emission"], enabled=scal["enabled"],
        manual_queued=scal["manual_queued"], finished_notified=notified, ring_cursor=scal["ring_cursor"],
        rng_key=new_key,
    )
    if not stats:
        return new_state, None
    if stats_row is None:
        aabb_min, aabb_max, alive_count, per_type = stat_reductions(static, params, kw, ptype, alive)
    zero = torch.zeros((), dtype=torch.int32, device=alive.device)
    out = StepOutputs(
        alive_count=alive_count, alive_count_per_type=per_type, finished_event=finished,
        aabb_valid=alive_any, aabb_min=aabb_min, aabb_max=aabb_max,
        destroyed_mask=torch.zeros_like(alive) if dump is None else dump, nested_deferred=zero, nested_dropped=zero,
    )
    return new_state, out


def stat_reductions(static: SpawnerStatic, params: SpawnerParams, kw: dict, ptype, alive):
    """The plain version of the kernel's stats block: (aabb_min [3], aabb_max
    [3], alive count, per-type counts [T]) over the live lanes, the AABB of
    pos ± scale (render.rs:677-703)."""
    life = lifetime_of(static, kw)
    scale = kw["initial_scale"] * scale_factor(static, params, ptype, kw["age"] / life)
    inf = float("inf")
    aabb_min = torch.stack([torch.where(alive, kw[c] - scale, inf).min() for c in ("px", "py", "pz")])
    aabb_max = torch.stack([torch.where(alive, kw[c] + scale, -inf).max() for c in ("px", "py", "pz")])
    per_type = torch.stack([(alive & (ptype == t)).sum(dtype=torch.int32) for t in range(static.num_types)])
    return aabb_min, aabb_max, alive.sum(dtype=torch.int32), per_type


def plain_frames(static: SpawnerStatic, params: SpawnerParams, state: PoolState, frame: FrameInput, n: int = 1,
                 stats: bool = True, colliders=None):
    """n frames of the plain version from `state`, on its device: the frame
    keys split in order, `advance` n times, one `epilogue`. Returns
    (new_state, StepOutputs, or None without `stats`)."""
    key, seeds = frame_seeds(state.rng_key.numpy(), n)
    fields, scal = split_state(static, state)
    dump = None
    for seed in seeds:
        fields, scal, dump = advance(static, params, fields, scal, frame, seed, colliders)
    return epilogue(static, params, state, fields, scal, torch.as_tensor(key.astype(np.int64)), stats, dump)


def step(static: SpawnerStatic, params: SpawnerParams, colliders, state: PoolState, frame: FrameInput):
    """Advance one spawner's pool by one frame (plain PyTorch, any device).
    Returns (new_state, StepOutputs)."""
    check_scope(static)
    return plain_frames(static, params, state, frame, colliders=colliders)
