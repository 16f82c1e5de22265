"""The per-frame step, plain PyTorch: spawn -> integrate (+ collide) -> stats.

This is the plain version of the CUDA step kernel (`ops/csrc/fused_step_kernel.cuh`)
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

Scope: the reference's spawn/update chain with colliders of every kind,
destroy-on-collision, scene force fields, the destroyed-particle mask and
nested emission. Archetypes with a nested emitter step one hybrid frame at
a time, the plain version of `bevy_firework_tpu.ops.fused_step.
fused_step_hybrid` with its in-kernel child merge (`hybrid_frame`): each
valid nested emitter in order runs its nested stage (`nested_stage`, the
plain version of the nested-stage kernel): its cadence pass
(`nested_cadence`) and its child stage (`nested_child_rows`, threefry
draws under `fold_in(frame_key, 1000 + e)`), all on the pre-spawn alive;
then `advance` merges the children into their claim windows before the
global claim, whose ring cursor starts where the nested claims left it. A
frame of a folded chain takes its cadence results from a carry instead:
`nested_fold_carry` on the previous frame's post-frame state, the plain
version of the fold (kernel row 10).
Nested children therefore match the JAX package's lane for lane; the
hybrid's global spawns draw Philox like the fused path, seeded by word 1 of
the hybrid's kernel key. The JAX hybrid writes children back in place
where its Mosaic merge does not apply (dead-rank archetypes, pools no
larger than the child buffer); here every case merges, which claims the
same slots (consecutive claim windows over the pre-spawn ring or dead
ranks) and leaves `last_emitted` in the same clamp class (the JAX
package's tests/test_nested.py canonicalises it the same way).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .cadence import compute_emission_count, emission_next_last
from .collision import particle_collision
from .compiled import MODE_NESTED, PACING_ON_DEMAND, PACING_ONE_SHOT, SpawnerParams, SpawnerStatic
from .curve import eval_curve_static
from .emission_shape import sample_shape_comp
from .force_fields import field_accel
from .ops import table_layout as L
from .ops.table_layout import TILE
from .pool import FrameInput, PoolState
from .prng import frame_seeds, lane_uniforms, threefry_fold_in, threefry_split, threefry_uniform
from .rand import sample_randf32, sample_randf32_fused, sample_randvec3_comp
from .utils.f32 import F32_MIN, rem_euclid
from .utils.quat import quat_from_scaled_axis_comp, quat_mul_comp, quat_rotate_comp

ROTATION_FIELDS = ("qx", "qy", "qz", "qw", "wx", "wy", "wz")

# Raised on both devices by the kernel's layout for a nested archetype
# under sharding.
NESTED_SHARD_MESSAGE = ("the kernel's layout does not shard archetypes with a nested emitter (nor does the JAX "
                        "package's Pallas kernel): parallel.sharding.make_sharded_step steps them sharded in the XLA "
                        "layout, as the JAX package's GSPMD step does")


@dataclasses.dataclass(frozen=True)
class Shard:
    """A pool split over the particle axis, this shard of it (kernel row 11,
    the JAX package's `_shard_override`): the shard's lanes are the global
    lanes [lane_base, lane_base + its capacity) of a pool of global_n lanes,
    and dead_offset dead lanes of that pool lie in the shards before it:
    an int, or an int32 0-d tensor on the pool's device (the step reads it
    there, so nothing waits on the card for it). Unsharded: (0, capacity,
    0)."""

    lane_base: int
    global_n: int
    dead_offset: int | torch.Tensor = 0

    def __post_init__(self):
        negative = not isinstance(self.dead_offset, torch.Tensor) and self.dead_offset < 0
        if self.lane_base < 0 or negative or self.global_n <= self.lane_base:
            raise ValueError(f"not a shard of a pool: {self}")


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
    # Nested accounting (no silent losses): children beyond the per-frame
    # child buffer M are deferred to later frames (their parents' cadence
    # anchors advance only by what was materialised); children whose claim
    # window slot was not dead (pool capacity) are dropped, and counted.
    nested_deferred: torch.Tensor  # int32 scalar
    nested_dropped: torch.Tensor  # int32 scalar


def has_nested(static: SpawnerStatic) -> bool:
    """The archetype has a nested emitter: it steps hybrid frames."""
    return any(m == MODE_NESTED for m in static.mode_kinds)


def nested_emitters(static: SpawnerStatic) -> tuple:
    """The valid nested emitters, in emitter order (an invalid pacing never
    emits, core.rs:481-484)."""
    return tuple(e for e in range(static.num_emitters)
                 if static.mode_kinds[e] == MODE_NESTED and static.nested_valid[e])


def nested_m(static: SpawnerStatic, capacity: int) -> int:
    """The per-emitter per-frame child buffer: nested_m, at most the pool."""
    return min(static.nested_m, capacity)


def active_flag(static: SpawnerStatic, enabled, any_alive=None):
    """`ParticleSpawnerData::active` (core.rs:288-302): a global emitter
    counts while enabled, a nested one only while any particle lives
    (`any_alive`, a 0-d bool; unused by global-only archetypes, whose
    flag is per slot for a fleet's [S, E] enabled rows)."""
    if not has_nested(static):
        return enabled.any(-1)  # per slot of a stacked [S, E]
    active = torch.zeros((), dtype=torch.bool, device=enabled.device)
    for e in range(static.num_emitters):
        active = active | (enabled[e] & any_alive if static.mode_kinds[e] == MODE_NESTED else enabled[e])
    return active


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


def dead_tile_counts(alive: torch.Tensor) -> torch.Tensor:
    """The dead-rank claim's per-tile counts: the dead lanes of each
    TILE-lane tile of the pool (its last tile ragged), int32 [ceil(N /
    TILE)], or per slot of a stacked [S, N] plane. The plain version of the
    counts the card's dead-rank launch leaves for the next one (and its
    seed's count kernel); their exclusive cumsum is the claim's tile
    offsets."""
    lead, n = tuple(alive.shape[:-1]), alive.shape[-1]
    n_tiles = -(-n // TILE)
    dead = torch.zeros(lead + (n_tiles * TILE,), dtype=torch.int32, device=alive.device)
    dead[..., :n] = (~alive).to(torch.int32)
    return dead.view(lead + (n_tiles, TILE)).sum(-1, dtype=torch.int32)


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


def cadence(static: SpawnerStatic, params: SpawnerParams, scal: dict, dt, any_alive=None):
    """One frame of the reference's spawn bookkeeping (core.rs:395-427) for
    the global emitters on the scalar state: returns (bounds, new scalars)
    with bounds[e] the cumulative spawn count before emitter e (int32 0-d
    tensors). Nested emitters spawn nothing here and keep their scalars;
    any_alive (the pre-spawn flag) enters the active flag for them."""
    tic, last, en, mq = scal["time_in_cycle"], scal["last_emission"], scal["enabled"], scal["manual_queued"]
    E = static.num_emitters
    active = active_flag(static, en, any_alive)
    zero_i = torch.zeros((), dtype=torch.int32, device=tic.device)
    bounds = [zero_i]
    new_tic, new_last, new_en = [], [], []
    for e in range(E):
        gate = active & en[e]
        pk = static.pacing_kinds[e]
        if static.mode_kinds[e] == MODE_NESTED:  # spawned by the nested phase
            n_sp = zero_i
            new_en.append(en[e])
            new_tic.append(tic[e])
            new_last.append(last[e])
        elif pk == PACING_ONE_SHOT:
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
    n = scal["capacity"]  # the ring: the global pool's capacity when sharded
    cursor = scal["ring_cursor"]
    if static.ring_claim:  # the dead-rank claim leaves the cursor alone
        cursor = torch.remainder(cursor + bounds[-1], n).to(torch.int32)
    new = dict(scal, time_in_cycle=torch.stack(new_tic), last_emission=torch.stack(new_last),
               enabled=torch.stack(new_en), manual_queued=mq, ring_cursor=cursor)
    return bounds, new


@dataclasses.dataclass(frozen=True)
class NestedSpawns:
    """A hybrid frame's nested children, for `advance` to merge before the
    global claim (the plain version of the kernel's merge block)."""

    any_alive: torch.Tensor  # 0-d bool: a lane lived before the frame's spawns
    # per valid nested emitter: (emitter, window start, children n, rows
    # [len(active_f32_fields), M] indexed by child rank)
    windows: tuple
    # the ring cursor after the nested claims, or on dead-rank archetypes the
    # dead-slot rank where the global claim starts (int32 0-d)
    next_start: torch.Tensor


def advance(static: SpawnerStatic, params: SpawnerParams, fields: dict, scal: dict, frame: FrameInput, seed: int,
            colliders=None, nested: NestedSpawns = None, shard: Shard = None):
    """One sub-frame on the active fields (+ ptype, + alive on dead-rank
    archetypes) and the scalar state. Returns the new (fields, scal, dump):
    dump is the sub-frame's destroyed mask (lanes alive after the spawn and
    not surviving it, of a type with a destroyed handler), None when no type
    has one. nested: the frame's nested children, merged first: the child
    of rank r of emitter e takes the dead lane whose claim rank (ring
    distance from the window start, or dead-slot rank minus it) is r < n.
    shard (kernel row 11's plain version; `scal` from `split_state` with the
    same shard): these lanes are the global lanes lane_base + [0, N) of a
    pool of scal["capacity"] lanes, so they rank in its ring and draw as its
    lanes do, and their dead ranks start at dead_offset."""
    dt = frame.dt
    f = dict(fields)
    N = f["age"].shape[0]
    ptype = f["ptype"]
    life = lifetime_of(static, f)
    alive0 = f["age"] < life if static.ring_claim else f["alive"]
    lane_base, dead_offset = (0, 0) if shard is None else (shard.lane_base, shard.dead_offset)
    lanes = lane_base + torch.arange(N, dtype=torch.int64, device=f["age"].device)
    dead_pre = ~alive0
    rank_base = 0
    if nested is not None:
        # ---- nested child merge (the kernel's merge block) ----
        drank = None if static.ring_claim else dead_rank(dead_pre)
        for e, start, n, rows in nested.windows:
            r = torch.remainder(lanes - start, N) if static.ring_claim else drank - start
            m = ~alive0 & (r >= 0) & (r < n)
            ri = r.clamp(0, rows.shape[1] - 1)
            for k, row in zip(active_f32_fields(static), rows):
                f[k] = torch.where(m, row[ri], f[k])
            alive0 = alive0 | m
            if not static.single_type:
                ptype = torch.where(m, torch.full_like(ptype, static.particle_indices[e]), ptype)
        if static.ring_claim:
            scal = dict(scal, ring_cursor=nested.next_start)
        else:
            rank_base = nested.next_start
    dead = ~alive0

    cursor0 = scal["ring_cursor"]
    ring_n = scal["capacity"]
    bounds, scal = cadence(static, params, scal, dt, None if nested is None else nested.any_alive)
    total = bounds[-1]
    if static.ring_claim:
        rank = torch.remainder(lanes - cursor0, ring_n)
    else:
        rank = dead_rank(dead_pre) + dead_offset - rank_base
    spawned = dead & (rank >= 0) & (rank < total)

    # ---- spawn init (kernel spawn block; draws in prng's lane layout) ----
    u = lane_uniforms(seed, lanes, n_draws(static))
    trans = frame.transform_translation
    orot = frame.transform_rotation
    pvel = frame.parent_velocity
    for e in range(static.num_emitters):
        if static.mode_kinds[e] == MODE_NESTED:
            continue
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
    f, survivor, dump = integrate(static, params, f, ptype, alive_sp, frame, colliders)
    # ring archetypes never destroy, so age < lifetime stays their alive
    # flag; the others carry `alive`
    if not static.ring_claim:
        f["alive"] = survivor
    f["ptype"] = ptype
    return f, scal, dump


def integrate(static: SpawnerStatic, params: SpawnerParams, fields: dict, ptype, alive_sp, frame: FrameInput,
              colliders=None):
    """update_particles (reference core.rs:594-650, the op order of the JAX
    package's step.py:717-829) on the post-spawn fields: age, cull by
    lifetime, move (+ collide), acceleration (+ scene force fields) and
    drag, rotation. Shared by the kernel's plain version (`advance`) and the
    XLA-layout step (`xla_step.step`). Returns (fields, survivor, dump):
    survivor the lanes alive after the frame, dump the destroyed mask
    (lanes alive after the spawn and not surviving, of a type with a
    destroyed handler), None when no type has one."""
    T = static.num_types
    dt = frame.dt
    f = dict(fields)
    life = lifetime_of(static, f)
    age_new = f["age"] + dt
    dead_by_age = age_new >= life
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

    # a destroyed lane keeps its age
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
    return f, survivor, dump

def split_state(static: SpawnerStatic, state: PoolState, shard: Shard = None):
    """(fields, scal): the step's working set of a pool; with a shard,
    scal["capacity"] is the global pool's (the ring's) capacity."""
    fields = {k: getattr(state, k) for k in active_f32_fields(static)}
    fields["ptype"] = state.ptype
    if not static.ring_claim:
        fields["alive"] = state.alive
    scal = {k: getattr(state, k) for k in ("time_in_cycle", "last_emission", "enabled", "manual_queued",
                                           "ring_cursor")}
    scal["capacity"] = state.capacity if shard is None else shard.global_n
    return fields, scal


def finished_latch(static: SpawnerStatic, state: PoolState, enabled, alive_any):
    """notify_finished (core.rs:674-688): all empty, no active emitter (the
    active flag on the post-frame state, nested-aware as the JAX epilogue's,
    its `_epilogue_tail`), not yet notified. Returns (finished_event,
    finished_notified)."""
    active_now = active_flag(static, enabled, alive_any)
    finished = ~alive_any & ~active_now & ~state.finished_notified
    return finished, state.finished_notified | finished


def merge_latch(static: SpawnerStatic, state: PoolState, enabled, alive):
    """The plain version of a merge launch's latch (kernel rows 9 and 10:
    the words its last block writes, `ops.fused_step`), bool [3]: any lane
    alive after the frame, the finished event and the new
    finished_notified, from the post-frame enabled bits and alive plane.
    As the kernel computes it: an enabled global emitter, or an enabled
    nested one while a lane lives, keeps the spawner active; the epilogue
    given these words equals the one that reduces (`finished_latch`)."""
    nested = torch.tensor([k == MODE_NESTED for k in static.mode_kinds], device=enabled.device)
    any_alive = alive.any()
    active = (enabled & ~nested).any() | ((enabled & nested).any() & any_alive)
    finished = ~any_alive & ~active & ~state.finished_notified
    return torch.stack([any_alive, finished, state.finished_notified | finished])


def epilogue(static: SpawnerStatic, params: SpawnerParams, state: PoolState, fields: dict, scal: dict,
             new_key: torch.Tensor, stats: bool = True, dump=None, stats_row=None, last_emitted=None,
             nested_counts=None, group=None, latch=None):
    """Assemble the post-frame PoolState, and with `stats` the StepOutputs
    (AABB over pos ± scale, alive and per-type counts, finished latch, the
    destroyed mask `dump` of the last sub-frame). The stats are torch
    reductions here, or, given the kernel's stats row (`stats_row`, the
    in-kernel stats of `ops.fused_step`), read from it: then only the
    finished latch is computed. Without `stats` only the finished latch is
    computed (chain frames whose outputs nobody reads). Hybrid frames pass
    the new `last_emitted` rows and `nested_counts`, a function returning
    the frame's (deferred, dropped) children, called only for the outputs.
    A fleet launch (global-only archetypes) passes its stacked pool with
    the kernel's per-slot stats rows: every op then runs over the leading
    [S] axis, one op for all slots, and the outputs are [S]-stacked. group
    (a torch.distributed process group whose ranks hold the shards of one
    pool): the AABB, the counts and the any-alive flag (so the finished
    latch) are the whole pool's, from one collective (`group_reduce`), on
    every launch. A merge launch of the card (hybrid frames) passes its
    alive plane in `fields` ("alive", on the ring too) and its `latch`
    (`merge_latch`'s words: any alive, finished event, new
    finished_notified): then nothing here reduces or compares."""
    kw = {k: getattr(state, k) for k in ("px", "py", "pz", "vx", "vy", "vz", "qx", "qy", "qz", "qw",
                                         "wx", "wy", "wz", "initial_scale", "age", "lifetime")}
    kw.update({k: v for k, v in fields.items() if k not in ("ptype", "alive")})
    ptype = fields["ptype"]
    alive = fields.get("alive")
    if alive is None:  # the ring's, unless the launch wrote it
        alive = kw["age"] < lifetime_of(static, kw)
    local = stats_row
    if latch is not None:  # a merge launch's words (never sharded)
        alive_any, finished, notified = latch.unbind()
    else:
        if local is None and stats and group is not None:
            local = stat_reductions(static, params, kw, ptype, alive)
        if group is not None:
            local, alive_any = group_reduce(group, local, alive.any(-1) if local is None else None)
        else:
            alive_any = alive.any(-1) if local is None else local[2] > 0
        finished, notified = finished_latch(static, state, scal["enabled"], alive_any)
    if local is not None:
        aabb_min, aabb_max, alive_count, per_type = local
    new_state = PoolState(
        **kw, ptype=ptype, alive=alive, last_emitted=state.last_emitted if last_emitted is None else last_emitted,
        time_in_cycle=scal["time_in_cycle"], last_emission=scal["last_emission"], enabled=scal["enabled"],
        manual_queued=scal["manual_queued"], finished_notified=notified, ring_cursor=scal["ring_cursor"],
        rng_key=new_key,
    )
    if not stats:
        return new_state, None
    if local is None:
        aabb_min, aabb_max, alive_count, per_type = stat_reductions(static, params, kw, ptype, alive)
    if nested_counts is None:
        deferred = dropped = torch.zeros(alive.shape[:-1], dtype=torch.int32, device=alive.device)
    else:
        deferred, dropped = nested_counts()
    out = StepOutputs(
        alive_count=alive_count, alive_count_per_type=per_type, finished_event=finished,
        aabb_valid=alive_any, aabb_min=aabb_min, aabb_max=aabb_max,
        destroyed_mask=torch.zeros_like(alive) if dump is None else dump, nested_deferred=deferred,
        nested_dropped=dropped,
    )
    return new_state, out


def collective_device(group, device: torch.device) -> torch.device:
    """Where a collective's tensors live: the card under `nccl`, the CPU
    under `gloo` (read from the group's backend; a pool on the card then
    copies its few words to the host)."""
    import torch.distributed as dist

    if dist.get_backend(group) == "nccl":
        return device if device.type == "cuda" else torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def group_gather(group, value: torch.Tensor) -> torch.Tensor:
    """One all-gather of a small tensor over `group`, on the device its
    backend wants (`collective_device`): the ranks' values stacked [W, ...]
    on `value`'s device. Counts its calls and their host seconds
    (`group_gather.calls`, `.seconds`)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    sent = value.to(collective_device(group, value.device))
    parts = [torch.empty_like(sent) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, sent, group=group)
    out = torch.stack(parts).to(value.device)
    group_gather.calls += 1
    group_gather.seconds += time.perf_counter() - t0
    return out


group_gather.calls = 0
group_gather.seconds = 0.0


class ShardExchange:
    """Every word that crosses the ranks of `group` in a frame of the
    XLA-layout step over a sharded pool (`xla_step.step(shard=, group=)`,
    the JAX package's GSPMD step), each one `group_gather`, in a frame's
    order:
      * `frame_start` (archetypes with a nested emitter or the dead-rank
        claim): 2 int32 per rank, whether a lane of its shard lives and its
        dead lanes;
      * per valid nested emitter, `count_totals`: 1 int32 per rank, the
        children its parents ask for;
      * per valid nested emitter, `parents`: F x M + 1 int32 per rank, the
        f32 bits of the parent values (F fields, `nested_parent_fields`) of
        the child ranks whose parent lies in its shard, zeros elsewhere,
        and on the ring the children whose slot it owns and took;
      * the epilogue's `group_reduce`: 7 + T float64 (stats) or 1.
    So a ring archetype without a nested emitter sends only the epilogue's
    words. Ranks' values are merged by selection, never by a sum (-0.0 +
    0.0 is +0.0). Every result is a tensor on the shard's device."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)

    def frame_start(self, alive: torch.Tensor):
        """(any lane of the pool alive 0-d bool, each rank's dead lanes [W]
        int32)."""
        words = torch.stack([alive.any().to(torch.int32), (~alive).sum(dtype=torch.int32)])
        rows = group_gather(self.group, words)
        return rows[:, 0].amax() > 0, rows[:, 1].contiguous()

    def count_totals(self, total: torch.Tensor) -> torch.Tensor:
        """Each rank's children of one nested emitter, [W] int32."""
        return group_gather(self.group, total.reshape(1).to(torch.int32)).view(-1)

    def parents(self, values: torch.Tensor, took: torch.Tensor):
        """(every rank's parent values [W, F, M] f32, every rank's taken
        children [W] int32) from this rank's values [F, M] and count."""
        words = torch.cat([values.contiguous().view(torch.int32).reshape(-1), took.reshape(1).to(torch.int32)])
        rows = group_gather(self.group, words)
        return rows[:, :-1].contiguous().view(torch.float32).view(self.world, *values.shape), rows[:, -1]


def group_reduce(group, stats=None, alive_any=None):
    """A sharded pool's epilogue collective (the JAX package's pmin / pmax /
    psum, `_fused_epilogue` :2300-2304): this rank's (aabb_min, aabb_max,
    alive count, per-type counts) over its shard, or without stats its
    any-alive flag, become the whole pool's on every rank of `group`. One
    all-gather of a few float64 words per launch, reduced here: MIN, MAX and
    SUM are three reductions, and float64 holds every f32 bound and every
    count exactly, so the result equals the unsharded reductions. Returns
    (global stats or None, global any-alive 0-d bool), on the shard's
    device."""
    if stats is None:
        row = alive_any.reshape(1).to(torch.float64)
    else:
        mn, mx, count, per_type = stats
        row = torch.cat([mn.to(torch.float64), mx.to(torch.float64), count.reshape(1).to(torch.float64),
                         per_type.to(torch.float64)])
    rows = group_gather(group, row)
    if stats is None:
        return None, rows[:, 0].amax() > 0
    count = rows[:, 6].sum().to(torch.int32)
    out = (rows[:, 0:3].amin(0).to(torch.float32), rows[:, 3:6].amax(0).to(torch.float32), count,
           rows[:, 7:].sum(0).to(torch.int32))
    return out, count > 0


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


# --------------------------------------------------------------------------
# nested emission (the JAX package's step._spawn_phase nested branch with
# kernel_cadence, and step._nested_spawn)
# --------------------------------------------------------------------------


def nested_child_field_rows(static: SpawnerStatic) -> tuple:
    """The child rows' order, shared by the child stage and the kernel's
    merge: exactly the f32 fields a nested spawn writes (the active fields)."""
    return active_f32_fields(static)


def nested_parent_fields(static: SpawnerStatic) -> tuple:
    """The parent-state fields a nested spawn reads (core.rs:502-518):
    position, [rotation unless elided pool-wide,] velocity."""
    if static.elide_rotation:
        return ("px", "py", "pz", "vx", "vy", "vz")
    return ("px", "py", "pz", "qx", "qy", "qz", "qw", "vx", "vy", "vz")


def nested_draw_rows(static: SpawnerStatic) -> int:
    """Uniform rows of the child stage (the JAX package's step.py:414): 0-6
    shape, velocity, radial, 7 scale, 8 lifetime, 9-11 angular velocity,
    the rows the archetype reads."""
    return 12 if not static.elide_rotation else (9 if static.const_lifetime is None else 8)


def nested_lane_counts(static: SpawnerStatic, params: SpawnerParams, e: int, alive, ptype, age, lifetime, le_row,
                       gate):
    """Per parent lane of nested emitter e (the nested kernels' `nested_lane`):
    (counts [N] i32: the emission count of a live lane of the target type
    while `gate` holds, else 0; the full anchor advance; the anchor after
    the lazy reset of dead lanes to f32::MIN; the parent mask)."""
    base_le = torch.where(alive, le_row, torch.full_like(le_row, F32_MIN))  # lazy reset
    pm = alive & gate
    if not static.single_type:
        pm = pm & (ptype == static.target_types[e])
    counts, next_full = compute_emission_count(age, base_le, lifetime, params.off_start[e], params.off_end[e],
                                               params.count[e])
    return torch.where(pm, counts, torch.zeros_like(counts)), next_full, base_le, pm


def nested_cadence(static: SpawnerStatic, params: SpawnerParams, e: int, alive, ptype, age, lifetime, le_row, gate,
                   M: int, parent_fields=None):
    """The plain version of the nested-stage kernel's pass (kernel row 8; the JAX
    package's `_make_nested_cadence_kernel`, in its op order): per parent
    lane of emitter e, the lazy reset of dead lanes' anchors, the emission
    count (alive, gated, of the target type), the inclusive count cumsum,
    the deferral-truncated `last_emitted` advance and the total. Returns
    (new_le [N] f32, cum [N] i32 or None, total i32 0-d, parent values or
    None). With `parent_fields` (fetch mode: name -> [N] f32) the values of
    each child rank's parent come back instead of cum: name -> [M] f32,
    zeros for ranks at or above the total. lifetime: the [N] field or the
    archetype's 0-d constant."""
    off_s, off_e, cnt = params.off_start[e], params.off_end[e], params.count[e]
    counts, next_full, base_le, pm = nested_lane_counts(static, params, e, alive, ptype, age, lifetime, le_row, gate)
    cum = torch.cumsum(counts, 0, dtype=torch.int32)
    total = cum[-1]
    emitted = cum.clamp_max(M) - (cum - counts).clamp_max(M)
    trunc = emission_next_last(base_le, lifetime, off_s, off_e, cnt, emitted)
    new_le = torch.where(pm, torch.where(emitted < counts, trunc, next_full), base_le)
    if parent_fields is None:
        return new_le, cum, total, None
    ranks = torch.arange(M, dtype=torch.int32, device=cum.device)
    parent = nested_parents(cum, M)
    valid = ranks < total
    return new_le, None, total, {k: torch.where(valid, v[parent], torch.zeros((), device=v.device))
                                 for k, v in parent_fields.items()}


def nested_parents(cum: torch.Tensor, M: int) -> torch.Tensor:
    """Child rank -> parent lane: the first lane whose inclusive count cumsum
    exceeds the rank (the JAX package's `_monotone_inverse`, a TPU
    workaround for this search), clamped into the pool."""
    ranks = torch.arange(M, dtype=torch.int32, device=cum.device)
    return torch.searchsorted(cum, ranks, right=True).clamp_max(cum.shape[0] - 1)


def nested_child_rows(static: SpawnerStatic, params: SpawnerParams, frame: FrameInput, e: int, parent: dict,
                      frame_key, M: int, fused: bool = False) -> torch.Tensor:
    """The plain version of the nested-stage kernel's child rows: the
    children of emitter e by rank (the JAX package's step.py:411-453), from
    `parent` (name -> [M] parent values of each rank) and the uniforms
    uniform(fold_in(frame_key, 1000 + e), (n_rows, M)). Returns [len(nested_child_field_rows), M] f32.
    frame_key: the frame key on the host, or a captured XLA chain's frame
    keys as device words (`prng.FrameKeyWords`, whose fold-ins the chain
    computed), the same draws.
    fused (the XLA-layout step): each uniform range lo + (hi - lo) * u
    with one rounding, as XLA compiles it for the CPU."""
    randf32 = sample_randf32_fused if fused else sample_randf32
    dev = parent["px"].device
    u = threefry_uniform(threefry_fold_in(frame_key, 1000 + e), (nested_draw_rows(static), M), dev)
    ti = static.particle_indices[e]
    offx, offy, offz = sample_shape_comp(params.shape_params[e], u[0], u[1], u[2])
    ivx, ivy, ivz = sample_randvec3_comp(params.ivel_params[e], u[3], u[4], u[5])
    radial = randf32(u[6], params.radial_lo[e], params.radial_hi[e])
    l2 = offx * offx + offy * offy + offz * offz
    inv = torch.where(l2 > 0, 1.0 / torch.sqrt(l2), torch.zeros_like(l2))
    if static.elide_rotation:  # parent rotation is the identity pool-wide
        wvx, wvy, wvz = ivx, ivy, ivz
    else:
        wvx, wvy, wvz = quat_rotate_comp(parent["qx"], parent["qy"], parent["qz"], parent["qw"], ivx, ivy, ivz)
    spd = frame.modifier_speed
    inh = params.inherit[e]
    rows = {"px": parent["px"] + offx, "py": parent["py"] + offy, "pz": parent["pz"] + offz,
            "vx": spd * (wvx + offx * inv * radial) + inh * parent["vx"],
            "vy": spd * (wvy + offy * inv * radial) + inh * parent["vy"],
            "vz": spd * (wvz + offz * inv * radial) + inh * parent["vz"],
            "initial_scale": randf32(u[7], params.initial_scale_lo[ti], params.initial_scale_hi[ti])
            * frame.modifier_scale,
            "age": torch.zeros(M, dtype=torch.float32, device=dev)}
    if not static.elide_rotation:
        rot = params.init_rot[e]
        avx, avy, avz = sample_randvec3_comp(params.iangvel_params[e], u[9], u[10], u[11])
        rows.update(qx=rot[0].expand(M), qy=rot[1].expand(M), qz=rot[2].expand(M), qw=rot[3].expand(M),
                    wx=avx, wy=avy, wz=avz)
    if static.const_lifetime is None:
        rows["lifetime"] = randf32(u[8], params.lifetime_lo[ti], params.lifetime_hi[ti])
    return torch.stack([rows[k] for k in nested_child_field_rows(static)])


def nested_stage(static: SpawnerStatic, params: SpawnerParams, frame: FrameInput, e: int, alive, ptype, age,
                 lifetime, le_row, gate, M: int, parents: dict, frame_key, start, carry=None):
    """The plain version of the nested-stage kernel (kernel rows 8 and 9b,
    one launch per nested emitter of a hybrid frame): nested emitter e's
    cadence pass (`nested_cadence`), each child rank's parent
    (`nested_parents`; on ring archetypes parent values 0 from the total
    on, as the fetch mode gives them) and the child rows
    (`nested_child_rows`). Returns (new_le [N] f32, the emitter's NS record
    int32 [NS_STRIDE], child rows [len(nested_child_field_rows), M] f32).
    The record's window starts at `start` (int32 0-d: the ring cursor or a
    dead-slot rank); on the ring a child whose window slot lives (`alive`,
    the pre-spawn plane) is dropped, on dead-rank archetypes a child past
    the pool's dead lanes. carry (a folded frame; `nested_fold_carry`'s
    (new_le, total, parent values)) stands in for the cadence pass."""
    N = alive.shape[0]
    if carry is not None:
        new_le, total, pv = carry
    else:
        new_le, cum, total, _pv = nested_cadence(static, params, e, alive, ptype, age, lifetime, le_row, gate, M)
        idx = nested_parents(cum, M)
        valid = torch.arange(M, device=alive.device) < total
        pv = {k: v[idx] if not static.ring_claim else torch.where(valid, v[idx], torch.zeros((), device=v.device))
              for k, v in parents.items()}
    rows = nested_child_rows(static, params, frame, e, pv, frame_key, M)
    n = total.clamp_max(M)
    if static.ring_claim:
        r = torch.arange(M, dtype=torch.int64, device=alive.device)
        dropped = ((r < n) & alive[torch.remainder(start + r, N)]).sum(dtype=torch.int32)
        nxt = torch.remainder(start + n, N)
    else:
        dropped = n - n.clamp_max(((~alive).sum(dtype=torch.int32) - start).clamp_min(0))
        nxt = start + n
    rec = torch.zeros(L.NS_STRIDE, dtype=torch.int32, device=alive.device)
    for slot, v in ((L.NS_TOTAL, total), (L.NS_N, n), (L.NS_START, start), (L.NS_NEXT, nxt),
                    (L.NS_DROPPED, dropped), (L.NS_EMITTER, e)):
        rec[slot] = v
    return new_le, rec, rows


def nested_fold_carry(static: SpawnerStatic, params: SpawnerParams, state: PoolState) -> dict:
    """The plain version of the nested fold (kernel row 10, the JAX
    package's fold epilogue) and of a folded chain's seed: per valid nested
    emitter e of a ring archetype, `nested_cadence` in fetch mode on `state`
    (the post-frame state of the frame that folds), gated by the emitter's
    enabled bit alone. Returns {e: (new_le [N], total, parent values name ->
    [M])}, what the next frame's cadence pass would compute: the carry its
    nested phase consumes in place of the pass. The gate: the pass's is
    active & enabled[e]; it counts live lanes only, and while one lives an
    enabled nested emitter makes active true, so the two gates count the
    same lanes (the JAX package's fused_step.py:2496-2505)."""
    M = nested_m(static, state.capacity)
    life = lifetime_of(static, {"lifetime": state.lifetime, "age": state.age})
    alive = state.age < life
    parents = {k: getattr(state, k) for k in nested_parent_fields(static)}
    carry = {}
    for e in nested_emitters(static):
        new_le, _cum, total, pv = nested_cadence(static, params, e, alive, state.ptype, state.age, life,
                                                 state.last_emitted[e], state.enabled[e], M, parents)
        carry[e] = (new_le, total, pv)
    return carry


def nested_fold_counts(static: SpawnerStatic, params: SpawnerParams, state: PoolState, e: int):
    """The plain version of the fold epilogue's share on the card: nested
    emitter e's per-lane parent counts on the post-frame `state`
    (`nested_lane_counts`, gated by enabled[e] alone) summed per TILE-lane
    tile, int32 [ceil(N / TILE)], and whether a lane lives (the next
    frame's NS_ANY), a 0-d bool."""
    life = lifetime_of(static, {"lifetime": state.lifetime, "age": state.age})
    alive = state.age < life
    counts = nested_lane_counts(static, params, e, alive, state.ptype, state.age, life, state.last_emitted[e],
                                state.enabled[e])[0]
    n_tiles = -(-counts.shape[0] // TILE)
    padded = torch.zeros(n_tiles * TILE, dtype=torch.int32, device=counts.device)
    padded[:counts.shape[0]] = counts
    return padded.view(n_tiles, TILE).sum(-1, dtype=torch.int32), alive.any()


def nested_phase(static: SpawnerStatic, params: SpawnerParams, state: PoolState, frame: FrameInput, frame_key,
                 carry=None):
    """The nested half of a hybrid frame (the JAX package's `_spawn_phase`
    with skip_global and kernel_cadence, and `_nested_spawn`'s merge
    payload): per valid nested emitter in order, on the pre-spawn state,
    the cadence pass and the child stage, the claim window advanced by
    each emitter's children. Returns (NestedSpawns, last_emitted [E, N],
    deferred, dropped): ring windows start at the ring cursor and drop the
    children whose slot lives; dead-rank windows start at dead-slot rank 0
    and drop the children beyond the dead lanes. carry (a folded chain's
    frame; `nested_fold_carry` of this state): each emitter's pass results,
    used in place of the pass."""
    N = state.capacity
    M = nested_m(static, N)
    life = lifetime_of(static, {"lifetime": state.lifetime, "age": state.age})
    alive = state.age < life if static.ring_claim else state.alive
    any_alive = alive.any()
    active = active_flag(static, state.enabled, any_alive)
    last_emitted = state.last_emitted.clone()
    zero = torch.zeros((), dtype=torch.int32, device=alive.device)
    start = state.ring_cursor if static.ring_claim else zero
    deferred = dropped = zero
    parents = {k: getattr(state, k) for k in nested_parent_fields(static)}
    windows = []
    for e in nested_emitters(static):
        new_le, rec, rows = nested_stage(static, params, frame, e, alive, state.ptype, state.age, life,
                                         state.last_emitted[e], active & state.enabled[e], M, parents, frame_key,
                                         start, None if carry is None else carry[e])
        last_emitted[e] = new_le
        deferred = deferred + (rec[L.NS_TOTAL] - rec[L.NS_N])
        dropped = dropped + rec[L.NS_DROPPED]
        windows.append((e, rec[L.NS_START], rec[L.NS_N], rows))
        start = rec[L.NS_NEXT]
    return NestedSpawns(any_alive, tuple(windows), start), last_emitted, deferred, dropped


def hybrid_frame(static: SpawnerStatic, params: SpawnerParams, state: PoolState, frame: FrameInput,
                 stats: bool = True, colliders=None, nested_carry=None, fold_out: bool = False):
    """One hybrid frame (the plain version of `ops.fused_step.
    fused_step_hybrid`): the key chain of the JAX hybrid (new_key,
    frame_key = split(key); new_key, kernel_key = split(new_key); the
    global spawns' Philox seed is word 1 of kernel_key), the nested phase,
    then `advance` with the children merged first. Returns (new_state,
    StepOutputs or None), and with `fold_out` the next frame's carry
    (`nested_fold_carry` of the new state) third. nested_carry: this
    frame's carry, consumed in place of its cadence passes."""
    new_key, frame_key = threefry_split(state.rng_key.numpy())
    new_key, kernel_key = threefry_split(new_key)
    nested, last_emitted, deferred, dropped = nested_phase(static, params, state, frame, frame_key, nested_carry)
    fields, scal = split_state(static, state)
    fields, scal, dump = advance(static, params, fields, scal, frame, int(kernel_key[1]), colliders, nested)
    new_state, out = epilogue(static, params, state, fields, scal, torch.as_tensor(new_key.astype(np.int64)), stats,
                              dump, last_emitted=last_emitted, nested_counts=lambda: (deferred, dropped))
    if fold_out:
        return new_state, out, nested_fold_carry(static, params, new_state)
    return new_state, out


def plain_frames(static: SpawnerStatic, params: SpawnerParams, state: PoolState, frame: FrameInput, n: int = 1,
                 stats: bool = True, colliders=None, shard: Shard = None, group=None):
    """n frames of the plain version from `state`, on its device: the frame
    keys split in order, `advance` n times, one `epilogue`; archetypes with
    a nested emitter run n hybrid frames. Returns (new_state, StepOutputs,
    or None without `stats`). shard: `state` is that shard of a pool (see
    `advance`); group: the process group over whose shards the epilogue
    reduces (see `epilogue`). Nested archetypes raise NotImplementedError
    with a shard or a group (`NESTED_SHARD_MESSAGE`)."""
    if has_nested(static):
        if shard is not None or group is not None:
            raise NotImplementedError(NESTED_SHARD_MESSAGE)
        out = None
        for i in range(n):
            state, out = hybrid_frame(static, params, state, frame, stats and i == n - 1, colliders)
        return state, out
    key, seeds = frame_seeds(state.rng_key.numpy(), n)
    fields, scal = split_state(static, state, shard)
    dump = None
    for seed in seeds:
        fields, scal, dump = advance(static, params, fields, scal, frame, seed, colliders, shard=shard)
    return epilogue(static, params, state, fields, scal, torch.as_tensor(key.astype(np.int64)), stats, dump,
                    group=group)


def plain_step(static: SpawnerStatic, params: SpawnerParams, colliders, state: PoolState, frame: FrameInput):
    """One frame of the kernel's plain version (`plain_frames` with n = 1):
    what `ops.fused_step.step_auto` runs on CPU tensors. Returns
    (new_state, StepOutputs)."""
    return plain_frames(static, params, state, frame, colliders=colliders)


def step(static: SpawnerStatic, params: SpawnerParams, colliders, state: PoolState, frame: FrameInput):
    """Advance one spawner's pool by one frame in the JAX package's XLA
    layout (`xla_step.step`: threefry draws per emitter, emitters in
    declared order), on the state's device. Returns (new_state,
    StepOutputs)."""
    from . import xla_step

    return xla_step.step(static, params, colliders, state, frame)


def step_jit(static: SpawnerStatic, params: SpawnerParams, colliders, state: PoolState, frame: FrameInput,
             _captured: bool = True):
    """The JAX package's `step_jit` (its `jax.jit(step)`): `step`, the XLA
    layout, on the state's device. On the card one replay of the captured
    last frame of `multi_step`'s graph (`ops.chain_graph`, kind "xla"),
    bit-equal to `step`; _captured=False (a testing and timing seam) runs
    `step`."""
    if _captured and state.device.type == "cuda":
        from .ops import chain_graph

        return chain_graph.replay("xla", static, params, colliders, state, frame, 1)
    return step(static, params, colliders, state, frame)


def multi_step(static: SpawnerStatic, params: SpawnerParams, colliders, state: PoolState, frame: FrameInput,
               n_frames: int, _captured: bool = True):
    """The JAX package's `multi_step`: n_frames frames of `step` (the XLA
    layout) with one frame input, on the state's device. Returns (final
    state, outputs of the last frame); raises ValueError below one frame.
    On the card the JAX package's jit over lax.scan is a captured graph
    (`ops.chain_graph`, kind "xla": the scan body replayed n - 1 times, the
    last frame once), bit-equal to the frames one by one, which
    _captured=False (a testing and timing seam) runs
    (`xla_step.multi_step`). A capture that fails raises."""
    from . import xla_step

    if n_frames < 1:
        raise ValueError("multi_step needs n_frames >= 1")
    if _captured and state.device.type == "cuda":
        from .ops import chain_graph

        return chain_graph.replay("xla", static, params, colliders, state, frame, n_frames)
    return xla_step.multi_step(static, params, colliders, state, frame, n_frames)
