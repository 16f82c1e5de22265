"""Particle-vs-scene collision, plain PyTorch: the plain version of the CUDA
step kernel's narrow phase (`ops/csrc/fused_step_kernel.cuh`, `collide`).

Port of `bevy_firework_tpu.collision`: the reference's substepped
raycast-and-bounce loop (reference `src/core.rs:744-800`) over an analytic
collider table,

  while delta > 0 and n_steps < 4:
    hit = nearest solid raycast(pos, dir(vel), |vel| * delta)
    - inside (distance 0): push out along the hit normal, falling back to the
      velocity direction (or +Y) when the normal is zero;
      pos += max(|vel|, 1) * normal * delta        [delta not consumed]
    - hit: advance to the hit point; split velocity into the normal
      projection and the tangential rejection; friction impulse
      min(|proj|, |reject|) * friction against the tangential direction;
      normal response -restitution * proj; offset pos 1e-4 along the normal;
      delta -= distance (clamped to [0, dt])
    - destroy_on_collision: freeze the lane, mark it destroyed
    - miss: pos += vel * delta; delta = 0

Solid-cast semantics match parry: a ray that starts inside a shape reports
distance 0 and a zero normal.

Where the JAX package's two paths differ, this module keeps the op order of
its Pallas kernel (`bevy_firework_tpu/ops/fused_step.py` `_collide_tile`),
which the CUDA kernel also keeps: rotations in component form, the friction
term as `friction_dv * rj * rinv`, and `participating` lanes (alive after
spawn, not dead by age, of a collision type) as the only lanes with a travel
budget. Every expression is one IEEE operation per step in a fixed order, so
on the card the kernel and this module agree bit for bit.

The kernel skips, per warp and substep, the colliders that no active lane
of the warp can reach (the JAX kernel's looped narrow phase, `_collide_tile`
:452-563, which the JAX package takes from LOOP_MIN_COLLIDERS colliders;
the card's narrow phase takes it at every count). `broad_phase_keep` is that
test's plain version; the plain narrow phase here tests every collider, so
it stays the yardstick the skipping kernel must equal.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .colliders import (
    COLLIDER_CAPSULE,
    COLLIDER_CONE,
    COLLIDER_CUBOID,
    COLLIDER_CYLINDER,
    COLLIDER_HALFSPACE,
    COLLIDER_HULL,
    COLLIDER_SPHERE,
    ColliderTable,
    masked_layers,
)
from .utils.quat import quat_rotate_comp

BIG = float(np.float32(1e30))
EPS = float(np.float32(1e-12))
SUBSTEPS = 4
# The broad phase (the JAX package's looped narrow phase, its
# LOOP_MIN_COLLIDERS and reach = max(max_dist) * 1.001 + 0.01)
LOOP_MIN_COLLIDERS = 5
REACH_SCALE = float(np.float32(1.001))
REACH_MARGIN = float(np.float32(0.01))


def _normalize_or_zero(vx, vy, vz):
    l2 = vx * vx + vy * vy + vz * vz
    inv = torch.where(l2 > 0, 1.0 / torch.sqrt(l2), 0.0)
    return vx * inv, vy * inv, vz * inv


def _signed_eps(d):
    """d, or +-EPS (sign of d) where |d| < EPS: a division-safe denominator."""
    return torch.where(d.abs() < EPS, torch.where(d < 0, -EPS, EPS), d)


def _unless_inside(inside, dist, nx, ny, nz):
    return dist, torch.where(inside, 0.0, nx), torch.where(inside, 0.0, ny), torch.where(inside, 0.0, nz)


def _ray_halfspace(ox, oy, oz, dx, dy, dz):
    """Plane through the local origin, +Y normal, solid lower halfspace."""
    inside = oy <= 0.0
    t = -oy / _signed_eps(dy)
    hit_surface = (dy < 0.0) & (t >= 0.0)
    dist = torch.where(inside, 0.0, torch.where(hit_surface, t, BIG))
    zero = torch.zeros_like(ox)
    return dist, zero, torch.where(inside, 0.0, 1.0), zero


def _ray_sphere(ox, oy, oz, dx, dy, dz, r):
    c = ox * ox + oy * oy + oz * oz - r * r
    inside = c <= 0.0
    b = ox * dx + oy * dy + oz * dz
    disc = b * b - c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t = -b - sq
    valid = (disc >= 0.0) & (t >= 0.0)
    dist = torch.where(inside, 0.0, torch.where(valid, t, BIG))
    nx, ny, nz = _normalize_or_zero(ox + t * dx, oy + t * dy, oz + t * dz)
    return _unless_inside(inside, dist, nx, ny, nz)


def _ray_cuboid(ox, oy, oz, dx, dy, dz, hx, hy, hz):
    inside = (ox.abs() <= hx) & (oy.abs() <= hy) & (oz.abs() <= hz)

    def slab(o, d, h):
        invd = 1.0 / _signed_eps(d)
        t1 = (-h - o) * invd
        t2 = (h - o) * invd
        return torch.minimum(t1, t2), torch.maximum(t1, t2)

    tx0, tx1 = slab(ox, dx, hx)
    ty0, ty1 = slab(oy, dy, hy)
    tz0, tz1 = slab(oz, dz, hz)
    tmin = torch.maximum(torch.maximum(tx0, ty0), tz0)
    tmax = torch.minimum(torch.minimum(tx1, ty1), tz1)
    valid = (tmax >= tmin) & (tmin >= 0.0)
    dist = torch.where(inside, 0.0, torch.where(valid, tmin, BIG))
    # entering face normal: the axis achieving tmin, signed against the ray
    is_x = tmin == tx0
    is_y = ~is_x & (tmin == ty0)
    nx = torch.where(is_x, -torch.sign(dx), 0.0)
    ny = torch.where(is_y, -torch.sign(dy), 0.0)
    nz = torch.where(is_x | is_y, 0.0, -torch.sign(dz))
    return _unless_inside(inside, dist, nx, ny, nz)


def _ray_infinite_cylinder(ox, oz, dx, dz, r):
    """Circle intersection in the XZ plane: (t_enter, valid)."""
    a = dx * dx + dz * dz
    b = ox * dx + oz * dz
    c = ox * ox + oz * oz - r * r
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    safe_a = torch.where(a < EPS, EPS, a)
    t = (-b - sq) / safe_a
    valid = (disc >= 0.0) & (a >= EPS) & (t >= 0.0)
    return t, valid


def _ray_capsule(ox, oy, oz, dx, dy, dz, r, hs):
    # inside: distance from the point to the segment (0, +-hs, 0) <= r
    cy = torch.clamp(oy, -hs, hs)
    d2 = ox * ox + (oy - cy) * (oy - cy) + oz * oz
    inside = d2 <= r * r
    t_side, v_side = _ray_infinite_cylinder(ox, oz, dx, dz, r)
    v_side = v_side & ((oy + t_side * dy).abs() <= hs)

    def cap(cyy):  # cap sphere at (0, cyy, 0)
        oy2 = oy - cyy
        b = ox * dx + oy2 * dy + oz * dz
        c = ox * ox + oy2 * oy2 + oz * oz - r * r
        disc = b * b - c
        t = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
        return t, (disc >= 0.0) & (t >= 0.0)

    t_top, v_top = cap(hs)
    t_bot, v_bot = cap(-hs)
    t_caps = torch.minimum(torch.where(v_top, t_top, BIG), torch.where(v_bot, t_bot, BIG))
    t = torch.minimum(torch.where(v_side, t_side, BIG), t_caps)
    valid = t < BIG
    dist = torch.where(inside, 0.0, torch.where(valid, t, BIG))
    hxp, hyp, hzp = ox + t * dx, oy + t * dy, oz + t * dz
    nx, ny, nz = _normalize_or_zero(hxp, hyp - torch.clamp(hyp, -hs, hs), hzp)
    return _unless_inside(inside, dist, nx, ny, nz)


def _ray_cylinder(ox, oy, oz, dx, dy, dz, r, hh):
    inside = (ox * ox + oz * oz <= r * r) & (oy.abs() <= hh)
    t_side, v_side = _ray_infinite_cylinder(ox, oz, dx, dz, r)
    v_side = v_side & ((oy + t_side * dy).abs() <= hh)

    def cap(cy, sign):
        t = (cy - oy) / _signed_eps(dy)
        xx, zz = ox + t * dx, oz + t * dz
        return t, (t >= 0.0) & (xx * xx + zz * zz <= r * r) & (sign * dy < 0.0)

    t_top, v_top = cap(hh, 1.0)
    t_bot, v_bot = cap(-hh, -1.0)
    top_t = torch.where(v_top, t_top, BIG)
    bot_t = torch.where(v_bot, t_bot, BIG)
    t = torch.minimum(torch.minimum(torch.where(v_side, t_side, BIG), top_t), bot_t)
    valid = t < BIG
    dist = torch.where(inside, 0.0, torch.where(valid, t, BIG))
    hit_top = valid & v_top & (t == top_t)
    hit_bot = valid & v_bot & (t == bot_t)
    snx, _, snz = _normalize_or_zero(ox + t * dx, torch.zeros_like(ox), oz + t * dz)
    cap_hit = hit_top | hit_bot
    nx = torch.where(cap_hit, 0.0, snx)
    ny = torch.where(hit_top, 1.0, torch.where(hit_bot, -1.0, 0.0))
    nz = torch.where(cap_hit, 0.0, snz)
    return _unless_inside(inside, dist, nx, ny, nz)


def _ray_cone(ox, oy, oz, dx, dy, dz, r, hh):
    """Cone with its tip at (0, +hh, 0) and a base disk of radius r at -hh."""
    k = r / (2.0 * hh)  # radius growth per unit below the tip
    w = hh - oy  # distance below the tip
    inside = (oy >= -hh) & (oy <= hh) & (ox * ox + oz * oz <= (k * w) * (k * w))
    # lateral surface x^2 + z^2 = k^2 (hh - y)^2
    a = dx * dx + dz * dz - k * k * dy * dy
    b = ox * dx + oz * dz + k * k * w * dy
    c = ox * ox + oz * oz - k * k * w * w
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    safe_a = torch.where(a.abs() < EPS, EPS, a)
    t1 = (-b - sq) / safe_a
    t2 = (-b + sq) / safe_a
    tlo = torch.minimum(t1, t2)
    thi = torch.maximum(t1, t2)
    # ray parallel to the surface (a ~ 0): t = -c / (2b)
    t_lin = -c / torch.where(b.abs() < EPS, EPS, 2.0 * b)
    use_lin = a.abs() < EPS

    def side_ok(t):
        y = oy + t * dy
        return (t >= 0.0) & (y >= -hh) & (y <= hh) & (disc >= 0.0)

    t_side = torch.where(use_lin & (t_lin >= 0.0), t_lin,
                         torch.where(side_ok(tlo), tlo, torch.where(side_ok(thi), thi, BIG)))
    t_side = torch.where(use_lin, torch.where((t_lin >= 0.0) & ((oy + t_lin * dy).abs() <= hh), t_lin, BIG), t_side)
    # base disk
    t_base = (-hh - oy) / _signed_eps(dy)
    bx, bz = ox + t_base * dx, oz + t_base * dz
    v_base = (t_base >= 0.0) & (bx * bx + bz * bz <= r * r) & (dy > 0.0)
    base_t = torch.where(v_base, t_base, BIG)
    t = torch.minimum(t_side, base_t)
    valid = t < BIG
    dist = torch.where(inside, 0.0, torch.where(valid, t, BIG))
    hit_base = valid & v_base & (t == base_t)
    # lateral normal: the gradient of x^2 + z^2 - k^2 (hh - y)^2
    gnx, gny, gnz = _normalize_or_zero(ox + t * dx, k * k * (hh - (oy + t * dy)), oz + t * dz)
    nx = torch.where(hit_base, 0.0, gnx)
    ny = torch.where(hit_base, -1.0, gny)
    nz = torch.where(hit_base, 0.0, gnz)
    return _unless_inside(inside, dist, nx, ny, nz)


def _ray_hull(ox, oy, oz, dx, dy, dz, planes):
    """Convex plane-set hull: the intersection of half-spaces n.x <= d
    (planes [P, 4] rows (nx, ny, nz, d), unit normals, local space). Slab
    entry/exit over the planes; the entering plane's normal is the hit
    normal. Inside => dist 0, zero normal."""
    t_enter = torch.full_like(ox, -BIG)
    t_exit = torch.full_like(ox, BIG)
    nx = torch.zeros_like(ox)
    ny = torch.zeros_like(ox)
    nz = torch.zeros_like(ox)
    inside = torch.ones_like(ox, dtype=torch.bool)
    miss = ~inside
    for p in range(planes.shape[0]):
        pnx, pny, pnz, pd = planes[p, 0], planes[p, 1], planes[p, 2], planes[p, 3]
        denom = pnx * dx + pny * dy + pnz * dz
        num = pd - (pnx * ox + pny * oy + pnz * oz)
        inside = inside & (num >= 0.0)
        parallel = denom.abs() < EPS
        t = num / torch.where(parallel, torch.where(denom < 0, -EPS, EPS), denom)
        miss = miss | (parallel & (num < 0.0))  # outside a parallel slab
        take = (denom < 0.0) & ~parallel & (t > t_enter)
        nx = torch.where(take, pnx, nx)
        ny = torch.where(take, pny, ny)
        nz = torch.where(take, pnz, nz)
        t_enter = torch.where(take, t, t_enter)
        t_exit = torch.where((denom > 0.0) & ~parallel, torch.minimum(t_exit, t), t_exit)
    valid = ~miss & (t_exit >= t_enter) & (t_enter >= 0.0)
    dist = torch.where(inside, 0.0, torch.where(valid, t_enter, BIG))
    keep = valid & ~inside
    return dist, torch.where(keep, nx, 0.0), torch.where(keep, ny, 0.0), torch.where(keep, nz, 0.0)


def ray_collider(table: ColliderTable, ci: int, ox, oy, oz, dx, dy, dz):
    """The kind-specific ray test of collider ci in its local frame:
    (dist or BIG, local normal)."""
    k = table.kinds[ci]
    p = table.params[ci]
    if k == COLLIDER_HALFSPACE:
        return _ray_halfspace(ox, oy, oz, dx, dy, dz)
    if k == COLLIDER_SPHERE:
        return _ray_sphere(ox, oy, oz, dx, dy, dz, p[0])
    if k == COLLIDER_CUBOID:
        return _ray_cuboid(ox, oy, oz, dx, dy, dz, p[0], p[1], p[2])
    if k == COLLIDER_CAPSULE:
        return _ray_capsule(ox, oy, oz, dx, dy, dz, p[0], p[1])
    if k == COLLIDER_CYLINDER:
        return _ray_cylinder(ox, oy, oz, dx, dy, dz, p[0], p[1])
    if k == COLLIDER_CONE:
        return _ray_cone(ox, oy, oz, dx, dy, dz, p[0], p[1])
    if k == COLLIDER_HULL:
        return _ray_hull(ox, oy, oz, dx, dy, dz, table.hull_planes[ci, : table.hull_counts[ci]])
    raise ValueError(f"unknown collider kind {k}")


def raycast_scene(table: ColliderTable, lane_mask, px, py, pz, dx, dy, dz, max_dist):
    """Nearest solid hit over all colliders, per lane, in table order: the
    first collider wins a tie (dist < best is strict). Colliders whose
    (masked) layers share no bit with the lane's int64 filter mask are
    skipped. Returns (hit, dist (0 where no hit), world normal xyz)."""
    best = torch.full_like(px, BIG)
    bnx = torch.zeros_like(px)
    bny = torch.zeros_like(px)
    bnz = torch.zeros_like(px)
    layers = masked_layers(table)
    for ci in range(table.count):
        cx, cy, cz = table.position[ci, 0], table.position[ci, 1], table.position[ci, 2]
        qx, qy, qz, qw = (table.rotation[ci, j] for j in range(4))
        if table.identity_rot[ci]:
            ox, oy, oz = px - cx, py - cy, pz - cz
            rdx, rdy, rdz = dx, dy, dz
        else:
            ox, oy, oz = quat_rotate_comp(-qx, -qy, -qz, qw, px - cx, py - cy, pz - cz)
            rdx, rdy, rdz = quat_rotate_comp(-qx, -qy, -qz, qw, dx, dy, dz)
        dist, nx, ny, nz = ray_collider(table, ci, ox, oy, oz, rdx, rdy, rdz)
        dist = torch.where((lane_mask & layers[ci]) != 0, dist, BIG)
        if not table.identity_rot[ci]:
            nx, ny, nz = quat_rotate_comp(qx, qy, qz, qw, nx, ny, nz)
        closer = (dist <= max_dist) & (dist < best)
        bnx = torch.where(closer, nx, bnx)
        bny = torch.where(closer, ny, bny)
        bnz = torch.where(closer, nz, bnz)
        best = torch.where(closer, dist, best)
    hit = best <= max_dist
    return hit, torch.where(hit, best, 0.0), bnx, bny, bnz


def bounding_radius(kind: int, p0, p1, p2, sqrt=np.sqrt):
    """The broad phase's bounding-sphere radius about a collider's position
    (the JAX kernel's, `_collide_tile` :496-505), in f32 operations on its
    params (numpy float32 scalars, or 0-d tensors with sqrt=torch.sqrt): a
    sphere's radius, a cuboid's half-diagonal, a capsule's radius plus half
    segment, a hull's precomputed radius, a cylinder's or cone's
    sqrt(p0^2 + p1^2). A halfspace has none: 0."""
    if kind in (COLLIDER_SPHERE, COLLIDER_HULL):
        return p0
    if kind == COLLIDER_CUBOID:
        return sqrt(p0 * p0 + p1 * p1 + p2 * p2)
    if kind == COLLIDER_CAPSULE:
        return p0 + p1
    if kind in (COLLIDER_CYLINDER, COLLIDER_CONE):
        return sqrt(p0 * p0 + p1 * p1)
    return p0 * 0


def broad_phase_keep(table: ColliderTable, px, py, pz, max_dist, active, group: int = 32) -> torch.Tensor:
    """The kernel's broad phase in plain PyTorch: per `group`-lane group (a
    warp: 32 consecutive lanes) and collider, whether the substep tests the
    collider: [ceil(N / group), C] bool. The group's box is the AABB of its
    `active` lanes (a lane's NaN coordinate stays out of it, as fminf leaves
    it); its reach the longest active max_dist (NaN left out) times
    REACH_SCALE plus REACH_MARGIN. A collider is kept when the group has an
    active lane, its masked layers are not 0 and its bounding volume comes
    within reach of the box: a halfspace by the box's support distance to
    its plane (an unrotated one by min y less the plane's y), the other
    kinds by the distance from their position to the box's closest point
    against bounding_radius + reach. A comparison that meets NaN keeps the
    collider. The same f32 operations as the kernel's; the tests and
    chip_smoke use it."""
    n = px.shape[0]
    g = -(-n // group)
    dev = px.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    inf, zero, one, half = f32(float("inf")), f32(0.0), f32(1.0), f32(0.5)
    pad = g * group - n

    def fold(v, fill, op):
        w = torch.where(active & ~torch.isnan(v), v, fill)
        return op(torch.cat([w, fill.expand(pad)]).view(g, group), dim=1)

    mnx, mny, mnz = (fold(v, inf, torch.amin) for v in (px, py, pz))
    mxx, mxy, mxz = (fold(v, -inf, torch.amax) for v in (px, py, pz))
    reach = fold(max_dist, zero, torch.amax) * f32(REACH_SCALE) + f32(REACH_MARGIN)
    any_active = torch.cat([active, torch.zeros(pad, dtype=torch.bool, device=dev)]).view(g, group).any(1)
    layers = masked_layers(table)
    keep = []
    for ci in range(table.count):
        cx, cy, cz = table.position[ci, 0], table.position[ci, 1], table.position[ci, 2]
        kind = table.kinds[ci]
        if kind == COLLIDER_HALFSPACE and table.identity_rot[ci]:
            far = (mny - cy) > reach
        elif kind == COLLIDER_HALFSPACE:
            qx, qy, qz, qw = (table.rotation[ci, j] for j in range(4))
            nx, ny, nz = quat_rotate_comp(qx, qy, qz, qw, zero, one, zero)
            signed = ((mnx + mxx) * half - cx) * nx + ((mny + mxy) * half - cy) * ny + ((mnz + mxz) * half - cz) * nz
            support = nx.abs() * ((mxx - mnx) * half) + ny.abs() * ((mxy - mny) * half) + nz.abs() * ((mxz - mnz) * half)
            far = (signed - support) > reach
        else:
            radius = bounding_radius(kind, *(table.params[ci, j] for j in range(3)), sqrt=torch.sqrt)
            d2 = zero
            for c, lo, hi in ((cx, mnx, mxx), (cy, mny, mxy), (cz, mnz, mxz)):
                q = torch.where(c < lo, lo, c)
                q = torch.where(q > hi, hi, q)  # the kernel's clampf
                d2 = d2 + (c - q) * (c - q)
            rr = radius + reach
            far = d2 > rr * rr
        keep.append(any_active & (layers[ci] != 0) & ~far)
    if not keep:
        return torch.zeros((g, 0), dtype=torch.bool, device=dev)
    return torch.stack(keep, 1)


_substep_log = None  # the list `record_substeps` fills, or None


@contextlib.contextmanager
def record_substeps():
    """Within the block, every particle_collision substep appends its ray
    inputs before its raycast to the yielded list, a dict of px, py, pz,
    dx, dy, dz, max_dist, active (the substep's lane_active) and lane_mask:
    `broad_phase_keep`'s inputs for a frame's substeps (the skip share that
    chip_smoke reports, the winners the tests hold it to). Records only;
    no result changes."""
    global _substep_log
    _substep_log = []
    try:
        yield _substep_log
    finally:
        _substep_log = None


def particle_collision(table: ColliderTable, px, py, pz, vx, vy, vz, dt, restitution, friction, destroy_flag,
                       lane_mask, participating=None):
    """`particle_collision` (reference `src/core.rs:744-800`) on [N] lanes.
    restitution/friction/destroy_flag are per-lane f32, lane_mask per-lane
    int64 (uint32 bits), dt a 0-d tensor. Only `participating` lanes (all,
    when None) get a travel budget; the others come back unchanged.
    Returns (px, py, pz, vx, vy, vz, destroyed)."""
    dt = torch.as_tensor(dt, dtype=torch.float32).to(px.device)
    delta = dt.expand_as(px) if participating is None else torch.where(participating, dt, 0.0)
    destroyed = torch.zeros_like(px, dtype=torch.bool)
    done = torch.zeros_like(px, dtype=torch.bool)
    for _ in range(SUBSTEPS):
        lane_active = ~done & (delta > 0.0)
        speed2 = vx * vx + vy * vy + vz * vz
        speed = torch.sqrt(speed2)
        # Dir3::try_from(vel): unit direction; zero -> +Y
        ok = speed2 > 0.0
        inv = torch.where(ok, 1.0 / torch.where(speed > 0, speed, 1.0), 0.0)
        dx = torch.where(ok, vx * inv, 0.0)
        dy = torch.where(ok, vy * inv, 1.0)
        dz = torch.where(ok, vz * inv, 0.0)
        max_dist = speed * delta
        if _substep_log is not None:
            _substep_log.append(dict(px=px, py=py, pz=pz, dx=dx, dy=dy, dz=dz, max_dist=max_dist,
                                     active=lane_active, lane_mask=lane_mask))
        hit, dist, nx, ny, nz = raycast_scene(table, lane_mask, px, py, pz, dx, dy, dz, max_dist)
        hit = hit & lane_active
        dist = torch.where(hit, dist, 0.0)
        inside = hit & (dist == 0.0)
        surface = hit & (dist > 0.0)
        miss = lane_active & ~hit

        # inside: push out along the normal (zero-normal fallbacks, core.rs:766-775)
        n_zero = (nx == 0.0) & (ny == 0.0) & (nz == 0.0)
        fnx = torch.where(n_zero, torch.where(ok, dx, 0.0), nx)
        fny = torch.where(n_zero, torch.where(ok, dy, 1.0), ny)
        fnz = torch.where(n_zero, torch.where(ok, dz, 0.0), nz)
        push = torch.clamp_min(speed, 1.0) * delta
        px = torch.where(inside, px + push * fnx, px)
        py = torch.where(inside, py + push * fny, py)
        pz = torch.where(inside, pz + push * fnz, pz)

        # surface hit: advance, bounce (core.rs:776-787)
        px_s, py_s, pz_s = px + dx * dist, py + dy * dist, pz + dz * dist
        vdotn = vx * nx + vy * ny + vz * nz
        pjx, pjy, pjz = vdotn * nx, vdotn * ny, vdotn * nz  # projection on the unit normal
        rjx, rjy, rjz = vx - pjx, vy - pjy, vz - pjz  # rejection
        rej_len2 = rjx * rjx + rjy * rjy + rjz * rjz
        rej_len = torch.sqrt(rej_len2)
        friction_dv = torch.minimum(vdotn.abs(), rej_len) * friction
        rinv = torch.where(rej_len2 > 0, 1.0 / torch.where(rej_len > 0, rej_len, 1.0), 0.0)
        nvx = rjx - friction_dv * rjx * rinv - restitution * pjx
        nvy = rjy - friction_dv * rjy * rinv - restitution * pjy
        nvz = rjz - friction_dv * rjz * rinv - restitution * pjz
        px = torch.where(surface, px_s + nx * 1e-4, px)
        py = torch.where(surface, py_s + ny * 1e-4, py)
        pz = torch.where(surface, pz_s + nz * 1e-4, pz)
        vx = torch.where(surface, nvx, vx)
        vy = torch.where(surface, nvy, vy)
        vz = torch.where(surface, nvz, vz)
        delta = torch.where(surface, torch.minimum(torch.clamp_min(delta - dist, 0.0), dt), delta)

        # destroy-on-collision: freeze the lane (core.rs:788-791)
        kill = hit & (destroy_flag > 0.0)
        destroyed = destroyed | kill
        done = done | kill

        # miss: advect and finish (core.rs:792-795)
        px = torch.where(miss, px + vx * delta, px)
        py = torch.where(miss, py + vy * delta, py)
        pz = torch.where(miss, pz + vz * delta, pz)
        delta = torch.where(miss, 0.0, delta)
    return px, py, pz, vx, vy, vz, destroyed
