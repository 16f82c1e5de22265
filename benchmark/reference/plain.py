"""The plain reference: the particle step written out in PyTorch and numpy,
independent of the code under test.

It reads a benchmark configuration file (the spawner in the upstream
project's serde form, its colliders, rate, capacity and transform) and
steps a pool of lanes frame by frame with the semantics of bevy_firework's
`ParticleSpawner` update (spawn by the emission cadence, age and cull,
move, bounce off colliders in up to four substeps, gravity and drag), in
the lane layout of the port's kernels:

  * the frame-key chain is threefry-2x32 (20 rounds), key i of a split is
    threefry2x32(key, (0, i)); each frame draws with word 0 of its frame
    key as the Philox-4x32-10 key, counter (lane, block, 0, 0), and a
    uniform keeps the top 24 bits of a word;
  * a spawn claims the ring window [cursor, cursor + n) mod N of dead
    lanes; emitter e takes the ranks [S_{e-1}, S_e) of the frame's
    cumulative counts;
  * alive is age < lifetime.

Every expression is one IEEE f32 operation in a fixed order, so the
reference computed in float32 agrees with a correct step up to the
rounding of sinf and cosf. `dtype=torch.bfloat16` computes every float of
the lane math in bfloat16 instead (the cadence's scalars stay float32): the
benchmark's control.

Scope: one particle type with a constant lifetime and no rotation, global
emitters with count-over-duration pacing, and halfspace, sphere or cuboid
colliders without destroy-on-collision; anything else raises ValueError.
Nothing here imports the program under test.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
F32 = np.float32
TWO_PI = float(F32(2.0 * np.pi))
PI = float(F32(np.pi))
BIG = float(F32(1e30))
EPS = float(F32(1e-12))
SUBSTEPS = 4
CHUNK = 1 << 21  # lanes stepped at a time

SHAPES = {"point": 0, "sphere": 1, "circle": 2, "box": 3, "ring": 4}
CURVES = {"constant": 0, "even": 1, "uneven": 2}
HALFSPACE, SPHERE, CUBOID = 0, 1, 2
COLLIDER_KINDS = {"halfspace": HALFSPACE, "sphere": SPHERE, "cuboid": CUBOID}
LANE_FIELDS = ("px", "py", "pz", "vx", "vy", "vz", "initial_scale", "age", "lifetime")
N_DRAWS = 8  # 3 shape + 3 velocity + 1 radial + 1 scale


# ---------------------------------------------------------------- threefry

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0: int, k1: int, x0: int, x1: int) -> tuple:
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def key_chain(key: tuple, n: int) -> tuple:
    """n frames of the key chain from `key` (two uint32 words): the key
    after them and each frame's draw seed."""
    k0, k1 = (int(v) & MASK32 for v in key)
    seeds = []
    for _ in range(n):
        seeds.append(threefry2x32(k0, k1, 0, 1)[0])
        k0, k1 = threefry2x32(k0, k1, 0, 0)
    return (k0, k1), seeds


# ------------------------------------------------------------------ philox

_PM0, _PM1, _PW0, _PW1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85


def _mulhilo(m: int, x: torch.Tensor):
    p_lo = (x & 0xFFFF) * m
    p_hi = (x >> 16) * m
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    for r in range(10):
        if r:
            k0 = (k0 + _PW0) & MASK32
            k1 = (k1 + _PW1) & MASK32
        hi0, lo0 = _mulhilo(_PM0, c0)
        hi1, lo1 = _mulhilo(_PM1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def lane_uniforms(seed: int, lanes: torch.Tensor, n: int) -> list:
    """n float32 uniforms in [0, 1) per lane (int64 lane indices)."""
    out = []
    zero = torch.zeros_like(lanes)
    for b in range((n + 3) // 4):
        out.extend(philox4x32(lanes, torch.full_like(lanes, b), zero, zero, int(seed) & MASK32, 0))
    scale = float(F32(1.0 / (1 << 24)))
    return [(w >> 8).to(torch.float32) * scale for w in out[:n]]


# ------------------------------------------------------- quaternions, f32

def quat_rotate(qx, qy, qz, qw, vx, vy, vz):
    tx = 2.0 * (qy * vz - qz * vy)
    ty = 2.0 * (qz * vx - qx * vz)
    tz = 2.0 * (qx * vy - qy * vx)
    return (vx + qw * tx + (qy * tz - qz * ty), vy + qw * ty + (qz * tx - qx * tz),
            vz + qw * tz + (qx * ty - qy * tx))


def np_arc(src, dst) -> np.ndarray:
    """glam `Quat::from_rotation_arc` in float32 (unit vectors)."""
    src, dst = np.asarray(src, F32), np.asarray(dst, F32)
    d = float(np.dot(src, dst))
    if d > 1.0 - 1e-6:
        return np.array([0, 0, 0, 1], F32)
    if d < -1.0 + 1e-6:
        v = src
        if abs(v[0]) <= abs(v[1]) and abs(v[0]) <= abs(v[2]):
            o = np.array([0.0, -v[2], v[1]], F32)
        elif abs(v[1]) <= abs(v[2]):
            o = np.array([-v[2], 0.0, v[0]], F32)
        else:
            o = np.array([-v[1], v[0], 0.0], F32)
        o = (o / np.linalg.norm(o)).astype(F32)
        return np.array([o[0], o[1], o[2], 0.0], F32)
    c = np.cross(src, dst)
    q = np.array([c[0], c[1], c[2], 1.0 + d], F32)
    return (q / np.linalg.norm(q)).astype(F32)


def _unit_or_up(v) -> np.ndarray:
    v = np.asarray(v, F32)
    n = np.linalg.norm(v)
    return v / n if n > 0 else np.array([0, 1, 0], F32)


# ------------------------------------------------------------ the config

@dataclasses.dataclass(frozen=True)
class Emitter:
    count: float
    duration: float
    off_start: float
    off_end: float
    shape: np.ndarray  # f32[8]: kind, radius, arc quaternion (+Y -> normal), box extents y, z
    ivel: np.ndarray  # f32[7]: magnitude lo, hi, spread, arc quaternion (+Y -> direction)
    radial: tuple
    inherit: float


@dataclasses.dataclass(frozen=True)
class Curve:
    kind: int
    ts: np.ndarray  # f32[n]
    vs: np.ndarray  # f32[n] or [n, 4]


@dataclasses.dataclass(frozen=True)
class Collider:
    kind: int
    position: tuple
    rotation: tuple
    params: tuple
    layers: int

    @property
    def identity(self) -> bool:
        return tuple(self.rotation) == (0.0, 0.0, 0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class Config:
    """What the reference needs of a benchmark configuration."""

    capacity: int
    lifetime: float
    initial_scale: tuple
    acceleration: tuple
    linear_drag: float
    scale_curve: Curve
    base_color: Curve
    emissive_color: Curve
    emitters: tuple
    collision: object  # None, or (restitution, friction, filter mask)
    colliders: tuple
    translation: tuple
    rotation: tuple


def _curve(d: dict, channels: int) -> Curve:
    kind = CURVES[d["kind"]]
    vs = np.asarray(d["vs"], F32)
    n = vs.shape[0]
    if channels and vs.ndim == 1:
        vs = np.broadcast_to(vs[:, None], (n, channels)).copy()
    ts = np.array([i / (n - 1) for i in range(n)], F32) if kind == CURVES["even"] else np.asarray(d["ts"], F32)
    return Curve(kind, ts, vs)


def parse_config(cfg: dict) -> Config:
    """The reference's reading of a benchmark configuration file."""
    sp = cfg["spawner"]
    if len(sp["particle_settings"]) != 1:
        raise ValueError("the reference steps one particle type")
    if sp["spawn_transform_mode"] != "global":
        raise ValueError("the reference spawns in the global transform")
    if not sp["starts_enabled"]:
        raise ValueError("the reference's spawners start enabled")
    p = sp["particle_settings"][0]
    if p["lifetime"]["min"] != p["lifetime"]["max"]:
        raise ValueError("the reference takes a constant lifetime")
    if any(v != 0.0 for v in p["angular_acceleration"]):
        raise ValueError("the reference takes no rotation")
    emitters = []
    for e in sp["emission_settings"]:
        ep = e["emission_pacing"]
        if ep["kind"] != "count_over_duration" or e["emission_mode"]["kind"] != "global":
            raise ValueError("the reference takes global count-over-duration emitters")
        if tuple(e["initial_rotation"]) != (0.0, 0.0, 0.0, 1.0) or any(
                e["initial_angular_velocity"]["magnitude"][k] != 0.0 for k in ("min", "max")):
            raise ValueError("the reference takes no rotation")
        if e["particle_index"] != 0:
            raise ValueError("the reference steps one particle type")
        sh = e["emission_shape"]
        q = np_arc([0, 1, 0], _unit_or_up(sh.get("normal", (0, 1, 0))))
        ext = sh.get("extents", (0.0, 0.0))
        shape = np.array([SHAPES[sh["kind"]], sh.get("radius", 0.0), *q, ext[0], ext[1]], F32)
        iv = e["initial_velocity"]
        qv = np_arc([0, 1, 0], _unit_or_up(iv["direction"]))
        ivel = np.array([iv["magnitude"]["min"], iv["magnitude"]["max"], iv["spread"], *qv], F32)
        rad = e["initial_velocity_radial"]
        emitters.append(Emitter(float(F32(ep["count"])), float(F32(ep["duration"])), float(F32(ep["offset_start"])),
                                float(F32(ep["offset_end"])), shape, ivel,
                                (float(F32(rad["min"])), float(F32(rad["max"]))),
                                1.0 if e["inherit_parent_velocity"] else 0.0))
    cs = p.get("collision_settings")
    collision = None
    if cs is not None:
        if cs["destroy_on_collision"]:
            raise ValueError("the reference takes no destroy-on-collision")
        collision = (float(F32(cs["restitution"])), float(F32(cs["friction"])), int(cs.get("filter_mask", MASK32)))
    cols = []
    for c in cfg.get("colliders", ()):
        if c["kind"] not in COLLIDER_KINDS:
            raise ValueError(f"the reference takes halfspace, sphere and cuboid colliders, not {c['kind']}")
        cols.append(Collider(COLLIDER_KINDS[c["kind"]], tuple(float(F32(v)) for v in c["position"]),
                             tuple(float(F32(v)) for v in c["rotation"]),
                             tuple(float(F32(v)) for v in c["params"]), int(c.get("layers", MASK32))))
    tf = cfg["transform"]
    return Config(capacity=int(cfg["capacity"]), lifetime=float(F32(p["lifetime"]["min"])),
                  initial_scale=(float(F32(p["initial_scale"]["min"])), float(F32(p["initial_scale"]["max"]))),
                  acceleration=tuple(float(F32(v)) for v in p["acceleration"]),
                  linear_drag=float(F32(p["linear_drag"])),
                  scale_curve=_curve(p["scale_curve"], 0), base_color=_curve(p["base_color"], 4),
                  emissive_color=_curve(p["emissive_color"], 4), emitters=tuple(emitters),
                  collision=collision if cols else None, colliders=tuple(cols),
                  translation=tuple(float(F32(v)) for v in tf["translation"]),
                  rotation=tuple(float(F32(v)) for v in tf["rotation"]))


@dataclasses.dataclass(frozen=True)
class Frame:
    """One frame's inputs (float32 values)."""

    dt: float
    translation: tuple
    rotation: tuple = (0.0, 0.0, 0.0, 1.0)
    parent_velocity: tuple = (0.0, 0.0, 0.0)
    modifier_scale: float = 1.0
    modifier_speed: float = 1.0


def initial_state(cfg: Config, seed: int, device) -> dict:
    """A fresh pool: every lane dead (age == lifetime == the constant), the
    cadence at zero, the key (0, seed mod 2^32)."""
    n, e = cfg.capacity, len(cfg.emitters)
    f32 = dict(dtype=torch.float32, device=device)
    st = {k: torch.zeros(n, **f32) for k in ("px", "py", "pz", "vx", "vy", "vz", "initial_scale")}
    st["age"] = torch.full((n,), cfg.lifetime, **f32)
    st["lifetime"] = torch.full((n,), cfg.lifetime, **f32)
    st.update(time_in_cycle=np.zeros(e, F32), last_emission=np.zeros(e, F32), ring_cursor=0,
              rng_key=(0, int(seed) & MASK32))
    return st


# --------------------------------------------------------------- cadence

def _trunc_rem(a, b):
    return a - torch.trunc(a / b) * b


def _rem_euclid(a, b):
    r = _trunc_rem(a, b)
    return torch.where(r < 0, r + torch.abs(b), r)


def _div_euclid(a, b):
    q = torch.trunc(a / b)
    r = _trunc_rem(a, b)
    return torch.where(r < 0, torch.where(b > 0, q - 1, q + 1), q)


def cadence(cfg: Config, tic: np.ndarray, last: np.ndarray, cursor: int, dt: float, n: int) -> list:
    """n frames of the emission cadence on the host: per frame (ring
    cursor before the frame, cumulative spawn bounds), then the final
    (time_in_cycle, last_emission, cursor). The reference's
    `compute_emission_count` (bevy_firework `core.rs:553-575`) with Rust's
    div_euclid and rem_euclid, in float32."""
    def s(v):
        return torch.tensor(v, dtype=torch.float32)

    tic = [s(float(v)) for v in tic]
    last = [s(float(v)) for v in last]
    dt_t = torch.tensor(float(F32(dt)), dtype=torch.float32)
    frames = []
    for _ in range(n):
        bounds = [0]
        for e, em in enumerate(cfg.emitters):
            dur, ostart, oend, cnt = s(em.duration), s(em.off_start), s(em.off_end), s(em.count)
            t = _rem_euclid(tic[e] + dt_t, dur)
            pct = t / dur
            clamped = torch.maximum(last[e] / dur, ostart)
            since = torch.minimum(pct, oend) - clamped
            between = (oend - ostart) / cnt
            times = _div_euclid(since, between)
            count = int(torch.clamp_min(times, 0.0).to(torch.int32))
            last[e] = (clamped + times * between) * dur
            tic[e] = t
            bounds.append(bounds[-1] + count)
        frames.append((cursor, bounds))
        cursor = (cursor + bounds[-1]) % cfg.capacity
    final = (np.array([float(v) for v in tic], F32), np.array([float(v) for v in last], F32), cursor)
    return frames, final


# ---------------------------------------------------------- lane math

def _sample_shape(row, u0, u1, u2):
    kind, radius = int(row[0]), float(row[1])
    u = u0 * TWO_PI
    v = u1 * PI
    rr = u2 * radius
    cu, su = torch.cos(u), torch.sin(u)
    zero = torch.zeros_like(u0)
    if kind == SHAPES["point"]:
        return zero, zero, zero
    if kind == SHAPES["sphere"]:
        return -torch.sin(v) * cu * rr, su * rr, -torch.cos(v) * cu * rr
    if kind == SHAPES["circle"]:
        lx, ly, lz = rr * cu, zero, -rr * su
    elif kind == SHAPES["ring"]:
        lx, ly, lz = radius * cu, zero, -radius * su
    else:  # box
        lx, ly, lz = (u0 * 2.0 - 1.0) * radius, (u1 * 2.0 - 1.0) * float(row[6]), (u2 * 2.0 - 1.0) * float(row[7])
    return quat_rotate(*(float(x) for x in row[2:6]), lx, ly, lz)


def _sample_vec3(row, um, ud, ua):
    lo, hi = float(row[0]), float(row[1])
    mag = lo + (hi - lo) * um
    a = ud * float(row[2])
    b = ua * TWO_PI
    sa, ca = torch.sin(a), torch.cos(a)
    dx, dy, dz = quat_rotate(*(float(x) for x in row[3:7]), sa * torch.cos(b), ca, -sa * torch.sin(b))
    return mag * dx, mag * dy, mag * dz


def _segment(ts, kind, t):
    n = ts.shape[0]
    if kind == CURVES["even"]:
        x = torch.clamp(t, 0.0, 1.0) * float(n - 1)
        i = torch.clamp(torch.floor(x), 0.0, float(n - 2))
        return [i == k for k in range(1, n - 1)], x - i
    tun = torch.clamp(t, float(ts[0]), float(ts[n - 1]))
    i = torch.zeros_like(t)
    for k in range(1, n - 1):
        i = i + (tun >= float(ts[k])).to(t.dtype)
    sels = [i == k for k in range(1, n - 1)]
    t0 = torch.full_like(t, float(ts[0]))
    t1 = torch.full_like(t, float(ts[1]))
    for k, sel in zip(range(1, n - 1), sels):
        t0 = torch.where(sel, float(ts[k]), t0)
        t1 = torch.where(sel, float(ts[k + 1]), t1)
    return sels, (tun - t0) / (t1 - t0)


def eval_curve(c: Curve, t: torch.Tensor, channel=None) -> torch.Tensor:
    vs = c.vs if channel is None else c.vs[:, channel]
    if c.kind == CURVES["constant"]:
        return torch.full_like(t, float(vs[0]))
    sels, frac = _segment(c.ts, c.kind, t)
    v0 = torch.full_like(t, float(vs[0]))
    v1 = torch.full_like(t, float(vs[1]))
    for k, sel in enumerate(sels, start=1):
        v0 = torch.where(sel, float(vs[k]), v0)
        v1 = torch.where(sel, float(vs[k + 1]), v1)
    return v0 + (v1 - v0) * frac


def _ray_halfspace(ox, oy, oz, dx, dy, dz, p):
    inside = oy <= 0.0
    t = -oy / _signed_eps(dy)
    hit = (dy < 0.0) & (t >= 0.0)
    dist = torch.where(inside, 0.0, torch.where(hit, t, BIG))
    zero = torch.zeros_like(ox)
    return dist, zero, torch.where(inside, 0.0, 1.0), zero


def _signed_eps(d):
    return torch.where(d.abs() < EPS, torch.where(d < 0, -EPS, EPS), d)


def _normalize_or_zero(vx, vy, vz):
    l2 = vx * vx + vy * vy + vz * vz
    inv = torch.where(l2 > 0, 1.0 / torch.sqrt(l2), 0.0)
    return vx * inv, vy * inv, vz * inv


def _ray_sphere(ox, oy, oz, dx, dy, dz, p):
    r = p[0]
    c = ox * ox + oy * oy + oz * oz - r * r
    inside = c <= 0.0
    b = ox * dx + oy * dy + oz * dz
    disc = b * b - c
    t = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
    valid = (disc >= 0.0) & (t >= 0.0)
    dist = torch.where(inside, 0.0, torch.where(valid, t, BIG))
    nx, ny, nz = _normalize_or_zero(ox + t * dx, oy + t * dy, oz + t * dz)
    return dist, torch.where(inside, 0.0, nx), torch.where(inside, 0.0, ny), torch.where(inside, 0.0, nz)


def _ray_cuboid(ox, oy, oz, dx, dy, dz, p):
    hx, hy, hz = p
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
    is_x = tmin == tx0
    is_y = ~is_x & (tmin == ty0)
    nx = torch.where(is_x, -torch.sign(dx), 0.0)
    ny = torch.where(is_y, -torch.sign(dy), 0.0)
    nz = torch.where(is_x | is_y, 0.0, -torch.sign(dz))
    return dist, torch.where(inside, 0.0, nx), torch.where(inside, 0.0, ny), torch.where(inside, 0.0, nz)


_RAYS = {HALFSPACE: _ray_halfspace, SPHERE: _ray_sphere, CUBOID: _ray_cuboid}


def _raycast(cols, lane_mask: int, px, py, pz, dx, dy, dz, max_dist):
    """Nearest solid hit over the colliders in order (the first wins a
    tie); colliders sharing no layer bit with the lane's mask are skipped."""
    best = torch.full_like(px, BIG)
    bnx, bny, bnz = torch.zeros_like(px), torch.zeros_like(px), torch.zeros_like(px)
    for c in cols:
        cx, cy, cz = c.position
        qx, qy, qz, qw = c.rotation
        if c.identity:
            ox, oy, oz, rdx, rdy, rdz = px - cx, py - cy, pz - cz, dx, dy, dz
        else:
            ox, oy, oz = quat_rotate(-qx, -qy, -qz, qw, px - cx, py - cy, pz - cz)
            rdx, rdy, rdz = quat_rotate(-qx, -qy, -qz, qw, dx, dy, dz)
        dist, nx, ny, nz = _RAYS[c.kind](ox, oy, oz, rdx, rdy, rdz, c.params)
        if not (lane_mask & c.layers):
            dist = torch.full_like(dist, BIG)
        if not c.identity:
            nx, ny, nz = quat_rotate(qx, qy, qz, qw, nx, ny, nz)
        closer = (dist <= max_dist) & (dist < best)
        bnx, bny, bnz = torch.where(closer, nx, bnx), torch.where(closer, ny, bny), torch.where(closer, nz, bnz)
        best = torch.where(closer, dist, best)
    hit = best <= max_dist
    return hit, torch.where(hit, best, 0.0), bnx, bny, bnz


def _collide(cols, collision, px, py, pz, vx, vy, vz, dt, participating):
    """bevy_firework's substepped raycast-and-bounce (`core.rs:744-800`):
    up to four substeps of the remaining travel; a ray that starts inside
    pushes out along the normal, a hit advances to the surface and
    bounces (friction against the tangent, restitution along the normal,
    1e-4 off the surface), a miss advects and ends."""
    restitution, friction, mask = collision
    delta = torch.where(participating, dt, torch.zeros_like(px))
    done = torch.zeros_like(px, dtype=torch.bool)
    for _ in range(SUBSTEPS):
        active = ~done & (delta > 0.0)
        speed2 = vx * vx + vy * vy + vz * vz
        speed = torch.sqrt(speed2)
        ok = speed2 > 0.0
        inv = torch.where(ok, 1.0 / torch.where(speed > 0, speed, 1.0), 0.0)
        dx, dy, dz = torch.where(ok, vx * inv, 0.0), torch.where(ok, vy * inv, 1.0), torch.where(ok, vz * inv, 0.0)
        hit, dist, nx, ny, nz = _raycast(cols, mask, px, py, pz, dx, dy, dz, speed * delta)
        hit = hit & active
        dist = torch.where(hit, dist, 0.0)
        inside = hit & (dist == 0.0)
        surface = hit & (dist > 0.0)
        miss = active & ~hit
        n_zero = (nx == 0.0) & (ny == 0.0) & (nz == 0.0)
        fnx = torch.where(n_zero, torch.where(ok, dx, 0.0), nx)
        fny = torch.where(n_zero, torch.where(ok, dy, 1.0), ny)
        fnz = torch.where(n_zero, torch.where(ok, dz, 0.0), nz)
        push = torch.clamp_min(speed, 1.0) * delta
        px = torch.where(inside, px + push * fnx, px)
        py = torch.where(inside, py + push * fny, py)
        pz = torch.where(inside, pz + push * fnz, pz)
        sx, sy, sz = px + dx * dist, py + dy * dist, pz + dz * dist
        vdotn = vx * nx + vy * ny + vz * nz
        pjx, pjy, pjz = vdotn * nx, vdotn * ny, vdotn * nz
        rjx, rjy, rjz = vx - pjx, vy - pjy, vz - pjz
        rl2 = rjx * rjx + rjy * rjy + rjz * rjz
        rl = torch.sqrt(rl2)
        fdv = torch.minimum(vdotn.abs(), rl) * friction
        rinv = torch.where(rl2 > 0, 1.0 / torch.where(rl > 0, rl, 1.0), 0.0)
        nvx = rjx - fdv * rjx * rinv - restitution * pjx
        nvy = rjy - fdv * rjy * rinv - restitution * pjy
        nvz = rjz - fdv * rjz * rinv - restitution * pjz
        px = torch.where(surface, sx + nx * 1e-4, px)
        py = torch.where(surface, sy + ny * 1e-4, py)
        pz = torch.where(surface, sz + nz * 1e-4, pz)
        vx, vy, vz = torch.where(surface, nvx, vx), torch.where(surface, nvy, vy), torch.where(surface, nvz, vz)
        delta = torch.where(surface, torch.minimum(torch.clamp_min(delta - dist, 0.0), dt), delta)
        px = torch.where(miss, px + vx * delta, px)
        py = torch.where(miss, py + vy * delta, py)
        pz = torch.where(miss, pz + vz * delta, pz)
        delta = torch.where(miss, 0.0, delta)
    return px, py, pz, vx, vy, vz


def _frame(cfg: Config, f: dict, lanes: torch.Tensor, cursor: int, bounds: list, seed: int, fr: Frame,
           dtype) -> dict:
    """One frame of one block of lanes: spawn into the claimed ring window,
    then update (`core.rs:594-650`)."""
    n = cfg.capacity
    c = dtype
    life = torch.full((), cfg.lifetime, dtype=c, device=lanes.device)
    dt = torch.tensor(float(F32(fr.dt)), dtype=torch.float32).to(c).to(lanes.device)
    alive0 = f["age"] < life
    rank = torch.remainder(lanes - cursor, n)
    spawned = ~alive0 & (rank < bounds[-1])
    u = [x.to(c) for x in lane_uniforms(seed, lanes, N_DRAWS)]
    f = dict(f)
    tx, ty, tz = fr.translation
    qx, qy, qz, qw = fr.rotation
    for e, em in enumerate(cfg.emitters):
        m = spawned & (rank >= bounds[e]) & (rank < bounds[e + 1])
        offx, offy, offz = _sample_shape(em.shape, u[0], u[1], u[2])
        ivx, ivy, ivz = _sample_vec3(em.ivel, u[3], u[4], u[5])
        radial = em.radial[0] + (em.radial[1] - em.radial[0]) * u[6]
        l2 = offx * offx + offy * offy + offz * offz
        inv = torch.where(l2 > 0, 1.0 / torch.sqrt(l2), torch.zeros_like(l2))
        wvx, wvy, wvz = quat_rotate(qx, qy, qz, qw, ivx, ivy, ivz)
        spd, inh = fr.modifier_speed, em.inherit
        pv = fr.parent_velocity
        new = {"px": tx + offx, "py": ty + offy, "pz": tz + offz,
               "vx": spd * (wvx + offx * inv * radial) + inh * pv[0],
               "vy": spd * (wvy + offy * inv * radial) + inh * pv[1],
               "vz": spd * (wvz + offz * inv * radial) + inh * pv[2],
               "initial_scale": (cfg.initial_scale[0] + (cfg.initial_scale[1] - cfg.initial_scale[0]) * u[7])
               * fr.modifier_scale,
               "age": torch.zeros_like(u[0])}
        for k, v in new.items():
            f[k] = torch.where(m, v, f[k])
    alive = alive0 | spawned
    age_new = f["age"] + dt
    moved = alive & ~(age_new >= life)
    px, py, pz, vx, vy, vz = (f[k] for k in ("px", "py", "pz", "vx", "vy", "vz"))
    npx, npy, npz = px + vx * dt, py + vy * dt, pz + vz * dt
    nvx, nvy, nvz = vx, vy, vz
    if cfg.collision is not None:
        npx, npy, npz, nvx, nvy, nvz = _collide(cfg.colliders, cfg.collision, px, py, pz, vx, vy, vz, dt, moved)
    ax, ay, az = cfg.acceleration
    drag = cfg.linear_drag
    dvx = nvx + (ax - nvx * drag) * dt
    dvy = nvy + (ay - nvy * drag) * dt
    dvz = nvz + (az - nvz * drag) * dt
    f["age"] = torch.where(alive, age_new, f["age"])
    f["px"], f["py"], f["pz"] = torch.where(moved, npx, px), torch.where(moved, npy, py), torch.where(moved, npz, pz)
    f["vx"] = torch.where(moved, dvx, vx)
    f["vy"] = torch.where(moved, dvy, vy)
    f["vz"] = torch.where(moved, dvz, vz)
    return f


def render_planes(cfg: Config, f: dict) -> list:
    """The render pack's 9 float32 planes of a stepped block: instance
    scale (0 on dead lanes), base rgba, emissive rgba, each lane's curves
    at age / lifetime."""
    life = torch.full((), cfg.lifetime, dtype=f["age"].dtype, device=f["age"].device)
    pct = f["age"] / life
    scale = f["initial_scale"] * eval_curve(cfg.scale_curve, pct)
    inst = torch.where(f["age"] < life, scale, 0.0)
    base = [eval_curve(cfg.base_color, pct, ch) for ch in range(4)]
    emis = [eval_curve(cfg.emissive_color, pct, ch) for ch in range(4)]
    return [inst, *base, *emis]


def stats(cfg: Config, f: dict) -> dict:
    """The frame's stats over the live lanes: their count and the AABB of
    position +- scale (bevy_firework `render.rs:677-703`)."""
    life = torch.full((), cfg.lifetime, dtype=f["age"].dtype, device=f["age"].device)
    alive = f["age"] < life
    scale = f["initial_scale"] * eval_curve(cfg.scale_curve, f["age"] / life)
    lo = [float(torch.where(alive, f[c] - scale, math.inf).min()) for c in ("px", "py", "pz")]
    hi = [float(torch.where(alive, f[c] + scale, -math.inf).max()) for c in ("px", "py", "pz")]
    return {"alive_count": int(alive.sum()), "aabb": lo + hi}


def run_frames(cfg: Config, state: dict, frame, n: int, dtype=torch.float32, pack: bool = False,
               chunk: int = CHUNK, ranges=None):
    """n frames from `state` (the lane planes of LANE_FIELDS on one device,
    the host scalars time_in_cycle, last_emission, ring_cursor and the key
    words rng_key); `frame` is one Frame for every frame or a sequence of n
    (one dt). Returns the state after them (float32 planes) and, with
    `pack`, the last frame's 9 render planes. Lanes are independent within
    a frame, so they are stepped `chunk` at a time, all n frames each;
    `ranges` ([(a, b), ...] lane ranges, default the whole pool) steps only
    those lanes, gathered into the same chunks, and the planes returned are
    theirs, in that order."""
    frames_in = [frame] * n if isinstance(frame, Frame) else list(frame)
    if len(frames_in) != n or len({f.dt for f in frames_in}) > 1:
        raise ValueError("run_frames takes one Frame or n Frames of one dt")
    key, seeds = key_chain(state["rng_key"], n)
    frames, (tic, last, cursor) = cadence(cfg, state["time_in_cycle"], state["last_emission"],
                                          int(state["ring_cursor"]), frames_in[0].dt if n else 0.0, n)
    cap = cfg.capacity
    ranges = [(0, cap)] if ranges is None else [(int(a), int(b)) for a, b in ranges]
    dev = state["px"].device
    idx = torch.cat([torch.arange(a, b, dtype=torch.int64, device=dev) for a, b in ranges])
    size = idx.numel()
    out = {k: torch.empty(size, dtype=torch.float32, device=dev) for k in LANE_FIELDS}
    planes = [torch.empty(size, dtype=torch.float32, device=dev) for _ in range(9)] if pack else None
    for o in range(0, size, chunk):
        lanes = idx[o:o + chunk]
        f = {k: state[k][lanes].to(dtype) for k in LANE_FIELDS}
        for (cur, bounds), seed, fr in zip(frames, seeds, frames_in):
            f = _frame(cfg, f, lanes, cur, bounds, seed, fr, dtype)
        for k in LANE_FIELDS:
            out[k][o:o + lanes.numel()] = f[k].float()
        if pack:
            for p, v in zip(planes, render_planes(cfg, f)):
                p[o:o + lanes.numel()] = v.float()
    out.update(time_in_cycle=tic, last_emission=last, ring_cursor=cursor, rng_key=key)
    return out, planes


def _np_rem_euclid(a, b):
    r = F32(a - F32(np.trunc(F32(a / b))) * b)
    return F32(r + abs(b)) if r < 0 else r


def _np_div_euclid(a, b):
    q = F32(np.trunc(F32(a / b)))
    r = F32(a - F32(q * b))
    if r < 0:
        return F32(q - 1) if b > 0 else F32(q + 1)
    return q


def scalar_chain(cfg: Config, n: int, dt: float) -> dict:
    """The cadence scalars and the ring cursor of a pool after n frames of
    dt from `initial_state`: `cadence`'s float32 arithmetic on numpy
    scalars (a whole run's frames in well under a second)."""
    dt = F32(dt)
    tic = [F32(0.0)] * len(cfg.emitters)
    last = [F32(0.0)] * len(cfg.emitters)
    ems = [(F32(e.duration), F32(e.off_start), F32(e.off_end), F32(e.count)) for e in cfg.emitters]
    cursor = 0
    for _ in range(n):
        total = 0
        for e, (dur, ostart, oend, cnt) in enumerate(ems):
            t = _np_rem_euclid(F32(tic[e] + dt), dur)
            clamped = max(F32(last[e] / dur), ostart)
            since = F32(min(F32(t / dur), oend) - clamped)
            between = F32(F32(oend - ostart) / cnt)
            times = _np_div_euclid(since, between)
            total += int(max(times, F32(0.0)))
            last[e] = F32(F32(clamped + F32(times * between)) * dur)
            tic[e] = t
        cursor = (cursor + total) % cfg.capacity
    return {"time_in_cycle": np.array(tic, F32), "last_emission": np.array(last, F32), "ring_cursor": cursor}


def circle_translation(base: tuple, radius: float, period_s: float, phase: float, t: float) -> tuple:
    """A point moving on a horizontal circle about `base` (float32)."""
    a = phase + 2.0 * math.pi * t / period_s
    return (float(F32(base[0] + radius * math.cos(a))), float(F32(base[1])),
            float(F32(base[2] + radius * math.sin(a))))
