"""The port's collision (colliders, narrow phase, destroy-on-collision and its
dead-rank claim) against the JAX package, on the CPU.

Inputs are made from numpy seeds and go through both packages; the port runs
its plain versions here (the CUDA kernel's own tests are in
test_torch_kernel.py). Tolerances: the JAX package's XLA path contracts
multiply-adds into FMAs on the CPU and normalises the friction direction
before scaling it, while the port rounds every operation and keeps the
Pallas kernel's op order, so values agree to a few ulps of their magnitude:
rays within 1e-5, collision outcomes and trajectories within 1e-4 (the JAX
package's own collision tolerance, tests/test_fused_step.py), with hit/miss,
destroyed lanes, claims and counts exact."""

import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from bevy_firework_tpu import collision as jcol
from bevy_firework_tpu.cadence import np_compute_emission_count
from bevy_firework_tpu.models import effects as jeffects
from bevy_firework_tpu.ops import fused_step as jfs
from bevy_firework_tpu.step import step_jit
from bevy_firework_tpu.utils.f32 import np_rem_euclid
from bevy_firework_tpu_torch import collision as pcol
from bevy_firework_tpu_torch import interop
from bevy_firework_tpu_torch.colliders import TABLE_STATIC, TABLE_TENSORS
from bevy_firework_tpu_torch.models import effects as peffects
from bevy_firework_tpu_torch.ops import fused_step as pfs
from bevy_firework_tpu_torch.ops import table_layout as L
from bevy_firework_tpu_torch.settings import ParticleCollisionSettings as PortCollisionSettings
from bevy_firework_tpu_torch.step import dead_rank, plain_frames, plain_step
from test_torch_common import (  # noqa: F401
    _one_torch_thread,
    assert_pools_match,
    det_spawner,
    jax_pool_numpy,
    port_pool_numpy,
)

N = 8192
S8, C8 = math.sin(math.pi / 8), math.cos(math.pi / 8)
ROT = (0.1830127, 0.3415064, -0.1294095, 0.9123724)  # a unit quaternion off every axis


def both(make):
    """make(pkg) with each package's Collider: (JAX list, port list)."""
    return make(jx), make(pt)


def tables(make):
    """The same scene compiled by both packages."""
    cj, cp = both(make)
    return jx.compile_colliders(cj), pt.compile_colliders(cp, device="cpu")


def port_table_from_jax(jt):
    return interop.colliders_from_numpy({k: np.asarray(getattr(jt, k)) for k in TABLE_TENSORS},
                                        tuple(getattr(jt, k) for k in TABLE_STATIC), device="cpu")


def tetra(pkg, **kw):
    return pkg.Collider.hull_from_points([(0, 0, 0), (2, 0, 0), (0, 2.5, 0), (0, 0, 2)], **kw)


def box_planes(hx, hy, hz):
    return [(1, 0, 0, hx), (-1, 0, 0, hx), (0, 1, 0, hy), (0, -1, 0, hy), (0, 0, 1, hz), (0, 0, -1, hz)]


KINDS = {
    "halfspace": lambda pkg, rot: pkg.Collider.halfspace(position=(0.3, -0.2, 0.5), rotation=rot),
    "sphere": lambda pkg, rot: pkg.Collider.sphere(0.8, position=(0.3, -0.2, 0.5)),
    "cuboid": lambda pkg, rot: pkg.Collider.cuboid((0.7, 0.4, 1.1), position=(0.3, -0.2, 0.5), rotation=rot),
    "capsule": lambda pkg, rot: pkg.Collider.capsule(0.5, 0.6, position=(0.3, -0.2, 0.5), rotation=rot),
    "cylinder": lambda pkg, rot: pkg.Collider.cylinder(0.6, 0.5, position=(0.3, -0.2, 0.5), rotation=rot),
    "cone": lambda pkg, rot: pkg.Collider.cone(0.8, 0.7, position=(0.3, -0.2, 0.5), rotation=rot),
    "hull": lambda pkg, rot: tetra(pkg, position=(0.3, -0.2, 0.5), rotation=rot),
}


# ------------------------------------------------------------------ rays


def _rays(seed, n=4096):
    """Origins in a box around the collider (inside and outside); unit
    directions, half of them aimed near the collider, a quarter with one
    component zeroed and an eighth with two (rays parallel to slabs and
    planes)."""
    rng = np.random.default_rng(seed)
    center = np.array([0.3, -0.2, 0.5])
    o = rng.uniform(-2.5, 2.5, (n, 3)) + center
    d = rng.normal(size=(n, 3))
    d[n // 2:] = center + rng.normal(0.0, 0.6, (n - n // 2, 3)) - o[n // 2:]
    d[: n // 4, rng.integers(0, 3)] = 0.0
    d[n // 4: 3 * n // 8, :2] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _jax_cast(jt, o, d, max_dist=10.0):
    n = o.shape[0]
    col = [jnp.asarray(o[:, i]) for i in range(3)] + [jnp.asarray(d[:, i]) for i in range(3)]
    hit, dist, nx, ny, nz = jcol.raycast_scene(jt, jnp.full((n,), 0xFFFFFFFF, jnp.uint32), *col,
                                               jnp.full((n,), max_dist, jnp.float32))
    return np.asarray(hit), np.asarray(dist), np.stack([np.asarray(nx), np.asarray(ny), np.asarray(nz)], 1)


def _port_cast(pt_table, o, d, max_dist=10.0):
    n = o.shape[0]
    col = [torch.from_numpy(o[:, i].copy()) for i in range(3)] + [torch.from_numpy(d[:, i].copy()) for i in range(3)]
    hit, dist, nx, ny, nz = pcol.raycast_scene(pt_table, torch.full((n,), 0xFFFFFFFF, dtype=torch.int64), *col,
                                               torch.full((n,), max_dist))
    return hit.numpy(), dist.numpy(), torch.stack([nx, ny, nz], 1).numpy()


def _jax_ray(jt, o, d):
    """The JAX package's collision._ray_<kind> of collider 0 on local rays."""
    k, p = jt.kinds[0], jt.params[0]
    args = [jnp.asarray(o[:, i]) for i in range(3)] + [jnp.asarray(d[:, i]) for i in range(3)]
    fn, extra = {jx.colliders.COLLIDER_HALFSPACE: (jcol._ray_halfspace, ()),
                 jx.colliders.COLLIDER_SPHERE: (jcol._ray_sphere, (p[0],)),
                 jx.colliders.COLLIDER_CUBOID: (jcol._ray_cuboid, (p[0], p[1], p[2])),
                 jx.colliders.COLLIDER_CAPSULE: (jcol._ray_capsule, (p[0], p[1])),
                 jx.colliders.COLLIDER_CYLINDER: (jcol._ray_cylinder, (p[0], p[1])),
                 jx.colliders.COLLIDER_CONE: (jcol._ray_cone, (p[0], p[1])),
                 jx.colliders.COLLIDER_HULL: (jcol._ray_hull, (jt.hull_planes[0, : jt.hull_counts[0]],))}[k]
    dist, nx, ny, nz = fn(*args, *extra)
    dist = np.broadcast_to(np.asarray(dist), (o.shape[0],))
    return dist, np.stack([np.broadcast_to(np.asarray(c), dist.shape) for c in (nx, ny, nz)], 1)


def _port_ray(ptab, o, d):
    args = [torch.from_numpy(o[:, i].copy()) for i in range(3)] + [torch.from_numpy(d[:, i].copy()) for i in range(3)]
    dist, nx, ny, nz = pcol.ray_collider(ptab, 0, *args)
    dist = dist.expand(o.shape[0])
    return dist.numpy(), torch.stack([c.expand(o.shape[0]) for c in (nx, ny, nz)], 1).numpy()


def _to_local(col, o, d):
    """World rays into the collider's frame, in float64: both packages then
    see the same local rays."""
    x, y, z, w = col.rotation
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                  [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                  [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
    lo = (o.astype(np.float64) - np.asarray(col.position)) @ R
    return lo.astype(np.float32), (d.astype(np.float64) @ R).astype(np.float32)


@pytest.mark.parametrize("rotated", [False, True], ids=["axis", "rotated"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_ray_tests_match_jax(kind, rotated):
    """4096 seeded rays per kind. The port's _ray_<kind> against the JAX
    package's on the same local rays: hit/miss (a distance up to 10) exact,
    distance and local normal within 1e-5, on the rays whose outcome and
    normal are stable under 2e-3 shifts of the origin and that meet the
    surface at least 0.05 off tangency (|n.d| >= 0.05). Then the whole
    raycast_scene in world space, its rotations included, within 1e-4 on
    the same rays (the rotation's rounding differs between XLA's fused form
    and the port's, and a quadratic surface's distance amplifies it)."""
    rot = ROT if rotated else (0.0, 0.0, 0.0, 1.0)
    jt, ptab = tables(lambda pkg: [KINDS[kind](pkg, rot)])
    o, d = _rays(2 * sorted(KINDS).index(kind) + rotated)
    lo, ld = _to_local(KINDS[kind](jx, rot), o, d)
    shifts = [np.zeros(3)] + [s * 2e-3 * np.eye(3)[i] for i in range(3) for s in (1, -1)]
    runs = [_jax_ray(jt, (lo + sh).astype(np.float32), ld) for sh in shifts]
    hits = [r[0] <= 10.0 for r in runs]
    dj, nj = runs[0]
    hj = hits[0]
    stable = np.all([h == hj for h in hits], 0) & np.all([np.abs(r[1] - nj).max(1) < 0.05 for r in runs], 0)
    stable &= ~(hj & (dj > 0.0) & (np.abs((nj * ld).sum(1)) < 0.05))  # grazing
    assert stable.sum() > 3500 and hj[stable].sum() > 500 and (~hj[stable]).sum() > 500
    dp, np_ = _port_ray(ptab, lo, ld)
    np.testing.assert_array_equal(dp[stable] <= 10.0, hj[stable])
    hit = stable & hj
    np.testing.assert_allclose(dp[hit], dj[hit], atol=1e-5, rtol=0)
    np.testing.assert_allclose(np_[stable], nj[stable], atol=1e-5, rtol=0)
    inside = hit & (dj == 0.0)
    assert inside.sum() > 10
    assert np.all(dp[inside] == 0.0) and np.all(np_[inside] == 0.0)  # solid cast: dist 0, zero normal
    hwj, dwj, nwj = _jax_cast(jt, o, d)
    hwp, dwp, nwp = _port_cast(ptab, o, d)
    np.testing.assert_array_equal(hwp[stable], hwj[stable])
    np.testing.assert_allclose(dwp[stable], dwj[stable], atol=1e-4, rtol=0)
    np.testing.assert_allclose(nwp[stable], nwj[stable], atol=1e-4, rtol=0)


# -------------------------------------------------------------- authoring


def _mixed_scene(pkg):
    return [
        pkg.Collider.halfspace(position=(0, -1, 0), layers=0b01),
        pkg.Collider.sphere(0.5, position=(1, 0, 0), layers=0b10),
        pkg.Collider.cuboid((0.5, 0.3, 0.2), position=(-1, 0, 0), rotation=ROT),
        pkg.Collider.capsule(0.2, 0.4, position=(0, 1, 1), layers=0x80000000),
        pkg.Collider.cylinder(0.3, 0.5, position=(0, 0, -2), rotation=(S8, 0, 0, C8)),
        pkg.Collider.cone(0.4, 0.6, position=(2, 1, 2), layers=0xFFFFFFFF),
        pkg.Collider.hull(box_planes(1, 2, 3), position=(3, 0, 0)),
        tetra(pkg, rotation=ROT, layers=0b110),
    ]


@pytest.mark.parametrize("scene", ["mixed", "stress_test_collision", "empty", "no_hull"])
def test_compile_colliders_equal_tables(scene):
    """Both packages' compile_colliders: equal static tuples and arrays
    (the padded hull rows included), layers bit for bit; the JAX table
    carried over through interop equals the port's own."""
    make = {"mixed": _mixed_scene, "stress_test_collision": lambda pkg: (
        jeffects if pkg is jx else peffects).stress_test_collision()[2],
            "empty": lambda pkg: [], "no_hull": lambda pkg: _mixed_scene(pkg)[:6]}[scene]
    jt, ptab = tables(make)
    for k in TABLE_STATIC:
        assert getattr(jt, k) == getattr(ptab, k), k
    for k in TABLE_TENSORS:
        a, b = np.asarray(getattr(jt, k)), getattr(ptab, k).numpy()
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a.astype(b.dtype) if k == "layers" else a, b, err_msg=k)
    via = port_table_from_jax(jt)
    for k in TABLE_STATIC + TABLE_TENSORS:
        v, w = getattr(via, k), getattr(ptab, k)
        assert (torch.equal(v, w) if isinstance(w, torch.Tensor) else v == w), k


def test_hull_authoring_matches_jax():
    """hull / hull_from_points / hull_decomposition give the JAX package's
    planes and bounding radius exactly (the same host numpy)."""
    from tests.test_collision import _l_prism_mesh

    pts, tris = _l_prism_mesh()
    rng = np.random.default_rng(3)
    cloud = rng.normal(size=(12, 3))
    for make in (lambda pkg: [tetra(pkg)], lambda pkg: [pkg.Collider.hull(box_planes(1, 2, 3), rotation=ROT)],
                 lambda pkg: [pkg.Collider.hull_from_points(cloud)],
                 lambda pkg: pkg.hull_decomposition(pts, tris, max_pieces=8)):
        cj, cp = both(make)
        assert len(cj) == len(cp)
        for a, b in zip(cj, cp):
            assert (a.kind, a.planes, a.params, a.position, a.rotation, a.layers) == (
                b.kind, b.planes, b.params, b.position, b.rotation, b.layers)


def _cast_one(colliders, origin, direction, max_dist=100.0):
    d = np.asarray(direction, np.float64)
    d = (d / np.linalg.norm(d)).astype(np.float32)
    hit, dist, n = _port_cast(pt.compile_colliders(colliders, device="cpu"), np.asarray([origin], np.float32), d[None], max_dist)
    return bool(hit[0]), float(dist[0]), tuple(float(x) for x in n[0])


def _hull_box_matches_cuboid():
    hull = [pt.Collider.hull(box_planes(1, 2, 3), position=(0, -3, 0))]
    box = [pt.Collider.cuboid((1, 2, 3), position=(0, -3, 0))]
    for origin, d in (((0, 1, 0), (0, -1, 0)), ((0, -3, 0), (0, -1, 0)),
                      ((5, 1, 0), (0, -1, 0)), ((0.5, 4.0, 2.0), (0, -1, 0))):
        h1, d1, n1 = _cast_one(hull, origin, d)
        h2, d2, n2 = _cast_one(box, origin, d)
        assert h1 == h2 and abs(d1 - d2) < 1e-5
        np.testing.assert_allclose(n1, n2, atol=1e-5)


def _hull_from_points_tetrahedron():
    col = pt.Collider.hull_from_points([(0, 0, 0), (2, 0, 0), (0, 2, 0), (0, 0, 2)], position=(0, -3, 0))
    assert len(col.planes) == 4
    hit, dist, n = _cast_one([col], (0.4, 1.0, 0.4), (0, -1, 0))
    assert hit
    np.testing.assert_allclose(n, np.ones(3) / np.sqrt(3.0), atol=1e-5)
    hit, dist, n = _cast_one([col], (0.2, -2.8, 0.2), (0, -1, 0))
    assert hit and dist == 0.0 and n == (0, 0, 0)
    assert not _cast_one([col], (3.0, 1.0, 3.0), (0, -1, 0))[0]


def _hull_rotated():
    hull = [pt.Collider.hull(box_planes(1, 1, 1), position=(0, -2, 0), rotation=(0, 0, S8, C8))]
    box = [pt.Collider.cuboid((1, 1, 1), position=(0, -2, 0), rotation=(0, 0, S8, C8))]
    h1, d1, n1 = _cast_one(hull, (0, 1, 0), (0, -1, 0))
    h2, d2, n2 = _cast_one(box, (0, 1, 0), (0, -1, 0))
    assert h1 and h2 and abs(d1 - d2) < 1e-5
    np.testing.assert_allclose(n1, n2, atol=1e-5)


def _hull_from_points_large_rotated_box():
    rng = np.random.RandomState(0)
    q = rng.normal(size=4)
    x, y, z, w = q / np.linalg.norm(q)
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
    corners = np.array([[sx * 300.0, sy * 250.0, sz * 400.0] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    assert len(pt.Collider.hull_from_points(corners @ R.T + np.array([120.0, -80.0, 55.0])).planes) == 6


def _decomposition_convex_mesh():
    pts = np.asarray([(0, 0, 0), (2, 0, 0), (0, 2, 0), (0, 0, 2)], np.float64)
    tris = np.asarray([(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)], np.int64)
    pieces = pt.hull_decomposition(pts, tris)
    assert len(pieces) == 1 and len(pieces[0].planes) == 4


def _decomposition_l_prism():
    from tests.test_collision import _inside_any, _l_prism_mesh

    pts, tris = _l_prism_mesh()
    pieces = pt.hull_decomposition(pts, tris, max_pieces=8)
    assert 2 <= len(pieces) <= 8
    for p in pts:
        assert _inside_any(pieces, p, tol=1e-5), p
    assert not _inside_any(pieces, (1.5, 1.5, 0.5)) and not _inside_any(pieces, (1.05, 1.6, 0.5))
    hit, dist, n = _cast_one(pieces, (1.5, 3.0, 0.5), (0, -1, 0))
    assert hit and abs(dist - 2.0) < 1e-4 and abs(n[1] - 1.0) < 1e-4
    hit, dist, n = _cast_one(pieces, (0.5, 3.0, 0.5), (0, -1, 0))
    assert hit and abs(dist - 1.0) < 1e-4 and abs(n[1] - 1.0) < 1e-4
    assert not _cast_one(pieces, (2.5, 3.0, 0.5), (0, -1, 0))[0]


def _decomposition_deterministic():
    from tests.test_collision import _l_prism_mesh

    pts, tris = _l_prism_mesh()
    assert [p.planes for p in pt.hull_decomposition(pts, tris)] == [p.planes for p in pt.hull_decomposition(pts, tris)]


HULL_CASES = {f.__name__.lstrip("_"): f for f in (
    _hull_box_matches_cuboid, _hull_from_points_tetrahedron, _hull_rotated, _hull_from_points_large_rotated_box,
    _decomposition_convex_mesh, _decomposition_l_prism, _decomposition_deterministic)}


@pytest.mark.parametrize("case", sorted(HULL_CASES))
def test_hull_cases_port(case):
    """tests/test_collision.py's hull and hull_decomposition cases, on the
    port's authoring and raycast."""
    HULL_CASES[case]()


def test_pack_colliders_keeps_layer_bits_and_disables():
    """The kernel's collider table: kinds, flags and values at their slots,
    uint32 layers bit for bit, layers 0 for a disabled collider, each
    hull's own plane rows (and no plane words for other kinds), the broad
    phase's bounding radius; a table of any size (33 colliders here) packs."""
    t = pt.compile_colliders(_mixed_scene(pt), device="cpu")
    t = dataclasses.replace(t, active=torch.tensor([1, 1, 0, 1, 1, 1, 1, 1], dtype=torch.float32))
    w = pfs.pack_colliders(t)
    assert w.size == 8 * L.CO_STRIDE + 4 * (6 + 4)  # a 6-plane box and a tetrahedron
    rows = w[:8 * L.CO_STRIDE].reshape(8, L.CO_STRIDE)
    assert list(rows[:, L.CO_KIND]) == list(t.kinds) and list(rows[:, L.CO_HULL_N]) == list(t.hull_counts)
    assert list(rows[:, L.CO_IDENT]) == [int(i) for i in t.identity_rot]
    layers = rows[:, L.CO_LAYERS].view(np.uint32)
    assert list(layers) == [0b01, 0b10, 0, 0x80000000, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0b110]
    np.testing.assert_array_equal(rows[:, L.CO_ROT:L.CO_ROT + 4].view(np.float32), t.rotation.numpy())
    assert list(rows[:, L.CO_PLANES]) == [0] * 6 + [8 * L.CO_STRIDE, 8 * L.CO_STRIDE + 24]
    for ci in (6, 7):
        n = t.hull_counts[ci]
        planes = w[rows[ci, L.CO_PLANES]:][:4 * n].view(np.float32).reshape(n, 4)
        np.testing.assert_array_equal(planes, t.hull_planes[ci, :n].numpy())
    p = t.params.numpy()
    radius = rows[:, L.CO_RADIUS].view(np.float32)
    assert radius[1] == p[1, 0] and radius[6] == p[6, 0] and radius[3] == p[3, 0] + p[3, 1]
    assert radius[2] == np.sqrt(p[2, 0] * p[2, 0] + p[2, 1] * p[2, 1] + p[2, 2] * p[2, 2])
    many = pfs.pack_colliders(pt.compile_colliders([pt.Collider.sphere(1.0)] * 33, device="cpu"))
    assert many.size == 33 * L.CO_STRIDE and (many.reshape(33, L.CO_STRIDE)[:, L.CO_KIND] == 1).all()
    c = pt.compile_spawner(det_spawner(pt, ps=dict(
        collision_settings=PortCollisionSettings(0.5, 0.25, True, 0xFFFFFFFF))), device="cpu")
    words = pfs.pack_tables(c.static, c.params)
    ty = L.TY_AT
    assert words[ty + L.TY_HAS_COL] == 1 and not c.static.ring_claim
    assert words[ty + L.TY_COLL_MASK].view(np.uint32) == 0xFFFFFFFF
    assert list(words[ty + L.TY_RESTITUTION:ty + L.TY_DESTROY + 1].view(np.float32)) == [0.5, 0.25, 1.0]


# ----------------------------------------------------- particle_collision


def _hull8(pkg):
    """bench.py's 1M_hull8 scene: a 6-plane floor and 7 tetrahedra."""
    hulls = [pkg.Collider.hull(box_planes(60.0, 1.0, 60.0), position=(0.0, -1.5, 0.0))]
    for i in range(7):
        hulls.append(pkg.Collider.hull_from_points([(0, 0, 0), (2.0, 0, 0), (0, 2.5, 0), (0, 0, 2.0)],
                                                   position=(float(i * 3 - 9), -0.5, float((i % 3) * 3 - 3))))
    return hulls


PC_SCENES = {
    "stress_test_collision": (lambda pkg: (jeffects if pkg is jx else peffects).stress_test_collision()[2],
                              ((-5, 5), (-1.2, 3), (-5, 5))),
    "hull8": (_hull8, ((-10, 10), (-1.5, 3), (-4, 4))),
    "masked_mix": (_mixed_scene, ((-2, 4), (-1.5, 2.5), (-3, 3))),
}


@pytest.mark.parametrize("scene", sorted(PC_SCENES))
def test_particle_collision_matches_jax(scene):
    """8192 seeded lanes (positions around the scene, velocities up to ~15
    m/s, dt 1/30, per-lane restitution, friction, destroy flag and layer
    mask): positions and velocities within 1e-4, destroyed lanes exact. The
    mixed scene has a disabled collider (active 0), carried into the port
    from the JAX table through interop."""
    make, box = PC_SCENES[scene]
    jt = jx.compile_colliders(make(jx))
    if scene == "masked_mix":
        jt = dataclasses.replace(jt, active=jnp.asarray([1, 1, 0, 1, 1, 1, 1, 0], jnp.float32))
    ptab = port_table_from_jax(jt)
    rng = np.random.default_rng(sorted(PC_SCENES).index(scene))
    pos = [rng.uniform(lo, hi, N).astype(np.float32) for lo, hi in box]
    vel = [rng.normal(0.0, 5.0, N).astype(np.float32) for _ in range(3)]
    vel[1] -= 3.0
    rest = rng.uniform(0, 1, N).astype(np.float32)
    fric = rng.uniform(0, 0.5, N).astype(np.float32)
    dest = (rng.uniform(0, 1, N) < 0.3).astype(np.float32)
    masks = np.array([0b01, 0b10, 0b110, 0xFFFFFFFF, 0x80000000, 0], np.uint32)[rng.integers(0, 6, N)]
    dt = np.float32(1 / 30)
    # op by op: jit would spend a minute compiling the unrolled substeps on the CPU
    jout = jcol.particle_collision(jt, *map(jnp.asarray, pos + vel), jnp.float32(dt), jnp.asarray(rest),
                                   jnp.asarray(fric), jnp.asarray(dest), jnp.asarray(masks))
    pout = pcol.particle_collision(ptab, *map(torch.from_numpy, pos + vel), torch.tensor(dt),
                                   torch.from_numpy(rest), torch.from_numpy(fric), torch.from_numpy(dest),
                                   torch.from_numpy(masks.astype(np.int64)))
    moved = np.zeros(N, bool)
    for i in range(6):
        a, b = np.asarray(jout[i]), pout[i].numpy()
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0, err_msg=f"output {i}")
        moved |= a != (pos + vel)[i] + (vel[i] * dt if i < 3 else 0)
    np.testing.assert_array_equal(pout[6].numpy(), np.asarray(jout[6]))
    assert pout[6].sum() > 100 and moved.sum() > 500  # lanes hit, bounce and die


# ------------------------------------------------------------ trajectories


def _pair(ps_j, ps_p, pacing):
    return (jx.compile_spawner(det_spawner(jx, ps=ps_j, pacing=pacing[0])),
            pt.compile_spawner(det_spawner(pt, ps=ps_p, pacing=pacing[1]), device="cpu"))


def _six_colliders(pkg):
    """tests/test_fused_step.py's every-kind mix: colliders the burst hits
    and far ones of every kind."""
    return [
        pkg.Collider.halfspace(position=(0.0, -0.5, 0.0)),
        pkg.Collider.sphere(0.4, position=(0.6, 1.0, 0.1)),
        pkg.Collider.cuboid((0.3, 0.3, 0.3), position=(50.0, 0.0, 0.0)),
        pkg.Collider.capsule(0.2, 0.5, position=(0.0, 40.0, 0.0)),
        pkg.Collider.cylinder(0.3, 0.4, position=(-60.0, 2.0, 3.0), rotation=(0.0, 0.0, 0.3826834, 0.9238795)),
        pkg.Collider.cone(0.5, 0.5, position=(0.0, 0.0, 70.0)),
    ]


FLIP = (1.0, 0.0, 0.0, 0.0)  # half turn about X: a halfspace solid above its plane

TRAJECTORIES = {
    # (settings, collision settings, pacing, colliders, frames). The
    # deterministic spawner shoots every particle up along (1, 3, 0.2); the
    # halfspace configs of test_fused_step.py are moved into its path (a
    # steeper fall onto a raised floor; a ceiling for the destroy config) so
    # that lanes bounce and die within their 0.3 s.
    "halfspace_bounce": (dict(acceleration=(0.0, -50.0, 0.0)), dict(restitution=0.6, friction=0.2),
                         ("one_shot", 40), lambda pkg: [pkg.Collider.halfspace(position=(0.0, -0.2, 0.0))], 14),
    "six_kinds": ({}, dict(restitution=0.5, friction=0.1), ("one_shot", 60), _six_colliders, 14),
    "destroy_dead_rank_claim": ({}, dict(restitution=0.0, friction=0.0, destroy_on_collision=True),
                                ("rate", 1500.0),
                                lambda pkg: [pkg.Collider.halfspace(position=(0.0, 0.4, 0.0), rotation=FLIP)], 30),
}


@pytest.mark.parametrize("config", sorted(TRAJECTORIES))
def test_trajectories_match_jax_xla_step(config):
    """The port's step against the JAX XLA step on test_fused_step.py's
    deterministic collision configs, every frame: alive, counts and cursor
    exact, fields within 1e-4; the cadence scalars equal the numpy f32
    oracle's bit for bit (and the JAX step's within an FMA's rounding: XLA
    contracts the carry, see test_torch_step.py). The destroy config is not
    a ring archetype: it claims by dead-slot rank and carries the alive
    plane."""
    ps, cs, (pk, pv), make, frames = TRAJECTORIES[config]
    cj, cp = _pair(dict(linear_drag=0.0, collision_settings=jx.ParticleCollisionSettings(**cs), **ps),
                   dict(linear_drag=0.0, collision_settings=PortCollisionSettings(**cs), **ps),
                   (getattr(jx.EmissionPacing, pk)(pv), getattr(pt.EmissionPacing, pk)(pv)))
    assert cp.static.ring_claim == ("destroy_on_collision" not in cs)
    tj, tp = tables(make)
    fj, fp = jx.make_frame_input(1 / 50), pt.make_frame_input(1 / 50)
    sj, sp = jx.init_pool_for(cj, N, 0), pt.init_pool_for(cp, N, 0)
    destroyed = 0
    dt, tic, last = np.float32(1 / 50), np.float32(0.0), np.float32(0.0)
    for _ in range(frames):
        alive_before = sp.alive
        sj, oj = step_jit(cj.static, cj.params, tj, sj, fj)
        sp, op = plain_step(cp.static, cp.params, tp, sp, fp)
        a, b = jax_pool_numpy(sj), port_pool_numpy(sp)
        assert_pools_match(a, b, atol=1e-4, rtol=0)
        if pk == "rate":
            tic = np_rem_euclid(np.float32(tic + dt), np.float32(1.0))
            _n, last = np_compute_emission_count(tic, last, np.float32(1.0), 0.0, 1.0, np.float32(pv))
        np.testing.assert_array_equal(b["time_in_cycle"], [tic])
        np.testing.assert_array_equal(b["last_emission"], [last])
        np.testing.assert_allclose(b["last_emission"], a["last_emission"], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(a["time_in_cycle"], b["time_in_cycle"])
        np.testing.assert_array_equal(a["finished_notified"], b["finished_notified"])
        assert int(op.alive_count) == int(oj.alive_count)
        np.testing.assert_array_equal(op.alive_count_per_type.numpy(), np.asarray(oj.alive_count_per_type))
        destroyed += int((alive_before & ~sp.alive & (sp.age < sp.lifetime)).sum())  # died before their age
    assert int(op.alive_count) > 0
    if config == "destroy_dead_rank_claim":
        assert int(sp.ring_cursor) == 0 and destroyed > 100  # slots freed early and reclaimed


def test_halfspace_config_matches_jax_pallas_kernel_interpret_mode():
    """tests/test_fused_step.py's halfspace bounce through the JAX package's
    Pallas kernel (interpret mode, as its own tests run it on the CPU) and
    the port's fused_step, 12 frames at N = 8192: alive exact, fields within
    1e-4."""
    cs = dict(restitution=0.6, friction=0.2)
    cj, cp = _pair(dict(linear_drag=0.0, collision_settings=jx.ParticleCollisionSettings(**cs)),
                   dict(linear_drag=0.0, collision_settings=PortCollisionSettings(**cs)),
                   (jx.EmissionPacing.one_shot(40), pt.EmissionPacing.one_shot(40)))
    tj, tp = tables(lambda pkg: [pkg.Collider.halfspace(position=(0.0, -0.5, 0.0))])
    fj, fp = jx.make_frame_input(1 / 50), pt.make_frame_input(1 / 50)
    sj, sp = jx.init_pool_for(cj, N, 0), pt.init_pool_for(cp, N, 0)
    fused = jax.jit(jfs.fused_step, static_argnums=(0,))
    for _ in range(12):
        with pltpu.force_tpu_interpret_mode():
            sj, oj = fused(cj.static, cj.params, tj, sj, fj)
        sp, op = pfs.fused_step(cp.static, cp.params, tp, sp, fp)
    a, b = jax_pool_numpy(sj), port_pool_numpy(sp)
    a["alive"] = np.asarray(sj.alive)
    assert_pools_match(a, b, atol=1e-4, rtol=0)
    assert int(op.alive_count) == int(oj.alive_count) == 40


# ------------------------------------------------------- dead-rank claim


def test_dead_rank_and_tile_offsets_plain():
    """The claim's plain versions: dead_rank is the exclusive count of dead
    lanes before each lane; the tile offsets are the dead lanes before each
    TILE-lane tile, a ragged last tile included."""
    rng = np.random.default_rng(7)
    for n in (1, 255, 256, 1000, 131072 + 77):
        alive = rng.uniform(size=n) < rng.uniform()
        dead = ~alive
        want = np.cumsum(dead) - dead
        np.testing.assert_array_equal(dead_rank(torch.from_numpy(dead)).numpy(), want)
        offs = pfs.tile_dead_offsets(torch.from_numpy(alive)).numpy()
        starts = np.arange(0, n, L.TILE)
        np.testing.assert_array_equal(offs, np.concatenate([[0], np.cumsum(dead)])[starts])


# -------------------------------------------------------------- the slice


def test_chain_shape_matches_reference_chain_with_unroll(monkeypatch):
    """Launch split of a chain: U = 2 with colliders, U = 8 without, singles
    for the destroy archetype, as the JAX package's _chain_with_unroll cuts
    it on a TPU (its backend check and chain runner stubbed to record)."""
    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jfs, "_scan_hoist", lambda static, state: None)
    monkeypatch.setattr(jfs, "_chain", lambda fn, state, n, hoist: calls.append((fn, n)) or (state, None))
    spj, _tf, colj = jeffects.stress_test_collision()
    spp, _tf, colp = peffects.stress_test_collision()
    destroy = dict(collision_settings=jx.ParticleCollisionSettings(destroy_on_collision=True))
    pdestroy = dict(collision_settings=PortCollisionSettings(destroy_on_collision=True))
    cases = [(jx.compile_spawner(spj), pt.compile_spawner(spp, device="cpu"), True),
             (jx.compile_spawner(spj), pt.compile_spawner(spp, device="cpu"), False),
             (jx.compile_spawner(det_spawner(jx, ps=destroy)), pt.compile_spawner(det_spawner(pt, ps=pdestroy), device="cpu"), True)]
    for cj, cp, with_cols in cases:
        jt = jx.compile_colliders(colj) if with_cols else None
        ptab = pt.compile_colliders(colp, device="cpu") if with_cols else None
        for n in (1, 2, 7, 8, 19, 150):
            calls.clear()
            jfs._chain_with_unroll(cj.static, jt, types.SimpleNamespace(capacity=16384), n, "single",
                                   lambda u: ("unrolled", u))
            want = [u for fn, k in calls for u in [1 if fn == "single" else fn[1]] * k]
            assert pfs.chain_shape(n, pfs.chain_unroll(cp.static, ptab)) == want, (with_cols, n)


def test_stress_test_collision_chain_equals_plain_frames():
    """stress_test_collision at rate 6000 and capacity 16384 for 60 frames
    through multi_step_auto (30 launches of U = 2) against 60 plain frames:
    bit for bit (on the CPU both are the plain version, so this holds the
    chain's cut and its state hand-over); the floor and the cube bounce
    particles."""
    sp, tf, cols = peffects.stress_test_collision()
    es = dataclasses.replace(sp.emission_settings[0], emission_pacing=pt.EmissionPacing.rate(6000.0))
    sp = dataclasses.replace(sp, emission_settings=(es,))
    c = pt.compile_spawner(sp, device="cpu")
    table = pt.compile_colliders(cols, device="cpu")
    f = pt.make_frame_input(1 / 60, translation=tf.translation, rotation=tf.rotation)
    s0 = pt.init_pool_for(c, 16384, seed=1)
    assert pfs.chain_shape(60, pfs.chain_unroll(c.static, table)) == [2] * 30
    sa, oa = pfs.multi_step_auto(c.static, c.params, table, s0, f, 60)
    sb, ob = plain_frames(c.static, c.params, s0, f, 60, colliders=table)
    a, b = port_pool_numpy(sa), port_pool_numpy(sb)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(oa.alive_count) == int(ob.alive_count) == int(sa.ring_cursor) == 6000
    sn, _o = plain_frames(c.static, c.params, s0, f, 60)  # no colliders: the same lanes fly through
    alive = sa.alive.numpy()
    assert (sa.py.numpy()[alive] > -0.5).all() and (sn.py.numpy()[alive] < -0.5).sum() > 100
    assert (sa.py.numpy() != sn.py.numpy())[alive].sum() > 300


def test_collision_flow_port():
    """The verify skill's CPU collision flow: effects.collision() with its
    cuboid through step_auto_packed for 120 frames at 1/60: 199 live (rate
    100 for 2 s, lifetime 6.75 s; the f32 cadence carry emits the 200th at
    frame 121), nobody below the cuboid's top, 64 B rows."""
    sp, tf, cols = peffects.collision()
    c = pt.compile_spawner(sp, device="cpu")
    table = pt.compile_colliders(cols, device="cpu")
    s = pt.init_pool_for(c, 1024)
    f = pt.make_frame_input(1 / 60, translation=tf.translation, rotation=tf.rotation)
    for _ in range(120):
        s, out, planes = pt.step_auto_packed(c.static, c.params, table, s, f)
    assert int(out.alive_count) == int(s.ring_cursor) == 199
    inside_x = s.alive & (s.px.abs() < 3.9) & (s.pz.abs() < 3.9)
    assert int(inside_x.sum()) > 20 and bool((s.py[inside_x] > -1e-3).all())
    rows = pt.planes_to_rows(c.static, s, planes)
    assert len(pt.instances_to_bytes(rows)) == 199 * 64


def test_colliders_must_share_the_pool_device():
    """A collider table on another device than the pool raises on either
    path; nothing is copied or falls back."""
    sp, tf, cols = peffects.collision()
    c = pt.compile_spawner(sp, device="cpu")
    table = pt.compile_colliders(cols, device="meta")
    with pytest.raises(ValueError, match="colliders on meta"):
        pt.step_auto(c.static, c.params, table, pt.init_pool_for(c, 256), pt.make_frame_input(1 / 60))
