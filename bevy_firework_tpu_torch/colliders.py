"""Static analytic collider scene description (port of
`bevy_firework_tpu.colliders`).

The reference raycasts particles against arbitrary avian colliders through a
BVH (reference `src/core.rs:756-765`); here, as in the JAX package, a scene
is a small table of analytic primitives (kind, position, rotation, params,
layers) that the narrow phase evaluates per lane, taking the nearest hit.
Authoring (`Collider`, its constructors, `hull_from_points`,
`hull_decomposition`) is host numpy, the same code as the JAX package's, so
both packages lower a scene to the same numbers. `ColliderTable` holds
tensors on an explicit device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from .utils.device import DEFAULT_DEVICE, resolve_device

COLLIDER_HALFSPACE = 0  # params: () - plane through origin, +Y normal (local)
COLLIDER_SPHERE = 1  # params: (radius,)
COLLIDER_CUBOID = 2  # params: (hx, hy, hz) half-extents
COLLIDER_CAPSULE = 3  # params: (radius, half_segment) - segment along local Y
COLLIDER_CYLINDER = 4  # params: (radius, half_height) - axis local Y
COLLIDER_CONE = 5  # params: (base_radius, half_height) - tip at +hh, base at -hh
# Convex hull as a plane set: up to HULL_MAX_PLANES half-spaces n.x <= d in
# LOCAL space, padded with degenerate rows (n = 0, d = +BIG: always
# satisfied). params: (bounding_radius, n_planes, 0); the plane rows live in
# ColliderTable.hull_planes.
COLLIDER_HULL = 6

HULL_MAX_PLANES = 16
_HULL_PAD_D = 1e30  # padding plane offset: 0.x <= BIG is always satisfied


@dataclasses.dataclass(frozen=True)
class Collider:
    kind: int
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rotation: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)  # xyzw
    params: Tuple[float, ...] = ()
    layers: int = 0xFFFFFFFF
    planes: Tuple[Tuple[float, float, float, float], ...] = ()  # hull only

    @staticmethod
    def halfspace(position=(0, 0, 0), rotation=(0, 0, 0, 1), layers=0xFFFFFFFF):
        return Collider(COLLIDER_HALFSPACE, tuple(position), tuple(rotation), (), layers)

    @staticmethod
    def sphere(radius, position=(0, 0, 0), layers=0xFFFFFFFF):
        return Collider(COLLIDER_SPHERE, tuple(position), (0, 0, 0, 1), (float(radius),), layers)

    @staticmethod
    def cuboid(half_extents, position=(0, 0, 0), rotation=(0, 0, 0, 1), layers=0xFFFFFFFF):
        return Collider(COLLIDER_CUBOID, tuple(position), tuple(rotation), tuple(float(h) for h in half_extents), layers)

    @staticmethod
    def capsule(radius, half_segment, position=(0, 0, 0), rotation=(0, 0, 0, 1), layers=0xFFFFFFFF):
        return Collider(COLLIDER_CAPSULE, tuple(position), tuple(rotation), (float(radius), float(half_segment)), layers)

    @staticmethod
    def cylinder(radius, half_height, position=(0, 0, 0), rotation=(0, 0, 0, 1), layers=0xFFFFFFFF):
        return Collider(COLLIDER_CYLINDER, tuple(position), tuple(rotation), (float(radius), float(half_height)), layers)

    @staticmethod
    def cone(base_radius, half_height, position=(0, 0, 0), rotation=(0, 0, 0, 1), layers=0xFFFFFFFF):
        return Collider(COLLIDER_CONE, tuple(position), tuple(rotation), (float(base_radius), float(half_height)), layers)

    @staticmethod
    def hull(planes, position=(0, 0, 0), rotation=(0, 0, 0, 1), layers=0xFFFFFFFF):
        """Convex hull from a LOCAL-space plane set: each plane is
        (nx, ny, nz, d) meaning n·x <= d inside (normals point OUT). Normals
        are normalized here; at most HULL_MAX_PLANES planes. The planes must
        bound a finite volume for the broad phase (the bounding radius is
        derived by support-point sampling)."""
        rows = []
        for nx, ny, nz, d in planes:
            n = np.asarray((nx, ny, nz), np.float64)
            ln = float(np.linalg.norm(n))
            if ln <= 0:
                raise ValueError("hull plane with zero normal")
            rows.append((n[0] / ln, n[1] / ln, n[2] / ln, float(d) / ln))
        if not 4 <= len(rows) <= HULL_MAX_PLANES:
            raise ValueError(f"hull needs 4..{HULL_MAX_PLANES} planes, got {len(rows)}")
        radius = _hull_bounding_radius(rows)
        return Collider(COLLIDER_HULL, tuple(position), tuple(rotation),
                        (float(radius), float(len(rows)), 0.0), layers,
                        planes=tuple(tuple(r) for r in rows))

    @staticmethod
    def hull_from_points(points, position=(0, 0, 0), rotation=(0, 0, 0, 1), layers=0xFFFFFFFF):
        """Convex hull of LOCAL-space points (authoring convenience): brute
        force over point triples — O(n^3), fine for the tens of points a
        hand-authored hull has. The resulting plane set is deduplicated and
        capped at HULL_MAX_PLANES (an over-tessellated hull raises; simplify
        the point set)."""
        pts = np.asarray(points, np.float64)
        if pts.shape[0] < 4:
            raise ValueError("hull_from_points needs >= 4 points")
        center = pts.mean(axis=0)
        eps = 1e-7 * max(1.0, float(np.abs(pts).max()))
        planes = []
        n_pts = pts.shape[0]
        for i in range(n_pts):
            for j in range(i + 1, n_pts):
                for k in range(j + 1, n_pts):
                    n = np.cross(pts[j] - pts[i], pts[k] - pts[i])
                    ln = np.linalg.norm(n)
                    if ln < eps:
                        continue
                    n = n / ln
                    d = float(n @ pts[i])
                    if n @ center > d:  # make the normal point OUT
                        n, d = -n, -d
                    if np.all(pts @ n <= d + eps):  # supporting plane
                        # dedup tolerance scales with the point magnitudes
                        # (eps above): a fixed absolute tolerance made
                        # rotated/large-coordinate faces fail dedup and
                        # spuriously overflow HULL_MAX_PLANES
                        d_tol = 100.0 * eps
                        dup = any(
                            abs(d - p[3]) < d_tol and float(n @ np.asarray(p[:3])) > 1.0 - 1e-5
                            for p in planes
                        )
                        if not dup:
                            planes.append((float(n[0]), float(n[1]), float(n[2]), d))
        if len(planes) > HULL_MAX_PLANES:
            raise ValueError(
                f"hull has {len(planes)} faces > {HULL_MAX_PLANES}; simplify the points")
        return Collider.hull(planes, position, rotation, layers)


def _orient_mesh(pts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Consistently orient a (mostly) manifold triangle mesh so all faces
    wind outward: BFS over edge adjacency flipping inconsistent windings,
    then a global flip if the divergence-theorem signed volume is negative.
    Open/non-manifold meshes come back best-effort (hull_decomposition then
    skips the outward-normal negative samples)."""
    from collections import defaultdict

    tris = tris.copy()
    edge_tris = defaultdict(list)
    for t, (a, b, c) in enumerate(tris):
        for e in ((a, b), (b, c), (c, a)):
            edge_tris[frozenset(e)].append(t)
    oriented = np.zeros(len(tris), bool)
    for seed in range(len(tris)):
        if oriented[seed]:
            continue
        oriented[seed] = True
        stack = [seed]
        while stack:
            t = stack.pop()
            a, b, c = tris[t]
            for e in ((a, b), (b, c), (c, a)):
                for u in edge_tris[frozenset(e)]:
                    if u == t or oriented[u]:
                        continue
                    ua, ub, uc = (int(x) for x in tris[u])
                    # consistent winding: the shared edge must appear in
                    # OPPOSITE order in the neighbor
                    if e in ((ua, ub), (ub, uc), (uc, ua)):
                        tris[u] = (ua, uc, ub)
                    oriented[u] = True
                    stack.append(u)
    v = pts[tris]
    vol = float(np.einsum("ij,ij->", v[:, 0], np.cross(v[:, 1], v[:, 2])))
    if vol < 0:
        tris = tris[:, [0, 2, 1]]
    return tris


def hull_decomposition(points, triangles=None, max_pieces: int = 8,
                       concavity_tol: float = 1e-3, position=(0, 0, 0),
                       rotation=(0, 0, 0, 1), layers=0xFFFFFFFF) -> List[Collider]:
    """Decompose a (possibly concave) triangle mesh into convex
    `Collider.hull` pieces for the analytic collider table (the
    reference raycasts arbitrary avian colliders incl. trimeshes,
    reference `src/core.rs:756-765`; this narrow phase is
    analytic, so concave meshes enter as compound convex pieces — compound
    colliders are just multiple table entries).

    Authoring-time helper for SMALL meshes (tens of vertices — the plane
    extraction is O(n^3) in piece vertex count, same as hull_from_points).
    Deterministic axis-median BSP: if the piece's surface is within
    `concavity_tol` of its convex hull, emit one hull; otherwise split the
    triangles at the median of their centroids along the widest-spread axis
    and recurse, up to `max_pieces` pieces (then emit the best convex
    approximation of each remaining piece). `triangles=None` treats the
    points as a convex cloud (single hull).

    The union of the returned hulls covers the input surface (every input
    vertex lies in some piece); like any approximate convex decomposition it
    may overcover concave interior pockets by up to the achieved concavity —
    the returned pieces' planes are exact supporting planes of their vertex
    subsets."""
    pts = np.asarray(points, np.float64)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError("points must be [N, 3]")
    if triangles is None:
        return [Collider.hull_from_points(pts, position, rotation, layers)]
    tris = np.asarray(triangles, np.int64)
    if tris.ndim != 2 or tris.shape[1] != 3:
        raise ValueError("triangles must be [T, 3] vertex indices")

    # Outward face normals (after orienting the mesh consistently): used for
    # NEGATIVE samples — a point just outside each face must be OUTSIDE the
    # piece's hull. A convex patch wrapping a reflex corner (e.g. the two
    # inner walls of an L: their hull is the notch wedge) passes the plain
    # surface-on-hull test but buries its faces inside the hull; the buried
    # face's offset point is then the split witness.
    tris_o = _orient_mesh(pts, tris)
    v = pts[tris_o]
    face_n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    ln = np.linalg.norm(face_n, axis=1, keepdims=True)
    closed = float(np.einsum("ij,ij->", v[:, 0], np.cross(v[:, 1], v[:, 2]))) > 1e-9
    face_n = np.where(ln > 1e-12, face_n / np.maximum(ln, 1e-300), 0.0)
    diag = float(np.linalg.norm(pts.max(axis=0) - pts.min(axis=0)))
    eps_out = 1e-3 * max(diag, 1e-6)

    def piece_hull(tsel: np.ndarray):
        """(hull or None, concavity, witness point) for a triangle subset.
        Concavity = max distance of any surface sample (piece vertices +
        triangle centroids) INSIDE the convex hull of the piece's vertices —
        0 for a convex piece, where every sample sits on a hull plane — and
        any offset negative sample inside the hull forces a split there. The
        witness is the deepest-inside sample (the reflex region)."""
        vert_idx = np.unique(tris[tsel].ravel())
        if vert_idx.size < 4:
            return None, float("inf"), None
        try:
            hull = Collider.hull_from_points(pts[vert_idx])
        except ValueError:
            return None, float("inf"), None  # flat/degenerate/over-tessellated
        cent = pts[tris[tsel]].mean(axis=1)
        samples = np.concatenate([pts[vert_idx], cent], axis=0)
        n = np.asarray([p[:3] for p in hull.planes], np.float64)
        d = np.asarray([p[3] for p in hull.planes], np.float64)
        # slack of sample x = min_i (d_i - n_i.x): distance to the nearest
        # supporting plane
        slack = (d[None, :] - samples @ n.T).min(axis=1)
        w = int(np.argmax(slack))
        conc, witness = float(slack.max(initial=0.0)), samples[w]
        if closed:  # negative samples need reliable outward normals
            neg = cent + eps_out * face_n[tsel]
            nslack = (d[None, :] - neg @ n.T).min(axis=1)
            wn = int(np.argmax(nslack))
            if nslack[wn] > 0.0 and nslack[wn] + concavity_tol > conc:
                conc, witness = max(conc, concavity_tol * 2 + nslack[wn]), neg[wn]
        return hull, conc, witness

    root = np.arange(tris.shape[0])
    root_hull, root_conc, root_w = piece_hull(root)
    if root_hull is None:
        raise ValueError("mesh vertices do not bound a volume")
    pieces = [(root, root_hull, root_conc, root_w)]  # still to process
    done: List[Collider] = []
    while pieces:
        tsel, hull, conc, witness = pieces.pop()
        budget_left = max_pieces - (len(done) + len(pieces) + 1)
        if conc <= concavity_tol or budget_left <= 0 or tsel.size < 2:
            done.append(hull)
            continue
        cent = pts[tris[tsel]].mean(axis=1)
        # split at the concavity WITNESS (the reflex region — for an
        # L-shape, the inner corner), widest-spread axis first; fall back
        # to a median split, then the other axes, when a candidate half is
        # empty or degenerates (flat/too few points)
        axes = np.argsort(-(cent.max(axis=0) - cent.min(axis=0)))
        candidates = []
        for axis in axes:
            a = int(axis)
            side = cent[:, a] < witness[a]
            candidates.append((tsel[side], tsel[~side]))
            order = np.argsort(cent[:, a], kind="stable")
            half = tsel.size // 2
            candidates.append((tsel[order[:half]], tsel[order[half:]]))
        split = None
        for lo, hi in candidates:
            if lo.size == 0 or hi.size == 0:
                continue
            lo_h, lo_c, lo_w = piece_hull(lo)
            hi_h, hi_c, hi_w = piece_hull(hi)
            if lo_h is not None and hi_h is not None:
                split = ((lo, lo_h, lo_c, lo_w), (hi, hi_h, hi_c, hi_w))
                break
        if split is None:  # unsplittable: keep the convex approximation
            done.append(hull)
        else:
            pieces.extend(split)
    return [
        Collider.hull(c.planes, position, rotation, layers) for c in done
    ]


def _hull_bounding_radius(rows) -> float:
    """Conservative bounding-sphere radius about the LOCAL origin for a
    plane-set hull: the max distance of any plane-triple intersection vertex
    that satisfies every plane (the hull's vertices)."""
    import itertools

    n = np.asarray([r[:3] for r in rows], np.float64)
    d = np.asarray([r[3] for r in rows], np.float64)
    best = 0.0
    for i, j, k in itertools.combinations(range(len(rows)), 3):
        A = np.stack([n[i], n[j], n[k]])
        if abs(np.linalg.det(A)) < 1e-9:
            continue
        v = np.linalg.solve(A, np.asarray([d[i], d[j], d[k]]))
        if np.all(n @ v <= d + 1e-6):
            best = max(best, float(np.linalg.norm(v)))
    if best == 0.0:
        raise ValueError("hull planes do not bound a finite volume")
    return best


@dataclasses.dataclass(frozen=True)
class ColliderTable:
    """Compiled collider set: [C] rows as tensors on one device.

    `kinds`, `identity_rot` (unrotated?) and `hull_counts` (planes per hull,
    0 for other kinds) are static tuples: the plain narrow phase specialises
    on them per collider, and the CUDA kernel reads them from its packed
    table. `layers` holds the uint32 layer masks in int64, as
    `SpawnerParams.collision_mask` does, so 0xFFFFFFFF survives."""

    kinds: Tuple[int, ...]
    identity_rot: Tuple[bool, ...]
    hull_counts: Tuple[int, ...]
    position: torch.Tensor  # [C, 3] f32
    rotation: torch.Tensor  # [C, 4] f32 xyzw
    params: torch.Tensor  # [C, 3] f32 (unused slots 0)
    layers: torch.Tensor  # [C] int64 holding uint32
    active: torch.Tensor  # [C] f32: 1.0 live, 0.0 disabled
    # [C, HULL_MAX_PLANES, 4] (nx, ny, nz, d) local-space plane rows, padded
    # with (0, 0, 0, BIG); [C, 1, 4] zeros when the scene has no hull
    hull_planes: torch.Tensor

    @property
    def count(self) -> int:
        return len(self.kinds)

    @property
    def device(self) -> torch.device:
        return self.position.device


TABLE_TENSORS = ("position", "rotation", "params", "layers", "active", "hull_planes")  # the JAX data fields
TABLE_STATIC = ("kinds", "identity_rot", "hull_counts")  # its meta fields


def compile_colliders(colliders: List[Collider], device=DEFAULT_DEVICE) -> ColliderTable:
    """The JAX package's compile_colliders, with the tensors on `device`."""
    device = resolve_device(device)
    c = len(colliders)
    params = np.zeros((max(c, 1), 3), dtype=np.float32)
    for i, col in enumerate(colliders):
        params[i, : len(col.params)] = col.params
    any_hull = any(col.kind == COLLIDER_HULL for col in colliders)
    hp = np.zeros((max(c, 1), HULL_MAX_PLANES if any_hull else 1, 4), np.float32)
    if any_hull:
        hp[:, :, 3] = _HULL_PAD_D  # padding rows: 0.x <= BIG, never constrains
        for i, col in enumerate(colliders):
            if col.kind == COLLIDER_HULL:
                hp[i, : len(col.planes)] = np.asarray(col.planes, np.float32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return ColliderTable(
        kinds=tuple(int(col.kind) for col in colliders),
        identity_rot=tuple(tuple(col.rotation) == (0.0, 0.0, 0.0, 1.0) for col in colliders),
        hull_counts=tuple(len(col.planes) if col.kind == COLLIDER_HULL else 0 for col in colliders),
        position=t(np.array([col.position for col in colliders], dtype=np.float32).reshape(c, 3)),
        rotation=t(np.array([col.rotation for col in colliders], dtype=np.float32).reshape(c, 4)),
        params=t(params[:c]),
        layers=t(np.array([col.layers for col in colliders], dtype=np.uint32).reshape(c).astype(np.int64)),
        active=t(np.ones((c,), np.float32)),
        hull_planes=t(hp[:c]),
    )


def masked_layers(table: ColliderTable) -> torch.Tensor:
    """Effective layer masks (int64): disabled colliders get layers 0, which
    every narrow-phase consumer skips ((lane_mask & 0) != 0 is false)."""
    return torch.where(table.active > 0, table.layers, torch.zeros_like(table.layers))


def empty_collider_table(device=DEFAULT_DEVICE) -> ColliderTable:
    return compile_colliders([], device)
