"""Emission shapes: where on the spawner a particle appears.

`EmissionShape` and its compiled f32[8] row ([kind, radius, qx, qy, qz, qw,
ey, ez]) are identical to `bevy_firework_tpu.emission_shape`. Distributions,
quirks included:
  * Point  -> zero offset.
  * Sphere(R): PitchYaw(u·2π, v·π).to_unit_vec() · r · R (center-biased).
  * Circle{normal, radius}: arc(+Y->normal) ⊗ rot_y(u·2π) ⊗ (r·R, 0, 0).
  * Box{half_extents, normal}: uniform in the oriented box volume.
  * Ring{normal, radius}: uniform on the circle's edge.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .rand import TWO_PI
from .utils.quat import np_quat_from_rotation_arc, quat_rotate_comp

SHAPE_POINT = 0
SHAPE_SPHERE = 1
SHAPE_CIRCLE = 2
SHAPE_BOX = 3
SHAPE_RING = 4

PI = float(np.float32(np.pi))


@dataclasses.dataclass(frozen=True)
class EmissionShape:
    kind: int = SHAPE_POINT
    radius: float = 0.0  # sphere/circle/ring radius; box half-extent x
    normal: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    extents: Tuple[float, float] = (0.0, 0.0)  # box half-extents y, z

    @staticmethod
    def point() -> "EmissionShape":
        return EmissionShape(SHAPE_POINT)

    @staticmethod
    def sphere(radius: float) -> "EmissionShape":
        return EmissionShape(SHAPE_SPHERE, float(radius))

    @staticmethod
    def circle(normal, radius: float) -> "EmissionShape":
        return EmissionShape(SHAPE_CIRCLE, float(radius), tuple(float(x) for x in normal))

    @staticmethod
    def box(half_extents, normal=(0.0, 1.0, 0.0)) -> "EmissionShape":
        hx, hy, hz = (float(v) for v in half_extents)
        return EmissionShape(SHAPE_BOX, hx, tuple(float(x) for x in normal), (hy, hz))

    @staticmethod
    def ring(normal, radius: float) -> "EmissionShape":
        return EmissionShape(SHAPE_RING, float(radius), tuple(float(x) for x in normal))

    def to_dict(self):
        return {"kind": ["point", "sphere", "circle", "box", "ring"][self.kind],
                "radius": self.radius, "normal": list(self.normal), "extents": list(self.extents)}

    @staticmethod
    def from_dict(d):
        kind = {"point": SHAPE_POINT, "sphere": SHAPE_SPHERE, "circle": SHAPE_CIRCLE,
                "box": SHAPE_BOX, "ring": SHAPE_RING}[d["kind"]]
        return EmissionShape(kind, float(d.get("radius", 0.0)),
                             tuple(float(x) for x in d.get("normal", (0, 1, 0))),
                             tuple(float(x) for x in d.get("extents", (0.0, 0.0))))

    def compile(self) -> np.ndarray:
        """f32[8]: [kind, radius, qx, qy, qz, qw, ey, ez], q = arc(+Y->normal)."""
        n = np.asarray(self.normal, dtype=np.float32)
        ln = np.linalg.norm(n)
        n = n / ln if ln > 0 else np.array([0, 1, 0], np.float32)
        q = np_quat_from_rotation_arc(np.array([0, 1, 0], np.float32), n)
        return np.array([float(self.kind), self.radius, q[0], q[1], q[2], q[3],
                         self.extents[0], self.extents[1]], dtype=np.float32)


def sample_shape_comp(row, u0, u1, u2):
    """EmissionShape::generate_point from a compiled 8-float row (0-d
    tensors) and lane uniforms, selecting by kind without a host read (the
    row may live on the card). Returns (x, y, z) lane tensors."""
    kind, radius = row[0], row[1]
    u = u0 * TWO_PI
    v = u1 * PI
    rr = u2 * radius
    cu = torch.cos(u)
    su = torch.sin(u)
    sx, sy, sz = -torch.sin(v) * cu * rr, su * rr, -torch.cos(v) * cu * rr
    lx, lz = rr * cu, -rr * su
    is_sphere = kind == SHAPE_SPHERE
    is_circle = kind == SHAPE_CIRCLE
    is_box = kind == SHAPE_BOX
    is_ring = kind == SHAPE_RING
    zero = torch.zeros_like(u0)
    llx = torch.where(is_circle, lx, torch.where(is_ring, radius * cu, (u0 * 2.0 - 1.0) * radius))
    lly = torch.where(is_box, (u1 * 2.0 - 1.0) * row[6], zero)
    llz = torch.where(is_circle, lz, torch.where(is_ring, -radius * su, (u2 * 2.0 - 1.0) * row[7]))
    rx, ry, rz = quat_rotate_comp(row[2], row[3], row[4], row[5], llx, lly, llz)
    rot_sel = is_circle | is_box | is_ring
    ox = torch.where(is_sphere, sx, torch.where(rot_sel, rx, zero))
    oy = torch.where(is_sphere, sy, torch.where(rot_sel, ry, zero))
    oz = torch.where(is_sphere, sz, torch.where(rot_sel, rz, zero))
    return ox, oy, oz
