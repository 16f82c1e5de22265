"""Quaternion math on component-split tensors (xyzw), plus the numpy helpers
that spawner lowering uses at compile time.

The op order of every expression matches `bevy_firework_tpu.utils.quat`
and the CUDA step kernel (`ops/csrc/fused_step.cu`), so the plain version
and the kernel agree bit for bit where no libm call is involved.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS_ANGLE = float(np.float32(1e-12))
_SMALL_ANGLE = float(np.float32(1e-8))


def quat_rotate_comp(qx, qy, qz, qw, vx, vy, vz):
    """Rotate vector components by quaternion components (broadcasting)."""
    tx = 2.0 * (qy * vz - qz * vy)
    ty = 2.0 * (qz * vx - qx * vz)
    tz = 2.0 * (qx * vy - qy * vx)
    ox = vx + qw * tx + (qy * tz - qz * ty)
    oy = vy + qw * ty + (qz * tx - qx * tz)
    oz = vz + qw * tz + (qx * ty - qy * tx)
    return ox, oy, oz


def quat_mul_comp(x1, y1, z1, w1, x2, y2, z2, w2):
    """Hamilton product components: (q1 ⊗ q2)."""
    return (
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    )


def quat_from_scaled_axis_comp(vx: torch.Tensor, vy: torch.Tensor, vz: torch.Tensor):
    """glam `Quat::from_scaled_axis` on components; zero vector -> identity."""
    angle = torch.sqrt(vx * vx + vy * vy + vz * vz)
    safe = torch.clamp_min(angle, _EPS_ANGLE)
    half = 0.5 * angle
    s = torch.sin(half) / safe
    small = angle < _SMALL_ANGLE
    s = torch.where(small, torch.zeros_like(s), s)
    w = torch.where(small, torch.ones_like(s), torch.cos(half))
    return vx * s, vy * s, vz * s, w


# ---------------------------------------------------------------------------
# Host-side (numpy, compile-time) helpers
# ---------------------------------------------------------------------------


def np_quat_from_rotation_arc(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Shortest-arc rotation taking unit vector src to unit vector dst (glam
    `Quat::from_rotation_arc`; antiparallel inputs rotate pi about an
    arbitrary axis orthogonal to src)."""
    src = np.asarray(src, dtype=np.float32)
    dst = np.asarray(dst, dtype=np.float32)
    d = float(np.dot(src, dst))
    if d > 1.0 - 1e-6:
        return np.array([0, 0, 0, 1], dtype=np.float32)
    if d < -1.0 + 1e-6:
        axis = np_any_orthonormal(src)
        return np.array([axis[0], axis[1], axis[2], 0.0], dtype=np.float32)
    c = np.cross(src, dst)
    w = 1.0 + d
    q = np.array([c[0], c[1], c[2], w], dtype=np.float32)
    return (q / np.linalg.norm(q)).astype(np.float32)


def np_any_orthonormal(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=np.float32)
    if abs(v[0]) <= abs(v[1]) and abs(v[0]) <= abs(v[2]):
        o = np.array([0.0, -v[2], v[1]], dtype=np.float32)
    elif abs(v[1]) <= abs(v[2]):
        o = np.array([-v[2], 0.0, v[0]], dtype=np.float32)
    else:
        o = np.array([-v[1], v[0], 0.0], dtype=np.float32)
    return (o / np.linalg.norm(o)).astype(np.float32)


def np_quat_mul(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dtype=np.float32,
    )
