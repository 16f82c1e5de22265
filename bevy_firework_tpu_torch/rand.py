"""Random-range value types (`RandF32`, `RandVec3`) and their samplers.

Authoring types and their compiled rows are identical to
`bevy_firework_tpu.rand`. Samplers take pre-drawn uniforms in [0, 1) so that
the step draws all of a lane's randomness in one place (the Philox layout in
`prng.py`); their op order matches the CUDA kernel's `randvec3_row`.

Conventions:
  * RandVec3 cone sampling: deviation a ~ U[0, spread), azimuth
    b ~ U[0, 2π); the deviated +Y axis is rotated into `direction`'s frame
    with the shortest-arc rotation from +Y.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .utils.f32 import fma32
from .utils.quat import np_quat_from_rotation_arc, quat_rotate_comp

TWO_PI = float(np.float32(2.0 * np.pi))


@dataclasses.dataclass(frozen=True)
class RandF32:
    min: float = 0.0
    max: float = 0.0

    @staticmethod
    def constant(x: float) -> "RandF32":
        return RandF32(float(x), float(x))

    def to_dict(self):
        return {"min": self.min, "max": self.max}

    @staticmethod
    def from_dict(d):
        return RandF32(float(d["min"]), float(d["max"]))


def sample_randf32(u, lo, hi):
    """u in [0, 1) -> uniform [lo, hi); f32, broadcasts."""
    return lo + (hi - lo) * u


def sample_randf32_fused(u, lo, hi):
    """`sample_randf32` as XLA compiles it for the CPU: the product
    contracted into the sum, one rounding (the XLA-layout step's form)."""
    return fma32(hi - lo, u, lo)


@dataclasses.dataclass(frozen=True)
class RandVec3:
    magnitude: RandF32 = RandF32(0.0, 0.0)
    direction: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    spread: float = 0.0

    @staticmethod
    def constant(v) -> "RandVec3":
        v = np.asarray(v, dtype=np.float32)
        mag = float(np.linalg.norm(v))
        if mag == 0.0:
            return RandVec3(RandF32.constant(0.0), (0.0, 1.0, 0.0), 0.0)
        d = (v / mag).astype(np.float32)
        return RandVec3(RandF32.constant(mag), (float(d[0]), float(d[1]), float(d[2])), 0.0)

    def to_dict(self):
        return {"magnitude": self.magnitude.to_dict(), "direction": list(self.direction), "spread": self.spread}

    @staticmethod
    def from_dict(d):
        return RandVec3(RandF32.from_dict(d["magnitude"]), tuple(float(x) for x in d["direction"]), float(d["spread"]))

    def compile(self) -> np.ndarray:
        """f32[7] row: [mag_lo, mag_hi, spread, qx, qy, qz, qw], q the
        shortest-arc rotation from +Y to `direction`."""
        d = np.asarray(self.direction, dtype=np.float32)
        n = np.linalg.norm(d)
        d = d / n if n > 0 else np.array([0, 1, 0], dtype=np.float32)
        q = np_quat_from_rotation_arc(np.array([0, 1, 0], np.float32), d)
        return np.array([self.magnitude.min, self.magnitude.max, self.spread, q[0], q[1], q[2], q[3]],
                        dtype=np.float32)


def sample_randvec3_comp(row, u_mag, u_dev, u_azim):
    """RandVec3.generate() from a compiled 7-float row (0-d tensors) and
    lane uniforms. Returns (x, y, z) lane tensors."""
    import torch

    mag = sample_randf32(u_mag, row[0], row[1])
    a = u_dev * row[2]
    b = u_azim * TWO_PI
    sa, ca = torch.sin(a), torch.cos(a)
    lx, ly, lz = sa * torch.cos(b), ca, -sa * torch.sin(b)
    dx, dy, dz = quat_rotate_comp(row[3], row[4], row[5], row[6], lx, ly, lz)
    return mag * dx, mag * dy, mag * dz
