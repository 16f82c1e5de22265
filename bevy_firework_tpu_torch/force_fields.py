"""Force fields: scene-level acceleration sources (port of
`bevy_firework_tpu.force_fields`).

Four kinds, as in the JAX package:
  * POINT: radial pull toward (strength > 0) or push from `position`, linear
    falloff over `radius`: a = strength * max(0, 1 - d/radius) * (c - p) / d.
  * VORTEX: tangential swirl around the axis line through `position` along
    the unit `axis`, falling off with the distance to the axis.
  * AXIAL: pull toward (strength > 0) or push from the axis line.
  * TURBULENCE: the analytic curl of a 3-octave sine vector potential
    (divergence-free), scaled by a spherical falloff.

Fields add onto the per-type constant acceleration at the post-move
position, before drag, for the types whose `affected_by_fields` is set
(`step.advance`; the kernel at `ops/csrc/fused_step_kernel.cuh` `field_accel`).
Lanes on a field's singular locus (the point centre, the vortex axis) get 0
from it.

Authoring (`ForceField`) is host Python, the same as the JAX package's.
`FieldTable` is the compiled set: `kinds` a static tuple, the rows as host
numpy, and their tensors on an explicit device. The kernel wrapper packs
the host rows into its launch arguments, so a table rebuilt every frame (a
moving field) costs no device copy; the tensors, which the plain version
reads, are made on the device at their first use. `field_accel` is the
plain version, in component form, with the op order of the JAX package's
`field_accel`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from .utils.device import DEFAULT_DEVICE, resolve_device

FIELD_POINT = 0  # params: (strength, radius)
FIELD_VORTEX = 1  # params: (strength, radius); axis = unit vector
FIELD_AXIAL = 2  # params: (strength, radius); pull toward the axis line
FIELD_TURBULENCE = 3  # params: (strength, radius, frequency, phase)

EPS = float(np.float32(1e-6))  # singular-locus guard, as the f32 value it is


def _unit(axis):
    a = np.asarray(axis, np.float64)
    n = float(np.linalg.norm(a))
    if n < 1e-9:
        raise ValueError("ForceField axis must be non-zero")
    return tuple((a / n).astype(float))


@dataclasses.dataclass(frozen=True)
class ForceField:
    kind: int
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    axis: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    strength: float = 1.0
    radius: float = 5.0
    frequency: float = 1.0  # turbulence spatial scale
    phase: float = 0.0  # turbulence decorrelation / animation offset

    def __post_init__(self):
        if self.kind not in (FIELD_POINT, FIELD_VORTEX, FIELD_AXIAL, FIELD_TURBULENCE):
            raise ValueError(f"unknown ForceField kind {self.kind!r}")
        if self.radius <= 0.0:
            raise ValueError("ForceField.radius must be > 0 (falloff range)")

    @staticmethod
    def point(position, strength, radius):
        """Attractor (strength > 0) / repulsor (strength < 0)."""
        return ForceField(FIELD_POINT, tuple(position), (0.0, 1.0, 0.0), float(strength), float(radius))

    @staticmethod
    def vortex(position, axis, strength, radius):
        """Tangential swirl around the axis line through `position`."""
        return ForceField(FIELD_VORTEX, tuple(position), _unit(axis), float(strength), float(radius))

    @staticmethod
    def axial(position, axis, strength, radius):
        """Pull toward (strength > 0) / push away from the axis line."""
        return ForceField(FIELD_AXIAL, tuple(position), _unit(axis), float(strength), float(radius))

    @staticmethod
    def turbulence(position, strength, radius, frequency=1.0, phase=0.0):
        """Divergence-free curl-noise swirl (spherical falloff from
        `position` over `radius`)."""
        if frequency <= 0.0:
            raise ValueError("ForceField.turbulence frequency must be > 0")
        return ForceField(FIELD_TURBULENCE, tuple(position), (0.0, 1.0, 0.0), float(strength), float(radius),
                          frequency=float(frequency), phase=float(phase))


TABLE_SHAPES = {"position": (-1, 3), "axis": (-1, 3), "params": (-1, 4), "active": (-1,)}  # the JAX data fields


@dataclasses.dataclass(frozen=True, eq=False)
class FieldTable:
    """Compiled field set of F fields: `kinds` static; `rows` host f32 numpy
    by TABLE_SHAPES name: position [F, 3], axis [F, 3] (unit; vortex,
    axial), params [F, 4] (strength, radius, frequency, phase), active [F]
    (1.0 live, 0.0 disabled); the same rows as tensors on `device`
    (`position`, `axis`, `params`, `active`)."""

    kinds: Tuple[int, ...]
    rows: dict
    device: torch.device

    @property
    def count(self) -> int:
        return len(self.kinds)

    def tensor(self, name: str) -> torch.Tensor:
        """Row `name` on the table's device, made at first use and kept."""
        cache = self.__dict__.setdefault("_tensors", {})
        if name not in cache:
            cache[name] = torch.as_tensor(self.rows[name].copy(), device=self.device)
        return cache[name]

    position = property(lambda self: self.tensor("position"))
    axis = property(lambda self: self.tensor("axis"))
    params = property(lambda self: self.tensor("params"))
    active = property(lambda self: self.tensor("active"))


def field_table_from_rows(kinds, rows: dict, device=DEFAULT_DEVICE) -> FieldTable:
    """A FieldTable on `device` (the card unless the caller passes "cpu")
    from host rows by TABLE_SHAPES name."""
    return FieldTable(kinds=tuple(int(k) for k in kinds), device=resolve_device(device),
                      rows={k: np.ascontiguousarray(np.asarray(rows[k], np.float32).reshape(shape))
                            for k, shape in TABLE_SHAPES.items()})


def compile_force_fields(fields: List[ForceField], device=DEFAULT_DEVICE, active=None) -> FieldTable:
    """The JAX package's compile_force_fields, with the tensors on `device`
    (the card unless the caller passes "cpu"). `active` optionally gives
    each field's on/off flag (default: all on)."""
    return field_table_from_rows(
        [f.kind for f in fields],
        dict(position=[f.position for f in fields], axis=[f.axis for f in fields],
             params=[(f.strength, f.radius, f.frequency, f.phase) for f in fields],
             active=np.ones(len(fields)) if active is None else [1.0 if a else 0.0 for a in active]),
        device)


# Turbulence wave basis: 3 octaves x 3 potential components of fixed,
# incommensurate unit directions, per-(octave, component) phases and
# per-octave amplitudes (the JAX package's values; the kernel's copies are
# generated from these by ops/table_layout.py).
TURB_DIRS = np.float32([
    [[0.537, 0.721, -0.438], [-0.631, 0.442, 0.637], [0.289, -0.817, 0.499]],
    [[-0.758, 0.288, 0.585], [0.421, -0.693, -0.585], [0.652, 0.598, 0.466]],
    [[0.118, -0.937, 0.329], [-0.869, -0.159, -0.468], [0.504, 0.434, -0.747]],
])
TURB_PHASE = np.float32([[0.7, 2.3, 4.1], [1.9, 5.2, 0.4], [3.3, 1.1, 5.8]])
TURB_AMP = np.float32([1.0, 0.5, 0.25])


def _curl_sine_noise(freq, phase, rx, ry, rz):
    """Curl of psi_c = sum_o (amp_o/|k_o|) sin(k_{c,o} . r + phi): each
    partial is amp_o k_axis/|k_o| cos(...), with the |k| cancellation folded
    in (the JAX package's op order)."""
    cx = torch.zeros_like(rx)
    cy = torch.zeros_like(rx)
    cz = torch.zeros_like(rx)
    for o in range(3):
        ko = freq * float(2.0 ** o)
        dpsi = []
        for c in range(3):
            d = TURB_DIRS[o, c]
            arg = ko * (float(d[0]) * rx + float(d[1]) * ry + float(d[2]) * rz) + float(TURB_PHASE[o, c]) + phase
            g = float(TURB_AMP[o]) * torch.cos(arg)
            dpsi.append((g * float(d[0]), g * float(d[1]), g * float(d[2])))
        cx = cx + dpsi[2][1] - dpsi[1][2]
        cy = cy + dpsi[0][2] - dpsi[2][0]
        cz = cz + dpsi[1][0] - dpsi[0][1]
    return cx, cy, cz


def field_accel(table: FieldTable, px, py, pz):
    """Summed field acceleration (ax, ay, az) at component positions: the
    plain version of the kernel's `field_accel`. Table entries enter as 0-d
    tensors on the table's device, so every product and quotient is an f32
    op between tensors (PyTorch's CUDA ops turn a division by a host scalar
    into a multiply by its reciprocal)."""
    ax = torch.zeros_like(px)
    ay = torch.zeros_like(px)
    az = torch.zeros_like(px)
    for i, k in enumerate(table.kinds):
        s = table.params[i, 0] * table.active[i]
        inv_radius = 1.0 / table.params[i, 1]
        rx = px - table.position[i, 0]
        ry = py - table.position[i, 1]
        rz = pz - table.position[i, 2]
        if k == FIELD_TURBULENCE:
            d = torch.sqrt(rx * rx + ry * ry + rz * rz)
            w = torch.clamp_min(1.0 - d * inv_radius, 0.0)
            tx, ty, tz = _curl_sine_noise(table.params[i, 2], table.params[i, 3], rx, ry, rz)
            g = s * w
            ax = ax + g * tx
            ay = ay + g * ty
            az = az + g * tz
        elif k == FIELD_POINT:
            d = torch.sqrt(rx * rx + ry * ry + rz * rz)
            w = torch.clamp_min(1.0 - d * inv_radius, 0.0)
            g = torch.where(d > EPS, s * w / torch.clamp_min(d, EPS), 0.0)
            ax = ax - g * rx
            ay = ay - g * ry
            az = az - g * rz
        else:  # FIELD_VORTEX / FIELD_AXIAL: geometry about the axis line
            ux, uy, uz = table.axis[i, 0], table.axis[i, 1], table.axis[i, 2]
            tx = uy * rz - uz * ry
            ty = uz * rx - ux * rz
            tz = ux * ry - uy * rx
            d_ax = torch.sqrt(tx * tx + ty * ty + tz * tz)
            w = torch.clamp_min(1.0 - d_ax * inv_radius, 0.0)
            g = torch.where(d_ax > EPS, s * w / torch.clamp_min(d_ax, EPS), 0.0)
            if k == FIELD_VORTEX:
                ax = ax + g * tx
                ay = ay + g * ty
                az = az + g * tz
            else:  # toward the axis: -r_perp = -(r - (r.u)u)
                dot = rx * ux + ry * uy + rz * uz
                ax = ax - g * (rx - dot * ux)
                ay = ay - g * (ry - dot * uy)
                az = az - g * (rz - dot * uz)
    return ax, ay, az
