"""Render boundary: the 64 B/instance contract and the extract's packs.

  * `ParticleInstance` rows of 16 f32: [pos xyz, scale, rot xyzw,
    base rgba, emissive rgba] (reference render.rs:95-115).
  * `FireworkUniform {alpha_mode, pbr, fade_edge, fade_scene, flags}`.

`pack_render_planes` is the plain version of the step kernel's render-pack
block: 9 f32 planes (instance scale with 0 on dead lanes, base rgba,
emissive rgba), or in f16 mode the whole instance record, 12 or 16 f16
planes; `planes_to_rows` compacts their live lanes into contract rows on
the host. The packs of one particle type from a pool state, composed torch
ops on either device: `pack_instances_dense` (every lane, dead ones at
scale 0) and its f16 twin, and the compacting `pack_instances` (rows) and
`pack_instances_planar` (planes), an exclusive cumsum and a scatter, as the
JAX package's XLA composes them. The host side: `RenderItem`,
`compact_dense` (the native ring library's compaction), the back-to-front
instance sort and the frustum test of a spawner's AABB. Lights, shadows and
the other host-side render code of the JAX package are framework-free and
are not ported yet.

f16 records quantize positions: an f16 ulp is ~2^-10 of the magnitude (1
mm near 1 unit, 6 cm near 64 units, 0.5 near 1 km), so they suit effects
within tens of units of the origin or of a local frame; colours and
quaternions in [0, 1] lose nothing visible. The simulation stays f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import native
from .compiled import CompiledSpawner, SpawnerParams, SpawnerStatic
from .curve import eval_curve_static, eval_gradient_static
from .pool import PoolState
from .step import lifetime_of, scale_factor

FIREWORK_BASE_COLOR_TEXTURE_BIT = 1
FIREWORK_NORMAL_MAP_TEXTURE_BIT = 1 << 1
FIREWORK_ORM_TEXTURE_BIT = 1 << 2


@dataclasses.dataclass(frozen=True)
class FireworkUniform:
    """Per-system render uniform (render.rs:354-362); 32 bytes with pad."""

    alpha_mode: int
    pbr: int
    fade_edge: float
    fade_scene: float
    flags: int

    def to_bytes(self) -> bytes:
        """std140-style packing of the WGSL struct: 2x u32, 2x f32, u32,
        12 bytes padding."""
        buf = np.zeros(8, dtype=np.uint32)
        buf[0] = self.alpha_mode
        buf[1] = self.pbr
        buf[2:4] = np.array([self.fade_edge, self.fade_scene], dtype=np.float32).view(np.uint32)
        buf[4] = self.flags
        return buf.tobytes()


def make_uniform(compiled: CompiledSpawner, type_index: int) -> FireworkUniform:
    base_tex, normal_tex, orm_tex = compiled.textures[type_index]
    flags = 0
    if base_tex is not None:
        flags |= FIREWORK_BASE_COLOR_TEXTURE_BIT
    if normal_tex is not None:
        flags |= FIREWORK_NORMAL_MAP_TEXTURE_BIT
    if orm_tex is not None:
        flags |= FIREWORK_ORM_TEXTURE_BIT
    return FireworkUniform(
        alpha_mode=compiled.blend_modes[type_index],
        pbr=1 if compiled.pbr_flags[type_index] else 0,
        fade_edge=compiled.fade_edges[type_index],
        fade_scene=compiled.fade_scenes[type_index],
        flags=flags,
    )


def compute_render_fields(params: SpawnerParams, state: PoolState, type_index: int):
    """Scale and base/emissive colors of one particle type, recomputed from
    (initial_scale, age, lifetime). Returns (scale, base rgba, emis rgba)."""
    t = type_index
    kinds = torch.stack([params.scale_kind[t], params.scale_n[t], params.base_kind[t], params.base_n[t],
                         params.emis_kind[t], params.emis_n[t]]).tolist()
    age_pct = state.age / state.lifetime
    scale = state.initial_scale * eval_curve_static(params.scale_ts[t], params.scale_vs[t], kinds[0], kinds[1],
                                                    age_pct)
    base = eval_gradient_static(params.base_ts[t], params.base_vs[t], kinds[2], kinds[3], age_pct)
    emis = eval_gradient_static(params.emis_ts[t], params.emis_vs[t], kinds[4], kinds[5], age_pct)
    return scale, base, emis


def pack_instances_dense(params: SpawnerParams, state: PoolState, type_index: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compaction-free extract: [16, N] planes over every slot, dead lanes as
    zero-scale, zero-alpha quads. Returns (planes, live count)."""
    sel = state.alive & (state.ptype == type_index)
    scale, base, emis = compute_render_fields(params, state, type_index)
    planes = torch.stack([
        state.px, state.py, state.pz, torch.where(sel, scale, 0.0),
        state.qx, state.qy, state.qz, state.qw,
        base[0], base[1], base[2], torch.where(sel, base[3], 0.0),
        emis[0], emis[1], emis[2], emis[3],
    ])
    return planes, sel.sum(dtype=torch.int32)


def _compact_index(sel: torch.Tensor) -> torch.Tensor:
    """Each selected lane's exclusive rank among the selected lanes (its row
    in the compacted buffer); unselected lanes map to the spare row n."""
    seli = sel.to(torch.int32)
    rank = torch.cumsum(seli, 0, dtype=torch.int32) - seli
    return torch.where(sel, rank, sel.shape[0]).to(torch.int64)


def _instance_columns(params: SpawnerParams, state: PoolState, type_index: int) -> list:
    """The 16 contract columns of every lane as one type (unmasked)."""
    scale, base, emis = compute_render_fields(params, state, type_index)
    return [state.px, state.py, state.pz, scale, state.qx, state.qy, state.qz, state.qw, *base, *emis]


def pack_instances(params: SpawnerParams, state: PoolState, type_index: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The live lanes of one particle type compacted into [N, 16] f32
    contract rows, slot order kept; rows past the count are zero. Returns
    (rows, count): an exclusive cumsum and a scatter, no host wait."""
    n = state.capacity
    sel = state.alive & (state.ptype == type_index)
    rows = torch.stack(_instance_columns(params, state, type_index), dim=-1)
    buf = torch.zeros((n + 1, 16), dtype=torch.float32, device=rows.device)
    buf.index_copy_(0, _compact_index(sel), rows)
    return buf[:n], sel.sum(dtype=torch.int32)


def pack_instances_planar(params: SpawnerParams, state: PoolState,
                          type_index: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`pack_instances` in the planar layout: [16, N] f32 planes, the first
    `count` columns the live lanes in slot order, the rest zero. Returns
    (planes, count)."""
    n = state.capacity
    sel = state.alive & (state.ptype == type_index)
    vals = torch.stack(_instance_columns(params, state, type_index))
    planes = torch.zeros((16, n + 1), dtype=torch.float32, device=vals.device)
    planes.index_copy_(1, _compact_index(sel), vals)
    return planes[:, :n].contiguous(), sel.sum(dtype=torch.int32)


def pack_instances_dense_f16(params: SpawnerParams, state: PoolState,
                             type_index: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`pack_instances_dense` in f16 (32 B per instance; rounded to nearest
    even; see the module's note on position quantization). Returns (planes
    [16, N] f16, live count)."""
    planes, count = pack_instances_dense(params, state, type_index)
    return planes.to(torch.float16), count


def pack_render_planes(static: SpawnerStatic, params: SpawnerParams, state: PoolState, mode=True) -> tuple:
    """Plain version of the kernel's render-pack block on a post-step state,
    each lane evaluated with its own type's curves. mode True: 9 f32 planes
    (instance scale, 0 on dead lanes; base r, g, b, a; emissive r, g, b, a).
    mode "f16": the instance record as f16 planes, the f32 values rounded
    to nearest even: px, py, pz, instance scale, then qx, qy, qz, qw unless
    rotation is elided (12 planes, else 16), base rgba, emissive rgba."""
    life = lifetime_of(static, {"age": state.age, "lifetime": state.lifetime})
    age_pct = state.age / life
    ptype = state.ptype
    scale = state.initial_scale * scale_factor(static, params, ptype, age_pct)
    inst = torch.where(state.alive, scale, 0.0)
    base = emis = None
    for t in range(static.num_types):
        bk, bn, ek, en = static.color_curve_meta[t]
        bt = eval_gradient_static(params.base_ts[t], params.base_vs[t], bk, bn, age_pct)
        et = eval_gradient_static(params.emis_ts[t], params.emis_vs[t], ek, en, age_pct)
        if base is None:
            base, emis = bt, et
        else:
            base = [torch.where(ptype == t, b1, b0) for b0, b1 in zip(base, bt)]
            emis = [torch.where(ptype == t, e1, e0) for e0, e1 in zip(emis, et)]
    if mode == "f16":
        rot = () if static.elide_rotation else (state.qx, state.qy, state.qz, state.qw)
        return tuple(p.to(torch.float16) for p in (state.px, state.py, state.pz, inst, *rot, *base, *emis))
    return (inst, *base, *emis)


# the rows' constant columns where a record leaves planes out: the identity
# quaternion of an elided rotation
ROW_DEFAULTS = (0.0,) * 7 + (1.0,) + (0.0,) * 8


def record_columns(planes) -> list:
    """The 12- or 16-plane f16 record by contract column, None for the
    quaternion's columns of a 12-plane record."""
    planes = list(planes)
    if len(planes) == 12:
        return planes[:4] + [None] * 4 + planes[4:]
    if len(planes) != 16:
        raise ValueError(f"an f16 record has 12 or 16 planes, got {len(planes)}")
    return planes


def planes_to_rows(static: SpawnerStatic, state: PoolState, packed) -> np.ndarray:
    """Assemble and compact the 16-column contract from a render pack, on
    the host. packed: the 9 f32 render-pack planes, with positions and the
    quaternion from the post-step state (under rotation elision the
    identity quaternion is filled in) -> [count, 16] f32 rows; or the f16
    record (12 or 16 planes; the state is not read) -> [count, 16] f16 rows.
    Scale 0 (either sign in f16) marks dead lanes; slot order is kept."""
    if packed[0].dtype == torch.float16:
        cols = [None if p is None else p.cpu().numpy() for p in record_columns(packed)]
        live = (cols[3].view(np.uint16) & 0x7FFF) != 0
        out = np.empty((int(live.sum()), 16), np.float16)
        for i, col in enumerate(cols):
            out[:, i] = np.float16(ROW_DEFAULTS[i]) if col is None else col[live]
        return out
    q = (None,) * 4 if static.elide_rotation else (state.qx, state.qy, state.qz, state.qw)
    cols = [state.px, state.py, state.pz, packed[0], *q, *packed[1:9]]
    return native.compact_dense_planes([None if p is None else p.cpu().numpy() for p in cols], ROW_DEFAULTS)


def instances_to_bytes(buffer: np.ndarray) -> bytes:
    """Dense instance rows -> the exact 64 B/particle byte stream."""
    return np.ascontiguousarray(buffer, dtype=np.float32).tobytes()


def compact_dense(planes: np.ndarray) -> np.ndarray:
    """[16, N] dense planes (dead lanes at scale == 0 in plane 3) ->
    compacted [count, 16] instance rows, slot order kept (the ring
    library's compaction)."""
    return native.compact_dense(planes)


# alpha_mode codes (BlendMode.as_u32) whose blend operators do not commute:
# Blend (2) and Premultiplied (3) composite "over"; Add (4) and Multiply (5)
# commute; Opaque (0) depth tests.
ORDER_DEPENDENT_ALPHA_MODES = frozenset((2, 3))


def sort_instances_back_to_front(instances: np.ndarray, camera_pos) -> np.ndarray:
    """Stable farthest-first reorder of instance rows by squared distance
    from `camera_pos` (the compositing order of the non-commutative blend
    modes); rows keep the 64 B contract layout."""
    if instances.shape[0] <= 1:
        return instances
    cam = np.asarray(camera_pos, np.float32).reshape(3)
    d = instances[:, :3] - cam
    d2 = (d * d).sum(axis=1)
    return instances[np.argsort(-d2, kind="stable")]


def frustum_planes(view_proj, depth_zero_one: bool = True) -> np.ndarray:
    """The 6 view-frustum planes of a 4x4 view-projection matrix
    (Gribb-Hartmann; clip = view_proj @ [x, y, z, 1], row-major): [6, 4] f32
    rows (nx, ny, nz, d), normalised, plane . (x, y, z, 1) >= 0 inside.
    depth_zero_one: the WebGPU/D3D clip depth 0 <= z <= w, else OpenGL's
    -w <= z <= w."""
    m = np.asarray(view_proj, dtype=np.float32).reshape(4, 4)
    rows = [m[3] + m[0], m[3] - m[0], m[3] + m[1], m[3] - m[1]]
    rows.append(m[2] if depth_zero_one else m[3] + m[2])  # near
    rows.append(m[3] - m[2])  # far
    planes = np.stack(rows).astype(np.float32)
    norm = np.linalg.norm(planes[:, :3], axis=1)
    norm = np.where(norm > 0.0, norm, 1.0).astype(np.float32)
    return planes / norm[:, None]


def aabb_intersects_frustum(aabb_min, aabb_max, planes: np.ndarray) -> bool:
    """Conservative AABB-vs-frustum test (p-vertex form): culled only if the
    box corner farthest along some plane's normal lies outside it."""
    mn = np.asarray(aabb_min, dtype=np.float32).reshape(3)
    mx = np.asarray(aabb_max, dtype=np.float32).reshape(3)
    p_vertex = np.where(planes[:, :3] >= 0.0, mx[None, :], mn[None, :])
    dist = (planes[:, :3] * p_vertex).sum(axis=1) + planes[:, 3]
    return bool((dist >= 0.0).all())


@dataclasses.dataclass(frozen=True)
class RenderItem:
    """One draw call's data: the reference's render entity per (spawner x
    non-empty type) (render.rs:382-423)."""

    spawner_id: int
    type_index: int
    instances: np.ndarray  # [count, 16] f32
    count: int
    uniform: FireworkUniform
    textures: Tuple[Optional[str], Optional[str], Optional[str]]
    frame_id: Optional[int] = None  # the step these rows belong to (Scene.render_async); None: synchronous
    layers: int = 1  # RenderLayers bitmask of the spawner
