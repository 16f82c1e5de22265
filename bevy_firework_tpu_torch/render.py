"""Render boundary, the slice's part: the 64 B/instance contract.

  * `ParticleInstance` rows of 16 f32: [pos xyz, scale, rot xyzw,
    base rgba, emissive rgba] (reference render.rs:95-115).
  * `FireworkUniform {alpha_mode, pbr, fade_edge, fade_scene, flags}`.

`pack_render_planes` is the plain version of the step kernel's render-pack
block (9 planes: instance scale with 0 on dead lanes, base rgba, emissive
rgba); `planes_to_rows` compacts live lanes into contract rows on the host
with numpy. What `Scene.render_items` needs beside them is host numpy too:
`RenderItem`, `compact_dense`, the back-to-front instance sort and the
frustum test of a spawner's AABB. Lights, shadows and the other host-side
render code of the JAX package are framework-free and are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

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


def pack_render_planes(static: SpawnerStatic, params: SpawnerParams, state: PoolState) -> tuple:
    """Plain version of the kernel's render-pack block on a post-step state:
    (instance scale, 0 on dead lanes; base r, g, b, a; emissive r, g, b, a),
    each lane evaluated with its own type's curves."""
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
    return (inst, *base, *emis)


def planes_to_rows(static: SpawnerStatic, state: PoolState, packed) -> np.ndarray:
    """Assemble and compact the 16-plane contract from a post-step state and
    the 9 render-pack planes (scale == 0 marks dead lanes). Under rotation
    elision the identity quaternion is filled in on the host. Returns
    [count, 16] f32 rows in slot order."""
    host = [np.ascontiguousarray(p.cpu().numpy(), dtype=np.float32) for p in packed]
    live = host[0] != 0.0
    count = int(live.sum())
    out = np.empty((count, 16), np.float32)
    for i, name in enumerate(("px", "py", "pz")):
        out[:, i] = getattr(state, name).cpu().numpy()[live]
    out[:, 3] = host[0][live]
    for i, name in enumerate(("qx", "qy", "qz", "qw")):
        if static.elide_rotation:
            out[:, 4 + i] = 1.0 if name == "qw" else 0.0
        else:
            out[:, 4 + i] = getattr(state, name).cpu().numpy()[live]
    for c in range(8):
        out[:, 8 + c] = host[1 + c][live]
    return out


def instances_to_bytes(buffer: np.ndarray) -> bytes:
    """Dense instance rows -> the exact 64 B/particle byte stream."""
    return np.ascontiguousarray(buffer, dtype=np.float32).tobytes()


def compact_dense(planes: np.ndarray) -> np.ndarray:
    """[16, N] dense planes (dead lanes at scale == 0 in plane 3) ->
    compacted [count, 16] instance rows, slot order kept."""
    planes = np.ascontiguousarray(planes, dtype=np.float32)
    return np.ascontiguousarray(planes[:, planes[3] != 0.0].T)


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
    layers: int = 1  # RenderLayers bitmask of the spawner
