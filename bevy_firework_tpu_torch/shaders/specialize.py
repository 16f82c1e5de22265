"""Executable pipeline specialization — the reference's `FireworkSpecializer`
(bevy_firework `src/render.rs:805-867`) + key derivation
(`render.rs:519-535`) + dummy bind resources (`render.rs:85-241`), as a
renderer-agnostic, testable artifact.

The reference resolves one concrete GPU pipeline per
(view msaa/hdr/prepass) x (system alpha_mode) combination: shader defs pick
the WGSL variant, the uniform bind-group layout swaps its depth-prepass
entry for the multisampled flavor, and absent textures bind 1x1 dummies.
This module performs the same resolution over the shipped
`particles.wgsl`:

  * `preprocess(src, defs)` — naga_oil-style `#ifdef/#else/#endif`
    resolution (the subset the shader uses).
  * `PipelineKey` / `key_for` — the exact key-bit mapping from
    `queue_particles` (`render.rs:519-535`): Blend -> BLEND_ALPHA,
    Premultiplied|Add -> BLEND_PREMULTIPLIED_ALPHA (distinguished later in
    shading, not the key), Multiply -> BLEND_MULTIPLY, Mask -> MAY_DISCARD.
  * `PipelineCache.specialize(key)` — produces (and memoizes) the variant:
    preprocessed WGSL (validated by the static checker — the "compile"),
    color-target state (format from the view; blend ALWAYS standard alpha
    blending regardless of alpha_mode, `render.rs:855-859`), multisample
    count, reverse-Z Greater depth test with writes off
    (`render.rs:775-782`), no culling, and the bind-group layout.
  * `DummyTextures` — 1x1 white RGBA dummies for absent base/normal/ORM
    textures and a per-sample-count 1x1 depth dummy
    (`DummyTextures::ensure_has_samples`); `bind_group_entries` assembles
    the group(2) bindings with real-or-dummy resolution driven by the
    uniform's flag bits.

A GPU consumer walks `SpecializedPipeline` fields 1:1 into its API
(wgpu/WebGPU/Vulkan); the repo's software viewer and tests consume it to
pin the mapping.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import particles_wgsl_source
from .wgsl_check import check_wgsl

# alpha_mode uniform values (docs/RENDER_CONTRACT.md §2; Bevy's AlphaMode
# discriminants): 0 opaque, 1 mask, 2 blend, 3 premultiplied, 4 add,
# 5 multiply.
ALPHA_OPAQUE, ALPHA_MASK, ALPHA_BLEND = 0, 1, 2
ALPHA_PREMULTIPLIED, ALPHA_ADD, ALPHA_MULTIPLY = 3, 4, 5

# Pipeline-key blend bits (`MeshPipelineKey` names, `render.rs:519-535`).
BLEND_ALPHA = "BLEND_ALPHA"
BLEND_PREMULTIPLIED_ALPHA = "BLEND_PREMULTIPLIED_ALPHA"
BLEND_MULTIPLY = "BLEND_MULTIPLY"
MAY_DISCARD = "MAY_DISCARD"

# The fixed target blend state (`BlendState::ALPHA_BLENDING`,
# `render.rs:855-859`) — applied for EVERY key; alpha_mode only selects
# key bits / shading behavior, never the hardware blend equation.
ALPHA_BLENDING = {
    "color": {"src_factor": "src-alpha", "dst_factor": "one-minus-src-alpha", "operation": "add"},
    "alpha": {"src_factor": "one", "dst_factor": "one-minus-src-alpha", "operation": "add"},
}


# ---------------------------------------------------------------------------
# Shader-def preprocessing (naga_oil subset: #ifdef / #ifndef / #else /
# #endif, nested; trailing comments allowed)
# ---------------------------------------------------------------------------

_DIRECTIVE = re.compile(r"^\s*#(ifdef|ifndef|else|endif)\b\s*([A-Za-z_][A-Za-z0-9_]*)?")


def preprocess(src: str, defs: frozenset | set = frozenset()) -> str:
    """Resolve `#ifdef NAME` blocks against `defs`. Inactive lines are
    dropped; directive lines never survive to the output."""
    out: List[str] = []
    # stack of (parent_active, this_branch_taken, any_branch_taken)
    stack: List[List[bool]] = []
    active = True
    for lineno, line in enumerate(src.splitlines(), 1):
        m = _DIRECTIVE.match(line)
        if not m:
            if active:
                out.append(line)
            continue
        kind, name = m.group(1), m.group(2)
        if kind in ("ifdef", "ifndef"):
            if name is None:
                raise ValueError(f"line {lineno}: #{kind} without a name")
            cond = (name in defs) if kind == "ifdef" else (name not in defs)
            stack.append([active, active and cond, active and cond])
            active = active and cond
        elif kind == "else":
            if not stack:
                raise ValueError(f"line {lineno}: #else without #ifdef")
            parent, _this, any_taken = stack[-1]
            take = parent and not any_taken
            stack[-1] = [parent, take, any_taken or take]
            active = take
        else:  # endif
            if not stack:
                raise ValueError(f"line {lineno}: #endif without #ifdef")
            parent, _this, _any = stack.pop()
            active = parent
    if stack:
        raise ValueError("unterminated #ifdef block")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# Pipeline key
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelineKey:
    """The bits `queue_particles` folds into `FireworkPipelineKey`
    (`render.rs:513-538`): the view's msaa/hdr/prepass state plus the
    system's alpha_mode-derived blend bit."""

    msaa_samples: int = 1
    depth_prepass: bool = False
    hdr: bool = False
    blend_bit: Optional[str] = None  # one of the BLEND_*/MAY_DISCARD names
    # a directional shadow map is available for sampling in pbr_shade (the
    # reference inherits shadows from Bevy's clustered PBR; here it's an
    # explicit key bit like the prepass)
    shadow_map: bool = False
    # the view has distance fog (Bevy DistanceFog; the reference inherits
    # the fog stage from apply_pbr_lighting — here an explicit key bit that
    # binds a FogUniform at group(2) binding 11 and compiles the mix in)
    fog: bool = False
    # the view carries a light table (N directional/point/spot lights +
    # ambient, Bevy clustered-PBR semantics — the reference inherits the
    # whole environment from apply_pbr_lighting; here an explicit key bit
    # that binds a LightsUniform at group(2) binding 12 and compiles the
    # light loop into pbr_shade)
    lights: bool = False
    # per-light shadow atlas: one depth texture of
    # grid x grid tiles + a matrix array uniform; any dir/spot light row
    # with an atlas tile attenuates by its own map. Requires `lights`.
    shadow_atlas: bool = False

    def target_format(self) -> str:
        # `key.target_format()` (`render.rs:831`): the view's HDR choice.
        return "rgba16float" if self.hdr else "bgra8unorm-srgb"


def key_for(
    alpha_mode: int,
    *,
    msaa_samples: int = 1,
    depth_prepass: bool = False,
    hdr: bool = False,
    shadow_map: bool = False,
    fog: bool = False,
    lights: bool = False,
    shadow_atlas: bool = False,
) -> PipelineKey:
    """`render.rs:519-535`: alpha_mode -> key blend bit. Premultiplied and
    Add share one key (their difference is applied post-lighting in the
    shader, not in the pipeline); Opaque contributes no bit."""
    bit = {
        ALPHA_BLEND: BLEND_ALPHA,
        ALPHA_PREMULTIPLIED: BLEND_PREMULTIPLIED_ALPHA,
        ALPHA_ADD: BLEND_PREMULTIPLIED_ALPHA,
        ALPHA_MULTIPLY: BLEND_MULTIPLY,
        ALPHA_MASK: MAY_DISCARD,
    }.get(int(alpha_mode))
    return PipelineKey(
        msaa_samples=int(msaa_samples),
        depth_prepass=bool(depth_prepass),
        hdr=bool(hdr),
        blend_bit=bit,
        shadow_map=bool(shadow_map),
        fog=bool(fog),
        lights=bool(lights),
        shadow_atlas=bool(shadow_atlas),
    )


# ---------------------------------------------------------------------------
# Bind-group layout (group 2: system uniform + prepass + material textures)
# ---------------------------------------------------------------------------


def uniform_layout_entries(msaa: bool, shadow_map: bool = False,
                           fog: bool = False, lights: bool = False,
                           shadow_atlas: bool = False) -> List[dict]:
    """The uniform bind-group layout; the msaa flavor swaps the depth
    entry's texture type (`render.rs:820-824` picks uniform_layout vs
    uniform_layout_msaa). The depth entry is ALWAYS in the layout — when
    the view has no prepass, a 1x1 depth dummy of the matching sample
    count is bound (that is the entire reason `DummyTextures` keeps one
    per msaa count) and the DEPTH_PREPASS shader def compiles the reads
    out. Binding indices match the shipped WGSL."""
    entries = [
        {"binding": 0, "type": "uniform-buffer", "size": 32},
        {
            "binding": 1,
            "type": "texture",
            "sample_type": "depth",
            "multisampled": bool(msaa),
        },
    ]
    for i, name in ((2, "base"), (4, "normal"), (6, "orm")):
        entries.append({"binding": i, "type": "texture", "sample_type": "float", "multisampled": False, "name": name})
        entries.append({"binding": i + 1, "type": "sampler", "filtering": True, "name": name})
    if shadow_map:
        # SHADOW_MAP variant: light matrix uniform (mat4 + params vec4 =
        # 80 B), depth map, comparison sampler — bindings 8-10 in the WGSL
        entries.append({"binding": 8, "type": "uniform-buffer", "size": 80, "name": "shadow"})
        entries.append({"binding": 9, "type": "texture", "sample_type": "depth", "multisampled": False, "name": "shadow"})
        entries.append({"binding": 10, "type": "sampler", "comparison": True, "name": "shadow"})
    if fog:
        # FOG variant: FogUniform (4 x vec4 = 64 B) at binding 11 — fixed
        # slot regardless of shadow_map so the two variants compose
        entries.append({"binding": 11, "type": "uniform-buffer", "size": 64, "name": "fog"})
    if lights:
        # LIGHTS variant: LightsUniform (uvec4 + vec4 + 16 x 4 vec4 rows +
        # 9 env-SH vec4 + env params vec4 = 1216 B) at binding 12 — fixed
        # slot so it composes with shadow/fog
        entries.append({"binding": 12, "type": "uniform-buffer", "size": 1216, "name": "lights"})
    if shadow_atlas:
        # SHADOW_ATLAS variant: matrix-array uniform (16 mat4 + params =
        # 1040 B), tiled depth atlas, comparison sampler — bindings 13-15
        entries.append({"binding": 13, "type": "uniform-buffer", "size": 1040, "name": "shadow_atlas"})
        entries.append({"binding": 14, "type": "texture", "sample_type": "depth", "multisampled": False, "name": "shadow_atlas"})
        entries.append({"binding": 15, "type": "sampler", "comparison": True, "name": "shadow_atlas"})
    return entries


@dataclasses.dataclass(frozen=True)
class SpecializedPipeline:
    key: PipelineKey
    shader_defs: Tuple[str, ...]
    shader_source: str  # preprocessed, checker-validated WGSL
    layout: List[dict]  # group(2) bind-group layout entries
    # descriptor fields (names follow WebGPU/wgpu):
    target_format: str
    blend: dict  # ALWAYS ALPHA_BLENDING (render.rs:855-859)
    multisample_count: int
    depth_compare: str  # reverse-Z
    depth_write_enabled: bool
    cull_mode: Optional[str]
    topology: str


class PipelineCache:
    """`SpecializedRenderPipelines`-style memoized specialization. The
    "compile" is the static WGSL checker (no naga is a dependency); a
    variant with checker errors raises, so shader rot in ANY reachable
    variant fails tests, not just the default one."""

    def __init__(self, source: Optional[str] = None):
        self._source = source if source is not None else particles_wgsl_source()
        self._cache: Dict[PipelineKey, SpecializedPipeline] = {}

    def specialize(self, key: PipelineKey) -> SpecializedPipeline:
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        defs: List[str] = []
        if key.msaa_samples > 1:
            defs.append("MULTISAMPLED")  # render.rs:845-847
        if key.depth_prepass:
            defs.append("DEPTH_PREPASS")  # render.rs:848-850
        if key.shadow_map:
            defs.append("SHADOW_MAP")
        if key.fog:
            defs.append("FOG")
        if key.lights:
            defs.append("LIGHTS")
        if key.shadow_atlas:
            if not key.lights:
                raise ValueError("shadow_atlas requires lights (the atlas "
                                 "attenuates light-table rows)")
            defs.append("SHADOW_ATLAS")
        wgsl = preprocess(self._source, frozenset(defs))
        errors = check_wgsl(wgsl)
        if errors:
            raise ValueError(
                f"particles.wgsl variant {defs or ['<default>']} failed the "
                f"checker: {errors[:4]}"
            )
        variant = SpecializedPipeline(
            key=key,
            shader_defs=tuple(defs),
            shader_source=wgsl,
            layout=uniform_layout_entries(key.msaa_samples > 1, key.shadow_map,
                                          key.fog, key.lights,
                                          key.shadow_atlas),
            target_format=key.target_format(),
            blend=ALPHA_BLENDING,
            multisample_count=key.msaa_samples,  # render.rs:864
            depth_compare="greater",  # reverse-Z, render.rs:775-782
            depth_write_enabled=False,
            cull_mode=None,  # double-sided quads
            topology="triangle-list",
        )
        self._cache[key] = variant
        return variant

    def __len__(self) -> int:
        return len(self._cache)


# ---------------------------------------------------------------------------
# Dummy resources (render.rs:85-241)
# ---------------------------------------------------------------------------

FLAG_BASE_COLOR_TEXTURE = 1
FLAG_NORMAL_MAP_TEXTURE = 2
FLAG_ORM_TEXTURE = 4


class DummyTextures:
    """Host-side analog of the reference's `DummyTextures` resource: 1x1
    textures bound wherever a system has no real texture (the uniform's
    flag bits tell the shader which samples are meaningful), plus one 1x1
    depth dummy PER msaa sample count, created on demand
    (`ensure_has_samples`) for pipelines whose layout expects a
    (possibly multisampled) prepass texture that the view doesn't have."""

    def __init__(self):
        white = np.ones((1, 1, 4), dtype=np.float32)
        self.base_color_texture = white
        self.normal_map_texture = white  # flag bit gates the decode
        self.orm_texture = white
        self.sampler = {"mag_filter": "linear", "min_filter": "linear", "address_mode": "clamp-to-edge"}
        self.depth_textures: Dict[int, np.ndarray] = {}
        # shadow dummy: depth 1.0 everywhere => every compare (ref <= stored
        # under less-equal) passes => fully lit when no real map is bound
        self.shadow_texture = np.ones((1, 1), dtype=np.float32)
        self.shadow_sampler = {"compare": "less-equal"}

    def ensure_has_samples(self, sample_count: int) -> np.ndarray:
        if sample_count not in self.depth_textures:
            self.depth_textures[sample_count] = np.zeros((1, 1), dtype=np.float32)
        return self.depth_textures[sample_count]

    def bind_group_entries(
        self,
        flags: int,
        key: PipelineKey,
        textures: Optional[dict] = None,
        prepass_texture: Optional[np.ndarray] = None,
        shadow_texture: Optional[np.ndarray] = None,
        shadow_atlas_texture: Optional[np.ndarray] = None,
    ) -> List[dict]:
        """Assemble group(2): real resources where flag bits are set /
        the prepass exists, dummies elsewhere — the binding is never left
        empty (GPU layouts require every slot filled; that is the entire
        point of the reference's dummy scheme)."""
        textures = textures or {}
        entries: List[dict] = [{"binding": 0, "resource": "system-uniform"}]
        depth = prepass_texture
        if depth is None:
            depth = self.ensure_has_samples(key.msaa_samples)
            real = False
        else:
            real = True
        entries.append({"binding": 1, "resource": depth, "real": real})
        for bit, base_binding, name in (
            (FLAG_BASE_COLOR_TEXTURE, 2, "base_color"),
            (FLAG_NORMAL_MAP_TEXTURE, 4, "normal_map"),
            (FLAG_ORM_TEXTURE, 6, "orm"),
        ):
            real = bool(flags & bit) and name in textures
            tex = textures[name] if real else getattr(self, f"{name}_texture")
            entries.append({"binding": base_binding, "resource": tex, "real": real})
            entries.append({"binding": base_binding + 1, "resource": self.sampler, "real": real})
        if key.shadow_map:
            real = shadow_texture is not None
            entries.append({"binding": 8, "resource": "shadow-uniform"})
            entries.append({"binding": 9,
                            "resource": shadow_texture if real else self.shadow_texture,
                            "real": real})
            entries.append({"binding": 10, "resource": self.shadow_sampler, "real": real})
        if key.fog:
            # the uniform itself carries mode/opacity, so there is no dummy
            # resource — a host with fog disabled simply doesn't set the bit
            entries.append({"binding": 11, "resource": "fog-uniform"})
        if key.lights:
            # the uniform carries the light count (0 = ambient-only), so no
            # dummy resource exists for this slot either
            entries.append({"binding": 12, "resource": "lights-uniform"})
        if key.shadow_atlas:
            real = shadow_atlas_texture is not None
            entries.append({"binding": 13, "resource": "shadow-atlas-uniform"})
            entries.append({"binding": 14,
                            "resource": shadow_atlas_texture if real else self.shadow_texture,
                            "real": real})
            entries.append({"binding": 15, "resource": self.shadow_sampler, "real": real})
        return entries
