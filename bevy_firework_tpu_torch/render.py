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
instance sort and the frustum test of a spawner's AABB. The view's lights
and shading inputs, host numpy copied from the JAX package's render.py with
its names, fields and byte layouts: distance fog (`FogSettings`), the SH
environment light (`EnvironmentLight`), point / spot / directional lights
(`Light`, `LightTable`), and the shadow atlas (`light_view_proj`,
`cube_face`, `ShadowAtlas`, `make_shadow_atlas`).

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


FOG_OFF, FOG_LINEAR, FOG_EXP, FOG_EXP2 = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class FogSettings:
    """View-level distance fog (Bevy `DistanceFog` semantics — the reference
    inherits the fog stage from `apply_pbr_lighting`; here it is the FOG
    pipeline variant's uniform at group(2) binding 11). `color`'s alpha
    scales the maximum fog opacity; `directional_light_color`'s alpha is the
    inscattering strength around `light_dir` raised to
    `directional_light_exponent`. Mode semantics:

      FOG_LINEAR: amount = clamp((dist - start) / (end - start), 0, 1)
      FOG_EXP:    amount = 1 - exp(-dist * density)
      FOG_EXP2:   amount = 1 - exp(-(dist * density)^2)
    """

    mode: int = FOG_LINEAR
    color: tuple = (0.6, 0.65, 0.7, 1.0)
    start: float = 5.0          # FOG_LINEAR only
    end: float = 50.0           # FOG_LINEAR only
    density: float = 0.05       # FOG_EXP / FOG_EXP2 only
    directional_light_color: tuple = (0.0, 0.0, 0.0, 0.0)
    directional_light_exponent: float = 8.0
    light_dir: tuple = (0.4, 0.8, 0.3)

    def to_bytes(self) -> bytes:
        """std140 packing mirroring the WGSL `FogUniform` (4 x vec4 = 64 B):
        base_color, directional_light, light_dir.xyz + mode, params
        (start-or-density, end, scatter exponent, 0)."""
        buf = np.zeros(16, dtype=np.float32)
        buf[0:4] = self.color
        buf[4:8] = self.directional_light_color
        buf[8:11] = self.light_dir
        buf[11] = float(self.mode)
        buf[12] = self.start if self.mode == FOG_LINEAR else self.density
        buf[13] = self.end
        buf[14] = self.directional_light_exponent
        return buf.tobytes()

    def amount(self, dist):
        """The fog mix factor at view distance `dist` (numpy-friendly) —
        the host-side oracle for the WGSL `fog_amount`, consumed by the
        software viewer and the A/B image tests."""
        d = np.asarray(dist, dtype=np.float32)
        if self.mode == FOG_LINEAR:
            a = np.clip((d - self.start) / max(self.end - self.start, 1e-5), 0.0, 1.0)
        elif self.mode == FOG_EXP:
            a = 1.0 - np.exp(-d * self.density)
        elif self.mode == FOG_EXP2:
            a = 1.0 - np.exp(-np.square(d * self.density))
        else:
            a = np.zeros_like(d)
        return a * self.color[3]


LIGHT_DIRECTIONAL = 0
LIGHT_POINT = 1
LIGHT_SPOT = 2

MAX_LIGHTS = 16  # WGSL LightsUniform array size (shaders/particles.wgsl)

# Real spherical-harmonic basis constants (bands l = 0..2), the standard
# compact environment-light representation (Ramamoorthi & Hanrahan 2001).
_SH_C = np.asarray(
    [0.282095,                       # Y00
     0.488603, 0.488603, 0.488603,   # Y1-1 (y), Y10 (z), Y11 (x)
     1.092548, 1.092548, 0.315392,   # Y2-2 (xy), Y2-1 (yz), Y20 (3z^2-1)
     1.092548, 0.546274],            # Y21 (xz), Y22 (x^2-y^2)
    np.float32,
)
_SH_BAND = np.asarray([0, 1, 1, 1, 2, 2, 2, 2, 2], np.int32)  # l per coeff
# cosine-convolution factors A_l / pi: irradiance(n) below returns the
# Lambertian OUTGOING radiance for unit albedo (E(n) / pi), matching Bevy's
# prefiltered diffuse environment map convention (diffuse = irradiance *
# diffuse_color in environment_map.wgsl semantics).
_SH_A_OVER_PI = np.asarray([1.0, 2.0 / 3.0, 0.25], np.float32)


def _sh_basis(d):
    """Evaluate the 9 SH basis functions at unit direction(s) d [..., 3] ->
    [..., 9] (numpy; mirrored exactly by the WGSL `env_sh_basis`)."""
    d = np.asarray(d, np.float32)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return np.stack(
        [
            np.full_like(x, _SH_C[0]),
            _SH_C[1] * y, _SH_C[2] * z, _SH_C[3] * x,
            _SH_C[4] * x * y, _SH_C[5] * y * z,
            _SH_C[6] * (3.0 * z * z - 1.0),
            _SH_C[7] * x * z, _SH_C[8] * (x * x - y * y),
        ],
        axis=-1,
    ).astype(np.float32)


def _fibonacci_sphere(n: int) -> np.ndarray:
    """n near-uniform unit directions (deterministic golden-angle spiral)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    z = 1.0 - 2.0 * i / n
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    phi = i * (np.pi * (3.0 - np.sqrt(5.0)))
    return np.stack([r * np.cos(phi), z, r * np.sin(phi)], axis=-1).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class EnvironmentLight:
    """Image-based / environment ambient light.

    The reference's fragment inherits Bevy's `EnvironmentMapLight` (diffuse
    irradiance + roughness-prefiltered specular cube maps) and the flat
    `AmbientLight` resource through `apply_pbr_lighting`
    (bevy_firework `src/particles.wgsl:224`). This is the self-contained
    engine's analog: the environment radiance is held as 9 RGB
    second-order spherical-harmonic coefficients — the standard compact
    irradiance representation — bound in the LIGHTS uniform and evaluated
    in `pbr_shade`:

      * diffuse:  `diffuse_color * irradiance(n)` with the cosine
        convolution (A_l = [pi, 2pi/3, pi/4]) / pi folded into the eval —
        Bevy's `irradiance * diffuse_color` with the prefiltered map
        replaced by its exact SH projection.
      * specular: the SH evaluated at the reflection vector with a
        roughness window per band (w_l = exp(-l(l+1) * roughness^2) — the
        SH analog of selecting a prefiltered mip), times the analytic
        split-sum environment BRDF (Karis' EnvBRDFApprox:
        `f0 * AB.x + AB.y`), replacing the specular cube-map chain.

    `sh` holds RAW radiance projections (what `from_cubemap` /
    `from_directions` produce); convolution happens at eval time. All three
    consumers (WGSL, software viewer, tests) share the oracles below."""

    sh: tuple = ((0.0, 0.0, 0.0),) * 9  # 9 x rgb radiance SH coefficients
    intensity: float = 1.0              # scales diffuse + specular together

    # ---------------------------------------------------------------- bake
    @staticmethod
    def from_directions(entries, intensity: float = 1.0) -> "EnvironmentLight":
        """Project delta radiance sources [(direction_toward_light, rgb),
        ...] into SH: c_lm = sum color * Y_lm(dir)."""
        sh = np.zeros((9, 3), np.float32)
        for d, color in entries:
            d = np.asarray(d, np.float64)
            d = (d / max(np.linalg.norm(d), 1e-9)).astype(np.float32)
            sh += _sh_basis(d)[:, None] * np.asarray(color, np.float32)[None, :]
        return EnvironmentLight(sh=tuple(map(tuple, sh.tolist())),
                                intensity=float(intensity))

    @staticmethod
    def from_function(fn, intensity: float = 1.0, samples: int = 2048) -> "EnvironmentLight":
        """Project an arbitrary radiance function `fn(dirs [N,3]) -> [N,3]`
        by deterministic quadrature over a Fibonacci sphere:
        c_lm = (4pi/N) * sum L(d) Y_lm(d)."""
        dirs = _fibonacci_sphere(samples)
        L = np.asarray(fn(dirs), np.float32).reshape(samples, 3)
        basis = _sh_basis(dirs)  # [N, 9]
        sh = (4.0 * np.pi / samples) * (basis.T @ L)
        return EnvironmentLight(sh=tuple(map(tuple, sh.astype(np.float32).tolist())),
                                intensity=float(intensity))

    @staticmethod
    def gradient(sky=(0.4, 0.5, 0.7), horizon=(0.3, 0.3, 0.3),
                 ground=(0.15, 0.12, 0.1), intensity: float = 1.0) -> "EnvironmentLight":
        """The common three-band hemisphere gradient: sky above, ground
        below, horizon at the equator (smooth elevation lerp)."""
        sky = np.asarray(sky, np.float32)
        hor = np.asarray(horizon, np.float32)
        gnd = np.asarray(ground, np.float32)

        def fn(dirs):
            y = dirs[:, 1:2]
            up = np.clip(y, 0.0, 1.0)
            dn = np.clip(-y, 0.0, 1.0)
            return hor[None, :] * (1.0 - up - dn) + sky[None, :] * up + gnd[None, :] * dn

        return EnvironmentLight.from_function(fn, intensity=intensity)

    @staticmethod
    def from_cubemap(faces, intensity: float = 1.0) -> "EnvironmentLight":
        """Project a cubemap into SH — the image-based entry point. `faces`
        is a sequence of six [H, W, 3] float arrays in the WebGPU face
        order (+x, -x, +y, -y, +z, -z), texel centers mapped to directions
        with solid-angle weights."""
        total = np.zeros((9, 3), np.float64)
        wsum = 0.0
        axes = {  # face -> (forward, u_axis, v_axis); v runs DOWN the image
            0: ((1, 0, 0), (0, 0, -1), (0, -1, 0)),
            1: ((-1, 0, 0), (0, 0, 1), (0, -1, 0)),
            2: ((0, 1, 0), (1, 0, 0), (0, 0, 1)),
            3: ((0, -1, 0), (1, 0, 0), (0, 0, -1)),
            4: ((0, 0, 1), (1, 0, 0), (0, -1, 0)),
            5: ((0, 0, -1), (-1, 0, 0), (0, -1, 0)),
        }
        for fi, img in enumerate(faces):
            img = np.asarray(img, np.float32)
            h, w = img.shape[:2]
            fwd, ua, va = (np.asarray(a, np.float64) for a in axes[fi])
            u = (np.arange(w, dtype=np.float64) + 0.5) / w * 2.0 - 1.0
            v = (np.arange(h, dtype=np.float64) + 0.5) / h * 2.0 - 1.0
            uu, vv = np.meshgrid(u, v)
            d = fwd[None, None, :] + uu[..., None] * ua + vv[..., None] * va
            norm = np.linalg.norm(d, axis=-1, keepdims=True)
            dn = (d / norm).reshape(-1, 3).astype(np.float32)
            # solid angle of a cube face texel: 4 / (w*h) / |d|^3 (d on the
            # unit-cube face plane)
            dw = (4.0 / (w * h)) / np.square(norm[..., 0]).reshape(-1) / norm[..., 0].reshape(-1)
            basis = _sh_basis(dn)  # [N, 9]
            total += (basis * dw[:, None]).T @ img.reshape(-1, 3).astype(np.float64)
            wsum += float(dw.sum())
        # normalize the quadrature so sum(weights) == 4pi exactly
        total *= (4.0 * np.pi) / max(wsum, 1e-9)
        return EnvironmentLight(sh=tuple(map(tuple, total.astype(np.float32).tolist())),
                                intensity=float(intensity))

    # -------------------------------------------------------------- oracles
    def _sh_arr(self):
        return np.asarray(self.sh, np.float32).reshape(9, 3)

    def irradiance(self, n):
        """Lambertian outgoing radiance for unit albedo at normal(s) n
        [..., 3]: E(n)/pi = sum (A_l/pi) c_lm Y_lm(n). Oracle for the WGSL
        `env_irradiance`."""
        basis = _sh_basis(n)  # [..., 9]
        w = _SH_A_OVER_PI[_SH_BAND]  # [9]
        return np.einsum("...k,kc->...c", basis * w, self._sh_arr()) * np.float32(self.intensity)

    def specular_radiance(self, r, roughness):
        """Prefiltered specular radiance approx at reflection dir(s) r:
        band-windowed SH eval, w_l = exp(-l(l+1) * roughness^2). Oracle for
        the WGSL `env_specular`."""
        rough = np.asarray(roughness, np.float32)
        basis = _sh_basis(r)  # [..., 9]
        l = _SH_BAND.astype(np.float32)
        w = np.exp(-(l * (l + 1.0))[..., :] * (rough[..., None] ** 2))  # [..., 9]
        out = np.einsum("...k,kc->...c", basis * w, self._sh_arr())
        # clamp AFTER intensity, matching the WGSL env_specular exactly
        # (env_sh_eval applies intensity inside, max() wraps the result)
        return np.maximum(out * np.float32(self.intensity), 0.0)

    @staticmethod
    def env_brdf(f0, roughness, nv):
        """Karis' analytic split-sum environment BRDF (EnvBRDFApprox from
        'Physically Based Shading on Mobile'): returns f0*AB.x + AB.y.
        Mirrored exactly by the WGSL `env_brdf_approx`."""
        f0 = np.asarray(f0, np.float32)
        rough = np.asarray(roughness, np.float32)
        nv = np.asarray(nv, np.float32)
        c0 = np.asarray([-1.0, -0.0275, -0.572, 0.022], np.float32)
        c1 = np.asarray([1.0, 0.0425, 1.04, -0.04], np.float32)
        r4 = rough[..., None] * c0 + c1
        a004 = np.minimum(r4[..., 0] * r4[..., 0], np.exp2(-9.28 * nv)) * r4[..., 0] + r4[..., 1]
        ab_x = -1.04 * a004 + r4[..., 2]
        ab_y = 1.04 * a004 + r4[..., 3]
        return f0 * ab_x[..., None] + ab_y[..., None]

    def shade_indirect(self, n, v, base_rgb, metallic, roughness):
        """The full indirect contribution this environment adds in
        `pbr_shade` (diffuse + specular IBL) at normal n / view dir v —
        THE shared oracle (software viewer + image tests + WGSL contract)."""
        n = np.asarray(n, np.float32)
        v = np.asarray(v, np.float32)
        base = np.asarray(base_rgb, np.float32)
        f0 = 0.04 * (1.0 - metallic) + base * metallic
        diffuse_color = base * (1.0 - metallic)
        nv = np.maximum(np.sum(n * v, axis=-1), 1e-4)
        r = 2.0 * np.sum(n * v, axis=-1, keepdims=True) * n - v
        diff = diffuse_color * self.irradiance(n)
        spec = self.specular_radiance(r, roughness) * self.env_brdf(f0, roughness, nv)
        return diff + spec


@dataclasses.dataclass(frozen=True)
class Light:
    """One row of the LIGHTS variant's light table.

    The reference's fragment inherits Bevy's clustered point/spot/
    directional lights through `apply_pbr_lighting`
    (bevy_firework `src/particles.wgsl:180-239`); this is the
    self-contained analog: up to MAX_LIGHTS rows bound at group(2)
    binding 12, looped in `pbr_shade` with Bevy's smooth-window
    inverse-square attenuation and squared cone falloff.

    color holds the light color PRE-multiplied by intensity (radiance for
    directional; for point/spot use the `point`/`spot` constructors, which
    apply Bevy's lumens -> intensity convention: I = lumens / 4pi)."""

    kind: int = LIGHT_DIRECTIONAL
    color: tuple = (1.0, 1.0, 1.0)
    direction: tuple = (0.0, -1.0, 0.0)  # TOWARD the scene (dir/spot)
    position: tuple = (0.0, 0.0, 0.0)    # point/spot
    range: float = 20.0                  # point/spot attenuation window
    inner_angle: float = 0.4             # spot, radians
    outer_angle: float = 0.6             # spot, radians
    # cast shadows via the SHADOW_ATLAS variant (make_shadow_atlas assigns
    # this light atlas tiles): directional and spot rows take ONE tile,
    # point rows take SIX consecutive tiles (a cube map unrolled into the
    # atlas; face chosen per fragment by dominant axis). Rows that no
    # longer fit the 16-tile atlas keep extra.y = -1 (unshadowed).
    shadow: bool = False

    @staticmethod
    def directional(direction, color=(1.0, 1.0, 1.0), illuminance: float = 1.0,
                    shadow: bool = False) -> "Light":
        c = tuple(float(x) * float(illuminance) for x in color[:3])
        return Light(kind=LIGHT_DIRECTIONAL, color=c,
                     direction=tuple(map(float, direction)), shadow=bool(shadow))

    @staticmethod
    def point(position, color=(1.0, 1.0, 1.0), intensity: float = 4.0 * np.pi,
              range: float = 20.0, shadow: bool = False) -> "Light":
        """intensity in lumens, Bevy PointLight convention (radiant
        intensity = lumens / 4pi). shadow=True takes six atlas tiles (an
        unrolled cube map — Bevy PointLight.shadows_enabled analog)."""
        s = float(intensity) / (4.0 * np.pi)
        return Light(kind=LIGHT_POINT, color=tuple(float(x) * s for x in color[:3]),
                     position=tuple(map(float, position)), range=float(range),
                     shadow=bool(shadow))

    @staticmethod
    def spot(position, direction, color=(1.0, 1.0, 1.0), intensity: float = 4.0 * np.pi,
             range: float = 20.0, inner_angle: float = 0.4, outer_angle: float = 0.6,
             shadow: bool = False) -> "Light":
        s = float(intensity) / (4.0 * np.pi)
        return Light(kind=LIGHT_SPOT, color=tuple(float(x) * s for x in color[:3]),
                     position=tuple(map(float, position)), direction=tuple(map(float, direction)),
                     range=float(range), inner_angle=float(inner_angle),
                     outer_angle=float(outer_angle), shadow=bool(shadow))


@dataclasses.dataclass(frozen=True)
class LightTable:
    """The LIGHTS uniform: up to MAX_LIGHTS lights + ambient + optional
    environment light (SH IBL, see EnvironmentLight)."""

    lights: tuple = ()
    ambient: tuple = (0.09, 0.09, 0.1)
    environment: object = None  # Optional[EnvironmentLight]

    def to_bytes(self) -> bytes:
        """std140 packing mirroring the WGSL `LightsUniform` (1216 B):
        counts uvec4 (x = rows, y = environment flag), ambient vec4,
        MAX_LIGHTS x 4 vec4 rows (position_range, color_kind,
        direction_outer, extra), 9 env-SH vec4 rows (rgb, pad), env params
        vec4 (x = intensity)."""
        n = min(len(self.lights), MAX_LIGHTS)
        head = np.zeros(8, dtype=np.float32)
        head[:4] = np.asarray([n, 1 if self.environment is not None else 0, 0, 0],
                              np.uint32).view(np.float32)
        head[4:7] = self.ambient[:3]
        rows = np.zeros((MAX_LIGHTS, 16), dtype=np.float32)
        tiles = self.shadow_tiles()
        for i, lt in enumerate(self.lights[:MAX_LIGHTS]):
            rows[i, 0:3] = lt.position
            rows[i, 3] = lt.range
            rows[i, 4:7] = lt.color
            rows[i, 7] = float(lt.kind)
            rows[i, 8:11] = lt.direction
            rows[i, 11] = float(np.cos(lt.outer_angle))
            rows[i, 12] = float(np.cos(lt.inner_angle))
            rows[i, 13] = float(tiles[i])  # extra.y: atlas tile, -1 = none
        env = np.zeros((10, 4), dtype=np.float32)
        if self.environment is not None:
            env[:9, :3] = np.asarray(self.environment.sh, np.float32).reshape(9, 3)
            env[9, 0] = float(self.environment.intensity)
        return head.tobytes() + rows.tobytes() + env.tobytes()

    def shadow_tiles(self):
        """FIRST atlas tile per light row, allocated in table order:
        shadow-casting directional/spot rows take one tile, point rows take
        SIX consecutive tiles (cube faces +x -x +y -y +z -z); rows without
        shadows — or that no longer fit the 16-tile atlas — get -1. Shared
        by to_bytes, make_shadow_atlas and the software viewer so the three
        cannot disagree about which map belongs to which light."""
        tiles, nxt = [], 0
        for lt in self.lights[:MAX_LIGHTS]:
            need = 6 if lt.kind == LIGHT_POINT else 1
            if lt.shadow and nxt + need <= MAX_LIGHTS:
                tiles.append(nxt)
                nxt += need
            else:
                tiles.append(-1)
        return tiles

    def radiance_at(self, world_pos):
        """Per-light (l_dir, radiance) at `world_pos` — the host-side oracle
        for the WGSL light loop, consumed by the software viewer and image
        tests. Returns a list of (unit vector TOWARD the light, rgb)."""
        out = []
        p = np.asarray(world_pos, np.float32)
        for lt in self.lights[:MAX_LIGHTS]:
            color = np.asarray(lt.color, np.float32)
            if lt.kind == LIGHT_DIRECTIONAL:
                d = np.asarray(lt.direction, np.float32)
                l = -d / max(np.linalg.norm(d), 1e-5)
                out.append((l, color))
                continue
            to_light = np.asarray(lt.position, np.float32) - p
            d2 = float(to_light @ to_light)
            l = to_light / max(np.sqrt(d2), 1e-5)
            rng = max(lt.range, 1e-4)
            factor = d2 / (rng * rng)
            smooth = np.clip(1.0 - factor * factor, 0.0, 1.0)
            att = smooth * smooth / max(d2, 1e-4)
            radiance = color * att
            if lt.kind == LIGHT_SPOT:
                d = np.asarray(lt.direction, np.float32)
                d = d / max(np.linalg.norm(d), 1e-5)
                cd = float(-l @ d)
                co, ci = float(np.cos(lt.outer_angle)), float(np.cos(lt.inner_angle))
                cone = np.clip((cd - co) / max(ci - co, 1e-4), 0.0, 1.0)
                radiance = radiance * cone * cone
            out.append((l, radiance))
        return out


def _look_at(eye, forward, up_hint=(0.0, 1.0, 0.0)):
    """Right-handed view matrix looking along `forward` (camera -z)."""
    eye = np.asarray(eye, np.float64)
    z = -np.asarray(forward, np.float64)
    z = z / max(np.linalg.norm(z), 1e-9)
    up = np.asarray(up_hint, np.float64)
    if abs(float(up @ z)) > 0.999:
        up = np.asarray((1.0, 0.0, 0.0), np.float64)
    x = np.cross(up, z)
    x = x / max(np.linalg.norm(x), 1e-9)
    y = np.cross(z, x)
    v = np.eye(4)
    v[0, :3], v[1, :3], v[2, :3] = x, y, z
    v[:3, 3] = -(v[:3, :3] @ eye)
    return v


# Cube-face order for point-light shadows (tile offsets 0..5 from the
# row's first atlas tile): +x, -x, +y, -y, +z, -z. Face selection (dominant
# axis, y-before-z-before-x tie-break) must match the WGSL loop EXACTLY —
# cube_face() is the single host-side source of truth.
CUBE_FACE_DIRS = (
    (1.0, 0.0, 0.0), (-1.0, 0.0, 0.0),
    (0.0, 1.0, 0.0), (0.0, -1.0, 0.0),
    (0.0, 0.0, 1.0), (0.0, 0.0, -1.0),
)


def cube_face(d) -> int:
    """Cube face index for direction d (fragment - light position); mirrors
    the WGSL face select in shaders/particles.wgsl. Comparisons run in f32
    like the shader's interpolated values, so face-boundary ties resolve
    identically on both sides."""
    d = np.asarray(d, np.float32)
    ax, ay, az = abs(float(d[0])), abs(float(d[1])), abs(float(d[2]))
    if ay >= ax and ay >= az:
        return 2 if float(d[1]) >= 0.0 else 3
    if az >= ax:
        return 4 if float(d[2]) >= 0.0 else 5
    return 0 if float(d[0]) >= 0.0 else 1


def light_view_proj(light: Light, center=(0.0, 0.0, 0.0), radius: float = 10.0,
                    face: Optional[int] = None) -> np.ndarray:
    """World -> light-clip matrix (WebGPU 0..1 depth) for a shadow-casting
    light row. Spot: perspective from the light position along its
    direction, fovy = 2*outer_angle, far = range. Directional: orthographic
    box of half-extent `radius` about `center` (the caller's scene bounds —
    the analog of Bevy fitting directional cascades to the view). Point:
    pass `face` 0..5 — a 90-degree-fov perspective along CUBE_FACE_DIRS[face]
    (one unrolled cube-map face, Bevy point-light cube maps analog)."""
    if light.kind == LIGHT_POINT:
        if face is None:
            raise ValueError("point lights need a cube face (0..5)")
        near = max(0.02 * light.range, 1e-3)
        far = max(light.range, near * 2)
        proj = np.zeros((4, 4))
        proj[0, 0] = 1.0  # fovy 90 deg: f = 1/tan(45) = 1
        proj[1, 1] = 1.0
        proj[2, 2] = far / (near - far)
        proj[2, 3] = near * far / (near - far)
        proj[3, 2] = -1.0
        view = _look_at(light.position, CUBE_FACE_DIRS[face])
        return (proj @ view).astype(np.float32)
    if light.kind == LIGHT_SPOT:
        near = max(0.02 * light.range, 1e-3)
        far = max(light.range, near * 2)
        f = 1.0 / np.tan(max(light.outer_angle, 1e-3))
        proj = np.zeros((4, 4))
        proj[0, 0] = f
        proj[1, 1] = f
        proj[2, 2] = far / (near - far)
        proj[2, 3] = near * far / (near - far)
        proj[3, 2] = -1.0
        view = _look_at(light.position, light.direction)
        return (proj @ view).astype(np.float32)
    if light.kind == LIGHT_DIRECTIONAL:
        d = np.asarray(light.direction, np.float64)
        d = d / max(np.linalg.norm(d), 1e-9)
        r = max(float(radius), 1e-3)
        eye = np.asarray(center, np.float64) - d * (r + 1.0)
        near, far = 0.0, 2.0 * (r + 1.0)
        proj = np.eye(4)
        proj[0, 0] = 1.0 / r
        proj[1, 1] = 1.0 / r
        proj[2, 2] = 1.0 / (near - far)
        proj[2, 3] = near / (near - far)
        view = _look_at(eye, d)
        return (proj @ view).astype(np.float32)
    raise ValueError(f"unknown light kind {light.kind}")


@dataclasses.dataclass(frozen=True)
class ShadowAtlas:
    """Per-light shadow maps for the SHADOW_ATLAS pipeline variant. One
    depth texture holds `grid` x `grid` tiles of
    `resolution`^2 each; `mats[tile]` projects world -> that tile's light
    clip. The reference gets per-light shadowing (directional cascades +
    spot maps) free from Bevy's clustered pipeline
    (bevy_firework `src/particles.wgsl:224`); this is the self-contained
    analog for every shadow-flagged directional/spot row of a LightTable.

    `factor()` is the host oracle for the WGSL `shadow_atlas_factor` —
    the software viewer and image tests share it, so the two renderers
    cannot disagree about shadowing."""

    table: LightTable
    depth: np.ndarray  # [grid*res, grid*res] f32 light-clip depth (1 = far)
    mats: np.ndarray  # [MAX_LIGHTS, 4, 4] f32, row `tile` used
    grid: int
    bias: float = 2e-3
    strength: float = 1.0

    def to_bytes(self) -> bytes:
        """std140 ShadowAtlasUniform: 16 column-major mat4x4 + params."""
        mats = np.zeros((MAX_LIGHTS, 4, 4), np.float32)
        mats[: self.mats.shape[0]] = self.mats
        cols = mats.transpose(0, 2, 1)  # WGSL mat4x4 is column-major
        params = np.asarray([self.bias, self.strength, float(self.grid), 0.0], np.float32)
        return cols.tobytes() + params.tobytes()

    def factor(self, world_pos, light_index: int) -> float:
        """Shadow factor for light row `light_index` at a world position —
        mirrors shaders/particles.wgsl `shadow_atlas_factor` (projection,
        tile-local clamp, 4-tap PCF, less-equal compare) on the host map.
        Point rows first select the cube face by dominant axis
        (render.cube_face — the WGSL face select's oracle)."""
        tile = self.table.shadow_tiles()[light_index]
        if tile < 0:
            return 1.0
        lt = self.table.lights[light_index]
        if lt.kind == LIGHT_POINT:
            d = np.asarray(world_pos, np.float64) - np.asarray(lt.position, np.float64)
            tile += cube_face(d)
        lc = self.mats[tile] @ np.asarray([*world_pos, 1.0], np.float32)
        if abs(float(lc[3])) < 1e-9:
            return 1.0
        ndc = lc[:3] / lc[3]
        uv = np.asarray([ndc[0] * 0.5 + 0.5, ndc[1] * -0.5 + 0.5])
        if not (0.0 <= uv[0] <= 1.0 and 0.0 <= uv[1] <= 1.0 and 0.0 <= ndc[2] <= 1.0):
            return 1.0
        n = self.depth.shape[0]
        atlas_texel = 1.0 / n
        margin = 1.5 * self.grid * atlas_texel
        cuv = np.clip(uv, margin, 1.0 - margin)
        tile_xy = np.asarray([tile % self.grid, tile // self.grid], np.float64)
        auv = (tile_xy + cuv) / self.grid
        ref = float(ndc[2]) - self.bias
        lit = 0.0
        for ox, oy in ((-0.5, -0.5), (0.5, -0.5), (-0.5, 0.5), (0.5, 0.5)):
            px = min(max(int((auv[0] + ox * atlas_texel) * n), 0), n - 1)
            py = min(max(int((auv[1] + oy * atlas_texel) * n), 0), n - 1)
            lit += 1.0 if ref <= float(self.depth[py, px]) else 0.0
        return 1.0 - self.strength * (1.0 - lit * 0.25)


def shadow_tile_entries(table: LightTable, center=(0.0, 0.0, 0.0),
                        radius: float = 10.0):
    """Expand a table's shadow rows into (row, tile, world->clip matrix,
    facing direction) entries: one per dir/spot row, six cube faces per
    point row (tile offsets follow CUBE_FACE_DIRS). SINGLE source of truth
    for the tile layout — make_shadow_atlas and GPU consumers (the WebGPU
    page's caster passes) both build from this, so they cannot
    desynchronize from `shadow_tiles()`/`to_bytes`."""
    entries = []
    for row, tile in enumerate(table.shadow_tiles()):
        if tile < 0:
            continue
        lt = table.lights[row]
        if lt.kind == LIGHT_POINT:
            for fc in range(6):
                entries.append((row, tile + fc, light_view_proj(lt, face=fc),
                                CUBE_FACE_DIRS[fc]))
        else:
            entries.append((row, tile,
                            light_view_proj(lt, center=center, radius=radius),
                            lt.direction))
    return entries


def make_shadow_atlas(table: LightTable, occluders=(), resolution: int = 256,
                      center=(0.0, 0.0, 0.0), radius: float = 10.0,
                      bias: float = 2e-3, strength: float = 1.0) -> ShadowAtlas:
    """Bake a ShadowAtlas for every shadow-flagged directional/spot row of
    `table`. `occluders` is a list of world-space AABBs ((min_xyz,
    max_xyz)) — the shadow CASTERS (scene geometry; particles do not cast
    shadows, matching the reference where only meshes write Bevy's shadow
    maps). center/radius bound the directional lights' ortho box.

    A consumer with a real renderer can instead render its own depth into
    each tile and construct ShadowAtlas directly — the matrices and tile
    assignment here are the contract."""
    entries = [(t, m) for _row, t, m, _d in shadow_tile_entries(table, center, radius)]
    n_tiles = max([t + 1 for t, _m in entries], default=0)
    grid = 1
    while grid * grid < n_tiles:
        grid += 1
    grid = max(grid, 1)
    n = grid * resolution
    depth = np.ones((n, n), np.float32)
    mats = np.zeros((MAX_LIGHTS, 4, 4), np.float32)
    boxes = [(np.asarray(a, np.float64), np.asarray(b, np.float64)) for a, b in occluders]
    for tile, m in entries:
        mats[tile] = m
        if not boxes:
            continue
        inv = np.linalg.inv(m.astype(np.float64))
        ty, tx = divmod(tile, grid)
        # unproject each tile pixel at ndc z=0 and z=1, intersect the ray
        # segment with every AABB (slab test), store the nearest hit's
        # re-projected clip depth
        ys, xs = np.mgrid[0:resolution, 0:resolution]
        u = (xs + 0.5) / resolution
        v = (ys + 0.5) / resolution
        ndc_x = u * 2.0 - 1.0
        ndc_y = (v - 0.5) * -2.0  # uv.y = ndc.y * -0.5 + 0.5 inverted
        for zc, store in ((0.0, "p0"), (1.0, "p1")):
            pts = np.stack([ndc_x, ndc_y, np.full_like(ndc_x, zc), np.ones_like(ndc_x)], -1)
            w = pts @ inv.T
            w = w[..., :3] / w[..., 3:4]
            if store == "p0":
                p0 = w
            else:
                p1 = w
        ray = p1 - p0
        best = np.full(u.shape, np.inf)
        for lo, hi in boxes:
            with np.errstate(divide="ignore", invalid="ignore"):
                t1 = (lo - p0) / ray
                t2 = (hi - p0) / ray
            tmin = np.nanmax(np.minimum(t1, t2), axis=-1)
            tmax = np.nanmin(np.maximum(t1, t2), axis=-1)
            hit = (tmax >= np.maximum(tmin, 0.0)) & (tmin <= 1.0)
            tent = np.where(hit, np.maximum(tmin, 0.0), np.inf)
            best = np.minimum(best, tent)
        hitmask = np.isfinite(best)
        if hitmask.any():
            hp = p0 + np.where(hitmask, best, 0.0)[..., None] * ray
            hp4 = np.concatenate([hp, np.ones_like(hp[..., :1])], -1)
            clip = hp4 @ m.astype(np.float64).T
            with np.errstate(divide="ignore", invalid="ignore"):
                z = clip[..., 2] / clip[..., 3]
            tile_d = depth[ty * resolution:(ty + 1) * resolution,
                           tx * resolution:(tx + 1) * resolution]
            tile_d[hitmask] = np.clip(z[hitmask], 0.0, 1.0).astype(np.float32)
    return ShadowAtlas(table=table, depth=depth, mats=mats, grid=grid,
                       bias=float(bias), strength=float(strength))


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
