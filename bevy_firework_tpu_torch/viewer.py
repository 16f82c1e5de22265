"""Headless software viewer: rasterizes render items for visual QA.

The reference's examples are judged by eye in a Bevy window (SURVEY.md §4:
"visual correctness ... human-in-the-loop").  This module gives the
engine an equivalent: a small numpy rasterizer that consumes the exact render
contract (docs/RENDER_CONTRACT.md) — camera-facing discs with radial edge
fade, alpha/additive blending, distance sorting — and writes PNGs, so every
example can produce an inspectable frame without a GPU.  Not on the
benchmark path.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np


def write_png(path: str, rgb: np.ndarray):
    """Minimal zlib PNG writer (8-bit RGB, no deps). rgb: [H, W, 3] float
    (values tonemapped/clipped to [0,1]) or uint8."""
    if rgb.dtype != np.uint8:
        rgb = (np.clip(rgb, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


class Camera:
    def __init__(self, position=(0.0, 3.0, 8.0), look_at=(0.0, 1.0, 0.0), up=(0, 1, 0), fov_deg=50.0):
        self.position = np.asarray(position, np.float32)
        fwd = np.asarray(look_at, np.float32) - self.position
        n = np.linalg.norm(fwd)
        if n < 1e-9:
            raise ValueError("Camera look_at coincides with position")
        self.forward = fwd / n
        right = np.cross(self.forward, np.asarray(up, np.float32))
        rn = np.linalg.norm(right)
        if rn < 1e-6:  # straight up/down view: fall back to a stable basis
            right = np.cross(self.forward, np.float32([0.0, 0.0, 1.0]))
            rn = np.linalg.norm(right)
        self.right = right / rn
        self.up = np.cross(self.right, self.forward)
        self.fov = np.deg2rad(fov_deg)


def _smoothstep(edge0: float, edge1: float, x: np.ndarray) -> np.ndarray:
    t = np.clip((x - edge0) / max(edge1 - edge0, 1e-12), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _fog_mix(fog, color, rel_world):
    """Mix `color` ([..., 3]) toward the fog color by the falloff at each
    fragment's view distance — the host analog of the FOG pipeline variant's
    `apply_fog` (shaders/particles.wgsl), sharing `FogSettings.amount` as the
    falloff oracle. `rel_world`: world-space offset camera -> fragment,
    broadcastable against color's leading dims + (3,)."""
    rel = np.asarray(rel_world, np.float32)
    dist = np.linalg.norm(rel, axis=-1)
    amount = fog.amount(dist)[..., None]
    fog_rgb = np.asarray(fog.color[:3], np.float32)
    dl = fog.directional_light_color
    if dl[3] > 0.0:
        ld = np.asarray(fog.light_dir, np.float32)
        ld = ld / max(float(np.linalg.norm(ld)), 1e-6)
        vd = rel / np.maximum(dist, 1e-5)[..., None]
        align = np.maximum(vd @ ld, 0.0)
        fog_rgb = fog_rgb + (
            align[..., None] ** fog.directional_light_exponent
            * np.asarray(dl[:3], np.float32) * dl[3]
        )
    return color * (1.0 - amount) + fog_rgb * amount


def _composite(tile, alpha_mode, color, alpha):
    """In-place blend into an image view, per alpha_mode (render contract
    codes): 4 add (src+dst), 3 premultiplied over (src + dst*(1-a) — src is
    already alpha-weighted, never re-multiplied), 5 multiply (dst modulated
    toward src by coverage), else straight alpha blend."""
    a = alpha[..., None]
    if alpha_mode == 4:  # additive
        tile += color * a
    elif alpha_mode == 3:  # premultiplied: out = src + dst*(1-a)
        tile *= 1.0 - a
        tile += color
    elif alpha_mode == 5:  # multiply: dst * lerp(1, src, a)
        tile *= (1.0 - a) + color * a
    else:  # straight alpha blend (2/opaque fallthrough)
        tile *= 1.0 - a
        tile += color * a


def _draw_trail_segment(img, tbatch, pi, focal, width, height, ground=None):
    """Composite one ribbon segment (trails.py record layout) as a
    screen-space tapered line: per-pixel distance to the projected 2D
    segment against the width lerped along it, alpha lerped a0 -> a1."""
    seg, v0, v1, uni = tbatch
    z0, z1 = v0[pi, 2], v1[pi, 2]
    if z0 <= 0.05 or z1 <= 0.05:
        return
    p0 = np.array([focal * v0[pi, 0] / z0 + width * 0.5,
                   -focal * v0[pi, 1] / z0 + height * 0.5], np.float32)
    p1 = np.array([focal * v1[pi, 0] / z1 + width * 0.5,
                   -focal * v1[pi, 1] / z1 + height * 0.5], np.float32)
    r0 = max(focal * seg[pi, 3] / z0, 0.3)  # screen half-widths
    r1 = max(focal * seg[pi, 7] / z1, 0.0)
    rmax = max(r0, r1)
    x0 = int(min(p0[0], p1[0]) - rmax)
    x1 = int(max(p0[0], p1[0]) + rmax) + 1
    y0 = int(min(p0[1], p1[1]) - rmax)
    y1 = int(max(p0[1], p1[1]) + rmax) + 1
    if x1 < 0 or y1 < 0 or x0 >= width or y0 >= height:
        return
    x0c, x1c = max(x0, 0), min(x1, width)
    y0c, y1c = max(y0, 0), min(y1, height)
    if x0c >= x1c or y0c >= y1c:
        return
    yy, xx = np.mgrid[y0c:y1c, x0c:x1c]
    d = p1 - p0
    len2 = float(d @ d)
    if len2 < 1e-12:
        t = np.zeros(xx.shape, np.float32)
    else:
        t = np.clip(((xx - p0[0]) * d[0] + (yy - p0[1]) * d[1]) / len2, 0.0, 1.0)
    cx = p0[0] + t * d[0]
    cy = p0[1] + t * d[1]
    dist = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    w = r0 + t * (r1 - r0)
    with np.errstate(divide="ignore", invalid="ignore"):
        rr = np.where(w > 0, dist / np.maximum(w, 1e-6), np.inf)
    a = seg[pi, 11] + t * (seg[pi, 15] - seg[pi, 11])
    alpha = np.where(rr <= 1.0, a, 0.0)
    fade = uni.fade_edge
    if fade > 0:
        alpha = alpha * _smoothstep(0.0, fade, np.clip(1.0 - rr, 0.0, 1.0))
    if ground is not None:
        # ribbons obey the same ground depth test + scene fade as discs,
        # with per-pixel depth lerped along the segment
        cam, ground_y, near, focal_g, w_img, h_img = ground
        depth_px = z0 + t * (z1 - z0)
        ax = (xx + 0.5 - w_img * 0.5) / focal_g
        ay = -(yy + 0.5 - h_img * 0.5) / focal_g
        dy = cam.forward[1] + ax * cam.right[1] + ay * cam.up[1]
        with np.errstate(divide="ignore", invalid="ignore"):
            t_scene = (ground_y - cam.position[1]) / dy
        hits = t_scene > 0.0
        alpha = np.where(hits & (depth_px >= t_scene), 0.0, alpha)
        if uni.fade_scene > 0:
            # same smoothstep as the disc path, on inverse window depth
            # (reverse-Z: 1/(near/d) = d/near)
            alpha = alpha * _smoothstep(0.0, uni.fade_scene, np.abs(
                depth_px / near - np.where(hits, t_scene / near, np.inf)))
    color0 = seg[pi, 8:11]
    color1 = seg[pi, 12:15]
    color = color0[None, None, :] + t[..., None] * (color1 - color0)[None, None, :]
    _composite(img[y0c:y1c, x0c:x1c], uni.alpha_mode, color, alpha)


def render_frame(
    items: Sequence,
    camera: Optional[Camera] = None,
    width: int = 640,
    height: int = 480,
    background: Tuple[float, float, float] = (0.02, 0.02, 0.03),
    exposure: float = 1.0,
    ground_y: Optional[float] = None,
    near: float = 0.1,
    trail_items: Sequence = (),
    draw_ground: bool = False,
    shadows: bool = False,
    shadow_strength: float = 0.6,
    light_dir: Tuple[float, float, float] = (0.4, 0.8, 0.3),
    fog=None,
    lights=None,
    shadow_atlas=None,
) -> np.ndarray:
    """Rasterize RenderItems to an [H, W, 3] float image (simple Reinhard
    tonemap for the HDR gradients). Implements the contract's billboard +
    edge-fade + blend semantics in screen space.

    `draw_ground` shades the `ground_y` plane as visible opaque geometry
    (the WebGPU page's opaque ground pass); `shadows` additionally darkens
    it under particles — each particle's disc is projected along
    `light_dir` onto the plane and composited as accumulated transmittance,
    the software analog of the SHADOW_MAP pipeline variant's depth-map
    lookup (a projective blob shadow instead of a rasterized light-view
    depth pass; same light, same strength semantics: ground irradiance
    scales by 1 - strength * occlusion).

    `fog` (a `render.FogSettings`) mixes every particle fragment and the
    drawn ground toward the fog color by view distance — the software analog
    of the FOG pipeline variant (shaders/particles.wgsl `apply_fog`), using
    `FogSettings.amount` as the shared falloff oracle. Trail ribbons are
    intentionally unfogged: ribbons.wgsl ships no FOG variant.

    `ground_y` adds an analytic ground plane acting as the depth prepass:
    per-pixel reverse-Z test (Greater, like the reference pipeline
    render.rs:775-782) plus the reference's scene fade
    `alpha *= smoothstep(0, fade_scene, |1/z - 1/z_scene|)` on inverse
    window depth (reference particles.wgsl:149-155), with reverse-Z
    `z = near / view_depth` (Bevy's default near plane is 0.1). The
    fragment depth is approximated by the particle's center depth."""
    cam = camera or Camera()
    img = np.zeros((height, width, 3), np.float32)
    img[:] = background

    focal = 0.5 * width / np.tan(0.5 * cam.fov)

    if draw_ground and ground_y is not None:
        # opaque ground pass (the WebGPU page's groundPipeline color)
        yy, xx = np.mgrid[0:height, 0:width]
        ax = (xx + 0.5 - width * 0.5) / focal
        ay = -(yy + 0.5 - height * 0.5) / focal
        dy = cam.forward[1] + ax * cam.right[1] + ay * cam.up[1]
        with np.errstate(divide="ignore", invalid="ignore"):
            t_scene = (ground_y - cam.position[1]) / dy
        hits = np.nan_to_num(t_scene, nan=-1.0) > 0.0
        ground_color = np.array((0.075, 0.09, 0.11), np.float32)
        img[hits] = ground_color
        if shadows:
            l = np.asarray(light_dir, np.float32)
            l = l / max(float(np.linalg.norm(l)), 1e-6)
            # transmittance along the light ray, accumulated per pixel over
            # every particle disc projected onto the plane
            trans = np.ones((height, width), np.float32)
            for item in items:
                inst = np.asarray(item.instances, np.float32).reshape(-1, 16)
                fade = item.uniform.fade_edge
                for p in inst:
                    py_w = p[1] - ground_y
                    if py_w <= 0.0 or l[1] <= 1e-6 or p[11] <= 0.0:
                        continue  # below the plane / light from below / invisible
                    gp = p[0:3] - l * (py_w / l[1])  # shadow center on the plane
                    rel = gp - cam.position
                    depth = float(rel @ cam.forward)
                    if depth <= 0.05:
                        continue
                    sx = focal * float(rel @ cam.right) / depth + width * 0.5
                    sy = -focal * float(rel @ cam.up) / depth + height * 0.5
                    pr = max(focal * 0.5 * p[3] / depth, 0.3)
                    x0, x1 = max(int(sx - pr), 0), min(int(sx + pr) + 1, width)
                    y0, y1 = max(int(sy - pr), 0), min(int(sy + pr) + 1, height)
                    if x1 <= x0 or y1 <= y0:
                        continue
                    gyy, gxx = np.mgrid[y0:y1, x0:x1]
                    r = np.sqrt((gxx - sx) ** 2 + (gyy - sy) ** 2) / pr
                    occ = np.where(r <= 1.0, p[11], 0.0).astype(np.float32)
                    if fade > 0:
                        occ = occ * _smoothstep(0.0, fade, np.clip(1.0 - r, 0.0, 1.0))
                    trans[y0:y1, x0:x1] *= 1.0 - occ
            shade = 1.0 - shadow_strength * (1.0 - trans)
            img[hits] *= shade[hits, None]
        if fog is not None:
            # fog the ground like the WebGPU page's ground pass would —
            # world offset along the (unnormalized) pixel ray at t_scene
            ray = (cam.forward[None, None, :]
                   + ax[..., None] * cam.right + ay[..., None] * cam.up)
            rel = t_scene[..., None] * ray
            img[hits] = _fog_mix(fog, img[hits], rel[hits])

    # gather all particles with per-item uniform params
    batches = []
    for item in items:
        inst = np.asarray(item.instances, np.float32).reshape(-1, 16)
        if len(inst) == 0:
            continue
        rel = inst[:, 0:3] - cam.position
        depth = rel @ cam.forward
        x = rel @ cam.right
        y = rel @ cam.up
        batches.append((inst, depth, x, y, item.uniform))

    # trail ribbons enter the same global sort, keyed by segment midpoint
    tbatches = []
    for item in trail_items or ():
        seg = np.asarray(item.segments, np.float32).reshape(-1, 16)
        if len(seg) == 0:
            continue
        basis = np.stack([cam.right, cam.up, cam.forward])  # world -> view
        v0 = (seg[:, 0:3] - cam.position) @ basis.T
        v1 = (seg[:, 4:7] - cam.position) @ basis.T
        tbatches.append((seg, v0, v1, item.uniform))

    # global back-to-front ordering across items (transparent phase sort);
    # kind 0 = particle disc, kind 1 = trail segment
    order = []
    for bi, (inst, depth, x, y, uni) in enumerate(batches):
        for pi in range(len(inst)):
            order.append((depth[pi], 0, bi, pi))
    for bi, (seg, v0, v1, uni) in enumerate(tbatches):
        mid = 0.5 * (v0[:, 2] + v1[:, 2])
        for pi in range(len(seg)):
            order.append((mid[pi], 1, bi, pi))
    order.sort(key=lambda t: -t[0])

    ground_ctx = (cam, ground_y, near, focal, width, height) if ground_y is not None else None
    for depth, kind, bi, pi in order:
        if kind == 1:
            _draw_trail_segment(img, tbatches[bi], pi, focal, width, height, ground_ctx)
            continue
        inst, depths, xs, ys, uni = batches[bi]
        if depth <= 0.05:
            continue
        px = focal * xs[pi] / depth + width * 0.5
        py = -focal * ys[pi] / depth + height * 0.5
        # quad corners are +/-0.5 x scale in both the reference and shipped
        # shaders (particles.wgsl), so the disc RADIUS is scale/2
        pr = focal * 0.5 * inst[pi, 3] / depth  # screen-space radius
        if pr < 0.3:
            pr = 0.3
        x0, x1 = int(px - pr), int(px + pr) + 1
        y0, y1 = int(py - pr), int(py + pr) + 1
        if x1 < 0 or y1 < 0 or x0 >= width or y0 >= height:
            continue
        x0c, x1c = max(x0, 0), min(x1, width)
        y0c, y1c = max(y0, 0), min(y1, height)
        yy, xx = np.mgrid[y0c:y1c, x0c:x1c]
        r = np.sqrt((xx - px) ** 2 + (yy - py) ** 2) / pr
        base = inst[pi, 8:12]
        emis = inst[pi, 12:16]
        alpha = np.full(r.shape, base[3], np.float32)
        fade = uni.fade_edge
        if fade > 0:
            # alpha *= smoothstep(0, fade_edge, 1 - r): ramp over
            # r in [1 - fade_edge, 1] (reference particles.wgsl:140-147)
            alpha = alpha * _smoothstep(0.0, fade, np.clip(1.0 - r, 0.0, 1.0))
        alpha = np.where(r <= 1.0, alpha, 0.0)
        if ground_y is not None:
            # per-pixel view depth at which the camera ray hits the plane
            ax = (xx + 0.5 - width * 0.5) / focal
            ay = -(yy + 0.5 - height * 0.5) / focal
            dy = cam.forward[1] + ax * cam.right[1] + ay * cam.up[1]
            with np.errstate(divide="ignore", invalid="ignore"):
                t_scene = (ground_y - cam.position[1]) / dy
            hits = t_scene > 0.0
            # reverse-Z depth test Greater: fragment behind the plane fails
            alpha = np.where(hits & (depth >= t_scene), 0.0, alpha)
            if uni.fade_scene > 0:
                diff = np.abs(1.0 / (near / depth) - np.where(hits, 1.0 / (near / t_scene), np.inf))
                alpha = alpha * _smoothstep(0.0, uni.fade_scene, diff)
        if uni.pbr:
            # mirrors shaders/particles.wgsl pbr_shade: Cook-Torrance GGX;
            # billboard normal = to-camera, untextured defaults roughness
            # 1.0 / metallic 0. Environment: the built-in single directional
            # light, or — when a LightTable is passed — the LIGHTS
            # variant's loop (LightTable.radiance_at is the shared oracle).
            n = -np.array([xs[pi], ys[pi], depth], np.float32)
            n = n / max(np.linalg.norm(n), 1e-6)
            v = n  # camera-facing quad: normal == view direction
            basis = np.stack([cam.right, cam.up, cam.forward])
            nv = max(float(n @ v), 1e-4)
            a = 1.0  # perceptual_roughness 1.0 squared

            def ggx_direct(l, radiance):
                h = v + l
                h = h / max(np.linalg.norm(h), 1e-6)
                nl = max(float(n @ l), 0.0)
                nh = max(float(n @ h), 0.0)
                lh = max(float(l @ h), 0.0)
                d = a * a / (np.pi * (nh * nh * (a * a - 1.0) + 1.0) ** 2)
                gv = nl * np.sqrt(nv * nv * (1.0 - a * a) + a * a)
                gl = nv * np.sqrt(nl * nl * (1.0 - a * a) + a * a)
                vis = 0.5 / max(gv + gl, 1e-5)
                f0 = 0.04
                fr = f0 + (1.0 - f0) * (1.0 - lh) ** 5
                return (base[0:3] / np.pi + d * vis * fr) * np.asarray(radiance, np.float32) * nl

            if lights is None:
                light_w = np.array([0.4, 0.8, 0.3], np.float32)
                light_w = light_w / np.linalg.norm(light_w)
                direct = ggx_direct(basis @ light_w, (1.0, 1.0, 1.0))
                ambient = np.array([0.09, 0.09, 0.1], np.float32)
            else:
                world_pos = (cam.position + xs[pi] * cam.right + ys[pi] * cam.up
                             + depth * cam.forward)
                direct = np.zeros(3, np.float32)
                for li, (l_w, radiance) in enumerate(lights.radiance_at(world_pos)):
                    c = ggx_direct(basis @ np.asarray(l_w, np.float32), radiance)
                    if shadow_atlas is not None:
                        # SHADOW_ATLAS semantics: per-light factor on the
                        # direct contribution only (ShadowAtlas.factor is
                        # the shared WGSL oracle)
                        c = c * shadow_atlas.factor(world_pos, li)
                    direct = direct + c
                ambient = np.asarray(lights.ambient[:3], np.float32)
            indirect = base[0:3] * ambient
            if lights is not None and lights.environment is not None:
                # environment light (SH IBL): same diffuse+specular indirect
                # term as the WGSL (EnvironmentLight.shade_indirect is the
                # shared oracle); untextured viewer defaults metallic 0 /
                # roughness 1 like the direct path above
                n_w = basis.T @ n
                indirect = indirect + lights.environment.shade_indirect(
                    n_w, n_w, base[0:3], metallic=0.0, roughness=1.0)
            color = direct + indirect + emis[0:3]
        else:
            # unlit path: base color alone (reference particles.wgsl:162-163)
            color = base[0:3]
        if fog is not None:
            # view effect after the lighting branch for BOTH paths, same
            # ordering as the FOG variant's fragment
            rel_w = xs[pi] * cam.right + ys[pi] * cam.up + depth * cam.forward
            color = _fog_mix(fog, np.asarray(color, np.float32), rel_w)
        _composite(img[y0c:y1c, x0c:x1c], uni.alpha_mode, color, alpha)

    # Reinhard tonemap for HDR colors
    img = img * exposure
    return img / (1.0 + img)


def render_scene_png(scene, path: str, camera: Optional[Camera] = None, width: int = 640, height: int = 480, **kw):
    img = render_frame(
        scene.render_items(), camera, width, height,
        trail_items=scene.trail_items(), **kw,
    )
    write_png(path, img)
    return path
