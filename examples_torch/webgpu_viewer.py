"""Execute the SHIPPED WGSL: export simulated frames plus the specialized
pipeline descriptor to a standalone WebGPU page.

Unlike `web_viewer.py` (a WebGL2 re-implementation of the billboard
semantics), this page runs `bevy_firework_tpu_torch/shaders/particles.wgsl`
ITSELF: the JS builds its `GPURenderPipeline` mechanically from the
serialized `SpecializedPipeline` the engine's `PipelineCache` produced —
the preprocessed shader source verbatim, the pinned ALPHA_BLENDING blend
state, reverse-Z `greater` depth with writes off, the group(2) bind-group
layout (uniform + depth prepass + real-or-dummy material textures), the
64-byte instance vertex layout at locations 3-6
(bevy_firework `src/render.rs:737-766`), and one
`draw(6, count)` per system per frame (`render.rs:926`).

The page also renders a ground-plane depth prepass (the host-engine-side
work Bevy's prepass does for the reference), so the DEPTH_PREPASS variant's
`fade_scene` path — `alpha *= smoothstep(0, fade_scene, |1/z - 1/z_scene|)`
(reference particles.wgsl:149-155) — executes for real: the default scene
is the `pbr` smoke (fade_scene 3.5) hugging the ground.

The scene runs on the card (`--cpu`: on the CPU, the kernels' plain
versions); the descriptor comes from this package's `PipelineCache` and
`ribbons_wgsl_source`, and the page is the JAX package's example's,
character for character but its citations of the reference's sources,
by project name.

Usage: python examples_torch/webgpu_viewer.py [--cpu] [--scene pbr|sparks|mixed] [--out DIR]
Writes webgpu_viewer.html under --out (examples_torch/out/) — open in a
WebGPU browser (Chrome/Edge 113+, Safari 18+); no server needed.
"""

import argparse
import base64
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _common_torch import add_device_args, device_of  # noqa: E402

parser = argparse.ArgumentParser()
parser.add_argument("--scene", default="mixed", choices=["pbr", "sparks", "mixed", "textures", "comets"])
parser.add_argument("--frames", type=int, default=120)
parser.add_argument("--warmup", type=int, default=90)
parser.add_argument("--fog", action="store_true",
                    help="compile the FOG pipeline variant and bind a linear "
                         "distance fog uniform at group(2) binding 11")
parser.add_argument("--lights", action="store_true",
                    help="compile the LIGHTS pipeline variant and bind a "
                         "light table (1 directional + 1 point + 1 spot, "
                         "Bevy clustered-PBR semantics) at group(2) binding 12")
add_device_args(parser)
args = parser.parse_args()
device = device_of(args)

from bevy_firework_tpu_torch import Scene, TrailSettings, Transform, instances_to_bytes  # noqa: E402
from bevy_firework_tpu_torch.models import effects, library  # noqa: E402
from bevy_firework_tpu_torch.shaders import ribbons_wgsl_source  # noqa: E402
from bevy_firework_tpu_torch.shaders.specialize import (  # noqa: E402
    ALPHA_BLEND,
    PipelineCache,
    key_for,
)

if args.scene == "textures":
    # reference examples/textures.rs: textured PBR shell casings (real
    # base/normal/ORM maps -> flags != 0 -> the page binds REAL textures)
    # + nested smoke + cylinder/cone collision
    sp, tf, colliders = effects.textures()
    scene = Scene(seed=7, colliders=colliders, device=device)
    scene.add_spawner(sp, capacity=2048, transform=tf)
elif args.scene == "comets":
    # ribbon trails (docs/RENDER_CONTRACT.md 3b): the page draws the trail
    # segments with shaders/ribbons.wgsl alongside the particle heads
    scene = Scene(seed=7, device=device)
    scene.add_spawner(library.comets(), capacity=256,
                      transform=Transform(translation=(0.0, 0.5, 0.0)),
                      trail=TrailSettings(length=16, width=0.8))
else:
    scene = Scene(seed=7, device=device)
    if args.scene in ("pbr", "mixed"):
        sp, tf = effects.pbr()
        scene.add_spawner(sp, capacity=2048, transform=tf)
    if args.scene in ("sparks", "mixed"):
        sp, tf = effects.sparks()
        scene.add_spawner(sp, capacity=2048, transform=Transform(translation=(0.0, 0.6, 0.0)))

dt = 1.0 / 60.0
for _ in range(args.warmup):
    scene.step(dt)

frames = []
for _ in range(args.frames):
    scene.step(dt)
    fi = []
    # trail ribbons draw first (behind their own heads); same 64 B stride
    for item in scene.trail_items():
        fi.append(
            {
                "key": f"trail:{item.spawner_id}:{item.type_index}",
                "ribbon": True,
                "count": int(item.count),
                "uniform": base64.b64encode(item.uniform.to_bytes()).decode(),
                "textures": [None, None, None],
                "data": base64.b64encode(instances_to_bytes(item.segments)).decode(),
            }
        )
    for item in scene.render_items():
        u = item.uniform
        fi.append(
            {
                # render_items skips empty types, so positional indexing is
                # NOT stable across frames; key each draw by its render
                # entity identity (spawner x type, render.rs:439-461)
                "key": f"{item.spawner_id}:{item.type_index}",
                "count": int(item.count),
                # the 32 contract bytes; the page pads the GPU buffer to the
                # WGSL struct's 48-byte size (the vec3 pad aligns to 16)
                "uniform": base64.b64encode(u.to_bytes()).decode(),
                "textures": list(item.textures),
                "data": base64.b64encode(instances_to_bytes(item.instances)).decode(),
            }
        )
    frames.append(fi)

# Embed any referenced texture assets (asset-relative paths, like the
# reference's asset server handles) as base64 PNGs.
ASSET_ROOT = os.path.join(os.path.dirname(__file__), "..", "assets")
tex_paths = sorted({p for f in frames for s in f for p in s["textures"] if p})
assets = {}
for p in tex_paths:
    with open(os.path.join(ASSET_ROOT, p), "rb") as fh:
        assets[p] = base64.b64encode(fh.read()).decode()

# The engine-side specialization: every reference example renders with a
# depth prepass and no MSAA; alpha_mode only alters KEY bits, never the
# pipeline state (blend is pinned to ALPHA_BLENDING, render.rs:855-859), so
# one specialized variant serves every system on this page. shadow_map=True
# adds the SHADOW_MAP def: the page renders a directional light-view depth
# pass and pbr_shade samples it (casing shadows in the textures scene).
variant = PipelineCache().specialize(
    key_for(ALPHA_BLEND, depth_prepass=True, shadow_map=True, fog=args.fog,
            lights=args.lights, shadow_atlas=args.lights))
desc = dataclasses.asdict(variant)
del desc["key"]  # everything the consumer needs is in the descriptor fields
if args.fog:
    # FOG variant (Bevy DistanceFog analog): the page binds these 64 std140
    # bytes at group(2) binding 11; apply_fog mixes every fragment by view
    # distance, with a little sun inscattering along the shadow light.
    from bevy_firework_tpu_torch.render import FogSettings

    desc["fog_uniform"] = base64.b64encode(FogSettings(
        color=(0.10, 0.13, 0.19, 1.0), start=7.0, end=30.0,
        directional_light_color=(0.9, 0.75, 0.5, 0.25),
        directional_light_exponent=12.0, light_dir=(0.5, 0.7, 0.4),
    ).to_bytes()).decode()
if args.lights:
    # LIGHTS variant (Bevy clustered-PBR analog): the page binds these std140
    # bytes at group(2) binding 12; pbr_shade loops the table instead of the
    # built-in single directional environment. The spot CASTS via the
    # SHADOW_ATLAS variant: the page renders its tile of
    # the depth atlas itself against the engine's light_view_proj matrix and
    # binds the engine's ShadowAtlasUniform bytes at 13-15.
    import numpy as np

    from bevy_firework_tpu_torch.render import (MAX_LIGHTS, EnvironmentLight, Light,
                                                LightTable, ShadowAtlas)

    _table = LightTable(
        lights=(
            Light.directional((-0.5, -0.7, -0.4), color=(1.0, 0.95, 0.85), illuminance=0.8),
            Light.point((2.0, 2.5, 0.0), color=(0.2, 0.5, 1.0), intensity=120.0, range=18.0),
            Light.spot((-3.0, 4.0, 2.0), (0.5, -1.0, -0.3), color=(1.0, 0.4, 0.2),
                       intensity=250.0, range=25.0, inner_angle=0.35, outer_angle=0.55,
                       shadow=True),
        ),
        ambient=(0.05, 0.05, 0.07),
        # SH environment (IBL): the LIGHTS uniform's tail block; the page's
        # mechanically-walked 1216 B buffer carries it to the real GPU
        environment=EnvironmentLight.gradient(
            sky=(0.25, 0.35, 0.8), horizon=(0.6, 0.4, 0.3),
            ground=(0.12, 0.1, 0.08), intensity=0.6),
    )
    desc["lights_uniform"] = base64.b64encode(_table.to_bytes()).decode()
    from bevy_firework_tpu_torch.render import _look_at, shadow_tile_entries

    # the engine's single source of truth for tile layout (dir/spot rows:
    # one tile; point rows: six cube faces)
    _entries = shadow_tile_entries(_table, center=(0.0, 1.0, 0.0), radius=12.0)
    _n_tiles = max([t + 1 for _r, t, _m, _d in _entries], default=0)
    _grid = 1
    while _grid * _grid < _n_tiles:
        _grid += 1
    _mats = np.zeros((MAX_LIGHTS, 4, 4), np.float32)
    _tile_meta = []
    for _row, _ti, _m, _dir in _entries:
        _mats[_ti] = _m
        # caster-pass basis: the light camera's right/up (billboards face
        # the light); recover like _look_at does
        _v = _look_at(_table.lights[_row].position, _dir)
        _tile_meta.append({
            "tile": _ti,
            "vp": [float(x) for x in np.asarray(_m).T.ravel()],  # column-major
            "right": [float(x) for x in _v[0, :3]],
            "up": [float(x) for x in _v[1, :3]],
        })
    _atlas = ShadowAtlas(table=_table, depth=np.ones((1, 1), np.float32),
                         mats=_mats, grid=_grid, bias=0.004, strength=0.8)
    desc["shadow_atlas_uniform"] = base64.b64encode(_atlas.to_bytes()).decode()
    desc["shadow_atlas_grid"] = _grid
    desc["shadow_atlas_tiles"] = _tile_meta

HTML = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>bevy_firework_tpu - shipped-WGSL WebGPU viewer</title>
<style>html,body{margin:0;background:#0b0e13;color:#9aa4b2;font:12px monospace;overflow:hidden}
#hud{position:fixed;left:10px;top:8px;user-select:none;white-space:pre}</style></head>
<body><canvas id="c"></canvas><div id="hud">starting…</div>
<script>
"use strict";
const DESC = __DESC__;      // SpecializedPipeline, serialized by the engine
const FRAMES = __FRAMES__;  // per-frame, per-system 64 B instance records
const ASSETS = __ASSETS__;  // texture path -> base64 PNG
const RIBBON_WGSL = __RIBBON__;  // shipped ribbons.wgsl (trail contract 3b)
const hud = document.getElementById("hud");
const cv = document.getElementById("c");

// ---- page-local (host-engine-side) shaders: Bevy provides these around the
// reference — a depth prepass and an opaque ground pass. The PARTICLE
// pipeline below uses only DESC.shader_source, the shipped WGSL.
const GROUND_WGSL = `
struct ViewLike { view_proj: mat4x4<f32>, inverse_view: mat4x4<f32>, world_position: vec3<f32> };
struct ShadowUniform { light_view_proj: mat4x4<f32>, params: vec4<f32> };
@group(0) @binding(0) var<uniform> view: ViewLike;
@group(1) @binding(0) var<uniform> shadow: ShadowUniform;
@group(1) @binding(1) var shadow_map: texture_depth_2d;
@group(1) @binding(2) var shadow_samp: sampler_comparison;
struct GOut { @builtin(position) clip: vec4<f32>, @location(0) world: vec3<f32> };
@vertex fn vertex(@location(0) pos: vec3<f32>) -> GOut {
  var o: GOut;
  o.clip = view.view_proj * vec4<f32>(pos, 1.0);
  o.world = pos;
  return o;
}
@fragment fn fragment(in: GOut) -> @location(0) vec4<f32> {
  // the ground RECEIVES particle shadows (same lookup as the shipped
  // shader's shadow_factor; the casings darken the plane under them)
  let lc = shadow.light_view_proj * vec4<f32>(in.world, 1.0);
  let ndc = lc.xyz / lc.w;
  let uv = ndc.xy * vec2<f32>(0.5, -0.5) + vec2<f32>(0.5, 0.5);
  var lit = 1.0;
  if (uv.x >= 0.0 && uv.x <= 1.0 && uv.y >= 0.0 && uv.y <= 1.0 && ndc.z <= 1.0) {
    let ref_depth = ndc.z - shadow.params.x;
    let texel = 1.0 / vec2<f32>(textureDimensions(shadow_map));
    var s = textureSampleCompare(shadow_map, shadow_samp, uv + vec2<f32>(-0.5, -0.5) * texel, ref_depth);
    s = s + textureSampleCompare(shadow_map, shadow_samp, uv + vec2<f32>(0.5, -0.5) * texel, ref_depth);
    s = s + textureSampleCompare(shadow_map, shadow_samp, uv + vec2<f32>(-0.5, 0.5) * texel, ref_depth);
    s = s + textureSampleCompare(shadow_map, shadow_samp, uv + vec2<f32>(0.5, 0.5) * texel, ref_depth);
    lit = 1.0 - shadow.params.y * (1.0 - s * 0.25);
  }
  return vec4<f32>(vec3<f32>(0.075, 0.09, 0.11) * lit, 1.0);
}`;

// Light-view depth pass for particle casters (host-engine-side, the analog
// of Bevy's shadow-caster pipeline): quads billboarded toward the LIGHT,
// alpha-tested to a disc so shadows are round like the particles.
const SHADOW_CASTER_WGSL = `
struct ShadowView { light_view_proj: mat4x4<f32>, right: vec4<f32>, up: vec4<f32> };
@group(0) @binding(0) var<uniform> sv: ShadowView;
struct VsIn {
  @builtin(vertex_index) vertex_index: u32,
  @location(3) pos_scale: vec4<f32>,
  @location(4) rotation: vec4<f32>,
  @location(5) base_color: vec4<f32>,
  @location(6) emissive: vec4<f32>,
};
struct VsOut { @builtin(position) clip: vec4<f32>, @location(0) uv: vec2<f32>, @location(1) alpha: f32 };
@vertex fn vertex(in: VsIn) -> VsOut {
  var corners = array<vec2<f32>, 6>(
    vec2<f32>(-0.5, -0.5), vec2<f32>(0.5, -0.5), vec2<f32>(0.5, 0.5),
    vec2<f32>(-0.5, -0.5), vec2<f32>(0.5, 0.5), vec2<f32>(-0.5, 0.5),
  );
  let c = corners[in.vertex_index];
  let world = in.pos_scale.xyz + (c.x * sv.right.xyz + c.y * sv.up.xyz) * in.pos_scale.w;
  var o: VsOut;
  o.clip = sv.light_view_proj * vec4<f32>(world, 1.0);
  o.uv = c + vec2<f32>(0.5, 0.5);
  o.alpha = in.base_color.a;
  return o;
}
@fragment fn fragment(in: VsOut) {
  let r = length(in.uv - vec2<f32>(0.5, 0.5)) * 2.0;
  if (r > 1.0 || in.alpha < 0.25) { discard; }
}`;

function mat4mul(a, b) {  // column-major a*b
  const o = new Float32Array(16);
  for (let c = 0; c < 4; c++) for (let r = 0; r < 4; r++) {
    let s = 0;
    for (let k = 0; k < 4; k++) s += a[k*4+r] * b[c*4+k];
    o[c*4+r] = s;
  }
  return o;
}
function lookAt(eye, at) {
  const up = [0,1,0];
  let z = [eye[0]-at[0], eye[1]-at[1], eye[2]-at[2]];
  const zl = Math.hypot(...z); z = z.map(v => v/zl);
  let x = [up[1]*z[2]-up[2]*z[1], up[2]*z[0]-up[0]*z[2], up[0]*z[1]-up[1]*z[0]];
  const xl = Math.hypot(...x); x = x.map(v => v/xl);
  const y = [z[1]*x[2]-z[2]*x[1], z[2]*x[0]-z[0]*x[2], z[0]*x[1]-z[1]*x[0]];
  const view = new Float32Array([x[0],y[0],z[0],0, x[1],y[1],z[1],0, x[2],y[2],z[2],0,
    -(x[0]*eye[0]+x[1]*eye[1]+x[2]*eye[2]),
    -(y[0]*eye[0]+y[1]*eye[1]+y[2]*eye[2]),
    -(z[0]*eye[0]+z[1]*eye[1]+z[2]*eye[2]), 1]);
  // inverse of a rigid transform: transpose rotation, eye translation
  const inv = new Float32Array([x[0],x[1],x[2],0, y[0],y[1],y[2],0, z[0],z[1],z[2],0,
    eye[0],eye[1],eye[2],1]);
  return {view, inv};
}
// Reverse-Z infinite perspective (depth = near / view_dist, matching the
// engine's reverse-Z `greater` depth state and the 1/z fade comparison).
function perspRevZ(fov, aspect, near) {
  const f = 1/Math.tan(fov/2);
  return new Float32Array([f/aspect,0,0,0, 0,f,0,0, 0,0,0,-1, 0,0,near,0]);
}

function decodeFrames() {
  return FRAMES.map(f => f.map(s => {
    const bin = atob(s.data); const a = new Uint8Array(bin.length);
    for (let i = 0; i < bin.length; i++) a[i] = bin.charCodeAt(i);
    const ub = atob(s.uniform); const u = new Uint8Array(48);  // WGSL struct size
    for (let i = 0; i < ub.length; i++) u[i] = ub.charCodeAt(i);
    return {key: s.key, count: s.count, buf: a, uniform: u, textures: s.textures,
            ribbon: !!s.ribbon};
  }));
}

async function main() {
  if (!navigator.gpu) { hud.textContent = "WebGPU unavailable in this browser"; return; }
  const adapter = await navigator.gpu.requestAdapter();
  if (!adapter) { hud.textContent = "no WebGPU adapter"; return; }
  const device = await adapter.requestDevice();
  const ctx = cv.getContext("webgpu");

  // Target format: the engine key resolved bgra8unorm-srgb (hdr=false,
  // render.rs:831). Configure the canvas base format and render through an
  // sRGB view; fall back to the platform-preferred family if it differs.
  const pref = navigator.gpu.getPreferredCanvasFormat();
  const srgb = pref + "-srgb";
  const targetFormat = (srgb === DESC.target_format) ? DESC.target_format : srgb;
  ctx.configure({device, format: pref, viewFormats: [targetFormat], alphaMode: "opaque"});

  // ---- bind group layouts, built 1:1 from DESC.layout (group 2) ----
  const g0Layout = device.createBindGroupLayout({entries: [
    {binding: 0, visibility: GPUShaderStage.VERTEX | GPUShaderStage.FRAGMENT,
     buffer: {type: "uniform"}},
  ]});
  const g1Layout = device.createBindGroupLayout({entries: []});  // view group 1 unused
  const g2Entries = DESC.layout.map(e => {
    const out = {binding: e.binding, visibility: GPUShaderStage.FRAGMENT};
    if (e.type === "uniform-buffer") out.buffer = {type: "uniform"};
    else if (e.type === "texture")
      out.texture = {sampleType: e.sample_type, multisampled: !!e.multisampled};
    else out.sampler = {type: e.comparison ? "comparison"
                              : (e.filtering ? "filtering" : "non-filtering")};
    return out;
  });
  const g2Layout = device.createBindGroupLayout({entries: g2Entries});

  // ---- THE pipeline: every field comes from the engine's descriptor ----
  const module = device.createShaderModule({code: DESC.shader_source});
  const info = await module.getCompilationInfo();
  const errs = info.messages.filter(m => m.type === "error");
  if (errs.length) {
    hud.textContent = "shipped WGSL failed to compile:\n" +
      errs.map(m => `${m.lineNum}:${m.linePos} ${m.message}`).join("\n");
    return;
  }
  const blend = c => ({srcFactor: c.src_factor, dstFactor: c.dst_factor, operation: c.operation});
  const particlePipeline = device.createRenderPipeline({
    layout: device.createPipelineLayout({bindGroupLayouts: [g0Layout, g1Layout, g2Layout]}),
    vertex: {
      module, entryPoint: "vertex",
      buffers: [{
        arrayStride: 64, stepMode: "instance",  // render.rs:737-766
        attributes: [3, 4, 5, 6].map((loc, i) =>
          ({shaderLocation: loc, offset: 16*i, format: "float32x4"})),
      }],
    },
    fragment: {module, entryPoint: "fragment",
      targets: [{format: targetFormat, blend: {color: blend(DESC.blend.color), alpha: blend(DESC.blend.alpha)}}]},
    primitive: {topology: DESC.topology, cullMode: DESC.cull_mode ?? undefined},
    depthStencil: {format: "depth32float",
      depthWriteEnabled: DESC.depth_write_enabled, depthCompare: DESC.depth_compare},
    multisample: {count: DESC.multisample_count},
  });

  // ---- ribbon pipeline (shipped ribbons.wgsl, trail contract 3b): same
  // 64 B instance stride/locations, same pinned blend + reverse-Z depth;
  // group(2) is the uniform alone (no textures in the ribbon contract) ----
  const rg2Layout = device.createBindGroupLayout({entries: [
    {binding: 0, visibility: GPUShaderStage.FRAGMENT, buffer: {type: "uniform"}},
  ]});
  let ribbonPipeline = null;
  if (RIBBON_WGSL) {
    const rmod = device.createShaderModule({code: RIBBON_WGSL});
    const rinfo = await rmod.getCompilationInfo();
    const rerrs = rinfo.messages.filter(m => m.type === "error");
    if (rerrs.length) {
      hud.textContent = "shipped ribbons.wgsl failed to compile:\n" +
        rerrs.map(m => `${m.lineNum}:${m.linePos} ${m.message}`).join("\n");
      return;
    }
    ribbonPipeline = device.createRenderPipeline({
      layout: device.createPipelineLayout({bindGroupLayouts: [g0Layout, g1Layout, rg2Layout]}),
      vertex: {module: rmod, entryPoint: "vertex",
        buffers: [{arrayStride: 64, stepMode: "instance",
          attributes: [3, 4, 5, 6].map((loc, i) =>
            ({shaderLocation: loc, offset: 16*i, format: "float32x4"}))}]},
      fragment: {module: rmod, entryPoint: "fragment",
        targets: [{format: targetFormat, blend: {color: blend(DESC.blend.color), alpha: blend(DESC.blend.alpha)}}]},
      primitive: {topology: DESC.topology, cullMode: DESC.cull_mode ?? undefined},
      depthStencil: {format: "depth32float",
        depthWriteEnabled: DESC.depth_write_enabled, depthCompare: DESC.depth_compare},
      multisample: {count: DESC.multisample_count},
    });
  }

  // ---- host-engine-side: directional shadow map (the analog of Bevy's
  // shadow pass feeding the reference's apply_pbr_lighting) ----
  const SHADOW_SIZE = 1024;
  const shadowDepth = device.createTexture({size: [SHADOW_SIZE, SHADOW_SIZE],
    format: "depth32float",
    usage: GPUTextureUsage.RENDER_ATTACHMENT | GPUTextureUsage.TEXTURE_BINDING});
  const shadowDepthView = shadowDepth.createView();
  const compSamp = device.createSampler({compare: "less-equal"});
  // light matrices: ortho box around the scene, looking along -LIGHT_DIR
  // (the shipped shader's const light (0.4, 0.8, 0.3))
  const ll = Math.hypot(0.4, 0.8, 0.3);
  const ldir = [0.4/ll, 0.8/ll, 0.3/ll];
  const lightAt = [0, 1, 0];
  const lightEye = [lightAt[0] + ldir[0]*20, lightAt[1] + ldir[1]*20, lightAt[2] + ldir[2]*20];
  const lv = lookAt(lightEye, lightAt);
  const HALF = 14, LNEAR = 1, LFAR = 45;  // standard 0..1 depth (not reverse)
  const lproj = new Float32Array([1/HALF,0,0,0, 0,1/HALF,0,0,
    0,0,-1/(LFAR-LNEAR),0, 0,0,-LNEAR/(LFAR-LNEAR),1]);
  const lightVP = mat4mul(lproj, lv.view);
  // group(2) bindings 8-10 consume this uniform: mat4 + (bias, strength)
  const shadowUniBuf = device.createBuffer({size: 80, usage: GPUBufferUsage.UNIFORM | GPUBufferUsage.COPY_DST});
  { const u = new Float32Array(20); u.set(lightVP, 0); u[16] = 0.004; u[17] = 0.6;
    device.queue.writeBuffer(shadowUniBuf, 0, u); }
  // FOG variant: the engine's 64 std140 FogSettings bytes -> binding 11
  let fogUniBuf = null;
  if (DESC.fog_uniform) {
    fogUniBuf = device.createBuffer({size: 64, usage: GPUBufferUsage.UNIFORM | GPUBufferUsage.COPY_DST});
    const fb = atob(DESC.fog_uniform); const fa = new Uint8Array(64);
    for (let i = 0; i < fb.length; i++) fa[i] = fb.charCodeAt(i);
    device.queue.writeBuffer(fogUniBuf, 0, fa);
  }
  // LIGHTS variant: the engine's std140 LightTable bytes -> binding 12
  let lightsUniBuf = null;
  if (DESC.lights_uniform) {
    const lb = atob(DESC.lights_uniform); const la = new Uint8Array(lb.length);
    for (let i = 0; i < lb.length; i++) la[i] = lb.charCodeAt(i);
    lightsUniBuf = device.createBuffer({size: la.length, usage: GPUBufferUsage.UNIFORM | GPUBufferUsage.COPY_DST});
    device.queue.writeBuffer(lightsUniBuf, 0, la);
  }
  // SHADOW_ATLAS variant: one tiled depth texture; the page renders each
  // shadow light's tile itself (the engine authored the matrices — the
  // same contract a real renderer follows), engine uniform -> binding 13
  let atlasUniBuf = null, atlasView = null, atlasTiles = [];
  const ATLAS_TILE = 512;
  if (DESC.shadow_atlas_uniform) {
    const ab = atob(DESC.shadow_atlas_uniform); const aa = new Uint8Array(ab.length);
    for (let i = 0; i < ab.length; i++) aa[i] = ab.charCodeAt(i);
    atlasUniBuf = device.createBuffer({size: aa.length, usage: GPUBufferUsage.UNIFORM | GPUBufferUsage.COPY_DST});
    device.queue.writeBuffer(atlasUniBuf, 0, aa);
    const g = DESC.shadow_atlas_grid;
    const atlasTex = device.createTexture({size: [g*ATLAS_TILE, g*ATLAS_TILE],
      format: "depth32float",
      usage: GPUTextureUsage.RENDER_ATTACHMENT | GPUTextureUsage.TEXTURE_BINDING});
    atlasView = atlasTex.createView();
    for (const tm of DESC.shadow_atlas_tiles) {
      const buf = device.createBuffer({size: 96, usage: GPUBufferUsage.UNIFORM | GPUBufferUsage.COPY_DST});
      const u = new Float32Array(24);
      u.set(tm.vp, 0); u.set(tm.right, 16); u.set(tm.up, 20);
      device.queue.writeBuffer(buf, 0, u);
      atlasTiles.push({tile: tm.tile, buf});
    }
  }
  // caster-pass uniform: light vp + the light-facing quad basis
  const lright = [lv.inv[0], lv.inv[1], lv.inv[2]];
  const lup = [lv.inv[4], lv.inv[5], lv.inv[6]];
  const shadowViewBuf = device.createBuffer({size: 96, usage: GPUBufferUsage.UNIFORM | GPUBufferUsage.COPY_DST});
  { const u = new Float32Array(24); u.set(lightVP, 0);
    u.set(lright, 16); u.set(lup, 20);
    device.queue.writeBuffer(shadowViewBuf, 0, u); }
  const smod = device.createShaderModule({code: SHADOW_CASTER_WGSL});
  const svLayout = device.createBindGroupLayout({entries: [
    {binding: 0, visibility: GPUShaderStage.VERTEX, buffer: {type: "uniform"}}]});
  const svGroup = device.createBindGroup({layout: svLayout,
    entries: [{binding: 0, resource: {buffer: shadowViewBuf}}]});
  const casterPipeline = device.createRenderPipeline({
    layout: device.createPipelineLayout({bindGroupLayouts: [svLayout]}),
    vertex: {module: smod, entryPoint: "vertex",
      buffers: [{arrayStride: 64, stepMode: "instance",
        attributes: [3, 4, 5, 6].map((loc, i) =>
          ({shaderLocation: loc, offset: 16*i, format: "float32x4"}))}]},
    fragment: {module: smod, entryPoint: "fragment", targets: []},
    primitive: {topology: "triangle-list"},
    depthStencil: {format: "depth32float", depthWriteEnabled: true, depthCompare: "less"},
  });

  // ---- host-engine-side: ground prepass + opaque pass pipelines ----
  const gmod = device.createShaderModule({code: GROUND_WGSL});
  const gShadowLayout = device.createBindGroupLayout({entries: [
    {binding: 0, visibility: GPUShaderStage.FRAGMENT, buffer: {type: "uniform"}},
    {binding: 1, visibility: GPUShaderStage.FRAGMENT, texture: {sampleType: "depth"}},
    {binding: 2, visibility: GPUShaderStage.FRAGMENT, sampler: {type: "comparison"}},
  ]});
  const gShadowGroup = device.createBindGroup({layout: gShadowLayout, entries: [
    {binding: 0, resource: {buffer: shadowUniBuf}},
    {binding: 1, resource: shadowDepthView},
    {binding: 2, resource: compSamp},
  ]});
  const groundVertex = {module: gmod, entryPoint: "vertex",
    buffers: [{arrayStride: 12, attributes: [{shaderLocation: 0, offset: 0, format: "float32x3"}]}]};
  const prepassPipeline = device.createRenderPipeline({
    layout: device.createPipelineLayout({bindGroupLayouts: [g0Layout]}),
    vertex: groundVertex,  // depth-only: no fragment
    primitive: {topology: "triangle-list"},
    depthStencil: {format: "depth32float", depthWriteEnabled: true, depthCompare: "greater"},
  });
  const groundPipeline = device.createRenderPipeline({
    layout: device.createPipelineLayout({bindGroupLayouts: [g0Layout, gShadowLayout]}),
    vertex: groundVertex,
    fragment: {module: gmod, entryPoint: "fragment", targets: [{format: targetFormat}]},
    primitive: {topology: "triangle-list"},
    depthStencil: {format: "depth32float", depthWriteEnabled: true, depthCompare: "greater"},
  });

  const E = 30;
  const groundVerts = new Float32Array([-E,0,-E, E,0,-E, E,0,E, -E,0,-E, E,0,E, -E,0,E]);
  const groundBuf = device.createBuffer({size: groundVerts.byteLength, usage: GPUBufferUsage.VERTEX | GPUBufferUsage.COPY_DST});
  device.queue.writeBuffer(groundBuf, 0, groundVerts);

  // ---- resources: view uniform, dummy textures, per-system bindings ----
  const viewBuf = device.createBuffer({size: 144, usage: GPUBufferUsage.UNIFORM | GPUBufferUsage.COPY_DST});
  const g0 = device.createBindGroup({layout: g0Layout, entries: [{binding: 0, resource: {buffer: viewBuf}}]});
  const g1 = device.createBindGroup({layout: g1Layout, entries: []});

  // DummyTextures analog (render.rs:85-241): 1x1 whites wherever a system
  // has no real texture; real assets are decoded and bound per flag bits
  // (`prepare_firework_bindgroup`, render.rs:587-675).
  const white = device.createTexture({size: [1, 1], format: "rgba8unorm",
    usage: GPUTextureUsage.TEXTURE_BINDING | GPUTextureUsage.COPY_DST});
  device.queue.writeTexture({texture: white}, new Uint8Array([255,255,255,255]), {bytesPerRow: 4}, [1,1]);
  const samp = device.createSampler({magFilter: "linear", minFilter: "linear"});

  // decode embedded PNG assets; base color is sRGB, normal/ORM linear
  const texViews = new Map();  // path -> GPUTextureView
  async function loadAsset(path, srgb) {
    const res = await fetch("data:image/png;base64," + ASSETS[path]);
    const bmp = await createImageBitmap(await res.blob(), {colorSpaceConversion: "none"});
    const tex = device.createTexture({size: [bmp.width, bmp.height],
      format: srgb ? "rgba8unorm-srgb" : "rgba8unorm",
      usage: GPUTextureUsage.TEXTURE_BINDING | GPUTextureUsage.COPY_DST | GPUTextureUsage.RENDER_ATTACHMENT});
    device.queue.copyExternalImageToTexture({source: bmp}, {texture: tex}, [bmp.width, bmp.height]);
    texViews.set(path, tex.createView());
  }

  const bytes = decodeFrames();
  // stable per-(spawner x type) metadata: uniform/textures are constant,
  // the instance buffer is sized to the max count across frames
  const sysMeta = new Map();
  for (const f of bytes) for (const s of f) {
    const m = sysMeta.get(s.key);
    if (m) m.max = Math.max(m.max, s.count);
    else sysMeta.set(s.key, {max: s.count, uniform: s.uniform, textures: s.textures,
                             ribbon: s.ribbon});
  }
  const loads = [];
  for (const m of sysMeta.values())
    m.textures.forEach((p, slot) => {
      if (p && !texViews.has(p)) { texViews.set(p, null); loads.push(loadAsset(p, slot === 0)); }
    });
  await Promise.all(loads);

  const systems = new Map();
  for (const [key, m] of sysMeta) {
    const ubuf = device.createBuffer({size: 48, usage: GPUBufferUsage.UNIFORM | GPUBufferUsage.COPY_DST});
    device.queue.writeBuffer(ubuf, 0, m.uniform);
    const sys = {ubuf, textures: m.textures, ribbon: m.ribbon,
      uniformBytes: m.uniform,  // host copy: the shadow pass gates on pbr
      ibuf: device.createBuffer({size: Math.max(1, m.max) * 64,
        usage: GPUBufferUsage.VERTEX | GPUBufferUsage.COPY_DST})};
    if (m.ribbon)  // prepass-independent: build once
      sys.g2 = device.createBindGroup({layout: rg2Layout,
        entries: [{binding: 0, resource: {buffer: ubuf}}]});
    systems.set(key, sys);
  }

  let prepassDepth = null, mainDepth = null, depthW = 0, depthH = 0;
  function ensureTargets(w, h) {
    if (w === depthW && h === depthH) return;
    depthW = w; depthH = h;
    const mk = extra => device.createTexture({size: [w, h], format: "depth32float",
      usage: GPUTextureUsage.RENDER_ATTACHMENT | extra});
    prepassDepth = mk(GPUTextureUsage.TEXTURE_BINDING);
    mainDepth = mk(0);
    // bind group 2 depends on the (resized) prepass depth texture
    for (const sys of systems.values()) {
      if (sys.ribbon) continue;  // ribbon g2 has no prepass dependency
      const real = slot => {
        const p = sys.textures[slot];
        return (p && texViews.get(p)) || white.createView();
      };
      const g2e = [
        {binding: 0, resource: {buffer: sys.ubuf}},
        {binding: 1, resource: prepassDepth.createView()},
        {binding: 2, resource: real(0)}, {binding: 3, resource: samp},
        {binding: 4, resource: real(1)}, {binding: 5, resource: samp},
        {binding: 6, resource: real(2)}, {binding: 7, resource: samp},
        {binding: 8, resource: {buffer: shadowUniBuf}},   // SHADOW_MAP def:
        {binding: 9, resource: shadowDepthView},          // pbr_shade samples
        {binding: 10, resource: compSamp},                // the light-view map
      ];
      if (fogUniBuf) g2e.push({binding: 11, resource: {buffer: fogUniBuf}});
      if (lightsUniBuf) g2e.push({binding: 12, resource: {buffer: lightsUniBuf}});
      if (atlasUniBuf) {
        g2e.push({binding: 13, resource: {buffer: atlasUniBuf}});
        g2e.push({binding: 14, resource: atlasView});
        g2e.push({binding: 15, resource: compSamp});
      }
      sys.g2 = device.createBindGroup({layout: g2Layout, entries: g2e});
    }
  }

  let fi = 0, t = 0;
  function draw() {
    const w = cv.width = innerWidth, h = cv.height = innerHeight;
    ensureTargets(w, h);
    t += 0.004;
    const eye = [9*Math.sin(t), 3.2, 9*Math.cos(t)];
    const {view, inv} = lookAt(eye, [0, 1.2, 0]);
    const vp = mat4mul(perspRevZ(0.9, w/h, 0.1), view);
    const vu = new Float32Array(36);
    vu.set(vp, 0); vu.set(inv, 16); vu.set(eye, 32);
    device.queue.writeBuffer(viewBuf, 0, vu);

    // upload this frame's instance buffers once; all passes read them
    let live = 0, ribbons = 0;
    for (const s of bytes[fi]) {
      if (!s.count) continue;
      device.queue.writeBuffer(systems.get(s.key).ibuf, 0, s.buf, 0, s.count * 64);  // render.rs:568-584
      if (s.ribbon) ribbons += s.count; else live += s.count;
    }
    const enc = device.createCommandEncoder();
    // 0a) shadow ATLAS passes: each shadow light's tile depth-rendered from
    // its own view (SHADOW_ATLAS variant; per-light maps)
    if (atlasView) {
      const g = DESC.shadow_atlas_grid;
      const pA = enc.beginRenderPass({colorAttachments: [], depthStencilAttachment: {
        view: atlasView, depthClearValue: 1, depthLoadOp: "clear", depthStoreOp: "store"}});
      pA.setPipeline(casterPipeline);
      for (const at of atlasTiles) {
        pA.setViewport((at.tile % g) * ATLAS_TILE, Math.floor(at.tile / g) * ATLAS_TILE,
                       ATLAS_TILE, ATLAS_TILE, 0, 1);
        pA.setBindGroup(0, device.createBindGroup({layout: svLayout,
          entries: [{binding: 0, resource: {buffer: at.buf}}]}));
        for (const s of bytes[fi]) {
          if (!s.count || s.ribbon) continue;
          const sys = systems.get(s.key);
          if (new DataView(sys.uniformBytes.buffer, sys.uniformBytes.byteOffset).getUint32(4, true) !== 1) continue;
          pA.setVertexBuffer(0, sys.ibuf);
          pA.draw(6, s.count);
        }
      }
      pA.end();
    }
    // 0) shadow pass: PBR casters depth-rendered from the light's view
    const p0 = enc.beginRenderPass({colorAttachments: [], depthStencilAttachment: {
      view: shadowDepthView, depthClearValue: 1, depthLoadOp: "clear", depthStoreOp: "store"}});
    p0.setPipeline(casterPipeline); p0.setBindGroup(0, svGroup);
    for (const s of bytes[fi]) {
      if (!s.count || s.ribbon) continue;
      const sys = systems.get(s.key);
      // alpha-blended smoke shouldn't stamp solid discs: only PBR systems
      // cast (uniform word 1 = pbr flag)
      if (new DataView(sys.uniformBytes.buffer, sys.uniformBytes.byteOffset).getUint32(4, true) !== 1) continue;
      p0.setVertexBuffer(0, sys.ibuf);
      p0.draw(6, s.count);
    }
    p0.end();
    // 1) depth prepass (what Bevy's prepass provides the reference shader)
    const p1 = enc.beginRenderPass({colorAttachments: [], depthStencilAttachment: {
      view: prepassDepth.createView(), depthClearValue: 0, depthLoadOp: "clear", depthStoreOp: "store"}});
    p1.setPipeline(prepassPipeline); p1.setBindGroup(0, g0);
    p1.setVertexBuffer(0, groundBuf); p1.draw(6); p1.end();
    // 2) main pass: opaque ground (shadow-receiving), then one instanced
    //    draw per system
    const p2 = enc.beginRenderPass({
      colorAttachments: [{view: ctx.getCurrentTexture().createView({format: targetFormat}),
        clearValue: {r: 0.016, g: 0.02, b: 0.03, a: 1}, loadOp: "clear", storeOp: "store"}],
      depthStencilAttachment: {view: mainDepth.createView(),
        depthClearValue: 0, depthLoadOp: "clear", depthStoreOp: "store"}});
    p2.setPipeline(groundPipeline); p2.setBindGroup(0, g0); p2.setBindGroup(1, gShadowGroup);
    p2.setVertexBuffer(0, groundBuf); p2.draw(6);
    p2.setBindGroup(0, g0); p2.setBindGroup(1, g1);
    for (const s of bytes[fi]) {
      if (!s.count) continue;
      const sys = systems.get(s.key);
      p2.setPipeline(s.ribbon ? ribbonPipeline : particlePipeline);
      p2.setBindGroup(2, sys.g2);
      p2.setVertexBuffer(0, sys.ibuf);
      p2.draw(6, s.count);  // render.rs:926 (ribbons: 6 verts x segments)
    }
    p2.end();
    device.queue.submit([enc.finish()]);
    hud.textContent = `shipped particles.wgsl [${DESC.shader_defs.join(", ")}] executing on WebGPU\n` +
      `frame ${fi+1}/${bytes.length} — ${live} instances` +
      (ribbons ? ` + ${ribbons} ribbon segments (ribbons.wgsl)` : ``) +
      ` — 1 draw/system — target ${targetFormat}`;
    fi = (fi + 1) % bytes.length;
    requestAnimationFrame(draw);
  }
  draw();
}
main().catch(e => { hud.textContent = "error: " + e.message; });
</script></body></html>
"""

os.makedirs(args.out, exist_ok=True)
out = os.path.join(args.out, "webgpu_viewer.html")
with open(out, "w") as f:
    f.write(
        HTML.replace("__DESC__", json.dumps(desc))
        .replace("__FRAMES__", json.dumps(frames))
        .replace("__ASSETS__", json.dumps(assets))
        .replace("__RIBBON__", json.dumps(
            ribbons_wgsl_source() if any(s.get("ribbon") for f in frames for s in f) else None))
    )
total = sum(s["count"] for s in frames[-1])
print(
    f"wrote {out} ({args.frames} frames, {len(frames[-1])} system(s), "
    f"{total} instances in last frame, shader defs {list(variant.shader_defs)})"
)
