"""Render-contract consumer demo: export simulated frames to a standalone
WebGL2 page that draws them as instanced billboards.

This closes the loop the reference closes with its GPU pipeline: the page
binds the EXACT 64-byte `ParticleInstance` records this engine emits
(`render.instances_to_bytes`, mirroring bevy_firework `src/render.rs:95-115`
and the vertex layout at `:737-766`) as an instanced vertex buffer — one draw
call per particle system per frame (`render.rs:926`) — and implements the
reference's billboard semantics (bevy_firework `src/particles.wgsl:86-121`):
camera-facing quad corners +-0.5 scaled by `scale`, particle rotation
contributing only its twist about the view axis, radial edge fade
(`particles.wgsl:140-147`), and the Blend/Premultiplied/Additive/Multiply
alpha modes (`src/core.rs:57-97`). Unlit path only (the PBR/scene-depth path
needs a full engine; `viewer.py` covers it in software).

Runs the scene on the card (`--cpu`: on the CPU, the kernels' plain
versions); the page is the JAX package's example's, character for
character but its citation of the reference's source, by project name.

Usage: python examples_torch/web_viewer.py [--cpu] [--scene sparks] [--frames 90] [--out DIR]
Writes web_viewer.html under --out (examples_torch/out/) — open in any
browser, no server needed.
"""

import argparse
import base64
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _common_torch import add_device_args, device_of  # noqa: E402

parser = argparse.ArgumentParser()
parser.add_argument("--scene", default="sparks", choices=["sparks", "fireworks", "explosion", "snow"])
parser.add_argument("--frames", type=int, default=90)
parser.add_argument("--warmup", type=int, default=45)
add_device_args(parser)
args = parser.parse_args()
device = device_of(args)

from bevy_firework_tpu_torch import Scene, instances_to_bytes  # noqa: E402
from bevy_firework_tpu_torch.models import effects, library  # noqa: E402


def build_scene():
    scene = Scene(seed=3, device=device)
    if args.scene == "sparks":
        sp, tf = effects.sparks()
        scene.add_spawner(sp, capacity=2048, transform=tf)
    elif args.scene == "fireworks":
        sp, tf = effects.fireworks()
        scene.add_spawner(sp, transform=tf)
    elif args.scene == "explosion":
        scene.add_spawner(library.explosion())
    else:
        scene.add_spawner(library.snow())
    return scene


scene = build_scene()
dt = 1.0 / 60.0
for _ in range(args.warmup):
    scene.step(dt)

frames = []
uniforms = []
for _ in range(args.frames):
    scene.step(dt)
    items = scene.render_items()
    fi = []
    for item in items:
        # THE contract bytes: 16 f32 = 64 B per particle (render.rs:95-115)
        raw = instances_to_bytes(item.instances)
        fi.append(
            {
                "count": int(item.count),
                "alpha_mode": item.uniform.alpha_mode,
                "fade_edge": item.uniform.fade_edge,
                "data": base64.b64encode(raw).decode(),
            }
        )
    frames.append(fi)

html = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>bevy_firework_tpu - WebGL contract viewer</title>
<style>html,body{margin:0;background:#0b0e13;color:#9aa4b2;font:12px monospace;overflow:hidden}
#hud{position:fixed;left:10px;top:8px;user-select:none}</style></head>
<body><canvas id="c"></canvas><div id="hud"></div>
<script>
"use strict";
const FRAMES = __FRAMES__;
const cv = document.getElementById("c");
const gl = cv.getContext("webgl2", {alpha:false, antialias:true});
if (!gl) {
  document.getElementById("hud").textContent = "WebGL2 unavailable";
  throw new Error("WebGL2 unavailable");  // stop setup; HUD message stays
}
const VS = `#version 300 es
// Billboard semantics of bevy_firework src/particles.wgsl:86-121 (original
// implementation): view-space quad corner +-0.5 * scale, plus only the TWIST
// component (about the view axis) of the particle rotation (:301-325).
layout(location=0) in vec2 corner;     // per-vertex quad corner
layout(location=1) in vec4 pos_scale;  // instance: pos.xyz, scale
layout(location=2) in vec4 rot;        // instance: quat xyzw
layout(location=3) in vec4 base_color; // instance
layout(location=4) in vec4 emis_color; // instance
uniform mat4 u_view, u_proj;
out vec2 v_uv; out vec4 v_base; out vec4 v_emis;
vec3 qrot(vec4 q, vec3 v){ return v + 2.0*cross(q.xyz, cross(q.xyz, v) + q.w*v); }
void main(){
  vec3 center = pos_scale.xyz; float scale = pos_scale.w;
  vec3 view_dir = normalize((inverse(u_view) * vec4(0.,0.,-1.,0.)).xyz);
  // swing-twist: twist = normalize(projection of q onto (1, view_dir))
  float d = dot(rot.xyz, view_dir);
  vec4 twist = vec4(d * view_dir, rot.w);
  float n = length(twist);
  twist = n > 1e-6 ? twist / n : vec4(0.,0.,0.,1.);
  mat4 inv_view = inverse(u_view);
  vec3 right = inv_view[0].xyz, up = inv_view[1].xyz;
  vec3 offset = (right * corner.x + up * corner.y) * scale;
  vec3 world = center + qrot(twist, offset);
  v_uv = corner + vec2(0.5);
  v_base = base_color; v_emis = emis_color;
  gl_Position = u_proj * u_view * vec4(world, 1.0);
}`;
const FS = `#version 300 es
precision highp float;
in vec2 v_uv; in vec4 v_base; in vec4 v_emis;
uniform float u_fade_edge; uniform int u_alpha_mode;
out vec4 frag;
void main(){
  // edge fade (reference particles.wgsl:140-147): alpha *=
  // smoothstep(0, fade_edge, 1 - dist), i.e. the ramp spans
  // dist in [1 - fade_edge, 1] — written via the symmetry
  // smoothstep(0,f,1-d) == 1 - smoothstep(1-f,1,d).
  float dist = length(v_uv - vec2(0.5)) * 2.0;
  float fade = u_fade_edge > 0.0 ? 1.0 - smoothstep(1.0 - u_fade_edge, 1.0, dist) : 1.0;
  // unlit path: base color only (reference particles.wgsl:162-163);
  // emissive participates only in PBR, which this WebGL2 demo omits.
  vec4 c = vec4(v_base.rgb, v_base.a * fade);
  if (c.a <= 0.0) discard;
  if (u_alpha_mode == 4) c = vec4(c.rgb * c.a, c.a);   // additive: premul rgb
  frag = c;
}`;
function sh(type, src){ const s = gl.createShader(type); gl.shaderSource(s, src);
  gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS)) throw gl.getShaderInfoLog(s);
  return s; }
const prog = gl.createProgram();
gl.attachShader(prog, sh(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, sh(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog);
if (!gl.getProgramParameter(prog, gl.LINK_STATUS)) throw gl.getProgramInfoLog(prog);
gl.useProgram(prog);
const U = n => gl.getUniformLocation(prog, n);

// static quad (2 triangles, corners +-0.5) - DrawFirework draws 6 verts/instance
const quad = new Float32Array([-.5,-.5, .5,-.5, .5,.5, -.5,-.5, .5,.5, -.5,.5]);
const qbuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, qbuf); gl.bufferData(gl.ARRAY_BUFFER, quad, gl.STATIC_DRAW);
// instance buffer: re-uploaded per frame per system, exactly like
// prepare_instance_buffers (render.rs:568-584)
const ibuf = gl.createBuffer();
const vao = gl.createVertexArray();
gl.bindVertexArray(vao);
gl.bindBuffer(gl.ARRAY_BUFFER, qbuf);
gl.enableVertexAttribArray(0); gl.vertexAttribPointer(0, 2, gl.FLOAT, false, 8, 0);
gl.bindBuffer(gl.ARRAY_BUFFER, ibuf);
// 64-byte stride, offsets per render.rs:737-766 (locations 3..6 there)
[[1,0],[2,16],[3,32],[4,48]].forEach(([loc, off]) => {
  gl.enableVertexAttribArray(loc);
  gl.vertexAttribPointer(loc, 4, gl.FLOAT, false, 64, off);
  gl.vertexAttribDivisor(loc, 1);
});

const bytes = FRAMES.map(f => f.map(s => {
  const bin = atob(s.data); const a = new Uint8Array(bin.length);
  for (let i = 0; i < bin.length; i++) a[i] = bin.charCodeAt(i);
  return {count: s.count, alpha: s.alpha_mode, fade: s.fade_edge, buf: a};
}));

function persp(fov, aspect, near, far){
  const f = 1/Math.tan(fov/2);
  return new Float32Array([f/aspect,0,0,0, 0,f,0,0, 0,0,(far+near)/(near-far),-1, 0,0,2*far*near/(near-far),0]);
}
function lookAt(eye, at){
  const up=[0,1,0];
  let z=[eye[0]-at[0],eye[1]-at[1],eye[2]-at[2]]; const zl=Math.hypot(...z); z=z.map(v=>v/zl);
  let x=[up[1]*z[2]-up[2]*z[1], up[2]*z[0]-up[0]*z[2], up[0]*z[1]-up[1]*z[0]];
  const xl=Math.hypot(...x); x=x.map(v=>v/xl);
  const y=[z[1]*x[2]-z[2]*x[1], z[2]*x[0]-z[0]*x[2], z[0]*x[1]-z[1]*x[0]];
  return new Float32Array([x[0],y[0],z[0],0, x[1],y[1],z[1],0, x[2],y[2],z[2],0,
    -(x[0]*eye[0]+x[1]*eye[1]+x[2]*eye[2]), -(y[0]*eye[0]+y[1]*eye[1]+y[2]*eye[2]),
    -(z[0]*eye[0]+z[1]*eye[1]+z[2]*eye[2]), 1]);
}

let fi = 0, t = 0;
function draw(){
  const w = cv.width = innerWidth, h = cv.height = innerHeight;
  gl.viewport(0, 0, w, h);
  gl.clearColor(0.043, 0.055, 0.075, 1); gl.clear(gl.COLOR_BUFFER_BIT);
  gl.enable(gl.BLEND);
  t += 0.004;
  const eye = [6*Math.sin(t), 2.5, 6*Math.cos(t)];
  gl.uniformMatrix4fv(U("u_view"), false, lookAt(eye, [0,1,0]));
  gl.uniformMatrix4fv(U("u_proj"), false, persp(0.9, w/h, 0.1, 100));
  const systems = bytes[fi];
  let live = 0;
  for (const s of systems){
    if (!s.count) continue;
    live += s.count;
    // Blend2 / Premultiplied3 / Add4 / Multiply5 (core.rs:87-97)
    if (s.alpha === 4) gl.blendFunc(gl.ONE, gl.ONE);
    else if (s.alpha === 3) gl.blendFunc(gl.ONE, gl.ONE_MINUS_SRC_ALPHA);
    else if (s.alpha === 5) gl.blendFunc(gl.DST_COLOR, gl.ZERO);
    else gl.blendFunc(gl.SRC_ALPHA, gl.ONE_MINUS_SRC_ALPHA);
    gl.uniform1f(U("u_fade_edge"), s.fade);
    gl.uniform1i(U("u_alpha_mode"), s.alpha);
    gl.bindBuffer(gl.ARRAY_BUFFER, ibuf);
    gl.bufferData(gl.ARRAY_BUFFER, s.buf, gl.DYNAMIC_DRAW);
    gl.drawArraysInstanced(gl.TRIANGLES, 0, 6, s.count);  // render.rs:926
  }
  document.getElementById("hud").textContent =
    `bevy_firework_tpu render contract - frame ${fi+1}/${bytes.length} - ${live} instances - 1 draw/system`;
  fi = (fi + 1) % bytes.length;
  requestAnimationFrame(draw);
}
if (gl) draw();
</script></body></html>
"""

os.makedirs(args.out, exist_ok=True)
out = os.path.join(args.out, "web_viewer.html")
with open(out, "w") as f:
    f.write(html.replace("__FRAMES__", json.dumps(frames)))
total = sum(s["count"] for s in frames[-1])
print(f"wrote {out} ({args.frames} frames, {len(frames[-1])} system(s), {total} instances in last frame)")
