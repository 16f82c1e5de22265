// Fused particle step for NVIDIA Hopper (sm_90a): emission cadence, ring
// claim, spawn init from Philox, age cull, scale curve, move + linear drag,
// quaternion + angular drag, and optionally the f32 render pack, for U <= 8
// frames per launch.
//
// Replaces: bevy_firework_tpu/ops/fused_step.py `_make_kernel` (:913) as run
// by `_run_fused_kernel` (:1793) in the main-path configuration
// (kernel_spawn, ring_claim, derived_alive; no colliders, force fields,
// dump, fleet, shard or nested blocks), including its render-pack block
// (:1523-1561, f32 mode).
//
// Design:
//  * One thread per lane, grid-stride over N; any N (the TPU's 8192-lane
//    granule was a Mosaic tiling constraint). A lane's active fields stay
//    in registers across the U sub-frames; the pool is read and written once
//    per launch.
//  * Blocks run concurrently, so nothing carries across them. The
//    per-emitter cadence is scalar math whose values are the same for every
//    block: thread 0 of each block recomputes it for all U sub-frames into
//    shared memory (as every TPU tile recomputes it in SMEM). Scalar state is
//    read from the *_in buffers and written once, by block 0 thread 0, to
//    distinct *_out buffers, so no block can read a value already advanced.
//  * Claims: lane g is claimed in sub-frame u when dead and its ring rank
//    ((g - cursor_u) mod N, non-negative) is below the sub-frame's total
//    spawn count; the emitter is the one whose cumulative window holds the
//    rank. No prefix scan exists on this path.
//  * Randomness: Philox-4x32-10, key (seed_u, 0), counter (g, block, 0, 0),
//    uniforms from the top 24 bits, draw order shape 0-2, velocity 3-5,
//    radial 6, scale 7, then lifetime, then angular velocity. The torch
//    version in bevy_firework_tpu_torch/prng.py gives the same bits.
//  * Spawner structure (emitter/type counts, pacing kinds, curve kinds and
//    knot counts, elision flags) and all parameters come from one small
//    device table read at run time; branches on it are warp-uniform. The
//    table's layout, the field slots, the frame row and the kind
//    enumerations are defined once, in ops/table_layout.py; the build
//    generates "table_layout.h" from it, so this file states none of them.
//
// FMA policy: built with -fmad=false and without fast math, so every
// multiply and add rounds on its own, divisions and sqrtf are IEEE, and the
// op order below is the op order of the plain version (step.py). The cadence
// carry, the move and the drag lines then agree bit for bit with it; only
// libm's sinf/cosf may differ from PyTorch's by an ulp or two.
//
// Bound on this card: memory traffic. A U-frame launch reads and writes each
// active field once (8 f32 planes for the stress_test archetype: 64 B per
// lane, about 8 MB at N = 131072, ~2.5 us at 3.35 TB/s), plus 36 B per lane
// when the render pack is on. Arithmetic per lane-frame is a few dozen
// flops outside spawn lanes; spawn lanes add three Philox blocks and the
// samplers' sinf/cosf. At the main-path sizes a launch is short enough that
// launch latency, not bandwidth, dominates; U frames per launch amortise it.

#include <cuda_runtime.h>
#include <stdint.h>

// MAX_*, N_FIELDS, N_RENDER, the field slots PX .. LIFETIME, the frame row
// FR_*, the table's H_* header words and EM_* / TY_* / CV_* rows and slots,
// and the PACING_* / CURVE_* / SHAPE_* kinds (generated, see above)
#include "table_layout.h"

namespace {

struct Args {
  const float* in[N_FIELDS];
  float* out[N_FIELDS];
  const int* ptype_in;
  int* ptype_out;
  const float* tic_in;
  const float* last_in;
  const uint8_t* en_in;
  const int* mq_in;
  const int* cursor_in;
  float* tic_out;
  float* last_out;
  uint8_t* en_out;
  int* mq_out;
  int* cursor_out;
  float* render[N_RENDER];
  float frame[FRAME_WORDS];  // FR_* slots
  uint32_t seeds[MAX_U];
  int unroll;
  int n;
  int pack_render;
};

__device__ __forceinline__ float tabf(const int* tab, int i) { return __int_as_float(__ldg(tab + i)); }
__device__ __forceinline__ int tabi(const int* tab, int i) { return __ldg(tab + i); }

// NaN-propagating min/max/clamp, as torch.maximum / torch.clamp.
__device__ __forceinline__ float pmax(float a, float b) { return (a != a || b != b) ? a + b : (a > b ? a : b); }
__device__ __forceinline__ float pmin(float a, float b) { return (a != a || b != b) ? a + b : (a < b ? a : b); }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  float y = x < lo ? lo : x;
  return y > hi ? hi : y;
}

// ---- Rust float semantics (utils/f32.py) ----
__device__ __forceinline__ float trunc_rem(float a, float b) { return a - truncf(a / b) * b; }
__device__ __forceinline__ float rem_euclid(float a, float b) {
  float r = trunc_rem(a, b);
  return r < 0.0f ? r + fabsf(b) : r;
}
__device__ __forceinline__ float div_euclid(float a, float b) {
  float q = truncf(a / b);
  float r = trunc_rem(a, b);
  float adj = b > 0.0f ? q - 1.0f : q + 1.0f;
  return r < 0.0f ? adj : q;
}

// cadence.compute_emission_count
__device__ void emission_count(float t, float last, float dur, float off_s, float off_e, float per_cycle,
                               int* count, float* next_last) {
  float percent_passed = t / dur;
  float last_pct = last / dur;
  float clamped_last = pmax(last_pct, off_s);
  float since = pmin(percent_passed, off_e) - clamped_last;
  float between = (off_e - off_s) / per_cycle;
  float times = div_euclid(since, between);
  *count = (int)pmax(times, 0.0f);
  *next_last = (clamped_last + times * between) * dur;
}

// ---- Philox-4x32-10 ----
__device__ __forceinline__ void philox(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

__device__ __forceinline__ float u01(uint32_t bits) { return (float)(bits >> 8) * 5.9604644775390625e-08f; }

// ---- quaternion helpers (utils/quat.py op order) ----
__device__ __forceinline__ void quat_rotate(float qx, float qy, float qz, float qw, float vx, float vy, float vz,
                                            float* ox, float* oy, float* oz) {
  float tx = 2.0f * (qy * vz - qz * vy);
  float ty = 2.0f * (qz * vx - qx * vz);
  float tz = 2.0f * (qx * vy - qy * vx);
  *ox = vx + qw * tx + (qy * tz - qz * ty);
  *oy = vy + qw * ty + (qz * tx - qx * tz);
  *oz = vz + qw * tz + (qx * ty - qy * tx);
}

constexpr float TWO_PI = 6.2831854820251465f;  // float32(2*pi)
constexpr float PI_F = 3.1415927410125732f;    // float32(pi)

// emission_shape.sample_shape_comp on one compiled shape row (kind,
// radius, quat xyzw, half extents y z: EmissionShape.compile)
__device__ void shape_point(const int* tab, int row, float u0, float u1, float u2, float* ox, float* oy,
                            float* oz) {
  float kind = tabf(tab, row + 0), radius = tabf(tab, row + 1);
  float u = u0 * TWO_PI, v = u1 * PI_F, rr = u2 * radius;
  if (kind == (float)SHAPE_SPHERE) {
    float cu = cosf(u);
    *ox = -sinf(v) * cu * rr;
    *oy = sinf(u) * rr;
    *oz = -cosf(v) * cu * rr;
    return;
  }
  float lx, ly = 0.0f, lz;
  if (kind == (float)SHAPE_CIRCLE) {
    lx = rr * cosf(u);
    lz = -rr * sinf(u);
  } else if (kind == (float)SHAPE_RING) {
    lx = radius * cosf(u);
    lz = -radius * sinf(u);
  } else if (kind == (float)SHAPE_BOX) {
    lx = (u0 * 2.0f - 1.0f) * radius;
    ly = (u1 * 2.0f - 1.0f) * tabf(tab, row + 6);
    lz = (u2 * 2.0f - 1.0f) * tabf(tab, row + 7);
  } else {  // point
    *ox = 0.0f;
    *oy = 0.0f;
    *oz = 0.0f;
    return;
  }
  quat_rotate(tabf(tab, row + 2), tabf(tab, row + 3), tabf(tab, row + 4), tabf(tab, row + 5), lx, ly, lz, ox, oy,
              oz);
}

// rand.sample_randvec3_comp on one compiled row
__device__ void randvec3(const int* tab, int row, float u_mag, float u_dev, float u_azim, float* x, float* y,
                         float* z) {
  float lo = tabf(tab, row), hi = tabf(tab, row + 1);
  float mag = lo + (hi - lo) * u_mag;
  float a = u_dev * tabf(tab, row + 2);
  float b = u_azim * TWO_PI;
  float sa = sinf(a), ca = cosf(a);
  float lx = sa * cosf(b), ly = ca, lz = -sa * sinf(b);
  float dx, dy, dz;
  quat_rotate(tabf(tab, row + 3), tabf(tab, row + 4), tabf(tab, row + 5), tabf(tab, row + 6), lx, ly, lz, &dx, &dy,
              &dz);
  *x = mag * dx;
  *y = mag * dy;
  *z = mag * dz;
}

// curve.eval_*_static: segment index (as the selects of the plain version:
// default 0, NaN-safe) and fraction for a (kind, n) curve with knots ts.
__device__ void curve_segment(const int* tab, int ts_row, int kind, int n, float t, int* seg, float* frac) {
  if (kind == CURVE_EVEN) {
    float x = clampf(t, 0.0f, 1.0f) * (float)(n - 1);
    float i = clampf(floorf(x), 0.0f, (float)(n - 2));
    *frac = x - i;
    int s = 0;
    for (int k = 1; k < n - 1; ++k)
      if (i == (float)k) s = k;
    *seg = s;
    return;
  }
  float tun = clampf(t, tabf(tab, ts_row), tabf(tab, ts_row + n - 1));
  float i = 0.0f;
  for (int k = 1; k < n - 1; ++k) i = i + (tun >= tabf(tab, ts_row + k) ? 1.0f : 0.0f);
  int s = 0;
  for (int k = 1; k < n - 1; ++k)
    if (i == (float)k) s = k;
  *seg = s;
  float t0 = tabf(tab, ts_row + s), t1 = tabf(tab, ts_row + s + 1);
  *frac = (tun - t0) / (t1 - t0);
}

__device__ __forceinline__ float curve_lerp(const int* tab, int vs_row, int seg, float frac) {
  float v0 = tabf(tab, vs_row + seg), v1 = tabf(tab, vs_row + seg + 1);
  return v0 + (v1 - v0) * frac;
}

__device__ float eval_curve(const int* tab, int ts_row, int vs_row, int kind, int n, float t) {
  if (kind == CURVE_CONSTANT) return tabf(tab, vs_row);
  int seg;
  float frac;
  curve_segment(tab, ts_row, kind, n, t, &seg, &frac);
  return curve_lerp(tab, vs_row, seg, frac);
}

__device__ void eval_gradient(const int* tab, int ts_row, int kind, int n, float t, float out[4]) {
  // channel c's values sit in the row after ts (ts_row + (1 + c) * MAX_K)
  if (kind == CURVE_CONSTANT) {
    for (int c = 0; c < 4; ++c) out[c] = tabf(tab, ts_row + (1 + c) * MAX_K);
    return;
  }
  int seg;
  float frac;
  curve_segment(tab, ts_row, kind, n, t, &seg, &frac);
  for (int c = 0; c < 4; ++c) out[c] = curve_lerp(tab, ts_row + (1 + c) * MAX_K, seg, frac);
}

__global__ void __launch_bounds__(256) fused_step_kernel(const int* __restrict__ tab, Args a) {
  __shared__ int s_cursor[MAX_U];
  __shared__ int s_bounds[MAX_U][MAX_E + 1];

  const int E = tabi(tab, H_E);
  const int n = a.n;
  const float dt = a.frame[FR_DT];

  if (threadIdx.x == 0) {
    // per-emitter cadence for every sub-frame (reference core.rs:395-427)
    float tic[MAX_E], last[MAX_E];
    bool en[MAX_E];
    for (int e = 0; e < E; ++e) {
      tic[e] = a.tic_in[e];
      last[e] = a.last_in[e];
      en[e] = a.en_in[e] != 0;
    }
    int mq = *a.mq_in;
    int cursor = *a.cursor_in;
    for (int u = 0; u < a.unroll; ++u) {
      bool active = false;
      for (int e = 0; e < E; ++e) active = active || en[e];
      s_cursor[u] = cursor;
      int bound = 0;
      s_bounds[u][0] = 0;
      for (int e = 0; e < E; ++e) {
        const int row = EM_AT + e * EM_STRIDE;
        bool gate = active && en[e];
        int pk = tabi(tab, H_PACING + e);
        int n_sp;
        if (pk == PACING_ONE_SHOT) {
          n_sp = gate ? (int)tabf(tab, row + EM_COUNT) : 0;
          en[e] = en[e] && !gate;
        } else if (pk == PACING_ON_DEMAND) {
          n_sp = gate ? mq : 0;
          if (gate) mq = 0;
        } else {  // PACING_RATE
          const float dur = tabf(tab, row + EM_DURATION);
          float t = rem_euclid(tic[e] + dt, dur);
          int cnt;
          float next_last;
          emission_count(t, last[e], dur, tabf(tab, row + EM_OFF_START), tabf(tab, row + EM_OFF_END),
                         tabf(tab, row + EM_COUNT), &cnt, &next_last);
          n_sp = gate ? cnt : 0;
          if (gate) {
            tic[e] = t;
            last[e] = next_last;
          }
        }
        bound += n_sp;
        s_bounds[u][e + 1] = bound;
      }
      long long c = ((long long)cursor + bound) % n;
      cursor = (int)(c < 0 ? c + n : c);
    }
    if (blockIdx.x == 0) {
      for (int e = 0; e < E; ++e) {
        a.tic_out[e] = tic[e];
        a.last_out[e] = last[e];
        a.en_out[e] = en[e] ? 1 : 0;
      }
      *a.mq_out = mq;
      *a.cursor_out = cursor;
    }
  }
  __syncthreads();

  const bool single = tabi(tab, H_SINGLE) != 0;
  const bool elide_rot = tabi(tab, H_ELIDE_ROT) != 0;
  const bool const_life = tabi(tab, H_CONST_LIFE) != 0;
  const float life_c = tabf(tab, H_CONST_LIFE_VAL);
  const float mod_scale = a.frame[FR_MOD_SCALE], mod_speed = a.frame[FR_MOD_SPEED];
  const float* pvel = a.frame + FR_PVEL;
  const float* trans = a.frame + FR_TRANS;
  const float* orot = a.frame + FR_ROT;

  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < n; g += gridDim.x * blockDim.x) {
    float f[N_FIELDS];
    for (int i = 0; i < N_FIELDS; ++i) f[i] = a.in[i] ? a.in[i][g] : 0.0f;
    if (elide_rot) f[QW] = 1.0f;
    int ty = single ? 0 : a.ptype_in[g];
    float age_pct = 0.0f, scale_new = 0.0f;
    bool survivor = false;

    for (int u = 0; u < a.unroll; ++u) {
      float life = const_life ? life_c : f[LIFETIME];
      bool alive0 = f[AGE] < life;
      bool spawned = false;
      const int total = s_bounds[u][E];
      if (!alive0 && total > 0) {
        int rank = g - s_cursor[u];
        if (rank < 0) rank += n;
        if (rank < total) {
          spawned = true;
          int e = 0;
          while (!(rank >= s_bounds[u][e] && rank < s_bounds[u][e + 1])) ++e;
          // ---- spawn init (fused_step.py spawn_block) ----
          uint32_t c0[4] = {(uint32_t)g, 0u, 0u, 0u}, c1[4] = {(uint32_t)g, 1u, 0u, 0u},
                   c2[4] = {(uint32_t)g, 2u, 0u, 0u};
          philox(c0, a.seeds[u], 0u);
          philox(c1, a.seeds[u], 0u);
          float uu[12];
          for (int i = 0; i < 4; ++i) {
            uu[i] = u01(c0[i]);
            uu[4 + i] = u01(c1[i]);
          }
          if (!const_life || !elide_rot) {
            philox(c2, a.seeds[u], 0u);
            for (int i = 0; i < 4; ++i) uu[8 + i] = u01(c2[i]);
          }
          const int row = EM_AT + e * EM_STRIDE;
          float offx, offy, offz, ivx, ivy, ivz;
          shape_point(tab, row + EM_SHAPE, uu[0], uu[1], uu[2], &offx, &offy, &offz);
          randvec3(tab, row + EM_IVEL, uu[3], uu[4], uu[5], &ivx, &ivy, &ivz);
          float rlo = tabf(tab, row + EM_RADIAL_LO), rhi = tabf(tab, row + EM_RADIAL_HI);
          float radial = rlo + (rhi - rlo) * uu[6];
          float l2 = offx * offx + offy * offy + offz * offz;
          float inv = l2 > 0.0f ? 1.0f / sqrtf(l2) : 0.0f;
          float wvx, wvy, wvz;
          quat_rotate(orot[0], orot[1], orot[2], orot[3], ivx, ivy, ivz, &wvx, &wvy, &wvz);
          float inh = tabf(tab, row + EM_INHERIT);
          f[VX] = mod_speed * (wvx + offx * inv * radial) + inh * pvel[0];
          f[VY] = mod_speed * (wvy + offy * inv * radial) + inh * pvel[1];
          f[VZ] = mod_speed * (wvz + offz * inv * radial) + inh * pvel[2];
          f[PX] = trans[0] + offx;
          f[PY] = trans[1] + offy;
          f[PZ] = trans[2] + offz;
          ty = tabi(tab, H_PINDEX + e);
          const int trow = TY_AT + ty * TY_STRIDE;
          float slo = tabf(tab, trow + TY_ISCALE_LO), shi = tabf(tab, trow + TY_ISCALE_HI);
          f[INITIAL_SCALE] = (slo + (shi - slo) * uu[7]) * mod_scale;
          f[AGE] = 0.0f;
          int ui = 8;
          if (!const_life) {
            float llo = tabf(tab, trow + TY_LIFE_LO), lhi = tabf(tab, trow + TY_LIFE_HI);
            f[LIFETIME] = llo + (lhi - llo) * uu[ui];
            ui += 1;
          }
          if (!elide_rot) {
            f[QX] = tabf(tab, row + EM_INIT_ROT + 0);
            f[QY] = tabf(tab, row + EM_INIT_ROT + 1);
            f[QZ] = tabf(tab, row + EM_INIT_ROT + 2);
            f[QW] = tabf(tab, row + EM_INIT_ROT + 3);
            randvec3(tab, row + EM_IANG, uu[ui], uu[ui + 1], uu[ui + 2], &f[WX], &f[WY], &f[WZ]);
          }
        }
      }
      const bool alive_sp = alive0 || spawned;

      // ---- integrate (reference core.rs:594-650) ----
      life = const_life ? life_c : f[LIFETIME];
      const float age_new = f[AGE] + dt;
      const bool dead_by_age = age_new >= life;
      age_pct = age_new / life;
      const int crow = CV_AT + ty * CV_STRIDE;
      scale_new = f[INITIAL_SCALE] * eval_curve(tab, crow + CV_SCALE_TS * MAX_K, crow + CV_SCALE_VS * MAX_K,
                                                tabi(tab, H_SCALE_KIND + ty), tabi(tab, H_SCALE_N + ty), age_pct);
      const bool moved = alive_sp && !dead_by_age;
      survivor = moved;
      const int trow = TY_AT + ty * TY_STRIDE;
      const float lin_drag = tabf(tab, trow + TY_LIN_DRAG);
      const float vx = f[VX], vy = f[VY], vz = f[VZ];
      if (alive_sp) f[AGE] = age_new;
      if (moved) {
        f[PX] = f[PX] + vx * dt;
        f[PY] = f[PY] + vy * dt;
        f[PZ] = f[PZ] + vz * dt;
        f[VX] = vx + (tabf(tab, trow + TY_ACCEL + 0) - vx * lin_drag) * dt;
        f[VY] = vy + (tabf(tab, trow + TY_ACCEL + 1) - vy * lin_drag) * dt;
        f[VZ] = vz + (tabf(tab, trow + TY_ACCEL + 2) - vz * lin_drag) * dt;
      }
      if (!elide_rot && survivor) {
        const float ang_drag = tabf(tab, trow + TY_ANG_DRAG);
        const float wx = f[WX], wy = f[WY], wz = f[WZ];
        const float sx = wx * dt, sy = wy * dt, sz = wz * dt;
        const float angle = sqrtf(sx * sx + sy * sy + sz * sz);
        const float safe = angle < 1e-12f ? 1e-12f : angle;  // NaN passes, as torch.clamp_min
        const float half = 0.5f * angle;
        const bool small = angle < 1e-8f;
        const float s = small ? 0.0f : sinf(half) / safe;
        const float qw1 = small ? 1.0f : cosf(half);
        const float qx1 = sx * s, qy1 = sy * s, qz1 = sz * s;
        const float x2 = f[QX], y2 = f[QY], z2 = f[QZ], w2 = f[QW];
        f[QX] = qw1 * x2 + qx1 * w2 + qy1 * z2 - qz1 * y2;
        f[QY] = qw1 * y2 - qx1 * z2 + qy1 * w2 + qz1 * x2;
        f[QZ] = qw1 * z2 + qx1 * y2 - qy1 * x2 + qz1 * w2;
        f[QW] = qw1 * w2 - qx1 * x2 - qy1 * y2 - qz1 * z2;
        f[WX] = wx + (tabf(tab, trow + TY_ANG_ACCEL + 0) - ang_drag * wx) * dt;
        f[WY] = wy + (tabf(tab, trow + TY_ANG_ACCEL + 1) - ang_drag * wy) * dt;
        f[WZ] = wz + (tabf(tab, trow + TY_ANG_ACCEL + 2) - ang_drag * wz) * dt;
      }
    }

    for (int i = 0; i < N_FIELDS; ++i)
      if (a.out[i]) a.out[i][g] = f[i];
    if (!single) a.ptype_out[g] = ty;

    if (a.pack_render) {
      // render-contract extract of the last sub-frame: instance scale (0 on
      // dead lanes), base rgba, emissive rgba
      const int crow = CV_AT + ty * CV_STRIDE;
      float base[4], emis[4];
      eval_gradient(tab, crow + CV_BASE_TS * MAX_K, tabi(tab, H_BASE_KIND + ty), tabi(tab, H_BASE_N + ty), age_pct,
                    base);
      eval_gradient(tab, crow + CV_EMIS_TS * MAX_K, tabi(tab, H_EMIS_KIND + ty), tabi(tab, H_EMIS_N + ty), age_pct,
                    emis);
      a.render[0][g] = survivor ? scale_new : 0.0f;
      for (int c = 0; c < 4; ++c) {
        a.render[1 + c][g] = base[c];
        a.render[5 + c][g] = emis[c];
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch one U-frame step on `stream`. Pointer arrays live on the host and
// hold device pointers: field_in/field_out have N_FIELDS slots (null for an
// elided field), scal_in/scal_out 5 (time_in_cycle f32[E], last_emission
// f32[E], enabled u8[E], manual_queued i32, ring_cursor i32), render_out
// N_RENDER or null. frame is FRAME_WORDS host floats, seeds `unroll` host
// words.
// Returns the cudaError_t of the launch (0 = success).
int bf_fused_step(const void* tables, void* const* field_in, void* const* field_out, const void* ptype_in,
                  void* ptype_out, void* const* scal_in, void* const* scal_out, void* const* render_out,
                  const float* frame, const uint32_t* seeds, int unroll, int n, void* stream) {
  if (unroll < 1 || unroll > MAX_U || n <= 0) return (int)cudaErrorInvalidValue;
  Args a;
  for (int i = 0; i < N_FIELDS; ++i) {
    a.in[i] = (const float*)field_in[i];
    a.out[i] = (float*)field_out[i];
  }
  a.ptype_in = (const int*)ptype_in;
  a.ptype_out = (int*)ptype_out;
  a.tic_in = (const float*)scal_in[0];
  a.last_in = (const float*)scal_in[1];
  a.en_in = (const uint8_t*)scal_in[2];
  a.mq_in = (const int*)scal_in[3];
  a.cursor_in = (const int*)scal_in[4];
  a.tic_out = (float*)scal_out[0];
  a.last_out = (float*)scal_out[1];
  a.en_out = (uint8_t*)scal_out[2];
  a.mq_out = (int*)scal_out[3];
  a.cursor_out = (int*)scal_out[4];
  a.pack_render = render_out != nullptr;
  for (int i = 0; i < N_RENDER; ++i) a.render[i] = render_out ? (float*)render_out[i] : nullptr;
  for (int i = 0; i < FRAME_WORDS; ++i) a.frame[i] = frame[i];
  for (int i = 0; i < MAX_U; ++i) a.seeds[i] = i < unroll ? seeds[i] : 0u;
  a.unroll = unroll;
  a.n = n;

  const int threads = 256;
  long long blocks = ((long long)n + threads - 1) / threads;
  if (blocks > 132 * 8) blocks = 132 * 8;  // grid-stride beyond 8 blocks per SM
  fused_step_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>((const int*)tables, a);
  return (int)cudaGetLastError();
}

const char* bf_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
