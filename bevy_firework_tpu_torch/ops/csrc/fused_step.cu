// Fused particle step for NVIDIA Hopper (sm_90a): emission cadence, ring or
// dead-rank claim, spawn init from Philox, age cull, move, the collision
// narrow phase (7 collider kinds, up to 4 bounce substeps,
// destroy-on-collision), scene force fields, linear drag, quaternion +
// angular drag, and optionally the destroyed-particle dump plane, the f32
// render pack and the frame's stats (AABB and counts), for U <= 8 frames
// per launch; and for archetypes with nested emitters, the nested cadence
// pass, the child rows from threefry draws, and the child merge into the
// step (one frame per launch).
//
// Replaces: bevy_firework_tpu/ops/fused_step.py `_make_kernel` (:913) as run
// by `_run_fused_kernel` (:1793) with kernel_spawn on, ring or dead-rank
// claims, colliders, force fields, the dump, kernel stats and the nested
// merge (no fleet, shard or fold blocks): its main-path block (:1162-1521),
// its render-pack block (:1523-1561, f32 mode), its collision narrow phase
// `_collide_tile` (:349) with `_ray_kind` (:309), its dead-rank claim
// (`_prefix_exclusive` :173 with the SMEM `dead_carry`, :1142-1149,
// :1323-1333) with the alive plane in and out (:1023-1026, :1563-1564), its
// force-field block (`force_fields.field_accel`, used :1462-1472), its dump
// plane (:1567-1576), its kernel-stats block (:1580-1618) and its nested
// child merge (:1172-1227, fed by `fused_step_hybrid` :2445); and
// `_make_nested_cadence_kernel` (:683, `nested_cadence_pass` :805/:866) and
// the child stage of bevy_firework_tpu/step.py `_nested_spawn` (:411-453,
// composed XLA there), below the step kernel.
//
// Design:
//  * One thread per lane; a block runs TILE lanes, a fixed contiguous lane
//    range per tile, tile-strided over N; any N (the TPU's 8192-lane granule
//    was a Mosaic tiling constraint). A lane's active fields stay in
//    registers across the U sub-frames; the pool is read and written once
//    per launch.
//  * Blocks run concurrently, so nothing carries across them inside the
//    kernel. The per-emitter cadence is scalar math whose values are the same
//    for every block: thread 0 of each block recomputes it for all U
//    sub-frames into shared memory (as every TPU tile recomputes it in SMEM).
//    Scalar state is read from the *_in buffers and written once, by block 0
//    thread 0, to distinct *_out buffers, so no block can read a value
//    already advanced.
//  * Claims: lane g is claimed in sub-frame u when dead and its rank is below
//    the sub-frame's total spawn count; the emitter is the one whose
//    cumulative window holds the rank. Ring archetypes (deaths only by age)
//    rank by ring distance ((g - cursor_u) mod N): no scan. Destroy-on-
//    collision archetypes (U = 1) rank by dead-slot count: the TPU kernel
//    carried it across its in-order grid in SMEM; here two small kernels
//    (dead_count_kernel, tile_scan_kernel) write each tile's exclusive
//    offset before the step, and the step adds a block-local ballot scan.
//  * Collision: per lane, one loop over the colliders in table order with a
//    strict `dist < best` (the first of tied colliders wins, as in the XLA
//    path and the TPU kernel's (dist, index) tie-break); collider rows and
//    hull planes sit in shared memory, loaded once per block; unrotated
//    colliders skip the quaternion rotations. The TPU's per-tile substep
//    gating and its grouped, broad-phase-culled collider loop were VPU
//    measures and are not carried over: a lane leaves the substep loop as
//    soon as it has no travel budget, which is the same per-lane result.
//  * Randomness: Philox-4x32-10, key (seed_u, 0), counter (g, block, 0, 0),
//    uniforms from the top 24 bits, draw order shape 0-2, velocity 3-5,
//    radial 6, scale 7, then lifetime, then angular velocity. The torch
//    version in bevy_firework_tpu_torch/prng.py gives the same bits.
//  * Force fields: the scene's field records ride the launch arguments by
//    value (a table the host edits every frame costs no device copy) and are
//    staged once per block in shared memory; each surviving lane evaluates
//    them at its post-move position and adds them, weighted by its type's
//    opt-in, to the type's acceleration before drag (the plain version's op
//    order). A lane on a field's singular locus gets 0 from it by a select.
//  * Dump plane: u8, the last sub-frame's `alive after spawn && !survivor`
//    gated by the type's destroyed handler; written when the launch passes
//    it (dump archetypes step one frame per launch).
//  * Stats: the TPU carried its SMEM stat rows across its in-order grid;
//    CUDA blocks run concurrently, so each thread folds its lanes (min, max,
//    counts over the last sub-frame's survivors), each block reduces its
//    threads into one partial row, and the last block to finish (an atomic
//    ticket after __threadfence) reduces the partial rows into the output
//    row. Min, max and integer sums are exact in any order, so the row
//    equals the plain reductions.
//  * Nested merge (hybrid frames, U = 1): the nested stage's kernels leave
//    each valid nested emitter's children by rank in a child-row buffer and
//    its claim window (start, n) in a device record. Before the global
//    claim, a dead lane whose claim rank in a window (ring distance from
//    the window's cursor, or dead-slot rank minus the window's start) is r
//    < n loads child r's row by a direct indexed load, becomes alive and
//    takes the emitter's type; the global claim then ranks from the cursor
//    the nested windows advanced (ring) or from the dead rank after the
//    last window. The TPU's pre-shift of the buffer by cursor mod 128 and
//    its two-segment slices were Mosaic constraints and are not carried
//    over. The windows are consecutive, so this claims the slots the JAX
//    package's in-place write-back claims on dead-rank archetypes too.
//  * The kernel is a template over the claim kind, the narrow phase, the
//    force fields, the stats and the merge (twenty instantiations, chosen
//    at launch: the four merge ones set the narrow phase and field flags
//    and gate them by the launch's counts), so the main path's kernel
//    carries none of their registers, barriers or shared memory.
//  * Spawner structure (emitter/type counts, pacing kinds, curve kinds and
//    knot counts, elision flags, collision types) and all
//    parameters come from one small device table read at run time; branches
//    on it are warp-uniform. The table's and the collider table's layouts,
//    the field slots, the frame row, the kind enumerations and the narrow
//    phase's float constants are defined once, in ops/table_layout.py; the
//    build generates "table_layout.h" from it, so this file states none of
//    them.
//
// FMA policy: built with -fmad=false and without fast math, so every
// multiply and add rounds on its own, divisions and sqrtf are IEEE, and the
// op order below is the op order of the plain version (step.py,
// collision.py). The cadence carry, the move, the drag and the whole narrow
// phase then agree bit for bit with it; only libm's sinf/cosf may differ
// from PyTorch's by an ulp or two.
//
// Bound on this card: memory traffic on the main path. A U-frame launch
// reads and writes each active field once (8 f32 planes for the stress_test
// archetype: 64 B per lane, about 8 MB at N = 131072, ~2.5 us at 3.35 TB/s),
// plus 36 B per lane when the render pack is on, plus 2 B (alive in and out)
// on the dead-rank claim, plus 1 B for the dump plane. Arithmetic per
// lane-frame is a few dozen flops outside spawn lanes; spawn lanes add three
// Philox blocks and the samplers' sinf/cosf; colliding lanes add up to 4
// substeps x C ray tests, which at C = 8 hulls makes the step
// arithmetic-bound; a turbulence field adds 9 cosf and ~80 flops per lane
// and sub-frame, the other kinds ~25 flops each. The stats add one row per
// block and a final pass over at most MAX_BLOCKS rows.

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
  const uint8_t* alive_in;         // non-ring archetypes, else null
  uint8_t* alive_out;              // ...
  const int* tile_dead_offset;     // ... [n / TILE]: dead lanes before each tile
  const int* colliders;            // COLLIDER_WORDS table
  int n_colliders;                 // 0: no narrow phase
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
  uint8_t* dump;                   // destroyed-dump plane (u8) or null
  int* stats_partial;              // kStats: [gridDim.x * STATS_WORDS] block rows
  unsigned* stats_ticket;          // kStats: blocks finished (0 at launch)
  int* stats_out;                  // kStats: the STATS_WORDS output row
  float frame[FRAME_WORDS];        // FR_* slots
  int fields[FIELD_WORDS];         // FF_* records of the scene's force fields
  int n_fields;
  uint32_t seeds[MAX_U];
  int unroll;
  int n;
  int pack_render;
  // kMerge (hybrid frames of nested archetypes, U = 1): the nested scalars
  // (NS_* records, one per valid nested emitter), the child rows
  // [n_merge][child_rows][merge_m] by rank, and the pre-spawn alive flag
  const int* nested;
  const float* child;
  const int* any_alive;
  int n_merge;
  int merge_m;
  int child_rows;
  int merge_e[MAX_E];  // emitter of each record
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

// ---- collision narrow phase (collision.py; the JAX kernel's _collide_tile) ----
// Every ray test returns the distance along the unit ray to the entry point
// (0 inside, COLLISION_BIG on a miss) and the local-frame entry normal (zero
// inside), with the op order of the plain version.

struct Ray {
  float dist, nx, ny, nz;
};

// torch.sign: +1, -1, or 0 for +-0
__device__ __forceinline__ float sgnf(float x) { return (float)((0.0f < x) - (x < 0.0f)); }
// d, or +-EPS (sign of d) where |d| < EPS
__device__ __forceinline__ float signed_eps(float d) {
  return fabsf(d) < COLLISION_EPS ? (d < 0.0f ? -COLLISION_EPS : COLLISION_EPS) : d;
}

__device__ __forceinline__ void normalize_or_zero(float x, float y, float z, float* ox, float* oy, float* oz) {
  const float l2 = x * x + y * y + z * z;
  const float inv = l2 > 0.0f ? 1.0f / sqrtf(l2) : 0.0f;
  *ox = x * inv;
  *oy = y * inv;
  *oz = z * inv;
}

__device__ __forceinline__ Ray ray_result(bool inside, float dist, float nx, float ny, float nz) {
  return inside ? Ray{0.0f, 0.0f, 0.0f, 0.0f} : Ray{dist, nx, ny, nz};
}

__device__ Ray ray_halfspace(float ox, float oy, float oz, float dx, float dy, float dz) {
  const bool inside = oy <= 0.0f;
  const float t = -oy / signed_eps(dy);
  const bool hit_surface = dy < 0.0f && t >= 0.0f;
  return ray_result(inside, hit_surface ? t : COLLISION_BIG, 0.0f, 1.0f, 0.0f);
}

__device__ Ray ray_sphere(float ox, float oy, float oz, float dx, float dy, float dz, float r) {
  const float c = ox * ox + oy * oy + oz * oz - r * r;
  const bool inside = c <= 0.0f;
  const float b = ox * dx + oy * dy + oz * dz;
  const float disc = b * b - c;
  const float sq = sqrtf(pmax(disc, 0.0f));
  const float t = -b - sq;
  const bool valid = disc >= 0.0f && t >= 0.0f;
  float nx, ny, nz;
  normalize_or_zero(ox + t * dx, oy + t * dy, oz + t * dz, &nx, &ny, &nz);
  return ray_result(inside, valid ? t : COLLISION_BIG, nx, ny, nz);
}

__device__ __forceinline__ void slab(float o, float d, float h, float* lo, float* hi) {
  const float invd = 1.0f / signed_eps(d);
  const float t1 = (-h - o) * invd;
  const float t2 = (h - o) * invd;
  *lo = pmin(t1, t2);
  *hi = pmax(t1, t2);
}

__device__ Ray ray_cuboid(float ox, float oy, float oz, float dx, float dy, float dz, float hx, float hy, float hz) {
  const bool inside = fabsf(ox) <= hx && fabsf(oy) <= hy && fabsf(oz) <= hz;
  float tx0, tx1, ty0, ty1, tz0, tz1;
  slab(ox, dx, hx, &tx0, &tx1);
  slab(oy, dy, hy, &ty0, &ty1);
  slab(oz, dz, hz, &tz0, &tz1);
  const float tmin = pmax(pmax(tx0, ty0), tz0);
  const float tmax = pmin(pmin(tx1, ty1), tz1);
  const bool valid = tmax >= tmin && tmin >= 0.0f;
  // entering face normal: the axis achieving tmin, signed against the ray
  const bool is_x = tmin == tx0;
  const bool is_y = !is_x && tmin == ty0;
  return ray_result(inside, valid ? tmin : COLLISION_BIG, is_x ? -sgnf(dx) : 0.0f, is_y ? -sgnf(dy) : 0.0f,
                    (is_x || is_y) ? 0.0f : -sgnf(dz));
}

// circle intersection in the XZ plane: t_enter, valid
__device__ __forceinline__ bool ray_infinite_cylinder(float ox, float oz, float dx, float dz, float r, float* t) {
  const float a = dx * dx + dz * dz;
  const float b = ox * dx + oz * dz;
  const float c = ox * ox + oz * oz - r * r;
  const float disc = b * b - a * c;
  const float sq = sqrtf(pmax(disc, 0.0f));
  const float safe_a = a < COLLISION_EPS ? COLLISION_EPS : a;
  *t = (-b - sq) / safe_a;
  return disc >= 0.0f && a >= COLLISION_EPS && *t >= 0.0f;
}

// cap sphere of a capsule at (0, cyy, 0)
__device__ __forceinline__ bool capsule_cap(float ox, float oy, float oz, float dx, float dy, float dz, float r,
                                            float cyy, float* t) {
  const float oy2 = oy - cyy;
  const float b = ox * dx + oy2 * dy + oz * dz;
  const float c = ox * ox + oy2 * oy2 + oz * oz - r * r;
  const float disc = b * b - c;
  *t = -b - sqrtf(pmax(disc, 0.0f));
  return disc >= 0.0f && *t >= 0.0f;
}

__device__ Ray ray_capsule(float ox, float oy, float oz, float dx, float dy, float dz, float r, float hs) {
  const float cy = clampf(oy, -hs, hs);
  const float d2 = ox * ox + (oy - cy) * (oy - cy) + oz * oz;
  const bool inside = d2 <= r * r;
  float t_side, t_top, t_bot;
  const bool v_side = ray_infinite_cylinder(ox, oz, dx, dz, r, &t_side) && fabsf(oy + t_side * dy) <= hs;
  const bool v_top = capsule_cap(ox, oy, oz, dx, dy, dz, r, hs, &t_top);
  const bool v_bot = capsule_cap(ox, oy, oz, dx, dy, dz, r, -hs, &t_bot);
  const float t_caps = pmin(v_top ? t_top : COLLISION_BIG, v_bot ? t_bot : COLLISION_BIG);
  const float t = pmin(v_side ? t_side : COLLISION_BIG, t_caps);
  const bool valid = t < COLLISION_BIG;
  const float hxp = ox + t * dx, hyp = oy + t * dy, hzp = oz + t * dz;
  float nx, ny, nz;
  normalize_or_zero(hxp, hyp - clampf(hyp, -hs, hs), hzp, &nx, &ny, &nz);
  return ray_result(inside, valid ? t : COLLISION_BIG, nx, ny, nz);
}

__device__ __forceinline__ bool cylinder_cap(float ox, float oy, float oz, float dx, float dy, float dz, float r,
                                             float cy, float sign, float* t) {
  *t = (cy - oy) / signed_eps(dy);
  const float xx = ox + *t * dx, zz = oz + *t * dz;
  return *t >= 0.0f && xx * xx + zz * zz <= r * r && sign * dy < 0.0f;
}

__device__ Ray ray_cylinder(float ox, float oy, float oz, float dx, float dy, float dz, float r, float hh) {
  const bool inside = ox * ox + oz * oz <= r * r && fabsf(oy) <= hh;
  float t_side, t_top, t_bot;
  const bool v_side = ray_infinite_cylinder(ox, oz, dx, dz, r, &t_side) && fabsf(oy + t_side * dy) <= hh;
  const bool v_top = cylinder_cap(ox, oy, oz, dx, dy, dz, r, hh, 1.0f, &t_top);
  const bool v_bot = cylinder_cap(ox, oy, oz, dx, dy, dz, r, -hh, -1.0f, &t_bot);
  const float top_t = v_top ? t_top : COLLISION_BIG;
  const float bot_t = v_bot ? t_bot : COLLISION_BIG;
  const float t = pmin(pmin(v_side ? t_side : COLLISION_BIG, top_t), bot_t);
  const bool valid = t < COLLISION_BIG;
  const bool hit_top = valid && v_top && t == top_t;
  const bool hit_bot = valid && v_bot && t == bot_t;
  float snx, sny, snz;
  normalize_or_zero(ox + t * dx, 0.0f, oz + t * dz, &snx, &sny, &snz);
  const bool cap_hit = hit_top || hit_bot;
  return ray_result(inside, valid ? t : COLLISION_BIG, cap_hit ? 0.0f : snx,
                    hit_top ? 1.0f : (hit_bot ? -1.0f : 0.0f), cap_hit ? 0.0f : snz);
}

__device__ Ray ray_cone(float ox, float oy, float oz, float dx, float dy, float dz, float r, float hh) {
  const float k = r / (2.0f * hh);  // radius growth per unit below the tip
  const float w = hh - oy;          // distance below the tip
  const bool inside = oy >= -hh && oy <= hh && ox * ox + oz * oz <= (k * w) * (k * w);
  // lateral surface x^2 + z^2 = k^2 (hh - y)^2
  const float a = dx * dx + dz * dz - k * k * dy * dy;
  const float b = ox * dx + oz * dz + k * k * w * dy;
  const float c = ox * ox + oz * oz - k * k * w * w;
  const float disc = b * b - a * c;
  const float sq = sqrtf(pmax(disc, 0.0f));
  const float safe_a = fabsf(a) < COLLISION_EPS ? COLLISION_EPS : a;
  const float t1 = (-b - sq) / safe_a;
  const float t2 = (-b + sq) / safe_a;
  const float tlo = pmin(t1, t2), thi = pmax(t1, t2);
  // ray parallel to the surface (a ~ 0): t = -c / (2b)
  const float t_lin = -c / (fabsf(b) < COLLISION_EPS ? COLLISION_EPS : 2.0f * b);
  const bool use_lin = fabsf(a) < COLLISION_EPS;
  const float y_lo = oy + tlo * dy, y_hi = oy + thi * dy;
  const bool ok_lo = tlo >= 0.0f && y_lo >= -hh && y_lo <= hh && disc >= 0.0f;
  const bool ok_hi = thi >= 0.0f && y_hi >= -hh && y_hi <= hh && disc >= 0.0f;
  float t_side = (use_lin && t_lin >= 0.0f) ? t_lin : (ok_lo ? tlo : (ok_hi ? thi : COLLISION_BIG));
  if (use_lin) t_side = (t_lin >= 0.0f && fabsf(oy + t_lin * dy) <= hh) ? t_lin : COLLISION_BIG;
  // base disk
  const float t_base = (-hh - oy) / signed_eps(dy);
  const float bx = ox + t_base * dx, bz = oz + t_base * dz;
  const bool v_base = t_base >= 0.0f && bx * bx + bz * bz <= r * r && dy > 0.0f;
  const float base_t = v_base ? t_base : COLLISION_BIG;
  const float t = pmin(t_side, base_t);
  const bool valid = t < COLLISION_BIG;
  const bool hit_base = valid && v_base && t == base_t;
  // lateral normal: the gradient of x^2 + z^2 - k^2 (hh - y)^2
  float gnx, gny, gnz;
  normalize_or_zero(ox + t * dx, k * k * (hh - (oy + t * dy)), oz + t * dz, &gnx, &gny, &gnz);
  return ray_result(inside, valid ? t : COLLISION_BIG, hit_base ? 0.0f : gnx, hit_base ? -1.0f : gny,
                    hit_base ? 0.0f : gnz);
}

// convex plane-set hull: planes are `count` rows (nx, ny, nz, d), n.x <= d inside
__device__ Ray ray_hull(float ox, float oy, float oz, float dx, float dy, float dz, const int* planes, int count) {
  float t_enter = -COLLISION_BIG, t_exit = COLLISION_BIG;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  bool inside = true, miss = false;
  for (int p = 0; p < count; ++p) {
    const float pnx = __int_as_float(planes[4 * p]), pny = __int_as_float(planes[4 * p + 1]);
    const float pnz = __int_as_float(planes[4 * p + 2]), pd = __int_as_float(planes[4 * p + 3]);
    const float denom = pnx * dx + pny * dy + pnz * dz;
    const float num = pd - (pnx * ox + pny * oy + pnz * oz);
    inside = inside && num >= 0.0f;
    const bool parallel = fabsf(denom) < COLLISION_EPS;
    const float t = num / (parallel ? (denom < 0.0f ? -COLLISION_EPS : COLLISION_EPS) : denom);
    miss = miss || (parallel && num < 0.0f);  // outside a parallel slab
    if (denom < 0.0f && !parallel && t > t_enter) {
      nx = pnx;
      ny = pny;
      nz = pnz;
      t_enter = t;
    }
    if (denom > 0.0f && !parallel) t_exit = pmin(t_exit, t);
  }
  const bool valid = !miss && t_exit >= t_enter && t_enter >= 0.0f;
  const bool keep = valid && !inside;
  return Ray{inside ? 0.0f : (valid ? t_enter : COLLISION_BIG), keep ? nx : 0.0f, keep ? ny : 0.0f,
             keep ? nz : 0.0f};
}

// Nearest hit over the colliders in table order (strict <: the first of
// tied colliders wins). Collider rows and hull planes are in shared memory.
__device__ float raycast_scene(const int* col, int n_col, uint32_t lane_mask, float px, float py, float pz,
                               float dx, float dy, float dz, float max_dist, float* bnx, float* bny, float* bnz) {
  float best = COLLISION_BIG;
  *bnx = 0.0f;
  *bny = 0.0f;
  *bnz = 0.0f;
  for (int ci = 0; ci < n_col; ++ci) {
    const int* row = col + ci * CO_STRIDE;
    // a collider outside the lane's layers reads COLLISION_BIG, never closer
    if ((lane_mask & (uint32_t)row[CO_LAYERS]) == 0u) continue;
    const bool ident = row[CO_IDENT] != 0;
    const float qx = __int_as_float(row[CO_ROT]), qy = __int_as_float(row[CO_ROT + 1]);
    const float qz = __int_as_float(row[CO_ROT + 2]), qw = __int_as_float(row[CO_ROT + 3]);
    float ox = px - __int_as_float(row[CO_POS]);
    float oy = py - __int_as_float(row[CO_POS + 1]);
    float oz = pz - __int_as_float(row[CO_POS + 2]);
    float rdx = dx, rdy = dy, rdz = dz;
    if (!ident) {
      quat_rotate(-qx, -qy, -qz, qw, ox, oy, oz, &ox, &oy, &oz);
      quat_rotate(-qx, -qy, -qz, qw, dx, dy, dz, &rdx, &rdy, &rdz);
    }
    const float p0 = __int_as_float(row[CO_PARAMS]), p1 = __int_as_float(row[CO_PARAMS + 1]);
    const float p2 = __int_as_float(row[CO_PARAMS + 2]);
    Ray h;
    switch (row[CO_KIND]) {
      case COLLIDER_HALFSPACE: h = ray_halfspace(ox, oy, oz, rdx, rdy, rdz); break;
      case COLLIDER_SPHERE: h = ray_sphere(ox, oy, oz, rdx, rdy, rdz, p0); break;
      case COLLIDER_CUBOID: h = ray_cuboid(ox, oy, oz, rdx, rdy, rdz, p0, p1, p2); break;
      case COLLIDER_CAPSULE: h = ray_capsule(ox, oy, oz, rdx, rdy, rdz, p0, p1); break;
      case COLLIDER_CYLINDER: h = ray_cylinder(ox, oy, oz, rdx, rdy, rdz, p0, p1); break;
      case COLLIDER_CONE: h = ray_cone(ox, oy, oz, rdx, rdy, rdz, p0, p1); break;
      default:  // COLLIDER_HULL
        h = ray_hull(ox, oy, oz, rdx, rdy, rdz, col + CO_PLANES_AT + ci * CO_PLANE_STRIDE, row[CO_HULL_N]);
    }
    if (h.dist <= max_dist && h.dist < best) {
      if (!ident) quat_rotate(qx, qy, qz, qw, h.nx, h.ny, h.nz, &h.nx, &h.ny, &h.nz);
      best = h.dist;
      *bnx = h.nx;
      *bny = h.ny;
      *bnz = h.nz;
    }
  }
  return best;
}

// particle_collision (reference core.rs:744-800) for one participating lane:
// up to SUBSTEPS raycast-and-bounce steps, stopping when the lane has no
// travel budget left or is destroyed (the TPU kernel's per-tile substep
// gating is a no-op per lane, so the per-lane exit gives the same bits).
// Returns destroyed.
__device__ bool collide(const int* col, int n_col, float* px, float* py, float* pz, float* vx, float* vy, float* vz,
                        float dt, float restitution, float friction, bool destroy, uint32_t lane_mask) {
  float delta = dt;
  for (int s = 0; s < SUBSTEPS; ++s) {
    if (!(delta > 0.0f)) break;
    const float speed2 = *vx * *vx + *vy * *vy + *vz * *vz;
    const float speed = sqrtf(speed2);
    // Dir3::try_from(vel): unit direction; zero -> +Y
    const bool ok = speed2 > 0.0f;
    const float inv = ok ? 1.0f / (speed > 0.0f ? speed : 1.0f) : 0.0f;
    const float dx = ok ? *vx * inv : 0.0f, dy = ok ? *vy * inv : 1.0f, dz = ok ? *vz * inv : 0.0f;
    const float max_dist = speed * delta;
    float nx, ny, nz;
    const float dist = raycast_scene(col, n_col, lane_mask, *px, *py, *pz, dx, dy, dz, max_dist, &nx, &ny, &nz);
    if (!(dist <= max_dist)) {  // miss: advect and finish (core.rs:792-795)
      *px = *px + *vx * delta;
      *py = *py + *vy * delta;
      *pz = *pz + *vz * delta;
      break;
    }
    if (dist == 0.0f) {  // inside: push out along the normal (core.rs:766-775)
      const bool n_zero = nx == 0.0f && ny == 0.0f && nz == 0.0f;
      const float fnx = n_zero ? (ok ? dx : 0.0f) : nx;
      const float fny = n_zero ? (ok ? dy : 1.0f) : ny;
      const float fnz = n_zero ? (ok ? dz : 0.0f) : nz;
      const float push = pmax(speed, 1.0f) * delta;
      *px = *px + push * fnx;
      *py = *py + push * fny;
      *pz = *pz + push * fnz;
    } else if (dist > 0.0f) {  // surface hit: advance, bounce (core.rs:776-787)
      const float px_s = *px + dx * dist, py_s = *py + dy * dist, pz_s = *pz + dz * dist;
      const float vdotn = *vx * nx + *vy * ny + *vz * nz;
      const float pjx = vdotn * nx, pjy = vdotn * ny, pjz = vdotn * nz;
      const float rjx = *vx - pjx, rjy = *vy - pjy, rjz = *vz - pjz;
      const float rej_len2 = rjx * rjx + rjy * rjy + rjz * rjz;
      const float rej_len = sqrtf(rej_len2);
      const float friction_dv = pmin(fabsf(vdotn), rej_len) * friction;
      const float rinv = rej_len2 > 0.0f ? 1.0f / (rej_len > 0.0f ? rej_len : 1.0f) : 0.0f;
      *vx = rjx - friction_dv * rjx * rinv - restitution * pjx;
      *vy = rjy - friction_dv * rjy * rinv - restitution * pjy;
      *vz = rjz - friction_dv * rjz * rinv - restitution * pjz;
      *px = px_s + nx * 1e-4f;
      *py = py_s + ny * 1e-4f;
      *pz = pz_s + nz * 1e-4f;
      delta = pmin(pmax(delta - dist, 0.0f), dt);
    }
    if (destroy) return true;  // destroy-on-collision freezes the lane (core.rs:788-791)
  }
  return false;
}

// ---- force fields (force_fields.py; the JAX kernel's field block, :1462-1472) ----

// curl of the 3-octave sine vector potential (force_fields._curl_sine_noise)
__device__ __forceinline__ void curl_sine_noise(float freq, float phase, float rx, float ry, float rz, float* cx,
                                                float* cy, float* cz) {
  float x = 0.0f, y = 0.0f, z = 0.0f;
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    const float ko = freq * (float)(1 << o);
    float dp[3][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int k = (o * 3 + c) * 3;  // constant after unrolling: direct constant-bank reads
      const float arg = ko * (TURB_DIRS[k] * rx + TURB_DIRS[k + 1] * ry + TURB_DIRS[k + 2] * rz) +
                        TURB_PHASE[o * 3 + c] + phase;
      const float g = TURB_AMP[o] * cosf(arg);
      dp[c][0] = g * TURB_DIRS[k];
      dp[c][1] = g * TURB_DIRS[k + 1];
      dp[c][2] = g * TURB_DIRS[k + 2];
    }
    x = x + dp[2][1] - dp[1][2];
    y = y + dp[0][2] - dp[2][0];
    z = z + dp[1][0] - dp[0][1];
  }
  *cx = x;
  *cy = y;
  *cz = z;
}

// Summed acceleration of the n_fields records at ff (shared memory) at
// (px, py, pz). A lane on a point centre or an axis line gets 0 from that
// field: d > FIELD_EPS selects, so the unselected quotient never enters.
__device__ void field_accel(const int* ff, int n_fields, float px, float py, float pz, float* oax, float* oay,
                            float* oaz) {
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  for (int i = 0; i < n_fields; ++i) {
    const int* r = ff + i * FF_STRIDE;
    const int kind = r[FF_KIND];
    const float s = __int_as_float(r[FF_PARAMS]) * __int_as_float(r[FF_ACTIVE]);
    const float inv_radius = 1.0f / __int_as_float(r[FF_PARAMS + 1]);
    const float rx = px - __int_as_float(r[FF_POS]);
    const float ry = py - __int_as_float(r[FF_POS + 1]);
    const float rz = pz - __int_as_float(r[FF_POS + 2]);
    if (kind == FIELD_TURBULENCE) {
      const float d = sqrtf(rx * rx + ry * ry + rz * rz);
      const float w = pmax(1.0f - d * inv_radius, 0.0f);
      float tx, ty, tz;
      curl_sine_noise(__int_as_float(r[FF_PARAMS + 2]), __int_as_float(r[FF_PARAMS + 3]), rx, ry, rz, &tx, &ty, &tz);
      const float g = s * w;
      ax = ax + g * tx;
      ay = ay + g * ty;
      az = az + g * tz;
    } else if (kind == FIELD_POINT) {
      const float d = sqrtf(rx * rx + ry * ry + rz * rz);
      const float w = pmax(1.0f - d * inv_radius, 0.0f);
      const float g = d > FIELD_EPS ? s * w / pmax(d, FIELD_EPS) : 0.0f;
      ax = ax - g * rx;
      ay = ay - g * ry;
      az = az - g * rz;
    } else {  // FIELD_VORTEX / FIELD_AXIAL: geometry about the axis line
      const float ux = __int_as_float(r[FF_AXIS]), uy = __int_as_float(r[FF_AXIS + 1]);
      const float uz = __int_as_float(r[FF_AXIS + 2]);
      const float tx = uy * rz - uz * ry;
      const float ty = uz * rx - ux * rz;
      const float tz = ux * ry - uy * rx;
      const float d_ax = sqrtf(tx * tx + ty * ty + tz * tz);
      const float w = pmax(1.0f - d_ax * inv_radius, 0.0f);
      const float g = d_ax > FIELD_EPS ? s * w / pmax(d_ax, FIELD_EPS) : 0.0f;
      if (kind == FIELD_VORTEX) {
        ax = ax + g * tx;
        ay = ay + g * ty;
        az = az + g * tz;
      } else {  // toward the axis: -r_perp = -(r - (r.u)u)
        const float dot = rx * ux + ry * uy + rz * uz;
        ax = ax - g * (rx - dot * ux);
        ay = ay - g * (ry - dot * uy);
        az = az - g * (rz - dot * uz);
      }
    }
  }
  *oax = ax;
  *oay = ay;
  *oaz = az;
}

// ---- kernel stats (the JAX kernel's SMEM stat rows, :1580-1618) ----
// A stats row: ST_MIN [3] and ST_MAX [3] f32 bits, ST_ALIVE and ST_TYPES
// [MAX_T] i32. Every combine is exact (NaN-propagating min/max, integer
// sums), so any reduction order gives the plain reductions' values.

struct Stats {
  float mn[3], mx[3];
  int alive, types[MAX_T];
};

__device__ __forceinline__ void stats_init(Stats& s) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.mn[c] = __int_as_float(0x7f800000);        // +inf
    s.mx[c] = __int_as_float((int)0xff800000u);  // -inf
  }
  s.alive = 0;
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) s.types[t] = 0;
}

__device__ __forceinline__ void stats_combine(Stats& s, const Stats& o) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.mn[c] = pmin(s.mn[c], o.mn[c]);
    s.mx[c] = pmax(s.mx[c], o.mx[c]);
  }
  s.alive += o.alive;
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) s.types[t] += o.types[t];
}

__device__ __forceinline__ Stats stats_shfl_down(const Stats& s, int delta) {
  Stats o;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o.mn[c] = __shfl_down_sync(0xffffffffu, s.mn[c], delta);
    o.mx[c] = __shfl_down_sync(0xffffffffu, s.mx[c], delta);
  }
  o.alive = __shfl_down_sync(0xffffffffu, s.alive, delta);
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) o.types[t] = __shfl_down_sync(0xffffffffu, s.types[t], delta);
  return o;
}

__device__ __forceinline__ void stats_store(int* row, const Stats& s) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    row[ST_MIN + c] = __float_as_int(s.mn[c]);
    row[ST_MAX + c] = __float_as_int(s.mx[c]);
  }
  row[ST_ALIVE] = s.alive;
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) row[ST_TYPES + t] = s.types[t];
}

// kL2: a row in device memory written by another block, read through L2
// (__ldcg: this SM's L1 need not hold that block's stores); else a row in
// this block's shared memory
template <bool kL2>
__device__ __forceinline__ Stats stats_load(const int* row) {
  Stats s;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.mn[c] = __int_as_float(kL2 ? __ldcg(row + ST_MIN + c) : row[ST_MIN + c]);
    s.mx[c] = __int_as_float(kL2 ? __ldcg(row + ST_MAX + c) : row[ST_MAX + c]);
  }
  s.alive = kL2 ? __ldcg(row + ST_ALIVE) : row[ST_ALIVE];
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) s.types[t] = kL2 ? __ldcg(row + ST_TYPES + t) : row[ST_TYPES + t];
  return s;
}

// Block-wide combine of every thread's `s` into the row at `out` (all
// threads of the block must call it; s_rows holds TILE / 32 rows).
__device__ void block_stats(Stats s, int* s_rows, int* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int delta = 16; delta > 0; delta >>= 1) stats_combine(s, stats_shfl_down(s, delta));
  if (lane == 0) stats_store(s_rows + warp * STATS_WORDS, s);
  __syncthreads();
  if (threadIdx.x == 0) {
    Stats b = stats_load<false>(s_rows);
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) stats_combine(b, stats_load<false>(s_rows + w * STATS_WORDS));
    stats_store(out, b);
  }
  __syncthreads();
}

// ---- dead-rank claim (replaces the JAX kernel's _prefix_exclusive + SMEM dead_carry) ----
// The TPU carried the dead count across tiles in SMEM because its grid runs
// in order; CUDA blocks do not, so the carry is count -> scan -> apply:
// dead_count_kernel writes each TILE-lane tile's dead count, tile_scan_kernel
// (one block) scans them into exclusive tile offsets, and the step kernel
// adds its tile's offset to a block-local exclusive rank.

// exclusive rank of this thread's `dead` among the block's dead lanes, in
// lane order (all threads of the block must call it)
__device__ int block_dead_rank(bool dead, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, dead);
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  int before = __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  __syncthreads();  // s_warp is rewritten by the next tile
  return before;
}

__global__ void __launch_bounds__(TILE) dead_count_kernel(const uint8_t* __restrict__ alive, int* __restrict__ counts,
                                                          int n, int n_tiles) {
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int g = tile * TILE + threadIdx.x;
    const int c = __syncthreads_count(g < n && alive[g] == 0);
    if (threadIdx.x == 0) counts[tile] = c;
  }
}

__global__ void __launch_bounds__(1024) tile_scan_kernel(const int* __restrict__ counts, int* __restrict__ offsets,
                                                         int n_tiles) {
  __shared__ int s_warp[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (n_tiles + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < n_tiles ? lo + per : n_tiles;
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += counts[i];
  int x = sum;  // inclusive warp scan
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)(blockDim.x >> 5) ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  int run = (warp > 0 ? s_warp[warp - 1] : 0) + x - sum;
  for (int i = lo; i < hi; ++i) {
    offsets[i] = run;
    run += counts[i];
  }
}

// kRing: ring claim (else the dead-rank claim with the alive plane, U = 1);
// kCollide: the narrow phase runs; kFields: the scene has force fields;
// kStats: the launch writes the stats row; kMerge: a hybrid frame of a
// nested archetype (U = 1): the nested children merge before the global
// claim, and the narrow phase and field block run where the launch passes
// colliders or fields (their flags are set; the counts gate them at run
// time). The twenty instantiations keep each block's registers, barriers
// and shared memory out of the kernels that do not run it (the main path's
// is <true, false, false, false, false>).
template <bool kRing, bool kCollide, bool kFields, bool kStats, bool kMerge>
__global__ void __launch_bounds__(TILE) fused_step_kernel(const int* __restrict__ tab, Args a) {
  __shared__ int s_cursor[MAX_U];
  __shared__ int s_bounds[MAX_U][MAX_E + 1];
  __shared__ int s_mstart[kMerge ? MAX_E : 1], s_mn[kMerge ? MAX_E : 1], s_mti[kMerge ? MAX_E : 1];
  __shared__ int s_rank_base;
  __shared__ int s_warp[TILE / 32];
  __shared__ int s_col[kCollide ? COLLIDER_WORDS : 1];
  __shared__ int s_ff[kFields ? FIELD_WORDS : 1];
  __shared__ int s_stats[kStats ? (TILE / 32) * STATS_WORDS : 1];
  __shared__ bool s_last;

  const int E = tabi(tab, H_E);
  const int n = a.n;
  const float dt = a.frame[FR_DT];
  const int n_col = kCollide ? a.n_colliders : 0;
  const int n_ff = kFields ? a.n_fields : 0;

  // collider rows, and the plane rows of each hull up to its own count
  if (kCollide) {
    for (int i = threadIdx.x; i < n_col * CO_STRIDE; i += blockDim.x) s_col[i] = a.colliders[i];
    for (int i = threadIdx.x; i < n_col * CO_PLANE_STRIDE; i += blockDim.x) {
      const int ci = i / CO_PLANE_STRIDE;
      if (i - ci * CO_PLANE_STRIDE < 4 * a.colliders[ci * CO_STRIDE + CO_HULL_N])
        s_col[CO_PLANES_AT + i] = a.colliders[CO_PLANES_AT + i];
    }
  }
  // field records (constant indices into the launch arguments: no local copy)
  if (kFields && threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < FIELD_WORDS; ++i) s_ff[i] = a.fields[i];
  }

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
    // the children's claim windows (kernel :1172-1227): ring windows start
    // at their cursor, dead-rank windows at a dead-slot rank, and the
    // global dead-rank claim after the last of them
    bool anyp = false;
    s_rank_base = 0;
    if (kMerge) {
      anyp = *a.any_alive != 0;
      for (int mi = 0; mi < a.n_merge; ++mi) {
        const int* rec = a.nested + NS_AT + mi * NS_STRIDE;
        s_mstart[mi] = rec[NS_START];
        s_mn[mi] = rec[NS_N];
        s_mti[mi] = tabi(tab, H_PINDEX + a.merge_e[mi]);
        if (!kRing) s_rank_base = rec[NS_NEXT];
      }
    }
    for (int u = 0; u < a.unroll; ++u) {
      // active() is nested-aware (core.rs:288-302; kernel :1241-1250): a
      // nested emitter counts only while a lane lived before the spawns
      bool active = false;
      for (int e = 0; e < E; ++e) active = active || (tabi(tab, H_MODE + e) == MODE_NESTED ? en[e] && anyp : en[e]);
      s_cursor[u] = cursor;
      int bound = 0;
      s_bounds[u][0] = 0;
      for (int e = 0; e < E; ++e) {
        const int row = EM_AT + e * EM_STRIDE;
        bool gate = active && en[e];
        int pk = tabi(tab, H_PACING + e);
        int n_sp;
        if (tabi(tab, H_MODE + e) == MODE_NESTED) {  // spawned by the nested phase; scalars pass through
          n_sp = 0;
        } else if (pk == PACING_ONE_SHOT) {
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
      if (kRing) {  // the dead-rank claim leaves the cursor alone
        long long c = ((long long)cursor + bound) % n;
        cursor = (int)(c < 0 ? c + n : c);
      }
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
  const int n_tiles = (n + TILE - 1) / TILE;
  Stats st;  // kStats: this thread's fold over its lanes' last sub-frame
  if (kStats) stats_init(st);

  // A tile is the fixed lane range [tile * TILE, (tile + 1) * TILE), whichever
  // block runs it: the dead-rank claim's tile offsets index it.
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int g = tile * TILE + threadIdx.x;
    // dead-rank claim (non-ring archetypes, U = 1): this lane's exclusive
    // rank among the dead lanes of the pool, in lane order
    int dead_rank = 0;
    if (!kRing) dead_rank = a.tile_dead_offset[tile] + block_dead_rank(g < n && a.alive_in[g] == 0, s_warp);
    if (g >= n) continue;

    float f[N_FIELDS];
    for (int i = 0; i < N_FIELDS; ++i) f[i] = a.in[i] ? a.in[i][g] : 0.0f;
    if (elide_rot) f[QW] = 1.0f;
    int ty = single ? 0 : a.ptype_in[g];
    bool survivor = false, alive_sp = false;

    for (int u = 0; u < a.unroll; ++u) {
      float life = const_life ? life_c : f[LIFETIME];
      bool alive0 = kRing ? f[AGE] < life : a.alive_in[g] != 0;
      if (kMerge && !alive0) {
        // ---- nested child merge (kernel :1172-1227): the child of rank r
        // of record mi takes the dead lane whose claim rank in that
        // record's window is r < n; a direct indexed load of its row ----
        for (int mi = 0; mi < a.n_merge; ++mi) {
          int r = kRing ? g - s_mstart[mi] : dead_rank - s_mstart[mi];
          if (kRing && r < 0) r += n;
          if (r >= 0 && r < s_mn[mi]) {
            const float* c = a.child + (size_t)mi * a.child_rows * a.merge_m + r;
            const int m = a.merge_m;
            int k = 0;
            f[PX] = c[(k++) * m];
            f[PY] = c[(k++) * m];
            f[PZ] = c[(k++) * m];
            f[VX] = c[(k++) * m];
            f[VY] = c[(k++) * m];
            f[VZ] = c[(k++) * m];
            if (!elide_rot) {
              f[QX] = c[(k++) * m];
              f[QY] = c[(k++) * m];
              f[QZ] = c[(k++) * m];
              f[QW] = c[(k++) * m];
              f[WX] = c[(k++) * m];
              f[WY] = c[(k++) * m];
              f[WZ] = c[(k++) * m];
            }
            f[INITIAL_SCALE] = c[(k++) * m];
            f[AGE] = c[(k++) * m];
            if (!const_life) f[LIFETIME] = c[k * m];
            ty = s_mti[mi];
            alive0 = true;
            break;
          }
        }
      }
      bool spawned = false;
      const int total = s_bounds[u][E];
      if (!alive0 && total > 0) {
        int rank = dead_rank - s_rank_base;
        if (kRing) {
          rank = g - s_cursor[u];
          if (rank < 0) rank += n;
        }
        if (rank >= 0 && rank < total) {
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
      alive_sp = alive0 || spawned;

      // ---- integrate (reference core.rs:594-650) ----
      life = const_life ? life_c : f[LIFETIME];
      const float age_new = f[AGE] + dt;
      const bool dead_by_age = age_new >= life;
      const bool moved = alive_sp && !dead_by_age;
      const int trow = TY_AT + ty * TY_STRIDE;
      const float vx = f[VX], vy = f[VY], vz = f[VZ];
      float npx = f[PX] + vx * dt, npy = f[PY] + vy * dt, npz = f[PZ] + vz * dt;
      float nvx = vx, nvy = vy, nvz = vz;
      bool destroyed = false;
      if (kCollide && n_col > 0 && moved && tabi(tab, H_HAS_COL + ty) != 0) {
        // ---- narrow phase on a participating lane (kernel :1421-1456) ----
        npx = f[PX];
        npy = f[PY];
        npz = f[PZ];
        destroyed = collide(s_col, n_col, &npx, &npy, &npz, &nvx, &nvy, &nvz, dt, tabf(tab, trow + TY_RESTITUTION),
                            tabf(tab, trow + TY_FRICTION), tabf(tab, trow + TY_DESTROY) > 0.0f,
                            (uint32_t)tabi(tab, trow + TY_COLL_MASK));
      }
      survivor = moved && !destroyed;
      const float lin_drag = tabf(tab, trow + TY_LIN_DRAG);
      // a destroyed lane keeps its age: ring archetypes never destroy, the
      // others carry the alive plane
      if (alive_sp) f[AGE] = age_new;
      if (moved) {
        f[PX] = npx;
        f[PY] = npy;
        f[PZ] = npz;
        f[VX] = nvx;
        f[VY] = nvy;
        f[VZ] = nvz;
      }
      if (survivor) {
        float ax = tabf(tab, trow + TY_ACCEL + 0), ay = tabf(tab, trow + TY_ACCEL + 1);
        float az = tabf(tab, trow + TY_ACCEL + 2);
        if (kFields && n_ff > 0) {  // scene force fields at the post-move position (kernel :1462-1472)
          float fx, fy, fz;
          field_accel(s_ff, n_ff, npx, npy, npz, &fx, &fy, &fz);
          const float fm = tabf(tab, trow + TY_FIELD_MASK);
          ax = ax + fm * fx;
          ay = ay + fm * fy;
          az = az + fm * fz;
        }
        f[VX] = nvx + (ax - nvx * lin_drag) * dt;
        f[VY] = nvy + (ay - nvy * lin_drag) * dt;
        f[VZ] = nvz + (az - nvz * lin_drag) * dt;
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
    if (!kRing) a.alive_out[g] = survivor ? 1 : 0;
    // destroyed-dump plane (kernel :1567-1576): died this sub-frame, of a
    // type with a destroyed handler
    if (a.dump) a.dump[g] = (alive_sp && !survivor && tabi(tab, H_DUMP + ty) != 0) ? 1 : 0;

    // the lane's instance scale at its age fraction (render pack, stats)
    const float age_pct = f[AGE] / (const_life ? life_c : f[LIFETIME]);
    const int crow = CV_AT + ty * CV_STRIDE;
    float scale = 0.0f;
    if (a.pack_render || (kStats && survivor))
      scale = f[INITIAL_SCALE] * eval_curve(tab, crow + CV_SCALE_TS * MAX_K, crow + CV_SCALE_VS * MAX_K,
                                            tabi(tab, H_SCALE_KIND + ty), tabi(tab, H_SCALE_N + ty), age_pct);
    if (kStats && survivor) {  // stats of the last sub-frame (kernel :1580-1618)
      st.mn[0] = pmin(st.mn[0], f[PX] - scale);
      st.mn[1] = pmin(st.mn[1], f[PY] - scale);
      st.mn[2] = pmin(st.mn[2], f[PZ] - scale);
      st.mx[0] = pmax(st.mx[0], f[PX] + scale);
      st.mx[1] = pmax(st.mx[1], f[PY] + scale);
      st.mx[2] = pmax(st.mx[2], f[PZ] + scale);
      st.alive += 1;
#pragma unroll
      for (int t = 0; t < MAX_T; ++t) st.types[t] += ty == t ? 1 : 0;
    }

    if (a.pack_render) {
      // render-contract extract of the post-step state: instance scale (0 on
      // dead lanes), base rgba, emissive rgba, at the lane's age fraction
      float base[4], emis[4];
      eval_gradient(tab, crow + CV_BASE_TS * MAX_K, tabi(tab, H_BASE_KIND + ty), tabi(tab, H_BASE_N + ty), age_pct,
                    base);
      eval_gradient(tab, crow + CV_EMIS_TS * MAX_K, tabi(tab, H_EMIS_KIND + ty), tabi(tab, H_EMIS_N + ty), age_pct,
                    emis);
      a.render[0][g] = survivor ? scale : 0.0f;
      for (int c = 0; c < 4; ++c) {
        a.render[1 + c][g] = base[c];
        a.render[5 + c][g] = emis[c];
      }
    }
  }

  if (kStats) {
    // this block's row, then the last block to finish reduces every row
    block_stats(st, s_stats, a.stats_partial + blockIdx.x * STATS_WORDS);
    if (threadIdx.x == 0) {
      __threadfence();  // the row is visible before the ticket counts it
      s_last = atomicAdd(a.stats_ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (s_last) {
      __threadfence();
      Stats all;
      stats_init(all);
      for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x)
        stats_combine(all, stats_load<true>(a.stats_partial + b * STATS_WORDS));
      block_stats(all, s_stats, a.stats_out);
    }
  }
}

// ---- nested emission: the cadence pass (kernel row 8) and the child rows ----
// Replaces bevy_firework_tpu/ops/fused_step.py `_make_nested_cadence_kernel`
// (:683, called by `nested_cadence_pass` :805/:866) and the child stage of
// bevy_firework_tpu/step.py `_nested_spawn` (:411-453, composed XLA there).
// The TPU carried the count cumsum across its in-order tiles in SMEM; CUDA
// blocks run concurrently, so the pass is count -> scan -> apply, as the
// dead-rank claim: nested_count_kernel writes each tile's parent-count sum,
// tile_scan_kernel scans them, nested_apply_kernel recounts each lane, adds
// a block scan to its tile's offset for the inclusive cum, and writes the
// advanced anchors. Fetch mode has each parent lane write its own
// children's parent fields to out[r], r in [cum - count, min(cum, M)): a
// direct store replaces the TPU's exact MXU row fetch (`_exact_row_fetch`,
// :663) and its chunked one-hot search (:771-800), both Mosaic workarounds.
// Bound on this card: the launches. At 131072 lanes the pass moves ~3 MB
// (alive, ptype, age and the anchor in, the anchor and cum out), ~1 us at
// 3.35 TB/s, against a few microseconds per launch.

struct NestedArgs {
  const uint8_t* alive;            // pre-spawn alive plane
  const int* ptype;                // null: single type
  const float* age;
  const float* lifetime;           // null: the table's constant
  const float* le_in;              // this emitter's last_emitted row
  const uint8_t* gate;             // the emitter's gate (one byte)
  float* le_out;
  int* cum;                        // cum mode: the inclusive count cumsum; null in fetch mode
  const float* fetch_in[MAX_FETCH];  // fetch mode: parent planes
  float* fetch_out;                // fetch mode: [n_fetch][m] parent values by child rank
  int n_fetch;
  int* tile_counts;
  int* tile_offsets;
  const int* start_in;             // the window start (null: 0)
  const int* dead_counts;          // dead-rank archetypes: the claim's tile counts and offsets
  const int* dead_offsets;
  int* rec;                        // this emitter's NS record
  int* any_alive;                  // NS_ANY (null: not written)
  int e, n, m, ring;
};

// One lane's parent count (0 off the parent mask), its reset anchor, the
// full advance and its lifetime (step.nested_cadence's op order).
struct NestedLane {
  int count;
  float base_le, next_full, life;
  bool pm;
};

__device__ __forceinline__ NestedLane nested_lane(const int* tab, const NestedArgs& a, int g) {
  NestedLane l;
  const int row = EM_AT + a.e * EM_STRIDE;
  const bool alive = a.alive[g] != 0;
  l.life = a.lifetime ? a.lifetime[g] : tabf(tab, H_CONST_LIFE_VAL);
  l.base_le = alive ? a.le_in[g] : __int_as_float((int)0xff7fffffu);  // lazy reset to f32::MIN
  l.pm = alive && *a.gate != 0;
  if (a.ptype) l.pm = l.pm && a.ptype[g] == tabi(tab, H_TARGET + a.e);
  emission_count(a.age[g], l.base_le, l.life, tabf(tab, row + EM_OFF_START), tabf(tab, row + EM_OFF_END),
                 tabf(tab, row + EM_COUNT), &l.count, &l.next_full);
  if (!l.pm) l.count = 0;
  return l;
}

// inclusive scan of x over the block (all threads call it; s_warp holds
// TILE / 32 words and is free again on return)
__device__ int block_inclusive_scan(int x, int* s_warp, int* block_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int v = s_warp[w];
    if (w < warp) before += v;
    all += v;
  }
  __syncthreads();
  *block_total = all;
  return before + x;
}

__global__ void __launch_bounds__(TILE) nested_count_kernel(const int* __restrict__ tab, NestedArgs a, int n_tiles) {
  __shared__ int s_warp[TILE / 32];
  // fetch mode: ranks at or above the total keep 0 (the apply kernel writes
  // the others)
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n_fetch * a.m; i += gridDim.x * blockDim.x)
    a.fetch_out[i] = 0.0f;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int g = tile * TILE + threadIdx.x;
    int c = 0;
    bool alive = false;
    if (g < a.n) {
      c = nested_lane(tab, a, g).count;
      alive = a.alive[g] != 0;
    }
    int sum;
    block_inclusive_scan(c, s_warp, &sum);
    const bool any = __syncthreads_or(alive);
    if (threadIdx.x == 0) {
      a.tile_counts[tile] = sum;
      if (any && a.any_alive) *a.any_alive = 1;
    }
  }
}

__global__ void __launch_bounds__(TILE) nested_apply_kernel(const int* __restrict__ tab, NestedArgs a, int n_tiles) {
  __shared__ int s_warp[TILE / 32];
  const int row = EM_AT + a.e * EM_STRIDE;
  const float off_s = tabf(tab, row + EM_OFF_START), off_e = tabf(tab, row + EM_OFF_END);
  const float between = (off_e - off_s) / tabf(tab, row + EM_COUNT);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int g = tile * TILE + threadIdx.x;
    NestedLane l;
    l.count = 0;
    if (g < a.n) l = nested_lane(tab, a, g);
    int unused;
    const int cum = a.tile_offsets[tile] + block_inclusive_scan(l.count, s_warp, &unused);
    if (g >= a.n) continue;
    // deferral: only ranks below M materialise; a cut parent advances its
    // anchor by what was emitted (cadence.emission_next_last's op order)
    const int lo = cum - l.count;
    const int emitted = min(cum, a.m) - min(lo, a.m);
    const float last_pct = l.base_le / l.life;
    const float clamped = pmax(last_pct, off_s);
    const float trunc = (clamped + (float)emitted * between) * l.life;
    const float nl = emitted < l.count ? trunc : l.next_full;
    a.le_out[g] = l.pm ? nl : l.base_le;
    if (a.cum) a.cum[g] = cum;
    for (int r = lo; r < min(cum, a.m); ++r)
      for (int k = 0; k < a.n_fetch; ++k) a.fetch_out[k * a.m + r] = a.fetch_in[k][g];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    // the emitter's scalars: total, children this frame, its claim window
    const int total = a.tile_offsets[n_tiles - 1] + a.tile_counts[n_tiles - 1];
    const int n_sp = min(total, a.m);
    const int start = a.start_in ? *a.start_in : 0;
    a.rec[NS_TOTAL] = total;
    a.rec[NS_N] = n_sp;
    a.rec[NS_START] = start;
    if (a.ring) {
      a.rec[NS_NEXT] = (int)(((long long)start + n_sp) % a.n);
    } else {  // dead-rank: children beyond the pool's dead lanes drop
      const int n_tail = (a.n + TILE - 1) / TILE - 1;
      const int dead = a.dead_offsets[n_tail] + a.dead_counts[n_tail];
      a.rec[NS_NEXT] = start + n_sp;
      a.rec[NS_DROPPED] = n_sp - min(n_sp, max(dead - start, 0));
    }
  }
}

// threefry-2x32, 20 rounds (prng.threefry2x32)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1, uint32_t* o0,
                                             uint32_t* o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = (x1 << rot[i % 2][j]) | (x1 >> (32 - rot[i % 2][j]));
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  *o0 = x0;
  *o1 = x1;
}

struct ChildArgs {
  const float* parent_vals;        // fetch mode: [n_parent][m] by rank; null in cum mode
  const int* cum;                  // cum mode: the inclusive count cumsum [n]
  const float* planes[MAX_FETCH];  // cum mode: parent planes (nested_parent_fields order)
  int n_parent;
  int* rec;                        // ring hybrid frames: this emitter's record (drops counted); else null
  const uint8_t* alive;            // ... and the pre-spawn alive plane
  float* out;                      // [child_rows][m]
  float frame[FRAME_WORDS];
  uint32_t k0, k1;                 // fold_in(frame_key, 1000 + e)
  int e, n, m, n_draws;
};

// One thread per child rank r: the uniforms uniform(fold_in(frame_key,
// 1000 + e), (n_draws, M)) at flat index i * M + r (threefry-2x32 of
// (hi, lo) of the index, the xor of its words, the top 23 bits as a float
// in [1, 2) minus 1), then the child's init (step.nested_child_rows' op
// order). Bound: the launch (M ranks, 12 threefry evaluations each).
__global__ void __launch_bounds__(TILE) nested_child_rows_kernel(const int* __restrict__ tab, ChildArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  bool drop = false;
  if (r < a.m) {
    const bool elide_rot = tabi(tab, H_ELIDE_ROT) != 0;
    const bool const_life = tabi(tab, H_CONST_LIFE) != 0;
    float p[MAX_FETCH];
    if (a.parent_vals) {
      for (int k = 0; k < a.n_parent; ++k) p[k] = a.parent_vals[k * a.m + r];
    } else {  // the first lane whose cum exceeds r, clamped into the pool
      int lo = 0, hi = a.n;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a.cum[mid] <= r) lo = mid + 1;
        else hi = mid;
      }
      const int par = lo < a.n ? lo : a.n - 1;
      for (int k = 0; k < a.n_parent; ++k) p[k] = a.planes[k][par];
    }
    float u[12];
    for (int i = 0; i < a.n_draws; ++i) {
      uint32_t b0, b1;
      threefry2x32(a.k0, a.k1, 0u, (uint32_t)(i * a.m + r), &b0, &b1);
      u[i] = __int_as_float((int)(((b0 ^ b1) >> 9) | 0x3f800000u)) - 1.0f;
    }
    const int row = EM_AT + a.e * EM_STRIDE;
    const int ti = tabi(tab, H_PINDEX + a.e);
    const int trow = TY_AT + ti * TY_STRIDE;
    float offx, offy, offz, ivx, ivy, ivz;
    shape_point(tab, row + EM_SHAPE, u[0], u[1], u[2], &offx, &offy, &offz);
    randvec3(tab, row + EM_IVEL, u[3], u[4], u[5], &ivx, &ivy, &ivz);
    const float rlo = tabf(tab, row + EM_RADIAL_LO), rhi = tabf(tab, row + EM_RADIAL_HI);
    const float radial = rlo + (rhi - rlo) * u[6];
    const float l2 = offx * offx + offy * offy + offz * offz;
    const float inv = l2 > 0.0f ? 1.0f / sqrtf(l2) : 0.0f;
    float wvx = ivx, wvy = ivy, wvz = ivz;
    const int pv = a.n_parent - 3;  // parent velocity follows position [and rotation]
    if (!elide_rot) quat_rotate(p[3], p[4], p[5], p[6], ivx, ivy, ivz, &wvx, &wvy, &wvz);
    const float spd = a.frame[FR_MOD_SPEED], inh = tabf(tab, row + EM_INHERIT);
    float* o = a.out + r;
    const int m = a.m;
    int k = 0;
    o[(k++) * m] = p[0] + offx;
    o[(k++) * m] = p[1] + offy;
    o[(k++) * m] = p[2] + offz;
    o[(k++) * m] = spd * (wvx + offx * inv * radial) + inh * p[pv];
    o[(k++) * m] = spd * (wvy + offy * inv * radial) + inh * p[pv + 1];
    o[(k++) * m] = spd * (wvz + offz * inv * radial) + inh * p[pv + 2];
    if (!elide_rot) {
      for (int q = 0; q < 4; ++q) o[(k++) * m] = tabf(tab, row + EM_INIT_ROT + q);
      float avx, avy, avz;
      randvec3(tab, row + EM_IANG, u[9], u[10], u[11], &avx, &avy, &avz);
      o[(k++) * m] = avx;
      o[(k++) * m] = avy;
      o[(k++) * m] = avz;
    }
    const float slo = tabf(tab, trow + TY_ISCALE_LO), shi = tabf(tab, trow + TY_ISCALE_HI);
    o[(k++) * m] = (slo + (shi - slo) * u[7]) * a.frame[FR_MOD_SCALE];
    o[(k++) * m] = 0.0f;
    if (!const_life) {
      const float llo = tabf(tab, trow + TY_LIFE_LO), lhi = tabf(tab, trow + TY_LIFE_HI);
      o[k * m] = llo + (lhi - llo) * u[8];
    }
    // ring hybrid frames: a child whose window slot lives is dropped
    if (a.rec) {
      const int n_sp = a.rec[NS_N];
      const int slot = (int)(((long long)a.rec[NS_START] + r) % a.n);
      drop = r < n_sp && a.alive[slot] != 0;
    }
  }
  if (a.rec) {
    const unsigned b = __ballot_sync(0xffffffffu, drop);
    if ((threadIdx.x & 31) == 0 && b) atomicAdd(a.rec + NS_DROPPED, __popc(b));
  }
}

using KernelFn = void (*)(const int*, Args);

template <bool R, bool C, bool F>
KernelFn select_stats(bool stats) {
  return stats ? fused_step_kernel<R, C, F, true, false> : fused_step_kernel<R, C, F, false, false>;
}
template <bool R>
KernelFn select_merge(bool stats) {
  return stats ? fused_step_kernel<R, true, true, true, true> : fused_step_kernel<R, true, true, false, true>;
}
template <bool R, bool C>
KernelFn select_fields(bool fields, bool stats) {
  return fields ? select_stats<R, C, true>(stats) : select_stats<R, C, false>(stats);
}
template <bool R>
KernelFn select_collide(bool collide, bool fields, bool stats) {
  return collide ? select_fields<R, true>(fields, stats) : select_fields<R, false>(fields, stats);
}

}  // namespace

extern "C" {

// Launch one U-frame step on `stream`. Pointer arrays live on the host and
// hold device pointers: field_in/field_out have N_FIELDS slots (null for an
// elided field), scal_in/scal_out 5 (time_in_cycle f32[E], last_emission
// f32[E], enabled u8[E], manual_queued i32, ring_cursor i32), render_out
// N_RENDER or null. colliders is a COLLIDER_WORDS table with n_colliders
// rows (n_colliders 0: no narrow phase). Non-ring archetypes (U = 1) pass
// the alive planes (u8) and the tile offsets bf_dead_rank_offsets wrote;
// ring archetypes pass nulls. frame is FRAME_WORDS host floats, seeds
// `unroll` host words, fields FIELD_WORDS host words holding n_fields
// records (n_fields 0: no force fields). dump_out is the u8 dump plane or
// null. stats_out (STATS_WORDS words) or null; with it, stats_partial holds
// MAX_BLOCKS rows of scratch and stats_ticket one word that is 0 at launch.
// A hybrid frame of a nested archetype (U = 1) passes any_alive (one int,
// the pre-spawn flag), the nested scalars (NS_* records of n_merge
// emitters, merge_e[i] the emitter of record i) and the child rows
// [n_merge][child_rows][merge_m]; other launches pass a null any_alive.
// Returns the cudaError_t of the launch (0 = success).
int bf_fused_step(const void* tables, const void* colliders, int n_colliders, void* const* field_in,
                  void* const* field_out, const void* ptype_in, void* ptype_out, const void* alive_in,
                  void* alive_out, const void* tile_dead_offset, void* const* scal_in, void* const* scal_out,
                  void* const* render_out, const float* frame, const uint32_t* seeds, int unroll, int n,
                  const int* fields, int n_fields, void* dump_out, void* stats_partial, void* stats_ticket,
                  void* stats_out, const void* any_alive, const void* nested, const void* child, int n_merge,
                  const int* merge_e, int merge_m, int child_rows, void* stream) {
  if (unroll < 1 || unroll > MAX_U || n <= 0 || n_colliders < 0 || n_colliders > MAX_C || n_fields < 0 ||
      n_fields > MAX_F)
    return (int)cudaErrorInvalidValue;
  const bool merge = any_alive != nullptr;
  if (merge && (unroll != 1 || n_merge < 0 || n_merge > MAX_E || (n_merge > 0 && (nested == nullptr ||
                child == nullptr || merge_m <= 0))))
    return (int)cudaErrorInvalidValue;
  if ((alive_in == nullptr) != (tile_dead_offset == nullptr) || (alive_in != nullptr && unroll != 1))
    return (int)cudaErrorInvalidValue;
  if (stats_out != nullptr && (stats_partial == nullptr || stats_ticket == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  for (int i = 0; i < N_FIELDS; ++i) {
    a.in[i] = (const float*)field_in[i];
    a.out[i] = (float*)field_out[i];
  }
  a.ptype_in = (const int*)ptype_in;
  a.ptype_out = (int*)ptype_out;
  a.alive_in = (const uint8_t*)alive_in;
  a.alive_out = (uint8_t*)alive_out;
  a.tile_dead_offset = (const int*)tile_dead_offset;
  a.colliders = (const int*)colliders;
  a.n_colliders = n_colliders;
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
  a.dump = (uint8_t*)dump_out;
  a.stats_partial = (int*)stats_partial;
  a.stats_ticket = (unsigned*)stats_ticket;
  a.stats_out = (int*)stats_out;
  for (int i = 0; i < FRAME_WORDS; ++i) a.frame[i] = frame[i];
  for (int i = 0; i < FIELD_WORDS; ++i) a.fields[i] = i < n_fields * FF_STRIDE ? fields[i] : 0;
  a.n_fields = n_fields;
  for (int i = 0; i < MAX_U; ++i) a.seeds[i] = i < unroll ? seeds[i] : 0u;
  a.unroll = unroll;
  a.n = n;
  a.any_alive = (const int*)any_alive;
  a.nested = (const int*)nested;
  a.child = (const float*)child;
  a.n_merge = merge ? n_merge : 0;
  a.merge_m = merge_m;
  a.child_rows = child_rows;
  for (int i = 0; i < MAX_E; ++i) a.merge_e[i] = i < a.n_merge ? merge_e[i] : 0;

  const bool collide = n_colliders > 0, with_fields = n_fields > 0, stats = stats_out != nullptr;
  KernelFn kernel;
  if (merge)
    kernel = alive_in == nullptr ? select_merge<true>(stats) : select_merge<false>(stats);
  else
    kernel = alive_in == nullptr ? select_collide<true>(collide, with_fields, stats)
                                 : select_collide<false>(collide, with_fields, stats);
  long long blocks = ((long long)n + TILE - 1) / TILE;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;  // tile-stride beyond that
  kernel<<<(int)blocks, TILE, 0, (cudaStream_t)stream>>>((const int*)tables, a);
  return (int)cudaGetLastError();
}

// The dead-rank claim's first two passes over the u8 alive plane: per-tile
// dead counts into `counts` and their exclusive scan into `offsets` (both
// int32[ceil(n / TILE)]), on `stream`. Returns the cudaError_t of the
// launches.
int bf_dead_rank_offsets(const void* alive, void* counts, void* offsets, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = (n + TILE - 1) / TILE;
  const int blocks = n_tiles < MAX_BLOCKS ? n_tiles : MAX_BLOCKS;
  dead_count_kernel<<<blocks, TILE, 0, (cudaStream_t)stream>>>((const uint8_t*)alive, (int*)counts, n, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_scan_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>((const int*)counts, (int*)offsets, n_tiles);
  return (int)cudaGetLastError();
}

// One nested emitter's cadence pass over n lanes (kernel row 8): count,
// scan and apply launches on `stream`. alive (u8), age, le_in and le_out
// are [n]; ptype [n] or null (one type); lifetime [n] or null (the table's
// constant); gate one byte. Cum mode: cum [n] out, n_fetch 0. Fetch mode:
// cum null, fetch_in a host array of n_fetch device planes [n], fetch_out
// [n_fetch][m]. scratch holds 2 * ceil(n / TILE) ints. record (NS_STRIDE
// ints) receives the emitter's scalars, the window starting at *start_in
// (null: 0); dead-rank archetypes (ring 0) pass the claim's tile counts
// and offsets for the drop count. any_alive (or null) is set to 1 when a
// lane is alive. Returns the cudaError_t of the launches.
int bf_nested_cadence(const void* tables, int e, const void* alive, const void* ptype, const void* age,
                      const void* lifetime, const void* le_in, const void* gate, void* le_out, void* cum,
                      void* const* fetch_in, void* fetch_out, int n_fetch, void* scratch, const void* start_in,
                      const void* dead_counts, const void* dead_offsets, void* record, void* any_alive, int n,
                      int m, int ring, void* stream) {
  if (n <= 0 || m <= 0 || m > n || e < 0 || e >= MAX_E || n_fetch < 0 || n_fetch > MAX_FETCH ||
      (n_fetch > 0) == (cum != nullptr) || (!ring && (dead_counts == nullptr || dead_offsets == nullptr)))
    return (int)cudaErrorInvalidValue;
  NestedArgs a;
  a.alive = (const uint8_t*)alive;
  a.ptype = (const int*)ptype;
  a.age = (const float*)age;
  a.lifetime = (const float*)lifetime;
  a.le_in = (const float*)le_in;
  a.gate = (const uint8_t*)gate;
  a.le_out = (float*)le_out;
  a.cum = (int*)cum;
  for (int k = 0; k < MAX_FETCH; ++k) a.fetch_in[k] = k < n_fetch ? (const float*)fetch_in[k] : nullptr;
  a.fetch_out = (float*)fetch_out;
  a.n_fetch = n_fetch;
  const int n_tiles = (n + TILE - 1) / TILE;
  a.tile_counts = (int*)scratch;
  a.tile_offsets = (int*)scratch + n_tiles;
  a.start_in = (const int*)start_in;
  a.dead_counts = (const int*)dead_counts;
  a.dead_offsets = (const int*)dead_offsets;
  a.rec = (int*)record;
  a.any_alive = (int*)any_alive;
  a.e = e;
  a.n = n;
  a.m = m;
  a.ring = ring;
  const int blocks = n_tiles < MAX_BLOCKS ? n_tiles : MAX_BLOCKS;
  const cudaStream_t st = (cudaStream_t)stream;
  nested_count_kernel<<<blocks, TILE, 0, st>>>((const int*)tables, a, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_scan_kernel<<<1, 1024, 0, st>>>(a.tile_counts, a.tile_offsets, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nested_apply_kernel<<<blocks, TILE, 0, st>>>((const int*)tables, a, n_tiles);
  return (int)cudaGetLastError();
}

// The child rows of nested emitter e for its m ranks, on `stream`: out is
// [child_rows][m] (the active fields' order); frame FRAME_WORDS host floats;
// (k0, k1) = fold_in(frame_key, 1000 + e); n_draws uniform rows. Parents:
// fetch mode parent_vals [n_parent][m] by rank; cum mode cum [n] and
// parent_planes, a host array of n_parent device planes [n]. record and
// alive (a ring hybrid frame; else null): the emitter's NS record, whose
// NS_DROPPED counts the children whose window slot is alive. Returns the
// cudaError_t of the launch.
int bf_nested_child_rows(const void* tables, int e, const float* frame, uint32_t k0, uint32_t k1,
                         const void* parent_vals, const void* cum, void* const* parent_planes, int n_parent,
                         void* record, const void* alive, void* out, int n_draws, int n, int m, void* stream) {
  if (n <= 0 || m <= 0 || e < 0 || e >= MAX_E || (n_parent != 6 && n_parent != 10) || n_draws < 8 ||
      n_draws > 12 || (parent_vals == nullptr) == (cum == nullptr) || (record != nullptr && alive == nullptr))
    return (int)cudaErrorInvalidValue;
  ChildArgs a;
  a.parent_vals = (const float*)parent_vals;
  a.cum = (const int*)cum;
  for (int k = 0; k < MAX_FETCH; ++k)
    a.planes[k] = (cum != nullptr && k < n_parent) ? (const float*)parent_planes[k] : nullptr;
  a.n_parent = n_parent;
  a.rec = (int*)record;
  a.alive = (const uint8_t*)alive;
  a.out = (float*)out;
  for (int i = 0; i < FRAME_WORDS; ++i) a.frame[i] = frame[i];
  a.k0 = k0;
  a.k1 = k1;
  a.e = e;
  a.n = n;
  a.m = m;
  a.n_draws = n_draws;
  nested_child_rows_kernel<<<(m + TILE - 1) / TILE, TILE, 0, (cudaStream_t)stream>>>((const int*)tables, a);
  return (int)cudaGetLastError();
}

const char* bf_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
