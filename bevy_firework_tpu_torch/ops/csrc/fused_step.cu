// Fused particle step for NVIDIA Hopper (sm_90a): emission cadence, ring or
// dead-rank claim, spawn init from Philox, age cull, move, the collision
// narrow phase (7 collider kinds, up to 4 bounce substeps,
// destroy-on-collision), scene force fields, linear drag, quaternion +
// angular drag, and optionally the destroyed-particle dump plane, the f32
// or f16 render pack and the frame's stats (AABB and counts), for U <= 8 frames
// per launch, for one pool or for a fleet of S pools of one archetype in
// one launch; and for archetypes with nested emitters, the nested stage
// (the cadence pass and the child rows from threefry draws, one launch per
// nested emitter) and the child merge into the step (one frame per
// launch), with the next frame's cadence counts folded into the step of a
// chain's frame.
//
// Replaces: bevy_firework_tpu/ops/fused_step.py `_make_kernel` (:913) as run
// by `_run_fused_kernel` (:1793) with kernel_spawn on, ring or dead-rank
// claims, colliders, force fields, the dump, kernel stats, the nested merge
// the fleet grid (`fused_step_fleet` :2358, grid=(S, tiles) :2031) and the
// sharded claims (`fused_step` :2152-2198; kernel :1127-1149, :1234-1238,
// :1301-1307): its main-path block (:1162-1521),
// its render-pack block (:1523-1561, f32 and f16 modes), its collision narrow phase
// `_collide_tile` (:349) with `_ray_kind` (:309), its dead-rank claim
// (`_prefix_exclusive` :173 with the SMEM `dead_carry`, :1142-1149,
// :1323-1333) with the alive plane in and out (:1023-1026, :1563-1564), its
// force-field block (`force_fields.field_accel`, used :1462-1472), its dump
// plane (:1567-1576), its kernel-stats block (:1580-1618), its nested
// child merge (:1172-1227, fed by `fused_step_hybrid` :2445) and its nested
// fold epilogue (:1620-1701; launch plumbing :1893-1905, :1994-2027); and
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
//    sub-frames into shared memory (as every TPU tile recomputes it in SMEM),
//    from inputs that warp 0 stages first, one word per lane (the slot's
//    frame row and seeds, each emitter's carry and its row's cadence words),
//    so their load latencies overlap instead of chaining in thread 0. The
//    carry's chain of IEEE divisions, U sub-frames long, is the launch's
//    fixed cost (5.1 us of main_100k's 13 at U = 8 on an H100: PERF.md §6),
//    so a U > 1 launch of the solo main path (or its stats twin) of up to
//    32 emitters runs an instantiation of its own (fused_step_kernel_warp)
//    that computes it on warp 0's lanes (warp_cadence): each lane's carry
//    in registers, a sub-frame's active flag and on-demand queue by warp
//    votes, its cumulative spawn windows by a warp scan. Scalar state is
//    read from the *_in buffers and written once, by block 0, to distinct
//    *_out buffers, so no block can read a value already advanced.
//  * Claims: lane g is claimed in sub-frame u when dead and its rank is below
//    the sub-frame's total spawn count; the emitter is the one whose
//    cumulative window holds the rank. Ring archetypes (deaths only by age)
//    rank by ring distance ((g - cursor_u) mod N): no scan. Destroy-on-
//    collision archetypes (U = 1) rank by dead-slot count: the TPU kernel
//    carried it across its in-order grid in SMEM. Here a solo launch (kernel
//    row 4) takes each tile's dead count of its alive plane, which the
//    launch that wrote the plane counted after its frame (one
//    __syncthreads_count per tile, a run-time branch): while warp 0 runs
//    the prologue, warps 1-7 sum the counts before each of the block's
//    tiles into one bin per tile (a warp per bin, its lanes striding the
//    counts), and per tile the block adds its bin to a running base and a
//    block-local ballot scan. The tiles stay strided over the grid:
//    contiguous ranges per block, which need one sum per block, measured
//    slower, since the live lanes of a dead-rank pool gather in its first
//    tiles and a few blocks then ran them all (PERF.md §6). So a chain of
//    destroy frames is one launch a frame; the first frame, or a plane
//    edited since, is counted first (dead_count_kernel, the seed).
//    Fleet and hybrid launches keep two small kernels before the step
//    (dead_count_kernel, tile_scan_kernel: each tile's exclusive offset).
//  * Collision: per lane, one loop over the colliders in table order with a
//    strict `dist < best` (the first of tied colliders wins, as in the XLA
//    path and the TPU kernel's (dist, index) tie-break); the collider rows
//    and each hull's own plane rows sit in shared memory, loaded once per
//    block, or past SMEM_COLLIDER_WORDS are read in place (warp-uniform
//    addresses); unrotated colliders skip the quaternion rotations, and
//    unrotated cuboids share the substep's reciprocals of the ray
//    direction. The TPU's looped narrow phase with its broad phase
//    (`_collide_tile` :452-563) becomes a per-warp broad phase at every
//    collider count (the TPU unrolls its tests below LOOP_MIN_COLLIDERS,
//    :440-451; on this card that per-lane form was no faster at 1-4
//    colliders): the substep loop is warp-uniform, the warp's active lanes
//    fold a box and a reach by shuffles, and a collider no lane can reach
//    is skipped by the whole warp (collide). Its (kind, rotation) grouping
//    of the colliders was a Mosaic measure and is not carried over: a
//    warp's lanes test one collider at a time, so the kind switch is
//    warp-uniform. The substep's ray, position and velocity wait in shared
//    memory through the collider loop, so the ray tests' IEEE chains run
//    at 3 blocks per SM without spilling.
//  * Randomness: Philox-4x32-10, key (seed_u, 0), counter (global lane, block, 0, 0),
//    uniforms from the top 24 bits, draw order shape 0-2, velocity 3-5,
//    radial 6, scale 7, then lifetime, then angular velocity. The torch
//    version in bevy_firework_tpu_torch/prng.py gives the same bits.
//  * Force fields: the scene's field records sit in a device buffer (one
//    copy per edited table) and are staged once per block in shared memory
//    (past SMEM_FIELD_WORDS read in place); each surviving lane evaluates
//    them at its post-move position and adds them, weighted by its type's
//    opt-in, to the type's acceleration before drag (the plain version's op
//    order). A lane on a field's singular locus gets 0 from it by a select.
//    The TPU unrolled its field loop on the static tuple of kinds; here the
//    kinds are a run-time loop with a warp-uniform switch, and the block is
//    bound by its instructions (IEEE sqrt and division, nine cosf per
//    turbulence field, each record word a load): the values every lane
//    computed alike (strength * active, 1 / radius) come packed in the
//    record, whose rows are read by one 128-bit load each; a turbulence
//    field computes an octave's three cosine arguments first and their
//    cosines on a straight line (cos_fast: cosf's own fast path, written
//    out with adds in place of its two conversions, for arguments below its
//    slow path's bound), so the three chains overlap. The field
//    instantiations keep the lane's fields in registers, at a cap of
//    FIELD_MAX_REGISTERS.
//  * Dump plane: u8, the last sub-frame's `alive after spawn && !survivor`
//    gated by the type's destroyed handler; written when the launch passes
//    it (dump archetypes step one frame per launch).
//  * Stats: the TPU carried its SMEM stat rows across its in-order grid;
//    CUDA blocks run concurrently, so each thread folds its lanes (min, max
//    and the alive count over the last sub-frame's survivors) into its row
//    of shared memory, each warp counts its survivors per type (a ballot per
//    type), and each block reduces these by shuffles into one row that it
//    commits by atomics into the slot's accumulator: sums for the counts,
//    an integer max on an order-preserving key of each AABB word (NaN past
//    both ends, so it wins as the plain min/max keep it). The last block to
//    commit (an atomic ticket after __threadfence) decodes the 7 + T words
//    into the output row and zeroes them and the ticket, so the accumulator
//    is persistent scratch (one per stream in the wrapper) and a launch
//    allocates and fills nothing for it. Integer max and sums are exact in
//    any order, so the row equals the plain reductions.
//  * Occupancy: a launch's grid is one resident wave of its instantiation
//    (the SMs times cudaOccupancyMaxActiveBlocksPerMultiprocessor, asked
//    once per instantiation), its blocks striding the fixed tiles: a solo
//    launch takes the wave, a fleet launch an equal share per slot.
//    Registers are capped per instantiation (__maxnreg__ on the kernel) so
//    the main path and the ring stats run 4 blocks per SM, and the field
//    block, the narrow phase and the other stats 3. Through the narrow
//    phase (and the field block beside the stats) only their inputs stay
//    live: position and velocity ride their in/out registers and the lane's
//    other ten fields wait in shared memory.
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
//    A hybrid frame without colliders or fields (up to 32 emitters) runs
//    instantiations of its own (fused_step_kernel_merge<ring, stats>): no
//    narrow phase or field block, so none of their registers, shared
//    memory or inert lanes; capped at 64 registers, 4 blocks per SM, so at
//    131072 lanes (512 tiles) one wave runs every tile at once; its
//    prologue's cadence, the merge records and the dead-rank base on warp
//    0's lanes (warp_cadence). Frames with colliders or fields run
//    fused_step_kernel's four merge instantiations (thread 0's cadence).
//    fused_step_kernel_merge ends in a latch: each block adds its vote (a
//    lane lives after the frame) and its ticket in one 64-bit atomic, and
//    the block with the last ticket writes the any-alive word, the
//    finished event and the new finished_notified (step.finished_latch's
//    booleans); on the ring the launch writes the post-frame alive plane
//    (age < life). The frame's epilogue then runs none of PyTorch's
//    comparisons and reductions for them (a fence between a vote and a
//    ticket cost the launch ~1 us, PERF.md §6). fused_step_kernel's merge
//    instantiations leave them to the epilogue.
//  * Nested fold (kernel row 10; ring archetypes, every frame of a folded
//    chain but its last): the TPU epilogue computed the next frame's whole
//    cadence pass (anchors, total, parent fetch) on the post-frame tile,
//    carrying the exact count cumsum across its in-order grid in SMEM. CUDA
//    blocks run concurrently, so the epilogue does the count kernel's share
//    alone: per merge record each lane's parent count on the post-frame
//    state in registers (nested_lane's formula; the gate the emitter's
//    post-frame enabled bit), warp sums into one half of a double-buffered
//    row and one barrier per tile; fused_step_kernel_merge's latch writes
//    the next frame's NS buffer (NS_ANY from its vote, the records zero),
//    fused_step_kernel's merge sets NS_ANY per tile in a zeroed buffer;
//    the next frame's nested stage reduces those counts in place of
//    counting and waiting at its grid barrier (bf_nested_stage's carry). Epilogue plus stage compute the
//    TPU epilogue's outputs: the anchors, NS_TOTAL and the parents of the
//    child rows. It is a run-time branch of the ring's merge
//    instantiations (a.n_fold), no new instantiation.
//  * Shards (kernel row 11; solo ring and dead-rank launches): a pool split
//    over the particle axis runs one launch per shard with three launch
//    arguments, its lane base, the global capacity and its dead offset
//    (0, n, 0 unsharded). The global lane lane_base + g is the ring rank's
//    base ((lane_base + g - cursor), plus global_n when negative) and the
//    Philox counter; thread 0's cursor wraps at global_n; the dead rank
//    starts from dead_offset, or from a device word the launch reads in its
//    prologue (the JAX kernel's SMEM dyn_ref[0, 13], :1142-1149): a shard's
//    dead offset is then the exclusive prefix of the shards' carried dead
//    totals, gathered and summed on the device, and no host value waits on
//    the card before a dead-rank shard's launch. So each shard claims and draws what the
//    unsharded pool does on its lanes, random draws included. The TPU made
//    the global capacity a compile-time constant because its per-lane ring
//    modulo was a division; here the rank needs no division (one compare
//    and add), and thread 0's cursor update divides once per sub-frame, so
//    the three are run-time values of every solo instantiation. Fleet and
//    merge launches stay unsharded (the JAX package's :1828-1829).
//  * Fleets (kernel row 7): the slot is blockIdx.y and a block never spans
//    two slots. The TPU's grid (S, tiles) ran one tile per grid step; here
//    the slots share one resident wave (wave / S blocks each, striding the
//    slot's tiles), so a block runs the prologue once for several tiles.
//    Each slot reads its own table (tab_stride apart, or one shared),
//    scalars, frame row, field records and seeds, and offsets
//    every plane by slot * n; Philox counts the lane within the slot and
//    uses the slot's seed, the dead-rank offsets restart at each slot, and
//    each slot's stats rows have their own ticket and output row. So slot
//    s draws, claims and reduces exactly what a solo launch of its pool
//    does, and the fleet equals S solo launches bit for bit. Frame rows and
//    field records of a fleet live in a device buffer the host rewrites
//    only when they change; the seeds, new every frame, ride the launch
//    arguments ([slot][u], at most SEED_WORDS per launch), or device words
//    (a captured chain's, below). The fleet has
//    its own instantiations (kFleet): as a run-time index the slot cost
//    the solo main path a register, or 6.5% of its U = 8 launch time once
//    trimmed back (frame operands in shared memory instead of the launch
//    arguments), so solo launches compile as before the slot axis.
//  * Captured chains (ops/chain_graph.py, the JAX package's one-dispatch
//    chains): a CUDA graph freezes a launch's arguments, so a launch may
//    take its frame row and seeds (the nested stage its key and frame row)
//    as device words, which a replay rewrites before it runs; warp 0
//    stages them, or the by-value arguments, into shared memory in the
//    prologue (one path: the same bits either way; a solo launch reads them
//    volatile at each use, as it read its arguments, so nothing more is
//    held in its 63 registers). The unfolded nested stage launches
//    cooperatively through cudaLaunchKernelExC's attribute, which stream
//    capture records as a cooperative kernel node; the shared-memory
//    opt-in is made once per kernel and size, so a recorded launch makes no
//    attribute call.
//  * The kernel is a template over the claim kind, the narrow phase, the
//    force fields, the stats, the merge and the fleet (thirty-six
//    instantiations, chosen at launch: the four merge ones set the narrow
//    phase and field flags and gate them by the launch's counts; the
//    sixteen fleet ones leave the merge out; beside them the two of
//    fused_step_kernel_warp and the four of fused_step_kernel_merge), so
//    the main path's kernel carries none of their registers, barriers or
//    shared memory.
//  * Spawner structure (emitter/type counts, pacing kinds, curve kinds and
//    knot counts, elision flags, collision types) and all
//    parameters come from one small device table read at run time, sized
//    by its emitters, types and knots (its header holds the row offsets);
//    branches on it are warp-uniform. The arrays those counts size (the
//    cadence windows, the merge records, the per-type counts) live in
//    dynamic shared memory. The table's and the collider table's layouts,
//    the field slots, the frame row, the kind enumerations and the narrow
//    phase's float constants are defined once, in ops/table_layout.py; the
//    build generates "table_layout.h" from it, so this file states none of
//    them.
//
// Files: fused_step_kernel.cuh holds the launch arguments, the device
// helpers and the step kernel template; step_ring.cu, step_dead_rank.cu,
// step_fleet_ring.cu, step_fleet_dead_rank.cu and step_merge.cu each
// instantiate one share of it (solo or fleet launches, ring or dead-rank
// claim, and hybrid frames), so the build
// compiles the shares in parallel; this file holds the claim's count and
// scan kernels, the nested stage and every launcher.
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
// plus 36 B per lane when the f32 render pack is on (24 B, or 32 B with
// live rotation, for the f16 record), plus 2 B (alive in and out)
// on the dead-rank claim, plus 1 B for the dump plane. Arithmetic per
// lane-frame is a few dozen flops outside spawn lanes; spawn lanes add three
// Philox blocks and the samplers' sinf/cosf; colliding lanes add up to 4
// substeps x C ray tests (the tests of the colliders their warp's box
// keeps), which at C = 8 hulls makes the step
// arithmetic-bound; a turbulence field adds 9 cosf and ~80 flops per lane
// and sub-frame, the other kinds ~25 flops each. The stats add the scale
// curve per survivor, a block reduction and 7 + T atomics per block.

#include <mutex>
#include <vector>

#include "fused_step_kernel.cuh"

namespace {

// ---- dead-rank claim (replaces the JAX kernel's _prefix_exclusive + SMEM dead_carry) ----
// The TPU carried the dead count across tiles in SMEM because its grid runs
// in order; CUDA blocks do not. A solo launch reduces carried per-tile
// counts itself (see Claims above); dead_count_kernel seeds them. Fleet and
// hybrid launches count -> scan -> apply: dead_count_kernel writes each
// TILE-lane tile's dead count, tile_scan_kernel (one block) scans them into
// exclusive tile offsets, and the step kernel adds its tile's offset to a
// block-local exclusive rank.

// Both take a slot axis (fleet launches): grid.y (count) or grid.x (scan)
// is the slot, whose n lanes and n_tiles tiles follow the previous slot's,
// so each slot's offsets restart at 0 as a solo claim over its pool.
__global__ void __launch_bounds__(TILE) dead_count_kernel(const uint8_t* __restrict__ alive, int* __restrict__ counts,
                                                          int n, int n_tiles) {
  alive += (size_t)blockIdx.y * n;
  counts += (size_t)blockIdx.y * n_tiles;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int g = tile * TILE + threadIdx.x;
    const int c = __syncthreads_count(g < n && alive[g] == 0);
    if (threadIdx.x == 0) counts[tile] = c;
  }
}

__global__ void __launch_bounds__(1024) tile_scan_kernel(const int* __restrict__ counts, int* __restrict__ offsets,
                                                         int n_tiles) {
  __shared__ int s_warp[32];
  counts += (size_t)blockIdx.x * n_tiles;
  offsets += (size_t)blockIdx.x * n_tiles;
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

// ---- nested emission: the nested stage (kernel rows 8 and 9b) ----
// Replaces bevy_firework_tpu/ops/fused_step.py `_make_nested_cadence_kernel`
// (:683, called by `nested_cadence_pass` :805/:866) and the child stage of
// bevy_firework_tpu/step.py `_nested_spawn` (:411-453, composed XLA there):
// one launch per nested emitter and hybrid frame (nested_stage_kernel).
// The TPU carried the count cumsum across its in-order tiles in SMEM; CUDA
// blocks run concurrently, so an unfolded launch is cooperative (its
// blocks resident together, at most one wave) and each block takes a
// contiguous range of tiles: it counts its tiles' parents and publishes
// their sum, draws the parent-free parts of its share of the M child ranks
// (threefry uniforms and the samplers; each rank's row as past the total
// goes out at once), meets the others at one grid barrier, reduces the
// sums before its range (its exclusive prefix) and all of them (the
// total), and walks its tiles in order: a block scan per tile, the anchors
// (and the cum where asked), and the rows of the tile's rank window [c0,
// min(c0 + tile count, M)), spread over the threads (a rank's parent by a
// search over the block's inclusive scan in shared memory, its fields read
// in place, its parts read back). A folded frame's tile counts come from
// the previous step launch's fold epilogue (kernel row 10): its launch
// reduces those, with no count, no barrier and the draws in line, as its
// own instantiation, on up to two waves of blocks. Ranks from the total
// to M take the ring's parent
// values 0, or on dead-rank archetypes lane n - 1 (the search of
// step.nested_parents clamps there); block 0 writes the NS record. The
// barrier's arrival count and generation live in per-stream scratch that
// it leaves ready for the next launch; nothing is filled per launch and
// nothing syncs with the host. A single-pass scan with decoupled look-back
// (one tile per block, tiles by an atomic ticket) measured slower at 512
// and 5120 tiles (PERF.md §6): its per-block chain of ticket, spins
// and fences did not hide. The TPU's exact MXU row fetch
// (`_exact_row_fetch`, :663) and chunked one-hot search (:771-800) were
// Mosaic workarounds: a direct indexed load replaces them.
// Bound on this card: the launch, its barrier and the chains of one tile
// after another in a block (an unfolded launch at 5120 tiles walks ~10
// per block, 32% slower than the count, scan and apply chain it
// replaced; launch bounds of 6 and 8 blocks per SM spilled and measured
// slower, PERF.md §6). At 131072 lanes the stage moves ~3 MB (alive,
// ptype, age and the anchor in, the anchor out, the parents and child rows
// of M ranks), ~1 us at 3.35 TB/s.

struct NestedArgs {
  const uint8_t* alive;            // pre-spawn alive plane
  const int* ptype;                // null: single type
  const float* age;
  const float* lifetime;           // null: the table's constant
  const float* le_in;              // this emitter's last_emitted row
  const uint8_t* gate;             // the emitter's gate (one byte)
  float* le_out;                   // the advanced anchors (may be le_in)
  int* cum;                        // the inclusive count cumsum [n], or null
  const int* carry;                // a folded frame's per-tile counts, or null: counted here
  int* tile_counts;                // the count kernel's per-tile counts (a folded chain's seed)
  int* any_alive;                  // NS_ANY, set to 1 where a lane lives (null: not written)
  const float* planes[MAX_FETCH];  // parent planes [n] (nested_parent_fields order)
  int n_parent;
  float* fetch_out;                // the parent values by rank [n_parent][m] (0 from the total on), or null
  float* child;                    // the child rows [child_rows][m], or null
  float* parts;                    // an unfolded launch's child parts [CHILD_PARTS][m], drawn before its barrier
  const float* parent_vals;        // a child-rows launch alone: the parents by rank [n_parent][m] ...
  const int* cum_in;               // ... or the cum [n] whose search gives them
  const int* start_in;             // the window start (null: 0)
  const int* dead_counts;          // dead-rank archetypes: the claim's tile counts and offsets
  const int* dead_offsets;
  int* rec;                        // this emitter's NS record, or null
  float frame[FRAME_WORDS];
  uint32_t k0, k1;                 // fold_in(frame_key, 1000 + e)
  // device words in place of `frame` and (k0, k1) (a captured chain's,
  // whose replays copy them in): FRAME_WORDS floats and 2 words; null: the
  // by-value arguments above
  const float* frame_dev;
  const uint32_t* key_dev;
  int n_draws;
  unsigned* barrier;               // [2]: the grid barrier's arrivals (0 between launches) and generation
  int* block_sums;                 // [gridDim.x] each block's parent count
  int e, n, m, n_tiles, tiles_per_block, ring;
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
  const int row = tabi(tab, H_EM_AT) + a.e * EM_STRIDE;
  const bool alive = a.alive[g] != 0;
  l.life = a.lifetime ? a.lifetime[g] : tabf(tab, H_CONST_LIFE_VAL);
  l.base_le = alive ? a.le_in[g] : __int_as_float((int)0xff7fffffu);  // lazy reset to f32::MIN
  l.pm = alive && *a.gate != 0;
  if (a.ptype) l.pm = l.pm && a.ptype[g] == tabi(tab, row + EM_TARGET);
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

// The seed of a folded chain (kernel row 10's first frame): each tile's
// parent count into tile_counts, NS_ANY where a lane lives.
__global__ void __launch_bounds__(TILE) nested_count_kernel(const int* __restrict__ tab, NestedArgs a, int n_tiles) {
  __shared__ int s_warp[TILE / 32];
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

// The grid barrier of a cooperative launch (every block resident): thread
// 0 of each block arrives on bar[0] after its writes; the last to arrive
// zeroes it and bumps the generation bar[1], on which the others wait.
__device__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = *(volatile unsigned*)(bar + 1);
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*(volatile unsigned*)(bar + 1) == gen) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
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

// Child rank r's parent-free parts c (CHILD_PARTS words): the uniforms
// uniform(fold_in(frame_key, 1000 + e), (n_draws, M)) at flat index i * M
// + r (threefry-2x32 of (hi, lo) of the index, the xor of its words, the
// top 23 bits as a float in [1, 2) minus 1), then the samplers of the
// child's init (step.nested_child_rows' op order).
// The launch's frame word i and key word k: its arguments, or its device
// words where it gives them.
__device__ __forceinline__ float frame_word(const NestedArgs& a, int i) {
  return a.frame_dev != nullptr ? a.frame_dev[i] : a.frame[i];
}
__device__ __forceinline__ uint32_t key_word(const NestedArgs& a, int k) {
  return a.key_dev != nullptr ? a.key_dev[k] : (k == 0 ? a.k0 : a.k1);
}

__device__ __forceinline__ void child_parts(const int* tab, const NestedArgs& a, int r, float* c) {
  float u[12];
  const uint32_t k0 = key_word(a, 0), k1 = key_word(a, 1);
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    u[i] = 0.0f;
    if (i < a.n_draws) {
      uint32_t b0, b1;
      threefry2x32(k0, k1, 0u, (uint32_t)(i * a.m + r), &b0, &b1);
      u[i] = __int_as_float((int)(((b0 ^ b1) >> 9) | 0x3f800000u)) - 1.0f;
    }
  }
  const int row = tabi(tab, H_EM_AT) + a.e * EM_STRIDE;
  const int trow = TY_AT + tabi(tab, row + EM_PINDEX) * TY_STRIDE;
  float offx, offy, offz, ivx, ivy, ivz;
  shape_point(tab, row + EM_SHAPE, u[0], u[1], u[2], &offx, &offy, &offz);
  randvec3(tab, row + EM_IVEL, u[3], u[4], u[5], &ivx, &ivy, &ivz);
  const float rlo = tabf(tab, row + EM_RADIAL_LO), rhi = tabf(tab, row + EM_RADIAL_HI);
  const float radial = rlo + (rhi - rlo) * u[6];
  const float l2 = offx * offx + offy * offy + offz * offz;
  const float inv = l2 > 0.0f ? 1.0f / sqrtf(l2) : 0.0f;
  c[0] = offx;
  c[1] = offy;
  c[2] = offz;
  c[3] = ivx;
  c[4] = ivy;
  c[5] = ivz;
  c[6] = offx * inv * radial;
  c[7] = offy * inv * radial;
  c[8] = offz * inv * radial;
  float avx = 0.0f, avy = 0.0f, avz = 0.0f;
  if (tabi(tab, H_ELIDE_ROT) == 0) randvec3(tab, row + EM_IANG, u[9], u[10], u[11], &avx, &avy, &avz);
  c[9] = avx;
  c[10] = avy;
  c[11] = avz;
  const float slo = tabf(tab, trow + TY_ISCALE_LO), shi = tabf(tab, trow + TY_ISCALE_HI);
  c[12] = (slo + (shi - slo) * u[7]) * frame_word(a, FR_MOD_SCALE);
  const float llo = tabf(tab, trow + TY_LIFE_LO), lhi = tabf(tab, trow + TY_LIFE_HI);
  c[13] = llo + (lhi - llo) * u[8];
}

// The child's row v (CHILD_SLOTS words) from its parts c and its parent's
// fields p (nested_parent_fields order).
__device__ __forceinline__ void child_finish(const int* tab, const NestedArgs& a, const float* c, const float* p,
                                             float* v) {
  const bool elide_rot = tabi(tab, H_ELIDE_ROT) != 0;
  const int row = tabi(tab, H_EM_AT) + a.e * EM_STRIDE;
  float wvx = c[3], wvy = c[4], wvz = c[5];
  const int pv = a.n_parent - 3;  // parent velocity follows position [and rotation]
  if (!elide_rot) quat_rotate(p[3], p[4], p[5], p[6], c[3], c[4], c[5], &wvx, &wvy, &wvz);
  const float spd = frame_word(a, FR_MOD_SPEED), inh = tabf(tab, row + EM_INHERIT);
  v[0] = p[0] + c[0];
  v[1] = p[1] + c[1];
  v[2] = p[2] + c[2];
  v[3] = spd * (wvx + c[6]) + inh * p[pv];
  v[4] = spd * (wvy + c[7]) + inh * p[pv + 1];
  v[5] = spd * (wvz + c[8]) + inh * p[pv + 2];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[6 + q] = elide_rot ? 0.0f : tabf(tab, row + EM_INIT_ROT + q);
  v[10] = c[9];
  v[11] = c[10];
  v[12] = c[11];
  v[13] = c[12];
  v[14] = 0.0f;
  v[15] = c[13];
}

// Child rank r's row v from its parent's fields p.
__device__ __forceinline__ void child_row(const int* tab, const NestedArgs& a, int r, const float* p, float* v) {
  float c[CHILD_PARTS];
  child_parts(tab, a, r, c);
  child_finish(tab, a, c, p, v);
}

// rank r's row into the child buffer, the archetype's rows in order
__device__ __forceinline__ void store_child(const int* tab, const NestedArgs& a, int r, const float* v) {
  const bool elide_rot = tabi(tab, H_ELIDE_ROT) != 0, const_life = tabi(tab, H_CONST_LIFE) != 0;
  float* o = a.child + r;
  int k = 0;
#pragma unroll
  for (int i = 0; i < CHILD_SLOTS; ++i)
    if ((i < 6 || i > 12 || !elide_rot) && (i < 15 || !const_life)) o[(k++) * a.m] = v[i];
}

// Tile `tile` from its exclusive prefix c0: the lanes' cadence, the
// anchors (and the cum), and the child rows (or the parent values) of its
// ranks, their parts drawn before the barrier where kBarrier. Returns the
// tile's parent count (all threads call it).
template <bool kBarrier>
__device__ __forceinline__ int stage_tile(const int* tab, const NestedArgs& a, int tile, int c0, int* s_incl,
                                           int* s_warp) {
  const int g = tile * TILE + threadIdx.x;
  NestedLane l;
  l.count = 0;
  if (g < a.n) l = nested_lane(tab, a, g);
  int tile_total;
  const int incl = block_inclusive_scan(l.count, s_warp, &tile_total);
  s_incl[threadIdx.x] = incl;
  __syncthreads();
  if (g < a.n) {
    // deferral: only ranks below M materialise; a cut parent advances its
    // anchor by what was emitted (cadence.emission_next_last's op order)
    const int row = tabi(tab, H_EM_AT) + a.e * EM_STRIDE;
    const float off_s = tabf(tab, row + EM_OFF_START), off_e = tabf(tab, row + EM_OFF_END);
    const float between = (off_e - off_s) / tabf(tab, row + EM_COUNT);
    const int cum = c0 + incl;
    const int emitted = min(cum, a.m) - min(cum - l.count, a.m);
    const float clamped = pmax(l.base_le / l.life, off_s);
    const float trunc = (clamped + (float)emitted * between) * l.life;
    if (a.le_out) a.le_out[g] = l.pm ? (emitted < l.count ? trunc : l.next_full) : l.base_le;
    if (a.cum) a.cum[g] = cum;
  }
  // ranks [c0, min(c0 + tile_total, M)), where their parents or rows are
  // written: a rank's parent is the first lane of the tile whose inclusive
  // count exceeds its rank in the tile
  const int r_end = (a.fetch_out || a.child) ? min(c0 + tile_total, a.m) : c0;
  const bool drops = a.ring && a.rec != nullptr && a.child != nullptr;
  int dropped = 0;
  const int start = drops && c0 < r_end ? (a.start_in ? *a.start_in : 0) : 0;
  for (int r = c0 + (int)threadIdx.x; r < r_end; r += TILE) {
    int lo = 0, hi = TILE - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_incl[mid] <= r - c0) lo = mid + 1;
      else hi = mid;
    }
    const int par = tile * TILE + lo;
    float p[MAX_FETCH];
#pragma unroll
    for (int k = 0; k < MAX_FETCH; ++k) p[k] = k < a.n_parent ? a.planes[k][par] : 0.0f;
    if (a.fetch_out) {
      for (int k = 0; k < a.n_parent; ++k) a.fetch_out[k * a.m + r] = p[k];
    }
    if (a.child) {
      float v[CHILD_SLOTS];
      if (kBarrier && a.parts) {  // drawn before the barrier, by another block
        float c[CHILD_PARTS];
#pragma unroll
        for (int k = 0; k < CHILD_PARTS; ++k) c[k] = __ldcg(a.parts + k * a.m + r);
        child_finish(tab, a, c, p, v);
      } else {
        child_row(tab, a, r, p, v);
      }
      store_child(tab, a, r, v);
    }
    // ring hybrid frames: a child whose window slot lives is dropped
    if (drops) dropped += a.alive[(int)(((long long)start + r) % a.n)] != 0;
  }
  if (drops) {
    dropped = __reduce_add_sync(0xffffffffu, dropped);
    if ((threadIdx.x & 31) == 0 && dropped) atomicAdd(a.rec + NS_DROPPED, dropped);
  }
  __syncthreads();  // s_incl is the next tile's
  return tile_total;
}

// The parent fields p of child rank r at or above the total (every rank of
// a child-rows launch alone, whose total is 0): ring, values 0;
// dead-rank, lane n - 1 (the search past the total, clamped into the
// pool); a child-rows launch alone, its given values or the search of its
// cum.
__device__ __forceinline__ void past_total_parent(const NestedArgs& a, int r, float* p) {
  int par = a.n - 1;
  if (a.cum_in) {  // the first lane whose cum exceeds r, clamped into the pool
    int lo = 0, hi = a.n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (a.cum_in[mid] <= r) lo = mid + 1;
      else hi = mid;
    }
    par = lo < a.n ? lo : a.n - 1;
  }
#pragma unroll
  for (int k = 0; k < MAX_FETCH; ++k) {
    p[k] = 0.0f;
    if (k < a.n_parent) {
      if (a.parent_vals) p[k] = a.parent_vals[k * a.m + r];
      else if (!a.ring || a.cum_in) p[k] = a.planes[k][par];
    }
  }
}

// Rank r at or above the total: its child row, or its parent values 0.
__device__ __forceinline__ void stage_past_total(const int* tab, const NestedArgs& a, int r) {
  if (a.fetch_out) {
    for (int k = 0; k < a.n_parent; ++k) a.fetch_out[k * a.m + r] = 0.0f;
    return;
  }
  float p[MAX_FETCH], v[CHILD_SLOTS];
  past_total_parent(a, r, p);
  child_row(tab, a, r, p, v);
  store_child(tab, a, r, v);
}

// One nested emitter's stage. Block b takes tiles [b * tiles_per_block,
// ...) of the n_tiles (none in a child-rows launch alone). kBarrier, an
// unfolded launch: it counts them, draws the ranks' parts and waits at the
// grid barrier for every block's sum; else a folded launch reduces the
// carried counts. Two instantiations: where one kernel held both, the
// parts' code cost the folded path 1.4 us at 131072 lanes (PERF.md §6).
template <bool kBarrier>
__global__ void __launch_bounds__(TILE) nested_stage_kernel(const int* __restrict__ tab, NestedArgs a) {
  __shared__ int s_incl[TILE];
  __shared__ int s_warp[TILE / 32];
  const int t0 = blockIdx.x * a.tiles_per_block;
  const int t1 = min(t0 + a.tiles_per_block, a.n_tiles);
  int before = 0, total = 0;
  if (a.n_tiles > 0) {
    int x_before = 0, x_all = 0;
    if (!kBarrier) {  // a folded frame: the carried counts before the range, and all
      for (int i = threadIdx.x; i < a.n_tiles; i += TILE) {
        const int v = __ldg(a.carry + i);
        x_all += v;
        if (i < t0) x_before += v;
      }
    } else {
      int sum = 0;
      bool alive = false;
#pragma unroll 4
      for (int tile = t0; tile < t1; ++tile) {
        const int g = tile * TILE + threadIdx.x;
        if (g < a.n) {
          sum += nested_lane(tab, a, g).count;
          alive = alive || a.alive[g] != 0;
        }
      }
      int block_sum;
      block_inclusive_scan(sum, s_warp, &block_sum);
      if (a.any_alive && __syncthreads_or(alive) && threadIdx.x == 0) *a.any_alive = 1;
      if (threadIdx.x == 0) a.block_sums[blockIdx.x] = block_sum;
      if (a.parts) {
        // the ranks' parent-free parts, spread over the blocks while the
        // counts gather; each rank's row as past the total (its parent
        // known) goes out now, and its window's block rewrites it after
        // the barrier
        const int per = (a.m + (int)gridDim.x - 1) / (int)gridDim.x;
        for (int i = threadIdx.x; i < per; i += TILE) {
          const int r = (int)blockIdx.x * per + i;
          if (r >= a.m) break;
          float c[CHILD_PARTS], p[MAX_FETCH], v[CHILD_SLOTS];
          child_parts(tab, a, r, c);
#pragma unroll
          for (int k = 0; k < CHILD_PARTS; ++k) a.parts[k * a.m + r] = c[k];
          past_total_parent(a, r, p);
          child_finish(tab, a, c, p, v);
          store_child(tab, a, r, v);
        }
      }
      grid_barrier(a.barrier);
      for (int i = threadIdx.x; i < (int)gridDim.x; i += TILE) {
        const int v = __ldcg(a.block_sums + i);
        x_all += v;
        if (i < (int)blockIdx.x) x_before += v;
      }
    }
    block_inclusive_scan(x_before, s_warp, &before);
    block_inclusive_scan(x_all, s_warp, &total);
  }
  int c0 = before;
  for (int tile = t0; tile < t1; ++tile) c0 += stage_tile<kBarrier>(tab, a, tile, c0, s_incl, s_warp);
  // the ranks from the total to M, TILE per block in turn (written before
  // the barrier where their parts were drawn)
  if ((a.child || a.fetch_out) && !(kBarrier && a.parts))
    for (int r = total + (int)(blockIdx.x * TILE + threadIdx.x); r < a.m; r += (int)(gridDim.x * TILE))
      stage_past_total(tab, a, r);
  if (blockIdx.x == 0 && threadIdx.x == 0 && a.rec) {
    // the emitter's scalars: total, children this frame, its claim window
    const int n_sp = min(total, a.m);
    const int start = a.start_in ? *a.start_in : 0;
    a.rec[NS_TOTAL] = total;
    a.rec[NS_N] = n_sp;
    a.rec[NS_EMITTER] = a.e;
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

// The field block's cos_fast against CUDA's cosf on every float whose bits
// lie in [lo, lo + n) and whose magnitude is below COS_FAST_BOUND: each
// mismatch adds one to *bad.
__global__ void __launch_bounds__(TILE) cos_fast_sweep_kernel(uint32_t lo, uint32_t n, unsigned long long* bad) {
  for (uint32_t k = blockIdx.x * blockDim.x + threadIdx.x; k < n; k += gridDim.x * blockDim.x) {
    const float x = __uint_as_float(lo + k);
    if (fabsf(x) < COS_FAST_BOUND && __float_as_uint(cos_fast(x)) != __float_as_uint(cosf(x))) atomicAdd(bad, 1ull);
  }
}

// No work: profile_step.py's launch floor (a launch's own device time).
__global__ void __launch_bounds__(TILE) empty_kernel() {}

// Blocks of `kernel` that fill the current device once at `smem` bytes of
// dynamic shared memory: its SMs times the blocks of TILE threads resident
// on one (cudaOccupancyMaxActiveBlocksPerMultiprocessor), asked once per
// (device, kernel, smem) and cached; ctypes calls run without the GIL, so a
// mutex guards the cache.
cudaError_t resident_wave(const void* kernel, size_t smem, int* wave) {
  struct Entry {
    int device;
    const void* kernel;
    size_t smem;
    int wave;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.device == device && e.kernel == kernel && e.smem == smem) {
      *wave = e.wave;
      return cudaSuccess;
    }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TILE, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  cache.push_back(Entry{device, kernel, smem, sms * per_sm});
  *wave = sms * per_sm;
  return cudaSuccess;
}

// Past DEFAULT_SMEM_BYTES of dynamic shared memory, `kernel` opts in to
// `smem` bytes on the current device (cudaFuncSetAttribute), once per
// (device, kernel) and size it grows to: a launch a captured chain records
// makes no attribute call (the chain's first, uncaptured, run made it).
cudaError_t opt_in_smem(const void* kernel, size_t smem) {
  if (smem <= (size_t)DEFAULT_SMEM_BYTES) return cudaSuccess;
  struct Entry {
    int device;
    const void* kernel;
    size_t smem;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  Entry* hit = nullptr;
  for (Entry& e : cache)
    if (e.device == device && e.kernel == kernel) hit = &e;
  if (hit != nullptr && hit->smem >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (hit != nullptr) hit->smem = smem;
  else cache.push_back(Entry{device, kernel, smem});
  return cudaSuccess;
}

// Blocks of TILE threads of `kernel` resident on one SM of the current
// device at smem_bytes of dynamic shared memory, or minus the cudaError_t.
int blocks_per_sm(const void* kernel, int smem_bytes) {
  {
    cudaError_t err = opt_in_smem(kernel, (size_t)smem_bytes);
    if (err != cudaSuccess) return -(int)err;
  }
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TILE, (size_t)smem_bytes);
  return err == cudaSuccess ? per_sm : -(int)err;
}

}  // namespace

// The step kernel's instantiations, one source file each (step_*.cu):
// solo or fleet launches, ring or dead-rank claim, and hybrid frames.
extern "C" const void* bf_step_kernel_ring(int collide, int fields, int stats);
extern "C" const void* bf_step_kernel_dead_rank(int collide, int fields, int stats);
extern "C" const void* bf_step_kernel_fleet_ring(int collide, int fields, int stats);
extern "C" const void* bf_step_kernel_fleet_dead_rank(int collide, int fields, int stats);
extern "C" const void* bf_step_kernel_ring_warp(int stats);
extern "C" const void* bf_step_kernel_merge(int ring, int lean, int stats);

extern "C" {

// Launch one U-frame step on `stream`. Pointer arrays live on the host and
// hold device pointers: field_in/field_out have N_FIELDS slots (null for an
// elided field), scal_in/scal_out 5 (time_in_cycle f32[E], last_emission
// f32[E], enabled u8[E], manual_queued i32, ring_cursor i32); render_mode
// 0 (render_out null), PACK_F32 (render_out N_RENDER f32 planes) or
// PACK_F16 (render_out N_RECORD f16 planes by contract column, the
// quaternion's null when rotation is elided). tables is the spawner table of n_emitters emitters and
// n_types types (pack_tables). colliders is the collider table of
// n_colliders rows and collider_words words (pack_colliders; n_colliders 0:
// no narrow phase). Non-ring archetypes (U = 1) pass the alive planes (u8)
// and either the tile offsets bf_dead_rank_offsets wrote or, on a solo
// launch, dead_counts: the dead lanes of each tile of alive_in
// (ceil(n / TILE) ints: the previous launch's dead_next, or the count
// kernel's seed); a solo one may pass dead_next (ceil(n / TILE) ints,
// every word written: the same counts of alive_out, the next launch's
// dead_counts); ring archetypes pass nulls. frame is FRAME_WORDS host floats, seeds `unroll` host words (or
// null, where frame_dev and seeds_dev, device words, take their place: FRAME_WORDS floats, a solo launch's
// only, and [n_slots][unroll] words; a captured chain's launches pass them), fields
// n_fields FF_STRIDE records in device memory (n_fields 0: no force
// fields). dump_out is the u8 dump plane or null. stats_out (ST_TYPES +
// n_types words) or null; with it, stats_scratch holds ST_TYPES + n_types
// + 1 words that are 0 at launch (the launch leaves them 0: launches that
// share them must run in order, as on one stream).
// A hybrid frame of a nested archetype (U = 1) passes any_alive (one int,
// the pre-spawn flag), the nested scalars (NS_* records of n_merge
// emitters, each naming its emitter) and the child rows
// [n_merge][child_rows][merge_m]; other launches pass a null any_alive.
// A hybrid frame passes merge_kernel: 1 for fused_step_kernel_merge (no
// colliders, no fields, up to 32 emitters), 0 for fused_step_kernel's
// merge instantiations. With 1 it also passes latch_acc (2 int words of
// scratch, 8-byte aligned, 0 at launch, left 0; launches that share them
// run in order, as on one stream), latch_out (3 bytes: any lane alive
// after the frame, the finished event, the new finished_notified),
// notified_in (the pool's finished_notified byte) and on the ring
// alive_out (the post-frame alive plane, u8 [n]: age < life); other
// launches pass nulls and 0. A ring hybrid frame that folds the next
// frame's cadence counts (kernel row 10) passes n_fold = n_merge, fold_le
// (last_emitted [E][n] after this frame's cadence), fold_counts
// ([n_fold][ceil(n / TILE)] int, every word written) and fold_ns (the next
// frame's NS buffer, NS_AT + n_fold * NS_STRIDE words: 0, NS_ANY 1 where a
// lane lives after the frame; with merge_kernel 1 every word is written,
// with 0 the caller zeroes it); other launches pass 0.
// A fleet launch (kernel row 7) steps n_slots pools of n lanes each, of one
// archetype: every plane is [n_slots][n], the scalars [n_slots][E] or
// [n_slots], the tile offsets [n_slots][ceil(n / TILE)], the dump and
// render planes [n_slots][n], the stats row [n_slots][ST_TYPES + n_types]
// with stats_scratch [n_slots][ST_TYPES + n_types + 1]; tables holds one table per slot tab_stride words apart
// (0: one for all), seeds [n_slots][unroll] host words, and slot_rows
// (device, [n_slots][slot_words]) each slot's frame row and n_fields field
// records in place of frame and fields (which it ignores). A solo launch
// passes n_slots 1 and a null slot_rows. A shard of a pool split over the
// particle axis (kernel row 11; solo launches without a merge) passes its
// lane_base (the global index of its lane 0), global_n (the global pool's
// capacity: lane_base + n <= global_n, and the ring cursor below it) and
// dead_offset (the dead lanes of the shards before it), or in its place
// dead_offset_dev (a device int, read by the launch: no host value needed
// before it); every other launch passes 0, n, 0 and a null
// dead_offset_dev. Returns the cudaError_t of the launch (0 = success).
int bf_fused_step(const void* tables, const void* colliders, int n_colliders, int collider_words,
                  void* const* field_in, void* const* field_out, const void* ptype_in, void* ptype_out,
                  const void* alive_in, void* alive_out, const void* tile_dead_offset, void* const* scal_in,
                  void* const* scal_out, int render_mode, void* const* render_out, const float* frame,
                  const uint32_t* seeds, int unroll, int n, int n_emitters, int n_types, const void* fields,
                  int n_fields, void* dump_out, void* stats_scratch, void* stats_out,
                  const void* any_alive, const void* nested, const void* child, int n_merge, int merge_m,
                  int child_rows, const void* fold_le, void* fold_counts, void* fold_ns, int n_fold,
                  void* latch_acc, void* latch_out, const void* notified_in, int merge_kernel, int n_slots,
                  int tab_stride, const void* slot_rows, int slot_words, int lane_base, int global_n,
                  int dead_offset, const void* dead_counts, void* dead_next, const void* dead_offset_dev,
                  const void* frame_dev, const void* seeds_dev, void* stream) {
  const bool merge = any_alive != nullptr, fleet = slot_rows != nullptr;
  // the frame row: a solo launch's argument or device words, a fleet's slot rows; the seeds: arguments or words
  if ((fleet && frame_dev != nullptr) || (!fleet && frame == nullptr && frame_dev == nullptr) ||
      (seeds == nullptr && seeds_dev == nullptr))
    return (int)cudaErrorInvalidValue;
  if (lane_base < 0 || dead_offset < 0 || global_n < n || (long long)lane_base + n > global_n ||
      ((merge || fleet) && (lane_base != 0 || global_n != n || dead_offset != 0)))
    return (int)cudaErrorInvalidValue;
  // the carried claim and the dead offset's device word: solo dead-rank launches alone
  if ((dead_counts != nullptr || dead_next != nullptr || dead_offset_dev != nullptr) &&
      (alive_in == nullptr || merge || fleet))
    return (int)cudaErrorInvalidValue;
  if (unroll < 1 || unroll > MAX_U || n <= 0 || n_emitters < 1 || n_types < 1 || n_colliders < 0 ||
      collider_words < n_colliders * CO_STRIDE || (n_colliders > 0 && colliders == nullptr) || n_fields < 0 ||
      (n_fields > 0 && !fleet && fields == nullptr) || n_slots < 1 || n_slots * unroll > SEED_WORDS ||
      (long long)n_slots * n > 0x7FFFFFFFLL || tab_stride < 0 || (n_slots > 1 && !fleet) ||
      (fleet && slot_words < SL_FIELDS + n_fields * FF_STRIDE))
    return (int)cudaErrorInvalidValue;
  if (merge && (unroll != 1 || fleet || n_merge < 0 || (n_merge > 0 && (nested == nullptr || child == nullptr ||
                merge_m <= 0))))
    return (int)cudaErrorInvalidValue;
  if ((alive_in == nullptr) != (tile_dead_offset == nullptr && dead_counts == nullptr) ||
      (tile_dead_offset != nullptr && dead_counts != nullptr) || (alive_in != nullptr && unroll != 1) ||
      (alive_out == nullptr) != (alive_in == nullptr && merge_kernel == 0))
    return (int)cudaErrorInvalidValue;
  if (n_fold < 0 || (n_fold > 0 && (!merge || n_fold != n_merge || alive_in != nullptr || fold_le == nullptr ||
                                    fold_counts == nullptr || fold_ns == nullptr)))
    return (int)cudaErrorInvalidValue;
  const bool lean = merge_kernel != 0;
  if (lean != (latch_acc != nullptr) || lean != (latch_out != nullptr) || lean != (notified_in != nullptr) ||
      (lean && (!merge || n_colliders > 0 || n_fields > 0 || n_emitters > 32)))
    return (int)cudaErrorInvalidValue;
  if (stats_out != nullptr && stats_scratch == nullptr) return (int)cudaErrorInvalidValue;
  if ((render_mode != 0 && render_mode != PACK_F32 && render_mode != PACK_F16) ||
      (render_mode != 0) != (render_out != nullptr))
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
  a.col_words = collider_words;
  a.col_smem = n_colliders > 0 && collider_words <= SMEM_COLLIDER_WORDS;
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
  a.pack_render = render_mode;
  const int n_render = render_mode == PACK_F16 ? N_RECORD : render_mode == PACK_F32 ? N_RENDER : 0;
  for (int i = 0; i < N_RECORD; ++i) a.render[i] = i < n_render ? render_out[i] : nullptr;
  a.dump = (uint8_t*)dump_out;
  a.stats_acc = (unsigned*)stats_scratch;
  a.stats_out = (int*)stats_out;
  for (int i = 0; i < FRAME_WORDS; ++i) a.frame[i] = (fleet || frame == nullptr) ? 0.0f : frame[i];
  a.frame_dev = (const float*)frame_dev;
  a.fields = fleet ? nullptr : (const int*)fields;
  a.n_fields = n_fields;
  a.ff_smem = n_fields > 0 && n_fields * FF_STRIDE <= SMEM_FIELD_WORDS;
  a.slot_rows = (const int*)slot_rows;
  a.slot_words = slot_words;
  a.tab_stride = tab_stride;
  for (int i = 0; i < SEED_WORDS; ++i) a.seeds[i] = (seeds != nullptr && i < n_slots * unroll) ? seeds[i] : 0u;
  a.seeds_dev = (const uint32_t*)seeds_dev;
  a.unroll = unroll;
  a.n = n;
  a.lane_base = lane_base;
  a.global_n = global_n;
  a.dead_offset = dead_offset;
  a.E = n_emitters;
  a.T = n_types;
  a.any_alive = (const int*)any_alive;
  a.nested = (const int*)nested;
  a.child = (const float*)child;
  a.n_merge = merge ? n_merge : 0;
  a.merge_m = merge_m;
  a.child_rows = child_rows;
  a.fold_le = (const float*)fold_le;
  a.fold_counts = (int*)fold_counts;
  a.fold_ns = (int*)fold_ns;
  a.n_fold = merge ? n_fold : 0;
  a.latch_acc = (int*)latch_acc;
  a.latch_out = (uint8_t*)latch_out;
  a.notified_in = (const uint8_t*)notified_in;
  a.dead_counts = (const int*)dead_counts;
  a.dead_next = (int*)dead_next;
  a.dead_offset_dev = (const int*)dead_offset_dev;

  const bool collide = n_colliders > 0, with_fields = n_fields > 0, stats = stats_out != nullptr;
  const bool ring = alive_in == nullptr;
  // the solo main path at U > 1 with up to 32 emitters: the warp's cadence
  const bool warp = ring && !fleet && !collide && !with_fields && !merge && unroll > 1 && n_emitters <= 32;
  const void* kernel =
      warp    ? bf_step_kernel_ring_warp(stats)
      : merge ? bf_step_kernel_merge(ring, lean, stats)
      : fleet ? (ring ? bf_step_kernel_fleet_ring : bf_step_kernel_fleet_dead_rank)(collide, with_fields, stats)
              : (ring ? bf_step_kernel_ring : bf_step_kernel_dead_rank)(collide, with_fields, stats);
  // the tables' shared memory (the kernel's smem_layout with its flags: a
  // count of 0 stages nothing); past the default, the instantiation opts in
  const SmemLayout lay = smem_layout(unroll, n_emitters, a.n_merge, a.n_fold, stats ? n_types : 0,
                                     a.ff_smem ? n_fields * FF_STRIDE : 0, a.col_smem ? collider_words : 0);
  const size_t smem = (size_t)lay.words * sizeof(int);
  {
    cudaError_t err = opt_in_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
  }
  // one resident wave of the instantiation, its blocks striding the tiles:
  // a solo launch takes the whole wave, a fleet launch an equal share per
  // slot (at least one block; a launch holds at most SEED_WORDS slots)
  long long blocks = ((long long)n + TILE - 1) / TILE;
  int wave = 0;
  {
    cudaError_t err = resident_wave(kernel, smem, &wave);
    if (err != cudaSuccess) return (int)err;
  }
  if (fleet) wave = wave / n_slots > 1 ? wave / n_slots : 1;
  if (blocks > wave) blocks = wave;
  // a solo dead-rank launch's block sums the carried counts before each
  // of its tiles into one of CLAIM_BINS bins: past CLAIM_BINS tiles a
  // block, the grid takes more blocks than one wave
  if (!ring && !merge && !fleet) {
    const long long tiles = ((long long)n + TILE - 1) / TILE, least = (tiles + CLAIM_BINS - 1) / CLAIM_BINS;
    if (blocks < least) blocks = least;
  }
  const int* tab = (const int*)tables;
  void* params[] = {(void*)&tab, (void*)&a};
  cudaError_t err = cudaLaunchKernel(kernel, dim3((unsigned)blocks, (unsigned)n_slots), dim3(TILE), params, smem,
                                     (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The dead-rank claim's first two passes over the u8 alive planes of
// n_slots pools of n lanes ([n_slots][n]): per-tile dead counts into
// `counts` and their exclusive scan, restarting at each slot, into
// `offsets` (both int32 [n_slots][ceil(n / TILE)]), on `stream`; with a
// null `offsets` the count pass alone (a solo launch's carried claim, its
// seed). Returns the cudaError_t of the launches.
int bf_dead_rank_offsets(const void* alive, void* counts, void* offsets, int n, int n_slots, void* stream) {
  if (n <= 0 || n_slots < 1 || n_slots > 65535) return (int)cudaErrorInvalidValue;
  const int n_tiles = (n + TILE - 1) / TILE;
  const int blocks = n_tiles < MAX_BLOCKS ? n_tiles : MAX_BLOCKS;
  dead_count_kernel<<<dim3(blocks, n_slots), TILE, 0, (cudaStream_t)stream>>>((const uint8_t*)alive, (int*)counts,
                                                                              n, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || offsets == nullptr) return (int)err;
  tile_scan_kernel<<<n_slots, 1024, 0, (cudaStream_t)stream>>>((const int*)counts, (int*)offsets, n_tiles);
  return (int)cudaGetLastError();
}

// The count share of nested emitter e's cadence over n lanes on `stream`
// (a folded chain's seed, kernel row 10's first frame): each TILE-lane
// tile's parent count into tile_counts (ceil(n / TILE) ints), any_alive (or
// null) set to 1 where a lane is alive. alive (u8), age and le_in are [n];
// ptype [n] or null (one type); lifetime [n] or null (the table's
// constant); gate one byte. Returns the cudaError_t of the launch.
int bf_nested_counts(const void* tables, int e, const void* alive, const void* ptype, const void* age,
                     const void* lifetime, const void* le_in, const void* gate, void* tile_counts, void* any_alive,
                     int n, void* stream) {
  if (n <= 0 || e < 0 || tile_counts == nullptr) return (int)cudaErrorInvalidValue;
  NestedArgs a = {};
  a.alive = (const uint8_t*)alive;
  a.ptype = (const int*)ptype;
  a.age = (const float*)age;
  a.lifetime = (const float*)lifetime;
  a.le_in = (const float*)le_in;
  a.gate = (const uint8_t*)gate;
  a.tile_counts = (int*)tile_counts;
  a.any_alive = (int*)any_alive;
  a.e = e;
  a.n = n;
  const int n_tiles = (n + TILE - 1) / TILE;
  nested_count_kernel<<<n_tiles < MAX_BLOCKS ? n_tiles : MAX_BLOCKS, TILE, 0, (cudaStream_t)stream>>>(
      (const int*)tables, a, n_tiles);
  return (int)cudaGetLastError();
}

// One launch of nested_stage_kernel for nested emitter e on `stream`.
// With tiles (n_tiles = ceil(n / TILE)), the cadence pass over n lanes
// (kernel row 8): alive (u8), age, le_in are [n]; ptype [n] or null (one
// type); lifetime [n] or null (the table's constant); gate one byte; le_out
// [n] (may be le_in) or null; cum [n] or null; carry a folded frame's
// per-tile counts (ceil(n / TILE) ints, the fold epilogue's) or null
// (counted here); any_alive (NS_ANY) or null; planes a host array of
// n_parent device planes [n] (nested_parent_fields order); record
// (NS_STRIDE ints, zero, or null) receives the emitter's scalars, the
// window starting at *start_in (null: 0); dead-rank archetypes (ring 0)
// pass the claim's tile counts and offsets for the drop count. Then either
// fetch_out ([n_parent][m], the parent values by rank, 0 from the total
// on), or child ([child_rows][m], the child rows of the m ranks: frame
// FRAME_WORDS host floats, (k0, k1) = fold_in(frame_key, 1000 + e) (or
// frame_dev and key_dev, the same as device words: a captured chain's),
// n_draws uniform rows; a ring record counts the children whose window
// slot lives in NS_DROPPED; an unfolded launch passes parts,
// [CHILD_PARTS][m] floats, for the ranks' draws before its barrier), or
// neither. Without tiles (n_tiles 0), the
// child rows alone from parent_vals ([n_parent][m] by rank) or from cum_in
// ([n], the first lane whose cum exceeds the rank, clamped into the pool,
// with planes). scratch: scratch_words ints (2 + the blocks of a wave: the
// grid barrier's words, 0 at first use, and the blocks' sums; launches
// that share them run in order, as on one stream). An unfolded launch with
// tiles is cooperative (its blocks resident together); the grid is at most
// one wave of the kernel, and scratch_words - 2 blocks; a folded one at
// most two waves. Returns the cudaError_t of the launch.
int bf_nested_stage(const void* tables, int e, const void* alive, const void* ptype, const void* age,
                    const void* lifetime, const void* le_in, const void* gate, void* le_out, void* cum,
                    const void* carry, void* any_alive, void* const* planes, int n_parent, void* fetch_out,
                    void* child, void* parts, const void* parent_vals, const void* cum_in, const void* start_in,
                    const void* dead_counts, const void* dead_offsets, void* record, const float* frame, uint32_t k0,
                    uint32_t k1, int n_draws, void* scratch, int scratch_words, int n, int m, int n_tiles, int ring,
                    const void* frame_dev, const void* key_dev, void* stream) {
  const bool tiles = n_tiles > 0;
  if (n <= 0 || m <= 0 || e < 0 || n_parent < 0 || n_parent > MAX_FETCH || scratch == nullptr || scratch_words < 3 ||
      (tiles && n_tiles != (n + TILE - 1) / TILE) || n_tiles < 0 || (child != nullptr && fetch_out != nullptr))
    return (int)cudaErrorInvalidValue;
  if (child != nullptr && ((n_parent != 6 && n_parent != 10) || n_draws < 8 || n_draws > 12 ||
                           (frame == nullptr && frame_dev == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (parts != nullptr && (!tiles || child == nullptr || carry != nullptr)) return (int)cudaErrorInvalidValue;
  if (tiles && (m > n || alive == nullptr || age == nullptr || le_in == nullptr || gate == nullptr ||
                parent_vals != nullptr || cum_in != nullptr || ((child || fetch_out) && planes == nullptr) ||
                (record != nullptr && !ring && (dead_counts == nullptr || dead_offsets == nullptr))))
    return (int)cudaErrorInvalidValue;
  if (!tiles && (child == nullptr || (parent_vals == nullptr) == (cum_in == nullptr) ||
                 (cum_in != nullptr && planes == nullptr) || le_out || cum || record || any_alive))
    return (int)cudaErrorInvalidValue;
  NestedArgs a = {};
  a.alive = (const uint8_t*)alive;
  a.ptype = (const int*)ptype;
  a.age = (const float*)age;
  a.lifetime = (const float*)lifetime;
  a.le_in = (const float*)le_in;
  a.gate = (const uint8_t*)gate;
  a.le_out = (float*)le_out;
  a.cum = (int*)cum;
  a.carry = (const int*)carry;
  a.any_alive = (int*)any_alive;
  for (int k = 0; k < MAX_FETCH; ++k)
    a.planes[k] = (planes != nullptr && k < n_parent) ? (const float*)planes[k] : nullptr;
  a.n_parent = n_parent;
  a.fetch_out = (float*)fetch_out;
  a.child = (float*)child;
  a.parts = (float*)parts;
  a.parent_vals = (const float*)parent_vals;
  a.cum_in = (const int*)cum_in;
  a.start_in = (const int*)start_in;
  a.dead_counts = (const int*)dead_counts;
  a.dead_offsets = (const int*)dead_offsets;
  a.rec = (int*)record;
  for (int i = 0; i < FRAME_WORDS; ++i) a.frame[i] = frame ? frame[i] : 0.0f;
  a.k0 = k0;
  a.k1 = k1;
  a.frame_dev = (const float*)frame_dev;
  a.key_dev = (const uint32_t*)key_dev;
  a.n_draws = n_draws;
  a.barrier = (unsigned*)scratch;
  a.block_sums = (int*)scratch + 2;
  a.e = e;
  a.n = n;
  a.m = m;
  a.n_tiles = n_tiles;
  a.ring = ring;
  // each block a contiguous range of tiles: a cooperative launch at most
  // one wave of blocks (the barrier's condition) and one block sum per
  // scratch word; a folded launch at most two waves (every block reduces
  // all the carried counts: at 5120 tiles one wave, four and one tile per
  // block measured slower, PERF.md §6); a child-rows launch alone, one
  // block per TILE ranks
  const bool barrier = tiles && carry == nullptr;
  const void* kernel = barrier ? (const void*)nested_stage_kernel<true> : (const void*)nested_stage_kernel<false>;
  int blocks = (m + TILE - 1) / TILE;
  if (tiles) {
    int wave = 0;
    cudaError_t err = resident_wave(kernel, 0, &wave);
    if (err != cudaSuccess) return (int)err;
    const int cap = barrier ? wave : 2 * wave;
    blocks = n_tiles < cap ? n_tiles : cap;
    if (barrier && blocks > scratch_words - 2) blocks = scratch_words - 2;
    a.tiles_per_block = (n_tiles + blocks - 1) / blocks;
    blocks = (n_tiles + a.tiles_per_block - 1) / a.tiles_per_block;
  }
  const int* tab = (const int*)tables;
  void* params[] = {(void*)&tab, (void*)&a};
  cudaError_t err;
  if (barrier) {
    // cooperative (every block resident, the grid barrier's condition)
    // through the launch attribute, which stream capture records as a
    // cooperative kernel node: a captured chain replays it so
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(TILE);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelExC(&cfg, kernel, params);
  } else {
    err = cudaLaunchKernel(kernel, dim3(blocks), dim3(TILE), params, 0, (cudaStream_t)stream);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Blocks of TILE threads of the step kernel's instantiation <ring, collide,
// fields, stats, merge, fleet> resident on one SM of the current device at
// smem_bytes of dynamic shared memory (registers, static and dynamic shared
// memory; cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the
// cudaError_t of the query.
int bf_step_occupancy(int ring, int collide, int fields, int stats, int merge, int fleet, int smem_bytes) {
  if (smem_bytes < 0 || (merge && (fleet || !collide || !fields))) return -(int)cudaErrorInvalidValue;
  const void* kernel = merge   ? bf_step_kernel_merge(ring, 0, stats)
                       : fleet ? (ring ? bf_step_kernel_fleet_ring : bf_step_kernel_fleet_dead_rank)(collide, fields,
                                                                                                   stats)
                               : (ring ? bf_step_kernel_ring : bf_step_kernel_dead_rank)(collide, fields, stats);
  return blocks_per_sm(kernel, smem_bytes);
}

// bf_step_occupancy of fused_step_kernel_warp<stats>.
int bf_step_warp_occupancy(int stats, int smem_bytes) {
  if (smem_bytes < 0) return -(int)cudaErrorInvalidValue;
  return blocks_per_sm(bf_step_kernel_ring_warp(stats), smem_bytes);
}

// bf_step_occupancy of fused_step_kernel_merge<ring, stats>.
int bf_step_merge_occupancy(int ring, int stats, int smem_bytes) {
  if (smem_bytes < 0) return -(int)cudaErrorInvalidValue;
  return blocks_per_sm(bf_step_kernel_merge(ring, 1, stats), smem_bytes);
}

// cos_fast_sweep_kernel over the float bits [lo, lo + n) on `stream`,
// adding its mismatches to *bad (one u64 on the device). Returns the
// cudaError_t of the launch.
int bf_cos_fast_mismatches(uint32_t lo, uint32_t n, void* bad, void* stream) {
  cos_fast_sweep_kernel<<<MAX_BLOCKS, TILE, 0, (cudaStream_t)stream>>>(lo, n, (unsigned long long*)bad);
  return (int)cudaGetLastError();
}

// `count` launches of empty_kernel (one block) on `stream`. Returns the
// cudaError_t of the last launch.
int bf_empty_launches(int count, void* stream) {
  for (int i = 0; i < count; ++i) empty_kernel<<<1, TILE, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* bf_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
