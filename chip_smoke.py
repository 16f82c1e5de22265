#!/usr/bin/env python3
"""Drive bevy_firework_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Builds the fused step, fleet and nested kernels (ops/csrc/, one nvcc per
source, all started together) and the native instance ring from this
checkout, holds them against their plain PyTorch versions, and runs the
paths `bench.py` measures for the JAX package (stress_test through
multi_step_auto at 100k and 1M live; stress_test_collision against its two
cuboids and against 8 hulls at 1M; the nested_60k and nested_chained
cells; the fleet_16x55k, scene_batch_12, scene_hetero_100 and
group_churn_12 cells; render_extract_1M and examples/render_loop.py's
render loop) plus the interactive sparks, collision, fireworks and
textures flows, the Scene's async render, its async events, ribbon trails
(the comets flow and stress_test with a 16-point trail at 100k live),
checkpoints resumed on the card and every examples_torch/ script, through
the kernels. Phases:

  1. card: name and power limit (nvidia-smi), kernel build time, and per
     kernel ptxas's registers and spills and the blocks resident per SM
     (the main path and its warp-cadence instantiations within their cap of
     63 registers at 4 blocks per SM, no kernel spilling);
  2. deterministic config (constant draws, live rotation), N = 131072:
     kernel == plain bit for bit, 1-frame and 8-frame launches; then a
     pool with a partial last tile (130995 lanes) of two types of uneven
     curves, at U = 1 and 8 with no pack, the f32 pack and the f16 record:
     bit for bit;
  3. stress_test, N = 131072: alive count, cursor and cadence scalars exact,
     f32 fields within 4 ulp (libm sinf/cosf may differ between the kernel
     and PyTorch's CUDA ops), KS test of fresh initial_scale vs U(0.02, 0.08);
  4. one U = 8 launch == 8 single launches, bit for bit;
  5. render pack: the kernel's 9 planes == the plain render pack; rows are
     count x 64 bytes;
  6. main path at 100k live (rate 1e5, capacity 131072): a 140-frame
     multi_step_auto chain against 140 plain frames, its render pack against
     the plain one, differential CUDA-event timing over n and 2n frames, and
     the kernel's device time per launch (torch.profiler) beside the plain
     version's;
  7. the same at 1M live (rate 1e6, capacity 1310720);
  8. sparks flow: 120 step_auto_packed frames at 1/60 give 750 live; the
     last render planes equal the plain render pack;
  9. collision_det, N = 131072: a box emitter whose draws meet no sinf/cosf,
     against one collider of each of the 7 kinds (C = 7), against
     stress_test_collision's two cuboids (C = 2) and with lanes inside two
     overlapping colliders: kernel == plain bit for bit over 10 single and
     4 U = 2 launches;
 10. destroy_claim, N = 131072: the same emitter destroying on collision
     (dead-rank claim, alive plane) for 30 step_auto frames: claims, alive,
     cursor and fields exact against plain each frame; 30 launches on the
     carried counts (kernel row 4), one seed, no count + scan pair; the
     counts the last launch left and the count + scan pair's tile offsets
     against their plain versions; tiles holding dead lanes; the launch on
     carried counts against the same launch given the scanned offsets (C S
     S C), the seed, the pair, torch.cumsum and the plain dead_rank, timed;
 11. collision_1M: stress_test_collision at rate 5e5, capacity 1310720,
     two cuboids: a 150-frame multi_step_auto chain (U = 2 launches)
     against 150 plain frames (counts, cursor, cadence exact; f32 within 4
     ulp), its render pack against plain, differential ms/frame, and the
     kernel's device time per U = 2 and per U = 8 launch beside the plain
     version's 2 and 8 frames;
 12. hull8_1M: the same against bench.py's 8 hulls, 120 frames (8
     colliders; the JAX package's looped form); for both,
     the skip share and the narrow phase's operations counted from a
     recorded plain frame (the U = 2 launch's bound);
 13. collision_flow: effects.collision() with its cuboid through
     step_auto_packed for 400 frames: live count, state and render planes
     equal the plain version's;
 14. many_collider_det, N = 131072: the box emitter against the JAX
     test's 6-collider mix, 33 and 64 mixed colliders (a quarter hulls,
     some disabled, two overlapping where lanes start inside both) and 200
     (three in four 16-plane hulls: a table past SMEM_COLLIDER_WORDS, read
     from global memory): a chain of 10 U=1 and 4 U=2 launches, each
     running its broad phase, the first U=1 and the last U=2 launch == the
     plain version (no skip) bit for bit (a plain frame against 200
     colliders costs seconds of host time); the share of (warp, collider,
     substep) tests collision.broad_phase_keep skips;
 15. caps_det, N = 131072: past the old table caps, 17- and 40-knot
     curves, 9 emitters, 9 types (render planes and the stats row), 9
     types of 40-knot curves (a 4948-word spawner table), 34 emitters of
     mixed pacing (past the 32 the warp's cadence takes), 7 of mixed pacing
     with a queue at U = 1, 2 and 8 (the warp's cadence) and 9 force
     fields, solo and in a 3-slot fleet: kernel == plain, bit for bit
     (the state on the first and the last launch of each chain, the
     fleet's slots each == its solo launch on every launch and == plain
     on the first, slot 0 on the last; the render planes and stats row on
     every launch); a Scene (200
     colliders, 9 fields, 9 emitters and types) and a Fleet (200
     colliders) on the card == their plain replay;
 16. collider_scaling_1M: tools/collider_scaling_tpu.py's scenes with
     stress_test_collision at 5e5/s, capacity 1310720, 140 warm-up frames,
     C in {1, ..., 128} mixed colliders and {8, 16, 32, 64} with a quarter
     hulls: differential ms/frame, the U = 2 launch's device time (== 2
     plain frames within 4 ulp) beside its bound, the skip share (the
     narrow phase runs its per-warp broad phase at every count; at C = 1-4
     the JAX package unrolls its tests instead); at C = 32 the plain
     version's time;
 17. fields_det, N = 131072: the box emitter under one force field of each
     kind (and a disabled one), and under all four: kernel == plain bit for
     bit on point, vortex and axial, turbulence within 8 ulp (cosf against
     PyTorch's CUDA cos), over 4 U = 1 and 4 U = 8 launches; a 3-slot field
     fleet under the tornado's fields (65536 lanes per slot): every slot ==
     its solo launch bit for bit, == plain under the same rule; the
     turbulence's straight-line cosine (cos_fast) == CUDA's cosf on every
     float below its bound;
 18. dump_det, N = 131072: the destroyed-dump plane of a ring archetype with
     a particles_destroyed handler (deaths by age) and of a destroy
     archetype with one (dead-rank claim): equal to the plain mask, 12
     frames each;
 19. stats_det, N = 1310720: the kernel's stats row (AABB, alive and
     per-type counts) against the plain reductions over the state the same
     launch wrote, for a ring, a dead-rank and a 3-type archetype, by value;
     at the sparks flow's pool (2048 lanes, the Scene's size), timed beside
     the launch without the block; and at the float edges
     (tests/torch_stats_configs.py: a NaN position makes its axis's bounds
     NaN, lanes at -0, +0 and +-inf reduce as the plain reductions do);
 20. fields_1M: library.dust at 3e5/s (lifetime 4 s) under the tornado
     example's three fields, capacity 1310720: a 300-frame multi_step_auto
     chain (U = 8) against 300 plain frames, ms/frame and the kernel's
     device time per launch beside main_1M's;
 21. scene_flows: through `Scene` on the card: the sparks flow (750 live;
     state and rows equal a CPU Scene's), the tornado example (300 frames
     of set_force_field; equal to the plain version replayed on the card)
     and bench.py's events_dump_overhead scene (4 spawners at 3000/s,
     capacity 8192, a floor, destroy-on-collision): records delivered ==
     the plain version's destroyed count, ms per Scene.step with and
     without the handler;
 21a. scene_async_events: the events scene with enable_async_events, 220
     steps: after step i the records of frames < i delivered (== the plain
     version's cumulative destroyed count, each record once, one frame
     late; flush_events drains the last frame), then 20 steps whose
     payload enqueue (Scene._enqueue_events: the payload built on the
     device, its copy on the event copy stream) runs under
     torch.cuda.set_sync_debug_mode("error"); ms per Scene.step dump-free,
     sync and async (interleaved), async_over_free against its bar of 1.5,
     and the host time of record building and of the whole delivery;
 21b. trails_flow: library.comets() (capacity 256, TrailSettings(16, 0.8))
     through Scene for 300 steps: trail_items' count == a CPU Scene's, rows
     within 1e-5 (the circle's and the cone's sinf/cosf); 4 comets in one
     archetype group: the stacked trails == each member's own update_trails
     on its pool, bit for bit, every leaf;
 21c. trails_100k: stress_test at 1e5/s in 131072 lanes with
     TrailSettings(16, 0.8) through Scene, 140 frames: the last frame's
     trail rows == the plain replay's (plain_frames + update_trails on the
     card) within 4 ulp, hcount exact; ms per Scene.step with and without
     the trail, ms per trail_items call, its segments and the bytes it
     copies (count x 64), the device time of update_trails and of the
     pack + compaction beside their bytes bounds;
 21d. checkpoint_flow: the trails_100k scene, the events scene (with its
     handler) and the tornado scene (its fields moved every frame, a floor
     edited) saved at frame 70, loaded on the card and run 70 more frames:
     == the uninterrupted run bit for bit (pools, trails, destroyed
     records, render rows); the card's zip loaded on the CPU and a CPU zip
     (21b's comets) loaded on the card == their source leaf for leaf; save
     and load ms and the zips' sizes (written to a temporary directory in
     the checkout, removed after the phase);
 22. nested_det, N = 131072: the nested-stage kernel (kernel rows 8 and
     9b, one launch per nested emitter) against its plain version
     step.nested_stage, anchors, NS record and child buffer bit for bit,
     unfolded and on a folded frame's carried tile counts: a rate window
     on the ring (total below M) and on a dead-rank archetype, a burst
     whose first tile owns every rank below M, and the rate window at
     1310720 lanes; its pass alone (cum and fetch mode, the cum included)
     and its child rows alone (both parent modes) against
     step.nested_cadence and step.nested_child_rows; then 30 hybrid frames
     of a ring, a chained and a destroy-on-collision (dead-rank) nested
     archetype whose children meet no sinf/cosf, the last on its floor
     (fused_step_kernel's merge instantiation) and without one
     (fused_step_kernel_merge), stats on every other frame: bit for bit,
     anchors, nested counts, the alive plane and the finished latch
     included (kernel rows 9 and 10: every instantiation of
     fused_step_kernel_merge, ring and dead-rank, stats on and off, runs
     here or in 22a);
 22a. nested_fold_det, N = 131072: nested_det's ring configs (single and
     chained, with deferral; tests/torch_nested_configs.py): the seed's
     count kernels and the step launch's fold epilogue (kernel row 10: per-
     tile parent counts and the next frame's NS_ANY) against
     step.nested_fold_counts on the state each read, bit for bit, every
     third frame of 30; a 30-frame folded chain == the unfolded chain ==
     30 plain frames, bit for bit; four chains with the emitters' enabled
     bits toggled between them, folded == unfolded;
 23. nested_60k: bench.py's nested cell (4000 rockets/s, 10 children each,
     capacity 131072, nested_buffer 1024, ~60k live): a 150-frame
     multi_step_auto chain (folded: one count kernel per nested emitter,
     then per frame one nested-stage launch per emitter and the step
     launch, fused_step_kernel_merge's, with the fold epilogue but on the
     last: 1 + E launches a frame) under
     torch.cuda.set_sync_debug_mode("error") (no frame
     synchronises) against the unfolded chain (bit for bit) and 150 plain
     frames (counts, cursor, cadence exact; f32 within 4 ulp), differential
     ms/frame, the device time per frame of 10-frame folded and unfolded
     chains, and of the nested-stage launch (unfolded and folded), the
     seed's count kernel and the merge step launch without and with the
     fold epilogue, with the nested stage's share of the frame;
 24. nested_chained: the same for bench.py's 3-stage chained cell;
 24a. ab_nested_fold: bench.py's A/B (:958-1029) on nested_60k: folded (100
     and 200 frames) and unfolded (101 and 202) chains interleaved, 7
     pairs, ms/frame by host clock, the pair with the median ratio;
 25. nested_flows: effects.fireworks() and effects.textures() (with its
     colliders) through Scene on the card for 300 frames each, against the
     plain version replaying the flow on the card: per-type counts every
     frame, state, dense rows; ms per Scene.step;
 26. fleet_det, N = 131072, S = 3 (tests/torch_fleet_configs.py): a ring,
     a destroy-on-collision archetype with a handler (dead-rank claim,
     dump), 3 types with stats, force fields, the render pack and U = 8,
     slots differing in params, seeds, frames and fields: every slot of
     each fleet launch == a solo launch of its pool == the plain frames,
     bit for bit (rotation <= 2 ulp); the ring and render cases again at
     131073 lanes per slot (slot bases not 16-byte aligned);
 27. fleet_16x55k: bench.py's fleet cell (stress_test at 55000/s, 16 slots
     x 65536 lanes): a 140-frame multi_step_fleet chain under sync debug
     mode "error" == 16 solo multi_step_auto chains bit for bit, and slots
     0, 5, 10 and 15 == the plain version (counts exact, f32 <= 4 ulp);
     differential ms/frame of
     the fleet chain beside the 16 solo chains', and the U = 8 fleet
     launch's device time beside its bound, the 16 solo launches' and the
     plain version's;
 28. fleet_flow: the README's one-shot Fleet flow, extended (tests/
     torch_fleet_configs.py: 8 slots of 64 lanes, five bursts activated at
     two frames, drain_finished every frame, 200 frames) on the card
     against the same flow stepped by the plain version on the card and by
     the Fleet on the CPU: finished slots and live counts every frame,
     integer leaves and keys exact, the render items; f32 bit for bit
     against the card's plain replay where the burst emits from a box
     (within 4 ulp with its circle's sinf/cosf), within 1e-5 of the CPU;
 29. scene_groups: bench.py's scene_batch_12, scene_hetero_100 and
     group_churn_12 through Scene on the card (one fleet launch per
     archetype group and frame, the render pack on: render_items is called
     once before timing): every member (scene_hetero_100: every fifth) ==
     the plain version replaying its frames on the card; ms per Scene.step
     beside the same spawners stepped
     one by one through step_auto_packed (the render pack too),
     interleaved;
 30. render_f16_det, N = 131072: the f16 render pack (kernel row 2's f16
     mode) of the elided-rotation spawner (12 planes) and of phase 2's
     live-rotation config (16 planes) over 6 U = 1 and 3 U = 8 launches,
     stress_test at 1e5/s (random draws), a hybrid launch of
     nested_60k's effect and a 3-slot U = 8 fleet
     launch: the record == the plain version on the state the launch
     wrote, bit for bit (NaN by isnan), and == the same launch's f32 pack
     and positions rounded;
 31. render_extract_1M: from the main_1M state (bench.py's
     render_extract_1M cell), the device time per U = 8 and U = 1 launch
     with no pack, the f32 pack and the f16 record, each beside its bytes
     bound; the plain f16 frame's;
 32. render_loop: examples/render_loop.py's loop (tests/
     torch_render_configs.py: stress_test at 30000/s, capacity 65536, 240
     frames of fused_step + AsyncRenderReader.submit_packed + a draw
     poll) for the f32 pack and the f16 record: the sim loop's ms/frame
     without and with the reader (interleaved), frames drawn and
     published, the reader's copy-stream time per frame beside a pinned
     copy of the same bytes; a run in which every drawn frame equals the
     plain pack of its post-step state (every state of that run kept);
 33. render_loop_1M: the same at 1e6/s, capacity 1310720 (the checked
     run 60 frames);
 34. scene_async_render: a Scene on the card with async render on (two
     sparks spawners in one archetype group, a two-type spawner), 120
     steps: each render_async item == render_items of the frame its
     frame_id names; compact == dense; ms per Scene.step with async render
     on and off;
 35. shard_det, N = 131072 (kernel row 11: a pool split over the particle
     axis, each shard a launch with its lane base, the global capacity and
     its dead offset): phase 2's deterministic config, stress_test at 1e5/s
     (random draws) and destroy_claim's emitter on a halfspace (dead-rank
     claim), S = 2, 4, 8 shards in one process, 30 frames at U = 1 and,
     on the ring, U = 8: the stitched shards == the unsharded kernel bit
     for bit (every leaf; the stats rows reduced across shards), each shard
     == the plain version with the same shard arguments (phase 2's and 3's
     rules: rotation 2 ulp, stress_test 4 ulp; destroy bit for bit);
 36. sharded_1M: main_1M's cell split S = 2, 4, 8 in one process: a
     140-frame chain stitched == the unsharded chain bit for bit, each
     shard's U = 8 launch (device time) beside its bytes bound, the device
     time per frame summed over the shards beside the unsharded U = 8
     launch; destroy_claim's emitter at 1310720 lanes and 5e5/s, S = 4, 30
     frames, bit for bit, the shards' dead offsets device tensors (kernel
     row 11) and their frames run under sync debug mode "error"; at that
     state phase 10's claim timings and the S = 4 destroy frame's;
 37. dist_gloo: tests/torch_distributed_worker.py in 4 processes sharing
     the card over gloo, spawned once: sp (main_1M's cell, 140 frames,
     parallel.sharding.make_sharded_step), dp (fleet_16x55k, 4 slots per
     rank, make_fleet_step), 2d (2 x 2, 2 slots of main_100k's config,
     make_fleet_step_2d) and sp_nested (make_sharded_step on nested
     archetypes: the sharded XLA-layout step, xla_step.step(shard=,
     group=); nested_60k's cell, 131072 lanes with nested_buffer 1024,
     fireworks (ring claim) and fireworks with its sparkles destroyed on a
     floor (dead-rank claim; the worker's fireworks_floor) in 131072 lanes,
     150 frames each (fireworks_floor 100), every frame of each rank's
     share held against the unsharded xla_step.step on the card),
     each rank's share == its unsharded counterpart bit for bit, outputs
     included; ms/frame and the host time of the collectives per launch,
     and for sp_nested (its own line, dist_gloo_sp_nested) ms/frame of a
     30-frame sharded chain beside the unsharded multi_step's on rank 0,
     the gathers per frame and their host µs. A rank that fails or times
     out fails the phase. (NCCL refuses two ranks on one card: a
     multi-card run is not verified here.)
 38. xla_step: `multi_step` (the JAX package's XLA layout, composed torch:
     threefry draws per emitter, emitters in declared order; no kernel
     launches) of stress_test and sparks at 131072 lanes for 30 frames and
     fireworks (nested) at 16384 lanes for 120, on the card against the
     same call on the CPU: integer and bool state and the outputs' counts
     exact, f32 fields within 1e-5 (CUDA's sinf/cosf and the CPU's part by
     a few ulp in the shape and cone draws); ms per frame of `multi_step`
     beside `multi_step_auto` (the kernel's layout) at 131072 lanes
     (stress_test, CUDA events, median of 5);
 39. viewer_flow: a Scene on the card (sparks and a trailed comet
     spawner) drawn by `viewer.render_frame` with distance fog, a light
     table with an environment light and a shadow atlas over an occluder,
     against the same Scene stepped on the CPU: the same live and segment
     counts, pixels within 1e-3; `viewer.render_scene_png` writes the card
     Scene's PNG;
 40. examples: every script of examples_torch/ (the JAX package's
     examples/, ported) on the card, in this process through runpy
     (tests/torch_examples_run.py), at its JAX counterpart's default
     frames, each under its own deadline, files into a temporary directory
     of the checkout: each held to what its JAX counterpart prints or
     asserts (sparks' 750 live and count x 64 B, pbr's uniform, collision's
     minimum y over the floor, dynamic_colliders' four minimum-y readings
     with no kernel build or library load during the edits and the freed
     slot reused, on_demand's clicks and count, one_shot's impacts and
     finished slots, textures' two types, trails' segments, render_loop's
     final frame (f32 and --f16) equal to its live count, the WebGPU page's
     DESC == PipelineCache's, the PNGs of lights, render_preview and
     fireworks) and to the kernels it must launch; multichip.py starts 4
     gloo ranks sharing the card (sp == the unsharded multi_step_auto,
     nested sp == the unsharded xla_step.multi_step); then
     utils.profiling: a trace of 30 sparks frames holds the step kernel's
     launches and 30 annotate spans, device_memory_stats the card's
     allocated bytes;
 41. graphs: the captured chains (ops.chain_graph: multi_step_auto,
     multi_step_auto_packed, multi_step_fleet_stacked and multi_step_fleet
     replay one CUDA graph per static configuration, reading their frame
     rows, seeds and nested keys from device words) at main_100k, main_1M,
     collision_1M, fields_1M, the destroy config, nested_60k folded,
     unfolded and packed, nested_chained, fleet_16x55k, a destroy fleet
     with the dump plane, a nested fleet of stacked params and a dead-rank
     nested archetype (tests/torch_chain_configs.py's card sizes): captured ==
     uncaptured bit for bit on the first call, a replay, a replay with
     another dt and transform and a replay from the first state again, the
     earlier results kept and the input unwritten, every chain call under
     sync debug mode "error"; each launch family the chains use (solo U =
     8 and U = 1 with the render pack, the narrow phase, the field block,
     the dead-rank claim, the fleet, the hybrid frame's cooperative nested
     stage and lean merge, the folded frame, the wide merge) by value ==
     with device words; per cell the capture's host seconds, ms/frame
     uncaptured and captured in turns (CUDA events, the median of 7 calls
     a turn), the device time of a
     replay call beside the bare graph's (the difference: the host words,
     the copy-in and the clone-out); and ab_nested_fold with both chains
     captured.
 42. scene_graphs: the Scene's step as captured CUDA graphs (one per scene
     signature; one per group past combined_signature_limit; the groups'
     padded, hole-stable rows): tests/torch_scene_configs.py's cells at the
     card size (the sparks flow, the events scene sync and async, the
     tornado, a trailed comet group, scene_batch_12, scene_hetero_100 in
     combined and per-group mode, group_churn_12), each through a captured
     and an uncaptured Scene: pools, outputs, render planes, trails and
     render rows bit for bit, records and finished events every step, a
     signature's first step uncaptured and then one graph replay per step
     (per group in per-group mode), no launch one by one in a step that
     replays, the replays holding the fleet and the solo step launches, no
     capture on a churn within a pad class, padding rows dead and
     nobody's; the device memory with the graphs held; ms per Scene.step
     captured and uncaptured in interleaved windows; the host µs of a
     steady step by part, the copies' device µs, the capture ms per
     signature, the packed fleet launch at 12 rows against 16,
     group_churn_12 padded against unpadded; bench.py's churn_storm
     captured, uncaptured and unpadded. Every earlier phase that steps a
     Scene steps it captured.

The launch counters are set to 0 just before each main-path run (the two
stress_test chains, the sparks flow, the destroy run, the two collision
chains, the collision flow, the collider-scaling chains, the fields chain, the Scene flows, the
async events scene, the trails flows, the trails_100k scenes, the checkpointed scenes, the two
nested chains, the nested flows, the fleet chain, the Fleet flow, the
scene groups, the two render loops, the async Scene, sharded_1M's three
sharded chains, the viewer's Scene, each example script, the graphs
phase and each step of the captured Scene in the scene_graphs phase's checked cells) and read just after it;
the kernels' summary reports those counts only. A run counts the launches it made on the card: those launched one
by one and those its captured chains' replays ran (a graph's launches
times its replays), not those a capture recorded without running them. Every phase
prints one JSON line; the kernels' summary (with each kernel's bound: the
larger of its bytes over 3.35 TB/s and its f32 operations over 67 TFLOP/s,
from this run's shapes) and the final `{"ok": true, "device": ...}` line
follow. Every device time is held to its bound where it is measured: a
trace that holds no launch or reads below the bound is traced again (and
listed in the summary's `trace_faults`), three traces in all. Any failed
check raises, so the exit code is non-zero and no final line is printed. Without a CUDA device the script exits with an error before
running anything.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path


# An H100 SXM's published peaks at 700 W (NVIDIA's data sheet): HBM3
# bandwidth and f32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# f32 operations per lane and frame, counted from the kernel's source as
# lower bounds (spawn lanes, curve evaluation and libm calls beyond one
# operation each are not counted): the integrate path (age, move, drag),
# each force-field kind plus the field weighting, and the stats fold.
INTEGRATE_OPS = 20
FIELD_OPS = {0: 23, 1: 32, 2: 43, 3: 159}  # FIELD_POINT, VORTEX, AXIAL, TURBULENCE
FIELD_WEIGHT_OPS = 6
STATS_OPS = 14
# The narrow phase's f32 operations (arithmetic, comparisons, sqrtf and
# divisions one each; selects and the hit's bounce not counted), from
# csrc/fused_step_kernel.cuh: per active lane and substep the direction and
# reach (SUBSTEP_OPS); per tested collider the local frame and the two
# comparisons with the best hit (LOCAL_OPS), the two quaternion rotations
# of a rotated collider (ROTATE_OPS) and the kind's ray test (RAY_OPS by
# COLLIDER_* kind; a hull HULL_OPS plus HULL_PLANE_OPS per plane); per warp
# and substep of the broad phase the box (BOX_OPS) and per collider its
# test (BROAD_OPS: unrotated halfspace, rotated halfspace, bounding sphere).
SUBSTEP_OPS = 13
LOCAL_OPS = 5
ROTATE_OPS = 63
RAY_OPS = {0: 8, 1: 39, 2: 51, 3: 103, 4: 89, 5: 113}
HULL_OPS, HULL_PLANE_OPS = 3, 20
BOX_OPS = 35
BROAD_OPS = (2, 60, 17)


class CheckFailed(RuntimeError):
    pass


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over its
    memory rate and the f32 operations over its peak rate (ms)."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / PEAK_F32_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops}


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line carries the script's elapsed seconds."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 2
    import numpy as np

    import bevy_firework_tpu_torch as bt
    from bevy_firework_tpu_torch.models import effects
    from bevy_firework_tpu_torch.ops import _build
    from bevy_firework_tpu_torch.ops import chain_graph
    from bevy_firework_tpu_torch.ops import fused_step as fs
    from bevy_firework_tpu_torch.ops import table_layout as L
    from bevy_firework_tpu_torch.profile_step import device_times, kernel_report, tornado_fields
    from bevy_firework_tpu_torch.render import pack_render_planes
    from bevy_firework_tpu_torch.settings import EmissionPacing
    from bevy_firework_tpu_torch.settings import ParticleCollisionSettings
    from bevy_firework_tpu_torch import collision as pcol
    from bevy_firework_tpu_torch.colliders import COLLIDER_HALFSPACE, COLLIDER_HULL, masked_layers
    from bevy_firework_tpu_torch.step import active_f32_fields, dead_rank, dead_tile_counts, plain_frames
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))

    def narrow_work(table, log) -> dict:
        """The narrow phase's work in one recorded plain frame
        (`collision.record_substeps`), as the kernel does it: per substep
        the active lanes' tests of the colliders their warp's broad phase
        keeps (the card's narrow phase runs its broad phase at every
        collider count).
        Returns its f32 operations (the ops model above), the tests kept
        and the tests the warps with an active lane would run without a
        skip, and the skip share."""
        kinds, ident = table.kinds, table.identity_rot
        test_ops = torch.tensor([LOCAL_OPS + (0 if ident[c] else ROTATE_OPS) + (
            HULL_OPS + HULL_PLANE_OPS * table.hull_counts[c] if kinds[c] == COLLIDER_HULL else RAY_OPS[kinds[c]])
            for c in range(table.count)], dtype=torch.float64, device=table.device)
        broad_ops = sum(BROAD_OPS[2 if k != COLLIDER_HALFSPACE else 0 if ident[c] else 1] for c, k in enumerate(kinds))
        ops = kept = tests = 0.0
        for rec in log:
            act = rec["active"]
            groups = -(-act.shape[0] // 32)
            lanes = torch.cat([act, act.new_zeros(groups * 32 - act.shape[0])]).view(groups, 32)
            per_group, any_g = lanes.sum(1).double(), lanes.any(1)
            kf = pcol.broad_phase_keep(table, rec["px"], rec["py"], rec["pz"], rec["max_dist"], act).double()
            ops += float(per_group.sum()) * SUBSTEP_OPS + float(per_group @ (kf @ test_ops))
            ops += float(any_g.sum()) * (BOX_OPS + broad_ops)
            kept += float(kf.sum())
            tests += float(any_g.sum()) * table.count
        return {"ops": ops, "tests_kept": kept, "tests": tests, "skip_share": 1.0 - kept / tests if tests else 0.0}

    def recorded_frame(cm, table, state, frame) -> dict:
        """narrow_work of one plain frame from `state` on the card."""
        with pcol.record_substeps() as log:
            plain_frames(cm.static, cm.params, state, frame, 1, stats=False, colliders=table)
        return narrow_work(table, log)

    # ---------------------------------------------------------------- 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    _build.load()
    ptxas = kernel_report()
    step_rows = [r for r in ptxas if "args" in r]
    main_row = [r for r in step_rows if r["args"] == [1, 0, 0, 0, 0, 0]]
    warp_rows = [r for r in ptxas if "warp_stats" in r]  # the main path and its stats twin at U > 1
    merge_rows = [r for r in ptxas if "merge_args" in r]  # hybrid frames without colliders or fields
    check(len(step_rows) == 36 and len(main_row) == 1 and len(warp_rows) == 2
          and all(r["registers"] <= 63 and r["blocks_per_sm"] == 4 for r in main_row + warp_rows),
          f"the step kernel's instantiations: {[(r['kernel'], r['registers']) for r in step_rows + warp_rows]}")
    check(len(merge_rows) == 4 and all(r["registers"] <= 64 and r["blocks_per_sm"] == 4 for r in merge_rows),
          f"the merge kernel's instantiations: "
          f"{[(r['kernel'], r['registers'], r['blocks_per_sm']) for r in merge_rows]}")
    check(all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in ptxas),
          f"ptxas spills: {[r for r in ptxas if r['spill_stores'] or r['spill_loads']]}")
    emit({"phase": "card", "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s, "ptxas": ptxas,
          "rule": "ptxas's registers and spills per kernel; blocks_per_sm: resident blocks of 256 threads per SM "
                  "at no dynamic shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor); the main path and its "
                  "warp-cadence instantiations within their cap of 63 registers, 4 blocks per SM; the four "
                  "fused_step_kernel_merge instantiations within 64 registers, 4 blocks per SM; no kernel spills"})

    def ulp_diff(a, b) -> int:
        """Largest distance in units in the last place between two f32 tensors."""
        def key(x):
            i = x.contiguous().view(torch.int32).to(torch.int64)
            return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
        if a.numel() == 0:
            return 0
        return int((key(a) - key(b)).abs().max())

    scalars = ("ring_cursor", "time_in_cycle", "last_emission", "enabled", "manual_queued", "alive", "rng_key")
    max_err = {"fused_step": 0.0, "fused_step.pack_render": 0.0, "fused_step.collide": 0.0,
               "fused_step.dead_rank_claim": 0.0, "fused_step.fields": 0.0, "fused_step.dump": 0.0,
               "fused_step.stats": 0.0, "nested_stage": 0.0, "fused_step.nested_merge": 0.0,
               "nested_seed_count": 0.0, "fused_step.fleet": 0.0, "fused_step.collide_broad": 0.0,
               "fused_step.nested_fold": 0.0, "fused_step.sharded_claim": 0.0}

    def compare(c, sk, sp, f32_ulps: dict, label, kernel="fused_step"):
        for k in scalars:
            check(torch.equal(getattr(sk, k).cpu(), getattr(sp, k).cpu()), f"{label}: {k} differs")
        worst = {}
        for k in active_f32_fields(c.static):
            a, b = getattr(sk, k), getattr(sp, k)
            worst[k] = ulp_diff(a, b)
            max_err[kernel] = max(max_err[kernel], float((a - b).abs().max()))
            check(worst[k] <= f32_ulps.get(k, 0), f"{label}: {k} differs by {worst[k]} ulp")
        return worst

    def compare_planes(c, s, planes, label):
        """The kernel's render-pack planes against the plain render pack of
        the state the same launch produced: bit for bit."""
        for i, (a, b) in enumerate(zip(planes, pack_render_planes(c.static, c.params, s))):
            max_err["fused_step.pack_render"] = max(max_err["fused_step.pack_render"], float((a - b).abs().max()))
            check(torch.equal(a, b), f"{label}: render plane {i} differs by {ulp_diff(a, b)} ulp")

    counters = {"fused_step": (fs.fused_step, "launches"), "render": (fs.fused_step, "render_launches"),
                "collide": (fs.fused_step, "collide_launches"), "fields": (fs.fused_step, "fields_launches"),
                "dump": (fs.fused_step, "dump_launches"), "stats": (fs.fused_step, "stats_launches"),
                "dead_rank_claim": (fs.tile_dead_offsets, "launches"),
                "dead_claim": (fs.fused_step, "dead_claim_launches"), "dead_seed": (fs.claim_counts, "seeds"),
                "merge": (fs.fused_step, "merge_launches"),
                "merge_lean": (fs.fused_step, "merge_lean_launches"),
                "merge_wide": (fs.fused_step, "merge_wide_launches"),
                "nested_stage": (fs.nested_stage, "launches"), "nested_seed": (fs._seed_nested_carry, "launches"),
                "nested_pass": (fs.nested_cadence_pass, "launches"), "fold": (fs.fused_step, "fold_launches"),
                "nested_child_rows": (fs.nested_child_rows, "launches"),
                "fleet": (fs.fused_step_fleet, "launches"), "fleet_render": (fs.fused_step_fleet, "render_launches"),
                "fleet_collide": (fs.fused_step_fleet, "collide_launches"),
                "fleet_fields": (fs.fused_step_fleet, "fields_launches"),
                "fleet_dump": (fs.fused_step_fleet, "dump_launches"),
                "fleet_stats": (fs.fused_step_fleet, "stats_launches"),
                "broad": (fs.fused_step, "broad_launches"), "fleet_broad": (fs.fused_step_fleet, "broad_launches"),
                "render_f16": (fs.fused_step, "render_f16_launches"),
                "fleet_render_f16": (fs.fused_step_fleet, "render_f16_launches"),
                "shard": (fs.fused_step, "shard_launches")}

    def counted(fn):
        """fn() with the kernels' launch counters and the captured chains'
        counts set to 0 just before it and read just after: (result,
        {counter: launches}), the launches the run made on the card: those
        launched one by one, and those its chains' graph replays ran
        (chain_graph.REPLAYED), not those a capture recorded without running
        them (chain_graph.CAPTURED); and the run's chain captures and
        replays."""
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        chain_graph.reset_counts()
        result = fn()
        counts = {k: getattr(obj, attr) - chain_graph.CAPTURED.get(f"{obj.__name__}.{attr}", 0)
                  + chain_graph.REPLAYED.get(f"{obj.__name__}.{attr}", 0) for k, (obj, attr) in counters.items()}
        counts.update(chain_captures=chain_graph.COUNTS["captures"], chain_replays=chain_graph.COUNTS["replays"])
        return result, counts

    def det_spawner():
        return bt.ParticleSpawner(
            particle_settings=[bt.ParticleSettings(
                lifetime=bt.RandF32.constant(0.3), initial_scale=bt.RandF32.constant(0.1),
                scale_curve=bt.FireworkCurve.uneven_samples([(0.0, 1.0), (1.0, 2.0)]),
                base_color=bt.gradient_uneven_samples([(0.0, (1, 0.5, 0.2, 1)), (1.0, (0, 0, 0, 0))]))],
            emission_settings=[bt.EmissionSettings(
                emission_pacing=bt.EmissionPacing.rate(2000.0),
                initial_velocity=bt.RandVec3.constant((1.0, 3.0, 0.2)),
                initial_angular_velocity=bt.RandVec3.constant((0.0, 2.0, 0.0)))],
        )

    # --------------------------------------------- 2. deterministic config
    # libm (sinf/cosf in the quaternion update) is the only place kernel and
    # PyTorch may part; allow 2 ulp there and nothing anywhere else.
    c = bt.compile_spawner(det_spawner(), device=dev)
    f = bt.make_frame_input(1 / 50)
    s = bt.init_pool_for(c, 131072)
    rot_ulps = {k: 2 for k in ("qx", "qy", "qz", "qw")}
    worst_det = {}
    for u in [1] * 10 + [8] * 4:
        sk, _ok = fs.fused_step(c.static, c.params, None, s, f, unroll=u)
        sp_, _op = plain_frames(c.static, c.params, s, f, u)
        w = compare(c, sk, sp_, rot_ulps, f"deterministic U={u}")
        worst_det = {k: max(worst_det.get(k, 0), v) for k, v in w.items()}
        s = sk
    # a partial last tile and every pack mode of curved types (kernel rows
    # 1 and 2): a pool of 130995 lanes of tests/torch_table_configs.py's
    # two-type spawner (uneven scale curves and gradients), U = 1 and 8, no
    # pack, the f32 pack and the f16 record: state, ptype, planes and
    # record == plain bit for bit
    import torch_render_configs as render_cfg
    import torch_table_configs as table_cfg

    ck = bt.compile_spawner(table_cfg.two_type_curves_spawner(rate=2e5), device=dev)
    sk0 = bt.init_pool_for(ck, 131072 - 77, seed=5)
    fk = bt.make_frame_input(1 / 60)
    for u, pack in ((1, False), (1, True), (1, "f16"), (8, True), (8, "f16"), (8, False)):
        res = fs.fused_step(ck.static, ck.params, None, sk0, fk, unroll=u, pack_render=pack)
        sp_, _op = plain_frames(ck.static, ck.params, sk0, fk, u)
        compare(ck, res[0], sp_, {}, f"two_types U={u} pack={pack}")
        check(torch.equal(res[0].ptype, sp_.ptype), f"two_types U={u} pack={pack}: ptype differs")
        if pack == "f16":
            render_cfg.check_record(ck.static, ck.params, res[0], res[2], None, f"two_types U={u}")
        elif pack:
            compare_planes(ck, res[0], res[2], f"two_types U={u}")
        sk0 = res[0]
    check(int(sk0.alive.sum()) > 10000 and bool((sk0.ptype[sk0.alive] == 1).any()), "two_types: too few lanes")
    torch.cuda.synchronize()
    emit({"phase": "deterministic", "card": card, "n": 131072, "live": int(s.alive.sum()),
          "max_ulp": worst_det, "rule": "bit-equal; rotation <= 2 ulp (sinf/cosf)",
          "two_types": {"n": 131072 - 77, "live": int(sk0.alive.sum()),
                        "rule": "a partial last tile, two types of uneven curves, U = 1 and 8, no pack, f32 pack, "
                                "f16 record: bit for bit"}})

    # --------------------------------------------------- 3. random config
    sp0, tf = effects.stress_test()
    c = bt.compile_spawner(sp0, device=dev)
    f = bt.make_frame_input(1 / 60, translation=tf.translation)
    s = bt.init_pool_for(c, 131072)
    f32_ulps = {k: 4 for k in active_f32_fields(c.static)}
    worst_rnd = {}
    for u in [1] * 6 + [8] * 3 + [1] * 2:  # 32 frames: ~85k live, no saturation
        sk, _ok = fs.fused_step(c.static, c.params, None, s, f, unroll=u)
        sp_, _op = plain_frames(c.static, c.params, s, f, u)
        w = compare(c, sk, sp_, f32_ulps, f"stress_test U={u}")
        worst_rnd = {k: max(worst_rnd.get(k, 0), v) for k, v in w.items()}
        s = sk
    fresh = s.initial_scale[s.age == f.dt.item()].cpu().numpy()
    import scipy.stats

    ks = scipy.stats.kstest(fresh, scipy.stats.uniform(0.02, 0.06).cdf)
    check(fresh.size > 1000 and ks.pvalue > 1e-3, f"initial_scale KS p={ks.pvalue} on {fresh.size} lanes")
    emit({"phase": "random", "card": card, "n": 131072, "live": int(s.alive.sum()), "max_ulp": worst_rnd,
          "rule": "counts/cursor/cadence exact, f32 <= 4 ulp", "ks_initial_scale_p": float(ks.pvalue),
          "fresh_lanes": int(fresh.size)})
    s_random = s

    # ------------------------------------------------------- 4. unroll
    s8, _o = fs.fused_step(c.static, c.params, None, s_random, f, unroll=8)
    s1 = s_random
    for _ in range(8):
        s1, _o = fs.fused_step(c.static, c.params, None, s1, f)
    for k in active_f32_fields(c.static) + scalars:
        check(torch.equal(getattr(s8, k).cpu(), getattr(s1, k).cpu()), f"unroll: {k} differs")
    emit({"phase": "unroll", "card": card, "rule": "one U=8 launch == 8 single launches, bit for bit",
          "live": int(s8.alive.sum())})

    # -------------------------------------------------- 5. render pack
    sr, _o, planes = fs.fused_step(c.static, c.params, None, s_random, f, pack_render=True)
    compare_planes(c, sr, planes, "render pack")
    dense, count = bt.pack_instances_dense(c.params, sr, 0)
    check(torch.equal(planes[0], dense[3]), "render scale plane != dense pack scale")
    rows = bt.planes_to_rows(c.static, sr, planes)
    check(rows.shape[0] == int(count) and len(bt.instances_to_bytes(rows)) == int(count) * 64, "row bytes")
    emit({"phase": "render_pack", "card": card, "rows": int(rows.shape[0]), "bytes": int(rows.shape[0]) * 64})

    # ------------------------------------------------------------ timing
    def event_ms(fn, reps):
        """Wall time per call on the stream (CUDA events; host-bound calls
        measure the host)."""
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    trace_faults = []

    def device_ms(label, fn, reps, kernel_only, least_ms, kernels=("fused_step_kernel",)):
        """Device time per call from a torch.profiler trace: the named
        kernels' own time (kernel_only; each named kernel launches once per
        call), averaged over the launches the trace holds (a trace of 20
        calls may drop launches), or, otherwise, the time of every CUDA
        kernel over the calls. A trace that holds no launch of the named
        kernels, or that reads below least_ms (the least time the card could
        take for the call's work, from this run's shapes), is a measuring
        fault: it is recorded in `trace_faults` and traced again, three
        traces in all, and the run fails if all three are faulty."""
        fn()
        torch.cuda.synchronize()
        for _attempt in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device events only: a light trace
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            times = [device_times(prof, k) for k in kernels]
            if kernel_only:
                ms = sum(t[0] / t[2] for t in times) / 1e3 if all(t[2] > 0 for t in times) else 0.0
            else:
                ms = times[0][1] / reps / 1e3
            if ms > 0 and ms >= least_ms:
                return ms
            trace_faults.append({"label": label, "ms": ms, "least_ms": least_ms,
                                 "launches_in_trace": [t[2] for t in times]})
        raise CheckFailed(f"{label}: three traces read below the bound {least_ms} ms: {trace_faults[-3:]}")

    # ------------------------------------ 6./7. (and 11./12.) chained paths
    claim_kernels_names = ("dead_count_kernel", "tile_scan_kernel")

    def chain_path(label, spawner, rate, capacity, warm, n_frames, plain_n, colliders=None, unrolls=(8,),
                   fields=None, f32_ulps=4):
        """A `warm`-frame multi_step_auto chain from an empty pool (launches
        counted) against as many plain frames (f32 fields within f32_ulps),
        its render pack against the plain one, differential CUDA-event
        ms/frame over n and 2n frames, and device times (torch.profiler) of
        one launch per U in `unrolls` and of a render-pack launch, each
        beside the plain version's, each held to its bound (`bounds` in the
        result). fields:
        the scene's force fields (a list)."""
        es = dataclasses.replace(spawner.emission_settings[0], emission_pacing=EmissionPacing.rate(float(rate)))
        cm = bt.compile_spawner(dataclasses.replace(spawner, emission_settings=(es,)), device=dev)
        table = None if colliders is None else bt.compile_colliders(colliders, device=dev)
        ftable = None if fields is None else bt.compile_force_fields(fields, device=dev)
        # bench.py's _measure: the spawner at the origin
        frame = bt.make_frame_input(1 / 60, force_fields=ftable)
        state0 = bt.init_pool_for(cm, capacity, seed=0)
        (state, out), counts = counted(lambda: fs.multi_step_auto(cm.static, cm.params, table, state0, frame, warm))
        torch.cuda.synchronize()
        want = len(fs.chain_shape(warm, fs.chain_unroll(cm.static, table)))
        check(counts["fused_step"] == want and counts["render"] == 0 and counts["stats"] == 1
              and counts["collide"] == (0 if table is None else want)
              and counts["fields"] == (0 if ftable is None else want), f"{label}: the chain's launches {counts}")
        alive = int(out.alive_count)
        ref, ref_out = plain_frames(cm.static, cm.params, state0, frame, warm, colliders=table)
        check(int(ref_out.alive_count) == alive, f"{label}: alive {alive} != plain {int(ref_out.alive_count)}")
        for k in ("ring_cursor", "time_in_cycle", "last_emission", "alive"):
            check(torch.equal(getattr(ref, k), getattr(state, k)), f"{label}: {k} differs from plain")
        worst = {}
        for k in active_f32_fields(cm.static):
            a, b = getattr(ref, k), getattr(state, k)
            worst[k] = ulp_diff(a, b)
            for key, on in (("fused_step.collide", table is not None), ("fused_step.fields", ftable is not None)):
                if on:
                    max_err[key] = max(max_err[key], float((a - b).abs().max()))
            check(worst[k] <= f32_ulps, f"{label}: {k} {worst[k]} ulp from plain")
            check(bool(torch.isfinite(b).all()), f"{label}: non-finite {k}")
        res = {"phase": label, "card": card, "capacity": capacity, "rate": rate, "live": alive, "chain_frames": warm,
               "chain_launches": counts["fused_step"], "max_ulp": worst, "rule": f"counts exact, f32 <= {f32_ulps} ulp",
               "active_fields": len(active_f32_fields(cm.static))}
        if table is not None:
            free, _o = plain_frames(cm.static, cm.params, state0, frame, warm)
            res.update(colliders=len(colliders), lanes_deflected=int((state.alive & (state.py != free.py)).sum()))
        sr, _o, planes = fs.fused_step(cm.static, cm.params, table, state, frame, pack_render=True)
        compare_planes(cm, sr, planes, label)
        # bounds of the timed calls at this shape: f32 operations per live
        # lane and frame, the narrow phase's counted from a recorded plain
        # frame from this state (the tests this run's data needs, the skip
        # included), bytes of the planes each launch reads and writes
        lane_ops = INTEGRATE_OPS
        if fields is not None:
            lane_ops += FIELD_WEIGHT_OPS + sum(FIELD_OPS[fld.kind] for fld in fields)
        frame_ops = lane_ops * alive
        if table is not None:
            work = recorded_frame(cm, table, state, frame)
            frame_ops += work["ops"]
            res.update(narrow_ops_per_frame=work["ops"], skip_share=work["skip_share"],
                       broad_launches=counts["broad"])
        plane_bytes = 2 * 4 * len(active_f32_fields(cm.static)) * capacity
        bounds = {f"u{u}": bound(plane_bytes, u * frame_ops) for u in unrolls}
        bounds["render"] = bound(plane_bytes + 4 * L.N_RENDER * capacity, frame_ops)
        res["bounds"] = bounds

        def run(n):
            st, _o = fs.multi_step_auto(cm.static, cm.params, table, state, frame, n)
            return st

        def run_plain(n):
            st, _o = plain_frames(cm.static, cm.params, state, frame, n, colliders=table)
            return st

        def differential(fn, n, reps):
            diffs = []
            for _ in range(reps):
                t_n = event_ms(lambda: fn(n), 1)
                t_2n = event_ms(lambda: fn(2 * n), 1)
                diffs.append((t_2n - t_n) / n)
            return statistics.median(diffs)

        ms = differential(run, n_frames, 5)
        plain_ms = differential(run_plain, plain_n, 3)
        res.update(ms_per_frame=ms, particle_steps_per_s=alive / (ms * 1e-3), plain_ms_per_frame=plain_ms,
                   plain_particle_steps_per_s=alive / (plain_ms * 1e-3))

        # one U-frame launch vs U plain frames, one render-pack launch vs a
        # plain frame plus the plain pack, at this shape (no stats)
        def launch(u, render=False):
            return lambda: fs.fused_step(cm.static, cm.params, table, state, frame, unroll=u, pack_render=render,
                                         stats=False)

        def plain(u):
            return lambda: plain_frames(cm.static, cm.params, state, frame, u, stats=False, colliders=table)

        def plain_render():
            st, _o = plain_frames(cm.static, cm.params, state, frame, 1, stats=False, colliders=table)
            return pack_render_planes(cm.static, cm.params, st)

        for u in unrolls:
            least = bounds[f"u{u}"]["bound_ms"]
            res[f"u{u}_kernel_device_ms"] = device_ms(f"{label} U={u}", launch(u), 20, True, least)
            res[f"plain_{u}_frames_device_ms"] = device_ms(f"{label} plain {u}", plain(u), 1, False, least)
            res[f"u{u}_launch_wall_ms"] = event_ms(launch(u), 20)
            res[f"plain_{u}_frames_wall_ms"] = event_ms(plain(u), 1)
        least_r = bounds["render"]["bound_ms"]
        res.update(render_kernel_device_ms=device_ms(f"{label} render", launch(1, True), 20, True, least_r),
                   plain_render_frame_device_ms=device_ms(f"{label} plain render", plain_render, 1, False, least_r),
                   render_launch_wall_ms=event_ms(launch(1, True), 20),
                   plain_render_frame_wall_ms=event_ms(plain_render, 1))
        emit(res)
        return res, counts, cm, state

    stress_sp = effects.stress_test()[0]
    r100k, r100k_counts, c100k, s100k = chain_path("main_100k", stress_sp, 100_000, 1 << 17, 140, 400, 20)
    r1m, r1m_counts, c1m_main, s1m_main = chain_path("main_1M", stress_sp, 1_000_000, 160 * 8192, 140, 150, 10)

    # ------------------------------------------------ 8. sparks flow
    cs = bt.compile_spawner(bt.ParticleSpawner(
        particle_settings=[bt.ParticleSettings(lifetime=bt.RandF32.constant(0.75))],
        emission_settings=[bt.EmissionSettings(emission_pacing=bt.EmissionPacing.rate(1000.0))],
    ), device=dev)
    fsp = bt.make_frame_input(1 / 60)

    def sparks():
        ss = bt.init_pool_for(cs, 2048)
        for _ in range(120):
            ss, out, planes = bt.step_auto_packed(cs.static, cs.params, None, ss, fsp)
        return ss, out, planes

    (ss, out, planes), s_counts = counted(sparks)
    check(s_counts["fused_step"] == s_counts["render"] == 120, f"sparks flow: launches {s_counts} for 120 frames")
    compare_planes(cs, ss, planes, "sparks flow")
    rows = bt.planes_to_rows(cs.static, ss, planes)
    check(int(out.alive_count) == 750, f"sparks flow: {int(out.alive_count)} live, want 750")
    check(len(bt.instances_to_bytes(rows)) == 750 * 64, "sparks flow: row bytes")
    emit({"phase": "sparks_flow", "card": card, "live": int(out.alive_count), "bytes": 750 * 64,
          "launches": s_counts})

    # ------------------------------------------------ 9. collision_det
    def box_spawner(destroy=False, lifetime=2.0, handler=None):
        """Box emission, radial speed, no spread, gravity: every draw reaches
        the state through +, -, *, / and sqrt only (sinf/cosf see 0), so the
        kernel and the plain version agree bit for bit on every lane.
        handler: a particles_destroyed handler (the dump plane)."""
        return bt.ParticleSpawner(
            particle_settings=[bt.ParticleSettings(
                lifetime=bt.RandF32.constant(lifetime), initial_scale=bt.RandF32(0.02, 0.08),
                acceleration=(0.0, -9.81, 0.0), linear_drag=0.1,
                collision_settings=ParticleCollisionSettings(restitution=0.7, friction=0.3,
                                                             destroy_on_collision=destroy),
                event_handlers=bt.ParticleEventHandlers(particles_destroyed=handler))],
            emission_settings=[bt.EmissionSettings(
                emission_pacing=bt.EmissionPacing.rate(3e5), emission_shape=bt.EmissionShape.box((1.5, 0.5, 1.5)),
                initial_velocity=bt.RandVec3(bt.RandF32(0.5, 3.0), (0.0, 1.0, 0.0), 0.0),
                initial_velocity_radial=bt.RandF32(1.0, 4.0))],
        )

    s8, c8 = math.sin(math.pi / 8), math.cos(math.pi / 8)
    det_scenes = {
        "c7": [bt.Collider.halfspace(position=(0.0, -0.8, 0.0)),
               bt.Collider.cuboid((0.4, 0.3, 0.4), position=(1.6, 0.2, 0.0), rotation=(0.0, 0.0, s8, c8)),
               bt.Collider.sphere(0.5, position=(-1.4, 0.6, 0.2)),
               bt.Collider.capsule(0.25, 0.5, position=(0.3, 0.9, 1.5), rotation=(s8, 0.0, 0.0, c8)),
               bt.Collider.cylinder(0.4, 0.3, position=(-0.2, 0.8, -1.5)),
               bt.Collider.cone(0.6, 0.5, position=(1.2, 1.0, -1.2)),
               bt.Collider.hull_from_points([(0, 0, 0), (1, 0, 0), (0, 1.2, 0), (0, 0, 1)],
                                            position=(-1.3, -0.4, -1.3), rotation=(0.0, s8, 0.0, c8))],
        "c2": effects.stress_test_collision()[2],
        "tie": [bt.Collider.sphere(0.6, position=(0.5, 0.0, 0.5)),
                bt.Collider.cuboid((0.5, 0.5, 0.5), position=(0.7, 0.1, 0.5)),
                bt.Collider.halfspace(position=(0.0, -0.8, 0.0))],
    }
    det_res = {}
    fdet = bt.make_frame_input(1 / 60)
    for name, cols in det_scenes.items():
        c = bt.compile_spawner(box_spawner(), device=dev)
        table = bt.compile_colliders(cols, device=dev)
        s = bt.init_pool_for(c, 131072)
        s_free = s
        for u in [1] * 10 + [2] * 4:
            sk, _ok = fs.fused_step(c.static, c.params, table, s, fdet, unroll=u)
            sp_, _op = plain_frames(c.static, c.params, s, fdet, u, colliders=table)
            compare(c, sk, sp_, {}, f"collision_det {name} U={u}", kernel="fused_step.collide")
            s = sk
        s_free, _o = plain_frames(c.static, c.params, s_free, fdet, 18)  # no colliders
        bent = int((s.alive & ((s.vx != s_free.vx) | (s.vy != s_free.vy) | (s.vz != s_free.vz))).sum())
        check(bent > 1000, f"collision_det {name}: only {bent} lanes met a collider")
        det_res[name] = {"colliders": len(cols), "live": int(s.alive.sum()), "lanes_deflected": bent}
    torch.cuda.synchronize()
    emit({"phase": "collision_det", "card": card, "n": 131072, "scenes": det_res,
          "rule": "bit-equal over 10 U=1 and 4 U=2 launches"})

    # ------------------------------------------------ 10. destroy_claim
    cd = bt.compile_spawner(box_spawner(destroy=True), device=dev)
    check(not cd.static.ring_claim, "destroy archetype took the ring claim")
    table_c7 = bt.compile_colliders(det_scenes["c7"], device=dev)

    def destroy_run():
        st = bt.init_pool_for(cd, 131072)
        destroyed = 0
        for i in range(30):
            sk, ok = bt.step_auto(cd.static, cd.params, table_c7, st, fdet)
            sp_, op = plain_frames(cd.static, cd.params, st, fdet, 1, colliders=table_c7)
            compare(cd, sk, sp_, {}, f"destroy_claim frame {i}", kernel="fused_step.collide")
            check(int(ok.alive_count) == int(op.alive_count), f"destroy_claim frame {i}: alive count differs")
            destroyed += int((st.alive & ~sk.alive & (sk.age < sk.lifetime)).sum())
            st = sk
        return st, destroyed

    (sd, destroyed), d_counts = counted(destroy_run)
    check(d_counts["fused_step"] == 30 and d_counts["collide"] == 30 and d_counts["dead_claim"] == 30
          and d_counts["dead_seed"] == 1 and d_counts["dead_rank_claim"] == 0,
          f"destroy_claim launches {d_counts}: want 30 on carried counts, 1 seed, no count and scan pair")
    carried = fs._carried_claim(sd.alive)
    counts_plain = dead_tile_counts(sd.alive.cpu())
    check(carried is not None and torch.equal(carried.cpu(), counts_plain),
          "destroy_claim: the counts the last launch left differ from plain")
    offs = fs.tile_dead_offsets(sd.alive)
    offs_plain = fs.tile_dead_offsets(sd.alive.cpu())
    max_err["fused_step.dead_rank_claim"] = float(max((offs.cpu() - offs_plain).abs().max(),
                                                      (carried.cpu() - counts_plain).abs().max()))
    check(torch.equal(offs.cpu(), offs_plain), "destroy_claim: tile offsets differ from plain")
    tiles_dead = int((~sd.alive).view(-1, 256).any(1).sum())
    check(destroyed > 1000 and tiles_dead > 100, f"destroy_claim: {destroyed} destroyed, {tiles_dead} tiles")

    def claim_timing(label, cm, table, st, frame) -> dict:
        """Kernel row 4 at a destroy state (stats off): the launch on the
        carried counts and the same launch given the scanned offsets (the
        count -> scan route's step), interleaved (C S S C, 20 launches per
        trace), their difference (`carry_cost_ms`: the claim's cost with the
        carry, a difference of two traces); the seed's count kernel (on
        copies of the plane, made first), the count + scan pair, one
        torch.cumsum over the dead lanes (the library call) and the plain
        dead_rank (5 calls per trace). `bound`: the claim's own work, one u8
        plane read and the tile words; `launch_bound`: the launch's, its
        planes read and written once, the alive planes and the tile counts
        in and out (f32 operations: the integrate path per live lane)."""
        n = st.capacity
        b = bound(n + 4 * -(-n // L.TILE), n)
        least = b["bound_ms"]
        n_act = len(active_f32_fields(cm.static))
        lb = bound((2 * 4 * n_act + 2) * n + 8 * -(-n // L.TILE), INTEGRATE_OPS * int(st.alive.sum()))
        offs_ = fs.tile_dead_offsets(st.alive)

        def carried_launch():
            return fs.fused_step(cm.static, cm.params, table, st, frame, stats=False)

        def scanned_launch():
            return fs.fused_step(cm.static, cm.params, table, st, frame, stats=False, _dead_offsets=offs_)

        t = [device_ms(f"{label} {k} launch", fn, 20, True, lb["bound_ms"])
             for k, fn in (("carried", carried_launch), ("scanned", scanned_launch), ("scanned", scanned_launch),
                           ("carried", carried_launch))]
        copies = iter([st.alive.clone() for _ in range(64)])
        dead_i = (~st.alive).to(torch.int32)
        res = {"n": n, "carried_launch_ms": (t[0] + t[3]) / 2, "scanned_launch_ms": (t[1] + t[2]) / 2,
               "ccsc_ms": t, "bound": b, "launch_bound": lb,
               "seed_ms": device_ms(f"{label} seed", lambda: fs.claim_counts(next(copies)), 20, True, least,
                                    ("dead_count_kernel",)),
               "count_scan_ms": device_ms(f"{label} count + scan", lambda: fs.tile_dead_offsets(st.alive), 20, True,
                                          least, claim_kernels_names),
               "cumsum_ms": device_ms(f"{label} torch.cumsum", lambda: torch.cumsum(dead_i, 0), 5, False, least),
               "plain_dead_rank_device_ms": device_ms(f"{label} plain", lambda: dead_rank(~st.alive), 5, False,
                                                      least)}
        res["carry_cost_ms"] = res["carried_launch_ms"] - res["scanned_launch_ms"]
        return res

    claim = claim_timing("destroy_claim", cd, table_c7, sd, fdet)
    claim_bound = claim["bound"]
    emit({"phase": "destroy_claim", "card": card, "n": 131072, "frames": 30, "live": int(sd.alive.sum()),
          "destroyed": destroyed, "tiles": 512, "tiles_with_dead_lanes": tiles_dead, "launches": d_counts,
          **claim, "rule": "claims, alive, cursor and fields bit-equal each frame; 30 launches on carried counts, "
                           "1 seed, no count + scan pair; the counts the last launch left == plain; tile offsets "
                           "== plain"})

    # ------------------------------------------- 11./12. collision at 1M
    spc = effects.stress_test_collision()[0]
    c1m, c1m_counts, _cm, _st = chain_path("collision_1M", spc, 500_000, 160 * 8192, 150, 150, 5,
                                           effects.stress_test_collision()[2], (2, 8))
    hulls = [bt.Collider.hull([(1, 0, 0, 60.0), (-1, 0, 0, 60.0), (0, 1, 0, 1.0), (0, -1, 0, 1.0), (0, 0, 1, 60.0),
                               (0, 0, -1, 60.0)], position=(0.0, -1.5, 0.0))]
    for i in range(7):
        hulls.append(bt.Collider.hull_from_points([(0, 0, 0), (2.0, 0, 0), (0, 2.5, 0), (0, 0, 2.0)],
                                                  position=(float(i * 3 - 9), -0.5, float((i % 3) * 3 - 3))))
    h8, h8_counts, _cm, _st = chain_path("hull8_1M", spc, 500_000, 160 * 8192, 120, 120, 3, hulls, (2, 8))

    # ------------------------------------------------ 13. collision flow
    spf, tff, colf = effects.collision()
    cf = bt.compile_spawner(spf, device=dev)
    tablef = bt.compile_colliders(colf, device=dev)
    ff = bt.make_frame_input(1 / 60, translation=tff.translation, rotation=tff.rotation)

    def collision_flow():
        st = bt.init_pool_for(cf, 1024)
        for _ in range(400):
            st, out, planes = bt.step_auto_packed(cf.static, cf.params, tablef, st, ff)
        return st, out, planes

    (sf, outf, planesf), f_counts = counted(collision_flow)
    check(f_counts["fused_step"] == f_counts["render"] == f_counts["collide"] == 400,
          f"collision flow launches {f_counts}")
    sfp = bt.init_pool_for(cf, 1024)
    for _ in range(400):
        sfp, outp = plain_frames(cf.static, cf.params, sfp, ff, 1, colliders=tablef)
    compare(cf, sf, sfp, {}, "collision flow", kernel="fused_step.collide")
    check(int(outf.alive_count) == int(outp.alive_count), "collision flow: live count differs from plain")
    compare_planes(cf, sf, planesf, "collision flow")
    for a, b in zip(planesf, pack_render_planes(cf.static, cf.params, sfp)):
        check(torch.equal(a, b), "collision flow: render planes differ from the plain flow's")
    rows = bt.planes_to_rows(cf.static, sf, planesf)
    check(rows.shape[0] == int(outf.alive_count) > 600, f"collision flow: {rows.shape[0]} rows")
    emit({"phase": "collision_flow", "card": card, "live": int(outf.alive_count), "frames": 400,
          "launches": f_counts, "bytes": int(rows.shape[0]) * 64})

    # ------------------------------------------------ 14. many_collider_det
    import torch_table_configs as table_cfg
    from bevy_firework_tpu_torch.parallel.sharding import stack_frames, stack_pools, state_slot
    from bevy_firework_tpu_torch.step import stat_reductions

    mc_res = {}
    for name, (cols, disabled) in table_cfg.det_scenes().items():
        c = bt.compile_spawner(box_spawner(), device=dev)
        table = table_cfg.compile_with_disabled(cols, disabled, dev)
        words = fs.kernel_colliders(table).numel()
        check((words > L.SMEM_COLLIDER_WORDS) == (name == "c200"), f"many_collider_det {name}: {words} table words")
        s = bt.init_pool_for(c, 131072)
        shares = {}
        launches = [1] * 10 + [2] * 4
        for i, u in enumerate(launches):
            if i in (0, 9):  # the skip share on the first frame's state, and on the tenth's
                with pcol.record_substeps() as log:
                    recorded, _o = plain_frames(c.static, c.params, s, fdet, 1, stats=False, colliders=table)
                shares[f"frame_{i + 1}"] = narrow_work(table, log)["skip_share"]
            before = fs.fused_step.broad_launches
            sk, _ok = fs.fused_step(c.static, c.params, table, s, fdet, unroll=u)
            check(fs.fused_step.broad_launches - before == 1, f"many_collider_det {name}: the broad phase did not run")
            if i in (0, len(launches) - 1):  # the plain version (seconds of host time a frame at 200 colliders)
                sp_ = recorded if i == 0 else plain_frames(c.static, c.params, s, fdet, u, colliders=table)[0]
                compare(c, sk, sp_, {}, f"many_collider_det {name} U={u}", kernel="fused_step.collide_broad")
            s = sk
        s_free, _o = plain_frames(c.static, c.params, bt.init_pool_for(c, 131072), fdet, 18)  # no colliders
        bent = int((s.alive & ((s.vx != s_free.vx) | (s.vy != s_free.vy) | (s.vz != s_free.vz))).sum())
        check(bent > 1000, f"many_collider_det {name}: only {bent} lanes met a collider")
        mc_res[name] = {"colliders": table.count, "hulls": sum(k == COLLIDER_HULL for k in table.kinds),
                        "disabled": len(disabled), "table_words": words,
                        "global_memory": words > L.SMEM_COLLIDER_WORDS, "live": int(s.alive.sum()),
                        "lanes_deflected": bent, "skip_share": shares}
    torch.cuda.synchronize()
    emit({"phase": "many_collider_det", "card": card, "n": 131072, "scenes": mc_res,
          "rule": "the narrow phase with its broad phase == the plain version without a skip, "
                  "bit for bit on the first of 10 U=1 launches and the last of 4 U=2 launches (the chain's "
                  "state); skip_share: the share of (warp, collider, substep) "
                  "tests collision.broad_phase_keep skips in a plain frame from the first frame's and the tenth's state"})

    # ------------------------------------------------ 15. caps_det
    caps_res = {}
    for case in table_cfg.CAPS:
        cc = bt.compile_spawner(table_cfg.caps_spawner(case), device=dev)
        s = bt.init_pool_for(cc, 131072)
        launches = [1] * 3 + [8] * 2
        for i, u in enumerate(launches):
            sk, ok, planes = fs.fused_step(cc.static, cc.params, None, s, fdet, unroll=u, pack_render=True)
            if i in (0, len(launches) - 1):  # the plain version on the first and the last launch
                sp_, _op = plain_frames(cc.static, cc.params, s, fdet, u)
                compare(cc, sk, sp_, {}, f"caps_det {case} U={u}")
            compare_planes(cc, sk, planes, f"caps_det {case} U={u}")
            want = stat_reductions(cc.static, cc.params, {k: getattr(sk, k) for k in (
                "px", "py", "pz", "initial_scale", "age", "lifetime")}, sk.ptype, sk.alive)
            for got, w in zip((ok.aabb_min, ok.aabb_max, ok.alive_count, ok.alive_count_per_type), want):
                check(torch.equal(got, w), f"caps_det {case} U={u}: stats row != the plain reductions")
            s = sk
        check(int((ok.alive_count_per_type > 0).sum()) == cc.num_types and int(ok.alive_count) > 20000,
              f"caps_det {case}: {ok.alive_count_per_type.tolist()}")
        caps_res[case] = {"emitters": cc.num_emitters, "types": cc.num_types, "knots": int(cc.params.scale_ts.shape[1]),
                          "table_words": fs.kernel_tables(cc.static, cc.params).numel(),
                          "per_type": ok.alive_count_per_type.tolist()}
    # the warp's cadence (U > 1, up to 32 emitters) through its vote and
    # ballot branches: 7 emitters of mixed pacing with a queue, the last one
    # disabled at the U = 2 launches, with and without the stats row
    cm7 = bt.compile_spawner(table_cfg.mixed_pacing_spawner(7), device=dev)
    s = bt.init_pool_for(cm7, 131072, seed=2)
    en7 = s.enabled.clone()
    en7[6] = False
    for u, stats in ((2, True), (1, True), (8, True), (8, False), (2, False)):
        s = dataclasses.replace(s, manual_queued=torch.tensor(300 + 7 * u, dtype=torch.int32, device=dev),
                                enabled=en7 if u == 2 else s.enabled)
        sk, _ok = fs.fused_step(cm7.static, cm7.params, None, s, fdet, unroll=u, stats=stats)
        sp_, _op = plain_frames(cm7.static, cm7.params, s, fdet, u)
        compare(cm7, sk, sp_, {}, f"caps_det mixed7 U={u} stats={stats}")
        check(int(sk.manual_queued) == 0, f"caps_det mixed7 U={u}: the queue was not taken")
        s = sk
    check(int(s.alive.sum()) > 5000, f"caps_det mixed7: {int(s.alive.sum())} live")
    caps_res["mixed7"] = {"emitters": 7, "live": int(s.alive.sum())}
    cb9 = bt.compile_spawner(box_spawner(), device=dev)
    f9 = bt.make_frame_input(1 / 60, force_fields=bt.compile_force_fields(table_cfg.nine_fields(), device=dev))
    s = bt.init_pool_for(cb9, 131072)
    launches = [1] * 3 + [8] * 2
    for i, u in enumerate(launches):
        sk, _ok = fs.fused_step(cb9.static, cb9.params, None, s, f9, unroll=u)
        if i in (0, len(launches) - 1):
            sp_, _op = plain_frames(cb9.static, cb9.params, s, f9, u)
            compare(cb9, sk, sp_, {}, f"caps_det fields9 U={u}", kernel="fused_step.fields")
        s = sk
    caps_res["fields9"] = {"fields": 9, "live": int(s.alive.sum())}
    frames9 = [bt.make_frame_input(1 / 60, force_fields=bt.compile_force_fields(table_cfg.nine_fields(0.3 * i),
                                                                               device=dev)) for i in range(3)]
    pools9 = [bt.init_pool_for(cb9, 65536, seed=i) for i in range(3)]
    st9 = stack_pools(pools9)
    for j, u in enumerate((1, 8, 8)):
        st9, _o = fs.fused_step_fleet(cb9.static, cb9.params, None, st9, stack_frames(frames9), unroll=u)
        for i in range(3):
            solo, _o = fs.fused_step(cb9.static, cb9.params, None, pools9[i], frames9[i], unroll=u)
            for k in active_f32_fields(cb9.static) + ("ring_cursor", "alive"):
                check(torch.equal(getattr(state_slot(st9, i), k), getattr(solo, k)), f"caps_det fleet fields9 {k}")
            if j == 0 or (j == 2 and i == 0):  # the plain version: every slot's first launch, slot 0's last
                plain9, _o = plain_frames(cb9.static, cb9.params, pools9[i], frames9[i], u)
                compare(cb9, solo, plain9, {}, f"caps_det fleet fields9 slot {i} U={u}", kernel="fused_step.fleet")
            pools9[i] = solo
    caps_res["fields9_fleet"] = {"slots": 3, "fields": 9, "live": [int(p.alive.sum()) for p in pools9]}
    # the entry points past every old cap at once: a Scene (200 colliders,
    # nine fields, nine emitters and types) and a Fleet (200 colliders),
    # each against the plain version replaying it on the card; 2 frames
    # (the `cuda` test takes 6): a plain frame against 200 colliders costs
    # seconds of host time
    nl = 2
    (sc_l, sid_l), scene_l_counts = counted(lambda: table_cfg.lifted_scene(dev, nl))
    slot_l = sc_l._spawners[sid_l]
    st_l, out_l = table_cfg.plain_replay(sc_l, sid_l, nl)
    compare(slot_l.compiled, slot_l.state, st_l, {}, "caps_det Scene", kernel="fused_step.collide_broad")
    check(sc_l.alive_count() == int(out_l.alive_count) > 5000 and scene_l_counts["broad"] == nl
          and scene_l_counts["fields"] == nl, f"caps_det Scene: {sc_l.alive_count()} live, {scene_l_counts}")
    fleet_l, fleet_l_counts = counted(lambda: table_cfg.lifted_fleet(dev, nl))
    for i in (0, 1):
        compare(fleet_l.compiled, state_slot(fleet_l.states, i), table_cfg.fleet_plain_replay(fleet_l, i, nl), {},
                f"caps_det Fleet slot {i}", kernel="fused_step.fleet")
    check(fleet_l.alive_count() > 1000 and fleet_l_counts["fleet_broad"] == nl, f"caps_det Fleet: {fleet_l_counts}")
    caps_res["entry_points"] = {"scene_live": sc_l.alive_count(), "scene_colliders": sc_l._colliders.count,
                                "fleet_live": fleet_l.alive_count(), "frames": nl}
    torch.cuda.synchronize()
    emit({"phase": "caps_det", "card": card, "n": 131072, "cases": caps_res,
          "rule": "past the old caps (16 knots, 8 emitters, 8 types, 8 fields): kernel == plain bit for bit (state "
                  "on the first and the last launch, render planes on every launch), stats row == the plain "
                  "reductions; mixed7: 7 emitters of mixed pacing with a queue "
                  "at U = 1, 2, 8 (the warp's cadence), state and cadence scalars bit for bit; 9 fields solo and in "
                  "a 3-slot fleet (each slot "
                  "== its solo launch == plain); a Scene and a Fleet past every cap == their plain replay"})

    # ------------------------------------------------ 16. collider_scaling_1M
    es_sc = dataclasses.replace(spc.emission_settings[0], emission_pacing=EmissionPacing.rate(500_000.0))
    csc = bt.compile_spawner(dataclasses.replace(spc, emission_settings=(es_sc,)), device=dev)
    fsc = bt.make_frame_input(1 / 60)
    n_sc = 160 * 8192
    plane_bytes_sc = 2 * 4 * len(active_f32_fields(csc.static)) * n_sc
    scaling, scaling_counts = [], {}

    def sc_differential(table, state, n, reps):
        """Differential ms/frame of multi_step_auto over n and 2n frames."""
        diffs = []
        for _ in range(reps):
            t_n = event_ms(lambda: fs.multi_step_auto(csc.static, csc.params, table, state, fsc, n), 1)
            t_2n = event_ms(lambda: fs.multi_step_auto(csc.static, csc.params, table, state, fsc, 2 * n), 1)
            diffs.append((t_2n - t_n) / n)
        return statistics.median(diffs)

    for hulls, sizes in ((False, (1, 2, 4, 8, 16, 32, 64, 128)), (True, (8, 16, 32, 64))):
        for C in sizes:
            table = bt.compile_colliders(table_cfg.scaling_colliders(C, hulls), device=dev)
            (st, out), cnt = counted(lambda: fs.multi_step_auto(csc.static, csc.params, table,
                                                                bt.init_pool_for(csc, n_sc, seed=0), fsc, 140))
            for k, v in cnt.items():
                scaling_counts[k] = scaling_counts.get(k, 0) + v
            live = int(out.alive_count)
            label = f"collider_scaling C={C}{' (1/4 hulls)' if hulls else ''}"
            # the U = 2 launch against 2 plain frames from the warm state
            # (f32 within 4 ulp: the spray's draws meet sinf/cosf)
            sk, _o = fs.fused_step(csc.static, csc.params, table, st, fsc, unroll=2, stats=False)
            sp_, _o = plain_frames(csc.static, csc.params, st, fsc, 2, stats=False, colliders=table)
            compare(csc, sk, sp_, {k: 4 for k in active_f32_fields(csc.static)}, label,
                    kernel="fused_step.collide_broad" if C >= pcol.LOOP_MIN_COLLIDERS else "fused_step.collide")
            work = recorded_frame(csc, table, st, fsc)
            b2 = bound(plane_bytes_sc, 2 * (INTEGRATE_OPS * live + work["ops"]))

            def u2(table=table, st=st):
                return fs.fused_step(csc.static, csc.params, table, st, fsc, unroll=2, stats=False)

            row = {"colliders": C, "hulls": hulls, "live": live, "ms_per_frame": sc_differential(table, st, 100, 5),
                   "u2_kernel_device_ms": device_ms(f"{label} U=2", u2, 20, True, b2["bound_ms"]), "bound": b2,
                   "skip_share": work["skip_share"], "tests_kept": work["tests_kept"], "tests": work["tests"], "launches": cnt}
            if C == 32 and not hulls:
                row["plain_2_frames_device_ms"] = device_ms(f"{label} plain 2", lambda: plain_frames(
                    csc.static, csc.params, st, fsc, 2, stats=False, colliders=table), 1, False, b2["bound_ms"])
            scaling.append(row)
    check(len({r["live"] for r in scaling}) == 1 and scaling[0]["live"] > 900000,
          f"collider_scaling: live counts {[r['live'] for r in scaling]} (the ring's count is the cadence's)")
    emit({"phase": "collider_scaling_1M", "card": card, "capacity": n_sc, "rate": 500_000.0, "warm_frames": 140,
          "rows": scaling, "rule": "tools/collider_scaling_tpu.py's scenes: per C a 140-frame multi_step_auto chain, "
                                   "its U=2 launch == 2 plain frames (f32 <= 4 ulp); ms/frame differential over 100 "
                                   "and 200 frames (median of 5); the U=2 launch's device time against its bound (the narrow "
                                   "phase's operations counted from a recorded plain frame, the skip included)"})

    # ------------------------------------------------ 17. fields_det
    field_kinds = {
        "point": bt.ForceField.point((0.3, 0.8, -0.2), 6.0, 2.5),
        "vortex": bt.ForceField.vortex((0.1, 0.0, 0.2), (0.3, 0.9, 0.1), 5.0, 3.0),
        "axial": bt.ForceField.axial((-0.2, 0.0, 0.1), (0.0, 1.0, 0.0), 8.0, 2.0),
        "turbulence": bt.ForceField.turbulence((0.0, 0.5, 0.0), 4.0, 6.0, frequency=1.7, phase=0.3),
    }
    cb = bt.compile_spawner(box_spawner(), device=dev)
    fdet_res = {}
    for name in list(field_kinds) + ["all"]:
        fl = list(field_kinds.values()) if name == "all" else [field_kinds[name]]
        ftab = bt.compile_force_fields(fl + [field_kinds["point"]], device=dev, active=[True] * len(fl) + [False])
        fr = bt.make_frame_input(1 / 60, force_fields=ftab)
        # turbulence: 9 cosf per lane and field against PyTorch's CUDA cos
        allowed = 8 if name in ("turbulence", "all") else 0
        s = bt.init_pool_for(cb, 131072)
        worst = {}
        for u in [1] * 4 + [8] * 4:
            sk, _ok = fs.fused_step(cb.static, cb.params, None, s, fr, unroll=u)
            sp_, _op = plain_frames(cb.static, cb.params, s, fr, u)
            w = compare(cb, sk, sp_, {k: allowed for k in active_f32_fields(cb.static)}, f"fields_det {name} U={u}",
                        kernel="fused_step.fields")
            worst = {k: max(worst.get(k, 0), v) for k, v in w.items()}
            s = sk
        free, _o = plain_frames(cb.static, cb.params, bt.init_pool_for(cb, 131072), bt.make_frame_input(1 / 60), 36)
        moved = int((s.alive & (s.vx != free.vx)).sum())
        check(moved > 1000, f"fields_det {name}: the field moved {moved} lanes")
        fdet_res[name] = {"max_ulp": max(worst.values()), "allowed_ulp": allowed, "lanes_moved": moved}
    # the field fleet (the fleet's field instantiations): 3 slots of 65536
    # lanes under the tornado's fields, moved per slot; each slot == its
    # solo launch bit for bit, the solo launch == plain under the rule above
    from bevy_firework_tpu_torch.pool import POOL_FIELDS

    ff_frames = [bt.make_frame_input(1 / 60, force_fields=bt.compile_force_fields(tornado_fields(0.2 * i, 0.1),
                                                                                  device=dev)) for i in range(3)]
    ff_pools = [bt.init_pool_for(cb, 65536, seed=i) for i in range(3)]
    ff_st, ff_fr, worst = stack_pools(ff_pools), stack_frames(ff_frames), {}
    for u in (1, 8, 8, 1):
        ff_st, _o = fs.fused_step_fleet(cb.static, cb.params, None, ff_st, ff_fr, unroll=u)
        for i in range(3):
            solo, _o = fs.fused_step(cb.static, cb.params, None, ff_pools[i], ff_frames[i], unroll=u)
            sp_, _op = plain_frames(cb.static, cb.params, ff_pools[i], ff_frames[i], u)
            for k in POOL_FIELDS:
                check(torch.equal(getattr(state_slot(ff_st, i), k), getattr(solo, k)),
                      f"fields_det fleet U={u} slot {i}: {k} != its solo launch")
            w = compare(cb, solo, sp_, {k: 8 for k in active_f32_fields(cb.static)}, f"fields_det fleet U={u} slot {i}",
                        kernel="fused_step.fields")
            worst = {k: max(worst.get(k, 0), v) for k, v in w.items()}
            ff_pools[i] = solo
    fdet_res["tornado_fleet"] = {"max_ulp": max(worst.values()), "allowed_ulp": 8, "live": int(ff_st.alive.sum())}
    # the turbulence's straight-line cosines are CUDA's cosf below its bound
    cos_bad = fs.cos_fast_mismatches(dev)
    check(cos_bad == 0, f"fields_det: cos_fast differs from cosf on {cos_bad} floats below its bound")
    torch.cuda.synchronize()
    emit({"phase": "fields_det", "card": card, "n": 131072, "configs": fdet_res,
          "cos_fast_floats_checked": 2 * fs.COS_FAST_BITS, "cos_fast_mismatches": cos_bad,
          "rule": "bit-equal on point, vortex, axial; turbulence <= 8 ulp (cosf); 4 U=1 and 4 U=8 launches; "
                  "tornado_fleet: each of 3 slots == its solo launch bit for bit, solo == plain within 8 ulp; "
                  "cos_fast == cosf on every float below its bound"})

    # ------------------------------------------------ 18. dump_det
    dump_res = {}
    for destroy in (False, True):
        cdm = bt.compile_spawner(box_spawner(destroy=destroy, lifetime=0.1, handler=lambda records: None), device=dev)
        check(cdm.static.any_destroyed_dump and cdm.static.ring_claim == (not destroy), "dump archetype")
        tdm = table_c7 if destroy else None
        s = bt.init_pool_for(cdm, 131072)
        dumped = 0
        for i in range(12):
            sk, ok = fs.fused_step(cdm.static, cdm.params, tdm, s, fdet)
            sp_, op = plain_frames(cdm.static, cdm.params, s, fdet, 1, colliders=tdm)
            compare(cdm, sk, sp_, {}, f"dump_det destroy={destroy} frame {i}", kernel="fused_step.dump")
            check(torch.equal(ok.destroyed_mask, op.destroyed_mask), f"dump_det destroy={destroy} frame {i}: mask")
            max_err["fused_step.dump"] = max(max_err["fused_step.dump"], float(
                (ok.destroyed_mask.float() - op.destroyed_mask.float()).abs().max()))
            dumped += int(ok.destroyed_mask.sum())
            s = sk
        check(dumped > 1000, f"dump_det destroy={destroy}: {dumped} lanes dumped")
        dump_res["destroy_on_collision" if destroy else "ring_by_age"] = {"dumped": dumped, "live": int(s.alive.sum())}
        if not destroy:  # timing: the ring archetype alone, so the launch differs by the dump plane only
            c_nodump = bt.compile_spawner(box_spawner(lifetime=0.1), device=dev)
            dump_state, c_dump = s, cdm
    dump_live, dump_planes = int(dump_state.alive.sum()), 2 * 4 * len(active_f32_fields(c_dump.static)) * 131072
    dump_bound = bound(dump_planes + 131072, INTEGRATE_OPS * dump_live)
    least_nodump = bound(dump_planes, INTEGRATE_OPS * dump_live)["bound_ms"]
    dump_t = {"ms": device_ms("dump", lambda: fs.fused_step(c_dump.static, c_dump.params, None, dump_state, fdet), 20,
                              True, dump_bound["bound_ms"]),
              "ms_without": device_ms("dump without the plane", lambda: fs.fused_step(
                  c_nodump.static, c_nodump.params, None, dump_state, fdet), 20, True, least_nodump),
              "plain_ms": device_ms("dump plain", lambda: plain_frames(c_dump.static, c_dump.params, dump_state, fdet,
                                                                       1), 3, False, dump_bound["bound_ms"]),
              "live": dump_live}
    emit({"phase": "dump_det", "card": card, "n": 131072, "frames": 12, "archetypes": dump_res, **dump_t,
          "rule": "dump plane == plain destroyed mask, every frame; fields bit-equal"})

    # ------------------------------------------------ 19. stats_det
    from bevy_firework_tpu_torch.step import stat_reductions

    def three_types():
        types = [bt.ParticleSettings(lifetime=bt.RandF32.constant(0.5 + 0.2 * t),
                                     initial_scale=bt.RandF32(0.02, 0.08),
                                     scale_curve=bt.FireworkCurve.uneven_samples([(0.0, 1.0), (1.0, 0.5 + t)]),
                                     acceleration=(0.0, -1.0 * t, 0.0)) for t in range(3)]
        return bt.ParticleSpawner(particle_settings=types, emission_settings=[
            bt.EmissionSettings(particle_index=t, emission_pacing=bt.EmissionPacing.rate(2e5 * (t + 1)),
                                emission_shape=bt.EmissionShape.box((1.0 + t, 0.5, 1.0)),
                                initial_velocity=bt.RandVec3(bt.RandF32(0.5, 3.0), (0.0, 1.0, 0.0), 0.0),
                                initial_velocity_radial=bt.RandF32(1.0, 4.0)) for t in range(3)])

    n1m = 160 * 8192
    cdr = bt.compile_spawner(box_spawner(destroy=True), device=dev)
    c3 = bt.compile_spawner(three_types(), device=dev)
    stats_cases = {
        "ring_stress_test": (c1m_main, None, s1m_main, [1, 1, 8, 1]),
        "dead_rank_destroy": (cdr, table_c7, fs.multi_step_auto(cdr.static, cdr.params, table_c7,
                                                                bt.init_pool_for(cdr, n1m), fdet, 20)[0], [1] * 4),
        "three_types": (c3, None, fs.multi_step_auto(c3.static, c3.params, None, bt.init_pool_for(c3, n1m), fdet,
                                                     20)[0], [1, 8, 1]),
    }
    stats_keys = ("px", "py", "pz", "initial_scale", "age", "lifetime")
    stats_res = {}
    for name, (cs_, tab, s, unrolls) in stats_cases.items():
        for u in unrolls:
            sk, ok = fs.fused_step(cs_.static, cs_.params, tab, s, fdet, unroll=u)
            st_, _ot = fs.fused_step(cs_.static, cs_.params, tab, s, fdet, unroll=u, stats=False)
            want = dict(zip(("aabb_min", "aabb_max", "alive_count", "alive_count_per_type"), stat_reductions(
                cs_.static, cs_.params, {k: getattr(sk, k) for k in stats_keys}, sk.ptype, sk.alive)))
            for k, v in want.items():
                check(torch.equal(getattr(ok, k), v), f"stats_det {name} U={u}: {k} differs from the plain reductions")
            check(bool(ok.aabb_valid) == (int(want["alive_count"]) > 0), f"stats_det {name} U={u}: aabb_valid")
            for k in ("aabb_min", "aabb_max"):
                max_err["fused_step.stats"] = max(max_err["fused_step.stats"], float((getattr(ok, k) - want[k]).abs().max()))
            compare(cs_, sk, st_, {}, f"stats_det {name} U={u}", kernel="fused_step.stats")
            s = sk
        stats_res[name] = {"live": int(ok.alive_count), "per_type": ok.alive_count_per_type.tolist(),
                           "aabb_min": ok.aabb_min.tolist(), "aabb_max": ok.aabb_max.tolist()}
        check(int(ok.alive_count) > 50000 and bool(ok.aabb_valid), f"stats_det {name}: {stats_res[name]}")
    cs_, tab, s, _u = stats_cases["ring_stress_test"]
    kw = {k: getattr(s, k) for k in stats_keys}
    stats_live, stats_planes = int(s.alive.sum()), 2 * 4 * len(active_f32_fields(cs_.static)) * n1m
    stats_bound = bound(stats_planes, (INTEGRATE_OPS + STATS_OPS) * stats_live)
    least_plain = stats_bound["bound_ms"]
    # the reductions alone read the 6 planes they fold and the alive plane
    least_red = bound((6 * 4 + 1) * n1m, STATS_OPS * stats_live)["bound_ms"]
    stats_t = {"ms": device_ms("stats", lambda: fs.fused_step(cs_.static, cs_.params, None, s, fdet), 20, True,
                               stats_bound["bound_ms"]),
               "ms_without": device_ms("stats without the block", lambda: fs.fused_step(
                   cs_.static, cs_.params, None, s, fdet, stats=False), 20, True,
                   bound(stats_planes, INTEGRATE_OPS * stats_live)["bound_ms"]),
               "plain_ms": device_ms("stats plain", lambda: plain_frames(cs_.static, cs_.params, s, fdet, 1), 3, False,
                                     least_plain),
               "plain_reductions_ms": device_ms("stats plain reductions", lambda: stat_reductions(
                   cs_.static, cs_.params, kw, s.ptype, s.alive), 20, False, least_red),
               "live": stats_live, "n": n1m}
    # the Scene's size: the sparks flow's pool (2048 lanes, 750 live), the
    # launch with the stats block beside the same launch without it
    sk, ok = fs.fused_step(cs.static, cs.params, None, ss, fsp)
    want = stat_reductions(cs.static, cs.params, {k: getattr(sk, k) for k in stats_keys}, sk.ptype, sk.alive)
    for got, w in zip((ok.aabb_min, ok.aabb_max, ok.alive_count, ok.alive_count_per_type), want):
        check(torch.equal(got, w), "stats_det sparks pool: stats row != the plain reductions")
    sp_live, sp_planes = int(ss.alive.sum()), 2 * 4 * len(active_f32_fields(cs.static)) * ss.capacity
    stats_t["sparks"] = {
        "n": ss.capacity, "live": sp_live,
        "ms": device_ms("stats sparks", lambda: fs.fused_step(cs.static, cs.params, None, ss, fsp), 20, True,
                        bound(sp_planes, (INTEGRATE_OPS + STATS_OPS) * sp_live)["bound_ms"]),
        "ms_without": device_ms("stats sparks without the block", lambda: fs.fused_step(
            cs.static, cs.params, None, ss, fsp, stats=False), 20, True,
            bound(sp_planes, INTEGRATE_OPS * sp_live)["bound_ms"])}
    # float edges: a NaN position makes its axis's bounds NaN; -0, +0 and
    # +-inf reduce as the plain reductions do (by value, NaN where NaN)
    import torch_stats_configs as stats_cfg

    edge_res = {}
    for case in stats_cfg.EDGE_CASES:
        ce, se, fe = stats_cfg.edge_pool(case, dev)
        sk, ok = fs.fused_step(ce.static, ce.params, None, se, fe)
        _sp, op = plain_frames(ce.static, ce.params, se, fe, 1)
        want = dict(zip(("aabb_min", "aabb_max", "alive_count", "alive_count_per_type"), stat_reductions(
            ce.static, ce.params, {k: getattr(sk, k) for k in stats_keys}, sk.ptype, sk.alive)))
        for k, v in want.items():
            check(stats_cfg.rows_equal(getattr(ok, k), v) and stats_cfg.rows_equal(getattr(ok, k), getattr(op, k)),
                  f"stats_det edge {case}: {k} {getattr(ok, k).tolist()} != plain {v.tolist()}")
        check((bool(torch.isnan(ok.aabb_min[0])) and bool(torch.isnan(ok.aabb_max[0]))) if case == "nan" else
              (float(ok.aabb_max[1]) == math.inf and float(ok.aabb_min[2]) == -math.inf),
              f"stats_det edge {case}: {ok.aabb_min.tolist()} {ok.aabb_max.tolist()}")
        edge_res[case] = {"aabb_min": [str(v) for v in ok.aabb_min.tolist()],
                          "aabb_max": [str(v) for v in ok.aabb_max.tolist()], "live": int(ok.alive_count)}
    emit({"phase": "stats_det", "card": card, "n": n1m, "cases": stats_res, "edges": edge_res, **stats_t,
          "rule": "kernel stats row == the plain reductions of the launch's state by value (edges: NaN where NaN, "
                  "-0 == +0); state bit-equal; sparks: the Scene's pool size, with and without the block"})

    # ------------------------------------------------ 20. fields_1M
    from bevy_firework_tpu_torch.models import library

    dust1m = library.dust(rate=3e5, lifetime=4.0, updraft=2.5, drag=2.0, emit_radius=1.2)
    # f32 rule: dust draws meet sinf/cosf at spawn and turbulence 9 cosf per
    # lane-frame; 300 frames of integration carry an ulp where libm parts
    f1m, f1m_counts, _cm, _st = chain_path("fields_1M", dust1m, 300_000, n1m, 300, 150, 3, fields=tornado_fields(),
                                           f32_ulps=64)

    # ------------------------------------------------ 21. scene_flows
    sparks_sp = bt.ParticleSpawner(
        particle_settings=[bt.ParticleSettings(lifetime=bt.RandF32.constant(0.75))],
        emission_settings=[bt.EmissionSettings(emission_pacing=bt.EmissionPacing.rate(1000.0))])

    def sparks_scene(device):
        sc = bt.Scene(device=device)
        sc.add_spawner(sparks_sp, capacity=2048)
        for _ in range(120):
            sc.step(1 / 60)
        live = sc.alive_count()
        first = sc.render_items()  # turns the in-kernel render pack on
        sc.step(1 / 60)
        return sc, live, first, sc.render_items()

    def wander(f):
        return 0.8 * math.sin(f * 0.02), 0.8 * math.cos(f * 0.017)

    def tornado_scene():
        sc = bt.Scene(force_fields=tornado_fields(), device=dev)
        sid = sc.add_spawner(library.dust(updraft=2.5, drag=2.0, emit_radius=1.2), capacity=8192)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in range(300):
            x, z = wander(f)
            sc.set_force_field(0, position=(x, 0.0, z))
            sc.set_force_field(1, position=(x, 0.0, z))
            sc.step(1 / 60)
        torch.cuda.synchronize()
        return sc, sid, (time.perf_counter() - t0) / 300 * 1e3

    records = {}

    def events_scene(with_handler):
        handler = None
        if with_handler:
            def handler(rs):
                records[len(records)] = len(rs)
        sp = bt.ParticleSpawner(
            particle_settings=[bt.ParticleSettings(
                lifetime=bt.RandF32.constant(1.0),
                collision_settings=ParticleCollisionSettings(restitution=0.0, friction=0.0, destroy_on_collision=True),
                event_handlers=bt.ParticleEventHandlers(particles_destroyed=handler))],
            emission_settings=[bt.EmissionSettings(
                emission_pacing=bt.EmissionPacing.rate(3000.0),
                initial_velocity=bt.RandVec3(magnitude=bt.RandF32(2.0, 5.0), direction=(0, 1, 0), spread=0.7))])
        sc = bt.Scene(colliders=[bt.Collider.halfspace(position=(0.0, -1.0, 0.0))], device=dev)
        for i in range(4):
            sc.add_spawner(sp, capacity=8192, transform=bt.Transform(translation=(float(i), 0.0, 0.0)))
        return sc

    def step_ms(sc, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            sc.step(1 / 60)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    def scene_flows():
        out = {"sparks": sparks_scene(dev), "tornado": tornado_scene()}
        ev_on, ev_off = events_scene(True), events_scene(False)
        for sc in (ev_on, ev_off):
            step_ms(sc, 40)  # warm-up, 40 frames
        on, off = [], []
        for _ in range(3):  # interleaved windows of 60 frames
            on.append(step_ms(ev_on, 60))
            off.append(step_ms(ev_off, 60))
        out["events"] = (ev_on, statistics.median(on), statistics.median(off))
        return out

    flows, scene_counts = counted(scene_flows)
    # the events scene's 4 spawners are one archetype group: one fleet
    # launch per frame (and its claim), with the dump plane where the
    # handler is
    check(scene_counts["fields"] == 300 and scene_counts["dump"] == 0 and scene_counts["fleet_dump"] == 220
          and scene_counts["fleet"] == 2 * 220 and scene_counts["stats"] > 0 and scene_counts["fleet_stats"] == 440,
          f"scene flows: launches {scene_counts}")
    # sparks: 750 live, rows 64 B each, equal to a CPU Scene's (the plain versions)
    scs, live, first, second = flows["sparks"]
    cpu_sc, cpu_live, cpu_first, cpu_second = sparks_scene("cpu")
    check(live == cpu_live == 750, f"sparks scene: {live} live on the card, {cpu_live} on the CPU")
    for a, b in ((first, cpu_first), (second, cpu_second)):
        check(len(a) == len(b) == 1 and np.array_equal(a[0].instances, b[0].instances)
              and len(bt.instances_to_bytes(a[0].instances)) == a[0].count * 64, "sparks scene: rows differ from CPU")
    check(scs._spawners[0].render_planes is not None, "sparks scene: the render pack did not run")
    # tornado: the plain version replayed on the card with the same tables
    tsc, tsid, tornado_ms = flows["tornado"]
    ct = tsc._spawners[tsid].compiled
    st = bt.init_pool_for(ct, 8192, seed=tsid)
    for f in range(300):
        x, z = wander(f)
        fr = bt.make_frame_input(1 / 60, force_fields=bt.compile_force_fields(tornado_fields(x, z), device=dev))
        st, out_t = plain_frames(ct.static, ct.params, st, fr, 1)
    compare(ct, tsc._spawners[tsid].state, st, {k: 64 for k in active_f32_fields(ct.static)}, "tornado scene",
            kernel="fused_step.fields")
    check(tsc.alive_count() == int(out_t.alive_count) > 2500, "tornado scene: live count differs from plain")
    # events: the records delivered equal the plain version's destroyed count
    ev_on, on_ms, off_ms = flows["events"]
    want = 0
    plain_per_frame = [0] * 220  # the plain destroyed count of each frame (phase 21b)
    floor = bt.compile_colliders([bt.Collider.halfspace(position=(0.0, -1.0, 0.0))], device=dev)
    for sid, slot in ev_on._spawners.items():
        st = bt.init_pool_for(slot.compiled, 8192, seed=sid)
        fr = bt.make_frame_input(1 / 60, translation=(float(sid), 0.0, 0.0))
        for f in range(220):
            st, oe = plain_frames(slot.compiled.static, slot.compiled.params, st, fr, 1, colliders=floor)
            want += int(oe.destroyed_mask.sum())
            plain_per_frame[f] += int(oe.destroyed_mask.sum())
    delivered = sum(records.values())
    check(delivered == want > 1000, f"events scene: {delivered} records delivered, plain destroyed {want}")
    emit({"phase": "scene_flows", "card": card, "launches": scene_counts,
          "sparks": {"live": live, "rows": second[0].count, "rule": "state and rows == a CPU Scene's"},
          "tornado": {"frames": 300, "live": tsc.alive_count(), "ms_per_scene_step": tornado_ms,
                      "rule": "== plain replayed on the card, f32 <= 64 ulp"},
          "events": {"spawners": 4, "frames": 220, "records_delivered": delivered, "plain_destroyed": want,
                     "ms_per_scene_step_with_handler": on_ms, "ms_per_scene_step_without_handler": off_ms}})

    # ------------------------------------------------ 21a. scene_async_events
    from bevy_firework_tpu_torch import checkpoint as ckpt
    from bevy_firework_tpu_torch import trails as tr
    from bevy_firework_tpu_torch.pool import POOL_FIELDS

    def events_spawner(handler):
        """Phase 21's events spawner with the given particles_destroyed
        handler (None: dump-free)."""
        return bt.ParticleSpawner(
            particle_settings=[bt.ParticleSettings(
                lifetime=bt.RandF32.constant(1.0),
                collision_settings=ParticleCollisionSettings(restitution=0.0, friction=0.0, destroy_on_collision=True),
                event_handlers=bt.ParticleEventHandlers(particles_destroyed=handler))],
            emission_settings=[bt.EmissionSettings(
                emission_pacing=bt.EmissionPacing.rate(3000.0),
                initial_velocity=bt.RandVec3(magnitude=bt.RandF32(2.0, 5.0), direction=(0, 1, 0), spread=0.7))])

    def events_scene_with(handler, async_events=False):
        sc = bt.Scene(colliders=[bt.Collider.halfspace(position=(0.0, -1.0, 0.0))], device=dev)
        for i in range(4):
            sc.add_spawner(events_spawner(handler), capacity=8192, transform=bt.Transform(translation=(float(i), 0.0, 0.0)))
        if async_events:
            sc.enable_async_events()
        return sc

    def timed_calls(sc, name):
        """Wrap sc.<name> to add its host seconds to the returned cell."""
        cell = [0.0, 0]
        orig = getattr(sc, name)

        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                cell[0] += time.perf_counter() - t0
                cell[1] += 1

        setattr(sc, name, wrapped)
        return cell

    def async_events_run():
        """220 async Scene.steps of the events scene (the plain counts of
        phase 21 are its reference), then 20 steady steps whose payload
        enqueue runs under sync debug mode "error"."""
        got = []
        sc = events_scene_with(lambda rs: got.append(len(rs)), async_events=True)
        delivered = []
        for _ in range(220):
            sc.step(1 / 60)
            delivered.append(sum(got))
        sc.flush_events()
        total = sum(got)
        orig = sc._enqueue_events
        guarded = [0]

        def enqueue_checked(*a, **k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return orig(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                guarded[0] += 1

        sc._enqueue_events = enqueue_checked
        for _ in range(20):
            sc.step(1 / 60)
        del sc._enqueue_events
        sc.flush_events()
        return delivered, total, guarded[0]

    (ev_delivered, ev_total, ev_guarded), async_ev_counts = counted(async_events_run)
    check(async_ev_counts["fleet"] == async_ev_counts["fleet_dump"] == 240,
          f"async events: launches {async_ev_counts}")
    plain_cum = np.cumsum([0] + plain_per_frame).tolist()
    check(ev_total == want and ev_delivered == plain_cum[:220],
          f"async events: delivered {ev_total} (plain {want}); one frame late: "
          f"{[(i, d, w) for i, (d, w) in enumerate(zip(ev_delivered, plain_cum)) if d != w][:5]}")
    check(ev_guarded == 20, f"async events: {ev_guarded} payload enqueues ran under sync debug mode")
    # dump-free, sync and async Scene.step, interleaved windows; the async
    # scene's record building (_deliver_destroyed) and whole delivery
    # (flush_events: the wait on the copy's event, the host reads and the
    # record building) timed apart
    ev_free, ev_sync = events_scene_with(None), events_scene_with(lambda rs: None)
    ev_async = events_scene_with(lambda rs: None, async_events=True)
    build_sync = timed_calls(ev_sync, "_deliver_destroyed")
    build_async, flush_async = timed_calls(ev_async, "_deliver_destroyed"), timed_calls(ev_async, "flush_events")
    for sc in (ev_free, ev_sync, ev_async):
        step_ms(sc, 40)
    for cell in (build_sync, build_async, flush_async):
        cell[0] = cell[1] = 0
    win = {"free": [], "sync": [], "async": []}
    for _ in range(3):
        for name, sc in (("free", ev_free), ("sync", ev_sync), ("async", ev_async)):
            win[name].append(step_ms(sc, 60))
    ev_ms = {k: statistics.median(v) for k, v in win.items()}
    emit({"phase": "scene_async_events", "card": card, "launches": async_ev_counts,
          "frames": 220, "records_delivered": ev_total, "plain_destroyed": want,
          "rule": "after step i the records of frames < i delivered (== the plain cumulative count), each once; "
                  "flush_events drains the last frame",
          "sync_debug_error_enqueues": ev_guarded,
          "ms_per_scene_step": ev_ms, "async_over_free": ev_ms["async"] / ev_ms["free"], "async_over_free_bar": 1.5,
          "sync_over_free": ev_ms["sync"] / ev_ms["free"],
          "record_build_ms_per_step": {"sync": build_sync[0] * 1e3 / 180, "async": build_async[0] * 1e3 / 180},
          "async_flush_ms_per_step": flush_async[0] * 1e3 / 180,
          "timing": "ms per Scene.step by host clock with a synchronize at each 60-step window's ends, median of 3 "
                    "interleaved windows; record_build: host time in _deliver_destroyed per step; async_flush: host "
                    "time in flush_events per step (the wait on the copy's event, the reads and the record build)"})

    # ------------------------------------------------ 21b. trails_flow
    comets = library.comets()
    ts16 = bt.TrailSettings(length=16, width=0.8)

    def comet_scene(device):
        sc = bt.Scene(device=device)
        sc.add_spawner(comets, capacity=256, trail=ts16)
        for _ in range(300):
            sc.step(1 / 60)
        return sc, sc.trail_items()

    def trails_flow():
        card_sc, card_items = comet_scene(dev)
        g = bt.Scene(device=dev)
        for i in range(4):
            g.add_spawner(comets, capacity=256, trail=ts16, transform=bt.Transform(translation=(2.0 * i, 0.0, 0.0)))
        own = {sid: tr.init_trail_state(ts16, 256, dev) for sid in g.spawner_ids()}
        for _ in range(300):
            g.step(1 / 60)
            for sid in g.spawner_ids():  # the per-member path on the same pools
                own[sid] = tr.update_trails(own[sid], g._spawners[sid].state, np.float32(1 / 60))
        return card_sc, card_items, g, own

    (comet_card, comet_items, comet_group, comet_own), trails_counts = counted(trails_flow)
    check(trails_counts["fused_step"] >= 300 and trails_counts["fleet"] == 300, f"trails flow: launches {trails_counts}")
    comet_cpu, comet_cpu_items = comet_scene("cpu")
    check(len(comet_items) == len(comet_cpu_items) == 1 and comet_items[0].count == comet_cpu_items[0].count > 100,
          f"trails flow: segments {[i.count for i in comet_items]} on the card, "
          f"{[i.count for i in comet_cpu_items]} on the CPU")
    comet_err = float(np.abs(comet_items[0].segments - comet_cpu_items[0].segments).max())
    check(np.allclose(comet_items[0].segments, comet_cpu_items[0].segments, rtol=1e-5, atol=1e-5),
          f"trails flow: rows differ from the CPU Scene's by {comet_err}")
    check(next(iter(comet_group._batches.values())).trails is not None, "trails flow: the group's trails not stacked")
    for sid in comet_group.spawner_ids():
        for k in tr.TRAIL_FIELDS:
            check(torch.equal(getattr(comet_group._spawners[sid].trail_state, k), getattr(comet_own[sid], k)),
                  f"trails flow: stacked trails of member {sid} differ from its own update in {k}")
    emit({"phase": "trails_flow", "card": card, "launches": trails_counts,
          "comets": {"frames": 300, "segments": comet_items[0].count, "max_abs_err_vs_cpu": comet_err,
                     "bit_equal_to_cpu": bool(np.array_equal(comet_items[0].segments, comet_cpu_items[0].segments)),
                     "rule": "segment count == the CPU Scene's, rows within 1e-5 (CUDA's and the CPU's libm part "
                             "by a few ulp in the circle and cone draws)"},
          "group_of_4": {"frames": 300, "segments": sum(i.count for i in comet_group.trail_items()),
                         "rule": "stacked trails == each member's own update_trails on its pool, bit for bit"}})

    # ---------------------------------- 21c. trails_100k (and 21d's first scene)
    n_t = 1 << 17
    stress_1e5 = dataclasses.replace(stress_sp, emission_settings=(dataclasses.replace(
        stress_sp.emission_settings[0], emission_pacing=EmissionPacing.rate(1e5)),))
    ck_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_", dir=Path(__file__).resolve().parent)
    ck_dir = Path(ck_tmp.name)  # removed after 21d
    ck_report = {}

    def save_load(sc, name):
        """save_scene then load_scene on the card, timed: the loaded Scene."""
        path = ck_dir / f"{name}.zip"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_scene(str(path), sc)
        t1 = time.perf_counter()
        loaded = ckpt.load_scene(str(path), device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ck_report[name] = {"save_ms": (t1 - t0) * 1e3, "load_ms": (t2 - t1) * 1e3, "bytes": path.stat().st_size}
        return loaded, path

    def same_scenes(a, b, label):
        """Two card Scenes equal bit for bit: pools, trails, render rows."""
        for sid in a.spawner_ids():
            sa, sb = a._spawners[sid].state, b._spawners[sid].state
            for k in POOL_FIELDS:
                check(torch.equal(getattr(sa, k), getattr(sb, k)), f"{label}: spawner {sid} {k} differs")
            ta, tb = a._spawners[sid].trail_state, b._spawners[sid].trail_state
            for k in (tr.TRAIL_FIELDS if ta is not None else ()):
                check(torch.equal(getattr(ta, k), getattr(tb, k)), f"{label}: spawner {sid} trail {k} differs")
        ra, rb = a.render_items(), b.render_items()
        check(len(ra) == len(rb) and all(np.array_equal(x.instances, y.instances) for x, y in zip(ra, rb)),
              f"{label}: render rows differ")

    def trails_100k():
        with_t, no_t = bt.Scene(device=dev), bt.Scene(device=dev)
        with_t.add_spawner(stress_1e5, capacity=n_t, trail=ts16)
        no_t.add_spawner(stress_1e5, capacity=n_t)
        resumed = None
        for f in range(140):
            for sc in (with_t, no_t) if resumed is None else (with_t, no_t, resumed):
                sc.step(1 / 60)
            if f == 69:
                resumed, path = save_load(with_t, "trails_100k")
        return with_t, no_t, resumed, path

    (t_with, t_without, t_resumed, t_path), t100k_counts = counted(trails_100k)
    check(t100k_counts["fused_step"] == 140 * 2 + 70, f"trails_100k: launches {t100k_counts}")
    items_t = t_with.trail_items()
    # the plain replay of the same frames and trail on the card (phase 6's rule)
    c_t = t_with._spawners[0].compiled
    st_p, tr_p = bt.init_pool_for(c_t, n_t, seed=0), tr.init_trail_state(ts16, n_t, dev)
    fr_t = bt.make_frame_input(1 / 60)
    for _ in range(140):
        st_p, _o = plain_frames(c_t.static, c_t.params, st_p, fr_t, 1)
        tr_p = tr.update_trails(tr_p, st_p, np.float32(1 / 60))
    rows_p = tr.compact_segments(tr.pack_trail_segments(ts16, c_t.params, st_p, tr_p, 0)[0])
    check(len(items_t) == 1 and items_t[0].count == rows_p.shape[0] > 100000,
          f"trails_100k: {[i.count for i in items_t]} segments, plain {rows_p.shape[0]}")
    t_ulp = ulp_diff(torch.from_numpy(items_t[0].segments).to(dev), rows_p)
    check(t_ulp <= 4, f"trails_100k: rows differ from the plain replay's by {t_ulp} ulp")
    check(torch.equal(t_with._spawners[0].trail_state.hcount, tr_p.hcount), "trails_100k: hcount differs from plain")
    same_scenes(t_with, t_resumed, "checkpoint trails_100k")  # its render_items turn the render pack on
    del t_resumed
    t_without.render_items()  # the same render pack in the scene without the trail
    win = {"with_trail": [], "without_trail": []}
    for _ in range(3):
        win["with_trail"].append(step_ms(t_with, 20))
        win["without_trail"].append(step_ms(t_without, 20))
    t_ms = {k: statistics.median(v) for k, v in win.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        items_t = t_with.trail_items()
    items_ms = (time.perf_counter() - t0) / 5 * 1e3
    seg_count = items_t[0].count
    st_now, tr_now = t_with._spawners[0].state, t_with._spawners[0].trail_state
    tr_clone = tr.TrailState(**{k: getattr(tr_now, k).clone() for k in tr.TRAIL_FIELDS})
    upd_bound = bound(47 * n_t, 0)  # reads px py pz age alive prev_*, hcount; writes 3 rows, hcount, prev_*
    upd_ms = device_ms("update_trails", lambda: tr.update_trails(tr_clone, st_now, np.float32(1 / 60)), 20, False,
                       upd_bound["bound_ms"])
    pack_bound = bound(12 * 16 * n_t + 21 * n_t + 64 * seg_count, 0)  # history, hcount, 5 state planes; the rows
    pack_ms = device_ms("trail pack + compaction", lambda: tr.compact_segments(
        tr.pack_trail_segments(ts16, c_t.params, st_now, tr_now, 0)[0]), 10, False, pack_bound["bound_ms"])
    emit({"phase": "trails_100k", "card": card, "launches": t100k_counts, "capacity": n_t, "rate": 1e5,
          "trail": dataclasses.asdict(ts16), "warm_frames": 140,
          "ms_per_scene_step": t_ms, "trail_items_ms": items_ms, "segments": seg_count,
          "bytes_copied_per_trail_items": seg_count * 64, "dense_plane_bytes": 16 * 15 * n_t * 4,
          "update_trails_device_us": upd_ms * 1e3, "update_trails_bound_us": upd_bound["bound_ms"] * 1e3,
          "pack_compact_device_us": pack_ms * 1e3, "pack_compact_bound_us": pack_bound["bound_ms"] * 1e3,
          "rows_max_ulp_vs_plain": t_ulp,
          "rule": "the last frame's rows == the plain replay's (plain_frames + update_trails on the card) within 4 "
                  "ulp, same count; hcount exact",
          "timing": "ms_per_scene_step: host clock over 20-step windows, median of 3 interleaved; trail_items_ms: "
                    "host clock per call; *_device_us: torch.profiler, every kernel and copy of the call"})

    # ------------------------------------------------ 21d. checkpoint_flow
    def ck_events():
        got_a, got_b = [], []
        a = events_scene_with(lambda rs: got_a.append([dataclasses.astuple(r) for r in rs]))
        b = None
        for f in range(140):
            for sc in (a,) if b is None else (a, b):
                sc.step(1 / 60)
            if f == 69:
                b, _p = save_load(a, "events")
                sp_b = events_spawner(lambda rs: got_b.append([dataclasses.astuple(r) for r in rs]))
                for slot in b._spawners.values():  # handlers are code: registered again after loading
                    slot.spawner, slot.compiled = sp_b, b._compile(sp_b, slot.compiled.static.nested_m)
                got_a.clear()
        return a, b, got_a, got_b

    def ck_tornado():
        def run(sc, frames, start):
            for f in range(start, start + frames):
                x, z = wander(f)
                sc.set_force_field(0, position=(x, 0.0, z))
                sc.set_force_field(1, position=(x, 0.0, z))
                if f in (40, 100):
                    sc.set_collider(0, position=(0.0, -1.0 - f / 200, 0.0))
                sc.step(1 / 60)

        a = bt.Scene(force_fields=tornado_fields(), colliders=[bt.Collider.halfspace(position=(0.0, -1.0, 0.0))],
                     device=dev)
        a.add_spawner(library.dust(updraft=2.5, drag=2.0, emit_radius=1.2), capacity=8192)
        run(a, 70, 0)
        b, _p = save_load(a, "tornado")
        run(a, 70, 70)
        run(b, 70, 70)
        return a, b

    ((ev_a, ev_b, recs_a, recs_b), (tor_a, tor_b)), ck_counts = counted(lambda: (ck_events(), ck_tornado()))
    check(ck_counts["fleet_dump"] == 210 and ck_counts["fields"] == 210, f"checkpoint flow: launches {ck_counts}")
    same_scenes(ev_a, ev_b, "checkpoint events")
    check(recs_a == recs_b and sum(map(len, recs_a)) > 1000,
          f"checkpoint events: {sum(map(len, recs_a))} records uninterrupted, {sum(map(len, recs_b))} resumed")
    same_scenes(tor_a, tor_b, "checkpoint tornado")
    check(tor_b._collider_slots == tor_a._collider_slots and tor_b._field_slots == tor_a._field_slots,
          "checkpoint tornado: collider or field slots differ")
    # across devices: the card's zip on the CPU, a CPU zip on the card
    on_card = ckpt.load_scene(str(ck_dir / "events.zip"), device=dev)
    on_cpu = ckpt.load_scene(str(ck_dir / "events.zip"), device="cpu")
    cpu_path = ck_dir / "comets_cpu.zip"
    ckpt.save_scene(str(cpu_path), comet_cpu)
    from_cpu = ckpt.load_scene(str(cpu_path), device=dev)
    for x, y, label in ((on_card, on_cpu, "card zip on the CPU"), (comet_cpu, from_cpu, "CPU zip on the card")):
        for sid in x.spawner_ids():
            for k, v in bt.interop.pool_to_numpy(x._spawners[sid].state).items():
                check(np.array_equal(v, bt.interop.pool_to_numpy(y._spawners[sid].state)[k]), f"{label}: {sid} {k}")
            tx, ty = x._spawners[sid].trail_state, y._spawners[sid].trail_state
            for k in (tr.TRAIL_FIELDS if tx is not None else ()):
                check(torch.equal(getattr(tx, k).cpu(), getattr(ty, k).cpu()), f"{label}: {sid} trail {k}")
    check(from_cpu._spawners[0].trail_state is not None and from_cpu.trail_items()[0].count == comet_cpu_items[0].count,
          "CPU zip on the card: trail items differ")
    emit({"phase": "checkpoint_flow", "card": card, "launches": ck_counts, "files": ck_report,
          "scenes": {"trails_100k": "phase 21c's scene, saved at frame 70, resumed 70 frames",
                     "events": "4 destroy spawners, a floor, a handler: saved at frame 70, resumed 70 frames",
                     "tornado": "dust under the tornado's fields with a floor edited at frames 40 and 100, saved "
                                "at frame 70, resumed 70 frames"},
          "records_resumed": sum(map(len, recs_b)),
          "rule": "the resumed run == the uninterrupted run bit for bit (pools, trails, destroyed records, render "
                  "rows); the card's zip loaded on the CPU and a CPU zip loaded on the card == their source "
                  "leaf for leaf",
          "timing": "save_ms, load_ms: host clock of save_scene / load_scene (load to the card); bytes: the zip"})
    ck_tmp.cleanup()

    # ------------------------------------------------ 22. nested_det
    from bevy_firework_tpu_torch.step import hybrid_frame, nested_cadence, nested_fold_carry, nested_fold_counts
    from bevy_firework_tpu_torch.step import nested_child_rows as plain_child_rows, nested_parents
    from bevy_firework_tpu_torch.step import nested_stage as plain_stage

    import torch_nested_configs as nested_cfg

    det_nested = nested_cfg.det_nested
    n_det = 131072
    cn = bt.compile_spawner(det_nested(), nested_buffer=1024, device=dev)
    burst = bt.compile_spawner(bt.ParticleSpawner(
        particle_settings=[bt.ParticleSettings(), bt.ParticleSettings()],
        emission_settings=[bt.EmissionSettings(), bt.EmissionSettings(
            particle_index=1, emission_mode=bt.EmissionMode.nested(0),
            emission_pacing=bt.EmissionPacing.count_over_duration(10.0, 1.0, 0.0, 0.001))]), device=dev)
    rng = np.random.default_rng(19)
    life_np = rng.uniform(0.5, 2.0, n_det).astype(np.float32)
    age_np = (rng.uniform(0.0, 1.0, n_det) * life_np).astype(np.float32)
    le_np = np.where(rng.uniform(size=n_det) < 0.5, np.finfo(np.float32).min,
                     age_np * rng.uniform(0.0, 1.0, n_det)).astype(np.float32)
    cin = {"alive": torch.from_numpy(rng.uniform(size=n_det) < 0.5).to(dev),
           "ptype": torch.from_numpy(rng.integers(0, 2, n_det).astype(np.int32)).to(dev),
           "age": torch.from_numpy(age_np).to(dev), "life": torch.from_numpy(life_np).to(dev),
           "le": torch.from_numpy(le_np).to(dev)}
    planes_det = {k: torch.from_numpy(rng.normal(size=n_det).astype(np.float32)).to(dev)
                  for k in ("px", "py", "pz", "vx", "vy", "vz")}
    gate = torch.ones((), dtype=torch.bool, device=dev)
    cad_res = {}
    for name, cc, M in (("rate_window", cn, 1024), ("burst", burst, 4096)):
        for fetch in (False, True):
            pf = planes_det if fetch else None
            args = (cc.static, cc.params, 1, cin["alive"], cin["ptype"], cin["age"], cin["life"], cin["le"], gate, M)
            k_le, k_cum, k_total, k_pv = fs.nested_cadence_pass(*args, parent_fields=pf)
            p_le, p_cum, p_total, p_pv = nested_cadence(*args, parent_fields=pf)
            check(torch.equal(k_le, p_le) and int(k_total) == int(p_total), f"nested_det cadence {name}: new_le/total")
            if fetch:
                for k in pf:
                    check(torch.equal(k_pv[k], p_pv[k]), f"nested_det cadence {name}: parent {k}")
            else:
                check(torch.equal(k_cum, p_cum), f"nested_det cadence {name}: cum")
            max_err["nested_stage"] = max(max_err["nested_stage"], float((k_le - p_le).abs().max()))
            cad_res[f"{name}_{'fetch' if fetch else 'cum'}"] = {"total": int(k_total), "m": M}
    check(cad_res["burst_cum"]["total"] > 4096, f"nested_det: burst total {cad_res['burst_cum']}")
    # child rows: both parent modes, rates of the rate-window pass
    _le, cum_det, _t, _pv = nested_cadence(cn.static, cn.params, 1, cin["alive"], cin["ptype"], cin["age"],
                                           cin["life"], cin["le"], gate, 1024)
    fkey = np.array([19, 2026], np.uint32)
    fr_det = bt.make_frame_input(1 / 60, modifier_scale=1.2, modifier_speed=0.9)
    pv_det = {k: v[nested_parents(cum_det, 1024)] for k, v in planes_det.items()}
    rows_plain = plain_child_rows(cn.static, cn.params, fr_det, 1, pv_det, fkey, 1024)
    for kw in ({"cum": cum_det, "parent_planes": planes_det}, {"parent_vals": pv_det}):
        rows_k = fs.nested_child_rows(cn.static, cn.params, fr_det, 1, fkey, 1024, **kw)
        check(torch.equal(rows_k, rows_plain), f"nested_det child rows ({list(kw)[0]}) differ by "
              f"{ulp_diff(rows_k, rows_plain)} ulp")
        max_err["nested_stage"] = max(max_err["nested_stage"], float((rows_k - rows_plain).abs().max()))
    # the nested stage in one launch (kernel rows 8 and 9b) against
    # step.nested_stage, unfolded and on the carried tile counts of a folded
    # frame: a rate window on the ring (anchors just below the age but for
    # 0.2%: the total below M, the ranks above it the zero parent's), the
    # same inputs on a dead-rank archetype (the ranks above the total take
    # lane n - 1), a burst (one tile owns every rank below M) and the rate
    # window at 1310720 lanes (5120 tiles)
    def stage_inputs(n, seed, unset):
        rng = np.random.default_rng(seed)
        life = rng.uniform(0.5, 2.0, n).astype(np.float32)
        age = (rng.uniform(0.0, 1.0, n) * life).astype(np.float32)
        le = np.where(rng.uniform(size=n) < unset, np.finfo(np.float32).min, age * np.float32(0.97))
        t = {"alive": rng.uniform(size=n) < 0.5, "ptype": rng.integers(0, 2, n).astype(np.int32), "age": age,
             "life": life, "le": le.astype(np.float32)}
        t.update({k: rng.normal(size=n).astype(np.float32) for k in ("px", "py", "pz", "vx", "vy", "vz")})
        return {k: torch.from_numpy(v).to(dev) for k, v in t.items()}

    def stage_check(name, cc, t, M):
        n = t["age"].shape[0]
        start = torch.tensor(n // 3 if cc.static.ring_claim else 0, dtype=torch.int32, device=dev)
        par = {k: t[k] for k in fs.nested_parent_fields(cc.static)}
        args = (cc.static, cc.params, fr_det, 1, t["alive"], t["ptype"], t["age"], t["life"], t["le"], gate, M, par,
                np.array([23, 2026], np.uint32), start)
        p_le, p_rec, p_rows = plain_stage(*args)
        carried = nested_cfg.lane_tile_counts(cc.static, cc.params, 1, t["alive"], t["ptype"], t["age"], t["life"],
                                              t["le"], gate)
        for label, counts in (("unfolded", None), ("folded", carried)):
            k_le, k_rec, k_rows = fs.nested_stage(*args, counts=counts)
            check(torch.equal(k_rec, p_rec), f"nested_det stage {name} {label}: record {k_rec.tolist()} != "
                  f"{p_rec.tolist()}")
            check(torch.equal(k_le, p_le), f"nested_det stage {name} {label}: anchors")
            check(torch.equal(k_rows, p_rows), f"nested_det stage {name} {label}: child rows differ by "
                  f"{ulp_diff(k_rows, p_rows)} ulp")
            max_err["nested_stage"] = max(max_err["nested_stage"], float((k_rows - p_rows).abs().max()))
        cum = nested_cadence(cc.static, cc.params, 1, t["alive"], t["ptype"], t["age"], t["life"], t["le"], gate, M)[1]
        return {"n": n, "total": int(p_rec[L.NS_TOTAL]), "max_tile_ranks": nested_cfg.tile_ranks(cum, M),
                "dropped": int(p_rec[L.NS_DROPPED])}

    small = stage_inputs(n_det, 21, 0.002)
    stage_res = {"ring": stage_check("ring", cn, small, 1024),
                 "dead_rank": stage_check("dead_rank", bt.compile_spawner(det_nested(destroy=True), device=dev),
                                          small, 1024),
                 "burst": stage_check("burst", burst, stage_inputs(n_det, 22, 0.5), 1024),
                 "ring_1310720": stage_check("ring_1310720", cn, stage_inputs(1310720, 23, 0.002), 1024)}
    check(0 < stage_res["ring"]["total"] < 1024 and stage_res["burst"]["total"] > 1024
          and stage_res["burst"]["max_tile_ranks"] >= 256, f"nested_det stage: {stage_res}")
    # hybrid frames: ring (single and chained) and dead-rank (on its floor,
    # and without one), 30 frames each, stats on every other frame; which
    # merge instantiation each launch took (fused_step_kernel_merge's
    # <ring, stats> pairs, or fused_step_kernel's)
    floor_det = bt.compile_colliders(nested_cfg.DET_FLOOR, device=dev)
    hyb_res = {}
    merge_forms = set()
    for name, destroy, chained, floor in (("ring", False, False, False), ("chained", False, True, False),
                                          ("dead_rank", True, False, True), ("dead_rank_free", True, False, False)):
        ch = bt.compile_spawner(det_nested(destroy, chained), nested_buffer=1024, device=dev)
        check(ch.static.ring_claim == (not destroy), f"nested_det {name}: claim kind")
        tab = floor_det if floor else None
        s = bt.init_pool_for(ch, n_det)
        deferred = dropped = 0
        lean0, wide0 = fs.fused_step.merge_lean_launches, fs.fused_step.merge_wide_launches
        for i in range(30):
            st = i % 2 == 1  # the last frame has stats
            sk, ok = fs.fused_step(ch.static, ch.params, tab, s, fdet, stats=st)
            sp_, op = plain_frames(ch.static, ch.params, s, fdet, 1, stats=st, colliders=tab)
            compare(ch, sk, sp_, {}, f"nested_det {name} frame {i}", kernel="fused_step.nested_merge")
            for k in ("last_emitted", "ptype", "finished_notified"):
                check(torch.equal(getattr(sk, k), getattr(sp_, k)), f"nested_det {name} frame {i}: {k}")
            if st:
                for k in ("alive_count_per_type", "nested_deferred", "nested_dropped", "finished_event", "aabb_valid",
                          "aabb_min", "aabb_max"):
                    check(torch.equal(getattr(ok, k), getattr(op, k)), f"nested_det {name} frame {i}: {k}")
                deferred += int(ok.nested_deferred)
                dropped += int(ok.nested_dropped)
            merge_forms.add(("lean" if fs.merge_lean(ch.static, tab, fdet) else "wide", ch.static.ring_claim, st))
            s = sk
        lean, wide = fs.fused_step.merge_lean_launches - lean0, fs.fused_step.merge_wide_launches - wide0
        check((lean, wide) == ((0, 30) if floor else (30, 0)), f"nested_det {name}: merge launches {lean}, {wide}")
        hyb_res[name] = {"per_type": ok.alive_count_per_type.tolist(), "deferred": deferred, "dropped": dropped,
                         "merge_lean_launches": lean, "merge_wide_launches": wide}
        check(int(ok.alive_count_per_type[1]) > 5000, f"nested_det {name}: {hyb_res[name]}")
    check(hyb_res["ring"]["deferred"] > 0, "nested_det: no deferral")
    check({("lean", r, st) for r in (True, False) for st in (True, False)} <= merge_forms,
          f"nested_det: fused_step_kernel_merge's instantiations launched {sorted(merge_forms)}")
    torch.cuda.synchronize()
    emit({"phase": "nested_det", "card": card, "n": n_det, "stage": stage_res, "cadence": cad_res, "hybrid": hyb_res,
          "merge_instantiations": sorted(merge_forms),
          "rule": "the nested stage (unfolded and on carried tile counts: anchors, NS record, child buffer), its "
                  "pass alone (cum and fetch mode) and its child rows alone, and 30 hybrid frames == plain, bit for "
                  "bit (the alive plane and the finished latch included); every fused_step_kernel_merge "
                  "instantiation (ring, dead-rank, stats on and off) and fused_step_kernel's dead-rank merge "
                  "launched"})

    # ------------------------------------------------ 22a. nested_fold_det
    fold_det = {}
    for name, chained in (("ring", False), ("chained", True)):
        ch = bt.compile_spawner(det_nested(False, chained), nested_buffer=1024, device=dev)
        check(fs.can_fold_nested(ch.static, n_det), f"nested_fold_det {name}: the fold does not apply")
        s = bt.init_pool_for(ch, n_det)
        totals = []
        for i in range(10):  # 30 frames: every third one a folded frame whose carry is checked
            s, _o = fs.multi_step_auto(ch.static, ch.params, None, s, fdet, 2)
            s, r = nested_cfg.check_fold_epilogue(ch, s, fdet, label=f"nested_fold_det {name} frame {3 * i + 2}")
            totals.append(r["fold_totals"])
        check(min(t[0] for t in totals[3:]) > 1024 and totals[-1][-1] > 0, f"nested_fold_det {name}: {totals}")
        s0 = bt.init_pool_for(ch, n_det)
        sf, of = nested_cfg.check_folded_equals_unfolded(ch, s0, fdet, 30, label=f"nested_fold_det {name} chain")
        sp_, op = plain_frames(ch.static, ch.params, s0, fdet, 30)
        compare(ch, sf, sp_, {}, f"nested_fold_det {name} chain vs plain", kernel="fused_step.nested_fold")
        for k in ("last_emitted", "ptype"):
            check(torch.equal(getattr(sf, k), getattr(sp_, k)), f"nested_fold_det {name} chain vs plain: {k}")
        for k in ("alive_count_per_type", "nested_deferred", "nested_dropped"):
            check(torch.equal(getattr(of, k), getattr(op, k)), f"nested_fold_det {name} chain vs plain: {k}")
        toggles = nested_cfg.check_enabled_toggles(ch, sf, fdet, 10)
        fold_det[name] = {"fold_totals": totals, "per_type": of.alive_count_per_type.tolist(),
                          "deferred_last_frame": int(of.nested_deferred), "toggle_chains_per_type": toggles}
    torch.cuda.synchronize()
    emit({"phase": "nested_fold_det", "card": card, "n": n_det, "cases": fold_det,
          "rule": "the seed's count kernels and the fold epilogue (per-tile counts, next NS_ANY) == "
                  "step.nested_fold_counts on the state each read, bit for bit, every third frame of 30; a 30-frame "
                  "folded chain == the unfolded chain (every field, every output) == 30 plain frames; four chains "
                  "with the emitters' enabled bits toggled between them, folded == unfolded"})

    # ------------------------------------- 23./24. nested_60k, nested_chained
    bench_nested = nested_cfg.bench_nested

    def nested_path(label, chained, warm=150, n_frames=100):
        """bench.py's nested cell: a `warm`-frame multi_step_auto chain from an
        empty pool (folded: launches counted; no frame may synchronise)
        against the unfolded chain (bit for bit) and as many plain frames,
        differential ms/frame, device time per frame of a 10-frame folded
        and unfolded chain, and device times of the nested-stage launch of
        an unfolded and of a folded frame, the seed's count kernel and the
        step launch without and with the fold epilogue."""
        cm = bt.compile_spawner(bench_nested(chained), nested_buffer=1024, device=dev)
        capacity = 16 * 8192
        frame = bt.make_frame_input(1 / 60)
        state0 = bt.init_pool_for(cm, capacity, seed=0)
        n_em = len(cm.static.mode_kinds) - 1
        check(fs.can_fold_nested(cm.static, capacity), f"{label}: the fold does not apply")
        fs.kernel_tables(cm.static, cm.params)  # set-up: the table's one host-to-device copy

        def chain():
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fs.multi_step_auto(cm.static, cm.params, None, state0, frame, warm)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        (state, out), counts = counted(chain)
        torch.cuda.synchronize()
        # the folded chain: a seed of one count kernel per nested emitter,
        # one nested-stage launch per emitter and frame, the fold epilogue
        # in every step launch but the last, nothing else
        check(counts["fused_step"] == counts["merge"] == counts["merge_lean"] == warm and counts["merge_wide"] == 0
              and counts["fold"] == warm - 1
              and counts["nested_seed"] == n_em and counts["nested_stage"] == n_em * warm
              and counts["nested_pass"] == 0 and counts["nested_child_rows"] == 0
              and counts["dead_rank_claim"] == 0 and counts["stats"] == 1, f"{label}: the chain's launches {counts}")
        unf, unf_out = fs.chain_hybrid_unfolded(cm.static, cm.params, None, state0, frame, warm)
        nested_cfg.assert_chains_equal(state, out, unf, unf_out, f"{label} folded vs unfolded")
        ref, ref_out = plain_frames(cm.static, cm.params, state0, frame, warm)
        for k in ("alive_count", "alive_count_per_type", "nested_deferred", "nested_dropped"):
            check(torch.equal(getattr(out, k), getattr(ref_out, k)), f"{label}: {k} differs from plain")
        for k in ("ring_cursor", "time_in_cycle", "last_emission", "alive", "ptype", "rng_key"):
            check(torch.equal(getattr(ref, k).cpu(), getattr(state, k).cpu()), f"{label}: {k} differs from plain")
        worst = {}
        for k in active_f32_fields(cm.static) + ("last_emitted",):
            a, b = getattr(ref, k), getattr(state, k)
            worst[k] = ulp_diff(a, b)
            max_err["fused_step.nested_merge"] = max(max_err["fused_step.nested_merge"], float((a - b).abs().max()))
            check(worst[k] <= 4, f"{label}: {k} {worst[k]} ulp from plain")
            check(bool(torch.isfinite(b).all()), f"{label}: non-finite {k}")
        alive = int(out.alive_count)

        def run(n):
            torch.cuda.set_sync_debug_mode("error")
            try:
                st, _o = fs.multi_step_auto(cm.static, cm.params, None, state, frame, n)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            return st

        def differential(fn, n, reps):
            diffs = []
            for _ in range(reps):
                t_n = event_ms(lambda: fn(n), 1)
                t_2n = event_ms(lambda: fn(2 * n), 1)
                diffs.append((t_2n - t_n) / n)
            return statistics.median(diffs)

        ms = differential(run, n_frames, 5)
        plain_ms = differential(lambda n: plain_frames(cm.static, cm.params, state, frame, n, stats=False), 5, 3)

        # device time per frame of each kernel group: an unfolded hybrid
        # frame per call, or a folded frame from a copy of one carry
        def frame_call():
            return fs.fused_step(cm.static, cm.params, None, state, frame, stats=False)

        carry = fs._seed_nested_carry(cm.static, cm.params, state)

        def fold_call():
            return fs.fused_step_hybrid(cm.static, cm.params, None, state, frame, stats=False, fold_out=True,
                                        nested_carry=fs.FoldCarry(carry.counts.clone(), carry.ns.clone()))

        plain_carry = nested_fold_carry(cm.static, cm.params, state)

        def plain_fold_call():
            return hybrid_frame(cm.static, cm.params, state, frame, False, None, plain_carry, True)

        n_active = len(active_f32_fields(cm.static))
        M = 1024
        n_par = len(fs.nested_parent_fields(cm.static))
        n_rows = len(fs.nested_child_field_rows(cm.static))
        n_tiles = -(-capacity // L.TILE)
        # the stage reads alive, ptype, age and the anchor and writes the
        # anchor (lifetime constant), reads M ranks' parents and writes their
        # rows; ~20 ops of cadence per lane, ~60 of init and 12 threefry
        # draws of ~100 integer ops per rank
        stage_bound = bound(capacity * (1 + 4 + 4 + 4 + 4) + (n_par + n_rows) * 4 * M,
                            20 * capacity + M * (60 + 12 * 100))
        seed_bound = bound(capacity * (1 + 4 + 4 + 4) + 4 * n_tiles, 20 * capacity)
        children = int(out.alive_count_per_type[1:].sum())
        # the fields and ptype in and out, the alive plane out, the child rows
        step_bytes = 2 * 4 * n_active * capacity + 8 * capacity + capacity + n_em * n_rows * 4 * M
        step_bound = bound(step_bytes, INTEGRATE_OPS * alive)
        # the epilogue adds per nested emitter one read of the anchor row and
        # the tile counts written, and a cadence count (~20 ops) per live lane
        fold_bound = bound(step_bytes + n_em * (4 * capacity + 4 * n_tiles), INTEGRATE_OPS * alive + n_em * 20 * alive)
        stage_ms = device_ms(f"{label} nested stage", frame_call, 10, True, stage_bound["bound_ms"],
                             ("nested_stage_kernel",))
        folded_stage_ms = device_ms(f"{label} folded nested stage", fold_call, 10, True, stage_bound["bound_ms"],
                                    ("nested_stage_kernel",))
        seed_ms = device_ms(f"{label} seed count", lambda: fs._seed_nested_carry(cm.static, cm.params, state), 10,
                            True, seed_bound["bound_ms"], ("nested_count_kernel",))
        step_ms = device_ms(f"{label} step", frame_call, 10, True, step_bound["bound_ms"])
        fold_step_ms = device_ms(f"{label} fold step", fold_call, 10, True, fold_bound["bound_ms"])
        frame_dev_ms = device_ms(f"{label} frame", frame_call, 10, False,
                                 n_em * stage_bound["bound_ms"] + step_bound["bound_ms"])
        chain_least = 10 * (n_em * stage_bound["bound_ms"] + step_bound["bound_ms"])
        folded_chain_ms = device_ms(f"{label} folded chain", lambda: fs.chain_nested_folded(
            cm.static, cm.params, None, state, frame, 10), 3, False, chain_least)
        unfolded_chain_ms = device_ms(f"{label} unfolded chain", lambda: fs.chain_hybrid_unfolded(
            cm.static, cm.params, None, state, frame, 10), 3, False, chain_least)
        plain_frame_ms = device_ms(f"{label} plain frame", lambda: plain_frames(cm.static, cm.params, state, frame, 1,
                                                                                 stats=False), 3, False,
                                   step_bound["bound_ms"])
        plain_fold_ms = device_ms(f"{label} plain folded frame", plain_fold_call, 3, False, fold_bound["bound_ms"])
        launches_folded = (counts["fused_step"] + counts["nested_seed"] + counts["nested_stage"]) / warm
        res = {"phase": label, "card": card, "capacity": capacity, "live": alive,
               "per_type": out.alive_count_per_type.tolist(), "children_live": children, "chain_frames": warm,
               "launches": counts, "max_ulp": worst, "rule": "folded chain == unfolded chain bit for bit; counts, "
               "cursor, cadence exact against plain; f32 <= 4 ulp; no frame synchronises (sync debug mode error)",
               "ms_per_frame": ms, "particle_steps_per_s": alive / (ms * 1e-3), "plain_ms_per_frame": plain_ms,
               "stage_ms_per_launch": stage_ms, "stage_ms_per_frame": n_em * stage_ms,
               "folded_stage_ms_per_launch": folded_stage_ms, "seed_count_ms_per_launch": seed_ms,
               "step_ms_per_launch": step_ms,
               "fold_step_ms_per_launch": fold_step_ms, "device_ms_per_frame": frame_dev_ms,
               "folded_device_ms_per_frame": folded_chain_ms / 10,
               "unfolded_device_ms_per_frame": unfolded_chain_ms / 10,
               "kernel_launches_per_frame": {"folded": launches_folded, "unfolded": 1 + n_em},
               "plain_frame_device_ms": plain_frame_ms, "plain_folded_frame_device_ms": plain_fold_ms,
               "stage_share_of_device_frame": n_em * stage_ms / frame_dev_ms,
               "stage_share_of_frame": n_em * stage_ms / ms, "nested_emitters": n_em,
               "bounds": {"stage": stage_bound, "seed_count": seed_bound, "step": step_bound,
                          "fold_step": fold_bound},
               "frame_wall_ms": event_ms(frame_call, 20)}
        emit(res)
        return res, counts

    n60k, n60k_counts = nested_path("nested_60k", False)
    nch, nch_counts = nested_path("nested_chained", True)

    # ------------------------------------------------ 24a. ab_nested_fold
    def ab_nested_fold(captured=False):
        """bench.py's ab_nested_fold (:958-1029): nested_60k after 150 frames,
        ms/frame (host clock, (t(2n) - t(n)) / n, each run ending in a
        synchronize) of the folded chain (n = 100) and the unfolded chain
        (n = 101), 7 interleaved pairs; the pair with the median
        unfolded / folded ratio. Both chains launch by launch, or, with
        `captured`, both replay their graphs."""
        cm = bt.compile_spawner(bench_nested(False), nested_buffer=1024, device=dev)
        frame = bt.make_frame_input(1 / 60)
        st, _o = fs.multi_step_auto(cm.static, cm.params, None, bt.init_pool_for(cm, 16 * 8192, seed=0), frame, 150)
        torch.cuda.synchronize()

        def run(fold_on, n):
            if captured:  # the folded chain's graph against the unfolded chain's
                s_, _o = fs.multi_step_auto(cm.static, cm.params, None, st, frame, n) if fold_on else \
                    chain_graph.replay("unfolded", cm.static, cm.params, None, st, frame, n)
            elif fold_on:
                s_, _o = fs.multi_step_auto(cm.static, cm.params, None, st, frame, n, _captured=False)
            else:
                s_, _o = fs.chain_hybrid_unfolded(cm.static, cm.params, None, st, frame, n)
            torch.cuda.synchronize()

        n_on, n_off = 100, 101
        for on, n in ((True, n_on), (False, n_off)):
            run(on, n)
            run(on, 2 * n)
        pairs = []
        for _ in range(7):
            t0 = time.perf_counter()
            run(True, n_on)
            t1 = time.perf_counter()
            run(True, 2 * n_on)
            t2 = time.perf_counter()
            run(False, n_off)
            t3 = time.perf_counter()
            run(False, 2 * n_off)
            t4 = time.perf_counter()
            on_ms = ((t2 - t1) - (t1 - t0)) / n_on * 1e3
            off_ms = ((t4 - t3) - (t3 - t2)) / n_off * 1e3
            pairs.append((on_ms, off_ms, off_ms / on_ms if on_ms > 0 else None))
        ok = sorted((p for p in pairs if p[2] is not None), key=lambda p: p[2])
        med = ok[len(ok) // 2] if ok else (None, None, None)
        return {"fold_on_ms": med[0], "fold_off_ms": med[1], "off_over_on": med[2], "n_pairs": len(ok),
                "pairs": pairs, "live": int(st.alive.sum())}

    t_cell = time.perf_counter()
    ab_fold = ab_nested_fold()
    check(ab_fold["n_pairs"] >= 4, f"ab_nested_fold: {ab_fold}")
    emit({"phase": "ab_nested_fold", "card": card, **ab_fold, "seconds": time.perf_counter() - t_cell,
          "rule": "bench.py's A/B: folded (100 / 200 frames) and unfolded (101 / 202) interleaved, 7 pairs; the "
                  "median pair by off/on"})

    # ------------------------------------------------ 25. nested_flows
    from bevy_firework_tpu_torch.render import compact_dense

    def nested_flow(name, frames=300):
        """effects.<name>() through Scene on the card, then the same flow
        replayed by the plain version on the card: per-type counts every
        frame, the final state and the dense render rows."""
        made = getattr(effects, name)()
        sp_, tf_ = made[0], made[1]
        cols = made[2] if len(made) > 2 else None
        sc = bt.Scene(colliders=cols, device=dev)
        sid = sc.add_spawner(sp_, transform=tf_)
        counts_k = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(frames):
            sc.step(1 / 60)
            counts_k.append(sc._spawners[sid].outputs.alive_count_per_type)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / frames * 1e3
        slot = sc._spawners[sid]
        cf_ = slot.compiled
        tab = sc._colliders if cf_.static.any_collision else None
        fr = bt.make_frame_input(1 / 60, translation=tf_.translation, rotation=tf_.rotation)
        st = bt.init_pool_for(cf_, slot.capacity, seed=slot.seed)
        for i in range(frames):
            st, op = plain_frames(cf_.static, cf_.params, st, fr, 1, colliders=tab)
            check(torch.equal(op.alive_count_per_type, counts_k[i]), f"{name} flow frame {i}: per-type counts")
        compare(cf_, slot.state, st, {k: 64 for k in active_f32_fields(cf_.static)}, f"{name} flow",
                kernel="fused_step.nested_merge")
        rows = {}
        for t in range(cf_.num_types):
            a = compact_dense(bt.pack_instances_dense(cf_.params, slot.state, t)[0].cpu().numpy())
            b = compact_dense(bt.pack_instances_dense(cf_.params, st, t)[0].cpu().numpy())
            check(a.shape == b.shape and np.allclose(a, b, rtol=1e-5, atol=1e-5), f"{name} flow: type {t} rows")
            rows[t] = int(a.shape[0])
        items = sc.render_items()
        check({i.type_index for i in items} == set(range(cf_.num_types)), f"{name} flow: render items")
        return {"frames": frames, "per_type": counts_k[-1].tolist(), "rows": rows, "ms_per_scene_step": step_ms,
                "capacity": slot.capacity}

    flows_n, flows_counts = counted(lambda: {"fireworks": nested_flow("fireworks"),
                                             "textures": nested_flow("textures")})
    check(flows_counts["merge"] == 600 and flows_counts["nested_stage"] == 600, f"nested flows: {flows_counts}")
    check(flows_n["fireworks"]["per_type"][1] > 100 and flows_n["textures"]["per_type"][1] > 100,
          f"nested flows: {flows_n}")
    emit({"phase": "nested_flows", "card": card, "launches": flows_counts, **flows_n,
          "rule": "Scene on the card == the plain flow replayed on the card: per-type counts every frame, state "
                  "within 64 ulp, dense rows"})

    # ------------------------------------------------ 26. fleet_det
    from bevy_firework_tpu_torch.parallel.sharding import stack_frames, stack_pools, state_slot
    from bevy_firework_tpu_torch.pool import POOL_FIELDS

    import torch_fleet_configs as fleet_cfg

    fleet_det = {}
    for case in fleet_cfg.CASES:
        r = fleet_cfg.check_fleet_equals_solo(case, dev, 131072, plain=True)
        check(len(set(r["live"])) == fleet_cfg.S and min(r["live"]) > 5000, f"fleet_det {case}: {r}")
        check(case != "destroy_dump" or r["destroyed"] > 10000, f"fleet_det {case}: {r}")
        max_err["fused_step.fleet"] = max(max_err["fused_step.fleet"], r["max_abs_err_plain"])
        fleet_det[case] = r
    # lanes per slot not a multiple of 4: slot bases not 16-byte aligned
    for case in ("ring", "render_u8"):
        r = fleet_cfg.check_fleet_equals_solo(case, dev, 131073, plain=True)
        check(min(r["live"]) > 5000, f"fleet_det {case} unaligned: {r}")
        max_err["fused_step.fleet"] = max(max_err["fused_step.fleet"], r["max_abs_err_plain"])
        fleet_det[f"{case}_131073"] = r
    torch.cuda.synchronize()
    emit({"phase": "fleet_det", "card": card, "n": 131072, "slots": fleet_cfg.S, "cases": fleet_det,
          "rule": "each slot of every fleet launch == a solo launch of its pool, bit for bit (pool, key, outputs, "
                  "render planes), and == the plain frames (rotation <= 2 ulp); slots differ in params, seeds, "
                  "frames, fields; dead-rank claim, dump, stats, fields, render pack, U = 8; *_131073: 131073 lanes "
                  "per slot, slot bases not 16-byte aligned"})

    # ------------------------------------------------ 27. fleet_16x55k
    S16, cap16 = 16, 8 * 8192
    es16 = dataclasses.replace(stress_sp.emission_settings[0], emission_pacing=EmissionPacing.rate(55_000.0))
    c16 = bt.compile_spawner(dataclasses.replace(stress_sp, emission_settings=(es16,)), device=dev)
    pools16 = [bt.init_pool_for(c16, cap16, seed=i) for i in range(S16)]
    frames16 = [bt.make_frame_input(1 / 60, translation=(float(i), 0.0, 0.0)) for i in range(S16)]
    st16_0, fr16 = stack_pools(pools16), stack_frames(frames16)
    fs.kernel_tables(c16.static, c16.params)  # set-up: the table's and the frame rows' one copy each
    fs.fleet_slot_rows(fr16, dev)
    torch.cuda.synchronize()

    def fleet_chain(states, n):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fs.multi_step_fleet(c16.static, c16.params, None, states, fr16, n)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    (st16, out16), fleet_counts = counted(lambda: fleet_chain(st16_0, 140))
    torch.cuda.synchronize()
    want16 = len(fs.chain_shape(140, fs.chain_unroll(c16.static)))
    check(fleet_counts["fleet"] == want16 and fleet_counts["fused_step"] == 0 and fleet_counts["fleet_stats"] == 1,
          f"fleet_16x55k: the chain's launches {fleet_counts}")
    secs16, t_mark = {}, time.perf_counter()
    worst16 = {}
    plain16_slots = (0, 5, 10, 15)  # slots also held to 140 plain frames (every slot == its solo chain)
    for i in range(S16):
        si = state_slot(st16, i)
        solo, solo_out = fs.multi_step_auto(c16.static, c16.params, None, pools16[i], frames16[i], 140)
        for k in POOL_FIELDS:
            check(torch.equal(getattr(si, k).cpu(), getattr(solo, k).cpu()), f"fleet_16x55k slot {i}: {k} != solo")
        check(int(out16.alive_count[i]) == int(solo_out.alive_count), f"fleet_16x55k slot {i}: live count")
        if i not in plain16_slots:
            continue
        ref, ref_out = plain_frames(c16.static, c16.params, pools16[i], frames16[i], 140)
        check(int(ref_out.alive_count) == int(out16.alive_count[i]), f"fleet_16x55k slot {i}: live count != plain")
        for k in ("ring_cursor", "time_in_cycle", "last_emission", "alive", "rng_key"):
            check(torch.equal(getattr(ref, k).cpu(), getattr(si, k).cpu()), f"fleet_16x55k slot {i}: {k} != plain")
        for k in active_f32_fields(c16.static):
            a, b = getattr(ref, k), getattr(si, k)
            worst16[k] = max(worst16.get(k, 0), ulp_diff(a, b))
            max_err["fused_step.fleet"] = max(max_err["fused_step.fleet"], float((a - b).abs().max()))
            check(worst16[k] <= 4 and bool(torch.isfinite(b).all()), f"fleet_16x55k slot {i}: {k} {worst16[k]} ulp")
    alive16 = int(out16.alive_count.sum())
    check(alive16 > 16 * 50000, f"fleet_16x55k: {alive16} live")

    def solo16(n):
        sts = [state_slot(st16, i) for i in range(S16)]
        for i in range(S16):
            sts[i], _o = fs.multi_step_auto(c16.static, c16.params, None, sts[i], frames16[i], n)
        return sts

    def differential16(fn, n, reps):
        diffs = []
        for _ in range(reps):
            t_n = event_ms(lambda: fn(n), 1)
            t_2n = event_ms(lambda: fn(2 * n), 1)
            diffs.append((t_2n - t_n) / n)
        return statistics.median(diffs)

    secs16["checks"], t_mark = time.perf_counter() - t_mark, time.perf_counter()
    fleet_ms = differential16(lambda n: fleet_chain(st16, n), 100, 5)
    solo16_ms = differential16(solo16, 100, 3)
    n_active16 = len(active_f32_fields(c16.static))
    bound16 = bound(2 * 4 * n_active16 * cap16 * S16, 8 * INTEGRATE_OPS * alive16)

    def fleet_launch():
        return fs.fused_step_fleet(c16.static, c16.params, None, st16, fr16, unroll=8, stats=False)

    def solo_launches():
        return [fs.fused_step(c16.static, c16.params, None, state_slot(st16, i), frames16[i], unroll=8, stats=False)
                for i in range(S16)]

    def plain16():
        return [plain_frames(c16.static, c16.params, state_slot(st16, i), frames16[i], 8, stats=False)
                for i in range(S16)]

    secs16["chains_timed"], t_mark = time.perf_counter() - t_mark, time.perf_counter()
    fleet_dev_ms = device_ms("fleet_16x55k U=8", fleet_launch, 20, True, bound16["bound_ms"])
    # the 16 solo launches: their mean device time per launch, times 16
    solo16_dev_ms = S16 * device_ms("fleet_16x55k solo U=8", solo_launches, 5, True, bound16["bound_ms"] / S16)
    plain16_ms = device_ms("fleet_16x55k plain", plain16, 1, False, bound16["bound_ms"])
    secs16["device_times"] = time.perf_counter() - t_mark
    res16 = {"phase": "fleet_16x55k", "card": card, "slots": S16, "capacity": cap16, "rate": 55_000.0,
             "live": alive16, "chain_frames": 140, "chain_launches": fleet_counts["fleet"], "launches": fleet_counts,
             "max_ulp": worst16, "rule": "every slot == its solo multi_step_auto chain bit for bit; slots 0, 5, 10, 15 "
             "== 140 plain frames: counts, cursor, cadence exact, f32 <= 4 ulp; no frame synchronises (sync debug "
             "mode error)",
             "ms_per_frame": fleet_ms, "particle_steps_per_s": alive16 / (fleet_ms * 1e-3),
             "solo16_ms_per_frame": solo16_ms, "u8_fleet_kernel_device_ms": fleet_dev_ms,
             "u8_solo16_kernels_device_ms": solo16_dev_ms, "plain_8_frames_device_ms": plain16_ms,
             "u8_fleet_launch_wall_ms": event_ms(fleet_launch, 20), "u8_solo16_launches_wall_ms": event_ms(
                 solo_launches, 5), "bound": bound16, "seconds": secs16}
    emit(res16)

    # ------------------------------------------------ 28. fleet_flow
    t_mark = time.perf_counter()
    flow_card, flow_counts = counted(lambda: {sh: fleet_cfg.one_shot_fleet_flow(dev, sh)
                                              for sh in fleet_cfg.FLOW_SHAPES})
    torch.cuda.synchronize()
    flow_res = {"card_seconds": time.perf_counter() - t_mark}
    check(flow_counts["fleet"] == 200 * len(fleet_cfg.FLOW_SHAPES) and flow_counts["fused_step"] == 0,
          f"fleet_flow: launches {flow_counts}")
    for sh, fc in flow_card.items():
        check(sorted(s for fin in fc["finished"] for s in fin) == sorted(fc["activated"]),
              f"fleet_flow {sh}: finished {fc['finished']} for activated {fc['activated']}")
        flow_res[sh] = {"activated": fc["activated"], "peak_live": max(fc["live"]),
                        "finished_at": {str(f + 1): s for f, s in enumerate(fc["finished"]) if s}}
        refs = [("plain", lambda: fleet_cfg.one_shot_fleet_flow(dev, sh, plain=True))]
        if sh == "circle":  # the CPU Fleet where the card's libm meets the CPU's (the box flow: the card's replay)
            refs.append(("cpu", lambda: fleet_cfg.one_shot_fleet_flow("cpu", sh)))
        for ref, replay in refs:
            run = replay()
            diff = fleet_cfg.compare_fleet_flows(fc, run)
            check(fleet_cfg.flow_rule_holds(sh, ref, diff), f"fleet_flow {sh}: card != {ref} Fleet: {diff}")
            flow_res[sh]["vs_" + ref] = diff
            if ref == "plain":
                max_err["fused_step.fleet"] = max(max_err["fused_step.fleet"], diff["max_abs"])
    emit({"phase": "fleet_flow", "card": card, "frames": 200, "slots": 8, "capacity": 64, "launches": flow_counts,
          **flow_res, "rule": "Fleet on the card against the same flow stepped by the plain version on the card and "
                              "by the Fleet on the CPU (the circle flow): finished slots and live counts every frame, "
                              "integer leaves and "
                              "keys at frames 1, 30, 100, 160, 200, render items' slots and counts at frames 1 and "
                              "100 exact; f32 against the card's plain replay bit for bit with a box emission, "
                              "within 4 ulp with the one_shot circle's sinf/cosf; against the CPU within 1e-5"})

    # ------------------------------------------------ 29. scene_groups
    def scene_batch_12():
        sp_ = effects.sparks(rate=6000.0)[0]
        sc = bt.Scene(device=dev)
        for i in range(12):
            sc.add_spawner(sp_, capacity=8192, transform=bt.Transform(translation=(float(i), 0.0, 0.0)))
        return sc

    def scene_hetero_100():
        sparks2k = effects.sparks(rate=2000.0)[0]
        pbr = effects.pbr()[0]
        smoke = dataclasses.replace(pbr, emission_settings=tuple(
            dataclasses.replace(e, emission_pacing=EmissionPacing.rate(800.0)) for e in pbr.emission_settings))
        bouncy = bt.ParticleSpawner(
            particle_settings=[bt.ParticleSettings(lifetime=bt.RandF32.constant(2.0), collision_settings=(
                ParticleCollisionSettings(restitution=0.6, friction=0.2)))],
            emission_settings=[bt.EmissionSettings(emission_pacing=EmissionPacing.rate(500.0), initial_velocity=(
                bt.RandVec3(magnitude=bt.RandF32(2.0, 5.0), direction=(0, 1, 0), spread=0.6)))])
        oneshotish = dataclasses.replace(sparks2k, particle_settings=tuple(
            dataclasses.replace(p, lifetime=bt.RandF32(0.5, 1.5)) for p in sparks2k.particle_settings))
        archetypes = [sparks2k, smoke, bouncy, oneshotish]
        sc = bt.Scene(colliders=[bt.Collider.halfspace(position=(0.0, -1.0, 0.0))], device=dev)
        for i in range(100):
            sc.add_spawner(archetypes[i % 4], capacity=8192,
                           transform=bt.Transform(translation=(float(i % 10), 0.0, float(i // 10))))
        return sc

    def replay_check(sc, frames_of, label):
        """The members frames_of names against the plain version replaying
        their frames on the card from a fresh pool: counts, cursor and
        cadence exact, f32 within 64 ulp, dense rows within 1e-5."""
        worst = 0
        for sid, n_frames in frames_of.items():
            slot = sc._spawners[sid]
            cm = slot.compiled
            tab = sc._colliders if cm.static.any_collision else None
            st = bt.init_pool_for(cm, slot.capacity, seed=slot.seed)
            fr = bt.make_frame_input(1 / 60, translation=slot.transform.translation)
            for _ in range(n_frames):
                st, op = plain_frames(cm.static, cm.params, st, fr, 1, colliders=tab)
            w = compare(cm, slot.state, st, {k: 64 for k in active_f32_fields(cm.static)}, f"{label} sid {sid}",
                        kernel="fused_step.fleet")
            worst = max([worst] + list(w.values()))
            a = compact_dense(bt.pack_instances_dense(cm.params, slot.state, 0)[0].cpu().numpy())
            b = compact_dense(bt.pack_instances_dense(cm.params, st, 0)[0].cpu().numpy())
            check(a.shape == b.shape and np.allclose(a, b, rtol=1e-5, atol=1e-5), f"{label} sid {sid}: rows")
        return worst

    def one_by_one(sc):
        """The scene's spawners, to step one by one through step_auto_packed
        from their states now: [compiled, colliders, state, frame] each."""
        return [[slot.compiled, sc._colliders if slot.compiled.static.any_collision else None, slot.state,
                 sc._frame_for(slot, 1 / 60)] for slot in sc._spawners.values()]

    def step_one_by_one(items, n, churn=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(n):
            if churn is not None:  # the churn cell's edit: the oldest member out, a fresh pool in
                items.append([items[0][0], None, bt.init_pool_for(items[0][0], 8192, seed=churn + k), items[0][3]])
                items.pop(0)
            for it in items:
                it[2], _o, _p = bt.step_auto_packed(it[0].static, it[0].params, it[1], it[2], it[3])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    group_counts = {}

    def grouped(fn):
        """fn() with its launches added to the scene cells' counts."""
        result, cnt = counted(fn)
        for k, v in cnt.items():
            group_counts[k] = group_counts.get(k, 0) + v
        return result

    groups_res = {}
    for name, make, n_groups in (("scene_batch_12", scene_batch_12, 1), ("scene_hetero_100", scene_hetero_100, 4)):
        t_cell = time.perf_counter()
        sc = make()
        grouped(lambda: [sc.step(1 / 60) for _ in range(30)])
        check(sc._last_step_dispatches == n_groups and len(sc._batches) == n_groups,
              f"{name}: {sc._last_step_dispatches} dispatch groups")
        # scene_hetero_100: every fifth member (20, each archetype and slots
        # across each group's stack), the others by their group's launches
        worst = replay_check(sc, {sid: 30 for sid in sc._spawners if n_groups == 1 or sid % 5 == 0}, name)
        sc.render_items()  # render demand on: every group packs, as step_auto_packed does one by one
        items = one_by_one(sc)
        before = dict(group_counts)
        g_ms, o_ms = [], []
        for _ in range(3):  # interleaved windows of 40 frames
            g_ms.append(grouped(lambda: step_ms(sc, 40)))
            o_ms.append(step_one_by_one(items, 40))
        launched = group_counts["fleet"] - before.get("fleet", 0)
        packed = group_counts["fleet_render"] - before.get("fleet_render", 0)
        check(launched == packed == 120 * n_groups and group_counts["fused_step"] == 0,
              f"{name}: launches {group_counts}")
        groups_res[name] = {"spawners": len(sc._spawners), "dispatch_groups": sc._last_step_dispatches,
                            "live": sc.alive_count(), "ms_per_scene_step": statistics.median(g_ms),
                            "one_by_one_ms_per_frame": statistics.median(o_ms), "windows": {"grouped": g_ms,
                            "one_by_one": o_ms}, "max_ulp_vs_plain": worst,
                            "seconds": time.perf_counter() - t_cell}

    # group_churn_12: one member out and a new one in per frame
    t_cell = time.perf_counter()
    sc = scene_batch_12()
    sp6k = effects.sparks(rate=6000.0)[0]
    frames_of = {sid: 0 for sid in sc._spawners}

    def churn_steps(n, k0):
        for k in range(n):
            sc.remove_spawner(min(sc._spawners))
            del frames_of[min(frames_of)]
            sid = sc.add_spawner(sp6k, capacity=8192, transform=bt.Transform(translation=(float(100 + k0 + k), 0.0,
                                                                                             0.0)))
            frames_of[sid] = 0
            sc.step(1 / 60)
            for s_ in frames_of:
                frames_of[s_] += 1

    def steady_steps(n):
        for _ in range(n):
            sc.step(1 / 60)
            for s_ in frames_of:
                frames_of[s_] += 1

    grouped(lambda: steady_steps(30))
    grouped(lambda: churn_steps(1, 0))
    worst = replay_check(sc, frames_of, "group_churn_12")
    sc.render_items()  # render demand on, as for the cells above
    items = one_by_one(sc)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grouped(fn)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 40 * 1e3

    c_ms, s_ms, o_ms = [], [], []
    for w in range(3):  # interleaved windows of 40 frames
        c_ms.append(timed(lambda: churn_steps(40, 1 + 40 * w)))
        s_ms.append(timed(lambda: steady_steps(40)))
        o_ms.append(step_one_by_one(items, 40, churn=1000 + 40 * w))
    worst = max(worst, replay_check(sc, frames_of, "group_churn_12 after churn"))
    groups_res["group_churn_12"] = {"spawners": 12, "dispatch_groups": sc._last_step_dispatches,
                                    "live": sc.alive_count(), "churn_ms_per_scene_step": statistics.median(c_ms),
                                    "steady_ms_per_scene_step": statistics.median(s_ms),
                                    "one_by_one_churn_ms_per_frame": statistics.median(o_ms),
                                    "windows": {"churn": c_ms, "steady": s_ms, "one_by_one": o_ms},
                                    "max_ulp_vs_plain": worst, "seconds": time.perf_counter() - t_cell}
    # one fleet launch per group and frame: batch_12 and hetero_100 150
    # frames each (1 and 4 groups), the churn cell 31 + 3 * 80 frames
    check(group_counts["fused_step"] == 0 and group_counts["fleet"] == 150 * 1 + 150 * 4 + 31 + 240,
          f"scene_groups: launches {group_counts}")
    emit({"phase": "scene_groups", "card": card, "launches": group_counts, **groups_res,
          "rule": "members == the plain version replaying their frames on the card (counts exact, f32 <= 64 ulp, "
                  "rows; scene_hetero_100: every fifth member); one fleet launch per archetype group and frame; "
                  "timed with the render pack on, grouped and one by one (step_auto_packed)"})

    # ------------------------------------------------ 30. render_f16_det
    import torch_render_configs as render_cfg

    max_err["fused_step.pack_render_f16"] = 0.0

    def f16_pair(cm, st, frame, u=1):
        """A launch with the f16 record and one with the f32 pack from the
        same state: (state, f16 planes, f32 planes)."""
        sk, _o, p16 = fs.fused_step(cm.static, cm.params, None, st, frame, unroll=u, pack_render="f16")
        s32, _o, p32 = fs.fused_step(cm.static, cm.params, None, st, frame, unroll=u, pack_render=True)
        check(torch.equal(sk.px, s32.px) and torch.equal(sk.age, s32.age), "f16 and f32 pack launches differ")
        return sk, p16, p32

    def record_check(cm, st, p16, p32, label):
        err = render_cfg.check_record(cm.static, cm.params, st, p16, p32, label)
        max_err["fused_step.pack_render_f16"] = max(max_err["fused_step.pack_render_f16"], err)

    t_cell = time.perf_counter()
    f50 = bt.make_frame_input(1 / 50)
    f16_res = {}
    stress_100k = dataclasses.replace(stress_sp, emission_settings=(dataclasses.replace(
        stress_sp.emission_settings[0], emission_pacing=EmissionPacing.rate(1e5)),))
    for label, sp_ in (("elided_12", render_cfg.f16_spawner(False)), ("rotating_16", det_spawner()),
                       ("stress_test_12", stress_100k)):
        cm = bt.compile_spawner(sp_, device=dev)
        st = bt.init_pool_for(cm, 131072)
        for u in [1] * 6 + [8] * 3:
            st, p16, p32 = f16_pair(cm, st, f50, u)
            record_check(cm, st, p16, p32, f"render_f16_det {label} U={u}")
        f16_res[label] = {"planes": len(p16), "live": int(st.alive.sum())}
    cn = bt.compile_spawner(bench_nested(False), nested_buffer=1024, device=dev)
    sn, _o = fs.multi_step_auto(cn.static, cn.params, None, bt.init_pool_for(cn, 16 * 8192), fdet, 40)
    sn, p16, p32 = f16_pair(cn, sn, fdet)
    record_check(cn, sn, p16, p32, "render_f16_det hybrid")
    f16_res["hybrid_nested_60k"] = {"planes": len(p16), "live": int(sn.alive.sum())}
    cf = bt.compile_spawner(det_spawner(), device=dev)
    frames3 = stack_frames([bt.make_frame_input(1 / 50, translation=(float(i), 0.0, 0.0)) for i in range(3)])
    stf, _o = fs.multi_step_fleet(cf.static, cf.params, None,
                                  stack_pools([bt.init_pool_for(cf, 131072, seed=i) for i in range(3)]), frames3, 20)
    sf16, _o, fp16 = fs.fused_step_fleet(cf.static, cf.params, None, stf, frames3, unroll=8, pack_render="f16")
    sf32, _o, fp32 = fs.fused_step_fleet(cf.static, cf.params, None, stf, frames3, unroll=8, pack_render=True)
    for i in range(3):
        record_check(cf, state_slot(sf16, i), [p[i] for p in fp16], [p[i] for p in fp32], f"render_f16_det fleet {i}")
    f16_res["fleet_3x131072"] = {"planes": len(fp16), "live": [int(state_slot(sf16, i).alive.sum()) for i in range(3)]}
    torch.cuda.synchronize()
    emit({"phase": "render_f16_det", "card": card, "n": 131072, **f16_res, "seconds": time.perf_counter() - t_cell,
          "rule": "the kernel's f16 record == the plain version (render.pack_render_planes(..., 'f16')) on the state "
                  "the launch wrote, bit for bit (NaN by isnan), and == the same launch's f32 pack and the state's "
                  "positions and quaternion rounded to nearest even; 1-frame and U=8 launches, a hybrid launch of "
                  "nested_60k's effect, a 3-slot U=8 fleet launch"})

    # ------------------------------------------------ 31. render_extract_1M
    # the main_1M state (stress_test at 1e6/s, capacity 1310720, 140 frames)
    t_cell = time.perf_counter()
    cm, st, cap = c1m_main, s1m_main, 160 * 8192
    frame1m = bt.make_frame_input(1 / 60)
    live1m = int(st.alive.sum())
    n_rec = 12 if cm.static.elide_rotation else 16
    state_bytes = 2 * 4 * len(active_f32_fields(cm.static)) * cap
    pack_bytes = {"none": 0, "f32": 4 * L.N_RENDER * cap, "f16": 2 * n_rec * cap}
    modes = {"none": False, "f32": True, "f16": "f16"}
    ext = {"live": live1m, "capacity": cap, "pack_bytes_per_lane": {k: v / cap for k, v in pack_bytes.items()}}
    for u in (8, 1):
        for name, mode in modes.items():
            b = bound(state_bytes + pack_bytes[name], u * INTEGRATE_OPS * live1m)

            def launch(u=u, mode=mode):
                return fs.fused_step(cm.static, cm.params, None, st, frame1m, unroll=u, pack_render=mode, stats=False)

            ext[f"u{u}_{name}"] = {"ms": device_ms(f"render_extract_1M U={u} {name}", launch, 20, True, b["bound_ms"]),
                                   **b}

    def plain_f16_frame():
        sp_, _o = plain_frames(cm.static, cm.params, st, frame1m, 1, stats=False)
        return pack_render_planes(cm.static, cm.params, sp_, "f16")

    ext["plain_u1_f16_ms"] = device_ms("render_extract_1M plain f16", plain_f16_frame, 1, False,
                                       ext["u1_f16"]["bound_ms"])
    ext["u1_f16_wall_ms"] = event_ms(lambda: fs.fused_step(cm.static, cm.params, None, st, frame1m, pack_render="f16",
                                                           stats=False), 20)
    ext["plain_u1_f16_wall_ms"] = event_ms(plain_f16_frame, 1)
    ext["seconds"] = time.perf_counter() - t_cell
    emit({"phase": "render_extract_1M", "card": card, **ext,
          "rule": "device time per launch (torch.profiler, stats off) with no pack, the f32 pack and the f16 record "
                  "from the main_1M state, each held to its bytes bound (the state's planes read and written, the "
                  "pack's planes written) over 3.35 TB/s"})

    # ---------------------------------------- 32./33. render_loop, render_loop_1M
    def pinned_probe_ms(n_bytes, reps=12):
        """One copy of n_bytes from the card into pinned host memory on a side
        stream (CUDA events), the median of reps after two warm-ups."""
        src = torch.ones(n_bytes // 4, dtype=torch.float32, device=dev)
        dst = torch.empty(src.shape, dtype=torch.float32, pin_memory=True)
        stream = torch.cuda.Stream(dev)
        times = []
        for _ in range(reps + 2):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(stream):
                a.record(stream)
                dst.copy_(src, non_blocking=True)
                b.record(stream)
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times[2:])

    def render_loop_cell(label, rate, capacity, frames, check_frames):
        """examples/render_loop.py's loop (tests/torch_render_configs.py):
        stress_test at `rate`, per record (f32 pack, f16 record) the sim
        loop without and with the reader, interleaved (without, with, with,
        without), then a run holding every drawn frame to the plain pack of
        its state."""
        es = dataclasses.replace(stress_sp.emission_settings[0], emission_pacing=EmissionPacing.rate(float(rate)))
        cm = bt.compile_spawner(dataclasses.replace(stress_sp, emission_settings=(es,)), device=dev)
        frame = bt.make_frame_input(1 / 60)
        n_rec = 12 if cm.static.elide_rotation else 16
        res = {"capacity": capacity, "rate": rate, "frames": frames}
        for record, name in ((True, "f32"), ("f16", "f16")):
            runs = [render_cfg.render_loop(cm, frame, capacity, frames, record, reader=r)
                    for r in (False, True, True, False)]
            checked = render_cfg.render_loop(cm, frame, capacity, check_frames, record, check=True)
            for r in runs[1:3] + [checked]:
                check(len(r["drawn"]) > 0 and r["drawn"] == sorted(set(r["drawn"])), f"{label} {name}: drawn ids")
            check(checked["checked"] == len(checked["drawn"]) > 0, f"{label} {name}: {checked['checked']} checked")
            n_bytes = n_rec * capacity * (4 if record is True else 2)
            copy = runs[1]["copy_ms"] + runs[2]["copy_ms"]
            res[name] = {"ms_per_frame_without_reader": [runs[0]["ms_per_frame"], runs[3]["ms_per_frame"]],
                         "ms_per_frame_with_reader": [runs[1]["ms_per_frame"], runs[2]["ms_per_frame"]],
                         "frames_drawn": [len(runs[1]["drawn"]), len(runs[2]["drawn"])],
                         "frames_published": [runs[1]["published"], runs[2]["published"]],
                         "checked_frames": check_frames, "checked_drawn": checked["checked"],
                         "skipped_older": checked["skipped"], "live": runs[1]["live"],
                         "copy_bytes_per_frame": n_bytes, "copy_ms_median": statistics.median(copy),
                         "copy_ms_min": min(copy), "pinned_probe_ms": pinned_probe_ms(n_bytes)}
        return res

    t_cell = time.perf_counter()
    loop_res, loop_counts = counted(lambda: render_loop_cell("render_loop", 30_000, 65536, 240, 240))
    check(loop_counts["render"] == 4 * 240 + 240 and loop_counts["render_f16"] == 4 * 240 + 240
          and loop_counts["fused_step"] == 2 * (5 * 240), f"render_loop: launches {loop_counts}")
    emit({"phase": "render_loop", "card": card, "launches": loop_counts, **loop_res,
          "seconds": time.perf_counter() - t_cell,
          "rule": "every drawn frame's rows == the plain pack of its post-step state (f32 rows, or f16 rows of the "
                  "record), drawn frame ids strictly increasing; ms/frame: host clock over frames 11-240 ending in "
                  "a synchronize; copy_ms: the reader's copy stream per frame (CUDA events) beside one pinned copy "
                  "of the same bytes"})
    t_cell = time.perf_counter()
    loop1m_res, loop1m_counts = counted(lambda: render_loop_cell("render_loop_1M", 1_000_000, 160 * 8192, 240, 60))
    check(loop1m_counts["render"] == 4 * 240 + 60 and loop1m_counts["render_f16"] == 4 * 240 + 60,
          f"render_loop_1M: launches {loop1m_counts}")
    emit({"phase": "render_loop_1M", "card": card, "launches": loop1m_counts, **loop1m_res,
          "seconds": time.perf_counter() - t_cell,
          "rule": "as render_loop, at 1e6/s and capacity 1310720; the checked run is 60 frames (its states stay on "
                  "the card until it ends, 42 MB each: a frame drawn late is still checked)"})

    # ------------------------------------------------ 34. scene_async_render
    def scene_async():
        """The sparks flow's Scene with async render on: two sparks spawners
        (one archetype group: each submits its row of the group's render
        pack) and a two-type spawner (the dense pack per type), 120 steps;
        every render_async item == render_items of the frame its frame_id
        names; compact == dense."""
        sparks_sp = bt.ParticleSpawner(
            particle_settings=[bt.ParticleSettings(lifetime=bt.RandF32.constant(0.75))],
            emission_settings=[bt.EmissionSettings(emission_pacing=bt.EmissionPacing.rate(1000.0))])
        two = bt.ParticleSpawner(
            particle_settings=[bt.ParticleSettings(lifetime=bt.RandF32.constant(0.75)),
                               bt.ParticleSettings(lifetime=bt.RandF32.constant(0.5))],
            emission_settings=[bt.EmissionSettings(particle_index=t, emission_pacing=bt.EmissionPacing.rate(800.0))
                               for t in (0, 1)])
        sc = bt.Scene(device=dev)
        sc.enable_async_render()
        for i in range(2):
            sc.add_spawner(sparks_sp, capacity=2048, transform=bt.Transform(translation=(2.0 * i, 0.0, 0.0)))
        sc.add_spawner(two, capacity=4096)
        sync, items_seen, ids = {}, 0, {}
        for k in range(1, 121):
            sc.step(1 / 60)
            for it in sc.render_items():
                sync[(it.spawner_id, it.type_index, k)] = it.instances.copy()
            for it in sc.render_async():
                want = sync.get((it.spawner_id, it.type_index, it.frame_id))
                check(want is not None and it.instances.shape == want.shape and np.array_equal(it.instances, want),
                      f"scene_async_render: item {(it.spawner_id, it.type_index)} of frame {it.frame_id} at {k}")
                ids.setdefault((it.spawner_id, it.type_index), []).append(it.frame_id)
                items_seen += 1
        sc.release_async()
        deadline = time.time() + 30
        last = {key: v[-1] for key, v in ids.items()}
        while time.time() < deadline and not (len(last) == 4 and all(v == 120 for v in last.values())):
            for it in sc.render_async():
                check(np.array_equal(it.instances, sync[(it.spawner_id, it.type_index, it.frame_id)]),
                      f"scene_async_render: drained item of frame {it.frame_id}")
                last[(it.spawner_id, it.type_index)] = it.frame_id
            time.sleep(0.01)
        sc.release_async()
        check(len(last) == 4 and all(v == 120 for v in last.values()), f"scene_async_render: drained {last}")
        check(all(v == sorted(set(v)) for v in ids.values()), "scene_async_render: frame ids not increasing")
        dense, compact = sc.render_items(), sc.render_items(method="compact")
        check(len(dense) == len(compact) == 4 and all(
            a.spawner_id == b.spawner_id and a.type_index == b.type_index and np.array_equal(a.instances, b.instances)
            for a, b in zip(dense, compact)), "scene_async_render: compact != dense")
        t_on = step_ms(sc, 60)
        sc.disable_async_render()
        t_off = step_ms(sc, 60)
        out = {"items_checked": items_seen, "items_per_key": {str(k): len(v) for k, v in ids.items()},
               "live": sc.alive_count(), "dispatch_groups": sc._last_step_dispatches,
               "ms_per_scene_step_async_on": t_on, "ms_per_scene_step_async_off": t_off}
        return out

    t_cell = time.perf_counter()
    async_res, async_counts = counted(scene_async)
    check(async_counts["fleet_render"] == 240 and async_counts["fleet"] == 240, f"scene_async_render: {async_counts}")
    emit({"phase": "scene_async_render", "card": card, "launches": async_counts, **async_res,
          "seconds": time.perf_counter() - t_cell,
          "rule": "each render_async item == render_items of the frame its frame_id names (rows exact), ids "
                  "strictly increasing, every item reaches frame 120; render_items(method='compact') == 'dense'"})

    # ------------------------------------------------ 35. shard_det
    import torch_shard_configs as shard_cfg

    shard_ulps = {"det": {k: 2 for k in ("qx", "qy", "qz", "qw")}, "stress": None, "destroy": {}}

    def shard_det():
        """Per config and U: the unsharded kernel's launches over 30 frames,
        then S = 2, 4, 8 shards of the same pool: stitched == unsharded bit
        for bit (every leaf; the stats rows reduced) on every launch, and
        each shard == the plain version with the same shard arguments on
        the same input on the first and the last launch."""
        out = {}
        for name in ("det", "stress", "destroy"):
            c, table, frame = shard_cfg.config(name, dev)
            ulps = shard_ulps[name] if shard_ulps[name] is not None else {k: 4 for k in active_f32_fields(c.static)}
            for u in ((1, 8) if fs.can_unroll(c.static) else (1,)):
                whole0 = bt.init_pool_for(c, 131072)
                if c.static.ring_claim:  # start near the ring's end: the claims wrap
                    whole0 = dataclasses.replace(whole0, ring_cursor=torch.tensor(131072 - 700, dtype=torch.int32,
                                                                                 device=dev))
                shape = fs.chain_shape(30, u) if u > 1 else [1] * 30
                wholes, w = [], whole0
                for uu in shape:
                    w, o = fs.fused_step(c.static, c.params, table, w, frame, unroll=uu)
                    wholes.append((w, o))
                for n_shards in (2, 4, 8):
                    shards = shard_cfg.split(whole0, n_shards)
                    for i, uu in enumerate(shape):
                        args = shard_cfg.shard_args(c.static, shards)
                        plain = [] if 0 < i < len(shape) - 1 else [  # the plain version: first and last launch
                            plain_frames(c.static, c.params, sh_, frame, uu, colliders=table, shard=a)[0]
                            for sh_, a in zip(shards, args)]
                        shards, outs, _p = shard_cfg.step_shards(c, table, shards, frame, unroll=uu)
                        lbl = f"shard_det {name} U={u} S={n_shards} launch {i}"
                        bad = shard_cfg.pool_mismatch(shard_cfg.stitch(shards), wholes[i][0])
                        check(bad == [], f"{lbl}: {bad} != the unsharded kernel")
                        bad = shard_cfg.outputs_mismatch(wholes[i][1], shard_cfg.reduce_outputs(outs))
                        check(bad == [], f"{lbl}: reduced stats {bad} != the unsharded kernel's")
                        for sh_, pl in zip(shards, plain):
                            compare(c, sh_, pl, ulps, lbl, kernel="fused_step.sharded_claim")
                    out[f"{name}_u{u}_s{n_shards}"] = int(wholes[-1][1].alive_count)
        return out

    t_cell = time.perf_counter()
    shard_det_res = shard_det()
    emit({"phase": "shard_det", "card": card, "n": 131072, "live": shard_det_res,
          "seconds": time.perf_counter() - t_cell,
          "rule": "30 frames, S = 2, 4, 8 shards (kernel row 11: lane base, global capacity, dead offset): stitched "
                  "== the unsharded kernel bit for bit, every leaf, the stats rows reduced across shards, every "
                  "launch; each shard == the plain version with the same shard arguments on the first and the last "
                  "launch (det: rotation <= 2 ulp, sinf/cosf; stress: f32 <= 4 ulp; destroy: bit for bit; scalars "
                  "exact)"})

    # ------------------------------------------------ 36. sharded_1M
    def sharded_1m():
        """main_1M's cell split S = 2, 4, 8 in one process: a 140-frame chain
        stitched == the unsharded chain bit for bit; the device time per
        frame summed over the shards beside the unsharded U = 8 launch, each
        shard's U = 8 launch beside its bytes bound; destroy_claim's emitter
        at 1310720 lanes and 5e5/s, S = 4, 30 frames, bit for bit, each
        frame's shards (their dead offsets device tensors) stepped under
        sync debug mode "error"; then at that state the carried claim's
        timings (`claim_timing`) and the S = 4 sharded destroy frame."""
        c, _t, frame = shard_cfg.config("stress", dev, rate=1e6)
        cap = 160 * 8192
        whole0 = bt.init_pool_for(c, cap, seed=0)
        whole, wout = fs.multi_step_auto(c.static, c.params, None, whole0, frame, 140)
        shape = fs.chain_shape(140, fs.chain_unroll(c.static))
        n_active = len(active_f32_fields(c.static))
        live = int(wout.alive_count)
        res, counts_all = {"live": live, "chain_frames": 140, "by_shards": {}}, {}

        def chain(shards):
            out = None
            for i, u in enumerate(shape):
                shards, out, _p = shard_cfg.step_shards(c, None, shards, frame, unroll=u, stats=i == len(shape) - 1)
            return shards, out

        def u8_whole():
            return fs.fused_step(c.static, c.params, None, whole, frame, unroll=8, stats=False)

        whole_u8_ms = device_ms("sharded_1M unsharded U=8", u8_whole, 20, True,
                                bound(2 * 4 * n_active * cap, 8 * INTEGRATE_OPS * live)["bound_ms"])
        res["unsharded_u8_ms"] = whole_u8_ms
        for n_shards in (2, 4, 8):
            (shards, outs), counts = counted(lambda: chain(shard_cfg.split(whole0, n_shards)))
            torch.cuda.synchronize()
            check(counts["shard"] == n_shards * len(shape), f"sharded_1M S={n_shards}: launches {counts}")
            counts_all[n_shards] = counts
            bad = shard_cfg.pool_mismatch(shard_cfg.stitch(shards), whole)
            check(bad == [], f"sharded_1M S={n_shards}: {bad} != the unsharded chain")
            bad = shard_cfg.outputs_mismatch(wout, shard_cfg.reduce_outputs(outs))
            check(bad == [], f"sharded_1M S={n_shards}: reduced stats {bad}")
            args = shard_cfg.shard_args(c.static, shards)
            bounds_ = [bound(2 * 4 * n_active * sh_.capacity, 8 * INTEGRATE_OPS * int(sh_.alive.sum()))
                       for sh_ in shards]
            per = [device_ms(f"sharded_1M S={n_shards} shard {r} U=8", lambda sh_=sh_, a=a: fs.fused_step(
                c.static, c.params, None, sh_, frame, unroll=8, stats=False, shard=a), 20, True, b["bound_ms"])
                for r, (sh_, a, b) in enumerate(zip(shards, args, bounds_))]
            res["by_shards"][n_shards] = {
                "launch_ms": per, "bound_ms": [b["bound_ms"] for b in bounds_], "bound": bounds_[0],
                "lanes": [sh_.capacity for sh_ in shards], "chain_launches": counts["shard"],
                "device_us_per_frame_summed": sum(per) * 1e3 / 8,
                "unsharded_device_us_per_frame": whole_u8_ms * 1e3 / 8}
        # the row's plain version: 8 plain frames of S = 4's first shard
        sh4 = shard_cfg.split(whole, 4)
        a4 = shard_cfg.shard_args(c.static, sh4)[0]
        res["plain_8_frames_shard_ms"] = device_ms("sharded_1M plain shard", lambda: plain_frames(
            c.static, c.params, sh4[0], frame, 8, stats=False, shard=a4), 1, False,
            res["by_shards"][4]["bound_ms"][0])
        # destroy_claim's emitter on the dead-rank claim at 1310720 lanes
        cd_, tab_, fr_ = shard_cfg.config("destroy", dev, rate=5e5)
        w = bt.init_pool_for(cd_, cap)
        shards = shard_cfg.split(w, 4)
        fs.fused_step(cd_.static, cd_.params, tab_, w, fr_)  # the tables reach the card before the checked frames
        for i in range(30):
            w, o = fs.fused_step(cd_.static, cd_.params, tab_, w, fr_)
            torch.cuda.set_sync_debug_mode("error")  # no shard's dead offset reaches the host
            try:
                shards, outs, _p = shard_cfg.step_shards(cd_, tab_, shards, fr_)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            bad = shard_cfg.pool_mismatch(shard_cfg.stitch(shards), w)
            check(bad == [], f"sharded_1M destroy frame {i}: {bad}")
            check(shard_cfg.outputs_mismatch(o, shard_cfg.reduce_outputs(outs)) == [], f"sharded_1M destroy {i}")
        res["destroy_live"] = int(o.alive_count)
        res["destroy_dead_lanes"] = int((~w.alive).sum())
        check(0 < res["destroy_live"] < cap, f"sharded_1M destroy: {res['destroy_live']} live")
        res["destroy_claim"] = claim_timing("sharded_1M destroy", cd_, tab_, w, fr_)

        def shard_frame():  # the shards' dead offsets on the device, then the four launches
            for sh_, a in zip(shards, shard_cfg.shard_args(cd_.static, shards)):
                fs.fused_step(cd_.static, cd_.params, tab_, sh_, fr_, stats=False, shard=a)

        n_act = len(active_f32_fields(cd_.static))
        res["destroy_frame_s4_bound"] = bound((2 * 4 * n_act + 2) * cap, INTEGRATE_OPS * int(w.alive.sum()))
        res["destroy_frame_s4_device_ms"] = device_ms("sharded_1M destroy frame S=4", shard_frame, 20, False,
                                                      res["destroy_frame_s4_bound"]["bound_ms"])
        res["destroy_frame_s4_wall_ms"] = event_ms(shard_frame, 20)
        return res, counts_all

    t_cell = time.perf_counter()
    s1m, s1m_counts_all = sharded_1m()
    emit({"phase": "sharded_1M", "card": card, "capacity": 160 * 8192, "rate": 1e6, **s1m,
          "launches": {str(k): v["shard"] for k, v in s1m_counts_all.items()}, "seconds": time.perf_counter() - t_cell,
          "rule": "the 140-frame chain's shards (U = 8 launches) stitched == the unsharded chain bit for bit, the "
                  "stats reduced == its stats; launch_ms: device time of each shard's U = 8 launch (torch.profiler, "
                  "20 launches), each held to its bytes bound; destroy: 30 frames, S = 4, bit for bit, the shards "
                  "stepped under sync debug mode 'error' (dead offsets device tensors); destroy_frame_s4: every "
                  "kernel of one S = 4 frame (offsets and four launches, stats off) per call, and its CUDA-event "
                  "wall time"})

    # ------------------------------------------------ 37. dist_gloo
    def dist_gloo():
        """tests/torch_distributed_worker.py on 4 processes sharing the card,
        gloo, spawned once: sp (main_1M's cell, 140 frames), dp
        (fleet_16x55k, 4 slots per rank), 2d (2 x 2, 2 slots of
        main_100k's config) and sp_nested (nested_60k's cell, fireworks and
        fireworks_floor at 131072 lanes, 150 and 100 frames, through the
        sharded XLA-layout step), each == its unsharded counterpart bit for
        bit."""
        import socket

        with socket.socket() as so:
            so.bind(("127.0.0.1", 0))
            port = so.getsockname()[1]
        worker = Path(__file__).resolve().parent / "tests" / "torch_distributed_worker.py"
        procs = [subprocess.Popen([sys.executable, str(worker), "--rank", str(r), "--world", "4", "--init",
                                   f"tcp://127.0.0.1:{port}", "--device", "cuda", "--size", "card", "--cases",
                                   "sp,dp,2d,sp_nested"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(4)]
        outs, deadline = [], time.time() + 420
        try:
            for r, p in enumerate(procs):
                try:
                    o, e = p.communicate(timeout=max(1.0, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    raise CheckFailed(f"dist_gloo: rank {r} timed out")
                check(p.returncode == 0, f"dist_gloo: rank {r} exited {p.returncode}: {e[-3000:]}")
                outs.append(json.loads(o.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return outs

    t_cell = time.perf_counter()
    gloo = dist_gloo()
    emit({"phase": "dist_gloo", "card": card, "ranks": gloo, "seconds": time.perf_counter() - t_cell,
          "rule": "4 ranks on the one card (NCCL refuses two ranks on one card; a multi-card run is not verified), "
                  "each rank's share == the same lanes / slots of the unsharded chain run in its process, bit for "
                  "bit, outputs included; ms_per_frame: a second chain by host clock; collective_us_per_launch: "
                  "host time in the chain's gathers (the epilogue's reduction) per launch, the wait for the other "
                  "ranks included"})
    for name in ("nested_60k", "fireworks", "fireworks_floor"):
        runs = [r["sp_nested"][name] for r in gloo]
        check(all(r["live"] == runs[0]["live"] > 0 for r in runs) and min(runs[0]["live_per_type"]) > 0,
              f"dist_gloo sp_nested {name}: live counts {[r['live_per_type'] for r in runs]}")
    # the ring's window walks over the ranks' lanes (on the dead-rank claim
    # rockets and children take the first dead lanes, in rank 0's shard)
    check(sum(r["sp_nested"]["nested_60k"]["crossed"] for r in gloo) > 0,
          "dist_gloo sp_nested nested_60k: no child landed on a rank other than its parent's")
    emit({"phase": "dist_gloo_sp_nested", "card": card, "ranks": 4,
          **{name: {"capacity": gloo[0]["sp_nested"][name]["capacity"], "live": gloo[0]["sp_nested"][name]["live"],
                    "live_per_type": gloo[0]["sp_nested"][name]["live_per_type"],
                    "unsharded_ms_per_frame": gloo[0]["sp_nested"][name]["unsharded_ms_per_frame"],
                    "ms_per_frame": [r["sp_nested"][name]["ms_per_frame"] for r in gloo],
                    "gathers_per_frame": gloo[0]["sp_nested"][name]["gathers_per_frame"],
                    "gather_us_per_frame": [r["sp_nested"][name]["gather_us_per_frame"] for r in gloo],
                    "checked_ms_per_frame": [r["sp_nested"][name]["checked_ms_per_frame"] for r in gloo],
                    "crossed": [r["sp_nested"][name]["crossed"] for r in gloo],
                    "max_deferred": gloo[0]["sp_nested"][name]["max_deferred"],
                    "max_dropped": gloo[0]["sp_nested"][name]["max_dropped"]}
             for name in ("nested_60k", "fireworks", "fireworks_floor")},
          "rule": "make_sharded_step on nested archetypes (the sharded XLA-layout step, composed torch, no kernel) "
                  "on 4 gloo ranks sharing the card: every frame of each rank's share == the same lanes of the "
                  "unsharded xla_step.step on the card, bit for bit, outputs and nested counts included "
                  "(checked_ms_per_frame: those frames' sharded step by host clock); ms_per_frame: a 30-frame "
                  "sharded chain from the checked state, host clock, per rank; unsharded_ms_per_frame: the "
                  "unsharded xla_step.multi_step of 30 frames on rank 0 while the others wait; gathers: "
                  "step.group_gather calls per frame and their host µs (the wait for the other ranks included); "
                  "crossed: children each rank wrote whose parent lay on another rank"})

    # ------------------------------------------------ 38. xla_step
    from bevy_firework_tpu_torch import viewer as bview

    t_cell = time.perf_counter()
    xla_exact = ("alive", "ptype", "ring_cursor", "time_in_cycle", "last_emission", "enabled", "manual_queued",
                 "last_emitted", "finished_notified", "rng_key")
    xla_outs = ("alive_count", "alive_count_per_type", "finished_event", "nested_deferred", "nested_dropped")
    xla_tol = 1e-5  # CUDA's sinf/cosf and the CPU's part by a few ulp (the shape and cone draws)
    xla_res = {}
    for name, n_x, frames_x in (("stress_test", 131072, 30), ("sparks", 131072, 30), ("fireworks", 16384, 120)):
        sp_x, tf_x = getattr(effects, name)()
        cx, cx_cpu = bt.compile_spawner(sp_x, device=dev), bt.compile_spawner(sp_x, device="cpu")
        fx = bt.make_frame_input(1 / 60, translation=tf_x.translation)
        t_x = time.perf_counter()
        (st_x, out_x), xla_counts = counted(lambda: bt.multi_step(cx.static, cx.params, None,
                                                                   bt.init_pool_for(cx, n_x, 1), fx, frames_x))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t_x
        check(st_x.px.is_cuda and sum(xla_counts.values()) == 0,
              f"xla_step {name}: the XLA layout launched kernels {xla_counts}")
        t_x = time.perf_counter()
        st_c, out_c = bt.multi_step(cx_cpu.static, cx_cpu.params, None, bt.init_pool_for(cx_cpu, n_x, 1), fx,
                                    frames_x)
        cpu_s = time.perf_counter() - t_x
        for k in xla_exact:
            check(torch.equal(getattr(st_x, k).cpu(), getattr(st_c, k)), f"xla_step {name}: {k} card != CPU")
        for k in xla_outs:
            check(torch.equal(getattr(out_x, k).cpu(), getattr(out_c, k)), f"xla_step {name}: output {k}")
        live_x = st_c.alive
        err_x = max(float((getattr(st_x, k).cpu() - getattr(st_c, k))[live_x].abs().max()) if bool(live_x.any())
                    else 0.0 for k in active_f32_fields(cx_cpu.static))
        check(err_x <= xla_tol, f"xla_step {name}: f32 fields {err_x} from the CPU's")
        check(int(out_x.alive_count) > (50000 if name == "stress_test" else 100),
              f"xla_step {name}: {out_x.alive_count_per_type.tolist()} live")
        if name == "fireworks":
            check(int(out_x.alive_count_per_type[1]) > 0, f"xla_step fireworks: no children {out_x}")
        xla_res[name] = {"n": n_x, "frames": frames_x, "per_type": out_x.alive_count_per_type.tolist(),
                         "max_abs_err": err_x, "card_s": card_s, "cpu_s": cpu_s, "cpu_threads": torch.get_num_threads()}

    def chain_ms(fn, reps=5):
        """Median of `reps` CUDA-event times of fn() (after one warm call), ms."""
        fn()
        times = []
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        return float(np.median(times))

    cx = bt.compile_spawner(effects.stress_test()[0], device=dev)
    fx = bt.make_frame_input(1 / 60, translation=effects.stress_test()[1].translation)
    sx0, _o = fs.multi_step_auto(cx.static, cx.params, None, bt.init_pool_for(cx, 131072, 1), fx, 60)
    xla_ms = chain_ms(lambda: bt.multi_step(cx.static, cx.params, None, sx0, fx, 8)) / 8
    auto_ms = chain_ms(lambda: fs.multi_step_auto(cx.static, cx.params, None, sx0, fx, 8)) / 8
    emit({"phase": "xla_step_timing", "card": card, "n": 131072, "live": int(sx0.alive.sum()),
          "multi_step_ms_per_frame": xla_ms, "multi_step_auto_ms_per_frame": auto_ms, "ratio": xla_ms / auto_ms,
          "timing": "CUDA events around an 8-frame call from the same 60-frame state, median of 5, per frame"})
    emit({"phase": "xla_step", "card": card, "configs": xla_res, "f32_tol": xla_tol,
          "seconds": time.perf_counter() - t_cell,
          "rule": "multi_step (the XLA layout, composed torch, no kernel) on the card == the same call on the CPU: "
                  "integer and bool state, rng_key and the outputs' counts exact; f32 fields within 1e-5 (libm)"})

    # ------------------------------------------------ 39. viewer_flow
    t_cell = time.perf_counter()

    def viewer_scene(device):
        sc = bt.Scene(device=device)
        sc.add_spawner(effects.sparks()[0], capacity=2048, transform=bt.Transform(translation=(0.0, 0.1, 0.0)))
        sc.add_spawner(comets, capacity=256, trail=ts16, transform=bt.Transform(translation=(-2.0, 0.5, -1.0)))
        for _ in range(90):
            sc.step(1 / 60)
        return sc

    view_lights = bt.LightTable(lights=(
        bt.Light.directional((-0.3, -1.0, -0.2), color=(1.0, 0.95, 0.9), illuminance=2.0, shadow=True),
        bt.Light.point((1.5, 2.5, 1.0), color=(0.3, 0.5, 1.0), intensity=40.0, range=8.0, shadow=True),
    ), ambient=(0.05, 0.05, 0.06), environment=bt.EnvironmentLight.gradient())
    view_kw = dict(fog=bt.FogSettings(mode=1, start=4.0, end=20.0, color=(0.5, 0.55, 0.6, 0.8)), lights=view_lights,
                   shadow_atlas=bt.make_shadow_atlas(view_lights, occluders=[((-0.5, 1.2, -0.5), (0.5, 1.4, 0.5))],
                                                     resolution=64, radius=6.0),
                   ground_y=0.0, draw_ground=True, shadows=True)
    view_cam = bview.Camera(position=(0.0, 2.5, 7.0), look_at=(0.0, 1.2, 0.0))
    view_card, viewer_counts = counted(lambda: viewer_scene(dev))
    check(viewer_counts["fused_step"] >= 90, f"viewer_flow: launches {viewer_counts}")
    view_cpu = viewer_scene("cpu")
    imgs, view_n = [], []
    for sc in (view_card, view_cpu):
        items, trails = sc.render_items(), sc.trail_items()
        view_n.append((sum(i.count for i in items), sum(t.count for t in trails)))
        imgs.append(bview.render_frame(items, view_cam, 320, 240, trail_items=trails, **view_kw))
    pix_err = float(np.abs(imgs[0] - imgs[1]).max())
    check(view_n[0] == view_n[1] and view_n[0][0] > 500 and view_n[0][1] > 0,
          f"viewer_flow: (instances, segments) {view_n[0]} on the card, {view_n[1]} on the CPU")
    check(pix_err <= 1e-3 and float(imgs[0].std()) > 0.01, f"viewer_flow: pixels {pix_err} from the CPU's")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_viewer_", dir=Path(__file__).resolve().parent) as vdir:
        png = Path(bview.render_scene_png(view_card, str(Path(vdir) / "viewer_flow.png"), view_cam, 320, 240,
                                          **view_kw))
        png_bytes = png.read_bytes()
    check(png_bytes[:8] == b"\x89PNG\r\n\x1a\n", "viewer_flow: not a PNG")
    emit({"phase": "viewer_flow", "card": card, "launches": viewer_counts, "instances": view_n[0][0],
          "segments": view_n[0][1], "max_pixel_err": pix_err, "png_bytes": len(png_bytes),
          "seconds": time.perf_counter() - t_cell,
          "rule": "a card Scene (sparks, a trailed comet) through viewer.render_frame with fog, lights and a shadow "
                  "atlas == the same Scene stepped on the CPU: counts exact, pixels within 1e-3"})

    # ------------------------------------------------ 40. examples
    import torch_examples_run as ex_run

    t_cell = time.perf_counter()
    ex_counts = {}

    def counted_example(fn):
        result, cnt = counted(fn)
        for k, v in cnt.items():
            ex_counts[k] = ex_counts.get(k, 0) + v
        return result, cnt

    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_", dir=Path(__file__).resolve().parent) as exdir:
        ex_res = ex_run.run_on_card(exdir, counted_example, check)
        ex_prof = ex_run.card_profile(Path(exdir) / "trace", check)
    emit({"phase": "examples", "card": card, "scripts": ex_res, "profiling": ex_prof, "launches": ex_counts,
          "seconds": time.perf_counter() - t_cell,
          "cuts": "none: every script at its JAX counterpart's default frames (multichip: 4 gloo ranks on the card, "
                  "90 / 60 / 120 frames for sp and dp / 2d / nested sp)",
          "rule": "examples_torch/*.py on the card through runpy, each under its deadline, held to what its JAX "
                  "counterpart prints or asserts (tests/torch_examples_run.card_checks) and to the kernels it must "
                  "launch; utils.profiling's trace holds the step kernel's launches and the annotate spans"})

    # ------------------------------------------------ 41. graphs
    # The captured chains (ops.chain_graph): bench.py's chain cells through
    # their entry points, captured == uncaptured bit for bit on the first
    # call, replays and a changed dt (tests/torch_chain_configs.py); every
    # launch family the chains use by value == with device words; capture
    # time, ms/frame captured and uncaptured in turns (CUDA events), the
    # device time of a replay call against the bare graph's (the
    # difference: the copy-in and clone-out), and the fold's A/B captured.
    import torch_chain_configs as chain_cfg
    from bevy_firework_tpu_torch.profile_step import traced_kernels

    t_cell = time.perf_counter()

    def words_match(label, case, state, kind, n, call):
        """call() with its frame rows, seeds and keys by value == the same
        launches reading them as device words, every result leaf bit for
        bit."""
        ref = call(state)
        words = fs.DeviceWords.upload(chain_graph.chain_words(kind, case.static, case.colliders, state, case.frame,
                                                              n)[0], dev)
        with fs.device_words(words):
            got = call(state)
        chain_cfg.assert_results_equal(got, ref, f"device words {label}")
        return label

    def call_ms(fn, calls):
        """CUDA-event wall time of each of `calls` calls of fn (one warm call
        first); the median (host-bound calls measure the host)."""
        fn()
        torch.cuda.synchronize()
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(calls + 1)]
        evs[0].record()
        for e in evs[1:]:
            fn()
            e.record()
        evs[-1].synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in zip(evs, evs[1:]))

    def graph_timing(case, st) -> dict:
        """ms/frame uncaptured, captured, captured, uncaptured (per turn the
        median of 7 calls' CUDA-event wall) and the device time of a replay
        call against the bare graph's replays (torch.profiler)."""
        def run(captured):
            return lambda: chain_cfg._step_chain(case, st, case.frame, captured)

        t = [call_ms(run(c), 7) for c in (False, True, True, False)]
        row = {"uncaptured_ms_per_frame": (t[0] + t[3]) / 2 / case.n,
               "captured_ms_per_frame": (t[1] + t[2]) / 2 / case.n, "turns_ms": t}
        row["uncaptured_over_captured"] = row["uncaptured_ms_per_frame"] / row["captured_ms_per_frame"]
        g = chain_graph.graph_of(case.kind, case.static, case.params, case.colliders, st, case.frame, case.n)
        call_us = traced_kernels(run(True), 5, 3)["us_per_call"]
        bare_us = traced_kernels(g.graph.replay, 5, 3)["us_per_call"]
        row.update(replay_call_device_us=call_us, graph_device_us=bare_us, copies_device_us=call_us - bare_us,
                   graph_launches=sum(g.launches.get(k, 0)
                                      for k in ("fused_step.launches", "fused_step_fleet.launches")),
                   copy_in_leaves=g.copy_in_leaves, clone_out_leaves=g.clone_out_leaves)
        return row

    def graphs_run():
        cells, families = {}, []
        for name in ("main", "main_1M", "collision", "fields", "destroy", "nested_folded", "nested_unfolded",
                     "nested_chained", "nested_packed", "fleet", "fleet_destroy", "nested_fleet"):
            case = chain_cfg.build(name, dev, "card")
            cap0 = chain_graph.COUNTS["capture_s"]
            t0 = time.perf_counter()
            r = chain_cfg.check_captured(case)
            cells[name] = {"label": chain_cfg.CASES[name], "frames": case.n, "live": r["live"], "leaves": r["leaves"],
                           "capture_s": chain_graph.COUNTS["capture_s"] - cap0, "check_s": time.perf_counter() - t0}
            st = r["state"]
            stc, fc, col = case.static, case.frame, case.colliders
            # the launch families of this chain, by value == device words
            if name == "main":
                families.append(words_match("solo U=8 (warp cadence)", case, st, "auto", 8, lambda s: fs.fused_step(
                    stc, case.params, None, s, fc, unroll=8)))
                families.append(words_match("solo U=1 render pack", case, st, "auto_packed", 1, lambda s: fs.fused_step(
                    stc, case.params, None, s, fc, pack_render=True)))
            elif name == "collision":
                families.append(words_match("narrow phase U=2", case, st, "auto", 2, lambda s: fs.fused_step(
                    stc, case.params, col, s, fc, unroll=2)))
            elif name == "fields":
                families.append(words_match("field block U=8", case, st, "auto", 8, lambda s: fs.fused_step(
                    stc, case.params, None, s, fc, unroll=8)))
            elif name == "destroy":
                families.append(words_match("dead-rank claim U=1", case, st, "auto", 1, lambda s: fs.fused_step(
                    stc, case.params, col, s, fc)))
            elif name == "fleet":
                families.append(words_match("fleet U=8", case, st, "fleet", 8, lambda s: fs.fused_step_fleet(
                    stc, case.params, None, s, fc, unroll=8)))
            elif name == "fleet_destroy":
                families.append(words_match("fleet dead-rank U=1 with the dump plane", case, st, "fleet", 1,
                                            lambda s: fs.fused_step_fleet(stc, case.params, col, s, fc)))
            elif name in ("nested_folded", "nested_chained"):
                families.append(words_match(f"{name}: hybrid frame (cooperative stage, lean merge)", case, st,
                                            "auto", 1, lambda s: fs.fused_step(stc, case.params, None, s, fc)))

                def folded(s):
                    carry = fs._seed_nested_carry(stc, case.params, s)
                    return fs.fused_step_hybrid(stc, case.params, None, s, fc, nested_carry=carry, fold_out=True)

                families.append(words_match(f"{name}: folded hybrid frame (stage on carried counts, fold epilogue)",
                                            case, st, "auto", 1, folded))
            cells[name]["timing"] = (case, st)
            chain_graph.clear()
        nd = chain_cfg.build("nested_dead_rank", dev, "card")
        ndr = chain_cfg.check_captured(nd)
        families.append(words_match("dead-rank hybrid frame (wide merge, colliders)", nd, ndr["state"], "auto", 1,
                                    lambda s: fs.fused_step(nd.static, nd.params, nd.colliders, s, nd.frame)))
        chain_graph.clear()
        return cells, families

    (graph_cells, graph_families), graph_counts = counted(graphs_run)
    check(graph_counts["chain_replays"] > 0 and graph_counts["chain_captures"] > 0, f"graphs: {graph_counts}")
    for row in graph_cells.values():  # timed apart from the counted checks
        row.update(graph_timing(*row.pop("timing")))
        chain_graph.clear()
    ab_fold_captured = ab_nested_fold(captured=True)
    emit({"phase": "graphs", "card": card, "cells": graph_cells, "device_word_families": graph_families,
          "ab_nested_fold_captured": ab_fold_captured, "launches": graph_counts,
          "seconds": time.perf_counter() - t_cell,
          "rule": "per cell (card sizes of tests/torch_chain_configs.py): the captured chain == the uncaptured chain "
                  "bit for bit (every pool leaf, the key, outputs, render planes; the first call, a replay, a replay "
                  "with another dt and transform, a replay from the first state again; earlier results kept; the "
                  "input unwritten; the carried claim), calls under sync debug mode 'error'; every launch family by "
                  "value == with device words; *_ms_per_frame: CUDA-event wall per frame of one chain call, "
                  "uncaptured, captured, captured, uncaptured (the median of 7 calls each); replay_call_device_us: "
                  "device time of "
                  "a replay call (torch.profiler), graph_device_us: the bare graph's, copies_device_us: their "
                  "difference (the host words, the copy-in and the clone-out)"})

    # ------------------------------------------------ 42. scene_graphs
    # The Scene's one-dispatch step (Scene._dispatch, chain_graph.
    # replay_segments): each cell of tests/torch_scene_configs.py at the
    # card size through a captured and an uncaptured Scene, bit for bit;
    # ms per Scene.step captured against uncaptured in interleaved windows;
    # bench.py's churn_storm; the host split of a steady step; the copies'
    # device time; the padding rows' cost in the fleet launch.
    import torch_scene_configs as scene_cfg
    from bevy_firework_tpu_torch import scene as scene_mod

    t_cell = time.perf_counter()

    # the counts of the captured Scene's steps alone (run_pair's
    # `launches`: each a.scene.step between two readings; its uncaptured
    # twin's launches are not the main path's)
    sg_cells = {}
    for name in scene_cfg.CELLS:
        cap0, n0 = chain_graph.COUNTS["capture_s"], chain_graph.COUNTS["captures"]
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        r = scene_cfg.run_pair(name, dev, "card")
        r.update(capture_s=chain_graph.COUNTS["capture_s"] - cap0, check_s=time.perf_counter() - t0)
        r["capture_ms_per_signature"] = r["capture_s"] * 1e3 / max(chain_graph.COUNTS["captures"] - n0, 1)
        check(r["uncaptured_launches_in_replay_steps"] == 0 and r["replay_steps"] > 0,
              f"scene_graphs {name}: {r}")
        sg_cells[name] = r
        chain_graph.clear()
    sg_counts = {k: sum(c["launches"].get(f"{obj.__name__}.{attr}", 0) for c in sg_cells.values())
                 for k, (obj, attr) in counters.items()}
    sg_counts.update(chain_captures=sum(c["captures"] for c in sg_cells.values()),
                     chain_replays=sum(c["replays"] for c in sg_cells.values()))
    sg_replayed = {}
    for c in sg_cells.values():
        for k, v in c["replayed"].items():
            sg_replayed[k] = sg_replayed.get(k, 0) + v
    check(all(f < scene_cfg.CHURN_FROM for f in sg_cells["group_churn_12"]["capture_frames"]),
          f"scene_graphs: churn captured {sg_cells['group_churn_12']['capture_frames']}")
    check(all(sg_cells[k]["padding_rows_checked"] > 0 for k in ("scene_batch_12", "scene_hetero_100",
                                                               "group_churn_12")), "scene_graphs: no padding row")
    hpg = sg_cells["scene_hetero_100_per_group"]
    check(hpg["per_group_mode"] and hpg["captures"] == 8 and hpg["replay_steps"] == hpg["frames"] - 8
          and hpg["replays"] == 4 * hpg["replay_steps"] + 2 * (1 + 2 + 3), "scene_graphs: per-group replays")
    check(sg_replayed.get("fused_step_fleet.launches", 0) > 0 and sg_replayed.get("fused_step.launches", 0) > 0
          and sg_counts["fleet"] > 0 and sg_counts["fused_step"] > 0, f"scene_graphs: replayed {sg_replayed}")

    def timed_pair(name, churn=True):
        """ms per Scene.step captured and uncaptured (scene_cfg.time_steps:
        3 interleaved 40-step windows, U C, C U, U C)."""
        row, scenes = scene_cfg.time_steps(name, dev, {"uncaptured": {"_captured": False}, "captured": {}},
                                           churn=churn)
        row["uncaptured_over_captured"] = row["uncaptured"] / row["captured"]
        return row, scenes["captured"]

    sg_ms = {}
    for name in ("sparks", "events", "tornado", "scene_batch_12", "scene_hetero_100", "scene_hetero_100_per_group"):
        sg_ms[name], keep = timed_pair(name)
        if name == "scene_batch_12":
            batch12 = keep
        elif name == "scene_hetero_100":
            hetero100 = keep
        chain_graph.clear()
    sg_ms["group_churn_12_churn"], _ = timed_pair("group_churn_12")
    sg_ms["group_churn_12_steady"], _ = timed_pair("group_churn_12", churn=False)
    chain_graph.clear()
    # does the padding pay on this card: group_churn_12 captured, padded (16
    # rows) against unpadded (12 in member order), churn and steady
    pad_ab = {}
    for churn in (True, False):
        pad_ab["churn" if churn else "steady"], _ = scene_cfg.time_steps(
            "group_churn_12", dev, {"unpadded": {"_padded": False}, "padded": {}}, churn=churn)
        chain_graph.clear()

    # the host split of one steady step (render pack on): each part's host
    # µs per step by wrapping it
    def host_split(sc, steps=60):
        parts = {"group_inputs": 0.0, "signature": 0.0, "words": 0.0, "copy_in": 0.0, "replay": 0.0,
                 "clone_out": 0.0, "finish_and_events": 0.0}
        saved = []

        def wrap(owner, attr, label):
            orig = getattr(owner, attr)
            saved.append((owner, attr, orig))

            def timed(*a, **k):
                t0 = time.perf_counter()
                try:
                    return orig(*a, **k)
                finally:
                    parts[label] += time.perf_counter() - t0
            setattr(owner, attr, timed)

        wrap(sc, "_plans", "group_inputs")
        wrap(sc, "_signature", "signature")
        wrap(chain_graph, "segment_words", "words")
        wrap(chain_graph, "_copy_all", "copy_in")
        wrap(chain_graph, "_clone_out", "clone_out")
        wrap(torch.cuda.CUDAGraph, "replay", "replay")
        wrap(sc, "_finish_group", "finish_and_events")
        wrap(sc, "_finish_solo", "finish_and_events")
        try:
            for _ in range(5):
                sc.step(scene_cfg.DT)
            for k in parts:
                parts[k] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                sc.step(scene_cfg.DT)
            total = time.perf_counter() - t0
            torch.cuda.synchronize()
        finally:
            for owner, attr, orig in reversed(saved):
                if owner is sc:
                    delattr(sc, attr)
                else:
                    setattr(owner, attr, orig)
        us = {k: v / steps * 1e6 for k, v in parts.items()}
        us["step_total"] = total / steps * 1e6
        us["bookkeeping_rest"] = us["step_total"] - sum(v for k, v in us.items() if k != "step_total")
        return us

    split = {"scene_hetero_100": host_split(hetero100), "scene_batch_12": host_split(batch12)}

    def host_us(fn, calls=30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    def clone_ab(sc):
        """The clone-out of the scene's graph: a clone per output tensor
        against `_clone_out` (one `_foreach_copy_` per dtype and
        contiguity), host µs per call up to a synchronize, in turns (T G G
        T); and a bare replay's enqueue, host µs per call (50 calls, no
        synchronize between them)."""
        g = chain_graph._GRAPHS[sc._signature(sc._plans(scene_cfg.DT, 1), 1)]

        def per_tensor():
            return [t.clone() for t in g.outs]

        def grouped():
            return chain_graph._clone_out(g.outs, g.clone_plan)

        t = [host_us(f) for f in (per_tensor, grouped, grouped, per_tensor)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            g.graph.replay()
        enqueue = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize()
        return {"outputs": len(g.outs), "per_tensor_us": (t[0] + t[3]) / 2, "grouped_us": (t[1] + t[2]) / 2,
                "turns_us": t, "replay_enqueue_us": enqueue}

    clone_us = {"scene_hetero_100": clone_ab(hetero100), "scene_batch_12": clone_ab(batch12)}
    del hetero100
    # device time of a step against its graph's bare replay: the copy-in and
    # clone-out (the words' one copy included)
    sig12 = batch12._signature(batch12._plans(scene_cfg.DT, 1), 1)
    g12 = chain_graph._GRAPHS[sig12]
    step_us = traced_kernels(lambda: batch12.step(scene_cfg.DT), 5, 3)["us_per_call"]
    bare_us = traced_kernels(g12.graph.replay, 5, 3)["us_per_call"]
    # the padding rows' cost: the packed fleet launch at scene_batch_12 with
    # its 16 rows against the same members stacked in 12
    b12 = next(iter(batch12._batches.values()))
    st16 = b12.states
    st12 = scene_mod.take_insert(st16, list(b12.rows), [], None)
    members12 = [batch12._spawners[s] for s in b12.sids]
    f16 = batch12._group_inputs[(members12[0].compiled.static, members12[0].capacity)]["frames"][1]
    f12 = scene_mod.stack_frames([batch12._frame_for(m, scene_cfg.DT) for m in members12])
    c12 = members12[0].compiled
    pad_us = {}
    for rows_n, st_, fr_ in ((12, st12, f12), (16, st16, f16), (12, st12, f12), (16, st16, f16)):
        ms_ = device_ms(f"fleet launch {rows_n} rows", lambda: fs.fused_step_fleet(
            c12.static, c12.params, None, st_, fr_, pack_render=True), 20, True, 0.0)
        pad_us.setdefault(rows_n, []).append(ms_ * 1e3)
    chain_graph.clear()
    garbage = scene_cfg.cyclic_garbage()  # what the phase's timed cells left, freed before the storm
    storm = scene_cfg.churn_storm(dev)
    chain_graph.clear()
    storm_unc = scene_cfg.churn_storm(dev, _captured=False)
    chain_graph.clear()
    storm_unpadded = scene_cfg.churn_storm(dev, _padded=False)
    chain_graph.clear()
    check(storm["captures"] > 0 and storm_unc["captures"] == 0, f"churn_storm: {storm['captures']} captures")
    emit({"phase": "scene_graphs", "card": card, "cells": sg_cells, "launches": sg_counts, "replayed": sg_replayed,
          "ms_per_scene_step": sg_ms, "padded_against_unpadded_group_churn_12": pad_ab,
          "host_us_steady_step": split, "clone_out_and_replay_enqueue": clone_us,
          "batch_12_step_device_us": step_us, "batch_12_graph_device_us": bare_us,
          "batch_12_copies_device_us": step_us - bare_us, "fleet_launch_us_by_rows": pad_us,
          "churn_storm": {k: v for k, v in storm.items() if k != "walls_ms"},
          "churn_storm_walls_ms": storm["walls_ms"],
          "churn_storm_uncaptured": {k: v for k, v in storm_unc.items() if k != "walls_ms"},
          "churn_storm_unpadded": {k: v for k, v in storm_unpadded.items() if k != "walls_ms"},
          "garbage_before_storm": garbage,
          "seconds": time.perf_counter() - t_cell,
          "rule": "per cell (tests/torch_scene_configs.py, card size): the captured Scene == the uncaptured one bit "
                  "for bit (every pool leaf, outputs, render planes, trails at 4 checkpoints; records and finished "
                  "events every step; render rows at the end), each signature's first step uncaptured, then one "
                  "replay per step (per group in per-group mode; the first after a capture), no launch one by one "
                  "in a step that replays, no capture on group_churn_12's churn, padding rows dead and nobody's; "
                  "launches: the captured scene's steps alone, replayed: those in replays; memory: after the "
                  "cell with both scenes and its graphs held (graph_bytes: the graphs' static inputs and "
                  "outputs), peak since the cell began; ms_per_scene_step: host clock over 40 steps between "
                  "synchronizes, median of 3 interleaved windows (U C, C U, U C) after the cell's script; "
                  "host_us: each part's host µs per steady step (wrapped), bookkeeping_rest the step's rest; "
                  "clone_out_and_replay_enqueue: the graph's clone-out per tensor against grouped (host µs per "
                  "call to a synchronize, T G G T) and a bare replay's enqueue (host µs per call); "
                  "copies_device_us: a step's device time (torch.profiler) less its graph's bare replay; "
                  "fleet_launch_us_by_rows: the packed fleet launch's step kernel at scene_batch_12's state, 12 "
                  "rows (its members) against 16 (the padded stack), in turns; padded_against_unpadded: "
                  "group_churn_12 captured with Scene._padded on and off, timed as ms_per_scene_step; "
                  "churn_storm: bench.py's _measure_churn_storm (60 frames, capacity 8192, 6 archetypes, 12 "
                  "live), enqueue wall per frame, captured, uncaptured and unpadded, its memory after the "
                  "storm with the graphs held, its worst frame's collector ms; garbage_before_storm: the cyclic "
                  "garbage the timed cells left (objects, types, ms to free), collected before the storm"})

    # counts from the main-path runs alone (every run listed in the
    # docstring's last paragraph)
    runs = (r100k_counts, r1m_counts, s_counts, d_counts, c1m_counts, h8_counts, f_counts, scaling_counts, f1m_counts,
            scene_counts, async_ev_counts, trails_counts, t100k_counts, ck_counts, n60k_counts, nch_counts, flows_counts, fleet_counts, flow_counts, group_counts, loop_counts,
            loop1m_counts, async_counts, *s1m_counts_all.values(), viewer_counts, ex_counts, graph_counts, sg_counts)

    def total(keys):
        keys = (keys,) if isinstance(keys, str) else keys
        return sum(r.get(k, 0) for r in runs for k in keys)

    csrc = "bevy_firework_tpu_torch/ops/csrc/"

    def occupancy(pick, warp=False, merge=False):
        """Registers, stack frame, spill stores and blocks per SM of the
        step kernel's instantiations whose template arguments (ring,
        collide, fields, stats, merge, fleet) `pick` takes, with `warp`
        the warp-cadence ones and with `merge` fused_step_kernel_merge's,
        from the card line's report."""
        rows = [r for r in step_rows if pick(*r["args"])] + (warp_rows if warp else []) + (
            merge_rows if merge else [])
        return {r["kernel"][len("fused_step_kernel"):]: {k: r[k] for k in ("registers", "stack", "spill_stores",
                                                                            "blocks_per_sm")}
                for r in rows}

    def entry(name, replaces, key, ms, plain_ms, b, source="fused_step_kernel.cuh", **extra):
        return {"name": name, "route": "cuda", "source": csrc + source, "replaces": replaces, "launches": total(key),
                "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None, **extra}

    # plain versions of the nested kernels at nested_60k's shapes, timed on
    # the card: the nested stage (rows 8 and 9b) and the seed's counts
    c60 = bt.compile_spawner(bench_nested(False), nested_buffer=1024, device=dev)
    s60, _o = fs.multi_step_auto(c60.static, c60.params, None, bt.init_pool_for(c60, 16 * 8192), fdet, 150)
    life60 = torch.full((), 2.0, dtype=torch.float32, device=dev)
    par60 = {k: getattr(s60, k) for k in fs.nested_parent_fields(c60.static)}
    plain_stage_ms = device_ms("nested plain stage", lambda: plain_stage(
        c60.static, c60.params, fdet, 1, s60.alive, s60.ptype, s60.age, life60, s60.last_emitted[1], s60.enabled[1],
        1024, par60, np.array([1, 2], np.uint32), s60.ring_cursor), 5, False, n60k["bounds"]["stage"]["bound_ms"])
    plain_seed_ms = device_ms("nested plain seed count", lambda: nested_fold_counts(c60.static, c60.params, s60, 1),
                              5, False, n60k["bounds"]["seed_count"]["bound_ms"])

    # every device time below was held to its bound where it was measured
    # the instantiations that run rows 1 and 2 (no narrow phase, field
    # block or merge)
    def main_path(ring, collide, fields, stats, merge, fleet):
        return not (collide or fields or merge)

    kernels = [
        entry("fused_step", "bevy_firework_tpu/ops/fused_step.py:913", "fused_step", r100k["u8_kernel_device_ms"],
              r100k["plain_8_frames_device_ms"], r100k["bounds"]["u8"],
              launch_wall_ms=r100k["u8_launch_wall_ms"], plain_wall_ms=r100k["plain_8_frames_wall_ms"],
              status="redesigned", occupancy=occupancy(main_path, warp=True)),
        entry("fused_step.pack_render", "bevy_firework_tpu/ops/fused_step.py:1523", ("render", "fleet_render"),
              r100k["render_kernel_device_ms"], r100k["plain_render_frame_device_ms"], r100k["bounds"]["render"],
              launch_wall_ms=r100k["render_launch_wall_ms"], plain_wall_ms=r100k["plain_render_frame_wall_ms"],
              u1_1M_ms=ext["u1_f32"]["ms"], u8_1M_ms=ext["u8_f32"]["ms"],
              status="redesign measured, not kept; block unchanged (a staged table, shared curve searches and a "
                     "ring of tiles measured slower: PERF.md §6); its U > 1 launches take row 1's warp cadence",
              occupancy=occupancy(main_path, warp=True)),
        entry("fused_step.pack_render_f16", "bevy_firework_tpu/ops/fused_step.py:1541",
              ("render_f16", "fleet_render_f16"), ext["u1_f16"]["ms"], ext["plain_u1_f16_ms"], {k: ext["u1_f16"][k] for k in ("bound_ms", "bound_by",
                                                                                           "bound_bytes", "bound_ops")},
              also_replaces="bevy_firework_tpu/ops/fused_step.py:1523-1561 (f16 mode; plane count _n_render_planes "
                            ":652, dtype :1989)",
              u8_ms=ext["u8_f16"]["ms"], u8_bound_ms=ext["u8_f16"]["bound_ms"], u1_no_pack_ms=ext["u1_none"]["ms"],
              u8_no_pack_ms=ext["u8_none"]["ms"], launch_wall_ms=ext["u1_f16_wall_ms"],
              plain_wall_ms=ext["plain_u1_f16_wall_ms"]),
        entry("fused_step.collide", "bevy_firework_tpu/ops/fused_step.py:349", ("collide", "fleet_collide"),
              c1m["u2_kernel_device_ms"],
              c1m["plain_2_frames_device_ms"], c1m["bounds"]["u2"],
              u8_ms=c1m["u8_kernel_device_ms"], plain_u8_ms=c1m["plain_8_frames_device_ms"],
              hull8_ms=h8["u2_kernel_device_ms"], hull8_plain_ms=h8["plain_2_frames_device_ms"],
              status="redesigned", occupancy=occupancy(lambda ring, collide, fields, stats, merge, fleet: collide)),
        entry("fused_step.collide_broad", "bevy_firework_tpu/ops/fused_step.py:452", ("broad", "fleet_broad"),
              h8["u2_kernel_device_ms"], h8["plain_2_frames_device_ms"], h8["bounds"]["u2"],
              also_replaces="bevy_firework_tpu/ops/fused_step.py:452-563 (the looped narrow phase and its broad "
                            "phase; _collider_perm :324 not carried over)",
              u8_ms=h8["u8_kernel_device_ms"], plain_u8_ms=h8["plain_8_frames_device_ms"],
              skip_share_hull8=h8["skip_share"],
              scaling_u2_ms={f"{r['colliders']}{'h' if r['hulls'] else ''}": r["u2_kernel_device_ms"]
                             for r in scaling},
              scaling_bound_ms={f"{r['colliders']}{'h' if r['hulls'] else ''}": r["bound"]["bound_ms"]
                                for r in scaling}),
        entry("fused_step.dead_rank_claim", "bevy_firework_tpu/ops/fused_step.py:173", "dead_claim",
              claim["carried_launch_ms"], claim["plain_dead_rank_device_ms"], claim["launch_bound"],
              library_ms=claim["cumsum_ms"], status="redesigned",
              also_replaces="bevy_firework_tpu/ops/fused_step.py:1142-1149, :1323-1333 (the SMEM dead_carry)",
              kernels=["fused_step_kernel<0, *, *, *, 0, 0>: the claim on carried counts (warps 1-7 sum the "
                       "counts before each of the block's tiles beside the prologue, block_dead_rank per tile) and "
                       "the next launch's counts (__syncthreads_count at the next tile's barrier)",
                       "dead_count_kernel (the seed; fleet and hybrid launches: with tile_scan_kernel)"],
              carry_cost_ms=claim["carry_cost_ms"], claim_bound_ms=claim_bound["bound_ms"],
              scanned_launch_ms=claim["scanned_launch_ms"],
              seed_ms=claim["seed_ms"], count_scan_ms=claim["count_scan_ms"],
              seed_launches=total("dead_seed"), count_scan_launches=total("dead_rank_claim"),
              ms_1M=s1m["destroy_claim"]["carried_launch_ms"], carry_cost_ms_1M=s1m["destroy_claim"]["carry_cost_ms"],
              scanned_launch_ms_1M=s1m["destroy_claim"]["scanned_launch_ms"], seed_ms_1M=s1m["destroy_claim"]["seed_ms"],
              count_scan_ms_1M=s1m["destroy_claim"]["count_scan_ms"], library_ms_1M=s1m["destroy_claim"]["cumsum_ms"],
              plain_ms_1M=s1m["destroy_claim"]["plain_dead_rank_device_ms"],
              bound_ms_1M=s1m["destroy_claim"]["launch_bound"]["bound_ms"],
              claim_bound_ms_1M=s1m["destroy_claim"]["bound"]["bound_ms"],
              occupancy=occupancy(lambda ring, collide, fields, stats, merge, fleet: not (ring or merge or fleet))),
        entry("fused_step.fields", "bevy_firework_tpu/ops/fused_step.py:1462", ("fields", "fleet_fields"),
              f1m["u8_kernel_device_ms"],
              f1m["plain_8_frames_device_ms"], f1m["bounds"]["u8"],
              main_1M_ms=r1m["u8_kernel_device_ms"], also_replaces="bevy_firework_tpu/force_fields.py:197",
              status="redesigned", occupancy=occupancy(
                  lambda ring, collide, fields, stats, merge, fleet: fields and not collide and not merge)),
        entry("fused_step.stats", "bevy_firework_tpu/ops/fused_step.py:1580", ("stats", "fleet_stats"), stats_t["ms"],
              stats_t["plain_ms"], stats_bound,
              ms_without=stats_t["ms_without"], plain_reductions_ms=stats_t["plain_reductions_ms"],
              sparks_ms=stats_t["sparks"]["ms"], sparks_ms_without=stats_t["sparks"]["ms_without"],
              status="redesigned", occupancy=occupancy(lambda ring, collide, fields, stats, merge, fleet: stats)),
        entry("fused_step.dump", "bevy_firework_tpu/ops/fused_step.py:1567", ("dump", "fleet_dump"), dump_t["ms"],
              dump_t["plain_ms"], dump_bound, ms_without=dump_t["ms_without"]),
        entry("nested_stage", "bevy_firework_tpu/ops/fused_step.py:683", "nested_stage",
              n60k["stage_ms_per_launch"], plain_stage_ms, n60k["bounds"]["stage"], source="fused_step.cu",
              also_replaces="bevy_firework_tpu/ops/fused_step.py:805/:866 (nested_cadence_pass) and "
                            "bevy_firework_tpu/step.py:411-453 (the child stage of _nested_spawn; XLA, not Pallas)",
              kernels=["nested_stage_kernel"], status="redesigned", folded_ms=n60k["folded_stage_ms_per_launch"],
              chained_ms=nch["stage_ms_per_launch"], chained_folded_ms=nch["folded_stage_ms_per_launch"],
              share_of_frame_60k=n60k["stage_share_of_frame"], share_of_frame_chained=nch["stage_share_of_frame"],
              pass_launches=total("nested_pass"), child_rows_launches=total("nested_child_rows"),
              launches_per_frame_60k=n60k["kernel_launches_per_frame"],
              launches_per_frame_chained=nch["kernel_launches_per_frame"]),
        entry("nested_seed_count", "bevy_firework_tpu/ops/fused_step.py:683", "nested_seed",
              n60k["seed_count_ms_per_launch"], plain_seed_ms, n60k["bounds"]["seed_count"], source="fused_step.cu",
              kernels=["nested_count_kernel"], role="a folded chain's seed (kernel row 10's first frame), once per "
                                                    "nested emitter and chain"),
        entry("fused_step.nested_merge", "bevy_firework_tpu/ops/fused_step.py:1172", "merge",
              n60k["step_ms_per_launch"], n60k["plain_frame_device_ms"], n60k["bounds"]["step"],
              chained_ms=nch["step_ms_per_launch"], chained_plain_ms=nch["plain_frame_device_ms"],
              lean_launches=total("merge_lean"), wide_launches=total("merge_wide"), status="redesigned",
              kernels=["fused_step_kernel_merge<ring, stats> (no colliders or fields)",
                       "fused_step_kernel<ring, 1, 1, stats, 1, 0> (colliders or fields)"],
              occupancy=occupancy(lambda ring, collide, fields, stats, merge, fleet: merge, merge=True)),
        entry("fused_step.nested_fold", "bevy_firework_tpu/ops/fused_step.py:1620", "fold",
              n60k["fold_step_ms_per_launch"], n60k["plain_folded_frame_device_ms"], n60k["bounds"]["fold_step"],
              status="redesigned",
              also_replaces="bevy_firework_tpu/ops/fused_step.py:1620-1701 (plumbing :1893-1905, :1994-2027, "
                            ":2075-2080), with the next frame's nested stage on its counts (fused_step.cu)",
              kernels=["fused_step_kernel_merge<1, stats> fold epilogue and latch",
                       "nested_stage_kernel (its carried tile counts)"],
              step_without_epilogue_ms=n60k["step_ms_per_launch"], folded_stage_ms=n60k["folded_stage_ms_per_launch"],
              unfolded_stage_ms=n60k["stage_ms_per_launch"], folded_frame_ms=n60k["folded_device_ms_per_frame"],
              unfolded_frame_ms=n60k["unfolded_device_ms_per_frame"], chained_ms=nch["fold_step_ms_per_launch"],
              chained_step_without_epilogue_ms=nch["step_ms_per_launch"],
              chained_folded_stage_ms=nch["folded_stage_ms_per_launch"],
              chained_folded_frame_ms=nch["folded_device_ms_per_frame"],
              chained_unfolded_frame_ms=nch["unfolded_device_ms_per_frame"],
              ab_fold_on_ms=ab_fold["fold_on_ms"], ab_fold_off_ms=ab_fold["fold_off_ms"]),
        entry("fused_step.fleet", "bevy_firework_tpu/ops/fused_step.py:2358", "fleet",
              res16["u8_fleet_kernel_device_ms"], res16["plain_8_frames_device_ms"], bound16,
              also_replaces="bevy_firework_tpu/ops/fused_step.py:2029 (grid=(S, tiles) :2031)",
              solo16_ms=res16["u8_solo16_kernels_device_ms"], launch_wall_ms=res16["u8_fleet_launch_wall_ms"],
              solo16_wall_ms=res16["u8_solo16_launches_wall_ms"], status="redesigned",
              occupancy=occupancy(lambda ring, collide, fields, stats, merge, fleet: fleet)),
    ]
    b4 = s1m["by_shards"][4]
    kernels.append(entry(
        "fused_step.sharded_claim", "bevy_firework_tpu/ops/fused_step.py:2152-2198", "shard",
        b4["launch_ms"][0], s1m["plain_8_frames_shard_ms"], b4["bound"],
        also_replaces="bevy_firework_tpu/ops/fused_step.py:1127-1149, :1234-1238, :1301-1307 (lane base, dead "
                      "offset, global RNG tile, global ring modulo)",
        shard_launch_ms={str(k): v["launch_ms"] for k, v in s1m["by_shards"].items()},
        shard_bound_ms={str(k): v["bound_ms"] for k, v in s1m["by_shards"].items()},
        device_us_per_frame_summed={str(k): v["device_us_per_frame_summed"] for k, v in s1m["by_shards"].items()},
        unsharded_u8_ms=s1m["unsharded_u8_ms"], status="redesigned",
        destroy_frame_s4_ms=s1m["destroy_frame_s4_device_ms"], destroy_frame_s4_wall_ms=s1m["destroy_frame_s4_wall_ms"],
        destroy_frame_s4_bound_ms=s1m["destroy_frame_s4_bound"]["bound_ms"],
        dist_gloo_launches=sum(r["shard_launches"] for r in gloo)))
    check(all(k["launches"] > 0 for k in kernels), f"a kernel of the main path never launched: "
          f"{[k['name'] for k in kernels if k['launches'] == 0]}")
    emit({"kernels": kernels, "card": card, "at": "fused_step and pack_render: 131072 lanes (100k live; u*_1M_ms: "
                          "the main_1M state, 1310720 lanes); pack_render_f16: the main_1M state (1310720 lanes, 12 "
                          "planes); collide: 1310720 lanes "
                          "stress_test_collision (collide_broad: hull8_1M, 8 hulls; scaling_*: "
                          "collider_scaling_1M, C colliders, 'h' a quarter hulls); dead_rank_claim: destroy_claim's "
                          "state, 131072 lanes (*_1M: sharded_1M's destroy state, 1310720 lanes); fields: "
                          "fields_1M (1310720 lanes, dust, 3 fields); stats: 1310720 lanes stress_test (sparks_*: 2048 lanes, 750 live); dump: "
                          "131072 lanes, the ring archetype with a handler; nested_stage, nested_seed_count, nested_merge, "
                          "nested_fold: nested_60k (131072 lanes, M 1024; chained_*: "
                          "nested_chained); fleet: "
                          "fleet_16x55k (16 slots x 65536 lanes, stress_test at 55000/s); sharded_claim: sharded_1M "
                          "(main_1M's state, S = 4 shards of 327680 lanes; shard_*: S = 2, 4, 8; destroy_frame_s4_*: "
                          "sharded_1M's destroy state in 4 shards)",
        "timing": "ms: device time per launch (torch.profiler): fused_step U=8, pack_render U=1 with the pack, "
                  "pack_render_f16 U=1 with the f16 record (u8_ms U=8; *_no_pack_ms the same launches without a "
                  "pack; plain: a plain frame and render.pack_render_planes(..., 'f16')), collide "
                  "U=2 (u8_ms U=8), collide_broad U=2 at hull8_1M, dead_rank_claim the U=1 launch claiming from "
                  "the carried counts (as dump: the launch with its block; bound_ms the launch's) "
                  "(carry_cost_ms: it less the same launch given the scanned offsets, the claim's own cost, a "
                  "difference of two traced times beside claim_bound_ms, the claim's own bytes; seed_ms: the "
                  "seed's count kernel; count_scan_ms: the count + scan pair that fleet and hybrid launches "
                  "keep; library_ms: one torch.cumsum over the dead lanes), fields U=8 with the field block, "
                  "stats U=1 with the stats block (ms_without: the same launch without it; sparks_*: at the "
                  "sparks flow's 2048-lane pool), dump U=1 with the dump "
                  "plane (ms_without: the same archetype without a handler), nested_stage one launch of an unfolded "
                  "frame (cadence pass and child rows; folded_ms: of a folded frame), nested_seed_count one count "
                  "kernel, nested_merge the hybrid step launch, nested_fold the hybrid step launch with the "
                  "fold epilogue (folded_stage_ms: the next frame's nested stage on its counts; *_frame_ms: device "
                  "time per frame of a 10-frame folded / unfolded chain), fleet one U=8 "
                  "launch of all 16 slots (solo16_ms: the 16 slots' solo U=8 launches), sharded_claim the first "
                  "shard's U=8 launch at S = 4 (shard_launch_ms: every shard's; destroy_frame_s4_ms: every kernel "
                  "of an S = 4 destroy frame, the dead offsets built on the device; "
                  "device_us_per_frame_summed: the shards' U=8 launches summed per frame); plain_ms: "
                  "device time of the plain version's same frames (8 / 1 + pack / 2 / 8 / 8 / 1 + reductions / 1 / "
                  "a hybrid frame for nested_merge, a hybrid frame with step.nested_fold_carry for nested_fold, 16 x 8 "
                  "for fleet, 8 with the shard's arguments for sharded_claim), of the plain dead_rank cumsum, of "
                  "step.nested_stage or step.nested_fold_counts; plain_reductions_ms: the plain reductions "
                  "(step.stat_reductions, the CPU's stats); "
                  "*_wall_ms: CUDA-event wall time per call; bound_ms: the larger of bound_bytes over 3.35 TB/s "
                  "and bound_ops (f32, lower-bound counts; the narrow phase's from a recorded plain frame of the "
                  "same state, its broad phase's skips included) over 67 TFLOP/s; collide and collide_broad are "
                  "one function, counted by the JAX package's form (fewer than LOOP_MIN_COLLIDERS colliders, or "
                  "more); library_ms: no single PyTorch call "
                  "computes these functions but the claim's; every device time was held to its bound, a trace below it traced "
                  "again (trace_faults)",
        "trace_faults": trace_faults,
        "at_1M": {k: r1m[k] for k in ("u8_kernel_device_ms", "plain_8_frames_device_ms", "render_kernel_device_ms",
                                      "plain_render_frame_device_ms")}})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
