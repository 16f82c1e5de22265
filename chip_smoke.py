#!/usr/bin/env python3
"""Drive bevy_firework_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Builds the fused step kernels (ops/csrc/fused_step.cu) from this checkout,
holds them against their plain PyTorch versions, and runs the paths
`bench.py` measures for the JAX package (stress_test through
multi_step_auto at 100k and 1M live; stress_test_collision against its two
cuboids and against 8 hulls at 1M) plus the interactive sparks and
collision flows, through the kernels. Phases:

  1. card: name and power limit (nvidia-smi), kernel build time;
  2. deterministic config (constant draws, live rotation), N = 131072:
     kernel == plain bit for bit, 1-frame and 8-frame launches;
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
     cursor and fields exact against plain each frame; the claim's tile
     offsets against their plain version; tiles holding dead lanes;
 11. collision_1M: stress_test_collision at rate 5e5, capacity 1310720,
     two cuboids: a 150-frame multi_step_auto chain (U = 2 launches)
     against 150 plain frames (counts, cursor, cadence exact; f32 within 4
     ulp), its render pack against plain, differential ms/frame, and the
     kernel's device time per U = 2 and per U = 8 launch beside the plain
     version's 2 and 8 frames;
 12. hull8_1M: the same against bench.py's 8 hulls, 120 frames;
 13. collision_flow: effects.collision() with its cuboid through
     step_auto_packed for 400 frames: live count, state and render planes
     equal the plain version's.

The launch counters are set to 0 just before each main-path run (the two
stress_test chains, the sparks flow, the destroy run, the two collision
chains and the collision flow) and read just after it; the kernels'
summary reports those counts only. Every phase prints one JSON line; the kernels'
summary and the final `{"ok": true, "device": ...}` line follow. Any failed check raises, so the
exit code is non-zero and no final line is printed. Without a CUDA device
the script exits with an error before running anything.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time


class CheckFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 2
    import bevy_firework_tpu_torch as bt
    from bevy_firework_tpu_torch.models import effects
    from bevy_firework_tpu_torch.ops import _build
    from bevy_firework_tpu_torch.ops import fused_step as fs
    from bevy_firework_tpu_torch.profile_step import device_times
    from bevy_firework_tpu_torch.render import pack_render_planes
    from bevy_firework_tpu_torch.settings import EmissionPacing
    from bevy_firework_tpu_torch.settings import ParticleCollisionSettings
    from bevy_firework_tpu_torch.step import active_f32_fields, dead_rank, plain_frames
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")

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
    emit({"phase": "card", "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s})

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
               "fused_step.dead_rank_claim": 0.0}

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

    def counted(fn):
        """fn() with the kernels' launch counters set to 0 just before it and
        read just after: (result, {counter: launches})."""
        fs.fused_step.launches = 0
        fs.fused_step.render_launches = 0
        fs.fused_step.collide_launches = 0
        fs.tile_dead_offsets.launches = 0
        result = fn()
        return result, {"fused_step": fs.fused_step.launches, "render": fs.fused_step.render_launches,
                        "collide": fs.fused_step.collide_launches, "dead_rank_claim": fs.tile_dead_offsets.launches}

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
    torch.cuda.synchronize()
    emit({"phase": "deterministic", "card": card, "n": 131072, "live": int(s.alive.sum()),
          "max_ulp": worst_det, "rule": "bit-equal; rotation <= 2 ulp (sinf/cosf)"})

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

    def device_ms(fn, reps, kernel_only, kernels=("fused_step_kernel",)):
        """Device time per call from a torch.profiler trace: the named
        kernels' own time (kernel_only) or that of every CUDA kernel."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = sum(device_times(prof, k)[0] for k in kernels)
        total = device_times(prof, kernels[0])[1]
        ms = (kern if kernel_only else total) / reps / 1e3
        check(ms > 0, f"the profiler saw no device time for {fn}")
        return ms

    # ------------------------------------ 6./7. (and 11./12.) chained paths
    claim_kernels_names = ("dead_count_kernel", "tile_scan_kernel")

    def chain_path(label, spawner, rate, capacity, warm, n_frames, plain_n, colliders=None, unrolls=(8,)):
        """A `warm`-frame multi_step_auto chain from an empty pool (launches
        counted) against as many plain frames, its render pack against the
        plain one, differential CUDA-event ms/frame over n and 2n frames,
        and device times (torch.profiler) of one launch per U in `unrolls`,
        of a render-pack launch and of the dead-rank claim on the final
        alive plane, each beside the plain version's."""
        es = dataclasses.replace(spawner.emission_settings[0], emission_pacing=EmissionPacing.rate(float(rate)))
        cm = bt.compile_spawner(dataclasses.replace(spawner, emission_settings=(es,)), device=dev)
        table = None if colliders is None else bt.compile_colliders(colliders, device=dev)
        frame = bt.make_frame_input(1 / 60)  # bench.py's _measure: the spawner at the origin
        state0 = bt.init_pool_for(cm, capacity, seed=0)
        (state, out), counts = counted(lambda: fs.multi_step_auto(cm.static, cm.params, table, state0, frame, warm))
        torch.cuda.synchronize()
        want = len(fs.chain_shape(warm, fs.chain_unroll(cm.static, table)))
        check(counts["fused_step"] == want and counts["render"] == 0
              and counts["collide"] == (0 if table is None else want), f"{label}: the chain's launches {counts}")
        alive = int(out.alive_count)
        ref, ref_out = plain_frames(cm.static, cm.params, state0, frame, warm, colliders=table)
        check(int(ref_out.alive_count) == alive, f"{label}: alive {alive} != plain {int(ref_out.alive_count)}")
        for k in ("ring_cursor", "time_in_cycle", "last_emission", "alive"):
            check(torch.equal(getattr(ref, k), getattr(state, k)), f"{label}: {k} differs from plain")
        worst = {}
        for k in active_f32_fields(cm.static):
            a, b = getattr(ref, k), getattr(state, k)
            worst[k] = ulp_diff(a, b)
            if table is not None:
                max_err["fused_step.collide"] = max(max_err["fused_step.collide"], float((a - b).abs().max()))
            check(worst[k] <= 4, f"{label}: {k} {worst[k]} ulp from plain")
            check(bool(torch.isfinite(b).all()), f"{label}: non-finite {k}")
        res = {"phase": label, "card": card, "capacity": capacity, "rate": rate, "live": alive, "chain_frames": warm,
               "chain_launches": counts["fused_step"], "max_ulp": worst}
        if table is not None:
            free, _o = plain_frames(cm.static, cm.params, state0, frame, warm)
            res.update(colliders=len(colliders), lanes_deflected=int((state.alive & (state.py != free.py)).sum()))
        sr, _o, planes = fs.fused_step(cm.static, cm.params, table, state, frame, pack_render=True)
        compare_planes(cm, sr, planes, label)

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
            res[f"u{u}_kernel_device_ms"] = device_ms(launch(u), 20, True)
            res[f"plain_{u}_frames_device_ms"] = device_ms(plain(u), 3, False)
            res[f"u{u}_launch_wall_ms"] = event_ms(launch(u), 20)
            res[f"plain_{u}_frames_wall_ms"] = event_ms(plain(u), 3)
        res.update(render_kernel_device_ms=device_ms(launch(1, True), 20, True),
                   plain_render_frame_device_ms=device_ms(plain_render, 3, False),
                   render_launch_wall_ms=event_ms(launch(1, True), 20),
                   plain_render_frame_wall_ms=event_ms(plain_render, 3),
                   claim_kernels_device_ms=device_ms(lambda: fs.tile_dead_offsets(state.alive), 20, True,
                                                     claim_kernels_names),
                   plain_dead_rank_device_ms=device_ms(lambda: dead_rank(~state.alive), 20, False))
        emit(res)
        return res, counts

    stress_sp = effects.stress_test()[0]
    r100k, r100k_counts = chain_path("main_100k", stress_sp, 100_000, 1 << 17, 140, 400, 20)
    r1m, r1m_counts = chain_path("main_1M", stress_sp, 1_000_000, 160 * 8192, 140, 150, 10)

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
    def box_spawner(destroy=False):
        """Box emission, radial speed, no spread, gravity: every draw reaches
        the state through +, -, *, / and sqrt only (sinf/cosf see 0), so the
        kernel and the plain version agree bit for bit on every lane."""
        return bt.ParticleSpawner(
            particle_settings=[bt.ParticleSettings(
                lifetime=bt.RandF32.constant(2.0), initial_scale=bt.RandF32(0.02, 0.08),
                acceleration=(0.0, -9.81, 0.0), linear_drag=0.1,
                collision_settings=ParticleCollisionSettings(restitution=0.7, friction=0.3,
                                                             destroy_on_collision=destroy))],
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
    check(d_counts["fused_step"] == 30 and d_counts["collide"] == 30 and d_counts["dead_rank_claim"] == 30,
          f"destroy_claim launches {d_counts}")
    offs = fs.tile_dead_offsets(sd.alive)
    offs_plain = fs.tile_dead_offsets(sd.alive.cpu())
    max_err["fused_step.dead_rank_claim"] = float((offs.cpu() - offs_plain).abs().max())
    check(torch.equal(offs.cpu(), offs_plain), "destroy_claim: tile offsets differ from plain")
    tiles_dead = int((~sd.alive).view(-1, 256).any(1).sum())
    check(destroyed > 1000 and tiles_dead > 100, f"destroy_claim: {destroyed} destroyed, {tiles_dead} tiles")

    def claim_kernels():
        return fs.tile_dead_offsets(sd.alive)

    def claim_plain():
        return dead_rank(~sd.alive)

    claim = {"claim_kernels_device_ms": device_ms(claim_kernels, 20, True, claim_kernels_names),
             "plain_dead_rank_device_ms": device_ms(claim_plain, 20, False)}
    emit({"phase": "destroy_claim", "card": card, "n": 131072, "frames": 30, "live": int(sd.alive.sum()),
          "destroyed": destroyed, "tiles": 512, "tiles_with_dead_lanes": tiles_dead, "launches": d_counts,
          **claim, "rule": "claims, alive, cursor and fields bit-equal each frame; tile offsets == plain"})

    # ------------------------------------------- 11./12. collision at 1M
    spc = effects.stress_test_collision()[0]
    c1m, c1m_counts = chain_path("collision_1M", spc, 500_000, 160 * 8192, 150, 150, 5,
                                 effects.stress_test_collision()[2], (2, 8))
    hulls = [bt.Collider.hull([(1, 0, 0, 60.0), (-1, 0, 0, 60.0), (0, 1, 0, 1.0), (0, -1, 0, 1.0), (0, 0, 1, 60.0),
                               (0, 0, -1, 60.0)], position=(0.0, -1.5, 0.0))]
    for i in range(7):
        hulls.append(bt.Collider.hull_from_points([(0, 0, 0), (2.0, 0, 0), (0, 2.5, 0), (0, 0, 2.0)],
                                                  position=(float(i * 3 - 9), -0.5, float((i % 3) * 3 - 3))))
    h8, h8_counts = chain_path("hull8_1M", spc, 500_000, 160 * 8192, 120, 120, 3, hulls, (2, 8))

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

    # counts from the main-path runs alone: the two stress_test chains, the
    # sparks flow, the destroy run, the two collision chains, the collision flow
    runs = (r100k_counts, r1m_counts, s_counts, d_counts, c1m_counts, h8_counts, f_counts)
    launches = sum(r["fused_step"] for r in runs)
    render_launches = sum(r["render"] for r in runs)
    collide_launches = sum(r["collide"] for r in runs)
    claim_launches = sum(r["dead_rank_claim"] for r in runs)

    src = "bevy_firework_tpu_torch/ops/csrc/fused_step.cu"
    emit({"kernels": [
        {"name": "fused_step", "route": "cuda", "source": src,
         "replaces": "bevy_firework_tpu/ops/fused_step.py:913", "launches": launches,
         "max_abs_err": max_err["fused_step"], "ms": r100k["u8_kernel_device_ms"],
         "plain_ms": r100k["plain_8_frames_device_ms"], "launch_wall_ms": r100k["u8_launch_wall_ms"],
         "plain_wall_ms": r100k["plain_8_frames_wall_ms"]},
        {"name": "fused_step.pack_render", "route": "cuda", "source": src,
         "replaces": "bevy_firework_tpu/ops/fused_step.py:1523", "launches": render_launches,
         "max_abs_err": max_err["fused_step.pack_render"], "ms": r100k["render_kernel_device_ms"],
         "plain_ms": r100k["plain_render_frame_device_ms"], "launch_wall_ms": r100k["render_launch_wall_ms"],
         "plain_wall_ms": r100k["plain_render_frame_wall_ms"]},
        {"name": "fused_step.collide", "route": "cuda", "source": src,
         "replaces": "bevy_firework_tpu/ops/fused_step.py:349", "launches": collide_launches,
         "max_abs_err": max_err["fused_step.collide"], "ms": c1m["u2_kernel_device_ms"],
         "plain_ms": c1m["plain_2_frames_device_ms"], "u8_ms": c1m["u8_kernel_device_ms"],
         "plain_u8_ms": c1m["plain_8_frames_device_ms"], "hull8_ms": h8["u2_kernel_device_ms"],
         "hull8_plain_ms": h8["plain_2_frames_device_ms"]},
        {"name": "fused_step.dead_rank_claim", "route": "cuda", "source": src,
         "replaces": "bevy_firework_tpu/ops/fused_step.py:173",
         "kernels": ["dead_count_kernel", "tile_scan_kernel", "fused_step_kernel block_dead_rank"],
         "launches": claim_launches, "max_abs_err": max_err["fused_step.dead_rank_claim"],
         "ms": claim["claim_kernels_device_ms"], "plain_ms": claim["plain_dead_rank_device_ms"],
         "ms_1M": c1m["claim_kernels_device_ms"], "plain_ms_1M": c1m["plain_dead_rank_device_ms"]},
    ], "card": card, "at": "fused_step and pack_render: 131072 lanes (100k live); collide: 1310720 lanes "
                          "stress_test_collision; dead_rank_claim: 131072 lanes (ms_1M: 1310720)",
        "timing": "ms: device time per launch (torch.profiler): fused_step U=8, pack_render U=1 with the pack, collide "
                  "U=2 (u8_ms U=8), dead_rank_claim its count + scan kernels; plain_ms: device time of the plain "
                  "version's same frames (8 / 1 + pack / 2 / 8) or of the plain dead_rank cumsum; *_wall_ms: "
                  "CUDA-event wall time per call",
        "at_1M": {k: r1m[k] for k in ("u8_kernel_device_ms", "plain_8_frames_device_ms", "render_kernel_device_ms",
                                      "plain_render_frame_device_ms")}})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
