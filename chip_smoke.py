#!/usr/bin/env python3
"""Drive bevy_firework_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Builds the fused step kernel (ops/csrc/fused_step.cu) from this checkout,
holds it against its plain PyTorch version, and runs the path `bench.py`
measures for the JAX package (stress_test through multi_step_auto at 100k
and 1M live) plus the interactive sparks flow, through the kernel. Phases:

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
     last render planes equal the plain render pack.

The launch counters are set to 0 just before each main-path run (the two
chains and the sparks flow) and read just after it; the kernels' summary
reports those counts only. Every phase prints one JSON line; the kernels'
summary and the final `{"ok": true, "device": ...}` line follow. Any failed check raises, so the
exit code is non-zero and no final line is printed. Without a CUDA device
the script exits with an error before running anything.
"""

from __future__ import annotations

import dataclasses
import json
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
    from bevy_firework_tpu_torch.step import active_f32_fields, plain_frames
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
    max_err = {"fused_step": 0.0, "fused_step.pack_render": 0.0}

    def compare(c, sk, sp, f32_ulps: dict, label):
        for k in scalars:
            check(torch.equal(getattr(sk, k).cpu(), getattr(sp, k).cpu()), f"{label}: {k} differs")
        worst = {}
        for k in active_f32_fields(c.static):
            a, b = getattr(sk, k), getattr(sp, k)
            worst[k] = ulp_diff(a, b)
            max_err["fused_step"] = max(max_err["fused_step"], float((a - b).abs().max()))
            check(worst[k] <= f32_ulps.get(k, 0), f"{label}: {k} differs by {worst[k]} ulp")
        return worst

    def compare_planes(c, s, planes, label):
        """The kernel's render-pack planes against the plain render pack of
        the state the same launch produced: bit for bit."""
        for i, (a, b) in enumerate(zip(planes, pack_render_planes(c.static, c.params, s))):
            max_err["fused_step.pack_render"] = max(max_err["fused_step.pack_render"], float((a - b).abs().max()))
            check(torch.equal(a, b), f"{label}: render plane {i} differs by {ulp_diff(a, b)} ulp")

    def counted(fn):
        """fn() with the kernel's launch counters set to 0 just before it and
        read just after: (result, launches, render-pack launches)."""
        fs.fused_step.launches = 0
        fs.fused_step.render_launches = 0
        result = fn()
        return result, fs.fused_step.launches, fs.fused_step.render_launches

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

    def stress(rate=None):
        sp, tf = effects.stress_test()
        if rate is not None:
            es = dataclasses.replace(sp.emission_settings[0], emission_pacing=EmissionPacing.rate(float(rate)))
            sp = dataclasses.replace(sp, emission_settings=(es,))
        return sp, tf

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
    sp0, tf = stress()
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

    def device_ms(fn, reps, kernel_only):
        """Device time per call from a torch.profiler trace: the fused step
        kernel's own time (kernel_only) or that of every CUDA kernel."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern, total = device_times(prof, "fused_step_kernel")
        ms = (kern if kernel_only else total) / reps / 1e3
        check(ms > 0, f"the profiler saw no device time for {fn}")
        return ms

    # ------------------------------------------------ 6./7. main path
    def main_path(rate, capacity, n_frames, plain_frames_n, label):
        spm, tfm = stress(rate)
        cm = bt.compile_spawner(spm, device=dev)
        frame = bt.make_frame_input(1 / 60)
        state0 = bt.init_pool_for(cm, capacity, seed=0)
        (state, out), launches, render_launches = counted(
            lambda: fs.multi_step_auto(cm.static, cm.params, None, state0, frame, 140))
        torch.cuda.synchronize()
        check(launches == len(fs.chain_shape(140)) and render_launches == 0,
              f"{label}: the 140-frame chain launched the kernel {launches} times ({render_launches} with render)")
        alive = int(out.alive_count)
        # reference: the plain version over the same 140 frames
        ref, ref_out = plain_frames(cm.static, cm.params, state0, frame, 140)
        check(int(ref_out.alive_count) == alive, f"{label}: alive {alive} != plain {int(ref_out.alive_count)}")
        for k in ("ring_cursor", "time_in_cycle", "last_emission"):
            check(torch.equal(getattr(ref, k), getattr(state, k)), f"{label}: {k} differs from plain")
        for k in active_f32_fields(cm.static):
            check(ulp_diff(getattr(ref, k), getattr(state, k)) <= 4, f"{label}: {k} beyond 4 ulp of plain")
        for k in ("px", "py", "pz", "vx", "vy", "vz"):
            check(bool(torch.isfinite(getattr(state, k)).all()), f"{label}: non-finite {k}")
        sr, _o, planes = fs.fused_step(cm.static, cm.params, None, state, frame, pack_render=True)
        compare_planes(cm, sr, planes, label)

        def run(n):
            st, _o = fs.multi_step_auto(cm.static, cm.params, None, state, frame, n)
            return st

        def run_plain(n):
            st, _o = plain_frames(cm.static, cm.params, state, frame, n)
            return st

        def differential(fn, n, reps):
            diffs = []
            for _ in range(reps):
                t_n = event_ms(lambda: fn(n), 1)
                t_2n = event_ms(lambda: fn(2 * n), 1)
                diffs.append((t_2n - t_n) / n)
            return statistics.median(diffs)

        ms = differential(run, n_frames, 5)
        plain_ms = differential(run_plain, plain_frames_n, 3)

        # one U=8 launch vs 8 plain frames, and one render-pack launch vs a
        # plain frame plus the plain pack, at this shape (no stats)
        def u8():
            return fs.fused_step(cm.static, cm.params, None, state, frame, unroll=8, stats=False)

        def plain8():
            return plain_frames(cm.static, cm.params, state, frame, 8, stats=False)

        def render1():
            return fs.fused_step(cm.static, cm.params, None, state, frame, pack_render=True, stats=False)

        def plain_render():
            st, _o = plain_frames(cm.static, cm.params, state, frame, 1, stats=False)
            return pack_render_planes(cm.static, cm.params, st)

        res = {"phase": label, "card": card, "capacity": capacity, "rate": rate, "live": alive,
               "chain_launches": launches, "ms_per_frame": ms, "particle_steps_per_s": alive / (ms * 1e-3),
               "plain_ms_per_frame": plain_ms, "plain_particle_steps_per_s": alive / (plain_ms * 1e-3),
               "u8_kernel_device_ms": device_ms(u8, 20, True), "plain_8_frames_device_ms": device_ms(plain8, 5, False),
               "render_kernel_device_ms": device_ms(render1, 20, True),
               "plain_render_frame_device_ms": device_ms(plain_render, 5, False),
               "u8_launch_wall_ms": event_ms(u8, 20), "plain_8_frames_wall_ms": event_ms(plain8, 5),
               "render_launch_wall_ms": event_ms(render1, 20), "plain_render_frame_wall_ms": event_ms(plain_render, 5)}
        emit(res)
        return res

    r100k = main_path(100_000, 1 << 17, 400, 20, "main_100k")
    r1m = main_path(1_000_000, 160 * 8192, 150, 10, "main_1M")

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

    (ss, out, planes), s_launches, s_render = counted(sparks)
    check(s_launches == 120 and s_render == 120,
          f"sparks flow: {s_launches} kernel launches ({s_render} with render) for 120 frames")
    compare_planes(cs, ss, planes, "sparks flow")
    rows = bt.planes_to_rows(cs.static, ss, planes)
    check(int(out.alive_count) == 750, f"sparks flow: {int(out.alive_count)} live, want 750")
    check(len(bt.instances_to_bytes(rows)) == 750 * 64, "sparks flow: row bytes")
    emit({"phase": "sparks_flow", "card": card, "live": int(out.alive_count), "bytes": 750 * 64,
          "launches": s_launches, "render_launches": s_render})

    # counts from the main-path runs alone: the two chains and the sparks flow
    launches = r100k["chain_launches"] + r1m["chain_launches"] + s_launches
    render_launches = s_render

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
    ], "card": card, "at": "131072 lanes (100k live)",
        "timing": "ms: device time per launch (torch.profiler), U=8 / U=1 with render pack; plain_ms: device time "
                  "of the plain version's 8 frames / 1 frame plus pack; *_wall_ms: CUDA-event wall time per call",
        "at_1M": {k: r1m[k] for k in ("u8_kernel_device_ms", "plain_8_frames_device_ms", "render_kernel_device_ms",
                                      "plain_render_frame_device_ms")}})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
