"""The render extract's configurations and checks, shared by the port's card
tests (tests/test_torch_kernel.py) and chip_smoke.py: the f16 render pack
against its plain version, and examples/render_loop.py's loop (step, the
reader's copy stream, the ring, a draw poll) with every drawn frame held to
the plain pack of its state. Imports torch and the port only (no tests
here)."""

import time

import numpy as np
import torch

import bevy_firework_tpu_torch as pt
from bevy_firework_tpu_torch.ops import fused_step as fs
from bevy_firework_tpu_torch.render import pack_render_planes, planes_to_rows
from bevy_firework_tpu_torch.render_pipeline import AsyncRenderReader


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def f16_spawner(rotating: bool):
    """tests/test_fused_step.py's f16 spawner: constant draws, a point
    emitter; rotation elided (the 12-plane record) or, with an angular
    velocity, live (16 planes)."""
    extra = {"initial_angular_velocity": pt.RandVec3.constant((0.0, 2.0, 0.0))} if rotating else {}
    return pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(
            lifetime=pt.RandF32.constant(0.3), initial_scale=pt.RandF32.constant(0.1),
            scale_curve=pt.FireworkCurve.uneven_samples([(0.0, 1.0), (1.0, 2.0)]),
            base_color=pt.gradient_uneven_samples([(0.0, (1, 0.5, 0.2, 1)), (1.0, (0, 0, 0, 0))]))],
        emission_settings=[pt.EmissionSettings(
            emission_pacing=pt.EmissionPacing.rate(2000.0), initial_velocity=pt.RandVec3.constant((1.0, 3.0, 0.2)),
            **extra)],
    )


def same_f16(a: torch.Tensor, b: torch.Tensor) -> bool:
    """f16 planes equal bit for bit, NaN lanes by isnan (payloads may
    differ)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(a.view(torch.int16)[~na], b.view(torch.int16)[~nb]))


def check_record(static, params, state, p16, p32=None, label="") -> float:
    """The kernel's f16 record against the plain version on the post-step
    state the same launch wrote, bit for bit (NaN by isnan), and, given the
    kernel's own f32 pack of the same launch (p32), against it and the
    state's positions and quaternion rounded to nearest even. Returns the
    largest absolute difference to the plain version (0.0)."""
    want = pack_render_planes(static, params, state, "f16")
    require(len(p16) == len(want) == (12 if static.elide_rotation else 16), f"{label}: {len(p16)} f16 planes")
    err = 0.0
    for i, (a, b) in enumerate(zip(p16, want)):
        require(a.dtype == torch.float16 and same_f16(a, b), f"{label}: f16 plane {i} differs from the plain version")
        d = (a.float() - b.float()).abs()
        err = max(err, float(d[~torch.isnan(d)].max()) if d.numel() else 0.0)
    if p32 is not None:
        q = () if static.elide_rotation else (state.qx, state.qy, state.qz, state.qw)
        for i, (a, b) in enumerate(zip(p16, (state.px, state.py, state.pz, p32[0], *q, *p32[1:]))):
            require(same_f16(a, b.to(torch.float16)), f"{label}: f16 plane {i} != the f32 value rounded")
    return err


def rows_of(static, params, state, record) -> np.ndarray:
    """The plain pack of a post-step state as contract rows: what a drawn
    frame must hold (f32 rows, or f16 rows for the f16 record)."""
    return planes_to_rows(static, state, pack_render_planes(static, params, state, record))


def render_loop(compiled, frame, capacity, frames, record, reader=True, check=False, warm=10, seed=0):
    """examples/render_loop.py's loop on the port: per frame one
    fused_step(pack_render=record) and, with the reader, submit_packed and a
    draw poll (acquire; a frame no newer than the last drawn is skipped, as
    Scene.render_async does; release). check: every post-step state stays
    on the card until the loop ends, and every drawn frame's rows must
    equal the plain pack of its state (however late it is drawn).
    Returns the sim loop's wall ms/frame over the frames after `warm`
    (ending in a synchronize), the frame ids drawn, how many were checked
    and skipped, the frames the reader published and its copy times."""
    cuda = torch.device(compiled.params.device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    state = pt.init_pool_for(compiled, capacity, seed=seed)
    rd = AsyncRenderReader(capacity, 1, timing=cuda) if reader else None
    acquire = None if rd is None else (lambda: rd.acquire_f16(0)) if record == "f16" else (lambda: rd.acquire(0))
    kept, drawn, checked, skipped = {}, [], 0, 0
    t0 = time.perf_counter()
    try:
        for fid in range(1, frames + 1):
            if fid == warm + 1:
                sync()
                t0 = time.perf_counter()
            state, _o, planes = fs.fused_step(compiled.static, compiled.params, None, state, frame, pack_render=record)
            if rd is None:
                continue
            rd.submit_packed(compiled.static, state, planes, fid)
            if check:
                kept[fid] = state
            got = acquire()
            if got is None:
                continue
            rows, got_fid = got
            if drawn and got_fid <= drawn[-1]:
                skipped += 1
            else:
                drawn.append(got_fid)
                if check:
                    want = rows_of(compiled.static, compiled.params, kept[got_fid], record)
                    require(rows.shape == want.shape and rows.tobytes() == want.tobytes(),
                            f"frame {got_fid}: drawn rows {rows.shape} differ from the plain pack {want.shape}")
                    checked += 1
            rd.release(0)
        sync()
        ms = (time.perf_counter() - t0) / (frames - warm) * 1e3
    finally:
        if rd is not None:
            rd.close()
    return {"ms_per_frame": ms, "drawn": drawn, "checked": checked, "skipped": skipped,
            "published": 0 if rd is None else rd.published, "copy_ms": [] if rd is None else list(rd.copy_ms),
            "live": int(state.alive.sum())}
