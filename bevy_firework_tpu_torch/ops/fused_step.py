"""The fused step: the CUDA kernel wrapper and the dispatch around it.

`fused_step` advances a pool by U <= 8 frames in one launch of the
hand-written Hopper kernel (`csrc/fused_step.cu`, which replaces the JAX
package's Pallas `_make_kernel` in its main-path configuration), optionally
writing the render-pack planes of the last frame. Dispatch is by the device
of the pool's tensors and nothing else:
  * CUDA tensors: the kernel is launched, or the call raises;
  * CPU tensors: the plain PyTorch version (`step.plain_frames` over U
    frames, and `render.pack_render_planes`), which keeps the kernel's op order and
    random-bit layout.
Archetypes outside the kernel's scope raise NotImplementedError on either
device; nothing falls back.

The stats of a frame (AABB, alive and per-type counts, finished latch) are
torch reductions outside the kernel (`step.epilogue`), as XLA ran them
outside the Pallas kernel. `multi_step_auto` computes them for the last
frame only; earlier launches of a chain update just the finished latch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..compiled import MODE_GLOBAL, SpawnerParams, SpawnerStatic
from ..pool import FrameInput, PoolState
from ..prng import frame_seeds
from ..render import pack_render_planes
from ..step import active_f32_fields, check_scope, epilogue, plain_frames
from . import table_layout as L

MAX_UNROLL = L.MAX_U


def can_fuse(static: SpawnerStatic) -> bool:
    """Global-only archetypes (the JAX package's fused-path condition)."""
    return all(m == MODE_GLOBAL for m in static.mode_kinds)


def can_unroll(static: SpawnerStatic) -> bool:
    """U frames per launch are sound where every cross-frame dependency
    lives in the fields and scalars: ring claims, derived alive, no dump."""
    return can_fuse(static) and static.ring_claim and static.derived_alive and not static.any_destroyed_dump


def check_kernel_scope(static: SpawnerStatic, colliders=None, frame: Optional[FrameInput] = None,
                       unroll: int = 1) -> None:
    """Raise NotImplementedError for an archetype or call the kernel (and its
    plain version) does not cover."""
    check_scope(static, colliders, frame)
    if not can_unroll(static):
        raise NotImplementedError("archetype outside the fused kernel's scope (can_unroll is false)")
    if not 1 <= unroll <= MAX_UNROLL:
        raise ValueError(f"unroll must be in 1..{MAX_UNROLL}, got {unroll}")
    if static.num_emitters > L.MAX_E or static.num_types > L.MAX_T:
        raise NotImplementedError(f"the kernel's tables hold at most {L.MAX_E} emitters and {L.MAX_T} types")


def pack_tables(static: SpawnerStatic, params: SpawnerParams) -> np.ndarray:
    """The kernel's table buffer (int32 words, f32 values stored bitwise):
    spawner structure in a header, then emitter rows, type rows and curve
    rows, at the slots `table_layout` names."""
    p = params.to_numpy()
    K = p["scale_ts"].shape[1]
    if K > L.MAX_K:
        raise NotImplementedError(f"curves with more than {L.MAX_K} knots are outside the kernel's tables")
    words = np.zeros(L.TABLE_WORDS, np.int32)
    fl = words.view(np.float32)
    E, T = static.num_emitters, static.num_types
    words[[L.H_E, L.H_SINGLE, L.H_ELIDE_ROT]] = [E, int(static.single_type), int(static.elide_rotation)]
    words[L.H_CONST_LIFE] = int(static.const_lifetime is not None)
    fl[L.H_CONST_LIFE_VAL] = 0.0 if static.const_lifetime is None else static.const_lifetime
    words[L.H_PACING:L.H_PACING + E] = static.pacing_kinds
    words[L.H_PINDEX:L.H_PINDEX + E] = static.particle_indices
    for t, (k, n) in enumerate(static.scale_curve_meta):
        words[L.H_SCALE_KIND + t], words[L.H_SCALE_N + t] = k, n
    for t, (bk, bn, ek, en) in enumerate(static.color_curve_meta):
        words[[L.H_BASE_KIND + t, L.H_BASE_N + t, L.H_EMIS_KIND + t, L.H_EMIS_N + t]] = [bk, bn, ek, en]
    emitter_slots = ((L.EM_COUNT, "count"), (L.EM_DURATION, "duration"), (L.EM_OFF_START, "off_start"),
                     (L.EM_OFF_END, "off_end"), (L.EM_SHAPE, "shape_params"), (L.EM_IVEL, "ivel_params"),
                     (L.EM_IANG, "iangvel_params"), (L.EM_RADIAL_LO, "radial_lo"), (L.EM_RADIAL_HI, "radial_hi"),
                     (L.EM_INHERIT, "inherit"), (L.EM_INIT_ROT, "init_rot"))
    type_slots = ((L.TY_ISCALE_LO, "initial_scale_lo"), (L.TY_ISCALE_HI, "initial_scale_hi"),
                  (L.TY_LIFE_LO, "lifetime_lo"), (L.TY_LIFE_HI, "lifetime_hi"), (L.TY_ACCEL, "acceleration"),
                  (L.TY_LIN_DRAG, "linear_drag"), (L.TY_ANG_ACCEL, "angular_acceleration"),
                  (L.TY_ANG_DRAG, "angular_drag"))

    def put(at, value):
        v = np.atleast_1d(value)
        fl[at:at + v.size] = v

    for e in range(E):
        for slot, name in emitter_slots:
            put(L.EM_AT + e * L.EM_STRIDE + slot, p[name][e])
    for t in range(T):
        for slot, name in type_slots:
            put(L.TY_AT + t * L.TY_STRIDE + slot, p[name][t])
        curve_rows = {L.CV_SCALE_TS: p["scale_ts"][t], L.CV_SCALE_VS: p["scale_vs"][t],
                      L.CV_BASE_TS: p["base_ts"][t], L.CV_EMIS_TS: p["emis_ts"][t]}
        for c in range(4):
            curve_rows[L.CV_BASE_TS + 1 + c] = p["base_vs"][t][:, c]
            curve_rows[L.CV_EMIS_TS + 1 + c] = p["emis_vs"][t][:, c]
        for r, vals in curve_rows.items():
            put(L.CV_AT + t * L.CV_STRIDE + r * L.MAX_K, vals)
    return words


def kernel_tables(static: SpawnerStatic, params: SpawnerParams) -> torch.Tensor:
    """`pack_tables` on the params' device, built once per (params, static)
    and kept in the params object (a frozen dataclass; the cache lives in
    its __dict__, beside the fields it is derived from)."""
    cache = params.__dict__.setdefault("_kernel_tables", {})
    if static not in cache:
        cache[static] = torch.from_numpy(pack_tables(static, params)).to(params.device)
    return cache[static]


def _ptr_array(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr() for t in tensors])


def _checked(t: torch.Tensor, dtype, device, shape: tuple) -> torch.Tensor:
    if t.dtype != dtype or t.device != device or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"kernel input must be a contiguous {dtype} tensor of shape {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")
    return t


def _launch(static: SpawnerStatic, params: SpawnerParams, state: PoolState, frame: FrameInput, seeds: list,
            pack_render: bool):
    """One kernel launch on the current stream. Returns (fields, scal,
    render planes or None): new tensors; the inputs are not modified."""
    from . import _build

    lib = _build.load()
    dev = state.device
    if params.device != dev:
        raise ValueError(f"params on {params.device}, pool on {dev}")
    N = state.capacity
    fields = {}
    ins, outs = [None] * L.N_FIELDS, [None] * L.N_FIELDS
    for name in active_f32_fields(static):
        i = L.FIELD_SLOTS.index(name)
        ins[i] = _checked(getattr(state, name), torch.float32, dev, (N,))
        outs[i] = fields[name] = torch.empty_like(ins[i])
    ptype_in = ptype_out = None
    if not static.single_type:
        ptype_in = _checked(state.ptype, torch.int32, dev, (N,))
        ptype_out = torch.empty_like(ptype_in)
    fields["ptype"] = state.ptype if ptype_out is None else ptype_out
    names = ("time_in_cycle", "last_emission", "enabled", "manual_queued", "ring_cursor")
    dtypes = (torch.float32, torch.float32, torch.bool, torch.int32, torch.int32)
    E = static.num_emitters
    shapes = ((E,), (E,), (E,), (), ())
    s_in = [_checked(getattr(state, k), d, dev, sh) for k, d, sh in zip(names, dtypes, shapes)]
    s_out = [torch.empty_like(t) for t in s_in]
    render = [torch.empty(N, dtype=torch.float32, device=dev) for _ in range(L.N_RENDER)] if pack_render else None
    row = np.zeros(L.FRAME_WORDS, np.float32)
    for at, value in ((L.FR_DT, frame.dt), (L.FR_MOD_SCALE, frame.modifier_scale),
                      (L.FR_MOD_SPEED, frame.modifier_speed), (L.FR_PVEL, frame.parent_velocity),
                      (L.FR_TRANS, frame.transform_translation), (L.FR_ROT, frame.transform_rotation)):
        v = value.numpy().reshape(-1)
        row[at:at + v.size] = v
    frame_row = (ctypes.c_float * L.FRAME_WORDS)(*row.tolist())
    seed_row = (ctypes.c_uint32 * len(seeds))(*seeds)
    rc = lib.bf_fused_step(
        kernel_tables(static, params).data_ptr(), _ptr_array(ins), _ptr_array(outs),
        None if ptype_in is None else ptype_in.data_ptr(), None if ptype_out is None else ptype_out.data_ptr(),
        _ptr_array(s_in), _ptr_array(s_out), None if render is None else _ptr_array(render),
        frame_row, seed_row, len(seeds), N, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_step kernel launch failed: {lib.bf_error_string(rc).decode()}")
    scal = dict(zip(names, s_out))
    return fields, scal, render


def fused_step(static: SpawnerStatic, params: SpawnerParams, colliders, state: PoolState, frame: FrameInput,
               pack_render: bool = False, unroll: int = 1, stats: bool = True):
    """Advance `unroll` frames (bit-equal to that many single frames).
    Returns (state, outputs) or, with pack_render, (state, outputs, planes):
    the 9 render-pack planes of the last frame. outputs is None when
    `stats` is False (chain frames nobody reads; the finished latch is
    still updated)."""
    check_kernel_scope(static, colliders, frame, unroll)
    if state.device.type == "cuda":
        key, seeds = frame_seeds(state.rng_key.numpy(), unroll)
        fields, scal, planes = _launch(static, params, state, frame, seeds, pack_render)
        fused_step.launches += 1
        if pack_render:
            fused_step.render_launches += 1
        new_state, out = epilogue(static, params, state, fields, scal, torch.as_tensor(key.astype(np.int64)), stats)
    elif state.device.type == "cpu":
        new_state, out = plain_frames(static, params, state, frame, unroll, stats)
        planes = pack_render_planes(static, params, new_state) if pack_render else None
    else:
        raise ValueError(f"no step for device {state.device}")
    if pack_render:
        return new_state, out, tuple(planes)
    return new_state, out


fused_step.launches = 0  # kernel launches (CUDA path only)
fused_step.render_launches = 0  # of which with the render pack


def step_auto(static, params, colliders, state, frame):
    """One frame through the fused step (kernel on the card, plain version on
    the CPU). Returns (state, outputs)."""
    return fused_step(static, params, colliders, state, frame)


def step_auto_packed(static, params, colliders, state, frame):
    """step_auto plus the render extract: (state, outputs, planes), planes the
    9 render-pack planes `render.planes_to_rows` assembles into rows."""
    return fused_step(static, params, colliders, state, frame, pack_render=True)


def chain_shape(n_frames: int) -> list:
    """Frames per launch of an n-frame chain: q launches of MAX_UNROLL, then
    the remainder as single frames (the JAX package's _chain_with_unroll)."""
    if n_frames < MAX_UNROLL:
        return [1] * n_frames
    q, r = divmod(n_frames, MAX_UNROLL)
    return [MAX_UNROLL] * q + [1] * r


def multi_step_auto(static, params, colliders, state, frame, n_frames: int):
    """n frames with the same frame input; returns (final state, outputs of
    the last frame). Stats are computed for the last frame only; invariant
    fields (elided rotation/lifetime, single-type ptype, last_emitted) pass
    through every launch untouched."""
    if n_frames < 1:
        raise ValueError("multi_step_auto needs n_frames >= 1")
    shape = chain_shape(n_frames)
    out = None
    for i, u in enumerate(shape):
        state, out = fused_step(static, params, colliders, state, frame, unroll=u, stats=i == len(shape) - 1)
    return state, out
