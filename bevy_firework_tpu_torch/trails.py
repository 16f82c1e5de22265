"""Trail / ribbon rendering: per-particle position history and segment
records (port of `bevy_firework_tpu.trails`).

  * The history is a circular [K, N] buffer per coordinate with a head
    cursor: a frame writes one [N] row per coordinate in place
    (`index_copy_` at the 0-d device head, so nothing reads the head on
    the host) and updates the [N] validity, never a K x N shift.
  * Respawn detection needs no particle ids: a slot restarted iff it is
    alive now and either was dead at the last record, its age ran
    backwards (same-frame ring reuse reads a younger tenant), or, across a
    step_n window, it is younger than a continuing tenant could be (the
    `elapsed` rule of `update_trails`).
  * Segment extraction is a gather of K-1 row pairs behind the head cursor,
    packed into 64-byte records whose invalid rows carry width 0, the key
    the dense compaction (`native.compact_dense`) drops; on the card
    `compact_segments` selects the same columns on the device, so only the
    count x 64 bytes of kept rows cross to the host.

Segment record (16 f32 = 64 B):

    [p0.x, p0.y, p0.z, w0,  p1.x, p1.y, p1.z, w1,  r, g, b, a0,  r, g, b, a1]

p0 is the newer end (toward the particle), p1 the older; w* are world-space
ribbon half-widths; the colour is the particle's current base colour with
the alpha tapered toward the tail.

A trail state updates in place, as the JAX package's donated one does: the
returned state holds the argument's buffers, so the argument is not reused
by the caller. Its `prev_age` and `prev_alive` are the trail's own buffers,
written with `copy_` from the pool: they never alias a pool plane, which a
later step, a Scene edit (`set_enabled`, a group's restack or
`take_insert`) or the carried claim's bookkeeping on the alive plane may
replace or rewrite.

Group batching: when every member of an archetype group is trailed with
equal TrailSettings, the Scene updates the whole group's [S, K, N] stack in
one set of ops (`update_trails_stacked`, a head per slot); members read
their row lazily, as they read their pool row.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .pool import PoolState
from .render import FireworkUniform, compute_render_fields
from .utils.device import DEFAULT_DEVICE, resolve_device

TRAIL_FIELDS = ("hx", "hy", "hz", "hcount", "head", "prev_age", "prev_alive")


@dataclasses.dataclass(frozen=True)
class TrailSettings:
    """Per-spawner trail config (`length` sizes the history buffer and the
    packed segment count)."""

    length: int = 8  # history points K (>= 2); up to K-1 segments drawn
    width: float = 0.25  # ribbon half-width as a fraction of particle scale
    taper: bool = True  # linearly taper width and alpha toward the tail

    def __post_init__(self):
        if self.length < 2:
            raise ValueError("TrailSettings.length must be >= 2")
        if self.width <= 0.0:
            raise ValueError("TrailSettings.width must be > 0 (w == 0 is the compaction drop key)")


@dataclasses.dataclass(frozen=True)
class TrailState:
    """Circular position history of one spawner's pool ([K, N] leaves), or
    of a group's pools stacked on a leading slot axis ([S, K, N], a head
    per slot)."""

    hx: torch.Tensor  # [K, N] f32
    hy: torch.Tensor  # [K, N] f32
    hz: torch.Tensor  # [K, N] f32
    hcount: torch.Tensor  # [N] int32: valid history points per slot (0..K)
    head: torch.Tensor  # 0-d int32: row of the most recent point
    prev_age: torch.Tensor  # [N] f32: age at the last recorded point
    prev_alive: torch.Tensor  # [N] bool

    @property
    def length(self) -> int:
        return self.hx.shape[-2]

    @property
    def capacity(self) -> int:
        return self.hx.shape[-1]


def init_trail_state(settings: TrailSettings, capacity: int, device=DEFAULT_DEVICE) -> TrailState:
    """An empty history on `device` (every buffer its own: the state
    updates in place)."""
    dev = resolve_device(device)
    k, n = int(settings.length), int(capacity)

    def z():
        return torch.zeros((k, n), dtype=torch.float32, device=dev)

    return TrailState(
        hx=z(), hy=z(), hz=z(),
        hcount=torch.zeros((n,), dtype=torch.int32, device=dev),
        head=torch.zeros((), dtype=torch.int32, device=dev),
        prev_age=torch.zeros((n,), dtype=torch.float32, device=dev),
        prev_alive=torch.zeros((n,), dtype=torch.bool, device=dev),
    )


def trail_slot(trails: TrailState, i: int) -> TrailState:
    """Slot i of a stacked trail state: views of the stacked leaves."""
    return TrailState(**{k: getattr(trails, k)[i] for k in TRAIL_FIELDS})


def stack_trails(trails) -> TrailState:
    """Stack S trail states of one length and capacity (new buffers)."""
    return TrailState(**{k: torch.stack([getattr(t, k) for t in trails]) for k in TRAIL_FIELDS})


def update_trails(trail: TrailState, state: PoolState, elapsed=None) -> TrailState:
    """Record one history point from the post-step pool state, in place
    (see the module docstring); returns the state.

    Call after stepping (Scene does this for trailed spawners). Slots that
    (re)started since the last recorded point (newly alive, age running
    backwards, or, given `elapsed`, younger than a continuing tenant could
    be) restart their history at the current position; stale rows behind
    them are hidden by hcount.

    elapsed: sim time advanced since the previous recorded point (n * dt
    after a step_n window; Scene passes it on every step). A slot whose
    tenant died inside the window and was re-claimed can come back older
    than the previous record; a continuing tenant carries exactly
    prev_age + elapsed while a re-tenant carries age <= elapsed, so
    `age < prev_age * 0.5 + elapsed` separates them with an f32 margin of
    prev_age / 2.

    Works on a solo state ([K, N], 0-d head) and on a stacked one ([S, K, N]
    trails over an [S, N] pool, a head per slot)."""
    k = trail.length
    restarted = state.alive & (~trail.prev_alive | (state.age < trail.prev_age))
    if elapsed is not None:
        restarted = restarted | (state.alive & (state.age < trail.prev_age * 0.5 + float(elapsed)))
    hcount = torch.where(state.alive, torch.where(restarted, 1, torch.clamp_max(trail.hcount + 1, k)), 0)
    trail.head.add_(1).remainder_(k)
    if trail.head.dim() == 0:
        idx = trail.head.to(torch.int64).view(1)
        for h, p in ((trail.hx, state.px), (trail.hy, state.py), (trail.hz, state.pz)):
            h.index_copy_(0, idx, p.unsqueeze(0))
    else:  # stacked: row head[s] of slot s
        idx = trail.head.to(torch.int64).view(-1, 1, 1).expand(-1, 1, trail.capacity)
        for h, p in ((trail.hx, state.px), (trail.hy, state.py), (trail.hz, state.pz)):
            h.scatter_(1, idx, p.unsqueeze(1))
    trail.hcount.copy_(hcount)
    # the trail's own buffers (module docstring): never the pool's planes
    trail.prev_age.copy_(state.age)
    trail.prev_alive.copy_(state.alive)
    return trail


def update_trails_stacked(trails: TrailState, states: PoolState, elapsed=None) -> TrailState:
    """`update_trails` over a group's stacked [S, K, N] trails and [S, N]
    pool in one set of ops (a head per slot); in place, as update_trails."""
    if trails.head.dim() != 1:
        raise ValueError("update_trails_stacked takes stacked trails (a head per slot)")
    return update_trails(trails, states, elapsed)


def pack_trail_segments(settings: TrailSettings, params, state: PoolState, trail: TrailState,
                        type_index: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense segment planes [16, (K-1)*N] f32 and the valid-segment count.

    Row s of the (K-1)-stack joins history points s and s+1 behind the head;
    a segment is valid iff its slot is alive, of `type_index`, and has
    recorded both endpoints (hcount >= s+2). Invalid lanes carry w0 == 0,
    the dense pack's drop key, so `compact_segments` (or
    `native.compact_dense` of the planes on the host) yields the final
    [count, 16] records. The count is the number of w0 > 0 rows: a valid
    segment whose scale curve evaluates to exactly 0 drops."""
    k = settings.length
    dev = trail.hx.device
    s = torch.arange(k - 1, dtype=torch.int32, device=dev)  # segment index, 0 = newest
    # one K-row gather per coordinate (newest first); consecutive rows are
    # the segment endpoints
    idx = torch.remainder(trail.head - torch.arange(k, dtype=torch.int32, device=dev) + 2 * k, k).to(torch.int64)
    hx, hy, hz = trail.hx.index_select(0, idx), trail.hy.index_select(0, idx), trail.hz.index_select(0, idx)
    p0 = (hx[:-1], hy[:-1], hz[:-1])  # each [K-1, N]
    p1 = (hx[1:], hy[1:], hz[1:])

    sel = state.alive & (state.ptype == type_index)
    valid = sel[None, :] & (trail.hcount[None, :] >= (s + 2)[:, None])

    scale, base, _emis = compute_render_fields(params, state, type_index)
    if settings.taper:
        t0 = (1.0 - s.to(torch.float32) / np.float32(k - 1))[:, None]
        t1 = (1.0 - (s + 1).to(torch.float32) / np.float32(k - 1))[:, None]
    else:
        t0 = torch.ones((k - 1, 1), dtype=torch.float32, device=dev)
        t1 = t0
    half_w = scale[None, :] * np.float32(settings.width)
    w0 = torch.where(valid, half_w * t0, 0.0)
    w1 = (half_w * t1).expand(k - 1, -1)

    count = (w0 > 0).sum(dtype=torch.int32)

    def bc(x):
        return x[None, :].expand(k - 1, -1)

    planes = torch.stack([
        p0[0], p0[1], p0[2], w0,
        p1[0], p1[1], p1[2], w1,
        bc(base[0]), bc(base[1]), bc(base[2]), base[3][None, :] * t0,
        bc(base[0]), bc(base[1]), bc(base[2]), base[3][None, :] * t1,
    ]).reshape(16, -1)
    return planes, count


def compact_segments(planes: torch.Tensor) -> torch.Tensor:
    """The kept columns of dense segment planes as [count, 16] rows, on the
    planes' device: the columns whose w0 (plane 3) is not 0, in column
    order ((segment, lane), segment-major), `native.compact_dense`'s rule
    and row order. One selection on the device; copying the result to the
    host moves count x 64 bytes, not the dense planes."""
    keep = planes[3] != 0.0
    return planes[:, keep].t().contiguous()


@dataclasses.dataclass(frozen=True)
class TrailItem:
    """One ribbon draw's worth of data, per (spawner x non-empty type)."""

    spawner_id: int
    type_index: int
    segments: np.ndarray  # [count, 16] f32 (see module docstring layout)
    count: int
    uniform: FireworkUniform
    layers: int = 1  # RenderLayers bitmask carried from the spawner


def sort_segments_back_to_front(segments: np.ndarray, camera_pos) -> np.ndarray:
    """Stable farthest-first reorder by segment midpoint distance (the
    ribbon analog of `render.sort_instances_back_to_front`)."""
    if segments.shape[0] <= 1:
        return segments
    cam = np.asarray(camera_pos, np.float32).reshape(3)
    mid = 0.5 * (segments[:, 0:3] + segments[:, 4:7]) - cam
    d2 = (mid * mid).sum(axis=1)
    return segments[np.argsort(-d2, kind="stable")]


def trail_to_numpy(trail: TrailState) -> dict:
    """The trail's leaves as numpy in the JAX package's dtypes (the
    checkpoint's `trail_{sid}.npz`)."""
    return {k: getattr(trail, k).cpu().numpy() for k in TRAIL_FIELDS}


def trail_from_numpy(leaves: dict, device=DEFAULT_DEVICE) -> TrailState:
    """A trail state from numpy leaves (own copies on `device`)."""
    dev = resolve_device(device)
    dtypes = {"hcount": torch.int32, "head": torch.int32, "prev_alive": torch.bool}
    return TrailState(**{k: torch.as_tensor(np.array(leaves[k], copy=True), device=dev).to(
        dtypes.get(k, torch.float32)) for k in TRAIL_FIELDS})

