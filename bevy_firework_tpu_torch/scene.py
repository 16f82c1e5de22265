"""Host facade: the engine's runtime API (port of `bevy_firework_tpu.scene`,
with archetype groups).

    scene = Scene(colliders=[...], force_fields=[...])   # on the card; device="cpu" for the CPU
    sid = scene.add_spawner(ParticleSpawner(...), capacity=65536, transform=Transform(...))
    scene.step(dt)                      # every spawner, one frame
    scene.queue_particles(sid, 5)       # ParticleSpawnerData::queue_particles
    scene.render_items()                # per (spawner x non-empty type) draws
    scene.on_finished(sid, callback)    # ParticleSpawnerFinished observer
    scene.enable_async_render(); scene.render_async()   # pipelined extract
    scene.add_spawner(sp, trail=TrailSettings(length=16)); scene.trail_items()
    scene.enable_async_events(); scene.flush_events()   # events one frame late

Spawners of equal (SpawnerStatic, capacity) form an archetype group, as in
the JAX Scene (its `scene.py:62-75`); members may differ in params,
transforms and seeds. A group of two or more of a global-only archetype
steps as one fleet chain (`fused_step_fleet`; n frames: the fleet chain,
and with the render pack n - 1 fleet frames and one packed launch) and
keeps its results stacked between frames (`_GroupBatch`): members read
their pool, outputs and render planes as views of their row. A group
without a destroyed-particle handler and without a trailed member keeps
the JAX Scene's padded, hole-stable rows: each member keeps its row for its
life, a removal leaves a hole, an add takes the lowest hole first, and the
stack has `_pad_target(n)` rows (the next multiple of 8), the rows no
member holds being fresh, dead, disabled pools (a removal's hole gets one
at the restack that makes it); other groups stack their members in
order. An edit to a member
(`queue_particles`, `set_enabled`, `set_spawner`) takes its row off the
batch, and the next step gathers the kept rows on the device and inserts
the changed ones (`take_insert`). A group of one steps through
`multi_step_auto` (or `multi_step_auto_packed` once something renders)
with the kernel's stats, at n = 1 `step_auto` (`step_auto_packed`); the
members of a nested group step one by one through the hybrid frame, as
`step_auto_fleet` does. Per-member results equal solo steps bit for bit.
On the card the hand-written kernels run them, on the CPU their plain
versions.

On the card a step is one captured CUDA graph (`ops.chain_graph`), the
counterpart of the JAX Scene's one jitted program per frame
(`_scene_step_combined`): its segments are every group's chain in group
order, its signature the segments' graph keys with the frame count and
the render-pack flag (no value: a churn within a pad class keeps it). A
signature's first step runs uncaptured and captures nothing; the step
that meets it again captures it (`chain_graph.replay_segments(defer=
True)`), so a signature met once costs no capture; a step captures at
most one graph. A replay writes every segment's host words with one
pinned copy, copies the inputs in, replays once and clones the results
out. Past `combined_signature_limit` distinct signatures the scene
replays one graph per group instead, as the JAX Scene switches to one
dispatch per group. The restacks, trail updates and event reads run
outside the graph.

The scene's colliders and force fields live
on the scene's device; their tables are rebuilt when an edit changes them,
and slots freed by a removal are reused by a later add of the same kind, as
the JAX Scene does. Destroyed-particle handlers and `on_finished` observers
run inside the step that produced their events, or, with
`enable_async_events`, at the start of the next step (or `flush_events`):
the frame's event payload (finished flag, destroyed count, the first
`DUMP_COMPACT_M` destroyed lanes' dump fields) is built on the device with
no host wait and copied on a copy stream into a pinned host buffer while
the next frame steps.

Trailed spawners (`add_spawner(trail=TrailSettings(...))`) record one
history point per `step` / `step_n` (`trails.update_trails`); a group whose
members are all trailed alike updates its stacked trails in one set of ops,
members reading their row lazily. `trail_items` packs the segments and, on
the card, compacts them on the device, so only the kept rows are copied.
Checkpoints: `checkpoint.save_scene` / `load_scene`.

Nested spawners (textures, fireworks) step hybrid frames; `nested_buffer`
sizes their per-emitter child buffer.

The pipelined render extract (`enable_async_render`) gives every spawner an
`AsyncRenderReader`: each `step` hands it the frame's render pack (the
kernel's planes; the dense pack for other types), copied on the reader's
copy stream while the next frame steps; `render_async` returns the newest
frame the reader has finished.

Differences from the reference by design (as in the JAX package): time is
an input (`step(dt)`), parent velocity and the effect modifier are explicit
setters, and `set_spawner` resets the pool (`core.rs:343-365`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .colliders import _HULL_PAD_D, COLLIDER_HULL, HULL_MAX_PLANES, Collider, ColliderTable, empty_collider_table
from .compiled import CompiledSpawner, compile_spawner
from .curve import CURVE_CONSTANT, CURVE_EVEN
from .force_fields import FieldTable, ForceField, _unit, compile_force_fields
from .ops import chain_graph
from .ops.fused_step import can_fleet
from .parallel.sharding import (
    num_slots,
    outputs_slot,
    stack_frames,
    stack_params,
    stack_pools,
    state_slot,
    take_insert,
)
from .pool import init_pool_for, make_frame_input
from .render import (
    ORDER_DEPENDENT_ALPHA_MODES,
    RenderItem,
    aabb_intersects_frustum,
    compact_dense,
    frustum_planes,
    make_uniform,
    pack_instances,
    pack_instances_dense,
    planes_to_rows,
    sort_instances_back_to_front,
)
from .settings import EffectModifier, EmissionModeKind, EmissionPacingKind, ParticleSpawner, SpawnTransformMode
from .trails import (
    TRAIL_FIELDS,
    TrailItem,
    TrailState,
    compact_segments,
    init_trail_state,
    pack_trail_segments,
    sort_segments_back_to_front,
    stack_trails,
    trail_slot,
    update_trails,
    update_trails_stacked,
)
from .utils.device import DEFAULT_DEVICE, resolve_device

_DUMP_FIELDS = ("px", "py", "pz", "vx", "vy", "vz", "qx", "qy", "qz", "qw", "wx", "wy", "wz", "initial_scale", "age",
                "lifetime", "ptype")

# Destroyed lanes whose dump fields an async event payload carries per
# spawner and frame (the JAX Scene's _DUMP_COMPACT_M); a frame destroying
# more is delivered from the state at delivery time.
DUMP_COMPACT_M = 1024

# estimate_capacity rounds large pools up to the JAX package's 8192-lane
# kernel tile, so both packages size a spawner's pool alike
_CAPACITY_TILE = 8192
# estimate_capacity's allowance per on-demand emitter (caller-driven volume)
_ON_DEMAND_ALLOWANCE = 256


@dataclasses.dataclass(frozen=True)
class Transform:
    translation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rotation: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)  # xyzw


def estimate_capacity(spawner: ParticleSpawner, headroom: float = 1.5) -> int:
    """Steady-state live-particle estimate for a spawner, with headroom (the
    JAX package's rule): rate emitters count/duration x max lifetime,
    one-shots their burst, nested emitters count per parent x parents,
    on-demand a default allowance; rounded up to 8192 lanes when large, else
    to a power of two >= 256."""
    per_type = [0.0] * len(spawner.particle_settings)
    for es in spawner.emission_settings:
        ps = spawner.particle_settings[es.particle_index]
        life = max(ps.lifetime.min, ps.lifetime.max)
        p = es.emission_pacing
        if p.kind == EmissionPacingKind.ONE_SHOT:
            per_type[es.particle_index] += p.count
        elif p.kind == EmissionPacingKind.COUNT_OVER_DURATION:
            if es.emission_mode.kind == EmissionModeKind.NESTED:
                parents = per_type[es.emission_mode.target_particle_type]
                tps = spawner.particle_settings[es.emission_mode.target_particle_type]
                plife = max(max(tps.lifetime.min, tps.lifetime.max), 1e-6)
                per_type[es.particle_index] += parents * p.count * min(life / plife, 1.0) + p.count
            else:
                per_type[es.particle_index] += p.count / max(p.duration, 1e-6) * life
        else:
            per_type[es.particle_index] += _ON_DEMAND_ALLOWANCE
    total = int(sum(per_type) * headroom) + 64
    if total > _CAPACITY_TILE // 2:
        return -(-total // _CAPACITY_TILE) * _CAPACITY_TILE
    return max(256, 1 << (total - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class DestroyedParticle:
    """Host-side mirror of `ParticleData` handed to `particles_destroyed`
    handlers (`core.rs:164-167,660-667`)."""

    position: Tuple[float, float, float]
    velocity: Tuple[float, float, float]
    rotation: Tuple[float, float, float, float]
    angular_velocity: Tuple[float, float, float]
    initial_scale: float
    scale: float
    age: float
    lifetime: float
    base_color: Tuple[float, float, float, float]
    emissive_color: Tuple[float, float, float, float]
    pbr: bool


def _curve_many(curve, t):
    """Vectorised host evaluation of a curve or gradient at many t (numpy
    f32, the interpolation cases of `FireworkCurve.sample_clamped`)."""
    t = np.asarray(t, np.float32)
    vs = np.asarray(curve.vs, dtype=np.float32)
    if curve.kind == CURVE_CONSTANT:
        return np.broadcast_to(vs[0], t.shape + vs[0:1].shape[1:]).astype(np.float32)
    if curve.kind == CURVE_EVEN:
        n = len(curve.vs)
        x = np.clip(t, 0.0, 1.0) * np.float32(n - 1)
        i = np.minimum(np.floor(x).astype(np.int64), n - 2)
        frac = (x - i.astype(np.float32)).astype(np.float32)
    else:
        ts = np.asarray(curve.ts, dtype=np.float32)
        tc = np.clip(t, ts[0], ts[-1]).astype(np.float32)
        i = np.clip(np.searchsorted(ts, tc, side="right") - 1, 0, len(ts) - 2)
        frac = ((tc - ts[i]) / (ts[i + 1] - ts[i])).astype(np.float32)
    if vs.ndim > 1:
        frac = frac[..., None]
    return (vs[i] + (vs[i + 1] - vs[i]) * frac).astype(np.float32)


def event_payload(states, outputs, n_frames: int, dump: bool, m: int = DUMP_COMPACT_M) -> torch.Tensor:
    """A step's event payload of one spawner or an [S]-stacked group, on the
    pool's device with nothing read on the host: [S, R, W] f32 (S = 1 for a
    solo pool). Row R - 1 holds in column 0 the destroyed count and in
    column 1 the finished flag (this frame's event; the finished latch after
    an n-frame window). With `dump`, rows 0 .. R - 2 are the dump fields
    (`_DUMP_FIELDS`) of the first W = min(m, N) destroyed lanes in lane
    order: each destroyed lane's exclusive rank (a cumsum) scatters its lane
    index into column rank, the columns past the count reading lane 0.
    Without, W = 2 and only the last row."""
    fin = outputs.finished_event if n_frames == 1 else states.finished_notified
    fin = fin.reshape(-1).to(torch.float32)
    s = fin.shape[0]
    dev = states.px.device
    if not dump:
        return torch.stack([torch.zeros_like(fin), fin], -1).unsqueeze(1)
    n = states.capacity
    mask = outputs.destroyed_mask.reshape(s, n)
    width = max(2, min(int(m), n))
    mi = mask.to(torch.int32)
    rank = torch.cumsum(mi, -1, dtype=torch.int32) - mi
    col = torch.where(mask & (rank < width), rank, width).to(torch.int64)
    lanes = torch.zeros((s, width + 1), dtype=torch.int64, device=dev)
    lanes.scatter_(1, col, torch.arange(n, device=dev).expand(s, n))  # column `width` collects the rest
    # one stack and one gather of every dump field (a few launches, not one per field)
    fields = torch.stack([getattr(states, k).reshape(s, n).to(torch.float32) for k in _DUMP_FIELDS], 1)
    rows = fields.gather(2, lanes[:, None, :width].expand(s, len(_DUMP_FIELDS), width))
    tail = torch.zeros((s, 1, width), dtype=torch.float32, device=dev)
    tail[:, 0, 0] = mi.sum(-1)
    tail[:, 0, 1] = fin
    return torch.cat([rows, tail], 1)


class _SpawnerSlot:
    """One spawner's host-side record: its settings, pool, last outputs and
    render planes, transform, per-frame inputs and observers. A member of
    an archetype group reads its pool, outputs and planes as views of its
    row of the group's stacked batch (`attach`); setting any of them, or
    `detach`, makes them the member's own again."""

    def __init__(self, spawner, compiled, state, capacity, transform, global_transform, modifier, seed, layers,
                 trail_settings=None, trail_state=None):
        self.spawner = spawner
        self.compiled = compiled
        self._state = state
        self._outputs = None
        self._planes = None
        self._batch = None  # (_GroupBatch, row) while the group's batch holds this member
        self.capacity = capacity
        self.transform = transform
        self.global_transform = global_transform
        self.parent_velocity = (0.0, 0.0, 0.0)
        self.modifier = modifier
        self.finished_observers: List[Callable[[int], None]] = []
        self.finished_fired = False
        self.seed = seed
        self.layers = layers  # RenderLayers bitmask (render.rs:414-418)
        self.frame_cache = None  # (dt, field table, FrameInput)
        self.trail_settings = trail_settings
        self._trail = trail_state  # None while the group's stacked trails hold this member's row

    def attach(self, batch, row: int, trails_on_batch: bool = False):
        """Point the member at its row of a freshly stepped batch.
        trails_on_batch: the caller installs the group's stacked trails on
        the batch this frame; otherwise a member whose trail was a row of
        the old batch's stacked trails takes its own copy first."""
        self._trail = None if trails_on_batch else self._own_trail()
        self._batch = (batch, row)
        self._state = self._outputs = self._planes = None

    def _own_trail(self):
        """This member's trail as its own buffers: a copy of its row where
        the old batch's stacked trails hold it (the stack updates in place
        while it stays a group's)."""
        if self._trail is None and self._batch is not None and self._batch[0].trails is not None:
            row = trail_slot(self._batch[0].trails, self._batch[1])
            return TrailState(**{k: getattr(row, k).clone() for k in TRAIL_FIELDS})
        return self._trail

    def detach(self):
        """Take this member's views off the group's batch (they stay valid:
        a step writes new tensors, never the batch's); its trail becomes
        its own."""
        if self._batch is not None:
            batch, row = self._batch
            self._state, self._outputs, self._planes = batch.state(row), batch.outputs(row), batch.planes(row)
            self._trail = self._own_trail()
            self._batch = None

    @property
    def trail_state(self):
        """The trail (None for an untrailed spawner): a view of this member's
        row of the group's stacked trails while they hold it."""
        if self._trail is None and self._batch is not None and self._batch[0].trails is not None:
            return self._batch[0].trail(self._batch[1])
        return self._trail

    @trail_state.setter
    def trail_state(self, value):
        self._trail = value

    @property
    def state(self):
        return self._batch[0].state(self._batch[1]) if self._batch is not None else self._state

    @state.setter
    def state(self, value):
        self.detach()
        self._state = value

    @property
    def outputs(self):
        return self._batch[0].outputs(self._batch[1]) if self._batch is not None else self._outputs

    @outputs.setter
    def outputs(self, value):
        self.detach()
        self._outputs = value

    @property
    def render_planes(self):
        return self._batch[0].planes(self._batch[1]) if self._batch is not None else self._planes

    @render_planes.setter
    def render_planes(self, value):
        self.detach()
        self._planes = value


class _GroupBatch:
    """Stacked authority for one archetype group after a fleet step (the
    JAX Scene's `_GroupBatch`): the group's [S]-stacked pool, outputs and
    render planes, member sids[j] at row rows[j]. pad: the stack's row
    count in a padded group (rows no member holds are padding or holes
    that nobody reads), None in a group stacked in member order. In the
    steady state the next step takes `states` as it is; members read their
    rows as views, made at the first read."""

    def __init__(self, sids: tuple, rows: tuple, pad, states, outputs, planes):
        self.sids = sids
        self.rows = rows
        self.pad = pad
        self.states = states
        self.stacked_outputs = outputs
        self.stacked_planes = planes
        self.trails = None  # the members' stacked TrailState when all are trailed alike
        self._views = {}

    def _view(self, kind: str, row: int, make):
        key = (kind, row)
        if key not in self._views:
            self._views[key] = make()
        return self._views[key]

    def state(self, row: int):
        return self._view("s", row, lambda: state_slot(self.states, row))

    def outputs(self, row: int):
        if self.stacked_outputs is None:
            return None
        return self._view("o", row, lambda: outputs_slot(self.stacked_outputs, row))

    def planes(self, row: int):
        if self.stacked_planes is None:
            return None
        return self._view("p", row, lambda: tuple(p[row] for p in self.stacked_planes))

    def trail(self, row: int):
        return self._view("t", row, lambda: trail_slot(self.trails, row))


def _pad_target(n: int) -> int:
    """A padded group's row count for n members (the JAX Scene's): the
    next multiple of 8, at least 8, so a +-1 churn keeps the stack's
    shapes and the scene's signature."""
    return max(8, -(-n // 8) * 8)


@dataclasses.dataclass
class _Plan:
    """One archetype group's step, assembled before the scene's graph runs:
    its chains (`chain_graph` segments: (kind, static, params, colliders,
    state, frame, n_frames)), one per member stepping solo or one fleet
    chain; a fleet group's rows, pad and the stacked trails it updates."""

    key: tuple
    sids: tuple
    slots: list
    segments: list
    rows: Optional[tuple] = None
    pad: Optional[int] = None
    trails: object = None


@dataclasses.dataclass
class _ColliderSlot:
    """Host master copy of one collider-table row; `kind`, `identity_rot`
    and the hull's plane count decide whether a freed slot can be reused."""

    kind: int
    identity_rot: bool
    position: Tuple[float, float, float]
    rotation: Tuple[float, float, float, float]
    params: Tuple[float, ...]
    layers: int
    active: bool
    planes: Tuple[Tuple[float, float, float, float], ...] = ()  # hull only


@dataclasses.dataclass
class _FieldSlot:
    """Host master copy of one force-field row."""

    kind: int
    position: Tuple[float, float, float]
    axis: Tuple[float, float, float]
    strength: float
    radius: float
    frequency: float
    phase: float
    active: bool


def _is_identity_rot(rotation) -> bool:
    return tuple(float(r) for r in rotation) == (0.0, 0.0, 0.0, 1.0)


class Scene:
    def __init__(self, colliders: Optional[List[Collider]] = None, seed: int = 0,
                 force_fields: Optional[List[ForceField]] = None, combined_signature_limit: int = 16,
                 device=DEFAULT_DEVICE):
        """A scene whose spawners, collider table and force fields live on
        `device` (the card unless the caller passes "cpu"; raises without a
        card).

        combined_signature_limit bounds the capture hitches of the
        one-graph-per-step design, as it bounds the JAX Scene's compile
        hitches: each distinct scene signature (the groups' archetypes and
        padded sizes, their pools', tables', colliders' and fields' shapes,
        the frame count, the render pack) a step meets costs one uncaptured
        step, and a capture of the whole scene's graph when a later step
        meets it again. A scene with a
        bounded set of archetypes stays under the limit and replays one
        graph per step; one that keeps meeting new signatures crosses it
        and from then on replays one graph per group (a new archetype then
        captures only its own group's graph, for one replay per group and
        step). Both modes give the same results bit for bit; on the CPU
        the same bookkeeping runs and the groups step uncaptured."""
        self.device = resolve_device(device)
        self._collider_slots: List[_ColliderSlot] = []
        self._collider_ids: Dict[int, int] = {}  # cid -> slot index
        self._next_collider_id = 0
        self._collider_table: Optional[ColliderTable] = None  # cache; None = dirty
        self._field_slots: List[_FieldSlot] = []
        self._field_ids: Dict[int, int] = {}  # fid -> slot index
        self._next_field_id = 0
        self._field_table: Optional[FieldTable] = None  # cache; None = dirty
        self._spawners: Dict[int, _SpawnerSlot] = {}
        self._next_id = 0
        # Render-demand gate (the JAX Scene's): the in-kernel render pack
        # writes 9 planes nobody reads while no one renders, so headless
        # stepping leaves it off. render_items turns it on for good; the
        # call that turns it on falls back to the dense pack for that frame.
        self._render_demand = False
        # pipelined render extract (enable_async_render): a reader per
        # spawner, the step count it stamps frames with, the ring slots the
        # last render_async holds and the newest frame delivered per item
        self._async_enabled = False
        self._async_slots = 3
        self._async_readers: Dict[int, object] = {}
        self._async_frame_id = 0
        self._async_acquired: List[tuple] = []
        self._async_seen_fid: Dict[tuple, int] = {}
        # deferred events (enable_async_events): each step's payloads, in
        # flight to pinned host buffers (reused per key and shape) on a copy
        # stream, delivered at the start of the next step
        self._async_events = False
        self._pending_events: List[tuple] = []
        self._event_buffers: Dict[tuple, torch.Tensor] = {}
        self._event_stream = None
        self._compile_cache: Dict[tuple, CompiledSpawner] = {}
        # archetype groups: (static, capacity) -> the last step's stacked
        # batch (groups of two or more), and the group's stacked inputs,
        # kept while unchanged: (member params, their table source) and
        # (member frames, the stacked FrameInput with its device records)
        self._batches: Dict[tuple, _GroupBatch] = {}
        self._group_inputs: Dict[tuple, dict] = {}
        self._last_step_dispatches = 0  # archetype groups stepped by the last step
        self._combined_limit = int(combined_signature_limit)
        self._combined_signatures: set = set()
        self._per_group_mode = False
        # testing and timing seams: _captured (multi_step_auto's) False
        # steps every chain's launches one by one on the card; _padded
        # False stacks every group's members in order, unpadded
        self._captured = True
        self._padded = True
        self._seed = seed
        self._last_dt = 0.0
        self.time = 0.0
        for col in colliders or []:
            self.add_collider(col)
        for ff in force_fields or []:
            self.add_force_field(ff)

    # ------------------------------------------------------------- authoring
    def add_spawner(self, spawner: ParticleSpawner, capacity: Optional[int] = None,
                    transform: Optional[Transform] = None, global_transform: Optional[Transform] = None,
                    modifier: Optional[EffectModifier] = None, sid: Optional[int] = None,
                    nested_buffer: int = 4096, trail=None, layers: int = 1) -> int:
        """Add a spawner; returns its id. capacity=None sizes the pool with
        `estimate_capacity`. sid: an explicit id (fresh ids continue above
        it). layers: the RenderLayers bitmask that render_items(view_layers=)
        and trail_items(view_layers=) filter on. trail: TrailSettings gives
        the spawner ribbon trails: each step records one history point,
        `trail_items` draws them."""
        if capacity is None:
            capacity = estimate_capacity(spawner)
        if sid is None:
            sid = self._next_id
            self._next_id += 1
        else:
            if sid in self._spawners:
                raise ValueError(f"spawner id {sid} already in use")
            self._next_id = max(self._next_id, sid + 1)
        compiled = self._compile(spawner, nested_buffer)
        seed = self._seed + sid
        t = transform or Transform()
        self._spawners[sid] = _SpawnerSlot(
            spawner, compiled, init_pool_for(compiled, capacity, seed), capacity, t, global_transform or t,
            modifier or EffectModifier(), seed, layers, trail,
            init_trail_state(trail, capacity, self.device) if trail is not None else None)
        return sid

    def _compile(self, spawner: ParticleSpawner, nested_buffer: int) -> CompiledSpawner:
        """compile_spawner on the scene's device, memoised per (settings,
        nested_buffer) where the settings hash."""
        try:
            key = (spawner, int(nested_buffer))
            compiled = self._compile_cache.get(key)
        except TypeError:  # unhashable settings: compile fresh
            key, compiled = None, None
        if compiled is None:
            compiled = compile_spawner(spawner, nested_buffer=nested_buffer, device=self.device)
            if key is not None:
                self._compile_cache[key] = compiled
        return compiled

    def set_layers(self, sid: int, layers: int):
        """Move a spawner to other render layers (host metadata; no reset)."""
        self._spawners[sid].layers = int(layers)

    def remove_spawner(self, sid: int):
        del self._spawners[sid]
        reader = self._async_readers.pop(sid, None)
        if reader is not None:
            self._async_acquired = [(r, t) for r, t in self._async_acquired if r is not reader]
            reader.close()

    def set_spawner(self, sid: int, spawner: ParticleSpawner):
        """Settings change => full re-sync, clearing live particles
        (`core.rs:343-365`)."""
        slot = self._spawners[sid]
        slot.spawner = spawner
        slot.compiled = self._compile(spawner, slot.compiled.static.nested_m)
        slot.state = init_pool_for(slot.compiled, slot.capacity, slot.seed)
        slot.outputs = None
        slot.render_planes = None
        slot.finished_fired = False
        if slot.trail_settings is not None:  # the re-sync clears the history too
            slot.trail_state = init_trail_state(slot.trail_settings, slot.capacity, self.device)

    # ------------------------------------------------------------- colliders
    def set_colliders(self, colliders: List[Collider]):
        """Replace the whole collider set."""
        self._collider_slots = []
        self._collider_ids = {}
        self._collider_table = None
        for col in colliders or []:
            self.add_collider(col)

    def add_collider(self, collider: Collider) -> int:
        """Add a collider; returns a handle for remove/set_collider. A slot
        freed by remove_collider is reused when its kind, its hull plane
        count and its rotation path fit (an unrotated slot takes only
        unrotated colliders), so remove + re-add cycles keep the table's
        layout."""
        col_identity = _is_identity_rot(collider.rotation)
        idx = None
        for i, slot in enumerate(self._collider_slots):
            if (not slot.active and i not in self._collider_ids.values() and slot.kind == collider.kind
                    and (not slot.identity_rot or col_identity) and len(slot.planes) == len(collider.planes)):
                idx = i
                break
        new_slot = _ColliderSlot(
            kind=int(collider.kind),
            identity_rot=col_identity if idx is None else self._collider_slots[idx].identity_rot,
            position=tuple(float(v) for v in collider.position),
            rotation=tuple(float(v) for v in collider.rotation),
            params=tuple(float(v) for v in collider.params),
            layers=int(collider.layers),
            planes=tuple(tuple(float(x) for x in pl) for pl in collider.planes),
            active=True,
        )
        if idx is None:
            idx = len(self._collider_slots)
            self._collider_slots.append(new_slot)
        else:
            self._collider_slots[idx] = new_slot
        cid = self._next_collider_id
        self._next_collider_id += 1
        self._collider_ids[cid] = idx
        self._collider_table = None
        return cid

    def remove_collider(self, cid: int):
        """Disable a collider (active 0, layers masked to 0 in the kernel's
        table); the slot is kept for a later add_collider of its kind."""
        idx = self._collider_ids.pop(cid)
        self._collider_slots[idx].active = False
        self._collider_table = None

    def set_collider(self, cid: int, position=None, rotation=None, params=None, layers=None):
        """Move or re-shape a collider in place. A rotation given to a slot
        added unrotated moves the slot to the rotated path for good."""
        slot = self._collider_slots[self._collider_ids[cid]]
        if position is not None:
            slot.position = tuple(float(v) for v in position)
        if rotation is not None:
            slot.rotation = tuple(float(v) for v in rotation)
            if slot.identity_rot and not _is_identity_rot(rotation):
                slot.identity_rot = False
        if params is not None:
            slot.params = tuple(float(v) for v in params)
        if layers is not None:
            slot.layers = int(layers)
        self._collider_table = None

    @property
    def _colliders(self) -> ColliderTable:
        if self._collider_table is None:
            self._collider_table = self._build_collider_table()
        return self._collider_table

    def _build_collider_table(self) -> ColliderTable:
        slots = self._collider_slots
        c = len(slots)
        if c == 0:
            return empty_collider_table(self.device)
        params = np.zeros((c, 3), dtype=np.float32)
        for i, s in enumerate(slots):
            params[i, : len(s.params)] = s.params
        any_hull = any(s.kind == COLLIDER_HULL for s in slots)
        hp = np.zeros((c, HULL_MAX_PLANES if any_hull else 1, 4), np.float32)
        if any_hull:
            hp[:, :, 3] = _HULL_PAD_D
            for i, s in enumerate(slots):
                if s.kind == COLLIDER_HULL and s.planes:
                    hp[i, : len(s.planes)] = np.asarray(s.planes, np.float32)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

        return ColliderTable(
            kinds=tuple(s.kind for s in slots),
            identity_rot=tuple(s.identity_rot for s in slots),
            hull_counts=tuple(len(s.planes) if s.kind == COLLIDER_HULL else 0 for s in slots),
            position=t(np.array([s.position for s in slots], dtype=np.float32)),
            rotation=t(np.array([s.rotation for s in slots], dtype=np.float32)),
            params=t(params),
            layers=t(np.array([s.layers for s in slots], dtype=np.uint32).astype(np.int64)),
            active=t(np.array([s.active for s in slots], dtype=np.float32)),
            hull_planes=t(hp),
        )

    # ---------------------------------------------------------- force fields
    def add_force_field(self, field: ForceField) -> int:
        """Add a scene force field; returns a handle for remove/set_force_field.
        A slot freed by remove_force_field is reused by the next field of
        its kind."""
        idx = None
        for i, slot in enumerate(self._field_slots):
            if not slot.active and i not in self._field_ids.values() and slot.kind == field.kind:
                idx = i
                break
        new_slot = _FieldSlot(kind=int(field.kind), position=tuple(float(v) for v in field.position),
                              axis=tuple(float(v) for v in field.axis), strength=float(field.strength),
                              radius=float(field.radius), frequency=float(field.frequency),
                              phase=float(field.phase), active=True)
        if idx is None:
            idx = len(self._field_slots)
            self._field_slots.append(new_slot)
        else:
            self._field_slots[idx] = new_slot
        fid = self._next_field_id
        self._next_field_id += 1
        self._field_ids[fid] = idx
        self._field_table = None
        return fid

    def remove_force_field(self, fid: int):
        """Disable a field (active 0: it contributes nothing); the slot is
        kept for a later add_force_field of its kind."""
        idx = self._field_ids.pop(fid)
        self._field_slots[idx].active = False
        self._field_table = None

    def set_force_field(self, fid: int, position=None, axis=None, strength=None, radius=None, frequency=None,
                        phase=None):
        """Move or re-tune a field in place (stepping `phase` each frame
        animates turbulence)."""
        slot = self._field_slots[self._field_ids[fid]]
        if frequency is not None:
            if frequency <= 0:
                raise ValueError("frequency must be > 0")
            slot.frequency = float(frequency)
        if phase is not None:
            slot.phase = float(phase)
        if position is not None:
            slot.position = tuple(float(v) for v in position)
        if axis is not None:
            slot.axis = _unit(axis)
        if strength is not None:
            slot.strength = float(strength)
        if radius is not None:
            if radius <= 0:
                raise ValueError("radius must be > 0")
            slot.radius = float(radius)
        self._field_table = None

    @property
    def _force_fields(self) -> Optional[FieldTable]:
        """The FieldTable (disabled slots stay with active 0), or None when
        no field was ever added. Rebuilt after an edit; building it copies
        nothing to the device (the kernel takes its host rows)."""
        if not self._field_slots:
            return None
        if self._field_table is None:
            s = self._field_slots
            self._field_table = compile_force_fields(
                [ForceField(kind=x.kind, position=x.position, axis=x.axis, strength=x.strength, radius=x.radius,
                            frequency=x.frequency, phase=x.phase) for x in s],
                self.device, active=[x.active for x in s])
        return self._field_table

    # ------------------------------------------------------ per-spawner inputs
    def set_transform(self, sid: int, transform: Transform, global_transform: Optional[Transform] = None):
        slot = self._spawners[sid]
        slot.transform = transform
        slot.global_transform = global_transform or transform
        slot.frame_cache = None

    def set_parent_velocity(self, sid: int, velocity):
        """Host-side analog of `sync_parent_velocity` (`core.rs:705-742`)."""
        slot = self._spawners[sid]
        slot.parent_velocity = tuple(float(v) for v in velocity)
        slot.frame_cache = None

    def set_modifier(self, sid: int, modifier: EffectModifier):
        """Analog of `propagate_particle_spawner_modifier` (`core.rs:690-703`)."""
        slot = self._spawners[sid]
        slot.modifier = modifier
        slot.frame_cache = None

    def queue_particles(self, sid: int, count: int):
        """`ParticleSpawnerData::queue_particles` (`core.rs:284-286`)."""
        slot = self._spawners[sid]
        slot.state = dataclasses.replace(slot.state, manual_queued=slot.state.manual_queued + int(count))

    def set_enabled(self, sid: int, enabled: bool):
        slot = self._spawners[sid]
        slot.state = dataclasses.replace(slot.state, enabled=torch.full_like(slot.state.enabled, bool(enabled)))

    def on_finished(self, sid: int, callback: Callable[[int], None]):
        self._spawners[sid].finished_observers.append(callback)

    def enable_async_events(self):
        """Take event delivery off the step: finished callbacks and
        destroyed-particle records are delivered at the start of the next
        `step` / `step_n` (or at `flush_events`) instead of inside the step
        that produced them.

        Ordering contract: events of step N are delivered, in spawner-id
        order, before step N+1's simulation runs, exactly once, one frame
        late; spawners removed since still get theirs. `step_n` reports the
        finished latch of its window. Call flush_events() to drain the last
        frame's events.

        Each step builds its event payload on the device without waiting
        for it (`event_payload`: the finished flag, the destroyed count and
        the first DUMP_COMPACT_M destroyed lanes' dump fields, a rank and a
        scatter) and copies it on a copy stream into a pinned host buffer;
        delivery waits for that copy's event only. A frame destroying more
        than DUMP_COMPACT_M lanes in one spawner is delivered from the
        spawner's state at delivery time (the state of that frame unless
        the spawner was edited since). On the CPU the same path runs
        without streams."""
        self._async_events = True

    def flush_events(self):
        """Deliver the deferred events now (see enable_async_events), in
        spawner-id order: each spawner's finished callbacks, then its
        destroyed records."""
        pending, self._pending_events = self._pending_events, []
        deliveries = []
        for _key, sids, slots, rows_of, host, done, _payload, dt in pending:
            if done is not None:
                done.synchronize()  # the copy's own event; _payload is held until here
            rows = host.numpy()
            deliveries += [(sid, slot, rows[r], dt) for sid, slot, r in zip(sids, slots, rows_of)]
        deliveries.sort(key=lambda d: d[0])
        for sid, slot, rows, dt in deliveries:
            count, finished = rows[-1, 0], rows[-1, 1]
            if slot.finished_observers and not slot.finished_fired and finished > 0:
                self._fire_finished(sid, slot)
            if not slot.compiled.static.any_destroyed_dump or count == 0:
                continue
            if count > rows.shape[-1]:
                self._dispatch_destroyed(slot, dt)  # past the payload's window: from the state
            else:
                self._deliver_destroyed(slot, rows[:-1, :int(count)], dt)

    def _enqueue_events(self, key: tuple, sids: tuple, slots: tuple, rows: tuple, states, outputs, n_frames: int):
        """Queue this step's event payload of one spawner or group (member
        sids[j] at row rows[j] of the payload): built on the current
        stream, copied on the event copy stream into the key's pinned host
        buffer, with nothing waiting on the card."""
        payload = event_payload(states, outputs, n_frames, slots[0].compiled.static.any_destroyed_dump)
        bkey = key + (tuple(payload.shape),)
        host = self._event_buffers.get(bkey)
        done = None
        if payload.device.type == "cuda":
            if host is None:
                host = self._event_buffers[bkey] = torch.empty(payload.shape, dtype=payload.dtype, pin_memory=True)
            if self._event_stream is None:
                self._event_stream = torch.cuda.Stream(payload.device)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(payload.device))
            with torch.cuda.stream(self._event_stream):
                self._event_stream.wait_event(ready)
                host.copy_(payload, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._event_stream)
        else:
            if host is None:
                host = self._event_buffers[bkey] = torch.empty(payload.shape, dtype=payload.dtype)
            host.copy_(payload)
        self._pending_events.append((bkey, sids, slots, rows, host, done, payload, self._last_dt))

    # ------------------------------------------------------------------ step
    def _frame_for(self, slot: _SpawnerSlot, dt: float):
        ff = self._force_fields  # the cached table; a new object after an edit
        cache = slot.frame_cache
        if cache is not None and cache[0] == dt and cache[1] is ff:
            return cache[2]
        tf = slot.transform if slot.spawner.spawn_transform_mode == SpawnTransformMode.LOCAL else slot.global_transform
        frame = make_frame_input(dt, translation=tf.translation, rotation=tf.rotation,
                                 parent_velocity=slot.parent_velocity, modifier_scale=slot.modifier.scale,
                                 modifier_speed=slot.modifier.speed, force_fields=ff)
        slot.frame_cache = (dt, ff, frame)
        return frame

    def step(self, dt: float):
        """Advance every spawner one frame (spawn -> integrate -> notify);
        with the async render on, hand the frame to the readers."""
        self.time += float(dt)
        if self._async_events:
            self.flush_events()  # step N-1's events, before this step runs
        self._last_dt = float(dt)
        self._run(dt, 1)
        if self._async_enabled:
            self._async_submit_all()

    def step_n(self, dt: float, n_frames: int):
        """Advance every spawner n frames (one chain per group or solo
        spawner; on the card one graph, its signature holding n). Finished
        events are still delivered (latched via finished_notified);
        destroyed-particle handlers see the last frame's deaths only."""
        if n_frames <= 0:
            return
        self.time += float(dt) * n_frames
        if self._async_events:
            self.flush_events()
        self._last_dt = float(dt)
        self._run(dt, n_frames)

    def _run(self, dt: float, n_frames: int):
        """Step every archetype group: spawners of equal (SpawnerStatic,
        capacity) form one group (the JAX Scene's rule). Three phases, as
        the JAX Scene's `_run_groups`: every group's chains assembled
        (`_plans`: restacks, stacked frames and params), every chain run
        (`_dispatch`: on the card one graph replay per step, or per group
        past the signature limit), then the members pointed at their
        results, trails updated and events delivered, group by group.
        `_last_step_dispatches` counts the groups. Trailed spawners record
        one history point (elapsed dt * n)."""
        plans = self._plans(dt, n_frames)
        results = self._dispatch(plans, n_frames)
        batches, at = {}, 0
        for plan in plans:
            res = results[at:at + len(plan.segments)]
            at += len(plan.segments)
            if plan.rows is not None:
                batches[plan.key] = self._finish_group(plan, res[0], dt, n_frames)
            else:
                for sid, slot, r in zip(plan.sids, plan.slots, res):
                    self._finish_solo(sid, slot, r, dt, n_frames)
        self._batches = batches
        if self._async_events:  # keep the pinned buffers of the keys this step used
            self._event_buffers = {p[0]: p[4] for p in self._pending_events}

    def _plans(self, dt: float, n_frames: int) -> List[_Plan]:
        """Every group's step, in the order the groups' first members were
        added: a group of two or more of a global-only archetype one fleet
        chain of its stacked rows (`_plan_group`), any other group one chain
        per member."""
        groups: Dict[tuple, List[int]] = {}
        for sid, slot in self._spawners.items():
            groups.setdefault((slot.compiled.static, slot.capacity), []).append(sid)
        self._last_step_dispatches = len(groups)
        self._group_inputs = {k: v for k, v in self._group_inputs.items() if k in groups}
        pack = self._render_demand or self._async_enabled
        plans = []
        for key, sids in groups.items():
            slots = [self._spawners[sid] for sid in sids]
            if len(sids) > 1 and can_fleet(key[0]):
                plans.append(self._plan_group(key, sids, slots, dt, n_frames, pack))
            else:
                plans.append(_Plan(key, tuple(sids), slots,
                                   [self._solo_segment(slot, dt, n_frames, pack) for slot in slots]))
        return plans

    def _signature(self, plans: List[_Plan], n_frames: int) -> tuple:
        """The scene's signature (the JAX Scene's `sig`: the groups' statics
        and padded sizes, the frame count, the pack flag), with every
        segment's `chain_graph.graph_key`: the key of the scene's graph. No
        value enters it; a restack runs before the graph, so its churn does
        not either."""
        pack = bool(self._render_demand or self._async_enabled)
        return ("scene", int(n_frames), pack,
                tuple(tuple(chain_graph.graph_key(*seg) for seg in plan.segments) for plan in plans))

    def _dispatch(self, plans: List[_Plan], n_frames: int) -> list:
        """Every segment's result, in order. The signature is counted as the
        JAX Scene counts it (`_combined_signatures`; past the limit the
        scene stays in per-group mode). On the card (unless `_captured` is
        False) one graph replay for the scene, or in per-group mode one per
        group; otherwise each chain launched one by one (the plain versions
        on the CPU). A signature (in per-group mode a group's) is captured
        the second time it is met, its first step uncaptured; a step
        captures at most one graph (per-group mode's other new groups step
        uncaptured until their turn)."""
        if not plans:
            return []
        sig = self._signature(plans, n_frames)
        if not self._per_group_mode:
            self._combined_signatures.add(sig)
            if len(self._combined_signatures) > self._combined_limit:
                self._per_group_mode = True
        if not (self._captured and self.device.type == "cuda"):
            return [chain_graph.run(*seg) for plan in plans for seg in plan.segments]
        if not self._per_group_mode:
            return chain_graph.replay_segments(sig, [seg for plan in plans for seg in plan.segments], defer=True)
        group_sigs = [sig[:3] + ((g,),) for g in sig[3]]
        out, caps = [], chain_graph.COUNTS["captures"]
        for gsig, plan in zip(group_sigs, plans):  # at most one capture a step
            out += chain_graph.replay_segments(gsig, plan.segments, keep=group_sigs, defer=True,
                                               capture=chain_graph.COUNTS["captures"] == caps)
        return out

    def _solo_segment(self, slot: _SpawnerSlot, dt: float, n_frames: int, pack: bool) -> tuple:
        """A spawner's chain stepping alone: `multi_step_auto`'s, or with
        the render pack (which serves the single-type item, as the JAX
        Scene's in-kernel pack does; other types take the dense pack)
        `multi_step_auto_packed`'s; n = 1 steps `step_auto`'s launches."""
        static = slot.compiled.static
        return ("auto_packed" if pack and static.single_type else "auto", static, slot.compiled.params,
                self._colliders if static.any_collision else None, slot.state, self._frame_for(slot, dt), n_frames)

    def _finish_solo(self, sid: int, slot: _SpawnerSlot, res: tuple, dt: float, n_frames: int):
        st, out = res[0], res[1]
        slot.state, slot.outputs, slot.render_planes = st, out, res[2] if len(res) > 2 else None
        static = slot.compiled.static
        if slot.trail_settings is not None:
            # one history point per step / step_n call; elapsed lets the
            # restart rule catch slots re-tenanted inside a step_n window
            slot.trail_state = update_trails(slot.trail_state, st, np.float32(dt * n_frames))
        if self._async_events:
            if (slot.finished_observers and not slot.finished_fired) or static.any_destroyed_dump:
                self._enqueue_events(("solo", sid), (sid,), (slot,), (0,), st, out, n_frames)
            return
        if slot.finished_observers and not slot.finished_fired:
            fired = bool(out.finished_event) if n_frames == 1 else bool(st.finished_notified)
            if fired:
                self._fire_finished(sid, slot)
        if static.any_destroyed_dump:
            self._dispatch_destroyed(slot)

    def _group_rows(self, key: tuple, slots: list, padded: bool) -> Tuple[tuple, Optional[int]]:
        """The members' rows and the stack's pad (the JAX Scene's
        `scene.py:1320-1353`). Padded: a member attached to the last padded
        batch keeps its row; the others take its free rows (holes and
        padding) lowest first, then new rows; pad = _pad_target of the rows
        in use, never below the last batch's. Otherwise rows in member
        order and no pad."""
        n = len(slots)
        if not padded:
            return tuple(range(n)), None
        batch = self._batches.get(key)
        old = batch.pad if batch is not None and batch.pad is not None else 0
        row_of = {j: s._batch[1] for j, s in enumerate(slots)
                  if old and s._batch is not None and s._batch[0] is batch}
        taken = set(row_of.values())
        free = [r for r in range(old) if r not in taken]
        nxt = old
        for j in range(n):
            if j not in row_of:
                if free:
                    row_of[j] = free.pop(0)
                else:
                    row_of[j] = nxt
                    nxt += 1
        top = max(max(row_of.values()) + 1, n)
        return tuple(row_of[j] for j in range(n)), max(_pad_target(top), old)

    def _plan_group(self, key: tuple, sids: list, slots: list, dt: float, n_frames: int, pack: bool) -> _Plan:
        """A fleet group's chain over its stacked rows. Padded (the JAX
        Scene's flat groups): no destroyed-particle handler and no trailed
        member."""
        static = key[0]
        padded = self._padded and not static.any_destroyed_dump and all(s.trail_settings is None for s in slots)
        rows, pad = self._group_rows(key, slots, padded)
        size = len(slots) if pad is None else pad
        seg = ("fleet_packed" if pack and static.single_type else "fleet", static,
               self._group_params(key, slots, rows, size), self._colliders if static.any_collision else None,
               self._group_states(key, slots, rows, size), self._group_frames(key, slots, rows, size, dt), n_frames)
        return _Plan(key, tuple(sids), slots, [seg], rows, pad, self._group_trails(key, slots))

    def _group_params(self, key: tuple, slots: list, rows: tuple, size: int):
        """The group's params: one SpawnerParams shared by every member (the
        kernel then reads one table), or the members' params stacked by row
        (the first member's in rows no member holds), kept until a
        member's params or the rows change."""
        members = tuple(s.compiled.params for s in slots)
        if all(p is members[0] for p in members):
            return members[0]
        by_row = [members[0]] * size
        for p, r in zip(members, rows):
            by_row[r] = p
        cache = self._group_inputs.setdefault(key, {})
        kept = cache.get("params")
        if kept is None or len(kept[0]) != size or any(a is not b for a, b in zip(kept[0], by_row)):
            kept = cache["params"] = (tuple(by_row), stack_params(by_row))
        return kept[1]

    def _group_frames(self, key: tuple, slots: list, rows: tuple, size: int, dt: float):
        """The group's stacked FrameInput by row (the first member's frame
        in rows no member holds), kept while every row's cached frame is
        the same object (so its device records are copied once)."""
        frames = [self._frame_for(s, dt) for s in slots]
        by_row = [frames[0]] * size
        for f, r in zip(frames, rows):
            by_row[r] = f
        cache = self._group_inputs.setdefault(key, {})
        kept = cache.get("frames")
        if kept is None or len(kept[0]) != size or any(a is not b for a, b in zip(kept[0], by_row)):
            kept = cache["frames"] = (tuple(by_row), stack_frames(by_row))
        return kept[1]

    def _dead_pool(self, slot: _SpawnerSlot):
        """A padding row's pool (the JAX Scene's `_fresh_dead_state`): fresh,
        every emitter disabled, so it never spawns."""
        st = init_pool_for(slot.compiled, slot.capacity, 0)
        return dataclasses.replace(st, enabled=torch.zeros_like(st.enabled))

    def _group_states(self, key: tuple, slots: list, rows: tuple, size: int):
        """The group's stacked pool: the last batch as it is while every
        member sits on its row of it and none has left; otherwise the kept
        members' rows (and a padded batch's dead rows) gathered from it on
        the device and only the changed members' pools, new padding rows
        and a dead pool in each row a removal left inserted
        (`take_insert`); with no member kept, every row stacked."""
        batch = self._batches.get(key)
        kept = {j: s._batch[1] for j, s in enumerate(slots)
                if batch is not None and s._batch is not None and s._batch[0] is batch}
        if (batch is not None and len(kept) == len(slots) == len(batch.rows)
                and all(kept[j] == r for j, r in enumerate(rows)) and num_slots(batch.states) == size):
            return batch.states
        member_at = {r: j for j, r in enumerate(rows)}
        holes = num_slots(batch.states) if batch is not None and batch.pad is not None else 0
        was_member = set(batch.rows) if holes else set()
        keep, pos, changed, dead = [0] * size, [], [], None
        for r in range(size):
            j = member_at.get(r)
            if j in kept:
                keep[r] = kept[j]
            elif j is not None:
                pos.append(r)
                changed.append(slots[j].state)
            elif r < holes and r not in was_member:
                keep[r] = r  # a dead row stays as it is
            else:
                pos.append(r)
                dead = dead or self._dead_pool(slots[0])
                changed.append(dead)
        if not kept:
            by_row = [None] * size
            for r, st in zip(pos, changed):
                by_row[r] = st
            return stack_pools(by_row)
        return take_insert(batch.states, keep, pos, stack_pools(changed) if pos else None)

    def _group_trails(self, key: tuple, slots: list):
        """The trails the group updates stacked this step, or None (a member
        untrailed, or the members' settings unequal: each updates its own).
        In the steady state the last batch's stacked trails as they are
        (updated in place); after a membership change or a member's edit,
        every member's trail stacked into new buffers. Read before the
        members are pointed at the new batch."""
        settings = {s.trail_settings for s in slots}
        if len(slots) < 2 or len(settings) != 1 or None in settings:
            return None
        batch = self._batches.get(key)
        if (batch is not None and batch.trails is not None and len(batch.sids) == len(slots)
                and all(s._trail is None and s._batch is not None and s._batch[0] is batch and s._batch[1] == j
                        for j, s in enumerate(slots))):
            return batch.trails
        return stack_trails([s.trail_state for s in slots])

    def _finish_group(self, plan: _Plan, res: tuple, dt: float, n_frames: int) -> _GroupBatch:
        """Point the members at their rows of the group's results (a new
        batch) and deliver the group's events: one [S] flag read per group
        for on_finished, one gather and copy per group for the destroyed
        records."""
        static, sids, slots = plan.key[0], plan.sids, plan.slots
        states, out = res[0], res[1]
        batch = _GroupBatch(sids, plan.rows, plan.pad, states, out, res[2] if len(res) > 2 else None)
        for slot, row in zip(slots, plan.rows):
            slot.attach(batch, row, trails_on_batch=plan.trails is not None)
        elapsed = np.float32(dt * n_frames)
        if plan.trails is not None:
            batch.trails = update_trails_stacked(plan.trails, states, elapsed)
        else:
            for slot in slots:
                if slot.trail_settings is not None:
                    slot.trail_state = update_trails(slot.trail_state, slot.state, elapsed)
        if self._async_events:
            if static.any_destroyed_dump or any(s.finished_observers and not s.finished_fired for s in slots):
                self._enqueue_events(("group",) + sids, sids, tuple(slots), plan.rows, states, out, n_frames)
            return batch
        waiting = [j for j, s in enumerate(slots) if s.finished_observers and not s.finished_fired]
        if waiting:
            flags = (out.finished_event if n_frames == 1 else states.finished_notified).cpu().numpy()
            for j in waiting:
                if flags[plan.rows[j]]:
                    self._fire_finished(sids[j], slots[j])
        if static.any_destroyed_dump:
            self._dispatch_destroyed_group(slots, batch)
        return batch

    def _fire_finished(self, sid: int, slot: _SpawnerSlot):
        slot.finished_fired = True
        for cb in slot.finished_observers:
            cb(sid)

    def _dispatch_destroyed(self, slot: _SpawnerSlot, dt: Optional[float] = None):
        """Deliver the records of the lanes of a spawner's last destroyed
        mask: one gather of the dump fields on the device, one copy to the
        host."""
        idx = torch.nonzero(slot.outputs.destroyed_mask).flatten()
        if idx.numel() == 0:
            return
        st = slot.state
        rows = torch.stack([getattr(st, k).index_select(0, idx).to(torch.float32) for k in _DUMP_FIELDS])
        self._deliver_destroyed(slot, rows.cpu().numpy(), dt)

    def _dispatch_destroyed_group(self, slots: list, batch: _GroupBatch):
        """The group's records (the JAX Scene's `_pack_dump_compact_stacked`):
        one nonzero over the [S, N] destroyed mask, one gather of the dump
        fields with each record's row, one copy to the host, then each
        member's records (its row's) to its handlers."""
        mask = batch.stacked_outputs.destroyed_mask
        flat = torch.nonzero(mask.reshape(-1)).flatten()
        if flat.numel() == 0:
            return
        st, n = batch.states, mask.shape[-1]
        rows = torch.stack([getattr(st, k).reshape(-1).index_select(0, flat).to(torch.float32) for k in _DUMP_FIELDS]
                           + [torch.div(flat, n, rounding_mode="floor").to(torch.float32)]).cpu().numpy()
        owner = np.full(mask.shape[0], -1, np.int64)  # row -> member index (-1: no member's)
        owner[list(batch.rows)] = np.arange(len(slots))
        member = owner[rows[-1].astype(np.int64)]
        for j, slot in enumerate(slots):
            sel = member == j
            if sel.any():
                self._deliver_destroyed(slot, rows[:-1, sel])

    def _deliver_destroyed(self, slot: _SpawnerSlot, rows: np.ndarray, dt: Optional[float] = None):
        """Build and deliver `DestroyedParticle` records (`core.rs:660-667`)
        from the dump fields' rows ([len(_DUMP_FIELDS), K] f32 on the host),
        the fields the pool no longer carries (scale, colours) rebuilt with
        vectorised numpy curve evaluation; dt: the step's (default the last
        step's)."""
        f = {k: rows[i] for i, k in enumerate(_DUMP_FIELDS)}
        ptype = f["ptype"].astype(np.int64)
        dt = np.float32(self._last_dt if dt is None else dt)
        for t, handler in enumerate(slot.compiled.destroyed_handlers):
            if handler is None:
                continue
            sel = np.nonzero(ptype == t)[0]
            if sel.size == 0:
                continue
            ps = slot.spawner.particle_settings[t]
            age, lifetime, iscale = f["age"][sel], f["lifetime"][sel], f["initial_scale"][sel]
            # The fields the reference stores on the destroyed clone: colours
            # were last updated on the previous frame (gradient at the last
            # frame's age fraction); a death by age skips this frame's scale
            # update, a death by collision includes it.
            pct_prev = (np.maximum(age - dt, np.float32(0.0)) / lifetime).astype(np.float32)
            died_of_age = age >= lifetime
            first_frame = age == dt
            sc_prev = _curve_many(ps.scale_curve, pct_prev)
            sc_now = _curve_many(ps.scale_curve, (age / lifetime).astype(np.float32))
            scale = np.where(died_of_age, np.where(first_frame, iscale, (iscale * sc_prev).astype(np.float32)),
                             (iscale * sc_now).astype(np.float32)).astype(np.float32)
            base = np.atleast_2d(_curve_many(ps.base_color, pct_prev))
            emis = np.atleast_2d(_curve_many(ps.emissive_color, pct_prev))
            pbr = bool(slot.compiled.pbr_flags[t])
            r = {k: f[k][sel] for k in _DUMP_FIELDS}
            handler([
                DestroyedParticle(
                    position=(r["px"][i], r["py"][i], r["pz"][i]),
                    velocity=(r["vx"][i], r["vy"][i], r["vz"][i]),
                    rotation=(r["qx"][i], r["qy"][i], r["qz"][i], r["qw"][i]),
                    angular_velocity=(r["wx"][i], r["wy"][i], r["wz"][i]),
                    initial_scale=float(iscale[i]), scale=float(scale[i]), age=float(age[i]),
                    lifetime=float(lifetime[i]), base_color=tuple(float(c) for c in base[i]),
                    emissive_color=tuple(float(c) for c in emis[i]), pbr=pbr,
                )
                for i in range(sel.size)
            ])

    # ----------------------------------------------------------------- query
    def alive_count(self, sid: Optional[int] = None) -> int:
        if sid is not None:
            return int(self._spawners[sid].state.alive_count())
        return sum(int(s.state.alive_count()) for s in self._spawners.values())

    def aabb(self, sid: int, space: str = "world"):
        """Bounding box (min, max) of the spawner's live particles (pos ±
        scale), from the last step's stats; None before a step or when
        nothing lives. space="local": the reference's `update_aabbs`
        (`render.rs:677-703`): world half-extents, centre moved into the
        spawner's frame by the inverse global transform."""
        out = self._spawners[sid].outputs
        if out is None or not bool(out.aabb_valid):
            return None
        mn = out.aabb_min.cpu().numpy().astype(np.float32)
        mx = out.aabb_max.cpu().numpy().astype(np.float32)
        if space == "world":
            return mn, mx
        center = (mn + mx) * np.float32(0.5)
        half = (mx - mn) * np.float32(0.5)
        tf = self._spawners[sid].global_transform
        qx, qy, qz, qw = (np.float32(v) for v in tf.rotation)
        v = center - np.asarray(tf.translation, dtype=np.float32)
        ux, uy, uz = -qx, -qy, -qz  # rotate by the conjugate quaternion
        tx = np.float32(2.0) * (uy * v[2] - uz * v[1])
        ty = np.float32(2.0) * (uz * v[0] - ux * v[2])
        tz = np.float32(2.0) * (ux * v[1] - uy * v[0])
        cl = np.array([v[0] + qw * tx + (uy * tz - uz * ty), v[1] + qw * ty + (uz * tx - ux * tz),
                       v[2] + qw * tz + (ux * ty - uy * tx)], dtype=np.float32)
        return cl - half, cl + half

    def spawner_ids(self) -> List[int]:
        return list(self._spawners.keys())

    # ---------------------------------------------------------------- render
    def render_items(self, method: str = "dense", camera_pos=None, sort_within: str = "auto", view_proj=None,
                     view_layers: Optional[int] = None) -> List[RenderItem]:
        """The extract step: one item per (spawner x non-empty type)
        (`render.rs:439-461`), each with its instance rows in the 64-byte
        contract layout. The single-type item comes from the last step's
        render-pack planes when that step packed (from the second call on:
        this call turns the pack on); otherwise the dense pack, with dead
        lanes at scale 0, is compacted on the host. A live particle whose
        scale curve is exactly 0 is dropped (it is invisible either way).

        camera_pos: items back-to-front by spawner-origin distance, and the
        rows of items with an order-dependent blend (sort_within "auto"; "all"
        sorts every item, "none" none) back-to-front. view_proj: a 4x4
        view-projection matrix (WebGPU 0..1 clip depth); spawners whose AABB
        lies outside its frustum are skipped. view_layers: only spawners
        whose layers intersect it.

        method="compact": every item from `pack_instances` (the card
        compacts by a cumsum and a scatter; a live particle at scale 0 is
        kept). Pipelined rendering takes `enable_async_render` and
        `render_async` instead of this call."""
        if method not in ("dense", "compact"):
            raise ValueError(f"method must be 'dense' or 'compact', got {method!r}")
        self._render_demand = True
        cull_planes = frustum_planes(view_proj) if view_proj is not None else None
        items = []
        for sid, slot in self._spawners.items():
            if view_layers is not None and not (slot.layers & view_layers):
                continue
            if cull_planes is not None:
                box = self.aabb(sid, space="world")
                if box is not None and not aabb_intersects_frustum(box[0], box[1], cull_planes):
                    continue
            for t in range(slot.compiled.num_types):
                if method == "compact":
                    buf, count = pack_instances(slot.compiled.params, slot.state, t)
                    rows = buf[:int(count)].cpu().numpy()
                elif slot.render_planes is not None and t == 0:
                    rows = planes_to_rows(slot.compiled.static, slot.state, slot.render_planes)
                else:
                    planes, _count = pack_instances_dense(slot.compiled.params, slot.state, t)
                    rows = compact_dense(planes.cpu().numpy())
                if rows.shape[0] == 0:
                    continue
                uniform = make_uniform(slot.compiled, t)
                if camera_pos is not None and (sort_within == "all" or (
                        sort_within == "auto" and uniform.alpha_mode in ORDER_DEPENDENT_ALPHA_MODES)):
                    rows = sort_instances_back_to_front(rows, camera_pos)
                items.append(RenderItem(spawner_id=sid, type_index=t, instances=rows, count=rows.shape[0],
                                        uniform=uniform, textures=slot.compiled.textures[t], layers=slot.layers))
        if camera_pos is not None:
            cam = np.asarray(camera_pos, np.float32).reshape(3)

            def farthest_first(item):
                o = np.asarray(self._spawners[item.spawner_id].global_transform.translation, np.float32) - cam
                return -float(o @ o)

            items.sort(key=farthest_first)
        return items

    # ---------------------------------------------------------------- trails
    def trail_items(self, camera_pos=None, view_layers: Optional[int] = None) -> List[TrailItem]:
        """Ribbon-trail segments of every trailed spawner: one item per
        (spawner x non-empty type) with [count, 16] f32 segment records
        (`trails` module docstring for the layout). The segments are packed
        (`pack_trail_segments`) and compacted on the spawner's device
        (`compact_segments`: `native.compact_dense`'s rule and row order), so
        from the card only count x 64 bytes are copied. camera_pos sorts
        the segments of order-dependent blend modes back to front (midpoint
        key). view_layers: only spawners whose layers intersect it.

        Trail items are not frustum-culled: the step's AABB covers live
        particle positions only, not the history, so culling ribbons by it
        could drop visible segments behind an off-box spawner."""
        items = []
        for sid, slot in self._spawners.items():
            if slot.trail_settings is None:
                continue
            if view_layers is not None and not (slot.layers & view_layers):
                continue
            for t in range(slot.compiled.num_types):
                planes, _n = pack_trail_segments(slot.trail_settings, slot.compiled.params, slot.state,
                                                 slot.trail_state, t)
                rows = compact_segments(planes).cpu().numpy()
                if rows.shape[0] == 0:
                    continue
                uniform = make_uniform(slot.compiled, t)
                if camera_pos is not None and uniform.alpha_mode in ORDER_DEPENDENT_ALPHA_MODES:
                    rows = sort_segments_back_to_front(rows, camera_pos)
                items.append(TrailItem(spawner_id=sid, type_index=t, segments=rows, count=rows.shape[0],
                                       uniform=uniform, layers=slot.layers))
        return items

    # ------------------------------------------------- pipelined (async) render
    def enable_async_render(self, n_slots: int = 3):
        """Pipeline the render extract: from the next step on, every `step`
        hands each spawner's frame to its `AsyncRenderReader` (the kernel's
        render pack, or the dense pack of the other types), whose copies
        into pinned host memory run on a copy stream while the next frame
        steps and whose reader thread fills native instance rings. Take the
        frames with `render_async` / `release_async`: up to a frame or two
        behind `step`, latest-wins (a slow consumer skips frames, never
        blocks the simulation)."""
        self._async_enabled = True
        self._render_demand = True
        self._async_slots = int(n_slots)
        for sid in self._spawners:
            self._async_reader_for(sid)

    def disable_async_render(self):
        self.release_async()
        self._async_enabled = False
        for reader in self._async_readers.values():
            reader.close()
        self._async_readers.clear()
        self._async_seen_fid.clear()

    def _async_reader_for(self, sid: int):
        reader = self._async_readers.get(sid)
        if reader is None:
            from .render_pipeline import AsyncRenderReader

            slot = self._spawners[sid]
            reader = self._async_readers[sid] = AsyncRenderReader(slot.capacity, slot.compiled.num_types,
                                                                  n_slots=self._async_slots)
        return reader

    def _async_submit_all(self):
        """Hand this step's frame to every spawner's reader without waiting
        for the card: a single-type spawner's render-pack planes (a group
        member's row of its group's planes), else the dense pack of each
        type."""
        self._async_frame_id += 1
        fid = self._async_frame_id
        for sid, slot in self._spawners.items():
            reader = self._async_reader_for(sid)
            if slot.render_planes is not None and slot.compiled.num_types == 1:
                reader.submit_packed(slot.compiled.static, slot.state, slot.render_planes, fid)
            else:
                reader.submit(slot.compiled.params, slot.state, fid)

    def render_async(self, view_layers: Optional[int] = None) -> List[RenderItem]:
        """The newest frame each (spawner x type) reader has finished, without
        waiting for the card: usually the step before the last while the last
        one computes, possibly nothing right after the first step. Each frame
        is delivered at most once per item and frame ids strictly increase
        (an empty result: nothing newer; keep drawing the last upload).
        item.frame_id names the step (counted from 1 since enable). The rows
        are views into ring slots, valid until `release_async` (which the
        next render_async calls first)."""
        self.release_async()
        items = []
        for sid, slot in self._spawners.items():
            if view_layers is not None and not (slot.layers & view_layers):
                continue
            reader = self._async_readers.get(sid)
            if reader is None:
                continue
            for t in range(slot.compiled.num_types):
                got = reader.acquire(t)
                if got is None:
                    continue
                rows, fid = got
                self._async_acquired.append((reader, t))
                if fid <= self._async_seen_fid.get((sid, t), 0):
                    continue  # an older ready slot lingering after a newer one
                self._async_seen_fid[(sid, t)] = fid
                if rows.shape[0] == 0:
                    continue
                items.append(RenderItem(spawner_id=sid, type_index=t, instances=rows, count=rows.shape[0],
                                        uniform=make_uniform(slot.compiled, t), textures=slot.compiled.textures[t],
                                        frame_id=fid, layers=slot.layers))
        return items

    def release_async(self):
        """Release the ring slots the last render_async holds (its rows
        become invalid; the reader may overwrite those slots again)."""
        for reader, t in self._async_acquired:
            reader.release(t)
        self._async_acquired = []
