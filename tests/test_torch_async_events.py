"""The port Scene's async events (`enable_async_events`, `flush_events`)
against the JAX Scene's async mode, on the CPU.

The ordering contract (the JAX package's tests/test_scene.py): events of
step N are delivered in spawner-id order before step N+1's simulation runs,
exactly once, one frame late; `flush_events` drains them; spawners removed
since still get theirs; `step_n` reports the finished latch. The port
builds each frame's payload on the device (`scene.event_payload`: a rank
and a scatter, no host read) and delivers from a host copy of it; a frame
destroying more than `DUMP_COMPACT_M` lanes is delivered from the state.
Spawners are deterministic (constant draws), so the records are compared
with the JAX Scene's within the Scene tests' ATOL = 1e-4."""

import dataclasses

import numpy as np
import pytest
import torch

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from bevy_firework_tpu_torch import scene as pscene
from test_torch_common import _one_torch_thread, det_spawner  # noqa: F401

ATOL = 1e-4
FLIP = (1.0, 0.0, 0.0, 0.0)  # half turn about X: a halfspace solid above its plane


def burst(pkg, sink, n=4, lifetime=0.1):
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(
            lifetime=pkg.RandF32.constant(lifetime), initial_scale=pkg.RandF32.constant(0.5),
            event_handlers=pkg.ParticleEventHandlers(particles_destroyed=sink.extend))],
        emission_settings=[pkg.EmissionSettings(
            emission_pacing=pkg.EmissionPacing.one_shot(n),
            initial_velocity=pkg.RandVec3.constant((1.0, 0.0, 0.0)))])


def same_records(got, want):
    """Two lists of DestroyedParticle records equal within ATOL."""
    assert len(got) == len(want)
    for x, y in zip(want, got):
        for k in ("position", "velocity", "rotation", "angular_velocity", "base_color", "emissive_color"):
            np.testing.assert_allclose(getattr(y, k), getattr(x, k), atol=ATOL, rtol=0, err_msg=k)
        for k in ("initial_scale", "scale", "age", "lifetime"):
            assert abs(getattr(y, k) - getattr(x, k)) <= ATOL, k
        assert y.pbr == x.pbr


def _burst_scenes(async_mode, n=4, lifetime=0.1, capacity=32):
    out = {}
    for name, pkg in (("jax", jx), ("port", pt)):
        got, fin = [], []
        sc = pkg.Scene() if pkg is jx else pkg.Scene(device="cpu")
        sid = sc.add_spawner(burst(pkg, got, n, lifetime), capacity=capacity)
        sc.on_finished(sid, fin.append)
        if async_mode:
            sc.enable_async_events()
        out[name] = (sc, got, fin)
    return out


def test_async_events_one_frame_late_exactly_once():
    """The same records as the sync path, delivered one frame late, once;
    the finished callback too; equal to the JAX Scene's async delivery."""
    sync, asy = _burst_scenes(False), _burst_scenes(True)
    first = {}
    for f in range(12):
        for mode, d in (("sync", sync), ("async", asy)):
            for name, (sc, got, fin) in d.items():
                sc.step(1 / 60)
                if got:
                    first.setdefault((mode, name, "death"), f)
                if fin:
                    first.setdefault((mode, name, "fin"), f)
    for name in ("jax", "port"):
        assert first[("async", name, "death")] == first[("sync", name, "death")] + 1
        assert first[("async", name, "fin")] == first[("sync", name, "fin")] + 1
    assert first[("async", "port", "death")] == first[("async", "jax", "death")]
    _sc, got_s, fin_s = sync["port"]
    _sc, got_a, fin_a = asy["port"]
    assert len(got_a) == len(got_s) == 4 and fin_a == fin_s == [0]
    assert [dataclasses.astuple(r) for r in got_a] == [dataclasses.astuple(r) for r in got_s]
    same_records(got_a, asy["jax"][1])


def test_flush_events_drains_the_last_frame():
    """A death on the last stepped frame arrives through flush_events,
    exactly once; a second flush delivers nothing."""
    d = _burst_scenes(True)
    for name, (sc, got, _fin) in d.items():
        while not np.asarray(sc._spawners[0].state.alive).any():
            sc.step(1 / 60)
        while np.asarray(sc._spawners[0].state.alive).any():
            sc.step(1 / 60)
        assert len(got) == 0
        sc.flush_events()
        assert len(got) == 4
        sc.flush_events()
        assert len(got) == 4
    same_records(d["port"][1], d["jax"][1])


def test_step_n_reports_the_finished_latch():
    """A step_n window in which the burst finishes: its finished callback
    arrives at the start of the next call (the latch), once; the records
    of the window's last frame with it."""
    d = _burst_scenes(True)
    for name, (sc, got, fin) in d.items():
        sc.step_n(1 / 60, 12)
        assert fin == [] and got == []
        sc.step(1 / 60)
        assert fin == [0]
        sc.step_n(1 / 60, 3)
        sc.flush_events()
        assert fin == [0]
    assert len(d["port"][1]) == len(d["jax"][1])


def test_overflow_past_the_payload_window():
    """2000 particles dying on one frame (past DUMP_COMPACT_M = 1024):
    every record arrives once, one frame late, from the state, equal to
    the JAX Scene's."""
    d = _burst_scenes(True, n=2000, lifetime=0.1, capacity=2048)
    deaths = {}
    for f in range(12):
        for name, (sc, got, _fin) in d.items():
            sc.step(1 / 60)
            if got:
                deaths.setdefault(name, f)
    assert deaths["port"] == deaths["jax"]
    assert len(d["port"][1]) == 2000
    same_records(d["port"][1], d["jax"][1])


def _ceiling_scenes(n_spawners, async_mode=True):
    """n destroy-on-collision deterministic spawners of one archetype under
    a ceiling, each with its own sink and transform, in both Scenes."""
    out = {}
    for name, pkg in (("jax", jx), ("port", pt)):
        kw = {} if pkg is jx else {"device": "cpu"}
        sc = pkg.Scene(colliders=[pkg.Collider.halfspace(position=(0.0, 0.4, 0.0), rotation=FLIP)], **kw)
        sinks = []
        for i in range(n_spawners):
            sink = []
            sinks.append(sink)
            sc.add_spawner(det_spawner(pkg, ps=dict(
                collision_settings=pkg.ParticleCollisionSettings(destroy_on_collision=True),
                event_handlers=pkg.ParticleEventHandlers(particles_destroyed=lambda rs, s=sink: s.append(rs)))),
                capacity=1024, transform=pkg.Transform(translation=(float(i), -0.1 * i, 0.0)))
        if async_mode:
            sc.enable_async_events()
        out[name] = (sc, sinks)
    return out


@pytest.mark.parametrize("n_spawners", [1, 3])
def test_destroy_records_match_jax_async(n_spawners):
    """Solo and as a group (one fleet launch, one payload per group): each
    handler gets, frame by frame, the JAX Scene's async records; the
    port's async records == its sync records one frame later."""
    d = _ceiling_scenes(n_spawners)
    sync = _ceiling_scenes(n_spawners, async_mode=False)["port"]
    for f in range(30):
        for name, (sc, _s) in d.items():
            sc.step(1 / 50)
        sync[0].step(1 / 50)
        for j in range(n_spawners):
            assert len(d["port"][1][j]) == len(d["jax"][1][j])
    if n_spawners > 1:
        assert d["port"][0]._last_step_dispatches == 1
    for j in range(n_spawners):
        assert sum(map(len, d["port"][1][j])) > 100
        for a, b in zip(d["jax"][1][j], d["port"][1][j]):
            same_records(b, a)
        got = [[dataclasses.astuple(r) for r in rs] for rs in d["port"][1][j]]
        want = [[dataclasses.astuple(r) for r in rs] for rs in sync[1][j]]
        assert got == want[:len(got)] and len(got) >= len(want) - 1


def test_spawner_id_order_and_removed_spawners():
    """Deliveries of one step run in spawner-id order across solo spawners
    and groups; a spawner removed after its event frame still gets its
    records at the next step."""
    log = []

    def sp(tag, n):
        return pt.ParticleSpawner(
            particle_settings=[pt.ParticleSettings(
                lifetime=pt.RandF32.constant(0.05),
                event_handlers=pt.ParticleEventHandlers(particles_destroyed=lambda rs: log.append((tag, len(rs)))))],
            emission_settings=[pt.EmissionSettings(emission_pacing=pt.EmissionPacing.one_shot(n))])

    sc = pt.Scene(device="cpu")
    sc.enable_async_events()
    # ids 0 and 2: one archetype (a group); 1 and 3 solo (other capacities)
    sc.add_spawner(sp(0, 4), capacity=64)
    sc.add_spawner(sp(1, 5), capacity=128)
    sc.add_spawner(sp(2, 4), capacity=64)
    sc.add_spawner(sp(3, 6), capacity=256)
    for _ in range(8):
        sc.step(1 / 60)
        if 3 in sc.spawner_ids() and sc.alive_count() == 0:
            assert log == []
            sc.remove_spawner(3)  # its deaths are in flight
    assert log == [(0, 4), (1, 5), (2, 4), (3, 6)]


def test_event_payload_rank_and_scatter():
    """event_payload == the dump fields of the mask's first M lanes in lane
    order (torch.nonzero's), solo and stacked, the count beside them, the
    finished flag or latch; below and above M."""
    rng = np.random.default_rng(5)
    n = 700
    for m, p_dead in ((256, 0.2), (256, 0.6), (1024, 0.5)):
        states, masks = [], []
        for _ in range(3):
            st = pt.init_pool(n, 1, device="cpu")
            st = dataclasses.replace(st, **{k: torch.from_numpy(rng.normal(size=n).astype(np.float32))
                                            for k in ("px", "vy", "wz", "age")},
                                     ptype=torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)),
                                     finished_notified=torch.tensor(bool(rng.integers(0, 2))))
            states.append(st)
            masks.append(torch.from_numpy(rng.uniform(size=n) < p_dead))
        for stacked in (False, True):
            sel = range(3) if stacked else range(1)
            st = pt.stack_pools([states[j] for j in sel]) if stacked else states[0]
            mask = torch.stack([masks[j] for j in sel]) if stacked else masks[0]
            fin = torch.tensor([True, False, True][:len(sel)]) if stacked else torch.tensor(True)
            out = pt.StepOutputs(alive_count=None, alive_count_per_type=None, finished_event=fin, aabb_valid=None,
                                 aabb_min=None, aabb_max=None, destroyed_mask=mask, nested_deferred=None,
                                 nested_dropped=None)
            for n_frames in (1, 4):
                pay = pscene.event_payload(st, out, n_frames, True, m)
                assert pay.shape == (len(sel), len(pscene._DUMP_FIELDS) + 1, min(m, n))
                for j in sel:
                    idx = torch.nonzero(masks[j]).flatten()
                    c = min(idx.numel(), pay.shape[-1])
                    assert pay[j, -1, 0] == idx.numel()
                    want = (fin.reshape(-1)[j] if n_frames == 1 else states[j].finished_notified).float()
                    assert pay[j, -1, 1] == want
                    for i, k in enumerate(pscene._DUMP_FIELDS):
                        assert torch.equal(pay[j, i, :c], getattr(states[j], k)[idx[:c]].float()), k
    flag_only = pscene.event_payload(st, out, 1, False)
    assert flag_only.shape == (3, 1, 2) and torch.equal(flag_only[:, 0, 1], torch.tensor([1.0, 0.0, 1.0]))
