"""The Scene's one-dispatch step (`Scene._dispatch`: one captured graph per
scene signature, one per group past `combined_signature_limit`) and the
padded, hole-stable group rows, against the JAX Scene on the CPU.

On the CPU: through a churn script of adds, removes, re-adds, an edit and
a reset, in a padded group (with a group of one-shots whose observers
fire), a trailed group and a group with a destroyed-particle handler, the
port's rows and pad equal the JAX `_GroupBatch`'s `rows` / `pad`, and the
members' counts, claims, enabled bits, queues and keys (exact), cadence
scalars (within 1e-6: XLA on the CPU contracts the cadence sums, ROADMAP
queue 3), live lanes (within 1e-4: it contracts multiply-adds), finished
events and destroyed records equal the JAX Scene's, step by step. The scene signature and the packed fleet
chain's graph key hold no value, change with each static fact and stay
equal across a +-1 churn within a pad class; on a script without churn
the port switches to per-group mode on the JAX Scene's step; with churn
after its own `combined_signature_limit` + 1 signatures (the JAX
signature also counts each restack's churn class; the port's restacks run
before its graph, so its signature leaves them out). A scene graph's
words are its segments' `chain_words` joined, and the keys after the step
equal the JAX members' `rng_key`. A solo spawner's one-frame step is the
"auto" / "auto_packed" chain at n = 1, bit for bit, hybrid frames
included; a group's packed chain is n - 1 fleet frames and one packed
fleet launch.

On a card (`cuda` marker; skipped here): tests/torch_scene_configs.py's
cells, the captured Scene == the uncaptured one bit for bit (pools,
outputs, render planes and rows, trails, sync and async events), a
signature's first step uncaptured and then one replay per step (per group
in per-group mode), no launch stepped one by one in a step that replays;
a steady step under sync debug mode "error". On the CPU the deferred
capture (`replay_segments(defer=True)`: a key captured when it comes back)
and the graph cache's count and byte bounds run on stand-in graphs. This file imports JAX only inside the tests that compare with
it, so on a machine without JAX
    python -m pytest --noconftest -q tests/test_torch_scene_graph.py -k "captured or sync or capture"
runs the card cases."""

import collections
import dataclasses

import numpy as np
import pytest
import torch

import bevy_firework_tpu_torch as pt
from bevy_firework_tpu_torch.models import effects
from bevy_firework_tpu_torch.ops import chain_graph as cg
from bevy_firework_tpu_torch.ops import fused_step as fs
from bevy_firework_tpu_torch.parallel import sharding as psh

import torch_scene_configs as scene_cfg

DT = 1 / 50
ATOL = 1e-4
FLIP = (1.0, 0.0, 0.0, 0.0)  # half turn about X: a halfspace solid above its plane


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions are many small ops; one thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    import bevy_firework_tpu as jx

    return jx


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured Scene replays CUDA graphs")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# the churn script through both Scenes
# ---------------------------------------------------------------------------

# per step: the edits made before it (op, member name[, arg]), then the
# steps. Every removal comes with an add in the same step: the JAX Scene's
# trailed and dump groups raise on a step whose restack inserts nothing
# (its `sig` reads the empty churn tuple's first item, ROADMAP queue 3).
SCRIPT = (
    ([("add", 0), ("add", 1), ("add", 2), ("shot", 0), ("shot", 1)], 2),
    ([("add", 3), ("add", 4)], 2),
    ([("remove", 1), ("add", 5), ("shot", 2)], 1),  # 5 takes member 1's row (the lowest hole)
    ([("queue", 0, 5)], 1),  # an edit: member 0's row leaves the batch and comes back
    ([("remove", 0), ("remove", 2), ("add", 6)], 2),  # 6 takes row 0; row 2 stays a hole
    ([("add", 7), ("add", 8), ("add", 9), ("add", 10)], 2),  # 8 members: every row
    ([("remove", 3), ("remove", 6), ("remove", 7), ("remove", 8), ("readd", 1)], 2),  # member 1's settings again
    ([("reset", 4)], 3),  # set_spawner: a fresh pool in member 4's row
)


def _det(pkg, pacing, velocity=(1.0, 3.0, 0.2), **ps):
    """tests/test_fused_step.py's deterministic spawner (constant draws, point
    shape, live rotation) with the given pacing, launch velocity and
    particle settings, in either package's authoring types."""
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(
            lifetime=pkg.RandF32.constant(0.3), initial_scale=pkg.RandF32.constant(0.1),
            scale_curve=pkg.FireworkCurve.uneven_samples([(0.0, 1.0), (1.0, 2.0)]),
            base_color=pkg.gradient_uneven_samples([(0.0, (1, 0.5, 0.2, 1)), (1.0, (0, 0, 0, 0))]), **ps)],
        emission_settings=[pkg.EmissionSettings(
            emission_pacing=pacing, initial_velocity=pkg.RandVec3.constant(velocity),
            initial_angular_velocity=pkg.RandVec3.constant((0.0, 2.0, 0.0)))])


def _member(pkg, kind, i, sink):
    """Member i of a group of `kind`: the deterministic spawner at 1000 per
    second with its own launch velocity (params), plain, trailed or
    destroyed on a ceiling with a handler. One rate for every member: where
    XLA on the CPU contracts the rate cadence (ROADMAP queue 3), the JAX
    grouped Scene's vmapped program writes one lane fewer than it makes
    alive (1280/s at 1/64 s: the frame's last lane left at 0), a seam the
    rate 1000 at 1/50 s does not meet."""
    ps = {}
    if kind == "dump":
        ps = dict(collision_settings=pkg.ParticleCollisionSettings(destroy_on_collision=True),
                  event_handlers=pkg.ParticleEventHandlers(particles_destroyed=lambda rs: sink.append((i, len(rs), rs))))
    return _det(pkg, pkg.EmissionPacing.rate(1000.0), (1.0 + 0.25 * (i % 5), 3.0, 0.2), **ps)


def _one_shot(pkg):
    return _det(pkg, pkg.EmissionPacing.one_shot(40))


class _Driver:
    """One package's Scene driven by SCRIPT: member names to sids, and the
    events its handlers and observers saw this step."""

    def __init__(self, pkg, kind, **scene_kw):
        self.pkg, self.kind = pkg, kind
        cols = [pkg.Collider.halfspace(position=(0.0, 0.4, 0.0), rotation=FLIP)] if kind == "dump" else None
        self.scene = pkg.Scene(colliders=cols, seed=11, **scene_kw)
        self.sid, self.shots, self.events = {}, {}, []

    def add(self, i, readd=False):
        name = (i, "again") if readd else i
        tf = self.pkg.Transform(translation=(float(i), 0.1 * i, 0.0))
        kw = dict(trail=self.pkg.TrailSettings(length=6)) if self.kind == "trailed" else {}
        self.sid[name] = self.scene.add_spawner(_member(self.pkg, self.kind, i, self.events), capacity=1024,
                                                transform=tf, **kw)

    def apply(self, ops):
        for op in ops:
            if op[0] in ("add", "readd"):
                self.add(op[1], op[0] == "readd")
            elif op[0] == "shot":
                sid = self.scene.add_spawner(_one_shot(self.pkg), capacity=256,
                                             transform=self.pkg.Transform(translation=(0.0, float(op[1]), 1.0)))
                self.scene.on_finished(sid, lambda s: self.events.append(("finished", s)))
                self.shots[op[1]] = sid
            elif op[0] == "remove":
                self.scene.remove_spawner(self.sid.pop(op[1]))
            elif op[0] == "queue":
                self.scene.queue_particles(self.sid[op[1]], op[2])
            elif op[0] == "reset":
                self.scene.set_spawner(self.sid[op[1]], _member(self.pkg, self.kind, op[1] + 1, self.events))

    def step(self):
        self.events.clear()
        self.scene.step(DT)


def _rows_and_pad(scene, sids):
    """Each member's (row) and its batch's pad (None where no batch holds
    the member)."""
    out = []
    for sid in sids:
        b = scene._spawners[sid]._batch
        out.append(None if b is None else (b[1], b[0].pad))
    return out


def _records(events):
    return [(e[0], e[1]) if e[0] == "finished" else (e[0], e[1], [round(float(r.age), 4) for r in e[2]])
            for e in events]


@pytest.mark.parametrize("kind", ["flat", "trailed", "dump"])
def test_churn_rows_and_members_match_jax(kind):
    """SCRIPT through both Scenes (see the module docstring): after every
    step the port's rows and pad == the JAX batch's (a flat group padded to
    8 rows; trailed and dump groups unpadded, rows in member order),
    every member's bookkeeping exact and its live lanes within 1e-4, and
    the finished events and destroyed records the same, in order."""
    from test_torch_common import EXACT, F32_LANE, jax_pool_numpy

    jd, pd = _Driver(_jax(), kind), _Driver(pt, kind, device="cpu")
    pads = set()
    for ops, steps in SCRIPT:
        jd.apply(ops)
        pd.apply(ops)
        for _ in range(steps):
            jd.step()
            pd.step()
            assert jd.scene._last_step_dispatches == pd.scene._last_step_dispatches
            names = sorted(pd.sid, key=str)
            jr = _rows_and_pad(jd.scene, [jd.sid[n] for n in names])
            pr = _rows_and_pad(pd.scene, [pd.sid[n] for n in names])
            assert pr == jr, (ops, pr, jr)  # trailed and dump groups: rows in member order, no pad
            pads |= {p[1] for p in pr if p is not None}
            assert _records(pd.events) == _records(jd.events), ops
            for n in names + [("shot", k) for k in pd.shots]:
                js, ps = (jd.scene._spawners[jd.shots[n[1]]], pd.scene._spawners[pd.shots[n[1]]]) \
                    if isinstance(n, tuple) and n[0] == "shot" else (jd.scene._spawners[jd.sid[n]],
                                                                     pd.scene._spawners[pd.sid[n]])
                got, want = pt.interop.pool_to_numpy(ps.state), jax_pool_numpy(js.state)
                for k in EXACT:
                    np.testing.assert_array_equal(got[k], want[k], err_msg=f"{ops} {n} {k}")
                for k in ("time_in_cycle", "last_emission"):  # XLA's contracted cadence sums: an ulp (queue 3)
                    np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=f"{ops} {n} {k}")
                live = want["alive"]
                for k in F32_LANE:
                    np.testing.assert_allclose(got[k][live], want[k][live], atol=ATOL, rtol=0, err_msg=f"{n} {k}")
    assert pads == ({8} if kind == "flat" else {None})
    assert pd.scene.alive_count() == jd.scene.alive_count() > 0
    if kind == "trailed":
        assert [i.count for i in pd.scene.trail_items()] == [i.count for i in jd.scene.trail_items()]


def test_unpadded_seam_steps_members_alike():
    """SCRIPT's flat group with `Scene._padded` off (the timing seam): rows
    in member order and no pad, and every member, the one-shots included,
    == the padded scene's bit for bit after every step, its events the
    same."""
    a, b = _Driver(pt, "flat", device="cpu"), _Driver(pt, "flat", device="cpu")
    b.scene._padded = False
    for ops, steps in SCRIPT:
        a.apply(ops)
        b.apply(ops)
        for _ in range(steps):
            a.step()
            b.step()
            assert all(batch.pad is None and batch.rows == tuple(range(len(batch.sids)))
                       for batch in b.scene._batches.values())
            assert _records(a.events) == _records(b.events), ops
            assert list(a.scene._spawners) == list(b.scene._spawners)
            for sid in a.scene._spawners:
                x = pt.interop.pool_to_numpy(a.scene._spawners[sid].state)
                y = pt.interop.pool_to_numpy(b.scene._spawners[sid].state)
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=f"{ops} sid {sid} {k}")
    assert any(batch.pad == 8 for batch in a.scene._batches.values())


def test_pad_grows_past_eight_rows():
    """Past 8 members a padded group takes 16 rows, the kept members on
    their rows and the new ones on the next rows (the JAX Scene's rule; its
    own incremental restack across a pad class raises in its capsule pack,
    ROADMAP queue 3), and shrinks no more while the group lasts: every
    member == an isolated scene stepped alike, bit for bit."""
    def spawner(i):
        return _member(pt, "flat", i, [])

    sc = pt.Scene(seed=4, device="cpu")
    solos = {}

    def add(i):
        sid = sc.add_spawner(spawner(i), capacity=256, transform=pt.Transform(translation=(float(i), 0.0, 0.0)))
        solos[sid] = pt.Scene(seed=4 + sid, device="cpu")
        solos[sid].add_spawner(spawner(i), capacity=256, transform=pt.Transform(translation=(float(i), 0.0, 0.0)))

    def step(n=2):
        for _ in range(n):
            sc.step(DT)
            for s in solos.values():
                s.step(DT)
        for sid, s in solos.items():
            a, b = pt.interop.pool_to_numpy(sc._spawners[sid].state), pt.interop.pool_to_numpy(s._spawners[0].state)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"sid {sid} {k}")

    for i in range(6):
        add(i)
    step()
    sc.remove_spawner(2)
    del solos[2]
    for i in range(6, 10):
        add(i)
    step()
    batch = next(iter(sc._batches.values()))
    assert batch.pad == 16 and batch.rows == (0, 1, 3, 4, 5, 2, 6, 7, 8)
    for sid in list(solos)[:6]:
        sc.remove_spawner(sid)
        del solos[sid]
    step()
    batch = next(iter(sc._batches.values()))
    assert batch.pad == 16 and batch.rows == (6, 7, 8) and psh.num_slots(batch.states) == 16


def test_padding_rows_stay_dead_and_hidden(tmp_path):
    """A padded group of 3 members (8 rows) and a removal's hole: the hole
    gets a dead pool at the restack that makes it, and it and the four
    padding rows are dead and disabled after 15 more steps; render items,
    alive_count, aabb and a checkpoint see the members only."""
    sc = pt.Scene(device="cpu")
    sids = [sc.add_spawner(_member(pt, "flat", i, []), capacity=512, transform=pt.Transform(translation=(float(i), 0, 0)))
            for i in range(4)]
    for _ in range(5):
        sc.step(DT)
    sc.remove_spawner(sids.pop(1))  # row 1: a hole
    sc.render_items()
    for _ in range(15):
        sc.step(DT)
    batch = next(iter(sc._batches.values()))
    assert batch.pad == 8 and batch.rows == (0, 2, 3) and psh.num_slots(batch.states) == 8
    pad_rows = [r for r in range(8) if r not in (0, 2, 3)]
    assert not bool(batch.states.alive[pad_rows].any()) and not bool(batch.states.enabled[pad_rows].any())
    assert {i.spawner_id for i in sc.render_items()} == set(sids)
    assert sc.alive_count() == sum(int(sc._spawners[s].state.alive.sum()) for s in sids)
    assert all(sc.aabb(s) is not None for s in sids)
    import zipfile

    from bevy_firework_tpu_torch import checkpoint

    path = str(tmp_path / "scene.zip")
    checkpoint.save_scene(path, sc)
    names = zipfile.ZipFile(path).namelist()
    assert sorted(n for n in names if n.startswith("pool_")) == sorted(f"pool_{s}.npz" for s in sids)
    back = checkpoint.load_scene(path, device="cpu")
    for s in sids:
        for k, v in pt.interop.pool_to_numpy(back._spawners[s].state).items():
            np.testing.assert_array_equal(v, pt.interop.pool_to_numpy(sc._spawners[s].state)[k], err_msg=k)


# ---------------------------------------------------------------------------
# the chains a scene graph holds
# ---------------------------------------------------------------------------


def _solo_case(name):
    if name == "sparks":
        sp, col = effects.sparks(rate=3000.0)[0], None
    elif name == "destroy":
        sp = _det(pt, pt.EmissionPacing.rate(2000.0),
                  collision_settings=pt.ParticleCollisionSettings(destroy_on_collision=True))
        col = pt.compile_colliders([pt.Collider.halfspace(position=(0.0, 0.4, 0.0), rotation=FLIP)], device="cpu")
    else:
        sp, col = effects.fireworks()[0], None
    c = pt.compile_spawner(sp, nested_buffer=256, device="cpu")
    state = pt.init_pool_for(c, 2048, seed=5)
    frame = pt.make_frame_input(DT, translation=(0.5, 0.0, 0.0))
    for _ in range(12):
        state, _o = fs.step_auto(c.static, c.params, col, state, frame)
    return c, col, state, frame


def _same(a, b, label):
    la, lb = [], []
    cg._flatten(a, la)
    cg._flatten(b, lb)
    assert len(la) == len(lb), label
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{label}: leaf {i}"


@pytest.mark.parametrize("name", ["sparks", "destroy", "fireworks"])
def test_solo_chain_at_one_frame_is_step_auto(name):
    """The "auto" and "auto_packed" chains at n = 1 (what a scene graph
    holds for a solo spawner's step) == step_auto and step_auto_packed, bit
    for bit: a ring archetype, a dead-rank one against a ceiling, and a
    nested one (a hybrid frame)."""
    c, col, state, frame = _solo_case(name)
    _same(cg.run("auto", c.static, c.params, col, state, frame, 1),
          fs.step_auto(c.static, c.params, col, state, frame), f"{name} auto")
    if c.static.single_type:
        _same(cg.run("auto_packed", c.static, c.params, col, state, frame, 1),
              fs.step_auto_packed(c.static, c.params, col, state, frame), f"{name} auto_packed")


def _fleet_case(S=4, n_steps=6):
    c = pt.compile_spawner(effects.sparks(rate=3000.0)[0], device="cpu")
    pools = psh.stack_pools([pt.init_pool_for(c, 1024, seed=i) for i in range(S)])
    frames = psh.stack_frames([pt.make_frame_input(DT, translation=(float(i), 0.0, 0.0)) for i in range(S)])
    for _ in range(n_steps):
        pools, _o = fs.fused_step_fleet(c.static, c.params, None, pools, frames)
    return c, pools, frames


@pytest.mark.parametrize("n", [1, 2, 9])
def test_group_chains_are_the_fleet_steps(n):
    """A group's chains: "fleet" at n == multi_step_fleet_stacked (at n = 1
    the one fused_step_fleet launch), "fleet_packed" at n == n - 1 fleet
    frames then one packed fleet launch, bit for bit; their words and
    final keys are the chain's launches' (chain_words)."""
    c, pools, frames = _fleet_case()
    got = cg.run("fleet", c.static, c.params, None, pools, frames, n)
    want = fs.multi_step_fleet_stacked(c.static, c.params, None, pools, frames, n)
    _same(got, want, "fleet")
    if n == 1:
        _same(got, fs.fused_step_fleet(c.static, c.params, None, pools, frames), "fleet n=1")
    st = pools
    if n > 1:
        st, _o = fs.multi_step_fleet_stacked(c.static, c.params, None, pools, frames, n - 1)
    packed = cg.run("fleet_packed", c.static, c.params, None, pools, frames, n)
    _same(packed, fs.fused_step_fleet(c.static, c.params, None, st, frames, pack_render=True), "fleet_packed")
    words, final = cg.chain_words("fleet_packed", c.static, None, pools, frames, n)
    shape = (fs.chain_shape(n - 1, fs.chain_unroll(c.static)) if n > 1 else []) + [1]
    assert words.size == 4 * sum(shape)  # S * U seeds per launch
    assert np.array_equal(final, packed[0].rng_key.numpy())


def _key_scene(**change):
    """A scene of a padded group of five sparks (one params object), a solo
    collider-bound spawner and a nested spawner; `change` alters one fact."""
    sc = pt.Scene(colliders=[pt.Collider.halfspace(position=(0.0, -1.0, 0.0))] * change.get("colliders", 1),
                  device="cpu")
    sp = effects.sparks(rate=2000.0 + change.get("rate", 0.0))[0]
    for i in range(change.get("members", 5)):
        sc.add_spawner(sp, capacity=change.get("capacity", 1024), transform=pt.Transform(
            translation=(float(i) + change.get("move", 0.0), 0.0, 0.0)))
    sc.add_spawner(scene_cfg.hetero_archetypes()[2], capacity=512)
    sc.add_spawner(effects.fireworks()[0], capacity=1024, nested_buffer=128)
    if change.get("fields"):
        sc.add_force_field(pt.ForceField.vortex((0, 0, 0), (0, 1, 0), strength=1.0, radius=2.0))
    if change.get("render"):
        sc.render_items()
    sc.step(change.get("dt", DT))
    return sc


def _sig(sc, n=1, dt=DT):
    return sc._signature(sc._plans(dt, n), n)


KEY_STATIC = {"members": dict(members=9), "capacity": dict(capacity=2048), "colliders": dict(colliders=2),
              "fields": dict(fields=True), "render": dict(render=True)}
KEY_VALUES = {"dt": dict(dt=1 / 30), "move": dict(move=3.0), "rate": dict(rate=500.0), "members": dict(members=6)}


@pytest.mark.parametrize("change", sorted(KEY_STATIC))
def test_scene_signature_holds_static_facts(change):
    """The signature changes with a padded size (9 members: 16 rows), the
    capacity, the collider count, a force field and the render pack."""
    assert _sig(_key_scene(**KEY_STATIC[change])) != _sig(_key_scene())


@pytest.mark.parametrize("change", sorted(KEY_VALUES))
def test_scene_signature_holds_no_value(change):
    """The signature stays with dt, transforms, a rate (params) and a sixth
    member (the pad class of 8 rows); the frame count changes it."""
    sc = _key_scene()
    assert _sig(_key_scene(**KEY_VALUES[change])) == _sig(sc)
    assert _sig(sc, n=3) != _sig(sc)


def test_churn_within_a_pad_class_keeps_the_signature():
    """A +-1 churn (one member out, another in: its hole) keeps the scene's
    signature and the group's graph key; a group past 8 members moves to
    16 rows and a new signature."""
    sc = _key_scene()
    base = _sig(sc)
    sp = effects.sparks(rate=2000.0)[0]
    for k in range(3):
        sc.remove_spawner(min(s for s in sc._spawners if sc._spawners[s].capacity == 1024
                              and sc._spawners[s].compiled.static.single_type))
        sc.add_spawner(sp, capacity=1024)
        assert _sig(sc) == base
        sc.step(DT)
    for _ in range(4):
        sc.add_spawner(sp, capacity=1024)
    assert _sig(sc) != base


def test_fleet_packed_graph_key():
    """The packed fleet chain's graph key holds the slots, capacity, frame
    count and archetype, and no value (dt, translations); a nested
    archetype has no packed fleet chain."""
    c, pools, frames = _fleet_case()
    key = cg.graph_key("fleet_packed", c.static, c.params, None, pools, frames, 3)
    other = psh.stack_frames([pt.make_frame_input(1 / 30, translation=(9.0, 1.0, 0.0)) for _ in range(4)])
    assert cg.graph_key("fleet_packed", c.static, c.params, None, pools, other, 3) == key
    assert cg.graph_key("fleet_packed", c.static, c.params, None, pools, frames, 2) != key
    assert cg.graph_key("fleet", c.static, c.params, None, pools, frames, 3) != key
    c8, p8, f8 = _fleet_case(S=8, n_steps=0)
    assert cg.graph_key("fleet_packed", c8.static, c8.params, None, p8, f8, 3) != key
    n = pt.compile_spawner(effects.fireworks()[0], nested_buffer=128, device="cpu")
    nested = psh.stack_pools([pt.init_pool_for(n, 512, seed=i) for i in range(2)])
    with pytest.raises(ValueError, match="global-only"):
        cg.graph_key("fleet_packed", n.static, n.params, None, nested, psh.stack_frames(
            [pt.make_frame_input(DT)] * 2), 1)


def test_clone_out_copies_every_output_apart():
    """A replay's clone-out (`_clone_plan`, `_clone_out`) on outputs of
    several dtypes, a strided stats-row view among them (grouped apart from
    the contiguous outputs of its dtype): equal copies, none sharing memory
    with its output."""
    row = torch.arange(4 * 9, dtype=torch.int32).view(4, 9)
    outs = [torch.rand(4, 300), torch.rand(4, 300) > 0.5, row, row.view(torch.float32)[:, 1:4],
            torch.arange(4, dtype=torch.int32), torch.rand(7), torch.zeros(0)]
    plan = cg._clone_plan(outs)
    assert sorted(map(sorted, plan)) == [[0, 5, 6], [1], [2, 4], [3]]
    cloned = cg._clone_out(outs, plan)
    for a, b in zip(outs, cloned):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        assert b.numel() == 0 or b.untyped_storage().data_ptr() != a.untyped_storage().data_ptr()


def test_graph_cache_drops_the_oldest_but_what_a_step_keeps(monkeypatch):
    """The graph cache past MAX_GRAPHS drops the least recently used graphs
    first, never one the call keeps (a step's own groups), and holds more
    than MAX_GRAPHS while a step keeps more."""
    monkeypatch.setattr(cg, "MAX_GRAPHS", 3)
    monkeypatch.setattr(cg, "_GRAPHS", collections.OrderedDict((k, _FakeGraph(0)) for k in "abcdef"))
    cg._evict(keep={"a", "b"})
    assert list(cg._GRAPHS) == ["a", "b", "f"]
    cg._GRAPHS.update((k, _FakeGraph(0)) for k in "gh")
    cg._evict(keep=set("abgh"))
    assert list(cg._GRAPHS) == ["a", "b", "g", "h"]


def test_graph_cache_drops_past_its_bytes(monkeypatch):
    """Past MAX_GRAPH_BYTES the cache drops the least recently used graphs
    until the rest fit, never one the call keeps, though fewer than
    MAX_GRAPHS are kept."""
    monkeypatch.setattr(cg, "MAX_GRAPH_BYTES", 100)
    monkeypatch.setattr(cg, "_GRAPHS", collections.OrderedDict(
        (k, _FakeGraph(b)) for k, b in zip("abcd", (40, 30, 20, 50))))
    cg._evict(keep={"a", "d"})
    assert list(cg._GRAPHS) == ["a", "d"]  # 90 bytes
    cg._GRAPHS["e"] = _FakeGraph(200)
    cg._evict(keep={"e"})
    assert list(cg._GRAPHS) == ["e"]


def test_deferred_key_captures_when_it_comes_back(monkeypatch):
    """replay_segments(defer=True): a key's first call steps its chains one
    by one and captures nothing, its second captures and returns the
    graph's replay, later calls replay; a key forgotten past MAX_SEEN, or
    evicted, starts over; without defer the first call steps and
    captures; with capture=False a key met again steps one by one and
    waits."""
    log = []

    class Graph(_FakeGraph):
        def __init__(self, segments):
            super().__init__(0)
            log.append(("capture", segments[0][1]))

        def replay(self, segments):
            log.append(("replay", segments[0][1]))
            return ["graph"]

    monkeypatch.setattr(cg, "_Graph", Graph)
    monkeypatch.setattr(cg, "run", lambda kind, *a: log.append(("run", a[0])) or "launched")
    monkeypatch.setattr(cg, "_GRAPHS", collections.OrderedDict())
    monkeypatch.setattr(cg, "_SEEN", collections.OrderedDict())
    monkeypatch.setattr(cg, "MAX_SEEN", 2)
    card = type("State", (), {"device": torch.device("cuda")})()

    def call(key, defer=True, capture=True):
        del log[:]
        out = cg.replay_segments(key, [("auto", key, None, None, card, None, 1)], defer=defer, capture=capture)
        return out, list(log)

    assert call("a") == (["launched"], [("run", "a")])
    assert call("a") == (["graph"], [("capture", "a"), ("replay", "a")])
    assert call("a") == (["graph"], [("replay", "a")])
    for k in "bcd":
        assert call(k)[1] == [("run", k)]
    assert list(cg._SEEN) == ["c", "d"]
    assert call("b")[1] == [("run", "b")]  # forgotten: met once again
    cg._GRAPHS.clear()
    assert call("a")[1] == [("run", "a")]  # evicted: starts over
    assert call("e", defer=False) == (["launched"], [("run", "e"), ("capture", "e")])
    assert call("e")[1] == [("replay", "e")]
    assert call("f", capture=False)[1] == [("run", "f")]
    assert call("f", capture=False)[1] == [("run", "f")]  # met again, no capture allowed: waits
    assert call("f")[1] == [("capture", "f"), ("replay", "f")]


class _FakeGraph:
    def __init__(self, nbytes):
        self.nbytes = nbytes


# ---------------------------------------------------------------------------
# the switch to per-group mode
# ---------------------------------------------------------------------------


def _sparks_like(pkg, lifetime):
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(lifetime=pkg.RandF32.constant(lifetime))],
        emission_settings=[pkg.EmissionSettings(emission_pacing=pkg.EmissionPacing.rate(500.0))])


def test_per_group_switch_matches_jax_without_churn():
    """A script without churn (solo archetypes added, a group formed from a
    solo spawner, step_n windows, the render pack): at limit 4 the port
    switches to per-group mode on the same step as the JAX Scene, and both
    count the groups as their dispatches."""
    jx = _jax()
    js, ps = jx.Scene(combined_signature_limit=4), pt.Scene(combined_signature_limit=4, device="cpu")
    modes = []

    def both(fn):
        for sc, pkg in ((js, jx), (ps, pt)):
            fn(sc, pkg)
        modes.append((js._per_group_mode, ps._per_group_mode))
        assert js._last_step_dispatches == ps._last_step_dispatches

    both(lambda sc, pkg: sc.add_spawner(_sparks_like(pkg, 0.5), capacity=512) and None)
    for _ in range(3):
        both(lambda sc, pkg: sc.step(DT))
    both(lambda sc, pkg: sc.step_n(DT, 3))
    both(lambda sc, pkg: sc.step(DT))
    both(lambda sc, pkg: (sc.add_spawner(_sparks_like(pkg, 0.8), capacity=512), sc.step(DT)) and None)
    both(lambda sc, pkg: (sc.add_spawner(_sparks_like(pkg, 0.5), capacity=512), sc.step(DT)) and None)
    both(lambda sc, pkg: sc.step(DT))
    both(lambda sc, pkg: (sc.render_items(), sc.step(DT)) and None)  # the fifth signature
    both(lambda sc, pkg: sc.step(DT))
    assert [m[0] for m in modes] == [m[1] for m in modes]
    assert modes[-1] == (True, True) and modes.index((True, True)) == 9
    assert ps._last_step_dispatches == 2 and len(ps._combined_signatures) == 5


def test_per_group_switch_after_its_own_signatures_with_churn():
    """With churn the JAX Scene counts each restack's churn class and
    crosses limit 2 while the port, whose restacks run before its graph,
    stays with one signature; the port switches after its own third
    signature (a group past 8 members, then the render pack)."""
    jx = _jax()
    js, ps = jx.Scene(combined_signature_limit=2), pt.Scene(combined_signature_limit=2, device="cpu")
    live = {js: [], ps: []}
    for sc, pkg in ((js, jx), (ps, pt)):
        for i in range(3):
            live[sc].append(sc.add_spawner(_sparks_like(pkg, 0.5), capacity=512))
        sc.step(DT)
    for k in range(4):  # a +-1 churn per step; k = 1 also edits a member
        for sc, pkg in ((js, jx), (ps, pt)):
            sc.remove_spawner(live[sc].pop(0))
            live[sc].append(sc.add_spawner(_sparks_like(pkg, 0.5), capacity=512))
            if k == 1:
                sc.queue_particles(live[sc][0], 3)
            sc.step(DT)
    assert js._per_group_mode and not ps._per_group_mode and len(ps._combined_signatures) == 1
    for _ in range(7):
        live[ps].append(ps.add_spawner(_sparks_like(pt, 0.5), capacity=512))
    ps.step(DT)
    assert not ps._per_group_mode and len(ps._combined_signatures) == 2
    ps.render_items()
    ps.step(DT)
    assert ps._per_group_mode and len(ps._combined_signatures) == 3
    ps.step(DT)
    assert ps._last_step_dispatches == 1


# ---------------------------------------------------------------------------
# a scene graph's words and keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 4])
def test_scene_words_join_segments_and_keys_match_jax(n):
    """A scene of a padded group (three members), a solo spawner and a group
    with a handler: the graph's words are its segments' chain_words joined
    in segment order, and after step / step_n the members' keys == the key
    chains' finals (by row) == the JAX members' rng_key."""
    sink = []
    jx = _jax()
    js, ps = jx.Scene(seed=3), pt.Scene(seed=3, device="cpu")
    for sc, pkg in ((js, jx), (ps, pt)):
        for i in range(3):
            sc.add_spawner(_member(pkg, "flat", i, sink), capacity=512)
        sc.add_spawner(_sparks_like(pkg, 0.7), capacity=256)
        for i in range(2):
            sc.add_spawner(_member(pkg, "dump", i, sink), capacity=512)
        sc.step(DT)
    plans = ps._plans(DT, n)
    segments = [s for p in plans for s in p.segments]
    words, finals = cg.segment_words(segments)
    assert np.array_equal(words, np.concatenate([cg.chain_words(k, st, col, s, f, m)[0]
                                                 for k, st, _p, col, s, f, m in segments]))
    assert [s[0] for s in segments] == ["fleet", "auto", "fleet"] and plans[0].pad == 8 and plans[2].pad is None
    if n == 1:
        js.step(DT)
        ps.step(DT)
    else:
        js.step_n(DT, n)
        ps.step_n(DT, n)
    at = 0
    for plan in plans:
        for j, sid in enumerate(plan.sids):
            final = finals[at] if plan.rows is None else finals[at][plan.rows[j]]
            assert np.array_equal(final, ps._spawners[sid].state.rng_key.numpy())
            assert np.array_equal(final.astype(np.uint32), np.asarray(js._spawners[sid].state.rng_key)), sid
            if plan.rows is None:
                at += 1
        if plan.rows is not None:
            at += 1


# ---------------------------------------------------------------------------
# on a card: captured == uncaptured
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", scene_cfg.CELLS)
def test_captured_scene_equals_uncaptured(cuda, name):
    """tests/torch_scene_configs.py's cell at the test size on the card: the
    captured Scene == the uncaptured one bit for bit through its script,
    each signature's first step uncaptured, then one replay per step (per
    group in per-group mode), no launch one by one in a step that
    replays, the replays holding step launches."""
    res = scene_cfg.run_pair(name, cuda, "test")
    assert res["uncaptured_launches_in_replay_steps"] == 0 and res["replay_steps"] > 0
    assert sum(res["replayed"].get(k, 0) for k in ("fused_step.launches", "fused_step_fleet.launches")) > 0


@pytest.mark.cuda
def test_churn_within_a_pad_class_captures_nothing(cuda):
    """group_churn_12 on the card: its signature, met at frame 0, is
    captured at frame 1; the churn within the pad class replays it."""
    res = scene_cfg.run_pair("group_churn_12", cuda, "test")
    assert res["capture_frames"] == [1] and res["uncaptured_steps"] == [0]


@pytest.mark.cuda
def test_steady_scene_step_makes_no_host_sync(cuda):
    """Steady replayed steps of scene_batch_12 under sync debug mode
    "error"."""
    assert scene_cfg.steady_no_sync(cuda, "test") == 10


@pytest.mark.cuda
def test_evicted_graphs_are_captured_again(cuda, monkeypatch):
    """With room for 2 graphs, a per-group scene of 4 groups keeps its 4
    graphs (captured one a step from its second step, none after);
    another scene's graph then evicts three of them, and the next steps
    capture those again, still == the uncaptured scene bit for bit."""
    monkeypatch.setattr(cg, "MAX_GRAPHS", 2)
    cg.clear()
    a = scene_cfg.build("scene_hetero_100_per_group", cuda, "test", observe=False)
    b = scene_cfg.build("scene_hetero_100_per_group", cuda, "test", observe=False)
    b.scene._captured = False

    def steps(n):
        c0 = cg.COUNTS["captures"]
        for _ in range(n):
            a.scene.step(scene_cfg.DT)
            b.scene.step(scene_cfg.DT)
        return cg.COUNTS["captures"] - c0

    assert steps(1) == 0 and [steps(1) for _ in range(4)] == [1] * 4 and steps(3) == 0 and len(cg._GRAPHS) == 4
    other = scene_cfg.build("scene_batch_12", cuda, "test", observe=False)
    for _ in range(3):
        other.scene.step(scene_cfg.DT)
    assert len(cg._GRAPHS) == 2  # the batch's graph and the last group's, the most recently used
    assert steps(4) == 3
    scene_cfg.assert_scenes_equal(a.scene, b.scene, "after eviction")
