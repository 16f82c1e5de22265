"""The captured chains (`ops.chain_graph`): the chain's host words in one
pass, its final key against the JAX package's `multi_step_auto` and
`multi_step_fleet`, and the graph key; on a card, captured == uncaptured.

On the CPU: the one-pass key chains of `prng` (`chain_seeds`,
`chain_seeds_stacked`, `hybrid_chain_keys`) equal the per-launch
`frame_seeds` / `frame_seeds_stacked` sequence and the hybrid frames'
splits and fold_ins, exactly; `chain_graph.chain_words` lays them out with
the frame rows in the order the launches take them; the key after a chain
equals the JAX package's on the CPU (its Pallas kernels in interpret mode,
its merge and fold forced on as tests/test_torch_nested_fold.py forces
them); the graph key holds every static field and no value.

On a card (`cuda` marker; skipped here): every case of
tests/torch_chain_configs.py, captured == uncaptured bit for bit over a
first call, replays and a changed dt. This file imports JAX only inside the
tests that compare with it, so on a machine without JAX
    python -m pytest --noconftest -q tests/test_torch_chain_graph.py
runs the rest (those skip)."""

import dataclasses
import enum

import numpy as np
import pytest
import torch

import bevy_firework_tpu_torch as pt
from bevy_firework_tpu_torch import prng
from bevy_firework_tpu_torch.models import effects
from bevy_firework_tpu_torch.ops import chain_graph as cg
from bevy_firework_tpu_torch.ops import fused_step as fs
from bevy_firework_tpu_torch.ops import table_layout as L
from bevy_firework_tpu_torch.parallel import sharding as psh

import torch_chain_configs as chain_cfg
import torch_fleet_configs as fleet_cfg
import torch_nested_configs as nested_cfg

NS = (1, 7, 8, 140, 150)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a captured chain replays CUDA graphs")
    return torch.device("cuda")


def _keys(S):
    seeds = (0, 1, 7, 2**31 + 5, 11, 12, 13, 2**32 - 1, 99, 100, 12345, 3, 4, 5, 6, 8)[:S]
    return np.array([[0, s & 0xFFFFFFFF] for s in seeds], np.uint32)


# ---------------------------------------------------------------------------
# the chain's host words in one pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 16])
@pytest.mark.parametrize("U", [1, 2, 8])
@pytest.mark.parametrize("n", NS)
def test_chain_seeds_one_pass(n, U, S):
    """chain_seeds (S = 1) and chain_seeds_stacked (S = 16) over the launches
    of chain_shape(n, U) == frame_seeds / frame_seeds_stacked launch by
    launch: every seed and the final key."""
    shape = fs.chain_shape(n, U)
    keys = _keys(S)
    if S == 1:
        final, seeds = prng.chain_seeds(keys[0], shape)
        key = keys[0]
        for u, s in zip(shape, seeds):
            key, want = prng.frame_seeds(key, u)
            assert s.dtype == np.uint32 and s.tolist() == want
    else:
        final, seeds = prng.chain_seeds_stacked(keys, shape)
        key = keys
        for u, s in zip(shape, seeds):
            key, want = prng.frame_seeds_stacked(key, u)
            assert s.shape == (S, u)
            np.testing.assert_array_equal(s, want)
    assert len(seeds) == len(shape)
    np.testing.assert_array_equal(final, key)


@pytest.mark.parametrize("S", [1, 16])
@pytest.mark.parametrize("emitters", [(), (1,), (1, 2)])
@pytest.mark.parametrize("n", NS)
def test_hybrid_keys_one_pass(n, emitters, S):
    """hybrid_chain_keys == a hybrid frame's two splits per frame (new_key,
    frame_key = split(key); new_key, kernel_key = split(new_key)), its
    seed word 1 of kernel_key and each nested stage's fold_in(frame_key,
    1000 + e), frame by frame, for each of S slot keys; the final key
    exact."""
    for key in _keys(S):
        final, seeds, stage = prng.hybrid_chain_keys(key, n, emitters)
        assert seeds.shape == (n,) and stage.shape == (n, len(emitters), 2)
        k = key
        for f in range(n):
            new_key, frame_key = prng.threefry_split(k)
            new_key, kernel_key = prng.threefry_split(new_key)
            assert seeds[f] == kernel_key[1]
            for j, e in enumerate(emitters):
                np.testing.assert_array_equal(stage[f, j], prng.threefry_fold_in(frame_key, 1000 + e))
            k = new_key
        np.testing.assert_array_equal(final, k)


def _solo(name, n=16384):
    sp = {"main": effects.stress_test()[0], "nested": nested_cfg.bench_nested(False),
          "chained": nested_cfg.bench_nested(True)}[name]
    kw = {"nested_buffer": 256} if name != "main" else {}
    c = pt.compile_spawner(sp, device="cpu", **kw)
    return c, pt.init_pool_for(c, n, seed=5)


def _row(frame):
    return fs._frame_row(frame).view(np.uint32).tolist()


@pytest.mark.parametrize("kind,n", [("auto", 1), ("auto", 19), ("auto_packed", 1), ("auto_packed", 19)])
def test_chain_words_solo_layout(kind, n):
    """A solo chain's words: per launch of chain_shape(n, 8) (for the packed
    chain: n - 1 frames, then one) its frame row, then its seeds."""
    c, s = _solo("main")
    f = pt.make_frame_input(1 / 60, translation=(1.0, 2.0, 3.0))
    words, final = cg.chain_words(kind, c.static, None, s, f, n)
    shape = fs.chain_shape(n, 8) if kind == "auto" else (fs.chain_shape(n - 1, 8) if n > 1 else []) + [1]
    want, key = [], s.rng_key.numpy()
    for u in shape:
        key, seeds = prng.frame_seeds(key, u)
        want += _row(f) + seeds
    assert words.tolist() == want
    np.testing.assert_array_equal(final, key)


@pytest.mark.parametrize("name", ["nested", "chained"])
def test_chain_words_hybrid_layout(name):
    """A hybrid chain's words: per frame, per nested emitter its stage's key
    and the frame row, then the step launch's frame row and seed."""
    c, s = _solo(name)
    f = pt.make_frame_input(1 / 60, modifier_scale=1.5)
    es = fs.nested_emitters(c.static)
    words, final = cg.chain_words("auto", c.static, None, s, f, 5)
    want, key = [], s.rng_key.numpy()
    for _ in range(5):
        new_key, frame_key = prng.threefry_split(key)
        key, kernel_key = prng.threefry_split(new_key)
        for e in es:
            want += prng.threefry_fold_in(frame_key, 1000 + e).tolist() + _row(f)
        want += _row(f) + [int(kernel_key[1])]
    assert words.tolist() == want
    assert len(words) == 5 * (len(es) * (2 + L.FRAME_WORDS) + L.FRAME_WORDS + 1)
    np.testing.assert_array_equal(final, key)


@pytest.mark.parametrize("nested", [False, True])
def test_chain_words_fleet_layout(nested):
    """A fleet chain's words: per launch its [S, U] seeds slot-major; a
    nested fleet's, per frame and slot that slot's hybrid frame."""
    S = 3
    c, _s = _solo("nested" if nested else "main", 4096)
    pools = psh.stack_pools([pt.init_pool_for(c, 4096, seed=i) for i in range(S)])
    frames = psh.stack_frames([pt.make_frame_input(1 / 60, translation=(float(i), 0.0, 0.0)) for i in range(S)])
    n = 10
    words, final = cg.chain_words("fleet", c.static, None, pools, frames, n)
    keys = pools.rng_key.numpy()
    want = []
    if not nested:
        for u in fs.chain_shape(n, 8):
            keys, seeds = prng.frame_seeds_stacked(keys, u)
            want += seeds.reshape(-1).tolist()
    else:
        es = fs.nested_emitters(c.static)
        keys = [k for k in keys]
        for _ in range(n):
            for i in range(S):
                new_key, frame_key = prng.threefry_split(keys[i])
                keys[i], kernel_key = prng.threefry_split(new_key)
                row = _row(psh.frame_slot(frames, i))
                for e in es:
                    want += prng.threefry_fold_in(frame_key, 1000 + e).tolist() + row
                want += row + [int(kernel_key[1])]
        keys = np.stack(keys)
    assert words.tolist() == want
    np.testing.assert_array_equal(final, keys)


def test_device_words_take_in_order():
    """DeviceWords hands out the words in order and refuses a launch that
    asks for other words, or a run that leaves words untaken."""
    w = fs.DeviceWords(np.array([1, 2, 3, 4], np.uint32), torch.zeros(4, dtype=torch.int32))
    base = w.buf.data_ptr()
    assert w.take([1, 2]) == base and w.take([3]) == base + 8
    with pytest.raises(RuntimeError, match="asked for"):
        w.take([5])
    with pytest.raises(RuntimeError, match="took 3 of 4"):
        w.check_done()


@pytest.mark.parametrize("name", chain_cfg.TEST_CASES)
def test_chain_words_key_matches_the_plain_chain(name):
    """Every case of tests/torch_chain_configs.py on the CPU: the key after
    its chain in chain_words (one host pass) == the key its entry point's
    plain chain leaves, and the words' count follows the chain's launches
    (a solo launch a frame row and its seeds, a fleet launch S * U seeds, a
    hybrid frame per nested emitter a key and a row, then a row and a
    seed)."""
    case = chain_cfg.build(name, "cpu", "test")
    words, final = cg.chain_words(case.kind, case.static, case.colliders, case.state, case.frame, case.n)
    state = chain_cfg._step_chain(case, case.state, case.frame, False)[0]
    np.testing.assert_array_equal(final.astype(np.int64), state.rng_key.numpy())
    S = case.state.px.shape[0] if case.kind == "fleet" else 1
    if fs.has_nested(case.static):
        per_frame = len(fs.nested_emitters(case.static)) * (2 + L.FRAME_WORDS) + L.FRAME_WORDS + 1
        assert words.size == S * case.n * per_frame
    elif case.kind == "fleet":
        assert words.size == S * case.n
    else:
        shape = fs.chain_shape(case.n, fs.chain_unroll(case.static, case.colliders))
        if case.kind == "auto_packed":
            shape = fs.chain_shape(case.n - 1, fs.chain_unroll(case.static, case.colliders)) + [1]
        assert words.size == len(shape) * L.FRAME_WORDS + case.n


# ---------------------------------------------------------------------------
# the final key against the JAX package
# ---------------------------------------------------------------------------


def _to_jax(obj, jx, js):
    """A port authoring object as the JAX package's (same names, fields and
    enum members)."""
    if isinstance(obj, enum.Enum):
        return getattr(js, type(obj).__name__)[obj.name]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(jx, type(obj).__name__, None) or getattr(js, type(obj).__name__)
        return cls(**{f.name: _to_jax(getattr(obj, f.name), jx, js) for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_jax(x, jx, js) for x in obj)
    return obj


@pytest.mark.parametrize("config", ["main", "nested", "fleet"])
def test_final_key_matches_jax(config):
    """The key after a chain (chain_words' final key, and the port's
    uncaptured chain's on the CPU) == the JAX package's multi_step_auto
    (main: tests/torch_chain_configs.py's stress test; nested: bench.py's
    nested cell, folded through its merge in interpret mode) and
    multi_step_fleet (tests/torch_fleet_configs.py's det spawner, 3
    slots): exact."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from jax.experimental.pallas import tpu as pltpu

    import bevy_firework_tpu as jx
    import bevy_firework_tpu.ops.fused_step as jfs
    import bevy_firework_tpu.settings as js

    if config == "fleet":
        sp = fleet_cfg.det_spawner(3000.0)
        S, N, n = 3, 512, 10
        cj = jx.compile_spawner(_to_jax(sp, jx, js))
        sj = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[jx.init_pool_for(cj, N, s) for s in range(S)])
        fj = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[jx.make_frame_input(1 / 60) for _ in range(S)])
        jkey = np.asarray(jfs.multi_step_fleet(cj.static, cj.params, None, sj, fj, n)[0].rng_key)
        cp = pt.compile_spawner(sp, device="cpu")
        sp_ = psh.stack_pools([pt.init_pool_for(cp, N, seed=s) for s in range(S)])
        fp = psh.stack_frames([pt.make_frame_input(1 / 60) for _ in range(S)])
        _w, final = cg.chain_words("fleet", cp.static, None, sp_, fp, n)
        port = fs.multi_step_fleet(cp.static, cp.params, None, sp_, fp, n)[0].rng_key.numpy()
    else:
        sp = chain_cfg._rated(effects.stress_test()[0], 3e4) if config == "main" else nested_cfg.bench_nested(False)
        kw = {"nested_buffer": 128} if config == "nested" else {}
        N, n = (1024, 9) if config == "main" else (8192, 3)
        cj = jx.compile_spawner(_to_jax(sp, jx, js), **kw)
        prev = jfs._FORCE_NESTED_MERGE_CPU, jfs._FORCE_NESTED_FOLD_CPU
        jfs._FORCE_NESTED_MERGE_CPU = jfs._FORCE_NESTED_FOLD_CPU = config == "nested"
        try:
            with pltpu.force_tpu_interpret_mode():
                out = jfs.multi_step_auto(cj.static, cj.params, None, jx.init_pool_for(cj, N, 3),
                                          jx.make_frame_input(1 / 60), n)
        finally:
            jfs._FORCE_NESTED_MERGE_CPU, jfs._FORCE_NESTED_FOLD_CPU = prev
        jkey = np.asarray(out[0].rng_key)
        cp = pt.compile_spawner(sp, device="cpu", **kw)
        s0, f0 = pt.init_pool_for(cp, N, seed=3), pt.make_frame_input(1 / 60)
        _w, final = cg.chain_words("auto", cp.static, None, s0, f0, n)
        port = fs.multi_step_auto(cp.static, cp.params, None, s0, f0, n)[0].rng_key.numpy()
    np.testing.assert_array_equal(final.astype(np.int64), jkey.astype(np.int64))
    np.testing.assert_array_equal(port, jkey.astype(np.int64))


# ---------------------------------------------------------------------------
# the graph key
# ---------------------------------------------------------------------------


def _key_case(**change):
    """(kind, static, params, colliders, state, frame, n) of a collision
    chain on the CPU with one input changed."""
    sp, _tf, cols = effects.collision()
    sp = change.get("spawner", sp)
    c = pt.compile_spawner(sp, device="cpu")
    cols = change.get("colliders", cols)
    table = None if cols is None else pt.compile_colliders(cols, device="cpu")
    ff = change.get("fields")
    frame = pt.make_frame_input(change.get("dt", 1 / 60), translation=change.get("translation", (0.0, 0.0, 0.0)),
                                force_fields=None if ff is None else pt.compile_force_fields(ff, device="cpu"))
    state = pt.init_pool_for(c, change.get("capacity", 4096), seed=change.get("seed", 0))
    return (change.get("kind", "auto"), c.static, c.params, table, state, frame, change.get("n", 20))


KEY_STATIC = {
    "kind": {"kind": "auto_packed"},
    "n_frames": {"n": 21},
    "capacity": {"capacity": 4096 + 256},
    "collider_count": {"colliders": list(effects.collision()[2]) + [pt.Collider.sphere(0.5, position=(1, 1, 1))]},
    "hull": {"colliders": [pt.Collider.hull_from_points([(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)])]},
    "no_colliders": {"colliders": None},
    "field_count": {"fields": [pt.ForceField.point((0, 1, 0), 3.0, 2.0)]},
    "static": {"spawner": effects.sparks()[0]},
}
KEY_VALUES = {
    "dt": {"dt": 1 / 30},
    "transform": {"translation": (3.0, 1.0, 0.0)},
    "seed": {"seed": 9},
    "params": {"spawner": chain_cfg._rated(effects.collision()[0], 1234.0)},
    "collider_values": {"colliders": [dataclasses.replace(c, position=tuple(p + 0.5 for p in c.position))
                                      for c in effects.collision()[2]]},
}


@pytest.mark.parametrize("change", sorted(KEY_STATIC))
def test_graph_key_holds_static_fields(change):
    """Each static field of a chain (entry point, frame count, capacity,
    collider count and hull sizes, field count, the archetype) changes its
    graph key."""
    assert cg.graph_key(*_key_case(**KEY_STATIC[change])) != cg.graph_key(*_key_case())


@pytest.mark.parametrize("change", sorted(KEY_VALUES))
def test_graph_key_holds_no_value(change):
    """dt, the transform, the pool's key, params and collider values leave
    the graph key as it is: a new frame is an argument of a replay."""
    assert cg.graph_key(*_key_case(**KEY_VALUES[change])) == cg.graph_key(*_key_case())


def test_graph_key_fleet_slots():
    """A fleet's slot count and field count are in its key; its frames'
    values are not."""
    c = pt.compile_spawner(effects.stress_test()[0], device="cpu")

    def key(S, dt=1 / 60, ff=None):
        pools = psh.stack_pools([pt.init_pool_for(c, 1024, seed=i) for i in range(S)])
        frames = psh.stack_frames([pt.make_frame_input(dt, force_fields=ff) for _ in range(S)])
        return cg.graph_key("fleet", c.static, c.params, None, pools, frames, 8)

    ff = pt.compile_force_fields([pt.ForceField.point((0, 1, 0), 3.0, 2.0)], device="cpu")
    assert key(3) == key(3, dt=1 / 30) != key(4)
    assert key(3, ff=ff) != key(3)


# ---------------------------------------------------------------------------
# on a card: captured == uncaptured
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", chain_cfg.TEST_CASES)
def test_captured_equals_uncaptured(cuda, name):
    """tests/torch_chain_configs.py's case on the card: the captured chain ==
    the uncaptured chain bit for bit (the first call, a replay, a replay
    with another dt and transform, a replay from the first call's state
    again; earlier results kept; the input unwritten; the carried claim),
    under sync debug mode "error"."""
    chain_cfg.check_captured(chain_cfg.build(name, cuda, "test"))


@pytest.mark.cuda
def test_scene_step_n_replays_graphs(cuda):
    """`Scene.step_n` on the card runs its chains as captured graphs (a solo
    spawner through multi_step_auto_packed, a group of three through
    multi_step_fleet_stacked, a nested spawner's hybrid chain): three
    step_n(8) calls == 24 `step` calls of an equal Scene, every pool leaf of
    every spawner bit for bit, and the second and third calls replay."""
    def scene():
        sc = pt.Scene(device=cuda)
        sc.add_spawner(effects.sparks(rate=3000.0)[0], capacity=4096)
        for i in range(3):
            sc.add_spawner(effects.sparks(rate=2000.0 + 500.0 * i)[0], capacity=8192,
                           transform=pt.Transform(translation=(float(i), 0.0, 0.0)))
        sp, tf = effects.fireworks()
        sc.add_spawner(sp, transform=tf, capacity=16384, nested_buffer=256)
        sc.render_items()  # the render pack on: step_n's solo chains take multi_step_auto_packed
        return sc

    a, b = scene(), scene()
    before = dict(cg.COUNTS)
    for _ in range(3):
        a.step_n(1 / 60, 8)
    for _ in range(24):
        b.step(1 / 60)
    assert cg.COUNTS["replays"] - before["replays"] >= 6
    for sid in a._spawners:
        sa, sb = a._spawners[sid].state, b._spawners[sid].state
        for k in dataclasses.fields(sa):
            x, y = getattr(sa, k.name), getattr(sb, k.name)
            if x.dtype.is_floating_point:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x.cpu(), y.cpu()), (sid, k.name)
