"""The nested fold in the port (plain PyTorch, on the CPU) against the JAX
package's fold: `can_fold_nested`, the carry one folded frame leaves, and
a folded chain; and the port's folded chain against its unfolded chain.

The JAX package folds and merges in-kernel on a TPU only;
`_FORCE_NESTED_MERGE_CPU` and `_FORCE_NESTED_FOLD_CPU` turn both on here
for a test and are restored afterwards, as tests/test_nested.py does, and
its Pallas kernels run in interpret mode. Tolerances as in
tests/test_torch_nested.py: XLA on the CPU contracts multiply-adds into
FMAs, so f32 values are held within `assert_pools_match`'s 2e-5; counts,
totals, cursors, types and keys are exact; anchors (`last_emitted`, the
carry's new_le) within 1 ulp once canonicalised. The port's folded chain
equals its unfolded one with torch.equal."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import bevy_firework_tpu as jx
import bevy_firework_tpu.ops.fused_step as jfs
import bevy_firework_tpu_torch as pt
import torch_nested_configs as cfg
from bevy_firework_tpu_torch import interop
from bevy_firework_tpu_torch.ops import fused_step as fs
from bevy_firework_tpu_torch.pool import POOL_FIELDS
from test_torch_common import _one_torch_thread, assert_pools_match  # noqa: F401
from test_torch_nested import _canonical_le, _chained, _ulps

OFFS = {1: 0.1, 2: 0.2}  # the chained config's nested off_start per emitter
TARGETS = {1: 0, 2: 1}  # ... and parent type


@pytest.fixture
def jax_fold():
    """The JAX package's merge and fold on the CPU for one test."""
    prev = jfs._FORCE_NESTED_MERGE_CPU, jfs._FORCE_NESTED_FOLD_CPU
    jfs._FORCE_NESTED_MERGE_CPU = jfs._FORCE_NESTED_FOLD_CPU = True
    yield
    jfs._FORCE_NESTED_MERGE_CPU, jfs._FORCE_NESTED_FOLD_CPU = prev


# ------------------------------------------------------------ can_fold_nested


def _fold_spawner(pkg, kind):
    if kind == "dead_rank":  # destroy-on-collision parents claim by dead-slot rank
        sp = _chained(pkg, 2)
        col = pkg.ParticleCollisionSettings(destroy_on_collision=True)
        ps = (dataclasses.replace(sp.particle_settings[0], collision_settings=col),) + tuple(sp.particle_settings[1:])
        return dataclasses.replace(sp, particle_settings=ps)
    if kind == "no_valid_nested":  # nested + one-shot pacing never emits (core.rs:481)
        sp = _chained(pkg, 2)
        es = dataclasses.replace(sp.emission_settings[1], emission_pacing=pkg.EmissionPacing.one_shot(5))
        return dataclasses.replace(sp, emission_settings=(sp.emission_settings[0], es))
    if kind == "global_only":
        sp = _chained(pkg, 1)
        return sp
    return _chained(pkg, 2)


# (spawner, capacity, nested_buffer, the port's answer, the JAX package's)
FOLD_CASES = {
    "ring": ("ring", 8192, 128, True, True),
    "dead_rank": ("dead_rank", 8192, 128, False, False),
    "no_valid_nested": ("no_valid_nested", 8192, 128, False, False),
    "global_only": ("global_only", 8192, 128, False, False),
    "capacity_equals_m": ("ring", 8192, 8192, False, False),
    # the reference's Mosaic layout conditions, which the port drops: a
    # capacity off its 64 x 128-lane tile, an M off 128 lanes
    "ragged_capacity": ("ring", 8192 + 256, 128, True, False),
    "m_not_a_multiple_of_128": ("ring", 8192, 100, True, False),
}


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_can_fold_nested_matches_jax(case):
    """The port's predicate against the JAX package's on its semantic
    conditions (ring claim, a valid nested emitter, capacity > M); the
    layout conditions the port dropped are the two cases where they part."""
    kind, capacity, m, want_port, want_jax = FOLD_CASES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the invalid nested pacing's compile warning
        cj = jx.compile_spawner(_fold_spawner(jx, kind), nested_buffer=m)
        cp = pt.compile_spawner(_fold_spawner(pt, kind), nested_buffer=m, device="cpu")
    assert jfs.can_fold_nested(cj.static, capacity) == want_jax
    assert fs.can_fold_nested(cp.static, capacity) == want_port


# ------------------------------------------------- the carry against the JAX fold


def _canonical_row(le, state: dict, e: int) -> np.ndarray:
    """One emitter's anchor row in its observable class (`_canonical_le`)."""
    full = np.zeros((3,) + le.shape, np.float32)
    full[e] = le
    return _canonical_le(full, state["lifetime"], state["ptype"], state["alive"], {e: OFFS[e]}, TARGETS)[e]


def _compare_carries(cj: dict, cp: dict, sj: dict, sp: dict, exact_parents: bool, label: str):
    assert sorted(cj) == sorted(cp) == [1, 2]
    for e in cp:
        le_j, total_j, pv_j = cj[e]
        le_p, total_p, pv_p = cp[e]
        assert int(total_j) == int(total_p) > 0, (label, e)
        assert _ulps(_canonical_row(np.asarray(le_j), sj, e), _canonical_row(le_p.numpy(), sp, e)).max() <= 1, label
        for k, v in pv_p.items():
            if exact_parents:
                np.testing.assert_array_equal(np.asarray(pv_j[k]), v.numpy(), err_msg=f"{label} {e} {k}")
            else:
                np.testing.assert_allclose(np.asarray(pv_j[k]), v.numpy(), atol=2e-5, rtol=1e-6,
                                           err_msg=f"{label} {e} {k}")


def test_fold_carry_matches_jax_fold_outputs(jax_fold):
    """The 3-stage chained config (tests/test_nested.py:430-452's stages,
    with test_torch_nested.py's constant global draws), 8192 lanes,
    nested_buffer 512: from one state (20 port frames, handed to the JAX
    package), each package's seed carry and the carry of one folded frame
    (`fused_step_hybrid(..., nested_carry=seed, fold_out=True)`; the JAX
    fold epilogue in interpret mode): totals exact, parent values exact on
    the shared state and within 2e-5 after the frame, new_le within 1 ulp
    canonicalised; the post-frame pools match."""
    cj = jx.compile_spawner(_chained(jx, 3), nested_buffer=512)
    cp = pt.compile_spawner(_chained(pt, 3), nested_buffer=512, device="cpu")
    fj, fp = jx.make_frame_input(1 / 50), pt.make_frame_input(1 / 50)
    sp, _o = pt.multi_step_auto(cp.static, cp.params, None, pt.init_pool_for(cp, 8192, 0), fp, 20)
    sj = jx.PoolState(**{k: jnp.asarray(v) for k, v in interop.pool_to_numpy(sp).items()})

    def seeded_fold(static, params, s, f):
        seed = jfs._seed_nested_carry(static, params, s)
        return seed, jfs.fused_step_hybrid(static, params, None, s, f, nested_carry=seed, fold_out=True)

    with pltpu.force_tpu_interpret_mode():
        seed_j, (s2j, _oj, carry_j) = jax.jit(seeded_fold, static_argnums=(0,))(cj.static, cj.params, sj, fj)
    seed_p = fs._seed_nested_carry(cp.static, cp.params, sp)
    s2p, _op, carry_p = pt.fused_step_hybrid(cp.static, cp.params, None, sp, fp, nested_carry=seed_p, fold_out=True)
    shared = interop.pool_to_numpy(sp)
    _compare_carries(seed_j, seed_p, shared, shared, True, "seed")
    a = {k: np.asarray(getattr(s2j, k)) for k in POOL_FIELDS}
    b = interop.pool_to_numpy(s2p)
    assert_pools_match(a, b)
    np.testing.assert_array_equal(a["ptype"][a["alive"]], b["ptype"][b["alive"]])
    _compare_carries(carry_j, carry_p, a, b, False, "fold")


def test_folded_chain_matches_jax_folded_chain(jax_fold):
    """30 frames of the port's `multi_step_auto` (folded) against the JAX
    package's `_chain_nested_folded` (interpret mode) on the same config,
    from an empty pool: every f32 field within 2e-5, cursor, alive, types
    and key exact, the last frame's per-type counts and nested counts
    exact, last_emitted within 1 ulp canonicalised."""
    cj = jx.compile_spawner(_chained(jx, 3), nested_buffer=512)
    cp = pt.compile_spawner(_chained(pt, 3), nested_buffer=512, device="cpu")
    assert fs.can_fold_nested(cp.static, 8192) and jfs.can_fold_nested(cj.static, 8192)
    chain = jax.jit(lambda st, p, s, f: jfs._chain_nested_folded(st, p, None, s, f, 30), static_argnums=(0,))
    with pltpu.force_tpu_interpret_mode():
        sj, oj = chain(cj.static, cj.params, jx.init_pool_for(cj, 8192, 0), jx.make_frame_input(1 / 50))
    sp, op = pt.multi_step_auto(cp.static, cp.params, None, pt.init_pool_for(cp, 8192, 0), pt.make_frame_input(1 / 50),
                                30)
    a = {k: np.asarray(getattr(sj, k)) for k in POOL_FIELDS}
    b = interop.pool_to_numpy(sp)
    assert_pools_match(a, b)
    np.testing.assert_array_equal(a["ptype"][a["alive"]], b["ptype"][b["alive"]])
    for k in ("alive_count_per_type", "nested_deferred", "nested_dropped"):
        np.testing.assert_array_equal(np.asarray(getattr(oj, k)), getattr(op, k).numpy(), err_msg=k)
    le_j = _canonical_le(a["last_emitted"], a["lifetime"], a["ptype"], a["alive"], OFFS, TARGETS)
    le_p = _canonical_le(b["last_emitted"], b["lifetime"], b["ptype"], b["alive"], OFFS, TARGETS)
    assert _ulps(le_j, le_p).max() <= 1
    assert min(op.alive_count_per_type.tolist()) > 0


# ----------------------------------------------- folded against unfolded (port)

CHAIN_CONFIGS = {
    "nested_60k": lambda: cfg.bench_nested(False),  # bench.py's nested cell's spawner
    "two_stage": lambda: _chained(pt, 2),
    "three_stage": lambda: _chained(pt, 3),
}


@pytest.mark.parametrize("config", sorted(CHAIN_CONFIGS))
def test_folded_chain_equals_unfolded(config):
    """Two consecutive 20-frame chains, 8192 lanes, nested_buffer 128 (the
    parents ask for more: deferral cuts them): `multi_step_auto` (folded)
    == `chain_hybrid_unfolded`, every pool field, every output and the
    deferred and dropped counts, with torch.equal."""
    c = pt.compile_spawner(CHAIN_CONFIGS[config](), nested_buffer=128, device="cpu")
    assert fs.can_fold_nested(c.static, 8192)
    f = pt.make_frame_input(1 / 50)
    s = pt.init_pool_for(c, 8192, 0)
    deferred = 0
    for i in range(2):
        s, out = cfg.check_folded_equals_unfolded(c, s, f, 20, label=f"{config} chain {i}")
        deferred += int(out.nested_deferred)
    assert deferred > 0 and min(out.alive_count_per_type.tolist()) > 0


def test_fold_across_enabled_toggles():
    """nested_60k's spawner, 8192 lanes: four 20-frame chains with the
    global and the nested emitter's enabled bits toggled between them
    (`cfg.TOGGLES`), each folded == unfolded. Nothing dies within the
    chains (lifetimes 2 s), so a paused emitter's type keeps its count."""
    c = pt.compile_spawner(cfg.bench_nested(False), nested_buffer=128, device="cpu")
    live = cfg.check_enabled_toggles(c, pt.init_pool_for(c, 8192, 0), pt.make_frame_input(1 / 50), 20)
    assert live[1][1] == live[0][1] > 0 and live[1][0] > live[0][0]  # the nested emitter paused
    assert live[2][0] == live[1][0] and live[2][1] > live[1][1]  # the rockets paused, their children not
    assert live[3][0] > live[2][0] and live[3][1] > live[2][1]


def test_fold_needs_a_foldable_archetype():
    """A carry or fold_out on an archetype the fold does not take raises;
    chains of it step unfolded."""
    c = pt.compile_spawner(_fold_spawner(pt, "dead_rank"), nested_buffer=128, device="cpu")
    s, f = pt.init_pool_for(c, 8192, 0), pt.make_frame_input(1 / 50)
    with pytest.raises(ValueError, match="can_fold_nested"):
        pt.fused_step_hybrid(c.static, c.params, None, s, f, fold_out=True)
    a, _o = pt.multi_step_auto(c.static, c.params, None, s, f, 3)
    b, _o = fs.chain_hybrid_unfolded(c.static, c.params, None, s, f, 3)
    assert all(torch.equal(getattr(a, k), getattr(b, k)) for k in POOL_FIELDS)


# -------------------------------------------- the entry points that chain frames


def test_multi_step_auto_packed_folds_like_single_frames():
    """`multi_step_auto_packed` (a folded chain of n - 1 frames, then one
    packed frame) against n single hybrid frames, the last packed: state
    and render planes equal."""
    sp = _chained(pt, 2)
    es = dataclasses.replace(sp.emission_settings[1], particle_index=0)  # one type: the render pack serves it
    c = pt.compile_spawner(dataclasses.replace(sp, particle_settings=sp.particle_settings[:1],
                                               emission_settings=(sp.emission_settings[0], es)),
                           nested_buffer=128, device="cpu")
    assert c.static.single_type and fs.can_fold_nested(c.static, 4096)
    f = pt.make_frame_input(1 / 50)
    s0 = pt.init_pool_for(c, 4096, 0)
    a, _oa, planes_a = pt.multi_step_auto_packed(c.static, c.params, None, s0, f, 25)
    b = s0
    for _ in range(24):
        b, _ob = pt.step_auto(c.static, c.params, None, b, f)
    b, _ob, planes_b = pt.step_auto_packed(c.static, c.params, None, b, f)
    for k in POOL_FIELDS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert all(torch.equal(x, y) for x, y in zip(planes_a, planes_b))
    assert int(b.alive.sum()) > 500


def test_scene_step_n_folds_like_single_steps():
    """`Scene.step_n` of the fireworks effect (capacity 2048 beside a child
    buffer of 256: the fold applies) against as many `Scene.step` calls:
    the spawner's state and outputs equal."""
    from bevy_firework_tpu_torch.models import effects

    sp, tf = effects.fireworks()
    scenes = [pt.Scene(device="cpu") for _ in range(2)]
    sids = [sc.add_spawner(sp, capacity=2048, transform=tf, nested_buffer=256) for sc in scenes]
    slot = scenes[0]._spawners[sids[0]]
    assert fs.can_fold_nested(slot.compiled.static, slot.capacity)
    for _ in range(3):
        scenes[0].step_n(1 / 60, 40)
        for _ in range(40):
            scenes[1].step(1 / 60)
    a, b = (sc._spawners[sid] for sc, sid in zip(scenes, sids))
    for k in POOL_FIELDS:
        assert torch.equal(getattr(a.state, k), getattr(b.state, k)), k
    for k in ("alive_count", "alive_count_per_type", "nested_deferred", "nested_dropped"):
        assert torch.equal(getattr(a.outputs, k), getattr(b.outputs, k)), k
    assert min(a.outputs.alive_count_per_type.tolist()) > 0
