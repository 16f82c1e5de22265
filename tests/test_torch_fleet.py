"""Fleets and archetype groups of the port against the JAX package, on the CPU.

The port's `Fleet`, its stacked key chain, its `fused_step_fleet` and
`multi_step_fleet` (their plain versions here: S solo plain steps stacked;
on a card the fleet kernel, checked by test_torch_kernel.py and
chip_smoke.py's `fleet_det`), held to S solo steps bit for bit and to the
JAX package lane for lane on deterministic configs (constant draws: the two
packages' per-lane generators differ), within 2e-5 (XLA on the CPU
contracts multiply-adds into FMAs; the port rounds every operation), with
counts, cursors, cadence scalars and keys exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
import torch_fleet_configs as cfg
from bevy_firework_tpu.fleet import Fleet as JaxFleet
from bevy_firework_tpu.ops import fused_step as jfs
from bevy_firework_tpu.parallel import sharding as jsh
from bevy_firework_tpu_torch import prng
from bevy_firework_tpu_torch.fleet import Fleet
from bevy_firework_tpu_torch.models import effects as peffects
from bevy_firework_tpu_torch.ops import fused_step as fs
from bevy_firework_tpu_torch.parallel import sharding as psh
from test_torch_common import (  # noqa: F401
    _one_torch_thread,
    assert_pools_match,
    det_spawner,
    jax_pool_numpy,
)

CPU = torch.device("cpu")


def _burst(pkg, n=10, lifetime=0.2):
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(lifetime=pkg.RandF32.constant(lifetime),
                                                initial_scale=pkg.RandF32.constant(0.1),
                                                acceleration=(0, 0, 0), linear_drag=0.0)],
        emission_settings=[pkg.EmissionSettings(emission_pacing=pkg.EmissionPacing.one_shot(n),
                                                initial_velocity=pkg.RandVec3.constant((0, 1, 0)))],
    )


def _stacked_numpy(states, i) -> dict:
    """Slot i of a stacked port pool as numpy leaves."""
    return pt.interop.pool_to_numpy(psh.state_slot(states, i))


# ---------------------------------------------------------------------------
# ports of tests/test_fleet.py
# ---------------------------------------------------------------------------


def test_fleet_one_shot_lifecycle():
    """Two bursts, their render items at their transforms, finished events
    and slot recycling; every frame's live count and the finished slots
    equal the JAX Fleet's, the rows lane for lane."""
    fleet, jfleet = Fleet(_burst(pt), capacity=32, max_spawners=8, device="cpu"), \
        JaxFleet(_burst(jx), capacity=32, max_spawners=8)
    a = fleet.activate(pt.Transform(translation=(1, 0, 0)))
    b = fleet.activate(pt.Transform(translation=(5, 0, 0)))
    assert (a, b) == (jfleet.activate(jx.Transform(translation=(1, 0, 0))),
                      jfleet.activate(jx.Transform(translation=(5, 0, 0))))
    fleet.step(1 / 60)
    jfleet.step(1 / 60)
    assert fleet.alive_count() == jfleet.alive_count() == 20  # 10 each
    items, jitems = fleet.render_items(), jfleet.render_items()
    assert len(items) == 2 and [(i.spawner_id, i.count) for i in items] == [(i.spawner_id, i.count) for i in jitems]
    for x, y in zip(items, jitems):
        np.testing.assert_allclose(x.instances, y.instances, atol=2e-5, rtol=0)
    xs = sorted(i.instances[:, 0].mean() for i in items)
    assert abs(xs[0] - 1.0) < 0.1 and abs(xs[1] - 5.0) < 0.1
    finished, jfinished = [], []
    for _ in range(20):
        fleet.step(1 / 60)
        jfleet.step(1 / 60)
        assert fleet.alive_count() == jfleet.alive_count()
        finished += fleet.drain_finished()
        jfinished += jfleet.drain_finished()
    assert sorted(finished) == sorted(jfinished) == [a, b]
    assert fleet.active_slots() == []
    c = fleet.activate(pt.Transform(translation=(-3, 0, 0)))
    assert c == 0
    fleet.step(1 / 60)
    assert fleet.alive_count() == 10


def test_inactive_slots_do_nothing():
    fleet = Fleet(_burst(pt), capacity=32, max_spawners=4, device="cpu")
    fleet.step(1 / 60)
    assert fleet.alive_count() == 0
    fleet.activate()
    fleet.step(1 / 60)
    assert fleet.alive_count() == 10  # only the active slot emits


def test_fleet_full_raises():
    fleet = Fleet(_burst(pt, lifetime=10.0), capacity=32, max_spawners=2, device="cpu")
    fleet.activate()
    fleet.activate()
    with pytest.raises(RuntimeError, match="Fleet full"):
        fleet.activate()


def test_fleet_slots_draw_distinct_random_streams():
    """Sibling slots draw different randomness; a re-activated slot keeps
    its own advancing key (no replay of its stream); the slots' keys follow
    the JAX Fleet's exactly."""
    def sp(pkg):
        return pkg.ParticleSpawner(
            particle_settings=[pkg.ParticleSettings(lifetime=pkg.RandF32.constant(5.0))],
            emission_settings=[pkg.EmissionSettings(
                emission_pacing=pkg.EmissionPacing.one_shot(8),
                initial_velocity=pkg.RandVec3(pkg.RandF32(1.0, 5.0), (0, 1, 0), 1.0))])

    fleet, jfleet = Fleet(sp(pt), capacity=32, max_spawners=4, device="cpu"), JaxFleet(sp(jx), capacity=32,
                                                                                          max_spawners=4)
    a, b = fleet.activate(), fleet.activate()
    jfleet.activate(), jfleet.activate()
    fleet.step(1 / 60)
    jfleet.step(1 / 60)
    vy, alive = fleet.states.vy.numpy(), fleet.states.alive.numpy()
    va, vb = np.sort(vy[a][alive[a]]), np.sort(vy[b][alive[b]])
    assert va.size == vb.size == 8 and not np.allclose(va, vb), "sibling slots emitted identical random draws"
    fleet.deactivate(a)
    jfleet.deactivate(a)
    assert fleet.activate() == a
    jfleet.activate()
    fleet.step(1 / 60)
    jfleet.step(1 / 60)
    vy2, alive2 = fleet.states.vy.numpy(), fleet.states.alive.numpy()
    va2 = np.sort(vy2[a][alive2[a]][:8])
    assert not np.allclose(va, va2), "re-activated slot replayed its stream"
    np.testing.assert_array_equal(fleet.states.rng_key.numpy().astype(np.uint32),
                                  np.asarray(jfleet.states.rng_key).astype(np.uint32))


def test_multi_step_fleet_matches_sequential():
    """multi_step_fleet (one shared params, U = 8 chains) equals each slot
    stepped alone through multi_step_auto, bit for bit."""
    sp, _tf = peffects.sparks(rate=400.0)
    c = pt.compile_spawner(sp, device="cpu")
    S, N, F = 3, 2048, 40
    pools = [pt.init_pool_for(c, N, seed=i) for i in range(S)]
    frames = [pt.make_frame_input(1 / 60, translation=(float(i), 0.0, 0.0)) for i in range(S)]
    st, out = fs.multi_step_fleet(c.static, c.params, None, psh.stack_pools(pools), psh.stack_frames(frames), F)
    for i in range(S):
        si, oi = fs.multi_step_auto(c.static, c.params, None, pools[i], frames[i], F)
        assert int(oi.alive_count) == int(out.alive_count[i]) > 0
        for k, v in pt.interop.pool_to_numpy(si).items():
            np.testing.assert_array_equal(v, _stacked_numpy(st, i)[k], err_msg=f"slot {i} {k}")


# ---------------------------------------------------------------------------
# the stacked key chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 5, 12])
def test_stacked_key_chain_matches_jax_fleet_prelude(S):
    """frame_seeds_stacked over S keys for 20 frames (launches of U = 1, 8,
    3 and 8 frames)
    against the JAX fleet prelude's per-slot chain: `key, frame_key =
    jax.random.split(key)` per frame under vmap, the seed word 0 of the
    frame key. Keys and seeds bit for bit, and each slot's chain equal to
    the solo `frame_seeds`."""
    seeds = (0, 1, 7, -3, 2**31 + 5, 11, 12, 13, 2**32 - 1, 99, 100, 12345)[:S]
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in seeds]).astype(np.uint32)

    def prelude(key, u):
        seeds = []
        for _ in range(u):
            key, frame_key = jax.random.split(key)
            seeds.append(frame_key[0])
        return key, jnp.stack(seeds)

    jkeys, pkeys = jnp.asarray(keys), keys
    for u in (1, 8, 3, 8):
        jkeys, jseeds = jax.vmap(lambda k, u=u: prelude(k, u))(jkeys)
        solo = [prng.frame_seeds(k, u) for k in pkeys]
        pkeys, pseeds = prng.frame_seeds_stacked(pkeys, u)
        assert pkeys.dtype == pseeds.dtype == np.uint32 and pseeds.shape == (S, u)
        np.testing.assert_array_equal(pseeds, np.asarray(jseeds))
        np.testing.assert_array_equal(pkeys, np.asarray(jkeys))
        np.testing.assert_array_equal(pkeys, np.stack([k for k, _s in solo]))
        np.testing.assert_array_equal(pseeds, np.array([s for _k, s in solo], np.uint32))


# ---------------------------------------------------------------------------
# fused_step_fleet's plain version against S solo fused_step calls
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", cfg.CASES)
def test_fleet_plain_equals_solo_steps(case):
    """Per-slot params, seeds, frames (and fields) that differ: every pool
    leaf, output and render plane of each slot equals its solo fused_step,
    launch for launch (ring, a destroy-on-collision archetype with a
    handler, 3 types with stats, force fields, the render pack at U = 8)."""
    res = cfg.check_fleet_equals_solo(case, CPU, 1000)
    assert len(set(res["live"])) == cfg.S and min(res["live"]) > 50, res
    if case == "destroy_dump":
        assert res["destroyed"] > 50, res


def test_fleet_shared_and_stacked_params_agree():
    """One SpawnerParams shared by every slot steps as the same params
    stacked S times; the kernel's stacked table holds each member's table."""
    c = pt.compile_spawner(det_spawner(pt), device="cpu")
    pools = psh.stack_pools([pt.init_pool_for(c, 512, seed=i) for i in range(3)])
    frames = psh.stack_frames([pt.make_frame_input(1 / 50, translation=(float(i), 0.0, 0.0)) for i in range(3)])
    P = psh.stack_params([c.params] * 3)
    a, oa = fs.fused_step_fleet(c.static, c.params, None, pools, frames, unroll=8)
    b, ob = fs.fused_step_fleet(c.static, P, None, pools, frames, unroll=8)
    for k, v in pt.interop.pool_to_numpy(a).items():
        np.testing.assert_array_equal(v, pt.interop.pool_to_numpy(b)[k], err_msg=k)
    assert torch.equal(oa.alive_count, ob.alive_count)
    tables = fs.kernel_tables(c.static, P)
    assert tables.shape == (3, fs.kernel_tables(c.static, c.params).numel()) and all(
        torch.equal(t, fs.kernel_tables(c.static, c.params))
                                                          for t in tables)


def test_fleet_entry_points_check_their_inputs():
    """Nested archetypes go through step_auto_fleet (members one by one,
    the JAX package's vmapped hybrid); fused_step_fleet and
    multi_step_fleet refuse what they do not take."""
    sp, _tf = peffects.fireworks()
    c = pt.compile_spawner(sp, device="cpu")
    assert not fs.can_fleet(c.static)
    pools = [pt.init_pool_for(c, 1024, seed=i) for i in range(2)]
    frames = [pt.make_frame_input(1 / 60, translation=(float(i), 0.0, 0.0)) for i in range(2)]
    with pytest.raises(ValueError, match="step_auto_fleet"):
        fs.fused_step_fleet(c.static, c.params, None, psh.stack_pools(pools), psh.stack_frames(frames))
    st, out = fs.multi_step_fleet_stacked(c.static, c.params, None, psh.stack_pools(pools),
                                          psh.stack_frames(frames), 30)
    for i in range(2):
        si, oi = fs.multi_step_auto(c.static, c.params, None, pools[i], frames[i], 30)
        assert torch.equal(out.alive_count_per_type[i], oi.alive_count_per_type)
        for k, v in pt.interop.pool_to_numpy(si).items():
            np.testing.assert_array_equal(v, _stacked_numpy(st, i)[k], err_msg=f"slot {i} {k}")
    cd = pt.compile_spawner(det_spawner(pt), device="cpu")
    dpools = psh.stack_pools([pt.init_pool_for(cd, 256, seed=i) for i in range(2)])
    with pytest.raises(ValueError, match="stacked over the 2 slots"):
        fs.fused_step_fleet(cd.static, cd.params, None, dpools, psh.stack_frames(frames[:1]))
    with pytest.raises(ValueError, match="shared SpawnerParams"):
        fs.multi_step_fleet(cd.static, psh.stack_params([cd.params] * 2), None, dpools, psh.stack_frames(frames), 3)


def test_stack_helpers_view_and_take_insert():
    """A member's view is a slice of the stacked leaves (no copy); alive
    counts and capacity read the last axis; take_insert gathers kept slots
    and inserts new rows without touching its input."""
    c = pt.compile_spawner(det_spawner(pt), device="cpu")
    pools = [pt.init_pool_for(c, 64, seed=i) for i in range(4)]
    st = psh.stack_pools(pools)
    assert st.capacity == 64 and st.alive_count().shape == (4,)
    v = psh.state_slot(st, 2)
    assert v.px.data_ptr() == st.px[2].data_ptr() and v.rng_key.tolist() == pools[2].rng_key.tolist()
    fresh = psh.stack_pools([pt.init_pool_for(c, 64, seed=99)])
    out = psh.take_insert(st, [3, 0, 1], [1], fresh)
    assert out.rng_key.tolist() == [pools[3].rng_key.tolist(), fresh.rng_key[0].tolist(), pools[1].rng_key.tolist()]
    assert st.rng_key.tolist() == [p.rng_key.tolist() for p in pools]


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def test_multi_step_fleet_matches_jax_multi_step_fleet():
    """The deterministic spawner (constant draws) as a 3-slot fleet with
    per-slot transforms, 20 frames (U = 8, 8, then singles) through both
    packages' multi_step_fleet: pools lane for lane, keys, cursors, cadence
    and counts exact."""
    S, N, F = 3, 2048, 20
    jc = jx.compile_spawner(det_spawner(jx))
    c = pt.compile_spawner(det_spawner(pt), device="cpu")
    jstates = jsh.stack_pools([jx.init_pool_for(jc, N, i) for i in range(S)])
    jframes = jsh.stack_frames([jx.make_frame_input(1 / 50, translation=(float(i), 0.5, 0.0)) for i in range(S)])
    states = psh.stack_pools([pt.init_pool_for(c, N, seed=i) for i in range(S)])
    frames = psh.stack_frames([pt.make_frame_input(1 / 50, translation=(float(i), 0.5, 0.0)) for i in range(S)])
    js, jo = jfs.multi_step_fleet(jc.static, jc.params, None, jstates, jframes, F)
    st, out = fs.multi_step_fleet(c.static, c.params, None, states, frames, F)
    np.testing.assert_array_equal(out.alive_count.numpy(), np.asarray(jo.alive_count))
    assert out.alive_count.min() > 0
    for i in range(S):
        want = {k: v[i] for k, v in jax_pool_numpy(js).items()}
        got = _stacked_numpy(st, i)
        assert_pools_match(got, want)
        for k in ("time_in_cycle", "last_emission"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_fleet_matches_the_jax_fleet_kernel_in_interpret_mode():
    """The JAX package's Pallas fleet kernel (grid = (S, tiles)), run in
    interpret mode, against the port's fused_step_fleet: S = 2 slots of
    8192 lanes with per-slot transforms, 3 frames, the deterministic
    spawner: pools lane for lane, counts, cursors and keys exact."""
    from jax.experimental.pallas import tpu as pltpu

    S, N = 2, 8192
    jc = jx.compile_spawner(det_spawner(jx))
    c = pt.compile_spawner(det_spawner(pt), device="cpu")
    jstates = jsh.stack_pools([jx.init_pool_for(jc, N, i) for i in range(S)])
    jframes = jsh.stack_frames([jx.make_frame_input(1 / 50, translation=(float(i), 0.5, 0.0)) for i in range(S)])
    states = psh.stack_pools([pt.init_pool_for(c, N, seed=i) for i in range(S)])
    frames = psh.stack_frames([pt.make_frame_input(1 / 50, translation=(float(i), 0.5, 0.0)) for i in range(S)])
    P = psh.stack_params([c.params] * S)
    with pltpu.force_tpu_interpret_mode():
        for _ in range(3):
            jstates, jo = jfs.fused_step_fleet(jc.static, jsh.stack_params([jc.params] * S), None, jstates, jframes)
            states, out = fs.fused_step_fleet(c.static, P, None, states, frames)
            np.testing.assert_array_equal(out.alive_count.numpy(), np.asarray(jo.alive_count))
    assert out.alive_count.min() > 100
    for i in range(S):
        assert_pools_match(_stacked_numpy(states, i), {k: v[i] for k, v in jax_pool_numpy(jstates).items()})
