"""Scale-out of the port (kernel row 11's plain version, `parallel.sharding`)
against itself unsharded and against the JAX package, on the CPU.

A pool split over S shards steps each shard with `fused_step(...,
shard=(lane_base, global_n, dead_offset))` (on the CPU the plain version,
`step.plain_frames` with the shard): stitched, the shards equal the
unsharded pool bit for bit, random draws included (Philox counts the
global lane). Against the JAX package: its Pallas kernel with the same
manual split (`fused_step(_shard_override=...)`, interpret mode) on the
deterministic spawners of tests/test_sharded_fused.py (constant draws: the
packages' per-lane generators differ), alive slot for slot, cursor and
spawn counts exact, fields within 2e-5 and the cadence's f32 carries within
1 ulp (XLA on the CPU contracts multiply-adds into FMAs, the port rounds
every operation); and its `make_sharded_step`
on the 8 virtual CPU devices. The gloo process groups run in
tests/test_torch_distributed.py."""

import dataclasses

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
import torch_shard_configs as sc
from bevy_firework_tpu.ops import fused_step as jfs
from bevy_firework_tpu.parallel import sharding as jsh
from bevy_firework_tpu_torch import xla_step
from bevy_firework_tpu_torch.models import effects as peffects
from bevy_firework_tpu_torch.ops import fused_step as fs
from bevy_firework_tpu_torch.parallel import sharding as psh
from bevy_firework_tpu_torch.step import NESTED_SHARD_MESSAGE, Shard, plain_frames
from test_sharded_fused import _det_spawner
from test_torch_common import _one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _port_det_spawner(ring: bool):
    """tests/test_sharded_fused.py's `_det_spawner`, in the port's types."""
    ps = dict(lifetime=pt.RandF32.constant(0.4), initial_scale=pt.RandF32.constant(0.1),
              scale_curve=pt.FireworkCurve.uneven_samples([(0.0, 1.0), (1.0, 2.0)]), linear_drag=0.0)
    if not ring:
        ps["collision_settings"] = pt.ParticleCollisionSettings(restitution=0.6, friction=0.2,
                                                                destroy_on_collision=True)
    return pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(**ps)],
        emission_settings=[pt.EmissionSettings(emission_pacing=pt.EmissionPacing.rate(10000.0),
                                               initial_velocity=pt.RandVec3.constant((1.0, -3.0, 0.2)))])


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("name,unroll", [("stress", 1), ("destroy", 1), ("stress", 8)])
def test_sharded_plain_step_equals_unsharded(name, unroll, n_shards):
    """30 frames (a U = 8 chain: 3 launches of 8, 6 single frames): the
    stitched shards == the unsharded pool bit for bit, every leaf; the
    shards' stats reduced == the pool's. Capacities that S does not divide
    give shards of unequal size; the ring starts 500 lanes before its end,
    so its claims wrap."""
    c, table, frame = sc.config(name, CPU, rate=4e3 if name == "stress" else 2e4)
    whole = pt.init_pool_for(c, 3001 if n_shards == 4 else 3000, device=CPU)
    whole = dataclasses.replace(whole, ring_cursor=torch.tensor(whole.capacity - 500, dtype=torch.int32))
    shards = sc.split(whole, n_shards)
    shape = fs.chain_shape(30, unroll) if unroll > 1 else [1] * 30
    for i, u in enumerate(shape):
        whole, out = fs.fused_step(c.static, c.params, table, whole, frame, unroll=u)
        shards, outs, _p = sc.step_shards(c, table, shards, frame, unroll=u)
        assert sc.pool_mismatch(sc.stitch(shards), whole) == [], f"launch {i}"
        assert sc.outputs_mismatch(out, sc.reduce_outputs(outs)) == [], f"launch {i}"
    assert 0 < int(out.alive_count) < whole.capacity
    if name == "destroy":
        assert not c.static.ring_claim and int((~whole.alive).sum()) > 0


def _prefill(pool, ring: bool):
    """Lanes [0, 8000) of shard 0 alive, every third near the floor: the
    frames' claims cross into shard 1, and on the dead-rank archetype the
    floor destroys lanes at scattered ranks."""
    pool = {k: np.array(v) for k, v in pool.items()}
    live = np.arange(pool["age"].shape[0]) < 8000
    pool["age"] = np.where(live, 0.0, pool["age"]).astype(np.float32)
    pool["py"] = np.where(live & (np.arange(live.size) % 3 == 0), -0.45, 0.5).astype(np.float32)
    if not ring:
        pool["alive"] = live.copy()
        pool["lifetime"] = np.full_like(pool["lifetime"], 0.4)
    return pool


@pytest.mark.parametrize("ring", [True, False])
def test_shard_seam_matches_jax_kernel_override(ring):
    """2 x 8192 lanes, 6 frames, the JAX kernel (interpret mode) with
    `_shard_override` against the port's shards with the same split:
    alive slot for slot, cursor and spawn counts exact, fields within 2e-5;
    the cadence's f32 carries (time in cycle, last emission) within 1 ulp:
    XLA on the CPU contracts rem_euclid's multiply-subtract into an FMA
    (ROADMAP queue 3, "XLA contracts cadence sums on the CPU")."""
    n, half = 2 * 8192, 8192
    cols = None if ring else [jx.Collider.halfspace(position=(0.0, -0.5, 0.0))]
    cj = jx.compile_spawner(_det_spawner(ring))
    cp = pt.compile_spawner(_port_det_spawner(ring), device=CPU)
    assert cj.static.ring_claim == cp.static.ring_claim == ring
    tj = None if ring else jx.compile_colliders(cols)
    tp = None if ring else pt.compile_colliders([pt.Collider.halfspace(position=(0.0, -0.5, 0.0))], device=CPU)
    start = _prefill(pt.interop.pool_to_numpy(pt.init_pool_for(cp, n, device=CPU)), ring)
    if ring:
        start["ring_cursor"] = np.asarray(8000, np.int32)
    whole_p = pt.interop.pool_from_numpy(start, CPU)
    shards_p = sc.split(whole_p, 2)
    shards_j = [jx.PoolState(**{k: (np.asarray(v)[..., r * half:(r + 1) * half] if k not in sc.REPLICATED else
                                    np.asarray(v)) for k, v in start.items()}) for r in range(2)]
    fj, fp = jx.make_frame_input(1 / 50), pt.make_frame_input(1 / 50)
    with pltpu.force_tpu_interpret_mode():
        for frame in range(6):
            dead = [int((~np.asarray(s.alive)).sum()) for s in shards_j]
            shards_j = [jfs.fused_step(cj.static, cj.params, tj, s, fj,
                                       _shard_override=(r * half, n, 0 if ring else sum(dead[:r])))[0]
                        for r, s in enumerate(shards_j)]
            shards_p, _o, _p = sc.step_shards(cp, tp, shards_p, fp)
            for r in range(2):
                a, b = np.asarray(shards_j[r].alive), shards_p[r].alive.numpy()
                np.testing.assert_array_equal(a, b, err_msg=f"frame {frame} shard {r}: alive")
                for k in ("ring_cursor", "manual_queued"):
                    assert int(np.asarray(getattr(shards_j[r], k))) == int(getattr(shards_p[r], k)), k
                for k in ("time_in_cycle", "last_emission"):  # f32 carries: the FMA seam, 1 ulp
                    np.testing.assert_allclose(np.asarray(getattr(shards_j[r], k)), getattr(shards_p[r], k).numpy(),
                                               rtol=1.2e-7, atol=0, err_msg=f"frame {frame} shard {r}: {k}")
                for k in ("px", "py", "pz", "vx", "vy", "vz", "age"):
                    np.testing.assert_allclose(np.asarray(getattr(shards_j[r], k))[a], getattr(shards_p[r], k)[b],
                                               atol=2e-5, err_msg=f"frame {frame} shard {r}: {k}")
    claimed = [int(s.alive.sum()) for s in shards_p]
    assert claimed[1] > 0 and claimed[0] > 0  # the frames' claims reached both shards
    if not ring:
        assert int((~shards_p[0].alive[:8000]).sum()) > 0  # the floor punched holes


def test_shards_match_jax_make_sharded_step():
    """tests/test_sharding.py's sp config: 8 x 256 lanes, 30 frames: the
    port's 8 shards stitched against the JAX package's make_sharded_step on
    the 8 virtual CPU devices: alive plane, ages and counts exact."""
    def spawner(pkg):
        return pkg.ParticleSpawner(
            particle_settings=[pkg.ParticleSettings(lifetime=pkg.RandF32.constant(0.4),
                                                    initial_scale=pkg.RandF32.constant(0.1))],
            emission_settings=[pkg.EmissionSettings(emission_pacing=pkg.EmissionPacing.rate(300.0),
                                                    initial_velocity=pkg.RandVec3.constant((0.5, 2.0, 0.0)))])

    cj = jx.compile_spawner(spawner(jx))
    cp = pt.compile_spawner(spawner(pt), device=CPU)
    mesh = jsh.make_mesh(8)
    sj = jsh.shard_pool(jx.init_pool_for(cj, 8 * 256, seed=7), mesh)
    sharded = jsh.make_sharded_step(cj.static, mesh)
    shards = sc.split(pt.init_pool_for(cp, 8 * 256, seed=7, device=CPU), 8)
    fj, fp = jx.make_frame_input(1 / 60), pt.make_frame_input(1 / 60)
    for _ in range(30):
        sj, oj = sharded(cj.params, None, sj, fj)
        shards, outs, _p = sc.step_shards(cp, None, shards, fp)
    sp = sc.stitch(shards)
    np.testing.assert_array_equal(np.asarray(sj.alive), sp.alive.numpy())
    np.testing.assert_array_equal(np.asarray(sj.age), sp.age.numpy())
    red = sc.reduce_outputs(outs)
    assert int(oj.alive_count) == int(red["alive_count"]) > 0
    np.testing.assert_array_equal(np.asarray(oj.alive_count_per_type), red["alive_count_per_type"].numpy())
    assert int(np.asarray(sj.ring_cursor)) == int(sp.ring_cursor)


def test_nested_archetypes_do_not_shard():
    """The kernel's layout keeps refusing nested archetypes under sharding:
    the seam and the plain step raise NESTED_SHARD_MESSAGE, which names
    make_sharded_step (the card's launch raises it too: test_torch_kernel).
    make_sharded_step does not raise: it steps them sharded in the XLA
    layout, here in a 1-rank gloo group (the 2- and 3-rank groups run in
    tests/test_torch_distributed.py), bit for bit the unsharded
    `xla_step.step`; only prefer_fused=True, the kernel's layout forced,
    raises the same message."""
    import torch.distributed as dist

    from test_torch_distributed import free_port

    c = pt.compile_spawner(peffects.fireworks()[0], device=CPU)
    s = pt.init_pool_for(c, 1024, device=CPU)
    f = pt.make_frame_input(1 / 60)
    with pytest.raises(NotImplementedError, match="make_sharded_step") as e1:
        fs.fused_step(c.static, c.params, None, s, f, shard=(0, 2048, 0))
    with pytest.raises(NotImplementedError) as e2:
        plain_frames(c.static, c.params, s, f, shard=Shard(0, 1024))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    try:
        with pytest.raises(NotImplementedError) as e3:
            psh.make_sharded_step(c.static, prefer_fused=True)
        step = psh.make_sharded_step(c.static)
        share, whole = psh.shard_pool(s), s
        for _ in range(3):
            share, out = step(c.params, None, share, f, 10)
            whole, want = xla_step.multi_step(c.static, c.params, None, whole, f, 10)
            assert sc.pool_mismatch(share, whole) == [] and sc.outputs_mismatch(want, {
                k: getattr(out, k) for k in ("alive_count", "alive_count_per_type", "nested_deferred")}) == []
        assert int(out.alive_count) > 0
    finally:
        dist.destroy_process_group()
    assert str(e1.value) == str(e2.value) == str(e3.value) == NESTED_SHARD_MESSAGE


def test_shard_arguments_are_checked():
    """A shard past the global pool, a group without a shard, or a shard of
    the XLA layout without its group, raises."""
    c, _t, f = sc.config("det", CPU)
    s = pt.init_pool_for(c, 100, device=CPU)
    with pytest.raises(ValueError):
        fs.fused_step(c.static, c.params, None, s, f, shard=(50, 120, 0))
    with pytest.raises(ValueError):
        fs.fused_step(c.static, c.params, None, s, f, group=object())
    with pytest.raises(ValueError):  # the XLA layout's shard needs its group's words
        xla_step.step(c.static, c.params, None, s, f, shard=Shard(0, 200))
    assert psh.split_range(10, 2, 3) == (6, 10) and psh.split_range(10, 0, 3) == (0, 3)


def test_shard_fleet_takes_contiguous_slots():
    """shard_fleet / shard_fleet_2d slice slots and lanes as the groups
    lay them out (without a process group: the slicing alone)."""
    c, _t, _f = sc.config("det", CPU)
    states = psh.stack_pools([pt.init_pool_for(c, 10, seed=i, device=CPU) for i in range(5)])
    got = psh.slice_pool(states, slots=psh.split_range(5, 1, 2), lanes=psh.split_range(10, 1, 2))
    assert tuple(got.px.shape) == (3, 5) and tuple(got.last_emitted.shape) == (3, c.num_emitters, 5)
    assert torch.equal(got.rng_key, states.rng_key[2:5]) and got.px.is_contiguous()
    frames = psh.stack_frames([pt.make_frame_input(1 / 60, translation=(float(i), 0, 0)) for i in range(5)])
    sl = psh._slice_frames(frames, 2, 5)
    assert sl.transform_translation[:, 0].tolist() == [2.0, 3.0, 4.0]
