"""The dead-rank claim's carried counts (kernel row 4) and the sharded
claim's dead offset as a tensor (kernel row 11), on the CPU, against the
JAX package.

A solo dead-rank launch on the card claims from the per-tile dead counts
of its alive plane that the launch which wrote the plane left
(`ops.fused_step.claim_counts`); their plain version is
`step.dead_tile_counts`. Here: those counts on every post-frame plane of a
30-frame destroy chain (`tests/torch_shard_configs.config("destroy")`: the
box emitter destroying on a halfspace) against the dead lanes per tile of
the JAX package's claim on the same plane (its exclusive dead rank,
`cumsum(dead) - dead`, at the tile starts), and each frame of the chain
against the JAX package's step from the same pre-frame state (the Pallas
kernel in interpret mode at 16384 lanes, its XLA step at a ragged 10000):
alive lane for lane, the claimed slots exact (the draws differ: the two
packages' generators do; the chain continues from the port's state). The
carry's keying: an alive plane edited in place, replaced or restacked has
no carried counts. Shards whose dead offsets are int32 tensors (the
exclusive cumsum of the shards' dead totals) equal those with int offsets
and the unsharded pool bit for bit, S = 2, 4, 8. The card's side is in
tests/test_torch_kernel.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
import torch_shard_configs as sc
from bevy_firework_tpu.ops import fused_step as jfs
from bevy_firework_tpu.step import step_jit
from bevy_firework_tpu_torch.interop import pool_to_numpy
from bevy_firework_tpu_torch.ops import fused_step as fs
from bevy_firework_tpu_torch.ops.table_layout import TILE
from bevy_firework_tpu_torch.parallel.sharding import stack_pools
from bevy_firework_tpu_torch.step import Shard, dead_tile_counts
from test_torch_common import _one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
RATE = 2e4


def _jax_box_spawner(rate):
    """tests/torch_fleet_configs.box_spawner(rate, destroy=True) in the JAX
    package's types."""
    return jx.ParticleSpawner(
        particle_settings=[jx.ParticleSettings(
            lifetime=jx.RandF32.constant(2.0), initial_scale=jx.RandF32(0.02, 0.08),
            acceleration=(0.0, -9.81, 0.0), linear_drag=0.1,
            collision_settings=jx.ParticleCollisionSettings(restitution=0.7, friction=0.3,
                                                            destroy_on_collision=True))],
        emission_settings=[jx.EmissionSettings(
            emission_pacing=jx.EmissionPacing.rate(rate), emission_shape=jx.EmissionShape.box((1.5, 0.5, 1.5)),
            initial_velocity=jx.RandVec3(jx.RandF32(0.5, 3.0), (0.0, 1.0, 0.0), 0.0),
            initial_velocity_radial=jx.RandF32(1.0, 4.0))])


def _jax_tile_counts(alive_j) -> np.ndarray:
    """The dead lanes per TILE-lane tile that the JAX package's dead-rank
    claim gives a plane: its exclusive rank (`cumsum(dead) - dead`) at each
    tile's first lane, differenced, the last tile's up to the pool's end."""
    di = (~jnp.asarray(alive_j)).astype(jnp.int32)
    rank = np.asarray(jnp.cumsum(di) - di)
    n = rank.shape[0]
    starts = np.append(rank[::TILE], rank[-1] + int(di[-1]))
    assert starts.shape[0] == -(-n // TILE) + 1
    return np.diff(starts).astype(np.int32)


@pytest.mark.parametrize("n", [16384, 10000])
def test_destroy_chain_counts_and_claims_match_jax(n):
    """30 frames of the destroy config: per frame, the JAX package's step
    from the port's pre-frame state gives the same alive plane lane for
    lane and claims the same slots; the port's per-tile dead counts of the
    post-frame plane (the carry the card's launch leaves) == the dead lanes
    per tile of the JAX claim on it, == the count kernel's plain version
    (`claim_counts` on the CPU) and sum to the plane's dead lanes."""
    c, table, frame = sc.config("destroy", CPU, rate=RATE)
    cj = jx.compile_spawner(_jax_box_spawner(RATE))
    tj = jx.compile_colliders([jx.Collider.halfspace(position=(0.0, -0.8, 0.0))])
    fj = jx.make_frame_input(1 / 60)
    assert not c.static.ring_claim and not cj.static.ring_claim
    s = pt.init_pool_for(c, n, device=CPU)
    fused = jax.jit(jfs.fused_step, static_argnums=(0,))
    claimed = destroyed = 0
    for i in range(30):
        sj = jx.PoolState(**pool_to_numpy(s))
        if n % 8192 == 0:
            with pltpu.force_tpu_interpret_mode():
                sj, _oj = fused(cj.static, cj.params, tj, sj, fj)
        else:
            sj, _oj = step_jit(cj.static, cj.params, tj, sj, fj)
        s2, out = fs.fused_step(c.static, c.params, table, s, frame)
        alive_j = np.asarray(sj.alive)
        np.testing.assert_array_equal(s2.alive.numpy(), alive_j, err_msg=f"frame {i}: alive")
        new_p, new_j = (s2.alive & ~s.alive).numpy(), alive_j & ~s.alive.numpy()
        np.testing.assert_array_equal(new_p, new_j, err_msg=f"frame {i}: claimed slots")
        counts = dead_tile_counts(s2.alive)
        assert counts.dtype == torch.int32 and counts.shape == (-(-n // TILE),)
        np.testing.assert_array_equal(counts.numpy(), _jax_tile_counts(alive_j), err_msg=f"frame {i}: tile counts")
        assert torch.equal(fs.claim_counts(s2.alive), counts)
        assert int(counts.sum()) == int((~s2.alive).sum())
        claimed += int(new_p.sum())
        destroyed += int((s.alive & ~s2.alive & (s2.age < s2.lifetime)).sum())
        s = s2
    # slots were claimed past freed holes, and the floor destroyed lanes
    assert claimed > n // 2 and destroyed > 100 and 0 < int(out.alive_count) < n


def test_dead_tile_counts_plain_version():
    """Per tile and per slot of a stacked plane, a ragged last tile
    included; its exclusive cumsum is `tile_dead_offsets`."""
    rng = np.random.default_rng(3)
    for n in (1, 255, 256, 257, 10000):
        alive = torch.from_numpy(rng.uniform(size=(3, n)) < rng.uniform(size=(3, 1)))
        counts = dead_tile_counts(alive)
        for r in range(3):
            dead = np.pad((~alive[r]).numpy(), (0, -n % TILE))
            np.testing.assert_array_equal(counts[r].numpy(), dead.reshape(-1, TILE).sum(1))
            assert torch.equal(dead_tile_counts(alive[r]), counts[r])
        offs = torch.cumsum(counts, -1, dtype=torch.int32) - counts
        assert torch.equal(fs.tile_dead_offsets(alive), offs)


def test_carried_counts_follow_the_tensor_and_its_version():
    """The carry is keyed on the alive tensor itself: the plane it was kept
    for finds it; an in-place edit, a replaced plane, a copy and a
    restacked pool do not; it goes with its tensor."""
    c, _t, _f = sc.config("destroy", CPU)
    s = pt.init_pool_for(c, 1000, device=CPU)
    alive = s.alive
    counts = dead_tile_counts(alive)
    fs._carry_claim(alive, counts)
    assert fs._carried_claim(alive) is counts
    assert fs._carried_claim(alive.clone()) is None  # replaced (a copy)
    assert fs._carried_claim(dataclasses.replace(s, alive=alive.clone()).alive) is None
    assert fs._carried_claim(stack_pools([s, s]).alive[0]) is None  # restacked
    alive[3] = True  # edited in place
    assert fs._carried_claim(alive) is None
    fs._carry_claim(alive, dead_tile_counts(alive))
    assert fs._carried_claim(alive) is not None
    key = id(alive)
    del alive, s
    assert key not in fs._CLAIM_CARRY


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_tensor_dead_offsets_equal_int_offsets(n_shards):
    """20 frames of the destroy config in S shards of a ragged pool: the
    shards stepped with tensor dead offsets (`shard_args`: the exclusive
    cumsum of the shards' dead totals, int32 0-d tensors) == the same
    shards with the offsets as ints == the unsharded pool, bit for bit."""
    c, table, frame = sc.config("destroy", CPU, rate=RATE)
    whole = pt.init_pool_for(c, 3001, device=CPU)
    shards = ints = sc.split(whole, n_shards)
    for i in range(20):
        args = sc.shard_args(c.static, shards)
        assert all(isinstance(a.dead_offset, torch.Tensor) and a.dead_offset.dtype == torch.int32 for a in args)
        int_args = [Shard(a.lane_base, a.global_n, int(a.dead_offset)) for a in sc.shard_args(c.static, ints)]
        whole, out = fs.fused_step(c.static, c.params, table, whole, frame)
        shards = [fs.fused_step(c.static, c.params, table, s, frame, shard=a)[0] for s, a in zip(shards, args)]
        ints = [fs.fused_step(c.static, c.params, table, s, frame, shard=a)[0] for s, a in zip(ints, int_args)]
        assert sc.pool_mismatch(sc.stitch(shards), whole) == [], i
        assert sc.pool_mismatch(sc.stitch(ints), whole) == [], i
    assert int((~whole.alive).sum()) > 0 and int(out.alive_count) > 0


def test_shard_takes_a_tensor_offset_unread():
    """A Shard and `as_shard` keep a tensor dead offset as it is (no
    host read); an int offset below 0 raises."""
    off = torch.tensor(7, dtype=torch.int32)
    sh = fs.as_shard((0, 200, off), 100)
    assert sh.dead_offset is off and sh.lane_base == 0 and sh.global_n == 200
    assert fs.as_shard(Shard(100, 200, off), 100).dead_offset is off
    with pytest.raises(ValueError):
        Shard(0, 200, -1)
