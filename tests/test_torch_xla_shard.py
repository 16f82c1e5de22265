"""The port's sharded XLA-layout step (`parallel.sharding.make_sharded_step`
on nested archetypes, or with `prefer_fused=False`; `xla_step.step(shard=,
group=)`) against the JAX package's `make_sharded_step` on the 8 virtual CPU
devices, which runs its GSPMD-jitted XLA step there.

A 3-rank gloo group (tests/torch_distributed_worker.py's `jax_ref` case,
each rank a subprocess with its own 120 s limit, every frame of its share
held bit for bit against the unsharded `xla_step.step`) writes each rank's
final share; stitched along the lanes (1024 and 2048 lanes in 3 uneven
shards), the pool is held against the JAX package's sharded pool after the
same frames from the same seed: integer and bool leaves, `rng_key` and the
outputs' counts exact, f32 fields on live lanes and the AABB within
tests/test_torch_xla_step.py's F32_ATOL + F32_RTOL * |x| (XLA's FMA
contractions and sin/cos polynomials on the CPU). The JAX package's own
`step_jit` is run beside its sharded step and must agree with it on the
same terms. Configs: tests/test_sharding.py's sp spawner (random draws,
through the XLA layout), its nested spawner (ring claim),
effects.fireworks() (ring claim, random lifetimes, bursts) and the
worker's fireworks_floor (its sparkles destroyed on a floor: the dead-rank
claim; claims global, nested, global in a frame)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import bevy_firework_tpu as jx
from bevy_firework_tpu.models import effects as jeffects
from bevy_firework_tpu.parallel import sharding as jsh
from bevy_firework_tpu_torch import prng
from bevy_firework_tpu_torch.parallel.sharding import REPLICATED
from test_torch_common import _one_torch_thread  # noqa: F401
from test_torch_distributed import run_group
from test_torch_xla_step import EXACT_STATE, F32_ATOL, F32_FIELDS, F32_RTOL
from torch_distributed_worker import fireworks_floor

WORLD = 3
EXACT_OUT = ("alive_count", "alive_count_per_type", "finished_event", "aabb_valid", "nested_deferred",
             "nested_dropped")
# name -> (capacity, seed, frames, prefer_fused): the worker's jax_ref_configs
RUNS = {"sp_xla": (8 * 256, 7, 30, False), "nested": (8 * 128, 3, 40, None), "fireworks": (8 * 128, 0, 100, None),
        "fireworks_floor": (8 * 128, 0, 100, None)}


@pytest.fixture(scope="module")
def shares(tmp_path_factory):
    """The gloo group's final shares, one npz per config and rank."""
    out = tmp_path_factory.mktemp("xla_shard")
    ranks = run_group(WORLD, "jax_ref", "--out", str(out))
    assert all(r["ok"] for r in ranks)
    return out


def stitch(out_dir, name):
    """(pool leaves, outputs) of the ranks' shares as one pool: per-lane
    leaves concatenated in lane order, replicated ones equal on every rank."""
    parts = [dict(np.load(out_dir / f"{name}_{r}.npz")) for r in range(WORLD)]
    assert [tuple(p["lanes"]) for p in parts] == [(r * RUNS[name][0] // WORLD, (r + 1) * RUNS[name][0] // WORLD)
                                                  for r in range(WORLD)]
    pool = {}
    for key in (k for k in parts[0] if k.startswith("pool_")):
        k = key[5:]
        if k in REPLICATED:
            for p in parts[1:]:
                np.testing.assert_array_equal(p[key], parts[0][key], err_msg=f"replicated {k}")
            pool[k] = parts[0][key]
        else:
            pool[k] = np.concatenate([p[key] for p in parts], -1)
    outs = {}
    for key in (k for k in parts[0] if k.startswith("out_")):
        for p in parts[1:]:
            np.testing.assert_array_equal(p[key], parts[0][key], err_msg=f"output {key[4:]} differs between ranks")
        outs[key[4:]] = parts[0][key]
    return pool, outs


def jax_config(name):
    """(spawner, collider table or None, frame) of a run, the JAX package's
    types."""
    R, V = jx.RandF32, jx.RandVec3
    if name == "sp_xla":
        return jx.ParticleSpawner(
            particle_settings=[jx.ParticleSettings(lifetime=R.constant(0.4), initial_scale=R.constant(0.1))],
            emission_settings=[jx.EmissionSettings(emission_pacing=jx.EmissionPacing.rate(300.0),
                                                   initial_velocity=V.constant((0.5, 2.0, 0.0)))]), None, \
            jx.make_frame_input(1 / 60)
    if name == "nested":
        return jx.ParticleSpawner(
            particle_settings=[jx.ParticleSettings(lifetime=R.constant(1.0)),
                               jx.ParticleSettings(lifetime=R.constant(0.5))],
            emission_settings=[
                jx.EmissionSettings(particle_index=0, emission_pacing=jx.EmissionPacing.rate(50.0)),
                jx.EmissionSettings(particle_index=1, emission_mode=jx.EmissionMode.nested(0),
                                    emission_pacing=jx.EmissionPacing.count_over_duration(4.0, 1.0, 0.0, 0.5))]), \
            None, jx.make_frame_input(1 / 60)
    if name == "fireworks":  # its transform is the identity
        return jeffects.fireworks()[0], None, jx.make_frame_input(1 / 60)
    sp, floor = fireworks_floor(jx)
    return sp, jx.compile_colliders(floor), jx.make_frame_input(1 / 60)


def mismatches(name, pool, outs, state, out, ring: bool) -> list:
    """Where a pool and outputs part from the JAX package's state and
    outputs: exact leaves and counts, f32 on live lanes within the
    tolerance; the first differing lane of each."""
    bad = []
    live = np.asarray(state.alive)
    for k in EXACT_STATE:
        a, b = np.asarray(getattr(state, k)), pool[k]
        if k == "rng_key":
            b = b.astype(np.uint32)
        if not np.array_equal(a, b):
            bad.append(f"{name}: {k} at {int(np.nonzero(a.ravel() != b.ravel())[0][0])}")
    for k in EXACT_OUT:
        if not np.array_equal(np.asarray(getattr(out, k)), outs[k]):
            bad.append(f"{name}: output {k}: jax {np.asarray(getattr(out, k))} port {outs[k]}")
    for k in F32_FIELDS:
        a, b = np.asarray(getattr(state, k))[live], pool[k][live]
        far = np.abs(a - b) > F32_ATOL + F32_RTOL * np.abs(a)
        if far.any():
            bad.append(f"{name}: {k} at lane {int(np.nonzero(live)[0][np.argmax(far)])}")
    for k in ("aabb_min", "aabb_max"):
        a = np.asarray(getattr(out, k))
        if (np.abs(a - outs[k]) > F32_ATOL + F32_RTOL * np.abs(a)).any():
            bad.append(f"{name}: output {k}: jax {a} port {outs[k]}")
    if ring:  # the ring's stored plane is its derived one
        if not np.array_equal(live, pool["age"] < pool["lifetime"]):
            bad.append(f"{name}: alive != age < lifetime")
    return bad


@pytest.mark.parametrize("name", list(RUNS))
def test_stitched_shards_match_jax_make_sharded_step(shares, name):
    """The stitched port pool == the JAX package's make_sharded_step pool on
    the 8 virtual CPU devices (and its step_jit beside it), as the module
    docstring says."""
    cap, seed, frames, prefer = RUNS[name]
    sp, table, frame = jax_config(name)
    c = jx.compile_spawner(sp)
    assert c.static.ring_claim == (name != "fireworks_floor")
    mesh = jsh.make_mesh(8)
    sharded = jsh.make_sharded_step(c.static, mesh, prefer_fused=prefer)
    sj = jsh.shard_pool(jx.init_pool_for(c, cap, seed=seed), mesh)
    uj = jx.init_pool_for(c, cap, seed=seed)
    for _ in range(frames):
        sj, oj = sharded(c.params, table, sj, frame)
        uj, ou = jx.step_jit(c.static, c.params, table, uj, frame)
    assert not sj.px.sharding.is_fully_replicated
    # the reference's two routes agree: no seam between them on these runs
    unsharded = {f.name: np.asarray(getattr(uj, f.name)) for f in dataclasses.fields(uj)}
    assert mismatches(f"{name} (jax step_jit)", unsharded, {k: np.asarray(getattr(ou, k)) for k in
                                                            EXACT_OUT + ("aabb_min", "aabb_max")},
                      sj, oj, c.static.ring_claim) == []
    pool, outs = stitch(shares, name)
    assert mismatches(name, pool, outs, sj, oj, c.static.ring_claim) == []
    assert int(outs["alive_count"]) > 0
    if name != "sp_xla":  # both types live: parents and their children
        assert (outs["alive_count_per_type"] > 0).all()


@pytest.mark.parametrize("route", ["numpy", "int64"])
def test_threefry_column_window_matches_jax(monkeypatch, route):
    """threefry_uniform's column window (a shard's lanes of a (rows, N)
    draw), on the CPU's numpy route and the card's int64 route: the same
    bits as the same columns of jax.random.uniform over the whole shape,
    with and without a row subset, windows at the start, inside and at
    the end."""
    if route == "int64":
        monkeypatch.setattr(prng, "_numpy_route", lambda device, shape: False)
    for seed, shape in ((0, (12, 3001)), (5, (9, 1024))):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.uniform(key, shape, jax.numpy.float32))
        words = np.asarray(key).astype(np.uint32)
        n = shape[1]
        for a, b in ((0, n // 3), (n // 3, 2 * n // 3), (2 * n // 3, n)):
            got = prng.threefry_uniform(words, shape, cols=(a, b))
            np.testing.assert_array_equal(got.numpy(), want[:, a:b])
            rows = [0, 3, shape[0] - 1]
            got = prng.threefry_uniform(words, shape, rows=rows, cols=(a, b))
            np.testing.assert_array_equal(got.numpy(), want[rows, a:b])
        assert prng.threefry_uniform(words, shape, rows=[1]).shape == (1, n)
    assert torch.equal(prng.threefry_uniform(words, (4, 10)), prng.threefry_uniform(words, (4, 10), cols=(0, 10)))
