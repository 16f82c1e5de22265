"""The XLA layout's chain as the card captures it (`ops.chain_graph`'s kind
"xla": the top-level `multi_step` and `step_jit`), held on the CPU against
the JAX package.

  * the host word chain (`prng.xla_chain_keys`, `chain_graph.chain_words`):
    per frame new_key, frame_key = split(key) and fold_in(frame_key, d) for
    each keyed emitter (d = e global, 1000 + e nested), and the key after
    the chain, equal `jax.random.split` / `fold_in`;
  * draws keyed by int64 0-d tensors (`prng.DeviceKey`, read from the
    words) equal the host-key draws bit for bit, on the numpy route and on
    the card's int64 route;
  * the fixed-shape nested write-back (`xla_step.write_children`: the
    dropped children land in a scratch lane) equals the boolean-index
    write, under overflow too;
  * the scan body (`xla_step.chain_frame`: its frame built from the frame
    row, its keys from row t of the words), run n times on the CPU, equals
    `xla_step.multi_step` bit for bit and the JAX package's `multi_step`
    within tests/test_torch_xla_step.py's tolerance (integers and bools
    exact; f32 within 5e-5 + 1e-5 |x| on live lanes);
  * the body reads no value on the host: no `aten._local_scalar_dense`,
    `nonzero` or `masked_select` under a TorchDispatchMode.

The card's side, captured == uncaptured, is
tests/test_torch_xla_graph_card.py (no JAX)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from bevy_firework_tpu_torch import prng, xla_step
from bevy_firework_tpu_torch.ops import chain_graph as cg
from bevy_firework_tpu_torch.ops import fused_step as fs
from bevy_firework_tpu_torch.pool import POOL_FIELDS
from test_torch_common import _one_torch_thread  # noqa: F401
from test_torch_xla_step import EXACT_STATE, F32_ATOL, F32_FIELDS, F32_RTOL, _effects, _library

HOST_READS = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select", "boolean index")


def _tornado(pkg):
    return [pkg.ForceField.vortex((0, 0, 0), (0, 1, 0), strength=12.0, radius=6.0),
            pkg.ForceField.axial((0, 0, 0), (0, 1, 0), strength=25.0, radius=7.0),
            pkg.ForceField.turbulence((0, 2, 0), strength=1.8, radius=8.0, frequency=2.2)]


def _case(pkg, name):
    """(spawner, colliders, force fields, capacity, frames) of a cell at
    the test size, built with either package. fireworks_overflow: the
    fireworks in 96 lanes, whose bursts ask for more lanes than are dead."""
    eff = _effects(pkg)
    R = pkg.EmissionPacing.rate
    if name == "stress_test":
        sp = eff.stress_test()[0]
        es = dataclasses.replace(sp.emission_settings[0], emission_pacing=R(1500.0))
        return dataclasses.replace(sp, emission_settings=(es,)), None, None, 2048, 12
    if name == "sparks":
        return eff.sparks()[0], None, None, 2048, 12
    if name in ("fireworks", "fireworks_overflow"):
        return eff.fireworks()[0], None, None, 96 if name == "fireworks_overflow" else 2048, 100
    if name == "collision":
        sp, _tf, cols = eff.collision()
        es = dataclasses.replace(sp.emission_settings[0], emission_pacing=R(1500.0))
        return dataclasses.replace(sp, emission_settings=(es,)), cols, None, 2048, 60
    if name == "fields":
        return (_library(pkg).dust(rate=1500.0, lifetime=4.0, updraft=2.5, drag=2.0, emit_radius=1.2), None,
                _tornado(pkg), 2048, 12)
    raise ValueError(name)


def _port(name, frame_kw=None):
    sp, cols, ff, cap, n = _case(pt, name)
    c = pt.compile_spawner(sp, device="cpu")
    table = pt.compile_colliders(cols, device="cpu") if cols else None
    fields = pt.compile_force_fields(ff, device="cpu") if ff else None
    frame = pt.make_frame_input(1 / 60, force_fields=fields, **(frame_kw or {}))
    return c, table, frame, pt.init_pool_for(c, cap, 5), n


def body_chain(static, params, colliders, state, frame, n):
    """n frames of the captured chain's body on the CPU, as its graphs run
    them: the words of `chain_words`, the frame row of the kernels' layout,
    stats on the last frame, the key after the chain from the host."""
    words, final = cg.chain_words("xla", static, colliders, state, frame, n)
    buf = torch.cat([torch.zeros(1, dtype=torch.int32), torch.from_numpy(words.view(np.int32).copy())])
    row = torch.from_numpy(fs._frame_row(frame).copy())
    out = None
    for f in range(n):
        state, out = xla_step.chain_frame(static, params, colliders, state, row, frame.force_fields, buf,
                                          stats=f == n - 1)
    assert int(buf[0]) == n
    return dataclasses.replace(state, rng_key=torch.from_numpy(final.astype(np.int64))), out


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# ---------------------------------------------------------------------------
# the host word chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sparks", "fireworks"])
@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_xla_chain_keys_match_jax(name, seed):
    """Per frame the fold-ins of every keyed emitter (fireworks: a global
    launcher and nested bursts, 1000 + e) and the key after 9 frames ==
    jax.random.split / fold_in; chain_words lays them out frame-major."""
    c = pt.compile_spawner(_case(pt, name)[0], device="cpu")
    data = xla_step.keyed_data(c.static)
    if name == "fireworks":
        assert any(d >= 1000 for d in data) and any(d < 1000 for d in data)
    n = 9
    final, keys = prng.xla_chain_keys(np.array([0, seed], np.uint32), n, data)
    key = jax.random.PRNGKey(seed)
    for f in range(n):
        key, fk = jax.random.split(key)
        for j, d in enumerate(data):
            np.testing.assert_array_equal(keys[f, j], np.asarray(jax.random.fold_in(fk, d)), err_msg=f"{f} {d}")
    np.testing.assert_array_equal(final, np.asarray(key))
    state = dataclasses.replace(pt.init_pool_for(c, 64, 0), rng_key=torch.tensor([0, seed], dtype=torch.int64))
    words, final_w = cg.chain_words("xla", c.static, None, state, pt.make_frame_input(1 / 60), n)
    np.testing.assert_array_equal(words, keys.reshape(-1))
    np.testing.assert_array_equal(final_w, final)


# ---------------------------------------------------------------------------
# draws keyed by device words
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 1])
def test_tensor_keyed_draws_equal_host_routes(seed):
    """threefry_uniform under a DeviceKey (int64 0-d tensors) == under the
    host key, whole, by rows (runs and gaps: the elided-row sets) and by a
    column window, on the numpy route and the card's int64 route, and ==
    jax.random.uniform; FrameKeyWords' fold_in == threefry_fold_in."""
    fk = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), 17)).astype(np.uint32)
    data = (0, 2, 1003)
    words = np.stack([prng.threefry_fold_in(fk, d) for d in data]).reshape(-1)
    kw = prng.FrameKeyWords(data, torch.from_numpy(words.view(np.int32).copy()))
    for d in data:
        key = prng.threefry_fold_in(fk, d)
        dk = prng.threefry_fold_in(kw, d)
        assert isinstance(dk, prng.DeviceKey) and dk.k0.dtype == torch.int64 and dk.k0.dim() == 0
        assert (int(dk.k0), int(dk.k1)) == (int(key[0]), int(key[1]))
        shape = (12, 3000)
        want = np.asarray(jax.random.uniform(jax.numpy.asarray(key), shape, jax.numpy.float32))
        for rows, cols in ((None, None), (list(range(8)) + [9, 10, 11], None), (list(range(9)), None),
                           ([0, 2, 5, 11], (1000, 2500))):
            sub = want if rows is None else want[rows]
            sub = sub if cols is None else sub[:, cols[0]:cols[1]]
            host = prng.threefry_uniform(key, shape, rows=rows, cols=cols)
            dev = prng.threefry_uniform(dk, shape, "cpu", rows=rows, cols=cols)
            np.testing.assert_array_equal(host.numpy(), sub)
            np.testing.assert_array_equal(dev.numpy(), sub)
        idx = torch.arange(int(np.prod(shape)), dtype=torch.int64)
        card_route = prng._uniform_int64(int(key[0]), int(key[1]), idx).reshape(shape)
        np.testing.assert_array_equal(card_route.numpy(), want)
    with pytest.raises(KeyError):
        prng.threefry_fold_in(kw, 1)


# ---------------------------------------------------------------------------
# the fixed-shape nested write-back
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("dead_share", [0.0, 0.02, 0.5, 1.0])
def test_fixed_shape_write_back_equals_boolean_index(ring, dead_share):
    """write_children (every child rank writes a plane of N + 1 lanes, the
    dropped ones lane N) == the boolean-index write (`row[slot < N]` into
    `slot[slot < N]`), for the slots a ring window and a dead-rank claim
    give, with more children than dead lanes (overflow) and fewer."""
    rng = np.random.default_rng(int(dead_share * 100) + ring)
    N, M = 1000, 300
    alive = torch.from_numpy(rng.random(N) >= dead_share)
    dead = ~alive
    for n_spawn in (0, 17, M):
        n_spawn = torch.tensor(n_spawn, dtype=torch.int32)
        ranks = torch.arange(M, dtype=torch.int32)
        if ring:
            slot_raw = torch.remainder(torch.tensor(950, dtype=torch.int32) + ranks, N)
            slot = torch.where((ranks < n_spawn) & dead[slot_raw.long()], slot_raw, N)
        else:
            dead_cum = torch.cumsum(dead.to(torch.int32), 0, dtype=torch.int32)
            slot = torch.where(ranks < n_spawn, xla_step.monotone_inverse(dead_cum, M), N)
        plane = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
        row = torch.from_numpy(rng.standard_normal(M).astype(np.float32))
        keep = slot < N
        want = plane.index_put((slot[keep].long(),), row[keep])
        got = xla_step.write_children(plane, slot, row)
        assert got.shape == (N,) and torch.equal(_bits(got), _bits(want))
        assert torch.equal(plane, plane.clone())  # the input plane is not written


# ---------------------------------------------------------------------------
# the scan body against the frames one by one and the JAX package
# ---------------------------------------------------------------------------

BODY_CASES = ("stress_test", "sparks", "fireworks", "fireworks_overflow", "collision", "fields")


@pytest.mark.parametrize("name", BODY_CASES)
def test_body_chain_equals_multi_step_and_jax(name):
    """The body n times (words, the frame row) == xla_step.multi_step bit
    for bit (every leaf, outputs included), under the frame the tests give
    the JAX package (translation and rotation of the cell's transform), and
    == the JAX package's multi_step: integer and bool leaves exact, f32
    within the stated tolerance on live lanes."""
    tf = _case_transform(name)
    c, table, frame, s0, n = _port(name, dict(translation=tf[0], rotation=tf[1]))
    got_s, got_o = body_chain(c.static, c.params, table, s0, frame, n)
    ref_s, ref_o = xla_step.multi_step(c.static, c.params, table, s0, frame, n)
    for k in POOL_FIELDS:
        assert torch.equal(_bits(getattr(got_s, k)), _bits(getattr(ref_s, k))), k
    for f in dataclasses.fields(ref_o):
        assert torch.equal(_bits(getattr(got_o, f.name)), _bits(getattr(ref_o, f.name))), f.name
    spj, colj, ffj, cap, _n = _case(jx, name)
    cj = jx.compile_spawner(spj)
    fj = jx.make_frame_input(1 / 60, translation=tf[0], rotation=tf[1],
                             force_fields=jx.compile_force_fields(ffj) if ffj else None)
    sj, oj = jx.multi_step(cj.static, cj.params, jx.compile_colliders(colj) if colj else None,
                           jx.init_pool_for(cj, cap, 5), fj, n)
    for k in EXACT_STATE:
        a, b = np.asarray(getattr(sj, k)), getattr(got_s, k).numpy()
        np.testing.assert_array_equal(b.astype(a.dtype) if k == "rng_key" else b, a, err_msg=k)
    for k in ("alive_count", "alive_count_per_type", "finished_event", "aabb_valid", "nested_deferred",
              "nested_dropped", "destroyed_mask"):
        np.testing.assert_array_equal(getattr(got_o, k).numpy(), np.asarray(getattr(oj, k)), err_msg=k)
    live = np.asarray(sj.alive)
    for k in F32_FIELDS:
        a, b = np.asarray(getattr(sj, k))[live], getattr(got_s, k).numpy()[live]
        assert (np.abs(a - b) <= F32_ATOL + F32_RTOL * np.abs(a)).all(), k
    assert int(got_o.alive_count) > 0
    if name.startswith("fireworks"):
        assert int(got_o.alive_count_per_type[1]) > 0  # the bursts' children
    if name == "collision":  # the cuboid bounced some lanes within the chain
        free, _o = xla_step.multi_step(c.static, c.params, None, s0, frame, n)
        assert not torch.equal(free.vy, got_s.vy)
    if name == "fireworks_overflow":  # some frame's bursts asked for more lanes than were dead
        st, dropped = s0, 0
        for _ in range(n):
            st, o = xla_step.step(c.static, c.params, table, st, frame)
            dropped += int(o.nested_dropped)
        assert dropped > 0


def _case_transform(name):
    eff = _effects(pt)
    if name in ("fields",):
        return (0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0)
    if name == "collision":
        tf = eff.collision()[1]
    else:
        tf = getattr(eff, name.replace("_overflow", ""))()[1]
    return tuple(tf.translation), tuple(tf.rotation)


def test_body_reads_no_frame_or_key_from_the_host():
    """The same state and words under two frames: the body's result follows
    the frame row and the words it is given (another dt and transform,
    another key), each == xla_step.multi_step under that frame and key."""
    c, table, frame, s0, _n = _port("sparks")
    s0, _o = xla_step.multi_step(c.static, c.params, table, s0, frame, 6)
    frame2 = pt.make_frame_input(1 / 45, translation=(0.3, -0.2, 0.1), rotation=(0.0, 0.0998, 0.0, 0.995),
                                 parent_velocity=(0.5, 0.0, -0.25), modifier_scale=1.25, modifier_speed=0.8)
    s1 = dataclasses.replace(s0, rng_key=torch.tensor([0, 99], dtype=torch.int64))
    for st, fr in ((s0, frame), (s1, frame2)):
        got, _g = body_chain(c.static, c.params, table, st, fr, 3)
        ref, _r = xla_step.multi_step(c.static, c.params, table, st, fr, 3)
        for k in POOL_FIELDS:
            assert torch.equal(_bits(getattr(got, k)), _bits(getattr(ref, k))), k


# ---------------------------------------------------------------------------
# no host read in the body
# ---------------------------------------------------------------------------


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(str(func))  # e.g. "aten._local_scalar_dense.default"
        if func.overloadpacket in (torch.ops.aten.index, torch.ops.aten.index_put, torch.ops.aten.index_put_,
                                   torch.ops.aten._index_put_impl_):
            if any(t is not None and t.dtype == torch.bool for t in args[1]):  # a nonzero inside the op
                self.names.add(f"boolean index in {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["stress_test", "fireworks_overflow", "collision", "fields"])
def test_body_step_has_no_host_read(name):
    """Every op the body dispatches, stats on and off, on a populated pool
    (nested frames with children to write): none reads a value on the
    host (`aten._local_scalar_dense`: .item(), int(), bool() of a tensor)
    or has a shape that depends on the data (`nonzero`, `masked_select`,
    an index by a boolean mask, whose nonzero runs inside the op)."""
    c, table, frame, s0, n = _port(name)
    s0, _o = xla_step.multi_step(c.static, c.params, table, s0, frame, n - 2)
    words, _final = cg.chain_words("xla", c.static, table, s0, frame, 2)
    buf = torch.cat([torch.zeros(1, dtype=torch.int32), torch.from_numpy(words.view(np.int32).copy())])
    row = torch.from_numpy(fs._frame_row(frame).copy())
    mode = _Ops()
    with mode:
        st, _o = xla_step.chain_frame(c.static, c.params, table, s0, row, frame.force_fields, buf, stats=False)
        xla_step.chain_frame(c.static, c.params, table, st, row, frame.force_fields, buf, stats=True)
    assert len(mode.names) > 20
    found = [op for op in mode.names if any(op.startswith(h) for h in HOST_READS)]
    assert not found, found


# ---------------------------------------------------------------------------
# the graph key and the entry points' routes
# ---------------------------------------------------------------------------


def test_xla_graph_key_holds_no_frame_count_or_value():
    """One key for every n and every dt, transform, seed and collider
    position; another for another collider kind or field set (the composed
    torch specialises on them)."""
    c, table, frame, s0, _n = _port("collision")
    key = cg.graph_key("xla", c.static, c.params, table, s0, frame, 1)
    assert key == cg.graph_key("xla", c.static, c.params, table, dataclasses.replace(
        s0, rng_key=torch.tensor([0, 5], dtype=torch.int64)), pt.make_frame_input(1 / 30, translation=(1, 2, 3)), 140)
    moved = pt.compile_colliders([pt.Collider.cuboid((4.0, 0.5, 4.0), position=(0.0, -0.7, 0.0)),
                                  pt.Collider.cuboid((0.5, 0.5, 0.5), position=(0.3, 0.5, 0.0))], device="cpu")
    assert cg.graph_key("xla", c.static, c.params, moved, s0, frame, 3) != key  # an unrotated cube: identity_rot
    other = pt.compile_colliders([pt.Collider.sphere(0.5), pt.Collider.cuboid((0.5, 0.5, 0.5))], device="cpu")
    assert cg.graph_key("xla", c.static, c.params, other, s0, frame, 3) != key
    cf, _t, ff_frame, sf, _n = _port("fields")
    kf = cg.graph_key("xla", cf.static, cf.params, None, sf, ff_frame, 3)
    assert kf != cg.graph_key("xla", cf.static, cf.params, None, sf, pt.make_frame_input(1 / 60), 3)


def test_cpu_entry_points_step_uncaptured():
    """On the CPU `multi_step` and `step_jit` never reach chain_graph: the
    same bits as the frames one by one, with or without the seam."""
    c, table, frame, s0, _n = _port("fireworks")
    before = dict(cg.COUNTS)
    a = pt.multi_step(c.static, c.params, table, s0, frame, 4)
    b = pt.multi_step(c.static, c.params, table, s0, frame, 4, _captured=False)
    j = pt.step_jit(c.static, c.params, table, a[0], frame)
    s = xla_step.step(c.static, c.params, table, a[0], frame)
    for k in POOL_FIELDS:
        assert torch.equal(getattr(a[0], k), getattr(b[0], k)) and torch.equal(getattr(j[0], k), getattr(s[0], k)), k
    assert cg.COUNTS == before
    with pytest.raises(ValueError):
        pt.multi_step(c.static, c.params, table, s0, frame, 0)
