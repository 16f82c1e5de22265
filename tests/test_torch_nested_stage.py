"""The nested stage's plain version (`step.nested_stage`: kernel rows 8 and
9b, one launch per nested emitter of a hybrid frame on the card) against
the JAX package on the CPU: its `nested_cadence_pass` (Pallas, interpret
mode) and its child stage `step._nested_spawn` under the same
fold_in(frame_key, 1000 + e) key, composed per emitter as the JAX hybrid's
`_spawn_phase` composes them (fetch mode and the in-kernel merge payload on
ring archetypes, cum mode and the in-place write-back on dead-rank ones).

Tolerances: the record's integer words (total, children, window, next
start, drops) are exact. The anchors equal the numpy f32 cadence bit for
bit; the JAX kernel's equal it or, where XLA on the CPU contracts the
anchor sum `clamped + x * between` into an FMA, that contraction (as
`test_nested_cadence_matches_jax_kernel` holds them). The child rows are
exact where no multiply-add that XLA contracts and no libm call is
involved (age, initial scale, lifetime, the rotation rows, the box
emitter's positions); the velocities (`spd * (w + off * inv * radial) +
inh * v`, contracted by XLA) and the sphere emitter's positions (sinf/cosf,
XLA's and PyTorch's libm) are held within 1e-6 absolute and relative: an
ulp or two of their operands, which the velocity sum's cancellation can
make ~15 ulp of a small result."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import bevy_firework_tpu as jx
import bevy_firework_tpu.ops.fused_step as jfs
import bevy_firework_tpu_torch as pt
from bevy_firework_tpu_torch.ops import table_layout as L
from bevy_firework_tpu_torch.step import nested_child_field_rows, nested_emitters, nested_parent_fields, nested_stage
from test_torch_common import _one_torch_thread  # noqa: F401
from test_torch_nested import _np_cadence

jstep = importlib.import_module("bevy_firework_tpu.step")  # the package exports a `step` function
F32_MIN = np.finfo(np.float32).min
M = 1024
# child rows no multiply-add of XLA's and no libm call reaches
EXACT_ROWS = ("qx", "qy", "qz", "qw", "initial_scale", "age", "lifetime")


def _ulps(a, b) -> np.ndarray:
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


def _spawner(pkg, dead_rank: bool, two: bool, burst: bool):
    """A rocket type and nested children of type 1 from one or two nested
    emitters on the rockets: the first draws box offsets with no spread (no
    sinf/cosf), the second a sphere with spread; with `burst` the first asks
    for a parent's 10 children at once (a window of 0.001 of its life), so
    the total exceeds M. dead_rank: the rockets are destroyed on collision
    (dead-rank claim, cum mode)."""
    col = pkg.ParticleCollisionSettings(restitution=0.5, destroy_on_collision=True) if dead_rank else None
    types = [pkg.ParticleSettings(lifetime=pkg.RandF32.constant(1.5), collision_settings=col),
             pkg.ParticleSettings(lifetime=pkg.RandF32(0.3, 0.5))]
    window = (0.0, 0.001) if burst else (0.1, 1.0)
    ems = [pkg.EmissionSettings(particle_index=0),
           pkg.EmissionSettings(particle_index=1, emission_mode=pkg.EmissionMode.nested(0),
                                emission_pacing=pkg.EmissionPacing.count_over_duration(10.0, 1.0, *window),
                                emission_shape=pkg.EmissionShape.box((0.1, 0.2, 0.1)),
                                initial_velocity=pkg.RandVec3(pkg.RandF32(0.1, 0.9), (0.0, 1.0, 0.0), 0.0),
                                initial_velocity_radial=pkg.RandF32(0.2, 1.0), inherit_parent_velocity=True)]
    if two:
        ems.append(pkg.EmissionSettings(particle_index=1, emission_mode=pkg.EmissionMode.nested(0),
                                        emission_pacing=pkg.EmissionPacing.count_over_duration(3.0, 1.0, 0.2, 0.9),
                                        emission_shape=pkg.EmissionShape.sphere(0.2),
                                        initial_velocity=pkg.RandVec3(pkg.RandF32(0.2, 0.6), (0.0, 1.0, 0.0), 0.7)))
    return pkg.ParticleSpawner(particle_settings=types, emission_settings=ems)


def _pool(n: int, seed: int, n_emitters: int, unset: float) -> dict:
    """Random pre-spawn pool planes: 60% of the lanes alive, two types, ages
    inside the lifetime, a share `unset` of the anchors unset (f32::MIN: the
    parent asks for every child its window has passed), the others just
    below the age (a child now and then), random parents."""
    rng = np.random.default_rng(seed)
    life = np.full(n, 1.5, np.float32)
    age = (rng.uniform(0.0, 1.0, n) * life).astype(np.float32)
    le = np.where(rng.uniform(size=(n_emitters, n)) < unset, F32_MIN,
                  age * rng.uniform(0.95, 1.0, (n_emitters, n))).astype(np.float32)
    p = {k: rng.normal(size=n).astype(np.float32) for k in ("px", "py", "pz", "vx", "vy", "vz")}
    p.update(alive=rng.uniform(size=n) < 0.6, ptype=rng.integers(0, 2, n).astype(np.int32), age=age, lifetime=life,
             last_emitted=le, initial_scale=np.full(n, 0.1, np.float32), ring_cursor=np.int32(n // 3))
    return p


def _jax_stage(cj, e, fields, frame, frame_key, alive0):
    """The JAX hybrid's nested work for emitter e (its `_spawn_phase`
    :628-648 on the merge path): (new_le, total, dropped, child rows by
    rank for the ranks it produces, the parent lane of each such rank)."""
    static, params = cj.static, cj.params
    ring = static.ring_claim
    fetch = {k: fields[k] for k in jstep.nested_parent_fields(static)} if ring else None
    with pltpu.force_tpu_interpret_mode():
        new_le, cum, total, pv = jfs.nested_cadence_pass(
            static, params, e, jnp.asarray(alive0), fields["ptype"], fields["age"], fields["lifetime"],
            fields["last_emitted"][e], jnp.asarray(True), True, M, parent_fields=fetch)
    payload = []
    dead_before = np.flatnonzero(~np.asarray(fields["alive"]))
    dropped = jstep._nested_spawn(static, params, frame, fields, e, None, cum, total, frame_key,
                                  merge_out=payload if ring else None, parent_vals=pv)
    names = nested_child_field_rows(static)  # the port's and the JAX rows' common order
    if ring:
        rows = dict(payload[0]["rows"])
        return np.asarray(new_le), int(total), int(dropped), np.stack([np.asarray(rows[k]) for k in names]), M
    # write-back: rank r's child landed in the r-th dead slot
    n_w = min(int(total), M, dead_before.size)
    rows = np.stack([np.asarray(fields[k])[dead_before[:n_w]] for k in names])
    return np.asarray(new_le), int(total), int(dropped), rows, n_w


@pytest.mark.parametrize("n", [8192, 16384])
@pytest.mark.parametrize("burst", [False, True])
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("mode", ["fetch", "cum"])
def test_nested_stage_matches_jax(mode, two, burst, n):
    """Per nested emitter in order, on one random pre-spawn pool: the record
    (NS_TOTAL, NS_N, NS_START, NS_NEXT, NS_DROPPED, NS_EMITTER) against the
    JAX totals, its ring cursor or dead-slot claims and its drop count; the
    anchors against the numpy cadence (and the JAX kernel's up to its FMA
    contraction); the child rows against the JAX child stage's rows by rank
    (the merge payload's M rows on the ring; the ranks the write-back
    placed on dead-rank archetypes), within the tolerances above."""
    dead_rank = mode == "cum"
    cj = jx.compile_spawner(_spawner(jx, dead_rank, two, burst), nested_buffer=M)
    cp = pt.compile_spawner(_spawner(pt, dead_rank, two, burst), nested_buffer=M, device="cpu")
    assert cp.static.ring_claim == (not dead_rank) == cj.static.ring_claim
    es = nested_emitters(cp.static)
    assert len(es) == 1 + two
    pool = _pool(n, 7 + 2 * two + burst, cp.static.num_emitters, 0.5 if burst else 0.03)
    names = nested_parent_fields(cp.static)
    fields = {k: jnp.asarray(v) for k, v in pool.items()}
    for k in ("qx", "qy", "qz", "wx", "wy", "wz"):
        fields[k] = jnp.zeros(n, jnp.float32)
    fields["qw"] = jnp.ones(n, jnp.float32)
    frame_j = jx.make_frame_input(1 / 60, modifier_scale=1.2, modifier_speed=0.9)
    frame_p = pt.make_frame_input(1 / 60, modifier_scale=1.2, modifier_speed=0.9)
    key = np.array([11, 20260 + n], np.uint32)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in pool.items()}
    alive = t["alive"]
    parents = {k: t[k] for k in names}
    gate = torch.ones((), dtype=torch.bool)
    start = torch.tensor(pool["ring_cursor"] if not dead_rank else 0, dtype=torch.int32)
    totals = []
    for e in es:
        new_le, rec, rows = nested_stage(cp.static, cp.params, frame_p, e, alive, t["ptype"], t["age"],
                                         t["lifetime"], t["last_emitted"][e], gate, M, parents, key, start)
        j_le, j_total, j_dropped, j_rows, n_rows = _jax_stage(cj, e, fields, frame_j, jnp.asarray(key), pool["alive"])
        n_sp = min(j_total, M)
        want_next = (int(start) + n_sp) % n if not dead_rank else int(start) + n_sp
        assert rec.tolist()[:6] == [j_total, n_sp, int(start), want_next, j_dropped, e], (e, rec.tolist())
        if not dead_rank:
            assert int(fields["ring_cursor"]) == want_next
        # anchors: the numpy f32 cadence's op order, the JAX kernel's up to
        # its contracted anchor sums
        cad = (pool["alive"], pool["ptype"], pool["age"], pool["lifetime"], pool["last_emitted"][e], True, 0,
               float(cp.params.off_start[e]), float(cp.params.off_end[e]), float(cp.params.count[e]), M)
        want_le, _cum, want_total = _np_cadence(*cad)
        fma_le = _np_cadence(*cad, fma=True)[0]
        np.testing.assert_array_equal(new_le.numpy(), want_le)
        parted = j_le != want_le
        assert want_total == j_total and (j_le[parted] == fma_le[parted]).all()
        # child rows by rank: exact but for XLA's contractions and libm
        k_rows = rows.numpy()[:, :n_rows]
        assert k_rows.shape == j_rows.shape
        row_names = nested_child_field_rows(cp.static)
        for i, k in enumerate(row_names):
            if k in EXACT_ROWS or (e == es[0] and k in ("px", "py", "pz")):
                np.testing.assert_array_equal(k_rows[i], j_rows[i], err_msg=f"emitter {e} row {k}")
            else:
                np.testing.assert_allclose(k_rows[i], j_rows[i], rtol=1e-6, atol=1e-6, err_msg=f"emitter {e} row {k}")
        totals.append(j_total)
        start = rec[L.NS_NEXT]
    assert (totals[0] > M) == burst and 0 < min(totals) and (burst or max(totals) < M)


def test_nested_stage_wrapper_runs_the_plain_version_on_the_cpu():
    """`ops.fused_step.nested_stage` on CPU tensors is `step.nested_stage`
    (the kernel's tile counts and output buffers are the card's: it raises
    on them), and a hybrid frame's records on the CPU are its records."""
    from bevy_firework_tpu_torch.ops import fused_step as fs

    cp = pt.compile_spawner(_spawner(pt, False, True, False), nested_buffer=M, device="cpu")
    pool = _pool(8192, 3, cp.static.num_emitters, 0.03)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in pool.items()}
    args = (cp.static, cp.params, pt.make_frame_input(1 / 60), 1, t["alive"], t["ptype"], t["age"], t["lifetime"],
            t["last_emitted"][1], torch.ones((), dtype=torch.bool), M,
            {k: t[k] for k in nested_parent_fields(cp.static)}, np.array([1, 2], np.uint32),
            torch.tensor(5, dtype=torch.int32))
    got, want = fs.nested_stage(*args), nested_stage(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert 0 < int(got[1][L.NS_TOTAL]) < M and int(got[1][L.NS_START]) == 5
    with pytest.raises(ValueError, match="card"):
        fs.nested_stage(*args, counts=torch.zeros(32, dtype=torch.int32))
    with pytest.raises(ValueError, match="card"):
        fs.nested_stage(*args, out={"child": got[2]})


def _rotating_spawner(pkg):
    """Rockets and a nested burst emitter on them whose children spin (an
    angular velocity): rotation is live, so the stage reads ten parent
    fields (position, rotation, velocity), and the total exceeds M."""
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(lifetime=pkg.RandF32.constant(1.5)),
                           pkg.ParticleSettings(lifetime=pkg.RandF32(0.3, 0.5))],
        emission_settings=[pkg.EmissionSettings(particle_index=0), pkg.EmissionSettings(
            particle_index=1, emission_mode=pkg.EmissionMode.nested(0),
            emission_pacing=pkg.EmissionPacing.count_over_duration(10.0, 1.0, 0.0, 0.001),
            initial_angular_velocity=pkg.RandVec3(pkg.RandF32(1.0, 2.0), (1.0, 0.0, 0.0), 0.3))])


@pytest.mark.parametrize("subset", ["position_velocity", "one", "all"])
def test_nested_cadence_pass_fetches_any_parent_fields_as_jax(subset):
    """The pass alone in fetch mode (`nested_cadence_pass`) copies by rank
    whichever parent planes it is given, as the JAX package's does: on an
    archetype with live rotation (ten parent fields), the six position and
    velocity planes, one plane and all ten; the fetched values and the
    total exact, the anchors equal to the numpy f32 cadence."""
    cj = jx.compile_spawner(_rotating_spawner(jx), nested_buffer=M)
    cp = pt.compile_spawner(_rotating_spawner(pt), nested_buffer=M, device="cpu")
    names = nested_parent_fields(cp.static)
    assert len(names) == 10 and tuple(jstep.nested_parent_fields(cj.static)) == tuple(names)
    n = 8192
    pool = _pool(n, 29, cp.static.num_emitters, 0.5)
    rng = np.random.default_rng(31)
    for k in ("qx", "qy", "qz", "qw"):
        pool[k] = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    pick = {"position_velocity": ("px", "py", "pz", "vx", "vy", "vz"), "one": ("qw",), "all": names}[subset]
    with pltpu.force_tpu_interpret_mode():
        j_le, _j_cum, j_total, j_pv = jfs.nested_cadence_pass(
            cj.static, cj.params, 1, jnp.asarray(pool["alive"]), jnp.asarray(pool["ptype"]), jnp.asarray(pool["age"]),
            jnp.asarray(pool["lifetime"]), jnp.asarray(pool["last_emitted"][1]), jnp.asarray(True), True, M,
            parent_fields={k: jnp.asarray(pool[k]) for k in pick})
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in pool.items()}
    p_le, p_cum, p_total, p_pv = pt.nested_cadence_pass(
        cp.static, cp.params, 1, t["alive"], t["ptype"], t["age"], t["lifetime"], t["last_emitted"][1],
        torch.ones((), dtype=torch.bool), M, parent_fields={k: t[k] for k in pick})
    assert p_cum is None and sorted(p_pv) == sorted(pick)
    assert int(p_total) == int(j_total) > M
    want_le = _np_cadence(pool["alive"], pool["ptype"], pool["age"], pool["lifetime"], pool["last_emitted"][1], True,
                          0, float(cp.params.off_start[1]), float(cp.params.off_end[1]), float(cp.params.count[1]),
                          M)[0]
    np.testing.assert_array_equal(p_le.numpy(), want_le)
    for k in pick:
        np.testing.assert_array_equal(p_pv[k].numpy(), np.asarray(j_pv[k]), err_msg=k)


def test_child_rows_refuse_another_parent_count():
    """The nested-stage launcher builds child rows only from the
    archetype's own parent fields (ten with live rotation), and a fetch
    from at most `MAX_FETCH` planes: it refuses other counts before
    anything reaches the card."""
    from bevy_firework_tpu_torch.ops import fused_step as fs

    cp = pt.compile_spawner(_rotating_spawner(pt), nested_buffer=M, device="cpu")
    planes = tuple(torch.zeros(8192) for _ in range(6))
    child = torch.empty((len(nested_child_field_rows(cp.static)), M))
    with pytest.raises(ValueError, match="parent fields"):
        fs._stage_launch(None, cp.static, cp.params, 1, M, 8192, planes=planes, child=child,
                         cum_in=torch.zeros(8192, dtype=torch.int32))
    with pytest.raises(ValueError, match="parent fields"):
        fs._stage_launch(None, cp.static, cp.params, 1, M, M, child=child, parent_vals=torch.zeros((6, M)))
    with pytest.raises(ValueError, match="at most"):
        fs._stage_launch(None, cp.static, cp.params, 1, M, 8192, planes=planes * 2, fetch_out=torch.empty((12, M)))
