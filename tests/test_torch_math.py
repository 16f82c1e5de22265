"""Scalar math, curves and random bits of the port against the JAX package
and against pure-Python oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_firework_tpu.cadence import np_compute_emission_count
from bevy_firework_tpu.curve import FireworkCurve as JaxCurve
from bevy_firework_tpu.curve import compile_curve as jax_compile_curve
from bevy_firework_tpu.ops.fused_step import _eval_curve_static, _eval_gradient_static
from bevy_firework_tpu.utils.f32 import np_div_euclid, np_rem_euclid
from bevy_firework_tpu_torch import cadence, curve, prng
from bevy_firework_tpu_torch.utils import f32
from test_torch_common import _one_torch_thread  # noqa: F401


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def test_rem_div_euclid_match_numpy_oracle():
    rng = np.random.default_rng(0)
    a = rng.uniform(-50, 50, 4000).astype(np.float32)
    b = rng.choice([-3.0, -0.7, 0.25, 1.0, 2.5, 7.0], 4000).astype(np.float32)
    got_r = f32.rem_euclid(_t(a), _t(b)).numpy()
    got_d = f32.div_euclid(_t(a), _t(b)).numpy()
    want_r = np.array([np_rem_euclid(x, y) for x, y in zip(a, b)], np.float32)
    want_d = np.array([np_div_euclid(x, y) for x, y in zip(a, b)], np.float32)
    np.testing.assert_array_equal(got_r, want_r)
    np.testing.assert_array_equal(got_d, want_d)


def test_compute_emission_count_matches_numpy_oracle():
    """A carried stream at an awkward rate and dt: counts and carries exact."""
    dur, per, dt = np.float32(2.5), np.float32(37.0), np.float32(0.007)
    t_np = t_pt = np.float32(0.0)
    last_np = np.float32(np.finfo(np.float32).min)
    last_pt = _t(last_np)
    for _ in range(500):
        n_np, last_np = np_compute_emission_count(t_np, last_np, dur, 0.1, 0.9, per)
        n_pt, last_pt = cadence.compute_emission_count(_t(t_pt), last_pt, _t(dur), _t(0.1), _t(0.9), _t(per))
        assert int(n_pt) == n_np
        assert last_pt.item() == last_np
        t_np = np_rem_euclid(np.float32(t_np + dt), dur)
        t_pt = t_np


CURVES = {
    "constant": JaxCurve.constant(1.7),
    "even": JaxCurve.even_samples([1.0, 2.0, 0.5, 3.0]),
    "uneven": JaxCurve.uneven_samples([(0.0, 1.0), (0.3, 0.2), (0.8, 2.5), (1.0, 0.0)]),
    "uneven_short": JaxCurve.uneven_samples([(0.1, 1.0), (0.7, 2.0)]),
}
GRADIENTS = {
    "constant": JaxCurve.constant((1.0, 0.5, 0.25, 1.0)),
    "even": JaxCurve.even_samples([(1, 0, 0, 1), (0, 1, 0, 0.5), (0, 0, 1, 0)]),
    "uneven": JaxCurve.uneven_samples([(0.0, (150.0, 100.0, 15.0, 1.0)), (0.7, (3.0, 1.0, 1.0, 1.0)),
                                       (0.8, (1.0, 0.3, 0.3, 1.0)), (0.9, (0.3, 0.3, 0.3, 1.0)),
                                       (1.0, (0.1, 0.1, 0.1, 0.0))]),
}


def _query():
    rng = np.random.default_rng(1)
    return np.concatenate([rng.uniform(-0.2, 1.3, 2000), [0.0, 0.3, 0.7, 0.8, 1.0, 1.0 + 1e-7]]).astype(np.float32)


def _np_static(ts, vs, kind, n, t):
    """_eval_curve_static in numpy f32 with every op rounded on its own."""
    f = np.float32
    if kind == 0:
        return np.full(t.shape, vs[0], f)
    if kind == 1:
        x = np.clip(t, f(0), f(1)) * f(n - 1)
        i = np.clip(np.floor(x), f(0), f(n - 2))
        frac = (x - i).astype(f)
    else:
        tun = np.clip(t, ts[0], ts[n - 1])
        i = sum((tun >= ts[k]).astype(f) for k in range(1, n - 1)) if n > 2 else np.zeros_like(t)
    seg = np.where(i == i, i, 0).astype(np.int64)
    if kind != 1:
        t0, t1 = ts[seg], ts[seg + 1]
        frac = ((tun - t0) / (t1 - t0)).astype(f)
    v0, v1 = vs[seg], vs[seg + 1]
    return (v0 + ((v1 - v0) * frac).astype(f)).astype(f)


def _assert_fma_close(got, want, vs):
    atol = float(np.spacing(np.float32(np.abs(vs).max())))
    np.testing.assert_allclose(got, want, rtol=float(np.finfo(np.float32).eps), atol=atol)


@pytest.mark.parametrize("name", sorted(CURVES))
def test_curve_eval_matches_jax_static_eval(name):
    """Equal to a separately rounded numpy evaluation bit for bit. Against
    the JAX package's `_eval_curve_static`, which XLA on the CPU compiles
    with the lerp `v0 + (v1 - v0) * frac` contracted into an FMA, within one
    rounding of the product: 1 ulp relative, plus the spacing of the table's
    largest value where the lerp cancels towards 0."""
    c = CURVES[name]
    ts, vs, n, kind = jax_compile_curve(c, 0, 8)
    t = _query()
    want = np.asarray(jax.jit(lambda x: _eval_curve_static(jnp.asarray(ts), jnp.asarray(vs), int(kind), int(n), x))(t))
    got = curve.eval_curve_static(torch.from_numpy(ts), torch.from_numpy(vs), int(kind), int(n), torch.from_numpy(t))
    np.testing.assert_array_equal(got.numpy(), _np_static(ts, vs, int(kind), int(n), t))
    _assert_fma_close(got.numpy(), want, vs)


@pytest.mark.parametrize("name", sorted(GRADIENTS))
def test_gradient_eval_matches_jax_static_eval(name):
    """Per channel as the scalar curve (same FMA bound against JAX)."""
    c = GRADIENTS[name]
    ts, vs, n, kind = jax_compile_curve(c, 4, 8)
    t = _query()
    rows = [jnp.asarray(vs[:, ch]) for ch in range(4)]
    want = jax.jit(lambda x: _eval_gradient_static(jnp.asarray(ts), rows, int(kind), int(n), x))(t)
    got = curve.eval_gradient_static(torch.from_numpy(ts), torch.from_numpy(vs), int(kind), int(n),
                                     torch.from_numpy(t))
    for ch in range(4):
        np.testing.assert_array_equal(got[ch].numpy(), _np_static(ts, vs[:, ch], int(kind), int(n), t))
        _assert_fma_close(got[ch].numpy(), np.asarray(want[ch]), vs[:, ch])


def test_port_compile_curve_equals_jax():
    for c in list(CURVES.values()) + list(GRADIENTS.values()):
        pc = curve.FireworkCurve(c.kind, c.ts, c.vs)
        for a, b in zip(jax_compile_curve(c, c.channels, 12), curve.compile_curve(pc, pc.channels, 12)):
            np.testing.assert_array_equal(a, b)


def test_threefry_split_matches_jax_random_split():
    want0 = [[1797259609, 2579123966], [928981903, 3453687069]]
    new, frame = prng.threefry_split(np.array([0, 0], np.uint32))
    assert [new.tolist(), frame.tolist()] == want0
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 2**32, size=(64, 2), dtype=np.uint64).astype(np.uint32)
    split = jax.jit(jax.random.split)
    for k in keys:
        want = np.asarray(split(k))
        got = prng.threefry_split(k)
        np.testing.assert_array_equal(np.stack(got), want)
    # the key chain of 5 frames, as jax.random.split iterated
    key = np.array([0, 42], np.uint32)
    k_jax = jnp.asarray(key)
    seeds_jax = []
    for _ in range(5):
        k_jax, fk = jax.random.split(k_jax)
        seeds_jax.append(int(fk[0]))
    k_end, seeds = prng.frame_seeds(key, 5)
    assert seeds == seeds_jax
    np.testing.assert_array_equal(k_end, np.asarray(k_jax))


@pytest.mark.parametrize("seed", [3, 4])
def test_threefry_fold_in_matches_jax(seed):
    """fold_in bit for bit against jax.random.fold_in (threefry,
    partitionable), for random keys and data, the child stage's 1000 + e
    among them."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, size=(32, 2), dtype=np.uint64).astype(np.uint32)
    data = [0, 1, 1000, 1003, 2**31 + 5, 2**32 - 1] + rng.integers(0, 2**32, 26, dtype=np.uint64).tolist()
    fold = jax.jit(jax.random.fold_in)
    for k, d in zip(keys, data):
        np.testing.assert_array_equal(prng.threefry_fold_in(k, int(d)), np.asarray(fold(k, np.uint32(d))))


@pytest.mark.parametrize("shape", [(1,), (12, 1024), (9, 333), (3, 7, 5)])
def test_threefry_uniform_matches_jax(shape):
    """uniform(key, shape, float32) bit for bit against jax.random.uniform
    for several keys: the flat index's (hi, lo) counters, the xor of the
    output words, the top 23 bits as a float in [1, 2) minus 1."""
    rng = np.random.default_rng(len(shape))
    for k in rng.integers(0, 2**32, size=(4, 2), dtype=np.uint64).astype(np.uint32):
        want = np.asarray(jax.random.uniform(jnp.asarray(k), shape, jnp.float32))
        got = prng.threefry_uniform(k, shape).numpy()
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert 0.0 <= got.min() and got.max() < 1.0


def _philox_reference(ctr, key):
    """Philox-4x32-10 transliterated from the Random123 specification with
    Python integers."""
    m0, m1, w0, w1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
    c = list(ctr)
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + w0) & 0xFFFFFFFF, (k1 + w1) & 0xFFFFFFFF
        p0, p1 = m0 * c[0], m1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & 0xFFFFFFFF, (p0 >> 32) ^ c[3] ^ k1, p0 & 0xFFFFFFFF]
    return c


def test_torch_philox_matches_python_reference():
    rng = np.random.default_rng(3)
    ctr = rng.integers(0, 2**32, size=(300, 4), dtype=np.uint64)
    ctr[:4] = [[0, 0, 0, 0], [0xFFFFFFFF] * 4, [1, 2, 3, 4], [131071, 2, 0, 0]]
    for key in [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (1797259609, 0), (12345, 678)]:
        cols = [torch.from_numpy(ctr[:, i].astype(np.int64)) for i in range(4)]
        got = torch.stack(prng.philox4x32(*cols, *key), dim=1).numpy()
        want = np.array([_philox_reference([int(v) for v in row], key) for row in ctr])
        np.testing.assert_array_equal(got, want)


def test_lane_uniforms_layout():
    """Draw d of lane g is word d % 4 of Philox block d // 4 at counter
    (g, d // 4, 0, 0), mapped from its top 24 bits into [0, 1)."""
    lanes = torch.arange(0, 5000, 7, dtype=torch.int64)
    u = prng.lane_uniforms(987654321, lanes, 11)
    assert len(u) == 11
    for g in (0, 7, 4991):
        i = g // 7
        for d in range(11):
            word = _philox_reference([g, d // 4, 0, 0], (987654321, 0))[d % 4]
            assert u[d][i].item() == np.float32((word >> 8) / float(1 << 24))
    allu = torch.cat(u)
    assert float(allu.min()) >= 0.0 and float(allu.max()) < 1.0
    assert abs(float(allu.mean()) - 0.5) < 0.01
