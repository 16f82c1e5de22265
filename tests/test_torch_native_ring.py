"""The port's instance ring (bevy_firework_tpu_torch/native) against the JAX
package's ring and packs: build, interleave, compaction, the producer /
consumer hand-off and latest-wins, on planes from a numpy seed and on pool
states the JAX package stepped and carried over."""

from pathlib import Path

import numpy as np
import pytest

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from bevy_firework_tpu.native import InstanceRing as JaxRing
from bevy_firework_tpu.render import pack_instances_dense as jax_pack_dense
from bevy_firework_tpu.render import pack_instances_planar as jax_pack_planar
from bevy_firework_tpu.step import step_jit
from bevy_firework_tpu_torch import interop, native
from bevy_firework_tpu_torch.native import InstanceRing, get_lib, transpose_planes
from test_torch_common import _one_torch_thread, jax_pool_numpy  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
DEFAULTS = [0.0] * 7 + [1.0] + [0.0] * 8  # identity quaternion w


def test_native_lib_builds():
    """The library builds from the port's own source into a git-ignored
    directory; no library is committed."""
    lib = get_lib()
    assert lib is not None and native.library_path().exists()
    assert native.library_path().parent == native.BUILD_DIR
    assert native.SOURCE.parent == Path(pt.__file__).parent / "native"
    ignored = (REPO / ".gitignore").read_text().split()
    assert f"{native.BUILD_DIR.relative_to(REPO).as_posix()}/" in ignored
    assert not [p for p in native.SOURCE.parent.iterdir() if p.suffix == ".so"]


def test_transpose_matches_numpy():
    planes = np.random.RandomState(0).rand(16, 1000).astype(np.float32)
    np.testing.assert_array_equal(transpose_planes(planes), planes.T)


def test_ring_round_trip():
    ring = InstanceRing(capacity=4096, n_slots=3)
    planes = np.random.RandomState(1).rand(16, 500).astype(np.float32)
    ring.publish(planes, count=500, frame_id=7)
    got = ring.acquire()
    assert got is not None
    buf, fid = got
    assert fid == 7 and buf.shape == (500, 16)
    np.testing.assert_array_equal(buf, planes.T)
    ring.release()
    ring.close()


def test_ring_latest_frame_wins():
    ring = InstanceRing(capacity=64, n_slots=2)
    for fid in range(5):  # the consumer never drains: the producer takes the oldest ready slot
        ring.publish(np.full((16, 8), float(fid), np.float32), count=8, frame_id=fid)
    buf, fid = ring.acquire()
    assert fid == 4
    np.testing.assert_array_equal(buf, 4.0)
    ring.release()
    ring.close()


def test_ring_drops_a_frame_when_no_slot_is_free():
    """With every slot held by the consumer, a publish drops its frame
    (returns -1) instead of writing a held slot."""
    ring = InstanceRing(capacity=8, n_slots=1)
    ring.publish(np.ones((16, 4), np.float32), 4, frame_id=1)
    assert ring.acquire()[1] == 1
    assert ring.publish(np.zeros((16, 4), np.float32), 4, frame_id=2) == -1
    ring.release()
    assert ring.publish(np.zeros((16, 4), np.float32), 4, frame_id=3) == 0
    assert ring.acquire()[1] == 3
    ring.release()
    ring.close()


def test_ring_count_clamped_to_capacity():
    ring = InstanceRing(capacity=16, n_slots=2)
    ring.publish(np.ones((16, 100), np.float32), count=100, frame_id=0)
    buf, _ = ring.acquire()
    assert buf.shape[0] == 16
    ring.release()
    ring.close()


def _carried(spawner, n, frames, dt=1 / 60):
    """A JAX-stepped pool and its port copy (CPU)."""
    cj = jx.compile_spawner(spawner(jx))
    cp = pt.compile_spawner(spawner(pt), device="cpu")
    sj = jx.init_pool_for(cj, n, 0)
    for _ in range(frames):
        sj, _o = step_jit(cj.static, cj.params, None, sj, jx.make_frame_input(dt))
    return cj, cp, sj, interop.pool_from_numpy(jax_pool_numpy(sj), device="cpu")


def _one_shot(pkg):
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(lifetime=pkg.RandF32.constant(5.0))],
        emission_settings=[pkg.EmissionSettings(emission_pacing=pkg.EmissionPacing.one_shot(37))])


def _short_lived(pkg):
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(lifetime=pkg.RandF32(0.05, 0.4))],
        emission_settings=[pkg.EmissionSettings(emission_pacing=pkg.EmissionPacing.rate(300.0))])


def test_end_to_end_with_engine_planes():
    """Port pack (planar) -> ring interleave == the port's and the JAX
    package's pack_instances rows."""
    cj, cp, sj, sp = _carried(_one_shot, 256, 1)
    planes, count = pt.pack_instances_planar(cp.params, sp, 0)
    rows, count_rows = pt.pack_instances(cp.params, sp, 0)
    rows_j, count_j = jx.pack_instances(cj.params, sj, 0)
    assert int(count) == int(count_rows) == int(count_j) == 37
    ring = InstanceRing(capacity=256)
    ring.publish(planes.numpy(), int(count), frame_id=1)
    buf, _ = ring.acquire()
    np.testing.assert_array_equal(buf, rows.numpy()[:37])
    np.testing.assert_array_equal(buf, np.asarray(rows_j)[:37])
    ring.release()
    ring.close()


def test_dense_and_f16_paths_match_compacted():
    """Dense f32 and f16 publishes of the port's packs equal the compacted
    rows (f16: the rows rounded, exactly)."""
    cj, cp, sj, sp = _carried(_short_lived, 512, 25)  # a mix of live and dead lanes
    rows, cnt = pt.pack_instances(cp.params, sp, 0)
    rows = rows.numpy()[: int(cnt)]
    assert len(rows) > 5 and not bool(sp.alive.all())
    ring = InstanceRing(512)
    planes, _ = pt.pack_instances_dense(cp.params, sp, 0)
    ring.publish_dense(planes.numpy(), 1)
    buf, _ = ring.acquire()
    np.testing.assert_array_equal(buf, rows)
    ring.release()
    planes16, _ = pt.pack_instances_dense_f16(cp.params, sp, 0)
    ring.publish_dense_f16(planes16.numpy(), 2)
    buf16, fid = ring.acquire_f16()
    assert fid == 2 and buf16.dtype == np.float16 and buf16.shape == rows.shape
    np.testing.assert_array_equal(buf16, rows.astype(np.float16))
    ring.release()
    ring.close()


def _random_planes(seed=3, n=500):
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(16, n)).astype(np.float32)
    planes[3, rng.random(n) < 0.4] = 0.0
    return planes


def test_publish_dense_planes_and_f16():
    """Separate-plane publishes (f32 and f16, None planes -> defaults) equal
    the compacted planes."""
    planes = _random_planes()
    n = planes.shape[1]
    expect = planes[:, planes[3] != 0.0].T
    ring = InstanceRing(n, 2)
    try:
        plist = [planes[p].copy() for p in range(16)]
        ring.publish_dense_planes(plist, DEFAULTS, frame_id=5)
        rows, fid = ring.acquire()
        assert fid == 5
        np.testing.assert_array_equal(rows, expect)
        ring.release()
        ring.publish_dense_planes(plist[:4] + [None] * 4 + plist[8:], DEFAULTS, frame_id=6)
        rows2, _ = ring.acquire()
        np.testing.assert_array_equal(rows2[:, 4:8], np.tile(np.float32([0, 0, 0, 1]), (len(expect), 1)))
        np.testing.assert_array_equal(rows2[:, 8:], expect[:, 8:])
        ring.release()
    finally:
        ring.close()
    ring16 = InstanceRing(n, 2)
    try:
        p16 = [planes[p].astype(np.float16) for p in range(4)] + [None] * 4 + \
              [planes[p].astype(np.float16) for p in range(8, 16)]
        ring16.publish_dense_planes_f16(p16, DEFAULTS, frame_id=9)
        rows16, fid = ring16.acquire_f16()
        assert fid == 9
        live16 = (planes[3].astype(np.float16).view(np.uint16) & 0x7FFF) != 0
        expect16 = planes[:, live16].T.astype(np.float16)
        np.testing.assert_array_equal(rows16[:, 0:4], expect16[:, 0:4])
        np.testing.assert_array_equal(rows16[:, 8:], expect16[:, 8:])
        np.testing.assert_array_equal(rows16[:, 4:8], np.tile(np.float16([0, 0, 0, 1]), (len(expect16), 1)))
        ring16.release()
    finally:
        ring16.close()


def _publish_all(ring_cls, planes):
    """Every publish kind of one ring class on the same planes: the rows'
    bytes of each."""
    n = planes.shape[1]
    out = []
    ring = ring_cls(n, 2)
    try:
        cases = (
            lambda: ring.publish(planes, n // 2, 1),
            lambda: ring.publish_dense(planes, 2),
            lambda: ring.publish_dense_planes([planes[p] for p in range(16)], DEFAULTS, 3),
            lambda: ring.publish_dense_planes([planes[p] if not 4 <= p < 8 else None for p in range(16)],
                                              DEFAULTS, 4),
            lambda: ring.publish_rows(np.ascontiguousarray(planes.T[: n // 3]), 5),
        )
        for publish in cases:
            publish()
            rows, fid = ring.acquire()
            out.append((fid, rows.tobytes()))
            ring.release()
        p16 = planes.astype(np.float16)
        for fid, publish in ((6, lambda: ring.publish_dense_f16(p16, 6)),
                             (7, lambda: ring.publish_dense_planes_f16(
                                 [p16[p] if not 4 <= p < 8 else None for p in range(16)], DEFAULTS, 7))):
            publish()
            rows, got = ring.acquire_f16()
            out.append((got, rows.tobytes()))
            ring.release()
    finally:
        ring.close()
    return out


@pytest.mark.parametrize("seed", [3, 11])
def test_port_ring_rows_are_byte_equal_to_jax_ring(seed):
    """The port's ring and the JAX package's ring give byte-equal rows from
    the same planes, for every publish kind."""
    planes = _random_planes(seed, 777)
    planes[5, ::7] = -0.0
    planes[3, ::13] = -0.0  # a negative-zero scale is dead too
    got, want = _publish_all(InstanceRing, planes), _publish_all(JaxRing, planes)
    assert [f for f, _b in got] == [f for f, _b in want] == [1, 2, 3, 4, 5, 6, 7]
    for (fid, a), (_f, b) in zip(got, want):
        assert a == b, fid


def test_ring_rows_from_jax_dense_pack_of_carried_state():
    """A JAX-stepped state carried over: the port's dense and planar packs
    through the port's ring == the JAX packs through the JAX ring, row for
    row (positions and rotation bytes equal, curve columns within the 1-ulp
    FMA seam)."""
    cj, cp, sj, sp = _carried(_short_lived, 512, 25)
    pd, _n = pt.pack_instances_dense(cp.params, sp, 0)
    jd, _nj = jax_pack_dense(cj.params, sj, 0)
    pp, pc = pt.pack_instances_planar(cp.params, sp, 0)
    jp, jc = jax_pack_planar(cj.params, sj, 0)
    assert int(pc) == int(jc) > 0
    rows = []
    for ring_cls, dense, planar, count in ((InstanceRing, pd.numpy(), pp.numpy(), int(pc)),
                                          (JaxRing, np.asarray(jd), np.asarray(jp), int(jc))):
        ring = ring_cls(512, 2)
        ring.publish_dense(dense, 1)
        a = ring.acquire()[0].copy()
        ring.release()
        ring.publish(planar, count, 2)
        b = ring.acquire()[0].copy()
        ring.release()
        ring.close()
        rows.append((a, b))
    (pa, pb), (ja, jb) = rows
    np.testing.assert_array_equal(pa, pb)
    assert pa.shape == ja.shape == jb.shape
    exact = [0, 1, 2, 4, 5, 6, 7]
    assert pa[:, exact].tobytes() == ja[:, exact].tobytes() == jb[:, exact].tobytes()
    np.testing.assert_allclose(pa, ja, rtol=float(np.finfo(np.float32).eps), atol=1e-7)
