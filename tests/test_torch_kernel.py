"""The CUDA step kernel against its plain PyTorch version, on a card.

Imports torch and the port only, so on a machine without JAX it runs as
    python -m pytest --noconftest -q tests/test_torch_kernel.py
Every test that launches the kernel carries the `cuda` marker and skips
without a CUDA device; the table test runs anywhere."""

import numpy as np
import pytest
import torch

import bevy_firework_tpu_torch as pt
from bevy_firework_tpu_torch.ops import fused_step as fs
from bevy_firework_tpu_torch.ops import table_layout as L
from bevy_firework_tpu_torch.render import pack_render_planes
from bevy_firework_tpu_torch.step import active_f32_fields

SCALARS = ("ring_cursor", "time_in_cycle", "last_emission", "enabled", "manual_queued", "alive", "ptype")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _ulps(a, b) -> int:
    def key(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((key(a) - key(b)).abs().max())


def _plain(c, s, f, n):
    for _ in range(n):
        s, _o = pt.step(c.static, c.params, None, s, f)
    return s


def _det_spawner():
    return pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(
            lifetime=pt.RandF32.constant(0.3), initial_scale=pt.RandF32.constant(0.1),
            scale_curve=pt.FireworkCurve.uneven_samples([(0.0, 1.0), (1.0, 2.0)]),
            base_color=pt.gradient_uneven_samples([(0.0, (1, 0.5, 0.2, 1)), (1.0, (0, 0, 0, 0))]))],
        emission_settings=[pt.EmissionSettings(
            emission_pacing=pt.EmissionPacing.rate(2000.0),
            initial_velocity=pt.RandVec3.constant((1.0, 3.0, 0.2)),
            initial_angular_velocity=pt.RandVec3.constant((0.0, 2.0, 0.0)))],
    )


def test_pack_tables_puts_each_parameter_at_its_named_slot():
    """Live-rotation and curve slots of the kernel's table (the stress_test
    ones are in test_torch_slice.py)."""
    c = pt.compile_spawner(_det_spawner())
    p = c.params.to_numpy()
    fl = fs.pack_tables(c.static, c.params).view(np.float32)
    em, ty, cv = L.EM_AT, L.TY_AT, L.CV_AT
    assert fl[em + L.EM_DURATION] == p["duration"][0] and fl[em + L.EM_COUNT] == p["count"][0]
    np.testing.assert_array_equal(fl[em + L.EM_IANG:em + L.EM_IANG + 7], p["iangvel_params"][0])
    np.testing.assert_array_equal(fl[em + L.EM_INIT_ROT:em + L.EM_INIT_ROT + 4], p["init_rot"][0])
    np.testing.assert_array_equal(fl[ty + L.TY_ACCEL:ty + L.TY_ACCEL + 3], p["acceleration"][0])
    assert fl[ty + L.TY_ANG_DRAG] == p["angular_drag"][0]
    K = p["scale_ts"].shape[1]
    np.testing.assert_array_equal(fl[cv + L.CV_SCALE_VS * L.MAX_K:][:K], p["scale_vs"][0])
    np.testing.assert_array_equal(fl[cv + (L.CV_EMIS_TS + 4) * L.MAX_K:][:K], p["emis_vs"][0][:, 3])


@pytest.mark.cuda
@pytest.mark.parametrize("unroll", [1, 8])
def test_kernel_matches_plain_on_deterministic_config(cuda, unroll):
    """One launch equals `unroll` plain frames bit for bit, render planes
    included."""
    c = pt.compile_spawner(_det_spawner(), device=cuda)
    s = pt.init_pool_for(c, 131072)
    f = pt.make_frame_input(1 / 50)
    for _ in range(3):
        sk, _ok, planes = fs.fused_step(c.static, c.params, None, s, f, unroll=unroll, pack_render=True)
        sp = _plain(c, s, f, unroll)
        for k in active_f32_fields(c.static) + SCALARS:
            assert torch.equal(getattr(sk, k), getattr(sp, k)), k
        for a, b in zip(planes, pack_render_planes(c.static, c.params, sp)):
            assert torch.equal(a, b)
        s = sk


@pytest.mark.cuda
def test_kernel_scope_beyond_main_path(cuda):
    """Random lifetime, live rotation, two types, three emitters (rate,
    one-shot, on-demand) of three shapes, and a ragged capacity: counts,
    cursor, cadence, types exact; f32 fields within 4 ulp (libm sinf/cosf
    in the kernel vs PyTorch's CUDA ops)."""
    sp = pt.ParticleSpawner(
        particle_settings=[
            pt.ParticleSettings(lifetime=pt.RandF32(0.2, 0.6), initial_scale=pt.RandF32(0.1, 0.2),
                                scale_curve=pt.FireworkCurve.even_samples([1.0, 0.5, 2.0])),
            pt.ParticleSettings(lifetime=pt.RandF32(0.3, 0.4), angular_acceleration=(0.0, 1.0, 0.0),
                                base_color=pt.gradient_even_samples([(1, 0, 0, 1), (0, 0, 1, 0)])),
        ],
        emission_settings=[
            pt.EmissionSettings(particle_index=0, emission_pacing=pt.EmissionPacing.rate(90000.0),
                                emission_shape=pt.EmissionShape.sphere(0.5),
                                initial_velocity=pt.RandVec3(pt.RandF32(1.0, 2.0), (0, 1, 0), 0.4)),
            pt.EmissionSettings(particle_index=1, emission_pacing=pt.EmissionPacing.one_shot(5000),
                                emission_shape=pt.EmissionShape.box((0.2, 0.3, 0.4)),
                                initial_angular_velocity=pt.RandVec3(pt.RandF32(1.0, 3.0), (1, 0, 0), 0.3)),
            pt.EmissionSettings(particle_index=0, emission_pacing=pt.EmissionPacing.on_demand(),
                                emission_shape=pt.EmissionShape.ring((0, 0, 1), 0.7)),
        ],
    )
    c = pt.compile_spawner(sp, device=cuda)
    f = pt.make_frame_input(1 / 60, translation=(0.5, 1.0, -2.0), rotation=(0.0, 0.3826834, 0.0, 0.9238795),
                            parent_velocity=(0.1, 0.0, 0.2), modifier_scale=1.5, modifier_speed=0.8)
    s = pt.init_pool_for(c, 100003, seed=11)
    s = pt.PoolState(**{**{k: getattr(s, k) for k in pt.pool.POOL_FIELDS},
                        "manual_queued": torch.tensor(777, dtype=torch.int32, device=cuda)})
    worst = 0
    for u in (1, 8, 1, 4):  # 14 frames: no burst particle reaches 0.3 s
        sk, ok = fs.fused_step(c.static, c.params, None, s, f, unroll=u)
        sp_ = _plain(c, s, f, u)
        for k in SCALARS:
            assert torch.equal(getattr(sk, k), getattr(sp_, k)), k
        for k in active_f32_fields(c.static):
            worst = max(worst, _ulps(getattr(sk, k), getattr(sp_, k)))
        s = sk
    assert worst <= 4, worst
    assert int(s.manual_queued) == 0 and not bool(s.enabled[1])
    assert int(ok.alive_count_per_type[1]) == 5000
