"""The CUDA step kernel (with its narrow phase and dead-rank claim) against
its plain PyTorch version, on a card.

Imports torch and the port only, so on a machine without JAX it runs as
    python -m pytest --noconftest -q tests/test_torch_kernel.py
Every test that launches the kernel carries the `cuda` marker and skips
without a CUDA device; the table test runs anywhere."""

import math

import numpy as np
import pytest
import torch

import bevy_firework_tpu_torch as pt
from bevy_firework_tpu_torch.ops import fused_step as fs
from bevy_firework_tpu_torch.ops import table_layout as L
from bevy_firework_tpu_torch.render import pack_render_planes
from bevy_firework_tpu_torch.settings import ParticleCollisionSettings
from bevy_firework_tpu_torch.step import active_f32_fields, plain_frames

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


def _box_spawner(destroy=False, rate=3e5):
    """Box emission, radial speed, no spread, gravity: every draw reaches the
    state through +, -, *, / and sqrt only (sinf/cosf see 0), so the kernel
    and the plain version agree bit for bit on every lane."""
    return pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(
            lifetime=pt.RandF32.constant(2.0), initial_scale=pt.RandF32(0.02, 0.08),
            acceleration=(0.0, -9.81, 0.0), linear_drag=0.1,
            collision_settings=ParticleCollisionSettings(restitution=0.7, friction=0.3,
                                                         destroy_on_collision=destroy))],
        emission_settings=[pt.EmissionSettings(
            emission_pacing=pt.EmissionPacing.rate(rate), emission_shape=pt.EmissionShape.box((1.5, 0.5, 1.5)),
            initial_velocity=pt.RandVec3(pt.RandF32(0.5, 3.0), (0.0, 1.0, 0.0), 0.0),
            initial_velocity_radial=pt.RandF32(1.0, 4.0))],
    )


S8, C8 = math.sin(math.pi / 8), math.cos(math.pi / 8)
SCENES = {
    # one collider of every kind around the emitter box, three of them rotated
    "c7": lambda: [
        pt.Collider.halfspace(position=(0.0, -0.8, 0.0)),
        pt.Collider.cuboid((0.4, 0.3, 0.4), position=(1.6, 0.2, 0.0), rotation=(0.0, 0.0, S8, C8)),
        pt.Collider.sphere(0.5, position=(-1.4, 0.6, 0.2)),
        pt.Collider.capsule(0.25, 0.5, position=(0.3, 0.9, 1.5), rotation=(S8, 0.0, 0.0, C8)),
        pt.Collider.cylinder(0.4, 0.3, position=(-0.2, 0.8, -1.5)),
        pt.Collider.cone(0.6, 0.5, position=(1.2, 1.0, -1.2)),
        pt.Collider.hull_from_points([(0, 0, 0), (1, 0, 0), (0, 1.2, 0), (0, 0, 1)], position=(-1.3, -0.4, -1.3),
                                     rotation=(0.0, S8, 0.0, C8)),
    ],
    # stress_test_collision's floor and angled cube
    "c2": lambda: [
        pt.Collider.cuboid((4.0, 0.5, 4.0), position=(0.0, -0.5, 0.0)),
        pt.Collider.cuboid((0.5, 0.5, 0.5), position=(0.0, 0.5, 0.0),
                           rotation=(0.35355338, 0.35355338, 0.14644662, 0.85355339)),
    ],
    # lanes spawned inside two overlapping colliders: dist 0 from both
    "tie": lambda: [
        pt.Collider.sphere(0.6, position=(0.5, 0.0, 0.5)),
        pt.Collider.cuboid((0.5, 0.5, 0.5), position=(0.7, 0.1, 0.5)),
        pt.Collider.halfspace(position=(0.0, -0.8, 0.0)),
    ],
}


def _assert_kernel_equals_plain(c, table, s, f, unrolls):
    for u in unrolls:
        sk, ok = fs.fused_step(c.static, c.params, table, s, f, unroll=u)
        sp, op = plain_frames(c.static, c.params, s, f, u, colliders=table)
        for k in active_f32_fields(c.static) + SCALARS:
            assert torch.equal(getattr(sk, k), getattr(sp, k)), (u, k)
        assert int(ok.alive_count) == int(op.alive_count)
        s = sk
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_collision_kernel_matches_plain(cuda, scene):
    """The narrow phase on every kind (C = 7), on stress_test_collision's
    two cuboids and on lanes inside two colliders: bit for bit, single and
    U = 2 launches, each launch counted once."""
    c = pt.compile_spawner(_box_spawner(), device=cuda)
    table = pt.compile_colliders(SCENES[scene](), device=cuda)
    s = pt.init_pool_for(c, 131072)
    f = pt.make_frame_input(1 / 60)
    before = fs.fused_step.collide_launches
    s = _assert_kernel_equals_plain(c, table, s, f, [1] * 6 + [2] * 3)
    assert fs.fused_step.collide_launches - before == 9
    assert int(s.alive.sum()) > 40000


@pytest.mark.cuda
@pytest.mark.parametrize("n", [131072, 100003])
def test_dead_rank_claim_matches_plain(cuda, n):
    """Destroy-on-collision: the claim ranks dead lanes across 512 tiles (or
    a ragged last tile); claims, alive, cursor and fields are exact against
    the plain cumsum claim, and the tile offsets against their plain
    version."""
    c = pt.compile_spawner(_box_spawner(destroy=True), device=cuda)
    assert not c.static.ring_claim
    table = pt.compile_colliders(SCENES["c7"](), device=cuda)
    s = pt.init_pool_for(c, n)
    f = pt.make_frame_input(1 / 60)
    before = fs.tile_dead_offsets.launches
    s = _assert_kernel_equals_plain(c, table, s, f, [1] * 12)
    assert fs.tile_dead_offsets.launches - before == 12
    dead = ~s.alive
    assert int(dead.view(-1)[: n // 256 * 256].view(-1, 256).any(1).sum()) > 50  # holes in many tiles
    assert torch.equal(fs.tile_dead_offsets(s.alive).cpu(), fs.tile_dead_offsets(s.alive.cpu()))
    with pytest.raises(ValueError, match="unroll"):
        fs.fused_step(c.static, c.params, table, s, f, unroll=2)
