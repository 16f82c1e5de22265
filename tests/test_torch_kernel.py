"""The CUDA step kernel (with its narrow phase, dead-rank claim, force
fields, dump plane and stats) against its plain PyTorch version, on a card.

Imports torch and the port only, so on a machine without JAX it runs as
    python -m pytest --noconftest -q tests/test_torch_kernel.py
Every test that launches the kernel carries the `cuda` marker and skips
without a CUDA device; the table test runs anywhere."""

import dataclasses
import math
import time

import numpy as np
import pytest
import torch

import bevy_firework_tpu_torch as pt
from bevy_firework_tpu_torch.ops import fused_step as fs
from bevy_firework_tpu_torch.ops import table_layout as L
from bevy_firework_tpu_torch.render import pack_render_planes
from bevy_firework_tpu_torch.settings import ParticleCollisionSettings, ParticleEventHandlers
from bevy_firework_tpu_torch.collision import LOOP_MIN_COLLIDERS
from bevy_firework_tpu_torch.step import active_f32_fields, plain_frames, plain_step, stat_reductions

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
        s, _o = plain_step(c.static, c.params, None, s, f)
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
    ones are in test_torch_slice.py); the curve rows follow the header's
    knot stride (H_K)."""
    c = pt.compile_spawner(_det_spawner(), device="cpu")
    p = c.params.to_numpy()
    w = fs.pack_tables(c.static, c.params)
    fl = w.view(np.float32)
    em, ty, cv, K = w[L.H_EM_AT], L.TY_AT, w[L.H_CV_AT], w[L.H_K]
    assert fl[em + L.EM_DURATION] == p["duration"][0] and fl[em + L.EM_COUNT] == p["count"][0]
    np.testing.assert_array_equal(fl[em + L.EM_IANG:em + L.EM_IANG + 7], p["iangvel_params"][0])
    np.testing.assert_array_equal(fl[em + L.EM_INIT_ROT:em + L.EM_INIT_ROT + 4], p["init_rot"][0])
    np.testing.assert_array_equal(fl[ty + L.TY_ACCEL:ty + L.TY_ACCEL + 3], p["acceleration"][0])
    assert fl[ty + L.TY_ANG_DRAG] == p["angular_drag"][0]
    assert K == p["scale_ts"].shape[1] and cv == em + L.EM_STRIDE
    np.testing.assert_array_equal(fl[cv + L.CV_SCALE_VS * K:][:K], p["scale_vs"][0])
    np.testing.assert_array_equal(fl[cv + (L.CV_EMIS_TS + 4) * K:][:K], p["emis_vs"][0][:, 3])


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


def _box_spawner(destroy=False, rate=3e5, lifetime=2.0, handler=None):
    """Box emission, radial speed, no spread, gravity: every draw reaches the
    state through +, -, *, / and sqrt only (sinf/cosf see 0), so the kernel
    and the plain version agree bit for bit on every lane."""
    return pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(
            lifetime=pt.RandF32.constant(lifetime), initial_scale=pt.RandF32(0.02, 0.08),
            acceleration=(0.0, -9.81, 0.0), linear_drag=0.1,
            collision_settings=ParticleCollisionSettings(restitution=0.7, friction=0.3,
                                                         destroy_on_collision=destroy),
            event_handlers=ParticleEventHandlers(particles_destroyed=handler))],
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


def _assert_kernel_equals_plain(c, table, s, f, unrolls, f32_ulps=0):
    """Each launch against as many plain frames from the same state: the
    bookkeeping and the destroyed mask exact, f32 fields within f32_ulps."""
    for u in unrolls:
        sk, ok = fs.fused_step(c.static, c.params, table, s, f, unroll=u)
        sp, op = plain_frames(c.static, c.params, s, f, u, colliders=table)
        for k in SCALARS:
            assert torch.equal(getattr(sk, k), getattr(sp, k)), (u, k)
        for k in active_f32_fields(c.static):
            assert _ulps(getattr(sk, k), getattr(sp, k)) <= f32_ulps, (u, k)
        assert int(ok.alive_count) == int(op.alive_count)
        assert torch.equal(ok.destroyed_mask, op.destroyed_mask)
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
    version. The 12 launches claim from carried counts: one seed, no count
    and scan pair."""
    c = pt.compile_spawner(_box_spawner(destroy=True), device=cuda)
    assert not c.static.ring_claim
    table = pt.compile_colliders(SCENES["c7"](), device=cuda)
    s = pt.init_pool_for(c, n)
    f = pt.make_frame_input(1 / 60)
    before = (fs.tile_dead_offsets.launches, fs.claim_counts.seeds, fs.fused_step.dead_claim_launches)
    s = _assert_kernel_equals_plain(c, table, s, f, [1] * 12)
    after = (fs.tile_dead_offsets.launches, fs.claim_counts.seeds, fs.fused_step.dead_claim_launches)
    assert tuple(a - b for a, b in zip(after, before)) == (0, 1, 12)
    dead = ~s.alive
    assert int(dead.view(-1)[: n // 256 * 256].view(-1, 256).any(1).sum()) > 50  # holes in many tiles
    assert torch.equal(fs.tile_dead_offsets(s.alive).cpu(), fs.tile_dead_offsets(s.alive.cpu()))
    with pytest.raises(ValueError, match="unroll"):
        fs.fused_step(c.static, c.params, table, s, f, unroll=2)


def _claim_pair_equal(c, a, b, stats, label):
    """Two launches' states (and outputs) bit for bit: every scalar and
    field, the dump plane and the alive count."""
    (sa, oa), (sb, ob) = a, b
    for k in SCALARS:
        assert torch.equal(getattr(sa, k), getattr(sb, k)), (label, k)
    for k in active_f32_fields(c.static):
        assert _ulps(getattr(sa, k), getattr(sb, k)) == 0, (label, k)
    if stats:
        assert torch.equal(oa.destroyed_mask, ob.destroyed_mask), label
        assert int(oa.alive_count) == int(ob.alive_count), label


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("n", [131072, 100003, 1310720])
def test_carried_claim_equals_count_scan_and_plain(cuda, n, stats):
    """Kernel row 4: each destroy frame (a handler: the dump plane) claimed
    from the carried counts == the same launch given the scanned offsets
    (`_dead_offsets`, the count -> scan route) == the plain frame, bit for
    bit; the counts the carried launch leaves for its alive plane == their
    plain version; the first frame seeds, no other counts or scans."""
    from bevy_firework_tpu_torch.step import dead_tile_counts

    c = pt.compile_spawner(_box_spawner(destroy=True, handler=print), device=cuda)
    assert c.static.any_destroyed_dump and not c.static.ring_claim
    table = pt.compile_colliders(SCENES["c7"](), device=cuda)
    s = pt.init_pool_for(c, n)
    f = pt.make_frame_input(1 / 60)
    frames = 8 if n < 1_000_000 else 4
    seeds, scans = fs.claim_counts.seeds, fs.tile_dead_offsets.launches
    for i in range(frames):
        carried = fs.fused_step(c.static, c.params, table, s, f, stats=stats)
        scanned = fs.fused_step(c.static, c.params, table, s, f, stats=stats,
                                _dead_offsets=fs.tile_dead_offsets(s.alive))
        plain = plain_frames(c.static, c.params, s, f, 1, stats=stats, colliders=table)
        _claim_pair_equal(c, carried, scanned, stats, f"frame {i} carried vs scanned")
        _claim_pair_equal(c, carried, plain, stats, f"frame {i} carried vs plain")
        s = carried[0]
        assert torch.equal(fs._carried_claim(s.alive).cpu(), dead_tile_counts(s.alive.cpu())), i
    assert (fs.claim_counts.seeds - seeds, fs.tile_dead_offsets.launches - scans) == (1, frames)
    assert int((~s.alive).sum()) > 0 and int(s.alive.sum()) > 0


@pytest.mark.cuda
def test_carried_claim_chain_seeds_once(cuda):
    """A 50-frame destroy chain (multi_step_auto: single launches) == 50
    plain frames bit for bit, with one seed, no count and scan pair and 50
    launches on carried counts; then a launch from the chain's state takes
    its carry, and an alive plane edited in place, replaced or restacked
    is counted again (a seed each), each launch == plain."""
    from bevy_firework_tpu_torch.parallel.sharding import stack_pools as stack, state_slot as slot

    c = pt.compile_spawner(_box_spawner(destroy=True), device=cuda)
    table = pt.compile_colliders(SCENES["c7"](), device=cuda)
    s0 = pt.init_pool_for(c, 131072)
    f = pt.make_frame_input(1 / 60)
    before = (fs.claim_counts.seeds, fs.tile_dead_offsets.launches, fs.fused_step.dead_claim_launches)
    s, _o = fs.multi_step_auto(c.static, c.params, table, s0, f, 50, _captured=False)
    after = (fs.claim_counts.seeds, fs.tile_dead_offsets.launches, fs.fused_step.dead_claim_launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 0, 50)
    sp = s0
    for _ in range(50):
        sp, _op = plain_frames(c.static, c.params, sp, f, 1, colliders=table)
    for k in SCALARS:
        assert torch.equal(getattr(s, k), getattr(sp, k)), k
    for k in active_f32_fields(c.static):
        assert _ulps(getattr(s, k), getattr(sp, k)) == 0, k
    edited = dataclasses.replace(s, alive=s.alive.clone())
    edited.alive[:4096:7] = False
    fs._carry_claim(edited.alive, fs.claim_counts(s.alive))  # a stale carry: the edit below bumps the version
    edited.alive[1] = ~edited.alive[1]
    cases = [("carried", s, 0), ("edited", edited, 1), ("replaced", dataclasses.replace(s, alive=s.alive.clone()), 1),
             ("restacked", slot(stack([s, s]), 1), 1)]
    for label, st, seeded in cases:
        n0 = fs.claim_counts.seeds
        sk, _ok = fs.fused_step(c.static, c.params, table, st, f)
        assert fs.claim_counts.seeds - n0 == seeded, label
        sp, _op = plain_frames(c.static, c.params, st, f, 1, colliders=table)
        for k in SCALARS:
            assert torch.equal(getattr(sk, k), getattr(sp, k)), (label, k)


FIELDS = {
    "point": lambda: pt.ForceField.point((0.3, 0.8, -0.2), 6.0, 2.5),
    "vortex": lambda: pt.ForceField.vortex((0.1, 0.0, 0.2), (0.3, 0.9, 0.1), 5.0, 3.0),
    "axial": lambda: pt.ForceField.axial((-0.2, 0.0, 0.1), (0.0, 1.0, 0.0), 8.0, 2.0),
    "turbulence": lambda: pt.ForceField.turbulence((0.0, 0.5, 0.0), 4.0, 6.0, frequency=1.7, phase=0.3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("unroll", [1, 8])
@pytest.mark.parametrize("kind", sorted(FIELDS))
def test_force_field_kernel_matches_plain(cuda, kind, unroll):
    """One field of each kind (plus a disabled one) on the box spawner's
    spread lanes: the kernel's field block equals the plain field_accel bit
    for bit on point, vortex and axial; turbulence within 8 ulp of the f32
    fields (its 9 cosf per lane against PyTorch's CUDA cos, which agreed bit
    for bit on every earlier config, may part by an ulp and the integration
    carries it)."""
    c = pt.compile_spawner(_box_spawner(), device=cuda)
    table = pt.compile_force_fields([FIELDS[kind](), FIELDS["point"]()], device=cuda, active=[True, False])
    f = pt.make_frame_input(1 / 60, force_fields=table)
    s = pt.init_pool_for(c, 131072)
    before = fs.fused_step.fields_launches
    s = _assert_kernel_equals_plain(c, None, s, f, [unroll] * 4, f32_ulps=8 if kind == "turbulence" else 0)
    assert fs.fused_step.fields_launches - before == 4
    free, _o = plain_frames(c.static, c.params, pt.init_pool_for(c, 131072), pt.make_frame_input(1 / 60), 4 * unroll)
    assert int((s.alive & (s.vx != free.vx)).sum()) > 1000  # the field moved lanes


@pytest.mark.cuda
def test_cos_fast_is_cosf_below_its_bound(cuda):
    """The turbulence's straight-line cosine (cos_fast, CUDA's cosf fast
    path written out) maps every float below its bound, both signs, to
    cosf's bits: 0 mismatches over all 2 * 0x47ce4780 of them."""
    assert fs.cos_fast_mismatches(cuda) == 0


@pytest.mark.cuda
def test_force_fields_on_the_singular_locus(cuda):
    """Lanes that stay at a point field's centre and on a vortex's axis get 0
    from those fields in both versions (a select, no NaN)."""
    sp = pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(lifetime=pt.RandF32.constant(1.0), linear_drag=0.0)],
        emission_settings=[pt.EmissionSettings(emission_pacing=pt.EmissionPacing.rate(6000.0))])
    c = pt.compile_spawner(sp, device=cuda)
    table = pt.compile_force_fields([pt.ForceField.point((0.0, 0.0, 0.0), 5.0, 2.0),
                                     pt.ForceField.vortex((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 5.0, 2.0)], device=cuda)
    f = pt.make_frame_input(1 / 60, force_fields=table)
    s = _assert_kernel_equals_plain(c, None, pt.init_pool_for(c, 4096), f, [1, 8])
    assert int(s.alive.sum()) > 500 and bool((s.vx[s.alive] == 0).all()) and bool(torch.isfinite(s.vx).all())


@pytest.mark.cuda
@pytest.mark.parametrize("destroy", [False, True])
def test_dump_plane_matches_plain(cuda, destroy):
    """The destroyed-dump plane of a ring archetype with a handler (deaths by
    age only; alive derived from age in both versions) and of a destroy
    archetype with a handler (dead-rank claim, deaths by collision): equal to
    the plain mask every frame, and not empty."""
    c = pt.compile_spawner(_box_spawner(destroy=destroy, lifetime=0.1, handler=print), device=cuda)
    assert c.static.any_destroyed_dump and c.static.ring_claim == (not destroy)
    table = pt.compile_colliders(SCENES["c7"](), device=cuda) if destroy else None
    s = pt.init_pool_for(c, 131072)
    f = pt.make_frame_input(1 / 60)
    before, dumped = fs.fused_step.dump_launches, 0
    for _ in range(12):
        sk, ok = fs.fused_step(c.static, c.params, table, s, f)
        sp, op = plain_frames(c.static, c.params, s, f, 1, colliders=table)
        for k in active_f32_fields(c.static) + SCALARS:
            assert torch.equal(getattr(sk, k), getattr(sp, k)), k
        assert torch.equal(ok.destroyed_mask, op.destroyed_mask)
        dumped += int(ok.destroyed_mask.sum())
        s = sk
    assert fs.fused_step.dump_launches - before == 12 and dumped > 1000


def _three_type_spawner():
    types = [pt.ParticleSettings(lifetime=pt.RandF32.constant(0.5 + 0.2 * t), initial_scale=pt.RandF32(0.02, 0.08),
                                 scale_curve=pt.FireworkCurve.uneven_samples([(0.0, 1.0), (1.0, 0.5 + t)]),
                                 acceleration=(0.0, -1.0 * t, 0.0)) for t in range(3)]
    emitters = [pt.EmissionSettings(particle_index=t, emission_pacing=pt.EmissionPacing.rate(1e5 * (t + 1)),
                                    emission_shape=pt.EmissionShape.box((1.0 + t, 0.5, 1.0)),
                                    initial_velocity=pt.RandVec3(pt.RandF32(0.5, 3.0), (0.0, 1.0, 0.0), 0.0),
                                    initial_velocity_radial=pt.RandF32(1.0, 4.0)) for t in range(3)]
    return pt.ParticleSpawner(particle_settings=types, emission_settings=emitters)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [131072, 100003])
@pytest.mark.parametrize("types", [1, 3])
def test_kernel_stats_match_epilogue(cuda, n, types):
    """The kernel's stats row (AABB of pos +- scale over survivors, alive and
    per-type counts across blocks) equals the plain reductions
    (`step.stat_reductions`) over the state the same launch wrote, and the
    plain version's outputs over the same frames, by value, at 512 tiles and
    at a ragged 100003 lanes."""
    c = pt.compile_spawner(_box_spawner() if types == 1 else _three_type_spawner(), device=cuda)
    s = pt.init_pool_for(c, n)
    f = pt.make_frame_input(1 / 60)
    before = fs.fused_step.stats_launches
    for u in [1] * 6 + [8, 1]:
        sk, ok = fs.fused_step(c.static, c.params, None, s, f, unroll=u)
        sp, op = plain_frames(c.static, c.params, s, f, u)
        kw = {k: getattr(sk, k) for k in ("px", "py", "pz", "initial_scale", "age", "lifetime")}
        want = dict(zip(("aabb_min", "aabb_max", "alive_count", "alive_count_per_type"),
                        stat_reductions(c.static, c.params, kw, sk.ptype, sk.alive)))
        for k, v in want.items():
            assert torch.equal(getattr(ok, k), v), k
        for k in ("alive_count", "alive_count_per_type", "aabb_valid", "aabb_min", "aabb_max", "finished_event"):
            assert torch.equal(getattr(ok, k), getattr(op, k)), k
        for k in active_f32_fields(c.static) + SCALARS:
            assert torch.equal(getattr(sk, k), getattr(sp, k)), k
        s = sk
    assert fs.fused_step.stats_launches - before == 8
    assert int(ok.alive_count) > 20000 and int((ok.alive_count_per_type > 0).sum()) == types


# ---- nested emission: the cadence kernels, the child rows, the hybrid frame ----

def _nested_spawner(destroy=False, chained=False, shape=None, spread=0.0):
    """A global rocket emitter (constant draws) and nested children of type
    1 (and with `chained` grandchildren of type 2); with `destroy` the
    rockets fall back and die on a floor (`NESTED_FLOOR`) before their
    lifetime ends, so dead lanes open behind the cursor. Children draw box
    offsets, random speeds and radial speeds: with spread 0 their draws meet
    no sinf/cosf, so kernel and plain version agree bit for bit."""
    col = ParticleCollisionSettings(restitution=0.5, friction=0.2, destroy_on_collision=True) if destroy else None
    types = [pt.ParticleSettings(lifetime=pt.RandF32.constant(0.6), linear_drag=0.1, collision_settings=col,
                                 acceleration=(0.0, -9.81 if destroy else 0.0, 0.0)),
             pt.ParticleSettings(lifetime=pt.RandF32(0.3, 0.5), linear_drag=0.2, acceleration=(0.0, -2.0, 0.0)),
             pt.ParticleSettings(lifetime=pt.RandF32.constant(0.4), linear_drag=0.3)]
    child = dict(emission_shape=shape or pt.EmissionShape.box((0.1, 0.2, 0.1)),
                 initial_velocity=pt.RandVec3(pt.RandF32(0.1, 0.9), (0.0, 1.0, 0.0), spread),
                 initial_velocity_radial=pt.RandF32(0.2, 1.0), inherit_parent_velocity=True)
    emitters = [pt.EmissionSettings(particle_index=0, emission_pacing=pt.EmissionPacing.rate(20000.0),
                                    initial_velocity=pt.RandVec3.constant((0.3, 2.0, 0.1))),
                pt.EmissionSettings(particle_index=1, emission_mode=pt.EmissionMode.nested(0),
                                    emission_pacing=pt.EmissionPacing.count_over_duration(6.0, 1.0, 0.1, 1.0),
                                    **child)]
    if chained:
        emitters.append(pt.EmissionSettings(particle_index=2, emission_mode=pt.EmissionMode.nested(1),
                                            emission_pacing=pt.EmissionPacing.count_over_duration(
                                                3.0, 1.0, 0.2, 0.9), **child))
    return pt.ParticleSpawner(particle_settings=types if chained else types[:2], emission_settings=emitters)


NESTED_FLOOR = [pt.Collider.halfspace(position=(0.0, -0.2, 0.0))]


def _cadence_inputs(n, seed, device):
    """Random pool planes for a nested cadence pass: half the lanes alive,
    two types, ages inside the lifetime, anchors unset (f32::MIN) or set."""
    rng = np.random.default_rng(seed)
    life = rng.uniform(0.5, 2.0, n).astype(np.float32)
    age = (rng.uniform(0.0, 1.0, n) * life).astype(np.float32)
    le = np.where(rng.uniform(size=n) < 0.5, np.finfo(np.float32).min,
                  age * rng.uniform(0.0, 1.0, n)).astype(np.float32)
    t = {"alive": torch.from_numpy(rng.uniform(size=n) < 0.5), "ptype": torch.from_numpy(rng.integers(0, 2, n,
                                                                                                    dtype=np.int32)),
         "age": torch.from_numpy(age), "lifetime": torch.from_numpy(life), "le": torch.from_numpy(le)}
    for k in ("px", "py", "pz", "vx", "vy", "vz"):
        t[k] = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    return {k: v.to(device) for k, v in t.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("fetch", [False, True])
def test_nested_cadence_kernels_match_plain(cuda, fetch):
    """Kernel row 8 (the nested-stage kernel's pass alone) on 100003 lanes
    (391 tiles, a ragged tail) with a burst pacing whose total exceeds M =
    4096, so the deferral cuts parents and child ranks straddle tiles:
    new_le, cum (or the fetched parent values), and the total equal the
    plain version's bit for bit."""
    from bevy_firework_tpu_torch.step import nested_cadence

    c = pt.compile_spawner(_nested_spawner(), device=cuda)
    c_burst = pt.compile_spawner(pt.ParticleSpawner(
        particle_settings=[pt.ParticleSettings(), pt.ParticleSettings()],
        emission_settings=[pt.EmissionSettings(), pt.EmissionSettings(
            particle_index=1, emission_mode=pt.EmissionMode.nested(0),
            emission_pacing=pt.EmissionPacing.count_over_duration(10.0, 1.0, 0.0, 0.001))]), device=cuda)
    for cc in (c, c_burst):
        t = _cadence_inputs(100003, 5, cuda)
        gate = torch.ones((), dtype=torch.bool, device=cuda)
        pf = {k: t[k] for k in ("px", "py", "pz", "vx", "vy", "vz")} if fetch else None
        args = (cc.static, cc.params, 1, t["alive"], t["ptype"], t["age"], t["lifetime"], t["le"], gate, 4096)
        k_le, k_cum, k_total, k_pv = fs.nested_cadence_pass(*args, parent_fields=pf)
        p_le, p_cum, p_total, p_pv = nested_cadence(*args, parent_fields=pf)
        assert torch.equal(k_le, p_le) and int(k_total) == int(p_total)
        if fetch:
            for k in pf:
                assert torch.equal(k_pv[k], p_pv[k]), k
        else:
            assert torch.equal(k_cum, p_cum)
    assert int(k_total) > 4096  # the burst: deferral cut it


def _rotating_child_spawner():
    """`_nested_spawner` with live rotation: children on a sphere with
    spread and an angular velocity, so the stage reads ten parent fields
    (position, rotation, velocity)."""
    sp = _nested_spawner(spread=0.7, shape=pt.EmissionShape.sphere(0.2))
    es = list(sp.emission_settings)
    es[1] = dataclasses.replace(es[1], initial_angular_velocity=pt.RandVec3(pt.RandF32(1.0, 2.0), (1, 0, 0), 0.3))
    return dataclasses.replace(sp, emission_settings=tuple(es))


@pytest.mark.cuda
@pytest.mark.parametrize("subset", ["position_velocity", "one", "all"])
def test_nested_cadence_pass_fetches_any_parent_fields(cuda, subset):
    """The pass alone in fetch mode copies by rank whichever parent planes
    it is given, not the archetype's `nested_parent_fields`: on an
    archetype with live rotation (ten parent fields), the six position and
    velocity planes, one plane and all ten, on 100003 lanes with a total
    past M, equal the plain version's bit for bit."""
    from bevy_firework_tpu_torch.step import nested_cadence

    c = pt.compile_spawner(_rotating_child_spawner(), device=cuda)
    names = fs.nested_parent_fields(c.static)
    assert len(names) == 10
    t = _cadence_inputs(100003, 21, cuda)
    for k in ("qx", "qy", "qz", "qw"):
        t[k] = torch.rand_like(t["px"])
    pick = {"position_velocity": ("px", "py", "pz", "vx", "vy", "vz"), "one": ("qw",), "all": names}[subset]
    pf = {k: t[k] for k in pick}
    gate = torch.ones((), dtype=torch.bool, device=cuda)
    args = (c.static, c.params, 1, t["alive"], t["ptype"], t["age"], t["lifetime"], t["le"], gate, 1024)
    k_le, k_cum, k_total, k_pv = fs.nested_cadence_pass(*args, parent_fields=pf)
    p_le, _p_cum, p_total, p_pv = nested_cadence(*args, parent_fields=pf)
    assert k_cum is None and sorted(k_pv) == sorted(pick)
    assert torch.equal(k_le, p_le) and int(k_total) == int(p_total) > 1024
    for k in pick:
        assert torch.equal(k_pv[k], p_pv[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("elide", [True, False])
def test_nested_child_rows_kernel_matches_plain(cuda, elide):
    """The nested-stage kernel's child rows alone against their plain
    version on the card, both parent modes, with and without live rotation
    (spread and a sphere: sinf/cosf within 4 ulp)."""
    from bevy_firework_tpu_torch.step import nested_cadence, nested_child_rows

    c = pt.compile_spawner(_nested_spawner() if elide else _rotating_child_spawner(), device=cuda)
    assert c.static.elide_rotation == elide
    t = _cadence_inputs(65536, 9, cuda)
    for k in ("qx", "qy", "qz"):
        t[k] = torch.zeros_like(t["px"])
    t["qw"] = torch.ones_like(t["px"])
    names = fs.nested_parent_fields(c.static)
    planes = {k: t[k] for k in names}
    gate = torch.ones((), dtype=torch.bool, device=cuda)
    _le, cum, _total, _pv = nested_cadence(c.static, c.params, 1, t["alive"], t["ptype"], t["age"], t["lifetime"],
                                           t["le"], gate, 1024)
    key = np.array([7, 123456], np.uint32)
    f = pt.make_frame_input(1 / 60, modifier_scale=1.3, modifier_speed=0.7)
    pv = {k: v[fs.nested_parents(cum, 1024)] for k, v in planes.items()}
    p_rows = nested_child_rows(c.static, c.params, f, 1, pv, key, 1024)
    for kw in ({"cum": cum, "parent_planes": planes}, {"parent_vals": pv}):
        k_rows = fs.nested_child_rows(c.static, c.params, f, 1, key, 1024, **kw)
        assert k_rows.shape == p_rows.shape == (len(active_f32_fields(c.static)), 1024)
        assert _ulps(k_rows, p_rows) <= (0 if elide else 4)


def _stage_case(case, device):
    """(compiled, cadence inputs, M) of a nested-stage case: `ring` and
    `dead_rank` at 100003 lanes (a ragged last tile; anchors set just below
    the age but for 0.2% of them, so the total stays below M = 1024 and the
    ranks above it take the ring's zero parent or the clamped lane n - 1),
    `burst` (the first tile owns every rank below M, at least 256) and
    `wide` (1310720 lanes, 5120 tiles)."""
    n = {"ring": 100003, "dead_rank": 100003, "burst": 65536, "wide": 1310720}[case]
    t = _cadence_inputs(n, 13, device)
    if case in ("ring", "dead_rank"):
        unset = torch.from_numpy(np.random.default_rng(3).uniform(size=n) < 0.002).to(device)
        t["le"] = torch.where(unset, torch.full_like(t["le"], np.finfo(np.float32).min), t["age"] * 0.97)
    if case == "burst":
        sp = pt.ParticleSpawner(
            particle_settings=[pt.ParticleSettings(), pt.ParticleSettings()],
            emission_settings=[pt.EmissionSettings(), pt.EmissionSettings(
                particle_index=1, emission_mode=pt.EmissionMode.nested(0),
                emission_pacing=pt.EmissionPacing.count_over_duration(10.0, 1.0, 0.0, 0.001))])
    else:
        sp = _nested_spawner(destroy=case == "dead_rank")
    return pt.compile_spawner(sp, device=device), t, 1024


def _stage_args(c, t, key, start):
    names = fs.nested_parent_fields(c.static)
    gate = torch.ones((), dtype=torch.bool, device=t["age"].device)
    return (c.static, c.params, pt.make_frame_input(1 / 60, modifier_scale=1.3, modifier_speed=0.7), 1, t["alive"],
            t["ptype"], t["age"], t["lifetime"], t["le"], gate, 1024, {k: t[k] for k in names}, key, start)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ring", "dead_rank", "burst", "wide"])
def test_nested_stage_matches_plain(cuda, case):
    """Kernel rows 8 and 9b in one launch (`fs.nested_stage`) against its
    plain version (`step.nested_stage`) on the card: the anchors, the NS
    record and the [rows, M] child buffer bit for bit (box offsets and no
    spread: no sinf/cosf), unfolded and with the carried tile counts of a
    folded frame; the same inputs on a ragged 100003-lane pool, a tile that
    owns >= 256 ranks and a 1310720-lane pool (5120 tiles)."""
    from bevy_firework_tpu_torch.step import nested_cadence, nested_stage

    import torch_nested_configs as nested_cfg

    c, t, M = _stage_case(case, cuda)
    key = np.array([5, 777], np.uint32)
    start = torch.tensor(t["alive"].shape[0] // 3 if c.static.ring_claim else 0, dtype=torch.int32, device=cuda)
    args = _stage_args(c, t, key, start)
    p_le, p_rec, p_rows = nested_stage(*args)
    gate = torch.ones((), dtype=torch.bool, device=cuda)
    carried = nested_cfg.lane_tile_counts(c.static, c.params, 1, t["alive"], t["ptype"], t["age"],
                                          t["lifetime"], t["le"], gate)
    for counts in (None, carried):
        before = fs.nested_stage.launches
        k_le, k_rec, k_rows = fs.nested_stage(*args, counts=counts)
        assert fs.nested_stage.launches == before + 1
        assert torch.equal(k_le, p_le) and torch.equal(k_rec, p_rec), (k_rec.tolist(), p_rec.tolist())
        assert torch.equal(k_rows, p_rows)
    cum = nested_cadence(c.static, c.params, 1, t["alive"], t["ptype"], t["age"], t["lifetime"], t["le"], gate, M)[1]
    assert 0 < int(p_rec[L.NS_TOTAL])
    assert (int(p_rec[L.NS_TOTAL]) < M) == (case in ("ring", "dead_rank"))
    if case == "burst":
        assert nested_cfg.tile_ranks(cum, M) >= 256 and int(p_rec[L.NS_TOTAL]) > M


@pytest.mark.cuda
def test_nested_stage_repeats_and_two_streams(cuda):
    """The grid barrier's scratch: 50 launches of one nested stage on the
    same inputs give the same bits (the arrival count the last block
    zeroes is ready for each next launch), and launches on two streams at
    once, each with its own scratch, give the same bits as on one."""
    c, t, _M = _stage_case("ring", cuda)
    key = np.array([5, 777], np.uint32)
    start = torch.tensor(t["alive"].shape[0] // 3, dtype=torch.int32, device=cuda)
    args = _stage_args(c, t, key, start)
    ref = fs.nested_stage(*args)
    for _ in range(50):
        got = fs.nested_stage(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    outs = []
    for s in (s1, s2, s1, s2):
        with torch.cuda.stream(s):
            outs.append(fs.nested_stage(*args))
    torch.cuda.synchronize()
    for got in outs:
        assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ring", "chained", "dead_rank"])
def test_hybrid_frames_match_plain(cuda, case):
    """Hybrid frames (cadence passes, child rows, the merge launch) against
    the plain hybrid frame on the card: every field, the cursor, the
    anchors and the nested counts bit for bit, frame by frame; a
    multi_step_auto chain equals as many plain frames."""
    c = pt.compile_spawner(_nested_spawner(destroy=case == "dead_rank", chained=case == "chained"),
                           nested_buffer=1024, device=cuda)
    table = pt.compile_colliders(NESTED_FLOOR, device=cuda) if case == "dead_rank" else None
    f = pt.make_frame_input(1 / 60)
    s = pt.init_pool_for(c, 65536)
    for i in range(24):
        sk, ok = fs.fused_step(c.static, c.params, table, s, f)
        sp, op = plain_frames(c.static, c.params, s, f, 1, colliders=table)
        for k in active_f32_fields(c.static) + SCALARS + ("last_emitted", "rng_key"):
            assert torch.equal(getattr(sk, k).cpu(), getattr(sp, k).cpu()), (i, k)
        for k in ("alive_count", "alive_count_per_type", "nested_deferred", "nested_dropped"):
            assert torch.equal(getattr(ok, k), getattr(op, k)), (i, k)
        s = sk
    assert int(ok.alive_count_per_type[1]) > 1000
    sc, _o = fs.multi_step_auto(c.static, c.params, table, s, f, 5)
    ref, _o = plain_frames(c.static, c.params, s, f, 5, colliders=table)
    for k in active_f32_fields(c.static) + SCALARS + ("last_emitted",):
        assert torch.equal(getattr(sc, k), getattr(ref, k)), k


import torch_nested_configs as nested_cfg  # noqa: E402


def _hybrid_vs_plain(c, table, s, f, stats, label):
    """One hybrid frame through the entry point on the card against the plain
    hybrid frame: every pool field, the cursor, the anchors, the alive plane
    and the finished latch bit for bit, and with stats the outputs. Returns
    the kernel's state and outputs."""
    sk, ok = fs.fused_step(c.static, c.params, table, s, f, stats=stats)
    sp, op = plain_frames(c.static, c.params, s, f, 1, stats=stats, colliders=table)
    for k in active_f32_fields(c.static) + SCALARS + ("last_emitted", "rng_key", "finished_notified"):
        assert torch.equal(getattr(sk, k).cpu(), getattr(sp, k).cpu()), (label, k)
    assert (ok is None) == (not stats), label
    if stats:
        for k in ("alive_count", "alive_count_per_type", "nested_deferred", "nested_dropped", "finished_event",
                  "aabb_valid", "aabb_min", "aabb_max"):
            assert torch.equal(getattr(ok, k), getattr(op, k)), (label, k)
    return sk, ok


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("case", ["ring", "chained", "dead_rank", "wrap", "dead_rank_floor", "colliders_fields"])
def test_merge_instantiations_match_plain(cuda, case, stats):
    """Kernel rows 9 and 10 on the card: a hybrid frame without colliders or
    fields takes fused_step_kernel_merge (ring and dead-rank, stats on and
    off; `dead_rank` a destroy-on-collision archetype stepped without a
    collider table), one with colliders (`dead_rank_floor`: the same
    archetype on a floor) or with colliders and a force field
    (`colliders_fields`, a ring) fused_step_kernel's merge
    instantiations; each frame == the plain hybrid frame bit for bit, the
    alive plane and the finished latch included (`merge_latch`'s words:
    with every emitter disabled the pool empties and the event fires once),
    and each launch counted under its instantiation. `wrap` puts the ring
    cursor 40 lanes before the pool's end, so the children's window wraps."""
    destroy = case.startswith("dead_rank")
    c = pt.compile_spawner(_nested_spawner(destroy=destroy, chained=case == "chained"), nested_buffer=1024,
                           device=cuda)
    table = pt.compile_colliders(NESTED_FLOOR, device=cuda) if case == "dead_rank_floor" else None
    f = pt.make_frame_input(1 / 60)
    n = 65536
    if case == "colliders_fields":  # a ring archetype whose rockets bounce off the floor, under a point field
        sp = _nested_spawner()
        col = ParticleCollisionSettings(restitution=0.5, friction=0.2)
        sp = dataclasses.replace(sp, particle_settings=[dataclasses.replace(sp.particle_settings[0],
                                                                            collision_settings=col),
                                                        sp.particle_settings[1]])
        c = pt.compile_spawner(sp, nested_buffer=1024, device=cuda)
        table = pt.compile_colliders(NESTED_FLOOR, device=cuda)
        f = pt.make_frame_input(1 / 60, force_fields=pt.compile_force_fields(
            [pt.ForceField.point((0.3, 0.8, -0.2), 6.0, 2.5)], device=cuda))
    lean = case not in ("dead_rank_floor", "colliders_fields")
    assert fs.merge_lean(c.static, table, f) == lean
    s = pt.init_pool_for(c, n)
    fs.fused_step.merge_lean_launches = fs.fused_step.merge_wide_launches = fs.fused_step.merge_launches = 0
    frames = 0
    for i in range(16):
        if case == "wrap" and i == 8:
            s = dataclasses.replace(s, ring_cursor=torch.tensor(n - 40, dtype=torch.int32, device=cuda))
        s, _o = _hybrid_vs_plain(c, table, s, f, stats, f"{case} frame {i}")
        frames += 1
    assert int(s.alive.sum()) > 1000
    if case == "wrap":
        assert int(s.ring_cursor) < n - 40  # the windows wrapped past the pool's end
    off = dataclasses.replace(s, enabled=torch.zeros_like(s.enabled))
    fired = 0
    for i in range(60):  # nothing spawns: the pool empties, the event fires once
        off, ok = _hybrid_vs_plain(c, table, off, f, True, f"{case} disabled frame {i}")
        fired += int(ok.finished_event)
        frames += 1
    assert fired == 1 and bool(off.finished_notified) and not bool(off.alive.any())
    assert fs.fused_step.merge_launches == frames
    assert (fs.fused_step.merge_lean_launches, fs.fused_step.merge_wide_launches) == (
        (frames, 0) if lean else (0, frames))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65536, 100003])
def test_merge_fold_epilogue_lean(cuda, n):
    """Kernel row 10 in fused_step_kernel_merge: folded frames from a seed
    carry, with and without stats, against the plain hybrid frame (state,
    finished latch, outputs) and the carry each launch leaves against
    `step.nested_fold_counts` on its own post-frame state (per-tile counts,
    the next NS buffer: NS_ANY, zero records); 100003 lanes end in a
    ragged tile, whose lanes past the pool reach the epilogue's barrier."""
    c = pt.compile_spawner(_nested_spawner(chained=True), nested_buffer=1024, device=cuda)
    f = pt.make_frame_input(1 / 60)
    s, _o = fs.multi_step_auto(c.static, c.params, None, pt.init_pool_for(c, n), f, 20)
    fs.fused_step.merge_lean_launches = fs.fused_step.fold_launches = 0
    for i, stats in enumerate((False, True, False, True)):
        seed = fs._seed_nested_carry(c.static, c.params, s)
        res = fs.fused_step_hybrid(c.static, c.params, None, s, f, stats=stats, nested_carry=seed, fold_out=True)
        sp, op = plain_frames(c.static, c.params, s, f, 1, stats=stats)
        for k in active_f32_fields(c.static) + SCALARS + ("last_emitted", "rng_key", "finished_notified"):
            assert torch.equal(getattr(res[0], k), getattr(sp, k)), (i, k)
        if stats:
            for k in ("alive_count_per_type", "nested_deferred", "finished_event", "aabb_valid"):
                assert torch.equal(getattr(res[1], k), getattr(op, k)), (i, k)
        nested_cfg.check_carry(c.static, c.params, res[0], res[-1], f"frame {i}")
        s = res[0]
    assert (fs.fused_step.merge_lean_launches, fs.fused_step.fold_launches) == (4, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65536, 100003])
@pytest.mark.parametrize("chained", [False, True])
def test_fold_epilogue_matches_plain(cuda, chained, n):
    """Kernel row 10: the seed's count kernels and the merge launch's fold
    epilogue against `step.nested_fold_counts` on the state each read (the
    launch's own post-frame state), per tile and the next frame's NS_ANY,
    bit for bit, every 4th frame of a 32-frame chain; 100003 lanes end in a
    ragged tile. Children first emit near frame 9, grandchildren near 17."""
    c = pt.compile_spawner(_nested_spawner(chained=chained), nested_buffer=1024, device=cuda)
    f = pt.make_frame_input(1 / 60)
    s = pt.init_pool_for(c, n)
    totals = []
    for i in range(8):
        s, _o = fs.multi_step_auto(c.static, c.params, None, s, f, 3)
        s, r = nested_cfg.check_fold_epilogue(c, s, f, label=f"frame {4 * i + 3}")
        totals.append(r["fold_totals"])
    assert min(t[0] for t in totals[3:]) > 0 and min(t[-1] for t in totals[5:]) > 0  # every stage's parents emit


@pytest.mark.cuda
@pytest.mark.parametrize("chained", [False, True])
def test_folded_chain_equals_unfolded_on_the_card(cuda, chained):
    """bench.py's nested cells' spawners at their width (131072 lanes,
    nested_buffer 1024): two 30-frame folded chains == the unfolded chain,
    every pool field, every output and the nested counts bit for bit; then
    chains with the emitters' enabled bits toggled between them; the folded
    chain launches one count kernel per nested emitter (the seed),
    one nested-stage launch per emitter and frame (no scan or apply: no
    tile_scan_kernel, whose only launcher is now the dead-rank claim's),
    and the fold epilogue on every frame but the last."""
    c = pt.compile_spawner(nested_cfg.bench_nested(chained), nested_buffer=1024, device=cuda)
    f = pt.make_frame_input(1 / 60)
    s = pt.init_pool_for(c, 131072)
    n_em = len(fs.nested_emitters(c.static))
    for i in range(2):
        fs._seed_nested_carry.launches = fs.nested_stage.launches = fs.tile_dead_offsets.launches = 0
        fs.nested_cadence_pass.launches = fs.nested_child_rows.launches = fs.fused_step.fold_launches = 0
        a, oa = fs.multi_step_auto(c.static, c.params, None, s, f, 30, _captured=False)
        assert (fs._seed_nested_carry.launches, fs.tile_dead_offsets.launches, fs.nested_stage.launches,
                fs.nested_cadence_pass.launches, fs.nested_child_rows.launches,
                fs.fused_step.fold_launches) == (n_em, 0, 30 * n_em, 0, 0, 29)
        b, ob = fs.chain_hybrid_unfolded(c.static, c.params, None, s, f, 30)
        nested_cfg.assert_chains_equal(a, oa, b, ob, f"chain {i}")
        s = a
    assert min(oa.alive_count_per_type.tolist()) > 0
    nested_cfg.check_enabled_toggles(c, s, f, 10)


# ---------------------------------------------------------------------------
# fleets (kernel row 7): S pools of one archetype in one launch
# ---------------------------------------------------------------------------

import torch_fleet_configs as fleet_cfg  # noqa: E402
from bevy_firework_tpu_torch.parallel.sharding import stack_frames, stack_pools, state_slot  # noqa: E402
from bevy_firework_tpu_torch.models import effects  # noqa: E402
from bevy_firework_tpu_torch.pool import POOL_FIELDS  # noqa: E402
from bevy_firework_tpu_torch.profile_step import tornado_fields  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("case", fleet_cfg.CASES)
def test_fleet_kernel_equals_solo_launches(cuda, case):
    """Each slot of a fleet launch equals a solo launch of its pool, bit for
    bit (pool, keys, outputs, render planes), and the plain frames of its
    pool (rotation within 2 ulp), on slots whose params, seeds, frames and
    fields differ; 16421 lanes per slot: a ragged last tile."""
    before = fs.fused_step_fleet.launches
    res = fleet_cfg.check_fleet_equals_solo(case, cuda, 16421, plain=True)
    assert fs.fused_step_fleet.launches > before
    assert len(set(res["live"])) == fleet_cfg.S and min(res["live"]) > 1000, res
    if case == "destroy_dump":
        assert res["destroyed"] > 1000, res


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fleet16_u8", "dead_rank_3x1M_u1"])
def test_fleet_with_more_tiles_than_blocks_equals_solo_launches(cuda, case):
    """A fleet launch shares one resident wave among its slots, so each
    block strides several of its slot's tiles: fleet_16x55k's shape (16
    slots of 65536 lanes, 256 tiles each, at U = 8) and 3 slots of 1310720
    lanes (5120 tiles each) at U = 1 with the stats block, the dump plane
    and the dead-rank claim: every slot equals its solo launch bit for bit
    (pool, keys, outputs), launch after launch."""
    if case == "dead_rank_3x1M_u1":
        res = fleet_cfg.check_fleet_equals_solo("destroy_dump", cuda, 1310720)
        assert min(res["live"]) > 100000 and res["destroyed"] > 10000, res
        return
    sp = effects.stress_test()[0]
    es = dataclasses.replace(sp.emission_settings[0], emission_pacing=pt.EmissionPacing.rate(55000.0))
    c = pt.compile_spawner(dataclasses.replace(sp, emission_settings=(es,)), device=cuda)
    pools = [pt.init_pool_for(c, 65536, seed=i) for i in range(16)]
    frames = [pt.make_frame_input(1 / 60, translation=(float(i), 0.0, 0.0)) for i in range(16)]
    st, fr = stack_pools(pools), stack_frames(frames)
    for _ in range(4):
        st, out = fs.fused_step_fleet(c.static, c.params, None, st, fr, unroll=8)
        for i in range(16):
            pools[i], oi = fs.fused_step(c.static, c.params, None, pools[i], frames[i], unroll=8)
            for k in POOL_FIELDS:
                assert torch.equal(getattr(state_slot(st, i), k), getattr(pools[i], k)), (i, k)
            for k, v in vars(oi).items():
                assert torch.equal(getattr(out, k)[i], v), (i, k)
    assert int(out.alive_count.min()) > 25000


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(FIELDS) + ["tornado"])
def test_field_fleet_matches_solo_and_plain(cuda, kind):
    """The field block's fleet instantiations (register-capped as the solo
    ones): 3 slots of 65536 lanes whose fields differ per slot, at U = 1
    and U = 8; each slot equals its solo launch bit for bit, and the solo
    launch the plain frames under fields_det's rule (point, vortex and
    axial bit for bit; with turbulence within 8 ulp: cosf against
    PyTorch's CUDA cos)."""
    c = pt.compile_spawner(_box_spawner(), device=cuda)

    def fields(i):
        if kind == "tornado":
            return tornado_fields(0.2 * i, 0.1)
        return [dataclasses.replace(FIELDS[kind](), position=(0.3 * i, 0.8, -0.2))]

    frames = [pt.make_frame_input(1 / 60, force_fields=pt.compile_force_fields(fields(i), device=cuda))
              for i in range(3)]
    pools = [pt.init_pool_for(c, 65536, seed=i) for i in range(3)]
    st, fr = stack_pools(pools), stack_frames(frames)
    ulps = 8 if kind in ("turbulence", "tornado") else 0
    before = fs.fused_step_fleet.fields_launches
    for u in (1, 8, 8, 1):
        st, _o = fs.fused_step_fleet(c.static, c.params, None, st, fr, unroll=u)
        for i in range(3):
            solo, _o = fs.fused_step(c.static, c.params, None, pools[i], frames[i], unroll=u)
            plain, _o = plain_frames(c.static, c.params, pools[i], frames[i], u)
            for k in POOL_FIELDS:
                assert torch.equal(getattr(state_slot(st, i), k), getattr(solo, k)), (u, i, k)
            for k in SCALARS:
                assert torch.equal(getattr(solo, k), getattr(plain, k)), (u, i, k)
            for k in active_f32_fields(c.static):
                assert _ulps(getattr(solo, k), getattr(plain, k)) <= ulps, (u, i, k)
            pools[i] = solo
    assert fs.fused_step_fleet.fields_launches - before == 4
    assert int(st.alive.sum()) > 30000


@pytest.mark.cuda
def test_fleet_launches_in_chunks_of_the_seed_row(cuda):
    """20 slots at U = 8 take two launches (16 slots of seeds per launch);
    every slot equals its solo chain, and a chain's stats come from its
    last launch."""
    c = pt.compile_spawner(_det_spawner(), device=cuda)
    pools = [pt.init_pool_for(c, 4096, seed=i) for i in range(20)]
    frames = [pt.make_frame_input(1 / 50, translation=(float(i), 0.0, 0.0)) for i in range(20)]
    before = fs.fused_step_fleet.launches
    st, out = fs.multi_step_fleet(c.static, c.params, None, stack_pools(pools), stack_frames(frames), 17,
                                  _captured=False)
    assert fs.fused_step_fleet.launches - before == 2 * 2 + 1  # two U=8 launches, one U=1, each in 2 chunks
    for i in (0, 7, 15, 16, 19):
        si, oi = fs.multi_step_auto(c.static, c.params, None, pools[i], frames[i], 17)
        for k in ("px", "py", "qx", "qw", "age", "ring_cursor", "time_in_cycle", "rng_key"):
            assert torch.equal(getattr(state_slot(st, i), k), getattr(si, k)), (i, k)
        assert int(out.alive_count[i]) == int(oi.alive_count) > 0


@pytest.mark.cuda
def test_fleet_dead_rank_offsets_restart_per_slot(cuda):
    """The claim's count and scan over a stacked [S, N] alive plane: each
    slot's tile offsets equal a solo claim over its pool."""
    g = torch.Generator().manual_seed(5)
    alive = torch.rand((3, 70001), generator=g) < torch.tensor([[0.2], [0.5], [0.9]])
    offs = fs.tile_dead_offsets(alive.to(cuda))
    assert torch.equal(offs.cpu(), fs.tile_dead_offsets(alive))
    for i in range(3):
        assert torch.equal(offs[i], fs.tile_dead_offsets(alive[i].to(cuda)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", fleet_cfg.FLOW_SHAPES)
def test_fleet_one_shot_flow_on_the_card(cuda, shape):
    """The README's one-shot Fleet flow through `Fleet` on the card, against
    the same flow stepped by the plain version on the card and by the CPU
    Fleet: the same finished slots from `drain_finished` every frame (every
    activated slot once), the same live counts, integer leaves and keys
    exact, equal render items; f32 under `flow_rule_holds` (bit for bit
    against the card's plain replay with a box emission)."""
    before = fs.fused_step_fleet.launches
    card = fleet_cfg.one_shot_fleet_flow(cuda, shape)
    assert fs.fused_step_fleet.launches - before == 200
    assert sorted(s for fin in card["finished"] for s in fin) == sorted(card["activated"])
    for reference, run in (("plain", fleet_cfg.one_shot_fleet_flow(cuda, shape, plain=True)),
                           ("cpu", fleet_cfg.one_shot_fleet_flow("cpu", shape))):
        diff = fleet_cfg.compare_fleet_flows(card, run)
        assert fleet_cfg.flow_rule_holds(shape, reference, diff), (reference, diff)


# ---------------------------------------------------------------------------
# many colliders (the broad phase) and the lifted table caps
# ---------------------------------------------------------------------------

import torch_table_configs as table_cfg  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("scene", sorted(table_cfg.det_scenes()))
def test_broad_phase_kernel_matches_plain(cuda, scene):
    """The narrow phase skips, per warp and substep, the colliders no active
    lane can reach (at every count; the JAX package from
    LOOP_MIN_COLLIDERS): the kernel still equals the plain version (every
    collider, no skip) bit for bit, single
    and U = 2 launches, on the six-collider mix, on 33 and 64 mixed
    colliders (a quarter hulls, some disabled, lanes starting inside two)
    and on 200 read from global memory."""
    cols, disabled = table_cfg.det_scenes()[scene]
    c = pt.compile_spawner(_box_spawner(), device=cuda)
    table = table_cfg.compile_with_disabled(cols, disabled, cuda)
    assert (fs.kernel_colliders(table).numel() > L.SMEM_COLLIDER_WORDS) == (scene == "c200")
    s = pt.init_pool_for(c, 131072)
    before = fs.fused_step.broad_launches
    s = _assert_kernel_equals_plain(c, table, s, pt.make_frame_input(1 / 60), [1] * 6 + [2] * 3)
    assert fs.fused_step.broad_launches - before == 9
    assert int(s.alive.sum()) > 40000


@pytest.mark.cuda
@pytest.mark.parametrize("case", table_cfg.CAPS)
def test_lifted_caps_kernel_matches_plain(cuda, case):
    """Curves of 17 and 40 knots, 9 emitters, 9 types: the kernel equals the
    plain version bit for bit (state, render planes), and its stats row the
    plain reductions, over single and U = 8 launches."""
    c = pt.compile_spawner(table_cfg.caps_spawner(case), device=cuda)
    s = pt.init_pool_for(c, 131072)
    f = pt.make_frame_input(1 / 60)
    for u in [1] * 3 + [8] * 2:
        sk, ok, planes = fs.fused_step(c.static, c.params, None, s, f, unroll=u, pack_render=True)
        sp, _op = plain_frames(c.static, c.params, s, f, u)
        for k in active_f32_fields(c.static) + SCALARS:
            assert torch.equal(getattr(sk, k), getattr(sp, k)), (u, k)
        for a, b in zip(planes, pack_render_planes(c.static, c.params, sp)):
            assert torch.equal(a, b), u
        kw = {k: getattr(sk, k) for k in ("px", "py", "pz", "initial_scale", "age", "lifetime")}
        want = stat_reductions(c.static, c.params, kw, sk.ptype, sk.alive)
        for got, w in zip((ok.aabb_min, ok.aabb_max, ok.alive_count, ok.alive_count_per_type), want):
            assert torch.equal(got, w), u
        s = sk
    assert int((ok.alive_count_per_type > 0).sum()) == c.num_types and int(ok.alive_count) > 20000


@pytest.mark.cuda
@pytest.mark.parametrize("fleet", [False, True])
def test_nine_force_fields_kernel_matches_plain(cuda, fleet):
    """Nine force fields from the device records: a solo launch equals the
    plain version bit for bit; a fleet of 3 slots whose fields differ
    equals each slot's solo launch and plain frames."""
    c = pt.compile_spawner(_box_spawner(), device=cuda)
    if not fleet:
        f = pt.make_frame_input(1 / 60, force_fields=pt.compile_force_fields(table_cfg.nine_fields(), device=cuda))
        _assert_kernel_equals_plain(c, None, pt.init_pool_for(c, 131072), f, [1] * 3 + [8] * 2)
        return
    frames = [pt.make_frame_input(1 / 60, force_fields=pt.compile_force_fields(table_cfg.nine_fields(0.3 * i),
                                                                               device=cuda)) for i in range(3)]
    pools = [pt.init_pool_for(c, 65536, seed=i) for i in range(3)]
    st = stack_pools(pools)
    for u in (1, 8, 8):
        st, _o = fs.fused_step_fleet(c.static, c.params, None, st, stack_frames(frames), unroll=u)
        for i in range(3):
            solo, _o = fs.fused_step(c.static, c.params, None, pools[i], frames[i], unroll=u)
            plain, _o = plain_frames(c.static, c.params, pools[i], frames[i], u)
            for k in active_f32_fields(c.static) + ("ring_cursor", "alive"):
                assert torch.equal(getattr(state_slot(st, i), k), getattr(solo, k)), (u, i, k)
                assert torch.equal(getattr(solo, k), getattr(plain, k)), (u, i, k)
            pools[i] = solo


@pytest.mark.cuda
def test_scene_and_fleet_past_the_old_caps(cuda):
    """A Scene on the card with 200 colliders, nine force fields, nine
    emitters and nine types, and a Fleet against the 200 colliders, each
    equal to the plain version replaying it on the card, bit for bit."""
    scene, sid = table_cfg.lifted_scene(cuda)
    st, out = table_cfg.plain_replay(scene, sid)
    got = scene._spawners[sid].state
    for k in active_f32_fields(scene._spawners[sid].compiled.static) + SCALARS:
        assert torch.equal(getattr(got, k), getattr(st, k)), k
    assert scene.alive_count() == int(out.alive_count) > 5000
    fleet = table_cfg.lifted_fleet(cuda)
    for i in (0, 1):
        want = table_cfg.fleet_plain_replay(fleet, i)
        for k in active_f32_fields(fleet.compiled.static) + SCALARS:
            assert torch.equal(getattr(state_slot(fleet.states, i), k), getattr(want, k)), (i, k)


# ---------------------------------------------------------------------------
# the f16 render pack (kernel row 2's f16 mode) and the async reader
# ---------------------------------------------------------------------------

import torch_render_configs as render_cfg  # noqa: E402
from bevy_firework_tpu_torch.render_pipeline import AsyncRenderReader  # noqa: E402


def _stress_100k():
    """stress_test at 1e5/s (random draws, rotation elided)."""
    from bevy_firework_tpu_torch.models import effects

    sp, _tf = effects.stress_test()
    es = dataclasses.replace(sp.emission_settings[0], emission_pacing=pt.EmissionPacing.rate(1e5))
    return dataclasses.replace(sp, emission_settings=(es,))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["elided", "rotating", "stress_test"])
@pytest.mark.parametrize("unroll", [1, 8])
def test_f16_render_pack_matches_plain(cuda, case, unroll):
    """The f16 record (12 planes with rotation elided, 16 with it live)
    equals the plain version on the state the launch wrote, bit for bit,
    and the same launch's f32 pack and positions rounded; 131071 lanes (a
    ragged last tile)."""
    sp = _stress_100k() if case == "stress_test" else render_cfg.f16_spawner(case == "rotating")
    c = pt.compile_spawner(sp, device=cuda)
    s = pt.init_pool_for(c, 131071)
    f = pt.make_frame_input(1 / 50)
    before = fs.fused_step.render_f16_launches
    for _ in range(4):
        sk, _ok, p16 = fs.fused_step(c.static, c.params, None, s, f, unroll=unroll, pack_render="f16")
        s32, _o, p32 = fs.fused_step(c.static, c.params, None, s, f, unroll=unroll, pack_render=True)
        assert torch.equal(sk.px, s32.px)
        render_cfg.check_record(c.static, c.params, sk, p16, p32, case)
        s = sk
    assert fs.fused_step.render_f16_launches - before == 4
    assert 0 < int(s.alive.sum()) < 131071


@pytest.mark.cuda
def test_f16_render_pack_hybrid_and_fleet(cuda):
    """The f16 record of a hybrid frame (the merge launch) and of a fleet
    launch: each equal to the plain version on its post-step state, a fleet
    slot's record equal to its solo launch's."""
    c = pt.compile_spawner(_nested_spawner(), nested_buffer=1024, device=cuda)
    f = pt.make_frame_input(1 / 60)
    s = pt.init_pool_for(c, 65536)
    for _ in range(20):
        s, _o = fs.fused_step(c.static, c.params, None, s, f)
    sk, _o, p16 = fs.fused_step(c.static, c.params, None, s, f, pack_render="f16")
    _s, _o, p32 = fs.fused_step(c.static, c.params, None, s, f, pack_render=True)
    render_cfg.check_record(c.static, c.params, sk, p16, p32, "hybrid")
    c = pt.compile_spawner(render_cfg.f16_spawner(True), device=cuda)
    frames = [pt.make_frame_input(1 / 50, translation=(float(i), 0.0, 0.0)) for i in range(3)]
    pools = [pt.init_pool_for(c, 40000, seed=i) for i in range(3)]
    st = stack_pools(pools)
    for u in (8, 1):
        st2, _o, fp16 = fs.fused_step_fleet(c.static, c.params, None, st, stack_frames(frames), unroll=u,
                                            pack_render="f16")
        for i in range(3):
            solo, _o, sp16 = fs.fused_step(c.static, c.params, None, pools[i], frames[i], unroll=u, pack_render="f16")
            assert all(torch.equal(a[i].view(torch.int16), b.view(torch.int16)) for a, b in zip(fp16, sp16))
            render_cfg.check_record(c.static, c.params, solo, sp16, label=f"fleet slot {i}")
            pools[i] = solo
        st = st2


@pytest.mark.cuda
@pytest.mark.parametrize("record", [True, "f16"])
def test_render_loop_draws_the_plain_pack(cuda, record):
    """examples/render_loop.py's loop on the card (stress_test at 30000/s,
    capacity 65536): every drawn frame's rows == the plain pack of its
    post-step state, frame ids strictly increasing, copies on the reader's
    copy stream."""
    from bevy_firework_tpu_torch.models import effects

    sp, _tf = effects.stress_test()
    es = dataclasses.replace(sp.emission_settings[0], emission_pacing=pt.EmissionPacing.rate(30_000.0))
    c = pt.compile_spawner(dataclasses.replace(sp, emission_settings=(es,)), device=cuda)
    res = render_cfg.render_loop(c, pt.make_frame_input(1 / 60), 65536, 120, record, check=True)
    assert res["checked"] == len(res["drawn"]) > 5 and res["drawn"] == sorted(set(res["drawn"]))
    assert len(res["copy_ms"]) == res["published"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense", "compact"])
def test_async_reader_submit_on_the_card(cuda, mode):
    """reader.submit on card pools of three types (the dense or compacting
    pack on the card, copies on the copy stream): the published rows of
    each type == pack_instances of the state."""
    c = pt.compile_spawner(_three_type_spawner(), device=cuda)
    s = pt.init_pool_for(c, 50000)
    f = pt.make_frame_input(1 / 60)
    reader = AsyncRenderReader(50000, c.num_types, mode=mode)
    try:
        for fid in range(1, 31):
            s, _o = fs.fused_step(c.static, c.params, None, s, f)
            reader.submit(c.params, s, fid)
        torch.cuda.synchronize()
        for t in range(c.num_types):
            buf, count = pt.pack_instances(c.params, s, t)
            want = buf[: int(count)].cpu().numpy()
            deadline = time.time() + 20
            while True:
                got = reader.acquire(t)
                if got is not None and got[1] == 30:
                    break
                if got is not None:
                    reader.release(t)
                assert time.time() < deadline, f"type {t}: frame 30 never arrived"
                time.sleep(0.01)
            assert int(count) > 0 and np.array_equal(got[0], want), t
            reader.release(t)
    finally:
        reader.close()


# ---------------------------------------------------------------------------
# sharded claims (kernel row 11): a pool split over the particle axis
# ---------------------------------------------------------------------------

import torch_shard_configs as shard_cfg  # noqa: E402
from bevy_firework_tpu_torch.step import NESTED_SHARD_MESSAGE  # noqa: E402

# kernel against plain, per config: the unsharded launch's own rule (libm
# sinf/cosf: the live rotation 2 ulp, stress_test's draws 4 ulp)
SHARD_ULPS = {"det": 2, "stress": 4, "destroy": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [2, 5])
@pytest.mark.parametrize("name,unroll", [("det", 1), ("det", 8), ("stress", 8), ("destroy", 1)])
def test_sharded_kernel_equals_unsharded(cuda, name, unroll, n_shards):
    """The stitched shards of 12 launches (lane base, global capacity and
    dead offset as launch arguments) == the unsharded launches bit for bit,
    every leaf, random draws included; the shards' stats reduced == the
    pool's; each shard == the plain version with the same shard arguments
    within the unsharded kernel's own rule. 70001 lanes: ragged shards; the
    ring starts 300 lanes before its end, so its claims wrap."""
    c, table, frame = shard_cfg.config(name, cuda, rate=3e4 if name == "stress" else None)
    whole = pt.init_pool_for(c, 70001)
    whole = dataclasses.replace(whole, ring_cursor=torch.tensor(70001 - 300, dtype=torch.int32, device=cuda))
    shards = shard_cfg.split(whole, n_shards)
    before = fs.fused_step.shard_launches
    for i in range(12):
        args = shard_cfg.shard_args(c.static, shards)
        plain = [plain_frames(c.static, c.params, s, frame, unroll, colliders=table, shard=a)[0]
                 for s, a in zip(shards, args)]
        whole, out = fs.fused_step(c.static, c.params, table, whole, frame, unroll=unroll)
        shards, outs, _p = shard_cfg.step_shards(c, table, shards, frame, unroll=unroll)
        assert shard_cfg.pool_mismatch(shard_cfg.stitch(shards), whole) == [], i
        assert shard_cfg.outputs_mismatch(out, shard_cfg.reduce_outputs(outs)) == [], i
        for s, p in zip(shards, plain):
            for k in SCALARS:
                assert torch.equal(getattr(s, k), getattr(p, k)), (i, k)
            for k in active_f32_fields(c.static):
                assert _ulps(getattr(s, k), getattr(p, k)) <= SHARD_ULPS[name], (i, k)
    assert fs.fused_step.shard_launches - before == 12 * n_shards
    assert 0 < int(out.alive_count) < whole.capacity


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_dead_rank_chain_with_device_offsets(cuda, n_shards):
    """Kernel row 11 on the dead-rank claim: 20 destroy frames of 131072
    lanes in S shards, each frame's dead offsets device tensors (the
    exclusive cumsum of the shards' carried dead totals, `shard_args`) and
    its launches run under torch.cuda.set_sync_debug_mode("error"): no
    value reaches the host; stitched == the unsharded launches bit for bit,
    the stats reduced == the pool's."""
    c, table, frame = shard_cfg.config("destroy", cuda)
    whole = pt.init_pool_for(c, 131072)
    shards = shard_cfg.split(whole, n_shards)
    fs.fused_step(c.static, c.params, table, whole, frame)  # the tables reach the card before the checked frames
    for i in range(20):
        whole, out = fs.fused_step(c.static, c.params, table, whole, frame)
        torch.cuda.set_sync_debug_mode("error")
        try:
            shards, outs, _p = shard_cfg.step_shards(c, table, shards, frame)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert shard_cfg.pool_mismatch(shard_cfg.stitch(shards), whole) == [], i
        assert shard_cfg.outputs_mismatch(out, shard_cfg.reduce_outputs(outs)) == [], i
    assert 0 < int((~whole.alive).sum()) < whole.capacity


@pytest.mark.cuda
def test_sharded_kernel_refuses_what_does_not_shard(cuda):
    """A nested archetype raises the CPU's NotImplementedError on the card;
    a shard past the global pool raises before any launch."""
    from bevy_firework_tpu_torch.models import effects

    c = pt.compile_spawner(effects.fireworks()[0], device=cuda)
    s = pt.init_pool_for(c, 1024)
    with pytest.raises(NotImplementedError) as e:
        fs.fused_step(c.static, c.params, None, s, pt.make_frame_input(1 / 60), shard=(0, 2048, 0))
    assert str(e.value) == NESTED_SHARD_MESSAGE
    c, _t, f = shard_cfg.config("det", cuda)
    with pytest.raises(ValueError):
        fs.fused_step(c.static, c.params, None, pt.init_pool_for(c, 100), f, shard=(50, 120, 0))


# ---------------------------------------------------------------------------
# kernel row 6's stats block (atomic commit into per-stream scratch) and
# kernel row 3's two narrow-phase forms
# ---------------------------------------------------------------------------

import torch_stats_configs as stats_cfg  # noqa: E402

STATS_KEYS = ("px", "py", "pz", "initial_scale", "age", "lifetime")


def _stats_want(c, s):
    """The plain reductions over a state: aabb_min, aabb_max, alive count,
    per-type counts."""
    return dict(zip(("aabb_min", "aabb_max", "alive_count", "alive_count_per_type"), stat_reductions(
        c.static, c.params, {k: getattr(s, k) for k in STATS_KEYS}, s.ptype, s.alive)))


def _stats_case(case, device):
    """(compiled, pool, frames, launches) of a stats case: one tile, a ragged
    tile count with three types, 1310720 lanes, nine types, or a 3-slot
    fleet (stacked pools and frames)."""
    f = pt.make_frame_input(1 / 60)
    if case == "one_tile":
        c = pt.compile_spawner(_box_spawner(rate=2e3), device=device)
        return c, pt.init_pool_for(c, 256), f
    if case == "ragged_three_types":
        c = pt.compile_spawner(_three_type_spawner(), device=device)
        return c, pt.init_pool_for(c, 100003), f
    if case == "lanes_1310720":
        c = pt.compile_spawner(_box_spawner(rate=3e6), device=device)
        return c, pt.init_pool_for(c, 1310720), f
    if case == "nine_types":
        c = pt.compile_spawner(table_cfg.caps_spawner("types9"), device=device)
        return c, pt.init_pool_for(c, 131072), f
    from bevy_firework_tpu_torch.parallel.sharding import stack_frames, stack_pools

    c = pt.compile_spawner(_three_type_spawner(), device=device)
    pools = [pt.init_pool_for(c, 65536, seed=i) for i in range(3)]
    frames = [pt.make_frame_input(1 / 60, translation=(float(i), 0.0, 0.0)) for i in range(3)]
    return c, stack_pools(pools), stack_frames(frames)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_tile", "ragged_three_types", "lanes_1310720", "nine_types", "fleet3"])
def test_stats_row_matches_plain_reductions(cuda, case):
    """The stats row (every block commits its row by atomics into the
    stream's scratch; the last block decodes it and zeroes the scratch)
    equals the plain reductions over the state the same launch wrote, for
    every slot of a fleet, over launches in a row (each starts from the
    scratch the last one left), U = 1 and U = 8."""
    from bevy_firework_tpu_torch.parallel.sharding import state_slot

    c, s, f = _stats_case(case, cuda)
    fleet = case == "fleet3"
    for u in [1] * 4 + [8, 1]:
        if fleet:
            s, ok = fs.fused_step_fleet(c.static, c.params, None, s, f, unroll=u)
            rows = [(state_slot(s, i), {k: getattr(ok, k)[i] for k in (
                "aabb_min", "aabb_max", "alive_count", "alive_count_per_type")}) for i in range(3)]
        else:
            s, ok = fs.fused_step(c.static, c.params, None, s, f, unroll=u)
            rows = [(s, {k: getattr(ok, k) for k in ("aabb_min", "aabb_max", "alive_count", "alive_count_per_type")})]
        for si, got in rows:
            for k, v in _stats_want(c, si).items():
                assert torch.equal(got[k], v), (u, k)
    assert all(int(got["alive_count"]) > 0 for _s, got in rows)
    assert int((ok.alive_count_per_type > 0).sum()) == (3 * c.num_types if fleet else c.num_types)


@pytest.mark.cuda
def test_stats_scratch_is_left_zero_between_launches(cuda):
    """Two stats launches in a row on one stream from the same state give the
    same row, and each leaves the stream's accumulator and ticket at 0."""
    c = pt.compile_spawner(_three_type_spawner(), device=cuda)
    s, _o = fs.multi_step_auto(c.static, c.params, None, pt.init_pool_for(c, 100003), pt.make_frame_input(1 / 60), 20)
    f = pt.make_frame_input(1 / 60)
    words = L.stats_words(c.num_types) + 1
    stream = torch.cuda.current_stream(cuda).cuda_stream
    rows = []
    for _ in range(2):
        _s, ok = fs.fused_step(c.static, c.params, None, s, f)
        torch.cuda.synchronize()
        assert not fs.stats_scratch(cuda, stream, words).any()
        rows.append((ok.aabb_min, ok.aabb_max, ok.alive_count, ok.alive_count_per_type))
    for a, b in zip(*rows):
        assert torch.equal(a, b)
    assert int(rows[0][2]) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("case", stats_cfg.EDGE_CASES)
def test_stats_row_at_float_edges(cuda, case):
    """A lane with a NaN position makes its axis's bounds NaN, as in the
    plain reductions; lanes at -0 and +0 and at +-inf reduce to the plain
    reductions' values (by value: -0 == +0)."""
    c, s, f = stats_cfg.edge_pool(case, cuda)
    sk, ok = fs.fused_step(c.static, c.params, None, s, f)
    _sp, op = plain_frames(c.static, c.params, s, f, 1)
    for k, v in _stats_want(c, sk).items():
        assert stats_cfg.rows_equal(getattr(ok, k), v), k
        assert stats_cfg.rows_equal(getattr(ok, k), getattr(op, k)), k
    assert int(ok.alive_count) == 1500
    if case == "nan":
        assert bool(torch.isnan(ok.aabb_min[0])) and bool(torch.isnan(ok.aabb_max[0]))
    else:
        assert float(ok.aabb_max[1]) == math.inf and float(ok.aabb_min[2]) == -math.inf
        assert float(ok.aabb_min[0]) == 0.0 == float(ok.aabb_max[0])


def _eight_colliders():
    """Every collider kind (SCENES["c7"]) and a second cuboid: C = 1..8 take the first C."""
    return SCENES["c7"]() + [pt.Collider.cuboid((0.3, 0.3, 0.3), position=(0.0, 1.4, 0.0))]


@pytest.mark.cuda
@pytest.mark.parametrize("n_colliders", range(1, 9))
def test_narrow_phase_matches_plain_at_every_count(cuda, n_colliders):
    """The narrow phase (its per-warp broad phase at every collider count;
    the JAX package unrolls its tests below LOOP_MIN_COLLIDERS) equals the
    plain version bit for bit at C = 1-8 colliders of all seven kinds,
    single and U = 2 launches; the launches count by the reference's form."""
    c = pt.compile_spawner(_box_spawner(), device=cuda)
    table = pt.compile_colliders(_eight_colliders()[:n_colliders], device=cuda)
    s = pt.init_pool_for(c, 131072)
    before = (fs.fused_step.collide_launches, fs.fused_step.broad_launches)
    s = _assert_kernel_equals_plain(c, table, s, pt.make_frame_input(1 / 60), [1] * 6 + [2] * 3)
    looped = n_colliders >= LOOP_MIN_COLLIDERS
    assert (fs.fused_step.collide_launches - before[0], fs.fused_step.broad_launches - before[1]) == (9, 9 * looped)
    assert int(s.alive.sum()) > 40000


def test_stats_scratch_is_kept_per_device_and_stream():
    """The stats block's scratch: one zeroed buffer per (device, stream),
    the same storage for later launches on that stream, another for another
    stream, and a larger zeroed one when a launch needs more words."""
    cpu = torch.device("cpu")
    a = fs.stats_scratch(cpu, 11, 10)
    assert a.shape == (10,) and a.dtype == torch.int32 and not a.any()
    assert fs.stats_scratch(cpu, 11, 8).data_ptr() == a.data_ptr()
    assert fs.stats_scratch("cpu", 11, 10).data_ptr() == a.data_ptr()
    b = fs.stats_scratch(cpu, 12, 10)
    assert b.data_ptr() != a.data_ptr()
    a[3] = 5  # a launch left words set: the cache hands out what it holds
    assert int(fs.stats_scratch(cpu, 11, 10)[3]) == 5
    grown = fs.stats_scratch(cpu, 11, 40)
    assert grown.shape == (40,) and not grown.any() and grown.data_ptr() != a.data_ptr()
    assert fs.stats_scratch(cpu, 11, 10).data_ptr() == grown.data_ptr()


def test_launch_counters_split_by_the_reference_form():
    """The card's narrow phase has one form; its launches count as the JAX
    package's looped form (`looped_form`) from LOOP_MIN_COLLIDERS colliders,
    and none without colliders or colliding types."""
    c = pt.compile_spawner(_box_spawner(), device="cpu")
    tables = {n: pt.compile_colliders(_eight_colliders()[:n], device="cpu") for n in range(1, 9)}
    assert [fs.looped_form(c.static, t) for t in tables.values()] == [n >= LOOP_MIN_COLLIDERS for n in tables]
    assert not fs.looped_form(c.static, None)
    free = pt.compile_spawner(_det_spawner(), device="cpu")
    assert not fs.looped_form(free.static, tables[8])


# ---- kernel rows 1 and 2 on the card: the warp's cadence (U > 1, up to 32
# emitters) and lane 0's, tiles past three waves, unaligned slot and shard
# bases, partial tiles, every pack mode, a large table ----

def _check_launches(c, s, f, unrolls, pack):
    """Each launch (with the render pack `pack`) against as many plain frames
    from the same state and the plain pack of the state it wrote: every
    pool leaf and plane bit for bit. Returns the last state."""
    for u in unrolls:
        res = fs.fused_step(c.static, c.params, None, s, f, unroll=u, pack_render=pack)
        sp, _op = plain_frames(c.static, c.params, s, f, u)
        for k in active_f32_fields(c.static) + SCALARS:
            assert torch.equal(getattr(res[0], k), getattr(sp, k)), (u, k)
        if pack == "f16":
            render_cfg.check_record(c.static, c.params, res[0], res[2], None, f"U={u}")
        elif pack:
            for a, b in zip(res[2], pack_render_planes(c.static, c.params, sp)):
                assert torch.equal(a, b), u
        s = res[0]
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("n", [131072 - 77, 1310720])
def test_partial_and_many_tiles_match_plain(cuda, n):
    """A pool whose last tile is partial and a pool of 5120 tiles, ~10 per
    block of one resident wave (more than three waves' tiles), at U = 1
    and 8, bit for bit against the plain frames."""
    c = pt.compile_spawner(_box_spawner(rate=n * 0.4), device=cuda)
    s = pt.init_pool_for(c, n, seed=3)
    f = pt.make_frame_input(1 / 60)
    s = _check_launches(c, s, f, [1] * 3 + [8] * 2, False)
    assert 0 < int(s.alive.sum()) < n


@pytest.mark.cuda
@pytest.mark.parametrize("unroll", [1, 8])
@pytest.mark.parametrize("pack", [False, True, "f16"])
def test_pack_modes_of_two_curved_types_match_plain(cuda, pack, unroll):
    """Every render-pack mode at U = 1 and 8 on a two-type pool whose
    types' curves are all uneven and whose last tile is partial: bit for
    bit against the plain frames and the plain pack."""
    c = pt.compile_spawner(table_cfg.two_type_curves_spawner(rate=2e5), device=cuda)
    s = pt.init_pool_for(c, 200003, seed=5)
    f = pt.make_frame_input(1 / 60)
    s = _check_launches(c, s, f, [unroll] * 4, pack)
    assert int(s.alive.sum()) > 10000 and bool((s.ptype[s.alive] == 1).any())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [131073, 65538])
def test_fleet_slots_at_unaligned_bases(cuda, n):
    """A fleet whose lanes per slot are not a multiple of 4: slot bases at
    slot * n are not 16-byte aligned; every slot == its solo launch == the
    plain frames, bit for bit (rotation within 2 ulp)."""
    for case in ("ring", "three_types_stats", "render_u8"):
        res = fleet_cfg.check_fleet_equals_solo(case, cuda, n, plain=True)
        assert min(res["live"]) > 1000, (case, res)


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [3, 4])
def test_sharded_pool_of_many_tiles(cuda, n_shards):
    """A pool of 1310720 lanes split into shards (4: views at 16-byte
    aligned bases; 3: unaligned views and ragged last tiles), stepped at
    U = 8: the stitched shards == the unsharded launches bit for bit, and
    each shard == the plain frames with its shard arguments."""
    c = pt.compile_spawner(_box_spawner(rate=5e5), device=cuda)
    whole = pt.init_pool_for(c, 1310720, seed=9)
    f = pt.make_frame_input(1 / 60)
    shards = shard_cfg.split(whole, n_shards)
    for i in range(4):
        args = shard_cfg.shard_args(c.static, shards)
        plain = [plain_frames(c.static, c.params, s, f, 8, shard=a)[0] for s, a in zip(shards, args)]
        whole, out = fs.fused_step(c.static, c.params, None, whole, f, unroll=8)
        shards, outs, _p = shard_cfg.step_shards(c, None, shards, f, unroll=8)
        assert shard_cfg.pool_mismatch(shard_cfg.stitch(shards), whole) == [], i
        for s, p in zip(shards, plain):
            for k in active_f32_fields(c.static) + SCALARS:
                assert torch.equal(getattr(s, k), getattr(p, k)), (i, k)
    assert int(out.alive_count) > 100000


@pytest.mark.cuda
@pytest.mark.parametrize("n_emitters", [7, 34])
def test_cadence_of_mixed_pacings_matches_plain(cuda, n_emitters):
    """Rate, one-shot, on-demand (two or more: the first gated one takes
    the queue) and offset count-over-duration emitters, the last one
    disabled at the U = 2 launches: 7 run on the warp's lanes at U > 1
    (votes and a scan), 34 in lane 0; U = 1, 2 and 8 launches with a queue
    == the plain frames bit for bit, the cadence scalars included."""
    c = pt.compile_spawner(table_cfg.mixed_pacing_spawner(n_emitters), device=cuda)
    s = pt.init_pool_for(c, 131072, seed=2)
    enabled = s.enabled.clone()
    enabled[n_emitters - 1] = False
    f = pt.make_frame_input(1 / 60)
    for u in (2, 1, 8, 8, 1, 2):
        s = dataclasses.replace(s, manual_queued=torch.tensor(300 + 7 * u, dtype=torch.int32, device=cuda),
                                enabled=enabled if u == 2 else s.enabled)
        sk, _ok = fs.fused_step(c.static, c.params, None, s, f, unroll=u)
        sp, _op = plain_frames(c.static, c.params, s, f, u)
        for k in active_f32_fields(c.static) + SCALARS:
            assert torch.equal(getattr(sk, k), getattr(sp, k)), (u, k)
        assert int(sk.manual_queued) == 0, u
        s = sk
    assert int(s.alive.sum()) > 5000


@pytest.mark.cuda
def test_table_of_nine_40_knot_types(cuda):
    """A 4948-word spawner table (9 types of 40-knot curves): U = 1 and 8
    launches with the f32 pack and the stats row == the plain version bit
    for bit."""
    c = pt.compile_spawner(table_cfg.caps_spawner("types9_knots40"), device=cuda)
    assert fs.pack_tables(c.static, c.params).size == 4948
    s = pt.init_pool_for(c, 131072 + 5)
    f = pt.make_frame_input(1 / 60)
    for u in [1] * 3 + [8] * 2:
        sk, ok, planes = fs.fused_step(c.static, c.params, None, s, f, unroll=u, pack_render=True)
        sp, _op = plain_frames(c.static, c.params, s, f, u)
        for k in active_f32_fields(c.static) + SCALARS:
            assert torch.equal(getattr(sk, k), getattr(sp, k)), (u, k)
        for a, b in zip(planes, pack_render_planes(c.static, c.params, sp)):
            assert torch.equal(a, b), u
        kw = {k: getattr(sk, k) for k in ("px", "py", "pz", "initial_scale", "age", "lifetime")}
        want = stat_reductions(c.static, c.params, kw, sk.ptype, sk.alive)
        for got, w in zip((ok.aabb_min, ok.aabb_max, ok.alive_count, ok.alive_count_per_type), want):
            assert torch.equal(got, w), u
        s = sk
    assert int((ok.alive_count_per_type > 0).sum()) == c.num_types
