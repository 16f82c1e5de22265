"""The port's force fields (authoring, `field_accel`, the step's field block,
the destroyed mask) against the JAX package, on the CPU.

Inputs are made from numpy seeds and go through both packages; the port runs
its plain versions here (the CUDA kernel's field block and dump plane have
their own tests in test_torch_kernel.py). Tolerances: XLA on the CPU
contracts multiply-adds into FMAs, the port rounds every operation, so
field accelerations agree within 1e-5 of their magnitude (1e-6 absolute
for the point, vortex and axial kinds) and trajectories within 1e-4 (the
JAX package's own field tolerance, tests/test_force_fields.py); counts,
claims, alive and destroyed masks are exact. Lanes on a field's singular
locus get exactly 0 from it in both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from bevy_firework_tpu import force_fields as jff
from bevy_firework_tpu.ops import fused_step as jfs
from bevy_firework_tpu.step import step_jit
from bevy_firework_tpu_torch import force_fields as pff
from bevy_firework_tpu_torch import interop
from bevy_firework_tpu_torch.ops import fused_step as pfs
from bevy_firework_tpu_torch.ops import table_layout as L
from bevy_firework_tpu_torch.settings import ParticleCollisionSettings as PortCollisionSettings
from bevy_firework_tpu_torch.settings import ParticleEventHandlers as PortEventHandlers
from bevy_firework_tpu_torch.step import plain_step
from test_torch_common import (  # noqa: F401
    _one_torch_thread,
    assert_pools_match,
    det_spawner,
    jax_pool_numpy,
    port_pool_numpy,
)

N = 8192
DT = 1 / 60


def _fields(pkg):
    """One field of each kind, off-axis, with overlapping falloffs."""
    F = pkg.ForceField
    return [F.point((0.3, 0.8, -0.2), 6.0, 2.5), F.vortex((0.1, 0.0, 0.2), (0.3, 0.9, 0.1), 5.0, 3.0),
            F.axial((-0.2, 0.0, 0.1), (0.0, 1.0, 0.0), 8.0, 2.0),
            F.turbulence((0.0, 0.5, 0.0), 4.0, 6.0, frequency=1.7, phase=0.3)]


def _tables(make, active=None):
    """The same field set compiled by both packages (the JAX table with the
    given active flags)."""
    jt = jx.compile_force_fields(make(jx))
    if active is not None:
        jt = dataclasses.replace(jt, active=np.asarray(active, np.float32))
    return jt, interop.fields_from_numpy({k: np.asarray(getattr(jt, k)) for k in pff.TABLE_SHAPES}, jt.kinds,
                                         device="cpu")


def _jax_accel(jt, p):
    a = jff.field_accel(jt.kinds, jnp.asarray(jt.position), jnp.asarray(jt.axis), jnp.asarray(jt.params),
                        jnp.asarray(jt.active).reshape(-1, 1), p[:, 0], p[:, 1], p[:, 2])
    return np.stack([np.asarray(x) for x in a], 1)


def _port_accel(table, p):
    t = torch.from_numpy(np.ascontiguousarray(p))
    return torch.stack(pff.field_accel(table, t[:, 0], t[:, 1], t[:, 2]), 1).numpy()


@pytest.mark.parametrize("kind", ["point", "vortex", "axial", "turbulence", "all", "toggled"])
def test_field_accel_matches_jax(kind):
    """4096 random positions around the fields (numpy seed): each kind
    alone, all four together, and all four with two toggled off. Point,
    vortex and axial within 1e-6 absolute, turbulence within 1e-5 of the
    field's scale (its cos arguments reach ~30, where XLA's and PyTorch's
    cos and the contracted products part by a few ulp)."""
    rng = np.random.default_rng(3)
    p = rng.normal(scale=1.5, size=(4096, 3)).astype(np.float32)
    names = ["point", "vortex", "axial", "turbulence"]
    pick = list(range(4)) if kind in ("all", "toggled") else [names.index(kind)]
    active = [1.0, 0.0, 1.0, 0.0] if kind == "toggled" else None
    jt, table = _tables(lambda pkg: [_fields(pkg)[i] for i in pick], active)
    want, got = _jax_accel(jt, p), _port_accel(table, p)
    atol = 1e-6 if kind in ("point", "vortex", "axial", "toggled") else 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-6)
    assert np.abs(want).max() > 0.5  # the fields act on these lanes


def _tornado(pkg, x=0.0, z=0.0):
    """examples/force_fields.py's funnel (chip_smoke.py's fields_1M cell)."""
    F = pkg.ForceField
    return [F.vortex((x, 0.0, z), (0.0, 1.0, 0.0), strength=12.0, radius=6.0),
            F.axial((x, 0.0, z), (0.0, 1.0, 0.0), strength=25.0, radius=7.0),
            F.turbulence((0.0, 2.0, 0.0), strength=1.8, radius=8.0, frequency=2.2)]


@pytest.mark.parametrize("centre", [(0.0, 0.0), (0.8, -0.55)])
def test_field_accel_matches_jax_on_the_tornado(centre):
    """The tornado's three fields (centred, and moved as examples/
    force_fields.py moves them) on 8192 positions where its dust lives, a
    cylinder about the axis reaching past the fields' radii (numpy seed):
    the port's plain field_accel against the JAX package's, within 1e-5 of
    the acceleration's scale (the turbulence's cos arguments and XLA's
    contracted products part by a few ulp)."""
    rng = np.random.default_rng(11)
    r, a = rng.uniform(0.0, 9.0, 8192), rng.uniform(0.0, 2.0 * np.pi, 8192)
    p = np.stack([r * np.cos(a), rng.uniform(-1.0, 11.0, 8192), r * np.sin(a)], 1).astype(np.float32)
    jt, table = _tables(lambda pkg: _tornado(pkg, *centre))
    want, got = _jax_accel(jt, p), _port_accel(table, p)
    np.testing.assert_allclose(got, want, atol=1e-5 * float(np.abs(want).max()), rtol=1e-6)
    assert np.abs(want).max() > 5.0 and (np.abs(want).sum(1) == 0).any()  # inside and past the radii


def test_packed_lane_invariants_are_the_plain_f32_values():
    """pack_fields' FF_STRENGTH and FF_INV_RADIUS words hold the f32 bits of
    strength * active and of 1 / radius, the values field_accel computes for
    every lane (the kernel reads them in place of computing them), for
    live and disabled fields of every kind and radii that do not divide
    evenly."""
    fields = _fields(pt) + _tornado(pt, 0.3, -0.1)
    table = pt.compile_force_fields(fields, device="cpu", active=[True, False, True, True, True, False, True])
    fl = pfs.pack_fields(table).view(np.float32).reshape(len(fields), L.FF_STRIDE)
    params, active = table.rows["params"], table.rows["active"]
    want_s = np.float32([params[i, 0] * active[i] for i in range(len(fields))])
    want_inv = np.float32([np.float32(1) / np.float32(params[i, 1]) for i in range(len(fields))])
    np.testing.assert_array_equal(fl[:, L.FF_STRENGTH].view(np.int32), want_s.view(np.int32))
    np.testing.assert_array_equal(fl[:, L.FF_INV_RADIUS].view(np.int32), want_inv.view(np.int32))
    # the plain version's own products and quotients, as tensors
    got_s = (table.params[:, 0] * table.active).numpy()
    got_inv = torch.stack([1.0 / table.params[i, 1] for i in range(len(fields))]).numpy()
    np.testing.assert_array_equal(got_s.view(np.int32), want_s.view(np.int32))
    np.testing.assert_array_equal(got_inv.view(np.int32), want_inv.view(np.int32))
    assert (want_s == 0).sum() == 2 and len(set(want_inv.tolist())) == len(set(params[:, 1].tolist()))


def test_singular_locus_gives_zero():
    """Lanes at a point field's centre and on a vortex's or an axial field's
    axis get exactly 0 from that field in both packages, with no NaN."""
    c = np.float32([0.25, -0.5, 1.0])
    p = np.stack([c, c + np.float32([0.0, 3.0, 0.0]), c + np.float32([0.0, -7.5, 0.0])]).astype(np.float32)
    for make in (lambda pkg: [pkg.ForceField.point(tuple(c), 5.0, 9.0)],
                 lambda pkg: [pkg.ForceField.vortex(tuple(c), (0.0, 1.0, 0.0), 5.0, 9.0)],
                 lambda pkg: [pkg.ForceField.axial(tuple(c), (0.0, 1.0, 0.0), 5.0, 9.0)]):
        jt, table = _tables(make)
        want, got = _jax_accel(jt, p), _port_accel(table, p)
        if jt.kinds[0] == jff.FIELD_POINT:
            want, got = want[:1], got[:1]  # only the centre itself is singular for a point
        np.testing.assert_array_equal(want, 0.0)
        np.testing.assert_array_equal(got, 0.0)


def test_tables_and_packing():
    """compile_force_fields gives the JAX package's rows; the kernel's field
    records hold each field at its named slots; a table of 12 fields steps
    like any other, and a table on another device than the pool raises."""
    jt = jx.compile_force_fields(_fields(jx))
    table = pt.compile_force_fields(_fields(pt), device="cpu", active=[True, False, True, True])
    assert table.kinds == jt.kinds and table.count == 4 and table.device == torch.device("cpu")
    for k in ("position", "axis", "params"):
        np.testing.assert_array_equal(getattr(table, k).numpy(), np.asarray(getattr(jt, k)), err_msg=k)
    np.testing.assert_array_equal(table.active.numpy(), [1, 0, 1, 1])
    w = pfs.pack_fields(table)
    fl = w.view(np.float32)
    at = 3 * L.FF_STRIDE
    assert w[at + L.FF_KIND] == pff.FIELD_TURBULENCE and fl[L.FF_STRIDE + L.FF_ACTIVE] == 0.0
    np.testing.assert_array_equal(fl[at + L.FF_PARAMS:at + L.FF_PARAMS + 4], np.asarray(jt.params)[3])
    np.testing.assert_array_equal(fl[at + L.FF_AXIS:at + L.FF_AXIS + 3], np.asarray(jt.axis)[3])
    assert w.size == 4 * L.FF_STRIDE
    c = pt.compile_spawner(pt.ParticleSpawner(), device="cpu")
    assert pfs.pack_tables(c.static, c.params).view(np.float32)[L.TY_AT + L.TY_FIELD_MASK] == 1.0
    twelve = pt.compile_force_fields(_fields(pt) * 3, device="cpu")
    assert pfs.pack_fields(twelve).size == 12 * L.FF_STRIDE
    s, out = pt.step_auto(c.static, c.params, None, pt.init_pool_for(c, 64),
                          pt.make_frame_input(DT, force_fields=twelve))
    assert int(out.alive_count) >= 0 and bool(torch.isfinite(s.vx).all())
    meta = pt.compile_force_fields(_fields(pt), device="meta")
    with pytest.raises(ValueError, match="force fields on meta"):
        pt.step_auto(c.static, c.params, None, pt.init_pool_for(c, 64), pt.make_frame_input(DT, force_fields=meta))


# ---------------------------------------------------------------- physics


def _drifting(pkg, n=64, lifetime=10.0, shape=None, vel=(0.0, 0.0, 0.0)):
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(lifetime=pkg.RandF32.constant(lifetime),
                                                initial_scale=pkg.RandF32.constant(0.1),
                                                acceleration=(0.0, 0.0, 0.0), linear_drag=0.0)],
        emission_settings=[pkg.EmissionSettings(emission_pacing=pkg.EmissionPacing.one_shot(n),
                                                emission_shape=shape or pkg.EmissionShape.sphere(1.5),
                                                initial_velocity=pkg.RandVec3.constant(vel))],
    )


def _run(scene, sid, n_frames):
    for _ in range(n_frames):
        scene.step(DT)
    st = scene._spawners[sid].state
    alive = st.alive.numpy()
    p = torch.stack([st.px, st.py, st.pz], 1).numpy()[alive]
    v = torch.stack([st.vx, st.vy, st.vz], 1).numpy()[alive]
    return p, v


def test_point_attractor_binds_and_repulsor_expels():
    """tests/test_force_fields.py's check through the port's Scene."""
    scene = pt.Scene(force_fields=[pt.ForceField.point((0.0, 0.0, 0.0), 6.0, 20.0)], device="cpu")
    sid = scene.add_spawner(_drifting(pt), capacity=256)
    p, v = _run(scene, sid, 90)
    assert p.shape[0] == 64 and np.linalg.norm(p, axis=1).max() < 3.0
    scene2 = pt.Scene(force_fields=[pt.ForceField.point((0.0, 0.0, 0.0), -6.0, 20.0)], device="cpu")
    sid2 = scene2.add_spawner(_drifting(pt), capacity=256)
    p2, v2 = _run(scene2, sid2, 90)
    assert ((p2 * v2).sum(1) / np.linalg.norm(p2, axis=1) > 0).all()  # everything moving outward
    assert np.linalg.norm(p2, axis=1).min() > np.linalg.norm(p, axis=1).min()


def test_vortex_swirls_with_consistent_handedness():
    """Positive strength gives positive angular momentum about +Y; beyond
    its radius a vortex leaves lanes untouched."""
    scene = pt.Scene(force_fields=[pt.ForceField.vortex((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 5.0, 30.0)],
                     device="cpu")
    sid = scene.add_spawner(_drifting(pt), capacity=256)
    p, v = _run(scene, sid, 60)
    ly = p[:, 2] * v[:, 0] - p[:, 0] * v[:, 2]
    swirling = np.sqrt(p[:, 0] ** 2 + p[:, 2] ** 2) > 0.2
    assert swirling.sum() > 40 and (ly[swirling] > 0).all()
    scene3 = pt.Scene(force_fields=[pt.ForceField.vortex((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 5.0, 2.0)],
                      device="cpu")
    sid3 = scene3.add_spawner(_drifting(pt, shape=pt.EmissionShape.point()), capacity=256)
    scene3.set_transform(sid3, pt.Transform(translation=(100.0, 0.0, 0.0)))
    _p3, v3 = _run(scene3, sid3, 30)
    np.testing.assert_allclose(v3, 0.0, atol=1e-6)


def test_turbulence_divergence_free_and_animates():
    """The curl noise is numerically divergence-free (central differences),
    falls to 0 past its radius, and its phase changes the pattern."""
    def acc(table, p):
        return _port_accel(table, p.astype(np.float32)).astype(np.float64)

    t = pt.compile_force_fields([pt.ForceField.turbulence((0.0, 0.0, 0.0), 2.0, 1000.0, frequency=0.7)],
                                device="cpu")
    pts = (np.random.default_rng(0).normal(size=(64, 3)) * 3).astype(np.float32)
    eps = 1e-3
    div = np.zeros(64)
    for axi in range(3):
        e = np.zeros(3, np.float32)
        e[axi] = eps
        div += (acc(t, pts + e)[:, axi] - acc(t, pts - e)[:, axi]) / (2 * eps)
    mag = np.linalg.norm(acc(t, pts), axis=1)
    assert mag.mean() > 0.5 and np.abs(div).max() < 0.02 * mag.mean()
    t2 = pt.compile_force_fields([pt.ForceField.turbulence((0.0, 0.0, 0.0), 2.0, 1.0, frequency=0.7)], device="cpu")
    np.testing.assert_allclose(acc(t2, np.float32([[50.0, 0.0, 0.0]])), 0.0, atol=1e-6)
    t3 = pt.compile_force_fields([pt.ForceField.turbulence((0.0, 0.0, 0.0), 2.0, 1000.0, frequency=0.7, phase=2.0)],
                                 device="cpu")
    assert np.abs(acc(t3, pts) - acc(t, pts)).max() > 0.1


def test_per_type_field_opt_out():
    """affected_by_fields=False exempts a type: under a strong repulsor only
    the opted-in type accelerates."""
    types = [pt.ParticleSettings(lifetime=pt.RandF32.constant(5.0), acceleration=(0.0, 0.0, 0.0), linear_drag=0.0,
                                 affected_by_fields=t == 0) for t in range(2)]
    sp = pt.ParticleSpawner(particle_settings=types, emission_settings=[
        pt.EmissionSettings(particle_index=t, emission_pacing=pt.EmissionPacing.one_shot(16),
                            emission_shape=pt.EmissionShape.sphere(1.0)) for t in range(2)])
    scene = pt.Scene(force_fields=[pt.ForceField.point((0.0, 0.0, 0.0), -10.0, 50.0)], device="cpu")
    sid = scene.add_spawner(sp, capacity=256)
    for _ in range(30):
        scene.step(DT)
    st = scene._spawners[sid].state
    alive = st.alive.numpy()
    ty = st.ptype.numpy()[alive]
    speed = torch.sqrt(st.vx ** 2 + st.vy ** 2 + st.vz ** 2).numpy()[alive]
    assert (speed[ty == 0] > 0.5).all() and (ty == 1).sum() == 16
    np.testing.assert_allclose(speed[ty == 1], 0.0, atol=1e-6)


# ----------------------------------------------------- against the JAX step


def _pair(**kw):
    return jx.compile_spawner(det_spawner(jx, **kw)), pt.compile_spawner(det_spawner(pt, **kw), device="cpu")


def test_trajectory_with_fields_matches_jax_xla_step():
    """The deterministic spawner (constant draws, rate 2000, 0.3 s) under
    all four kinds for 60 frames, against the JAX XLA step every frame:
    alive, claims and counts exact, fields within 1e-4."""
    cj, cp = _pair()
    jt, table = _tables(_fields)
    fj, fp = jx.make_frame_input(1 / 50, force_fields=jt), pt.make_frame_input(1 / 50, force_fields=table)
    sj, sp = jx.init_pool_for(cj, N, 0), pt.init_pool_for(cp, N, 0)
    sn = sp
    for _ in range(60):
        sj, oj = step_jit(cj.static, cj.params, None, sj, fj)
        sp, op = plain_step(cp.static, cp.params, None, sp, fp)
        assert_pools_match(jax_pool_numpy(sj), port_pool_numpy(sp), atol=1e-4, rtol=0)
        assert int(op.alive_count) == int(oj.alive_count)
        sn, _o = plain_step(cp.static, cp.params, None, sn, pt.make_frame_input(1 / 50))
    assert int(op.alive_count) > 500
    assert np.abs(sp.vx.numpy() - sn.vx.numpy())[sp.alive.numpy()].max() > 0.1  # the fields acted


def test_fields_config_matches_jax_pallas_kernel_interpret_mode():
    """A point + vortex + turbulence config through the JAX package's Pallas
    kernel (interpret mode, as its own tests run it on the CPU) and the
    port's fused_step, 12 frames at N = 8192: alive exact, fields within
    1e-4."""
    cj, cp = _pair()
    jt, table = _tables(lambda pkg: [_fields(pkg)[i] for i in (0, 1, 3)])
    fj, fp = jx.make_frame_input(1 / 50, force_fields=jt), pt.make_frame_input(1 / 50, force_fields=table)
    sj, sp = jx.init_pool_for(cj, N, 0), pt.init_pool_for(cp, N, 0)
    fused = jax.jit(jfs.fused_step, static_argnums=(0,))
    for _ in range(12):
        with pltpu.force_tpu_interpret_mode():
            sj, oj = fused(cj.static, cj.params, None, sj, fj)
        sp, op = pfs.fused_step(cp.static, cp.params, None, sp, fp)
    a, b = jax_pool_numpy(sj), port_pool_numpy(sp)
    a["alive"] = np.asarray(sj.alive)
    assert_pools_match(a, b, atol=1e-4, rtol=0)
    assert int(op.alive_count) == int(oj.alive_count) > 0


FLIP = (1.0, 0.0, 0.0, 0.0)  # half turn about X: a halfspace solid above its plane


@pytest.mark.parametrize("destroy", [False, True])
def test_destroyed_mask_matches_jax_xla_step(destroy):
    """A ring archetype with a particles_destroyed handler (deaths by age;
    alive derived from age in the port, carried in the JAX step) and a
    destroy-on-collision archetype with one (a ceiling kills the stream):
    the destroyed mask equals the JAX step's every frame, lane for lane,
    and holds deaths."""
    handlers = (jx.ParticleEventHandlers(particles_destroyed=print), PortEventHandlers(particles_destroyed=print))
    cols = (dict(collision_settings=jx.ParticleCollisionSettings(destroy_on_collision=True)),
            dict(collision_settings=PortCollisionSettings(destroy_on_collision=True))) if destroy else ({}, {})
    cj = jx.compile_spawner(det_spawner(jx, ps=dict(event_handlers=handlers[0], **cols[0])))
    cp = pt.compile_spawner(det_spawner(pt, ps=dict(event_handlers=handlers[1], **cols[1])), device="cpu")
    assert cp.static.any_destroyed_dump and cp.static.ring_claim == (not destroy) and not cp.static.derived_alive
    tj = jx.compile_colliders([jx.Collider.halfspace(position=(0.0, 0.4, 0.0), rotation=FLIP)]) if destroy else None
    tp = pt.compile_colliders([pt.Collider.halfspace(position=(0.0, 0.4, 0.0), rotation=FLIP)],
                              device="cpu") if destroy else None
    fj, fp = jx.make_frame_input(1 / 50), pt.make_frame_input(1 / 50)
    sj, sp = jx.init_pool_for(cj, N, 0), pt.init_pool_for(cp, N, 0)
    dumped = 0
    for _ in range(30):
        sj, oj = step_jit(cj.static, cj.params, tj, sj, fj)
        sp, op = plain_step(cp.static, cp.params, tp, sp, fp)
        np.testing.assert_array_equal(op.destroyed_mask.numpy(), np.asarray(oj.destroyed_mask))
        assert_pools_match(jax_pool_numpy(sj), port_pool_numpy(sp), atol=1e-4, rtol=0)
        dumped += int(op.destroyed_mask.sum())
    assert dumped > 200
