"""Golden trajectory parity for the port: `step_jit` (the XLA-layout step)
against the NumPy oracle (`tests/oracle.py`, a transliteration of the
reference's Rust semantics) on deterministic (constant-range) configs. The
port of tests/test_step_golden.py, at its tolerances; the oracle reads the
JAX package's authoring types, so each spawner is built with both
packages."""

import numpy as np
import torch

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from test_torch_common import _one_torch_thread  # noqa: F401
from tests.oracle import oracle_init, oracle_step


def deterministic_spawner(pkg, **overrides):
    ps = dict(
        lifetime=pkg.RandF32.constant(0.5),
        initial_scale=pkg.RandF32.constant(0.1),
        scale_curve=pkg.FireworkCurve.uneven_samples([(0.0, 1.0), (1.0, 2.0)]),
        base_color=pkg.gradient_uneven_samples([(0.0, (1.0, 0.5, 0.2, 1.0)), (1.0, (0.0, 0.0, 0.0, 0.0))]),
        acceleration=(0.0, -9.81, 0.0),
        linear_drag=0.2,
    )
    es = dict(
        emission_pacing=pkg.EmissionPacing.rate(100.0),
        initial_velocity=pkg.RandVec3.constant((1.0, 3.0, 0.2)),
        initial_angular_velocity=pkg.RandVec3.constant((0.0, 2.0, 0.0)),
    )
    for k, v in overrides.items():
        v = v(pkg) if callable(v) else v
        if k in ps:
            ps[k] = v
        else:
            es[k] = v
    return pkg.ParticleSpawner(
        particle_settings=(pkg.ParticleSettings(**ps),),
        emission_settings=(pkg.EmissionSettings(**es),),
    )


def run_engine(spawner, n_frames, dt, capacity=256):
    compiled = pt.compile_spawner(spawner, device="cpu")
    state = pt.init_pool_for(compiled, capacity, seed=0)
    frames = []
    for _ in range(n_frames):
        state, out = pt.step_jit(compiled.static, compiled.params, None, state, pt.make_frame_input(dt))
        alive = state.alive.numpy()
        buf, count = pt.pack_instances(compiled.params, state, 0)
        rows = buf.numpy()[: int(count)]
        frames.append({
            "count": int(alive.sum()),
            "pos": rows[:, 0:3],
            "vel": np.stack([state.vx.numpy()[alive], state.vy.numpy()[alive], state.vz.numpy()[alive]], -1),
            "age": state.age.numpy()[alive],
            "scale": rows[:, 3],
            "color": rows[:, 8:12],
            "rot": rows[:, 4:8],
            "finished": bool(out.finished_event),
        })
    return frames


def run_oracle(spawner, n_frames, dt):
    st = oracle_init(spawner)
    frames = []
    for _ in range(n_frames):
        _, finished = oracle_step(spawner, st, dt)
        parts = [p for plist in st.particles for p in plist]
        frames.append({
            "count": len(parts),
            "pos": np.array([p.position for p in parts]).reshape(-1, 3),
            "vel": np.array([p.velocity for p in parts]).reshape(-1, 3),
            "age": np.array([p.age for p in parts]),
            "scale": np.array([p.scale for p in parts]),
            "color": np.array([p.base_color for p in parts]).reshape(-1, 4),
            "rot": np.array([p.rotation for p in parts]).reshape(-1, 4),
            "finished": finished,
        })
    return frames


def _sorted_rows(a):
    a = np.asarray(a, dtype=np.float64)
    if a.size == 0:
        return a
    if a.ndim == 1:
        return np.sort(a)
    return a[np.lexsort(a.T[::-1])]


def assert_frames_match(engine_frames, oracle_frames, atol=2e-5):
    for fi, (ef, of) in enumerate(zip(engine_frames, oracle_frames)):
        assert ef["count"] == of["count"], f"frame {fi}: count {ef['count']} != {of['count']}"
        for key in ("pos", "vel", "age", "scale", "color", "rot"):
            a, b = _sorted_rows(ef[key]), _sorted_rows(of[key])
            np.testing.assert_allclose(a, b, atol=atol, err_msg=f"frame {fi} field {key}")
        assert ef["finished"] == of["finished"], f"frame {fi} finished"


def _pair(**overrides):
    return deterministic_spawner(pt, **overrides), deterministic_spawner(jx, **overrides)


def test_rate_emitter_trajectories():
    sp, sj = _pair()
    dt = 1.0 / 60.0
    n = 50  # > lifetime/dt so cull paths are exercised
    assert_frames_match(run_engine(sp, n, dt), run_oracle(sj, n, dt))


def test_one_shot_lifecycle_and_finished():
    sp, sj = _pair(emission_pacing=lambda pkg: pkg.EmissionPacing.one_shot(20),
                   lifetime=lambda pkg: pkg.RandF32.constant(0.2))
    dt = 1.0 / 60.0
    n = 20
    ef, of = run_engine(sp, n, dt), run_oracle(sj, n, dt)
    assert_frames_match(ef, of)
    assert any(f["finished"] for f in ef)
    assert max(f["count"] for f in ef) == 20  # burst emitted exactly once


def test_no_drag_ballistic_closed_form():
    """drag=0: after k frames velocity = v0 + k*a*dt exactly (semi-implicit,
    post-move update — A.4 steps 3/5)."""
    sp, _sj = _pair(linear_drag=0.0, emission_pacing=lambda pkg: pkg.EmissionPacing.one_shot(1),
                    lifetime=lambda pkg: pkg.RandF32.constant(10.0))
    dt = np.float32(0.01)
    frames = run_engine(sp, 5, float(dt), capacity=64)
    v0 = np.array([1.0, 3.0, 0.2], dtype=np.float32)
    a = np.array([0.0, -9.81, 0.0], dtype=np.float32)
    for k, f in enumerate(frames):
        want_v = v0 + np.float32(k + 1) * a * dt
        np.testing.assert_allclose(f["vel"][0], want_v, atol=1e-5)


def test_scale_curve_applied():
    sp, _sj = _pair(emission_pacing=lambda pkg: pkg.EmissionPacing.one_shot(1))
    dt = 0.05
    frames = run_engine(sp, 9, dt, capacity=64)
    for k, f in enumerate(frames):
        age = (k + 1) * dt
        if age >= 0.5:
            assert f["count"] == 0
            continue
        pct = np.float32(age) / np.float32(0.5)
        want = 0.1 * (1.0 + pct)  # curve 1 -> 2
        np.testing.assert_allclose(f["scale"][0], want, atol=1e-5)


def test_angular_velocity_rotates():
    sp, sj = _pair(emission_pacing=lambda pkg: pkg.EmissionPacing.one_shot(3))
    dt = 1.0 / 30.0
    assert_frames_match(run_engine(sp, 16, dt), run_oracle(sj, 16, dt))


def test_modifier_scales_speed_and_size():
    sp, _sj = _pair(emission_pacing=lambda pkg: pkg.EmissionPacing.one_shot(1), linear_drag=0.0)
    compiled = pt.compile_spawner(sp, device="cpu")
    state = pt.init_pool_for(compiled, 64, 0)
    frame = pt.make_frame_input(0.01, modifier_scale=2.0, modifier_speed=3.0)
    state, _ = pt.step_jit(compiled.static, compiled.params, None, state, frame)
    alive = state.alive
    # initial_scale = 0.1 * 2; velocity ~ 3 * v0 + 1 frame of gravity
    np.testing.assert_allclose(state.initial_scale[alive][0].item(), 0.2, atol=1e-6)
    v = torch.stack([state.vx[alive][0], state.vy[alive][0], state.vz[alive][0]]).numpy()
    want = 3.0 * np.array([1.0, 3.0, 0.2]) + np.array([0.0, -9.81, 0.0]) * 0.01
    np.testing.assert_allclose(v, want, atol=1e-5)
