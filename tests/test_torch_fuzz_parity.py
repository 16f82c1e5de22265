"""Property-based parity fuzz for the port: random (deterministic-draw)
spawner configs, the port's `step_jit` (the XLA-layout step) against the
NumPy oracle (`tests/oracle.py`), covering multi-emitter / multi-type
combinations, pacing kinds, emission offset windows and physics constants.
The port of tests/test_fuzz_parity.py at its tolerances; each config is
drawn twice from the same seed, once with each package's authoring types
(the oracle reads the JAX package's)."""

import numpy as np
import pytest

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from test_torch_common import _one_torch_thread  # noqa: F401
from tests.oracle import oracle_init, oracle_step


def random_spawner(pkg, rng: np.random.RandomState):
    T = rng.randint(1, 3)
    types = []
    for _ in range(T):
        n_knots = rng.randint(1, 5)
        if n_knots == 1:
            curve = pkg.FireworkCurve.constant(float(rng.uniform(0.5, 2.0)))
        else:
            ts = np.sort(rng.uniform(0, 1, n_knots))
            ts[0], ts[-1] = 0.0, 1.0
            if len(set(ts)) < n_knots:
                curve = pkg.FireworkCurve.constant(1.0)
            else:
                curve = pkg.FireworkCurve.uneven_samples([(float(t), float(rng.uniform(0.2, 3.0))) for t in ts])
        types.append(
            pkg.ParticleSettings(
                lifetime=pkg.RandF32.constant(float(rng.uniform(0.1, 0.8))),
                initial_scale=pkg.RandF32.constant(float(rng.uniform(0.05, 0.5))),
                scale_curve=curve,
                acceleration=tuple(rng.uniform(-10, 10, 3).astype(float)),
                angular_acceleration=tuple(rng.uniform(-2, 2, 3).astype(float)),
                linear_drag=float(rng.uniform(0, 1.0)),
                angular_drag=float(rng.uniform(0, 1.0)),
                base_color=pkg.gradient_uneven_samples(
                    [(0.0, tuple(rng.uniform(0, 2, 4).astype(float))), (1.0, tuple(rng.uniform(0, 1, 4).astype(float)))]
                ),
            )
        )
    E = rng.randint(1, 4)
    emitters = []
    for _ in range(E):
        kind = rng.choice(["one_shot", "rate", "windowed"])
        if kind == "one_shot":
            pacing = pkg.EmissionPacing.one_shot(int(rng.randint(1, 8)))
        elif kind == "rate":
            pacing = pkg.EmissionPacing.rate(float(rng.uniform(20, 300)))
        else:
            a = float(rng.uniform(0.0, 0.4))
            b = float(rng.uniform(0.6, 1.0))
            pacing = pkg.EmissionPacing.count_over_duration(float(rng.uniform(3, 40)), float(rng.uniform(0.3, 1.5)), a, b)
        emitters.append(
            pkg.EmissionSettings(
                particle_index=int(rng.randint(0, T)),
                emission_pacing=pacing,
                initial_velocity=pkg.RandVec3.constant(tuple(rng.uniform(-3, 3, 3).astype(float))),
                initial_angular_velocity=pkg.RandVec3.constant(tuple(rng.uniform(-3, 3, 3).astype(float))),
                inherit_parent_velocity=bool(rng.randint(0, 2)),
                initial_rotation=tuple((lambda q: q / np.linalg.norm(q))(rng.normal(size=4)).astype(float)),
            )
        )
    return pkg.ParticleSpawner(particle_settings=tuple(types), emission_settings=tuple(emitters))


def run_pair(seed, n_frames, dt, capacity=512):
    spawner = random_spawner(pt, np.random.RandomState(100 + seed))
    oracle_spawner = random_spawner(jx, np.random.RandomState(100 + seed))
    compiled = pt.compile_spawner(spawner, device="cpu")
    state = pt.init_pool_for(compiled, capacity, 0)
    ost = oracle_init(oracle_spawner)
    for fi in range(n_frames):
        state, out = pt.step_jit(compiled.static, compiled.params, None, state, pt.make_frame_input(dt))
        oracle_step(oracle_spawner, ost, dt)
        alive = state.alive.numpy()
        tys = state.ptype.numpy()[alive]
        o_parts = [(p, ti) for ti, pl_ in enumerate(ost.particles) for p in pl_]
        assert alive.sum() == len(o_parts), f"frame {fi}: {alive.sum()} vs {len(o_parts)}"
        for ti in range(len(spawner.particle_settings)):
            assert (tys == ti).sum() == sum(1 for _, t in o_parts if t == ti), f"frame {fi} type {ti}"
        for field, oget in (
            ("px", lambda p: p.position[0]),
            ("py", lambda p: p.position[1]),
            ("vz", lambda p: p.velocity[2]),
            ("age", lambda p: p.age),
            ("wx", lambda p: p.angular_velocity[0]),
            ("qw", lambda p: p.rotation[3]),
        ):
            a = np.sort(getattr(state, field).numpy()[alive])
            b = np.sort(np.array([oget(p) for p, _ in o_parts], dtype=np.float64)) if o_parts else np.array([])
            np.testing.assert_allclose(a, b, atol=5e-4, err_msg=f"frame {fi} {field}")


@pytest.mark.parametrize("seed", range(8))
def test_random_config_parity(seed):
    run_pair(seed, n_frames=35, dt=1.0 / 50.0)


def _ks_uniform(x):
    """KS statistic of samples x against U[0,1)."""
    x = np.sort(np.clip(x, 0.0, 1.0))
    n = len(x)
    ecdf_hi = np.arange(1, n + 1) / n
    ecdf_lo = np.arange(0, n) / n
    return max(np.abs(ecdf_hi - x).max(), np.abs(x - ecdf_lo).max())


def test_random_draw_distribution_through_step():
    """Randomized (non-constant) draws through the FULL engine step: burst 5000
    particles with cone-spread velocity + ranged lifetime/scale, then check the
    live pool realizes the reference distributions (SURVEY.md A.3 / hard part
    2: distribution parity, not bitstream parity). Deviation angle/spread,
    azimuth, magnitude, lifetime, and initial scale must each be uniform."""
    spread = np.pi / 5
    lo_m, hi_m = 2.0, 7.0
    sp = pt.ParticleSpawner(
        particle_settings=[
            pt.ParticleSettings(
                lifetime=pt.RandF32(1.0, 3.0),
                initial_scale=pt.RandF32(0.1, 0.4),
                acceleration=(0.0, 0.0, 0.0),
                linear_drag=0.0,
            )
        ],
        emission_settings=[
            pt.EmissionSettings(
                emission_pacing=pt.EmissionPacing.one_shot(5000),
                initial_velocity=pt.RandVec3(
                    magnitude=pt.RandF32(lo_m, hi_m), direction=(0.0, 1.0, 0.0), spread=spread
                ),
            )
        ],
    )
    compiled = pt.compile_spawner(sp, device="cpu")
    state = pt.init_pool_for(compiled, 8192, 0)
    state, _ = pt.step_jit(compiled.static, compiled.params, None, state, pt.make_frame_input(0.0))
    alive = state.alive.numpy()
    assert alive.sum() == 5000
    v = np.stack([state.vx.numpy()[alive], state.vy.numpy()[alive], state.vz.numpy()[alive]], -1)
    mags = np.linalg.norm(v, axis=-1)
    # magnitude ~ U[lo, hi)
    assert mags.min() >= lo_m and mags.max() < hi_m
    assert _ks_uniform((mags - lo_m) / (hi_m - lo_m)) < 0.03
    # deviation angle ~ U[0, spread)  (a = u * spread in the sampler)
    ang = np.arccos(np.clip(v[:, 1] / mags, -1, 1))
    assert ang.max() <= spread + 1e-5
    assert _ks_uniform(ang / spread) < 0.03
    # azimuth ~ U[0, 2pi)
    azim = np.mod(np.arctan2(-v[:, 2], v[:, 0]), 2 * np.pi)
    assert _ks_uniform(azim / (2 * np.pi)) < 0.03
    # lifetime ~ U[1, 3), initial scale ~ U[0.1, 0.4)
    life = state.lifetime.numpy()[alive]
    assert _ks_uniform((life - 1.0) / 2.0) < 0.03
    iscale = state.initial_scale.numpy()[alive]
    assert _ks_uniform((iscale - 0.1) / 0.3) < 0.03


def test_serde_round_trip_random_spawners():
    """JSON serde is total over the random config space: to_json -> from_json
    reproduces an EQUAL spawner (frozen dataclasses compare by value), and
    the round-tripped config compiles to the identical static key — so a
    scene file written by one process steps bit-identically in another.
    Randomized shapes/textures/collision/fields-opt-out included."""
    from bevy_firework_tpu_torch import EmissionShape, ParticleCollisionSettings, spawner_from_json, spawner_to_json

    rng = np.random.RandomState(77)
    shapes = [
        lambda: EmissionShape.point(),
        lambda: EmissionShape.sphere(float(rng.uniform(0.1, 2.0))),
        lambda: EmissionShape.circle(tuple(rng.uniform(-1, 1, 3) + 1e-3), float(rng.uniform(0.1, 2.0))),
        lambda: EmissionShape.box(tuple(rng.uniform(0.1, 2.0, 3)), tuple(rng.uniform(-1, 1, 3) + 1e-3)),
        lambda: EmissionShape.ring(tuple(rng.uniform(-1, 1, 3) + 1e-3), float(rng.uniform(0.1, 2.0))),
    ]
    for trial in range(25):
        sp = random_spawner(pt, rng)
        # sprinkle the surfaces random_spawner doesn't vary
        ps = list(sp.particle_settings)
        import dataclasses as dc

        if rng.rand() < 0.5:
            ps[0] = dc.replace(
                ps[0],
                collision_settings=ParticleCollisionSettings(
                    restitution=float(rng.uniform(0, 1)), friction=float(rng.uniform(0, 1)),
                    destroy_on_collision=bool(rng.randint(0, 2))),
                affected_by_fields=bool(rng.randint(0, 2)),
                base_color_texture="textures/bullet_case/diffuse.png" if rng.rand() < 0.3 else None,
            )
        es = list(sp.emission_settings)
        es[0] = dc.replace(es[0], emission_shape=shapes[rng.randint(len(shapes))]())
        sp = dc.replace(sp, particle_settings=tuple(ps), emission_settings=tuple(es))

        rt = spawner_from_json(spawner_to_json(sp))
        assert rt == sp, f"trial {trial}: round-trip not value-equal"
        assert pt.compile_spawner(rt, device="cpu").static == pt.compile_spawner(sp, device="cpu").static, trial
