"""The port's physics-sync helpers (`physics_sync`, copied from the JAX
package) on the port's `Scene`: the four cases of tests/test_physics_sync.py,
each result equal to the JAX Scene's on the same deterministic spawner."""

import warnings

import numpy as np

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from bevy_firework_tpu import physics_sync as jps
from bevy_firework_tpu_torch import physics_sync as pps
from test_torch_common import _one_torch_thread  # noqa: F401


def _scene(pkg):
    return pkg.Scene(device="cpu") if pkg is pt else pkg.Scene()


def _state(scene, sid):
    st = scene._spawners[sid].state
    alive = np.asarray(st.alive)
    return {k: np.asarray(getattr(st, k))[alive] for k in ("px", "py", "pz", "vx", "vy", "vz", "initial_scale")}


def test_linear_velocity_at_point():
    rng = np.random.default_rng(0)
    for _ in range(200):
        args = [tuple(rng.uniform(-5, 5, 3)) for _ in range(4)]
        np.testing.assert_array_equal(pt.linear_velocity_at_point(*args), jx.linear_velocity_at_point(*args))
    np.testing.assert_allclose(pt.linear_velocity_at_point((0, 0, 0), (0, 0, 1), (1, 0, 0), (0, 0, 0)), [0, 1, 0],
                               atol=1e-6)
    np.testing.assert_allclose(pt.linear_velocity_at_point((2, 0, 0), (0, 0, 1), (1, 0, 0), (0, 0, 0)), [2, 1, 0],
                               atol=1e-6)


def _inheriting(pkg):
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(lifetime=pkg.RandF32.constant(5.0), acceleration=(0, 0, 0),
                                                linear_drag=0.0)],
        emission_settings=[pkg.EmissionSettings(emission_pacing=pkg.EmissionPacing.rate(30.0),
                                                initial_velocity=pkg.RandVec3.constant((0, 0, 0)),
                                                inherit_parent_velocity=True)],
    )


def test_sync_parent_velocity_feeds_spawned_particles():
    """A spawner riding a spinning body: the body's point velocity at the
    spawner becomes the inherited parent velocity, frame after frame, in
    both Scenes (omega x r at spawn)."""
    out = []
    for pkg, ps in ((jx, jps), (pt, pps)):
        scene = _scene(pkg)
        sid = scene.add_spawner(_inheriting(pkg), capacity=64, transform=pkg.Transform(translation=(1.0, 0.0, 0.0)))
        body = ps.RigidBodyState(linear_velocity=(0.5, 0, 0), angular_velocity=(0, 0, 2.0), center_of_mass=(0, 0, 0))
        for f in range(20):
            ps.sync_parent_velocity(scene, {sid: body})
            scene.step(1 / 60)
            if f == 5:
                scene.set_transform(sid, pkg.Transform(translation=(0.0, 2.0, 0.0)))
        out.append(_state(scene, sid))
    j, p = out
    assert len(p["vx"]) == len(j["vx"]) > 5
    for k in j:
        np.testing.assert_allclose(p[k], j[k], atol=1e-6, err_msg=k)
    assert {round(float(v), 5) for v in p["vy"]} == {2.0, 0.0} and set(np.round(p["vx"], 5)) == {0.5, -3.5}


def test_propagate_modifiers():
    """One ancestor's modifier onto two descendants: both spawn at its scale
    and speed, as in the JAX Scene."""
    out = []
    for pkg, ps in ((jx, jps), (pt, pps)):
        sp = pkg.ParticleSpawner(
            particle_settings=[pkg.ParticleSettings(lifetime=pkg.RandF32.constant(5.0),
                                                    initial_scale=pkg.RandF32.constant(1.0))],
            emission_settings=[pkg.EmissionSettings(emission_pacing=pkg.EmissionPacing.one_shot(1),
                                                    initial_velocity=pkg.RandVec3.constant((0, 1, 0)))],
        )
        scene = _scene(pkg)
        a = scene.add_spawner(sp, capacity=8)
        b = scene.add_spawner(sp, capacity=8)
        ps.propagate_modifiers(scene, pkg.EffectModifier(scale=3.0, speed=2.0), [a, b])
        scene.step(0.0)
        out.append([_state(scene, sid) for sid in (a, b)])
    for sj, sp_ in zip(*out):
        assert float(sp_["initial_scale"][0]) == float(sj["initial_scale"][0]) == 3.0
        assert float(sp_["vy"][0]) == float(sj["vy"][0]) == 2.0


def test_invalid_nested_pacing_warns():
    """A nested emitter with on-demand pacing warns at compile time in both
    packages, with the same message."""
    msgs = []
    for pkg in (jx, pt):
        sp = pkg.ParticleSpawner(
            particle_settings=[pkg.ParticleSettings(), pkg.ParticleSettings()],
            emission_settings=[
                pkg.EmissionSettings(particle_index=0, emission_pacing=pkg.EmissionPacing.one_shot(1)),
                pkg.EmissionSettings(particle_index=1, emission_mode=pkg.EmissionMode.nested(0),
                                     emission_pacing=pkg.EmissionPacing.on_demand()),
            ],
        )
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            pkg.compile_spawner(sp) if pkg is jx else pkg.compile_spawner(sp, device="cpu")
        msgs.append([str(x.message) for x in w if "CountOverDuration" in str(x.message)])
    assert msgs[0] and msgs[0] == msgs[1]
