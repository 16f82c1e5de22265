"""Shared helpers of the port's tests (no tests here): spawners built the same
way in both packages, and state exchange between them through numpy."""

import dataclasses

import numpy as np
import pytest
import torch

import bevy_firework_tpu as jx
from bevy_firework_tpu.compiled import SpawnerParams as JaxSpawnerParams
from bevy_firework_tpu_torch import interop

POOL_FIELDS = [f.name for f in dataclasses.fields(jx.PoolState)]
PARAM_FIELDS = [f.name for f in dataclasses.fields(JaxSpawnerParams)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions are many small ops; OpenMP thread start-up costs
    more than the ops at these sizes when several test workers share cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def det_spawner(pkg, **kw):
    """tests/test_fused_step.py's deterministic spawner (constant draws, point
    shape, live rotation), built with either package's authoring types."""
    return pkg.ParticleSpawner(
        particle_settings=[
            pkg.ParticleSettings(
                lifetime=pkg.RandF32.constant(0.3),
                initial_scale=pkg.RandF32.constant(0.1),
                scale_curve=pkg.FireworkCurve.uneven_samples([(0.0, 1.0), (1.0, 2.0)]),
                base_color=pkg.gradient_uneven_samples([(0.0, (1, 0.5, 0.2, 1)), (1.0, (0, 0, 0, 0))]),
                **kw.get("ps", {}),
            )
        ],
        emission_settings=[
            pkg.EmissionSettings(
                emission_pacing=kw.get("pacing", pkg.EmissionPacing.rate(2000.0)),
                initial_velocity=pkg.RandVec3.constant((1.0, 3.0, 0.2)),
                initial_angular_velocity=pkg.RandVec3.constant((0.0, 2.0, 0.0)),
            )
        ],
    )


def effect(pkg_name, name, rate=None):
    """An effect of either package's models.effects, optionally re-rated."""
    if pkg_name == "jax":
        from bevy_firework_tpu.models import effects
        from bevy_firework_tpu.settings import EmissionPacing
    else:
        from bevy_firework_tpu_torch.models import effects
        from bevy_firework_tpu_torch.settings import EmissionPacing
    sp, tf = getattr(effects, name)()
    if rate is not None:
        es = dataclasses.replace(sp.emission_settings[0], emission_pacing=EmissionPacing.rate(float(rate)))
        sp = dataclasses.replace(sp, emission_settings=(es,))
    return sp, tf


def jax_pool_numpy(state) -> dict:
    return {k: np.asarray(getattr(state, k)) for k in POOL_FIELDS}


def jax_params_numpy(params) -> dict:
    return {k: np.asarray(getattr(params, k)) for k in PARAM_FIELDS}


def port_pool_numpy(state) -> dict:
    return interop.pool_to_numpy(state)


EXACT = ("alive", "ring_cursor", "enabled", "manual_queued", "rng_key")
F32_LANE = ("px", "py", "pz", "vx", "vy", "vz", "qx", "qy", "qz", "qw", "wx", "wy", "wz",
            "initial_scale", "age", "lifetime")


def assert_pools_match(a: dict, b: dict, atol=2e-5, rtol=1e-6, fields=F32_LANE):
    """Lane-by-lane pool comparison: bookkeeping exact, f32 fields within
    (atol, rtol) — XLA on the CPU contracts multiply-adds into FMAs, which the
    port's separately rounded ops do not, so values differ in the last bits."""
    for k in EXACT:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in fields:
        np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=rtol, err_msg=k)
