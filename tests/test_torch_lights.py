"""The port's view lights, fog and shadow atlas (`render`, host numpy copied
from the JAX package) against the JAX package's, on seeded inputs: the
uniform bytes byte for byte, the host oracles (fog amount, light radiance,
the SH environment light, the light matrices, the cube-face select) and a
baked shadow depth map bit for bit."""

import numpy as np
import pytest

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from bevy_firework_tpu import render as jr
from bevy_firework_tpu_torch import render as pr


def _lights(pkg, rng):
    """A seeded table of each kind, two of them shadowed (a directional, a
    spot and a point row: 1 + 1 + 6 atlas tiles)."""
    def v3(lo, hi):
        return tuple(float(x) for x in rng.uniform(lo, hi, 3))
    rows = (
        pkg.Light.directional(v3(-1, -0.2), color=v3(0.5, 1.0), illuminance=float(rng.uniform(0.5, 3)), shadow=True),
        pkg.Light.spot(v3(-3, 3), v3(-1, 1), color=v3(0.2, 1.0), intensity=float(rng.uniform(5, 40)),
                       range=float(rng.uniform(5, 20)), shadow=True),
        pkg.Light.point(v3(-4, 4), color=v3(0.1, 1.0), intensity=float(rng.uniform(5, 60)),
                        range=float(rng.uniform(4, 15)), shadow=True),
        pkg.Light.point(v3(-4, 4), color=v3(0.1, 1.0)),
    )
    env = pkg.EnvironmentLight.gradient(sky=v3(0.2, 0.8), horizon=v3(0.1, 0.5), ground=v3(0.0, 0.3),
                                        intensity=float(rng.uniform(0.5, 2)))
    return pkg.LightTable(lights=rows, ambient=v3(0, 0.2), environment=env)


@pytest.mark.parametrize("seed", range(3))
def test_uniform_bytes_match(seed):
    """FogSettings (each mode), LightTable (with its environment light) and
    a baked ShadowAtlas pack to the same bytes."""
    for mode in (pr.FOG_LINEAR, pr.FOG_EXP, pr.FOG_EXP2):
        rng = np.random.default_rng(seed)
        kw = dict(mode=mode, color=tuple(rng.uniform(0, 1, 4)), start=float(rng.uniform(0, 5)),
                  end=float(rng.uniform(10, 60)), density=float(rng.uniform(0.01, 0.2)),
                  directional_light_color=tuple(rng.uniform(0, 1, 4)), light_dir=tuple(rng.uniform(-1, 1, 3)))
        assert pt.FogSettings(**kw).to_bytes() == jx.FogSettings(**kw).to_bytes()
    tp, tj = _lights(pt, np.random.default_rng(seed)), _lights(jx, np.random.default_rng(seed))
    assert tp.to_bytes() == tj.to_bytes() and len(tp.to_bytes()) == 1216
    assert tp.shadow_tiles() == tj.shadow_tiles()
    ap, aj = pt.make_shadow_atlas(tp, resolution=16), jx.make_shadow_atlas(tj, resolution=16)
    assert ap.to_bytes() == aj.to_bytes()


def test_host_oracles_match():
    """fog amount, light radiance at points, the SH environment light's
    irradiance and specular radiance, light_view_proj of each kind and
    face, cube_face: equal on seeded inputs."""
    rng = np.random.default_rng(7)
    dists = rng.uniform(0, 80, 500)
    for mode in (pr.FOG_LINEAR, pr.FOG_EXP, pr.FOG_EXP2):
        np.testing.assert_array_equal(pt.FogSettings(mode=mode).amount(dists), jx.FogSettings(mode=mode).amount(dists))
    tp, tj = _lights(pt, np.random.default_rng(1)), _lights(jx, np.random.default_rng(1))
    pts = rng.uniform(-6, 6, (200, 3))
    for p in pts:
        np.testing.assert_array_equal(tp.radiance_at(p), tj.radiance_at(p))
    normals = rng.standard_normal((300, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    ep, ej = tp.environment, tj.environment
    assert ep.sh == ej.sh
    np.testing.assert_array_equal(ep.irradiance(normals), ej.irradiance(normals))
    for rough in (0.0, 0.3, 0.9):
        np.testing.assert_array_equal(ep.specular_radiance(normals, rough), ej.specular_radiance(normals, rough))
    for lp, lj in zip(tp.lights, tj.lights):
        if lp.kind == pr.LIGHT_POINT:
            for face in range(6):
                np.testing.assert_array_equal(pt.light_view_proj(lp, face=face), jx.light_view_proj(lj, face=face))
        else:
            np.testing.assert_array_equal(pt.light_view_proj(lp, center=(0.5, 0, 0), radius=7.0),
                                          jx.light_view_proj(lj, center=(0.5, 0, 0), radius=7.0))
    for d in rng.standard_normal((400, 3)):
        assert pr.cube_face(d) == jr.cube_face(d)
    assert pr.CUBE_FACE_DIRS == jr.CUBE_FACE_DIRS and pr.MAX_LIGHTS == jr.MAX_LIGHTS


def test_shadow_atlas_depth_and_factor_match():
    """make_shadow_atlas with occluder boxes: the depth map and matrices bit
    for bit, the atlas tiles laid out alike, and `factor` equal at seeded
    world points for every shadowed row."""
    rng = np.random.default_rng(3)
    boxes = [(tuple(c - s), tuple(c + s)) for c, s in
             ((rng.uniform(-3, 3, 3), rng.uniform(0.2, 1.2, 3)) for _ in range(4))]
    tp, tj = _lights(pt, np.random.default_rng(2)), _lights(jx, np.random.default_rng(2))
    ap = pt.make_shadow_atlas(tp, occluders=boxes, resolution=32, radius=8.0)
    aj = jx.make_shadow_atlas(tj, occluders=boxes, resolution=32, radius=8.0)
    np.testing.assert_array_equal(ap.depth, aj.depth)
    np.testing.assert_array_equal(ap.mats, aj.mats)
    assert (ap.grid, ap.bias, ap.strength) == (aj.grid, aj.bias, aj.strength)
    assert (ap.depth < 1.0).any()  # the occluders cast
    assert [e[:2] for e in pr.shadow_tile_entries(tp)] == [e[:2] for e in jr.shadow_tile_entries(tj)]
    for p in rng.uniform(-5, 5, (300, 3)):
        for row in range(3):
            assert ap.factor(p, row) == aj.factor(p, row)
