"""The port's headless viewer (`viewer`, copied from the JAX package)
against the JAX package's: a deterministic Scene stepped in both packages,
its render items and trail items drawn with fog, a light table and a shadow
atlas, give the same image; `write_png` writes the same bytes."""

import numpy as np

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from bevy_firework_tpu import viewer as jv
from bevy_firework_tpu_torch import viewer as pv
from test_torch_common import _one_torch_thread  # noqa: F401

# Positions in the two Scenes differ by XLA's FMA contractions on the CPU
# (a few ulp; tests/test_torch_xla_step.py), which moves a disc's edge
# coverage by a hair: pixels agree to this much (6.1e-7 measured), and
# nearly all exactly.
PIXEL_ATOL = 1e-5


def _fountain(pkg, color, pbr):
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(
            lifetime=pkg.RandF32.constant(1.2), initial_scale=pkg.RandF32.constant(0.12),
            scale_curve=pkg.FireworkCurve.uneven_samples([(0.0, 1.0), (1.0, 0.4)]),
            base_color=pkg.gradient_uneven_samples([(0.0, color), (1.0, (0.2, 0.1, 0.05, 0.2))]),
            acceleration=(0.0, -4.0, 0.0), linear_drag=0.2, pbr=pbr)],
        emission_settings=[pkg.EmissionSettings(
            emission_pacing=pkg.EmissionPacing.rate(60.0),
            initial_velocity=pkg.RandVec3.constant((0.6, 3.5, 0.3)))])


def _comet(pkg):
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(
            lifetime=pkg.RandF32.constant(0.8), initial_scale=pkg.RandF32.constant(0.2),
            base_color=pkg.gradient_constant((1.0, 0.8, 0.3, 1.0)), acceleration=(0.0, 0.0, 0.0), linear_drag=0.0)],
        emission_settings=[pkg.EmissionSettings(
            emission_pacing=pkg.EmissionPacing.rate(8.0), initial_velocity=pkg.RandVec3.constant((2.5, 0.8, 0.0)))])


def _view(pkg):
    """Fog, a light table (directional + point + SH environment, two rows
    shadowed) and its shadow atlas over one box occluder."""
    fog = pkg.FogSettings(mode=1, start=4.0, end=20.0, color=(0.5, 0.55, 0.6, 0.8),
                          directional_light_color=(1.0, 0.9, 0.7, 0.5))
    lights = pkg.LightTable(lights=(
        pkg.Light.directional((-0.3, -1.0, -0.2), color=(1.0, 0.95, 0.9), illuminance=2.0, shadow=True),
        pkg.Light.point((1.5, 2.5, 1.0), color=(0.3, 0.5, 1.0), intensity=40.0, range=8.0, shadow=True),
    ), ambient=(0.05, 0.05, 0.06), environment=pkg.EnvironmentLight.gradient())
    atlas = pkg.make_shadow_atlas(lights, occluders=[((-0.5, 1.2, -0.5), (0.5, 1.4, 0.5))], resolution=32,
                                  radius=6.0)
    return dict(fog=fog, lights=lights, shadow_atlas=atlas)


def _scene_images(frames=50, width=96, height=72):
    images = []
    for pkg, viewer in ((jx, jv), (pt, pv)):
        scene = pkg.Scene(seed=2) if pkg is jx else pkg.Scene(seed=2, device="cpu")
        scene.add_spawner(_fountain(pkg, (1.0, 0.5, 0.2, 1.0), False), capacity=128)
        scene.add_spawner(_fountain(pkg, (0.4, 0.8, 1.0, 1.0), True), capacity=128,
                          transform=pkg.Transform(translation=(-1.5, 0.0, 0.5)))
        scene.add_spawner(_comet(pkg), capacity=16, trail=pkg.TrailSettings(length=8, width=0.15),
                          transform=pkg.Transform(translation=(-2.0, 0.5, -1.0)))
        for _ in range(frames):
            scene.step(1 / 60)
        cam = viewer.Camera(position=(0.0, 2.5, 7.0), look_at=(0.0, 1.2, 0.0))
        items, trails = scene.render_items(), scene.trail_items()
        img = viewer.render_frame(items, cam, width, height, trail_items=trails, ground_y=0.0, draw_ground=True,
                                  shadows=True, **_view(pkg))
        images.append((img, sum(i.count for i in items), sum(t.count for t in trails)))
    return images


def test_scene_image_matches_jax():
    (ij, nj, tj), (ip, np_, tp) = _scene_images()
    assert (np_, tp) == (nj, tj) and np_ > 50 and tp > 0
    assert ip.shape == ij.shape == (72, 96, 3)
    diff = np.abs(ip - ij)
    assert diff.max() <= PIXEL_ATOL, diff.max()
    assert (diff > 0).mean() < 0.02
    assert ip.std() > 0.01  # something was drawn


def test_write_png_bytes_match(tmp_path):
    """The same image through both writers (float and uint8 input) gives
    the same file, and render_scene_png writes the Scene's frame."""
    rng = np.random.default_rng(4)
    img = rng.uniform(-0.1, 1.1, (17, 23, 3)).astype(np.float32)
    for arr in (img, (np.clip(img, 0, 1) * 255).astype(np.uint8)):
        pv.write_png(str(tmp_path / "p.png"), arr)
        jv.write_png(str(tmp_path / "j.png"), arr)
        assert (tmp_path / "p.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    scene = pt.Scene(device="cpu")
    scene.add_spawner(_comet(pt), capacity=16, trail=pt.TrailSettings(length=4))
    for _ in range(10):
        scene.step(1 / 60)
    path = pv.render_scene_png(scene, str(tmp_path / "s.png"), width=32, height=24)
    assert (tmp_path / "s.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and path.endswith("s.png")
