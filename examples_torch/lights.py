"""PBR smoke under a light TABLE (LIGHTS pipeline variant):
one warm directional sun + a blue point light + an orange spot, Bevy
clustered-PBR semantics. The reference inherits this whole environment from
`apply_pbr_lighting` (bevy_firework `src/particles.wgsl:180-239`); here the
table is an explicit uniform at group(2) binding 12 and the software viewer
shares `LightTable.radiance_at` as the oracle.

Writes lights.png (light table), lights_shadow.png (per-light shadow atlas),
lights_env.png (SH environment light) and lights_builtin.png (the built-in
single-directional environment) under --out, for a side-by-side.
"""

import os

from _common_torch import parse_args, run

args = parse_args(__doc__, frames=240)

from bevy_firework_tpu_torch import Light, LightTable, Scene
from bevy_firework_tpu_torch.models import effects
from bevy_firework_tpu_torch.viewer import Camera, render_scene_png

spawner, tf = effects.pbr()
scene = Scene(device=args.device)
scene.add_spawner(spawner, capacity=2048, transform=tf)
run(scene, args)

table = LightTable(
    lights=(
        Light.directional((-0.5, -0.7, -0.4), color=(1.0, 0.95, 0.85), illuminance=0.6),
        # shadow-casting POINT light: six cube-face atlas tiles (unrolled
        # cube map) — the occluder slab blocks its -x faces over the smoke
        Light.point((2.0, 2.5, 0.0), color=(0.2, 0.5, 1.0), intensity=150.0, range=18.0,
                    shadow=True),
        # SHADOW-CASTING spot: shadow=True assigns it
        # an atlas tile; the occluder slab below blocks it over half the
        # smoke column
        Light.spot((-3.0, 4.0, 8.0), (0.35, -0.3, -1.0), color=(1.0, 0.4, 0.2),
                   intensity=250.0, range=25.0, inner_angle=0.35, outer_angle=0.55,
                   shadow=True),
    ),
    ambient=(0.03, 0.03, 0.05),
)
from bevy_firework_tpu_torch import make_shadow_atlas

atlas = make_shadow_atlas(
    table,
    occluders=[
        ((-2.5, 0.0, 4.5), (0.0, 5.0, 5.2)),  # blocks the spot over half the column
        ((0.8, 1.0, -0.6), (1.3, 3.2, 0.6)),  # between the POINT light and the smoke
    ],
    resolution=256, strength=0.9)
cam = Camera(position=(0.0, 3.0, 10.0), look_at=(0.0, 2.0, 0.0))
os.makedirs(args.out, exist_ok=True)
render_scene_png(scene, os.path.join(args.out, "lights.png"), camera=cam, lights=table)
render_scene_png(scene, os.path.join(args.out, "lights_shadow.png"), camera=cam, lights=table,
                 shadow_atlas=atlas)
render_scene_png(scene, os.path.join(args.out, "lights_builtin.png"), camera=cam)

# ENVIRONMENT light (SH IBL): the same scene under a
# dusk-sky gradient environment instead of the flat ambient — the analog of
# Bevy's EnvironmentMapLight the reference inherits via apply_pbr_lighting.
import dataclasses

from bevy_firework_tpu_torch import EnvironmentLight

env = EnvironmentLight.gradient(sky=(0.25, 0.35, 0.8), horizon=(0.9, 0.5, 0.3),
                                ground=(0.15, 0.1, 0.08), intensity=0.8)
env_table = dataclasses.replace(table, ambient=(0.0, 0.0, 0.0), environment=env)
render_scene_png(scene, os.path.join(args.out, "lights_env.png"), camera=cam, lights=env_table)
print("wrote lights.png (light table), lights_shadow.png (per-light shadow "
      "atlas), lights_env.png (SH environment light) and lights_builtin.png "
      f"(built-in env) to {args.out}")
