"""Showcase: a two-stage firework built from the reference's own primitives
(nested emission with an end-of-life window = apex burst). Writes a PNG
(`firework_showcase.png` under --out)."""

import os

from _common_torch import parse_args, run

args = parse_args(__doc__, frames=240)

from bevy_firework_tpu_torch import Scene
from bevy_firework_tpu_torch.models import effects
from bevy_firework_tpu_torch.viewer import Camera, render_scene_png

spawner, tf = effects.fireworks()
scene = Scene(device=args.device)
scene.add_spawner(spawner, capacity=8192, transform=tf)
run(scene, args)
os.makedirs(args.out, exist_ok=True)
path = render_scene_png(
    scene, os.path.join(args.out, "firework_showcase.png"),
    Camera(position=(0.0, 4.0, 16.0), look_at=(0.0, 5.0, 0.0)),
    width=800, height=600, exposure=1.5,
)
print(f"live={scene.alive_count()} -> {path}")
