"""Render example scenes to PNGs with the software viewer — the headless
analog of eyeballing the reference's Bevy windows. Writes
firework_<scene>.png frames under --out."""

import os

from _common_torch import parse_args

args = parse_args(__doc__, frames=90)

from bevy_firework_tpu_torch import FogSettings, Scene
from bevy_firework_tpu_torch.models import effects
from bevy_firework_tpu_torch.viewer import Camera, render_scene_png

scenes = {}

spawner, tf = effects.sparks()
s = Scene(device=args.device)
s.add_spawner(spawner, capacity=2048, transform=tf)
scenes["sparks"] = (s, Camera(position=(-2.5, 4.5, 9.0), look_at=(0, 1.5, 0)))

spawner, tf, cols = effects.collision()
s = Scene(colliders=cols, device=args.device)
s.add_spawner(spawner, capacity=2048, transform=tf)
scenes["collision"] = (s, Camera(position=(-2.5, 4.5, 9.0), look_at=(1.5, 1.0, 0)))

spawner, tf, cols = effects.textures()
s = Scene(colliders=cols, device=args.device)
s.add_spawner(spawner, capacity=2048, transform=tf)
scenes["textures"] = (s, Camera(position=(0.0, 3.0, 9.0), look_at=(0, 1.0, 0)))

os.makedirs(args.out, exist_ok=True)
for name, (scene, cam) in scenes.items():
    for _ in range(args.frames):
        scene.step(args.dt)
    # textures: casings shadow the drawn ground plane and the scene recedes
    # into distance fog (the software analogs of the SHADOW_MAP + FOG
    # pipeline variants composed)
    kw = dict(ground_y=0.0, draw_ground=True, shadows=True,
              fog=FogSettings(start=6.0, end=35.0, color=(0.08, 0.10, 0.14, 1.0)),
              ) if name == "textures" else {}
    path = render_scene_png(scene, os.path.join(args.out, f"firework_{name}.png"), cam, **kw)
    print(f"{name}: {scene.alive_count()} live -> {path}")
