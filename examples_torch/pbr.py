"""Buoyant PBR smoke (reference: `examples/pbr.rs`): rate 150/s, lifetime
5 s => ~750 live; PBR path + scene fade in the per-system uniform."""

from _common_torch import parse_args, run

args = parse_args(__doc__, frames=420)

from bevy_firework_tpu_torch import Scene
from bevy_firework_tpu_torch.models import effects

spawner, tf = effects.pbr()
scene = Scene(device=args.device)
scene.add_spawner(spawner, capacity=2048, transform=tf)
run(scene, args)
item = scene.render_items()[0]
print(f"uniform: {item.uniform} (pbr=1, fade_scene=3.5 expected)")
