"""Continuous ember fountain (reference: `examples/sparks.rs`).

~750 live particles at steady state (rate 1000/s x 0.75 s lifetime)."""

from _common_torch import parse_args, run

args = parse_args(__doc__)

from bevy_firework_tpu_torch import Scene
from bevy_firework_tpu_torch.models import effects

spawner, tf = effects.sparks()
scene = Scene(device=args.device)
scene.add_spawner(spawner, capacity=2048, transform=tf)
run(scene, args)
items = scene.render_items()
print(f"render items: {len(items)}; instances: {items[0].count} x 64 B")
