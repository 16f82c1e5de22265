"""Comet trails: ribbon rendering from the circular position history
(trails.py — beyond the reference's feature set; the reference has no
trails, bevy_firework `README.md:21-50`).

Each comet head drags a 16-point tapered ribbon; `Scene.trail_items()`
drains [count, 16] f32 segment records the same way `render_items()` drains
instance records."""

from _common_torch import parse_args, run

args = parse_args(__doc__)

from bevy_firework_tpu_torch import Scene, TrailSettings
from bevy_firework_tpu_torch.models import library

scene = Scene(device=args.device)
scene.add_spawner(library.comets(), capacity=256,
                  trail=TrailSettings(length=16, width=0.8))
run(scene, args)
items = scene.trail_items()
n_seg = sum(it.count for it in items)
print(f"trail items: {len(items)}; segments: {n_seg} x 64 B")
