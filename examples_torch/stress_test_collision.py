"""Collision stress test (reference: `examples/stress_test_collision.rs`):
rate 80,000/s, lifetime 2 s with raycast collision (<=4 substeps) against a
cuboid floor + angled cube => ~160 k live."""

from _common_torch import parse_args, run

args = parse_args(__doc__, frames=300)

from bevy_firework_tpu_torch import Scene
from bevy_firework_tpu_torch.models import effects

spawner, tf, colliders = effects.stress_test_collision()
scene = Scene(colliders=colliders, device=args.device)
scene.add_spawner(spawner, capacity=1 << 18, transform=tf)
wall = run(scene, args)
alive = scene.alive_count()
print(f"steady-state live: {alive}")
print(f"avg wall per frame: {wall / args.frames * 1e3:.3f} ms")
