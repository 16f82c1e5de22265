"""Stress test (reference: `examples/stress_test.rs`): rate 160,000/s,
lifetime 1 s => ~160 k live steady state. Prints the live-count overlay and a
particles-stepped/sec summary."""

from _common_torch import parse_args, run

args = parse_args(__doc__, frames=300)

from bevy_firework_tpu_torch import Scene
from bevy_firework_tpu_torch.models import effects

spawner, tf = effects.stress_test()
scene = Scene(device=args.device)
scene.add_spawner(spawner, capacity=1 << 18, transform=tf)
wall = run(scene, args)
alive = scene.alive_count()
print(f"steady-state live: {alive}")
print(f"avg wall per frame: {wall / args.frames * 1e3:.3f} ms")
print(f"~particle-steps/sec: {alive * args.frames / wall:,.0f}")
