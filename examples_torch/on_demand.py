"""On-demand emission (reference: `examples/on_demand.rs`): each simulated
"click" queues one particle via `queue_particles`."""

from _common_torch import parse_args, run

args = parse_args(__doc__, frames=240)

from bevy_firework_tpu_torch import Scene
from bevy_firework_tpu_torch.models import effects

spawner, tf = effects.on_demand()
scene = Scene(device=args.device)
sid = scene.add_spawner(spawner, capacity=256, transform=tf)


def click_occasionally(f):
    if f % 30 == 0:  # a click every half second
        scene.queue_particles(sid, 1)
        print(f"frame {f}: click -> queue_particles(1)")


run(scene, args, on_frame=click_occasionally)
print(f"end: live={scene.alive_count()}")
