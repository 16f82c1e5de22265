"""Impact bursts (reference: `examples/one_shot.rs`): a bouncing ball spawns
a 20-particle burst per impact, sized by impulse; each burst spawner despawns
when finished (ParticleSpawnerFinished observer).

Uses a `Fleet` so every live burst steps in ONE launch of the fleet kernel —
the analog of the reference's par_iter_mut over spawners."""

from _common_torch import parse_args

args = parse_args(__doc__, frames=600)

import numpy as np

from bevy_firework_tpu_torch import EffectModifier, Fleet, Transform
from bevy_firework_tpu_torch.models import effects

# one archetype for all bursts: impulse scales via EffectModifier instead of
# per-spawner settings (same visual effect, one compiled archetype)
spawner, _ = effects.one_shot(impulse=5.0)
fleet = Fleet(spawner, capacity=32, max_spawners=64, device=args.device)

# Simple host-side bouncing ball standing in for the avian rigid body.
pos = np.array([0.0, 3.0, 0.0])
vel = np.array([8.0, 0.0, 6.0])
bounds = np.array([3.0, 2.0, 3.0])

for f in range(args.frames):
    vel[1] -= 9.81 * args.dt
    pos += vel * args.dt
    if pos[1] < -2.0:
        impulse = abs(vel[1])
        slot = fleet.activate(
            Transform(translation=tuple(pos)),
            modifier=EffectModifier(scale=min(max(impulse / 10.0, 0.05), 1.0), speed=1.0),
        )
        pos[1] = -2.0
        vel[1] = -vel[1]
        print(f"frame {f}: impact (impulse {impulse:.1f}) -> burst slot {slot}")
    for axis in (0, 2):
        if abs(pos[axis]) > bounds[axis]:
            pos[axis] = np.sign(pos[axis]) * bounds[axis]
            vel[axis] = -vel[axis]
    fleet.step(args.dt)
    for slot in fleet.drain_finished():
        print(f"frame {f}: burst slot {slot} finished -> despawned")

print(f"end: live={fleet.alive_count()}, active slots={fleet.active_slots()}")
