"""Collision demo (reference: `examples/collision.rs`): tilted ember fountain
bouncing off a cuboid base with restitution 0.6 / friction 0.2."""

from _common_torch import parse_args, run

args = parse_args(__doc__, frames=420)

import numpy as np

from bevy_firework_tpu_torch import Scene
from bevy_firework_tpu_torch.models import effects

spawner, tf, colliders = effects.collision()
scene = Scene(colliders=colliders, device=args.device)
sid = scene.add_spawner(spawner, capacity=2048, transform=tf)
run(scene, args)

# particles above the 8x8 floor (|x|,|z| < 4) bounce and stay above its top
# (y=0); ones that arc past the edge keep falling — same as the reference.
st = scene._spawners[sid].state
alive = st.alive.cpu().numpy()
xs, ys, zs = (a.cpu().numpy()[alive] for a in (st.px, st.py, st.pz))
over_floor = (np.abs(xs) < 4) & (np.abs(zs) < 4)
print(f"live={alive.sum()}  over-floor={over_floor.sum()}  min y over floor={ys[over_floor].min():.4f} (>= ~0)")
