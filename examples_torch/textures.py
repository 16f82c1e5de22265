"""Textured shells + nested smoke (reference: `examples/textures.rs`):
spinning textured PBR shell casings (12/s) collide with a cylinder base and a
cone; each shell emits 6 smoke puffs in the first 10% of its life (nested
emission). ~60 shells + ~140 smoke = ~200 live."""

from _common_torch import parse_args, run

args = parse_args(__doc__, frames=420)

from bevy_firework_tpu_torch import Scene
from bevy_firework_tpu_torch.models import effects

spawner, tf, colliders = effects.textures()
scene = Scene(colliders=colliders, device=args.device)
sid = scene.add_spawner(spawner, capacity=2048, transform=tf)
run(scene, args)

st = scene._spawners[sid].state
alive = st.alive.cpu().numpy()
tys = st.ptype.cpu().numpy()[alive]
print(f"shells (type 0): {(tys == 0).sum()}, smoke (type 1): {(tys == 1).sum()}")
for item in scene.render_items():
    print(f"draw: type {item.type_index}, {item.count} instances, flags={item.uniform.flags}, textures={item.textures}")
