"""Dynamic collider pool demo: add, remove, and move colliders at runtime
with nothing rebuilt (an active mask + slot reuse in the collider table the
kernel reads; the avian analog is freely spawning/despawning collider
entities, which the reference picks up automatically through its spatial
query, bevy_firework `src/core.rs:756`).

A steady stream rains onto a floor; mid-run the floor is removed (particles
fall through), re-added (bounce resumes — the freed slot is reused, so the
table keeps its layout), then lowered in place. Every edit only marks the
Scene's collider table for a rebuild of its values: no kernel is built or
loaded again (on the card the kernel library is built and loaded once, at
the first step)."""

from _common_torch import parse_args

args = parse_args(__doc__, frames=240)

from bevy_firework_tpu_torch import (
    Collider,
    EmissionPacing,
    EmissionSettings,
    ParticleCollisionSettings,
    ParticleSettings,
    ParticleSpawner,
    RandF32,
    RandVec3,
    Scene,
    Transform,
)
from bevy_firework_tpu_torch.ops import _build

spawner = ParticleSpawner(
    particle_settings=[
        ParticleSettings(
            lifetime=RandF32.constant(0.6),
            collision_settings=ParticleCollisionSettings(restitution=0.7),
        )
    ],
    emission_settings=[
        EmissionSettings(
            emission_pacing=EmissionPacing.rate(2000.0),
            initial_velocity=RandVec3.constant((0.0, -5.0, 0.0)),
        )
    ],
)

scene = Scene(colliders=[Collider.halfspace(position=(0, 0, 0))], device=args.device)
sid = scene.add_spawner(spawner, transform=Transform(translation=(0, 1.5, 0)))
(floor_id,) = list(scene._collider_ids.keys())
floor_slot = scene._collider_ids[floor_id]


readings = []  # the four minimum-y readings


def min_y():
    st = scene._spawners[sid].state
    alive = st.alive.cpu().numpy()
    readings.append(float(st.py.cpu().numpy()[alive].min()))
    return readings[-1]


def library_loads():
    """Loads of the kernel library (each a build where its sources'
    library is missing): `_build.load`'s cache misses."""
    return _build.load.cache_info().misses


for _ in range(90):
    scene.step(args.dt)
print(f"floor on:      min y = {min_y():+.3f}  (held at 0)")
loads0 = library_loads()  # the first step's build and load are done; edits start here

scene.remove_collider(floor_id)
for _ in range(40):
    scene.step(args.dt)
print(f"floor removed: min y = {min_y():+.3f}  (falling through)")

floor_id = scene.add_collider(Collider.halfspace(position=(0, 0, 0)))
for _ in range(90):
    scene.step(args.dt)
print(f"floor back:    min y = {min_y():+.3f}  (held again, slot reused)")
slot_reused = scene._collider_ids[floor_id] == floor_slot and len(scene._collider_slots) == 1

scene.set_collider(floor_id, position=(0, -1.0, 0))
for _ in range(90):
    scene.step(args.dt)
print(f"floor lowered: min y = {min_y():+.3f}  (held at -1)")

rebuilds = library_loads() - loads0
print(f"kernel builds or library loads across all collider edits: {rebuilds} (expected 0); "
      f"freed slot {floor_slot} reused: {slot_reused} (table of {len(scene._collider_slots)} collider)")
assert rebuilds == 0
assert slot_reused
