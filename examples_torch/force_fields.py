"""Tornado: scene force fields driving dust motes (force_fields.py — beyond
the reference, whose acceleration is a per-type constant, core.rs:641-643).

The classic funnel recipe: a VORTEX swirls particles around the +Y axis, an
AXIAL field pulls them toward the funnel line, and the dust's own updraft
acceleration lifts them; high drag makes the field acceleration set the
steady-state velocity. Fields move/re-tune every frame with nothing rebuilt
(`scene.set_force_field` rewrites the field records the kernel reads) — the
funnel wanders across the ground plane."""

import math

from _common_torch import parse_args, run

args = parse_args(__doc__)

from bevy_firework_tpu_torch import ForceField, Scene
from bevy_firework_tpu_torch.models import library

scene = Scene(force_fields=[
    ForceField.vortex((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), strength=12.0, radius=6.0),
    ForceField.axial((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), strength=25.0, radius=7.0),
    ForceField.turbulence((0.0, 2.0, 0.0), strength=1.8, radius=8.0, frequency=2.2),
], device=args.device)
vortex_id, core_id = 0, 1
scene.add_spawner(library.dust(updraft=2.5, drag=2.0, emit_radius=1.2), capacity=8192)


def wander(f):
    # the funnel drifts: moving a field rewrites its record, nothing else
    x = 0.8 * math.sin(f * 0.02)
    z = 0.8 * math.cos(f * 0.017)
    scene.set_force_field(vortex_id, position=(x, 0.0, z))
    scene.set_force_field(core_id, position=(x, 0.0, z))


run(scene, args, on_frame=wander)
print(f"force fields: {len(scene._field_slots)} active; live {scene.alive_count()}")
