"""The card's peaks and the step kernel's least work per launch.

Bounds follow the roofline rule: the least time of a launch is the larger
of the bytes it must move over the memory rate and the float32 operations
it must do over the peak rate. Bytes: each input plane read once and each
output plane written once, whatever the kernel reads again and whatever U
(frames per launch) it runs: the pool's active planes in and out, and a
packing launch's render planes out. Operations: the integrate path's
float32 operations per live lane and frame (age, move, gravity and drag),
counted from the step as lower bounds: spawn draws, curves, libm calls and
the narrow phase are not counted, so a bound is never too high.
"""

from __future__ import annotations

# An H100 SXM's published peaks at 700 W (NVIDIA's data sheet): HBM3
# bandwidth and float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
INTEGRATE_OPS = 20  # per live lane and frame
F32_BYTES = 4
RENDER_PLANES = 9  # the render pack: instance scale, base rgba, emissive rgba (float32)


def active_planes(config: dict) -> int:
    """Float32 planes a step launch reads and writes: position and
    velocity, initial scale and age; a lifetime plane unless every type's
    lifetime is one constant; seven rotation planes unless rotation is
    elided; a type plane past one type."""
    sp = config["spawner"]
    types = sp["particle_settings"]
    ems = sp["emission_settings"]
    lifetimes = {(t["lifetime"]["min"], t["lifetime"]["max"]) for t in types}
    const_life = len(lifetimes) == 1 and next(iter(lifetimes))[0] == next(iter(lifetimes))[1]
    rotation = not (all(tuple(e["initial_rotation"]) == (0.0, 0.0, 0.0, 1.0) for e in ems)
                    and all(e["initial_angular_velocity"]["magnitude"]["min"] == 0.0
                            and e["initial_angular_velocity"]["magnitude"]["max"] == 0.0 for e in ems)
                    and all(tuple(t["angular_acceleration"]) == (0.0, 0.0, 0.0) for t in types))
    return 8 + (0 if const_life else 1) + (7 if rotation else 0) + (1 if len(types) > 1 else 0)


def launch_bytes(config: dict, packed: bool) -> int:
    """Bytes one step launch must move at the configuration's capacity."""
    n = int(config["capacity"])
    planes = 2 * F32_BYTES * active_planes(config) * n
    return planes + (F32_BYTES * RENDER_PLANES * n if packed else 0)


def step_bound_s(config: dict, launches: int, packed_launches: int, frames: int, live: int) -> dict:
    """The least device time of `launches` step launches (of which
    `packed_launches` pack the render planes) that step `frames` frames
    of `live` lanes: the larger of the summed bytes over the memory rate
    and the summed operations over the peak rate. Per launch the larger of
    the two summed would be no smaller, so this bound never reads above
    the launches' own."""
    n_bytes = (launches - packed_launches) * launch_bytes(config, False) + packed_launches * launch_bytes(config, True)
    n_ops = frames * INTEGRATE_OPS * live
    by_bytes, by_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_PER_S
    return {"bound_s": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": n_bytes, "ops": n_ops}
