"""The production render loop: pipelined sim + async extract + ring hand-off.

The deployment shape for 1M-scale rendering (SURVEY.md §7 hard part 6;
the analog of Bevy's pipelined main/render worlds, `render.rs:52-54`):

  sim loop:     step_auto_packed (the render pack rides the step kernel)
                -> reader.submit_packed (non-blocking; planes still on the card)
  reader thread: card->host copy on a copy stream + native-ring compaction/interleave
  render loop:  ring.acquire() -> newest [count, 16] instance rows -> draw

On the card every frame is one launch of the step kernel with its render
pack (`--f16`: the f16 record, 32 B/particle); with `--cpu` the kernel's
plain version packs the same planes. The loop is the same on both.

Run: python examples_torch/render_loop.py [--cpu] [--frames N] [--f16]
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _common_torch import add_device_args, device_of

_p = argparse.ArgumentParser(description=__doc__)
_p.add_argument("--frames", type=int, default=240)
_p.add_argument("--f16", action="store_true", help="full-f16 in-kernel pack (32 B/particle)")
add_device_args(_p)
_a = _p.parse_args()
device = device_of(_a)
frames = _a.frames
f16 = _a.f16

from bevy_firework_tpu_torch import compile_spawner, init_pool_for, make_frame_input
from bevy_firework_tpu_torch.models import effects
from bevy_firework_tpu_torch.ops.fused_step import fused_step, step_auto_packed
from bevy_firework_tpu_torch.render_pipeline import AsyncRenderReader
from bevy_firework_tpu_torch.settings import EmissionPacing

spawner, _tf = effects.stress_test()
es = dataclasses.replace(spawner.emission_settings[0], emission_pacing=EmissionPacing.rate(30_000.0))
spawner = dataclasses.replace(spawner, emission_settings=(es,))

compiled = compile_spawner(spawner, device=device)
capacity = 8 * 8192
state = init_pool_for(compiled, capacity, seed=0)
frame = make_frame_input(1.0 / 60.0)

reader = AsyncRenderReader(capacity=capacity, num_types=compiled.num_types)
acquire = (lambda: reader.acquire_f16(0)) if f16 else (lambda: reader.acquire(0))

live = []  # each frame's live count (a device scalar: nothing waits for the card)
drawn = 0
last_fid = -1
t0 = time.perf_counter()
for fid in range(frames):
    if f16:  # full f16 record from the kernel (32 B/particle hand-off)
        state, outputs, planes = fused_step(compiled.static, compiled.params, None, state, frame, pack_render="f16")
    else:
        state, outputs, planes = step_auto_packed(compiled.static, compiled.params, None, state, frame)
    live.append(outputs.alive_count)
    reader.submit_packed(compiled.static, state, planes, fid)

    # "draw": acquire the newest ready frame, consume, release
    got = acquire()
    if got is not None:
        rows, got_fid = got
        if got_fid != last_fid:
            drawn += 1
            last_fid = got_fid
        reader.release(0)

elapsed = time.perf_counter() - t0
# drain the last frame
time.sleep(0.3)
final = None
got = acquire()
if got is not None:
    rows, fid = got
    final = (rows.shape[0], fid, int(live[fid]))
    print(f"final frame {fid}: {rows.shape[0]} instances (live {final[2]}), dtype {rows.dtype}")
    reader.release(0)
reader.close()
print(
    f"{frames} sim frames in {elapsed:.2f}s "
    f"({elapsed / frames * 1e3:.2f} ms/frame wall, "
    f"device={device}, f16={f16}); rendered {drawn} distinct frames"
)
