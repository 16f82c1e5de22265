"""The Scene facade's host time per Scene.step call (set_transform included),
from the benchmark's spans in the window."""

from benchmark.harness import readers


def read(ctx):
    return readers.host_us_per_frame(ctx)
