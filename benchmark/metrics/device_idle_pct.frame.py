"""The share of a frame cell's traced slice (after the window) with no kernel
and no copy on the device."""

from benchmark.harness import readers


def read(ctx):
    return readers.idle_pct(ctx)
