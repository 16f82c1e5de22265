"""Device time per frame of every kernel and copy but the step kernel's (the
graph's copy-in and clone-out, PyTorch's kernels), from the traced slice."""

from benchmark.harness import readers


def read(ctx):
    return readers.nonstep_us_per_frame(ctx)
