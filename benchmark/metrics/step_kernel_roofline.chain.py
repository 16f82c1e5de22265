"""The step kernel's share of its roofline over a chain cell's traced launches."""

from benchmark.harness import readers


def read(ctx):
    return readers.step_roofline_pct(ctx)
