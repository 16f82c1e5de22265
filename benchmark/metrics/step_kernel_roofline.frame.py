"""The step kernel's share of its roofline over a frame cell's traced launches
(the render pack's planes counted)."""

from benchmark.harness import readers


def read(ctx):
    return readers.step_roofline_pct(ctx)
