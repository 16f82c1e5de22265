"""The captured chain's own host time (key words, pinned copy, replay and
clone-out enqueue) per frame: the benchmark's spans around multi_step_auto
calls in the traced run's host probe, each call made after a synchronize,
so that no wait on the card (the pinned word buffer of two replays back)
falls into it; the median call's seconds over its frames."""

from benchmark.harness import readers


def read(ctx):
    return readers.host_us_per_frame(ctx)
