"""examples_torch/one_shot.py against examples/one_shot.py, on the CPU: a
host-side ball (numpy, deterministic) activates a 20-particle burst per
impact in a `Fleet` of 64 slots, each despawned when its finished event
fires. The port's Fleet steps every slot through the fleet kernel's plain
version here (one slot at a time), so this comparison has a file of its
own."""

from test_torch_common import _one_torch_thread  # noqa: F401
from torch_examples_run import EXAMPLES, EXAMPLES_TORCH, run_example


def test_one_shot_matches_jax():
    """The host-side ball is numpy and deterministic: the impact lines, the
    finished bursts and the live count equal the JAX script's."""
    out, g = run_example(EXAMPLES_TORCH / "one_shot.py", "--cpu", "--frames", 212)
    jout, _jg = run_example(EXAMPLES / "one_shot.py", "--cpu", "--frames", 212)
    assert out.splitlines() == jout.splitlines()
    assert out.splitlines()[:3] == ["frame 60: impact (impulse 10.0) -> burst slot 0",
                                    "frame 182: impact (impulse 10.0) -> burst slot 1",
                                    "frame 210: burst slot 0 finished -> despawned"]
    assert g["fleet"].active_slots() == [1]
