"""The XLA layout's captured chain on a card (`cuda` marker; skipped
without one): tests/torch_xla_graph_configs.py's cases at the test size,
the captured `multi_step` and `step_jit` == `_captured=False` bit for bit
over five calls (another seed, dt, transform and fields among them; for
sparks a sixth of 300 frames, longer than the graph's word rows), the
captured calls under sync debug mode "error". No JAX: on the card
    python -m pytest --noconftest -q tests/test_torch_xla_graph_card.py
The CPU's side, against the JAX package, is tests/test_torch_xla_graph.py."""

import pytest
import torch

from bevy_firework_tpu_torch.ops import chain_graph

import torch_xla_graph_configs as xla_cfg


@pytest.mark.cuda
@pytest.mark.parametrize("name", xla_cfg.CELLS)
def test_captured_equals_uncaptured(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a captured chain replays CUDA graphs")
    chain_graph.clear()  # the test size's two stress_test cells share a key
    counts = xla_cfg.check_captured(xla_cfg.build(name, "cuda", "test"))
    assert counts["captures"] == 1 and counts["replays"] == counts["calls"] and counts["live"] > 0
