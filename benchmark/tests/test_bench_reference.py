"""The configurations load into the port and into the plain reference; the
count functions give the kernel table's bounds; the reference's imports."""

from __future__ import annotations

import ast

import numpy as np
import pytest
import torch

from toycells import ROOT, cells, toy

from benchmark.harness import counts, program, spec
from benchmark.reference import plain

CONFIGS = [c["name"] for c in spec.benchmark()["configs"]]


def _config(name):
    entry = {c["name"]: c for c in spec.benchmark()["configs"]}[name]
    return spec.load_json(ROOT / entry["file"])


@pytest.mark.parametrize("name", CONFIGS)
def test_config_loads_into_port_and_reference(name):
    cfg = _config(name)
    prog = program.build(cfg, "cpu")
    ref = plain.parse_config(cfg)
    assert prog.capacity == ref.capacity == cfg["capacity"]
    assert prog.static.const_lifetime == ref.lifetime
    assert prog.static.elide_rotation
    assert len(ref.colliders) == len(cfg["colliders"])
    assert float(prog.params.count[0]) == np.float32(cfg["rate"])
    # the reference works the emitter's rows out again, bit for bit
    for e, em in enumerate(ref.emitters):
        assert np.array_equal(prog.params.shape_params[e].numpy(), em.shape)
        assert np.array_equal(prog.params.ivel_params[e].numpy(), em.ivel)


def test_counts_give_the_kernel_tables_bounds():
    cfg = dict(_config("stress_test_10M"))
    for lanes, us in ((131072, 2.50), (1310720, 25.04)):
        cfg["capacity"] = lanes
        b = counts.step_bound_s(cfg, 1, 0, 8, int(0.75 * lanes))
        assert b["bound_by"] == "bytes"
        assert round(b["bound_s"] * 1e6, 2) == us
    cfg["capacity"] = 1310720  # the f32 render pack: 39.13 us (kernel table row 2)
    assert round(counts.step_bound_s(cfg, 1, 1, 1, 0)["bound_s"] * 1e6, 2) == 39.13


@pytest.mark.parametrize("name", ["stress_10M.chain", "collision_1M.chain"])
def test_reference_matches_the_ports_plain_step(name):
    """On the CPU the port steps its plain version, which the card's kernel
    equals up to sinf/cosf: the reference, written apart, gives the same
    bits."""
    cell = toy(name, 2048)
    prog = program.build(cell.config, "cpu")
    bt = prog.bt
    st = bt.init_pool_for(prog.compiled, prog.capacity, seed=77)
    frame = bt.make_frame_input(1 / 60, translation=prog.translation, rotation=prog.rotation)
    st, _o = bt.multi_step_auto(prog.static, prog.params, prog.colliders, st, frame, 40)
    inp = program.state_dict(st)
    out, _o = bt.multi_step_auto(prog.static, prog.params, prog.colliders, st, frame, 8)
    cfg = plain.parse_config(cell.config)
    ref, _p = plain.run_frames(cfg, inp, plain.Frame(1 / 60, cfg.translation, cfg.rotation), 8, chunk=700)
    got = program.state_dict(out)
    assert (ref["age"] < ref["lifetime"]).any()
    for k in plain.LANE_FIELDS:
        assert torch.equal(got[k], ref[k]), k
    assert got["rng_key"] == ref["rng_key"] and got["ring_cursor"] == ref["ring_cursor"]


def test_reference_steps_lane_ranges_and_frame_lists_alike():
    """Stepping only some lane ranges gives those lanes' bits of the whole
    pool's run, and a list of n equal Frames gives the one Frame's."""
    cfg = plain.parse_config(toy("collision_1M.chain", 2048).config)
    st = plain.initial_state(cfg, 5, "cpu")
    fr = plain.Frame(1 / 60, cfg.translation, cfg.rotation)
    full, _p = plain.run_frames(cfg, st, fr, 30, chunk=512)
    ranges = [(100, 300), (1500, 2048)]
    part, _p = plain.run_frames(cfg, st, [fr] * 30, 30, chunk=512, ranges=ranges)
    for k in plain.LANE_FIELDS:
        assert torch.equal(part[k], torch.cat([full[k][a:b] for a, b in ranges])), k
    assert part["rng_key"] == full["rng_key"] and part["ring_cursor"] == full["ring_cursor"]
    with pytest.raises(ValueError):
        plain.run_frames(cfg, st, [fr] * 3, 4)


def test_sample_ranges_are_drawn_from_the_seed():
    from benchmark.harness import base

    big = 2**31 + 123456789
    r = base.sample_ranges(10485760, big)
    assert r == base.sample_ranges(10485760, big) and r != base.sample_ranges(10485760, big + 1)
    assert sum(b - a for a, b in r) == base.SAMPLE_LANES and len(r) == base.SAMPLE_BLOCKS
    assert all(0 <= a < b <= 10485760 for a, b in r) and all(r[i][1] <= r[i + 1][0] for i in range(len(r) - 1))
    assert base.sample_ranges(4096, big) == [(0, 4096)]


def test_scalar_chain_matches_the_per_frame_cadence():
    cfg = plain.parse_config(toy("stress_10M.chain", 4096).config)
    frames, (tic, last, cursor) = plain.cadence(cfg, np.zeros(1, np.float32), np.zeros(1, np.float32), 0, 1 / 60, 97)
    run = plain.scalar_chain(cfg, 97, 1 / 60)
    assert np.array_equal(run["time_in_cycle"], tic) and np.array_equal(run["last_emission"], last)
    assert run["ring_cursor"] == cursor


FORBIDDEN = {"jax", "jaxlib", "flax", "bevy_firework_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    for path in spec.BENCH_DIR.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (spec.BENCH_DIR / "reference").rglob("*.py"):
        assert "bevy_firework_tpu_torch" not in set(_imports(path)), path


def test_every_cell_has_a_toy_size():
    for name in cells():
        assert toy(name).config["capacity"] == 4096
