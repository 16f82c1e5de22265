"""The port's examples (`examples_torch/`) against the JAX package's
(`examples/`), on the CPU.

Each port script runs in this process with `--cpu` (the kernels' plain
versions) through runpy, at a few frames; where what it prints is
deterministic in both step layouts, the JAX script runs the same way in the
same test and the two printouts must agree. The port's Scene steps the
kernel's layout (Philox draws per lane), the JAX Scene on the CPU its XLA
step (threefry), so scenes whose numbers depend on draws agree only in
distribution: for them the invariant the JAX script prints is asserted.

One seam of the reference is allowed for, where named: XLA on the CPU
contracts the rate cadence's carry, so at a few frames in a hundred a
rate-driven count is one particle off the f32 cadence the port follows
(ROADMAP §3, "XLA contracts cadence sums on the CPU"). Live counts of
constant-lifetime scenes are held within one particle for it; everything
else is exact."""

import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

import bevy_firework_tpu as jx
import bevy_firework_tpu_torch as pt
from test_torch_common import _one_torch_thread  # noqa: F401
from torch_examples_run import (
    EXAMPLES,
    EXAMPLES_TORCH,
    REPO,
    SCRIPTS,
    lines_without_overlay,
    overlay_live,
    run_example,
)

CADENCE_SEAM = 1  # particles: XLA's contracted rate cadence on the CPU against the f32 cadence


def both(name, *args):
    """(port stdout, port globals), (JAX stdout, JAX globals) of one script."""
    return run_example(EXAMPLES_TORCH / name, "--cpu", *args), run_example(EXAMPLES / name, "--cpu", *args)


def test_every_example_has_its_counterpart():
    assert len(SCRIPTS) == 18
    assert sorted(p.name for p in EXAMPLES_TORCH.glob("*.py")) == sorted(SCRIPTS + ("_common_torch.py",))


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_without_cpu_needs_a_card(name, monkeypatch, tmp_path):
    """Without --cpu an example runs on the card and raises where there is
    none; it never runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_example(EXAMPLES_TORCH / name, "--out", tmp_path)
    assert not any(tmp_path.iterdir())


def test_examples_import_no_jax():
    """Every module the port's scripts import, imported in a fresh process,
    brings in neither jax nor the JAX package."""
    mods = set()
    for path in EXAMPLES_TORCH.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods |= {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods.add(node.module)
    assert "bevy_firework_tpu_torch" in mods and "_common_torch" in mods
    code = (f"import sys; sys.path[:0] = [{str(REPO)!r}, {str(EXAMPLES_TORCH)!r}]; "
            + "; ".join(f"import {m}" for m in sorted(mods))
            + "; bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'bevy_firework_tpu.')) "
              "or m == 'bevy_firework_tpu']; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sparks_matches_jax():
    """750 live at steady state and the render item's 750 x 64 B, as the JAX
    script prints them; the overlay's counts within the cadence seam."""
    (out, g), (jout, _jg) = both("sparks.py", "--frames", 120)
    assert lines_without_overlay(out) == lines_without_overlay(jout) == ["render items: 1; instances: 750 x 64 B"]
    items = g["items"]
    assert len(pt.instances_to_bytes(items[0].instances)) == items[0].count * 64 == 750 * 64
    assert np.abs(np.subtract(overlay_live(out), overlay_live(jout))).max() <= CADENCE_SEAM


def test_pbr_uniform_matches_jax():
    (out, g), (jout, _jg) = both("pbr.py", "--frames", 60)
    assert lines_without_overlay(out) == lines_without_overlay(jout)
    u = g["item"].uniform
    assert (u.pbr, u.fade_scene) == (1, 3.5)


def test_on_demand_matches_jax():
    """The clicks' frames and the live count, line for line."""
    (out, _g), (jout, _jg) = both("on_demand.py", "--frames", 150)
    lines = lines_without_overlay(out)
    assert lines == lines_without_overlay(jout)
    assert lines[0] == "frame 0: click -> queue_particles(1)" and lines[-1].startswith("end: live=")
    assert overlay_live(out) == overlay_live(jout)


def _min_y_at(monkeypatch, scene_cls, at):
    """Wrap scene_cls.step so that after the steps numbered `at` the minimum
    y of the live particles is recorded (the JAX script's min_y(), which it
    prints to 3 decimals, to full precision)."""
    seen, step = [], scene_cls.step

    def recorded(self, dt):
        step(self, dt)
        recorded.n += 1
        if recorded.n in at:
            st = next(iter(self._spawners.values())).state
            seen.append(float(np.asarray(st.py)[np.asarray(st.alive)].min()))

    recorded.n = 0
    monkeypatch.setattr(scene_cls, "step", recorded)
    return seen


def test_dynamic_colliders_matches_jax(monkeypatch):
    """The four minimum-y readings (held at 0, falling, held again, held at
    -1) within 1e-5 of the JAX script's; no kernel built or loaded during
    the edits, the freed slot reused."""
    want = _min_y_at(monkeypatch, jx.Scene, (90, 130, 220, 310))
    (out, g), (jout, _jg) = both("dynamic_colliders.py")
    got = g["readings"]
    assert len(got) == len(want) == 4
    assert np.abs(np.subtract(got, want)).max() <= 1e-5, (got, want)
    assert abs(got[0]) < 1e-3 and got[1] < -1.0 and abs(got[2]) < 1e-3 and abs(got[3] + 1.0) < 1e-3
    assert out.splitlines()[:4] == jout.splitlines()[:4]
    assert g["rebuilds"] == 0 and g["slot_reused"]
    assert "across all collider edits: 0 (expected 0); freed slot 0 reused: True" in out


@pytest.mark.parametrize("name,frames", [("stress_test.py", 20), ("force_fields.py", 120)])
def test_cadence_counts_match_jax(name, frames):
    """Rate-driven scenes before any particle reaches its lifetime, so that
    the cadence alone decides the live count the scripts print: within the
    cadence seam."""
    (out, g), (jout, jg) = both(name, "--frames", frames)
    live, jlive = g["scene"].alive_count(), jg["scene"].alive_count()
    assert live > 0 and abs(live - jlive) <= CADENCE_SEAM, (live, jlive)
    if name == "force_fields.py":
        assert out.splitlines()[-1] == f"force fields: 3 active; live {live}"
        assert live == 1784  # the f32 cadence's count at frame 120 (the verify flow)
    else:
        assert f"steady-state live: {live}" in out


def test_stress_test_collision_runs():
    """One frame: its 262144 lanes against two cuboids take the plain
    version seconds per frame here (the card's chip_smoke runs it whole)."""
    out, g = run_example(EXAMPLES_TORCH / "stress_test_collision.py", "--cpu", "--frames", 1)
    live = g["scene"].alive_count()
    assert live > 0 and f"steady-state live: {live}" in out


def test_collision_stays_over_the_floor():
    """The JAX script's invariant: particles over the 8x8 floor stay above
    its top (y = 0) within the bounce's tolerance."""
    out, g = run_example(EXAMPLES_TORCH / "collision.py", "--cpu", "--frames", 180)
    assert g["over_floor"].sum() > 0 and g["ys"][g["over_floor"]].min() >= -1e-4
    assert out.splitlines()[-1].startswith(f"live={g['alive'].sum()}  over-floor={g['over_floor'].sum()}")


def test_textures_draws_both_types():
    """Shells (type 0) and their nested smoke (type 1) both live, one draw
    each, the shells textured."""
    out, g = run_example(EXAMPLES_TORCH / "textures.py", "--cpu", "--frames", 150)
    assert (g["tys"] == 0).sum() > 0 and (g["tys"] == 1).sum() > 0
    items = g["scene"].render_items()
    assert sorted(i.type_index for i in items) == [0, 1]
    assert items[0].uniform.flags == 7 and items[0].textures[0].endswith("diffuse.png")
    assert "draw: type 1" in out


def test_trails_draw_segments():
    out, g = run_example(EXAMPLES_TORCH / "trails.py", "--cpu", "--frames", 60)
    assert g["n_seg"] > 0 and out.splitlines()[-1] == f"trail items: 1; segments: {g['n_seg']} x 64 B"


def test_fireworks_writes_its_png(tmp_path):
    out, g = run_example(EXAMPLES_TORCH / "fireworks.py", "--cpu", "--frames", 90, "--out", tmp_path)
    png = tmp_path / "firework_showcase.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and g["path"] == str(png)
    assert g["scene"].alive_count() > 0 and out.splitlines()[-1].endswith(str(png))


@pytest.mark.parametrize("f16", [False, True])
def test_render_loop(f16):
    """Frames drawn, and the final frame's rows equal the live count of the
    frame it names; the f16 record is float16."""
    out, g = run_example(EXAMPLES_TORCH / "render_loop.py", "--cpu", "--frames", 8, *(["--f16"] if f16 else []))
    rows, fid, live = g["final"]
    assert g["drawn"] > 0 and rows == live > 0 and 0 <= fid < 8
    assert f"dtype {'float16' if f16 else 'float32'}" in out and f"f16={f16}" in out
