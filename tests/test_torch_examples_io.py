"""The port's examples that write files or start processes, and its
`utils/profiling`, on the CPU.

The viewers' pages are the JAX scripts' templates character for character
(the reference's sources cited by project name, `cite`), and the WebGPU page's pipeline descriptor is the JAX package's
`PipelineCache().specialize(key_for(...))` for the same key (called here,
not by running the JAX exporter). lights and render_preview write their
PNGs; multichip's ranks run over gloo on the CPU, each case held against
the unsharded steps. `FrameStats` equals the JAX package's under the same
clock."""

import ast
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

import bevy_firework_tpu_torch as pt
from bevy_firework_tpu.shaders import ribbons_wgsl_source as jax_ribbons_wgsl_source
from bevy_firework_tpu.shaders.specialize import ALPHA_BLEND, PipelineCache, key_for
from bevy_firework_tpu.utils import profiling as jprofiling
from bevy_firework_tpu_torch.models import effects
from bevy_firework_tpu_torch.ops.fused_step import multi_step_auto
from bevy_firework_tpu_torch.utils import profiling
from test_torch_common import _one_torch_thread  # noqa: F401
from torch_examples_run import EXAMPLES, EXAMPLES_TORCH, REPO, run_example

PNG = b"\x89PNG\r\n\x1a\n"


def template(path, name):
    """The string literal a script assigns to `name` (its page template)."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and [t.id for t in node.targets] == [name]:
            return node.value.value
    raise KeyError(name)


def cite(text: str) -> str:
    """The JAX package's text with the reference's sources cited by project
    name, as the port's copies cite them (the JAX package cites them by a
    local checkout's path, `/<dir>/reference/src/...`)."""
    return re.sub(r"/\w+/reference/", "bevy_firework ", text)


def code(wgsl: str) -> str:
    """WGSL without its `//` comments."""
    return re.sub(r"//[^\n]*", "", wgsl)


def test_web_viewer_page(tmp_path):
    out, g = run_example(EXAMPLES_TORCH / "web_viewer.py", "--cpu", "--frames", 3, "--out", tmp_path)
    assert g["html"] == cite(template(EXAMPLES / "web_viewer.py", "html"))
    page = (tmp_path / "web_viewer.html").read_text()
    assert page == g["html"].replace("__FRAMES__", json.dumps(g["frames"]))
    last = g["frames"][-1]
    assert len(g["frames"]) == 3 and last[0]["count"] == g["scene"].alive_count() > 0
    assert f"{last[0]['count']} instances in last frame" in out


@pytest.mark.parametrize("flags,key", [
    ((), dict(fog=False, lights=False, shadow_atlas=False)),
    (("--fog", "--lights"), dict(fog=True, lights=True, shadow_atlas=True)),
    (("--scene", "comets"), dict(fog=False, lights=False, shadow_atlas=False)),
])
def test_webgpu_viewer_descriptor(tmp_path, flags, key):
    """The embedded DESC is the JAX package's specialization of the same
    key, the page its template, the ribbon shader (comets) its source. The
    shaders are compared without their `//` comments: the port's copies
    cite the reference's upstream sources by name, not by a local path
    (tests/test_torch_shaders.py holds the rest of them equal)."""
    out, g = run_example(EXAMPLES_TORCH / "webgpu_viewer.py", "--cpu", "--frames", 3, "--warmup", 30,
                         "--out", tmp_path, *flags)
    assert g["HTML"] == cite(template(EXAMPLES / "webgpu_viewer.py", "HTML"))
    page = (tmp_path / "webgpu_viewer.html").read_text()
    desc = json.loads(re.search(r"const DESC = (.*?);      // SpecializedPipeline", page).group(1))
    want = dataclasses.asdict(PipelineCache().specialize(key_for(ALPHA_BLEND, depth_prepass=True, shadow_map=True,
                                                                 **key)))
    del want["key"]
    want["shader_source"], desc["shader_source"] = code(want["shader_source"]), code(desc["shader_source"])
    assert {k: desc[k] for k in want} == json.loads(json.dumps(want))
    assert set(desc) - set(want) == ({"fog_uniform", "lights_uniform", "shadow_atlas_uniform", "shadow_atlas_grid",
                                      "shadow_atlas_tiles"} if key["lights"] else set())
    ribbon = json.loads(re.search(r"const RIBBON_WGSL = (.*?);  // shipped", page).group(1))
    if flags[-1:] == ("comets",):
        assert code(ribbon) == code(jax_ribbons_wgsl_source())
    else:
        assert ribbon is None
    assert "shader defs" in out and len(g["frames"]) == 3


def test_lights_writes_its_pngs(tmp_path):
    out, _g = run_example(EXAMPLES_TORCH / "lights.py", "--cpu", "--frames", 30, "--out", tmp_path)
    names = ("lights.png", "lights_shadow.png", "lights_builtin.png", "lights_env.png")
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(names)
    assert all((tmp_path / n).read_bytes()[:8] == PNG for n in names)
    assert str(tmp_path) in out


def test_render_preview_writes_its_pngs(tmp_path):
    out, g = run_example(EXAMPLES_TORCH / "render_preview.py", "--cpu", "--frames", 20, "--out", tmp_path)
    names = [f"firework_{n}.png" for n in ("sparks", "collision", "textures")]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(names)
    assert all((tmp_path / n).read_bytes()[:8] == PNG for n in names)
    assert [line.split(":")[0] for line in out.splitlines()] == ["sparks", "collision", "textures"]
    assert all(s.alive_count() > 0 for s, _cam in g["scenes"].values())


def test_multichip_on_two_gloo_ranks():
    """sp, dp, 2d and nested sp over two gloo ranks on the CPU: sp's and
    nested sp's live counts equal the unsharded steps the script runs on
    rank 0 (multi_step_auto; xla_step.multi_step), dp's and 2d's equal the
    same pools stepped unsharded here."""
    frames = 30  # nested sp: 40 frames, the first rockets up
    proc = subprocess.run([sys.executable, str(EXAMPLES_TORCH / "multichip.py"), "--cpu", "--ranks", "2", "--frames",
                           str(frames)], cwd=REPO, capture_output=True, text=True, timeout=140,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert [line.split(":")[0] for line in lines] == ["ranks", "sp", "dp", "2d", "nested sp"]
    assert lines[0] == "ranks: 2 x cpu (gloo)"
    sp = re.search(r"sp: (\d+) live .*unsharded multi_step_auto: (\d+)\)", lines[1])
    assert int(sp.group(1)) == int(sp.group(2)) > 0
    nested = re.search(r"nested sp: (\d+) live (\[\d+, \d+\]) .*unsharded xla_step.multi_step: (\[\d+, \d+\])\)",
                       lines[4])
    assert nested.group(2) == nested.group(3) and int(nested.group(1)) > 0
    c = pt.compile_spawner(effects.sparks(rate=3000.0)[0], device="cpu")

    def unsharded(n, seed, n_frames, translation=(0.0, 0.0, 0.0)):
        frame = pt.make_frame_input(1 / 60, translation=translation)
        return int(multi_step_auto(c.static, c.params, None, pt.init_pool_for(c, n, seed), frame, n_frames)[1]
                   .alive_count)

    assert lines[2].startswith(f"dp: 4 spawners x {unsharded(4096, 0, frames)} live each")
    total_2d = sum(unsharded(2 * 1024, 100 + i, frames * 2 // 3) for i in range(2))
    assert lines[3].endswith(f"{total_2d} live total") and "over 1 host(s)" in lines[3]


def test_frame_stats_matches_jax(monkeypatch):
    """The same clock readings give every field and the overlay of the JAX
    package's FrameStats."""
    clock = iter([0.0, 0.0, 0.0166, 0.0166, 0.0341, 0.0341, 0.05, 0.05, 0.0667, 0.0667, 0.09, 0.09])
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    ours, theirs = profiling.FrameStats(), jprofiling.FrameStats()
    for particles in (0, 750, 750, 751, 749, 750):
        ours.tick(particles)
        theirs.tick(particles)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.overlay() == theirs.overlay()
    assert ours.frames == 6 and ours.fps > 0


def test_trace_holds_an_annotated_span(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("examples_torch.step"):
            torch.ones(64).cumsum(0)
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "examples_torch.step" in names
    assert "examples_torch.step" in {e.key for e in prof.key_averages()}


def test_device_memory_stats(monkeypatch):
    assert profiling.device_memory_stats("cpu") == {"cpu": None}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.device_memory_stats()
