"""The slice end to end: the verify flow through the port's public API and
the package boundary. The CUDA kernel's own tests are in
test_torch_kernel.py."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import bevy_firework_tpu_torch as pt
from bevy_firework_tpu_torch.ops import fused_step as fs
from bevy_firework_tpu_torch.ops import table_layout as L
from test_torch_common import _one_torch_thread, effect  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _sparks_flow(pkg):
    return pkg.ParticleSpawner(
        particle_settings=[pkg.ParticleSettings(lifetime=pkg.RandF32.constant(0.75))],
        emission_settings=[pkg.EmissionSettings(emission_pacing=pkg.EmissionPacing.rate(1000.0))],
    )


def test_sparks_flow_port():
    """The verify skill's sparks flow: 120 frames at 1/60, 750 live, 64 B
    per rendered instance."""
    c = pt.compile_spawner(_sparks_flow(pt), device="cpu")
    s = pt.init_pool_for(c, 2048)
    f = pt.make_frame_input(1 / 60)
    for _ in range(120):
        s, out, planes = pt.step_auto_packed(c.static, c.params, None, s, f)
    assert int(out.alive_count) == 750
    rows = pt.planes_to_rows(c.static, s, planes)
    assert rows.shape == (750, 16)
    assert len(pt.instances_to_bytes(rows)) == 750 * 64


def test_sparks_flow_jax_reference():
    import bevy_firework_tpu as jx

    scene = jx.Scene()
    scene.add_spawner(_sparks_flow(jx), capacity=2048)
    for _ in range(120):
        scene.step(1 / 60)
    assert scene.alive_count() == 750
    items = scene.render_items()
    assert len(jx.instances_to_bytes(items[0].instances)) == items[0].count * 64 == 750 * 64


def test_port_imports_no_jax():
    code = ("import sys, bevy_firework_tpu_torch, bevy_firework_tpu_torch.interop, "
            "bevy_firework_tpu_torch.models.effects, bevy_firework_tpu_torch.ops._build; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'bevy_firework_tpu.')) "
            "or m == 'bevy_firework_tpu']; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kernel_table_layout_matches_cuda_source():
    """The CUDA sources take every layout name (table slots, field slots,
    frame and field rows, the stats row, kinds, the float constants and the
    turbulence basis) from the header `table_layout` generates and define
    none themselves, so the wrapper and the kernels share one layout; every
    source the build compiles reaches it through the kernel header."""
    from bevy_firework_tpu_torch.ops import _build

    csrc = REPO / "bevy_firework_tpu_torch/ops/csrc"
    assert sorted(p.name for p in csrc.iterdir()) == sorted(_build.SOURCES + _build.HEADERS)
    for name in _build.SOURCES:
        assert '#include "fused_step_kernel.cuh"' in (csrc / name).read_text(), name
    code = re.sub(r"//.*", "", "".join((csrc / n).read_text() for n in _build.SOURCES + _build.HEADERS))
    assert '#include "table_layout.h"' in code
    own = {"TWO_PI", "PI_F"}  # the kernel's float constants
    generated = set(L.constants()) | set(L.float_constants()) | set(L.array_constants())
    assert set(re.findall(r"\b[A-Z][A-Z0-9_]+\b", code)) - generated == own
    assert set(re.findall(r"constexpr\s+\w+\s+(\w+)", code)) == own
    header = L.header()
    for name, value in L.constants().items():
        assert f"constexpr int {name} = {value};" in header
    for name, value in L.float_constants().items():
        assert f"constexpr float {name} = {value!r}f;" in header
        assert float(np.float32(value)) == value  # the literal is an f32 value
    for name, values in L.array_constants().items():
        assert f"__constant__ float {name}[{len(values)}] = {{{', '.join(f'{v!r}f' for v in values)}}};" in header
        assert all(float(np.float32(v)) == v for v in values)
    assert L.MAX_U == fs.MAX_UNROLL


def test_pack_tables_holds_the_spawner():
    sp, _tf = effect("torch", "stress_test")
    c = pt.compile_spawner(sp, device="cpu")
    w = fs.pack_tables(c.static, c.params)
    fl = w.view("float32")
    assert w[L.H_E] == 1 and w[L.H_SINGLE] == 1 and w[L.H_ELIDE_ROT] == 1 and w[L.H_CONST_LIFE] == 1
    assert fl[L.H_CONST_LIFE_VAL] == 1.0
    em = w[L.H_EM_AT]
    assert em == L.TY_AT + L.TY_STRIDE and w[L.H_T] == 1 and w.size == L.table_words(1, 1, w[L.H_K])
    assert fl[em + L.EM_COUNT] == 160000.0  # count per cycle
    shape = fl[em + L.EM_SHAPE:em + L.EM_SHAPE + 8]
    assert tuple(shape) == tuple(c.params.shape_params[0].tolist())
    assert fl[L.TY_AT + L.TY_LIN_DRAG] == c.params.linear_drag[0].item()
    assert w[L.TY_AT + L.TY_BASE_KIND] == 2 and w[L.TY_AT + L.TY_BASE_N] == 5  # the 5-knot uneven ember gradient


def test_wrapper_has_no_fallback_device():
    """Only CPU tensors take the plain version; other devices raise."""
    c = pt.compile_spawner(_sparks_flow(pt), device="cpu")
    s = pt.init_pool_for(c, 256).to("meta")
    with pytest.raises(ValueError, match="no step for device"):
        pt.step_auto(c.static, c.params, None, s, pt.make_frame_input(1 / 60))
