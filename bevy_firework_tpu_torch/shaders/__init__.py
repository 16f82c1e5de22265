"""Shipped render-contract shaders + a static WGSL checker + specializer.

`particles.wgsl` is the render-contract consumer (docs/RENDER_CONTRACT.md)
with naga_oil-style `#ifdef` shader-def blocks; `specialize.PipelineCache`
resolves the variants exactly as the reference's `FireworkSpecializer`
does (bevy_firework `src/render.rs:805-867`); `wgsl_check.check_wgsl`
gives CI a compiler-free regression gate over every reachable variant.
"""

import os

SHADER_DIR = os.path.dirname(__file__)


def particles_wgsl_source() -> str:
    """Raw shader source, shader-def directives included. Pass through
    `specialize.preprocess` (or use `specialize.PipelineCache`) to obtain
    compilable WGSL for a concrete pipeline key."""
    with open(os.path.join(SHADER_DIR, "particles.wgsl")) as f:
        return f.read()


def ribbons_wgsl_source() -> str:
    """The trail-segment consumer (docs/RENDER_CONTRACT.md §3b — beyond the
    reference's feature set). No shader defs; compilable as-is."""
    with open(os.path.join(SHADER_DIR, "ribbons.wgsl")) as f:
        return f.read()
