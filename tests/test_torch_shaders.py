"""The port's shaders package (copied from the JAX package) against the JAX
package's: the shipped WGSL, the shader-def preprocessor, the pipeline
specializer over every key, the dummy resources, and the static and type
checkers on the shipped variants and on the reference tests' mutations.

The port's .wgsl files equal the reference's byte for byte except four
comment lines: where the reference names its upstream sources by a path of
the machine it was written on, the port names them by project
(`bevy_firework src/...`), and one comment drops a citation of a project
note. Every line of code is the same, and so is every checker result."""

import itertools
import re

import numpy as np
import pytest

from bevy_firework_tpu import shaders as jsh
from bevy_firework_tpu.shaders import specialize as jsp
from bevy_firework_tpu.shaders import wgsl_check as jwc
from bevy_firework_tpu.shaders import wgsl_types as jwt
from bevy_firework_tpu_torch import shaders as psh
from bevy_firework_tpu_torch.shaders import specialize as psp
from bevy_firework_tpu_torch.shaders import wgsl_check as pwc
from bevy_firework_tpu_torch.shaders import wgsl_types as pwt
from test_wgsl_types import FOG_MUTATIONS, PARTICLE_MUTATIONS, RIBBON_MUTATIONS

UPSTREAM_COMMENTS = {"particles": 3, "ribbons": 1}  # the comment lines that differ


def _code(src: str) -> str:
    """The source with its `//` comments removed."""
    return re.sub(r"//[^\n]*", "", src)


@pytest.mark.parametrize("name", ["particles", "ribbons"])
def test_wgsl_files_match(name):
    ours = getattr(psh, f"{name}_wgsl_source")()
    ref = getattr(jsh, f"{name}_wgsl_source")()
    assert _code(ours) == _code(ref)
    a, b = ours.splitlines(), ref.splitlines()
    assert len(a) == len(b)
    differ = [(x, y) for x, y in zip(a, b) if x != y]
    assert len(differ) == UPSTREAM_COMMENTS[name]
    for x, y in differ:  # the same upstream files and lines, named by project
        assert x.lstrip().startswith("//") and y.lstrip().startswith("//")
        assert re.findall(r"(?:src/)?[\w.]+:\d+(?:-\d+)?", x) == re.findall(r"(?:src/)?[\w.]+:\d+(?:-\d+)?", y)


def _keys(pkg):
    """Every PipelineKey: msaa, prepass, hdr, shadow map, fog, lights,
    the shadow atlas (with lights), over each alpha mode's blend bit."""
    modes = (pkg.ALPHA_OPAQUE, pkg.ALPHA_MASK, pkg.ALPHA_BLEND, pkg.ALPHA_PREMULTIPLIED, pkg.ALPHA_ADD,
             pkg.ALPHA_MULTIPLY)
    for msaa, prepass, hdr, smap, fog, lit in itertools.product((1, 4), *[(False, True)] * 5):
        for atlas in ((False, True) if lit else (False,)):
            for mode in modes:
                yield pkg.key_for(mode, msaa_samples=msaa, depth_prepass=prepass, hdr=hdr, shadow_map=smap, fog=fog,
                                  lights=lit, shadow_atlas=atlas)


def test_specialize_every_key_matches():
    """key_for over every key equal; PipelineCache().specialize over every
    shader-def set (each key's msaa, prepass, shadow map, fog, lights and
    atlas bits; the hdr and blend bits only change the descriptor, so they
    are specialized on one def set): equal defs, layouts and descriptors,
    and sources equal but for the upstream comments; preprocess on every
    def set likewise."""
    cp, cj = psp.PipelineCache(), jsp.PipelineCache()
    n = 0
    for kp, kj in zip(_keys(psp), _keys(jsp)):
        assert kp.__dict__ == kj.__dict__
        n += 1
        plain = kp.blend_bit == psp.BLEND_ALPHA and not kp.hdr
        varied = kp.msaa_samples == 4 and kp.depth_prepass and not kp.lights
        if not (plain or varied):
            continue
        vp, vj = cp.specialize(kp), cj.specialize(kj)
        assert vp.shader_defs == vj.shader_defs
        assert _code(vp.shader_source) == _code(vj.shader_source)
        assert vp.layout == vj.layout
        for f in ("target_format", "blend", "multisample_count", "depth_compare", "depth_write_enabled", "cull_mode",
                  "topology"):
            assert getattr(vp, f) == getattr(vj, f), f
    assert n == 2 * 2 ** 4 * 3 * 6 and len(cp) == len(cj) > 48
    srcp, srcj = psh.particles_wgsl_source(), jsh.particles_wgsl_source()
    defs = ("MULTISAMPLED", "DEPTH_PREPASS", "SHADOW_MAP", "FOG", "LIGHTS", "SHADOW_ATLAS")
    for bits in itertools.product((False, True), repeat=len(defs)):
        d = frozenset(x for x, b in zip(defs, bits) if b)
        assert _code(psp.preprocess(srcp, d)) == _code(jsp.preprocess(srcj, d))
    with pytest.raises(ValueError):
        psp.preprocess("#ifdef A\nx\n", frozenset())
    with pytest.raises(ValueError):
        cp.specialize(psp.PipelineKey(shadow_atlas=True))
    for args in itertools.product((False, True), repeat=5):
        assert psp.uniform_layout_entries(*args) == jsp.uniform_layout_entries(*args)


def test_dummy_textures_match():
    """DummyTextures: the same dummies and group(2) entries for every key
    shape and flag set."""
    dp, dj = psp.DummyTextures(), jsp.DummyTextures()
    real = {"base_color": np.full((2, 2, 4), 0.5, np.float32)}
    for kp, kj in itertools.islice(zip(_keys(psp), _keys(jsp)), 0, None, 6):
        for flags in range(8):
            ep, ej = dp.bind_group_entries(flags, kp, real), dj.bind_group_entries(flags, kj, real)
            assert len(ep) == len(ej)
            for a, b in zip(ep, ej):
                assert a.keys() == b.keys() and a["binding"] == b["binding"] and a.get("real") == b.get("real")
                ra, rb = a["resource"], b["resource"]
                assert np.array_equal(ra, rb) if isinstance(ra, np.ndarray) else ra == rb
    assert dp.depth_textures.keys() == dj.depth_textures.keys()


# tests/test_wgsl.py's regressions of the shipped (depth-prepass) variant
WGSL_MUTATIONS = [
    lambda s: s.replace("normalize(view.world_position", "normalizee(view.world_position"),
    lambda s: s.replace("system.fade_scene", "system.fade_scenee"),
    lambda s: s.replace("fn quat_rotate", "fn quat_rotatex"),
    lambda s: s[: s.rfind("}")],
    lambda s: s.replace("@fragment", ""),
    lambda s: s.replace("@location(4) rotation", "@location(9) rotation"),
    lambda s: s.replace("fn fragment(in: VsOut)", "fn fragment(in: VsOut, @builtin(position) frag_coord: vec4<f32>)"),
]
RIBBON_REGRESSIONS = [("view.world_position", "view.world_positionn"), ("smoothstep(", "smoothsteep("),
                      ("out.across = side;", "out.across = sidex;")]
INSTANCE_CONTRACT = {3: "pos_scale", 4: "rotation", 5: "base_color", 6: "emissive"}


def _both_checkers(src):
    """(check_wgsl, type_check_wgsl) of each package on `src`, which must
    agree."""
    got = (pwc.check_wgsl(src), pwt.type_check_wgsl(src))
    assert got == (jwc.check_wgsl(src), jwt.type_check_wgsl(src))
    return got


def test_checkers_match_on_variants_and_mutations():
    """check_wgsl and type_check_wgsl give the reference's results on every
    shipped variant (clean) and on the reference tests' mutations (each
    caught, with the same messages)."""
    srcp = psh.particles_wgsl_source()
    defs = ("MULTISAMPLED", "DEPTH_PREPASS", "SHADOW_MAP", "FOG", "LIGHTS", "SHADOW_ATLAS")
    for bits in itertools.product((False, True), repeat=len(defs)):
        d = frozenset(x for x, b in zip(defs, bits) if b)
        if "SHADOW_ATLAS" in d and "LIGHTS" not in d:
            continue
        assert _both_checkers(psp.preprocess(srcp, d)) == ([], [])
    assert _both_checkers(psh.ribbons_wgsl_source()) == ([], [])
    prepass = psp.preprocess(srcp, {"DEPTH_PREPASS"})
    assert pwc.check_wgsl(prepass, instance_locations=INSTANCE_CONTRACT) == []
    for mutate in WGSL_MUTATIONS:
        m = mutate(prepass)
        got = pwc.check_wgsl(m, instance_locations=INSTANCE_CONTRACT)
        assert got and got == jwc.check_wgsl(m, instance_locations=INSTANCE_CONTRACT)
    for find, rep in RIBBON_REGRESSIONS:
        assert _both_checkers(psh.ribbons_wgsl_source().replace(find, rep))[0]
    for muts, src in ((PARTICLE_MUTATIONS, psp.preprocess(srcp, {"DEPTH_PREPASS", "MULTISAMPLED"})),
                      (FOG_MUTATIONS, psp.preprocess(srcp, {"DEPTH_PREPASS", "FOG"})),
                      (RIBBON_MUTATIONS, psp.preprocess(psh.ribbons_wgsl_source(), {"DEPTH_PREPASS", "MULTISAMPLED"}))):
        for name, find, rep in muts:
            assert find in src, name
            assert _both_checkers(src.replace(find, rep))[1], name
