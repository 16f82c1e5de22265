"""Static checker for the WGSL subset used by `particles.wgsl`.

No WGSL compiler (naga, tint, wgpu-py) is a dependency, but the shipped
shader is part of the render contract and must not rot silently (the
reference compiles and runs `src/particles.wgsl` every frame via Bevy, so any
syntax error there is caught instantly). This module is the compiler-free
stand-in: a tokenizer + declaration parser + name/arity resolver that fails
on the regressions that actually happen to hand-edited shaders —

  * unbalanced braces/parens/brackets,
  * statements missing semicolons,
  * references to undeclared identifiers (typos in variables, functions,
    struct fields of known uniform/IO structs),
  * calls to unknown functions or user functions with the wrong arity,
  * missing @vertex/@fragment entry points,
  * the same stage builtin declared twice in one entry point's inputs
    (e.g. `@builtin(position)` both inside the IO struct and as a separate
    parameter — naga/tint reject this as a duplicate-builtin error),
  * instance-attribute locations drifting from the documented contract.

Structure/name gating lives here; TYPE errors (wrong-width constructors,
illegal swizzles, operand and builtin-signature mismatches, assignments to
immutables, return-type drift) are caught by the `wgsl_types` front end,
which `check_wgsl` runs whenever the structural pass is clean. Together
they cover the regression classes a real compiler (naga/tint) would
reject; still NOT covered: uniformity analysis, resource-binding layout
validation, and constructs outside the documented subset (wgsl_types
errors on those rather than passing them silently).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Set, Tuple

# WGSL builtin functions used by / plausible in this shader family.
BUILTIN_FUNCS: Set[str] = {
    "abs", "acos", "all", "any", "asin", "atan", "atan2", "ceil", "clamp",
    "cos", "cross", "degrees", "distance", "dot", "exp", "exp2", "floor",
    "fract", "inverseSqrt", "length", "log", "log2", "max", "min", "mix",
    "normalize", "pow", "radians", "reflect", "refract", "round", "saturate",
    "select", "sign", "sin", "smoothstep", "sqrt", "step", "tan", "tanh",
    "transpose", "trunc",
    "textureLoad", "textureSample", "textureSampleBias", "textureSampleLevel",
    "textureSampleCompare", "textureSampleCompareLevel", "textureDimensions",
    "arrayLength", "pack4x8unorm", "unpack4x8unorm",
}

# Type constructors are callable too.
TYPE_NAMES: Set[str] = {
    "f32", "f16", "i32", "u32", "bool",
    "vec2", "vec3", "vec4", "mat2x2", "mat3x3", "mat4x4",
    "array", "ptr", "atomic",
    "sampler", "sampler_comparison",
    "texture_2d", "texture_depth_2d", "texture_depth_2d_array",
    "texture_2d_array", "texture_cube", "texture_3d",
    "texture_multisampled_2d", "texture_depth_multisampled_2d",
}

KEYWORDS: Set[str] = {
    "fn", "let", "var", "const", "struct", "return", "if", "else", "for",
    "while", "loop", "break", "continue", "continuing", "discard", "switch",
    "case", "default", "true", "false", "fallthrough", "uniform", "storage",
    "read", "write", "read_write", "function", "private", "workgroup",
    "override", "alias", "enable", "requires", "diagnostic",
}

_ID = r"[A-Za-z_][A-Za-z0-9_]*"


class WgslError(Exception):
    pass


def _strip_comments(src: str) -> str:
    # Replace comments with spaces, preserving line numbers.
    out: List[str] = []
    i, n = 0, len(src)
    while i < n:
        if src.startswith("//", i):
            j = src.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
        elif src.startswith("/*", i):
            j = src.find("*/", i)
            if j < 0:
                raise WgslError("unterminated block comment")
            seg = src[i : j + 2]
            out.append("".join(c if c == "\n" else " " for c in seg))
            i = j + 2
        else:
            out.append(src[i])
            i += 1
    return "".join(out)


def _line_of(src: str, pos: int) -> int:
    return src.count("\n", 0, pos) + 1


def _check_balance(src: str, errors: List[str]) -> None:
    pairs = {")": "(", "}": "{", "]": "["}
    stack: List[Tuple[str, int]] = []
    for i, c in enumerate(src):
        if c in "({[":
            stack.append((c, i))
        elif c in ")}]":
            if not stack or stack[-1][0] != pairs[c]:
                errors.append(f"line {_line_of(src, i)}: unbalanced '{c}'")
                return
            stack.pop()
    for c, i in stack:
        errors.append(f"line {_line_of(src, i)}: unclosed '{c}'")


def _match_brace(src: str, open_pos: int) -> int:
    """Index just past the '}' matching the '{' at open_pos."""
    depth = 0
    for i in range(open_pos, len(src)):
        if src[i] == "{":
            depth += 1
        elif src[i] == "}":
            depth -= 1
            if depth == 0:
                return i + 1
    raise WgslError(f"line {_line_of(src, open_pos)}: unclosed brace")


def _parse_structs(src: str) -> Tuple[Dict[str, Set[str]], Dict[str, List[str]]]:
    """name -> field names, plus name -> stage builtins declared on fields."""
    structs: Dict[str, Set[str]] = {}
    struct_builtins: Dict[str, List[str]] = {}
    for m in re.finditer(rf"\bstruct\s+({_ID})\s*{{", src):
        body = src[m.end() : _match_brace(src, m.end() - 1) - 1]
        fields = set(re.findall(rf"({_ID})\s*:", body))
        # strip attribute args that look like `@builtin(position) name:`
        fields -= {"builtin", "location", "interpolate", "align", "size"}
        structs[m.group(1)] = fields
        struct_builtins[m.group(1)] = re.findall(rf"@builtin\(({_ID})\)", body)
    return structs, struct_builtins


def _parse_globals(src: str) -> Dict[str, Optional[str]]:
    """Module-scope var/const name -> declared type name (or None)."""
    out: Dict[str, Optional[str]] = {}
    # var<uniform> name: Type;  |  var name: texture_2d<f32>;
    for m in re.finditer(
        rf"\bvar\s*(?:<[^>;{{]*>)?\s*({_ID})\s*:\s*({_ID})", src
    ):
        # only module scope: crude but effective — must not be inside a fn.
        out[m.group(1)] = m.group(2)
    for m in re.finditer(rf"\bconst\s+({_ID})\s*(?::\s*({_ID})(?:<[^>=;]*>)?)?\s*=", src):
        out[m.group(1)] = m.group(2)
    return out


def _parse_functions(src: str) -> Dict[str, dict]:
    """name -> {params: [(name, type_name)], body: str, body_pos: int,
    attrs: set, arity: int}"""
    fns: Dict[str, dict] = {}
    for m in re.finditer(rf"\bfn\s+({_ID})\s*\(", src):
        name = m.group(1)
        # match parens of the parameter list
        depth, i = 0, m.end() - 1
        while i < len(src):
            if src[i] == "(":
                depth += 1
            elif src[i] == ")":
                depth -= 1
                if depth == 0:
                    break
            i += 1
        params_src = src[m.end() : i]
        param_builtins = re.findall(rf"@builtin\(({_ID})\)", params_src)
        brace = src.find("{", i)
        if brace < 0:
            raise WgslError(f"line {_line_of(src, m.start())}: fn {name} has no body")
        end = _match_brace(src, brace)
        params: List[Tuple[str, Optional[str]]] = []
        for pm in re.finditer(rf"(?:^|,)\s*(?:@{_ID}\([^)]*\)\s*)*({_ID})\s*:\s*({_ID})", params_src):
            params.append((pm.group(1), pm.group(2)))
        attrs = set(re.findall(rf"@({_ID})", src[max(0, m.start() - 80) : m.start()]))
        fns[name] = {
            "params": params,
            "param_builtins": param_builtins,
            "body": src[brace + 1 : end - 1],
            "body_pos": brace + 1,
            "attrs": attrs,
            "arity": len(params),
        }
    return fns


def _iter_identifiers(body: str):
    """Yield (name, pos, is_call, is_member) for identifier tokens."""
    for m in re.finditer(_ID, body):
        if m.start() > 0 and body[m.start() - 1].isdigit():
            continue  # numeric-literal suffix (1e-8, 0u, 1.5f) — not a name
        name = m.group(0)
        before = body[: m.start()].rstrip()
        is_member = before.endswith(".")
        after = body[m.end() :].lstrip()
        # `<` after a non-type identifier is a comparison, so only `(` marks
        # a call; generic type heads (vec4<...>) are in TYPE_NAMES and are
        # filtered before the call check.
        is_call = after.startswith("(")
        yield name, m.start(), is_call, is_member


def check_wgsl(src: str, *, instance_locations: Optional[Dict[int, str]] = None) -> List[str]:
    """Returns a list of error strings (empty = passes).

    instance_locations: optional {location: field_name} pin for the vertex
    input struct, verifying the instance-attribute contract.
    """
    errors: List[str] = []
    try:
        src = _strip_comments(src)
        _check_balance(src, errors)
        if errors:
            return errors
        structs, struct_builtins = _parse_structs(src)
        globals_ = _parse_globals(src)
        fns = _parse_functions(src)
    except WgslError as e:
        return [str(e)]

    # entry points
    vertex_fns = [n for n, f in fns.items() if "vertex" in f["attrs"]]
    fragment_fns = [n for n, f in fns.items() if "fragment" in f["attrs"]]
    if not vertex_fns:
        errors.append("no @vertex entry point")
    if not fragment_fns:
        errors.append("no @fragment entry point")

    # duplicate stage-builtin inputs on an entry point: each builtin may be
    # consumed exactly once across the direct parameters and any struct-typed
    # parameters' fields (naga/tint validation error otherwise — e.g. a
    # second `@builtin(position)` param next to a VsOut that already carries
    # clip_position).
    for ename in vertex_fns + fragment_fns:
        f = fns[ename]
        seen: List[str] = list(f["param_builtins"])
        for _, ptype in f["params"]:
            seen.extend(struct_builtins.get(ptype, []))
        for b in sorted({b for b in seen if seen.count(b) > 1}):
            errors.append(
                f"entry point {ename}: builtin '{b}' declared "
                f"{seen.count(b)} times across its inputs"
            )

    known_callables = BUILTIN_FUNCS | TYPE_NAMES | set(fns) | set(structs)

    for fname, f in fns.items():
        scope: Dict[str, Optional[str]] = dict(globals_)
        for pname, ptype in f["params"]:
            scope[pname] = ptype
        body = f["body"]
        # locals: let/var declarations anywhere in the body (no shadow/order
        # analysis — name presence is what we gate on)
        for dm in re.finditer(rf"\b(?:let|var)\s+({_ID})\s*(?::\s*({_ID}))?", body):
            scope[dm.group(1)] = dm.group(2)
        for name, pos, is_call, is_member in _iter_identifiers(body):
            line = _line_of(src, f["body_pos"] + pos)
            if is_member:
                continue  # members checked below, against known struct bases
            if name in KEYWORDS or name in TYPE_NAMES:
                continue
            if is_call:
                if name not in known_callables:
                    errors.append(f"line {line}: fn {fname}: call to unknown function '{name}'")
                elif name in fns:
                    # arity check for user functions
                    after = body[pos + len(name) :]
                    paren = after.find("(")
                    depth, j, commas, any_tok = 0, paren, 0, False
                    while j < len(after):
                        c = after[j]
                        if c == "(":
                            depth += 1
                        elif c == ")":
                            depth -= 1
                            if depth == 0:
                                break
                        elif c == "," and depth == 1:
                            commas += 1
                        elif depth >= 1 and not c.isspace():
                            any_tok = True
                        j += 1
                    nargs = (commas + 1) if any_tok else 0
                    if nargs != fns[name]["arity"]:
                        errors.append(
                            f"line {line}: fn {fname}: '{name}' called with "
                            f"{nargs} args, declared with {fns[name]['arity']}"
                        )
                continue
            if name not in scope and name not in known_callables:
                errors.append(f"line {line}: fn {fname}: undeclared identifier '{name}'")

        # member accesses on bases whose type is a user struct
        for mm in re.finditer(rf"\b({_ID})\.({_ID})\b", body):
            base, member = mm.group(1), mm.group(2)
            btype = scope.get(base)
            if btype in structs and member not in structs[btype]:
                line = _line_of(src, f["body_pos"] + mm.start())
                errors.append(
                    f"line {line}: fn {fname}: '{base}.{member}' — struct "
                    f"{btype} has no field '{member}'"
                )

    # semicolon sanity: a `let`/`return` statement line must end with ';'
    for sm in re.finditer(r"\b(let|return)\b[^;{}]*$", src, re.MULTILINE):
        frag = sm.group(0).rstrip()
        if frag in ("return", "let") or frag.endswith((",", "(", "+", "-", "*", "/", "=", "&", "|")):
            continue  # statement continues on the next line
        errors.append(f"line {_line_of(src, sm.start())}: statement missing ';'")

    # full type inference over the subset (wgsl_types): wrong-width
    # constructors, illegal swizzles, operand/signature/return mismatches,
    # assignments to immutables. Only when the structural pass is clean —
    # type errors cascade noisily from structural ones.
    if not errors:
        from .wgsl_types import type_check_wgsl

        errors.extend(type_check_wgsl(src))

    # instance-attribute contract pin
    if instance_locations:
        vs_inputs: Dict[int, List[str]] = {}
        for m in re.finditer(rf"@location\((\d+)\)\s+({_ID})\s*:", src):
            vs_inputs.setdefault(int(m.group(1)), []).append(m.group(2))
        for loc, want in instance_locations.items():
            got = vs_inputs.get(loc, [])
            if want not in got:
                errors.append(
                    f"instance attribute contract: expected '{want}' at "
                    f"@location({loc}), found {got or 'nothing'}"
                )
    return errors
