"""Type inference for the WGSL subset used by the shipped shaders.

`wgsl_check` gates names and structure; this module adds the class of error
it could not see: TYPE errors — wrong-width vector constructors, illegal
swizzles, mismatched operands, bad builtin signatures, assignments to
immutable bindings, wrong return types. The reference never needs this
because Bevy compiles `src/particles.wgsl` with naga every run
(bevy_firework `src/plugin.rs:36-41`); no WGSL compiler
(naga, tint, wgpu-py) is a dependency, so a hand-written front end for the subset the
shaders use is the CI stand-in.

Pipeline: tokenizer -> recursive-descent parser (module decls, statements,
Pratt expression parser) -> two-phase checker (collect module-scope
signatures, then type every function body with lexical scopes).

Supported subset (everything `particles.wgsl` / `ribbons.wgsl` use, plus
headroom for plausible edits): scalars f32/f16/i32/u32/bool + abstract
numerics with WGSL's automatic conversions; vecN<T>; matNxN<f32>;
array<T, N>; textures/samplers; struct types; full operator set
(arithmetic, comparison incl. per-component vector relations, logical,
bitwise, shifts); swizzles (xyzw/rgba, legality + width checked); matrix
and array indexing; constructors (splat, component-flatten, conversion);
~60 builtin signatures; let/var/const locals with declare-before-use;
assignment lvalue analysis (params and `let` are immutable); if/for/
while/loop control flow; return-type checking; discard.

Deliberately NOT supported (the shaders don't use them): pointers,
atomics, workgroup storage, switch, bitcast, f16 literals-with-suffix
edge cases, abstract-int overflow analysis. Hitting one of these yields
an "unsupported" error rather than silence, so new shader code either
stays in the checked subset or extends the checker.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------

# scalar kinds; 'aint'/'afloat' are WGSL's abstract numerics (literals)
_NUMERIC = ("f32", "f16", "i32", "u32", "aint", "afloat")
_FLOATY = ("f32", "f16", "afloat")
_INTY = ("i32", "u32", "aint")


@dataclass(frozen=True)
class Scalar:
    kind: str  # f32 f16 i32 u32 bool aint afloat

    def __str__(self):
        return self.kind


@dataclass(frozen=True)
class Vec:
    n: int
    scalar: Scalar

    def __str__(self):
        return f"vec{self.n}<{self.scalar}>"


@dataclass(frozen=True)
class Mat:
    cols: int
    rows: int

    def __str__(self):
        return f"mat{self.cols}x{self.rows}<f32>"


@dataclass(frozen=True)
class Arr:
    elem: "WType"
    count: Optional[int]

    def __str__(self):
        return f"array<{self.elem}, {self.count}>"


@dataclass(frozen=True)
class Tex:
    kind: str  # '2d', 'depth_2d', 'depth_multisampled_2d', '2d_array', ...

    def __str__(self):
        return f"texture_{self.kind}"


@dataclass(frozen=True)
class SamplerT:
    comparison: bool = False

    def __str__(self):
        return "sampler_comparison" if self.comparison else "sampler"


@dataclass(frozen=True)
class StructT:
    name: str

    def __str__(self):
        return self.name


WType = object

F32, I32, U32, BOOL = Scalar("f32"), Scalar("i32"), Scalar("u32"), Scalar("bool")
AINT, AFLOAT = Scalar("aint"), Scalar("afloat")


def _is_abstract(s: Scalar) -> bool:
    return s.kind in ("aint", "afloat")


def _scalar_conv(src: Scalar, dst: Scalar) -> bool:
    """WGSL automatic conversion: abstract-int -> {i32,u32,f32,f16,afloat},
    abstract-float -> {f32,f16}. Concrete types never convert implicitly."""
    if src == dst:
        return True
    if src.kind == "aint":
        return dst.kind in ("i32", "u32", "f32", "f16", "afloat")
    if src.kind == "afloat":
        return dst.kind in ("f32", "f16")
    return False


def _conv(src: WType, dst: WType) -> bool:
    """Is `src` implicitly usable where `dst` is expected?"""
    if src == dst:
        return True
    if isinstance(src, Scalar) and isinstance(dst, Scalar):
        return _scalar_conv(src, dst)
    if isinstance(src, Vec) and isinstance(dst, Vec):
        return src.n == dst.n and _scalar_conv(src.scalar, dst.scalar)
    if isinstance(src, Arr) and isinstance(dst, Arr):
        return src.count == dst.count and _conv(src.elem, dst.elem)
    return False


def _common_scalar(a: Scalar, b: Scalar) -> Optional[Scalar]:
    if a == b:
        return a
    if _scalar_conv(a, b):
        return b
    if _scalar_conv(b, a):
        return a
    # aint + afloat -> afloat
    if {a.kind, b.kind} == {"aint", "afloat"}:
        return AFLOAT
    return None


def _concretize(t: WType) -> WType:
    """Materialize abstract numerics (the type a `let x = 1.0;` gets)."""
    if isinstance(t, Scalar):
        return {"aint": I32, "afloat": F32}.get(t.kind, t)
    if isinstance(t, Vec):
        return Vec(t.n, _concretize(t.scalar))
    if isinstance(t, Arr):
        return Arr(_concretize(t.elem), t.count)
    return t


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<num>0[xX][0-9a-fA-F]+[iu]?
        |(?:\d+\.\d*|\.\d+)(?:[eE][+-]?\d+)?[fh]?
        |\d+[eE][+-]?\d+[fh]?
        |\d+[fhiu]?)
    |(?P<id>[A-Za-z_][A-Za-z0-9_]*)
    |(?P<op>->|&&|\|\||==|!=|<=|>=|<<|>>|\+=|-=|\*=|/=|%=|&=|\|=|\^=|\+\+|--
        |[-+*/%<>=!&|^~@(){}\[\],.;:])
    """,
    re.VERBOSE,
)


@dataclass
class Tok:
    kind: str  # 'num' | 'id' | 'op'
    text: str
    line: int


class WgslTypeError(Exception):
    def __init__(self, line: int, msg: str):
        super().__init__(f"line {line}: {msg}")
        self.line = line


def _tokenize(src: str) -> List[Tok]:
    toks: List[Tok] = []
    pos = 0
    line = 1
    n = len(src)
    while pos < n:
        c = src[pos]
        if c == "\n":
            line += 1
            pos += 1
            continue
        if c.isspace():
            pos += 1
            continue
        if src.startswith("//", pos):
            j = src.find("\n", pos)
            pos = n if j < 0 else j
            continue
        if src.startswith("/*", pos):
            j = src.find("*/", pos)
            if j < 0:
                raise WgslTypeError(line, "unterminated block comment")
            line += src.count("\n", pos, j)
            pos = j + 2
            continue
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise WgslTypeError(line, f"unexpected character {c!r}")
        kind = m.lastgroup
        toks.append(Tok(kind, m.group(0), line))
        pos = m.end()
    toks.append(Tok("eof", "", line))
    return toks


# ---------------------------------------------------------------------------
# token stream
# ---------------------------------------------------------------------------


class _Stream:
    def __init__(self, toks: List[Tok]):
        self.toks = toks
        self.i = 0

    @property
    def cur(self) -> Tok:
        return self.toks[self.i]

    def at(self, text: str) -> bool:
        return self.cur.text == text and self.cur.kind != "num"

    def at_id(self) -> bool:
        return self.cur.kind == "id"

    def advance(self) -> Tok:
        t = self.cur
        if t.kind != "eof":
            self.i += 1
        return t

    def eat(self, text: str) -> bool:
        if self.at(text):
            self.advance()
            return True
        return False

    def expect(self, text: str) -> Tok:
        if not self.at(text):
            raise WgslTypeError(self.cur.line, f"expected {text!r}, found {self.cur.text!r}")
        return self.advance()

    def expect_id(self) -> Tok:
        if self.cur.kind != "id":
            raise WgslTypeError(self.cur.line, f"expected identifier, found {self.cur.text!r}")
        return self.advance()


# ---------------------------------------------------------------------------
# type parsing
# ---------------------------------------------------------------------------

_SCALARS = {"f32": F32, "f16": Scalar("f16"), "i32": I32, "u32": U32, "bool": BOOL}
_VECS = {"vec2": 2, "vec3": 3, "vec4": 4}
_MATS = {
    "mat2x2": (2, 2), "mat2x3": (2, 3), "mat2x4": (2, 4),
    "mat3x2": (3, 2), "mat3x3": (3, 3), "mat3x4": (3, 4),
    "mat4x2": (4, 2), "mat4x3": (4, 3), "mat4x4": (4, 4),
}
_TEXES = {
    "texture_2d": "2d", "texture_2d_array": "2d_array", "texture_3d": "3d",
    "texture_cube": "cube", "texture_multisampled_2d": "multisampled_2d",
    "texture_depth_2d": "depth_2d",
    "texture_depth_multisampled_2d": "depth_multisampled_2d",
    "texture_depth_2d_array": "depth_2d_array",
}
_TYPE_HEADS = set(_SCALARS) | set(_VECS) | set(_MATS) | set(_TEXES) | {
    "array", "sampler", "sampler_comparison"}


def _parse_type(s: _Stream, structs: Dict[str, dict]) -> WType:
    t = s.expect_id()
    name = t.text
    if name in _SCALARS:
        return _SCALARS[name]
    if name in _VECS:
        scalar = F32
        if s.eat("<"):
            inner = _parse_type(s, structs)
            if not isinstance(inner, Scalar):
                raise WgslTypeError(t.line, f"vec component must be scalar, got {inner}")
            scalar = inner
            s.expect(">")
        return Vec(_VECS[name], scalar)
    if name in _MATS:
        if s.eat("<"):
            inner = _parse_type(s, structs)
            if inner != F32:
                raise WgslTypeError(t.line, f"matrix elements must be f32, got {inner}")
            s.expect(">")
        c, r = _MATS[name]
        return Mat(c, r)
    if name == "array":
        s.expect("<")
        elem = _parse_type(s, structs)
        count = None
        if s.eat(","):
            cn = s.advance()
            if cn.kind != "num" or not cn.text.isdigit():
                raise WgslTypeError(cn.line, f"array count must be an integer literal, got {cn.text!r}")
            count = int(cn.text)
        s.expect(">")
        return Arr(elem, count)
    if name in _TEXES:
        if s.eat("<"):  # sampled type; only f32 textures in the subset
            inner = _parse_type(s, structs)
            if inner != F32:
                raise WgslTypeError(t.line, f"texture sample type must be f32, got {inner}")
            s.expect(">")
        return Tex(_TEXES[name])
    if name == "sampler":
        return SamplerT(False)
    if name == "sampler_comparison":
        return SamplerT(True)
    if name in structs:
        return StructT(name)
    raise WgslTypeError(t.line, f"unknown type '{name}'")


# ---------------------------------------------------------------------------
# module-scope parsing (two-phase: signatures first, then bodies)
# ---------------------------------------------------------------------------


def _skip_attributes(s: _Stream):
    while s.at("@"):
        s.advance()
        s.expect_id()
        if s.eat("("):
            depth = 1
            while depth:
                t = s.advance()
                if t.kind == "eof":
                    raise WgslTypeError(t.line, "unterminated attribute")
                if t.text == "(":
                    depth += 1
                elif t.text == ")":
                    depth -= 1


def _skip_balanced(s: _Stream, open_: str, close: str):
    s.expect(open_)
    depth = 1
    while depth:
        t = s.advance()
        if t.kind == "eof":
            raise WgslTypeError(t.line, f"unterminated {open_!r}")
        if t.text == open_:
            depth += 1
        elif t.text == close:
            depth -= 1


def _parse_module(src: str):
    """Collect structs, globals (name -> (type, mutable)), consts, and
    functions (with body token ranges)."""
    toks = _tokenize(src)
    # pre-scan struct names so types can reference structs in any order
    struct_names = {toks[i + 1].text for i in range(len(toks) - 1)
                    if toks[i].text == "struct" and toks[i + 1].kind == "id"}
    structs: Dict[str, dict] = {n: {} for n in struct_names}
    globals_: Dict[str, Tuple[WType, bool]] = {}
    fns: Dict[str, dict] = {}
    const_exprs: List[Tuple[str, Optional[WType], int, int]] = []  # name, declared, expr range

    s = _Stream(toks)
    while s.cur.kind != "eof":
        _skip_attributes(s)
        if s.eat("struct"):
            name = s.expect_id().text
            s.expect("{")
            fields: Dict[str, WType] = {}
            while not s.eat("}"):
                _skip_attributes(s)
                fname = s.expect_id().text
                s.expect(":")
                fields[fname] = _parse_type(s, structs)
                if not s.eat(","):
                    s.expect("}")
                    break
            structs[name] = fields
            s.eat(";")
        elif s.eat("var"):
            if s.eat("<"):  # address space: var<uniform> etc
                while not s.eat(">"):
                    s.advance()
            name = s.expect_id().text
            s.expect(":")
            ty = _parse_type(s, structs)
            if s.eat("="):
                while not s.at(";"):
                    s.advance()
            s.expect(";")
            globals_[name] = (ty, True)
        elif s.eat("const") or s.eat("override"):
            name = s.expect_id().text
            declared = None
            if s.eat(":"):
                declared = _parse_type(s, structs)
            s.expect("=")
            start = s.i
            while not s.at(";"):
                if s.cur.kind == "eof":
                    raise WgslTypeError(s.cur.line, "unterminated const")
                s.advance()
            const_exprs.append((name, declared, start, s.i))
            s.expect(";")
        elif s.eat("fn"):
            name = s.expect_id().text
            s.expect("(")
            params: List[Tuple[str, WType]] = []
            while not s.eat(")"):
                _skip_attributes(s)
                pname = s.expect_id().text
                s.expect(":")
                params.append((pname, _parse_type(s, structs)))
                if not s.eat(","):
                    s.expect(")")
                    break
            ret: Optional[WType] = None
            if s.eat("->"):
                _skip_attributes(s)
                ret = _parse_type(s, structs)
            body_start = s.i
            _skip_balanced(s, "{", "}")
            fns[name] = {"params": params, "ret": ret,
                         "body": (body_start, s.i)}
        elif s.eat("alias"):
            while not s.eat(";"):
                s.advance()
        elif s.eat("enable") or s.eat("requires") or s.eat("diagnostic"):
            while not s.eat(";"):
                s.advance()
        elif s.eat(";"):
            pass
        else:
            raise WgslTypeError(s.cur.line,
                                f"unsupported module-scope construct at {s.cur.text!r}")
    return toks, structs, globals_, const_exprs, fns


# ---------------------------------------------------------------------------
# expression / statement checking
# ---------------------------------------------------------------------------

_SWIZZLE_SETS = ({"x": 0, "y": 1, "z": 2, "w": 3}, {"r": 0, "g": 1, "b": 2, "a": 3})


class _Checker:
    def __init__(self, toks, structs, consts, globals_, fns, errors: List[str]):
        self.toks = toks
        self.structs = structs
        self.consts = consts  # name -> WType (immutable)
        self.globals = globals_  # name -> (WType, mutable)
        self.fns = fns
        self.errors = errors

    # -- scope ---------------------------------------------------------------

    def _lookup(self, scopes, name) -> Optional[Tuple[WType, bool]]:
        for sc in reversed(scopes):
            if name in sc:
                return sc[name]
        if name in self.consts:
            return (self.consts[name], False)
        if name in self.globals:
            return self.globals[name]
        return None

    # -- expressions (Pratt) --------------------------------------------------

    def expr(self, s: _Stream, scopes) -> WType:
        return self._or(s, scopes)

    def _or(self, s, scopes):
        t = self._and(s, scopes)
        while s.at("||"):
            line = s.advance().line
            r = self._and(s, scopes)
            t = self._logical(line, "||", t, r)
        return t

    def _and(self, s, scopes):
        t = self._bitor(s, scopes)
        while s.at("&&"):
            line = s.advance().line
            r = self._bitor(s, scopes)
            t = self._logical(line, "&&", t, r)
        return t

    def _logical(self, line, op, a, b):
        if a != BOOL or b != BOOL:
            self.errors.append(f"line {line}: '{op}' needs bool operands, got {a} and {b}")
        return BOOL

    def _bitor(self, s, scopes):
        t = self._bitxor(s, scopes)
        while s.at("|") and not s.at("||"):
            line = s.advance().line
            t = self._bitop(line, "|", t, self._bitxor(s, scopes))
        return t

    def _bitxor(self, s, scopes):
        t = self._bitand(s, scopes)
        while s.at("^"):
            line = s.advance().line
            t = self._bitop(line, "^", t, self._bitand(s, scopes))
        return t

    def _bitand(self, s, scopes):
        t = self._cmp(s, scopes)
        while s.at("&") and not s.at("&&"):
            line = s.advance().line
            t = self._bitop(line, "&", t, self._cmp(s, scopes))
        return t

    def _bitop(self, line, op, a, b):
        def ok(x):
            return (isinstance(x, Scalar) and (x.kind in _INTY or x.kind == "bool")) or (
                isinstance(x, Vec) and (x.scalar.kind in _INTY or x.scalar.kind == "bool"))
        if not (ok(a) and ok(b)):
            self.errors.append(f"line {line}: '{op}' needs integer/bool operands, got {a} and {b}")
            return a
        return self._arith(line, op, a, b, require=None)

    def _cmp(self, s, scopes):
        t = self._shift(s, scopes)
        while any(s.at(o) for o in ("==", "!=", "<", ">", "<=", ">=")):
            op = s.advance()
            r = self._shift(s, scopes)
            t = self._relational(op.line, op.text, t, r)
        return t

    def _relational(self, line, op, a, b):
        if isinstance(a, Vec) and isinstance(b, Vec):
            if a.n != b.n or _common_scalar(a.scalar, b.scalar) is None:
                self.errors.append(f"line {line}: cannot compare {a} with {b}")
            return Vec(a.n, BOOL)
        if isinstance(a, Scalar) and isinstance(b, Scalar):
            if _common_scalar(a, b) is None:
                self.errors.append(f"line {line}: cannot compare {a} with {b}")
            return BOOL
        self.errors.append(f"line {line}: cannot compare {a} with {b}")
        return BOOL

    def _shift(self, s, scopes):
        t = self._add(s, scopes)
        while s.at("<<") or s.at(">>"):
            op = s.advance()
            r = self._add(s, scopes)
            def ints(x):
                return (isinstance(x, Scalar) and x.kind in _INTY) or (
                    isinstance(x, Vec) and x.scalar.kind in _INTY)
            if not (ints(t) and ints(r)):
                self.errors.append(f"line {op.line}: '{op.text}' needs integer operands, got {t} and {r}")
        return t

    def _add(self, s, scopes):
        t = self._mul(s, scopes)
        while (s.at("+") or s.at("-")) and s.cur.kind == "op":
            op = s.advance()
            r = self._mul(s, scopes)
            t = self._arith(op.line, op.text, t, r, require=_NUMERIC)
        return t

    def _mul(self, s, scopes):
        t = self._unary(s, scopes)
        while s.at("*") or s.at("/") or s.at("%"):
            op = s.advance()
            r = self._unary(s, scopes)
            if op.text == "*":
                t = self._times(op.line, t, r)
            else:
                t = self._arith(op.line, op.text, t, r, require=_NUMERIC)
        return t

    def _times(self, line, a, b):
        # matrix algebra first, then elementwise
        if isinstance(a, Mat) and isinstance(b, Mat):
            if a.cols != b.rows:
                self.errors.append(f"line {line}: {a} * {b} dimension mismatch")
            return Mat(b.cols, a.rows)
        if isinstance(a, Mat) and isinstance(b, Vec):
            if b.n != a.cols or not _scalar_conv(b.scalar, F32):
                self.errors.append(f"line {line}: {a} * {b} dimension mismatch")
            return Vec(a.rows, F32)
        if isinstance(a, Vec) and isinstance(b, Mat):
            if a.n != b.rows or not _scalar_conv(a.scalar, F32):
                self.errors.append(f"line {line}: {a} * {b} dimension mismatch")
            return Vec(b.cols, F32)
        if isinstance(a, Mat) and isinstance(b, Scalar):
            return a
        if isinstance(a, Scalar) and isinstance(b, Mat):
            return b
        return self._arith(line, "*", a, b, require=_NUMERIC)

    def _arith(self, line, op, a, b, require) -> WType:
        def scal(x):
            return x if isinstance(x, Scalar) else x.scalar if isinstance(x, Vec) else None

        sa, sb = scal(a), scal(b)
        if sa is None or sb is None:
            self.errors.append(f"line {line}: '{op}' cannot combine {a} and {b}")
            return a
        if require is not None and not (sa.kind in require and sb.kind in require):
            self.errors.append(f"line {line}: '{op}' needs numeric operands, got {a} and {b}")
        common = _common_scalar(sa, sb)
        if common is None:
            self.errors.append(f"line {line}: '{op}' operand types {a} and {b} do not match")
            common = sa
        if isinstance(a, Vec) and isinstance(b, Vec):
            if a.n != b.n:
                self.errors.append(f"line {line}: '{op}' width mismatch: {a} vs {b}")
            return Vec(a.n, common)
        if isinstance(a, Vec):
            return Vec(a.n, common)
        if isinstance(b, Vec):
            return Vec(b.n, common)
        return common

    def _unary(self, s, scopes):
        if s.at("-"):
            line = s.advance().line
            t = self._unary(s, scopes)
            sc = t if isinstance(t, Scalar) else t.scalar if isinstance(t, Vec) else None
            if sc is None or sc.kind not in _NUMERIC:
                self.errors.append(f"line {line}: unary '-' on non-numeric {t}")
            elif sc.kind == "u32":
                self.errors.append(f"line {line}: unary '-' on u32 is invalid in WGSL")
            return t
        if s.at("!"):
            line = s.advance().line
            t = self._unary(s, scopes)
            if not (t == BOOL or (isinstance(t, Vec) and t.scalar == BOOL)):
                self.errors.append(f"line {line}: '!' on non-bool {t}")
            return t
        if s.at("~"):
            s.advance()
            return self._unary(s, scopes)
        if s.at("*") or s.at("&"):  # pointers: out of subset
            raise WgslTypeError(s.cur.line, "pointer operations are outside the checked subset")
        return self._postfix(s, scopes)

    def _postfix(self, s, scopes):
        t = self._primary(s, scopes)
        while True:
            if s.at("."):
                s.advance()
                mem = s.expect_id()
                t = self._member(mem.line, t, mem.text)
            elif s.at("["):
                line = s.advance().line
                idx = self.expr(s, scopes)
                s.expect("]")
                t = self._index(line, t, idx)
            else:
                return t

    def _member(self, line, base, name) -> WType:
        if isinstance(base, StructT):
            fields = self.structs.get(base.name, {})
            if name not in fields:
                self.errors.append(f"line {line}: struct {base.name} has no field '{name}'")
                return F32
            return fields[name]
        if isinstance(base, Vec):
            for letters in _SWIZZLE_SETS:
                if all(c in letters for c in name):
                    if len(name) > 4:
                        self.errors.append(f"line {line}: swizzle '{name}' too long")
                    bad = [c for c in name if letters[c] >= base.n]
                    if bad:
                        self.errors.append(
                            f"line {line}: swizzle '.{name}' out of range for {base} "
                            f"(component '{bad[0]}' needs width {letters[bad[0]] + 1})")
                    return base.scalar if len(name) == 1 else Vec(len(name), base.scalar)
            self.errors.append(f"line {line}: invalid swizzle '.{name}' on {base}")
            return base.scalar
        self.errors.append(f"line {line}: '.{name}' on non-composite {base}")
        return F32

    def _index(self, line, base, idx) -> WType:
        if not (isinstance(idx, Scalar) and idx.kind in _INTY):
            self.errors.append(f"line {line}: index must be an integer, got {idx}")
        if isinstance(base, Arr):
            return base.elem
        if isinstance(base, Vec):
            return base.scalar
        if isinstance(base, Mat):
            return Vec(base.rows, F32)
        self.errors.append(f"line {line}: cannot index {base}")
        return F32

    def _primary(self, s, scopes) -> WType:
        t = s.cur
        if t.kind == "num":
            s.advance()
            return self._literal_type(t)
        if s.eat("("):
            inner = self.expr(s, scopes)
            s.expect(")")
            return inner
        if t.kind == "id":
            if t.text in ("true", "false"):
                s.advance()
                return BOOL
            if t.text in _TYPE_HEADS:
                ty = _parse_type(s, self.structs)
                return self._constructor(t.line, ty, s, scopes)
            s.advance()
            if s.at("("):
                return self._call(t, s, scopes)
            binding = self._lookup(scopes, t.text)
            if binding is None:
                self.errors.append(f"line {t.line}: undeclared identifier '{t.text}'")
                return F32
            return binding[0]
        raise WgslTypeError(t.line, f"unexpected token {t.text!r} in expression")

    @staticmethod
    def _literal_type(t: Tok) -> Scalar:
        x = t.text
        if x.endswith("u"):
            return U32
        if x.endswith("i"):
            return I32
        if x.endswith("f"):
            return F32
        if x.endswith("h"):
            return Scalar("f16")
        if "." in x or (("e" in x or "E" in x) and not x.lower().startswith("0x")):
            return AFLOAT
        return AINT

    def _call_args(self, s, scopes) -> List[WType]:
        s.expect("(")
        args: List[WType] = []
        while not s.eat(")"):
            args.append(self.expr(s, scopes))
            if not s.eat(","):
                s.expect(")")
                break
        return args

    def _constructor(self, line, ty: WType, s, scopes) -> WType:
        args = self._call_args(s, scopes)
        if isinstance(ty, Scalar):
            if len(args) != 1 or not isinstance(args[0], Scalar):
                self.errors.append(f"line {line}: {ty}() takes one scalar argument")
            return ty
        if isinstance(ty, Vec):
            if len(args) == 0:
                return ty  # zero value
            if len(args) == 1 and isinstance(args[0], Vec):
                if args[0].n != ty.n:
                    self.errors.append(
                        f"line {line}: {ty} constructed from {args[0]} (width mismatch)")
                return ty
            if len(args) == 1 and isinstance(args[0], Scalar):
                if not _scalar_conv(args[0], ty.scalar) and not _is_abstract(args[0]):
                    self.errors.append(f"line {line}: cannot splat {args[0]} into {ty}")
                return ty
            total = 0
            for a in args:
                if isinstance(a, Scalar):
                    total += 1
                    comp = a
                elif isinstance(a, Vec):
                    total += a.n
                    comp = a.scalar
                else:
                    self.errors.append(f"line {line}: {ty} component argument has type {a}")
                    continue
                if _common_scalar(comp, ty.scalar) is None:
                    self.errors.append(
                        f"line {line}: {ty} component of type {comp} is not {ty.scalar}")
            if total != ty.n:
                self.errors.append(
                    f"line {line}: {ty} constructed from {total} components (needs {ty.n})")
            return ty
        if isinstance(ty, Mat):
            if args and len(args) not in (ty.cols, ty.cols * ty.rows, 1):
                self.errors.append(
                    f"line {line}: {ty} constructed from {len(args)} arguments")
            return ty
        if isinstance(ty, Arr):
            if ty.count is not None and args and len(args) != ty.count:
                self.errors.append(
                    f"line {line}: array<_, {ty.count}> constructed from {len(args)} elements")
            for a in args:
                if not _conv(a, ty.elem) and _concretize(a) != _concretize(ty.elem):
                    self.errors.append(f"line {line}: array element {a} is not {ty.elem}")
            return ty
        self.errors.append(f"line {line}: type {ty} is not constructible")
        return ty

    # -- builtin + user calls --------------------------------------------------

    def _call(self, name_tok: Tok, s, scopes) -> WType:
        name, line = name_tok.text, name_tok.line
        if name in self.structs:
            args = self._call_args(s, scopes)
            fields = list(self.structs[name].values())
            if args and len(args) != len(fields):
                self.errors.append(
                    f"line {line}: struct {name} constructed with {len(args)} of "
                    f"{len(fields)} fields")
            return StructT(name)
        if name in self.fns:
            args = self._call_args(s, scopes)
            f = self.fns[name]
            if len(args) != len(f["params"]):
                self.errors.append(
                    f"line {line}: '{name}' called with {len(args)} args, "
                    f"declared with {len(f['params'])}")
            else:
                for a, (pname, pty) in zip(args, f["params"]):
                    if not _conv(a, pty):
                        self.errors.append(
                            f"line {line}: '{name}' parameter '{pname}' expects "
                            f"{pty}, got {a}")
            return f["ret"] if f["ret"] is not None else F32
        args = self._call_args(s, scopes)
        return self._builtin(line, name, args)

    def _builtin(self, line, name, args) -> WType:
        def err(msg):
            self.errors.append(f"line {line}: {name}(): {msg}")

        def float_like(t):
            return (isinstance(t, Scalar) and t.kind in _FLOATY) or (
                isinstance(t, Vec) and t.scalar.kind in _FLOATY)

        def same(ts):
            cs = [_concretize(x) for x in ts]
            base = next((c for c in cs if not (isinstance(c, Scalar) and _is_abstract(c))), cs[0])
            for a, c in zip(ts, cs):
                if c != base and not _conv(a, base):
                    return None
            return base

        unary_float = {
            "acos", "asin", "atan", "ceil", "cos", "degrees", "exp", "exp2",
            "floor", "fract", "inverseSqrt", "log", "log2", "radians", "round",
            "saturate", "sin", "sqrt", "tan", "tanh", "trunc", "normalize",
        }
        if name in unary_float:
            if len(args) != 1 or not float_like(args[0]):
                err(f"needs one float operand, got {tuple(str(a) for a in args)}")
                return args[0] if args else F32
            if name == "normalize" and not isinstance(args[0], Vec):
                err("needs a vector")
            return _concretize(args[0])
        if name in ("abs", "sign"):
            if len(args) != 1:
                err("needs one argument")
            return _concretize(args[0]) if args else F32
        if name in ("length", "distance"):
            want = 1 if name == "length" else 2
            if len(args) != want or not all(float_like(a) for a in args):
                err("needs float vector operand(s)")
            return F32
        if name == "dot":
            if len(args) != 2 or not all(isinstance(a, Vec) for a in args) or args[0].n != args[1].n:
                err(f"needs two equal-width vectors, got {tuple(str(a) for a in args)}")
                return F32
            return _concretize(args[0]).scalar
        if name == "cross":
            if len(args) != 2 or any(not (isinstance(a, Vec) and a.n == 3) for a in args):
                err(f"needs two vec3, got {tuple(str(a) for a in args)}")
            return Vec(3, F32)
        if name in ("min", "max", "atan2", "pow", "step", "reflect"):
            if len(args) != 2 or same(args) is None:
                err(f"needs two matching operands, got {tuple(str(a) for a in args)}")
                return _concretize(args[0]) if args else F32
            if name == "reflect" and not isinstance(args[0], Vec):
                err("needs vectors")
            return same(args)
        if name in ("clamp", "fma", "smoothstep", "mix"):
            if len(args) != 3:
                err("needs three arguments")
                return args[0] if args else F32
            t = same(args)
            if t is None and name == "mix":
                # the mix(vecN, vecN, scalar) overload (smoothstep has no
                # mixed overload — naga requires all three the same type)
                if isinstance(args[0], Vec) and same(args[:2]) is not None \
                        and isinstance(args[2], Scalar) and args[2].kind in _FLOATY:
                    return _concretize(args[0])
            if t is None:
                err(f"operand types {tuple(str(a) for a in args)} do not match")
                return _concretize(args[0])
            return t
        if name == "select":
            if len(args) != 3:
                err("needs (false_value, true_value, condition)")
                return args[0] if args else F32
            t = same(args[:2])
            cond_ok = args[2] == BOOL or (
                isinstance(args[2], Vec) and args[2].scalar == BOOL
                and isinstance(t, Vec) and args[2].n == t.n)
            if t is None or not cond_ok:
                err(f"invalid operands {tuple(str(a) for a in args)}")
            return t if t is not None else F32
        if name == "refract":
            if len(args) != 3 or not isinstance(args[0], Vec):
                err("needs (vec, vec, scalar)")
            return _concretize(args[0]) if args else F32
        if name in ("all", "any"):
            if len(args) != 1 or not (isinstance(args[0], Vec) and args[0].scalar == BOOL):
                err("needs a boolean vector")
            return BOOL
        if name == "transpose":
            if len(args) != 1 or not isinstance(args[0], Mat):
                err("needs a matrix")
                return args[0] if args else Mat(4, 4)
            return Mat(args[0].rows, args[0].cols)
        if name == "arrayLength":
            return U32
        if name == "pack4x8unorm":
            if len(args) != 1 or args[0] != Vec(4, F32):
                err("needs vec4<f32>")
            return U32
        if name == "unpack4x8unorm":
            if len(args) != 1 or not _conv(args[0], U32):
                err("needs u32")
            return Vec(4, F32)
        if name in ("textureSample", "textureSampleLevel", "textureSampleBias"):
            if len(args) < 3 or not isinstance(args[0], Tex) or not isinstance(args[1], SamplerT):
                err("needs (texture, sampler, coords, ...)")
                return Vec(4, F32)
            if not _conv(args[2], Vec(2, F32)):
                err(f"2d coords must be vec2<f32>, got {args[2]}")
            extra = 4 if name != "textureSample" else 3
            if len(args) > extra:
                err(f"takes {extra} arguments for 2d textures, got {len(args)}")
            if name != "textureSample" and len(args) == 4 and not _conv(args[3], F32):
                err(f"level/bias must be f32, got {args[3]}")
            return F32 if args[0].kind.startswith("depth") else Vec(4, F32)
        if name in ("textureSampleCompare", "textureSampleCompareLevel"):
            if (len(args) != 4 or not isinstance(args[0], Tex)
                    or not args[0].kind.startswith("depth")
                    or not (isinstance(args[1], SamplerT) and args[1].comparison)
                    or not _conv(args[2], Vec(2, F32)) or not _conv(args[3], F32)):
                err("needs (texture_depth_2d, sampler_comparison, vec2<f32>, f32)")
            return F32
        if name == "textureLoad":
            if not args or not isinstance(args[0], Tex):
                err("needs a texture first argument")
                return Vec(4, F32)
            tex = args[0]
            if len(args) != 3:
                err(f"takes (texture, coords, level_or_sample), got {len(args)} args")
            else:
                cok = any(_conv(args[1], Vec(2, t)) for t in (I32, U32))
                if not cok:
                    err(f"coords must be vec2<i32|u32>, got {args[1]}")
                if not (isinstance(args[2], Scalar) and args[2].kind in _INTY):
                    err(f"level/sample index must be an integer, got {args[2]}")
            return F32 if tex.kind.startswith("depth") else Vec(4, F32)
        if name == "textureDimensions":
            if not args or not isinstance(args[0], Tex):
                err("needs a texture")
            return Vec(2, U32)
        err("unknown builtin function")
        return F32

    # -- statements -----------------------------------------------------------

    def check_fn(self, fname: str):
        f = self.fns[fname]
        start, end = f["body"]
        s = _Stream(self.toks[start:end])
        scopes = [dict()]
        for pname, pty in f["params"]:
            scopes[0][pname] = (pty, False)  # params are immutable
        s.expect("{")
        self._stmts(s, scopes, f)

    def _stmts(self, s, scopes, f):
        while not s.eat("}"):
            if s.cur.kind == "eof":
                raise WgslTypeError(s.cur.line, "unterminated block")
            self._stmt(s, scopes, f)

    def _block(self, s, scopes, f):
        s.expect("{")
        scopes.append({})
        self._stmts(s, scopes, f)
        scopes.pop()

    def _stmt(self, s, scopes, f):
        t = s.cur
        if s.at("{"):
            self._block(s, scopes, f)
            return
        if t.text in ("let", "var", "const") and t.kind == "id":
            s.advance()
            mutable = t.text == "var"
            name = s.expect_id().text
            declared = None
            if s.eat(":"):
                declared = _parse_type(s, self.structs)
            init = None
            if s.eat("="):
                init = self.expr(s, scopes)
            s.expect(";")
            if declared is not None and init is not None and not _conv(init, declared):
                self.errors.append(
                    f"line {t.line}: '{name}: {declared}' initialized with {init}")
            ty = declared if declared is not None else (
                _concretize(init) if init is not None else None)
            if ty is None:
                self.errors.append(f"line {t.line}: '{name}' needs a type or initializer")
                ty = F32
            scopes[-1][name] = (ty, mutable)
            return
        if s.eat("return"):
            if s.eat(";"):
                if f["ret"] is not None:
                    self.errors.append(
                        f"line {t.line}: bare return in function returning {f['ret']}")
                return
            val = self.expr(s, scopes)
            s.expect(";")
            if f["ret"] is None:
                self.errors.append(f"line {t.line}: return with a value in a void function")
            elif not _conv(val, f["ret"]):
                self.errors.append(
                    f"line {t.line}: return type {val} does not match declared {f['ret']}")
            return
        if s.eat("discard") or s.eat("break") or s.eat("continue"):
            s.expect(";")
            return
        if s.eat("if"):
            had_paren = s.eat("(")
            cond = self.expr(s, scopes)
            if had_paren:
                s.expect(")")
            if cond != BOOL:
                self.errors.append(f"line {t.line}: if condition is {cond}, not bool")
            self._block(s, scopes, f)
            if s.eat("else"):
                if s.at("if"):
                    self._stmt(s, scopes, f)
                else:
                    self._block(s, scopes, f)
            return
        if s.eat("while"):
            had_paren = s.eat("(")
            cond = self.expr(s, scopes)
            if had_paren:
                s.expect(")")
            if cond != BOOL:
                self.errors.append(f"line {t.line}: while condition is {cond}, not bool")
            self._block(s, scopes, f)
            return
        if s.eat("for"):
            s.expect("(")
            scopes.append({})
            if not s.at(";"):
                self._stmt(s, scopes, f)  # init (consumes its ';')
            else:
                s.advance()
            if not s.at(";"):
                cond = self.expr(s, scopes)
                if cond != BOOL:
                    self.errors.append(f"line {t.line}: for condition is {cond}, not bool")
            s.expect(";")
            if not s.at(")"):
                self._assign_or_expr(s, scopes, terminator=")")
            s.expect(")")
            self._block(s, scopes, f)
            scopes.pop()
            return
        if s.eat("loop"):
            self._block(s, scopes, f)
            return
        if s.eat("continuing"):
            self._block(s, scopes, f)
            return
        if t.text == "switch" and t.kind == "id":
            raise WgslTypeError(t.line, "switch is outside the checked subset")
        self._assign_or_expr(s, scopes, terminator=";")
        if s.cur.text == ";":
            s.advance()

    _ASSIGN_OPS = ("=", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=")

    def _assign_or_expr(self, s, scopes, terminator):
        """Either `lvalue (=|op=) expr` or a bare call expression."""
        t = s.cur
        if t.kind != "id":
            self.expr(s, scopes)
            return
        # try lvalue: ID (.member | [index])* then an assignment operator
        mark = s.i
        base = s.advance()
        binding = self._lookup(scopes, base.text)
        lv_type = binding[0] if binding else None
        ok_chain = True
        while ok_chain:
            if s.at("."):
                s.advance()
                mem = s.expect_id()
                if lv_type is not None:
                    lv_type = self._member(mem.line, lv_type, mem.text)
            elif s.at("["):
                line = s.advance().line
                idx = self.expr(s, scopes)
                s.expect("]")
                if lv_type is not None:
                    lv_type = self._index(line, lv_type, idx)
            else:
                break
        if s.cur.text in self._ASSIGN_OPS and s.cur.kind == "op":
            op = s.advance()
            rhs = self.expr(s, scopes)
            if binding is None:
                self.errors.append(f"line {base.line}: assignment to undeclared '{base.text}'")
                return
            if not binding[1]:
                self.errors.append(
                    f"line {base.line}: cannot assign to immutable binding '{base.text}' "
                    f"(declared with 'let' or as a parameter)")
            if op.text == "=":
                if lv_type is not None and not _conv(rhs, lv_type):
                    self.errors.append(
                        f"line {op.line}: assigning {rhs} to lvalue of type {lv_type}")
            else:
                if lv_type is not None:
                    self._arith(op.line, op.text[0], lv_type, rhs,
                                require=None if op.text[0] in "&|^" else _NUMERIC)
            return
        # not an assignment: rewind and parse as a full expression statement
        s.i = mark
        self.expr(s, scopes)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def type_check_wgsl(src: str) -> List[str]:
    """Full-module type check. Returns error strings (empty = passes).

    The input must already be preprocessed (no #ifdef) — run every shader-def
    combination through `specialize.preprocess` first, as the tests do."""
    errors: List[str] = []
    try:
        toks, structs, globals_, const_exprs, fns = _parse_module(src)
    except WgslTypeError as e:
        return [str(e)]

    consts: Dict[str, WType] = {}
    checker = _Checker(toks, structs, consts, globals_, fns, errors)
    # module consts, in order (may reference earlier consts)
    for name, declared, start, end in const_exprs:
        try:
            s = _Stream(toks[start:end] + [Tok("eof", "", toks[end].line)])
            ty = checker.expr(s, [dict()])
            if declared is not None:
                if not _conv(ty, declared):
                    errors.append(
                        f"line {toks[start].line}: const '{name}: {declared}' "
                        f"initialized with {ty}")
                ty = declared
            consts[name] = _concretize(ty)
        except WgslTypeError as e:
            errors.append(str(e))
            consts[name] = F32
    for fname in fns:
        try:
            checker.check_fn(fname)
        except WgslTypeError as e:
            errors.append(f"fn {fname}: {e}")
    return errors
