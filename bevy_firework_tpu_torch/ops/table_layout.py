"""The fused step kernel's interface layout, defined once.

The kernel reads the spawner's structure and parameters from one int32
device buffer (f32 values stored bitwise), the collider scene from a second
one and the scene's force-field records from a third; the pool's fields
through 16 pointer slots and the frame's inputs from a row of 13 floats
passed by value in the launch arguments; with kernel stats it writes one
stats row. Every table is sized by what it holds: the spawner table by its
emitters, types and knots (the header carries the offsets that depend on
them), the collider table by its colliders and its hulls' planes, the field
records and the stats row by their counts. This module is the only
definition of those layouts: `ops.fused_step` fills the buffers, the slots
and the rows by these names, and `ops._build` writes them, with the
enumerations the kernel branches on, the narrow phase's float constants and
the turbulence basis, into a generated C++ header (`header()`, included by
`csrc/fused_step.cu` as "table_layout.h"). The CUDA source names every slot
and states no value.
"""

from __future__ import annotations

import numpy as np

from .. import colliders, collision, compiled, curve, emission_shape, force_fields

MAX_U = 8  # sub-frames per launch
TILE = 256  # lanes per tile = threads per block (the dead-rank claim's unit)

# ---- pool field slots (PoolState order; a null pointer marks an elided field) ----
FIELD_SLOTS = ("px", "py", "pz", "vx", "vy", "vz", "qx", "qy", "qz", "qw", "wx", "wy", "wz",
               "initial_scale", "age", "lifetime")
N_FIELDS = len(FIELD_SLOTS)
N_RENDER = 9  # f32 render-pack planes: instance scale, base rgba, emissive rgba
# The f16 render pack writes the whole instance record, one plane per
# contract column: px py pz, instance scale, qx qy qz qw, base rgba,
# emissive rgba (the quaternion's four planes are left out when rotation is
# elided: 12 planes, else 16)
N_RECORD = 16
PACK_F32, PACK_F16 = 1, 2  # a launch's render-pack mode (0: no pack)

# ---- frame row (floats) ----
FR_DT, FR_MOD_SCALE, FR_MOD_SPEED = 0, 1, 2
FR_PVEL, FR_TRANS, FR_ROT = 3, 6, 9  # xyz, xyz, xyzw
FRAME_WORDS = 13

# ---- spawner table: header, T type rows, E emitter rows, T curve blocks ----
# header (int32 words)
H_E = 0  # emitter count
H_T = 1  # particle type count
H_K = 2  # knots per curve row (every curve row's length: the curve rows' stride)
H_SINGLE = 3  # single particle type (no ptype plane)
H_ELIDE_ROT = 4  # rotation fields elided
H_CONST_LIFE = 5  # lifetime constant (no lifetime plane) ...
H_CONST_LIFE_VAL = 6  # ... and its value (f32)
H_EM_AT = 7  # first emitter row: TY_AT + T * TY_STRIDE
H_CV_AT = 8  # first curve block: H_EM_AT + E * EM_STRIDE
HEADER_WORDS = 16

# type rows (f32 unless noted), at a fixed start
TY_AT, TY_STRIDE = HEADER_WORDS, 28
TY_ISCALE_LO = 0
TY_ISCALE_HI = 1
TY_LIFE_LO = 2
TY_LIFE_HI = 3
TY_ACCEL = 4  # 3 words
TY_LIN_DRAG = 7
TY_ANG_ACCEL = 8  # 3 words
TY_ANG_DRAG = 11
TY_RESTITUTION = 12
TY_FRICTION = 13
TY_DESTROY = 14  # destroy_on_collision (0/1)
TY_COLL_MASK = 15  # collision filter mask, uint32 bits (int32 word)
TY_FIELD_MASK = 16  # affected_by_fields (0/1)
TY_SCALE_KIND = 17  # int: scale curve kind
TY_SCALE_N = 18  # int: ... knots
TY_BASE_KIND = 19  # int: base color gradient kind
TY_BASE_N = 20  # int: ... knots
TY_EMIS_KIND = 21  # int: emissive gradient kind
TY_EMIS_N = 22  # int: ... knots
TY_HAS_COL = 23  # int: the type collides
TY_DUMP = 24  # int: the type has a destroyed handler (dump plane)

# emitter rows (f32 unless noted), from the header's H_EM_AT
EM_STRIDE = 40
EM_COUNT = 0  # particles per cycle (one-shot: burst size)
EM_DURATION = 1
EM_OFF_START = 2
EM_OFF_END = 3
EM_SHAPE = 4  # 8 words: compiled shape row (kind, radius, quat xyzw, half extents y z)
EM_IVEL = 12  # 7 words: initial velocity RandVec3 (lo, hi, deviation, quat xyzw)
EM_IANG = 19  # 7 words: initial angular velocity RandVec3
EM_RADIAL_LO = 26
EM_RADIAL_HI = 27
EM_INHERIT = 28  # parent velocity inheritance
EM_INIT_ROT = 29  # 4 words: initial rotation quat xyzw
EM_PACING = 33  # int: pacing kind
EM_PINDEX = 34  # int: particle type spawned
EM_MODE = 35  # int: emission mode (MODE_GLOBAL / MODE_NESTED)
EM_TARGET = 36  # int: a nested emitter's parent type

# curve blocks (f32), from the header's H_CV_AT: per type CV_ROWS rows of
# H_K words each; row indices within a type's block
CV_SCALE_TS = 0
CV_SCALE_VS = 1
CV_BASE_TS = 2  # then one row per channel r g b a
CV_EMIS_TS = 7  # then one row per channel r g b a
CV_ROWS = 12


def table_words(num_emitters: int, num_types: int, knots: int) -> int:
    """Words of a spawner table with these counts (the header's offsets
    follow from them)."""
    return TY_AT + num_types * TY_STRIDE + num_emitters * EM_STRIDE + num_types * CV_ROWS * knots


# ---- collider table (a buffer of its own; int32 words, f32 bitwise) ----
# C rows, then each hull's plane rows in table order
CO_STRIDE = 16  # words per collider row
CO_KIND = 0
CO_IDENT = 1  # unrotated (1): the quaternion rotations are skipped
CO_HULL_N = 2  # hull plane count (0 for other kinds)
CO_LAYERS = 3  # layers, uint32 bits; 0 for a disabled collider (masked_layers)
CO_POS = 4  # 3 words
CO_ROT = 7  # 4 words, xyzw
CO_PARAMS = 11  # 3 words
CO_PLANES = 14  # a hull's first plane word (from the table's start; 0 for other kinds): rows (nx, ny, nz, d)
CO_RADIUS = 15  # f32: the broad phase's bounding radius about the position (collision.bounding_radius)
HULL_MAX_PLANES = colliders.HULL_MAX_PLANES
SUBSTEPS = collision.SUBSTEPS
# A collider table of at most this many words is staged in each block's
# shared memory; a larger one is read from global memory (warp-uniform
# addresses: one broadcast load per row word). 48 KB: four blocks' tables
# fit an SM's 228 KB beside their other shared memory, so the table never
# holds a collide instantiation (64 or more registers: at most four blocks
# of TILE threads per SM) below the occupancy its registers allow.
SMEM_COLLIDER_WORDS = 12 * 1024

# ---- force-field records (device buffer; int32 words, f32 bitwise): one per field ----
# Four rows of 4 words (16 bytes, aligned): the kernel reads a row with one
# 128-bit load, a field's kind-specific words in one row each
FF_STRIDE = 16  # words per field
FF_KIND = 0  # FIELD_* kind (int)
# the values every lane of a field computed alike, computed once by the
# packer in f32 (numpy's f32 product and quotient round as the card's IEEE
# ops do, so the kernel reads the bits it would compute)
FF_STRENGTH = 1  # strength * active
FF_INV_RADIUS = 2  # 1 / radius
FF_ACTIVE = 3  # 1.0 live, 0.0 disabled
FF_POS = 4  # 3 words
FF_AXIS = 8  # 3 words, unit
FF_PARAMS = 12  # 4 words: strength, radius, frequency, phase
# records staged in shared memory up to this many words (256 fields); more
# are read from global memory
SMEM_FIELD_WORDS = 256 * FF_STRIDE

# ---- stats row (kernel output, int32 words; per slot the same words, then a
# ticket, accumulate it in the stream's scratch) ----
ST_MIN = 0  # 3 f32: min(pos - scale) over survivors
ST_MAX = 3  # 3 f32: max(pos + scale)
ST_ALIVE = 6  # i32: survivors
ST_TYPES = 7  # [T] i32: survivors per type


def stats_words(num_types: int) -> int:
    """Words of a stats row for T particle types."""
    return ST_TYPES + num_types


# ---- nested scalars (device int32 buffer, zeroed per frame; kernel in- and outputs) ----
# A header word, then one record per valid nested emitter, in emitter order.
NS_ANY = 0  # header: 1 when a lane lived before the frame's spawns (the nested stage, the seed or the fold epilogue)
NS_AT = 1  # first record
NS_STRIDE = 8
NS_TOTAL = 0  # children the emitter's parents ask for this frame
NS_N = 1  # children claiming this frame: min(total, M); the rest are deferred
NS_START = 2  # the claim window's start: ring cursor, or the dead-slot rank on dead-rank archetypes
NS_NEXT = 3  # the next emitter's start: NS_START + NS_N (mod N on the ring)
NS_DROPPED = 4  # children whose window slot was not dead (pool capacity overflow)
NS_EMITTER = 5  # the record's nested emitter (its nested stage writes it)
MAX_FETCH = 10  # parent fields a nested stage reads (nested_parent_fields)
# a child's fields in the nested stage's registers: position, velocity,
# rotation, angular velocity, initial scale, age, lifetime (the rows an
# archetype elides are not stored)
CHILD_SLOTS = 16
# a child's parent-free parts, drawn before an unfolded nested stage's grid
# barrier: the shape offset, the initial velocity before the parent's
# rotation, offset * inv * radial, the angular velocity, the initial scale
# and the lifetime
CHILD_PARTS = 14
# The step kernel's shared words per merge record: the window's start, its
# children, their type, the record's emitter (the fold epilogue's)
MERGE_WORDS = 4

# ---- fleet launches (kernel row 7): S slots of one archetype per launch ----
# Per-slot records in one device int32 buffer [S, slot_words(F)]: the
# slot's frame row and its F force-field records (f32 bitwise), staged per
# block.
SL_FRAME = 0  # FRAME_WORDS f32
SL_FIELDS = 16  # F * FF_STRIDE words: the FF_* records


def slot_words(num_fields: int) -> int:
    """Words of a fleet slot's record with F force fields."""
    return SL_FIELDS + num_fields * FF_STRIDE


# Draw seeds ride the launch arguments, [slot][u]: a launch takes at most
# SEED_WORDS // U slots, and a larger fleet launches in chunks of that many.
SEED_WORDS = 128

# ---- the step's prologue: each emitter's cadence words (EMC_* of
# EMC_WORDS), staged in shared memory by warp 0 for thread 0's cadence ----
EMC_MODE, EMC_PACING, EMC_COUNT, EMC_DURATION, EMC_OFF_START, EMC_OFF_END = range(6)
EMC_WORDS = 6

# ---- launch geometry ----
# blocks per slot of the claim's and nested passes' kernels, which
# tile-stride beyond it (a step launch takes one resident wave of its
# instantiation, asked of the card: a solo launch the whole wave, a fleet
# launch an equal share per slot)
MAX_BLOCKS = 132 * 8
DEFAULT_SMEM_BYTES = 48 * 1024  # dynamic shared memory a launch takes without the opt-in attribute
# the field block's instantiations (without the narrow phase): their
# register cap (three blocks of TILE threads per SM)
FIELD_MAX_REGISTERS = 80
# the most tiles a solo dead-rank launch gives a block: its carried
# claim's bins in shared memory (past it the grid widens beyond one wave)
CLAIM_BINS = 64

# CUDA's cosf leaves its fast path from this magnitude on (its SASS: a
# branch to a Payne-Hanek reduction); the field block's straight-line
# cosine (cos_fast) takes the arguments below it
COS_FAST_BOUND = 105615.0

assert NS_EMITTER < NS_STRIDE and EM_TARGET < EM_STRIDE and TY_DUMP < TY_STRIDE and H_CV_AT < HEADER_WORDS
assert CO_RADIUS < CO_STRIDE and TILE % 32 == 0 and FF_PARAMS + 4 == FF_STRIDE
assert FF_KIND % 4 == 0 and FF_STRENGTH == FF_KIND + 1 and FF_INV_RADIUS == FF_KIND + 2
assert FF_POS % 4 == 0 and FF_AXIS % 4 == 0 and FF_PARAMS % 4 == 0 and SL_FIELDS % 4 == 0
assert SL_FRAME + FRAME_WORDS <= SL_FIELDS and SEED_WORDS >= MAX_U


def constants() -> dict:
    """Every value the CUDA source takes from Python, by its C++ name: this
    module's constants, the field slots (PX .. LIFETIME) and the pacing,
    curve and shape kinds of the modules that define them."""
    out = {k: v for k, v in globals().items() if k.isupper() and isinstance(v, int)}
    out.update({name.upper(): i for i, name in enumerate(FIELD_SLOTS)})
    for mod, prefix in ((compiled, "PACING_"), (compiled, "MODE_"), (curve, "CURVE_"), (emission_shape, "SHAPE_"),
                        (colliders, "COLLIDER_"), (force_fields, "FIELD_")):
        out.update({k: v for k, v in vars(mod).items() if k.startswith(prefix) and isinstance(v, int)})
    return out


def float_constants() -> dict:
    """The f32 constants shared with the plain versions: the narrow phase's
    miss distance and division guard and the broad phase's reach factor and
    margin (`collision`), the force fields' singular-locus guard
    (`force_fields`); and the field block's cos_fast bound."""
    return {"COLLISION_BIG": collision.BIG, "COLLISION_EPS": collision.EPS, "REACH_SCALE": collision.REACH_SCALE,
            "REACH_MARGIN": collision.REACH_MARGIN, "FIELD_EPS": force_fields.EPS, "COS_FAST_BOUND": COS_FAST_BOUND}


def array_constants() -> dict:
    """f32 tables shared with the plain versions, flattened in C order: the
    turbulence basis (`force_fields`: [octave][component][axis] directions,
    [octave][component] phases) and its directions scaled by their octave's
    amplitude. The amplitudes are powers of two, so each scaled direction
    is exact, and the kernel's cos * (amp * dir) rounds as the plain
    version's (amp * cos) * dir."""
    amp = force_fields.TURB_AMP
    assert all(float(a) == 2.0 ** round(np.log2(float(a))) for a in amp), "turbulence amplitudes: powers of two"
    return {"TURB_DIRS": [float(v) for v in force_fields.TURB_DIRS.reshape(-1)],
            "TURB_PHASE": [float(v) for v in force_fields.TURB_PHASE.reshape(-1)],
            "TURB_AMP_DIRS": [float(v) for v in (amp[:, None, None] * force_fields.TURB_DIRS).reshape(-1)]}


def header() -> str:
    """The C++ header `csrc/fused_step.cu` includes as "table_layout.h"."""
    lines = ["// Generated from bevy_firework_tpu_torch/ops/table_layout.py; do not edit.", "#pragma once"]
    lines += [f"constexpr int {k} = {v};" for k, v in constants().items()]
    lines += [f"constexpr float {k} = {v!r}f;" for k, v in float_constants().items()]
    lines += [f"__constant__ float {k}[{len(v)}] = {{{', '.join(f'{x!r}f' for x in v)}}};"
              for k, v in array_constants().items()]
    return "\n".join(lines) + "\n"
