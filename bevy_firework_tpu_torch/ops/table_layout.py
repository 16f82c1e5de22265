"""The fused step kernel's interface layout, defined once.

The kernel reads the spawner's structure and parameters from one int32
device buffer (f32 values stored bitwise), the collider scene from a second
one, the pool's fields through 16 pointer slots, the frame's inputs from a
row of 13 floats and the scene's force fields from a row of MAX_F field
records, both passed by value in the launch arguments; with kernel stats it
writes one stats row. This module is the only definition of those layouts:
`ops.fused_step` fills the buffers, the slots and the rows by these names,
and `ops._build` writes them, with the enumerations the kernel branches on,
the narrow phase's float constants and the turbulence basis, into a
generated C++ header (`header()`, included by `csrc/fused_step.cu` as
"table_layout.h"). The CUDA source names every slot and states no value.
"""

from __future__ import annotations

from .. import colliders, collision, compiled, curve, emission_shape, force_fields

# ---- capacities ----
MAX_E = 8  # emitters
MAX_T = 8  # particle types
MAX_K = 16  # knots per curve
MAX_U = 8  # sub-frames per launch
MAX_C = 32  # colliders
MAX_F = 8  # scene force fields
TILE = 256  # lanes per tile = threads per block (the dead-rank claim's unit)

# ---- pool field slots (PoolState order; a null pointer marks an elided field) ----
FIELD_SLOTS = ("px", "py", "pz", "vx", "vy", "vz", "qx", "qy", "qz", "qw", "wx", "wy", "wz",
               "initial_scale", "age", "lifetime")
N_FIELDS = len(FIELD_SLOTS)
N_RENDER = 9  # render-pack planes: instance scale, base rgba, emissive rgba

# ---- frame row (floats) ----
FR_DT, FR_MOD_SCALE, FR_MOD_SPEED = 0, 1, 2
FR_PVEL, FR_TRANS, FR_ROT = 3, 6, 9  # xyz, xyz, xyzw
FRAME_WORDS = 13

# ---- table header (int32 words; [E] or [T] runs where noted) ----
H_E = 0  # emitter count
H_SINGLE = 3  # single particle type (no ptype plane)
H_ELIDE_ROT = 4  # rotation fields elided
H_CONST_LIFE = 5  # lifetime constant (no lifetime plane) ...
H_CONST_LIFE_VAL = 6  # ... and its value (f32)
H_PACING = 8  # [E] pacing kind
H_PINDEX = H_PACING + MAX_E  # [E] particle type spawned
H_SCALE_KIND = H_PINDEX + MAX_E  # [T] scale curve kind
H_SCALE_N = H_SCALE_KIND + MAX_T  # [T] scale curve knots
H_BASE_KIND = H_SCALE_N + MAX_T  # [T] base color gradient kind
H_BASE_N = H_BASE_KIND + MAX_T  # [T] ... knots
H_EMIS_KIND = H_BASE_N + MAX_T  # [T] emissive gradient kind
H_EMIS_N = H_EMIS_KIND + MAX_T  # [T] ... knots
H_HAS_COL = H_EMIS_N + MAX_T  # [T] type collides
H_DUMP = H_HAS_COL + MAX_T  # [T] type has a destroyed handler (dump plane)
H_MODE = H_DUMP + MAX_T  # [E] emission mode (MODE_GLOBAL / MODE_NESTED)
H_TARGET = H_MODE + MAX_E  # [E] nested emitter's parent type

# ---- emitter rows (f32): slot offsets within a row ----
EM_AT, EM_STRIDE = 128, 48
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

# ---- type rows (f32) ----
TY_AT, TY_STRIDE = EM_AT + MAX_E * EM_STRIDE, 20
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

# ---- curve rows (f32, MAX_K words each): row indices within a type's block ----
CV_SCALE_TS = 0
CV_SCALE_VS = 1
CV_BASE_TS = 2  # then one row per channel r g b a
CV_EMIS_TS = 7  # then one row per channel r g b a
CV_ROWS = 12
CV_AT, CV_STRIDE = TY_AT + MAX_T * TY_STRIDE, CV_ROWS * MAX_K
TABLE_WORDS = CV_AT + MAX_T * CV_STRIDE

# ---- collider table (a buffer of its own; int32 words, f32 bitwise) ----
CO_STRIDE = 16  # words per collider row
CO_KIND = 0
CO_IDENT = 1  # unrotated (1): the quaternion rotations are skipped
CO_HULL_N = 2  # hull plane count (0 for other kinds)
CO_LAYERS = 3  # layers, uint32 bits; 0 for a disabled collider (masked_layers)
CO_POS = 4  # 3 words
CO_ROT = 7  # 4 words, xyzw
CO_PARAMS = 11  # 3 words
HULL_MAX_PLANES = colliders.HULL_MAX_PLANES
CO_PLANE_STRIDE = HULL_MAX_PLANES * 4  # words per collider's plane rows (nx, ny, nz, d)
CO_PLANES_AT = MAX_C * CO_STRIDE
COLLIDER_WORDS = CO_PLANES_AT + MAX_C * CO_PLANE_STRIDE
SUBSTEPS = collision.SUBSTEPS

# ---- force-field row (launch argument; int32 words, f32 bitwise): MAX_F records ----
FF_STRIDE = 12  # words per field
FF_KIND = 0  # FIELD_* kind (int)
FF_POS = 1  # 3 words
FF_AXIS = 4  # 3 words, unit
FF_PARAMS = 7  # 4 words: strength, radius, frequency, phase
FF_ACTIVE = 11  # 1.0 live, 0.0 disabled
FIELD_WORDS = MAX_F * FF_STRIDE

# ---- stats row (kernel output, int32 words; one per block as partials) ----
ST_MIN = 0  # 3 f32: min(pos - scale) over survivors
ST_MAX = 3  # 3 f32: max(pos + scale)
ST_ALIVE = 6  # i32: survivors
ST_TYPES = 7  # [MAX_T] i32: survivors per type
STATS_WORDS = ST_TYPES + MAX_T

# ---- nested scalars (device int32 buffer, zeroed per frame; kernel in- and outputs) ----
# A header word, then one record per valid nested emitter, in emitter order.
NS_ANY = 0  # header: 1 when a lane lived before the frame's spawns (the nested count kernels set it)
NS_AT = 1  # first record
NS_STRIDE = 8
NS_TOTAL = 0  # children the emitter's parents ask for this frame
NS_N = 1  # children claiming this frame: min(total, M); the rest are deferred
NS_START = 2  # the claim window's start: ring cursor, or the dead-slot rank on dead-rank archetypes
NS_NEXT = 3  # the next emitter's start: NS_START + NS_N (mod N on the ring)
NS_DROPPED = 4  # children whose window slot was not dead (pool capacity overflow)
MAX_FETCH = 10  # parent fields a fetch-mode cadence pass reads (nested_parent_fields)

# ---- fleet launches (kernel row 7): S slots of one archetype per launch ----
# Per-slot records in one device int32 buffer [S, SLOT_WORDS]: the slot's
# frame row and its force-field records (f32 bitwise), staged per block.
SL_FRAME = 0  # FRAME_WORDS f32
SL_FIELDS = 16  # FIELD_WORDS: the FF_* records
SLOT_WORDS = SL_FIELDS + FIELD_WORDS
# Draw seeds ride the launch arguments, [slot][u]: a launch takes at most
# SEED_WORDS // U slots, and a larger fleet launches in chunks of that many.
SEED_WORDS = 128

# ---- launch geometry ----
MAX_BLOCKS = 132 * 8  # the step tile-strides beyond 8 blocks per SM per slot (stats partials)

assert H_TARGET + MAX_E <= EM_AT and NS_DROPPED < NS_STRIDE and EM_INIT_ROT + 4 <= EM_STRIDE and TY_FIELD_MASK < TY_STRIDE
assert CO_PARAMS + 3 <= CO_STRIDE and TILE % 32 == 0 and FF_ACTIVE < FF_STRIDE
assert SL_FRAME + FRAME_WORDS <= SL_FIELDS and SEED_WORDS >= MAX_U


def launch_blocks(n: int) -> int:
    """Blocks per slot of a step launch over n lanes (the C launcher's
    grid.x): one per TILE-lane tile, at most MAX_BLOCKS."""
    return min(-(-n // TILE), MAX_BLOCKS)


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
    miss distance and division guard (`collision`), the force fields'
    singular-locus guard (`force_fields`)."""
    return {"COLLISION_BIG": collision.BIG, "COLLISION_EPS": collision.EPS, "FIELD_EPS": force_fields.EPS}


def array_constants() -> dict:
    """f32 tables shared with the plain versions, flattened in C order: the
    turbulence basis (`force_fields`: [octave][component][axis] directions,
    [octave][component] phases, [octave] amplitudes)."""
    return {"TURB_DIRS": [float(v) for v in force_fields.TURB_DIRS.reshape(-1)],
            "TURB_PHASE": [float(v) for v in force_fields.TURB_PHASE.reshape(-1)],
            "TURB_AMP": [float(v) for v in force_fields.TURB_AMP.reshape(-1)]}


def header() -> str:
    """The C++ header `csrc/fused_step.cu` includes as "table_layout.h"."""
    lines = ["// Generated from bevy_firework_tpu_torch/ops/table_layout.py; do not edit.", "#pragma once"]
    lines += [f"constexpr int {k} = {v};" for k, v in constants().items()]
    lines += [f"constexpr float {k} = {v!r}f;" for k, v in float_constants().items()]
    lines += [f"__constant__ float {k}[{len(v)}] = {{{', '.join(f'{x!r}f' for x in v)}}};"
              for k, v in array_constants().items()]
    return "\n".join(lines) + "\n"
