"""Random bits for the step: the frame-key chain and the per-lane draws.

Two generators, both counter-based and stateless:

  * `threefry_split(key)`: threefry-2x32 on the host, bit-identical to
    `jax.random.split(key)` under `jax_threefry_partitionable=True` (each
    new key i is threefry2x32(key, (0, i))). `PoolState.rng_key` advances
    through it exactly like the JAX package's key, and each frame's draw
    seed is word 0 of the frame key, as `bevy_firework_tpu.ops.fused_step`
    takes it. `threefry_fold_in` and `threefry_uniform` are
    `jax.random.fold_in` and `jax.random.uniform` under the same setting:
    fold_in(key, d) = threefry2x32(key, (0, d)); the uniform at flat index
    i draws threefry2x32(key, (hi(i), lo(i))), keeps the xor of the two
    output words, and maps its top 23 bits into [1, 2) minus 1. The nested
    child stage draws its rows with them, so its children match the JAX
    package's lane for lane (the CUDA nested-stage kernel evaluates the same
    function per rank). A captured chain of the XLA layout computes its
    frames' fold-ins on the host in one pass (`xla_chain_keys`) and its
    draws read them from device words (`FrameKeyWords`, `DeviceKey`): the
    same bits, with no key baked into the graph.
  * Philox-4x32-10 (Salmon et al., SC'11, the Random123 constants) written
    in torch int64 ops with 32-bit masking. The CUDA step kernel implements
    the same function, so kernel and plain version draw the same bits for
    the same (seed, lane): key = (seed, 0), counter = (lane, block, 0, 0),
    draw d of a lane is word d % 4 of block d // 4. A uniform keeps the top
    24 bits: u = (bits >> 8) * 2^-24, in [0, 1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF

# --------------------------------------------------------------------------
# threefry-2x32 (host side)
# --------------------------------------------------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_CPU_CHUNK = 1 << 14  # words per numpy pass of threefry_uniform on the CPU


def threefry2x32(k0, k1, x0, x1):
    """threefry-2x32 with 20 rounds on Python ints holding uint32 values
    (scalar ints: a frame's key split is two evaluations, and numpy's
    per-op overhead on 2-element arrays cost ~0.1 ms per split), or on
    int64 tensors holding them (every intermediate stays below 2^62)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def threefry_split(key) -> tuple[np.ndarray, np.ndarray]:
    """`jax.random.split(key)` (2 keys): returns (new_key, frame_key), each a
    uint32[2] numpy array."""
    k0, k1 = (int(v) & _MASK32 for v in key)
    a0, a1 = threefry2x32(k0, k1, 0, 0)
    b0, b1 = threefry2x32(k0, k1, 0, 1)
    # split's key i is threefry2x32(key, (0, i))
    return np.array([a0, a1], np.uint32), np.array([b0, b1], np.uint32)


class DeviceKey(NamedTuple):
    """A threefry key as two int64 0-d tensors holding its uint32 words,
    read from device words (so a captured graph reads the key of each
    replay, not the one it was captured with)."""

    k0: torch.Tensor
    k1: torch.Tensor


class FrameKeyWords:
    """A frame key of the XLA layout whose fold-ins the chain computed on
    the host (`xla_chain_keys`): `fold_in(self, d)` is the key of `data[j]
    == d`, words 2j and 2j + 1 of `words` (int32 [2 * len(data)], on the
    pool's device), a `DeviceKey`. A fold-in the chain did not compute
    raises KeyError."""

    def __init__(self, data: tuple, words: torch.Tensor):
        if words.shape != (2 * len(data),):
            raise ValueError(f"frame key words: {2 * len(data)} words for {len(data)} fold-ins, got "
                             f"{tuple(words.shape)}")
        self.data = tuple(int(d) for d in data)
        self.words = words.to(torch.int64) & _MASK32

    def fold_in(self, data: int) -> DeviceKey:
        try:
            j = self.data.index(int(data))
        except ValueError:
            raise KeyError(f"no fold_in({data}) in this frame's key words (fold-ins {self.data})") from None
        return DeviceKey(self.words[2 * j], self.words[2 * j + 1])


def threefry_fold_in(key, data: int):
    """`jax.random.fold_in(key, data)`: a uint32[2] numpy array; of a
    `FrameKeyWords`, the `DeviceKey` the chain computed for `data`."""
    if isinstance(key, FrameKeyWords):
        return key.fold_in(data)
    k0, k1 = (int(v) & _MASK32 for v in key)
    return np.array(threefry2x32(k0, k1, 0, int(data) & _MASK32), np.uint32)


def xla_chain_keys(key, n: int, data: tuple) -> tuple[np.ndarray, np.ndarray]:
    """The key chain of n frames of the XLA layout in one host pass: the key
    after them and each frame's fold-ins, uint32 [n, len(data), 2]: per
    frame new_key, frame_key = split(key), then fold_in(frame_key, d) for
    each d of `data` (the step's draws: d = e for global emitter e,
    1000 + e for nested emitter e)."""
    k0, k1 = (int(v) & _MASK32 for v in key)
    out = np.empty((int(n), len(data), 2), np.uint32)
    for f in range(int(n)):
        f0, f1 = threefry2x32(k0, k1, 0, 1)
        k0, k1 = threefry2x32(k0, k1, 0, 0)
        for j, d in enumerate(data):
            out[f, j] = threefry2x32(f0, f1, 0, int(d) & _MASK32)
    return np.array([k0, k1], np.uint32), out


def _row_index(rows, width: int, device) -> torch.Tensor:
    """int64 [len(rows)]: each row's first flat index, row * width, made on
    `device` from aranges over the runs of consecutive rows (no host copy:
    a captured graph may hold it)."""
    runs, start = [], None
    for i, r in enumerate(rows):
        if start is None or r != rows[i - 1] + 1:
            if start is not None:
                runs.append((start, rows[i - 1] + 1))
            start = r
    runs.append((start, rows[-1] + 1))
    parts = [torch.arange(a, b, dtype=torch.int64, device=device) for a, b in runs]
    return (parts[0] if len(parts) == 1 else torch.cat(parts)) * width


def threefry_uniform(key, shape, device=None, rows=None, cols=None) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32)` in [0, 1), on `device`.
    rows (a 2-D shape's row indices) and cols (a 2-D shape's column window
    (a, b)): draw only those rows and columns, [len(rows), b - a], each
    value the one at the same place of the whole draw (the draw is counter
    based: the value at flat index row * shape[1] + col depends on that
    index alone; a shard of a pool draws its lanes' columns so). On the CPU
    the words are numpy uint32 (`_threefry2x32_u32`: wrapping arithmetic,
    half the bytes of the masked int64 form and no masks), the same bits.
    key: uint32 words on the host, or a `DeviceKey`, which draws through
    the int64 tensor route on either device (no host read of the key)."""
    on_device = isinstance(key, DeviceKey)
    k0, k1 = key if on_device else (int(v) & _MASK32 for v in key)
    whole = rows is None and cols is None
    if whole:
        out_shape = shape
    else:
        row_ids = range(shape[0]) if rows is None else rows
        a, b = (0, shape[1]) if cols is None else cols
        out_shape = (len(row_ids), b - a)
    if not on_device and _numpy_route(device, shape):
        idx = np.arange(int(np.prod(shape)), dtype=np.uint32) if whole else (
            np.asarray(row_ids, np.uint32)[:, None] * np.uint32(shape[1]) + np.arange(a, b, dtype=np.uint32)).ravel()
        bits = np.empty_like(idx)
        zero = np.zeros(min(idx.shape[0], _CPU_CHUNK), np.uint32)
        for i in range(0, idx.shape[0], _CPU_CHUNK):  # chunks that stay in cache: ~2x the whole-array passes
            b0, b1 = _threefry2x32_u32(np.uint32(k0), np.uint32(k1), zero[:idx.shape[0] - i], idx[i:i + _CPU_CHUNK])
            np.bitwise_xor(b0, b1, out=bits[i:i + _CPU_CHUNK])
        bits >>= np.uint32(9)
        bits |= np.uint32(0x3F800000)
        return (torch.from_numpy(bits.view(np.float32)) - 1.0).reshape(out_shape)
    idx = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=device) if whole else (
        _row_index(list(row_ids), shape[1], device)[:, None]
        + torch.arange(a, b, dtype=torch.int64, device=device)).reshape(-1)
    return _uniform_int64(k0, k1, idx).reshape(out_shape)


def _numpy_route(device, shape) -> bool:
    """`threefry_uniform` draws with numpy uint32 words: on the CPU, while
    the flat indices fit 32 bits."""
    return (device is None or torch.device(device).type == "cpu") and int(np.prod(shape)) < (1 << 32)


def _uniform_int64(k0, k1, idx: torch.Tensor) -> torch.Tensor:
    """The uniforms at flat indices `idx` (int64) from int64 tensor words:
    `threefry_uniform`'s route on the card. k0, k1: Python ints, or int64
    0-d tensors on idx's device (a `DeviceKey`), the same bits."""
    b0, b1 = threefry2x32(k0, k1, idx >> 32, idx & _MASK32)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def frame_seeds(key, n: int) -> tuple[np.ndarray, list[int]]:
    """Split the key n times in order (one frame each); returns the key after
    the n frames and each frame's draw seed (word 0 of its frame key)."""
    k0, k1 = (int(v) & _MASK32 for v in key)
    seeds = []
    for _ in range(n):
        seeds.append(threefry2x32(k0, k1, 0, 1)[0])
        k0, k1 = threefry2x32(k0, k1, 0, 0)
    return np.array([k0, k1], np.uint32), seeds


def chain_seeds(key, shape) -> tuple[np.ndarray, list[np.ndarray]]:
    """The key chain of a chain of launches of `shape` (frames per launch),
    in one host pass: the key after all of them and each launch's draw
    seeds (uint32[u]), the words `frame_seeds(key, u)` gives launch by
    launch."""
    final, seeds = frame_seeds(key, int(sum(shape)))
    seeds = np.asarray(seeds, np.uint32)
    ends = np.cumsum(shape)
    return final, [seeds[e - u:e] for u, e in zip(shape, ends)]


def chain_seeds_stacked(keys, shape) -> tuple[np.ndarray, list[np.ndarray]]:
    """`chain_seeds` over S keys (a fleet's): the keys after the chain [S, 2]
    and each launch's seeds [S, u] (slot-major, as a fleet launch takes
    them), the words `frame_seeds_stacked(keys, u)` gives launch by launch."""
    final, seeds = frame_seeds_stacked(keys, int(sum(shape)))
    ends = np.cumsum(shape)
    return final, [np.ascontiguousarray(seeds[:, e - u:e]) for u, e in zip(shape, ends)]


def hybrid_chain_keys(key, n: int, emitters) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The key chain of n hybrid frames (an archetype with a nested
    emitter, one frame per launch) in one host pass: the key after them,
    each frame's step seed (word 1 of its kernel key; uint32[n]) and each
    frame's nested-stage keys (fold_in(frame_key, 1000 + e) per nested
    emitter e of `emitters`; uint32[n, len(emitters), 2]), the words a
    hybrid frame takes from its two splits (new_key, frame_key =
    split(key); new_key, kernel_key = split(new_key))."""
    k0, k1 = (int(v) & _MASK32 for v in key)
    seeds = np.empty(n, np.uint32)
    stage = np.empty((n, len(emitters), 2), np.uint32)
    for f in range(n):
        n0, n1 = threefry2x32(k0, k1, 0, 0)
        f0, f1 = threefry2x32(k0, k1, 0, 1)
        k0, k1 = threefry2x32(n0, n1, 0, 0)
        seeds[f] = threefry2x32(n0, n1, 0, 1)[1]
        for j, e in enumerate(emitters):
            stage[f, j] = threefry2x32(f0, f1, 0, (1000 + int(e)) & _MASK32)
    return np.array([k0, k1], np.uint32), seeds, stage


def _threefry2x32_u32(k0: np.ndarray, k1: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """threefry2x32 on numpy uint32 arrays (wrapping arithmetic, in-place
    ufuncs: a few dozen array operations whatever the array length)."""
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    tmp = np.empty_like(x1)
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 += x1
            np.left_shift(x1, np.uint32(r), out=tmp)
            x1 >>= np.uint32(32 - r)
            x1 |= tmp
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3]
        x1 += np.uint32(i + 1)
    return x0, x1


def frame_seeds_stacked(keys, n: int) -> tuple[np.ndarray, np.ndarray]:
    """`frame_seeds` over S keys at once (a fleet's per-slot key chains, as
    the JAX fleet prelude splits each slot's key): keys [S, 2] uint32 words;
    returns the keys after the n frames [S, 2] uint32 and the draw seeds
    [S, n] uint32. One frame's two splits (counters 0 and 1) run as one
    evaluation over 2S lanes, a cost per frame that does not grow with S."""
    keys = np.asarray(keys).astype(np.uint32).reshape(-1, 2)
    S = keys.shape[0]
    k0, k1 = np.tile(keys[:, 0], 2), np.tile(keys[:, 1], 2)
    x1 = np.repeat(np.array([0, 1], np.uint32), S)
    zero = np.zeros(2 * S, np.uint32)
    seeds = np.empty((S, n), np.uint32)
    for f in range(n):
        a0, a1 = _threefry2x32_u32(k0, k1, zero, x1)
        seeds[:, f] = a0[S:]
        k0, k1 = np.tile(a0[:S], 2), np.tile(a1[:S], 2)
    return np.stack([k0[:S], k1[:S]], axis=1), seeds


# --------------------------------------------------------------------------
# Philox-4x32-10 (torch int64 with 32-bit masking)
# --------------------------------------------------------------------------

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) words of the 64-bit product m * x for m, x < 2^32, exact in
    int64 by splitting x into 16-bit halves."""
    p_lo = (x & 0xFFFF) * m  # < 2^48
    p_hi = (x >> 16) * m  # < 2^48
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32(c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor, c3: torch.Tensor, k0: int, k1: int):
    """Philox-4x32-10 on int64 tensors holding uint32 values."""
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def lane_uniforms(seed: int, lanes: torch.Tensor, n_draws: int) -> list[torch.Tensor]:
    """The step's per-lane uniforms: n_draws float32 tensors shaped like
    `lanes` (int64 global lane indices), draw d from Philox block d // 4."""
    out = []
    zero = torch.zeros_like(lanes)
    for b in range((n_draws + 3) // 4):
        words = philox4x32(lanes, torch.full_like(lanes, b), zero, zero, int(seed) & _MASK32, 0)
        out.extend(words)
    scale = float(np.float32(1.0 / (1 << 24)))
    return [(w >> 8).to(torch.float32) * scale for w in out[:n_draws]]
