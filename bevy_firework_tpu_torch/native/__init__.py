"""The host instance ring (`instance_ring.cpp`) and its ctypes binding.

`InstanceRing` is the hand-off of 64 B/particle instance records from the
simulation to the renderer: a ring of reusable host buffers, filled from
planar arrays (the device's layout) by a producer thread and taken, newest
frame first, by a consumer thread, without locks (latest-wins: a slow
consumer skips frames). `compact_dense`, `compact_dense_planes` and
`transpose_planes` are the ring's interleave and compaction without a ring:
the synchronous extract's host pass.

The library builds at first use, `g++ -O3 -std=c++17 -shared -fPIC`, into
`native/_build/` beside this file, named by a hash of the source and the
flags; nothing is built at import. There is no other implementation: a host
without g++ raises at first use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).parent / "instance_ring.cpp"
BUILD_DIR = Path(__file__).parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
FLOATS_PER_INSTANCE = 16  # 64 bytes


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libinstance_ring_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the ring library if the one for the source's current hash is
    missing (into a temporary name, then renamed: concurrent builders are
    safe); returns its path."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the instance ring builds from instance_ring.cpp at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name} ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The ring library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fp, hp = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint16)
    lib.ring_create.restype = vp
    lib.ring_create.argtypes = [i64, i32]
    lib.ring_destroy.argtypes = [vp]
    lib.ring_capacity.restype = i64
    lib.ring_capacity.argtypes = [vp]
    lib.ring_begin_write.restype = i32
    lib.ring_begin_write.argtypes = [vp]
    lib.ring_slot_data.restype = fp
    lib.ring_slot_data.argtypes = [vp, i32]
    lib.ring_publish_planar.argtypes = [vp, i32, fp, i64, i64, i64]
    lib.ring_publish_rows.argtypes = [vp, i32, fp, i64, i64]
    lib.ring_publish_dense.restype = i64
    lib.ring_publish_dense.argtypes = [vp, i32, fp, i64, i64, i64]
    lib.ring_publish_dense_f16.restype = i64
    lib.ring_publish_dense_f16.argtypes = [vp, i32, hp, i64, i64, i64]
    lib.ring_publish_dense_ptrs.restype = i64
    lib.ring_publish_dense_ptrs.argtypes = [vp, i32, ctypes.POINTER(fp), fp, i64, i64]
    lib.ring_publish_dense_ptrs_f16.restype = i64
    lib.ring_publish_dense_ptrs_f16.argtypes = [vp, i32, ctypes.POINTER(hp), hp, i64, i64]
    lib.ring_acquire.restype = i32
    lib.ring_acquire.argtypes = [vp, ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.ring_release.argtypes = [vp, i32]
    lib.transpose_planes.argtypes = [fp, fp, i64, i64]
    lib.compact_dense.restype = i64
    lib.compact_dense.argtypes = [fp, fp, i64, i64]
    lib.compact_dense_ptrs.restype = i64
    lib.compact_dense_ptrs.argtypes = [fp, ctypes.POINTER(fp), fp, i64]
    return lib


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class PlaneSet:
    """16 planes of N lanes by contract column, as the ring's C calls take
    them: a C array of their pointers (null for a None plane, whose column
    is defaults[p] on every row) and the defaults, f32 or f16 (`f16`).
    Contiguous planes of the right type are used in place, so a set built
    once over buffers that stay put serves every frame written into them
    (AsyncRenderReader's staging buffers)."""

    def __init__(self, planes, defaults, f16: bool = False):
        dtype, ctype = (np.float16, ctypes.c_uint16) if f16 else (np.float32, ctypes.c_float)
        self.f16 = f16
        self.arrays = [None if p is None else np.ascontiguousarray(p, dtype=dtype) for p in planes]
        self.n = self.arrays[3].shape[0]
        ptr_t = ctypes.POINTER(ctype)
        self.ptrs = (ptr_t * FLOATS_PER_INSTANCE)(*[ptr_t() if a is None else a.ctypes.data_as(ptr_t)
                                                    for a in self.arrays])
        self.defaults = np.asarray(defaults, dtype=dtype)
        self.defaults_ptr = self.defaults.ctypes.data_as(ptr_t)


class InstanceRing:
    """A ring of `n_slots` host buffers of `capacity` instance records.

    Producer (the reader thread):
        ring.publish_dense_planes(planes, defaults, frame_id)   # and the other publish_*
    Consumer (the render thread):
        got = ring.acquire()          # (rows [count, 16] view, frame_id) or None
        ...upload / draw...
        ring.release()

    A producer that finds every slot busy takes the oldest ready one (the
    consumer is behind: only the latest frame is drawn); when none is free
    or ready, the frame is dropped and publish returns -1. f16 publishes
    fill the slot with f16 rows (32 B each, at its start): take them with
    `acquire_f16`."""

    def __init__(self, capacity: int, n_slots: int = 3):
        self._lib = get_lib()
        self.capacity = int(capacity)
        self.n_slots = int(n_slots)
        self._acquired = None
        self._h = self._lib.ring_create(self.capacity, self.n_slots)

    def close(self):
        if self._h:
            self._lib.ring_destroy(self._h)
            self._h = None

    # ------------------------------------------------------------- producer
    def publish(self, planes: np.ndarray, count: int, frame_id: int) -> int:
        """planes [16, M] f32 (the compacted planar layout): the first
        `count` columns become rows."""
        planes = np.ascontiguousarray(planes, dtype=np.float32)
        count = min(int(count), self.capacity, planes.shape[1])
        slot = self._lib.ring_begin_write(self._h)
        if slot >= 0:
            self._lib.ring_publish_planar(self._h, slot, _fptr(planes), planes.shape[1], count, frame_id)
        return slot

    def publish_dense(self, planes: np.ndarray, frame_id: int) -> int:
        """planes [16, N] f32 over every pool lane, dead lanes at scale == 0
        (`render.pack_instances_dense`): the live lanes become rows."""
        planes = np.ascontiguousarray(planes, dtype=np.float32)
        slot = self._lib.ring_begin_write(self._h)
        if slot >= 0:
            self._lib.ring_publish_dense(self._h, slot, _fptr(planes), planes.shape[1], planes.shape[1], frame_id)
        return slot

    def publish_dense_f16(self, planes: np.ndarray, frame_id: int) -> int:
        """publish_dense of f16 planes [16, N] (`pack_instances_dense_f16`;
        scale bits 0x0000 / 0x8000 mark dead lanes): f16 rows."""
        u16 = np.ascontiguousarray(planes, dtype=np.float16).view(np.uint16)
        slot = self._lib.ring_begin_write(self._h)
        if slot >= 0:
            ptr = u16.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))
            self._lib.ring_publish_dense_f16(self._h, slot, ptr, u16.shape[1], u16.shape[1], frame_id)
        return slot

    def publish_planes(self, planes: PlaneSet, frame_id: int) -> int:
        """publish_dense from a PlaneSet: the live lanes (scale != 0; in f16
        bits other than 0x0000 / 0x8000) become f32 or f16 rows."""
        slot = self._lib.ring_begin_write(self._h)
        if slot >= 0:
            publish = self._lib.ring_publish_dense_ptrs_f16 if planes.f16 else self._lib.ring_publish_dense_ptrs
            publish(self._h, slot, planes.ptrs, planes.defaults_ptr, planes.n, frame_id)
        return slot

    def publish_dense_planes(self, planes, defaults, frame_id: int) -> int:
        """publish_dense from 16 separate [N] f32 planes by contract column
        (None: the column is defaults[p] on every row, as the identity
        quaternion of an elided rotation); plane 3 (scale) is required."""
        return self.publish_planes(PlaneSet(planes, defaults), frame_id)

    def publish_dense_planes_f16(self, planes, defaults, frame_id: int) -> int:
        """publish_dense_planes of f16 planes (the kernel's f16 record; None
        planes take the f16 of defaults[p]): f16 rows."""
        return self.publish_planes(PlaneSet(planes, defaults, f16=True), frame_id)

    def publish_rows(self, rows: np.ndarray, frame_id: int) -> int:
        """Rows [count, 16] f32 as they are (a copy)."""
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        count = min(rows.shape[0], self.capacity)
        slot = self._lib.ring_begin_write(self._h)
        if slot >= 0:
            self._lib.ring_publish_rows(self._h, slot, _fptr(rows), count, frame_id)
        return slot

    # ------------------------------------------------------------- consumer
    def acquire(self):
        """The newest ready slot: (rows [count, 16] f32, a view into the
        slot, frame_id), or None. Hold it until `release`."""
        cnt, fid = ctypes.c_int64(), ctypes.c_int64()
        slot = self._lib.ring_acquire(self._h, ctypes.byref(cnt), ctypes.byref(fid))
        if slot < 0:
            return None
        buf = np.ctypeslib.as_array(self._lib.ring_slot_data(self._h, slot), shape=(self.capacity, 16))
        self._acquired = slot
        return buf[: cnt.value], fid.value

    def acquire_f16(self):
        """acquire() of a slot an f16 publish filled: (rows [count, 16] f16,
        frame_id), or None."""
        got = self.acquire()
        if got is None:
            return None
        buf, fid = got
        count = buf.shape[0]
        return buf.reshape(-1).view(np.float16)[: count * 16].reshape(count, 16), fid

    def release(self):
        if self._acquired is not None:
            self._lib.ring_release(self._h, self._acquired)
            self._acquired = None


def compact_dense(planes: np.ndarray) -> np.ndarray:
    """[16, N] dense f32 planes (dead lanes at scale == 0 in plane 3) ->
    [count, 16] rows of the live lanes, slot order kept."""
    planes = np.ascontiguousarray(planes, dtype=np.float32)
    n = planes.shape[1]
    out = np.empty((n, 16), np.float32)
    count = get_lib().compact_dense(_fptr(out), _fptr(planes), n, n)
    return out[:count]


def compact_dense_planes(planes, defaults) -> np.ndarray:
    """16 separate [N] f32 planes by contract column (None: defaults[p] on
    every row; plane 3, the scale, is required and 0 marks dead lanes) ->
    [count, 16] rows of the live lanes, slot order kept."""
    ps = PlaneSet(planes, defaults)
    out = np.empty((ps.n, 16), np.float32)
    count = get_lib().compact_dense_ptrs(_fptr(out), ps.ptrs, ps.defaults_ptr, ps.n)
    return out[:count]


def transpose_planes(planes: np.ndarray) -> np.ndarray:
    """[16, M] planar f32 -> [M, 16] rows."""
    planes = np.ascontiguousarray(planes, dtype=np.float32)
    m = planes.shape[1]
    out = np.empty((m, 16), np.float32)
    get_lib().transpose_planes(_fptr(out), _fptr(planes), m, m)
    return out
