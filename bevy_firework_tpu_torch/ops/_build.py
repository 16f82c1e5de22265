"""Build and load the port's CUDA kernels.

`nvcc` compiles `csrc/*.cu` (plain C interface, no PyTorch headers; one
process per source, all started together) and links them into a shared
library under `ops/_build/` at first use, named by a hash of the sources,
the kernel header, the generated layout header (`table_layout.header()`,
included as "table_layout.h") and the flags, so an edited source or layout
rebuilds; the library is loaded with ctypes. ptxas reports each kernel's
registers, stack, spills and shared memory (`-Xptxas -v`); the report is
kept beside the library (`ptxas_report()`). Nothing is built when the
package is imported.
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

from . import table_layout

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
# the launchers and small kernels, then the step kernel's five shares
SOURCES = ("fused_step.cu", "step_ring.cu", "step_dead_rank.cu", "step_fleet_ring.cu", "step_fleet_dead_rank.cu",
           "step_merge.cu")
HEADERS = ("fused_step_kernel.cuh",)
# -fmad=false: no multiply-add contraction, so the kernels keep the plain
# versions' op order (see the FMA policy in csrc/fused_step.cu). No fast math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(table_layout.header().encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libbevy_firework_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if the library for their current hash is missing;
    returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        (Path(work) / "table_layout.h").write_text(table_layout.header())
        tmp = Path(work) / out.name
        nvcc = nvcc_path()
        objs = [Path(work) / f"{Path(s).stem}.o" for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", work, "-c", "-o", str(o), str(CSRC / s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for s, o in zip(SOURCES, objs)]
        reports = [p.communicate() for p in procs]
        for s, p, (_out, err) in zip(SOURCES, procs, reports):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s} ({p.returncode}):\n{err}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n{link.stderr}")
        out.with_suffix(".ptxas.txt").write_text("".join(err for _out, err in reports))
        os.replace(tmp, out)
    return out


def ptxas_report() -> str:
    """ptxas's report of the current library's build (built if missing)."""
    return build().with_suffix(".ptxas.txt").read_text()


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    u = ctypes.c_uint32
    lib.bf_fused_step.argtypes = [p, p, i, i, p, p, p, p, p, p, p, p, p, i, p, p, p, i, i, i, i, p, i, p, p, p,
                                  p, p, p, i, i, i, p, p, p, i, p, p, p, i, i, i, p, i, i, i, i, p, p, p, p, p,
                                  p]
    lib.bf_fused_step.restype = ctypes.c_int
    lib.bf_dead_rank_offsets.argtypes = [p, p, p, i, i, p]
    lib.bf_dead_rank_offsets.restype = ctypes.c_int
    lib.bf_nested_counts.argtypes = [p, i, p, p, p, p, p, p, p, p, i, p]
    lib.bf_nested_counts.restype = ctypes.c_int
    lib.bf_nested_stage.argtypes = [p, i, p, p, p, p, p, p, p, p, p, p, p, i, p, p, p, p, p, p, p, p, p, p, u, u, i,
                                    p, i, i, i, i, i, p, p, p]
    lib.bf_nested_stage.restype = ctypes.c_int
    lib.bf_step_occupancy.argtypes = [i, i, i, i, i, i, i]
    lib.bf_step_occupancy.restype = ctypes.c_int
    lib.bf_step_warp_occupancy.argtypes = [i, i]
    lib.bf_step_warp_occupancy.restype = ctypes.c_int
    lib.bf_step_merge_occupancy.argtypes = [i, i, i]
    lib.bf_step_merge_occupancy.restype = ctypes.c_int
    lib.bf_cos_fast_mismatches.argtypes = [u, u, p, p]
    lib.bf_cos_fast_mismatches.restype = ctypes.c_int
    lib.bf_empty_launches.argtypes = [i, p]
    lib.bf_empty_launches.restype = ctypes.c_int
    lib.bf_error_string.argtypes = [ctypes.c_int]
    lib.bf_error_string.restype = ctypes.c_char_p
    return lib
