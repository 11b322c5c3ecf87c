"""Builds the port's CUDA kernels at first use and binds them with ctypes.

``nvcc`` compiles each ``regneuralde_tpu_torch/csrc/*.cu`` for ``sm_90a``,
all at once in parallel, and links them into a shared library with a
plain C interface under ``build/kernels/`` (listed in ``.gitignore``); the
library's name carries a hash of the sources and headers, so an edited
source is rebuilt. Nothing here runs at import time: the CPU tests import
every module, and a machine without a card has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

_lib = None
build_seconds = None  # wall time of this process's build (None if cached)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "regnde_normed_fwd": [_P] * 12 + [_I] * 8 + [_F, _F, _P],
    "regnde_normed_bwd": [_P] * 31 + [_I] * 10 + [_F, _F, _P],
    "regnde_whole_solve_fwd": [_P] * 18 + [_I] * 10 + [_F] * 9 + [_P],
    "regnde_whole_solve_bwd": [_P] * 36 + [_I] * 13 + [_F] * 9 + [_P],
    "regnde_walk_col_align": [],
    "regnde_walk_max_tile": [],
    "regnde_walk_smem_bytes": [_I] * 3,
    "regnde_lanes_walk_smem_bytes": [_I] * 3,
    "regnde_solve_smem_bytes": [_I] * 3,
    "regnde_solve_scratch_floats": [_I] * 5,
    "regnde_whole_solve_altmlp_fwd": [_P] * 4 + [_I] + [_P] * 9 + [_I] * 5 + [_F] * 9 + [_P],
    "regnde_whole_solve_altmlp_bwd": [_P] * 5 + [_I] + [_P] * 12 + [_I] * 6 + [_F] * 9 + [_P],
    "regnde_altmlp_rows": [],
    "regnde_altmlp_slot_rows": [],
    "regnde_altmlp_fwd_smem_bytes": [_I] * 3,
    "regnde_altmlp_max_depth": [],
    "regnde_altmlp_fwd": [_P] * 5 + [_I] + [_P] * 4 + [_I] * 3 + [_F] * 2 + [_P],
    "regnde_altmlp_bwd": [_P] * 4 + [_I] + [_P] * 8 + [_I] * 3 + [_F] * 2 + [_P],
    "regnde_altmlp_bwd_rows": [],
    "regnde_altmlp_bwd_smem_bytes": [_I] * 3,
    "regnde_csl_rows": [],
    "regnde_csl_slot_rows": [],
    "regnde_csl_fwd_smem_bytes": [_I] * 3,
    "regnde_csl_fwd": [_P] * 5 + [_I] + [_P] * 4 + [_I] * 3 + [_F] * 2 + [_P],
    "regnde_csl_bwd": [_P] * 5 + [_I] + [_P] * 8 + [_I] * 3 + [_F] * 2 + [_P],
    "regnde_csl_bwd_rows": [],
    "regnde_csl_bwd_smem_bytes": [_I] * 3,
    "regnde_csl_bwd_max_tiles": [],
    "regnde_whole_solve_csl_fwd_grid": [_I] * 4,
    "regnde_whole_solve_csl_fwd": [_P] * 4 + [_I] + [_P] * 9 + [_I] * 5 + [_F] * 9 + [_P],
    "regnde_whole_solve_csl_bwd": [_P] * 5 + [_I] + [_P] * 12 + [_I] * 6 + [_F] * 9 + [_P],
    "regnde_sde_rows": [],
    "regnde_sde_chain": [],
    "regnde_sde_threads": [],
    "regnde_sde_fixed_instance": [_P, _I, _I],
    "regnde_sde_smem_bytes": [_P, _I, _I],
    "regnde_sde_whole_solve_fwd": [_P] * 18 + [_I] * 4 + [_F] * 9 + [_P],
    "regnde_sde_whole_solve_bwd": [_P] * 22 + [_I] * 5 + [_F] * 9 + [_P],
    "regnde_sde_whole_solve_cubic_fwd": [_P] * 18 + [_I] * 4 + [_F] * 9 + [_P],
    "regnde_sde_whole_solve_cubic_bwd": [_P] * 22 + [_I] * 5 + [_F] * 9 + [_P],
    "regnde_lanes_fwd": [_P] * 14 + [_I] * 8 + [_P],
    "regnde_lanes_solve_smem_bytes": [_I] * 3,
    "regnde_lanes_solve_scratch_floats": [_I] * 5,
    "regnde_lanes_bwd": [_P] * 33 + [_I] * 10 + [_P],
    "regnde_mlp_tsit5_fwd": [_P] * 14 + [_I] * 8 + [_P],
    "regnde_mlp_tsit5_bwd": [_P] * 33 + [_I] * 10 + [_P],
    "regnde_spike_wholesolve": [_F] + [_P] * 5 + [_I] * 2 + [_P],
    "regnde_weight_cotangents": [_P] * 9 + [_I] * 5 + [_P],
}
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
          "-Xcompiler", "-fPIC"]
# Per-source flags: the SDE whole solve and K15 round each multiply and add
# of their algebra on its own, as the plain versions' separate ATen ops do.
_SOURCE_FLAGS = {"sde_whole_solve.cu": ["-fmad=false"], "spike_wholesolve.cu": ["-fmad=false"]}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library():
    """The kernels' ctypes library, built on the first call."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    sources = sorted(_CSRC.glob("*.cu"))
    hashed = sources + sorted(_CSRC.glob("*.cuh"))
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in hashed)).hexdigest()[:16]
    so = BUILD_DIR / f"libregnde_kernels_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{digest}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        start = time.perf_counter()
        nvcc = _nvcc()
        procs = [subprocess.Popen(
            [nvcc, *_FLAGS, *_SOURCE_FLAGS.get(src.name, []), "-Xptxas", "-v", "-c", "-o",
             str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, obj in zip(sources, objs)]
        reports = []
        for src, proc in zip(sources, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{err}")
            reports.append(err)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        (BUILD_DIR / f"ptxas_{digest}.txt").write_text("".join(reports))
        os.replace(tmp, so)
        for obj in objs:
            obj.unlink()
        build_seconds = time.perf_counter() - start
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def ptxas_report() -> str:
    """What ``ptxas -v`` said about each kernel (registers, shared memory,
    spills) when the current library was built."""
    reports = sorted(BUILD_DIR.glob("ptxas_*.txt"), key=lambda p: p.stat().st_mtime)
    return reports[-1].read_text() if reports else ""


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
