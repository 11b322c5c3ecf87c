"""Builds the port's CUDA kernels at first use and binds them with ctypes.

``nvcc`` compiles ``regneuralde_tpu_torch/csrc/*.cu`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/kernels/`` (listed in
``.gitignore``); the library's name carries a hash of the sources, so an
edited source is rebuilt. Nothing here runs at import time: the CPU tests
import every module, and this machine has no ``nvcc``.
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
    "regnde_fwd_rows": [],
    "regnde_bwd_rows": [],
    "regnde_normed_fwd": [_P] * 12 + [_I, _I, _I, _F, _F, _P],
    "regnde_normed_bwd": [_P] * 23 + [_I, _I, _I, _F, _F, _P],
}


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
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)).hexdigest()[:16]
    so = BUILD_DIR / f"libregnde_kernels_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
               "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(tmp), *map(str, sources)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        (BUILD_DIR / f"ptxas_{digest}.txt").write_text(proc.stderr)
        os.replace(tmp, so)
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
