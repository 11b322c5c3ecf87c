"""Variants of the package's CUDA sources for the sizing tools
(``torch_k3_variants.py``, ``torch_k4_variants.py``): each built into a
library of its own, timed per iteration, and swapped in under the package's
wrappers on a forced tile plan. Needs a CUDA device and ``nvcc``."""

import contextlib
import ctypes
import re
import shutil
import statistics
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "regneuralde_tpu_torch" / "csrc"


def build(header, variants, names, probes, out, keep, defines=()):
    """One library a variant of ``names``: the sources copied under
    ``out/<name>/``, the substitutions ``variants[name]`` made in
    ``header`` (each must occur in it), ``probes`` appended to
    ``whole_solve.cu`` (with ``#define <name upper-cased>`` first where the
    name is in ``defines``), compiled by ``nvcc`` as ``ops/_cuda.py``
    compiles (``-Xptxas -v``, all variants at once) with
    ``weight_cotangents.cu`` into ``out/<name>.so``. Prints what ``ptxas``
    reported for the kernels whose names hold one of ``keep``, and returns
    the libraries with the package's signatures bound."""
    from regneuralde_tpu_torch.ops import _cuda

    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    base = (CSRC / header).read_text()
    procs = {}
    for name in names:
        src = out / name
        if src.exists():
            shutil.rmtree(src)
        shutil.copytree(CSRC, src)
        text = base
        for a, b in variants[name]:
            if a not in text:
                raise SystemExit(f"variant {name}: {a!r} is not in {header}")
            text = text.replace(a, b)
        (src / header).write_text(text)
        flag = f"#define {name.upper()}\n" if name in defines else ""
        (src / "whole_solve.cu").write_text(flag + (CSRC / "whole_solve.cu").read_text()
                                            + probes)
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
             "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-o", str(out / f"{name}.so"),
             str(src / "whole_solve.cu"), str(src / "weight_cotangents.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{err[-4000:]}")
        kernel = None
        for line in err.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = m.group(1)
            elif kernel and any(k in kernel for k in keep) and (
                    "registers" in line or "spill" in line):
                print(f"[ptxas] {name} {kernel[:60]}: {line.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn, argtypes in _cuda._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def per_iteration_ms(launch, n1=2, n2=22):
    """Device ms of one iteration: CUDA events around launches of n1 and
    n2 iterations, the difference over n2 - n1, median of 5."""
    import torch

    def one(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch(n)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    launch(n1)
    torch.cuda.synchronize()
    return statistics.median((one(n2) - one(n1)) / (n2 - n1) for _ in range(5))


@contextlib.contextmanager
def forced(plan=None, lib=None):
    """The package's MLPDynamics wrappers on ``plan`` (a ``WalkPlan``, its
    sizes not checked against the library's: a variant's slab ring may
    change them) and on ``lib`` (a library of ``build``), each where
    given; both restored on exit."""
    from regneuralde_tpu_torch.ops import _cuda
    from regneuralde_tpu_torch.ops import whole_solve as ws

    saved = ws.walk_plan, ws._cuda_walk_plan, _cuda.library()
    try:
        if plan is not None:
            ws.walk_plan = lambda *_a, **_k: plan
            ws._cuda_walk_plan = lambda *_a, **_k: plan
        if lib is not None:
            _cuda._lib = lib
        yield
    finally:
        ws.walk_plan, ws._cuda_walk_plan, _cuda._lib = saved
