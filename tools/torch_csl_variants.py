#!/usr/bin/env python3
"""K8-CSL's reverse tile body in variants of ``csrc/csl_tsit5.cuh``: each
built from ``csl_tsit5.cu`` alone into a library of its own, swapped in
under the package's wrapper, and timed at phase 15's inputs (1024 x 44 x
100, 1.4e-8): device ms a launch of ``csl_bwd_kernel`` under
``torch.profiler``, what ``ptxas`` reported, and the distance of its
outputs from the plain version.

    python3 tools/torch_csl_variants.py [--variants shipped,norev,nocw]

Variants: ``shipped`` (the source as it is); ``norev`` (the recompute and
the seeds only: the reverse loop runs no stage), ``nofwd`` (the reverse on
the records the recompute would write, the recompute's stages not run),
``nocw`` (no weight-cotangent update), ``norowsum`` (no row sums in the
recompute), ``g2`` and ``g8`` (2 or 8 rows a product item instead of 4),
``u2f64``, ``u2f32``, ``u2all``, ``u4f64`` (the f64 products' reduction
loops, the f32 ones' or both unrolled 2 or 4 times). ``norev``, ``nofwd``,
``nocw`` and ``norowsum`` are wrong by design and only say what a part
costs. Needs one GPU and ``nvcc``.
"""

import argparse
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

HEADER = "csl_tsit5.cuh"
# the products' reduction loops unrolled twice: the f64 ones (recompute),
# the f32 ones (reverse)
U64 = [(f"    for (; {i} + 2 <= {n}; {i} += 2) {{",
        f"#pragma unroll 2\n    for (; {i} + 2 <= {n}; {i} += 2) {{") for i, n in (("k", "K"), ("o", "O"))]
U32 = [(f"    for (; {i} + 4 <= {n}; {i} += 4) {{",
        f"#pragma unroll 2\n    for (; {i} + 4 <= {n}; {i} += 4) {{") for i, n in (("k", "K"), ("o", "O"))]
VARIANTS = {
    "shipped": [],
    "norev": [("for (int i = 6; i >= 1; --i) {", "for (int i = 6; i >= 7; --i) {")],
    "nofwd": [("    csl_reverse_stage_fwd(s, s.ks + i * n, ti, rec_g + (i - 1) * R * RF, wsm, "
               "A, D, H,\n                          kinetic);\n", "")],
    "nocw": [("    csl_cw_update(acc, s, D, H);\n", "")],
    "norowsum": [("for (int q = threadIdx.x; q < R * (kinetic ? 3 : 1); q += kThreads) {",
                  "for (int q = threadIdx.x; q < 0; q += kThreads) {")],
    "u2f64": U64,
    "u2f32": U32,
    "u2all": U64 + U32,
    "u4f64": [(a, b.replace("unroll 2", "unroll 4")) for a, b in U64],
    "g2": [("constexpr int kCslGroup = 4;", "constexpr int kCslGroup = 2;")],
    "g8": [("constexpr int kCslGroup = 4;", "constexpr int kCslGroup = 8;")],
}


def build(names, out):
    """One library a variant, compiled as ``ops/_cuda.py`` compiles, all at
    once; prints ptxas' registers and spills of ``csl_bwd_kernel``."""
    from regneuralde_tpu_torch.ops import _cuda

    csrc = Path(_cuda._CSRC)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name in names:
        src = out / name
        shutil.copytree(csrc, src)
        text = (csrc / HEADER).read_text()
        for a, b in VARIANTS[name]:
            if text.count(a) != 1:
                raise SystemExit(f"variant {name}: {a!r} is not once in {HEADER}")
            text = text.replace(a, b)
        (src / HEADER).write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_cuda._FLAGS, "-shared", "-Xptxas", "-v", "-o", str(out / f"{name}.so"),
             str(src / "csl_tsit5.cu")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
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
            elif kernel and "csl_bwd_kernel" in kernel and ("registers" in line
                                                            or "spill" in line):
                print(f"[ptxas] {name}: {line.split(':', 1)[-1].strip()}")
        libs[name] = str(out / f"{name}.so")
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    names = ap.parse_args().variants.split(",")
    import ctypes

    import torch

    import chip_smoke as cs
    from regneuralde_tpu_torch.ops import _cuda
    from regneuralde_tpu_torch.ops import fused_csl as fc

    out = Path(tempfile.mkdtemp())
    libs = build(names, out)
    dev = torch.device("cuda", 0)
    B, D, H, tol = cs.FFJORD_BATCH, cs.FFJORD_DIM, cs.FFJORD_HIDDEN, cs.FLAGSHIP_TOL
    gen = torch.Generator().manual_seed(cs.SEED + 12)
    leaves, y, k1 = cs._csl_inputs(gen, B, D, H, False, dev)
    cts = [torch.randn(y.shape, generator=gen).to(dev), torch.randn(y.shape, generator=gen).to(dev),
           *(torch.tensor(v, device=dev) for v in (0.7, 1.3, -0.4))]
    t, dt = torch.tensor(0.07, device=dev), torch.tensor(0.11, device=dev)
    plain = fc._csl_bwd_math(t, dt, y, k1, leaves, cts, tol, tol)
    groups = lambda g: [torch.stack(g[:2]), g[2], g[3],
                        torch.cat([x.flatten() for x in g[4][:fc.N_PARAMS]])]
    for name in names:
        lib = ctypes.CDLL(libs[name])
        for fn, argtypes in _cuda._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        _cuda._lib = lib
        fc._csl_bwd_scratch.cache_clear()
        bwd = lambda: fc.csl_normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)
        got = bwd()
        torch.cuda.synchronize()
        errs = [cs._rel(a, b) for a, b in zip(groups(got), groups(plain))]
        ms = cs._device_ms(bwd, "csl_bwd_kernel")
        print(f"[variant] {name}: csl_bwd_kernel device ms {ms!r}; rel err against the plain "
              f"version (ct_t|ct_dt, ct_y, ct_k1, params) {errs}", flush=True)
    shutil.rmtree(out)


if __name__ == "__main__":
    main()
