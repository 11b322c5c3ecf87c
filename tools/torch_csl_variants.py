#!/usr/bin/env python3
"""K7-CSL's forward and K8-CSL's reverse tile body in variants of
``csrc/csl_tsit5.cuh``: each built from ``csl_tsit5.cu`` alone into a
library of its own, swapped in under the package's wrappers, and timed at
phase 15's inputs (1024 x 44 x 100, 1.4e-8): device ms a launch of
``csl_fwd_kernel`` and of ``csl_bwd_kernel`` under ``torch.profiler``, what
``ptxas`` reported, whether K7-CSL's rows equal its plain version's and its
sums its schedule's (``fc.plain_csl_fwd_tiles``) bitwise, and the distance
of K8-CSL's outputs from the plain version.

    python3 tools/torch_csl_variants.py [--variants shipped,norev,nocw,k16+noepif]

Variants: ``shipped`` (the source as it is); ``norev`` (the recompute and
the seeds only: the reverse loop runs no stage), ``nofwd`` (the reverse on
the records the recompute would write, the recompute's stages not run),
``nocw`` (no weight-cotangent update), ``norowsum`` (no row sums in the
recompute), ``g2`` and ``g8`` (2 or 8 rows a product item instead of 4),
``u2f64``, ``u2f32``, ``u2all``, ``u4f64`` (the f64 products' reduction
loops, the f32 ones' or both unrolled 2 or 4 times); of the forward:
``chains`` (its products as the reverse's f64 chains, bitwise too),
``k4``, ``k16`` (the tensor-core products as m16n8k4 or m16n8k16 instead
of m16n8k8), ``load1``, ``load8`` (the parameters loaded with 1 or 8 loads
a thread in flight instead of 16), ``norowsumf`` (no row sums),
``noepif`` (no softplus or sigmoid after the products), ``nohopf`` (no
hop of the e^T J chain), ``noprodf`` (no product at all), ``stage1f`` (one
stage), ``nostagesf`` (no stage: the parameters' and the tile's loads and
the norm sums only). ``norev``, ``nofwd``, ``nocw``, ``norowsum`` and the
forward's ``no*`` and ``stage1f`` are wrong by design and only say what a
part costs; ``a+b`` makes both variants' changes, and a name given twice is
timed twice (``chains,shipped,shipped,chains``). Needs one GPU and
``nvcc``.
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
# the forward's products (and their epilogues) skipped
HOP_SKIP = ("__device__ __forceinline__ void csl_fwd_hop(const CslLayer& L, const double* v, "
            "int pv,\n                                            const float* g, Epi epi) {\n",
            "__device__ __forceinline__ void csl_fwd_hop(const CslLayer& L, const double* v, "
            "int pv,\n                                            const float* g, Epi epi) {\n"
            "  return;\n")
AFFINE_SKIP = ("__device__ __forceinline__ void csl_fwd_affine(const CslLayer& L, const double* x, "
               "int px,\n                                               Epi epi) {\n",
               "__device__ __forceinline__ void csl_fwd_affine(const CslLayer& L, const double* x, "
               "int px,\n                                               Epi epi) {\n  return;\n")
# the forward's products as the reverse's f64 chains
CHAINS = [("  csl_mma_rows(x, px, L.n_in, L.n_out, L.b, [&](int o, int k) { return L.W[o * "
           "stride + k]; },\n               epi);\n", "  csl_affine_rows(L, x, px, epi);\n"),
          ("  csl_mma_rows(v, pv, L.n_out, L.n_in, nullptr,\n               [&](int k, int o) "
           "{ return __fmul_rn(L.W[o * stride + k], g[o]); }, epi);\n",
           "  csl_hop_rows(L, v, pv, g, epi);\n")]
# the tensor-core instruction at a reduction depth of 4 or 16 instead of 8
MMA_K8 = ('  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "\n'
          '      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"\n'
          '      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])\n'
          '      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));\n')
MMA_K4 = ('  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, "\n'
          '      "{%6}, {%0, %1, %2, %3};"\n'
          '      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])\n'
          '      : "d"(a[0]), "d"(a[1]), "d"(b[0]));\n')
MMA_K16 = ('  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "\n'
           '      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};"\n'
           '      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])\n'
           '      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),\n'
           '        "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));\n')
# the forward's epilogue functions (softplus, sigmoid) taken out
NOEPI = [("    s.o1[r * ph + o] = ov;\n    s.xb[r * ph + o] = csl_softplus(ov);\n",
          "    s.o1[r * ph + o] = ov;\n    s.xb[r * ph + o] = ov;\n"),
         ("    s.o2[r * ph + o] = ov;\n    s.xa[r * ph + o] = csl_softplus(ov);\n",
          "    s.o2[r * ph + o] = ov;\n    s.xa[r * ph + o] = ov;\n"),
         ("    s.xb[r * ph + o] = __fmul_rn(v, csl_sigmoid(s.o2[r * ph + o]));\n",
          "    s.xb[r * ph + o] = __fmul_rn(v, s.o2[r * ph + o]);\n"),
         ("    s.xa[r * ph + o] = __fmul_rn(v, csl_sigmoid(s.o1[r * ph + o]));\n",
          "    s.xa[r * ph + o] = __fmul_rn(v, s.o1[r * ph + o]);\n")]
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
    "chains": CHAINS,
    "load1": [("constexpr int kCslLoadsInFlight = 16;", "constexpr int kCslLoadsInFlight = 1;")],
    "load8": [("constexpr int kCslLoadsInFlight = 16;", "constexpr int kCslLoadsInFlight = 8;")],
    "k4": [("constexpr int kCslMmaK = 8;", "constexpr int kCslMmaK = 4;"), (MMA_K8, MMA_K4)],
    "k16": [("constexpr int kCslMmaK = 8;", "constexpr int kCslMmaK = 16;"), (MMA_K8, MMA_K16)],
    "noepif": NOEPI,
    "stage1f": [("kStages = 6;", "kStages = 1;")],
    "norowsumf": [("q < (kinetic ? 3 : 1) * R;", "q < 0;")],
    "nostagesf": [("kStages = 6;", "kStages = 0;")],
    "nohopf": [HOP_SKIP],
    "noprodf": [HOP_SKIP, AFFINE_SKIP],
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
        for a, b in [s for part in name.split("+") for s in VARIANTS[part]]:
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
            print(f"[variant] {name}: nvcc failed, left out:\n{err[-2000:]}", flush=True)
            continue
        kernel = None
        for line in err.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = m.group(1)
            elif kernel and ("csl_bwd_kernel" in kernel or "csl_fwd_kernel" in kernel) and (
                    "registers" in line or "spill" in line):
                which = "fwd" if "csl_fwd_kernel" in kernel else "bwd"
                print(f"[ptxas] {name} {which}: {line.split(':', 1)[-1].strip()}")
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
    libs = build(list(dict.fromkeys(names)), out)  # a name given twice is timed twice
    dev = torch.device("cuda", 0)
    B, D, H, tol = cs.FFJORD_BATCH, cs.FFJORD_DIM, cs.FFJORD_HIDDEN, cs.FLAGSHIP_TOL
    gen = torch.Generator().manual_seed(cs.SEED + 12)
    leaves, y, k1 = cs._csl_inputs(gen, B, D, H, False, dev)
    cts = [torch.randn(y.shape, generator=gen).to(dev), torch.randn(y.shape, generator=gen).to(dev),
           *(torch.tensor(v, device=dev) for v in (0.7, 1.3, -0.4))]
    t, dt = torch.tensor(0.07, device=dev), torch.tensor(0.11, device=dev)
    plain = fc._csl_bwd_math(t, dt, y, k1, leaves, cts, tol, tol)
    sched = fc.plain_csl_fwd_tiles(t, dt, y, k1, leaves, tol, tol)
    groups = lambda g: [torch.stack(g[:2]), g[2], g[3],
                        torch.cat([x.flatten() for x in g[4][:fc.N_PARAMS]])]
    for name in (n for n in names if n in libs):
        lib = ctypes.CDLL(libs[name])
        for fn, argtypes in _cuda._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        _cuda._lib = lib
        fc._csl_bwd_scratch.cache_clear()
        fc.check_fwd_plan.cache_clear()
        fwd = lambda: fc.csl_normed_sweep(t, dt, y, k1, leaves, tol, tol)
        got = fwd()
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(got, sched)]
        ms = cs._device_ms(fwd, "csl_fwd_kernel")
        print(f"[variant] {name}: csl_fwd_kernel device ms {ms!r}; bitwise the schedule "
              f"(y_new, k7, err, num, den) {same}", flush=True)
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
