#!/usr/bin/env python3
"""K7's forward and K8's reverse tile body in variants of
``csrc/altmlp_tsit5.cuh``: each built from ``altmlp_tsit5.cu`` alone into a
library of its own, swapped in under the package's wrappers, and timed at
phase 8's inputs (256 x 20 x 50 x 4, 1.4e-8): device ms a launch of
``altmlp_fwd_kernel`` and its slot sum and of ``altmlp_bwd_kernel`` under
``torch.profiler``, what ``ptxas`` reported for both, whether K7's rows are
the plain version's and its rows and sums its schedule's
(``fg.plain_altmlp_fwd_tiles``) bitwise, and the distance of K8's outputs
from the plain version's.

    python3 tools/torch_altmlp_variants.py [--variants shipped,r8,r8,shipped] [--f0]

Variants: ``shipped`` (the source as it is: 2-row tiles, at most 7 terms
a lane's share of a sum); ``r1``, ``r4``, ``r8`` (1, 4 or 8 rows a tile);
``chain10``, ``chain13``, ``chain25`` (at most 10, 13 or 25 terms a lane's
share of a sum: fewer lanes a sum); ``mma`` (8-row tiles, the recompute's
affine maps on the FP64 tensor cores, ``mma.sync.m16n8k8`` f64 transposed,
16 outputs x the tile's 8 rows, the sum from the bias over the reduction in
f64, rounded once); ``lb1`` (K8 launched with a bound of one block an SM,
so ``ptxas`` may take 255 registers instead of 128); ``smemcw`` (every
weight and bias cotangent in shared memory, none in registers); wrong by
design, to say what a part costs: ``norev`` (the recompute and the seeds
only), ``nocw`` (no weight or bias cotangent), ``stage1`` (one stage each
way), ``nostages`` (none: the launch, the loads, the seeds and the stores),
``noprod`` (the products' sums skipped), ``noepi`` (the products'
epilogues skipped), ``nobar`` (no barrier between the layers' phases).
The forward's: ``fr4`` (4-row tiles, two norm-sum slots a tile),
``fchain4``, ``fchain13`` (at most 4 or 13 terms a lane's share of a
sum), ``fgeneric`` (the latent widths not compiled as constants); wrong by
design:
``fnoload`` (no leaves loaded), ``fstage1`` (one stage).
``a+b`` makes both variants' changes, and a name given twice is timed
twice, so ``shipped,r8,r8,shipped`` is an A B B A in one process. With ``--f0``, each variant's K8 also walks
phase 11's record at 1.4e-8 (the plain forward's, 49 saves) as every trial
step's pullback under the plain walk's scalar chain, seeded with y1's
cotangent alone: its ct_f0's and the time scalars' distance from the
plain walk and from a float64 walk (phase 11 holds K4's ct_f0 there to
1e-3 of the plain walk; it is the float32 residual of the cotangents of t
and dt_eff, rounding). Needs one GPU and ``nvcc``.
"""

import argparse
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

HEADER = "altmlp_tsit5.cuh"

# the recompute's affine maps on the FP64 tensor cores (8-row tiles only):
# out^T (outputs x rows) = W (outputs x K) x^T, M = 16 outputs a warp at a
# time, N = the tile's 8 rows, K 8 a step; A's element e at output g + 8 (e
# % 2), column q + 4 (e / 2); B's element e at column q + 4 e of row g; D's
# d0, d1 at output g, rows 2 q, 2 q + 1, d2, d3 at output g + 8 (lane = 4 g
# + q)
MMA_BODY = r'''
  static_assert(kAltBwdRows == 8, "the mma's N is the tile's 8 rows");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const double* xr = x + (size_t)g * px;
  for (int m0 = 16 * warp; m0 < N; m0 += 16 * kWarps) {
    const int ja = m0 + g, jb = ja + 8;
    double d[4];
    d[0] = d[1] = ja < N ? (double)b[ja] : 0.0;
    d[2] = d[3] = jb < N ? (double)b[jb] : 0.0;
    for (int i0 = 0; i0 < K; i0 += 8) {
      double a[4], v[2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e % 2 ? jb : ja, i = i0 + q + 4 * (e / 2);
        a[e] = j < N && i < K ? (double)W[j * (K + 1) + i] : 0.0;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = i0 + q + 4 * e;
        v[e] = i < K ? xr[i] : 0.0;
      }
      asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
          "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
          : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(v[0]), "d"(v[1]));
    }
    if (ja < N) {
      epi(2 * q, ja, (float)d[0]);
      epi(2 * q + 1, ja, (float)d[1]);
    }
    if (jb < N) {
      epi(2 * q, jb, (float)d[2]);
      epi(2 * q + 1, jb, (float)d[3]);
    }
  }
  return;
'''
AFFINE = ("                                                const double* x, int px, Epi epi) {\n"
          "  constexpr int G = kAltGroup, NG = kAltBwdRows / G;\n  const int lg = alt_split_lg(K)")
# the reverse over the stages, run for no stage; the recompute's stage loop
REV = ("  for (int i = 6; i >= 1; --i) {\n    const float* rec = s.rec(i);",
       "  for (int i = 6; i >= 7; --i) {\n    const float* rec = s.rec(i);")
FWD = "  for (int i = 1; i <= 6; ++i) {\n    float* rec = s.rec(i);"
CW = "        alt_cw_stage(cw, s.cw, gps, rec, depth, D, H);\n"

ROWS = "constexpr int kAltBwdRows = 2;"
CHAIN = "constexpr int kAltChain = 7;"
# the forward body's
FROWS = "constexpr int kAltRows = 2;"
FCHAIN = "constexpr int kAltFwdChain = 7;"
FWIDTHS = "  if (D == kAltLatentD && H == kAltLatentH)\n"
FSTAGES = "  for (int i = 1; i <= 6; ++i) {\n    const float* W = wsm;"
FLOAD = ("altmlp_tsit5.cu", "  alt_fwd_load_weights(leaves, depth, D, H, wsm);\n")
# the forward's lanes a sum under each chain variant (fg.ALT_FWD_CHAIN)
FWD_CHAINS = {"fchain4": 4, "fchain13": 13}

VARIANTS = {
    "shipped": [],
    "r1": [(ROWS, ROWS.replace("2;", "1;"))],
    "r4": [(ROWS, ROWS.replace("2;", "4;"))],
    "r8": [(ROWS, ROWS.replace("2;", "8;"))],
    "chain10": [(CHAIN, CHAIN.replace("7;", "10;"))],
    "chain13": [(CHAIN, CHAIN.replace("7;", "13;"))],
    "chain25": [(CHAIN, CHAIN.replace("7;", "25;"))],
    "mma": [(ROWS, ROWS.replace("2;", "8;")),
            (AFFINE, AFFINE.replace("  constexpr int G", MMA_BODY + "  constexpr int G"))],
    "lb1": [("altmlp_tsit5.cu", "__global__ void __launch_bounds__(kThreads)\naltmlp_bwd_kernel(",
             "__global__ void __launch_bounds__(kThreads, 1)\naltmlp_bwd_kernel(")],
    "smemcw": [("  return 2 * depth > kAltRegLayers ||", "  return true ||"),
               ("    if (q >= nl) break;", "    if (true) break;"),
               ("const int first = l < kAltRegLayers ? t0 + kThreads : t0;",
                "const int first = t0;"),
               ("const bool reg = l < kAltRegLayers && t < kThreads;", "const bool reg = false;"),
               ("const bool reg = l < kAltRegLayers && o < kThreads;", "const bool reg = false;")],
    "norev": [REV],
    "nocw": [(CW, "")],
    "stage1": [(FWD, FWD.replace("i <= 6", "i <= 1")), (REV[0], REV[0].replace("i = 6;", "i = 1;"))],
    "nostages": [(FWD, FWD.replace("i <= 6", "i <= 0")), REV],
    "noprod": [("    int k = s;\n", "    int k = K;\n"), ("    int o = s;  // four terms", "    int o = N;  // four terms")],
    "noepi": [("        if ((j & (S - 1)) == s) epi(g * G + j, o, (float)acc[j]);",
               "        if ((j & (S - 1)) == s && acc[j] == 12345.0) epi(g * G + j, o, (float)acc[j]);"),
              ("        if ((j & (S - 1)) == s) epi(g * G + j, k, acc[j]);",
               "        if ((j & (S - 1)) == s && acc[j] == 12345.0f) epi(g * G + j, k, acc[j]);")],
    "fr4": [(FROWS, FROWS.replace("2;", "4;"))],
    "fchain4": [(FCHAIN, FCHAIN.replace("7;", "4;"))],
    "fchain13": [(FCHAIN, FCHAIN.replace("7;", "13;"))],
    "fgeneric": [(FWIDTHS, "  if (false)\n")],
    "fnoload": [(*FLOAD[:2], "")],
    "fstage1": [(FSTAGES, FSTAGES.replace("i <= 6", "i <= 1"))],
    "nobar": [("      __syncthreads();\n      if (l < nl - 1) {", "      if (l < nl - 1) {"),
              ("      __syncthreads();\n      if (fetch && l == nl - 1)", "      if (fetch && l == nl - 1)")],
}


def build(names, out):
    """One library a variant, compiled as ``ops/_cuda.py`` compiles, all at
    once; prints ptxas' registers and spills of ``altmlp_bwd_kernel``."""
    from regneuralde_tpu_torch.ops import _cuda

    csrc = Path(_cuda._CSRC)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name in names:
        src = out / name
        shutil.copytree(csrc, src)
        texts = {}
        for sub in [s for part in name.split("+") for s in VARIANTS[part]]:
            fname = sub[0] if len(sub) == 3 else HEADER  # (file,) a, b
            text = texts.get(fname) or (csrc / fname).read_text()
            a, b = sub[-2:]
            if text.count(a) != 1:
                raise SystemExit(f"variant {name}: {a!r} is not once in {fname}")
            texts[fname] = text.replace(a, b)
        for fname, text in texts.items():
            (src / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_cuda._FLAGS, "-shared", "-Xptxas", "-v", "-o", str(out / f"{name}.so"),
             str(src / "altmlp_tsit5.cu")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
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
            elif kernel and ("registers" in line or "spill" in line):
                for k in ("altmlp_fwd_kernel", "altmlp_bwd_kernel"):
                    if k in kernel:
                        print(f"[ptxas] {name} {k}: {line.split(':', 1)[-1].strip()}")
        libs[name] = str(out / f"{name}.so")
    return libs


def _f0_walks(dev):
    """Phase 11's record at 1.4e-8 and its plain and float64 walks; returns
    a function that walks it with the current library's K8 and says how far
    that walk's ct_f0 and time scalars lie from the two."""
    import json

    import torch

    import chip_smoke as cs
    from regneuralde_tpu_torch.ops import fused_generic as fg
    from regneuralde_tpu_torch.ops import ode
    from regneuralde_tpu_torch.ops import whole_solve as ws
    from regneuralde_tpu_torch.ops.controller import PIController

    gen = torch.Generator().manual_seed(cs.SEED + 4)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    B, D, H, depth, tol = (cs.LATENT_BATCH, cs.LATENT_DIM, cs.LATENT_HIDDEN, cs.LATENT_DEPTH,
                           cs.FLAGSHIP_TOL)
    leaves = []
    for _ in range(depth):
        leaves += [rnd(H, D, scale=D ** -0.5), rnd(H, scale=0.1), rnd(D, H, scale=H ** -0.5),
                   rnd(D, scale=0.1)]
    y0 = rnd(B, D, scale=0.8)
    _, saveat = cs.latent_batches(1, dev)
    ctrl = PIController.for_order(5)
    t0, t1, f0, dt0 = ode.solve_prologue(fg.alternating_mlp_apply(depth), y0, 0.0, 1.0,
                                         tuple(leaves), tol, tol)
    sa, ys_init = ode.saveat_rows(saveat, t0, t1, y0)
    rec = ws.plain_whole_solve_fwd(t0, t1, dt0, y0, f0, leaves, tol, tol, ctrl,
                                   cs.LATENT_MAX_STEPS, dynamics="altmlp", saveat=sa,
                                   ys_init=ys_init)
    ns = int(rec.final[3:5].sum().item())
    ct_y1 = torch.randn(B, D, generator=torch.Generator().manual_seed(cs.SEED + 5)).to(dev)
    tel = torch.zeros(4, cs.LATENT_MAX_STEPS, device=dev)
    bkw = dict(dynamics="altmlp", saveat=sa, ct_ys=torch.zeros_like(rec.ys))
    d = lambda x: x.double()
    plain = ws.plain_whole_solve_bwd(rec, ns, ct_y1, tel, t0, t1, leaves, tol, tol, ctrl, **bkw)
    f64 = ws.plain_whole_solve_bwd(ws.SolveRecord(*map(d, rec)), ns, d(ct_y1), d(tel), d(t0),
                                   d(t1), [d(x) for x in leaves], tol, tol, ctrl,
                                   dynamics="altmlp", saveat=d(sa), ct_ys=d(bkw["ct_ys"]))
    plain_steps = ws.plain_steps

    def walk():
        def steps(dyn, rtol, atol):
            sweep, _ = plain_steps(dyn, rtol, atol)
            return sweep, lambda t, dt, y, k1, lv, cts: fg.altmlp_normed_sweep_bwd(
                t, dt, y, k1, lv, cts, rtol, atol)

        ws.plain_steps = steps
        try:
            g = ws.plain_whole_solve_bwd(rec, ns, ct_y1, tel, t0, t1, leaves, tol, tol, ctrl,
                                         **bkw)
        finally:
            ws.plain_steps = plain_steps
        time = lambda x: torch.stack(x[:3])
        return json.dumps({
            f"{ns} trial steps; ct_f0 from plain, float64; plain from float64": [
                cs._rel(g[4], plain[4]), cs._rel(g[4], f64[4]), cs._rel(plain[4], f64[4])],
            "time scalars": [cs._rel(time(g), time(plain)), cs._rel(time(g), time(f64)),
                             cs._rel(time(plain), time(f64))]})

    return walk


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--f0", action="store_true", help="walk phase 11's record with each K8")
    args = ap.parse_args()
    names = args.variants.split(",")
    import ctypes

    import torch

    import chip_smoke as cs
    from regneuralde_tpu_torch.ops import _cuda
    from regneuralde_tpu_torch.ops import fused_generic as fg

    out = Path(tempfile.mkdtemp())
    libs = build(list(dict.fromkeys(names)), out)  # a name given twice is timed twice
    dev = torch.device("cuda", 0)
    B, D, H, depth, tol = (cs.LATENT_BATCH, cs.LATENT_DIM, cs.LATENT_HIDDEN, cs.LATENT_DEPTH,
                           cs.FLAGSHIP_TOL)
    gen = torch.Generator().manual_seed(cs.SEED + 3)
    rnd = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen) * scale).to(dev)
    leaves = []
    for _ in range(depth):
        leaves += [rnd(H, D, scale=D ** -0.5), rnd(H, scale=0.1),
                   rnd(D, H, scale=H ** -0.5), rnd(D, scale=0.1)]
    y, k1 = rnd(B, D, scale=0.5), rnd(B, D, scale=0.3)
    t, dt = torch.tensor(0.07, device=dev), torch.tensor(0.11, device=dev)
    cts = [rnd(B, D), rnd(B, D), *(torch.tensor(v, device=dev) for v in (0.7, 1.3, -0.4))]
    plain = fg._altmlp_bwd_math(t, dt, y, k1, leaves, cts, tol, tol)
    plain_f = fg.plain_altmlp_normed_sweep(t, dt, y, k1, leaves, tol, tol)
    groups = lambda g: [torch.stack(g[:2]), g[2], g[3], torch.cat([x.flatten() for x in g[4]])]
    rows_shipped, check_shipped = fg.ALT_BWD_ROWS, fg.check_bwd_plan
    frows_shipped, chain_shipped = fg.ALT_FWD_ROWS, fg.ALT_FWD_CHAIN

    def check_variant(lib, D, H, depth):
        """The variant's plan, as its library sizes it."""
        rows = lib.regnde_altmlp_bwd_rows()
        return fg.AltBwdPlan(rows, 0, lib.regnde_altmlp_bwd_smem_bytes(depth, D, H),
                             4 * rows * depth * (fg._pad4(D) + fg._pad4(H)), False)

    def check_fwd_variant(lib, D, H, depth):
        """The forward's plan, as the variant's library sizes it."""
        return fg.AltFwdPlan(lib.regnde_altmlp_rows(), lib.regnde_altmlp_slot_rows(), 0, 0,
                             lib.regnde_altmlp_fwd_smem_bytes(depth, D, H))

    f0_walk = _f0_walks(dev) if args.f0 else None
    fcheck_shipped = fg.check_fwd_plan
    fg.check_bwd_plan, fg.check_fwd_plan = check_variant, check_fwd_variant
    try:
        for name in (n for n in names if n in libs):
            lib = ctypes.CDLL(libs[name])
            for fn, argtypes in _cuda._SIGNATURES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            _cuda._lib = lib
            # the variant's rows and shared memory are the library's
            fg.ALT_BWD_ROWS = lib.regnde_altmlp_bwd_rows()
            fg._altmlp_bwd_scratch.cache_clear()
            fg.ALT_FWD_ROWS = lib.regnde_altmlp_rows()
            fg.ALT_FWD_CHAIN = next((c for p, c in FWD_CHAINS.items() if p in name.split("+")),
                                    chain_shipped)
            fwd = lambda: fg.altmlp_normed_sweep(t, dt, y, k1, leaves, tol, tol)
            got = fwd()
            sched = fg.plain_altmlp_fwd_tiles(t, dt, y, k1, leaves, tol, tol)
            torch.cuda.synchronize()
            rows = all(torch.equal(a, b) for a, b in zip(got[:2], plain_f[:2]))
            same = all(torch.equal(a, b) for a, b in zip(got, sched))
            print(f"[variant] {name}: altmlp_fwd_kernel device ms "
                  f"{cs._device_ms(fwd, 'altmlp_fwd_kernel')!r}, sum_slots_warp_kernel "
                  f"{cs._device_ms(fwd, 'sum_slots_warp_kernel')!r} ({fg.ALT_FWD_ROWS}-row "
                  f"tiles); rows bitwise the plain version's {rows}; rows and sums bitwise "
                  f"its schedule's {same}", flush=True)
            bwd = lambda: fg.altmlp_normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)
            got = bwd()
            torch.cuda.synchronize()
            errs = [cs._rel(a, b) for a, b in zip(groups(got), groups(plain))]
            ms = cs._device_ms(bwd, "altmlp_bwd_kernel")
            print(f"[variant] {name}: altmlp_bwd_kernel device ms {ms!r} ({fg.ALT_BWD_ROWS}-row "
                  f"tiles); rel err against the plain version (ct_t|ct_dt, ct_y, ct_k1, "
                  f"leaves) {errs}", flush=True)
            if f0_walk:
                print(f"[variant] {name}: phase 11's walk at 1.4e-8 with this K8 " + f0_walk(),
                      flush=True)
    finally:
        fg.ALT_BWD_ROWS, fg.check_bwd_plan = rows_shipped, check_shipped
        fg.ALT_FWD_ROWS, fg.ALT_FWD_CHAIN = frows_shipped, chain_shipped
        fg.check_fwd_plan = fcheck_shipped
    shutil.rmtree(out)


if __name__ == "__main__":
    main()
