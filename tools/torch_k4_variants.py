#!/usr/bin/env python3
"""Size K4's walk for MLPDynamics (``regneuralde_tpu_torch/csrc/mlp_walk.cuh``)
on one GPU: the cost of a grid-wide barrier, each phase of a reverse stage
alone, and the whole walk, for a few tile shapes and source variants.

    python3 tools/torch_k4_variants.py [--variants shipped,stages4,...]
                                       [--plans 32x100,16x196]

Each variant is the source with the substitutions of ``VARIANTS`` made in
``mlp_walk.cuh``, and probe kernels appended to ``whole_solve.cu``: a
cooperative kernel that runs n ``grid.sync()`` and one that runs phase A
or phase B (stage 3) n times over on every tile of a plan, after one seed
phase, with no barrier between (each phase's prefetch of the next phase's
first slabs is consumed by the next call as its own: the same work). Each is compiled by ``nvcc`` (as
``ops/_cuda.py`` compiles, ``-Xptxas -v``) with ``weight_cotangents.cu``
into a library of its own under ``build/k4_variants/``. For each variant
it prints what ``ptxas`` reported for the walk and the probes (registers,
spills), then, on seeded random rows at 512 x 784 x 100 and each plan of
``--plans`` (tile rows x columns; the column blocks cover D = 784), the
device time of one barrier with the plan's grid and shared memory, and of
one phase A and one phase B: CUDA events around launches of n1 and n2
iterations, the difference over n2 - n1 (median of 5). Last, the device time of K4's walk and
of the weight-cotangent contraction after it (``torch.profiler``) on the
flagship solve at 1.4e-8 under each plan with the package's own library,
and of the walk under the shipped plan with each variant's library.
"""

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch_variants as tv  # noqa: E402

OUT = ROOT / "build" / "k4_variants"
B, D, H = 512, 784, 100
HPP = -(-(H + 1) // 4) * 4  # a partial's rows of ct_h, H+1 rounded to 4
# name -> substitutions in mlp_walk.cuh (each must occur in it)
VARIANTS = {
    "shipped": [],
    "stages3": [("kWalkStages = 4;", "kWalkStages = 3;")],
    "stages6": [("kWalkStages = 4;", "kWalkStages = 6;")],
    "kb16": [("kWalkKB = 8;", "kWalkKB = 16;"), ("kWalkStages = 4;", "kWalkStages = 3;")],
    # what the phases spend outside the contractions' FMAs
    "nofma": [("    if (live) {\n#pragma unroll\n      for (int kk = 0;",
               "    if (live && nslab < 0) {\n#pragma unroll\n      for (int kk = 0;")],
    # the walk without its stages: the seed phase, the final pass and the
    # scalar chain of every trial step
    "nostages": [(f"      walk_stage<{i}>(args, grid, ws, s, tl, part);\n", "")
                 for i in range(6, 0, -1)],
    # the walk with no barrier inside a stage (its results are wrong): what
    # the two barriers a stage cost, waiting on the slowest block included
    "nosync": [("  grid.sync();\n  walk_reduce<I>", "  walk_reduce<I>"),
               ("  grid.sync();\n  walk_phase_b<I>", "  walk_phase_b<I>")],
    # the step's time policy copied into registers in phase B, not read from
    # the step where it is used; and read where used in the reduction too
    "tmcopy_b": [("  const Time& tm = ws.tm;\n", "  const Time tm = ws.tm;\n")],
    "tmref_reduce": [("D = a.D;\n  const Time tm = ws.tm;\n",
                      "D = a.D;\n  const Time& tm = ws.tm;\n")],
}
PROBES = r'''
namespace {

__global__ void __launch_bounds__(kThreads) probe_pad_kernel(WalkArgs<true> args) {
  walk_pad_weights(args.a.dyn.W1, args.a.dyn.W2, args.w, args.a.D, args.a.dyn.H,
                   walk_round_up(args.a.dyn.H + 1, kWalkTN));
}

__global__ void __launch_bounds__(kThreads) probe_sync_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < n; ++k) grid.sync();
}

// Phase A (which == 0), the reduction (1) or phase B (2) of stage 3 on every
// tile of the first row chunk, n times over after one seed phase.
__global__ void __launch_bounds__(kThreads)
    probe_phase_kernel(WalkArgs<true> args, WalkStep ws, int which, int n) {
  extern __shared__ __align__(16) float walk_pool[];
  const BwdArgs<MlpDyn<true>>& a = args.a;
  const Walk& w = args.w;
  const WalkSmem s = walk_smem(walk_pool, w, a.dyn.H);
  const WalkTile tl = walk_tile(w, a.B, a.D, 0);
  const size_t pstride = (size_t)s.HPP * w.R;
  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  walk_seed(a, w, ws, s, tl, part);
  for (int k = 0; k < n; ++k) {
    __syncthreads();
    float* ctp1g = w.ctp1g + (size_t)tl.rb * a.dyn.H * w.R;
    if (which == 0)
      walk_phase_a<3>(a, w, s, tl, w.psum + blockIdx.x * pstride);
    else if (which == 1)
      walk_reduce<3>(a, w, ws, s, tl, w.psum + (size_t)tl.rb * w.ndb * pstride, ctp1g, part);
    else
      walk_phase_b<3>(a, w, ws, s, tl, ctp1g, part);
  }
  walk_wait<0>();
  block_sum_to<4>(part, s.red, a.partials + 4 * blockIdx.x);
}

}  // namespace

extern "C" int probe_sync(int blocks, int smem, int n, void* stream) {
  const void* k = (const void*)probe_sync_kernel;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  void* params[] = {&n};
  e = cudaLaunchCooperativeKernel(k, blocks, kThreads, params, smem, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

extern "C" int probe_phase(const float* y, const float* k1, const float* ks, const float* hs,
                           const float* W1, const float* b1, const float* W2, const float* b2,
                           float* cp2, float* he, float* cp1, float* ye, float* psum,
                           float* slots, float* ct_y, float* ct_f, float* w2p, float* w1p,
                           float* ctp1g, int R, int C, int nrb, int ndb, int which, int n,
                           void* stream) {
  const Walk w{nullptr, nullptr, psum, ctp1g, w2p, w1p, R, C, nrb, ndb, 1};
  WalkArgs<true> args{{nullptr, nullptr, y, k1,
                       MlpDyn<true>{W1, b1, W2, b2, const_cast<float*>(ks),
                                    const_cast<float*>(hs), cp2, he, cp1, ye, H_},
                       Saves{nullptr, nullptr, nullptr, 0}, nullptr, ct_y, ct_f, nullptr,
                       slots, nullptr, nullptr, 1, B_, D_, 1, 1e-6f, 1e-6f, Ctrl{}},
                      w};
  const WalkStep ws{y, k1, y, k1, ks, hs, cp2, he, cp1, ye, ct_y, ct_f, nullptr, nullptr,
                    0.1f, 0.05f, 0.7f, 1.3f, -0.4f, 0, 0};
  const size_t smem = walk_smem_bytes(R, C, H_);
  const void* k = (const void*)probe_phase_kernel;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  probe_pad_kernel<<<nrb * ndb, kThreads, 0, (cudaStream_t)stream>>>(args);
  void* params[] = {&args, (void*)&ws, &which, &n};
  e = cudaLaunchKernel(k, nrb * ndb, kThreads, params, smem, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
'''


def build(names):
    probes = PROBES.replace("B_", str(B)).replace("D_", str(D)).replace("H_", str(H))
    libs = tv.build("mlp_walk.cuh", VARIANTS, names, probes, OUT, ("mlp_walk", "probe"))
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, lib in libs.items():
        sass_counts(name, OUT / f"{name}.so")
        lib.probe_sync.argtypes = [I, I, I, P]
        lib.probe_phase.argtypes = [P] * 19 + [I] * 6 + [P]
    return libs


def sass_counts(name, so):
    """How many shared (LDS/STS), generic (LD/ST), local (LDL/STL) and
    global (LDG/STG) memory instructions and FFMAs each walk kernel of the
    library holds (``cuobjdump -sass``); the probe kernel's SASS goes to
    ``build/k4_variants/<variant>_probe.sass``."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dump = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True).stdout
    kernel, counts, probe = None, {}, []
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            kernel = m.group(1) if ("mlp_walk" in m.group(1) or "probe_phase" in m.group(1)) else None
            if kernel:
                counts[kernel] = {}
        elif kernel:
            if "probe_phase" in kernel:
                probe.append(line)
            op = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if op:
                key = op.group(1)
                if key in ("LDS", "STS", "LD", "ST", "LDL", "STL", "LDG", "STG", "FFMA", "BAR",
                           "LDGSTS"):
                    counts[kernel][key] = counts[kernel].get(key, 0) + 1
    for kernel, c in counts.items():
        print(f"[sass] {name} {kernel[-40:]}: " + ", ".join(f"{k} {v}" for k, v in sorted(c.items())))
    (OUT / f"{name}_probe.sass").write_text("\n".join(probe))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="shipped,stages3,stages6,kb16,nofma,nosync")
    ap.add_argument("--plans", default="32x100,16x196")
    args = ap.parse_args()
    import torch

    from regneuralde_tpu_torch.ops import whole_solve as ws

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    plans = []
    for spec in args.plans.split(","):
        R, C = map(int, spec.split("x"))
        ndb = -(-D // C)
        plans.append(ws.WalkPlan(R, C, -(-B // R), ndb, 1, 0))
    libs = build(args.variants.split(","))
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    W1, b1 = rnd(H, D + 1, scale=(D + 1) ** -0.5), rnd(H, scale=0.1)
    W2, b2 = rnd(D, H + 1, scale=(H + 1) ** -0.5), rnd(D, scale=0.1)
    y, k1 = rnd(B, D), rnd(B, D, scale=0.3)
    ks, hs = rnd(6, B, D, scale=0.3).tanh(), rnd(6, B, H).tanh()
    rows = [torch.empty(6 * B, w, device=dev) for w in (D, H + 2, H, D + 2)]
    ct_y, ct_f = rnd(B, D), rnd(B, D)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    for name, lib in libs.items():
        for p in plans:
            smem = lib.regnde_walk_smem_bytes(p.rows, p.cols, H)
            psum = torch.zeros(p.tiles * p.rows * HPP, device=dev)
            ctp1g = torch.zeros(p.row_blocks * H * p.rows, device=dev)
            wpad = (torch.empty(p.col_blocks * p.cols * HPP, device=dev),
                    torch.empty(H * p.col_blocks * p.cols, device=dev))
            slots = torch.empty(4 * p.tiles, device=dev)

            def phase(which, n):
                code = lib.probe_phase(*map(ptr, (y, k1, ks, hs, W1, b1, W2, b2, *rows, psum,
                                                  slots, ct_y, ct_f, *wpad, ctp1g)),
                                       p.rows, p.cols, p.row_blocks, p.col_blocks, which, n,
                                       stream)
                if code:
                    raise SystemExit(f"{name} {p}: probe_phase failed ({code})")

            def sync(n):
                code = lib.probe_sync(p.tiles, smem, n, stream)
                if code:
                    raise SystemExit(f"{name} {p}: probe_sync failed ({code})")

            if smem > ws.SMEM_LIMIT:
                print(f"[k4-variants] {name} {p.rows}x{p.cols}: {smem} bytes, does not fit")
                continue
            ms = {"grid_sync_us": 1e3 * tv.per_iteration_ms(sync, 10, 1010),
                  "phase_a_us": 1e3 * tv.per_iteration_ms(lambda n: phase(0, n)),
                  "reduce_us": 1e3 * tv.per_iteration_ms(lambda n: phase(1, n)),
                  "phase_b_us": 1e3 * tv.per_iteration_ms(lambda n: phase(2, n))}
            print(f"[k4-variants] {name} {p.rows}x{p.cols} ({p.tiles} tiles, {smem} bytes): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))

    # the whole K4 under each plan, with the package's library, and under
    # the shipped plan with each variant's library
    import chip_smoke as cs
    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.ops import ode
    from regneuralde_tpu_torch.ops.controller import PIController

    tol, ctrl = cs.FLAGSHIP_TOL, PIController.for_order(5)
    leaves = [W1, b1, W2, b2]
    parts = fm._split_params(*leaves)
    func = lambda t, x, _: fm._mlp_k(x, t, parts)[0]
    y0 = torch.rand(B, D, generator=gen).to(dev)
    t0, t1, f0, dt0 = ode.solve_prologue(func, y0, 0.0, 1.0, (), tol, tol)
    rec = ws.whole_solve_fwd(t0, t1, dt0, y0, f0, leaves, tol, tol, ctrl, cs.MAX_STEPS)
    ns = int(rec.final[3:5].sum().item())
    ct_tel = torch.zeros(4, cs.MAX_STEPS, device=dev)
    call = lambda: ws.whole_solve_bwd(rec, ns, ct_y, ct_tel, t0, t1, leaves, tol, tol, ctrl)
    for p in plans:
        forced = p._replace(smem_bytes=ws.walk_smem_bytes(p.rows, p.cols, H))
        if forced.smem_bytes > ws.SMEM_LIMIT:
            continue
        with tv.forced(plan=forced):
            walk = cs._device_ms(call, "mlp_walk_kernel")
            wcot = cs._device_ms(call, "wcot_")
        print(f"[k4-variants] K4 at {p.rows}x{p.cols}, {ns} trial steps: device ms "
              f"walk {walk!r}, the contraction {wcot!r}")
    own = ws.walk_plan(B, D, H, torch.cuda.get_device_properties(dev).multi_processor_count)
    for name, lib in libs.items():
        if lib.regnde_walk_smem_bytes(own.rows, own.cols, H) > ws.SMEM_LIMIT:
            continue
        with tv.forced(plan=own, lib=lib):
            ms = cs._device_ms(call, "mlp_walk_kernel")
        print(f"[k4-variants] {name}: the walk at the shipped plan, device ms {ms!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
