#!/usr/bin/env python3
"""Size K3 for MLPDynamics (``regneuralde_tpu_torch/csrc/mlp_solve.cuh``) on
one GPU: the cost of a grid-wide barrier, each phase of a stage alone, and
the whole forward solve, for a few tile shapes and source variants.

    python3 tools/torch_k3_variants.py [--variants shipped,kb16,...]
                                       [--plans 32x100,16x196]

Each variant is the source with the substitutions of ``VARIANTS`` made in
``mlp_solve.cuh``, and probe kernels appended to ``whole_solve.cu``: a
cooperative kernel that runs n ``grid.sync()`` and one that runs the load
of a tile, phase A, the reduction or phase B of stage 3 n times over on
every tile of a plan, after one load of the tile, with no barrier between (each
phase's prefetch of the next phase's first slabs is consumed by the next
call as its own: the same work). Each is compiled by ``nvcc`` (as
``ops/_cuda.py`` compiles, ``-Xptxas -v``) with ``weight_cotangents.cu`` into
a library of its own under ``build/k3_variants/``. For each variant it prints
what ``ptxas`` reported for K3 and the probes (registers, spills), then, on
seeded random rows at 512 x 784 x 100 and each plan of ``--plans`` (tile
rows x columns; the column blocks cover D = 784), the device time of one
barrier with the plan's grid and K3's shared memory, and of each phase:
CUDA events around launches of n1 and n2 iterations, the difference over
n2 - n1 (median of 5). Last, the device time of K3 (``torch.profiler``) on
the flagship solve at 1.4e-8 under each plan with the package's own library,
and under the shipped plan with each variant's library, with its trial
steps (a variant whose results are wrong by design may take other steps);
for the ``trace`` variant also where that solve's time goes, per stage:
the SM clocks (``clock64``) thread 0 of each block saw between marks at
each phase's end, averaged over the blocks and scaled to the solve's
device time.
"""

import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch_variants as tv  # noqa: E402

OUT = ROOT / "build" / "k3_variants"
B, D, H = 512, 784, 100
TRACE_MARKS = r'''// per-block sums of SM clocks between the marks, by phase (the trace variant)
__device__ long long k3_acc[1024][6];
__device__ long long k3_last[1024];
__device__ __forceinline__ void k3_mark_begin() {
  if (threadIdx.x != 0) return;
  for (int q = 0; q < 6; ++q) k3_acc[blockIdx.x][q] = 0;
  k3_last[blockIdx.x] = clock64();
}
__device__ __forceinline__ void k3_mark(int phase) {
  if (threadIdx.x != 0) return;
  const long long now = clock64();
  k3_acc[blockIdx.x][phase] += now - k3_last[blockIdx.x];
  k3_last[blockIdx.x] = now;
}
'''
# name -> substitutions in mlp_solve.cuh (each must occur in it)
VARIANTS = {
    "shipped": [],
    "stages3": [("kWalkStages = 4;", "kWalkStages = 3;")],
    "stages6": [("kWalkStages = 4;", "kWalkStages = 6;")],
    "kb16": [("kWalkKB = 8;", "kWalkKB = 16;"), ("kWalkStages = 4;", "kWalkStages = 3;")],
    # what the phases spend outside the contractions' FMAs (wrong results)
    "nofma": [("    if (live) {\n#pragma unroll\n      for (int kk = 0;",
               "    if (live && nslab < 0) {\n#pragma unroll\n      for (int kk = 0;")],
    # K3 without its stages: the load, the norm sums, the controller, the
    # history and the barrier of every trial step (wrong results)
    "nostages": [(f"  solve_stage<{i}, OUT>(m, f, grid, ss, s, tl, B, D);\n", "")
                 for i in range(1, 7)],
    # no barrier inside a stage (wrong results): what the two barriers a
    # stage cost, waiting on the slowest block included
    "nosync": [("  grid.sync();\n  solve_reduce<I, OUT>", "  solve_reduce<I, OUT>"),
               ("                       B, D);\n  grid.sync();\n", "                       B, D);\n")],
    # the shipped kernel with thread 0 of every block adding the SM clocks
    # (clock64) between marks to per-phase sums: phase A, the wait at the
    # first barrier, the reduction, the wait at the second, phase B, and the
    # rest (the load, the norm sums, the controller, the history)
    "trace": [("constexpr int kSolveState = 9;", TRACE_MARKS + "constexpr int kSolveState = 9;"),
              ("  __syncthreads();  // the stage input is complete\n"
               "  solve_phase_a(f, s, tl, m.H, f.psum + blockIdx.x * pstride);\n"
               "  grid.sync();\n"
               "  solve_reduce<I, OUT>(m, f, ss, tl, f.psum + (size_t)tl.rb * f.ndb * pstride, "
               "hidg, s.HP4,\n                       B, D);\n"
               "  grid.sync();\n"
               "  solve_phase_b<I, OUT>(m, f, ss, s, tl, hidg, B, D);\n",
               "  __syncthreads();\n  k3_mark(5);\n"
               "  solve_phase_a(f, s, tl, m.H, f.psum + blockIdx.x * pstride);\n  k3_mark(0);\n"
               "  grid.sync();\n  k3_mark(1);\n"
               "  solve_reduce<I, OUT>(m, f, ss, tl, f.psum + (size_t)tl.rb * f.ndb * pstride, "
               "hidg, s.HP4,\n                       B, D);\n  k3_mark(2);\n"
               "  grid.sync();\n  k3_mark(3);\n"
               "  solve_phase_b<I, OUT>(m, f, ss, s, tl, hidg, B, D);\n  k3_mark(4);\n"),
              ("  const SolveSmem s = solve_smem(solve_pool, f, H);\n",
               "  const SolveSmem s = solve_smem(solve_pool, f, H);\n  k3_mark_begin();\n")],
}
TRACE_PHASES = ("phase_a", "wait_1", "reduction", "wait_2", "phase_b", "rest")
PROBES = r'''
namespace {

__global__ void __launch_bounds__(kThreads) probe_pad_kernel(SolveArgs<true> args) {
  solve_pad_weights(args.a.dyn.W1, args.a.dyn.W2, args.f, args.a.D, args.a.dyn.H,
                    walk_round_up(args.a.dyn.H, kWalkTN));
}

__global__ void __launch_bounds__(kThreads) probe_sync_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < n; ++k) grid.sync();
}

// The load of the tile (which == 0), phase A (1), the reduction (2) or
// phase B (3) of stage 3 on every tile of the first row chunk, n times over
// after one load of the tile.
__global__ void __launch_bounds__(kThreads, 1)
    probe_phase_kernel(SolveArgs<true> args, SolveStep<StepTime> ss, int which, int n) {
  extern __shared__ __align__(16) float solve_pool[];
  const FwdArgs<MlpDyn<true>>& a = args.a;
  const Solve& f = args.f;
  const MlpDyn<true>& m = a.dyn;
  const SolveSmem s = solve_smem(solve_pool, f, m.H);
  const WalkTile tl = walk_tile(f, a.B, a.D, 0);
  const size_t pstride = (size_t)s.HP4 * f.R;
  float* hidg = f.hid + (size_t)tl.rb * m.H * f.R;
  for (int e = threadIdx.x; e < (kSolveState - 1) * s.RC; e += kThreads) s.st[e] = 0.0f;
  for (int e = threadIdx.x; e < walk_round_up(f.C, kWalkKB) * f.R; e += kThreads)
    s.yi[e] = 0.0f;
  __syncthreads();
  solve_load(ss, s, tl, f.R, f.C, a.D);
  if (which == 1)
    walk_prefetch((tl.cols + kWalkKB - 1) / kWalkKB,
                  [&](int p) { solve_load_w1(f, s, tl, p); });
  if (which == 3) {
    const int kk0 = threadIdx.x / (f.C / 4), c40 = threadIdx.x % (f.C / 4);
    walk_prefetch((m.H + kWalkKB - 1) / kWalkKB,
                  [&](int p) { solve_load_w2(f, s, tl, m.H, kk0, c40, p); });
  }
  for (int k = 0; k < n; ++k) {
    __syncthreads();
    if (which == 0)
      solve_load(ss, s, tl, f.R, f.C, a.D);
    else if (which == 1)
      solve_phase_a(f, s, tl, m.H, f.psum + blockIdx.x * pstride);
    else if (which == 2)
      solve_reduce<3, true>(m, f, ss, tl, f.psum + (size_t)tl.rb * f.ndb * pstride, hidg,
                            s.HP4, a.B, a.D);
    else
      solve_phase_b<3, true>(m, f, ss, s, tl, hidg, a.B, a.D);
  }
  walk_wait<0>();
}

}  // namespace

extern "C" int probe_trace(long long* out, int blocks) {
#ifdef TRACE
  return (int)cudaMemcpyFromSymbol(out, k3_acc, sizeof(long long) * 6 * blocks);
#else
  return (int)cudaErrorInvalidValue;
#endif
}

extern "C" int probe_sync(int blocks, int smem, int n, void* stream) {
  const void* k = (const void*)probe_sync_kernel;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  void* params[] = {&n};
  e = cudaLaunchCooperativeKernel(k, blocks, kThreads, params, smem, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

extern "C" int probe_phase(const float* y, const float* k1, float* ks, float* hs,
                           const float* W1, const float* b1, const float* W2, const float* b2,
                           float* scratch, int R, int C, int nrb, int ndb, int which, int n,
                           void* stream) {
  SolveArgs<true> args{{nullptr, y, k1,
                        MlpDyn<true>{W1, b1, W2, b2, ks, hs, nullptr, nullptr, nullptr,
                                     nullptr, H_},
                        Saves{nullptr, nullptr, nullptr, 0}, nullptr, nullptr, nullptr,
                        nullptr, nullptr, nullptr, B_, D_, 1, 1e-6f, 1e-6f, Ctrl{}},
                       solve_carve(scratch, R, C, nrb, ndb, 1, H_)};
  const SolveStep<StepTime> ss{y, k1, ks, hs, 0.1f, 0.05f};
  const size_t smem = sizeof(float) * solve_smem_floats(R, C, H_);
  const void* k = (const void*)probe_phase_kernel;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  probe_pad_kernel<<<nrb * ndb, kThreads, 0, (cudaStream_t)stream>>>(args);
  void* params[] = {&args, (void*)&ss, &which, &n};
  e = cudaLaunchKernel(k, nrb * ndb, kThreads, params, smem, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
'''


def build(names):
    probes = PROBES.replace("B_", str(B)).replace("D_", str(D)).replace("H_", str(H))
    libs = tv.build("mlp_solve.cuh", VARIANTS, names, probes, OUT,
                    ("mlp_solve", "probe_phase"), defines=("trace",))
    P, I = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.probe_sync.argtypes = [I, I, I, P]
        lib.probe_trace.argtypes = [P, I]
        lib.probe_phase.argtypes = [P] * 9 + [I] * 6 + [P]
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="shipped,stages3,stages6,kb16,nofma,nostages,"
                                          "nosync,trace")
    ap.add_argument("--plans", default="32x100,16x196")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.ops import ode
    from regneuralde_tpu_torch.ops import whole_solve as ws
    from regneuralde_tpu_torch.ops.controller import PIController

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    plans = []
    for spec in args.plans.split(","):
        R, C = map(int, spec.split("x"))
        plans.append(ws.WalkPlan(R, C, -(-B // R), -(-D // C), 1, 0))
    libs = build(args.variants.split(","))
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    W1, b1 = rnd(H, D + 1, scale=(D + 1) ** -0.5), rnd(H, scale=0.1)
    W2, b2 = rnd(D, H + 1, scale=(H + 1) ** -0.5), rnd(D, scale=0.1)
    y, k1 = rnd(B, D), rnd(B, D, scale=0.3)
    ks, hs = torch.empty(6, B, D, device=dev), torch.empty(6, B, H, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    for name, lib in libs.items():
        for p in plans:
            smem = ws.solve_smem_bytes(p.rows, p.cols, H)
            if smem > ws.SMEM_LIMIT:
                print(f"[k3-variants] {name} {p.rows}x{p.cols}: {smem} bytes, does not fit")
                continue
            scratch = torch.zeros(lib.regnde_solve_scratch_floats(
                p.rows, p.cols, p.row_blocks, p.col_blocks, H), device=dev)

            def phase(which, n):
                code = lib.probe_phase(*map(ptr, (y, k1, ks, hs, W1, b1, W2, b2, scratch)),
                                       p.rows, p.cols, p.row_blocks, p.col_blocks, which, n,
                                       stream)
                if code:
                    raise SystemExit(f"{name} {p}: probe_phase failed ({code})")

            def sync(n):
                code = lib.probe_sync(p.tiles, smem, n, stream)
                if code:
                    raise SystemExit(f"{name} {p}: probe_sync failed ({code})")

            ms = {"grid_sync_us": 1e3 * tv.per_iteration_ms(sync, 10, 1010)}
            for which, key in enumerate(("load_us", "phase_a_us", "reduce_us",
                                         "phase_b_us")):
                ms[key] = 1e3 * tv.per_iteration_ms(lambda n, w=which: phase(w, n))
            print(f"[k3-variants] {name} {p.rows}x{p.cols} ({p.tiles} tiles, {smem} bytes): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))

    # the whole K3 under each plan, with the package's library, and under
    # the shipped plan with each variant's library
    tol, ctrl = cs.FLAGSHIP_TOL, PIController.for_order(5)
    leaves = [W1, b1, W2, b2]
    parts = fm._split_params(*leaves)
    func = lambda t, x, _: fm._mlp_k(x, t, parts)[0]
    y0 = torch.rand(B, D, generator=gen).to(dev)
    t0, t1, f0, dt0 = ode.solve_prologue(func, y0, 0.0, 1.0, (), tol, tol)
    solve = (t0, t1, dt0, y0, f0, leaves, tol, tol, ctrl, cs.MAX_STEPS)

    def k3(tag, lib=None):
        ns = int(ws.whole_solve_fwd(*solve).final[3:5].sum().item())
        ms = cs._device_ms(lambda: ws.whole_solve_fwd(*solve), "mlp_solve_kernel")
        print(f"[k3-variants] {tag}: K3 device ms {ms!r}, {ns} trial steps")
        if lib is not None:  # the trace of the last solve, per stage
            plan = ws.walk_plan(B, D, H, torch.cuda.get_device_properties(dev)
                                .multi_processor_count)
            acc = (ctypes.c_longlong * (6 * plan.tiles))()
            if lib.probe_trace(acc, plan.tiles):
                raise SystemExit("probe_trace failed")
            sums = [sum(acc[6 * b + q] for b in range(plan.tiles)) / plan.tiles
                    for q in range(6)]
            us = 1e3 * ms / sum(sums)  # the solve's device time over its clocks
            stages = 6 * ns * plan.chunks
            print(f"[k3-variants] {tag}: mean over blocks, us a stage (the rest: a "
                  "trial step's, over its 6 stages) " + ", ".join(
                      f"{n} {v * us / stages:.3f}" for n, v in zip(TRACE_PHASES, sums)))

    for p in plans:
        forced = p._replace(smem_bytes=ws.walk_smem_bytes(p.rows, p.cols, H))
        if forced.smem_bytes > ws.SMEM_LIMIT:
            continue
        with tv.forced(plan=forced):
            k3(f"plan {p.rows}x{p.cols}")
    own = ws.walk_plan(B, D, H, torch.cuda.get_device_properties(dev).multi_processor_count)
    for name, lib in libs.items():
        # a variant's slab ring changes its shared memory: the plan is not
        # checked against its library's sizes
        with tv.forced(plan=own, lib=lib):
            k3(f"{name} at the shipped plan", lib if name == "trace" else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
