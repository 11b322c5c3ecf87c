// K13, K1 and K11 on Hopper: the tuple, the normed and the lane-wise Tsit5
// trial step of MLPDynamics (ops/fused_mlp.py stage_sweep_fwd, odeint's
// generic engine's step with mlp_dynamics_stage_sweep; normed_sweep_fwd,
// the fast adjoint's step on fused="step"; ops/fused_mlp_lanes.py
// sweep_lanes_fwd, the per-sample engine's step, every row at its own
// (t, dt)) as one trial step of K3's grid-split stages on the walk's tiles.
// One kernel, mlp_step_solve_kernel<End>, over the policy of what each tile
// writes after its stages and of what the kernel does after its last row
// chunk, which also names the stages' time and rounding policies
// (mlp_solve.cuh): TupleEnd (K13: the rows y_new, k7, err, k6, g6; StepTime,
// F32), NormedEnd (K1: the rows y_new and k7, and the three norm sums,
// summed over the tiles in tile order; StepTime, F32) and LaneEnd (K11:
// TupleEnd's rows at every row's own dt; LaneTime, F64). Included by
// whole_solve.cu only, after mlp_solve.cuh, whose stages it runs; their
// backwards, K14, K2 and K12, are mlp_step_walk.cuh.
//
// Replaces the TPU kernels
//   K13: regneuralde_tpu/ops/pallas_mlp.py  _pallas_sweep (_fused_step_kernel)
//   K1:  regneuralde_tpu/ops/pallas_mlp.py  _normed_pallas_fwd
//        (_make_normed_kernels.fwd_kernel)
//   K11: regneuralde_tpu/ops/pallas_mlp.py  _pallas_sweep_lanes
//        (_fused_step_kernel_lanes)
// and, on this card, their ports over 4-row tiles (tuple_fwd_kernel,
// normed_fwd_kernel and lanes_fwd_kernel, 128 blocks at 512x784x100, each
// running the six stages with plain FMA loops; K1's norm sums in a second
// launch) that read all of W1 and W2 from L2 once per tile per stage:
// ~485 MB a launch, K13 0.351 ms and K1 0.405 ms with the wrapper, K11
// 0.368-0.371 ms of device time (H100 80GB HBM3 at 700 W).
//
// What bounds it on this card. One trial step is 12 contractions of B x D x
// H (24 B D H operations, 0.96 GFLOP at 512x784x100: 14 us at the 67
// TFLOP/s f32 rate, 28 us at the 34 TFLOP/s f64 rate K11's take) in a
// chain of six stages, each of which needs every column of its rows before
// its hidden layer: against that stand each stage's grid-wide barriers and
// the latency of each phase's round trips to L2.
//
// What the design does about it. One cooperative launch on the walk's tile
// plan (ops/whole_solve.py walk_plan: 32 x 100 tiles, 128 at the flagship;
// row chunks when the batch does not fit the grid; K11 on K12's plan):
//   * every block pads W1 and W2 for K3's slabs (solve_pad_weights),
//     grid.sync();
//   * per row chunk, K3's own stages (solve_stages, mlp_solve.cuh) with no
//     residual stream: per stage phase A, the reduction and phase B split
//     over the whole grid, two grid.sync() a stage, the tile's y, k1..k7 and
//     stage input in shared memory; the step's t and dt read once from the
//     device (StepTime), or each tile's rows' staged in shared memory
//     (LaneTime, K11);
//   * then the policy's tile end on that state (TupleEnd and LaneEnd: the
//     five rows; NormedEnd: K3's solve_finish, the two rows and the tile's
//     norm sums added to the thread's);
//   * after the last chunk the policy's finish (NormedEnd: each block's
//     sums to its slot, one grid.sync(), block 0 sums the slots in tile
//     order as K3's controller does; the others: nothing).
// So W1 and W2 are read once per row block a stage (~40 MB a launch at the
// flagship, ~80 MB as K11's f64 copies), not once per 4-row tile; 1 + 12 x
// chunks grid.sync() a launch for K13 and K11, one more for K1, whose norm
// sums need no second launch.
// K13's and K1's stages are bitwise K3's and the replay of them in K14 and
// K2: the replay adjoint takes its accept flags from K13 alone and launches
// it twice a trial step (forward and replay), and K14 and K2 differentiate
// the very stages K13 and K1 ran. K1's norm sums are K3's for the same
// trial step: the same per-tile algebra, block sums and tile order.
// K11's stages round as its plain version (F64): the per-sample engine takes
// each lane's accept from K11, at the error norm's float32 floor, so K11's
// five rows equal _reference_sweep_lanes's bitwise; K12's replay rounds the
// same stages as K3 (F32), which moves gradients only.
// IEEE FMAs, no TF32, no fast math, no atomics: every sum has a fixed
// order, so runs are bitwise reproducible.

#pragma once

namespace {

// TupleEnd (K13): each tile's rows of the tuple (y_new, k7, err, k6, g6),
// from the state solve_stages leaves (y, k1..k7 in s.st, the stage-6 input
// y_new in s.yi), at each row's dt (dt_row: the step's under StepTime).
// g6, the stage-5 input, is rebuilt by the rounding policy's input, the
// form the stages used (for F32 stage_state, as solve_finish does); err = dt
// sum_j btilde_j (k_j - k1) rounds each op on its own, as the plain
// version's ATen ops: it is a cancellation, so a contraction moves it by its
// own rounding. It has no sums and no finish.
struct TupleEnd {
  using Time = StepTime;
  using Rnd = F32;
  float *y_new, *k7, *err, *k6, *g6;  // (B, D) each

  template <class Tm, class Rd>
  __device__ __forceinline__ void tile(const SolveStep<Tm>& ss, const SolveSmemT<Rd>& s,
                                       const WalkTile& tl, int R, int C, int D,
                                       float (&)[3]) const {
    const int n = C * (R / 4);
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int c = e % C, g = e / C, off = walk_at(c, g, R);
      float4 kv[7];
#pragma unroll
      for (int j = 0; j < 7; ++j) kv[j] = ld4(s.st + (1 + j) * s.RC + off);
      const float4 yv = ld4(s.st + off);
      const auto ynv = ld4(s.yi + off);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 4 * g + q;
        if (r >= tl.rows || c >= tl.cols) continue;
        const size_t gi = (size_t)(tl.row0 + r) * D + tl.d0 + c;
        const float dt = ss.tm.dt_row(r);
        float k[7];
#pragma unroll
        for (int j = 0; j < 7; ++j) k[j] = lane_of(kv[j], q);
        const float y = lane_of(yv, q);
        float s_comb = __fmul_rn(kBt[1], __fsub_rn(k[1], k[0]));
#pragma unroll
        for (int j = 2; j <= 6; ++j)
          s_comb = __fadd_rn(s_comb, __fmul_rn(kBt[j], __fsub_rn(k[j], k[0])));
        y_new[gi] = (float)lane_of(ynv, q);  // a float held as T
        k7[gi] = k[6];
        err[gi] = __fmul_rn(dt, s_comb);
        k6[gi] = k[5];
        g6[gi] = Rd::template input<5>(y, k, dt);
      }
    }
  }

  template <class Rd>
  __device__ __forceinline__ void finish(cg::grid_group&, const SolveT<Rd>&,
                                         const SolveSmemT<Rd>&, const float (&)[3]) const {}
};

// LaneEnd (K11): TupleEnd's rows at each row's own (t, dt) (LaneTime, the
// tile's rows in a LaneRows after K3's pool) on stages rounded as the plain
// version (F64).
struct LaneEnd : TupleEnd {
  using Time = LaneTime;
  using Rnd = F64;
};

// NormedEnd (K1): each tile's rows of y_new and k7 and its norm sums (err,
// num, den) added to the thread's part, by K3's solve_finish; after the last
// row chunk every block's sums to its slot (block_sum_to), one grid.sync(),
// and warp 0 of block 0 sums the slots in tile order (sum_tiles, the order
// of K3's fwd_decide) into sums. No atomics.
struct NormedEnd {
  using Time = StepTime;
  using Rnd = F32;
  float *y_new, *k7;  // (B, D) each
  float* sums;        // (3,): err_ssq, num_ssq, den_ssq
  float rtol, atol;

  __device__ __forceinline__ void tile(const SolveStep<StepTime>& ss, const SolveSmem& s,
                                       const WalkTile& tl, int R, int C, int D,
                                       float (&part)[3]) const {
    solve_finish(ss, s, tl, R, C, D, rtol, atol, y_new, k7, part);
  }

  __device__ __forceinline__ void finish(cg::grid_group& grid, const Solve& f,
                                         const SolveSmem& s, const float (&part)[3]) const {
    block_sum_to<3>(part, s.red, f.slots + 3 * blockIdx.x);
    grid.sync();
    if (blockIdx.x == 0 && threadIdx.x < 32) {
      float out[3];
      sum_tiles<3>(f.slots, gridDim.x, out);
      if (threadIdx.x == 0) {
        sums[0] = out[0];
        sums[1] = out[1];
        sums[2] = out[2];
      }
    }
  }
};

// The arguments of K13, K1 and K11: the leaves (no stream, no
// weight-cotangent rows), the plan and K3's scratch in the end's rounding
// policy, the step's inputs and the end policy.
template <class End>
struct StepSolveArgs {
  MlpDyn<false> m;
  SolveT<typename End::Rnd> f;
  const float *t, *dt;  // scalars (StepTime) or B floats (LaneTime) on the device
  const float *y, *k1;  // (B, D)
  End end;
  int B, D;
};

// The step's time policy: the scalars read once, or the rows' arrays and
// the block's LaneRows in the pool.
template <class End, class Rnd>
__device__ __forceinline__ typename End::Time step_time(const StepSolveArgs<End>& args,
                                                        const SolveSmemT<Rnd>& s) {
  using Time = typename End::Time;
  if constexpr (Time::kLanes) return Time{args.t, args.dt, solve_lane_rows(s)};
  else return Time{__ldg(args.t), __ldg(args.dt)};
}

// K13 (TupleEnd), K1 (NormedEnd) and K11 (LaneEnd): one trial step, one
// block a tile (gridDim.x == nrb * ndb, all resident).
template <class End>
__global__ void __launch_bounds__(kThreads, 1) mlp_step_solve_kernel(StepSolveArgs<End> args) {
  using Time = typename End::Time;
  using Rnd = typename End::Rnd;
  extern __shared__ __align__(16) float solve_pool[];
  cg::grid_group grid = cg::this_grid();
  const MlpDyn<false>& m = args.m;
  const SolveT<Rnd>& f = args.f;
  const int B = args.B, D = args.D;
  const SolveSmemT<Rnd> s = solve_smem(solve_pool, f, m.H);
  solve_pad_weights(m.W1, m.W2, f, D, m.H, s.HP4);
  const SolveStep<Time> ss{args.y, args.k1, nullptr, nullptr,
                           step_time(args, s)};
  grid.sync();
  float part[3] = {0.0f, 0.0f, 0.0f};  // the thread's norm sums (NormedEnd)
  for (int chunk = 0; chunk < f.chunks; ++chunk) {
    const WalkTile tl = walk_tile(f, B, D, chunk);
    solve_stages<false>(m, f, grid, ss, s, tl, B, D);
    args.end.tile(ss, s, tl, f.R, f.C, D, part);
  }
  args.end.finish(grid, f, s, part);
}

}  // namespace
