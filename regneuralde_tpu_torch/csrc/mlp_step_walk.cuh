// K2, K14 and K12 on Hopper: the backwards of the normed, of the tuple and
// of the lane-wise Tsit5 trial step of MLPDynamics (ops/fused_mlp.py
// normed_sweep_bwd, the fast adjoint solve's; stage_sweep_bwd, odeint's
// generic engine's; ops/fused_mlp_lanes.py sweep_lanes_bwd, the per-sample
// engine's), each as one trial step of K4's reverse walk. One kernel,
// mlp_step_walk_kernel<Seed>, over the seed policy: NormedSeed (K2: the
// rows' cotangents of y_new and k7 and the three norm sums', K4's own
// seeds), TupleSeed (K14: the five row cotangents) or LaneSeed (K12: the
// same five at every row's own t and dt, LaneTime). Included by
// whole_solve.cu only, after mlp_walk.cuh, whose phases it runs.
//
// Replaces the TPU kernels
//   K2: regneuralde_tpu/ops/pallas_mlp.py _normed_pallas_bwd
//       (_make_normed_kernels.bwd_kernel, math in _normed_bwd_math)
//   K14: regneuralde_tpu/ops/pallas_mlp.py _pallas_bwd (_fused_bwd_kernel)
//   K12: regneuralde_tpu/ops/pallas_mlp.py _pallas_bwd_lanes
//        (_fused_bwd_kernel_lanes)
// and, on this card, their ports over 2-row tiles (256 blocks at
// 512x784x100, each recomputing the six stages and walking them back) that
// read all of W1 and W2 from L2 twelve times a tile: ~1.9 GB a launch,
// 1.2-1.9 ms with the weight cotangents (H100 80GB HBM3 at 700 W).
//
// What bounds it on this card. The forward's six stages again (12
// contractions of B x D x H) and the reverse's twelve input-cotangent
// contractions, 48 B D H f32 operations, 1.9 GFLOP at 512x784x100: 29 us at
// the 67 TFLOP/s f32 rate; against that stand the dependent chain of stages,
// each with grid-wide barriers (every hidden row needs every column), and
// the latency of each phase's round trips to L2.
//
// What the design does about it. The step is one cooperative launch on the
// walk's tile plan (ops/whole_solve.py walk_plan: 32 x 100 tiles, 128 at the
// flagship; row chunks when the batch does not fit the grid):
//   * every block pads W1 and W2 for the walk's slabs and K3's, grid.sync();
//   * the replay: K3's own stages (solve_stages, mlp_solve.cuh) on the same
//     tiles write k2..k7 and each stage's hidden rows into a one-step
//     scratch (walk_replay, as K4 without the residual stream), grid.sync();
//   * the seed phase (walk_seed with the step's policy). NormedSeed: as in
//     K4's walk, the norm sums' cotangents (read by thread 0 from the
//     device, with t and dt) seed every stage derivative's cotangent through
//     the scaled error, k6's and k7's through the stiffness numerator, the
//     stage-6 and stage-5 inputs through its denominator and the error
//     norm's max(|y|, |y_new|); no saved rows, so no Hermite pullback.
//     TupleSeed: btilde_j dt ct_err into every stage derivative's cotangent,
//     ct_k7 and ct_k6 into k7's and k6's, ct_y_new as stage 6's input seed
//     and ct_g6 as stage 5's. Either way the input seeds are carried into
//     cty, the cotangents of the ks and the dt partial as those stages'
//     ct_yi carry them;
//   * the walk's six reverse stages (walk_stage<6..1>), each phase A, the
//     reduction and phase B split over the whole grid with two grid.sync(),
//     writing the weight-cotangent rows; the final pass writes ct_y, ct_k1;
//   * each tile's (ct_t, ct_dt) to its slot, grid.sync(), and block 0 sums
//     the slots in tile order. K12's are rows, one per batch row: each row's
//     ct_t, the sum over stages of its ct_ti, is whole in the block that
//     reduces the row (walk_reduce, ti_sum); its ct_dt is the time terms
//     there plus each element's seed and stage terms, kept per element in
//     shared memory (s.pdt) and summed per row over each tile's columns
//     after the walk (lane_rows_out), to a (row, column block) slot; after
//     the same last grid.sync() every row's slots are summed in column-block
//     order;
//   * then the weight-cotangent contraction (weight_cotangents.cu).
// So W1 and W2 are read once per row block a stage, not once per 2-row
// tile. The stages round as K3's (sums over D in column blocks): K14's
// replay is bitwise K13's forward (mlp_step_solve.cuh), K2's and K12's are
// not their forwards' (K1, K11), but the fast adjoint solve and the
// per-sample engine take their accept flags from the forward only, so the
// backward's rounding moves gradients, never a decision.
// IEEE f32 FMAs, no TF32, no fast math, no atomics: every sum has a fixed
// order, so runs are bitwise reproducible.

#pragma once

#include <type_traits>

namespace {

// The seeds of K14 and K12: the row cotangents of the tuple (y_new, k7,
// err, k6, g6). y_new's and k7's come through the walk step (ct_ynew,
// ct_k7), the other three through the policy; rows outside the tile get
// none. A seed policy of walk_seed (mlp_walk.cuh), at the step's times
// (TupleSeed) or at each row's own (LaneSeed, which keeps each element's
// share of ct_dt in s.pdt).
template <class TimeT>
struct TupleSeedOf {
  using Time = TimeT;
  const float *ct_err, *ct_k6, *ct_g6;

  struct In {
    SeedIn r;  // y, k1..k7, ct_y_new, ct_k7
    float ce[4], ck6[4], cg6[4];
  };

  template <bool STREAM>
  __device__ __forceinline__ void load(const BwdArgs<MlpDyn<STREAM>>& a,
                                       const WalkStepT<Time>& ws, const WalkTile& tl, int c,
                                       int g, In& in) const {
    seed_load(a, ws, tl, c, g, in.r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * g + i;
      const bool ok = r < tl.rows && c < tl.cols;
      const size_t gi = (size_t)(tl.row0 + r) * a.D + tl.d0 + c;
      in.ce[i] = ok ? __ldcg(ct_err + gi) : 0.0f;
      in.ck6[i] = ok ? __ldcg(ct_k6 + gi) : 0.0f;
      in.cg6[i] = ok ? __ldcg(ct_g6 + gi) : 0.0f;
    }
  }

  // _fused_bwd_kernel's seed block on one item (ops/fused_mlp.py _bwd_math;
  // _lanes_bwd_math's with each row's own dt).
  template <bool STREAM>
  __device__ __forceinline__ void compute(const BwdArgs<MlpDyn<STREAM>>&,
                                          const WalkStepT<Time>& ws, const WalkSmem& s,
                                          const WalkTile&, int R, int c, int g, const In& in,
                                          float (&part)[4]) const {
    const auto dtv = ws.tm.dtv(g);
    float4 ks[6], cks[6], cty, cp, pd = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dt = lane_of(dtv, i);
      const float* k = in.r.k[i];
      float s_comb = kBt[1] * (k[1] - k[0]);
#pragma unroll
      for (int j = 2; j <= 6; ++j) s_comb += kBt[j] * (k[j] - k[0]);
      const float ce = in.ce[i];
      float ck[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) ck[j] = kBt[j] * (dt * ce);
      ck[5] += in.ck6[i];
      const float ck6 = kBt[6] * (dt * ce) + in.r.ck7[i];
      float& p1 = Time::kLanes ? comp(pd, i) : part[1];
      seed_row(k, ck, ck6, ce, s_comb, in.r.cyn[i], in.cg6[i], 0.0f, dt, p1, i, ks, cks, cty,
               cp);
    }
    seed_store(s, R, c, g, ks, cks, cty, cp);
    if constexpr (Time::kLanes) st4(s.pdt + walk_at(c, g, R), pd);
  }
};
struct TupleSeed : TupleSeedOf<StepTime> {};
struct LaneSeed : TupleSeedOf<LaneTime> {};

// K12, after a row chunk's walk: for each row of the tile, its elements'
// shares of ct_dt (s.pdt) summed over the tile's columns in a fixed order
// (lane-strided, then the warp's tree), plus, in the block that reduced the
// row (rows db + k ndb), the time terms of its ct_dt; to the row's slot of
// this column block (slots: rows x ndb). That block also writes the row's
// ct_t.
__device__ __forceinline__ void lane_rows_out(const Walk& w, const WalkSmem& s,
                                              const WalkTile& tl, float* slots, float* ct_t) {
  const LaneRows& lr = *s.lanes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < tl.rows; r += kWarps) {
    float v = 0.0f;
    for (int c = lane; c < tl.cols; c += 32) v += s.pdt[walk_at(c, r / 4, w.R) + (r & 3)];
    v = warp_sum(v);
    if (lane == 0) {
      const size_t row = (size_t)tl.row0 + r;
      if (r % w.ndb == tl.db) {
        v += lr.cdt[r / w.ndb];
        ct_t[row] = lr.ct[r / w.ndb];
      }
      slots[row * w.ndb + tl.db] = v;
    }
  }
}

// The arguments of K2, K14 and K12: the walk's (a: the leaves and their
// weight-cotangent rows, B, D, rtol, atol, and ct_y, ct_f: the outputs ct_y,
// ct_k1; w: the plan and its scratch, the replay's included), the step's
// inputs and row cotangents, the seed policy, the per-tile (ct_t, ct_dt)
// slots, the output ct_tdt and the norm sums' cotangents (K2's).
template <class Seed>
struct StepWalkArgs {
  WalkArgs<false> wa;
  const float *t, *dt;  // scalars on the device (K12: B floats each)
  const float *y, *k1, *ct_ynew, *ct_k7;
  Seed seed;
  float* slots;           // tiles x 2 (K12: rows x ndb, rows = chunks x nrb x R)
  float* ct_tdt;          // (2,): ct_t, ct_dt (K12: (2, B))
  const float* ct_norms;  // (3,) on the device: of err_ssq, num_ssq, den_ssq (NormedSeed)
};

// K2 (NormedSeed), K14 (TupleSeed) and K12 (LaneSeed): one block a tile
// (gridDim.x == nrb * ndb, all resident).
template <class Seed>
__global__ void __launch_bounds__(kThreads, 1) mlp_step_walk_kernel(StepWalkArgs<Seed> args) {
  using Time = typename Seed::Time;
  extern __shared__ __align__(16) float walk_pool[];
  // in shared memory: no registers held across the phases
  __shared__ WalkStepT<Time> s_step;
  cg::grid_group grid = cg::this_grid();
  const BwdArgs<MlpDyn<false>>& a = args.wa.a;
  const Walk& w = args.wa.w;
  const MlpDyn<false>& m = a.dyn;
  const int H = m.H;
  const WalkSmem s = walk_smem(walk_pool, w, H);
  walk_pad_weights(m.W1, m.W2, w, a.D, H, s.HPP);
  solve_pad_weights(m.W1, m.W2, w.f, a.D, H, walk_round_up(H, kWalkTN));
  if (threadIdx.x == 0) {
    float c_err = 0.0f, c_num = 0.0f, c_den = 0.0f;
    if constexpr (std::is_same_v<Seed, NormedSeed>) {
      c_err = args.ct_norms[0];
      c_num = args.ct_norms[1];
      c_den = args.ct_norms[2];
    }
    Time tm;
    if constexpr (Time::kLanes) tm = Time{args.t, args.dt, s.lanes};
    else tm = Time{*args.t, *args.dt};
    s_step = WalkStepT<Time>{args.y,  args.k1,    nullptr, nullptr, w.ks_step, w.hs_step,
                             m.cp2,   m.he,       m.cp1,   m.ye,    args.ct_ynew, args.ct_k7,
                             nullptr, nullptr,    tm,      c_err,   c_num,    c_den,
                             0,       0};
  }
  grid.sync();
  const WalkStepT<Time>& ws = s_step;
  walk_replay(a, w, grid, ws.yi, ws.fi, ws.tm, walk_pool);
  grid.sync();
  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int chunk = 0; chunk < w.chunks; ++chunk) {
    const WalkTile tl = walk_tile(w, a.B, a.D, chunk);
    ws.tm.load(tl);
    walk_seed(a, w, ws, s, tl, part, args.seed);
    walk_stage<6>(args.wa, grid, ws, s, tl, part);
    walk_stage<5>(args.wa, grid, ws, s, tl, part);
    walk_stage<4>(args.wa, grid, ws, s, tl, part);
    walk_stage<3>(args.wa, grid, ws, s, tl, part);
    walk_stage<2>(args.wa, grid, ws, s, tl, part);
    walk_stage<1>(args.wa, grid, ws, s, tl, part);
    walk_final(a, w, ws, s, tl);
    if constexpr (Time::kLanes) lane_rows_out(w, s, tl, args.slots, args.ct_tdt);
  }
  if constexpr (Time::kLanes) {
    grid.sync();
    // each row's ct_dt: its slots summed in column-block order
    for (int row = blockIdx.x * kThreads + threadIdx.x; row < a.B; row += gridDim.x * kThreads) {
      float v = 0.0f;
      for (int q = 0; q < w.ndb; ++q) v += __ldcg(args.slots + (size_t)row * w.ndb + q);
      args.ct_tdt[a.B + row] = v;
    }
  } else {
    const float tdt[2] = {part[0], part[1]};
    block_sum_to<2>(tdt, s.red, args.slots + 2 * blockIdx.x);
    grid.sync();
    if (blockIdx.x == 0 && threadIdx.x < 32) {
      float sums[2];
      sum_tiles<2>(args.slots, gridDim.x, sums);
      if (threadIdx.x == 0) {
        args.ct_tdt[0] = sums[0];
        args.ct_tdt[1] = sums[1];
      }
    }
  }
}

}  // namespace
