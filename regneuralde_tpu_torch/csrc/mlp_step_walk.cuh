// K2 and K14 on Hopper: the backwards of the normed and of the tuple Tsit5
// trial step of MLPDynamics (ops/fused_mlp.py normed_sweep_bwd, the fast
// adjoint solve's; stage_sweep_bwd, odeint's generic engine's), each as one
// trial step of K4's reverse walk. One kernel, mlp_step_walk_kernel<Seed>,
// over the seed policy: NormedSeed (K2: the rows' cotangents of y_new and k7
// and the three norm sums', K4's own seeds) or TupleSeed (K14: the five row
// cotangents). Included by whole_solve.cu only, after mlp_walk.cuh, whose
// phases it runs unchanged.
//
// Replaces the TPU kernels
//   K2: regneuralde_tpu/ops/pallas_mlp.py _normed_pallas_bwd
//       (_make_normed_kernels.bwd_kernel, math in _normed_bwd_math)
//   K14: regneuralde_tpu/ops/pallas_mlp.py _pallas_bwd (_fused_bwd_kernel)
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
//     the slots in tile order;
//   * then the weight-cotangent contraction (weight_cotangents.cu).
// So W1 and W2 are read once per row block a stage, not once per 2-row
// tile. The stages round as K3's (sums over D in column blocks), not as the
// step forwards' (K1, K13): the fast adjoint solve and the replay adjoint
// take their accept flags from the forward only, so the backward's rounding
// moves gradients, never a decision.
// IEEE f32 FMAs, no TF32, no fast math, no atomics: every sum has a fixed
// order, so runs are bitwise reproducible.

#pragma once

#include <type_traits>

namespace {

// K14's seeds: the row cotangents of the tuple (y_new, k7, err, k6, g6).
// y_new's and k7's come through the walk step (ct_ynew, ct_k7), the other
// three through the policy; rows outside the tile get none. A seed policy
// of walk_seed (mlp_walk.cuh).
struct TupleSeed {
  const float *ct_err, *ct_k6, *ct_g6;

  struct In {
    SeedIn r;  // y, k1..k7, ct_y_new, ct_k7
    float ce[4], ck6[4], cg6[4];
  };

  template <bool STREAM>
  __device__ __forceinline__ void load(const BwdArgs<MlpDyn<STREAM>>& a, const WalkStep& ws,
                                       const WalkTile& tl, int c, int g, In& in) const {
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

  // _fused_bwd_kernel's seed block on one item (ops/fused_mlp.py _bwd_math).
  template <bool STREAM>
  __device__ __forceinline__ void compute(const BwdArgs<MlpDyn<STREAM>>&, const WalkStep& ws,
                                          const WalkSmem& s, const WalkTile&, int R, int c,
                                          int g, const In& in, float (&part)[4]) const {
    const float dt = ws.dt;
    float4 ks[6], cks[6], cty, cp;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
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
      seed_row(k, ck, ck6, ce, s_comb, in.r.cyn[i], in.cg6[i], 0.0f, dt, part[1], i, ks, cks,
               cty, cp);
    }
    seed_store(s, R, c, g, ks, cks, cty, cp);
  }
};

// The arguments of K2 and K14: the walk's (a: the leaves and their
// weight-cotangent rows, B, D, rtol, atol, and ct_y, ct_f: the outputs ct_y,
// ct_k1; w: the plan and its scratch, the replay's included), the step's
// inputs and row cotangents, the seed policy, the per-tile (ct_t, ct_dt)
// slots, the output ct_tdt and the norm sums' cotangents (K2's).
template <class Seed>
struct StepWalkArgs {
  WalkArgs<false> wa;
  const float *t, *dt;  // scalars on the device
  const float *y, *k1, *ct_ynew, *ct_k7;
  Seed seed;
  float* slots;           // tiles x 2
  float* ct_tdt;          // (2,): ct_t, ct_dt
  const float* ct_norms;  // (3,) on the device: of err_ssq, num_ssq, den_ssq (NormedSeed)
};

// K2 (NormedSeed) and K14 (TupleSeed): one block a tile (gridDim.x == nrb *
// ndb, all resident).
template <class Seed>
__global__ void __launch_bounds__(kThreads, 1) mlp_step_walk_kernel(StepWalkArgs<Seed> args) {
  extern __shared__ __align__(16) float walk_pool[];
  __shared__ WalkStep s_step;  // in shared memory: no registers held across the phases
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
    s_step = WalkStep{args.y,  args.k1,    nullptr, nullptr, w.ks_step, w.hs_step,
                      m.cp2,   m.he,       m.cp1,   m.ye,    args.ct_ynew, args.ct_k7,
                      nullptr, nullptr,    *args.t, *args.dt, c_err,    c_num,
                      c_den,   0,          0};
  }
  grid.sync();
  const WalkStep& ws = s_step;
  walk_replay(a, w, grid, ws.yi, ws.fi, ws.t, ws.dt, walk_pool);
  grid.sync();
  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int chunk = 0; chunk < w.chunks; ++chunk) {
    const WalkTile tl = walk_tile(w, a.B, a.D, chunk);
    walk_seed(a, w, ws, s, tl, part, args.seed);
    walk_stage<6>(args.wa, grid, ws, s, tl, part);
    walk_stage<5>(args.wa, grid, ws, s, tl, part);
    walk_stage<4>(args.wa, grid, ws, s, tl, part);
    walk_stage<3>(args.wa, grid, ws, s, tl, part);
    walk_stage<2>(args.wa, grid, ws, s, tl, part);
    walk_stage<1>(args.wa, grid, ws, s, tl, part);
    walk_final(a, w, ws, s, tl);
  }
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

}  // namespace
