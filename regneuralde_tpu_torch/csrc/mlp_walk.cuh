// K4 for MLPDynamics on Hopper: the reverse walk over the whole solve's
// trial steps, each reverse stage's two contractions split over the whole
// grid. Included by whole_solve.cu only, after the scalar chain it shares
// with the other walks (post_bwd, Chain, chain_begin/_end/_finish,
// hermite_elem, BwdArgs, MlpDyn) and after mlp_solve.cuh, K3's, whose tile
// toolkit it is built on and whose stages its replay runs. K2 and K14
// (mlp_step_walk.cuh) run one trial step of this walk, K2 with K4's seeds
// and K14 with seeds of its own (seed policies of walk_seed).
//
// Replaces the TPU kernel
//   K4: regneuralde_tpu/ops/pallas_solve.py make_whole_solve.make_bwd_kernel
//       for MLPDynamics, whose trial step is ops/pallas_mlp.py
//       _normed_bwd_math on the streamed stage residuals (cache_residuals)
// and, on this card, the walk over 2-row tiles (whole_solve_bwd_kernel
// with the step backward's tile body, 256 tiles at 512x784x100) that read
// all of W1 and W2 from L2 once per tile per stage: ~970 MB a trial step,
// 19.7 ms a walk, 21x its bound (H100 80GB HBM3 at 700 W).
//
// What bounds it on this card. A trial step's reverse is 12 contractions
// of B x D x H (the stages' input cotangents, 24 B D H f32 operations; the
// weight cotangents are the contraction after the walk), 0.96 GFLOP at
// 512x784x100: 14 us at the 67 TFLOP/s f32 rate. Against that stand two
// grid-wide barriers per stage (the stage's cotangent of the hidden layer
// needs every column of every row), the latency of each phase's round
// trips to L2, and the traffic that would evict the weights from L2 (the
// stream of stage residuals in, ~22 MB of weight-cotangent rows out a
// trial step at 512x784x100).
//
// What the design does about it.
//   * The grid is one tile per block: (row block x column block) tiles of
//     R rows x C columns of the batch's B x D elements (the plan of
//     ops/whole_solve.py walk_plan: 32 x 100, 128 tiles at the flagship).
//     Each block keeps its tile's reverse state for the whole trial step in
//     shared memory: ks[0..5], their cotangents cks[0..5] and cty
//     (kWalkState floats an element), and the tile's ct_pre2 of the next
//     stage. The seeds of the stage-6 and stage-5 inputs enter cty, cks and
//     the dt partial in the seed phase, as those stages' ct_yi carry them,
//     so they need no state of their own. Each array is column-major, its
//     4-row groups XOR-permuted by the column (walk_at), so that a quarter
//     warp reads 8 columns' or 8 groups' float4s without bank conflicts.
//   * Phase A of stage i: ct_h[r, h] = sum_d cp2_i[r, d] W2[d, h] for h in
//     0..H (column H is W2's time column), split over the column blocks:
//     each block sums its own C columns of cp2_i (in its shared memory)
//     against its C rows of W2, in column order, and stores the R x (H+1)
//     partial through L2. grid.sync().
//   * The reduction: each block sums, for its share of its row block's rows,
//     the row block's partials in column-block order, so ct_pre1 = ct_h (1 -
//     h_i^2), and stores them through L2, with those rows' cp1 and he rows
//     and time terms; then the row pass (below). grid.sync().
//   * Phase B: every block loads its row block's ct_pre1, then ct_yi[r, d] =
//     sum_h ct_pre1[r, h] W1[h, d] over its tile, in h order. The epilogue
//     updates cty, cks[j < i] and the dt partial, and forms cp2_{i-1} =
//     cks_{i-1} (1 - k_{i-1}^2), final once stage i is done, for the next
//     phase A, which needs no barrier before it. So W1 and W2 are each read
//     once per row block per stage, not once per 2-row tile: ~80 MB a trial
//     step at the flagship, from L2.
//   * Contractions: each thread holds a 4 x 4 register tile and takes one
//     float4 of each operand from shared memory per k. The weight rows
//     stream through shared memory in slabs of kWalkKB rows, kWalkStages in
//     flight, one 16-byte cp.async a thread a slab: the kernel first copies
//     W1 and W2 into zero-padded layouts (w1p, w2p) in which every slab is
//     whole 16-byte chunks. Each phase issues the next phase's first slabs
//     before its own tail, so the pipeline fills behind the barrier.
//   * The weight-cotangent rows (cp2, ye, cp1, he) go out with evict-first
//     stores and the stage residuals come in with evict-first loads, so the
//     weights, the partials and the rows of y stay in L2; the seed phase
//     prefetches into L2 the hidden activations the six reductions will
//     read. The row pass (cp2 and ye rows) and the final ct_y0, ct_f0 go to
//     global memory with consecutive threads on consecutive columns, the
//     rows of y they need loaded before the work they wait behind.
//   * The scalar chain runs in thread 0 of every block, redundantly, as in
//     the other walks; per trial step one more barrier after every block
//     wrote its slot of the cotangents of t and dt_eff. The trial step's
//     pointers sit in shared memory (s_step), not in registers across it.
//   * The replay (cache_residuals=False) runs first in every trial step:
//     the blocks recompute the step's stage residuals on K3's tiles with
//     K3's own stages (solve_stages, mlp_solve.cuh) into a one-step
//     scratch, grid.sync(), and the same walk reads it. So the streamed walk
//     equals the replay bitwise: K3 streamed the same bits.
//   * A batch whose state does not fit the grid's shared memory is walked
//     in row chunks, one after another, each the whole chain of stages.
//   * The phases are templates over the step's time policy (mlp_solve.cuh)
//     and read times only through it: StepTime here and in K2 and K14,
//     K12's LaneTime (mlp_step_walk.cuh), whose rows each take their own t
//     and dt. Only where the time terms of (ct_t, ct_dt) are summed do the
//     two differ (ti_term, ti_sum, dt_term): the thread's sums, or each
//     row's own.
// No atomics, no TF32, no fast math: every sum has a fixed order, so runs
// are bitwise reproducible.

#pragma once

namespace {

constexpr int kWalkState = 13;   // floats of reverse state an element
constexpr int kLaneState = 14;   // K12's: and each element's share of its row's ct_dt
constexpr int kWalkRounds = 4;   // a thread's items in a row pass, in registers
// shared-memory arrays of the state, kWalkState x (C x R)
enum { WS_KS = 0, WS_CKS = 6, WS_CTY = 12 };

// Floats of the walk's shared memory for tiles of R rows x C columns: the
// state (state floats an element: kWalkState, or kLaneState with K12's
// per-element ct_dt shares, which lie after the block sum's scratch),
// ct_pre2 of the tile (C rounded to a slab, x R), ct_pre1 of the row block
// (H rounded to a slab, x R), the slab ring (rows of H+1 or C floats,
// rounded to kWalkTN), the block sum's scratch and, with kLaneState, K12's
// LaneRows last.
__host__ __device__ inline size_t walk_smem_floats(int R, int C, int H,
                                                   int state = kWalkState) {
  const int HPP = walk_round_up(H + 1, kWalkTN);
  const int slab = HPP > C ? HPP : C;
  return (size_t)R * ((size_t)state * C + walk_round_up(C, kWalkKB) +
                      walk_round_up(H, kWalkKB)) +
         (size_t)kWalkStages * kWalkKB * slab + 4 * kWarps +
         (state == kLaneState ? kLaneRowFloats : 0);
}

// The walk's dynamic shared memory. The replay's stages (K3's, on the same
// tiles) reuse it: solve_smem_floats<F32> is below walk_smem_floats term by term
// (8 floats of state an element against 13, slabs of H against H+1).
size_t walk_smem_bytes(int R, int C, int H, int state = kWalkState) {
  return sizeof(float) * walk_smem_floats(R, C, H, state);
}

// The tile plan and the walk's own scratch (ops/whole_solve.py walk_plan).
struct Walk {
  float *ks_step, *hs_step;  // the replay's stage residuals of one step: 6 x B x D, 6 x B x H
  float* psum;               // phase A's partials: tiles x R x HPP
  float* ctp1g;              // the row blocks' ct_pre1: nrb x H x R
  float* w2p;                // W2 padded: ndb C rows of HPP floats, zero past W2
  float* w1p;                // W1x padded: H rows of ndb C floats, zero past D
  int R, C, nrb, ndb, chunks;
  Solve f;                   // the replay's: K3's tiles (the same plan) and scratch
};

template <bool STREAM>
struct WalkArgs {
  BwdArgs<MlpDyn<STREAM>> a;
  Walk w;
};

// One trial step's inputs and outputs as the phases see them, over its
// time policy (mlp_solve.cuh: StepTime, or K12's LaneTime).
template <class Time>
struct WalkStepT {
  const float *yi, *fi, *yn, *kn;  // hy[i], hf[i], hy[i+1], hf[i+1]
  const float *ksi, *hsi;          // its stage residuals: 6 x B x D, 6 x B x H
  float *cp2, *he, *cp1, *ye;      // its weight-cotangent rows (stage s at (s-1) B)
  const float *ct_ynew, *ct_k7;    // the seeds' row cotangents (null: zero)
  const float *pass_y, *pass_k1;   // added to ct_y0, ct_f0 (null: zero)
  Time tm;
  float c_err, c_num, c_den;
  int lo, hi;                      // saveat rows to pull back
};
using WalkStep = WalkStepT<StepTime>;

struct WalkSmem {
  float* st;    // kWalkState x C x R, column-major, groups permuted (walk_at)
  float* cp2;   // (C rounded to a slab) x R: the next phase A's ct_pre2, as st
  float* ctp1;  // (H rounded to a slab) x R: the row block's ct_pre1, [h][r]
  float* slab;  // kWalkStages slabs of SS floats
  float* red;   // 4 x kWarps
  float* pdt;   // K12's (kLaneState): C x R, as st, each element's share of ct_dt
  LaneRows* lanes;  // K12's: the tile's rows (LaneTime), after pdt
  int RC, SS, HPP;
};

__device__ __forceinline__ WalkSmem walk_smem(float* pool, const Walk& w, int H) {
  WalkSmem s;
  s.RC = w.R * w.C;
  s.HPP = walk_round_up(H + 1, kWalkTN);
  s.SS = kWalkKB * (s.HPP > w.C ? s.HPP : w.C);
  s.st = pool;
  s.cp2 = s.st + (size_t)kWalkState * s.RC;
  s.ctp1 = s.cp2 + (size_t)walk_round_up(w.C, kWalkKB) * w.R;
  s.slab = s.ctp1 + (size_t)walk_round_up(H, kWalkKB) * w.R;
  s.red = s.slab + (size_t)kWalkStages * s.SS;
  s.pdt = s.red + 4 * kWarps;
  s.lanes = reinterpret_cast<LaneRows*>(s.pdt + s.RC);  // 16-byte aligned: R is a multiple of 4
  return s;
}

// acc_I (ops/fused_mlp.py _stage_acc) of stage I on a float4 of 4 rows:
// sum_j a[I-1][j] ks[j], first term first.
template <int I>
__device__ __forceinline__ float4 walk_stage_acc(const float* st, int RC, int off) {
  const float4 k0 = ld4(st + WS_KS * RC + off);
  const float a0 = kA[I - 1][0];
  float4 acc = make_float4(a0 * k0.x, a0 * k0.y, a0 * k0.z, a0 * k0.w);
#pragma unroll
  for (int j = 1; j < I; ++j) acc = axpy4(kA[I - 1][j], ld4(st + (WS_KS + j) * RC + off), acc);
  return acc;
}

// Slab p of phase A's weights: the tile's C rows of the padded W2 (HPP
// floats each).
__device__ __forceinline__ void walk_load_w2(const Walk& w, const WalkSmem& s,
                                             const WalkTile& tl, int p) {
  slab_rows(s.slab + (p % kWalkStages) * s.SS, w.w2p + (size_t)tl.d0 * s.HPP, s.HPP, w.C, p);
}

// Slab p of phase B's weights: rows of the padded W1 at the tile's C
// columns, zero past H. (kk, c4) as slab_cols.
__device__ __forceinline__ void walk_load_w1(const Walk& w, const WalkSmem& s,
                                             const WalkTile& tl, int H, int kk, int c4,
                                             int p) {
  slab_cols(s.slab + (p % kWalkStages) * s.SS, w.w1p, (size_t)w.ndb * w.C, tl.d0, w.C, H, kk,
            c4, p);
}

// The padded copies of the weights the slabs are cut from (every block a
// share; the caller syncs the grid): W2 (D x (H+1)) into ndb C rows of HPP
// floats and W1's first D columns into H rows of ndb C floats, zero past
// the weights, so every slab is whole 16-byte copies.
__device__ void walk_pad_weights(const float* W1, const float* W2, const Walk& w, int D,
                                 int H, int HPP) {
  const size_t WS = (size_t)w.ndb * w.C;
  const size_t n2 = WS * HPP, n1 = (size_t)H * WS;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < n2 + n1;
       e += (size_t)gridDim.x * kThreads) {
    if (e < n2) {
      const size_t d = e / HPP, h = e - d * HPP;
      w.w2p[e] = d < (size_t)D && h <= (size_t)H ? W2[d * (H + 1) + h] : 0.0f;
    } else {
      const size_t h = (e - n2) / WS, d = (e - n2) - h * WS;
      w.w1p[e - n2] = d < (size_t)D ? W1[h * (D + 1) + d] : 0.0f;
    }
  }
}

// The loads of one item of the seed phase, 4 rows of a column (zero
// outside the tile).
struct SeedIn {
  float y[4], k[4][7], cyn[4], ck7[4];
};

template <bool STREAM, class Time>
__device__ __forceinline__ void seed_load(const BwdArgs<MlpDyn<STREAM>>& a,
                                          const WalkStepT<Time>& ws, const WalkTile& tl, int c,
                                          int g, SeedIn& in) {
  const size_t BD = (size_t)a.B * a.D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * g + i;
    const bool ok = r < tl.rows && c < tl.cols;
    const size_t gi = (size_t)(tl.row0 + r) * a.D + tl.d0 + c;
    in.y[i] = ok ? __ldcg(ws.yi + gi) : 0.0f;
    in.k[i][0] = ok ? __ldcg(ws.fi + gi) : 0.0f;
#pragma unroll
    for (int j = 1; j <= 6; ++j) {
      const float* p = ws.ksi + (j - 1) * BD + gi;
      in.k[i][j] = ok ? (STREAM ? __ldcs(p) : __ldcg(p)) : 0.0f;
    }
    in.cyn[i] = ok && ws.ct_ynew ? __ldcg(ws.ct_ynew + gi) : 0.0f;
    in.ck7[i] = ok && ws.ct_k7 ? __ldcg(ws.ct_k7 + gi) : 0.0f;
  }
}

// The seeds of the stage-6 and stage-5 inputs applied to row i of an
// item (k: its k1..k7; ck: its cotangents of k1..k6 so far, ck6 of k7),
// as those stages' ct_yi carry them, into cty (from cty0), the dt partial
// (after cerr * s_comb, the error row's share) and the cotangents of the
// ks; then the row's state and ct_pre2 of stage 6 into lane i of the
// item's float4s. Shared by K4's and K2's seed and K14's and K12's
// (mlp_step_walk.cuh).
__device__ __forceinline__ void seed_row(const float* k, float (&ck)[6], float ck6, float cerr,
                                         float s_comb, float seed6, float seed5, float cty0,
                                         float dt, float& part1, int i, float4 (&ks)[6],
                                         float4 (&cks)[6], float4& cty, float4& cp) {
  float acc6 = kA[5][0] * k[0], acc5 = kA[4][0] * k[0];
#pragma unroll
  for (int j = 1; j < 6; ++j) acc6 += kA[5][j] * k[j];
#pragma unroll
  for (int j = 1; j < 5; ++j) acc5 += kA[4][j] * k[j];
  part1 += cerr * s_comb;
  part1 += seed6 * acc6;
  part1 += seed5 * acc5;
#pragma unroll
  for (int j = 0; j < 6; ++j) ck[j] += (dt * kA[5][j]) * seed6;
#pragma unroll
  for (int j = 0; j < 5; ++j) ck[j] += (dt * kA[4][j]) * seed5;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    comp(ks[j], i) = k[j];
    comp(cks[j], i) = ck[j];
  }
  comp(cty, i) = cty0 + seed6 + seed5;
  comp(cp, i) = ck6 * (1.0f - k[6] * k[6]);
}

// An item's seeded state into the tile's shared arrays (walk_at).
__device__ __forceinline__ void seed_store(const WalkSmem& s, int R, int c, int g,
                                           const float4 (&ks)[6], const float4 (&cks)[6],
                                           float4 cty, float4 cp) {
  const int off = walk_at(c, g, R);
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    st4(s.st + (WS_KS + j) * s.RC + off, ks[j]);
    st4(s.st + (WS_CKS + j) * s.RC + off, cks[j]);
  }
  st4(s.st + WS_CTY * s.RC + off, cty);
  st4(s.cp2 + off, cp);
}

// The normed seed block (ops/fused_mlp.py _normed_bwd_math) on one item,
// element by element, after the Hermite pullback of the saved rows, with
// the seeds of the stage-6 and stage-5 inputs applied: the state's initial
// values and ct_pre2 of stage 6. Zero inputs (outside the tile) give zero
// state.
// part: this thread's (ct_t, ct_dt, Hermite ct_t, Hermite ct_dt).
template <bool STREAM>
__device__ __forceinline__ void seed_compute(const BwdArgs<MlpDyn<STREAM>>& a,
                                             const WalkStep& ws, const WalkSmem& s,
                                             const WalkTile& tl, int R, int c, int g,
                                             const SeedIn& in, float (&part)[4]) {
  const size_t BD = (size_t)a.B * a.D;
  const float dt = ws.tm.dt;
  const bool h0 = dt == 0.0f;
  const float hd = h0 ? 1.0f : dt;
  float4 ks[6], cks[6], cty, cp;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* k = in.k[i];
    const float yv = in.y[i];
    // the stage-6 (y_new) and stage-5 states, by the replay's own routine
    const float yn = stage_state(6, &yv, k, 1, 0, dt);
    const float g6 = stage_state(5, &yv, k, 1, 0, dt);
    float cyn = in.cyn[i], ck7 = in.ck7[i];
    const int r = 4 * g + i;
    if (ws.ct_ynew && ws.hi > ws.lo && r < tl.rows && c < tl.cols) {
      const size_t gi = (size_t)(tl.row0 + r) * a.D + tl.d0 + c;
      float c_y0, c_y1, c_f0, c_f1;
      hermite_elem(a.sv.sa, a.sv.ys, ws.lo, ws.hi, ws.tm.t, dt, hd, h0, yv,
                   __ldcg(ws.yn + gi), k[0], __ldcg(ws.kn + gi), gi, BD, part + 2, c_y0,
                   c_y1, c_f0, c_f1);
      cyn = cyn + c_y1;
      ck7 = ck7 + c_f1;
      a.hdy[gi] = c_y0;
      a.hdf[gi] = c_f0;
    }
    float s_comb = kBt[1] * (k[1] - k[0]);
#pragma unroll
    for (int j = 2; j <= 6; ++j) s_comb += kBt[j] * (k[j] - k[0]);
    const float err = dt * s_comb;
    const float denom = a.atol + fmaxf(fabsf(yv), fabsf(yn)) * a.rtol;
    const float scaled = err / denom;
    const float cerr = ws.c_err * 2.0f * scaled / denom;
    const float cdenom = ws.c_err * (-2.0f) * scaled * scaled / denom;
    // all of the max subgradient goes to y on ties (pallas_mlp.py:1000-1002)
    const bool y_is_max = fabsf(yv) >= fabsf(yn);
    const float to_y = y_is_max ? cdenom * a.rtol * sign_of(yv) : 0.0f;
    const float to_ynew = y_is_max ? 0.0f : cdenom * a.rtol * sign_of(yn);
    const float d_k7 = ws.c_num * 2.0f * (k[6] - k[5]);
    const float d_ynew = ws.c_den * 2.0f * (yn - g6);
    float ck[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) ck[j] = kBt[j] * (dt * cerr);
    ck[5] = kBt[5] * (dt * cerr) - d_k7;
    const float ck6 = kBt[6] * (dt * cerr) + ck7 + d_k7;
    // the seeds of the stage-6 and stage-5 inputs
    seed_row(k, ck, ck6, cerr, s_comb, cyn + d_ynew + to_ynew, -d_ynew, to_y, dt, part[1], i,
             ks, cks, cty, cp);
  }
  seed_store(s, R, c, g, ks, cks, cty, cp);
}

// K4's seeds (the walk's trial step): the rows' cotangents of y_new and k7
// (with the Hermite pullback of the saved rows) and the norm sums' (c_err,
// c_num, c_den), in _normed_bwd_math's algebra; K2's too, with no saved
// rows (hi == lo). A seed policy of walk_seed: In, the loads of one item;
// load; compute.
struct NormedSeed {
  using Time = StepTime;
  using In = SeedIn;
  template <bool STREAM>
  __device__ __forceinline__ void load(const BwdArgs<MlpDyn<STREAM>>& a, const WalkStep& ws,
                                       const WalkTile& tl, int c, int g, In& in) const {
    seed_load(a, ws, tl, c, g, in);
  }
  template <bool STREAM>
  __device__ __forceinline__ void compute(const BwdArgs<MlpDyn<STREAM>>& a, const WalkStep& ws,
                                          const WalkSmem& s, const WalkTile& tl, int R, int c,
                                          int g, const In& in, float (&part)[4]) const {
    seed_compute(a, ws, s, tl, R, c, g, in, part);
  }
};

// The seed phase of one tile (items: 4 rows of a column, consecutive
// threads on consecutive columns), two items' loads in flight at once, by
// the seed policy (NormedSeed: K4's and K2's; TupleSeed: K14's; LaneSeed:
// K12's). Phase A(6)'s first slabs are issued first.
template <bool STREAM, class Time, class Seed = NormedSeed>
__device__ __forceinline__ void walk_seed(const BwdArgs<MlpDyn<STREAM>>& a, const Walk& w,
                          const WalkStepT<Time>& ws, const WalkSmem& s, const WalkTile& tl,
                          float (&part)[4], const Seed& seed = Seed{}) {
  const int C = w.C, n = C * (w.R / 4), H = a.dyn.H;
  walk_prefetch((tl.cols + kWalkKB - 1) / kWalkKB,
                [&](int p) { walk_load_w2(w, s, tl, p); });
  // the hidden activations the reductions of the six stages will read
  // (this block's rows, from device memory) into L2 ahead of them
  const int lines = (H + 31) / 32, nr = (w.R - tl.db + w.ndb - 1) / w.ndb;
  for (int e = threadIdx.x; e < 6 * nr * lines; e += kThreads) {
    const int st = e / (nr * lines), k = (e / lines) % nr, l = e % lines;
    const int r = tl.db + k * w.ndb;
    if (r < tl.rows)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(
          ws.hsi + ((size_t)st * a.B + tl.row0 + r) * H + 32 * l));
  }
  // ct_pre2's padding columns stay zero: phase A sums whole slabs
  for (int e = C * w.R + threadIdx.x; e < walk_round_up(C, kWalkKB) * w.R; e += kThreads)
    s.cp2[e] = 0.0f;
  for (int e0 = threadIdx.x; e0 < n; e0 += 2 * kThreads) {
    typename Seed::In in[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = e0 + u * kThreads;
      if (e < n) seed.load(a, ws, tl, e % C, e / C, in[u]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = e0 + u * kThreads;
      if (e < n) seed.compute(a, ws, s, tl, w.R, e % C, e / C, in[u], part);
    }
  }
}

// Phase A of stage I: this tile's partial of ct_h = cp2_I W2 over its
// columns, R rows x (H+1) (column H: W2's time column), to out ([R][HPP],
// through L2); then phase B's first slabs, behind the barrier.
template <int I, bool STREAM>
__device__ __forceinline__ void walk_phase_a(const BwdArgs<MlpDyn<STREAM>>& a, const Walk& w,
                                             const WalkSmem& s, const WalkTile& tl,
                                             float* out) {
  const int R = w.R, C = w.C, G4 = R / 4, H = a.dyn.H;
  const int items = G4 * (s.HPP / 4);
  const int nslab = (tl.cols + kWalkKB - 1) / kWalkKB;
  auto load = [&](int p) { walk_load_w2(w, s, tl, p); };
  for (int base = 0; base < items; base += kThreads) {
    const int item = base + threadIdx.x;
    const int g = item % G4, hg = item / G4;
    float acc[kWalkTM][kWalkTN] = {};
    if (base > 0) walk_prefetch(nslab, load);
    walk_gemm(acc, item < items, nslab, load,
              [&](int k) { return ld4(s.cp2 + walk_at(k, g, R)); },
              [&](int slot, int kk) {
                return ld4(s.slab + slot * s.SS + kk * s.HPP + 4 * hg);
              });
    if (item < items) {
#pragma unroll
      for (int i = 0; i < kWalkTM; ++i)
        __stcg(reinterpret_cast<float4*>(out + (size_t)(4 * g + i) * s.HPP + 4 * hg),
               make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }
  }
  const int kk0 = threadIdx.x / (C / 4), c40 = threadIdx.x % (C / 4);
  walk_prefetch((H + kWalkKB - 1) / kWalkKB,
                [&](int p) { walk_load_w1(w, s, tl, H, kk0, c40, p); });
}

// The time terms of (ct_t, ct_dt), by the step's time policy: ti_term and
// ti_sum, stage I's ct_ti in walk_reduce (its terms ct_pre1 w1t, h < H, and
// cp2_I against W2's time column, h == H; ct_t += ct_ti, ct_dt += c_I
// ct_ti); dt_term, ct_yi . acc_i in phase B. StepTime: the thread's sums
// (part[0], part[1]), summed over the grid after the walk. LaneTime: each
// row's own. Row k of the rows this block reduces (rows db + k ndb of the
// tile) keeps its terms (ct_pre1 w1t in s.ctp1, [k][h], free until phase B;
// the time column's in rows->vt), and ti_sum adds them over h in a fixed
// order (lane-strided, then the warp's tree), then the time column's, to
// rows->ct and, times c_I, rows->cdt; ct_yi . acc_i stays with its element
// (s.pdt), summed per row after the walk (mlp_step_walk.cuh lane_rows_out).
__device__ __forceinline__ void ti_term(const StepTime&, const WalkSmem&, int, int, int,
                                        float v, float& ct_ti) {
  ct_ti += v;
}
__device__ __forceinline__ void ti_term(const LaneTime& tm, const WalkSmem& s, int k, int h,
                                        int H, float v, float&) {
  if (h < H) s.ctp1[k * H + h] = v;
  else tm.rows->vt[k] = v;
}
template <int I>
__device__ __forceinline__ void ti_sum(const StepTime&, const WalkSmem&, const Walk&,
                                       const WalkTile&, int, float ct_ti, float (&part)[4]) {
  part[0] += ct_ti;
  part[1] += kC[I] * ct_ti;
}
template <int I>
__device__ __forceinline__ void ti_sum(const LaneTime& tm, const WalkSmem& s, const Walk& w,
                                       const WalkTile& tl, int H, float, float (&)[4]) {
  LaneRows& lr = *tm.rows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // every term is in
  for (int k = warp; tl.db + k * w.ndb < tl.rows; k += kWarps) {
    float v = 0.0f;
    for (int h = lane; h < H; h += 32) v += s.ctp1[k * H + h];
    v = warp_sum(v);
    if (lane == 0) {
      const float ct = lr.vt[k] + v;
      lr.ct[k] += ct;
      lr.cdt[k] += kC[I] * ct;
    }
  }
}
__device__ __forceinline__ void dt_term(const StepTime&, float*, float4 ct, float4 acc,
                                        float (&part)[4]) {
  part[1] += ct.x * acc.x;
  part[1] += ct.y * acc.y;
  part[1] += ct.z * acc.z;
  part[1] += ct.w * acc.w;
}
__device__ __forceinline__ void dt_term(const LaneTime&, float* pdt, float4 ct, float4 acc,
                                        float (&)[4]) {
  const float4 p = ld4(pdt);
  st4(pdt, make_float4(p.x + ct.x * acc.x, p.y + ct.y * acc.y, p.z + ct.z * acc.z,
                       p.w + ct.w * acc.w));
}

// The reduction of stage I: ct_h of this block's share of its row
// block's rows (r = db, db + ndb, ...) from the column blocks' partials
// (psum: the row block's ndb partials, [R][HPP] each), summed in
// column-block order, so ct_pre1 = ct_h (1 - h_I^2), to ctp1g ([H][R],
// through L2); the rows' cp1 and he and the time columns of he and ye, and
// the time terms of ct_ti. Items (row, h), consecutive threads on
// consecutive h, four in flight a thread. Then the row pass, whose loads of
// y go first: cp2_I's rows and, below stage 6, ye of stage I+1.
template <int I, bool STREAM, class Time>
__device__ __forceinline__ void walk_reduce(const BwdArgs<MlpDyn<STREAM>>& a, const Walk& w,
                                            const WalkStepT<Time>& ws, const WalkSmem& s,
                                            const WalkTile& tl, const float* psum,
                                            float* ctp1g, float (&part)[4]) {
  const MlpDyn<STREAM>& m = a.dyn;
  const int H = m.H, HP = H + 1, R = w.R, B = a.B, D = a.D;
  const Time tm = ws.tm;
  const size_t srow = (size_t)(I - 1) * B;  // stage I's weight-cotangent rows
  const float* hsi = ws.hsi + srow * H;
  const size_t PT = (size_t)R * s.HPP;     // floats of one tile's partial
  const int n = (R - tl.db + w.ndb - 1) / w.ndb * HP;
  // the row pass's rows of y (ye of stage I+1), loaded first
  const int C = w.C, nrow = C * (R / 4);
  float yp[kWalkRounds][4];
#pragma unroll
  for (int q = 0; q < kWalkRounds; ++q) {
    const int e = threadIdx.x + q * kThreads, c = e % C, g = e / C;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * g + i;
      const bool ok = I < 6 && e < nrow && r < tl.rows && c < tl.cols;
      yp[q][i] = ok ? __ldcg(ws.yi + (size_t)(tl.row0 + r) * D + tl.d0 + c) : 0.0f;
    }
  }
  float ct_ti = 0.0f;  // StepTime's: the thread's terms
  constexpr int U = 4;
  for (int e0 = threadIdx.x; e0 < n; e0 += U * kThreads) {
    float v[U] = {}, hv[U], w1t[U];
    for (int q = 0; q < w.ndb; ++q) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * kThreads, k = e / HP, h = e - k * HP;
        if (e < n) v[u] += __ldcg(psum + q * PT + (size_t)(tl.db + k * w.ndb) * s.HPP + h);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * kThreads, k = e / HP, h = e - k * HP, r = tl.db + k * w.ndb;
      const bool valid = e < n && r < tl.rows && h < H;
      hv[u] = valid ? __ldcs(hsi + (size_t)(tl.row0 + r) * H + h) : 0.0f;
      w1t[u] = valid ? __ldg(m.W1 + (size_t)h * (D + 1) + D) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * kThreads, k = e / HP, h = e - k * HP, r = tl.db + k * w.ndb;
      if (e >= n) continue;
      const bool valid = r < tl.rows;
      const size_t row = (size_t)tl.row0 + r;
      if (h < H) {
        const float c1 = v[u] * (1.0f - hv[u] * hv[u]);
        __stcg(ctp1g + (size_t)h * R + r, c1);
        if (valid) {
          __stcs(ws.cp1 + (srow + row) * H + h, c1);
          __stcs(ws.he + (srow + row) * (H + 2) + h, hv[u]);
          ti_term(tm, s, k, h, H, c1 * w1t[u], ct_ti);
        }
      } else if (valid) {
        const float ti = tm.t_row(r) + kC[I] * tm.dt_row(r);
        ti_term(tm, s, k, H, H, v[u], ct_ti);  // cp2_I against W2's time column
        __stcs(ws.he + (srow + row) * (H + 2) + H, ti);
        __stcs(ws.he + (srow + row) * (H + 2) + H + 1, 1.0f);
        __stcs(ws.ye + (srow + row) * (D + 2) + D, ti);
        __stcs(ws.ye + (srow + row) * (D + 2) + D + 1, 1.0f);
      }
    }
  }
  ti_sum<I>(tm, s, w, tl, H, ct_ti, part);
  // the row pass: cp2_I's rows (still in shared memory) and, below stage 6,
  // ye of stage I+1
#pragma unroll
  for (int q = 0; q < kWalkRounds; ++q) {
    const int e = threadIdx.x + q * kThreads;
    if (e >= nrow) break;
    const int c = e % C, g = e / C, off = walk_at(c, g, R);
    float4 cp = ld4(s.cp2 + off);
    float4 accv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (I < 6) accv = walk_stage_acc<I + 1>(s.st, s.RC, off);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * g + i;
      if (r >= tl.rows || c >= tl.cols) continue;
      const size_t row = (size_t)tl.row0 + r, d = (size_t)tl.d0 + c;
      __stcs(ws.cp2 + ((size_t)(I - 1) * B + row) * D + d, comp(cp, i));
      if (I < 6)
        __stcs(ws.ye + ((size_t)I * B + row) * (D + 2) + d,
               yp[q][i] + tm.dt_row(r) * comp(accv, i));
    }
  }
}

// Phase B of stage I: the row block's ct_pre1 (ctp1g, [H][R]) into shared
// memory, then this tile's ct_yi = ct_pre1 W1x and its epilogue (see the
// header note), and above stage 1 the next phase A's first slabs.
template <int I, bool STREAM, class Time>
__device__ __forceinline__ void walk_phase_b(const BwdArgs<MlpDyn<STREAM>>& a, const Walk& w,
                             const WalkStepT<Time>& ws, const WalkSmem& s, const WalkTile& tl,
                             const float* ctp1g, float (&part)[4]) {
  const MlpDyn<STREAM>& m = a.dyn;
  const int H = m.H, R = w.R, C = w.C, G4 = R / 4;
  const int RC = s.RC;
  // the policy read from the step where it is used: a copy in registers
  // held across the contraction gave K4's walk 73 local loads, not 17
  // (tools/torch_k4_variants.py, tmcopy_b)
  const Time& tm = ws.tm;
  for (int e = threadIdx.x; e < H * R / 4; e += kThreads)
    st4(s.ctp1 + 4 * e, __ldcg(reinterpret_cast<const float4*>(ctp1g) + e));
  for (int e = H * R + threadIdx.x; e < walk_round_up(H, kWalkKB) * R; e += kThreads)
    s.ctp1[e] = 0.0f;
  __syncthreads();

  // ---- ct_yi = ct_pre1 W1x on 4 x 4 register tiles, and the epilogue ----
  const int items = G4 * (C / 4);
  const int nslab = (H + kWalkKB - 1) / kWalkKB;
  const int kk0 = threadIdx.x / (C / 4), c40 = threadIdx.x % (C / 4);
  auto load = [&](int p) { walk_load_w1(w, s, tl, H, kk0, c40, p); };
  for (int base = 0; base < items; base += kThreads) {
    const int item = base + threadIdx.x;
    const int g = item % G4, cg = item / G4;
    float acc[kWalkTM][kWalkTN] = {};
    if (base > 0) walk_prefetch(nslab, load);
    walk_gemm(acc, item < items, nslab, load,
              [&](int k) { return ld4(s.ctp1 + k * R + 4 * g); },
              [&](int slot, int kk) { return ld4(s.slab + slot * s.SS + kk * C + 4 * cg); });
    if (I > 1 && base + kThreads >= items)  // phase A(I-1)'s first slabs
      walk_prefetch((tl.cols + kWalkKB - 1) / kWalkKB,
                    [&](int p) { walk_load_w2(w, s, tl, p); });
    if (item >= items) continue;
    const auto dtv = tm.dtv(g);
#pragma unroll
    for (int u = 0; u < kWalkTN; ++u) {
      const int off = walk_at(4 * cg + u, g, R);
      const float4 ct = make_float4(acc[0][u], acc[1][u], acc[2][u], acc[3][u]);
      float* cty = s.st + WS_CTY * RC + off;
      st4(cty, add4(ld4(cty), ct));
      dt_term(tm, s.pdt + off, ct, walk_stage_acc<I>(s.st, RC, off), part);
#pragma unroll
      for (int j = 0; j < I; ++j) {
        const float cf = kA[I - 1][j];
        float* ck = s.st + (WS_CKS + j) * RC + off;
        if (cf != 0.0f) st4(ck, axpy4(times(dtv, cf), ct, ld4(ck)));
      }
      if (I > 1) {  // cks[I-1] is final: ct_pre2 of stage I-1
        const float4 kv = ld4(s.st + (WS_KS + I - 1) * RC + off);
        const float4 ck = ld4(s.st + (WS_CKS + I - 1) * RC + off);
        st4(s.cp2 + off, make_float4(ck.x * (1.0f - kv.x * kv.x), ck.y * (1.0f - kv.y * kv.y),
                                     ck.z * (1.0f - kv.z * kv.z), ck.w * (1.0f - kv.w * kv.w)));
      }
    }
  }
}

// After stage 1: the row pass of ye of stage 1 and the tile's final ct_y0 =
// pass_y + cty, ct_f0 = pass_k1 + cks[0], every load first.
template <bool STREAM, class Time>
__device__ __forceinline__ void walk_final(const BwdArgs<MlpDyn<STREAM>>& a, const Walk& w,
                           const WalkStepT<Time>& ws, const WalkSmem& s, const WalkTile& tl) {
  const int R = w.R, C = w.C, D = a.D, nrow = C * (R / 4);
  float yp[kWalkRounds][4], py[kWalkRounds][4], pk[kWalkRounds][4];
#pragma unroll
  for (int q = 0; q < kWalkRounds; ++q) {
    const int e = threadIdx.x + q * kThreads, c = e % C, g = e / C;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * g + i;
      const bool ok = e < nrow && r < tl.rows && c < tl.cols;
      const size_t gi = (size_t)(tl.row0 + r) * D + tl.d0 + c;
      yp[q][i] = ok ? __ldcg(ws.yi + gi) : 0.0f;
      py[q][i] = ok && ws.pass_y ? __ldcg(ws.pass_y + gi) : 0.0f;
      pk[q][i] = ok && ws.pass_k1 ? __ldcg(ws.pass_k1 + gi) : 0.0f;
    }
  }
  __syncthreads();  // the last epilogue's state is complete
#pragma unroll
  for (int q = 0; q < kWalkRounds; ++q) {
    const int e = threadIdx.x + q * kThreads;
    if (e >= nrow) break;
    const int c = e % C, g = e / C, off = walk_at(c, g, R);
    float4 accv = walk_stage_acc<1>(s.st, s.RC, off);
    float4 cty = ld4(s.st + WS_CTY * s.RC + off);
    float4 ck0 = ld4(s.st + WS_CKS * s.RC + off);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * g + i;
      if (r >= tl.rows || c >= tl.cols) continue;
      const size_t row = (size_t)tl.row0 + r, gi = row * D + tl.d0 + c;
      __stcs(ws.ye + row * (D + 2) + tl.d0 + c, yp[q][i] + ws.tm.dt_row(r) * comp(accv, i));
      a.ct_y[gi] = py[q][i] + comp(cty, i);
      a.ct_f[gi] = pk[q][i] + comp(ck0, i);
    }
  }
}

// One reverse stage: phase A, the barrier, the reduction, the barrier,
// phase B. Each block's next phase A comes after the second barrier, so
// every partial and ct_pre1 it overwrites has been read.
template <int I, bool STREAM, class Time>
__device__ __forceinline__ void walk_stage(const WalkArgs<STREAM>& args, cg::grid_group& grid,
                                           const WalkStepT<Time>& ws, const WalkSmem& s,
                                           const WalkTile& tl, float (&part)[4]) {
  const Walk& w = args.w;
  const size_t pstride = (size_t)s.HPP * w.R;
  float* ctp1g = w.ctp1g + (size_t)tl.rb * args.a.dyn.H * w.R;
  __syncthreads();  // ct_pre2 is complete
  walk_phase_a<I>(args.a, w, s, tl, w.psum + blockIdx.x * pstride);
  grid.sync();
  walk_reduce<I>(args.a, w, ws, s, tl, w.psum + (size_t)tl.rb * w.ndb * pstride, ctp1g, part);
  grid.sync();
  walk_phase_b<I>(args.a, w, ws, s, tl, ctp1g, part);
}

// The replay: trial step i's stage residuals (k2..k7 and each stage's
// hidden activations) into the one-step scratch, by K3's own stages on K3's
// tiles (w.f), at the step's times (tm).
template <bool STREAM, class Time>
__device__ __forceinline__ void walk_replay(const BwdArgs<MlpDyn<STREAM>>& a, const Walk& w,
                                            cg::grid_group& grid, const float* yi,
                                            const float* fi, const Time& tm, float* pool) {
  const SolveSmem s = solve_smem(pool, w.f, a.dyn.H);
  const SolveStep<Time> ss{yi, fi, w.ks_step, w.hs_step, tm};
  for (int chunk = 0; chunk < w.f.chunks; ++chunk)
    solve_stages<true>(a.dyn, w.f, grid, ss, s, walk_tile(w.f, a.B, a.D, chunk), a.B, a.D);
}

// K4 for MLPDynamics: the reverse walk over the forward's ns trial steps,
// one block a tile (gridDim.x == nrb * ndb, all resident), on the stage
// residuals' stream (STREAM) or replaying them.
template <bool STREAM>
__global__ void __launch_bounds__(kThreads, 1) mlp_walk_kernel(WalkArgs<STREAM> args) {
  extern __shared__ __align__(16) float walk_pool[];
  __shared__ float s_ct[5];
  __shared__ float s_ti, s_dteff;
  __shared__ int s_last, s_acc, s_lo, s_hi, s_rcur;
  __shared__ PostGrads s_g;
  __shared__ WalkStep s_step;  // in shared memory: no registers held across the phases
  const Chain ch{s_ct, s_g, s_ti, s_dteff, s_last, s_acc, s_lo, s_hi, s_rcur};
  cg::grid_group grid = cg::this_grid();
  const BwdArgs<MlpDyn<STREAM>>& a = args.a;
  const Walk& w = args.w;
  const MlpDyn<STREAM>& m = a.dyn;
  const int H = m.H, B = a.B, D = a.D;
  const int tiles = w.nrb * w.ndb;
  const size_t BD = (size_t)B * D;
  const float t0 = a.scalars[0], t1 = a.scalars[1];
  const float tdir = sign_of(t1 - t0), span = fabsf(t1 - t0);
  const float count = (float)BD;
  const int cur0 = a.sv.n ? a.sv.cursors[0] : 0;
  const WalkSmem s = walk_smem(walk_pool, w, H);
  if (threadIdx.x < 5) s_ct[threadIdx.x] = 0.0f;
  if (threadIdx.x == 0) s_rcur = a.sv.n ? a.sv.cursors[1] : 0;
  walk_pad_weights(m.W1, m.W2, w, D, H, s.HPP);
  if constexpr (!STREAM) solve_pad_weights(m.W1, m.W2, w.f, D, H, walk_round_up(H, kWalkTN));
  grid.sync();

  for (int j = 0; j < a.ns; ++j) {
    const int i = a.ns - 1 - j;
    if (threadIdx.x == 0) chain_begin(a, ch, i, cur0, t1, tdir, span, count);
    __syncthreads();
    const float* yi = a.hy + (size_t)i * BD;
    const float* fi = a.hf + (size_t)i * BD;
    if constexpr (!STREAM) {
      walk_replay(a, w, grid, yi, fi, StepTime{s_ti, s_dteff}, walk_pool);
      grid.sync();
    }
    if (threadIdx.x == 0) {
      const bool acc = s_acc, saves = s_hi > s_lo;
      const size_t base = (size_t)i * 6 * B;  // this step's weight-cotangent rows
      // y_out = where(acc, y_new, y), f0_out likewise: route the carry
      s_step = WalkStep{yi, fi, a.hy + (size_t)(i + 1) * BD, a.hf + (size_t)(i + 1) * BD,
                        STREAM ? m.ks + (size_t)i * 6 * BD : w.ks_step,
                        STREAM ? m.hs + (size_t)i * 6 * B * H : w.hs_step,
                        m.cp2 + base * D, m.he + base * (H + 2), m.cp1 + base * H,
                        m.ye + base * (D + 2), acc ? a.ct_y : nullptr, acc ? a.ct_f : nullptr,
                        acc ? (saves ? a.hdy : nullptr) : a.ct_y,
                        acc ? (saves ? a.hdf : nullptr) : a.ct_f, s_ti, s_dteff, s_g.e,
                        s_g.n, s_g.d, s_lo, saves ? s_hi : s_lo};
    }
    __syncthreads();
    const WalkStep& ws = s_step;
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int chunk = 0; chunk < w.chunks; ++chunk) {
      const WalkTile tl = walk_tile(w, B, D, chunk);
      walk_seed(a, w, ws, s, tl, part);
      walk_stage<6>(args, grid, ws, s, tl, part);
      walk_stage<5>(args, grid, ws, s, tl, part);
      walk_stage<4>(args, grid, ws, s, tl, part);
      walk_stage<3>(args, grid, ws, s, tl, part);
      walk_stage<2>(args, grid, ws, s, tl, part);
      walk_stage<1>(args, grid, ws, s, tl, part);
      walk_final(a, w, ws, s, tl);
    }
    float* slots = a.partials + (size_t)(j & 1) * tiles * 4;
    block_sum_to<4>(part, s.red, slots + 4 * blockIdx.x);
    grid.sync();
    if (threadIdx.x < 32) chain_end(a, ch, slots, tiles, i);
    __syncthreads();
  }
  // the rows the forward wrote pass no cotangent on to ys_init
  if (a.sv.n) {
    const int curf = a.sv.cursors[1];
    for (int chunk = 0; chunk < w.chunks; ++chunk) {
      const WalkTile tl = walk_tile(w, B, D, chunk);
      for (int r = cur0; r < curf; ++r)
        for (int e = threadIdx.x; e < tl.rows * tl.cols; e += kThreads) {
          const int rr = e / tl.cols, c = e - rr * tl.cols;
          a.sv.ys[(size_t)r * BD + (size_t)(tl.row0 + rr) * D + tl.d0 + c] = 0.0f;
        }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) chain_finish(ch, a.ct_scalars, tdir);
}

}  // namespace
