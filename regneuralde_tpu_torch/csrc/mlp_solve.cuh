// K3 for MLPDynamics on Hopper: the whole forward solve, each stage's two
// contractions split over the whole grid, on the tiles of K4's reverse
// walk. Included by whole_solve.cu only, after the scalar code the forwards
// share (fwd_begin, fwd_decide, fwd_end, hermite_at, FwdArgs, MlpDyn);
// mlp_walk.cuh, included after it, builds on its tile toolkit (the first
// part below) and runs its stage phases in its replay.
//
// Replaces the TPU kernel
//   K3: regneuralde_tpu/ops/pallas_solve.py make_whole_solve.make_fwd_kernel
//       for MLPDynamics, whose trial step is ops/pallas_mlp.py
//       make_normed_algebra_fwd_res
// and, on this card, the forward over 4-row tiles (whole_solve_fwd_kernel
// with normed_fwd_tile, 128 tiles at 512x784x100) that read all of W1 and
// W2 from L2 once per tile per stage: ~485 MB a trial step, 9.8-10.1 ms a
// solve, 21x its bound (H100 80GB HBM3 at 700 W).
//
// What bounds it on this card. A trial step is 12 contractions of B x D x H
// (24 B D H f32 operations, 0.96 GFLOP at 512x784x100: 14 us at the 67
// TFLOP/s f32 rate), in a chain: stage i's input needs k_{i-1} of its row,
// and k_i needs the hidden layer of its row, which sums over every column.
// Against that stand the grid-wide barriers of each stage, the latency of
// each phase's round trips to L2, and the stage residuals streamed out
// (~11 MB a trial step at the flagship).
//
// What the design does about it.
//   * The grid is one block a tile of R rows x C columns of the batch's
//     B x D elements, on the reverse walk's plan (ops/whole_solve.py
//     walk_plan: 32 x 100, 128 tiles at the flagship; a batch that does not
//     fit the grid is solved in row chunks, one after another, within each
//     trial step), so K4's replay recomputes a trial step on the tiles K3
//     streamed it from. Each block keeps its tile's state for the trial
//     step in shared memory: y, k1..k7 and the stage input (kSolveState
//     floats an element), column-major, 4-row groups permuted by walk_at.
//     y and k1 come from the history rows hy[i], hf[i] each trial step.
//   * The load: y and k1 of the tile, and stage 1's input y_1 = y + dt
//     a_11 k1 (stage_state, pinned).
//   * Phase A: the tile's partial of y_i W1x^T over its own C columns,
//     R x H on 4 x 4 register tiles, the rows of W1x^T streaming through
//     shared memory in 16-byte cp.async slabs from a zero-padded transposed
//     copy (w1p); stored through L2. grid.sync().
//   * The reduction: each block takes its share of its row block's rows
//     (r = db, db + ndb, ...), sums the row block's partials in column-block
//     order, adds t_i w1t and b1 and takes tanh: the row block's hidden
//     rows, through L2, and the hs stream. grid.sync().
//   * Phase B: the row block's hidden rows into shared memory, then k_i =
//     tanh(hid W2h^T + t_i w2t + b2) over the tile's columns on register
//     tiles (W2h^T from its padded copy w2p), into the state and the ks
//     stream; the thread that holds 4 x 4 of them forms their next stage
//     input y_{i+1} = y + dt sum_j a_{i+1,j} k_j (stage_state, pinned), so
//     the next phase A follows after a block barrier. Each phase issues the
//     next phase's first slabs before its own tail, so the pipeline fills
//     behind the barrier.
//   So W1 and W2 are each read once per row block a stage (~40 MB a trial
//   step at the flagship, from L2), not once per 4-row tile.
//   * After stage 6, per tile, the norm sums, and the rows of y_new and k7
//     into hy[i+1], hf[i+1]; every block's sums to its slot, one grid.sync(),
//     and every block sums the slots in tile order and runs the controller
//     redundantly (fwd_decide, as whole_solve_fwd_kernel); then each block
//     writes its tiles' copy of a rejected step or Hermite rows.
//   * The stage residuals go out with evict-first stores: K4 reads them once.
//   * The stage phases are templates over a time policy (below) and read
//     times only through it, a row or a 4-row group at a time: the solve's,
//     K13's, K1's, and K4's, K2's and K14's replays give every row the
//     step's t and dt, K11's stages and K12's replay each row its own.
//   * And over a rounding policy (below): F32, the contractions as f32
//     fmaf chains (every instance but one), or F64, K11's, whose plain
//     version decides each lane's accept: the two contractions in f64 on
//     operands converted once, each affine map rounded once to f32, the
//     stage inputs formed op by op as the plain version's ATen ops.
// IEEE FMAs, no TF32, no fast math, no atomics: every sum has a fixed
// order, so runs are bitwise reproducible. The stage's arithmetic outside
// the contractions' fma chains is pinned (explicit roundings), so K4's
// replay of it, another kernel, gives the same bits.

#pragma once

namespace {

// ---------------------------------------------------------------------------
// The tile toolkit of the MLPDynamics whole solve (K3 here, K4 in
// mlp_walk.cuh): register-tiled contractions over weight slabs streamed
// through shared memory, on column-major tiles of the batch.
// ---------------------------------------------------------------------------

constexpr int kWalkTM = 4;       // rows of a thread's register tile
constexpr int kWalkTN = 4;       // its columns; tile widths are a multiple
constexpr int kWalkKB = 8;       // operand rows in a slab
constexpr int kWalkStages = 4;   // slabs in flight

__host__ __device__ inline int walk_round_up(int x, int m) { return (x + m - 1) / m * m; }

// One block's tile in one row chunk of a plan P (its R, C, nrb, ndb): rows
// [row0, row0 + rows) (rows may be 0 in the last chunk) and columns [d0,
// d0 + cols) of the batch.
struct WalkTile {
  int row0, rows, d0, cols, rb, db;
};

template <class P>
__device__ __forceinline__ WalkTile walk_tile(const P& w, int B, int D, int chunk) {
  WalkTile t;
  t.rb = blockIdx.x / w.ndb;
  t.db = blockIdx.x - t.rb * w.ndb;
  t.row0 = (chunk * w.nrb + t.rb) * w.R;
  t.rows = max(0, min(w.R, B - t.row0));
  t.d0 = t.db * w.C;
  t.cols = max(0, min(w.C, D - t.d0));
  return t;
}

// The offset of rows [4g, 4g + 4) of column c in a column-major array of R
// rows: the 4-row groups of a column are XOR-permuted by the column, so a
// quarter warp on 8 consecutive columns (or on the 8 groups of one column)
// meets 8 distinct banks.
__device__ __forceinline__ int walk_at(int c, int g, int R) {
  return c * R + 4 * (g ^ (c & (R / 4 - 1)));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float4 add4(float4 a, float4 b) {  // a + b, per lane
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 axpy4(float a, float4 x, float4 y) {  // y + a x, per lane
  return make_float4(y.x + a * x.x, y.y + a * x.y, y.z + a * x.z, y.w + a * x.w);
}
__device__ __forceinline__ float4 axpy4(float4 a, float4 x, float4 y) {  // y + a x, per lane
  return make_float4(y.x + a.x * x.x, y.y + a.y * x.y, y.z + a.z * x.z, y.w + a.w * x.w);
}
__device__ __forceinline__ float& comp(float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Four doubles (the F64 rounding policy's operands), moved as two 16-byte
// halves; st4 of a float4 to doubles widens each lane.
struct Dbl4 {
  double x, y, z, w;
};
__device__ __forceinline__ Dbl4 ld4(const double* p) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  return {a.x, a.y, b.x, b.y};
}
__device__ __forceinline__ void st4(double* p, float4 v) {
  *reinterpret_cast<double2*>(p) = make_double2(v.x, v.y);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v.z, v.w);
}

// Four values of a register tile's row to p through L2.
__device__ __forceinline__ void stcg4(float* p, const float (&v)[4]) {
  __stcg(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void stcg4(double* p, const double (&v)[4]) {
  __stcg(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  __stcg(reinterpret_cast<double2*>(p + 2), make_double2(v[2], v[3]));
}

__device__ __forceinline__ float fma_of(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_of(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }


// A 16-byte copy from global to shared memory, zero-filled (nothing read)
// where ok is false.
__device__ __forceinline__ void walk_cp16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void walk_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void walk_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Slab p of a run of `rows` rows of `width` floats (a multiple of 4),
// contiguous from src: rows [p kWalkKB, +kWalkKB), zero past the run.
__device__ __forceinline__ void slab_rows(float* dst, const float* src, int width, int rows,
                                          int p) {
  const float* from = src + (size_t)p * kWalkKB * width;
  const int valid = (rows - p * kWalkKB) * width;  // floats of the run's rows
  for (int e = 4 * threadIdx.x; e < kWalkKB * width; e += 4 * kThreads)
    walk_cp16(dst + e, e < valid ? from + e : src, e < valid);
}

// Slab p of a matrix of `rows` rows at a row stride of `stride` floats: rows
// [p kWalkKB, +kWalkKB), C floats (a multiple of 4) of each from column d0,
// zero past the rows. (kk, c4): this thread's first copy, a row of the slab
// and a float4 of it.
__device__ __forceinline__ void slab_cols(float* dst, const float* src, size_t stride, int d0,
                                          int C, int rows, int kk, int c4, int p) {
  const int quads = C / 4;
  for (int e = threadIdx.x; e < kWalkKB * quads; e += kThreads) {
    const int h = p * kWalkKB + kk;
    const bool ok = h < rows;
    walk_cp16(dst + 4 * e, ok ? src + h * stride + d0 + 4 * c4 : src, ok);
    c4 += kThreads % quads;  // the next copy of this thread
    kk += kThreads / quads + (c4 >= quads);
    if (c4 >= quads) c4 -= quads;
  }
}

// The first kWalkStages - 1 slabs of a phase, issued ahead of it.
template <class Load>
__device__ __forceinline__ void walk_prefetch(int nslab, Load load) {
#pragma unroll
  for (int p = 0; p < kWalkStages - 1; ++p) {
    if (p < nslab) load(p);
    walk_commit();
  }
}

// acc[i][u] += sum_k a(k)[i] b(k)[u] over nslab slabs of kWalkKB rows k: a(k)
// 4 rows of the shared operand, b(slot, kk) 4 columns of row kk of the slab
// in ring slot `slot` (a float4, or a Dbl4 where acc holds doubles), in k
// order, one fma a term in acc's type. The first kWalkStages - 1 slabs are
// in flight already.
template <class T, class Load, class A, class Bv>
__device__ __forceinline__ void walk_gemm(T (&acc)[kWalkTM][kWalkTN], bool live, int nslab,
                                          Load load, A a, Bv b) {
  for (int kt = 0; kt < nslab; ++kt) {
    walk_wait<kWalkStages - 2>();  // slab kt has landed
    __syncthreads();               // and every thread is done with slab kt - 1
    if (kt + kWalkStages - 1 < nslab) load(kt + kWalkStages - 1);
    walk_commit();
    if (live) {
#pragma unroll
      for (int kk = 0; kk < kWalkKB; ++kk) {
        const auto av = a(kt * kWalkKB + kk);
        const auto bv = b(kt % kWalkStages, kk);
        const T ar[4] = {av.x, av.y, av.z, av.w};
        const T br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < kWalkTM; ++i)
#pragma unroll
          for (int u = 0; u < kWalkTN; ++u) acc[i][u] = fma_of(ar[i], br[u], acc[i][u]);
      }
    }
  }
  walk_wait<0>();
  __syncthreads();  // the slab ring is free again
}

// Calls f(gi) for each element of a tile, gi its offset in a B x D array,
// consecutive threads on consecutive columns.
template <class F>
__device__ __forceinline__ void for_tile(const WalkTile& tl, int D, F f) {
  for (int e = threadIdx.x; e < tl.rows * tl.cols; e += kThreads) {
    const int r = e / tl.cols, c = e - r * tl.cols;
    f((size_t)(tl.row0 + r) * D + tl.d0 + c);
  }
}

// ---------------------------------------------------------------------------
// The time policies of a trial step's phases: how a row's t and dt are read
// (t_row, dt_row; dtv, a 4-row group's dt). StepTime (K3, K4, K13, K2, K14):
// every row at the step's t and dt, and dtv a float. LaneTime (K12, the
// per-sample engine's step): row r of the batch at t[r] and dt[r], device
// arrays of B floats; load stages the current tile's rows in the block's
// LaneRows (in the walk's dynamic shared memory, mlp_walk.cuh walk_smem)
// before its stages and before its walk, and dtv is a float4. Where the
// walk sums the time terms of (ct_t, ct_dt) it asks the policy too
// (mlp_walk.cuh).
// ---------------------------------------------------------------------------

constexpr int kLaneRows = 32;  // the most rows a tile has (ops/whole_solve.py WALK_ROWS)

// The shared rows of a LaneTime step: the tile's times and, for the rows
// this block reduces in the walk (rows db + k ndb), a stage's time-column
// term of ct_ti, the row's ct_t and the time terms of its ct_dt.
struct __align__(16) LaneRows {
  float t[kLaneRows], dt[kLaneRows], vt[kLaneRows], ct[kLaneRows], cdt[kLaneRows];
};
constexpr int kLaneRowFloats = sizeof(LaneRows) / sizeof(float);

// Stage I's time, each operation rounded on its own.
template <int I>
__device__ __forceinline__ float stage_ti(float t, float dt) {
  return __fadd_rn(t, __fmul_rn(kC[I], dt));
}

struct StepTime {
  static constexpr bool kLanes = false;
  float t, dt;
  __device__ __forceinline__ void load(const WalkTile&) const {}
  __device__ __forceinline__ float dtv(int) const { return dt; }
  __device__ __forceinline__ float t_row(int) const { return t; }
  __device__ __forceinline__ float dt_row(int) const { return dt; }
};

struct LaneTime {
  static constexpr bool kLanes = true;
  const float *t, *dt;  // B floats each, on the device
  LaneRows* rows;       // the block's, in its shared memory
  // the tile's rows' times (zero past the batch) into rows, and the reduced
  // rows' sums to zero, between two block barriers
  __device__ __forceinline__ void load(const WalkTile& tl) const {
    __syncthreads();  // every read of the last tile's rows is done
    if (threadIdx.x < kLaneRows) {
      const int r = threadIdx.x;
      const bool ok = r < tl.rows;
      rows->t[r] = ok ? __ldg(t + tl.row0 + r) : 0.0f;
      rows->dt[r] = ok ? __ldg(dt + tl.row0 + r) : 0.0f;
      rows->ct[r] = 0.0f;
      rows->cdt[r] = 0.0f;
    }
    __syncthreads();
  }
  __device__ __forceinline__ float4 dtv(int g) const { return ld4(rows->dt + 4 * g); }
  __device__ __forceinline__ float t_row(int r) const { return rows->t[r]; }
  __device__ __forceinline__ float dt_row(int r) const { return rows->dt[r]; }
};

// dtv times a constant, per lane.
__device__ __forceinline__ float times(float a, float b) { return a * b; }
__device__ __forceinline__ float4 times(float4 a, float b) {
  return make_float4(a.x * b, a.y * b, a.z * b, a.w * b);
}

// Lane q of a 4-row group's value: the value itself when all rows share it.
__device__ __forceinline__ float lane_of(float v, int) { return v; }
__device__ __forceinline__ float lane_of(float4 v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}
__device__ __forceinline__ double lane_of(Dbl4 v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// The rounding policies of a trial step's stages: T, the type of the two
// contractions' operands and sums (the stage input, the hidden rows, the
// padded weights, the slab ring and phase A's partials); act, an affine
// map's sum, time and bias terms to its activation; input, stage I's input
// y + dt acc_I of one element.
//   F32 (K3, K13, K1, and the replays of the stages in K4, K2, K14 and K12):
//     f32 fmaf chains, the time and bias terms added by rounded ops, the
//     input by stage_state's pinned fma chain.
//   F64 (K11, the per-sample engine's step, whose plain version
//     ops/fused_mlp_lanes.py _reference_sweep_lanes decides each lane's
//     accept at its error norm's float32 floor): the contractions in f64,
//     their operands converted once (the stage input when it is formed, the
//     hidden rows when they are reduced, the weights when they are padded),
//     and sum + fma(t_i, w_t, b) in f64 rounded once to f32: the product of
//     two floats is exact in f64, so this is the plain version's f64 addmm
//     up to the order of an f64 sum; the input with every multiply and add
//     rounded on its own, in fused_mlp._stage_acc's order, as ATen's ops.
// ---------------------------------------------------------------------------

// A bias given as its value, or as a function that reads it where act adds
// it: the reduction passes the read, so F32's PTX keeps the bias's address
// and load after the time term, where K3's expression has always had them.
__device__ __forceinline__ float bias_of(float b) { return b; }
template <class F>
__device__ __forceinline__ float bias_of(F read) {
  return read();
}

struct F32 {
  using T = float;
  template <class B>
  static __device__ __forceinline__ float act(float v, float ti, float wt, B b) {
    return accurate_tanh(__fadd_rn(__fadd_rn(v, __fmul_rn(ti, wt)), bias_of(b)));
  }
  template <int I>
  static __device__ __forceinline__ float input(float y, const float* k, float dt) {
    return stage_state(I, &y, k, 1, 0, dt);
  }
};

struct F64 {
  using T = double;
  template <class B>
  static __device__ __forceinline__ float act(double v, float ti, float wt, B b) {
    return accurate_tanh(__double2float_rn(
        __dadd_rn(v, __fma_rn((double)ti, (double)wt, (double)bias_of(b)))));
  }
  template <int I>
  static __device__ __forceinline__ float input(float y, const float* k, float dt) {
    float acc = __fmul_rn(kA[I - 1][0], k[0]);
#pragma unroll
    for (int j = 1; j < I; ++j) acc = __fadd_rn(acc, __fmul_rn(kA[I - 1][j], k[j]));
    return __fadd_rn(y, __fmul_rn(dt, acc));
  }
};

// Floats of one element of a policy's T.
template <class Rnd>
constexpr int rnd_floats = sizeof(typename Rnd::T) / sizeof(float);

// ---------------------------------------------------------------------------
// K3's stages.
// ---------------------------------------------------------------------------

constexpr int kSolveState = 9;  // floats of state an element: y, k1..k7, the stage input

// The forward's tiles (walk_plan's) and its scratch: phase A's partials
// (tiles x R x HP4, HP4 = H rounded to kWalkTN), the row blocks' hidden
// rows (nrb x H x R), the padded transposed
// weights w1p (ndb C rows of HP4: W1x^T, zero past D and H) and w2p
// (H rows of ndb C: W2h^T, zero past D), all in the rounding policy's T,
// and the per-tile slots of the norm sums (2 x tiles x 3 floats, by
// trial-step parity).
template <class Rnd>
struct SolveT {
  typename Rnd::T *psum, *hid, *w1p, *w2p;
  float* slots;
  int R, C, nrb, ndb, chunks;
};
using Solve = SolveT<F32>;

template <class Rnd = F32>
__host__ __device__ inline size_t solve_scratch_floats(int R, int C, int nrb, int ndb, int H) {
  const size_t tiles = (size_t)nrb * ndb, HP4 = walk_round_up(H, kWalkTN);
  const size_t width = (size_t)ndb * C;
  return rnd_floats<Rnd> * (tiles * R * HP4 + (size_t)nrb * H * R + width * HP4 +
                            (size_t)H * width) +
         2 * tiles * 3;
}

// The plan's Solve over a scratch of solve_scratch_floats<Rnd> floats (each
// part a multiple of 4 floats, so every part stays 16-byte aligned).
template <class Rnd = F32>
__host__ __device__ inline SolveT<Rnd> solve_carve(float* scratch, int R, int C, int nrb,
                                                   int ndb, int chunks, int H) {
  const size_t tiles = (size_t)nrb * ndb, HP4 = walk_round_up(H, kWalkTN);
  const size_t width = (size_t)ndb * C;
  SolveT<Rnd> f;
  f.psum = reinterpret_cast<typename Rnd::T*>(scratch);
  f.hid = f.psum + tiles * R * HP4;
  f.w1p = f.hid + (size_t)nrb * H * R;
  f.w2p = f.w1p + width * HP4;
  f.slots = reinterpret_cast<float*>(f.w2p + (size_t)H * width);
  f.R = R;
  f.C = C;
  f.nrb = nrb;
  f.ndb = ndb;
  f.chunks = chunks;
  return f;
}

// Floats of K3's shared memory for tiles of R x C: the state (y, k1..k7),
// the stage input (C rounded to a slab, x R), the row block's hidden rows
// (H rounded to a slab, x R), the slab ring (rows of HP4 or C), the last
// three in the rounding policy's T, the block sum's scratch and, for a
// LaneTime step (lanes), the tile's LaneRows.
template <class Rnd = F32>
__host__ __device__ inline size_t solve_smem_floats(int R, int C, int H, bool lanes = false) {
  const int HP4 = walk_round_up(H, kWalkTN);
  const int slab = HP4 > C ? HP4 : C;
  constexpr int w = rnd_floats<Rnd>;
  return (size_t)R * ((size_t)(kSolveState - 1) * C + w * walk_round_up(C, kWalkKB) +
                      w * walk_round_up(H, kWalkKB)) +
         (size_t)w * kWalkStages * kWalkKB * slab + 3 * kWarps + (lanes ? kLaneRowFloats : 0);
}

template <class Rnd>
struct SolveSmemT {
  float* st;              // y, k1..k7: 8 x C x R, column-major, groups permuted (walk_at)
  typename Rnd::T* yi;    // (C rounded to a slab) x R: the stage input, as st; zero past C
  typename Rnd::T* hid;   // (H rounded to a slab) x R: the row block's hidden rows, [h][r]
  typename Rnd::T* slab;  // kWalkStages slabs of SS
  float* red;             // 3 x kWarps
  int RC, SS, HP4;
};
using SolveSmem = SolveSmemT<F32>;

template <class Rnd>
__device__ __forceinline__ SolveSmemT<Rnd> solve_smem(float* pool, const SolveT<Rnd>& f,
                                                      int H) {
  SolveSmemT<Rnd> s;
  s.RC = f.R * f.C;
  s.HP4 = walk_round_up(H, kWalkTN);
  s.SS = kWalkKB * (s.HP4 > f.C ? s.HP4 : f.C);
  s.st = pool;
  s.yi = reinterpret_cast<typename Rnd::T*>(s.st + (size_t)(kSolveState - 1) * s.RC);
  s.hid = s.yi + (size_t)walk_round_up(f.C, kWalkKB) * f.R;
  s.slab = s.hid + (size_t)walk_round_up(H, kWalkKB) * f.R;
  s.red = reinterpret_cast<float*>(s.slab + (size_t)kWalkStages * s.SS);
  return s;
}

// A LaneTime step's rows in K3's pool: after the block sum's scratch, 16-byte
// aligned (every part before is a multiple of 4 floats, the scratch 24).
template <class Rnd>
__device__ __forceinline__ LaneRows* solve_lane_rows(const SolveSmemT<Rnd>& s) {
  return reinterpret_cast<LaneRows*>(s.red + 3 * kWarps);
}

// The padded transposed copies of the weights the slabs are cut from, in
// the policy's T (every block a share; the caller syncs the grid).
template <class Rnd>
__device__ void solve_pad_weights(const float* W1, const float* W2, const SolveT<Rnd>& f,
                                  int D, int H, int HP4) {
  using T = typename Rnd::T;
  const size_t width = (size_t)f.ndb * f.C;
  const size_t n1 = width * HP4, n2 = (size_t)H * width;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < n1 + n2;
       e += (size_t)gridDim.x * kThreads) {
    if (e < n1) {
      const size_t d = e / HP4, h = e - d * HP4;
      f.w1p[e] = d < (size_t)D && h < (size_t)H ? (T)W1[h * (D + 1) + d] : T(0);
    } else {
      const size_t h = (e - n1) / width, d = (e - n1) - h * width;
      f.w2p[e - n1] = d < (size_t)D ? (T)W2[d * (H + 1) + h] : T(0);
    }
  }
}

// One trial step as the phases see it: its start rows (hy[i], hf[i]), its
// rows of the stage residuals (6 x B x D, 6 x B x H; null without OUT), and
// its time policy (K3's: t and dt_eff).
template <class Time>
struct SolveStep {
  const float *y, *k1;
  float *ks, *hs;
  Time tm;
};

// Slab p of phase A's weights: the tile's C rows of w1p.
template <class Rnd>
__device__ __forceinline__ void solve_load_w1(const SolveT<Rnd>& f, const SolveSmemT<Rnd>& s,
                                              const WalkTile& tl, int p) {
  slab_rows(reinterpret_cast<float*>(s.slab + (p % kWalkStages) * s.SS),
            reinterpret_cast<const float*>(f.w1p + (size_t)tl.d0 * s.HP4),
            rnd_floats<Rnd> * s.HP4, f.C, p);
}

// Slab p of phase B's weights: rows of w2p at the tile's C columns. (kk, c4)
// as slab_cols, over rows of rnd_floats<Rnd> C floats.
template <class Rnd>
__device__ __forceinline__ void solve_load_w2(const SolveT<Rnd>& f, const SolveSmemT<Rnd>& s,
                                              const WalkTile& tl, int H, int kk, int c4,
                                              int p) {
  constexpr int w = rnd_floats<Rnd>;
  slab_cols(reinterpret_cast<float*>(s.slab + (p % kWalkStages) * s.SS),
            reinterpret_cast<const float*>(f.w2p), w * (size_t)f.ndb * f.C, w * tl.d0, w * f.C,
            H, kk, c4, p);
}


// Stage I's input at 4 rows of one column (offset off of the state): y +
// dt sum_j a_Ij k_j by the rounding policy, k_0..k_{I-2} from the state and
// k_{I-1} given (kl); dt the rows' (a float4) or the step's (a float).
template <int I, class Rnd, class DT>
__device__ __forceinline__ float4 solve_input(const SolveSmemT<Rnd>& s, int off, float4 kl,
                                              DT dt) {
  float4 kv[I];
#pragma unroll
  for (int j = 0; j + 1 < I; ++j) kv[j] = ld4(s.st + (1 + j) * s.RC + off);
  kv[I - 1] = kl;
  float4 yv = ld4(s.st + off), yi;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float y = comp(yv, q);
    float k[I];
#pragma unroll
    for (int j = 0; j < I; ++j) k[j] = comp(kv[j], q);
    comp(yi, q) = Rnd::template input<I>(y, k, lane_of(dt, q));
  }
  return yi;
}

// The load of the tile (items: 4 rows of a column, consecutive threads on
// consecutive columns): y and k1 (zero outside the tile) into the state,
// stage 1's input into s.yi.
template <class Time, class Rnd>
__device__ __forceinline__ void solve_load(const SolveStep<Time>& ss, const SolveSmemT<Rnd>& s,
                                           const WalkTile& tl, int R, int C, int D) {
  const int n = C * (R / 4);
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int c = e % C, g = e / C, off = walk_at(c, g, R);
    float4 yv, kv;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 4 * g + q;
      const bool ok = r < tl.rows && c < tl.cols;
      const size_t gi = (size_t)(tl.row0 + r) * D + tl.d0 + c;
      comp(yv, q) = ok ? __ldcg(ss.y + gi) : 0.0f;
      comp(kv, q) = ok ? __ldcg(ss.k1 + gi) : 0.0f;
    }
    st4(s.st + off, yv);
    st4(s.st + s.RC + off, kv);
    st4(s.yi + off, solve_input<1>(s, off, kv, ss.tm.dtv(g)));
  }
}

// Phase A: this tile's partial of y_I W1x^T over its columns, R x HP4, to
// out ([R][HP4], through L2); then phase B's first slabs, behind the barrier.
template <class Rnd>
__device__ __forceinline__ void solve_phase_a(const SolveT<Rnd>& f, const SolveSmemT<Rnd>& s,
                                              const WalkTile& tl, int H,
                                              typename Rnd::T* out) {
  const int R = f.R, C = f.C, G4 = R / 4;
  const int items = G4 * (s.HP4 / 4);
  const int nslab = (tl.cols + kWalkKB - 1) / kWalkKB;
  auto load = [&](int p) { solve_load_w1(f, s, tl, p); };
  for (int base = 0; base < items; base += kThreads) {
    const int item = base + threadIdx.x;
    const int g = item % G4, hg = item / G4;
    typename Rnd::T acc[kWalkTM][kWalkTN] = {};
    if (base > 0) walk_prefetch(nslab, load);
    walk_gemm(acc, item < items, nslab, load,
              [&](int k) { return ld4(s.yi + walk_at(k, g, R)); },
              [&](int slot, int kk) {
                return ld4(s.slab + slot * s.SS + kk * s.HP4 + 4 * hg);
              });
    if (item < items) {
#pragma unroll
      for (int i = 0; i < kWalkTM; ++i)
        stcg4(out + (size_t)(4 * g + i) * s.HP4 + 4 * hg, acc[i]);
    }
  }
  const int quads = rnd_floats<Rnd> * C / 4;
  const int kk0 = threadIdx.x / quads, c40 = threadIdx.x % quads;
  walk_prefetch((H + kWalkKB - 1) / kWalkKB,
                [&](int p) { solve_load_w2(f, s, tl, H, kk0, c40, p); });
}

// The reduction of stage I: the hidden rows hid = act(sum_q psum_q, t_I,
// w1t, b1) of this block's share of its row block's rows (r = db, db +
// ndb, ...), the row block's partials (psum, [R][HP4] each) summed in
// column-block order in the policy's T; to hidg ([h][r], the row block's
// hidden rows, through L2) and, with OUT, to the hs stream. Items (row, h),
// consecutive threads on consecutive h, two a thread, the partials loaded Q
// at a time before they are summed (an add waiting on each load made them
// ndb round trips to L2 one after another). Every block reducing all of its
// row block's rows, one barrier a stage, took K3 from 5.65 to 8.05 ms
// (512x784x100, H100).
template <int I, bool OUT, class M, class Time, class Rnd>
__device__ __forceinline__ void solve_reduce(const M& m, const SolveT<Rnd>& f,
                                             const SolveStep<Time>& ss, const WalkTile& tl,
                                             const typename Rnd::T* psum,
                                             typename Rnd::T* hidg, int HP4, int B, int D) {
  using T = typename Rnd::T;
  const int H = m.H, R = f.R;
  const Time tm = ss.tm;
  const size_t PT = (size_t)R * HP4;  // elements of one tile's partial
  const int n = (R - tl.db + f.ndb - 1) / f.ndb * H;
  constexpr int U = 2, Q = 8;
  for (int e0 = threadIdx.x; e0 < n; e0 += U * kThreads) {
    T v[U] = {};
    for (int q0 = 0; q0 < f.ndb; q0 += Q) {
      T p[Q][U];
#pragma unroll
      for (int j = 0; j < Q; ++j)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u * kThreads, k = e / H, h = e - k * H;
          p[j][u] = e < n && q0 + j < f.ndb
                        ? __ldcg(psum + (q0 + j) * PT + (size_t)(tl.db + k * f.ndb) * HP4 + h)
                        : T(0);
        }
#pragma unroll
      for (int j = 0; j < Q; ++j)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (q0 + j < f.ndb) v[u] = add_rn(v[u], p[j][u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * kThreads, k = e / H, h = e - k * H, r = tl.db + k * f.ndb;
      if (e >= n) continue;
      const float w1t = __ldg(m.W1 + (size_t)h * (D + 1) + D);
      const float ti = stage_ti<I>(tm.t_row(r), tm.dt_row(r));
      const float hv = Rnd::act(v[u], ti, w1t, [&] { return __ldg(m.b1 + h); });
      hidg[(size_t)h * R + r] = hv;
      if (OUT && r < tl.rows) __stcs(ss.hs + ((size_t)(I - 1) * B + tl.row0 + r) * H + h, hv);
    }
  }
}

// Phase B of stage I: the row block's hidden rows (hidg, [H][R]) into shared
// memory, then k_I = act(hid W2h^T, t_I, w2t, b2) over this tile's columns
// into the state and, with OUT, its rows to the ks stream; below stage 6
// the next phase A's first slabs, and the next stage's input (solve_input)
// of the elements each thread computed.
template <int I, bool OUT, class M, class Time, class Rnd>
__device__ __forceinline__ void solve_phase_b(const M& m, const SolveT<Rnd>& f,
                                              const SolveStep<Time>& ss,
                                              const SolveSmemT<Rnd>& s, const WalkTile& tl,
                                              const typename Rnd::T* hidg, int B, int D) {
  const int H = m.H, R = f.R, C = f.C, G4 = R / 4;
  // all in flight at once
  for (int e = 4 * threadIdx.x; e < rnd_floats<Rnd> * H * R; e += 4 * kThreads)
    walk_cp16(reinterpret_cast<float*>(s.hid) + e, reinterpret_cast<const float*>(hidg) + e,
              true);
  walk_commit();
  walk_wait<0>();  // and every slab issued before
  for (int e = H * R + threadIdx.x; e < walk_round_up(H, kWalkKB) * R; e += kThreads)
    s.hid[e] = 0;
  __syncthreads();

  const Time tm = ss.tm;
  const int items = G4 * (C / 4);
  const int nslab = (H + kWalkKB - 1) / kWalkKB;
  const int quads = rnd_floats<Rnd> * C / 4;
  const int kk0 = threadIdx.x / quads, c40 = threadIdx.x % quads;
  auto load = [&](int p) { solve_load_w2(f, s, tl, H, kk0, c40, p); };
  for (int base = 0; base < items; base += kThreads) {
    const int item = base + threadIdx.x;
    const int g = item % G4, cg = item / G4;
    typename Rnd::T acc[kWalkTM][kWalkTN] = {};
    if (base > 0) walk_prefetch(nslab, load);
    walk_gemm(acc, item < items, nslab, load,
              [&](int k) { return ld4(s.hid + k * R + 4 * g); },
              [&](int slot, int kk) { return ld4(s.slab + slot * s.SS + kk * C + 4 * cg); });
    if (I < 6 && base + kThreads >= items)  // phase A(I+1)'s first slabs
      walk_prefetch((tl.cols + kWalkKB - 1) / kWalkKB,
                    [&](int p) { solve_load_w1(f, s, tl, p); });
    if (item >= items) continue;
    float4 ti;  // t_I of the item's rows
#pragma unroll
    for (int i = 0; i < kWalkTM; ++i)
      comp(ti, i) = stage_ti<I>(tm.t_row(4 * g + i), tm.dt_row(4 * g + i));
#pragma unroll
    for (int u = 0; u < kWalkTN; ++u) {
      const int c = 4 * cg + u;
      const bool in = c < tl.cols;
      const size_t d = (size_t)tl.d0 + c;
      const float w2t = in ? __ldg(m.W2 + d * (H + 1) + H) : 0.0f;
      const float b = in ? __ldg(m.b2 + d) : 0.0f;
      float4 k;
#pragma unroll
      for (int i = 0; i < kWalkTM; ++i) comp(k, i) = Rnd::act(acc[i][u], comp(ti, i), w2t, b);
      const int off = walk_at(c, g, R);
      st4(s.st + (1 + I) * s.RC + off, k);  // ks[I] = k_{I+1}
      if constexpr (OUT) {
#pragma unroll
        for (int i = 0; i < kWalkTM; ++i)
          if (4 * g + i < tl.rows && in)
            __stcs(ss.ks + ((size_t)(I - 1) * B + tl.row0 + 4 * g + i) * D + d, comp(k, i));
      }
      if constexpr (I < 6) st4(s.yi + off, solve_input<I + 1>(s, off, k, tm.dtv(g)));
    }
  }
}

// One stage: phase A, the barrier, the reduction, the barrier, phase B.
// Each block's next phase A comes after the second barrier, so every
// partial it overwrites has been read.
template <int I, bool OUT, class M, class Time, class Rnd>
__device__ __forceinline__ void solve_stage(const M& m, const SolveT<Rnd>& f,
                                            cg::grid_group& grid, const SolveStep<Time>& ss,
                                            const SolveSmemT<Rnd>& s, const WalkTile& tl, int B,
                                            int D) {
  const size_t pstride = (size_t)s.HP4 * f.R;
  typename Rnd::T* hidg = f.hid + (size_t)tl.rb * m.H * f.R;
  __syncthreads();  // the stage input is complete
  solve_phase_a(f, s, tl, m.H, f.psum + blockIdx.x * pstride);
  grid.sync();
  solve_reduce<I, OUT>(m, f, ss, tl, f.psum + (size_t)tl.rb * f.ndb * pstride, hidg, s.HP4,
                       B, D);
  grid.sync();
  solve_phase_b<I, OUT>(m, f, ss, s, tl, hidg, B, D);
}

// The six stages of one trial step on one tile: y, k1..k7 and the stage-6
// input (y_new) in shared memory after it; with OUT the rows of k2..k7 and
// of every stage's hidden layer streamed.
template <bool OUT, class M, class Time, class Rnd>
__device__ __forceinline__ void solve_stages(const M& m, const SolveT<Rnd>& f,
                                             cg::grid_group& grid, const SolveStep<Time>& ss,
                                             const SolveSmemT<Rnd>& s, const WalkTile& tl,
                                             int B, int D) {
  // the stage input's padding columns stay zero: phase A sums whole slabs
  for (int e = f.C * f.R + threadIdx.x; e < walk_round_up(f.C, kWalkKB) * f.R; e += kThreads)
    s.yi[e] = 0;
  walk_prefetch((tl.cols + kWalkKB - 1) / kWalkKB,
                [&](int p) { solve_load_w1(f, s, tl, p); });
  ss.tm.load(tl);
  __syncthreads();  // the last reads of the state (the caller's) are done
  solve_load(ss, s, tl, f.R, f.C, D);
  solve_stage<1, OUT>(m, f, grid, ss, s, tl, B, D);
  solve_stage<2, OUT>(m, f, grid, ss, s, tl, B, D);
  solve_stage<3, OUT>(m, f, grid, ss, s, tl, B, D);
  solve_stage<4, OUT>(m, f, grid, ss, s, tl, B, D);
  solve_stage<5, OUT>(m, f, grid, ss, s, tl, B, D);
  solve_stage<6, OUT>(m, f, grid, ss, s, tl, B, D);
  __syncthreads();  // the last phase B's state is complete
}

// After the stages: the tile's norm sums added to sums (err, num, den; the
// algebra of ops/fused_mlp.py _normed_outs, the stage-5 state rebuilt by
// stage_state) and its rows of y_new and k7 to yn, kn. K3's trial step and
// K1's tile end (mlp_step_solve.cuh NormedEnd).
__device__ __forceinline__ void solve_finish(const SolveStep<StepTime>& ss, const SolveSmem& s,
                                             const WalkTile& tl, int R, int C, int D,
                                             float rtol, float atol, float* yn, float* kn,
                                             float (&sums)[3]) {
  const int n = C * (R / 4);
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int c = e % C, g = e / C, off = walk_at(c, g, R);
    float4 kv[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) kv[j] = ld4(s.st + (1 + j) * s.RC + off);
    float4 yv = ld4(s.st + off), ynv = ld4(s.yi + off);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 4 * g + q;
      if (r >= tl.rows || c >= tl.cols) continue;
      const size_t row = (size_t)tl.row0 + r, gi = row * D + tl.d0 + c;
      float k[7];
#pragma unroll
      for (int j = 0; j < 7; ++j) k[j] = comp(kv[j], q);
      const float y = comp(yv, q), ynew = comp(ynv, q);
      const float g6 = stage_state(5, &y, k, 1, 0, ss.tm.dt);
      float s_comb = kBt[1] * (k[1] - k[0]);
#pragma unroll
      for (int j = 2; j <= 6; ++j) s_comb += kBt[j] * (k[j] - k[0]);
      const float err = ss.tm.dt * s_comb;
      const float denom = atol + fmaxf(fabsf(y), fabsf(ynew)) * rtol;
      const float sc = err / denom;
      sums[0] += sc * sc;
      const float dk = k[6] - k[5];
      sums[1] += dk * dk;
      const float dg = ynew - g6;
      sums[2] += dg * dg;
      yn[gi] = ynew;
      kn[gi] = k[6];
    }
  }
}

template <bool STREAM>
struct SolveArgs {
  FwdArgs<MlpDyn<STREAM>> a;
  Solve f;
};

// K3 for MLPDynamics: the whole forward solve, one block a tile
// (gridDim.x == nrb * ndb, all resident), streaming the stage residuals
// (STREAM) or not.
template <bool STREAM>
__global__ void __launch_bounds__(kThreads, 1) mlp_solve_kernel(SolveArgs<STREAM> args) {
  extern __shared__ __align__(16) float solve_pool[];
  __shared__ FwdState sc;
  cg::grid_group grid = cg::this_grid();
  const FwdArgs<MlpDyn<STREAM>>& a = args.a;
  const Solve& f = args.f;
  const MlpDyn<STREAM>& m = a.dyn;
  const int H = m.H, B = a.B, D = a.D;
  const int tiles = f.nrb * f.ndb;
  const size_t BD = (size_t)B * D;
  const float t0 = a.scalars[0], t1 = a.scalars[1];
  const float tdir = sign_of(t1 - t0), span = fabsf(t1 - t0);
  const float count = (float)BD;
  const SolveSmem s = solve_smem(solve_pool, f, H);
  solve_pad_weights(m.W1, m.W2, f, D, H, s.HP4);
  for (int chunk = 0; chunk < f.chunks; ++chunk)
    for_tile(walk_tile(f, B, D, chunk), D, [&](size_t gi) {
      a.hy[gi] = a.y0[gi];
      a.hf[gi] = a.f0[gi];
    });
  if (threadIdx.x == 0) fwd_begin(a, sc, span);
  grid.sync();

  int i = 0;
  for (; i < a.S && !sc.done; ++i) {
    const float t = sc.t, dt = sc.dt;
    const float remaining = t1 - t;
    const bool is_last = (dt - remaining) * tdir >= 0.0f;
    const float dt_eff = is_last ? remaining : dt;
    const float* yi = a.hy + (size_t)i * BD;
    const float* fi = a.hf + (size_t)i * BD;
    float* yn = a.hy + (size_t)(i + 1) * BD;
    float* kn = a.hf + (size_t)(i + 1) * BD;
    const SolveStep<StepTime> ss{yi, fi, STREAM ? m.ks + (size_t)i * 6 * BD : nullptr,
                                 STREAM ? m.hs + (size_t)i * 6 * B * H : nullptr, t, dt_eff};
    float sums[3] = {0.0f, 0.0f, 0.0f};
    for (int chunk = 0; chunk < f.chunks; ++chunk) {
      const WalkTile tl = walk_tile(f, B, D, chunk);
      solve_stages<STREAM>(m, f, grid, ss, s, tl, B, D);
      solve_finish(ss, s, tl, f.R, f.C, D, a.rtol, a.atol, yn, kn, sums);
    }
    float* slots = f.slots + (size_t)(i & 1) * tiles * 3;
    block_sum_to<3>(sums, s.red, slots + 3 * blockIdx.x);
    grid.sync();
    if (threadIdx.x < 32)
      fwd_decide(a, sc, slots, tiles, i, t, dt, dt_eff, is_last, t1, tdir, span, count);
    __syncthreads();
    const bool acc = sc.acc;
    const int lo = sc.lo, hi = sc.hi;
    for (int chunk = 0; chunk < f.chunks; ++chunk) {
      const WalkTile tl = walk_tile(f, B, D, chunk);
      if (!acc) {  // a rejected step keeps its start state
        for_tile(tl, D, [&](size_t gi) {
          yn[gi] = __ldcg(yi + gi);
          kn[gi] = __ldcg(fi + gi);
        });
      } else {
        for (int r = lo; r < hi; ++r) {
          const HermiteAt h = hermite_at(a.sv.sa[r], t, dt_eff);
          float* out = a.sv.ys + (size_t)r * BD;
          for_tile(tl, D, [&](size_t gi) {
            out[gi] = hermite_value(h, __ldcg(yi + gi), __ldcg(yn + gi), __ldcg(fi + gi),
                                    __ldcg(kn + gi));
          });
        }
      }
    }
    __syncthreads();
  }

  const float* y_end = a.hy + (size_t)i * BD;
  for (int chunk = 0; chunk < f.chunks; ++chunk)
    for_tile(walk_tile(f, B, D, chunk), D, [&](size_t gi) { a.y1[gi] = __ldcg(y_end + gi); });
  if (blockIdx.x == 0 && threadIdx.x == 0) fwd_end(a, sc);
}

}  // namespace
