// The whole adaptive Tsit5 solve on Hopper: one persistent cooperative
// kernel for the forward (K3) and one for the reverse walk (K4), generic
// over the dynamics' per-tile trial-step body: AlternatingMLP (K7's and
// K8's, altmlp_tsit5.cuh) or FFJORD's augmented CSL dynamics (K7-CSL's and
// K8-CSL's, csl_tsit5.cuh). MLPDynamics' forward and reverse walk are
// kernels of their own, mlp_solve.cuh and mlp_walk.cuh, which split each
// stage's contractions over the whole grid; they share the scalar code
// below (fwd_begin, fwd_decide, fwd_end, hermite_at, chain_begin,
// chain_end, chain_finish, hermite_elem). K2, K14 and K12, the backwards
// of the normed, the tuple and the lane-wise Tsit5 step (the fast adjoint
// solve's, odeint's generic engine's and the per-sample engine's), are one
// trial step of that walk (mlp_step_walk.cuh), and K13, K1 and K11, the
// tuple, the normed and the lane-wise step themselves, one trial step of
// K3's stages (mlp_step_solve.cuh), so they are built here too.
//
// Replaces the TPU kernels
//   K3: regneuralde_tpu/ops/pallas_solve.py  make_whole_solve.make_fwd_kernel
//   K4: regneuralde_tpu/ops/pallas_solve.py  make_whole_solve.make_bwd_kernel
//   K5: regneuralde_tpu/ops/pallas_solve.py  make_whole_solve_tiled.make_fwd_kernel
//   K6: regneuralde_tpu/ops/pallas_solve.py  make_whole_solve_tiled.make_bwd_kernel
// The TPU has two engines because its monolithic one keeps the whole
// batch's stage stacks in VMEM and the tiled one does not. Here the batch
// is always tiled across blocks, so one pair serves fused=True, "solve"
// and "tiled", with or without saveat.
//
// What bounds it on this card. Each trial step is the step kernel's
// (forward) or its reverse's (backward) work, latency-bound (see
// mlp_step_solve.cuh and altmlp_tsit5.cu), plus one grid-wide decision: the
// accept flag and the next dt hang on three norm sums over the whole
// batch. What the solve saves against one launch per trial step is the
// host: no launch, no flag read back, no scalar chain and no Hermite
// write or pullback on the host between trial steps.
//
// What the design does about it.
//   * Each block owns the same row tiles (tile = blockIdx.x + k*gridDim.x)
//     for the whole solve and runs the dynamics' per-tile body on them
//     (MLPDynamics: one tile of the batch's rows and columns a block). The
//     carry lives in global memory, in the history itself: hy[i], hf[i] is
//     the state at the start of trial step i, the tile body writes its
//     y_new, k7 into hy[i+1], hf[i+1], and a rejected step copies row i
//     over them. Only a tile's owner touches its rows.
//   * Per trial step each tile writes its partial sums to a per-tile slot
//     (K3-CSL's 8-row tiles one a 2-row sub-tile, the slots of K7-CSL),
//     then grid.sync(). Every block then sums the slots in order (one
//     warp, lane-strided, shuffle tree: the order of the step kernels'
//     sum_slots_warp_kernel, so the sums equal the step route's bitwise)
//     and runs the controller in one thread, redundantly: every block
//     takes the same decision with no second barrier. The controller
//     rounds as ops/ode.py _post does on the card. The slots are double-
//     buffered by step parity, so a fast block's step i+1 never overwrites
//     slots a slow block still reads.
//   * saveat: every block keeps the save cursor in shared memory,
//     redundantly. An accepted step writes each save time in (t, t_end]
//     by cubic Hermite interpolation, each tile its own rows, each multiply
//     and add rounded as the ATen ops of ops/ode.py _interp. The reverse
//     walk hands each row's cotangent to the step that wrote it.
//   * The backward reads the stored accept flags and norm sums, and pulls
//     cotangents back through the scalar chain with post_bwd, the hand
//     pullback of ops/ode.py post_bwd. Scalar cotangents are per-tile slots
//     summed in tile order. MLPDynamics' weight-cotangent rows of each trial
//     step are stored (about 22 MB a step at 512x784x100) and summed after
//     the walk by one fixed-order contraction; AlternatingMLP's block keeps
//     its tiles' weight cotangents with their owner threads for the whole
//     walk (in registers where they fit) and CSL's adds them to its slot
//     every trial step, and one pass sums the blocks' slots in block order.
//   * MLPDynamics streams its stage residuals, as the TPU's K3/K4 do with
//     cache_residuals: each trial step of K3 stores its six fresh stage
//     derivatives k2..k7 and each stage's hidden activations (ks: S x 6 x
//     B x D, hs: S x 6 x B x H, rejected steps included; 10.9 MB a step at
//     512x784x100) with evict-first stores, and K4 loads them for the same
//     step instead of re-running the six stages (12 contractions and 12
//     tanh's over the tile). K4 rebuilds the stage-6 and stage-5 states
//     from the stored ks by the replay's own expression (stage_state), so
//     its outputs equal the replay's bitwise where K3's ks equal the
//     replay's. The TPU kernel's delayed-by-one DMA and final flush are not
//     needed: the tile stores its rows itself. AlternatingMLP and CSL
//     replay, as on the TPU, whose hand pullback they lack.
// No floating-point atomics, no TF32, no fast math: runs are bitwise
// reproducible. powf is the libdevice powf, as ATen's float pow.

#include <cooperative_groups.h>

#include "coop.cuh"
#include "csl_tsit5.cuh"

namespace cg = cooperative_groups;

namespace {

// Rows of the (11, S) stream buffer (ops/whole_solve.py).
enum { ST_T, ST_DT, ST_QOLD, ST_E, ST_N, ST_D, ST_ACC, TEL_T, TEL_DT,
       TEL_EEST, TEL_EIGEN };

constexpr float kEestFloor = 1e-10f;  // ops/controller.py _EEST_FLOOR

struct Ctrl {
  float beta1, beta2, qmin, qmax, gamma, qoldinit, qsteady_max;
};

struct Post {
  float t_new, dt_next, qold_next, t_end, eest, eigen;
  bool accept;
};

// The scalar chain of one trial step (ops/ode.py _post), rounded as ATen
// runs it on 0-d CUDA tensors: a tensor divided by a Python float is
// multiplied by the float reciprocal (e / count, q / gamma), a tensor by a
// tensor divided; pow is powf.
__device__ Post post_fwd(const Ctrl& c, float count, float t, float dt_eff,
                         float qold, float e, float n, float d, float t1,
                         float span, bool is_last) {
  Post p;
  const float inv_count = __fdiv_rn(1.0f, count);
  const float inv_gamma = __fdiv_rn(1.0f, c.gamma);
  p.eest = e > 0.0f ? sqrtf(__fmul_rn(e, inv_count)) : 0.0f;
  const float num = n > 0.0f ? sqrtf(n) : 0.0f;
  const float den = d > 0.0f ? sqrtf(d) : 0.0f;
  p.eigen = den > 0.0f ? __fdiv_rn(num, fmaxf(den, 1e-30f)) : 0.0f;
  p.accept = p.eest <= 1.0f;
  const float q11 = powf(fmaxf(p.eest, kEestFloor), c.beta1);
  const float q = __fdiv_rn(q11, powf(qold, c.beta2));
  float qa = fminf(fmaxf(__fmul_rn(q, inv_gamma), __fdiv_rn(1.0f, c.qmax)),
                   __fdiv_rn(1.0f, c.qmin));
  if (c.qsteady_max > 1.0f && qa >= 1.0f && qa <= c.qsteady_max) qa = 1.0f;
  const float dt0 = p.accept
      ? __fdiv_rn(dt_eff, qa)
      : __fdiv_rn(dt_eff, fminf(__fdiv_rn(1.0f, c.qmin), __fmul_rn(q11, inv_gamma)));
  p.qold_next = p.accept ? fmaxf(p.eest, c.qoldinit) : qold;
  p.dt_next = __fmul_rn(sign_of(dt0), fminf(fabsf(dt0), span));
  p.t_end = is_last ? t1 : __fadd_rn(t, dt_eff);
  p.t_new = p.accept ? p.t_end : t;
  return p;
}

// Autograd's pullbacks of maximum(a, b) / minimum(a, b) to a: all of g
// where a wins, half of it on a tie.
__device__ __forceinline__ float max_grad(float a, float b, float g) {
  return a > b ? g : (a == b ? g / 2.0f : 0.0f);
}
__device__ __forceinline__ float min_grad(float a, float b, float g) {
  return a < b ? g : (a == b ? g / 2.0f : 0.0f);
}

struct PostGrads {
  float t, dt_eff, qold, e, n, d, t1, span;
};

// Hand pullback of post_fwd, the algebra of ops/ode.py post_bwd line by
// line. c_* are the cotangents of (t_new, dt_next, qold_next, t_end, eest,
// eigen); accept is the stored flag.
__device__ PostGrads post_bwd(const Ctrl& c, float count, float t, float dt_eff,
                              float qold, float e, float n, float d, float t1,
                              float span, bool is_last, bool accept,
                              float c_tnew, float c_dtn, float c_qn,
                              float c_tend, float c_eest, float c_eig) {
  const bool pe = e > 0.0f, pn = n > 0.0f, pd = d > 0.0f;
  const float eest = pe ? sqrtf(e / count) : 0.0f;
  const float num = pn ? sqrtf(n) : 0.0f;
  const float den = pd ? sqrtf(d) : 0.0f;
  const float tiny = 1e-30f;
  const float mden = fmaxf(den, tiny);
  const float es = fmaxf(eest, kEestFloor);
  const float q11 = powf(es, c.beta1);
  const float qb = powf(qold, c.beta2);
  const float q = q11 / qb;
  const float qg = q / c.gamma;
  const float lo = 1.0f / c.qmax, hi = 1.0f / c.qmin;
  const float mx = fmaxf(qg, lo);
  const float qa0 = fminf(mx, hi);
  const bool in_band = c.qsteady_max > 1.0f && qa0 >= 1.0f && qa0 <= c.qsteady_max;
  const float qa = in_band ? 1.0f : qa0;
  const float r = q11 / c.gamma;
  const float q_rej = fminf(hi, r);
  const float dt0 = accept ? dt_eff / qa : dt_eff / q_rej;
  const float s = sign_of(dt0);
  const float a = fabsf(dt0);

  PostGrads g;
  // t_new = where(accept, t_end, t); t_end = where(is_last, t1, t + dt_eff)
  const float g_tend = c_tend + (accept ? c_tnew : 0.0f);
  g.t = accept ? 0.0f : c_tnew;
  g.t1 = is_last ? g_tend : 0.0f;
  const float g_lin = is_last ? 0.0f : g_tend;
  g.t = g.t + g_lin;
  g.dt_eff = g_lin;
  // dt_next = sign(dt0) * minimum(|dt0|, span)
  const float g_m = c_dtn * s;
  const float g_dt0 = min_grad(a, span, g_m) * s;
  g.span = min_grad(span, a, g_m);
  // qold_next = where(accept, maximum(eest, qoldinit), qold)
  g.qold = accept ? 0.0f : c_qn;
  float g_eest = c_eest + max_grad(eest, c.qoldinit, accept ? c_qn : 0.0f);
  // dt0 = where(accept, dt_eff / qa, dt_eff / q_rej)
  const float g_acc = accept ? g_dt0 : 0.0f;
  const float g_rej = accept ? 0.0f : g_dt0;
  g.dt_eff = g.dt_eff + g_acc / qa + g_rej / q_rej;
  const float g_qa = -g_acc * ((dt_eff / qa) / qa);
  const float g_qrej = -g_rej * ((dt_eff / q_rej) / q_rej);
  float g_q11 = min_grad(r, hi, g_qrej) / c.gamma;
  const float g_qa0 = in_band ? 0.0f : g_qa;
  const float g_q = max_grad(qg, lo, min_grad(mx, hi, g_qa0)) / c.gamma;
  g_q11 = g_q11 + g_q / qb;
  const float g_qb = -g_q * ((q11 / qb) / qb);
  g.qold = g.qold + g_qb * (c.beta2 * powf(qold, c.beta2 - 1.0f));
  const float g_es = g_q11 * (c.beta1 * powf(es, c.beta1 - 1.0f));
  g_eest = g_eest + max_grad(eest, kEestFloor, g_es);
  // eigen = where(den > 0, num / maximum(den, 1e-30), 0)
  const float g_ratio = den > 0.0f ? c_eig : 0.0f;
  const float g_num = g_ratio / mden;
  const float g_den = den > 0.0f
      ? max_grad(den, tiny, -g_ratio * ((num / mden) / mden)) : 0.0f;
  g.e = pe ? (g_eest / (2.0f * eest)) / count : 0.0f;
  g.n = pn ? g_num / (2.0f * num) : 0.0f;
  g.d = pd ? g_den / (2.0f * den) : 0.0f;
  return g;
}

// The forward's scalar state, in the solving kernel's shared memory (one
// copy a block, kept alike in every block): t, dt and qold of the next
// trial step, the step counts, whether the solve is done, the last trial
// step's accept flag and save rows [lo, hi), and the save cursor.
struct FwdState {
  float t, dt, qold;
  int na, nr, done, acc, cur, lo, hi;
};

// Thread 0, before the first trial step.
template <class A>
__device__ __forceinline__ void fwd_begin(const A& a, FwdState& s, float span) {
  s.t = a.scalars[0];
  s.dt = a.scalars[2];
  s.qold = a.ctrl.qoldinit;
  s.na = s.nr = 0;
  s.done = span == 0.0f;
  s.cur = a.sv.n ? a.sv.cursors[0] : 0;
  s.lo = s.hi = 0;
}

// Warp 0 of every block, after every tile of trial step i wrote its norm
// sums to its slots (part[3 * k ..] for k < ntiles, the slots) and the grid
// synced: sums the slots in order and runs the controller (thread 0); block
// 0 records the step in the streams.
template <class A>
__device__ __forceinline__ void fwd_decide(const A& a, FwdState& s, const float* part,
                                           int ntiles, int i, float t, float dt,
                                           float dt_eff, bool is_last, float t1, float tdir,
                                           float span, float count) {
  float sums[3];
  sum_tiles<3>(part, ntiles, sums);
  if (threadIdx.x != 0) return;
  const Post p = post_fwd(a.ctrl, count, t, dt_eff, s.qold, sums[0], sums[1], sums[2], t1,
                          span, is_last);
  if (blockIdx.x == 0) {
    float* st = a.streams;
    const int S = a.S;
    st[ST_T * S + i] = t;
    st[ST_DT * S + i] = dt;
    st[ST_QOLD * S + i] = s.qold;
    st[ST_E * S + i] = sums[0];
    st[ST_N * S + i] = sums[1];
    st[ST_D * S + i] = sums[2];
    st[ST_ACC * S + i] = p.accept ? 1.0f : 0.0f;
    st[TEL_T * S + i] = p.t_end;
    st[TEL_DT * S + i] = dt_eff;
    st[TEL_EEST * S + i] = p.eest;
    st[TEL_EIGEN * S + i] = p.eigen;
  }
  // the save cursor consumes every save time in (t, t_end]
  int hi = s.cur;
  if (p.accept)
    while (hi < a.sv.n && (a.sv.sa[hi] - p.t_end) * tdir <= 0.0f) ++hi;
  s.lo = s.cur;
  s.hi = hi;
  s.cur = hi;
  s.acc = p.accept;
  s.t = p.t_new;
  s.dt = p.dt_next;
  s.qold = p.qold_next;
  if (p.accept) ++s.na; else ++s.nr;
  s.done = p.accept && is_last;
}

// Block 0, thread 0, after the solve: the final scalars and save cursor.
template <class A>
__device__ __forceinline__ void fwd_end(const A& a, const FwdState& s) {
  a.final_[0] = s.t;
  a.final_[1] = s.dt;
  a.final_[2] = s.qold;
  a.final_[3] = (float)s.na;
  a.final_[4] = (float)s.nr;
  a.final_[5] = (float)s.done;
  if (a.sv.n) a.sv.cursors[1] = s.cur;
}

// Copies rows [row0, row0 + rows) of src to dst (B x D row-major).
__device__ void copy_rows(const float* src, float* dst, int row0, int rows,
                          int D) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const size_t g = (size_t)row0 * D + idx;
    dst[g] = __ldcg(src + g);
  }
}

// The saveat rows of a solve: n save times sa, monotone in the direction
// of time; cursors[0] rows lie at or before t0 and hold y0 already (the
// caller's ys_init), the forward writes cursors[1], the first row it did
// not reach.
struct Saves {
  const float* sa;
  int* cursors;
  float* ys;  // (n, B, D)
  int n;
};

// Cubic Hermite interpolation on an accepted step from (t, y0, f0) over
// dt_eff to (y1, f1) at one save time, each multiply and add rounded as the
// ATen ops of ops/ode.py _interp and _hermite_eval (the step route's
// writer): the save time's coefficients (hermite_at), then one element's
// value (hermite_value).
struct HermiteAt {
  float th, a0, P, c, thm1_h, th_h;
};

__device__ __forceinline__ HermiteAt hermite_at(float sa, float t, float dt_eff) {
  const float hd = dt_eff == 0.0f ? 1.0f : dt_eff;
  HermiteAt h;
  h.th = __fdiv_rn(__fsub_rn(sa, t), hd);
  h.a0 = __fsub_rn(1.0f, h.th);
  const float thm1 = __fsub_rn(h.th, 1.0f);
  h.P = __fmul_rn(h.th, thm1);
  h.c = __fsub_rn(1.0f, __fmul_rn(2.0f, h.th));
  h.thm1_h = __fmul_rn(thm1, dt_eff);
  h.th_h = __fmul_rn(h.th, dt_eff);
  return h;
}

__device__ __forceinline__ float hermite_value(const HermiteAt& h, float y0, float y1,
                                               float f0, float f1) {
  const float dy = __fsub_rn(y1, y0);
  const float lin = __fadd_rn(__fmul_rn(h.a0, y0), __fmul_rn(h.th, y1));
  const float q = __fadd_rn(__fadd_rn(__fmul_rn(h.c, dy), __fmul_rn(h.thm1_h, f0)),
                            __fmul_rn(h.th_h, f1));
  return __fadd_rn(lin, __fmul_rn(h.P, q));
}

// The rows [lo, hi) of ys for batch rows [row0, row0 + rows), from the
// accepted step (t, yi, fi) -> (yn, kn).
__device__ void hermite_rows(const Saves& sv, int lo, int hi, float t,
                             float dt_eff, const float* yi, const float* fi,
                             const float* yn, const float* kn, int row0,
                             int rows, int D, size_t BD) {
  for (int r = lo; r < hi; ++r) {
    const HermiteAt h = hermite_at(sv.sa[r], t, dt_eff);
    float* out = sv.ys + (size_t)r * BD;
    for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
      const size_t g = (size_t)row0 * D + idx;
      out[g] = hermite_value(h, __ldcg(yi + g), __ldcg(yn + g), __ldcg(fi + g),
                             __ldcg(kn + g));
    }
  }
}

// The pullback of hermite_rows at one element g of rows [lo, hi) with
// their cotangents ct_ys: the cotangents of y_i, y_new, f0_i and k7 at g
// (y0, y1, f0, f1 their values), and the element's shares of the
// cotangents of t and dt_eff added to part[0], part[1]. hd is dt_eff, or 1
// where dt_eff is 0 (h0).
__device__ __forceinline__ void hermite_elem(const float* sa, const float* ct_ys, int lo,
                                             int hi, float t, float dt_eff, float hd,
                                             bool h0, float y0, float y1, float f0,
                                             float f1, size_t g, size_t BD, float* part,
                                             float& c_y0, float& c_y1, float& c_f0,
                                             float& c_f1) {
  const float dy = y1 - y0;
  c_y0 = c_y1 = c_f0 = c_f1 = 0.0f;
  for (int r = lo; r < hi; ++r) {
    const float th = (sa[r] - t) / hd;
    const float P = th * (th - 1.0f);
    const float c = 1.0f - 2.0f * th;
    const float gr = __ldcg(ct_ys + (size_t)r * BD + g);
    c_y0 += gr * ((1.0f - th) - P * c);
    c_y1 += gr * (th + P * c);
    c_f0 += gr * (P * (th - 1.0f) * dt_eff);
    c_f1 += gr * (P * th * dt_eff);
    const float q = c * dy + (th - 1.0f) * dt_eff * f0 + th * dt_eff * f1;
    const float dth = dy + (2.0f * th - 1.0f) * q + P * (dt_eff * (f0 + f1) - 2.0f * dy);
    const float ct_th = gr * dth;
    // theta = (sa - t) / dt_eff (over 1 where dt_eff is 0)
    part[0] -= ct_th / hd;
    part[1] += gr * P * ((th - 1.0f) * f0 + th * f1) - (h0 ? 0.0f : ct_th * th / hd);
  }
}

// The pullback of hermite_rows for rows [lo, hi) with their cotangents
// ct_ys: per element the cotangents of y_i and f0_i (written to hdy, hdf)
// and of y_new and k7 (added to ct_y, ct_f, where the trial step's
// pullback takes them as seeds); the tile's sums of the cotangents of t
// and dt_eff to part_out. red: 2 * kWarps floats of shared memory.
__device__ void hermite_pullback(const float* sa, const float* ct_ys, int lo,
                                 int hi, float t, float dt_eff, const float* yi,
                                 const float* fi, const float* yn,
                                 const float* kn, float* ct_y, float* ct_f,
                                 float* hdy, float* hdf, float* part_out,
                                 float* red, int row0, int rows, int D,
                                 size_t BD) {
  const bool h0 = dt_eff == 0.0f;
  const float hd = h0 ? 1.0f : dt_eff;
  float part[2] = {0.0f, 0.0f};  // ct_t, ct_dt_eff
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const size_t g = (size_t)row0 * D + idx;
    float c_y0, c_y1, c_f0, c_f1;
    hermite_elem(sa, ct_ys, lo, hi, t, dt_eff, hd, h0, __ldcg(yi + g), __ldcg(yn + g),
                 __ldcg(fi + g), __ldcg(kn + g), g, BD, part, c_y0, c_y1, c_f0, c_f1);
    ct_y[g] = __ldcg(ct_y + g) + c_y1;
    ct_f[g] = __ldcg(ct_f + g) + c_f1;
    hdy[g] = c_y0;
    hdf[g] = c_f0;
  }
  block_sum_to<2>(part, red, part_out);
}

// MLPDynamics' leaves (W1, b1, W2, b2) and its whole solve's rows, for
// its own forward (mlp_solve.cuh) and reverse walk (mlp_walk.cuh). With
// STREAM the forward streams each trial step's stage residuals to ks, hs
// (S x 6 x B x D and S x 6 x B x H) and the walk reads them; without, both
// are null and the walk replays the stages. The walk stores each trial
// step's weight-cotangent rows (cp2, he, cp1, ye; 6 B rows a step) for one
// contraction after it.
template <bool STREAM>
struct MlpDyn {
  const float *W1, *b1, *W2, *b2;
  float *ks, *hs;
  float *cp2, *he, *cp1, *ye;
  int H;
};

// AlternatingMLP: K7's forward body (altmlp_forward_tile, kAltRows-row
// tiles, one norm-sum slot a kAltSlotRows-row sub-tile) and K8's reverse
// body backward (altmlp_reverse_tile, kAltBwdRows-row tiles), the padded
// leaves in shared memory for the whole solve. The backward's weight and
// bias cotangents stay with their owner threads for the whole walk (Regs:
// in registers, the rest in the walk's shared memory) and reach
// slots[blockIdx.x] (leaf_floats) once, at the end; from float pad4(grid *
// leaf_floats) on, slots holds each block's activation records
// (alt_reverse_records).
struct AltDyn {
  static constexpr int kFwdR = kAltRows, kBwdR = kAltBwdRows, kSlotR = kAltSlotRows;
  using Regs = AltCw;
  AltLeaves lv;
  float* slots;
  int depth, H;

  __device__ void setup_fwd(float* smem, int D) const {
    alt_fwd_load_weights(lv, depth, D, H, smem);
  }
  __device__ void fwd(const float* y, const float* k1, int row0, int rows, int,
                      int, float, float dt, float* yn, float* kn, float* sums,
                      int D, float rtol, float atol, float* smem) const {
    altmlp_forward_tile(y, k1, row0, rows, dt, smem, depth, yn, kn, sums, D, H,
                        rtol, atol, smem + alt_fwd_weight_floats(depth, D, H));
  }
  __device__ void setup_bwd(float* smem, int D, AltCw& cw) const {
    load_weights(lv, depth, D, H, smem);
    alt_reverse_begin(cw, smem + padded_weight_floats(depth, D, H), depth, D, H);
  }
  __device__ void bwd(const float* y, const float* k1, int row0, int rows, int,
                      int, float, float dt, const float* ct_ynew,
                      const float* ct_k7, const float* pass_y,
                      const float* pass_k1, float c_err, float c_num,
                      float c_den, float* ct_y, float* ct_k1, float* part,
                      int D, float rtol, float atol, float* smem, AltCw& cw) const {
    float* recs = slots + alt_pad4((int)gridDim.x * leaf_floats(depth, D, H)) +
                  (size_t)blockIdx.x * alt_reverse_records(depth, D, H);
    altmlp_reverse_tile(y, k1, row0, rows, dt, smem, depth, cw, recs, ct_ynew, ct_k7, pass_y,
                        pass_k1, c_err, c_num, c_den, ct_y, ct_k1, part, D, H, rtol, atol,
                        smem + padded_weight_floats(depth, D, H));
  }
  __device__ void finish_bwd(float* smem, int D, const AltCw& cw) const {
    alt_cw_store(cw, smem + padded_weight_floats(depth, D, H),
                 slots + (size_t)blockIdx.x * leaf_floats(depth, D, H), depth, D, H);
  }
};

// FFJORD's CSL dynamics: K7-CSL's tile body forward (csl_forward_tile,
// 8-row tiles, each writing one norm-sum slot a 2-row sub-tile) and K8-CSL's
// reverse body backward (csl_reverse_tile, 8-row tiles), the padded
// parameters in shared memory for the whole solve (the probe e is read by
// row). The backward's slots hold one slot a block (csl_leaf_floats)
// that its tiles add their parameter cotangents to, zeroed first and
// summed over the blocks after the walk, then, from float pad4(grid *
// csl_leaf_floats) on, each block's activation records
// (csl_reverse_records). The template's row width is the augmented state's,
// A = dim + 1 or dim + 3 (kinetic).
struct CslDyn {
  static constexpr int kFwdR = kCslBwdRows, kBwdR = kCslBwdRows, kSlotR = kCslSlotRows;
  struct Regs {};  // its cotangents live in the slots
  CslLeaves lv;
  float* slots;
  int dim, H, kinetic;

  __device__ void setup_fwd(float* smem, int) const { csl_load_params(lv, dim, H, smem); }
  __device__ void fwd(const float* y, const float* k1, int row0, int rows, int,
                      int, float t, float dt, float* yn, float* kn, float* sums,
                      int A, float rtol, float atol, float* smem) const {
    csl_forward_tile(y, k1, lv.p[kCslParams], row0, rows, t, dt, smem, yn, kn, sums, A,
                     dim, H, kinetic, rtol, atol, smem + csl_pad_floats(dim, H));
  }
  __device__ void setup_bwd(float* smem, int, Regs&) const {
    csl_load_weights(lv, dim, H, smem);
    const int nleaf = csl_leaf_floats(dim, H);
    float* slot = slots + (size_t)blockIdx.x * nleaf;
    for (int e = threadIdx.x; e < nleaf; e += kThreads) slot[e] = 0.0f;
  }
  __device__ void bwd(const float* y, const float* k1, int row0, int rows, int,
                      int, float t, float dt, const float* ct_ynew,
                      const float* ct_k7, const float* pass_y,
                      const float* pass_k1, float c_err, float c_num,
                      float c_den, float* ct_y, float* ct_k1, float* part,
                      int A, float rtol, float atol, float* smem, Regs&) const {
    const int nleaf = csl_leaf_floats(dim, H);
    float* recs = slots + csl_pad4((int)gridDim.x * nleaf) +
                  (size_t)blockIdx.x * csl_reverse_records(dim, H);
    csl_reverse_tile(y, k1, lv.p[kCslParams], row0, rows, t, dt, smem, recs,
                     slots + (size_t)blockIdx.x * nleaf, true, ct_ynew, ct_k7, pass_y,
                     pass_k1, c_err, c_num, c_den, ct_y, ct_k1, part, A, dim, H, kinetic,
                     rtol, atol, smem + csl_pad_floats(dim, H));
  }
  __device__ void finish_bwd(float*, int, const Regs&) const {}
};

template <class Dyn>
struct FwdArgs {
  const float* scalars;  // t0, t1, dt0
  const float* y0;
  const float* f0;
  Dyn dyn;
  Saves sv;
  float* y1;
  float* hy;  // (S+1, B, D)
  float* hf;
  float* streams;  // (11, S), zero on entry
  float* final_;   // t, dt, qold, naccept, nreject, done
  float* partials;  // (2, nslots, 3): a slot Dyn::kSlotR rows
  int B, D, S;
  float rtol, atol;
  Ctrl ctrl;
};

// K3 for AlternatingMLP and CSL: the whole forward solve on row tiles of
// Dyn::kFwdR rows, each writing its norm sums as R / kSlotR slots
// (MLPDynamics solves in mlp_solve.cuh).
template <class Dyn>
__global__ void __launch_bounds__(kThreads) whole_solve_fwd_kernel(FwdArgs<Dyn> a) {
  extern __shared__ float smem[];
  __shared__ FwdState s;
  cg::grid_group grid = cg::this_grid();
  constexpr int R = Dyn::kFwdR, SR = Dyn::kSlotR;
  const int ntiles = (a.B + R - 1) / R, nslots = (a.B + SR - 1) / SR;
  const size_t BD = (size_t)a.B * a.D;
  const float t0 = a.scalars[0], t1 = a.scalars[1];
  const float tdir = sign_of(t1 - t0), span = fabsf(t1 - t0);
  const float count = (float)BD;

  a.dyn.setup_fwd(smem, a.D);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * R, rows = min(R, a.B - row0);
    copy_rows(a.y0, a.hy, row0, rows, a.D);
    copy_rows(a.f0, a.hf, row0, rows, a.D);
  }
  if (threadIdx.x == 0) fwd_begin(a, s, span);
  __syncthreads();

  int i = 0;
  for (; i < a.S && !s.done; ++i) {
    const float t = s.t, dt = s.dt;
    const float remaining = t1 - t;
    const bool is_last = (dt - remaining) * tdir >= 0.0f;
    const float dt_eff = is_last ? remaining : dt;
    float* part = a.partials + (size_t)(i & 1) * nslots * 3;
    const float* yi = a.hy + (size_t)i * BD;
    const float* fi = a.hf + (size_t)i * BD;
    float* yn = a.hy + (size_t)(i + 1) * BD;
    float* kn = a.hf + (size_t)(i + 1) * BD;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int row0 = tile * R;
      a.dyn.fwd(yi, fi, row0, min(R, a.B - row0), i, a.B, t, dt_eff, yn, kn,
                part + 3 * (R / SR) * tile, a.D, a.rtol, a.atol, smem);
    }
    grid.sync();
    if (threadIdx.x < 32)
      fwd_decide(a, s, part, nslots, i, t, dt, dt_eff, is_last, t1, tdir, span, count);
    __syncthreads();
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int row0 = tile * R, rows = min(R, a.B - row0);
      if (!s.acc) {  // a rejected step keeps its start state
        copy_rows(yi, yn, row0, rows, a.D);
        copy_rows(fi, kn, row0, rows, a.D);
      } else {
        hermite_rows(a.sv, s.lo, s.hi, t, dt_eff, yi, fi, yn, kn, row0, rows,
                     a.D, BD);
      }
    }
    __syncthreads();
  }

  const float* y_end = a.hy + (size_t)i * BD;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * R;
    copy_rows(y_end, a.y1, row0, min(R, a.B - row0), a.D);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) fwd_end(a, s);
}

template <class Dyn>
struct BwdArgs {
  const float* scalars;  // t0, t1
  const float* streams;  // (11, S), the forward's
  const float* hy;
  const float* hf;
  Dyn dyn;
  Saves sv;  // ys: in ct_ys, out the cotangent of ys_init
  const float* ct_tel;  // (4, S): t, dt, eest, eigen_est
  float* ct_y;  // in: ct_y1, out: ct_y0
  float* ct_f;  // in: 0, out: ct_f0
  float* ct_scalars;  // out: ct_t0, ct_t1, ct_dt0
  float* partials;  // (2, ntiles, 4): the trial step's, the pullback's (ct_t, ct_dt)
  float* hdy;  // (B, D): the Hermite pullback's cotangents of y_i, f0_i
  float* hdf;
  int ns, B, D, S;
  float rtol, atol;
  Ctrl ctrl;
};

// The reverse walk's scalar state, in the walking kernel's shared memory:
// the running cotangents ct_t, ct_dt, ct_qold, of t1 and of span; the
// current trial step's pullback of the controller, start time, dt_eff,
// is_last and accept flags and save rows [lo, hi); the reverse cursor.
struct Chain {
  float (&ct)[5];
  PostGrads& g;
  float &ti, &dteff;
  int &last, &acc, &lo, &hi, &rcur;
};

// Thread 0, before trial step i of a reverse walk: pulls the running
// cotangents back through the step's controller (post_bwd) and moves the
// reverse save cursor: an accepted step owns the rows before it whose save
// time lies after its start.
template <class A>
__device__ __forceinline__ void chain_begin(const A& a, const Chain& c, int i, int cur0,
                                            float t1, float tdir, float span, float count) {
  const int S = a.S;
  const float* st = a.streams;
  const float t_i = st[ST_T * S + i], dt_i = st[ST_DT * S + i];
  const float remaining = t1 - t_i;
  const bool is_last = (dt_i - remaining) * tdir >= 0.0f;
  const float dt_eff = is_last ? remaining : dt_i;
  const bool acc = st[ST_ACC * S + i] > 0.5f;
  c.g = post_bwd(a.ctrl, count, t_i, dt_eff, st[ST_QOLD * S + i],
                 st[ST_E * S + i], st[ST_N * S + i], st[ST_D * S + i], t1,
                 span, is_last, acc, c.ct[0], c.ct[1], c.ct[2],
                 a.ct_tel[0 * S + i], a.ct_tel[2 * S + i],
                 a.ct_tel[3 * S + i]);
  c.ti = t_i;
  c.dteff = dt_eff;
  c.last = is_last;
  c.acc = acc;
  int lo = c.rcur;
  if (acc)
    while (lo > cur0 && (a.sv.sa[lo - 1] - t_i) * tdir > 0.0f) --lo;
  c.lo = lo;
  c.hi = c.rcur;
  c.rcur = lo;
}

// Warp 0, after every tile of trial step i wrote its slot part[4 * tile ..]
// (the trial step's cotangents of t and dt_eff, then the Hermite
// pullback's) and the grid synced: sums the slots in tile order and adds
// them to the running cotangents.
template <class A>
__device__ __forceinline__ void chain_end(const A& a, const Chain& c, const float* part,
                                          int ntiles, int i) {
  float k[4];
  sum_tiles<4>(part, ntiles, k);
  if (threadIdx.x == 0) {
    // dt_eff = where(is_last, t1 - t, dt)
    const float ct_dteff = c.g.dt_eff + k[1] + k[3] + a.ct_tel[1 * a.S + i];
    c.ct[0] = c.g.t + k[0] + k[2] + (c.last ? -ct_dteff : 0.0f);
    c.ct[1] = c.last ? 0.0f : ct_dteff;
    c.ct[2] = c.g.qold;
    c.ct[3] = c.ct[3] + c.g.t1 + (c.last ? ct_dteff : 0.0f);
    c.ct[4] = c.ct[4] + c.g.span;
  }
}

// Block 0, thread 0, after the walk: the cotangents of t0, t1 and dt0.
__device__ __forceinline__ void chain_finish(const Chain& c, float* ct_scalars, float tdir) {
  ct_scalars[0] = c.ct[0] - tdir * c.ct[4];
  ct_scalars[1] = c.ct[3] + tdir * c.ct[4];
  ct_scalars[2] = c.ct[1];
}

// K4 for AlternatingMLP and CSL: the reverse walk over the forward's ns
// trial steps on row tiles (MLPDynamics walks in mlp_walk.cuh).
template <class Dyn>
__global__ void __launch_bounds__(kThreads) whole_solve_bwd_kernel(BwdArgs<Dyn> a) {
  extern __shared__ float smem[];
  // running cotangents ct_t, ct_dt, ct_qold, of t1 and of span
  __shared__ float s_ct[5];
  __shared__ float s_ti, s_dteff;
  __shared__ int s_last, s_acc, s_lo, s_hi, s_rcur;
  __shared__ PostGrads s_g;
  __shared__ float s_red[2 * kWarps];
  const Chain ch{s_ct, s_g, s_ti, s_dteff, s_last, s_acc, s_lo, s_hi, s_rcur};
  cg::grid_group grid = cg::this_grid();
  constexpr int R = Dyn::kBwdR;
  const int ntiles = (a.B + R - 1) / R;
  const size_t BD = (size_t)a.B * a.D;
  const float t0 = a.scalars[0], t1 = a.scalars[1];
  const float tdir = sign_of(t1 - t0), span = fabsf(t1 - t0);
  const float count = (float)BD;
  const int cur0 = a.sv.n ? a.sv.cursors[0] : 0;
  typename Dyn::Regs regs;  // the dynamics' state a thread holds over the walk
  a.dyn.setup_bwd(smem, a.D, regs);
  if (threadIdx.x < 5) s_ct[threadIdx.x] = 0.0f;
  if (threadIdx.x == 0) s_rcur = a.sv.n ? a.sv.cursors[1] : 0;
  __syncthreads();

  for (int j = 0; j < a.ns; ++j) {
    const int i = a.ns - 1 - j;
    if (threadIdx.x == 0) chain_begin(a, ch, i, cur0, t1, tdir, span, count);
    __syncthreads();
    const bool acc = s_acc, saves = s_hi > s_lo;
    float* part = a.partials + (size_t)(j & 1) * ntiles * 4;
    const float* yi = a.hy + (size_t)i * BD;
    const float* fi = a.hf + (size_t)i * BD;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int row0 = tile * R, rows = min(R, a.B - row0);
      if (saves) {
        hermite_pullback(a.sv.sa, a.sv.ys, s_lo, s_hi, s_ti, s_dteff, yi, fi,
                         a.hy + (size_t)(i + 1) * BD, a.hf + (size_t)(i + 1) * BD,
                         a.ct_y, a.ct_f, a.hdy, a.hdf, part + 4 * tile + 2,
                         s_red, row0, rows, a.D, BD);
        __syncthreads();
      } else if (threadIdx.x == 0) {
        part[4 * tile + 2] = 0.0f;
        part[4 * tile + 3] = 0.0f;
      }
      // y_out = where(acc, y_new, y), f0_out likewise: route the carry
      a.dyn.bwd(yi, fi, row0, rows, i, a.B, s_ti, s_dteff,
                acc ? a.ct_y : nullptr, acc ? a.ct_f : nullptr,
                acc ? (saves ? a.hdy : nullptr) : a.ct_y,
                acc ? (saves ? a.hdf : nullptr) : a.ct_f, s_g.e, s_g.n, s_g.d,
                a.ct_y, a.ct_f, part + 4 * tile, a.D, a.rtol, a.atol, smem, regs);
    }
    grid.sync();
    if (threadIdx.x < 32) chain_end(a, ch, part, ntiles, i);
    __syncthreads();
  }
  // the rows the forward wrote pass no cotangent on to ys_init
  if (a.sv.n) {
    const int curf = a.sv.cursors[1];
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int row0 = tile * R, rows = min(R, a.B - row0);
      for (int r = cur0; r < curf; ++r)
        for (int idx = threadIdx.x; idx < rows * a.D; idx += kThreads)
          a.sv.ys[(size_t)r * BD + (size_t)row0 * a.D + idx] = 0.0f;
    }
  }
  a.dyn.finish_bwd(smem, a.D, regs);
  if (blockIdx.x == 0 && threadIdx.x == 0) chain_finish(ch, a.ct_scalars, tdir);
}

Ctrl make_ctrl(float beta1, float beta2, float qmin, float qmax, float gamma,
               float qoldinit, float qsteady_max) {
  return Ctrl{beta1, beta2, qmin, qmax, gamma, qoldinit, qsteady_max};
}

}  // namespace

#include "mlp_solve.cuh"
#include "mlp_walk.cuh"
#include "mlp_step_walk.cuh"
#include "mlp_step_solve.cuh"

namespace {

// Launches MLPDynamics' K3, K4, K13, K1, K2, K14 or K12 with one block a tile, or fails if
// the card cannot hold every tile's block at once.
cudaError_t launch_walk(const void* kernel, void* args, size_t smem, int tiles,
                        cudaStream_t s) {
  int capacity = 0;
  cudaError_t e = cooperative_capacity(kernel, smem, &capacity);
  if (e != cudaSuccess) return e;
  if (capacity < tiles) return cudaErrorCooperativeLaunchTooLarge;
  return launch_cooperative(kernel, args, smem, tiles, s, nullptr);
}

// Whether a tile plan (ops/whole_solve.py walk_plan) is one K3, K4, K13, K1,
// K2, K14 and K12 take at B x D: tiles of 16 or 32 rows and a multiple of kWalkTN columns, at
// most the row passes' elements, covering the batch.
bool plan_ok(int rows, int cols, int row_blocks, int col_blocks, int chunks, int B, int D) {
  return (rows == 16 || rows == 32) && cols >= 1 && cols % kWalkTN == 0 &&
         rows * cols <= kWalkRounds * kThreads * kWalkTM && row_blocks >= 1 && chunks >= 1 &&
         col_blocks == (D + cols - 1) / cols && chunks * row_blocks * rows >= B;
}

// The walk of one trial step (K2, K14, K12) on a checked plan, replaying the
// step's stages: the leaves, the weight-cotangent rows, the outputs ct_y,
// ct_k1 and the norms' tolerances in the walk's arguments.
WalkArgs<false> step_walk(const float* W1, const float* b1, const float* W2, const float* b2,
                          float* ct_y, float* ct_k1, float* psum, float* ctp1g, float* w2p,
                          float* w1p, float* ks_step, float* hs_step, float* fscratch,
                          float* cp2, float* he, float* cp1, float* ye, int B, int D, int H,
                          int rows, int cols, int row_blocks, int col_blocks, int chunks,
                          float rtol, float atol) {
  WalkArgs<false> wa{};
  wa.a.dyn = MlpDyn<false>{W1, b1, W2, b2, nullptr, nullptr, cp2, he, cp1, ye, H};
  wa.a.ct_y = ct_y;
  wa.a.ct_f = ct_k1;
  wa.a.ns = 1;
  wa.a.B = B;
  wa.a.D = D;
  wa.a.rtol = rtol;
  wa.a.atol = atol;
  wa.w = Walk{ks_step, hs_step,    psum,       ctp1g,      w2p,
              w1p,     rows,       cols,       row_blocks, col_blocks,
              chunks,  solve_carve(fscratch, rows, cols, row_blocks, col_blocks, chunks, H)};
  return wa;
}

// K2, K14 or K12 (mlp_step_walk_kernel<Seed>), one cooperative launch on
// the walk's plan, then the weight-cotangent contraction of its 6B rows.
template <class Seed>
int launch_step_walk(StepWalkArgs<Seed> args, float* cW1, float* cb1, float* cW2, float* cb2,
                     float* wpart, int chunk_rows, int wpart_floats, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Walk& w = args.wa.w;
  const MlpDyn<false>& m = args.wa.a.dyn;
  const int state = Seed::Time::kLanes ? kLaneState : kWalkState;
  const cudaError_t e = launch_walk((const void*)mlp_step_walk_kernel<Seed>, &args,
                                    walk_smem_bytes(w.R, w.C, m.H, state), w.nrb * w.ndb, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_weight_cotangents(m.cp2, m.he, m.cp1, m.ye, cW1, cb1, cW2, cb2, wpart,
                                       6 * args.wa.a.B, args.wa.a.D, m.H, chunk_rows,
                                       wpart_floats, s);
}

// K13, K1 or K11 (mlp_step_solve_kernel<End>), one cooperative launch on a
// checked plan with K3's shared memory and scratch in the end's rounding
// policy (and, for K11, the tile's LaneRows).
template <class End>
int launch_step_solve(const float* t, const float* dt, const float* y, const float* k1,
                      const float* W1, const float* b1, const float* W2, const float* b2,
                      End end, float* scratch, int B, int D, int H, int rows, int cols,
                      int row_blocks, int col_blocks, int chunks, void* stream) {
  using Rnd = typename End::Rnd;
  if (!plan_ok(rows, cols, row_blocks, col_blocks, chunks, B, D))
    return (int)cudaErrorInvalidValue;
  StepSolveArgs<End> a{
      MlpDyn<false>{W1, b1, W2, b2, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, H},
      solve_carve<Rnd>(scratch, rows, cols, row_blocks, col_blocks, chunks, H), t, dt, y, k1,
      end, B, D};
  return (int)launch_walk(
      (const void*)mlp_step_solve_kernel<End>, &a,
      sizeof(float) * solve_smem_floats<Rnd>(rows, cols, H, End::Time::kLanes),
      row_blocks * col_blocks, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// MLPDynamics' K3 and K4 on one tile plan: the multiple its tile widths
// take, the most elements a tile holds, K4's, K12's, K3's and K11's shared
// memory for tiles of R x C, and K3's and K11's scratch (the wrapper's plan
// is checked against them, and sizes the scratch by the last two).
int regnde_walk_col_align() { return kWalkTN; }
int regnde_walk_max_tile() { return kWalkRounds * kThreads * kWalkTM; }
int regnde_walk_smem_bytes(int R, int C, int H) { return (int)walk_smem_bytes(R, C, H); }
int regnde_lanes_walk_smem_bytes(int R, int C, int H) {
  return (int)walk_smem_bytes(R, C, H, kLaneState);
}
int regnde_solve_smem_bytes(int R, int C, int H) {
  return (int)(sizeof(float) * solve_smem_floats(R, C, H));
}
int regnde_solve_scratch_floats(int R, int C, int row_blocks, int col_blocks, int H) {
  return (int)solve_scratch_floats(R, C, row_blocks, col_blocks, H);
}
int regnde_lanes_solve_smem_bytes(int R, int C, int H) {
  return (int)(sizeof(float) * solve_smem_floats<F64>(R, C, H, true));
}
int regnde_lanes_solve_scratch_floats(int R, int C, int row_blocks, int col_blocks, int H) {
  return (int)solve_scratch_floats<F64>(R, C, row_blocks, col_blocks, H);
}

// K3 for MLPDynamics (mlp_solve.cuh). scalars: (3,) t0, t1, dt0. saveat:
// (n_save,) save times, monotone in the direction of time; cursors: (2,)
// int, [0] the rows at or before t0 (in), [1] the rows written (out); ys:
// (n_save, B, D), ys_init in, the saved states out (all three null when
// n_save is 0). ks: (S, 6, B, D) and hs: (S, 6, B, H), the stage residuals
// out (both null: no stream). hy, hf: (S+1, B, D). streams: (11, S), zeroed
// by the caller. final: (6,). scratch: regnde_solve_scratch_floats floats.
// The tile plan as regnde_whole_solve_bwd's.
int regnde_whole_solve_fwd(const float* scalars, const float* y0,
                           const float* f0, const float* W1, const float* b1,
                           const float* W2, const float* b2,
                           const float* saveat, int* cursors, float* ys,
                           float* ks, float* hs,
                           float* y1, float* hy, float* hf, float* streams,
                           float* final_, float* scratch, int B, int D, int H,
                           int S, int n_save, int rows, int cols, int row_blocks,
                           int col_blocks, int chunks, float rtol, float atol,
                           float beta1, float beta2, float qmin, float qmax,
                           float gamma, float qoldinit, float qsteady_max,
                           void* stream) {
  if (!ks != !hs || !plan_ok(rows, cols, row_blocks, col_blocks, chunks, B, D))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Ctrl ctrl = make_ctrl(beta1, beta2, qmin, qmax, gamma, qoldinit, qsteady_max);
  const Solve f = solve_carve(scratch, rows, cols, row_blocks, col_blocks, chunks, H);
  const size_t smem = sizeof(float) * solve_smem_floats(rows, cols, H);
  const int tiles = row_blocks * col_blocks;
  if (ks) {
    SolveArgs<true> a{{scalars, y0, f0,
                       MlpDyn<true>{W1, b1, W2, b2, ks, hs, nullptr, nullptr, nullptr,
                                    nullptr, H},
                       Saves{saveat, cursors, ys, n_save}, y1, hy, hf, streams,
                       final_, nullptr, B, D, S, rtol, atol, ctrl},
                      f};
    return (int)launch_walk((const void*)mlp_solve_kernel<true>, &a, smem, tiles, s);
  }
  SolveArgs<false> a{{scalars, y0, f0,
                      MlpDyn<false>{W1, b1, W2, b2, nullptr, nullptr, nullptr,
                                    nullptr, nullptr, nullptr, H},
                      Saves{saveat, cursors, ys, n_save}, y1, hy, hf, streams,
                      final_, nullptr, B, D, S, rtol, atol, ctrl},
                     f};
  return (int)launch_walk((const void*)mlp_solve_kernel<false>, &a, smem, tiles, s);
}

// K3 for AlternatingMLP: as regnde_whole_solve_fwd with the leaves as a
// host array of 4 * depth device pointers (up_0.weight, up_0.bias,
// down_0.weight, down_0.bias, ...). partials: (2, ceil(B/kAltSlotRows), 3).
int regnde_whole_solve_altmlp_fwd(const float* scalars, const float* y0,
                                  const float* f0, const float* const* leaves,
                                  int depth, const float* saveat, int* cursors,
                                  float* ys, float* y1, float* hy, float* hf,
                                  float* streams, float* final_,
                                  float* partials, int B, int D, int H, int S,
                                  int n_save, float rtol, float atol,
                                  float beta1, float beta2, float qmin,
                                  float qmax, float gamma, float qoldinit,
                                  float qsteady_max, void* stream) {
  if (depth < 1 || 4 * depth > kMaxLeaves) return (int)cudaErrorInvalidValue;
  FwdArgs<AltDyn> a{scalars, y0, f0, AltDyn{pack_leaves(leaves, depth), nullptr, depth, H},
                    Saves{saveat, cursors, ys, n_save}, y1, hy, hf, streams,
                    final_, partials, B, D, S, rtol, atol,
                    make_ctrl(beta1, beta2, qmin, qmax, gamma, qoldinit, qsteady_max)};
  return (int)launch_cooperative((const void*)whole_solve_fwd_kernel<AltDyn>, &a,
                                 altmlp_fwd_smem_bytes(depth, D, H),
                                 (B + kAltRows - 1) / kAltRows,
                                 static_cast<cudaStream_t>(stream), nullptr);
}

// K4 for MLPDynamics (mlp_walk.cuh), then the weight cotangents from its
// stored rows. scalars: (2,) t0, t1. saveat, cursors: the forward's;
// ct_ys: (n_save, B, D), the cotangent of ys in, of ys_init out. ct_tel:
// (4, S). ct_y: ct_y1 in, ct_y0 out; ct_f: zeros in, ct_f0 out. ct_scalars:
// (3,) ct_t0, ct_t1, ct_dt0 out. Weight cotangents in nn.Linear layout. The
// tile plan (ops/whole_solve.py walk_plan): tiles of rows x cols,
// row_blocks x col_blocks of them, the batch in chunks of row_blocks x
// rows rows. Scratch: slots (2, tiles, 4), psum (tiles, rows, HPP) with HPP
// = H+1 rounded up to 4, ctp1g (row_blocks, H, rows), the padded weights
// w2p (col_blocks cols, HPP)
// and w1p (H, col_blocks cols), hdy,
// hdf (B, D; null without saveat), cp2 (6 B ns, D), he (6 B ns, H+2), cp1
// (6 B ns, H), ye (6 B ns, D+2), and the contraction's wpart (wpart_floats
// floats, chunks of chunk_rows rows; weight_cotangents.cu). ks, hs: the
// forward's stage residuals; both null: replay the stages into ks_step (6,
// B, D) and hs_step (6, B, H), with K3's scratch fscratch (as
// regnde_whole_solve_fwd's; null when streaming).
int regnde_whole_solve_bwd(const float* scalars, const float* streams,
                           const float* hy, const float* hf, const float* W1,
                           const float* b1, const float* W2, const float* b2,
                           const float* ks, const float* hs,
                           const float* saveat, int* cursors, float* ct_ys,
                           const float* ct_tel, float* ct_y, float* ct_f,
                           float* cW1, float* cb1, float* cW2, float* cb2,
                           float* ct_scalars, float* slots, float* psum, float* ctp1g,
                           float* hdy,
                           float* hdf, float* ks_step, float* hs_step, float* fscratch,
                           float* w2p, float* w1p, float* cp2,
                           float* he, float* cp1, float* ye, float* wpart, int ns, int B,
                           int D, int H, int S, int n_save, int rows, int cols,
                           int row_blocks, int col_blocks, int chunks, int chunk_rows,
                           int wpart_floats, float rtol, float atol, float beta1,
                           float beta2, float qmin, float qmax, float gamma,
                           float qoldinit, float qsteady_max, void* stream) {
  if (!ks != !hs || (!ks && (!ks_step || !hs_step || !fscratch)) ||
      !plan_ok(rows, cols, row_blocks, col_blocks, chunks, B, D))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Ctrl ctrl = make_ctrl(beta1, beta2, qmin, qmax, gamma, qoldinit, qsteady_max);
  const Walk w{ks_step,   hs_step,    psum,       ctp1g, w2p, w1p,
               rows,      cols,       row_blocks, col_blocks, chunks,
               ks ? Solve{} : solve_carve(fscratch, rows, cols, row_blocks, col_blocks,
                                          chunks, H)};
  const int tiles = row_blocks * col_blocks;
  const size_t smem = walk_smem_bytes(rows, cols, H);
  cudaError_t e;
  if (ks) {
    WalkArgs<true> a{{scalars, streams, hy, hf,
                      MlpDyn<true>{W1, b1, W2, b2, const_cast<float*>(ks),
                                   const_cast<float*>(hs), cp2, he, cp1, ye, H},
                      Saves{saveat, cursors, ct_ys, n_save}, ct_tel, ct_y, ct_f, ct_scalars,
                      slots, hdy, hdf, ns, B, D, S, rtol, atol, ctrl},
                     w};
    e = launch_walk((const void*)mlp_walk_kernel<true>, &a, smem, tiles, s);
  } else {
    WalkArgs<false> a{{scalars, streams, hy, hf,
                       MlpDyn<false>{W1, b1, W2, b2, nullptr, nullptr, cp2, he, cp1, ye, H},
                       Saves{saveat, cursors, ct_ys, n_save}, ct_tel, ct_y, ct_f, ct_scalars,
                       slots, hdy, hdf, ns, B, D, S, rtol, atol, ctrl},
                      w};
    e = launch_walk((const void*)mlp_walk_kernel<false>, &a, smem, tiles, s);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)launch_weight_cotangents(cp2, he, cp1, ye, cW1, cb1, cW2, cb2,
                                       wpart, 6 * B * ns, D, H, chunk_rows,
                                       wpart_floats, s);
}

// K2 (mlp_step_walk.cuh), the normed Tsit5 step's backward, then the weight
// cotangents from its rows. t, dt: scalars on the device; y, k1 and the row
// cotangents of y_new and k7 (B, D) in, and ct_norms (3,) on the device, the
// cotangents of err_ssq, num_ssq, den_ssq; ct_y, ct_k1 (B, D), the weight
// cotangents in nn.Linear layout (cW1 (H, D+1), cb1 (H), cW2 (D, H+1), cb2
// (D)) and ct_tdt (2,) = (ct_t, ct_dt) out. The tile plan as
// regnde_whole_solve_bwd's. Scratch: slots (tiles, 2); psum, ctp1g, w2p,
// w1p, ks_step, hs_step and fscratch as regnde_whole_solve_bwd's when it
// replays; cp2 (6B, D), he (6B, H+2), cp1 (6B, H), ye (6B, D+2), and the
// contraction's wpart (wpart_floats floats, chunks of chunk_rows rows).
int regnde_normed_bwd(const float* t, const float* dt, const float* y, const float* k1,
                      const float* W1, const float* b1, const float* W2, const float* b2,
                      const float* ct_ynew, const float* ct_k7, const float* ct_norms,
                      float* ct_y, float* ct_k1, float* cW1, float* cb1, float* cW2, float* cb2,
                      float* ct_tdt, float* slots, float* psum, float* ctp1g, float* w2p,
                      float* w1p, float* ks_step, float* hs_step, float* fscratch, float* cp2,
                      float* he, float* cp1, float* ye, float* wpart, int B, int D, int H,
                      int rows, int cols, int row_blocks, int col_blocks, int chunks,
                      int chunk_rows, int wpart_floats, float rtol, float atol, void* stream) {
  if (!plan_ok(rows, cols, row_blocks, col_blocks, chunks, B, D))
    return (int)cudaErrorInvalidValue;
  const StepWalkArgs<NormedSeed> args{
      step_walk(W1, b1, W2, b2, ct_y, ct_k1, psum, ctp1g, w2p, w1p, ks_step, hs_step, fscratch,
                cp2, he, cp1, ye, B, D, H, rows, cols, row_blocks, col_blocks, chunks, rtol,
                atol),
      t, dt, y, k1, ct_ynew, ct_k7, NormedSeed{}, slots, ct_tdt, ct_norms};
  return launch_step_walk(args, cW1, cb1, cW2, cb2, wpart, chunk_rows, wpart_floats, stream);
}

// K13 (mlp_step_solve.cuh), the tuple Tsit5 step: t, dt scalars on the
// device; y, k1 (B, D) in; the rows y_new, k7, err, k6, g6 (B, D) out. The
// tile plan as regnde_whole_solve_bwd's; scratch: K3's
// (regnde_solve_scratch_floats floats).
int regnde_mlp_tsit5_fwd(const float* t, const float* dt, const float* y, const float* k1,
                         const float* W1, const float* b1, const float* W2, const float* b2,
                         float* y_new, float* k7, float* err, float* k6, float* g6,
                         float* scratch, int B, int D, int H, int rows, int cols,
                         int row_blocks, int col_blocks, int chunks, void* stream) {
  return launch_step_solve(t, dt, y, k1, W1, b1, W2, b2, TupleEnd{y_new, k7, err, k6, g6},
                           scratch, B, D, H, rows, cols, row_blocks, col_blocks, chunks,
                           stream);
}

// K1 (mlp_step_solve.cuh), the normed Tsit5 step: as regnde_mlp_tsit5_fwd,
// with the rows y_new, k7 (B, D) and sums (3,) = (err_ssq, num_ssq,
// den_ssq) out at the norms' tolerances rtol, atol; the per-tile slots of
// the sums in the scratch.
int regnde_normed_fwd(const float* t, const float* dt, const float* y, const float* k1,
                      const float* W1, const float* b1, const float* W2, const float* b2,
                      float* y_new, float* k7, float* sums, float* scratch, int B, int D,
                      int H, int rows, int cols, int row_blocks, int col_blocks, int chunks,
                      float rtol, float atol, void* stream) {
  return launch_step_solve(t, dt, y, k1, W1, b1, W2, b2,
                           NormedEnd{y_new, k7, sums, rtol, atol}, scratch, B, D, H, rows,
                           cols, row_blocks, col_blocks, chunks, stream);
}

// K11 (mlp_step_solve.cuh with LaneEnd), the lane-wise Tsit5 step: as
// regnde_mlp_tsit5_fwd with t and dt (B,) on the device, every row at its
// own, on K12's tile plan; scratch: regnde_lanes_solve_scratch_floats
// floats; the shared memory of regnde_lanes_solve_smem_bytes.
int regnde_lanes_fwd(const float* t, const float* dt, const float* y, const float* k1,
                     const float* W1, const float* b1, const float* W2, const float* b2,
                     float* y_new, float* k7, float* err, float* k6, float* g6, float* scratch,
                     int B, int D, int H, int rows, int cols, int row_blocks, int col_blocks,
                     int chunks, void* stream) {
  return launch_step_solve(t, dt, y, k1, W1, b1, W2, b2, LaneEnd{{y_new, k7, err, k6, g6}},
                           scratch, B, D, H, rows, cols, row_blocks, col_blocks, chunks,
                           stream);
}

// K14 (mlp_step_walk.cuh), the tuple Tsit5 step's backward, then the
// weight cotangents from its rows: as regnde_normed_bwd, with the row
// cotangents of (y_new, k7, err, k6, g6) (B, D) in place of those of y_new,
// k7 and the norm sums.
int regnde_mlp_tsit5_bwd(const float* t, const float* dt, const float* y, const float* k1,
                         const float* W1, const float* b1, const float* W2, const float* b2,
                         const float* ct_ynew, const float* ct_k7, const float* ct_err,
                         const float* ct_k6, const float* ct_g6, float* ct_y, float* ct_k1,
                         float* cW1, float* cb1, float* cW2, float* cb2, float* ct_tdt,
                         float* slots, float* psum, float* ctp1g, float* w2p, float* w1p,
                         float* ks_step, float* hs_step, float* fscratch, float* cp2,
                         float* he, float* cp1, float* ye, float* wpart, int B, int D, int H,
                         int rows, int cols, int row_blocks, int col_blocks, int chunks,
                         int chunk_rows, int wpart_floats, void* stream) {
  if (!plan_ok(rows, cols, row_blocks, col_blocks, chunks, B, D))
    return (int)cudaErrorInvalidValue;
  const StepWalkArgs<TupleSeed> args{
      step_walk(W1, b1, W2, b2, ct_y, ct_k1, psum, ctp1g, w2p, w1p, ks_step, hs_step, fscratch,
                cp2, he, cp1, ye, B, D, H, rows, cols, row_blocks, col_blocks, chunks, 0.0f,
                0.0f),
      t, dt, y, k1, ct_ynew, ct_k7, TupleSeed{{ct_err, ct_k6, ct_g6}}, slots, ct_tdt, nullptr};
  return launch_step_walk(args, cW1, cb1, cW2, cb2, wpart, chunk_rows, wpart_floats, stream);
}

// K12 (mlp_step_walk.cuh with LaneSeed), the lane-wise Tsit5 step's
// backward, then the weight cotangents from its rows: as regnde_mlp_tsit5_bwd
// with t and dt (B,) on the device, every row at its own; ct_tdt (2, B): the
// rows' ct_t, then their ct_dt; slots (chunks * row_blocks * rows,
// col_blocks); the shared memory of regnde_lanes_walk_smem_bytes.
int regnde_lanes_bwd(const float* t, const float* dt, const float* y, const float* k1,
                     const float* W1, const float* b1, const float* W2, const float* b2,
                     const float* ct_ynew, const float* ct_k7, const float* ct_err,
                     const float* ct_k6, const float* ct_g6, float* ct_y, float* ct_k1,
                     float* cW1, float* cb1, float* cW2, float* cb2, float* ct_tdt,
                     float* slots, float* psum, float* ctp1g, float* w2p, float* w1p,
                     float* ks_step, float* hs_step, float* fscratch, float* cp2, float* he,
                     float* cp1, float* ye, float* wpart, int B, int D, int H, int rows,
                     int cols, int row_blocks, int col_blocks, int chunks, int chunk_rows,
                     int wpart_floats, void* stream) {
  if (!plan_ok(rows, cols, row_blocks, col_blocks, chunks, B, D))
    return (int)cudaErrorInvalidValue;
  const StepWalkArgs<LaneSeed> args{
      step_walk(W1, b1, W2, b2, ct_y, ct_k1, psum, ctp1g, w2p, w1p, ks_step, hs_step, fscratch,
                cp2, he, cp1, ye, B, D, H, rows, cols, row_blocks, col_blocks, chunks, 0.0f,
                0.0f),
      t, dt, y, k1, ct_ynew, ct_k7, LaneSeed{{ct_err, ct_k6, ct_g6}}, slots, ct_tdt, nullptr};
  return launch_step_walk(args, cW1, cb1, cW2, cb2, wpart, chunk_rows, wpart_floats, stream);
}

// K4 for AlternatingMLP on kAltBwdRows-row tiles (one a block at B <=
// kAltBwdRows x the grid), then the sum of its blocks' weight-cotangent
// slots in block order. Arguments as regnde_whole_solve_bwd; partials: (2,
// ceil(B/R), 4), R = kAltBwdRows; out: (leaf_floats,) the leaves'
// cotangents in order (nn.Linear layout); slots: pad4(ceil(B/R) x
// leaf_floats) + ceil(B/R) x alt_reverse_records floats of scratch
// (AltDyn).
int regnde_whole_solve_altmlp_bwd(const float* scalars, const float* streams,
                                  const float* hy, const float* hf,
                                  const float* const* leaves, int depth,
                                  const float* saveat, int* cursors,
                                  float* ct_ys, const float* ct_tel,
                                  float* ct_y, float* ct_f, float* out,
                                  float* ct_scalars, float* partials,
                                  float* hdy, float* hdf, float* slots, int ns,
                                  int B, int D, int H, int S, int n_save,
                                  float rtol, float atol, float beta1,
                                  float beta2, float qmin, float qmax,
                                  float gamma, float qoldinit,
                                  float qsteady_max, void* stream) {
  if (depth < 1 || 4 * depth > kMaxLeaves) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdArgs<AltDyn> a{scalars, streams, hy, hf,
                    AltDyn{pack_leaves(leaves, depth), slots, depth, H},
                    Saves{saveat, cursors, ct_ys, n_save}, ct_tel, ct_y, ct_f,
                    ct_scalars, partials, hdy, hdf, ns, B, D, S, rtol, atol,
                    make_ctrl(beta1, beta2, qmin, qmax, gamma, qoldinit, qsteady_max)};
  int grid = 0;
  cudaError_t e = launch_cooperative((const void*)whole_solve_bwd_kernel<AltDyn>, &a,
                                     altmlp_bwd_smem_bytes(depth, D, H),
                                     (B + kAltBwdRows - 1) / kAltBwdRows, s, &grid);
  if (e != cudaSuccess) return (int)e;
  const int width = leaf_floats(depth, D, H);
  sum_slots_kernel<<<(width + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      slots, grid, width, out);
  return (int)cudaGetLastError();
}

// K3 for FFJORD's CSL dynamics: as regnde_whole_solve_altmlp_fwd with the
// leaves as a host array of 16 device pointers (the 15 parameters of
// CSLDynamics, then the probe e, B x dim) and the kinetic flag; A is the
// augmented state's width, dim + 1 or dim + 3. One block an 8-row tile
// (the grid is ceil(B/8) where the card holds it); partials: (2, ceil(B/2),
// 3), a slot a 2-row sub-tile.
int regnde_whole_solve_csl_fwd(const float* scalars, const float* y0,
                               const float* f0, const float* const* leaves,
                               int kinetic, const float* saveat, int* cursors,
                               float* ys, float* y1, float* hy, float* hf,
                               float* streams, float* final_, float* partials,
                               int B, int A, int H, int S, int n_save, float rtol,
                               float atol, float beta1, float beta2, float qmin,
                               float qmax, float gamma, float qoldinit,
                               float qsteady_max, void* stream) {
  const int dim = A - 1 - 2 * kinetic;
  FwdArgs<CslDyn> a{scalars, y0, f0, CslDyn{pack_csl_leaves(leaves), nullptr, dim, H, kinetic},
                    Saves{saveat, cursors, ys, n_save}, y1, hy, hf, streams,
                    final_, partials, B, A, S, rtol, atol,
                    make_ctrl(beta1, beta2, qmin, qmax, gamma, qoldinit, qsteady_max)};
  return (int)launch_cooperative((const void*)whole_solve_fwd_kernel<CslDyn>, &a,
                                 csl_fwd_smem_bytes(A, dim, H),
                                 (B + kCslBwdRows - 1) / kCslBwdRows,
                                 static_cast<cudaStream_t>(stream), nullptr);
}

// K3-CSL's cooperative grid at B x A x H (kinetic as above): one block a
// tile where the card holds them all, else as many as it holds; minus the
// CUDA error code if the card cannot say.
int regnde_whole_solve_csl_fwd_grid(int B, int A, int H, int kinetic) {
  const int dim = A - 1 - 2 * kinetic;
  int capacity = 0;
  const cudaError_t e = cooperative_capacity((const void*)whole_solve_fwd_kernel<CslDyn>,
                                             csl_fwd_smem_bytes(A, dim, H), &capacity);
  if (e != cudaSuccess) return -(int)e;
  return min(capacity, (B + kCslBwdRows - 1) / kCslBwdRows);
}

// K4 for FFJORD's CSL dynamics on 8-row tiles (one a block at B <= 8 x the
// grid), then the sum of its blocks' parameter-cotangent slots in block
// order. Arguments as regnde_whole_solve_altmlp_bwd with the leaves and
// kinetic flag of regnde_whole_solve_csl_fwd; partials: (2, ceil(B/8), 4);
// out: (csl_leaf_floats,) the parameters' cotangents in order (the probe
// has none); slots: pad4(ceil(B/8) x csl_leaf_floats) + ceil(B/8) x
// csl_reverse_records floats of scratch (CslDyn).
int regnde_whole_solve_csl_bwd(const float* scalars, const float* streams,
                               const float* hy, const float* hf,
                               const float* const* leaves, int kinetic,
                               const float* saveat, int* cursors, float* ct_ys,
                               const float* ct_tel, float* ct_y, float* ct_f,
                               float* out, float* ct_scalars, float* partials,
                               float* hdy, float* hdf, float* slots, int ns, int B,
                               int A, int H, int S, int n_save, float rtol,
                               float atol, float beta1, float beta2, float qmin,
                               float qmax, float gamma, float qoldinit,
                               float qsteady_max, void* stream) {
  const int dim = A - 1 - 2 * kinetic;
  if (csl_cw_tiles(dim, H) > kCslCwTiles * kThreads) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdArgs<CslDyn> a{scalars, streams, hy, hf,
                    CslDyn{pack_csl_leaves(leaves), slots, dim, H, kinetic},
                    Saves{saveat, cursors, ct_ys, n_save}, ct_tel, ct_y, ct_f,
                    ct_scalars, partials, hdy, hdf, ns, B, A, S, rtol, atol,
                    make_ctrl(beta1, beta2, qmin, qmax, gamma, qoldinit, qsteady_max)};
  int grid = 0;
  cudaError_t e = launch_cooperative((const void*)whole_solve_bwd_kernel<CslDyn>, &a,
                                     csl_bwd_smem_bytes(A, dim, H),
                                     (B + kCslBwdRows - 1) / kCslBwdRows, s, &grid);
  if (e != cudaSuccess) return (int)e;
  const int width = csl_leaf_floats(dim, H);
  sum_slots_kernel<<<(width + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      slots, grid, width, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
