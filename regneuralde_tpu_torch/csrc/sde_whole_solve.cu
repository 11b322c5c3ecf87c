// The whole adaptive SRI solve of a diagonal-noise SDE on Hopper: one
// persistent cooperative kernel for the forward (K9) and one for the
// reverse walk of its history (K10), generic over the tile body of the
// drift/diffusion pair: sri_mlp.cuh's MlpPair (the MNIST Neural SDE) and
// sri_cubic.cuh's CubicPair (the toy 2-D SDE's cubic drift), each with its
// own pair of extern "C" entry points.
//
// Replaces the TPU kernels
//   K9:  regneuralde_tpu/ops/pallas_sde.py  make_sde_whole_solve.make_fwd_kernel
//   K10: regneuralde_tpu/ops/pallas_sde.py  make_sde_whole_solve.make_bwd_kernel
// The TPU K10 traces jax.vjp of the trial step inside the kernel; there is
// no tracer here, so K10 is the hand pullback of the same step (its plain
// version is ops/sde_whole_solve.py _sde_step_bwd_math).
//
// What bounds it on this card. At the MNIST Neural SDE's width (B = 512,
// D = 32, drift 32 -> 64 -> 32, diffusion 32 -> 32, SOSRI2: four drift and
// four diffusion evaluations a trial step) a forward trial step is about 21
// MFLOP over 21 KB of leaves, a few microseconds of the card's f32 rate;
// the bound is latency: about a dozen dependent layers a trial step, each
// ending in a block barrier, and one grid-wide decision (accept and the
// next dt hang on three sums over the whole batch). What the kernel saves
// against a host-driven loop is the host: no launch, no flag read back and
// no scalar chain on the host between trial steps.
//
// What the design does about it (K3/K4's design, whole_solve.cu).
//   * Each block owns the same row tiles of kSdeRows rows for the whole
//     solve. The carry lives in global memory, in the history: hy, hw, hz
//     row i hold the state and the Brownian tail at the start of trial step
//     i. Each tile reads its rows of the presampled draws xi_w[i], xi_z[i],
//     runs the collapse bridge, the SRI stages, y_new and the natural-
//     embedding error, writes y_new, dW, dZ into row i + 1 and its three
//     partial sums (the scaled error's squares, |f_b - f_a|^2, |H0_b -
//     H0_a|^2) to a per-tile slot double-buffered by step parity, then
//     grid.sync(). Every block sums the slots in tile order and runs the
//     scalar chain (norms, PI controller, time and tail update) in one
//     thread, redundantly; then each tile fixes its rows up: an accepted
//     step turns dW, dZ into the tail's remainder and writes the saveat rows
//     in its window (the linear save cursor, every block's own copy in
//     shared memory), a rejected one copies its start state forward.
//   * K10 walks the trial steps in reverse. Per step every block pulls the
//     scalar chain back in one thread (post_bwd, from the stored sums and
//     accept flag), each tile recomputes its stages from (y_i, tail_i,
//     xi_i) and runs the row pullback; the per-row contributions to the
//     scalar cotangents (of t from the saves, of dt_eff, of sqrt(dt_eff),
//     of the bridge's frac and std) are per-tile slots summed in tile order
//     after a grid.sync(). The leaves' cotangents accumulate in each
//     block's shared memory over the whole walk (one owner an element) and
//     one sum_slots_kernel pass adds the blocks in block order.
// No floating-point atomics, no TF32, no fast math: runs are bitwise
// reproducible. This file is compiled with -fmad=false (ops/_cuda.py), so
// every multiply and add of the step's algebra rounds on its own, as the
// separate ATen ops of the plain version do on the card; the only fused
// multiply-adds are the explicit fma/fmaf of the products. The scalar chain
// rounds as ATen runs ops/sde.py sde_post on 0-d CUDA tensors: a tensor
// divided by a Python float is multiplied by the float reciprocal, pow by
// 0.5 is sqrt and pow by 0 is 1.

#include <cooperative_groups.h>

#include <initializer_list>

#include "coop.cuh"
#include "sri_cubic.cuh"
#include "sri_mlp.cuh"

namespace cg = cooperative_groups;

namespace {

// Rows of the (12, S) stream buffer (ops/sde_whole_solve.py).
enum { ST_T, ST_DT, ST_QOLD, ST_H, ST_E, ST_N, ST_D, ST_ACC, TEL_T, TEL_DT,
       TEL_EEST, TEL_EIGEN, N_STREAMS };

constexpr int kStages = 4;
constexpr float kEestFloor = 1e-10f;  // ops/controller.py _EEST_FLOOR
constexpr float kTiny = 1e-30f;

// An SRI tableau (ops/sri.py) as the kernels read it: the coefficients cast
// to float as ATen casts a Python float against a float32 tensor, delta *
// e_drift multiplied in double first (as Python does), and the static stage
// analysis: f_src[i] is the stage whose drift value stage i uses (itself,
// or the earlier stage it aliases; -1 when unused), likewise g_src;
// coef[i] says whether g_i enters y_new; (ia, ib) are the eigen proxy's
// stages.
struct SriTab {
  float A0[kStages][kStages], A1[kStages][kStages], B0[kStages][kStages],
      B1[kStages][kStages];
  float alpha[kStages], beta[kStages][4], dE[kStages], en[kStages];
  int f_src[kStages], g_src[kStages], coef[kStages], ia, ib;
};

SriTab pack_tab(const float* f, const int* n) {
  SriTab t;
  int k = 0;
  for (auto* m : {&t.A0, &t.A1, &t.B0, &t.B1})
    for (int i = 0; i < kStages; ++i)
      for (int j = 0; j < kStages; ++j) (*m)[i][j] = f[k++];
  for (int i = 0; i < kStages; ++i) t.alpha[i] = f[k++];
  for (int i = 0; i < kStages; ++i)
    for (int q = 0; q < 4; ++q) t.beta[i][q] = f[k++];
  for (int i = 0; i < kStages; ++i) t.dE[i] = f[k++];
  for (int i = 0; i < kStages; ++i) t.en[i] = f[k++];
  k = 0;
  for (int i = 0; i < kStages; ++i) t.f_src[i] = n[k++];
  for (int i = 0; i < kStages; ++i) t.g_src[i] = n[k++];
  for (int i = 0; i < kStages; ++i) t.coef[i] = n[k++];
  k += 3 * kStages;  // reserved
  t.ia = n[k++];
  t.ib = n[k++];
  return t;
}

struct Ctrl {
  float beta1, beta2, qmin, qmax, gamma, qoldinit, qsteady_max;
};

// ctrl.propose's powers as ATen computes them: x ** 0.5 is sqrt, x ** 0 is 1.
__device__ __forceinline__ float ctrl_pow(float x, float p) {
  return p == 0.5f ? sqrtf(x) : (p == 0.0f ? 1.0f : powf(x, p));
}

struct Post {
  float t_new, dt_next, qold_next, t_end, eest, eigen;
  bool accept;
};

// The scalar chain of one trial step (ops/sde.py sde_post), rounded as ATen
// runs it on 0-d CUDA tensors.
__device__ Post sde_post_fwd(const Ctrl& c, float count, float t, float dt_eff, float qold,
                             float e, float n, float d, float t1, float span, bool is_last) {
  Post p;
  const float inv_count = 1.0f / count;
  const float inv_gamma = 1.0f / c.gamma;
  p.eest = e > 0.0f ? sqrtf(e * inv_count) : 0.0f;
  const float num = n > 0.0f ? sqrtf(n * inv_count) : 0.0f;
  const float den = d > 0.0f ? sqrtf(d * inv_count) : 0.0f;
  p.eigen = den > 0.0f ? num / fmaxf(den, kTiny) : 0.0f;
  p.accept = p.eest <= 1.0f;
  const float q11 = ctrl_pow(fmaxf(p.eest, kEestFloor), c.beta1);
  const float q = q11 / ctrl_pow(qold, c.beta2);
  float qa = fminf(fmaxf(q * inv_gamma, 1.0f / c.qmax), 1.0f / c.qmin);
  if (c.qsteady_max > 1.0f && qa >= 1.0f && qa <= c.qsteady_max) qa = 1.0f;
  const float dt0 = p.accept ? dt_eff / qa : dt_eff / fminf(1.0f / c.qmin, q11 * inv_gamma);
  p.qold_next = p.accept ? fmaxf(p.eest, c.qoldinit) : qold;
  p.dt_next = fminf(dt0, span);
  p.t_end = is_last ? t1 : t + dt_eff;
  p.t_new = p.accept ? p.t_end : t;
  return p;
}

// Autograd's pullbacks of maximum(a, b) / minimum(a, b) to a.
__device__ __forceinline__ float max_grad(float a, float b, float g) {
  return a > b ? g : (a == b ? g / 2.0f : 0.0f);
}
__device__ __forceinline__ float min_grad(float a, float b, float g) {
  return a < b ? g : (a == b ? g / 2.0f : 0.0f);
}

struct PostGrads {
  float t, dt_eff, qold, e, n, d, t1, span;
};

// Hand pullback of sde_post_fwd, the algebra of ops/sde_whole_solve.py
// sde_post_bwd line by line; accept is the stored flag.
__device__ PostGrads sde_post_bwd(const Ctrl& c, float count, float dt_eff, float qold,
                                  float e, float n, float d, float span, bool is_last,
                                  bool accept, float c_tnew, float c_dtn, float c_qn,
                                  float c_tend, float c_eest, float c_eig) {
  const bool pe = e > 0.0f, pn = n > 0.0f, pd = d > 0.0f;
  const float eest = pe ? sqrtf(e / count) : 0.0f;
  const float num = pn ? sqrtf(n / count) : 0.0f;
  const float den = pd ? sqrtf(d / count) : 0.0f;
  const float mden = fmaxf(den, kTiny);
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

  PostGrads g;
  const float g_tend = c_tend + (accept ? c_tnew : 0.0f);
  g.t = accept ? 0.0f : c_tnew;
  g.t1 = is_last ? g_tend : 0.0f;
  const float g_lin = is_last ? 0.0f : g_tend;
  g.t = g.t + g_lin;
  g.dt_eff = g_lin;
  // dt_next = minimum(dt0, span)
  const float g_dt0 = min_grad(dt0, span, c_dtn);
  g.span = min_grad(span, dt0, c_dtn);
  g.qold = accept ? 0.0f : c_qn;
  float g_eest = c_eest + max_grad(eest, c.qoldinit, accept ? c_qn : 0.0f);
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
  const float g_ratio = den > 0.0f ? c_eig : 0.0f;
  const float g_num = g_ratio / mden;
  const float g_den = max_grad(den, kTiny, -g_ratio * ((num / mden) / mden));
  g.e = pe ? (g_eest / (2.0f * eest)) / count : 0.0f;
  g.n = pn ? (g_num / (2.0f * num)) / count : 0.0f;
  g.d = pd ? (g_den / (2.0f * den)) / count : 0.0f;
  return g;
}

// The collapse bridge's scalars of a trial step (ops/sde.py
// _sample_increment): dW = frac tail_w + std xi_w.
struct Bridge {
  bool inside;
  float safe_h, frac, var0, var, std;
};

__device__ Bridge bridge_of(float dt_eff, float h) {
  Bridge b;
  b.safe_h = fmaxf(h, kTiny);
  b.inside = dt_eff < h;
  b.frac = b.inside ? dt_eff / b.safe_h : 1.0f;
  b.var0 = b.inside ? dt_eff * (h - dt_eff) / b.safe_h : fmaxf(dt_eff - h, 0.0f);
  b.var = fmaxf(b.var0, 0.0f);
  b.std = b.var > 0.0f ? sqrtf(b.var) : 0.0f;
  return b;
}

// Pullback of bridge_of for the cotangents of frac and std: adds to
// *g_dteff and *g_h (ops/sde_whole_solve.py bridge_scalars_bwd).
__device__ void bridge_bwd(const Bridge& b, float dt_eff, float h, float g_frac, float g_std,
                           float* g_dteff, float* g_h) {
  float gd = b.inside ? g_frac / b.safe_h : 0.0f;
  float g_safe = b.inside ? -g_frac * ((dt_eff / b.safe_h) / b.safe_h) : 0.0f;
  const float g_var = b.var > 0.0f ? g_std / (2.0f * b.std) : 0.0f;
  const float g_var0 = max_grad(b.var0, 0.0f, g_var);
  const float g_p = b.inside ? g_var0 / b.safe_h : 0.0f;
  const float p = dt_eff * (h - dt_eff);
  g_safe = g_safe - (b.inside ? g_var0 * ((p / b.safe_h) / b.safe_h) : 0.0f);
  gd = gd + g_p * (h - dt_eff) - g_p * dt_eff;
  float gh = g_p * dt_eff;
  const float g_m = max_grad(dt_eff - h, 0.0f, b.inside ? 0.0f : g_var0);
  *g_dteff += gd + g_m;
  *g_h += gh - g_m + max_grad(h, kTiny, g_safe);
}

// The per-step scalars every thread of a tile needs.
struct StepScalars {
  float dt_eff, frac, std, sqdt;
};

// Shared memory of one tile (floats, after the body's leaves and, in the
// backward, their cotangents). n = kSdeRows * D.
//   forward:  15 row arrays (y, tw, tz, xw, xz, dw, dz, i11, i10, i111, H1,
//             and F, G, H0 per stage: 12 more), 2 network buffers, 3 * kWarps
//   backward: the forward's, the stages' hidden activations, 14 more row
//             arrays of cotangents and 5 * kWarps
template <class Pair>
__host__ __device__ int sde_fwd_tile_floats(const Pair& pr, int D) {
  const int n = kSdeRows * D;
  return (11 + 3 * kStages) * n + 2 * kSdeRows * pr.max_width() + 3 * kWarps;
}

template <class Pair>
__host__ __device__ int sde_bwd_tile_floats(const Pair& pr, int D) {
  const int n = kSdeRows * D;
  return (11 + 4 * kStages) * n + kStages * (pr.hidden_floats(0) + pr.hidden_floats(1)) +
         (14 + 3 * kStages) * n + 2 * kSdeRows * pr.max_width() + 5 * kWarps;
}

// The forward recompute of one trial step on a tile: loads the rows (zero
// past the batch end) and runs the Itô coefficients and the stages. With
// acts (K10) each evaluated stage keeps its hidden activations there (stage
// i's drift at acts + i * hf, its diffusion at acts + kStages * hf + i *
// hg). Ends synchronised.
struct TileFwd {
  float *y, *tw, *tz, *xw, *xz, *dw, *dz, *i11, *i10, *i111, *h1;
  float *F[kStages], *G[kStages], *H0[kStages], *H1[kStages];
  float *bufa, *bufb;
};

template <class Pair>
__device__ void sri_stages(const Pair& pr, const SriTab& tb, const float* wsm, TileFwd& w,
                           const float* y_g, const float* tw_g, const float* tz_g,
                           const float* xw_g, const float* xz_g, int row0, int rows, int D,
                           const StepScalars& sc, float* acts) {
  const int n = kSdeRows * D;
  const float dt = sc.dt_eff;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const bool valid = idx < rows * D;
    const size_t g = (size_t)row0 * D + idx;
    w.y[idx] = valid ? __ldcg(y_g + g) : 0.0f;
    w.tw[idx] = valid ? __ldcg(tw_g + g) : 0.0f;
    w.tz[idx] = valid ? __ldcg(tz_g + g) : 0.0f;
    w.xw[idx] = valid ? xw_g[g] : 0.0f;
    w.xz[idx] = valid ? xz_g[g] : 0.0f;
  }
  __syncthreads();
  // ops/sri.py ito_coefficients, op by op; dz / sqrt(3) is ATen's
  // multiply by the float reciprocal on the card
  const float inv_sqrt3 = 1.0f / 1.7320508075688772f;
  const float dt3 = 3.0f * dt, dt6 = 6.0f * dt;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const float dw = sc.frac * w.tw[idx] + sc.std * w.xw[idx];
    const float dz = sc.frac * w.tz[idx] + sc.std * w.xz[idx];
    w.dw[idx] = dw;
    w.dz[idx] = dz;
    w.i11[idx] = 0.5f * (dw * dw - dt) / sc.sqdt;
    w.i10[idx] = 0.5f * (dw + dz * inv_sqrt3);
    w.i111[idx] = (dw * dw * dw - dt3 * dw) / dt6;
  }
  __syncthreads();
  const int hf = pr.hidden_floats(0), hg = pr.hidden_floats(1);
  for (int i = 0; i < kStages; ++i) {
    if (tb.f_src[i] == i) {
      for (int idx = threadIdx.x; idx < n; idx += kThreads) {
        float h = w.y[idx];
        for (int j = 0; j < i; ++j) {
          if (tb.A0[i][j] != 0.0f) h = h + (tb.A0[i][j] * dt) * w.F[tb.f_src[j]][idx];
          if (tb.B0[i][j] != 0.0f) h = h + (tb.B0[i][j] * w.i10[idx]) * w.G[tb.g_src[j]][idx];
        }
        w.H0[i][idx] = h;
      }
      __syncthreads();
      pr.eval(0, wsm, w.H0[i], w.F[i], acts ? acts + i * hf : nullptr, w.bufa, w.bufb);
    }
    if (tb.g_src[i] == i) {
      float* h1 = w.H1[i] ? w.H1[i] : w.h1;
      for (int idx = threadIdx.x; idx < n; idx += kThreads) {
        float h = w.y[idx];
        for (int j = 0; j < i; ++j) {
          if (tb.A1[i][j] != 0.0f) h = h + (tb.A1[i][j] * dt) * w.F[tb.f_src[j]][idx];
          if (tb.B1[i][j] != 0.0f) h = h + (tb.B1[i][j] * sc.sqdt) * w.G[tb.g_src[j]][idx];
        }
        h1[idx] = h;
      }
      __syncthreads();
      pr.eval(1, wsm, h1, w.G[i], acts ? acts + kStages * hf + i * hg : nullptr, w.bufa,
              w.bufb);
    }
  }
}

// y_new and the natural-embedding error of element idx, op by op as
// ops/sri.py sri_step.
__device__ __forceinline__ void sri_combine(const SriTab& tb, const TileFwd& w, int idx,
                                            float dt, float* y_new, float* err) {
  float v = w.y[idx];
  for (int i = 0; i < kStages; ++i)
    if (tb.alpha[i] != 0.0f) v = v + (tb.alpha[i] * dt) * w.F[tb.f_src[i]][idx];
  for (int i = 0; i < kStages; ++i) {
    if (!tb.coef[i]) continue;
    const float* b = tb.beta[i];
    const float c = b[0] * w.dw[idx] + b[1] * w.i11[idx] + b[2] * w.i10[idx] +
                    b[3] * w.i111[idx];
    v = v + c * w.G[tb.g_src[i]][idx];
  }
  float e = 0.0f;
  for (int i = 0; i < kStages; ++i)
    if (tb.dE[i] != 0.0f) e = e + (tb.dE[i] * dt) * w.F[tb.f_src[i]][idx];
  for (int i = 0; i < kStages; ++i)
    if (tb.en[i] != 0.0f) e = e + (tb.en[i] * w.i10[idx]) * w.G[tb.g_src[i]][idx];
  *y_new = v;
  *err = e;
}

// Carves the tile's row arrays out of shared memory.
__device__ float* carve_fwd(TileFwd& w, float* p, int n, int W, bool keep_h1) {
  float** rows[] = {&w.y, &w.tw, &w.tz, &w.xw, &w.xz, &w.dw, &w.dz, &w.i11, &w.i10, &w.i111,
                    &w.h1};
  for (float** r : rows) { *r = p; p += n; }
  for (int i = 0; i < kStages; ++i) { w.F[i] = p; p += n; }
  for (int i = 0; i < kStages; ++i) { w.G[i] = p; p += n; }
  for (int i = 0; i < kStages; ++i) { w.H0[i] = p; p += n; }
  for (int i = 0; i < kStages; ++i) {
    if (keep_h1) { w.H1[i] = p; p += n; } else { w.H1[i] = nullptr; }
  }
  w.bufa = p; p += kSdeRows * W;
  w.bufb = p; p += kSdeRows * W;
  return p;
}

// K9's body for one tile: the trial step's rows y_new, dW, dZ (to the
// history's row i + 1) and the three sums of squares to sums_out.
template <class Pair>
__device__ void sde_fwd_tile(const Pair& pr, const SriTab& tb, const float* wsm, float* smem,
                             const float* y_g, const float* tw_g, const float* tz_g,
                             const float* xw_g, const float* xz_g, float* yn_g, float* dw_g,
                             float* dz_g, int row0, int rows, int D, const StepScalars& sc,
                             float rtol, float atol, float* sums_out) {
  const int n = kSdeRows * D;
  TileFwd w;
  float* red = carve_fwd(w, smem, n, pr.max_width(), false);
  sri_stages(pr, tb, wsm, w, y_g, tw_g, tz_g, xw_g, xz_g, row0, rows, D, sc, nullptr);
  float sums[3] = {0.0f, 0.0f, 0.0f};
  const bool eig = tb.ia != tb.ib;
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    float yn, er;
    sri_combine(tb, w, idx, sc.dt_eff, &yn, &er);
    const float yv = w.y[idx];
    const float denom = atol + fmaxf(fabsf(yv), fabsf(yn)) * rtol;
    const float s = er / denom;
    sums[0] += s * s;
    if (eig) {
      const float df = w.F[tb.ib][idx] - w.F[tb.ia][idx];
      const float dh = w.H0[tb.ib][idx] - w.H0[tb.ia][idx];
      sums[1] += df * df;
      sums[2] += dh * dh;
    }
    const size_t g = (size_t)row0 * D + idx;
    yn_g[g] = yn;
    dw_g[g] = w.dw[idx];
    dz_g[g] = w.dz[idx];
  }
  block_sum_to<3>(sums, red, sums_out);
}

// The cotangents K10's tile body carries, in shared memory.
struct TileBwd {
  float *cy, *cyn, *cerr, *cw, *ci11, *ci10, *ci111, *cdw, *cdz, *ctw, *ctz, *cx, *den, *sc;
  float *cF[kStages], *cG[kStages], *cH0[kStages];
};

// The pullback of one stage's network k (output cotangent c_out) and of
// the stage state's lincomb (coefficient rows A, B against the earlier
// stages' F and G, scaled by dt and by brow: i10 for the drift's H0,
// sqrt(dt) for the diffusion's H1). Adds to the carried cotangents and to
// the per-thread partials *p_dt (of dt_eff) and *p_sq (of sqrt(dt_eff)).
template <class Pair>
__device__ void stage_pullback(const Pair& pr, const SriTab& tb, const float* wsm, float* cwsm,
                               const TileFwd& w, TileBwd& c, int k, int i, const float* x,
                               const float* acts, const float* c_out, const float* extra,
                               int n, float dt, float sqdt, float* p_dt, float* p_sq) {
  pr.pullback(k, wsm, cwsm, x, acts, c_out, c.cx, w.bufa, w.bufb);
  const float(*A)[kStages] = k ? tb.A1 : tb.A0;
  const float(*B)[kStages] = k ? tb.B1 : tb.B0;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const float cx = extra ? c.cx[idx] + extra[idx] : c.cx[idx];
    c.cy[idx] = c.cy[idx] + cx;
    for (int j = 0; j < i; ++j) {
      if (A[i][j] != 0.0f) {
        float* cf = c.cF[tb.f_src[j]];
        cf[idx] = cf[idx] + (A[i][j] * dt) * cx;
        *p_dt += A[i][j] * (w.F[tb.f_src[j]][idx] * cx);
      }
      if (B[i][j] != 0.0f) {
        float* cg = c.cG[tb.g_src[j]];
        const float gj = w.G[tb.g_src[j]][idx];
        if (k) {
          cg[idx] = cg[idx] + (B[i][j] * sqdt) * cx;
          *p_sq += B[i][j] * (gj * cx);
        } else {
          cg[idx] = cg[idx] + (B[i][j] * w.i10[idx]) * cx;
          c.ci10[idx] = c.ci10[idx] + B[i][j] * (gj * cx);
        }
      }
    }
  }
  __syncthreads();
}

// K10's body for one tile: the pullback of one trial step (the algebra of
// ops/sde_whole_solve.py _sde_rows_bwd). Seeds: the cotangents of y_out,
// tail_w_out, tail_z_out (ct_y, ct_tw, ct_tz, rows in global memory,
// replaced by those of y, tail_w, tail_z), of the three sums (g_e, g_n,
// g_d), and the saves': rows [lo, hi) of ct_ys, interpolated from (t,
// dt_eff) between y and y_new = hy_next. Adds the leaves' cotangents to
// cwsm and writes the tile's partials (ct_t from the saves, ct_dt_eff,
// ct_sqrt(dt_eff), ct_frac, ct_std) to part_out.
template <class Pair>
__device__ void sde_bwd_tile(const Pair& pr, const SriTab& tb, const float* wsm, float* cwsm,
                             float* smem, const float* y_g, const float* tw_g,
                             const float* tz_g, const float* xw_g, const float* xz_g,
                             const float* hy_next, const float* sa, const float* ct_ys, int lo,
                             int hi, float t, size_t BD, float* ct_y, float* ct_tw,
                             float* ct_tz, int row0, int rows, int D, const StepScalars& sc,
                             bool acc, bool inside, float g_e, float g_n, float g_d,
                             float rtol, float atol, float* part_out) {
  const int n = kSdeRows * D;
  const float dt = sc.dt_eff;
  TileFwd w;
  float* p = carve_fwd(w, smem, n, pr.max_width(), true);
  float* acts = p;
  p += kStages * (pr.hidden_floats(0) + pr.hidden_floats(1));
  TileBwd c;
  float** rows_c[] = {&c.cy, &c.cyn, &c.cerr, &c.cw, &c.ci11, &c.ci10, &c.ci111, &c.cdw,
                      &c.cdz, &c.ctw, &c.ctz, &c.cx, &c.den, &c.sc};
  for (float** r : rows_c) { *r = p; p += n; }
  for (int i = 0; i < kStages; ++i) { c.cF[i] = p; p += n; }
  for (int i = 0; i < kStages; ++i) { c.cG[i] = p; p += n; }
  for (int i = 0; i < kStages; ++i) { c.cH0[i] = p; p += n; }
  float* red = p;

  sri_stages(pr, tb, wsm, w, y_g, tw_g, tz_g, xw_g, xz_g, row0, rows, D, sc, acts);
  float part[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // t, dt_eff, sqrt(dt_eff), frac, std
  const float hd = dt == 0.0f ? 1.0f : dt;
  const bool eig = tb.ia != tb.ib;
  // ---- seeds ----
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    for (int i = 0; i < kStages; ++i) c.cF[i][idx] = c.cG[i][idx] = c.cH0[i][idx] = 0.0f;
    c.cw[idx] = c.ci11[idx] = c.ci10[idx] = c.ci111[idx] = 0.0f;
    if (idx >= rows * D) {  // past the batch end: no seed, so no cotangent
      c.cy[idx] = c.cyn[idx] = c.cerr[idx] = c.cdw[idx] = c.cdz[idx] = c.ctw[idx] =
          c.ctz[idx] = 0.0f;
      continue;
    }
    const size_t g = (size_t)row0 * D + idx;
    const float cyo = __ldcg(ct_y + g), cwo = __ldcg(ct_tw + g), czo = __ldcg(ct_tz + g);
    float cy = acc ? 0.0f : cyo, cyn = acc ? cyo : 0.0f;
    // tail_out = where(accept, where(inside, tail - d, 0), d)
    c.cdw[idx] = acc ? (inside ? -cwo : 0.0f) : cwo;
    c.cdz[idx] = acc ? (inside ? -czo : 0.0f) : czo;
    c.ctw[idx] = acc && inside ? cwo : 0.0f;
    c.ctz[idx] = acc && inside ? czo : 0.0f;
    if (hi > lo) {  // the saves: row = (1 - th) y + th y_new
      const float yv = w.y[idx], ynv = __ldcg(hy_next + g);
      for (int r = lo; r < hi; ++r) {
        const float th = (sa[r] - t) / hd;
        const float gr = __ldcg(ct_ys + (size_t)r * BD + g);
        cy += (1.0f - th) * gr;
        cyn += th * gr;
        const float c_th = gr * (ynv - yv);
        part[0] -= c_th / hd;
        part[1] += dt == 0.0f ? 0.0f : -c_th * th / hd;
      }
    }
    float yn, er;
    sri_combine(tb, w, idx, dt, &yn, &er);
    const float yv = w.y[idx];
    const float ay = fabsf(yv), an = fabsf(yn);
    const float denom = atol + fmaxf(ay, an) * rtol;
    const float s = er / denom;
    const float cs = g_e * 2.0f * s;
    const float cm = -cs * s / denom * rtol;
    cy += (ay > an ? cm : (ay == an ? 0.5f * cm : 0.0f)) * sign_of(yv);
    cyn += (an > ay ? cm : (ay == an ? 0.5f * cm : 0.0f)) * sign_of(yn);
    c.cerr[idx] = cs / denom;
    c.cyn[idx] = cyn;
    c.cy[idx] = cy + cyn;  // y_new = y + ...
    if (eig) {
      const float df = g_n * 2.0f * (w.F[tb.ib][idx] - w.F[tb.ia][idx]);
      const float dh = g_d * 2.0f * (w.H0[tb.ib][idx] - w.H0[tb.ia][idx]);
      c.cF[tb.ib][idx] = df;
      c.cF[tb.ia][idx] = -df;
      c.cH0[tb.ib][idx] = dh;
      c.cH0[tb.ia][idx] = -dh;
    }
  }
  // ---- y_new's and the error's stage weights (each element by its owner) ----
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const float cyn = c.cyn[idx], cerr = c.cerr[idx];
    for (int i = 0; i < kStages; ++i) {
      if (tb.alpha[i] != 0.0f) {
        float* cf = c.cF[tb.f_src[i]];
        cf[idx] = cf[idx] + (tb.alpha[i] * dt) * cyn;
        part[1] += tb.alpha[i] * (w.F[tb.f_src[i]][idx] * cyn);
      }
      if (tb.dE[i] != 0.0f) {
        float* cf = c.cF[tb.f_src[i]];
        cf[idx] = cf[idx] + (tb.dE[i] * dt) * cerr;
        part[1] += tb.dE[i] * (w.F[tb.f_src[i]][idx] * cerr);
      }
      const float gi = tb.g_src[i] >= 0 ? w.G[tb.g_src[i]][idx] : 0.0f;
      if (tb.coef[i]) {
        const float* b = tb.beta[i];
        const float co = b[0] * w.dw[idx] + b[1] * w.i11[idx] + b[2] * w.i10[idx] +
                         b[3] * w.i111[idx];
        float* cg = c.cG[tb.g_src[i]];
        cg[idx] = cg[idx] + co * cyn;
        const float cc = gi * cyn;
        c.cw[idx] += b[0] * cc;
        c.ci11[idx] += b[1] * cc;
        c.ci10[idx] += b[2] * cc;
        c.ci111[idx] += b[3] * cc;
      }
      if (tb.en[i] != 0.0f) {
        float* cg = c.cG[tb.g_src[i]];
        cg[idx] = cg[idx] + (tb.en[i] * w.i10[idx]) * cerr;
        c.ci10[idx] += tb.en[i] * (gi * cerr);
      }
    }
  }
  __syncthreads();
  // ---- reverse over the stages ----
  const int hf = pr.hidden_floats(0), hg = pr.hidden_floats(1);
  for (int i = kStages - 1; i >= 0; --i) {
    if (tb.g_src[i] == i)
      stage_pullback(pr, tb, wsm, cwsm, w, c, 1, i, w.H1[i], acts + kStages * hf + i * hg,
                     c.cG[i], nullptr, n, dt, sc.sqdt, &part[1], &part[2]);
    if (tb.f_src[i] == i)
      stage_pullback(pr, tb, wsm, cwsm, w, c, 0, i, w.H0[i], acts + i * hf, c.cF[i],
                     c.cH0[i], n, dt, sc.sqdt, &part[1], &part[2]);
  }
  // ---- the Itô coefficients and the bridge ----
  const float inv_sqrt3 = 1.0f / 1.7320508075688772f;
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const float dw = w.dw[idx], i11 = w.i11[idx], i111 = w.i111[idx];
    const float c11 = c.ci11[idx], c111 = c.ci111[idx], c10 = c.ci10[idx];
    const float cdw = c.cdw[idx] + c.cw[idx] + c11 * (dw / sc.sqdt) + 0.5f * c10 +
                      c111 * ((3.0f * dw * dw - 3.0f * dt) / (6.0f * dt));
    const float cdz = c.cdz[idx] + (0.5f * inv_sqrt3) * c10;
    part[1] += -c11 * (0.5f / sc.sqdt) + c111 * (-3.0f * dw / (6.0f * dt) - i111 / dt);
    part[2] += -c11 * i11 / sc.sqdt;
    part[3] += w.tw[idx] * cdw + w.tz[idx] * cdz;
    part[4] += w.xw[idx] * cdw + w.xz[idx] * cdz;
    const size_t g = (size_t)row0 * D + idx;
    ct_y[g] = c.cy[idx];
    ct_tw[g] = c.ctw[idx] + sc.frac * cdw;
    ct_tz[g] = c.ctz[idx] + sc.frac * cdz;
  }
  block_sum_to<5>(part, red, part_out);
}

template <class Pair>
struct SdeFwdArgs {
  const float* scalars;  // t0, t1, dt0
  const float* y0;
  Pair pair;
  SriTab tab;
  const float* xi_w;  // (S, B, D)
  const float* xi_z;
  const float* sa;  // (n_save,) sorted save times
  int* cursors;     // [0] rows at or before t0 (in), [1] rows written (out)
  float* ys;        // (n_save, B, D): ys_init in, the saves out
  int n_save;
  float* y1;
  float* hy;  // (S+1, B, D): state at the start of each trial step
  float* hw;  // the tail's rows
  float* hz;
  float* streams;   // (12, S), zero on entry
  float* final_;    // t, dt, qold, naccept, nreject, done
  float* partials;  // (2, ntiles, 3)
  int B, D, S;
  float rtol, atol;
  Ctrl ctrl;
};

// K9: the whole forward solve.
template <class Pair>
__global__ void __launch_bounds__(kThreads) sde_whole_solve_fwd_kernel(SdeFwdArgs<Pair> a) {
  extern __shared__ float smem[];
  __shared__ float s_t, s_dt, s_qold, s_h;
  __shared__ int s_na, s_nr, s_done, s_acc, s_inside, s_cur, s_lo, s_hi;
  cg::grid_group grid = cg::this_grid();
  constexpr int R = kSdeRows;
  const int ntiles = (a.B + R - 1) / R;
  const size_t BD = (size_t)a.B * a.D;
  const float t0 = a.scalars[0], t1 = a.scalars[1];
  const float span = t1 - t0;
  const float count = (float)BD;
  float* wsm = smem;
  float* tsm = smem + a.pair.padded_floats();

  a.pair.load(wsm);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * R, n = min(R, a.B - row0) * a.D;
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const size_t g = (size_t)row0 * a.D + idx;
      a.hy[g] = a.y0[g];
      a.hw[g] = 0.0f;
      a.hz[g] = 0.0f;
    }
  }
  if (threadIdx.x == 0) {
    s_t = t0;
    s_dt = a.scalars[2];
    s_qold = a.ctrl.qoldinit;
    s_h = 0.0f;
    s_na = s_nr = 0;
    s_done = span == 0.0f;
    s_cur = a.n_save ? a.cursors[0] : 0;
    s_lo = s_hi = 0;
  }
  __syncthreads();

  int i = 0;
  for (; i < a.S && !s_done; ++i) {
    const float t = s_t, dt = s_dt, h = s_h;
    const float remaining = t1 - t;
    const bool is_last = dt >= remaining;
    const float dt_eff = is_last ? remaining : dt;
    const Bridge br = bridge_of(dt_eff, h);
    const StepScalars sc{dt_eff, br.frac, br.std, sqrtf(dt_eff)};
    float* part = a.partials + (size_t)(i & 1) * ntiles * 3;
    const size_t cur = (size_t)i * BD, nxt = cur + BD;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int row0 = tile * R;
      sde_fwd_tile(a.pair, a.tab, wsm, tsm, a.hy + cur, a.hw + cur, a.hz + cur, a.xi_w + cur,
                   a.xi_z + cur, a.hy + nxt, a.hw + nxt, a.hz + nxt, row0,
                   min(R, a.B - row0), a.D, sc, a.rtol, a.atol, part + 3 * tile);
    }
    grid.sync();
    if (threadIdx.x < 32) {
      float sums[3];
      sum_tiles<3>(part, ntiles, sums);
      if (threadIdx.x == 0) {
        const Post p = sde_post_fwd(a.ctrl, count, t, dt_eff, s_qold, sums[0], sums[1],
                                    sums[2], t1, span, is_last);
        if (blockIdx.x == 0) {
          float* st = a.streams;
          const int S = a.S;
          const float vals[N_STREAMS] = {t, dt, s_qold, h, sums[0], sums[1], sums[2],
                                         p.accept ? 1.0f : 0.0f, p.t_end, dt_eff, p.eest,
                                         p.eigen};
          for (int q = 0; q < N_STREAMS; ++q) st[q * S + i] = vals[q];
        }
        // the save cursor consumes every save time in (t, t_end]
        int hi = s_cur;
        if (p.accept)
          while (hi < a.n_save && a.sa[hi] - p.t_end <= 0.0f) ++hi;
        s_lo = s_cur;
        s_hi = hi;
        s_cur = hi;
        s_acc = p.accept;
        s_inside = br.inside;
        s_t = p.t_new;
        s_dt = p.dt_next;
        s_qold = p.qold_next;
        s_h = p.accept ? (br.inside ? h - dt_eff : 0.0f) : dt_eff;
        if (p.accept) ++s_na; else ++s_nr;
        s_done = p.accept && is_last;
      }
    }
    __syncthreads();
    const float hd = dt_eff == 0.0f ? 1.0f : dt_eff;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int row0 = tile * R, n = min(R, a.B - row0) * a.D;
      for (int idx = threadIdx.x; idx < n; idx += kThreads) {
        const size_t g = (size_t)row0 * a.D + idx;
        if (!s_acc) {  // a rejected step keeps its state; dW, dZ are the new tail
          a.hy[nxt + g] = __ldcg(a.hy + cur + g);
          continue;
        }
        // the accepted step's tail: the remainder inside it, else none
        a.hw[nxt + g] = s_inside ? __ldcg(a.hw + cur + g) - __ldcg(a.hw + nxt + g) : 0.0f;
        a.hz[nxt + g] = s_inside ? __ldcg(a.hz + cur + g) - __ldcg(a.hz + nxt + g) : 0.0f;
        const float y0v = __ldcg(a.hy + cur + g), y1v = __ldcg(a.hy + nxt + g);
        for (int r = s_lo; r < s_hi; ++r) {
          const float th = (a.sa[r] - t) / hd;
          a.ys[(size_t)r * BD + g] = (1.0f - th) * y0v + th * y1v;
        }
      }
    }
    __syncthreads();
  }

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * R, n = min(R, a.B - row0) * a.D;
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const size_t g = (size_t)row0 * a.D + idx;
      a.y1[g] = __ldcg(a.hy + (size_t)i * BD + g);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const float fin[6] = {s_t, s_dt, s_qold, (float)s_na, (float)s_nr, (float)s_done};
    for (int q = 0; q < 6; ++q) a.final_[q] = fin[q];
    if (a.n_save) a.cursors[1] = s_cur;
  }
}

template <class Pair>
struct SdeBwdArgs {
  const float* scalars;  // t0, t1
  const float* streams;  // (12, S), the forward's
  const float* hy;
  const float* hw;
  const float* hz;
  Pair pair;
  SriTab tab;
  const float* xi_w;
  const float* xi_z;
  const float* sa;
  const int* cursors;
  float* ct_ys;  // in: the cotangent of ys; out: of ys_init
  int n_save;
  const float* ct_tel;  // (4, S): t, dt, eest, eigen_est
  float* ct_y;   // in: ct_y1; out: ct_y0
  float* ct_tw;  // zeros in; scratch
  float* ct_tz;
  float* ct_scalars;  // out: ct_t0, ct_t1, ct_dt0
  float* partials;    // (2, ntiles, 5)
  float* slots;       // (grid, leaf floats)
  int ns, B, D, S;
  float rtol, atol;
  Ctrl ctrl;
};

// K10: the reverse walk over K9's ns trial steps.
template <class Pair>
__global__ void __launch_bounds__(kThreads) sde_whole_solve_bwd_kernel(SdeBwdArgs<Pair> a) {
  extern __shared__ float smem[];
  // running cotangents of t, dt, qold, tail_h, and the sums of those of t1, span
  __shared__ float s_ct[6];
  __shared__ PostGrads s_g;
  __shared__ Bridge s_br;
  __shared__ float s_ti, s_dteff, s_h, s_sqdt;
  __shared__ int s_last, s_acc, s_lo, s_hi, s_rcur;
  cg::grid_group grid = cg::this_grid();
  constexpr int R = kSdeRows;
  const int ntiles = (a.B + R - 1) / R;
  const size_t BD = (size_t)a.B * a.D;
  const float t0 = a.scalars[0], t1 = a.scalars[1];
  const float span = t1 - t0;
  const float count = (float)BD;
  const int S = a.S;
  const int cur0 = a.n_save ? a.cursors[0] : 0;
  const int nleaf = a.pair.leaf_floats();
  float* wsm = smem;
  float* cwsm = smem + a.pair.padded_floats();
  float* tsm = cwsm + nleaf;
  a.pair.load(wsm);
  for (int e = threadIdx.x; e < nleaf; e += kThreads) cwsm[e] = 0.0f;
  if (threadIdx.x < 6) s_ct[threadIdx.x] = 0.0f;
  if (threadIdx.x == 0) s_rcur = a.n_save ? a.cursors[1] : 0;
  __syncthreads();

  for (int j = 0; j < a.ns; ++j) {
    const int i = a.ns - 1 - j;
    if (threadIdx.x == 0) {
      const float* st = a.streams;
      const float t_i = st[ST_T * S + i], dt_i = st[ST_DT * S + i], h_i = st[ST_H * S + i];
      const bool is_last = dt_i >= t1 - t_i;
      const float dt_eff = is_last ? t1 - t_i : dt_i;
      const bool acc = st[ST_ACC * S + i] > 0.5f;
      s_g = sde_post_bwd(a.ctrl, count, dt_eff, st[ST_QOLD * S + i], st[ST_E * S + i],
                         st[ST_N * S + i], st[ST_D * S + i], span, is_last, acc, s_ct[0],
                         s_ct[1], s_ct[2], a.ct_tel[0 * S + i], a.ct_tel[2 * S + i],
                         a.ct_tel[3 * S + i]);
      s_br = bridge_of(dt_eff, h_i);
      s_ti = t_i;
      s_dteff = dt_eff;
      s_h = h_i;
      s_sqdt = sqrtf(dt_eff);
      s_last = is_last;
      s_acc = acc;
      // the reverse cursor: an accepted step owns the rows before it whose
      // save time lies after its start
      int lo = s_rcur;
      if (acc)
        while (lo > cur0 && a.sa[lo - 1] - t_i > 0.0f) --lo;
      s_lo = lo;
      s_hi = s_rcur;
      s_rcur = lo;
    }
    __syncthreads();
    const StepScalars sc{s_dteff, s_br.frac, s_br.std, s_sqdt};
    float* part = a.partials + (size_t)(j & 1) * ntiles * 5;
    const size_t cur = (size_t)i * BD;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int row0 = tile * R;
      sde_bwd_tile(a.pair, a.tab, wsm, cwsm, tsm, a.hy + cur, a.hw + cur, a.hz + cur,
                   a.xi_w + cur, a.xi_z + cur, a.hy + cur + BD, a.sa, a.ct_ys, s_lo, s_hi,
                   s_ti, BD, a.ct_y, a.ct_tw, a.ct_tz, row0, min(R, a.B - row0), a.D, sc,
                   s_acc, s_br.inside, s_g.e, s_g.n, s_g.d, a.rtol, a.atol, part + 5 * tile);
    }
    grid.sync();
    if (threadIdx.x < 32) {
      float k[5];
      sum_tiles<5>(part, ntiles, k);
      if (threadIdx.x == 0) {
        const float c_th = s_ct[3];
        float g_dteff = s_g.dt_eff + a.ct_tel[1 * S + i] + k[1] + k[2] / (2.0f * s_sqdt);
        float g_h = 0.0f;
        // tail_h_out = where(accept, where(inside, h - dt_eff, 0), dt_eff)
        if (s_acc) {
          if (s_br.inside) {
            g_h += c_th;
            g_dteff -= c_th;
          }
        } else {
          g_dteff += c_th;
        }
        bridge_bwd(s_br, s_dteff, s_h, k[3], k[4], &g_dteff, &g_h);
        // dt_eff = where(is_last, t1 - t, dt)
        s_ct[0] = s_g.t + k[0] + (s_last ? -g_dteff : 0.0f);
        s_ct[1] = s_last ? 0.0f : g_dteff;
        s_ct[2] = s_g.qold;
        s_ct[3] = g_h;
        s_ct[4] = s_ct[4] + s_g.t1 + (s_last ? g_dteff : 0.0f);
        s_ct[5] = s_ct[5] + s_g.span;
      }
    }
    __syncthreads();
  }
  // the rows the forward wrote pass no cotangent on to ys_init
  if (a.n_save) {
    const int curf = a.cursors[1];
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int row0 = tile * R, n = min(R, a.B - row0) * a.D;
      for (int r = cur0; r < curf; ++r)
        for (int idx = threadIdx.x; idx < n; idx += kThreads)
          a.ct_ys[(size_t)r * BD + (size_t)row0 * a.D + idx] = 0.0f;
    }
  }
  __syncthreads();
  float* slot = a.slots + (size_t)blockIdx.x * nleaf;
  for (int e = threadIdx.x; e < nleaf; e += kThreads) slot[e] = cwsm[e];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    // span = t1 - t0
    a.ct_scalars[0] = s_ct[0] - s_ct[5];
    a.ct_scalars[1] = s_ct[4] + s_ct[5];
    a.ct_scalars[2] = s_ct[1];
  }
}

// The pair from a host array of leaf pointers and the widths [nf, ng, drift
// widths (nf + 1), diffusion widths (ng + 1)]; false if a network has no
// layer or more than kMaxNetLayers, or its ends are not D wide.
bool pack_pair(const float* const* leaves, const int* widths, int D, MlpPair* pr) {
  const int L[2] = {widths[0], widths[1]};
  int w = 2, p = 0;
  for (int k = 0; k < 2; ++k) {
    if (L[k] < 1 || L[k] > kMaxNetLayers) return false;
    MlpNet& n = pr->net[k];
    n.L = L[k];
    for (int l = 0; l <= L[k]; ++l) n.w[l] = widths[w++];
    if (n.w[0] != D || n.w[L[k]] != D) return false;
    for (int q = 0; q < 2 * L[k]; ++q) n.p[q] = leaves[p++];
  }
  return true;
}

// The cubic pair's networks are laid out as the MLP pair's.
bool pack_pair(const float* const* leaves, const int* widths, int D, CubicPair* pr) {
  MlpPair m;
  if (!pack_pair(leaves, widths, D, &m)) return false;
  pr->net[0] = m.net[0];
  pr->net[1] = m.net[1];
  return true;
}

Ctrl make_ctrl(float beta1, float beta2, float qmin, float qmax, float gamma, float qoldinit,
               float qsteady_max) {
  return Ctrl{beta1, beta2, qmin, qmax, gamma, qoldinit, qsteady_max};
}

// K9 for the tile body Pair (the arguments of regnde_sde_whole_solve_fwd).
template <class Pair>
int sde_fwd_entry(const float* scalars, const float* y0, const float* const* leaves,
                  const int* widths, const float* tab_f, const int* tab_i, const float* xi_w,
                  const float* xi_z, const float* saveat, int* cursors, float* ys, float* y1,
                  float* hy, float* hw, float* hz, float* streams, float* final_,
                  float* partials, int B, int D, int S, int n_save, float rtol, float atol,
                  const Ctrl& ctrl, void* stream) {
  SdeFwdArgs<Pair> a{};
  if (!pack_pair(leaves, widths, D, &a.pair)) return (int)cudaErrorInvalidValue;
  a.scalars = scalars; a.y0 = y0; a.tab = pack_tab(tab_f, tab_i);
  a.xi_w = xi_w; a.xi_z = xi_z; a.sa = saveat; a.cursors = cursors; a.ys = ys;
  a.n_save = n_save; a.y1 = y1; a.hy = hy; a.hw = hw; a.hz = hz; a.streams = streams;
  a.final_ = final_; a.partials = partials; a.B = B; a.D = D; a.S = S;
  a.rtol = rtol; a.atol = atol; a.ctrl = ctrl;
  const size_t smem =
      sizeof(float) * ((size_t)a.pair.padded_floats() + sde_fwd_tile_floats(a.pair, D));
  return (int)launch_cooperative((const void*)sde_whole_solve_fwd_kernel<Pair>, &a, smem,
                                 (B + kSdeRows - 1) / kSdeRows,
                                 static_cast<cudaStream_t>(stream), nullptr);
}

// K10 for the tile body Pair, then the sum of its blocks' leaf-cotangent
// slots in block order (the arguments of regnde_sde_whole_solve_bwd).
template <class Pair>
int sde_bwd_entry(const float* scalars, const float* streams, const float* hy,
                  const float* hw, const float* hz, const float* const* leaves,
                  const int* widths, const float* tab_f, const int* tab_i, const float* xi_w,
                  const float* xi_z, const float* saveat, const int* cursors, float* ct_ys,
                  const float* ct_tel, float* ct_y, float* ct_tw, float* ct_tz, float* out,
                  float* ct_scalars, float* partials, float* slots, int ns, int B, int D, int S,
                  int n_save, float rtol, float atol, const Ctrl& ctrl, void* stream) {
  SdeBwdArgs<Pair> a{};
  if (!pack_pair(leaves, widths, D, &a.pair)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  a.scalars = scalars; a.streams = streams; a.hy = hy; a.hw = hw; a.hz = hz;
  a.tab = pack_tab(tab_f, tab_i); a.xi_w = xi_w; a.xi_z = xi_z; a.sa = saveat;
  a.cursors = cursors; a.ct_ys = ct_ys; a.n_save = n_save; a.ct_tel = ct_tel; a.ct_y = ct_y;
  a.ct_tw = ct_tw; a.ct_tz = ct_tz; a.ct_scalars = ct_scalars; a.partials = partials;
  a.slots = slots; a.ns = ns; a.B = B; a.D = D; a.S = S; a.rtol = rtol; a.atol = atol;
  a.ctrl = ctrl;
  const size_t smem = sizeof(float) * ((size_t)a.pair.padded_floats() + a.pair.leaf_floats() +
                                       sde_bwd_tile_floats(a.pair, D));
  int grid = 0;
  cudaError_t e = launch_cooperative((const void*)sde_whole_solve_bwd_kernel<Pair>, &a, smem,
                                     (B + kSdeRows - 1) / kSdeRows, s, &grid);
  if (e != cudaSuccess) return (int)e;
  const int width = a.pair.leaf_floats();
  sum_slots_kernel<<<(width + kThreads - 1) / kThreads, kThreads, 0, s>>>(slots, grid, width,
                                                                        out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int regnde_sde_rows() { return kSdeRows; }

// K9 for the MLP pair. scalars: (3,) t0, t1, dt0 (float32). leaves: host
// array of device pointers, the drift's (W, b) per layer then the
// diffusion's; widths: host array [nf, ng, drift widths, diffusion
// widths]; tab_f, tab_i: the tableau (ops/sde_whole_solve.py
// _tableau_arrays). xi_w, xi_z: (S, B, D) draws. saveat (n_save,), cursors
// (2,), ys (n_save, B, D): null when n_save is 0. hy, hw, hz: (S+1, B, D);
// streams (12, S) zeroed by the caller; final (6,); partials (2,
// ceil(B/4), 3).
int regnde_sde_whole_solve_fwd(const float* scalars, const float* y0,
                               const float* const* leaves, const int* widths,
                               const float* tab_f, const int* tab_i, const float* xi_w,
                               const float* xi_z, const float* saveat, int* cursors, float* ys,
                               float* y1, float* hy, float* hw, float* hz, float* streams,
                               float* final_, float* partials, int B, int D, int S, int n_save,
                               float rtol, float atol, float beta1, float beta2, float qmin,
                               float qmax, float gamma, float qoldinit, float qsteady_max,
                               void* stream) {
  return sde_fwd_entry<MlpPair>(scalars, y0, leaves, widths, tab_f, tab_i, xi_w, xi_z, saveat,
                                cursors, ys, y1, hy, hw, hz, streams, final_, partials, B, D, S,
                                n_save, rtol, atol,
                                make_ctrl(beta1, beta2, qmin, qmax, gamma, qoldinit,
                                          qsteady_max),
                                stream);
}

// K9 for the cubic pair: the arguments of regnde_sde_whole_solve_fwd, the
// drift's widths those of its MLP after the cube (D -> ... -> D).
int regnde_sde_whole_solve_cubic_fwd(
    const float* scalars, const float* y0, const float* const* leaves, const int* widths,
    const float* tab_f, const int* tab_i, const float* xi_w, const float* xi_z,
    const float* saveat, int* cursors, float* ys, float* y1, float* hy, float* hw, float* hz,
    float* streams, float* final_, float* partials, int B, int D, int S, int n_save, float rtol,
    float atol, float beta1, float beta2, float qmin, float qmax, float gamma, float qoldinit,
    float qsteady_max, void* stream) {
  return sde_fwd_entry<CubicPair>(scalars, y0, leaves, widths, tab_f, tab_i, xi_w, xi_z,
                                  saveat, cursors, ys, y1, hy, hw, hz, streams, final_,
                                  partials, B, D, S, n_save, rtol, atol,
                                  make_ctrl(beta1, beta2, qmin, qmax, gamma, qoldinit,
                                            qsteady_max),
                                  stream);
}

// K10 for the MLP pair, then the sum of its blocks' leaf-cotangent slots in
// block order. scalars: (2,) t0, t1; streams, hy, hw, hz, saveat, cursors:
// the forward's; ct_ys (n_save, B, D): the cotangent of ys in, of ys_init
// out. ct_tel (4, S); ct_y: ct_y1 in, ct_y0 out; ct_tw, ct_tz: zeros in
// (B, D), scratch. out: (leaf floats,) the leaves' cotangents in order
// (nn.Linear layout); ct_scalars (3,) ct_t0, ct_t1, ct_dt0 out. Scratch:
// partials (2, ceil(B/4), 5), slots (ceil(B/4), leaf floats).
int regnde_sde_whole_solve_bwd(const float* scalars, const float* streams, const float* hy,
                               const float* hw, const float* hz, const float* const* leaves,
                               const int* widths, const float* tab_f, const int* tab_i,
                               const float* xi_w, const float* xi_z, const float* saveat,
                               const int* cursors, float* ct_ys, const float* ct_tel,
                               float* ct_y, float* ct_tw, float* ct_tz, float* out,
                               float* ct_scalars, float* partials, float* slots, int ns, int B,
                               int D, int S, int n_save, float rtol, float atol, float beta1,
                               float beta2, float qmin, float qmax, float gamma,
                               float qoldinit, float qsteady_max, void* stream) {
  return sde_bwd_entry<MlpPair>(scalars, streams, hy, hw, hz, leaves, widths, tab_f, tab_i,
                                xi_w, xi_z, saveat, cursors, ct_ys, ct_tel, ct_y, ct_tw, ct_tz,
                                out, ct_scalars, partials, slots, ns, B, D, S, n_save, rtol,
                                atol,
                                make_ctrl(beta1, beta2, qmin, qmax, gamma, qoldinit,
                                          qsteady_max),
                                stream);
}

// K10 for the cubic pair: the arguments of regnde_sde_whole_solve_bwd.
int regnde_sde_whole_solve_cubic_bwd(
    const float* scalars, const float* streams, const float* hy, const float* hw,
    const float* hz, const float* const* leaves, const int* widths, const float* tab_f,
    const int* tab_i, const float* xi_w, const float* xi_z, const float* saveat,
    const int* cursors, float* ct_ys, const float* ct_tel, float* ct_y, float* ct_tw,
    float* ct_tz, float* out, float* ct_scalars, float* partials, float* slots, int ns, int B,
    int D, int S, int n_save, float rtol, float atol, float beta1, float beta2, float qmin,
    float qmax, float gamma, float qoldinit, float qsteady_max, void* stream) {
  return sde_bwd_entry<CubicPair>(scalars, streams, hy, hw, hz, leaves, widths, tab_f, tab_i,
                                  xi_w, xi_z, saveat, cursors, ct_ys, ct_tel, ct_y, ct_tw,
                                  ct_tz, out, ct_scalars, partials, slots, ns, B, D, S, n_save,
                                  rtol, atol,
                                  make_ctrl(beta1, beta2, qmin, qmax, gamma, qoldinit,
                                            qsteady_max),
                                  stream);
}

}  // extern "C"
