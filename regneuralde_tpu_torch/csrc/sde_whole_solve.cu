// The whole adaptive SRI solve of a diagonal-noise SDE on Hopper: one
// persistent cooperative kernel for the forward (K9) and one for the
// reverse walk of its history (K10), over one forward and one reverse tile
// body generic over the drift/diffusion pair (sri_mlp.cuh's MlpPair, the
// MNIST Neural SDE's; sri_cubic.cuh's CubicPair, the toy 2-D SDE's cubic
// drift), each pair with its own extern "C" entry points.
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
// the bound is latency: a chain of dependent phases a trial step, each
// ending in a block barrier, and one grid-wide decision (accept and the
// next dt hang on three sums over the whole batch). A phase costs about a
// microsecond at run-time widths and a third of one with the widths known
// to the compiler, so the design counts phases.
//
// What the design does about it.
//   * Each block owns the same row tiles of kSdeRows rows for the whole
//     solve. The carry lives in the history: hy, hw, hz row i hold the
//     state and the Brownian tail at the start of trial step i (keeping it
//     in the tile's shared memory measured no faster,
//     tools/torch_sde_variants.py). Each tile reads its rows of
//     the presampled draws xi_w[i], xi_z[i], runs the collapse bridge, the
//     SRI stages, y_new and the natural-embedding error, writes y_new, dW,
//     dZ into row i + 1 and its three partial sums (the scaled error's
//     squares, |f_b - f_a|^2, |H0_b - H0_a|^2) to a per-tile slot
//     double-buffered by step parity, then grid.sync(). Every block sums
//     the slots in tile order and runs the scalar chain (norms, PI
//     controller, time and tail update) in one thread, redundantly; then
//     each tile fixes its rows up: an accepted step turns dW, dZ into the
//     tail's remainder and writes the saveat rows in its window (the linear
//     save cursor, every block's own copy in shared memory), a rejected one
//     copies its start state forward.
//   * The forward tile body (sde_load, sde_stages): the Itô coefficients and
//     stage 0's states in the load phase; each layer one phase, a stage's
//     drift and diffusion layers side by side (sri_mlp.cuh sde_layer_items:
//     every f64 sum split over lanes, every thread at work); the next
//     stage's states H0, H1 built op by op in the epilogue of the phase that
//     completes the values they read; the stage loops unrolled, so the
//     tableau (SriTab, a kernel parameter) is read at indices the compiler
//     knows and the stages' rows are offsets, never an indexed array of
//     pointers. SOSRI2 at the MNIST widths: a load phase, two phases a
//     stage, the combine (the parent body's element-to-thread assignment and
//     block_sum_to, so every sum, accept, NFE, dt and save cursor is the
//     one before this design gave; each affine map is an f64 sum rounded
//     once, as the plain version's f64 addmm, so the rows differ only where
//     an f64 sum lies within its rounding error of an f32 tie).
//   * Each pair's widths are a compile-time instance (Pair::Fixed: the
//     MNIST NSDE's 32 -> 64 -> 32 and 32 -> 32, the toy's cubic 2 -> 50 -> 2
//     and 2 -> 2); every other pair the wrappers accept runs the generic one
//     (DynWidths).
//   * K10 walks the trial steps in reverse. Per step every block pulls the
//     scalar chain back in one thread (post_bwd, from the stored sums and
//     accept flag); each tile recomputes its stages with K9's body (the
//     same bits) and runs the reverse tile body (sde_bwd_tile): the seeds
//     element by element, then each stage's layers in reverse, one phase a
//     layer, the drift's and the diffusion's side by side, the input
//     cotangents' f64 sums split over lanes, each network's input cotangent
//     pulled through its stage's lincomb in the epilogue that completes it;
//     the Itô coefficients and the bridge last. The per-row contributions to
//     the scalar cotangents (of t from the saves, of dt_eff, of
//     sqrt(dt_eff), of the bridge's frac and std) are per-tile slots summed
//     in tile order after a grid.sync(). The leaves' cotangents stay in the
//     block's shared memory over the whole walk (one owner an element in a
//     layer's phase; in registers they ran slower,
//     tools/torch_sde_variants.py) and one sum_slots_kernel pass adds the
//     blocks in block order. Its order of sums on the CPU is
//     ops/sde_whole_solve.py plain_sde_bwd_tiles.
// No floating-point atomics, no TF32, no fast math: runs are bitwise
// reproducible. This file is compiled with -fmad=false (ops/_cuda.py), so
// every multiply and add of the step's algebra rounds on its own, as the
// separate ATen ops of the plain version do on the card; the only fused
// multiply-adds are the explicit fma of the f64 sums. The scalar chain
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

// The tile's shared memory (rows of R = kSdeRows, n = R * D floats; the f64
// row buffers of a network's input or output at row stride sde_ld0(D), of
// network k's hidden layers at sde_ldh(wd, k), widths rounded up to 4).
// Forward (K9, and K10's recompute): the carry y, tw, tz, the draws xw, xz,
// the increments dw, dz, the Itô coefficients i11, i10, i111; per
// stage (stage i at + i * n) the drift values F, the diffusion values G and
// their states H0, H1; per stage the networks' hidden activations (actf,
// actg); the layers' f64 input rows: layer 0's by stage parity (x0), the
// hidden layers' by layer parity (xh); the warp partials of the block sums.
// Reverse (K10): the row cotangents (cy, cyn, cerr, cwi of dW's
// coefficient, ci11, ci10, ci111, cdw, cdz, ctw, ctz), the per-element
// shares of the scalar cotangents (ep0 of t, ep1 of dt_eff, ep2 of
// sqrt(dt_eff)), a network's input cotangent held for a lincomb phase (cxf,
// cxg), per stage cF, cG, cH0, the f64 copies of a stage's output
// cotangents by stage parity (cod) and the hidden layers' pre-activation
// cotangents by layer parity, f64 (gh) and f32 (ghf); they take the place of
// the recompute's f64 rows, done with before the seeds. Each buffer of a
// pair (network f or g, parity 0 or 1) is a field of its own, picked by a
// select (an indexed pair would put the struct in local memory).
struct SdeTile {
  double *x0f0, *x0f1, *x0g0, *x0g1, *xhf0, *xhf1, *xhg0, *xhg1;
  double *codf0, *codf1, *codg0, *codg1, *ghf0, *ghf1, *ghg0, *ghg1;
  float *gff0, *gff1, *gfg0, *gfg1;
  float *y, *tw, *tz, *xw, *xz, *dw, *dz, *i11, *i10, *i111;
  float *F, *G, *H0, *H1, *actf, *actg, *red;
  float *cy, *cyn, *cerr, *cwi, *ci11, *ci10, *ci111, *cdw, *cdz, *ctw, *ctz, *ep0, *ep1, *ep2,
      *cxf, *cxg, *cF, *cG, *cH0;
  // network k's buffer of parity i
  __device__ double* x0(int k, int i) const {
    return k ? ((i & 1) ? x0g1 : x0g0) : ((i & 1) ? x0f1 : x0f0);
  }
  __device__ double* xh(int k, int i) const {
    return k ? ((i & 1) ? xhg1 : xhg0) : ((i & 1) ? xhf1 : xhf0);
  }
  __device__ double* cod(int k, int i) const {
    return k ? ((i & 1) ? codg1 : codg0) : ((i & 1) ? codf1 : codf0);
  }
  __device__ double* gh(int k, int i) const {
    return k ? ((i & 1) ? ghg1 : ghg0) : ((i & 1) ? ghf1 : ghf0);
  }
  __device__ float* ghf(int k, int i) const {
    return k ? ((i & 1) ? gfg1 : gfg0) : ((i & 1) ? gff1 : gff0);
  }
};

// Hands out consecutive parts of a buffer, each a multiple of 4 floats (at
// least 4) from a 16-byte aligned base; with no base, only counts.
struct SdeCarve {
  float* base;
  int off;
  __host__ __device__ float* f(int floats) {
    float* p = base ? base + off : nullptr;
    off += floats > 0 ? (floats + 3) & ~3 : 4;
    return p;
  }
  __host__ __device__ double* d(int doubles) { return reinterpret_cast<double*>(f(2 * doubles)); }
};

// Floats of the tile (bwd: K10's), with a base its parts' addresses to *t.
template <class Wd>
__host__ __device__ int sde_tile_floats(const Wd& wd, int D, bool bwd, float* base = nullptr,
                                        SdeTile* t = nullptr) {
  constexpr int R = kSdeRows;
  const int n = R * D, p0 = R * sde_ld0(D), pf = R * sde_ldh(wd, 0), pg = R * sde_ldh(wd, 1);
  SdeCarve c{base, 0};
  SdeTile s{};
  s.x0f0 = c.d(p0);
  s.x0f1 = c.d(p0);
  s.x0g0 = c.d(p0);
  s.x0g1 = c.d(p0);
  s.xhf0 = c.d(pf);
  s.xhf1 = c.d(pf);
  s.xhg0 = c.d(pg);
  s.xhg1 = c.d(pg);
  if (bwd) {
    const int fwd_end = c.off;
    c.off = 0;
    s.codf0 = c.d(p0);
    s.codf1 = c.d(p0);
    s.codg0 = c.d(p0);
    s.codg1 = c.d(p0);
    s.ghf0 = c.d(pf);
    s.ghf1 = c.d(pf);
    s.ghg0 = c.d(pg);
    s.ghg1 = c.d(pg);
    s.gff0 = c.f(pf);
    s.gff1 = c.f(pf);
    s.gfg0 = c.f(pg);
    s.gfg1 = c.f(pg);
    c.off = c.off > fwd_end ? c.off : fwd_end;
  }
  s.y = c.f(n);
  s.tw = c.f(n);
  s.tz = c.f(n);
  s.xw = c.f(n);
  s.xz = c.f(n);
  s.dw = c.f(n);
  s.dz = c.f(n);
  s.i11 = c.f(n);
  s.i10 = c.f(n);
  s.i111 = c.f(n);
  s.F = c.f(kStages * n);
  s.G = c.f(kStages * n);
  s.H0 = c.f(kStages * n);
  s.H1 = c.f(kStages * n);
  s.actf = c.f(kStages * sde_hidden_floats(wd, 0));
  s.actg = c.f(kStages * sde_hidden_floats(wd, 1));
  s.red = c.f(5 * kWarps);
  if (bwd) {
    s.cy = c.f(n);
    s.cyn = c.f(n);
    s.cerr = c.f(n);
    s.cwi = c.f(n);
    s.ci11 = c.f(n);
    s.ci10 = c.f(n);
    s.ci111 = c.f(n);
    s.cdw = c.f(n);
    s.cdz = c.f(n);
    s.ctw = c.f(n);
    s.ctz = c.f(n);
    s.ep0 = c.f(n);
    s.ep1 = c.f(n);
    s.ep2 = c.f(n);
    s.cxf = c.f(n);
    s.cxg = c.f(n);
    s.cF = c.f(kStages * n);
    s.cG = c.f(kStages * n);
    s.cH0 = c.f(kStages * n);
  }
  if (t) *t = s;
  return c.off;
}

// Floats of K9's and K10's dynamic shared memory: the leaves (padded rows),
// 4 of slack to align the tile, K10's leaf cotangents (the leaf layout),
// the tile.
template <class Wd>
__host__ __device__ int sde_cs_floats(const Wd& wd) {
  return (sde_leaf_floats(wd, 0) + sde_leaf_floats(wd, 1) + 3) & ~3;
}
template <class Wd>
__host__ __device__ int sde_smem_floats(const Wd& wd, int D, bool bwd) {
  return sde_weight_floats(wd) + 4 + (bwd ? sde_cs_floats(wd) : 0) + sde_tile_floats(wd, D, bwd);
}

// The tile's parts after the leaves (and K10's cotangents), aligned to 16
// bytes by an offset from the shared base, not by a cast through an integer
// (after such a cast every access was a generic one, LD.E for LDS).
template <class Wd>
__device__ __forceinline__ SdeTile sde_tile(const Wd& wd, float* smem, int D, bool bwd) {
  float* p = smem + sde_weight_floats(wd) + (bwd ? sde_cs_floats(wd) : 0);
  const int pad = (4 - ((int)__cvta_generic_to_shared(p) >> 2 & 3)) & 3;
  SdeTile s;
  sde_tile_floats(wd, D, bwd, p + pad, &s);
  return s;
}

// Stage k's states of element idx = (r, c), op by op as ops/sri.py sri_step
// builds them (H0_k from the drift values and i10, H1_k from them and
// sqrt(dt)), each network's with its f64 input row (the cubic pair's drift
// takes the cube, x * x * x as (x * x) * x), for the networks stage k
// evaluates.
template <class Pair>
__device__ __forceinline__ void sde_build(const SriTab& tb, const SdeTile& s, int k, int idx,
                                          int r, int c, int n, int ld0, float dt, float sqdt) {
  const float y = s.y[idx];
  if (tb.f_src[k] == k) {
    float h = y;
#pragma unroll
    for (int j = 0; j < kStages; ++j) {
      if (j >= k) break;
      if (tb.A0[k][j] != 0.0f) h = h + (tb.A0[k][j] * dt) * s.F[tb.f_src[j] * n + idx];
      if (tb.B0[k][j] != 0.0f) h = h + (tb.B0[k][j] * s.i10[idx]) * s.G[tb.g_src[j] * n + idx];
    }
    s.H0[k * n + idx] = h;
    s.x0(0, k)[r * ld0 + c] = (double)(Pair::kCube ? h * h * h : h);
  }
  if (tb.g_src[k] == k) {
    float h = y;
#pragma unroll
    for (int j = 0; j < kStages; ++j) {
      if (j >= k) break;
      if (tb.A1[k][j] != 0.0f) h = h + (tb.A1[k][j] * dt) * s.F[tb.f_src[j] * n + idx];
      if (tb.B1[k][j] != 0.0f) h = h + (tb.B1[k][j] * sqdt) * s.G[tb.g_src[j] * n + idx];
    }
    s.H1[k * n + idx] = h;
    s.x0(1, k)[r * ld0 + c] = (double)h;
  }
}

// The load phase of a trial step on a tile: the carry (from the history,
// zero past the batch end), the draws, the increments and the Itô coefficients (ops/sri.py
// ito_coefficients op by op; dz / sqrt(3) is ATen's multiply by the float
// reciprocal on the card), and stage 0's states.
template <class Pair, class Wd>
__device__ __forceinline__ void sde_load(const Wd& wd, const SriTab& tb, const SdeTile& s,
                                         const float* y_g, const float* tw_g,
                                         const float* tz_g, const float* xw_g,
                                         const float* xz_g, int row0, int rows, int D,
                                         const StepScalars& sc) {
  constexpr int R = kSdeRows;
  const int n = R * D, ld0 = sde_ld0(D);
  const float dt = sc.dt_eff;
  const float inv_sqrt3 = 1.0f / 1.7320508075688772f;
  const float dt3 = 3.0f * dt, dt6 = 6.0f * dt;
  __syncthreads();  // the previous trial step's (or tile's) last reads
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const bool valid = idx < rows * D;
    const size_t g = (size_t)row0 * D + idx;
    s.y[idx] = valid ? __ldcg(y_g + g) : 0.0f;
    const float tw = valid ? __ldcg(tw_g + g) : 0.0f, tz = valid ? __ldcg(tz_g + g) : 0.0f;
    s.tw[idx] = tw;
    s.tz[idx] = tz;
    const float xw = valid ? xw_g[g] : 0.0f, xz = valid ? xz_g[g] : 0.0f;
    s.xw[idx] = xw;
    s.xz[idx] = xz;
    const float dw = sc.frac * tw + sc.std * xw;
    const float dz = sc.frac * tz + sc.std * xz;
    s.dw[idx] = dw;
    s.dz[idx] = dz;
    s.i11[idx] = 0.5f * (dw * dw - dt) / sc.sqdt;
    s.i10[idx] = 0.5f * (dw + dz * inv_sqrt3);
    s.i111[idx] = (dw * dw * dw - dt3 * dw) / dt6;
    const int r = idx / D;
    sde_build<Pair>(tb, s, 0, idx, r, idx - r * D, n, ld0, dt, sc.sqdt);
  }
}

// Runs phase(p) for the p < np layer phases of a stage: unrolled where the
// widths are constants (every index of a phase then folds), one rolled loop
// where they are not (a copy for each of kMaxNetLayers layer slots would
// quadruple the stages' code).
template <class Wd, class Phase>
__device__ __forceinline__ void sde_phases(int np, Phase phase) {
  if constexpr (Wd::kFixed) {
#pragma unroll
    for (int p = 0; p < kMaxNetLayers; ++p)
      if (p < np) phase(p);
  } else {
#pragma unroll 1
    for (int p = 0; p < np; ++p) phase(p);
  }
}

// The stages of a trial step on the tile, after the load phase (K9's, and
// K10's recompute; both keep every stage's values, states and hidden
// activations). Each layer is one phase between two block barriers, a
// stage's drift and diffusion layers side by side (sde_layer_items): stage
// i's phase p runs layer p of each network it evaluates. A hidden layer's
// epilogue keeps tanh of its sums (f32) and their f64 copy; a network's
// last layer's writes F_i or G_i; where one network finishes last, that
// epilogue also builds stage i + 1's states (sde_build) element by element,
// else (both finish in one phase, or stage i evaluates nothing) a phase of
// its own builds them. Ends with the last stage's phase (no barrier).
template <class Pair, class Wd>
__device__ __forceinline__ void sde_stages(const Wd& wd, const SriTab& tb, const float* wsm,
                                           const SdeTile& s, int D, const StepScalars& sc) {
  constexpr int R = kSdeRows;
  const int n = R * D, ld0 = sde_ld0(D), ldf = sde_ldh(wd, 0), ldg = sde_ldh(wd, 1);
  const int hf = sde_hidden_floats(wd, 0), hg = sde_hidden_floats(wd, 1);
  bool built = true;  // stage 0's states, by the load phase
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    const bool ef = tb.f_src[i] == i, eg = tb.g_src[i] == i;
    if (!ef && !eg) {
      built = false;
      continue;
    }
    if (!built) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < n; idx += kThreads) {
        const int r = idx / D;
        sde_build<Pair>(tb, s, i, idx, r, idx - r * D, n, ld0, sc.dt_eff, sc.sqdt);
      }
    }
    const int nf = ef ? wd.L(0) : 0, ng = eg ? wd.L(1) : 0, np = nf > ng ? nf : ng;
    const bool next = i + 1 < kStages && nf != ng;
    sde_phases<Wd>(np, [&](int p) {
      __syncthreads();
      const SdeLayer a = sde_layer(wsm, sde_layer_at(wd, 0, p), wd.in(0, p), wd.out(0, p),
                                   p == 0 ? s.x0(0, i) : s.xh(0, p - 1),
                                   p == 0 ? ld0 : ldf, wd.in(0, p));
      const SdeLayer b = sde_layer(wsm, sde_layer_at(wd, 1, p), wd.in(1, p), wd.out(1, p),
                                   p == 0 ? s.x0(1, i) : s.xh(1, p - 1),
                                   p == 0 ? ld0 : ldg, wd.in(1, p));
      int hoff = 0;  // layer p's hidden activations in a stage's record
#pragma unroll
      for (int m = 0; m < kMaxNetLayers; ++m)
        if (m < p) hoff += R * ((wd.out(0, m) + 3) & ~3);
      int goff = 0;
#pragma unroll
      for (int m = 0; m < kMaxNetLayers; ++m)
        if (m < p) goff += R * ((wd.out(1, m) + 3) & ~3);
      // a network's last layer writes F_i or G_i; where it finishes the
      // stage last, its epilogue builds stage i + 1's states
      auto last = [&](float* out, int r, int o, float v) {
        const int idx = r * D + o;
        out[i * n + idx] = v;
        if (next && p == np - 1)
          sde_build<Pair>(tb, s, i + 1, idx, r, o, n, ld0, sc.dt_eff, sc.sqdt);
      };
      if (p < nf)
        sde_layer_items<true>(a, 0, [&](int r, int o, float v) {
          if (p + 1 < wd.L(0)) {  // a hidden layer: tanh, its record and f64 copy
            const float h = tanhf(v);
            s.actf[i * hf + hoff + r * ((wd.out(0, p) + 3) & ~3) + o] = h;
            s.xh(0, p)[r * ldf + o] = (double)h;
            return;
          }
          last(s.F, r, o, v);
        });
      if (p < ng)
        sde_layer_items<true>(b, sde_items_after<true>(p < nf, a), [&](int r, int o, float v) {
          if (p + 1 < wd.L(1)) {
            const float h = tanhf(v);
            s.actg[i * hg + goff + r * ((wd.out(1, p) + 3) & ~3) + o] = h;
            s.xh(1, p)[r * ldg + o] = (double)h;
            return;
          }
          last(s.G, r, o, v);
        });
    });
    built = next;
  }
}

// y_new and the natural-embedding error of element idx, op by op as
// ops/sri.py sri_step.
__device__ __forceinline__ void sri_combine(const SriTab& tb, const SdeTile& s, int idx, int n,
                                            float dt, float* y_new, float* err) {
  float v = s.y[idx];
#pragma unroll
  for (int i = 0; i < kStages; ++i)
    if (tb.alpha[i] != 0.0f) v = v + (tb.alpha[i] * dt) * s.F[tb.f_src[i] * n + idx];
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (!tb.coef[i]) continue;
    const float c = tb.beta[i][0] * s.dw[idx] + tb.beta[i][1] * s.i11[idx] +
                    tb.beta[i][2] * s.i10[idx] + tb.beta[i][3] * s.i111[idx];
    v = v + c * s.G[tb.g_src[i] * n + idx];
  }
  float e = 0.0f;
#pragma unroll
  for (int i = 0; i < kStages; ++i)
    if (tb.dE[i] != 0.0f) e = e + (tb.dE[i] * dt) * s.F[tb.f_src[i] * n + idx];
#pragma unroll
  for (int i = 0; i < kStages; ++i)
    if (tb.en[i] != 0.0f) e = e + (tb.en[i] * s.i10[idx]) * s.G[tb.g_src[i] * n + idx];
  *y_new = v;
  *err = e;
}

// K9's body for one tile: the trial step's rows y_new, dW, dZ (to the
// history's row i + 1) and the three sums of
// squares to sums_out, each element by thread idx % kThreads and the
// threads' partials by block_sum_to, the order of the body before this one.
template <class Pair, class Wd>
__device__ __forceinline__ void sde_fwd_tile(const Wd& wd, const SriTab& tb, const float* wsm,
                                             const SdeTile& s, const float* y_g,
                                             const float* tw_g, const float* tz_g,
                                             const float* xw_g, const float* xz_g, float* yn_g,
                                             float* dw_g, float* dz_g, int row0, int rows, int D,
                                             const StepScalars& sc, float rtol, float atol,
                                             float* sums_out) {
  const int n = kSdeRows * D;
  sde_load<Pair>(wd, tb, s, y_g, tw_g, tz_g, xw_g, xz_g, row0, rows, D, sc);
  sde_stages<Pair>(wd, tb, wsm, s, D, sc);
  __syncthreads();
  float sums[3] = {0.0f, 0.0f, 0.0f};
  const bool eig = tb.ia != tb.ib;
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    float yn, er;
    sri_combine(tb, s, idx, n, sc.dt_eff, &yn, &er);
    const float yv = s.y[idx];
    const float denom = atol + fmaxf(fabsf(yv), fabsf(yn)) * rtol;
    const float sv = er / denom;
    sums[0] += sv * sv;
    if (eig) {
      const float df = s.F[tb.ib * n + idx] - s.F[tb.ia * n + idx];
      const float dh = s.H0[tb.ib * n + idx] - s.H0[tb.ia * n + idx];
      sums[1] += df * df;
      sums[2] += dh * dh;
    }
    const size_t g = (size_t)row0 * D + idx;
    yn_g[g] = yn;
    dw_g[g] = s.dw[idx];
    dz_g[g] = s.dz[idx];
  }
  block_sum_to<3>(sums, s.red, sums_out);
}

// Stage i's lincomb pullbacks of element idx (the algebra of
// ops/sde_whole_solve.py _sde_rows_bwd): the diffusion's state H1_i (input
// cotangent cx) and the drift's H0_i (cx with the eigen seed cH0 added),
// each into cy, the earlier stages' cF, cG and the per-element shares of
// the scalar cotangents, j in order, the A term before the B term.
__device__ __forceinline__ void sde_lincomb_g(const SriTab& tb, const SdeTile& s, int i, int idx,
                                              int n, float cx, float dt, float sqdt) {
  s.cy[idx] = s.cy[idx] + cx;
#pragma unroll
  for (int j = 0; j < kStages; ++j) {
    if (j >= i) break;
    if (tb.A1[i][j] != 0.0f) {
      float* cf = s.cF + tb.f_src[j] * n + idx;
      *cf = *cf + (tb.A1[i][j] * dt) * cx;
      s.ep1[idx] = s.ep1[idx] + tb.A1[i][j] * (s.F[tb.f_src[j] * n + idx] * cx);
    }
    if (tb.B1[i][j] != 0.0f) {
      float* cg = s.cG + tb.g_src[j] * n + idx;
      *cg = *cg + (tb.B1[i][j] * sqdt) * cx;
      s.ep2[idx] = s.ep2[idx] + tb.B1[i][j] * (s.G[tb.g_src[j] * n + idx] * cx);
    }
  }
}

__device__ __forceinline__ void sde_lincomb_f(const SriTab& tb, const SdeTile& s, int i, int idx,
                                              int n, float cx, float dt) {
  s.cy[idx] = s.cy[idx] + cx;
#pragma unroll
  for (int j = 0; j < kStages; ++j) {
    if (j >= i) break;
    if (tb.A0[i][j] != 0.0f) {
      float* cf = s.cF + tb.f_src[j] * n + idx;
      *cf = *cf + (tb.A0[i][j] * dt) * cx;
      s.ep1[idx] = s.ep1[idx] + tb.A0[i][j] * (s.F[tb.f_src[j] * n + idx] * cx);
    }
    if (tb.B0[i][j] != 0.0f) {
      float* cg = s.cG + tb.g_src[j] * n + idx;
      *cg = *cg + (tb.B0[i][j] * s.i10[idx]) * cx;
      s.ci10[idx] = s.ci10[idx] + tb.B0[i][j] * (s.G[tb.g_src[j] * n + idx] * cx);
    }
  }
}

// The f64 copies of stage k's output cotangents (cF_k, cG_k, final once
// the stages after k are pulled back) of element idx = (r, c), for the
// networks stage k evaluates.
__device__ __forceinline__ void sde_cod(const SriTab& tb, const SdeTile& s, int k, int idx, int r,
                                        int c, int n, int ld0) {
  if (tb.f_src[k] == k) s.cod(0, k)[r * ld0 + c] = (double)s.cF[k * n + idx];
  if (tb.g_src[k] == k) s.cod(1, k)[r * ld0 + c] = (double)s.cG[k * n + idx];
}

// K10's body for one tile: the pullback of one trial step (the algebra of
// ops/sde_whole_solve.py _sde_rows_bwd; its order of sums on the CPU is
// plain_sde_bwd_tiles). Recomputes the step with K9's load and stages
// (the same bits), then: one phase of seeds (each element by thread idx %
// kThreads: the cotangents of y_out, tail_w_out, tail_z_out (ct_y, ct_tw,
// ct_tz, rows in global memory), of the three sums (g_e, g_n, g_d) and the
// saves' (rows [lo, hi) of ct_ys, interpolated from (t, dt_eff) between y
// and y_new = hy_next), then y_new's and the error's stage weights); the
// stages in reverse, each layer one phase, a stage's drift and diffusion
// layers side by side (sde_layer_items): the input cotangents' f64 sums
// split over lanes, a hidden layer's multiplied by tanh' in its epilogue
// (the next layer's pre-activation cotangent), the weight and bias
// cotangents added to the block's (shared memory, sde_cw_layer), and a
// network's input cotangent pulled through the stage's lincomb in the
// epilogue that completes it (the diffusion's, then the drift's; a phase of
// its own where both finish together); last, the
// Itô coefficients and the bridge, each element by thread idx % kThreads.
// Replaces the rows ct_y, ct_tw, ct_tz with the cotangents of y, tail_w,
// tail_z and writes the tile's partials (ct_t from the saves, ct_dt_eff,
// ct_sqrt(dt_eff), ct_frac, ct_std; block_sum_to over the threads' sums of
// their elements' shares) to part_out.
template <class Pair, class Wd>
__device__ __forceinline__ void sde_bwd_tile(
    const Wd& wd, const SriTab& tb, const float* wsm, float* cw, const SdeTile& s,
    const float* y_g, const float* tw_g, const float* tz_g, const float* xw_g, const float* xz_g,
    const float* hy_next, const float* sa, const float* ct_ys, int lo, int hi,
    float t, size_t BD, float* ct_y, float* ct_tw, float* ct_tz, int row0, int rows, int D,
    const StepScalars& sc, bool acc, bool inside, float g_e, float g_n, float g_d, float rtol,
    float atol, float* part_out) {
  constexpr int R = kSdeRows;
  const int n = R * D, ld0 = sde_ld0(D), ldf = sde_ldh(wd, 0), ldg = sde_ldh(wd, 1);
  const int hf = sde_hidden_floats(wd, 0), hg = sde_hidden_floats(wd, 1);
  const float dt = sc.dt_eff, sqdt = sc.sqdt;
  sde_load<Pair>(wd, tb, s, y_g, tw_g, tz_g, xw_g, xz_g, row0, rows, D, sc);
  sde_stages<Pair>(wd, tb, wsm, s, D, sc);
  __syncthreads();

  // ---- seeds, then y_new's and the error's stage weights ----
  const float hd = dt == 0.0f ? 1.0f : dt;
  const bool eig = tb.ia != tb.ib;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    for (int k = 0; k < kStages; ++k)
      s.cF[k * n + idx] = s.cG[k * n + idx] = s.cH0[k * n + idx] = 0.0f;
    float cwi = 0.0f, c11 = 0.0f, c10 = 0.0f, c111 = 0.0f, e0 = 0.0f, e1 = 0.0f;
    float cy = 0.0f, cyn = 0.0f, cerr = 0.0f, cdw = 0.0f, cdz = 0.0f, ctw = 0.0f, ctz = 0.0f;
    if (idx < rows * D) {
      const size_t g = (size_t)row0 * D + idx;
      const float cyo = __ldcg(ct_y + g), cwo = __ldcg(ct_tw + g), czo = __ldcg(ct_tz + g);
      cy = acc ? 0.0f : cyo;
      cyn = acc ? cyo : 0.0f;
      // tail_out = where(accept, where(inside, tail - d, 0), d)
      cdw = acc ? (inside ? -cwo : 0.0f) : cwo;
      cdz = acc ? (inside ? -czo : 0.0f) : czo;
      ctw = acc && inside ? cwo : 0.0f;
      ctz = acc && inside ? czo : 0.0f;
      const float yv = s.y[idx];
      if (hi > lo) {  // the saves: row = (1 - th) y + th y_new
        const float ynv = __ldcg(hy_next + g);
        for (int r = lo; r < hi; ++r) {
          const float th = (sa[r] - t) / hd;
          const float gr = __ldcg(ct_ys + (size_t)r * BD + g);
          cy += (1.0f - th) * gr;
          cyn += th * gr;
          const float c_th = gr * (ynv - yv);
          e0 -= c_th / hd;
          e1 += dt == 0.0f ? 0.0f : -c_th * th / hd;
        }
      }
      float yn, er;
      sri_combine(tb, s, idx, n, dt, &yn, &er);
      const float ay = fabsf(yv), an = fabsf(yn);
      const float denom = atol + fmaxf(ay, an) * rtol;
      const float sv = er / denom;
      const float csv = g_e * 2.0f * sv;
      const float cm = -csv * sv / denom * rtol;
      cy += (ay > an ? cm : (ay == an ? 0.5f * cm : 0.0f)) * sign_of(yv);
      cyn += (an > ay ? cm : (ay == an ? 0.5f * cm : 0.0f)) * sign_of(yn);
      cerr = csv / denom;
      cy = cy + cyn;  // y_new = y + ...
      if (eig) {
        const float df = g_n * 2.0f * (s.F[tb.ib * n + idx] - s.F[tb.ia * n + idx]);
        const float dh = g_d * 2.0f * (s.H0[tb.ib * n + idx] - s.H0[tb.ia * n + idx]);
        s.cF[tb.ib * n + idx] = df;
        s.cF[tb.ia * n + idx] = -df;
        s.cH0[tb.ib * n + idx] = dh;
        s.cH0[tb.ia * n + idx] = -dh;
      }
      const float dwv = s.dw[idx], i11 = s.i11[idx], i10 = s.i10[idx], i111 = s.i111[idx];
#pragma unroll
      for (int i = 0; i < kStages; ++i) {
        if (tb.alpha[i] != 0.0f) {
          float* cf = s.cF + tb.f_src[i] * n + idx;
          *cf = *cf + (tb.alpha[i] * dt) * cyn;
          e1 += tb.alpha[i] * (s.F[tb.f_src[i] * n + idx] * cyn);
        }
        if (tb.dE[i] != 0.0f) {
          float* cf = s.cF + tb.f_src[i] * n + idx;
          *cf = *cf + (tb.dE[i] * dt) * cerr;
          e1 += tb.dE[i] * (s.F[tb.f_src[i] * n + idx] * cerr);
        }
        const float gi = tb.g_src[i] >= 0 ? s.G[tb.g_src[i] * n + idx] : 0.0f;
        if (tb.coef[i]) {
          const float co = tb.beta[i][0] * dwv + tb.beta[i][1] * i11 + tb.beta[i][2] * i10 +
                           tb.beta[i][3] * i111;
          float* cg = s.cG + tb.g_src[i] * n + idx;
          *cg = *cg + co * cyn;
          const float cc = gi * cyn;
          cwi += tb.beta[i][0] * cc;
          c11 += tb.beta[i][1] * cc;
          c10 += tb.beta[i][2] * cc;
          c111 += tb.beta[i][3] * cc;
        }
        if (tb.en[i] != 0.0f) {
          float* cg = s.cG + tb.g_src[i] * n + idx;
          *cg = *cg + (tb.en[i] * i10) * cerr;
          c10 += tb.en[i] * (gi * cerr);
        }
      }
    }
    s.cy[idx] = cy;
    s.cyn[idx] = cyn;
    s.cerr[idx] = cerr;
    s.cdw[idx] = cdw;
    s.cdz[idx] = cdz;
    s.ctw[idx] = ctw;
    s.ctz[idx] = ctz;
    s.cwi[idx] = cwi;
    s.ci11[idx] = c11;
    s.ci10[idx] = c10;
    s.ci111[idx] = c111;
    s.ep0[idx] = e0;
    s.ep1[idx] = e1;
    s.ep2[idx] = 0.0f;
    const int r = idx / D;
    sde_cod(tb, s, kStages - 1, idx, r, idx - r * D, n, ld0);
  }

  // ---- reverse over the stages ----
  bool built = true;  // the last stage's output cotangents' f64 copies, by the seeds
#pragma unroll
  for (int ii = 0; ii < kStages; ++ii) {
    const int i = kStages - 1 - ii;
    const bool ef = tb.f_src[i] == i, eg = tb.g_src[i] == i;
    if (!ef && !eg) {
      built = false;
      continue;
    }
    if (!built) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < n; idx += kThreads) {
        const int r = idx / D;
        sde_cod(tb, s, i, idx, r, idx - r * D, n, ld0);
      }
    }
    const int nf = ef ? wd.L(0) : 0, ng = eg ? wd.L(1) : 0, np = nf > ng ? nf : ng;
    // both lincombs in a phase of their own where the diffusion's input
    // cotangent is not done a phase before the drift's
    const bool tail = ef && eg && ng >= nf;
    const bool last_f = ef && (!eg || nf > ng);  // whose epilogue ends the stage
    sde_phases<Wd>(np, [&](int p) {
      __syncthreads();
      // the layers this phase pulls back
      const int lf = wd.L(0) - 1 - p, lg = wd.L(1) - 1 - p;
      const bool rf = ef && lf >= 0, rg = eg && lg >= 0;
      const int lfc = lf >= 0 ? lf : 0, lgc = lg >= 0 ? lg : 0;
      const int Kf = wd.in(0, lfc), Nf = wd.out(0, lfc), Kg = wd.in(1, lgc), Ng = wd.out(1, lgc);
      // the layers' output cotangents (f32 and f64 rows) and inputs (f32 rows)
      const bool topf = lfc == wd.L(0) - 1, topg = lgc == wd.L(1) - 1;
      int hoff_f = 0, hoff_g = 0;  // layer l - 1's activations in a stage's record
#pragma unroll
      for (int m = 0; m < kMaxNetLayers; ++m) {
        if (m + 1 < lfc) hoff_f += R * ((wd.out(0, m) + 3) & ~3);
        if (m + 1 < lgc) hoff_g += R * ((wd.out(1, m) + 3) & ~3);
      }
      const float* gf = topf ? s.cF + i * n : s.ghf(0, lfc);
      const float* gg = topg ? s.cG + i * n : s.ghf(1, lgc);
      const int ldgf = topf ? D : ldf, ldgg = topg ? D : ldg;
      const float* xf = lfc == 0 ? s.H0 + i * n : s.actf + i * hf + hoff_f;
      const float* xg = lgc == 0 ? s.H1 + i * n : s.actg + i * hg + hoff_g;
      const int ldxf = lfc == 0 ? D : ((wd.out(0, lfc - 1) + 3) & ~3);
      const int ldxg = lgc == 0 ? D : ((wd.out(1, lgc - 1) + 3) & ~3);
      if (rf)
        sde_cw_layer(cw, sde_leaf_at(wd, 0, lfc), Kf, Nf, gf, ldgf, xf, ldxf,
                     Pair::kCube && lfc == 0);
      if (rg) sde_cw_layer(cw, sde_leaf_at(wd, 1, lgc), Kg, Ng, gg, ldgg, xg, ldxg, false);
      const SdeLayer a = sde_layer(wsm, sde_layer_at(wd, 0, lfc), Kf, Nf,
                                   topf ? s.cod(0, i) : s.gh(0, lfc),
                                   topf ? ld0 : ldf, Nf);
      const SdeLayer b = sde_layer(wsm, sde_layer_at(wd, 1, lgc), Kg, Ng,
                                   topg ? s.cod(1, i) : s.gh(1, lgc),
                                   topg ? ld0 : ldg, Ng);
      if (rf)
        sde_layer_items<false>(a, 0, [&](int r, int c, float v) {
          if (lfc > 0) {  // the layer below's pre-activation cotangent: times tanh'
            const float h = xf[r * ldxf + c];
            const float gv = v * (1.0f - h * h);
            s.ghf(0, lfc - 1)[r * ldf + c] = gv;
            s.gh(0, lfc - 1)[r * ldf + c] = (double)gv;
            return;
          }
          const int idx = r * D + c;
          float cx = v;
          if (Pair::kCube) {
            const float x = s.H0[i * n + idx];
            cx = cx * (3.0f * (x * x));
          }
          cx = cx + s.cH0[i * n + idx];
          if (tail) {
            s.cxf[idx] = cx;
            return;
          }
          sde_lincomb_f(tb, s, i, idx, n, cx, dt);
          if (last_f && i > 0) sde_cod(tb, s, i - 1, idx, r, c, n, ld0);
        });
      if (rg)
        sde_layer_items<false>(b, sde_items_after<false>(rf, a), [&](int r, int c, float v) {
          if (lgc > 0) {
            const float h = xg[r * ldxg + c];
            const float gv = v * (1.0f - h * h);
            s.ghf(1, lgc - 1)[r * ldg + c] = gv;
            s.gh(1, lgc - 1)[r * ldg + c] = (double)gv;
            return;
          }
          const int idx = r * D + c;
          if (tail) {
            s.cxg[idx] = v;
            return;
          }
          sde_lincomb_g(tb, s, i, idx, n, v, dt, sqdt);
          if (!last_f && i > 0) sde_cod(tb, s, i - 1, idx, r, c, n, ld0);
        });
    });
    if (tail) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < n; idx += kThreads) {
        sde_lincomb_g(tb, s, i, idx, n, s.cxg[idx], dt, sqdt);
        sde_lincomb_f(tb, s, i, idx, n, s.cxf[idx], dt);
        const int r = idx / D;
        if (i > 0) sde_cod(tb, s, i - 1, idx, r, idx - r * D, n, ld0);
      }
    }
    built = true;
  }
  __syncthreads();

  // ---- the Itô coefficients and the bridge ----
  const float inv_sqrt3 = 1.0f / 1.7320508075688772f;
  float part[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // t, dt_eff, sqrt(dt_eff), frac, std
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    part[0] += s.ep0[idx];
    part[1] += s.ep1[idx];
    part[2] += s.ep2[idx];
    const float dw = s.dw[idx], i11 = s.i11[idx], i111 = s.i111[idx];
    const float c11 = s.ci11[idx], c111 = s.ci111[idx], c10 = s.ci10[idx];
    const float cdw = s.cdw[idx] + s.cwi[idx] + c11 * (dw / sqdt) + 0.5f * c10 +
                      c111 * ((3.0f * dw * dw - 3.0f * dt) / (6.0f * dt));
    const float cdz = s.cdz[idx] + (0.5f * inv_sqrt3) * c10;
    part[1] += -c11 * (0.5f / sqdt) + c111 * (-3.0f * dw / (6.0f * dt) - i111 / dt);
    part[2] += -c11 * i11 / sqdt;
    part[3] += s.tw[idx] * cdw + s.tz[idx] * cdz;
    part[4] += s.xw[idx] * cdw + s.xz[idx] * cdz;
    const size_t g = (size_t)row0 * D + idx;
    ct_y[g] = s.cy[idx];
    ct_tw[g] = s.ctw[idx] + sc.frac * cdw;
    ct_tz[g] = s.ctz[idx] + sc.frac * cdz;
  }
  block_sum_to<5>(part, s.red, part_out);
}

template <class Pair, class Wd>
struct SdeFwdArgs {
  const float* scalars;  // t0, t1, dt0
  const float* y0;
  Pair pair;
  Wd wd;
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
template <class Pair, class Wd>
__global__ void __launch_bounds__(kThreads, 1) sde_whole_solve_fwd_kernel(SdeFwdArgs<Pair, Wd> a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_t, s_dt, s_qold, s_h;
  __shared__ int s_na, s_nr, s_done, s_acc, s_inside, s_cur, s_lo, s_hi;
  cg::grid_group grid = cg::this_grid();
  constexpr int R = kSdeRows;
  const Wd& wd = a.wd;
  const int ntiles = (a.B + R - 1) / R;
  const size_t BD = (size_t)a.B * a.D;
  const float t0 = a.scalars[0], t1 = a.scalars[1];
  const float span = t1 - t0;
  const float count = (float)BD;
  const float* wsm = smem;
  const SdeTile s = sde_tile(wd, smem, a.D, false);

  sde_load_leaves(a.pair.net, wd, smem);
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
      sde_fwd_tile<Pair>(wd, a.tab, wsm, s, a.hy + cur, a.hw + cur, a.hz + cur,
                         a.xi_w + cur, a.xi_z + cur, a.hy + nxt, a.hw + nxt, a.hz + nxt, row0,
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
    // the fix-up: a rejected step keeps its state and takes dW, dZ as its
    // new tail; an accepted one keeps the tail's remainder inside it (else
    // none) and writes the saveat rows in its window
    const float hd = dt_eff == 0.0f ? 1.0f : dt_eff;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int row0 = tile * R, n = min(R, a.B - row0) * a.D;
      for (int idx = threadIdx.x; idx < n; idx += kThreads) {
        const size_t g = (size_t)row0 * a.D + idx;
        if (!s_acc) {
          a.hy[nxt + g] = __ldcg(a.hy + cur + g);
          continue;
        }
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

template <class Pair, class Wd>
struct SdeBwdArgs {
  const float* scalars;  // t0, t1
  const float* streams;  // (12, S), the forward's
  const float* hy;
  const float* hw;
  const float* hz;
  Pair pair;
  Wd wd;
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

// K10: the reverse walk over K9's ns trial steps. The leaves' cotangents
// stay in the block's shared memory for the whole walk and reach its slot
// once.
template <class Pair, class Wd>
__global__ void __launch_bounds__(kThreads, 1) sde_whole_solve_bwd_kernel(SdeBwdArgs<Pair, Wd> a) {
  extern __shared__ __align__(16) float smem[];
  // running cotangents of t, dt, qold, tail_h, and the sums of those of t1, span
  __shared__ float s_ct[6];
  __shared__ PostGrads s_g;
  __shared__ Bridge s_br;
  __shared__ float s_ti, s_dteff, s_h, s_sqdt;
  __shared__ int s_last, s_acc, s_lo, s_hi, s_rcur;
  cg::grid_group grid = cg::this_grid();
  constexpr int R = kSdeRows;
  const Wd& wd = a.wd;
  const int ntiles = (a.B + R - 1) / R;
  const size_t BD = (size_t)a.B * a.D;
  const float t0 = a.scalars[0], t1 = a.scalars[1];
  const float span = t1 - t0;
  const float count = (float)BD;
  const int S = a.S;
  const int cur0 = a.n_save ? a.cursors[0] : 0;
  const int nleaf = sde_leaf_floats(wd, 0) + sde_leaf_floats(wd, 1);
  const float* wsm = smem;
  float* cw = smem + sde_weight_floats(wd);
  const SdeTile s = sde_tile(wd, smem, a.D, true);
  sde_load_leaves(a.pair.net, wd, smem);
  for (int e = threadIdx.x; e < nleaf; e += kThreads) cw[e] = 0.0f;
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
      sde_bwd_tile<Pair>(wd, a.tab, wsm, cw, s, a.hy + cur, a.hw + cur, a.hz + cur,
                         a.xi_w + cur, a.xi_z + cur, a.hy + cur + BD, a.sa, a.ct_ys, s_lo, s_hi,
                         s_ti, BD, a.ct_y, a.ct_tw, a.ct_tz, row0, min(R, a.B - row0), a.D, sc,
                         s_acc, s_br.inside, s_g.e, s_g.n, s_g.d, a.rtol, a.atol,
                         part + 5 * tile);
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
  for (int e = threadIdx.x; e < nleaf; e += kThreads) slot[e] = cw[e];
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
bool pack_nets(const float* const* leaves, const int* widths, int D, MlpNet (&net)[2]) {
  const int L[2] = {widths[0], widths[1]};
  int w = 2, p = 0;
  for (int k = 0; k < 2; ++k) {
    if (L[k] < 1 || L[k] > kMaxNetLayers) return false;
    MlpNet& n = net[k];
    n = MlpNet{};
    n.L = L[k];
    for (int l = 0; l <= L[k]; ++l) n.w[l] = widths[w++];
    if (n.w[0] != D || n.w[L[k]] != D) return false;
    for (int q = 0; q < 2 * L[k]; ++q) n.p[q] = leaves ? leaves[p++] : nullptr;
  }
  return true;
}

// Whether the pair's compile-time instance (Pair::Fixed, its widths as
// constants) runs these networks: drift D -> H -> D, diffusion D -> D at
// that instance's D and H.
template <class Pair>
bool fixed_instance(const MlpNet (&net)[2], int D) {
  using F = typename Pair::Fixed;
  return D == F::kD && net[0].L == 2 && net[0].w[1] == F::kH && net[1].L == 1;
}

Ctrl make_ctrl(float beta1, float beta2, float qmin, float qmax, float gamma, float qoldinit,
               float qsteady_max) {
  return Ctrl{beta1, beta2, qmin, qmax, gamma, qoldinit, qsteady_max};
}

template <class Pair, class Wd>
int sde_fwd_launch(SdeFwdArgs<Pair, Wd>& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)sde_smem_floats(a.wd, a.D, false);
  return (int)launch_cooperative((const void*)sde_whole_solve_fwd_kernel<Pair, Wd>, &a, smem,
                                 (a.B + kSdeRows - 1) / kSdeRows, stream, nullptr);
}

// K9 for the tile body Pair (the arguments of regnde_sde_whole_solve_fwd).
template <class Pair>
int sde_fwd_entry(const float* scalars, const float* y0, const float* const* leaves,
                  const int* widths, const float* tab_f, const int* tab_i, const float* xi_w,
                  const float* xi_z, const float* saveat, int* cursors, float* ys, float* y1,
                  float* hy, float* hw, float* hz, float* streams, float* final_,
                  float* partials, int B, int D, int S, int n_save, float rtol, float atol,
                  const Ctrl& ctrl, void* stream) {
  Pair pair{};
  if (!pack_nets(leaves, widths, D, pair.net)) return (int)cudaErrorInvalidValue;
  auto fill = [&](auto& a) {
    a.scalars = scalars; a.y0 = y0; a.pair = pair; a.tab = pack_tab(tab_f, tab_i);
    a.xi_w = xi_w; a.xi_z = xi_z; a.sa = saveat; a.cursors = cursors; a.ys = ys;
    a.n_save = n_save; a.y1 = y1; a.hy = hy; a.hw = hw; a.hz = hz; a.streams = streams;
    a.final_ = final_; a.partials = partials; a.B = B; a.D = D; a.S = S;
    a.rtol = rtol; a.atol = atol; a.ctrl = ctrl;
  };
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fixed_instance<Pair>(pair.net, D)) {
    SdeFwdArgs<Pair, typename Pair::Fixed> a{};
    fill(a);
    return sde_fwd_launch(a, s);
  }
  SdeFwdArgs<Pair, DynWidths> a{};
  fill(a);
  a.wd = dyn_widths(pair.net);
  return sde_fwd_launch(a, s);
}

template <class Pair, class Wd>
int sde_bwd_launch(SdeBwdArgs<Pair, Wd>& a, float* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)sde_smem_floats(a.wd, a.D, true);
  int grid = 0;
  cudaError_t e = launch_cooperative((const void*)sde_whole_solve_bwd_kernel<Pair, Wd>, &a, smem,
                                     (a.B + kSdeRows - 1) / kSdeRows, stream, &grid);
  if (e != cudaSuccess) return (int)e;
  const int width = sde_leaf_floats(a.wd, 0) + sde_leaf_floats(a.wd, 1);
  sum_slots_kernel<<<(width + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a.slots, grid,
                                                                             width, out);
  return (int)cudaGetLastError();
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
  Pair pair{};
  if (!pack_nets(leaves, widths, D, pair.net)) return (int)cudaErrorInvalidValue;
  auto fill = [&](auto& a) {
    a.scalars = scalars; a.streams = streams; a.hy = hy; a.hw = hw; a.hz = hz; a.pair = pair;
    a.tab = pack_tab(tab_f, tab_i); a.xi_w = xi_w; a.xi_z = xi_z; a.sa = saveat;
    a.cursors = cursors; a.ct_ys = ct_ys; a.n_save = n_save; a.ct_tel = ct_tel; a.ct_y = ct_y;
    a.ct_tw = ct_tw; a.ct_tz = ct_tz; a.ct_scalars = ct_scalars; a.partials = partials;
    a.slots = slots; a.ns = ns; a.B = B; a.D = D; a.S = S; a.rtol = rtol; a.atol = atol;
    a.ctrl = ctrl;
  };
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fixed_instance<Pair>(pair.net, D)) {
    SdeBwdArgs<Pair, typename Pair::Fixed> a{};
    fill(a);
    return sde_bwd_launch(a, out, s);
  }
  SdeBwdArgs<Pair, DynWidths> a{};
  fill(a);
  a.wd = dyn_widths(pair.net);
  return sde_bwd_launch(a, out, s);
}

}  // namespace

extern "C" {

int regnde_sde_rows() { return kSdeRows; }
int regnde_sde_chain() { return kSdeChain; }
int regnde_sde_threads() { return kThreads; }

// Whether K9 and K10 run the pair of these widths ([nf, ng, drift widths,
// diffusion widths], as regnde_sde_whole_solve_fwd takes them; the cubic
// pair where cubic) on its compile-time instance, its widths as constants
// (1), or on the generic one (0); -1 for widths the kernels refuse.
int regnde_sde_fixed_instance(const int* widths, int D, int cubic) {
  MlpNet net[2];
  if (!pack_nets(nullptr, widths, D, net)) return -1;
  return (cubic ? fixed_instance<CubicPair>(net, D) : fixed_instance<MlpPair>(net, D)) ? 1 : 0;
}

// Bytes of dynamic shared memory of a K9 (bwd 0) or K10 (bwd 1) block at
// these widths; -1 for widths the kernels refuse.
int regnde_sde_smem_bytes(const int* widths, int D, int bwd) {
  MlpNet net[2];
  if (!pack_nets(nullptr, widths, D, net)) return -1;
  return (int)sizeof(float) * sde_smem_floats(dyn_widths(net), D, bwd != 0);
}

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
