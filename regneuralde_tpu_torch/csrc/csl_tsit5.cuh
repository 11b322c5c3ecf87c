// Device code of FFJORD's augmented CSL dynamics in the normed Tsit5 trial
// step, shared by the step kernels (csl_tsit5.cu, K7/K8-CSL) and the
// whole-solve kernels (whole_solve.cu, K3/K4 with CslDyn): the stage, the
// six-stage recompute, and the per-tile bodies of one trial step and of
// its hand reverse.
//
//   o_l = (h W_l^T + b_l) * g_l + (t w_b,l + b_b,l),  g_l = sigmoid(t w_g,l)
//   h_1 = softplus(o_1), h_2 = softplus(o_2), mz = o_3      (CSLDynamics)
//   v_3 = e (W_3 * g_3), v_2 = (v_3 s_2) (W_2 * g_2), eJ = (v_2 s_1) (W_1 * g_1)
//   with s_l = sigmoid(o_l); the stage derivative is
//   [mz, -sum(eJ e) (, sum mz^2, sum eJ^2)]                 (FFJORD's state)
//
// The leaves are W_l (nn.Linear layout, out x in), b_l, w_g,l, w_b,l, b_b,l
// for l = 1, 2, 3 (dim -> hidden -> hidden -> dim), then the Hutchinson
// probe e (batch x dim), read by row like y. A tile is kCslRows rows of the
// batch, run by one block of kThreads; the parameters live in shared memory
// (csl_load_weights), each weight row padded to an odd stride so that
// neither the products over inputs (threads over outputs) nor those over
// outputs (threads over inputs) have bank conflicts. The gates are computed
// once per stage per block.
//
// Rounding. The forward reproduces its plain version (ops/fused_csl.py
// plain_csl_normed_sweep) rounding for rounding: each affine map, each hop
// and each row sum is summed in f64 and rounded once to f32 (as the plain
// version's f64 products), W * g is an f32 product first (as in JAX), and
// every other op rounds as ATen's does on the card: sigmoid is 1 / (1 +
// expf(-x)), softplus max(x, 0) + log1pf(expf(-|x|)) (jax.nn.softplus),
// each multiply and add on its own (__fmul_rn/__fadd_rn, no FMA
// contraction). Arithmetic is IEEE: no fast math, no TF32.

#pragma once

#include "altmlp_tsit5.cuh"

namespace {

constexpr int kCslRows = 2;     // rows of the batch per tile
constexpr int kCslParams = 15;  // 3 layers x (W, b, w_g, w_b, b_b)
constexpr int kCslBwdBufs = 16;  // row buffers of the backward's reverse

struct CslLeaves {
  const float* p[kCslParams + 1];  // the parameters, then the probe e
};

__host__ __device__ inline int csl_in(int l, int D, int H) { return l == 0 ? D : H; }
__host__ __device__ inline int csl_out(int l, int D, int H) { return l == 2 ? D : H; }

// Floats of layer l in shared memory: W padded (out x (in + 1)), then b,
// w_g, w_b, b_b (out each); of its leaves as given (unpadded).
__host__ __device__ inline int csl_pad_layer(int l, int D, int H) {
  return csl_out(l, D, H) * (csl_in(l, D, H) + 5);
}
__host__ __device__ inline int csl_leaf_layer(int l, int D, int H) {
  return csl_out(l, D, H) * (csl_in(l, D, H) + 4);
}
__host__ __device__ inline int csl_pad_floats(int D, int H) {
  return csl_pad_layer(0, D, H) + csl_pad_layer(1, D, H) + csl_pad_layer(2, D, H);
}
__host__ __device__ inline int csl_leaf_floats(int D, int H) {
  return csl_leaf_layer(0, D, H) + csl_leaf_layer(1, D, H) + csl_leaf_layer(2, D, H);
}

// One stage's activations of a row: a1, o1, a2, o2, v3, v2 (H each), a3,
// eJ (D each).
__host__ __device__ inline int csl_rec_row(int D, int H) { return 6 * H + 2 * D; }

// Shared memory of one forward tile and of one backward tile, after the
// padded parameters (and, backward, their cotangents).
__host__ __device__ inline int csl_fwd_tile_floats(int A, int D, int H) {
  return 10 * kCslRows * A + kCslRows * D + (2 * H + D) +
         kCslRows * csl_rec_row(D, H) + 2 * kCslRows * H + 3 * kWarps;
}
__host__ __device__ inline int csl_bwd_tile_floats(int A, int D, int H) {
  const int W = D > H ? D : H;
  return 19 * kCslRows * A + kCslRows * D + (2 * H + D) +
         6 * kCslRows * csl_rec_row(D, H) + 2 * kCslRows * H +
         kCslBwdBufs * kCslRows * W + 2 * kWarps;
}

size_t csl_fwd_smem_bytes(int A, int D, int H) {
  return sizeof(float) * ((size_t)csl_pad_floats(D, H) + csl_fwd_tile_floats(A, D, H));
}
size_t csl_bwd_smem_bytes(int A, int D, int H) {
  return sizeof(float) * ((size_t)csl_pad_floats(D, H) + csl_leaf_floats(D, H) +
                          csl_bwd_tile_floats(A, D, H));
}

// The end of a forward tile body: the tile's y_new and k7 rows (its first
// `valid` elements, from element g0 of the global rows) and its three norm
// sums (err, num, den) to sums_out, from the recomputed y_s, ks, ystage
// (y_new) and g6 (the stage-5 state), n elements each. The same algebra as
// the end of altmlp_fwd_tile.
__device__ __forceinline__ void normed_tile_out(const float* y_s, const float* ks,
                                                const float* ystage, const float* g6,
                                                int n, int valid, size_t g0, float dt,
                                                float rtol, float atol, float* y_new,
                                                float* k7, float* red, float* sums_out) {
  float sums[3] = {0.0f, 0.0f, 0.0f};
  for (int idx = threadIdx.x; idx < valid; idx += kThreads) {
    const float err = __fmul_rn(dt, err_comb_rn(ks, n, idx));
    const float yv = y_s[idx], yn = ystage[idx];
    const float denom = __fadd_rn(atol, __fmul_rn(fmaxf(fabsf(yv), fabsf(yn)), rtol));
    const float sc = __fdiv_rn(err, denom);
    sums[0] += sc * sc;
    const float dk = ks[6 * n + idx] - ks[5 * n + idx];
    sums[1] += dk * dk;
    const float dg = yn - g6[idx];
    sums[2] += dg * dg;
    y_new[g0 + idx] = yn;
    k7[g0 + idx] = ks[6 * n + idx];
  }
  block_sum_to<3>(sums, red, sums_out);
}

// The seeds of a backward tile body from the outputs' cotangents: the
// stage derivatives' cotangents cks (7 x n), the stage-6 seed seed6, the
// stage-5 seed (into g6, which held the stage-5 state) and cty, the
// direct cotangent of y. Elements past `valid` (rows past the batch end)
// get none, so they add nothing to the parameter cotangents. Returns this
// thread's share of ct_dt. The same algebra as altmlp_bwd_tile's seeds.
__device__ __forceinline__ float normed_seeds(const float* y_s, const float* ks,
                                              const float* ystage, float* cks, float* g6,
                                              float* seed6, float* cty, int n, int valid,
                                              size_t g0, const float* ct_ynew,
                                              const float* ct_k7, float dt, float c_err,
                                              float c_num, float c_den, float rtol,
                                              float atol) {
  float ct_dt = 0.0f;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    if (idx >= valid) {
      for (int j = 0; j < 7; ++j) cks[j * n + idx] = 0.0f;
      seed6[idx] = g6[idx] = cty[idx] = 0.0f;
      continue;
    }
    const float s_comb = err_comb_rn(ks, n, idx);
    const float err = __fmul_rn(dt, s_comb);
    const float yv = y_s[idx], yn = ystage[idx];
    const float ay = fabsf(yv), an = fabsf(yn);
    const float denom = __fadd_rn(atol, __fmul_rn(fmaxf(ay, an), rtol));
    const float scaled = __fdiv_rn(err, denom);
    const float cerr = c_err * 2.0f * scaled / denom;
    const float cm = c_err * (-2.0f) * scaled * scaled / denom * rtol;
    // max(|y|, |y_new|): a tie splits the cotangent in half (as autograd
    // and jax.vjp do)
    const float to_y = ay > an ? cm : (ay == an ? 0.5f * cm : 0.0f);
    const float to_yn = an > ay ? cm : (ay == an ? 0.5f * cm : 0.0f);
    const float d_k7 = c_num * 2.0f * (ks[6 * n + idx] - ks[5 * n + idx]);
    const float d_ynew = c_den * 2.0f * (yn - g6[idx]);
    const size_t g = g0 + idx;
    const float cyn = ct_ynew ? __ldcg(ct_ynew + g) : 0.0f;
    const float ck7 = ct_k7 ? __ldcg(ct_k7 + g) : 0.0f;
    for (int j = 0; j < 7; ++j) cks[j * n + idx] = kBt[j] * (dt * cerr);
    cks[6 * n + idx] += ck7 + d_k7;
    cks[5 * n + idx] -= d_k7;
    seed6[idx] = cyn + d_ynew + to_yn * sign_of(yn);
    g6[idx] = -d_ynew;
    cty[idx] = to_y * sign_of(yv);
    ct_dt += cerr * s_comb;
  }
  return ct_dt;
}

// Element idx of stage i's state cotangent, ct_yi from the dynamics'
// pullback: adds the seeds, then pulls y_i = y + dt * acc_i back into cty,
// ct_dt (valid elements only) and the earlier stages' cks.
__device__ __forceinline__ void stage_reverse(int i, int idx, float ct_yi,
                                              bool valid, const float* ks,
                                              float* cks, const float* seed6,
                                              const float* g6, float* cty,
                                              int n, float dt, float& ct_dt) {
  if (i == 6) ct_yi += seed6[idx];
  if (i == 5) ct_yi += g6[idx];
  cty[idx] += ct_yi;
  if (valid) ct_dt += ct_yi * stage_acc_rn(i, ks, n, idx);
  for (int j = 0; j < i; ++j) {
    const float c = kA[i - 1][j];
    if (c != 0.0f) cks[j * n + idx] += (dt * c) * ct_yi;
  }
}

// The end of a backward tile body: its first `valid` elements of ct_y and
// ct_k1 (from element g0 of the global rows), each the pass-through
// (null: zero) plus the tile's cty, cks[0].
__device__ __forceinline__ void normed_tile_cts(const float* cty, const float* cks,
                                                int valid, size_t g0, const float* pass_y,
                                                const float* pass_k1, float* ct_y,
                                                float* ct_k1) {
  for (int idx = threadIdx.x; idx < valid; idx += kThreads) {
    const size_t g = g0 + idx;
    ct_y[g] = pass_y ? __ldcg(pass_y + g) + cty[idx] : cty[idx];
    ct_k1[g] = pass_k1 ? __ldcg(pass_k1 + g) + cks[idx] : cks[idx];
  }
}

__device__ __forceinline__ float csl_sigmoid(float x) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-x)));
}
__device__ __forceinline__ float csl_softplus(float x) {
  return __fadd_rn(fmaxf(x, 0.0f), log1pf(expf(-fabsf(x))));
}

// Layer l's parameters in shared memory.
struct CslLayer {
  const float *W, *b, *wg, *wb, *bb;
  int n_in, n_out;
};

__device__ __forceinline__ CslLayer csl_layer(const float* wsm, int l, int D, int H) {
  int off = 0;
  for (int j = 0; j < l; ++j) off += csl_pad_layer(j, D, H);
  CslLayer L;
  L.n_in = csl_in(l, D, H);
  L.n_out = csl_out(l, D, H);
  L.W = wsm + off;
  L.b = L.W + L.n_out * (L.n_in + 1);
  L.wg = L.b + L.n_out;
  L.wb = L.b + 2 * L.n_out;
  L.bb = L.b + 3 * L.n_out;
  return L;
}

__device__ void csl_load_weights(const CslLeaves& lv, int D, int H, float* wsm) {
  for (int l = 0; l < 3; ++l) {
    const CslLayer L = csl_layer(wsm, l, D, H);
    float* W = const_cast<float*>(L.W);
    const float* src = lv.p[5 * l];
    for (int idx = threadIdx.x; idx < L.n_out * L.n_in; idx += kThreads) {
      const int o = idx / L.n_in, k = idx - o * L.n_in;
      W[o * (L.n_in + 1) + k] = src[idx];
    }
    float* vec = const_cast<float*>(L.b);
    for (int idx = threadIdx.x; idx < 4 * L.n_out; idx += kThreads) {
      const int j = idx / L.n_out;
      vec[idx] = lv.p[5 * l + 1 + j][idx - j * L.n_out];
    }
  }
}

// The three layers' gates sigmoid(ti w_g) at gbuf (layer l at l * H).
// Ends synchronised.
__device__ void csl_gates(const float* wsm, float ti, float* gbuf, int D, int H) {
  for (int idx = threadIdx.x; idx < 2 * H + D; idx += kThreads) {
    const int l = idx < H ? 0 : (idx < 2 * H ? 1 : 2);
    gbuf[idx] = csl_sigmoid(__fmul_rn(ti, csl_layer(wsm, l, D, H).wg[idx - l * H]));
  }
  __syncthreads();
}

// o = (x W^T + b) * g + (ti w_b + b_b) for the tile's rows (x with row
// stride xs): a and o to a_out, o_out (row strides as, os), softplus(o) to
// h_out (row stride n_out) where given. Ends synchronised.
__device__ void csl_affine(const CslLayer& L, const float* x, int xs,
                           const float* g, float ti, float* a_out, int as,
                           float* o_out, int os, float* h_out) {
  for (int idx = threadIdx.x; idx < kCslRows * L.n_out; idx += kThreads) {
    const int r = idx / L.n_out, o = idx - r * L.n_out;
    const float* xr = x + r * xs;
    const float* w = L.W + o * (L.n_in + 1);
    double s = (double)L.b[o];
    for (int k = 0; k < L.n_in; ++k) s = fma((double)xr[k], (double)w[k], s);
    const float a = (float)s;
    const float ov = __fadd_rn(__fmul_rn(a, g[o]), __fadd_rn(__fmul_rn(ti, L.wb[o]), L.bb[o]));
    a_out[r * as + o] = a;
    o_out[r * os + o] = ov;
    if (h_out) h_out[idx] = csl_softplus(ov);
  }
  __syncthreads();
}

// out[r, k] = sum_{o < n_out} v[r, o] (W[o, k] * g[o]) for k < n_in: a hop
// of the e^T J chain (v with row stride vs, out with row stride os). Ends
// synchronised.
__device__ void csl_hop(const CslLayer& L, const float* v, int vs, const float* g,
                        float* out, int os) {
  for (int idx = threadIdx.x; idx < kCslRows * L.n_in; idx += kThreads) {
    const int r = idx / L.n_in, k = idx - r * L.n_in;
    const float* vr = v + r * vs;
    double s = 0.0;
    for (int o = 0; o < L.n_out; ++o)
      s = fma((double)vr[o], (double)__fmul_rn(L.W[o * (L.n_in + 1) + k], g[o]), s);
    out[r * os + k] = (float)s;
  }
  __syncthreads();
}

// One evaluation of the augmented dynamics for the tile's rows at time ti:
// k (row stride A) from the state x (row stride A) and the probe rows e_s
// (row stride D). rec receives the rows' activations (csl_rec_row floats a
// row); gbuf the gates; hA, hB kCslRows x H of scratch. Ends synchronised.
__device__ void csl_stage(const float* x, float* k, float ti, const float* e_s,
                          float* gbuf, float* rec, float* hA, float* hB,
                          const float* wsm, int A, int D, int H, bool kinetic) {
  const int RF = csl_rec_row(D, H);
  float *a1 = rec, *o1 = rec + H, *a2 = rec + 2 * H, *o2 = rec + 3 * H;
  float *v3 = rec + 4 * H, *v2 = rec + 5 * H, *a3 = rec + 6 * H, *eJ = rec + 6 * H + D;
  const CslLayer L1 = csl_layer(wsm, 0, D, H), L2 = csl_layer(wsm, 1, D, H),
                 L3 = csl_layer(wsm, 2, D, H);
  const float *g1 = gbuf, *g2 = gbuf + H, *g3 = gbuf + 2 * H;
  csl_gates(wsm, ti, gbuf, D, H);
  csl_affine(L1, x, A, g1, ti, a1, RF, o1, RF, hA);        // h1 in hA
  csl_affine(L2, hA, H, g2, ti, a2, RF, o2, RF, hB);       // h2 in hB
  csl_affine(L3, hB, H, g3, ti, a3, RF, k, A, nullptr);    // mz into k
  csl_hop(L3, e_s, D, g3, v3, RF);
  for (int idx = threadIdx.x; idx < kCslRows * H; idx += kThreads) {
    const int r = idx / H, o = idx - r * H;
    hA[idx] = __fmul_rn(v3[r * RF + o], csl_sigmoid(o2[r * RF + o]));
  }
  __syncthreads();
  csl_hop(L2, hA, H, g2, v2, RF);
  for (int idx = threadIdx.x; idx < kCslRows * H; idx += kThreads) {
    const int r = idx / H, o = idx - r * H;
    hA[idx] = __fmul_rn(v2[r * RF + o], csl_sigmoid(o1[r * RF + o]));
  }
  __syncthreads();
  csl_hop(L1, hA, H, g1, eJ, RF);
  // the row sums: -sum(eJ e), and with the kinetic terms sum mz^2, sum eJ^2
  for (int q = threadIdx.x; q < kCslRows * (kinetic ? 3 : 1); q += kThreads) {
    const int r = q % kCslRows, which = q / kCslRows;
    const float* u = which == 1 ? k + r * A : eJ + r * RF;
    const float* w = which == 0 ? e_s + r * D : u;
    double s = 0.0;
    for (int c = 0; c < D; ++c) s = fma((double)u[c], (double)w[c], s);
    k[r * A + D + which] = which == 0 ? -(float)s : (float)s;
  }
  __syncthreads();
}

// Loads the tile's y, k1 and probe rows (zero past the batch end) and runs
// the six stages at t_i = t + c_i dt: ks[i] = f(t_i, y + dt * acc_i). On
// return ystage holds y_new (the stage-6 state) and g6 the stage-5 state;
// stage i's activations are at recs + (i - 1) * rec_step (rec_step 0: one
// record, overwritten).
__device__ void csl_recompute(const float* y_g, const float* k1_g, const float* e_g,
                              int row0, int rows, float t, float dt, float* y_s,
                              float* ks, float* ystage, float* g6, float* e_s,
                              float* gbuf, float* recs, int rec_step, float* hA,
                              float* hB, const float* wsm, int A, int D, int H,
                              bool kinetic) {
  const int n = kCslRows * A;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const bool valid = idx < rows * A;
    y_s[idx] = valid ? __ldcg(y_g + (size_t)row0 * A + idx) : 0.0f;
    ks[idx] = valid ? __ldcg(k1_g + (size_t)row0 * A + idx) : 0.0f;
  }
  for (int idx = threadIdx.x; idx < kCslRows * D; idx += kThreads)
    e_s[idx] = idx < rows * D ? e_g[(size_t)row0 * D + idx] : 0.0f;
  for (int i = 1; i <= 6; ++i) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const float v = __fadd_rn(y_s[idx], __fmul_rn(dt, stage_acc_rn(i, ks, n, idx)));
      ystage[idx] = v;
      if (i == 5) g6[idx] = v;
    }
    __syncthreads();
    const float ti = __fadd_rn(t, __fmul_rn(kC[i], dt));
    csl_stage(ystage, ks + i * n, ti, e_s, gbuf, recs + (i - 1) * rec_step, hA, hB,
              wsm, A, D, H, kinetic);
  }
}

// K7-CSL's body for one tile [row0, row0 + rows): writes the tile's y_new
// and k7 rows and its three norm sums (err, num, den) to sums_out. wsm
// holds the padded parameters; smem csl_fwd_tile_floats of scratch.
__device__ void csl_fwd_tile(const float* y, const float* k1, const float* e,
                             int row0, int rows, float t, float dt,
                             const float* wsm, float* y_new, float* k7,
                             float* sums_out, int A, int D, int H, bool kinetic,
                             float rtol, float atol, float* smem) {
  const int n = kCslRows * A;
  float* y_s = smem;
  float* ks = y_s + n;  // 7 x n
  float* ystage = ks + 7 * n;
  float* g6 = ystage + n;
  float* e_s = g6 + n;
  float* gbuf = e_s + kCslRows * D;
  float* rec = gbuf + 2 * H + D;
  float* hA = rec + kCslRows * csl_rec_row(D, H);
  float* hB = hA + kCslRows * H;
  float* red = hB + kCslRows * H;
  csl_recompute(y, k1, e, row0, rows, t, dt, y_s, ks, ystage, g6, e_s, gbuf, rec,
                0, hA, hB, wsm, A, D, H, kinetic);
  normed_tile_out(y_s, ks, ystage, g6, n, rows * A, (size_t)row0 * A, dt, rtol,
                  atol, y_new, k7, red, sums_out);
}

// K8-CSL's body for one tile: the hand reverse chain of K7-CSL (the algebra
// of ops/fused_csl.py _csl_bwd_math), seeded with the row cotangents
// ct_ynew, ct_k7 (null: zero) and the norm sums' cotangents c_err, c_num,
// c_den. Writes ct_y = pass_y + (the tile's ct_y), ct_k1 = pass_k1 + (its
// ct_k1) (pass_*: null for zero; ct_ynew/ct_k7 may alias the outputs: each
// element is read before its own write, by the same thread), adds the
// tile's parameter cotangents to cw (csl_leaf_floats, the leaves' layout;
// shared memory, each element owned by one thread) and writes the tile's
// (ct_t, ct_dt) to part_out. The probe gets no cotangent. Per stage, at t_i
// = t + c_i dt: the hops' pullbacks (q_l = ct_out W_l^T, so ct_u_l = g_l q_l;
// sigmoid' = s (1 - s) into ct_o), then the layers' (ct_a = ct_o g), each
// weight's two uses (x^T ct_a and (u g)^T ct_out), and the gates' and
// time-biases' dependence on t_i. wsm holds the padded parameters; smem
// csl_bwd_tile_floats floats.
__device__ void csl_bwd_tile(const float* y, const float* k1, const float* e,
                             int row0, int rows, float t, float dt,
                             const float* wsm, float* cw, const float* ct_ynew,
                             const float* ct_k7, const float* pass_y,
                             const float* pass_k1, float c_err, float c_num,
                             float c_den, float* ct_y, float* ct_k1,
                             float* part_out, int A, int D, int H, bool kinetic,
                             float rtol, float atol, float* smem) {
  constexpr int R = kCslRows;
  const int n = R * A;
  const int W = D > H ? D : H;
  const int RF = csl_rec_row(D, H);
  float* y_s = smem;
  float* ks = y_s + n;          // 7 x n
  float* cks = ks + 7 * n;      // 7 x n, the stage derivatives' cotangents
  float* ystage = cks + 7 * n;  // y_new after the recompute
  float* g6 = ystage + n;       // stage-5 state, then its seed -d_ynew
  float* seed6 = g6 + n;
  float* cty = seed6 + n;
  float* e_s = cty + n;
  float* gbuf = e_s + R * D;
  float* recs = gbuf + 2 * H + D;  // 6 x R x RF
  float* hA = recs + 6 * R * RF;  // h1 in the reverse
  float* hB = hA + R * H;         // h2 in the reverse
  float* buf = hB + R * H;        // kCslBwdBufs x R x W
  float *c_o1 = buf, *c_o2 = buf + R * W, *c_o3 = buf + 2 * R * W;
  float *c_a1 = buf + 3 * R * W, *c_a2 = buf + 4 * R * W, *c_a3 = buf + 5 * R * W;
  float *c_ej = buf + 6 * R * W, *c_v2 = buf + 7 * R * W, *c_v3 = buf + 8 * R * W;
  float *uq1 = buf + 9 * R * W, *uq2 = buf + 10 * R * W, *uq3 = buf + 11 * R * W;
  float *ug1 = buf + 12 * R * W, *ug2 = buf + 13 * R * W;
  float *zb = buf + 14 * R * W, *cz = buf + 15 * R * W;
  float* red = buf + kCslBwdBufs * R * W;

  csl_recompute(y, k1, e, row0, rows, t, dt, y_s, ks, ystage, g6, e_s, gbuf, recs,
                R * RF, hA, hB, wsm, A, D, H, kinetic);
  __syncthreads();
  float ct_dt = normed_seeds(y_s, ks, ystage, cks, g6, seed6, cty, n, rows * A,
                             (size_t)row0 * A, ct_ynew, ct_k7, dt, c_err, c_num,
                             c_den, rtol, atol);
  float ct_t = 0.0f;
  const CslLayer L1 = csl_layer(wsm, 0, D, H), L2 = csl_layer(wsm, 1, D, H),
                 L3 = csl_layer(wsm, 2, D, H);
  const float *g1 = gbuf, *g2 = gbuf + H, *g3 = gbuf + 2 * H;

  for (int i = 6; i >= 1; --i) {
    const float ti = __fadd_rn(t, __fmul_rn(kC[i], dt));
    const float* rec = recs + (i - 1) * R * RF;
    const float* cur = cks + i * n;  // ct of the stage derivative
    float ct_ti = 0.0f;
    __syncthreads();
    csl_gates(wsm, ti, gbuf, D, H);
    // the stage's z, recomputed as the forward did; ct_o3 and ct_eJ
    for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
      const int r = idx / D, o = idx - r * D;
      const int s = r * A + o;
      zb[r * W + o] = __fadd_rn(y_s[s], __fmul_rn(dt, stage_acc_rn(i, ks, n, s)));
      float co = cur[s];
      float cej = -cur[r * A + D] * e_s[idx];
      if (kinetic) {
        co += 2.0f * cur[r * A + D + 1] * ks[i * n + s];
        cej += 2.0f * cur[r * A + D + 2] * rec[r * RF + 6 * H + D + o];
      }
      c_o3[r * W + o] = co;
      c_ej[r * W + o] = cej;
    }
    __syncthreads();
    // hop 1: eJ = u1 (W1 g1), u1 = v2 s1
    for (int idx = threadIdx.x; idx < R * H; idx += kThreads) {
      const int r = idx / H, o = idx - r * H;
      float q = 0.0f;
      for (int k = 0; k < D; ++k) q = fmaf(c_ej[r * W + k], L1.W[o * (D + 1) + k], q);
      const float s1 = csl_sigmoid(rec[r * RF + H + o]), v2 = rec[r * RF + 5 * H + o];
      const float u1 = __fmul_rn(v2, s1), gq = g1[o] * q;
      c_v2[r * W + o] = gq * s1;
      c_o1[r * W + o] = gq * v2 * (s1 * (1.0f - s1));
      uq1[r * W + o] = u1 * q;
      ug1[r * W + o] = u1 * g1[o];
    }
    __syncthreads();
    // hop 2: v2 = u2 (W2 g2), u2 = v3 s2
    for (int idx = threadIdx.x; idx < R * H; idx += kThreads) {
      const int r = idx / H, o = idx - r * H;
      float q = 0.0f;
      for (int k = 0; k < H; ++k) q = fmaf(c_v2[r * W + k], L2.W[o * (H + 1) + k], q);
      const float s2 = csl_sigmoid(rec[r * RF + 3 * H + o]), v3 = rec[r * RF + 4 * H + o];
      const float u2 = __fmul_rn(v3, s2), gq = g2[o] * q;
      c_v3[r * W + o] = gq * s2;
      c_o2[r * W + o] = gq * v3 * (s2 * (1.0f - s2));
      uq2[r * W + o] = u2 * q;
      ug2[r * W + o] = u2 * g2[o];
    }
    __syncthreads();
    // hop 3: v3 = e (W3 g3); the probe takes no cotangent. Layer 3: ct_a3
    for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
      const int r = idx / D, o = idx - r * D;
      float q = 0.0f;
      for (int k = 0; k < H; ++k) q = fmaf(c_v3[r * W + k], L3.W[o * (H + 1) + k], q);
      uq3[r * W + o] = e_s[idx] * q;
      c_a3[r * W + o] = c_o3[r * W + o] * g3[o];
    }
    __syncthreads();
    // ct_h2 = ct_a3 W3 into ct_o2 through softplus' = s2; h2 for cW3
    for (int idx = threadIdx.x; idx < R * H; idx += kThreads) {
      const int r = idx / H, k = idx - r * H;
      float s = 0.0f;
      for (int o = 0; o < D; ++o) s = fmaf(c_a3[r * W + o], L3.W[o * (H + 1) + k], s);
      const float o2 = rec[r * RF + 3 * H + k];
      c_o2[r * W + k] += s * csl_sigmoid(o2);
      hB[idx] = csl_softplus(o2);
      c_a2[r * W + k] = c_o2[r * W + k] * g2[k];
    }
    __syncthreads();
    // ct_h1 = ct_a2 W2 into ct_o1; h1 for cW2
    for (int idx = threadIdx.x; idx < R * H; idx += kThreads) {
      const int r = idx / H, k = idx - r * H;
      float s = 0.0f;
      for (int o = 0; o < H; ++o) s = fmaf(c_a2[r * W + o], L2.W[o * (H + 1) + k], s);
      const float o1 = rec[r * RF + H + k];
      c_o1[r * W + k] += s * csl_sigmoid(o1);
      hA[idx] = csl_softplus(o1);
      c_a1[r * W + k] = c_o1[r * W + k] * g1[k];
    }
    __syncthreads();
    // ct_z = ct_a1 W1
    for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
      const int r = idx / D, k = idx - r * D;
      float s = 0.0f;
      for (int o = 0; o < H; ++o) s = fmaf(c_a1[r * W + o], L1.W[o * (D + 1) + k], s);
      cz[r * W + k] = s;
    }
    // the parameters' cotangents, one owner an element: W gets x^T ct_a
    // and (u g)^T ct_out; b, w_g, w_b, b_b the row sums
    float* cwl = cw;
    for (int l = 0; l < 3; ++l) {
      const CslLayer L = l == 0 ? L1 : (l == 1 ? L2 : L3);
      const float* x = l == 0 ? zb : (l == 1 ? hA : hB);
      const int xs = l == 0 ? W : H;
      const float* c_a = l == 0 ? c_a1 : (l == 1 ? c_a2 : c_a3);
      const float* c_o = l == 0 ? c_o1 : (l == 1 ? c_o2 : c_o3);
      const float* hop = l == 0 ? c_ej : (l == 1 ? c_v2 : c_v3);
      const float* uq = l == 0 ? uq1 : (l == 1 ? uq2 : uq3);
      const float* g = gbuf + l * H;
      const float* a = rec + (l == 0 ? 0 : (l == 1 ? 2 * H : 6 * H));
      for (int el = threadIdx.x; el < L.n_out * L.n_in; el += kThreads) {
        const int o = el / L.n_in, k = el - o * L.n_in;
        float s = cwl[el];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float ug = l == 0 ? ug1[r * W + o]
                         : (l == 1 ? ug2[r * W + o] : e_s[r * D + o] * g3[o]);
          s = fmaf(c_a[r * W + o], x[r * xs + k], s);
          s = fmaf(ug, hop[r * W + k], s);
        }
        cwl[el] = s;
      }
      float* cv = cwl + L.n_out * L.n_in;  // b, w_g, w_b, b_b
      for (int o = threadIdx.x; o < L.n_out; o += kThreads) {
        float co = 0.0f, ca = 0.0f, cg = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          co += c_o[r * W + o];
          ca += c_a[r * W + o];
          cg += c_o[r * W + o] * a[r * RF + o] + uq[r * W + o];
        }
        const float dg = cg * (g[o] * (1.0f - g[o]));
        cv[o] += ca;
        cv[L.n_out + o] += dg * ti;
        cv[2 * L.n_out + o] += co * ti;
        cv[3 * L.n_out + o] += co;
        ct_ti += co * L.wb[o] + dg * L.wg[o];
      }
      cwl += csl_leaf_layer(l, D, H);
    }
    __syncthreads();
    // the stage state's cotangent (z's; the aux columns feed nothing),
    // the seeds and the lincomb transposes
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const int r = idx / A, c = idx - r * A;
      stage_reverse(i, idx, c < D ? cz[r * W + c] : 0.0f, idx < rows * A, ks, cks,
                    seed6, g6, cty, n, dt, ct_dt);
    }
    ct_t += ct_ti;
    ct_dt += kC[i] * ct_ti;
  }
  __syncthreads();
  normed_tile_cts(cty, cks, rows * A, (size_t)row0 * A, pass_y, pass_k1, ct_y, ct_k1);
  const float part[2] = {ct_t, ct_dt};
  block_sum_to<2>(part, red, part_out);
}

CslLeaves pack_csl_leaves(const float* const* leaves) {
  CslLeaves lv{};
  for (int j = 0; j <= kCslParams; ++j) lv.p[j] = leaves[j];
  return lv;
}

}  // namespace
