// Device code of AlternatingMLP's normed Tsit5 trial step, shared by the
// step kernels (altmlp_tsit5.cu, K7/K8) and the whole-solve kernels
// (whole_solve.cu, K3/K4): the forward tile body (altmlp_forward_tile,
// 2-row tiles, kAltRows), the reverse tile body (altmlp_reverse_tile, 2-row
// tiles, kAltBwdRows), and the seeds algebra of a normed step's reverse,
// which FFJORD's reverse body (csl_tsit5.cuh) runs too.
//
//   f(y) = tanh(... tanh(down_0(tanh(up_0(tanh(y))))) ...), depth x (up, down),
//   up_i: nn.Linear(D, H), down_i: nn.Linear(H, D), no time input.
//
// The leaves live in shared memory: the reverse body's copy (load_weights)
// with each weight row padded to an odd stride so that neither the products
// over inputs (threads over outputs) nor those over outputs (threads over
// inputs) have bank conflicts, the forward's (alt_fwd_load_weights) in the
// leaves' own layout. Arithmetic is IEEE (no fast math, no TF32), tanh the
// accurate tanhf. The forward reproduces its plain version
// (ops/fused_generic.py plain_altmlp_normed_sweep) rounding for rounding:
// each affine map is summed in f64 and rounded once to f32 (as the plain
// version's f64 addmm), and the stage and error lincombs round each multiply
// and add as PyTorch's separate ops do (__fmul_rn/__fadd_rn, no contraction
// into an FMA).
//
// Rows the whole solve writes and later reads again are read with __ldcg,
// through L2 (see normed_tsit5.cuh).

#pragma once

#include "normed_tsit5.cuh"

namespace {

constexpr int kAltRows = 2;      // rows of the batch per forward tile
constexpr int kMaxLeaves = 32;   // 4 leaves a depth level: depth <= 8

struct AltLeaves {
  const float* p[kMaxLeaves];    // up_0.weight, up_0.bias, down_0.weight, ...
};

// acc_i = sum_j a[i-1][j] * k_j, first term first, each multiply and add
// rounded on its own (the order and roundings of the plain version).
__device__ __forceinline__ float stage_acc_rn(int i, const float* ks, int stride,
                                              int idx) {
  float acc = __fmul_rn(kA[i - 1][0], ks[idx]);
  for (int j = 1; j < i; ++j)
    acc = __fadd_rn(acc, __fmul_rn(kA[i - 1][j], ks[j * stride + idx]));
  return acc;
}

// s_comb = sum_{j>=1} bt_j (k_j - k_0) in the plain version's order and
// roundings; the embedded error is dt * s_comb.
__device__ __forceinline__ float err_comb_rn(const float* ks, int n, int idx) {
  const float k0 = ks[idx];
  float s = __fmul_rn(kBt[1], __fsub_rn(ks[n + idx], k0));
  for (int j = 2; j <= 6; ++j) s = __fadd_rn(s, __fmul_rn(kBt[j], __fsub_rn(ks[j * n + idx], k0)));
  return s;
}

// The seeds of a backward tile body from the outputs' cotangents: the
// stage derivatives' cotangents cks (7 x n), the stage-6 seed seed6, the
// stage-5 seed (into g6, which held the stage-5 state) and cty, the
// direct cotangent of y. Elements past `valid` (rows past the batch end)
// get none, so they add nothing to the parameter cotangents. Returns this
// thread's share of ct_dt. K8's and K8-CSL's reverse bodies both start here.
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

__host__ __device__ __forceinline__ int layer_in(int l, int D, int H) { return (l & 1) ? H : D; }
__host__ __device__ __forceinline__ int layer_out(int l, int D, int H) { return (l & 1) ? D : H; }

// Floats of the padded weights in shared memory: per layer W (out x (in+1))
// then b (out).
__host__ __device__ inline int padded_weight_floats(int depth, int D, int H) {
  return depth * (H * (D + 1) + H + D * (H + 1) + D);
}

// Floats of the leaves as given (nn.Linear layout, unpadded).
__host__ __device__ inline int leaf_floats(int depth, int D, int H) {
  return depth * (H * D + H + D * H + D);
}

__device__ void load_weights(const AltLeaves& lv, int depth, int D, int H,
                             float* wsm) {
  int off = 0;
  for (int l = 0; l < 2 * depth; ++l) {
    const int n_in = layer_in(l, D, H), n_out = layer_out(l, D, H);
    const float* W = lv.p[2 * l];
    const float* b = lv.p[2 * l + 1];
    for (int idx = threadIdx.x; idx < n_out * n_in; idx += kThreads) {
      const int o = idx / n_in, k = idx - o * n_in;
      wsm[off + o * (n_in + 1) + k] = W[idx];
    }
    for (int o = threadIdx.x; o < n_out; o += kThreads)
      wsm[off + n_out * (n_in + 1) + o] = b[o];
    off += n_out * (n_in + 1) + n_out;
  }
}

// ---------------------------------------------------------------------------
// The reverse tile body of K8 and K4 (AltDyn in whole_solve.cu).
//
// A tile is kAltBwdRows = 2 rows of the batch, one block of kThreads: at
// the latent ODE's batch of 256 that is 128 tiles, one wave. Per trial step
// the body recomputes the six stages, then walks them in reverse. Each layer
// of either walk is one phase between two block barriers, and every phase
// has the block's threads at work on the tile's rows:
//   * a product item is one output and kAltGroup rows (independent chains
//     in one thread, one weight load for all of them); 2^alt_split_lg(n)
//     lanes of a warp share each sum of n terms, lane s taking the terms s,
//     s + S, ... (four a trip, their loads issued first), so no lane runs
//     more than kAltChain terms, and a butterfly of shuffles adds the
//     partials in a fixed order (every lane ends with the same bits);
//   * the recompute's affine maps are f64 sums (from the bias, of the rows'
//     exact f64 copies times the f32 weights) rounded once to f32, as K7's
//     chains are: the stage values are K7's except where an f64 sum lies
//     within its own rounding error of an f32 tie;
//   * the reverse's products are IEEE f32. The phase that writes a layer's
//     input cotangent multiplies it by the layer below's 1 - h^2 before
//     storing it: that is the next layer's pre-activation cotangent, so one
//     barrier a layer suffices. Layer 0's phase also runs the stage's
//     lincomb transposes (stage_reverse), the next stage's first
//     pre-activation cotangent, element by element, and the stage's weight
//     and bias cotangents (alt_cw_stage), from the stage's pre-activation
//     cotangents of every layer (gps);
//   * the weight and bias cotangents are held by their owner threads for
//     the whole launch (K8) or walk (K4): a thread owns one 2 x 2 tile of
//     each layer's weight and one bias element, in registers for the first
//     kAltRegLayers layers (AltCw), updated over the tile's rows in order;
//     what registers do not hold (deeper networks, wider layers) lives in
//     shared memory (leaf layout), each element with one owner. They reach
//     the block's slot once, at the end.
// The stages' activation records (h_0 .. h_{2 depth - 1}; the stage
// derivative is ks[i]) stay in shared memory for stages 5 and 6; stages 1 to
// 4 also go to a per-block scratch in device memory, and each comes back by
// cp.async while the stage after it is reversed. The tile's share of ct_dt
// is summed in f64 and rounded once. Every sum has a fixed order: no
// atomics, bitwise reproducible. Rows a tile, terms a lane and the rest were
// chosen on the H100 (tools/torch_altmlp_variants.py): 2-row tiles ran 0.65x
// the time of 8-row ones, a layer's phase costs about 1 us whatever it does,
// so the tile's rows are spread over as many blocks as the card holds.
// ---------------------------------------------------------------------------

constexpr int kAltBwdRows = 2;      // rows of the batch per reverse tile
constexpr int kAltGroup = kAltBwdRows < 4 ? kAltBwdRows : 4;  // rows of a product item
constexpr int kAltChain = 7;        // most terms of one lane's share of a sum
constexpr int kAltRegLayers = 8;    // layers whose cotangents sit in registers

__host__ __device__ inline int alt_pad4(int n) { return (n + 3) & ~3; }

// log2 of the lanes that share one sum of n terms: the fewest (a power of
// two, at most 32) that leave each lane at most kAltChain terms. The lanes
// find their share by shifts and masks: a division by a count known only at
// run time is a chain of ~20 dependent instructions, and a phase ran several.
__host__ __device__ inline int alt_split_lg(int n) {
  int lg = 0;
  while (lg < 5 && ((n + (1 << lg) - 1) >> lg) > kAltChain) ++lg;
  return lg;
}

// One stage's activation record: h_0 (= tanh(y_i), D wide), h_1 (H), h_2
// (D), ..., h_{2 depth - 1} (H), each kAltBwdRows rows at its width rounded
// up to 4; and the offset of h_j in it. A stage's pre-activation
// cotangents (gps) take the same layout: layer l's (n_out wide) at h_{l+1}'s
// place, layer 2 depth - 1's (D wide) at h_0's.
__host__ __device__ inline int alt_record_floats(int depth, int D, int H) {
  return kAltBwdRows * depth * (alt_pad4(D) + alt_pad4(H));
}
__host__ __device__ inline int alt_record_at(int j, int D, int H) {
  return kAltBwdRows * ((j >> 1) * (alt_pad4(D) + alt_pad4(H)) + ((j & 1) ? alt_pad4(D) : 0));
}

// Floats of one block's records in device memory: stages 1 to 4.
__host__ __device__ inline int alt_reverse_records(int depth, int D, int H) {
  return 4 * alt_record_floats(depth, D, H);
}

// 2 x 2 (output x input) weight-cotangent tiles of layer l (both kinds of
// layer have as many), and whether some cotangent lives in shared memory:
// past kAltRegLayers layers, past one tile a thread, past one bias element
// a thread.
__host__ __device__ inline int alt_cw_tiles(int D, int H) {
  return ((D + 1) / 2) * ((H + 1) / 2);
}
__host__ __device__ inline bool alt_cw_in_smem(int depth, int D, int H) {
  return 2 * depth > kAltRegLayers || alt_cw_tiles(D, H) > kThreads || D > kThreads ||
         H > kThreads;
}

// The thread's register-held cotangents: of layer l < kAltRegLayers its 2 x
// 2 weight tile (tile threadIdx.x; outputs o0, o0 + 1 x inputs k0, k0 + 1,
// row-major) and its bias element (output threadIdx.x).
struct AltCw {
  float w[kAltRegLayers][4];
  float b[kAltRegLayers];
};

// The reverse tile's shared memory: the stage state (y_s .. cty, R x D
// each, ks and cks 7 of them), two stages' records (stage i in rec(i)) and
// pre-activation cotangents of every layer (gps(i), by stage parity), two
// f64 row copies (a layer's input, its output) at the widest layer's width
// rounded up to 4, the f64 block sum, and the cotangents held in shared
// memory (leaf layout; null where registers hold them all).
struct AltReverseSmem {
  float *y_s, *ks, *cks, *ystage, *g6, *seed6, *cty;
  // the pairs by parity, picked by a select (an indexed pair would put the
  // whole struct in local memory)
  float *rec0, *rec1, *gps0, *gps1;
  __device__ float* rec(int i) const { return (i & 1) ? rec1 : rec0; }
  __device__ float* gps(int i) const { return (i & 1) ? gps1 : gps0; }
  double *xa, *xb, *red;
  float* cw;
};

// Floats of the reverse tile (each part a multiple of 4, from a 16-byte
// aligned base); with a base, its parts' addresses to *s.
__host__ __device__ inline int alt_reverse_floats(int depth, int D, int H, float* base = nullptr,
                                                  AltReverseSmem* s = nullptr) {
  constexpr int R = kAltBwdRows;
  const int n = R * D, pw = R * (D > H ? alt_pad4(D) : alt_pad4(H));
  const int rec = alt_record_floats(depth, D, H);
  int off = 0;
  auto take = [&](int floats) {
    float* p = base ? base + off : nullptr;
    off += alt_pad4(floats);
    return p;
  };
  auto take64 = [&](int doubles) { return reinterpret_cast<double*>(take(2 * doubles)); };
  AltReverseSmem t;
  t.y_s = take(n);
  t.ks = take(7 * n);
  t.cks = take(7 * n);
  t.ystage = take(n);
  t.g6 = take(n);
  t.seed6 = take(n);
  t.cty = take(n);
  t.rec0 = take(rec);
  t.rec1 = take(rec);
  t.gps0 = take(rec);
  t.gps1 = take(rec);
  t.xa = take64(pw);
  t.xb = take64(pw);
  t.red = take64(kWarps);
  t.cw = alt_cw_in_smem(depth, D, H) ? take(leaf_floats(depth, D, H)) : nullptr;
  if (s) *s = t;
  return off;
}

// Bytes of shared memory of a block that holds the padded weights and runs
// reverse tiles (4 floats of slack to align the tile).
size_t altmlp_bwd_smem_bytes(int depth, int D, int H) {
  return sizeof(float) *
         ((size_t)padded_weight_floats(depth, D, H) + 4 + alt_reverse_floats(depth, D, H));
}

// The reverse tile's parts in the shared memory after the padded weights.
__device__ __forceinline__ AltReverseSmem alt_reverse_smem(float* smem, int depth, int D, int H) {
  // aligned to 16 bytes by an offset, not by a cast through an integer: so
  // the compiler still knows every part to be shared memory (after such a
  // cast each access was a generic one, LD.E for LDS)
  const int pad = (4 - ((int)__cvta_generic_to_shared(smem) >> 2 & 3)) & 3;
  AltReverseSmem s;
  alt_reverse_floats(depth, D, H, smem + pad, &s);
  return s;
}

// out[r, o] = b[o] + sum_{k < K} x[r, k] W[o, k] for the tile's rows and o <
// N, x the rows' f64 copies (row stride px), W padded rows of K + 1: each
// sum in f64, rounded once; lane s of the S = 2^alt_split_lg(K) sharing it
// takes k = s, s + S, ... (lane 0 from b[o]), and hands rows j = s, s + S,
// ... of its item to epi(r, o, value), one inlined copy of epi picking the
// row at run time (a copy a row made the kernel 1.08x slower at 2 rows,
// 1.30x at 8: the phases' code outgrows the instruction cache).
template <class Epi>
__device__ __forceinline__ void alt_affine_rows(const float* W, const float* b, int K, int N,
                                                const double* x, int px, Epi epi) {
  constexpr int G = kAltGroup, NG = kAltBwdRows / G;
  const int lg = alt_split_lg(K), S = 1 << lg, items = (N * NG) << lg;
  for (int base = 0; base < items; base += kThreads) {  // the same trips in every lane
    const int item = base + threadIdx.x, s = item & (S - 1);
    const bool live = item < items;
    const int og = live ? item >> lg : 0, o = og / NG, g = og - o * NG;
    const double* xr = x + (size_t)g * G * px;
    const float* w = W + o * (K + 1);
    double acc[G];
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j] = s == 0 ? (double)b[o] : 0.0;
    // four terms a trip, their loads issued before their FMAs (a trip a
    // term waited out the loads' latency every term)
    int k = s;
    for (; k + 3 * S < K; k += 4 * S) {
      double wk[4], xv[4][G];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wk[q] = w[k + q * S];
#pragma unroll
        for (int j = 0; j < G; ++j) xv[q][j] = xr[j * px + k + q * S];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < G; ++j) acc[j] = fma(xv[q][j], wk[q], acc[j]);
    }
    for (; k < K; k += S) {
      const double wk = w[k];
#pragma unroll
      for (int j = 0; j < G; ++j) acc[j] = fma(xr[j * px + k], wk, acc[j]);
    }
    for (int m = 1; m < S; m <<= 1)
#pragma unroll
      for (int j = 0; j < G; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], m);
    if (live)
      for (int j = s; j < G; j += S) {
        double v = acc[0];
#pragma unroll
        for (int q = 1; q < G; ++q)
          if (q == j) v = acc[q];
        epi(g * G + j, o, (float)v);
      }
  }
}

// out[r, k] = sum_{o < N} v[r, o] W[o, k] for k < K (v row-major, row
// stride pv; W padded rows of K + 1), f32, the sum split over o as
// alt_affine_rows splits it; epi(r, k, value).
template <class Epi>
__device__ __forceinline__ void alt_xw_rows(const float* W, int K, int N, const float* v, int pv,
                                            Epi epi) {
  constexpr int G = kAltGroup, NG = kAltBwdRows / G;
  const int lg = alt_split_lg(N), S = 1 << lg, items = (K * NG) << lg;
  for (int base = 0; base < items; base += kThreads) {
    const int item = base + threadIdx.x, s = item & (S - 1);
    const bool live = item < items;
    const int kg = live ? item >> lg : 0, k = kg / NG, g = kg - k * NG;
    const float* vr = v + g * G * pv;
    float acc[G];
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j] = 0.0f;
    int o = s;  // four terms a trip, as alt_affine_rows
    for (; o + 3 * S < N; o += 4 * S) {
      float wk[4], vv[4][G];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wk[q] = W[(o + q * S) * (K + 1) + k];
#pragma unroll
        for (int j = 0; j < G; ++j) vv[q][j] = vr[j * pv + o + q * S];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < G; ++j) acc[j] = fmaf(vv[q][j], wk[q], acc[j]);
    }
    for (; o < N; o += S) {
      const float wk = W[o * (K + 1) + k];
#pragma unroll
      for (int j = 0; j < G; ++j) acc[j] = fmaf(vr[j * pv + o], wk, acc[j]);
    }
    for (int m = 1; m < S; m <<= 1)
#pragma unroll
      for (int j = 0; j < G; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], m);
    if (live)
      for (int j = s; j < G; j += S) {
        float v = acc[0];
#pragma unroll
        for (int q = 1; q < G; ++q)
          if (q == j) v = acc[q];
        epi(g * G + j, k, v);
      }
  }
}

// One 2 x 2 weight-cotangent tile's share of a layer's x^T gp: per row in
// order, w[2i + j] += gp[r, o0 + i] h[r, k0 + j].
__device__ __forceinline__ void alt_cw_rows(float (&w)[4], const float* gp, int pg,
                                            const float* h, int ph, int o0, int k0) {
#pragma unroll
  for (int r = 0; r < kAltBwdRows; ++r) {
    const float2 a = *reinterpret_cast<const float2*>(gp + r * pg + o0);
    const float2 x = *reinterpret_cast<const float2*>(h + r * ph + k0);
    w[0] = fmaf(a.x, x.x, w[0]);
    w[1] = fmaf(a.x, x.y, w[1]);
    w[2] = fmaf(a.y, x.x, w[2]);
    w[3] = fmaf(a.y, x.y, w[3]);
  }
}

// Offset of layer l's weight cotangent in the leaf layout (its bias's
// follows it).
__device__ __forceinline__ int alt_leaf_at(int l, int D, int H) {
  return (l >> 1) * (2 * H * D + H + D) + ((l & 1) ? H * D + H : 0);
}

// One stage's share of the tile's weight and bias cotangents: layer l's
// pre-activation cotangent at gps + alt_record_at((l + 1) % (2 depth)), its
// input at rec + alt_record_at(l). Tile t and bias element t of a layer
// belong to thread t % kThreads: in registers (cw) for the first of each
// where l < kAltRegLayers, else in shared memory (cs, the leaf layout).
__device__ __forceinline__ void alt_cw_stage(AltCw& cw, float* cs, const float* gps,
                                             const float* rec, int depth, int D, int H) {
  const int nl = 2 * depth, tiles = alt_cw_tiles(D, H), t0 = threadIdx.x;
  // the thread's tile of a layer of each kind: first output and input
  const int nke = (D + 1) / 2, nko = (H + 1) / 2;
  const int o0e = 2 * (t0 / nke), k0e = 2 * (t0 % nke), o0o = 2 * (t0 / nko),
            k0o = 2 * (t0 % nko);
#pragma unroll
  for (int q = 0; q < kAltRegLayers; ++q) {
    if (q >= nl) break;
    const int n_in = layer_in(q, D, H), n_out = layer_out(q, D, H);
    const int pg = alt_pad4(n_out);
    const float* gp = gps + alt_record_at(q + 1 == nl ? 0 : q + 1, D, H);
    if (t0 < tiles)
      alt_cw_rows(cw.w[q], gp, pg, rec + alt_record_at(q, D, H), alt_pad4(n_in),
                  (q & 1) ? o0o : o0e, (q & 1) ? k0o : k0e);
    if (t0 < n_out)
#pragma unroll
      for (int r = 0; r < kAltBwdRows; ++r) cw.b[q] += gp[r * pg + t0];
  }
  if (!cs) return;
  for (int l = 0; l < nl; ++l) {
    const int n_in = layer_in(l, D, H), n_out = layer_out(l, D, H), nk2 = (n_in + 1) / 2;
    const int pg = alt_pad4(n_out), ph = alt_pad4(n_in);
    const float* gp = gps + alt_record_at(l + 1 == nl ? 0 : l + 1, D, H);
    const float* h = rec + alt_record_at(l, D, H);
    float* cW = cs + alt_leaf_at(l, D, H);
    const int first = l < kAltRegLayers ? t0 + kThreads : t0;
    for (int t = first; t < tiles; t += kThreads) {
      const int o0 = 2 * (t / nk2), k0 = 2 * (t % nk2);
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = o0 + e / 2, k = k0 + e % 2;
        w[e] = o < n_out && k < n_in ? cW[o * n_in + k] : 0.0f;
      }
      alt_cw_rows(w, gp, pg, h, ph, o0, k0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = o0 + e / 2, k = k0 + e % 2;
        if (o < n_out && k < n_in) cW[o * n_in + k] = w[e];
      }
    }
    for (int o = first; o < n_out; o += kThreads) {
      float b = cW[n_out * n_in + o];
      for (int r = 0; r < kAltBwdRows; ++r) b += gp[r * pg + o];
      cW[n_out * n_in + o] = b;
    }
  }
}

// Zeroes the thread's cotangents (registers) and the block's shared-memory
// ones (smem: after the padded weights); a barrier follows before the
// first tile body reads them.
__device__ void alt_reverse_begin(AltCw& cw, float* smem, int depth, int D, int H) {
#pragma unroll
  for (int q = 0; q < kAltRegLayers; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) cw.w[q][e] = 0.0f;
    cw.b[q] = 0.0f;
  }
  float* cs = alt_reverse_smem(smem, depth, D, H).cw;
  if (cs)
    for (int e = threadIdx.x; e < leaf_floats(depth, D, H); e += kThreads) cs[e] = 0.0f;
}

// The block's weight and bias cotangents to slot (leaf layout, nn.Linear),
// each element by its owner thread.
__device__ void alt_cw_store(const AltCw& cw, float* smem, float* slot, int depth, int D,
                             int H) {
  const float* cs = alt_reverse_smem(smem, depth, D, H).cw;
  const int tiles = alt_cw_tiles(D, H);
  for (int l = 0; l < 2 * depth; ++l) {
    const int n_in = layer_in(l, D, H), n_out = layer_out(l, D, H), nk2 = (n_in + 1) / 2;
    const int at = alt_leaf_at(l, D, H);
    for (int t = threadIdx.x; t < tiles; t += kThreads) {
      const int o0 = 2 * (t / nk2), k0 = 2 * (t % nk2);
      const bool reg = l < kAltRegLayers && t < kThreads;
      float w[4];
#pragma unroll
      for (int q = 0; q < kAltRegLayers; ++q)
        if (reg && q == l)
#pragma unroll
          for (int e = 0; e < 4; ++e) w[e] = cw.w[q][e];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = o0 + e / 2, k = k0 + e % 2;
        if (o < n_out && k < n_in) slot[at + o * n_in + k] = reg ? w[e] : cs[at + o * n_in + k];
      }
    }
    for (int o = threadIdx.x; o < n_out; o += kThreads) {
      const bool reg = l < kAltRegLayers && o < kThreads;
      float b = 0.0f;
#pragma unroll
      for (int q = 0; q < kAltRegLayers; ++q)
        if (reg && q == l) b = cw.b[q];
      slot[at + n_out * n_in + o] = reg ? b : cs[at + n_out * n_in + o];
    }
  }
}

__device__ __forceinline__ void alt_cp16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// The block's sum of each thread's v, in a fixed order (a warp butterfly,
// then the warps in order); every thread gets it.
__device__ __forceinline__ double alt_block_sum(double v, double* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// K8's and K4's body for one tile [row0, row0 + rows) of at most
// kAltBwdRows rows: the hand reverse chain of K7 (the algebra of
// ops/fused_generic.py _altmlp_bwd_math; its order of sums on the CPU is
// plain_altmlp_bwd_tiles), seeded with the row cotangents ct_ynew, ct_k7
// (null: zero) and the norm sums' cotangents c_err, c_num, c_den. Writes
// ct_y = pass_y + (the tile's ct_y), ct_k1 = pass_k1 + (its ct_k1) (pass_*:
// null for zero; ct_ynew/ct_k7 may alias the outputs: each element is read
// before its own write, by the same thread), adds the tile's weight and
// bias cotangents to the block's (cw and the shared memory's, see
// alt_cw_stage), and writes the tile's (ct_t, ct_dt) to part_out; ct_t is
// exactly zero (the dynamics ignore t). wsm holds the padded weights, smem
// alt_reverse_floats + 4 floats, rec_g alt_reverse_records floats of device
// memory.
__device__ void altmlp_reverse_tile(const float* y, const float* k1, int row0, int rows,
                                    float dt, const float* wsm, int depth, AltCw& cw,
                                    float* rec_g, const float* ct_ynew, const float* ct_k7,
                                    const float* pass_y, const float* pass_k1, float c_err,
                                    float c_num, float c_den, float* ct_y, float* ct_k1,
                                    float* part_out, int D, int H, float rtol, float atol,
                                    float* smem) {
  constexpr int R = kAltBwdRows;
  const int n = R * D, nl = 2 * depth, pd = alt_pad4(D);
  const int pw = D > H ? pd : alt_pad4(H), RF = alt_record_floats(depth, D, H);
  const size_t g0 = (size_t)row0 * D;
  const AltReverseSmem s = alt_reverse_smem(smem, depth, D, H);

  // Stage i's state y + dt acc_i of element (r, c) and its tanh, h_0 (to
  // the record, and its f64 copy to xa); ystage ends as the stage-6 state
  // (y_new), g6 holds the stage-5 state.
  auto stage_in = [&](int i, int r, int c) {
    const int idx = r * D + c;
    const float v = __fadd_rn(s.y_s[idx], __fmul_rn(dt, stage_acc_rn(i, s.ks, n, idx)));
    s.ystage[idx] = v;
    if (i == 5) s.g6[idx] = v;
    const float h = tanhf(v);
    s.rec(i)[r * pd + c] = h;
    if (i <= 4) __stcg(rec_g + (i - 1) * RF + r * pd + c, h);
    s.xa[r * pw + c] = h;
  };

  __syncthreads();  // the previous tile's last reads
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const bool valid = idx < rows * D;
    s.y_s[idx] = valid ? __ldcg(y + g0 + idx) : 0.0f;
    s.ks[idx] = valid ? __ldcg(k1 + g0 + idx) : 0.0f;
    stage_in(1, idx / D, idx % D);
  }

  // the recompute: ks[i] = f(y + dt acc_i), stage i's record to rec(i)
  // (and stages 1-4 to rec_g); the last layer's phase starts stage i + 1
  for (int i = 1; i <= 6; ++i) {
    float* rec = s.rec(i);
    float* rg = rec_g + (i - 1) * RF;
    const float* W = wsm;
    for (int l = 0; l < nl; ++l) {
      const int n_in = layer_in(l, D, H), n_out = layer_out(l, D, H);
      const float* b = W + n_out * (n_in + 1);
      const double* x = (l & 1) ? s.xb : s.xa;
      double* xo = (l & 1) ? s.xa : s.xb;
      __syncthreads();
      if (l < nl - 1) {
        const int at = alt_record_at(l + 1, D, H), po = alt_pad4(n_out);
        alt_affine_rows(W, b, n_in, n_out, x, pw, [&](int r, int o, float a) {
          const float h = tanhf(a);
          rec[at + r * po + o] = h;
          if (i <= 4) __stcg(rg + at + r * po + o, h);
          xo[r * pw + o] = h;
        });
      } else {
        alt_affine_rows(W, b, n_in, n_out, x, pw, [&](int r, int o, float a) {
          s.ks[i * n + r * D + o] = tanhf(a);
          if (i < 6) stage_in(i + 1, r, o);
        });
      }
      W = b + n_out;
    }
  }
  __syncthreads();

  // the seeds; the last layer's pre-activation cotangent at stage 6,
  // ct_k7 (1 - k7^2), by the thread that seeded each element
  double ct_dt = normed_seeds(s.y_s, s.ks, s.ystage, s.cks, s.g6, s.seed6, s.cty, n, rows * D,
                              g0, ct_ynew, ct_k7, dt, c_err, c_num, c_den, rtol, atol);
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const float h = s.ks[6 * n + idx];
    const int r = idx / D, c = idx - r * D;
    s.gps(6)[r * pd + c] = s.cks[6 * n + idx] * (1.0f - h * h);
  }

  // the reverse over the stages
  for (int i = 6; i >= 1; --i) {
    const float* rec = s.rec(i);
    float* gps = s.gps(i);
    const bool fetch = i >= 2 && i <= 5;  // stage i - 1's record from rec_g
    const float* W = wsm + padded_weight_floats(depth, D, H);
    for (int l = nl - 1; l >= 0; --l) {
      const int n_in = layer_in(l, D, H), n_out = layer_out(l, D, H);
      const int pi = alt_pad4(n_in), po = alt_pad4(n_out);
      W -= n_out * (n_in + 1) + n_out;
      const float* gin = gps + alt_record_at(l + 1 == nl ? 0 : l + 1, D, H);
      const float* h_in = rec + alt_record_at(l, D, H);
      __syncthreads();
      if (fetch && l == nl - 1)
        for (int q = threadIdx.x; q < RF / 4; q += kThreads)
          alt_cp16(s.rec(i - 1) + 4 * q, rec_g + (i - 2) * RF + 4 * q);
      if (l > 0) {
        float* gout = gps + alt_record_at(l, D, H);  // layer l - 1's
        alt_xw_rows(W, n_in, n_out, gin, po, [&](int r, int k, float v) {
          const float h = h_in[r * pi + k];
          gout[r * pi + k] = v * (1.0f - h * h);
        });
      } else {
        // h_0 = tanh(y_i): the stage state's cotangent, the seeds and the
        // lincomb transposes, then stage i - 1's first pre-activation
        // cotangent, element by element
        alt_xw_rows(W, n_in, n_out, gin, po, [&](int r, int k, float v) {
          const int idx = r * D + k;
          const float h0 = h_in[r * pd + k];
          float term = 0.0f;
          stage_reverse(i, idx, v * (1.0f - h0 * h0), idx < rows * D, s.ks, s.cks, s.seed6,
                        s.g6, s.cty, n, dt, term);
          ct_dt += term;
          if (i > 1) {
            const float h = s.ks[(i - 1) * n + idx];
            s.gps(i - 1)[r * pd + k] = s.cks[(i - 1) * n + idx] * (1.0f - h * h);
          }
        });
        alt_cw_stage(cw, s.cw, gps, rec, depth, D, H);
        if (fetch) asm volatile("cp.async.wait_all;\n" ::: "memory");
      }
    }
  }
  __syncthreads();
  normed_tile_cts(s.cty, s.cks, rows * D, g0, pass_y, pass_k1, ct_y, ct_k1);
  const double sum = alt_block_sum(ct_dt, s.red);
  if (threadIdx.x == 0) {
    part_out[0] = 0.0f;
    part_out[1] = (float)sum;
  }
}

// ---------------------------------------------------------------------------
// The forward tile body of K7 and K3 (AltDyn in whole_solve.cu).
//
// A tile is kAltRows = 2 rows of the batch, one block of kThreads: at the
// latent ODE's batch of 256 that is 128 tiles, one wave, and K3's
// cooperative grid holds one tile a block. The block copies the leaves into
// shared memory once (a launch in K7, a solve in K3) with every copy in
// flight at once (alt_fwd_load_weights). Per trial step the body runs the
// six stages, each layer one phase between two block barriers with the
// block's threads at work on the tile's rows, as the reverse body's
// recompute runs them:
//   * a product item is one output and the tile's rows; 2^alt_fwd_split_lg(K)
//     lanes of a warp share each sum of K terms, lane s taking the terms s,
//     s + S, ... (at most kAltFwdChain, their loads issued before their
//     FMAs), and a butterfly of shuffles adds the partials in a fixed order;
//   * each affine map is an f64 sum (from the bias, of the rows' exact f64
//     copies times the f32 weights) rounded once to f32: the plain version's
//     rows (its f64 addmm) except where an f64 sum lies within its own
//     rounding error of an f32 tie. With kAltFwdChain equal to the reverse's
//     kAltChain the sums run in alt_affine_rows' order, so K8's recompute
//     reproduces these stages bitwise;
//   * the last layer's phase also builds stage i + 1's input, element by
//     element: its state y + dt acc_{i+1} (the plain version's order and
//     roundings, __fmul_rn/__fadd_rn), its tanh and that tanh's f64 copy;
//   * at the latent widths (kAltLatentD x kAltLatentH) the widths are
//     compile-time constants: every index, split and trip count of a phase
//     is known to the compiler and a lane's terms are one unrolled run;
//     other widths take the generic instance.
// The norm sums are the parent body's, element for element: one slot of
// (err, num, den) a kAltSlotRows = 2-row sub-tile, element j of the slot
// taken by thread j % kThreads in order of j, a shuffle tree a warp, the
// warps added in order (block_sum_to's order), then the ceil(B / 2) slots
// summed lane-strided by one warp (sum_slots_warp_kernel in K7, sum_tiles
// in K3's fwd_decide). So every accept, NFE and dt of a latent solve is
// what the one-output-a-thread body before it gave.
// ---------------------------------------------------------------------------

constexpr int kAltSlotRows = 2;   // rows of the batch per norm-sum slot
constexpr int kAltSlots = kAltRows / kAltSlotRows;
constexpr int kAltFwdChain = 7;   // most terms of one lane's share of a forward sum
constexpr int kAltLatentD = 20, kAltLatentH = 50;  // widths compiled as constants
static_assert(kAltRows % kAltSlotRows == 0 && kAltRows <= 4, "a product item is all rows");

// log2 of the lanes that share one forward sum of n terms: the fewest (a
// power of two, at most 32) that leave each lane at most kAltFwdChain.
__host__ __device__ constexpr int alt_fwd_split_lg(int n) {
  int lg = 0;
  while (lg < 5 && ((n + (1 << lg) - 1) >> lg) > kAltFwdChain) ++lg;
  return lg;
}

// The forward tile's shared memory: the stage state (y_s, ks 7 of them,
// ystage, g6; R x D each), two f64 row copies (a layer's input, its
// output) at the widest layer's width rounded up to 4, and the slot sums'
// warp partials.
struct AltForwardSmem {
  float *y_s, *ks, *ystage, *g6, *red;
  double *xa, *xb;
};

// Floats of the forward tile (each part a multiple of 4, from a 16-byte
// aligned base); with a base, its parts' addresses to *s.
__host__ __device__ inline int alt_forward_floats(int D, int H, float* base = nullptr,
                                                  AltForwardSmem* s = nullptr) {
  constexpr int R = kAltRows;
  const int n = R * D, pw = R * (D > H ? alt_pad4(D) : alt_pad4(H));
  int off = 0;
  auto take = [&](int floats) {
    float* p = base ? base + off : nullptr;
    off += alt_pad4(floats);
    return p;
  };
  auto take64 = [&](int doubles) { return reinterpret_cast<double*>(take(2 * doubles)); };
  AltForwardSmem t;
  t.y_s = take(n);
  t.ks = take(7 * n);
  t.ystage = take(n);
  t.g6 = take(n);
  t.xa = take64(pw);
  t.xb = take64(pw);
  t.red = take(3 * kAltSlots * kWarps);
  if (s) *s = t;
  return off;
}

// The forward's copy of the leaves in shared memory: the leaves in their
// own layout (nn.Linear's, rows unpadded), each from a 4-float boundary.
// Floats of layer l's weight, of layer l, of all layers, and the offset of
// layer l.
__host__ __device__ inline int alt_fwd_w_floats(int n_in, int n_out) {
  return alt_pad4(n_out * n_in);
}
__host__ __device__ inline int alt_fwd_layer_floats(int l, int D, int H) {
  return alt_fwd_w_floats(layer_in(l, D, H), layer_out(l, D, H)) + alt_pad4(layer_out(l, D, H));
}
__host__ __device__ inline int alt_fwd_weight_floats(int depth, int D, int H) {
  return depth * (alt_fwd_layer_floats(0, D, H) + alt_fwd_layer_floats(1, D, H));
}
__host__ __device__ inline int alt_fwd_layer_at(int l, int D, int H) {
  return (l >> 1) * (alt_fwd_layer_floats(0, D, H) + alt_fwd_layer_floats(1, D, H)) +
         ((l & 1) ? alt_fwd_layer_floats(0, D, H) : 0);
}

// Bytes of shared memory of a block that holds the forward's leaves and
// runs forward tiles (4 floats of slack to align the tile).
size_t altmlp_fwd_smem_bytes(int depth, int D, int H) {
  return sizeof(float) *
         ((size_t)alt_fwd_weight_floats(depth, D, H) + 4 + alt_forward_floats(D, H));
}

// The forward tile's parts in the shared memory after the forward's leaves,
// aligned as alt_reverse_smem aligns the reverse's.
__device__ __forceinline__ AltForwardSmem alt_forward_smem(float* smem, int D, int H) {
  const int pad = (4 - ((int)__cvta_generic_to_shared(smem) >> 2 & 3)) & 3;
  AltForwardSmem s;
  alt_forward_floats(D, H, smem + pad, &s);
  return s;
}

__device__ __forceinline__ void alt_cp4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// n floats, contiguous in device memory at src, to dst: a cp.async of 16
// bytes a thread where both ends are 16-byte aligned, else of 4.
__device__ __forceinline__ void alt_fwd_copy(float* dst, const float* src, int n) {
  const bool wide =
      (((size_t)__cvta_generic_to_shared(dst) | reinterpret_cast<size_t>(src)) & 15) == 0;
  const int n4 = wide ? n & ~3 : 0;
  for (int e = 4 * (int)threadIdx.x; e < n4; e += 4 * kThreads) alt_cp16(dst + e, src + e);
  for (int e = n4 + (int)threadIdx.x; e < n; e += kThreads) alt_cp4(dst + e, src + e);
}

// The leaves into shared memory in the forward's layout, each leaf one
// contiguous copy by cp.async, 16 bytes a thread, all of a thread's copies
// in flight at once (rows padded by a float and copied 4 bytes a lane took
// 1.27x the kernel's time on the H100; load_weights' loop, a load and its
// store at a time, was no faster than that). Returns with this thread's
// copies done; a block barrier makes them visible.
__device__ void alt_fwd_load_weights(const AltLeaves& lv, int depth, int D, int H, float* wsm) {
  for (int l = 0; l < 2 * depth; ++l) {
    const int n_in = layer_in(l, D, H), n_out = layer_out(l, D, H);
    float* dst = wsm + alt_fwd_layer_at(l, D, H);
    alt_fwd_copy(dst, lv.p[2 * l], n_out * n_in);
    alt_fwd_copy(dst + alt_fwd_w_floats(n_in, n_out), lv.p[2 * l + 1], n_out);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// out[r, o] = b[o] + sum_{k < K} x[r, k] W[o, k] for the tile's rows and o <
// N, x the rows' f64 copies (row stride px), W rows of K: each sum in f64
// from the bias, rounded once; lane s of the S =
// 2^alt_fwd_split_lg(K) sharing it takes k = s, s + S, ... in that order and
// hands rows j = s, s + S, ... to epi(r, o, value), one inlined copy of epi
// picking the row at run time. KC, NC > 0: K and N known to the compiler,
// each lane's terms one unrolled run with every load first; else four terms
// a trip, their loads first (alt_affine_rows' loop).
template <int KC, int NC, class Epi>
__device__ __forceinline__ void alt_fwd_rows(const float* W, const float* b, int K_, int N_,
                                             const double* x, int px, Epi epi) {
  constexpr int R = kAltRows;
  const int K = KC > 0 ? KC : K_, N = NC > 0 ? NC : N_;
  const int lg = alt_fwd_split_lg(K), S = 1 << lg, items = N << lg;
  for (int base = 0; base < items; base += kThreads) {  // the same trips in every lane
    const int item = base + threadIdx.x, s = item & (S - 1);
    const bool live = item < items;
    const int o = live ? item >> lg : 0;
    const float* w = W + o * K;
    double acc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) acc[j] = s == 0 ? (double)b[o] : 0.0;
    if constexpr (KC > 0) {
      constexpr int SC = 1 << alt_fwd_split_lg(KC), T = (KC + SC - 1) / SC;
      double wk[T], xv[T][R];
#pragma unroll
      for (int q = 0; q < T; ++q) {
        const int k = s + q * SC;
        const bool in = q < T - 1 || k < KC;  // only a lane's last term may run past K
        wk[q] = in ? (double)w[k] : 0.0;
#pragma unroll
        for (int j = 0; j < R; ++j) xv[q][j] = in ? x[j * px + k] : 0.0;
      }
#pragma unroll
      for (int q = 0; q < T; ++q)
        if (q < T - 1 || s + q * SC < KC)
#pragma unroll
          for (int j = 0; j < R; ++j) acc[j] = fma(xv[q][j], wk[q], acc[j]);
    } else {
      int k = s;
      for (; k + 3 * S < K; k += 4 * S) {
        double wk[4], xv[4][R];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          wk[q] = w[k + q * S];
#pragma unroll
          for (int j = 0; j < R; ++j) xv[q][j] = x[j * px + k + q * S];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < R; ++j) acc[j] = fma(xv[q][j], wk[q], acc[j]);
      }
      for (; k < K; k += S) {
        const double wk = w[k];
#pragma unroll
        for (int j = 0; j < R; ++j) acc[j] = fma(x[j * px + k], wk, acc[j]);
      }
    }
    for (int m = 1; m < S; m <<= 1)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], m);
    if (live)
      for (int j = s; j < R; j += S) {
        double v = acc[0];
#pragma unroll
        for (int q = 1; q < R; ++q)
          if (q == j) v = acc[q];
        epi(j, o, (float)v);
      }
  }
}

// K7's and K3's body for one tile [row0, row0 + rows) of at most kAltRows
// rows at widths DC x HC (0 x 0: D x H at run time): loads the tile's y and
// k1 (zero past the batch end), runs the six stages (ks[i] = f(y + dt *
// acc_i)), then writes the tile's y_new and k7 rows and, for each of its
// slots that holds a row of the batch, the slot's three norm sums (err,
// num, den) to sums_out[3 * slot ..]. wsm holds the forward's leaves
// (alt_fwd_load_weights), smem alt_forward_floats + 4 floats.
template <int DC, int HC>
__device__ __forceinline__ void altmlp_forward_tile_at(const float* y, const float* k1, int row0,
                                                       int rows, float dt, const float* wsm,
                                                       int depth, float* y_new, float* k7,
                                                       float* sums_out, int D_, int H_,
                                                       float rtol, float atol, float* smem) {
  constexpr int R = kAltRows, SR = kAltSlotRows;
  const int D = DC > 0 ? DC : D_, H = HC > 0 ? HC : H_;
  const int n = R * D, pw = D > H ? alt_pad4(D) : alt_pad4(H);
  const size_t g0 = (size_t)row0 * D;
  const AltForwardSmem s = alt_forward_smem(smem, D, H);

  // Stage i's state y + dt acc_i of element (r, c), its tanh's f64 copy to
  // xa (layer 0's input); ystage ends as the stage-6 state (y_new), g6 holds
  // the stage-5 state.
  auto stage_in = [&](int i, int r, int c) {
    const int idx = r * D + c;
    const float v = __fadd_rn(s.y_s[idx], __fmul_rn(dt, stage_acc_rn(i, s.ks, n, idx)));
    s.ystage[idx] = v;
    if (i == 5) s.g6[idx] = v;
    s.xa[r * pw + c] = tanhf(v);
  };

  __syncthreads();  // the weights' copies; the previous tile's last reads
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const bool valid = idx < rows * D;
    s.y_s[idx] = valid ? __ldcg(y + g0 + idx) : 0.0f;
    s.ks[idx] = valid ? __ldcg(k1 + g0 + idx) : 0.0f;
    stage_in(1, idx / D, idx % D);
  }

  // ks[i] = f(y + dt acc_i); the last layer's phase starts stage i + 1
  for (int i = 1; i <= 6; ++i) {
    const float* W = wsm;
    for (int p = 0; p < depth; ++p) {
      const float* bu = W + alt_fwd_w_floats(D, H);
      __syncthreads();
      alt_fwd_rows<DC, HC>(W, bu, D, H, s.xa, pw,
                           [&](int r, int o, float a) { s.xb[r * pw + o] = tanhf(a); });
      W = bu + alt_pad4(H);
      const float* bd = W + alt_fwd_w_floats(H, D);
      const bool last = p == depth - 1;
      __syncthreads();
      alt_fwd_rows<HC, DC>(W, bd, H, D, s.xb, pw, [&](int r, int o, float a) {
        const float h = tanhf(a);
        if (!last) {
          s.xa[r * pw + o] = h;
          return;
        }
        s.ks[i * n + r * D + o] = h;
        if (i < 6) stage_in(i + 1, r, o);
      });
      W = bd + alt_pad4(D);
    }
  }
  __syncthreads();

  // the norm sums (the parent body's loop, a slot at a time) and the rows
  float sums[3 * kAltSlots];
#pragma unroll
  for (int q = 0; q < 3 * kAltSlots; ++q) sums[q] = 0.0f;
#pragma unroll
  for (int sl = 0; sl < kAltSlots; ++sl) {
    const int valid = min(max(rows - sl * SR, 0), SR) * D;
    for (int j = threadIdx.x; j < valid; j += kThreads) {
      const int idx = sl * SR * D + j;
      const float err = __fmul_rn(dt, err_comb_rn(s.ks, n, idx));
      const float yv = s.y_s[idx], yn = s.ystage[idx];
      const float denom = __fadd_rn(atol, __fmul_rn(fmaxf(fabsf(yv), fabsf(yn)), rtol));
      const float sc = __fdiv_rn(err, denom);
      sums[3 * sl] += sc * sc;
      const float dk = s.ks[6 * n + idx] - s.ks[5 * n + idx];
      sums[3 * sl + 1] += dk * dk;
      const float dg = yn - s.g6[idx];
      sums[3 * sl + 2] += dg * dg;
      y_new[g0 + idx] = yn;
      k7[g0 + idx] = s.ks[6 * n + idx];
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 3 * kAltSlots; ++q) {
    const float v = warp_sum(sums[q]);
    if (lane == 0) s.red[q * kWarps + warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < 3 * ((rows + SR - 1) / SR)) {
    const int q = threadIdx.x;
    float v = 0.0f;
    for (int w = 0; w < kWarps; ++w) v += s.red[q * kWarps + w];
    sums_out[q] = v;
  }
}

// The forward tile body at the tile's widths: the latent widths as
// constants, any other at run time.
__device__ void altmlp_forward_tile(const float* y, const float* k1, int row0, int rows, float dt,
                                    const float* wsm, int depth, float* y_new, float* k7,
                                    float* sums_out, int D, int H, float rtol, float atol,
                                    float* smem) {
  if (D == kAltLatentD && H == kAltLatentH)
    altmlp_forward_tile_at<kAltLatentD, kAltLatentH>(y, k1, row0, rows, dt, wsm, depth, y_new,
                                                     k7, sums_out, D, H, rtol, atol, smem);
  else
    altmlp_forward_tile_at<0, 0>(y, k1, row0, rows, dt, wsm, depth, y_new, k7, sums_out, D, H,
                                 rtol, atol, smem);
}

// out[c] = sum over slots s (in order of s) of slots[s * width + c], one
// thread a column: the weight cotangents of K8's blocks (and of K8-CSL's,
// K10's), and of K4's over the whole reverse walk.
__global__ void sum_slots_kernel(const float* __restrict__ slots, int nslots,
                                 int width, float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= width) return;
  float s = 0.0f;
  for (int b = 0; b < nslots; ++b) s += slots[(size_t)b * width + c];
  out[c] = s;
}

// out[c] = the slots' column c summed by one warp in a fixed order (lane
// partials over s = lane, lane + 32, ..., then a butterfly): the step
// kernels' norm sums, in the order of the whole solve's sum_tiles.
__global__ void sum_slots_warp_kernel(const float* __restrict__ slots, int nslots,
                                      int width, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (c >= width) return;
  float s = 0.0f;
  for (int b = lane; b < nslots; b += 32) s += slots[(size_t)b * width + c];
  s = warp_sum(s);
  if (lane == 0) out[c] = s;
}

AltLeaves pack_leaves(const float* const* leaves, int depth) {
  AltLeaves lv{};
  for (int j = 0; j < 4 * depth; ++j) lv.p[j] = leaves[j];
  return lv;
}

}  // namespace
