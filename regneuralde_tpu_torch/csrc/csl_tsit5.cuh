// Device code of FFJORD's augmented CSL dynamics in the normed Tsit5 trial
// step, shared by the step kernels (csl_tsit5.cu, K7/K8-CSL) and the
// whole-solve kernels (whole_solve.cu, K3/K4 with CslDyn): the per-tile
// bodies of one trial step (csl_forward_tile) and of its hand reverse
// (csl_reverse_tile), and the products over a tile's rows they run.
//
//   o_l = (h W_l^T + b_l) * g_l + (t w_b,l + b_b,l),  g_l = sigmoid(t w_g,l)
//   h_1 = softplus(o_1), h_2 = softplus(o_2), mz = o_3      (CSLDynamics)
//   v_3 = e (W_3 * g_3), v_2 = (v_3 s_2) (W_2 * g_2), eJ = (v_2 s_1) (W_1 * g_1)
//   with s_l = sigmoid(o_l); the stage derivative is
//   [mz, -sum(eJ e) (, sum mz^2, sum eJ^2)]                 (FFJORD's state)
//
// The leaves are W_l (nn.Linear layout, out x in), b_l, w_g,l, w_b,l, b_b,l
// for l = 1, 2, 3 (dim -> hidden -> hidden -> dim), then the Hutchinson
// probe e (batch x dim), read by row like y. A tile is kCslBwdRows = 8 rows
// of the batch, forward and reverse, run by one block of kThreads; the
// parameters live in shared memory (csl_load_weights), each weight row
// padded to an odd stride so that neither the products over inputs (threads
// over outputs) nor those over outputs (threads over inputs) have bank
// conflicts. The gates are computed once per stage per block.
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

constexpr int kCslParams = 15;  // 3 layers x (W, b, w_g, w_b, b_b)

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

// ---------------------------------------------------------------------------
// The reverse tile body of K8-CSL and K4-CSL (CslDyn in whole_solve.cu).
//
// A tile is kCslBwdRows = 8 rows, one block of kThreads: at FFJORD's batch
// of 1024 that is 128 tiles, one wave on the card's 132 SMs. Shared memory
// holds the padded parameters and the tile (csl_reverse_floats); what does
// not fit there lives elsewhere:
//   * the six stages' activation records (8 x 686 floats a stage at 43 x
//     100) go to a per-block scratch in device memory during the recompute
//     and come back one stage at a time in reverse (22 KB a stage, in L2);
//   * the weights' cotangents are held in registers, kCslCwTiles tiles of 4
//     outputs x 4 inputs a thread over the three weights (csl_cw_tile), and
//     reach the block's slot in device memory once, at the end of the tile,
//     each element by its owner thread; the vectors' (b, w_g, w_b, b_b) sit
//     in shared memory, one owner thread an output.
// Every product runs over the tile's rows: a thread takes one output (or
// input) and kCslGroup rows, so a weight element loaded once feeds four
// independent chains, and the row vectors are read as float4 (f32) or
// double2 (f64) along the reduction. The recompute keeps the forward's sums
// (each output an f64 chain over the reduction index in order from its
// start value, rounded once; the row vectors are stored as their exact f64
// copies, so a weight is converted once for four rows), so its stages are
// K7-CSL's bitwise. The weight cotangents' update is a register tile of
// (output, input) elements: per row two float4 of the outputs' vectors and
// two of the inputs' feed 32 FMAs, once per stage per tile. Every sum has
// a fixed order: no atomics, bitwise reproducible.
// ---------------------------------------------------------------------------

constexpr int kCslBwdRows = 8;   // rows of the batch per backward tile
constexpr int kCslGroup = 4;     // rows of one product item (a thread's chains)
constexpr int kCslCwTiles = 5;   // 4 x 4 weight-cotangent tiles a thread holds

__host__ __device__ inline int csl_pad4(int n) { return (n + 3) & ~3; }

// 4 x 4 tiles (outputs x inputs) of layer l's weight, and of all three; a
// plan of more than kCslCwTiles * kThreads tiles does not fit the body.
__host__ __device__ inline int csl_cw_layer_tiles(int l, int D, int H) {
  return ((csl_out(l, D, H) + 3) / 4) * ((csl_in(l, D, H) + 3) / 4);
}
__host__ __device__ inline int csl_cw_tiles(int D, int H) {
  return csl_cw_layer_tiles(0, D, H) + csl_cw_layer_tiles(1, D, H) +
         csl_cw_layer_tiles(2, D, H);
}

// Floats of one block's activation records in device memory: six stages of
// kCslBwdRows rows.
__host__ __device__ inline int csl_reverse_records(int D, int H) {
  return 6 * kCslBwdRows * csl_rec_row(D, H);
}

// The reverse tile's shared memory: the stage state (y_s .. cty, row-major
// at A floats a row, as the rows in device memory), the probe (f32 and its
// f64 copy), the gates, the vectors' cotangents (b, w_g, w_b, b_b of the
// 2H + D outputs, in that order), one stage's record (row-major, csl_rec_row
// a row), two f64 product inputs, and the reverse's row vectors at the
// layers' widths rounded up to 4 (row-major: pd = pad4(D), ph = pad4(H)).
struct CslReverseSmem {
  float *y_s, *ks, *cks, *ystage, *g6, *seed6, *cty;
  float *e, *gbuf, *cv, *rec;
  double *e64, *xa, *xb;
  float *zb, *c_o3, *c_ej, *uq3, *c_a3, *ug3, *cz;                  // R x pd
  float *c_v2, *c_o1, *uq1, *ug1, *c_v3, *c_o2, *uq2, *ug2, *hA, *hB, *c_a1,
      *c_a2;                                                        // R x ph
  float* red;
};

// Floats of the reverse tile (each part a multiple of 4, from a 16-byte
// aligned base); with a base, its parts' addresses to *s.
__host__ __device__ inline int csl_reverse_floats(int A, int D, int H, float* base = nullptr,
                                                  CslReverseSmem* s = nullptr) {
  constexpr int R = kCslBwdRows;
  const int n = R * A, pd = R * csl_pad4(D), ph = R * csl_pad4(H);
  const int pw = pd > ph ? pd : ph;
  int off = 0;
  auto take = [&](int floats) {
    float* p = base ? base + off : nullptr;
    off += csl_pad4(floats);
    return p;
  };
  auto take64 = [&](int doubles) { return reinterpret_cast<double*>(take(2 * doubles)); };
  CslReverseSmem t;
  t.y_s = take(n);
  t.ks = take(7 * n);
  t.cks = take(7 * n);
  t.ystage = take(n);
  t.g6 = take(n);
  t.seed6 = take(n);
  t.cty = take(n);
  t.e = take(pd);
  t.e64 = take64(pd);
  t.gbuf = take(2 * H + D);
  t.cv = take(4 * (2 * H + D));
  t.rec = take(R * csl_rec_row(D, H));
  t.xa = take64(pw);
  t.xb = take64(pw);
  float** by_d[] = {&t.zb, &t.c_o3, &t.c_ej, &t.uq3, &t.c_a3, &t.ug3, &t.cz};
  for (float** q : by_d) *q = take(pd);
  float** by_h[] = {&t.c_v2, &t.c_o1, &t.uq1, &t.ug1, &t.c_v3, &t.c_o2,
                    &t.uq2,  &t.ug2,  &t.hA,  &t.hB,  &t.c_a1, &t.c_a2};
  for (float** q : by_h) *q = take(ph);
  t.red = take(2 * kWarps);
  if (s) *s = t;
  return off;
}

// Bytes of shared memory of a block that holds the padded parameters and
// runs reverse tiles (4 floats of slack to align the tile).
size_t csl_bwd_smem_bytes(int A, int D, int H) {
  return sizeof(float) *
         ((size_t)csl_pad_floats(D, H) + 4 + csl_reverse_floats(A, D, H));
}

__device__ __forceinline__ float4 csl_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// out = (x W^T + b) of the tile's rows from their f64 copies x (row stride
// px doubles): output o's sum an f64 chain over k in order from b[o],
// rounded once (csl_affine's, bitwise); epi(r, o, a) takes each.
template <class Epi>
__device__ __forceinline__ void csl_affine_rows(const CslLayer& L, const double* x, int px,
                                                Epi epi) {
  constexpr int G = kCslGroup;
  const int N = L.n_out, K = L.n_in;
  for (int item = threadIdx.x; item < (kCslBwdRows / G) * N; item += kThreads) {
    const int g = item / N, o = item - g * N;
    const double* xr = x + (size_t)g * G * px;
    const float* w = L.W + o * (K + 1);
    double s[G];
#pragma unroll
    for (int j = 0; j < G; ++j) s[j] = (double)L.b[o];
    int k = 0;
    for (; k + 2 <= K; k += 2) {
      const double w0 = w[k], w1 = w[k + 1];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const double2 v = *reinterpret_cast<const double2*>(xr + j * px + k);
        s[j] = fma(v.x, w0, s[j]);
        s[j] = fma(v.y, w1, s[j]);
      }
    }
    if (k < K) {
      const double w0 = w[k];
#pragma unroll
      for (int j = 0; j < G; ++j) s[j] = fma(xr[j * px + k], w0, s[j]);
    }
#pragma unroll
    for (int j = 0; j < G; ++j) epi(g * G + j, o, (float)s[j]);
  }
}

// out[r, k] = sum_{o < n_out} v[r, o] (W[o, k] * g[o]) for k < n_in from
// v's f64 copies (row stride pv doubles): a hop of the e^T J chain with
// csl_hop's sums, bitwise; epi(r, k, value).
template <class Epi>
__device__ __forceinline__ void csl_hop_rows(const CslLayer& L, const double* v, int pv,
                                             const float* g, Epi epi) {
  constexpr int G = kCslGroup;
  const int N = L.n_in, O = L.n_out, stride = L.n_in + 1;
  for (int item = threadIdx.x; item < (kCslBwdRows / G) * N; item += kThreads) {
    const int gi = item / N, k = item - gi * N;
    const double* vr = v + (size_t)gi * G * pv;
    double s[G];
#pragma unroll
    for (int j = 0; j < G; ++j) s[j] = 0.0;
    int o = 0;
    for (; o + 2 <= O; o += 2) {
      const double w0 = __fmul_rn(L.W[o * stride + k], g[o]);
      const double w1 = __fmul_rn(L.W[(o + 1) * stride + k], g[o + 1]);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const double2 x = *reinterpret_cast<const double2*>(vr + j * pv + o);
        s[j] = fma(x.x, w0, s[j]);
        s[j] = fma(x.y, w1, s[j]);
      }
    }
    if (o < O) {
      const double w0 = __fmul_rn(L.W[o * stride + k], g[o]);
#pragma unroll
      for (int j = 0; j < G; ++j) s[j] = fma(vr[j * pv + o], w0, s[j]);
    }
#pragma unroll
    for (int j = 0; j < G; ++j) epi(gi * G + j, k, (float)s[j]);
  }
}

// out[r, o] = sum_{k < n_in} v[r, k] W[o, k] (v row-major, row stride pv
// floats), f32 chains in k order; epi(r, o, value).
template <class Epi>
__device__ __forceinline__ void csl_xwt_rows(const CslLayer& L, const float* v, int pv,
                                             Epi epi) {
  constexpr int G = kCslGroup;
  const int N = L.n_out, K = L.n_in;
  for (int item = threadIdx.x; item < (kCslBwdRows / G) * N; item += kThreads) {
    const int g = item / N, o = item - g * N;
    const float* vr = v + g * G * pv;
    const float* w = L.W + o * (K + 1);
    float s[G];
#pragma unroll
    for (int j = 0; j < G; ++j) s[j] = 0.0f;
    int k = 0;
    for (; k + 4 <= K; k += 4) {
      const float w0 = w[k], w1 = w[k + 1], w2 = w[k + 2], w3 = w[k + 3];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float4 x = csl_ld4(vr + j * pv + k);
        s[j] = fmaf(x.x, w0, s[j]);
        s[j] = fmaf(x.y, w1, s[j]);
        s[j] = fmaf(x.z, w2, s[j]);
        s[j] = fmaf(x.w, w3, s[j]);
      }
    }
    for (; k < K; ++k) {
      const float w0 = w[k];
#pragma unroll
      for (int j = 0; j < G; ++j) s[j] = fmaf(vr[j * pv + k], w0, s[j]);
    }
#pragma unroll
    for (int j = 0; j < G; ++j) epi(g * G + j, o, s[j]);
  }
}

// out[r, k] = sum_{o < n_out} v[r, o] W[o, k] for k < n_in (v row-major,
// row stride pv floats), f32 chains in o order; epi(r, k, value).
template <class Epi>
__device__ __forceinline__ void csl_xw_rows(const CslLayer& L, const float* v, int pv,
                                            Epi epi) {
  constexpr int G = kCslGroup;
  const int N = L.n_in, O = L.n_out, stride = L.n_in + 1;
  for (int item = threadIdx.x; item < (kCslBwdRows / G) * N; item += kThreads) {
    const int g = item / N, k = item - g * N;
    const float* vr = v + g * G * pv;
    float s[G];
#pragma unroll
    for (int j = 0; j < G; ++j) s[j] = 0.0f;
    int o = 0;
    for (; o + 4 <= O; o += 4) {
      const float w0 = L.W[o * stride + k], w1 = L.W[(o + 1) * stride + k];
      const float w2 = L.W[(o + 2) * stride + k], w3 = L.W[(o + 3) * stride + k];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float4 x = csl_ld4(vr + j * pv + o);
        s[j] = fmaf(x.x, w0, s[j]);
        s[j] = fmaf(x.y, w1, s[j]);
        s[j] = fmaf(x.z, w2, s[j]);
        s[j] = fmaf(x.w, w3, s[j]);
      }
    }
    for (; o < O; ++o) {
      const float w0 = L.W[o * stride + k];
#pragma unroll
      for (int j = 0; j < G; ++j) s[j] = fmaf(vr[j * pv + o], w0, s[j]);
    }
#pragma unroll
    for (int j = 0; j < G; ++j) epi(g * G + j, k, s[j]);
  }
}

// The calling thread's q-th weight-cotangent tile: layer l, first output
// o0, first input k0 (tiles numbered layer by layer, outputs-major, and
// dealt to the threads round robin); false past the last tile.
__device__ __forceinline__ bool csl_cw_tile(int q, int D, int H, int& l, int& o0, int& k0) {
  int t = threadIdx.x + q * kThreads;
  for (l = 0; l < 3; ++l) {
    const int nk = (csl_in(l, D, H) + 3) / 4, nt = csl_cw_layer_tiles(l, D, H);
    if (t < nt) {
      const int og = t / nk;
      o0 = 4 * og;
      k0 = 4 * (t - og * nk);
      return true;
    }
    t -= nt;
  }
  return false;
}

// One stage's update of the thread's weight-cotangent tiles: W_l gets
// x^T ct_a and (u g)^T ct_out, row by row, each element's two terms in that
// order.
__device__ __forceinline__ void csl_cw_update(float (&acc)[kCslCwTiles][16],
                                              const CslReverseSmem& s, int D, int H) {
  const int pd = csl_pad4(D), ph = csl_pad4(H);
#pragma unroll
  for (int q = 0; q < kCslCwTiles; ++q) {
    int l, o0, k0;
    if (!csl_cw_tile(q, D, H, l, o0, k0)) break;
    const float* ca = l == 0 ? s.c_a1 : (l == 1 ? s.c_a2 : s.c_a3);
    const float* ug = l == 0 ? s.ug1 : (l == 1 ? s.ug2 : s.ug3);
    const float* x = l == 0 ? s.zb : (l == 1 ? s.hA : s.hB);
    const float* hop = l == 0 ? s.c_ej : (l == 1 ? s.c_v2 : s.c_v3);
    const int po = l == 2 ? pd : ph, pk = l == 0 ? pd : ph;
    for (int r = 0; r < kCslBwdRows; ++r) {
      const float4 a4 = csl_ld4(ca + r * po + o0), u4 = csl_ld4(ug + r * po + o0);
      const float4 x4 = csl_ld4(x + r * pk + k0), h4 = csl_ld4(hop + r * pk + k0);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w}, u[4] = {u4.x, u4.y, u4.z, u4.w};
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w}, hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[q][4 * i + j] = fmaf(a[i], xv[j], acc[q][4 * i + j]);
          acc[q][4 * i + j] = fmaf(u[i], hv[j], acc[q][4 * i + j]);
        }
    }
  }
}

// The tile's parameter cotangents to the block's slot (csl_leaf_floats, the
// leaves' layout): slot = (add ? slot : 0) + the tile's, each element by its
// owner thread (weights: the register tiles; vectors: cv).
__device__ __forceinline__ void csl_cw_store(const float (&acc)[kCslCwTiles][16],
                                             const float* cv, float* slot, bool add, int D,
                                             int H) {
#pragma unroll
  for (int q = 0; q < kCslCwTiles; ++q) {
    int l, o0, k0;
    if (!csl_cw_tile(q, D, H, l, o0, k0)) break;
    const int n_in = csl_in(l, D, H), n_out = csl_out(l, D, H);
    int off = 0;
    for (int j = 0; j < l; ++j) off += csl_leaf_layer(j, D, H);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + i, k = k0 + j;
        if (o < n_out && k < n_in) {
          float* p = slot + off + o * n_in + k;
          __stcg(p, add ? __ldcg(p) + acc[q][4 * i + j] : acc[q][4 * i + j]);
        }
      }
  }
  const int nv = 2 * H + D;
  for (int q = threadIdx.x; q < nv; q += kThreads) {
    const int l = q < H ? 0 : (q < 2 * H ? 1 : 2), o = q - l * H;
    const int n_out = csl_out(l, D, H);
    int off = n_out * csl_in(l, D, H);
    for (int j = 0; j < l; ++j) off += csl_leaf_layer(j, D, H);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* p = slot + off + j * n_out + o;
      __stcg(p, add ? __ldcg(p) + cv[j * nv + q] : cv[j * nv + q]);
    }
  }
}

// One stage of the recompute for the tile's rows at time ti, from the f64
// copy of the stage state's z in s.xa (row stride pad4(D)) and the gates in
// s.gbuf: k (row stride A) as csl_stage writes it, bitwise, and the stage's
// record to rec_g (device memory). Ends synchronised.
__device__ void csl_reverse_stage_fwd(const CslReverseSmem& s, float* k, float ti,
                                      float* rec_g, const float* wsm, int A, int D, int H,
                                      bool kinetic) {
  constexpr int R = kCslBwdRows;
  const int RF = csl_rec_row(D, H), pd = csl_pad4(D), ph = csl_pad4(H);
  const CslLayer L1 = csl_layer(wsm, 0, D, H), L2 = csl_layer(wsm, 1, D, H),
                 L3 = csl_layer(wsm, 2, D, H);
  const float *g1 = s.gbuf, *g2 = s.gbuf + H, *g3 = s.gbuf + 2 * H;
  float* rec = s.rec;
  auto out = [&](const CslLayer& L, const float* g, int o, float a) {
    return __fadd_rn(__fmul_rn(a, g[o]), __fadd_rn(__fmul_rn(ti, L.wb[o]), L.bb[o]));
  };
  // h1 = softplus(o1) into xb, h2 into xa, mz into k
  csl_affine_rows(L1, s.xa, pd, [&](int r, int o, float a) {
    const float ov = out(L1, g1, o, a);
    rec[r * RF + o] = a;
    rec[r * RF + H + o] = ov;
    s.xb[r * ph + o] = csl_softplus(ov);
  });
  __syncthreads();
  csl_affine_rows(L2, s.xb, ph, [&](int r, int o, float a) {
    const float ov = out(L2, g2, o, a);
    rec[r * RF + 2 * H + o] = a;
    rec[r * RF + 3 * H + o] = ov;
    s.xa[r * ph + o] = csl_softplus(ov);
  });
  __syncthreads();
  csl_affine_rows(L3, s.xa, ph, [&](int r, int o, float a) {
    rec[r * RF + 6 * H + o] = a;
    k[r * A + o] = out(L3, g3, o, a);
  });
  // v3 = e (W3 g3) (it reads nothing of layer 3's map); u2 = v3 s2 into xb
  csl_hop_rows(L3, s.e64, pd, g3, [&](int r, int o, float v) {
    rec[r * RF + 4 * H + o] = v;
    s.xb[r * ph + o] = __fmul_rn(v, csl_sigmoid(rec[r * RF + 3 * H + o]));
  });
  __syncthreads();
  // v2 = u2 (W2 g2); u1 = v2 s1 into xa; eJ = u1 (W1 g1)
  csl_hop_rows(L2, s.xb, ph, g2, [&](int r, int o, float v) {
    rec[r * RF + 5 * H + o] = v;
    s.xa[r * ph + o] = __fmul_rn(v, csl_sigmoid(rec[r * RF + H + o]));
  });
  __syncthreads();
  csl_hop_rows(L1, s.xa, ph, g1,
               [&](int r, int o, float v) { rec[r * RF + 6 * H + D + o] = v; });
  __syncthreads();
  // the row sums: -sum(eJ e), and with the kinetic terms sum mz^2, sum eJ^2
  for (int q = threadIdx.x; q < R * (kinetic ? 3 : 1); q += kThreads) {
    const int r = q % R, which = q / R;
    const float* u = which == 1 ? k + r * A : rec + r * RF + 6 * H + D;
    const float* w = which == 0 ? s.e + r * pd : u;
    double sum = 0.0;
    for (int c = 0; c < D; ++c) sum = fma((double)u[c], (double)w[c], sum);
    k[r * A + D + which] = which == 0 ? -(float)sum : (float)sum;
  }
  for (int idx = threadIdx.x; idx < R * RF / 4; idx += kThreads)
    __stcg(reinterpret_cast<float4*>(rec_g) + idx, reinterpret_cast<const float4*>(rec)[idx]);
  __syncthreads();
}

// K8-CSL's and K4-CSL's body for one tile [row0, row0 + rows) of at most
// kCslBwdRows rows: the hand reverse chain of K7-CSL (the algebra of
// ops/fused_csl.py _csl_bwd_math; its order of sums on the CPU is
// plain_csl_bwd_tiles), seeded with the row cotangents ct_ynew, ct_k7
// (null: zero) and the norm sums' cotangents c_err, c_num, c_den. Writes
// ct_y = pass_y + (the tile's ct_y), ct_k1 = pass_k1 + (its ct_k1) (pass_*:
// null for zero; ct_ynew/ct_k7 may alias the outputs: each element is read
// before its own write, by the same thread), the tile's parameter
// cotangents to slot (csl_cw_store, with add), and the tile's (ct_t, ct_dt)
// to part_out. The probe gets no cotangent. wsm holds the padded
// parameters, smem csl_reverse_floats + 4 floats, rec_g
// csl_reverse_records floats of device memory. Per stage, at t_i = t + c_i
// dt: the hops' pullbacks (q_l = ct_out W_l^T, so ct_u_l = g_l q_l; sigmoid'
// = s (1 - s) into ct_o), then the layers' (ct_a = ct_o g), each weight's
// two uses (x^T ct_a and (u g)^T ct_out), and the gates' and time-biases'
// dependence on t_i.
__device__ void csl_reverse_tile(const float* y, const float* k1, const float* e, int row0,
                                 int rows, float t, float dt, const float* wsm, float* rec_g,
                                 float* slot, bool add, const float* ct_ynew,
                                 const float* ct_k7, const float* pass_y,
                                 const float* pass_k1, float c_err, float c_num,
                                 float c_den, float* ct_y, float* ct_k1, float* part_out,
                                 int A, int D, int H, bool kinetic, float rtol, float atol,
                                 float* smem) {
  constexpr int R = kCslBwdRows;
  const int n = R * A, RF = csl_rec_row(D, H), pd = csl_pad4(D), ph = csl_pad4(H);
  const int nv = 2 * H + D;
  const size_t g0 = (size_t)row0 * A;
  float* base = reinterpret_cast<float*>((reinterpret_cast<size_t>(smem) + 15) & ~size_t(15));
  CslReverseSmem s;
  const int nfloats = csl_reverse_floats(A, D, H, base, &s);
  __syncthreads();  // the previous tile's last reads
  for (int idx = threadIdx.x; idx < nfloats; idx += kThreads) base[idx] = 0.0f;
  __syncthreads();
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const bool valid = idx < rows * A;
    s.y_s[idx] = valid ? __ldcg(y + g0 + idx) : 0.0f;
    s.ks[idx] = valid ? __ldcg(k1 + g0 + idx) : 0.0f;
  }
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    const float v = r < rows ? e[(size_t)(row0 + r) * D + c] : 0.0f;
    s.e[r * pd + c] = v;
    s.e64[r * pd + c] = v;
  }
  const CslLayer L1 = csl_layer(wsm, 0, D, H), L2 = csl_layer(wsm, 1, D, H),
                 L3 = csl_layer(wsm, 2, D, H);
  const float *g1 = s.gbuf, *g2 = s.gbuf + H, *g3 = s.gbuf + 2 * H;
  auto gates = [&](float ti) {
    for (int idx = threadIdx.x; idx < nv; idx += kThreads) {
      const int l = idx < H ? 0 : (idx < 2 * H ? 1 : 2);
      s.gbuf[idx] = csl_sigmoid(__fmul_rn(ti, csl_layer(wsm, l, D, H).wg[idx - l * H]));
    }
  };

  // the recompute (csl_recompute's stages): ks[i] = f(t_i, y + dt * acc_i);
  // ystage ends as y_new, g6 holds the stage-5 state
  for (int i = 1; i <= 6; ++i) {
    __syncthreads();
    const float ti = __fadd_rn(t, __fmul_rn(kC[i], dt));
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const float v = __fadd_rn(s.y_s[idx], __fmul_rn(dt, stage_acc_rn(i, s.ks, n, idx)));
      s.ystage[idx] = v;
      if (i == 5) s.g6[idx] = v;
      const int r = idx / A, c = idx - r * A;
      if (c < D) s.xa[r * pd + c] = v;
    }
    gates(ti);
    __syncthreads();
    csl_reverse_stage_fwd(s, s.ks + i * n, ti, rec_g + (i - 1) * R * RF, wsm, A, D, H,
                          kinetic);
  }
  float ct_dt = normed_seeds(s.y_s, s.ks, s.ystage, s.cks, s.g6, s.seed6, s.cty, n,
                             rows * A, g0, ct_ynew, ct_k7, dt, c_err, c_num, c_den, rtol,
                             atol);
  float ct_t = 0.0f;
  float acc[kCslCwTiles][16];
#pragma unroll
  for (int q = 0; q < kCslCwTiles; ++q)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[q][j] = 0.0f;
  const float* rec = s.rec;

  for (int i = 6; i >= 1; --i) {
    const float ti = __fadd_rn(t, __fmul_rn(kC[i], dt));
    const float* cur = s.cks + i * n;  // ct of the stage derivative
    float ct_ti = 0.0f;
    __syncthreads();
    // the stage's record and gates
    const float4* rg = reinterpret_cast<const float4*>(rec_g + (i - 1) * R * RF);
    for (int idx = threadIdx.x; idx < R * RF / 4; idx += kThreads)
      reinterpret_cast<float4*>(s.rec)[idx] = __ldcg(rg + idx);
    gates(ti);
    __syncthreads();
    // the stage's z, recomputed as the forward did; ct_o3, ct_eJ, layer 3's
    // ct_a and (e g3)
    for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
      const int r = idx / D, o = idx - r * D, j = r * pd + o;
      const int si = r * A + o;
      s.zb[j] = __fadd_rn(s.y_s[si], __fmul_rn(dt, stage_acc_rn(i, s.ks, n, si)));
      float co = cur[si];
      float cej = -cur[r * A + D] * s.e[j];
      if (kinetic) {
        co += 2.0f * cur[r * A + D + 1] * s.ks[i * n + si];
        cej += 2.0f * cur[r * A + D + 2] * rec[r * RF + 6 * H + D + o];
      }
      s.c_o3[j] = co;
      s.c_ej[j] = cej;
      s.c_a3[j] = co * g3[o];
      s.ug3[j] = s.e[j] * g3[o];
    }
    __syncthreads();
    // hop 1: eJ = u1 (W1 g1), u1 = v2 s1
    csl_xwt_rows(L1, s.c_ej, pd, [&](int r, int o, float q) {
      const float s1 = csl_sigmoid(rec[r * RF + H + o]), v2 = rec[r * RF + 5 * H + o];
      const float u1 = __fmul_rn(v2, s1), gq = g1[o] * q;
      const int j = r * ph + o;
      s.c_v2[j] = gq * s1;
      s.c_o1[j] = gq * v2 * (s1 * (1.0f - s1));
      s.uq1[j] = u1 * q;
      s.ug1[j] = u1 * g1[o];
    });
    __syncthreads();
    // hop 2: v2 = u2 (W2 g2), u2 = v3 s2
    csl_xwt_rows(L2, s.c_v2, ph, [&](int r, int o, float q) {
      const float s2 = csl_sigmoid(rec[r * RF + 3 * H + o]), v3 = rec[r * RF + 4 * H + o];
      const float u2 = __fmul_rn(v3, s2), gq = g2[o] * q;
      const int j = r * ph + o;
      s.c_v3[j] = gq * s2;
      s.c_o2[j] = gq * v3 * (s2 * (1.0f - s2));
      s.uq2[j] = u2 * q;
      s.ug2[j] = u2 * g2[o];
    });
    __syncthreads();
    // hop 3: v3 = e (W3 g3), the probe takes no cotangent; and ct_h2 = ct_a3
    // W3 into ct_o2 through softplus' = s2, h2 for cW3
    csl_xwt_rows(L3, s.c_v3, ph,
                 [&](int r, int o, float q) { s.uq3[r * pd + o] = s.e[r * pd + o] * q; });
    csl_xw_rows(L3, s.c_a3, pd, [&](int r, int k, float v) {
      const int j = r * ph + k;
      const float o2 = rec[r * RF + 3 * H + k];
      s.c_o2[j] += v * csl_sigmoid(o2);
      s.hB[j] = csl_softplus(o2);
      s.c_a2[j] = s.c_o2[j] * g2[k];
    });
    __syncthreads();
    // ct_h1 = ct_a2 W2 into ct_o1; h1 for cW2
    csl_xw_rows(L2, s.c_a2, ph, [&](int r, int k, float v) {
      const int j = r * ph + k;
      const float o1 = rec[r * RF + H + k];
      s.c_o1[j] += v * csl_sigmoid(o1);
      s.hA[j] = csl_softplus(o1);
      s.c_a1[j] = s.c_o1[j] * g1[k];
    });
    __syncthreads();
    // ct_z = ct_a1 W1; the parameters' cotangents: W's in registers, the
    // vectors' (b, w_g, w_b, b_b: row sums) one owner an output
    csl_xw_rows(L1, s.c_a1, ph, [&](int r, int k, float v) { s.cz[r * pd + k] = v; });
    csl_cw_update(acc, s, D, H);
    for (int q = threadIdx.x; q < nv; q += kThreads) {
      const int l = q < H ? 0 : (q < 2 * H ? 1 : 2), o = q - l * H;
      const CslLayer& L = l == 0 ? L1 : (l == 1 ? L2 : L3);
      const int p = l == 2 ? pd : ph;
      const float* c_o = l == 0 ? s.c_o1 : (l == 1 ? s.c_o2 : s.c_o3);
      const float* c_a = l == 0 ? s.c_a1 : (l == 1 ? s.c_a2 : s.c_a3);
      const float* uq = l == 0 ? s.uq1 : (l == 1 ? s.uq2 : s.uq3);
      const int aoff = l == 0 ? 0 : (l == 1 ? 2 * H : 6 * H);
      float co = 0.0f, ca = 0.0f, cg = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        co += c_o[r * p + o];
        ca += c_a[r * p + o];
        cg += c_o[r * p + o] * rec[r * RF + aoff + o] + uq[r * p + o];
      }
      const float g = s.gbuf[q];
      const float dg = cg * (g * (1.0f - g));
      s.cv[q] += ca;
      s.cv[nv + q] += dg * ti;
      s.cv[2 * nv + q] += co * ti;
      s.cv[3 * nv + q] += co;
      ct_ti += co * L.wb[o] + dg * L.wg[o];
    }
    __syncthreads();
    // the stage state's cotangent (z's; the aux columns feed nothing),
    // the seeds and the lincomb transposes
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const int r = idx / A, c = idx - r * A;
      stage_reverse(i, idx, c < D ? s.cz[r * pd + c] : 0.0f, idx < rows * A, s.ks, s.cks,
                    s.seed6, s.g6, s.cty, n, dt, ct_dt);
    }
    ct_t += ct_ti;
    ct_dt += kC[i] * ct_ti;
  }
  __syncthreads();
  normed_tile_cts(s.cty, s.cks, rows * A, g0, pass_y, pass_k1, ct_y, ct_k1);
  csl_cw_store(acc, s.cv, slot, add, D, H);
  const float part[2] = {ct_t, ct_dt};
  block_sum_to<2>(part, s.red, part_out);
}

// ---------------------------------------------------------------------------
// The forward tile body of K7-CSL and K3-CSL (CslDyn in whole_solve.cu).
//
// A tile is the reverse's kCslBwdRows = 8 rows, one block of kThreads: at
// FFJORD's batch of 1024 that is 128 tiles, one wave on the card's 132 SMs,
// and K3-CSL's cooperative grid holds one tile a block. The block loads the
// parameters into shared memory once (per launch in K7-CSL, per solve in
// K3-CSL; csl_load_params). Each stage's six products run over the tile's
// rows on the FP64 tensor cores (csl_mma_rows): the tile's 8 rows are an
// m16n8k8 instruction's N, the rows are read as their exact f64 copies,
// each weight is converted once a product, and every output is an f64 sum
// from its start value rounded once to f32, as the plain version's f64
// products are; the reverse's recompute (csl_reverse_stage_fwd) sums the
// same products as f64 chains, in another order of the f64 additions.
// The reverse's comments call its stages csl_recompute's and csl_stage's,
// and its products' sums csl_affine's and csl_hop's: the names of the 2-row
// forward body this one replaced, which summed the same chains one row a
// thread. The activations the hops need (o1, o2) and eJ stay in shared
// memory; nothing is recorded in device memory.
//
// The norm sums. FFJORD's error estimate sits at its float32 floor at
// 1.4e-8, and an order of sums moves accepts there, so the tile writes one
// slot of (err, num, den) a kCslSlotRows = 2-row sub-tile, each reduced as
// a block of its own reduces two rows (csl_slot_sums), and the ceil(B / 2)
// slots are summed in order (sum_slots_warp_kernel in K7-CSL, sum_tiles in
// K3-CSL's fwd_decide).
// ---------------------------------------------------------------------------

constexpr int kCslSlotRows = 2;  // rows of the batch per norm-sum slot
constexpr int kCslSlots = kCslBwdRows / kCslSlotRows;

// The forward tile's shared memory: the stage state (y_s, ks, ystage, g6,
// row-major at A floats a row), the probe (f32 and its f64 copy), the
// gates, two f64 product inputs, o1 and o2 (the hops' sigmoids read them),
// eJ (the row sums read it; row-major at pad4 of the layers' widths) and
// the slot sums' warp partials.
struct CslForwardSmem {
  float *y_s, *ks, *ystage, *g6, *e, *gbuf, *o1, *o2, *ej, *red;
  double *e64, *xa, *xb;
};

// Floats of the forward tile (each part a multiple of 4, from a 16-byte
// aligned base); with a base, its parts' addresses to *s.
__host__ __device__ inline int csl_forward_floats(int A, int D, int H, float* base = nullptr,
                                                  CslForwardSmem* s = nullptr) {
  constexpr int R = kCslBwdRows;
  const int n = R * A, pd = R * csl_pad4(D), ph = R * csl_pad4(H);
  const int pw = pd > ph ? pd : ph;
  int off = 0;
  auto take = [&](int floats) {
    float* p = base ? base + off : nullptr;
    off += csl_pad4(floats);
    return p;
  };
  auto take64 = [&](int doubles) { return reinterpret_cast<double*>(take(2 * doubles)); };
  CslForwardSmem t;
  t.y_s = take(n);
  t.ks = take(7 * n);
  t.ystage = take(n);
  t.g6 = take(n);
  t.e = take(pd);
  t.e64 = take64(pd);
  t.gbuf = take(2 * H + D);
  t.xa = take64(pw);
  t.xb = take64(pw);
  t.o1 = take(ph);
  t.o2 = take(ph);
  t.ej = take(pd);
  t.red = take(3 * kCslSlots * kWarps);
  if (s) *s = t;
  return off;
}

// Bytes of shared memory of a block that holds the padded parameters and
// runs forward tiles (4 floats of slack to align the tile).
size_t csl_fwd_smem_bytes(int A, int D, int H) {
  return sizeof(float) *
         ((size_t)csl_pad_floats(D, H) + 4 + csl_forward_floats(A, D, H));
}

// The padded parameters into shared memory in csl_load_weights' layout,
// kCslLoadsInFlight loads a thread issued before their stores: K7-CSL loads
// them once a launch, and one load at a time waits out the memory's latency
// some 80 times a thread.
constexpr int kCslLoadsInFlight = 16;

__device__ void csl_load_params(const CslLeaves& lv, int D, int H, float* wsm) {
  constexpr int U = kCslLoadsInFlight;
  for (int l = 0; l < 3; ++l) {
    const CslLayer L = csl_layer(wsm, l, D, H);
    float* W = const_cast<float*>(L.W);
    float* vec = const_cast<float*>(L.b);
    const int nw = L.n_out * L.n_in, nall = nw + 4 * L.n_out;
    for (int base = threadIdx.x; base < nall; base += U * kThreads) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = base + u * kThreads, j = (idx - nw) / L.n_out;
        v[u] = idx < nw ? lv.p[5 * l][idx]
                        : (idx < nall ? lv.p[5 * l + 1 + j][idx - nw - j * L.n_out] : 0.0f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = base + u * kThreads;
        if (idx < nw)
          W[idx + idx / L.n_in] = v[u];  // row o at o (n_in + 1)
        else if (idx < nall)
          vec[idx - nw] = v[u];
      }
    }
  }
}

// The forward's products on the FP64 tensor cores, transposed: out^T
// (outputs x rows) = w (outputs x I) x^T on mma.sync m16n8k8 f64, so M is
// 16 outputs (one m-tile a warp at a time), N the tile's 8 rows, and each
// instruction takes kCslMmaK of the reduction. A is the f32 weight (for a
// hop the f32 product W * g) converted in a register, B the rows' f64
// copies. The sum starts at the same value and runs over the reduction in
// f64, rounded once to f32; only the order of the f64 additions is the
// instruction's. On the H100 this ran 1.76 times as fast as the reverse's
// f64 chains (csl_affine_rows, csl_hop_rows) and faster than m16n8k4,
// m16n8k16 or m8n8k4 (tools/torch_csl_variants.py builds them).
constexpr int kCslMmaK = 8;

__device__ __forceinline__ void csl_dmma(double (&d)[4], const double* a, const double* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// out[r, j] = c[j] + sum_{i < I} x[r, i] w(j, i) for j < J over the tile's
// rows (x: f64 copies, row stride px; c null: from 0), w(j, i) the f32
// weight; epi(r, j, value). Fragments (lane = 4 g + q): A's element e at
// output row g + 8 (e % 2), reduction column q + 4 (e / 2); B's element e
// at reduction row q + 4 e of the tile's row g; D's d0, d1 at output g,
// rows 2 q, 2 q + 1, and d2, d3 at output g + 8.
template <class Wt, class Epi>
__device__ __forceinline__ void csl_mma_rows(const double* x, int px, int I, int J,
                                             const float* c, Wt w, Epi epi) {
  constexpr int KS = kCslMmaK, NA = KS / 2, NB = KS / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const double* xr = x + (size_t)g * px;
  for (int m0 = 16 * warp; m0 < J; m0 += 16 * kWarps) {
    const int ja = m0 + g, jb = ja + 8;  // this lane's outputs
    double d[4];
    d[0] = d[1] = c && ja < J ? (double)c[ja] : 0.0;
    d[2] = d[3] = c && jb < J ? (double)c[jb] : 0.0;
    for (int i0 = 0; i0 < I; i0 += KS) {
      double a[NA], b[NB];
#pragma unroll
      for (int e = 0; e < NA; ++e) {
        const int j = e % 2 ? jb : ja, i = i0 + q + 4 * (e / 2);
        a[e] = j < J && i < I ? (double)w(j, i) : 0.0;
      }
#pragma unroll
      for (int e = 0; e < NB; ++e) {
        const int i = i0 + q + 4 * e;
        b[e] = i < I ? xr[i] : 0.0;
      }
      csl_dmma(d, a, b);
    }
    if (ja < J) {
      epi(2 * q, ja, (float)d[0]);
      epi(2 * q + 1, ja, (float)d[1]);
    }
    if (jb < J) {
      epi(2 * q, jb, (float)d[2]);
      epi(2 * q + 1, jb, (float)d[3]);
    }
  }
}

// The forward's affine map (x W^T + b) and hop of the e^T J chain (v (W *
// g)) over the tile's rows, on csl_mma_rows.
template <class Epi>
__device__ __forceinline__ void csl_fwd_affine(const CslLayer& L, const double* x, int px,
                                               Epi epi) {
  const int stride = L.n_in + 1;
  csl_mma_rows(x, px, L.n_in, L.n_out, L.b, [&](int o, int k) { return L.W[o * stride + k]; },
               epi);
}
template <class Epi>
__device__ __forceinline__ void csl_fwd_hop(const CslLayer& L, const double* v, int pv,
                                            const float* g, Epi epi) {
  const int stride = L.n_in + 1;
  csl_mma_rows(v, pv, L.n_out, L.n_in, nullptr,
               [&](int k, int o) { return __fmul_rn(L.W[o * stride + k], g[o]); }, epi);
}

// One evaluation of the augmented dynamics for the tile's rows at time ti,
// from the f64 copy of the stage state's z in s.xa (row stride pad4(D)) and
// the gates in s.gbuf: the stage derivative to k (row stride A).
__device__ void csl_forward_stage(const CslForwardSmem& s, float* k, float ti,
                                  const float* wsm, int A, int D, int H, bool kinetic) {
  constexpr int R = kCslBwdRows;
  const int pd = csl_pad4(D), ph = csl_pad4(H);
  const CslLayer L1 = csl_layer(wsm, 0, D, H), L2 = csl_layer(wsm, 1, D, H),
                 L3 = csl_layer(wsm, 2, D, H);
  const float *g1 = s.gbuf, *g2 = s.gbuf + H, *g3 = s.gbuf + 2 * H;
  auto out = [&](const CslLayer& L, const float* g, int o, float a) {
    return __fadd_rn(__fmul_rn(a, g[o]), __fadd_rn(__fmul_rn(ti, L.wb[o]), L.bb[o]));
  };
  // h1 = softplus(o1) into xb, h2 into xa, mz into k
  csl_fwd_affine(L1, s.xa, pd, [&](int r, int o, float a) {
    const float ov = out(L1, g1, o, a);
    s.o1[r * ph + o] = ov;
    s.xb[r * ph + o] = csl_softplus(ov);
  });
  __syncthreads();
  csl_fwd_affine(L2, s.xb, ph, [&](int r, int o, float a) {
    const float ov = out(L2, g2, o, a);
    s.o2[r * ph + o] = ov;
    s.xa[r * ph + o] = csl_softplus(ov);
  });
  __syncthreads();
  csl_fwd_affine(L3, s.xa, ph, [&](int r, int o, float a) { k[r * A + o] = out(L3, g3, o, a); });
  // v3 = e (W3 g3) (it reads nothing of layer 3's map); u2 = v3 s2 into xb
  csl_fwd_hop(L3, s.e64, pd, g3, [&](int r, int o, float v) {
    s.xb[r * ph + o] = __fmul_rn(v, csl_sigmoid(s.o2[r * ph + o]));
  });
  __syncthreads();
  // v2 = u2 (W2 g2); u1 = v2 s1 into xa; eJ = u1 (W1 g1)
  csl_fwd_hop(L2, s.xb, ph, g2, [&](int r, int o, float v) {
    s.xa[r * ph + o] = __fmul_rn(v, csl_sigmoid(s.o1[r * ph + o]));
  });
  __syncthreads();
  csl_fwd_hop(L1, s.xa, ph, g1, [&](int r, int o, float v) { s.ej[r * pd + o] = v; });
  __syncthreads();
  // the row sums: -sum(eJ e), and with the kinetic terms sum mz^2, sum eJ^2
  // (each an f64 chain over the columns in order, four columns' loads ahead)
  for (int q = threadIdx.x; q < (kinetic ? 3 : 1) * R; q += kThreads) {
    const int r = q % R, which = q / R;
    const float* u = which == 1 ? k + r * A : s.ej + r * pd;
    const float* w = which == 0 ? s.e + r * pd : u;
    double sum = 0.0;
    int c = 0;
    for (; c + 4 <= D; c += 4) {
      float uc[4], wc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uc[j] = u[c + j];
        wc[j] = w[c + j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) sum = fma((double)uc[j], (double)wc[j], sum);
    }
    for (; c < D; ++c) sum = fma((double)u[c], (double)w[c], sum);
    k[r * A + D + which] = which == 0 ? -(float)sum : (float)sum;
  }
}

// The end of a forward tile [row0, row0 + rows): its y_new and k7 rows and,
// per 2-row slot that holds a row, the three norm sums (err, num, den) to
// slots_out[3 * slot ..]. Each slot is reduced as a block of its own
// reduces a tile of two rows: element j of the slot (of its 2 A) is taken
// by the thread j % kThreads, which adds its elements' squares in order of
// j, each square rounded; a shuffle tree a warp (warp_sum); the warps added
// in order (block_sum_to's).
__device__ void csl_slot_sums(const CslForwardSmem& s, int A, int rows, size_t g0, float dt,
                              float rtol, float atol, float* y_new, float* k7,
                              float* slots_out) {
  const int n = kCslBwdRows * A, sn = kCslSlotRows * A;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[3 * kCslSlots];
#pragma unroll
  for (int q = 0; q < 3 * kCslSlots; ++q) acc[q] = 0.0f;
  __syncthreads();  // the last stage's row sums
#pragma unroll
  for (int sl = 0; sl < kCslSlots; ++sl) {
    const int valid = min(max(rows - sl * kCslSlotRows, 0), kCslSlotRows) * A;
    for (int j = threadIdx.x; j < valid; j += kThreads) {
      const int idx = sl * sn + j;
      const float err = __fmul_rn(dt, err_comb_rn(s.ks, n, idx));
      const float yv = s.y_s[idx], yn = s.ystage[idx];
      const float denom = __fadd_rn(atol, __fmul_rn(fmaxf(fabsf(yv), fabsf(yn)), rtol));
      const float sc = __fdiv_rn(err, denom);
      const float dk = __fsub_rn(s.ks[6 * n + idx], s.ks[5 * n + idx]);
      const float dg = __fsub_rn(yn, s.g6[idx]);
      acc[3 * sl] = __fadd_rn(acc[3 * sl], __fmul_rn(sc, sc));
      acc[3 * sl + 1] = __fadd_rn(acc[3 * sl + 1], __fmul_rn(dk, dk));
      acc[3 * sl + 2] = __fadd_rn(acc[3 * sl + 2], __fmul_rn(dg, dg));
      y_new[g0 + idx] = yn;
      k7[g0 + idx] = s.ks[6 * n + idx];
    }
  }
#pragma unroll
  for (int q = 0; q < 3 * kCslSlots; ++q) {
    const float v = warp_sum(acc[q]);
    if (lane == 0) s.red[q * kWarps + warp] = v;
  }
  __syncthreads();
  const int q = threadIdx.x;
  if (q < 3 * ((rows + kCslSlotRows - 1) / kCslSlotRows)) {
    float sum = 0.0f;
    for (int w = 0; w < kWarps; ++w) sum += s.red[q * kWarps + w];
    slots_out[q] = sum;
  }
}

// K7-CSL's and K3-CSL's body for one tile [row0, row0 + rows) of at most
// kCslBwdRows rows: loads the tile's y, k1 and probe rows (zero past the
// batch end), runs the six stages at t_i = t + c_i dt (ks[i] = f(t_i, y +
// dt * acc_i)), then writes the tile's y_new and k7 rows and its slots'
// norm sums (csl_slot_sums). wsm holds the padded parameters, smem
// csl_forward_floats + 4 floats.
__device__ void csl_forward_tile(const float* y, const float* k1, const float* e, int row0,
                                 int rows, float t, float dt, const float* wsm, float* y_new,
                                 float* k7, float* slots_out, int A, int D, int H,
                                 bool kinetic, float rtol, float atol, float* smem) {
  constexpr int R = kCslBwdRows, kStages = 6;
  const int n = R * A, pd = csl_pad4(D), nv = 2 * H + D;
  const size_t g0 = (size_t)row0 * A;
  float* base = reinterpret_cast<float*>((reinterpret_cast<size_t>(smem) + 15) & ~size_t(15));
  CslForwardSmem s;
  csl_forward_floats(A, D, H, base, &s);
  __syncthreads();  // the parameters; the previous tile's last reads
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const bool valid = idx < rows * A;
    s.y_s[idx] = valid ? __ldcg(y + g0 + idx) : 0.0f;
    s.ks[idx] = valid ? __ldcg(k1 + g0 + idx) : 0.0f;
  }
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    const float v = r < rows ? e[(size_t)(row0 + r) * D + c] : 0.0f;
    s.e[r * pd + c] = v;
    s.e64[r * pd + c] = v;
  }
  for (int i = 1; i <= kStages; ++i) {
    __syncthreads();
    const float ti = __fadd_rn(t, __fmul_rn(kC[i], dt));
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const float v = __fadd_rn(s.y_s[idx], __fmul_rn(dt, stage_acc_rn(i, s.ks, n, idx)));
      s.ystage[idx] = v;
      if (i == 5) s.g6[idx] = v;
      const int r = idx / A, c = idx - r * A;
      if (c < D) s.xa[r * pd + c] = v;
    }
    for (int idx = threadIdx.x; idx < nv; idx += kThreads) {
      const int l = idx < H ? 0 : (idx < 2 * H ? 1 : 2);
      s.gbuf[idx] = csl_sigmoid(__fmul_rn(ti, csl_layer(wsm, l, D, H).wg[idx - l * H]));
    }
    __syncthreads();
    csl_forward_stage(s, s.ks + i * n, ti, wsm, A, D, H, kinetic);
  }
  csl_slot_sums(s, A, rows, g0, dt, rtol, atol, y_new, k7, slots_out);
}

CslLeaves pack_csl_leaves(const float* const* leaves) {
  CslLeaves lv{};
  for (int j = 0; j <= kCslParams; ++j) lv.p[j] = leaves[j];
  return lv;
}

}  // namespace
