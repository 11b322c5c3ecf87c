// The networks of the SDE whole solve's tile bodies (sde_whole_solve.cu,
// K9/K10): an MLP drift and an MLP diffusion (models.MLP: tanh between
// layers, the last layer linear, no time input; the MNIST Neural SDE's 32 ->
// 64 -> 32 drift and 32 -> 32 diffusion), MlpPair; sri_cubic.cuh's
// CubicPair applies the drift's MLP to the cube of the state.
//
// A tile is kSdeRows rows of the batch, run by one block of kThreads. The
// leaves of both networks live in shared memory for the whole solve, each
// weight row at a stride of its width rounded up to 4 plus 4 (so a warp's
// lanes, spread over outputs and terms, meet no bank twice), copied there
// once by cp.async (sde_load_leaves). A layer of either
// network is one product phase over the tile's rows (sde_layer_items,
// sde_item_sum): a product item is one output (or input) and all kSdeRows
// rows, 2^sde_split_lg(K) lanes of a warp share each sum of K terms, lane s
// taking the terms s, s + S, ... (at most kSdeChain, four loads ahead of
// their FMAs), and a butterfly of shuffles adds the partials in a fixed
// order, so every lane ends with the same bits. Every sum is in f64 from
// the rows' exact f64 copies (made once, by the epilogue that writes a
// row) and rounded once to f32: the forward's affine maps are the plain
// version's (ops/sde_whole_solve.py _affine, an f64 addmm) except where an
// f64 sum lies within its own rounding error of an f32 tie; tanh is the
// accurate tanhf. The leaves' cotangents (sde_cw_layer, in shared memory)
// are IEEE f32, each element over the tile's rows in order, each product
// and sum rounded on its own (the file is compiled with -fmad=false), so a
// plain PyTorch schedule (ops/sde_whole_solve.py plain_sde_bwd_tiles)
// reproduces them bitwise.

#pragma once

#include "altmlp_tsit5.cuh"

namespace {

constexpr int kSdeRows = 4;        // rows of the batch per tile
constexpr int kMaxNetLayers = 4;   // layers per network
constexpr int kSdeChain = 8;       // most terms of one lane's share of a sum

// One network: L layers, widths w[0] (= D) -> w[1] -> ... -> w[L] (= D),
// leaves p = (W_0, b_0, W_1, b_1, ...) in nn.Linear layout.
struct MlpNet {
  int L;
  int w[kMaxNetLayers + 1];
  const float* p[2 * kMaxNetLayers];
};

// The stride of a weight row of n inputs in shared memory.
__host__ __device__ constexpr int sde_ld(int n) { return ((n + 3) & ~3) + 4; }

// log2 of the lanes that share one sum of n terms: the fewest (a power of
// two, at most 32) that leave each lane at most kSdeChain terms (past 32
// kSdeChain terms, 32 lanes).
__host__ __device__ constexpr int sde_split_lg(int n) {
  int lg = 0;
  while (lg < 5 && ((n + (1 << lg) - 1) >> lg) > kSdeChain) ++lg;
  return lg;
}

// The pair's widths as the tile bodies read them: FixedWidths<D, H> (drift
// D -> H -> D, diffusion D -> D; each pair's own instance, Pair::Fixed) as
// constants the compiler folds into every index, split and trip count;
// DynWidths at run time. Network k's layers L(k), its layer l's inputs
// in(k, l) and outputs out(k, l).
template <int D, int H>
struct FixedWidths {
  static constexpr bool kFixed = true;
  static constexpr int kD = D, kH = H;
  __host__ __device__ static constexpr int L(int k) { return k ? 1 : 2; }
  __host__ __device__ static constexpr int in(int k, int l) { return k == 0 && l == 1 ? H : D; }
  __host__ __device__ static constexpr int out(int k, int l) { return k == 0 && l == 0 ? H : D; }
};

struct DynWidths {
  static constexpr bool kFixed = false;
  int nl[2];
  int w[2][kMaxNetLayers + 1];
  __host__ __device__ int L(int k) const { return nl[k]; }
  __host__ __device__ int in(int k, int l) const { return w[k][l]; }
  __host__ __device__ int out(int k, int l) const { return w[k][l + 1]; }
};

__host__ inline DynWidths dyn_widths(const MlpNet (&net)[2]) {
  DynWidths d{};
  for (int k = 0; k < 2; ++k) {
    d.nl[k] = net[k].L;
    for (int l = 0; l <= net[k].L; ++l) d.w[k][l] = net[k].w[l];
  }
  return d;
}

// Floats of network k's leaves (unpadded), of layer l's in shared memory
// (padded rows, then the bias from a 4-float boundary), and the offsets of
// layer l's in both layouts.
template <class Wd>
__host__ __device__ int sde_leaf_floats(const Wd& wd, int k) {
  int s = 0;
  for (int l = 0; l < wd.L(k); ++l) s += wd.out(k, l) * wd.in(k, l) + wd.out(k, l);
  return s;
}
__host__ __device__ inline int sde_layer_smem(int n_in, int n_out) {
  return n_out * sde_ld(n_in) + ((n_out + 3) & ~3);
}
template <class Wd>
__host__ __device__ int sde_layer_at(const Wd& wd, int k, int l) {
  int s = 0;
  for (int q = 0; q < k; ++q)
    for (int m = 0; m < wd.L(q); ++m) s += sde_layer_smem(wd.in(q, m), wd.out(q, m));
  for (int m = 0; m < l; ++m) s += sde_layer_smem(wd.in(k, m), wd.out(k, m));
  return s;
}
template <class Wd>
__host__ __device__ int sde_leaf_at(const Wd& wd, int k, int l) {
  int s = k ? sde_leaf_floats(wd, 0) : 0;
  for (int m = 0; m < l; ++m) s += wd.out(k, m) * wd.in(k, m) + wd.out(k, m);
  return s;
}
template <class Wd>
__host__ __device__ int sde_weight_floats(const Wd& wd) {
  return sde_layer_at(wd, 2, 0);
}
// Floats of one stage's hidden activations of network k (the outputs of
// layers 0 .. L - 2) for the tile.
template <class Wd>
__host__ __device__ int sde_hidden_floats(const Wd& wd, int k) {
  int s = 0;
  for (int l = 0; l + 1 < wd.L(k); ++l) s += kSdeRows * ((wd.out(k, l) + 3) & ~3);
  return s;
}
// Row strides of the f64 row buffers: a network's input or output (D
// wide), network k's widest hidden layer (0 without one); widths rounded up
// to 4.
__host__ __device__ constexpr int sde_ld0(int D) { return (D + 3) & ~3; }
template <class Wd>
__host__ __device__ int sde_ldh(const Wd& wd, int k) {
  int m = 0;
  for (int l = 0; l + 1 < wd.L(k); ++l) m = wd.out(k, l) > m ? wd.out(k, l) : m;
  return (m + 3) & ~3;
}

// Both networks' leaves into shared memory (wsm, sde_layer_at's layout):
// the weights by cp.async, 4 bytes a copy (their rows padded; 16-byte
// copies of the rows measured no faster, tools/torch_sde_variants.py), each
// bias one run of copies. Returns with this thread's copies done; a block
// barrier makes them visible.
template <class Wd>
__device__ void sde_load_leaves(const MlpNet (&net)[2], const Wd& wd, float* wsm) {
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int l = 0; l < kMaxNetLayers; ++l) {
      if (l >= wd.L(k)) break;
      const int K = wd.in(k, l), N = wd.out(k, l), ld = sde_ld(K);
      float* dst = wsm + sde_layer_at(wd, k, l);
      const float* W = net[k].p[2 * l];
      for (int e = threadIdx.x; e < N * K; e += kThreads) {
        const int o = e / K, c = e - o * K;
        alt_cp4(dst + o * ld + c, W + e);
      }
      alt_fwd_copy(dst + N * ld, net[k].p[2 * l + 1], N);
    }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The f64 sum of one product item over the tile's rows, acc[r] += sum_k
// x[r, k] w[k] for the terms k = s, s + S, ... < K of lane s (S = 1 << lg;
// at most kSdeChain terms up to K = 32 kSdeChain, more past it), four terms
// a trip with their loads first; then the butterfly over the S
// lanes (every lane ends with the item's sums). x: the rows' f64 copies at
// row stride ldx; w at unit stride (wstride 1) or a column (wstride ld).
__device__ __forceinline__ void sde_item_sum(double (&acc)[kSdeRows], const float* w, int wstride,
                                             const double* x, int ldx, int K, int lg, int s) {
  constexpr int R = kSdeRows;
  const int S = 1 << lg;
#pragma unroll
  for (int q0 = 0; s + q0 * S < K; q0 += 4) {
    double wk[4], xv[4][R];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = s + (q0 + q) * S;
      const bool in = k < K;
      wk[q] = in ? (double)w[k * wstride] : 0.0;
#pragma unroll
      for (int j = 0; j < R; ++j) xv[q][j] = in ? x[j * ldx + k] : 0.0;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (s + (q0 + q) * S < K)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[j] = fma(xv[q][j], wk[q], acc[j]);
  }
  for (int m = 1; m < S; m <<= 1)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], m);
}

// Rows j = s, s + S, ... of an item's sums to epi(j, value rounded to f32):
// one inlined copy of epi, the row picked at run time.
template <class Epi>
__device__ __forceinline__ void sde_item_out(const double (&acc)[kSdeRows], int lg, int s,
                                             Epi epi) {
  for (int j = s; j < kSdeRows; j += 1 << lg) {
    double v = acc[0];
#pragma unroll
    for (int q = 1; q < kSdeRows; ++q)
      if (q == j) v = acc[q];
    epi(j, (float)v);
  }
}

// One layer of a product phase: the weights W (rows at stride ld), bias b,
// K inputs, N outputs, the input rows' f64 copies x (row stride ldx), and
// the items' lanes 1 << lg.
struct SdeLayer {
  const float* W;
  const float* b;
  const double* x;
  int K, N, ld, ldx, lg;
};

__device__ __forceinline__ SdeLayer sde_layer(const float* wsm, int at, int K, int N,
                                              const double* x, int ldx, int terms) {
  return SdeLayer{wsm + at, wsm + at + N * sde_ld(K), x, K, N, sde_ld(K), ldx,
                  sde_split_lg(terms)};
}

// One product item of layer y: lane s of the 1 << y.lg sharing output (or,
// reverse, input) o's sum, item = o << y.lg | s (dead past the layer's
// items: it takes the butterfly's trips, nothing else).
template <bool Fwd, class Epi>
__device__ __forceinline__ void sde_item(const SdeLayer& y, int item, Epi& epi) {
  const int n_items = (Fwd ? y.N : y.K) << y.lg;
  const bool live = item < n_items;
  const int s = item & ((1 << y.lg) - 1);
  const int o = live ? item >> y.lg : 0;
  double acc[kSdeRows];
#pragma unroll
  for (int j = 0; j < kSdeRows; ++j) acc[j] = Fwd && s == 0 ? (double)y.b[o] : 0.0;
  if (Fwd)
    sde_item_sum(acc, y.W + o * y.ld, 1, y.x, y.ldx, y.K, y.lg, s);
  else
    sde_item_sum(acc, y.W + o, y.ld, y.x, y.ldx, y.N, y.lg, s);
  if (live) sde_item_out(acc, y.lg, s, [&](int r, float v) { epi(r, o, v); });
}

// The product items of one layer in a phase: forward out[r, o] = b[o] +
// sum_k x[r, k] W[o, k], reverse out[r, k] = sum_o x[r, o] W[o, k] (x the
// output cotangents); epi(r, o or k, value). The items start at thread
// `first` (a multiple of 32: a second layer's items go after a first's, so
// a stage's drift and diffusion layers run side by side in one phase); a
// warp holding no item skips the trip, the others take it whole (the
// butterfly's lanes).
template <bool Fwd, class Epi>
__device__ __forceinline__ void sde_layer_items(const SdeLayer& y, int first, Epi epi) {
  const int items = (Fwd ? y.N : y.K) << y.lg;
  const int t = ((int)threadIdx.x - first + kThreads) & (kThreads - 1);
  for (int base = 0; base < items; base += kThreads)
    if (((base + t) & ~31) < items) sde_item<Fwd>(y, base + t, epi);
}

// The thread a second layer's items start at, after a first layer's (each
// where it runs).
template <bool Fwd>
__device__ __forceinline__ int sde_items_after(bool run, const SdeLayer& y) {
  return run ? ((((Fwd ? y.N : y.K) << y.lg) + 31) & ~31) & (kThreads - 1) : 0;
}

// Adds the tile's rows' share of one layer's weight and bias cotangents to
// the block's, cw (shared memory, the leaf layout; the layer's elements
// off .. off + N K + N, nn.Linear layout, element e by thread (e - off) %
// kThreads): c += g[r, o] x[r, k] (weights) or c += g[r, o] (biases), rows
// in order, each product and sum rounded on its own. g: the layer's output
// cotangents (row stride ldg), x: its inputs (row stride ldx), cubed first
// where cube (the cubic pair's drift input).
__device__ __forceinline__ void sde_cw_layer(float* cw, int off, int K, int N, const float* g,
                                             int ldg, const float* x, int ldx, bool cube) {
  constexpr int R = kSdeRows;
  for (int j = threadIdx.x; j < N * K + N; j += kThreads) {
    float c = cw[off + j];
    if (j < N * K) {
      const int o = j / K, k = j - o * K;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float xv = x[r * ldx + k];
        if (cube) xv = xv * xv * xv;
        c = c + g[r * ldg + o] * xv;
      }
    } else {
      const int o = j - N * K;
#pragma unroll
      for (int r = 0; r < R; ++r) c = c + g[r * ldg + o];
    }
    cw[off + j] = c;
  }
}

// The MNIST Neural SDE's pair: network 0 is the drift, network 1 the
// diffusion.
struct MlpPair {
  static constexpr bool kCube = false;
  using Fixed = FixedWidths<32, 64>;  // its widths as constants
  MlpNet net[2];
};

}  // namespace
