// Device code of AlternatingMLP's normed Tsit5 trial step, shared by the
// step kernels (altmlp_tsit5.cu, K7/K8) and the whole-solve kernels
// (whole_solve.cu, K3/K4): the stage, the six-stage recompute, and the
// per-tile bodies of one trial step and of its hand reverse.
//
//   f(y) = tanh(... tanh(down_0(tanh(up_0(tanh(y))))) ...), depth x (up, down),
//   up_i: nn.Linear(D, H), down_i: nn.Linear(H, D), no time input.
//
// A tile is kAltRows rows of the batch, run by one block of kThreads. The
// leaves live in shared memory (load_weights), each weight row padded to an
// odd stride so that neither the forward (threads over outputs) nor the
// backward (threads over inputs) has bank conflicts. Arithmetic is IEEE
// (no fast math, no TF32), tanh the accurate tanhf. The forward reproduces
// its plain version (ops/fused_generic.py plain_altmlp_normed_sweep)
// rounding for rounding: each affine map is summed in f64 and rounded once
// to f32 (as the plain version's f64 addmm), and the stage and error
// lincombs round each multiply and add as PyTorch's separate ops do
// (__fmul_rn/__fadd_rn, no contraction into an FMA).
//
// Rows the whole solve writes and later reads again are read with __ldcg,
// through L2 (see normed_tsit5.cuh).

#pragma once

#include "normed_tsit5.cuh"

namespace {

constexpr int kAltRows = 2;      // rows of the batch per tile
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

__device__ __forceinline__ int layer_in(int l, int D, int H) { return (l & 1) ? H : D; }
__device__ __forceinline__ int layer_out(int l, int D, int H) { return (l & 1) ? D : H; }

// Floats of the padded weights in shared memory: per layer W (out x (in+1))
// then b (out).
__host__ __device__ inline int padded_weight_floats(int depth, int D, int H) {
  return depth * (H * (D + 1) + H + D * (H + 1) + D);
}

// Floats of the leaves as given (nn.Linear layout, unpadded).
__host__ __device__ inline int leaf_floats(int depth, int D, int H) {
  return depth * (H * D + H + D * H + D);
}

// Floats of one stage's nine activations for kAltRows rows.
__host__ __device__ inline int act_floats(int depth, int D, int H) {
  return kAltRows * (D + depth * (H + D));
}

// Shared memory of one forward tile, after the padded weights.
__host__ __device__ inline int alt_fwd_tile_floats(int D, int H) {
  const int W = D > H ? D : H;
  return 10 * kAltRows * D + 2 * kAltRows * W + 3 * kWarps;
}

// Shared memory of one backward tile, after the padded weights and the
// weight cotangents (leaf_floats).
__host__ __device__ inline int alt_bwd_tile_floats(int depth, int D, int H) {
  const int W = D > H ? D : H;
  return 20 * kAltRows * D + 6 * act_floats(depth, D, H) + 2 * kAltRows * W +
         2 * kWarps;
}

// Bytes of shared memory of a kernel that holds the padded weights and
// runs forward tiles / backward tiles (with the weight cotangents).
size_t altmlp_fwd_smem_bytes(int depth, int D, int H) {
  return sizeof(float) * ((size_t)padded_weight_floats(depth, D, H) +
                          alt_fwd_tile_floats(D, H));
}

size_t altmlp_bwd_smem_bytes(int depth, int D, int H) {
  return sizeof(float) * ((size_t)padded_weight_floats(depth, D, H) +
                          leaf_floats(depth, D, H) +
                          alt_bwd_tile_floats(depth, D, H));
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

// One AlternatingMLP evaluation for kAltRows rows: k = f(x). x and k are
// (R x D) in shared memory. With acts, the nine activations [h0 = tanh(x),
// h1 (R x H), h2 (R x D), ..., h_2depth = k] are stored there back to
// back; without, two (R x max(D, H)) buffers ping-pong. Ends synchronised.
__device__ void altmlp_stage(const float* x, float* k_out, float* bufa,
                             float* bufb, float* acts, const float* wsm,
                             int depth, int D, int H) {
  constexpr int R = kAltRows;
  float* cur = acts ? acts : bufa;
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) cur[idx] = tanhf(x[idx]);
  __syncthreads();
  int off = 0;
  const int nl = 2 * depth;
  for (int l = 0; l < nl; ++l) {
    const int n_in = layer_in(l, D, H), n_out = layer_out(l, D, H);
    const float* W = wsm + off;
    const float* b = W + n_out * (n_in + 1);
    const bool last = l == nl - 1;
    float* nxt = acts ? cur + R * n_in : (last ? k_out : (cur == bufa ? bufb : bufa));
    for (int idx = threadIdx.x; idx < R * n_out; idx += kThreads) {
      const int r = idx / n_out, o = idx - r * n_out;
      const float* a = cur + r * n_in;
      const float* w = W + o * (n_in + 1);
      double s = (double)b[o];
      for (int k = 0; k < n_in; ++k) s = fma((double)a[k], (double)w[k], s);
      const float h = tanhf((float)s);
      nxt[idx] = h;
      if (last && acts) k_out[idx] = h;
    }
    __syncthreads();
    cur = nxt;
    off += n_out * (n_in + 1) + n_out;
  }
}

// Loads the tile's y and k1 (zero past the batch end) and runs the six
// stages: ks[i] = f(y + dt * acc_i). On return ystage holds y_new (the
// stage-6 state) and g6 the stage-5 state; acts (K8) the activations of
// every stage, stage i at acts + (i - 1) * act_floats.
__device__ void altmlp_recompute(const float* y_g, const float* k1_g, int row0,
                                 int rows, float dt, float* y_s, float* ks,
                                 float* ystage, float* g6, float* bufa,
                                 float* bufb, float* acts, const float* wsm,
                                 int depth, int D, int H) {
  const int n = kAltRows * D;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const bool valid = idx < rows * D;
    y_s[idx] = valid ? __ldcg(y_g + (size_t)row0 * D + idx) : 0.0f;
    ks[idx] = valid ? __ldcg(k1_g + (size_t)row0 * D + idx) : 0.0f;
  }
  const int na = act_floats(depth, D, H);
  for (int i = 1; i <= 6; ++i) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const float v = __fadd_rn(y_s[idx], __fmul_rn(dt, stage_acc_rn(i, ks, n, idx)));
      ystage[idx] = v;
      if (i == 5) g6[idx] = v;
    }
    __syncthreads();
    altmlp_stage(ystage, ks + i * n, bufa, bufb, acts ? acts + (i - 1) * na : nullptr,
                 wsm, depth, D, H);
  }
}

// K7's body for one tile [row0, row0 + rows): writes the tile's y_new and
// k7 rows and its three norm sums (err, num, den) to sums_out. wsm holds
// the padded weights; smem alt_fwd_tile_floats(D, H) floats of scratch.
__device__ void altmlp_fwd_tile(const float* y, const float* k1, int row0,
                                int rows, float dt, const float* wsm, int depth,
                                float* y_new, float* k7, float* sums_out, int D,
                                int H, float rtol, float atol, float* smem) {
  constexpr int R = kAltRows;
  const int n = R * D;
  const int W = D > H ? D : H;
  float* y_s = smem;
  float* ks = y_s + n;          // 7 x n
  float* ystage = ks + 7 * n;
  float* g6 = ystage + n;
  float* bufa = g6 + n;
  float* bufb = bufa + R * W;
  float* red = bufb + R * W;
  altmlp_recompute(y, k1, row0, rows, dt, y_s, ks, ystage, g6, bufa, bufb,
                   nullptr, wsm, depth, D, H);

  float sums[3] = {0.0f, 0.0f, 0.0f};
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const float err = __fmul_rn(dt, err_comb_rn(ks, n, idx));
    const float yv = y_s[idx], yn = ystage[idx];
    const float denom = __fadd_rn(atol, __fmul_rn(fmaxf(fabsf(yv), fabsf(yn)), rtol));
    const float sc = __fdiv_rn(err, denom);
    sums[0] += sc * sc;
    const float dk = ks[6 * n + idx] - ks[5 * n + idx];
    sums[1] += dk * dk;
    const float dg = yn - g6[idx];
    sums[2] += dg * dg;
    y_new[(size_t)row0 * D + idx] = yn;
    k7[(size_t)row0 * D + idx] = ks[6 * n + idx];
  }
  block_sum_to<3>(sums, red, sums_out);
}

// K8's body for one tile: the hand reverse chain of K7, seeded with the
// row cotangents ct_ynew, ct_k7 (null: zero) and the norm sums' cotangents
// c_err, c_num, c_den. Writes
//   ct_y = pass_y + (the tile's ct_y), ct_k1 = pass_k1 + (its ct_k1)
// (pass_*: null for zero; ct_ynew/ct_k7 may alias the outputs: each
// element is read before its own write, by the same thread), adds the
// tile's weight cotangents to cw (leaf_floats, nn.Linear layout, leaves in
// order; shared memory, each element owned by one thread) and writes the
// tile's (ct_t, ct_dt) to part_out. ct_t is exactly zero: the dynamics
// ignore t. wsm holds the padded weights; smem alt_bwd_tile_floats floats.
__device__ void altmlp_bwd_tile(const float* y, const float* k1, int row0,
                                int rows, float dt, const float* wsm, int depth,
                                float* cw, const float* ct_ynew,
                                const float* ct_k7, const float* pass_y,
                                const float* pass_k1, float c_err, float c_num,
                                float c_den, float* ct_y, float* ct_k1,
                                float* part_out, int D, int H, float rtol,
                                float atol, float* smem) {
  constexpr int R = kAltRows;
  const int n = R * D;
  const int W = D > H ? D : H;
  const int nleaf = leaf_floats(depth, D, H);
  const int na = act_floats(depth, D, H);
  float* y_s = smem;
  float* ks = y_s + n;          // 7 x n
  float* cks = ks + 7 * n;      // 7 x n, the stage derivatives' cotangents
  float* ystage = cks + 7 * n;  // y_new after the recompute
  float* g6 = ystage + n;       // stage-5 state, then its seed -d_ynew
  float* seed6 = g6 + n;
  float* cty = seed6 + n;
  float* acts = cty + n;        // 6 x na
  float* gp = acts + 6 * na;    // ct of a layer's pre-activation
  float* gh = gp + R * W;       // ct of a layer's input activation
  float* red = gh + R * W;

  altmlp_recompute(y, k1, row0, rows, dt, y_s, ks, ystage, g6, gp, gh, acts,
                   wsm, depth, D, H);
  __syncthreads();

  float ct_dt = 0.0f;
  // ---- seeds from the outputs' cotangents; rows past the batch end get
  // none, so they add nothing to the weight cotangents ----
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    if (idx >= rows * D) {
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
    const size_t g = (size_t)row0 * D + idx;
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

  // ---- reverse over the stages ----
  const int nl = 2 * depth;
  for (int i = 6; i >= 1; --i) {
    const float* act = acts + (i - 1) * na;
    const float* cur = cks + i * n;  // ct of the stage's output h_nl
    int woff = padded_weight_floats(depth, D, H);
    int coff = nleaf;
    int aoff = na;                   // end of h_nl
    __syncthreads();
    for (int l = nl - 1; l >= 0; --l) {
      const int n_in = layer_in(l, D, H), n_out = layer_out(l, D, H);
      woff -= n_out * (n_in + 1) + n_out;
      coff -= n_out * n_in + n_out;
      const float* h_out = act + aoff - R * n_out;
      const float* h_in = h_out - R * n_in;
      aoff -= R * n_out;
      for (int idx = threadIdx.x; idx < R * n_out; idx += kThreads) {
        const float h = h_out[idx];
        gp[idx] = cur[idx] * (1.0f - h * h);
      }
      __syncthreads();
      // this tile's rows into the layer's cotangents, one owner a value
      float* cW = cw + coff;
      for (int e = threadIdx.x; e < n_out * n_in; e += kThreads) {
        const int o = e / n_in, k = e - o * n_in;
        float s = cW[e];
#pragma unroll
        for (int r = 0; r < R; ++r) s = fmaf(gp[r * n_out + o], h_in[r * n_in + k], s);
        cW[e] = s;
      }
      for (int o = threadIdx.x; o < n_out; o += kThreads) {
        float s = cW[n_out * n_in + o];
#pragma unroll
        for (int r = 0; r < R; ++r) s += gp[r * n_out + o];
        cW[n_out * n_in + o] = s;
      }
      // ct of the layer's input: gp W
      const float* Wl = wsm + woff;
      for (int idx = threadIdx.x; idx < R * n_in; idx += kThreads) {
        const int r = idx / n_in, k = idx - r * n_in;
        const float* gr = gp + r * n_out;
        float s = 0.0f;
        for (int o = 0; o < n_out; ++o) s = fmaf(gr[o], Wl[o * (n_in + 1) + k], s);
        gh[idx] = s;
      }
      __syncthreads();
      cur = gh;
    }
    // h0 = tanh(y_i); then the seeds and the lincomb transposes
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const float h0 = act[idx];
      float ct_yi = cur[idx] * (1.0f - h0 * h0);
      if (i == 6) ct_yi += seed6[idx];
      if (i == 5) ct_yi += g6[idx];
      cty[idx] += ct_yi;
      if (idx < rows * D) ct_dt += ct_yi * stage_acc_rn(i, ks, n, idx);
      for (int j = 0; j < i; ++j) {
        const float c = kA[i - 1][j];
        if (c != 0.0f) cks[j * n + idx] += (dt * c) * ct_yi;
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const size_t g = (size_t)row0 * D + idx;
    ct_y[g] = pass_y ? __ldcg(pass_y + g) + cty[idx] : cty[idx];
    ct_k1[g] = pass_k1 ? __ldcg(pass_k1 + g) + cks[idx] : cks[idx];
  }
  const float part[2] = {0.0f, ct_dt};
  block_sum_to<2>(part, red, part_out);
}

// out[c] = sum over slots s (in order of s) of slots[s * width + c], one
// thread a column: the weight cotangents of K8's blocks,
// and of K4's over the whole reverse walk.
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
