// Tsit5 trial step of MLPDynamics on Hopper in the solver's tuple protocol:
// forward (K13) writes the rows (y_new, k7, err, k6, g6), and its
// hand-written backward (K14) maps their five cotangents to those of t, dt,
// y, k1 and the weights. The step of odeint's generic engine with
// regneuralde_tpu_torch/ops/fused_mlp.py mlp_dynamics_stage_sweep.
//
// Replaces the TPU kernels
//   K13: regneuralde_tpu/ops/pallas_mlp.py  _pallas_sweep (_fused_step_kernel)
//   K14: regneuralde_tpu/ops/pallas_mlp.py  _pallas_bwd (_fused_bwd_kernel)
//
// What bounds it on this card. At the flagship shape (B=512, D=784, H=100)
// one trial step is 12 contractions of 2*B*D*H = 80 MFLOP, about 1 GFLOP
// forward and 3 GFLOP backward, over 0.6 MB of weights and 7 (forward) or
// 9 (backward) row arrays of 1.6 MB. Far below the card's f32 rate and its
// bandwidth: the bound is latency, six dependent stages of a contraction, a
// tanh and a lincomb, a block barrier between them.
//
// What the design does about it. K1/K2's layout and tile bodies
// (normed_tsit5.cuh, included read-only): one block owns a small row tile
// (4 rows forward, 2 backward) and runs all six stages with the state, the
// seven stage derivatives and the hidden activations in shared memory; the
// weights are read from L2 in nn.Linear's layout. K13 is K1's stage loop
// with the norm sums left out and three more rows written. K14 is K2's
// reverse chain with row seeds in place of the norm seeds: btilde_j * dt *
// ct_err into every stage derivative, ct_k7 and ct_k6 into k7 and k6,
// ct_y_new into stage 6's input and ct_g6 into stage 5's, and
// sum(ct_err * err / dt) into ct_dt. The tile's (ct_t, ct_dt) go to a
// (blocks, 2) buffer that one warp sums in block order; the weight
// cotangents are the stored per-stage rows' contractions, summed in a fixed
// order by weight_cotangents.cu. No floating-point atomics: both kernels are
// bitwise deterministic, which the replay adjoint relies on (it recomputes
// each step's accept flag from K13's rows).
//
// Making these fast (wgmma, TMA) is later work; the contractions here are
// plain FMA loops.

#include "normed_tsit5.cuh"

namespace {

// K13's body for one row tile [row0, row0 + rows). smem: fwd_smem_bytes(D, H).
__device__ void tuple_fwd_tile(const float* y, const float* k1, int row0, int rows, float t,
                               float dt, const float* __restrict__ W1,
                               const float* __restrict__ b1, const float* __restrict__ W2,
                               const float* __restrict__ b2, float* y_new, float* k7,
                               float* err, float* k6, float* g6_out, int D, int H,
                               float* smem) {
  constexpr int R = kFwdRows;
  const int n = R * D;
  float* y_s = smem;
  float* ks = y_s + n;
  float* yi = ks + 7 * n;
  float* g6 = yi + n;
  float* hid = g6 + n;
  recompute_stages<R>(y, k1, row0, rows, t, dt, y_s, ks, yi, g6, hid, nullptr, W1, b1, W2,
                      b2, D, H);
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    // the error row rounds each op as the plain version's (no contraction):
    // it is a cancellation, so an fma here moves it by its own rounding
    const float k0 = ks[idx];
    float s_comb = __fmul_rn(kBt[1], __fsub_rn(ks[n + idx], k0));
    for (int j = 2; j <= 6; ++j)
      s_comb = __fadd_rn(s_comb, __fmul_rn(kBt[j], __fsub_rn(ks[j * n + idx], k0)));
    const size_t g = (size_t)row0 * D + idx;
    y_new[g] = yi[idx];
    k7[g] = ks[6 * n + idx];
    err[g] = __fmul_rn(dt, s_comb);
    k6[g] = ks[5 * n + idx];
    g6_out[g] = g6[idx];
  }
}

// K14's body for one row tile (math of pallas_mlp.py _fused_bwd_kernel),
// seeded with the row cotangents of y_new, k7, err, k6 and g6. Writes the
// tile's ct_y and ct_k1 rows, its (ct_t, ct_dt) to part_out, and the rows of
// the weight-cotangent contractions: cp2 (6B x D), he (6B x (H+2)) =
// [h, t_i, 1], cp1 (6B x H), ye (6B x (D+2)) = [y_i, t_i, 1]; row =
// stage*B + batch row. smem: bwd_smem_bytes(D, H).
__device__ void tuple_bwd_tile(const float* y, const float* k1, int row0, int rows, int B,
                               float t, float dt, const float* __restrict__ W1,
                               const float* __restrict__ b1, const float* __restrict__ W2,
                               const float* __restrict__ b2, const float* ct_ynew,
                               const float* ct_k7, const float* ct_err, const float* ct_k6,
                               const float* ct_g6, float* ct_y, float* ct_k1,
                               float* part_out, float* cp2, float* he, float* cp1, float* ye,
                               int D, int H, float* smem) {
  constexpr int R = kBwdRows;
  const int n = R * D;
  float* y_s = smem;
  float* ks = y_s + n;        // 7 x n
  float* cks = ks + 7 * n;    // 7 x n
  float* yi = cks + 7 * n;
  float* seed5 = yi + n;      // the stage-5 state, then ct_g6
  float* seed6 = seed5 + n;
  float* cty = seed6 + n;
  float* accb = cty + n;
  float* hs = accb + n;       // 6 x R*H
  float* ctp1 = hs + 6 * R * H;
  float* red = ctp1 + R * H;

  recompute_stages<R>(y, k1, row0, rows, t, dt, y_s, ks, yi, seed5, nullptr, hs, W1, b1, W2,
                      b2, D, H);

  float part[2] = {0.0f, 0.0f};  // ct_t, ct_dt
  // ---- seeds from the row cotangents; rows past the batch end get none ----
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const bool valid = idx < rows * D;
    const size_t g = (size_t)row0 * D + idx;
    const float k0 = ks[idx];
    float s_comb = kBt[1] * (ks[n + idx] - k0);
    for (int j = 2; j <= 6; ++j) s_comb += kBt[j] * (ks[j * n + idx] - k0);
    const float ce = valid ? ct_err[g] : 0.0f;
    for (int j = 0; j < 7; ++j) cks[j * n + idx] = kBt[j] * (dt * ce);
    cks[6 * n + idx] += valid ? ct_k7[g] : 0.0f;
    cks[5 * n + idx] += valid ? ct_k6[g] : 0.0f;
    seed6[idx] = valid ? ct_ynew[g] : 0.0f;
    seed5[idx] = valid ? ct_g6[g] : 0.0f;
    cty[idx] = 0.0f;
    if (valid) part[1] += ce * s_comb;
  }

  // ---- reverse over the stages ----
  for (int i = 6; i >= 1; --i) {
    const float ti = t + kC[i] * dt;
    const float* k_i = ks + i * n;
    float* cp2_s = cks + i * n;  // ct_pre2 overwrites ct_ks[i]
    const float* h_i = hs + (i - 1) * R * H;
    const size_t srow = (size_t)(i - 1) * B + row0;
    float ct_ti = 0.0f;
    __syncthreads();
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const float acc = stage_acc(i, ks, n, idx);
      accb[idx] = acc;
      const float kv = k_i[idx];
      const float cp = cp2_s[idx] * (1.0f - kv * kv);
      cp2_s[idx] = cp;
      if (idx < rows * D) {
        const int r = idx / D, d = idx - r * D;
        cp2[(srow + r) * D + d] = cp;
        ye[(srow + r) * (D + 2) + d] = y_s[idx] + dt * acc;
        ct_ti += cp * W2[(size_t)d * (H + 1) + H];
      }
    }
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      ye[(srow + r) * (D + 2) + D] = ti;
      ye[(srow + r) * (D + 2) + D + 1] = 1.0f;
      he[(srow + r) * (H + 2) + H] = ti;
      he[(srow + r) * (H + 2) + H + 1] = 1.0f;
    }
    __syncthreads();
    // ct_h = ct_pre2 W2h; ct_pre1 = ct_h (1 - h^2)
    {
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      for (int h = warp; h < H; h += kWarps) {
        float s[R];
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] = 0.0f;
        for (int d = lane; d < D; d += 32) {
          const float w = W2[(size_t)d * (H + 1) + h];
#pragma unroll
          for (int r = 0; r < R; ++r) s[r] += cp2_s[r * D + d] * w;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] = warp_sum(s[r]);
        if (lane == 0) {
          const float w1t = W1[(size_t)h * (D + 1) + D];
          for (int r = 0; r < R; ++r) {
            const float hv = h_i[r * H + h];
            const float c1 = s[r] * (1.0f - hv * hv);
            ctp1[r * H + h] = c1;
            if (r < rows) {
              cp1[(srow + r) * H + h] = c1;
              he[(srow + r) * (H + 2) + h] = hv;
              ct_ti += c1 * w1t;
            }
          }
        }
      }
    }
    __syncthreads();
    // ct_yi = seed_i + ct_pre1 W1x, then the lincomb transposes
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      float s = 0.0f;
      for (int h = 0; h < H; ++h) s += ctp1[r * H + h] * W1[(size_t)h * (D + 1) + d];
      float ct_yi = s;
      if (i == 6) ct_yi = seed6[idx] + s;
      if (i == 5) ct_yi = seed5[idx] + s;
      cty[idx] += ct_yi;
      if (idx < rows * D) part[1] += ct_yi * accb[idx];
      for (int j = 0; j < i; ++j) {
        const float c = kA[i - 1][j];
        if (c != 0.0f) cks[j * n + idx] += (dt * c) * ct_yi;
      }
    }
    part[0] += ct_ti;
    part[1] += kC[i] * ct_ti;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const size_t g = (size_t)row0 * D + idx;
    ct_y[g] = cty[idx];
    ct_k1[g] = cks[idx];
  }
  block_sum_to<2>(part, red, part_out);
}

// K13: one Tsit5 trial step per row tile.
__global__ void __launch_bounds__(kThreads)
tuple_fwd_kernel(const float* __restrict__ t_p, const float* __restrict__ dt_p,
                 const float* __restrict__ y, const float* __restrict__ k1,
                 const float* __restrict__ W1, const float* __restrict__ b1,
                 const float* __restrict__ W2, const float* __restrict__ b2,
                 float* __restrict__ y_new, float* __restrict__ k7, float* __restrict__ err,
                 float* __restrict__ k6, float* __restrict__ g6, int B, int D, int H) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * kFwdRows;
  tuple_fwd_tile(y, k1, row0, min(kFwdRows, B - row0), *t_p, *dt_p, W1, b1, W2, b2, y_new, k7,
                 err, k6, g6, D, H, smem);
}

// K14: the hand reverse chain of K13 per row tile.
__global__ void __launch_bounds__(kThreads)
tuple_bwd_kernel(const float* __restrict__ t_p, const float* __restrict__ dt_p,
                 const float* __restrict__ y, const float* __restrict__ k1,
                 const float* __restrict__ W1, const float* __restrict__ b1,
                 const float* __restrict__ W2, const float* __restrict__ b2,
                 const float* __restrict__ ct_ynew, const float* __restrict__ ct_k7,
                 const float* __restrict__ ct_err, const float* __restrict__ ct_k6,
                 const float* __restrict__ ct_g6, float* __restrict__ ct_y,
                 float* __restrict__ ct_k1, float* __restrict__ partials,
                 float* __restrict__ cp2, float* __restrict__ he, float* __restrict__ cp1,
                 float* __restrict__ ye, int B, int D, int H) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * kBwdRows;
  tuple_bwd_tile(y, k1, row0, min(kBwdRows, B - row0), B, *t_p, *dt_p, W1, b1, W2, b2,
                 ct_ynew, ct_k7, ct_err, ct_k6, ct_g6, ct_y, ct_k1, partials + 2 * blockIdx.x,
                 cp2, he, cp1, ye, D, H, smem);
}

// out[q] = sum over blocks b (in order of b) of partials[b * nq + q]; one warp.
__global__ void tuple_reduce_kernel(const float* __restrict__ partials, int nblocks, int nq,
                                    float* __restrict__ out) {
  const int lane = threadIdx.x;
  for (int q = 0; q < nq; ++q) {
    float s = 0.0f;
    for (int b = lane; b < nblocks; b += 32) s += partials[b * nq + q];
    s = warp_sum(s);
    if (lane == 0) out[q] = s;
  }
}

}  // namespace

extern "C" {

// K13. t, dt: scalars on the device; the five outputs (B, D).
int regnde_mlp_tsit5_fwd(const float* t, const float* dt, const float* y, const float* k1,
                         const float* W1, const float* b1, const float* W2, const float* b2,
                         float* y_new, float* k7, float* err, float* k6, float* g6, int B,
                         int D, int H, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = fwd_smem_bytes(D, H);
  cudaError_t e = cudaFuncSetAttribute(tuple_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nblocks = (B + kFwdRows - 1) / kFwdRows;
  tuple_fwd_kernel<<<nblocks, kThreads, smem, s>>>(t, dt, y, k1, W1, b1, W2, b2, y_new, k7,
                                                   err, k6, g6, B, D, H);
  return (int)cudaGetLastError();
}

// K14. The five row cotangents (B, D) in; ct_y, ct_k1 (B, D), the weight
// cotangents in nn.Linear layout (cW1 (H, D+1), cb1 (H), cW2 (D, H+1),
// cb2 (D)) and ct_tdt (2,) = (ct_t, ct_dt) out. Scratch: partials
// (ceil(B/2), 2), cp2 (6B, D), he (6B, H+2), cp1 (6B, H), ye (6B, D+2), and
// the contraction's wpart (wpart_floats floats, chunks of chunk_rows rows).
int regnde_mlp_tsit5_bwd(const float* t, const float* dt, const float* y, const float* k1,
                         const float* W1, const float* b1, const float* W2, const float* b2,
                         const float* ct_ynew, const float* ct_k7, const float* ct_err,
                         const float* ct_k6, const float* ct_g6, float* ct_y, float* ct_k1,
                         float* cW1, float* cb1, float* cW2, float* cb2, float* ct_tdt,
                         float* partials, float* cp2, float* he, float* cp1, float* ye,
                         float* wpart, int B, int D, int H, int chunk_rows, int wpart_floats,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_smem_bytes(D, H);
  cudaError_t e = cudaFuncSetAttribute(tuple_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nblocks = (B + kBwdRows - 1) / kBwdRows;
  tuple_bwd_kernel<<<nblocks, kThreads, smem, s>>>(t, dt, y, k1, W1, b1, W2, b2, ct_ynew,
                                                   ct_k7, ct_err, ct_k6, ct_g6, ct_y, ct_k1,
                                                   partials, cp2, he, cp1, ye, B, D, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tuple_reduce_kernel<<<1, 32, 0, s>>>(partials, nblocks, 2, ct_tdt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_weight_cotangents(cp2, he, cp1, ye, cW1, cb1, cW2, cb2, wpart, 6 * B, D, H,
                                      chunk_rows, wpart_floats, s);
}

}  // extern "C"
