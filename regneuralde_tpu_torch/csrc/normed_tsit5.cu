// Normed Tsit5 trial step of MLPDynamics on Hopper: forward (K1) and its
// hand-written backward (K2), plus the small reduction K1/K2 launch. Their
// per-tile bodies live in normed_tsit5.cuh, shared with whole_solve.cu.
//
// Replaces the TPU kernels
//   K1: regneuralde_tpu/ops/pallas_mlp.py  _normed_pallas_fwd
//       (_make_normed_kernels.fwd_kernel)
//   K2: regneuralde_tpu/ops/pallas_mlp.py  _normed_pallas_bwd
//       (_make_normed_kernels.bwd_kernel, math in _normed_bwd_math)
//
// What bounds it on this card. One trial step at the flagship shape
// (B=512, D=784, H=100) is 12 contractions of 2*B*D*H = 80 MFLOP each,
// about 1 GFLOP forward and 3 GFLOP backward, over 0.6 MB of weights and
// about 13 MB of row data. Both are far below the card's f32 rate and
// bandwidth, so the bound is latency: six dependent stages, each a
// contraction, a tanh and a lincomb, with a block barrier between them.
//
// What the design does about it. The Pallas kernels tile the batch in
// 128 (forward) / 64 (backward) row blocks that run in sequence and carry
// the norm sums and the weight cotangents from one grid step to the next.
// Here blocks run in parallel with nothing carried between them:
//   * every stage is row-independent, so one block owns a small row tile
//     (4 rows forward, 2 backward) and runs all six stages with the state,
//     the seven stage derivatives and the hidden activations in shared
//     memory; the weights (2 x 314 KB) are read from L2 by every block in
//     the layout nn.Linear holds them ((out, in), time column last), so no
//     copy happens per trial step;
//   * cross-block sums (the three norm sums; ct_t, ct_dt) go to a
//     (blocks, q) buffer that a one-warp kernel reduces in block order;
//   * the weight cotangents are batch reductions. The backward stores the
//     per-stage rows they need (ct_pre2, [h, t_i, 1], ct_pre1,
//     [y_i, t_i, 1]) and weight_cotangents.cu's contraction sums the 6*B
//     rows in chunks, and the chunks in a fixed order.
// Every sum therefore has a fixed order and no floating-point atomics: the
// norm sums decide accept/reject, and a flipped accept changes NFE and the
// whole adjoint. All arithmetic is IEEE f32 on the FMA pipes (no TF32, no
// fast-math): the embedded error estimate is a fifth-order cancellation.
// tanh is 2*sigmoid(2x)-1 with expf, as regneuralde_tpu/ops/math.py has it.
//
// Making these fast (wgmma, TMA) is later work; the contractions here are
// plain FMA loops. The persistent whole solve is whole_solve.cu.

#include "normed_tsit5.cuh"

namespace {

// K1: one normed Tsit5 trial step per row tile.
__global__ void __launch_bounds__(kThreads)
normed_fwd_kernel(const float* __restrict__ t_p, const float* __restrict__ dt_p,
                  const float* __restrict__ y, const float* __restrict__ k1,
                  const float* __restrict__ W1, const float* __restrict__ b1,
                  const float* __restrict__ W2, const float* __restrict__ b2,
                  float* __restrict__ y_new, float* __restrict__ k7,
                  float* __restrict__ partials, int B, int D, int H,
                  float rtol, float atol) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * kFwdRows;
  normed_fwd_tile(y, k1, row0, min(kFwdRows, B - row0), *t_p, *dt_p, W1, b1,
                  W2, b2, y_new, k7, partials + 3 * blockIdx.x, D, H, rtol,
                  atol, smem);
}

// out[q] = sum over blocks b (in order of b) of partials[b * nq + q]; one warp.
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       int nblocks, int nq,
                                       float* __restrict__ out) {
  const int lane = threadIdx.x;
  for (int q = 0; q < nq; ++q) {
    float s = 0.0f;
    for (int b = lane; b < nblocks; b += 32) s += partials[b * nq + q];
    s = warp_sum(s);
    if (lane == 0) out[q] = s;
  }
}

// K2: the hand reverse chain of K1 per row tile (normed_bwd_tile).
__global__ void __launch_bounds__(kThreads)
normed_bwd_kernel(const float* __restrict__ t_p, const float* __restrict__ dt_p,
                  const float* __restrict__ y, const float* __restrict__ k1,
                  const float* __restrict__ W1, const float* __restrict__ b1,
                  const float* __restrict__ W2, const float* __restrict__ b2,
                  const float* __restrict__ ct_ynew,
                  const float* __restrict__ ct_k7,
                  const float* __restrict__ ct_scalars,
                  float* __restrict__ ct_y, float* __restrict__ ct_k1,
                  float* __restrict__ partials, float* __restrict__ cp2,
                  float* __restrict__ he, float* __restrict__ cp1,
                  float* __restrict__ ye, int B, int D, int H, float rtol,
                  float atol) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * kBwdRows;
  normed_bwd_tile(y, k1, row0, min(kBwdRows, B - row0), B, *t_p, *dt_p, W1, b1,
                  W2, b2, ct_ynew, ct_k7, nullptr, nullptr, ct_scalars[0],
                  ct_scalars[1], ct_scalars[2], ct_y, ct_k1,
                  partials + 2 * blockIdx.x, cp2, he, cp1, ye, D, H, rtol, atol,
                  smem);
}

}  // namespace

extern "C" {

int regnde_fwd_rows() { return kFwdRows; }
int regnde_bwd_rows() { return kBwdRows; }

// K1. partials: (ceil(B/4), 3) scratch; sums: (3,) err_ssq, num_ssq, den_ssq.
int regnde_normed_fwd(const float* t, const float* dt, const float* y,
                      const float* k1, const float* W1, const float* b1,
                      const float* W2, const float* b2, float* y_new,
                      float* k7, float* partials, float* sums, int B, int D,
                      int H, float rtol, float atol, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = fwd_smem_bytes(D, H);
  cudaError_t e = cudaFuncSetAttribute(
      normed_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nblocks = (B + kFwdRows - 1) / kFwdRows;
  normed_fwd_kernel<<<nblocks, kThreads, smem, s>>>(
      t, dt, y, k1, W1, b1, W2, b2, y_new, k7, partials, B, D, H, rtol, atol);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials_kernel<<<1, 32, 0, s>>>(partials, nblocks, 3, sums);
  return (int)cudaGetLastError();
}

// K2. ct_scalars: (3,) cotangents of the three sums. ct_tdt: (2,) ct_t,
// ct_dt. Weight cotangents in nn.Linear layout: cW1 (H, D+1), cb1 (H),
// cW2 (D, H+1), cb2 (D). Scratch: partials (ceil(B/2), 2), cp2 (6B, D),
// he (6B, H+2), cp1 (6B, H), ye (6B, D+2), and the contraction's wpart
// (wpart_floats floats, chunks of chunk_rows rows; weight_cotangents.cu).
int regnde_normed_bwd(const float* t, const float* dt, const float* y,
                      const float* k1, const float* W1, const float* b1,
                      const float* W2, const float* b2, const float* ct_ynew,
                      const float* ct_k7, const float* ct_scalars, float* ct_y,
                      float* ct_k1, float* cW1, float* cb1, float* cW2,
                      float* cb2, float* ct_tdt, float* partials, float* cp2,
                      float* he, float* cp1, float* ye, float* wpart, int B,
                      int D, int H, int chunk_rows, int wpart_floats,
                      float rtol, float atol, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_smem_bytes(D, H);
  cudaError_t e = cudaFuncSetAttribute(
      normed_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nblocks = (B + kBwdRows - 1) / kBwdRows;
  normed_bwd_kernel<<<nblocks, kThreads, smem, s>>>(
      t, dt, y, k1, W1, b1, W2, b2, ct_ynew, ct_k7, ct_scalars, ct_y, ct_k1,
      partials, cp2, he, cp1, ye, B, D, H, rtol, atol);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials_kernel<<<1, 32, 0, s>>>(partials, nblocks, 2, ct_tdt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_weight_cotangents(cp2, he, cp1, ye, cW1, cb1, cW2, cb2,
                                      wpart, 6 * B, D, H, chunk_rows,
                                      wpart_floats, s);
}

}  // extern "C"
