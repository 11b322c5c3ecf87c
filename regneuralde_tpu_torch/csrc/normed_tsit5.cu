// Normed Tsit5 trial step of MLPDynamics on Hopper: the forward (K1), with
// the small reduction it launches after it. Its per-tile body lives in
// normed_tsit5.cuh, shared with the step kernel of mlp_lanes_tsit5.cu. Its
// hand-written backward (K2) is one trial step of the MLPDynamics reverse
// walk (mlp_step_walk.cuh, built in whole_solve.cu; C entry
// regnde_normed_bwd).
//
// Replaces the TPU kernel
//   K1: regneuralde_tpu/ops/pallas_mlp.py  _normed_pallas_fwd
//       (_make_normed_kernels.fwd_kernel)
//
// What bounds it on this card. One trial step at the flagship shape
// (B=512, D=784, H=100) is 12 contractions of 2*B*D*H = 80 MFLOP each,
// about 1 GFLOP, over 0.6 MB of weights and about 6 MB of row data. Both
// are far below the card's f32 rate and bandwidth, so the bound is
// latency: six dependent stages, each a contraction, a tanh and a lincomb,
// with a block barrier between them.
//
// What the design does about it. The Pallas kernel tiles the batch in 128
// row blocks that run in sequence and carry the norm sums from one grid
// step to the next. Here blocks run in parallel with nothing carried
// between them:
//   * every stage is row-independent, so one block owns a 4-row tile and
//     runs all six stages with the state, the seven stage derivatives and
//     the hidden activations in shared memory; the weights (2 x 314 KB) are
//     read from L2 by every block in the layout nn.Linear holds them ((out,
//     in), time column last), so no copy happens per trial step;
//   * the three norm sums go to a (blocks, 3) buffer that a one-warp
//     kernel reduces in block order.
// Every sum therefore has a fixed order and no floating-point atomics: the
// norm sums decide accept/reject, and a flipped accept changes NFE and the
// whole adjoint. All arithmetic is IEEE f32 on the FMA pipes (no TF32, no
// fast-math): the embedded error estimate is a fifth-order cancellation.
// tanh is 2*sigmoid(2x)-1 with expf, as regneuralde_tpu/ops/math.py has it.
//
// Making this fast (wgmma, TMA) is later work; the contractions here are
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

}  // namespace

extern "C" {

int regnde_fwd_rows() { return kFwdRows; }

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

}  // extern "C"
