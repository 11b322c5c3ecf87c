// Host and device helpers of the persistent cooperative kernels (the whole
// solves K3/K4 in whole_solve.cu and K9/K10 in sde_whole_solve.cu): the
// fixed-order sum of per-tile slots that every block runs after a
// grid.sync(), and the cooperative launch.

#pragma once

#include "normed_tsit5.cuh"

namespace {

// Sums q quantities over the per-tile slots part[tile * nq + q] in tile
// order (lanes strided over tiles, then a shuffle tree); call from warp 0,
// every lane gets the sums.
template <int NQ>
__device__ void sum_tiles(const float* part, int ntiles, float (&out)[NQ]) {
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    float s = 0.0f;
    for (int k = threadIdx.x; k < ntiles; k += 32) s += __ldcg(part + k * NQ + q);
    out[q] = warp_sum(s);
  }
}

// The most blocks of `kernel` (kThreads threads, smem bytes of dynamic
// shared memory) resident on the card at once, the largest grid a
// cooperative launch takes.
cudaError_t cooperative_capacity(const void* kernel, size_t smem, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return e;
  if (!coop) return cudaErrorNotSupported;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

// Launches a cooperative kernel with one block per tile, at most as many
// blocks as fit on the card at once (grid.sync() needs them all resident).
// The grid's size goes to *grid_out where that is given.
cudaError_t launch_cooperative(const void* kernel, void* args, size_t smem,
                               int ntiles, cudaStream_t s, int* grid_out) {
  int capacity = 0;
  cudaError_t e = cooperative_capacity(kernel, smem, &capacity);
  if (e != cudaSuccess) return e;
  const int grid = min(capacity, ntiles);
  if (grid_out) *grid_out = grid;
  void* params[] = {args};
  e = cudaLaunchCooperativeKernel(kernel, grid, kThreads, params, smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace
