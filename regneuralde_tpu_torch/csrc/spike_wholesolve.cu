// K15 on Hopper: the whole-solve feature probe. A bounded while loop whose
// condition hangs on a scalar carried on the chip, a dynamic scalar store
// per iteration, an asynchronous copy of the state into a history row that
// overlaps the iteration's update, and the hand pullback of a small map.
//
// Replaces the TPU kernel
//   K15: tools/spike_wholesolve.py  run -> kernel
// What it computes, at B x D float32 (JAX's B = 32, D = 20, MAXS = 16):
//   tel[0:MAXS] = 0; i = 0; t = t0; y = y0
//   while i < MAXS and t < 1:
//     tel[i] = t; hy[i] = y                      (the asynchronous copy)
//     y2 = tanh(y + 0.1 t)
//     g  = vjp of u -> tanh(0.5 u) at y2, seeded with 0.01 y2
//     y  = y2 + g; t += 0.25; i += 1
//   y1 = y, n = i
// The vjp rounds as JAX's tanh rule: a = tanh(y2 * 0.5), c = y2 * 0.01,
// g = ((c + c a) (1 - a)) * 0.5; tanh is the accurate tanhf. The file is
// compiled with -fmad=false (ops/_cuda.py), so every multiply and add rounds
// on its own, as the plain version's separate ATen ops do.
//
// What bounds it on this card. At JAX's size the work is 640 elements over
// at most 16 iterations, ~10 KFLOP and ~45 KB: nothing; the bound is the
// launch and the loop's barriers (a few microseconds). At B = 512, D = 784
// the history rows (1.6 MB each) make it bound by bytes.
//
// What the design does about it. The loop condition depends on t and i
// alone, never on y, so the rows split into independent chunks: each block
// holds kChunk elements of y in shared memory and runs the whole loop on
// them (one block at JAX's size). The condition is block-uniform: thread 0
// updates (i, t) in shared memory and every thread reads them after a
// barrier. The history row is a bulk copy shared -> global
// (cp.async.bulk.global.shared::cta, the counterpart of make_async_copy):
// the block copies y into a staging buffer, fences the writes for the async
// proxy, and one thread issues the copy and commits it; the update runs
// while the copy is in flight, and cp.async.bulk.wait_group.read 0 comes
// before the staging buffer is written again (the counterpart of .wait()).
// The copy moves 16-byte multiples between 16-byte-aligned addresses, so
// B * D must be a multiple of 4 (the wrapper checks).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // floats of y per block (16 KB, and as much staging)

__device__ __forceinline__ void bulk_store(float* gdst, const float* ssrc, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(ssrc));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :
               : "l"(gdst), "r"(s), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
    spike_wholesolve_kernel(float t0, const float* __restrict__ y0, float* __restrict__ y1,
                            float* __restrict__ tel, float* __restrict__ hy,
                            int* __restrict__ n_out, int BD, int maxs) {
  __shared__ __align__(128) float ysm[kChunk];
  __shared__ __align__(128) float cpy[kChunk];
  __shared__ int s_i;
  __shared__ float s_t;
  const int base = blockIdx.x * kChunk;
  const int m = min(kChunk, BD - base);
  for (int k = threadIdx.x; k < m; k += kThreads) ysm[k] = y0[base + k];
  if (blockIdx.x == 0)
    for (int q = threadIdx.x; q < maxs; q += kThreads) tel[q] = 0.0f;
  if (threadIdx.x == 0) {
    s_i = 0;
    s_t = t0;
  }
  __syncthreads();

  while (s_i < maxs && s_t < 1.0f) {
    const int i = s_i;
    const float t = s_t;
    for (int k = threadIdx.x; k < m; k += kThreads) cpy[k] = ysm[k];
    // make the staging writes visible to the async proxy, then copy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      if (blockIdx.x == 0) tel[i] = t;
      bulk_store(hy + (size_t)i * BD + base, cpy, m * (int)sizeof(float));
    }
    const float st = 0.1f * t;
    for (int k = threadIdx.x; k < m; k += kThreads) {
      const float y2 = tanhf(ysm[k] + st);
      const float a = tanhf(y2 * 0.5f);
      const float c = y2 * 0.01f;
      const float g = ((c + c * a) * (1.0f - a)) * 0.5f;
      ysm[k] = y2 + g;
    }
    if (threadIdx.x == 0) {
      // the copy has read the staging buffer before it is written again
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      s_i = i + 1;
      s_t = t + 0.25f;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  for (int k = threadIdx.x; k < m; k += kThreads) y1[base + k] = ysm[k];
  if (blockIdx.x == 0 && threadIdx.x == 0) *n_out = s_i;
}

}  // namespace

extern "C" {

// K15. t0: the start time; y0, y1: (B, D) float32 with B * D = BD a multiple
// of 4; tel: (maxs,); hy: (maxs, B, D), rows >= n left unwritten; n_out: (1,)
// int32, the iterations run.
int regnde_spike_wholesolve(float t0, const float* y0, float* y1, float* tel, float* hy,
                            int* n_out, int BD, int maxs, void* stream) {
  if (BD <= 0 || BD % 4 != 0 || maxs < 1) return (int)cudaErrorInvalidValue;
  const int grid = (BD + kChunk - 1) / kChunk;
  spike_wholesolve_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t0, y0, y1, tel, hy, n_out, BD, maxs);
  return (int)cudaGetLastError();
}

}  // extern "C"
