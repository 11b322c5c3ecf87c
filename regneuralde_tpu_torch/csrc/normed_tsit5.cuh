// Device code shared by the whole-solve kernels (whole_solve.cu: K3/K4 for
// every dynamics, and the MLPDynamics step kernels K13, K1, K11, K2, K14 and
// K12 built there), the SDE whole solve (sde_whole_solve.cu) and the
// AlternatingMLP and CSL step kernels: the Tsit5 tableau, the accurate tanh,
// the fixed-order block sum, the pinned stage state, and the launcher of the
// fixed-order contraction that sums the weight cotangents
// (weight_cotangents.cu). The MLPDynamics
// whole solve and its step kernels run their stages on tiles of their own
// (mlp_solve.cuh, mlp_walk.cuh, mlp_step_solve.cuh, mlp_step_walk.cuh).
//
// Everything but that contraction's C entry sits in an anonymous
// namespace, so each .cu file that includes it has its own copy and no
// relocatable device code is needed.
//
// Rows that a kernel writes and later reads again (the whole solve's
// history and cotangent carries) are read with __ldcg, through L2, never
// through the non-coherent read-only path.

#pragma once

#include <cuda_runtime.h>

extern "C" int regnde_weight_cotangents(const float* cp2, const float* he,
                                        const float* cp1, const float* ye,
                                        float* cW1, float* cb1, float* cW2,
                                        float* cb2, float* partials, int K,
                                        int D, int H, int chunk_rows,
                                        int partial_floats, void* stream);

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Tsit5 (regneuralde_tpu/ops/tableaus.py). Row i-1 of kA builds stage i.
__constant__ float kA[6][6] = {
    {0.161, 0, 0, 0, 0, 0},
    {-0.008480655492356989, 0.335480655492357, 0, 0, 0, 0},
    {2.8971530571054935, -6.359448489975075, 4.3622954328695815, 0, 0, 0},
    {5.325864828439257, -11.748883564062828, 7.4955393428898365,
     -0.09249506636175525, 0, 0},
    {5.86145544294642, -12.92096931784711, 8.159367898576159,
     -0.071584973281401, -0.028269050394068383, 0},
    {0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
     -3.290069515436081, 2.324710524099774},
};
__constant__ float kC[7] = {0.0, 0.161, 0.327, 0.9, 0.9800255409045097,
                            1.0, 1.0};
__constant__ float kBt[7] = {
    -0.00178001105222577714, -0.0008164344596567469, 0.007880878010261995,
    -0.1447110071732629,     0.5823571654525552,     -0.45808210592918697,
    0.015151515151515152};

__device__ __forceinline__ float accurate_tanh(float x) {
  return 2.0f / (1.0f + expf(-2.0f * x)) - 1.0f;
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sums each thread's vals[0..NQ) over the block in a fixed order and
// writes them to out[0..NQ) (thread 0). red holds NQ * kWarps floats.
template <int NQ>
__device__ void block_sum_to(const float (&vals)[NQ], float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    float v = warp_sum(vals[q]);
    if (lane == 0) red[q * kWarps + warp] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s += red[q * kWarps + w];
      out[q] = s;
    }
  }
}

// Stage i's state y + dt * acc_i with its contraction pinned: acc starts
// as the rounded first product, takes each further term by one fma, and
// the state is fma(dt, acc, y). The whole solve for MLPDynamics builds every
// stage state here (K3's stage pass and K4's replay of it, mlp_solve.cuh,
// and K4's seed phase, mlp_walk.cuh; K13's and K1's stages and K13's g6 row,
// mlp_step_solve.cuh), so the same ks give the same bits on each path: left
// to the compiler, y + dt * acc_i contracted differently in two inlined
// copies, and K4's streamed and replayed cotangents of the stiffness norm
// parted by ulps (H100).
__device__ __forceinline__ float stage_state(int i, const float* y_s,
                                             const float* ks, int stride,
                                             int idx, float dt) {
  float acc = __fmul_rn(kA[i - 1][0], ks[idx]);
  for (int j = 1; j < i; ++j) acc = __fmaf_rn(kA[i - 1][j], ks[j * stride + idx], acc);
  return __fmaf_rn(dt, acc, y_s[idx]);
}

// The weight cotangents in nn.Linear layout from K rows of the stored
// per-stage products: cW2 | cb2 = cp2^T [h, t_i, 1] and
// cW1 | cb1 = cp1^T [y_i, t_i, 1], split over K into chunks of chunk_rows
// rows summed in chunk order (weight_cotangents.cu; partials: its scratch,
// partial_floats floats).
inline cudaError_t launch_weight_cotangents(const float* cp2, const float* he,
                                            const float* cp1, const float* ye,
                                            float* cW1, float* cb1, float* cW2,
                                            float* cb2, float* partials, int K,
                                            int D, int H, int chunk_rows,
                                            int partial_floats, cudaStream_t s) {
  return static_cast<cudaError_t>(regnde_weight_cotangents(
      cp2, he, cp1, ye, cW1, cb1, cW2, cb2, partials, K, D, H, chunk_rows,
      partial_floats, s));
}

}  // namespace
