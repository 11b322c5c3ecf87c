// Device code shared by the Tsit5 step kernels of MLPDynamics (K1,
// normed_tsit5.cu; K11, mlp_lanes_tsit5.cu) and the whole-solve kernels
// (whole_solve.cu, K3/K4): the Tsit5 tableau, the MLPDynamics stage, the
// per-tile body of one normed trial step (K1's), the pinned stage state,
// and the launcher of the fixed-order contraction that sums the weight
// cotangents (weight_cotangents.cu). The MLPDynamics whole solve, the tuple
// step K13 and the step backwards K2, K14 and K12 run their stages on tiles
// of their own (mlp_solve.cuh, mlp_walk.cuh, mlp_step_solve.cuh,
// mlp_step_walk.cuh).
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
constexpr int kFwdRows = 4;

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

// acc_i = sum_j a[i-1][j] * k_j over the nonzero coefficients, first term
// first (the order of ops/pallas_mlp.py's stage_acc).
__device__ __forceinline__ float stage_acc(int i, const float* ks, int stride,
                                           int idx) {
  float acc = kA[i - 1][0] * ks[idx];
  for (int j = 1; j < i; ++j) acc += kA[i - 1][j] * ks[j * stride + idx];
  return acc;
}

// Stage i's state y + dt * acc_i with its contraction pinned: acc starts
// as the rounded first product, takes each further term by one fma, and
// the state is fma(dt, acc, y). The whole solve for MLPDynamics builds every
// stage state here (K3's stage pass and K4's replay of it, mlp_solve.cuh,
// and K4's seed phase, mlp_walk.cuh; K13's stages and its g6 row,
// mlp_step_solve.cuh), so the same ks give the same bits on each path: left
// to the compiler, y + dt * acc_i contracted differently in two inlined
// copies, and K4's streamed and replayed cotangents of the stiffness norm
// parted by ulps (H100). K1's 4-row tiles keep the compiler's contraction:
// pinned in a 4-row step backward's recompute, it cost that kernel about
// 35% (H100).
__device__ __forceinline__ float stage_state(int i, const float* y_s,
                                             const float* ks, int stride,
                                             int idx, float dt) {
  float acc = __fmul_rn(kA[i - 1][0], ks[idx]);
  for (int j = 1; j < i; ++j) acc = __fmaf_rn(kA[i - 1][j], ks[j * stride + idx], acc);
  return __fmaf_rn(dt, acc, y_s[idx]);
}

// Stage i's derivative for ROWS rows: hid = tanh(yi W1x^T + ti w1t + b1),
// k = tanh(hid W2h^T + ti w2t + b2). yi (ROWS x D) and hid (ROWS x H) in
// shared memory; W1 is (H, D+1) and W2 is (D, H+1), time column last.
template <int ROWS>
__device__ void mlp_stage(const float* yi, float* hid, float* k_out, float ti,
                          const float* __restrict__ W1,
                          const float* __restrict__ b1,
                          const float* __restrict__ W2,
                          const float* __restrict__ b2, int D, int H) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int h = warp; h < H; h += kWarps) {
    const float* wrow = W1 + (size_t)h * (D + 1);
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float w = wrow[d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] += yi[r * D + d] * w;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = warp_sum(s[r]);
    if (lane == 0) {
      const float tw = ti * wrow[D];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) hid[r * H + h] = accurate_tanh(s[r] + tw + b1[h]);
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float* wrow = W2 + (size_t)d * (H + 1);
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.0f;
    for (int h = 0; h < H; ++h) {
      const float w = wrow[h];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] += hid[r * H + h] * w;
    }
    const float tw = ti * wrow[H];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) k_out[r * D + d] = accurate_tanh(s[r] + tw + b2[d]);
  }
}

// Loads ROWS rows of y and k1 (zero past the batch end) and runs the six
// stages. Shared layout: y | ks[0..6] | yi | g6 (each ROWS*D) | hid.
// On return yi holds y_new (stage 6 state, FSAL) and g6 the stage-5 state.
template <int ROWS>
__device__ void recompute_stages(const float* y_g, const float* k1_g, int row0,
                                 int rows, float t, float dt, float* y_s,
                                 float* ks, float* yi, float* g6, float* hid,
                                 const float* __restrict__ W1,
                                 const float* __restrict__ b1,
                                 const float* __restrict__ W2,
                                 const float* __restrict__ b2, int D, int H) {
  const int n = ROWS * D;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const bool valid = idx < rows * D;
    y_s[idx] = valid ? __ldcg(y_g + (size_t)row0 * D + idx) : 0.0f;
    ks[idx] = valid ? __ldcg(k1_g + (size_t)row0 * D + idx) : 0.0f;
  }
  for (int i = 1; i <= 6; ++i) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const float v = y_s[idx] + dt * stage_acc(i, ks, n, idx);
      yi[idx] = v;
      if (i == 5) g6[idx] = v;
    }
    __syncthreads();
    mlp_stage<ROWS>(yi, hid, ks + i * n, t + kC[i] * dt, W1, b1, W2, b2, D, H);
  }
  __syncthreads();
}

size_t fwd_smem_bytes(int D, int H) {
  return sizeof(float) * ((size_t)10 * kFwdRows * D + (size_t)kFwdRows * H + 3 * kWarps);
}

// K1's body for one row tile [row0, row0 + rows): writes the tile's y_new
// and k7 rows and its three norm sums (err, num, den) to sums_out.
// smem: fwd_smem_bytes(D, H).
__device__ void normed_fwd_tile(const float* y, const float* k1, int row0,
                                int rows, float t, float dt,
                                const float* __restrict__ W1,
                                const float* __restrict__ b1,
                                const float* __restrict__ W2,
                                const float* __restrict__ b2, float* y_new,
                                float* k7, float* sums_out, int D, int H,
                                float rtol, float atol, float* smem) {
  constexpr int R = kFwdRows;
  const int n = R * D;
  float* y_s = smem;
  float* ks = y_s + n;
  float* yi = ks + 7 * n;
  float* g6 = yi + n;
  float* hid = g6 + n;
  float* red = hid + R * H;
  recompute_stages<R>(y, k1, row0, rows, t, dt, y_s, ks, yi, g6, hid, W1, b1, W2, b2, D,
                      H);

  float sums[3] = {0.0f, 0.0f, 0.0f};
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const float k0 = ks[idx];
    float s_comb = kBt[1] * (ks[n + idx] - k0);
    for (int j = 2; j <= 6; ++j) s_comb += kBt[j] * (ks[j * n + idx] - k0);
    const float err = dt * s_comb;
    const float yv = y_s[idx], yn = yi[idx];
    const float denom = atol + fmaxf(fabsf(yv), fabsf(yn)) * rtol;
    const float sc = err / denom;
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
