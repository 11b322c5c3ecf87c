// Lane-wise Tsit5 trial step of MLPDynamics on Hopper: every row of the
// batch at its own (t_i, dt_i). The forward (K11), the step of the
// per-sample batched engine (regneuralde_tpu_torch/ops/per_sample_batched.py).
// Its backward, K12, is one trial step of the whole solve's walk at per-row
// times (mlp_step_walk.cuh, LaneSeed; C entry regnde_lanes_bwd in
// whole_solve.cu).
//
// Replaces the TPU kernel
//   K11: regneuralde_tpu/ops/pallas_mlp.py  _pallas_sweep_lanes
//        (_fused_step_kernel_lanes)
//
// What bounds it on this card. At the flagship shape (B=512, D=784, H=100)
// one trial step is 12 contractions of 2*B*D*H = 80 MFLOP, about 1 GFLOP,
// over 0.6 MB of weights and 5 row arrays of 1.6 MB. Far below the card's
// f32 rate and its bandwidth: the bound is latency, six dependent stages of
// a contraction, a tanh and a lincomb, a block barrier between them.
//
// What the design does about it. The 4-row layout K1 and K13 had before
// they became end policies of K3's grid-split stages (mlp_step_solve.cuh):
// one block owns a 4-row tile and runs all six stages with the state, the
// seven stage derivatives and the hidden activations in shared memory
// (sized from both D and H); the weights are read from L2 in nn.Linear's
// layout, by every tile in every stage. The Pallas kernel's per-lane (t,
// dt) columns are per-row values in shared memory. Rounding: the forward
// reproduces its plain version (ops/fused_mlp_lanes.py
// _reference_sweep_lanes) bitwise, because each of the 512 lanes decides
// accept or reject on its own error norm at the tolerance's float32 floor:
//   * each affine map x W^T + t_i w_t + b is summed in f64 (explicit fma)
//     and rounded once to f32, as the plain version's f64 addmm;
//   * the stage lincombs y + dt_i * sum_j a_ij k_j, the stage times
//     t_i + c_i dt_i and the error combination round every multiply and add
//     on its own (__fmul_rn/__fadd_rn, no contraction), in PyTorch's order;
//   * tanh is 2 / (1 + expf(-2x)) - 1 op by op, as ops/math.py's
//     2 * sigmoid(2x) - 1 on ATen's sigmoid.
// The per-sample engine takes its accept flags from this forward, so its
// backward (K12) rounds as K3's stages do and moves gradients only.
// No floating-point atomics.
//
// Making it fast (the whole solve's grid-split stages, with the rounding
// checked) is later work; the contractions here are plain FMA loops.

#include "normed_tsit5.cuh"

namespace {

constexpr int kLanesFwdRows = 4;

__device__ __forceinline__ double warp_sum_d(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ops/math.py tanh: 2 * sigmoid(2x) - 1, each op rounded as ATen's.
__device__ __forceinline__ float lanes_tanh(float x) {
  const float e = expf(__fmul_rn(-2.0f, x));
  return __fsub_rn(__fdiv_rn(2.0f, __fadd_rn(1.0f, e)), 1.0f);
}

// acc_i = sum_j a[i-1][j] * k_j, first term first, each op rounded.
__device__ __forceinline__ float lanes_acc(int i, const float* ks, int stride, int idx) {
  float acc = __fmul_rn(kA[i - 1][0], ks[idx]);
  for (int j = 1; j < i; ++j) acc = __fadd_rn(acc, __fmul_rn(kA[i - 1][j], ks[j * stride + idx]));
  return acc;
}

// sum_{j>=1} bt_j (k_j - k_0) in the plain version's order and roundings.
__device__ __forceinline__ float lanes_err_comb(const float* ks, int n, int idx) {
  const float k0 = ks[idx];
  float s = __fmul_rn(kBt[1], __fsub_rn(ks[n + idx], k0));
  for (int j = 2; j <= 6; ++j) s = __fadd_rn(s, __fmul_rn(kBt[j], __fsub_rn(ks[j * n + idx], k0)));
  return s;
}

// Stage time of row r: t_r + c_i dt_r, rounded as the plain version.
__device__ __forceinline__ float stage_time(int i, const float* tc, const float* dtc, int r) {
  return __fadd_rn(tc[r], __fmul_rn(kC[i], dtc[r]));
}

// One MLPDynamics evaluation for ROWS rows, each at its own stage time ti[r]:
// hid = tanh(yi W1x^T + ti w1t + b1), k = tanh(hid W2h^T + ti w2t + b2), the
// affine maps summed in f64 and rounded once. yi (ROWS x D) and hid
// (ROWS x H) in shared memory. Ends synchronised.
template <int ROWS>
__device__ void lanes_stage(const float* yi, float* hid, float* k_out, const float* ti,
                            const float* __restrict__ W1, const float* __restrict__ b1,
                            const float* __restrict__ W2, const float* __restrict__ b2,
                            int D, int H) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int h = warp; h < H; h += kWarps) {
    const float* wrow = W1 + (size_t)h * (D + 1);
    double s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.0;
    for (int d = lane; d < D; d += 32) {
      const double w = (double)wrow[d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = fma((double)yi[r * D + d], w, s[r]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = warp_sum_d(s[r]);
    if (lane == 0) {
      const double wt = (double)wrow[D], bb = (double)b1[h];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        hid[r * H + h] = lanes_tanh((float)(s[r] + fma((double)ti[r], wt, bb)));
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float* wrow = W2 + (size_t)d * (H + 1);
    double s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.0;
    for (int h = 0; h < H; ++h) {
      const double w = (double)wrow[h];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = fma((double)hid[r * H + h], w, s[r]);
    }
    const double wt = (double)wrow[H], bb = (double)b2[d];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      k_out[r * D + d] = lanes_tanh((float)(s[r] + fma((double)ti[r], wt, bb)));
  }
  __syncthreads();
}

// Loads ROWS rows of y, k1 and their (t, dt) (zero past the batch end) and
// runs the six stages. Shared layout: y | ks[0..6] | yi | g6 (each ROWS*D),
// then hid (ROWS*H), then tc | dtc | ti (ROWS each). On return yi holds
// y_new (the stage-6 state, FSAL) and g6 the stage-5 state.
template <int ROWS>
__device__ void lanes_recompute(const float* y_g, const float* k1_g, const float* t_g,
                                const float* dt_g, int row0, int rows, float* y_s,
                                float* ks, float* yi, float* g6, float* hid,
                                float* tc, float* dtc, float* ti,
                                const float* __restrict__ W1, const float* __restrict__ b1,
                                const float* __restrict__ W2, const float* __restrict__ b2,
                                int D, int H) {
  const int n = ROWS * D;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const bool valid = idx < rows * D;
    y_s[idx] = valid ? y_g[(size_t)row0 * D + idx] : 0.0f;
    ks[idx] = valid ? k1_g[(size_t)row0 * D + idx] : 0.0f;
  }
  for (int r = threadIdx.x; r < ROWS; r += kThreads) {
    tc[r] = r < rows ? t_g[row0 + r] : 0.0f;
    dtc[r] = r < rows ? dt_g[row0 + r] : 0.0f;
  }
  for (int i = 1; i <= 6; ++i) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const int r = idx / D;
      const float v = __fadd_rn(y_s[idx], __fmul_rn(dtc[r], lanes_acc(i, ks, n, idx)));
      yi[idx] = v;
      if (i == 5) g6[idx] = v;
    }
    for (int r = threadIdx.x; r < ROWS; r += kThreads) ti[r] = stage_time(i, tc, dtc, r);
    __syncthreads();
    lanes_stage<ROWS>(yi, hid, ks + i * n, ti, W1, b1, W2, b2, D, H);
  }
}

size_t lanes_fwd_smem_bytes(int D, int H) {
  return sizeof(float) * ((size_t)10 * kLanesFwdRows * D + (size_t)kLanesFwdRows * H +
                          3 * kLanesFwdRows);
}

// K11: one lane-wise Tsit5 trial step per row tile; writes y_new, k7, err,
// k6 and g6 of the tile's rows.
__global__ void __launch_bounds__(kThreads)
lanes_fwd_kernel(const float* __restrict__ t, const float* __restrict__ dt,
                 const float* __restrict__ y, const float* __restrict__ k1,
                 const float* __restrict__ W1, const float* __restrict__ b1,
                 const float* __restrict__ W2, const float* __restrict__ b2,
                 float* __restrict__ y_new, float* __restrict__ k7, float* __restrict__ err,
                 float* __restrict__ k6, float* __restrict__ g6_out, int B, int D, int H) {
  extern __shared__ float smem[];
  constexpr int R = kLanesFwdRows;
  const int n = R * D;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);
  float* y_s = smem;
  float* ks = y_s + n;  // 7 x n
  float* yi = ks + 7 * n;
  float* g6 = yi + n;
  float* hid = g6 + n;
  float* tc = hid + R * H;
  float* dtc = tc + R;
  float* ti = dtc + R;
  lanes_recompute<R>(y, k1, t, dt, row0, rows, y_s, ks, yi, g6, hid, tc, dtc, ti, W1, b1, W2,
                     b2, D, H);
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const size_t g = (size_t)row0 * D + idx;
    y_new[g] = yi[idx];
    k7[g] = ks[6 * n + idx];
    err[g] = __fmul_rn(dtc[idx / D], lanes_err_comb(ks, n, idx));
    k6[g] = ks[5 * n + idx];
    g6_out[g] = g6[idx];
  }
}

}  // namespace

extern "C" {

// K11. t, dt: (B,) per-lane time and step size; the five outputs (B, D).
int regnde_lanes_fwd(const float* t, const float* dt, const float* y, const float* k1,
                     const float* W1, const float* b1, const float* W2, const float* b2,
                     float* y_new, float* k7, float* err, float* k6, float* g6, int B, int D,
                     int H, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = lanes_fwd_smem_bytes(D, H);
  cudaError_t e = cudaFuncSetAttribute(
      lanes_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nblocks = (B + kLanesFwdRows - 1) / kLanesFwdRows;
  lanes_fwd_kernel<<<nblocks, kThreads, smem, s>>>(t, dt, y, k1, W1, b1, W2, b2, y_new, k7,
                                                   err, k6, g6, B, D, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
