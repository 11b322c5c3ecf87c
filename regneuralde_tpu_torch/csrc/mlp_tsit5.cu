// Tsit5 trial step of MLPDynamics on Hopper in the solver's tuple protocol:
// the forward (K13) writes the rows (y_new, k7, err, k6, g6). The step of
// odeint's generic engine with regneuralde_tpu_torch/ops/fused_mlp.py
// mlp_dynamics_stage_sweep. Its hand-written backward (K14), which maps the
// rows' five cotangents to those of t, dt, y, k1 and the weights, is one
// trial step of the MLPDynamics reverse walk (mlp_step_walk.cuh, built in
// whole_solve.cu; C entry regnde_mlp_tsit5_bwd).
//
// Replaces the TPU kernel
//   K13: regneuralde_tpu/ops/pallas_mlp.py  _pallas_sweep (_fused_step_kernel)
//
// What bounds it on this card. At the flagship shape (B=512, D=784, H=100)
// one trial step is 12 contractions of 2*B*D*H = 80 MFLOP, about 1 GFLOP,
// over 0.6 MB of weights and 7 row arrays of 1.6 MB. Far below the card's
// f32 rate and its bandwidth: the bound is latency, six dependent stages of
// a contraction, a tanh and a lincomb, a block barrier between them.
//
// What the design does about it. K1's layout and tile body
// (normed_tsit5.cuh, included read-only): one block owns a 4-row tile and
// runs all six stages with the state, the seven stage derivatives and the
// hidden activations in shared memory; the weights are read from L2 in
// nn.Linear's layout. K13 is K1's stage loop with the norm sums left out
// and three more rows written. No floating-point atomics: the kernel is
// bitwise deterministic, which the replay adjoint relies on (it recomputes
// each step's accept flag from K13's rows).
//
// Making this fast (wgmma, TMA) is later work; the contractions here are
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
  recompute_stages<R>(y, k1, row0, rows, t, dt, y_s, ks, yi, g6, hid, W1, b1, W2, b2, D,
                      H);
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

}  // extern "C"
