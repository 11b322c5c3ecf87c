// The tile body of the SDE whole solve (sde_whole_solve.cu, K9/K10) for
// the toy 2-D SDE's pair (experiments/sde_toy.py): the drift is an MLP on
// the cube of the state, x -> x * x * x -> Dense(2, 50) tanh -> Dense(50,
// 2) (models.CubicDrift), the diffusion an MLP (Dense(2, 2)). The MLP
// parts are sri_mlp.cuh's net_eval and net_pullback, unchanged; MlpPair's
// code is not touched.
//
// The cube of a tile's rows lives in a scratch area of kSdeRows * D floats
// that CubicPair claims after both networks' padded leaves (padded_floats()
// counts it, so the kernels' shared-memory layout needs no change): eval
// fills it from x and runs the drift on it; pullback recomputes it (the
// same products, so the same bits) as the drift's input for the weights'
// cotangents, and takes the state's cotangent as c_xc * (3 * (x * x)),
// the order of JAX's integer_pow rule. x * x * x rounds as (x * x) * x,
// XLA's two products. The file is compiled with -fmad=false.

#pragma once

#include "sri_mlp.cuh"

namespace {

struct CubicPair {
  MlpNet net[2];  // 0: the drift's MLP (after the cube), 1: the diffusion

  __host__ __device__ int scratch_offset() const {
    return net_padded_floats(net[0]) + net_padded_floats(net[1]);
  }
  __host__ __device__ int padded_floats() const {
    return scratch_offset() + kSdeRows * net[0].w[0];
  }
  __host__ __device__ int leaf_floats() const {
    return net_leaf_floats(net[0]) + net_leaf_floats(net[1]);
  }
  __host__ __device__ int hidden_floats(int k) const {
    return kSdeRows * net_hidden_floats(net[k]);
  }
  __host__ __device__ int max_width() const {
    const int a = net_max_width(net[0]), b = net_max_width(net[1]);
    return a > b ? a : b;
  }
  __device__ void load(float* wsm) const {
    net_load(net[0], wsm);
    net_load(net[1], wsm + net_padded_floats(net[0]));
  }
  // the cube of the tile's rows x into the scratch area; ends synchronised
  __device__ float* cube(const float* wsm, const float* x) const {
    float* xc = const_cast<float*>(wsm) + scratch_offset();
    for (int idx = threadIdx.x; idx < kSdeRows * net[0].w[0]; idx += kThreads)
      xc[idx] = x[idx] * x[idx] * x[idx];
    __syncthreads();
    return xc;
  }
  __device__ void eval(int k, const float* wsm, const float* x, float* out, float* acts,
                       float* bufa, float* bufb) const {
    if (k) {
      net_eval(net[1], wsm + net_padded_floats(net[0]), x, out, acts, bufa, bufb);
      return;
    }
    net_eval(net[0], wsm, cube(wsm, x), out, acts, bufa, bufb);
  }
  __device__ void pullback(int k, const float* wsm, float* cw, const float* x,
                           const float* acts, const float* c_out, float* c_x, float* bufa,
                           float* bufb) const {
    if (k) {
      net_pullback(net[1], wsm + net_padded_floats(net[0]), cw + net_leaf_floats(net[0]), x,
                   acts, c_out, c_x, bufa, bufb);
      return;
    }
    net_pullback(net[0], wsm, cw, cube(wsm, x), acts, c_out, c_x, bufa, bufb);
    for (int idx = threadIdx.x; idx < kSdeRows * net[0].w[0]; idx += kThreads)
      c_x[idx] = c_x[idx] * (3.0f * (x[idx] * x[idx]));
    __syncthreads();
  }
};

}  // namespace
