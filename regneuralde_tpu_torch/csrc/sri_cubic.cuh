// The toy 2-D SDE's pair for the SDE whole solve's tile bodies
// (sde_whole_solve.cu, K9/K10; experiments/sde_toy.py): the drift is an MLP
// on the cube of the state, x -> x * x * x -> Dense(2, 50) tanh ->
// Dense(50, 2) (models.CubicDrift), the diffusion an MLP (Dense(2, 2)). The
// bodies are MlpPair's: where kCube, the forward builds the drift's f64
// input row from the cube of H0 (x * x * x rounds as (x * x) * x, XLA's two
// products), the drift's first weight cotangent takes the cube of H0 (the
// same products, so the same bits), and the reverse multiplies the drift's
// input cotangent by 3 * (x * x), the order of JAX's integer_pow rule. The
// file is compiled with -fmad=false.

#pragma once

#include "sri_mlp.cuh"

namespace {

struct CubicPair {
  static constexpr bool kCube = true;
  using Fixed = FixedWidths<2, 50>;  // its widths as constants
  MlpNet net[2];  // 0: the drift's MLP (after the cube), 1: the diffusion
};

}  // namespace
