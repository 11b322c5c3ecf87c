// Normed Tsit5 trial step of the latent ODE's AlternatingMLP dynamics on
// Hopper: the forward (K7) and its hand-written backward (K8), plus the
// fixed-order reductions they launch.
//
// Replaces the TPU kernels
//   K7: regneuralde_tpu/ops/pallas_generic.py  make_normed_tsit5_sweep.fwd_pallas
//   K8: regneuralde_tpu/ops/pallas_generic.py  make_normed_tsit5_sweep.bwd_pallas
// specialised to AlternatingMLP (pallas_generic.alternating_mlp_apply):
//   f(y) = tanh(... tanh(down_0(tanh(up_0(tanh(y))))) ...), depth x (up, down),
// up_i: nn.Linear(D, H), down_i: nn.Linear(H, D), no time input.
// The TPU K8 traces jax.vjp of the stage algebra inside the kernel; there
// is no tracer here, so K8 is the hand reverse chain of the same algebra
// (the plain version is ops/fused_generic.py _altmlp_bwd_math).
//
// What bounds it on this card. At the latent shape (B=256, D=20, H=50,
// depth 4) one trial step is 6 stages x 8 layers of (rows x 20 x 50)
// products: 25 MFLOP forward, about 75 MFLOP backward, over 33 KB of
// weights and 20 KB a row array. Nothing here approaches the card's f32
// rate or bandwidth: the bound is latency, 6 x 8 dependent layers (12 x 8
// in the backward) and the block barriers between them, plus the launches
// themselves.
//
// What the design does about it. Widths of 20 and 50 are far below a
// tensor-core tile, so every product is FMA work on values in shared
// memory; all leaves (8,280 floats) are loaded into shared memory once per
// launch (K8 pads each weight row to an odd stride; K7 copies them as they
// are, 16 bytes a thread). No floating-point atomics anywhere, so every
// result is bitwise reproducible: the norm sums decide accept/reject, and a
// flipped accept changes NFE and the adjoint.
//   * K7: one block owns a tile of kAltRows = 2 rows and runs the forward
//     body altmlp_forward_tile (altmlp_tsit5.cuh): the leaves copied into
//     shared memory by cp.async, all in flight at once; each layer of the
//     six stages one phase between two block barriers in which every
//     thread takes a share of the products (each sum split over lanes of a
//     warp, added by a shuffle butterfly), the latent widths compiled as
//     constants; the last layer's phase builds the next stage's input. The
//     three norm sums leave each block as a slot a 2-row sub-tile, summed
//     in slot order by a second small kernel (as K1).
//   * K8: one block owns a tile of kAltBwdRows rows and runs the reverse
//     body altmlp_reverse_tile (altmlp_tsit5.cuh): each layer of the stage
//     recompute and of the reverse is one phase between two block barriers
//     in which every thread takes a share of the products (a product's sum
//     split over lanes of a warp, added by a shuffle butterfly); the weight
//     and bias cotangents stay in their owner threads' registers for the
//     launch and reach the block's slot once; a second kernel sums the
//     slots in block order (as weight_cotangents.cu sums its chunks). The
//     records of stages 1-4 go through a per-block scratch in device memory
//     (recs).
// Arithmetic is IEEE (no fast math, no TF32), tanh is the accurate tanhf
// (the counterpart of jnp.tanh; no tanh.approx.f32): the embedded error
// estimate is a fifth-order cancellation. The forward reproduces its plain
// version (ops/fused_generic.py plain_altmlp_normed_sweep) rounding for
// rounding: each affine map is summed in f64 and rounded once to f32 (as
// the plain version's f64 addmm), and the stage and error lincombs round
// each multiply and add as PyTorch's separate ops do (__fmul_rn/__fadd_rn,
// no contraction into an FMA). At the latent ODE's width the error
// estimate of a smooth solve sits at its f32 rounding floor, where any
// other rounding moves the step sizes and with them NFE; bitwise stage
// values keep kernel and plain solves on the same steps. K8's recompute
// sums the same f64 terms in the same order (alt_affine_rows); its order
// on the CPU is ops/fused_generic.py plain_altmlp_fwd_tiles.

#include "altmlp_tsit5.cuh"

namespace {

// K7: one normed Tsit5 trial step of AlternatingMLP per row tile. Writes
// the tile's y_new and k7 rows and the three norm sums of each of its slots
// to partials[slot] (kAltSlots slots a tile).
__global__ void __launch_bounds__(kThreads)
altmlp_fwd_kernel(const float* __restrict__ t_p, const float* __restrict__ dt_p,
                  const float* __restrict__ y, const float* __restrict__ k1,
                  const AltLeaves leaves, int depth, float* __restrict__ y_new,
                  float* __restrict__ k7, float* __restrict__ partials, int B,
                  int D, int H, float rtol, float atol) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * kAltRows;
  (void)t_p;  // the dynamics take no time input
  float* wsm = smem;
  alt_fwd_load_weights(leaves, depth, D, H, wsm);
  altmlp_forward_tile(y, k1, row0, min(kAltRows, B - row0), *dt_p, wsm, depth, y_new, k7,
                      partials + 3 * kAltSlots * blockIdx.x, D, H, rtol, atol,
                      wsm + alt_fwd_weight_floats(depth, D, H));
}

// K8: the hand reverse chain of K7 per row tile of kAltBwdRows rows,
// seeded with the row cotangents ct_ynew, ct_k7 and the norm sums'
// cotangents. Writes the tile's ct_y and ct_k1 rows, and to slots[tile]
// its weight cotangents (leaf_floats, nn.Linear layout, leaves in order)
// followed by its (ct_t, ct_dt). ct_t is exactly zero: the dynamics ignore
// t. recs: alt_reverse_records floats a block.
__global__ void __launch_bounds__(kThreads)
altmlp_bwd_kernel(const float* __restrict__ dt_p, const float* __restrict__ y,
                  const float* __restrict__ k1, const AltLeaves leaves,
                  int depth, const float* __restrict__ ct_ynew,
                  const float* __restrict__ ct_k7,
                  const float* __restrict__ ct_scalars,
                  float* __restrict__ ct_y, float* __restrict__ ct_k1,
                  float* __restrict__ slots, float* __restrict__ recs, int B, int D, int H,
                  float rtol, float atol) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * kAltBwdRows;
  const int nleaf = leaf_floats(depth, D, H);
  float* wsm = smem;
  float* tile = wsm + padded_weight_floats(depth, D, H);
  load_weights(leaves, depth, D, H, wsm);
  AltCw cw;
  alt_reverse_begin(cw, tile, depth, D, H);
  float* slot = slots + (size_t)blockIdx.x * (nleaf + 2);
  altmlp_reverse_tile(y, k1, row0, min(kAltBwdRows, B - row0), *dt_p, wsm, depth, cw,
                      recs + (size_t)blockIdx.x * alt_reverse_records(depth, D, H), ct_ynew,
                      ct_k7, nullptr, nullptr, ct_scalars[0], ct_scalars[1], ct_scalars[2],
                      ct_y, ct_k1, slot + nleaf, D, H, rtol, atol, tile);
  alt_cw_store(cw, tile, slot, depth, D, H);
}

}  // namespace

extern "C" {

// K7's and K3's forward tile: its rows, its norm-sum slots' rows, and its
// block's shared memory.
int regnde_altmlp_rows() { return kAltRows; }
int regnde_altmlp_slot_rows() { return kAltSlotRows; }
int regnde_altmlp_fwd_smem_bytes(int depth, int D, int H) {
  return (int)altmlp_fwd_smem_bytes(depth, D, H);
}
int regnde_altmlp_max_depth() { return kMaxLeaves / 4; }
// K8's and K4's reverse tile: its rows, and its block's shared memory.
int regnde_altmlp_bwd_rows() { return kAltBwdRows; }
int regnde_altmlp_bwd_smem_bytes(int depth, int D, int H) {
  return (int)altmlp_bwd_smem_bytes(depth, D, H);
}

// K7. leaves: host array of 4 * depth device pointers (up_0.weight,
// up_0.bias, down_0.weight, down_0.bias, ...). partials: (ceil(B/R) *
// kAltSlots, 3) scratch, R = kAltRows; sums: (3,) err_ssq, num_ssq, den_ssq.
int regnde_altmlp_fwd(const float* t, const float* dt, const float* y,
                      const float* k1, const float* const* leaves, int depth,
                      float* y_new, float* k7, float* partials, float* sums,
                      int B, int D, int H, float rtol, float atol, void* stream) {
  if (depth < 1 || 4 * depth > kMaxLeaves) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = altmlp_fwd_smem_bytes(depth, D, H);
  cudaError_t e = cudaFuncSetAttribute(
      altmlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nblocks = (B + kAltRows - 1) / kAltRows;
  altmlp_fwd_kernel<<<nblocks, kThreads, smem, s>>>(
      t, dt, y, k1, pack_leaves(leaves, depth), depth, y_new, k7, partials, B,
      D, H, rtol, atol);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nslots = (B + kAltSlotRows - 1) / kAltSlotRows;
  sum_slots_warp_kernel<<<1, 3 * 32, 0, s>>>(partials, nslots, 3, sums);
  return (int)cudaGetLastError();
}

// K8. ct_scalars: (3,) cotangents of the three sums. out: (leaf_floats +
// 2,) the leaves' cotangents in order (nn.Linear layout), then ct_t and
// ct_dt. slots: (ceil(B/R), leaf_floats + 2) and recs: (ceil(B/R),
// alt_reverse_records) scratch, R = kAltBwdRows.
int regnde_altmlp_bwd(const float* dt, const float* y, const float* k1,
                      const float* const* leaves, int depth,
                      const float* ct_ynew, const float* ct_k7,
                      const float* ct_scalars, float* ct_y, float* ct_k1,
                      float* slots, float* recs, float* out, int B, int D, int H, float rtol,
                      float atol, void* stream) {
  if (depth < 1 || 4 * depth > kMaxLeaves) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = altmlp_bwd_smem_bytes(depth, D, H);
  cudaError_t e = cudaFuncSetAttribute(
      altmlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nblocks = (B + kAltBwdRows - 1) / kAltBwdRows;
  altmlp_bwd_kernel<<<nblocks, kThreads, smem, s>>>(
      dt, y, k1, pack_leaves(leaves, depth), depth, ct_ynew, ct_k7, ct_scalars,
      ct_y, ct_k1, slots, recs, B, D, H, rtol, atol);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int width = leaf_floats(depth, D, H) + 2;
  sum_slots_kernel<<<(width + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      slots, nblocks, width, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
