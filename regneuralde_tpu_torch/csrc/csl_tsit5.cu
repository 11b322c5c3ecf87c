// Normed Tsit5 trial step of FFJORD's augmented CSL dynamics on Hopper: the
// forward (K7-CSL) and its hand-written backward (K8-CSL), plus the
// fixed-order reductions they launch.
//
// Replaces the TPU kernels
//   K7: regneuralde_tpu/ops/pallas_generic.py  make_normed_tsit5_sweep.fwd_pallas
//   K8: regneuralde_tpu/ops/pallas_generic.py  make_normed_tsit5_sweep.bwd_pallas
// specialised to FFJORD's CSL dynamics with the analytic Hutchinson product
// (pallas_generic.csl_aug_apply, csl_aug_leaves; the probe e is a
// row-aligned leaf). The TPU K8 traces jax.vjp of the stage algebra inside
// the kernel; there is no tracer here, so K8-CSL is the hand reverse chain
// of the same algebra (the plain version is ops/fused_csl.py _csl_bwd_math).
// That chain is second order: the forward already holds e^T J, so the
// pullback carries sigmoid' in the hops, each weight's second use inside
// W * g, and the gates' and time-biases' dependence on the stage time.
//
// What bounds it on this card. At FFJORD's tabular width (B=1024, dim 43,
// hidden 100) one trial step is 6 stages x (three affine maps and three
// hops) of about 18,600 multiply-adds a row: 0.46 GFLOP forward, about
// three times that backward, over 78 KB of parameters and 180 KB a row
// array. The f32 rate bounds it at about 7 us; the kernels are latency
// bound, six dependent products a stage each ending in a block barrier.
//
// What the design does about it. Both kernels run one block a tile of
// kCslBwdRows = 8 rows (128 blocks at B = 1024, one wave on 132 SMs); the
// parameters (19,572 floats) are loaded into shared memory once per
// launch, each weight row padded to an odd stride.
//   * K7-CSL, csl_forward_tile: every product on the FP64 tensor cores
//     (mma.sync m16n8k8 f64, the tile's 8 rows the instruction's N), each
//     output an f64 sum rounded once; the stage's activations stay in
//     shared memory; the three norm sums leave each block as one slot a
//     2-row sub-tile (kCslSlotRows), each reduced as a block of its own
//     would reduce two rows (ops/fused_csl.py csl_slot_order_sums), and a
//     second small kernel sums the ceil(B/2) slots in order: FFJORD's
//     error estimate sits at its f32 floor, where the order of these sums
//     decides accepts;
//   * K8-CSL, csl_reverse_tile: every product is FMA work on values in
//     shared memory, four rows a thread, a weight loaded once for four
//     chains; the recompute writes each stage's activations to device
//     memory (they do not fit beside the parameters), the reverse reads
//     them back a stage at a time; the weights' cotangents are held in
//     registers (4 x 4 tiles a thread) and written once per tile to a
//     per-block slot, which a second kernel sums in block order; the time
//     cotangent of each stage reaches t and dt through the per-tile
//     (ct_t, ct_dt) sums.
// No floating-point atomics: every result is bitwise reproducible (the
// norm sums decide accept/reject).
// The forward reproduces its plain version bitwise (see csl_tsit5.cuh), so
// that kernel and plain solves take the same steps where the error estimate
// sits at its f32 rounding floor.

#include "csl_tsit5.cuh"

namespace {

// K7-CSL: one normed Tsit5 trial step per row tile of kCslBwdRows rows
// (csl_forward_tile). Writes the tile's y_new and k7 rows and its slots'
// three norm sums to partials[slot] (kCslSlots slots a tile).
__global__ void __launch_bounds__(kThreads)
csl_fwd_kernel(const float* __restrict__ t_p, const float* __restrict__ dt_p,
               const float* __restrict__ y, const float* __restrict__ k1,
               const CslLeaves leaves, int kinetic, float* __restrict__ y_new,
               float* __restrict__ k7, float* __restrict__ partials, int B, int A,
               int D, int H, float rtol, float atol) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * kCslBwdRows;
  csl_load_params(leaves, D, H, smem);
  csl_forward_tile(y, k1, leaves.p[kCslParams], row0, min(kCslBwdRows, B - row0), *t_p,
                   *dt_p, smem, y_new, k7, partials + 3 * kCslSlots * blockIdx.x, A, D, H,
                   kinetic, rtol, atol, smem + csl_pad_floats(D, H));
}

// K8-CSL: the hand reverse chain of K7-CSL per row tile of kCslBwdRows
// rows (csl_reverse_tile), seeded with the row cotangents ct_ynew, ct_k7
// and the norm sums' cotangents. Writes the tile's ct_y and ct_k1 rows, and
// to slots[tile] its parameter cotangents (csl_leaf_floats, the leaves'
// layout) followed by its (ct_t, ct_dt); recs: the tiles' activation
// records (csl_reverse_records floats each).
__global__ void __launch_bounds__(kThreads)
csl_bwd_kernel(const float* __restrict__ t_p, const float* __restrict__ dt_p,
               const float* __restrict__ y, const float* __restrict__ k1,
               const CslLeaves leaves, int kinetic,
               const float* __restrict__ ct_ynew, const float* __restrict__ ct_k7,
               const float* __restrict__ ct_scalars, float* __restrict__ ct_y,
               float* __restrict__ ct_k1, float* __restrict__ slots,
               float* __restrict__ recs, int B, int A, int D, int H, float rtol,
               float atol) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * kCslBwdRows;
  const int nleaf = csl_leaf_floats(D, H);
  float* slot = slots + (size_t)blockIdx.x * (nleaf + 2);
  csl_load_weights(leaves, D, H, smem);
  csl_reverse_tile(y, k1, leaves.p[kCslParams], row0, min(kCslBwdRows, B - row0), *t_p,
                   *dt_p, smem, recs + (size_t)blockIdx.x * csl_reverse_records(D, H), slot,
                   false, ct_ynew, ct_k7, nullptr, nullptr, ct_scalars[0], ct_scalars[1],
                   ct_scalars[2], ct_y, ct_k1, slot + nleaf, A, D, H, kinetic, rtol, atol,
                   smem + csl_pad_floats(D, H));
}

}  // namespace

extern "C" {

// The forward's tile rows, the rows of one of its norm-sum slots, and its
// shared memory at A x D x H.
int regnde_csl_rows() { return kCslBwdRows; }
int regnde_csl_slot_rows() { return kCslSlotRows; }
int regnde_csl_fwd_smem_bytes(int A, int D, int H) { return (int)csl_fwd_smem_bytes(A, D, H); }

// K7-CSL. leaves: host array of 16 device pointers (the 15 parameters of
// CSLDynamics in parameters() order, then the probe e, B x D). A: the
// augmented state's width, D + 1 or D + 3 (kinetic). partials: (ceil(B/2),
// 3) scratch, a slot a 2-row sub-tile; sums: (3,) err_ssq, num_ssq,
// den_ssq.
int regnde_csl_fwd(const float* t, const float* dt, const float* y, const float* k1,
                   const float* const* leaves, int kinetic, float* y_new, float* k7,
                   float* partials, float* sums, int B, int A, int H, float rtol,
                   float atol, void* stream) {
  const int D = A - 1 - 2 * kinetic;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = csl_fwd_smem_bytes(A, D, H);
  cudaError_t e = cudaFuncSetAttribute(
      csl_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nblocks = (B + kCslBwdRows - 1) / kCslBwdRows;
  csl_fwd_kernel<<<nblocks, kThreads, smem, s>>>(t, dt, y, k1, pack_csl_leaves(leaves),
                                                 kinetic, y_new, k7, partials, B, A, D,
                                                 H, rtol, atol);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nslots = (B + kCslSlotRows - 1) / kCslSlotRows;
  sum_slots_warp_kernel<<<1, 3 * 32, 0, s>>>(partials, nslots, 3, sums);
  return (int)cudaGetLastError();
}

// The backward's tile rows, its shared memory at A x D x H and the most
// 4 x 4 weight-cotangent tiles it holds (csl_cw_tiles must not exceed it).
int regnde_csl_bwd_rows() { return kCslBwdRows; }
int regnde_csl_bwd_smem_bytes(int A, int D, int H) { return (int)csl_bwd_smem_bytes(A, D, H); }
int regnde_csl_bwd_max_tiles() { return kCslCwTiles * kThreads; }

// K8-CSL. ct_scalars: (3,) cotangents of the three sums. out:
// (csl_leaf_floats + 2,) the parameters' cotangents in order (the leaves'
// layout), then ct_t and ct_dt. slots: (ceil(B/8), csl_leaf_floats + 2) and
// recs: (ceil(B/8), csl_reverse_records) scratch.
int regnde_csl_bwd(const float* t, const float* dt, const float* y, const float* k1,
                   const float* const* leaves, int kinetic, const float* ct_ynew,
                   const float* ct_k7, const float* ct_scalars, float* ct_y,
                   float* ct_k1, float* slots, float* recs, float* out, int B, int A,
                   int H, float rtol, float atol, void* stream) {
  const int D = A - 1 - 2 * kinetic;
  if (csl_cw_tiles(D, H) > kCslCwTiles * kThreads) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = csl_bwd_smem_bytes(A, D, H);
  cudaError_t e = cudaFuncSetAttribute(
      csl_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nblocks = (B + kCslBwdRows - 1) / kCslBwdRows;
  csl_bwd_kernel<<<nblocks, kThreads, smem, s>>>(
      t, dt, y, k1, pack_csl_leaves(leaves), kinetic, ct_ynew, ct_k7, ct_scalars,
      ct_y, ct_k1, slots, recs, B, A, D, H, rtol, atol);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int width = csl_leaf_floats(D, H) + 2;
  sum_slots_kernel<<<(width + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      slots, nblocks, width, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
