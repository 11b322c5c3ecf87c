// The weight-cotangent contraction that ends the MLPDynamics backward
// kernels K2, K14 and K12 (mlp_step_walk.cuh) and K4<MlpDyn>
// (mlp_walk.cuh). Each of them stores,
// for every stage of every row it reverses, the rows
//   cp2 (K, D) = ct_pre2,  he (K, H+2) = [h, t_i, 1],
//   cp1 (K, H) = ct_pre1,  ye (K, D+2) = [y_i, t_i, 1],
// and the weight cotangents in nn.Linear layout are two products over K:
//   cW2 | cb2 = cp2^T he   (D x (H+1) and D),
//   cW1 | cb1 = cp1^T ye   (H x (D+1) and H).
//
// Replaces the weight-cotangent sums the TPU kernels carry from one grid
// step to the next: regneuralde_tpu/ops/pallas_mlp.py _make_normed_kernels
// bwd_kernel (K2, the cw*_ref accumulation at :1263), _fused_bwd_kernel
// (K14, :405) and _fused_bwd_kernel_lanes (K12, :814), and
// regneuralde_tpu/ops/pallas_solve.py make_bwd_kernel's ct_leaves (K4,
// :629). There the grid runs in order on one core; here the 6 * B rows
// (6 * B * ns for K4) are summed after the walk by the two kernels below.
//
// What bounds it on this card. 2 K (D (H+2) + H (D+2)) f32 operations over
// 4 K (2 D + 2 H + 4) bytes of rows: at the flagship's D = 784, H = 100
// about 45 operations a byte, above the H100's f32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20): the bound is the FMA pipes, 0.48 ms at K = 101,376 (33
// trial steps) and 0.0145 ms at K = 3072.
//
// What the design does about it.
//   * Split over K. K is cut into chunks of chunk_rows rows (the rule is
//     ops/weight_cotangents.py plan(): about four blocks an SM at large K,
//     at least 64 rows a chunk, a cap on the partial buffer). One block
//     owns one 64 x 128 output tile of one product over one chunk, so both
//     products and every chunk go in one launch; it writes its partial
//     tile to a scratch buffer, and a second kernel sums the chunks in
//     chunk order. No atomics: two runs are bitwise equal.
//   * Orientation. Each product is computed with its wider side as the
//     tile's 64-row side: cp1^T ye is computed as ye^T cp1 and transposed
//     when the chunks are summed, so both flagship products are 13 tiles
//     of 64 x 128 (102 or 100 of the 128 columns live).
//   * Register tiles. 128 threads a block, each with 8 x 8 outputs in
//     registers; a step of k reads two float4 of A and two of B from shared
//     memory for 64 FMAs.
//   * Pipelining. kStages slabs of 8 rows of A and B are in flight with
//     cp.async while the block computes on the oldest. he and ye have row
//     strides of H+2 and D+2 floats, 8-byte but not 16-byte aligned at the
//     flagship, so the rows are copied 8 bytes at a time where all four row
//     widths are even (the flagship's), else 4: no stored row changes its
//     layout, and the backward kernels that write them keep their code. One
//     width for the launch keeps each thread at one column of a slab, with
//     few addresses live beside its 64 sums.
//   * Precision: IEEE f32 FMAs in a fixed order, no TF32, no fast math.
//
// Making it faster (fewer padded columns, tensor cores are ruled out by
// the precision) is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 64;       // tile rows: the product's wider side
constexpr int kBN = 128;      // tile columns: its narrower side
constexpr int kBK = 8;        // rows of K in one pipeline stage
constexpr int kStages = 4;    // stages in flight
constexpr int kThreads = 128; // 8 x 16 threads, 8 x 8 outputs each
constexpr int kSumThreads = 256;

// One product C (rows x cols) = A^T B with A (K, rows) and B (K, cols), as
// the chunk kernel sees it: C' (m x n) = a^T b with a the wider operand.
struct Product {
  const float* a;     // (K, m) rows
  const float* b;     // (K, n) rows
  float* part;        // chunk c's partial C' at part + c * stride, row stride ldp
  float* c_main;      // natural C's columns 0 .. cols-2, (rows, cols-1)
  float* c_last;      // natural C's last column, (rows,)
  int m, n, ldp;
  int tiles_n, tiles;
  int stride;         // floats between two chunks' partials
  int transposed;     // 1: C' = C^T (a is the natural B)
  int cols;
};

struct Args {
  Product p[2];
  int K, chunk_rows;
};

// A copy of V floats from global to shared memory, zero-filled (no bytes
// read) where ok is false.
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int nbytes = ok ? 4 * V : 0;
  if constexpr (V == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
                 "r"(nbytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(nbytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [k0, k0 + kBK) and columns [c0, c0 + W) of the (K, ld) row array src
// into dst (kBK x W), zeros past kend and past ld.
template <int W, int V>
__device__ __forceinline__ void load_slab(float* dst, const float* src, int ld, int c0,
                                          int k0, int kend) {
  constexpr int kPerRow = W / V;
  constexpr int kCount = kBK * kPerRow;
  static_assert(kCount % kThreads == 0, "whole copies per thread");
#pragma unroll
  for (int j = 0; j < kCount / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kPerRow, c = (i - r * kPerRow) * V;
    const int k = k0 + r, col = c0 + c;
    const bool ok = k < kend && col < ld;
    cp_async<V>(dst + r * W + c, ok ? src + (size_t)k * ld + col : src, ok);
  }
}

// One block's work: the partial sum over chunk `chunk`'s rows of tile t
// of product W, each thread's 8 x 8 outputs summed over k in order with
// fmaf, its rows copied V floats at a time. The product is read from the
// kernel's parameters at a fixed index, so its fields stay constant-bank
// operands and take no registers.
template <int W, int V>
__device__ __forceinline__ void chunk_tile(const Args& args, int chunk, int t, float* As,
                                           float* Bs) {
  const Product& P = args.p[W];
  const int tm = t / P.tiles_n;
  const int m0 = tm * kBM, n0 = (t - tm * P.tiles_n) * kBN;
  const int kbeg = chunk * args.chunk_rows;
  const int kend = min(args.K, kbeg + args.chunk_rows);
  const int nk = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      load_slab<kBM, V>(As + s * kBK * kBM, P.a, P.m, m0, kbeg + s * kBK, kend);
      load_slab<kBN, V>(Bs + s * kBK * kBN, P.b, P.n, n0, kbeg + s * kBK, kend);
    }
    cp_async_commit();
  }

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // slab kt has landed
    __syncthreads();               // and every thread is done with slab kt - 1
    const int next = kt + kStages - 1;
    if (next < nk) {
      const int s = next % kStages;
      load_slab<kBM, V>(As + s * kBK * kBM, P.a, P.m, m0, kbeg + next * kBK, kend);
      load_slab<kBN, V>(Bs + s * kBK * kBN, P.b, P.n, n0, kbeg + next * kBK, kend);
    }
    cp_async_commit();
    const float* as = As + (kt % kStages) * kBK * kBM + ty * 4;
    const float* bs = Bs + (kt % kStages) * kBK * kBN + tx * 4;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kBM);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * kBM + 32);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kBN);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kBN + 64);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // The partial tile; ldp is n rounded up to 4, so a float4 whose first
  // column is live lies inside the row.
  float* part = P.part + (size_t)chunk * P.stride;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 32 + ty * 4 + i - 4);
    if (m >= P.m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n < P.n) {
        *reinterpret_cast<float4*>(part + (size_t)m * P.ldp + n) = make_float4(
            acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      }
    }
  }
}

// Block (chunk, product, tile), chunks slowest: the blocks of one chunk run
// together and share its rows through L2. V: the copy width of every row
// array in floats, 2 or 1 (one width for all, so that each thread copies
// every row of a slab at the same column and holds few addresses).
template <int V>
__global__ void __launch_bounds__(kThreads, 4)
    wcot_chunk_kernel(const __grid_constant__ Args args) {
  __shared__ __align__(16) float As[kStages * kBK * kBM];
  __shared__ __align__(16) float Bs[kStages * kBK * kBN];
  const int tiles_all = args.p[0].tiles + args.p[1].tiles;
  const int chunk = blockIdx.x / tiles_all;
  const int t = blockIdx.x - chunk * tiles_all;
  if (t < args.p[0].tiles) {
    chunk_tile<0, V>(args, chunk, t, As, Bs);
  } else {
    chunk_tile<1, V>(args, chunk, t - args.p[0].tiles, As, Bs);
  }
}

// One output of product W: its chunks' partials summed in chunk order,
// written to c_main / c_last in the natural (nn.Linear) layout.
template <int W>
__device__ __forceinline__ void sum_output(const Args& args, int local, int nchunks) {
  const Product& P = args.p[W];
  const int m = local / P.n, n = local - m * P.n;
  const float* src = P.part + (size_t)m * P.ldp + n;
  float s = src[0];
  for (int c = 1; c < nchunks; ++c) s += src[(size_t)c * P.stride];
  const int r = P.transposed ? n : m, col = P.transposed ? m : n;
  if (col < P.cols - 1) {
    P.c_main[(size_t)r * (P.cols - 1) + col] = s;
  } else {
    P.c_last[r] = s;
  }
}

__global__ void __launch_bounds__(kSumThreads)
    wcot_sum_kernel(const __grid_constant__ Args args, int nchunks) {
  const int total0 = args.p[0].m * args.p[0].n;
  const int total = total0 + args.p[1].m * args.p[1].n;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += gridDim.x * blockDim.x) {
    if (e < total0) {
      sum_output<0>(args, e, nchunks);
    } else {
      sum_output<1>(args, e - total0, nchunks);
    }
  }
}

int round4(int x) { return (x + 3) & ~3; }

// Whether rows of length ld at base p can be copied 8 bytes at a time.
bool pairs(const float* p, int ld) {
  return ld % 2 == 0 && reinterpret_cast<uintptr_t>(p) % 8 == 0;
}

// C (rows x cols) = A^T B, its wider side on the tile's rows.
Product make_product(const float* A, const float* B, int rows, int cols, float* c_main,
                     float* c_last, float* part) {
  Product p;
  p.transposed = rows < cols;
  p.a = p.transposed ? B : A;
  p.b = p.transposed ? A : B;
  p.m = p.transposed ? cols : rows;
  p.n = p.transposed ? rows : cols;
  p.ldp = round4(p.n);
  p.tiles_n = (p.n + kBN - 1) / kBN;
  p.tiles = ((p.m + kBM - 1) / kBM) * p.tiles_n;
  p.stride = round4(rows) * round4(cols);
  p.part = part;
  p.c_main = c_main;
  p.c_last = c_last;
  p.cols = cols;
  return p;
}

}  // namespace

extern "C" {

// cW2 | cb2 = cp2^T he and cW1 | cb1 = cp1^T ye over K rows: cp2 (K, D),
// he (K, H+2), cp1 (K, H), ye (K, D+2); cW1 (H, D+1), cb1 (H), cW2
// (D, H+1), cb2 (D). partials: scratch of partial_floats floats, at least
// nchunks * (r4(D) r4(H+2) + r4(H) r4(D+2)) with r4 rounding up to a
// multiple of 4 and nchunks = ceil(K / chunk_rows) (1 when K = 0).
int regnde_weight_cotangents(const float* cp2, const float* he, const float* cp1,
                             const float* ye, float* cW1, float* cb1, float* cW2, float* cb2,
                             float* partials, int K, int D, int H, int chunk_rows,
                             int partial_floats, void* stream) {
  if (K < 0 || D < 1 || H < 1 || chunk_rows < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nchunks = K > 0 ? (K - 1) / chunk_rows + 1 : 1;
  Args args;
  args.p[0] = make_product(cp2, he, D, H + 2, cW2, cb2, partials);
  const size_t floats0 = (size_t)nchunks * args.p[0].stride;
  args.p[1] = make_product(cp1, ye, H, D + 2, cW1, cb1, partials + floats0);
  if (floats0 + (size_t)nchunks * args.p[1].stride > (size_t)partial_floats) {
    return (int)cudaErrorInvalidValue;
  }
  args.K = K;
  args.chunk_rows = chunk_rows;
  const int blocks = nchunks * (args.p[0].tiles + args.p[1].tiles);
  // 8-byte copies where the four row widths are even (the flagship's);
  // 16-byte ones for all four would need D and D + 2 both multiples of 4
  if (pairs(cp2, D) && pairs(he, H + 2) && pairs(cp1, H) && pairs(ye, D + 2)) {
    wcot_chunk_kernel<2><<<blocks, kThreads, 0, s>>>(args);
  } else {
    wcot_chunk_kernel<1><<<blocks, kThreads, 0, s>>>(args);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int total = D * (H + 2) + H * (D + 2);
  wcot_sum_kernel<<<(total + kSumThreads - 1) / kSumThreads, kSumThreads, 0, s>>>(args,
                                                                                nchunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
