// Normed Tsit5 trial step of MLPDynamics on Hopper: forward (K1) and its
// hand-written backward (K2), plus the two small helpers they launch.
//
// Replaces the TPU kernels
//   K1: regneuralde_tpu/ops/pallas_mlp.py  _normed_pallas_fwd
//       (_make_normed_kernels.fwd_kernel)
//   K2: regneuralde_tpu/ops/pallas_mlp.py  _normed_pallas_bwd
//       (_make_normed_kernels.bwd_kernel, math in _normed_bwd_math)
//
// What bounds it on this card. One trial step at the flagship shape
// (B=512, D=784, H=100) is 12 contractions of 2*B*D*H = 80 MFLOP each,
// about 1 GFLOP forward and 3 GFLOP backward, over 0.6 MB of weights and
// about 13 MB of row data. Both are far below the card's f32 rate and
// bandwidth, so the bound is latency: six dependent stages, each a
// contraction, a tanh and a lincomb, with a block barrier between them.
//
// What the design does about it. The Pallas kernels tile the batch in
// 128 (forward) / 64 (backward) row blocks that run in sequence and carry
// the norm sums and the weight cotangents from one grid step to the next.
// Here blocks run in parallel with nothing carried between them:
//   * every stage is row-independent, so one block owns a small row tile
//     (4 rows forward, 2 backward) and runs all six stages with the state,
//     the seven stage derivatives and the hidden activations in shared
//     memory; the weights (2 x 314 KB) are read from L2 by every block in
//     the layout nn.Linear holds them ((out, in), time column last), so no
//     copy happens per trial step;
//   * cross-block sums (the three norm sums; ct_t, ct_dt) go to a
//     (blocks, q) buffer that a one-warp kernel reduces in block order;
//   * the weight cotangents are batch reductions. The backward stores the
//     per-stage rows they need (ct_pre2, [h, t_i, 1], ct_pre1,
//     [y_i, t_i, 1]) and a tiled contraction kernel sums the 6*B rows in a
//     fixed order, one output element per thread.
// Every sum therefore has a fixed order and no floating-point atomics: the
// norm sums decide accept/reject, and a flipped accept changes NFE and the
// whole adjoint. All arithmetic is IEEE f32 on the FMA pipes (no TF32, no
// fast-math): the embedded error estimate is a fifth-order cancellation.
// tanh is 2*sigmoid(2x)-1 with expf, as regneuralde_tpu/ops/math.py has it.
//
// Making these fast (wgmma, TMA, a persistent multi-CTA solve) is later
// work; the contractions here are plain FMA loops.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFwdRows = 4;
constexpr int kBwdRows = 2;
constexpr int kTile = 32;

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
// hs, when given, receives each stage's hidden activations (6 x ROWS*H).
template <int ROWS>
__device__ void recompute_stages(const float* __restrict__ y_g,
                                 const float* __restrict__ k1_g, int row0,
                                 int rows, float t, float dt, float* y_s,
                                 float* ks, float* yi, float* g6, float* hid,
                                 float* hs, const float* __restrict__ W1,
                                 const float* __restrict__ b1,
                                 const float* __restrict__ W2,
                                 const float* __restrict__ b2, int D, int H) {
  const int n = ROWS * D;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const bool valid = idx < rows * D;
    y_s[idx] = valid ? y_g[(size_t)row0 * D + idx] : 0.0f;
    ks[idx] = valid ? k1_g[(size_t)row0 * D + idx] : 0.0f;
  }
  for (int i = 1; i <= 6; ++i) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const float v = y_s[idx] + dt * stage_acc(i, ks, n, idx);
      yi[idx] = v;
      if (i == 5) g6[idx] = v;
    }
    __syncthreads();
    float* h_out = hs ? hs + (i - 1) * ROWS * H : hid;
    mlp_stage<ROWS>(yi, h_out, ks + i * n, t + kC[i] * dt, W1, b1, W2, b2, D, H);
  }
  __syncthreads();
}

// K1: one normed Tsit5 trial step per row tile.
__global__ void __launch_bounds__(kThreads)
normed_fwd_kernel(const float* __restrict__ t_p, const float* __restrict__ dt_p,
                  const float* __restrict__ y, const float* __restrict__ k1,
                  const float* __restrict__ W1, const float* __restrict__ b1,
                  const float* __restrict__ W2, const float* __restrict__ b2,
                  float* __restrict__ y_new, float* __restrict__ k7,
                  float* __restrict__ partials, int B, int D, int H,
                  float rtol, float atol) {
  extern __shared__ float smem[];
  constexpr int R = kFwdRows;
  const int n = R * D;
  float* y_s = smem;
  float* ks = y_s + n;
  float* yi = ks + 7 * n;
  float* g6 = yi + n;
  float* hid = g6 + n;
  float* red = hid + R * H;

  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);
  const float t = *t_p, dt = *dt_p;
  recompute_stages<R>(y, k1, row0, rows, t, dt, y_s, ks, yi, g6, hid, nullptr,
                      W1, b1, W2, b2, D, H);

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
  block_sum_to<3>(sums, red, partials + 3 * blockIdx.x);
}

// out[q] = sum over blocks b (in order of b) of partials[b * nq + q]; one warp.
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       int nblocks, int nq,
                                       float* __restrict__ out) {
  const int lane = threadIdx.x;
  for (int q = 0; q < nq; ++q) {
    float s = 0.0f;
    for (int b = lane; b < nblocks; b += 32) s += partials[b * nq + q];
    s = warp_sum(s);
    if (lane == 0) out[q] = s;
  }
}

// K2: the hand reverse chain of K1 per row tile (math of
// ops/pallas_mlp.py _normed_bwd_math). Writes ct_y, ct_k1, per-block
// (ct_t, ct_dt) partials, and the rows of the weight-cotangent
// contractions: cp2 (6B x D), he (6B x (H+2)) = [h, t_i, 1],
// cp1 (6B x H), ye (6B x (D+2)) = [y_i, t_i, 1]; row = stage*B + batch row.
__global__ void __launch_bounds__(kThreads)
normed_bwd_kernel(const float* __restrict__ t_p, const float* __restrict__ dt_p,
                  const float* __restrict__ y, const float* __restrict__ k1,
                  const float* __restrict__ W1, const float* __restrict__ b1,
                  const float* __restrict__ W2, const float* __restrict__ b2,
                  const float* __restrict__ ct_ynew,
                  const float* __restrict__ ct_k7,
                  const float* __restrict__ ct_scalars,
                  float* __restrict__ ct_y, float* __restrict__ ct_k1,
                  float* __restrict__ partials, float* __restrict__ cp2,
                  float* __restrict__ he, float* __restrict__ cp1,
                  float* __restrict__ ye, int B, int D, int H, float rtol,
                  float atol) {
  extern __shared__ float smem[];
  constexpr int R = kBwdRows;
  const int n = R * D;
  float* y_s = smem;
  float* ks = y_s + n;        // 7 x n
  float* cks = ks + 7 * n;    // 7 x n
  float* yi = cks + 7 * n;
  float* g6 = yi + n;         // stage-5 state, then d_ynew
  float* seed6 = g6 + n;
  float* cty = seed6 + n;
  float* accb = cty + n;
  float* hs = accb + n;       // 6 x R*H
  float* ctp1 = hs + 6 * R * H;
  float* red = ctp1 + R * H;

  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);
  const float t = *t_p, dt = *dt_p;
  const float c_err = ct_scalars[0], c_num = ct_scalars[1], c_den = ct_scalars[2];
  recompute_stages<R>(y, k1, row0, rows, t, dt, y_s, ks, yi, g6, nullptr, hs,
                      W1, b1, W2, b2, D, H);

  float part[2] = {0.0f, 0.0f};  // ct_t, ct_dt
  // ---- seeds from the scalar norm cotangents ----
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const bool valid = idx < rows * D;
    const float k0 = ks[idx];
    float s_comb = kBt[1] * (ks[n + idx] - k0);
    for (int j = 2; j <= 6; ++j) s_comb += kBt[j] * (ks[j * n + idx] - k0);
    const float err = dt * s_comb;
    const float yv = y_s[idx], yn = yi[idx];
    const float denom = atol + fmaxf(fabsf(yv), fabsf(yn)) * rtol;
    const float scaled = err / denom;
    const float cerr = c_err * 2.0f * scaled / denom;
    const float cdenom = c_err * (-2.0f) * scaled * scaled / denom;
    // all of the max subgradient goes to y on ties (pallas_mlp.py:1000-1002)
    const bool y_is_max = fabsf(yv) >= fabsf(yn);
    const float to_y = y_is_max ? cdenom * rtol * sign_of(yv) : 0.0f;
    const float to_ynew = y_is_max ? 0.0f : cdenom * rtol * sign_of(yn);
    const float d_k7 = c_num * 2.0f * (ks[6 * n + idx] - ks[5 * n + idx]);
    const float d_ynew = c_den * 2.0f * (yn - g6[idx]);
    const float cyn = valid ? ct_ynew[(size_t)row0 * D + idx] : 0.0f;
    const float ck7 = valid ? ct_k7[(size_t)row0 * D + idx] : 0.0f;
    for (int j = 0; j < 7; ++j) cks[j * n + idx] = kBt[j] * (dt * cerr);
    cks[6 * n + idx] = cks[6 * n + idx] + ck7 + d_k7;
    cks[5 * n + idx] = cks[5 * n + idx] - d_k7;
    seed6[idx] = cyn + d_ynew + to_ynew;
    g6[idx] = -d_ynew;
    cty[idx] = to_y;
    if (valid) part[1] += cerr * s_comb;
  }

  // ---- reverse over the stages ----
  for (int i = 6; i >= 1; --i) {
    const float ti = t + kC[i] * dt;
    const float* k_i = ks + i * n;
    float* cp2_s = cks + i * n;  // ct_pre2 overwrites ct_ks[i]
    const float* h_i = hs + (i - 1) * R * H;
    const size_t srow = (size_t)(i - 1) * B + row0;
    float ct_ti = 0.0f;
    __syncthreads();
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const float acc = stage_acc(i, ks, n, idx);
      accb[idx] = acc;
      const float kv = k_i[idx];
      const float cp = cp2_s[idx] * (1.0f - kv * kv);
      cp2_s[idx] = cp;
      if (idx < rows * D) {
        const int r = idx / D, d = idx - r * D;
        cp2[(srow + r) * D + d] = cp;
        ye[(srow + r) * (D + 2) + d] = y_s[idx] + dt * acc;
        ct_ti += cp * W2[(size_t)d * (H + 1) + H];
      }
    }
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      ye[(srow + r) * (D + 2) + D] = ti;
      ye[(srow + r) * (D + 2) + D + 1] = 1.0f;
      he[(srow + r) * (H + 2) + H] = ti;
      he[(srow + r) * (H + 2) + H + 1] = 1.0f;
    }
    __syncthreads();
    // ct_h = ct_pre2 W2h; ct_pre1 = ct_h (1 - h^2)
    {
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      for (int h = warp; h < H; h += kWarps) {
        float s[R];
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] = 0.0f;
        for (int d = lane; d < D; d += 32) {
          const float w = W2[(size_t)d * (H + 1) + h];
#pragma unroll
          for (int r = 0; r < R; ++r) s[r] += cp2_s[r * D + d] * w;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] = warp_sum(s[r]);
        if (lane == 0) {
          const float w1t = W1[(size_t)h * (D + 1) + D];
          for (int r = 0; r < R; ++r) {
            const float hv = h_i[r * H + h];
            const float c1 = s[r] * (1.0f - hv * hv);
            ctp1[r * H + h] = c1;
            if (r < rows) {
              cp1[(srow + r) * H + h] = c1;
              he[(srow + r) * (H + 2) + h] = hv;
              ct_ti += c1 * w1t;
            }
          }
        }
      }
    }
    __syncthreads();
    // ct_yi = seed_i + ct_pre1 W1x, then the lincomb transposes
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      float s = 0.0f;
      for (int h = 0; h < H; ++h) s += ctp1[r * H + h] * W1[(size_t)h * (D + 1) + d];
      float ct_yi = s;
      if (i == 6) ct_yi = seed6[idx] + s;
      if (i == 5) ct_yi = g6[idx] + s;
      cty[idx] += ct_yi;
      if (idx < rows * D) part[1] += ct_yi * accb[idx];
      for (int j = 0; j < i; ++j) {
        const float c = kA[i - 1][j];
        if (c != 0.0f) cks[j * n + idx] += (dt * c) * ct_yi;
      }
    }
    part[0] += ct_ti;
    part[1] += kC[i] * ct_ti;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    ct_y[(size_t)row0 * D + idx] = cty[idx];
    ct_k1[(size_t)row0 * D + idx] = cks[idx];
  }
  block_sum_to<2>(part, red, partials + 2 * blockIdx.x);
}

// C[m, n] = sum_k A[k * M + m] * Bm[k * N + n] summed over k in order,
// for m < M, n < N. Column n < N-1 goes to c_main (M x (N-1)), column
// N-1 to c_last (M). 32 x 32 output tile per block, 4 outputs a thread.
__global__ void __launch_bounds__(kThreads)
atb_split_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                 float* __restrict__ c_main, float* __restrict__ c_last,
                 int M, int N, int K) {
  __shared__ float As[kTile][kTile + 1];
  __shared__ float Bs[kTile][kTile + 1];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < K; k0 += kTile) {
    for (int kk = ty; kk < kTile; kk += kWarps) {
      const int k = k0 + kk;
      As[kk][tx] = (k < K && m0 + tx < M) ? A[(size_t)k * M + m0 + tx] : 0.0f;
      Bs[kk][tx] = (k < K && n0 + tx < N) ? Bm[(size_t)k * N + n0 + tx] : 0.0f;
    }
    __syncthreads();
    for (int kk = 0; kk < kTile; ++kk) {
      const float b = Bs[kk][tx];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += As[kk][ty + q * kWarps] * b;
    }
    __syncthreads();
  }
  const int n = n0 + tx;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = m0 + ty + q * kWarps;
    if (m >= M || n >= N) continue;
    if (n < N - 1) c_main[(size_t)m * (N - 1) + n] = acc[q];
    else c_last[m] = acc[q];
  }
}

size_t fwd_smem_bytes(int D, int H) {
  return sizeof(float) * ((size_t)10 * kFwdRows * D + (size_t)kFwdRows * H + 3 * kWarps);
}

size_t bwd_smem_bytes(int D, int H) {
  return sizeof(float) * ((size_t)20 * kBwdRows * D + (size_t)7 * kBwdRows * H + 2 * kWarps);
}

}  // namespace

extern "C" {

int regnde_fwd_rows() { return kFwdRows; }
int regnde_bwd_rows() { return kBwdRows; }

// K1. partials: (ceil(B/4), 3) scratch; sums: (3,) err_ssq, num_ssq, den_ssq.
int regnde_normed_fwd(const float* t, const float* dt, const float* y,
                      const float* k1, const float* W1, const float* b1,
                      const float* W2, const float* b2, float* y_new,
                      float* k7, float* partials, float* sums, int B, int D,
                      int H, float rtol, float atol, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = fwd_smem_bytes(D, H);
  cudaError_t e = cudaFuncSetAttribute(
      normed_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nblocks = (B + kFwdRows - 1) / kFwdRows;
  normed_fwd_kernel<<<nblocks, kThreads, smem, s>>>(
      t, dt, y, k1, W1, b1, W2, b2, y_new, k7, partials, B, D, H, rtol, atol);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials_kernel<<<1, 32, 0, s>>>(partials, nblocks, 3, sums);
  return (int)cudaGetLastError();
}

// K2. ct_scalars: (3,) cotangents of the three sums. ct_tdt: (2,) ct_t,
// ct_dt. Weight cotangents in nn.Linear layout: cW1 (H, D+1), cb1 (H),
// cW2 (D, H+1), cb2 (D). Scratch: partials (ceil(B/2), 2), cp2 (6B, D),
// he (6B, H+2), cp1 (6B, H), ye (6B, D+2).
int regnde_normed_bwd(const float* t, const float* dt, const float* y,
                      const float* k1, const float* W1, const float* b1,
                      const float* W2, const float* b2, const float* ct_ynew,
                      const float* ct_k7, const float* ct_scalars, float* ct_y,
                      float* ct_k1, float* cW1, float* cb1, float* cW2,
                      float* cb2, float* ct_tdt, float* partials, float* cp2,
                      float* he, float* cp1, float* ye, int B, int D, int H,
                      float rtol, float atol, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_smem_bytes(D, H);
  cudaError_t e = cudaFuncSetAttribute(
      normed_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nblocks = (B + kBwdRows - 1) / kBwdRows;
  normed_bwd_kernel<<<nblocks, kThreads, smem, s>>>(
      t, dt, y, k1, W1, b1, W2, b2, ct_ynew, ct_k7, ct_scalars, ct_y, ct_k1,
      partials, cp2, he, cp1, ye, B, D, H, rtol, atol);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials_kernel<<<1, 32, 0, s>>>(partials, nblocks, 2, ct_tdt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int K = 6 * B;
  // cW2 | cb2 = cp2^T [h, t_i, 1]
  dim3 g2((H + 2 + kTile - 1) / kTile, (D + kTile - 1) / kTile);
  atb_split_kernel<<<g2, kThreads, 0, s>>>(cp2, he, cW2, cb2, D, H + 2, K);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // cW1 | cb1 = cp1^T [y_i, t_i, 1]
  dim3 g1((D + 2 + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  atb_split_kernel<<<g1, kThreads, 0, s>>>(cp1, ye, cW1, cb1, H, D + 2, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
