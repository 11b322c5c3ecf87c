// The whole adaptive Tsit5 solve of MLPDynamics on Hopper: one persistent
// cooperative kernel for the forward (K3) and one for the reverse walk (K4).
//
// Replaces the TPU kernels
//   K3: regneuralde_tpu/ops/pallas_solve.py  make_whole_solve.make_fwd_kernel
//   K4: regneuralde_tpu/ops/pallas_solve.py  make_whole_solve.make_bwd_kernel
//   K5: regneuralde_tpu/ops/pallas_solve.py  make_whole_solve_tiled.make_fwd_kernel
//   K6: regneuralde_tpu/ops/pallas_solve.py  make_whole_solve_tiled.make_bwd_kernel
// The TPU has two engines because its monolithic one keeps the whole
// batch's stage stacks in VMEM and the tiled one does not. Here the batch
// is always tiled across blocks, so one pair serves fused=True, "solve"
// and "tiled".
//
// What bounds it on this card. Each trial step is K1's (forward) or K2's
// (backward) work, latency-bound (see normed_tsit5.cu), plus one
// grid-wide decision: the accept flag and the next dt hang on three norm
// sums over the whole batch. What the solve saves against one launch per
// trial step is the host: no launch, no flag read back, no scalar chain on
// the host between trial steps.
//
// What the design does about it.
//   * Each block owns the same row tiles (tile = blockIdx.x + k*gridDim.x)
//     for the whole solve and runs K1's/K2's per-tile body on them. The
//     carry lives in global memory, in the history itself: hy[i], hf[i] is
//     the state at the start of trial step i, the tile body writes its
//     y_new, k7 into hy[i+1], hf[i+1], and a rejected step copies row i
//     over them. Only a tile's owner touches its rows.
//   * Per trial step each tile writes its partial sums to a per-tile slot,
//     then grid.sync(). Every block then sums the slots in tile order (one
//     warp, lane-strided, shuffle tree) and runs the controller in one
//     thread, redundantly: every block takes the same decision with no
//     second barrier. The slots are double-buffered by step parity, so a
//     fast block's step i+1 never overwrites slots a slow block still reads.
//   * The backward reads the stored accept flags and norm sums, and pulls
//     cotangents back through the scalar chain with post_bwd, the hand
//     pullback of ops/ode.py post_bwd. Each trial step's weight-cotangent
//     rows are stored (about 22 MB a step at 512x784x100) and summed after
//     the walk by one fixed-order contraction over all 6*B*ns rows.
// No floating-point atomics, no TF32, no fast math: runs are bitwise
// reproducible. powf is the libdevice powf, as ATen's float pow.

#include <cooperative_groups.h>

#include "normed_tsit5.cuh"

namespace cg = cooperative_groups;

namespace {

// Rows of the (11, S) stream buffer (ops/whole_solve.py).
enum { ST_T, ST_DT, ST_QOLD, ST_E, ST_N, ST_D, ST_ACC, TEL_T, TEL_DT,
       TEL_EEST, TEL_EIGEN };

constexpr float kEestFloor = 1e-10f;  // ops/controller.py _EEST_FLOOR

struct Ctrl {
  float beta1, beta2, qmin, qmax, gamma, qoldinit, qsteady_max;
};

struct Post {
  float t_new, dt_next, qold_next, t_end, eest, eigen;
  bool accept;
};

// The scalar chain of one trial step (ops/ode.py _post).
__device__ Post post_fwd(const Ctrl& c, float count, float t, float dt_eff,
                         float qold, float e, float n, float d, float t1,
                         float span, bool is_last) {
  Post p;
  p.eest = e > 0.0f ? sqrtf(e / count) : 0.0f;
  const float num = n > 0.0f ? sqrtf(n) : 0.0f;
  const float den = d > 0.0f ? sqrtf(d) : 0.0f;
  p.eigen = den > 0.0f ? num / fmaxf(den, 1e-30f) : 0.0f;
  p.accept = p.eest <= 1.0f;
  const float q11 = powf(fmaxf(p.eest, kEestFloor), c.beta1);
  const float q = q11 / powf(qold, c.beta2);
  float qa = fminf(fmaxf(q / c.gamma, 1.0f / c.qmax), 1.0f / c.qmin);
  if (c.qsteady_max > 1.0f && qa >= 1.0f && qa <= c.qsteady_max) qa = 1.0f;
  const float dt0 = p.accept ? dt_eff / qa
                             : dt_eff / fminf(1.0f / c.qmin, q11 / c.gamma);
  p.qold_next = p.accept ? fmaxf(p.eest, c.qoldinit) : qold;
  p.dt_next = sign_of(dt0) * fminf(fabsf(dt0), span);
  p.t_end = is_last ? t1 : t + dt_eff;
  p.t_new = p.accept ? p.t_end : t;
  return p;
}

// Autograd's pullbacks of maximum(a, b) / minimum(a, b) to a: all of g
// where a wins, half of it on a tie.
__device__ __forceinline__ float max_grad(float a, float b, float g) {
  return a > b ? g : (a == b ? g / 2.0f : 0.0f);
}
__device__ __forceinline__ float min_grad(float a, float b, float g) {
  return a < b ? g : (a == b ? g / 2.0f : 0.0f);
}

struct PostGrads {
  float t, dt_eff, qold, e, n, d, t1, span;
};

// Hand pullback of post_fwd, the algebra of ops/ode.py post_bwd line by
// line. c_* are the cotangents of (t_new, dt_next, qold_next, t_end, eest,
// eigen); accept is the stored flag.
__device__ PostGrads post_bwd(const Ctrl& c, float count, float t, float dt_eff,
                              float qold, float e, float n, float d, float t1,
                              float span, bool is_last, bool accept,
                              float c_tnew, float c_dtn, float c_qn,
                              float c_tend, float c_eest, float c_eig) {
  const bool pe = e > 0.0f, pn = n > 0.0f, pd = d > 0.0f;
  const float eest = pe ? sqrtf(e / count) : 0.0f;
  const float num = pn ? sqrtf(n) : 0.0f;
  const float den = pd ? sqrtf(d) : 0.0f;
  const float tiny = 1e-30f;
  const float mden = fmaxf(den, tiny);
  const float es = fmaxf(eest, kEestFloor);
  const float q11 = powf(es, c.beta1);
  const float qb = powf(qold, c.beta2);
  const float q = q11 / qb;
  const float qg = q / c.gamma;
  const float lo = 1.0f / c.qmax, hi = 1.0f / c.qmin;
  const float mx = fmaxf(qg, lo);
  const float qa0 = fminf(mx, hi);
  const bool in_band = c.qsteady_max > 1.0f && qa0 >= 1.0f && qa0 <= c.qsteady_max;
  const float qa = in_band ? 1.0f : qa0;
  const float r = q11 / c.gamma;
  const float q_rej = fminf(hi, r);
  const float dt0 = accept ? dt_eff / qa : dt_eff / q_rej;
  const float s = sign_of(dt0);
  const float a = fabsf(dt0);

  PostGrads g;
  // t_new = where(accept, t_end, t); t_end = where(is_last, t1, t + dt_eff)
  const float g_tend = c_tend + (accept ? c_tnew : 0.0f);
  g.t = accept ? 0.0f : c_tnew;
  g.t1 = is_last ? g_tend : 0.0f;
  const float g_lin = is_last ? 0.0f : g_tend;
  g.t = g.t + g_lin;
  g.dt_eff = g_lin;
  // dt_next = sign(dt0) * minimum(|dt0|, span)
  const float g_m = c_dtn * s;
  const float g_dt0 = min_grad(a, span, g_m) * s;
  g.span = min_grad(span, a, g_m);
  // qold_next = where(accept, maximum(eest, qoldinit), qold)
  g.qold = accept ? 0.0f : c_qn;
  float g_eest = c_eest + max_grad(eest, c.qoldinit, accept ? c_qn : 0.0f);
  // dt0 = where(accept, dt_eff / qa, dt_eff / q_rej)
  const float g_acc = accept ? g_dt0 : 0.0f;
  const float g_rej = accept ? 0.0f : g_dt0;
  g.dt_eff = g.dt_eff + g_acc / qa + g_rej / q_rej;
  const float g_qa = -g_acc * ((dt_eff / qa) / qa);
  const float g_qrej = -g_rej * ((dt_eff / q_rej) / q_rej);
  float g_q11 = min_grad(r, hi, g_qrej) / c.gamma;
  const float g_qa0 = in_band ? 0.0f : g_qa;
  const float g_q = max_grad(qg, lo, min_grad(mx, hi, g_qa0)) / c.gamma;
  g_q11 = g_q11 + g_q / qb;
  const float g_qb = -g_q * ((q11 / qb) / qb);
  g.qold = g.qold + g_qb * (c.beta2 * powf(qold, c.beta2 - 1.0f));
  const float g_es = g_q11 * (c.beta1 * powf(es, c.beta1 - 1.0f));
  g_eest = g_eest + max_grad(eest, kEestFloor, g_es);
  // eigen = where(den > 0, num / maximum(den, 1e-30), 0)
  const float g_ratio = den > 0.0f ? c_eig : 0.0f;
  const float g_num = g_ratio / mden;
  const float g_den = den > 0.0f
      ? max_grad(den, tiny, -g_ratio * ((num / mden) / mden)) : 0.0f;
  g.e = pe ? (g_eest / (2.0f * eest)) / count : 0.0f;
  g.n = pn ? g_num / (2.0f * num) : 0.0f;
  g.d = pd ? g_den / (2.0f * den) : 0.0f;
  return g;
}

// Sums q quantities over the per-tile slots part[tile * nq + q] in tile
// order (lanes strided over tiles, then a shuffle tree); call from warp 0,
// every lane gets the sums.
template <int NQ>
__device__ void sum_tiles(const float* part, int ntiles, float (&out)[NQ]) {
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    float s = 0.0f;
    for (int k = threadIdx.x; k < ntiles; k += 32) s += __ldcg(part + k * NQ + q);
    out[q] = warp_sum(s);
  }
}

// Copies rows [row0, row0 + rows) of src to dst (B x D row-major).
__device__ void copy_rows(const float* src, float* dst, int row0, int rows,
                          int D) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const size_t g = (size_t)row0 * D + idx;
    dst[g] = __ldcg(src + g);
  }
}

struct FwdArgs {
  const float* scalars;  // t0, t1, dt0
  const float* y0;
  const float* f0;
  const float* W1;
  const float* b1;
  const float* W2;
  const float* b2;
  float* y1;
  float* hy;  // (S+1, B, D)
  float* hf;
  float* streams;  // (11, S), zero on entry
  float* final_;   // t, dt, qold, naccept, nreject, done
  float* partials;  // (2, ntiles, 3)
  int B, D, H, S;
  float rtol, atol;
  Ctrl ctrl;
};

// K3: the whole forward solve.
__global__ void __launch_bounds__(kThreads) whole_solve_fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  __shared__ float s_t, s_dt, s_qold;
  __shared__ int s_na, s_nr, s_done, s_acc;
  cg::grid_group grid = cg::this_grid();
  constexpr int R = kFwdRows;
  const int ntiles = (a.B + R - 1) / R;
  const size_t BD = (size_t)a.B * a.D;
  const float t0 = a.scalars[0], t1 = a.scalars[1];
  const float tdir = sign_of(t1 - t0), span = fabsf(t1 - t0);
  const float count = (float)BD;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * R, rows = min(R, a.B - row0);
    copy_rows(a.y0, a.hy, row0, rows, a.D);
    copy_rows(a.f0, a.hf, row0, rows, a.D);
  }
  if (threadIdx.x == 0) {
    s_t = t0;
    s_dt = a.scalars[2];
    s_qold = a.ctrl.qoldinit;
    s_na = s_nr = 0;
    s_done = span == 0.0f;
  }
  __syncthreads();

  int i = 0;
  for (; i < a.S && !s_done; ++i) {
    const float t = s_t, dt = s_dt;
    const float remaining = t1 - t;
    const bool is_last = (dt - remaining) * tdir >= 0.0f;
    const float dt_eff = is_last ? remaining : dt;
    float* part = a.partials + (size_t)(i & 1) * ntiles * 3;
    const float* yi = a.hy + (size_t)i * BD;
    const float* fi = a.hf + (size_t)i * BD;
    float* yn = a.hy + (size_t)(i + 1) * BD;
    float* kn = a.hf + (size_t)(i + 1) * BD;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int row0 = tile * R;
      normed_fwd_tile(yi, fi, row0, min(R, a.B - row0), t, dt_eff, a.W1, a.b1,
                      a.W2, a.b2, yn, kn, part + 3 * tile, a.D, a.H, a.rtol,
                      a.atol, smem);
    }
    grid.sync();
    if (threadIdx.x < 32) {
      float sums[3];
      sum_tiles<3>(part, ntiles, sums);
      if (threadIdx.x == 0) {
        const Post p = post_fwd(a.ctrl, count, t, dt_eff, s_qold, sums[0],
                                sums[1], sums[2], t1, span, is_last);
        if (blockIdx.x == 0) {
          float* st = a.streams;
          const int S = a.S;
          st[ST_T * S + i] = t;
          st[ST_DT * S + i] = dt;
          st[ST_QOLD * S + i] = s_qold;
          st[ST_E * S + i] = sums[0];
          st[ST_N * S + i] = sums[1];
          st[ST_D * S + i] = sums[2];
          st[ST_ACC * S + i] = p.accept ? 1.0f : 0.0f;
          st[TEL_T * S + i] = p.t_end;
          st[TEL_DT * S + i] = dt_eff;
          st[TEL_EEST * S + i] = p.eest;
          st[TEL_EIGEN * S + i] = p.eigen;
        }
        s_acc = p.accept;
        s_t = p.t_new;
        s_dt = p.dt_next;
        s_qold = p.qold_next;
        if (p.accept) ++s_na; else ++s_nr;
        s_done = p.accept && is_last;
      }
    }
    __syncthreads();
    if (!s_acc) {  // a rejected step keeps its start state
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int row0 = tile * R, rows = min(R, a.B - row0);
        copy_rows(yi, yn, row0, rows, a.D);
        copy_rows(fi, kn, row0, rows, a.D);
      }
    }
    __syncthreads();
  }

  const float* y_end = a.hy + (size_t)i * BD;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * R;
    copy_rows(y_end, a.y1, row0, min(R, a.B - row0), a.D);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.final_[0] = s_t;
    a.final_[1] = s_dt;
    a.final_[2] = s_qold;
    a.final_[3] = (float)s_na;
    a.final_[4] = (float)s_nr;
    a.final_[5] = (float)s_done;
  }
}

struct BwdArgs {
  const float* scalars;  // t0, t1
  const float* streams;  // (11, S), the forward's
  const float* hy;
  const float* hf;
  const float* W1;
  const float* b1;
  const float* W2;
  const float* b2;
  const float* ct_tel;  // (4, S): t, dt, eest, eigen_est
  float* ct_y;  // in: ct_y1, out: ct_y0
  float* ct_f;  // in: 0, out: ct_f0
  float* ct_scalars;  // out: ct_t0, ct_t1, ct_dt0
  float* partials;  // (2, ntiles, 2)
  float* cp2;  // (6 B ns, D)
  float* he;   // (6 B ns, H + 2)
  float* cp1;  // (6 B ns, H)
  float* ye;   // (6 B ns, D + 2)
  int ns, B, D, H, S;
  float rtol, atol;
  Ctrl ctrl;
};

// K4: the reverse walk over the forward's ns trial steps.
__global__ void __launch_bounds__(kThreads) whole_solve_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  // running cotangents ct_t, ct_dt, ct_qold, of t1 and of span
  __shared__ float s_ct[5];
  __shared__ float s_ti, s_dteff;
  __shared__ int s_last, s_acc;
  __shared__ PostGrads s_g;
  cg::grid_group grid = cg::this_grid();
  constexpr int R = kBwdRows;
  const int ntiles = (a.B + R - 1) / R;
  const size_t BD = (size_t)a.B * a.D;
  const float t0 = a.scalars[0], t1 = a.scalars[1];
  const float tdir = sign_of(t1 - t0), span = fabsf(t1 - t0);
  const float count = (float)BD;
  const int S = a.S;
  if (threadIdx.x < 5) s_ct[threadIdx.x] = 0.0f;
  __syncthreads();

  for (int j = 0; j < a.ns; ++j) {
    const int i = a.ns - 1 - j;
    if (threadIdx.x == 0) {
      const float* st = a.streams;
      const float t_i = st[ST_T * S + i], dt_i = st[ST_DT * S + i];
      const float remaining = t1 - t_i;
      const bool is_last = (dt_i - remaining) * tdir >= 0.0f;
      const float dt_eff = is_last ? remaining : dt_i;
      const bool acc = st[ST_ACC * S + i] > 0.5f;
      s_g = post_bwd(a.ctrl, count, t_i, dt_eff, st[ST_QOLD * S + i],
                     st[ST_E * S + i], st[ST_N * S + i], st[ST_D * S + i], t1,
                     span, is_last, acc, s_ct[0], s_ct[1], s_ct[2],
                     a.ct_tel[0 * S + i], a.ct_tel[2 * S + i],
                     a.ct_tel[3 * S + i]);
      s_ti = t_i;
      s_dteff = dt_eff;
      s_last = is_last;
      s_acc = acc;
    }
    __syncthreads();
    const bool acc = s_acc;
    float* part = a.partials + (size_t)(j & 1) * ntiles * 2;
    const size_t base = (size_t)i * 6 * a.B;  // this step's weight rows
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int row0 = tile * R;
      // y_out = where(acc, y_new, y), f0_out likewise: route the carry
      normed_bwd_tile(a.hy + (size_t)i * BD, a.hf + (size_t)i * BD, row0,
                      min(R, a.B - row0), a.B, s_ti, s_dteff, a.W1, a.b1, a.W2,
                      a.b2, acc ? a.ct_y : nullptr, acc ? a.ct_f : nullptr,
                      acc ? nullptr : a.ct_y, acc ? nullptr : a.ct_f, s_g.e,
                      s_g.n, s_g.d, a.ct_y, a.ct_f, part + 2 * tile,
                      a.cp2 + base * a.D, a.he + base * (a.H + 2),
                      a.cp1 + base * a.H, a.ye + base * (a.D + 2), a.D, a.H,
                      a.rtol, a.atol, smem);
    }
    grid.sync();
    if (threadIdx.x < 32) {
      float k[2];  // the trial step's ct_t, ct_dt_eff
      sum_tiles<2>(part, ntiles, k);
      if (threadIdx.x == 0) {
        // dt_eff = where(is_last, t1 - t, dt)
        const float ct_dteff = s_g.dt_eff + k[1] + a.ct_tel[1 * S + i];
        s_ct[0] = s_g.t + k[0] + (s_last ? -ct_dteff : 0.0f);
        s_ct[1] = s_last ? 0.0f : ct_dteff;
        s_ct[2] = s_g.qold;
        s_ct[3] = s_ct[3] + s_g.t1 + (s_last ? ct_dteff : 0.0f);
        s_ct[4] = s_ct[4] + s_g.span;
      }
    }
    __syncthreads();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.ct_scalars[0] = s_ct[0] - tdir * s_ct[4];
    a.ct_scalars[1] = s_ct[3] + tdir * s_ct[4];
    a.ct_scalars[2] = s_ct[1];
  }
}

// Launches a cooperative kernel with one block per tile, at most as many
// blocks as fit on the card at once (grid.sync() needs them all resident).
cudaError_t launch_cooperative(const void* kernel, void* args, size_t smem,
                               int ntiles, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return e;
  if (!coop) return cudaErrorNotSupported;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int grid = min(per_sm * sms, ntiles);
  void* params[] = {args};
  e = cudaLaunchCooperativeKernel(kernel, grid, kThreads, params, smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K3. scalars: (3,) t0, t1, dt0. hy, hf: (S+1, B, D). streams: (11, S),
// zeroed by the caller. final: (6,). partials: (2, ceil(B/4), 3) scratch.
int regnde_whole_solve_fwd(const float* scalars, const float* y0,
                           const float* f0, const float* W1, const float* b1,
                           const float* W2, const float* b2, float* y1,
                           float* hy, float* hf, float* streams, float* final_,
                           float* partials, int B, int D, int H, int S,
                           float rtol, float atol, float beta1, float beta2,
                           float qmin, float qmax, float gamma, float qoldinit,
                           float qsteady_max, void* stream) {
  FwdArgs a{scalars, y0, f0, W1, b1, W2, b2, y1, hy, hf, streams, final_,
            partials, B, D, H, S, rtol, atol,
            Ctrl{beta1, beta2, qmin, qmax, gamma, qoldinit, qsteady_max}};
  return (int)launch_cooperative((const void*)whole_solve_fwd_kernel, &a,
                                 fwd_smem_bytes(D, H), (B + kFwdRows - 1) / kFwdRows,
                                 static_cast<cudaStream_t>(stream));
}

// K4, then the weight cotangents from its stored rows. scalars: (2,) t0,
// t1. ct_tel: (4, S). ct_y: ct_y1 in, ct_y0 out; ct_f: zeros in, ct_f0
// out. ct_scalars: (3,) ct_t0, ct_t1, ct_dt0 out. Weight cotangents in
// nn.Linear layout. Scratch: partials (2, ceil(B/2), 2), cp2 (6 B ns, D),
// he (6 B ns, H+2), cp1 (6 B ns, H), ye (6 B ns, D+2).
int regnde_whole_solve_bwd(const float* scalars, const float* streams,
                           const float* hy, const float* hf, const float* W1,
                           const float* b1, const float* W2, const float* b2,
                           const float* ct_tel, float* ct_y, float* ct_f,
                           float* cW1, float* cb1, float* cW2, float* cb2,
                           float* ct_scalars, float* partials, float* cp2,
                           float* he, float* cp1, float* ye, int ns, int B,
                           int D, int H, int S, float rtol, float atol,
                           float beta1, float beta2, float qmin, float qmax,
                           float gamma, float qoldinit, float qsteady_max,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdArgs a{scalars, streams, hy, hf, W1, b1, W2, b2, ct_tel, ct_y, ct_f,
            ct_scalars, partials, cp2, he, cp1, ye, ns, B, D, H, S, rtol, atol,
            Ctrl{beta1, beta2, qmin, qmax, gamma, qoldinit, qsteady_max}};
  cudaError_t e = launch_cooperative((const void*)whole_solve_bwd_kernel, &a,
                                     bwd_smem_bytes(D, H),
                                     (B + kBwdRows - 1) / kBwdRows, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_weight_cotangents(cp2, he, cp1, ye, cW1, cb1, cW2, cb2,
                                       6 * B * ns, D, H, s);
}

}  // extern "C"
