// The tile body of the SDE whole solve (sde_whole_solve.cu, K9/K10) for an
// MLP drift and an MLP diffusion (models.MLP: tanh between layers, the last
// layer linear, no time input; the MNIST Neural SDE's 32 -> 64 -> 32 drift
// and 32 -> 32 diffusion): the networks' evaluation on a row tile and its
// pullback. The SRI algebra around it is generic over the body (a template
// parameter of the kernels), so another drift/diffusion pair is another
// body.
//
// A tile is kSdeRows rows of the batch, run by one block of kThreads. The
// leaves of both networks live in shared memory for the whole solve
// (MlpPair::load), each weight row padded to an odd stride so that neither
// the products over inputs (threads over outputs) nor those over outputs
// (threads over inputs) have bank conflicts. Each affine map is summed in
// f64 and rounded once to f32, as the plain version's f64 addmm
// (ops/sde_whole_solve.py _affine); tanh is the accurate tanhf.

#pragma once

#include "altmlp_tsit5.cuh"

namespace {

constexpr int kSdeRows = 4;        // rows of the batch per tile
constexpr int kMaxNetLayers = 4;   // layers per network

// One network: L layers, widths w[0] (= D) -> w[1] -> ... -> w[L] (= D),
// leaves p = (W_0, b_0, W_1, b_1, ...) in nn.Linear layout.
struct MlpNet {
  int L;
  int w[kMaxNetLayers + 1];
  const float* p[2 * kMaxNetLayers];
};

__host__ __device__ inline int net_padded_floats(const MlpNet& n) {
  int s = 0;
  for (int l = 0; l < n.L; ++l) s += n.w[l + 1] * (n.w[l] + 1) + n.w[l + 1];
  return s;
}

__host__ __device__ inline int net_leaf_floats(const MlpNet& n) {
  int s = 0;
  for (int l = 0; l < n.L; ++l) s += n.w[l + 1] * n.w[l] + n.w[l + 1];
  return s;
}

// Floats of one row's hidden activations (the outputs of layers 0..L-2).
__host__ __device__ inline int net_hidden_floats(const MlpNet& n) {
  int s = 0;
  for (int l = 0; l + 1 < n.L; ++l) s += n.w[l + 1];
  return s;
}

__host__ __device__ inline int net_max_width(const MlpNet& n) {
  int m = 0;
  for (int l = 0; l <= n.L; ++l) m = n.w[l] > m ? n.w[l] : m;
  return m;
}

// out[r, o] = act(b[o] + sum_k x[r, k] W[o, k]) for the tile's rows, the
// sum in f64 rounded once; W padded (n_out x (n_in + 1)), then b. Ends
// synchronised.
__device__ void dense_rows(const float* x, int n_in, const float* W, int n_out,
                           float* out, bool act) {
  const float* b = W + n_out * (n_in + 1);
  for (int idx = threadIdx.x; idx < kSdeRows * n_out; idx += kThreads) {
    const int r = idx / n_out, o = idx - r * n_out;
    const float* a = x + r * n_in;
    const float* w = W + o * (n_in + 1);
    double s = (double)b[o];
    for (int k = 0; k < n_in; ++k) s = fma((double)a[k], (double)w[k], s);
    const float h = (float)s;
    out[idx] = act ? tanhf(h) : h;
  }
  __syncthreads();
}

__device__ void net_load(const MlpNet& n, float* wsm) {
  int off = 0;
  for (int l = 0; l < n.L; ++l) {
    const int n_in = n.w[l], n_out = n.w[l + 1];
    const float* W = n.p[2 * l];
    const float* b = n.p[2 * l + 1];
    for (int idx = threadIdx.x; idx < n_out * n_in; idx += kThreads) {
      const int o = idx / n_in, k = idx - o * n_in;
      wsm[off + o * (n_in + 1) + k] = W[idx];
    }
    for (int o = threadIdx.x; o < n_out; o += kThreads) wsm[off + n_out * (n_in + 1) + o] = b[o];
    off += n_out * (n_in + 1) + n_out;
  }
}

// The network on the tile's rows x (kSdeRows x w[0]) into out (kSdeRows x
// w[L]). With acts, the hidden activations are kept there (layer l's
// output at acts + kSdeRows * (w[1] + ... + w[l])); without, bufa and bufb
// (kSdeRows x max width each) ping-pong. x must be synchronised on entry;
// ends synchronised.
__device__ void net_eval(const MlpNet& n, const float* wsm, const float* x, float* out,
                         float* acts, float* bufa, float* bufb) {
  const float* cur = x;
  int off = 0, aoff = 0;
  for (int l = 0; l < n.L; ++l) {
    const bool last = l == n.L - 1;
    float* nxt = last ? out : (acts ? acts + aoff : (cur == bufa ? bufb : bufa));
    dense_rows(cur, n.w[l], wsm + off, n.w[l + 1], nxt, !last);
    cur = nxt;
    off += n.w[l + 1] * (n.w[l] + 1) + n.w[l + 1];
    aoff += kSdeRows * n.w[l + 1];
  }
}

// Pullback of net_eval from its input x and hidden activations acts, for
// the output's cotangent c_out (read only): the input's cotangent to c_x,
// the leaves' cotangents added to cw (nn.Linear layout, leaves in order,
// each element owned by one thread). bufa, bufb: kSdeRows x max width
// each. Rows whose c_out is zero add nothing. Ends synchronised.
__device__ void net_pullback(const MlpNet& n, const float* wsm, float* cw, const float* x,
                             const float* acts, const float* c_out, float* c_x, float* bufa,
                             float* bufb) {
  constexpr int R = kSdeRows;
  int woff = net_padded_floats(n), coff = net_leaf_floats(n), aoff = R * net_hidden_floats(n);
  float* g = const_cast<float*>(c_out);  // written only for hidden layers (buffers)
  for (int l = n.L - 1; l >= 0; --l) {
    const int n_in = n.w[l], n_out = n.w[l + 1];
    woff -= n_out * (n_in + 1) + n_out;
    coff -= n_out * n_in + n_out;
    if (l < n.L - 1) {
      // g is the cotangent of tanh's output: pull it through tanh in place
      const float* h = acts + aoff;
      for (int idx = threadIdx.x; idx < R * n_out; idx += kThreads)
        g[idx] = g[idx] * (1.0f - h[idx] * h[idx]);
      __syncthreads();
    }
    const float* h_in = l == 0 ? x : acts + aoff - R * n_in;
    aoff -= R * n_in;
    float* cW = cw + coff;
    for (int e = threadIdx.x; e < n_out * n_in; e += kThreads) {
      const int o = e / n_in, k = e - o * n_in;
      float s = cW[e];
#pragma unroll
      for (int r = 0; r < R; ++r) s = fmaf(g[r * n_out + o], h_in[r * n_in + k], s);
      cW[e] = s;
    }
    for (int o = threadIdx.x; o < n_out; o += kThreads) {
      float s = cW[n_out * n_in + o];
#pragma unroll
      for (int r = 0; r < R; ++r) s += g[r * n_out + o];
      cW[n_out * n_in + o] = s;
    }
    float* nxt = l == 0 ? c_x : (g == bufa ? bufb : bufa);
    const float* Wl = wsm + woff;
    for (int idx = threadIdx.x; idx < R * n_in; idx += kThreads) {
      const int r = idx / n_in, k = idx - r * n_in;
      const float* gr = g + r * n_out;
      float s = 0.0f;
      for (int o = 0; o < n_out; ++o) s = fmaf(gr[o], Wl[o * (n_in + 1) + k], s);
      nxt[idx] = s;
    }
    __syncthreads();
    g = nxt;
  }
}

// The MNIST Neural SDE's body: network 0 is the drift, network 1 the
// diffusion. Shared memory: the padded leaves of both, then (backward)
// their cotangents, unpadded.
struct MlpPair {
  MlpNet net[2];

  __host__ __device__ int padded_floats() const {
    return net_padded_floats(net[0]) + net_padded_floats(net[1]);
  }
  __host__ __device__ int leaf_floats() const {
    return net_leaf_floats(net[0]) + net_leaf_floats(net[1]);
  }
  // floats of one stage's hidden activations of network k for the tile
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
  __device__ void eval(int k, const float* wsm, const float* x, float* out, float* acts,
                       float* bufa, float* bufb) const {
    net_eval(net[k], wsm + (k ? net_padded_floats(net[0]) : 0), x, out, acts, bufa, bufb);
  }
  __device__ void pullback(int k, const float* wsm, float* cw, const float* x,
                           const float* acts, const float* c_out, float* c_x, float* bufa,
                           float* bufb) const {
    net_pullback(net[k], wsm + (k ? net_padded_floats(net[0]) : 0),
                 cw + (k ? net_leaf_floats(net[0]) : 0), x, acts, c_out, c_x, bufa, bufb);
  }
};

}  // namespace
