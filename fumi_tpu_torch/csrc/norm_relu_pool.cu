// conv4's batch-statistics norm, ReLU and 2x2 max-pool as one op, with its
// backward and double backward.
//
// Replaces no TPU kernel: the JAX package writes this chain out
// (fumi_tpu/models/conv4.py: batch_stat_norm, relu, maxpool2x2) and leaves
// it to XLA. The port wrote it out as a dozen tensor operations, each
// reading and writing a whole activation, and autograd's first and second
// backward of them were most of second-order MAML's card time through
// Conv-4-64. This file computes the same function on a (M, G, H, W) fp32
// tensor in channels_last memory, (M, H, W, G) in memory, G = B*64 task
// channels:
//   y = z + b;  mu, var = mean and variance of y over a channel's
//   N = M*H*W positions;  x = (y - mu) * rstd, rstd = 1 / sqrt(var + 1e-5);
//   a = gamma * x + beta;  h = relu(a);  out = 2x2 stride-2 VALID max of h
// (an odd last row or column is left out of the pool, not of the
// statistics). A tied window splits its gradient evenly among its ties, as
// torch's amax does, and relu'(0) = 0.
//
// Entry points (ops/kernels.py binds them with ctypes, and its plain
// PyTorch versions compute the same closed forms):
// - norm_relu_pool_forward_launch: the statistics, then the pooled output;
//   saves mu and rstd (stats, 2 x G floats);
// - norm_relu_pool_backward_launch: given g_out, the cotangent of the
//   pooled output, writes g_z, g_gamma, g_beta and g_b. ga, g_out routed
//   through the window's ties and masked by a > 0, gives
//     g_gamma = sum ga*x,  g_beta = sum ga,
//     g_z = gamma*rstd*(ga - sum(ga)/N - x*sum(ga*x)/N),
//   and g_b = 0: the output does not depend on b, which mu takes away;
// - norm_relu_pool_double_backward_launch: the backward of that backward,
//   given the cotangents (v_z, v_gamma, v_beta) of (g_z, g_gamma, g_beta),
//   the cotangents of z, gamma, g_out (and beta, b: zero). mu and rstd are
//   differentiated as the functions of z they are; the ReLU mask and the
//   pool's routing are piecewise constant. Per channel, with V = sum v_z,
//   VX = sum v_z*x, VG = sum v_z*ga, A = sum ga, S = sum ga*x, r = rstd:
//     c_gamma = r*(VG - A*V/N - S*VX/N),
//     c_z = ag*ga + av*v_z + ax*x + a0,
//     c_gout = sum over the window's routed positions of
//              (wv*v_z + wx*x + w0) / ties,
//   with the coefficients of grad2_finalize below.
//
// Bound on this card: bytes. Per element the op does a handful of flops,
// far below the H100's 20 flops a byte. With E = M*H*W*G elements of 4
// bytes and the pooled tensor a quarter of that, the least traffic is
// - forward: z read twice (the statistics must be complete before any
//   element is normalised), the output written: 2.25 * 4E bytes;
// - backward: z and g_out read for the two sums, again for g_z, g_z
//   written: 3.5 * 4E;
// - double backward: z, v_z and g_out read for the three sums, again for
//   the outputs, c_z and c_gout written: 5.75 * 4E.
// At conv4.train's largest call (M = 160 query images, G = 256 channels of
// 84 x 84, 1.16 GB) that is 0.78, 1.21 and 1.99 ms at 3.35 TB/s.
//
// What the design does about it:
// - Each pass reads only what it needs: nothing but z, the per-channel
//   (mu, rstd) and the parameters is saved, and x, a, the ReLU mask and
//   the pool's routing are recomputed from them, so no activation-sized
//   intermediate is ever written; every arithmetic step is an explicitly
//   rounded intrinsic, so every pass recomputes a, its mask and its ties
//   bit for bit as the forward had them.
// - A thread owns a vector of 4 channels (16-byte loads where G % 4 == 0
//   and the pointers are aligned) and walks 2x2 cells of the image, so a
//   warp reads 512 contiguous bytes a pixel and a thread has its window's
//   four pixels in flight at once.
// - Sums are deterministic: each thread sums in fp64 (shifted by the
//   channel's first value for the statistics), a block adds its threads in
//   a fixed order into one partial row, and a finalize kernel adds the
//   rows in a fixed order. No float atomics: two runs give the same bits,
//   and fp64 keeps the statistics of 10^6 positions at the two-pass
//   value's quality.
// - A pass is three launches: the sums, the finalize (a few microseconds,
//   which also turns the sums into per-channel coefficients), the
//   elementwise pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // threads of a block of the walks
constexpr int kMaxVecs = 64;       // channel vectors a block covers
constexpr int kFinalChans = 32;    // channels of a finalize block
constexpr int kFinalLanes = 8;     // lanes that share a finalize channel
constexpr float kEps = 1e-5f;

// The tensor's shape and the walk: a block covers TX channel vectors (of V
// channels each) and TY cells at a time; grid.x blocks walk the cells,
// grid.y covers the channels.
struct Geom {
  long long M;
  int G, H, W, H2, W2, CH, CW;  // CH, CW: cells (2x2, ragged at odd sides)
  int TX, TY;
  double n;  // positions of a channel, M*H*W
};

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// A thread's channel vector and its per-channel constants.
template <int V>
struct Chans {
  int c;      // first channel
  bool live;  // c < G
  float b[V], mu[V], rstd[V], g[V], be[V];
};

template <int V>
__device__ __forceinline__ Chans<V> chans(const Geom& q, const float* b,
                                          const float* gamma,
                                          const float* beta,
                                          const float* stats) {
  Chans<V> ch;
  const int tx = threadIdx.x % q.TX;
  ch.c = (blockIdx.y * q.TX + tx) * V;
  ch.live = ch.c < q.G;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = ch.live ? ch.c + v : 0;
    ch.b[v] = b[c];
    ch.g[v] = gamma ? gamma[c] : 0.f;
    ch.be[v] = beta ? beta[c] : 0.f;
    ch.mu[v] = stats ? stats[c] : 0.f;
    ch.rstd[v] = stats ? stats[q.G + c] : 0.f;
  }
  return ch;
}

// x of one element, rounded step by step as every pass rounds it
__device__ __forceinline__ float normed(float z, float b, float mu,
                                        float rstd) {
  return __fmul_rn(__fsub_rn(__fadd_rn(z, b), mu), rstd);
}

// Cell e of a walk over (M, rows, cols) cells (fewer than 2^31: 32-bit
// divisions).
__device__ __forceinline__ void cell_of(unsigned e, int rows, int cols,
                                        long long& m, int& ci, int& cj) {
  const unsigned t = e / (unsigned)cols;
  cj = (int)(e - t * (unsigned)cols);
  const unsigned u = t / (unsigned)rows;
  ci = (int)(t - u * (unsigned)rows);
  m = u;
}

// A cell's (up to) four elements of one channel vector: position k is row
// 2ci + k/2, column 2cj + k%2; ok[k] where it lies inside the image.
template <int V>
struct Cell {
  bool ok[4];
  long long off[4];
  float x[4][V], a[4][V];
};

template <int V>
__device__ __forceinline__ void load_cell(const Geom& q, const float* z,
                                          const Chans<V>& ch, long long m,
                                          int ci, int cj, Cell<V>& cl) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = 2 * ci + (k >> 1), j = 2 * cj + (k & 1);
    cl.ok[k] = i < q.H && j < q.W;
    cl.off[k] = ((m * q.H + i) * q.W + j) * q.G + ch.c;
  }
  float raw[4][V];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (cl.ok[k]) {
      load<V>(z + cl.off[k], raw[k]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) raw[k][v] = 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float x = normed(raw[k][v], ch.b[v], ch.mu[v], ch.rstd[v]);
      cl.x[k][v] = x;
      cl.a[k][v] = __fmaf_rn(ch.g[v], x, ch.be[v]);
    }
  }
}

// The window's routing for one channel: bit k set where element k takes
// the window's gradient (a tie of the max of relu(a), with a > 0); *ties
// is the number of ties of the max, relu-dead ones included, as amax
// counts them.
__device__ __forceinline__ void route(float a0, float a1, float a2,
                                      float a3, int* bits, float* ties) {
  const float h0 = fmaxf(a0, 0.f), h1 = fmaxf(a1, 0.f);
  const float h2 = fmaxf(a2, 0.f), h3 = fmaxf(a3, 0.f);
  const float top = fmaxf(fmaxf(h0, h1), fmaxf(h2, h3));
  const bool t0 = h0 == top, t1 = h1 == top, t2 = h2 == top, t3 = h3 == top;
  *ties = (float)((int)t0 + (int)t1 + (int)t2 + (int)t3);
  *bits = (t0 && a0 > 0.f) | ((t1 && a1 > 0.f) << 1) |
          ((t2 && a2 > 0.f) << 2) | ((t3 && a3 > 0.f) << 3);
}

// ga of a cell: the pooled gradient g routed through the window, or 0
// outside the pooled region (the odd last row or column).
template <int V>
__device__ __forceinline__ void routed(const Geom& q, const float* g_out,
                                       const Chans<V>& ch, long long m,
                                       int ci, int cj, const Cell<V>& cl,
                                       float (&ga)[4][V], int (&bits)[V],
                                       float (&ties)[V], float (&gw)[V],
                                       long long& woff) {
  const bool window = ci < q.H2 && cj < q.W2;
  woff = ((m * q.H2 + ci) * q.W2 + cj) * q.G + ch.c;
  if (window) {
    load<V>(g_out + woff, gw);
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    bits[v] = 0;
    ties[v] = 1.f;
    if (window) {
      route(cl.a[0][v], cl.a[1][v], cl.a[2][v], cl.a[3][v], &bits[v],
            &ties[v]);
    } else {
      gw[v] = 0.f;
    }
    const float share = __fdiv_rn(gw[v], ties[v]);
#pragma unroll
    for (int k = 0; k < 4; ++k) ga[k][v] = (bits[v] >> k) & 1 ? share : 0.f;
  }
}

// A block's sums into its partial row: the threads of one channel vector
// added in a fixed order. partial is (rows, K, G) doubles.
template <int K, int V>
__device__ __forceinline__ void block_partial(const Geom& q,
                                              const Chans<V>& ch,
                                              const double (&acc)[K][V],
                                              double* partial) {
  __shared__ double red[K * V * kThreads];
  const int n = q.TX * q.TY;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int v = 0; v < V; ++v) red[(k * V + v) * n + threadIdx.x] = acc[k][v];
  __syncthreads();
  if (threadIdx.x >= q.TX || !ch.live) return;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      double s = 0.0;
      for (int t = 0; t < q.TY; ++t) s += red[(k * V + v) * n + t * q.TX + threadIdx.x];
      partial[((long long)blockIdx.x * K + k) * q.G + ch.c + v] = s;
    }
  }
}

// A finalize block's sums of its channel over the partial rows, in a fixed
// order: lane l adds rows l, l + 8, ..., then lane 0 adds the lanes (all 0
// where partial is null). Returns false on the threads that hold no
// result.
template <int K>
__device__ __forceinline__ bool final_sums(const double* partial, int rows,
                                           int G, double (&s)[K], int& c) {
  __shared__ double red[K][kFinalLanes][kFinalChans];
  const int tx = threadIdx.x % kFinalChans, lane = threadIdx.x / kFinalChans;
  c = blockIdx.x * kFinalChans + tx;
  double acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;
  if (c < G && partial) {
    for (int r = lane; r < rows; r += kFinalLanes)
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] += partial[((long long)r * K + k) * G + c];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) red[k][lane][tx] = acc[k];
  __syncthreads();
  if (lane != 0 || c >= G) return false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    s[k] = 0.0;
    for (int l = 0; l < kFinalLanes; ++l) s[k] += red[k][l][tx];
  }
  return true;
}

// ---- forward ---------------------------------------------------------

// Sums of y - shift and (y - shift)^2 over every position, shift = the
// channel's y at position 0.
template <int V>
__global__ void __launch_bounds__(kThreads)
norm_relu_pool_stats_kernel(const float* __restrict__ z,
                            const float* __restrict__ b, Geom q,
                            double* __restrict__ partial) {
  const Chans<V> ch = chans<V>(q, b, nullptr, nullptr, nullptr);
  double acc[2][V] = {};
  if (ch.live) {
    float z0[V];
    load<V>(z + ch.c, z0);
    double shift[V];
#pragma unroll
    for (int v = 0; v < V; ++v) shift[v] = (double)__fadd_rn(z0[v], ch.b[v]);
    const unsigned cells = (unsigned)(q.M * q.CH * q.CW);
    const int ty = threadIdx.x / q.TX;
    for (unsigned e = blockIdx.x * q.TY + ty; e < cells;
         e += gridDim.x * q.TY) {
      long long m;
      int ci, cj;
      cell_of(e, q.CH, q.CW, m, ci, cj);
      float raw[4][V];
      bool ok[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 2 * ci + (k >> 1), j = 2 * cj + (k & 1);
        ok[k] = i < q.H && j < q.W;
        if (ok[k]) load<V>(z + ((m * q.H + i) * q.W + j) * q.G + ch.c, raw[k]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!ok[k]) continue;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const double d = (double)__fadd_rn(raw[k][v], ch.b[v]) - shift[v];
          acc[0][v] += d;
          acc[1][v] = fma(d, d, acc[1][v]);
        }
      }
    }
  }
  block_partial<2, V>(q, ch, acc, partial);
}

// mu and rstd of each channel: stats[c] = mu, stats[G + c] = rstd.
__global__ void __launch_bounds__(kFinalChans * kFinalLanes)
norm_relu_pool_stats_finalize_kernel(const double* __restrict__ partial,
                                     int rows, const float* __restrict__ z,
                                     const float* __restrict__ b, Geom q,
                                     float* __restrict__ stats) {
  double s[2];
  int c;
  if (!final_sums<2>(partial, rows, q.G, s, c)) return;
  const double mean = s[0] / q.n;
  const double var = fmax(s[1] / q.n - mean * mean, 0.0);
  stats[c] = (float)((double)__fadd_rn(z[c], b[c]) + mean);
  stats[q.G + c] = (float)(1.0 / sqrt(var + (double)kEps));
}

// The pooled output: the max of relu(a) over each 2x2 window.
template <int V>
__global__ void __launch_bounds__(kThreads)
norm_relu_pool_apply_kernel(const float* __restrict__ z,
                            const float* __restrict__ b,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta,
                            const float* __restrict__ stats, Geom q,
                            float* __restrict__ out) {
  const Chans<V> ch = chans<V>(q, b, gamma, beta, stats);
  if (!ch.live) return;
  const unsigned windows = (unsigned)(q.M * q.H2 * q.W2);
  const int ty = threadIdx.x / q.TX;
  for (unsigned e = blockIdx.x * q.TY + ty; e < windows;
       e += gridDim.x * q.TY) {
    long long m;
    int ci, cj;
    cell_of(e, q.H2, q.W2, m, ci, cj);
    Cell<V> cl;
    load_cell<V>(q, z, ch, m, ci, cj, cl);
    float o[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float h0 = fmaxf(cl.a[0][v], 0.f), h1 = fmaxf(cl.a[1][v], 0.f);
      const float h2 = fmaxf(cl.a[2][v], 0.f), h3 = fmaxf(cl.a[3][v], 0.f);
      o[v] = fmaxf(fmaxf(h0, h1), fmaxf(h2, h3));
    }
    store<V>(out + (long long)e * q.G + ch.c, o);
  }
}

// ---- backward --------------------------------------------------------

// sum ga and sum ga*x over the pooled windows (ga is 0 elsewhere).
template <int V>
__global__ void __launch_bounds__(kThreads)
norm_relu_pool_grad_sums_kernel(const float* __restrict__ z,
                                const float* __restrict__ b,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta,
                                const float* __restrict__ stats,
                                const float* __restrict__ g_out, Geom q,
                                double* __restrict__ partial) {
  const Chans<V> ch = chans<V>(q, b, gamma, beta, stats);
  double acc[2][V] = {};
  if (ch.live) {
    const unsigned windows = (unsigned)(q.M * q.H2 * q.W2);
    const int ty = threadIdx.x / q.TX;
    for (unsigned e = blockIdx.x * q.TY + ty; e < windows;
         e += gridDim.x * q.TY) {
      long long m, woff;
      int ci, cj;
      cell_of(e, q.H2, q.W2, m, ci, cj);
      Cell<V> cl;
      load_cell<V>(q, z, ch, m, ci, cj, cl);
      float ga[4][V], ties[V], gw[V];
      int bits[V];
      routed<V>(q, g_out, ch, m, ci, cj, cl, ga, bits, ties, gw, woff);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[0][v] += (double)ga[k][v];
          acc[1][v] = fma((double)ga[k][v], (double)cl.x[k][v], acc[1][v]);
        }
    }
  }
  block_partial<2, V>(q, ch, acc, partial);
}

// sums = (A, S) in fp64 for the double backward; coef = (gamma*r,
// -gamma*r*S/N, -gamma*r*A/N) for g_z; g_gamma = S, g_beta = A, g_b = 0.
__global__ void __launch_bounds__(kFinalChans * kFinalLanes)
norm_relu_pool_grad_finalize_kernel(const double* __restrict__ partial,
                                    int rows,
                                    const float* __restrict__ gamma,
                                    const float* __restrict__ stats, Geom q,
                                    double* __restrict__ sums,
                                    float* __restrict__ coef,
                                    float* __restrict__ g_gamma,
                                    float* __restrict__ g_beta,
                                    float* __restrict__ g_b) {
  double s[2];
  int c;
  if (!final_sums<2>(partial, rows, q.G, s, c)) return;
  const int G = q.G;
  const double A = s[0], S = s[1];
  const double gr = (double)gamma[c] * (double)stats[G + c];
  sums[c] = A;
  sums[G + c] = S;
  coef[c] = (float)gr;
  coef[G + c] = (float)(-gr * S / q.n);
  coef[2 * G + c] = (float)(-gr * A / q.n);
  g_gamma[c] = (float)S;
  g_beta[c] = (float)A;
  g_b[c] = 0.f;
}

// g_z = gamma*r*ga - gamma*r*S/N * x - gamma*r*A/N at every position.
template <int V>
__global__ void __launch_bounds__(kThreads)
norm_relu_pool_grad_kernel(const float* __restrict__ z,
                           const float* __restrict__ b,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           const float* __restrict__ stats,
                           const float* __restrict__ g_out,
                           const float* __restrict__ coef, Geom q,
                           float* __restrict__ g_z) {
  const Chans<V> ch = chans<V>(q, b, gamma, beta, stats);
  if (!ch.live) return;
  float k1[V], k2[V], k3[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    k1[v] = coef[ch.c + v];
    k2[v] = coef[q.G + ch.c + v];
    k3[v] = coef[2 * q.G + ch.c + v];
  }
  const unsigned cells = (unsigned)(q.M * q.CH * q.CW);
  const int ty = threadIdx.x / q.TX;
  for (unsigned e = blockIdx.x * q.TY + ty; e < cells;
       e += gridDim.x * q.TY) {
    long long m, woff;
    int ci, cj;
    cell_of(e, q.CH, q.CW, m, ci, cj);
    Cell<V> cl;
    load_cell<V>(q, z, ch, m, ci, cj, cl);
    float ga[4][V], ties[V], gw[V];
    int bits[V];
    routed<V>(q, g_out, ch, m, ci, cj, cl, ga, bits, ties, gw, woff);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!cl.ok[k]) continue;
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        o[v] = __fmaf_rn(k1[v], ga[k][v], __fmaf_rn(k2[v], cl.x[k][v], k3[v]));
      store<V>(g_z + cl.off[k], o);
    }
  }
}

// ---- double backward -------------------------------------------------

// V = sum v_z, VX = sum v_z*x, VG = sum v_z*ga over every position.
template <int V>
__global__ void __launch_bounds__(kThreads)
norm_relu_pool_grad2_sums_kernel(const float* __restrict__ z,
                                 const float* __restrict__ b,
                                 const float* __restrict__ gamma,
                                 const float* __restrict__ beta,
                                 const float* __restrict__ stats,
                                 const float* __restrict__ g_out,
                                 const float* __restrict__ v_z, Geom q,
                                 double* __restrict__ partial) {
  const Chans<V> ch = chans<V>(q, b, gamma, beta, stats);
  double acc[3][V] = {};
  if (ch.live) {
    const unsigned cells = (unsigned)(q.M * q.CH * q.CW);
    const int ty = threadIdx.x / q.TX;
    for (unsigned e = blockIdx.x * q.TY + ty; e < cells;
         e += gridDim.x * q.TY) {
      long long m, woff;
      int ci, cj;
      cell_of(e, q.CH, q.CW, m, ci, cj);
      Cell<V> cl;
      load_cell<V>(q, z, ch, m, ci, cj, cl);
      float ga[4][V], ties[V], gw[V], vz[4][V];
      int bits[V];
      routed<V>(q, g_out, ch, m, ci, cj, cl, ga, bits, ties, gw, woff);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (cl.ok[k]) {
          load<V>(v_z + cl.off[k], vz[k]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) vz[k][v] = 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const double w = (double)vz[k][v];
          acc[0][v] += w;
          acc[1][v] = fma(w, (double)cl.x[k][v], acc[1][v]);
          acc[2][v] = fma(w, (double)ga[k][v], acc[2][v]);
        }
    }
  }
  block_partial<3, V>(q, ch, acc, partial);
}

// The double backward's per-channel coefficients, coef = (ag, av, ax, a0,
// wv, wx, w0) x G, and c_gamma; c_beta = c_b = 0. v_z's sums come from
// partial (null v_z: all 0), v_gamma and v_beta may be null (0).
__global__ void __launch_bounds__(kFinalChans * kFinalLanes)
norm_relu_pool_grad2_finalize_kernel(const double* __restrict__ partial,
                                     int rows,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ stats,
                                     const double* __restrict__ sums,
                                     const float* __restrict__ v_gamma,
                                     const float* __restrict__ v_beta,
                                     Geom q, float* __restrict__ coef,
                                     float* __restrict__ c_gamma,
                                     float* __restrict__ c_beta,
                                     float* __restrict__ c_b) {
  double s[3];
  int c;
  if (!final_sums<3>(partial, rows, q.G, s, c)) return;
  const int G = q.G;
  const double n = q.n;
  const double Vs = s[0], VX = s[1], VG = s[2];
  const double A = sums[c], S = sums[G + c];
  const double r = (double)stats[G + c], g = (double)gamma[c], gr = g * r;
  const double vg = v_gamma ? (double)v_gamma[c] : 0.0;
  const double vb = v_beta ? (double)v_beta[c] : 0.0;
  // Phi = g*r*(VG - A*V/N - S*VX/N) + vg*S + vb*A; its derivative in x is
  // p = -(g*r/N)*(ga*VX + v_z*S) + vg*ga, in rstd (explicit) g*qq
  const double qq = VG - A * Vs / n - S * VX / n;
  const double mean_p = -gr * (A * VX + Vs * S) / (n * n) + vg * A / n;
  const double mean_px = -2.0 * gr * S * VX / (n * n) + vg * S / n;
  coef[c] = (float)(r * (vg - gr * VX / n));                  // ag
  coef[G + c] = (float)(-gr * r * S / n);                     // av
  coef[2 * G + c] = (float)(-r * mean_px - g * qq * r * r / n);  // ax
  coef[3 * G + c] = (float)(-r * mean_p);                     // a0
  coef[4 * G + c] = (float)gr;                                // wv
  coef[5 * G + c] = (float)(vg - gr * VX / n);                // wx
  coef[6 * G + c] = (float)(vb - gr * Vs / n);                // w0
  c_gamma[c] = (float)(r * qq);
  c_beta[c] = 0.f;
  c_b[c] = 0.f;
}

// c_z at every position and c_gout at every window.
template <int V>
__global__ void __launch_bounds__(kThreads)
norm_relu_pool_grad2_kernel(const float* __restrict__ z,
                            const float* __restrict__ b,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta,
                            const float* __restrict__ stats,
                            const float* __restrict__ g_out,
                            const float* __restrict__ v_z,
                            const float* __restrict__ coef, Geom q,
                            float* __restrict__ c_z,
                            float* __restrict__ c_gout) {
  const Chans<V> ch = chans<V>(q, b, gamma, beta, stats);
  if (!ch.live) return;
  float k[7][V];
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int v = 0; v < V; ++v) k[i][v] = coef[i * q.G + ch.c + v];
  const unsigned cells = (unsigned)(q.M * q.CH * q.CW);
  const int ty = threadIdx.x / q.TX;
  for (unsigned e = blockIdx.x * q.TY + ty; e < cells;
       e += gridDim.x * q.TY) {
    long long m, woff;
    int ci, cj;
    cell_of(e, q.CH, q.CW, m, ci, cj);
    Cell<V> cl;
    load_cell<V>(q, z, ch, m, ci, cj, cl);
    float ga[4][V], ties[V], gw[V], vz[4][V];
    int bits[V];
    routed<V>(q, g_out, ch, m, ci, cj, cl, ga, bits, ties, gw, woff);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (cl.ok[p] && v_z) {
        load<V>(v_z + cl.off[p], vz[p]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) vz[p][v] = 0.f;
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (!cl.ok[p]) continue;
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        o[v] = __fmaf_rn(k[0][v], ga[p][v],
                         __fmaf_rn(k[1][v], vz[p][v],
                                   __fmaf_rn(k[2][v], cl.x[p][v], k[3][v])));
      store<V>(c_z + cl.off[p], o);
    }
    if (ci < q.H2 && cj < q.W2) {
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float s = 0.f;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if ((bits[v] >> p) & 1)
            s = __fadd_rn(s, __fmaf_rn(k[4][v], vz[p][v],
                                       __fmaf_rn(k[5][v], cl.x[p][v], k[6][v])));
        }
        o[v] = __fdiv_rn(s, ties[v]);
      }
      store<V>(c_gout + woff, o);
    }
  }
}

// ---- launch ----------------------------------------------------------

// The walk's geometry for a launch; false where the arguments are bad.
bool make_geom(long long M, int G, int H, int W, int vec, int tx, int rows,
               Geom* q, dim3* grid_max) {
  if (M < 1 || G < 1 || H < 2 || W < 2 || (vec != 1 && vec != 4) ||
      G % vec != 0 || tx < 1 || tx > kMaxVecs || rows < 1 ||
      M * ((H + 1) / 2) * ((W + 1) / 2) >= (1LL << 31))
    return false;
  const int vecs = G / vec;
  if (tx != (vecs < kMaxVecs ? vecs : kMaxVecs)) return false;
  q->M = M;
  q->G = G;
  q->H = H;
  q->W = W;
  q->H2 = H / 2;
  q->W2 = W / 2;
  q->CH = (H + 1) / 2;
  q->CW = (W + 1) / 2;
  q->TX = tx;
  q->TY = kThreads / tx;
  q->n = (double)M * H * W;
  *grid_max = dim3(rows, (vecs + tx - 1) / tx);
  return true;
}

// Blocks along the cells for a walk over `units` cells: enough that each
// thread has a cell, at most the partial rows the caller allocated.
dim3 walk_grid(const Geom& q, dim3 grid_max, long long units) {
  long long need = (units + q.TY - 1) / q.TY;
  if (need < 1) need = 1;
  return dim3((unsigned)(need < grid_max.x ? need : grid_max.x), grid_max.y);
}

dim3 final_grid(const Geom& q) {
  return dim3((q.G + kFinalChans - 1) / kFinalChans);
}

inline bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// z (M, H, W, G), b, gamma, beta (G) -> out (M, H/2, W/2, G), stats (2, G).
// partial: rows * 3 * G doubles of scratch. vec 4 needs every tensor
// pointer 16-byte aligned; tx = min(G / vec, 64).
int norm_relu_pool_forward_launch(const float* z, const float* b,
                                  const float* gamma, const float* beta,
                                  float* out, float* stats, double* partial,
                                  long long M, int G, int H, int W, int vec,
                                  int tx, int rows, void* stream) {
  Geom q;
  dim3 gmax;
  if (!make_geom(M, G, H, W, vec, tx, rows, &q, &gmax) ||
      (vec == 4 && !(aligned(z) && aligned(out))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(q.TX * q.TY);
  const dim3 g1 = walk_grid(q, gmax, M * q.CH * q.CW);
  if (vec == 4)
    norm_relu_pool_stats_kernel<4><<<g1, block, 0, s>>>(z, b, q, partial);
  else
    norm_relu_pool_stats_kernel<1><<<g1, block, 0, s>>>(z, b, q, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  norm_relu_pool_stats_finalize_kernel<<<final_grid(q), kFinalChans * kFinalLanes,
                                         0, s>>>(partial, g1.x, z, b, q, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2 = walk_grid(q, gmax, M * q.H2 * q.W2);
  if (vec == 4)
    norm_relu_pool_apply_kernel<4><<<g2, block, 0, s>>>(z, b, gamma, beta,
                                                        stats, q, out);
  else
    norm_relu_pool_apply_kernel<1><<<g2, block, 0, s>>>(z, b, gamma, beta,
                                                        stats, q, out);
  return (int)cudaGetLastError();
}

// + g_out (M, H/2, W/2, G) -> g_z (M, H, W, G), g_gamma, g_beta, g_b (G);
// sums (2, G) doubles and coef (3, G) floats are kept for the double
// backward (sums) and used here (coef).
int norm_relu_pool_backward_launch(const float* z, const float* b,
                                   const float* gamma, const float* beta,
                                   const float* stats, const float* g_out,
                                   float* g_z, float* g_gamma, float* g_beta,
                                   float* g_b, double* sums, float* coef,
                                   double* partial, long long M, int G, int H,
                                   int W, int vec, int tx, int rows,
                                   void* stream) {
  Geom q;
  dim3 gmax;
  if (!make_geom(M, G, H, W, vec, tx, rows, &q, &gmax) ||
      (vec == 4 && !(aligned(z) && aligned(g_out) && aligned(g_z))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(q.TX * q.TY);
  const dim3 g1 = walk_grid(q, gmax, M * q.H2 * q.W2);
  if (vec == 4)
    norm_relu_pool_grad_sums_kernel<4><<<g1, block, 0, s>>>(
        z, b, gamma, beta, stats, g_out, q, partial);
  else
    norm_relu_pool_grad_sums_kernel<1><<<g1, block, 0, s>>>(
        z, b, gamma, beta, stats, g_out, q, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  norm_relu_pool_grad_finalize_kernel<<<final_grid(q), kFinalChans * kFinalLanes,
                                        0, s>>>(partial, g1.x, gamma, stats, q,
                                                sums, coef, g_gamma, g_beta,
                                                g_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2 = walk_grid(q, gmax, M * q.CH * q.CW);
  if (vec == 4)
    norm_relu_pool_grad_kernel<4><<<g2, block, 0, s>>>(
        z, b, gamma, beta, stats, g_out, coef, q, g_z);
  else
    norm_relu_pool_grad_kernel<1><<<g2, block, 0, s>>>(
        z, b, gamma, beta, stats, g_out, coef, q, g_z);
  return (int)cudaGetLastError();
}

// + the backward's sums and the cotangents v_z (M, H, W, G), v_gamma,
// v_beta (G), each may be null (zero) -> c_z, c_gout, c_gamma, c_beta, c_b.
// coef: 7 * G floats of scratch.
int norm_relu_pool_double_backward_launch(
    const float* z, const float* b, const float* gamma, const float* beta,
    const float* stats, const float* g_out, const double* sums,
    const float* v_z, const float* v_gamma, const float* v_beta, float* c_z,
    float* c_gout, float* c_gamma, float* c_beta, float* c_b, float* coef,
    double* partial, long long M, int G, int H, int W, int vec, int tx,
    int rows, void* stream) {
  Geom q;
  dim3 gmax;
  if (!make_geom(M, G, H, W, vec, tx, rows, &q, &gmax) ||
      (vec == 4 && !(aligned(z) && aligned(g_out) && aligned(v_z) &&
                     aligned(c_z) && aligned(c_gout))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(q.TX * q.TY);
  const dim3 g1 = walk_grid(q, gmax, M * q.CH * q.CW);
  cudaError_t err;
  if (v_z) {
    if (vec == 4)
      norm_relu_pool_grad2_sums_kernel<4><<<g1, block, 0, s>>>(
          z, b, gamma, beta, stats, g_out, v_z, q, partial);
    else
      norm_relu_pool_grad2_sums_kernel<1><<<g1, block, 0, s>>>(
          z, b, gamma, beta, stats, g_out, v_z, q, partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  norm_relu_pool_grad2_finalize_kernel<<<final_grid(q), kFinalChans * kFinalLanes,
                                         0, s>>>(v_z ? partial : nullptr, g1.x,
                                                 gamma, stats, sums, v_gamma,
                                                 v_beta, q, coef, c_gamma,
                                                 c_beta, c_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (vec == 4)
    norm_relu_pool_grad2_kernel<4><<<g1, block, 0, s>>>(
        z, b, gamma, beta, stats, g_out, v_z, coef, q, c_z, c_gout);
  else
    norm_relu_pool_grad2_kernel<1><<<g1, block, 0, s>>>(
        z, b, gamma, beta, stats, g_out, v_z, coef, q, c_z, c_gout);
  return (int)cudaGetLastError();
}

}  // extern "C"
