// The batch-statistics norm, ReLU or leaky ReLU and 2x2 max-pool of conv4's
// blocks and ResNet-12's units as one op, with its backward and double
// backward.
//
// Replaces no TPU kernel: the JAX package writes these chains out
// (fumi_tpu/models/conv4.py: batch_stat_norm, relu, maxpool2x2;
// fumi_tpu/models/resnet12.py: the same norm, leaky_relu, the residual add)
// and leaves them to XLA. The port wrote them out as a dozen tensor
// operations, each reading and writing a whole activation, and autograd's
// first and second backward of them were most of second-order MAML's card
// time through Conv-4-64 and ~40% of it through ResNet-12. This file
// computes, on (M, G, H, W) fp32 tensors in channels_last memory ((M, H, W,
// G) in memory, G = B*C task channels), for each of NB branches k:
//   y_k = z_k + b_k;  mu_k, var_k = mean and variance of y_k over a
//   channel's N = M*H*W positions;  x_k = (y_k - mu_k) * rstd_k,
//   rstd_k = 1 / sqrt(var_k + 1e-5);  a = sum over k of gamma_k*x_k + beta_k;
//   h = act(a);  out = h, or the 2x2 stride-2 VALID max of h,
// in one of three forms, each its own instance of the same templates
// <LEAKY, POOL, NB>:
// - conv4's block: act = relu, the pool, one branch;
// - ResNet-12's units c1 and c2: act = leaky relu (slope 0.1), no pool;
// - ResNet-12's unit c3 with the stage's 1x1 shortcut: two branches (their
//   normed sum, the residual add), leaky relu, the pool.
// An odd last row or column is left out of the pool, not of the statistics.
// A tied window splits its gradient evenly among its ties, as torch's amax
// does; relu'(a) = 0 and leaky'(a) = 0.1 for a <= 0, as torch's backwards
// take them. Leaky relu is increasing, so every tie of a window's max takes
// its share times its slope; relu's ties at 0 take none.
//
// Entry points (ops/kernels.py binds them with ctypes, and its plain
// PyTorch versions compute the same closed forms), each given the form:
// - norm_relu_pool_forward_launch: the statistics of every branch in one
//   pass, then the output; saves mu_k and rstd_k (stats, 2 x G floats each);
// - norm_relu_pool_backward_launch: given g_out, the cotangent of the
//   output, writes g_z_k, g_gamma_k, g_beta_k and g_b_k. ga, g_out routed
//   through the window's ties (at its own position without the pool) and
//   scaled by act'(a), is every branch's; per channel, A = sum ga and
//   S_k = sum ga*x_k give
//     g_gamma_k = S_k,  g_beta_k = A,
//     g_z_k = gamma_k*rstd_k*(ga - A/N - x_k*S_k/N),
//   and g_b_k = 0: the output does not depend on b_k, which mu_k takes away;
// - norm_relu_pool_double_backward_launch: the backward of that backward,
//   given the cotangents (v_z_k, v_gamma_k, v_beta_k) of (g_z_k, g_gamma_k,
//   g_beta_k), the cotangents of z_k, gamma_k, g_out (and beta_k, b_k:
//   zero). mu_k and rstd_k are differentiated as the functions of z_k they
//   are; act' and the pool's routing are piecewise constant in a, so the
//   branches meet only in ga and c_gout. Per branch and channel, with
//   V = sum v_z, VX = sum v_z*x, VG = sum v_z*ga, A, S, r = rstd:
//     c_gamma = r*(VG - A*V/N - S*VX/N),
//     c_z = ag*ga + av*v_z + ax*x + a0,
//   and c_gout = sum over the window's routed positions (its own position
//   without the pool) of act'(a) * sum over k of (wv*v_z + wx*x + w0)_k /
//   ties, with the coefficients of grad2_finalize below.
//
// Bound on this card: bytes. Per element the op does a handful of flops,
// far below the H100's 20 flops a byte. In units of one activation (E =
// M*H*W*G elements of 4 bytes), with f the output's share of it (1/4 with
// the pool, 1 without), the least traffic is
// - forward: every z_k read twice (the statistics must be complete before
//   any element is normalised), the output written: 2*NB + f;
// - backward: every z_k and g_out read for the sums, again for the g_z_k,
//   which are written: 3*NB + 2f;
// - double backward: every z_k, v_z_k and g_out read for the sums, again
//   for the outputs, c_z_k and c_gout written: 5*NB + 3f.
// conv4's block 2.25/3.5/5.75, ResNet-12's c1 and c2 3/5/8, c3 with the
// shortcut 4.25/6.5/10.75. At the largest calls of conv4.train and
// resnet12.train (M = 160 query images, G = 256 channels of 84 x 84, E =
// 1.16 GB) conv4's block takes 0.78, 1.21 and 1.99 ms at 3.35 TB/s,
// ResNet-12's c1 1.04, 1.73 and 2.76 ms, its c3 1.47, 2.24 and 3.71 ms.
//
// What the design does about it:
// - Each pass reads only what it needs: nothing but the z_k, the
//   per-channel (mu_k, rstd_k) and the parameters is saved, and x, a, act'
//   and the pool's routing are recomputed from them, so no activation-sized
//   intermediate is ever written (the written-out chain also stores the
//   normed branches, their sum, the activation and its mask); every
//   arithmetic step is an explicitly rounded intrinsic, so every pass
//   recomputes a, its slope and its ties bit for bit as the forward had them.
// - A thread owns a vector of 4 channels (16-byte loads where G % 4 == 0
//   and the pointers are aligned) and walks 2x2 cells of the image, so a
//   warp reads 512 contiguous bytes a pixel and a thread has its cell's
//   four pixels of every branch in flight at once.
// - Sums are deterministic: each thread sums in fp64 (shifted by the
//   channel's first value for the statistics), a block adds its threads in
//   a fixed order into one partial row, and a finalize kernel adds the rows
//   in a fixed order. No float atomics: two runs give the same bits, and
//   fp64 keeps the statistics of 10^6 positions at the two-pass value's
//   quality. Two branches share each pass: one walk takes both branches'
//   sums (A once), one elementwise pass writes both outputs.
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
constexpr float kLeak = 0.1f;      // ResNet-12's slope (models/resnet12.py)

// The tensor's shape and the walk: a block covers TX channel vectors (of V
// channels each) and TY cells at a time; grid.x blocks walk the cells,
// grid.y covers the channels.
struct Geom {
  long long M;
  int G, H, W, H2, W2, CH, CW;  // CH, CW: cells (2x2, ragged at odd sides)
  int TX, TY;
  double n;  // positions of a channel, M*H*W
};

// One branch's tensors, null where a pass takes none: its input and
// parameters; the forward's (mu, rstd), 2 x G; the backward's (A, S), 2 x G
// doubles; a finalize's per-channel coefficients; the double backward's
// cotangents; the pass's outputs (g_z, g_gamma, g_beta, g_b, or the
// cotangents c_ of the double backward).
struct Branch {
  const float *z, *b, *gamma, *beta;
  float* stats;
  double* sums;
  float* coef;
  const float *v_z, *v_gamma, *v_beta;
  float *d_z, *d_gamma, *d_beta, *d_b;
};

// A launch's tensors: NB branches, g_out (the backward's and double
// backward's), out (the forward's output, the double backward's c_gout),
// the partial rows of the sums.
template <int NB>
struct Args {
  Branch br[NB];
  const float* g_out;
  float* out;
  double* partial;
};

// Loads of the op's inputs, which no kernel writes: the read-only path.
template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(p);
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

// A thread's channel vector and each branch's per-channel constants.
template <int NB, int V>
struct Chans {
  int c;      // first channel
  bool live;  // c < G
  float b[NB][V], mu[NB][V], rstd[NB][V], g[NB][V], be[NB][V];
};

// normed: the parameters and statistics too (the statistics' own pass has
// no statistics yet).
template <int NB, int V>
__device__ __forceinline__ Chans<NB, V> chans(const Geom& q,
                                              const Args<NB>& p,
                                              bool normed) {
  Chans<NB, V> ch;
  const int tx = threadIdx.x % q.TX;
  ch.c = (blockIdx.y * q.TX + tx) * V;
  ch.live = ch.c < q.G;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const Branch& br = p.br[k];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = ch.live ? ch.c + v : 0;
      ch.b[k][v] = __ldg(br.b + c);
      ch.g[k][v] = normed ? __ldg(br.gamma + c) : 0.f;
      ch.be[k][v] = normed ? __ldg(br.beta + c) : 0.f;
      ch.mu[k][v] = normed ? __ldg(br.stats + c) : 0.f;
      ch.rstd[k][v] = normed ? __ldg(br.stats + q.G + c) : 0.f;
    }
  }
  return ch;
}

// x of one element, rounded step by step as every pass rounds it
__device__ __forceinline__ float normed(float z, float b, float mu,
                                        float rstd) {
  return __fmul_rn(__fsub_rn(__fadd_rn(z, b), mu), rstd);
}

template <bool LEAKY>
__device__ __forceinline__ float act(float a) {
  if constexpr (LEAKY) {
    return a > 0.f ? a : __fmul_rn(a, kLeak);
  } else {
    return fmaxf(a, 0.f);
  }
}

// g * act'(a)
template <bool LEAKY>
__device__ __forceinline__ float sloped(float g, float a) {
  if constexpr (LEAKY) {
    return a > 0.f ? g : __fmul_rn(g, kLeak);
  } else {
    return a > 0.f ? g : 0.f;
  }
}

// g * act'(a) at a position route() routed: relu routes only a > 0
template <bool LEAKY>
__device__ __forceinline__ float through(float g, float a) {
  if constexpr (LEAKY) {
    return sloped<true>(g, a);
  } else {
    return g;
  }
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
template <int NB, int V>
struct Cell {
  bool ok[4];
  long long off[4];
  float x[NB][4][V], a[4][V];
};

template <int NB, int V>
__device__ __forceinline__ void load_cell(const Geom& q, const Args<NB>& p,
                                          const Chans<NB, V>& ch,
                                          long long m, int ci, int cj,
                                          Cell<NB, V>& cl) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = 2 * ci + (k >> 1), j = 2 * cj + (k & 1);
    cl.ok[k] = i < q.H && j < q.W;
    cl.off[k] = ((m * q.H + i) * q.W + j) * q.G + ch.c;
  }
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    float raw[4][V];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (cl.ok[k]) {
        load<V>(p.br[n].z + cl.off[k], raw[k]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) raw[k][v] = 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float x = normed(raw[k][v], ch.b[n][v], ch.mu[n][v],
                               ch.rstd[n][v]);
        cl.x[n][k][v] = x;
        const float a = __fmaf_rn(ch.g[n][v], x, ch.be[n][v]);
        cl.a[k][v] = n == 0 ? a : __fadd_rn(cl.a[k][v], a);
      }
    }
  }
}

// The window's routing for one channel: bit k set where element k takes
// the window's gradient (a tie of the max of act(a); under relu, with
// a > 0); *ties is the number of ties of the max, relu-dead ones included,
// as amax counts them.
template <bool LEAKY>
__device__ __forceinline__ void route(float a0, float a1, float a2,
                                      float a3, int* bits, float* ties) {
  const float h0 = act<LEAKY>(a0), h1 = act<LEAKY>(a1);
  const float h2 = act<LEAKY>(a2), h3 = act<LEAKY>(a3);
  const float top = fmaxf(fmaxf(h0, h1), fmaxf(h2, h3));
  const bool t0 = h0 == top, t1 = h1 == top, t2 = h2 == top, t3 = h3 == top;
  *ties = (float)((int)t0 + (int)t1 + (int)t2 + (int)t3);
  if constexpr (LEAKY) {
    *bits = t0 | (t1 << 1) | (t2 << 2) | (t3 << 3);
  } else {
    *bits = (t0 && a0 > 0.f) | ((t1 && a1 > 0.f) << 1) |
            ((t2 && a2 > 0.f) << 2) | ((t3 && a3 > 0.f) << 3);
  }
}

// ga of a cell: with the pool, the pooled gradient routed through the
// window, or 0 outside the pooled region (the odd last row or column);
// without it, g_out at each position; times act'(a).
template <bool LEAKY, bool POOL, int NB, int V>
__device__ __forceinline__ void routed(const Geom& q, const float* g_out,
                                       const Chans<NB, V>& ch, long long m,
                                       int ci, int cj, const Cell<NB, V>& cl,
                                       float (&ga)[4][V], int (&bits)[V],
                                       float (&ties)[V], long long& woff) {
  if constexpr (POOL) {
    const bool window = ci < q.H2 && cj < q.W2;
    woff = ((m * q.H2 + ci) * q.W2 + cj) * q.G + ch.c;
    float gw[V];
    if (window) {
      load<V>(g_out + woff, gw);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      bits[v] = 0;
      ties[v] = 1.f;
      if (window) {
        route<LEAKY>(cl.a[0][v], cl.a[1][v], cl.a[2][v], cl.a[3][v],
                     &bits[v], &ties[v]);
      } else {
        gw[v] = 0.f;
      }
      const float share = __fdiv_rn(gw[v], ties[v]);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        ga[k][v] = (bits[v] >> k) & 1 ? through<LEAKY>(share, cl.a[k][v])
                                      : 0.f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float g[V];
      if (cl.ok[k]) {
        load<V>(g_out + cl.off[k], g);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) g[v] = 0.f;
      }
#pragma unroll
      for (int v = 0; v < V; ++v) ga[k][v] = sloped<LEAKY>(g[v], cl.a[k][v]);
    }
  }
}

// A block's sums into its partial row: the threads of one channel vector
// added in a fixed order, at most 3 sums a channel staged at a time.
// partial is (rows, K, G) doubles.
template <int K, int V>
__device__ __forceinline__ void block_partial(const Geom& q, int c, bool live,
                                              const double (&acc)[K][V],
                                              double* partial) {
  constexpr int KC = K < 3 ? K : 3;
  __shared__ double red[KC * V * kThreads];
  const int n = q.TX * q.TY;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += KC) {
    if (k0) __syncthreads();
#pragma unroll
    for (int k = 0; k < KC && k0 + k < K; ++k)
#pragma unroll
      for (int v = 0; v < V; ++v)
        red[(k * V + v) * n + threadIdx.x] = acc[k0 + k][v];
    __syncthreads();
    if (threadIdx.x < q.TX && live) {
#pragma unroll
      for (int k = 0; k < KC && k0 + k < K; ++k) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          double s = 0.0;
          for (int t = 0; t < q.TY; ++t) s += red[(k * V + v) * n + t * q.TX + threadIdx.x];
          partial[((long long)blockIdx.x * K + k0 + k) * q.G + c + v] = s;
        }
      }
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

// The walk of the backward's sums and of the forward's output: the pooled
// windows with the pool (the rest takes no gradient and gives no output),
// else every cell.
template <bool POOL>
__device__ __forceinline__ void out_walk(const Geom& q, unsigned* units,
                                         int* rows, int* cols) {
  *rows = POOL ? q.H2 : q.CH;
  *cols = POOL ? q.W2 : q.CW;
  *units = (unsigned)(q.M * *rows * *cols);
}

// ---- forward ---------------------------------------------------------

// Each branch's sums of y - shift and (y - shift)^2 over every position,
// shift = the channel's y at position 0.
template <int NB, int V>
__global__ void __launch_bounds__(kThreads)
norm_relu_pool_stats_kernel(const Args<NB> p, Geom q) {
  const Chans<NB, V> ch = chans<NB, V>(q, p, false);
  double acc[2 * NB][V] = {};
  if (ch.live) {
    double shift[NB][V];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      float z0[V];
      load<V>(p.br[n].z + ch.c, z0);
#pragma unroll
      for (int v = 0; v < V; ++v)
        shift[n][v] = (double)__fadd_rn(z0[v], ch.b[n][v]);
    }
    const unsigned cells = (unsigned)(q.M * q.CH * q.CW);
    const int ty = threadIdx.x / q.TX;
    for (unsigned e = blockIdx.x * q.TY + ty; e < cells;
         e += gridDim.x * q.TY) {
      long long m;
      int ci, cj;
      cell_of(e, q.CH, q.CW, m, ci, cj);
      bool ok[4];
      long long off[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 2 * ci + (k >> 1), j = 2 * cj + (k & 1);
        ok[k] = i < q.H && j < q.W;
        off[k] = ((m * q.H + i) * q.W + j) * q.G + ch.c;
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        float raw[4][V];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (ok[k]) load<V>(p.br[n].z + off[k], raw[k]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!ok[k]) continue;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const double d = (double)__fadd_rn(raw[k][v], ch.b[n][v]) - shift[n][v];
            acc[2 * n][v] += d;
            acc[2 * n + 1][v] = fma(d, d, acc[2 * n + 1][v]);
          }
        }
      }
    }
  }
  block_partial<2 * NB, V>(q, ch.c, ch.live, acc, p.partial);
}

// mu and rstd of each branch's channels: stats[c] = mu, stats[G + c] = rstd.
template <int NB>
__global__ void __launch_bounds__(kFinalChans * kFinalLanes)
norm_relu_pool_stats_finalize_kernel(const Args<NB> p, int rows, Geom q) {
  double s[2 * NB];
  int c;
  if (!final_sums<2 * NB>(p.partial, rows, q.G, s, c)) return;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const Branch& br = p.br[n];
    const double mean = s[2 * n] / q.n;
    const double var = fmax(s[2 * n + 1] / q.n - mean * mean, 0.0);
    br.stats[c] = (float)((double)__fadd_rn(br.z[c], br.b[c]) + mean);
    br.stats[q.G + c] = (float)(1.0 / sqrt(var + (double)kEps));
  }
}

// The output: act(a) at every position, or its max over each 2x2 window.
template <bool LEAKY, bool POOL, int NB, int V>
__global__ void __launch_bounds__(kThreads)
norm_relu_pool_apply_kernel(const Args<NB> p, Geom q) {
  const Chans<NB, V> ch = chans<NB, V>(q, p, true);
  if (!ch.live) return;
  unsigned units;
  int rows, cols;
  out_walk<POOL>(q, &units, &rows, &cols);
  const int ty = threadIdx.x / q.TX;
  for (unsigned e = blockIdx.x * q.TY + ty; e < units;
       e += gridDim.x * q.TY) {
    long long m;
    int ci, cj;
    cell_of(e, rows, cols, m, ci, cj);
    Cell<NB, V> cl;
    load_cell<NB, V>(q, p, ch, m, ci, cj, cl);
    if constexpr (POOL) {
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float h0 = act<LEAKY>(cl.a[0][v]), h1 = act<LEAKY>(cl.a[1][v]);
        const float h2 = act<LEAKY>(cl.a[2][v]), h3 = act<LEAKY>(cl.a[3][v]);
        o[v] = fmaxf(fmaxf(h0, h1), fmaxf(h2, h3));
      }
      store<V>(p.out + (long long)e * q.G + ch.c, o);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!cl.ok[k]) continue;
        float o[V];
#pragma unroll
        for (int v = 0; v < V; ++v) o[v] = act<LEAKY>(cl.a[k][v]);
        store<V>(p.out + cl.off[k], o);
      }
    }
  }
}

// ---- backward --------------------------------------------------------

// sum ga, and each branch's sum ga*x, over the walk (ga is 0 elsewhere).
template <bool LEAKY, bool POOL, int NB, int V>
__global__ void __launch_bounds__(kThreads)
norm_relu_pool_grad_sums_kernel(const Args<NB> p, Geom q) {
  const Chans<NB, V> ch = chans<NB, V>(q, p, true);
  double acc[1 + NB][V] = {};
  if (ch.live) {
    unsigned units;
    int rows, cols;
    out_walk<POOL>(q, &units, &rows, &cols);
    const int ty = threadIdx.x / q.TX;
    for (unsigned e = blockIdx.x * q.TY + ty; e < units;
         e += gridDim.x * q.TY) {
      long long m, woff;
      int ci, cj;
      cell_of(e, rows, cols, m, ci, cj);
      Cell<NB, V> cl;
      load_cell<NB, V>(q, p, ch, m, ci, cj, cl);
      float ga[4][V], ties[V];
      int bits[V];
      routed<LEAKY, POOL, NB, V>(q, p.g_out, ch, m, ci, cj, cl, ga, bits,
                                 ties, woff);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[0][v] += (double)ga[k][v];
#pragma unroll
          for (int n = 0; n < NB; ++n)
            acc[1 + n][v] = fma((double)ga[k][v], (double)cl.x[n][k][v], acc[1 + n][v]);
        }
    }
  }
  block_partial<1 + NB, V>(q, ch.c, ch.live, acc, p.partial);
}

// Each branch's sums = (A, S) in fp64 for the double backward; coef =
// (gamma*r, -gamma*r*S/N, -gamma*r*A/N) for g_z; g_gamma = S, g_beta = A,
// g_b = 0.
template <int NB>
__global__ void __launch_bounds__(kFinalChans * kFinalLanes)
norm_relu_pool_grad_finalize_kernel(const Args<NB> p, int rows, Geom q) {
  double s[1 + NB];
  int c;
  if (!final_sums<1 + NB>(p.partial, rows, q.G, s, c)) return;
  const int G = q.G;
  const double A = s[0];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const Branch& br = p.br[n];
    const double S = s[1 + n];
    const double gr = (double)br.gamma[c] * (double)br.stats[G + c];
    br.sums[c] = A;
    br.sums[G + c] = S;
    br.coef[c] = (float)gr;
    br.coef[G + c] = (float)(-gr * S / q.n);
    br.coef[2 * G + c] = (float)(-gr * A / q.n);
    br.d_gamma[c] = (float)S;
    br.d_beta[c] = (float)A;
    br.d_b[c] = 0.f;
  }
}

// g_z = gamma*r*ga - gamma*r*S/N * x - gamma*r*A/N at every position, for
// every branch.
template <bool LEAKY, bool POOL, int NB, int V>
__global__ void __launch_bounds__(kThreads)
norm_relu_pool_grad_kernel(const Args<NB> p, Geom q) {
  const Chans<NB, V> ch = chans<NB, V>(q, p, true);
  if (!ch.live) return;
  float k1[NB][V], k2[NB][V], k3[NB][V];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      k1[n][v] = __ldg(p.br[n].coef + ch.c + v);
      k2[n][v] = __ldg(p.br[n].coef + q.G + ch.c + v);
      k3[n][v] = __ldg(p.br[n].coef + 2 * q.G + ch.c + v);
    }
  const unsigned cells = (unsigned)(q.M * q.CH * q.CW);
  const int ty = threadIdx.x / q.TX;
  for (unsigned e = blockIdx.x * q.TY + ty; e < cells;
       e += gridDim.x * q.TY) {
    long long m, woff;
    int ci, cj;
    cell_of(e, q.CH, q.CW, m, ci, cj);
    Cell<NB, V> cl;
    load_cell<NB, V>(q, p, ch, m, ci, cj, cl);
    float ga[4][V], ties[V];
    int bits[V];
    routed<LEAKY, POOL, NB, V>(q, p.g_out, ch, m, ci, cj, cl, ga, bits, ties,
                               woff);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!cl.ok[k]) continue;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        float o[V];
#pragma unroll
        for (int v = 0; v < V; ++v)
          o[v] = __fmaf_rn(k1[n][v], ga[k][v],
                           __fmaf_rn(k2[n][v], cl.x[n][k][v], k3[n][v]));
        store<V>(p.br[n].d_z + cl.off[k], o);
      }
    }
  }
}

// ---- double backward -------------------------------------------------

// Each branch's V = sum v_z, VX = sum v_z*x, VG = sum v_z*ga over every
// position (a null v_z: zero).
template <bool LEAKY, bool POOL, int NB, int V>
__global__ void __launch_bounds__(kThreads)
norm_relu_pool_grad2_sums_kernel(const Args<NB> p, Geom q) {
  const Chans<NB, V> ch = chans<NB, V>(q, p, true);
  double acc[3 * NB][V] = {};
  if (ch.live) {
    const unsigned cells = (unsigned)(q.M * q.CH * q.CW);
    const int ty = threadIdx.x / q.TX;
    for (unsigned e = blockIdx.x * q.TY + ty; e < cells;
         e += gridDim.x * q.TY) {
      long long m, woff;
      int ci, cj;
      cell_of(e, q.CH, q.CW, m, ci, cj);
      Cell<NB, V> cl;
      load_cell<NB, V>(q, p, ch, m, ci, cj, cl);
      float ga[4][V], ties[V];
      int bits[V];
      routed<LEAKY, POOL, NB, V>(q, p.g_out, ch, m, ci, cj, cl, ga, bits,
                                 ties, woff);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const float* v_z = p.br[n].v_z;
        float vz[4][V];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (cl.ok[k] && v_z) {
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
            acc[3 * n][v] += w;
            acc[3 * n + 1][v] = fma(w, (double)cl.x[n][k][v], acc[3 * n + 1][v]);
            acc[3 * n + 2][v] = fma(w, (double)ga[k][v], acc[3 * n + 2][v]);
          }
      }
    }
  }
  block_partial<3 * NB, V>(q, ch.c, ch.live, acc, p.partial);
}

// The double backward's per-channel coefficients of each branch, coef =
// (ag, av, ax, a0, wv, wx, w0) x G, and c_gamma; c_beta = c_b = 0. v_z's
// sums come from partial (null: all 0), v_gamma and v_beta may be null (0).
template <int NB>
__global__ void __launch_bounds__(kFinalChans * kFinalLanes)
norm_relu_pool_grad2_finalize_kernel(const Args<NB> p, int rows, Geom q) {
  double s[3 * NB];
  int c;
  if (!final_sums<3 * NB>(p.partial, rows, q.G, s, c)) return;
  const int G = q.G;
  const double n = q.n;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const Branch& br = p.br[b];
    const double Vs = s[3 * b], VX = s[3 * b + 1], VG = s[3 * b + 2];
    const double A = br.sums[c], S = br.sums[G + c];
    const double r = (double)br.stats[G + c], g = (double)br.gamma[c];
    const double gr = g * r;
    const double vg = br.v_gamma ? (double)br.v_gamma[c] : 0.0;
    const double vb = br.v_beta ? (double)br.v_beta[c] : 0.0;
    // Phi = g*r*(VG - A*V/N - S*VX/N) + vg*S + vb*A; its derivative in x
    // is p = -(g*r/N)*(ga*VX + v_z*S) + vg*ga, in rstd (explicit) g*qq
    const double qq = VG - A * Vs / n - S * VX / n;
    const double mean_p = -gr * (A * VX + Vs * S) / (n * n) + vg * A / n;
    const double mean_px = -2.0 * gr * S * VX / (n * n) + vg * S / n;
    float* coef = br.coef;
    coef[c] = (float)(r * (vg - gr * VX / n));                  // ag
    coef[G + c] = (float)(-gr * r * S / n);                     // av
    coef[2 * G + c] = (float)(-r * mean_px - g * qq * r * r / n);  // ax
    coef[3 * G + c] = (float)(-r * mean_p);                     // a0
    coef[4 * G + c] = (float)gr;                                // wv
    coef[5 * G + c] = (float)(vg - gr * VX / n);                // wx
    coef[6 * G + c] = (float)(vb - gr * Vs / n);                // w0
    br.d_gamma[c] = (float)(r * qq);
    br.d_beta[c] = 0.f;
    br.d_b[c] = 0.f;
  }
}

// Each branch's c_z at every position, and c_gout at every window (every
// position without the pool).
template <bool LEAKY, bool POOL, int NB, int V>
__global__ void __launch_bounds__(kThreads)
norm_relu_pool_grad2_kernel(const Args<NB> p, Geom q) {
  const Chans<NB, V> ch = chans<NB, V>(q, p, true);
  if (!ch.live) return;
  float k[NB][7][V];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 7; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v)
        k[n][i][v] = __ldg(p.br[n].coef + i * q.G + ch.c + v);
  const unsigned cells = (unsigned)(q.M * q.CH * q.CW);
  const int ty = threadIdx.x / q.TX;
  for (unsigned e = blockIdx.x * q.TY + ty; e < cells;
       e += gridDim.x * q.TY) {
    long long m, woff;
    int ci, cj;
    cell_of(e, q.CH, q.CW, m, ci, cj);
    Cell<NB, V> cl;
    load_cell<NB, V>(q, p, ch, m, ci, cj, cl);
    float ga[4][V], ties[V];
    int bits[V];
    routed<LEAKY, POOL, NB, V>(q, p.g_out, ch, m, ci, cj, cl, ga, bits, ties,
                               woff);
    // w: c_gout's term at each position, summed over the branches
    float w[4][V];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float* v_z = p.br[n].v_z;
      float vz[4][V];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (cl.ok[i] && v_z) {
          load<V>(v_z + cl.off[i], vz[i]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) vz[i][v] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!cl.ok[i]) continue;
        float o[V];
#pragma unroll
        for (int v = 0; v < V; ++v)
          o[v] = __fmaf_rn(k[n][0][v], ga[i][v],
                           __fmaf_rn(k[n][1][v], vz[i][v],
                                     __fmaf_rn(k[n][2][v], cl.x[n][i][v], k[n][3][v])));
        store<V>(p.br[n].d_z + cl.off[i], o);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float t = __fmaf_rn(k[n][4][v], vz[i][v],
                                    __fmaf_rn(k[n][5][v], cl.x[n][i][v], k[n][6][v]));
          w[i][v] = n == 0 ? t : __fadd_rn(w[i][v], t);
        }
    }
    if constexpr (POOL) {
      if (ci < q.H2 && cj < q.W2) {
        float o[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if ((bits[v] >> i) & 1)
              s = __fadd_rn(s, through<LEAKY>(w[i][v], cl.a[i][v]));
          }
          o[v] = __fdiv_rn(s, ties[v]);
        }
        store<V>(p.out + woff, o);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!cl.ok[i]) continue;
        float o[V];
#pragma unroll
        for (int v = 0; v < V; ++v) o[v] = sloped<LEAKY>(w[i][v], cl.a[i][v]);
        store<V>(p.out + cl.off[i], o);
      }
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

// A launch's pointers as ops/kernels.py passes them: kSlots a branch in
// Branch's order, then g_out and out.
constexpr int kSlots = 14;

template <int NB>
Args<NB> args_of(void* const* t, double* partial) {
  Args<NB> p;
  for (int n = 0; n < NB; ++n) {
    void* const* s = t + n * kSlots;
    p.br[n] = Branch{(const float*)s[0], (const float*)s[1],
                     (const float*)s[2], (const float*)s[3],
                     (float*)s[4],       (double*)s[5],
                     (float*)s[6],       (const float*)s[7],
                     (const float*)s[8], (const float*)s[9],
                     (float*)s[10],      (float*)s[11],
                     (float*)s[12],      (float*)s[13]};
  }
  p.g_out = (const float*)t[NB * kSlots];
  p.out = (float*)t[NB * kSlots + 1];
  p.partial = partial;
  return p;
}

// Whether every activation-sized pointer of the launch (null or) takes
// 16-byte loads and stores.
template <int NB>
bool vec_aligned(const Args<NB>& p) {
  bool ok = aligned(p.g_out) && aligned(p.out);
  for (int n = 0; n < NB; ++n)
    ok = ok && aligned(p.br[n].z) && aligned(p.br[n].v_z) &&
         aligned(p.br[n].d_z);
  return ok;
}

// A pass's launches, after make_geom; the kernels' walks take V = vec.
template <bool LEAKY, bool POOL, int NB>
int forward(const Args<NB>& p, const Geom& q, dim3 gmax, int vec,
            cudaStream_t s) {
  const dim3 block(q.TX * q.TY);
  const dim3 g1 = walk_grid(q, gmax, q.M * q.CH * q.CW);
  if (vec == 4)
    norm_relu_pool_stats_kernel<NB, 4><<<g1, block, 0, s>>>(p, q);
  else
    norm_relu_pool_stats_kernel<NB, 1><<<g1, block, 0, s>>>(p, q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  norm_relu_pool_stats_finalize_kernel<NB>
      <<<final_grid(q), kFinalChans * kFinalLanes, 0, s>>>(p, g1.x, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2 = walk_grid(q, gmax, POOL ? q.M * q.H2 * q.W2
                                          : q.M * q.CH * q.CW);
  if (vec == 4)
    norm_relu_pool_apply_kernel<LEAKY, POOL, NB, 4><<<g2, block, 0, s>>>(p, q);
  else
    norm_relu_pool_apply_kernel<LEAKY, POOL, NB, 1><<<g2, block, 0, s>>>(p, q);
  return (int)cudaGetLastError();
}

template <bool LEAKY, bool POOL, int NB>
int backward(const Args<NB>& p, const Geom& q, dim3 gmax, int vec,
             cudaStream_t s) {
  const dim3 block(q.TX * q.TY);
  const dim3 g1 = walk_grid(q, gmax, POOL ? q.M * q.H2 * q.W2
                                          : q.M * q.CH * q.CW);
  if (vec == 4)
    norm_relu_pool_grad_sums_kernel<LEAKY, POOL, NB, 4><<<g1, block, 0, s>>>(p, q);
  else
    norm_relu_pool_grad_sums_kernel<LEAKY, POOL, NB, 1><<<g1, block, 0, s>>>(p, q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  norm_relu_pool_grad_finalize_kernel<NB>
      <<<final_grid(q), kFinalChans * kFinalLanes, 0, s>>>(p, g1.x, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2 = walk_grid(q, gmax, q.M * q.CH * q.CW);
  if (vec == 4)
    norm_relu_pool_grad_kernel<LEAKY, POOL, NB, 4><<<g2, block, 0, s>>>(p, q);
  else
    norm_relu_pool_grad_kernel<LEAKY, POOL, NB, 1><<<g2, block, 0, s>>>(p, q);
  return (int)cudaGetLastError();
}

template <bool LEAKY, bool POOL, int NB>
int double_backward(const Args<NB>& p, const Geom& q, dim3 gmax, int vec,
                    cudaStream_t s) {
  const dim3 block(q.TX * q.TY);
  const dim3 g1 = walk_grid(q, gmax, q.M * q.CH * q.CW);
  bool any_vz = false;
  for (int n = 0; n < NB; ++n) any_vz = any_vz || p.br[n].v_z;
  cudaError_t err;
  if (any_vz) {
    if (vec == 4)
      norm_relu_pool_grad2_sums_kernel<LEAKY, POOL, NB, 4><<<g1, block, 0, s>>>(p, q);
    else
      norm_relu_pool_grad2_sums_kernel<LEAKY, POOL, NB, 1><<<g1, block, 0, s>>>(p, q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  Args<NB> f = p;
  if (!any_vz) f.partial = nullptr;
  norm_relu_pool_grad2_finalize_kernel<NB>
      <<<final_grid(q), kFinalChans * kFinalLanes, 0, s>>>(f, g1.x, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (vec == 4)
    norm_relu_pool_grad2_kernel<LEAKY, POOL, NB, 4><<<g1, block, 0, s>>>(p, q);
  else
    norm_relu_pool_grad2_kernel<LEAKY, POOL, NB, 1><<<g1, block, 0, s>>>(p, q);
  return (int)cudaGetLastError();
}

enum Pass { kForward, kBackward, kDoubleBackward };

template <bool LEAKY, bool POOL, int NB>
int run(Pass pass, void* const* t, double* partial, long long M, int G,
        int H, int W, int vec, int tx, int rows, void* stream) {
  Geom q;
  dim3 gmax;
  const Args<NB> p = args_of<NB>(t, partial);
  if (!make_geom(M, G, H, W, vec, tx, rows, &q, &gmax) ||
      (vec == 4 && !vec_aligned<NB>(p)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (pass == kForward) return forward<LEAKY, POOL, NB>(p, q, gmax, vec, s);
  if (pass == kBackward) return backward<LEAKY, POOL, NB>(p, q, gmax, vec, s);
  return double_backward<LEAKY, POOL, NB>(p, q, gmax, vec, s);
}

// The three forms this file is built for; any other is refused.
int dispatch(Pass pass, int leaky, int pool, int branches, void* const* t,
             double* partial, long long M, int G, int H, int W, int vec,
             int tx, int rows, void* stream) {
  if (!leaky && pool && branches == 1)
    return run<false, true, 1>(pass, t, partial, M, G, H, W, vec, tx, rows,
                               stream);
  if (leaky && !pool && branches == 1)
    return run<true, false, 1>(pass, t, partial, M, G, H, W, vec, tx, rows,
                               stream);
  if (leaky && pool && branches == 2)
    return run<true, true, 2>(pass, t, partial, M, G, H, W, vec, tx, rows,
                              stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The form (leaky, pool, branches), the tensors t (kSlots pointers a
// branch, then g_out and out: null where the pass takes none), partial
// (rows * 3 * branches * G doubles of scratch) and the walk: z_k (M, H, W,
// G) -> out (M, H/2, W/2, G), or (M, H, W, G) without the pool, and each
// branch's stats (2, G). vec 4 needs every activation pointer 16-byte
// aligned; tx = min(G / vec, 64).
int norm_relu_pool_forward_launch(int leaky, int pool, int branches,
                                  void* const* t, double* partial,
                                  long long M, int G, int H, int W, int vec,
                                  int tx, int rows, void* stream) {
  return dispatch(kForward, leaky, pool, branches, t, partial, M, G, H, W,
                  vec, tx, rows, stream);
}

// + g_out -> each branch's g_z (M, H, W, G), g_gamma, g_beta, g_b (G);
// each branch's sums (2, G) doubles and coef (3, G) floats are kept for
// the double backward (sums) and used here (coef).
int norm_relu_pool_backward_launch(int leaky, int pool, int branches,
                                   void* const* t, double* partial,
                                   long long M, int G, int H, int W, int vec,
                                   int tx, int rows, void* stream) {
  return dispatch(kBackward, leaky, pool, branches, t, partial, M, G, H, W,
                  vec, tx, rows, stream);
}

// + the backward's sums and each branch's cotangents v_z (M, H, W, G),
// v_gamma, v_beta (G), each may be null (zero) -> its c_z, c_gamma, c_beta,
// c_b, and c_gout (out); coef: 7 * G floats of scratch a branch.
int norm_relu_pool_double_backward_launch(int leaky, int pool, int branches,
                                          void* const* t, double* partial,
                                          long long M, int G, int H, int W,
                                          int vec, int tx, int rows,
                                          void* stream) {
  return dispatch(kDoubleBackward, leaky, pool, branches, t, partial, M, G,
                  H, W, vec, tx, rows, stream);
}

}  // extern "C"
