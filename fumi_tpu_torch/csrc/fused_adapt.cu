// Fused test-time adaptation of the 2-hidden-layer MLP plus a head, one
// thread-block cluster per task.
//
// Replaces both TPU kernels of fumi_tpu/ops/pallas_kernels.py that compute
// this function: _fused_adapt_kernel (:113; wrappers fused_adapt,
// fused_maml_adapt, fused_fumi_adapt: a head per task) and
// _fused_adapt_batched_kernel (:353; wrapper fused_maml_adapt_batched: one
// head shared by the tasks). The JAX package needs two because a TPU core
// runs one grid program at a time; here one kernel spreads each task over a
// cluster either way, and the shared head is a per-task head at a task
// stride of 0. Per task: private copies of W1, b1, W2, b2 and the head (W3,
// b3); n_steps of forward -> g = (softmax - onehot)/S -> hand-derived
// backprop -> SGD on all six tensors at step_size, each update rounded as
// __fsub_rn(w, __fmul_rn(step, grad)); then the queries' logits through the
// adapted weights. IEEE fp32 on the CUDA cores: plain FMA, no TF32, no
// tensor cores.
//
// Bound on this card: operations. A task-step costs
// 2*S*(2*D*H1 + 3*H1*H2 + 3*H2*N) flops (forward, and backward to every
// weight), the queries 2*Qn*(D*H1 + H1*H2 + H2*N); at the flagship eval
// shapes (B=4, S=25, Qn=100, D=2048, H=(256, 64), N=5, 100 steps) that is
// 22.41 GFLOP, 0.3344 ms at the H100 SXM's 67 TFLOP/s fp32. The bytes (the
// inputs and the logits, about 6 MB) take 2 us at 3.35 TB/s.
//
// What the design does about it. W1 is H1*D*4 = 2 MiB a task, more than
// the 227 KB of shared memory a block has, and the two products that are D
// deep (the layer-1 forward and the W1 update) are 97% of the flops. So a
// task gets a cluster of C blocks (C=16 at the flagship, 16 SMs of one GPC)
// and block c owns columns [c*cols, (c+1)*cols) of D, cols = ceil(D/C): its
// slice of W1 (256 x 128 x 4 B = 128 KB) and of the support rows X (12.5 KB)
// stay in its shared memory, k-major, for all the steps. Block c also owns
// HC = H1/C hidden columns and JC = H2/C columns of a2. Partial sums travel
// as stores into the owner's shared memory (distributed shared memory,
// st.shared::cluster), published by a cluster barrier; the owner adds the C
// partials in rank order. A step:
//   1. block c computes the partial a1 over its D slice (S x H1, depth
//      cols) and pushes each hidden column's share to its owner;
//   2. barrier; each block sums its hidden columns: r1 = relu(a1 + b1);
//      computes the partial a2 over them (S x H2) and pushes each a2
//      column's share to its owner;
//   3. barrier; each block sums its a2 columns, r2 = relu(a2 + b2), and
//      pushes them to every block;
//   4. barrier; every block holds all of r2. Half a warp a support row:
//      the logits, g, dr2 = (g W3) * (a2 > 0), dr1 of the own hidden
//      columns with W2 from before its update, pushed to every block. Then
//      the updates of W3, b3, b2 (every block the same values in the same
//      order, so the copies stay bitwise equal across the cluster), of the
//      own columns of W2 and of the own slice of b1;
//   5. barrier (arrived before those updates, waited after them); the W1
//      slice -= step * dr1^T X[:, slice].
// The D-deep products are tiled in registers from float4 shared-memory
// loads: the layer-1 forward gives a thread pair a 4 x 8 tile of the
// partial a1 (the two lanes split the depth and join with a shuffle), the
// W1 update a thread an 8 x 8 tile of the slice. Clusters are independent,
// so grid = B*C runs in as many waves as the card needs, and every SM that a
// cluster holds works; at B=4 that is 64 of the 132 SMs, at R=1 16. The
// queries go through the same forward, SP rows at a time.
//
// Where the time goes, at the flagship on an H100 (clock64() stamps of one
// block in a development build; PERF.md): about 27 us a step, 8x the
// bound's share of a task-step: the two D-deep products about half of it,
// at about half of one SM's fp32 rate (the layer-1 forward is bound by its
// shared-memory loads, the W1 update by FMAs and its read-modify-write of
// the slice); the chain of small dependent layers and the cluster barriers
// the other half.
//
// Plan. C, cols and where W1 lives come from the caller
// (fumi_tpu_torch/ops/kernels.py:fused_adapt_plan): C = 16 where the card
// schedules such a cluster, fewer where D is small; where the W1 slice does
// not fit next to the activations it lives in a device-memory scratch
// buffer the caller allocates, with the same code (the kernel's other
// instantiation). fused_adapt_launch recomputes the layout and refuses a
// plan that does not match it (cudaErrorInvalidValue).
//
// Bound to PyTorch with ctypes: fused_adapt_launch takes data_ptr()s, the
// head strides, the shapes, the plan, the step size and the stream, and
// returns the launch's error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxCluster = 16;
// layer-1 forward: a thread sums a kRows x kCols tile of the partial a1,
// kSplit neighbouring lanes over interleaved rows of the slice
constexpr int kRows = 4;
constexpr int kCols = 8;
constexpr int kSplit = 2;
// W1 update: a thread updates a kUpdK x kCols tile of the k-major slice
constexpr int kUpdK = 8;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The segments of a block's shared memory, in this order, each 16-byte
// aligned (offsets in floats in Dims::off). "Pushed" segments are written by
// the cluster's blocks (remote stores) before a cluster barrier and read
// locally after it.
enum Segment {
  kXT,   // [DP][SP]    the block's columns of X (or of a query chunk), k-major
  kRA1,  // [C][SP][HC] pushed: each block's partial a1 of the own columns
  kD1F,  // [SP][LH]    pushed: the whole dr1
  kR1,   // [SP][HC]    relu(a1), own hidden columns
  kD1,   // [SP][HC]    dr1, own hidden columns
  kRA2,  // [C][SP][JC] pushed: each block's partial a2 of the own a2
         //             columns; then dr2, [SP][H2P]
  kR2,   // [SP][H2P]   pushed: relu(a2), all columns
  kG,    // [SP][N]     logits, then dL/dlogits
  kW2T,  // [HC][LW2]   own columns of W2, transposed
  kB1,   // [HC]        own slice of b1
  kB2,   // [H2P]
  kW3,   // [N][H2P]
  kB3,   // [N]
  kY,    // [SP]        support labels (int)
  kW1T,  // [DP][LH]    the W1 slice, k-major (when in shared memory)
  kSegments
};

struct Dims {
  int S, Qn, D, H1, H2, N;
  int C;        // blocks per task: the cluster
  int cols;     // columns of D a block owns, ceil(D / C)
  int w1_smem;  // the W1 slice in shared memory (else device memory)
  int SP;       // rows of the activation buffers, round_up(S, kRows)
  int DP;       // rows of the k-major X and W1 slices, round_up(cols, kUpdK)
  int HT;       // hidden columns in whole tiles, round_up(H1, kCols)
  int LH;       // row stride of the W1 slice and of d1f: HT + 4, so that
                // rows k and k+1 fall on other banks
  int HC;       // hidden columns a block owns, round_up(ceil(H1 / C), 4)
  int H2P;      // row stride of the S x H2 buffers, round_up(H2, 4)
  int JC;       // columns of a2 a block sums, round_up(ceil(H2 / C), 4)
  int LW2;      // row stride of the own W2 columns (transposed), H2P + 4
  int off[kSegments];  // segment offsets in floats
  long long floats;    // shared memory a block, in floats
  int n_steps;
  float step;
  long long hw_stride, hb_stride;  // head floats per task (0: shared head)
};

Dims make_dims(int S, int Qn, int D, int H1, int H2, int N, int C,
               int w1_smem) {
  Dims d;
  d.S = S; d.Qn = Qn; d.D = D; d.H1 = H1; d.H2 = H2; d.N = N;
  d.C = C;
  d.cols = cdiv(D, C);
  d.w1_smem = w1_smem;
  d.SP = round_up(S, kRows);
  d.DP = round_up(d.cols, kUpdK);
  d.HT = round_up(H1, kCols);
  d.LH = d.HT + 4;
  d.HC = round_up(cdiv(H1, C), 4);
  d.H2P = round_up(H2, 4);
  d.JC = round_up(cdiv(H2, C), 4);
  d.LW2 = d.H2P + 4;
  const long long SP = d.SP, CSP = (long long)d.C * d.SP;
  const long long sizes[kSegments] = {
      d.DP * SP,      CSP * d.HC, SP * d.LH,  SP * d.HC, SP * d.HC,
      CSP * d.JC,     SP * d.H2P,    SP * d.N,   (long long)d.HC * d.LW2,
      d.HC, d.H2P, (long long)d.N * d.H2P, d.N, SP,
      d.w1_smem ? (long long)d.DP * d.LH : 0};
  long long off = 0;
  for (int i = 0; i < kSegments; ++i) {
    d.off[i] = (int)off;
    off += (sizes[i] + 3) & ~3LL;
  }
  d.floats = off;
  d.n_steps = 0;
  d.step = 0.f;
  d.hw_stride = d.hb_stride = 0;
  return d;
}

extern __shared__ float4 smem_raw[];

__device__ __forceinline__ float* seg(const Dims& d, Segment s) {
  return reinterpret_cast<float*>(smem_raw) + d.off[s];
}

__device__ __forceinline__ float sgd(float w, float step, float grad) {
  // w - step * grad, rounded twice as the reference computes it
  return __fsub_rn(w, __fmul_rn(step, grad));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Stores v at the same place as p (in this block's shared memory) in the
// shared memory of the cluster's block `rank`.
__device__ __forceinline__ void st_peer4(float* p, int rank, float4 v) {
  const uint32_t local = (uint32_t)__cvta_generic_to_shared(p);
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "r"(remote), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// xT[k][r] = A[r][k0 + k] for k < kn, r < R; zero elsewhere (the padding
// rows and columns must add nothing). A row-major with row stride D.
__device__ void load_rows(const Dims& d, const float* __restrict__ A, int R,
                          int k0, int kn) {
  float* xT = seg(d, kXT);
#pragma unroll 1
  for (int e = threadIdx.x; e < d.SP * d.DP; e += kThreads) {
    const int r = e / d.DP, k = e % d.DP;
    xT[k * d.SP + r] = (r < R && k < kn) ? A[(size_t)r * d.D + k0 + k] : 0.f;
  }
}

// The partial a1[r][h] = sum_k xT[k][r] * w1T[k][h] over the block's slice,
// for rows r < R, pushed to ra1[rank][r][h - c*HC] of the block c that owns
// column h. Thread pairs own a kRows x kCols tile; the two lanes sum even
// and odd k and join with one shuffle. A warp with a task left runs whole
// (its idle lanes on a dummy tile), so the shuffle sees all its lanes.
__device__ void layer1_partial(const Dims& d, const float* w1T, int R,
                               int rank) {
  const float* xT = seg(d, kXT);
  float* ra1 = seg(d, kRA1);
  const int part = threadIdx.x % kSplit;
  const int ct_n = d.HT / kCols;
  const int tasks = (d.SP / kRows) * ct_n;
  for (int t0 = 0; t0 < tasks; t0 += kThreads / kSplit) {
    if (t0 + (threadIdx.x & ~31) / kSplit >= tasks) break;  // the whole warp
    const int task = t0 + threadIdx.x / kSplit;
    const bool live = task < tasks;
    const int rt = live ? task / ct_n : 0, ct = live ? task % ct_n : 0;
    const float* xp = xT + rt * kRows;
    const float* wp = w1T + ct * kCols;
    float acc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = part; k < d.DP; k += kSplit) {
      const float4 a = *reinterpret_cast<const float4*>(xp + k * d.SP);
      const float4 w0 = *reinterpret_cast<const float4*>(wp + k * d.LH);
      const float4 w1 = *reinterpret_cast<const float4*>(wp + k * d.LH + 4);
      const float av[kRows] = {a.x, a.y, a.z, a.w};
      const float wv[kCols] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 1);
    if (live && part == 0) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = rt * kRows + i;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int h = ct * kCols + 4 * q, c = h / d.HC;
          if (r < R && h < d.H1)
            st_peer4(ra1 + (rank * d.SP + r) * d.HC + h - c * d.HC, c,
                     make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                                 acc[i][4 * q + 2], acc[i][4 * q + 3]));
        }
      }
    }
  }
}

// w1T[k][h] -= step * sum_s xT[k][s] * dr1[s][h], dr1 in d1f: a thread
// updates kUpdK rows of the slice at columns [4c, 4c+4) and [HT/2 + 4c,
// HT/2 + 4c + 4), so a warp's float4 loads and stores are contiguous; the
// support rows two at a time.
__device__ void w1_update(const Dims& d, float* w1T) {
  const float* xT = seg(d, kXT);
  const float* d1f = seg(d, kD1F);
  const int ct_n = d.HT / kCols, half = d.HT / 2;
  const int tasks = (d.DP / kUpdK) * ct_n;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int kt = task / ct_n, ct = task % ct_n;
    const float* xp = xT + kt * kUpdK * d.SP;
    const float* gp = d1f + ct * 4;
    float acc[kUpdK][kCols];
#pragma unroll
    for (int i = 0; i < kUpdK; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
    for (int s = 0; s < d.SP; s += 2) {
      float2 x[kUpdK];
#pragma unroll
      for (int i = 0; i < kUpdK; ++i)
        x[i] = *reinterpret_cast<const float2*>(xp + i * d.SP + s);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* row = gp + (s + u) * d.LH;
        const float4 g0 = *reinterpret_cast<const float4*>(row);
        const float4 g1 = *reinterpret_cast<const float4*>(row + half);
        const float gv[kCols] = {g0.x, g0.y, g0.z, g0.w,
                                 g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int i = 0; i < kUpdK; ++i) {
          const float xv = u == 0 ? x[i].x : x[i].y;
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            acc[i][j] = fmaf(xv, gv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kUpdK; ++i) {
      float* row = w1T + (kt * kUpdK + i) * d.LH + ct * 4;
      float4 w0 = *reinterpret_cast<float4*>(row);
      float4 w1 = *reinterpret_cast<float4*>(row + half);
      w0.x = sgd(w0.x, d.step, acc[i][0]); w0.y = sgd(w0.y, d.step, acc[i][1]);
      w0.z = sgd(w0.z, d.step, acc[i][2]); w0.w = sgd(w0.w, d.step, acc[i][3]);
      w1.x = sgd(w1.x, d.step, acc[i][4]); w1.y = sgd(w1.y, d.step, acc[i][5]);
      w1.z = sgd(w1.z, d.step, acc[i][6]); w1.w = sgd(w1.w, d.step, acc[i][7]);
      *reinterpret_cast<float4*>(row) = w0;
      *reinterpret_cast<float4*>(row + half) = w1;
    }
  }
}

// The forward of R rows in xT up to relu(a2) in r2, in every block of the
// cluster. Each block pushes its partial a1 to the owners of the hidden
// columns; each owner sums the C partials of its columns in rank order (r1)
// and pushes its partial a2 to the owners of the a2 columns; each of those
// sums the C partials in rank order and pushes relu(a2) of its columns to
// every block (r2).
__device__ void forward_to_r2(const Dims& d, const cg::cluster_group& cluster,
                              const float* w1T, int R, int rank, int hn,
                              int j0, int jn) {
  const int tid = threadIdx.x;
  const int C = d.C, SP = d.SP, HC = d.HC, JC = d.JC, H2P = d.H2P;
  const float* ra1 = seg(d, kRA1);
  float* r1 = seg(d, kR1);
  float* ra2 = seg(d, kRA2);
  float* r2 = seg(d, kR2);
  const float* w2T = seg(d, kW2T);
  const float* b1 = seg(d, kB1);
  const float* b2 = seg(d, kB2);
  layer1_partial(d, w1T, R, rank);
  cluster.sync();
  const int hq = HC / 4;
#pragma unroll 1
  for (int e = tid; e < R * hq; e += kThreads) {
    const int s = e / hq, q = e % hq;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (4 * q < hn) {
      const float* src = ra1 + s * HC + 4 * q;
      acc = *reinterpret_cast<const float4*>(src);
#pragma unroll 4
      for (int c = 1; c < C; ++c)
        acc = add4(acc, *reinterpret_cast<const float4*>(src + c * SP * HC));
    }
    const float av[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int hl = 4 * q + t;
      r1[s * HC + hl] = hl < hn ? fmaxf(av[t] + b1[hl], 0.f) : 0.f;
    }
  }
  __syncthreads();
  // the partial a2 over the own hidden columns, four columns a thread,
  // pushed to the owner of those columns of a2
  const int q_n = H2P / 4;
#pragma unroll 1
  for (int e = tid; e < R * q_n; e += kThreads) {
    const int s = e / q_n, j = 4 * (e % q_n);
    const float* a = r1 + s * HC;
    const float* w = w2T + j;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int hl = 0; hl < hn; ++hl) {
      const float av = a[hl];
      const float4 wv = *reinterpret_cast<const float4*>(w + hl * d.LW2);
      acc.x = fmaf(av, wv.x, acc.x);
      acc.y = fmaf(av, wv.y, acc.y);
      acc.z = fmaf(av, wv.z, acc.z);
      acc.w = fmaf(av, wv.w, acc.w);
    }
    const int c = j / JC;
    st_peer4(ra2 + (rank * SP + s) * JC + j - c * JC, c, acc);
  }
  cluster.sync();
  // the own columns of a2: sixteen lanes an item, each pushing the sum to
  // one block of the cluster
  const int jq = cdiv(jn, 4);
  const int peer = tid % kMaxCluster;
#pragma unroll 1
  for (int e = tid / kMaxCluster; e < R * jq; e += kThreads / kMaxCluster) {
    const int s = e / jq, q = e % jq;
    const float* src = ra2 + s * JC + 4 * q;
    float4 acc = *reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (int c = 1; c < C; ++c)
      acc = add4(acc, *reinterpret_cast<const float4*>(src + c * SP * JC));
    const float av[4] = {acc.x, acc.y, acc.z, acc.w};
    float rv[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int jl = 4 * q + t;
      rv[t] = jl < jn ? fmaxf(av[t] + b2[j0 + jl], 0.f) : 0.f;
    }
    if (peer < C)
      st_peer4(r2 + s * H2P + j0 + 4 * q, peer,
               make_float4(rv[0], rv[1], rv[2], rv[3]));
  }
  cluster.sync();
}

// sum_s a[s * sa] over s < S, in two interleaved partial sums; every
// block adds in this one order.
__device__ __forceinline__ float sum_rows(const float* a, int sa, int S) {
  float acc0 = 0.f, acc1 = 0.f;
  int s = 0;
#pragma unroll 1
  for (; s + 1 < S; s += 2) {
    acc0 += a[s * sa];
    acc1 += a[(s + 1) * sa];
  }
  if (s < S) acc0 += a[s * sa];
  return acc0 + acc1;
}

// The small layers of a support row or a query row go to a group of
// kRowLanes lanes (half a warp), so the 25 rows of a flagship support set
// take one round of the block's 32 groups.
constexpr int kRowLanes = 16;

// The logits of row s of r2 into dst[0, N): one lane group (lane gl of
// mask gmask), the lanes splitting H2 in float4 quads, four classes at a
// time.
__device__ void row_logits(const Dims& d, int s, float* dst, int gl,
                           unsigned gmask) {
  const float* a = seg(d, kR2) + s * d.H2P;
  const float* w3 = seg(d, kW3);
  const float* b3 = seg(d, kB3);
  const int q_n = d.H2P / 4;
#pragma unroll 1
  for (int n0 = 0; n0 < d.N; n0 += 4) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int q = gl; q < q_n; q += kRowLanes) {
      const float4 av = *reinterpret_cast<const float4*>(a + 4 * q);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (n0 + u < d.N) {
          const float4 wv = *reinterpret_cast<const float4*>(
              w3 + (n0 + u) * d.H2P + 4 * q);
          acc[u] = fmaf(av.x, wv.x, acc[u]);
          acc[u] = fmaf(av.y, wv.y, acc[u]);
          acc[u] = fmaf(av.z, wv.z, acc[u]);
          acc[u] = fmaf(av.w, wv.w, acc[u]);
        }
      }
    }
#pragma unroll
    for (int o = kRowLanes / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[u] += __shfl_xor_sync(gmask, acc[u], o);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (gl == u && n0 + u < d.N) dst[n0 + u] = acc[u] + b3[n0 + u];
  }
}

// One adaptation step on the support rows (already in xT).
__device__ void adapt_step(const Dims& d, const cg::cluster_group& cluster,
                           float* w1T, int rank, int h0, int hn, int j0,
                           int jn) {
  const int tid = threadIdx.x;
  const int S = d.S, N = d.N, HC = d.HC, H2P = d.H2P;
  const int LW2 = d.LW2;
  const float step = d.step;
  float* d1f = seg(d, kD1F);
  float* r1 = seg(d, kR1);
  float* d1 = seg(d, kD1);
  float* d2 = seg(d, kRA2);  // ra2 is free once a2 is summed
  float* r2 = seg(d, kR2);
  float* g = seg(d, kG);
  float* w2T = seg(d, kW2T);
  float* b1 = seg(d, kB1);
  float* b2 = seg(d, kB2);
  float* w3 = seg(d, kW3);
  float* b3 = seg(d, kB3);
  const int* y = reinterpret_cast<const int*>(seg(d, kY));

  forward_to_r2(d, cluster, w1T, S, rank, hn, j0, jn);

  // a lane group a support row, with no block barrier between: the
  // logits, g = (softmax - onehot) / S, dr2 = (g W3) * (a2 > 0), dr1 for
  // the own hidden columns = (dr2 W2) * (a1 > 0) with W2 from before its
  // update, and that row of dr1 pushed to every block's d1f
  const int hq = cdiv(min(HC, round_up(d.H1, 4) - h0), 4);
  const int gl = tid % kRowLanes;
  const unsigned gmask = 0xffffu << (tid & 16);
#pragma unroll 1
  for (int s = tid / kRowLanes; s < S; s += kThreads / kRowLanes) {
    float* gs = g + s * N;
    row_logits(d, s, gs, gl, gmask);
    __syncwarp(gmask);
    float m = gs[0];
#pragma unroll 1
    for (int n = 1; n < N; ++n) m = fmaxf(m, gs[n]);
    float sum = 0.f;
#pragma unroll 1
    for (int n = 0; n < N; ++n) sum += expf(gs[n] - m);
    __syncwarp(gmask);
#pragma unroll 1
    for (int n = gl; n < N; n += kRowLanes) {
      const float p = expf(gs[n] - m) / sum;
      gs[n] = (p - (n == y[s] ? 1.f : 0.f)) / (float)S;
    }
    __syncwarp(gmask);
#pragma unroll 1
    for (int q = gl; q < H2P / 4; q += kRowLanes) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
      for (int n = 0; n < N; ++n) {
        const float gn = gs[n];
        const float4 wv =
            *reinterpret_cast<const float4*>(w3 + n * H2P + 4 * q);
        acc.x = fmaf(gn, wv.x, acc.x);
        acc.y = fmaf(gn, wv.y, acc.y);
        acc.z = fmaf(gn, wv.z, acc.z);
        acc.w = fmaf(gn, wv.w, acc.w);
      }
      // the padding columns of r2 are 0, so dr2 is 0 there: the sums over
      // H2P below add nothing for them
      const float4 rv =
          *reinterpret_cast<const float4*>(r2 + s * H2P + 4 * q);
      *reinterpret_cast<float4*>(d2 + s * H2P + 4 * q) =
          make_float4(rv.x > 0.f ? acc.x : 0.f, rv.y > 0.f ? acc.y : 0.f,
                      rv.z > 0.f ? acc.z : 0.f, rv.w > 0.f ? acc.w : 0.f);
    }
    __syncwarp(gmask);
#pragma unroll 1
    for (int hl = gl; hl < HC; hl += kRowLanes) {
      float acc = 0.f;
      if (hl < hn) {
        const float* a = d2 + s * H2P;
        const float* w = w2T + hl * LW2;
        float4 p4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int j = 0; j < H2P; j += 4) {
          const float4 av = *reinterpret_cast<const float4*>(a + j);
          const float4 wv = *reinterpret_cast<const float4*>(w + j);
          p4.x = fmaf(av.x, wv.x, p4.x);
          p4.y = fmaf(av.y, wv.y, p4.y);
          p4.z = fmaf(av.z, wv.z, p4.z);
          p4.w = fmaf(av.w, wv.w, p4.w);
        }
        acc = (p4.x + p4.y) + (p4.z + p4.w);
      }
      d1[s * HC + hl] = r1[s * HC + hl] > 0.f ? acc : 0.f;
    }
    __syncwarp(gmask);
#pragma unroll 1
    for (int e = gl; e < hq * d.C; e += kRowLanes) {
      const int c = e % d.C, q = e / d.C;
      st_peer4(d1f + s * d.LH + h0 + 4 * q, c,
               *reinterpret_cast<const float4*>(d1 + s * HC + 4 * q));
    }
  }
  __syncthreads();
  // the cluster barrier that publishes dr1 is split: this block arrives now
  // and waits only before the W1 update, so the updates below overlap the
  // other blocks' arrival
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");

  // the updates that sum over the support rows, one item a thread over a
  // joint index, four columns an item: W3, the own columns of W2, b2; then
  // b3 and the own slice of b1. The sums over s run in order, the same in
  // every block.
  const int q_n = H2P / 4;
  const int n_w3 = N * q_n, n_w2 = hn * q_n;
  const int n_all = n_w3 + n_w2 + q_n + N + hn;
#pragma unroll 1
  for (int e = tid; e < n_all; e += kThreads) {
    if (e < n_w3 + n_w2 + q_n) {
      float4* w;
      const float* a;  // one factor a support row (none for b2)
      int sa, j;
      if (e < n_w3) {
        const int n = e / q_n;
        j = 4 * (e % q_n);
        w = reinterpret_cast<float4*>(w3 + n * H2P + j);
        a = g + n;
        sa = N;
      } else if (e < n_w3 + n_w2) {
        const int i = e - n_w3, hl = i / q_n;
        j = 4 * (i % q_n);
        w = reinterpret_cast<float4*>(w2T + hl * LW2 + j);
        a = r1 + hl;
        sa = HC;
      } else {
        j = 4 * (e - n_w3 - n_w2);
        w = reinterpret_cast<float4*>(b2 + j);
        a = nullptr;
        sa = 0;
      }
      // the g or r2 rows for W3, the dr2 rows for W2 and b2
      const float* v = (e < n_w3 ? r2 : d2) + j;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 5
      for (int s = 0; s < S; ++s) {
        const float as = a != nullptr ? a[s * sa] : 1.f;
        const float4 vv = *reinterpret_cast<const float4*>(v + s * H2P);
        acc.x = fmaf(as, vv.x, acc.x);
        acc.y = fmaf(as, vv.y, acc.y);
        acc.z = fmaf(as, vv.z, acc.z);
        acc.w = fmaf(as, vv.w, acc.w);
      }
      float4 wv = *w;
      wv.x = sgd(wv.x, step, acc.x);
      wv.y = sgd(wv.y, step, acc.y);
      wv.z = sgd(wv.z, step, acc.z);
      wv.w = sgd(wv.w, step, acc.w);
      *w = wv;
    } else if (e < n_w3 + n_w2 + q_n + N) {
      const int n = e - n_w3 - n_w2 - q_n;
      b3[n] = sgd(b3[n], step, sum_rows(g + n, N, S));
    } else {
      const int hl = e - n_w3 - n_w2 - q_n - N;
      b1[hl] = sgd(b1[hl], step, sum_rows(d1 + hl, HC, S));
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  __syncthreads();
  w1_update(d, w1T);
  __syncthreads();
}

template <bool kW1Shared>
__global__ void __launch_bounds__(kThreads, 1)
fused_adapt_kernel(const float* __restrict__ sx, const int* __restrict__ sy,
                   const float* __restrict__ qx, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, const float* __restrict__ hw,
                   const float* __restrict__ hb, float* __restrict__ out,
                   float* __restrict__ w1_scratch, const Dims d) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / d.C;
  float* w1T = kW1Shared ? seg(d, kW1T)
                         : w1_scratch + (size_t)blockIdx.x * d.DP * d.LH;

  const int k0 = rank * d.cols;
  const int kn = max(0, min(d.cols, d.D - k0));
  const int h0 = rank * d.HC;
  const int hn = max(0, min(d.HC, d.H1 - h0));
  const int j0 = rank * d.JC;
  const int jn = max(0, min(d.JC, d.H2 - j0));
  const int H1 = d.H1, H2 = d.H2, N = d.N, HC = d.HC;

  // private copies: the W1 slice (k-major, zero padding), the own columns
  // of W2 (transposed) and slice of b1, all of b2 and the task's head
#pragma unroll 1
  for (int e = tid; e < d.HT * d.DP; e += kThreads) {
    const int h = e / d.DP, k = e % d.DP;
    w1T[k * d.LH + h] =
        (h < H1 && k < kn) ? w1[(size_t)h * d.D + k0 + k] : 0.f;
  }
  float* w2T = seg(d, kW2T);
#pragma unroll 1
  for (int e = tid; e < HC * d.LW2; e += kThreads) {
    const int hl = e / d.LW2, j = e % d.LW2;
    w2T[e] = (hl < hn && j < H2) ? w2[(size_t)j * H1 + h0 + hl] : 0.f;
  }
  float* pb1 = seg(d, kB1);
#pragma unroll 1
  for (int hl = tid; hl < HC; hl += kThreads)
    pb1[hl] = hl < hn ? b1[h0 + hl] : 0.f;
  float* pb2 = seg(d, kB2);
#pragma unroll 1
  for (int j = tid; j < d.H2P; j += kThreads) pb2[j] = j < H2 ? b2[j] : 0.f;
  float* w3 = seg(d, kW3);
#pragma unroll 1
  for (int e = tid; e < N * d.H2P; e += kThreads) {
    const int n = e / d.H2P, j = e % d.H2P;
    w3[e] = j < H2 ? hw[(size_t)b * d.hw_stride + n * H2 + j] : 0.f;
  }
  float* b3 = seg(d, kB3);
#pragma unroll 1
  for (int n = tid; n < N; n += kThreads)
    b3[n] = hb[(size_t)b * d.hb_stride + n];
  int* y = reinterpret_cast<int*>(seg(d, kY));
#pragma unroll 1
  for (int s = tid; s < d.S; s += kThreads) y[s] = sy[(size_t)b * d.S + s];
  // rows and columns of dr1 that no block pushes enter the W1 update as
  // zeros
  float* d1f = seg(d, kD1F);
#pragma unroll 1
  for (int e = tid; e < d.SP * d.LH; e += kThreads) d1f[e] = 0.f;
  load_rows(d, sx + (size_t)b * d.S * d.D, d.S, k0, kn);
  __syncthreads();

  for (int it = 0; it < d.n_steps; ++it)
    adapt_step(d, cluster, w1T, rank, h0, hn, j0, jn);

  // the queries through the adapted weights, SP rows at a time; rank 0
  // writes the logits
  const float* Q = qx + (size_t)b * d.Qn * d.D;
  float* o = out + (size_t)b * d.Qn * N;
  for (int q0 = 0; q0 < d.Qn; q0 += d.SP) {
    const int R = min(d.SP, d.Qn - q0);
    __syncthreads();
    load_rows(d, Q + (size_t)q0 * d.D, R, k0, kn);
    __syncthreads();
    forward_to_r2(d, cluster, w1T, R, rank, hn, j0, jn);
    if (rank == 0)
      for (int s = tid / kRowLanes; s < R; s += kThreads / kRowLanes)
        row_logits(d, s, o + (size_t)(q0 + s) * N, tid % kRowLanes,
                   0xffffu << (tid & 16));
  }
  // no block leaves while a peer may still read its shared memory
  cluster.sync();
}

// Checks a plan against the layout; returns the dims or C = 0.
Dims checked_dims(int S, int Qn, int D, int H1, int H2, int N, int C,
                  int cols, int w1_smem, long long smem_bytes) {
  Dims bad;
  bad.C = 0;
  if (S < 1 || Qn < 1 || D < 1 || H1 < 1 || H2 < 1 || N < 1 || C < 1 ||
      C > kMaxCluster)
    return bad;
  const Dims d = make_dims(S, Qn, D, H1, H2, N, C, w1_smem ? 1 : 0);
  if (cols != d.cols || 4 * d.floats != smem_bytes) return bad;
  return d;
}

template <bool kW1Shared>
cudaError_t set_attributes(int smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_adapt_kernel<kW1Shared>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fused_adapt_kernel<kW1Shared>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

cudaLaunchConfig_t cluster_config(int C, int blocks, long long bytes,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// Shared-memory bytes of a block under a plan (C blocks per task, the W1
// slice in shared memory or not).
long long fused_adapt_smem_bytes(int S, int D, int H1, int H2, int N, int C,
                                 int w1_smem) {
  return 4 * make_dims(S, 1, D, H1, H2, N, C, w1_smem ? 1 : 0).floats;
}

// What the current card allows: the shared memory a block may opt in to,
// and the largest cluster of this kernel it can schedule with that much
// shared memory a block.
int fused_adapt_card_limits(int* smem_optin, int* max_cluster) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = set_attributes<true>(*smem_optin);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMaxCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)*smem_optin;
  return (int)cudaOccupancyMaxPotentialClusterSize(
      max_cluster, (const void*)fused_adapt_kernel<true>, &cfg);
}

// How many clusters of C blocks with smem_bytes each the card can hold at
// once (0: such a cluster cannot be scheduled).
int fused_adapt_active_clusters(int C, int smem_bytes, int* clusters) {
  cudaError_t err = set_attributes<true>(smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(C, C, smem_bytes, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, (const void*)fused_adapt_kernel<true>, &cfg);
}

int fused_adapt_launch(const float* sx, const int* sy, const float* qx,
                       const float* w1, const float* b1, const float* w2,
                       const float* b2, const float* hw, const float* hb,
                       float* out, float* w1_scratch, long long hw_stride,
                       long long hb_stride, int B, int S, int Qn, int D, int H1,
                       int H2, int N, int C, int cols, int w1_smem,
                       long long smem_bytes, int n_steps, float step,
                       void* stream) {
  Dims d = checked_dims(S, Qn, D, H1, H2, N, C, cols, w1_smem, smem_bytes);
  if (B < 1 || n_steps < 0 || d.C == 0 || (!w1_smem && w1_scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  d.n_steps = n_steps;
  d.step = step;
  d.hw_stride = hw_stride;
  d.hb_stride = hb_stride;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      C, B * C, smem_bytes, (cudaStream_t)stream, attr);
  cudaError_t err;
  if (w1_smem) {
    err = set_attributes<true>((int)smem_bytes);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, fused_adapt_kernel<true>, sx, sy, qx, w1,
                               b1, w2, b2, hw, hb, out, w1_scratch, d);
  } else {
    err = set_attributes<false>((int)smem_bytes);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, fused_adapt_kernel<false>, sx, sy, qx, w1,
                               b1, w2, b2, hw, hb, out, w1_scratch, d);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
