// Fused test-time adaptation of the 2-hidden-layer MLP plus a per-task head.
//
// Replaces the TPU kernel fumi_tpu/ops/pallas_kernels.py:_fused_adapt_kernel
// (wrapper fused_adapt). Per task: private copies of W1, b1, W2, b2 and the
// task's head (W3, b3); n_steps of forward -> g = (softmax - onehot)/S ->
// hand-derived backprop -> SGD on all six tensors at step_size; then one
// forward pass of the queries through the adapted weights. IEEE fp32
// throughout: plain FMA on the CUDA cores, no TF32, no tensor cores.
//
// Bound on this card. One adaptation step of one task costs
//   2*S*(2*D*H1 + 3*H1*H2 + 3*H2*N) flops
// (forward D*H1 + H1*H2 + H2*N, backward dW3, dr2, dW2, dr1 and dW1; the
// bias sums are lower order). At the flagship shapes (S=25, D=2048, H1=256,
// H2=64, N=5) that is 54.9 MFLOP a step, 5.49 GFLOP a task at 100 steps and
// 22.0 GFLOP at B=4, plus 2*Qn*(D*H1 + H1*H2 + H2*N) for the queries. The
// bytes it must move are the inputs and the logits, about 6 MB at B=4. At
// the H100 SXM's 67 TFLOP/s fp32 rate and 3.35 TB/s, the operations bound
// it: about 0.33 ms for B=4.
//
// What this design does about the bound: little, on purpose. The TPU
// kernel keeps a task's weights in VMEM; W1 alone is H1*D*4 = 2 MiB, which
// does not fit the 227 KB of shared memory a block can use. So each task
// gets ONE thread block (grid = B), persistent over all n_steps, with
// __syncthreads() between the phases of a step. The task's weight copies
// live in a scratch buffer in device memory that the wrapper allocates
// (B * 2.2 MB stays in the 50 MB L2); activations and gradients of the
// support rows live in shared memory. The two products with depth D (the
// layer-1 forward and the W1 update) are tiled through shared memory with a
// 4x4 register tile; the small ones are plain loops. Only B of the 132 SMs
// work, so the kernel reaches at most B/132 of the fp32 rate. Splitting a
// task across a thread-block cluster is the next design.
//
// Bound to PyTorch with ctypes: fused_adapt_launch takes data_ptr()s, the
// shapes, step_size and the stream, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTileRows = 32;   // rows of the layer-1 output tile
constexpr int kTileCols = 256;  // H1 columns of the layer-1 output tile
constexpr int kTileK = 32;      // depth of one shared-memory tile
constexpr int kPad = 4;         // keeps float4 rows aligned, spreads banks
constexpr int kChunkS = 32;     // support rows held in registers (W1 update)

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Shared-memory layout, in floats, each segment 16-byte aligned:
//   xsT [kTileK][kTileRows + kPad]   input tile, transposed
//   wsT [kTileK][kTileCols + kPad]   W1 tile, transposed
//   r1  [S][H1 + 1]                  relu(a1)
//   d1T [H1][round4(S)]              dL/da1, transposed
//   r2  [S][H2 + 1]                  relu(a2)
//   d2  [S][H2]                      dL/da2
//   g   [S][N]                       logits, then dL/dlogits
struct Smem {
  float *xsT, *wsT, *r1, *d1T, *r2, *d2, *g;
};

__host__ __device__ inline int layout(int S, int H1, int H2, int N,
                                      float* base, Smem* sm) {
  const int sizes[7] = {kTileK * (kTileRows + kPad),
                        kTileK * (kTileCols + kPad),
                        S * (H1 + 1),
                        H1 * round4(S),
                        S * (H2 + 1),
                        S * H2,
                        S * N};
  float** slots[7] = {nullptr, nullptr, nullptr, nullptr,
                      nullptr, nullptr, nullptr};
  if (sm != nullptr) {
    slots[0] = &sm->xsT; slots[1] = &sm->wsT; slots[2] = &sm->r1;
    slots[3] = &sm->d1T; slots[4] = &sm->r2; slots[5] = &sm->d2;
    slots[6] = &sm->g;
  }
  int off = 0;
  for (int i = 0; i < 7; ++i) {
    if (sm != nullptr) *slots[i] = base + off;
    off += round4(sizes[i]);
  }
  return off;
}

struct Task {
  int S, D, H1, H2, N;
  float step;
  const float* X;  // (S, D) support rows
  const int* Y;    // (S,) labels
  float* W1;       // adapted copies, in scratch
  float* b1;
  float* W2;
  float* b2;
  float* W3;
  float* b3;
};

// out[r][h] = relu(sum_k A[r][k] * W[h][k] + bias[h]), r < R, h < H; A and
// W row-major with depth K in global memory, out in shared memory (row
// stride ldo). Each thread owns a 4x4 tile of a 32x256 block of outputs.
__device__ void layer1(const float* A, int R, int K, const float* W,
                       const float* bias, int H, float* out, int ldo,
                       const Smem& sm) {
  const int tid = threadIdx.x;
  const int tx = tid % (kTileCols / 4);
  const int ty = tid / (kTileCols / 4);
  constexpr int ldx = kTileRows + kPad;
  constexpr int ldw = kTileCols + kPad;
  for (int r0 = 0; r0 < R; r0 += kTileRows) {
    for (int h0 = 0; h0 < H; h0 += kTileCols) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += kTileK) {
        __syncthreads();  // the previous tile has been consumed
        for (int e = tid; e < kTileRows * kTileK; e += kThreads) {
          const int kk = e % kTileK, rr = e / kTileK;
          const int r = r0 + rr, k = k0 + kk;
          sm.xsT[kk * ldx + rr] =
              (r < R && k < K) ? A[(size_t)r * K + k] : 0.f;
        }
        for (int e = tid; e < kTileCols * kTileK; e += kThreads) {
          const int kk = e % kTileK, hh = e / kTileK;
          const int h = h0 + hh, k = k0 + kk;
          sm.wsT[kk * ldw + hh] =
              (h < H && k < K) ? W[(size_t)h * K + k] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kTileK; ++kk) {
          const float4 a =
              *reinterpret_cast<const float4*>(&sm.xsT[kk * ldx + ty * 4]);
          const float4 b =
              *reinterpret_cast<const float4*>(&sm.wsT[kk * ldw + tx * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = r0 + ty * 4 + i, h = h0 + tx * 4 + j;
          if (r < R && h < H) out[r * ldo + h] = fmaxf(acc[i][j] + bias[h], 0.f);
        }
      }
    }
  }
  __syncthreads();
}

// Forward of R <= S rows of A: r1, r2 in shared memory, logits into
// `logits` (row stride N; shared or global memory).
__device__ void forward(const Task& t, const float* A, int R, const Smem& sm,
                        float* logits) {
  const int tid = threadIdx.x;
  const int H1 = t.H1, H2 = t.H2, N = t.N;
  layer1(A, R, t.D, t.W1, t.b1, H1, sm.r1, H1 + 1, sm);
  for (int idx = tid; idx < R * H2; idx += kThreads) {
    const int s = idx % R, j = idx / R;
    const float* a = sm.r1 + s * (H1 + 1);
    const float* w = t.W2 + (size_t)j * H1;
    float acc = 0.f;
    for (int k = 0; k < H1; ++k) acc = fmaf(a[k], w[k], acc);
    sm.r2[s * (H2 + 1) + j] = fmaxf(acc + t.b2[j], 0.f);
  }
  __syncthreads();
  for (int idx = tid; idx < R * N; idx += kThreads) {
    const int s = idx % R, n = idx / R;
    const float* a = sm.r2 + s * (H2 + 1);
    const float* w = t.W3 + n * H2;
    float acc = 0.f;
    for (int k = 0; k < H2; ++k) acc = fmaf(a[k], w[k], acc);
    logits[s * N + n] = acc + t.b3[n];
  }
  __syncthreads();
}

__device__ inline float sgd(float w, float step, float grad) {
  // w - step * grad, rounded twice as the reference computes it
  return __fsub_rn(w, __fmul_rn(step, grad));
}

// One adaptation step on the support rows.
__device__ void adapt_step(const Task& t, const Smem& sm) {
  const int tid = threadIdx.x;
  const int S = t.S, D = t.D, H1 = t.H1, H2 = t.H2, N = t.N;
  const int SP = round4(S);
  const float step = t.step;

  forward(t, t.X, S, sm, sm.g);

  // g = (softmax(logits) - onehot) / S, one thread per row
  for (int s = tid; s < S; s += kThreads) {
    float* row = sm.g + s * N;
    float m = row[0];
    for (int n = 1; n < N; ++n) m = fmaxf(m, row[n]);
    float sum = 0.f;
    for (int n = 0; n < N; ++n) sum += expf(row[n] - m);
    const int y = t.Y[s];
    for (int n = 0; n < N; ++n) {
      const float p = expf(row[n] - m) / sum;
      row[n] = (p - (n == y ? 1.f : 0.f)) / (float)S;
    }
  }
  __syncthreads();

  // dr2 = (g @ W3) * (a2 > 0)
  for (int idx = tid; idx < S * H2; idx += kThreads) {
    const int j = idx % H2, s = idx / H2;
    float acc = 0.f;
    for (int n = 0; n < N; ++n) acc = fmaf(sm.g[s * N + n], t.W3[n * H2 + j], acc);
    sm.d2[s * H2 + j] = sm.r2[s * (H2 + 1) + j] > 0.f ? acc : 0.f;
  }
  __syncthreads();

  // dr1 = (dr2 @ W2) * (a1 > 0), read before W2 changes; W3, b3 update
  for (int idx = tid; idx < S * H1; idx += kThreads) {
    const int h = idx % H1, s = idx / H1;
    float acc = 0.f;
    for (int j = 0; j < H2; ++j)
      acc = fmaf(sm.d2[s * H2 + j], t.W2[(size_t)j * H1 + h], acc);
    sm.d1T[h * SP + s] = sm.r1[s * (H1 + 1) + h] > 0.f ? acc : 0.f;
  }
  for (int idx = tid; idx < N * H2; idx += kThreads) {
    const int j = idx % H2, n = idx / H2;
    float acc = 0.f;
    for (int s = 0; s < S; ++s)
      acc = fmaf(sm.g[s * N + n], sm.r2[s * (H2 + 1) + j], acc);
    t.W3[n * H2 + j] = sgd(t.W3[n * H2 + j], step, acc);
  }
  for (int n = tid; n < N; n += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += sm.g[s * N + n];
    t.b3[n] = sgd(t.b3[n], step, acc);
  }
  __syncthreads();

  // W2, b2, b1 updates
  for (int idx = tid; idx < H2 * H1; idx += kThreads) {
    const int h = idx % H1, j = idx / H1;
    float acc = 0.f;
    for (int s = 0; s < S; ++s)
      acc = fmaf(sm.d2[s * H2 + j], sm.r1[s * (H1 + 1) + h], acc);
    t.W2[idx] = sgd(t.W2[idx], step, acc);
  }
  for (int j = tid; j < H2; j += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += sm.d2[s * H2 + j];
    t.b2[j] = sgd(t.b2[j], step, acc);
  }
  for (int h = tid; h < H1; h += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += sm.d1T[h * SP + s];
    t.b1[h] = sgd(t.b1[h], step, acc);
  }

  // W1 -= step * dr1^T @ X: one column d per thread, the column's support
  // values in registers, dr1 rows read as float4 broadcasts. Supports of
  // more than kChunkS rows update in chunks (the same sum, summed in parts).
  for (int d = tid; d < D; d += kThreads) {
    for (int s0 = 0; s0 < S; s0 += kChunkS) {
      float xr[kChunkS];
#pragma unroll
      for (int i = 0; i < kChunkS; ++i)
        xr[i] = (s0 + i < S) ? t.X[(size_t)(s0 + i) * D + d] : 0.f;
#pragma unroll 2
      for (int h = 0; h < H1; ++h) {
        const float* dp = sm.d1T + h * SP + s0;
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kChunkS; i += 4) {
          if (s0 + i < S) {
            const float4 v = *reinterpret_cast<const float4*>(dp + i);
            acc = fmaf(v.x, xr[i], acc);
            acc = fmaf(v.y, xr[i + 1], acc);
            acc = fmaf(v.z, xr[i + 2], acc);
            acc = fmaf(v.w, xr[i + 3], acc);
          }
        }
        float* w = t.W1 + (size_t)h * D + d;
        *w = sgd(*w, step, acc);
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
fused_adapt_kernel(const float* __restrict__ sx, const int* __restrict__ sy,
                   const float* __restrict__ qx, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, const float* __restrict__ hw,
                   const float* __restrict__ hb, float* __restrict__ out,
                   float* scratch, int S, int Qn, int D, int H1, int H2, int N,
                   int n_steps, float step) {
  extern __shared__ float4 smem_raw[];
  Smem sm;
  layout(S, H1, H2, N, reinterpret_cast<float*>(smem_raw), &sm);
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const size_t per_task =
      (size_t)H1 * D + H1 + (size_t)H2 * H1 + H2 + (size_t)N * H2 + N;

  Task t;
  t.S = S; t.D = D; t.H1 = H1; t.H2 = H2; t.N = N; t.step = step;
  t.X = sx + (size_t)b * S * D;
  t.Y = sy + (size_t)b * S;
  t.W1 = scratch + (size_t)b * per_task;
  t.b1 = t.W1 + (size_t)H1 * D;
  t.W2 = t.b1 + H1;
  t.b2 = t.W2 + (size_t)H2 * H1;
  t.W3 = t.b2 + H2;
  t.b3 = t.W3 + (size_t)N * H2;

  // private copies of the shared init and of this task's head
  for (size_t i = tid; i < (size_t)H1 * D; i += kThreads) t.W1[i] = w1[i];
  for (int i = tid; i < H1; i += kThreads) t.b1[i] = b1[i];
  for (int i = tid; i < H2 * H1; i += kThreads) t.W2[i] = w2[i];
  for (int i = tid; i < H2; i += kThreads) t.b2[i] = b2[i];
  for (int i = tid; i < N * H2; i += kThreads) t.W3[i] = hw[(size_t)b * N * H2 + i];
  for (int i = tid; i < N; i += kThreads) t.b3[i] = hb[(size_t)b * N + i];
  // the float4 reads of d1T run over its row padding: keep that zero
  const int SP = round4(S);
  for (int i = tid; i < H1 * (SP - S); i += kThreads)
    sm.d1T[(i / (SP - S)) * SP + S + i % (SP - S)] = 0.f;
  __syncthreads();

  for (int it = 0; it < n_steps; ++it) adapt_step(t, sm);

  // queries through the adapted weights, S rows at a time
  const float* Q = qx + (size_t)b * Qn * D;
  float* o = out + (size_t)b * Qn * N;
  for (int q0 = 0; q0 < Qn; q0 += S) {
    const int R = min(S, Qn - q0);
    forward(t, Q + (size_t)q0 * D, R, sm, o + (size_t)q0 * N);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs, in bytes.
long long fused_adapt_smem_bytes(int S, int H1, int H2, int N) {
  return (long long)layout(S, H1, H2, N, nullptr, nullptr) * sizeof(float);
}

// Scratch floats the wrapper allocates for each task.
long long fused_adapt_scratch_floats(int D, int H1, int H2, int N) {
  return (long long)H1 * D + H1 + (long long)H2 * H1 + H2 + (long long)N * H2 + N;
}

int fused_adapt_launch(const float* sx, const int* sy, const float* qx,
                       const float* w1, const float* b1, const float* w2,
                       const float* b2, const float* hw, const float* hb,
                       float* out, float* scratch, int B, int S, int Qn, int D,
                       int H1, int H2, int N, int n_steps, float step,
                       void* stream) {
  if (B < 1 || S < 1 || Qn < 1 || D < 1 || H1 < 1 || H2 < 1 || N < 1 ||
      n_steps < 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = fused_adapt_smem_bytes(S, H1, H2, N);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fused_adapt_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_adapt_kernel<<<B, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      sx, sy, qx, w1, b1, w2, b2, hw, hb, out, scratch, S, Qn, D, H1, H2, N,
      n_steps, step);
  return (int)cudaGetLastError();
}

}  // extern "C"
