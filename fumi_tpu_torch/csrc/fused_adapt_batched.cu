// Fused MAML test-time adaptation of B tasks that share one head, spread
// over the whole card.
//
// Replaces the TPU kernel fumi_tpu/ops/pallas_kernels.py:353-472
// (_fused_adapt_batched_kernel, wrapper fused_maml_adapt_batched). It
// computes the function of fused_maml_adapt (and of fused_adapt.cu with the
// head broadcast): per task, n_steps of forward -> g = (softmax - onehot)/S
// -> hand-derived backprop -> SGD on W1, b1, W2, b2, W3, b3 at step_size,
// then the query logits through the adapted weights. IEEE fp32 on the CUDA
// cores: plain FMA, no TF32, no tensor cores.
//
// Bound on this card: the operations of fused_adapt, per task-step
// 2*S*(2*D*H1 + 3*H1*H2 + 3*H2*N) flops plus the query forward; at the
// flagship eval shapes (B=4, S=25, Qn=100, D=2048, H=(256, 64), N=5, 100
// steps) 22.41 GFLOP, 0.3344 ms at the H100 SXM's 67 TFLOP/s fp32.
//
// Design. The TPU kernel's point is that all tasks live in one program, so
// their independent chains overlap. fused_adapt.cu gives each task one
// thread block and so uses B of the 132 SMs. Here each task's H1 rows of
// layer 1 are split over T blocks (R = ceil(H1 / T) rows each), and the B*T
// blocks of one cooperative launch are all resident at once. Each block
// keeps, in shared memory: its R rows of W1 (8 x 2048 x 4 = 64 KB at the
// flagship with T = 32), its slice of b1, and its own full copy of the
// small tensors W2 (stored transposed, 64 KB), b2, W3, b3. A step then needs
// the task's full r1 = relu(X W1^T + b1) (S x H1) from the task's other
// blocks once:
//   (A) the block computes r1[:, its rows] (one warp per support row, the
//       lanes splitting the D-deep sums) and writes it to a ping-pong buffer
//       in device memory; then the T blocks of the task meet at a barrier;
//   (B) every block reads the whole r1 and computes, redundantly and in the
//       same order, a2, r2, the logits, g, dr2, dW3/db3 and dW2/db2, and
//       updates its private W2, b2, W3, b3 (all T copies stay bitwise
//       equal); it computes dr1[:, its rows] = (dr2 W2_old[:, rows]) *
//       (r1 > 0) and updates its own W1 rows and b1 slice.
// One barrier per step; the ping-pong buffer keeps a fast block's next (A)
// off the buffer a slow block still reads. After the last step the blocks
// compute the queries' r1 the same way, meet once more, and each finishes
// ceil(Qn / T) of the task's query rows. The barrier is a counter and a
// generation word per task in device memory (arrive with atomicAdd, the last
// arriver resets the counter and bumps the generation); the cooperative
// launch guarantees that every block is resident, and a barrier that waits
// for seconds traps rather than hangs. The support rows X are read from
// device memory (L2) twice per step, by the layer-1 forward and by the W1
// update; each thread issues kLoads of those loads before it uses them.
//
// Where the private copies do not fit in shared memory (many tasks, so
// few blocks per task and many W1 rows per block) they live in a scratch
// buffer in device memory that the wrapper allocates, with the same code.
// Where not even the activations fit, the wrapper raises with the shapes.
//
// Prediction, written before this kernel's first run on the card: 1.5-5 ms
// at the flagship eval shapes (B=4: T=32, 128 blocks), against fused_adapt's
// 52 ms; each block does about 1.6 M FMAs a step, from shared memory. The
// measured time, several times that, and what it is spent on: PERF.md.
//
// Bound to PyTorch with ctypes: fused_adapt_batched_plan picks T and the
// shared memory for the card, fused_adapt_batched_launch takes data_ptr()s,
// the shapes, T, the step size and the stream, and returns the launch's
// error code.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowChunk = 8;  // W1 rows whose sums a thread keeps at once
constexpr int kLoads = 8;     // loads of X a thread issues before using them
constexpr long long kSpinLimit = 1LL << 27;  // x 64 ns sleeps: ~10 s

__host__ __device__ inline long long round4(long long x) {
  return (x + 3) & ~3LL;
}
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Dims {
  int B, S, Qn, D, H1, H2, N;
  int T;          // blocks per task
  int R;          // W1 rows per block
  int RB;         // rows of the activation buffers in shared memory
  int RG;         // rows of each task's ping-pong buffer: max(S, Qn)
  int priv_smem;  // private weight copies in shared memory (else scratch)
  int n_steps;
  float step;
};

struct Priv {  // a block's private weights
  float *w1, *b1, *w2t, *b2, *w3, *b3;
};
struct Work {  // a block's activations and gradients, in shared memory
  float *r1, *r2, *d2, *g, *d1;
};

__host__ __device__ inline long long carve_priv(const Dims& d, float* base,
                                                Priv* p) {
  const long long sizes[6] = {(long long)d.R * d.D, d.R,
                              (long long)d.H1 * d.H2, d.H2,
                              (long long)d.N * d.H2, d.N};
  float** slots[6] = {&p->w1, &p->b1, &p->w2t, &p->b2, &p->w3, &p->b3};
  long long off = 0;
  for (int i = 0; i < 6; ++i) {
    if (base != nullptr) *slots[i] = base + off;
    off += round4(sizes[i]);
  }
  return off;
}

__host__ __device__ inline long long carve_work(const Dims& d, float* base,
                                                Work* w) {
  const long long sizes[5] = {(long long)d.RB * d.H1, (long long)d.RB * d.H2,
                              (long long)d.S * d.H2, (long long)d.RB * d.N,
                              (long long)d.S * d.R};
  float** slots[5] = {&w->r1, &w->r2, &w->d2, &w->g, &w->d1};
  long long off = 0;
  for (int i = 0; i < 5; ++i) {
    if (base != nullptr) *slots[i] = base + off;
    off += round4(sizes[i]);
  }
  return off;
}

__host__ __device__ inline Dims make_dims(int B, int S, int Qn, int D, int H1,
                                          int H2, int N, int T, int priv) {
  Dims d;
  d.B = B; d.S = S; d.Qn = Qn; d.D = D; d.H1 = H1; d.H2 = H2; d.N = N;
  d.R = cdiv(H1, T);
  d.T = cdiv(H1, d.R);
  d.RB = S > cdiv(Qn, d.T) ? S : cdiv(Qn, d.T);
  d.RG = S > Qn ? S : Qn;
  d.priv_smem = priv;
  d.n_steps = 0;
  d.step = 0.f;
  return d;
}

long long smem_floats(const Dims& d) {
  Priv p;
  Work w;
  return carve_work(d, nullptr, &w) +
         (d.priv_smem ? carve_priv(d, nullptr, &p) : 0);
}

__device__ inline float sgd(float w, float step, float grad) {
  // w - step * grad, rounded twice as the reference computes it
  return __fsub_rn(w, __fmul_rn(step, grad));
}

// The T blocks of one task meet here. Each block's writes before the
// barrier are visible to the task's blocks after it.
__device__ void task_barrier(unsigned int* count, unsigned int* gen,
                             unsigned int n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* vgen = gen;
    const unsigned int mine = *vgen;
    __threadfence();
    if (atomicAdd(count, 1u) == n - 1) {
      atomicExch(count, 0u);
      __threadfence();
      atomicAdd(gen, 1u);
    } else {
      long long spins = 0;
      while (*vgen == mine) {
        __nanosleep(64);
        if (++spins > kSpinLimit) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// dst[s][h0 + r] = relu(X[s] . W1[h0 + r] + b1[h0 + r]) for s < rows,
// r < nr: one warp per row of X, the lanes splitting the D-deep sums. X
// comes from device memory (L2): each lane issues kLoads independent loads
// before it uses them, so their latencies overlap.
__device__ void rows_forward(const Dims& d, const Priv& pv, int h0, int nr,
                             const float* __restrict__ X, int rows,
                             float* dst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int s = warp; s < rows; s += kWarps) {
    const float* xs = X + (size_t)s * d.D;
    for (int r0 = 0; r0 < nr; r0 += kRowChunk) {
      float acc[kRowChunk];
#pragma unroll
      for (int i = 0; i < kRowChunk; ++i) acc[i] = 0.f;
      for (int k0 = lane; k0 < d.D; k0 += 32 * kLoads) {
        float x[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u)
          x[u] = k0 + 32 * u < d.D ? __ldg(xs + k0 + 32 * u) : 0.f;
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int k = k0 + 32 * u;
          if (k >= d.D) break;
#pragma unroll
          for (int i = 0; i < kRowChunk; ++i)
            if (r0 + i < nr)
              acc[i] = fmaf(x[u], pv.w1[(size_t)(r0 + i) * d.D + k], acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowChunk; ++i) {
        float v = acc[i];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0 && r0 + i < nr)
          __stcg(dst + (size_t)s * d.H1 + h0 + r0 + i,
                 fmaxf(v + pv.b1[r0 + i], 0.f));
      }
    }
  }
}

// wk.r1[0 .. rows) <- src rows row0 .. row0+rows, bypassing L1 (the other
// blocks of the task wrote them).
__device__ void load_r1(const Dims& d, const Work& wk, const float* src,
                        int row0, int rows) {
  const float* from = src + (size_t)row0 * d.H1;
  for (int i = threadIdx.x; i < rows * d.H1; i += kThreads)
    wk.r1[i] = __ldcg(from + i);
  __syncthreads();
}

// r2 = relu(r1 W2^T + b2) and logits = r2 W3^T + b3 for `rows` rows of
// wk.r1; logits (row stride N) in shared or device memory.
__device__ void head_forward(const Dims& d, const Priv& pv, const Work& wk,
                             int rows, float* logits) {
  const int H1 = d.H1, H2 = d.H2, N = d.N;
  for (int idx = threadIdx.x; idx < rows * H2; idx += kThreads) {
    const int j = idx % H2, s = idx / H2;
    const float* a = wk.r1 + (size_t)s * H1;
    float acc = 0.f;
    for (int k = 0; k < H1; ++k) acc = fmaf(a[k], pv.w2t[k * H2 + j], acc);
    wk.r2[s * H2 + j] = fmaxf(acc + pv.b2[j], 0.f);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * N; idx += kThreads) {
    const int n = idx % N, s = idx / N;
    float acc = 0.f;
    for (int j = 0; j < H2; ++j)
      acc = fmaf(wk.r2[s * H2 + j], pv.w3[n * H2 + j], acc);
    logits[s * N + n] = acc + pv.b3[n];
  }
  __syncthreads();
}

// Phase (B) of a step: everything after the task's full r1 is in wk.r1.
__device__ void backward_update(const Dims& d, const Priv& pv, const Work& wk,
                                int h0, int nr, const float* __restrict__ X,
                                const int* __restrict__ Y) {
  const int tid = threadIdx.x;
  const int S = d.S, D = d.D, H1 = d.H1, H2 = d.H2, N = d.N, R = d.R;
  const float step = d.step;

  head_forward(d, pv, wk, S, wk.g);

  // g = (softmax(logits) - onehot) / S, one thread per row
  for (int s = tid; s < S; s += kThreads) {
    float* row = wk.g + s * N;
    float m = row[0];
    for (int n = 1; n < N; ++n) m = fmaxf(m, row[n]);
    float sum = 0.f;
    for (int n = 0; n < N; ++n) sum += expf(row[n] - m);
    const int y = Y[s];
    for (int n = 0; n < N; ++n) {
      const float p = expf(row[n] - m) / sum;
      row[n] = (p - (n == y ? 1.f : 0.f)) / (float)S;
    }
  }
  __syncthreads();

  // dr2 = (g W3) * (a2 > 0)
  for (int idx = tid; idx < S * H2; idx += kThreads) {
    const int j = idx % H2, s = idx / H2;
    float acc = 0.f;
    for (int n = 0; n < N; ++n)
      acc = fmaf(wk.g[s * N + n], pv.w3[n * H2 + j], acc);
    wk.d2[s * H2 + j] = wk.r2[s * H2 + j] > 0.f ? acc : 0.f;
  }
  __syncthreads();

  // dr1[:, own rows] = (dr2 W2[:, rows]) * (a1 > 0), read before W2
  // changes; the W3 and b3 updates
  for (int idx = tid; idx < S * nr; idx += kThreads) {
    const int r = idx % nr, s = idx / nr;
    const float* w = pv.w2t + (size_t)(h0 + r) * H2;
    float acc = 0.f;
    for (int j = 0; j < H2; ++j) acc = fmaf(wk.d2[s * H2 + j], w[j], acc);
    wk.d1[s * R + r] = wk.r1[(size_t)s * H1 + h0 + r] > 0.f ? acc : 0.f;
  }
  for (int idx = tid; idx < N * H2; idx += kThreads) {
    const int j = idx % H2, n = idx / H2;
    float acc = 0.f;
    for (int s = 0; s < S; ++s)
      acc = fmaf(wk.g[s * N + n], wk.r2[s * H2 + j], acc);
    pv.w3[idx] = sgd(pv.w3[idx], step, acc);
  }
  for (int n = tid; n < N; n += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += wk.g[s * N + n];
    pv.b3[n] = sgd(pv.b3[n], step, acc);
  }
  __syncthreads();

  // W2 (transposed), b2, the own b1 rows and W1 rows
  for (int idx = tid; idx < H1 * H2; idx += kThreads) {
    const int j = idx % H2, h = idx / H2;
    float acc = 0.f;
    for (int s = 0; s < S; ++s)
      acc = fmaf(wk.d2[s * H2 + j], wk.r1[(size_t)s * H1 + h], acc);
    pv.w2t[idx] = sgd(pv.w2t[idx], step, acc);
  }
  for (int j = tid; j < H2; j += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += wk.d2[s * H2 + j];
    pv.b2[j] = sgd(pv.b2[j], step, acc);
  }
  for (int r = tid; r < nr; r += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += wk.d1[s * R + r];
    pv.b1[r] = sgd(pv.b1[r], step, acc);
  }
  // W1[rows] -= step * dr1[:, rows]^T X: one column k per thread, kLoads
  // rows of X loaded at once
  for (int k = tid; k < D; k += kThreads) {
    for (int r0 = 0; r0 < nr; r0 += kRowChunk) {
      float acc[kRowChunk];
#pragma unroll
      for (int i = 0; i < kRowChunk; ++i) acc[i] = 0.f;
      for (int s0 = 0; s0 < S; s0 += kLoads) {
        float x[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u)
          x[u] = s0 + u < S ? __ldg(X + (size_t)(s0 + u) * D + k) : 0.f;
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          if (s0 + u >= S) break;
          const float* dr = wk.d1 + (s0 + u) * R + r0;
#pragma unroll
          for (int i = 0; i < kRowChunk; ++i)
            if (r0 + i < nr) acc[i] = fmaf(dr[i], x[u], acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowChunk; ++i) {
        if (r0 + i < nr) {
          float* w = pv.w1 + (size_t)(r0 + i) * D + k;
          *w = sgd(*w, step, acc[i]);
        }
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
fused_adapt_batched_kernel(
    const float* __restrict__ sx, const int* __restrict__ sy,
    const float* __restrict__ qx, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const float* __restrict__ b3, float* __restrict__ out, float* rbuf,
    float* priv_scratch, unsigned int* bar, Dims d) {
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x;
  const int b = blockIdx.x / d.T, t = blockIdx.x % d.T;
  const int h0 = t * d.R;
  const int nr = min(d.R, d.H1 - h0);
  const int H1 = d.H1, H2 = d.H2, N = d.N, D = d.D;

  Work wk;
  const long long work = carve_work(d, smem, &wk);
  Priv pv;
  const long long per_block = carve_priv(d, nullptr, &pv);
  carve_priv(d,
             d.priv_smem ? smem + work
                         : priv_scratch + (size_t)blockIdx.x * per_block,
             &pv);

  // private copies: this block's W1 rows and b1 slice, all of W2
  // (transposed), b2, W3, b3
  for (size_t i = tid; i < (size_t)nr * D; i += kThreads)
    pv.w1[i] = w1[(size_t)h0 * D + i];
  for (int r = tid; r < nr; r += kThreads) pv.b1[r] = b1[h0 + r];
  for (int i = tid; i < H1 * H2; i += kThreads)
    pv.w2t[i] = w2[(size_t)(i % H2) * H1 + i / H2];
  for (int j = tid; j < H2; j += kThreads) pv.b2[j] = b2[j];
  for (int i = tid; i < N * H2; i += kThreads) pv.w3[i] = w3[i];
  for (int n = tid; n < N; n += kThreads) pv.b3[n] = b3[n];
  __syncthreads();

  const float* X = sx + (size_t)b * d.S * D;
  const int* Y = sy + (size_t)b * d.S;
  const float* Q = qx + (size_t)b * d.Qn * D;
  unsigned int* count = bar + 2 * b;
  unsigned int* gen = bar + 2 * b + 1;
  const size_t task_buf = (size_t)d.RG * H1;

  int p = 0;
  for (int it = 0; it < d.n_steps; ++it) {
    float* buf = rbuf + ((size_t)p * d.B + b) * task_buf;
    rows_forward(d, pv, h0, nr, X, d.S, buf);
    task_barrier(count, gen, (unsigned)d.T);
    load_r1(d, wk, buf, 0, d.S);
    backward_update(d, pv, wk, h0, nr, X, Y);
    p ^= 1;
  }

  // the queries through the adapted weights: r1 from every block of the
  // task, then this block's share of the query rows
  float* buf = rbuf + ((size_t)p * d.B + b) * task_buf;
  rows_forward(d, pv, h0, nr, Q, d.Qn, buf);
  task_barrier(count, gen, (unsigned)d.T);
  const int per = cdiv(d.Qn, d.T);
  const int q0 = t * per;
  const int nq = min(per, d.Qn - q0);
  if (nq > 0) {
    load_r1(d, wk, buf, q0, nq);
    head_forward(d, pv, wk, nq, out + ((size_t)b * d.Qn + q0) * N);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, of a launch with T blocks per task.
long long fused_adapt_batched_smem_bytes(int S, int Qn, int D, int H1, int H2,
                                         int N, int T, int priv_smem) {
  return 4 * smem_floats(make_dims(1, S, Qn, D, H1, H2, N, T, priv_smem));
}

// Scratch floats per block for private copies that live in device memory.
long long fused_adapt_batched_priv_floats(int D, int H1, int H2, int N,
                                          int T) {
  Priv p;
  return carve_priv(make_dims(1, 1, 1, D, H1, H2, N, T, 0), nullptr, &p);
}

// The launch for this card: the largest T (blocks per task) whose B*T
// blocks are all resident, private copies in shared memory where any T
// allows it. plan = {T, shared-memory bytes, private copies in shared
// memory}. Returns a CUDA error code; cudaErrorInvalidValue when no T fits.
int fused_adapt_batched_plan(int B, int S, int Qn, int D, int H1, int H2,
                             int N, int* plan) {
  if (B < 1 || S < 1 || Qn < 1 || D < 1 || H1 < 1 || H2 < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0, sms = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  for (int priv = 1; priv >= 0; --priv) {
    int last_T = 0;
    for (int R = 1; R <= H1; ++R) {
      const Dims d = make_dims(B, S, Qn, D, H1, H2, N, cdiv(H1, R), priv);
      if (d.T == last_T || d.R != R) continue;
      last_T = d.T;
      const long long bytes = 4 * smem_floats(d);
      if (bytes > optin) continue;
      err = cudaFuncSetAttribute(fused_adapt_batched_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes);
      if (err != cudaSuccess) return (int)err;
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_adapt_batched_kernel, kThreads, (size_t)bytes);
      if (err != cudaSuccess) return (int)err;
      if ((long long)B * d.T <= (long long)per_sm * sms) {
        plan[0] = d.T;
        plan[1] = (int)bytes;
        plan[2] = priv;
        return (int)cudaSuccess;
      }
    }
  }
  return (int)cudaErrorInvalidValue;
}

int fused_adapt_batched_launch(const float* sx, const int* sy, const float* qx,
                               const float* w1, const float* b1,
                               const float* w2, const float* b2,
                               const float* w3, const float* b3, float* out,
                               float* rbuf, float* priv_scratch,
                               unsigned int* bar, int B, int S, int Qn, int D,
                               int H1, int H2, int N, int T, int priv_smem,
                               int n_steps, float step, void* stream) {
  if (B < 1 || S < 1 || Qn < 1 || D < 1 || H1 < 1 || H2 < 1 || N < 1 ||
      T < 1 || n_steps < 0)
    return (int)cudaErrorInvalidValue;
  Dims d = make_dims(B, S, Qn, D, H1, H2, N, T, priv_smem);
  if (d.T != T) return (int)cudaErrorInvalidValue;
  d.n_steps = n_steps;
  d.step = step;
  const long long bytes = 4 * smem_floats(d);
  cudaError_t err = cudaFuncSetAttribute(
      fused_adapt_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&sx, &sy, &qx, &w1, &b1, &w2, &b2, &w3, &b3, &out,
                  &rbuf, &priv_scratch, &bar, &d};
  err = cudaLaunchCooperativeKernel((const void*)fused_adapt_batched_kernel,
                                    dim3(B * T), dim3(kThreads), args,
                                    (size_t)bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
