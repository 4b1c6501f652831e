// Fused test-time adaptation of the 2-hidden-layer MLP plus a head, one
// thread-block cluster per task, in the support set's Gram form.
//
// Replaces both TPU kernels of fumi_tpu/ops/pallas_kernels.py that compute
// this function: _fused_adapt_kernel (:113; wrappers fused_adapt,
// fused_maml_adapt, fused_fumi_adapt: a head per task) and
// _fused_adapt_batched_kernel (:353; wrapper fused_maml_adapt_batched: one
// head shared by the tasks). The JAX package needs two because a TPU core
// runs one grid program at a time; here one kernel spreads each task over a
// cluster either way, and the shared head is a per-task head at a task
// stride of 0. The function, per task: n_steps of forward -> g = (softmax -
// onehot)/S -> hand-derived backprop -> SGD on all six tensors at
// step_size; then the queries' logits through the adapted weights, which
// are all the kernel returns.
//
// The Gram form. SGD's change to W1 lies in the row space of the fixed
// support rows X (S x D): W1_t = W1_0 - step * P_t^T X, with P_t the sum of
// the steps' dr1 (S x H1). So X W1_t^T = X W1_0^T - step * G P_t with
// G = X X^T (S x S), and the queries get Q W1_T^T = Q W1_0^T -
// step * (Q X^T) P_T. The kernel never forms W1: the products that are D
// deep (A0 = X W1_0^T, G, and Q W1_0^T, Q X^T a chunk of queries at a time)
// run once, and a step's layer 1 is S*S*H1 deep instead of the forward's
// and the W1 update's 2*S*D*H1. W1 is read from device memory in those
// passes only; no step reads or writes it.
//
// Precision. G's entries are large (about D/3 for rows in [0, 1)) and
// cancel in G P: in fp32 the served logits drift by 1e-2. So G, Q X^T, P
// and the two corrections are fp64 (an fp32 x fp32 product is exact in
// fp64); a1 = fp32(A0 - step * G P) + b1. The rest is the plain loop's IEEE
// fp32: A0 and Q W1_0^T, the small layers, and the updates of W2, W3 and
// the biases, each rounded as __fsub_rn(w, __fmul_rn(step, grad)). Inputs
// and outputs are fp32; no TF32, no tensor cores.
//
// Bound on this card: operations. The roofline counts the plain loop's
// work, the function the kernel computes: a task-step
// 2*S*(2*D*H1 + 3*H1*H2 + 3*H2*N) flops, the queries
// 2*Qn*(D*H1 + H1*H2 + H2*N); at the flagship eval shapes (B=4, S=25,
// Qn=100, D=2048, H=(256, 64), N=5, 100 steps) 22.41 GFLOP, 0.3344 ms at
// the H100 SXM's 67 TFLOP/s fp32; at a served request (B=1, 128 queries)
// 0.0841 ms. The Gram form does less: (S + Qn)*D*H1 fp32 and (S + Qn)*S*D
// fp64 multiply-adds once (88 M at the served request, 1.5 of the plain
// loop's steps), then S*S*H1 fp64 and 3*S*H1*H2 + 3*S*H2*N fp32 a step.
// What is left is a chain of small dependent stages, so the kernel stays
// latency-bound, far under that count's roofline.
//
// Layout. A task gets a cluster of C blocks (C=16 at the flagship, 16 SMs
// of one GPC); block c owns columns [c*cols, (c+1)*cols) of D, cols =
// ceil(D/C): its slice of X, and of a chunk of QR query rows, k-major.
// Block c also owns HC = H1/C hidden columns (their A0, P, dr1, b1 and
// columns of W2) and JC = H2/C columns of a2. Partial sums travel as
// stores into the owner's shared memory (distributed shared memory); the
// owner adds the C partials in rank order. A D-deep pass over R rows (the
// support set once, then each query chunk), with cluster barriers between
// its parts:
//   1. each block computes its partial R x H1 product with W1_0 over its D
//      slice, GW = 256 hidden columns at a time, W1 passing through two
//      shared-memory tiles of TK rows by GW columns (one copied with
//      cp.async while the block sums over the other), and pushes each
//      hidden column's share to its owner; and its partial gram rows (R x S
//      with X, fp64);
//   2. barrier; each block sums its hidden columns, and block r / RG reads
//      gram row r's partials from every block and sums them; barrier; each
//      block reads every gram row's sum from its owner; barrier.
// A step, one stage a block barrier:
//   1. a1 = fp32(A0 - step * G P) + b1 on the own columns, r1 = relu(a1);
//   2. the partial a2 over them, pushed to the owners of a2's columns;
//      each owner sums its a2 columns, r2 = relu(a2 + b2), and pushes them
//      to every block. The two exchanges wait on mbarriers that the
//      arriving bytes complete (st.async), not on cluster barriers;
//   3. the logits, a thread a (row, class); g, a thread a (row, class);
//      dr2 = (g W3) * (a2 > 0), a thread a float4 of a row; dr1 of the own
//      hidden columns with W2 from before its update, and P += dr1, a
//      thread an entry;
//   4. the updates of W3, b3, b2 (every block the same values in the same
//      order, so the copies stay bitwise equal across the cluster), of the
//      own columns of W2 and of the own slice of b1.
// The queries take the same forward, through the chunk's gram rows Q X^T.
// Rows of the buffers that the logits read row by row are padded (H2L) so
// that their rows fall on other banks. Clusters are independent, so grid =
// B*C runs in as many waves as the card needs; at B=4 that is 64 of the
// 132 SMs, at R=1 16.
//
// Memory. What the cluster's blocks exchange (the partial sums, r2, the
// mbarriers) and the W1 tiles are in shared memory; the rest is private to
// a block and follows them there. Where it does not fit (many support rows
// of wide layers: S = 64 at D = 4096, H = (256, 64), say), the private
// buffers lie in device memory instead, in a scratch buffer the caller
// allocates (the kDevicePrivate instantiation, the same code), and the
// exchanged ones take no more shared memory than any layout of this
// function needs.
//
// Where the time goes, at a served request on an H100 (clock64() stamps,
// scripts/fused_adapt_phases.py, and kernels timed by steps; PERF.md):
// about 6 us a step, each stage 0.3-0.9 us, the exchanges' waits 0.3-0.4
// us; the five D-deep passes about 130 us, most of it the fp32 product.
//
// Plan. C, cols, TK, QR and where the private buffers live come from the
// caller (fumi_tpu_torch/ops/kernels.py:fused_adapt_plan): C = 16 where the
// card schedules such a cluster, fewer where D is small; QR = 32 query rows
// a chunk, or the support rows' where that does not fit; TK the deepest of
// 32, 16 and 8 that fits; the private buffers in shared memory wherever
// some QR and TK let them fit. fused_adapt_launch recomputes the layout and
// refuses a plan that does not match it (cudaErrorInvalidValue).
//
// Bound to PyTorch with ctypes: fused_adapt_launch takes data_ptr()s (the
// scratch buffer's too), the head strides, the shapes, the plan, the step
// size and the stream, and returns the launch's error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxCluster = 16;
// fp32 D-deep product: a thread sums a kRows x kCols tile of the partial
// a1, kSplit neighbouring lanes over interleaved rows of a W1 tile of TK
// rows of the slice (TK one of 32, 16, 8: the plan's tile_k)
constexpr int kRows = 4;
constexpr int kCols = 8;
constexpr int kSplit = 2;
// query rows a chunk at most (the plan's query_rows)
constexpr int kQueryRows = 32;
// hidden columns of a W1 tile at most: wider layers go a group of columns
// at a time, so that the tiles do not grow with H1
constexpr int kGroupCols = 256;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// x / d for 0 <= x < 2^31 as a multiply and a shift (Granlund and
// Montgomery): l = ceil(log2 d), m = floor(2^32 (2^l - d) / d) + 1, made
// on the host. The stages split their item index with it every step, where
// a division by a runtime divisor costs tens of instructions.
struct Div {
  uint32_t m, l;
};

Div make_div(int d) {
  uint32_t l = 0;
  while ((1LL << l) < d) ++l;
  return {(uint32_t)(((1ULL << 32) * ((1ULL << l) - d)) / d + 1), l};
}

__device__ __forceinline__ int operator/(int x, const Div& v) {
  const uint32_t t = __umulhi((uint32_t)x, v.m);
  return (int)((t + (uint32_t)x) >> v.l);
}

// The segments of a block's memory, in this order, each 16-byte aligned
// (offsets in floats in Dims::off; the fp64 ones hold doubles). The shared
// ones are in shared memory always: the cluster's blocks read or write
// them (distributed shared memory), or cp.async fills them. "Pushed"
// segments are written by the cluster's blocks (remote stores) before a
// cluster barrier, or an mbarrier phase they complete, and read locally
// after it. The private ones only their block touches (the owners read the
// partial gram rows after a cluster barrier); they follow the shared ones
// in shared memory, or, where they do not fit there, lie in a device-memory
// scratch buffer of Dims::priv floats a block (the kernel's kDevicePrivate
// instantiation; offsets from the buffer's start).
enum Segment {
  kW1T,   // [2][TK][LG] two tiles of the W1 slice, k-major, a group of
          //             GW hidden columns
  kPart,  // partial sums, one kind at a time: pushed, each block's partial
          //             a1 of the own columns [C][AP][HC]; the sums of the
          //             gram rows this block owns, fp64 [RG][SP]; pushed,
          //             each block's partial a2 of the own a2 columns
          //             [C][AP][JC]
  kR2,    // [AP][H2L]   pushed: relu(a2), all columns
  kMbar,  // [2]         mbarriers (u64) of forward_a2's two exchanges
  kXS,    // [DP][SP]    private from here: the block's columns of X, k-major
  kXT,    // [DP][QR]    the block's columns of a query chunk, k-major
  kA,     // [AP][HC]    A0 = X W1_0^T, own columns; a chunk's Q W1_0^T
  kR1,    // [AP][HC]    relu(a1), own hidden columns
  kD1,    // [SP][HC]    dr1, own hidden columns
  kD2,    // [SP][H2P]   dr2
  kL,     // [SP][N]     logits
  kG,     // [SP][N]     dL/dlogits
  kW2T,   // [HC][LW2]   own columns of W2, transposed
  kB1,    // [HC]        own slice of b1
  kB2,    // [H2P]
  kW3,    // [N][H2L]
  kB3,    // [N]
  kY,     // [SP]        support labels (int)
  kGram,  // [AP][SP]    fp64: the block's partial gram rows, then the sums
          //             (G = X X^T; a chunk's Q X^T)
  kP,     // [SP][HC]    fp64: P, the sum of the steps' dr1, own columns
  kSegments
};
constexpr int kFirstPrivate = kXS;

struct Dims {
  int S, Qn, D, H1, H2, N;
  int C;        // blocks per task: the cluster
  int cols;     // columns of D a block owns, ceil(D / C)
  int SP;       // support rows in whole tiles, round_up(S, kRows)
  int QR;       // query rows a chunk
  int AP;       // rows of the activation buffers, max(SP, QR)
  int TK;       // rows of a W1 tile
  int DP;       // rows of the k-major slices, round_up(cols, TK)
  int HT;       // hidden columns in whole tiles, round_up(H1, kCols)
  int GW;       // hidden columns of a W1 tile, min(HT, kGroupCols)
  int LG;       // row stride of a W1 tile: GW + 4, so that rows k and k+1
                // fall on other banks
  int HC;       // hidden columns a block owns, round_up(ceil(H1 / C), 4)
  int H2P;      // row stride of the S x H2 buffers, round_up(H2, 4)
  int JC;       // columns of a2 a block sums, round_up(ceil(H2 / C), 4)
  int LW2;      // row stride of the own W2 columns (transposed), H2P + 4
  int H2L;      // row stride of r2 and W3, H2P + 4, so that the logits'
                // rows fall on other banks
  int RG;       // gram rows a block sums, ceil(AP / C)
  Div dDP, dHC, dHQ, dQN, dJQ, dTQ, dSP, dCT, dN;  // DP, HC, HC/4, H2P/4,
                                                   // JC/4, SP/2, SP,
                                                   // GW/kCols, N
  int off[kSegments];  // segment offsets in floats: from the start of shared
                       // memory, or for the private ones under
                       // kDevicePrivate from the block's part of scratch
  long long shared;    // floats of the shared segments
  long long priv;      // floats of the private segments
  float* scratch;      // the private segments' device memory, priv floats
                       // a block (kDevicePrivate)
  int n_steps;
  float step;
  long long hw_stride, hb_stride;  // head floats per task (0: shared head)
};

Dims make_dims(int S, int Qn, int D, int H1, int H2, int N, int C,
               int TK, int QR) {
  Dims d;
  d.S = S; d.Qn = Qn; d.D = D; d.H1 = H1; d.H2 = H2; d.N = N;
  d.C = C;
  d.cols = cdiv(D, C);
  d.SP = round_up(S, kRows);
  d.QR = QR;
  d.AP = max(d.SP, d.QR);
  d.TK = TK;
  d.DP = round_up(d.cols, TK);
  d.HT = round_up(H1, kCols);
  d.GW = min(d.HT, kGroupCols);
  d.LG = d.GW + 4;
  d.HC = round_up(cdiv(H1, C), 4);
  d.H2P = round_up(H2, 4);
  d.JC = round_up(cdiv(H2, C), 4);
  d.LW2 = d.H2P + 4;
  d.H2L = d.H2P + 4;
  d.RG = cdiv(d.AP, C);
  d.dDP = make_div(d.DP);
  d.dHC = make_div(d.HC);
  d.dHQ = make_div(d.HC / 4);
  d.dQN = make_div(d.H2P / 4);
  d.dJQ = make_div(d.JC / 4);
  d.dTQ = make_div(d.SP / 2);
  d.dSP = make_div(d.SP);
  d.dCT = make_div(d.GW / kCols);
  d.dN = make_div(N);
  const long long SP = d.SP, AP = d.AP, CAP = (long long)d.C * d.AP;
  const long long sizes[kSegments] = {
      2LL * TK * d.LG, max(CAP * max(d.HC, d.JC), 2LL * d.RG * SP),
      AP * d.H2L, 4,
      d.DP * SP, (long long)d.DP * d.QR, AP * d.HC, AP * d.HC, SP * d.HC,
      SP * d.H2P, SP * d.N, SP * d.N, (long long)d.HC * d.LW2, d.HC, d.H2P,
      (long long)d.N * d.H2L, d.N, SP, 2 * AP * SP, 2 * SP * d.HC};
  long long off = 0;
  for (int i = 0; i < kSegments; ++i) {
    if (i == kFirstPrivate) {
      d.shared = off;
      off = 0;
    }
    d.off[i] = (int)off;
    off += (sizes[i] + 3) & ~3LL;
  }
  d.priv = off;
  d.scratch = nullptr;
  d.n_steps = 0;
  d.step = 0.f;
  d.hw_stride = d.hb_stride = 0;
  return d;
}

extern __shared__ float4 smem_raw[];

// A segment of this block: in shared memory, or, for a private one under
// kDevicePrivate, in the block's part of the scratch buffer. s is a
// constant where this is inlined, so the compiler knows each pointer's
// space.
template <bool kDevicePrivate, typename T = float>
__device__ __forceinline__ T* seg(const Dims& d, Segment s) {
  float* base = reinterpret_cast<float*>(smem_raw);
  if (kDevicePrivate && s >= kFirstPrivate)
    base = d.scratch + (size_t)blockIdx.x * d.priv;
  return reinterpret_cast<T*>(base + d.off[s]);
}

// The block `rank` of this cluster's copy of a private segment s (the
// owners read the partial gram rows from it).
template <bool kDevicePrivate, typename T>
__device__ __forceinline__ const T* peer_seg(const Dims& d,
                                             const cg::cluster_group& cl,
                                             Segment s, int rank) {
  T* p = seg<kDevicePrivate, T>(d, s);
  if (kDevicePrivate)
    return reinterpret_cast<const T*>(
        reinterpret_cast<float*>(p) +
        (long long)(rank - (int)cl.block_rank()) * d.priv);
  return cl.map_shared_rank(p, rank);
}

__device__ __forceinline__ float sgd(float w, float step, float grad) {
  // w - step * grad, rounded twice as the reference computes it
  return __fsub_rn(w, __fmul_rn(step, grad));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The address of p's place in the shared memory of the cluster's block
// `rank`.
__device__ __forceinline__ uint32_t peer_address(const void* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(smem_address(p)), "r"(rank));
  return remote;
}

// Stores v at the same place as p (in this block's shared memory) in the
// shared memory of the cluster's block `rank`.
__device__ __forceinline__ void st_peer4(float* p, int rank, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "r"(peer_address(p, rank)), "f"(v.x), "f"(v.y), "f"(v.z),
                  "f"(v.w)
               : "memory");
}

// The mbarriers of forward_a2: the bytes an exchange brings in complete
// a phase (st.async ... mbarrier::complete_tx), with this block's thread 0
// as the one arrival that sets them; no cluster-wide barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_address(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("{\n\t.reg .b64 state;\n\t"
               "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;"
               "\n\t}"
               :: "r"(smem_address(bar)), "r"(bytes) : "memory");
}

// Waits for the phase of this parity to complete; traps instead of
// hanging if it does not within about a second.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_address(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 "
                 "p, [%1], %2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 31)) __trap();
  }
}

// Stores v at the same place as p in the shared memory of the cluster's
// block `rank`, and completes 16 bytes of its mbarrier `bar`.
__device__ __forceinline__ void st_async4(float* p, int rank, float4 v,
                                          uint64_t* bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32"
               " [%0], {%1, %2, %3, %4}, [%5];"
               :: "r"(peer_address(p, rank)), "f"(v.x), "f"(v.y), "f"(v.z),
                  "f"(v.w), "r"(peer_address(bar, rank))
               : "memory");
}

// An asynchronous 4-byte copy from device to shared memory; zeros where
// `valid` is false (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_address(dst)), "l"(src),
                  "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// waits for all but the newest group of this thread's copies
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// sum_{c < C} src[c * stride] in rank order, float4s; the loads go out
// four at a time ahead of the adds.
__device__ __forceinline__ float4 sum_ranks(const float* src, int stride,
                                            int C) {
  float4 acc = *reinterpret_cast<const float4*>(src);
#pragma unroll 1
  for (int c0 = 1; c0 < C; c0 += 4) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = c0 + u < C ? *reinterpret_cast<const float4*>(
                              src + (c0 + u) * stride)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (c0 + u < C) acc = add4(acc, v[u]);
  }
  return acc;
}

// xT[k][r] = A[r][k0 + k] for k < kn, r < R; zero elsewhere up to RP rows
// (the padding rows and columns must add nothing). A row-major with row
// stride D.
__device__ void load_rows(const Dims& d, float* xT, int RP,
                          const float* __restrict__ A, int R, int k0,
                          int kn) {
  constexpr int kBatch = 8;  // loads in flight a thread
  const int n = RP * d.DP;
#pragma unroll 1
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads, r = e / d.dDP, k = e - r * d.DP;
      v[u] = (e < n && r < R && k < kn) ? A[(size_t)r * d.D + k0 + k] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads, r = e / d.dDP;
      if (e < n) xT[(e - r * d.DP) * RP + r] = v[u];
    }
  }
}

// Starts copying w1T[k][h] = W1[h0 + h][kb + k] for k < kn, h0 + h < H1,
// zero elsewhere (h < GW), into the tile buffer w1T. A warp reads 8
// neighbouring k of 4 rows of W1 (a 32-byte sector each) and stores them
// on 32 different banks.
__device__ void stage_w1(const Dims& d, float* w1T,
                         const float* __restrict__ w1, int kb, int kn,
                         int h0) {
  // TK / 8 (1, 2 or 4) warps side by side along k, the block's warps
  // 16 * 8 / TK groups of 4 rows apart along h
  const int kb_n = d.TK >> 3, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = (w & (kb_n - 1)) * 8 + (lane & 7);
  const int dh = (kThreads >> 5) / kb_n * 4;
  const bool k_ok = k < kn;
  float* dst = w1T + k * d.LG;
  const float* src = w1 + (size_t)h0 * d.D + kb + k;
#pragma unroll 4
  for (int h = w / kb_n * 4 + (lane >> 3); h < d.GW; h += dh) {
    const bool valid = k_ok && h0 + h < d.H1;
    cp_async4(dst + h, valid ? src + (size_t)h * d.D : w1, valid);
  }
  cp_async_commit();
}

// The partial a1[r][h] = sum_k xT[k][r] * W1[h][k0 + k] over the block's
// slice, for rows r < R (xT's row stride RP), pushed to
// ra1[rank][r][h - c*HC] of the block c that owns column h. The hidden
// columns go GW at a time; W1 passes through shared memory a tile at a
// time, the next tile's copy in flight while the block sums over this one.
// Thread pairs own a kRows x kCols tile; the two lanes sum even and odd k
// and join with one shuffle. A warp with a tile left runs whole (its idle
// lanes on a dummy tile), so the shuffle sees all its lanes; every thread
// meets every block barrier.
__device__ void layer1_partial(const Dims& d, const float* __restrict__ w1,
                               const float* xT, int RP, int R, int rank,
                               int k0, int kn) {
  float* tiles = seg<false>(d, kW1T);
  const int tile = d.TK * d.LG;
  float* ra1 = seg<false>(d, kPart);
  const int part = threadIdx.x % kSplit;
  const int ct_n = d.GW / kCols;
  const int tasks = cdiv(R, kRows) * ct_n;
  const int n_tiles = d.DP / d.TK;
#pragma unroll 1
  for (int h0 = 0; h0 < d.HT; h0 += d.GW)
  for (int t0 = 0; t0 < tasks; t0 += kThreads / kSplit) {
    const bool warp_live = t0 + (threadIdx.x & ~31) / kSplit < tasks;
    const int task = t0 + threadIdx.x / kSplit;
    const bool live = task < tasks;
    const int rt = live ? task / d.dCT : 0, ct = live ? task - rt * ct_n : 0;
    float acc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
    stage_w1(d, tiles, w1, k0, kn, h0);
#pragma unroll 1
    for (int it = 0; it < n_tiles; ++it) {
      const int kt = it * d.TK;
      if (it + 1 < n_tiles)
        stage_w1(d, tiles + ((it + 1) & 1) * tile, w1, k0 + kt + d.TK,
                 kn - kt - d.TK, h0);
      else
        cp_async_commit();  // an empty group: the wait below counts alike
      cp_async_wait_prior();
      __syncthreads();
      if (warp_live) {
        const float* xp = xT + kt * RP + rt * kRows;
        const float* wp = tiles + (it & 1) * tile + ct * kCols;
#pragma unroll 4
        for (int k = part; k < d.TK; k += kSplit) {
          const float4 a = *reinterpret_cast<const float4*>(xp + k * RP);
          const float4 w0 = *reinterpret_cast<const float4*>(wp + k * d.LG);
          const float4 w1v =
              *reinterpret_cast<const float4*>(wp + k * d.LG + 4);
          const float av[kRows] = {a.x, a.y, a.z, a.w};
          const float wv[kCols] = {w0.x,  w0.y,  w0.z,  w0.w,
                                   w1v.x, w1v.y, w1v.z, w1v.w};
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
    if (!warp_live) continue;
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
          const int h = h0 + ct * kCols + 4 * q, c = h / d.dHC;
          if (r < R && h < d.H1)
            st_peer4(ra1 + (rank * d.AP + r) * d.HC + h - c * d.HC, c,
                     make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                                 acc[i][4 * q + 2], acc[i][4 * q + 3]));
        }
      }
    }
  }
}

// The partial gram rows gram[r][t] = sum_k xT[k][r] * xs[k][t] over the
// block's slice, r < R, t < SP (zero for t >= S), in fp64 (each product of
// two floats exact), into this block's kGram: a thread a 2 x 2 tile.
template <bool kDevicePrivate>
__device__ void gram_partial(const Dims& d, const float* xT, int RP, int R) {
  const float* xs = seg<kDevicePrivate>(d, kXS);
  double* gram = seg<kDevicePrivate, double>(d, kGram);
  const int SP = d.SP, tq = SP / 2;
  const int tasks = cdiv(R, 2) * tq;
#pragma unroll 1
  for (int e = threadIdx.x; e < tasks; e += kThreads) {
    const int r = 2 * (e / d.dTQ), t = 2 * (e - r / 2 * tq);
    double a00 = 0, a01 = 0, a10 = 0, a11 = 0;
#pragma unroll 4
    for (int k = 0; k < d.DP; ++k) {
      const float2 x = *reinterpret_cast<const float2*>(xT + k * RP + r);
      const float2 y = *reinterpret_cast<const float2*>(xs + k * SP + t);
      a00 = fma((double)x.x, (double)y.x, a00);
      a01 = fma((double)x.x, (double)y.y, a01);
      a10 = fma((double)x.y, (double)y.x, a10);
      a11 = fma((double)x.y, (double)y.y, a11);
    }
    gram[r * SP + t] = a00;
    gram[r * SP + t + 1] = a01;
    if (r + 1 < R) {
      gram[(r + 1) * SP + t] = a10;
      gram[(r + 1) * SP + t + 1] = a11;
    }
  }
}

// A D-deep pass over the R rows of xT (k-major, the block's slice, row
// stride RP): the own columns of their product with W1_0, summed in rank
// order, into kA; their gram rows with X, summed in rank order, into every
// block's kGram. Block r / RG owns gram row r: it reads the row's partials
// from every block's kGram and keeps the sum in its kPart, where every
// block reads it. Three cluster barriers.
template <bool kDevicePrivate>
__device__ void deep_pass(const Dims& d, const cg::cluster_group& cluster,
                          const float* __restrict__ w1, const float* xT,
                          int RP, int R, int rank, int k0, int kn, int hn) {
  const int tid = threadIdx.x;
  const int C = d.C, SP = d.SP, AP = d.AP, HC = d.HC, RG = d.RG;
  layer1_partial(d, w1, xT, RP, R, rank, k0, kn);
  gram_partial<kDevicePrivate>(d, xT, RP, R);
  cluster.sync();
  float* part = seg<kDevicePrivate>(d, kPart);
  float* A = seg<kDevicePrivate>(d, kA);
  const int hq = HC / 4;
#pragma unroll 1
  for (int e = tid; e < R * hq; e += kThreads) {
    const int s = e / d.dHQ, q = e - s * hq;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (4 * q < hn) acc = sum_ranks(part + s * HC + 4 * q, AP * HC, C);
    *reinterpret_cast<float4*>(A + s * HC + 4 * q) = acc;
  }
  __syncthreads();
  // the own gram rows, an entry a thread: the partials in rank order, the
  // loads four ranks ahead of the adds
  double* sums = reinterpret_cast<double*>(part);
  const int r0 = rank * RG, own = max(0, min(RG, R - r0));
  auto partial = [&](int c, int i) {
    const double* p = peer_seg<kDevicePrivate, double>(d, cluster, kGram, c);
    // device memory that another SM wrote: read past this SM's L1
    return kDevicePrivate ? __ldcg(p + i) : p[i];
  };
#pragma unroll 1
  for (int e = tid; e < own * SP; e += kThreads) {
    const int rr = e / d.dSP, i = (r0 + rr) * SP + e - rr * SP;
    double v[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) v[c] = c < C ? partial(c, i) : 0.0;
    double g = v[0];
#pragma unroll
    for (int c = 1; c < kMaxCluster; ++c)
      if (c < C) g += v[c];
    sums[e] = g;
  }
  cluster.sync();
  // every gram row from its owner, two entries a thread
  double* gram = seg<kDevicePrivate, double>(d, kGram);
  const int tq = SP / 2;
#pragma unroll 1
  for (int e = tid; e < R * tq; e += kThreads) {
    const int r = e / d.dTQ, t = 2 * (e - r * tq), owner = r / RG;
    *reinterpret_cast<double2*>(gram + r * SP + t) =
        *reinterpret_cast<const double2*>(
            cluster.map_shared_rank(sums, owner) + (r - owner * RG) * SP + t);
  }
  cluster.sync();
}

// r1 = relu(fp32(A - step * gram P) + b1) on the own hidden columns of R
// rows: the layer-1 forward through the adapted W1 (gram = G for the
// support rows, Q X^T for a query chunk).
template <bool kDevicePrivate>
__device__ void layer1_gram(const Dims& d, int R, int hn) {
  const int HC = d.HC, SP = d.SP;
  const float* A = seg<kDevicePrivate>(d, kA);
  const float* b1 = seg<kDevicePrivate>(d, kB1);
  const double* gram = seg<kDevicePrivate, double>(d, kGram);
  const double* P = seg<kDevicePrivate, double>(d, kP);
  float* r1 = seg<kDevicePrivate>(d, kR1);
  const double step = (double)d.step;
#pragma unroll 1
  for (int e = threadIdx.x; e < R * HC; e += kThreads) {
    const int s = e / d.dHC, hl = e - s * HC;
    float r = 0.f;
    if (hl < hn) {
      const double* gs = gram + s * SP;
      const double* ph = P + hl;
      double acc[4] = {0, 0, 0, 0};
      int t = 0;
#pragma unroll 2
      for (; t + 3 < d.S; t += 4)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[u] = fma(gs[t + u], ph[(t + u) * HC], acc[u]);
#pragma unroll 1
      for (; t < d.S; ++t) acc[0] = fma(gs[t], ph[t * HC], acc[0]);
      const double gp = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      const float a = (float)((double)A[s * HC + hl] - step * gp);
      r = fmaxf(a + b1[hl], 0.f);
    }
    r1[s * HC + hl] = r;
  }
}

// From r1 (own hidden columns) of R rows to relu(a2) in r2, in every block
// of the cluster. Each block pushes its partial a2 to the owners of the a2
// columns; each owner sums the C partials in rank order and pushes
// relu(a2) of its columns to every block (r2). Each exchange ends when its
// bytes have arrived (the mbarriers' phase `parity`, this call's count of
// calls before it, mod 2); what it overwrites is free by then: a block
// sends the next partials only after all of this r2 reached it, so after
// every owner read these partials, and an owner sends the next r2 only
// after every block's next partials, so after every block used this r2.
template <bool kDevicePrivate>
__device__ void forward_a2(const Dims& d, int R, int rank, int hn, int j0,
                           int jn, int parity) {
  const int tid = threadIdx.x;
  const int C = d.C, AP = d.AP, HC = d.HC, JC = d.JC, H2P = d.H2P;
  const float* r1 = seg<kDevicePrivate>(d, kR1);
  float* ra2 = seg<kDevicePrivate>(d, kPart);
  float* r2 = seg<kDevicePrivate>(d, kR2);
  const float* w2T = seg<kDevicePrivate>(d, kW2T);
  const float* b2 = seg<kDevicePrivate>(d, kB2);
  uint64_t* bar = seg<kDevicePrivate, uint64_t>(d, kMbar);
  const int q_n = H2P / 4, jq = JC / 4;
  if (tid == 0) {
    // the partials of this block's quads of a2's columns from every block,
    // and r2's every quad from their owners
    const int own = max(0, min(jq, q_n - rank * jq));
    mbar_expect(bar, 16 * C * R * own);
    mbar_expect(bar + 1, 16 * R * q_n);
  }
  // the partial a2 over the own hidden columns, four columns a thread,
  // pushed to the owner of those columns of a2
#pragma unroll 1
  for (int e = tid; e < R * q_n; e += kThreads) {
    const int s = e / d.dQN, j = 4 * (e - s * q_n);
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
    const int c = (j >> 2) / d.dJQ;
    st_async4(ra2 + (rank * AP + s) * JC + j - c * JC, c, acc, bar);
  }
  mbar_wait(bar, parity);
  // the own columns of a2: sixteen lanes an item, each pushing the sum to
  // one block of the cluster
  const int peer = tid % kMaxCluster;
#pragma unroll 1
  for (int e = tid / kMaxCluster; e < R * jq; e += kThreads / kMaxCluster) {
    const int s = e / d.dJQ, q = e - s * jq;
    if (4 * q >= jn) continue;
    const float4 acc = sum_ranks(ra2 + s * JC + 4 * q, AP * JC, C);
    const float av[4] = {acc.x, acc.y, acc.z, acc.w};
    float rv[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int jl = 4 * q + t;
      rv[t] = jl < jn ? fmaxf(av[t] + b2[j0 + jl], 0.f) : 0.f;
    }
    if (peer < C)
      st_async4(r2 + s * d.H2L + j0 + 4 * q, peer,
                make_float4(rv[0], rv[1], rv[2], rv[3]), bar + 1);
  }
  mbar_wait(bar + 1, parity);
}

// sum_s a[s * sa] over s < S, in four interleaved partial sums; every
// block adds in this one order.
__device__ __forceinline__ float sum_rows(const float* a, int sa, int S) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int s = 0;
#pragma unroll 2
  for (; s + 3 < S; s += 4)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u] += a[(s + u) * sa];
#pragma unroll 1
  for (; s < S; ++s) acc[0] += a[s * sa];
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// The logits of R rows of relu(a2) into dst (row stride N), a thread a
// (row, class): the H2-deep dot product in four partial sums, one a float4
// lane, and the bias.
template <bool kDevicePrivate>
__device__ void logits(const Dims& d, int R, float* dst) {
  const float* r2 = seg<kDevicePrivate>(d, kR2);
  const float* w3 = seg<kDevicePrivate>(d, kW3);
  const float* b3 = seg<kDevicePrivate>(d, kB3);
  const int N = d.N, H2P = d.H2P;
#pragma unroll 1
  for (int e = threadIdx.x; e < R * N; e += kThreads) {
    const int s = e / d.dN, n = e - s * N;
    const float* a = r2 + s * d.H2L;
    const float* w = w3 + n * d.H2L;
    float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int j = 0; j < H2P; j += 4) {
      const float4 av = *reinterpret_cast<const float4*>(a + j);
      const float4 wv = *reinterpret_cast<const float4*>(w + j);
      p.x = fmaf(av.x, wv.x, p.x);
      p.y = fmaf(av.y, wv.y, p.y);
      p.z = fmaf(av.z, wv.z, p.z);
      p.w = fmaf(av.w, wv.w, p.w);
    }
    dst[e] = ((p.x + p.y) + (p.z + p.w)) + b3[n];
  }
}

// One adaptation step on the support rows: block-wide stages, a thread an
// output of each, with a block barrier between them.
template <bool kDevicePrivate>
__device__ void adapt_step(const Dims& d, int rank, int hn, int j0, int jn,
                           int parity) {
  const int tid = threadIdx.x;
  const int S = d.S, N = d.N, HC = d.HC, H2P = d.H2P, q_n = H2P / 4;
  const int LW2 = d.LW2, H2L = d.H2L;
  const float step = d.step;
  float* r1 = seg<kDevicePrivate>(d, kR1);
  float* d1 = seg<kDevicePrivate>(d, kD1);
  float* d2 = seg<kDevicePrivate>(d, kD2);
  const float* r2 = seg<kDevicePrivate>(d, kR2);
  const float* lg = seg<kDevicePrivate>(d, kL);
  float* g = seg<kDevicePrivate>(d, kG);
  float* w2T = seg<kDevicePrivate>(d, kW2T);
  float* b1 = seg<kDevicePrivate>(d, kB1);
  float* b2 = seg<kDevicePrivate>(d, kB2);
  float* w3 = seg<kDevicePrivate>(d, kW3);
  float* b3 = seg<kDevicePrivate>(d, kB3);
  double* P = seg<kDevicePrivate, double>(d, kP);
  const int* y = reinterpret_cast<const int*>(seg<kDevicePrivate>(d, kY));

  layer1_gram<kDevicePrivate>(d, S, hn);
  __syncthreads();
  forward_a2<kDevicePrivate>(d, S, rank, hn, j0, jn, parity);
  logits<kDevicePrivate>(d, S, seg<kDevicePrivate>(d, kL));
  __syncthreads();
  // g = (softmax - onehot) / S, a thread a (row, class); the max and the
  // sum over the row's classes in order
#pragma unroll 1
  for (int e = tid; e < S * N; e += kThreads) {
    const int s = e / d.dN, n = e - s * N;
    const float* l = lg + s * N;
    float m = l[0];
#pragma unroll 1
    for (int c = 1; c < N; ++c) m = fmaxf(m, l[c]);
    float sum = 0.f;
#pragma unroll 1
    for (int c = 0; c < N; ++c) sum += expf(l[c] - m);
    const float p = expf(l[n] - m) / sum;
    g[e] = (p - (n == y[s] ? 1.f : 0.f)) / (float)S;
  }
  __syncthreads();
  // dr2 = (g W3) * (a2 > 0), a thread a float4 of a row; the padding
  // columns of r2 are 0, so dr2 is 0 there and the sums over H2P below add
  // nothing for them
#pragma unroll 1
  for (int e = tid; e < S * q_n; e += kThreads) {
    const int s = e / d.dQN, j = 4 * (e - s * q_n);
    const float* gs = g + s * N;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const float gn = gs[n];
      const float4 wv = *reinterpret_cast<const float4*>(w3 + n * H2L + j);
      acc.x = fmaf(gn, wv.x, acc.x);
      acc.y = fmaf(gn, wv.y, acc.y);
      acc.z = fmaf(gn, wv.z, acc.z);
      acc.w = fmaf(gn, wv.w, acc.w);
    }
    const float4 rv = *reinterpret_cast<const float4*>(r2 + s * H2L + j);
    *reinterpret_cast<float4*>(d2 + s * H2P + j) =
        make_float4(rv.x > 0.f ? acc.x : 0.f, rv.y > 0.f ? acc.y : 0.f,
                    rv.z > 0.f ? acc.z : 0.f, rv.w > 0.f ? acc.w : 0.f);
  }
  __syncthreads();
  // dr1 of the own hidden columns = (dr2 W2) * (a1 > 0) with W2 from
  // before its update, a thread an entry; P += dr1
#pragma unroll 1
  for (int e = tid; e < S * HC; e += kThreads) {
    const int s = e / d.dHC, hl = e - s * HC;
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
    const float dr = r1[s * HC + hl] > 0.f ? acc : 0.f;
    d1[e] = dr;
    P[e] += (double)dr;
  }
  __syncthreads();

  // the updates that sum over the support rows, one item a thread over a
  // joint index: the own columns of W2, two hidden columns by four of a2's
  // an item; W3 and b2, four columns an item; b3 and the own slice of b1.
  // The sums over s run in order, the same in every block.
  const int hp = (hn + 1) / 2;
  const int n_w2 = hp * q_n, n_w3 = N * q_n;
  const int n_all = n_w2 + n_w3 + q_n + N + hn;
#pragma unroll 1
  for (int e = tid; e < n_all; e += kThreads) {
    if (e < n_w2) {
      const int i = e / d.dQN, hl = 2 * i, j = 4 * (e - i * q_n);
      const bool two = hl + 1 < hn;
      float4 acc0 = make_float4(0.f, 0.f, 0.f, 0.f), acc1 = acc0;
#pragma unroll 5
      for (int s = 0; s < S; ++s) {
        const float2 a = *reinterpret_cast<const float2*>(r1 + s * HC + hl);
        const float4 v = *reinterpret_cast<const float4*>(d2 + s * H2P + j);
        acc0.x = fmaf(a.x, v.x, acc0.x);
        acc0.y = fmaf(a.x, v.y, acc0.y);
        acc0.z = fmaf(a.x, v.z, acc0.z);
        acc0.w = fmaf(a.x, v.w, acc0.w);
        acc1.x = fmaf(a.y, v.x, acc1.x);
        acc1.y = fmaf(a.y, v.y, acc1.y);
        acc1.z = fmaf(a.y, v.z, acc1.z);
        acc1.w = fmaf(a.y, v.w, acc1.w);
      }
      float4* w = reinterpret_cast<float4*>(w2T + hl * LW2 + j);
      float4 wv = w[0];
      wv.x = sgd(wv.x, step, acc0.x);
      wv.y = sgd(wv.y, step, acc0.y);
      wv.z = sgd(wv.z, step, acc0.z);
      wv.w = sgd(wv.w, step, acc0.w);
      w[0] = wv;
      if (two) {
        w = reinterpret_cast<float4*>(w2T + (hl + 1) * LW2 + j);
        wv = w[0];
        wv.x = sgd(wv.x, step, acc1.x);
        wv.y = sgd(wv.y, step, acc1.y);
        wv.z = sgd(wv.z, step, acc1.z);
        wv.w = sgd(wv.w, step, acc1.w);
        w[0] = wv;
      }
    } else if (e < n_w2 + n_w3 + q_n) {
      // W3 from the g and r2 rows; b2 from the dr2 rows
      const int i = e - n_w2;
      const bool is_w3 = i < n_w3;
      const int n = is_w3 ? i / d.dQN : 0;
      const int j = 4 * (is_w3 ? i - n * q_n : i - n_w3);
      float4* w = reinterpret_cast<float4*>(is_w3 ? w3 + n * H2L + j
                                                  : b2 + j);
      const float* v = (is_w3 ? r2 : d2) + j;
      const int sv = is_w3 ? H2L : H2P;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 5
      for (int s = 0; s < S; ++s) {
        const float as = is_w3 ? g[s * N + n] : 1.f;
        const float4 vv = *reinterpret_cast<const float4*>(v + s * sv);
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
    } else if (e < n_w2 + n_w3 + q_n + N) {
      const int n = e - n_w2 - n_w3 - q_n;
      b3[n] = sgd(b3[n], step, sum_rows(g + n, N, S));
    } else {
      const int hl = e - n_w2 - n_w3 - q_n - N;
      b1[hl] = sgd(b1[hl], step, sum_rows(d1 + hl, HC, S));
    }
  }
  __syncthreads();
}

// kDevicePrivate: the private segments in device memory (d.scratch), where
// they do not fit in shared memory beside the shared ones.
template <bool kDevicePrivate>
__global__ void __launch_bounds__(kThreads, 1)
fused_adapt_kernel(const float* __restrict__ sx, const int* __restrict__ sy,
                   const float* __restrict__ qx, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, const float* __restrict__ hw,
                   const float* __restrict__ hb, float* __restrict__ out,
                   const Dims d) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / d.C;

  const int k0 = rank * d.cols;
  const int kn = max(0, min(d.cols, d.D - k0));
  const int h0 = rank * d.HC;
  const int hn = max(0, min(d.HC, d.H1 - h0));
  const int j0 = rank * d.JC;
  const int jn = max(0, min(d.JC, d.H2 - j0));
  const int H1 = d.H1, H2 = d.H2, N = d.N, HC = d.HC;

  // private copies: the own columns of W2 (transposed) and slice of b1,
  // all of b2 and the task's head; P = 0
  float* w2T = seg<kDevicePrivate>(d, kW2T);
#pragma unroll 1
  for (int e = tid; e < HC * d.LW2; e += kThreads) {
    const int hl = e / d.LW2, j = e % d.LW2;
    w2T[e] = (hl < hn && j < H2) ? w2[(size_t)j * H1 + h0 + hl] : 0.f;
  }
  float* pb1 = seg<kDevicePrivate>(d, kB1);
#pragma unroll 1
  for (int hl = tid; hl < HC; hl += kThreads)
    pb1[hl] = hl < hn ? b1[h0 + hl] : 0.f;
  float* pb2 = seg<kDevicePrivate>(d, kB2);
#pragma unroll 1
  for (int j = tid; j < d.H2P; j += kThreads) pb2[j] = j < H2 ? b2[j] : 0.f;
  float* w3 = seg<kDevicePrivate>(d, kW3);
#pragma unroll 1
  for (int e = tid; e < N * d.H2L; e += kThreads) {
    const int n = e / d.H2L, j = e % d.H2L;
    w3[e] = j < H2 ? hw[(size_t)b * d.hw_stride + n * H2 + j] : 0.f;
  }
  float* b3 = seg<kDevicePrivate>(d, kB3);
#pragma unroll 1
  for (int n = tid; n < N; n += kThreads)
    b3[n] = hb[(size_t)b * d.hb_stride + n];
  int* y = reinterpret_cast<int*>(seg<kDevicePrivate>(d, kY));
#pragma unroll 1
  for (int s = tid; s < d.S; s += kThreads) y[s] = sy[(size_t)b * d.S + s];
  double* P = seg<kDevicePrivate, double>(d, kP);
#pragma unroll 1
  for (int e = tid; e < d.SP * HC; e += kThreads) P[e] = 0;
  // forward_a2's mbarriers. The cluster's blocks touch each other's
  // shared memory only after every block has started and set them: a
  // cluster barrier, its wait after the loads of X
  uint64_t* bar = seg<kDevicePrivate, uint64_t>(d, kMbar);
  if (tid == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
  float* xs = seg<kDevicePrivate>(d, kXS);
  load_rows(d, xs, d.SP, sx + (size_t)b * d.S * d.D, d.S, k0, kn);
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");

  if (d.n_steps > 0) {
    // A0 = X W1_0^T and G = X X^T, once
    deep_pass<kDevicePrivate>(d, cluster, w1, xs, d.SP, d.S, rank, k0, kn, hn);
    for (int it = 0; it < d.n_steps; ++it)
      adapt_step<kDevicePrivate>(d, rank, hn, j0, jn, it & 1);
  }

  // the queries through the adapted weights, QR rows at a time; rank 0
  // writes the logits
  float* xT = seg<kDevicePrivate>(d, kXT);
  const float* Q = qx + (size_t)b * d.Qn * d.D;
  float* o = out + (size_t)b * d.Qn * N;
  for (int q0 = 0; q0 < d.Qn; q0 += d.QR) {
    const int R = min(d.QR, d.Qn - q0);
    __syncthreads();
    load_rows(d, xT, d.QR, Q + (size_t)q0 * d.D, R, k0, kn);
    __syncthreads();
    deep_pass<kDevicePrivate>(d, cluster, w1, xT, d.QR, R, rank, k0, kn, hn);
    layer1_gram<kDevicePrivate>(d, R, hn);
    __syncthreads();
    forward_a2<kDevicePrivate>(d, R, rank, hn, j0, jn,
                               (d.n_steps + q0 / d.QR) & 1);
    if (rank == 0) logits<kDevicePrivate>(d, R, o + (size_t)q0 * N);
  }
  // no block leaves while a peer may still read its shared memory
  cluster.sync();
}

// A block's shared memory, in floats: the shared segments, and the private
// ones unless they are in device memory.
long long shared_floats(const Dims& d, int device_private) {
  return d.shared + (device_private ? 0 : d.priv);
}

// Checks a plan against the layout; returns the dims or C = 0.
Dims checked_dims(int S, int Qn, int D, int H1, int H2, int N, int C,
                  int cols, int tile_k, int query_rows, int device_private,
                  long long smem_bytes) {
  Dims bad;
  bad.C = 0;
  if (S < 1 || Qn < 1 || D < 1 || H1 < 1 || H2 < 1 || N < 1 || C < 1 ||
      C > kMaxCluster || (tile_k != 8 && tile_k != 16 && tile_k != 32) ||
      query_rows < 1 || query_rows > kQueryRows || query_rows % kRows != 0)
    return bad;
  const Dims d =
      make_dims(S, Qn, D, H1, H2, N, C, tile_k, query_rows);
  if (cols != d.cols || 4 * shared_floats(d, device_private) != smem_bytes)
    return bad;
  // an exchange's bytes must fit an mbarrier's transaction count (they
  // do where their buffers fit in shared memory of under 1 MiB)
  const long long most = 16LL * d.AP * max(C * (d.JC / 4), d.H2P / 4);
  if (most >= (1 << 20)) return bad;
  return d;
}

// Clusters over 8 blocks, smem_bytes of shared memory a block, for the
// instantiation that keeps the private segments in device memory or not.
cudaError_t set_attributes(int smem_bytes, int device_private = 0) {
  const void* f = device_private ? (const void*)fused_adapt_kernel<true>
                                 : (const void*)fused_adapt_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      f, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
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

// Shared-memory bytes of a block under a plan (C blocks per task, W1 tiles
// of tile_k rows, query chunks of query_rows rows, the private segments in
// device memory or not).
long long fused_adapt_smem_bytes(int S, int D, int H1, int H2, int N, int C,
                                 int tile_k, int query_rows,
                                 int device_private) {
  return 4 * shared_floats(
                 make_dims(S, 1, D, H1, H2, N, C, tile_k, query_rows),
                 device_private);
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
  if (err == cudaSuccess) err = set_attributes(*smem_optin);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMaxCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)*smem_optin;
  return (int)cudaOccupancyMaxPotentialClusterSize(
      max_cluster, (const void*)fused_adapt_kernel<false>, &cfg);
}

// How many clusters of C blocks with smem_bytes each the card can hold at
// once (0: such a cluster cannot be scheduled).
int fused_adapt_active_clusters(int C, int smem_bytes, int* clusters) {
  cudaError_t err = set_attributes(smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(C, C, smem_bytes, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, (const void*)fused_adapt_kernel<false>, &cfg);
}

// One launch; with device_private, scratch holds scratch_floats floats,
// at least B * C blocks' private segments.
int fused_adapt_launch(const float* sx, const int* sy, const float* qx,
                       const float* w1, const float* b1, const float* w2,
                       const float* b2, const float* hw, const float* hb,
                       float* out, float* scratch, long long hw_stride,
                       long long hb_stride, int B, int S, int Qn, int D,
                       int H1, int H2, int N, int C, int cols, int tile_k,
                       int query_rows, int device_private,
                       long long smem_bytes, long long scratch_floats,
                       int n_steps, float step, void* stream) {
  Dims d = checked_dims(S, Qn, D, H1, H2, N, C, cols, tile_k, query_rows,
                        device_private, smem_bytes);
  if (B < 1 || n_steps < 0 || d.C == 0 ||
      (device_private &&
       (scratch == nullptr || scratch_floats < (long long)B * C * d.priv)))
    return (int)cudaErrorInvalidValue;
  d.scratch = scratch;
  if (!device_private)
    for (int i = kFirstPrivate; i < kSegments; ++i) d.off[i] += (int)d.shared;
  d.n_steps = n_steps;
  d.step = step;
  d.hw_stride = hw_stride;
  d.hb_stride = hb_stride;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      C, B * C, smem_bytes, (cudaStream_t)stream, attr);
  cudaError_t err = set_attributes((int)smem_bytes, device_private);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg,
                             device_private ? fused_adapt_kernel<true>
                                            : fused_adapt_kernel<false>,
                             sx, sy, qx, w1, b1, w2, b2, hw, hb, out, d);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
