// conv4's 3x3 convolutions (stride 1, SAME zero padding, grouped) in IEEE
// fp32 on the CUDA cores: the forward (fprop), the input gradient (dgrad)
// and the weight gradient (wgrad), each an implicit GEMM.
//
// Replaces no TPU kernel: the JAX package leaves conv4's convolutions to
// XLA (fumi_tpu/models/conv4.py: lax.conv_general_dilated). The port sent
// them to cuDNN, which has no good fp32 grouped engine at conv4's shapes:
// second-order MAML through Conv-4-64 spent ~85% of its card time in a
// legacy direct dgrad, FFT and Winograd pieces, a 32x32-tile GEMM and
// NHWC<->NCHW layout transforms, at under a quarter of the fp32 roofline.
//
// Layout. Activations are (M, H, W, G*C) in memory, the channels_last view
// of (M, G*C, H, W) that models/conv4.py:to_groups makes: group g's C
// channels of a pixel are contiguous at g*C, so no layout transform runs.
// The weight is PyTorch's (G*Cout, Cin, 3, 3), read where it lies.
//   fprop: y[p, n]  = sum_{r,s,c} x[p + (r-1, s-1), c] * w[n, c, r, s]
//   dgrad: dx[p, c] = sum_{r,s,n} gy[p + (r-1, s-1), n] * w[n, c, 2-r, 2-s]
//          (a stride-1 SAME 3x3 convolution's input gradient is again one,
//          with the window turned by 180 degrees and the channel roles
//          swapped: the same body reads the weight another way)
//   wgrad: dw[n, c, r, s] = sum_p x[p + (r-1, s-1), c] * gy[p, n]
// per group, with x read as zero outside the image.
//
// Bound on this card: operations. conv4.train's step is 1.171 TFLOP of
// these products (benchmark/costs/maml.py), 17.5 ms at 67 TFLOP/s; every
// call but block 0's forward and weight gradient (K = 27) does hundreds of
// FMAs a byte it must move. What the design does about it:
// - fprop/dgrad (conv3x3_fprop_kernel, conv3x3_dgrad_kernel): a block
//   computes TM output pixels x 64 output channels of one group; K =
//   9 * C_in is walked a tap and 32 input channels at a time, so that a
//   pixel's part of a chunk is one 128-byte line and 8 lanes copy it (a
//   chunk of 4 channels x 9 taps, 16 scattered bytes a lane, spent as
//   long in L1 requests as the FMAs took). The im2col addresses come
//   from a per-tile table of pixel offsets and tap masks; zero padding is
//   cp.async's zero fill. A small first kernel (conv3x3_fprop_wpack_kernel,
//   conv3x3_dgrad_wpack_kernel) lays the weight out tap by tap, each
//   output channel's input channels contiguous (the dgrad's with the
//   window turned and the roles swapped), so its chunk is lines too. Both
//   tiles are staged with cp.async, double buffered. A thread holds an
//   8 x 8 register tile (8 pixels, 8 channels) and runs FFMA only: per 4 k
//   it reads 8 + 8 float4 from shared memory, conflict-free, for 256
//   FMAs. TM = 128 where there are blocks enough for a wave of the
//   card, 64 below (block 3's 10 x 10 at M = 25 is latency, not FLOPs).
// - fprop with C_in <= 3 (conv3x3_fprop_narrow_kernel, block 0's images):
//   K = 27 is one chunk, gathered 4 bytes at a time; the call is bound by
//   writing its output, which a warp stores 32 contiguous bytes a pixel
//   at a time.
// - wgrad (conv3x3_wgrad_kernel): the output is small (64 x 9 * C_in a
//   group) and the reduction long (every pixel). A block owns 64 output x
//   64 input channels of one kernel row r for its three taps s (192
//   threads, an 8 x 8 tile each) and walks a share of the image rows: a
//   chunk is a run of pixels of one row (or several short rows), whose gy
//   and whose x row h + r - 1 with one pixel of halo each side are staged
//   once and read by the three taps, shifted. The positions are split
//   over enough blocks for two waves of the card; each block writes its
//   partial tile to scratch, 16 bytes a store, and
//   conv3x3_wgrad_reduce_kernel sums the partials in split order (fp64)
//   into the weight's layout. No atomics: the result is the same bits run
//   to run.
// - wgrad with C_in <= 3 (conv3x3_wgrad_narrow_kernel): 64 x 27 outputs
//   (padded to 32), bound by reading gy. A chunk's im2col rows (27 a
//   pixel, each gathering thread one pixel, its taps' bounds computed once)
//   sit in shared memory beside the pixels' gy, swizzled so that neither
//   the gather's writes nor the tile's reads collide; the same split and
//   reduce.
// - No TF32 and no tensor cores: every product is an fp32 FMA, summed in
//   fp32 registers; only the wgrad's cross-block sum is wider.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTN = 64;             // output channels a fprop/dgrad block
constexpr int kKW = 32;             // input channels a K-chunk (one tap)
constexpr int kAS = 36;             // floats a row of As and Bs: kKW, padded
constexpr int kStages = 2;          // cp.async stages of every kernel
constexpr int kWP = 48;             // wgrad: gy pixels a chunk, at most
constexpr int kWX = 96;             // wgrad: x slots a chunk, at most
constexpr int kWThreads = 192;      // wgrad: 3 taps x 64 threads
constexpr int kWTile = 3 * 64 * 3 * 64;  // wgrad: a block's partial tile
constexpr int kNP = 64;             // narrow wgrad: pixels a chunk
constexpr int kNK = 32;             // narrow wgrad: K slots (27 used)
constexpr int kNThreads = 128;
constexpr int kReduceThreads = 256;

enum Mode { kFprop = 0, kDgrad = 1, kFpropNarrow = 2 };

struct Geom {
  int M, H, W, G;
  int cin, cout;  // the weight's (G * cout, cin, 3, 3)
  long long P;    // M * H * W pixels
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async with zero fill: `ok` false writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Bit t of the result is set where tap t = 3r + s of pixel p reads inside
// the image; 0 for a pixel past the last.
__device__ __forceinline__ unsigned tap_mask(long long p, const Geom& q) {
  if (p >= q.P) return 0u;
  const int rem = (int)(p % ((long long)q.H * q.W));
  const int h = rem / q.W, w = rem - (rem / q.W) * q.W;
  unsigned m = 0u;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int hh = h + t / 3 - 1, ww = w + t % 3 - 1;
    if (hh >= 0 && hh < q.H && ww >= 0 && ww < q.W) m |= 1u << t;
  }
  return m;
}

// The pixel offset of tap t's neighbour
__device__ __forceinline__ long long tap_offset(int t, const Geom& q) {
  return (long long)(t / 3 - 1) * q.W + (t % 3 - 1);
}

// ---- fprop / dgrad: one implicit-GEMM body ---------------------------

// The weight laid out for the main loop's chunks: wp[g][t][n][c], output
// channel n's input channels c contiguous for each tap t. fprop:
// w[g*cout + n][c][t]; dgrad (the turned window, roles swapped):
// w[g*cout + c][n][8 - t]. One thread an element of wp.
template <int MODE>
__device__ __forceinline__ void wpack(const float* __restrict__ w,
                                      float* __restrict__ wp, const Geom q) {
  const int N = MODE == kDgrad ? q.cin : q.cout;
  const int CX = MODE == kDgrad ? q.cout : q.cin;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)q.G * 9 * N * CX;
  if (i >= total) return;
  const int c = (int)(i % CX), n = (int)(i / CX % N), t = (int)(i / CX / N % 9);
  const long long g = i / ((long long)CX * N * 9);
  wp[i] = MODE == kDgrad ? w[((g * q.cout + c) * q.cin + n) * 9 + 8 - t]
                         : w[((g * q.cout + n) * q.cin + c) * 9 + t];
}

__global__ void __launch_bounds__(256)
conv3x3_fprop_wpack_kernel(const float* __restrict__ w, float* __restrict__ wp,
                           Geom q) {
  wpack<kFprop>(w, wp, q);
}

__global__ void __launch_bounds__(256)
conv3x3_dgrad_wpack_kernel(const float* __restrict__ w, float* __restrict__ wp,
                           Geom q) {
  wpack<kDgrad>(w, wp, q);
}

// A block: TM pixels x kTN output channels of group blockIdx.z, the
// channel tile blockIdx.y. Thread (mg, ng) owns pixels mg + (TM/8) i and
// channels ng + 8 j. Shared memory: the tile's pixel offsets and tap masks,
// then per stage As[TM][kAS] and Bs[kTN][kAS] (rows of kKW k, padded to
// kAS floats so that the tile's float4 reads do not collide). A chunk is
// one tap t and kKW input channels: a pixel's kKW channels are one
// 128-byte line, which 8 lanes copy, and wp's rows give Bs the same; the
// narrow forward's one chunk is k = c*9 + t of all 9 * CX <= 27 k.
template <int TM, int MODE>
__device__ __forceinline__ void igemm(const float* __restrict__ x,
                                      const float* __restrict__ wt,
                                      float* __restrict__ y, const Geom q) {
  constexpr int MG = TM / 8;
  // streamed input channels and output channels of one group
  const int CX = MODE == kDgrad ? q.cout : q.cin;
  const int N = MODE == kDgrad ? q.cin : q.cout;
  const long long ldx = (long long)q.G * CX, ldy = (long long)q.G * N;
  const int g = blockIdx.z, n0 = blockIdx.y * kTN;
  const long long tile0 = (long long)blockIdx.x * TM;
  extern __shared__ __align__(16) float smem[];
  long long* poff = reinterpret_cast<long long*>(smem);
  unsigned* pmask = reinterpret_cast<unsigned*>(poff + TM);
  float* As = smem + 3 * TM;
  float* Bs = As + kStages * TM * kAS;
  const int tid = threadIdx.x, mg = tid >> 3, ng = tid & 7;

  {
    const long long pix = tile0 + tid;
    const unsigned taps = tap_mask(pix, q);
    poff[tid] = (taps ? pix * ldx : 0) + (long long)g * CX;
    pmask[tid] = taps;
  }
  __syncthreads();
  const int ncb = (CX + kKW - 1) / kKW;  // channel blocks a tap
  const int nchunks = MODE == kFpropNarrow ? 1 : 9 * ncb;

  auto load = [&](int stage, int kc) {
    float* as = As + stage * TM * kAS;
    float* bs = Bs + stage * kTN * kAS;
    if (MODE == kFpropNarrow) {
      const long long wgroup = (long long)g * q.cout * q.cin * 9;
      const unsigned taps = pmask[tid];
      const float* xp = x + poff[tid];
#pragma unroll
      for (int k = 0; k < kAS; ++k) {
        const int c = k / 9, t = k - c * 9;
        const bool ok = k < 9 * CX && ((taps >> t) & 1u);
        cp_async4(as + tid * kAS + k, ok ? xp + tap_offset(t, q) * ldx + c : x,
                  ok);
      }
      // w[n][k]: 9 * CX contiguous floats a channel
      for (int e = tid; e < kTN * kAS; e += TM) {
        const int n = e / kAS, k = e - n * kAS;
        const bool ok = k < 9 * CX && n0 + n < N;
        cp_async4(bs + e,
                  ok ? wt + wgroup + (long long)(n0 + n) * 9 * CX + k : wt, ok);
      }
      return;
    }
    const int t = kc / ncb, c0 = (kc - t * ncb) * kKW;
    const long long toff = tap_offset(t, q) * ldx + c0;
#pragma unroll
    for (int e = tid; e < TM * (kKW / 4); e += TM) {
      const int px = e / (kKW / 4), v = e % (kKW / 4);
      const bool ok = ((pmask[px] >> t) & 1u) && c0 + v * 4 < CX;
      cp_async16(as + px * kAS + v * 4, ok ? x + poff[px] + toff + v * 4 : x,
                 ok);
    }
    const float* wrow = wt + (((long long)g * 9 + t) * N + n0) * CX + c0;
#pragma unroll
    for (int e = tid; e < kTN * (kKW / 4); e += TM) {
      const int n = e / (kKW / 4), v = e % (kKW / 4);
      const bool ok = n0 + n < N && c0 + v * 4 < CX;
      cp_async16(bs + n * kAS + v * 4, ok ? wrow + (long long)n * CX + v * 4 : wt,
                 ok);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < nchunks; ++kc) {
    cp_async_wait_all();
    __syncthreads();
    if (kc + 1 < nchunks) load((kc + 1) & 1, kc + 1);
    cp_async_commit();
    const float* as = As + (kc & 1) * TM * kAS;
    const float* bs = Bs + (kc & 1) * kTN * kAS;
    // 4 k of the tile: 8 + 8 float4 from shared memory, 256 FMAs
    auto mma4 = [&](int k) {
      float4 b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = *reinterpret_cast<const float4*>(bs + (ng + 8 * j) * kAS + k);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(as + (mg + MG * i) * kAS + k);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float t = acc[i][j];
          t = fmaf(a.x, b[j].x, t);
          t = fmaf(a.y, b[j].y, t);
          t = fmaf(a.z, b[j].z, t);
          t = fmaf(a.w, b[j].w, t);
          acc[i][j] = t;
        }
      }
    };
    if (MODE == kFpropNarrow) {
      // K = 9 * CX <= 27 rounded up to 4 (zero filled); unrolled, this
      // loop spills at the registers three blocks an SM leave
#pragma unroll 1
      for (int k = 0; k < ((9 * CX + 3) & ~3); k += 4) mma4(k);
    } else {
#pragma unroll 2
      for (int k = 0; k < kKW; k += 4) mma4(k);
    }
  }

  // epilogue: a warp stores 32 contiguous bytes of each of 4 pixels
  const int nrem = N - n0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long p = tile0 + mg + MG * i;
    if (p >= q.P) continue;
    float* dst = y + p * ldy + (long long)g * N + n0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (ng + 8 * j < nrem) dst[ng + 8 * j] = acc[i][j];
  }
}

template <int TM>
__global__ void __launch_bounds__(TM, 3)
conv3x3_fprop_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                     float* __restrict__ y, Geom q) {
  igemm<TM, kFprop>(x, wp, y, q);
}

template <int TM>
__global__ void __launch_bounds__(TM, 3)
conv3x3_fprop_narrow_kernel(const float* __restrict__ x,
                            const float* __restrict__ w,
                            float* __restrict__ y, Geom q) {
  igemm<TM, kFpropNarrow>(x, w, y, q);
}

template <int TM>
__global__ void __launch_bounds__(TM, 3)
conv3x3_dgrad_kernel(const float* __restrict__ gy, const float* __restrict__ wp,
                     float* __restrict__ dx, Geom q) {
  igemm<TM, kDgrad>(gy, wp, dx, q);
}

// ---- wgrad -----------------------------------------------------------

// How a wgrad walks the pixels: a piece is `L` pixels of one image row
// (`segs` pieces a row), a chunk `R` pieces; `chunks` chunks in all over
// `splits` blocks along the positions.
struct WalkGeom {
  int L, R, segs, splits;
  long long pieces, chunks;
};

// Block (split, (tile, r), g): output channels co0..co0+63 x input
// channels ci0..ci0+63 of kernel row r, for its three taps s (threads
// 64 s .. 64 s + 63; thread (cg, xg) owns output channels cg*4 + {0..3},
// 32 + cg*4 + {0..3} and input channels xg*4 + {0..3}, 32 + xg*4 +
// {0..3}). Shared memory per stage: gs[kWP][64] (a pixel's gy) and
// xs[kWX][64] (a piece's x row, one halo pixel each side). The partial
// tile lies at [split][g][tile][r][co 64][s][ci 64].
__global__ void __launch_bounds__(kWThreads, 2)
conv3x3_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ gy,
                     float* __restrict__ part, Geom q, WalkGeom wk) {
  const int split = blockIdx.x;
  const int r = blockIdx.y % 3, tile = blockIdx.y / 3;
  const int cit_n = (q.cin + 63) / 64, tiles = cit_n * ((q.cout + 63) / 64);
  const int ci0 = (tile % cit_n) * 64, co0 = (tile / cit_n) * 64;
  const int g = blockIdx.z;
  const long long ldx = (long long)q.G * q.cin, ldg = (long long)q.G * q.cout;
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;
  float* xs = smem + kStages * kWP * 64;
  const int tid = threadIdx.x, s = tid / 64, sub = tid & 63;
  const int cg = sub >> 3, xg = sub & 7;
  const long long c_begin = split * wk.chunks / wk.splits;
  const long long c_end = (split + 1) * wk.chunks / wk.splits;
  const int L = wk.L, R = wk.R;

  // a piece's geometry once, then its pixels' 16-byte pieces of gy and of
  // the x row (32-bit arithmetic: the pieces of a call fit in an int)
  auto load = [&](int stage, long long chunk) {
    float* gst = gs + stage * kWP * 64;
    float* xst = xs + stage * kWX * 64;
    for (int j = 0; j < R; ++j) {
      const int piece = (int)(chunk * R) + j;
      const bool live = piece < wk.pieces;
      const int row = piece / wk.segs;  // image * H + h
      const int w0 = (piece - row * wk.segs) * L;
      const int hh = row % q.H + r - 1;
      const bool xrow = live && hh >= 0 && hh < q.H;
      const float* gp = gy + ((long long)row * q.W + w0) * ldg +
                        (long long)g * q.cout + co0;
      const float* xp = x + ((long long)(row + r - 1) * q.W + w0 - 1) * ldx +
                        (long long)g * q.cin + ci0;
      for (int e = tid; e < L * 16; e += kWThreads) {
        const int w = e >> 4, v = e & 15;
        const bool ok = live && w0 + w < q.W && co0 + v * 4 < q.cout;
        cp_async16(gst + (j * L + w) * 64 + v * 4,
                   ok ? gp + w * ldg + v * 4 : gy, ok);
      }
      for (int e = tid; e < (L + 2) * 16; e += kWThreads) {
        const int t = e >> 4, v = e & 15;
        const int ww = w0 - 1 + t;
        const bool ok = xrow && ww >= 0 && ww < q.W && ci0 + v * 4 < q.cin;
        cp_async16(xst + (j * (L + 2) + t) * 64 + v * 4,
                   ok ? xp + t * ldx + v * 4 : x, ok);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (c_begin < c_end) load(0, c_begin);
  cp_async_commit();
  for (long long ch = c_begin; ch < c_end; ++ch) {
    const int stage = (int)((ch - c_begin) & 1);
    cp_async_wait_all();
    __syncthreads();
    if (ch + 1 < c_end) load(stage ^ 1, ch + 1);
    cp_async_commit();
    const float* gst = gs + stage * kWP * 64;
    const float* xst = xs + stage * kWX * 64;
    for (int j = 0; j < R; ++j) {
      const int piece = (int)(ch * R) + j;
      if (piece >= wk.pieces) break;
      const int w0 = (piece % wk.segs) * L;
      const int len = q.W - w0 < L ? q.W - w0 : L;
      const float* gp = gst + j * L * 64;
      const float* xp = xst + (j * (L + 2) + s) * 64;
#pragma unroll 4
      for (int w = 0; w < len; ++w) {
        const float4 g0 = *reinterpret_cast<const float4*>(gp + w * 64 + cg * 4);
        const float4 g1 = *reinterpret_cast<const float4*>(gp + w * 64 + 32 + cg * 4);
        const float4 x0 = *reinterpret_cast<const float4*>(xp + w * 64 + xg * 4);
        const float4 x1 = *reinterpret_cast<const float4*>(xp + w * 64 + 32 + xg * 4);
        const float a[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float b[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
      }
    }
  }

  float* out = part + (((long long)split * q.G + g) * tiles + tile) * kWTile +
               (long long)r * (64 * 3 * 64) + s * 64;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int co = i < 4 ? cg * 4 + i : 32 + cg * 4 + i - 4;
    float* row = out + co * (3 * 64);
    *reinterpret_cast<float4*>(row + xg * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 32 + xg * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// Block (split, g, co tile): output channels co0..co0+63 x K = 9 * cin
// (<= 27, k = c*9 + t as the weight stores it, padded to kNK) over a
// share of the pixels, kNP a chunk. Thread (cg, kg) owns output channels
// cg*4 + {0..3} and k = kg*4 + {0..3}. Shared memory per stage: gs[kNP][64]
// and ks[kNP][kNK], a pixel's im2col row, its float4 f at f ^ (pixel & 7).
// Threads 0..kNP-1 gather a pixel's row each, the others load gy. The
// partial tile lies at [split][g][co tile][co 64][kNK].
__global__ void __launch_bounds__(kNThreads)
conv3x3_wgrad_narrow_kernel(const float* __restrict__ x,
                            const float* __restrict__ gy,
                            float* __restrict__ part, Geom q, long long chunks,
                            int splits) {
  const int split = blockIdx.x, g = blockIdx.y, cot = blockIdx.z;
  const int co0 = cot * 64;
  const long long ldx = (long long)q.G * q.cin, ldg = (long long)q.G * q.cout;
  const int K = 9 * q.cin;
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;
  float* ks = smem + kStages * kNP * 64;
  const int tid = threadIdx.x, cg = tid >> 3, kg = tid & 7;
  const long long c_begin = split * chunks / splits;
  const long long c_end = (split + 1) * chunks / splits;

  auto load = [&](int stage, long long chunk) {
    const long long p0 = chunk * kNP;
    if (tid < kNP) {
      float* row = ks + (stage * kNP + tid) * kNK;
      const long long p = p0 + tid;
      const unsigned taps = tap_mask(p, q);
      const float* xp = x + (taps ? p * ldx : 0) + (long long)g * q.cin;
#pragma unroll 4
      for (int k = 0; k < kNK; ++k) {
        const int c = k / 9, t = k - c * 9;
        const bool ok = k < K && ((taps >> t) & 1u);
        cp_async4(row + (((k >> 2) ^ (tid & 7)) << 2) + (k & 3),
                  ok ? xp + tap_offset(t, q) * ldx + c : x, ok);
      }
    } else {
      float* gst = gs + stage * kNP * 64;
      for (int e = tid - kNP; e < kNP * 16; e += kNThreads - kNP) {
        const int px = e >> 4, v = e & 15;
        const long long p = p0 + px;
        const bool ok = p < q.P && co0 + v * 4 < q.cout;
        cp_async16(gst + px * 64 + v * 4,
                   ok ? gy + p * ldg + (long long)g * q.cout + co0 + v * 4 : gy,
                   ok);
      }
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (c_begin < c_end) load(0, c_begin);
  cp_async_commit();
  for (long long ch = c_begin; ch < c_end; ++ch) {
    const int stage = (int)((ch - c_begin) & 1);
    cp_async_wait_all();
    __syncthreads();
    if (ch + 1 < c_end) load(stage ^ 1, ch + 1);
    cp_async_commit();
    const float* gst = gs + stage * kNP * 64;
    const float* kst = ks + stage * kNP * kNK;
#pragma unroll 4
    for (int px = 0; px < kNP; ++px) {
      const float4 g4 = *reinterpret_cast<const float4*>(gst + px * 64 + cg * 4);
      const float4 k4 = *reinterpret_cast<const float4*>(
          kst + px * kNK + ((kg ^ (px & 7)) << 2));
      const float a[4] = {g4.x, g4.y, g4.z, g4.w};
      const float b[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  float* out = part +
               (((long long)split * q.G + g) * gridDim.z + cot) * 64 * kNK;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(out + (cg * 4 + i) * kNK + kg * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// dw = the partials summed over the splits in split order, in fp64, each
// element put where the weight's layout keeps it. n: a split's partial
// floats; `narrow` says which kernel wrote them.
__global__ void __launch_bounds__(kReduceThreads)
conv3x3_wgrad_reduce_kernel(const float* __restrict__ part,
                            float* __restrict__ dw, long long n, int splits,
                            Geom q, int narrow) {
  const long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= n) return;
  int co, ci, t;
  long long g;
  if (narrow) {
    const int k = (int)(i % kNK);
    const long long rest = i / kNK;
    co = (int)(rest % ((q.cout + 63) / 64 * 64));
    g = rest / ((q.cout + 63) / 64 * 64);
    ci = k / 9;
    t = k - ci * 9;
    if (k >= 9 * q.cin) return;
  } else {
    const int cit_n = (q.cin + 63) / 64;
    const int tiles = cit_n * ((q.cout + 63) / 64);
    const int ci_l = (int)(i % 64), s = (int)(i / 64 % 3);
    const int co_l = (int)(i / (3 * 64) % 64), r = (int)(i / (64 * 3 * 64) % 3);
    const long long rest = i / kWTile;
    const int tile = (int)(rest % tiles);
    g = rest / tiles;
    ci = (tile % cit_n) * 64 + ci_l;
    co = (tile / cit_n) * 64 + co_l;
    t = r * 3 + s;
  }
  if (co >= q.cout || ci >= q.cin) return;
  double sum = 0.0;
  for (int sp = 0; sp < splits; ++sp) sum += (double)part[(long long)sp * n + i];
  dw[((g * q.cout + co) * q.cin + ci) * 9 + t] = (float)sum;
}

// ---- launch ----------------------------------------------------------

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

bool make_geom(int M, int H, int W, int G, int cin, int cout, Geom* q) {
  if (M < 1 || H < 1 || W < 1 || G < 1 || cin < 1 || cout < 1) return false;
  q->M = M;
  q->H = H;
  q->W = W;
  q->G = G;
  q->cin = cin;
  q->cout = cout;
  q->P = (long long)M * H * W;
  return q->P < (1LL << 40);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, dim3 block, int smem,
                   cudaStream_t s, const float* a, const float* b, float* c,
                   const Geom& q) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, block, smem, s>>>(a, b, c, q);
  return cudaGetLastError();
}

template <int TM>
int igemm_launch(int mode, const float* a, const float* w, float* out,
                 const Geom& q, cudaStream_t s) {
  const int N = mode == kDgrad ? q.cin : q.cout;
  const dim3 grid((unsigned)((q.P + TM - 1) / TM), (N + kTN - 1) / kTN, q.G);
  const int smem = (3 * TM + kStages * (TM + kTN) * kAS) * (int)sizeof(float);
  if (mode == kFprop)
    return (int)launch(conv3x3_fprop_kernel<TM>, grid, dim3(TM), smem, s, a, w,
                       out, q);
  if (mode == kFpropNarrow)
    return (int)launch(conv3x3_fprop_narrow_kernel<TM>, grid, dim3(TM), smem, s,
                       a, w, out, q);
  return (int)launch(conv3x3_dgrad_kernel<TM>, grid, dim3(TM), smem, s, a, w,
                     out, q);
}

// The entry: the weight packed into wp (not for the narrow forward, which
// reads w where it lies), then the main kernel.
int igemm_entry(int mode, const float* a, const float* w, float* wp,
                float* out, int M, int H, int W, int G, int cin, int cout,
                int tile_m, void* stream) {
  Geom q;
  if (!make_geom(M, H, W, G, cin, cout, &q) || (tile_m != 64 && tile_m != 128))
    return (int)cudaErrorInvalidValue;
  const int CX = mode == kDgrad ? cout : cin;
  if (mode == kFpropNarrow
          ? CX > 3
          : (CX % 4 != 0 || !aligned16(a) || !aligned16(wp)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode != kFpropNarrow) {
    const long long n = (long long)G * 9 * cin * cout;
    const unsigned blocks = (unsigned)((n + 255) / 256);
    if (mode == kFprop)
      conv3x3_fprop_wpack_kernel<<<blocks, 256, 0, s>>>(w, wp, q);
    else
      conv3x3_dgrad_wpack_kernel<<<blocks, 256, 0, s>>>(w, wp, q);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    w = wp;
  }
  return tile_m == 128 ? igemm_launch<128>(mode, a, w, out, q, s)
                       : igemm_launch<64>(mode, a, w, out, q, s);
}

}  // namespace

extern "C" {

// x (M, H, W, G*cin), w (G*cout, cin, 3, 3) -> y (M, H, W, G*cout).
// cin % 4 == 0 with x 16-byte aligned, or cin <= 3 (the narrow kernel).
// wp: G*9*cout*cin floats of scratch, 16-byte aligned (unused where
// cin <= 3). tile_m: 128 or 64 pixels a block.
int conv3x3_fprop_launch(const float* x, const float* w, float* wp, float* y,
                         int M, int H, int W, int G, int cin, int cout,
                         int tile_m, void* stream) {
  return igemm_entry(cin <= 3 ? kFpropNarrow : kFprop, x, w, wp, y, M, H, W,
                     G, cin, cout, tile_m, stream);
}

// gy (M, H, W, G*cout), w (G*cout, cin, 3, 3) -> dx (M, H, W, G*cin).
// cout % 4 == 0, gy 16-byte aligned; wp as for the forward.
int conv3x3_dgrad_launch(const float* gy, const float* w, float* wp,
                         float* dx, int M, int H, int W, int G, int cin,
                         int cout, int tile_m, void* stream) {
  return igemm_entry(kDgrad, gy, w, wp, dx, M, H, W, G, cin, cout, tile_m,
                     stream);
}

// Floats of one split's partial tiles (the scratch holds splits of them).
long long conv3x3_wgrad_partial_floats(int G, int cin, int cout) {
  const long long cot_n = (cout + 63) / 64, cit_n = (cin + 63) / 64;
  return cin <= 3 ? (long long)G * cot_n * 64 * kNK
                  : (long long)G * cot_n * cit_n * kWTile;
}

// x (M, H, W, G*cin), gy (M, H, W, G*cout) -> dw (G*cout, cin, 3, 3), two
// launches: the partials of `splits` blocks along the positions into
// `part` (splits * conv3x3_wgrad_partial_floats floats), then their sum.
// cout % 4 == 0 and cin % 4 == 0 or cin <= 3, x, gy and part 16-byte
// aligned. rows and piece: the pieces a chunk and the pixels a piece
// (cin % 4 == 0 only: piece <= 48, rows * piece <= 48, rows * (piece + 2)
// <= 96, rows 1 where piece < W).
int conv3x3_wgrad_launch(const float* x, const float* gy, float* dw,
                         float* part, int M, int H, int W, int G, int cin,
                         int cout, int splits, int rows, int piece,
                         void* stream) {
  Geom q;
  if (!make_geom(M, H, W, G, cin, cout, &q) || splits < 1 ||
      cout % 4 != 0 || (cin % 4 != 0 && cin > 3) || !aligned16(x) ||
      !aligned16(gy) || !aligned16(part))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int cot_n = (cout + 63) / 64;
  const bool narrow = cin <= 3;
  cudaError_t err;
  if (narrow) {
    const long long chunks = (q.P + kNP - 1) / kNP;
    if (splits > chunks) return (int)cudaErrorInvalidValue;
    const int smem = kStages * kNP * (64 + kNK) * (int)sizeof(float);
    err = cudaFuncSetAttribute(conv3x3_wgrad_narrow_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    conv3x3_wgrad_narrow_kernel<<<dim3(splits, G, cot_n), kNThreads, smem, s>>>(
        x, gy, part, q, chunks, splits);
  } else {
    WalkGeom wk;
    wk.L = piece;
    wk.R = rows;
    wk.segs = (W + piece - 1) / piece;
    if (piece < 1 || piece > kWP || rows < 1 || rows * piece > kWP ||
        rows * (piece + 2) > kWX || (rows > 1 && wk.segs > 1))
      return (int)cudaErrorInvalidValue;
    wk.pieces = (long long)M * H * wk.segs;
    wk.chunks = (wk.pieces + rows - 1) / rows;
    if (wk.chunks * rows >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    wk.splits = splits;
    if (splits > wk.chunks) return (int)cudaErrorInvalidValue;
    const int smem = kStages * (kWP + kWX) * 64 * (int)sizeof(float);
    err = cudaFuncSetAttribute(conv3x3_wgrad_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int cit_n = (cin + 63) / 64;
    conv3x3_wgrad_kernel<<<dim3(splits, 3 * cot_n * cit_n, G), kWThreads, smem,
                           s>>>(x, gy, part, q, wk);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = conv3x3_wgrad_partial_floats(G, cin, cout);
  conv3x3_wgrad_reduce_kernel<<<(unsigned)((n + kReduceThreads - 1) /
                                           kReduceThreads),
                                kReduceThreads, 0, s>>>(part, dw, n, splits, q,
                                                        narrow ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
