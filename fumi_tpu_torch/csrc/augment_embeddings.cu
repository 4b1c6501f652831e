// Multiplicative embedding jitter: out = x * (1 + U[-scale, scale)).
//
// Replaces the TPU kernel fumi_tpu/ops/pallas_kernels.py:53-87
// (_augment_kernel, wrapper augment_embeddings): the --augment jitter of the
// support embeddings of every training episode. The function is carried
// over, not the blocking. The TPU kernel draws its bits from the core's PRNG
// seeded with seed + block id, so its output depends on the block size and
// needs M % block_rows == 0. Here the bits come from Philox4x32-10 (Salmon et
// al., "Parallel random numbers: as easy as 1, 2, 3", SC'11), a counter-based
// generator: key = the 64-bit seed, counter = (c, row, 0) for the group of
// four columns 4c .. 4c+3 of a row (the row counted from row_offset, so a
// slice of a larger tensor jitters as the whole does), whose four 32-bit
// outputs jitter those four elements. The output therefore depends on the
// seed and the element's position only, never on the launch geometry, and
// any M and any D work. The mapping from bits to the jitter is the TPU
// kernel's: keep 23 mantissa bits under exponent 127 for a float u in
// [1, 2), then jitter = (u - 1.5) * (2 * scale), in [-scale, scale). Every
// float operation is an explicitly rounded intrinsic, so nvcc cannot
// contract them into an FMA: the plain PyTorch version
// (ops/kernels.py:augment_embeddings_reference) computes the same Philox
// bits in int64 tensor arithmetic and the same roundings, and the two agree
// bitwise.
//
// The seed is read from a one-element int64 tensor on the card: the sampler
// draws it from its device generator, so no value crosses to the host (the
// TPU kernel takes its seed as a prefetched scalar for the same reason).
//
// Bound on this card. The kernel reads x once and writes out once:
// 2 * M * D * 4 bytes. At the flagship support set (B=4 tasks of 5-way
// 5-shot: M = 100 rows of D = 2048 fp32) that is 1.64 MB, 0.49 us at the
// H100 SXM's 3.35 TB/s. Philox's 10 rounds cost about 20 integer operations
// per element, far under the card's integer rate at this size. The launch
// (a few microseconds) is expected to set the kernel's time.
//
// What this design does about the bound: one thread per group of four
// elements, a grid-stride loop, 16-byte loads and stores where D % 4 == 0
// and both pointers are 16-byte aligned (other widths and unaligned tensors
// take scalar accesses). Consecutive threads touch consecutive 16-byte
// words.
//
// Bound to PyTorch with ctypes: augment_embeddings_launch takes data_ptr()s,
// the shape, the row offset, 2 * scale and the stream, and returns
// cudaGetLastError().
//
// The fused entry point, gather_augment_launch. On the sampler's kernel-gather
// path the support rows come from the device-resident table, and a
// standalone jitter would read back the rows the gather has just written:
// a second launch and twice the bytes. The TPU kernel's stated aim is that
// the jitter costs no traffic beyond the tensor itself, so here it is the
// epilogue of the gather. One pass reads support row table[idx[m]] (int32
// indices; an index outside [0, R) trips a device-side assert, as in
// gather_rows.cu, and never reads outside the table: where asserts are
// compiled out the row is zeroed), widens it to fp32 in registers as the
// sampler's pixels_to_float does (fp32 passes through, bf16 widens exactly,
// uint8 becomes float(u8) * (1/255 rounded to fp32), one fp32 product),
// multiplies it by the jitter of Philox4x32-10 at counter (column group,
// row_offset + m, 0) and writes the fp32 row once. Its output is bitwise
// augment_embeddings(pixels_to_float(gather_rows(table, idx))).
//
// Bound: the gather's own bytes, M rows of the table read, M int32 indices
// read, M fp32 rows written. At the flagship support set (M = 100 of
// D = 2048 fp32) 1.64 MB, 0.49 us at 3.35 TB/s; against the two launches it
// replaces it saves one launch and the 1.64 MB of the standalone jitter.
//
// Design: a 2-D grid, x over the support rows (a grid-stride loop over m),
// y over each row's chunks of kThreads groups of four columns, so a thread
// takes one group (at D = 2048 fp32: 2 blocks a row, 200 blocks for M =
// 100, as many as the standalone jitter launches). A block loads its row's
// index, then each thread loads its group as one 16-, 8- or 4-byte word
// (fp32, bf16, uint8) where D % 4 == 0 and the table is aligned to the
// group's width, and stores it as one float4 where the output is 16-byte
// aligned; other widths take scalar accesses. The load is issued before
// the Philox rounds, so they run under it, and no thread holds a second
// group whose load would wait for the first group's rounds and store.

#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;
constexpr long long kMaxGridY = 65535;  // the card's limit on gridDim.y

constexpr unsigned kM0 = 0xD2511F53u;  // Philox4x32 multipliers
constexpr unsigned kM1 = 0xCD9E8D57u;
constexpr unsigned kW0 = 0x9E3779B9u;  // Weyl key increments
constexpr unsigned kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += kW0;
      k.y += kW1;
    }
    const unsigned hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const unsigned hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// 1 + (u - 1.5) * two_scale for u in [1, 2) from the low 23 bits, each
// operation rounded on its own as the plain version rounds it.
__device__ __forceinline__ float factor(unsigned bits, float two_scale) {
  const float u = __uint_as_float((bits & 0x7FFFFFu) | 0x3F800000u);
  return __fadd_rn(1.0f, __fmul_rn(__fsub_rn(u, 1.5f), two_scale));
}

__global__ void __launch_bounds__(kThreads)
augment_kernel(const float* __restrict__ x, const long long* __restrict__ seed,
               float* __restrict__ out, long long rows, int D,
               long long row_offset, float two_scale, int vec) {
  const unsigned long long s = (unsigned long long)seed[0];
  const uint2 key = make_uint2((unsigned)s, (unsigned)(s >> 32));
  const int per_row = (D + 3) >> 2;
  const long long groups = rows * per_row;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += (long long)gridDim.x * blockDim.x) {
    const long long r = g / per_row;
    const int c = (int)(g - r * per_row);
    const unsigned long long row = (unsigned long long)(row_offset + r);
    const uint4 bits = philox4x32_10(
        make_uint4((unsigned)c, (unsigned)row, (unsigned)(row >> 32), 0u),
        key);
    const long long i = r * D + 4 * c;
    if (vec) {  // D % 4 == 0 and 16-byte aligned pointers
      float4 v = *reinterpret_cast<const float4*>(x + i);
      v.x = __fmul_rn(v.x, factor(bits.x, two_scale));
      v.y = __fmul_rn(v.y, factor(bits.y, two_scale));
      v.z = __fmul_rn(v.z, factor(bits.z, two_scale));
      v.w = __fmul_rn(v.w, factor(bits.w, two_scale));
      *reinterpret_cast<float4*>(out + i) = v;
    } else {
      const unsigned b[4] = {bits.x, bits.y, bits.z, bits.w};
      for (int j = 0; j < 4 && 4 * c + j < D; ++j)
        out[i + j] = __fmul_rn(x[i + j], factor(b[j], two_scale));
    }
  }
}

// ---- gather, widen and jitter in one pass --------------------------------

// The table element types, by the code the launch passes.
enum TableKind { kFloat32 = 0, kBFloat16 = 1, kUInt8 = 2 };

// 1/255 rounded to fp32 once, as a Python scalar enters a float32 product
constexpr float kInv255 = (float)(1.0 / 255.0);

// pixels_to_float of one element: fp32 as it is, bf16 (its 16 bits) widened
// exactly, uint8 scaled by 1/255 in one rounded fp32 product.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(unsigned short v) {
  return __uint_as_float((unsigned)v << 16);
}
__device__ __forceinline__ float to_float(unsigned char v) {
  return __fmul_rn(__uint2float_rn(v), kInv255);
}

// Four consecutive elements, loaded as one word of their width.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 w = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
}
__device__ __forceinline__ void load4(const unsigned short* p, float v[4]) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(w.x << 16);  // little-endian: low half first
  v[1] = __uint_as_float(w.x & 0xFFFF0000u);
  v[2] = __uint_as_float(w.y << 16);
  v[3] = __uint_as_float(w.y & 0xFFFF0000u);
}
__device__ __forceinline__ void load4(const unsigned char* p, float v[4]) {
  const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = to_float((unsigned char)(w >> (8 * j)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_augment_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                      const long long* __restrict__ seed,
                      float* __restrict__ out, long long rows, long long M,
                      int D, long long row_offset, float two_scale, int vec) {
  const unsigned long long s = (unsigned long long)seed[0];
  const uint2 key = make_uint2((unsigned)s, (unsigned)(s >> 32));
  const int per_row = (D + 3) >> 2;
  for (long long m = blockIdx.x; m < M; m += gridDim.x) {
    const int r = idx[m];
    assert(r >= 0 && r < rows);
    // a bad row loads nothing and is written as zeros
    const bool ok = r >= 0 && r < rows;
    const T* src = table + (ok ? (long long)r * D : 0);
    float* dst = out + m * D;
    const unsigned long long row = (unsigned long long)(row_offset + m);
    for (int c = blockIdx.y * blockDim.x + threadIdx.x; c < per_row;
         c += gridDim.y * blockDim.x) {
      const int j0 = 4 * c;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (ok && vec) {
        load4(src + j0, v);
      } else if (ok) {
        // unrolled with a guard a lane: v stays in registers
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j0 + j < D) v[j] = to_float(__ldg(src + j0 + j));
      }
      const uint4 bits = philox4x32_10(
          make_uint4((unsigned)c, (unsigned)row, (unsigned)(row >> 32), 0u),
          key);
      const unsigned b[4] = {bits.x, bits.y, bits.z, bits.w};
      if (vec) {
        *reinterpret_cast<float4*>(dst + j0) = make_float4(
            __fmul_rn(v[0], factor(b[0], two_scale)),
            __fmul_rn(v[1], factor(b[1], two_scale)),
            __fmul_rn(v[2], factor(b[2], two_scale)),
            __fmul_rn(v[3], factor(b[3], two_scale)));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j0 + j < D)
            dst[j0 + j] = __fmul_rn(v[j], factor(b[j], two_scale));
      }
    }
  }
}

template <typename T>
int launch_gather_augment(const void* table, const int* idx,
                          const long long* seed, float* out, long long rows,
                          long long M, int D, long long row_offset,
                          float two_scale, cudaStream_t stream) {
  // x: the rows; y: the row's groups of four, one a thread
  const long long chunks = (((D + 3) >> 2) + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(M < kMaxBlocks ? M : kMaxBlocks),
                  (unsigned)(chunks < kMaxGridY ? chunks : kMaxGridY));
  // D % 4 == 0 keeps every row start aligned to a group once the table is
  const int vec = (D % 4 == 0 && (uintptr_t)table % (4 * sizeof(T)) == 0 &&
                   (uintptr_t)out % 16 == 0);
  gather_augment_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(table), idx, seed, out, rows, M, D, row_offset,
      two_scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int augment_embeddings_launch(const float* x, const long long* seed,
                              float* out, long long rows, int D,
                              long long row_offset, float two_scale,
                              void* stream) {
  if (rows < 0 || D < 0 || row_offset < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || D == 0) return (int)cudaSuccess;
  const long long groups = rows * ((D + 3) >> 2);
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const int vec = (D % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)out % 16 == 0);
  augment_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, seed, out, rows, D, row_offset, two_scale, vec);
  return (int)cudaGetLastError();
}

// out (M, D) fp32 = jitter(pixels_to_float(table[idx])); kind is a
// TableKind: 0 fp32, 1 bf16, 2 uint8.
int gather_augment_launch(const void* table, int kind, const int* idx,
                          const long long* seed, float* out, long long rows,
                          long long M, int D, long long row_offset,
                          float two_scale, void* stream) {
  if (rows < 0 || M < 0 || D < 0 || row_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || D == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kFloat32:
      return launch_gather_augment<float>(table, idx, seed, out, rows, M, D,
                                          row_offset, two_scale, s);
    case kBFloat16:
      return launch_gather_augment<unsigned short>(
          table, idx, seed, out, rows, M, D, row_offset, two_scale, s);
    case kUInt8:
      return launch_gather_augment<unsigned char>(
          table, idx, seed, out, rows, M, D, row_offset, two_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
