// Row gathers of the episode sampler: one kernel body, three entry points.
//
// Replaces the TPU kernel fumi_tpu/ops/pallas_kernels.py:288-350
// (_gather_kernel, wrapper gather_rows), which the device episode sampler
// runs twice per episode to assemble the support and query embeddings from
// the device-resident table, and, as the epilogue of the support rows, the
// --augment jitter of fumi_tpu/ops/pallas_kernels.py:53-87
// (_augment_kernel). Only the functions are carried over: the TPU kernel's
// (R, 8, D/8) row view, its D % 1024 gate, the M % block_rows requirement
// and the scalar prefetch of the indices are Mosaic tiling, not semantics.
//
// The entry points:
// - gather_rows_launch: out[m] = table[idx[m]], the row's BYTES copied, so
//   one kernel serves fp32, bf16 and uint8 tables and keeps their dtype
//   (the TPU kernel's own function);
// - gather_augment_launch: the same rows widened to fp32 as the sampler's
//   pixels_to_float does and jittered, row m as jitter row row_offset + m;
// - gather_episode_launch: a whole episode. idx is the sampler's (C, K+Q)
//   class-major index tensor (C = B*N classes); of class c's K+Q indices
//   the first K go to support row c*K + j and the rest to query row
//   c*Q + j - K, both widened; with a seed the support rows are jittered
//   as jitter row c*K + j, exactly as gather_augment_launch jitters the
//   support indices alone, and the query rows never are.
// Widening: fp32 passes through, bf16 widens exactly, uint8 becomes
// float(u8) * (1/255 rounded to fp32), one rounded fp32 product. Jitter:
// Philox4x32-10 (philox.cuh) at counter (column group, row, 0), the four
// words jittering the group's four columns, out = x * factor, every
// operation an explicitly rounded intrinsic. The plain PyTorch versions
// (ops/kernels.py: gather_rows_reference, gather_augment_rows_reference,
// gather_episode_rows_reference) compose index_select, pixels_to_float and
// augment_embeddings_reference, and agree with these bitwise.
//
// Bound on this card. A gather must read its rows and indices once and
// write its rows once, with no arithmetic worth counting: at the flagship
// widths (D = 2048 fp32, 8 KiB rows) a train episode (100 support + 640
// query rows) moves 12.1 MB, 3.62 us at the H100 SXM's 3.35 TB/s; an eval
// episode (100 + 400) 8.2 MB, 2.45 us; the support rows alone 1.6 MB,
// 0.49 us. At these sizes a launch costs as much as the bytes, and a row
// costs its memory latency: the index load, then the row's loads, then its
// stores.
//
// What this design does about it:
// - One launch for the episode: both segments share one grid, so an
//   episode pays one launch and one dependent latency chain, not two.
// - A 2-D grid: x over the rows, y over the row's chunks of 32 * kUnroll
//   groups (a group is 4 elements widened, or one 16-, 4- or 1-byte word
//   copied), a warp a chunk and up to kWarps warps a block, all on one
//   row. At D = 2048 fp32 a row is 8 chunks, two blocks, so the train and
//   eval episodes launch 1480 and 1000 blocks, the augmented train episode
//   (4 groups a lane) 740: at least five on each of the 132 SMs.
//   Grid-stride loops take any row count and width.
// - A block finds its row without a division, so its index load issues
//   at once: every lane asks for the same word, one broadcast transaction
//   a warp. Where the row goes (support or query, which row) takes a
//   32-bit division, done while the index is on its way.
// - Every lane issues ALL its loads (kUnroll of 16 bytes at fp32) before
//   its first epilogue and store, so a row costs one dependent round trip
//   after its index.
// - The epilogue runs per segment: copy, widen, or widen and jitter; the
//   Philox rounds do not depend on the loads and run under them.
// - The groups a lane takes were measured on an H100 (PERF.md, PR 6):
//   2 where no row is jittered (4 was slower at every main-path shape: a
//   train episode 4.41 against 4.16 us) and where every row is (the
//   support rows alone: 2.47 against 2.75 us), 4 in the augmented episode
//   (4.40 against 4.85 us).
// - Widths or pointers that are not aligned to a group's width take the
//   4-byte and 1-byte words (copy) or element loads with a guard at the
//   row's end (widening).
// An index outside [0, R) trips a device-side assert (the launch then
// reports cudaErrorAssert at the next synchronisation) and never reads
// outside the table: where asserts are compiled out the row is zeroed.
//
// Bound to PyTorch with ctypes: each entry point takes data_ptr()s, the
// sizes and the stream, and returns cudaGetLastError().

#include <algorithm>
#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kWarps = 4;             // most warps a block, all on one row
constexpr int kThreads = 32 * kWarps;
// groups a lane loads before it stores: kMixedUnroll in a launch that
// jitters its support rows and copies its query rows (the augmented
// episode), kUnroll in every other (scripts/gather_variants.py)
constexpr int kUnroll = 2;
constexpr int kMixedUnroll = 4;
constexpr long long kMaxBlocks = 1 << 20;
constexpr long long kMaxGridY = 65535;  // the card's limit on gridDim.y

// The table element types, by the code the launch passes.
enum TableKind { kFloat32 = 0, kBFloat16 = 1, kUInt8 = 2 };

// Where a launch's rows come from and go. idx holds classes x P indices,
// class-major; of a class's P indices the first K are support rows, the
// other Q = P - K query rows. A one-segment gather of M rows is M classes
// of P = K = 1.
struct Layout {
  long long rows;        // R: rows of the table
  long long total;       // classes * P indices, < 2^32
  int P, K, Q;
  int D;                 // elements a row (the widening's guard)
  int stride;            // In (and Out) elements from a row to the next
  int groups;            // groups a row
  long long row_offset;  // jitter row of support row 0
};

// The byte copy: a group is one Word of the row, stored as it was loaded.
template <typename Word>
struct Copy {
  using In = Word;
  using Out = Word;
  using Reg = Word;
  __device__ static Reg zero() { return Word{}; }
  __device__ static Reg load(const Word* row, int g, const Layout&) {
    return __ldg(row + g);
  }
  __device__ static void store(Word* row, int g, const Reg& v,
                               const Layout&) {
    row[g] = v;
  }
};

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
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const unsigned short* p) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  // little-endian: the low half is the first element
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xFFFF0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xFFFF0000u));
}
__device__ __forceinline__ float4 load4(const unsigned char* p) {
  const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
  return make_float4(to_float((unsigned char)w),
                     to_float((unsigned char)(w >> 8)),
                     to_float((unsigned char)(w >> 16)),
                     to_float((unsigned char)(w >> 24)));
}

// The widening: a group is the four elements 4g .. 4g+3 of a row of T,
// widened to fp32. kVec: the group loads as one word of 4 * sizeof(T)
// bytes and stores as one float4; else element by element, guarded at the
// row's end.
template <typename T, bool kVec>
struct Widen {
  using In = T;
  using Out = float;
  using Reg = float4;
  __device__ static Reg zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static Reg load(const T* row, int g, const Layout& L) {
    const int j = 4 * g;
    if (kVec) return load4(row + j);
    Reg v = zero();
    if (j < L.D) v.x = to_float(__ldg(row + j));
    if (j + 1 < L.D) v.y = to_float(__ldg(row + j + 1));
    if (j + 2 < L.D) v.z = to_float(__ldg(row + j + 2));
    if (j + 3 < L.D) v.w = to_float(__ldg(row + j + 3));
    return v;
  }
  __device__ static void store(float* row, int g, const Reg& v,
                               const Layout& L) {
    const int j = 4 * g;
    if (kVec) {
      *reinterpret_cast<float4*>(row + j) = v;
      return;
    }
    row[j] = v.x;
    if (j + 1 < L.D) row[j + 1] = v.y;
    if (j + 2 < L.D) row[j + 2] = v.z;
    if (j + 3 < L.D) row[j + 3] = v.w;
  }
};

__device__ __forceinline__ void jitter(float4& v, uint4 bits,
                                       float two_scale) {
  v.x = __fmul_rn(v.x, philox::factor(bits.x, two_scale));
  v.y = __fmul_rn(v.y, philox::factor(bits.y, two_scale));
  v.z = __fmul_rn(v.z, philox::factor(bits.z, two_scale));
  v.w = __fmul_rn(v.w, philox::factor(bits.w, two_scale));
}

template <class Pol, int kU, bool kJitter>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const typename Pol::In* __restrict__ table,
              const int* __restrict__ idx,
              const long long* __restrict__ seed,
              typename Pol::Out* __restrict__ support,
              typename Pol::Out* __restrict__ query, const Layout L,
              const float two_scale) {
  using Reg = typename Pol::Reg;
  constexpr int kChunk = 32 * kU;  // groups a warp takes of its row
  uint2 key = make_uint2(0u, 0u);
  if (kJitter) key = philox::key_of(seed);
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int chunks = (L.groups + kChunk - 1) / kChunk;
  // x: the row, found without a division, so the index load issues at
  // once; y and the block's warps: the row's chunks
  for (long long o = blockIdx.x; o < L.total; o += gridDim.x) {
    // every lane asks for the same word: one broadcast load a warp
    const int r = __ldg(idx + o);
    // where the row goes, worked out while the index is on its way:
    // class c's j-th index is support row c*K + j, or query row c*Q + j - K
    const unsigned c = (unsigned)o / (unsigned)L.P;
    const int j = (int)((unsigned)o - c * (unsigned)L.P);
    const bool sup = j < L.K;
    const long long out_row =
        sup ? (long long)c * L.K + j : (long long)c * L.Q + (j - L.K);
    typename Pol::Out* dst = (sup ? support : query) + out_row * L.stride;
    assert(r >= 0 && r < L.rows);
    // a bad row loads nothing and is written as zeros
    const bool ok = r >= 0 && r < L.rows;
    const typename Pol::In* src = table + (ok ? (long long)r * L.stride : 0);
    for (int ch = blockIdx.y * warps + (threadIdx.x >> 5); ch < chunks;
         ch += gridDim.y * warps) {
      const int g0 = ch * kChunk + lane;
      Reg v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int g = g0 + 32 * u;
        v[u] = (ok && g < L.groups) ? Pol::load(src, g, L) : Pol::zero();
      }
      if constexpr (kJitter) {
        if (sup) {
          const unsigned long long row =
              (unsigned long long)(L.row_offset + out_row);
#pragma unroll
          for (int u = 0; u < kU; ++u)
            jitter(v[u],
                   philox::group_bits((unsigned)(g0 + 32 * u), row, key),
                   two_scale);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int g = g0 + 32 * u;
        if (g < L.groups) Pol::store(dst, g, v[u], L);
      }
    }
  }
}

Layout make_layout(long long rows, long long classes, int P, int K, int D,
                   int stride, int groups, long long row_offset) {
  return Layout{rows, classes * P, P, K, P - K, D, stride, groups,
                row_offset};
}

template <class Pol, int kU, bool kJitter>
int launch(const void* table, const int* idx, const long long* seed,
           void* support, void* query, const Layout& L, float two_scale,
           cudaStream_t stream) {
  if (L.total == 0 || L.groups == 0) return (int)cudaSuccess;
  if (L.total > (long long)UINT32_MAX) return (int)cudaErrorInvalidValue;
  // a block is up to kWarps warps on consecutive chunks of one row
  const long long chunks = (L.groups + 32 * kU - 1) / (32 * kU);
  const long long warps = std::min<long long>(kWarps, chunks);
  const dim3 grid((unsigned)std::min(L.total, kMaxBlocks),
                  (unsigned)std::min((chunks + warps - 1) / warps,
                                     kMaxGridY));
  using In = typename Pol::In;
  using Out = typename Pol::Out;
  gather_kernel<Pol, kU, kJitter><<<grid, (unsigned)(32 * warps), 0,
                                    stream>>>(
      static_cast<const In*>(table), idx, seed, static_cast<Out*>(support),
      static_cast<Out*>(query), L, two_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_widen(const void* table, const int* idx, const long long* seed,
                 float* support, float* query, long long rows,
                 long long classes, int P, int K, int D,
                 long long row_offset, float two_scale, cudaStream_t s) {
  const Layout L = make_layout(rows, classes, P, K, D, D, (D + 3) / 4,
                               row_offset);
  // D % 4 == 0 keeps every row start aligned to a group once the table is
  const bool vec = D % 4 == 0 &&
                   (uintptr_t)table % (4 * sizeof(T)) == 0 &&
                   (uintptr_t)support % 16 == 0 &&
                   (uintptr_t)query % 16 == 0;
  if (!seed)
    return vec ? launch<Widen<T, true>, kUnroll, false>(
                     table, idx, seed, support, query, L, two_scale, s)
               : launch<Widen<T, false>, kUnroll, false>(
                     table, idx, seed, support, query, L, two_scale, s);
  if (P > K)  // support rows jittered, query rows copied
    return vec ? launch<Widen<T, true>, kMixedUnroll, true>(
                     table, idx, seed, support, query, L, two_scale, s)
               : launch<Widen<T, false>, kMixedUnroll, true>(
                     table, idx, seed, support, query, L, two_scale, s);
  return vec ? launch<Widen<T, true>, kUnroll, true>(
                   table, idx, seed, support, query, L, two_scale, s)
             : launch<Widen<T, false>, kUnroll, true>(
                   table, idx, seed, support, query, L, two_scale, s);
}

int widen(const void* table, int kind, const int* idx, const long long* seed,
          float* support, float* query, long long rows, long long classes,
          int P, int K, int D, long long row_offset, float two_scale,
          cudaStream_t s) {
  switch (kind) {
    case kFloat32:
      return launch_widen<float>(table, idx, seed, support, query, rows,
                                 classes, P, K, D, row_offset, two_scale, s);
    case kBFloat16:
      return launch_widen<unsigned short>(table, idx, seed, support, query,
                                          rows, classes, P, K, D, row_offset,
                                          two_scale, s);
    case kUInt8:
      return launch_widen<unsigned char>(table, idx, seed, support, query,
                                         rows, classes, P, K, D, row_offset,
                                         two_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename Word>
int launch_copy(const void* table, const int* idx, void* out, long long rows,
                long long M, long long row_bytes, cudaStream_t s) {
  const int words = (int)(row_bytes / (long long)sizeof(Word));
  const Layout L = make_layout(rows, M, 1, 1, words, words, words, 0);
  return launch<Copy<Word>, kUnroll, false>(table, idx, nullptr, out,
                                            nullptr, L, 0.0f, s);
}

}  // namespace

extern "C" {

// out (M, row_bytes) = table[idx], byte for byte.
int gather_rows_launch(const void* table, const int* idx, void* out,
                       long long rows, long long M, long long row_bytes,
                       void* stream) {
  if (rows < 0 || M < 0 || row_bytes < 0 || row_bytes > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || row_bytes == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bits = (uintptr_t)table | (uintptr_t)out |
                         (uintptr_t)row_bytes;
  if (bits % 16 == 0)
    return launch_copy<uint4>(table, idx, out, rows, M, row_bytes, s);
  if (bits % 4 == 0)
    return launch_copy<unsigned int>(table, idx, out, rows, M, row_bytes, s);
  return launch_copy<unsigned char>(table, idx, out, rows, M, row_bytes, s);
}

// out (M, D) fp32 = jitter(pixels_to_float(table[idx])), row m jittered as
// row row_offset + m; kind is a TableKind: 0 fp32, 1 bf16, 2 uint8.
int gather_augment_launch(const void* table, int kind, const int* idx,
                          const long long* seed, float* out, long long rows,
                          long long M, int D, long long row_offset,
                          float two_scale, void* stream) {
  if (rows < 0 || M < 0 || D < 0 || row_offset < 0 || seed == nullptr)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || D == 0) return (int)cudaSuccess;
  return widen(table, kind, idx, seed, out, nullptr, rows, M, 1, 1, D,
               row_offset, two_scale, static_cast<cudaStream_t>(stream));
}

// The episode: idx (classes, K + Q) int32; support (classes * K, D) and
// query (classes * Q, D) fp32 = pixels_to_float of the rows, the support
// rows jittered where seed is not null.
int gather_episode_launch(const void* table, int kind, const int* idx,
                          const long long* seed, float* support,
                          float* query, long long rows, long long classes,
                          int K, int Q, int D, float two_scale,
                          void* stream) {
  if (rows < 0 || classes < 0 || K < 0 || Q < 0 || D < 0 ||
      (long long)K + Q > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (classes == 0 || K + Q == 0 || D == 0) return (int)cudaSuccess;
  return widen(table, kind, idx, seed, support, query, rows, classes, K + Q,
               K, D, 0, two_scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
