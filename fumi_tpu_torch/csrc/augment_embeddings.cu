// Multiplicative embedding jitter: out = x * (1 + U[-scale, scale)).
//
// Replaces the TPU kernel fumi_tpu/ops/pallas_kernels.py:53-87
// (_augment_kernel, wrapper augment_embeddings): the --augment jitter of the
// support embeddings of every training episode. The function is carried
// over, not the blocking. The TPU kernel draws its bits from the core's PRNG
// seeded with seed + block id, so its output depends on the block size and
// needs M % block_rows == 0. Here the bits come from Philox4x32-10
// (philox.cuh), a counter-based generator: key = the 64-bit seed, counter =
// (c, row, 0) for the group of four columns 4c .. 4c+3 of a row (the row
// counted from row_offset, so a slice of a larger tensor jitters as the
// whole does), whose four 32-bit outputs jitter those four elements. The
// output therefore depends on the seed and the element's position only,
// never on the launch geometry, and any M and any D work. The mapping from
// bits to the jitter is the TPU kernel's: keep 23 mantissa bits under
// exponent 127 for a float u in [1, 2), then jitter = (u - 1.5) *
// (2 * scale), in [-scale, scale). Every float operation is an explicitly
// rounded intrinsic, so nvcc cannot contract them into an FMA: the plain
// PyTorch version (ops/kernels.py:augment_embeddings_reference) computes
// the same Philox bits in int64 tensor arithmetic and the same roundings,
// and the two agree bitwise.
//
// This file is the standalone pass, run after the library gather (the
// sampler without --tpu_pallas_gather). With the kernel gather the same
// jitter is the epilogue of the episode's gather (gather_rows.cu), which
// reads each support row once and writes it once.
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

#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

__global__ void __launch_bounds__(kThreads)
augment_kernel(const float* __restrict__ x, const long long* __restrict__ seed,
               float* __restrict__ out, long long rows, int D,
               long long row_offset, float two_scale, int vec) {
  const uint2 key = philox::key_of(seed);
  const int per_row = (D + 3) >> 2;
  const long long groups = rows * per_row;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += (long long)gridDim.x * blockDim.x) {
    const long long r = g / per_row;
    const int c = (int)(g - r * per_row);
    const uint4 bits = philox::group_bits(
        (unsigned)c, (unsigned long long)(row_offset + r), key);
    const long long i = r * D + 4 * c;
    if (vec) {  // D % 4 == 0 and 16-byte aligned pointers
      float4 v = *reinterpret_cast<const float4*>(x + i);
      v.x = __fmul_rn(v.x, philox::factor(bits.x, two_scale));
      v.y = __fmul_rn(v.y, philox::factor(bits.y, two_scale));
      v.z = __fmul_rn(v.z, philox::factor(bits.z, two_scale));
      v.w = __fmul_rn(v.w, philox::factor(bits.w, two_scale));
      *reinterpret_cast<float4*>(out + i) = v;
    } else {
      const unsigned b[4] = {bits.x, bits.y, bits.z, bits.w};
      for (int j = 0; j < 4 && 4 * c + j < D; ++j)
        out[i + j] = __fmul_rn(x[i + j], philox::factor(b[j], two_scale));
    }
  }
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

}  // extern "C"
