// Row gather: out[m, :] = table[idx[m], :], bitwise.
//
// Replaces the TPU kernel fumi_tpu/ops/pallas_kernels.py:288-350
// (_gather_kernel, wrapper gather_rows), which the device episode sampler
// runs twice per episode to assemble the support and query embeddings from
// the device-resident table. Only the function is carried over: the TPU
// kernel's (R, 8, D/8) row view, its D % 1024 gate, the M % block_rows
// requirement and the scalar prefetch of the indices are Mosaic tiling, not
// semantics. This kernel takes any row width, any M >= 0 and int32 indices,
// and copies row BYTES, so one kernel serves fp32, bf16 and uint8 tables.
//
// Bound on this card. The gather must read M rows and the M indices and
// write M rows: 2*M*row_bytes + 4*M bytes, no arithmetic. At the flagship
// training shapes (D = 2048 fp32, so 8 KiB rows) the support gather
// (M = 100) moves 1.6 MB and the query gather (M = 640) 10.5 MB: 0.5 us and
// 3.1 us at the H100 SXM's 3.35 TB/s. Bytes bound it.
//
// What this design does about the bound: each thread block copies whole
// rows (a grid-stride loop over m, so any M fits one launch), and loads its
// own index; the threads of a block stream the row with 16-byte vector
// loads and stores where the row's byte width and both base pointers allow
// it (the common case: fp32 rows of a multiple of 4 values), 4-byte words
// where they are 4-byte aligned, and single bytes otherwise. Consecutive
// threads touch consecutive 16-byte words, so each warp moves 512
// contiguous bytes per instruction, and M blocks in flight keep enough
// loads outstanding to cover the memory latency. At the sampler's sizes
// the launch itself (a few microseconds) costs more than the bytes; that
// is measured in PERF.md, not designed around here.
//
// An index outside [0, R) trips a device-side assert (the launch then
// reports cudaErrorAssert at the next synchronisation) and never reads
// outside the table: where asserts are compiled out the row is zeroed.
//
// Bound to PyTorch with ctypes: gather_rows_launch takes data_ptr()s, the
// row count, M, the row width in bytes and the stream, and returns
// cudaGetLastError().

#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

template <typename Word>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const Word* __restrict__ table,
                   const int* __restrict__ idx, Word* __restrict__ out,
                   long long rows, long long M, long long row_words) {
  for (long long m = blockIdx.x; m < M; m += gridDim.x) {
    const int r = idx[m];
    assert(r >= 0 && r < rows);
    Word* dst = out + m * row_words;
    if (r < 0 || r >= rows) {
      for (long long j = threadIdx.x; j < row_words; j += blockDim.x)
        dst[j] = Word{};
      continue;
    }
    const Word* src = table + (long long)r * row_words;
    for (long long j = threadIdx.x; j < row_words; j += blockDim.x)
      dst[j] = __ldg(src + j);
  }
}

template <typename Word>
void launch(const void* table, const int* idx, void* out, long long rows,
            long long M, long long row_bytes, cudaStream_t stream) {
  const int blocks = (int)(M < kMaxBlocks ? M : kMaxBlocks);
  gather_rows_kernel<Word><<<blocks, kThreads, 0, stream>>>(
      static_cast<const Word*>(table), idx, static_cast<Word*>(out), rows, M,
      row_bytes / (long long)sizeof(Word));
}

}  // namespace

extern "C" {

// Width in bytes of the words the kernel copies for these pointers and
// this row width: 16, 4 or 1.
int gather_rows_word_bytes(const void* table, const void* out,
                           long long row_bytes) {
  const uintptr_t bits = (uintptr_t)table | (uintptr_t)out |
                         (uintptr_t)row_bytes;
  if (bits % 16 == 0) return 16;
  if (bits % 4 == 0) return 4;
  return 1;
}

int gather_rows_launch(const void* table, const int* idx, void* out,
                       long long rows, long long M, long long row_bytes,
                       void* stream) {
  if (rows < 0 || M < 0 || row_bytes < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (gather_rows_word_bytes(table, out, row_bytes)) {
    case 16:
      launch<uint4>(table, idx, out, rows, M, row_bytes, s);
      break;
    case 4:
      launch<unsigned int>(table, idx, out, rows, M, row_bytes, s);
      break;
    default:
      launch<unsigned char>(table, idx, out, rows, M, row_bytes, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
