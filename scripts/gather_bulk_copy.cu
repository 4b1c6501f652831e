// The Hopper bulk-copy form of the episode gather, for the measurement in
// scripts/gather_variants.py only; the port does not build it.
//
// The same function as gather_episode_launch of
// fumi_tpu_torch/csrc/gather_rows.cu on fp32 rows without the jitter (a
// byte copy): each output row is table[idx[o]], class c's j-th index going
// to support row c*K + j or query row c*Q + j - K. One thread a row issues
// a 1-D cp.async.bulk (the TMA) of the whole row from device memory into
// its own slot of shared memory, completing on an mbarrier (complete_tx),
// waits on it, and issues a cp.async.bulk of the slot back to the output
// row. rows_per_block rows share a block (one warp), so up to 27 rows of
// 8 KiB are in flight on an SM: the TPU kernel's issue-every-copy-then-
// drain DMA pattern, done by the TMA with no registers holding the data.
// Rows must be a multiple of 16 bytes and both pointers 16-byte aligned.
// An index outside [0, R) trips a device-side assert.

#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(32)
bulk_gather_kernel(const char* __restrict__ table, const int* __restrict__ idx,
                   char* __restrict__ support, char* __restrict__ query,
                   long long rows, long long total, int P, int K,
                   int row_bytes, int rows_per_block) {
  extern __shared__ __align__(128) unsigned char slots[];
  __shared__ __align__(8) unsigned long long bars[32];
  const int lane = threadIdx.x;
  const long long o = (long long)blockIdx.x * rows_per_block + lane;
  if (lane >= rows_per_block || o >= total) return;
  const int r = __ldg(idx + o);
  const unsigned c = (unsigned)o / (unsigned)P;
  const int j = (int)((unsigned)o - c * (unsigned)P);
  const bool sup = j < K;
  const long long out_row =
      sup ? (long long)c * K + j : (long long)c * (P - K) + (j - K);
  char* dst = (sup ? support : query) + out_row * row_bytes;
  assert(r >= 0 && r < rows);
  const unsigned bar = (unsigned)__cvta_generic_to_shared(&bars[lane]);
  const unsigned buf =
      (unsigned)__cvta_generic_to_shared(slots + (size_t)lane * row_bytes);
  const char* src = table + (long long)r * row_bytes;
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(row_bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(buf),
      "l"(src), "r"(row_bytes), "r"(bar)
      : "memory");
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(0u)
        : "memory");
  }
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
                   "l"(dst),
               "r"(buf), "r"(row_bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

}  // namespace

extern "C" {

// idx (classes, K + Q) int32; support (classes * K) and query (classes * Q)
// rows of row_bytes each.
int bulk_episode_launch(const void* table, const int* idx, void* support,
                        void* query, long long rows, long long classes,
                        int K, int Q, int row_bytes, int rows_per_block,
                        void* stream) {
  const long long total = classes * (K + Q);
  if (row_bytes % 16 || (uintptr_t)table % 16 || (uintptr_t)support % 16 ||
      (uintptr_t)query % 16 || rows_per_block < 1 || rows_per_block > 32 ||
      total > (long long)UINT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (total == 0) return (int)cudaSuccess;
  const int smem = rows_per_block * row_bytes;
  static int opted_in = 48 * 1024;  // what a block may take without asking
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        bulk_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  const long long blocks = (total + rows_per_block - 1) / rows_per_block;
  bulk_gather_kernel<<<(unsigned)blocks, 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(table), idx, static_cast<char*>(support),
      static_cast<char*>(query), rows, total, K + Q, K, row_bytes,
      rows_per_block);
  return (int)cudaGetLastError();
}

}  // extern "C"
