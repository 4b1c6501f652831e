// Philox4x32-10 and the --augment jitter factor, shared by the kernels that
// jitter embeddings (augment_embeddings.cu, gather_rows.cu).
//
// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11) is counter-based: the four 32-bit outputs at a counter depend
// on the counter and the 64-bit key only, so a jittered element's bits
// depend on its position, never on the launch geometry. The plain PyTorch
// version (ops/kernels.py:philox4x32_10) computes the same rounds in int64
// tensor arithmetic.

#pragma once

#include <cuda_runtime.h>

namespace philox {

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

// The key of a seed held as one int64 on the card: its low and high words.
__device__ __forceinline__ uint2 key_of(const long long* seed) {
  const unsigned long long s = (unsigned long long)seed[0];
  return make_uint2((unsigned)s, (unsigned)(s >> 32));
}

// The bits of the four columns 4c .. 4c+3 of jitter row `row`: Philox at
// counter (c, row mod 2^32, row >> 32, 0).
__device__ __forceinline__ uint4 group_bits(unsigned c, unsigned long long row,
                                            uint2 key) {
  return philox4x32_10(
      make_uint4(c, (unsigned)row, (unsigned)(row >> 32), 0u), key);
}

// 1 + (u - 1.5) * two_scale for u in [1, 2) from the low 23 bits, each
// operation rounded on its own as the plain version rounds it (no FMA).
__device__ __forceinline__ float factor(unsigned bits, float two_scale) {
  const float u = __uint_as_float((bits & 0x7FFFFFu) | 0x3F800000u);
  return __fadd_rn(1.0f, __fmul_rn(__fsub_rn(u, 1.5f), two_scale));
}

}  // namespace philox
