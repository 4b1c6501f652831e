// Native host-side episodic index sampler.
//
// The reference's host sampling path runs through Python/torchmeta object
// chains per episode (ref: fumi/dataset/data.py:294-581). The TPU-native
// fast path samples on-device; THIS component serves the host path (parity
// mode, CPU-only runs, and feeding remote fleets): it emits (B, N) class
// picks and (B, N, K+Q) within-class sample positions directly into caller
// buffers, using xoshiro256** and partial Fisher-Yates — no Python object
// traffic in the loop.
//
// Policy matches fumi_tpu.data.sampler.HostEpisodeSampler: N distinct
// classes per task (uniform, no replacement), K+Q distinct positions per
// chosen class from its `count` valid slots (uniform partial shuffle).
//
// Build: g++ -O3 -shared -fPIC episodic_sampler.cpp -o libepisodic.so
// (done lazily by fumi_tpu/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Xoshiro256ss {
  uint64_t s[4];

  explicit Xoshiro256ss(uint64_t seed) {
    // splitmix64 seeding
    uint64_t x = seed;
    for (int i = 0; i < 4; ++i) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }

  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }

  inline uint64_t next() {
    const uint64_t result = rotl(s[1] * 5, 7) * 9;
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }

  // unbiased bounded draw (Lemire)
  inline uint32_t bounded(uint32_t n) {
    uint64_t x = next() & 0xffffffffULL;
    uint64_t m = x * n;
    uint32_t l = static_cast<uint32_t>(m);
    if (l < n) {
      uint32_t t = (~n + 1) % n;
      while (l < t) {
        x = next() & 0xffffffffULL;
        m = x * n;
        l = static_cast<uint32_t>(m);
      }
    }
    return static_cast<uint32_t>(m >> 32);
  }
};

// partial Fisher-Yates: write a uniform `k`-subset permutation of [0, n)
// into out[0..k)
inline void partial_shuffle(Xoshiro256ss& rng, int32_t n, int32_t k,
                            std::vector<int32_t>& scratch, int32_t* out) {
  if (static_cast<int32_t>(scratch.size()) < n) scratch.resize(n);
  for (int32_t i = 0; i < n; ++i) scratch[i] = i;
  for (int32_t i = 0; i < k; ++i) {
    int32_t j = i + static_cast<int32_t>(rng.bounded(n - i));
    int32_t tmp = scratch[i];
    scratch[i] = scratch[j];
    scratch[j] = tmp;
    out[i] = scratch[i];
  }
}

}  // namespace

extern "C" {

// Sample `B` tasks: `N` distinct classes each, `KQ` distinct positions per
// class. counts: (C,) per-class valid sizes. Outputs:
//   out_class_idx: (B, N) int32
//   out_sel:       (B, N, KQ) int32 in-class positions
// `seed`/`counter` define the deterministic stream (counter advances per
// call on the Python side).
int sample_episodes(uint64_t seed, uint64_t counter, int32_t num_classes,
                    const int32_t* counts, int32_t B, int32_t N, int32_t KQ,
                    int32_t* out_class_idx, int32_t* out_sel) {
  if (N > num_classes) return -1;
  Xoshiro256ss rng(seed ^ (counter * 0x9e3779b97f4a7c15ULL + 1));
  std::vector<int32_t> scratch;
  for (int32_t b = 0; b < B; ++b) {
    int32_t* cls = out_class_idx + b * N;
    partial_shuffle(rng, num_classes, N, scratch, cls);
    for (int32_t i = 0; i < N; ++i) {
      int32_t c = cls[i];
      int32_t cnt = counts[c];
      if (cnt < KQ) return -2;  // class too small (validate_episode)
      partial_shuffle(rng, cnt, KQ, scratch,
                      out_sel + (b * N + i) * KQ);
    }
  }
  return 0;
}

// Gather rows: out[m] = table[rows[m]] for float32 tables — the host-side
// episode assembly without numpy fancy-indexing overhead.
void gather_rows_f32(const float* table, int64_t row_len,
                     const int32_t* rows, int64_t m, float* out) {
  for (int64_t i = 0; i < m; ++i) {
    std::memcpy(out + i * row_len, table + rows[i] * row_len,
                sizeof(float) * row_len);
  }
}

}  // extern "C"
