// BLAKE2s zero-state raw compression (the Merkle node hash, SURVEY.md A.6).
//
// Replaces frieda_tpu/ops/merkle_pallas.py::_compress16. v = [0]*8 + IV,
// t = 0, no final flag, out[i] = v[i] ^ v[i+8]. This is NOT the RFC
// BLAKE2s-256 of the message (that one preloads the parameter block into h
// and gives a different root).
//
// The 10 rounds are written out with literal SIGMA indices, so after
// inlining every message word is a register or a constant: the 12 zero
// words of a leaf fold away at compile time, as the TPU version folds them
// at trace time. Rotations are funnel shifts.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace frieda {

__device__ __forceinline__ uint32_t ror32(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

#define FRIEDA_B2S_G(a, b, c, d, x, y) \
  a = a + b + (x);                     \
  d = ror32(d ^ a, 16);                \
  c = c + d;                           \
  b = ror32(b ^ c, 12);                \
  a = a + b + (y);                     \
  d = ror32(d ^ a, 8);                 \
  c = c + d;                           \
  b = ror32(b ^ c, 7);

#define FRIEDA_B2S_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  FRIEDA_B2S_G(v0, v4, v8, v12, m[s0], m[s1])                                                 \
  FRIEDA_B2S_G(v1, v5, v9, v13, m[s2], m[s3])                                                 \
  FRIEDA_B2S_G(v2, v6, v10, v14, m[s4], m[s5])                                                \
  FRIEDA_B2S_G(v3, v7, v11, v15, m[s6], m[s7])                                                \
  FRIEDA_B2S_G(v0, v5, v10, v15, m[s8], m[s9])                                                \
  FRIEDA_B2S_G(v1, v6, v11, v12, m[s10], m[s11])                                              \
  FRIEDA_B2S_G(v2, v7, v8, v13, m[s12], m[s13])                                               \
  FRIEDA_B2S_G(v3, v4, v9, v14, m[s14], m[s15])

// m: 16 message words; out: 8 hash words.
__device__ __forceinline__ void blake2s_compress_zero(const uint32_t (&m)[16], uint32_t (&out)[8]) {
  uint32_t v0 = 0, v1 = 0, v2 = 0, v3 = 0, v4 = 0, v5 = 0, v6 = 0, v7 = 0;
  uint32_t v8 = 0x6A09E667u, v9 = 0xBB67AE85u, v10 = 0x3C6EF372u, v11 = 0xA54FF53Au;
  uint32_t v12 = 0x510E527Fu, v13 = 0x9B05688Cu, v14 = 0x1F83D9ABu, v15 = 0x5BE0CD19u;
  FRIEDA_B2S_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  FRIEDA_B2S_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
  FRIEDA_B2S_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)
  FRIEDA_B2S_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)
  FRIEDA_B2S_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)
  FRIEDA_B2S_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)
  FRIEDA_B2S_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)
  FRIEDA_B2S_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)
  FRIEDA_B2S_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)
  FRIEDA_B2S_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)
  out[0] = v0 ^ v8;
  out[1] = v1 ^ v9;
  out[2] = v2 ^ v10;
  out[3] = v3 ^ v11;
  out[4] = v4 ^ v12;
  out[5] = v5 ^ v13;
  out[6] = v6 ^ v14;
  out[7] = v7 ^ v15;
}

#undef FRIEDA_B2S_ROUND
#undef FRIEDA_B2S_G

// Parent node: H(left || right).
__device__ __forceinline__ void blake2s_hash_pair(const uint32_t (&l)[8], const uint32_t (&r)[8],
                                                  uint32_t (&out)[8]) {
  uint32_t m[16];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    m[w] = l[w];
    m[w + 8] = r[w];
  }
  blake2s_compress_zero(m, out);
}

}  // namespace frieda
