// BLAKE2s zero-state raw compression (the Merkle node hash, SURVEY.md A.6),
// and the RFC compression of the Fiat-Shamir channel (blake2s_compress,
// below it) with the channel's hash and draw on top of it (hash_after,
// draw_felt), shared by the transcript kernel (channel.cu) and the collapse
// that ends a prover's tree (merkle.cu).
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

#include "common.cuh"

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

// RFC 7693 BLAKE2s compression of one block, for the Fiat-Shamir channel
// (csrc/channel.cu): chaining state h, byte counter t (< 2^32 here) and the
// final-block flag; out[i] = h[i] ^ v[i] ^ v[i+8]. The channel's hash is
// BLAKE2s-256 with the parameter block in h (kB2sParamIV0), unlike the Merkle
// node hash above.
__device__ __forceinline__ void blake2s_compress(const uint32_t (&h)[8], const uint32_t (&m)[16],
                                                 uint32_t t, bool final, uint32_t (&out)[8]) {
  uint32_t v0 = h[0], v1 = h[1], v2 = h[2], v3 = h[3], v4 = h[4], v5 = h[5], v6 = h[6], v7 = h[7];
  uint32_t v8 = 0x6A09E667u, v9 = 0xBB67AE85u, v10 = 0x3C6EF372u, v11 = 0xA54FF53Au;
  uint32_t v12 = 0x510E527Fu ^ t, v13 = 0x9B05688Cu, v14 = 0x1F83D9ABu ^ (final ? 0xFFFFFFFFu : 0u);
  uint32_t v15 = 0x5BE0CD19u;
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
  out[0] = h[0] ^ v0 ^ v8;
  out[1] = h[1] ^ v1 ^ v9;
  out[2] = h[2] ^ v2 ^ v10;
  out[3] = h[3] ^ v3 ^ v11;
  out[4] = h[4] ^ v4 ^ v12;
  out[5] = h[5] ^ v5 ^ v13;
  out[6] = h[6] ^ v6 ^ v14;
  out[7] = h[7] ^ v7 ^ v15;
}

// IV[0] of BLAKE2s-256 without a key: digest length 32, fanout 1, depth 1.
constexpr uint32_t kB2sParamIV0 = 0x6A09E667u ^ 0x01010020u;

__device__ __forceinline__ void param_iv(uint32_t (&h)[8]) {
  h[0] = kB2sParamIV0;
  h[1] = 0xBB67AE85u;
  h[2] = 0x3C6EF372u;
  h[3] = 0xA54FF53Au;
  h[4] = 0x510E527Fu;
  h[5] = 0x9B05688Cu;
  h[6] = 0x1F83D9ABu;
  h[7] = 0x5BE0CD19u;
}

// The channel's hash: BLAKE2s-256 of digest || payload (n_words
// little-endian u32 words after the 32 digest bytes). out may alias digest.
// Kept out of line: one copy of the compression serves every hash of a
// channel step, so the single thread that runs the step fetches its code
// once. Inlined at each call site (2-3 copies), a collapse's step took ~10
// us of a proof's graph replay on an NVIDIA H100 80GB HBM3 at 700 W, ~5.5
// us out of line, ~2.5 us with its code cached (PERF.md section 6).
static __device__ __noinline__ void hash_after(const uint32_t (&digest)[8], const uint32_t* payload, int n_words,
                                  uint32_t (&out)[8]) {
  uint32_t h[8];
  param_iv(h);
  const uint32_t len = 4u * (8u + static_cast<uint32_t>(n_words));
  const int blocks = static_cast<int>((len + 63u) / 64u);
  for (int b = 0; b < blocks; ++b) {
    uint32_t m[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int w = 16 * b + i;
      m[i] = w < 8 ? digest[w & 7] : (w - 8 < n_words ? payload[w - 8] : 0u);
    }
    const bool final = b == blocks - 1;
    uint32_t next[8];
    blake2s_compress(h, m, final ? len : 64u * static_cast<uint32_t>(b + 1), final, next);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = next[i];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = h[i];
}

// The channel's draw_felt on digest d: hash d || n_sent (8 bytes LE),
// counting n_sent up, until all 8 words are below draw_bound; alpha gets the
// first 4 reduced mod P.
static __device__ void draw_felt(const uint32_t (&d)[8], uint32_t& n_sent, uint32_t draw_bound,
                                 uint32_t* alpha) {
  uint32_t w[8];
  bool ok;
  do {
    const uint32_t v[2] = {n_sent, 0u};
    hash_after(d, v, 2, w);
    ++n_sent;
    ok = true;
#pragma unroll
    for (int i = 0; i < 8; ++i) ok &= w[i] < draw_bound;
  } while (!ok);
#pragma unroll
  for (int i = 0; i < 4; ++i) alpha[i] = w[i] >= kP ? w[i] - kP : w[i];
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
