// Host runtime of the port's verifier: the Merkle node hash and the
// multi-opening walks, with a plain C ABI loaded through ctypes
// (frieda_tpu_torch/native/__init__.py).
//
// The verifier's subset of frieda_tpu/native/src/frieda_native.cpp,
// unchanged: the raw zero-state BLAKE2s compression (SURVEY.md A.6) and the
// bottom-up walk that recomputes a root from opened leaves and a hash
// witness. tests/test_torch_verify.py holds it against the port's plain
// version (core/blake2s.compress_rows and a numpy walk).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

constexpr uint8_t SIGMA[10][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
};

inline uint32_t rotr(uint32_t x, int r) { return (x >> r) | (x << (32 - r)); }

inline void g(uint32_t v[16], int a, int b, int c, int d, uint32_t x, uint32_t y) {
  v[a] = v[a] + v[b] + x;
  v[d] = rotr(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr(v[b] ^ v[c], 12);
  v[a] = v[a] + v[b] + y;
  v[d] = rotr(v[d] ^ v[a], 8);
  v[c] = v[c] + v[d];
  v[b] = rotr(v[b] ^ v[c], 7);
}

void compress(uint32_t h[8], const uint32_t m[16], uint64_t t, bool final_block) {
  uint32_t v[16];
  std::memcpy(v, h, 32);
  std::memcpy(v + 8, IV, 32);
  v[12] ^= static_cast<uint32_t>(t);
  v[13] ^= static_cast<uint32_t>(t >> 32);
  if (final_block) v[14] ^= 0xFFFFFFFFu;
  for (int r = 0; r < 10; ++r) {
    const uint8_t* s = SIGMA[r];
    g(v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
    g(v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
    g(v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
    g(v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
    g(v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
    g(v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
    g(v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
    g(v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

}  // namespace

extern "C" {

// Raw zero-state compression of n 16-word messages (Merkle node hash).
void frieda_raw_compress_batch(const uint32_t* msgs, uint64_t n, uint32_t* out) {
  for (uint64_t i = 0; i < n; ++i) {
    uint32_t h[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    compress(h, msgs + 16 * i, 0, false);
    std::memcpy(out + 8 * i, h, 32);
  }
}

// Merkle multi-opening root recomputation (light-client verify hot path —
// the whole bottom-up walk in one call instead of per-level Python/numpy).
// idxs: n sorted unique leaf indices; rows: n x 8 leaf hash words;
// wit: n_wit x 8 sibling hash words consumed in encounter order (the
// deterministic plan of merkle.verify_openings_rows). Writes the recomputed
// root to out8 and the consumed witness count to *consumed. Returns 1 when
// the walk completes to exactly node 0 (caller still compares the root and
// checks *consumed == n_wit), 0 on witness underrun / malformed structure.
int frieda_verify_openings(uint32_t log_n, uint64_t n, const int64_t* idxs,
                           const uint32_t* rows, const uint32_t* wit,
                           uint64_t n_wit, uint32_t* out8, uint64_t* consumed) {
  // Two preallocated ping-pong buffers (each level's node count only ever
  // shrinks) — the per-level vector builds this replaces were ~4 mallocs x
  // log_n levels per tree, a visible cost in verify_many's batched calls.
  std::vector<int64_t> idxbuf(2 * n);
  std::vector<uint32_t> hbuf(2 * 8 * n);
  int64_t* cur_idx = idxbuf.data();
  int64_t* nxt_idx = idxbuf.data() + n;
  uint32_t* cur_h = hbuf.data();
  uint32_t* nxt_h = hbuf.data() + 8 * n;
  std::memcpy(cur_idx, idxs, n * sizeof(int64_t));
  std::memcpy(cur_h, rows, 8 * n * sizeof(uint32_t));
  uint64_t cnt = n;
  uint64_t wi = 0;
  for (uint32_t lvl = 0; lvl < log_n; ++lvl) {
    if (cnt == 0) break;
    uint64_t out = 0;
    uint64_t i = 0;
    while (i < cnt) {
      int64_t cur = cur_idx[i];
      const uint32_t *l, *r;
      if (i + 1 < cnt && cur_idx[i + 1] == (cur ^ 1)) {
        l = cur_h + 8 * i;
        r = cur_h + 8 * (i + 1);
        i += 2;
      } else {
        if (wi >= n_wit) { *consumed = wi; return 0; }
        const uint32_t* w = wit + 8 * wi;
        ++wi;
        if ((cur & 1) == 0) { l = cur_h + 8 * i; r = w; }
        else { l = w; r = cur_h + 8 * i; }
        i += 1;
      }
      uint32_t m[16];
      std::memcpy(m, l, 32);
      std::memcpy(m + 8, r, 32);
      uint32_t hh[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      compress(hh, m, 0, false);
      nxt_idx[out] = cur >> 1;
      std::memcpy(nxt_h + 8 * out, hh, 32);
      ++out;
    }
    std::swap(cur_idx, nxt_idx);
    std::swap(cur_h, nxt_h);
    cnt = out;
  }
  *consumed = wi;
  if (cnt != 1 || cur_idx[0] != 0) return 0;
  std::memcpy(out8, cur_h, 32);
  return 1;
}

// Batched multi-opening walk over n_trees INDEPENDENT equal-depth trees
// (the light-client verify_many hot path: one call per layer depth for a
// whole batch of proofs instead of one per proof). Tree p owns leaf rows
// [seg[p], seg[p+1]) of idxs/rows and witness rows [wseg[p], wseg[p+1]).
// idxs are tree-local (already de-offset). Writes n_trees x 8 root words
// and per-tree ok flags (walk completed AND consumed its witness exactly).
int frieda_verify_openings_batch(uint32_t log_n, uint32_t n_trees,
                                 const uint64_t* seg, const int64_t* idxs,
                                 const uint32_t* rows, const uint64_t* wseg,
                                 const uint32_t* wit, uint32_t* out_roots,
                                 uint8_t* out_ok) {
  for (uint32_t p = 0; p < n_trees; ++p) {
    uint64_t n = seg[p + 1] - seg[p];
    uint64_t n_wit = wseg[p + 1] - wseg[p];
    uint64_t consumed = 0;
    int ok = frieda_verify_openings(log_n, n, idxs + seg[p], rows + 8 * seg[p],
                                    wit + 8 * wseg[p], n_wit,
                                    out_roots + 8 * p, &consumed);
    out_ok[p] = (ok && consumed == n_wit) ? 1 : 0;
  }
  return 1;
}

}  // extern "C"
