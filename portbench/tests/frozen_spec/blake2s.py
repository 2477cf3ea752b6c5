"""Reference-spec raw BLAKE2s compression function (RFC 7693 core).

The reference's Merkle tree hashes nodes with the *raw* BLAKE2s compression
function applied to a zero state: h = eight 0 words (no IV preload into h, no
parameter block), t0 = t1 = 0, no finalization flag. Internally the
compression function still loads the standard IV into v[8..15] as RFC 7693
prescribes. This convention is golden-verified (SURVEY.md Appendix A.6;
reference use-sites the upstream's src/commit.rs:17-21, src/proof.rs:14).

Two implementations:
  * compress_words  — scalar, Python ints (clarity; used for tiny vectors)
  * compress_batch  — numpy uint32 vectorized over a batch axis (the oracle
                      actually used at blob scale)
"""

from __future__ import annotations

import numpy as np

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)

# (a, b, c, d) register indices for the 8 G applications of each round.
G_INDICES = (
    (0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
    (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14),
)

_MASK = 0xFFFFFFFF


def _ror(x: int, r: int) -> int:
    return ((x >> r) | (x << (32 - r))) & _MASK


def compress_words(h, m, t: int = 0, final: bool = False):
    """RFC 7693 BLAKE2s compression: h (8 u32 words), m (16 u32 words)."""
    assert len(h) == 8 and len(m) == 16
    v = list(h) + list(IV)
    v[12] ^= t & _MASK
    v[13] ^= (t >> 32) & _MASK
    if final:
        v[14] ^= _MASK
    for rnd in range(10):
        s = SIGMA[rnd]
        for g, (a, b, c, d) in enumerate(G_INDICES):
            x, y = m[s[2 * g]], m[s[2 * g + 1]]
            v[a] = (v[a] + v[b] + x) & _MASK
            v[d] = _ror(v[d] ^ v[a], 16)
            v[c] = (v[c] + v[d]) & _MASK
            v[b] = _ror(v[b] ^ v[c], 12)
            v[a] = (v[a] + v[b] + y) & _MASK
            v[d] = _ror(v[d] ^ v[a], 8)
            v[c] = (v[c] + v[d]) & _MASK
            v[b] = _ror(v[b] ^ v[c], 7)
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def raw_compress(m):
    """Zero-state raw compression used for Merkle nodes (SURVEY.md A.6)."""
    return compress_words([0] * 8, m, t=0, final=False)


# ---------------------------------------------------------------------------
# Vectorized oracle (numpy uint32), batch axis last: m shape (16, n) -> (8, n)
# ---------------------------------------------------------------------------

def _ror_np(x, r):
    return (x >> np.uint32(r)) | (x << np.uint32(32 - r))


def compress_batch(m: np.ndarray) -> np.ndarray:
    """Zero-state raw compression over a batch: m (16, n) uint32 -> (8, n)."""
    assert m.dtype == np.uint32 and m.shape[0] == 16
    n = m.shape[1]
    v = [np.zeros(n, np.uint32) for _ in range(8)] + [
        np.full(n, iv, np.uint32) for iv in IV
    ]
    for rnd in range(10):
        s = SIGMA[rnd]
        for g, (a, b, c, d) in enumerate(G_INDICES):
            x, y = m[s[2 * g]], m[s[2 * g + 1]]
            v[a] = v[a] + v[b] + x
            v[d] = _ror_np(v[d] ^ v[a], 16)
            v[c] = v[c] + v[d]
            v[b] = _ror_np(v[b] ^ v[c], 12)
            v[a] = v[a] + v[b] + y
            v[d] = _ror_np(v[d] ^ v[a], 8)
            v[c] = v[c] + v[d]
            v[b] = _ror_np(v[b] ^ v[c], 7)
    return np.stack([v[i] ^ v[i + 8] for i in range(8)])
