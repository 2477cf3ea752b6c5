"""BLAKE2s compression on torch int64 tensors (plain version).

Counterpart of `frieda_tpu/core/blake2s.py`. The Merkle node hash (SURVEY.md
A.6) is the raw compression function applied to a zero chaining state, with
the standard IV in v[8..15], t = 0 and no final flag, and out[i] = v[i] ^
v[i+8]. It is not RFC BLAKE2s-256 (that one preloads the parameter block
into h): `blake2s_hash_one_block` is, for messages of at most one block, and
serves the proof-of-work grind. The hand-written kernel of the Merkle hash
is `csrc/blake2s.cuh`.
"""

from __future__ import annotations

import torch

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

# (a, b, c, d) register quadruples of the 8 G applications per round
# (columns, then diagonals).
G_INDICES = (
    (0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
    (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14),
)

_M32 = 0xFFFFFFFF


def _ror(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x >> r) | (x << (32 - r))) & _M32  # x < 2^32: x << 31 < 2^63


def compress_rows(msg: torch.Tensor, h=None, t: int = 0, final: bool = False) -> torch.Tensor:
    """Raw compression over a batch. msg: (16, ...) int64 u32 values; h: the
    chaining state, 8 words (ints or tensors broadcastable to a row), zero
    when None; t: the byte counter; final: the last-block flag. Returns
    (8, ...) int64 output words h[i] ^ v[i] ^ v[i+8]."""
    if msg.shape[0] != 16:
        raise ValueError(f"expected 16 message rows, got {tuple(msg.shape)}")
    m = list(msg.unbind(0))
    zero = torch.zeros_like(m[0])
    h = None if h is None else [zero + w for w in h]
    iv = list(IV)
    iv[4] ^= t & _M32
    iv[5] ^= (t >> 32) & _M32
    if final:
        iv[6] ^= _M32
    v = (h or [zero] * 8) + [torch.full_like(m[0], w) for w in iv]
    for rnd in range(10):
        s = SIGMA[rnd]
        for g, (a, b, c, d) in enumerate(G_INDICES):
            x, y = m[s[2 * g]], m[s[2 * g + 1]]
            va = (v[a] + v[b] + x) & _M32
            vd = _ror(v[d] ^ va, 16)
            vc = (v[c] + vd) & _M32
            vb = _ror(v[b] ^ vc, 12)
            va = (va + vb + y) & _M32
            vd = _ror(vd ^ va, 8)
            vc = (vc + vd) & _M32
            vb = _ror(vb ^ vc, 7)
            v[a], v[b], v[c], v[d] = va, vb, vc, vd
    out = [v[i] ^ v[i + 8] for i in range(8)]
    return torch.stack(out if h is None else [o ^ w for o, w in zip(out, h)])


# Parameter block of BLAKE2s-256 without a key: digest length 32, fanout 1,
# depth 1, xored into IV[0].
PARAM_IV0 = IV[0] ^ 0x01010020


def blake2s_hash_one_block(msg: torch.Tensor, data_len: int) -> torch.Tensor:
    """Standard BLAKE2s-256 of a message of data_len <= 64 bytes, given as
    (16, ...) int64 u32 words zero-padded past data_len: parameter-block IV,
    t = data_len, final flag. Returns the (8, ...) digest words."""
    if not 0 <= data_len <= 64:
        raise ValueError(f"one block holds at most 64 bytes, got {data_len}")
    return compress_rows(msg, h=(PARAM_IV0,) + IV[1:], t=data_len, final=True)
