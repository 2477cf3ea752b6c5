"""BLAKE2s compression over a batch of messages, on int64 tensors.

A Merkle node is the raw compression of its 64-byte message from a zero
chaining state: v = 8 zero words + the standard IV, counter 0, no final
flag, out[i] = v[i] ^ v[i + 8]. The proof-of-work hash is standard
BLAKE2s-256 of one block. The four column steps of a round run as one
(4, lanes) step, and so do the four diagonal ones, so a compression is ~600
tensor operations whatever the batch.
"""

from __future__ import annotations

import torch

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
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
M32 = 0xFFFFFFFF
PARAM_IV0 = IV[0] ^ 0x01010020  # BLAKE2s-256, no key: digest length 32, fanout 1, depth 1
LANES = 1 << 23  # lanes hashed at once, which bounds the temporaries (~0.6 GiB a (4, LANES) tensor)


def _ror(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x >> r) | ((x << (32 - r)) & M32)


def _g(a, b, c, d, x, y):
    a = (a + b + x) & M32
    d = _ror(d ^ a, 16)
    c = (c + d) & M32
    b = _ror(b ^ c, 12)
    a = (a + b + y) & M32
    d = _ror(d ^ a, 8)
    c = (c + d) & M32
    b = _ror(b ^ c, 7)
    return a, b, c, d


def _compress(msg: torch.Tensor, h, t: int, final: bool) -> torch.Tensor:
    lanes = msg.shape[1]
    iv = list(IV)
    iv[4] ^= t & M32
    iv[5] ^= (t >> 32) & M32
    if final:
        iv[6] ^= M32
    vec = torch.tensor([h[:4], h[4:], iv[:4], iv[4:]], dtype=torch.int64, device=msg.device)
    a, b, c, d = (row[:, None].expand(4, lanes) for row in vec)
    for s in SIGMA:
        idx = torch.tensor(s, device=msg.device)
        m = msg.index_select(0, idx)  # m[k] = msg[s[k]]
        a, b, c, d = _g(a, b, c, d, m[0:8:2], m[1:8:2])
        # diagonals: (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14)
        b, c, d = b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0)
        a, b, c, d = _g(a, b, c, d, m[8:16:2], m[9:16:2])
        b, c, d = b.roll(1, 0), c.roll(2, 0), d.roll(3, 0)
    hv = vec[0:2].reshape(8, 1)
    return torch.cat([a, b]) ^ torch.cat([c, d]) ^ hv


def compress(msg: torch.Tensor, h=(0,) * 8, t: int = 0, final: bool = False) -> torch.Tensor:
    """(16, lanes) int64 u32 message words -> (8, lanes) output words
    h[i] ^ v[i] ^ v[i + 8], in chunks of `LANES`."""
    if msg.shape[0] != 16:
        raise ValueError(f"expected 16 message rows, got {tuple(msg.shape)}")
    lanes = msg.shape[1]
    if lanes <= LANES:
        return _compress(msg, list(h), t, final)
    return torch.cat([_compress(msg[:, i : i + LANES], list(h), t, final) for i in range(0, lanes, LANES)], dim=1)


def hash_one_block(msg: torch.Tensor, data_len: int) -> torch.Tensor:
    """Standard BLAKE2s-256 of messages of data_len <= 64 bytes given as
    (16, lanes) words zero-padded past data_len: (8, lanes) digest words."""
    return compress(msg, (PARAM_IV0,) + IV[1:], t=data_len, final=True)
