"""Proof-of-work grind: the minimum nonce whose mix clears pow_bits.

Counterpart of `frieda_tpu/core/grind.py` and `device_channel.dc_grind`:
the smallest nonce n >= 0 such that channel.clone().mix_u64(n)
.trailing_zeros() >= pow_bits. mix_u64 hashes digest (32 B) || nonce (8 B
LE), one 40-byte BLAKE2s-256 block, so a batch of consecutive nonces is one
`blake2s_hash_one_block` over a batch axis on the channel's device, and a
min-reduce over the qualifying nonces keeps the sequential scan's answer.
The sweep is plain PyTorch tensor code (the JAX package left it to XLA, not
to Pallas); a CUDA tensor runs it on the card.
"""

from __future__ import annotations

import torch

from .blake2s import blake2s_hash_one_block
from .channel import Blake2sChannel

_M32 = 0xFFFFFFFF
BATCH_MAX = 1 << 20
BATCH_MIN = 1 << 8


def batch_size(pow_bits: int) -> int:
    """Nonces per sweep: 2^pow_bits (a hit is expected within it), clamped."""
    return max(BATCH_MIN, min(BATCH_MAX, 1 << pow_bits))


def _clears(w0: torch.Tensor, w1: torch.Tensor, pow_bits: int) -> torch.Tensor:
    """trailing_zeros(w1:w0) >= pow_bits, for pow_bits <= 64."""
    if pow_bits <= 32:
        return (w0 & ((1 << pow_bits) - 1)) == 0
    return (w0 == 0) & ((w1 & ((1 << (pow_bits - 32)) - 1)) == 0)


def grind(channel: Blake2sChannel, pow_bits: int, device, batch: int | None = None) -> int:
    """Minimum qualifying nonce, swept `batch` nonces at a time on `device`
    (one host sync per batch). pow_bits <= 60, as PcsConfig allows."""
    if not 0 <= pow_bits <= 60:
        raise ValueError(f"pow_bits must be in [0, 60], got {pow_bits}")
    batch = batch or batch_size(pow_bits)
    digest = [int.from_bytes(channel.digest[4 * i : 4 * i + 4], "little") for i in range(8)]
    idx = torch.arange(batch, dtype=torch.int64, device=device)
    msg = torch.zeros((16, batch), dtype=torch.int64, device=device)
    msg[:8] = torch.tensor(digest, dtype=torch.int64, device=device)[:, None]
    none = 1 << 62
    base = 0
    while True:
        nonce = idx + base
        msg[8] = nonce & _M32
        msg[9] = nonce >> 32
        out = blake2s_hash_one_block(msg, data_len=40)
        best = int(torch.where(_clears(out[0], out[1], pow_bits), nonce, none).min())
        if best != none:
            return best
        base += batch
