"""Fiat-Shamir channel on device tensors: the plain versions of the
`transcript` and `grind` kernels (`ops/channel.py`).

Counterpart of `frieda_tpu/core/device_channel.py`, the bit-exact twin of
the host channel (`core/channel.py`, the verifier's source of truth). The
JAX package runs it inside the commit phase's one jitted dispatch; the port
runs the same steps as two hand-written kernels and keeps these functions as
their plain versions, on int64 tensors holding u32 words. Two steps loop on
data, and here their loops test on the host (one synchronization a trip on a
CUDA tensor): the whole-draw retry of `dc_draw_base_felts` and the nonce
sweep of `dc_grind`.

State: the digest, (8,) u32 words little-endian, and n_sent, a count (an
int or a 0-d tensor). Every mix replaces the digest with BLAKE2s-256(digest
|| payload); every draw hashes digest || n_sent (8 bytes LE) and returns
n_sent + 1.
"""

from __future__ import annotations

import torch

from .blake2s import IV, PARAM_IV0, compress_rows

P = (1 << 31) - 1
# draw_felt retries while any of its 8 words is >= DRAW_BOUND (2P: the host
# channel's rule). The transcript kernel takes it as an argument from here;
# tests lower it to reach the retry, which no natural input does (~2^-28 a
# draw).
DRAW_BOUND = 2 * P
_M32 = 0xFFFFFFFF


def dc_blake2s(msg_words: torch.Tensor, byte_len: int) -> torch.Tensor:
    """RFC BLAKE2s-256 of byte_len bytes given as (16 * k,) int64 u32 words
    (zero-padded, k = max(1, ceil(byte_len / 64)) blocks). Returns the (8,)
    digest words."""
    n_blocks = max(1, -(-byte_len // 64))
    if msg_words.shape != (16 * n_blocks,):
        raise ValueError(f"{byte_len} bytes need {16 * n_blocks} words, got {tuple(msg_words.shape)}")
    h = (PARAM_IV0,) + IV[1:]
    for i in range(n_blocks):
        final = i == n_blocks - 1
        h = compress_rows(msg_words[16 * i : 16 * (i + 1)], h=h, t=byte_len if final else 64 * (i + 1),
                          final=final)
    return h


def fresh_digest(device="cpu") -> torch.Tensor:
    return torch.zeros(8, dtype=torch.int64, device=device)


def dc_mix_u64(digest: torch.Tensor, value_lo, value_hi) -> torch.Tensor:
    """digest <- blake2s(digest || value_le8), the value as two u32 words
    (ints or 0-d tensors)."""
    msg = digest.new_zeros(16)
    msg[:8] = digest
    msg[8] = value_lo
    msg[9] = value_hi
    return dc_blake2s(msg, 40)


def dc_mix_u64_const(digest: torch.Tensor, value: int) -> torch.Tensor:
    return dc_mix_u64(digest, value & _M32, (value >> 32) & _M32)


def dc_mix_digest(digest: torch.Tensor, root_words: torch.Tensor) -> torch.Tensor:
    """digest <- blake2s(digest || 32-byte root): exactly one block."""
    return dc_blake2s(torch.cat([digest, root_words]), 64)


def dc_mix_felts(digest: torch.Tensor, felts: torch.Tensor) -> torch.Tensor:
    """felts: (k, 4) QM31 coordinates. digest <- blake2s(digest || each QM31
    as 4 u32 LE words)."""
    byte_len = 32 + 16 * felts.shape[0]
    n_blocks = -(-byte_len // 64)
    flat = torch.cat([digest, felts.reshape(-1)])
    return dc_blake2s(torch.cat([flat, flat.new_zeros(16 * n_blocks - flat.numel())]), byte_len)


def dc_draw_random_words(digest: torch.Tensor, n_sent):
    """One draw: blake2s(digest || n_sent_le8) -> ((8,) words, n_sent + 1)."""
    return dc_mix_u64(digest, n_sent, 0), n_sent + 1


def dc_draw_base_felts(digest: torch.Tensor, n_sent):
    """8 uniform M31 felts with the host channel's whole-draw rejection rule:
    retry while any word >= DRAW_BOUND (the test runs on the host). Returns
    (felts (8,), n_sent')."""
    while True:
        words, n_sent = dc_draw_random_words(digest, n_sent)
        if bool((words < DRAW_BOUND).all()):
            return torch.where(words >= P, words - P, words), n_sent


def dc_draw_felt(digest: torch.Tensor, n_sent):
    """Draw one QM31 (the first 4 of 8 base felts). Returns ((4,), n_sent')."""
    felts, n_sent = dc_draw_base_felts(digest, n_sent)
    return felts[:4], n_sent


def _tz32(w: torch.Tensor) -> torch.Tensor:
    """Trailing zeros of u32 values (32 for zero)."""
    return sum(((w & ((2 << b) - 1)) == 0).to(torch.int64) for b in range(32))


def dc_trailing_zeros(digest: torch.Tensor) -> torch.Tensor:
    """Trailing zeros of the u128 formed from the first 16 digest bytes LE
    (128 when they are all zero, as the host channel says)."""
    tz = _tz32(digest[0])
    all_zero = digest[0] == 0
    for i in range(1, 4):
        tz = tz + torch.where(all_zero, _tz32(digest[i]), 0)
        all_zero = all_zero & (digest[i] == 0)
    return tz


def dc_grind(digest: torch.Tensor, pow_bits: int, batch: int | None = None) -> int:
    """Minimum nonce n >= 0 whose mix clears pow_bits (trailing_zeros of
    dc_mix_u64(digest, n) >= pow_bits), for pow_bits <= 60: batches of
    consecutive u64 nonces on the digest's device (`core/grind.sweep`), one
    host test a batch."""
    from .grind import sweep

    return sweep(digest, pow_bits, batch)


def dc_sample_query_words(digest: torch.Tensor, n_sent, n_queries: int, log_domain: int):
    """n_queries positions in [0, 2^log_domain), with duplicates and unsorted,
    drawn as the host sampler draws them (sorting and deduplication stay on
    the host). Returns ((n_queries,), n_sent')."""
    out = []
    for _ in range(-(-n_queries // 8)):
        words, n_sent = dc_draw_random_words(digest, n_sent)
        out.append(words)
    words = torch.cat(out)[:n_queries] if out else digest.new_zeros(0)
    return words & ((1 << log_domain) - 1), n_sent
