"""Byte -> M31 felt ingest.

Counterpart of `frieda_tpu/utils/packing.py`. The host half is numpy and
copied jax-free; the device half (`ingest_rev`) is one kernel launch on a
CUDA tensor (`ops/ingest.py`).

The input's LSB-first bit stream is cut into 30-bit little-endian chunks, so
every felt is < 2^30 and canonical by construction (SURVEY.md A.1).
"""

from __future__ import annotations

import numpy as np
import torch


def ceil_log2(n: int) -> int:
    """Exact integer ceil(log2(n)), n >= 1."""
    return max(n - 1, 0).bit_length()


def log_total_for(data_len: int) -> int:
    """log2 of the padded felt count for a data blob (reference .max(2)
    quirk included): max(ceil_log2(ceil(8*len/30)), 2)."""
    n_felts = -(-(8 * data_len) // 30)
    return max(ceil_log2(max(n_felts, 1)), 2)


def pad_to_words(data: bytes, log_total: int) -> np.ndarray:
    """Little-endian uint32 word view of `data`, zero-padded so that every
    felt's (lo, hi) word pair is in range for `ingest_rev`:
    ceil(30*2^log_total / 32) + 1 words. One host memcpy, no bit work."""
    nw = words_for(log_total)
    buf = np.zeros(nw * 4, np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    return buf.view("<u4")


def words_for(log_total: int) -> int:
    """Word count `pad_to_words` produces for 2^log_total felts."""
    return (30 * (1 << log_total) + 31) // 32 + 1


def bytes_to_felts(data: bytes) -> np.ndarray:
    """Felts of a blob, unpadded: lcm(8, 30) = 120 bits, so each 15-byte
    block yields exactly 4 felts through fixed shifts and masks."""
    n_felts = -(-(8 * len(data)) // 30)
    if n_felts == 0:
        return np.zeros(0, np.uint32)
    n_blocks = -(-len(data) // 15)
    buf = np.zeros(n_blocks * 15, np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    b = buf.reshape(n_blocks, 15).astype(np.uint32)
    f0 = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | ((b[:, 3] & 0x3F) << 24)
    f1 = (b[:, 3] >> 6) | (b[:, 4] << 2) | (b[:, 5] << 10) | (b[:, 6] << 18) | ((b[:, 7] & 0x0F) << 26)
    f2 = (b[:, 7] >> 4) | (b[:, 8] << 4) | (b[:, 9] << 12) | (b[:, 10] << 20) | ((b[:, 11] & 0x03) << 28)
    f3 = (b[:, 11] >> 2) | (b[:, 12] << 6) | (b[:, 13] << 14) | (b[:, 14] << 22)
    return np.stack([f0, f1, f2, f3], axis=1).reshape(-1)[:n_felts]


def polynomial_from_bytes(data: bytes) -> np.ndarray:
    """Felts padded to 2^max(ceil_log2(n), 2), split into the 4 coordinate
    polynomials of one secure circle polynomial: (4, 2^log_size) uint32,
    natural coefficient order."""
    felts = bytes_to_felts(data)
    total = 1 << max(ceil_log2(max(len(felts), 1)), 2)
    padded = np.zeros(total, np.uint32)
    padded[: len(felts)] = felts
    return padded.reshape(4, total // 4)


def ingest_rev(words: torch.Tensor, log_size: int) -> torch.Tensor:
    """Words (`pad_to_words` with log_total = log_size + 2, int32 bits) ->
    (4, 2^log_size) int32 *bit-reversed-order* coefficients, ready for
    `core.fft.evaluate_auto`. Same result as `device_ingest_rev` for every
    log_size >= 0; one kernel launch on a CUDA tensor."""
    from ..ops import ingest

    return ingest.ingest(words, log_size)
