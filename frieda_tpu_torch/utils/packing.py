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

from .profiling import span


def ceil_log2(n: int) -> int:
    """Exact integer ceil(log2(n)), n >= 1."""
    return max(n - 1, 0).bit_length()


def log_total_for(data_len: int) -> int:
    """log2 of the padded felt count for a data blob (reference .max(2)
    quirk included): max(ceil_log2(ceil(8*len/30)), 2)."""
    n_felts = -(-(8 * data_len) // 30)
    return max(ceil_log2(max(n_felts, 1)), 2)


def stack_words(datas, log_total: int, pin: bool = False) -> torch.Tensor:
    """(B, words_for(log_total)) int32 tensor: row k is the little-endian
    uint32 words of `datas[k]`, zero-padded so that every felt's (lo, hi)
    word pair is in range for `ingest_rev`. Each blob's bytes are written
    straight into one buffer (one host memcpy, no bit work); `pin` puts that
    buffer in page-locked host memory (PyTorch's caching host allocator keeps
    it for the next call), so the upload is one DMA. Spans "ingest/pin" (the
    allocation) and "ingest/copy" (the rows)."""
    nw = words_for(log_total)
    with span("ingest/pin"):
        host = torch.empty((len(datas), nw), dtype=torch.int32, pin_memory=pin)
    with span("ingest/copy"):
        rows = host.numpy().view(np.uint8)
        for row, data in zip(rows, datas):
            row[: len(data)] = np.frombuffer(data, np.uint8)
            row[len(data):] = 0
    return host


def upload_words(datas, log_total: int, device, out: torch.Tensor | None = None) -> tuple:
    """(host buffer, words): `stack_words` of the blobs, page-locked for the
    card, and its (B, nw) copy on `device`, uploaded without waiting for the
    device. A page-locked block is not handed out again before its copy has
    run (PyTorch's caching host allocator records the copy). `out`, a (B, nw)
    int32 tensor on `device` (a captured commit phase's static input),
    receives the copy in place of a new tensor. The copy's enqueue is the
    span "ingest/upload"."""
    device = torch.device(device)
    host = stack_words(datas, log_total, pin=device.type == "cuda")
    if out is not None and (out.shape != host.shape or out.dtype != host.dtype):
        raise ValueError(f"out: expected {tuple(host.shape)} int32, got {tuple(out.shape)} {out.dtype}")
    with span("ingest/upload"):
        return host, host.to(device, non_blocking=True) if out is None else out.copy_(host, non_blocking=True)


def pad_to_words(data: bytes, log_total: int) -> np.ndarray:
    """The one-blob `stack_words`, as a numpy uint32 array of
    ceil(30*2^log_total / 32) + 1 words."""
    return stack_words([data], log_total).numpy()[0].view("<u4")


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
