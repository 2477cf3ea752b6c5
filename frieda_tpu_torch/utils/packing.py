"""Byte -> M31 felt ingest.

Counterpart of `frieda_tpu/utils/packing.py`. The host half is numpy and
copied jax-free; the device half (`ingest_rev`) is one kernel launch on a
CUDA tensor (`ops/ingest.py`).

The input's LSB-first bit stream is cut into 30-bit little-endian chunks, so
every felt is < 2^30 and canonical by construction (SURVEY.md A.1).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from .profiling import span

# The blobs' copy into the host buffer runs at one core's memory rate. A call
# whose blobs hold SPLIT_BYTES or more is copied in chunks on up to
# MAX_COPY_THREADS threads (the calling thread one of them), as many as the
# process's CPU affinity allows; below it the calling thread copies alone. Each
# chunk is numpy slice assignments, which release the interpreter lock.
# Measured on two H100 hosts (8 CPUs each; tools/torch_copy_times.py): a
# 62,914,560-byte blob into page-locked memory took a median 9.1-10.3 ms on
# one thread, 5.5-8.8 on 2, 3.4-5.8 on 4, 3.4-4.5 on 8 (95th percentiles
# 6.7-8.0 on 4, 9.0-11.1 on 8: a copy ends with its slowest chunk) and
# 3.8-5.0 on 16. A chunk's hand-off to an idle worker took 0.05-0.1 ms; split
# over 4 or 8 threads, a copy won at 16 MiB and above on both hosts, and lost
# below 4 MiB.
SPLIT_BYTES = 16 << 20
MAX_COPY_THREADS = 4
CHUNK_ALIGN = 1 << 12  # chunk boundaries in the rows' byte stream fall on multiples of a page


def ceil_log2(n: int) -> int:
    """Exact integer ceil(log2(n)), n >= 1."""
    return max(n - 1, 0).bit_length()


def log_total_for(data_len: int) -> int:
    """log2 of the padded felt count for a data blob (reference .max(2)
    quirk included): max(ceil_log2(ceil(8*len/30)), 2)."""
    n_felts = -(-(8 * data_len) // 30)
    return max(ceil_log2(max(n_felts, 1)), 2)


def copy_chunks(sizes, parts: int) -> list:
    """The rows' bytes (`sizes[k]` in row k), taken as one stream in row
    order, cut into at most `parts` runs of about equal length whose
    boundaries fall on multiples of CHUNK_ALIGN: a list of chunks, each a
    list of (row, start, end) pieces. Every byte lies in exactly one piece."""
    step = max(-(-sum(sizes) // max(parts, 1)), 1)
    step = -(-step // CHUNK_ALIGN) * CHUNK_ALIGN
    chunks, chunk, room = [], [], step
    for k, size in enumerate(sizes):
        a = 0
        while a < size:
            b = min(size, a + room)
            chunk.append((k, a, b))
            room -= b - a
            a = b
            if room == 0:
                chunks.append(chunk)
                chunk, room = [], step
    return chunks + [chunk] if chunk else chunks


def _copy_chunk(rows, srcs, chunk) -> None:
    for k, a, b in chunk:
        rows[k][a:b] = srcs[k][a:b]


class RowCopier:
    """Copies blobs' bytes into the rows of a host buffer: whole on the
    calling thread below `split_bytes` in all, else in `copy_chunks` over
    the calling thread and a pool of worker threads, made at the first split
    copy. `threads` (None: the CPUs of the process's affinity, at most
    MAX_COPY_THREADS, read at each call) bounds the threads of a copy. A
    forked child drops the parent's pool, whose threads it does not have,
    and makes its own. `counts`: calls copied whole, calls split, and the
    chunks of the split calls."""

    def __init__(self, split_bytes: int = SPLIT_BYTES, threads: int | None = None):
        self.split_bytes, self.threads = split_bytes, threads
        self.counts = {"whole": 0, "split": 0, "chunks": 0}
        self._lock = threading.Lock()
        self._pool = None

    def after_fork(self) -> None:
        self._lock = threading.Lock()
        self._pool = None

    def _threads(self) -> int:
        if self.threads is not None:
            return self.threads
        return min(len(os.sched_getaffinity(0)), MAX_COPY_THREADS)

    def copy(self, rows, srcs) -> None:
        """rows[k][:len(srcs[k])] = srcs[k] for every k (uint8 arrays)."""
        threads = self._threads()
        if threads < 2 or sum(s.size for s in srcs) < self.split_bytes:
            for row, src in zip(rows, srcs):
                row[: src.size] = src
            with self._lock:
                self.counts["whole"] += 1
            return
        chunks = copy_chunks([s.size for s in srcs], threads)
        with self._lock:
            if self._pool is None:
                workers = (self.threads or MAX_COPY_THREADS) - 1  # started as chunks come
                self._pool = ThreadPoolExecutor(workers, thread_name_prefix="frieda-copy")
            pool = self._pool
            self.counts["split"] += 1
            self.counts["chunks"] += len(chunks)
        futures = [pool.submit(_copy_chunk, rows, srcs, chunk) for chunk in chunks[1:]]
        try:
            _copy_chunk(rows, srcs, chunks[0])
        finally:
            wait(futures)  # the rows outlive no worker's writes
        for f in futures:
            f.result()


_COPIER = RowCopier()
os.register_at_fork(after_in_child=_COPIER.after_fork)


def copy_counts() -> dict:
    """{"whole", "split", "chunks"}: `stack_words` calls since the process
    started (a forked child goes on from its parent's counts) whose bytes
    the calling thread copied alone, calls split over threads, and the
    chunks of the split calls."""
    with _COPIER._lock:
        return dict(_COPIER.counts)


def stack_words(datas, log_total: int, pin: bool = False) -> torch.Tensor:
    """(B, words_for(log_total)) int32 tensor: row k is the little-endian
    uint32 words of `datas[k]`, zero-padded so that every felt's (lo, hi)
    word pair is in range for `ingest_rev`. Each blob's bytes are written
    straight into one buffer (memcpy, no bit work; split over host threads
    when the blobs hold SPLIT_BYTES or more, see `RowCopier`); `pin` puts
    that buffer in page-locked host memory (PyTorch's caching host allocator
    keeps it for the next call), so the upload is one DMA. Spans
    "ingest/pin" (the allocation) and "ingest/copy" (the rows)."""
    nw = words_for(log_total)
    with span("ingest/pin"):
        host = torch.empty((len(datas), nw), dtype=torch.int32, pin_memory=pin)
    with span("ingest/copy"):
        rows = host.numpy().view(np.uint8)
        srcs = [np.frombuffer(data, np.uint8) for data in datas]
        _COPIER.copy(rows, srcs)
        for row, src in zip(rows, srcs):
            row[src.size:] = 0
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
