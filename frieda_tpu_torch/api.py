"""Public API: commit.

Counterpart of `frieda_tpu/api.py:commit`, with the same quirks: empty
input commits to the zero polynomial of log size 2, and the padded felt
count is at least 4 (`log_total_for`). The device is explicit: a CUDA
device runs every step as a hand-written kernel and never falls back to the
CPU; the CPU runs each kernel's plain PyTorch version.
"""

from __future__ import annotations

import torch

from .config import DEFAULT_CONFIG, PcsConfig  # noqa: F401  (re-export)
from .core import fft, merkle
from .utils.convert import from_numpy_u32
from .utils.packing import ingest_rev, log_total_for, pad_to_words

Commitment = bytes  # 32-byte Merkle root


def commit_root_pipeline(words: torch.Tensor, log_total: int,
                         log_blowup_factor: int) -> torch.Tensor:
    """`pad_to_words` words (int32, on the device) -> (8, 1) int32 root node
    on the same device: ingest, low-degree extension, Merkle tree. Enqueues
    device work only; nothing waits for the device."""
    log_size = log_total - 2
    twiddles = fft.stage_twiddles(log_size + log_blowup_factor, words.device)
    evals = fft.evaluate_auto(ingest_rev(words, log_size), twiddles)
    return merkle.root_level(evals)


def commit(data: bytes, log_blowup_factor: int, device) -> Commitment:
    """Commit to a data blob (reference: src/commit.rs) on `device`."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"commit on {device} requested, but CUDA is not available")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    log_total = log_total_for(len(data))
    words = from_numpy_u32(pad_to_words(data, log_total), device)
    return merkle.root_bytes(commit_root_pipeline(words, log_total, log_blowup_factor))
