"""Public API: commit, generate_proof, commit_and_prove.

Counterpart of `frieda_tpu/api.py`, with the same quirks: empty input
commits to the zero polynomial of log size 2, and the padded felt count is
at least 4 (`log_total_for`). Every entry point runs on the card unless the
caller asks for the CPU: a CUDA device runs every kernel of the path as a
hand-written kernel and never falls back to the CPU, and without CUDA it
raises; the CPU runs each kernel's plain PyTorch version.
"""

from __future__ import annotations

import torch

from .config import DEFAULT_CONFIG, PcsConfig  # noqa: F401  (re-export)
from .core import fft, fri, merkle
from .utils.convert import from_numpy_u32
from .utils.packing import ingest_rev, log_total_for, pad_to_words

Commitment = bytes  # 32-byte Merkle root


def _device(device, what: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} on {device} requested, but CUDA is not available")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def commit_root_pipeline(words: torch.Tensor, log_total: int,
                         log_blowup_factor: int) -> torch.Tensor:
    """`pad_to_words` words (int32, on the device) -> (8, 1) int32 root node
    on the same device: ingest, low-degree extension, Merkle tree. Enqueues
    device work only; nothing waits for the device."""
    log_size = log_total - 2
    twiddles = fft.stage_twiddles(log_size + log_blowup_factor, words.device)
    evals = fft.evaluate_auto(ingest_rev(words, log_size), twiddles)
    return merkle.root_level(evals)


def commit(data: bytes, log_blowup_factor: int, device="cuda") -> Commitment:
    """Commit to a data blob (reference: src/commit.rs) on `device`."""
    device = _device(device, "commit")
    log_total = log_total_for(len(data))
    words = from_numpy_u32(pad_to_words(data, log_total), device)
    return merkle.root_bytes(commit_root_pipeline(words, log_total, log_blowup_factor))


def commit_and_prove(data: bytes, seed, pcs_config: PcsConfig = DEFAULT_CONFIG,
                     device="cuda"):
    """(commitment, Proof) of a blob (reference commit_and_generate_proof);
    seed: optional int mixed into the Fiat-Shamir channel. The proof's wire
    bytes equal `frieda_tpu.api.commit_and_prove`'s."""
    return fri.commit_and_generate_proof(data, seed, pcs_config, _device(device, "prove"))


def generate_proof(data: bytes, seed, pcs_config: PcsConfig = DEFAULT_CONFIG, device="cuda"):
    """The Proof of `commit_and_prove` (reference: src/proof.rs:28-77)."""
    return commit_and_prove(data, seed, pcs_config, device)[1]


def commit_and_prove_staged(words: torch.Tensor, log_total: int, seed,
                            pcs_config: PcsConfig = DEFAULT_CONFIG):
    """`commit_and_prove` for a blob already on its device as
    `pad_to_words(data, log_total)` words (int32): skips the host padding and
    the upload. Counterpart of `fri.dispatch_commit_phase_staged` +
    `fri.finish_proof`, the form a serving pipeline with device-side ingest
    runs."""
    _device(words.device, "prove")
    return fri.prove_words(words, log_total, seed, pcs_config)
