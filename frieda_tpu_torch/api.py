"""Public API: commit, commit_many, commit_with_tree, generate_proof,
commit_and_prove, prove_many, verify, verify_many.

Counterpart of `frieda_tpu/api.py`, with the same quirks: empty input
commits to the zero polynomial of log size 2, and the padded felt count is
at least 4 (`log_total_for`). Every entry point that commits or proves runs
on the card unless the caller asks for the CPU: a CUDA device runs every
kernel of the path as a hand-written kernel and never falls back to the
CPU, and without CUDA it raises; the CPU runs each kernel's plain PyTorch
version. `verify` and `verify_many` take no device: the verifier is host
code, as in the JAX package.
"""

from __future__ import annotations

import torch

from .config import DEFAULT_CONFIG, PcsConfig  # noqa: F401  (re-export)
from .core import fft, fri, merkle
from .utils.packing import ingest_rev, log_total_for, upload_words

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
    on the same device: ingest, low-degree extension, Merkle tree. A batch of
    such rows, (B, nw), gives (B, 8, 1) in the same launches. Enqueues device
    work only; nothing waits for the device."""
    return merkle.root_level(_evaluations(words, log_total, log_blowup_factor))


def _evaluations(words: torch.Tensor, log_total: int, log_blowup_factor: int) -> torch.Tensor:
    """Words -> (4, 2^n) int32 evaluations (a batch: (B, 4, 2^n)), natural
    domain order: the ingest and the low-degree extension."""
    log_size = log_total - 2
    twiddles = fft.stage_twiddles(log_size + log_blowup_factor, words.device)
    return fft.evaluate_auto(ingest_rev(words, log_size), twiddles)


def commit_root_pipeline_batch(words: torch.Tensor, log_total: int,
                               log_blowup_factor: int) -> torch.Tensor:
    """(B, nw) `pad_to_words` rows of equal log_total (int32, on the device)
    -> (B, 8, 1) int32 root nodes: every blob's commit in the launches of
    one (counterpart of `_commit_root_pipeline_batch`, the JAX package's
    vmap)."""
    if words.dim() != 2:
        raise ValueError(f"expected (B, nw) words, got {tuple(words.shape)}")
    return commit_root_pipeline(words, log_total, log_blowup_factor)


def commit(data: bytes, log_blowup_factor: int, device="cuda") -> Commitment:
    """Commit to a data blob (reference: src/commit.rs) on `device`."""
    device = _device(device, "commit")
    log_total = log_total_for(len(data))
    words = upload_words([data], log_total, device)[1][0]
    return merkle.root_bytes(commit_root_pipeline(words, log_total, log_blowup_factor))


def commit_many(datas, log_blowup_factor: int, device="cuda") -> list:
    """Commit a batch of blobs of equal padded size (`log_total_for`) in one
    upload (from page-locked memory for the card), one set of launches (those
    of one `commit`) and one fetch;
    returns each blob's 32-byte root, equal to `commit(data, ...)`. No blob
    gives []; unequal padded sizes raise ValueError. The whole batch goes to
    the device at once, as in the JAX package."""
    device = _device(device, "commit_many")
    datas = list(datas)
    if not datas:
        return []
    log_total = log_total_for(len(datas[0]))
    if any(log_total_for(len(d)) != log_total for d in datas):
        raise ValueError("commit_many requires equal padded sizes")
    words = upload_words(datas, log_total, device)[1]
    return merkle.root_bytes_many(commit_root_pipeline_batch(words, log_total, log_blowup_factor))


def commit_with_tree(data: bytes, log_blowup_factor: int, device="cuda"):
    """(root bytes, evals, CommitTree, n): the commit with its whole tree, as
    `frieda_tpu.api.commit_with_tree` gives it. evals: (4, 2^n) int32 on
    `device`, natural domain order; the tree's levels down to width
    2^HOST_CUTOFF_LOG stay on the device (`merkle.device_levels`)."""
    device = _device(device, "commit_with_tree")
    log_total = log_total_for(len(data))
    evals = _evaluations(upload_words([data], log_total, device)[1][0], log_total, log_blowup_factor)
    n = log_total - 2 + log_blowup_factor
    tree = merkle.CommitTree(merkle.device_levels(evals), n)
    return tree.root, evals, tree, n


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


def prove_many(datas, seeds, pcs_config: PcsConfig = DEFAULT_CONFIG, max_in_flight=None,
               device="cuda"):
    """[(commitment, Proof)] of each blob under its seed, in input order, the
    same bytes as a loop of `commit_and_prove`. Up to `max_in_flight`
    finished commit phases wait on the device for their decommitment; None
    picks min(8, the window that fits the device's memory), and a larger
    request is clamped to that window with a warning (`fri.prove_many`)."""
    return fri.prove_many(datas, seeds, pcs_config, max_in_flight, _device(device, "prove_many"))


def verify(proof, seed) -> bool:
    """Verify a proof under the sampling seed (reference: src/proof.rs:79-101).
    Like the reference it does not take the commitment: compare
    `proof.first_layer_commitment` yourself for binding.

    Host code (numpy and the C++ runtime of `frieda_tpu_torch/native/`, built
    on first use), written for a light client without a card, as the JAX
    package's verifier is: there is no device version, and nothing falls
    back. Returns False for an invalid proof; raises IndexError when
    `evaluations` is shorter than the query set (the reference panics)."""
    return fri.verify_proof(proof, seed)


def verify_many(proofs, seeds) -> list:
    """[verify(p, s) ...] for a batch, with the proofs of one shape checked
    together (`fri.verify_many`). Host code, like `verify`."""
    return fri.verify_many(proofs, seeds)
