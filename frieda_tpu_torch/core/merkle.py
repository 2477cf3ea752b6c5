"""Merkle root over evaluation columns.

Counterpart of the root half of `frieda_tpu/core/merkle.py` (SURVEY.md A.6):

  leaf i   = raw_compress(0, [c0[i], c1[i], c2[i], c3[i], 0 x 12])
  inner    = raw_compress(0, left(8 words) || right(8 words))
  root     = top node, serialized as 8 little-endian u32 words.

Natural-order halves pairing: level M pairs node j with node j + M/2 (the
stored-order siblings 2k, 2k+1 sit at natural j, j + M/2), so every level
combines its two contiguous halves.

`levels` is the plain full build (int64). `root_level` is the GPU plan: the
`merkle_level` kernel three levels per pass until the width is at most
`ops.merkle.COLLAPSE_MAX`, then `merkle_collapse` takes it to width 1 in
one block. The JAX package finishes the last 2^6 nodes on the host to spare
TPU round trips; here the tree ends on the device, with the same root.
"""

from __future__ import annotations

import torch

from .blake2s import compress_rows


def hash_leaves(columns: torch.Tensor) -> torch.Tensor:
    """(4, N) int64 columns -> (8, N) int64 leaf hashes."""
    if columns.shape[0] != 4:
        raise ValueError(f"expected 4 columns, got {tuple(columns.shape)}")
    zeros = columns.new_zeros((12, columns.shape[1]))
    return compress_rows(torch.cat([columns, zeros]))


def hash_parents(level: torch.Tensor) -> torch.Tensor:
    """(8, M) int64 level -> (8, M/2) parents, parent j = H(L[j] || L[j+M/2])."""
    half = level.shape[1] // 2
    return compress_rows(torch.cat([level[:, :half], level[:, half:]]))


def levels(columns: torch.Tensor) -> list[torch.Tensor]:
    """Plain full tree: every level leaves-first down to width 1, (8, m)
    int64 each. Counterpart of JAX `device_levels(columns, cutoff_log=0)`."""
    level = hash_leaves(columns)
    out = [level]
    while level.shape[1] > 1:
        level = hash_parents(level)
        out.append(level)
    return out


def root_level(columns: torch.Tensor) -> torch.Tensor:
    """(4, N) int32 columns (N a power of two) -> (8, 1) int32 root node.
    On a CUDA tensor every step is a kernel launch; on a CPU tensor each
    step runs its plain version."""
    from ..ops import merkle as merkle_ops

    n = columns.shape[1]
    level = merkle_ops.merkle_level(columns, leaf=True, fused=n % 8 == 0)
    while level.shape[1] > merkle_ops.COLLAPSE_MAX:
        level = merkle_ops.merkle_level(level, leaf=False, fused=level.shape[1] % 8 == 0)
    return merkle_ops.merkle_collapse(level)


def root_bytes(top: torch.Tensor) -> bytes:
    """(8, 1) root node (int32 bits or int64 values) -> 32 root bytes."""
    from ..utils.convert import to_numpy_u32

    return to_numpy_u32(top)[:, 0].astype("<u4").tobytes()
