"""Kernels 1 and 2: Merkle levels (`merkle_level`) and the narrow-tail
collapse (`merkle_collapse`), both BLAKE2s zero-state raw compressions.

`merkle_level` replaces the four level kernels of
`frieda_tpu/ops/merkle_pallas.py` (`leaf_level`, `inner_level`,
`leaf3_level`, `inner3_level`): one thread per output node, one level or
three levels per pass, leaf mode hashing [c0..c3, 0 x 12] first.
`merkle_collapse` replaces `collapse_level` / `collapse_multi` (single
output width here): one block takes a level of width <= COLLAPSE_MAX to the
root with every intermediate level in shared memory. Sources:
`csrc/merkle.cu`, `csrc/blake2s.cuh`.
"""

from __future__ import annotations

import torch

from ..core.merkle import hash_leaves, hash_parents
from ..utils.convert import narrow, widen
from . import _build

# Widest level the collapse block holds: 8 x 4096 u32 = 128 KB of the 227 KB
# of shared memory a Hopper block may opt into.
COLLAPSE_MAX = 4096


def merkle_level_plain(x: torch.Tensor, leaf: bool, fused: bool) -> torch.Tensor:
    """Plain version on int64 values. leaf: (4, N) columns -> (8, N) leaf
    hashes, or (8, N/8) with fused. Inner: (8, M) -> (8, M/2), or (8, M/8)
    with fused (three pairing levels)."""
    level = hash_leaves(x) if leaf else x
    for _ in range(3 if fused else (0 if leaf else 1)):
        level = hash_parents(level)
    return level


def merkle_level(x: torch.Tensor, leaf: bool, fused: bool) -> torch.Tensor:
    """int32 form of `merkle_level_plain`. Launches the kernel on a CUDA
    tensor, runs the plain version on a CPU tensor."""
    rows, width = x.shape
    _build.check_u32(x, "x", (4 if leaf else 8, width))
    fold = 8 if fused else (1 if leaf else 2)
    if width < fold or width % fold or width & (width - 1):
        raise ValueError(f"width {width} is not a power of two divisible by {fold}")
    if x.is_cuda:
        out = torch.empty((8, width // fold), dtype=torch.int32, device=x.device)
        lib = _build.library()
        _build.check_launch(lib.frieda_merkle_level(
            x.data_ptr(), out.data_ptr(), width, int(leaf), int(fused), _build.stream_of(x)))
        merkle_level.launches += 1
        return out
    return narrow(merkle_level_plain(widen(x), leaf, fused))


merkle_level.launches = 0


def merkle_collapse_plain(level: torch.Tensor) -> torch.Tensor:
    """Plain version: (8, m) int64 level -> (8, 1) root node."""
    while level.shape[1] > 1:
        level = hash_parents(level)
    return level


def merkle_collapse(level: torch.Tensor) -> torch.Tensor:
    """(8, m) int32 level, m a power of two <= COLLAPSE_MAX -> (8, 1) int32.
    Launches the kernel on a CUDA tensor, runs the plain version on a CPU
    tensor."""
    m = level.shape[1]
    _build.check_u32(level, "level", (8, m))
    if not 1 <= m <= COLLAPSE_MAX or m & (m - 1):
        raise ValueError(f"collapse width must be a power of two <= {COLLAPSE_MAX}, got {m}")
    if level.is_cuda:
        out = torch.empty((8, 1), dtype=torch.int32, device=level.device)
        lib = _build.library()
        _build.check_launch(lib.frieda_merkle_collapse(
            level.data_ptr(), out.data_ptr(), m, _build.stream_of(level)))
        merkle_collapse.launches += 1
        return out
    return narrow(merkle_collapse_plain(widen(level)))


merkle_collapse.launches = 0
