"""Kernels 1 and 2: Merkle levels (`merkle_level`) and the narrow-tail
collapse (`merkle_collapse`), both BLAKE2s zero-state raw compressions.

`merkle_level` replaces the four level kernels of
`frieda_tpu/ops/merkle_pallas.py` (`leaf_level`, `inner_level`,
`leaf3_level`, `inner3_level`): one thread per output node, one level or
three levels per pass, leaf mode hashing [c0..c3, 0 x 12] first.
`merkle_collapse` replaces `collapse_level` / `collapse_multi`: one block
takes a level of width <= COLLAPSE_MAX down the tree with every
intermediate level in shared memory, and writes each requested width (the
commit asks for the root only, the prover's pruned trees for every third
level of the tail). Sources: `csrc/merkle.cu`, `csrc/blake2s.cuh`.
"""

from __future__ import annotations

import ctypes

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


def _check_widths(m: int, out_widths) -> tuple:
    widths = tuple(int(w) for w in out_widths)
    if (not widths or any(w < 1 or m % w or w & (w - 1) for w in widths)
            or any(a <= b for a, b in zip(widths, widths[1:]))):
        raise ValueError(f"out_widths {out_widths} must be descending powers of two dividing {m}")
    return widths


def merkle_collapse_plain(level: torch.Tensor, out_widths=(1,)) -> list:
    """Plain version: (8, m) int64 level -> [(8, w) level of width w for w in
    out_widths], widths descending and dividing m."""
    outs = []
    for w in _check_widths(level.shape[1], out_widths):
        while level.shape[1] > w:
            level = hash_parents(level)
        outs.append(level)
    return outs


def merkle_collapse(level: torch.Tensor, out_widths=(1,)) -> list:
    """(8, m) int32 level, m a power of two <= COLLAPSE_MAX -> [(8, w) int32
    for w in out_widths] (descending powers of two dividing m), in one launch
    on a CUDA tensor; the plain version on a CPU tensor."""
    m = level.shape[1]
    _build.check_u32(level, "level", (8, m))
    if not 1 <= m <= COLLAPSE_MAX or m & (m - 1):
        raise ValueError(f"collapse width must be a power of two <= {COLLAPSE_MAX}, got {m}")
    widths = _check_widths(m, out_widths)
    if level.is_cuda:
        outs = [torch.empty((8, w), dtype=torch.int32, device=level.device) for w in widths]
        ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
        ws = (ctypes.c_longlong * len(widths))(*widths)
        lib = _build.library()
        _build.check_launch(lib.frieda_merkle_collapse(
            level.data_ptr(), ptrs, ws, len(widths), m, _build.stream_of(level)))
        merkle_collapse.launches += 1
        return outs
    return [narrow(o) for o in merkle_collapse_plain(widen(level), widths)]


merkle_collapse.launches = 0
