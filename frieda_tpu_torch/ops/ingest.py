"""Kernel 4, `ingest`: u32 words -> (4, 2^log_size) bit-reversed coefficients.

Replaces `frieda_tpu/ops/ingest_pallas.py::ingest_rows` together with the
`bitrev_rows_device` step after it (`utils/packing.device_ingest_rev`): one
CUDA kernel launch (`csrc/ingest.cu`) for every log_size >= 0. From
log_size 10 on, a block reads whole aligned 30-word runs (32 felts) into
shared memory and writes 32 x 32 bit-reversal tiles (`ingest_tile`); below
that, one thread per output reads the words of its felt.

Output [c, r] is felt f = c*L + rev_{log_size}(r) (L = 2^log_size), and
felt f is bits [30f, 30f + 30) of the little-endian word stream:
(words[30f >> 5] >> s | words[(30f >> 5) + 1] << (32 - s)) & (2^30 - 1),
s = 30f & 31, the high word used only when s > 2.

A batch (`commit_many`) is `pad_to_words` rows stacked, (B, nw) -> (B, 4,
2^log_size), in one launch: the kernel takes each blob's row base from the
row stride (a row is 30 * 2^(log_size - 3) + 1 words, so a batch is not one
blob of 4B columns).
"""

from __future__ import annotations

import torch

from ..core.circle import bitrev_permutation
from ..utils.convert import narrow, widen
from ..utils.packing import words_for
from . import _build

_MASK30 = (1 << 30) - 1
_M32 = 0xFFFFFFFF
TILE_LOG = 10  # log_size of one 32 x 32 tile: r = hi * 2^(log_size - 5) + mid * 32 + lo
TILES_MAX = 8  # tiles a block: at 8, each span a block reads is 960 bytes, 32-byte aligned


def ingest_tile(log_size: int) -> int:
    """Tiles a block of the kernel takes (consecutive rev(mid)), or 0 for the
    per-element form below a full tile."""
    return 0 if log_size < TILE_LOG else min(TILES_MAX, 1 << (log_size - TILE_LOG))


def ingest_plain(words: torch.Tensor, log_size: int) -> torch.Tensor:
    """Plain version on int64 u32 values: (nw,) -> (4, 2^log_size), or a
    batch (B, nw) -> (B, 4, 2^log_size)."""
    L = 1 << log_size
    rev = torch.from_numpy(bitrev_permutation(log_size).copy()).to(words.device)
    f = torch.arange(4, dtype=torch.int64, device=words.device)[:, None] * L + rev[None, :]
    bit = 30 * f  # int64: no overflow past log_total = 27
    idx = bit >> 5
    s = bit & 31
    lo = words[..., idx]
    hi = words[..., idx + 1]
    high = torch.where(s > 2, (hi << (32 - s)) & _M32, torch.zeros_like(hi))
    return ((lo >> s) | high) & _MASK30


def ingest(words: torch.Tensor, log_size: int) -> torch.Tensor:
    """words: (nw,) int32 from `pad_to_words` (log_total = log_size + 2),
    nw >= ceil(30 * 2^log_total / 32) + 1, or (B, nw) such rows stacked.
    Returns (4, 2^log_size) int32, or (B, 4, 2^log_size). Launches the
    kernel on a CUDA tensor, with `ingest_tile(log_size)` tiles a block, runs
    the plain version on a CPU tensor (per blob, stacked)."""
    if log_size < 0:
        raise ValueError(f"log_size must be >= 0, got {log_size}")
    need = words_for(log_size + 2)
    if words.dim() not in (1, 2) or words.shape[-1] < need or not words.shape[0]:
        raise ValueError(f"words: expected (>= {need},) or (B >= 1, >= {need}) words, got {tuple(words.shape)}")
    _build.check_u32(words, "words", tuple(words.shape))
    rows = words.view(-1, words.shape[-1])
    if words.is_cuda:
        out = torch.empty((rows.shape[0], 4, 1 << log_size), dtype=torch.int32, device=words.device)
        lib = _build.library()
        _build.check_launch(lib.frieda_ingest(
            words.data_ptr(), out.data_ptr(), log_size, ingest_tile(log_size), rows.shape[1],
            rows.shape[0], _build.stream_of(words)))
        ingest.launches += 1
    else:
        out = torch.stack([narrow(ingest_plain(widen(row), log_size)) for row in rows])
    return out if words.dim() == 2 else out[0]


ingest.launches = 0
