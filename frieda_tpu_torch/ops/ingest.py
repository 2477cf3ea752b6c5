"""Kernel 4, `ingest`: u32 words -> (4, 2^log_size) bit-reversed coefficients.

Replaces `frieda_tpu/ops/ingest_pallas.py::ingest_rows` together with the
`bitrev_rows_device` step after it (`utils/packing.device_ingest_rev`): one
CUDA kernel (`csrc/ingest.cu`) writes each output element straight from its
two source words, for every log_size >= 0.

Output [c, r] is felt f = c*L + rev_{log_size}(r) (L = 2^log_size), and
felt f is bits [30f, 30f + 30) of the little-endian word stream:
(words[30f >> 5] >> s | words[(30f >> 5) + 1] << (32 - s)) & (2^30 - 1),
s = 30f & 31, the high word used only when s > 2.
"""

from __future__ import annotations

import torch

from ..core.circle import bitrev_permutation
from ..utils.convert import narrow, widen
from ..utils.packing import words_for
from . import _build

_MASK30 = (1 << 30) - 1
_M32 = 0xFFFFFFFF


def ingest_plain(words: torch.Tensor, log_size: int) -> torch.Tensor:
    """Plain version on int64 u32 values: (nw,) -> (4, 2^log_size)."""
    L = 1 << log_size
    rev = torch.from_numpy(bitrev_permutation(log_size).copy()).to(words.device)
    f = torch.arange(4, dtype=torch.int64, device=words.device)[:, None] * L + rev[None, :]
    bit = 30 * f  # int64: no overflow past log_total = 27
    idx = bit >> 5
    s = bit & 31
    lo = words[idx]
    hi = words[idx + 1]
    high = torch.where(s > 2, (hi << (32 - s)) & _M32, torch.zeros_like(hi))
    return ((lo >> s) | high) & _MASK30


def ingest(words: torch.Tensor, log_size: int) -> torch.Tensor:
    """words: (nw,) int32 from `pad_to_words` (log_total = log_size + 2),
    nw >= ceil(30 * 2^log_total / 32) + 1. Returns (4, 2^log_size) int32.
    Launches the kernel on a CUDA tensor, runs the plain version on a CPU
    tensor."""
    if log_size < 0:
        raise ValueError(f"log_size must be >= 0, got {log_size}")
    need = words_for(log_size + 2)
    if words.dim() != 1 or words.shape[0] < need:
        raise ValueError(f"words: expected >= {need} words, got {tuple(words.shape)}")
    _build.check_u32(words, "words", tuple(words.shape))
    if words.is_cuda:
        out = torch.empty((4, 1 << log_size), dtype=torch.int32, device=words.device)
        lib = _build.library()
        _build.check_launch(lib.frieda_ingest(
            words.data_ptr(), out.data_ptr(), log_size, _build.stream_of(words)))
        ingest.launches += 1
        return out
    return narrow(ingest_plain(widen(words), log_size))


ingest.launches = 0
