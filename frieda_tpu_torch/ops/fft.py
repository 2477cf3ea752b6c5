"""Kernel 3, `fft_pass`: a group of consecutive circle-FFT butterfly stages.

Replaces the three Pallas passes of `frieda_tpu/ops/fft_pallas.py` (the low
pass `_run_low_pass`, the dilating low pass `_run_low_pass_dilating` and the
mid pass `_run_mid_pass`): one CUDA kernel (`csrc/fft.cu`) runs the stages at
bits [p_lo, p_hi) of a (C, 2^n) array, and the first group of a transform
reads the undilated coefficients through read-index math.

Tiles: a block owns the 2^g elements that differ only in the group's bits
[p_lo, p_hi), times 2^k contiguous low-bit columns (bits [0, k)), and runs
all g stages on them: in registers, in rounds of at most 4 stage bits, with
shared memory only for the exchange between rounds (`csrc/fft.cu`). Tiles
are disjoint, so every group after the first updates the output in place.
`pass_plan` is a pure function of (n, log_l), so the CPU tests run the same
groups through the plain version.
"""

from __future__ import annotations

import functools

import torch

from ..core import fft as core_fft
from ..utils.convert import narrow, widen
from . import _build

TILE_LOG = 15        # a tile holds at most 2^15 u32: 128 KB of shared memory
FIRST_TILE_LOG = 14  # the dilating first group's: 64 KB, two blocks an SM
COL_LOG = 4          # 16 contiguous low-bit columns: 64-byte rows


@functools.lru_cache(maxsize=64)
def pass_plan(n: int, log_l: int):
    """Group the executed stage bits [p_min, n) into kernel launches.

    Returns (p_min, groups), each group (p_lo, p_hi, col_log) with
    (p_hi - p_lo) + col_log <= TILE_LOG and col_log <= p_lo: as few groups
    of at most TILE_LOG - COL_LOG stage bits as cover log_l, of near-equal
    size, the larger first (two at n = 22, 24, 26 with log_l = n - 4). The
    first group reads 1/2^p_min of what it writes and is bound by
    instructions, not bytes: its tile stays within FIRST_TILE_LOG, so two
    blocks share an SM (col_log 3 at n = 26). A constant polynomial
    (log_l == 0) still gets one zero-stage group: it writes the dilated
    copy."""
    p_min = n - log_l
    if log_l == 0:
        return p_min, ((n, n, min(n, TILE_LOG)),)
    count = -(-log_l // (TILE_LOG - COL_LOG))
    groups = []
    p = p_min
    for q in range(count):
        g = log_l // count + (q < log_l % count)
        groups.append((p, p + g, min(p, COL_LOG, (TILE_LOG if q else FIRST_TILE_LOG) - g)))
        p += g
    return p_min, tuple(groups)


def fft_pass_plain(src: torch.Tensor, twiddles: torch.Tensor, n: int,
                   p_lo: int, p_hi: int, src_shift: int) -> torch.Tensor:
    """Plain version: (C, 2^(n - src_shift)) int64 -> (C, 2^n) int64, the
    source dilated by 2^src_shift and then the stages at bits [p_lo, p_hi)."""
    return core_fft.run_stages(core_fft.dilate(src, src_shift), twiddles, p_lo, p_hi)


def fft_pass(src: torch.Tensor, twiddles: torch.Tensor, out: torch.Tensor,
             p_lo: int, p_hi: int, col_log: int, src_shift: int) -> torch.Tensor:
    """Stages at bits [p_lo, p_hi) into `out` ((C, 2^n) int32), reading
    `src` ((C, 2^(n - src_shift)) int32) dilated by 2^src_shift, with
    src_shift <= p_lo. `out` may be `src` when src_shift == 0 (in place).
    Launches the kernel on a CUDA tensor, runs the plain version on a CPU
    tensor."""
    C, N = out.shape
    n = N.bit_length() - 1
    _build.check_u32(out, "out", (C, N))
    _build.check_u32(src, "src", (C, N >> src_shift))
    _build.check_u32(twiddles, "twiddles", ((1 << n) - 1,))
    if N != 1 << n or not 0 <= src_shift <= n:
        raise ValueError(f"bad shapes: out {tuple(out.shape)}, src_shift {src_shift}")
    g = p_hi - p_lo
    if not (0 <= col_log <= p_lo <= p_hi <= n and g + col_log <= TILE_LOG
            and src_shift <= p_lo):
        raise ValueError(f"bad stage group ({p_lo}, {p_hi}, {col_log}) for n={n}")
    if src_shift and src.data_ptr() == out.data_ptr():
        raise ValueError("a dilating pass cannot run in place")
    _build.check_same_device(src, twiddles, out)
    if out.is_cuda:
        lib = _build.library()
        _build.check_launch(lib.frieda_fft_pass(
            src.data_ptr(), out.data_ptr(), twiddles.data_ptr(), C, n, p_lo, p_hi,
            col_log, src_shift, _build.stream_of(out)))
        fft_pass.launches += 1
        return out
    out.copy_(narrow(fft_pass_plain(widen(src), twiddles, n, p_lo, p_hi, src_shift)))
    return out


fft_pass.launches = 0
