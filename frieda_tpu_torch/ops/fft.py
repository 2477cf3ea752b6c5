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

Kernel 9, `fft_exchange`: the butterfly stage whose pairs lie on two shards
of an element-sharded transform (`parallel/fft_sharded.py`), which the JAX
package leaves to XLA (`frieda_tpu/parallel/fft_sharded.py:298-309`): rows
of the low and the high shard, one twiddle a row, updated in place, one
thread a pair (`csrc/fft.cu`).
"""

from __future__ import annotations

import functools

import torch

from ..core import fft as core_fft
from ..core.field import m31_add, m31_mul, m31_sub
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


def fft_exchange_plain(lo: torch.Tensor, hi: torch.Tensor, twiddles: torch.Tensor) -> tuple:
    """Plain version on int64 values: lo, hi (A, B, L), twiddles (B,) ->
    (lo + t * hi, lo - t * hi) with t = twiddles[b] on row (a, b)."""
    u = m31_mul(twiddles[:, None], hi)
    return m31_add(lo, u), m31_sub(lo, u)


def fft_exchange(lo: torch.Tensor, hi: torch.Tensor, twiddles: torch.Tensor,
                 write_lo: bool = True, write_hi: bool = True) -> None:
    """One cross-shard butterfly stage in place: lo <- lo + t * hi and hi <- lo
    - t * hi (each only if its write flag is set), with t = twiddles[b] on row
    (a, b). lo and hi: (A, B, L) int32 views with the same strides, each row
    of L contiguous words, the B rows of one a contiguous, and no word of lo
    in hi: the low and high halves of a (S, C, 2^m) block viewed as (S /
    2^(p+1), 2, 2^p, C * 2^m), or two separate (1, 1, C * 2^m) shards;
    twiddles (B,). Launches the kernel on CUDA tensors, runs the plain
    version on CPU tensors."""
    if lo.dim() != 3 or lo.shape != hi.shape or lo.stride() != hi.stride():
        raise ValueError(f"lo {tuple(lo.shape)} / {lo.stride()} and hi {tuple(hi.shape)} / "
                         f"{hi.stride()}: expected two (A, B, L) views of the same strides")
    A, B, L = lo.shape
    for name, t in (("lo", lo), ("hi", hi)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected torch.int32 (u32 bits), got {t.dtype}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: unsupported device {t.device}")
    if not A * B * L or lo.stride(2) != 1 or lo.stride(1) != L or lo.stride(0) < B * L:
        raise ValueError(f"lo/hi: rows of L contiguous words expected, got shape {(A, B, L)}, "
                         f"strides {lo.stride()}")
    d, s0 = (hi.data_ptr() - lo.data_ptr()) // 4, lo.stride(0)
    k = min(A - 1, max(1 - A, -round(d / s0)))  # the row offset that brings hi closest to lo
    if any(abs(d + j * s0) < B * L for j in (k - 1, k, k + 1) if abs(j) < A):
        raise ValueError("lo and hi overlap")
    if not (write_lo or write_hi):
        raise ValueError("nothing to write")
    _build.check_u32(twiddles, "twiddles", (B,))
    _build.check_same_device(lo, hi, twiddles)
    if lo.is_cuda:
        if A * B > 65535:
            raise ValueError(f"{A * B} rows: at most 65535 a launch")
        _build.check_launch(_build.library().frieda_fft_exchange(
            lo.data_ptr(), hi.data_ptr(), twiddles.data_ptr(), A * B, B, lo.stride(0), L,
            int(write_lo) | int(write_hi) << 1, _build.stream_of(lo)))
        fft_exchange.launches += 1
        return
    new_lo, new_hi = fft_exchange_plain(widen(lo), widen(hi), widen(twiddles))
    if write_lo:
        lo.copy_(narrow(new_lo))
    if write_hi:
        hi.copy_(narrow(new_hi))


fft_exchange.launches = 0
