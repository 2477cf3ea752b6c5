"""Circle FFT (low-degree extension) on torch tensors.

Counterpart of `frieda_tpu/core/fft.py`. Coefficients come in
*bit-reversed* order and evaluations leave in *natural* domain order, so
every butterfly stage pairs whole contiguous sub-blocks (layout note in
`core/circle.py`).

Stage model, by bit position p (depth d = n-1-p in the JAX docstring): the
stage at bit p pairs flat indices j and j + 2^p (bit p of j clear) with the
twiddle T_p[j mod 2^p], T_p = Twiddles(n).eval_stage_twiddle(n-1-p):

    out[j]       = x[j] + T_p[j mod 2^p] * x[j + 2^p]
    out[j + 2^p] = x[j] - T_p[j mod 2^p] * x[j + 2^p]

Stages run p = p_min .. n-1 with p_min = n - log_l: the lower bits are the
free Reed-Solomon dilation, element j of the dilated vector being
coeffs[j >> p_min].

`evaluate` is the plain version (int64, one stage at a time);
`evaluate_auto` runs the stage groups of `ops.fft.pass_plan` through the
`fft_pass` kernel on a CUDA tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from . import circle as hostcircle
from .field import m31_add, m31_mul, m31_sub

_stage_twiddles_dev: dict = {}


def stage_twiddles(n: int, device) -> torch.Tensor:
    """All stage tables of the domain of log size n as ONE flat int32 tensor
    on `device`, indexed by bit: T_p = tw[2^p - 1 : 2^(p+1) - 1] (length
    2^p). The same values as JAX `fft.stage_twiddles(n)` (a tuple indexed by
    depth), concatenated from p = 0 up. Cached per (n, device)."""
    device = torch.device(device)
    key = (n, str(device))
    cached = _stage_twiddles_dev.get(key)
    if cached is not None:
        return cached
    flat = np.zeros((1 << n) - 1, np.uint32)
    if n >= 1:
        tw = hostcircle.get_twiddles(n)
        for p in range(n):
            flat[(1 << p) - 1 : (1 << (p + 1)) - 1] = tw.eval_stage_twiddle(n - 1 - p)
    # every twiddle is < P < 2^31: the int32 view holds the value itself
    table = torch.from_numpy(flat.view(np.int32)).to(device)
    _stage_twiddles_dev[key] = table
    return table


def twiddles_log_size(twiddles: torch.Tensor) -> int:
    """n of a `stage_twiddles(n)` table (2^n - 1 entries)."""
    n = (twiddles.numel() + 1).bit_length() - 1
    if (1 << n) - 1 != twiddles.numel():
        raise ValueError(f"not a stage-twiddle table: {twiddles.numel()} entries")
    return n


def _log_len(coeffs_rev: torch.Tensor, n: int) -> int:
    """log_l of (C, 2^log_l) coefficients for a domain of log size n."""
    if coeffs_rev.dim() != 2:
        raise ValueError(f"expected (C, 2^log_l) coefficients, got {tuple(coeffs_rev.shape)}")
    log_l = coeffs_rev.shape[1].bit_length() - 1
    if coeffs_rev.shape[1] != 1 << log_l or log_l > n:
        raise ValueError(f"bad coefficient shape {tuple(coeffs_rev.shape)} for n={n}")
    return log_l


def dilate(src: torch.Tensor, shift: int) -> torch.Tensor:
    """(C, S) -> (C, S * 2^shift) with out[:, j] = src[:, j >> shift]."""
    return src.repeat_interleave(1 << shift, dim=1) if shift else src


def run_stages(x: torch.Tensor, twiddles: torch.Tensor, p_lo: int, p_hi: int) -> torch.Tensor:
    """Butterfly stages at bits p_lo .. p_hi-1 over (C, 2^n) int64 values."""
    C, N = x.shape
    for p in range(p_lo, p_hi):
        e = 1 << p
        t = twiddles[e - 1 : 2 * e - 1].to(torch.int64)
        xv = x.reshape(C, N // (2 * e), 2, e)
        g0 = xv[:, :, 0]
        u = m31_mul(t, xv[:, :, 1])
        x = torch.stack([m31_add(g0, u), m31_sub(g0, u)], dim=2).reshape(C, N)
    return x


def evaluate(coeffs_rev: torch.Tensor, twiddles: torch.Tensor) -> torch.Tensor:
    """Plain version. coeffs_rev: (C, 2^log_l) int64 bit-reversed
    coefficients, log_l <= n; twiddles: stage_twiddles(n). Returns (C, 2^n)
    int64 evaluations in natural domain order."""
    n = twiddles_log_size(twiddles)
    p_min = n - _log_len(coeffs_rev, n)
    return run_stages(dilate(coeffs_rev, p_min), twiddles, p_min, n)


def evaluate_auto(coeffs_rev: torch.Tensor, twiddles: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """`evaluate` on int32 (u32 bits) tensors, run as the stage groups of
    `ops.fft.pass_plan`: the first group reads the undilated coefficients,
    the rest update the output in place. On a CUDA tensor every group is one
    `fft_pass` kernel launch; on a CPU tensor each group runs its plain
    version. A batch (B, 4, 2^log_l) -> (B, 4, 2^n) runs as the 4B columns
    of one (4B, 2^log_l) array (`commit_many`): the same launches.

    `twiddles` may be any table of the `stage_twiddles` shape: a shard of
    an element-sharded transform passes its own (`parallel/fft_sharded.py`).
    `out`, a contiguous (C, 2^n) int32 tensor, receives the evaluations (it
    may be `coeffs_rev` itself when log_l == n)."""
    from ..ops import fft as fft_ops

    n = twiddles_log_size(twiddles)
    if coeffs_rev.dim() == 3:
        flat = evaluate_auto(coeffs_rev.reshape(-1, coeffs_rev.shape[-1]), twiddles)
        return flat.view(*coeffs_rev.shape[:2], flat.shape[-1])
    p_min, groups = fft_ops.pass_plan(n, _log_len(coeffs_rev, n))
    if out is None:
        out = torch.empty((coeffs_rev.shape[0], 1 << n), dtype=torch.int32, device=coeffs_rev.device)
    src, shift = coeffs_rev, p_min
    for p_lo, p_hi, col_log in groups:
        fft_ops.fft_pass(src, twiddles, out, p_lo, p_hi, col_log, shift)
        src, shift = out, 0
    return out
