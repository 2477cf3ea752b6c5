"""Element-sharded circle FFT (low-degree extension) in the cyclic layout.

Counterpart of `frieda_tpu/parallel/fft_sharded.py`, with another layout:
the JAX package shards the evaluations contiguously and XLA moves them; here
natural column j lives on shard s = j mod S (`mesh.py`), which keeps every
Merkle level and fold after the extension on one shard. The stage model is
`core/fft.py`'s: the stage at bit p pairs j and j + 2^p with the twiddle
T_p[j mod 2^p], stages p_min .. n-1, p_min = n - log_l.

  * A stage at bit p >= log2 S pairs local columns i and i + 2^(p - log2 S)
    of one shard. Shard s runs these stages as the single-device transform
    of its (C, 2^m) part, m = n - log2 S (`core/fft.evaluate_auto`, the
    `fft_pass` kernel), with its own table T'_{p'} = T_{p' + log2 S}[s::S]
    (`block_twiddles`: cut on the device from the cached full table, one
    (k, 2^m - 1) tensor for a block of k shards, kept by the mesh).
  * A stage at bit p < log2 S pairs shard s with shard s + 2^p, element for
    element, at the one twiddle T_p[s mod 2^p]: the `fft_exchange` kernel
    (`ops/fft.py`). These stages come first (p_min <= p < log2 S) and run
    only when log2 S > p_min: a commit has p_min = log_blowup, so at log_blowup
    4 up to 16 shards need no exchange at all.
  * The dilation: for p_min >= log2 S every shard starts from the whole
    coefficient vector, dilated by 2^(p_min - log2 S) (one tensor shared by
    the shards of a device); for p_min < log2 S shard s starts from the
    coefficients (s >> p_min), (s >> p_min) + 2^(log2 S - p_min), ...
"""

from __future__ import annotations

import torch

from ..core import fft
from ..ops import fft as fft_ops
from .mesh import Mesh, Sharded, new_sharded

def block_twiddles(mesh: Mesh, n: int, e0: int, k: int, device) -> torch.Tensor:
    """The stage tables of shards e0 .. e0 + k - 1 for the local stages of a
    2^n domain on the mesh's S = 2^log_s shards: a (k, 2^m - 1) int32 tensor,
    m = n - log_s, whose row i is laid out as `core/fft.stage_twiddles(m)`
    with stage p' = T_{p' + log_s}[e0 + i :: S]. Cut on the device out of the
    cached full table (one strided copy a stage) and kept by the mesh."""
    def build():
        full = fft.stage_twiddles(n, device)
        m = n - mesh.log_elem
        out = torch.empty((k, (1 << m) - 1), dtype=torch.int32, device=device)
        for q in range(m):
            p = q + mesh.log_elem
            stage = full[(1 << p) - 1 : (1 << (p + 1)) - 1].view(1 << q, mesh.n_elem)
            out[:, (1 << q) - 1 : (1 << (q + 1)) - 1] = stage[:, e0 : e0 + k].T
        return out

    return mesh.cached(("stage_twiddles", n, e0, k, str(torch.device(device))), build)


def exchange_twiddles(n: int, p: int, device) -> torch.Tensor:
    """T_p of a 2^n domain (2^p twiddles; p below log2 S): a view of the
    cached `core/fft.stage_twiddles(n)` on `device`. Entry b is the twiddle
    of the pairs of shards s and s + 2^p with s mod 2^p = b."""
    return fft.stage_twiddles(n, device)[(1 << p) - 1 : (1 << (p + 1)) - 1]


def _supported(n: int, log_l: int, log_s: int) -> bool:
    """The shapes the sharded transform takes (the JAX package's rule): every
    shard holds at least one coefficient and two evaluations."""
    return log_l >= log_s and n - log_s >= 1 and log_s >= 0


def exchange_stage(x: Sharded, n: int, p: int) -> None:
    """The stage at bit p < log2 S of a 2^n domain, in place: shard s and
    shard s + 2^p (bit p of s clear) become x_s + t x_{s+2^p} and x_s - t
    x_{s+2^p}, t = T_p[s mod 2^p]. One `fft_exchange` launch when one block
    holds the whole row; else one a pair on one device, and one a shard whose
    partner is on another device or in another process (`Mesh.swap`), which
    keeps its own half."""
    whole = x.whole()
    if whole is not None:
        v = whole.view(whole.shape[0] >> (p + 1), 2, 1 << p, -1)
        fft_ops.fft_exchange(v[:, 0], v[:, 1], exchange_twiddles(n, p, whole.device))
        return
    parts = x.parts
    copies = x.mesh.swap(x.row, p, parts)
    for e, own in parts.items():
        tw = exchange_twiddles(n, p, own.device)
        b = e & ((1 << p) - 1)
        low = not (e >> p) & 1
        if e in copies:
            other = copies[e].view(1, 1, -1)
            lo, hi = (own.view(1, 1, -1), other) if low else (other, own.view(1, 1, -1))
            fft_ops.fft_exchange(lo, hi, tw[b : b + 1], write_lo=low, write_hi=not low)
        elif low:
            fft_ops.fft_exchange(own.view(1, 1, -1), parts[e ^ (1 << p)].view(1, 1, -1), tw[b : b + 1])


def sharded_evaluate(coeffs_rev: torch.Tensor, n: int, mesh: Mesh, row: int | None = None) -> Sharded:
    """Evaluate (C, 2^log_l) int32 bit-reversed coefficients onto the 2^n
    domain, element-sharded over the `elem` axis of mesh row `row` (this
    process's first row by default) in the cyclic layout: shard s's part is
    the natural-order evaluations [:, s::S]. `.gather()` gives the whole
    (C, 2^n) array in natural order (for tests). Counterpart of
    `frieda_tpu/parallel/fft_sharded.sharded_evaluate`.

    The coefficients go to each device of the row once, shared by its
    shards. Shapes the sharded transform does not take (`_supported`: fewer
    coefficients than shards, or fewer than two evaluations a shard) fall
    back, as in the JAX package, to the unsharded `core/fft.evaluate_auto`
    on the row's home device, whose result is then split into the parts; a
    domain smaller than S raises ValueError."""
    C, L = coeffs_rev.shape
    log_l = L.bit_length() - 1
    if L != 1 << log_l or log_l > n:
        raise ValueError(f"bad coefficient shape {tuple(coeffs_rev.shape)} for n={n}")
    row = mesh.rows()[0] if row is None else row
    S, log_s = mesh.n_elem, mesh.log_elem
    if n < log_s:
        raise ValueError(f"a 2^{n} domain over {S} shards: fewer than one evaluation a shard")
    if not _supported(n, log_l, log_s):
        home = mesh.home(row)
        full = fft.evaluate_auto(coeffs_rev.to(home), fft.stage_twiddles(n, home))
        cols = full.view(C, -1, S)
        return Sharded(mesh, row, [(e0, cols[:, :, e0 : e0 + k].permute(2, 0, 1).to(dev).contiguous())
                                   for e0, k, dev in mesh.blocks(row)])
    m, p_min = n - log_s, n - log_l
    out = new_sharded(mesh, row, (C, 1 << m))
    for e0, block in out.blocks:
        src = coeffs_rev.to(block.device)
        for i in range(block.shape[0]):
            if p_min >= log_s:  # no exchange: the local stages read the dilated coefficients
                tables = block_twiddles(mesh, n, e0, block.shape[0], block.device)
                fft.evaluate_auto(src, tables[i], out=block[i])
            else:
                block[i].copy_(src[:, (e0 + i) >> p_min :: 1 << (log_s - p_min)])
    if p_min < log_s:
        for p in range(p_min, log_s):
            exchange_stage(out, n, p)
        for e0, block in out.blocks:
            tables = block_twiddles(mesh, n, e0, block.shape[0], block.device)
            for i in range(block.shape[0]):
                fft.evaluate_auto(block[i], tables[i], out=block[i])
    return out
