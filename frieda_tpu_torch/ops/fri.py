"""Kernel 6, `fri_fold`: one FRI fold, (4, M) QM31 columns -> (4, M/2).

Replaces `fold_c` / `fold_l` of `frieda_tpu/core/fri.py:_fri_commit_fn`
(:211-225), which XLA fuses inside the commit phase's one dispatch (vmapped
over the blobs in the batched one); no Pallas kernel. With lo and hi the
two natural-order halves,

    g = (lo + hi) + alpha * (lo - hi) * inv

in QM31; inv is `ys_inv` for the circle fold and `xs_layers_inv[l]` for
line fold l (`core/fri.fold_tables`). alpha is a (4,) int32 tensor on the
device, where the transcript kernel drew it. One launch, one thread per
output element (`csrc/fri.cu`), also for a batch of blobs (the batched
commit phase) or of one layer's shards (the sharded commit phase).
"""

from __future__ import annotations

import torch

from ..core.field import m31_add, m31_mul, m31_sub, qm31_mul
from ..utils.convert import narrow, widen
from . import _build


def fri_fold_plain(values: torch.Tensor, alpha, inv: torch.Tensor) -> torch.Tensor:
    """Plain version on int64 u32 values: (4, M) -> (4, M/2). alpha: (4,)
    values or a QM31 tuple of ints or 0-d tensors; inv: (M/2,). A batch
    (B, 4, M) -> (B, 4, M/2) folds each blob with alpha[b] ((B, 4); a (4,)
    alpha is shared) and inv[b] ((B, M/2); an (M/2,) table is shared)."""
    if values.dim() == 3:
        alphas = alpha if isinstance(alpha, torch.Tensor) and alpha.dim() == 2 else [alpha] * len(values)
        invs = inv if inv.dim() == 2 else [inv] * len(values)
        return torch.stack([fri_fold_plain(v, a, i) for v, a, i in zip(values, alphas, invs)])
    half = values.shape[1] // 2
    lo, hi = values[:, :half], values[:, half:]
    f1 = m31_mul(m31_sub(lo, hi), inv)
    return m31_add(m31_add(lo, hi), torch.stack(qm31_mul(tuple(alpha), tuple(f1))))


def fri_fold(values: torch.Tensor, alpha: torch.Tensor, inv: torch.Tensor,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """int32 form of `fri_fold_plain`: values (4, M) canonical M31 words, M
    even; alpha (4,); inv (M/2,); all int32 on one device. Returns (4, M/2)
    int32, written into `out` when given (a contiguous tensor of that
    shape). A batch, values (B, 4, M) -> (B, 4, M/2), folds in the same one
    launch: alpha (B, 4), one draw a blob, or (4,) shared by every blob (the
    shards of one layer); inv (M/2,) shared, or (B, M/2), a table a row
    (`core/fri.block_fold_tables`). Launches the kernel on CUDA tensors,
    runs the plain version on CPU tensors."""
    if values.dim() not in (2, 3) or values.shape[-2] != 4 or values.shape[-1] < 2 or values.shape[-1] % 2 \
            or not values.shape[0]:
        raise ValueError(f"values: expected (4, M) or (B >= 1, 4, M) with M even, got {tuple(values.shape)}")
    half = values.shape[-1] // 2
    lead = tuple(values.shape[:-2])
    blobs = values.shape[0] if lead else 1
    _build.check_u32(values, "values", tuple(values.shape))
    _build.check_u32(alpha, "alpha", lead + (4,) if alpha.dim() == 2 or not lead else (4,))
    _build.check_u32(inv, "inv", lead + (half,) if inv.dim() == 2 or not lead else (half,))
    if out is None:
        out = torch.empty(lead + (4, half), dtype=torch.int32, device=values.device)
    _build.check_u32(out, "out", lead + (4, half))
    _build.check_same_device(values, alpha, inv, out)
    if not values.is_cuda:
        return out.copy_(narrow(fri_fold_plain(widen(values), widen(alpha), widen(inv))))
    _build.check_launch(_build.library().frieda_fri_fold(
        values.data_ptr(), alpha.data_ptr(), inv.data_ptr(), out.data_ptr(), half, blobs,
        4 if alpha.dim() == 2 else 0, half if inv.dim() == 2 else 0, _build.stream_of(values)))
    fri_fold.launches += 1
    return out


fri_fold.launches = 0
