"""Bit-exact transfer of u32 data between numpy and the port's tensors.

The JAX package keeps every word (felts, hash words, twiddles) in numpy /
jnp `uint32`. The port stores the same bits two ways:

  * kernels and the orchestration around them take `torch.int32` holding the
    u32 bits (values >= 2^31 read as negative);
  * plain PyTorch versions hold the u32 value in `torch.int64`, because
    torch's CPU `uint32` lacks add, shift and compare.

`from_numpy_u32` / `to_numpy_u32` move the JAX side's arrays in and out
(columns (4, N), levels (8, M), twiddle tables); `widen` / `narrow` convert at
a wrapper boundary.
"""

from __future__ import annotations

import numpy as np
import torch

U32_MASK = 0xFFFFFFFF


def from_numpy_u32(arr: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 array -> int32 tensor on `device` with the same bits."""
    arr = np.ascontiguousarray(arr, dtype=np.uint32)
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """int32 (u32 bits) or int64 (u32 values) tensor -> numpy uint32 array."""
    if t.dtype == torch.int64:
        t = narrow(t)
    if t.dtype != torch.int32:
        raise TypeError(f"expected int32 or int64, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def widen(t: torch.Tensor) -> torch.Tensor:
    """int32 u32 bits -> int64 u32 values in [0, 2^32)."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected int32, got {t.dtype}")
    return t.to(torch.int64) & U32_MASK


def narrow(t: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> int32 tensor with the same low 32 bits."""
    if t.dtype != torch.int64:
        raise TypeError(f"expected int64, got {t.dtype}")
    return (t & U32_MASK).to(torch.int32)
