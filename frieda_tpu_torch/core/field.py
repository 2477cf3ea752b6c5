"""M31 arithmetic on torch int64 tensors (plain versions).

Counterpart of the M31 half of `frieda_tpu/core/field.py`. Values are
canonical u32 words in [0, P) held in `torch.int64`: a product of two of
them is < 2^62, so it is formed directly and reduced with `%`, where the TPU
version splits into 16-bit limbs for lack of a 64-bit multiply. Results are
the canonical representatives, bit-identical with the JAX functions.
CM31/QM31 come with the prover.
"""

from __future__ import annotations

import torch

P = (1 << 31) - 1


def m31_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b  # < 2P
    return torch.where(s >= P, s - P, s)


def m31_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + (P - b)  # in (0, 2P]
    return torch.where(s >= P, s - P, s)


def m31_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b) % P
