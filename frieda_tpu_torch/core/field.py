"""M31 / CM31 / QM31 arithmetic on torch int64 tensors (plain versions).

Counterpart of `frieda_tpu/core/field.py`. Values are canonical u32 words in
[0, P) held in `torch.int64`: a product of two of them is < 2^62, so it is
formed directly and reduced with `%`, where the TPU version splits into
16-bit limbs for lack of a 64-bit multiply. Results are the canonical
representatives, bit-identical with the JAX functions.

QM31 values are 4-tuples (a, b, c, d) meaning (a + b i) + (c + d i) u with
i^2 = -1, u^2 = 2 + i, as in the JAX package. Any element of a tuple may be
a Python int (a constant such as a drawn FRI alpha) instead of a tensor.
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


def m31_neg(a: torch.Tensor) -> torch.Tensor:
    return (P - a) % P


def m31_pow(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a Python exponent e >= 0 (square and multiply)."""
    acc = torch.ones_like(a)
    base = a
    while e:
        if e & 1:
            acc = m31_mul(acc, base)
        e >>= 1
        if e:
            base = m31_mul(base, base)
    return acc


def m31_inv(a: torch.Tensor) -> torch.Tensor:
    """a^(P-2); zero maps to zero, as in the JAX package."""
    return m31_pow(a, P - 2)


# -- CM31: pairs (re, im) -----------------------------------------------------

def cm31_add(x, y):
    return (m31_add(x[0], y[0]), m31_add(x[1], y[1]))


def cm31_sub(x, y):
    return (m31_sub(x[0], y[0]), m31_sub(x[1], y[1]))


def cm31_mul(x, y):
    return (
        m31_sub(m31_mul(x[0], y[0]), m31_mul(x[1], y[1])),
        m31_add(m31_mul(x[0], y[1]), m31_mul(x[1], y[0])),
    )


# -- QM31: 4-tuples (a, b, c, d); u^2 = 2 + i -----------------------------------

def qm31_add(x, y):
    return tuple(m31_add(x[i], y[i]) for i in range(4))


def qm31_sub(x, y):
    return tuple(m31_sub(x[i], y[i]) for i in range(4))


def qm31_mul(x, y):
    a_, b_ = (x[0], x[1]), (x[2], x[3])
    c_, d_ = (y[0], y[1]), (y[2], y[3])
    ac = cm31_mul(a_, c_)
    bd = cm31_mul(b_, d_)
    # bd * (2 + i) = (2*bd0 - bd1, bd0 + 2*bd1)
    r = (m31_sub(m31_mul(bd[0], 2), bd[1]), m31_add(bd[0], m31_mul(bd[1], 2)))
    lo = cm31_add(ac, r)
    hi = cm31_add(cm31_mul(a_, d_), cm31_mul(b_, c_))
    return (lo[0], lo[1], hi[0], hi[1])


def qm31_mul_m31(x, s):
    return tuple(m31_mul(x[i], s) for i in range(4))
