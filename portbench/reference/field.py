"""M31 and QM31 arithmetic on int64 tensors, canonical values in [0, P).

QM31 values are tensors whose axis `dim` holds the 4 coordinates (a, b, c,
d), meaning (a + b i) + (c + d i) u with i^2 = -1 and u^2 = 2 + i. A product
of two canonical values is below 2^62, so it is formed in int64 and reduced
with `%`.
"""

from __future__ import annotations

import torch

P = (1 << 31) - 1


def add(a, b):
    return (a + b) % P


def sub(a, b):
    return (a - b + P) % P


def mul(a, b):
    return (a * b) % P


def inv(a: torch.Tensor) -> torch.Tensor:
    """a^(P - 2) elementwise (zero maps to zero)."""
    acc = torch.ones_like(a)
    base = a % P
    e = P - 2
    while e:
        if e & 1:
            acc = acc * base % P
        base = base * base % P
        e >>= 1
    return acc


def qm31_mul(x: torch.Tensor, y: torch.Tensor, dim: int) -> torch.Tensor:
    """x * y for QM31 tensors broadcastable against each other, the 4
    coordinates along `dim` of both."""
    a0, a1, b0, b1 = x.unbind(dim)
    c0, c1, d0, d1 = y.unbind(dim)

    def cm(r0, i0, r1, i1):
        return sub(mul(r0, r1), mul(i0, i1)), add(mul(r0, i1), mul(i0, r1))

    ac = cm(a0, a1, c0, c1)
    bd = cm(b0, b1, d0, d1)
    ad = cm(a0, a1, d0, d1)
    bc = cm(b0, b1, c0, c1)
    # bd (2 + i) = (2 bd_r - bd_i, bd_r + 2 bd_i)
    lo = (add(ac[0], sub(2 * bd[0] % P, bd[1])), add(ac[1], add(bd[0], 2 * bd[1] % P)))
    hi = (add(ad[0], bc[0]), add(ad[1], bc[1]))
    return torch.stack([lo[0], lo[1], hi[0], hi[1]], dim=dim)
