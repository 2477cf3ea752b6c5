"""Vectorized host-side M31/QM31 arithmetic (numpy uint64).

Jax-free copy of `frieda_tpu/core/npfield.py`. The verifier (`core/fri.py`)
is host code: it folds ~n_queries values per FRI layer as one numpy vector
op per layer. `tests/test_torch_verify.py` holds these functions against
the JAX package's.

Representation: M31 values are uint64 arrays with entries < P; QM31 values
are (m, 4) uint64 arrays with columns (a, b, c, d) meaning (a + b i) +
(c + d i) u, u^2 = 2 + i — the same coordinate order as `core/field.py`.
Products of canonical values fit uint64 (x*y < 2^62), so plain `* %` is
exact.
"""

from __future__ import annotations

import numpy as np

P = (1 << 31) - 1


def m31_mul(a, b):
    return a * b % P


def m31_inv(a: np.ndarray) -> np.ndarray:
    """Batched a^(P-2) (Fermat); zero maps to zero (caller beware)."""
    e = P - 2
    acc = np.ones_like(a)
    base = a % P
    while e:
        if e & 1:
            acc = acc * base % P
        base = base * base % P
        e >>= 1
    return acc


def qm31_arr(vals) -> np.ndarray:
    """list of (a, b, c, d) tuples -> (m, 4) uint64 array."""
    return np.asarray(vals, np.uint64).reshape(-1, 4)


def qm31_add(x, y):
    return (x + y) % P


def qm31_sub(x, y):
    return (x - y + P) % P


def qm31_mul_m31(x, s):
    """x: (m, 4); s: (m,) or scalar M31 — componentwise scale."""
    return x * np.asarray(s, np.uint64).reshape(-1, 1) % P


def _cm31_mul(xr, xi, yr, yi):
    return (xr * yr + (P - xi) * yi % P) % P, (xr * yi + xi * yr) % P


def qm31_mul(x, y):
    """(m, 4) * (m, 4) (or broadcastable (1, 4)) -> (m, 4)."""
    a, b = (x[:, 0], x[:, 1]), (x[:, 2], x[:, 3])
    c, d = (y[:, 0], y[:, 1]), (y[:, 2], y[:, 3])
    ac = _cm31_mul(*a, *c)
    bd = _cm31_mul(*b, *d)
    # bd * (2 + i) = (2*bd_r - bd_i, bd_r + 2*bd_i)
    lo = ((ac[0] + 2 * bd[0] + (P - bd[1])) % P, (ac[1] + bd[0] + 2 * bd[1]) % P)
    ad = _cm31_mul(*a, *d)
    bc = _cm31_mul(*b, *c)
    hi = ((ad[0] + bc[0]) % P, (ad[1] + bc[1]) % P)
    return np.stack([lo[0], lo[1], hi[0], hi[1]], axis=1)


def bitrev(js: np.ndarray, bits: int) -> np.ndarray:
    """Vectorized bit-reversal of index arrays over `bits` bits."""
    js = np.asarray(js, np.uint64)
    r = np.zeros_like(js)
    for i in range(bits):
        r |= ((js >> np.uint64(i)) & np.uint64(1)) << np.uint64(bits - 1 - i)
    return r
