"""Reference-spec M31 / CM31 / QM31 field arithmetic over Python ints.

This module is the *conformance oracle*: deliberately simple, obviously-correct
arithmetic used to validate the JAX/Pallas device kernels. It mirrors the field
tower used by the Rust reference via stwo-prover (see SURVEY.md Appendix A.2 /
B.1; reference use-sites: the upstream's src/lib.rs:14, src/proof.rs:6).

  M31  : integers mod P = 2**31 - 1 (Mersenne prime)
  CM31 : M31[i] / (i^2 + 1)
  QM31 : CM31[u] / (u^2 - (2 + i))   -- the "secure field" (~124 bits)
"""

from __future__ import annotations

P = (1 << 31) - 1  # 2147483647


# ---------------------------------------------------------------------------
# M31 (base field) — canonical representatives in [0, P)
# ---------------------------------------------------------------------------

def m31_add(a: int, b: int) -> int:
    return (a + b) % P


def m31_sub(a: int, b: int) -> int:
    return (a - b) % P


def m31_mul(a: int, b: int) -> int:
    return (a * b) % P


def m31_neg(a: int) -> int:
    return (-a) % P


def m31_inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("M31 inverse of zero")
    return pow(a, P - 2, P)


def m31_pow(a: int, e: int) -> int:
    return pow(a, e, P)


# ---------------------------------------------------------------------------
# CM31 = M31[i], elements are tuples (re, im)
# ---------------------------------------------------------------------------

def cm31_add(a, b):
    return (m31_add(a[0], b[0]), m31_add(a[1], b[1]))


def cm31_sub(a, b):
    return (m31_sub(a[0], b[0]), m31_sub(a[1], b[1]))


def cm31_mul(a, b):
    # (a0 + a1 i)(b0 + b1 i) = (a0 b0 - a1 b1) + (a0 b1 + a1 b0) i
    return (
        m31_sub(m31_mul(a[0], b[0]), m31_mul(a[1], b[1])),
        m31_add(m31_mul(a[0], b[1]), m31_mul(a[1], b[0])),
    )


def cm31_neg(a):
    return (m31_neg(a[0]), m31_neg(a[1]))


def cm31_inv(a):
    # 1 / (x + yi) = (x - yi) / (x^2 + y^2)
    d = m31_inv(m31_add(m31_mul(a[0], a[0]), m31_mul(a[1], a[1])))
    return (m31_mul(a[0], d), m31_mul(m31_neg(a[1]), d))


CM31_ZERO = (0, 0)
CM31_ONE = (1, 0)
# u^2 = 2 + i
CM31_R = (2, 1)


# ---------------------------------------------------------------------------
# QM31 = CM31[u]/(u^2 - (2+i)) — elements are 4-tuples (a, b, c, d) meaning
# (a + b i) + (c + d i) u.  This matches stwo's coordinate order: a QM31 is
# (re, im) over CM31, each CM31 is (re, im) over M31, so the flat coordinate
# order is exactly the 4 base-field columns of a SecureEvaluation
# (SURVEY.md B.1; the upstream's src/proof.rs:62-66).
# ---------------------------------------------------------------------------

def qm31(a: int = 0, b: int = 0, c: int = 0, d: int = 0):
    return (a % P, b % P, c % P, d % P)


def qm31_add(x, y):
    return (m31_add(x[0], y[0]), m31_add(x[1], y[1]),
            m31_add(x[2], y[2]), m31_add(x[3], y[3]))


def qm31_sub(x, y):
    return (m31_sub(x[0], y[0]), m31_sub(x[1], y[1]),
            m31_sub(x[2], y[2]), m31_sub(x[3], y[3]))


def qm31_neg(x):
    return (m31_neg(x[0]), m31_neg(x[1]), m31_neg(x[2]), m31_neg(x[3]))


def qm31_mul(x, y):
    # (A + B u)(C + D u) = (AC + BD*(2+i)) + (AD + BC) u, A..D in CM31
    a_ = (x[0], x[1])
    b_ = (x[2], x[3])
    c_ = (y[0], y[1])
    d_ = (y[2], y[3])
    ac = cm31_mul(a_, c_)
    bd = cm31_mul(b_, d_)
    lo = cm31_add(ac, cm31_mul(bd, CM31_R))
    hi = cm31_add(cm31_mul(a_, d_), cm31_mul(b_, c_))
    return (lo[0], lo[1], hi[0], hi[1])


def qm31_mul_m31(x, s: int):
    return (m31_mul(x[0], s), m31_mul(x[1], s), m31_mul(x[2], s), m31_mul(x[3], s))


def qm31_inv(x):
    # (A + Bu)^-1 = (A - Bu) / (A^2 - (2+i) B^2)
    a_ = (x[0], x[1])
    b_ = (x[2], x[3])
    denom = cm31_sub(cm31_mul(a_, a_), cm31_mul(CM31_R, cm31_mul(b_, b_)))
    dinv = cm31_inv(denom)
    lo = cm31_mul(a_, dinv)
    hi = cm31_mul(cm31_neg(b_), dinv)
    return (lo[0], lo[1], hi[0], hi[1])


QM31_ZERO = (0, 0, 0, 0)
QM31_ONE = (1, 0, 0, 0)
