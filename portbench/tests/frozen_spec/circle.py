"""Reference-spec circle group over M31 and the cosets/domains used by FRIDA.

Oracle counterpart of the circle geometry inside stwo-prover (SURVEY.md
Appendix A.3, golden-verified). Reference use-sites:
the upstream's src/commit.rs:14 (Coset::half_odds), src/proof.rs:44-46.

The unit circle x^2 + y^2 = 1 over M31 is a cyclic group of order 2^31 with
generator G = (2, 1268011823). Group law:
  (x1,y1) * (x2,y2) = (x1 x2 - y1 y2, x1 y2 + y1 x2);  identity (1, 0);
  inverse / conjugate of (x, y) is (x, -y).
"""

from __future__ import annotations

from .field import P, m31_add, m31_mul, m31_neg, m31_sub

# Generator of the full 2^31-order circle group (verified: SURVEY.md A.3).
GENERATOR = (2, 1268011823)
LOG_ORDER = 31


def point_mul(p, q):
    return (
        m31_sub(m31_mul(p[0], q[0]), m31_mul(p[1], q[1])),
        m31_add(m31_mul(p[0], q[1]), m31_mul(p[1], q[0])),
    )


def point_conj(p):
    return (p[0], m31_neg(p[1]))


def point_pow(p, e: int):
    acc = (1, 0)
    base = p
    while e:
        if e & 1:
            acc = point_mul(acc, base)
        base = point_mul(base, base)
        e >>= 1
    return acc


def subgroup_gen(log_size: int):
    """Generator of the order-2^log_size subgroup: G^(2^(31-log_size))."""
    return point_pow(GENERATOR, 1 << (LOG_ORDER - log_size))


def half_odds_coset(log_size: int):
    """`Coset::half_odds(log_size)` — initial = G^(2^(29-log_size)),
    step = G^(2^(31-log_size)); points p_k = initial * step^k, k in
    [0, 2^log_size). (SURVEY.md A.3, golden-verified.)"""
    initial = point_pow(GENERATOR, 1 << (LOG_ORDER - 2 - log_size))
    step = subgroup_gen(log_size)
    pts = []
    p = initial
    for _ in range(1 << log_size):
        pts.append(p)
        p = point_mul(p, step)
    return pts


def circle_domain(log_half_size: int):
    """CircleDomain::new(half_odds(log_half_size)) in *natural* enumeration
    order: [p_0 .. p_{n-1}, conj(p_0) .. conj(p_{n-1})]."""
    half = half_odds_coset(log_half_size)
    return half + [point_conj(p) for p in half]


def bit_reverse_index(i: int, log_n: int) -> int:
    r = 0
    for _ in range(log_n):
        r = (r << 1) | (i & 1)
        i >>= 1
    return r


def pi(x: int) -> int:
    """The circle doubling map projected to x: pi(x) = 2x^2 - 1."""
    return m31_sub(m31_mul(2, m31_mul(x, x)), 1)
