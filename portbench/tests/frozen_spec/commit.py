"""Reference-spec (oracle) implementation of the FRIDA commit path.

Pure numpy / Python-int re-derivation of
the upstream's src/commit.rs + src/utils.rs, per the golden-verified spec in
SURVEY.md Appendix A. This module is the conformance oracle for the JAX/Pallas
production path: slow-ish but transparent. It reproduces the golden root
  d1a2d506 9dc587e5 5dc29cc6 255af937 ff7fed0e e41bdf5a f98717f9 d74f60e8
for commit(blob, 4) (the upstream's src/commit.rs:28-38).
"""

from __future__ import annotations

import numpy as np

from .blake2s import compress_batch
from .circle import bit_reverse_index, half_odds_coset, pi
from .field import P

# ---------------------------------------------------------------------------
# Byte -> felt packing (src/utils.rs:10-19, SURVEY.md A.1)
# ---------------------------------------------------------------------------


def bytes_to_felts(data: bytes) -> np.ndarray:
    """LSB-first bit stream, 30-bit little-endian chunks -> canonical M31 felts.

    Equivalent to: big = int.from_bytes(data, 'little');
    felt[j] = (big >> (30 j)) & (2^30 - 1), for j < ceil(8 len / 30).
    """
    if len(data) == 0:
        return np.zeros(0, np.uint32)
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    n_felts = -(-len(bits) // 30)
    padded = np.zeros(n_felts * 30, np.uint8)
    padded[: len(bits)] = bits
    weights = (np.uint64(1) << np.arange(30, dtype=np.uint64))
    return (padded.reshape(n_felts, 30).astype(np.uint64) @ weights).astype(np.uint32)


def ceil_log2(n: int) -> int:
    """ceil(log2(n)) for n >= 1. The reference computes this via f64 log2
    (src/utils.rs:23) which is exact for all reachable sizes (< 2^49)."""
    return max(n - 1, 0).bit_length()


def polynomial_from_bytes(data: bytes) -> np.ndarray:
    """Pad felts to 2^max(ceil_log2(n), 2), split into 4 contiguous chunks =
    the 4 base-field coordinate polynomials of one SecureCirclePoly
    (src/utils.rs:21-33). Returns shape (4, 2^log_size) uint32, coefficients
    in natural order; log_size = per-coordinate log length."""
    felts = bytes_to_felts(data)
    log_total = max(ceil_log2(max(len(felts), 1)), 2)
    total = 1 << log_total
    padded = np.zeros(total, np.uint32)
    padded[: len(felts)] = felts
    return padded.reshape(4, total // 4)


# ---------------------------------------------------------------------------
# Twiddle tables (host precompute; SURVEY.md A.3-A.5)
# ---------------------------------------------------------------------------


class CircleTwiddles:
    """Twiddles for evaluating on the canonic CircleDomain of log size n
    (half coset = half_odds(n-1)), in bit-reversed storage order.

    q_k = half_coset[bitrev_{n-1}(k)]. Attributes:
      ys        : (2^(n-1),) uint64 — y(q_k)
      xs_layers : list over line layers d = 0.. of uint64 arrays,
                  xs_layers[d][j] = pi^d-image x-domain in bitrev order,
                  sizes 2^(n-1), 2^(n-2), ..., 2 — layer d pairs satisfy
                  xs[2k+1] == -xs[2k] (asserted).
    """

    def __init__(self, log_size: int):
        assert log_size >= 1
        self.log_size = log_size
        m = log_size - 1
        half = half_odds_coset(m)
        order = [bit_reverse_index(k, m) for k in range(1 << m)]
        q = [half[i] for i in order]
        self.ys = np.array([p[1] for p in q], np.uint64)
        xs = np.array([p[0] for p in q], np.uint64)
        self.xs_layers = []
        while len(xs) >= 2:
            assert np.all((xs[0::2] + xs[1::2]) % P == 0), "x-pair adjacency"
            self.xs_layers.append(xs)
            nxt = (2 * xs[0::2] % P) * xs[0::2] % P  # 2x^2
            xs = (nxt + P - 1) % P  # pi(x) = 2x^2 - 1
        # NB: for log_size == 1 there are no line layers (single coefficient).


# ---------------------------------------------------------------------------
# Circle FFT evaluation (recursive even/odd split; SURVEY.md A.4-A.5)
# ---------------------------------------------------------------------------


def _eval_line(c: np.ndarray, xs_layers, d: int) -> np.ndarray:
    if len(c) == 1:
        return c.copy()
    g0 = _eval_line(c[0::2], xs_layers, d + 1)
    g1 = _eval_line(c[1::2], xs_layers, d + 1)
    x = xs_layers[d]
    out = np.empty_like(c)
    t = x[0::2] * g1 % P
    out[0::2] = (g0 + t) % P
    out[1::2] = (g0 + P - t) % P  # x[2k+1] = -x[2k]
    return out


def evaluate_circle_poly(coeffs: np.ndarray, tw: CircleTwiddles) -> np.ndarray:
    """Evaluate one coordinate polynomial (natural-order coefficients,
    zero-extended to the domain size 2^tw.log_size) over the canonic domain.
    Output in bit-reversed storage order: out[2k] = f(q_k), out[2k+1] =
    f(conj(q_k)) (SURVEY.md A.5)."""
    n = 1 << tw.log_size
    assert len(coeffs) <= n
    c = np.zeros(n, np.uint64)
    c[: len(coeffs)] = coeffs
    if n == 1:
        return c
    f0 = _eval_line(c[0::2], tw.xs_layers, 0)
    f1 = _eval_line(c[1::2], tw.xs_layers, 0)
    out = np.empty(n, np.uint64)
    t = tw.ys * f1 % P
    out[0::2] = (f0 + t) % P
    out[1::2] = (f0 + P - t) % P
    return out


# ---------------------------------------------------------------------------
# Merkle commitment (SURVEY.md A.6)
# ---------------------------------------------------------------------------


def merkle_levels(columns: np.ndarray) -> list[np.ndarray]:
    """Full Merkle tree over 4 equal-length columns (shape (4, N) uint32,
    stored order). Returns the list of hash levels, leaves first; each level
    is (8, n_nodes) uint32. Leaf i = compress(0, [c0[i],c1[i],c2[i],c3[i],
    0 x 12]); inner = compress(0, left || right)."""
    assert columns.shape[0] == 4
    n = columns.shape[1]
    msg = np.zeros((16, n), np.uint32)
    msg[:4] = columns
    level = compress_batch(msg)
    levels = [level]
    while level.shape[1] > 1:
        msg = np.concatenate([level[:, 0::2], level[:, 1::2]], axis=0)
        level = compress_batch(msg)
        levels.append(level)
    return levels


def merkle_root_bytes(levels: list[np.ndarray]) -> bytes:
    root = levels[-1][:, 0]
    return b"".join(int(w).to_bytes(4, "little") for w in root)


def commit(data: bytes, log_blowup: int) -> bytes:
    """Oracle equivalent of frieda's api::commit (src/commit.rs:11-22)."""
    coeffs = polynomial_from_bytes(data)
    log_size = ceil_log2(coeffs.shape[1])
    n = log_size + log_blowup
    tw = CircleTwiddles(n)
    evals = np.stack(
        [evaluate_circle_poly(coeffs[i].astype(np.uint64), tw) for i in range(4)]
    ).astype(np.uint32)
    return merkle_root_bytes(merkle_levels(evals))
