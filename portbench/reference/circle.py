"""The canonic circle domain over M31, in stored (bit-reversed) order, and the
circle FFT that evaluates a blob's polynomial on it.

The domain of log size n is the half coset half_odds(n - 1) and its
conjugates. Stored order pairs each point with its conjugate: entry 2k is
q_k = half[bitrev_{n-1}(k)] and entry 2k + 1 its conjugate. The line layers
of the FFT and of the FRI folds are x-coordinates in the same order:
xs_layers[0][j] = x(q_j), xs_layers[d + 1][j] = pi(xs_layers[d][2j]) with
pi(x) = 2x^2 - 1, and xs_layers[d][2j + 1] = -xs_layers[d][2j].
"""

from __future__ import annotations

import torch

from .field import P, add, inv, mul, sub

GENERATOR = (2, 1268011823)
LOG_ORDER = 31


def _point_pow(px: int, py: int, e: int) -> tuple:
    ax, ay = 1, 0
    while e:
        if e & 1:
            ax, ay = (ax * px - ay * py) % P, (ax * py + ay * px) % P
        px, py = (px * px - py * py) % P, (2 * px * py) % P
        e >>= 1
    return ax, ay


def bitrev(idx: torch.Tensor, bits: int) -> torch.Tensor:
    out = torch.zeros_like(idx)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


class Domain:
    """Tables of the canonic domain of log size n >= 1 on `device`: `ys`
    (2^(n-1),) the y of q_k, `xs_layers` the line layers (sizes 2^(n-1) down
    to 2), and their inverses on demand."""

    def __init__(self, n: int, device):
        self.n = n
        m = n - 1
        ix, iy = _point_pow(*GENERATOR, 1 << (LOG_ORDER - 2 - m))
        sx, sy = _point_pow(*GENERATOR, 1 << (LOG_ORDER - m))
        xs = torch.tensor([ix], dtype=torch.int64, device=device)
        ys = torch.tensor([iy], dtype=torch.int64, device=device)
        for _ in range(m):  # p_k = initial * step^k, k < 2^m: double the list each time
            nx, ny = sub(mul(xs, sx), mul(ys, sy)), add(mul(xs, sy), mul(ys, sx))
            xs, ys = torch.cat([xs, nx]), torch.cat([ys, ny])
            sx, sy = (sx * sx - sy * sy) % P, (2 * sx * sy) % P
        order = bitrev(torch.arange(1 << m, device=device), m)
        self.ys = ys[order]
        self.xs_layers = []
        x = xs[order]
        while x.numel() >= 2:
            self.xs_layers.append(x)
            x = sub(mul(2, mul(x[0::2], x[0::2])), 1)
        self._inv = {}

    def ys_inv(self) -> torch.Tensor:
        if "ys" not in self._inv:
            self._inv["ys"] = inv(self.ys)
        return self._inv["ys"]

    def xs_inv(self, d: int) -> torch.Tensor:
        """1 / xs_layers[d][2j], one a pair (2j, 2j + 1) of line layer d."""
        if d not in self._inv:
            self._inv[d] = inv(self.xs_layers[d][0::2])
        return self._inv[d]


def evaluate(coeffs: torch.Tensor, dom: Domain) -> torch.Tensor:
    """(..., 2^l) natural-order coefficients, l <= n, zero-extended to the
    domain -> (..., 2^n) evaluations in stored order. The recursion splits
    the coefficients by index parity, the circle (y) split first, then the
    line (x) splits; it runs bottom-up, level k holding the 2^k sub-problems
    c[r :: 2^k] (rows r) of length 2^(n - k) each."""
    n = dom.n
    lead, l_len = coeffs.shape[:-1], coeffs.shape[-1]
    y = torch.zeros(*lead, 1 << n, dtype=torch.int64, device=coeffs.device)
    y[..., :l_len] = coeffs
    y = y.reshape(*lead, 1 << n, 1)
    for k in range(n - 1, -1, -1):
        g0, g1 = y[..., : 1 << k, :], y[..., 1 << k :, :]
        tw = dom.ys if k == 0 else dom.xs_layers[k - 1][0::2]
        t = mul(g1, tw)
        y = torch.stack([add(g0, t), sub(g0, t)], dim=-1).reshape(*lead, 1 << k, -1)
    return y.reshape(*lead, 1 << n)
