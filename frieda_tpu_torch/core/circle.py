"""Host-side circle-domain twiddle precompute (vectorized numpy).

Jax-free copy of `frieda_tpu/core/circle.py`: the circle geometry is index
math on the host and only the resulting tables go to the device. The
verifier's lookups (`line_x_batch`, `line_x_inv_batch`,
`ys_inv_at_stored_pairs`) read the same cached tables on the host.

Layout: NATURAL domain order (half coset, then conjugates). `Twiddles(n)`
covers the canonic CircleDomain of size 2^n:

  ys[t]            y(p_t), half-coset points in natural order    (2^(n-1),)
  xs_layers[l]     x-line layer l, natural, first-half entries only; the
                   dropped second half satisfies L[t+half] == -L[t]
  ys_inv, xs_layers_inv   matching inverses (FRI folds), computed on first
                   use so that a commit never pays for them

FFT stage twiddle at depth d: ys if d == 0 else xs_layers[d-1].
"""

from __future__ import annotations

import functools

import numpy as np

P = (1 << 31) - 1
GENERATOR = (2, 1268011823)
LOG_ORDER = 31
_INV_BLOCK = 64  # elements per row of the blocked batch inverse


def batch_inv(a: np.ndarray) -> np.ndarray:
    """Elementwise inverse mod P of a uint64 array of canonical values (zero
    maps to zero), equal to a^(P-2). Montgomery's batch inversion, run as
    _INV_BLOCK running products vectorized over the rows of a
    (_INV_BLOCK, n / _INV_BLOCK) view: ~3 multiplies per element plus one
    exponentiation per row, where a^(P-2) for every element costs ~60
    multiplies per element (the fold tables at n = 26 hold 2^26 values)."""
    a = np.asarray(a, np.uint64)
    flat = np.where(a == 0, np.uint64(1), a).reshape(-1)
    n = flat.size
    k = _INV_BLOCK if n % _INV_BLOCK == 0 else 1
    x = flat.reshape(k, n // k)
    prefix = np.empty_like(x)
    prefix[0] = x[0]
    for i in range(1, k):
        prefix[i] = prefix[i - 1] * x[i] % P
    run = prefix[k - 1]  # running inverse: 1 / (x[0] * ... * x[i]) per row
    e = P - 2
    acc = np.ones_like(run)
    while e:
        if e & 1:
            acc = acc * run % P
        run = run * run % P
        e >>= 1
    run = acc
    out = np.empty_like(x)
    for i in range(k - 1, 0, -1):
        out[i] = run * prefix[i - 1] % P
        run = run * x[i] % P
    out[0] = run
    return np.where(a == 0, np.uint64(0), out.reshape(a.shape))


_REV8 = np.array([sum(((i >> b) & 1) << (7 - b) for b in range(8)) for i in range(256)], np.int64)


def bitrev_array(js: np.ndarray, bits: int) -> np.ndarray:
    """Vectorized bit reversal of int64 indices in [0, 2^bits) over `bits`
    (0..32) bits: four byte-table lookups (the verifier calls it once per
    FRI layer on a few queries, the prover on whole domains)."""
    if not 0 <= bits <= 32:
        raise ValueError(f"bits must be in 0..32, got {bits}")
    js = np.asarray(js, np.int64)
    r32 = ((_REV8[js & 0xFF] << 24) | (_REV8[(js >> 8) & 0xFF] << 16)
           | (_REV8[(js >> 16) & 0xFF] << 8) | _REV8[(js >> 24) & 0xFF])
    return r32 >> (32 - bits)


def _pmul(x1, y1, x2, y2):
    """Vectorized circle group law over uint64 numpy arrays (mod P)."""
    return (
        (x1 * x2 + (P - y1) * y2 % P) % P,
        (x1 * y2 + y1 * x2) % P,
    )


def _point_pow(px: int, py: int, e: int):
    ax, ay = 1, 0
    while e:
        if e & 1:
            ax, ay = (ax * px - ay * py) % P, (ax * py + ay * px) % P
        px, py = (px * px - py * py) % P, (2 * px * py) % P
        e >>= 1
    return ax % P, ay % P


@functools.lru_cache(maxsize=32)
def bitrev_permutation(log_n: int) -> np.ndarray:
    rev = bitrev_array(np.arange(1 << log_n, dtype=np.int64), log_n)
    rev.setflags(write=False)  # cached: guard against accidental mutation
    return rev


def half_odds_points(log_size: int):
    """All points of Coset::half_odds(log_size) in natural order, as two
    uint64 arrays (xs, ys). p_k = G^(2^(29-m)) * (G^(2^(31-m)))^k."""
    m = log_size
    ix, iy = _point_pow(*GENERATOR, 1 << (LOG_ORDER - 2 - m))
    sx, sy = _point_pow(*GENERATOR, 1 << (LOG_ORDER - m))
    xs = np.array([ix], np.uint64)
    ys = np.array([iy], np.uint64)
    px, py = sx, sy
    for _ in range(m):
        nx, ny = _pmul(xs, ys, np.uint64(px), np.uint64(py))
        xs = np.concatenate([xs, nx])
        ys = np.concatenate([ys, ny])
        px, py = _point_pow(px, py, 2)
    return xs, ys


class Twiddles:
    def __init__(self, log_size: int):
        assert log_size >= 1
        self.log_size = log_size
        xs, ys = half_odds_points(log_size - 1)
        self.ys = ys.astype(np.uint32)
        self.xs_layers: list[np.ndarray] = []
        cur = xs
        while len(cur) >= 2:
            half = len(cur) >> 1
            lo, hi = cur[:half], cur[half:]
            assert np.all((lo + hi) % P == 0), "±x natural pair adjacency broken"
            self.xs_layers.append(lo.astype(np.uint32))
            cur = (2 * lo % P * lo + (P - 1)) % P  # pi(x) = 2x^2 - 1
        # log_size == 1: domain {p, conj p} — no line layers, ys has 1 entry.

    @functools.cached_property
    def ys_inv(self) -> np.ndarray:
        return batch_inv(self.ys).astype(np.uint32)

    @functools.cached_property
    def xs_layers_inv(self) -> list[np.ndarray]:
        return [batch_inv(x).astype(np.uint32) for x in self.xs_layers]

    def eval_stage_twiddle(self, depth: int) -> np.ndarray:
        """Twiddle table for FFT combine depth `depth` (0 = y-stage), natural
        order, size 2^(log_size-1-depth)."""
        return self.ys if depth == 0 else self.xs_layers[depth - 1]


@functools.lru_cache(maxsize=4)
def get_twiddles(log_size: int) -> Twiddles:
    return Twiddles(log_size)


# --- the verifier's per-query lookups (host) ---------------------------------

def bit_reverse_index(i: int, log_n: int) -> int:
    r = 0
    for _ in range(log_n):
        r = (r << 1) | (i & 1)
        i >>= 1
    return r


def natural_point(log_size: int, natural: int):
    """Circle point of the canonic domain of log size n at *natural* index."""
    m = log_size - 1
    conj = natural >= (1 << m)
    t = natural & ((1 << m) - 1)
    ix, iy = _point_pow(*GENERATOR, 1 << (LOG_ORDER - 2 - m))
    sx, sy = _point_pow(*GENERATOR, 1 << (LOG_ORDER - m))
    px, py = _point_pow(sx, sy, t)
    x = (ix * px - iy * py) % P
    y = (ix * py + iy * px) % P
    if conj:
        y = (P - y) % P
    return x, y


def domain_point_at_stored_index(log_size: int, stored: int):
    """Circle point at *stored* (bit-reversed) index: stored s <-> natural
    bitrev_n(s) (SURVEY.md A.5)."""
    return natural_point(log_size, bit_reverse_index(stored, log_size))


def _line_lookup(log_size: int, layer: int, js, table: np.ndarray) -> np.ndarray:
    """Signed lookup shared by line_x_batch / line_x_inv_batch, as uint64.

    X_layer[j] = pi^layer(x(natural u)) with u = bitrev_{n-1-layer}(j), and
    pi^layer(xs[u]) = ±xs_layers[layer][u mod half] (the Twiddles
    construction; second halves negate by the ±x pair adjacency asserted
    there). The same index and sign select from the inverse table, so the
    verifier runs no field inversion. The uint32 table is read in place and
    only the entries gathered are widened (the JAX package caches uint64
    copies of whole layers: 128 MiB each for the first layer of a 2^26
    domain)."""
    u = bitrev_array(np.asarray(js, np.int64), log_size - 1 - layer)
    half = table.shape[0]  # == 2^(log_size - 2 - layer)
    hi = u >= half
    val = table[np.where(hi, u - half, u)].astype(np.uint64)
    return np.where(hi, (P - val) % P, val)


def line_x_batch(log_size: int, layer: int, js) -> np.ndarray:
    """X_layer[js] for an array of STORED line-domain indices: X_0[j] = x(stored
    domain point 2j), X_l[j] = pi^l(X_0[j << l]). Lookups in the cached
    twiddle tables, which the prover of the same size already built."""
    return _line_lookup(log_size, layer, js, get_twiddles(log_size).xs_layers[layer])


def line_x_inv_batch(log_size: int, layer: int, js) -> np.ndarray:
    """1 / X_layer[js], from the cached inverse tables (no Fermat pow)."""
    return _line_lookup(log_size, layer, js, get_twiddles(log_size).xs_layers_inv[layer])


def ys_inv_at_stored_pairs(log_size: int, ks) -> np.ndarray:
    """1/y(stored domain point 2k) for an array of pair indices k, as uint64:
    the natural index of stored 2k is bitrev_{n-1}(k), always in the half
    coset (no conjugate sign)."""
    u = bitrev_array(np.asarray(ks, np.int64), log_size - 1)
    return get_twiddles(log_size).ys_inv[u].astype(np.uint64)
