"""Port's circle FFT vs the JAX package: the plain `evaluate` and the
stage-group plan `evaluate_auto` runs (each group through its plain version
on CPU), against JAX `fft.evaluate` and the fused Pallas passes in interpret
mode, and the CUDA kernel's index mapping mirrored in Python. Tolerance:
exact equality."""

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from frieda_tpu.core import fft as jfft  # noqa: E402
from frieda_tpu.ops import fft_pallas  # noqa: E402
from frieda_tpu.spec import commit as sc  # noqa: E402
from frieda_tpu_torch.core import fft as tfft  # noqa: E402
from frieda_tpu_torch.ops import fft as fft_ops  # noqa: E402
from frieda_tpu_torch.utils.convert import from_numpy_u32, to_numpy_u32, widen  # noqa: E402

torch.set_num_threads(1)

P = (1 << 31) - 1


def _coeffs_rev(C, log_l, seed):
    c = np.random.default_rng(seed).integers(0, P, (C, 1 << log_l), dtype=np.uint32)
    return jfft.bitrev_coeffs(c)


@pytest.mark.parametrize("n", [1, 2, 5, 11])
def test_stage_twiddles_match_jax(n):
    got = to_numpy_u32(tfft.stage_twiddles(n, "cpu"))
    by_depth = [np.asarray(t) for t in jfft.stage_twiddles(n)]
    assert np.array_equal(got, np.concatenate(by_depth[::-1]))


# the shapes of tests/test_fft_pallas.py, plus tiny and constant polynomials
@pytest.mark.parametrize("n,log_l", [(16, 14), (16, 12), (17, 13), (16, 16), (14, 9),
                                     (1, 0), (3, 0), (3, 1), (6, 2), (10, 10)])
def test_evaluate_matches_jax(n, log_l):
    c_rev = _coeffs_rev(2, log_l, n * 100 + log_l)
    expect = np.asarray(jfft.evaluate_jit(jnp.asarray(c_rev), n))
    tw = tfft.stage_twiddles(n, "cpu")
    c = from_numpy_u32(c_rev, "cpu")
    assert np.array_equal(to_numpy_u32(tfft.evaluate(widen(c), tw)), expect)
    assert np.array_equal(to_numpy_u32(tfft.evaluate_auto(c, tw)), expect)


@pytest.mark.parametrize("n,log_l", [(16, 12), (16, 16)])
def test_evaluate_matches_fused_pallas(n, log_l):
    """(16, 12) takes the dilation-fused low pass, (16, 16) the undilated
    one; tests/test_fft_pallas.py covers its other shapes against
    `fft.evaluate`, which test_evaluate_matches_jax covers here."""
    c_rev = _coeffs_rev(2, log_l, n * 100 + log_l)
    expect = np.asarray(fft_pallas.evaluate_fused(jnp.asarray(c_rev), n, interpret=True))
    got = tfft.evaluate_auto(from_numpy_u32(c_rev, "cpu"), tfft.stage_twiddles(n, "cpu"))
    assert np.array_equal(to_numpy_u32(got), expect)


def test_evaluate_matches_spec_oracle():
    """One coordinate against the recursive spec FFT (bit-reversed storage
    order out: stored s <-> natural bitrev(s))."""
    n, log_l = 8, 5
    coeffs = np.random.default_rng(1).integers(0, P, (1, 1 << log_l), dtype=np.uint32)
    got = to_numpy_u32(tfft.evaluate(
        widen(from_numpy_u32(jfft.bitrev_coeffs(coeffs), "cpu")), tfft.stage_twiddles(n, "cpu")))
    spec = sc.evaluate_circle_poly(coeffs[0].astype(np.uint64), sc.CircleTwiddles(n))
    rev = np.array([int(format(s, f"0{n}b")[::-1], 2) for s in range(1 << n)])
    assert np.array_equal(got[0][rev], spec.astype(np.uint32))


@pytest.mark.parametrize("n,log_l", [(16, 12), (14, 14), (13, 2), (9, 0), (16, 5)])
def test_pass_plan_groups_emulated(monkeypatch, n, log_l):
    """Shrink the tile so small domains take several groups, run the plan
    group by group through the plain `fft_pass_plain` exactly as the kernel
    launches run (the first group reads the undilated coefficients), and
    compare with the one-shot stage loop."""
    monkeypatch.setattr(fft_ops, "TILE_LOG", 6)
    monkeypatch.setattr(fft_ops, "FIRST_TILE_LOG", 5)
    monkeypatch.setattr(fft_ops, "COL_LOG", 3)
    fft_ops.pass_plan.cache_clear()
    try:
        p_min, groups = fft_ops.pass_plan(n, log_l)
        assert p_min == n - log_l
        bits = [p for lo, hi, _ in groups for p in range(lo, hi)]
        assert bits == list(range(p_min, n))
        for p_lo, p_hi, k in groups:
            assert 0 <= k <= p_lo and (p_hi - p_lo) + k <= fft_ops.TILE_LOG
        sizes = [hi - lo for lo, hi, _ in groups]
        assert max(sizes) - min(sizes) <= 1
        if log_l > fft_ops.TILE_LOG:
            assert len(groups) >= 2
        tw = tfft.stage_twiddles(n, "cpu")
        c = widen(from_numpy_u32(_coeffs_rev(2, log_l, n + log_l), "cpu"))
        x, shift = c, p_min
        for p_lo, p_hi, _ in groups:
            x = fft_ops.fft_pass_plain(x, tw, n, p_lo, p_hi, shift)
            shift = 0
        assert np.array_equal(to_numpy_u32(x), to_numpy_u32(tfft.evaluate(c, tw)))
    finally:
        fft_ops.pass_plan.cache_clear()


@pytest.mark.parametrize("n,log_l,expect", [
    (22, 18, ((4, 13, 4), (13, 22, 4))),                # 2^20-felt prove
    (24, 20, ((4, 14, 4), (14, 24, 4))),                # 2^22-felt commit
    (26, 22, ((4, 15, 3), (15, 26, 4))),                # 2^24-felt commit and prove
    (28, 24, ((4, 12, 4), (12, 20, 4), (20, 28, 4))),   # 2^26-felt prove
    (5, 0, ((5, 5, 5),)),                               # constant: one zero-stage copy
])
def test_pass_plan_at_main_path_shapes(n, log_l, expect):
    """The plan the card runs: two launches up to n = 26, every stage bit
    exactly once, each group within the tile (the first within
    FIRST_TILE_LOG), whole 32-byte sectors a row (k >= 3)."""
    p_min, groups = fft_ops.pass_plan(n, log_l)
    assert (p_min, groups) == (n - log_l, expect)
    assert [p for lo, hi, _ in groups for p in range(lo, hi)] == list(range(p_min, n))
    for q, (p_lo, p_hi, k) in enumerate(groups):
        assert k <= p_lo and (p_hi - p_lo) + k <= fft_ops.TILE_LOG
        assert k >= 3
        if q == 0 and log_l:
            assert (p_hi - p_lo) + k <= fft_ops.FIRST_TILE_LOG
    if log_l and n <= 26:
        assert len(groups) == 2


def _kernel_rounds(g):
    """csrc/fft.cu `Rounds`: ceil(g / 4) rounds of near-equal size, the
    larger first; a zero-stage group is one round of 0 bits."""
    count = 1 if g == 0 else -(-g // 4)
    return [g // count + (q < g % count) for q in range(count)]


def _block_base(t, p_lo, g, k):
    """csrc/fft.cu fft_pass_kernel: j bits fixed by tile number t."""
    mid_bits = p_lo - k
    return ((t >> mid_bits) << (p_lo + g)) | ((t & ((1 << mid_bits) - 1)) << k)


# (n, p_lo, g, k, tiles checked; None = all): the small plans' groups, and
# the 2^24-felt LDE's two groups (n = 26) on a few of their tiles
@pytest.mark.parametrize("n,p_lo,g,k,tiles", [
    (15, 4, 11, 3, None), (14, 4, 10, 4, None), (13, 4, 9, 4, None), (20, 12, 8, 4, None),
    (16, 0, 8, 0, None), (9, 9, 0, 9, None), (3, 2, 1, 2, None),
    (26, 4, 11, 3, (0, 1, 2047, 4095)), (26, 15, 11, 4, (0, 1, 1023, 2047)),
])
def test_kernel_rounds_touch_every_element_once(n, p_lo, g, k, tiles):
    """Mirror of csrc/fft.cu's thread -> element and round -> stage mapping:
    in every round the blocks' jobs hold each (column, j) of the group
    exactly once, every thread gets the same number of jobs, the padded
    shared-memory slots are distinct and in bounds and step by a constant
    per element, and the twiddle offsets equal T_p[j mod 2^p]."""
    radices = _kernel_rounds(g)
    assert sum(radices) == g and max(radices) <= 4 and max(radices) - min(radices) <= 1
    r0 = radices[0]
    threads = 1 << min(10 if g + k > 14 else 9, g + k - r0)
    n_tiles = 1 << (n - g - k)
    bases = np.array([_block_base(t, p_lo, g, k) for t in range(n_tiles)], np.int64)
    tile_bits = ((1 << g) - 1) << p_lo | ((1 << k) - 1)
    assert np.all(bases & tile_bits == 0) and len(np.unique(bases)) == n_tiles
    tiles = range(n_tiles) if tiles is None else tiles
    rows, cols = np.meshgrid(np.arange(1 << g), np.arange(1 << k), indexing="ij")
    want_rel = np.sort((rows << p_lo | cols).ravel())
    s0 = 0
    for r in radices:
        a, sh = s0 + k, p_lo + s0
        jobs = 1 << (g + k - r)
        assert jobs % threads == 0
        m = np.arange(jobs, dtype=np.int64)[:, None]
        e = np.arange(1 << r, dtype=np.int64)[None, :]
        ib = (m & ((1 << a) - 1)) | ((m >> a) << (a + r))
        i = ib + (e << a)
        assert np.array_equal(np.sort(i.ravel()), np.arange(1 << (g + k)))
        slot = i + ((i >> (k + r0)) << k)
        step = (1 << a) + ((1 << (a - r0)) if a >= k + r0 else 0)
        assert np.array_equal(slot, slot[:, :1] + e * step)
        assert len(np.unique(slot)) == slot.size and slot.max() < (1 << (g + k)) + ((1 << (g + k)) >> r0)
        for t in tiles:
            jb = int(bases[t]) | ((ib >> k) << p_lo) | (ib & ((1 << k) - 1))
            j = jb + (e << sh)
            assert np.array_equal(np.sort(j.ravel()) - bases[t], want_rel)
            for b in range(r):
                p = sh + b
                tw_idx = ((1 << p) - 1) + (jb & ((1 << sh) - 1)) + ((e & ((1 << b) - 1)) << sh)
                assert np.array_equal(tw_idx, ((1 << p) - 1) + (j & ((1 << p) - 1)))
        s0 += r
    assert s0 == g


# (p_lo, p_hi, col_log, src_shift) that the kernel cannot run, at n = 8
@pytest.mark.parametrize("p_lo,p_hi,col_log,src_shift", [
    (4, 3, 3, 0),    # p_hi < p_lo
    (2, 4, 3, 0),    # col_log > p_lo
    (4, 8, 12, 0),   # beyond the tile
    (2, 8, 2, 3),    # dilation bits above p_lo
])
def test_fft_pass_rejects_bad_groups(p_lo, p_hi, col_log, src_shift):
    n = 8
    src = torch.zeros((2, 1 << (n - src_shift)), dtype=torch.int32)
    out = torch.zeros((2, 1 << n), dtype=torch.int32)
    with pytest.raises(ValueError, match="bad stage group"):
        fft_ops.fft_pass(src, tfft.stage_twiddles(n, "cpu"), out, p_lo, p_hi, col_log, src_shift)
