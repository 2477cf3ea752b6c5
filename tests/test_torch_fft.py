"""Port's circle FFT vs the JAX package: the plain `evaluate` and the
stage-group plan `evaluate_auto` runs (each group through its plain version
on CPU), against JAX `fft.evaluate` and the fused Pallas passes in interpret
mode. Tolerance: exact equality."""

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from frieda_tpu.core import fft as jfft  # noqa: E402
from frieda_tpu.ops import fft_pallas  # noqa: E402
from frieda_tpu.spec import commit as sc  # noqa: E402
from frieda_tpu_torch.core import fft as tfft  # noqa: E402
from frieda_tpu_torch.ops import fft as fft_ops  # noqa: E402
from frieda_tpu_torch.utils.convert import from_numpy_u32, to_numpy_u32, widen  # noqa: E402

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
    monkeypatch.setattr(fft_ops, "COL_LOG", 3)
    fft_ops.pass_plan.cache_clear()
    try:
        p_min, groups = fft_ops.pass_plan(n, log_l)
        assert p_min == n - log_l
        bits = [p for lo, hi, _ in groups for p in range(lo, hi)]
        assert bits == list(range(p_min, n))
        for p_lo, p_hi, k in groups:
            assert 0 <= k <= p_lo and (p_hi - p_lo) + k <= fft_ops.TILE_LOG
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


def test_pass_plan_at_main_path_shapes():
    """The plan the card runs: three launches at n = 24 (2^22 felts, blowup
    4), and one zero-stage copy for a constant polynomial."""
    assert fft_ops.pass_plan(24, 20) == (4, ((4, 12, 4), (12, 18, 6), (18, 24, 6)))
    assert fft_ops.pass_plan(5, 0) == (5, ((5, 5, 5),))
