"""Port's Merkle root (plain full build, and the GPU level/collapse split
run through the plain versions on CPU) vs the JAX package and the numpy
spec compression. Tolerance: exact equality."""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from frieda_tpu.core import merkle as jm  # noqa: E402
from frieda_tpu.spec import blake2s as sb  # noqa: E402
from frieda_tpu_torch.core import merkle as tm  # noqa: E402
from frieda_tpu_torch.ops import merkle as merkle_ops  # noqa: E402
from frieda_tpu_torch.utils.convert import from_numpy_u32, to_numpy_u32, widen  # noqa: E402

P = (1 << 31) - 1


def _cols(log_w: int) -> np.ndarray:
    return np.random.default_rng(log_w).integers(0, P, (4, 1 << log_w), dtype=np.uint32)


def _numpy_levels(cols: np.ndarray) -> list:
    """Every level, natural halves pairing, with the numpy spec compression."""
    msg = np.zeros((16, cols.shape[1]), np.uint32)
    msg[:4] = cols
    level = sb.compress_batch(msg)
    out = [level]
    while level.shape[1] > 1:
        half = level.shape[1] // 2
        level = sb.compress_batch(np.ascontiguousarray(
            np.concatenate([level[:, :half], level[:, half:]], axis=0)))
        out.append(level)
    return out


@pytest.mark.parametrize("log_w", range(1, 16))
def test_root_level_matches_numpy_levels(log_w):
    cols = _cols(log_w)
    expect = _numpy_levels(cols)
    t = from_numpy_u32(cols, "cpu")
    plain = tm.levels(widen(t))
    assert len(plain) == len(expect)
    for got, want in zip(plain, expect):
        assert np.array_equal(to_numpy_u32(got), want)
    assert np.array_equal(to_numpy_u32(tm.root_level(t)), expect[-1])


@pytest.mark.parametrize("log_w", range(1, 16))
def test_root_level_matches_jax_device_levels(log_w):
    cols = _cols(log_w)
    jax_levels = jax.jit(lambda c: jm.device_levels(c, cutoff_log=0))(jnp.asarray(cols))
    t = from_numpy_u32(cols, "cpu")
    assert np.array_equal(to_numpy_u32(tm.root_level(t)), np.asarray(jax_levels[-1]))
    for got, want in zip(tm.levels(widen(t)), jax_levels):
        assert np.array_equal(to_numpy_u32(got), np.asarray(want))


@pytest.mark.parametrize("leaf,fused", [(True, False), (True, True), (False, False), (False, True)])
def test_merkle_level_modes_match_full_build(leaf, fused):
    """Each kernel mode's plain version is the matching level of the full
    build: leaf -> level 0, fused leaf -> level 3, inner -> +1, fused -> +3."""
    cols = _cols(10)
    full = _numpy_levels(cols)
    x = from_numpy_u32(cols if leaf else full[2], "cpu")
    want = full[(0 if leaf else 2) + (3 if fused else (0 if leaf else 1))]
    assert np.array_equal(to_numpy_u32(merkle_ops.merkle_level(x, leaf, fused)), want)


def test_level_collapse_split_emulated(monkeypatch):
    """The GPU split with a tiny collapse bound: fused inner passes run down
    to the bound (the 1-level form where the width is not divisible by 8),
    then the collapse. Every step goes through a wrapper's plain version."""
    monkeypatch.setattr(merkle_ops, "COLLAPSE_MAX", 2)
    calls = []
    real_level = merkle_ops.merkle_level

    def spy(x, leaf, fused):
        calls.append((x.shape[1], leaf, fused))
        return real_level(x, leaf, fused)

    monkeypatch.setattr(merkle_ops, "merkle_level", spy)
    cols = _cols(14)
    got = tm.root_level(from_numpy_u32(cols, "cpu"))
    assert calls == [(1 << 14, True, True), (1 << 11, False, True),
                     (1 << 8, False, True), (1 << 5, False, True), (4, False, False)]
    assert np.array_equal(to_numpy_u32(got), _numpy_levels(cols)[-1])


@pytest.mark.parametrize("log_m", [0, 1, 3, 12])
def test_collapse_matches_full_build(log_m):
    level = np.random.default_rng(log_m).integers(0, 1 << 32, (8, 1 << log_m), dtype=np.uint64)
    level = level.astype(np.uint32)
    want = jm.host_levels_from(level)[-1] if log_m else level
    got = merkle_ops.merkle_collapse(from_numpy_u32(level, "cpu"))[0]
    assert np.array_equal(to_numpy_u32(got), want)


def test_root_bytes_little_endian():
    top = from_numpy_u32(np.array([[0x04030201], [0], [0], [0], [0], [0], [0], [0xFFFFFFFF]],
                                  np.uint32), "cpu")
    assert tm.root_bytes(top) == bytes([1, 2, 3, 4] + [0] * 24 + [0xFF] * 4)
