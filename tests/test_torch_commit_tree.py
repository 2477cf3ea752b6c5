"""Port's commit with its whole tree (`frieda_tpu_torch.api.commit_with_tree`,
`core/merkle.device_levels`, `CommitTree`, `build_tree`; device="cpu":
every kernel's plain version) vs the JAX package's. Tolerance: exact
equality of roots, evaluations, every tree level and every gathered node."""

import functools

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import synthetic_data  # noqa: E402
from frieda_tpu import api as japi  # noqa: E402
from frieda_tpu.core import merkle as jm  # noqa: E402
from frieda_tpu_torch import api as tapi  # noqa: E402
from frieda_tpu_torch.core import merkle as tm  # noqa: E402
from frieda_tpu_torch.utils.convert import from_numpy_u32, to_numpy_u32, widen  # noqa: E402

torch.set_num_threads(1)

P = (1 << 31) - 1

# (blob bytes, log_blowup): domains 2^12 (7 device levels, 6 host), 2^5
# (only the leaf level on the device) and 2^1 (two leaves)
CASES = [(3_840, 4), (100, 2), (0, 1)]


def _indices(rng, log_m: int) -> list:
    return [int(s) for s in rng.integers(0, 1 << log_m, 16)]


@pytest.mark.parametrize("n_bytes,log_blowup", CASES)
def test_commit_with_tree_matches_jax(n_bytes, log_blowup):
    data = synthetic_data(n_bytes, seed=n_bytes)
    root, evals, tree, n = tapi.commit_with_tree(data, log_blowup, device="cpu")
    j_root, j_evals, j_tree, j_n = japi.commit_with_tree(data, log_blowup)
    assert root == j_root == tapi.commit(data, log_blowup, device="cpu")
    assert n == j_n
    assert evals.shape == (4, 1 << n) and evals.device.type == "cpu"
    assert np.array_equal(to_numpy_u32(evals), np.asarray(j_evals))
    assert tree.n_device_levels == j_tree.n_device_levels
    assert len(tree.hlevels) == len(j_tree.hlevels)
    assert tree.root == root and tree.log_n_leaves == n
    for got, want in zip(tree.hlevels, j_tree.hlevels):
        assert np.array_equal(got, want)
    rng = np.random.default_rng(n_bytes)
    for level in range(n + 1):  # device levels, then host levels, to the root
        stored = _indices(rng, n - level)
        assert tree.gather_nodes(level, stored) == j_tree.gather_nodes(level, stored)
        assert tree.gather_nodes(level, np.array(stored)) == j_tree.gather_nodes(level, stored)
    assert tree.gather_nodes(0, []) == j_tree.gather_nodes(0, []) == []


@functools.lru_cache(maxsize=None)
def _cols(log_n: int) -> np.ndarray:
    return np.random.default_rng(log_n).integers(0, P, (4, 1 << log_n), dtype=np.uint32)


@pytest.mark.parametrize("cutoff_log", [0, 3, 6])
def test_device_levels_match_jax(cutoff_log):
    cols = _cols(10)
    want = jax.jit(lambda c: jm.device_levels(c, cutoff_log=cutoff_log))(jnp.asarray(cols))
    got = tm.device_levels(from_numpy_u32(cols, "cpu"), cutoff_log)
    assert len(got) == len(want) == 11 - cutoff_log
    for g, w in zip(got, want):
        assert g.dtype == from_numpy_u32(cols, "cpu").dtype
        assert np.array_equal(to_numpy_u32(g), np.asarray(w))
    # the plain version: the full build, cut at the same level
    plain = tm.levels(widen(from_numpy_u32(cols, "cpu")))[: len(got)]
    assert all(np.array_equal(to_numpy_u32(g), to_numpy_u32(p)) for g, p in zip(got, plain))


def test_device_levels_narrower_than_the_cutoff():
    cols = from_numpy_u32(_cols(3), "cpu")
    got = tm.device_levels(cols)  # 8 leaves <= 2^6: the leaf level alone
    assert len(got) == 1 and got[0].shape == (8, 8)


def test_build_tree_root_matches_jax():
    cols = _cols(10)
    tree = tm.build_tree(from_numpy_u32(cols, "cpu"))
    j_tree = jm.build_tree(jnp.asarray(cols))
    assert tree.root == j_tree.root
    assert tree.n_device_levels == j_tree.n_device_levels == 5
    assert len(tree.hlevels) == len(j_tree.hlevels) == 6
    assert tree.root == tm.root_bytes(tm.root_level(from_numpy_u32(cols, "cpu")))


def test_host_levels_from_matches_jax():
    top = np.random.default_rng(7).integers(0, 1 << 32, (8, 64), dtype=np.uint64).astype(np.uint32)
    got, want = tm.host_levels_from(top), jm.host_levels_from(top)
    assert len(got) == len(want) == 6
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert tm.host_levels_from(top[:, :1]) == []
