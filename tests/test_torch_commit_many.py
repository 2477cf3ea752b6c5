"""Port's batch commit (`frieda_tpu_torch.api.commit_many`, device="cpu":
every kernel's plain version) vs `frieda_tpu.api.commit_many` and a loop of
the port's `commit`; the batched wrappers vs a stack of their one-blob calls;
and the small-batch anchor roots chip_smoke.py checks on the card. Tolerance:
exact equality of the 32 root bytes and of every word."""

import functools

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import COMMIT_MANY_ANCHORS, synthetic_data  # noqa: E402
from frieda_tpu import api as japi  # noqa: E402
from frieda_tpu_torch import api as tapi  # noqa: E402
from frieda_tpu_torch.core import merkle as tm  # noqa: E402
from frieda_tpu_torch.ops import ingest as ingest_ops  # noqa: E402
from frieda_tpu_torch.ops import merkle as merkle_ops  # noqa: E402
from frieda_tpu_torch.utils import packing as tp  # noqa: E402
from frieda_tpu_torch.utils.convert import from_numpy_u32  # noqa: E402

P = (1 << 31) - 1

# (blob sizes, log_blowup): B in {1, 3, 5}, sizes that differ but share a
# log_total (2, 10, 12), log_blowup in {1, 2, 4}
CASES = [
    ((0, 1, 2), 1),
    ((0, 1, 2), 4),
    ((3_000, 3_500, 3_840), 4),
    ((3_840, 3_000, 3_001, 3_500, 3_839), 1),
    ((15_360,), 2),
    ((15_360, 15_359, 14_000, 12_000, 15_360), 2),
]


def _blobs(sizes) -> list:
    return [synthetic_data(n, seed=k) for k, n in enumerate(sizes)]


@functools.lru_cache(maxsize=None)
def _jax_roots(sizes, log_blowup) -> tuple:
    return tuple(japi.commit_many(_blobs(sizes), log_blowup))


@pytest.mark.parametrize("sizes,log_blowup", CASES)
def test_commit_many_matches_jax_and_loop(sizes, log_blowup):
    datas = _blobs(sizes)
    got = tapi.commit_many(datas, log_blowup, device="cpu")
    assert len(got) == len(sizes) and all(len(r) == 32 for r in got)
    assert tuple(got) == _jax_roots(sizes, log_blowup)
    assert got == [tapi.commit(d, log_blowup, device="cpu") for d in datas]
    assert len(set(got)) == len(got)  # distinct blobs, distinct roots


@pytest.mark.parametrize("sizes,log_blowup,roots", COMMIT_MANY_ANCHORS)
def test_smoke_commit_many_anchors_match_jax(sizes, log_blowup, roots):
    assert [r.hex() for r in _jax_roots(sizes, log_blowup)] == list(roots)
    assert [r.hex() for r in tapi.commit_many(_blobs(sizes), log_blowup, device="cpu")] == list(roots)


def test_commit_many_empty_and_unequal_sizes_match_jax():
    assert tapi.commit_many([], 4, device="cpu") == japi.commit_many([], 4) == []
    assert tapi.commit_many(iter([]), 4, device="cpu") == []
    unequal = [synthetic_data(100), synthetic_data(4_000)]
    with pytest.raises(ValueError, match="equal padded sizes") as jax_err:
        japi.commit_many(unequal, 4)
    with pytest.raises(ValueError, match="equal padded sizes") as port_err:
        tapi.commit_many(unequal, 4, device="cpu")
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("sizes", [(0,), (0, 1, 2), (3_000, 3_840, 3_500)])
def test_stack_words_is_a_stack_of_pad_to_words(sizes):
    datas = _blobs(sizes)
    log_total = tp.log_total_for(max(sizes))
    got = tp.stack_words(datas, log_total)
    want = np.stack([tp.pad_to_words(d, log_total) for d in datas])
    assert got.dtype == torch.int32 and np.array_equal(got.numpy().view(np.uint32), want)


def _u32(rng, shape, hi=1 << 32):
    return from_numpy_u32(rng.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32), "cpu")


@pytest.mark.parametrize("log_size", [0, 3, 10, 11])  # per-element and tile forms
def test_batched_ingest_is_a_stack_of_blobs(log_size):
    rng = np.random.default_rng(log_size)
    words = _u32(rng, (3, tp.words_for(log_size + 2)))
    got = ingest_ops.ingest(words, log_size)
    assert got.shape == (3, 4, 1 << log_size)
    want = torch.stack([ingest_ops.ingest(w, log_size) for w in words])
    assert torch.equal(got, want)
    assert not torch.equal(got[0], got[1])


@pytest.mark.parametrize("leaf,fused", [(True, False), (True, True), (False, False), (False, True)])
def test_batched_merkle_level_is_a_stack_of_blobs(leaf, fused):
    rng = np.random.default_rng(int(leaf) * 2 + int(fused))
    x = _u32(rng, (4, 4 if leaf else 8, 64), P if leaf else 1 << 32)
    got = merkle_ops.merkle_level(x, leaf, fused)
    fold = 8 if fused else (1 if leaf else 2)
    assert got.shape == (4, 8, 64 // fold)
    assert torch.equal(got, torch.stack([merkle_ops.merkle_level(b, leaf, fused) for b in x]))
    # a stacked (B, 8, M) is not one level of width B * M: pairs stay in a blob
    if not leaf:
        flat = merkle_ops.merkle_level(x.permute(1, 0, 2).reshape(8, -1), leaf, fused)
        assert not torch.equal(flat.reshape(8, 4, -1).permute(1, 0, 2), got)


@pytest.mark.parametrize("m,widths", [(1, (1,)), (2, (1,)), (64, (8, 1)), (4096, (512, 64, 8, 1))])
def test_batched_collapse_is_a_stack_of_blobs(m, widths):
    level = _u32(np.random.default_rng(m), (3, 8, m))
    got = merkle_ops.merkle_collapse(level, widths)
    for k, w in enumerate(widths):
        assert got[k].shape == (3, 8, w)
        assert torch.equal(got[k], torch.stack([merkle_ops.merkle_collapse(b, widths)[k] for b in level]))


@pytest.mark.parametrize("log_n", [1, 2, 3, 12])  # one-level leaf, fused + collapse, fused inner passes
def test_batched_root_level_is_a_stack_of_blobs(log_n, monkeypatch):
    monkeypatch.setattr(merkle_ops, "COLLAPSE_MAX", 64)  # run the fused inner passes at a small size
    cols = _u32(np.random.default_rng(log_n), (3, 4, 1 << log_n), P)
    got = tm.root_level(cols)
    assert got.shape == (3, 8, 1)
    assert torch.equal(got, torch.stack([tm.root_level(c) for c in cols]))
    assert tm.root_bytes_many(got) == [tm.root_bytes(t) for t in got]


def test_batched_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        ingest_ops.ingest(torch.zeros((0, tp.words_for(2)), dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        merkle_ops.merkle_level(torch.zeros((2, 8, 8), dtype=torch.int32), leaf=True, fused=False)
    with pytest.raises(ValueError):
        merkle_ops.merkle_collapse(torch.zeros((2, 4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        tapi.commit_root_pipeline_batch(torch.zeros(tp.words_for(2), dtype=torch.int32), 2, 1)
