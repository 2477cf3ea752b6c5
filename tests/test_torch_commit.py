"""Port's commit (`frieda_tpu_torch.api.commit`, device="cpu": every kernel's
plain version) vs `frieda_tpu.api.commit` and the spec oracle; and the anchor
roots chip_smoke.py checks on the card vs the JAX package. Tolerance: exact
equality of the 32 root bytes."""

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from chip_smoke import ANCHORS, synthetic_data  # noqa: E402
from frieda_tpu import api as japi  # noqa: E402
from frieda_tpu.spec import commit as sc  # noqa: E402
from frieda_tpu_torch import api as tapi  # noqa: E402

torch.set_num_threads(1)

CASES = [(s, b) for s in (0, 1, 61, 1024, 9999) for b in (1, 4)] + [(333, 3), (4096, 2)]


@pytest.mark.parametrize("size,log_blowup", CASES)
def test_commit_matches_jax_and_spec(size, log_blowup):
    data = bytes((i * 31 + size) % 256 for i in range(size))
    got = tapi.commit(data, log_blowup, device="cpu")
    assert len(got) == 32
    assert got == japi.commit(data, log_blowup)
    assert got == sc.commit(data, log_blowup)


@pytest.mark.parametrize("n_bytes,root_hex", ANCHORS[:4])
def test_smoke_anchor_roots_match_jax(n_bytes, root_hex):
    data = synthetic_data(n_bytes)
    assert japi.commit(data, 4).hex() == root_hex
    assert tapi.commit(data, 4, device="cpu").hex() == root_hex


@pytest.mark.parametrize("n_bytes,root_hex", ANCHORS[:2])
def test_smoke_anchor_roots_match_spec(n_bytes, root_hex):
    assert sc.commit(synthetic_data(n_bytes), 4).hex() == root_hex


@pytest.mark.slow
@pytest.mark.parametrize("n_bytes,root_hex", ANCHORS[4:])
def test_large_smoke_anchor_roots_match_jax(n_bytes, root_hex):
    assert japi.commit(synthetic_data(n_bytes), 4).hex() == root_hex
