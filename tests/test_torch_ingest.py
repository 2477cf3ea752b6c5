"""Port's ingest (host packing helpers and `ingest_rev`, plain version on
CPU) vs the JAX package and the spec oracle. Tolerance: exact equality."""

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from frieda_tpu.spec import commit as sc  # noqa: E402
from frieda_tpu.utils import packing as jp  # noqa: E402
from frieda_tpu_torch.ops import ingest as ingest_ops  # noqa: E402
from frieda_tpu_torch.utils import packing as tp  # noqa: E402
from frieda_tpu_torch.utils.convert import from_numpy_u32, to_numpy_u32  # noqa: E402


def _blob(size: int) -> bytes:
    return np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("size", [0, 1, 15, 59, 60, 61, 1024, 9999])
def test_ingest_rev_matches_device_ingest_rev(size):
    data = _blob(size)
    log_total = tp.log_total_for(len(data))
    words = tp.pad_to_words(data, log_total)
    got = to_numpy_u32(tp.ingest_rev(from_numpy_u32(words, "cpu"), log_total - 2))
    expect = np.asarray(jp.device_ingest_rev(jnp.asarray(words), log_total - 2))
    assert np.array_equal(got, expect)


@pytest.mark.parametrize("log_size", [9, 11])
def test_ingest_rev_matches_pallas_ingest_rows(log_size):
    """The Pallas ingest kernel in interpret mode, then the shared per-row
    bit-reversal, as tests/test_commit_jax.py runs it."""
    from frieda_tpu.ops import ingest_pallas

    total = 1 << (log_size + 2)
    data = np.random.default_rng(log_size).integers(0, 256, total * 30 // 8, dtype=np.uint8).tobytes()
    words = tp.pad_to_words(data, log_size + 2)
    pre = ingest_pallas.ingest_rows(jnp.asarray(words), log_size, interpret=True)
    expect = np.asarray(jp.bitrev_rows_device(pre, log_size - 4).reshape(4, 1 << log_size))
    got = to_numpy_u32(tp.ingest_rev(from_numpy_u32(words, "cpu"), log_size))
    assert np.array_equal(got, expect)


@pytest.mark.parametrize("size", [0, 1, 14, 15, 16, 29, 30, 31, 100, 4097, 262_146])
def test_host_packing_matches_jax_and_spec(size):
    data = _blob(size)
    log_total = tp.log_total_for(size)
    assert log_total == jp.log_total_for(size)
    assert tp.ceil_log2(size + 1) == jp.ceil_log2(size + 1)
    assert np.array_equal(tp.pad_to_words(data, log_total), jp.pad_to_words(data, log_total))
    assert np.array_equal(tp.bytes_to_felts(data), sc.bytes_to_felts(data))
    assert np.array_equal(tp.polynomial_from_bytes(data), sc.polynomial_from_bytes(data))


def test_ingest_rejects_bad_operands():
    words = from_numpy_u32(tp.pad_to_words(b"abc", 2), "cpu")
    with pytest.raises(ValueError):
        ingest_ops.ingest(words[:-1], 0)  # one word short of pad_to_words
    with pytest.raises(TypeError):
        ingest_ops.ingest(words.to(torch.int64), 0)
