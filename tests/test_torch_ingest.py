"""Port's ingest (host packing helpers and `ingest_rev`, plain version on
CPU) vs the JAX package and the spec oracle. Tolerance: exact equality."""

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from frieda_tpu.spec import commit as sc  # noqa: E402
from frieda_tpu.utils import packing as jp  # noqa: E402
from frieda_tpu_torch.core.circle import bitrev_array  # noqa: E402
from frieda_tpu_torch.ops import ingest as ingest_ops  # noqa: E402
from frieda_tpu_torch.utils import packing as tp  # noqa: E402
from frieda_tpu_torch.utils.convert import from_numpy_u32, to_numpy_u32  # noqa: E402

torch.set_num_threads(1)


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


@pytest.mark.parametrize("log_size", [9, 10, 11])
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


def _unpack(words, bit):
    """30-bit fields at bit offsets `bit` of u32 `words` (int64 arrays); the
    high word read only where the field straddles it (s > 2)."""
    w, s = bit >> 5, bit & 31
    hi = np.where(s > 2, (words[np.where(s > 2, w + 1, w)] << (32 - s)) & 0xFFFFFFFF, 0)
    return ((words[w] >> s) | hi) & ((1 << 30) - 1)


def _tile_ingest(words, log_size):
    """Mirror of `csrc/ingest.cu`: (outputs, read count of each word, write
    count of each output). Tile form: block (c, p0) reads, for each lo, the
    span of `tile` 30-word runs at felt c*L + rev5(lo) * 2^(ls-5) + p0 * 32,
    and writes output (c, hi * 2^(ls-5) + rev(p0 + pp) * 32 + lo) from felt
    rev5(hi) of run (pp, lo). Per-element form: output r reads the words of
    felt c*L + rev(r)."""
    L = 1 << log_size
    out = np.zeros(4 * L, np.int64)
    reads = np.zeros(words.size, np.int64)
    writes = np.zeros(4 * L, np.int64)
    tile = ingest_ops.ingest_tile(log_size)
    if not tile:
        f = np.arange(4)[:, None] * L + bitrev_array(np.arange(L), log_size)[None, :]
        bit = 30 * f.reshape(-1)
        np.add.at(reads, bit >> 5, 1)
        np.add.at(reads, ((bit >> 5) + 1)[(bit & 31) > 2], 1)
        out[:] = _unpack(words, bit)
        writes += 1
        return out, reads, writes
    mid_bits = log_size - 10
    per_column = (1 << mid_bits) // tile
    lo = np.arange(32)
    for block in range(4 * per_column):
        c, p0 = block // per_column, (block % per_column) * tile
        felt0 = c * L + (bitrev_array(lo, 5) << (log_size - 5)) + p0 * 32  # one span per lo
        assert (felt0 % 32 == 0).all()
        at = felt0[:, None] // 32 * 30 + np.arange(30 * tile)[None, :]
        np.add.at(reads, at.reshape(-1), 1)
        runs = words[at].reshape(32, tile, 30)  # [lo, pp, word]
        pp, hi, lo_ = np.meshgrid(np.arange(tile), np.arange(32), lo, indexing="ij")
        bit = 30 * bitrev_array(hi, 5)
        run_words = runs[lo_, pp]  # (tile, 32, 32, 30)
        w, s = bit >> 5, bit & 31
        low = np.take_along_axis(run_words, w[..., None], -1)[..., 0] >> s
        high = np.take_along_axis(run_words, np.minimum(w + 1, 29)[..., None], -1)[..., 0]
        v = (low | np.where(s > 2, (high << (32 - s)) & 0xFFFFFFFF, 0)) & ((1 << 30) - 1)
        r = (hi << (log_size - 5)) + bitrev_array(p0 + pp, mid_bits) * 32 + lo_
        out[c * L + r] = v
        np.add.at(writes, (c * L + r).reshape(-1), 1)
    return out, reads, writes


@pytest.mark.parametrize("log_size", range(15))
def test_ingest_tile_mirror_matches_plain(log_size):
    nw = tp.words_for(log_size + 2)
    words = np.random.default_rng(log_size).integers(0, 1 << 32, nw, dtype=np.uint64).astype(np.int64)
    out, reads, writes = _tile_ingest(words, log_size)
    want = ingest_ops.ingest_plain(torch.from_numpy(words), log_size)
    assert np.array_equal(out.reshape(4, -1), want.numpy())
    assert (writes == 1).all()
    assert reads[(30 * (4 << log_size) + 31) // 32:].sum() == 0  # nothing past the felts' last word
    if ingest_ops.ingest_tile(log_size):
        assert (reads[: 30 * (4 << log_size) // 32] == 1).all()  # every word once, in whole runs


def test_ingest_tile_plan():
    assert [ingest_ops.ingest_tile(k) for k in range(15)] == [0] * 10 + [1, 2, 4, 8, 8]
    words = from_numpy_u32(tp.pad_to_words(b"", 12), "cpu")
    for bad_log in (-1, 11):  # no such size; more felts than the words hold
        with pytest.raises(ValueError):
            ingest_ops.ingest(words, bad_log)


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
