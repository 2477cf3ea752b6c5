"""The port's host copy of blobs into the ingest's buffer (`utils/packing.
stack_words`, `upload_words` on the CPU): split over threads from
SPLIT_BYTES on, and byte for byte the one-thread copy at every length.
Tolerance: exact equality."""

import multiprocessing
import sys
import threading

import numpy as np
import pytest
import torch

from frieda_tpu_torch.utils import packing as tp

torch.set_num_threads(1)

SPLIT = tp.SPLIT_BYTES
CPUS = 4  # the process's affinity as the tests set it: a split copy runs in 4 chunks


@pytest.fixture
def four_cpus(monkeypatch):
    monkeypatch.setattr(tp.os, "sched_getaffinity", lambda pid: set(range(CPUS)))


def _blob(size: int, seed: int = 0) -> bytes:
    return np.random.default_rng([size, seed]).integers(0, 256, size, dtype=np.uint8).tobytes()


def _one_thread(datas, log_total: int) -> np.ndarray:
    """The rows as one thread writes them: each blob's bytes, then zeros."""
    rows = np.zeros((len(datas), 4 * tp.words_for(log_total)), np.uint8)
    for row, data in zip(rows, datas):
        row[: len(data)] = np.frombuffer(data, np.uint8)
    return rows


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in tp.copy_counts().items()}


ODD = SPLIT + 3 * tp.CHUNK_ALIGN + 1  # neither a multiple of a chunk's alignment nor of 4


@pytest.mark.parametrize("sizes", [
    [0], [1], [SPLIT - 1], [SPLIT], [SPLIT + 1], [ODD], [62_914_560],
    [SPLIT // 3 + 5, SPLIT // 2 + 1, 7, SPLIT // 4 + 123],  # each row below, the call above
    [SPLIT // 4, 0, SPLIT // 4 - 1],  # below in all
], ids=lambda s: "+".join(map(str, s)))
def test_stack_and_upload_words_equal_the_one_thread_copy(sizes, four_cpus):
    datas = [_blob(n, k) for k, n in enumerate(sizes)]
    log_total = tp.log_total_for(max(sizes))
    want = _one_thread(datas, log_total)
    split = sum(sizes) >= SPLIT
    before = tp.copy_counts()
    stacked = tp.stack_words(datas, log_total)
    host, words = tp.upload_words(datas, log_total, "cpu")
    assert np.array_equal(stacked.numpy().view(np.uint8), want)
    assert np.array_equal(host.numpy().view(np.uint8), want)
    assert np.array_equal(words.numpy().view(np.uint8), want)
    chunks = len(tp.copy_chunks(sizes, CPUS)) if split else 0
    assert _delta(before) == {"whole": 0 if split else 2, "split": 2 if split else 0, "chunks": 2 * chunks}
    if len(sizes) == 1:
        assert np.array_equal(tp.pad_to_words(datas[0], log_total).view(np.uint8), want[0])


@pytest.mark.parametrize("sizes, parts", [
    ([10, 0, 5000], 3), ([], 4), ([9000, 9000], 4), ([SPLIT], 8), ([62_914_560], 5), ([1, 1, 1], 8),
    ([3 * tp.CHUNK_ALIGN + 1, tp.CHUNK_ALIGN - 1, 2 * tp.CHUNK_ALIGN], 2), ([12_345], 1),
])
def test_copy_chunks_cover_every_byte_once_in_order(sizes, parts):
    chunks = tp.copy_chunks(sizes, parts)
    assert len(chunks) <= parts and all(chunks)
    pieces = [p for chunk in chunks for p in chunk]
    assert all(a < b for _, a, b in pieces)
    assert [p[0] for p in pieces] == sorted(p[0] for p in pieces)
    for k, n in enumerate(sizes):  # row k's pieces tile [0, n) in order
        end = 0
        for a, b in [(a, b) for row, a, b in pieces if row == k]:
            assert a == end
            end = b
        assert end == n
    stream = 0  # every chunk but the last ends on a multiple of CHUNK_ALIGN of the stream
    for chunk in chunks[:-1]:
        stream += sum(b - a for _, a, b in chunk)
        assert stream % tp.CHUNK_ALIGN == 0


def test_concurrent_callers_copy_their_own_blobs(four_cpus):
    """More callers than cores, each splitting its copy over the one pool,
    with the interpreter switching threads as often as it can: every buffer
    holds its caller's blob, and the counts lose no call."""
    callers, rounds = 12, 2
    datas = [_blob(SPLIT + 4 * k + 1, k) for k in range(callers)]
    log_total = tp.log_total_for(len(datas[-1]))
    bad, errors = [], []

    def work(k):
        try:
            for _ in range(rounds):
                got = tp.stack_words([datas[k]], log_total).numpy().view(np.uint8)[0]
                if not np.array_equal(got[: len(datas[k])], np.frombuffer(datas[k], np.uint8)) or got[len(datas[k]):].any():
                    bad.append(k)
        except Exception as exc:  # reported below
            errors.append(repr(exc))

    before = tp.copy_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not bad
    assert _delta(before) == {"whole": 0, "split": callers * rounds, "chunks": callers * rounds * CPUS}


def _copy_in_child(blob: bytes, log_total: int) -> None:
    before = tp.copy_counts()
    got = tp.stack_words([blob], log_total).numpy().view(np.uint8)[0]
    if not np.array_equal(got[: len(blob)], np.frombuffer(blob, np.uint8)) or got[len(blob):].any():
        raise SystemExit(3)
    if _delta(before)["split"] != 1:
        raise SystemExit(4)


def test_a_forked_child_splits_its_copy_with_a_pool_of_its_own(four_cpus):
    """The parent's pool exists when it forks; the child has none of its
    threads, and its split copy still gives the blob's bytes."""
    blob = _blob(SPLIT + 12_345)
    log_total = tp.log_total_for(len(blob))
    tp.stack_words([blob], log_total)
    assert tp._COPIER._pool is not None
    child = multiprocessing.get_context("fork").Process(target=_copy_in_child, args=(blob, log_total))
    child.start()
    child.join(timeout=120)
    if child.is_alive():
        child.kill()
        child.join()
        pytest.fail("the forked child's split copy did not end")
    assert child.exitcode == 0
