"""The port's commit phase as one dispatch (`frieda_tpu_torch.core.fri`:
`_fri_commit_fn`, `dispatch_words`, `dispatch_blobs`), in the parts a CPU
can run: one blob as a batch of one under a key of B = 1; the
seed as two device words (`seed_words`) against the int seed and the JAX
package's `dc_mix_u64_const`; the lease and key bookkeeping of the graph
cache (`_GraphCache`, `_Instance`, `Committed.release`), with stand-in
instances where the card would capture a CUDA graph; and the rule that the
CPU never captures. The capture itself needs the card (chip_smoke.py phase
13). Tolerance: exact equality (integer arithmetic and hashes)."""

import pytest

pytest.importorskip("torch")

import gc  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from frieda_tpu.core import device_channel as jdc  # noqa: E402
from frieda_tpu_torch import api  # noqa: E402
from frieda_tpu_torch.config import FriConfig, PcsConfig  # noqa: E402
from frieda_tpu_torch.core import fri  # noqa: E402
from frieda_tpu_torch.ops import channel as channel_ops  # noqa: E402
from frieda_tpu_torch.utils.convert import to_numpy_u32  # noqa: E402
from frieda_tpu_torch.utils.packing import log_total_for, upload_words, words_for  # noqa: E402

torch.set_num_threads(1)

M64 = (1 << 64) - 1
SEEDS = [None, 0, 1, 1 << 31, (1 << 32) - 1, 1 << 32, 1 << 63, M64, (1 << 64) + 5, -1]
# 24-byte blobs: 8 felts, a 2^3 domain, one FRI layer; a proof takes well
# under a second of the plain versions on the CPU
CFG = PcsConfig(pow_bits=2, fri_config=FriConfig(2, 0, 3))
DATAS = [bytes((i * k + 3) % 256 for i in range(24)) for k in (7, 11, 13, 17)]


@pytest.mark.parametrize("seed", SEEDS, ids=str)
def test_seed_words_mix_as_the_int_seed(seed):
    """The (2,) int32 seed words leave the channel state that the int seed
    leaves (the transcript's plain version), and the digest is the JAX
    package's `dc_mix_u64_const` of the seed; None mixes nothing."""
    words = fri.seed_words(seed, "cpu")
    by_words, by_int = channel_ops.new_state("cpu"), channel_ops.new_state("cpu")
    if seed is None:
        assert words is None
    else:
        value = int(seed) & M64
        assert to_numpy_u32(words).tolist() == [value & 0xFFFFFFFF, value >> 32]
        assert fri.seed_words(words, "cpu") is words
        channel_ops.transcript_plain(by_words, mix_u64=words)
        channel_ops.transcript_plain(by_int, mix_u64=int(seed))
        want = np.asarray(jdc.dc_mix_u64_const(jdc.fresh_digest(), seed))
        assert to_numpy_u32(by_words[:8]).tolist() == want.tolist()
    assert torch.equal(by_words, by_int)


class Stub(fri._Instance):
    """An instance that captures nothing: the cache's and the leases' view."""

    def __init__(self, warm: bool):
        self.warm, self.closed = warm, False

    def close(self):
        self.closed = True


class CpuGraph(fri._Instance):
    """A stand-in for `fri._CommitGraph` on the CPU: static words of one
    blob, and a run that is the eager commit phase over them, leased as a
    replay's is."""

    def __init__(self, log_total: int, pcs_config, warm: bool):
        self.log_total, self.pcs_config, self.warm = log_total, pcs_config, warm
        self.words = torch.zeros((1, words_for(log_total)), dtype=torch.int32)

    def run(self, seeds):
        c = fri.commit_phase(self.words, self.log_total, seeds, self.pcs_config)
        self.lend(c[0])
        return c


@pytest.fixture(scope="module")
def looped():
    """commit_and_prove of each blob of DATAS under seeds 1-4: wire bytes."""
    return [api.commit_and_prove(d, s, CFG, device="cpu")[1].to_bytes() for s, d in enumerate(DATAS, 1)]


def committed() -> fri.Committed:
    return fri.Committed([], [], (fri.BatchFetch(torch.zeros((1, 0), dtype=torch.int32)), 0), 1, 1)


def test_a_leased_instance_is_never_handed_out():
    cache = fri._GraphCache(8)
    first = cache.instance("k", Stub)
    held = committed()
    first.lend(held)
    second = cache.instance("k", Stub)
    assert second is not first and cache.captures == 2 and [first.warm, second.warm] == [True, False]
    second.lend(committed())  # a temporary: collected at once, so `second` is free again
    assert cache.instance("k", Stub) is second
    held.release()
    assert first.free and cache.instance("k", Stub) is first and cache.captures == 2


def test_a_lease_ends_with_finish_proof_and_with_collection():
    log_total = log_total_for(len(DATAS[0]))
    words = upload_words([DATAS[0]], log_total, "cpu")[1][0]
    inst = fri._Instance()
    c = fri.commit_phase(words[None], log_total, [5], CFG)[0]
    inst.lend(c)
    assert not inst.free
    want = fri.finish_proof(c, log_total, CFG)
    assert inst.free and c._lease is None
    c = fri.commit_phase(words[None], log_total, [5], CFG)[0]
    inst.lend(c)
    del c
    gc.collect()
    assert inst.free
    assert fri.prove_words(words, log_total, 5, CFG)[1].to_bytes() == want[1].to_bytes()


@pytest.mark.parametrize("window", [1, 2, 3])
def test_a_window_holds_that_many_instances_per_key(monkeypatch, looped, window):
    """prove_many finishes the oldest proof before it dispatches the next, so
    a key (here every blob: one size, every seed set) holds `window`
    instances; the proofs equal a loop of commit_and_prove."""
    cache = fri._GraphCache(8)

    def commit_graph(log_total, pcs_config, has_seed, device, blobs=1, mesh=None, row=0):
        return cache.instance((log_total, has_seed), lambda warm: CpuGraph(log_total, pcs_config, warm))

    monkeypatch.setattr(fri, "_commit_graph", commit_graph)
    batch = api.prove_many(DATAS, [1, 2, 3, 4], CFG, max_in_flight=window, device="cpu")
    assert [p.to_bytes() for _, p in batch] == looped
    (_, insts, _), = cache.keys.values()
    assert len(insts) == window == cache.captures and all(i.free for i in insts)
    assert [i.warm for i in insts] == [True] + [False] * (window - 1)


def test_prove_many_over_several_keys_keeps_within_the_budget(monkeypatch, looped):
    """A sequence of prove_many calls over three keys (query counts): a
    capture first closes free instances of the least recently used other
    keys until the instances' bytes, its own and a first instance's warm-up
    fit `MEMORY_SHARE` of the device; each call still holds its window of
    3, and the proofs equal commit_and_prove's."""
    cache = fri._GraphCache(8)
    device = "stand-in card"  # the cache's budget 600 there; the window's on the CPU is wide
    monkeypatch.setattr(fri, "device_memory_bytes", lambda d: 1000 if d == device else 1 << 40)
    monkeypatch.setattr(fri, "_GRAPHS", cache)

    def commit_graph(log_total, pcs_config, has_seed, dev, blobs=1, mesh=None, row=0):
        return cache.instance((log_total, pcs_config.fri_config.n_queries), lambda warm: CpuGraph(
            log_total, pcs_config, warm), device, nbytes=100, warm_bytes=100)

    monkeypatch.setattr(fri, "_commit_graph", commit_graph)
    held = []
    for q in (3, 4, 5):  # 3 is CFG's
        cfg = PcsConfig(pow_bits=2, fri_config=FriConfig(2, 0, q))
        batch = [p.to_bytes() for _, p in api.prove_many(DATAS, [1, 2, 3, 4], cfg, max_in_flight=3, device="cpu")]
        if q == 3:
            assert batch == looped
        else:
            words = upload_words([DATAS[0]], 3, "cpu")[1][0]
            assert batch[0] == fri.finish_proof(fri.commit_phase(words[None], 3, [1], cfg)[0], 3, cfg)[1].to_bytes()
        assert len(cache.keys[(3, q)][1]) == 3
        held.append(({k[1]: n for k, n in fri.commit_graphs()[1].items()}, cache.held_bytes(device)))
    # key 5's first capture (with its warm-up) closes two of key 3's, its third the last
    assert held == [({3: 3}, 300), ({3: 3, 4: 3}, 600), ({4: 3, 5: 3}, 600)] and cache.captures == 9


def test_room_is_made_from_free_instances_of_other_keys_on_the_device(monkeypatch):
    """Before a capture the cache closes free instances of other keys on
    the same device, the least recently used key first, until the bytes
    held, the new instance's and a first instance's warm-up fit 60% of the
    device; leased instances and other devices' stay."""
    monkeypatch.setattr(fri, "device_memory_bytes", lambda d: 1000)  # budget 600
    cache = fri._GraphCache(8)
    a, b = "card a", "card b"
    on_b = cache.instance("b", Stub, b, nbytes=500)
    live = [committed() for _ in range(3)]
    old = []
    for c in live:
        old.append(cache.instance("old", Stub, a, nbytes=100))
        old[-1].lend(c)
    live.pop().release()  # old[2] free, old[0] and old[1] leased
    new = [cache.instance("new", Stub, a, nbytes=100, warm_bytes=200)]  # 300 held + 300 fit
    assert cache.held_bytes(a) == 400 and cache.held_bytes(a, leased_only=True) == 200
    new.append(cache.instance("new", Stub, a, nbytes=300))  # new[0] is free: it is handed out
    assert new[1] is new[0]
    new[0].lend(committed())  # collected at once: new[0] free again
    new[0].lend(keep := committed())
    new.append(cache.instance("new", Stub, a, nbytes=300))  # 400 + 300: old[2], the free one, goes
    assert old[2].closed and not old[0].closed and cache.held_bytes(a) == 700 - 100
    live.pop(0).release()  # old[0] free
    cache.instance("newest", Stub, a, nbytes=100)  # 600 + 100: old[0] goes, not old[1] (leased)
    assert old[0].closed and not old[1].closed and cache.held_bytes(a) == 600
    assert list(cache.keys) == ["b", "old", "new", "newest"] and not on_b.closed
    live.pop().release()  # old[1] free; new[0] leased by `keep`, new[2] and newest's free
    cache.instance("fourth", Stub, a, nbytes=500)  # 600 + 500: every free instance on `a` goes
    assert old[1].closed and new[2].closed and not new[0].closed
    assert list(cache.keys) == ["b", "new", "fourth"] and cache.held_bytes(a) == 100 + 500
    assert not on_b.closed and cache.held_bytes(b) == 500 and keep._lease is new[0]


def test_safe_in_flight_leaves_out_what_live_leases_hold(monkeypatch):
    """The window's budget loses the bytes of the captured commit phases that
    live `Committed`s hold on the card (free ones the cache closes)."""
    cache = fri._GraphCache(8)
    monkeypatch.setattr(fri, "_GRAPHS", cache)
    monkeypatch.setattr(fri, "device_memory_bytes", lambda device: 80 << 30)
    cuda = torch.device("cuda", 0)
    fc = FriConfig(4, 0, 20)
    domain = 1 << 24
    empty = fri.safe_in_flight(20, fc, cuda)
    assert empty == (int(0.6 * (80 << 30)) - fri.ACTIVE_BYTES_PER_ELEMENT * domain) // (
        fri.RESIDENT_BYTES_PER_ELEMENT * domain)
    held = committed()
    cache.instance("k", Stub, cuda, nbytes=10 * fri.RESIDENT_BYTES_PER_ELEMENT * domain).lend(held)
    cache.instance("j", Stub, cuda, nbytes=1 << 40)  # free: not counted
    assert fri.safe_in_flight(20, fc, cuda) == empty - 10
    assert fri.safe_in_flight(20, fc, torch.device("cuda", 1)) == empty
    held.release()
    assert fri.safe_in_flight(20, fc, cuda) == empty


def test_a_bare_cuda_device_and_its_index_share_a_key(monkeypatch):
    """"cuda" names the current card: `_commit_graph` asks `_fri_commit_fn`
    for cuda:<current> either way, so one configuration on one card is one
    key (one warm-up, one capture)."""
    asked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(fri, "_fri_commit_fn", lambda *args: asked.append(args[3]))
    for device in ("cuda", "cuda:0", torch.device("cuda"), torch.device("cuda", 0)):
        fri._commit_graph(3, CFG, True, device)
    assert asked == [torch.device("cuda", 0)] * 4 and len({str(d) for d in asked}) == 1


def test_the_ninth_key_evicts_the_least_recently_used_free_key():
    cache = fri._GraphCache(8)
    insts = [cache.instance(k, Stub) for k in range(8)]
    held = committed()
    insts[0].lend(held)  # key 0 is the least recently used, but holds a live lease
    cache.instance(1, Stub)  # key 1 becomes the most recently used
    cache.instance(8, Stub)
    assert list(cache.keys) == [0, 3, 4, 5, 6, 7, 1, 8] and insts[2].closed
    assert not any(i.closed for k, i in enumerate(insts) if k != 2)
    again = cache.instance(2, Stub)  # captured anew, warm, and key 3 goes
    assert again is not insts[2] and again.warm and insts[3].closed and cache.captures == 10
    del held
    gc.collect()
    cache.clear()
    assert not cache.keys and all(i.closed for i in insts) and again.closed


def test_every_key_leased_evicts_nothing():
    cache = fri._GraphCache(2)
    held = [committed() for _ in range(2)]
    for k, c in enumerate(held):
        cache.instance(k, Stub).lend(c)
    cache.instance(2, Stub)
    assert list(cache.keys) == [0, 1, 2]
    cache.clear()
    assert list(cache.keys) == [0, 1]


def test_meshes_that_stay_eager():
    """A process-group mesh and a row over two devices run the commit phase
    eagerly (no capture is asked for), as the CPU does."""
    cuda = torch.device("cuda", 0)

    def mesh(group, devices):
        return types.SimpleNamespace(group=group, local_elems=lambda row: [0, 1], device=lambda row, e: devices[e])

    log_total = log_total_for(len(DATAS[0]))
    assert log_total == 3 and fri._commit_graph(log_total, CFG, True, "cpu") is None
    assert fri._commit_graph(log_total, CFG, True, cuda, 1, mesh(object(), [cuda, cuda]), 0) is None
    assert fri._commit_graph(log_total, CFG, True, cuda, 1, mesh(None, [cuda, torch.device("cuda", 1)]), 0) is None
    with pytest.raises(ValueError, match="unsatisfiable"):
        fri._commit_graph(2, PcsConfig(4, FriConfig(2, 1, 8)), True, "cpu")


def test_the_cpu_never_captures(monkeypatch):
    """prove_words, prove_many and commit_and_prove on the CPU run the eager
    commit phase: torch.cuda.graph and CUDAGraph are never touched."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA graph on the CPU path")

    monkeypatch.setattr(torch.cuda, "graph", refuse)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    captures = fri._GRAPHS.captures
    log_total = log_total_for(len(DATAS[0]))
    words = upload_words([DATAS[0]], log_total, "cpu")[1][0]
    one = fri.prove_words(words, log_total, 9, CFG)
    assert fri.dispatch_words(words[None], log_total, [9], CFG)[0].roots == [
        layer.commitment for layer in [one[1].proof.first_layer, *one[1].proof.inner_layers]]
    batch = api.prove_many(DATAS[:2], [9, None], CFG, device="cpu")
    assert batch[0][1].to_bytes() == one[1].to_bytes()
    assert api.commit_and_prove(DATAS[1], None, CFG, device="cpu")[1].to_bytes() == batch[1][1].to_bytes()
    assert fri._GRAPHS.captures == captures and not fri._GRAPHS.keys


class FakeCapture(fri._Instance):
    """A stand-in for `fri._CommitGraph`, built as `_fri_commit_fn` builds
    one: static (B, nw) words and (B, 2) seeds, and a run that writes the
    seeds and runs the key's eager commit phase over its words on the CPU,
    leased as a replay's is."""

    def __init__(self, device, blobs, n_words, has_seed, commit, tables, warm):
        self.words = torch.zeros((blobs, n_words), dtype=torch.int32)
        self.seed = torch.zeros((blobs, 2), dtype=torch.int32) if has_seed else None
        self.commit = commit

    def run(self, seeds):
        if self.seed is not None:
            fri.write_seeds(self.seed, seeds)
        out = self.commit(self.words, self.seed)
        for c in out:
            self.lend(c)
        return out


@pytest.mark.parametrize("seed", [9, None], ids=str)
@pytest.mark.parametrize("entry", ["words", "bytes"])
def test_one_blob_is_a_batch_of_one_under_one_key(monkeypatch, entry, seed):
    """On a faked card (the device reads as cuda:0 where the dispatch
    chooses, and the capture is a stand-in that runs eagerly on the CPU),
    a one-blob dispatch from staged words or from host bytes takes one
    graph key whose blob count is 1, and its one `Committed` equals row 0
    of the eager batch of one: the same packed words and wire bytes, which
    are commit_and_prove's. Its lease ends with its finish."""
    cache = fri._GraphCache(8)
    monkeypatch.setattr(fri, "_GRAPHS", cache)
    monkeypatch.setattr(fri, "_card", lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(fri, "device_memory_bytes", lambda device: 1 << 40)
    monkeypatch.setattr(fri, "_CommitGraph", FakeCapture)
    log_total = log_total_for(len(DATAS[0]))
    words = upload_words(DATAS[:1], log_total, "cpu")[1]
    if entry == "words":
        dispatched = fri.dispatch_words(words, log_total, [seed], CFG)
    else:
        dispatched = fri.dispatch_blobs(DATAS[:1], log_total, [seed], CFG, "cpu")
    eager = fri.commit_phase(words, log_total, [seed], CFG)
    assert len(dispatched) == len(eager) == 1 and torch.equal(dispatched[0].packed, eager[0].packed)
    (key, (_, insts, _)), = cache.keys.items()
    assert (key[5], key[6], key[-1]) == (seed is not None, torch.device("cuda", 0), 1)
    assert len(insts) == cache.captures == 1
    assert not insts[0].free
    wire = fri.finish_proof(dispatched[0], log_total, CFG)[1].to_bytes()
    assert insts[0].free and wire == fri.finish_proof(eager[0], log_total, CFG)[1].to_bytes()
    assert wire == api.commit_and_prove(DATAS[0], seed, CFG, device="cpu")[1].to_bytes()
