"""The proof's decommitment ordered in the commit phase
(`ops.merkle.order_openings`, `order_openings_plain`, `ordered_section`) and
cut on the host (`core/fri._cut`), against a copy of the host selection it
replaces (`_assemble` over `_known_levels`, kept here as the oracle), on
synthetic gathers at both benchmark cells' layouts (a 2^15 domain, 14
layers, 70 queries; a 2^26 domain, 22 layers, 20 queries) and a tiny one,
with no trees built. A Python mirror of the kernel's plan (rank sort, the
highest differing bit of neighbouring words, the marked left siblings, the
lists of each bit) holds the CUDA kernel's arithmetic to the plain version;
on a card the kernel itself is held to it, bit for bit, for B = 1, 4, 5
and 9 and inside a captured graph (`card` tests, skipped without CUDA).
`fri.select_counts` tells the proofs cut from an ordered row from those
planned on the host (`opening_cls`). Inputs are seeded; tolerance: exact
equality."""

import pytest

pytest.importorskip("torch")

import struct  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from chip_smoke import synthetic_data  # noqa: E402
from frieda_tpu_torch import api  # noqa: E402
from frieda_tpu_torch.config import PcsConfig  # noqa: E402
from frieda_tpu_torch.core import fri, merkle  # noqa: E402
from frieda_tpu_torch.ops import merkle as merkle_ops  # noqa: E402
from frieda_tpu_torch.parallel import sharding  # noqa: E402
from frieda_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from frieda_tpu_torch.utils.convert import from_numpy_u32, narrow, to_numpy_u32  # noqa: E402
from frieda_tpu_torch.utils.packing import log_total_for, pad_to_words  # noqa: E402

torch.set_num_threads(1)

# (n, T, nq): the block cell's proof, the 2^24-felt proof's, and a tiny domain
LAYOUTS = {"block9": (15, 14, 70), "2p24": (26, 22, 20), "tiny": (4, 3, 16)}
SMALL = PcsConfig.from_dict({"pow_bits": 0, "fri_config": {"log_blowup_factor": 1, "log_last_layer_degree_bound": 0,
                                                           "n_queries": 64}})


def sizes_of(n: int, T: int) -> list:
    return [n - t for t in range(T)]


# --- the oracle: the host selection this change replaced ----------------------

def _known_levels(positions, levels: int) -> tuple:
    q = np.asarray(positions, np.int64).reshape(-1)
    d = np.arange(levels, dtype=np.int64)
    keys, first = np.unique((d[:, None] << 40 | q[None, :] >> d[:, None]).reshape(-1), return_index=True)
    return keys >> 40, keys & ((1 << 40) - 1), first % max(q.size, 1), fri._pairs(keys)[0]


def _assemble(words: np.ndarray, raw: np.ndarray, pair_off: list, auth_off: list, sizes: list) -> tuple:
    """`core/fri._assemble` as it stood before the ordering moved to the card,
    over the gathers `words` at `open_queries_offsets`."""
    nq = raw.size
    T = len(sizes)
    level, node, slot, lone = _known_levels(raw, sizes[0])
    pair = np.asarray(pair_off, np.int64)
    cols = 2 * nq * np.arange(4)

    def values(sel, flip):
        at = pair[level[sel]] + 2 * slot[sel] + ((node[sel] & 1) ^ flip)
        return words[at[:, None] + cols].tolist()

    evaluations = [tuple(v) for v in values(level == 0, 0)]
    wit_sel = lone & (level < T)
    witness = [tuple(v) for v in values(wit_sel, 1)]
    wit_cut = np.r_[0, np.cumsum(np.bincount(level[wit_sel], minlength=T))]
    auth = np.zeros((T, sizes[0]), np.int64)
    for t, offs in enumerate(auth_off):
        auth[t, : len(offs)] = offs
    e_level, e_slot = level[lone], slot[lone]
    t_idx, e_idx = np.nonzero(e_level[None, :] > np.arange(T)[:, None])
    at = auth[t_idx, e_level[e_idx] - t_idx] + e_slot[e_idx]
    blob = words[at[:, None] + nq * np.arange(8)].astype("<u4").tobytes()
    hashes = struct.unpack("32s" * at.size, blob)
    hash_cut = np.r_[0, np.cumsum(np.bincount(t_idx, minlength=T))]
    return evaluations, [(witness[wit_cut[t] : wit_cut[t + 1]], list(hashes[hash_cut[t] : hash_cut[t + 1]]))
                         for t in range(T)]


# --- synthetic gathers: each entry a function of the node it holds -----------

def _mix(*parts) -> np.ndarray:
    x = np.zeros(np.broadcast(*parts).shape, np.uint64)
    for k, p in enumerate(parts):
        x = (x ^ np.asarray(p, np.uint64)) * np.uint64(0x9E3779B97F4A7C15 + 2 * k)
        x ^= x >> np.uint64(29)
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def synthetic_gathers(words: np.ndarray, n: int, T: int, salt: int = 0) -> np.ndarray:
    """What `merkle_open_queries` writes for these raw words over T layers of
    2^n, 2^(n-1), ... leaves, with made-up columns and nodes: a value is a
    function of (layer, stored index, column), a node of (layer, level,
    node, word), so every draw under a node gathers the same words."""
    q = words.astype(np.int64) & ((1 << n) - 1)
    nq = q.size
    out = []
    for t in range(T):
        pos = q >> t
        idx = (pos & ~1)[None, :, None] | np.arange(2)[None, None, :]  # (1, nq, 2)
        out.append(_mix(salt, t, idx, np.arange(4)[:, None, None]).reshape(-1))  # (4, nq, 2)
        for k in range(n - t):
            out.append(_mix(salt + 1, t, k, ((pos >> k) ^ 1)[None, :], np.arange(8)[:, None]).reshape(-1))
    g = np.concatenate(out)
    assert g.size == merkle_ops.open_queries_words(sizes_of(n, T), nq)
    return g


def query_set(kind: str, n: int, nq: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":  # with repeated draws
        words = rng.integers(0, 1 << n, nq, dtype=np.uint32)
        words[-1], words[nq // 2] = words[0], words[min(1, nq - 1)]
    elif kind == "equal":
        words = np.full(nq, rng.integers(0, 1 << n), np.uint32)
    elif kind == "siblings":  # adjacent positions p, p + 1
        base = rng.integers(0, 1 << (n - 1), (nq + 1) // 2).astype(np.uint32) * 2
        words = np.stack([base, base + 1], 1).reshape(-1)[:nq]
    elif kind == "every":  # every position of the domain, shuffled
        words = rng.permutation(1 << n).astype(np.uint32)
    elif kind == "every_twice":
        words = rng.permutation(np.tile(np.arange(1 << n, dtype=np.uint32), 2))
    else:
        raise AssertionError(kind)
    return words


def cut_row(section: np.ndarray, sizes: list, nq: int) -> tuple:
    """`fri._cut` of one ordered section, as the tail of a packed row."""
    layout = fri.PackedLayout({"qpos": (0, 0)}, merkle_ops.ordered_section(tuple(sizes), nq), section.size, sizes)
    return fri._cut(section.astype(np.uint32), layout)


def oracle(gathers: np.ndarray, words: np.ndarray, sizes: list) -> tuple:
    pair_off, auth_off = merkle_ops.open_queries_offsets(sizes, words.size)
    return _assemble(gathers, words.astype(np.int64) & ((1 << sizes[0]) - 1), pair_off, auth_off, sizes)


CASES = [("block9", k) for k in ("random", "equal", "siblings", "single")] + \
        [("2p24", k) for k in ("random", "equal", "siblings", "single")] + \
        [("tiny", "every"), ("tiny", "every_twice")]


@pytest.mark.parametrize("layout, kind", CASES)
def test_ordered_section_cut_equals_the_host_selection(layout, kind):
    """The plain ordered section, cut as `finish_proof` cuts it, gives the
    evaluations and every layer's FRI and hash witness of the old host
    selection; the section is `ordered_section` long, within the gathers'
    length, zero past its counts."""
    n, T, nq = LAYOUTS[layout]
    if kind == "single":
        nq, kind = 1, "random"
    elif kind == "every_twice":
        nq = 2 << n
    words = query_set(kind, n, nq, seed=n + nq)
    sizes = sizes_of(n, T)
    gathers = synthetic_gathers(words, n, T)
    section = to_numpy_u32(narrow(merkle_ops.order_openings_plain(gathers, words, sizes)))
    sec = merkle_ops.ordered_section(tuple(sizes), nq)
    assert section.size == sec.words <= merkle_ops.open_queries_words(sizes, nq)
    got = cut_row(section, sizes, nq)
    assert got == oracle(gathers, words, sizes)
    evals, layers = got
    assert len(evals) == len(set((words & ((1 << n) - 1)).tolist()))
    used_values = len(evals) + sum(len(w) for w, _ in layers)
    used_nodes = sum(len(h) for _, h in layers)
    assert not section[sec.values + 4 * used_values : sec.nodes].any()
    assert not section[sec.nodes + 8 * used_nodes :].any()
    # the wrapper on CPU tensors is the plain version
    out = merkle_ops.order_openings(from_numpy_u32(gathers, "cpu"), from_numpy_u32(words, "cpu"), sizes)
    assert np.array_equal(to_numpy_u32(out), section)


@pytest.mark.parametrize("B", [1, 5, 9])
def test_a_batch_orders_each_row(B):
    """B rows of gathers and words (rows of wider tensors, as a batch's packed
    vectors are): each row's section == its own, and its cut == the oracle."""
    n, T, nq = LAYOUTS["block9"]
    sizes = sizes_of(n, T)
    kinds = ["random", "equal", "siblings"]
    words = np.stack([query_set(kinds[b % 3], n, nq, seed=b) for b in range(B)])
    gathers = np.stack([synthetic_gathers(words[b], n, T, salt=b) for b in range(B)])
    sec = merkle_ops.ordered_section(tuple(sizes), nq)
    packed = torch.zeros((B, 7 + sec.words), dtype=torch.int32)
    got = merkle_ops.order_openings(from_numpy_u32(gathers, "cpu"), from_numpy_u32(words, "cpu"), sizes,
                                    packed[:, 7:])
    assert got.data_ptr() == packed[:, 7:].data_ptr() and not packed[:, :7].any()
    plain = merkle_ops.order_openings_plain(gathers, words, sizes)
    assert plain.shape == (B, sec.words) and torch.equal(packed[:, 7:], narrow(plain))
    for b in range(B):
        row = to_numpy_u32(packed[b, 7:])
        assert np.array_equal(row, to_numpy_u32(narrow(merkle_ops.order_openings_plain(gathers[b], words[b],
                                                                                         sizes))))
        assert cut_row(row, sizes, nq) == oracle(gathers[b], words[b], sizes)


def test_order_openings_checks_its_operands():
    n, T, nq = LAYOUTS["tiny"]
    sizes = sizes_of(n, T)
    words = from_numpy_u32(query_set("every", n, nq, 0), "cpu")
    gathers = from_numpy_u32(synthetic_gathers(to_numpy_u32(words), n, T), "cpu")
    with pytest.raises(ValueError, match="log sizes"):
        merkle_ops.order_openings(gathers, words, [4, 2, 1])
    with pytest.raises(ValueError, match="gathers"):
        merkle_ops.order_openings(gathers[1:], words, sizes)
    with pytest.raises(ValueError, match="out"):
        merkle_ops.order_openings(gathers, words, sizes, torch.empty(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="query words"):
        merkle_ops.order_openings(gathers, words[:0], sizes)


def test_the_section_is_no_longer_than_the_gathers():
    """At every layout of a proof up to n = 31 layers and 1-1024 queries the
    ordered section (the packed vector's part after the head) holds no more
    words than the per-query gathers it replaced there."""
    for n in (1, 2, 5, 15, 26, 31):
        for T in sorted({1, n // 2 or 1, n}):
            for nq in (1, 3, 20, 70, 1024):
                sizes = sizes_of(n, T)
                assert merkle_ops.ordered_section(tuple(sizes), nq).words <= merkle_ops.open_queries_words(sizes, nq)


# --- the kernel's plan, mirrored ------------------------------------------------

def mirror_kernel(gathers: np.ndarray, words: np.ndarray, sizes: list) -> np.ndarray:
    """`order_openings_kernel` (csrc/merkle.cu) step by step for one blob:
    threads as list indices, warps of 32 lanes, the ballots as bit lists."""
    n, T, nq = sizes[0], len(sizes), words.size
    sec = merkle_ops.ordered_section(tuple(sizes), nq)
    threads = 1024
    word = [int(w) & ((1 << n) - 1) for w in words]
    pos, slot = [0] * nq, [0] * nq
    for e in range(nq):
        r = sum((word[j] < word[e]) | ((word[j] == word[e]) & (j < e)) for j in range(nq))
        pos[r], slot[r] = word[e], e
    high = []
    for e in range(nq):
        x = pos[e] ^ pos[e - 1] if e else 0
        high.append(31 if e == 0 else (x.bit_length() - 1 if x else -1))
    marked = [0] * nq
    for e in range(1, nq):
        if high[e] >= 0:
            f = e - 1
            while high[f] < high[e]:
                f -= 1
            marked[f] |= 1 << high[e]
    mask = [0] * threads
    for e in range(nq):
        if high[e] >= 0:
            hb = high[e]
            levels = (1 << n) - 1 if hb >= n - 1 else (2 << hb) - 1
            mask[e] = (levels & ~((1 << hb) if e else 0) & ~marked[e] & 0xFFFFFFFF) | (1 << 31)
    warps = threads // 32
    base = [[bin(sum(((mask[32 * w + l] >> b) & 1) << l for l in range(32))).count("1") for b in range(32)]
            for w in range(warps)]
    first = [0] * 33
    for b in range(32):
        total = 0
        for w in range(warps):
            base[w][b], total = total, total + base[w][b]
        first[b + 1] = total
    for b in range(32):
        first[b + 1] += first[b]
    pair_at, hbase, at = [], [0], 0
    for t in range(T):
        pair_at.append(at)
        at += 8 * nq * (1 + n - t)
        hbase.append(hbase[t] + first[n] - first[t + 1])
    lst = [None] * first[32]
    assert first[32] <= sec.list_cap
    for e in range(nq):
        w, lane = divmod(e, 32)
        for b in range(32):
            if (mask[e] >> b) & 1:
                below = sum((mask[32 * w + l] >> b) & 1 for l in range(lane))
                lst[first[b] + base[w][b] + below] = e
    out = np.zeros(sec.words, np.int64)
    evals = first[32] - first[31]
    out[0] = evals
    for t in range(T):
        out[1 + t] = first[t + 1] - first[t]
        out[1 + T + t] = hbase[t + 1] - hbase[t]
    vals = 1 + 2 * T
    n_vals = evals + first[T]
    for x in range(4 * n_vals):  # past n_vals the kernel writes zeros
        v = x >> 2
        t = 0
        if v < evals:
            e = lst[first[31] + v]
            el = pos[e] & 1
        else:
            g = v - evals
            while first[t + 1] <= g:
                t += 1
            e = lst[g]
            el = ((pos[e] >> t) & 1) ^ 1
        out[vals + x] = gathers[pair_at[t] + (x & 3) * 2 * nq + 2 * slot[e] + el]
    nodes = vals + 4 * sec.values_cap
    for y in range(8 * hbase[T]):
        h = y >> 3
        t = 0
        while hbase[t + 1] <= h:
            t += 1
        g = first[t + 1] + h - hbase[t]
        d = t + 1
        while first[d + 1] <= g:
            d += 1
        out[nodes + y] = gathers[pair_at[t] + 8 * nq * (1 + d - t) + (y & 7) * nq + slot[lst[g]]]
    return out


@pytest.mark.parametrize("layout, kind", [("block9", "random"), ("2p24", "siblings"), ("tiny", "every_twice")])
def test_the_kernel_s_plan_equals_the_plain_version(layout, kind):
    n, T, nq = LAYOUTS[layout]
    nq = 2 << n if kind == "every_twice" else nq
    words = query_set(kind, n, nq, seed=7)
    sizes = sizes_of(n, T)
    gathers = synthetic_gathers(words, n, T)
    want = merkle_ops.order_openings_plain(gathers, words, sizes).numpy()
    assert np.array_equal(mirror_kernel(gathers.astype(np.int64), words, sizes), want)


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(st.integers(1, 9).flatmap(lambda n: st.tuples(
    st.just(n), st.integers(1, n), st.lists(st.integers(0, (1 << n) - 1), min_size=1, max_size=40))))
def test_the_kernel_s_plan_on_random_draws(case):
    """The mirror against the plain version over random draws (repeats, any
    order) at domains of 2^1 to 2^9 and 1 to n layers."""
    n, T, drawn = case
    words = np.array(drawn, np.uint32)
    sizes = sizes_of(n, T)
    gathers = synthetic_gathers(words, n, T)
    want = merkle_ops.order_openings_plain(gathers, words, sizes).numpy()
    assert np.array_equal(mirror_kernel(gathers.astype(np.int64), words, sizes), want)
    assert cut_row(want, sizes, words.size) == oracle(gathers, words, sizes)


# --- select_counts ---------------------------------------------------------------

def test_single_proofs_and_blocks_are_cut_from_ordered_rows():
    """A single proof and a block through `prove_many_sharded` (the one-device
    block pipeline) count as cut, none as planned; their bytes are a loop's."""
    fri.reset_select_counts()
    datas = [synthetic_data(64, k) for k in range(3)]
    single = api.commit_and_prove(datas[0], 5, SMALL, device="cpu")
    assert fri.select_counts() == {"cut": 1, "planned": 0}
    block = sharding.prove_many_sharded(datas, [5, 6, 7], SMALL, Mesh(1, 1, ["cpu"]))
    assert fri.select_counts() == {"cut": 4, "planned": 0}
    assert block[0][1].to_bytes() == single[1].to_bytes()


def test_a_committed_that_names_an_opening_class_is_planned_on_the_host():
    """The `opening_cls` route (a mesh row of several blocks; here set on a
    one-device `Committed`) counts as planned and gives the cut's bytes."""
    data = synthetic_data(64, 3)
    log_total = log_total_for(len(data))

    def committed():
        words = from_numpy_u32(pad_to_words(data, log_total), "cpu")
        return fri.commit_phase(words[None], log_total, [5], SMALL)[0]

    fri.reset_select_counts()
    cut = fri.finish_proof(committed(), log_total, SMALL)[1].to_bytes()
    c = committed()
    c.opening_cls = merkle.ShardedOpening
    planned = fri.finish_proof(c, log_total, SMALL)[1].to_bytes()
    assert planned == cut and fri.select_counts() == {"cut": 1, "planned": 1}
    fri.reset_select_counts()
    assert fri.select_counts() == {"cut": 0, "planned": 0}


# --- on a card -------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _batch(layout: str, B: int) -> tuple:
    n, T, nq = LAYOUTS[layout]
    kinds = ["random", "equal", "siblings"]
    words = np.stack([query_set(kinds[b % 3], n, nq, seed=10 + b) for b in range(B)])
    gathers = np.stack([synthetic_gathers(words[b], n, T, salt=b) for b in range(B)])
    return sizes_of(n, T), words, gathers


@pytest.mark.card
@pytest.mark.parametrize("layout", ["block9", "2p24"])
@pytest.mark.parametrize("B", [1, 4, 5, 9])
def test_the_kernel_equals_its_plain_version(card, layout, B):
    """B rows in one launch, into rows of a wider tensor, bit for bit; one
    proof's (1-D) form too."""
    sizes, words, gathers = _batch(layout, B)
    sec = merkle_ops.ordered_section(tuple(sizes), words.shape[1])
    want = narrow(merkle_ops.order_openings_plain(gathers, words, sizes))
    packed = torch.full((B, 5 + sec.words), -1, dtype=torch.int32, device=card)
    before = merkle_ops.order_openings.launches
    merkle_ops.order_openings(from_numpy_u32(gathers, card), from_numpy_u32(words, card), sizes, packed[:, 5:])
    assert merkle_ops.order_openings.launches == before + 1
    assert torch.equal(packed[:, 5:].cpu(), want) and (packed[:, :5] == -1).all()
    one = merkle_ops.order_openings(from_numpy_u32(gathers[-1], card), from_numpy_u32(words[-1], card), sizes)
    assert torch.equal(one.cpu(), want[-1])


@pytest.mark.card
def test_the_kernel_in_a_captured_graph(card):
    """Captured once, replayed over new words and gathers copied into its
    static inputs: each replay equals the plain version."""
    sizes, words, gathers = _batch("block9", 5)
    g_in, w_in = from_numpy_u32(gathers, card), from_numpy_u32(words, card)
    merkle_ops.order_openings(g_in, w_in, sizes)  # warm: the library and the attribute
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = merkle_ops.order_openings(g_in, w_in, sizes)
    for salt in (0, 1):
        words2 = np.roll(words, salt + 1, axis=1)
        gathers2 = np.stack([synthetic_gathers(words2[b], sizes[0], len(sizes), salt=b) for b in range(5)])
        g_in.copy_(from_numpy_u32(gathers2, card))
        w_in.copy_(from_numpy_u32(words2, card))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), narrow(merkle_ops.order_openings_plain(gathers2, words2, sizes)))
