"""Port's decommitment on the device side of the commit phase
(`ops.merkle.merkle_open_queries`, `order_openings`, `core/fri._packed_layout`)
and its host cut (`fri.finish_proof`), against the JAX package on the CPU:
the gathers alone against `fri._auth_sibling_nodes` and the pair gathers of
`_fri_commit_fn.run`; whole commit phases' gathers against the pair and auth
sections of `fri.dispatch_commit_phase_staged`'s packed vector at the
frozen cases' shapes, and their packed vectors' ordered decommitment against
the plain ordering of those gathers; proof wire bytes against `frieda_tpu`'s
and the frozen proofs, with duplicate raw queries and pow_bits 0; and
`finish_proof`'s one fetch and no launch. Inputs are seeded numpy arrays;
tolerance: exact equality."""

import pytest

pytest.importorskip("torch")

import json  # noqa: E402
import pathlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import synthetic_data  # noqa: E402
from frieda_tpu import api as japi  # noqa: E402
from frieda_tpu.config import PcsConfig as JPcsConfig  # noqa: E402
from frieda_tpu.core import fri as jfri  # noqa: E402
from frieda_tpu.core import merkle as jm  # noqa: E402
from frieda_tpu.utils.packing import pad_to_words as jpad_to_words  # noqa: E402
from frieda_tpu_torch import api, ops  # noqa: E402
from frieda_tpu_torch.config import PcsConfig  # noqa: E402
from frieda_tpu_torch.core import circle as tcircle  # noqa: E402
from frieda_tpu_torch.core import fft, fri  # noqa: E402
from frieda_tpu_torch.core import merkle as tm  # noqa: E402
from frieda_tpu_torch.ops import channel as channel_ops  # noqa: E402
from frieda_tpu_torch.ops import fri as fri_ops  # noqa: E402
from frieda_tpu_torch.ops import ingest as ingest_ops  # noqa: E402
from frieda_tpu_torch.ops import merkle as merkle_ops  # noqa: E402
from frieda_tpu_torch.utils import convert  # noqa: E402
from frieda_tpu_torch.utils import profiling  # noqa: E402
from frieda_tpu_torch.utils.convert import from_numpy_u32, narrow, to_numpy_u32  # noqa: E402
from frieda_tpu_torch.utils.packing import log_total_for, pad_to_words  # noqa: E402

torch.set_num_threads(1)

P = (1 << 31) - 1
CASES = {c["name"]: c for c in json.loads(
    (pathlib.Path(__file__).parent / "data" / "frozen_proofs.json").read_text())}
# Many draws from a small domain (duplicate raw queries) and no grinding:
# 64 bytes at log_blowup 1 is a domain of 2^6, 64 queries.
DUPLICATES = {"pow_bits": 0, "fri_config": {"log_blowup_factor": 1, "log_last_layer_degree_bound": 0,
                                            "n_queries": 64}}


def _layers(n: int, T: int, seed: int) -> tuple:
    """(numpy columns, port columns) of T layers of 2^n, 2^(n-1), ... leaves,
    as a proof's layers are sized."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, P, (4, 1 << (n - t)), dtype=np.uint32) for t in range(T)]
    return cols, [from_numpy_u32(c, "cpu") for c in cols]


def _port_tree(store: dict, log_n: int) -> tm.PrunedTree:
    """A port PrunedTree holding exactly the levels of a JAX pruned store."""
    offsets, off, flat = {}, 0, []
    for k in sorted(store):
        offsets[k] = (off, store[k].shape[1])
        off += store[k].size
        flat.append(store[k].reshape(-1))
    return tm.PrunedTree(log_n, from_numpy_u32(np.concatenate(flat), "cpu"), offsets)


def _jax_gathers(cols: np.ndarray, store: dict, log_leaves: int, pos: np.ndarray) -> np.ndarray:
    """One layer's section of the JAX package's packed vector: both elements
    of each query's pair (4, nq, 2), then `_auth_sibling_nodes` (8, nq) at
    every level (`frieda_tpu/core/fri.py:_fri_commit_fn.run`)."""
    p = jnp.asarray(pos.astype(np.uint32))
    base = p & ~jnp.uint32(1)
    jc = jnp.asarray(cols)
    pv = jnp.stack([jc[:, jfri._dbitrev(base, log_leaves)], jc[:, jfri._dbitrev(base | jnp.uint32(1), log_leaves)]],
                   axis=2)
    stored = {k: jnp.asarray(v) for k, v in store.items()}
    parts = [np.asarray(pv).reshape(-1)]
    parts += [np.asarray(jfri._auth_sibling_nodes(stored, jc, log_leaves, p, k)).reshape(-1)
              for k in range(log_leaves)]
    return np.concatenate(parts)


@pytest.mark.parametrize("n,T,nq,store", [(6, 3, 9, "port"), (6, 3, 9, "jax"), (3, 2, 20, "port")])
def test_open_queries_plain_matches_jax_gathers(n, T, nq, store):
    """`merkle_open_queries_plain` (and the wrapper on CPU tensors) over T
    layers and nq raw query words with duplicates, on the port's pruned
    trees or the JAX package's stores (level 0 stored), against the JAX
    gathers layer by layer; the output is `open_queries_words` long."""
    cols, tcols = _layers(n, T, 100 * n + nq)
    words = np.random.default_rng(nq).integers(0, 1 << n, nq, dtype=np.uint32)
    words[-1] = words[0]  # a repeated draw
    jstores = [{k: np.asarray(v) for k, v in jm.device_levels_pruned(jnp.asarray(c))} for c in cols]
    trees = [tm.build_pruned(c) for c in tcols] if store == "port" else \
        [_port_tree(s, n - t) for t, s in enumerate(jstores)]
    tw = from_numpy_u32(words, "cpu")
    got = to_numpy_u32(merkle_ops.merkle_open_queries_plain(tcols, trees, tw))
    assert got.size == merkle_ops.open_queries_words([n - t for t in range(T)], nq)
    assert np.array_equal(to_numpy_u32(merkle_ops.merkle_open_queries(tcols, trees, tw)), got)
    want = np.concatenate([_jax_gathers(cols[t], jstores[t], n - t, words.astype(np.int64) >> t)
                           for t in range(T)])
    assert np.array_equal(got, want)


def test_open_queries_checks_its_operands():
    """The wrapper refuses what its kernel could not read: no words, words of
    another dtype, a tree whose stored levels are not packed ascending, a
    level with no stored base, a wrong `out`."""
    _, tcols = _layers(7, 2, 1)
    trees = [tm.build_pruned(c) for c in tcols]
    words = from_numpy_u32(np.arange(5, dtype=np.uint32), "cpu")
    with pytest.raises(ValueError, match="no query words"):
        merkle_ops.merkle_open_queries(tcols, trees, words[:0])
    with pytest.raises(TypeError):
        merkle_ops.merkle_open_queries(tcols, trees, words.to(torch.int64))
    tree = trees[0]
    shifted = tm.PrunedTree(tree.log_leaves, tree.flat, {k: (o + 8, m) for k, (o, m) in tree.offsets.items()})
    with pytest.raises(ValueError):
        merkle_ops.merkle_open_queries(tcols, [shifted, trees[1]], words)
    gap = {k: v for k, v in tree.offsets.items() if k != 3}
    broken = tm.PrunedTree(tree.log_leaves, tree.flat, gap)
    with pytest.raises(ValueError):
        merkle_ops.merkle_open_queries(tcols, [broken, trees[1]], words)
    with pytest.raises(ValueError):
        merkle_ops.merkle_open_queries(tcols, trees, words, out=torch.empty(3, dtype=torch.int32))


# Every kernel wrapper the prover calls, by module and name.
DEVICE_STEPS = [(ingest_ops, "ingest"), (fft, "evaluate_auto"), (merkle_ops, "merkle_level"),
                (merkle_ops, "merkle_collapse"), (merkle_ops, "merkle_open"), (merkle_ops, "merkle_open_queries"),
                (merkle_ops, "order_openings"), (fri_ops, "fri_fold"), (channel_ops, "transcript"),
                (channel_ops, "grind")]


def refuse_device_steps(monkeypatch) -> None:
    """Patch every wrapper of `DEVICE_STEPS` to raise; each keeps its launch
    count for `ops.launch_counts`."""
    for module, name in DEVICE_STEPS:
        def refuse(*args, **kwargs):
            raise AssertionError("finish_proof called a device step")

        refuse.launches = getattr(getattr(module, name), "launches", 0)
        monkeypatch.setattr(module, name, refuse)


def _commit(case_cfg: dict, data: bytes, seed) -> tuple:
    cfg = PcsConfig.from_dict(case_cfg)
    log_total = log_total_for(len(data))
    words = from_numpy_u32(pad_to_words(data, log_total), "cpu")
    return fri.commit_phase(words[None], log_total, [seed], cfg)[0], cfg, log_total


@pytest.mark.parametrize("name", ["dryrun_960B", "mid_4096B_lastlayer2"])
def test_packed_sections_match_jax_dispatch(name):
    """The port's commit phase: the gathers of its raw query words over its
    layers and trees, each layer's pair section and each level's auth
    section (`open_queries_offsets`), equal the JAX package's packed vector
    (`dispatch_commit_phase_staged`) at its pair_off / auth_off, bit for
    bit, layer 0's pairs hold the JAX evaluations, and the packed vector
    after the head is those gathers' plain ordered decommitment."""
    case = CASES[name]
    data = synthetic_data(case["data_len"], case["data_seed_offset"])
    committed, cfg, log_total = _commit(case["config"], data, case["seed"])
    jcfg = JPcsConfig.from_dict(case["config"])
    packed, _, _, n, n_inner = jfri.dispatch_commit_phase_staged(
        jnp.asarray(jpad_to_words(data, log_total)), log_total, case["seed"], jcfg)
    nq = cfg.fri_config.n_queries
    bound = 1 << cfg.fri_config.log_last_layer_degree_bound
    off, jpair, jauth, total, sizes = jfri._packed_layout(n, n_inner, bound, nq)
    jvec = np.asarray(packed)
    assert jvec.size == total
    layout = committed.layout
    assert layout == fri._packed_layout(n, n_inner, bound, nq) and layout.sizes == sizes
    vec = to_numpy_u32(committed.packed)
    assert vec.size == layout.total
    raw = vec[slice(layout.head["qpos"][0], layout.head["qpos"][0] + nq)]
    gathers = merkle_ops.merkle_open_queries(committed.layers, committed.trees, from_numpy_u32(raw, "cpu"))
    got = to_numpy_u32(gathers)
    pair_off, auth_off = merkle_ops.open_queries_offsets(sizes, nq)
    for t, L in enumerate(sizes):
        assert np.array_equal(got[pair_off[t] : pair_off[t] + 8 * nq], jvec[jpair[t] : jpair[t] + 8 * nq]), t
        for k in range(L):
            assert np.array_equal(got[auth_off[t][k] : auth_off[t][k] + 8 * nq],
                                  jvec[jauth[t][k] : jauth[t][k] + 8 * nq]), (t, k)
    pairs = got[: 8 * nq].reshape(4, nq, 2)
    o, c = off["evalvals"]
    assert np.array_equal(pairs[:, np.arange(nq), raw & 1], jvec[o : o + c].reshape(4, nq))
    assert np.array_equal(vec[layout.head_words :],
                          to_numpy_u32(narrow(merkle_ops.order_openings_plain(gathers, raw, sizes))))


@pytest.mark.parametrize("name", sorted(CASES))
def test_finish_proof_fetches_once_and_launches_nothing(name, monkeypatch):
    """`finish_proof` after a commit phase: one device-to-host fetch (the
    packed vector), no kernel launch, no kernel wrapper called (each patched
    to raise); the wire bytes are the frozen proof's."""
    case = CASES[name]
    data = synthetic_data(case["data_len"], case["data_seed_offset"])
    committed, cfg, log_total = _commit(case["config"], data, case["seed"])
    fetched = []

    def counting(t):
        fetched.append(t.numel())
        return to_numpy_u32(t)

    monkeypatch.setattr(fri, "to_numpy_u32", counting)
    monkeypatch.setattr(convert, "to_numpy_u32", counting)
    refuse_device_steps(monkeypatch)
    before = ops.launch_counts()
    com, proof = fri.finish_proof(committed, log_total, cfg)
    assert fetched == [committed.layout.total] and ops.launch_counts() == before
    assert proof.to_bytes().hex() == case["wire_hex"] and com.hex() == case["commitment"]


def test_a_second_finish_gives_the_same_proof_without_a_fetch(monkeypatch):
    """Finishing one eager `Committed` twice: the second `finish_proof`
    fetches nothing and gives the same wire bytes."""
    case = CASES["dryrun_960B"]
    data = synthetic_data(case["data_len"], case["data_seed_offset"])
    committed, cfg, log_total = _commit(case["config"], data, case["seed"])
    first = fri.finish_proof(committed, log_total, cfg)[1].to_bytes()
    fetched = []
    monkeypatch.setattr(fri, "to_numpy_u32", lambda t: fetched.append(t) or to_numpy_u32(t))
    assert fri.finish_proof(committed, log_total, cfg)[1].to_bytes() == first == bytes.fromhex(case["wire_hex"])
    assert not fetched


def test_a_layout_without_gathers_is_the_head_alone():
    """The sharded commit phase's layout: the same head, no ordered
    decommitment, the vector ending after the query words."""
    full, head = fri._packed_layout(12, 8, 2, 7), fri._packed_layout(12, 8, 2, 7, gather=False)
    assert head.head == full.head and head.sizes == full.sizes
    assert head.order is None and head.total == head.head_words == full.head_words
    assert full.total == full.head_words + full.order.words


def test_duplicate_queries_and_no_grinding_match_jax():
    """64 raw queries over a 2^6 domain (many repeated draws, every layer
    touched) at pow_bits 0: the port's proof on the CPU equals the JAX
    package's wire bytes, and both verifiers accept it."""
    data = synthetic_data(64, 3)
    committed, cfg, log_total = _commit(DUPLICATES, data, 5)
    raw = committed.query_words
    assert len(set(raw.tolist())) < raw.size // 2  # mostly repeats
    com, proof = fri.finish_proof(committed, log_total, cfg)
    jcom, jproof = japi.commit_and_prove(data, 5, JPcsConfig.from_dict(DUPLICATES))
    assert com == jcom and proof.to_bytes() == jproof.to_bytes()
    assert api.verify(proof, 5) and japi.verify(jproof, 5)
    assert proof.to_bytes() == api.commit_and_prove(data, 5, cfg, device="cpu")[1].to_bytes()


def test_assembly_picks_the_first_draw_of_each_position():
    """The ordering reads each revealed value and node from the first raw
    draw under it: with every later duplicate's gathers overwritten, the
    decommitment ordered into the packed vector gives the same proof, and
    with a first draw's overwritten it does not."""
    data = synthetic_data(64, 3)
    committed, cfg, log_total = _commit(DUPLICATES, data, 5)
    want = fri.finish_proof(committed, log_total, cfg)[1].to_bytes()
    raw = committed.query_words
    layout = committed.layout
    nq = raw.size
    pair_off, auth_off = merkle_ops.open_queries_offsets(layout.sizes, nq)
    seen = {}
    later = [i for i, q in enumerate(raw.tolist()) if seen.setdefault(q, i) != i]
    assert later
    for slots, same in ((later, True), ([0], False)):
        c2, _, _ = _commit(DUPLICATES, data, 5)
        gathers = to_numpy_u32(merkle_ops.merkle_open_queries(c2.layers, c2.trees, from_numpy_u32(raw, "cpu")))
        at = np.array(slots)
        for t in range(len(layout.sizes)):
            for c in range(4):  # the (4, nq, 2) pairs
                for e in range(2):
                    gathers[pair_off[t] + 2 * nq * c + 2 * at + e] = 0x5A5A5A5A
            for b in auth_off[t]:  # the (8, nq) nodes
                for w in range(8):
                    gathers[b + w * nq + at] = 0x5A5A5A5A
        vec = to_numpy_u32(c2.packed).copy()
        vec[layout.head_words :] = to_numpy_u32(narrow(merkle_ops.order_openings_plain(gathers, raw, layout.sizes)))
        c2.batch = (fri.BatchFetch(from_numpy_u32(vec, "cpu")[None]), 0)
        got = fri.finish_proof(c2, log_total, cfg)[1].to_bytes()
        assert (got == want) == same


def test_packed_layout_sections_follow_the_jax_layout():
    """The port's head is the JAX package's up to its evaluations section (a
    two-word nonce); its gathers are the JAX pair and auth sections from
    their start (`open_queries_offsets`); the ordered decommitment that
    follows the head in the packed vector is no longer than those
    sections."""
    for n, n_inner, bound, nq in ((8, 5, 1, 8), (12, 7, 4, 12), (26, 22, 1, 20), (24, 20, 1, 64)):
        off, jpair, jauth, total, sizes = jfri._packed_layout(n, n_inner, bound, nq)
        layout = fri._packed_layout(n, n_inner, bound, nq)
        shift = jpair[0] - layout.head_words
        assert shift == 4 * nq - 1 and layout.total <= total - shift and layout.sizes == sizes
        pair_off, auth_off = merkle_ops.open_queries_offsets(sizes, nq)
        assert [p - jpair[0] for p in jpair] == pair_off
        assert [[a - jpair[0] for a in lv] for lv in jauth] == auth_off
        assert layout.total - layout.head_words == layout.order.words
        assert layout.head_words - layout.head["qpos"][0] == nq


def test_open_queries_bound_counts_each_read():
    """`profiling.merkle_open_queries_bound` on a small opening: bytes are
    the query words, the distinct entries read and the output; the
    operations are the distinct hashes that rebuilding each distinct node
    read needs, a hash shared by rebuilds (or reads) counted once, fewer
    than the oblivious reads' (leaf + 1) 2^depth - 1 each."""
    cols, tcols = _layers(6, 3, 9)
    trees = [tm.build_pruned(c) for c in tcols]
    words = np.array([5, 5, 63, 0, 4], np.uint32)
    compressions, read_bytes = merkle_ops.open_queries_work(trees, words)
    values, nodes = merkle_ops.query_reads(trees, words)
    assert len(nodes) == 5 * (6 + 5 + 4) and len(values) == 2 * 5 * 3

    def needed(t, k, s, out):  # the hashes that node (t, k, s) needs, down to stored levels
        if k not in trees[t].offsets:
            out.add((t, k, s))
            if k:
                needed(t, k - 1, 2 * s, out)
                needed(t, k - 1, 2 * s + 1, out)

    want = set()
    for t, k, s in nodes.tolist():
        needed(t, k, s, want)
    assert compressions == len(want)
    _, _, _, r, leaf, _ = merkle_ops.open_plan(trees, values, nodes)
    assert compressions < int(((leaf.astype(np.int64) + 1) << r).sum()) - r.size
    out_words = merkle_ops.open_queries_words([6, 5, 4], 5)
    got = profiling.merkle_open_queries_bound(5, out_words, read_bytes, compressions,
                                              card="NVIDIA H100 80GB HBM3")
    assert got == profiling.least_ms(20 + read_bytes + 4 * out_words, compressions * profiling.BLAKE2S_COMPRESS_INSTR,
                                     "NVIDIA H100 80GB HBM3")
    # every distinct column entry is 16 bytes and every stored node 32: no read is counted twice
    assert read_bytes % 16 == 0 and read_bytes < 16 * len(values) + 32 * int((1 << r).sum())


def test_natural_pairs_of_the_gathers():
    """The pair section of a layer holds, for each raw query, its value and
    its sibling's in stored order: columns at bitrev(pos & ~1) and
    bitrev(pos | 1)."""
    cols, tcols = _layers(5, 1, 4)
    trees = [tm.build_pruned(tcols[0])]
    words = np.array([3, 16, 31, 3], np.uint32)
    got = to_numpy_u32(merkle_ops.merkle_open_queries_plain(tcols, trees, words))[: 8 * 4].reshape(4, 4, 2)
    for i, q in enumerate(words.astype(np.int64)):
        for e in range(2):
            assert np.array_equal(got[:, i, e], cols[0][:, tcircle.bitrev_array(np.array([(q & ~1) | e]), 5)[0]])
