"""Port's decommitment inside the sharded commit phase: the sharded form of
`ops.merkle.merkle_open_queries` over a mesh row whose shards all lie in one
block (`core/fri.commit_phase_sharded`), on meshes of CPU devices
(`devices=["cpu"] * S`: every kernel's plain version). The sharded plain
gathers against the single-device plain gathers over the whole row, and a
Python mirror of the kernel's sharded address mapping, lane by lane, against
both; the sharded packed vector against the single-device one word for word,
and the sharded gathers against the pair and auth sections of the JAX
package's mesh `_fri_commit_fn` on its virtual 8-device CPU mesh, the packed
vector's ordered decommitment against their plain ordering; the sharded
`finish_proof`'s one fetch and no device step; the rows that keep
`merkle.ShardedOpening` (rows of several blocks) and its bytes; the
wrapper's checks. Inputs are seeded; tolerance: exact equality."""

import pytest

pytest.importorskip("torch")

import functools  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import synthetic_data  # noqa: E402
from test_torch_decommit import refuse_device_steps  # noqa: E402
from frieda_tpu.config import PcsConfig as JPcsConfig  # noqa: E402
from frieda_tpu.core import fri as jfri  # noqa: E402
from frieda_tpu.parallel import sharding as jsharding  # noqa: E402
from frieda_tpu_torch import ops  # noqa: E402
from frieda_tpu_torch.config import FriConfig, PcsConfig  # noqa: E402
from frieda_tpu_torch.core import fri, merkle  # noqa: E402
from frieda_tpu_torch.core import merkle as tm  # noqa: E402
from frieda_tpu_torch.core.blake2s import compress_rows  # noqa: E402
from frieda_tpu_torch.ops import merkle as merkle_ops  # noqa: E402
from frieda_tpu_torch.parallel import sharding  # noqa: E402
from frieda_tpu_torch.parallel.mesh import Mesh, Sharded  # noqa: E402
from frieda_tpu_torch.utils import convert  # noqa: E402
from frieda_tpu_torch.utils.convert import from_numpy_u32, narrow, to_numpy_u32, widen  # noqa: E402
from frieda_tpu_torch.utils.packing import log_total_for, pad_to_words  # noqa: E402

torch.set_num_threads(1)

CASES = {c["name"]: c for c in json.loads(
    (pathlib.Path(__file__).parent / "data" / "frozen_proofs.json").read_text())}
DATA = synthetic_data(960, 5)  # 2^6 felts a column: a 2^7 or 2^8 domain


def _mesh(n_data: int, n_elem: int) -> Mesh:
    return sharding.make_mesh(n_data, n_elem, devices=["cpu"] * (n_data * n_elem))


def _words(data: bytes) -> tuple:
    log_total = log_total_for(len(data))
    return from_numpy_u32(pad_to_words(data, log_total), "cpu"), log_total


@functools.lru_cache(maxsize=None)
def _sharded_commit(S: int, log_blowup: int) -> fri.Committed:
    """The sharded commit phase of DATA over a (1, S) mesh, 8 queries."""
    words, log_total = _words(DATA)
    cfg = PcsConfig(pow_bits=2, fri_config=FriConfig(log_blowup, 0, 8))
    return fri.commit_phase_sharded(words, log_total, 3, cfg, _mesh(1, S), 0)


def _repeated_words(c: fri.Committed) -> np.ndarray:
    """The commit phase's raw query words, with draws repeated."""
    o, nq = c.layout.head["qpos"]
    words = to_numpy_u32(c.packed[o : o + nq]).copy()
    words[nq // 2 :] = words[: nq - nq // 2]
    return words


def _brev(x: int, bits: int) -> int:
    """`bitrev` of csrc/merkle.cu: __brev(x) >> (32 - bits), and 0 for bits 0."""
    return int(f"{x:032b}"[::-1], 2) >> (32 - bits) if bits else 0


def _open_query_quads(columns, trees, words: np.ndarray) -> torch.Tensor:
    """Mirror of `merkle_open_queries_kernel`, lane by lane over the whole
    grid (128 threads a block), from the layer descriptors alone
    (`open_queries_layers`: pointers, log_leaves, stored masks, log2 S): a
    tensor is found by its address, as the kernel finds it. A read at level
    k of a sharded layer, stored index s: natural x = bitrev(s, L - k); a
    level at least S wide is read from shard x mod S, its part and tree at
    x mod S rows from shard 0's (a row's words summed from the mask), at
    local stored index bitrev(x >> log2 S, L - log2 S - k); a narrower one
    is the top tree's level k - (L - log2 S) at s, all levels stored. Then
    the single-device body (pairs, stored gathers, rebuilds, two exchange
    rounds)."""
    layers, ls = merkle_ops.open_queries_layers(columns, trees)
    by_ptr = {}
    for x, tree in zip(columns, trees):
        if isinstance(tree, tm.ShardedTree):
            by_ptr.update({p.data_ptr(): widen(p).reshape(-1) for p in x.parts.values()})
            by_ptr.update({sh.flat.data_ptr(): widen(sh.flat) for sh in tree.shards.values()})
            if tree.top is not None:
                by_ptr[tree.top.flat.data_ptr()] = widen(tree.top.flat)
        else:
            by_ptr[x.data_ptr()] = widen(x).reshape(-1)
            by_ptr[tree.flat.data_ptr()] = widen(tree.flat)
    nq, Ls = len(words), [layer.log_leaves for layer in layers]
    n_reads = sum(nq * (2 + L) for L in Ls)
    lanes = np.arange(-(-4 * n_reads // 128) * 128)
    out = torch.full((merkle_ops.open_queries_words(Ls, nq),), -1, dtype=torch.int64)
    h = torch.zeros((8, lanes.size), dtype=torch.int64)
    r = np.zeros(lanes.size, np.int64)
    leaf_lanes, leaf_cols, targets = [], [], {}
    for lane in lanes:
        g, u = lane >> 2, lane & 3
        j, t, dst = min(g, n_reads - 1), 0, 0
        while t + 1 < len(layers) and j >= nq * (2 + Ls[t]):
            j, dst, t = j - nq * (2 + Ls[t]), dst + 8 * nq * (1 + Ls[t]), t + 1
        layer = layers[t]
        L, stored = layer.log_leaves, layer.stored
        cols, flat = layer.cols.data_ptr(), layer.flat.data_ptr()
        pair = j < 2 * nq
        k = 0 if pair else (j - 2 * nq) // nq
        qi = j >> 1 if pair else (j - 2 * nq) % nq
        pos = (int(words[qi]) >> t) & ((1 << L) - 1)
        s = (pos & ~1) | (j & 1) if pair else (pos >> k) ^ 1
        kl = k
        if layer.top is not None:
            if L - k >= ls:
                x, local = _brev(s, L - k), L - ls
                row = sum(8 << (local - b) for b in range(32) if stored >> b & 1)
                cols += 4 * (x & ((1 << ls) - 1)) * (4 << local)  # bytes
                flat += 4 * (x & ((1 << ls) - 1)) * row
                s, L = _brev(x >> ls, local - k), local
            else:
                flat, kl, L, stored = layer.top.data_ptr(), k - (L - ls), ls, (2 << ls) - 1
        if pair:
            if g < n_reads:
                out[dst + u * 2 * nq + j] = by_ptr[cols][(u << L) + _brev(s, L)]
            continue
        base = kl if stored >> kl & 1 else 3 * (kl // 3)
        r[lane] = kl - base
        child = (s << int(r[lane])) | (u & ((1 << int(r[lane])) - 1))
        if stored >> base & 1:
            off = sum(8 << (L - b) for b in range(base) if stored >> b & 1)
            h[:, lane] = by_ptr[flat][off + (torch.arange(8) << (L - base)) + _brev(child, L - base)]
        else:
            leaf_lanes.append(lane)
            leaf_cols.append(by_ptr[cols][(torch.arange(4) << L) + _brev(child, L)])
        if g < n_reads:
            targets[lane] = dst + 8 * nq * (1 + k) + qi
    if leaf_lanes:
        h[:, leaf_lanes] = tm.hash_leaves(torch.stack(leaf_cols, 1))
    for rnd in range(2):
        other = h[:, lanes ^ (1 << rnd)]
        right = torch.from_numpy((lanes >> rnd) & 1 == 1)
        parent = compress_rows(torch.cat([torch.where(right, other, h), torch.where(right, h, other)]))
        h = torch.where(torch.from_numpy(rnd < r), parent, h)
    for lane, at in targets.items():
        for w in range(8):
            if w // 2 == lane & 3:
                out[at + w * nq] = h[w, lane]
    return out


@pytest.mark.parametrize("S,log_blowup", [(2, 1), (4, 2), (8, 1), (16, 2)])
def test_sharded_gathers_match_the_whole_row(S, log_blowup):
    """The sharded commit phase's layers (sharded down to width 2S, then
    replicated) over its raw query words and a copy with repeated words:
    the sharded plain gathers (and the wrapper on CPU tensors) equal the
    single-device plain gathers over the whole row (each sharded layer
    gathered into natural order, its tree built on one device), and the
    kernel mirror equals both."""
    c = _sharded_commit(S, log_blowup)
    sharded = [isinstance(x, Sharded) for x in c.layers]
    assert any(sharded) and (S < 8 or not all(sharded))  # layers narrower than 2S are replicated
    whole = [x.gather() if isinstance(x, Sharded) else x for x in c.layers]
    trees = [tm.build_pruned(x) for x in whole]
    o, nq = c.layout.head["qpos"]
    for words in (to_numpy_u32(c.packed[o : o + nq]), _repeated_words(c)):
        got = merkle_ops.merkle_open_queries_plain(c.layers, c.trees, words)
        assert torch.equal(got, merkle_ops.merkle_open_queries_plain(whole, trees, words))
        assert torch.equal(widen(merkle_ops.merkle_open_queries(c.layers, c.trees, from_numpy_u32(words, "cpu"))),
                           got)
        assert torch.equal(_open_query_quads(c.layers, c.trees, words), got)


def test_whole_tree_reassembles_the_levels():
    """`whole_tree` of a sharded layer: every level it holds equals the
    single-device full tree's level (natural order), the shards' stored
    levels and every level of the top tree."""
    c = _sharded_commit(4, 2)
    x, tree = c.layers[0], c.trees[0]
    full = tm.levels(widen(x.gather()))
    whole = merkle_ops.whole_tree(tree)
    L = tree.log_leaves
    assert set(whole.offsets) == set(tree.shards[0].offsets) | set(range(L - 2, L + 1))
    for k in whole.offsets:
        assert torch.equal(widen(whole.level(k)), full[k]), k


def _prove(data: bytes, seed, cfg: PcsConfig, mesh=None, row: int = 0) -> fri.Committed:
    words, log_total = _words(data)
    if mesh is None:
        return fri.commit_phase(words[None], log_total, [seed], cfg)[0]
    return fri.commit_phase_sharded(words, log_total, seed, cfg, mesh, row)


@functools.lru_cache(maxsize=None)
def _single_packed(name: str) -> np.ndarray:
    case = CASES[name]
    data = synthetic_data(case["data_len"], case["data_seed_offset"])
    return to_numpy_u32(_prove(data, case["seed"], PcsConfig.from_dict(case["config"])).packed)


@pytest.mark.parametrize("name", ["dryrun_960B", "mid_4096B_lastlayer2"])
@pytest.mark.parametrize("mesh_shape,row", [((1, 8), 0), ((2, 4), 1)])
def test_sharded_packed_equals_single_device(name, mesh_shape, row):
    """The sharded commit phase packs what one device's does, word for
    word: the head and every pair and auth section, at one layout."""
    case = CASES[name]
    data = synthetic_data(case["data_len"], case["data_seed_offset"])
    cfg = PcsConfig.from_dict(case["config"])
    c = _prove(data, case["seed"], cfg, _mesh(*mesh_shape), row)
    nq, bound = cfg.fri_config.n_queries, 1 << cfg.fri_config.log_last_layer_degree_bound
    n = log_total_for(len(data)) - 2 + cfg.fri_config.log_blowup_factor
    assert c.opening_cls is None and c.layout == fri._packed_layout(n, len(c.layers) - 1, bound, nq)
    assert np.array_equal(to_numpy_u32(c.packed), _single_packed(name))


def test_sharded_finish_fetches_once_and_calls_no_device_step(monkeypatch):
    """`finish_proof` after the sharded commit phase: one device-to-host
    fetch (the packed vector), no kernel launch and no kernel wrapper
    (`merkle_open` included) called; the wire bytes are the frozen proof's."""
    case = CASES["dryrun_960B"]
    data = synthetic_data(case["data_len"], case["data_seed_offset"])
    cfg = PcsConfig.from_dict(case["config"])
    c = _prove(data, case["seed"], cfg, _mesh(1, 8))
    fetched = []

    def counting(t):
        fetched.append(t.numel())
        return to_numpy_u32(t)

    monkeypatch.setattr(fri, "to_numpy_u32", counting)
    monkeypatch.setattr(convert, "to_numpy_u32", counting)
    refuse_device_steps(monkeypatch)
    before = ops.launch_counts()
    com, proof = fri.finish_proof(c, log_total_for(len(data)), cfg)
    assert fetched == [c.layout.total] and ops.launch_counts() == before
    assert proof.to_bytes().hex() == case["wire_hex"] and com.hex() == case["commitment"]


def test_sharded_opening_keeps_its_bytes(monkeypatch):
    """`merkle.ShardedOpening` after the fetch gives the same proof bytes:
    set on a one-block row's `Committed` (its gathers then unread; one
    `merkle_open` for its one device), and as the decommitment of a row of
    several blocks (its shards on devices that differ: "cpu" and "cpu:0"),
    whose commit phase packs the head alone."""
    case = CASES["dryrun_960B"]
    data = synthetic_data(case["data_len"], case["data_seed_offset"])
    cfg = PcsConfig.from_dict(case["config"])
    log_total = log_total_for(len(data))
    opens, merkle_open = [], merkle_ops.merkle_open

    def counted_open(*args):
        opens.append(len(args[0]))
        return merkle_open(*args)

    monkeypatch.setattr(merkle_ops, "merkle_open", counted_open)
    c = _prove(data, case["seed"], cfg, _mesh(1, 8))
    c.opening_cls = merkle.ShardedOpening
    assert fri.finish_proof(c, log_total, cfg)[1].to_bytes().hex() == case["wire_hex"]
    assert len(opens) == 1
    split = sharding.make_mesh(1, 8, devices=["cpu", "cpu:0"] * 4)
    assert len(split.blocks(0)) == 8
    c = _prove(data, case["seed"], cfg, split)
    assert c.opening_cls is merkle.ShardedOpening and c.layout.order is None
    assert c.layout.total == c.layout.head_words
    assert fri.finish_proof(c, log_total, cfg)[1].to_bytes().hex() == case["wire_hex"]
    assert len(opens) == 3  # one a device


def test_sharded_sections_match_jax_mesh_commit():
    """The sharded commit phase's gathers equal the pair and auth sections of
    the JAX package's mesh `_fri_commit_fn` (`_dispatch_commit_phase(mesh=
    ...)` on its virtual 8-device CPU mesh, tests/conftest.py), at the
    tiny_64B_default proof's shape: a 2^7 domain over 8 shards, every
    layer sharded and read from its shards and its top tree; its packed
    vector after the head is their plain ordered decommitment."""
    case = CASES["tiny_64B_default"]
    data = synthetic_data(case["data_len"], case["data_seed_offset"])
    c = _prove(data, case["seed"], PcsConfig.from_dict(case["config"]), _mesh(1, 8))
    assert all(isinstance(x, Sharded) for x in c.layers)
    packed, _, _, n, n_inner = jfri._dispatch_commit_phase(
        data, case["seed"], JPcsConfig.from_dict(case["config"]), mesh=jsharding.make_mesh(1, 8))
    _, jpair, jauth, total, sizes = jfri._packed_layout(n, n_inner, 1, c.n_queries)
    jvec, vec, nq = np.asarray(packed), to_numpy_u32(c.packed), c.n_queries
    assert jvec.size == total and c.layout.sizes == sizes
    raw = vec[c.layout.head["qpos"][0] : c.layout.head_words]
    gathers = to_numpy_u32(merkle_ops.merkle_open_queries(c.layers, c.trees, from_numpy_u32(raw, "cpu")))
    pair_off, auth_off = merkle_ops.open_queries_offsets(sizes, nq)
    for t, L in enumerate(sizes):
        at = pair_off[t]
        assert np.array_equal(gathers[at : at + 8 * nq], jvec[jpair[t] : jpair[t] + 8 * nq]), t
        for k in range(L):
            at = auth_off[t][k]
            assert np.array_equal(gathers[at : at + 8 * nq], jvec[jauth[t][k] : jauth[t][k] + 8 * nq]), (t, k)
    assert np.array_equal(vec[c.layout.head_words :],
                          to_numpy_u32(narrow(merkle_ops.order_openings_plain(gathers, raw, sizes))))


def _block_sharded(mesh: Mesh, block: torch.Tensor) -> Sharded:
    return Sharded(mesh, 0, [(0, block)])


def test_wrapper_refuses_parts_that_are_not_rows_of_one_tensor():
    """The wrapper finds shard e's part and tree at e rows from shard 0's:
    parts or trees that are not the rows of one tensor in shard order, a
    shard not held, a top tree missing a level and two shard counts in one
    call raise ValueError; the rows of one block pass."""
    c = _sharded_commit(4, 2)
    x, tree = c.layers[0], c.trees[0]
    words = from_numpy_u32(np.arange(5, dtype=np.uint32), "cpu")
    block = x.whole()
    merkle_ops.merkle_open_queries([x], [tree], words)  # one block: accepted
    backwards = Sharded(x.mesh, 0, [(e, block[3 - e : 4 - e]) for e in range(4)])
    spread = _block_sharded(x.mesh, torch.stack([block, block], 1)[:, 0])  # a row apart
    apart = Sharded(x.mesh, 0, [(e, block[e : e + 1].clone()) for e in range(4)])
    for bad in (backwards, spread, apart):
        with pytest.raises(ValueError, match="rows of one tensor"):
            merkle_ops.merkle_open_queries([bad], [tree], words)
    shards = dict(tree.shards)
    shards[1] = tm.PrunedTree(shards[1].log_leaves, shards[1].flat.clone(), shards[1].offsets)
    with pytest.raises(ValueError, match="rows of one tensor"):
        merkle_ops.merkle_open_queries([x], [tm.ShardedTree(tree.log_leaves, shards, tree.top, tree.root)], words)
    part = Sharded(x.mesh, 0, [(0, block[:2])])
    with pytest.raises(ValueError, match="not all held"):
        merkle_ops.merkle_open_queries([part], [tree], words)
    top = tree.top
    cut = top.offsets[1][0]
    gap = tm.PrunedTree(top.log_leaves, top.flat[cut:], {k: (o - cut, m) for k, (o, m) in top.offsets.items() if k})
    with pytest.raises(ValueError, match="every level"):
        merkle_ops.merkle_open_queries([x], [tm.ShardedTree(tree.log_leaves, tree.shards, gap, tree.root)], words)
    c8 = _sharded_commit(8, 1)
    with pytest.raises(ValueError, match="one row"):
        merkle_ops.merkle_open_queries([x, c8.layers[0]], [tree, c8.trees[0]], words)


def test_open_queries_work_counts_the_sharded_form():
    """`open_queries_work` of a sharded layer is that of its `whole_tree`:
    the top tree's levels are all stored, so its nodes need no rebuild, and
    it counts fewer hashes than the single device's tree, which stores only
    every third of those levels."""
    c = _sharded_commit(16, 2)
    words = _repeated_words(c)
    got = merkle_ops.open_queries_work(c.trees, words)
    whole = [merkle_ops.whole_tree(t) if isinstance(t, tm.ShardedTree) else t for t in c.trees]
    assert got == merkle_ops.open_queries_work(whole, words)
    single = [tm.build_pruned(x.gather() if isinstance(x, Sharded) else x) for x in c.layers]
    assert got[0] < merkle_ops.open_queries_work(single, words)[0]
