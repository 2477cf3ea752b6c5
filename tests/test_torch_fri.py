"""Port's prover modules, one by one, vs the JAX package on CPU: QM31 field
ops, twiddle inverses, one-block BLAKE2s, the host channel, the grind, the
pruned tree store and its every-third-level invariant, the decommitment's
reads (`merkle_open`: values and auth siblings, on the port's and the JAX
package's stores, and its checks), the multi-width collapse, the last-layer
interpolation and the witness planning. Inputs are seeded numpy arrays;
tolerance: exact equality (integer arithmetic)."""

import pytest

pytest.importorskip("torch")

import hashlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from frieda_tpu.core import channel as jch  # noqa: E402
from frieda_tpu.core import circle as jcircle  # noqa: E402
from frieda_tpu.core import field as jf  # noqa: E402
from frieda_tpu.core import fri as jfri  # noqa: E402
from frieda_tpu.core import grind as jgrind  # noqa: E402
from frieda_tpu.core import merkle as jm  # noqa: E402
from frieda_tpu.spec import field as sf  # noqa: E402
from frieda_tpu_torch.core import blake2s as tb  # noqa: E402
from frieda_tpu_torch.core import channel as tch  # noqa: E402
from frieda_tpu_torch.core import circle as tcircle  # noqa: E402
from frieda_tpu_torch.core import field as tf  # noqa: E402
from frieda_tpu_torch.core import fri as tfri  # noqa: E402
from frieda_tpu_torch.core import grind as tgrind  # noqa: E402
from frieda_tpu_torch.core import merkle as tm  # noqa: E402
from frieda_tpu_torch.ops import merkle as merkle_ops  # noqa: E402
from frieda_tpu_torch.utils.convert import from_numpy_u32, narrow, to_numpy_u32, widen  # noqa: E402

torch.set_num_threads(1)

P = sf.P
BOUNDARY = np.array([0, 1, 2, P - 1, P - 2, (1 << 30) - 1, 1 << 30, (1 << 30) + 1], np.uint32)


def _qm31_vectors(seed: int):
    """Two QM31 operand sets (4 coordinates each): random values plus every
    pair of boundary values in every coordinate."""
    rng = np.random.default_rng(seed)
    ga, gb = np.meshgrid(BOUNDARY, BOUNDARY)
    a = [np.concatenate([ga.ravel(), rng.integers(0, P, 200, dtype=np.uint32)]) for _ in range(4)]
    b = [np.concatenate([gb.ravel(), rng.integers(0, P, 200, dtype=np.uint32)]) for _ in range(4)]
    for i in range(1, 4):  # the boundary pairs in other coordinates too
        a[i][: ga.size] = np.roll(a[i][: ga.size], 7 * i)
    return a, b


def _t(xs):
    return tuple(widen(from_numpy_u32(x, "cpu")) for x in xs)


@pytest.mark.parametrize("op", ["qm31_add", "qm31_sub", "qm31_mul", "qm31_mul_m31", "cm31_mul"])
def test_qm31_ops_match_jax_and_spec(op):
    a, b = _qm31_vectors(len(op))
    k = 2 if op.startswith("cm31") else 4
    a, b = a[:k], b[:k]
    if op == "qm31_mul_m31":
        got = tf.qm31_mul_m31(_t(a), widen(from_numpy_u32(b[0], "cpu")))
        want = jf.qm31_mul_m31(tuple(map(jnp.asarray, a)), jnp.asarray(b[0]))
        spec = [sf.qm31_mul_m31(tuple(int(x[j]) for x in a), int(b[0][j])) for j in range(a[0].size)]
    else:
        got = getattr(tf, op)(_t(a), _t(b))
        want = getattr(jf, op)(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)))
        spec_fn = getattr(sf, op)
        spec = [spec_fn(tuple(int(x[j]) for x in a), tuple(int(y[j]) for y in b))
                for j in range(a[0].size)]
    got = np.stack([to_numpy_u32(g) for g in got])
    assert np.array_equal(got, np.stack([np.asarray(w) for w in want]))
    assert np.array_equal(got.T, np.array(spec, np.uint32))


def test_qm31_mul_by_constant_tuple_matches_tensor_form():
    """The folds multiply by alpha held as Python ints."""
    a, b = _qm31_vectors(5)
    alpha = tuple(int(x[250]) for x in a)
    got = tf.qm31_mul(alpha, _t(b))
    want = tf.qm31_mul(tuple(torch.full_like(x, v) for x, v in zip(_t(b), alpha)), _t(b))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_m31_neg_pow_inv_match_jax_and_spec():
    a = np.concatenate([BOUNDARY, np.random.default_rng(3).integers(0, P, 100, dtype=np.uint32)])
    t = widen(from_numpy_u32(a, "cpu"))
    ja = jnp.asarray(a)
    assert np.array_equal(to_numpy_u32(tf.m31_neg(t)), np.asarray(jf.m31_neg(ja)))
    for e in (0, 1, 5, 1 << 20, P - 2):
        assert np.array_equal(to_numpy_u32(tf.m31_pow(t, e)), np.asarray(jf.m31_pow(ja, e)))
    inv = to_numpy_u32(tf.m31_inv(t))
    assert np.array_equal(inv, np.asarray(jf.m31_inv(ja)))
    assert all(int(i) == (sf.m31_inv(int(x)) if x else 0) for x, i in zip(a, inv))


@pytest.mark.parametrize("n", [1, 2, 5, 13])
def test_twiddle_inverses_match_jax(n):
    got, want = tcircle.Twiddles(n), jcircle.Twiddles(n)
    assert np.array_equal(got.ys_inv, want.ys_inv)
    assert len(got.xs_layers_inv) == len(want.xs_layers_inv)
    for g, w in zip(got.xs_layers_inv, want.xs_layers_inv):
        assert np.array_equal(g, w)


def test_batch_inv_blocks_and_zero():
    a = np.random.default_rng(1).integers(0, P, 64 * 5, dtype=np.uint64)
    a[[0, 17, 300]] = 0
    got = tcircle.batch_inv(a)
    assert np.array_equal(got, jcircle._batch_inv(a))
    assert np.array_equal(tcircle.batch_inv(a[:7]), jcircle._batch_inv(a[:7]))


@pytest.mark.parametrize("length", [0, 1, 8, 32, 40, 55, 64])
def test_blake2s_hash_one_block_matches_hashlib(length):
    rng = np.random.default_rng(length)
    msgs = [rng.integers(0, 256, length, dtype=np.uint8).tobytes() for _ in range(3)]
    words = np.stack([np.frombuffer(m + bytes(64 - length), "<u4") for m in msgs], axis=1)
    out = tb.blake2s_hash_one_block(widen(from_numpy_u32(words, "cpu")), length)
    got = to_numpy_u32(out)
    for j, m in enumerate(msgs):
        assert got[:, j].astype("<u4").tobytes() == hashlib.blake2s(m).digest()


def test_channel_matches_jax_channel():
    a, b = tch.Blake2sChannel(), jch.Blake2sChannel()
    for c in (a, b):
        c.mix_u64(2**64 + 12345)
        c.mix_digest(bytes(range(32)))
        c.mix_felts([(1, 2, 3, 4), (P - 1, 0, 7, 1 << 30)])
    assert a.digest == b.digest
    assert [a.draw_felt() for _ in range(5)] == [b.draw_felt() for _ in range(5)]
    assert a.draw_random_bytes() == b.draw_random_bytes()
    assert a.trailing_zeros() == b.trailing_zeros()
    assert tch.sample_query_positions(a.clone(), 13, 40) == jch.sample_query_positions(b.clone(), 13, 40)
    a.digest = b.digest = b"\x00\x00\x00\x80" + bytes(28)
    assert a.trailing_zeros() == b.trailing_zeros() == 31


@pytest.mark.parametrize("pow_bits,batch", [(0, None), (3, 4), (9, 64), (12, 1024)])
def test_grind_matches_host_grind(pow_bits, batch):
    for seed in (1, 2):
        a, b = tch.Blake2sChannel(), jch.Blake2sChannel()
        a.mix_u64(seed)
        b.mix_u64(seed)
        want = jgrind.grind_host(b, pow_bits)
        assert tgrind.grind(a, pow_bits, "cpu", batch=batch) == want
        c = a.clone()
        c.mix_u64(want)
        assert c.trailing_zeros() >= pow_bits


def test_grind_mask_above_32_bits():
    """pow_bits > 32 tests the second word, as `grind.py:46-51` builds it."""
    w0 = torch.tensor([0, 0, 0, 1 << 31], dtype=torch.int64)
    w1 = torch.tensor([0, 2, 1, 0], dtype=torch.int64)
    assert tgrind._clears(w0, w1, 33).tolist() == [True, True, False, False]
    assert tgrind._clears(w0, w1, 32).tolist() == [True, True, True, False]


def _cols(log_n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed + log_n).integers(0, P, (4, 1 << log_n), dtype=np.uint32)


def _jax_store(cols: np.ndarray, monkeypatch, block=None) -> dict:
    """The JAX package's pruned store. With `block`, its BLOCK is set so low
    that its three-level grouping (taken when N % (8 * BLOCK) == 0, i.e. from
    N = 2^15 at the real BLOCK) shows at a small N."""
    from frieda_tpu.ops import merkle_pallas

    if block is not None:
        monkeypatch.setattr(merkle_pallas, "BLOCK", block)
    return {k: np.asarray(v) for k, v in jm.device_levels_pruned(jnp.asarray(cols))}


@pytest.mark.parametrize("log_n,collapse_max,jax_block", [
    (2, 4096, None), (3, 4096, None), (7, 4096, 4), (9, 2, None), (10, 8, 4)])
def test_pruned_store_matches_jax_and_keeps_every_third_level(log_n, collapse_max, jax_block,
                                                              monkeypatch):
    monkeypatch.setattr(merkle_ops, "COLLAPSE_MAX", collapse_max)
    cols = _cols(log_n)
    tree = tm.build_pruned(from_numpy_u32(cols, "cpu"))
    full = tm.levels(widen(from_numpy_u32(cols, "cpu")))
    jstore = _jax_store(cols, monkeypatch, jax_block)
    assert tree.log_leaves == log_n
    assert {k for k in range(3, log_n + 1, 3)} | {log_n} <= set(tree.offsets)
    assert set(tree.offsets) - set(jstore) <= ({0} if log_n < 3 else set())
    for k in tree.offsets:
        got = to_numpy_u32(tree.level(k))
        assert np.array_equal(got, to_numpy_u32(full[k]))
        if k in jstore:
            assert np.array_equal(got, jstore[k])
    assert np.array_equal(to_numpy_u32(tree.root), jstore[log_n])


def _tree_from_store(store: dict, log_n: int) -> tm.PrunedTree:
    """A port PrunedTree holding exactly the levels of a JAX pruned store."""
    offsets, off, flat = {}, 0, []
    for k in sorted(store):
        offsets[k] = (off, store[k].shape[1])
        off += store[k].size
        flat.append(store[k].reshape(-1))
    return tm.PrunedTree(log_n, from_numpy_u32(np.concatenate(flat), "cpu"), offsets)


# (log_n, store): the port's own pruned tree ("port", leaf level stored only
# below 8 leaves), or the JAX package's store read into a port tree, with its
# leaf level ("jax_leaf": BLOCK as it is) or without ("jax_no_leaf": BLOCK 1,
# so every N % 8 == 0 groups three levels from the leaves).
_OPEN_STORES = [(log_n, store) for log_n in (1, 2, 3, 5, 7, 9)
                for store in ("port", "jax_leaf", "jax_no_leaf") if log_n >= 3 or store != "jax_no_leaf"]


@pytest.mark.parametrize("log_n,store", _OPEN_STORES)
def test_opened_nodes_match_jax_auth_siblings(log_n, store, monkeypatch):
    """Every level's auth-path siblings of a set of queries and their values,
    read through `Opening` (one `merkle_open`: the wrapper on CPU tensors)
    and through `merkle_open_plain`, vs `fri._auth_sibling_nodes` over the
    JAX package's pruned store."""
    cols = _cols(log_n, 1)
    rng = np.random.default_rng(log_n)
    pos = rng.integers(0, 1 << log_n, 13, dtype=np.uint32)
    jstore = _jax_store(cols, monkeypatch, 1 if store == "jax_no_leaf" else None)
    assert (0 in jstore) == (store != "jax_no_leaf")
    tcols = from_numpy_u32(cols, "cpu")
    tree = tm.build_pruned(tcols) if store == "port" else _tree_from_store(jstore, log_n)
    opening = tm.Opening([tcols], [tree])
    slices = [opening.nodes(0, k, (pos.astype(np.int64) >> k) ^ 1) for k in range(log_n)]
    value_sl = opening.values(0, pos.astype(np.int64))
    values, nodes = opening.run()
    assert opening.open_calls == 1
    plain = to_numpy_u32(merkle_ops.merkle_open_plain([tcols], [tree], *opening.jobs()))
    assert np.array_equal(plain, np.concatenate([values.reshape(-1), nodes.reshape(-1)]))
    jstored = {k: jnp.asarray(v) for k, v in jstore.items()}
    for k, sl in enumerate(slices):
        want = np.asarray(jfri._auth_sibling_nodes(jstored, jnp.asarray(cols), log_n, jnp.asarray(pos), k))
        assert np.array_equal(nodes[:, sl], want), k
    nat = tcircle.bitrev_array(pos.astype(np.int64), log_n)
    assert np.array_equal(values[:, value_sl], cols[:, nat])


def _two_layers():
    layers = [from_numpy_u32(_cols(6, 2), "cpu"), from_numpy_u32(_cols(4, 3), "cpu")]
    return layers, [tm.build_pruned(c) for c in layers]


def test_opening_reads_across_layers_in_request_order():
    """Two layers with their own trees; requests interleave layers and
    rebuild depths, and answers come back in request order."""
    layers, trees = _two_layers()
    opening = tm.Opening(layers, trees)
    reqs = [(1, 2, [3, 0]), (0, 0, [5]), (0, 4, [1, 2, 3]), (1, 3, [1]), (0, 6, [0]), (1, 1, [7])]
    slices = [opening.nodes(t, k, np.array(s)) for t, k, s in reqs]
    vsl = opening.values(1, np.array([15, 0]))
    values, nodes = opening.run()
    assert opening.open_calls == 1
    full = [tm.levels(widen(c)) for c in layers]
    for (t, k, s), sl in zip(reqs, slices):
        L = trees[t].log_leaves
        want = to_numpy_u32(full[t][k])[:, tcircle.bitrev_array(np.array(s), L - k)]
        assert np.array_equal(nodes[:, sl], want), (t, k)
    assert np.array_equal(values[:, vsl], to_numpy_u32(layers[1])[:, tcircle.bitrev_array(np.array([15, 0]), 4)])


@pytest.mark.parametrize("reads", ["values", "nodes", "none"])
def test_opening_values_only_nodes_only_and_no_reads(reads):
    layers, trees = _two_layers()
    opening = tm.Opening(layers, trees)
    if reads == "values":
        opening.values(0, np.array([63, 0, 7]))
        opening.values(1, np.array([2]))
    if reads == "nodes":
        opening.nodes(1, 4, np.array([0]))
        opening.nodes(0, 1, np.array([31, 2]))
    values, nodes = opening.run()
    assert opening.open_calls == 1
    assert values.shape == (4, 4 if reads == "values" else 0)
    assert nodes.shape == (8, 3 if reads == "nodes" else 0)
    if reads == "values":
        want = [to_numpy_u32(layers[0])[:, tcircle.bitrev_array(np.array([63, 0, 7]), 6)],
                to_numpy_u32(layers[1])[:, [4]]]
        assert np.array_equal(values, np.concatenate(want, 1))
    if reads == "nodes":
        full = [tm.levels(widen(c)) for c in layers]
        assert np.array_equal(nodes[:, 0], to_numpy_u32(full[1][4])[:, 0])
        assert np.array_equal(nodes[:, 1:], to_numpy_u32(full[0][1])[:, tcircle.bitrev_array(np.array([31, 2]), 5)])


# Reads outside their layer (layers of 2^6 and 2^4 leaves): (values, nodes).
_BAD_READS = {
    "layer_negative": ([], [(-1, 0, 0)]),
    "layer_past_end": ([], [(2, 0, 0)]),
    "level_negative": ([], [(0, -1, 0)]),
    "level_past_root": ([], [(1, 5, 0)]),
    "node_past_width": ([], [(0, 2, 16)]),
    "node_negative": ([], [(1, 1, -1)]),
    "root_index_1": ([], [(0, 6, 1)]),
    "value_past_width": ([(1, 16)], []),
    "value_layer_past_end": ([(2, 0)], []),
}


@pytest.mark.parametrize("case", sorted(_BAD_READS))
def test_merkle_open_rejects_reads_outside_their_layer(case):
    layers, trees = _two_layers()
    values, nodes = _BAD_READS[case]
    values = np.array(values, np.int64).reshape(-1, 2)
    nodes = np.array(nodes, np.int64).reshape(-1, 3)
    for fn in (merkle_ops.merkle_open, merkle_ops.merkle_open_plain, merkle_ops.open_table):
        with pytest.raises(ValueError, match="outside its layer"):
            fn(layers, trees, values, nodes)


def test_merkle_open_raises_on_a_missing_base_level():
    """Every multiple-of-3 level is stored; a tree without one is a bug."""
    layers, trees = _two_layers()
    tree = trees[0]
    broken = tm.PrunedTree(tree.log_leaves, tree.flat, {k: v for k, v in tree.offsets.items() if k != 3})
    with pytest.raises(AssertionError, match="no stored base"):
        merkle_ops.merkle_open(layers[:1], [broken], np.zeros((0, 2)), np.array([[0, 4, 1]]))
    assert merkle_ops.merkle_open(layers[:1], [broken], np.zeros((0, 2)), np.array([[0, 2, 1]])).shape == (8,)


@pytest.mark.parametrize("log_m", [0, 1, 3, 6, 9, 12])
def test_collapse_plain_out_widths_match_full_build(log_m):
    level = np.random.default_rng(log_m).integers(0, 1 << 32, (8, 1 << log_m), dtype=np.uint64)
    level = widen(from_numpy_u32(level.astype(np.uint32), "cpu"))
    full = [level]
    while full[-1].shape[1] > 1:
        full.append(tm.hash_parents(full[-1]))
    widths = tm.tail_widths(1 << log_m) if log_m else (1,)
    if log_m == 6:
        widths = (64, 8, 4, 1)  # the echoed input width and a non-tail width
    got = merkle_ops.merkle_collapse_plain(level, widths)
    assert [g.shape[1] for g in got] == list(widths)
    for g, w in zip(got, widths):
        assert torch.equal(g, full[log_m - (w.bit_length() - 1)])
    wrapped = merkle_ops.merkle_collapse(narrow(level), widths)
    assert all(torch.equal(widen(a), b) for a, b in zip(wrapped, got))
    with pytest.raises(ValueError):
        merkle_ops.merkle_collapse_plain(level, (1, 2) if log_m else (2,))


@pytest.mark.parametrize("log_m,depth,n", [(0, 3, 8), (2, 1, 8), (4, 5, 12)])
def test_device_ifft_line_matches_jax(log_m, depth, n):
    xs_invs = jcircle.get_twiddles(n).xs_layers_inv
    vals = np.random.default_rng(log_m).integers(0, P, (4, 1 << log_m), dtype=np.uint32)
    want = jfri._device_ifft_line(tuple(jnp.asarray(v) for v in vals),
                                  tuple(jnp.asarray(x) for x in xs_invs), depth)
    tx = [torch.from_numpy(x.astype(np.int64)) for x in tcircle.get_twiddles(n).xs_layers_inv]
    got = tfri._device_ifft_line(from_numpy_u32(vals, "cpu"), tx, depth)
    assert np.array_equal(to_numpy_u32(got), np.asarray(want))


def test_folds_match_spec():
    """fold_c / fold_l against the spec field, one element at a time."""
    n = 6
    ys_inv, xs_invs = tfri.fold_tables(n, "cpu")
    evals = _cols(n, 4)
    alpha = (5, P - 1, 1 << 30, 12345)
    g = tfri.fold_c(from_numpy_u32(evals, "cpu"), alpha, ys_inv)
    g2 = tfri.fold_l(g, alpha, xs_invs[0])
    half = 1 << (n - 1)

    def fold(lo, hi, inv):
        f1 = sf.qm31_mul_m31(sf.qm31_sub(lo, hi), inv)
        return sf.qm31_add(sf.qm31_add(lo, hi), sf.qm31_mul(alpha, f1))

    col = lambda a, j: tuple(int(a[i, j]) for i in range(4))  # noqa: E731
    want = [fold(col(evals, j), col(evals, j + half), int(ys_inv[j])) for j in range(half)]
    got = to_numpy_u32(g)
    assert [col(got, j) for j in range(half)] == want
    want2 = [fold(col(got, j), col(got, j + half // 2), int(xs_invs[0][j])) for j in range(half // 2)]
    got2 = to_numpy_u32(g2)
    assert [col(got2, j) for j in range(half // 2)] == want2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_witness_planning_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pos = sorted(set(int(p) for p in rng.integers(0, 256, 30)))
    assert list(tfri._pair_groups(pos)) == list(jfri._pair_groups(pos))
    leaves = tfri._all_leaf_indices(pos)
    assert leaves == jfri._all_leaf_indices(pos)
    assert tfri._merkle_witness_plans(8, leaves) == jfri._merkle_witness_plans(8, leaves)
