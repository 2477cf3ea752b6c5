"""Port's Merkle root (plain full build, and the GPU level/collapse split
run through the plain versions on CPU) vs the JAX package and the numpy
spec compression, and Python mirrors of the collapse's cluster split and of
`merkle_open`'s quads vs the plain versions. Tolerance: exact equality."""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from frieda_tpu.core import merkle as jm  # noqa: E402
from frieda_tpu.spec import blake2s as sb  # noqa: E402
from frieda_tpu_torch.core import merkle as tm  # noqa: E402
from frieda_tpu_torch.core.blake2s import compress_rows  # noqa: E402
from frieda_tpu_torch.ops import merkle as merkle_ops  # noqa: E402
from frieda_tpu_torch.utils.convert import from_numpy_u32, narrow, to_numpy_u32, widen  # noqa: E402

torch.set_num_threads(1)

P = (1 << 31) - 1


def _cols(log_w: int) -> np.ndarray:
    return np.random.default_rng(log_w).integers(0, P, (4, 1 << log_w), dtype=np.uint32)


def _numpy_levels(cols: np.ndarray) -> list:
    """Every level, natural halves pairing, with the numpy spec compression."""
    msg = np.zeros((16, cols.shape[1]), np.uint32)
    msg[:4] = cols
    level = sb.compress_batch(msg)
    out = [level]
    while level.shape[1] > 1:
        half = level.shape[1] // 2
        level = sb.compress_batch(np.ascontiguousarray(
            np.concatenate([level[:, :half], level[:, half:]], axis=0)))
        out.append(level)
    return out


@pytest.mark.parametrize("log_w", range(1, 16))
def test_root_level_matches_numpy_levels(log_w):
    cols = _cols(log_w)
    expect = _numpy_levels(cols)
    t = from_numpy_u32(cols, "cpu")
    plain = tm.levels(widen(t))
    assert len(plain) == len(expect)
    for got, want in zip(plain, expect):
        assert np.array_equal(to_numpy_u32(got), want)
    assert np.array_equal(to_numpy_u32(tm.root_level(t)), expect[-1])


@pytest.mark.parametrize("log_w", range(1, 16))
def test_root_level_matches_jax_device_levels(log_w):
    cols = _cols(log_w)
    jax_levels = jax.jit(lambda c: jm.device_levels(c, cutoff_log=0))(jnp.asarray(cols))
    t = from_numpy_u32(cols, "cpu")
    assert np.array_equal(to_numpy_u32(tm.root_level(t)), np.asarray(jax_levels[-1]))
    for got, want in zip(tm.levels(widen(t)), jax_levels):
        assert np.array_equal(to_numpy_u32(got), np.asarray(want))


@pytest.mark.parametrize("leaf,fused", [(True, False), (True, True), (False, False), (False, True)])
def test_merkle_level_modes_match_full_build(leaf, fused):
    """Each kernel mode's plain version is the matching level of the full
    build: leaf -> level 0, fused leaf -> level 3, inner -> +1, fused -> +3."""
    cols = _cols(10)
    full = _numpy_levels(cols)
    x = from_numpy_u32(cols if leaf else full[2], "cpu")
    want = full[(0 if leaf else 2) + (3 if fused else (0 if leaf else 1))]
    assert np.array_equal(to_numpy_u32(merkle_ops.merkle_level(x, leaf, fused)), want)


def test_level_collapse_split_emulated(monkeypatch):
    """The GPU split with a tiny collapse bound: fused inner passes run down
    to the bound (the 1-level form where the width is not divisible by 8),
    then the collapse. Every step goes through a wrapper's plain version."""
    monkeypatch.setattr(merkle_ops, "COLLAPSE_MAX", 2)
    calls = []
    real_level = merkle_ops.merkle_level

    def spy(x, leaf, fused):
        calls.append((x.shape[1], leaf, fused))
        return real_level(x, leaf, fused)

    monkeypatch.setattr(merkle_ops, "merkle_level", spy)
    cols = _cols(14)
    got = tm.root_level(from_numpy_u32(cols, "cpu"))
    assert calls == [(1 << 14, True, True), (1 << 11, False, True),
                     (1 << 8, False, True), (1 << 5, False, True), (4, False, False)]
    assert np.array_equal(to_numpy_u32(got), _numpy_levels(cols)[-1])


@pytest.mark.parametrize("log_m", [0, 1, 3, 12])
def test_collapse_matches_full_build(log_m):
    level = np.random.default_rng(log_m).integers(0, 1 << 32, (8, 1 << log_m), dtype=np.uint64)
    level = level.astype(np.uint32)
    want = jm.host_levels_from(level)[-1] if log_m else level
    got = merkle_ops.merkle_collapse(from_numpy_u32(level, "cpu"))[0]
    assert np.array_equal(to_numpy_u32(got), want)


def _cluster_collapse(level, widths, B):
    """Mirror of `merkle_collapse`'s cluster split: block b takes the nodes
    x = b + B * i (its local node i) and halves them with `hash_parents`
    down to one node, writing each requested width w >= B at the columns it
    owns; rank 0 then ends the tree from the width-B level (node b at column
    b), writing the widths below B."""
    m = level.shape[1]
    blocks = [level[:, b::B] for b in range(B)]
    outs, width = {}, m
    while True:
        if width in widths:
            outs[width] = torch.stack(blocks, dim=2).reshape(8, width)  # column b + B * i
        if width == B:
            break
        blocks = [tm.hash_parents(blk) for blk in blocks]
        width //= 2
    top = torch.cat(blocks, 1)
    while width > min(widths):
        top = tm.hash_parents(top)
        width //= 2
        if width in widths:
            outs[width] = top
    return [outs[w] for w in widths]


_SPLITS = [(log_m, B) for log_m in range(13) for B in (1, 2, 4, 8, 16)
           if B <= 1 << log_m and (1 << log_m) // B <= merkle_ops.BLOCK_NODES_MAX]


@pytest.mark.parametrize("log_m,B", _SPLITS)
def test_cluster_collapse_mirror_matches_plain(log_m, B):
    m = 1 << log_m
    level = np.random.default_rng(100 + log_m).integers(0, 1 << 32, (8, m), dtype=np.uint64)
    level = widen(from_numpy_u32(level.astype(np.uint32), "cpu"))
    for widths in {(1,), tm.tail_widths(m) if m > 1 else (1,), tuple(sorted({m, B, 1}, reverse=True))}:
        got = _cluster_collapse(level, widths, B)
        want = merkle_ops.merkle_collapse_plain(level, widths)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (m, B, widths)


def test_collapse_plan():
    plans = [merkle_ops.collapse_plan(1 << k) for k in range(13)]
    for k, B in enumerate(plans):
        m = 1 << k
        assert B & (B - 1) == 0 and 1 <= B <= min(merkle_ops.CLUSTER_MAX, m)
        assert m // B <= merkle_ops.BLOCK_NODES
    assert plans == sorted(plans) and plans[0] == 1 and plans[-1] == merkle_ops.CLUSTER_MAX
    for bad in (2 * merkle_ops.COLLAPSE_MAX, 48):  # wider than the plan covers; not a power of two
        with pytest.raises(ValueError):
            merkle_ops.merkle_collapse(from_numpy_u32(np.zeros((8, bad), np.uint32), "cpu"))


def _brev(x: int, bits: int) -> int:
    """`bitrev` of csrc/merkle.cu: __brev(x) >> (32 - bits), and 0 for bits 0."""
    return int(f"{x:032b}"[::-1], 2) >> (32 - bits) if bits else 0


def _open_quads(columns, trees, table, n_values, n_nodes):
    """Mirror of `merkle_open_kernel`, lane by lane over the whole grid (128
    threads a block), from the job table alone: a layer's tensors are found
    by the pointers in its descriptor. Quad q takes row min(q, n - 1); a
    value quad's lane u reads column u; a node quad's lane u loads child
    u mod 2^r (a stored node, or a leaf hash when level `base` is not
    stored); two rounds of exchange with lane u ^ 1, then u ^ 2, hash the
    even lane's node on the left while the round is below r; lane u stores
    words 2u and 2u + 1."""
    by_ptr = {c.data_ptr(): widen(c).reshape(-1) for c in columns}
    by_ptr.update({tree.flat.data_ptr(): widen(tree.flat) for tree in trees})
    words = 3 + merkle_ops.OPEN_LEVELS
    heads = table[: len(columns) * words].reshape(-1, words)
    rows = table[len(columns) * words:].reshape(-1, 3)
    n = n_values + n_nodes
    lanes = np.arange(-(-4 * n // 128) * 128)
    out = torch.full((4 * n_values + 8 * n_nodes,), -1, dtype=torch.int64)
    h = torch.zeros((8, lanes.size), dtype=torch.int64)
    r = np.zeros(lanes.size, np.int64)
    leaf_lanes, leaf_cols = [], []
    for lane in lanes:
        q, u = lane >> 2, lane & 3
        t, k, s = (int(x) for x in rows[min(q, n - 1)])
        cols, flat, L = by_ptr[int(heads[t, 0])], by_ptr[int(heads[t, 1])], int(heads[t, 2])
        off = [int(x) for x in heads[t, 3:]]
        if k < 0:
            if q < n_values:
                out[u * n_values + q] = cols[(u << L) + _brev(s, L)]
            continue
        base = k if off[k] >= 0 else 3 * (k // 3)
        r[lane] = k - base
        child = (s << int(r[lane])) | (u & ((1 << int(r[lane])) - 1))
        if off[base] >= 0:
            h[:, lane] = flat[off[base] + (torch.arange(8) << (L - base)) + _brev(child, L - base)]
        else:
            leaf_lanes.append(lane)
            leaf_cols.append(cols[(torch.arange(4) << L) + _brev(child, L)])
    if leaf_lanes:
        h[:, leaf_lanes] = tm.hash_leaves(torch.stack(leaf_cols, 1))
    for rnd in range(2):
        other = h[:, lanes ^ (1 << rnd)]
        right = torch.from_numpy((lanes >> rnd) & 1 == 1)
        parent = compress_rows(torch.cat([torch.where(right, other, h), torch.where(right, h, other)]))
        h = torch.where(torch.from_numpy(rnd < r), parent, h)
    for q in range(n_values, n):
        quad = h[:, 4 * q: 4 * q + 4]
        assert torch.equal(quad, quad[:, :1].expand(8, 4)), q  # every lane holds the node
        for w in range(8):
            out[4 * n_values + w * n_nodes + q - n_values] = h[w, 4 * q + w // 2]
    return out


def _tree_with_leaf_level(columns: torch.Tensor, tree: tm.PrunedTree) -> tm.PrunedTree:
    """`tree` with the leaf hashes stored as well (as the JAX store keeps them)."""
    full = tm.levels(widen(columns))
    ks = sorted({0} | set(tree.offsets))
    offsets, off = {}, 0
    for k in ks:
        offsets[k] = (off, full[k].shape[1])
        off += full[k].numel()
    return tm.PrunedTree(tree.log_leaves, narrow(torch.cat([full[k].reshape(-1) for k in ks])), offsets)


@pytest.mark.parametrize("case", ["port_trees", "leaf_levels", "nodes_only"])
def test_open_quad_mirror_matches_plain(case):
    """Layers of 2^1 ... 2^8 leaves, a value read and every level's node
    reads of each, in a shuffled order (warps mix value reads, gathers and
    rebuilds of every depth; the read count is not a multiple of a block's)."""
    rng = np.random.default_rng(len(case))
    columns, trees = [], []
    for L in (1, 2, 3, 5, 8):
        cols = from_numpy_u32(rng.integers(0, P, (4, 1 << L), dtype=np.uint32), "cpu")
        tree = tm.build_pruned(cols)
        columns.append(cols)
        trees.append(_tree_with_leaf_level(cols, tree) if case == "leaf_levels" else tree)
    values = [] if case == "nodes_only" else [
        (t, int(s)) for t, tree in enumerate(trees) for s in rng.integers(0, 1 << tree.log_leaves, 3)]
    nodes = [(t, k, int(s)) for t, tree in enumerate(trees) for k in range(tree.log_leaves + 1)
             for s in rng.integers(0, 1 << (tree.log_leaves - k), 2)]
    nodes = np.array(nodes, np.int64)[rng.permutation(len(nodes))]
    values = np.array(values, np.int64).reshape(-1, 2)
    table = merkle_ops.open_table(columns, trees, values, nodes)
    got = _open_quads(columns, trees, table, len(values), len(nodes))
    assert torch.equal(got, merkle_ops.merkle_open_plain(columns, trees, values, nodes))


def test_root_bytes_little_endian():
    top = from_numpy_u32(np.array([[0x04030201], [0], [0], [0], [0], [0], [0], [0xFFFFFFFF]],
                                  np.uint32), "cpu")
    assert tm.root_bytes(top) == bytes([1, 2, 3, 4] + [0] * 24 + [0xFF] * 4)
