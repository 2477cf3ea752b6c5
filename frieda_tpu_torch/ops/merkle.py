"""The Merkle kernels, BLAKE2s zero-state raw compressions: levels
(`merkle_level`), the narrow-tail collapse (`merkle_collapse`) and the
decommitment's reads (`merkle_open`).

`merkle_level` replaces the four level kernels of
`frieda_tpu/ops/merkle_pallas.py` (`leaf_level`, `inner_level`,
`leaf3_level`, `inner3_level`): one thread per output node, one level or
three levels per pass, leaf mode hashing [c0..c3, 0 x 12] first.
`merkle_collapse` replaces `collapse_level` / `collapse_multi`: one
thread-block cluster of `collapse_plan(m)` blocks takes a level of width
<= COLLAPSE_MAX down the tree with every intermediate level in shared
memory (block b the subtree of the nodes x = b mod B down to width B, then
rank 0 the rest), and writes each requested width (the commit asks for the
root only, the prover's pruned trees for every third level of the tail).
A prover's collapse also carries its layer's channel step
(`ops.channel.ChannelStep`: the seed mix for layer 0, the root mix, the
alpha draw), run at the end of the same launch by the thread that holds the
root (`step=`; counted in `merkle_collapse.steps`), a step a blob for a
batch.
`merkle_open` does the device work of `frieda_tpu/core/fri.py`'s
`_auth_sibling_nodes` and value gathers for every read of one proof in one
launch, a quad of lanes per read (`leaf_level` / `inner_level` are that
function's one-level steps in the JAX package), from a job table built on
the host (the decommitment of a mesh row of several blocks).
`merkle_open_queries` is the same per-read body driven by the query words
on the card: the oblivious gathers of the JAX package's
`_fri_commit_fn.run`, every raw query's pair and authentication path in
each layer, in a grid fixed by the configuration, so that a CUDA graph of
the commit phase holds it; a layer may be element-sharded over a mesh row
whose shards all lie in one block here, each read then mapped to its shard's
part and tree or to the top tree on the card (`open_queries_layers`).
`order_openings` turns those gathers into the proof's decommitment on the
card, deduplicated and in the proof's order (`ordered_section`), one block a
proof, so that the host only cuts it.
Sources: `csrc/merkle.cu`, `csrc/blake2s.cuh`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core import device_channel as dc
from ..core.blake2s import compress_rows
from ..core.circle import bitrev_array
from ..core.merkle import PrunedTree, ShardedTree, hash_leaves, hash_parents
from ..parallel.mesh import Sharded
from ..utils.convert import narrow, to_numpy_u32, widen
from . import _build
from . import channel as channel_ops

CLUSTER_MAX = 16  # the largest cluster a Hopper card runs (non-portable above 8)
BLOCK_NODES = 256  # input nodes a block of the plan takes: 128 compressions, a warp per scheduler
BLOCK_NODES_MAX = 512  # the kernel's limit (8 KB of shared memory for its first level)
COLLAPSE_MAX = CLUSTER_MAX * BLOCK_NODES  # 4096: the widest level the collapse takes


def collapse_plan(m: int) -> int:
    """Blocks of the collapse cluster for a level of width m: one block per
    BLOCK_NODES nodes, 1 to CLUSTER_MAX."""
    return min(CLUSTER_MAX, max(1, m // BLOCK_NODES))


def merkle_level_plain(x: torch.Tensor, leaf: bool, fused: bool) -> torch.Tensor:
    """Plain version on int64 values. leaf: (4, N) columns -> (8, N) leaf
    hashes, or (8, N/8) with fused. Inner: (8, M) -> (8, M/2), or (8, M/8)
    with fused (three pairing levels). A batch (B, 4 or 8, width) runs blob
    by blob."""
    if x.dim() == 3:
        return torch.stack([merkle_level_plain(b, leaf, fused) for b in x])
    level = hash_leaves(x) if leaf else x
    for _ in range(3 if fused else (0 if leaf else 1)):
        level = hash_parents(level)
    return level


def merkle_level(x: torch.Tensor, leaf: bool, fused: bool) -> torch.Tensor:
    """int32 form of `merkle_level_plain`, over one blob ((4 or 8, width))
    or a batch ((B, 4 or 8, width) -> (B, 8, width / fold)), each blob its
    own tree. Launches the kernel on a CUDA tensor, runs the plain version on
    a CPU tensor (per blob, stacked)."""
    rows = 4 if leaf else 8
    if x.dim() not in (2, 3) or x.shape[-2] != rows or not x.shape[0]:
        raise ValueError(f"x: expected ({rows}, width) or (B >= 1, {rows}, width), got {tuple(x.shape)}")
    _build.check_u32(x, "x", tuple(x.shape))
    blobs = x.view(-1, rows, x.shape[-1])
    width = x.shape[-1]
    fold = 8 if fused else (1 if leaf else 2)
    if width < fold or width % fold or width & (width - 1):
        raise ValueError(f"width {width} is not a power of two divisible by {fold}")
    if x.is_cuda:
        out = torch.empty((blobs.shape[0], 8, width // fold), dtype=torch.int32, device=x.device)
        lib = _build.library()
        _build.check_launch(lib.frieda_merkle_level(
            x.data_ptr(), out.data_ptr(), width, int(leaf), int(fused), blobs.shape[0],
            _build.stream_of(x)))
        merkle_level.launches += 1
    else:
        out = torch.stack([narrow(merkle_level_plain(widen(b), leaf, fused)) for b in blobs])
    return out if x.dim() == 3 else out[0]


merkle_level.launches = 0


def _check_widths(m: int, out_widths) -> tuple:
    widths = tuple(int(w) for w in out_widths)
    if (not widths or any(w < 1 or m % w or w & (w - 1) for w in widths)
            or any(a <= b for a, b in zip(widths, widths[1:]))):
        raise ValueError(f"out_widths {out_widths} must be descending powers of two dividing {m}")
    return widths


def merkle_collapse_plain(level: torch.Tensor, out_widths=(1,), step=None) -> list:
    """Plain version: (8, m) int64 level -> [(8, w) level of width w for w in
    out_widths], widths descending and dividing m; with `step`, then
    `transcript_plain` runs it on the root. A batch
    (B, 8, m) -> [(B, 8, w) ...] runs blob by blob, blob b with row b of a
    batched step."""
    widths = _check_widths(level.shape[-1], out_widths)
    _check_step(level, widths, step)
    if level.dim() == 3:
        per_blob = [merkle_collapse_plain(x, widths, _row_step(step, b)) for b, x in enumerate(level)]
        return [torch.stack([o[k] for o in per_blob]) for k in range(len(widths))]
    outs = []
    for w in widths:
        while level.shape[1] > w:
            level = hash_parents(level)
        outs.append(level)
    if step is not None:  # `ops.channel.run_step` on the root, by the transcript's plain version
        alpha, _ = channel_ops.transcript_plain(step.state, mix_u64=step.seed, mix_digest=narrow(outs[-1]).reshape(8),
                                                draw_felt=True)
        step.alpha.copy_(alpha)
    return outs


def _row_step(step, b: int):
    """Blob b's step of a batched step (None for None)."""
    if step is None:
        return None
    return channel_ops.ChannelStep(step.state[b], None if step.seed is None else step.seed[b], step.alpha[b])


def _check_step(level: torch.Tensor, widths: tuple, step) -> None:
    """A step rides on a collapse (m >= 2) that ends at the root: one
    channel for an (8, m) level, a batch of B channels ((B, ...) fields)
    for a (B, 8, m) batch; ValueError otherwise."""
    if step is None:
        return
    if level.shape[-1] < 2 or widths[-1] != 1:
        raise ValueError(f"a channel step needs a level of m >= 2 collapsed to its root; got level "
                         f"{tuple(level.shape)} -> {widths}")
    if step.state.shape[:-1] != level.shape[:-2]:
        raise ValueError(f"a step over channels {tuple(step.state.shape)} for a level {tuple(level.shape)}: "
                         "one channel a blob")
    channel_ops.check_step(step)
    _build.check_same_device(level, step.state)


def merkle_collapse(level: torch.Tensor, out_widths=(1,), step=None) -> list:
    """(8, m) int32 level, m a power of two <= COLLAPSE_MAX -> [(8, w) int32
    for w in out_widths] (descending powers of two dividing m); or a batch
    (B, 8, m) -> [(B, 8, w) ...], each blob its own tree. One launch on a
    CUDA tensor: a cluster of `collapse_plan(m)` blocks per blob. The plain
    version on a CPU tensor.

    step: None, or an `ops.channel.ChannelStep` run on the root at the end
    of the same launch (state updated, alpha written in place): m >= 2, the
    widths ending at 1, and for a batch one channel a blob, (B, ...) fields,
    each run by the block that holds its blob's root (ValueError
    otherwise)."""
    if level.dim() not in (2, 3) or level.shape[-2] != 8 or not level.shape[0]:
        raise ValueError(f"level: expected (8, m) or (B >= 1, 8, m), got {tuple(level.shape)}")
    m = level.shape[-1]
    _build.check_u32(level, "level", tuple(level.shape))
    if not 1 <= m <= COLLAPSE_MAX or m & (m - 1):
        raise ValueError(f"collapse width must be a power of two <= {COLLAPSE_MAX}, got {m}")
    widths = _check_widths(m, out_widths)
    _check_step(level, widths, step)
    if not level.is_cuda:
        return [narrow(o) for o in merkle_collapse_plain(widen(level), widths, step)]
    blobs = level.view(-1, 8, m)
    outs = [torch.empty((blobs.shape[0], 8, w), dtype=torch.int32, device=level.device) for w in widths]
    ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    ws = (ctypes.c_longlong * len(widths))(*widths)
    state, seed, alpha = step if step is not None else (None, None, None)
    lib = _build.library()
    _build.check_launch(lib.frieda_merkle_collapse(
        level.data_ptr(), ptrs, ws, len(widths), m, collapse_plan(m), blobs.shape[0],
        None if state is None else state.data_ptr(), None if seed is None else seed.data_ptr(),
        None if alpha is None else alpha.data_ptr(), dc.DRAW_BOUND, _build.stream_of(level)))
    merkle_collapse.launches += 1
    merkle_collapse.steps += step is not None
    return outs if level.dim() == 3 else [o[0] for o in outs]


merkle_collapse.launches = 0
merkle_collapse.steps = 0  # launches that carried a channel step


OPEN_LEVELS = 32  # level offsets a layer descriptor of the job table holds (log_leaves < 32)


def open_plan(trees, values, nodes) -> tuple:
    """Check the reads of one opening and say where each node read comes from.

    values: (V, 2) int64 rows (layer t, stored leaf index s); nodes: (R, 3)
    rows (t, level k, stored node index s). Returns (values, nodes, base, r,
    leaf, offsets): a node of a stored level k is gathered (base k, r 0);
    otherwise its 2^r descendants at level base = 3 * (k // 3), r = k - base,
    are gathered if that level is stored, or else (k <= 2, `leaf`) the leaf
    hashes of their columns. offsets: (T, OPEN_LEVELS), level k's offset in
    trees[t].flat or -1. Raises ValueError for a read outside its layer,
    AssertionError for a level k >= 3 without a stored base (every multiple
    of 3 is stored: a structural bug)."""
    values = np.asarray(values, np.int64).reshape(-1, 2)
    nodes = np.asarray(nodes, np.int64).reshape(-1, 3)
    logs = np.array([tree.log_leaves for tree in trees], np.int64)
    if not len(logs) or logs.max() >= OPEN_LEVELS:
        raise ValueError(f"an opening needs 1 or more layers of fewer than 2^{OPEN_LEVELS} leaves")
    offsets = np.full((len(trees), OPEN_LEVELS), -1, np.int64)
    for t, tree in enumerate(trees):
        for k, (off, _) in tree.offsets.items():
            offsets[t, k] = off
    for what, t, k, s in (("value", values[:, 0], 0 * values[:, 0], values[:, 1]), ("node", *nodes.T)):
        L = logs[np.clip(t, 0, len(logs) - 1)]
        bad = (t < 0) | (t >= len(logs)) | (k < 0) | (k > L) | (s < 0)
        bad |= s >= np.left_shift(1, np.clip(L - k, 0, None))
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(f"{what} read (t={t[i]}, k={k[i]}, s={s[i]}) lies outside its layer")
    t, k, _ = nodes.T
    base = np.where(offsets[t, k] >= 0, k, 3 * (k // 3))
    leaf = offsets[t, base] < 0
    if (leaf & (k > 2)).any():
        raise AssertionError(f"level {k[leaf & (k > 2)][0]} has no stored base")
    return values, nodes, base, k - base, leaf, offsets


def open_table(columns, trees, values, nodes) -> np.ndarray:
    """`merkle_open`'s job table, int64: for each layer t the data pointers
    of columns[t] and trees[t].flat, log_leaves and `open_plan`'s level
    offsets; then one row (t, k, s) per read, the value reads first with
    k = -1."""
    values, nodes, *_, offsets = open_plan(trees, values, nodes)
    heads = np.array([[c.data_ptr(), tree.flat.data_ptr(), tree.log_leaves]
                      for c, tree in zip(columns, trees)], np.int64)
    reads = np.concatenate([np.stack([values[:, 0], np.full(len(values), -1, np.int64), values[:, 1]], 1),
                            nodes])
    return np.concatenate([np.concatenate([heads, offsets], 1).reshape(-1), reads.reshape(-1)])


def merkle_open_plain(columns, trees, values, nodes) -> torch.Tensor:
    """Plain version, int64 (4V + 8R,): the (4, V) column values of the value
    reads, then the (8, R) nodes of the node reads, each from where
    `open_plan` says; the 2^r descendants of a rebuilt node combine in
    stored-order pairs H(2s, 2s + 1) r times. Counterpart of the value
    gathers and `_auth_sibling_nodes` of `frieda_tpu/core/fri.py`."""
    values, nodes, base, r, leaf, _ = open_plan(trees, values, nodes)
    dev = columns[0].device

    def gather(src, stored, bits):  # src's columns at the natural indices of stored ones
        return widen(src[:, torch.from_numpy(bitrev_array(stored, bits).reshape(-1)).to(dev)])

    def put(dst, rows, src):
        dst[:, torch.from_numpy(rows).to(dev)] = src

    vals = torch.zeros((4, len(values)), dtype=torch.int64, device=dev)
    for t in np.unique(values[:, 0]):
        rows = np.flatnonzero(values[:, 0] == t)
        put(vals, rows, gather(columns[t], values[rows, 1], trees[t].log_leaves))
    out = torch.zeros((8, len(nodes)), dtype=torch.int64, device=dev)
    for from_leaves, depth in set(zip(leaf.tolist(), r.tolist())):  # one batch per (kind, r)
        group = np.flatnonzero((leaf == from_leaves) & (r == depth))
        kids, order = [], []
        for t, b in sorted(set(zip(nodes[group, 0].tolist(), base[group].tolist()))):
            rows = group[(nodes[group, 0] == t) & (base[group] == b)]
            children = (nodes[rows, 2, None] << depth) | np.arange(1 << depth)
            src = columns[t] if from_leaves else trees[t].level(b)
            kids.append(gather(src, children, trees[t].log_leaves - b))
            order.append(rows)
        h = torch.cat(kids, 1)
        if from_leaves:
            h = hash_leaves(h)
        for _ in range(depth):
            pairs = h.reshape(8, -1, 2)
            h = compress_rows(torch.cat([pairs[:, :, 0], pairs[:, :, 1]]))
        put(out, np.concatenate(order), h)
    return torch.cat([vals.reshape(-1), out.reshape(-1)])


def _check_layer(what: str, cols: torch.Tensor, tree) -> None:
    L, n = tree.log_leaves, tree.flat.numel()
    _build.check_u32(cols, f"{what} columns", (4, 1 << L))
    _build.check_u32(tree.flat, f"{what} tree", (n,))
    _build.check_same_device(cols, tree.flat)
    if any(not 0 <= k <= L or m != 1 << (L - k) or off < 0 or off + 8 * m > n
           for k, (off, m) in tree.offsets.items()):
        raise ValueError(f"{what}: a stored level does not fit its tree")


def _check_layers(columns, trees) -> None:
    if not columns or len(columns) != len(trees):
        raise ValueError(f"{len(columns)} column sets for {len(trees)} trees")
    for t, (cols, tree) in enumerate(zip(columns, trees)):
        _check_layer(f"layer {t}", cols, tree)
    _build.check_same_device(*columns)


def merkle_open(columns, trees, values, nodes, table=None) -> torch.Tensor:
    """int32 form of `merkle_open_plain` over int32 layers (`columns[t]`,
    (4, 2^L) each) and their pruned trees: one launch on CUDA tensors, the
    plain version on CPU tensors. Every read is checked against its layer
    first (`open_plan`). The job table (`open_table`) is uploaded here
    without a synchronization, unless the caller passes its copy on the
    card as `table` (a CUDA graph cannot capture the upload)."""
    _check_layers(columns, trees)
    if not columns[0].is_cuda:
        return narrow(merkle_open_plain(columns, trees, values, nodes))
    host = open_table(columns, trees, values, nodes)
    n_values, n_nodes = np.size(values) // 2, np.size(nodes) // 3
    dev = columns[0].device
    out = torch.empty(4 * n_values + 8 * n_nodes, dtype=torch.int32, device=dev)
    if not out.numel():
        return out
    if table is None:
        table = torch.from_numpy(host).to(dev, non_blocking=True)
    elif table.dtype != torch.int64 or tuple(table.shape) != host.shape or table.device != dev:
        raise ValueError(f"table: expected int64 {host.shape} on {dev}, got {table.dtype} "
                         f"{tuple(table.shape)} on {table.device}")
    _build.check_launch(_build.library().frieda_merkle_open(
        table.data_ptr(), len(columns), n_values, n_nodes, out.data_ptr(), _build.stream_of(out)))
    merkle_open.launches += 1
    return out


merkle_open.launches = 0


def open_queries_words(log_leaves, nq: int) -> int:
    """Output words of `merkle_open_queries` over layers of these log sizes
    and nq query words: per layer the (4, nq, 2) pairs, then an (8, nq)
    block a level."""
    return sum(8 * nq * (1 + int(L)) for L in log_leaves)


def open_queries_offsets(log_leaves, nq: int) -> tuple:
    """(pair_off, auth_off): where `merkle_open_queries`' output holds layer
    t's (4, nq, 2) pairs and its level-k (8, nq) sibling nodes, in words
    (the JAX package's pair and auth sections, `frieda_tpu/core/fri.py:
    _packed_layout`, from their start)."""
    pair_off, auth_off, o = [], [], 0
    for L in log_leaves:
        pair_off.append(o)
        auth_off.append([o + 8 * nq * (1 + k) for k in range(int(L))])
        o += 8 * nq * (1 + int(L))
    return pair_off, auth_off


def query_reads(trees, query_words) -> tuple:
    """(values (V, 2), nodes (R, 3)): `merkle_open_queries`' reads as the job
    rows of `merkle_open`, in the order of its output. Per layer t, with pos
    = q >> t for each word q in draw order: the two elements (pos & ~1) | e
    of each query's pair, then for each level k < log_leaves the sibling
    (pos >> k) ^ 1 of each query's ancestor. The gathers of
    `frieda_tpu/core/fri.py:_fri_commit_fn.run` (`_dbitrev` pairs,
    `_auth_sibling_nodes`)."""
    q = np.asarray(query_words).astype(np.int64).reshape(-1) & 0xFFFFFFFF
    values, nodes = [], []
    for t, tree in enumerate(trees):
        pos = q >> t
        s = ((pos & ~1)[:, None] | np.arange(2)).reshape(-1)
        values.append(np.stack([np.full_like(s, t), s], 1))
        k = np.repeat(np.arange(tree.log_leaves), q.size)
        nodes.append(np.stack([np.full_like(k, t), k, (np.tile(pos, tree.log_leaves) >> k) ^ 1], 1))
    return np.concatenate(values), np.concatenate(nodes)


def whole_tree(tree: ShardedTree) -> PrunedTree:
    """The pruned tree of a sharded layer (`core.merkle.ShardedTree`) as one
    device's tree over the whole layer, in natural order: its levels at
    least S wide are the shards' stored levels, natural node j of one being
    node j // S of shard j mod S, and its narrower levels are the top tree's
    (all stored). What the plain version and the bound read a sharded layer
    by, independent of the kernel's address mapping."""
    L = tree.log_leaves
    ls = 0 if tree.top is None else tree.top.log_leaves
    ks = sorted(set(tree.shards[0].offsets) | {L - ls + k for k in (tree.top.offsets if ls else ())})
    offsets, off = {}, 0
    for k in ks:
        offsets[k] = (off, 1 << (L - k))
        off += 8 << (L - k)

    def level(k):
        if L - k >= ls:
            return torch.stack([tree.shards[e].level(k) for e in range(1 << ls)], -1).reshape(8, -1)
        return tree.top.level(k - (L - ls))

    return PrunedTree(L, torch.cat([level(k).reshape(-1) for k in ks]), offsets)


def _whole(columns, trees) -> tuple:
    """(columns, trees) with each sharded layer reassembled on one device:
    its parts' columns in natural order (column j is column j // S of part
    j mod S) and `whole_tree`."""
    cols, out = [], []
    for x, tree in zip(columns, trees):
        if isinstance(tree, ShardedTree):
            parts = x.parts
            x = torch.stack([parts[e] for e in range(len(parts))], -1).reshape(4, -1)
            tree = whole_tree(tree)
        cols.append(x)
        out.append(tree)
    return cols, out


def merkle_open_queries_plain(columns, trees, query_words) -> torch.Tensor:
    """Plain version, int64 (`open_queries_words`,): for each layer the
    (4, nq, 2) values of the queried pairs, then an (8, nq) block of sibling
    nodes a level (`query_reads`), read by `merkle_open_plain`. A sharded
    layer (`parallel.mesh.Sharded`, `core.merkle.ShardedTree`) is read from
    its reassembled columns and `whole_tree`. The query words are read on
    the host (a tensor is fetched). A batch ((B, 4, 2^L) layers, a list of
    B trees each, (B, nq) words) -> (B, words), blob by blob."""
    if trees and isinstance(trees[0], (list, tuple)):
        return torch.stack([merkle_open_queries_plain([x[b] for x in columns], [tree[b] for tree in trees],
                                                      query_words[b]) for b in range(len(trees[0]))])
    columns, trees = _whole(columns, trees)
    words = to_numpy_u32(query_words) if isinstance(query_words, torch.Tensor) else np.asarray(query_words)
    values, nodes = query_reads(trees, words)
    flat = merkle_open_plain(columns, trees, values, nodes)
    nq = words.size
    vals = flat[: 4 * len(values)].reshape(4, len(trees), 2 * nq)
    found = flat[4 * len(values):].reshape(8, -1)
    out, r0 = [], 0
    for t, tree in enumerate(trees):
        L = tree.log_leaves
        out += [vals[:, t].reshape(-1), found[:, r0 : r0 + L * nq].reshape(8, L, nq).transpose(0, 1).reshape(-1)]
        r0 += L * nq
    return torch.cat(out)


def stored_mask(tree) -> int:
    """Bit k set for each level k the pruned tree stores, which is what
    `merkle_open_queries` reads a layer's levels by. Raises ValueError
    unless the stored levels lie in its flat tensor in ascending order with
    no gap (the kernel derives their offsets from the mask) and every level
    below log_leaves is stored, has its base 3 * (k // 3) stored, or is
    rebuilt from the leaves (k <= 2)."""
    mask, off = 0, 0
    for k in sorted(tree.offsets):
        at, m = tree.offsets[k]
        if at != off:
            raise ValueError(f"stored level {k} at offset {at}, not {off}: levels must be packed ascending")
        off += 8 * m
        mask |= 1 << k
    for k in range(tree.log_leaves):
        if not (mask >> k & 1 or mask >> (3 * (k // 3)) & 1 or k <= 2):
            raise ValueError(f"level {k} is neither stored nor rebuilt from a stored level")
    return mask


class OpenLayer(NamedTuple):
    """A layer as `merkle_open_queries` reads it (an entry of `OpenLayers`
    in csrc/merkle.cu). Whole: its (4, 2^L) columns, its pruned tree's flat
    tensor, no top. Element-sharded over the S > 1 shards of one mesh row,
    all in one block here: shard 0's part and tree (shard e's lie e parts and
    e trees further on), and the top tree's flat tensor. Of a batch of
    proofs: blob 0's columns and tree, blob b's `blob_cols` and `blob_flat`
    words a blob further on (0 for one proof)."""

    cols: torch.Tensor
    flat: torch.Tensor
    top: torch.Tensor | None
    log_leaves: int  # of the whole layer
    stored: int  # `stored_mask` of its tree (of each shard's tree)
    blob_cols: int = 0
    blob_flat: int = 0


def _rows_of_one_tensor(what: str, rows: list) -> int:
    """The word stride from each of `rows` to the next, checked: row b must
    lie b strides after row 0 (ValueError otherwise); 0 for one row."""
    if len(rows) == 1:
        return 0
    step = (rows[1].data_ptr() - rows[0].data_ptr()) // 4
    if step < rows[0].numel() or any(row.data_ptr() != rows[0].data_ptr() + 4 * b * step
                                     for b, row in enumerate(rows)):
        raise ValueError(f"{what} are not the rows of one tensor in blob order")
    return step


def _batched_layer(t: int, x: torch.Tensor, trees) -> OpenLayer:
    """The `OpenLayer` of layer t of a batch: (B, 4, 2^L) columns and B
    pruned trees (`core.merkle.build_pruned_many`'s rows), checked."""
    trees = list(trees)
    if any(isinstance(tree, ShardedTree) for tree in trees):
        raise ValueError(f"layer {t}: a batch of proofs reads whole layers only")
    if x.dim() != 3 or x.shape[0] != len(trees) or not trees:
        raise ValueError(f"layer {t}: {tuple(x.shape)} columns for {len(trees)} trees; expected (B, 4, 2^L)")
    for b, tree in enumerate(trees):
        _check_layer(f"layer {t}, blob {b}", x[b], tree)
    first = trees[0]
    if any(tree.log_leaves != first.log_leaves or tree.offsets != first.offsets for tree in trees):
        raise ValueError(f"layer {t}: its blobs' trees differ in shape")
    return OpenLayer(x[0], first.flat, None, first.log_leaves, stored_mask(first),
                     _rows_of_one_tensor(f"layer {t}'s columns", list(x)),
                     _rows_of_one_tensor(f"layer {t}'s trees", [tree.flat for tree in trees]))


def open_queries_layers(columns, trees) -> tuple:
    """(layers, log_shards): the `OpenLayer` of each layer, checked, and
    log2 S of the sharded ones (0 with none). A layer is a (4, 2^L) tensor
    with a `PrunedTree`, a `parallel.mesh.Sharded` with a `ShardedTree`, or
    a batch's (B, 4, 2^L) tensor with a list of B `PrunedTree`s (every
    layer then a batch's); one over a single shard is read as a whole
    layer. Raises ValueError for layers of several shard counts, a shard
    not held here, shards whose parts or trees are not the rows of one
    tensor in shard order (the kernel finds shard e's at e rows from shard
    0's), unequal shard trees, a top tree that does not store every level,
    and a batch whose blobs' columns or trees are not the rows of one
    tensor at one stride (the kernel finds blob b's at b strides), or mixed
    with single or sharded layers."""
    if not columns or len(columns) != len(trees):
        raise ValueError(f"{len(columns)} column sets for {len(trees)} trees")
    if len(trees) > OPEN_LEVELS:
        raise ValueError(f"at most {OPEN_LEVELS} layers")
    batched = {isinstance(tree, (list, tuple)) for tree in trees}
    if len(batched) > 1:
        raise ValueError("a batch's layers and single layers in one read")
    if batched.pop():
        layers = [_batched_layer(t, x, tree) for t, (x, tree) in enumerate(zip(columns, trees))]
        if len({len(tree) for tree in trees}) != 1:
            raise ValueError("layers of a batch with different blob counts")
        if any(layer.log_leaves >= OPEN_LEVELS for layer in layers):
            raise ValueError(f"at most {OPEN_LEVELS} layers of fewer than 2^{OPEN_LEVELS} leaves")
        _build.check_same_device(*[layer.cols for layer in layers])
        return layers, 0
    layers, shard_logs = [], set()
    for t, (x, tree) in enumerate(zip(columns, trees)):
        if not isinstance(tree, ShardedTree):
            _check_layer(f"layer {t}", x, tree)
            layers.append(OpenLayer(x, tree.flat, None, tree.log_leaves, stored_mask(tree)))
            continue
        ls = 0 if tree.top is None else tree.top.log_leaves
        S, L = 1 << ls, tree.log_leaves
        parts = x.parts if isinstance(x, Sharded) else {}
        if sorted(parts) != list(range(S)) or sorted(tree.shards) != list(range(S)):
            raise ValueError(f"layer {t}: its {S} shards are not all held here")
        shards = [tree.shards[e] for e in range(S)]
        for e, shard in enumerate(shards):
            _check_layer(f"layer {t}, shard {e}", parts[e], shard)
        first = shards[0]
        if first.log_leaves != L - ls or any(shard.offsets != first.offsets for shard in shards):
            raise ValueError(f"layer {t}: its shards' trees differ, or do not hold 2^{L - ls} leaves each")
        mask = stored_mask(first)
        if S == 1:
            layers.append(OpenLayer(parts[0], first.flat, None, L, mask))
            continue
        _build.check_u32(tree.top.flat, f"layer {t} top tree", (tree.top.flat.numel(),))
        _build.check_same_device(parts[0], tree.top.flat)
        if stored_mask(tree.top) != (2 << ls) - 1:
            raise ValueError(f"layer {t}: the top tree must store every level")
        if first.flat.numel() != sum(8 * m for _, m in first.offsets.values()):
            raise ValueError(f"layer {t}: a shard's tree holds words past its stored levels")
        for what, rows in (("parts", [parts[e] for e in range(S)]), ("trees", [shard.flat for shard in shards])):
            step = 4 * rows[0].numel()
            if any(row.data_ptr() != rows[0].data_ptr() + e * step for e, row in enumerate(rows)):
                raise ValueError(f"layer {t}: its shards' {what} are not the rows of one tensor in shard order")
        shard_logs.add(ls)
        layers.append(OpenLayer(parts[0], first.flat, tree.top.flat, L, mask))
    if len(shard_logs) > 1:
        raise ValueError(f"sharded layers over {sorted(1 << ls for ls in shard_logs)} shards: one row has one count")
    if any(layer.log_leaves >= OPEN_LEVELS for layer in layers):
        raise ValueError(f"at most {OPEN_LEVELS} layers of fewer than 2^{OPEN_LEVELS} leaves")
    _build.check_same_device(*[layer.cols for layer in layers])
    return layers, shard_logs.pop() if shard_logs else 0


def merkle_open_queries(columns, trees, query_words: torch.Tensor, out: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """int32 form of `merkle_open_queries_plain` over int32 layers (whole:
    (4, 2^L) columns and their pruned trees; or element-sharded over one
    mesh row with every shard in one block here, `open_queries_layers`) and
    the (nq,) int32 query words on the same device, into `out`
    (`open_queries_words` int32 words, or a new tensor): the same words at
    the same offsets whatever the layers' form. A batch of B proofs takes
    (B, 4, 2^L) layers with a list of B trees each (`core.merkle.
    build_pruned_many`'s rows), (B, nq) words and a (B, words) `out`, whose
    rows may lie further apart than their length (the gathers' part of
    each row of a batch's packed vectors). One launch on CUDA tensors, for
    a batch too: the layers go by value in the kernel's parameters and the
    words are read on the card, so nothing is uploaded or fetched and a
    CUDA graph captures the launch. The plain version on CPU tensors."""
    layers, log_shards = open_queries_layers(columns, trees)
    batch = query_words.dim() == 2
    if batch != isinstance(trees[0], (list, tuple)):
        raise ValueError(f"query words {tuple(query_words.shape)}: (nq,) for one proof, (B, nq) for a batch")
    lead = tuple(query_words.shape[:-1])
    nq = query_words.shape[-1]
    if not nq:
        raise ValueError("no query words")
    if batch and query_words.shape[0] != len(trees[0]):
        raise ValueError(f"{query_words.shape[0]} rows of query words for {len(trees[0])} blobs")
    _build.check_u32(query_words, "query_words", lead + (nq,))
    n_words = open_queries_words([layer.log_leaves for layer in layers], nq)
    if out is None:
        out = torch.empty(lead + (n_words,), dtype=torch.int32, device=query_words.device)
    if batch:
        if out.dtype != torch.int32 or tuple(out.shape) != lead + (n_words,) or out.stride(-1) != 1 \
                or (out.shape[0] > 1 and out.stride(0) < n_words):
            raise ValueError(f"out: expected int32 {lead + (n_words,)} rows, got {out.dtype} {tuple(out.shape)} "
                             f"strides {out.stride()}")
    else:
        _build.check_u32(out, "out", (n_words,))
    _build.check_same_device(layers[0].cols, query_words, out)
    if not query_words.is_cuda:
        return out.copy_(narrow(merkle_open_queries_plain(columns, trees, query_words)))
    T = len(layers)

    def pointers(ts):
        return (ctypes.c_void_p * T)(*[None if x is None else x.data_ptr() for x in ts])

    def longs(values):
        return (ctypes.c_longlong * T)(*values)

    _build.check_launch(_build.library().frieda_merkle_open_queries(
        pointers([layer.cols for layer in layers]), pointers([layer.flat for layer in layers]),
        pointers([layer.top for layer in layers]), (ctypes.c_int * T)(*[layer.log_leaves for layer in layers]),
        (ctypes.c_uint * T)(*[layer.stored for layer in layers]), longs([layer.blob_cols for layer in layers]),
        longs([layer.blob_flat for layer in layers]), T, log_shards, query_words.data_ptr(), nq,
        lead[0] if batch else 1, out.stride(0) if batch else 0, out.data_ptr(), _build.stream_of(out)))
    merkle_open_queries.launches += 1
    return out


merkle_open_queries.launches = 0

ORDER_QUERIES_MAX = 1024  # query words `order_openings` takes: one a thread of its block


class OrderedSection(NamedTuple):
    """`order_openings`' output for one proof, in int32 words from its
    start: 1 + 2T counts at 0 (the evaluations, each layer's FRI witness,
    each layer's hash witness), then the values, (values_cap, 4): the
    evaluations, then layer 0's witness, layer 1's, ...; then the nodes,
    (nodes_cap, 8): layer 0's hash witness, layer 1's, ..., each in (level,
    node) order. Zeros past the counted entries of each."""

    values: int  # offset of the values
    nodes: int  # offset of the nodes
    values_cap: int
    nodes_cap: int
    words: int
    list_cap: int  # the kernel's list of lone nodes and evaluations at most


@functools.lru_cache(maxsize=32)
def ordered_section(log_leaves: tuple, nq: int) -> OrderedSection:
    """The `OrderedSection` of a proof whose T layers have the log sizes
    n, n - 1, ..., n - T + 1 (`log_leaves`) and nq query words: each
    capacity from the most known nodes a level d can have, min(nq, 2^(n -
    d)) (a lone node, and an evaluation, is a known node). No more words
    than `open_queries_words`."""
    n, T = log_leaves[0], len(log_leaves)
    cap = [min(nq, 1 << (n - d)) for d in range(n)]
    values_cap = cap[0] + sum(cap[:T])
    nodes_cap = sum(sum(cap[t + 1 :]) for t in range(T))
    values = 1 + 2 * T
    nodes = values + 4 * values_cap
    return OrderedSection(values, nodes, values_cap, nodes_cap, nodes + 8 * nodes_cap, cap[0] + sum(cap))


def _proof_sizes(log_leaves) -> tuple:
    """log_leaves as a tuple of ints, checked: a proof's layers, n, n - 1,
    ..., n - T + 1 with 1 <= n < OPEN_LEVELS (ValueError otherwise)."""
    sizes = tuple(int(L) for L in log_leaves)
    if not sizes or not 1 <= sizes[0] < OPEN_LEVELS or sizes != tuple(range(sizes[0], sizes[0] - len(sizes), -1)):
        raise ValueError(f"layers of log sizes {list(sizes)}: expected n, n - 1, ..., n - T + 1 with 1 <= n < "
                         f"{OPEN_LEVELS}")
    return sizes


def order_openings_plain(gathers, query_words, log_leaves) -> torch.Tensor:
    """Plain version, int64: a proof's `ordered_section` from its gathers
    (`merkle_open_queries`' output, `open_queries_offsets`) and its nq raw
    query words (draw order, repeats allowed), read on the host. The known
    nodes of level d are the distinct words >> d; each reads its gathers at
    the first draw of its smallest word (every draw under a node gathered
    the same pair and path), and is lone when node ^ 1 is not known. The
    evaluations are the distinct words' own values (layer 0's pairs); layer
    t's FRI witness is the sibling value of each lone node of level t (its
    pairs), and its hash witness the level-(d - t) sibling node of each lone
    node of every level d > t, in (level, node) order: the selection of
    `frieda_tpu/core/fri.py:_finish_proof`. On the gathers' device (the
    CPU for a numpy array). A batch ((B, words) gathers, (B, nq) words) ->
    (B, words), row by row."""
    words = to_numpy_u32(query_words) if isinstance(query_words, torch.Tensor) else np.asarray(query_words)
    if words.ndim == 2:
        return torch.stack([order_openings_plain(gathers[b], words[b], log_leaves) for b in range(len(words))])
    g = to_numpy_u32(gathers).astype(np.int64) if isinstance(gathers, torch.Tensor) else np.asarray(gathers, np.int64)
    sizes = _proof_sizes(log_leaves)
    n, T, nq = sizes[0], len(sizes), words.size
    sec = ordered_section(sizes, nq)
    pair_off, auth_off = open_queries_offsets(sizes, nq)
    pos, slot = np.unique(words.astype(np.int64) & ((1 << n) - 1), return_index=True)  # first draws
    lone_node, lone_slot = [], []
    for d in range(n):
        x = pos >> d
        start = np.r_[True, x[1:] != x[:-1]]
        node, at = x[start], slot[start]
        lone = ~np.isin(node ^ 1, node)
        lone_node.append(node[lone])
        lone_slot.append(at[lone])

    def pair_values(t, at, el):  # (m, 4): element el of layer t's pair gathered at raw index at
        return g[(pair_off[t] + 2 * at + el)[:, None] + 2 * nq * np.arange(4)]

    values = [pair_values(0, slot, pos & 1)]
    values += [pair_values(t, lone_slot[t], (lone_node[t] & 1) ^ 1) for t in range(T)]
    nodes = [g[(auth_off[t][d - t] + lone_slot[d])[:, None] + nq * np.arange(8)]
             for t in range(T) for d in range(t + 1, n)]
    out = np.zeros(sec.words, np.int64)
    out[0] = pos.size
    out[1 : 1 + T] = [lone_node[t].size for t in range(T)]
    out[1 + T : 1 + 2 * T] = [sum(lone_node[d].size for d in range(t + 1, n)) for t in range(T)]
    vals = np.concatenate(values).reshape(-1)
    found = np.concatenate(nodes).reshape(-1) if nodes else np.zeros(0, np.int64)
    out[sec.values : sec.values + vals.size] = vals
    out[sec.nodes : sec.nodes + found.size] = found
    return torch.from_numpy(out).to(gathers.device if isinstance(gathers, torch.Tensor) else "cpu")


def order_openings(gathers: torch.Tensor, query_words: torch.Tensor, log_leaves,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """int32 form of `order_openings_plain`: the (words,) gathers of one
    proof over its (nq,) int32 query words into `out` (`ordered_section(
    log_leaves, nq).words` int32 words, or a new tensor), or a batch's (B,
    words) gathers and (B, nq) words into (B, section) rows (rows of the
    gathers and of `out` may lie further apart than their length: a batch's
    packed vectors). One launch on CUDA tensors, one block a proof: the
    words are read and ordered on the card, so nothing is uploaded or
    fetched and a CUDA graph captures it (at most ORDER_QUERIES_MAX words a
    proof). The plain version on CPU tensors."""
    sizes = _proof_sizes(log_leaves)
    lead, nq = tuple(query_words.shape[:-1]), query_words.shape[-1]
    if query_words.dim() not in (1, 2) or not nq:
        raise ValueError(f"query words {tuple(query_words.shape)}: (nq >= 1,) for one proof, (B, nq) for a batch")
    _build.check_u32(query_words, "query_words", lead + (nq,))
    sec = ordered_section(sizes, nq)
    if out is None:
        out = torch.empty(lead + (sec.words,), dtype=torch.int32, device=query_words.device)
    for name, x, width in (("gathers", gathers, open_queries_words(sizes, nq)), ("out", out, sec.words)):
        if x.dtype != torch.int32 or tuple(x.shape) != lead + (width,) or x.stride(-1) != 1 \
                or (x.dim() == 2 and x.shape[0] > 1 and x.stride(0) < width):
            raise ValueError(f"{name}: expected int32 {lead + (width,)} rows, got {x.dtype} {tuple(x.shape)} "
                             f"strides {x.stride()}")
    _build.check_same_device(gathers, query_words, out)
    if not query_words.is_cuda:
        return out.copy_(narrow(order_openings_plain(gathers, query_words, sizes)))
    if nq > ORDER_QUERIES_MAX:
        raise ValueError(f"{nq} query words: at most {ORDER_QUERIES_MAX} a proof on the card")
    batch = query_words.dim() == 2
    _build.check_launch(_build.library().frieda_order_openings(
        gathers.data_ptr(), gathers.stride(0) if batch else 0, query_words.data_ptr(), nq, sizes[0], len(sizes),
        sec.values_cap, sec.nodes_cap, sec.list_cap, lead[0] if batch else 1, out.data_ptr(),
        out.stride(0) if batch else 0, _build.stream_of(out)))
    order_openings.launches += 1
    return out


order_openings.launches = 0


def open_queries_work(trees, query_words) -> tuple:
    """(compressions, read_bytes) that one `merkle_open_queries` needs: the
    distinct hashes computed to rebuild its distinct node reads (`open_plan`:
    each from 2^depth descendants at its stored base, or from the leaves'
    columns), a hash shared by several rebuilds counted once; and the bytes
    of the distinct column entries (16) and stored nodes (32) its reads
    touch, each counted once. For `utils/profiling.merkle_open_queries_bound`.
    A sharded layer counts as its `whole_tree`, whose levels narrower than S
    are all stored: their nodes are read, not rebuilt. A batch's launch (a
    list of B trees a layer, (B, nq) words) counts its B proofs' work, each
    its own."""
    if trees and isinstance(trees[0], (list, tuple)):
        work = [open_queries_work([tree[b] for tree in trees], np.asarray(query_words)[b])
                for b in range(len(trees[0]))]
        return tuple(int(sum(w)) for w in zip(*work))
    trees = [whole_tree(tree) if isinstance(tree, ShardedTree) else tree for tree in trees]
    values, nodes = query_reads(trees, query_words)
    nodes = np.unique(nodes, axis=0)
    _, _, base, r, leaf, _ = open_plan(trees, values, nodes)
    width = 1 << r
    owner = np.repeat(np.arange(len(nodes)), width)
    u = np.arange(width.sum()) - np.repeat(np.cumsum(width) - width, width)
    child = (nodes[owner, 2] << r[owner]) | u
    level = np.where(leaf[owner], -1, base[owner])  # -1: a column entry
    reads = np.concatenate([np.stack([values[:, 0], np.full(len(values), -1), values[:, 1]], 1),
                            np.stack([nodes[owner, 0], level, child], 1)])
    distinct = np.unique(reads, axis=0)
    n_cols = int((distinct[:, 1] == -1).sum())
    # the hashes of a rebuild: its levels k - d for d < depth (d <= depth
    # from the leaves, whose level 0 hashes the columns), 2^d nodes each
    t, k, s = nodes.T
    hashes = []
    for d in range(int(r.max(initial=0)) + 1):
        m = d < r + leaf
        hashes.append(np.stack([np.repeat(t[m], 1 << d), np.repeat(k[m] - d, 1 << d),
                                ((s[m] << d)[:, None] | np.arange(1 << d)).reshape(-1)], 1))
    compressions = len(np.unique(np.concatenate(hashes), axis=0))
    return compressions, 16 * n_cols + 32 * (len(distinct) - n_cols)
