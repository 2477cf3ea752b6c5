"""Merkle root over evaluation columns.

Counterpart of the root half of `frieda_tpu/core/merkle.py` (SURVEY.md A.6):

  leaf i   = raw_compress(0, [c0[i], c1[i], c2[i], c3[i], 0 x 12])
  inner    = raw_compress(0, left(8 words) || right(8 words))
  root     = top node, serialized as 8 little-endian u32 words.

Natural-order halves pairing: level M pairs node j with node j + M/2 (the
stored-order siblings 2k, 2k+1 sit at natural j, j + M/2), so every level
combines its two contiguous halves.

`levels` is the plain full build (int64). `root_level` is the GPU plan: the
`merkle_level` kernel three levels per pass until the width is at most
`ops.merkle.COLLAPSE_MAX`, then `merkle_collapse` takes it to width 1 in
one block. The JAX package finishes the last 2^6 nodes on the host to spare
TPU round trips; here the tree ends on the device, with the same root.

The full tree, for `commit_with_tree`: `device_levels` keeps every level on
the device (one-level `merkle_level` launches) down to width 2^HOST_CUTOFF_LOG,
`host_levels_from` ends it on the host, and `CommitTree` reads nodes by
stored index (counterparts of `frieda_tpu/core/merkle.py:45-79, 221-274`).

The prover's half: `build_pruned` keeps every third level of a tree (the
counterpart of `device_levels_pruned`), whose two missing levels of each
group the decommitment rebuilds from the level below: inside the commit
phase (`ops.merkle.merkle_open_queries`, over the query words on the card),
on one device and for a mesh row whose shards all lie in one block (the
shards' trees of a `ShardedTree` are rows of one tensor there), and after
the fetch for a row of several blocks, where `ShardedOpening` (an
`Opening`) reads the values and nodes a proof reveals in one `merkle_open`
launch a device. `MerkleDecommitment` is the proof's hash witness.

The verifier's half is host code over numpy rows, as in the JAX package
(`frieda_tpu/core/merkle.py:297-410`): `compress_rows_host` hashes leaves and
`verify_openings_rows` recomputes a root from opened leaves and a hash
witness, both in the native runtime (`frieda_tpu_torch/native/`), or with
`plain=True` in the plain version (`blake2s.compress_rows` on CPU tensors and
a numpy walk per level) that the tests hold the runtime against.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .blake2s import compress_rows


def hash_leaves(columns: torch.Tensor) -> torch.Tensor:
    """(4, N) int64 columns -> (8, N) int64 leaf hashes."""
    if columns.shape[0] != 4:
        raise ValueError(f"expected 4 columns, got {tuple(columns.shape)}")
    zeros = columns.new_zeros((12, columns.shape[1]))
    return compress_rows(torch.cat([columns, zeros]))


def hash_parents(level: torch.Tensor) -> torch.Tensor:
    """(8, M) int64 level -> (8, M/2) parents, parent j = H(L[j] || L[j+M/2])."""
    half = level.shape[1] // 2
    return compress_rows(torch.cat([level[:, :half], level[:, half:]]))


def levels(columns: torch.Tensor) -> list[torch.Tensor]:
    """Plain full tree: every level leaves-first down to width 1, (8, m)
    int64 each. Counterpart of JAX `device_levels(columns, cutoff_log=0)`."""
    level = hash_leaves(columns)
    out = [level]
    while level.shape[1] > 1:
        level = hash_parents(level)
        out.append(level)
    return out


def root_level(columns: torch.Tensor) -> torch.Tensor:
    """(4, N) int32 columns (N a power of two) -> (8, 1) int32 root node, or
    a batch (B, 4, N) -> (B, 8, 1), one tree a blob, in the same launches.
    On a CUDA tensor every step is a kernel launch; on a CPU tensor each
    step runs its plain version."""
    from ..ops import merkle as merkle_ops

    n = columns.shape[-1]
    level = merkle_ops.merkle_level(columns, leaf=True, fused=n % 8 == 0)
    while level.shape[-1] > merkle_ops.COLLAPSE_MAX:
        level = merkle_ops.merkle_level(level, leaf=False, fused=level.shape[-1] % 8 == 0)
    return merkle_ops.merkle_collapse(level)[0]


def _root_words(words: np.ndarray) -> bytes:
    return np.asarray(words, np.uint32).astype("<u4").tobytes()


def root_bytes(top: torch.Tensor) -> bytes:
    """(8, 1) root node (int32 bits or int64 values) -> 32 root bytes."""
    from ..utils.convert import to_numpy_u32

    return _root_words(to_numpy_u32(top)[:, 0])


def root_bytes_many(tops: torch.Tensor) -> list:
    """(B, 8, 1) root nodes -> [32 root bytes of each blob], in one fetch."""
    from ..utils.convert import to_numpy_u32

    return [_root_words(top[:, 0]) for top in to_numpy_u32(tops)]


# ---------------------------------------------------------------------------
# The full tree (`commit_with_tree`)
# ---------------------------------------------------------------------------

HOST_CUTOFF_LOG = 6  # device levels stop at the first of width <= 2^6; the host ends the tree


def device_levels(columns: torch.Tensor, cutoff_log: int = HOST_CUTOFF_LOG) -> list:
    """Every level of the tree over (4, N) int32 natural-order columns on
    their device, leaves first, (8, m) int32 each, stopping at the first
    level of width <= 2^cutoff_log (the leaf level alone when N is that
    narrow). Counterpart of `frieda_tpu/core/merkle.py:device_levels`: one
    launch of the one-level leaf `merkle_level`, then one one-level inner
    launch per level, every level kept. Its plain version is `levels`, cut
    at the same level."""
    from ..ops import merkle as merkle_ops

    cut = max(1 << cutoff_log, 1)
    level = merkle_ops.merkle_level(columns, leaf=True, fused=False)
    out = [level]
    while level.shape[1] > cut:
        level = merkle_ops.merkle_level(level, leaf=False, fused=False)
        out.append(level)
    return out


def host_levels_from(top: np.ndarray) -> list:
    """The levels above a fetched level ((8, m) uint32, natural order), down
    to the root, hashed on the host (`compress_rows_host`)."""
    out, level = [], np.asarray(top, np.uint32)
    while level.shape[1] > 1:
        half = level.shape[1] // 2
        msgs = np.concatenate([level[:, :half], level[:, half:]]).T
        level = np.ascontiguousarray(compress_rows_host(msgs).T)
        out.append(level)
    return out


class CommitTree:
    """A whole Merkle tree: the device levels (`device_levels`, kept on their
    device), the host levels above the last of them, and the 32-byte root.
    Counterpart of `frieda_tpu/core/merkle.py:CommitTree`."""

    def __init__(self, dlevels: list, log_n_leaves: int):
        from ..utils.convert import to_numpy_u32

        self.dlevels = dlevels
        self.log_n_leaves = log_n_leaves
        top = to_numpy_u32(dlevels[-1])
        self.hlevels = host_levels_from(top)
        self.root = _root_words((self.hlevels[-1] if self.hlevels else top)[:, 0])

    @property
    def n_device_levels(self) -> int:
        return len(self.dlevels)

    def gather_nodes(self, level: int, stored_indices) -> list:
        """The 32-byte nodes at `level` (0 = leaves) by stored (reference
        order) index: bit-reversed to the natural layout, then one index
        tensor and one fetch for a device level, a numpy gather for a host
        level."""
        from ..utils.convert import to_numpy_u32
        from .circle import bitrev_array

        stored = np.asarray(stored_indices, np.int64).reshape(-1)
        if not stored.size:
            return []
        nat = bitrev_array(stored, self.log_n_leaves - level)
        if level < len(self.dlevels):
            src = self.dlevels[level]
            g = to_numpy_u32(src[:, torch.from_numpy(nat).to(src.device)])
        else:
            g = self.hlevels[level - len(self.dlevels)][:, nat]
        return [_root_words(g[:, j]) for j in range(g.shape[1])]


def build_tree(columns: torch.Tensor) -> CommitTree:
    """`CommitTree` over (4, N) int32 columns (`device_levels` at the host
    cutoff)."""
    return CommitTree(device_levels(columns), columns.shape[1].bit_length() - 1)


def tail_widths(m: int) -> tuple:
    """Widths stored below a level of width m > 1: m/8, m/64, ... while the
    width is at least 1, then the root (width 1) if that was not one."""
    out = []
    while m >= 8:
        m //= 8
        out.append(m)
    if not out or out[-1] != 1:
        out.append(1)
    return tuple(out)


@dataclass
class PrunedTree:
    """The stored levels of a pruned tree in one flat int32 tensor: level k
    (width m, natural order) is the (8, m) block at `offsets[k] = (offset,
    m)`. The levels stored are every multiple of 3 from 3 up and the root
    (level log_leaves), plus level 0 when there are fewer than 8 leaves."""

    log_leaves: int
    flat: torch.Tensor
    offsets: dict

    def level(self, k: int) -> torch.Tensor:
        off, m = self.offsets[k]
        return self.flat[off : off + 8 * m].view(8, m)

    @property
    def root(self) -> torch.Tensor:
        return self.level(self.log_leaves)


def _pruned_levels(columns: torch.Tensor, step=None) -> list:
    """[(level k, (..., 8, m) nodes)]: the stored levels of `build_pruned`
    over (4, N) columns, or over a batch (B, 4, N), one tree a blob. A
    channel step (a batch's: one channel a blob) rides on the collapse that
    makes the root, or is one `transcript` launch when the tree ends
    without a collapse (8 leaves or fewer: the leaf pass makes the root)."""
    from ..ops import channel as channel_ops
    from ..ops import merkle as merkle_ops

    n = columns.shape[-1]
    fused = n >= 8
    level = merkle_ops.merkle_level(columns, True, fused)
    lev = 3 if fused else 0
    stored = [(lev, level)]
    while level.shape[-1] > merkle_ops.COLLAPSE_MAX:
        level = merkle_ops.merkle_level(level, False, True)
        lev += 3
        stored.append((lev, level))
    m = level.shape[-1]
    if m > 1:
        widths = tail_widths(m)
        for w, arr in zip(widths, merkle_ops.merkle_collapse(level, widths, step=step)):
            stored.append((lev + (m // w).bit_length() - 1, arr))
    elif step is not None:
        channel_ops.run_step(step, level)
    return stored


def _flatten(stored: list) -> tuple:
    """(flat, offsets) of stored levels: (..., total) int32, level k's (8, m)
    block at offsets[k] = (offset, m) of each blob's row."""
    offsets, off = {}, 0
    for k, arr in stored:
        offsets[k] = (off, arr.shape[-1])
        off += 8 * arr.shape[-1]
    return torch.cat([arr.reshape(*arr.shape[:-2], -1) for _, arr in stored], dim=-1), offsets


def build_pruned(columns: torch.Tensor, step=None) -> PrunedTree:
    """Pruned tree over (4, N) int32 natural-order columns, N a power of two.

    Counterpart of `frieda_tpu/core/merkle.py:device_levels_pruned`: the leaf
    level and three pairing levels in one fused `merkle_level` pass (the
    one-level leaf pass when N < 8), fused inner passes while the width is
    above `ops.merkle.COLLAPSE_MAX`, each stored, then ONE `merkle_collapse`
    that writes the tail widths m/8^j and the root. Every multiple-of-3 level
    and the root are stored, which the decommitment's reads rely on. The grouping
    differs from the JAX package's BLOCK-based rule only at level 0: the JAX
    package stores the leaf hashes when N is not a multiple of 8 * 4096, this
    build only when N < 8; every other stored level is the same.

    step: the layer's channel step (`ops.channel.ChannelStep`), run by the
    collapse that makes the root, or by one `transcript` launch for a tree
    of 8 leaves or fewer."""
    flat, offsets = _flatten(_pruned_levels(columns, step))
    return PrunedTree(columns.shape[1].bit_length() - 1, flat, offsets)


def build_pruned_many(columns: torch.Tensor, step=None) -> tuple:
    """(trees, roots): the `build_pruned` trees of a batch (B, 4, N) of
    column sets, in the launches of one tree (the kernels' blob axis), each
    tree's `flat` a row of one (B, total) tensor; roots: (B, 8) root words.

    step: a batch of B channel steps (`ops.channel.ChannelStep` with (B, ...)
    fields: the batched commit phase's layer), blob b's run on its root by
    the collapse that makes the roots, or, for trees of 8 leaves or fewer,
    by one batched `transcript` launch."""
    flat, offsets = _flatten(_pruned_levels(columns, step))
    log_leaves = columns.shape[-1].bit_length() - 1
    off = offsets[log_leaves][0]
    return [PrunedTree(log_leaves, row, offsets) for row in flat], flat[:, off : off + 8]


class Opening:
    """The column values and tree nodes one proof reveals, read from a list of
    layers (`columns[t]`, (4, N_t) int32) and their pruned trees (`trees[t]`)
    in one `merkle_open` launch and fetched in one copy.

    Register reads with `values(t, stored)` and `nodes(t, k, stored)` (stored,
    i.e. bit-reversed, indices as numpy arrays); each returns the slice of
    `run()`'s result where its answers land, in order. A node of a stored
    level is gathered; a node of a missing level k is rebuilt from its 2^r
    descendants r = k - 3*(k//3) levels down: stored nodes, or for k <= 2 the
    hashed leaves (`ops.merkle.open_plan`; counterpart of
    `frieda_tpu/core/fri.py:_auth_sibling_nodes`)."""

    def __init__(self, columns: list, trees: list):
        self.columns = columns
        self.trees = trees
        self._values = []  # (n, 2) int64 rows (t, stored leaf index)
        self._nodes = []  # (n, 3) int64 rows (t, k, stored node index)
        self._n_values = 0
        self._n_nodes = 0
        self.open_calls = 0

    def values(self, t: int, stored: np.ndarray) -> slice:
        s = np.asarray(stored, np.int64).reshape(-1)
        self._values.append(np.stack([np.full_like(s, t), s], 1))
        self._n_values += len(s)
        return slice(self._n_values - len(s), self._n_values)

    def nodes(self, t: int, k: int, stored: np.ndarray) -> slice:
        s = np.asarray(stored, np.int64).reshape(-1)
        self._nodes.append(np.stack([np.full_like(s, t), np.full_like(s, k), s], 1))
        self._n_nodes += len(s)
        return slice(self._n_nodes - len(s), self._n_nodes)

    def jobs(self) -> tuple:
        """(values (V, 2), nodes (R, 3)): the int64 rows of every read, in
        registration order."""
        return (np.concatenate(self._values or [np.zeros((0, 2), np.int64)]),
                np.concatenate(self._nodes or [np.zeros((0, 3), np.int64)]))

    def run(self):
        """-> (values (4, V), nodes (8, R)) uint32 numpy arrays: one
        `ops.merkle.merkle_open` launch over every read, one fetch."""
        from ..ops import merkle as merkle_ops
        from ..utils.convert import to_numpy_u32

        values, nodes = self.jobs()
        out = to_numpy_u32(merkle_ops.merkle_open(self.columns, self.trees, values, nodes))
        self.open_calls += 1
        n_val = 4 * len(values)
        return out[:n_val].reshape(4, -1), out[n_val:].reshape(8, -1)


# ---------------------------------------------------------------------------
# Trees and openings over an element-sharded layer (`parallel/`)
# ---------------------------------------------------------------------------

def _subroot_level(x, subroots: dict) -> torch.Tensor:
    """(8, S) natural-order level of the S shards' subtree roots of a
    `parallel.mesh.Sharded` layer, on its home device (one gather)."""
    pieces = x.mesh.all_gather(x.row, subroots, [8] * x.mesh.n_elem)
    return torch.stack(pieces, dim=1)


def sharded_root_level(x) -> torch.Tensor:
    """(8, 1) root node of the tree over a `parallel.mesh.Sharded` (4, M)
    layer, M >= S: each block of shards runs `root_level` (the kernels'
    blob axis: the launches of one tree), whose root is node s of the whole
    tree's level of width S (natural pairs j, j + M/2 stay on a shard); the
    S subtree roots are gathered and collapsed to the root in one launch."""
    from ..ops import merkle as merkle_ops

    subroots = {}
    for e0, block in x.blocks:
        roots = root_level(block)
        subroots.update({e0 + i: roots[i] for i in range(roots.shape[0])})
    level = _subroot_level(x, subroots)
    return level if level.shape[1] == 1 else merkle_ops.merkle_collapse(level)[0]


@dataclass
class ShardedTree:
    """The pruned tree over a `parallel.mesh.Sharded` (4, 2^log_leaves)
    layer: `shards[s]`, each local shard's `build_pruned` tree over its part,
    whose stored levels are the whole tree's from the leaves up to width S;
    `top`, every level from the S subtree roots (level log_leaves - log2 S,
    node s from shard s) to the root, all stored (None for S = 1); `root`,
    the (8, 1) root node."""

    log_leaves: int
    shards: dict
    top: PrunedTree | None
    root: torch.Tensor


def build_sharded_tree(x, step=None) -> ShardedTree:
    """`ShardedTree` of a `parallel.mesh.Sharded` layer of at least 2S
    columns: `build_pruned_many` a block of shards, one gather of the
    subtree roots, and one `merkle_collapse` writing every level of the top,
    which carries the layer's channel step (`step`, on the home device); a
    mesh of one shard (no top) runs the step as one `transcript` launch."""
    from ..ops import channel as channel_ops
    from ..ops import merkle as merkle_ops

    shards, subroots = {}, {}
    for e0, block in x.blocks:
        trees, roots = build_pruned_many(block)
        for i, tree in enumerate(trees):
            shards[e0 + i] = tree
            subroots[e0 + i] = roots[i]
    level = _subroot_level(x, subroots)
    log_leaves = x.width.bit_length() - 1
    S = level.shape[1]
    if S == 1:
        if step is not None:
            channel_ops.run_step(step, level)
        return ShardedTree(log_leaves, shards, None, level)
    widths = tuple(S >> k for k in range(1, S.bit_length()))
    outs = merkle_ops.merkle_collapse(level, widths, step=step)
    flat, offsets = _flatten([(0, level)] + [(k + 1, o) for k, o in enumerate(outs)])
    return ShardedTree(log_leaves, shards, PrunedTree(S.bit_length() - 1, flat, offsets), outs[-1])


class ShardedOpening(Opening):
    """`Opening` over layers that are either `parallel.mesh.Sharded` (trees
    `ShardedTree`) or replicated (4, N_t) tensors (trees `PrunedTree`), all
    of one mesh row. Reads are registered by global stored index, as on one
    device; `run` maps each to an entry of the `merkle_open` table:

      * a value, or a node of a level at least S wide, of a sharded layer:
        natural j = bitrev(i), shard s = j mod S, local stored index
        bitrev(j // S) at the same level of shard s's tree. A missing level k
        is rebuilt from level 3 * (k // 3) of the same shard (descendants of a
        node stay on its shard);
      * a node of a level narrower than S: the top tree, whose levels are all
        stored (its column tensor is a (4, S) zero placeholder, never read);
      * a read of a replicated layer: its tree, as on one device.

    Every (layer, shard) is its own table entry: one launch for each device
    that holds an entry. In a process-group mesh each process opens its own
    shards and the replicated entries, and the shards' answers are gathered
    over the row (`Mesh.all_gather`). The decommitment of a row of several
    blocks; a row in one block reads the same mapping on the card, in its
    commit phase (`ops.merkle.merkle_open_queries`)."""

    def __init__(self, columns: list, trees: list):
        from ..parallel.mesh import Sharded

        super().__init__(columns, trees)
        sharded = [x for x in columns if isinstance(x, Sharded)]
        self.mesh, self.row = (sharded[0].mesh, sharded[0].row) if sharded else (None, None)
        self.slots = (self.mesh.n_elem if self.mesh else 1) + 2  # an entry's code: t * slots + slot
        self.top, self.rep = self.slots - 2, self.slots - 1  # the slots past the shards'

    def _locate(self, t: int, k: np.ndarray, s: np.ndarray) -> tuple:
        """(slots, local levels, local stored indices) of reads (t, k, s):
        slot e for shard e of a sharded layer, `self.top` for its top tree,
        `self.rep` for a replicated layer."""
        from .circle import bitrev_array

        tree = self.trees[t]
        if not isinstance(tree, ShardedTree):
            return np.full_like(s, self.rep), k, s
        L, log_s = tree.log_leaves, self.mesh.log_elem
        in_top = L - k < log_s
        j, local = np.zeros_like(s), np.zeros_like(s)
        for bits in np.unique(L - k[~in_top]):
            sel = ~in_top & (L - k == bits)
            j[sel] = bitrev_array(s[sel], int(bits))
            local[sel] = bitrev_array(j[sel] >> log_s, int(bits) - log_s)
        slot = np.where(in_top, self.top, j & ((1 << log_s) - 1))
        return slot, np.where(in_top, k - (L - log_s), k), np.where(in_top, s, local)

    def _held(self, slot: int) -> bool:
        return slot >= self.top or self.mesh.is_local(self.row, slot)

    def _entry(self, code: int) -> tuple:
        """(device, columns, tree) of an entry."""
        t, slot = divmod(code, self.slots)
        if slot == self.rep:
            return self.columns[t].device, self.columns[t], self.trees[t]
        if slot == self.top:
            home = self.mesh.home(self.row)
            return home, torch.zeros((4, self.mesh.n_elem), dtype=torch.int32, device=home), self.trees[t].top
        return self.mesh.device(self.row, slot), self.columns[t].part(slot), self.trees[t].shards[slot]

    def run(self):
        """-> (values (4, V), nodes (8, R)) uint32 numpy arrays, in
        registration order: one `ops.merkle.merkle_open` launch a device, over the entries this process holds, one fetch a device."""
        from ..ops import merkle as merkle_ops
        from ..utils.convert import to_numpy_u32

        values, nodes = self.jobs()
        reads = {}  # kind: (entry codes, local levels, local stored indices), registration order
        for kind, (t, k, s) in (("v", (values[:, 0], 0 * values[:, 0], values[:, 1])), ("n", nodes.T)):
            code, lk, ls = np.empty_like(s), np.empty_like(s), np.empty_like(s)
            for layer in np.unique(t):
                sel = t == layer
                slot, lk[sel], ls[sel] = self._locate(int(layer), k[sel], s[sel])
                code[sel] = layer * self.slots + slot
            reads[kind] = (code, lk, ls)
        entries = {int(c): self._entry(int(c)) for c in np.unique(np.concatenate([reads["v"][0], reads["n"][0]]))
                   if self._held(int(c) % self.slots)}
        out = {"v": np.zeros((4, len(values)), np.uint32), "n": np.zeros((8, len(nodes)), np.uint32)}
        for dev in dict.fromkeys(dev for dev, _, _ in entries.values()):
            codes = np.array([c for c, e in entries.items() if e[0] == dev], np.int64)  # ascending
            sel = {kind: np.isin(reads[kind][0], codes) for kind in reads}
            idx = {kind: np.searchsorted(codes, reads[kind][0][sel[kind]]) for kind in reads}
            got = to_numpy_u32(merkle_ops.merkle_open(
                [entries[c][1] for c in codes.tolist()], [entries[c][2] for c in codes.tolist()],
                np.stack([idx["v"], reads["v"][2][sel["v"]]], 1),
                np.stack([idx["n"], reads["n"][1][sel["n"]], reads["n"][2][sel["n"]]], 1)))
            self.open_calls += 1
            cut = 4 * int(sel["v"].sum())
            out["v"][:, sel["v"]] = got[:cut].reshape(4, -1)
            out["n"][:, sel["n"]] = got[cut:].reshape(8, -1)
        if self.mesh is not None and self.mesh.group is not None:
            self._gather_remote({kind: reads[kind][0] % self.slots for kind in reads}, out)
        return out["v"], out["n"]

    def _gather_remote(self, slots: dict, out: dict) -> None:
        """Fill the reads of other processes' shards: each shard's answers,
        values then nodes in registration order, gathered over the row."""
        S = self.mesh.n_elem
        numels = [4 * int((slots["v"] == e).sum()) + 8 * int((slots["n"] == e).sum()) for e in range(S)]
        mine = {}
        for e in self.mesh.local_elems(self.row):
            piece = np.concatenate([out[kind][:, slots[kind] == e].reshape(-1) for kind in "vn"])
            mine[e] = torch.from_numpy(piece.view(np.int32)).to(self.mesh.device(self.row, e))
        pieces = self.mesh.all_gather(self.row, mine, numels)
        for e in range(S):
            if e not in mine:
                got = pieces[e].cpu().numpy().view(np.uint32)
                cut = 4 * int((slots["v"] == e).sum())
                out["v"][:, slots["v"] == e] = got[:cut].reshape(4, -1)
                out["n"][:, slots["n"] == e] = got[cut:].reshape(8, -1)


@dataclass
class MerkleDecommitment:
    """Hash witness of a multi-opening (counterpart of stwo's
    MerkleDecommitment.hash_witness; column values travel separately as the
    FRI layer's fri_witness). Jax-free copy of the JAX package's class."""

    hash_witness: list = field(default_factory=list)

    def to_dict(self):
        return {"hash_witness": [h.hex() for h in self.hash_witness]}

    @classmethod
    def from_dict(cls, d):
        return cls(hash_witness=[bytes.fromhex(h) for h in d["hash_witness"]])


# ---------------------------------------------------------------------------
# The verifier's half (host)
# ---------------------------------------------------------------------------

def compress_rows_host(msgs: np.ndarray, plain: bool = False) -> np.ndarray:
    """(m, 16) uint32 messages -> (m, 8) uint32 zero-state compressions."""
    msgs = np.ascontiguousarray(msgs, np.uint32)
    if not plain:
        from .. import native

        return native.raw_compress_batch(msgs)
    out = compress_rows(torch.from_numpy(msgs.T.astype(np.int64)))
    return np.ascontiguousarray(out.numpy().T.astype(np.uint32))


def verify_openings_rows(root: bytes, log_n_leaves: int, idxs, rows: np.ndarray,
                         hash_witness: list, plain: bool = False) -> bool:
    """Recompute the root from known leaf hashes and the hash witness, which
    must be consumed exactly. Returns False on a mismatch or a malformed
    witness; never raises for a bad proof.

    idxs: sorted unique leaf indices; rows: their (m, 8) uint32 hash words.
    The native runtime walks the whole tree in one call; the plain walk
    groups pairs in numpy and hashes each level in one call."""
    try:  # one C-level join validates and packs
        joined = b"".join(hash_witness)
    except TypeError:
        return False
    if len(joined) != 32 * len(hash_witness):
        return False
    wit_rows = np.frombuffer(joined, np.uint32).reshape(-1, 8) if joined else np.zeros((0, 8), np.uint32)
    idxs = np.asarray(idxs, np.int64)
    if not plain:
        from .. import native

        ok, got_root, consumed = native.verify_openings(log_n_leaves, idxs, rows, wit_rows)
        return ok and consumed == wit_rows.shape[0] and got_root == root
    wi = 0
    for _ in range(log_n_leaves):
        if idxs.size == 0:
            break
        # sorted unique indices: element i starts a pair iff it is even and
        # the next element is its sibling (an odd element can only pair
        # backward, which the previous position already captured)
        is_start = np.zeros(idxs.size, bool)
        is_start[:-1] = (idxs[:-1] % 2 == 0) & (idxs[1:] == idxs[:-1] + 1)
        is_second = np.zeros(idxs.size, bool)
        is_second[1:] = is_start[:-1]
        lone = ~is_start & ~is_second
        n_lone = int(lone.sum())
        if wi + n_lone > wit_rows.shape[0]:
            return False
        keep = is_start | lone  # one output node per kept position, in order
        kidx = idxs[keep]
        krows = rows[keep]
        lone_k = lone[keep]
        lefts = krows.copy()
        rights = np.empty_like(krows)
        # paired: right = the following row; lone even: right = witness;
        # lone odd: left = witness, right = own row
        paired_k = ~lone_k
        rights[paired_k] = rows[np.flatnonzero(keep)[paired_k] + 1]
        wslice = wit_rows[wi : wi + n_lone]
        wi += n_lone
        lone_even = lone_k & (kidx % 2 == 0)
        lone_odd = lone_k & (kidx % 2 == 1)
        rights[lone_even] = wslice[(kidx[lone_k] % 2 == 0).nonzero()[0]]
        lefts[lone_odd] = wslice[(kidx[lone_k] % 2 == 1).nonzero()[0]]
        rights[lone_odd] = krows[lone_odd]
        rows = compress_rows_host(np.concatenate([lefts, rights], axis=1), plain=True)
        idxs = kidx >> 1
    if wi != wit_rows.shape[0]:  # leftover witness entries: malformed
        return False
    return idxs.size == 1 and int(idxs[0]) == 0 and rows[0].tobytes() == root


def verify_openings(root: bytes, log_n_leaves: int, leaf_hashes: dict, dec: MerkleDecommitment,
                    plain: bool = False) -> bool:
    """`verify_openings_rows` over a {leaf index: 32-byte hash} dict."""
    items = sorted(leaf_hashes.items())
    rows = np.stack([np.frombuffer(h, np.uint32) for _, h in items]) if items else np.zeros((0, 8), np.uint32)
    return verify_openings_rows(root, log_n_leaves, [i for i, _ in items], rows, dec.hash_witness, plain)
