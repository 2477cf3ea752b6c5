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

The prover's half: `build_pruned` keeps every third level of a tree (the
counterpart of `device_levels_pruned`), and `Opening` reads the nodes a
proof reveals from it, rebuilding the two missing levels of each group
from the level below in a handful of launches. `MerkleDecommitment` is the
proof's hash witness.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .blake2s import compress_rows
from .circle import bitrev_array


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
    """(4, N) int32 columns (N a power of two) -> (8, 1) int32 root node.
    On a CUDA tensor every step is a kernel launch; on a CPU tensor each
    step runs its plain version."""
    from ..ops import merkle as merkle_ops

    n = columns.shape[1]
    level = merkle_ops.merkle_level(columns, leaf=True, fused=n % 8 == 0)
    while level.shape[1] > merkle_ops.COLLAPSE_MAX:
        level = merkle_ops.merkle_level(level, leaf=False, fused=level.shape[1] % 8 == 0)
    return merkle_ops.merkle_collapse(level)[0]


def root_bytes(top: torch.Tensor) -> bytes:
    """(8, 1) root node (int32 bits or int64 values) -> 32 root bytes."""
    from ..utils.convert import to_numpy_u32

    return to_numpy_u32(top)[:, 0].astype("<u4").tobytes()


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


def build_pruned(columns: torch.Tensor, level_fn=None, collapse_fn=None) -> PrunedTree:
    """Pruned tree over (4, N) int32 natural-order columns, N a power of two.

    Counterpart of `frieda_tpu/core/merkle.py:device_levels_pruned`: the leaf
    level and three pairing levels in one fused `merkle_level` pass (the
    one-level leaf pass when N < 8), fused inner passes while the width is
    above `ops.merkle.COLLAPSE_MAX`, each stored, then ONE `merkle_collapse`
    that writes the tail widths m/8^j and the root. Every multiple-of-3 level
    and the root are stored, which is what `Opening` relies on. The grouping
    differs from the JAX package's BLOCK-based rule only at level 0: the JAX
    package stores the leaf hashes when N is not a multiple of 8 * 4096, this
    build only when N < 8; every other stored level is the same.

    level_fn / collapse_fn default to the kernel wrappers (`ops.merkle`); the
    prover passes its own so that one pipeline can run either route."""
    from ..ops import merkle as merkle_ops

    level_fn = level_fn or merkle_ops.merkle_level
    collapse_fn = collapse_fn or merkle_ops.merkle_collapse
    n = columns.shape[1]
    fused = n >= 8
    level = level_fn(columns, True, fused)
    lev = 3 if fused else 0
    stored = [(lev, level)]
    while level.shape[1] > merkle_ops.COLLAPSE_MAX:
        level = level_fn(level, False, True)
        lev += 3
        stored.append((lev, level))
    m = level.shape[1]
    if m > 1:
        widths = tail_widths(m)
        for w, arr in zip(widths, collapse_fn(level, widths)):
            stored.append((lev + (m // w).bit_length() - 1, arr))
    offsets, off = {}, 0
    for k, arr in stored:
        offsets[k] = (off, arr.shape[1])
        off += arr.numel()
    flat = torch.cat([arr.reshape(-1) for _, arr in stored])
    return PrunedTree(n.bit_length() - 1, flat, offsets)


def _pow2_at_least(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


class Opening:
    """The column values and tree nodes one proof reveals, read from a list of
    layers (`columns[t]`, (4, N_t) int32) and their pruned trees (`trees[t]`)
    in a few device operations, then fetched in one copy.

    Register reads with `values(t, stored)` and `nodes(t, k, stored)` (stored,
    i.e. bit-reversed, indices as numpy arrays); each returns the slice of
    `run()`'s result where its answers land, in order.

    A node of a stored level is gathered. A node of a missing level k is
    rebuilt from its 2^r descendants r = k - 3*(k//3) levels down: stored
    nodes, or for k <= 2 the hashed leaves (counterpart of
    `frieda_tpu/core/fri.py:_auth_sibling_nodes`, which does this per layer
    and per level). Here every rebuild of one depth r, over all layers and
    levels, is one batch: child u of job q sits at slot bitrev_r(u) * Q + q
    (Q a power of two), so the natural-halves pairing of `merkle_level` forms
    the stored-order parents H(2s, 2s+1). The leaves are hashed in one
    one-level leaf launch, then r = 1 and r = 2 take one and two inner
    launches: at most four `merkle_level` launches per proof
    (`rebuild_launches`)."""

    def __init__(self, columns: list, trees: list):
        self.columns = columns
        self.trees = trees
        self._values = []  # (t, natural column indices)
        self._nodes = []  # (t, k, stored indices)
        self._n_values = 0
        self._n_nodes = 0
        self.rebuild_launches = 0

    def values(self, t: int, stored: np.ndarray) -> slice:
        stored = np.asarray(stored, np.int64)
        nat = bitrev_array(stored, self.trees[t].log_leaves)
        self._values.append((t, nat))
        self._n_values += len(nat)
        return slice(self._n_values - len(nat), self._n_values)

    def nodes(self, t: int, k: int, stored: np.ndarray) -> slice:
        stored = np.asarray(stored, np.int64)
        self._nodes.append((t, k, stored))
        self._n_nodes += len(stored)
        return slice(self._n_nodes - len(stored), self._n_nodes)

    def run(self, level_fn=None):
        """-> (values (4, V), nodes (8, R)) uint32 numpy arrays."""
        from ..ops import merkle as merkle_ops
        from ..utils.convert import to_numpy_u32

        level_fn = level_fn or merkle_ops.merkle_level
        T = len(self.columns)
        col_reads = [[] for _ in range(T)]  # natural column indices, per layer
        node_reads = [[] for _ in range(T)]  # (8, c) flat indices, per layer
        col_count = [0] * T
        node_count = [0] * T

        def read_cols(t, nat):
            col_reads[t].append(nat.reshape(-1))
            col_count[t] += nat.size
            return np.arange(col_count[t] - nat.size, col_count[t]).reshape(nat.shape)

        def read_nodes(t, k, nat):
            off, m = self.trees[t].offsets[k]
            node_reads[t].append(off + np.arange(8)[:, None] * m + nat.reshape(1, -1))
            node_count[t] += nat.size
            return np.arange(node_count[t] - nat.size, node_count[t]).reshape(nat.shape)

        value_refs = [(t, read_cols(t, nat)) for t, nat in self._values]
        jobs = []  # (r, "leaf" | "node", t, local positions (c, 2^r))
        for t, k, s in self._nodes:
            tree = self.trees[t]
            L = tree.log_leaves
            if k in tree.offsets:
                jobs.append((0, "node", t, read_nodes(t, k, bitrev_array(s, L - k))[:, None]))
                continue
            base = 3 * (k // 3)
            r = k - base
            children = (s[:, None] << r) | np.arange(1 << r)[None, :]
            if base in tree.offsets:
                jobs.append((r, "node", t, read_nodes(t, base, bitrev_array(children, L - base))))
            elif k <= 2:
                jobs.append((r, "leaf", t, read_cols(t, bitrev_array(children, L))))
            else:  # every multiple-of-3 level is stored: a structural bug
                raise AssertionError(f"level {k} has no stored base in {sorted(tree.offsets)}")

        col_off = np.concatenate([[0], np.cumsum(col_count)])
        node_off = np.concatenate([[0], np.cumsum(node_count)])
        leaf_slots = np.concatenate(
            [col_off[t] + pos.reshape(-1) for _, kind, t, pos in jobs if kind == "leaf"] or [np.zeros(0, np.int64)])
        n_leaves = _pow2_at_least(leaf_slots.size) if leaf_slots.size else 0
        pool_idx, at_leaf = [], 0
        for r, kind, t, pos in jobs:
            if kind == "leaf":
                pool_idx.append(at_leaf + np.arange(pos.size).reshape(pos.shape))
                at_leaf += pos.size
            else:
                pool_idx.append(n_leaves + node_off[t] + pos)
        pool_width = n_leaves + int(node_off[-1])

        perms, final, q_off = {}, [], pool_width
        for r in (1, 2):
            kids = [p for (jr, *_), p in zip(jobs, pool_idx) if jr == r]
            if not kids:
                continue
            kids = np.concatenate(kids)
            q = _pow2_at_least(len(kids))
            perm = np.zeros((1 << r) * q, np.int64)
            for u in range(1 << r):
                perm[int(bitrev_array(u, r)) * q + np.arange(len(kids))] = kids[:, u]
            perms[r] = (perm, q_off)
            q_off += q
        taken = {1: 0, 2: 0}
        for (r, *_), p in zip(jobs, pool_idx):
            if r == 0:
                final.append(p[:, 0])
            else:
                final.append(perms[r][1] + taken[r] + np.arange(len(p)))
                taken[r] += len(p)
        final = np.concatenate(final or [np.zeros(0, np.int64)])
        value_pos = np.concatenate(
            [col_off[t] + pos for t, pos in value_refs] or [np.zeros(0, np.int64)])

        if not self._n_values and not self._n_nodes:
            return np.zeros((4, 0), np.uint32), np.zeros((8, 0), np.uint32)
        dev = self.columns[0].device
        host_idx = [np.concatenate(c) for c in col_reads if c]
        host_idx += [np.concatenate(c, axis=1).reshape(-1) for c in node_reads if c]
        host_idx += [leaf_slots] + [perms[r][0] for r in sorted(perms)] + [final, value_pos]
        idx = torch.from_numpy(np.concatenate(host_idx).astype(np.int64)).to(dev)
        pieces = list(torch.split(idx, [len(a) for a in host_idx]))
        cols = [self.columns[t][:, pieces.pop(0)] for t in range(T) if col_reads[t]]
        cols = torch.cat(cols, 1) if cols else torch.zeros((4, 0), dtype=torch.int32, device=dev)
        nodes = [self.trees[t].flat[pieces.pop(0).view(8, -1)] for t in range(T) if node_reads[t]]
        leaf_idx = pieces.pop(0)
        pool = []
        self.rebuild_launches = 0
        if n_leaves:
            leaf_idx = torch.cat([leaf_idx, leaf_idx.new_zeros(n_leaves - leaf_slots.size)])
            pool.append(level_fn(cols[:, leaf_idx], True, False))
            self.rebuild_launches += 1
        pool = torch.cat(pool + nodes, 1) if pool or nodes else cols.new_zeros((8, 0))
        built = [pool]
        for r in sorted(perms):
            x = pool[:, pieces.pop(0)]
            for _ in range(r):
                x = level_fn(x, False, False)
                self.rebuild_launches += 1
            built.append(x)
        final_idx, value_idx = pieces
        out = torch.cat(built, 1)[:, final_idx]
        host = to_numpy_u32(torch.cat([cols[:, value_idx].reshape(-1), out.reshape(-1)]))
        n_val = 4 * value_pos.size
        return host[:n_val].reshape(4, -1), host[n_val:].reshape(8, -1)


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
