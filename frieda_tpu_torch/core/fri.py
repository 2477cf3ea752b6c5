"""FRI prover on one device, its pipelined batch form, and the verifier.

Counterpart of `frieda_tpu/core/fri.py`; the proof wire bytes and the
verdicts are the JAX package's.

Transcript order (per proof):
  mix_u64(seed)? -> mix first-layer Merkle root -> draw alpha0
  per inner layer: mix root -> draw alpha
  mix_felts(last layer coefficients) -> grind + mix_u64(nonce)
  -> sample query positions in the full domain.

Folds (stwo convention, no division by 2), on natural-order halves:
  circle->line: g[k] = (f(p) + f(-p)) + alpha * (f(p) - f(-p)) / y_p
  line:         g'[k] = (g(x) + g(-x)) + alpha * (g(x) - g(-x)) / x

Architecture, as the JAX package's `_fri_commit_fn`: the commit phase
(`commit_phase`) enqueues all of its work on the device's stream, from the
staged words to the decommitment's gathers, and waits for nothing. The
Fiat-Shamir channel lives in device memory (`core/device_channel.py`, the
`transcript` and `grind` kernels of `ops/channel.py`): each layer's root is
mixed and its alpha drawn (with the seed mixed first for layer 0) at the end
of the `merkle_collapse` launch that ends the layer's tree, where the next
`fri_fold` reads alpha, so a proof has two `transcript` launches (the
last-layer felts; the nonce and query draws) plus one a tree that ends
without a collapse, and the grind searches on the card. Once the query
words are drawn, one `merkle_open_queries` launch gathers every raw query's
pair and authentication path in each layer on the card, as the JAX
package's oblivious gathers do. The transcript's outputs (the layer roots,
the last-layer coefficients, a degree flag, the nonce and the raw query
words) and those gathers make one packed vector in a fixed layout
(`_packed_layout`). `finish_proof` then makes ONE fetch of it, launches
nothing, and assembles the proof on the host in numpy: the queries
deduplicated, the first draw of each kept, the witness planned from the
known nodes of each level (`_known_levels`) and picked from the gathers.
The sharded commit phase does the same for a mesh row whose shards all lie
in one block (every row on one card): the same launch reads its shards'
trees and top trees, and the packed vector is one device's, word for word.
A row over several devices or processes packs the transcript's outputs
alone and decommits after the fetch (`plan_openings`, one `merkle_open`
launch a device).

The pipeline's device steps come in a `Route`: the kernel wrappers
(`KERNELS`) for callers, and any other route of the same signatures (the
plain versions, in chip_smoke.py) to check the kernels on the card.

On the card the callers' commit phase is one dispatch, as the JAX package's
jitted `_fri_commit_fn` is: `dispatch_commit_phase` replays a CUDA graph of
`commit_phase`, captured once per configuration and cached (at most 8
keys, and within `MEMORY_SHARE` of a card's memory), with the words in a
static buffer and the seed as two device words.
A replay writes over the outputs of the instance's last replay, so an
instance is leased to the `Committed` it produced until `finish_proof`
ends with it (or it is collected); a key holds as many instances as were
leased at once. The commit phase runs eagerly, by design and not as a
fallback, on the CPU, on another `Route` than the kernels, under the stage
clock (`stats`, which synchronizes inside the phase) and for a mesh whose
carrier is a process group or whose row spans more than one device.

`prove_many` keeps up to a window of commit phases (`Committed`, resident on
the device) ahead of their decommitments, on one stream: blob k + 1's
commit phase is enqueued before blob k's outputs are fetched.

The verifier (`verify_proof`, `verify_many`) is host code, as in the JAX
package: it replays the transcript on the host channel (`core/channel.py`)
and checks every Merkle opening (the native runtime,
`frieda_tpu_torch/native/`) and every fold (numpy, `npfield`). It runs no
kernel and needs no card.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import struct
import time
import warnings
import weakref
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import native, ops
from ..config import DEFAULT_CONFIG, PcsConfig
from ..ops import channel as channel_ops
from ..ops import fri as fri_ops
from ..ops import ingest as ingest_ops
from ..ops import merkle as merkle_ops
from ..utils.convert import from_numpy_u32, narrow, to_numpy_u32
from ..utils.packing import log_total_for, upload_words, words_for
from ..utils.profiling import span
from . import circle as hostcircle
from . import fft, npfield
from .channel import Blake2sChannel, sample_query_positions
from .field import P, m31_add, m31_mul, m31_sub
from .merkle import (MerkleDecommitment, Opening, build_pruned, build_pruned_many, compress_rows_host,
                     verify_openings_rows)
from .proof import FriLayerProof, FriProof, Proof

_INV2 = (P + 1) // 2


class Route(NamedTuple):
    """The device steps of the pipeline, with the kernel wrappers'
    signatures (int32 u32-bit tensors in and out). The commit phase calls
    them on a batch's (B, ...) shapes (B = 1 for one proof)."""

    ingest: Callable  # (words (B, nw), log_size) -> (B, 4, 2^log_size) bit-reversed coefficients
    evaluate: Callable  # (coeffs, stage_twiddles(n)) -> (B, 4, 2^n) evaluations
    level: Callable  # (x, leaf, fused) -> Merkle level
    collapse: Callable  # (level, out_widths, step=) -> [levels]; step: a ChannelStep a blob, run on its root
    open: Callable  # (layers, trees, values, nodes) -> (4V + 8R,) the reads of an Opening (sharded)
    open_queries: Callable  # (layers, trees, query_words, out) -> out: the gathers of `_packed_layout`
    fold: Callable  # (values (B, 4, M), alpha (B, 4), inv (M/2,)) -> (B, 4, M/2); (4, M) too
    transcript: Callable  # (state, mix_u64=, mix_digest=, mix_felts=, draw_felt=, queries=) -> (alpha, words)
    grind: Callable  # (state, pow_bits) -> (2,) nonce words (lo, hi); (B, 2) for (B, 9) states


KERNELS = Route(ingest_ops.ingest, fft.evaluate_auto, merkle_ops.merkle_level,
                merkle_ops.merkle_collapse, merkle_ops.merkle_open, merkle_ops.merkle_open_queries,
                fri_ops.fri_fold, channel_ops.transcript, channel_ops.grind)


# ---------------------------------------------------------------------------
# Folds and the last-layer interpolation (device tensors)
# ---------------------------------------------------------------------------

_fold_tables: dict = {}


def fold_tables(n: int, device):
    """(ys_inv, [xs_layers_inv[l]]) of the domain of log size n as int32
    tensors on `device` (one upload, cached per (n, device); a miss is the
    span "setup/tables")."""
    key = (n, str(torch.device(device)))
    if key not in _fold_tables:
        with span("setup/tables"):
            tw = hostcircle.get_twiddles(n)
            host = [tw.ys_inv] + tw.xs_layers_inv
            flat = from_numpy_u32(np.concatenate(host), device)
            parts = torch.split(flat, [len(h) for h in host])
            _fold_tables[key] = (parts[0], list(parts[1:]))
    return _fold_tables[key]


def block_fold_tables(mesh, n: int, e0: int, k: int, device) -> list:
    """[inv_t]: the fold tables of shards e0 .. e0 + k - 1 of the domain of
    log size n on the mesh's S shards, inv_0 = ys_inv and inv_t =
    xs_layers_inv[t - 1], for every layer t at least 2S wide (those that fold
    on their shards, `commit_phase_sharded`): (k, len / S) int32 tensors on
    `device` whose row i is inv_t[e0 + i :: S], cut on the device out of the
    cached `fold_tables` and kept by the mesh."""
    def build():
        ys_inv, xs_invs = fold_tables(n, device)
        S = mesh.n_elem
        return [t.view(-1, S)[:, e0 : e0 + k].T.contiguous() for t in [ys_inv, *xs_invs] if t.numel() >= S]

    return mesh.cached(("fold_tables", n, e0, k, str(torch.device(device))), build)


def _alpha(alpha, device) -> torch.Tensor:
    """alpha as the (4,) int32 tensor the fold takes: a tensor as it is, a
    QM31 tuple of ints or 0-d tensors stacked."""
    if isinstance(alpha, torch.Tensor):
        return alpha
    return torch.stack([torch.as_tensor(a, dtype=torch.int32, device=device) for a in alpha])


def fold_c(evals: torch.Tensor, alpha, ys_inv: torch.Tensor) -> torch.Tensor:
    """(4, N) circle evaluations -> (4, N/2) line values (int32); the
    conjugate pairs are the two halves. alpha: a (4,) int32 tensor on the
    device (the transcript's draw) or a QM31 tuple. One `fri_fold`."""
    return fri_ops.fri_fold(evals, _alpha(alpha, evals.device), ys_inv)


def fold_l(g: torch.Tensor, alpha, xs_inv: torch.Tensor) -> torch.Tensor:
    """(4, M) line values -> (4, M/2) next-layer values (int32); the ±x pairs
    are the two halves. alpha as for `fold_c`. One `fri_fold`."""
    return fri_ops.fri_fold(g, _alpha(alpha, g.device), xs_inv)


def _device_ifft_line(values: torch.Tensor, xs_invs, depth: int) -> torch.Tensor:
    """(4, M) natural-order QM31 line values on line layer `depth` -> (M, 4)
    int64 natural-order coefficients: the exact inverse of the line-FFT
    stages, all 2^d sub-problems of level d at once as a (4, 2^d, M/2^d)
    tensor. Output index bit k is the s(0)/d(1) branch choice at level k;
    appending branch results along the block axis keeps block index ==
    output index. A batch (B, 4, M) -> (B, M, 4), each blob its own.
    Counterpart of `fri._device_ifft_line` (vmapped in the batched commit
    phase)."""
    lead, m = tuple(values.shape[:-2]), values.shape[-1]
    x = values.to(torch.int64).reshape(*lead, 4, 1, m)
    for d in range(m.bit_length() - 1):
        half = x.shape[-1] // 2
        v0, v1 = x[..., :half], x[..., half:]
        s = m31_mul(m31_add(v0, v1), _INV2)
        dd = m31_mul(m31_mul(m31_sub(v0, v1), _INV2), xs_invs[depth + d][:half].to(torch.int64))
        x = torch.cat([s, dd], dim=-2)
    return x[..., 0].transpose(-1, -2)


# ---------------------------------------------------------------------------
# Pair grouping / witness planning (host index math, value-independent)
# ---------------------------------------------------------------------------

def _unique_sorted(x: np.ndarray) -> np.ndarray:
    """The distinct values of a sorted array."""
    return x[np.r_[True, x[1:] != x[:-1]]] if x.size else x


def _known_levels(positions, levels: int) -> tuple:
    """The known nodes of levels 0 .. levels - 1 above leaf positions (any
    order, duplicates allowed): at level d the distinct positions >> d.
    Returns (level, node, first, lone), one entry a known node, sorted by
    (level, node): `first` is the index in `positions` of the first position
    under it, and `lone` says that its sibling node ^ 1 is not known (the
    verifier's `_pairs` over every level at once: a level's nodes sit below
    2^40, so no pair spans two levels). This is the witness planner: a lone
    node's sibling is a hash (or, at the leaves, a value) the proof
    reveals."""
    q = np.asarray(positions, np.int64).reshape(-1)
    d = np.arange(levels, dtype=np.int64)
    keys, first = np.unique((d[:, None] << 40 | q[None, :] >> d[:, None]).reshape(-1), return_index=True)
    lone, _ = _pairs(keys)
    return keys >> 40, keys & ((1 << 40) - 1), first % max(q.size, 1), lone


def _pair_groups(positions) -> tuple:
    """(pair indices, lone): sorted unique positions grouped into the pairs
    (2k, 2k + 1) they touch, in order; lone[i] is the one position present
    of pair i, or -1 when both are. The JAX package's generator
    (`frieda_tpu/core/fri.py`) in numpy."""
    pos = np.asarray(positions, np.int64).reshape(-1)
    lone, keep = _pairs(pos)
    return pos[keep] >> 1, np.where(lone[keep], pos[keep], -1)


def _all_leaf_indices(positions) -> np.ndarray:
    """Both leaves 2k, 2k + 1 of every pair k that sorted unique positions
    touch, in order."""
    ks, _ = _pair_groups(positions)
    return (2 * ks[:, None] + np.arange(2)).reshape(-1)


def _merkle_witness_plans(log_n: int, known_leaves) -> list:
    """Per-level sibling indices (int64 arrays) a multi-opening of sorted
    unique leaves needs, bottom-up as the verifier's Merkle check consumes
    them: at each level the siblings of the lone known nodes
    (`_known_levels`)."""
    if log_n == 0:
        return []
    level, node, _, lone = _known_levels(known_leaves, log_n)
    counts = np.bincount(level[lone], minlength=log_n)
    return np.split(node[lone] ^ 1, np.cumsum(counts)[:-1])


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------

class _Clock:
    """Host wall time per stage, synchronized at both ends, when `stats` is a
    dict (stats["stage_s"][name] accumulates seconds, and
    stats["stage_launches"][name][kernel] the stage's kernel launches), each
    stage a `span` of its name from after the first synchronization to after
    the second; a no-op otherwise."""

    def __init__(self, device: torch.device, stats):
        self.stats = stats
        self.sync = device.type == "cuda"
        if stats is not None:
            stats["stage_s"] = {}
            stats["stage_launches"] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.stats is None:
            yield
            return
        if self.sync:
            torch.cuda.synchronize()
        before = ops.launch_counts()
        with span(name):
            t0 = time.perf_counter()
            yield
            if self.sync:
                torch.cuda.synchronize()
        stages = self.stats["stage_s"]
        stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
        launches = self.stats["stage_launches"].setdefault(name, {})
        for kernel, count in ops.launch_counts().items():
            launches[kernel] = launches.get(kernel, 0) + count - before[kernel]


def _qm31s(cols: np.ndarray, sl: slice) -> list:
    """QM31 tuples of the columns sl of a (4, V) array."""
    return [tuple(int(v) for v in cols[:, j]) for j in range(sl.start, sl.stop)]


class Committed:
    """What the commit phase of one proof leaves for its decommitment: the
    layers and their trees on the device, and `packed`, its outputs on the
    device (int32, `layout`: the layer roots (8 words each), the last
    layer's coefficients (4 words each), the degree flag, the nonce (lo,
    hi), the raw query words, then the gathers of every raw query's pairs
    and authentication paths). `roots`, `last_layer_poly`, `nonce` and
    `queries` make the one fetch of `packed` on first use (`fetch`) and
    keep it; `staging` holds the host buffer the words were uploaded from
    until then. The commit phase of a mesh row of several blocks packs the
    head alone (a layout with no gathers) and names the class that reads its
    decommitment after the fetch (`opening_cls`, `merkle.ShardedOpening`);
    set on a `Committed` with gathers, the same class reads it after the
    fetch instead of the gathers (the tests and chip_smoke.py hold the two
    routes to the same bytes). A row of a batched commit phase
    (`commit_phase_batched`) names its batch's `BatchFetch` and its row in
    `batch`: the first fetch of any row copies every row's packed vector
    in one fetch, and the others read that host copy."""

    opening_cls = None
    batch = None  # (BatchFetch, row) for a row of a batched commit phase

    def __init__(self, layers: list, trees: list, packed: torch.Tensor, bound: int, n_queries: int,
                 layout: PackedLayout | None = None):
        self.layers = layers  # (4, N_t) int32 evaluations of each FRI layer, on the device (or `Sharded`)
        self.trees = trees  # their pruned trees (or `merkle.ShardedTree`)
        self.packed = packed
        self.bound = bound  # coefficients of the last layer
        self.n_queries = n_queries
        self.layout = layout
        self.staging = None
        self._host = None
        self._words = None  # the fetched vector
        self._lease = None  # the captured commit phase whose outputs these are (`_Instance.lend`)

    def release(self) -> None:
        """End the lease on the captured commit phase whose replay wrote this
        `Committed`, if any: its next replay may write over these tensors.
        `finish_proof` calls it when it ends."""
        if self._lease is not None:
            self._lease.give_back(self)
            self._lease = None

    def fetch(self) -> None:
        """The one fetch of the transcript's outputs (a no-op after the
        first). Raises AssertionError when the last layer exceeded its degree
        bound."""
        if self._host is not None:
            return
        with span("prove/fetch_packed"):
            words = to_numpy_u32(self.packed) if self.batch is None else self.batch[0].row(self.batch[1])
        head = {key: words[o : o + count] for key, (o, count) in self.layout.head.items()}
        if not head["degree_ok"][0]:
            raise AssertionError("FRI last layer exceeds degree bound (internal bug)")
        lo, hi = head["nonce"]
        raw = head["qpos"]
        self._host = ([root.astype("<u4").tobytes() for root in head["roots"].reshape(-1, 8)],
                      [tuple(int(v) for v in row) for row in head["last"].reshape(-1, 4)],
                      int(lo) | int(hi) << 32, sorted(set(int(q) for q in raw)), raw)
        self._words = words
        self.staging = None

    @property
    def roots(self) -> list:
        """The 32-byte root of each layer's tree."""
        self.fetch()
        return self._host[0]

    @property
    def last_layer_poly(self) -> list:
        """The last layer's QM31 coefficients."""
        self.fetch()
        return self._host[1]

    @property
    def nonce(self) -> int:
        self.fetch()
        return self._host[2]

    @property
    def queries(self) -> list:
        """Positions in the first layer's domain (stored order), sorted and
        deduplicated."""
        self.fetch()
        return self._host[3]

    @property
    def query_words(self) -> np.ndarray:
        """The raw query draws, with duplicates, in draw order."""
        self.fetch()
        return self._host[4]


class BatchFetch:
    """The packed vectors of a batched commit phase, (B, layout.total) int32
    on the device, fetched in one copy at the first `row` (then every row
    is read from the host copy) and the host buffer its words were uploaded
    from (`staging`), kept until then."""

    def __init__(self, packed: torch.Tensor):
        self.packed = packed
        self.staging = None
        self.host = None

    def row(self, b: int) -> np.ndarray:
        if self.host is None:
            self.host = to_numpy_u32(self.packed)
            self.staging = None
        return self.host[b]


def _layer_sizes(log_total: int, pcs_config: PcsConfig) -> tuple:
    """(log_size, n, n_inner) of a proof: the coefficients' and the domain's
    log sizes and the line folds before the last layer; ValueError when the
    last layer's degree bound leaves none."""
    fri_cfg = pcs_config.fri_config
    log_size = log_total - 2
    n = log_size + fri_cfg.log_blowup_factor
    n_inner = n - 1 - fri_cfg.log_last_layer_degree_bound - fri_cfg.log_blowup_factor
    if n_inner < 0:
        raise ValueError(
            f"config unsatisfiable: log_last_layer_degree_bound "
            f"{fri_cfg.log_last_layer_degree_bound} >= poly log size {log_size}")
    return log_size, n, n_inner


class PackedLayout(NamedTuple):
    """Offsets (int32 words) of the commit phase's packed vector."""

    head: dict  # name -> (offset, count): roots, last, degree_ok, nonce (lo, hi), qpos
    pair_off: list  # per layer: (4, nq, 2) values of each raw query's pair ([]: no gathers)
    auth_off: list  # per layer, per level k < log_leaves: (8, nq) sibling nodes
    total: int
    sizes: list  # log_leaves of each layer

    @property
    def head_words(self) -> int:
        o, count = self.head["qpos"]
        return o + count


@functools.lru_cache(maxsize=32)
def _packed_layout(n: int, n_inner: int, bound: int, nq: int, gather: bool = True) -> PackedLayout:
    """The fixed layout of `Committed.packed` for one configuration: the
    transcript's outputs, then (with `gather`) `merkle_open_queries`'
    gathers. Counterpart of `frieda_tpu/core/fri.py:_packed_layout`, whose
    pair and auth sections these are; the head differs (a 64-bit nonce, no
    separate evaluations: layer 0's pairs hold them)."""
    sizes = [n] + [n - 1 - l for l in range(n_inner)]
    head, o = {}, 0
    for key, count in (("roots", 8 * len(sizes)), ("last", 4 * bound), ("degree_ok", 1), ("nonce", 2),
                       ("qpos", nq)):
        head[key] = (o, count)
        o += count
    pair_off, auth_off = [], []
    for log_leaves in sizes if gather else ():
        pair_off.append(o)
        o += 8 * nq
        auth_off.append([o + 8 * nq * k for k in range(log_leaves)])
        o += 8 * nq * log_leaves
    return PackedLayout(head, pair_off, auth_off, o, sizes)


_M64 = (1 << 64) - 1


def seed_words(seed, device) -> torch.Tensor | None:
    """The seed as the (2,) int32 words that `transcript(mix_u64=...)` mixes,
    on `device`: None for None (nothing is mixed), a (2,) int32 tensor as it
    is, else row 0 of `write_seeds` of the one seed into a new tensor."""
    if seed is None or isinstance(seed, torch.Tensor):
        return seed
    return write_seeds(torch.empty((1, 2), dtype=torch.int32, device=device), [seed])[0]


def write_seeds(out: torch.Tensor, seeds) -> torch.Tensor:
    """Write a batch's seeds into `out`, a (B, 2) int32 tensor: row b the
    words (lo, hi) of `int(seeds[b]) & (2^64 - 1)`, as the JAX package
    normalises a seed (`frieda_tpu/core/fri.py:583`), in one fill a row of
    the pair viewed as one int64 (no host synchronization and no page-locked
    staging, nothing baked into a kernel's arguments). Returns `out`."""
    rows = out.view(torch.int64).view(-1)
    for b, seed in enumerate(seeds):
        value = int(seed) & _M64
        rows[b].fill_(value - (1 << 64) if value >> 63 else value)
    return out


def batch_has_seed(seeds, blobs: int) -> bool:
    """Whether a batch's seeds (None, B ints or Nones, or (B, 2) int32
    words) are set. ValueError for another count than B, or some None and
    some set (the JAX package's rule and message)."""
    if seeds is None:
        return False
    if len(seeds) != blobs:
        raise ValueError(f"{blobs} blobs but {len(seeds)} seeds")
    if isinstance(seeds, torch.Tensor):
        return True
    has_seed = [s is not None for s in seeds]
    if any(has_seed) != all(has_seed):
        raise ValueError("seeds must be all None or all set in one batch")
    return all(has_seed)


def batch_seed_words(seeds, blobs: int, device) -> torch.Tensor | None:
    """A batch's seeds as the (B, 2) int32 words that the batched channel
    steps mix, on `device`: None where they are not set, a (B, 2) int32
    tensor as it is, else `write_seeds` of the B ints into a new tensor
    (ValueError as for `batch_has_seed`)."""
    if not batch_has_seed(seeds, blobs):
        return None
    if isinstance(seeds, torch.Tensor):
        return seeds
    return write_seeds(torch.empty((blobs, 2), dtype=torch.int32, device=device), seeds)


def commit_phase(words: torch.Tensor, log_total: int, seed,
                 pcs_config: PcsConfig = DEFAULT_CONFIG, route: Route = KERNELS,
                 clock: _Clock | None = None) -> Committed:
    """The commit phase of `prove_words` for one blob's words: row 0 of
    `commit_phase_batched` over a batch of one, the same launches (the
    kernels' blob axis at B = 1). Counterpart of `_fri_commit_fn.run`. seed:
    None, an int, or its (2,) int32 words on the device (`seed_words`),
    which layer 0's channel step mixes as a tensor. What the CPU, another
    route, the stage clock and `dispatch_commit_phase`'s capture run."""
    seeds = None if seed is None else seed[None] if isinstance(seed, torch.Tensor) else [seed]
    committed = commit_phase_batched(words[None], log_total, seeds, pcs_config, route, clock)[0]
    committed.batch = None  # its packed vector is fetched alone
    return committed


def commit_phase_batched(words: torch.Tensor, log_total: int, seeds, pcs_config: PcsConfig = DEFAULT_CONFIG,
                         route: Route = KERNELS, clock: _Clock | None = None) -> list:
    """The commit phase of B blobs of one size at once, (B, nw) `pad_to_words`
    rows on the device: the counterpart of the JAX package's
    `_fri_commit_fn(..., batched=True)` (its `run` under `jax.vmap`), each
    blob with its own transcript, in the launches of one proof. In order:
    the ingest and the extension of the (B, ...) batch (as
    `api.commit_root_pipeline_batch`); per layer the B pruned trees in the
    launches of one (`merkle.build_pruned_many`), every blob's channel step
    (seed, root, alpha: `ops.channel.ChannelStep`, one preallocated alpha a
    layer) on the collapse that ends them, and one batched `fri_fold` (the
    fold tables shared); the last layer's coefficients and degree check per
    blob; one batched `transcript` for the last-layer felts, one `grind`
    (each blob's own minimum nonce), one `transcript` for the nonce mixes
    and query draws; one `merkle_open_queries` for every blob's gathers.
    Nothing waits for the device (tables not yet cached for this size are
    uploaded first).

    seeds: None, B ints (all set or all None; ValueError otherwise), or
    their (B, 2) int32 words on the device. Returns B `Committed`s, row b
    equal to `commit_phase` of row b word for word; their packed vectors
    are the rows of one (B, layout.total) tensor (`Committed.batch`:
    the first fetch copies all of them). This is the eager form, each
    launch issued from Python: what the CPU (on the plain versions), another
    route and the stage clock run, and what `dispatch_batch` captures. Under
    the stage clock the layers' channel steps fall in "lde_trees", with
    their trees. On the kernel route the folds go through this module's
    `fold_c` and `fold_l` (a caller may replace them); another route's
    `fold` is called as it is."""
    log_size, n, n_inner = _layer_sizes(log_total, pcs_config)
    if words.dim() != 2 or not words.shape[0]:
        raise ValueError(f"words: expected (B >= 1, nw) rows, got {tuple(words.shape)}")
    B, device = words.shape[0], words.device
    clock = clock or _Clock(device, None)
    circle_fold, line_fold = (fold_c, fold_l) if route.fold is KERNELS.fold else (route.fold, route.fold)
    seeds = batch_seed_words(seeds, B, device)
    with span("prove/device_dispatch(lde+merkle+transcript+grind)"):
        state = channel_ops.new_state(device, blobs=B)
        alphas = torch.empty((n_inner + 1, B, 4), dtype=torch.int32, device=device)
        ys_inv, xs_invs = fold_tables(n, device)
        with clock("lde_trees"):
            g = route.evaluate(route.ingest(words, log_size), fft.stage_twiddles(n, device))
        layers, trees, roots = [], [], []
        for t in range(n_inner + 1):
            step = channel_ops.ChannelStep(state, seeds if t == 0 else None, alphas[t])
            with clock("lde_trees"):  # the trees, their channel steps on their last launch
                rows, root = build_pruned_many(g, step, route.level, route.collapse, route.transcript)
            layers.append(g)
            trees.append(rows)
            roots.append(root)
            with clock("folds"):
                g = circle_fold(g, alphas[t], ys_inv) if t == 0 else line_fold(g, alphas[t], xs_invs[t - 1])
        packed, layout, bound = _close(state, g, layers, trees, roots, xs_invs, n, n_inner, pcs_config, route,
                                       clock)
    fetch = BatchFetch(packed)
    out = []
    for b in range(B):
        c = Committed([x[b] for x in layers], [rows[b] for rows in trees], packed[b], bound,
                      pcs_config.fri_config.n_queries, layout)
        c.batch = (fetch, b)
        out.append(c)
    return out


def _close_transcript(state, g, layers, trees, xs_invs, n, n_inner, pcs_config, route, clock,
                      gather: bool = True) -> Committed:
    """The end of a commit phase after the last fold (`_close`) for one
    proof: its `Committed`."""
    packed, layout, bound = _close(state, g, layers, trees, [t.root.reshape(8) for t in trees], xs_invs, n,
                                   n_inner, pcs_config, route, clock, gather)
    return Committed(layers, trees, packed, bound, pcs_config.fri_config.n_queries, layout)


def _close(state, g, layers, trees, roots, xs_invs, n, n_inner, pcs_config, route, clock,
           gather: bool = True) -> tuple:
    """(packed, layout, bound): the end of a commit phase after the last
    fold: the last layer's coefficients and degree check, its transcript
    step, the grind and the query draws, then (with `gather`) the
    decommitment's gathers read with the query words on the device
    (`route.open_queries`), all packed for the one fetch (`_packed_layout`).
    A batch (g (B, 4, M), (B, 9) states, each root (B, 8), each layer's
    trees a list of B) packs (B, layout.total), a row a blob."""
    fri_cfg = pcs_config.fri_config
    bound = 1 << fri_cfg.log_last_layer_degree_bound
    lead = tuple(g.shape[:-2])
    with clock("folds"):
        coeffs = _device_ifft_line(g, xs_invs, n_inner)  # (..., 2^last_log, 4) int64
        last_poly = narrow(coeffs[..., :bound, :]).contiguous()
        degree_ok = (coeffs[..., bound:, :] == 0).reshape(*lead, -1).all(-1).to(torch.int32).reshape(*lead, 1)
    with clock("transcript"):
        route.transcript(state, mix_felts=last_poly)
    with clock("grind"):
        nonce = route.grind(state, pcs_config.pow_bits)
    with clock("transcript"):
        _, query_words = route.transcript(state, mix_u64=nonce, queries=(fri_cfg.n_queries, n))
        head = list(roots) + [last_poly.reshape(*lead, -1), degree_ok, nonce, query_words]
        layout = _packed_layout(n, n_inner, bound, fri_cfg.n_queries, gather)
        packed = torch.empty((*lead, layout.total), dtype=torch.int32, device=query_words.device)
        torch.cat(head, dim=-1, out=packed[..., : layout.head_words])
    if gather:
        with clock("decommit_gather"):
            route.open_queries(layers, trees, query_words, packed[..., layout.head_words :])
    return packed, layout, bound


def commit_phase_sharded(words: torch.Tensor, log_total: int, seed, pcs_config: PcsConfig,
                         mesh, row: int) -> Committed:
    """`commit_phase` over the `elem` axis of mesh row `row` (this process's
    shards of it; `parallel/mesh.py`), the counterpart of `_fri_commit_fn`
    with a mesh (`frieda_tpu/core/fri.py:182-205`); the same roots, transcript
    and outputs as on one device. `words` lie on the row's home device;
    seed as for `commit_phase`.

    This is the eager form: `dispatch_commit_phase` captures it as one CUDA
    graph when every shard of the row is on one CUDA device and the carrier
    is in-process. A process-group mesh always runs it eagerly, because its
    point-to-point exchanges (`Mesh.swap`, `Mesh.all_gather`) are not
    captured, and so does a row over several devices.

    Layers at least 2S wide stay element-sharded in the cyclic layout: the
    extension runs per shard (`parallel/fft_sharded.sharded_evaluate`), each
    shard builds its pruned tree over its part (`merkle.build_sharded_tree`:
    a block of shards on one device in the launches of one tree, then the
    gathered subtree roots hashed to the root), and folds its part with
    its slice of the fold table (`block_fold_tables`): one `fri_fold`
    launch a block of shards, the layer's alpha shared. A layer
    narrower than 2S is gathered onto the home device and continues there,
    as on one device, and so does the last layer. The transcript (each
    layer's step on the top tree's collapse, or the one-device tree's) and
    the grind run on the home device: one channel state for the in-process
    carrier, and one in each process of a process-group mesh, each the same
    (the JAX package's replicated channel). On one device nothing here waits
    for the device. The layers of the returned `Committed` are `Sharded` or
    tensors, its trees `ShardedTree` or `PrunedTree`.

    The decommitment: when this process holds every shard of the row in one
    block (`Mesh.blocks`: one device, so every row on one card, and a row
    of one shard in a process group), the query words read the shards'
    trees and the top trees on the device, in the commit phase, into the
    packed vector at one device's layout (`ops.merkle.merkle_open_queries`),
    as the JAX package's mesh `_fri_commit_fn` does; `finish_proof` then
    fetches once and launches nothing. A row of several blocks (shards on
    several devices, or split over a process group) packs the head alone and
    decommits after the fetch through `merkle.ShardedOpening` (one
    `merkle_open` a device, the answers gathered over the row): by design,
    since those rows run eagerly and their reads cross devices."""
    from ..parallel.fft_sharded import sharded_evaluate
    from ..parallel.mesh import Sharded, new_sharded
    from .merkle import ShardedOpening, build_sharded_tree

    log_size, n, n_inner = _layer_sizes(log_total, pcs_config)
    home, S = mesh.home(row), mesh.n_elem
    seed = seed_words(seed, home)
    with span("prove/device_dispatch(lde+merkle+transcript+grind)"):
        state = channel_ops.new_state(home)
        alphas = torch.empty((n_inner + 1, 4), dtype=torch.int32, device=home)
        coeffs = ingest_ops.ingest(words, log_size)
        ys_inv, xs_invs = fold_tables(n, home)
        if 1 << n >= 2 * S:
            g = sharded_evaluate(coeffs, n, mesh, row)
        else:
            g = fft.evaluate_auto(coeffs, fft.stage_twiddles(n, home))
        layers, trees = [], []
        for t in range(n_inner + 1):
            step = channel_ops.ChannelStep(state, seed if t == 0 else None, alphas[t])
            tree = build_sharded_tree(g, step) if isinstance(g, Sharded) else build_pruned(g, step=step)
            alpha = step.alpha
            layers.append(g)
            trees.append(tree)
            if not isinstance(g, Sharded):
                g = fri_ops.fri_fold(g, alpha, ys_inv if t == 0 else xs_invs[t - 1])
                continue
            out = new_sharded(mesh, row, (4, g.blocks[0][1].shape[-1] // 2))
            for (e0, src), (_, dst) in zip(g.blocks, out.blocks):  # a block's shards in one launch
                inv = block_fold_tables(mesh, n, e0, src.shape[0], src.device)[t]
                fri_ops.fri_fold(src, alpha.to(src.device), inv, out=dst)
            g = out if out.width >= 2 * S else out.gather()
        if isinstance(g, Sharded):
            g = g.gather()  # the last layer, at most 2^(llb + blowup) values: replicated
        one_block = [k for _, k, _ in mesh.blocks(row)] == [S]
        committed = _close_transcript(state, g, layers, trees, xs_invs, n, n_inner, pcs_config, KERNELS,
                                      _Clock(home, None), gather=one_block)
    if not one_block:
        committed.opening_cls = ShardedOpening
    return committed


# ---------------------------------------------------------------------------
# The commit phase as one dispatch: a cached CUDA graph (`_fri_commit_fn`)
# ---------------------------------------------------------------------------

class _Instance:
    """Lease bookkeeping of one instance of a cached commit phase. A run
    writes the instance's outputs anew, so the instance is leased to the
    `Committed`s its last run produced (`lend`: one, or a batch's B) until
    every one of them is finished (`Committed.release`, from
    `finish_proof`) or collected (each lease is a weak reference); only a
    free instance runs again."""

    _leases = ()  # weak references to the leased Committeds
    nbytes = 0  # what the instance keeps on its device (`_GraphCache` sets it)

    @property
    def free(self) -> bool:
        return all(ref() is None for ref in self._leases)

    def lend(self, committed: Committed) -> None:
        committed._lease = self
        self._leases = [ref for ref in self._leases if ref() is not None] + [weakref.ref(committed)]

    def give_back(self, committed: Committed) -> None:
        self._leases = [ref for ref in self._leases if ref() is not None and ref() is not committed]

    def close(self) -> None:
        """Free what the instance holds; its key was evicted."""


class _CommitGraph(_Instance):
    """One captured commit phase: the `torch.cuda.CUDAGraph` of `commit(words,
    seed)`, in a memory pool of its own (a later capture cannot place its
    tensors in this one's temporaries); its static inputs, `words` (the
    `words_for(log_total)` int32 words) and `seed` ((2,) int32, or None for
    a key without a seed), or a batch's (B, nw) words and (B, 2) seeds;
    `committed`, the outputs each replay writes (layers, pruned trees,
    `packed`; a batch's B `Committed`s); `tables`, every cached table the
    graph reads, held so that clearing a cache cannot free them; `launches`,
    the kernel launches the capture recorded; and `steps`, the channel steps
    its collapses carried (`merkle_collapse.steps`).

    With `warm` (a key's first instance) one eager `commit` runs first, on a
    side stream: it builds every table of the key (a mesh's block tables
    too) and sets the kernels' one-time attributes, none of which may happen
    inside a capture. A capture or replay error raises. The construction is
    the span "setup/graph", the warm-up "setup/warm" and the capture
    "setup/capture" inside it."""

    def __init__(self, device: torch.device, n_words: int, has_seed: bool, commit, tables, warm: bool,
                 batch: int | None = None):
        lead = () if batch is None else (batch,)
        with torch.cuda.device(device), span("setup/graph"):
            self.words = torch.zeros(lead + (n_words,), dtype=torch.int32, device=device)
            self.seed = torch.zeros(lead + (2,), dtype=torch.int32, device=device) if has_seed else None
            if warm:
                with span("setup/warm"):
                    side = torch.cuda.Stream(device)
                    side.wait_stream(torch.cuda.current_stream(device))
                    with torch.cuda.stream(side):
                        commit(self.words, self.seed)
                    torch.cuda.current_stream(device).wait_stream(side)
            self.tables = tables()  # cached again here if a cache was cleared since the warm-up
            before, steps = ops.launch_counts(), merkle_ops.merkle_collapse.steps
            self.graph = torch.cuda.CUDAGraph()
            try:
                with span("setup/capture"), torch.cuda.graph(self.graph):
                    self.committed = commit(self.words, self.seed)
            finally:
                self.launches = {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]}
                ops.add_launch_counts({k: -v for k, v in self.launches.items()})  # recorded, not run
                self.steps = merkle_ops.merkle_collapse.steps - steps
                merkle_ops.merkle_collapse.steps = steps

    def run(self, seed):
        """Write the seed (a batch's B seeds), replay the graph, count its
        launches; the new `Committed` (over this instance's outputs; a
        batch's B, which share one `BatchFetch`) holds the lease."""
        with torch.cuda.device(self.words.device), span("prove/device_dispatch(lde+merkle+transcript+grind)"):
            if self.seed is not None:
                write_seeds(self.seed.view(-1, 2), [seed] if self.seed.dim() == 1 else seed)
            self.graph.replay()
        ops.add_launch_counts(self.launches)
        merkle_ops.merkle_collapse.steps += self.steps
        if isinstance(self.committed, Committed):
            return self._renew(self.committed, None)
        fetch = BatchFetch(self.committed[0].batch[0].packed)
        return [self._renew(c, (fetch, b)) for b, c in enumerate(self.committed)]

    def _renew(self, c: Committed, batch) -> Committed:
        out = Committed(c.layers, c.trees, c.packed, c.bound, c.n_queries, c.layout)
        out.opening_cls = c.opening_cls
        out.batch = batch
        self.lend(out)
        return out

    def close(self) -> None:
        self.graph.reset()
        self.graph = self.committed = self.tables = self.words = self.seed = None


class _GraphCache:
    """Captured commit phases by key, at most `size` keys, the least recently
    used first: the JAX package's `lru_cache(maxsize=8)` over its
    `_fri_commit_fn`. A key holds as many instances as were leased at once.
    A new key evicts the least recently used key that holds no live lease
    (and closes its instances, which frees their pools), or none when every
    key holds one.

    The instances of one device also keep within `MEMORY_SHARE` of its
    memory: before a capture of `nbytes` (plus `warm_bytes`, the eager
    warm-up's peak, for a key's first instance) the free instances of other
    keys on that device are closed, the least recently used key first (a
    key left with none goes), until the bytes held fit. Leased instances
    are never closed, so live `Committed`s can hold more, as they would
    eagerly. Not thread-safe, as the prover is not."""

    def __init__(self, size: int = 8):
        self.size = size
        self.keys: collections.OrderedDict = collections.OrderedDict()  # key -> (capture, [instances], device)
        self.captures = 0

    def instance(self, key, capture, device=None, nbytes: int = 0, warm_bytes: int = 0) -> _Instance:
        """A free instance of `key`, which becomes the most recently used key:
        one already captured, or a new one, `capture(warm)` with the capture
        function of the key's first call (warm: the key has no instance
        yet), after room is made for it on `device` (None: no budget)."""
        if key not in self.keys:
            self._evict()
            self.keys[key] = (capture, [], device)
        capture, insts, device = self.keys[key]
        self.keys.move_to_end(key)
        inst = next((i for i in insts if i.free), None)
        if inst is None:
            if device is not None:
                budget = int(MEMORY_SHARE * device_memory_bytes(device))
                self._make_room(key, device, budget - nbytes - (0 if insts else warm_bytes))
            inst = capture(not insts)
            inst.nbytes = nbytes
            self.captures += 1
            insts.append(inst)
        return inst

    def held_bytes(self, device, leased_only: bool = False) -> int:
        """Bytes the instances on `device` keep (only the leased ones')."""
        return sum(i.nbytes for _, insts, d in self.keys.values() if d == device
                   for i in insts if not (leased_only and i.free))

    def _make_room(self, key, device, limit: int) -> None:
        excess = self.held_bytes(device) - limit
        for k in [k for k, (_, _, d) in self.keys.items() if k != key and d == device]:
            insts = self.keys[k][1]
            for inst in [i for i in insts if i.free]:
                if excess <= 0:
                    return
                insts.remove(inst)
                inst.close()
                excess -= inst.nbytes
                if not insts:
                    del self.keys[k]

    def _evict(self) -> None:
        if len(self.keys) >= self.size:
            idle = next((k for k, (_, insts, _) in self.keys.items() if all(i.free for i in insts)), None)
            if idle is not None:
                self._drop(idle)

    def _drop(self, key) -> None:
        for inst in self.keys.pop(key)[1]:
            inst.close()

    def clear(self) -> None:
        """Drop every key that holds no live lease."""
        for key in [k for k, (_, insts, _) in self.keys.items() if all(i.free for i in insts)]:
            self._drop(key)


_GRAPHS = _GraphCache(8)


def _fri_commit_fn(log_total: int, pcs_config: PcsConfig, has_seed: bool, device: torch.device,
                   mesh=None, row: int = 0, batch: int | None = None) -> _CommitGraph:
    """A free captured commit phase of one configuration on one CUDA device:
    the counterpart of the JAX package's `_fri_commit_fn`
    (`frieda_tpu/core/fri.py:150-153`), cached by the same fields (log_size,
    log_blowup, llb, n_queries, pow_bits, has_seed) and the device, for a
    mesh by its shape and row (`commit_phase_sharded`, whose shards all lie
    on `device`), and for a batch by its blob count B (`commit_phase_batched`
    over static (B, nw) words and (B, 2) seeds: the JAX package's jit
    retraces its vmapped program per batch shape). A batch's instance keeps
    B proofs' bytes, and its key's first capture is warmed up by an eager
    batch of B."""
    fri_cfg = pcs_config.fri_config
    log_size = log_total - 2
    n = log_size + fri_cfg.log_blowup_factor
    key = (log_size, fri_cfg.log_blowup_factor, fri_cfg.log_last_layer_degree_bound, fri_cfg.n_queries,
           pcs_config.pow_bits, has_seed, device, None if mesh is None else (mesh.n_data, mesh.n_elem, row), batch)

    def commit(words, seed):
        if batch is not None:
            return commit_phase_batched(words, log_total, seed, pcs_config)
        return _eager(words, log_total, seed, pcs_config, mesh, row)

    def tables() -> list:
        held = [fft.stage_twiddles(n, device), fold_tables(n, device)]
        return held if mesh is None else held + [mesh]  # the mesh keeps its block tables (`Mesh.cached`)

    blobs = batch or 1
    return _GRAPHS.instance(key, lambda warm: _CommitGraph(device, words_for(log_total), has_seed, commit,
                                                           tables, warm, batch),
                            device, blobs * RESIDENT_BYTES_PER_ELEMENT << n, blobs * ACTIVE_BYTES_PER_ELEMENT << n)


def _eager(words: torch.Tensor, log_total: int, seed, pcs_config: PcsConfig, mesh, row: int) -> Committed:
    if mesh is None:
        return commit_phase(words, log_total, seed, pcs_config)
    return commit_phase_sharded(words, log_total, seed, pcs_config, mesh, row)


def _card(device) -> torch.device:
    """`device` with its index: a bare "cuda" names the current card, so
    that "cuda" and "cuda:0" share one key of the graph cache."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _commit_graph(log_total: int, pcs_config: PcsConfig, seed, device, mesh=None, row: int = 0):
    """The free captured commit phase that runs this proof on `device` (a
    mesh row's home device), or None where the commit phase runs eagerly:
    on the CPU, and for a mesh whose carrier is a process group or whose row
    spans more than one device."""
    _layer_sizes(log_total, pcs_config)  # ValueError before any capture
    device = _card(device)
    if device.type != "cuda":
        return None
    if mesh is not None and (mesh.group is not None
                             or len({mesh.device(row, e) for e in mesh.local_elems(row)}) > 1):
        return None
    return _fri_commit_fn(log_total, pcs_config, seed is not None, device, mesh, row)


def dispatch_commit_phase(words: torch.Tensor, log_total: int, seed,
                          pcs_config: PcsConfig = DEFAULT_CONFIG, mesh=None, row: int = 0) -> Committed:
    """The commit phase of a blob's `pad_to_words` words (int32, on the
    device; on the home device of mesh row `row` for a mesh) as one
    dispatch: on a CUDA device, one device-to-device copy of the words into
    the static buffer of a free captured instance of this configuration
    (`_fri_commit_fn`; captured on first use), the seed written as two
    device words, one graph replay; nothing waits for the device. The
    `Committed` holds the instance until `finish_proof` ends with it.
    Counterpart of `fri.dispatch_commit_phase_staged`. The CPU and a mesh
    that `_commit_graph` leaves eager run `commit_phase` /
    `commit_phase_sharded`; the bytes are the same."""
    graph = _commit_graph(log_total, pcs_config, seed, words.device, mesh, row)
    if graph is None:
        return _eager(words, log_total, seed, pcs_config, mesh, row)
    if words.shape != graph.words.shape or words.dtype != torch.int32:
        raise ValueError(f"words: expected {tuple(graph.words.shape)} int32 for log_total {log_total}, "
                         f"got {tuple(words.shape)} {words.dtype}")
    graph.words.copy_(words)
    return graph.run(seed)


def dispatch_blob(data: bytes, log_total: int, seed, pcs_config: PcsConfig, device,
                  mesh=None, row: int = 0) -> Committed:
    """`dispatch_commit_phase` of a blob on the host, for `device` (a mesh
    row's home device): its words staged in page-locked memory and uploaded
    straight into the captured instance's static buffer (or into a new
    tensor where the commit phase runs eagerly); the host buffer stays with
    the `Committed` until its fetch."""
    graph = _commit_graph(log_total, pcs_config, seed, device, mesh, row)
    with span("prove/ingest"):
        host, words = upload_words([data], log_total, device, out=None if graph is None else graph.words[None])
    committed = _eager(words[0], log_total, seed, pcs_config, mesh, row) if graph is None else graph.run(seed)
    committed.staging = host  # the upload reads it asynchronously: kept until the fetch
    return committed


def _batch_graph(log_total: int, pcs_config: PcsConfig, has_seed: bool, device, batch: int):
    """The free captured batched commit phase of `batch` blobs on `device`,
    or None on the CPU, where it runs eagerly."""
    _layer_sizes(log_total, pcs_config)  # ValueError before any capture
    device = _card(device)
    if device.type != "cuda":
        return None
    return _fri_commit_fn(log_total, pcs_config, has_seed, device, batch=batch)


def dispatch_batch(datas, log_total: int, seeds, pcs_config: PcsConfig, device) -> list:
    """The commit phase of B blobs of one padded size (2^log_total felts)
    under their seeds (all set or all None), as ONE dispatch: on a CUDA
    device the B rows staged in one page-locked buffer and uploaded in one
    copy straight into the static words of a free captured instance of
    `commit_phase_batched` for B (`_fri_commit_fn(..., batch=B)`; captured
    on first use), the B seeds written by a fill each, one graph replay;
    nothing waits for the device. Returns the B `Committed`s, which hold the
    instance until the last of them is finished. The CPU runs
    `commit_phase_batched` eagerly on the plain versions; the bytes are the
    same. The host buffer stays with the batch until its fetch."""
    datas = list(datas)
    has_seed = batch_has_seed(seeds, len(datas))
    graph = _batch_graph(log_total, pcs_config, has_seed, device, len(datas))
    with span("prove/ingest"):
        host, words = upload_words(datas, log_total, device, out=None if graph is None else graph.words)
    if graph is None:
        committed = commit_phase_batched(words, log_total, seeds, pcs_config)
    else:
        committed = graph.run(seeds if has_seed else None)
    committed[0].batch[0].staging = host  # the upload reads it asynchronously: kept until the fetch
    return committed


def commit_graphs() -> tuple:
    """(captures so far, {key: instances}) of the captured commit phases, the
    least recently used key first."""
    return _GRAPHS.captures, {k: len(insts) for k, (_, insts, _) in _GRAPHS.keys.items()}


def clear_commit_graphs() -> None:
    """Drop every captured commit phase that no live `Committed` holds (and
    free its memory pool)."""
    _GRAPHS.clear()


def plan_openings(layers: list, trees: list, queries, opening_cls=Opening) -> tuple:
    """(opening, slice of the evaluations, [(slice of the FRI witness, [slices
    of the Merkle witness per level]) per layer]): every value and node a
    proof reveals, registered on one `Opening` (or `opening_cls`: the
    sharded commit phase's `merkle.ShardedOpening`), for a decommitment read
    after the fetch."""
    opening = opening_cls(layers, trees)
    pos = np.asarray(queries, np.int64)
    eval_sl = opening.values(0, pos)
    plan = []
    for t, tree in enumerate(trees):
        _, lone = _pair_groups(pos)
        wit_sl = opening.values(t, lone[lone >= 0] ^ 1)
        plans = _merkle_witness_plans(tree.log_leaves, _all_leaf_indices(pos))
        node_sls = [opening.nodes(t, k, sibs) for k, sibs in enumerate(plans) if sibs.size]
        plan.append((wit_sl, node_sls))
        pos = _unique_sorted(pos >> 1)
    return opening, eval_sl, plan


def finish_proof(committed: Committed, log_total: int, pcs_config: PcsConfig = DEFAULT_CONFIG,
                 route: Route = KERNELS, clock: _Clock | None = None):
    """(commitment, Proof) of a commit phase: the one fetch of its packed
    outputs (which raises AssertionError for a last layer above its degree
    bound), then the proof assembled on the host from the gathers in it; no
    launch. A `Committed` that names an `opening_cls` (the commit phase of
    a mesh row of several blocks) has its decommitment read after the fetch
    (`plan_openings`: one `route.open` a device and one fetch each).
    Counterpart of `fri._finish_proof`. Ends the lease of a `Committed`
    from `dispatch_commit_phase` (`Committed.release`), also when it
    raises."""
    try:
        return _finish_proof(committed, log_total, pcs_config, route, clock)
    finally:
        committed.release()


def _finish_proof(c: Committed, log_total: int, pcs_config: PcsConfig, route: Route, clock):
    clock = clock or _Clock(c.layers[0].device, None)
    with clock("transcript"):
        c.fetch()
    gathered = c.opening_cls is None
    if not gathered:
        with clock("decommit_plan"):
            opening, eval_sl, plan = plan_openings(c.layers, c.trees, c.queries, c.opening_cls)
        with clock("decommit_open"):
            vals, nodes = opening.run(route.open)
    with clock("decommit_assemble"), span("prove/assemble"):
        with span("assemble/select"):
            if not gathered:
                node_rows = np.ascontiguousarray(nodes.T).astype("<u4")
                evaluations = _qm31s(vals, eval_sl)
                layers = [(_qm31s(vals, wit_sl),
                           [node_rows[j].tobytes() for sl in node_sls for j in range(sl.start, sl.stop)])
                          for wit_sl, node_sls in plan]
            else:
                evaluations, layers = _assemble(c._words, c.query_words, c.layout)
        with span("assemble/objects"):
            layer_proofs = [
                FriLayerProof(fri_witness=wit, decommitment=MerkleDecommitment(hashes), commitment=c.roots[t])
                for t, (wit, hashes) in enumerate(layers)
            ]
            proof = Proof(
                proof=FriProof(layer_proofs[0], layer_proofs[1:], c.last_layer_poly),
                proof_of_work=c.nonce,
                pcs_config=pcs_config,
                log_size_bound=log_total - 2,
                evaluations=evaluations,
            )
    return c.roots[0], proof


def _assemble(words: np.ndarray, raw: np.ndarray, layout: PackedLayout) -> tuple:
    """(evaluations, [(FRI witness, hash witness) per layer]) of the
    deduplicated proof encoding, selected from the packed vector `words`
    (uint32, `layout`) of the raw query words `raw`. A known node x of
    level d above layer 0 stands for the distinct positions raw >> d; the
    first raw query under it (its slot) gathered its pair and path, so a
    lone position of layer t (d = t) reveals its sibling's value from the
    slot's pair, and a lone node at level k of layer t (d = t + k, k >= 1)
    reveals its sibling's hash from the slot's level-k auth node. The
    evaluations are layer 0's positions' own values. Counterpart of the
    selection in `frieda_tpu/core/fri.py:_finish_proof`."""
    nq, sizes = raw.size, layout.sizes
    T = len(sizes)
    level, node, slot, lone = _known_levels(raw, sizes[0])
    pair_off = np.asarray(layout.pair_off, np.int64)
    cols = 2 * nq * np.arange(4)

    def values(sel, flip):  # (m, 4) values of the entries sel, or of their siblings
        at = pair_off[level[sel]] + 2 * slot[sel] + ((node[sel] & 1) ^ flip)
        return words[at[:, None] + cols].tolist()

    evaluations = [tuple(v) for v in values(level == 0, 0)]
    wit_sel = lone & (level < T)
    witness = [tuple(v) for v in values(wit_sel, 1)]
    wit_cut = np.r_[0, np.cumsum(np.bincount(level[wit_sel], minlength=T))]
    # hash witness: layer t takes the lone nodes of the levels d > t, in (d, node) order
    auth = np.zeros((T, sizes[0]), np.int64)
    for t, offs in enumerate(layout.auth_off):
        auth[t, : len(offs)] = offs
    e_level, e_slot = level[lone], slot[lone]
    t_idx, e_idx = np.nonzero(e_level[None, :] > np.arange(T)[:, None])
    at = auth[t_idx, e_level[e_idx] - t_idx] + e_slot[e_idx]
    blob = words[at[:, None] + nq * np.arange(8)].astype("<u4").tobytes()
    hashes = struct.unpack("32s" * at.size, blob)  # one 32-byte node a row, cut in C
    hash_cut = np.r_[0, np.cumsum(np.bincount(t_idx, minlength=T))]
    layers = [(witness[wit_cut[t] : wit_cut[t + 1]], list(hashes[hash_cut[t] : hash_cut[t + 1]])) for t in range(T)]
    return evaluations, layers


def prove_words(words: torch.Tensor, log_total: int, seed,
                pcs_config: PcsConfig = DEFAULT_CONFIG, route: Route = KERNELS,
                stats: dict | None = None):
    """(commitment, Proof) for a blob given as its `pad_to_words(data,
    log_total)` words, int32, on the device that runs the proof: the commit
    phase, then `finish_proof`. Counterpart of
    `fri.dispatch_commit_phase_staged` + `fri.finish_proof`.

    With no `stats` on the kernel route the commit phase is
    `dispatch_commit_phase` (on the card one graph replay after a copy of
    the words into its static buffer); another route, or `stats`, runs
    `commit_phase` eagerly.

    stats, when a dict, receives the host wall time of each stage
    (synchronized at both ends, so the commit phase then waits for the
    device at every stage: "lde_trees" (each layer's channel step rides on
    its tree), "folds", "transcript" (the closing steps, with the one
    fetch), "grind", and the decommitment's "decommit_gather" (the
    route's `open_queries`, in the commit phase) and "decommit_assemble"
    (the proof objects)), and each stage's kernel launches."""
    if stats is None and route is KERNELS:
        return finish_proof(dispatch_commit_phase(words, log_total, seed, pcs_config), log_total, pcs_config)
    clock = _Clock(words.device, stats)
    return finish_proof(commit_phase(words, log_total, seed, pcs_config, route, clock),
                        log_total, pcs_config, route, clock)


def commit_and_generate_proof(data: bytes, seed, pcs_config: PcsConfig, device):
    """(commitment, Proof) of a blob on `device` (reference:
    src/proof.rs:32-77): `dispatch_blob`, then `finish_proof`."""
    log_total = log_total_for(len(data))
    return finish_proof(dispatch_blob(data, log_total, seed, pcs_config, device), log_total, pcs_config)


# ---------------------------------------------------------------------------
# Batch prover
# ---------------------------------------------------------------------------

# Peak bytes per domain element of one proof on the card, the tables cached
# for its size included: 10.069 GiB at a 2^26 domain (chip_smoke.py phase 9,
# NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 5).
ACTIVE_BYTES_PER_ELEMENT = 162
# Bytes per domain element that one proof in flight keeps on the device
# until its decommitment: on the card a captured commit phase's private pool
# (its outputs and, reused, its temporaries) and static words, 44.000 at a
# 2^22 domain and 42.375 at 2^26 (`torch.cuda.memory_reserved` growth for a
# second instance of a key, chip_smoke.py phase 13), which also covers an
# eager `Committed` (the evaluations 16, the folded layers ~16, the pruned
# trees ~9: 41.49 at 2^22 and 41.15 at 2^26, `torch.cuda.memory_allocated`
# around `commit_phase`, phase 9); NVIDIA H100 80GB HBM3 at 700 W, PERF.md
# sections 5 and 6; rounded up.
RESIDENT_BYTES_PER_ELEMENT = 44
# The share of the device's memory that prove_many's window and the graph
# cache's instances keep within.
MEMORY_SHARE = 0.6


def device_memory_bytes(device: torch.device) -> int:
    """Total memory of the device that holds prove_many's window: the card's
    (`torch.cuda.mem_get_info`), or the host's for the CPU."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[1]
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def safe_in_flight(log_size: int, fri_cfg, device: torch.device) -> int:
    """Largest prove_many window for blobs of 2^log_size felts per column:
    `MEMORY_SHARE` of the device's memory, less one proof's peak (the eager
    warm-up of a new key) and the captured commit phases that live
    `Committed`s hold on it (the cache closes the free ones to make room),
    over one proof in flight's `RESIDENT_BYTES_PER_ELEMENT`; at least 1."""
    n = 1 << (log_size + fri_cfg.log_blowup_factor)
    device = _card(device)
    budget = (int(MEMORY_SHARE * device_memory_bytes(device)) - ACTIVE_BYTES_PER_ELEMENT * n
              - _GRAPHS.held_bytes(device, leased_only=True))
    return max(1, budget // (RESIDENT_BYTES_PER_ELEMENT * n))


def safe_batch(log_size: int, fri_cfg, device: torch.device) -> int:
    """Largest batch of blobs of 2^log_size felts per column whose batched
    commit phase fits `MEMORY_SHARE` of the device's memory, less what live
    `Committed`s hold there: B x (`RESIDENT_BYTES_PER_ELEMENT`, the batch's
    instance, + `ACTIVE_BYTES_PER_ELEMENT`, its eager warm-up) per domain
    element; at least 1."""
    n = 1 << (log_size + fri_cfg.log_blowup_factor)
    device = _card(device)
    budget = int(MEMORY_SHARE * device_memory_bytes(device)) - _GRAPHS.held_bytes(device, leased_only=True)
    return max(1, budget // ((RESIDENT_BYTES_PER_ELEMENT + ACTIVE_BYTES_PER_ELEMENT) * n))


def prove_many(datas, seeds, pcs_config: PcsConfig = DEFAULT_CONFIG,
               max_in_flight: int | None = None, device: torch.device = torch.device("cuda")):
    """[(commitment, Proof)] of each blob under its seed, in input order, equal
    to a loop of `commit_and_generate_proof`: up to `max_in_flight` finished
    commit phases stay on the device before the oldest is decommitted. On
    the card each is a graph replay (`dispatch_blob`), so a key holds at
    most `max_in_flight` captured instances.

    None takes min(8, `safe_in_flight` of the largest blob); a larger request
    is clamped to the safe window with a warning. Counterpart of
    `fri.prove_many`."""
    datas, seeds = list(datas), list(seeds)
    if len(datas) != len(seeds):
        raise ValueError(f"{len(datas)} blobs but {len(seeds)} seeds")
    if datas:
        max_log_size = max(log_total_for(len(d)) for d in datas) - 2
        safe = safe_in_flight(max_log_size, pcs_config.fri_config, device)
        if max_in_flight is None:
            max_in_flight = min(8, safe)
        elif max_in_flight > safe:
            warnings.warn(
                f"prove_many window {max_in_flight} exceeds the safe window {safe} for "
                f"2^{max_log_size}-felt blobs at blowup 2^{pcs_config.fri_config.log_blowup_factor} "
                f"on {device}; clamping", stacklevel=3)
            max_in_flight = safe
    else:
        max_in_flight = max_in_flight or 8
    if max_in_flight < 1:
        raise ValueError(f"max_in_flight must be at least 1, got {max_in_flight}")
    out, window = [], []
    for data, seed in zip(datas, seeds):
        if len(window) >= max_in_flight:
            out.append(finish_proof(*window.pop(0), pcs_config))
        log_total = log_total_for(len(data))
        window.append((dispatch_blob(data, log_total, seed, pcs_config, device), log_total))
    out.extend(finish_proof(c, log_total, pcs_config) for c, log_total in window)
    return out


# ---------------------------------------------------------------------------
# Verifier (host)
# ---------------------------------------------------------------------------

def _eval_line_poly_batch(coeffs, xs: np.ndarray) -> np.ndarray:
    """Evaluate a line polynomial (natural order, basis bit k <-> pi^k(x)) at
    an array of points. coeffs: list of QM31 tuples; xs: (m,) uint64.
    Returns (m, 4) uint64."""
    m = xs.shape[0]
    n_c = len(coeffs)
    if n_c == 1:
        return np.broadcast_to(npfield.qm31_arr([coeffs[0]]), (m, 4)).copy()
    log_n = (n_c - 1).bit_length()
    basis = [np.asarray(xs, np.uint64)]
    for _ in range(log_n - 1):
        b = basis[-1]
        basis.append((2 * b % P * b + (P - 1)) % P)  # pi(x) = 2x^2 - 1
    acc = np.zeros((m, 4), np.uint64)
    for i, c in enumerate(coeffs):
        term = np.broadcast_to(npfield.qm31_arr([c]), (m, 4))
        for k in range(log_n):
            if (i >> k) & 1:
                term = npfield.qm31_mul_m31(term, basis[k])
        acc = npfield.qm31_add(acc, term)
    return acc


def _pairs(pos: np.ndarray):
    """Pair grouping of sorted unique positions: (lone, keep). Element i
    starts a full pair iff it is even and the next element is its sibling;
    an odd element can only pair backward, which the previous position
    already captured. `keep` marks one position per pair (its first), in
    order."""
    m = pos.size
    is_start = np.zeros(m, bool)
    if m > 1:
        is_start[:-1] = (pos[:-1] % 2 == 0) & (pos[1:] == pos[:-1] + 1)
    is_second = np.zeros(m, bool)
    is_second[1:] = is_start[:-1]
    lone = ~is_start & ~is_second
    return lone, is_start | lone


def _fill_pairs(pos, values, lone, keep, wit):
    """(v_even, v_odd) (k, 4) rows of each kept pair: both from `values`, or
    the lone one's sibling from the witness rows `wit`, in order."""
    kidx = pos[keep]
    k_n = kidx.size
    v0s = np.empty((k_n, 4), np.uint64)
    v1s = np.empty((k_n, 4), np.uint64)
    lone_k = lone[keep]
    paired_k = ~lone_k
    start_rows = np.flatnonzero(keep)[paired_k]
    v0s[paired_k] = values[start_rows]
    v1s[paired_k] = values[start_rows + 1]
    lone_rows = np.flatnonzero(keep)[lone_k]
    even_sel = kidx[lone_k] % 2 == 0
    lone_even = lone_k.copy()
    lone_even[lone_k] = even_sel
    lone_odd = lone_k.copy()
    lone_odd[lone_k] = ~even_sel
    v0s[lone_even] = values[lone_rows[even_sel]]
    v1s[lone_even] = wit[even_sel.nonzero()[0]]
    v0s[lone_odd] = wit[(~even_sel).nonzero()[0]]
    v1s[lone_odd] = values[lone_rows[~even_sel]]
    return v0s, v1s


def _leaf_rows(v0s: np.ndarray, v1s: np.ndarray) -> np.ndarray:
    """(2k, 8) leaf hashes of the pairs (2k, 2k + 1), interleaved."""
    msgs = np.zeros((2 * v0s.shape[0], 16), np.uint32)
    msgs[0::2, :4] = v0s.astype(np.uint32)
    msgs[1::2, :4] = v1s.astype(np.uint32)
    return compress_rows_host(msgs)


def _fold_rows(v0s, v1s, alpha_rows, inv):
    """(v0 + v1) + alpha * (v0 - v1) * inv over (k, 4) QM31 rows."""
    f1 = npfield.qm31_mul_m31(npfield.qm31_sub(v0s, v1s), inv)
    return npfield.qm31_add(npfield.qm31_add(v0s, v1s), npfield.qm31_mul(alpha_rows, f1))


def _verify_layer_merkle(root, log_len, positions, values, wit, dec):
    """Group pairs, fill the lone positions' siblings from the FRI witness
    rows `wit` ((n_lone, 4) uint64; consumed exactly) and check the Merkle
    multi-opening. positions: sorted unique; values: their (m, 4) uint64
    rows. Returns (pair_ks (k,) int64, v_even, v_odd (k, 4) uint64), or None
    if the layer is invalid."""
    pos = np.asarray(positions, np.int64)
    lone, keep = _pairs(pos)
    if int(lone.sum()) != wit.shape[0]:
        return None
    v0s, v1s = _fill_pairs(pos, values, lone, keep, wit)
    pair_ks = pos[keep] >> 1
    leaf_idxs = np.empty(2 * pair_ks.size, np.int64)
    leaf_idxs[0::2] = 2 * pair_ks
    leaf_idxs[1::2] = 2 * pair_ks + 1
    if not verify_openings_rows(root, log_len, leaf_idxs, _leaf_rows(v0s, v1s), dec.hash_witness):
        return None
    return pair_ks, v0s, v1s


def verify_proof(proof: Proof, seed) -> bool:
    """Replay the transcript and check every decommitment and fold. Returns
    False for an invalid proof and never raises (reference: FriVerifier::commit
    Err => false, src/proof.rs:84-91), with one deliberate exception: panic
    parity with the reference when `evaluations` is shorter than the sampled
    query set (src/proof.rs:166-173), which raises IndexError.

    Host code (numpy and the native runtime), for a light client without a
    card: there is no device version. The runtime is built before the
    verdict's `try`, so a failed build raises."""
    native.library()
    try:
        with span("verify"):
            return _verify_proof_inner(proof, seed)
    except IndexError:
        raise  # panic parity: missing evaluations
    except Exception:  # noqa: BLE001 - a malformed proof object is invalid
        return False


def _qm31_array_or_none(lst):
    """(m, 4) uint64 array of a list of QM31 values, or None unless EVERY entry
    is a tuple of four integers in [0, P). Strict: each entry's type is
    checked, where the JAX package checks only the first entry's
    (`frieda_tpu/core/fri.py:872-873`) and so accepts a later list; the
    proofs `Proof.from_bytes` and `Proof.from_dict` make hold tuples."""
    if not lst:
        return np.zeros((0, 4), np.uint64)
    if any(type(f) is not tuple for f in lst):
        return None
    try:
        arr = np.asarray(lst)
    except (TypeError, ValueError, OverflowError):
        return None
    if arr.dtype.kind in "iu" and arr.ndim == 2 and arr.shape[1] == 4 and (arr >= 0).all() and (arr < P).all():
        return arr.astype(np.uint64)
    return None


def _replay_and_validate(proof: Proof, seed):
    """Shape checks and the Fiat-Shamir replay shared by `verify_proof` and
    `verify_many`. Returns None for an invalid proof, else (n, n_inner,
    queries, vals, alpha0, alphas, wit_arrays, hash_rows): the sorted unique
    query positions, their (m, 4) uint64 evaluation rows, the alphas, and
    each layer's FRI witness (m_t, 4) and hash witness (h_t, 8) rows. Raises
    IndexError if `evaluations` is shorter than the query set (panic parity).
    Unlike the JAX package (`frieda_tpu/core/fri.py:910-911`), an out-of-range
    `log_size_bound` or `proof_of_work` gives None, not False, so `verify_many`
    rejects that proof instead of raising TypeError."""
    try:  # FriVerifier::commit's fallible parse: malformed => invalid
        cfg = proof.pcs_config
        fri_cfg = cfg.fri_config
        log_size = int(proof.log_size_bound)
        pow_nonce = int(proof.proof_of_work)
        if not (0 <= log_size <= 48 and 0 <= pow_nonce < (1 << 64)):
            return None
        wit_arrays, hash_rows = [], []
        for layer in [proof.proof.first_layer] + list(proof.proof.inner_layers):
            if not isinstance(layer.commitment, bytes) or len(layer.commitment) != 32:
                return None
            w = _qm31_array_or_none(layer.fri_witness)
            if w is None:
                return None
            wit_arrays.append(w)
            hw = layer.decommitment.hash_witness
            try:
                joined = b"".join(hw)
            except TypeError:
                return None
            if len(joined) != 32 * len(hw):
                return None
            hash_rows.append(np.frombuffer(joined, np.uint32).reshape(-1, 8)
                             if joined else np.zeros((0, 8), np.uint32))
    except (AttributeError, TypeError, ValueError):
        return None
    # Config bounds checked here, not only by FriConfig's asserts (stripped by
    # `python -O`): a proof claiming blowup 0 would read past the twiddle
    # layer tables and raise instead of returning False.
    if not (1 <= fri_cfg.log_blowup_factor <= 16 and 0 <= fri_cfg.log_last_layer_degree_bound <= 10
            and fri_cfg.n_queries >= 1 and 0 <= cfg.pow_bits <= 60):
        return None
    n = log_size + fri_cfg.log_blowup_factor
    n_inner = n - 1 - (fri_cfg.log_last_layer_degree_bound + fri_cfg.log_blowup_factor)
    if n_inner < 0 or len(proof.proof.inner_layers) != n_inner:
        return None
    if len(proof.proof.last_layer_poly) != (1 << fri_cfg.log_last_layer_degree_bound):
        return None
    if _qm31_array_or_none(proof.proof.last_layer_poly) is None:
        return None

    channel = Blake2sChannel()
    if seed is not None:
        channel.mix_u64(seed)
    channel.mix_digest(proof.proof.first_layer.commitment)
    alpha0 = channel.draw_felt()
    alphas = []
    for layer in proof.proof.inner_layers:
        channel.mix_digest(layer.commitment)
        alphas.append(channel.draw_felt())
    channel.mix_felts(proof.proof.last_layer_poly)
    channel.mix_u64(proof.proof_of_work)
    if channel.trailing_zeros() < cfg.pow_bits:
        return None
    queries = sample_query_positions(channel, n, fri_cfg.n_queries)

    # Reference quirk: missing evaluations panic (IndexError), extras are invalid.
    values = [proof.evaluations[i] for i in range(len(queries))]
    if len(proof.evaluations) > len(queries):
        return None
    vals = _qm31_array_or_none(values)
    if vals is None:
        return None
    return n, n_inner, queries, vals, alpha0, alphas, wit_arrays, hash_rows


def _verify_proof_inner(proof: Proof, seed) -> bool:
    ctx = _replay_and_validate(proof, seed)
    if ctx is None:
        return False
    n, n_inner, queries, vals, alpha0, alphas, wit_arrays, _ = ctx
    layers = [proof.proof.first_layer] + list(proof.proof.inner_layers)
    positions, folded = queries, vals
    for t, layer in enumerate(layers):  # t = 0: circle -> line; then line folds
        grouped = _verify_layer_merkle(layer.commitment, n - t, positions, folded, wit_arrays[t],
                                       layer.decommitment)
        if grouped is None:
            return False
        pair_ks, v0s, v1s = grouped
        if t == 0:
            inv, alpha = hostcircle.ys_inv_at_stored_pairs(n, pair_ks), alpha0
        else:
            inv, alpha = hostcircle.line_x_inv_batch(n, t - 1, 2 * pair_ks), alphas[t - 1]
        folded = _fold_rows(v0s, v1s, npfield.qm31_arr([alpha]), inv)
        positions = pair_ks
    xs = hostcircle.line_x_batch(n, n_inner, positions)
    return bool(np.array_equal(_eval_line_poly_batch(proof.proof.last_layer_poly, xs), folded))


def verify_many(proofs, seeds) -> list:
    """Verdicts of a batch of independent proofs, in input order: equal to
    [verify_proof(p, s) ...], the IndexError panic included. The proofs of
    one shape (n, n_inner) walk their layers together (`_batched_layer_walk`);
    a group the batched walk fails on, and a shape with one proof, go
    through `_verify_proof_inner` one proof at a time. Host code, like
    `verify_proof`."""
    proofs, seeds = list(proofs), list(seeds)
    if len(proofs) != len(seeds):
        raise ValueError(f"{len(proofs)} proofs but {len(seeds)} seeds")
    native.library()
    results = [False] * len(proofs)
    groups: dict = {}
    ctxs: dict = {}
    for i, (pr, sd) in enumerate(zip(proofs, seeds)):
        try:
            ctx = _replay_and_validate(pr, sd)
        except IndexError:
            raise  # panic parity, as verify_proof
        except Exception:  # noqa: BLE001 - a malformed proof object is invalid
            ctx = None
        if ctx is not None:
            ctxs[i] = ctx
            groups.setdefault((ctx[0], ctx[1]), []).append(i)

    def one_by_one(members):
        for i in members:
            try:
                results[i] = _verify_proof_inner(proofs[i], seeds[i])
            except Exception:  # noqa: BLE001
                results[i] = False

    for (n, n_inner), members in groups.items():
        if len(members) == 1:
            one_by_one(members)
            continue
        try:
            oks = _batched_layer_walk(n, n_inner, [proofs[i] for i in members], [ctxs[i] for i in members])
        except Exception:  # noqa: BLE001 - the reference's semantics: fall back to one by one
            one_by_one(members)
            continue
        for i, ok in zip(members, oks):
            results[i] = bool(ok)
    return results


def _batched_layer_walk(n: int, n_inner: int, proofs, ctxs) -> np.ndarray:
    """Every layer of a same-shape batch on concatenated arrays: (P,) bool.

    Proof p's positions in a layer of log size L are offset by p << L. The
    offsets are even multiples of the layer's size, so pair grouping, parity
    and halving (k = pos >> 1 keeps the offset as p << (L - 1)) stay right on
    the flat array and no pair straddles two proofs; the witness rows
    concatenate proof by proof, in the order they are met. Each layer hashes
    its leaves in one native call and walks the P trees in another."""
    n_p = len(proofs)
    alive = np.ones(n_p, bool)
    pos_list = [np.asarray(c[2], np.int64) for c in ctxs]
    val_list = [c[3] for c in ctxs]
    for t in range(n_inner + 1):
        log_len = n - t
        layers = [p.proof.first_layer if t == 0 else p.proof.inner_layers[t - 1] for p in proofs]
        lens = np.array([x.size for x in pos_list], np.int64)
        offs = np.arange(n_p, dtype=np.int64) << log_len
        pos_all = np.concatenate([pos + offs[p] for p, pos in enumerate(pos_list)])
        seg_id = np.repeat(np.arange(n_p), lens)
        lone, keep = _pairs(pos_all)
        lone_count = np.bincount(seg_id[lone], minlength=n_p)
        wits = []
        for p in range(n_p):
            w = ctxs[p][6][t]
            if w.shape[0] != lone_count[p]:
                alive[p] = False
                w = np.zeros((lone_count[p], 4), np.uint64)  # keeps the others aligned
            wits.append(w)
        v0s, v1s = _fill_pairs(pos_all, np.concatenate(val_list), lone, keep, np.concatenate(wits))
        pair_count = np.bincount(seg_id[keep], minlength=n_p)
        pair_off = np.concatenate([[0], np.cumsum(pair_count)])
        local_ks = (pos_all[keep] >> 1) - (np.repeat(offs, pair_count) >> 1)
        leaf_idxs = np.empty(2 * local_ks.size, np.int64)
        leaf_idxs[0::2] = 2 * local_ks
        leaf_idxs[1::2] = 2 * local_ks + 1
        hash_wits = [ctxs[p][7][t] for p in range(n_p)]
        wseg = np.concatenate([[0], np.cumsum([w.shape[0] for w in hash_wits])])
        ok, roots = native.verify_openings_batch(log_len, 2 * pair_off, leaf_idxs, _leaf_rows(v0s, v1s),
                                                 wseg, np.concatenate(hash_wits))
        alive &= ok & np.array([roots[p].tobytes() == layers[p].commitment for p in range(n_p)])
        if t == 0:
            inv = hostcircle.ys_inv_at_stored_pairs(n, local_ks)
            a_rows = npfield.qm31_arr([c[4] for c in ctxs])
        else:
            inv = hostcircle.line_x_inv_batch(n, t - 1, 2 * local_ks)
            a_rows = npfield.qm31_arr([c[5][t - 1] for c in ctxs])
        folded = _fold_rows(v0s, v1s, np.repeat(a_rows, pair_count, axis=0), inv)
        pos_list = [local_ks[pair_off[p]:pair_off[p + 1]] for p in range(n_p)]
        val_list = [folded[pair_off[p]:pair_off[p + 1]] for p in range(n_p)]
    for p in range(n_p):  # the last layer: each proof's claimed polynomial at its positions
        if alive[p]:
            xs = hostcircle.line_x_batch(n, n_inner, pos_list[p])
            alive[p] = bool(np.array_equal(_eval_line_poly_batch(proofs[p].proof.last_layer_poly, xs),
                                           val_list[p]))
    return alive
