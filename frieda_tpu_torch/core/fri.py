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
staged words to the raw query words, and waits for nothing. The Fiat-Shamir
channel lives in device memory (`core/device_channel.py`, the `transcript`
and `grind` kernels of `ops/channel.py`): each layer's root is mixed from
its tree's device tensor, alpha is drawn where the next `fri_fold` reads it,
and the grind searches on the card. `finish_proof` then makes ONE fetch of
the transcript's outputs (the layer roots, the last-layer coefficients, a
degree flag, the nonce and the raw query words; the head of the JAX
package's packed vector, `_packed_layout`), deduplicates the queries on the
host and decommits: `merkle.Opening` reads exactly the values and nodes the
query set needs (`plan_openings`), in one `merkle_open` launch and one
fetch, where the JAX package gathers every raw query's full authentication
path into its packed vector.

The pipeline's device steps come in a `Route`: the kernel wrappers
(`KERNELS`) for callers, and any other route of the same signatures (the
plain versions, in chip_smoke.py) to check the kernels on the card.

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

import contextlib
import os
import time
import warnings
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
from ..utils.packing import log_total_for, upload_words
from ..utils.profiling import span
from . import circle as hostcircle
from . import fft, npfield
from .channel import Blake2sChannel, sample_query_positions
from .field import P, m31_add, m31_mul, m31_sub
from .merkle import MerkleDecommitment, Opening, build_pruned, compress_rows_host, verify_openings_rows
from .proof import FriLayerProof, FriProof, Proof

_INV2 = (P + 1) // 2


class Route(NamedTuple):
    """The device steps of the pipeline, with the kernel wrappers'
    signatures (int32 u32-bit tensors in and out)."""

    ingest: Callable  # (words, log_size) -> (4, 2^log_size) bit-reversed coefficients
    evaluate: Callable  # (coeffs, stage_twiddles(n)) -> (4, 2^n) evaluations
    level: Callable  # (x, leaf, fused) -> Merkle level
    collapse: Callable  # (level, out_widths) -> [levels]
    open: Callable  # (layers, trees, values, nodes) -> (4V + 8R,) the reads of an Opening
    fold: Callable  # (values (4, M), alpha (4,), inv (M/2,)) -> (4, M/2)
    transcript: Callable  # (state, mix_u64=, mix_digest=, mix_felts=, draw_felt=, queries=) -> (alpha, words)
    grind: Callable  # (state, pow_bits) -> (2,) nonce words (lo, hi)


KERNELS = Route(ingest_ops.ingest, fft.evaluate_auto, merkle_ops.merkle_level,
                merkle_ops.merkle_collapse, merkle_ops.merkle_open, fri_ops.fri_fold,
                channel_ops.transcript, channel_ops.grind)


# ---------------------------------------------------------------------------
# Folds and the last-layer interpolation (device tensors)
# ---------------------------------------------------------------------------

_fold_tables: dict = {}


def fold_tables(n: int, device):
    """(ys_inv, [xs_layers_inv[l]]) of the domain of log size n as int32
    tensors on `device` (one upload, cached per (n, device))."""
    key = (n, str(torch.device(device)))
    if key not in _fold_tables:
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
    output index. Counterpart of `fri._device_ifft_line`."""
    m = values.shape[1]
    x = values.to(torch.int64).reshape(4, 1, m)
    for d in range(m.bit_length() - 1):
        half = x.shape[2] // 2
        v0, v1 = x[:, :, :half], x[:, :, half:]
        s = m31_mul(m31_add(v0, v1), _INV2)
        dd = m31_mul(m31_mul(m31_sub(v0, v1), _INV2), xs_invs[depth + d][:half].to(torch.int64))
        x = torch.cat([s, dd], dim=1)
    return x[:, :, 0].T


# ---------------------------------------------------------------------------
# Pair grouping / witness planning (host index math, value-independent)
# ---------------------------------------------------------------------------

def _pair_groups(positions):
    """positions: sorted unique. Yields (pair_index, pos_in_set, lone) where
    lone is None if both elements of the pair are in the set, else the lone
    position present."""
    i = 0
    while i < len(positions):
        p = positions[i]
        if p % 2 == 0 and i + 1 < len(positions) and positions[i + 1] == p + 1:
            yield (p >> 1, (p, p + 1), None)
            i += 2
        else:
            yield (p >> 1, (p,), p)
            i += 1


def _all_leaf_indices(positions):
    out = []
    for k, _, _ in _pair_groups(positions):
        out.extend((2 * k, 2 * k + 1))
    return out


def _merkle_witness_plans(log_n: int, known_leaves):
    """Per-level sibling-hash indices needed for a multi-opening, walking
    bottom-up exactly like the verifier's Merkle check."""
    plans = []
    known = list(known_leaves)
    for _ in range(log_n):
        sibs = []
        nxt = []
        i = 0
        while i < len(known):
            idx = known[i]
            if i + 1 < len(known) and known[i + 1] == (idx ^ 1):
                i += 2
            else:
                sibs.append(idx ^ 1)
                i += 1
            nxt.append(idx >> 1)
        plans.append(sibs)
        known = nxt
    return plans


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
    layers and their trees on the device, and `packed`, the transcript's
    outputs on the device (int32: the layer roots (8 words each), the last
    layer's coefficients (4 words each), the degree flag, the nonce (lo,
    hi) and the raw query words). `roots`, `last_layer_poly`, `nonce` and
    `queries` make the one fetch of `packed` on first use (`fetch`) and
    keep it; `staging` holds the host buffer the words were uploaded from
    until then."""

    opening_cls = Opening  # the decommitment's reads (`merkle.ShardedOpening` for a sharded commit phase)

    def __init__(self, layers: list, trees: list, packed: torch.Tensor, bound: int, n_queries: int):
        self.layers = layers  # (4, N_t) int32 evaluations of each FRI layer, on the device (or `Sharded`)
        self.trees = trees  # their pruned trees (or `merkle.ShardedTree`)
        self.packed = packed
        self.bound = bound  # coefficients of the last layer
        self.n_queries = n_queries
        self.staging = None
        self._host = None

    def fetch(self) -> None:
        """The one fetch of the transcript's outputs (a no-op after the
        first). Raises AssertionError when the last layer exceeded its degree
        bound."""
        if self._host is not None:
            return
        with span("prove/fetch_packed"):
            words = to_numpy_u32(self.packed)
        t, b = len(self.trees), self.bound
        roots = [words[8 * i : 8 * (i + 1)].astype("<u4").tobytes() for i in range(t)]
        o = 8 * t
        last = words[o : o + 4 * b].reshape(b, 4)
        o += 4 * b
        if not words[o]:
            raise AssertionError("FRI last layer exceeds degree bound (internal bug)")
        nonce = int(words[o + 1]) | int(words[o + 2]) << 32
        raw = words[o + 3 : o + 3 + self.n_queries]
        self._host = (roots, [tuple(int(v) for v in row) for row in last], nonce,
                      sorted(set(int(q) for q in raw)), raw)
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


def commit_phase(words: torch.Tensor, log_total: int, seed,
                 pcs_config: PcsConfig = DEFAULT_CONFIG, route: Route = KERNELS,
                 clock: _Clock | None = None) -> Committed:
    """The commit phase of `prove_words`: the LDE, a pruned tree, a transcript
    step and a fold per layer, the last layer, the grind and the query draws,
    all enqueued on `words`' device; nothing waits for the device (tables
    not yet cached for this size are uploaded first). Counterpart of
    `_fri_commit_fn.run`.

    On the kernel route the folds go through this module's `fold_c` and
    `fold_l` (a caller may replace them); another route's `fold` is called
    as it is."""
    log_size, n, n_inner = _layer_sizes(log_total, pcs_config)
    device = words.device
    clock = clock or _Clock(device, None)
    circle_fold, line_fold = (fold_c, fold_l) if route.fold is KERNELS.fold else (route.fold, route.fold)
    with span("prove/device_dispatch(lde+merkle+transcript+grind)"):
        state = channel_ops.new_state(device)
        if seed is not None:
            with clock("transcript"):
                route.transcript(state, mix_u64=int(seed))

        def commit_layer(g):
            with clock("lde_trees"):
                tree = build_pruned(g, route.level, route.collapse)
            with clock("transcript"):
                alpha, _ = route.transcript(state, mix_digest=tree.root.reshape(8), draw_felt=True)
            layers.append(g)
            trees.append(tree)
            return alpha

        layers, trees = [], []
        with clock("lde_trees"):
            evals = route.evaluate(route.ingest(words, log_size), fft.stage_twiddles(n, device))
        alpha = commit_layer(evals)
        with clock("folds"):
            ys_inv, xs_invs = fold_tables(n, device)
            g = circle_fold(evals, alpha, ys_inv)
        for l in range(n_inner):
            alpha = commit_layer(g)
            with clock("folds"):
                g = line_fold(g, alpha, xs_invs[l])
        return _close_transcript(state, g, layers, trees, xs_invs, n, n_inner, pcs_config, route, clock)


def _close_transcript(state, g, layers, trees, xs_invs, n, n_inner, pcs_config, route, clock) -> Committed:
    """The end of a commit phase after the last fold: the last layer's
    coefficients and degree check, its transcript step, the grind and the
    query draws, and the transcript's outputs packed for the one fetch."""
    fri_cfg = pcs_config.fri_config
    bound = 1 << fri_cfg.log_last_layer_degree_bound
    with clock("folds"):
        coeffs = _device_ifft_line(g, xs_invs, n_inner)  # (2^last_log, 4) int64
        last_poly = narrow(coeffs[:bound]).contiguous()
        degree_ok = (coeffs[bound:] == 0).all().to(torch.int32).reshape(1)
    with clock("transcript"):
        route.transcript(state, mix_felts=last_poly)
    with clock("grind"):
        nonce = route.grind(state, pcs_config.pow_bits)
    with clock("transcript"):
        _, query_words = route.transcript(state, mix_u64=nonce, queries=(fri_cfg.n_queries, n))
        packed = torch.cat([t.root.reshape(8) for t in trees]
                           + [last_poly.reshape(-1), degree_ok, nonce, query_words])
    return Committed(layers, trees, packed, bound, fri_cfg.n_queries)


def commit_phase_sharded(words: torch.Tensor, log_total: int, seed, pcs_config: PcsConfig,
                         mesh, row: int) -> Committed:
    """`commit_phase` over the `elem` axis of mesh row `row` (this process's
    shards of it; `parallel/mesh.py`), the counterpart of `_fri_commit_fn`
    with a mesh (`frieda_tpu/core/fri.py:182-205`); the same roots, transcript
    and outputs as on one device. `words` lie on the row's home device.

    Layers at least 2S wide stay element-sharded in the cyclic layout: the
    extension runs per shard (`parallel/fft_sharded.sharded_evaluate`), each
    shard builds its pruned tree over its part (`merkle.build_sharded_tree`:
    a block of shards on one device in the launches of one tree, then the
    gathered subtree roots hashed to the root), and folds its part with
    `fri_fold` and its slice of the fold table (`block_fold_tables`). A layer
    narrower than 2S is gathered onto the home device and continues there,
    as on one device, and so does the last layer. The transcript and the
    grind run on the home device: one channel state for the in-process
    carrier, and one in each process of a process-group mesh, each the same
    (the JAX package's replicated channel). On one device nothing here waits
    for the device. The layers of the returned `Committed` are `Sharded` or
    tensors, its trees `ShardedTree` or `PrunedTree`, and its
    decommitment runs through `merkle.ShardedOpening`."""
    from ..parallel.fft_sharded import sharded_evaluate
    from ..parallel.mesh import Sharded, new_sharded
    from .merkle import ShardedOpening, build_sharded_tree

    log_size, n, n_inner = _layer_sizes(log_total, pcs_config)
    home, S = mesh.home(row), mesh.n_elem
    with span("prove/device_dispatch(lde+merkle+transcript+grind)"):
        state = channel_ops.new_state(home)
        if seed is not None:
            channel_ops.transcript(state, mix_u64=int(seed))
        coeffs = ingest_ops.ingest(words, log_size)
        ys_inv, xs_invs = fold_tables(n, home)
        if 1 << n >= 2 * S:
            g = sharded_evaluate(coeffs, n, mesh, row)
        else:
            g = fft.evaluate_auto(coeffs, fft.stage_twiddles(n, home))
        layers, trees = [], []
        for t in range(n_inner + 1):
            tree = build_sharded_tree(g) if isinstance(g, Sharded) else build_pruned(g)
            alpha, _ = channel_ops.transcript(state, mix_digest=tree.root.reshape(8), draw_felt=True)
            layers.append(g)
            trees.append(tree)
            if not isinstance(g, Sharded):
                g = fri_ops.fri_fold(g, alpha, ys_inv if t == 0 else xs_invs[t - 1])
                continue
            out = new_sharded(mesh, row, (4, g.blocks[0][1].shape[-1] // 2))
            for (e0, src), (_, dst) in zip(g.blocks, out.blocks):
                a = alpha.to(src.device)
                inv = block_fold_tables(mesh, n, e0, src.shape[0], src.device)[t]
                for i in range(src.shape[0]):
                    fri_ops.fri_fold(src[i], a, inv[i], out=dst[i])
            g = out if out.width >= 2 * S else out.gather()
        if isinstance(g, Sharded):
            g = g.gather()  # the last layer, at most 2^(llb + blowup) values: replicated
        committed = _close_transcript(state, g, layers, trees, xs_invs, n, n_inner, pcs_config, KERNELS,
                                      _Clock(home, None))
    committed.opening_cls = ShardedOpening
    return committed


def plan_openings(layers: list, trees: list, queries, opening_cls=Opening) -> tuple:
    """(opening, slice of the evaluations, [(slice of the FRI witness, [slices
    of the Merkle witness per level]) per layer]): every value and node a
    proof reveals, registered on one `Opening` (or `opening_cls`: the
    sharded commit phase's `merkle.ShardedOpening`)."""
    opening = opening_cls(layers, trees)
    eval_sl = opening.values(0, np.array(queries, np.int64))
    plan = []
    pos = list(queries)
    for t, tree in enumerate(trees):
        sibs = [lone ^ 1 for _, _, lone in _pair_groups(pos) if lone is not None]
        wit_sl = opening.values(t, np.array(sibs, np.int64))
        plans = _merkle_witness_plans(tree.log_leaves, _all_leaf_indices(pos))
        node_sls = [opening.nodes(t, k, np.array(s, np.int64)) for k, s in enumerate(plans) if s]
        plan.append((wit_sl, node_sls))
        pos = sorted({p >> 1 for p in pos})
    return opening, eval_sl, plan


def finish_proof(committed: Committed, log_total: int, pcs_config: PcsConfig = DEFAULT_CONFIG,
                 route: Route = KERNELS, clock: _Clock | None = None):
    """(commitment, Proof) of a commit phase: the one fetch of its
    transcript's outputs (which raises AssertionError for a last layer above
    its degree bound), then the decommitment (every revealed value and node
    in one `merkle_open` launch and one fetch) and the proof objects.
    Counterpart of `fri._finish_proof`."""
    c = committed
    clock = clock or _Clock(c.layers[0].device, None)
    with clock("transcript"):
        c.fetch()
    with clock("decommit_plan"):
        opening, eval_sl, plan = plan_openings(c.layers, c.trees, c.queries, c.opening_cls)
    with clock("decommit_open"):
        vals, nodes = opening.run(route.open)
    with clock("decommit_assemble"), span("prove/assemble"):
        node_rows = np.ascontiguousarray(nodes.T).astype("<u4")
        layer_proofs = [
            FriLayerProof(
                fri_witness=_qm31s(vals, wit_sl),
                decommitment=MerkleDecommitment(
                    [node_rows[j].tobytes() for sl in node_sls for j in range(sl.start, sl.stop)]),
                commitment=c.roots[t],
            )
            for t, (wit_sl, node_sls) in enumerate(plan)
        ]
        proof = Proof(
            proof=FriProof(layer_proofs[0], layer_proofs[1:], c.last_layer_poly),
            proof_of_work=c.nonce,
            pcs_config=pcs_config,
            log_size_bound=log_total - 2,
            evaluations=_qm31s(vals, eval_sl),
        )
    if clock.stats is not None:
        clock.stats["open_launches"] = opening.open_calls
    return c.roots[0], proof


def prove_words(words: torch.Tensor, log_total: int, seed,
                pcs_config: PcsConfig = DEFAULT_CONFIG, route: Route = KERNELS,
                stats: dict | None = None):
    """(commitment, Proof) for a blob given as its `pad_to_words(data,
    log_total)` words, int32, on the device that runs the proof: `commit_phase`
    then `finish_proof`. Counterpart of `fri.dispatch_commit_phase_staged` +
    `fri.finish_proof`.

    stats, when a dict, receives the host wall time of each stage
    (synchronized at both ends, so the commit phase then waits for the
    device at every stage: "lde_trees", "folds", "transcript" (with the one
    fetch), "grind", and the decommitment's "decommit_plan" (witness
    planning and registration), "decommit_open" (upload, `merkle_open`,
    fetch) and "decommit_assemble" (the proof objects)), each stage's kernel
    launches, and `open_launches`, the calls of the route's `open` step."""
    clock = _Clock(words.device, stats)
    return finish_proof(commit_phase(words, log_total, seed, pcs_config, route, clock),
                        log_total, pcs_config, route, clock)


def commit_and_generate_proof(data: bytes, seed, pcs_config: PcsConfig, device):
    """(commitment, Proof) of a blob on `device` (reference:
    src/proof.rs:32-77)."""
    log_total = log_total_for(len(data))
    with span("prove/ingest"):
        words = upload_words([data], log_total, device)[1][0]
    return prove_words(words, log_total, seed, pcs_config)


# ---------------------------------------------------------------------------
# Batch prover
# ---------------------------------------------------------------------------

# Peak bytes per domain element of one proof on the card, the tables cached
# for its size included: 10.069 GiB at a 2^26 domain (chip_smoke.py phase 9,
# NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 5).
ACTIVE_BYTES_PER_ELEMENT = 162
# Bytes per domain element that one finished commit phase (`Committed`: the
# evaluations 16, the folded layers ~16, the pruned trees ~9) keeps on the
# device until its decommitment: 41.49 at a 2^22 domain and 41.15 at 2^26,
# `torch.cuda.memory_allocated` around `commit_phase` (chip_smoke.py phase 9,
# NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6), rounded up.
RESIDENT_BYTES_PER_ELEMENT = 42


def device_memory_bytes(device: torch.device) -> int:
    """Total memory of the device that holds prove_many's window: the card's
    (`torch.cuda.mem_get_info`), or the host's for the CPU."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[1]
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def safe_in_flight(log_size: int, fri_cfg, device: torch.device) -> int:
    """Largest prove_many window for blobs of 2^log_size felts per column:
    60% of the device's memory, less one proof's peak, over the resident
    bytes of one `Committed`; at least 1."""
    n = 1 << (log_size + fri_cfg.log_blowup_factor)
    budget = int(0.6 * device_memory_bytes(device)) - ACTIVE_BYTES_PER_ELEMENT * n
    return max(1, budget // (RESIDENT_BYTES_PER_ELEMENT * n))


def prove_many(datas, seeds, pcs_config: PcsConfig = DEFAULT_CONFIG,
               max_in_flight: int | None = None, device: torch.device = torch.device("cuda")):
    """[(commitment, Proof)] of each blob under its seed, in input order, equal
    to a loop of `commit_and_generate_proof`: up to `max_in_flight` finished
    commit phases stay on the device before the oldest is decommitted.

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
        with span("prove/ingest"):
            host, words = upload_words([data], log_total, device)
        committed = commit_phase(words[0], log_total, seed, pcs_config)
        committed.staging = host  # the upload reads it asynchronously: kept until the fetch
        window.append((committed, log_total))
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
