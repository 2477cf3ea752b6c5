"""FRI prover on one device.

Counterpart of the prover half of `frieda_tpu/core/fri.py`; the proof wire
bytes are the JAX package's, byte for byte.

Transcript order (per proof), on the host channel (`core/channel.py`):
  mix_u64(seed)? -> mix first-layer Merkle root -> draw alpha0
  per inner layer: mix root -> draw alpha
  mix_felts(last layer coefficients) -> grind + mix_u64(nonce)
  -> sample query positions in the full domain.

Folds (stwo convention, no division by 2), on natural-order halves:
  circle->line: g[k] = (f(p) + f(-p)) + alpha * (f(p) - f(-p)) / y_p
  line:         g'[k] = (g(x) + g(-x)) + alpha * (g(x) - g(-x)) / x

Architecture. The JAX package runs the whole commit phase as one jitted
dispatch with a device-side transcript, to spare round trips to a remote
TPU. Here the device work is enqueued eagerly and the host drives the
channel: each layer's 32-byte root is fetched before its alpha is drawn (one
small sync per layer). The evaluations, every folded layer and every pruned
tree stay on the device until the queries are known; `merkle.Opening` then
reads exactly the values and nodes the deduplicated query set needs, in a
few launches and one fetch, where the JAX package gathers every raw query's
full authentication path into one packed vector (`_packed_layout`).

The pipeline's LDE and tree functions come in a `Route`: the kernel wrappers
(`KERNELS`) for callers, and any other route of the same signatures (the
plain versions, in chip_smoke.py) to check the kernels on the card.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, PcsConfig
from ..ops import ingest as ingest_ops
from ..ops import merkle as merkle_ops
from ..utils.convert import from_numpy_u32, to_numpy_u32
from ..utils.packing import log_total_for, pad_to_words
from . import circle as hostcircle
from . import fft
from .channel import Blake2sChannel, sample_query_positions
from .field import P, m31_add, m31_mul, m31_sub, qm31_mul
from .grind import grind
from .merkle import MerkleDecommitment, Opening, build_pruned, root_bytes
from .proof import FriLayerProof, FriProof, Proof

_INV2 = (P + 1) // 2


class Route(NamedTuple):
    """The device steps of the pipeline, with the kernel wrappers'
    signatures (int32 u32-bit tensors in and out)."""

    ingest: Callable  # (words, log_size) -> (4, 2^log_size) bit-reversed coefficients
    evaluate: Callable  # (coeffs, stage_twiddles(n)) -> (4, 2^n) evaluations
    level: Callable  # (x, leaf, fused) -> Merkle level
    collapse: Callable  # (level, out_widths) -> [levels]


KERNELS = Route(ingest_ops.ingest, fft.evaluate_auto, merkle_ops.merkle_level,
                merkle_ops.merkle_collapse)


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


def _fold(lo: torch.Tensor, hi: torch.Tensor, alpha, inv: torch.Tensor) -> torch.Tensor:
    """(lo + hi) + alpha * (lo - hi) * inv over (4, M) QM31 columns."""
    lo, hi = lo.to(torch.int64), hi.to(torch.int64)
    f1 = m31_mul(m31_sub(lo, hi), inv)
    return m31_add(m31_add(lo, hi), torch.stack(qm31_mul(alpha, tuple(f1)))).to(torch.int32)


def fold_c(evals: torch.Tensor, alpha, ys_inv: torch.Tensor) -> torch.Tensor:
    """(4, N) circle evaluations -> (4, N/2) line values (int32); the
    conjugate pairs are the two halves. alpha: QM31 tuple of ints."""
    half = evals.shape[1] // 2
    return _fold(evals[:, :half], evals[:, half:], alpha, ys_inv)


def fold_l(g: torch.Tensor, alpha, xs_inv: torch.Tensor) -> torch.Tensor:
    """(4, M) line values -> (4, M/2) next-layer values (int32); the ±x pairs
    are the two halves."""
    half = g.shape[1] // 2
    return _fold(g[:, :half], g[:, half:], alpha, xs_inv)


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
    dict (stats["stage_s"][name] accumulates seconds); a no-op otherwise."""

    def __init__(self, device: torch.device, stats):
        self.stats = stats
        self.sync = device.type == "cuda"
        if stats is not None:
            stats["stage_s"] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.stats is None:
            yield
            return
        if self.sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        if self.sync:
            torch.cuda.synchronize()
        stages = self.stats["stage_s"]
        stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0


def _qm31s(cols: np.ndarray, sl: slice) -> list:
    """QM31 tuples of the columns sl of a (4, V) array."""
    return [tuple(int(v) for v in cols[:, j]) for j in range(sl.start, sl.stop)]


def prove_words(words: torch.Tensor, log_total: int, seed,
                pcs_config: PcsConfig = DEFAULT_CONFIG, route: Route = KERNELS,
                stats: dict | None = None):
    """(commitment, Proof) for a blob given as its `pad_to_words(data,
    log_total)` words, int32, on the device that runs the proof. Counterpart
    of `fri.dispatch_commit_phase_staged` + `fri.finish_proof`.

    stats, when a dict, receives the host wall time of each stage
    (synchronized: "lde_trees", "folds", "transcript", "grind", "decommit")
    and `rebuild_launches`, the `merkle_level` launches of the decommitment's
    node rebuilds."""
    fri_cfg = pcs_config.fri_config
    log_size = log_total - 2
    n = log_size + fri_cfg.log_blowup_factor
    last_log = fri_cfg.log_last_layer_degree_bound + fri_cfg.log_blowup_factor
    n_inner = n - 1 - last_log
    if n_inner < 0:
        raise ValueError(
            f"config unsatisfiable: log_last_layer_degree_bound "
            f"{fri_cfg.log_last_layer_degree_bound} >= poly log size {log_size}")
    device = words.device
    clock = _Clock(device, stats)
    channel = Blake2sChannel()
    if seed is not None:
        channel.mix_u64(int(seed))

    def commit_layer(g):
        with clock("lde_trees"):
            tree = build_pruned(g, route.level, route.collapse)
        with clock("transcript"):
            root = root_bytes(tree.root)
            channel.mix_digest(root)
            alpha = channel.draw_felt()
        layers.append(g)
        trees.append(tree)
        roots.append(root)
        return alpha

    layers, trees, roots = [], [], []
    with clock("lde_trees"):
        evals = route.evaluate(route.ingest(words, log_size), fft.stage_twiddles(n, device))
    alpha = commit_layer(evals)
    with clock("folds"):
        ys_inv, xs_invs = fold_tables(n, device)
        g = fold_c(evals, alpha, ys_inv)
    for l in range(n_inner):
        alpha = commit_layer(g)
        with clock("folds"):
            g = fold_l(g, alpha, xs_invs[l])
    with clock("folds"):
        coeffs = to_numpy_u32(_device_ifft_line(g, xs_invs, n_inner))  # (2^last_log, 4)
    bound = 1 << fri_cfg.log_last_layer_degree_bound
    if coeffs[bound:].any():
        raise AssertionError("FRI last layer exceeds degree bound (internal bug)")
    last_layer_poly = [tuple(int(v) for v in row) for row in coeffs[:bound]]
    with clock("transcript"):
        channel.mix_felts(last_layer_poly)
    with clock("grind"):
        nonce = grind(channel, pcs_config.pow_bits, device)
    with clock("transcript"):
        channel.mix_u64(nonce)
        queries = sample_query_positions(channel, n, fri_cfg.n_queries)

    with clock("decommit"):
        opening = Opening(layers, trees)
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
        vals, nodes = opening.run(route.level)
        node_rows = np.ascontiguousarray(nodes.T).astype("<u4")
        layer_proofs = [
            FriLayerProof(
                fri_witness=_qm31s(vals, wit_sl),
                decommitment=MerkleDecommitment(
                    [node_rows[j].tobytes() for sl in node_sls for j in range(sl.start, sl.stop)]),
                commitment=roots[t],
            )
            for t, (wit_sl, node_sls) in enumerate(plan)
        ]
        proof = Proof(
            proof=FriProof(layer_proofs[0], layer_proofs[1:], last_layer_poly),
            proof_of_work=nonce,
            pcs_config=pcs_config,
            log_size_bound=log_size,
            evaluations=_qm31s(vals, eval_sl),
        )
    if stats is not None:
        stats["rebuild_launches"] = opening.rebuild_launches
    return roots[0], proof


def commit_and_generate_proof(data: bytes, seed, pcs_config: PcsConfig, device):
    """(commitment, Proof) of a blob on `device` (reference:
    src/proof.rs:32-77)."""
    log_total = log_total_for(len(data))
    words = from_numpy_u32(pad_to_words(data, log_total), device)
    return prove_words(words, log_total, seed, pcs_config)
