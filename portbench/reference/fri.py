"""The plain reference of FRIDA's commit and prover, for a batch of blobs of
one size: what the benchmark holds the port's outputs to.

It follows the protocol as written (the upstream frieda library over
stwo's FRI, with the JAX package's numpy oracle as the executable spec of
the commit), not the port: stored-order domains, a BLAKE2s tree over every
level, folds as the formulas state them, the transcript on the host, the
grind as a search from nonce 0, and the decommitment read from the kept
levels. It imports nothing of the port or of the JAX package.

  packing   the blob's little-endian bit stream cut into 30-bit felts,
            padded to 2^max(ceil_log2(count), 2), four coordinate columns
  commit    the columns' circle evaluations on the domain of log size
            log_size + log_blowup_factor (stored order); leaf i = the raw
            compression of (c0[i], c1[i], c2[i], c3[i], 0 x 12), a parent
            the raw compression of left || right; root = 8 words LE
  prove     mix_u64(seed)?; per layer t = 0 .. n_inner: the layer's tree,
            mix its root, draw alpha_t, fold pairs (2k, 2k + 1):
            g = (v0 + v1) + alpha_t (v0 - v1) / y (t = 0) or / x (t > 0);
            the last layer's coefficients (the first 2^llb; the rest zero)
            mixed; the least nonce whose BLAKE2s-256(digest || nonce)
            has pow_bits trailing zeros, mixed; n_queries positions drawn;
            per layer the lone pair members' siblings and the sibling
            hashes a multi-opening needs; the wire bytes.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from . import blake2s
from .channel import Channel
from .circle import Domain, evaluate
from .field import P, add, mul, qm31_mul, sub

M32 = 0xFFFFFFFF
_INV2 = (P + 1) // 2


@dataclass(frozen=True)
class Protocol:
    log_blowup_factor: int
    log_last_layer_degree_bound: int
    n_queries: int
    pow_bits: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Protocol":
        return cls(cfg["log_blowup_factor"], cfg["log_last_layer_degree_bound"], cfg["n_queries"],
                   cfg["pow_bits"])


def log_total_for(n_bytes: int) -> int:
    n_felts = -(-(8 * n_bytes) // 30)
    return max(max(n_felts - 1, 0).bit_length(), 2)


def coefficients(blobs, device) -> tuple:
    """(log_total, (B, 4, 2^(log_total - 2)) int64 natural-order coefficients)
    of equal-length blobs: each 15-byte block gives 4 felts of 30 bits."""
    n = len(blobs[0])
    if any(len(b) != n for b in blobs):
        raise ValueError("a batch holds blobs of one length")
    log_total = log_total_for(n)
    n_felts = -(-(8 * n) // 30)
    blocks = -(-n // 15)
    raw = np.zeros((len(blobs), blocks * 15), np.uint8)
    for row, blob in zip(raw, blobs):
        row[:n] = np.frombuffer(blob, np.uint8)
    b = torch.from_numpy(raw).to(device).reshape(len(blobs), blocks, 15).to(torch.int64)
    f = torch.stack([
        b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | (b[..., 3] & 0x3F) << 24,
        b[..., 3] >> 6 | b[..., 4] << 2 | b[..., 5] << 10 | b[..., 6] << 18 | (b[..., 7] & 0x0F) << 26,
        b[..., 7] >> 4 | b[..., 8] << 4 | b[..., 9] << 12 | b[..., 10] << 20 | (b[..., 11] & 0x03) << 28,
        b[..., 11] >> 2 | b[..., 12] << 6 | b[..., 13] << 14 | b[..., 14] << 22,
    ], dim=-1).reshape(len(blobs), -1)
    out = torch.zeros((len(blobs), 1 << log_total), dtype=torch.int64, device=device)
    out[:, :n_felts] = f[:, :n_felts]
    return log_total, out.reshape(len(blobs), 4, -1)


def _flat(g: torch.Tensor) -> torch.Tensor:
    """(B, 4, N) -> (4, B N), blob-major lanes."""
    return g.permute(1, 0, 2).reshape(4, -1)


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _as_u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & M32


def tree(cols: torch.Tensor, blobs: int, keep: bool) -> list:
    """The levels of the `blobs` trees over (4, B N) blob-major leaf columns,
    leaves first and the B roots last, each (8, B W) int64; every level
    kept (as int32 bits) with `keep`, else the roots alone."""
    lanes = blake2s.LANES
    level = torch.cat([blake2s.compress(torch.cat([part, part.new_zeros(12, part.shape[1])]))
                       for part in cols.split(lanes, dim=1)], dim=1)
    levels = []
    while True:
        if keep:
            levels.append(_as_i32(level))
        if level.shape[1] == blobs:
            return levels if keep else [level]
        left, right = level[:, 0::2], level[:, 1::2]
        level = torch.cat([blake2s.compress(torch.cat([lp, rp]))
                           for lp, rp in zip(left.split(lanes, dim=1), right.split(lanes, dim=1))], dim=1)


def _root_bytes(top: torch.Tensor) -> list:
    """(8, B) root words -> B roots of 32 bytes."""
    words = _as_u32(top).cpu().numpy().astype("<u4")
    return [words[:, b].tobytes() for b in range(words.shape[1])]


def commit(blobs, log_blowup_factor: int, device) -> list:
    """The 32-byte root of each blob (equal lengths), as `api.commit`."""
    log_total, coeffs = coefficients(blobs, device)
    evals = evaluate(coeffs, Domain(log_total - 2 + log_blowup_factor, device))
    return _root_bytes(tree(_flat(evals), len(blobs), keep=False)[0])


def _interpolate(values: torch.Tensor, dom: Domain, d: int) -> torch.Tensor:
    """(..., M) stored-order values on line layer d -> (..., M)
    natural-order coefficients of the line polynomial."""
    if values.shape[-1] == 1:
        return values
    v0, v1 = values[..., 0::2], values[..., 1::2]
    g0 = mul(add(v0, v1), _INV2)
    g1 = mul(mul(sub(v0, v1), _INV2), dom.xs_inv(d))
    c0, c1 = _interpolate(g0, dom, d + 1), _interpolate(g1, dom, d + 1)
    return torch.stack([c0, c1], dim=-1).reshape(values.shape)


def grind(digests: list, pow_bits: int, device, chunk: int | None = None) -> list:
    """The least nonce of each channel digest whose BLAKE2s-256(digest ||
    nonce as 8 bytes LE) has at least pow_bits trailing zeros (of its first
    16 bytes read as a little-endian integer), searched from 0 in chunks of
    `chunk` nonces for every channel still searching."""
    chunk = chunk or max(256, min(1 << 20, 1 << pow_bits))
    words = torch.tensor([[int.from_bytes(d[4 * i : 4 * i + 4], "little") for i in range(8)] for d in digests],
                         dtype=torch.int64, device=device)
    found = [None] * len(digests)
    base = 0
    idx = torch.arange(chunk, dtype=torch.int64, device=device)
    group = max(1, (1 << 25) // chunk)
    while any(f is None for f in found):
        todo = [b for b, f in enumerate(found) if f is None]
        for g0 in range(0, len(todo), group):
            rows = todo[g0 : g0 + group]
            nonce = (base + idx).repeat(len(rows))
            msg = torch.zeros((16, len(rows) * chunk), dtype=torch.int64, device=device)
            msg[:8] = words[rows].T.repeat_interleave(chunk, dim=1)
            msg[8], msg[9] = nonce & M32, nonce >> 32
            out = blake2s.hash_one_block(msg, 40)
            if pow_bits <= 32:
                hit = (out[0] & ((1 << pow_bits) - 1)) == 0
            else:
                hit = (out[0] == 0) & ((out[1] & ((1 << (pow_bits - 32)) - 1)) == 0)
            none = 1 << 62
            best = torch.where(hit, nonce, none).reshape(len(rows), chunk).min(dim=1).values.tolist()
            for b, n in zip(rows, best):
                if n != none:
                    found[b] = n
        base += chunk
    return found


def _pairs_and_witness(pos: np.ndarray) -> tuple:
    """(the leaves of the pairs that sorted unique positions touch, the
    positions whose pair partner is not among them)."""
    pairs = np.unique(pos >> 1)
    leaves = np.stack([2 * pairs, 2 * pairs + 1], axis=1).reshape(-1)
    lone = pos[~np.isin(pos ^ 1, pos)]
    return leaves, lone


def _opening_plan(queries: list, n: int, n_layers: int) -> list:
    """Per layer t: (the value indices of the FRI witness, [(level j, node
    indices) of the hash witness]), in the proof's order."""
    pos = np.asarray(queries, np.int64)
    plan = []
    for t in range(n_layers):
        leaves, lone = _pairs_and_witness(pos)
        nodes = []
        known = leaves
        for j in range(1, n - t):
            known = np.unique(known >> 1)
            sib = known ^ 1
            nodes.append((j, sib[~np.isin(sib, known)]))
        plan.append((lone ^ 1, nodes))
        pos = np.unique(pos >> 1)
    return plan


def _qm31s(rows) -> bytes:
    out = struct.pack("<I", len(rows))
    return out + b"".join(struct.pack("<4I", *row) for row in rows)


def wire_bytes(nonce, log_size, proto: Protocol, roots, witnesses, hashes, last_poly, evaluations) -> bytes:
    """The proof's compact binary encoding: magic, header, each layer's
    commitment, FRI witness and hash witness, the last layer's coefficients,
    the evaluations (little-endian throughout)."""
    out = bytearray(b"FRTP\x01")
    out += struct.pack("<QIIIII", nonce, log_size, proto.pow_bits, proto.log_blowup_factor,
                       proto.log_last_layer_degree_bound, proto.n_queries)
    for t, (root, wit, hs) in enumerate(zip(roots, witnesses, hashes)):
        if t == 1:
            out += struct.pack("<I", len(roots) - 1)
        out += root + _qm31s(wit) + struct.pack("<I", len(hs)) + b"".join(hs)
    if len(roots) == 1:
        out += struct.pack("<I", 0)
    out += _qm31s(last_poly) + _qm31s(evaluations)
    return bytes(out)


def prove(blobs, seeds, proto: Protocol, device) -> list:
    """[(root, proof wire bytes)] of each blob (equal lengths) under its seed
    (an int, or None for no seed), as `api.commit_and_prove`."""
    log_total, coeffs = coefficients(blobs, device)
    B, log_size = len(blobs), log_total - 2
    n = log_size + proto.log_blowup_factor
    n_inner = n - 1 - proto.log_last_layer_degree_bound - proto.log_blowup_factor
    if n_inner < 0:
        raise ValueError("the last layer's degree bound leaves no fold")
    dom = Domain(n, device)
    chans = [Channel() for _ in range(B)]
    for ch, seed in zip(chans, seeds):
        if seed is not None:
            ch.mix_u64(seed)
    g = evaluate(coeffs, dom)
    layers, trees, roots = [], [], []
    for t in range(n_inner + 1):
        levels = tree(_flat(g), B, keep=True)
        layer_roots = _root_bytes(_as_u32(levels[-1]))
        alphas = []
        for ch, root in zip(chans, layer_roots):
            ch.mix_digest(root)
            alphas.append(ch.draw_felt())
        layers.append(_as_i32(g))
        trees.append(levels)
        roots.append(layer_roots)
        v0, v1 = g[..., 0::2], g[..., 1::2]
        w = mul(sub(v0, v1), dom.ys_inv() if t == 0 else dom.xs_inv(t - 1))
        alpha = torch.tensor(alphas, dtype=torch.int64, device=device)[:, :, None]
        g = add(add(v0, v1), qm31_mul(alpha, w, dim=1))
    coeffs_last = _interpolate(g, dom, n_inner).cpu().numpy()  # (B, 4, 2^(llb + lbf))
    bound = 1 << proto.log_last_layer_degree_bound
    if np.any(coeffs_last[:, :, bound:]):
        raise AssertionError("the last layer exceeds its degree bound")
    last = [[tuple(int(v) for v in coeffs_last[b, :, i]) for i in range(bound)] for b in range(B)]
    for ch, poly in zip(chans, last):
        ch.mix_felts(poly)
    nonces = grind([ch.digest for ch in chans], proto.pow_bits, device)
    queries = []
    for ch, nonce in zip(chans, nonces):
        ch.mix_u64(nonce)
        queries.append(ch.queries(n, proto.n_queries))
    plans = [_opening_plan(q, n, n_inner + 1) for q in queries]
    out = []
    evals = _gather_values(layers[0], [np.asarray(q, np.int64) for q in queries])
    wits = [_gather_values(layers[t], [p[t][0] for p in plans]) for t in range(n_inner + 1)]
    hashes = [_gather_nodes(trees[t], [p[t][1] for p in plans]) for t in range(n_inner + 1)]
    for b in range(B):
        out.append((roots[0][b], wire_bytes(nonces[b], log_size, proto, [r[b] for r in roots],
                                            [w[b] for w in wits], [h[b] for h in hashes], last[b], evals[b])))
    return out


def _gather_values(layer: torch.Tensor, idx: list) -> list:
    """Per blob b, the QM31 values (4-tuples) of (B, 4, W) `layer` at idx[b]."""
    counts = [len(i) for i in idx]
    if not sum(counts):
        return [[] for _ in idx]
    b_idx = torch.tensor(np.repeat(np.arange(len(idx)), counts), device=layer.device)
    at = torch.tensor(np.concatenate(idx), dtype=torch.int64, device=layer.device)
    rows = _as_u32(layer[b_idx, :, at]).cpu().numpy()
    rows = [tuple(int(v) for v in r) for r in rows]
    cut = np.r_[0, np.cumsum(counts)]
    return [rows[cut[b] : cut[b + 1]] for b in range(len(idx))]


def _gather_nodes(levels: list, plans: list) -> list:
    """Per blob b, the 32-byte nodes its plan [(level j, node indices)] names,
    in order, from the B trees' kept (8, B W) levels."""
    out = [[] for _ in plans]
    for j in range(1, len(levels)):
        width = levels[j].shape[1] // len(plans)
        parts = [p[j - 1][1] if j - 1 < len(p) else np.zeros(0, np.int64) for p in plans]
        counts = [len(x) for x in parts]
        if not sum(counts):
            continue
        at = np.concatenate([b * width + x for b, x in enumerate(parts)])
        words = _as_u32(levels[j][:, torch.tensor(at, dtype=torch.int64, device=levels[j].device)])
        words = words.cpu().numpy().astype("<u4").T
        cut = np.r_[0, np.cumsum(counts)]
        for b in range(len(plans)):
            out[b] += [row.tobytes() for row in words[cut[b] : cut[b + 1]]]
    return out


def wire_sections(wire: bytes) -> dict:
    """A proof's wire bytes cut into the sections the comparison names:
    the header, the nonce, each layer's root, FRI witness and hash witness
    (all layers together), the last layer and the evaluations."""
    off = 0

    def take(n):
        nonlocal off
        if off + n > len(wire):
            raise ValueError("truncated proof")
        off += n
        return wire[off - n : off]

    def u32():
        return struct.unpack("<I", take(4))[0]

    out = {"header": take(5) + wire[13:33]}
    out["nonce"] = take(8)
    take(20)
    roots, wits, hashes = [], [], []

    def layer():
        roots.append(take(32))
        wits.append(take(16 * u32()))
        hashes.append(take(32 * u32()))

    layer()
    for _ in range(u32()):
        layer()
    out.update(layer_roots=b"".join(roots), fri_witness=b"".join(wits), hash_witness=b"".join(hashes))
    out["last_layer"] = take(16 * u32())
    out["evaluations"] = take(16 * u32())
    if off != len(wire):
        raise ValueError("trailing bytes")
    return out
