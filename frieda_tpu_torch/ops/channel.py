"""Kernels 7 and 8, `transcript` and `grind`: the Fiat-Shamir channel on the
card, its state in device memory.

Replace the JAX package's device channel (`frieda_tpu/core/device_channel.py`:
the `dc_mix_*`, `dc_draw_*` and `dc_sample_query_words` steps, and
`dc_grind`), which XLA runs inside the FRI commit phase's one dispatch; no
Pallas kernel. Source: `csrc/channel.cu` (RFC BLAKE2s-256 from
`csrc/blake2s.cuh`). The plain versions are the `dc_*` functions of
`core/device_channel.py`.

The state is a (STATE_WORDS,) int32 tensor: the digest (words 0-7) and
n_sent (word 8). `transcript` runs, in one launch, the steps it is given, in
this order: mix_u64, mix_digest, mix_felts, draw_felt, the query draws; it
updates the state in place and returns the drawn alpha and query words as
new tensors. `grind` reads the digest and returns the minimum nonce as two
int32 words (lo, hi) on the device, which `transcript(mix_u64=...)` takes as
they are. Nothing here waits for the card.

A layer's step (mix the seed for layer 0, mix the root, draw alpha) is a
`ChannelStep`: the prover hands it to the `merkle_collapse` launch that ends
the layer's tree (`ops/merkle.py`), which runs it on the card, and
`run_step` runs it as one transcript call where a tree ends without a
collapse, and in the collapse's plain version.

A batch of B channels (the batched commit phase, the JAX package's vmap over
its device channel) is a (B, STATE_WORDS) state: each wrapper then takes a
(B, ...) tensor for each operand and runs every blob's steps in the same one
launch, and `grind` finds each blob's own minimum nonce.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core import device_channel as dc
from ..utils.convert import narrow, widen
from . import _build

STATE_WORDS = 9
_M64 = (1 << 64) - 1


class ChannelStep(NamedTuple):
    """One layer's step on the channel, run on its tree's root: mix `seed`
    ((2,) int32 words, or None), mix the root, draw alpha into `alpha`. A
    batch of B channels (the batched commit phase) has (B, ...) fields:
    states (B, STATE_WORDS), seeds (B, 2) or None, alphas (B, 4)."""

    state: torch.Tensor  # (STATE_WORDS,) or (B, STATE_WORDS) int32, updated in place
    seed: torch.Tensor | None
    alpha: torch.Tensor  # (4,) or (B, 4) int32, written


def check_step(step: ChannelStep) -> None:
    if step.seed is not None and not isinstance(step.seed, torch.Tensor):
        raise ValueError("a step's seed is (2,) int32 words on the device, or None")
    _check_steps(step.state, step.seed, None, None, None)
    _build.check_u32(step.alpha, "alpha", _lead(step.state) + (4,))
    _build.check_same_device(step.state, step.alpha)


def run_step(step: ChannelStep, root: torch.Tensor) -> None:
    """The step on `root` ((8,) or (8, 1) int32 words; a batch's (B, 8) or
    (B, 8, 1)) as one `transcript` launch, alpha written into
    `step.alpha`."""
    alpha, _ = transcript(step.state, mix_u64=step.seed, mix_digest=root.reshape(_lead(step.state) + (8,)),
                          draw_felt=True)
    step.alpha.copy_(alpha)


def new_state(device, blobs: int | None = None) -> torch.Tensor:
    """A fresh channel: zero digest, n_sent 0; with `blobs`, B fresh
    channels, (B, STATE_WORDS)."""
    shape = (STATE_WORDS,) if blobs is None else (blobs, STATE_WORDS)
    return torch.zeros(shape, dtype=torch.int32, device=device)


def _lead(state: torch.Tensor) -> tuple:
    """() for one channel's state, (B,) for a batch's."""
    return tuple(state.shape[:-1])


def _check_state(state: torch.Tensor) -> None:
    if state.dim() not in (1, 2) or (state.dim() == 2 and not state.shape[0]):
        raise ValueError(f"state: expected ({STATE_WORDS},) or (B >= 1, {STATE_WORDS}), got {tuple(state.shape)}")
    _build.check_u32(state, "state", _lead(state) + (STATE_WORDS,))


def _check_steps(state, mix_u64, mix_digest, mix_felts, queries) -> None:
    _check_state(state)
    lead = _lead(state)
    if isinstance(mix_u64, torch.Tensor):
        _build.check_u32(mix_u64, "mix_u64", lead + (2,))
        _build.check_same_device(state, mix_u64)
    if mix_digest is not None:
        _build.check_u32(mix_digest, "mix_digest", lead + (8,))
        _build.check_same_device(state, mix_digest)
    if mix_felts is not None:
        if mix_felts.dim() != len(lead) + 2 or mix_felts.shape[-1] != 4 or not mix_felts.shape[-2]:
            raise ValueError(f"mix_felts: expected {lead + ('k >= 1', 4)} QM31, got {tuple(mix_felts.shape)}")
        _build.check_u32(mix_felts, "mix_felts", lead + tuple(mix_felts.shape[-2:]))
        _build.check_same_device(state, mix_felts)
    if queries is not None:
        n_queries, log_domain = queries
        if n_queries < 0 or not 0 <= log_domain <= 32:
            raise ValueError(f"queries: expected (n >= 0, 0 <= log_domain <= 32), got {queries}")
    if not 1 <= dc.DRAW_BOUND <= 2 * dc.P:
        raise ValueError(f"device_channel.DRAW_BOUND must be in [1, 2P], got {dc.DRAW_BOUND}")


def transcript_plain(state: torch.Tensor, mix_u64=None, mix_digest=None, mix_felts=None,
                     draw_felt: bool = False, queries=None) -> tuple:
    """Plain version of `transcript`: the `dc_*` functions on the state's
    device (the draw's retry tests on the host). Same arguments and
    results; a batch runs blob by blob."""
    _check_steps(state, mix_u64, mix_digest, mix_felts, queries)
    if state.dim() == 2:
        def row(x, b):
            return x[b] if isinstance(x, torch.Tensor) else x

        outs = [transcript_plain(state[b], row(mix_u64, b), row(mix_digest, b), row(mix_felts, b), draw_felt,
                                 queries) for b in range(state.shape[0])]
        return tuple(None if o[0] is None else torch.stack(o) for o in zip(*outs))
    digest, n_sent = widen(state[:8]), widen(state[8])
    if mix_u64 is not None:
        if isinstance(mix_u64, torch.Tensor):
            v = widen(mix_u64)
            digest = dc.dc_mix_u64(digest, v[0], v[1])
        else:
            digest = dc.dc_mix_u64_const(digest, int(mix_u64) & _M64)
        n_sent = 0
    if mix_digest is not None:
        digest, n_sent = dc.dc_mix_digest(digest, widen(mix_digest)), 0
    if mix_felts is not None:
        digest, n_sent = dc.dc_mix_felts(digest, widen(mix_felts)), 0
    alpha = words = None
    if draw_felt:
        alpha, n_sent = dc.dc_draw_felt(digest, n_sent)
        alpha = narrow(alpha)
    if queries is not None:
        words, n_sent = dc.dc_sample_query_words(digest, n_sent, *queries)
        words = narrow(words)
    state[:8] = narrow(digest)
    state[8] = n_sent
    return alpha, words


def transcript(state: torch.Tensor, mix_u64=None, mix_digest=None, mix_felts=None,
               draw_felt: bool = False, queries=None) -> tuple:
    """One transcript launch: the steps given, in order, on the channel
    `state` (updated in place). mix_u64: an int (the seed) or (2,) int32
    words (lo, hi) on the device (the grind's nonce); mix_digest: (8,) int32
    root words; mix_felts: (k, 4) int32 QM31; draw_felt: draw alpha;
    queries: (n_queries, log_domain), the raw query words & (2^log_domain -
    1). Returns (alpha (4,) int32 or None, query words (n_queries,) int32 or
    None). A batch of B channels, state (B, STATE_WORDS), takes a (B, ...)
    tensor for each operand (an int mix_u64 is mixed into every channel)
    and returns (B, 4) and (B, n_queries), in the same one launch.
    Launches the kernel for a CUDA state, runs the plain version for a CPU
    state."""
    if not state.is_cuda:
        return transcript_plain(state, mix_u64, mix_digest, mix_felts, draw_felt, queries)
    _check_steps(state, mix_u64, mix_digest, mix_felts, queries)
    dev, lead = state.device, _lead(state)
    alpha = torch.empty(lead + (4,), dtype=torch.int32, device=dev) if draw_felt else None
    n_queries, log_domain = queries if queries is not None else (0, 0)
    words = torch.empty(lead + (n_queries,), dtype=torch.int32, device=dev) if queries is not None else None
    src = mix_u64 if isinstance(mix_u64, torch.Tensor) else None
    value = 0 if mix_u64 is None or src is not None else int(mix_u64) & _M64

    def ptr(t):
        return None if t is None or not t.numel() else t.data_ptr()

    _build.check_launch(_build.library().frieda_transcript(
        state.data_ptr(), int(mix_u64 is not None), ctypes.c_ulonglong(value), ptr(src), ptr(mix_digest),
        ptr(mix_felts), 0 if mix_felts is None else mix_felts.shape[-2], ptr(alpha), dc.DRAW_BOUND,
        ptr(words), n_queries, log_domain, state.shape[0] if lead else 1, _build.stream_of(state)))
    transcript.launches += 1
    return alpha, words


transcript.launches = 0


def grind_plain(state: torch.Tensor, pow_bits: int) -> torch.Tensor:
    """Plain version of `grind`: `dc_grind`'s sweep (one host test a batch),
    the nonce as (2,) int32 words (lo, hi) on the state's device; for a
    batch of channels (B, 2), blob by blob."""
    _check_state(state)
    rows = state.view(-1, STATE_WORDS)
    nonces = [dc.dc_grind(widen(row[:8]), pow_bits) for row in rows]
    return torch.tensor(nonces, dtype=torch.int64, device=state.device).view(torch.int32).view(_lead(state) + (2,))


GRIND_THREADS = 256  # a block (csrc/channel.cu kGrindThreads)
# k, the nonces a thread hashes an item, and at most GRIND_BLOCKS_PER_BLOB
# blocks an SM for each channel (of the 4 an SM holds at the kernel's 62
# registers): from a sweep over 1-4 blocks an SM and k = 1-16 at 1, 8 and
# 64 channels (tools/torch_grind_times.py; PERF.md section 6, NVIDIA H100
# 80GB HBM3 at 700 W). Smaller items pay the block's claim more often;
# larger items, or more blocks a channel, put more nonces in flight past a
# blob's minimum before its hit is seen: one channel's grind ran up to 4x
# its preset time at 4 blocks an SM, none at 2.
GRIND_NONCES = 4
GRIND_BLOCKS_PER_BLOB = 2


class GrindPlan(NamedTuple):
    """The grind's grid: `blocks` of `threads` that claim items of
    `width` = threads x `nonces` (k) nonces (csrc/channel.cu)."""

    blocks: int
    threads: int
    nonces: int

    @property
    def width(self) -> int:
        return self.threads * self.nonces

    def item(self, i: int, blobs: int) -> tuple:
        """Item i of a batch of `blobs`: (blob, base), the nonces
        [base, base + width) of blob i mod blobs, round i // blobs."""
        return i % blobs, i // blobs * self.width


def grind_plan(blobs: int, sms: int | None = None, blocks_per_sm: int | None = None, device=None) -> GrindPlan:
    """The plan of one grind launch over `blobs` channels: on each of the
    card's `sms` SMs, GRIND_BLOCKS_PER_BLOB blocks a channel, at most the
    `blocks_per_sm` an SM holds at once; k = GRIND_NONCES. `sms` and
    `blocks_per_sm` default to those of the CUDA `device` (the current one
    by default; `frieda_grind_shape`, read once a device)."""
    if blobs < 1:
        raise ValueError(f"blobs must be >= 1, got {blobs}")
    if sms is None or blocks_per_sm is None:
        sms, blocks_per_sm = _grind_shape(torch.device("cuda", torch.cuda.current_device()) if device is None
                                          else torch.device(device))
    if sms < 1 or blocks_per_sm < 1:
        raise ValueError(f"sms and blocks_per_sm must be >= 1, got {sms}, {blocks_per_sm}")
    return GrindPlan(sms * min(blocks_per_sm, GRIND_BLOCKS_PER_BLOB * blobs), GRIND_THREADS, GRIND_NONCES)


@functools.cache
def _grind_shape(device: torch.device) -> tuple:
    """(SMs, grind blocks an SM holds at once) of a CUDA device."""
    sms, per_sm = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        _build.check_launch(_build.library().frieda_grind_shape(ctypes.byref(sms), ctypes.byref(per_sm)))
    return sms.value, per_sm.value


def grind_buffer(blobs: int, device) -> torch.Tensor:
    """A grind launch's (blobs + 1,) int64 words, all 2^64 - 1: each blob's
    best, then the item counter."""
    return torch.full((blobs + 1,), -1, dtype=torch.int64, device=device)


def grind_launch(state: torch.Tensor, pow_bits: int, best: torch.Tensor, plan: GrindPlan) -> None:
    """One grind launch over the (B, STATE_WORDS) CUDA `state`, into `best`
    (`grind_buffer(B)`, or each blob's best set lower), with `plan`
    (`grind_plan`'s, or another grid or k: the C entry checks it)."""
    _check_state(state)
    blobs = state.shape[0]
    if state.dim() != 2 or best.dtype != torch.int64 or tuple(best.shape) != (blobs + 1,) or not best.is_contiguous():
        raise ValueError(f"grind_launch: expected (B, {STATE_WORDS}) states and (B + 1,) int64 words, got "
                         f"{tuple(state.shape)} and {tuple(best.shape)} {best.dtype}")
    _build.check_same_device(state, best)
    _build.check_launch(_build.library().frieda_grind(
        state.data_ptr(), pow_bits, best.data_ptr(), blobs, plan.blocks, plan.threads, plan.nonces,
        _build.stream_of(state)))
    grind.launches += 1


def grind(state: torch.Tensor, pow_bits: int) -> torch.Tensor:
    """The minimum nonce whose mix into the channel `state` clears pow_bits
    (0 <= pow_bits <= 60), as (2,) int32 words (lo, hi) on the state's
    device; for a batch of channels, (B, STATE_WORDS), each blob's own
    minimum as (B, 2). One kernel launch (`grind_plan`), the search on the
    card, for a CUDA state; the plain version for a CPU state."""
    if not 0 <= pow_bits <= 60:
        raise ValueError(f"pow_bits must be in [0, 60], got {pow_bits}")
    if not state.is_cuda:
        return grind_plain(state, pow_bits)
    _check_state(state)
    lead = _lead(state)
    rows = state.view(-1, STATE_WORDS)
    best = grind_buffer(rows.shape[0], state.device)
    grind_launch(rows, pow_bits, best, grind_plan(rows.shape[0], device=state.device))
    return best[:-1].view(torch.int32).view(lead + (2,))


grind.launches = 0
