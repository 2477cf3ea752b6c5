"""Phase spans and the roofline of one CUDA card.

Counterpart of `frieda_tpu/utils/profiling.py`, without JAX:

* `span(name)`: the host's wall time of a phase, printed to stderr as
  `[span] name: 1.23 ms` when FRIEDA_SPANS is set to anything but "" or "0"
  (or to the stream `out`), as the JAX package prints it. While a profiler
  runs, every span is also a `torch.profiler.record_function` range, so its
  name shows in a `torch.profiler` trace on the CPU and on the card; where
  CUDA is available it is an NVTX range (`nsys profile`). A span never
  synchronizes: around work enqueued on the card its wall is the host's
  enqueue time, unless the code inside waits for the device itself (a
  fetch).

  The spans sit at the JAX package's sites, with its names: `api.commit`
  has "commit/ingest" (padding and upload) and
  "commit/device(unpack+lde+merkle)" (the enqueue and the root's fetch,
  where the host waits, as at `jax.device_get`); there is no
  "commit/host_tree_top", since the port ends the tree on the card.
  `core/fri.py` has "prove/ingest" (the blob's upload),
  "prove/device_dispatch(lde+merkle+transcript+grind)" (the commit phase's
  enqueue, single or sharded), "prove/fetch_packed" (`Committed.fetch`),
  "prove/assemble" (the proof objects) and "verify".

  The port's own spans, which the JAX package has not: inside
  "commit/ingest" and "prove/ingest" (and wherever `utils/packing.
  upload_words` runs), "ingest/pin" (the host buffer's allocation,
  page-locked for the card), "ingest/copy" (the blobs' bytes into it, over
  host threads from `packing.SPLIT_BYTES` on, and the zero tail) and
  "ingest/upload" (the enqueue of the copy to the device); inside "prove/assemble", "assemble/select" (the witnesses picked
  from the fetched vector) and "assemble/objects" (the proof objects);
  around the finishes of each dispatch of a `core/fri.prove_block` call
  (the one-card block pipeline; two a call of two or more blobs),
  "batch/finish" (the dispatch's one fetch, which waits for its replay,
  and every proof's assembly). Set-up
  spans fire on a cache miss only: "setup/kernels" (`ops/_build.library`'s
  first call: the sources' hash, a build if any, the load), "setup/tables"
  (a miss of `fft.stage_twiddles` or `fri.fold_tables`) and "setup/graph"
  (a captured commit phase's construction, `fri._CommitGraph`), which holds
  "setup/warm" (its eager warm-up commit) and "setup/capture" (the CUDA
  graph's capture).

* `span_totals()`: every span, when it closes, adds its wall to an
  in-memory table, {name: (count, seconds)} since the process started or
  since `reset_span_totals()`. It is the one record of the set-up spans
  that a benchmark can read after its warm-up, before which no profiler
  runs.

* The program's counters besides: `core/fri.grind_totals()` (proofs whose
  nonce reached the host, and the sum of nonce + 1; `reset_grind_totals`),
  `utils/packing.copy_counts()` (the ingest's copies made whole or split
  over host threads, and the chunks) and `core/fri.pipeline_counts()`
  (`prove_block` calls, their dispatches, and the finishes that ran while
  a later dispatch of the same call was enqueued; `reset_pipeline_counts`).

* The roofline: the least time a card could take for a function's work, the
  larger of its bytes over the card's memory rate and its integer
  instructions over the card's instruction rate. The work is the
  function's, never a kernel's: each input read once and each output
  written once (no twiddle table, job table or pass plan, no intermediate
  that a pipeline of launches writes and reads back), and the instructions
  are units of work (compressions, butterflies, fold elements) times a
  fixed per-unit floor. So a redesigned kernel is graded by the same
  yardstick as the one it replaces. `fft_roofline`, `merkle_roofline` and
  `commit_roofline` grade a measured time as the JAX package's do; one
  `*_bound` function a kernel family gives (least ms, "bytes" or
  "operations") for `chip_smoke.py` and `tools/torch_kernel_times.py`.

Ceilings and shares are None on the CPU and on a card missing from `CARDS`.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch


class Card(NamedTuple):
    """A card's peaks: device-memory bytes/s, and the SM count and maximum SM
    clock that give its integer-instruction rate."""

    hbm_bytes_s: float
    sms: int
    max_sm_clock_hz: float

    @property
    def int_instr_s(self) -> float:
        """Warp-lane integer instructions a second: every SM's 4 schedulers
        issue one 32-lane instruction a cycle at the maximum clock."""
        return self.sms * 4 * 32 * self.max_sm_clock_hz


# Keyed by `torch.cuda.get_device_name`. NVIDIA H100 SXM5 80GB data sheet:
# 3.35 TB/s of HBM3, 132 SMs, 1,980 MHz maximum SM clock (`nvidia-smi
# --query-gpu=clocks.max.sm`), so 132 x 4 x 32 x 1.98e9 = 33.45e12
# instructions a second. These are peaks at the 700 W power limit; a card
# set lower reaches less, so a share is stated with the card's limit.
CARDS = {
    "NVIDIA H100 80GB HBM3": Card(hbm_bytes_s=3.35e12, sms=132, max_sm_clock_hz=1.98e9),
}


def card_peaks(card: str | None = None) -> Card | None:
    """The peaks of the card named `card`, or with None of CUDA device 0 (its
    SM count read from `torch.cuda.get_device_properties`); None on the CPU
    and for a card missing from `CARDS`."""
    if card is not None:
        return CARDS.get(card)
    if not torch.cuda.is_available():
        return None
    peaks = CARDS.get(torch.cuda.get_device_name(0))
    return peaks and peaks._replace(sms=torch.cuda.get_device_properties(0).multi_processor_count)


def hbm_gbps(card: str | None = None) -> float | None:
    """Device-memory rate of the card (`card_peaks`), GB/s."""
    peaks = card_peaks(card)
    return peaks and peaks.hbm_bytes_s / 1e9


def int_instr_per_s(card: str | None = None) -> float | None:
    """Integer-instruction rate of the card (`card_peaks`): the compute
    ceiling of the roofline, counterpart of the JAX package's `vpu_ops` (the
    TPU's vector-unit integer rate)."""
    peaks = card_peaks(card)
    return peaks and peaks.int_instr_s


def spans_enabled() -> bool:
    """Whether spans print to stderr: FRIEDA_SPANS set and not "" or "0". The
    NVTX range, and the profiler range while a profiler runs, are emitted
    either way."""
    return os.environ.get("FRIEDA_SPANS", "") not in ("", "0")


_SENTINEL = object()
_TOTALS: dict = {}  # name -> [count, seconds] of every span closed (`span_totals`)


class SpanTotal(NamedTuple):
    count: int
    seconds: float


def span_totals() -> dict:
    """{name: SpanTotal(count, seconds)}: every span closed since the process
    started or since `reset_span_totals`, a copy."""
    return {name: SpanTotal(*t) for name, t in _TOTALS.items()}


def reset_span_totals() -> None:
    """Empty the table of `span_totals`."""
    _TOTALS.clear()


@contextlib.contextmanager
def span(name: str, out=_SENTINEL):
    """A named phase: a `torch.profiler.record_function` range while a
    profiler runs (outside one it records nothing and costs ~20 us of host
    time, so it is skipped), an NVTX range where CUDA is available, its host
    wall time added to `span_totals` and printed to `out` (by default stderr
    under FRIEDA_SPANS). Never synchronizes."""
    if out is _SENTINEL:
        out = sys.stderr if spans_enabled() else None
    nvtx = torch.cuda.is_available()
    traced = torch.autograd._profiler_enabled()
    with torch.profiler.record_function(name) if traced else contextlib.nullcontext():
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if nvtx:
                torch.cuda.nvtx.range_pop()
            total = _TOTALS.get(name)
            if total is None:
                _TOTALS[name] = [1, dt]
            else:
                total[0] += 1
                total[1] += dt
            if out is not None:
                print(f"[span] {name}: {dt * 1e3:.2f} ms", file=out, flush=True)


# ---------------------------------------------------------------------------
# Per-unit instruction floors on sm_90 (IADD3 adds three operands, LOP3 is any
# three-input logic, SHF.R.W a rotate, VIADDMNMX an add and an unsigned min,
# IMAD.WIDE.U32 a 32 x 32 -> 64-bit product, LEA.HI a shifted add). Each is
# the smaller of the count derived below and the SASS count of the unit's
# never-launched probe kernel when the floors were fixed (962, 7, 121;
# chip_smoke.py phase 2 prints the current build's beside these). A bound never reads a
# probe, so a redesign that saves instructions does not move its yardstick.
#
# BLAKE2s compression (csrc/blake2s.cuh), 10 rounds of 8 G functions:
#   G = 4 adds (a + b + m is one IADD3) + 4 x (LOP3 xor, SHF rotate) = 12,
#   80 G = 960, the feed-forward out[i] = v[i] ^ v[i + 8] 8 LOP3 -> 968; the
#   zero chaining state of a Merkle node (v0..v7 = 0) folds the first add and
#   the b ^ c xor of each of round 0's four column G's: -8 -> 960.
#   Probe: 962.
BLAKE2S_COMPRESS_INSTR = 960
# M31 butterfly a' = a + t b, b' = a - t b (csrc/fft.cu `butterfly`, the
# twiddle doubled once a round): t b as IMAD.WIDE.U32, LEA.HI (hi + lo >> 1)
# and VIADDMNMX (min(s, s - P)) = 3; a + u and a - u an IADD3 and a
# VIADDMNMX each = 4 -> 7. Probe: 7.
M31_BUTTERFLY_INSTR = 7
# QM31 fold element g = (lo + hi) + alpha (lo - hi) inv (csrc/fri.cu
# `fold_one`, alpha doubled once a launch; m31 add and sub 2 each, a product
# by a doubled operand 3): 4 (lo - hi) 8, the inverse doubled 1, 4 x inv 12,
# alpha x f: 16 products 48, their 8 sums 16, the (2 + i) twist and the 4
# coordinates 16; 4 (lo + hi) and 4 final sums 16 -> 117. Probe (which
# doubles alpha too): 121.
QM31_FOLD_INSTR = 117
# Bytes of the Fiat-Shamir channel's device state (ops/channel.new_state):
# 8 digest words and the draw counter.
CHANNEL_STATE_BYTES = 36


def least_ms(n_bytes: float, n_instr: float, card: str | None = None) -> tuple | None:
    """(least ms, "bytes" | "operations"): n_bytes over the memory rate or
    n_instr integer instructions over the instruction rate, whichever is
    longer, on `card` (`card_peaks`); None without its peaks."""
    peaks = card_peaks(card)
    if peaks is None:
        return None
    t_bytes, t_ops = n_bytes / peaks.hbm_bytes_s * 1e3, n_instr / peaks.int_instr_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _lde_work(columns: int, log_l: int, n: int) -> tuple:
    """(bytes, butterflies) of the extension of columns x 2^log_l coefficients
    to 2^n evaluations: log_l butterfly stages of 2^(n - 1) a column (the
    n - log_l stages below them act on a dilated input and are copies)."""
    return 4 * columns * ((1 << log_l) + (1 << n)), columns * log_l << (n - 1)


def _tree_work(log_leaves: int, top_log: int = 0, store_levels: bool = False) -> tuple:
    """(bytes, compressions) of a Merkle tree over 2^log_leaves 4-word leaves
    down to width 2^top_log: the leaves read, the top level written (every
    level from the leaf hashes up with `store_levels`); 2N - 2^top_log
    compressions."""
    n, top = 1 << log_leaves, 1 << top_log
    written = 2 * n - top if store_levels else top
    return 16 * n + 32 * written, 2 * n - top


def ingest_bound(n_words: int, n_coeffs: int, card: str | None = None) -> tuple | None:
    """`ingest`: n_words packed words read, n_coeffs M31 coefficients written
    (4 columns x 2^log_size a blob); bit moves, no arithmetic counted."""
    return least_ms(4 * (n_words + n_coeffs), 0, card)


def fft_pass_bound(columns: int, log_l: int, n: int, card: str | None = None) -> tuple | None:
    """The low-degree extension that `fft_pass` computes (`core/fft.
    evaluate_auto`): columns x 2^log_l coefficients to columns x 2^n
    evaluations. Its launches' twiddle reads and passes over the evaluations
    are the kernel's cost, not the function's."""
    n_bytes, butterflies = _lde_work(columns, log_l, n)
    return least_ms(n_bytes, butterflies * M31_BUTTERFLY_INSTR, card)


def fft_exchange_bound(pairs: int, halves_written: int = 2, card: str | None = None) -> tuple | None:
    """`fft_exchange`: one butterfly stage over `pairs` (lo, hi) pairs of two
    shards, both halves read and the kept ones (1 or 2) written."""
    return least_ms(4 * pairs * (2 + halves_written), pairs * M31_BUTTERFLY_INSTR, card)


def merkle_level_bound(width: int, leaf: bool, fused: bool, blobs: int = 1,
                       card: str | None = None) -> tuple | None:
    """`merkle_level` over `blobs` levels of `width` nodes: a leaf level reads
    (4, width) columns, an inner one (8, width) nodes; one level (leaf hashes,
    or width / 2 parents) or three fused (width / 8 out) is written."""
    out_w = width // (8 if fused else 1 if leaf else 2)
    compressions = (width if leaf else 0) + (7 * out_w if fused else 0 if leaf else out_w)
    n_bytes = (16 if leaf else 32) * width + 32 * out_w
    return least_ms(blobs * n_bytes, blobs * compressions * BLAKE2S_COMPRESS_INSTR, card)


def merkle_collapse_bound(m: int, widths=(1,), blobs: int = 1, card: str | None = None,
                          step: bool = False, seed: bool = False) -> tuple | None:
    """`merkle_collapse` of `blobs` levels of width m to the root, writing the
    levels of `widths`: m - 1 compressions a blob. With `step`, each blob's
    channel step on its root as well: its state read and written, alpha
    (16 bytes) written, 2 channel compressions (3 and its 8 seed bytes read
    with `seed`)."""
    n_bytes = blobs * 32 * (m + sum(widths))
    compressions = blobs * (m - 1)
    if step:
        n_bytes += blobs * (2 * CHANNEL_STATE_BYTES + 16 + (8 if seed else 0))
        compressions += blobs * (3 if seed else 2)
    return least_ms(n_bytes, compressions * BLAKE2S_COMPRESS_INSTR, card)


def merkle_open_bound(n_values: int, leaf, depth, card: str | None = None) -> tuple | None:
    """`merkle_open` of one opening: n_values value reads ((t, s) rows) and one
    node a (t, k, s) row, rebuilt from 2^depth stored nodes, or where `leaf`
    from 2^depth leaves' columns (`ops/merkle.open_plan`'s r and leaf). Bytes:
    the int64 rows, the values (16 bytes) and the 2^r leaves (16) or nodes
    (32) read, a value (16) and a node (32) written; (leaf + 1) 2^r - 1
    compressions a node."""
    leaf, r = np.asarray(leaf, np.int64), np.asarray(depth, np.int64)
    n_nodes = r.size
    n_bytes = 8 * (2 * n_values + 3 * n_nodes) + 32 * n_values + int((np.where(leaf, 16, 32) << r).sum()) \
        + 32 * n_nodes
    compressions = int(((leaf + 1) << r).sum()) - n_nodes
    return least_ms(n_bytes, compressions * BLAKE2S_COMPRESS_INSTR, card)


def merkle_open_queries_bound(nq: int, out_words: int, read_bytes: int, compressions: int,
                              card: str | None = None) -> tuple | None:
    """`merkle_open_queries` of one proof (`ops/merkle.open_queries_work`):
    the nq query words read, the distinct column entries and stored nodes
    its reads touch (`read_bytes`, each once) and its out_words written;
    `compressions`, the distinct hashes its distinct node reads need. A
    batch's launch of B proofs: the sums over them (B nq words, B proofs'
    output words, `open_queries_work` of the batch)."""
    return least_ms(4 * nq + read_bytes + 4 * out_words, compressions * BLAKE2S_COMPRESS_INSTR, card)


def order_openings_bound(nq: int, values: int, nodes: int, out_words: int, card: str | None = None) -> tuple | None:
    """`order_openings` of one proof: its nq query words read, the gathered
    words of the `values` values (16 bytes) and `nodes` nodes (32) it
    selects read once, and its out_words (counts, values, nodes and the
    zeros past them) written; no hashing. A batch's launch: the sums over
    its proofs."""
    return least_ms(4 * nq + 16 * values + 32 * nodes + 4 * out_words, 0, card)


def fri_fold_bound(half: int, card: str | None = None, blobs: int = 1, tables: int = 1) -> tuple | None:
    """`fri_fold` of `blobs` (4, 2 half) QM31 values to (4, half) each: the
    values, each blob's alpha and `tables` inverse tables of `half` words
    (1: shared by the blobs; `blobs`: one a row) read, the folds written."""
    return least_ms(4 * (blobs * (8 * half + 4 + 4 * half) + tables * half), blobs * half * QM31_FOLD_INSTR,
                    card)


def transcript_bound(message_bytes: int, drawn_bytes: int, compressions: int,
                     card: str | None = None, blobs: int = 1) -> tuple | None:
    """One `transcript` launch over `blobs` channels, each with the same
    steps: a channel's state read and written, its mixed message read, its
    drawn words written; `compressions` BLAKE2s compressions a channel."""
    return least_ms(blobs * (2 * CHANNEL_STATE_BYTES + message_bytes + drawn_bytes),
                    blobs * compressions * BLAKE2S_COMPRESS_INSTR, card)


def grind_bound(nonce, card: str | None = None) -> tuple | None:
    """`grind` that found `nonce` (a batch's: the nonce of each blob): each
    state read and nonce (8 bytes) written; nonce + 1 compressions a blob,
    one a candidate up to its minimum."""
    nonces = [nonce] if isinstance(nonce, int) else list(nonce)
    return least_ms(len(nonces) * (CHANNEL_STATE_BYTES + 8), sum(n + 1 for n in nonces) * BLAKE2S_COMPRESS_INSTR,
                    card)


def _roofline(kernel: str, n_bytes: int, n_instr: int, seconds: float, card: str | None, **counts) -> dict:
    peaks = card_peaks(card)
    out = {"kernel": kernel, "bytes_moved": n_bytes, **counts, "int_instructions": n_instr,
           "achieved_gbps": n_bytes / seconds / 1e9,
           **{f"{k}_per_s": v / seconds for k, v in counts.items()},
           "hbm_gbps": None, "int_instr_per_s": None, "hbm_seconds_at_sol": None,
           "int_seconds_at_sol": None, "bound": None, "min_seconds_at_sol": None, "sol_fraction": None}
    if peaks is not None:
        t_hbm, t_int = n_bytes / peaks.hbm_bytes_s, n_instr / peaks.int_instr_s
        out.update(hbm_gbps=peaks.hbm_bytes_s / 1e9, int_instr_per_s=peaks.int_instr_s,
                   hbm_seconds_at_sol=t_hbm, int_seconds_at_sol=t_int,
                   bound="bytes" if t_hbm >= t_int else "operations",
                   min_seconds_at_sol=max(t_hbm, t_int), sol_fraction=max(t_hbm, t_int) / seconds)
    return out


def fft_roofline(log_domain: int, seconds: float, columns: int = 4, log_l: int | None = None,
                 card: str | None = None) -> dict:
    """Roofline of the low-degree extension of `columns` polynomials of 2^log_l
    coefficients (default log_domain - 4, the reference blowup) to
    2^log_domain, measured in `seconds`.

    Unlike the JAX package's, the bytes are the function's (coefficients in,
    evaluations out), not its pass plan's: a plan with fewer passes would
    otherwise grade itself against a smaller yardstick. And the butterflies
    are the log_l executed stages, where the JAX package's count log_domain
    stages whatever log_l (equal at log_l = log_domain). `sol_fraction` is
    the least time over `seconds` (its `bound` the larger side)."""
    log_l = log_domain - 4 if log_l is None else log_l
    n_bytes, butterflies = _lde_work(columns, log_l, log_domain)
    return _roofline("circle_fft", n_bytes, butterflies * M31_BUTTERFLY_INSTR, seconds, card,
                     butterflies=butterflies)


def merkle_roofline(log_leaves: int, seconds: float, top_log: int = 0, store_levels: bool = False,
                    card: str | None = None) -> dict:
    """Roofline of a BLAKE2s Merkle tree over 2^log_leaves leaves (4 words
    each) down to width 2^top_log (the root by default; `merkle.
    device_levels` stops at 2^6 and keeps every level: `store_levels`),
    measured in `seconds`: the leaves read, the kept levels written, and
    2N - 1 compressions to the root (the JAX package's count)."""
    n_bytes, hashes = _tree_work(log_leaves, top_log, store_levels)
    return _roofline("merkle_blake2s", n_bytes, hashes * BLAKE2S_COMPRESS_INSTR, seconds, card,
                     hashes=hashes)


def commit_roofline(log_domain: int, seconds: float, log_l: int | None = None,
                    card: str | None = None) -> dict:
    """Roofline of the device commit (`api.commit_root_pipeline`): the packed
    words of 4 x 2^log_l felts (default log_domain - 4) in, the 32-byte root
    out; the extension's butterflies and the tree's compressions. The
    coefficients and the evaluations are the function's intermediates: a
    pipeline that writes and reads them back moves more bytes, but at every
    size the operations bound it by ~6x."""
    log_l = log_domain - 4 if log_l is None else log_l
    n_words = (30 * (4 << log_l) + 31) // 32 + 1  # utils/packing.words_for(log_l + 2)
    _, butterflies = _lde_work(4, log_l, log_domain)
    _, hashes = _tree_work(log_domain)
    n_instr = butterflies * M31_BUTTERFLY_INSTR + hashes * BLAKE2S_COMPRESS_INSTR
    return _roofline("commit_e2e", 4 * n_words + 32, n_instr, seconds, card,
                     butterflies=butterflies, hashes=hashes)
