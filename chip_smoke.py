#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FRIDA (`frieda_tpu_torch`) on one CUDA
card, end to end, and check it: the commit, the FRI prover, the batch
prover and the verifier.

    python3 chip_smoke.py

Phases, each printed as it runs:
  1. the card: `nvidia-smi` name and power limit, torch's device name, and
     the peaks of `frieda_tpu_torch/utils/profiling.py` that the bounds use
     (memory rate; the SM count read from the device, the maximum clock
     beside `nvidia-smi`'s clocks.max.sm);
  2. the kernel build from `frieda_tpu_torch/csrc/` (nvcc, into build/kernels/),
     and the integer instructions of one BLAKE2s compression, of one M31
     butterfly and of one QM31 fold element, counted in the built SASS
     (cuobjdump), each beside the fixed per-unit floor of utils/profiling
     that the bounds use (a difference is printed, not a failure);
  3. each of the ten kernels against its plain PyTorch version on the card,
     at the shapes the commit and prove paths give it, bit-equal, with the
     least time the card could take for the same work (bound, from
     utils/profiling: the function's bytes and its units of work times the
     fixed floors; each kernel's beside the Bound PERF.md listed before it,
     every share at most 1) and two times:
     "device" ms, the time of the call's launches alone on the card (CUDA
     events around a CUDA graph of 20 calls, divided by 20:
     `tools/torch_harness.device_ms`), and "call" ms, CUDA events around one
     Python call of the wrapper, which also hold the host's work (checks,
     allocations, ctypes) while the card waits (median of a few runs; the
     plain versions are timed this way only). `ingest` in each of its forms
     (`ingest_tile`): log_size 9 (per-element), 10, 11, 12 (1, 2, 4 tiles a
     block), 20 and 22 (8 tiles); `fft_pass` at n = 24 / log_l 20 and
     n = 26 / log_l 22, with each launch of its plan timed alone (bytes,
     TB/s, threads and dynamic shared memory a block); `merkle_collapse` at
     every width m = 2^0 ... 2^12 with width 1 and the prover's tail widths,
     so at every cluster size its plan picks (1 ... 16), timed at the widths
     the 2^24-felt proof's 22 trees give it (with their sum); the collapse
     with the channel step of a prover's tree (seed, root, alpha: the
     outputs, the state and alpha bit-equal to the plain collapse followed
     by `transcript_plain` at every width, with and without the seed, and
     with `DRAW_BOUND` lowered so that the draw retries on the card), timed
     with and without the step at the proof's widths, and the proof's
     channel in all (2 transcript launches and the steps' added time);
     `merkle_open`
     at the openings of a 2^20-felt / 64-query and a 2^24-felt / 20-query
     proof (their real layers, trees and queries, from `fri.commit_phase`
     and `fri.plan_openings`: the sharded decommitment's job-table form),
     with the chain floor of one launch and three dependent compressions;
     `merkle_open_queries` at the same proofs' layers and trees over their
     raw query words on the card and over a copy with repeated words (the
     gathers that the commit phase packs), and its sharded form over the
     same words at the same proofs' layers element-sharded over one mesh
     row on the card (2^24 / 20 q over S = 8, 2^20 / 64 q on row 1 of a
     (2, 4) mesh; the sharded commit phase's packed vector == one device's,
     its gathers == plain and == one device's); `order_openings` over the
     same proofs' gathers of the raw and the repeated words (== plain, and
     over the raw words == the decommitment the commit phase packs), timed
     with its bound; `fri_fold`, circle and line, at (4, 2^26), at
     the proof's first line fold (4, 2^25) and at (4, 2^7), under one block,
     and timed at each of the 2^24-felt proof's 22 folds (with their sum);
     `transcript`, every step (seed, root and alpha, last-layer felts, nonce
     and queries) on 64 seeded states against the host channel and the plain
     version, each step form timed beside the launch floor and its chain of
     compressions; `grind` at pow_bits 8, 16 and 20 against the plain sweep
     (and at 8 and 16 a host scan, `grind_host`'s loop): the minimum nonce,
     with its plan (blocks, k, W), its registers (phase 2) and, at 20,
     nvidia-smi's SM clock, power and temperature sampled beside launches
     run back to back;
     then the blob axis of `commit_many`, each batch
     bit-equal to the one-blob plain version per blob: `ingest` at 64 blobs
     of log_size 14 (tiles) and 3 of log_size 8 (per-element), `fft_pass`
     at C = 256 columns, n = 18, the fused leaf and inner `merkle_level` at
     (64, 4, 2^18) and (64, 8, 2^15), the one-level leaf and inner at
     (3, 4, 2^4) and (3, 8, 2^4), `merkle_collapse` at (64, 8, 4096) -> 1 and
     (3, 8, 2) -> 1; `fft_exchange` at the sharded path's shapes: the
     blocks of 8 virtual shards at 2^24 felts, log_blowup 2 (stage 2 of a
     (8, 4, 2^21) block) and log_blowup 1 (stages 1 and 2 of (8, 4, 2^20)),
     and two separate (1, 1, 4 x 2^21) shards keeping one half each;
  4. `api.commit(data, 4, device="cuda")` on synthetic blobs against anchor
     roots computed with the JAX package (`frieda_tpu.api.commit` on CPU);
  5. a 2^24-felt commit: the kernel path's root equals the plain path's root
     on the card; median commit time (call, and a CUDA graph's replay) and
     felts/s at 2^22 and 2^24 felts, each graded by
     `profiling.commit_roofline` (every key printed, the share at most 1);
  6. `api.commit_many`: 64 blobs of 2^16 felts equal a loop of `api.commit`
     (root 0 the 2^16 anchor), with the launches of one `api.commit`; 16
     blobs of 2^20 felts equal a loop; `COMMIT_MANY_ANCHORS` (the JAX
     package's roots of small batches); [] for no blob, ValueError for
     unequal padded sizes. At 64 x 2^16 and 16 x 2^20: the device ms of
     `commit_root_pipeline_batch` (graph replay) beside phase 5's one-blob
     commit of as many felts, a loop of `commit_root_pipeline` timed by call
     and as one CUDA graph, the whole calls of `commit_many` and of a loop
     of `api.commit` in turns (median of 3), felts/s, and the idle share of
     5 batched calls and of 5 loops (torch.profiler);
  7. `api.commit_with_tree`: at 2^16 felts the kernel route's `CommitTree`
     equals the plain route's (device="cpu"): root, evals, every level and
     `gather_nodes` at 64 indices a level; at 2^22 felts the root equals the
     anchor and `api.commit`'s, each level's nodes at 64 indices equal the
     host hash of their children, the launches are one one-level leaf and
     one one-level inner per level (no fused level, no collapse), and the
     device ms of `device_levels` sits beside the fused `root_level`'s;
  8. `api.commit_and_prove(..., device="cuda")` against the JAX package's
     proofs: the four cases of tests/data/frozen_proofs.json and two anchors
     (blake2s of the wire bytes), each commitment equal to `api.commit`;
     `api.verify` (host code) accepts each proof, and rejects a copy with
     one FRI witness felt flipped and the proof under another seed;
  9. the staged prove (`api.commit_and_prove_staged`, words on the card) at
     2^20 felts / 64 queries and 2^24 felts / 20 queries (pow_bits 20,
     log_blowup 4): at 2^24 the kernel path's root and proof bytes equal
     `portbench/reference/fri.prove`'s for the same blob and seed; the
     median prove time of three runs of a dispatch and its `finish_proof`,
     the decommitment's launches counted around each (`ops.launch_counts`),
     kernel launches per proof (`merkle_open_queries` and `order_openings`
     once, in the commit phase, `merkle_open` never, nothing in
     `finish_proof`;
     `fri_fold` once a layer, `transcript` twice, a channel step in each
     layer's collapse (`merkle_collapse.steps` == layers), `grind` once) and
     peak device
     memory (allocated: everything live at the peak of a proof whose commit
     phase is a graph replay, its instance's outputs included; and the
     reserved bytes, the instances' pools included); a warm eager `fri.commit_phase` run under
     `torch.cuda.set_sync_debug_mode("error")` with FRIEDA_SPANS=1 (it
     synchronizes nowhere, and its span prints), its
     host enqueue ms beside its device ms (CUDA events), and a
     `finish_proof` that makes exactly one synchronizing fetch (counted in
     "warn" mode) and launches nothing, whose proof bytes equal the warm
     proof's; the
     bytes one finished commit phase (`fri.Committed`) keeps on the card
     (`torch.cuda.memory_allocated` around `fri.commit_phase`) and the
     prove_many window that gives; `api.verify` accepts the proof and
     rejects a tampered copy, with verify's host ms (median of 5); ten whole
     proves with the spans (`utils/profiling.span`)
     and ten with a no-op in their place, in turns, the median of the first
     beside the spread of the second, the host's `assemble/select` ms a
     proof over them (`profiling.span_totals`) with `fri.select_counts()`
     (every proof cut from its ordered row), and an empty span's host cost; at
     2^20 felts a torch.profiler trace of `api.commit`,
     `api.commit_and_prove`, the staged prove and `api.verify` on the card
     holds every span name (`SPANS`), with `packing.copy_counts()` over its
     calls (the blob copied whole or split over threads);
 10. every kernel's launch count over each path: the commit phases (4-5,
     checked there), `commit_many` (6), `commit_with_tree` (7, the one-level
     `merkle_level` forms) and the prove phases (8-9): each must be > 0,
     except `merkle_open`, `merkle_open_queries`, `order_openings`,
     `fri_fold`, `transcript` and `grind` outside a proof, `merkle_open` (the sharded decommitment,
     phase 12) in the single-device proofs and `merkle_collapse` in
     `commit_with_tree`;
 11. `api.prove_many` on 8 blobs of 2^20 felts (64 queries, seeds 1-8): every
     kernel launched (> 0) by its first run, whose peak device memory is
     printed; then a loop of `api.commit_and_prove` and `prove_many` in
     turns (loop, prove_many, prove_many, loop), every commitment and wire
     byte equal to the first run's, with each wall and proofs/s (a later
     `prove_many`: 16 transcript launches, 8 x 20 channel steps); the
     window, and the card's idle share over one more `prove_many`
     (torch.profiler); `api.verify_many` on those 8, 2 tampered copies and 1
     under a wrong seed, with the phase 8 proofs (mixed shapes) equal to a
     loop of `api.verify`, and its ms/proof beside the loop's on the 11 of
     one shape (host clock, median of 5).

 12. the sharded path (`frieda_tpu_torch.parallel`) on virtual shards:
     meshes whose devices are cuda:0 repeated, so every shard's kernels run on
     the card. `sharded_commit_root` at 2^24 felts over S = 2, 4, 8, 16 shards
     (root == phase 5's 2^24 anchor); at log_blowup 2 and 1 over S = 8 (one and
     two `fft_exchange` stages; root == `api.commit` at that blowup);
     `sharded_commit_and_prove` at 2^24 felts / 20 queries over S = 8 (bytes
     == phase 9's proof, verify True, tampered copy False; one `fri_fold`
     launch a fold, a block of 8 shards in one), its commit phase
     under sync debug mode "error", its `finish_proof` after a graph replay
     with no synchronizing call (an event wait for the row's copy ahead) and
     no launch, and the same commit phase
     decommitted as a row of several blocks (`merkle.ShardedOpening` after
     the fetch: one `merkle_open`, the same bytes); `prove_many_sharded` on
     phase 11's 8 x 2^20 felts / 64 queries over a (2, 4) mesh (== phase 11's
     proofs; two batched commit phases of 4 blobs, phase 14: each kernel's
     launches those of two proofs, and a dispatch's 8 finishes no
     synchronizing call (an event wait), no launch), the per-blob
     route of meshes over several devices or a process group
     (`prove_many_per_blob`) on the same mesh (== phase 11's proofs, verify;
     each kernel's launches those of 8 proofs, a block's folds one launch
     each; a blob's finish an event wait, no launch), and
     `commit_roots_batch` on 16 x 2^20 felts over (2, 4) (== `api.commit_many`).
     Host (enqueue) and device ms of each beside the single-device path's, in
     turns in this phase (the sharded proof eager and as a graph replay), and
     the launches per kernel: every kernel launched in this phase, the sharded
     proofs' decommitment `merkle_open_queries` in their commit phases,
     `merkle_open` only in the decommitment of several blocks. The sharded
     proofs' launches are read from a second call: the first runs the eager
     warm-up and the capture of the commit phase's graph (phase 13).
 13. the commit phase as one dispatch (`fri.dispatch_words`: a CUDA graph
     captured once per configuration and blob count and replayed; phases
     8, 9, 11 and 12 already prove through it) against the eager
     `fri.commit_phase`, at 2^20 felts / 64 queries, 2^24 felts / 20
     queries and the 2^24 / 20 q proof over 8 virtual shards: proof bytes
     == eager's == the anchor (2^20), phase 9's (2^24, itself ==
     `portbench/reference`'s) and the single
     device's (sharded: its decommitment in the graph too); two `Committed` of one key alive at once (a second
     instance captured: its `torch.cuda.memory_reserved` growth per domain
     element beside `fri.RESIDENT_BYTES_PER_ELEMENT`), finished in reverse
     order, each == eager; one capture per key over repeated calls; launches
     per proof == eager's, `merkle_open_queries` inside the graph (a
     torch.profiler trace of one replay, behind a warm replay that takes
     the trace's lost first records (`traced_run`), holds each recorded
     launch), the replayed
     proof's nonce and its `grind` record's device ms and share of
     `grind_bound`; the dispatch (copy,
     seed fill, replay, the row's copy ahead) under sync debug mode "error",
     then a `finish_proof` with no synchronizing call (an event wait) and no
     launch; host enqueue, device
     and whole-prove ms of both, median of 5 in turns, and the words' copy.
     Then 9 keys (2^10 felts, 1-9 queries): the 9th evicts the least
     recently used, and the first is captured again; the cached tables
     cleared under a live graph (it holds them) and its proof unchanged;
     `prove_many` on phase 11's 8 x 2^20 felts: bytes == a loop, instances
     of its key <= its window, proofs/s against the loop in turns, idle
     share, peak allocated and reserved memory.
 14. the commit phase over a batch (`fri.commit_phase`, the JAX
     package's `_fri_commit_fn(..., batched=True)`), which
     `prove_many_sharded` runs as two graph replays of half the blobs each
     when every shard of its mesh lies on the card: each kernel's blob axis against a loop of its
     plain version at B = 1, 3 and 8 on phase 11's 2^20-felt / 64-query
     shapes, bit-equal (`fri_fold` with a shared table, a table a blob, one
     alpha and a table a row; the collapse with a channel step a blob, with
     and without seeds and with `DRAW_BOUND` lowered so that some blobs'
     draws retry and others' do not; `transcript`'s close forms; `grind` at
     pow_bits 8 and 20 and B = 1, 3, 8 and 64, each blob's nonce its own
     minimum and its one-blob launch's, each case's device ms, share, plan
     and registers, 8 and 64 channels beside as many one-channel launches,
     the SM clock beside the 8; `merkle_open_queries`
     over the batch's real layers, its `order_openings` == plain == the
     batch's packed decommitment, every
     packed row == its blob's batch of one's), each timed at B = 8 beside 8 one-blob
     launches and its bound; `prove_many_sharded` of 8 x 2^20 / 64 q over the
     card's (8, 1) and (2, 4) meshes: bytes == phase 11's, verify True,
     tampered False, two replays of 4 blobs a call, two captures for both
     (one key, an instance a dispatch in flight), `fri.pipeline_counts()`
     (1 call, 2 dispatches, 4 overlapped finishes) printed beside
     `packing.copy_counts()`, each dispatch's fetch read from its copy
     ahead, the first dispatch's rows == a lone batch's, launches per call
     beside 8 single replays' (each kernel once a layer a dispatch); two
     `dispatch_blobs` calls with their copies ahead under sync debug mode
     "error", their 8 finishes no synchronizing call (an event wait a
     dispatch) and no launch; device ms of one batched replay
     against 8 single replays, a trace of one batched replay behind a warm
     one holding each recorded launch, and whole-call ms of
     `prove_many_sharded` against `prove_many` (median of 5 in turns), idle
     share and peak memory of one profiled call each, the host's
     `assemble/select` ms a blob in each and `fri.select_counts()` (every
     proof cut from its ordered row); then a block at `frida-4844-r2`'s
     shape (9 blobs of 131,072 bytes, log_blowup 1, 70 queries, pow_bits
     20) through `prove_many_sharded` on a one-card mesh, 5 calls: roots
     and wire bytes == `portbench/reference/fri.prove`'s, every proof cut,
     `assemble/select` ms a blob and `batch/finish` ms a block.

Any mismatch, build failure or launch error exits nonzero. The last line is
`{"ok": true, "device": {...}}`; the line before it lists the kernels as JSON,
the collapse with the channel step as its own entry (`merkle_collapse+step`,
its launches the main path's `merkle_collapse.steps`), and the batched forms
of phase 14 as theirs (`fri_fold[batch]` ...: their launches those of phase
14's counted `prove_many_sharded`).
Without CUDA the script exits nonzero before printing any result.

    python3 chip_smoke.py --prove-fit 26

runs only phases 1-2 and one staged prove of 2^26 felts (20 queries,
pow_bits 20, log_blowup 4) and prints its time and peak device memory:
whether the largest blob the JAX bench names fits one card; then
`api.verify` accepts the proof (host ms) and rejects a tampered copy.

    python3 chip_smoke.py --commit-graph

runs only phases 1-2 and 13 (~1 min).

    python3 chip_smoke.py --batched

runs only phases 1-2 and 14 (~2 min).

    python3 chip_smoke.py --commit-split

runs only phases 1-2 and splits the commit at 2^22 and 2^24 felts into host
padding, upload, ingest, LDE, Merkle, device total and root fetch (CUDA
events or synchronized host clock, median of 9), with the device's idle
share over 5 back-to-back device-resident commits (torch.profiler).
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import hashlib
import io
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tools"))
from torch_harness import (card, clocks_beside, cuda_ms, device_busy_us, device_ms, host_ms,  # noqa: E402
                           proof_collapse_widths)

# The JAX package's span names on the paths phase 9 traces (utils/profiling),
# all but commit/host_tree_top: the port ends the tree on the card.
SPANS = ("commit/ingest", "commit/device(unpack+lde+merkle)", "prove/ingest",
         "prove/device_dispatch(lde+merkle+transcript+grind)", "prove/fetch_packed", "prove/assemble",
         "verify")

# (blob bytes, root of commit(synthetic_data(bytes), 4)): computed with the
# JAX package, frieda_tpu.api.commit on CPU; tests/test_torch_commit.py keeps
# them equal to it.
ANCHORS = (
    (3_840, "f537a5509e120d3d6ab276113d97adde1782533c0a145fb97db031fc10e15f8d"),        # 2^10 felts
    (15_360, "2296e465aaf47b30c5a4ffbd1fab6e63129d5b55154aa5159728a685e435bf4b"),       # 2^12 felts
    (245_760, "7b231e9ca986b0d666a5cd99739b5a6416e81631ed73b70e4ee351463c0c877a"),      # 2^16 felts
    (262_146, "02d73bf8e7d85048c1644f3058249355f5936881aa304e4500ceff84d56ced50"),      # reference fixture size
    (3_932_160, "e38617ac97faf85ac6babc5e23254b85f14bbab4b4c09b905656c14842ce80d1"),    # 2^20 felts
    (15_728_640, "2c68ea8df3200e5354beafef3e6b648b819f38f298544834b3a9d2ca34f5200c"),   # 2^22 felts
)
# (blob sizes, log_blowup, roots of commit_many([synthetic_data(size, seed=k)
# for the k-th size], log_blowup)): computed with the JAX package,
# frieda_tpu.api.commit_many on CPU; tests/test_torch_commit_many.py keeps
# them equal to it.
COMMIT_MANY_ANCHORS = (
    ((0, 1, 2), 4, ("4d2aedd405053903f84ec43cdb56ae3f83590bdb8248667c65299ae2a1cdd44f",
                    "2a179b2f1652114540b085542f8ac844946b76c4fd72baf11df87540825ae054",
                    "d7f8f442a2ac2bc582958b53106def61d8ee3a0b5c94baac9ebabf4b66cb7311")),   # log_total 2
    ((3_000, 3_500, 3_840), 4, ("32c0cca3e034f05824fd505b2489676766cd3e270fabaa0f471b9ed174ba503f",
                                "8389c8dd58b51c834e5afe48e7ebaea2ec868e168785d81b871abb4595b8496d",
                                "fe9e47e9bd2103da5124a7cfccef3fa2b7425b3b816e99fb164ed55b5734b9d2")),  # log_total 10
)
# Proofs of synthetic_data(data_len) beyond the frozen cases, as
# (name, data_len, seed, pcs_config dict, commitment, blake2s of the wire
# bytes): computed with the JAX package, frieda_tpu.api.commit_and_prove on
# CPU; tests/test_torch_prove.py keeps them equal to it.
PROVE_ANCHORS = (
    ("default_262146B", 262_146, 262_146,
     {"pow_bits": 20, "fri_config": {"log_blowup_factor": 4, "log_last_layer_degree_bound": 0,
                                     "n_queries": 20}},
     "02d73bf8e7d85048c1644f3058249355f5936881aa304e4500ceff84d56ced50",
     "6f857669b6fe83ca3347ca63cdbb407195553a908461ecc7ae708ca9228935e9"),
    ("felts2p20_64q", 3_932_160, 7,
     {"pow_bits": 20, "fri_config": {"log_blowup_factor": 4, "log_last_layer_degree_bound": 0,
                                     "n_queries": 64}},
     "e38617ac97faf85ac6babc5e23254b85f14bbab4b4c09b905656c14842ce80d1",
     "a5dd3db0fe11a9baa6e90932cb3bbc8ba4f8caf16a861b89b1268fe812e536f5"),
)
FROZEN = pathlib.Path(__file__).resolve().parent / "tests" / "data" / "frozen_proofs.json"
LOG_BLOWUP = 4
SEED = 20261016
P = (1 << 31) - 1

# The Bound column of PERF.md section 6 before utils/profiling (ms) for each
# kernel's line, from the helpers this script had then (the build's SASS counts, the
# launches' twiddle and job-table bytes); phase 3 prints it beside the bound
# from utils/profiling.
EARLIER_BOUNDS = {"ingest": 0.0388, "fft_pass": 0.1404, "fft_exchange": 0.1603, "merkle_level": 0.9046,
                  "merkle_collapse": 0.000118, "merkle_open": 0.000235, "fri_fold": 0.5208,
                  "transcript": 5.8e-8, "grind": 0.0427, "merkle_open_queries": None, "order_openings": None,
                  "merkle_collapse+step": None,
                  **dict.fromkeys(("fri_fold[batch]", "transcript[batch]", "grind[batch]",
                                   "merkle_collapse+step[batch]", "merkle_open_queries[batch]"))}
# The kernels line's entry for merkle_collapse launches that carry a layer's
# channel step; its launches are `merkle_collapse.steps` on the main path.
STEP_FORM = "merkle_collapse+step"
STEPS = "merkle_collapse.steps"  # the key of the steps in a phase's counts
BUILT = {}  # kernel -> its registers, barriers and spills from the build log (phase 2)
# SASS opcodes that are not integer work: memory, control, moves.
SASS_SKIP = {"LDG", "STG", "LDC", "ULDC", "S2R", "S2UR", "EXIT", "BRA", "NOP", "ISETP", "BAR",
             "BSSY", "BSYNC", "RET", "CS2R", "MOV", "UMOV"}


def synthetic_data(n_bytes: int, seed: int = 0) -> bytes:
    """The blob bench.py commits: byte i = (i + seed) mod 256."""
    return ((np.arange(n_bytes, dtype=np.uint32) + seed) % 256).astype(np.uint8).tobytes()


def felt_bytes(log_felts: int) -> int:
    """Blob size that fills 2^log_felts felts exactly (30 bits each)."""
    return (30 << log_felts) // 8


def tampered(proof):
    """A copy of a proof with one FRI witness felt changed (in the first layer
    that has a witness)."""
    from frieda_tpu_torch.core.proof import Proof

    bad = Proof.from_bytes(proof.to_bytes())
    layer = next(t for t in [bad.proof.first_layer, *bad.proof.inner_layers] if t.fri_witness)
    a, b, c, d = layer.fri_witness[0]
    layer.fri_witness[0] = ((a + 1) % P, b, c, d)
    return bad


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def say(msg: str) -> None:
    print(msg, flush=True)


def grind_form(blobs: int) -> str:
    """The grind launch's plan over `blobs` channels (blocks, threads, k, W)
    and its kernel's registers from the build's `-Xptxas -v` (phase 2)."""
    from frieda_tpu_torch.ops import channel as channel_ops

    plan = channel_ops.grind_plan(blobs)
    return (f"{plan.blocks} blocks of {plan.threads} threads, k {plan.nonces} nonces a thread an item, "
            f"W {plan.width}; {BUILT.get('grind_kernel', 'registers not read')}")


def sass_int_ops(so: pathlib.Path, *name_has: str) -> list:
    """Integer instructions (opcodes with modifiers) of the one SASS function
    whose name contains every string of `name_has`, without loads, stores,
    branches, moves (IMAD.MOV too) and special-register reads."""
    cuobjdump = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    body = [f for f in sass.split("Function : ") if all(h in f.split("\n", 1)[0] for h in name_has)]
    check(len(body) == 1, f"expected one SASS function named like {name_has}, found {len(body)}")
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*(?:\.[A-Z0-9_]+)*)", body[0])
    return [op for op in ops if op.split(".")[0] not in SASS_SKIP and not op.startswith("IMAD.MOV")]


def commit_split() -> int:
    """The commit's stages at 2^22 and 2^24 felts, and the device's idle share."""
    import torch

    from frieda_tpu_torch import api
    from frieda_tpu_torch.core import fft, merkle
    from frieda_tpu_torch.utils.convert import from_numpy_u32
    from frieda_tpu_torch.utils.packing import ingest_rev, log_total_for, pad_to_words

    dev = torch.device("cuda", 0)
    for log_felts in (22, 24):
        data = synthetic_data(felt_bytes(log_felts))
        log_total = log_total_for(len(data))
        log_size = log_total - 2
        pad_ms = host_ms(lambda: pad_to_words(data, log_total))
        host_words = pad_to_words(data, log_total)
        upload_ms = host_ms(lambda: from_numpy_u32(host_words, dev))
        words = from_numpy_u32(host_words, dev)
        tw = fft.stage_twiddles(log_size + LOG_BLOWUP, dev)
        ingest_ms = cuda_ms(lambda: ingest_rev(words, log_size), 9)
        coeffs = ingest_rev(words, log_size)
        lde_ms = cuda_ms(lambda: fft.evaluate_auto(coeffs, tw), 9)
        evals = fft.evaluate_auto(coeffs, tw)
        merkle_ms = cuda_ms(lambda: merkle.root_level(evals), 9)
        del coeffs, evals
        device_ms = cuda_ms(lambda: api.commit_root_pipeline(words, log_total, LOG_BLOWUP), 9)
        root = api.commit_root_pipeline(words, log_total, LOG_BLOWUP)
        fetch_ms = host_ms(lambda: root.cpu())
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                api.commit_root_pipeline(words, log_total, LOG_BLOWUP)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy_us, records = device_busy_us(prof)
        averaged_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                          for e in prof.key_averages())
        say(f"[split] commit 2^{log_felts} felts (domain 2^{log_size + LOG_BLOWUP}), ms: "
            f"pad_to_words {pad_ms:.4f}, upload {upload_ms:.4f}, ingest {ingest_ms:.4f}, "
            f"LDE {lde_ms:.4f}, Merkle {merkle_ms:.4f}, device {device_ms:.4f}, root fetch "
            f"{fetch_ms:.4f}; idle share {1 - busy_us / wall_us:.3f} (device busy {busy_us:.0f} us "
            f"in {records} device records, of {wall_us:.0f} us over 5 commits; the sum of "
            f"key_averages' self device time: {averaged_us:.0f} us)")
        del words, root
        torch.cuda.empty_cache()
    return 0


def prove_fit(log_felts: int) -> int:
    """One staged prove of 2^log_felts felts on the card: time, stages, peak
    device memory."""
    import torch

    from frieda_tpu_torch import api
    from frieda_tpu_torch.config import FriConfig, PcsConfig
    from frieda_tpu_torch.core import fri
    from frieda_tpu_torch.utils.convert import from_numpy_u32
    from frieda_tpu_torch.utils.packing import log_total_for, pad_to_words

    dev = torch.device("cuda", 0)
    cfg = PcsConfig(pow_bits=20, fri_config=FriConfig(LOG_BLOWUP, 0, 20))
    data = synthetic_data(felt_bytes(log_felts))
    log_total = log_total_for(len(data))
    words = from_numpy_u32(pad_to_words(data, log_total), dev)
    del data
    domain = 1 << (log_total - 2 + LOG_BLOWUP)
    t0 = time.perf_counter()
    _, proof = api.commit_and_prove_staged(words, log_total, 7, cfg)  # tables, warm-up and capture on first use
    torch.cuda.synchronize()
    say(f"[fit] first prove of 2^{log_felts} felts through the commit phase's graph (host tables, eager "
        f"warm-up and capture included): {time.perf_counter() - t0:.3f} s; proof {wire_note(proof)}; "
        f"reserved {torch.cuda.memory_reserved(dev) / 2**30:.3f} GiB")
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved(dev)
    first = fri.dispatch_words(words[None], log_total, [7], cfg)[0]
    t0 = time.perf_counter()
    second = fri.dispatch_words(words[None], log_total, [7], cfg)[0]  # `first` holds its lease: a second instance
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    grown = torch.cuda.memory_reserved(dev) - reserved0
    check(grown <= fri.RESIDENT_BYTES_PER_ELEMENT * domain, f"2^{log_felts} felts: a second instance grew "
          f"memory_reserved {grown / domain:.3f} bytes per domain element, above "
          f"fri.RESIDENT_BYTES_PER_ELEMENT {fri.RESIDENT_BYTES_PER_ELEMENT}")
    graph_bytes = [fri.finish_proof(c, log_total, cfg)[1].to_bytes() for c in (second, first)]
    del first, second
    say(f"[fit] a second live Committed captured a second instance in {capture_s:.3f} s: memory_reserved "
        f"+{grown} bytes = {grown / domain:.3f} bytes per domain element (fri.RESIDENT_BYTES_PER_ELEMENT "
        f"{fri.RESIDENT_BYTES_PER_ELEMENT}); prove_many window "
        f"{fri.safe_in_flight(log_total - 2, cfg.fri_config, dev)}")
    fri.clear_commit_graphs()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    _, eager = fri.finish_proof(fri.commit_phase(words[None], log_total, [7], cfg)[0], log_total, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(graph_bytes == [proof.to_bytes()] * 2 and eager.to_bytes() == proof.to_bytes(),
          f"2^{log_felts} felts: the graph proofs != the eager proof")
    peak = torch.cuda.max_memory_allocated(dev)
    free, total = torch.cuda.mem_get_info(dev)
    say(f"[fit] eager staged prove 2^{log_felts} felts, 20 queries, pow 20 (domain 2^{log_total - 2 + LOG_BLOWUP}): "
        f"{wall * 1e3:.3f} ms; bytes == the graph's; peak device memory "
        f"{peak} bytes = {peak / 2**30:.3f} GiB of {total / 2**30:.3f} GiB ({peak / domain:.1f} "
        f"bytes per domain element)")
    t0 = time.perf_counter()
    ok = api.verify(proof, 7)
    verify_ms = (time.perf_counter() - t0) * 1e3
    check(ok, f"2^{log_felts}-felt proof: verify is False")
    check(not api.verify(tampered(proof), 7), f"2^{log_felts}-felt proof: a tampered copy verifies")
    say(f"[fit] verify 2^{log_felts}-felt proof: True in {verify_ms:.3f} ms (host); tampered copy False")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a CUDA card",
              file=sys.stderr)
        return 1

    from frieda_tpu_torch import api, ops
    from frieda_tpu_torch.config import FriConfig, PcsConfig
    from frieda_tpu_torch.core import device_channel as dc
    from frieda_tpu_torch.core import fft, fri, merkle
    from frieda_tpu_torch.core import grind
    from frieda_tpu_torch.core.channel import Blake2sChannel
    from frieda_tpu_torch.ops import _build
    from frieda_tpu_torch.ops import channel as channel_ops
    from frieda_tpu_torch.ops import fft as fft_ops
    from frieda_tpu_torch.ops import fri as fri_ops
    from frieda_tpu_torch.ops import ingest as ingest_ops
    from frieda_tpu_torch.ops import merkle as merkle_ops
    from frieda_tpu_torch.core.circle import bitrev_array
    from frieda_tpu_torch.parallel import sharding
    from frieda_tpu_torch.utils import profiling
    from frieda_tpu_torch.utils.convert import from_numpy_u32, narrow, to_numpy_u32, widen
    from frieda_tpu_torch.utils.packing import log_total_for, pad_to_words, words_for

    t_start = time.perf_counter()

    def lap(phase: int) -> None:
        say(f"[{phase}] phase {phase} ended {time.perf_counter() - t_start:.1f} s into the run")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    def rand_u32(shape, hi=1 << 32):
        return from_numpy_u32(rng.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32), dev)

    def max_abs_err(a, b) -> int:
        return int((widen(a) - widen(b)).abs().max().item())

    def collapse_steps() -> int:
        """The merkle_collapse launches that carried a channel step since the
        counts were last set to 0."""
        return merkle_ops.merkle_collapse.steps

    fit = sys.argv[sys.argv.index("--prove-fit") + 1] if "--prove-fit" in sys.argv else None
    split = "--commit-split" in sys.argv
    graph_only = "--commit-graph" in sys.argv
    batched_only = "--batched" in sys.argv

    # -- 1. the card ---------------------------------------------------------
    smi = card()
    say(f"[1] nvidia-smi: {smi}")
    say(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device 0: {torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}")
    peaks = profiling.card_peaks()
    check(peaks is not None, f"utils/profiling.CARDS has no peaks for {torch.cuda.get_device_name(0)}: "
          "the kernels' bounds need them")
    say(f"[1] peaks (utils/profiling): device memory {peaks.hbm_bytes_s / 1e12} TB/s; integer instructions "
        f"{peaks.sms} SMs (torch.cuda.get_device_properties) x 4 x 32 x {peaks.max_sm_clock_hz / 1e9} GHz "
        f"= {peaks.int_instr_s:.6g}/s; nvidia-smi clocks.max.sm: {card('clocks.max.sm')}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    say(f"[2] kernels built in {time.perf_counter() - t0:.1f} s: {so}")
    kernel, spills = "?", ""
    for line in (so.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:  # ptxas -v: entry, then spills, then registers
            mangled = line.split("'")[1]
            kernel = re.search(r"([a-z_]+_kernel|frieda_\w+)", mangled).group(1)
            targs = re.findall(r"L[bj](\d+)E", mangled)
            kernel += f"<{', '.join(targs)}>" if targs else ""
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            BUILT[kernel] = f"{line.split(':', 1)[1].strip()}; {spills}"
            say(f"[2]   {kernel}: {BUILT[kernel]}")
    bfly = sass_int_ops(so, "frieda_fft_butterfly_probe")
    say(f"[2] the M31 butterfly probe's SASS: {' '.join(bfly)}")
    for what, probe, fixed in (
            ("one BLAKE2s compression", "frieda_blake2s_probe", profiling.BLAKE2S_COMPRESS_INSTR),
            ("one M31 butterfly on one column (twiddle doubled once per round)", "frieda_fft_butterfly_probe",
             profiling.M31_BUTTERFLY_INSTR),
            ("one QM31 fold element (alpha and the inverse doubled)", "frieda_fri_fold_probe",
             profiling.QM31_FOLD_INSTR)):
        count = len(sass_int_ops(so, probe))
        note = "equal" if count == fixed else f"differs by {count - fixed:+d}; the bounds keep the floor"
        say(f"[2] {what}: {count} integer instructions in the SASS; the bounds' fixed floor "
            f"(utils/profiling) {fixed} ({note})")
    if fit is not None:
        return prove_fit(int(fit))
    if split:
        return commit_split()
    if graph_only:
        graph_phase(dev)
        say(f"[13] whole run {time.perf_counter() - t_start:.1f} s")
        return 0
    if batched_only:
        batched_phase(dev, {})
        say(f"[14] whole run {time.perf_counter() - t_start:.1f} s")
        return 0

    # -- 3. each kernel against its plain version, at main-path shapes --------
    kernels = {}

    for log_size in (9, 10, 11, 12, 20, 22):  # every tile form: 0, 1, 2, 4, 8 tiles a block
        words = rand_u32((words_for(log_size + 2),))
        w64 = widen(words)
        want = narrow(ingest_ops.ingest_plain(w64, log_size))
        got = ingest_ops.ingest(words, log_size)
        check(torch.equal(got, want), f"ingest log_size={log_size} differs from plain")
        plan = ingest_ops.ingest_tile(log_size)
        form = f"{plan} tiles of 32 x 32 a block" if plan else "per-element form"
        if log_size in (10, 11, 12):
            say(f"[3] ingest log_size={log_size} ({form}): bit-equal")
            continue
        ms = device_ms(lambda: ingest_ops.ingest(words, log_size))
        call = cuda_ms(lambda: ingest_ops.ingest(words, log_size))
        plain_ms = cuda_ms(lambda: ingest_ops.ingest_plain(w64, log_size))
        err = max_abs_err(got, want)
        b_ms, b_by = profiling.ingest_bound(words.numel(), 4 << log_size)
        say(f"[3] ingest log_size={log_size} ({form}): bit-equal; device {ms:.4f} ms, call {call:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; share {b_ms / ms:.3f})")
        kernels["ingest"] = dict(
            source="frieda_tpu_torch/csrc/ingest.cu",
            replaces="frieda_tpu/ops/ingest_pallas.py:66", max_abs_err=err, ms=ms, call_ms=call,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        del words, w64, got, want

    # the 2^22-felt commit's LDE (the kernels entry, as in earlier runs) and
    # the 2^24-felt commit's and proof's
    for n, log_l in ((24, 20), (26, 22)):
        tw = fft.stage_twiddles(n, dev)
        coeffs = rand_u32((4, 1 << log_l), P)
        c64 = widen(coeffs)
        got = fft.evaluate_auto(coeffs, tw)
        want = narrow(fft.evaluate(c64, tw))
        check(torch.equal(got, want), f"fft_pass plan at n={n}, log_l={log_l} differs from plain")
        err = max_abs_err(got, want)
        del want
        torch.cuda.empty_cache()
        ms = device_ms(lambda: fft.evaluate_auto(coeffs, tw), reps=4)  # 4 outputs of up to 1 GiB
        call = cuda_ms(lambda: fft.evaluate_auto(coeffs, tw))
        plain_ms = cuda_ms(lambda: fft.evaluate(c64, tw), reps=3)
        p_min, groups = fft_ops.pass_plan(n, log_l)
        b_ms, b_by = profiling.fft_pass_bound(4, log_l, n)
        say(f"[3] fft_pass n={n} log_l={log_l}, groups {groups}: bit-equal; "
            f"device {ms:.4f} ms ({len(groups)} launches), call {call:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}; {profiling.M31_BUTTERFLY_INSTR} instructions a butterfly)")
        src, shift = coeffs, p_min
        for p_lo, p_hi, k in groups:
            g_ms = cuda_ms(lambda: fft_ops.fft_pass(src, tw, got, p_lo, p_hi, k, shift))  # noqa: B023
            n_bytes = 4 * (src.numel() + got.numel() + (1 << p_hi) - (1 << p_lo))
            threads, smem = ctypes.c_int(), ctypes.c_int()
            _build.library().frieda_fft_pass_launch_shape(p_hi - p_lo, k, ctypes.byref(threads),
                                                         ctypes.byref(smem))
            say(f"[3]   launch ({p_lo}, {p_hi}, {k}): {g_ms:.4f} ms, {n_bytes} bytes, "
                f"{n_bytes / g_ms / 1e9:.3f} TB/s; {threads.value} threads and {smem.value} "
                f"bytes of dynamic shared memory a block")
            src, shift = got, 0
        if n == 24:
            kernels["fft_pass"] = dict(
                source="frieda_tpu_torch/csrc/fft.cu",
                replaces="frieda_tpu/ops/fft_pallas.py:294", max_abs_err=err,
                ms=ms, call_ms=call, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        del coeffs, c64, got, tw, src
        torch.cuda.empty_cache()

    # fft_exchange at the sharded path's shapes (phase 12): the blocks of 8
    # virtual shards of the 2^24-felt commit at log_blowup 2 (stage 2) and 1
    # (stages 1, 2), and two separate shards keeping one half each
    def exchange_case(what: str, lo, hi, tw, write=(True, True), timed: bool = False) -> dict:
        want_lo, want_hi = fft_ops.fft_exchange_plain(widen(lo), widen(hi), widen(tw))
        new_lo, new_hi = lo.clone(), hi.clone()
        fft_ops.fft_exchange(new_lo, new_hi, tw, *write)
        err = max(max_abs_err(new_lo, narrow(want_lo) if write[0] else lo),
                  max_abs_err(new_hi, narrow(want_hi) if write[1] else hi))
        check(err == 0, f"fft_exchange {what} differs from plain")
        b_ms, b_by = profiling.fft_exchange_bound(lo.numel(), sum(write))
        out = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by)
        if timed:
            l64, h64, t64 = widen(lo), widen(hi), widen(tw)
            out["ms"] = device_ms(lambda: fft_ops.fft_exchange(new_lo, new_hi, tw, *write), reps=5)
            out["call_ms"] = cuda_ms(lambda: fft_ops.fft_exchange(new_lo, new_hi, tw, *write))
            out["plain_ms"] = cuda_ms(lambda: fft_ops.fft_exchange_plain(l64, h64, t64), reps=3)
            say(f"[3] fft_exchange {what}: bit-equal; device {out['ms']:.4f} ms, call {out['call_ms']:.4f} ms, "
                f"plain {out['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}; share {b_ms / out['ms']:.3f})")
            del l64, h64, t64
        else:
            say(f"[3] fft_exchange {what}: bit-equal")
        return out

    for log_blowup, m in ((2, 21), (1, 20)):
        block = rand_u32((8, 4, 1 << m), P)
        for p in range(log_blowup, 3):
            tw = fft.stage_twiddles(22 + log_blowup, dev)[(1 << p) - 1 : (1 << (p + 1)) - 1]
            v = block.view(8 >> (p + 1), 2, 1 << p, -1)
            out = exchange_case(f"stage {p} of an (8, 4, 2^{m}) block (2^24 felts, log_blowup {log_blowup})",
                                v[:, 0], v[:, 1], tw, timed=log_blowup == 2)
            if log_blowup == 2:
                kernels["fft_exchange"] = dict(
                    source="frieda_tpu_torch/csrc/fft.cu",
                    replaces="frieda_tpu/parallel/fft_sharded.py:298-309 (XLA after a ppermute; no Pallas kernel)",
                    **out)
        del block
    a, b = rand_u32((1, 1, 4 << 21), P), rand_u32((1, 1, 4 << 21), P)
    tw1 = rand_u32((1,), P)
    exchange_case("two separate (1, 1, 4 x 2^21) shards, low half kept", a, b, tw1, (True, False))
    exchange_case("two separate (1, 1, 4 x 2^21) shards, high half kept", a, b, tw1, (False, True))
    del a, b
    torch.cuda.empty_cache()

    def level_case(leaf: bool, fused: bool, width: int, what: str) -> dict:
        x = rand_u32((4, width), P) if leaf else rand_u32((8, width))
        x64 = widen(x)
        got = merkle_ops.merkle_level(x, leaf=leaf, fused=fused)
        want = narrow(merkle_ops.merkle_level_plain(x64, leaf=leaf, fused=fused))
        check(torch.equal(got, want), f"merkle_level leaf={leaf} fused={fused} width={width} differs")
        ms = device_ms(lambda: merkle_ops.merkle_level(x, leaf=leaf, fused=fused))
        call = cuda_ms(lambda: merkle_ops.merkle_level(x, leaf=leaf, fused=fused))
        plain_ms = cuda_ms(lambda: merkle_ops.merkle_level_plain(x64, leaf=leaf, fused=fused), reps=3)
        b_ms, b_by = profiling.merkle_level_bound(width, leaf, fused)
        say(f"[3] merkle_level leaf={leaf} fused={fused} width {width} ({what}): bit-equal; "
            f"device {ms:.4f} ms, call {call:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        return dict(max_abs_err=max_abs_err(got, want), ms=ms, call_ms=call, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by)

    kernels["merkle_level"] = dict(
        source="frieda_tpu_torch/csrc/merkle.cu", replaces="frieda_tpu/ops/merkle_pallas.py:188",
        **level_case(True, True, 1 << 24, "leaf3_level, 2^22-felt commit's first tree"))
    level_case(False, True, 1 << 23, "inner3_level, 2^24-felt prove's first tree")
    level_case(True, False, 1 << 12, "leaf_level; root_level and build_pruned below 8 leaves")
    level_case(False, False, 1 << 13, "inner_level; no main-path caller")

    def collapse_case(m: int, widths: tuple) -> list:
        level = rand_u32((8, m))
        got = merkle_ops.merkle_collapse(level, widths)
        want = [narrow(w) for w in merkle_ops.merkle_collapse_plain(widen(level), widths)]
        check(len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want)),
              f"merkle_collapse {m} -> {widths} differs from plain")
        return [level, got, want]

    for log_m in range(13):
        m = 1 << log_m
        for widths in {(1,), merkle.tail_widths(m) if m > 1 else (1,)}:
            collapse_case(m, widths)
    say("[3] merkle_collapse m = 2^0 ... 2^12 -> 1 and -> m/8^j, 1 at the planned cluster sizes "
        f"{[merkle_ops.collapse_plan(1 << k) for k in range(13)]}: bit-equal")
    collapse_dev = {}
    for m in (4096, 2048, 1024, 512, 256, 128, 64, 32, 16, 8, 4, 2):
        widths = merkle.tail_widths(m)
        plan = merkle_ops.collapse_plan(m)
        level, got, want = collapse_case(m, widths)
        dev_ms = collapse_dev[m] = device_ms(lambda: merkle_ops.merkle_collapse(level, widths))  # noqa: B023
        call = cuda_ms(lambda: merkle_ops.merkle_collapse(level, widths))  # noqa: B023
        root_dev = device_ms(lambda: merkle_ops.merkle_collapse(level))  # noqa: B023
        root_call = cuda_ms(lambda: merkle_ops.merkle_collapse(level))  # noqa: B023
        say(f"[3] merkle_collapse m={m}, cluster {plan} x {max(32, m // plan // 2)} threads: -> {widths} "
            f"device {dev_ms:.4f} ms, call {call:.4f} ms; -> 1 device {root_dev:.4f} ms, call "
            f"{root_call:.4f} ms")
        if m == 4096:  # 4096 -> (512, 64, 8, 1), a 2^26 tree's tail
            l64 = widen(level)
            plain_ms = cuda_ms(lambda: merkle_ops.merkle_collapse_plain(l64, widths))  # noqa: B023
            b_ms, b_by = profiling.merkle_collapse_bound(4096, widths)
            kernels["merkle_collapse"] = dict(
                source="frieda_tpu_torch/csrc/merkle.cu",
                replaces="frieda_tpu/ops/merkle_pallas.py:240",
                max_abs_err=max(max_abs_err(g, w) for g, w in zip(got, want)),
                ms=dev_ms, call_ms=call, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            say(f"[3] merkle_collapse 4096 -> {widths}: plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms "
                f"({b_by})")
    shapes = proof_collapse_widths(merkle_ops.COLLAPSE_MAX)
    one = rand_u32((8, 1))
    gap_ms = device_ms(lambda: merkle_ops.merkle_collapse(one))
    say(f"[3] merkle_collapse over the 2^24-felt proof's {len(shapes)} trees (m = "
        f"{sorted(shapes, reverse=True)}): device {sum(collapse_dev[m] for m in shapes):.4f} ms in all; "
        f"chain floor at m = 4096: 12 x {collapse_dev[2]:.4f} = {12 * collapse_dev[2]:.4f} ms; "
        f"m = 1 (a copy of 8 words: the graph's time a launch) {gap_ms:.4f} ms")

    # merkle_open at two proofs' openings; its chain floor: one launch and
    # three dependent compressions, a compression timed as a level of the
    # one-block collapse chain (m = 256 has 8 levels, m = 2 one)
    level_ms = (collapse_dev[256] - collapse_dev[2]) / 7
    for log_felts, nq in ((20, 64), (24, 20)):
        cfg = PcsConfig(pow_bits=20, fri_config=FriConfig(LOG_BLOWUP, 0, nq))
        data = synthetic_data(felt_bytes(log_felts))
        log_total = log_total_for(len(data))
        committed = fri.commit_phase(from_numpy_u32(pad_to_words(data, log_total), dev)[None], log_total, [7],
                                     cfg)[0]
        values, nodes = fri.plan_openings(committed.layers, committed.trees, committed.queries)[0].jobs()
        args = (committed.layers, committed.trees, values, nodes)
        got = merkle_ops.merkle_open(*args)
        want = narrow(merkle_ops.merkle_open_plain(*args))
        check(torch.equal(got, want), f"merkle_open at the 2^{log_felts}-felt proof's opening differs")
        table = torch.from_numpy(merkle_ops.open_table(*args)).to(dev)
        ms = device_ms(lambda: merkle_ops.merkle_open(*args, table))  # noqa: B023
        call = cuda_ms(lambda: merkle_ops.merkle_open(*args))  # noqa: B023
        plain_ms = cuda_ms(lambda: merkle_ops.merkle_open_plain(*args), reps=3)  # noqa: B023
        _, _, _, r, leaf, _ = merkle_ops.open_plan(committed.trees, values, nodes)
        hashes = int(((leaf + 1) * (1 << r) - 1).sum())  # leaf hashes, then 2^r - 1 pairs a read
        b_ms, b_by = profiling.merkle_open_bound(len(values), leaf, r)
        say(f"[3] merkle_open, 2^{log_felts}-felt / {nq}-query proof ({len(committed.layers)} layers, "
            f"{len(values)} values, {len(nodes)} nodes, {hashes} compressions): bit-equal; device "
            f"{ms:.4f} ms, call {call:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}); "
            f"chain floor {gap_ms:.4f} + 3 x {level_ms:.4f} = {gap_ms + 3 * level_ms:.4f} ms")
        if log_felts == 24:
            kernels["merkle_open"] = dict(
                source="frieda_tpu_torch/csrc/merkle.cu",
                replaces="frieda_tpu/ops/merkle_pallas.py:111 and :127 (in frieda_tpu/core/fri.py:68)",
                max_abs_err=max_abs_err(got, want), ms=ms, call_ms=call, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)
        # the same proof's gathers over its raw query words on the card, and
        # over a copy whose words repeat (draws of one position)
        o = committed.layout.head["qpos"][0]
        raw = committed.packed[o : o + nq]
        repeated = raw.clone()
        repeated[nq // 2 : nq // 2 + 3] = raw[:3]
        repeated[-1] = raw[0]
        err = 0
        for words_ in (raw, repeated):
            q_args = (committed.layers, committed.trees, words_)
            got = merkle_ops.merkle_open_queries(*q_args)
            want = narrow(merkle_ops.merkle_open_queries_plain(*q_args))
            check(torch.equal(got, want), f"merkle_open_queries at the 2^{log_felts}-felt proof's "
                  f"{'repeated ' if words_ is repeated else ''}query words differs from plain")
            err = max(err, max_abs_err(got, want))
        # order_openings over those gathers, the raw words and the repeats: == plain, and over the raw
        # words == the ordered decommitment the commit phase packed after its head
        sizes, err_o = committed.layout.sizes, 0
        for words_ in (raw, repeated):
            o_args = (merkle_ops.merkle_open_queries(committed.layers, committed.trees, words_), words_, sizes)
            got_o, want_o = merkle_ops.order_openings(*o_args), narrow(merkle_ops.order_openings_plain(*o_args))
            err_o = max(err_o, max_abs_err(got_o, want_o))
            check(torch.equal(got_o, want_o),
                  f"order_openings at the 2^{log_felts}-felt proof's {'repeated ' if words_ is repeated else ''}"
                  "query words differs from plain")
        o_args = (merkle_ops.merkle_open_queries(committed.layers, committed.trees, raw), raw, sizes)
        check(torch.equal(merkle_ops.order_openings(*o_args), committed.packed[committed.layout.head_words :]),
              f"order_openings at 2^{log_felts} felts != the decommitment the commit phase packed")
        o_ms = device_ms(lambda: merkle_ops.order_openings(*o_args))  # noqa: B023
        o_call = cuda_ms(lambda: merkle_ops.order_openings(*o_args))  # noqa: B023
        o_plain = cuda_ms(lambda: merkle_ops.order_openings_plain(*o_args), reps=3)  # noqa: B023
        counts = to_numpy_u32(committed.packed[committed.layout.head_words :][: 1 + 2 * len(sizes)]).astype(int)
        n_values, n_nodes = counts[0] + counts[1 : 1 + len(sizes)].sum(), counts[1 + len(sizes) :].sum()
        b_ms, b_by = profiling.order_openings_bound(nq, n_values, n_nodes, got_o.numel())
        say(f"[3] order_openings, 2^{log_felts}-felt / {nq}-query proof: bit-equal to plain over the raw words "
            f"and the copy with repeats, == the commit phase's packed decommitment ({got_o.numel()} words: "
            f"{counts[0]} evaluations, {n_values - counts[0]} witness values, {n_nodes} nodes); device "
            f"{o_ms:.4f} ms, call {o_call:.4f} ms, plain {o_plain:.4f} ms, bound {b_ms:.6f} ms ({b_by}; share "
            f"{b_ms / o_ms:.3f})")
        if log_felts == 20:
            kernels["order_openings"] = dict(
                source="frieda_tpu_torch/csrc/merkle.cu",
                replaces="frieda_tpu/core/fri.py:_finish_proof's selection (numpy on the host there)",
                max_abs_err=err_o, ms=o_ms, call_ms=o_call, plain_ms=o_plain, bound_ms=b_ms, bound_by=b_by)
        q_args = (committed.layers, committed.trees, raw)
        ms = device_ms(lambda: merkle_ops.merkle_open_queries(*q_args))  # noqa: B023
        call = cuda_ms(lambda: merkle_ops.merkle_open_queries(*q_args))  # noqa: B023
        plain_ms = cuda_ms(lambda: merkle_ops.merkle_open_queries_plain(*q_args), reps=3)  # noqa: B023
        compressions, read_bytes = merkle_ops.open_queries_work(committed.trees, to_numpy_u32(raw))
        out_words = got.numel()
        b_ms, b_by = profiling.merkle_open_queries_bound(nq, out_words, read_bytes, compressions)
        node_reads = nq * sum(t.log_leaves for t in committed.trees)
        say(f"[3] merkle_open_queries, 2^{log_felts}-felt / {nq}-query proof ({len(committed.layers)} layers, "
            f"{2 * nq * len(committed.layers)} pair reads, {node_reads} node reads, {compressions} distinct "
            f"compressions, "
            f"{4 * out_words} bytes out, {read_bytes} distinct bytes read): bit-equal over the raw words "
            f"and over a copy with 4 repeated words; device {ms:.4f} ms, "
            f"call {call:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}; share "
            f"{b_ms / ms:.3f}); chain floor {gap_ms:.4f} + 3 x {level_ms:.4f} = {gap_ms + 3 * level_ms:.4f} ms")
        if log_felts == 20:
            kernels["merkle_open_queries"] = dict(
                source="frieda_tpu_torch/csrc/merkle.cu",
                replaces="frieda_tpu/core/fri.py:283-316 (the oblivious gathers of _fri_commit_fn.run; "
                         ":68 _auth_sibling_nodes over frieda_tpu/ops/merkle_pallas.py:111 and :127)",
                max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        # its sharded form: the same proof's layers over one mesh row whose shards all lie on the
        # card (2^24 / 20 q over S = 8; 2^20 / 64 q on row 1 of a (2, 4) mesh), the packed vector
        # and the gathers == one device's
        n_data, S, row = (1, 8, 0) if log_felts == 24 else (2, 4, 1)
        mesh = sharding.make_mesh(n_data, S, devices=[dev] * (n_data * S))
        sharded = fri.commit_phase_sharded(from_numpy_u32(pad_to_words(data, log_total), dev), log_total, 7, cfg,
                                           mesh, row)
        check(sharded.opening_cls is None and torch.equal(sharded.packed, committed.packed),
              f"the sharded commit phase at 2^{log_felts} felts over ({n_data}, {S}) row {row}: its packed "
              "vector != one device's")
        for words_ in (raw, repeated):
            s_args = (sharded.layers, sharded.trees, words_)
            got = merkle_ops.merkle_open_queries(*s_args)
            want = narrow(merkle_ops.merkle_open_queries_plain(*s_args))
            check(torch.equal(got, want) and torch.equal(got, merkle_ops.merkle_open_queries(
                committed.layers, committed.trees, words_)), f"sharded merkle_open_queries at 2^{log_felts} "
                  f"felts over S = {S}{' (repeated words)' if words_ is repeated else ''}: != plain or != one "
                  "device's")
            kernels["merkle_open_queries"]["max_abs_err"] = max(kernels["merkle_open_queries"]["max_abs_err"],
                                                                max_abs_err(got, want))
        s_args = (sharded.layers, sharded.trees, raw)
        ms = device_ms(lambda: merkle_ops.merkle_open_queries(*s_args))  # noqa: B023
        call = cuda_ms(lambda: merkle_ops.merkle_open_queries(*s_args))  # noqa: B023
        plain_ms = cuda_ms(lambda: merkle_ops.merkle_open_queries_plain(*s_args), reps=3)  # noqa: B023
        compressions, read_bytes = merkle_ops.open_queries_work(sharded.trees, to_numpy_u32(raw))
        b_ms, b_by = profiling.merkle_open_queries_bound(nq, out_words, read_bytes, compressions)
        n_sharded = sum(isinstance(t, merkle.ShardedTree) for t in sharded.trees)
        say(f"[3] merkle_open_queries, sharded form: 2^{log_felts}-felt / {nq}-query proof over S = {S} "
            f"(row {row} of ({n_data}, {S}); {n_sharded} of {len(sharded.layers)} layers sharded, the levels "
            f"narrower than {S} read from the top trees; {compressions} distinct compressions, {read_bytes} "
            f"distinct bytes read): bit-equal to plain over the raw words and the copy with repeats, == one "
            f"device's gathers; device {ms:.4f} ms, call {call:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}; share {b_ms / ms:.3f})")
        del committed, args, got, want, table, raw, repeated, q_args, s_args, sharded, mesh, o_args, got_o
        torch.cuda.empty_cache()
    # fri_fold: circle and line at (4, 2^26), the proof's first line fold
    # (4, 2^25) and a width under one block; then timed at each of the
    # 2^24-felt proof's 22 folds
    def fold_case(what: str, values, alpha, inv, timed: bool = False) -> dict:
        v64, a64, i64 = widen(values), widen(alpha), widen(inv)
        got = fri_ops.fri_fold(values, alpha, inv)
        want = narrow(fri_ops.fri_fold_plain(v64, a64, i64))
        check(torch.equal(got, want), f"fri_fold {what} differs from plain")
        b_ms, b_by = profiling.fri_fold_bound(values.shape[1] // 2)
        out = dict(max_abs_err=max_abs_err(got, want), bound_ms=b_ms, bound_by=b_by)
        del got, want
        if timed:
            out["ms"] = device_ms(lambda: fri_ops.fri_fold(values, alpha, inv), reps=4)
            out["call_ms"] = cuda_ms(lambda: fri_ops.fri_fold(values, alpha, inv))
            out["plain_ms"] = cuda_ms(lambda: fri_ops.fri_fold_plain(v64, a64, i64), reps=3)
            say(f"[3] fri_fold {what}: bit-equal; device {out['ms']:.4f} ms, call {out['call_ms']:.4f} ms, "
                f"plain {out['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}; share {b_ms / out['ms']:.3f})")
        else:
            say(f"[3] fri_fold {what}: bit-equal")
        return out

    ys26, xs26 = fri.fold_tables(26, dev)
    values = rand_u32((4, 1 << 26), P)
    alpha = rand_u32((4,), P)
    kernels["fri_fold"] = dict(
        source="frieda_tpu_torch/csrc/fri.cu",
        replaces="frieda_tpu/core/fri.py:211 fold_c (and :219 fold_l; XLA, no Pallas kernel)",
        **fold_case("circle (4, 2^26) (ys_inv, the 2^24-felt proof's first fold)", values, alpha, ys26,
                    timed=True))
    fold_case("line (4, 2^26) (a random canonical inverse table of 2^25)", values, alpha,
              rand_u32((1 << 25,), P))
    del values
    fold_case("line (4, 2^25) (xs_layers_inv[0], the proof's first line fold)", rand_u32((4, 1 << 25), P),
              alpha, xs26[0])
    ys7, _ = fri.fold_tables(7, dev)
    fold_case("circle (4, 2^7) (one block, 64 of 256 threads)", rand_u32((4, 1 << 7), P), alpha, ys7)
    fold_case("line (4, 2^6) (one block, 32 threads)", rand_u32((4, 1 << 6), P), alpha, xs26[19])
    fold_dev = 0.0
    for l in range(22):  # circle 2^26 -> 2^25, then line folds down to 2^5 -> 2^4
        x = rand_u32((4, 1 << (26 - l)), P)
        inv = ys26 if l == 0 else xs26[l - 1]
        fold_dev += device_ms(lambda: fri_ops.fri_fold(x, alpha, inv), reps=4 if l < 3 else 20)  # noqa: B023
    del x
    fold_bound = sum(profiling.fri_fold_bound(1 << (25 - l))[0] for l in range(22))
    say(f"[3] fri_fold over the 2^24-felt proof's 22 folds (4 x 2^26 ... 4 x 2^5): device {fold_dev:.4f} ms "
        f"in all; bound {fold_bound:.4f} ms; launch floor 22 x {gap_ms:.4f} = {22 * gap_ms:.4f} ms")
    torch.cuda.empty_cache()

    # transcript: every step on 64 seeded states against the host channel and
    # the plain version
    def words_bytes(t) -> bytes:
        return to_numpy_u32(t).astype("<u4").tobytes()

    t_err = 0
    for trial in range(64):
        host = Blake2sChannel()
        st, st_plain = channel_ops.new_state(dev), channel_ops.new_state(dev)
        seed = int(rng.integers(0, 1 << 62)) << 2 | trial % 4
        root = rand_u32((8,))
        felts = rand_u32((1 + trial % 8, 4), P)
        nonce = rand_u32((2,))
        nq, log_d = (1, 8, 20, 64)[trial % 4], 10 + trial % 23
        steps = (dict(mix_u64=seed), dict(mix_digest=root, draw_felt=True), dict(mix_felts=felts),
                 dict(mix_u64=nonce, queries=(nq, log_d)))
        host.mix_u64(seed)
        host.mix_digest(words_bytes(root))
        want_alpha = host.draw_felt()
        host.mix_felts([tuple(int(v) for v in row) for row in to_numpy_u32(felts)])
        lo, hi = (int(v) for v in to_numpy_u32(nonce))
        host.mix_u64(lo | hi << 32)
        want_q, probe = [], host.clone()
        while len(want_q) < nq:
            raw = probe.draw_random_bytes()
            want_q += [int.from_bytes(raw[4 * i : 4 * i + 4], "little") & ((1 << log_d) - 1) for i in range(8)]
        for step in steps:
            got = channel_ops.transcript(st, **step)
            want = channel_ops.transcript_plain(st_plain, **step)
            check(torch.equal(st, st_plain) and all((g is None) == (w is None) and (g is None or torch.equal(g, w))
                                                    for g, w in zip(got, want)),
                  f"transcript {sorted(step)} on state {trial} differs from plain")
            if step.get("draw_felt"):
                check(tuple(int(v) for v in to_numpy_u32(got[0])) == want_alpha,
                      f"transcript state {trial}: alpha differs from the host channel's")
                t_err = max(t_err, max_abs_err(got[0], want[0]))
        check(words_bytes(st[:8]) == host.digest and int(st[8].item()) == -(-nq // 8)
              and [int(v) for v in to_numpy_u32(got[1])] == want_q[:nq],
              f"transcript state {trial}: digest, n_sent or query words differ from the host channel's")
    say("[3] transcript: seed, root + alpha, last-layer felts (k = 1 ... 8), nonce + queries (1, 8, 20, "
        "64 of 2^10 ... 2^32) on 64 seeded states: bit-equal to the plain version and the host channel")
    st = channel_ops.new_state(dev)
    channel_ops.transcript(st, mix_u64=7)
    # (what, step, dependent compressions, (message bytes, drawn bytes, compressions))
    forms = (("seed", dict(mix_u64=7), 1, (8, 0, 1)),
             ("layer: root + alpha", dict(mix_digest=root, draw_felt=True), 2, (32, 16, 2)),
             ("last-layer felts, k = 1", dict(mix_felts=felts[:1]), 1, (16, 0, 1)),
             ("nonce + 20 queries", dict(mix_u64=nonce, queries=(20, 26)), 2, (8, 80, 4)),
             ("nonce + 64 queries", dict(mix_u64=nonce, queries=(64, 24)), 2, (8, 256, 9)))
    step_ms = {}
    for what, step, chain, work in forms:
        ms = step_ms[what] = device_ms(lambda: channel_ops.transcript(st, **step))  # noqa: B023
        call = cuda_ms(lambda: channel_ops.transcript(st, **step))  # noqa: B023
        plain_ms = cuda_ms(lambda: channel_ops.transcript_plain(st, **step), reps=3)  # noqa: B023
        b_ms, b_by = profiling.transcript_bound(*work)
        say(f"[3] transcript {what}: device {ms:.4f} ms, call {call:.4f} ms, plain {plain_ms:.4f} ms; bound "
            f"{b_ms:.6f} ms ({b_by}); chain floor {gap_ms:.4f} + {chain} x {level_ms:.4f} = "
            f"{gap_ms + chain * level_ms:.4f} ms")
        if what.startswith("layer"):
            kernels["transcript"] = dict(
                source="frieda_tpu_torch/csrc/channel.cu",
                replaces="frieda_tpu/core/device_channel.py:33-191 (dc_mix_*, dc_draw_felt, "
                         "dc_sample_query_words; XLA, no Pallas kernel)",
                max_abs_err=t_err, ms=ms, call_ms=call, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    per_proof = step_ms["seed"] + 22 * step_ms["layer: root + alpha"] + step_ms["last-layer felts, k = 1"] \
        + step_ms["nonce + 20 queries"]
    say(f"[3] transcript as 25 launches of the 2^24-felt / 20-query proof (before the channel step rode on "
        f"the collapse): device {per_proof:.4f} ms; launch floor 25 x {gap_ms:.4f} = {25 * gap_ms:.4f} ms")

    # merkle_collapse with the channel step (seed, root, alpha) of a prover's
    # tree: the outputs, the state and alpha bit-equal to the plain collapse
    # followed by transcript_plain, at every width (every cluster size), with
    # and without the seed, and with the draw's retry forced on the card
    def step_case(m: int, widths: tuple, with_seed: bool) -> tuple:
        level, state = rand_u32((8, m)), rand_u32((9,))
        seed = rand_u32((2,)) if with_seed else None
        kernel, plain = (channel_ops.ChannelStep(state.clone(), seed, torch.zeros(4, dtype=torch.int32, device=dev))
                         for _ in range(2))
        got = merkle_ops.merkle_collapse(level, widths, step=kernel)
        want = [narrow(w) for w in merkle_ops.merkle_collapse_plain(widen(level), widths, plain)]
        check(len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))
              and torch.equal(kernel.state, plain.state) and torch.equal(kernel.alpha, plain.alpha),
              f"merkle_collapse {m} -> {widths} with the channel step (seed {with_seed}) differs from plain")
        err = max([max_abs_err(g, w) for g, w in zip(got, want)]
                  + [max_abs_err(kernel.state, plain.state), max_abs_err(kernel.alpha, plain.alpha)])
        return level, kernel, err

    step_err = 0
    for log_m in range(1, 13):
        m = 1 << log_m
        for widths in {(1,), merkle.tail_widths(m)}:
            for with_seed in (False, True):
                step_err = max(step_err, step_case(m, widths, with_seed)[2])
    bound0, n_sent = dc.DRAW_BOUND, []
    dc.DRAW_BOUND = 3 << 30  # an attempt passes with probability (3/4)^8, about 0.1
    try:
        for m in (2, 256, 512, 4096):
            n_sent.append(int(step_case(m, merkle.tail_widths(m), True)[1].state[8].item()))
    finally:
        dc.DRAW_BOUND = bound0
    check(max(n_sent) > 1, f"the lowered DRAW_BOUND forced no retry: n_sent {n_sent}")
    say("[3] merkle_collapse with the channel step, m = 2^1 ... 2^12 -> 1 and -> m/8^j, 1, with and without "
        "the seed: outputs, state and alpha bit-equal to the plain collapse + transcript_plain; with "
        f"DRAW_BOUND 3 x 2^30 at m = 2, 256, 512, 4096 (retries on the card, n_sent {n_sent}): bit-equal")
    step_dev = {}
    for m in sorted(set(shapes), reverse=True):
        widths = merkle.tail_widths(m)
        level = rand_u32((8, m))
        st = channel_ops.ChannelStep(channel_ops.new_state(dev), None, torch.zeros(4, dtype=torch.int32, device=dev))
        step_dev[m] = device_ms(lambda: merkle_ops.merkle_collapse(level, widths, step=st))  # noqa: B023
        say(f"[3] merkle_collapse m={m} -> {widths}: device {step_dev[m]:.4f} ms with the channel step, "
            f"{collapse_dev[m]:.4f} ms without ({step_dev[m] - collapse_dev[m]:+.4f} ms)")
        if m == 4096:
            seeded = st._replace(seed=rand_u32((2,)))
            seed_ms = device_ms(lambda: merkle_ops.merkle_collapse(level, widths, step=seeded))  # noqa: B023
            call = cuda_ms(lambda: merkle_ops.merkle_collapse(level, widths, step=st))  # noqa: B023
            l64 = widen(level)
            plain_ms = cuda_ms(lambda: merkle_ops.merkle_collapse_plain(l64, widths, st), reps=3)  # noqa: B023
            b_ms, b_by = profiling.merkle_collapse_bound(4096, widths, step=True)
            kernels[STEP_FORM] = dict(
                source="frieda_tpu_torch/csrc/merkle.cu",
                replaces="frieda_tpu/ops/merkle_pallas.py:240 (collapse_multi) with "
                         "frieda_tpu/core/device_channel.py:76-126 (dc_mix_digest, dc_draw_felt; XLA)",
                max_abs_err=step_err, ms=step_dev[m], call_ms=call, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)
            say(f"[3] merkle_collapse 4096 -> {widths} with the channel step: with the seed (layer 0) device "
                f"{seed_ms:.4f} ms; call {call:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}); "
                f"the step's chain floor, no launch: 2 x {level_ms:.4f} = {2 * level_ms:.4f} ms")
    added = sum(step_dev[m] - collapse_dev[m] for m in shapes)
    closing = step_ms["last-layer felts, k = 1"] + step_ms["nonce + 20 queries"]
    say(f"[3] the 2^24-felt / 20-query proof's channel: 2 transcript launches (last-layer felts, nonce + 20 "
        f"queries) {closing:.4f} ms + the 22 steps' added device time in their collapses {added:.4f} ms = "
        f"{closing + added:.4f} ms (25 transcript launches before: {per_proof:.4f} ms)")

    # grind: the minimum nonce at pow_bits 8, 16 and 20
    for pow_bits in (8, 16, 20):
        host = Blake2sChannel()
        host.mix_u64(SEED + pow_bits)
        st = channel_ops.new_state(dev)
        channel_ops.transcript(st, mix_u64=SEED + pow_bits)
        got = channel_ops.grind(st, pow_bits)
        want = channel_ops.grind_plain(st, pow_bits)
        nonce = int(got.view(torch.int64).item())
        check(torch.equal(got, want), f"grind pow_bits={pow_bits}: nonce {nonce} != plain "
              f"{int(want.view(torch.int64).item())}")
        check(nonce == grind.grind(host, pow_bits, dev), f"grind pow_bits={pow_bits} != the host channel's sweep")
        if pow_bits <= 16:  # grind_host's loop on the host channel
            n = 0
            while True:
                c = host.clone()
                c.mix_u64(n)
                if c.trailing_zeros() >= pow_bits:
                    break
                n += 1
            check(nonce == n, f"grind pow_bits={pow_bits}: {nonce} != the host scan's {n}")
        b_ms, b_by = profiling.grind_bound(nonce)
        ms = device_ms(lambda: channel_ops.grind(st, pow_bits))  # noqa: B023
        call = cuda_ms(lambda: channel_ops.grind(st, pow_bits))  # noqa: B023
        plain_ms = cuda_ms(lambda: channel_ops.grind_plain(st, pow_bits), reps=3)  # noqa: B023
        say(f"[3] grind pow_bits={pow_bits}: nonce {nonce} == plain sweep"
            f"{' == host scan' if pow_bits <= 16 else ''}; device {ms:.4f} ms, call {call:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}: {nonce + 1} compressions; share {b_ms / ms:.3f}); "
            f"{grind_form(1)}")
        if pow_bits == 20:
            say(f"[3] grind pow_bits=20, one launch after another: "
                f"{clocks_beside(lambda: channel_ops.grind(st, pow_bits))}")  # noqa: B023
            kernels["grind"] = dict(
                source="frieda_tpu_torch/csrc/channel.cu",
                replaces="frieda_tpu/core/device_channel.py:145 dc_grind (XLA, no Pallas kernel)",
                max_abs_err=max_abs_err(got, want), ms=ms, call_ms=call, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)
    fri._fold_tables.clear()
    torch.cuda.empty_cache()

    # the blob axis (commit_many: 64 x 2^16 felts, log_blowup 4, and small
    # batches), each against its one-blob plain version per blob, stacked
    def batch_case(what: str, fn, plain_one, x, bound: tuple) -> None:
        got = fn(x)
        want = torch.stack([narrow(plain_one(widen(b))) for b in x])
        check(torch.equal(got, want), f"{what} differs from its plain version per blob")
        ms = device_ms(lambda: fn(x), reps=5)
        call = cuda_ms(lambda: fn(x))
        b_ms, b_by = bound
        say(f"[3] {what}: bit-equal per blob; device {ms:.4f} ms, call {call:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}; share {b_ms / ms:.3f})")

    for n_blobs, log_size in ((64, 14), (3, 8)):  # tile form, per-element form
        words = rand_u32((n_blobs, words_for(log_size + 2)))
        form = f"{ingest_ops.ingest_tile(log_size)} tiles a block" if log_size >= 10 else "per-element form"
        batch_case(f"ingest ({n_blobs}, {words.shape[1]}) log_size={log_size} ({form})",
                   lambda w: ingest_ops.ingest(w, log_size),  # noqa: B023
                   lambda w: ingest_ops.ingest_plain(w, log_size),  # noqa: B023
                   words, profiling.ingest_bound(words.numel(), n_blobs * 4 << log_size))
    tw = fft.stage_twiddles(18, dev)
    coeffs = rand_u32((64, 4, 1 << 14), P)
    _, groups = fft_ops.pass_plan(18, 14)
    batch_case(f"fft_pass C=256 n=18 log_l=14 ((64, 4, 2^14) as (256, 2^14), groups {groups})",
               lambda c: fft.evaluate_auto(c, tw), lambda c: fft.evaluate(c, tw), coeffs,
               profiling.fft_pass_bound(256, 14, 18))
    del coeffs, tw
    for n_blobs, leaf, fused, width in ((64, True, True, 1 << 18), (64, False, True, 1 << 15),
                                        (3, True, False, 1 << 4), (3, False, False, 1 << 4)):
        x = rand_u32((n_blobs, 4, width), P) if leaf else rand_u32((n_blobs, 8, width))
        batch_case(f"merkle_level leaf={leaf} fused={fused} {tuple(x.shape)}",
                   lambda v: merkle_ops.merkle_level(v, leaf, fused),  # noqa: B023
                   lambda v: merkle_ops.merkle_level_plain(v, leaf, fused),  # noqa: B023
                   x, profiling.merkle_level_bound(width, leaf, fused, blobs=n_blobs))
    for n_blobs, m in ((64, 4096), (3, 2)):
        level = rand_u32((n_blobs, 8, m))
        batch_case(f"merkle_collapse ({n_blobs}, 8, {m}) -> 1, {n_blobs} clusters of "
                   f"{merkle_ops.collapse_plan(m)}",
                   lambda v: merkle_ops.merkle_collapse(v)[0],
                   lambda v: merkle_ops.merkle_collapse_plain(v)[0],
                   level, profiling.merkle_collapse_bound(m, blobs=n_blobs))
    del x, level, words
    fri._fold_tables.clear()  # phase 9's peak memory counts no tables of these proofs
    torch.cuda.synchronize()
    lap(3)

    # -- 4. end-to-end commits against the JAX package's roots ---------------
    ops.reset_launch_counts()
    for n_bytes, expect in ANCHORS:
        t0 = time.perf_counter()
        root = api.commit(synthetic_data(n_bytes), LOG_BLOWUP, device=dev).hex()
        check(root == expect, f"commit of {n_bytes} bytes: {root} != anchor {expect}")
        say(f"[4] commit {n_bytes} bytes: root {root} matches ({time.perf_counter() - t0:.3f} s)")

    # -- 5. device-resident commits: time at 2^22 and 2^24 felts; 2^24 vs plain
    results = {}
    for log_felts in (22, 24):
        data = synthetic_data(felt_bytes(log_felts))
        log_total = log_total_for(len(data))
        words = from_numpy_u32(pad_to_words(data, log_total), dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ms = cuda_ms(lambda: api.commit_root_pipeline(words, log_total, LOG_BLOWUP))
        peak = torch.cuda.max_memory_allocated(dev)
        graph_ms = device_ms(lambda: api.commit_root_pipeline(words, log_total, LOG_BLOWUP), reps=3)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            root = api.commit(data, LOG_BLOWUP, device=dev)
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        felts = 1 << log_felts
        results[log_felts] = dict(ms=ms, graph_ms=graph_ms, wall_s=wall, peak=peak, root=root.hex())
        say(f"[5] commit 2^{log_felts} felts ({len(data)} bytes, domain 2^{log_total - 2 + LOG_BLOWUP}): "
            f"device {ms:.3f} ms median = {felts / (ms / 1e3) / 1e6:.2f} M felts/s (graph replay "
            f"{graph_ms:.4f} ms); "
            f"whole call {wall * 1e3:.1f} ms = {felts / wall / 1e6:.2f} M felts/s; "
            f"peak device memory {peak / 2**30:.3f} GiB; root {root.hex()}")
        for what, t_ms in (("graph replay", graph_ms), ("call", ms)):
            roof = profiling.commit_roofline(log_total - 2 + LOG_BLOWUP, t_ms / 1e3)
            check(0 < roof["sol_fraction"] <= 1, f"commit_roofline 2^{log_felts} felts ({what}): share "
                  f"{roof['sol_fraction']} outside (0, 1]")
            say(f"[5] commit_roofline 2^{log_felts} felts, {what} {t_ms:.4f} ms: "
                + ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}" for k, v in roof.items()))
        del words

    data = synthetic_data(felt_bytes(24))
    log_total = log_total_for(len(data))
    words = widen(from_numpy_u32(pad_to_words(data, log_total), dev))
    coeffs = ingest_ops.ingest_plain(words, log_total - 2)
    del words
    evals = fft.evaluate(coeffs, fft.stage_twiddles(log_total - 2 + LOG_BLOWUP, dev))
    del coeffs
    plain_root = merkle.root_bytes(merkle_ops.merkle_collapse_plain(merkle.hash_leaves(evals))[0]).hex()
    del evals
    torch.cuda.empty_cache()
    check(plain_root == results[24]["root"],
          f"2^24-felt commit: kernel root {results[24]['root']} != plain root {plain_root}")
    say(f"[5] 2^24-felt commit: kernel path root == plain path root {plain_root}")
    commit_counts = ops.launch_counts()
    check(collapse_steps() == 0, f"the commit phases 4-5 ran {collapse_steps()} channel steps")
    say(f"[5] kernel launches in the commit phases 4-5: {commit_counts}; channel steps 0")
    # a proof's kernels
    prove_only = {"merkle_open", "merkle_open_queries", "order_openings", "fri_fold", "transcript", "grind"}
    prove_only |= {"fft_exchange"}  # and the sharded path's exchange stages (phase 12)
    for name, count in commit_counts.items():
        check(count > 0 or name in prove_only, f"kernel {name} was never launched by the commit path")
    lap(5)

    # -- 6. commit_many --------------------------------------------------------
    blobs16 = [synthetic_data(felt_bytes(16), k) for k in range(64)]
    ops.reset_launch_counts()
    roots16 = api.commit_many(blobs16, LOG_BLOWUP, device=dev)
    batch_counts = ops.launch_counts()
    check(collapse_steps() == 0, f"commit_many ran {collapse_steps()} channel steps")
    ops.reset_launch_counts()
    api.commit(blobs16[0], LOG_BLOWUP, device=dev)
    check(ops.launch_counts() == batch_counts,
          f"commit_many of 64 blobs launched {batch_counts}; one commit {ops.launch_counts()}")
    check(roots16 == [api.commit(d, LOG_BLOWUP, device=dev) for d in blobs16],
          "commit_many of 64 x 2^16 felts differs from a loop of commit")
    check(roots16[0].hex() == dict(ANCHORS)[245_760], f"commit_many root 0 {roots16[0].hex()} != anchor")
    say(f"[6] commit_many 64 x 2^16 felts: every root == a loop of commit, root 0 == the 2^16 anchor; "
        f"launches per commit_many {batch_counts} == one commit's")
    blobs20 = [synthetic_data(felt_bytes(20), k) for k in range(16)]
    roots20 = api.commit_many(blobs20, LOG_BLOWUP, device=dev)  # phase 12's commit_roots_batch
    check(roots20 == [api.commit(d, LOG_BLOWUP, device=dev) for d in blobs20],
          "commit_many of 16 x 2^20 felts differs from a loop of commit")
    say("[6] commit_many 16 x 2^20 felts: every root == a loop of commit")
    for sizes, log_blowup, expect in COMMIT_MANY_ANCHORS:
        got = [r.hex() for r in api.commit_many([synthetic_data(n, k) for k, n in enumerate(sizes)],
                                                log_blowup, device=dev)]
        check(got == list(expect), f"commit_many {sizes}: {got} != anchors {expect}")
    check(api.commit_many([], LOG_BLOWUP, device=dev) == [], "commit_many of no blob is not []")
    try:
        api.commit_many([synthetic_data(100), synthetic_data(4_000)], LOG_BLOWUP, device=dev)
        check(False, "commit_many of unequal padded sizes did not raise")
    except ValueError as e:
        check("equal padded sizes" in str(e), f"commit_many of unequal sizes: {e}")
    say(f"[6] commit_many anchors {[sizes for sizes, _, _ in COMMIT_MANY_ANCHORS]} match the JAX "
        f"package's; [] for no blob; ValueError for unequal padded sizes")
    for blobs, log_felts, single in ((blobs16, 16, 22), (blobs20, 20, 24)):
        n_blobs = len(blobs)
        words = from_numpy_u32(np.stack([pad_to_words(d, log_felts) for d in blobs]), dev)
        rows = list(words)

        def batch(w=words, lt=log_felts):
            return api.commit_root_pipeline_batch(w, lt, LOG_BLOWUP)

        def loop(rs=rows, lt=log_felts):
            return [api.commit_root_pipeline(w, lt, LOG_BLOWUP) for w in rs]

        batch_dev = device_ms(batch, reps=3)
        batch_call = cuda_ms(batch)
        loop_call = cuda_ms(loop, reps=3)
        loop_graph = device_ms(loop, reps=1)
        walls = {"commit_many": [], "loop": []}
        for kind in ("commit_many", "loop", "loop", "commit_many", "commit_many", "loop"):  # in turns
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "loop":
                for d in blobs:
                    api.commit(d, LOG_BLOWUP, device=dev)
            else:
                api.commit_many(blobs, LOG_BLOWUP, device=dev)
            walls[kind].append((time.perf_counter() - t0) * 1e3)
        idle = {}
        for kind, fn in (("commit_many", batch), ("loop", loop)):
            torch.cuda.synchronize()
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            busy_us, records = device_busy_us(prof)
            check(records > 0 and busy_us < wall_us, f"profile of {kind}: {records} records, busy "
                  f"{busy_us:.0f} us of {wall_us:.0f} us")
            idle[kind] = (1 - busy_us / wall_us, busy_us, records, wall_us)
        felts = n_blobs << log_felts
        wall_many, wall_loop = statistics.median(walls["commit_many"]), statistics.median(walls["loop"])
        say(f"[6] commit_many {n_blobs} x 2^{log_felts} felts (domain 2^{log_felts - 2 + LOG_BLOWUP} each; "
            f"one 2^{single}-felt commit, phase 5: graph replay {results[single]['graph_ms']:.4f} ms, call "
            f"{results[single]['ms']:.4f} ms): commit_root_pipeline_batch device {batch_dev:.4f} ms "
            f"(graph replay) = {felts / batch_dev / 1e6:.3f} G felts/s, call {batch_call:.4f} ms; a loop "
            f"of {n_blobs} commit_root_pipeline: call {loop_call:.4f} ms, one CUDA graph {loop_graph:.4f} ms; "
            f"whole calls in turns (ms): commit_many {[round(w, 3) for w in walls['commit_many']]}, loop "
            f"of api.commit {[round(w, 3) for w in walls['loop']]}: medians {wall_many:.3f} / "
            f"{wall_loop:.3f} = {felts / wall_many / 1e3:.3f} / {felts / wall_loop / 1e3:.3f} M felts/s")
        for kind, (share, busy_us, records, wall_us) in idle.items():
            say(f"[6]   idle share over 5 x {kind} on device-resident words: {share:.3f} (device busy "
                f"{busy_us:.0f} us in {records} records of {wall_us:.0f} us)")
        del words, rows
        torch.cuda.empty_cache()
    del blobs16, blobs20
    lap(6)

    # -- 7. commit_with_tree --------------------------------------------------
    data = synthetic_data(felt_bytes(16))
    root, evals, tree, n = api.commit_with_tree(data, LOG_BLOWUP, device=dev)
    c_root, c_evals, c_tree, c_n = api.commit_with_tree(data, LOG_BLOWUP, device="cpu")
    check(root == c_root and n == c_n and torch.equal(evals.cpu(), c_evals), "commit_with_tree 2^16: "
          "kernel route root, n or evals != plain route's")
    check(tree.n_device_levels == c_tree.n_device_levels and len(tree.hlevels) == len(c_tree.hlevels)
          and all(torch.equal(a.cpu(), b) for a, b in zip(tree.dlevels, c_tree.dlevels))
          and all(np.array_equal(a, b) for a, b in zip(tree.hlevels, c_tree.hlevels)),
          "commit_with_tree 2^16: a tree level differs between the kernel and plain routes")
    for level in range(n + 1):
        stored = rng.integers(0, 1 << (n - level), 64)
        check(tree.gather_nodes(level, stored) == c_tree.gather_nodes(level, stored),
              f"commit_with_tree 2^16: gather_nodes at level {level} differs between routes")
    say(f"[7] commit_with_tree 2^16 felts (n = {n}): kernel route == plain route (device='cpu'): root, "
        f"evals, {tree.n_device_levels} device levels, {len(tree.hlevels)} host levels, gather_nodes at "
        f"64 indices of each of the {n + 1} levels")
    del evals, tree, c_evals, c_tree
    data = synthetic_data(felt_bytes(22))
    ops.reset_launch_counts()
    root, evals, tree, n = api.commit_with_tree(data, LOG_BLOWUP, device=dev)
    tree_counts = ops.launch_counts()
    check(collapse_steps() == 0, f"commit_with_tree ran {collapse_steps()} channel steps")
    levels = tree.n_device_levels
    # One merkle_level launch a stored level, each level half as wide as the
    # one below: the first launch is the one-level leaf form, the rest the
    # one-level inner form (a fused launch would divide the width by 8).
    widths = [lvl.shape[-1] for lvl in tree.dlevels]
    check(widths == [1 << (n - k) for k in range(levels)] and levels > 1
          and tree_counts["merkle_collapse"] == 0 and tree_counts["merkle_level"] == levels,
          f"commit_with_tree 2^22: launches {tree_counts} for device levels of widths {widths}")
    check(root.hex() == dict(ANCHORS)[felt_bytes(22)] == api.commit(data, LOG_BLOWUP, device=dev).hex(),
          f"commit_with_tree 2^22: root {root.hex()} != the anchor and api.commit's")
    for level in range(n + 1):  # each node == the hash of its two children, on the host
        stored = rng.integers(0, 1 << (n - level), 64)
        got = np.frombuffer(b"".join(tree.gather_nodes(level, stored)), np.uint32).reshape(-1, 8)
        if level == 0:
            cols = to_numpy_u32(evals[:, torch.from_numpy(bitrev_array(stored, n)).to(dev)]).T
            msgs = np.concatenate([cols, np.zeros((len(stored), 12), np.uint32)], 1)
        else:
            kids = [np.frombuffer(b"".join(tree.gather_nodes(level - 1, 2 * stored + side)),
                                  np.uint32).reshape(-1, 8) for side in (0, 1)]
            msgs = np.concatenate(kids, 1)
        check(np.array_equal(got, merkle.compress_rows_host(msgs)),
              f"commit_with_tree 2^22: a node of level {level} is not the hash of its children")
    tree_ms = device_ms(lambda: merkle.device_levels(evals), reps=3)
    root_ms = device_ms(lambda: merkle.root_level(evals), reps=3)
    roof = profiling.merkle_roofline(n, tree_ms / 1e3, top_log=n - levels + 1, store_levels=True)
    check(0 < roof["sol_fraction"] <= 1, f"device_levels: share {roof['sol_fraction']} outside (0, 1]")
    say(f"[7] commit_with_tree 2^22 felts (n = {n}): root == the 2^22 anchor == api.commit's; {levels} "
        f"device levels, {len(tree.hlevels)} host levels; every level's node at 64 indices == the host "
        f"hash of its children; launches {tree_counts} (one-level merkle_level: 1 leaf, {levels - 1} "
        f"inner); device levels {tree_ms:.4f} ms (graph replay; bound {roof['min_seconds_at_sol'] * 1e3:.4f} "
        f"ms, {roof['bound']}, share {roof['sol_fraction']:.3f}: profiling.merkle_roofline) against the "
        f"fused root_level's {root_ms:.4f} ms")
    del evals, tree
    torch.cuda.empty_cache()
    lap(7)

    # -- 8. proofs against the JAX package's ---------------------------------
    ops.reset_launch_counts()
    cases = [(c["name"], c["data_len"], c["data_seed_offset"], c["seed"], c["config"],
              c["commitment"], c["wire_blake"]) for c in json.loads(FROZEN.read_text())]
    cases += [(name, n_bytes, 0, seed, cfg, com, blake)
              for name, n_bytes, seed, cfg, com, blake in PROVE_ANCHORS]
    phase8 = []  # (proof, seed): phase 11's mixed shapes
    for name, n_bytes, offset, seed, cfg, com, blake in cases:
        data = synthetic_data(n_bytes, offset)
        pcs = PcsConfig.from_dict(cfg)
        t0 = time.perf_counter()
        commitment, proof = api.commit_and_prove(data, seed, pcs, device=dev)
        wall = time.perf_counter() - t0
        got = hashlib.blake2s(proof.to_bytes()).hexdigest()
        check(got == blake, f"proof {name}: wire blake2s {got} != anchor {blake}")
        check(commitment.hex() == com, f"proof {name}: commitment {commitment.hex()} != {com}")
        check(commitment == api.commit(data, pcs.fri_config.log_blowup_factor, device=dev),
              f"proof {name}: commitment differs from api.commit")
        wrong = 1 if seed is None else seed + 1
        check(api.verify(proof, seed), f"proof {name}: verify is False")
        check(not api.verify(tampered(proof), seed), f"proof {name}: a tampered copy verifies")
        check(not api.verify(proof, wrong), f"proof {name}: verifies under seed {wrong}")
        phase8.append((proof, seed))
        say(f"[8] prove {name} ({n_bytes} bytes, seed {seed}): wire bytes match the JAX package's "
            f"({wire_note(proof)}), commitment == api.commit ({wall:.3f} s); verify True, tampered "
            f"copy False, seed {wrong} False")

    # -- 9. the staged prove at full width ------------------------------------
    staged_wires = {}
    for log_felts, nq in ((20, 64), (24, 20)):
        cfg = PcsConfig(pow_bits=20, fri_config=FriConfig(LOG_BLOWUP, 0, nq))
        data = synthetic_data(felt_bytes(log_felts))
        log_total = log_total_for(len(data))
        words = from_numpy_u32(pad_to_words(data, log_total), dev)
        warm_root, warm = api.commit_and_prove_staged(words, log_total, 7, cfg)  # warm-up: tables, caches
        wire = warm.to_bytes()
        staged_wires[log_felts] = wire  # phase 12's sharded proof
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before, steps0 = ops.launch_counts(), collapse_steps()
        api.commit_and_prove_staged(words, log_total, 7, cfg)  # a replay of the graph the warm-up captured
        per_proof = {k: v - before[k] for k, v in ops.launch_counts().items()}
        per_proof[STEPS] = collapse_steps() - steps0
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        reserved = torch.cuda.memory_reserved(dev)
        layers = log_total - 2  # the proof's layers at llb 0: n - last_log
        # every tree (2^5 leaves and more) ends in a collapse, which carries
        # its layer's channel step: 2 transcript launches close the proof
        check(per_proof["fri_fold"] == layers and per_proof["transcript"] == 2 and per_proof[STEPS] == layers
              and per_proof["grind"] == 1 and per_proof["merkle_open_queries"] == 1 and per_proof["merkle_open"] == 0
              and per_proof["order_openings"] == 1,
              f"2^{log_felts}-felt proof: launches {per_proof} for {layers} layers")
        # the warm commit phase waits for nothing; then one fetch
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        os.environ["FRIEDA_SPANS"] = "1"  # the span prints its wall, still with no synchronization
        printed = io.StringIO()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with contextlib.redirect_stderr(printed):
                committed = fri.commit_phase(words[None], log_total, [7], cfg)[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
            del os.environ["FRIEDA_SPANS"]
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        check(printed.getvalue().startswith(f"[span] {SPANS[3]}: "), f"2^{log_felts}-felt commit phase "
              f"under FRIEDA_SPANS=1 printed {printed.getvalue()!r}")
        end.record()
        end.synchronize()
        syncs, finished, opened = finish_counted(fri, committed, log_total, cfg)
        check(syncs == 1 and not opened, f"2^{log_felts}-felt finish_proof: {syncs} synchronizing operations, "
              f"launches {opened}")
        check(finished == wire, f"2^{log_felts}-felt proof after the sync-free commit phase differs")
        say(f"[9] 2^{log_felts}-felt commit phase under sync debug mode 'error' and FRIEDA_SPANS=1: no "
            f"synchronization ({printed.getvalue().strip()}); host enqueue {enqueue_ms:.3f} ms, device "
            f"{start.elapsed_time(end):.3f} ms (CUDA events from before the first launch); then finish_proof: "
            f"{syncs} synchronizing fetch of {committed.packed.numel()} words, no launch; proof bytes unchanged")
        del committed
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = ops.launch_counts()
            committed = fri.dispatch_words(words[None], log_total, [7], cfg)[0]
            between = ops.launch_counts()
            _, proof = fri.finish_proof(committed, log_total, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            check(proof.to_bytes() == wire, f"2^{log_felts}-felt proof changed between runs")
            gathered = {k: between[k] - before[k] for k in ("merkle_open_queries", "order_openings", "merkle_open")
                        if between[k] != before[k]}
            assembled = {k: v - between[k] for k, v in ops.launch_counts().items() if v != between[k]}
            check(gathered == {"merkle_open_queries": 1, "order_openings": 1} and not assembled,
                  f"2^{log_felts}-felt proof: the decommitment launched {gathered} in the commit phase, "
                  f"{assembled} in finish_proof")
        del committed
        say(f"[9] staged prove 2^{log_felts} felts, {nq} queries, pow 20 (a dispatch, then finish_proof): median "
            f"{statistics.median(walls) * 1e3:.3f} ms of {[round(w * 1e3, 3) for w in walls]}; "
            f"kernel launches per proof {per_proof} (the decommitment: merkle_open_queries "
            f"{gathered['merkle_open_queries']} and order_openings {gathered['order_openings']} in the commit "
            f"phase, nothing in finish_proof); "
            f"peak device memory allocated {peak} bytes = {peak / 2**30:.3f} GiB (everything live: the graph "
            f"instances' outputs, tables, words, the decommitment), reserved {reserved / 2**30:.3f} GiB (the "
            f"instances' pools of every key so far included); proof {wire_note(warm)}")
        whole = {"on": [], "off": []}
        profiling.reset_span_totals()
        fri.reset_select_counts()
        for kind in ("on", "off", "off", "on") * 5:  # the commit phase runs ahead of the host
            with contextlib.nullcontext() if kind == "on" else no_spans(fri):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                api.commit_and_prove_staged(words, log_total, 7, cfg)
                whole[kind].append((time.perf_counter() - t0) * 1e3)
        on, off = statistics.median(whole["on"]), whole["off"]
        t0 = time.perf_counter()
        for _ in range(10_000):
            with profiling.span("chip_smoke/empty"):
                pass
        span_us = (time.perf_counter() - t0) / 10_000 * 1e6
        select = profiling.span_totals()["assemble/select"]
        proofs = len(whole["on"]) + len(off)
        check(select.count == len(whole["on"]) and fri.select_counts() == {"cut": proofs, "planned": 0},
              f"2^{log_felts}-felt staged proves: {select.count} assemble/select spans, select_counts "
              f"{fri.select_counts()}; want {len(whole['on'])} spans (the spans-on turns) and all {proofs} proofs "
              "cut from their ordered rows")
        say(f"[9] staged prove 2^{log_felts} felts, {nq} queries: assemble/select "
            f"{select.seconds / select.count * 1e3:.4f} ms a proof over the {select.count} spans-on turns (profiling.span_totals); select_counts "
            f"{fri.select_counts()}")
        say(f"[9] staged prove 2^{log_felts} felts, {nq} queries, in turns: spans on, median "
            f"{on:.3f} ms of {[round(w, 3) for w in whole['on']]}; spans off (utils/profiling.span a no-op), "
            f"median {statistics.median(off):.3f} ms of {[round(w, 3) for w in off]}; the median with spans "
            f"{'lies' if min(off) <= on <= max(off) else 'does NOT lie'} within the spread without them; "
            f"an empty span costs {span_us:.2f} us of host time (10^4 in a row; 3 a staged prove)")
        if log_felts == 20:
            span_trace(dev, data, words, log_total, cfg)
        torch.cuda.synchronize()
        before_bytes = torch.cuda.memory_allocated(dev)
        committed = fri.commit_phase(words[None], log_total, [7], cfg)[0]
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev) - before_bytes
        del committed
        domain = 1 << (log_total - 2 + LOG_BLOWUP)
        safe = fri.safe_in_flight(log_total - 2, cfg.fri_config, dev)
        say(f"[9] one eager Committed of 2^{log_felts} felts keeps {resident} bytes on the card = "
            f"{resident / domain:.3f} bytes per domain element (words uploaded, tables cached); "
            f"prove_many window (a graph instance a proof in flight, fri.RESIDENT_BYTES_PER_ELEMENT "
            f"{fri.RESIDENT_BYTES_PER_ELEMENT}): safe {safe}, default {min(8, safe)} (card total "
            f"{fri.device_memory_bytes(dev)} bytes)")
        check(api.verify(warm, 7), f"2^{log_felts}-felt proof: verify is False")
        check(not api.verify(tampered(warm), 7), f"2^{log_felts}-felt proof: a tampered copy verifies")
        verify_ms = host_ms(lambda: api.verify(warm, 7), 5)  # noqa: B023
        say(f"[9] verify 2^{log_felts}-felt / {nq}-query proof: True, tampered copy False; "
            f"{verify_ms:.3f} ms median of 5 (host)")
        if log_felts == 24:
            del warm, proof
            torch.cuda.empty_cache()
            from portbench.reference import fri as ref

            t0 = time.perf_counter()
            (ref_root, ref_wire), = ref.prove([data], [7], ref.Protocol(LOG_BLOWUP, 0, nq, 20), dev)
            check(ref_wire == wire and ref_root == warm_root, "2^24-felt proof: kernel path bytes != "
                  "portbench/reference's")
            say(f"[9] 2^24-felt proof: kernel path wire bytes and root == portbench/reference's "
                f"(blake2s {hashlib.blake2s(wire).hexdigest()}; reference "
                f"{time.perf_counter() - t0:.2f} s)")
        del words
        torch.cuda.empty_cache()

    # -- 10. launch counts of the commit_many, commit_with_tree and prove phases
    prove_counts = ops.launch_counts()
    prove_steps = collapse_steps()
    check(prove_steps > 0, "the prove phases 8-9 ran no channel step in a collapse")
    say(f"[10] kernel launches in the prove phases 8-9: {prove_counts}; channel steps in collapses {prove_steps}")
    for path, counts, unused in (("commit_many (6)", batch_counts, prove_only),
                                 ("commit_with_tree (7)", tree_counts, prove_only | {"merkle_collapse"}),
                                 ("prove (8-9)", prove_counts, {"fft_exchange", "merkle_open"})):
        for name, count in counts.items():
            check(count > 0 or name in unused, f"kernel {name} was never launched by the {path} path")
    say(f"[10] every kernel of each path launched: commit_many {batch_counts}, commit_with_tree "
        f"{tree_counts} (one-level merkle_level: 1 leaf, {levels - 1} inner, checked in phase 7)")
    lap(10)

    # -- 11. prove_many and verify_many ------------------------------------------
    cfg = PcsConfig(pow_bits=20, fri_config=FriConfig(LOG_BLOWUP, 0, 64))
    datas = [synthetic_data(felt_bytes(20), k) for k in range(8)]
    seeds = list(range(1, 9))
    log_size = log_total_for(len(datas[0])) - 2
    safe = fri.safe_in_flight(log_size, cfg.fri_config, dev)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    batch = api.prove_many(datas, seeds, cfg, device=dev)
    torch.cuda.synchronize()
    cold_wall = time.perf_counter() - t0  # its window's memory is new to the allocator
    many_counts = ops.launch_counts()
    many_steps = collapse_steps()
    many_peak = torch.cuda.max_memory_allocated(dev)
    for name, count in many_counts.items():
        check(count > 0 or name in ("fft_exchange", "merkle_open"), f"kernel {name} was never launched by "
              "prove_many")
    walls = {"loop": [], "prove_many": []}
    for kind in ("loop", "prove_many", "prove_many", "loop"):  # in turns
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "loop":
            out = [api.commit_and_prove(d, s, cfg, device=dev) for d, s in zip(datas, seeds)]
        else:
            out = api.prove_many(datas, seeds, cfg, device=dev)
        torch.cuda.synchronize()
        walls[kind].append(time.perf_counter() - t0)
        if kind == "prove_many":  # its instances captured: replays only
            turn = {"transcript": ops.launch_counts()["transcript"], STEPS: collapse_steps()}
            check(turn == {"transcript": 2 * len(datas), STEPS: len(datas) * log_size},
                  f"prove_many 8 x 2^20 felts: transcript launches and channel steps {turn}, want "
                  f"{2 * len(datas)} and {len(datas) * log_size}")
        for k, ((com, proof), (b_com, b_proof)) in enumerate(zip(out, batch)):
            check(com == b_com and proof.to_bytes() == b_proof.to_bytes(),
                  f"{kind} proof {k} differs from the first prove_many's")
    del out
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        api.prove_many(datas, seeds, cfg, device=dev)
        torch.cuda.synchronize()
        prof_us = (time.perf_counter() - t0) * 1e6
    busy_us, records = device_busy_us(prof)
    check(records > 0 and busy_us < prof_us, f"profile of prove_many: {records} device records, "
          f"busy {busy_us:.0f} us of {prof_us:.0f} us")
    lap(11)
    rate = {k: 8 / statistics.mean(v) for k, v in walls.items()}
    say(f"[11] prove_many 8 x 2^20 felts, 64 queries, pow 20 (domain 2^{log_size + LOG_BLOWUP}): every "
        f"commitment and wire byte == a loop of commit_and_prove; window {min(8, safe)} (safe {safe}); "
        f"walls in turns, ms: loop {walls['loop'][0] * 1e3:.3f}, prove_many "
        f"{walls['prove_many'][0] * 1e3:.3f}, {walls['prove_many'][1] * 1e3:.3f}, loop "
        f"{walls['loop'][1] * 1e3:.3f}: prove_many {rate['prove_many']:.3f} proofs/s, loop "
        f"{rate['loop']:.3f} proofs/s (first prove_many, allocator cold: {cold_wall * 1e3:.3f} ms); peak "
        f"device memory {many_peak} bytes = {many_peak / 2**30:.3f} GiB; idle share "
        f"{1 - busy_us / prof_us:.3f} (device busy {busy_us:.0f} us in {records} records, of "
        f"{prof_us:.0f} us of one profiled prove_many); kernel launches {many_counts}, channel steps "
        f"{many_steps}; in a later run transcript {turn['transcript']}, channel steps {turn[STEPS]}")
    proofs = [p for _, p in batch] + [tampered(batch[0][1]), tampered(batch[1][1]), batch[2][1]]
    vseeds = seeds + [seeds[0], seeds[1], seeds[2] + 100]
    verdicts = [api.verify(p, s) for p, s in zip(proofs, vseeds)]
    check(verdicts == [True] * 8 + [False] * 3, f"verify of prove_many's proofs: {verdicts}")
    check(api.verify_many(proofs, vseeds) == verdicts, "verify_many differs from a loop of verify")
    many_ms = host_ms(lambda: api.verify_many(proofs, vseeds), 5) / len(proofs)
    loop_ms = host_ms(lambda: [api.verify(p, s) for p, s in zip(proofs, vseeds)], 5) / len(proofs)
    mixed = proofs + [p for p, _ in phase8]
    mixed_seeds = vseeds + [s for _, s in phase8]
    want = [api.verify(p, s) for p, s in zip(mixed, mixed_seeds)]
    check(api.verify_many(mixed, mixed_seeds) == want, "verify_many differs from a loop of verify (mixed)")
    say(f"[11] verify_many == a loop of verify over {len(mixed)} proofs of "
        f"{len({(len(p.proof.inner_layers), p.log_size_bound) for p in mixed})} shapes {want}; "
        f"on the 11 of one shape (8 valid, 2 tampered, 1 wrong seed; host): verify_many {many_ms:.3f} "
        f"ms/proof, looped verify {loop_ms:.3f} ms/proof (median of 5)")
    many_out = [(com, p.to_bytes()) for com, p in batch]  # phase 12's prove_many_sharded
    del batch, proofs, mixed
    lap(11)

    # -- 12. the sharded path on virtual shards of cuda:0 ---------------------
    sharded_counts = sharded_phase(dev, results[24]["root"], staged_wires[24], many_out, roots20, datas, seeds)
    del roots20
    lap(12)

    # -- 13. the commit phase as one dispatch -------------------------------------
    graph_phase(dev, staged_wires[24], many_out)
    lap(13)

    # -- 14. the batched commit phase (prove_many_sharded on one card) ------------
    batch_used = batched_phase(dev, kernels, many_out)
    del many_out
    say(f"[14] whole run {time.perf_counter() - t_start:.1f} s")

    check(set(kernels) == {*ops.kernel_wrappers(), STEP_FORM, *BATCH_FORMS}, f"kernels measured {sorted(kernels)}")
    for name, k in kernels.items():
        share = k["bound_ms"] / k["ms"]
        check(0 < share <= 1, f"{name}: bound {k['bound_ms']} ms over device {k['ms']} ms = {share} outside (0, 1]")
        earlier = EARLIER_BOUNDS[name] or "none (a newer kernel than that list)"
        say(f"[3] {name}: bound {k['bound_ms']:.6g} ms ({k['bound_by']}; utils/profiling), PERF.md section 6 "
            f"before it: {earlier} ms; device {k['ms']:.4f} ms, share {share:.3f}")
    say(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
         "launches": batch_used.get(BATCH_FORMS[name][0], 0) if name in BATCH_FORMS else
                     prove_steps + many_steps + sharded_counts[STEPS] if name == STEP_FORM else
                     sum(c[name] for c in (commit_counts, batch_counts, tree_counts, prove_counts, many_counts,
                                           sharded_counts)),
         "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "ms_is": "device time: CUDA events around a replayed CUDA graph of the calls, per call",
         "call_ms": k["call_ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": None}
        for name, k in kernels.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def sharded_phase(dev, anchor24: str, wire24: bytes, many_out: list, roots20: list, datas: list,
                  seeds: list) -> dict:
    """Phase 12: the sharded path (`frieda_tpu_torch.parallel`) over meshes of
    virtual shards of one card (devices: `dev` repeated), each result held
    against the single-device path's, with the host and device ms of both;
    returns the kernel launches of the phase."""
    import torch

    from frieda_tpu_torch import api, ops
    from frieda_tpu_torch.config import FriConfig, PcsConfig
    from frieda_tpu_torch.core import fft, fri, merkle
    from frieda_tpu_torch.ops import ingest as ingest_ops
    from frieda_tpu_torch.parallel import sharding
    from frieda_tpu_torch.utils.convert import from_numpy_u32
    from frieda_tpu_torch.utils.packing import log_total_for, pad_to_words

    from frieda_tpu_torch.ops import merkle as merkle_ops

    sharded_counts = dict.fromkeys([*ops.kernel_wrappers(), STEPS], 0)  # the sharded calls' launches, summed

    def launched(fn) -> tuple:
        """(fn(), {kernel: launches} of that call, and STEPS: the collapses
        that carried a channel step): every count set to 0 just before the
        call and read just after; added to `sharded_counts`."""
        ops.reset_launch_counts()
        out = fn()
        used = {k: v for k, v in {**ops.launch_counts(), STEPS: merkle_ops.merkle_collapse.steps}.items() if v}
        for k, v in used.items():
            sharded_counts[k] += v
        return out, used

    def launched_all_but_exchange(used: dict, what: str) -> None:
        """Every kernel but `fft_exchange` (none at log_blowup 4) and
        `merkle_open` (a one-block row decommits in its commit phase, with
        `merkle_open_queries`)."""
        off = ("fft_exchange", "merkle_open")
        missing = [k for k in ops.kernel_wrappers() if k not in off and not used.get(k)]
        check(not missing and not any(used.get(k) for k in off), f"{what}: launches {used}; not launched: {missing}")

    def enqueue_and_device(fn, strict: bool = False) -> tuple:
        """(host ms to enqueue fn, device ms from before its first launch to
        after its last (CUDA events), fn()); with `strict`, fn runs under
        sync debug mode "error" (a synchronization raises)."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        if strict:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        host = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        return host, start.elapsed_time(end), out

    def mesh_of(n_data: int, n_elem: int):
        return sharding.make_mesh(n_data, n_elem, devices=[dev] * (n_data * n_elem))

    ops.reset_launch_counts()
    data = synthetic_data(felt_bytes(24))
    log_total = log_total_for(len(data))
    words = from_numpy_u32(pad_to_words(data, log_total), dev)
    coeffs = ingest_ops.ingest(words, log_total - 2)
    mesh8 = mesh_of(1, 8)
    for log_blowup, sizes in ((LOG_BLOWUP, (2, 4, 8, 16)), (2, (8,)), (1, (8,))):
        n = log_total - 2 + log_blowup
        tw = fft.stage_twiddles(n, dev)
        want = anchor24 if log_blowup == LOG_BLOWUP else api.commit(data, log_blowup, device=dev).hex()
        single = lambda: merkle.root_level(fft.evaluate_auto(coeffs, tw))  # noqa: B023, E731
        one_dev, one_call = device_ms(single, reps=3), cuda_ms(single)
        one_host = enqueue_and_device(single)[0]
        for S in sizes:
            mesh = mesh8 if S == 8 else mesh_of(1, S)
            t0 = time.perf_counter()
            root_words, used = launched(lambda: sharding.sharded_commit_root(coeffs, n, mesh))  # noqa: B023
            root = merkle.root_bytes(root_words.reshape(8, 1)).hex()
            first = time.perf_counter() - t0
            check(root == want, f"sharded_commit_root 2^24 felts, log_blowup {log_blowup}, S = {S}: {root} != "
                  f"the single-device root {want}")
            exchanges = max(0, S.bit_length() - 1 - log_blowup)
            check(used.get("fft_exchange", 0) == exchanges and used.get("fft_pass", 0) == 2 * S,
                  f"sharded_commit_root S = {S}, log_blowup {log_blowup}: launches {used}")
            fn = lambda: sharding.sharded_commit_root(coeffs, n, mesh)  # noqa: B023, E731
            dev_ms, call = device_ms(fn, reps=3), cuda_ms(fn)
            host = enqueue_and_device(fn)[0]
            say(f"[12] sharded_commit_root 2^24 felts (domain 2^{n}, log_blowup {log_blowup}) over S = {S} "
                f"virtual shards: root == {'phase 5 anchor' if log_blowup == LOG_BLOWUP else 'api.commit'}; "
                f"device {dev_ms:.4f} ms (graph replay), call {call:.4f} ms, host enqueue {host:.4f} ms; "
                f"single device (LDE + tree from the same coefficients): device {one_dev:.4f}, call "
                f"{one_call:.4f}, host enqueue {one_host:.4f} ms; launches {used}; first call (shard tables "
                f"built) {first:.3f} s")
        del tw
        torch.cuda.empty_cache()

    # the 2^24-felt / 20-query proof over 8 shards, against phase 9's; the
    # first call warms up and captures its commit phase, the second is counted
    cfg = PcsConfig(pow_bits=20, fri_config=FriConfig(LOG_BLOWUP, 0, 20))
    t0 = time.perf_counter()
    sharding.sharded_commit_and_prove(data, 7, cfg, mesh8)
    first = time.perf_counter() - t0
    (com, proof), used = launched(lambda: sharding.sharded_commit_and_prove(data, 7, cfg, mesh8))
    check(com.hex() == anchor24 and proof.to_bytes() == wire24,
          "sharded_commit_and_prove 2^24 felts / 20 queries over S = 8: bytes != phase 9's proof")
    check(api.verify(proof, 7), "sharded 2^24-felt proof: verify is False")
    check(not api.verify(tampered(proof), 7), "sharded 2^24-felt proof: a tampered copy verifies")
    # the 2^(log_size + 4) domain folds down to 2^4 (last-layer bound 2^0): log_size folds, each of a
    # layer at least 2S = 16 wide, whose 8 shards (one block on the card) fold in one fri_fold launch
    folds = log_total - 2
    launched_all_but_exchange(used, "sharded_commit_and_prove 2^24 felts over S = 8")
    check(used["fri_fold"] == folds and used["transcript"] == 2 and used.get(STEPS) == folds and used["grind"] == 1
          and used["merkle_open_queries"] == 1 and used["order_openings"] == 1 and used["ingest"] == 1,
          f"sharded_commit_and_prove 2^24 felts over S = 8: launches {used}, want fri_fold {folds} (a block of "
          f"8 shards in one launch a fold; {8 * folds} before), transcript 2, channel steps {folds} (every "
          "layer's on its top tree's collapse), grind, merkle_open_queries, order_openings and ingest 1")
    syncs, finished, opened = finish_counted(fri, fri.dispatch_words(words[None], log_total, [7], cfg, mesh8)[0],
                                             log_total, cfg)
    check(syncs == 0 and not opened and finished == wire24, f"the sharded proof's finish_proof after its "
          f"graph replay: {syncs} synchronizing operations (want none: an event wait for its copy ahead), "
          f"launches {opened}, bytes == phase 9's {finished == wire24}")
    again = fri.finish_proof(fri.commit_phase_sharded(words, log_total, 7, cfg, mesh8, 0), log_total, cfg)[1]
    check(again.to_bytes() == wire24, "sharded staged proof differs from phase 9's")
    host, dev_ms, committed = enqueue_and_device(
        lambda: fri.commit_phase_sharded(words, log_total, 7, cfg, mesh8, 0), strict=True)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            committed.fetch()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    check(syncs == 1, f"sharded commit phase: {syncs} synchronizing operations in its fetch")
    check(fri.finish_proof(committed, log_total, cfg)[1].to_bytes() == wire24,
          "sharded proof after the sync-free commit phase differs")
    # the decommitment of a row of several blocks (shards on several cards, or split over processes):
    # `merkle.ShardedOpening` after the fetch, one `merkle_open` a device; here set on this row's
    # `Committed`, its gathers then unread
    committed = fri.commit_phase_sharded(words, log_total, 7, cfg, mesh8, 0)
    committed.opening_cls = merkle.ShardedOpening
    (_, opened_proof), opened = launched(lambda: fri.finish_proof(committed, log_total, cfg))
    check(opened_proof.to_bytes() == wire24 and opened == {"merkle_open": 1},
          f"the sharded proof through merkle.ShardedOpening: launches {opened}, bytes == phase 9's "
          f"{opened_proof.to_bytes() == wire24}")
    say(f"[12] sharded_commit_and_prove 2^24 felts / 20 queries / pow 20 over S = 8: commitment and wire "
        f"bytes == phase 9's proof; verify True, tampered copy False (first call, with the shard tables, "
        f"the warm-up and the capture: {first:.3f} s); eager commit phase under sync debug mode 'error': "
        f"no synchronization (host enqueue "
        f"{host:.3f} ms, device {dev_ms:.3f} ms), then {syncs} synchronizing fetch; launches per proof {used}; "
        f"finish_proof after a graph replay: no synchronizing call (an event wait), no launch; the same commit phase "
        f"decommitted as a row of several blocks (merkle.ShardedOpening after the fetch): bytes == phase 9's, "
        f"launches {opened}")
    del committed
    rows = {"single": [], "sharded": [], "sharded graph": []}
    commit = {"single": lambda: fri.commit_phase(words[None], log_total, [7], cfg)[0],
              "sharded": lambda: fri.commit_phase_sharded(words, log_total, 7, cfg, mesh8, 0),
              "sharded graph": lambda: fri.dispatch_words(words[None], log_total, [7], cfg, mesh8)[0]}
    for kind in ("single", "sharded", "sharded graph", "sharded graph", "sharded", "single"):  # in turns
        t0 = time.perf_counter()
        host, dev_ms, committed = enqueue_and_device(commit[kind])
        wire = fri.finish_proof(committed, log_total, cfg)[1].to_bytes()
        rows[kind].append((host, dev_ms, (time.perf_counter() - t0) * 1e3))
        check(wire == wire24, f"{kind} staged proof differs from phase 9's")
        del committed
    for kind, runs in rows.items():
        say(f"[12]   2^24-felt / 20-query staged proof, {kind}: commit phase host enqueue ms "
            f"{[round(r[0], 3) for r in runs]}, device ms {[round(r[1], 3) for r in runs]}; whole prove "
            f"(commit phase synchronized, then the decommitment) ms {[round(r[2], 3) for r in runs]}")
    del words, coeffs, mesh8  # the mesh keeps its shard tables
    torch.cuda.empty_cache()

    # prove_many_sharded and commit_roots_batch over a (2, 4) mesh
    mesh24 = mesh_of(2, 4)
    cfg64 = PcsConfig(pow_bits=20, fri_config=FriConfig(LOG_BLOWUP, 0, 64))
    sharding.prove_many_sharded(datas, seeds, cfg64, mesh24)  # each row's key warmed up and captured
    out, used = launched(lambda: sharding.prove_many_sharded(datas, seeds, cfg64, mesh24))
    check([(c, p.to_bytes()) for c, p in out] == many_out, "prove_many_sharded 8 x 2^20 felts over (2, 4) "
          "differs from phase 11's proofs")
    check(all(api.verify(p, s) for (_, p), s in zip(out, seeds)), "a prove_many_sharded proof does not verify")
    check(not api.verify(tampered(out[0][1]), seeds[0]), "a tampered prove_many_sharded proof verifies")
    # every shard on one card: the batch as two batched commit phases of 4 blobs (phase 14), each kernel
    # once a layer a dispatch and not once a blob
    folds = log_total_for(len(datas[0])) - 2
    launched_all_but_exchange(used, "prove_many_sharded 8 x 2^20 felts over (2, 4)")
    check(used["fri_fold"] == 2 * folds and used["grind"] == 2 and used["merkle_open_queries"] == 2
          and used["order_openings"] == 2 and used["transcript"] == 4 and used.get(STEPS) == 2 * folds,
          f"prove_many_sharded: launches {used}, want for its two dispatches fri_fold {2 * folds}, grind, "
          f"merkle_open_queries and order_openings 2, transcript 4, channel steps {2 * folds}")
    log_total20 = log_total_for(len(datas[1]))
    syncs, opened = 0, {}
    for b, c in enumerate(fri.dispatch_blobs(datas, log_total20, seeds, cfg64, dev)):
        s, finished, o = finish_counted(fri, c, log_total20, cfg64)
        syncs, opened = syncs + s, {**opened, **o}
        check(finished == many_out[b][1], f"prove_many_sharded's batch, row {b}: bytes != phase 11's")
    check(syncs == 0 and not opened, f"a dispatch_blobs' 8 finish_proof calls: {syncs} synchronizing "
          f"operations, launches {opened}; want none (an event wait for its copy ahead) and none")
    # the per-blob route of meshes over several devices or a process group (`prove_many_per_blob`),
    # driven on the same one-card (2, 4) mesh: each blob's commit phase element-sharded over its row,
    # a graph replay a blob, every fold of a block of 4 shards in one fri_fold launch
    per_blob = lambda: sharding.prove_many_per_blob(datas, seeds, log_total20, cfg64, mesh24)  # noqa: E731
    per_blob()  # each row's key warmed up and captured, an instance a blob of the row
    out_blob, used_blob = launched(per_blob)
    check([(c, p.to_bytes()) for c, p in out_blob] == many_out, "prove_many_per_blob 8 x 2^20 felts over (2, 4) "
          "differs from phase 11's proofs")
    check(all(api.verify(p, s) for (_, p), s in zip(out_blob, seeds)), "a prove_many_per_blob proof does not verify")
    check(not api.verify(tampered(out_blob[0][1]), seeds[0]), "a tampered prove_many_per_blob proof verifies")
    launched_all_but_exchange(used_blob, "prove_many_per_blob 8 x 2^20 felts over (2, 4)")
    check(used_blob["fri_fold"] == len(datas) * folds and used_blob["grind"] == len(datas)
          and used_blob["merkle_open_queries"] == len(datas) and used_blob["order_openings"] == len(datas)
          and used_blob["transcript"] == 2 * len(datas)
          and used_blob.get(STEPS) == len(datas) * folds,
          f"prove_many_per_blob: launches {used_blob}, want fri_fold {len(datas) * folds} (a block's 4 shards "
          f"in one launch a fold), grind and merkle_open_queries {len(datas)}, transcript {2 * len(datas)}, "
          f"channel steps {len(datas) * folds}")
    syncs_blob, finished, opened_blob = finish_counted(
        fri, fri.dispatch_blobs([datas[1]], log_total20, [seeds[1]], cfg64, dev, mesh24, 0)[0], log_total20, cfg64)
    check(syncs_blob == 0 and not opened_blob and finished == many_out[1][1], f"a prove_many_per_blob blob's "
          f"finish_proof: {syncs_blob} synchronizing operations, launches {opened_blob}, bytes == phase 11's "
          f"{finished == many_out[1][1]}")
    blobs = [synthetic_data(felt_bytes(20), k) for k in range(16)]
    roots, used_roots = launched(lambda: sharding.commit_roots_batch(blobs, LOG_BLOWUP, mesh24))
    check(roots == roots20, "commit_roots_batch 16 x 2^20 felts over (2, 4) differs from api.commit_many")
    check(all(used_roots.get(k) for k in ("ingest", "fft_pass", "merkle_level", "merkle_collapse"))
          and STEPS not in used_roots, f"commit_roots_batch: launches {used_roots}")
    walls = {k: [] for k in ("prove_many", "prove_many_sharded", "prove_many_per_blob", "commit_many",
                             "commit_roots_batch")}
    calls = {"prove_many": lambda: api.prove_many(datas, seeds, cfg64, device=dev),
             "prove_many_sharded": lambda: sharding.prove_many_sharded(datas, seeds, cfg64, mesh24),
             "prove_many_per_blob": per_blob,
             "commit_many": lambda: api.commit_many(blobs, LOG_BLOWUP, device=dev),
             "commit_roots_batch": lambda: sharding.commit_roots_batch(blobs, LOG_BLOWUP, mesh24)}
    for one, sharded in (("prove_many", "prove_many_sharded"), ("prove_many_per_blob", "prove_many_sharded"),
                         ("commit_many", "commit_roots_batch")):
        for kind in (one, sharded, sharded, one):  # in turns
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[kind]()
            walls[kind].append(round((time.perf_counter() - t0) * 1e3, 3))
    busy = {}  # kind: (device busy ms, idle share) over one profiled call
    for kind, fn in calls.items():
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy_us, records = device_busy_us(prof)
        check(records > 0 and busy_us < wall_us, f"profile of {kind}: {records} records, busy {busy_us:.0f} "
              f"us of {wall_us:.0f} us")
        busy[kind] = f"device busy {busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.3f}"
    say(f"[12] prove_many_sharded 8 x 2^20 felts / 64 queries over a (2, 4) mesh: every commitment and wire "
        f"byte == phase 11's prove_many, each verifies, a tampered copy does not; launches {used} (two batched "
        f"commit phases); a dispatch_blobs' 8 finish_proof calls: no synchronizing call (an event wait), no "
        f"launch; walls in "
        f"turns, ms: prove_many {walls['prove_many']}, prove_many_sharded {walls['prove_many_sharded']} (the "
        f"first two against prove_many, the last two against the per-blob route); one profiled call each: "
        f"prove_many {busy['prove_many']}, prove_many_sharded {busy['prove_many_sharded']}")
    say(f"[12] prove_many_per_blob (the route of meshes over several devices or a process group) 8 x 2^20 "
        f"felts / 64 queries over the same (2, 4) mesh: every commitment and wire byte == phase 11's, each "
        f"verifies, a tampered copy does not; launches {used_blob} (a graph replay a blob); a blob's "
        f"finish_proof after its graph replay: {syncs_blob} synchronizing calls (an event wait), launches "
        f"{opened_blob}; walls "
        f"in turns with prove_many_sharded, ms: {walls['prove_many_per_blob']}; one profiled call: "
        f"{busy['prove_many_per_blob']}")
    say(f"[12] commit_roots_batch 16 x 2^20 felts over a (2, 4) mesh: every root == api.commit_many's; "
        f"launches {used_roots}; walls in turns, ms: commit_many {walls['commit_many']}, commit_roots_batch "
        f"{walls['commit_roots_batch']}; one profiled call each: commit_many {busy['commit_many']}, "
        f"commit_roots_batch {busy['commit_roots_batch']}")
    for name, count in sharded_counts.items():
        check(count > 0, f"kernel {name} was never launched by the sharded calls (phase 12)")
    say(f"[12] kernel launches of phase 12's sharded calls (the counted call of each; every kernel > 0, "
        f"merkle_open in the decommitment of a row of several blocks only): {sharded_counts}")
    return sharded_counts


def graph_phase(dev, wire24: bytes | None = None, many_out: list | None = None) -> None:
    """Phase 13: the commit phase as one dispatch (`fri.dispatch_words`, a
    cached CUDA graph) against the eager `fri.commit_phase`, at the two
    prove cells and the sharded proof; the cache's keys, leases and tables;
    `prove_many` through it. wire24: phase 9's 2^24-felt proof; many_out:
    phase 11's prove_many [(commitment, wire bytes)] (None when this phase
    runs alone)."""
    import weakref

    import torch

    from frieda_tpu_torch import api, ops
    from frieda_tpu_torch.config import FriConfig, PcsConfig
    from frieda_tpu_torch.core import fft, fri
    from frieda_tpu_torch.ops import merkle as merkle_ops
    from frieda_tpu_torch.parallel import sharding
    from frieda_tpu_torch.utils import profiling
    from frieda_tpu_torch.utils.convert import from_numpy_u32
    from frieda_tpu_torch.utils.packing import log_total_for, pad_to_words

    t_phase = time.perf_counter()
    fri.clear_commit_graphs()  # every key of phases 8-12 is free: their pools go
    torch.cuda.empty_cache()
    mesh8 = sharding.make_mesh(1, 8, devices=[dev] * 8)
    anchor20 = next(blake for name, _, _, _, _, blake in PROVE_ANCHORS if name == "felts2p20_64q")

    def captures() -> int:
        return fri.commit_graphs()[0]

    def counted(fn) -> tuple:
        """(fn(), its kernel launches and STEPS, the collapses that carried a
        channel step)."""
        ops.reset_launch_counts()
        out = fn()
        return out, {k: v for k, v in {**ops.launch_counts(), STEPS: merkle_ops.merkle_collapse.steps}.items() if v}

    def clocked(fn, finish) -> tuple:
        """(host enqueue ms, device ms from before the first launch to after
        the last (CUDA events), whole prove ms): fn() enqueues the commit
        phase, finish(committed) decommits it."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        committed = fn()
        host = (time.perf_counter() - t0) * 1e3
        end.record()
        finish(committed)
        wall = (time.perf_counter() - t0) * 1e3
        return host, start.elapsed_time(end), wall

    cells = (("2^20 felts / 64 q", 20, 64, None), ("2^24 felts / 20 q", 24, 20, None),
             ("2^24 felts / 20 q over 8 virtual shards", 24, 20, mesh8))
    for what, log_felts, nq, mesh in cells:
        cfg = PcsConfig(pow_bits=20, fri_config=FriConfig(LOG_BLOWUP, 0, nq))
        data = synthetic_data(felt_bytes(log_felts))
        log_total = log_total_for(len(data))
        words = from_numpy_u32(pad_to_words(data, log_total), dev)
        words2 = from_numpy_u32(pad_to_words(synthetic_data(felt_bytes(log_felts), 1), log_total), dev)
        domain = 1 << (log_total - 2 + LOG_BLOWUP)

        def eager(w=words, seed=7):
            if mesh is None:
                return fri.commit_phase(w[None], log_total, [seed], cfg)[0]
            return fri.commit_phase_sharded(w, log_total, seed, cfg, mesh, 0)  # noqa: B023

        def graph(w=words, seed=7):
            return fri.dispatch_words(w[None], log_total, [seed], cfg, mesh)[0]  # noqa: B023

        def finish(c):
            return fri.finish_proof(c, log_total, cfg)[1].to_bytes()  # noqa: B023

        want, eager_counts = counted(lambda: finish(eager()))
        want2 = finish(eager(words2, 8))
        n0 = captures()
        t0 = time.perf_counter()
        first = graph()
        first_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(dev)
        second = graph(words2, 8)  # `first` holds its lease: a second instance
        torch.cuda.synchronize()
        grown = torch.cuda.memory_reserved(dev) - reserved0
        check(captures() - n0 == 2, f"{what}: {captures() - n0} captures for two leases of one key")
        got2, got = finish(second), finish(first)  # in reverse order
        check(got == want and got2 == want2, f"{what}: graph proof bytes != eager's (two live Committed, "
              "finished in reverse order)")
        if mesh is None and log_felts == 20:
            check(hashlib.blake2s(got).hexdigest() == anchor20, f"{what}: graph proof != the JAX anchor")
        if log_felts == 24 and wire24 is not None:
            check(got == wire24, f"{what}: graph proof != phase 9's (portbench/reference's bytes)")
        n1 = captures()
        repeated, graph_counts = counted(lambda: [finish(graph()) for _ in range(3)])
        check(all(r == want for r in repeated) and captures() == n1,
              f"{what}: 3 repeated graph proofs: {captures() - n1} captures, bytes equal {repeated == [want] * 3}")
        check(graph_counts == {k: 3 * v for k, v in eager_counts.items()},
              f"{what}: launches of 3 graph proofs {graph_counts}, eager proof {eager_counts}")
        prof, committed = traced_run(
            graph, lambda c: check(finish(c) == want, f"{what}: the trace's warm replay's proof differs"))  # noqa: B023
        traced = traced_launches(prof)
        recorded = committed._lease.launches
        check(traced == recorded and {**recorded, STEPS: committed._lease.steps} == eager_counts,
              f"{what}: kernels in a torch.profiler trace of one replay {traced}, recorded at its capture "
              f"{recorded} and {committed._lease.steps} channel steps, eager commit phase {eager_counts}")
        check(finish(committed) == want, f"{what}: the traced replay's proof differs")
        port, plain, copies, windows = replay_device_ms(prof)
        grind_ms = port["grind"][1]
        b_ms, b_by = profiling.grind_bound(committed.nonce)
        say(f"[13]   {what}: the replay's grind: nonce {committed.nonce}, device {grind_ms:.4f} ms (its record), "
            f"bound {b_ms:.6f} ms ({b_by}), share {b_ms / grind_ms:.3f}; {grind_form(1)}")
        say(f"[13]   {what}: one replay's device records (torch.profiler, [records, summed ms, summed ms of "
            f"the gaps after them]): the port's kernels "
            f"{({k: [n, round(ms, 4), round(gap, 4)] for k, (n, ms, gap) in port.items()})}; plain PyTorch "
            f"{sum(v[0] for v in plain.values())} kernels, {sum(v[1] for v in plain.values()):.4f} ms "
            f"({({k: [n, round(ms, 4), round(gap, 4)] for k, (n, ms, gap) in plain.items()})}); copies and "
            f"fills {copies[0]}, {copies[1]:.4f} ms; the close's plain PyTorch ([records, summed ms, device ms "
            f"between the neighbouring kernels]): "
            f"{({k: [n, round(ms, 4), round(gap, 4)] for k, (n, ms, gap) in windows.items()})}")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            committed = graph()  # copy, seed fill, replay
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs, finished, opened = finish_counted(fri, committed, log_total, cfg)
        check(syncs == 0 and not opened and finished == want, f"{what}: finish_proof after the dispatch made "
              f"{syncs} synchronizing operations (want none: an event wait for its copy ahead) and launched "
              f"{opened}, or its proof differs")
        del committed
        rows = {"eager": [], "graph": []}
        for r in range(5):  # in turns
            for kind in ("eager", "graph") if r % 2 == 0 else ("graph", "eager"):
                rows[kind].append(clocked(eager if kind == "eager" else graph, finish))
        copy_ms = cuda_ms(lambda: torch.empty_like(words).copy_(words))  # noqa: B023
        med = {k: [statistics.median(r[i] for r in v) for i in range(3)] for k, v in rows.items()}
        say(f"[13] {what}: graph proof bytes == eager's{' == the JAX anchor' if log_felts == 20 and mesh is None else ''}"
            f"{' == phase 9' if log_felts == 24 and wire24 is not None else ''}; first dispatch (warm-up, "
            f"capture, replay) {first_s:.3f} s; a second live Committed captured a second instance: "
            f"memory_reserved +{grown} bytes = {grown / domain:.3f} bytes per domain element "
            f"({'within' if grown <= fri.RESIDENT_BYTES_PER_ELEMENT * domain else 'ABOVE'} "
            f"fri.RESIDENT_BYTES_PER_ELEMENT {fri.RESIDENT_BYTES_PER_ELEMENT}); both proofs == eager, finished in "
            f"reverse order; 3 repeated proofs: no capture, launches per proof == eager's {eager_counts}; a "
            f"torch.profiler trace of one replay holds each recorded launch: {traced}; "
            f"the dispatch (copy, seed fill, replay, the row's copy ahead) under sync debug mode 'error': no "
            f"synchronization, then finish_proof: {syncs} synchronizing calls (an event wait), launches "
            f"{opened or 'none'}")
        for kind, runs in rows.items():
            say(f"[13]   {what}, {kind} commit phase, 5 in turns: host enqueue ms "
                f"{[round(x[0], 3) for x in runs]} (median {med[kind][0]:.3f}), device ms "
                f"{[round(x[1], 3) for x in runs]} (median {med[kind][1]:.3f}), whole prove ms "
                f"{[round(x[2], 3) for x in runs]} (median {med[kind][2]:.3f})")
        say(f"[13]   {what}: the words' device-to-device copy into the static buffer {copy_ms:.4f} ms "
            f"({words.numel() * 4} bytes)")
        del words, words2, first, second
        torch.cuda.empty_cache()
    del mesh8

    # nine keys: 2^10 felts at 1-9 queries; the ninth evicts the first
    data = synthetic_data(felt_bytes(10))
    log_total = log_total_for(len(data))
    words = from_numpy_u32(pad_to_words(data, log_total), dev)
    cfgs = [PcsConfig(pow_bits=8, fri_config=FriConfig(LOG_BLOWUP, 0, q)) for q in range(1, 10)]
    n0 = captures()
    firsts = [api.commit_and_prove_staged(words, log_total, 7, c)[1].to_bytes() for c in cfgs]
    keys = fri.commit_graphs()[1]
    check(captures() - n0 == 9 and len(keys) == 8, f"9 keys: {captures() - n0} captures, {len(keys)} kept")
    again = api.commit_and_prove_staged(words, log_total, 7, cfgs[0])[1].to_bytes()
    check(captures() - n0 == 10 and again == firsts[0], f"the first of 9 keys: {captures() - n0 - 9} captures "
          "on its return, or its proof changed")
    n = log_total - 2 + LOG_BLOWUP
    held = weakref.ref(fri.fold_tables(n, dev)[0]), weakref.ref(fft.stage_twiddles(n, dev))
    fri._fold_tables.clear()
    fft._stage_twiddles_dev.clear()
    gc.collect()
    check(all(ref() is not None for ref in held), "a live graph's tables were freed with the caches")
    check(api.commit_and_prove_staged(words, log_total, 7, cfgs[0])[1].to_bytes() == firsts[0],
          "a live graph's proof changed after the caches were cleared")
    check(fri.finish_proof(fri.commit_phase(words[None], log_total, [7], cfgs[0])[0], log_total, cfgs[0])[1].to_bytes()
          == firsts[0], "the eager proof changed after the caches were cleared (tables uploaded again)")
    say(f"[13] 9 keys (2^10 felts, 1-9 queries): 9 captures, 8 keys kept; the first key captured again on "
        f"its return, proof unchanged; the fold and stage tables' caches cleared: the live graph still holds "
        f"its tables and its proof is unchanged, and the eager path uploads them again")
    del words

    # prove_many on phase 11's blobs
    cfg = PcsConfig(pow_bits=20, fri_config=FriConfig(LOG_BLOWUP, 0, 64))
    datas = [synthetic_data(felt_bytes(20), k) for k in range(8)]
    seeds = list(range(1, 9))
    log_size = log_total_for(len(datas[0])) - 2
    window = min(8, fri.safe_in_flight(log_size, cfg.fri_config, dev))
    fri.clear_commit_graphs()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reserved0 = torch.cuda.memory_reserved(dev)
    t0 = time.perf_counter()
    batch = [(c, p.to_bytes()) for c, p in api.prove_many(datas, seeds, cfg, device=dev)]
    torch.cuda.synchronize()
    cold = (time.perf_counter() - t0) * 1e3
    peak, peak_reserved = torch.cuda.max_memory_allocated(dev), torch.cuda.max_memory_reserved(dev)
    grown = torch.cuda.memory_reserved(dev) - reserved0
    instances = list(fri.commit_graphs()[1].values())
    check(instances == [window], f"prove_many with window {window}: instances {instances}")
    looped = [(c, p.to_bytes()) for c, p in (api.commit_and_prove(d, s, cfg, device=dev)
                                             for d, s in zip(datas, seeds))]
    check(batch == looped and (many_out is None or batch == many_out),
          "prove_many through the graphs != a loop of commit_and_prove (or phase 11's)")
    walls = {"loop": [], "prove_many": []}
    for kind in ("loop", "prove_many", "prove_many", "loop"):  # in turns
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "loop":
            for d, s in zip(datas, seeds):
                api.commit_and_prove(d, s, cfg, device=dev)
        else:
            api.prove_many(datas, seeds, cfg, device=dev)
        torch.cuda.synchronize()
        walls[kind].append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        api.prove_many(datas, seeds, cfg, device=dev)
        torch.cuda.synchronize()
        prof_us = (time.perf_counter() - t0) * 1e6
    busy_us, records = device_busy_us(prof)
    check(records > 0 and busy_us < prof_us, f"profile of prove_many: {records} records, busy {busy_us:.0f} us")
    rate = {k: 8 / statistics.mean(v) * 1e3 for k, v in walls.items()}
    say(f"[13] prove_many 8 x 2^20 felts / 64 q through the graphs: bytes == a loop of commit_and_prove"
        f"{' == phase 11' if many_out is not None else ''}; {instances[0]} instances of its key (window "
        f"{window}); first call (1 warm-up, {window} captures) {cold:.3f} ms; walls in turns, ms: loop "
        f"{walls['loop'][0]:.3f}, prove_many {walls['prove_many'][0]:.3f}, {walls['prove_many'][1]:.3f}, loop "
        f"{walls['loop'][1]:.3f}: prove_many {rate['prove_many']:.3f} proofs/s, loop {rate['loop']:.3f} "
        f"proofs/s; idle share {1 - busy_us / prof_us:.3f} (device busy {busy_us:.0f} us in {records} records "
        f"of {prof_us:.0f} us); peak allocated {peak / 2**30:.3f} GiB, peak reserved {peak_reserved / 2**30:.3f} "
        f"GiB, reserved growth over the first call {grown / 2**30:.3f} GiB (the {window} pools), of "
        f"{fri.device_memory_bytes(dev) / 2**30:.3f} GiB (60%: {0.6 * fri.device_memory_bytes(dev) / 2**30:.3f})")
    check(peak_reserved <= 0.6 * fri.device_memory_bytes(dev), "prove_many's reserved memory above 60% of the card")
    del datas, batch, looped

    # prove_many at 2^24 felts over several keys in a row: each call's window
    # of instances stays cached, and a later key's captures close the free
    # instances of the least recently used keys to keep within 60% of the card
    total = fri.device_memory_bytes(dev)
    budget = int(fri.MEMORY_SHARE * total)
    datas = [synthetic_data(felt_bytes(24), k) for k in range(8)]
    log_total = log_total_for(len(datas[0]))
    words0 = from_numpy_u32(pad_to_words(datas[0], log_total), dev)
    fri.clear_commit_graphs()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    notes = []
    for nq, seeded in ((20, True), (20, False), (21, True), (22, True)):
        cfg = PcsConfig(pow_bits=20, fri_config=FriConfig(LOG_BLOWUP, 0, nq))
        seeds = list(range(1, 9)) if seeded else [None] * 8
        window = min(8, fri.safe_in_flight(log_total - 2, cfg.fri_config, dev))
        t0 = time.perf_counter()
        proofs = [p for _, p in api.prove_many(datas, seeds, cfg, device=dev)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eager = fri.finish_proof(fri.commit_phase(words0[None], log_total, seeds[:1], cfg)[0], log_total, cfg)[1]
        check(proofs[0].to_bytes() == eager.to_bytes(), f"prove_many 2^24 felts / {nq} q seeded {seeded}: "
              "proof 0 != the eager proof")
        check(all(api.verify(p, s) for p, s in zip(proofs, seeds)), f"prove_many 2^24 / {nq} q: a proof fails")
        held = fri._GRAPHS.held_bytes(dev)
        keys = list(fri.commit_graphs()[1].values())
        check(held <= budget and keys[-1] == window, f"prove_many 2^24 / {nq} q: the cache holds {held} bytes "
              f"(budget {budget}), instances per key {keys}, window {window}")
        notes.append(f"{nq} q {'seeded' if seeded else 'no seed'}: window {window}, {wall:.3f} s, instances "
                     f"per key {keys}, {held / 2**30:.3f} GiB held, reserved "
                     f"{torch.cuda.memory_reserved(dev) / 2**30:.3f} GiB")
        del proofs
    say(f"[13] prove_many 8 x 2^24 felts over 4 keys in a row (proof 0 of each == the eager proof, every "
        f"proof verifies): {'; '.join(notes)}; the cache within {budget / 2**30:.3f} GiB "
        f"(fri.MEMORY_SHARE of {total / 2**30:.3f} GiB) after each call; peak reserved over the sequence "
        f"{torch.cuda.max_memory_reserved(dev) / 2**30:.3f} GiB, peak allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    del datas, words0
    fri.clear_commit_graphs()
    torch.cuda.empty_cache()
    say(f"[13] phase 13 took {time.perf_counter() - t_phase:.1f} s")


# The kernels line's entries for the batched forms that phase 14 measures (the
# batched commit phase of `prove_many_sharded` on one card): name -> (wrapper
# count that gives their launches on its main path, source, what they replace).
BATCH_FORMS = {
    "fri_fold[batch]": ("fri_fold", "frieda_tpu_torch/csrc/fri.cu",
                        "frieda_tpu/core/fri.py:211 fold_c and :219 fold_l under jax.vmap (:318-328; XLA)"),
    "transcript[batch]": ("transcript", "frieda_tpu_torch/csrc/channel.cu",
                          "frieda_tpu/core/device_channel.py:33-191 (dc_mix_*, dc_sample_query_words) under "
                          "jax.vmap (frieda_tpu/core/fri.py:318-328; XLA)"),
    "grind[batch]": ("grind", "frieda_tpu_torch/csrc/channel.cu",
                     "frieda_tpu/core/device_channel.py:145 dc_grind under jax.vmap (frieda_tpu/core/fri.py:318-328; "
                     "XLA)"),
    "merkle_collapse+step[batch]": (STEPS, "frieda_tpu_torch/csrc/merkle.cu",
                                    "frieda_tpu/ops/merkle_pallas.py:240 (collapse_multi) with "
                                    "frieda_tpu/core/device_channel.py:76-126 under jax.vmap (XLA)"),
    "merkle_open_queries[batch]": ("merkle_open_queries", "frieda_tpu_torch/csrc/merkle.cu",
                                   "frieda_tpu/core/fri.py:283-316 gathers and :68 _auth_sibling_nodes under "
                                   "jax.vmap (XLA)"),
}


def batched_phase(dev, kernels: dict, many_out: list | None = None) -> dict:
    """Phase 14: the commit phase over a batch (`fri.commit_phase`, the
    JAX package's `_fri_commit_fn(..., batched=True)`) that
    `prove_many_sharded` runs as one graph replay over a mesh of one card.
    Each batched kernel against its plain version at B = 1, 3 and 8 on
    phase 11's 2^20-felt / 64-query shapes; `prove_many_sharded` over (8, 1)
    and (2, 4) meshes of the card against phase 11's proofs (many_out: its
    [(commitment, wire bytes)], or None to prove them here), its replays,
    captures, launches, synchronizations and fetches; the batched replay's
    device ms beside 8 single replays', the whole call's beside
    `prove_many`'s. Fills `kernels` with the BATCH_FORMS entries; returns
    the launches of the counted `prove_many_sharded` call (its main path)."""
    import torch

    from frieda_tpu_torch import api, ops
    from frieda_tpu_torch.config import FriConfig, PcsConfig
    from frieda_tpu_torch.core import device_channel as dc
    from frieda_tpu_torch.core import fri, merkle
    from frieda_tpu_torch.ops import channel as channel_ops
    from frieda_tpu_torch.ops import fri as fri_ops
    from frieda_tpu_torch.ops import merkle as merkle_ops
    from frieda_tpu_torch.parallel import sharding
    from frieda_tpu_torch.utils import packing, profiling
    from frieda_tpu_torch.utils.convert import from_numpy_u32, narrow, to_numpy_u32, widen
    from frieda_tpu_torch.utils.packing import log_total_for, upload_words

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 14)

    def rand_u32(shape, hi=1 << 32):
        return from_numpy_u32(rng.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32), dev)

    def max_abs_err(a, b) -> int:
        return int((widen(a) - widen(b)).abs().max().item())

    def counted(fn) -> tuple:
        """(fn(), its kernel launches and STEPS), every count set to 0 just
        before the call and read just after."""
        ops.reset_launch_counts()
        out = fn()
        return out, {k: v for k, v in {**ops.launch_counts(), STEPS: merkle_ops.merkle_collapse.steps}.items() if v}

    cfg = PcsConfig(pow_bits=20, fri_config=FriConfig(LOG_BLOWUP, 0, 64))
    datas = [synthetic_data(felt_bytes(20), k) for k in range(8)]
    seeds = list(range(1, 9))
    log_total = log_total_for(len(datas[0]))
    n = log_total - 2 + LOG_BLOWUP
    layers = log_total - 2  # the proof's trees and folds: 2^24 ... 2^5 values
    entry = {}  # form -> dict of the kernels line
    errs = dict.fromkeys(BATCH_FORMS, 0)

    # fri_fold: (B, 4, 2^n) -> (B, 4, 2^(n - 1)), the proofs' first fold, with the
    # shared ys_inv and with a table a blob; a (4,) alpha shared by rows with a
    # table a row (a block of shards); one block wide
    ys, _ = fri.fold_tables(n, dev)
    for B in (1, 3, 8):
        values, alphas = rand_u32((B, 4, 1 << n), P), rand_u32((B, 4), P)
        for what, alpha, inv in (("the shared ys_inv", alphas, ys),
                                 ("a table a blob", alphas, rand_u32((B, 1 << (n - 1)), P)),
                                 ("one shared alpha, a table a row", alphas[0], rand_u32((B, 1 << (n - 1)), P))):
            got = fri_ops.fri_fold(values, alpha, inv)
            want = torch.stack([narrow(fri_ops.fri_fold_plain(
                widen(values[b]), widen(alpha if alpha.dim() == 1 else alpha[b]),
                widen(inv if inv.dim() == 1 else inv[b]))) for b in range(B)])
            check(torch.equal(got, want), f"fri_fold B = {B} with {what} differs from a loop of plain folds")
            errs["fri_fold[batch]"] = max(errs["fri_fold[batch]"], max_abs_err(got, want))
            del got, want
        small = rand_u32((B, 4, 1 << 6), P)
        check(torch.equal(fri_ops.fri_fold(small, alphas, ys[: 1 << 5]),
                          narrow(fri_ops.fri_fold_plain(widen(small), widen(alphas), widen(ys[: 1 << 5])))),
              f"fri_fold B = {B} at (4, 2^6) differs from plain")
        if B == 8:
            half = 1 << (n - 1)
            ms = device_ms(lambda: fri_ops.fri_fold(values, alphas, ys), reps=4)  # noqa: B023
            rows = [(values[b], alphas[b]) for b in range(B)]
            singles = device_ms(lambda: [fri_ops.fri_fold(v, a, ys) for v, a in rows], reps=4)  # noqa: B023
            v64, a64, i64 = widen(values), widen(alphas), widen(ys)
            plain_ms = cuda_ms(lambda: fri_ops.fri_fold_plain(v64, a64, i64), reps=3)  # noqa: B023
            call = cuda_ms(lambda: fri_ops.fri_fold(values, alphas, ys))  # noqa: B023
            b_ms, b_by = profiling.fri_fold_bound(half, blobs=B)
            entry["fri_fold[batch]"] = dict(ms=ms, call_ms=call, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            say(f"[14] fri_fold (8, 4, 2^{n}) -> (8, 4, 2^{n - 1}), one launch: device {ms:.4f} ms, call {call:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; share {b_ms / ms:.3f}); 8 single launches "
                f"device {singles:.4f} ms")
            del v64, a64, i64, rows
        del values
        torch.cuda.empty_cache()
    say(f"[14] fri_fold B = 1, 3, 8 at (B, 4, 2^{n}) (ys_inv shared, a table a blob, one alpha and a table a "
        "row) and (B, 4, 2^6): bit-equal to a loop of fri_fold_plain")

    # the collapse with a channel step a blob, with and without the seeds, and
    # with DRAW_BOUND lowered so that some blobs' draws retry and others' do not
    def step_case(B: int, m: int, with_seed: bool) -> list:
        widths = merkle.tail_widths(m)
        level, states = rand_u32((B, 8, m)), rand_u32((B, 9))
        seed = rand_u32((B, 2)) if with_seed else None
        kernel, plain = (channel_ops.ChannelStep(states.clone(), seed, torch.zeros((B, 4), dtype=torch.int32,
                                                                                     device=dev)) for _ in range(2))
        got = merkle_ops.merkle_collapse(level, widths, step=kernel)
        want = [narrow(w) for w in merkle_ops.merkle_collapse_plain(widen(level), widths, plain)]
        check(all(torch.equal(g, w) for g, w in zip(got, want)) and torch.equal(kernel.state, plain.state)
              and torch.equal(kernel.alpha, plain.alpha),
              f"merkle_collapse B = {B}, m = {m} with a step a blob (seeds {with_seed}) differs from plain")
        errs["merkle_collapse+step[batch]"] = max(
            errs["merkle_collapse+step[batch]"], max(max_abs_err(g, w) for g, w in zip(got, want)),
            max_abs_err(kernel.state, plain.state), max_abs_err(kernel.alpha, plain.alpha))
        return to_numpy_u32(kernel.state[:, 8]).tolist()

    for B in (1, 3, 8):
        for m in (2, 256, 4096):
            for with_seed in (False, True):
                step_case(B, m, with_seed)
    bound0, n_sent = dc.DRAW_BOUND, []
    dc.DRAW_BOUND = 15 << 28  # an attempt passes with probability (15/16)^8, about 0.6
    try:
        for B in (1, 3, 8):
            for m in (2, 256, 4096):
                n_sent += step_case(B, m, True)
    finally:
        dc.DRAW_BOUND = bound0
    check(min(n_sent) == 1 and max(n_sent) > 1, f"lowered DRAW_BOUND: n_sent {n_sent}, want some 1 and some more")
    say(f"[14] merkle_collapse with a channel step a blob, B = 1, 3, 8, m = 2, 256, 4096 -> tail widths and 1, "
        f"with and without the seeds: outputs, states and alphas bit-equal to a loop of the plain collapse + "
        f"transcript_plain; with DRAW_BOUND 15 x 2^28 (n_sent a blob {n_sent}: some draws retried, others not): "
        f"bit-equal")
    level8 = rand_u32((8, 8, 4096))
    widths = merkle.tail_widths(4096)
    st8 = channel_ops.ChannelStep(channel_ops.new_state(dev, 8), None, torch.zeros((8, 4), dtype=torch.int32,
                                                                                   device=dev))
    one = [channel_ops.ChannelStep(channel_ops.new_state(dev), None, torch.zeros(4, dtype=torch.int32, device=dev))
           for _ in range(8)]
    ms = device_ms(lambda: merkle_ops.merkle_collapse(level8, widths, step=st8))
    singles = device_ms(lambda: [merkle_ops.merkle_collapse(level8[b], widths, step=one[b]) for b in range(8)])
    call = cuda_ms(lambda: merkle_ops.merkle_collapse(level8, widths, step=st8))
    l64 = widen(level8)
    plain_ms = cuda_ms(lambda: merkle_ops.merkle_collapse_plain(l64, widths, st8), reps=3)
    b_ms, b_by = profiling.merkle_collapse_bound(4096, widths, blobs=8, step=True)
    entry["merkle_collapse+step[batch]"] = dict(ms=ms, call_ms=call, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    say(f"[14] merkle_collapse (8, 8, 4096) -> {widths} with 8 steps, one launch: device {ms:.4f} ms, call "
        f"{call:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}); 8 single launches device "
        f"{singles:.4f} ms")

    # transcript's close forms (and a small tree's step) over B channels
    for B in (1, 3, 8):
        forms = (("seed + root + alpha", dict(mix_u64=rand_u32((B, 2)), mix_digest=rand_u32((B, 8)), draw_felt=True)),
                 ("last-layer felts, k = 1", dict(mix_felts=rand_u32((B, 1, 4), P))),
                 ("last-layer felts, k = 4", dict(mix_felts=rand_u32((B, 4, 4), P))),
                 ("nonce + 64 queries", dict(mix_u64=rand_u32((B, 2)), queries=(64, n))))
        st = rand_u32((B, 9))
        st_plain = st.clone()
        for what, step in forms:
            got = channel_ops.transcript(st, **step)
            want = channel_ops.transcript_plain(st_plain, **step)
            check(torch.equal(st, st_plain) and all((g is None) == (w is None) and (g is None or torch.equal(g, w))
                                                    for g, w in zip(got, want)),
                  f"transcript B = {B} {what} differs from plain")
            errs["transcript[batch]"] = max([errs["transcript[batch]"], max_abs_err(st, st_plain)]
                                            + [max_abs_err(g, w) for g, w in zip(got, want) if g is not None])
    st8 = rand_u32((8, 9))
    nonce8 = rand_u32((8, 2))
    close = dict(mix_u64=nonce8, queries=(64, n))
    ms = device_ms(lambda: channel_ops.transcript(st8, **close))
    singles = device_ms(lambda: [channel_ops.transcript(st8[b], mix_u64=nonce8[b], queries=(64, n))
                                 for b in range(8)])
    call = cuda_ms(lambda: channel_ops.transcript(st8, **close))
    plain_ms = cuda_ms(lambda: channel_ops.transcript_plain(st8, **close), reps=3)
    b_ms, b_by = profiling.transcript_bound(8, 256, 9, blobs=8)
    entry["transcript[batch]"] = dict(ms=ms, call_ms=call, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    say(f"[14] transcript B = 1, 3, 8 (seed + root + alpha, last-layer felts k = 1 and 4, nonce + 64 queries): "
        f"bit-equal to plain; 8 channels' nonce + 64 queries in one launch: device {ms:.4f} ms, call {call:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}); 8 single launches device {singles:.4f} ms")

    # grind: each blob's nonce is its own minimum (the plain sweep's) and its
    # one-blob launch's; B = 64's states from their own generator, so that
    # B = 1, 3, 8 keep the states of the phase before it had B = 64
    many_rng = np.random.default_rng(SEED + 64)
    for pow_bits in (8, 20):
        for B in (1, 3, 8, 64):
            st = channel_ops.new_state(dev, B)
            words = (rand_u32((B, 2)) if B < 64 else
                     from_numpy_u32(many_rng.integers(0, 1 << 32, (B, 2), dtype=np.uint64).astype(np.uint32), dev))
            channel_ops.transcript(st, mix_u64=words)
            got = channel_ops.grind(st, pow_bits)
            want = channel_ops.grind_plain(st, pow_bits)
            nonces = to_numpy_u32(got).astype(np.uint64)
            nonces = (nonces[:, 0] | nonces[:, 1] << np.uint64(32)).tolist()
            check(torch.equal(got, want), f"grind B = {B}, pow_bits {pow_bits}: nonces {nonces} != the plain "
                  "sweep's minima")
            check(all(torch.equal(got[b], channel_ops.grind(st[b], pow_bits)) for b in range(B)),
                  f"grind B = {B}, pow_bits {pow_bits}: a blob's nonce differs from its one-blob launch's")
            errs["grind[batch]"] = max(errs["grind[batch]"], max_abs_err(got, want))
            ms = device_ms(lambda: channel_ops.grind(st, pow_bits), reps=5)  # noqa: B023
            b_ms, b_by = profiling.grind_bound(nonces)
            line = (f"[14] grind B = {B}, pow_bits {pow_bits}: nonces == the plain sweep's == the one-blob "
                    f"launches' (sum {sum(nonces)}, largest {max(nonces)}); one launch: device {ms:.4f} ms, bound "
                    f"{b_ms:.6f} ms ({b_by}; {sum(nonces) + B} compressions), share {b_ms / ms:.3f}; {grind_form(B)}")
            if pow_bits == 20 and B in (8, 64):
                singles = device_ms(lambda: [channel_ops.grind(st[b], pow_bits) for b in range(B)],  # noqa: B023
                                    reps=5 if B == 8 else 2)
                line += f"; {B} one-channel launches: device {singles:.4f} ms (share {b_ms / singles:.3f})"
            if pow_bits == 20 and B == 8:
                call = cuda_ms(lambda: channel_ops.grind(st, pow_bits))  # noqa: B023
                plain_ms = cuda_ms(lambda: channel_ops.grind_plain(st, pow_bits), reps=3)  # noqa: B023
                entry["grind[batch]"] = dict(ms=ms, call_ms=call, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
                line += (f"; call {call:.4f} ms, plain {plain_ms:.4f} ms; one launch after another: "
                         f"{clocks_beside(lambda: channel_ops.grind(st, pow_bits))}")  # noqa: B023
            say(line)
    say("[14] grind B = 1, 3, 8, 64 at pow_bits 8 and 20: each blob's nonce == the plain sweep's minimum == its "
        "one-blob launch's")

    # merkle_open_queries over a batch's real layers and trees
    for B in (1, 3, 8):
        _, words = upload_words(datas[:B], log_total, dev)
        cs = fri.commit_phase(words, log_total, seeds[:B], cfg)
        cols = [torch.stack([c.layers[t] for c in cs]) for t in range(layers)]
        trees = [[c.trees[t] for c in cs] for t in range(layers)]
        packed = cs[0].batch[0].packed
        o = cs[0].layout.head["qpos"][0]
        raw = packed[:, o : o + 64].contiguous()
        got = merkle_ops.merkle_open_queries(cols, trees, raw)
        want = narrow(merkle_ops.merkle_open_queries_plain(cols, trees, raw))
        ordered = merkle_ops.order_openings(got, raw, cs[0].layout.sizes)
        check(torch.equal(got, want) and torch.equal(ordered, packed[:, cs[0].layout.head_words :])
              and torch.equal(ordered, narrow(merkle_ops.order_openings_plain(got, raw, cs[0].layout.sizes))),
              f"merkle_open_queries B = {B} differs from a loop of the plain version, or its order_openings from "
              "plain or from the batch's packed decommitment")
        errs["merkle_open_queries[batch]"] = max(errs["merkle_open_queries[batch]"], max_abs_err(got, want))
        for b, c in enumerate(cs):  # each row == the packed vector of its blob's batch of one
            single = fri.commit_phase(words[b : b + 1], log_total, seeds[b : b + 1], cfg)[0]
            check(torch.equal(single.packed, packed[b]), f"commit_phase B = {B}: row {b} != a batch of one's")
        if B == 8:
            q_args = (cols, trees, raw)
            ms = device_ms(lambda: merkle_ops.merkle_open_queries(*q_args))  # noqa: B023
            rows = [([x[b] for x in cols], [t[b] for t in trees], raw[b]) for b in range(B)]
            singles = device_ms(lambda: [merkle_ops.merkle_open_queries(*r) for r in rows])  # noqa: B023
            call = cuda_ms(lambda: merkle_ops.merkle_open_queries(*q_args))  # noqa: B023
            plain_ms = cuda_ms(lambda: merkle_ops.merkle_open_queries_plain(*q_args), reps=3)  # noqa: B023
            compressions, read_bytes = merkle_ops.open_queries_work(trees, to_numpy_u32(raw))
            b_ms, b_by = profiling.merkle_open_queries_bound(B * 64, got.numel(), read_bytes, compressions)
            entry["merkle_open_queries[batch]"] = dict(ms=ms, call_ms=call, plain_ms=plain_ms, bound_ms=b_ms,
                                                       bound_by=b_by)
            say(f"[14] merkle_open_queries over 8 proofs' {layers} layers, one launch: device {ms:.4f} ms, call "
                f"{call:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}; {compressions} "
                f"compressions, {read_bytes} distinct bytes read); 8 single launches device {singles:.4f} ms")
            del rows, q_args
        del cs, cols, trees, packed, raw, got, want, words, ordered
        torch.cuda.empty_cache()
    say("[14] merkle_open_queries B = 1, 3, 8 over commit_phase's layers and trees: bit-equal to a loop "
        "of the plain version; order_openings of those gathers == plain == the batch's packed decommitment; "
        "every packed row == a batch of one's")
    lap_ms = (time.perf_counter() - t_phase)
    say(f"[14] kernels checked in {lap_ms:.1f} s")

    # prove_many_sharded over one card's (8, 1) and (2, 4) meshes: two batched
    # replays of 4 blobs, against phase 11's proofs
    if many_out is None:
        many_out = [(c, p.to_bytes()) for c, p in (api.commit_and_prove(d, s, cfg, device=dev)
                                                    for d, s in zip(datas, seeds))]
    replays, fetches = [0], []
    run, dispatch = fri._CommitGraph.run, fri.dispatch_blobs

    def counting_run(self, seed):
        replays[0] += 1
        return run(self, seed)

    def recording_dispatch(*args, **kwargs):
        committed = dispatch(*args, **kwargs)
        fetches.append((committed[0].batch[0], committed[0].batch[0]._ahead is not None))  # its copy ahead
        return committed

    fri._CommitGraph.run, fri.dispatch_blobs = counting_run, recording_dispatch
    try:
        captures0 = fri.commit_graphs()[0]
        main_used = None
        for shape in ((8, 1), (2, 4)):
            mesh = sharding.make_mesh(*shape, devices=[dev] * 8)
            sharding.prove_many_sharded(datas, seeds, cfg, mesh)  # the key's warm-up and captures (once)
            replays[0], copies0 = 0, packing.copy_counts()
            fetches.clear()
            fri.reset_pipeline_counts()
            out, used = counted(lambda: sharding.prove_many_sharded(datas, seeds, cfg, mesh))  # noqa: B023
            pipeline = fri.pipeline_counts()
            copies = {k: v - copies0[k] for k, v in packing.copy_counts().items()}
            check([(c, p.to_bytes()) for c, p in out] == many_out,
                  f"prove_many_sharded 8 x 2^20 felts over one card's {shape} mesh != phase 11's proofs")
            check(all(api.verify(p, s) for (_, p), s in zip(out, seeds)) and not api.verify(tampered(out[0][1]), 1),
                  f"prove_many_sharded over {shape}: a proof does not verify, or a tampered copy does")
            check(replays[0] == 2, f"prove_many_sharded over {shape}: {replays[0]} graph replays, want 2")
            check(pipeline == {"calls": 1, "dispatches": 2, "overlapped": 4},
                  f"prove_many_sharded over {shape}: pipeline_counts {pipeline}, want 1 call, 2 dispatches, "
                  f"4 overlapped finishes")
            check([(f.host.shape[0], ahead) for f, ahead in fetches] == [(4, True), (4, True)],
                  f"prove_many_sharded over {shape}: its dispatches' fetches "
                  f"{[(None if f.host is None else f.host.shape, ahead) for f, ahead in fetches]}, want two of "
                  f"4 rows, each with its copy enqueued ahead")
            say(f"[14] prove_many_sharded over {shape}: pipeline_counts {pipeline}, copy_counts {copies}")
            main_used = main_used or used
        captures = fri.commit_graphs()[0] - captures0
        instances = {k: v for k, v in fri.commit_graphs()[1].items() if k[-1] == 4}
        check(captures == 2 and list(instances.values()) == [2], f"prove_many_sharded over two meshes of one "
              f"card: {captures} captures, keys of 4 blobs {instances}; want 2 (one key, an instance a dispatch)")
        # the first dispatch's rows, read from its copy ahead, == a lone batch's of the same blobs
        firsts = [fetches[0][0].host[b].copy() for b in range(4)]
        lone = fri.dispatch_blobs(datas[:4], log_total, seeds[:4], cfg, dev)
        check(all(np.array_equal(lone[b].batch[0].row(b), firsts[b]) for b in range(4)),
              "the first dispatch's packed rows differ from a lone batch's of its 4 blobs")
        for b, c in enumerate(lone):
            check(fri.finish_proof(c, log_total, cfg)[1].to_bytes() == many_out[b][1], f"lone batch row {b} differs")
        del lone
        # 8 single replays (prove_many's instances captured in phase 11 or here)
        api.prove_many(datas, seeds, cfg, device=dev)
        _, single_used = counted(lambda: api.prove_many(datas, seeds, cfg, device=dev))
    finally:
        fri._CommitGraph.run, fri.dispatch_blobs = run, dispatch
    want_used = {"fri_fold": 2 * layers, "transcript": 4, STEPS: 2 * layers, "grind": 2, "merkle_open_queries": 2,
                 "order_openings": 2, "ingest": 2}
    check(all(main_used.get(k) == v for k, v in want_used.items())
          and all(4 * main_used.get(k, 0) == v for k, v in single_used.items()),
          f"prove_many_sharded launches per call {main_used}: want {want_used} and 1/4 of 8 single replays' "
          f"{single_used}")
    say(f"[14] prove_many_sharded 8 x 2^20 felts / 64 queries over one card's (8, 1) and (2, 4) meshes: every "
        f"commitment and wire byte == phase 11's, each verifies, a tampered copy does not; 2 graph replays of 4 "
        f"blobs a call, {captures} captures for both meshes (one key: log_size 20, batch 4; an instance a "
        f"dispatch in flight); the first dispatch's rows == a lone batch's; launches per call {main_used} (each "
        f"batched kernel once a layer a dispatch); 8 single replays (prove_many) {single_used}")

    # a call's two dispatches and their copies ahead under sync debug mode
    # "error", then their 8 finishes: no synchronizing call (each dispatch's
    # first finish waits on its copy's event) and no launch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        committed = (fri.dispatch_blobs(datas[:4], log_total, seeds[:4], cfg, dev)
                     + fri.dispatch_blobs(datas[4:], log_total, seeds[4:], cfg, dev))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs, launched = 0, {}
    for b, c in enumerate(committed):
        s, wire, opened = finish_counted(fri, c, log_total, cfg)
        syncs += s
        launched.update(opened)
        check(wire == many_out[b][1], f"dispatch_blobs row {b}: bytes != phase 11's")
    check(syncs == 0 and not launched, f"the 8 finishes of two dispatches: {syncs} synchronizing operations, "
          f"launches {launched}; want none (an event wait a dispatch) and none")
    del committed
    say("[14] two dispatch_blobs calls of 4 blobs (upload, seeds, replay, the rows' copy ahead and its event) "
        "under sync debug mode 'error': no synchronization; their 8 finish_proof calls: no synchronizing call "
        "(an event wait a dispatch), no launch")

    # device ms: one batched replay against 8 single replays (median of 5 in
    # turns), the words already on the card
    _, words8 = upload_words(datas, log_total, dev)
    inst = fri._fri_commit_fn(log_total, cfg, True, dev, blobs=8)

    def batched():
        inst.words.copy_(words8)
        return inst.run(seeds)

    def singles():
        return [fri.dispatch_words(words8[b : b + 1], log_total, seeds[b : b + 1], cfg)[0] for b in range(8)]

    dev_ms = {"batched": [], "8 single": []}
    for kind in ("batched", "8 single", "8 single", "batched") * 2 + ("batched", "8 single"):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        cs = batched() if kind == "batched" else singles()
        end.record()
        end.synchronize()
        dev_ms[kind].append(start.elapsed_time(end))
        for b, c in enumerate(cs):
            check(fri.finish_proof(c, log_total, cfg)[1].to_bytes() == many_out[b][1], f"{kind} row {b} differs")
        del cs
    med = {k: statistics.median(v) for k, v in dev_ms.items()}
    say(f"[14] device ms of the commit phases of 8 x 2^20 felts / 64 q (CUDA events, words on the card; median of "
        f"5 in turns): one batched replay {med['batched']:.3f} ({[round(x, 3) for x in dev_ms['batched']]}), 8 "
        f"single replays {med['8 single']:.3f} ({[round(x, 3) for x in dev_ms['8 single']]})")
    # where one batched replay's device time goes: its records in a trace,
    # which holds each launch its capture recorded
    def settle(cs):
        for b, c in enumerate(cs):
            check(fri.finish_proof(c, log_total, cfg)[1].to_bytes() == many_out[b][1],
                  f"traced batch row {b} differs")

    prof, cs = traced_run(batched, settle)
    traced = traced_launches(prof)
    settle(cs)
    del cs
    check(traced == inst.launches, f"the trace of one batched replay holds {traced}, recorded at its capture "
          f"{inst.launches}")
    say(f"[14] the trace of one batched replay holds every recorded launch: {traced}")
    port, plain, copies, windows = replay_device_ms(prof)
    say(f"[14] one batched replay's device records (torch.profiler, [records, summed ms, summed ms of the gaps "
        f"after them]): the port's kernels {({k: [n, round(ms, 4), round(gap, 4)] for k, (n, ms, gap) in port.items()})}"
        f"; plain PyTorch {sum(v[0] for v in plain.values())} kernels, {sum(v[1] for v in plain.values()):.4f} ms "
        f"({({k: [n, round(ms, 4), round(gap, 4)] for k, (n, ms, gap) in plain.items()})}); copies and fills "
        f"{copies[0]}, {copies[1]:.4f} ms; the close's windows "
        f"{({k: [n, round(ms, 4), round(gap, 4)] for k, (n, ms, gap) in windows.items()})}")

    # whole calls: prove_many_sharded (one card's (8, 1) mesh) against
    # prove_many, median of 5 in turns; idle share and peak memory of one
    # profiled call each
    mesh = sharding.make_mesh(8, 1, devices=[dev] * 8)
    calls = {"prove_many": lambda: api.prove_many(datas, seeds, cfg, device=dev),
             "prove_many_sharded": lambda: sharding.prove_many_sharded(datas, seeds, cfg, mesh)}
    walls, selects = {k: [] for k in calls}, {k: [0, 0.0] for k in calls}
    fri.reset_select_counts()
    for kind in ("prove_many", "prove_many_sharded", "prove_many_sharded", "prove_many") * 2 + (
            "prove_many", "prove_many_sharded"):
        torch.cuda.synchronize()
        profiling.reset_span_totals()
        t0 = time.perf_counter()
        calls[kind]()
        walls[kind].append((time.perf_counter() - t0) * 1e3)
        select = profiling.span_totals()["assemble/select"]
        selects[kind] = [selects[kind][0] + select.count, selects[kind][1] + select.seconds]
    check(fri.select_counts() == {"cut": 10 * len(datas), "planned": 0},
          f"whole calls: select_counts {fri.select_counts()}; want every one of {10 * len(datas)} proofs cut")
    say(f"[14] assemble/select of the whole calls (profiling.span_totals): "
        f"{({k: round(sec / n * 1e3, 4) for k, (n, sec) in selects.items()})} ms a blob; select_counts "
        f"{fri.select_counts()}")
    notes = {}
    for kind, fn in calls.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy_us, records = device_busy_us(prof)
        check(records > 0 and busy_us < wall_us, f"profile of {kind}: {records} records, busy {busy_us:.0f} us of "
              f"{wall_us:.0f} us")
        notes[kind] = (f"median {statistics.median(walls[kind]):.3f} ms ({[round(x, 3) for x in walls[kind]]}); "
                       f"profiled call: device busy {busy_us / 1e3:.3f} ms in {records} records, idle share "
                       f"{1 - busy_us / wall_us:.3f}; peak allocated {torch.cuda.max_memory_allocated(dev)} B, "
                       f"reserved {torch.cuda.max_memory_reserved(dev)} B")
    for kind, note in notes.items():
        say(f"[14] whole call {kind}, 8 x 2^20 felts / 64 q (in turns): {note}")
    for form, e in entry.items():
        kernels[form] = dict(source=BATCH_FORMS[form][1], replaces=BATCH_FORMS[form][2],
                             max_abs_err=errs[form], **e)
        say(f"[14] {form}: device {e['ms']:.4f} ms, bound {e['bound_ms']:.6g} ms ({e['bound_by']}; share "
            f"{e['bound_ms'] / e['ms']:.3f}); launches on the main path (the counted prove_many_sharded, two "
            f"dispatches) "
            f"{main_used.get(BATCH_FORMS[form][0], 0)}")
    block_select(dev)
    say(f"[14] phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return main_used


def block_select(dev) -> None:
    """An Ethereum block at `frida-4844-r2`'s shape (9 blobs of 131,072 bytes,
    log_blowup 1, 70 queries; pow_bits 20, so that the reference grinds in
    seconds) through `prove_many_sharded` on a one-card mesh, 5 times:
    roots and wire bytes == `portbench/reference/fri.prove`'s, every proof
    cut from its ordered row, and the host's assemble/select ms a blob."""
    import torch

    from frieda_tpu_torch.config import PcsConfig
    from frieda_tpu_torch.core import fri
    from frieda_tpu_torch.parallel import sharding
    from frieda_tpu_torch.parallel.mesh import Mesh
    from frieda_tpu_torch.utils import profiling
    from portbench.reference import fri as ref

    cfg = PcsConfig.from_dict({"pow_bits": 20, "fri_config": {"log_blowup_factor": 1, "log_last_layer_degree_bound": 0,
                                                              "n_queries": 70}})
    datas = [synthetic_data(131072, 300 + k) for k in range(9)]
    seeds = [(0x9E3779B97F4A7C15 * (k + 1)) % (1 << 64) for k in range(9)]
    mesh = Mesh(1, 1, [dev])
    out = sharding.prove_many_sharded(datas, seeds, cfg, mesh)  # warm-up: tables, the two dispatches' captures
    fri.reset_select_counts()
    profiling.reset_span_totals()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = sharding.prove_many_sharded(datas, seeds, cfg, mesh)
        walls.append((time.perf_counter() - t0) * 1e3)
        check([(c, p.to_bytes()) for c, p in again] == [(c, p.to_bytes()) for c, p in out],
              "a 9-blob block's proofs changed between calls")
    select, finish = profiling.span_totals()["assemble/select"], profiling.span_totals()["batch/finish"]
    check(fri.select_counts() == {"cut": 45, "planned": 0}, f"9-blob block: select_counts {fri.select_counts()}")
    t0 = time.perf_counter()
    want = ref.prove(datas, seeds, ref.Protocol(1, 0, 70, 20), dev)
    check([(c, p.to_bytes()) for c, p in out] == want, "a 9-blob block at frida-4844-r2's shape: roots or wire bytes "
          "!= portbench/reference's")
    say(f"[14] a 9-blob block at frida-4844-r2's shape, pow_bits 20, 5 calls: roots and wire bytes == "
        f"portbench/reference's (reference {time.perf_counter() - t0:.2f} s); select_counts {fri.select_counts()}; "
        f"assemble/select {select.seconds / select.count * 1e3:.4f} ms a blob, batch/finish "
        f"{finish.seconds / 5 * 1e3:.3f} ms a block (profiling.span_totals); calls median "
        f"{statistics.median(walls):.3f} ms of {[round(w, 3) for w in walls]}")


def finish_counted(fri, committed, log_total: int, cfg) -> tuple:
    """(synchronizing operations, wire bytes, {kernel: launches}) of one
    `fri.finish_proof` after a commit phase enqueued on the card: the
    synchronizations counted under sync debug mode "warn", the launches
    with every count set to 0 just before it."""
    import torch

    from frieda_tpu_torch import ops

    before = ops.launch_counts()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            wire = fri.finish_proof(committed, log_total, cfg)[1].to_bytes()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    return syncs, wire, {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]}


# A kernel's name in a trace -> the wrapper that counts its launches.
KERNEL_OF_WRAPPER = re.compile(
    r"\b(ingest|fft_pass|fft_exchange|merkle_level|merkle_collapse|merkle_open_queries|merkle_open|fri_fold|"
    r"transcript|grind|order_openings)"
    r"(?:_element|_tile)?_kernel\b")


def traced_launches(prof) -> dict:
    """{wrapper: kernels of it} among the counted records of a finished
    `torch.profiler.profile` (`counted_events`): the launches the card ran,
    which for a CUDA graph's replay are its kernel nodes (the wrappers'
    counts there are the capture's record)."""
    out: dict = {}
    for e in counted_events(prof):
        m = KERNEL_OF_WRAPPER.search(e.name())
        if m:
            out[m.group(1)] = out.get(m.group(1), 0) + 1
    return out


LEAD_IN = "spin_kernel"  # the kernel of torch.cuda._sleep


def lead_in() -> None:
    """A short device wait that marks where the counted work of a trace
    begins (`LEAD_IN`, `counted_events`)."""
    import torch

    torch.cuda._sleep(200_000)
    torch.cuda.synchronize()


def counted_events(prof) -> list:
    """The device records of a finished `torch.profiler.profile` after its
    last `lead_in`, by start time; all of them if it holds none."""
    import torch

    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA), key=lambda e: e.start_ns())
    last = max((i for i, e in enumerate(events) if LEAD_IN in e.name()), default=-1)
    return events[last + 1:]


def traced_run(run, settle) -> tuple:
    """(a finished `torch.profiler.profile`, the result of the `run()` it
    counts). A trace loses a varying number of its first device records,
    whatever they are: the lead-in alone, or with the first 4 or 14 kernels
    of the replay behind it, in a few of a hundred traces on an H100
    (tools/torch_trace_loss.py). So the trace holds a warm `run()` first,
    `settle` of its result (which frees what the counted run reuses), then
    `lead_in` and the counted run: the loss falls on the warm run, and the
    records after the lead-in are the counted run's."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        settle(run())
        lead_in()
        out = run()
        torch.cuda.synchronize()
    return prof, out


def replay_device_ms(prof) -> tuple:
    """({port kernel: [records, summed device ms, summed ms of the idle gaps
    after them]}, {PyTorch kernel, short name: [the same]}, [copies and
    fills: the same], {window: [records, summed ms, device ms from the
    record before it to the record after it]}) of the counted device records
    (`counted_events`) of one commit phase's replay in a finished
    `torch.profiler.profile`. PyTorch's own kernels there: the trees'
    `torch.cat` (`core/merkle._flatten`), the channel state's zero fill and
    the close. The windows are the close's two stretches of plain PyTorch:
    "last layer" from the last `fri_fold` to the next `transcript`
    (`fri._device_ifft_line`, the coefficients' cast, the degree check),
    "head" from the last `transcript` to `merkle_open_queries` (the packed
    head's `torch.cat`)."""
    events = counted_events(prof)
    kinds = []
    port, plain, copies = {}, {}, [0, 0.0, 0.0]
    for i, e in enumerate(events):
        m = KERNEL_OF_WRAPPER.search(e.name())
        kinds.append(m.group(1) if m else None)
        if m:
            into = port.setdefault(m.group(1), [0, 0.0, 0.0])
        elif e.name().startswith(("Memcpy", "Memset")):
            into = copies
        else:
            name = re.sub(r"\((?!anonymous).*$", "", re.sub(r"^void ", "", e.name()).split("<")[0])
            into = plain.setdefault(name.split("::")[-1], [0, 0.0, 0.0])
        into[0] += 1
        into[1] += e.duration_ns() / 1e6
        if i + 1 < len(events):
            into[2] += (events[i + 1].start_ns() - e.start_ns() - e.duration_ns()) / 1e6
    windows = {}
    for what, first, last in (("last layer", "fri_fold", "transcript"), ("head", "transcript", "merkle_open_queries")):
        lo = max((i for i, k in enumerate(kinds) if k == first), default=None)
        hi = next((i for i in range(lo + 1, len(kinds)) if kinds[i] == last), None) if lo is not None else None
        if hi is not None:
            inside = events[lo + 1 : hi]
            gap = (events[hi].start_ns() - events[lo].start_ns() - events[lo].duration_ns()) / 1e6
            windows[what] = [len(inside), sum(e.duration_ns() for e in inside) / 1e6, gap]
    return port, plain, copies, windows


@contextlib.contextmanager
def no_spans(module):
    """The module's `span` replaced by a no-op for the block: its paths
    without their annotations, for their host cost."""
    span, module.span = module.span, lambda name, out=None: contextlib.nullcontext()
    try:
        yield
    finally:
        module.span = span


def span_trace(dev, data: bytes, words, log_total: int, cfg) -> None:
    """One `api.commit`, `api.commit_and_prove`, staged prove and `api.verify`
    of the blob under torch.profiler on the card: every name of `SPANS` is a
    range in the trace (each span also pushed and popped an NVTX range), and
    the card ran kernels in it. Beside them, `packing.copy_counts()` over
    the calls: the two blob copies (the staged prove takes words) split
    over threads exactly when the blob holds `SPLIT_BYTES` or more."""
    import torch

    from frieda_tpu_torch import api
    from frieda_tpu_torch.utils import packing

    torch.cuda.synchronize()
    before = packing.copy_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        api.commit(data, LOG_BLOWUP, device=dev)
        api.commit_and_prove(data, 7, cfg, device=dev)
        _, proof = api.commit_and_prove_staged(words, log_total, 7, cfg)
        check(api.verify(proof, 7), "the traced staged proof does not verify")
        torch.cuda.synchronize()
    copies = {k: v - before[k] for k, v in packing.copy_counts().items()}
    names = [e.name for e in prof.events()]
    missing = [n for n in SPANS if n not in names]
    busy_us, records = device_busy_us(prof)
    check(not missing and records > 0, f"torch.profiler trace on the card: spans {missing} missing, "
          f"{records} device records")
    split = len(data) >= packing.SPLIT_BYTES and len(os.sched_getaffinity(0)) > 1
    check(copies["whole"] + copies["split"] == 2 and copies["split"] == 2 * split,
          f"copy_counts over api.commit and api.commit_and_prove of {len(data)} bytes: {copies}")
    say(f"[9] torch.profiler trace of api.commit, api.commit_and_prove, the staged prove and api.verify "
        f"(2^20 felts, 64 queries) on the card: every span name present, each "
        f"{[names.count(n) for n in SPANS]} times ({', '.join(SPANS)}: the host's ranges and, where a range "
        f"enqueued device work, its annotation on the device's timeline); NVTX ranges pushed and popped "
        f"without error; {records} device records, busy {busy_us:.0f} us; copy_counts {copies} (the blob "
        f"{len(data)} bytes, SPLIT_BYTES {packing.SPLIT_BYTES})")


def wire_note(proof) -> str:
    wire = proof.to_bytes()
    return f"{len(wire)} bytes, {1 + len(proof.proof.inner_layers)} layers"


if __name__ == "__main__":
    sys.exit(main())
