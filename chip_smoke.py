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
  3. each of the nine kernels against its plain PyTorch version on the card,
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
     the 2^24-felt proof's 22 trees give it (with their sum); `merkle_open`
     at the openings of a 2^20-felt / 64-query and a 2^24-felt / 20-query
     proof (their real layers, trees and queries, from `fri.commit_phase`
     and `fri.plan_openings`), with the chain floor of one launch and three
     dependent compressions; `fri_fold`, circle and line, at (4, 2^26), at
     the proof's first line fold (4, 2^25) and at (4, 2^7), under one block,
     and timed at each of the 2^24-felt proof's 22 folds (with their sum);
     `transcript`, every step (seed, root and alpha, last-layer felts, nonce
     and queries) on 64 seeded states against the host channel and the plain
     version, each step form timed beside the launch floor and its chain of
     compressions; `grind` at pow_bits 8, 16 and 20 against the plain sweep
     (and at 8 and 16 a host scan, `grind_host`'s loop): the minimum nonce;
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
     log_blowup 4): at 2^24 the kernel path's proof bytes equal the plain
     path's (the same prover on the plain versions); the median prove time
     of three runs with the stage clock, each run's stage split (the decommitment as
     plan, open and assemble), kernel launches per proof (`merkle_open` once,
     no `merkle_level` in the decommitment; `fri_fold` once a layer,
     `transcript` once a layer and three more, `grind` once) and peak device
     memory; a warm `fri.commit_phase` run under
     `torch.cuda.set_sync_debug_mode("error")` with FRIEDA_SPANS=1 (it
     synchronizes nowhere, and its span prints), its
     host enqueue ms beside its device ms (CUDA events), and exactly one
     synchronizing fetch (`Committed.fetch`, counted in "warn" mode) before
     the decommitment, whose proof bytes equal the warm proof's; the
     bytes one finished commit phase (`fri.Committed`) keeps on the card
     (`torch.cuda.memory_allocated` around `fri.commit_phase`) and the
     prove_many window that gives; `api.verify` accepts the proof and
     rejects a tampered copy, with verify's host ms (median of 5); ten whole
     proves without the stage clock with the spans (`utils/profiling.span`)
     and ten with a no-op in their place, in turns, the median of the first
     beside the spread of the second, and an empty span's host cost; at
     2^20 felts a torch.profiler trace of `api.commit`,
     `api.commit_and_prove`, the staged prove and `api.verify` on the card
     holds every span name (`SPANS`);
 10. every kernel's launch count over each path: the commit phases (4-5,
     checked there), `commit_many` (6), `commit_with_tree` (7, the one-level
     `merkle_level` forms) and the prove phases (8-9): each must be > 0,
     except `merkle_open`, `fri_fold`, `transcript` and `grind` outside a
     proof and `merkle_collapse` in `commit_with_tree`;
 11. `api.prove_many` on 8 blobs of 2^20 felts (64 queries, seeds 1-8): every
     kernel launched (> 0) by its first run, whose peak device memory is
     printed; then a loop of `api.commit_and_prove` and `prove_many` in
     turns (loop, prove_many, prove_many, loop), every commitment and wire
     byte equal to the first run's, with each wall and proofs/s; the
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
     == phase 9's proof, verify True, tampered copy False), its commit phase
     under sync debug mode "error"; `prove_many_sharded` on phase 11's 8 x
     2^20 felts / 64 queries over a (2, 4) mesh (== phase 11's proofs) and
     `commit_roots_batch` on 16 x 2^20 felts over (2, 4) (== `api.commit_many`).
     Host (enqueue) and device ms of each beside the single-device path's, in
     turns in this phase, and the launches per kernel: every kernel of the
     sharded path (all nine) launched in this phase.

Any mismatch, build failure or launch error exits nonzero. The last line is
`{"ok": true, "device": {...}}`; the line before it lists the kernels as JSON.
Without CUDA the script exits nonzero before printing any result.

    python3 chip_smoke.py --prove-fit 26

runs only phases 1-2 and one staged prove of 2^26 felts (20 queries,
pow_bits 20, log_blowup 4) and prints its time, stage split and peak device
memory: whether the largest blob the JAX bench names fits one card; then
`api.verify` accepts the proof (host ms) and rejects a tampered copy.

    python3 chip_smoke.py --commit-split

runs only phases 1-2 and splits the commit at 2^22 and 2^24 felts into host
padding, upload, ingest, LDE, Merkle, device total and root fetch (CUDA
events or synchronized host clock, median of 9), with the device's idle
share over 5 back-to-back device-resident commits (torch.profiler).
"""

from __future__ import annotations

import contextlib
import ctypes
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
from torch_harness import (card, cuda_ms, device_busy_us, device_ms, host_ms,  # noqa: E402
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
                  "transcript": 5.8e-8, "grind": 0.0427}
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


def plain_route():
    """The prover's device steps as the kernels' plain PyTorch versions (int64
    inside, int32 at the edges): the same pipeline, no kernel launched."""
    from frieda_tpu_torch.core import fft, fri
    from frieda_tpu_torch.ops import channel as channel_ops
    from frieda_tpu_torch.ops import fri as fri_ops
    from frieda_tpu_torch.ops import ingest as ingest_ops
    from frieda_tpu_torch.ops import merkle as merkle_ops
    from frieda_tpu_torch.utils.convert import narrow, widen

    return fri.Route(
        fold=lambda v, alpha, inv: narrow(fri_ops.fri_fold_plain(widen(v), widen(alpha), widen(inv))),
        transcript=channel_ops.transcript_plain,
        grind=channel_ops.grind_plain,
        ingest=lambda w, log_size: narrow(ingest_ops.ingest_plain(widen(w), log_size)),
        evaluate=lambda c, tw: narrow(fft.evaluate(widen(c), tw)),
        level=lambda x, leaf, fused: narrow(merkle_ops.merkle_level_plain(widen(x), leaf, fused)),
        collapse=lambda lvl, widths: [
            narrow(o) for o in merkle_ops.merkle_collapse_plain(widen(lvl), widths)],
        open=lambda layers, trees, values, nodes: narrow(
            merkle_ops.merkle_open_plain(layers, trees, values, nodes)),
    )


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
    t0 = time.perf_counter()
    _, proof = api.commit_and_prove_staged(words, log_total, 7, cfg)  # tables built on first use
    torch.cuda.synchronize()
    say(f"[fit] first prove of 2^{log_felts} felts (host tables included): "
        f"{time.perf_counter() - t0:.3f} s; proof {wire_note(proof)}")
    torch.cuda.reset_peak_memory_stats(dev)
    stats = {}
    t0 = time.perf_counter()
    fri.prove_words(words, log_total, 7, cfg, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    free, total = torch.cuda.mem_get_info(dev)
    split = " ".join(f"{k} {v * 1e3:.3f}" for k, v in stats["stage_s"].items())
    say(f"[fit] staged prove 2^{log_felts} felts, 20 queries, pow 20 (domain 2^{log_total - 2 + LOG_BLOWUP}): "
        f"{wall * 1e3:.3f} ms (synchronized stages, ms: {split}); peak device memory {peak} bytes = "
        f"{peak / 2**30:.3f} GiB of {total / 2**30:.3f} GiB ({peak / (1 << (log_total - 2 + LOG_BLOWUP)):.1f} "
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

    fit = sys.argv[sys.argv.index("--prove-fit") + 1] if "--prove-fit" in sys.argv else None
    split = "--commit-split" in sys.argv

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
            say(f"[2]   {kernel}: {line.split(':', 1)[1].strip()}; {spills}")
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
        committed = fri.commit_phase(from_numpy_u32(pad_to_words(data, log_total), dev), log_total, 7, cfg)
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
        del committed, args, got, want, table
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
    say(f"[3] transcript over the 2^24-felt / 20-query proof's 25 launches: device {per_proof:.4f} ms; "
        f"launch floor 25 x {gap_ms:.4f} = {25 * gap_ms:.4f} ms")

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
        blocks = ctypes.c_int()
        _build.library().frieda_grind_blocks(ctypes.byref(blocks))
        say(f"[3] grind pow_bits={pow_bits}: nonce {nonce} == plain sweep"
            f"{' == host scan' if pow_bits <= 16 else ''}; device {ms:.4f} ms, call {call:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}: {nonce + 1} compressions; share {b_ms / ms:.3f}); "
            f"{blocks.value} blocks of 256 threads")
        if pow_bits == 20:
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
    say(f"[5] kernel launches in the commit phases 4-5: {commit_counts}")
    prove_only = {"merkle_open", "fri_fold", "transcript", "grind"}  # a proof's openings and commit phase
    prove_only |= {"fft_exchange"}  # and the sharded path's exchange stages (phase 12)
    for name, count in commit_counts.items():
        check(count > 0 or name in prove_only, f"kernel {name} was never launched by the commit path")
    lap(5)

    # -- 6. commit_many --------------------------------------------------------
    blobs16 = [synthetic_data(felt_bytes(16), k) for k in range(64)]
    ops.reset_launch_counts()
    roots16 = api.commit_many(blobs16, LOG_BLOWUP, device=dev)
    batch_counts = ops.launch_counts()
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
        _, warm = api.commit_and_prove_staged(words, log_total, 7, cfg)  # warm-up: tables, caches
        wire = warm.to_bytes()
        staged_wires[log_felts] = wire  # phase 12's sharded proof
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = ops.launch_counts()
        api.commit_and_prove_staged(words, log_total, 7, cfg)
        per_proof = {k: v - before[k] for k, v in ops.launch_counts().items()}
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        layers = log_total - 2  # the proof's layers at llb 0: n - last_log
        check(per_proof["fri_fold"] == layers and per_proof["transcript"] == layers + 3
              and per_proof["grind"] == 1, f"2^{log_felts}-felt proof: launches {per_proof} for {layers} layers")
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
                committed = fri.commit_phase(words, log_total, 7, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            del os.environ["FRIEDA_SPANS"]
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        check(printed.getvalue().startswith(f"[span] {SPANS[3]}: "), f"2^{log_felts}-felt commit phase "
              f"under FRIEDA_SPANS=1 printed {printed.getvalue()!r}")
        end.record()
        end.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                committed.fetch()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs = sum("called a synchronizing" in str(w.message) for w in caught)
        check(syncs == 1, f"2^{log_felts}-felt commit phase: {syncs} synchronizing operations in its fetch")
        check(fri.finish_proof(committed, log_total, cfg)[1].to_bytes() == wire,
              f"2^{log_felts}-felt proof after the sync-free commit phase differs")
        say(f"[9] 2^{log_felts}-felt commit phase under sync debug mode 'error' and FRIEDA_SPANS=1: no "
            f"synchronization ({printed.getvalue().strip()}); host enqueue {enqueue_ms:.3f} ms, device "
            f"{start.elapsed_time(end):.3f} ms (CUDA events from before the first launch); then {syncs} "
            f"synchronizing fetch of {committed.packed.numel()} words before the decommitment; proof bytes "
            f"unchanged")
        del committed
        walls, splits = [], []
        for _ in range(3):
            stats = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, proof = fri.prove_words(words, log_total, 7, cfg, stats=stats)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            splits.append(" ".join(f"{k} {v * 1e3:.3f}" for k, v in stats["stage_s"].items()))
            check(proof.to_bytes() == wire, f"2^{log_felts}-felt proof changed between runs")
            opened = stats["stage_launches"]["decommit_open"]
            check(stats["open_launches"] == 1 and opened["merkle_open"] == 1 and opened["merkle_level"] == 0,
                  f"2^{log_felts}-felt proof: the decommitment launched {opened}")
        say(f"[9] staged prove 2^{log_felts} felts, {nq} queries, pow 20 (stages synchronized): median "
            f"{statistics.median(walls) * 1e3:.3f} ms of {[round(w * 1e3, 3) for w in walls]}; "
            f"kernel launches per proof {per_proof} (in the decommitment: merkle_open "
            f"{opened['merkle_open']}, merkle_level rebuilds {opened['merkle_level']}); "
            f"peak device memory {peak} bytes = {peak / 2**30:.3f} GiB; proof {wire_note(warm)}")
        for i, split in enumerate(splits):
            say(f"[9]   run {i + 1} stages (ms): {split}")
        whole = {"on": [], "off": []}
        for kind in ("on", "off", "off", "on") * 5:  # no stage clock: the commit phase runs ahead of the host
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
        say(f"[9] staged prove 2^{log_felts} felts, {nq} queries, no stage clock, in turns: spans on, median "
            f"{on:.3f} ms of {[round(w, 3) for w in whole['on']]}; spans off (utils/profiling.span a no-op), "
            f"median {statistics.median(off):.3f} ms of {[round(w, 3) for w in off]}; the median with spans "
            f"{'lies' if min(off) <= on <= max(off) else 'does NOT lie'} within the spread without them; "
            f"an empty span costs {span_us:.2f} us of host time (10^4 in a row; 3 a staged prove)")
        if log_felts == 20:
            span_trace(dev, data, words, log_total, cfg)
        torch.cuda.synchronize()
        before_bytes = torch.cuda.memory_allocated(dev)
        committed = fri.commit_phase(words, log_total, 7, cfg)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev) - before_bytes
        del committed
        domain = 1 << (log_total - 2 + LOG_BLOWUP)
        safe = fri.safe_in_flight(log_total - 2, cfg.fri_config, dev)
        say(f"[9] one Committed of 2^{log_felts} felts keeps {resident} bytes on the card = "
            f"{resident / domain:.3f} bytes per domain element (words uploaded, tables cached); "
            f"prove_many window: safe {safe}, default {min(8, safe)} (card total "
            f"{fri.device_memory_bytes(dev)} bytes)")
        check(api.verify(warm, 7), f"2^{log_felts}-felt proof: verify is False")
        check(not api.verify(tampered(warm), 7), f"2^{log_felts}-felt proof: a tampered copy verifies")
        verify_ms = host_ms(lambda: api.verify(warm, 7), 5)  # noqa: B023
        say(f"[9] verify 2^{log_felts}-felt / {nq}-query proof: True, tampered copy False; "
            f"{verify_ms:.3f} ms median of 5 (host)")
        if log_felts == 24:
            del warm, proof
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            _, plain_proof = fri.prove_words(words, log_total, 7, cfg, route=plain_route())
            plain_wire = plain_proof.to_bytes()
            check(plain_wire == wire, "2^24-felt proof: kernel path bytes != plain path bytes")
            say(f"[9] 2^24-felt proof: kernel path wire bytes == plain path wire bytes "
                f"(blake2s {hashlib.blake2s(wire).hexdigest()}; plain path "
                f"{time.perf_counter() - t0:.2f} s)")
        del words
        torch.cuda.empty_cache()

    # -- 10. launch counts of the commit_many, commit_with_tree and prove phases
    prove_counts = ops.launch_counts()
    say(f"[10] kernel launches in the prove phases 8-9: {prove_counts}")
    for path, counts, unused in (("commit_many (6)", batch_counts, prove_only),
                                 ("commit_with_tree (7)", tree_counts, prove_only | {"merkle_collapse"}),
                                 ("prove (8-9)", prove_counts, {"fft_exchange"})):
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
    many_peak = torch.cuda.max_memory_allocated(dev)
    for name, count in many_counts.items():
        check(count > 0 or name == "fft_exchange", f"kernel {name} was never launched by prove_many")
    walls = {"loop": [], "prove_many": []}
    for kind in ("loop", "prove_many", "prove_many", "loop"):  # in turns
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "loop":
            out = [api.commit_and_prove(d, s, cfg, device=dev) for d, s in zip(datas, seeds)]
        else:
            out = api.prove_many(datas, seeds, cfg, device=dev)
        torch.cuda.synchronize()
        walls[kind].append(time.perf_counter() - t0)
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
        f"{prof_us:.0f} us of one profiled prove_many); kernel launches {many_counts}")
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
    del many_out, roots20
    say(f"[12] whole run {time.perf_counter() - t_start:.1f} s")

    check(set(kernels) == set(ops.kernel_wrappers()), f"kernels measured {sorted(kernels)}")
    for name, k in kernels.items():
        share = k["bound_ms"] / k["ms"]
        check(0 < share <= 1, f"{name}: bound {k['bound_ms']} ms over device {k['ms']} ms = {share} outside (0, 1]")
        say(f"[3] {name}: bound {k['bound_ms']:.6g} ms ({k['bound_by']}; utils/profiling), PERF.md section 6 "
            f"before it: {EARLIER_BOUNDS[name]} ms; device {k['ms']:.4f} ms, share {share:.3f}")
    say(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
         "launches": sum(c[name] for c in (commit_counts, batch_counts, tree_counts, prove_counts,
                                            many_counts, sharded_counts)),
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

    sharded_counts = dict.fromkeys(ops.kernel_wrappers(), 0)  # the sharded calls' launches, summed

    def launched(fn) -> tuple:
        """(fn(), {kernel: launches} of that call): every count set to 0 just
        before the call and read just after; added to `sharded_counts`."""
        ops.reset_launch_counts()
        out = fn()
        used = {k: v for k, v in ops.launch_counts().items() if v}
        for k, v in used.items():
            sharded_counts[k] += v
        return out, used

    def launched_all_but_exchange(used: dict, what: str) -> None:
        missing = [k for k in ops.kernel_wrappers() if k != "fft_exchange" and not used.get(k)]
        check(not missing and not used.get("fft_exchange"), f"{what}: launches {used}; not launched: {missing}")

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

    # the 2^24-felt / 20-query proof over 8 shards, against phase 9's
    cfg = PcsConfig(pow_bits=20, fri_config=FriConfig(LOG_BLOWUP, 0, 20))
    t0 = time.perf_counter()
    (com, proof), used = launched(lambda: sharding.sharded_commit_and_prove(data, 7, cfg, mesh8))
    first = time.perf_counter() - t0
    check(com.hex() == anchor24 and proof.to_bytes() == wire24,
          "sharded_commit_and_prove 2^24 felts / 20 queries over S = 8: bytes != phase 9's proof")
    check(api.verify(proof, 7), "sharded 2^24-felt proof: verify is False")
    check(not api.verify(tampered(proof), 7), "sharded 2^24-felt proof: a tampered copy verifies")
    # the 2^(log_size + 4) domain folds down to 2^4 (last-layer bound 2^0): log_size folds, each of a
    # layer at least 2S = 16 wide, so one fri_fold launch a shard a fold
    folds = log_total - 2
    launched_all_but_exchange(used, "sharded_commit_and_prove 2^24 felts over S = 8")
    check(used["fri_fold"] == 8 * folds and used["transcript"] == folds + 3 and used["grind"] == 1
          and used["merkle_open"] == 1 and used["ingest"] == 1,
          f"sharded_commit_and_prove 2^24 felts over S = 8: launches {used}, want fri_fold {8 * folds}, "
          f"transcript {folds + 3}, grind, merkle_open and ingest 1")
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
    say(f"[12] sharded_commit_and_prove 2^24 felts / 20 queries / pow 20 over S = 8: commitment and wire "
        f"bytes == phase 9's proof; verify True, tampered copy False (first call with the shard tables "
        f"{first:.3f} s); commit phase under sync debug mode 'error': no synchronization (host enqueue "
        f"{host:.3f} ms, device {dev_ms:.3f} ms), then {syncs} synchronizing fetch; launches per proof {used}")
    del committed
    rows = {"single": [], "sharded": []}
    commit = {"single": lambda: fri.commit_phase(words, log_total, 7, cfg),
              "sharded": lambda: fri.commit_phase_sharded(words, log_total, 7, cfg, mesh8, 0)}
    for kind in ("single", "sharded", "sharded", "single"):  # in turns
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
    out, used = launched(lambda: sharding.prove_many_sharded(datas, seeds, cfg64, mesh24))
    check([(c, p.to_bytes()) for c, p in out] == many_out, "prove_many_sharded 8 x 2^20 felts over (2, 4) "
          "differs from phase 11's proofs")
    check(all(api.verify(p, s) for (_, p), s in zip(out, seeds)), "a prove_many_sharded proof does not verify")
    check(not api.verify(tampered(out[0][1]), seeds[0]), "a tampered prove_many_sharded proof verifies")
    folds = log_total_for(len(datas[0])) - 2  # as above: one fri_fold a shard a fold, 4 shards a blob
    launched_all_but_exchange(used, "prove_many_sharded 8 x 2^20 felts over (2, 4)")
    check(used["fri_fold"] == len(datas) * 4 * folds and used["grind"] == len(datas)
          and used["merkle_open"] == len(datas),
          f"prove_many_sharded: launches {used}, want fri_fold {len(datas) * 4 * folds}, grind and "
          f"merkle_open {len(datas)}")
    blobs = [synthetic_data(felt_bytes(20), k) for k in range(16)]
    roots, used_roots = launched(lambda: sharding.commit_roots_batch(blobs, LOG_BLOWUP, mesh24))
    check(roots == roots20, "commit_roots_batch 16 x 2^20 felts over (2, 4) differs from api.commit_many")
    check(all(used_roots.get(k) for k in ("ingest", "fft_pass", "merkle_level", "merkle_collapse")),
          f"commit_roots_batch: launches {used_roots}")
    walls = {k: [] for k in ("prove_many", "prove_many_sharded", "commit_many", "commit_roots_batch")}
    calls = {"prove_many": lambda: api.prove_many(datas, seeds, cfg64, device=dev),
             "prove_many_sharded": lambda: sharding.prove_many_sharded(datas, seeds, cfg64, mesh24),
             "commit_many": lambda: api.commit_many(blobs, LOG_BLOWUP, device=dev),
             "commit_roots_batch": lambda: sharding.commit_roots_batch(blobs, LOG_BLOWUP, mesh24)}
    for one, sharded in (("prove_many", "prove_many_sharded"), ("commit_many", "commit_roots_batch")):
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
        f"byte == phase 11's prove_many, each verifies, a tampered copy does not; launches {used}; walls in "
        f"turns, ms: prove_many {walls['prove_many']}, prove_many_sharded {walls['prove_many_sharded']}; one "
        f"profiled call each: prove_many {busy['prove_many']}, prove_many_sharded {busy['prove_many_sharded']}")
    say(f"[12] commit_roots_batch 16 x 2^20 felts over a (2, 4) mesh: every root == api.commit_many's; "
        f"launches {used_roots}; walls in turns, ms: commit_many {walls['commit_many']}, commit_roots_batch "
        f"{walls['commit_roots_batch']}; one profiled call each: commit_many {busy['commit_many']}, "
        f"commit_roots_batch {busy['commit_roots_batch']}")
    for name, count in sharded_counts.items():
        check(count > 0, f"kernel {name} was never launched by the sharded calls (phase 12)")
    say(f"[12] kernel launches of phase 12's sharded calls (the first call of each; every kernel > 0): "
        f"{sharded_counts}")
    return sharded_counts


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
    the card ran kernels in it."""
    import torch

    from frieda_tpu_torch import api

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        api.commit(data, LOG_BLOWUP, device=dev)
        api.commit_and_prove(data, 7, cfg, device=dev)
        _, proof = api.commit_and_prove_staged(words, log_total, 7, cfg)
        check(api.verify(proof, 7), "the traced staged proof does not verify")
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    missing = [n for n in SPANS if n not in names]
    busy_us, records = device_busy_us(prof)
    check(not missing and records > 0, f"torch.profiler trace on the card: spans {missing} missing, "
          f"{records} device records")
    say(f"[9] torch.profiler trace of api.commit, api.commit_and_prove, the staged prove and api.verify "
        f"(2^20 felts, 64 queries) on the card: every span name present, each "
        f"{[names.count(n) for n in SPANS]} times ({', '.join(SPANS)}: the host's ranges and, where a range "
        f"enqueued device work, its annotation on the device's timeline); NVTX ranges pushed and popped "
        f"without error; {records} device records, busy {busy_us:.0f} us")


def wire_note(proof) -> str:
    wire = proof.to_bytes()
    return f"{len(wire)} bytes, {1 + len(proof.proof.inner_layers)} layers"


if __name__ == "__main__":
    sys.exit(main())
