#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FRIDA (`frieda_tpu_torch`) on one CUDA
card, end to end, and check it: the commit and the FRI prover.

    python3 chip_smoke.py

Phases, each printed as it runs:
  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. the kernel build from `frieda_tpu_torch/csrc/` (nvcc, into build/kernels/),
     and the integer instructions of one BLAKE2s compression, counted in the
     built SASS (cuobjdump), for the kernels' bounds;
  3. each of the four kernels against its plain PyTorch version on the card,
     at the shapes the commit and prove paths give it, bit-equal, with both
     times (CUDA events, median of a few runs) and the least time the card
     could take for the same work (bound);
  4. `api.commit(data, 4, device="cuda")` on synthetic blobs against anchor
     roots computed with the JAX package (`frieda_tpu.api.commit` on CPU);
  5. a 2^24-felt commit: the kernel path's root equals the plain path's root
     on the card; median commit time and felts/s at 2^22 and 2^24 felts;
  6. `api.commit_and_prove(..., device="cuda")` against the JAX package's
     proofs: the four cases of tests/data/frozen_proofs.json and two anchors
     (blake2s of the wire bytes), each commitment equal to `api.commit`;
  7. the staged prove (`api.commit_and_prove_staged`, words on the card) at
     2^20 felts / 64 queries and 2^24 felts / 20 queries (pow_bits 20,
     log_blowup 4): at 2^24 the kernel path's proof bytes equal the plain
     path's (the same prover on the plain versions); median
     prove time, a per-stage split, kernel launches per proof and peak device
     memory;
  8. every kernel's launch count over the commit phases (4-5) and over the
     prove phases (6-7): each must be > 0 in both.

Any mismatch, build failure or launch error exits nonzero. The last line is
`{"ok": true, "device": {...}}`; the line before it lists the kernels as JSON.
Without CUDA the script exits nonzero before printing any result.

    python3 chip_smoke.py --prove-fit 26

runs only phases 1-2 and one staged prove of 2^26 felts (20 queries,
pow_bits 20, log_blowup 4) and prints its time, stage split and peak device
memory: whether the largest blob the JAX bench names fits one card.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np

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

# The card's peaks for the bounds (NVIDIA H100 SXM data sheet, 700 W): device
# memory 3.35 TB/s; instructions 132 SMs x 4 schedulers x 32 lanes x
# 1.98 GHz boost = 33.45e12 32-bit integer instructions/s.
HBM_BYTES_S = 3.35e12
INT_INSTR_S = 132 * 4 * 32 * 1.98e9
# 32-bit integer instructions of one M31 butterfly on one column, as
# csrc/common.cuh writes it: m31_mul 9 (wide multiply, two Mersenne folds,
# conditional subtract), m31_add 3, m31_sub 4.
BUTTERFLY_OPS = 16


def synthetic_data(n_bytes: int, seed: int = 0) -> bytes:
    """The blob bench.py commits: byte i = (i + seed) mod 256."""
    return ((np.arange(n_bytes, dtype=np.uint32) + seed) % 256).astype(np.uint8).tobytes()


def felt_bytes(log_felts: int) -> int:
    """Blob size that fills 2^log_felts felts exactly (30 bits each)."""
    return (30 << log_felts) // 8


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def say(msg: str) -> None:
    print(msg, flush=True)


def plain_route():
    """The prover's device steps as the kernels' plain PyTorch versions (int64
    inside, int32 at the edges): the same pipeline, no kernel launched."""
    from frieda_tpu_torch.core import fft, fri
    from frieda_tpu_torch.ops import ingest as ingest_ops
    from frieda_tpu_torch.ops import merkle as merkle_ops
    from frieda_tpu_torch.utils.convert import narrow, widen

    return fri.Route(
        ingest=lambda w, log_size: narrow(ingest_ops.ingest_plain(widen(w), log_size)),
        evaluate=lambda c, tw: narrow(fft.evaluate(widen(c), tw)),
        level=lambda x, leaf, fused: narrow(merkle_ops.merkle_level_plain(widen(x), leaf, fused)),
        collapse=lambda lvl, widths: [
            narrow(o) for o in merkle_ops.merkle_collapse_plain(widen(lvl), widths)],
    )


def sass_compression_ops(so: pathlib.Path) -> int:
    """Integer instructions of one zero-state BLAKE2s compression: the SASS of
    merkle_level's one-level inner kernel (one compression per thread)
    without its loads, stores, branches and special-register reads."""
    cuobjdump = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    funcs = sass.split("Function : ")
    body = [f for f in funcs if "merkle_level_kernel" in f.split("\n", 1)[0]
            and "ILb0ELb0E" in f.split("\n", 1)[0]]
    check(len(body) == 1, f"expected one inner merkle_level kernel in the SASS, found {len(body)}")
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", body[0])
    skip = {"LDG", "STG", "LDC", "ULDC", "S2R", "S2UR", "EXIT", "BRA", "NOP", "ISETP", "BAR",
            "BSSY", "BSYNC", "RET", "CS2R", "MOV", "UMOV"}
    return sum(1 for op in ops if op not in skip)


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
    from frieda_tpu_torch.ops import _build
    from frieda_tpu_torch.ops import fft as fft_ops
    from frieda_tpu_torch.ops import ingest as ingest_ops
    from frieda_tpu_torch.ops import merkle as merkle_ops
    from frieda_tpu_torch.utils.convert import from_numpy_u32, narrow, widen
    from frieda_tpu_torch.utils.packing import log_total_for, pad_to_words, words_for

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    def rand_u32(shape, hi=1 << 32):
        return from_numpy_u32(rng.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32), dev)

    def cuda_ms(fn, reps: int = 5) -> float:
        fn()  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def max_abs_err(a, b) -> int:
        return int((widen(a) - widen(b)).abs().max().item())

    def bound(n_bytes: float, n_ops: float) -> tuple:
        """(least ms, what sets it): bytes over the memory rate or integer
        instructions over the instruction rate, whichever is longer."""
        t_bytes, t_ops = n_bytes / HBM_BYTES_S * 1e3, n_ops / INT_INSTR_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    fit = sys.argv[sys.argv.index("--prove-fit") + 1] if "--prove-fit" in sys.argv else None

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    say(f"[1] nvidia-smi: {smi}")
    say(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device 0: {torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    say(f"[2] kernels built in {time.perf_counter() - t0:.1f} s: {so}")
    for line in (so.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"[2]   {line.strip()}")
    comp_ops = sass_compression_ops(so)
    say(f"[2] one BLAKE2s compression: {comp_ops} integer instructions in the SASS")
    if fit is not None:
        return prove_fit(int(fit))

    # -- 3. each kernel against its plain version, at main-path shapes --------
    kernels = {}

    for log_size in (20, 22):
        words = rand_u32((words_for(log_size + 2),))
        w64 = widen(words)
        got = ingest_ops.ingest(words, log_size)
        want = narrow(ingest_ops.ingest_plain(w64, log_size))
        check(torch.equal(got, want), f"ingest log_size={log_size} differs from plain")
        ms = cuda_ms(lambda: ingest_ops.ingest(words, log_size))
        plain_ms = cuda_ms(lambda: ingest_ops.ingest_plain(w64, log_size))
        err = max_abs_err(got, want)
        b_ms, b_by = bound(4 * words.numel() + 16 * (1 << log_size), 0)
        say(f"[3] ingest log_size={log_size}: bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        kernels["ingest"] = dict(
            source="frieda_tpu_torch/csrc/ingest.cu",
            replaces="frieda_tpu/ops/ingest_pallas.py:66", max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by)
        del words, w64, got, want

    n, log_l = 24, 20
    tw = fft.stage_twiddles(n, dev)
    coeffs = rand_u32((4, 1 << log_l), P)
    c64 = widen(coeffs)
    got = fft.evaluate_auto(coeffs, tw)
    want = narrow(fft.evaluate(c64, tw))
    check(torch.equal(got, want), f"fft_pass plan at n={n}, log_l={log_l} differs from plain")
    ms = cuda_ms(lambda: fft.evaluate_auto(coeffs, tw))
    plain_ms = cuda_ms(lambda: fft.evaluate(c64, tw), reps=3)
    groups = fft_ops.pass_plan(n, log_l)[1]
    b_ms, b_by = bound(16 * (1 << log_l) + 4 * tw.numel() + 16 * (1 << n),
                       4 * log_l * (1 << (n - 1)) * BUTTERFLY_OPS)
    say(f"[3] fft_pass n={n} log_l={log_l}, groups {groups}: bit-equal; "
        f"kernel {ms:.4f} ms ({len(groups)} launches), plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    kernels["fft_pass"] = dict(
        source="frieda_tpu_torch/csrc/fft.cu",
        replaces="frieda_tpu/ops/fft_pallas.py:294", max_abs_err=max_abs_err(got, want),
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    del coeffs, c64, got, want, tw

    def level_bound(leaf: bool, fused: bool, width: int) -> tuple:
        out_w = width // (8 if fused else (1 if leaf else 2))
        hashes = (width if leaf else 0) + (7 * out_w if fused else (0 if leaf else out_w))
        return bound((16 if leaf else 32) * width + 32 * out_w, hashes * comp_ops)

    def level_case(leaf: bool, fused: bool, width: int, what: str) -> dict:
        x = rand_u32((4, width), P) if leaf else rand_u32((8, width))
        x64 = widen(x)
        got = merkle_ops.merkle_level(x, leaf=leaf, fused=fused)
        want = narrow(merkle_ops.merkle_level_plain(x64, leaf=leaf, fused=fused))
        check(torch.equal(got, want), f"merkle_level leaf={leaf} fused={fused} width={width} differs")
        ms = cuda_ms(lambda: merkle_ops.merkle_level(x, leaf=leaf, fused=fused))
        plain_ms = cuda_ms(lambda: merkle_ops.merkle_level_plain(x64, leaf=leaf, fused=fused), reps=3)
        b_ms, b_by = level_bound(leaf, fused, width)
        say(f"[3] merkle_level leaf={leaf} fused={fused} width {width} ({what}): bit-equal; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        return dict(max_abs_err=max_abs_err(got, want), ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by)

    kernels["merkle_level"] = dict(
        source="frieda_tpu_torch/csrc/merkle.cu", replaces="frieda_tpu/ops/merkle_pallas.py:188",
        **level_case(True, True, 1 << 24, "leaf3_level, 2^22-felt commit's first tree"))
    level_case(False, True, 1 << 23, "inner3_level, 2^24-felt prove's first tree")
    level_case(True, False, 1 << 12, "leaf_level, prove's leaf rebuilds")
    level_case(False, False, 1 << 13, "inner_level, prove's node rebuilds")

    for m in (1, 2, 8, 4096):
        level = rand_u32((8, m))
        got = merkle_ops.merkle_collapse(level)[0]
        want = narrow(merkle_ops.merkle_collapse_plain(widen(level))[0])
        check(torch.equal(got, want), f"merkle_collapse width {m} differs from plain")
    for m in (8, 64, 512, 4096):
        widths = merkle.tail_widths(m)
        level = rand_u32((8, m))
        got = merkle_ops.merkle_collapse(level, widths)
        want = merkle_ops.merkle_collapse_plain(widen(level), widths)
        check(len(got) == len(want) and all(torch.equal(g, narrow(w)) for g, w in zip(got, want)),
              f"merkle_collapse {m} -> {widths} differs from plain")
    l64 = widen(level)  # the last loop's: 4096 -> (512, 64, 8, 1), a 2^26 tree's tail
    ms = cuda_ms(lambda: merkle_ops.merkle_collapse(level, widths))
    plain_ms = cuda_ms(lambda: merkle_ops.merkle_collapse_plain(l64, widths))
    ms_root = cuda_ms(lambda: merkle_ops.merkle_collapse(level))
    b_ms, b_by = bound(32 * (4096 + sum(widths)), 4095 * comp_ops)
    say(f"[3] merkle_collapse widths 1, 2, 8, 4096 -> 1 and 8, 64, 512, 4096 -> m/8^j, 1: "
        f"bit-equal; 4096 -> {widths}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.6f} ms ({b_by}); 4096 -> 1: kernel {ms_root:.4f} ms")
    kernels["merkle_collapse"] = dict(
        source="frieda_tpu_torch/csrc/merkle.cu",
        replaces="frieda_tpu/ops/merkle_pallas.py:240",
        max_abs_err=max(max_abs_err(g, narrow(w)) for g, w in zip(got, want)),
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    torch.cuda.synchronize()

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
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            root = api.commit(data, LOG_BLOWUP, device=dev)
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        felts = 1 << log_felts
        results[log_felts] = dict(ms=ms, wall_s=wall, peak=peak, root=root.hex())
        say(f"[5] commit 2^{log_felts} felts ({len(data)} bytes, domain 2^{log_total - 2 + LOG_BLOWUP}): "
            f"device {ms:.3f} ms median = {felts / (ms / 1e3) / 1e6:.2f} M felts/s; "
            f"whole call {wall * 1e3:.1f} ms = {felts / wall / 1e6:.2f} M felts/s; "
            f"peak device memory {peak / 2**30:.3f} GiB; root {root.hex()}")
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
    for name, count in commit_counts.items():
        check(count > 0, f"kernel {name} was never launched by the commit path")

    # -- 6. proofs against the JAX package's ---------------------------------
    ops.reset_launch_counts()
    cases = [(c["name"], c["data_len"], c["data_seed_offset"], c["seed"], c["config"],
              c["commitment"], c["wire_blake"]) for c in json.loads(FROZEN.read_text())]
    cases += [(name, n_bytes, 0, seed, cfg, com, blake)
              for name, n_bytes, seed, cfg, com, blake in PROVE_ANCHORS]
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
        say(f"[6] prove {name} ({n_bytes} bytes, seed {seed}): wire bytes match the JAX package's "
            f"({wire_note(proof)}), commitment == api.commit ({wall:.3f} s)")

    # -- 7. the staged prove at full width ------------------------------------
    prove_rows = {}
    for log_felts, nq in ((20, 64), (24, 20)):
        cfg = PcsConfig(pow_bits=20, fri_config=FriConfig(LOG_BLOWUP, 0, nq))
        data = synthetic_data(felt_bytes(log_felts))
        log_total = log_total_for(len(data))
        words = from_numpy_u32(pad_to_words(data, log_total), dev)
        _, warm = api.commit_and_prove_staged(words, log_total, 7, cfg)  # warm-up: tables, caches
        wire = warm.to_bytes()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = ops.launch_counts()
        api.commit_and_prove_staged(words, log_total, 7, cfg)
        per_proof = {k: v - before[k] for k, v in ops.launch_counts().items()}
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, proof = api.commit_and_prove_staged(words, log_total, 7, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            check(proof.to_bytes() == wire, f"2^{log_felts}-felt proof changed between runs")
        stats = {}
        fri.prove_words(words, log_total, 7, cfg, stats=stats)
        split = " ".join(f"{k} {v * 1e3:.3f}" for k, v in stats["stage_s"].items())
        prove_rows[log_felts] = dict(ms=statistics.median(walls) * 1e3, walls_ms=[w * 1e3 for w in walls],
                                     split_ms={k: v * 1e3 for k, v in stats["stage_s"].items()},
                                     launches=per_proof, rebuild=stats["rebuild_launches"], peak=peak)
        say(f"[7] staged prove 2^{log_felts} felts, {nq} queries, pow 20: median "
            f"{prove_rows[log_felts]['ms']:.3f} ms of {[round(w * 1e3, 3) for w in walls]}; "
            f"stages (synchronized run, ms): {split}; kernel launches per proof {per_proof} "
            f"(of them merkle_level for node rebuilds: {stats['rebuild_launches']}); "
            f"peak device memory {peak} bytes = {peak / 2**30:.3f} GiB; proof {wire_note(warm)}")
        if log_felts == 24:
            del warm, proof
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            _, plain_proof = fri.prove_words(words, log_total, 7, cfg, route=plain_route())
            plain_wire = plain_proof.to_bytes()
            check(plain_wire == wire, "2^24-felt proof: kernel path bytes != plain path bytes")
            say(f"[7] 2^24-felt proof: kernel path wire bytes == plain path wire bytes "
                f"(blake2s {hashlib.blake2s(wire).hexdigest()}; plain path "
                f"{time.perf_counter() - t0:.2f} s)")
        del words
        torch.cuda.empty_cache()

    # -- 8. launch counts of the prove phases ----------------------------------
    prove_counts = ops.launch_counts()
    say(f"[8] kernel launches in the prove phases 6-7: {prove_counts}")
    for name, count in prove_counts.items():
        check(count > 0, f"kernel {name} was never launched by the prove path")
    say(f"[8] whole run {time.perf_counter() - t_start:.1f} s")

    say(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
         "launches": commit_counts[name] + prove_counts[name], "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": None}
        for name, k in kernels.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def wire_note(proof) -> str:
    wire = proof.to_bytes()
    return f"{len(wire)} bytes, {1 + len(proof.proof.inner_layers)} layers"


if __name__ == "__main__":
    sys.exit(main())
