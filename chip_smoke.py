#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the FRIDA commit (`frieda_tpu_torch`) on one
CUDA card, end to end, and check it.

    python3 chip_smoke.py

Phases, each printed as it runs:
  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. the kernel build from `frieda_tpu_torch/csrc/` (nvcc, into build/kernels/);
  3. each of the four kernels against its plain PyTorch version on the card,
     at the shapes the commit path gives it, bit-equal, with both times
     (CUDA events, median of a few runs);
  4. `api.commit(data, 4, device="cuda")` on synthetic blobs against anchor
     roots computed with the JAX package (`frieda_tpu.api.commit` on CPU);
  5. a 2^24-felt commit: the kernel path's root equals the plain path's root
     on the card; median commit time and felts/s at 2^22 and 2^24 felts;
  6. every kernel's launch count over phases 4-5 (each must be > 0) and the
     peak device memory.

Any mismatch, build failure or launch error exits nonzero. The last line is
`{"ok": true, "device": {...}}`; the line before it lists the kernels as JSON.
Without CUDA the script exits nonzero before printing any result.
"""

from __future__ import annotations

import json
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
LOG_BLOWUP = 4
SEED = 20261016
P = (1 << 31) - 1


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a CUDA card",
              file=sys.stderr)
        return 1

    from frieda_tpu_torch import api, ops
    from frieda_tpu_torch.core import fft, merkle
    from frieda_tpu_torch.ops import _build
    from frieda_tpu_torch.ops import fft as fft_ops
    from frieda_tpu_torch.ops import ingest as ingest_ops
    from frieda_tpu_torch.ops import merkle as merkle_ops
    from frieda_tpu_torch.utils.convert import from_numpy_u32, narrow, widen
    from frieda_tpu_torch.utils.packing import log_total_for, pad_to_words, words_for

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
        say(f"[3] ingest log_size={log_size}: bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        kernels["ingest"] = dict(
            source="frieda_tpu_torch/csrc/ingest.cu",
            replaces="frieda_tpu/ops/ingest_pallas.py:66", max_abs_err=err, ms=ms, plain_ms=plain_ms)
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
    say(f"[3] fft_pass n={n} log_l={log_l}, groups {groups}: bit-equal; "
        f"kernel {ms:.4f} ms ({len(groups)} launches), plain {plain_ms:.4f} ms")
    kernels["fft_pass"] = dict(
        source="frieda_tpu_torch/csrc/fft.cu",
        replaces="frieda_tpu/ops/fft_pallas.py:294", max_abs_err=max_abs_err(got, want),
        ms=ms, plain_ms=plain_ms)
    del coeffs, c64, got, want, tw

    cols = rand_u32((4, 1 << 24), P)
    c64 = widen(cols)
    got = merkle_ops.merkle_level(cols, leaf=True, fused=True)
    want = narrow(merkle_ops.merkle_level_plain(c64, leaf=True, fused=True))
    check(torch.equal(got, want), "merkle_level leaf fused at 2^24 leaves differs from plain")
    ms = cuda_ms(lambda: merkle_ops.merkle_level(cols, leaf=True, fused=True))
    plain_ms = cuda_ms(lambda: merkle_ops.merkle_level_plain(c64, leaf=True, fused=True), reps=3)
    say(f"[3] merkle_level leaf fused 2^24 -> 2^21: bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    kernels["merkle_level"] = dict(
        source="frieda_tpu_torch/csrc/merkle.cu",
        replaces="frieda_tpu/ops/merkle_pallas.py:188", max_abs_err=max_abs_err(got, want), ms=ms,
        plain_ms=plain_ms)
    del cols, c64, got, want
    # the other modes, at the widths the tree passes through
    for leaf, fused, width in ((False, True, 1 << 21), (True, False, 1 << 12), (False, False, 1 << 13)):
        x = rand_u32((4 if leaf else 8, width))
        got = merkle_ops.merkle_level(x, leaf=leaf, fused=fused)
        want = narrow(merkle_ops.merkle_level_plain(widen(x), leaf=leaf, fused=fused))
        check(torch.equal(got, want), f"merkle_level leaf={leaf} fused={fused} width={width} differs")
        say(f"[3] merkle_level leaf={leaf} fused={fused} width={width}: bit-equal")

    for m in (1, 2, 8, 4096):
        level = rand_u32((8, m))
        got = merkle_ops.merkle_collapse(level)
        want = narrow(merkle_ops.merkle_collapse_plain(widen(level)))
        check(torch.equal(got, want), f"merkle_collapse width {m} differs from plain")
    l64 = widen(level)  # the last loop's: width 4096, the commit path's collapse
    ms = cuda_ms(lambda: merkle_ops.merkle_collapse(level))
    plain_ms = cuda_ms(lambda: merkle_ops.merkle_collapse_plain(l64))
    say(f"[3] merkle_collapse widths 1, 2, 8, 4096 -> 1: bit-equal; 4096: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    kernels["merkle_collapse"] = dict(
        source="frieda_tpu_torch/csrc/merkle.cu",
        replaces="frieda_tpu/ops/merkle_pallas.py:240", max_abs_err=max_abs_err(got, want),
        ms=ms, plain_ms=plain_ms)
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
    plain_root = merkle.root_bytes(merkle_ops.merkle_collapse_plain(merkle.hash_leaves(evals))).hex()
    del evals
    torch.cuda.empty_cache()
    check(plain_root == results[24]["root"],
          f"2^24-felt commit: kernel root {results[24]['root']} != plain root {plain_root}")
    say(f"[5] 2^24-felt commit: kernel path root == plain path root {plain_root}")

    # -- 6. launch counts of phases 4-5 ---------------------------------------
    counts = ops.launch_counts()
    say(f"[6] kernel launches in phases 4-5: {counts}")
    for name, count in counts.items():
        check(count > 0, f"kernel {name} was never launched by the commit path")
    say(f"[6] peak device memory of the 2^24-felt kernel-path commit: "
        f"{results[24]['peak']} bytes; max_memory_allocated now {torch.cuda.max_memory_allocated(dev)} bytes")

    say(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
         "launches": counts[name], "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"]}
        for name, k in kernels.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
