#!/usr/bin/env python3
"""Time the port's low-degree extension (`core.fft.evaluate_auto`, the
`fft_pass` launches of `ops.fft.pass_plan`) on one CUDA card, whole and per
launch, at the main-path shapes, each checked bit-equal to the plain
`core.fft.evaluate` first.

    python3 tools/torch_lde_times.py [--root DIR] [--reps N]
    python3 tools/torch_lde_times.py --ablate

`--root` imports `frieda_tpu_torch` from another checkout (for example an
older commit unpacked under build/), so two versions can be timed in turns
in one process launch each, on the same card. Prints one line per shape and
launch (CUDA events, median of --reps after a warm-up) and the card's
`nvidia-smi` name and power limit. Exits nonzero without CUDA.

`--ablate` copies this checkout's package under build/lde_ablate/ three
times, each with one part of `csrc/fft.cu` taken out, and times the copies
and the kernel as it is, in turns (their outputs are wrong by design and
not checked): `no_arith` (no butterflies and no twiddle loads: the index
math, shared-memory exchanges and device-memory traffic alone),
`no_twiddle_loads` (twiddles made from the index instead of read) and
`no_device_memory` (inputs made from the index, no stores).
"""

from __future__ import annotations

import argparse
import pathlib
import shutil
import statistics
import subprocess
import sys

import numpy as np

SHAPES = ((22, 18), (24, 20), (26, 22))  # 2^20-felt prove, 2^22 commit, 2^24 commit and prove
P = (1 << 31) - 1
REPO = pathlib.Path(__file__).resolve().parents[1]
# (name, [(text in csrc/fft.cu, its replacement), ...])
ABLATIONS = (
    ("no_arith", [("butterfly(x[e], x[e | (1 << b)], t2[(1 << b) - 1 + lo]);", "x[e] ^= 1u;"),
                  ("t2[(1 << b) - 1 + lo] = *T << 1;", "t2[(1 << b) - 1 + lo] = 0;")]),
    ("no_twiddle_loads", [("t2[(1 << b) - 1 + lo] = *T << 1;",
                           "t2[(1 << b) - 1 + lo] = (jb + lo + b) << 1;")]),
    ("no_device_memory", [("x[e] = *s;", "x[e] = (jb + e) & 0x3fffffffu;"),
                          ("*d = x[e];", "if (x[e] == 0xffffffffu) *d = x[e];")]),
)


def ablate(reps: int) -> int:
    """Time the kernel and its ablated copies, in turns, one process each."""
    out = REPO / "build" / "lde_ablate"
    shutil.rmtree(out, ignore_errors=True)
    roots = [REPO]
    for name, edits in ABLATIONS:
        pkg = out / name / "frieda_tpu_torch"
        shutil.copytree(REPO / "frieda_tpu_torch", pkg, ignore=shutil.ignore_patterns("__pycache__"))
        src = (pkg / "csrc" / "fft.cu").read_text()
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"torch_lde_times: {name}: {old!r} not in csrc/fft.cu")
            src = src.replace(old, new)
        (pkg / "csrc" / "fft.cu").write_text(src)
        roots.append(out / name)
    builds = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                                "from frieda_tpu_torch.ops import _build; _build.build()", str(r)])
              for r in roots]
    if any(b.wait() for b in builds):
        return 1
    for root in roots + roots[::-1]:
        cmd = [sys.executable, __file__, "--root", str(root), "--reps", str(reps)]
        if root != REPO:
            cmd.append("--no-check")
        if subprocess.run(cmd).returncode:
            return 1
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    if args.ablate:
        return ablate(args.reps)
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_lde_times: CUDA is not available", file=sys.stderr)
        return 1
    from frieda_tpu_torch.core import fft
    from frieda_tpu_torch.ops import fft as fft_ops
    from frieda_tpu_torch.utils.convert import from_numpy_u32, narrow, widen

    dev = torch.device("cuda", 0)

    def cuda_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip()
    print(f"[lde] root {args.root}; card {smi}", flush=True)
    rng = np.random.default_rng(20261016)
    for n, log_l in SHAPES:
        tw = fft.stage_twiddles(n, dev)
        coeffs = from_numpy_u32(rng.integers(0, P, (4, 1 << log_l), dtype=np.uint32), dev)
        got = fft.evaluate_auto(coeffs, tw)
        if not args.no_check and not torch.equal(got, narrow(fft.evaluate(widen(coeffs), tw))):
            print(f"torch_lde_times: n={n} log_l={log_l} differs from plain", file=sys.stderr)
            return 1
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: fft.evaluate_auto(coeffs, tw))
        p_min, groups = fft_ops.pass_plan(n, log_l)
        what = "not checked" if args.no_check else "bit-equal"
        print(f"[lde] n={n} log_l={log_l}: {what}; {ms:.4f} ms, {len(groups)} launches", flush=True)
        src, shift = coeffs, p_min
        for p_lo, p_hi, k in groups:
            g_ms = cuda_ms(lambda: fft_ops.fft_pass(src, tw, got, p_lo, p_hi, k, shift))  # noqa: B023
            n_bytes = 4 * (src.numel() + got.numel() + (1 << p_hi) - (1 << p_lo))
            print(f"[lde]   launch ({p_lo}, {p_hi}, {k}): {g_ms:.4f} ms, {n_bytes} bytes, "
                  f"{n_bytes / g_ms / 1e9:.3f} TB/s", flush=True)
            src, shift = got, 0
        del tw, coeffs, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
