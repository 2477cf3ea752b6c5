#!/usr/bin/env python3
"""Time the port's kernels on one CUDA card at the shapes the main path
gives them, each checked bit-equal to its plain version first.

    python3 tools/torch_kernel_times.py [--root DIR] [--parts lde,ingest,merkle,open,commit] [--reps N]
    python3 tools/torch_kernel_times.py --compare DIR [--parts ...]
    python3 tools/torch_kernel_times.py --ablate
    python3 tools/torch_kernel_times.py --plans

Parts, one line each shape:
- `lde`: `core.fft.evaluate_auto` (the `fft_pass` launches of
  `ops.fft.pass_plan`) at n = 22, 24, 26, whole and per launch, with bytes
  and TB/s a launch: call time (`torch_harness.cuda_ms`, median of --reps);
- `ingest`: `ingest` at log_size 20 and 22;
- `merkle`: `merkle_collapse` at each width m at which a tree of the
  2^24-felt proof reaches it, with the prover's tail widths, and their sum
  over the proof's 22 trees, the commit's 2048 -> 1; `merkle_level` leaf
  2^12 and inner 2^13 (the one-level modes), fused leaf 2^24 and inner
  2^23;
- `open`: the decommitment at the openings of a 2^20-felt / 64-query and a
  2^24-felt / 20-query proof (the `Opening` that `fri.prove_words` runs):
  `merkle_open`'s device and call time, or, in a checkout without it, the
  device work of the one-level route it replaced (its gathers and
  `merkle_level` launches, captured with the upload served from a tensor
  uploaded before and the fetch left out); and `Opening.run`'s wall time
  (`torch_harness.host_ms`), upload and fetch included;
- `commit`: `api.commit_root_pipeline` on device-resident words of the
  synthetic 2^22- and 2^24-felt blobs (log_blowup 4), its root checked
  against `api.commit`'s;
- `build`: a fresh build of the kernel library into an empty directory,
  as `ops._build.compile_once` runs it (one nvcc a source, all started
  together, then a link) and as one nvcc over every source, in turns
  (seconds, 2 each; not in the default parts).
`ingest`, `merkle`, `open` and `commit` give device time (`torch_harness.device_ms`:
CUDA events around a replayed CUDA graph of 20 calls, per call). Each line
gives the least time the card could take for the same work and the time's
share of it, from this checkout's `frieda_tpu_torch/utils/profiling.py`
(`torch_harness.profiling`), whichever checkout `--root` names.
The first line gives the card's `nvidia-smi` name and power limit. Exits
nonzero without CUDA.

`--root` imports `frieda_tpu_torch` from another checkout (for example an
older commit unpacked under build/). `--compare DIR` builds both checkouts'
kernels at once, then runs DIR, this checkout, this checkout and DIR, one
process each, on the same card.

`--ablate` copies this checkout's package under build/kernel_variants/,
once with each part of `csrc/fft.cu` in ABLATIONS taken out, and times the
LDE of the kernel as it is and of the copies in turns (the copies' outputs
are wrong by design and not checked): what bounds each `fft_pass` launch.
`--plans` copies it with the plans' neighbours in PLANS (half and twice the
collapse cluster of `collapse_plan`, half the ingest tiles of
`ingest_tile`) and times the ingest and the Merkle kernels of the package
as it is and of the copies in turns, each checked.
"""

from __future__ import annotations

import argparse
import contextlib
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from torch_harness import (REPO, build_all, card, cuda_ms, device_ms, host_ms, in_turns,
                           package_copies, profiling, proof_collapse_widths)


LDE_SHAPES = ((22, 18), (24, 20), (26, 22))  # 2^20-felt prove, 2^22 commit, 2^24 commit and prove
P = (1 << 31) - 1
SEED = 20261016
# (name, [(file in the package, text, its replacement), ...])
ABLATIONS = (
    ("no_arith", [("csrc/fft.cu", "butterfly(x[e], x[e | (1 << b)], t2[(1 << b) - 1 + lo]);", "x[e] ^= 1u;"),
                  ("csrc/fft.cu", "t2[(1 << b) - 1 + lo] = *T << 1;", "t2[(1 << b) - 1 + lo] = 0;")]),
    ("no_twiddle_loads", [("csrc/fft.cu", "t2[(1 << b) - 1 + lo] = *T << 1;",
                           "t2[(1 << b) - 1 + lo] = (jb + lo + b) << 1;")]),
    ("no_device_memory", [("csrc/fft.cu", "x[e] = *s;", "x[e] = (jb + e) & 0x3fffffffu;"),
                          ("csrc/fft.cu", "*d = x[e];", "if (x[e] == 0xffffffffu) *d = x[e];")]),
)
PLAN_RULE = "max(1, m // BLOCK_NODES))"
PLANS = (
    ("cluster_half", [("ops/merkle.py", PLAN_RULE, "max(1, m // (2 * BLOCK_NODES)))")]),
    ("cluster_double", [("ops/merkle.py", PLAN_RULE, "max(1, 2 * m // BLOCK_NODES))")]),
    ("tiles_half", [("ops/ingest.py", "TILES_MAX = 8", "TILES_MAX = 4")]),
)


def graded(ms: float, bound: tuple) -> str:
    """`bound ... ms (what sets it), share ...` of a time against its bound."""
    return f"bound {bound[0]:.6f} ms ({bound[1]}), share {bound[0] / ms:.3f}"


def time_lde(dev, rng, reps: int, checked: bool) -> None:
    from frieda_tpu_torch.core import fft
    from frieda_tpu_torch.ops import fft as fft_ops
    from frieda_tpu_torch.utils.convert import from_numpy_u32, narrow, widen

    for n, log_l in LDE_SHAPES:
        tw = fft.stage_twiddles(n, dev)
        coeffs = from_numpy_u32(rng.integers(0, P, (4, 1 << log_l), dtype=np.uint32), dev)
        got = fft.evaluate_auto(coeffs, tw)
        if checked and not torch.equal(got, narrow(fft.evaluate(widen(coeffs), tw))):
            raise SystemExit(f"torch_kernel_times: LDE n={n} log_l={log_l} differs from plain")
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: fft.evaluate_auto(coeffs, tw), reps)  # noqa: B023
        p_min, groups = fft_ops.pass_plan(n, log_l)
        what = "bit-equal" if checked else "not checked"
        print(f"[times] LDE n={n} log_l={log_l}: {what}; call {ms:.4f} ms, {len(groups)} launches; "
              f"{graded(ms, profiling().fft_pass_bound(4, log_l, n))}", flush=True)
        src, shift = coeffs, p_min
        for p_lo, p_hi, k in groups:
            g_ms = cuda_ms(lambda: fft_ops.fft_pass(src, tw, got, p_lo, p_hi, k, shift), reps)  # noqa: B023
            n_bytes = 4 * (src.numel() + got.numel() + (1 << p_hi) - (1 << p_lo))
            print(f"[times]   launch ({p_lo}, {p_hi}, {k}): {g_ms:.4f} ms, {n_bytes} bytes, "
                  f"{n_bytes / g_ms / 1e9:.3f} TB/s", flush=True)
            src, shift = got, 0
        del tw, coeffs, got, src
        torch.cuda.empty_cache()


def time_ingest(rand_u32) -> None:
    from frieda_tpu_torch.ops import ingest as ingest_ops
    from frieda_tpu_torch.utils.convert import narrow, widen
    from frieda_tpu_torch.utils.packing import words_for

    for log_size in (20, 22):
        words = rand_u32((words_for(log_size + 2),))
        if not torch.equal(ingest_ops.ingest(words, log_size),
                           narrow(ingest_ops.ingest_plain(widen(words), log_size))):
            raise SystemExit(f"torch_kernel_times: ingest log_size={log_size} differs from plain")
        ms = device_ms(lambda: ingest_ops.ingest(words, log_size))  # noqa: B023
        form = (f" ({ingest_ops.ingest_tile(log_size)} tiles a block)"
                if hasattr(ingest_ops, "ingest_tile") else "")
        print(f"[times] ingest log_size={log_size}{form}: bit-equal; device {ms:.4f} ms; "
              f"{graded(ms, profiling().ingest_bound(words.numel(), 4 << log_size))}", flush=True)


def time_build() -> None:
    from frieda_tpu_torch.ops import _build

    nvcc, units = _build._nvcc(), [_build.CSRC / s for s in _build.SOURCES]

    def per_source(out):
        _build.compile_once(out, _build.LIB_NAME, nvcc, _build.NVCC_FLAGS, units)

    def one_nvcc(out):
        cmd = [nvcc, *_build.NVCC_FLAGS, "-o", str(out / _build.LIB_NAME)]
        subprocess.run(cmd + [str(u) for u in units if u.suffix == ".cu"], check=True, capture_output=True)

    (REPO / "build").mkdir(exist_ok=True)
    for name, fn in [("compile_once (one nvcc a source, then a link)", per_source),
                     ("one nvcc over every source", one_nvcc)] * 2:
        with tempfile.TemporaryDirectory(dir=REPO / "build") as out:
            t0 = time.perf_counter()
            fn(pathlib.Path(out))
            print(f"[times] fresh kernel build, {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def time_commit(dev) -> None:
    from frieda_tpu_torch import api
    from frieda_tpu_torch.core import merkle
    from frieda_tpu_torch.utils.convert import from_numpy_u32
    from frieda_tpu_torch.utils.packing import pad_to_words

    for log_felts in (22, 24):
        data = ((np.arange((30 << log_felts) // 8, dtype=np.uint32)) % 256).astype(np.uint8).tobytes()
        words = from_numpy_u32(pad_to_words(data, log_felts), dev)
        root = merkle.root_bytes(api.commit_root_pipeline(words, log_felts, 4))
        if root != api.commit(data, 4, device=dev):
            raise SystemExit(f"torch_kernel_times: 2^{log_felts}-felt commit root differs from api.commit")
        ms = device_ms(lambda: api.commit_root_pipeline(words, log_felts, 4), reps=3)  # noqa: B023
        roof = profiling().commit_roofline(log_felts + 2, ms / 1e3)
        print(f"[times] commit_root_pipeline 2^{log_felts} felts: device {ms:.4f} ms; "
              f"{graded(ms, (roof['min_seconds_at_sol'] * 1e3, roof['bound']))}", flush=True)
        del words
        torch.cuda.empty_cache()


def time_merkle(rand_u32) -> None:
    from frieda_tpu_torch.core import merkle
    from frieda_tpu_torch.ops import merkle as merkle_ops
    from frieda_tpu_torch.utils.convert import narrow, widen

    shapes = proof_collapse_widths()
    times = {}
    for m, widths in sorted({(m, merkle.tail_widths(m)) for m in shapes} | {(2048, (1,))}, reverse=True):
        level = rand_u32((8, m))
        got = merkle_ops.merkle_collapse(level, widths)
        want = merkle_ops.merkle_collapse_plain(widen(level), widths)
        if not all(torch.equal(g, narrow(w)) for g, w in zip(got, want)):
            raise SystemExit(f"torch_kernel_times: merkle_collapse {m} -> {widths} differs from plain")
        ms = times[m, widths] = device_ms(lambda: merkle_ops.merkle_collapse(level, widths))  # noqa: B023
        plan = f" (cluster {merkle_ops.collapse_plan(m)})" if hasattr(merkle_ops, "collapse_plan") else ""
        print(f"[times] merkle_collapse {m} -> {widths}{plan}: bit-equal; device {ms:.4f} ms; "
              f"{graded(ms, profiling().merkle_collapse_bound(m, widths))}", flush=True)
    print(f"[times] merkle_collapse over the 2^24-felt proof's {len(shapes)} trees: device "
          f"{sum(times[m, merkle.tail_widths(m)] for m in shapes):.4f} ms", flush=True)
    for leaf, fused, width in ((True, False, 1 << 12), (False, False, 1 << 13),
                               (True, True, 1 << 24), (False, True, 1 << 23)):
        x = rand_u32((4, width), P) if leaf else rand_u32((8, width))
        if not torch.equal(merkle_ops.merkle_level(x, leaf, fused),
                           narrow(merkle_ops.merkle_level_plain(widen(x), leaf, fused))):
            raise SystemExit(f"torch_kernel_times: merkle_level leaf={leaf} fused={fused} width {width} "
                             "differs from plain")
        ms = device_ms(lambda: merkle_ops.merkle_level(x, leaf, fused))  # noqa: B023
        print(f"[times] merkle_level leaf={leaf} fused={fused} width {width}: bit-equal; "
              f"device {ms:.4f} ms; {graded(ms, profiling().merkle_level_bound(width, leaf, fused))}", flush=True)


def _proof_opening(fri, words, log_total: int, cfg):
    """The `Opening` whose `run` one `fri.prove_words` call makes (the class
    a `Committed` names, or before it the module's `Opening`)."""
    seen = []

    class Recorded(fri.Opening):
        def run(self, *args):
            seen.append(self)
            return super().run(*args)

    owner, name = getattr(fri, "Committed", None), "opening_cls"
    if not hasattr(owner, name):
        owner, name = fri, "Opening"
    real = getattr(owner, name)
    setattr(owner, name, Recorded)
    try:
        fri.prove_words(words, log_total, 7, cfg)
    finally:
        setattr(owner, name, real)
    return seen[0]


@contextlib.contextmanager
def _device_work_only():
    """`Opening.run` of the one-level route with its one upload served from
    the tensor its first call uploaded and its fetch left out, so that a CUDA
    graph captures its device work alone."""
    from frieda_tpu_torch.utils import convert

    real_from_numpy, real_fetch = torch.from_numpy, convert.to_numpy_u32
    uploaded = []

    class Upload:
        def __init__(self, arr):
            self.arr = arr

        def to(self, device):
            if not uploaded:
                uploaded.append(real_from_numpy(self.arr).to(device))
            return uploaded[0]

    torch.from_numpy = Upload
    convert.to_numpy_u32 = lambda t: np.zeros(t.numel(), np.uint32)
    try:
        yield
    finally:
        torch.from_numpy, convert.to_numpy_u32 = real_from_numpy, real_fetch


def time_open(dev) -> None:
    from chip_smoke import felt_bytes, synthetic_data
    from frieda_tpu_torch.config import FriConfig, PcsConfig
    from frieda_tpu_torch.core import fri
    from frieda_tpu_torch.ops import merkle as merkle_ops
    from frieda_tpu_torch.utils.convert import from_numpy_u32, narrow
    from frieda_tpu_torch.utils.packing import log_total_for, pad_to_words

    for log_felts, nq in ((20, 64), (24, 20)):
        cfg = PcsConfig(pow_bits=20, fri_config=FriConfig(4, 0, nq))
        data = synthetic_data(felt_bytes(log_felts))
        log_total = log_total_for(len(data))
        opening = _proof_opening(fri, from_numpy_u32(pad_to_words(data, log_total), dev), log_total, cfg)
        wall = host_ms(opening.run)
        if hasattr(merkle_ops, "merkle_open"):
            args = (opening.columns, opening.trees, *opening.jobs())
            if not torch.equal(merkle_ops.merkle_open(*args), narrow(merkle_ops.merkle_open_plain(*args))):
                raise SystemExit(f"torch_kernel_times: merkle_open at 2^{log_felts} felts differs from plain")
            table = torch.from_numpy(merkle_ops.open_table(*args)).to(dev)
            ms = device_ms(lambda: merkle_ops.merkle_open(*args, table))  # noqa: B023
            call = cuda_ms(lambda: merkle_ops.merkle_open(*args))  # noqa: B023
            _, _, _, r, leaf, _ = merkle_ops.open_plan(opening.trees, *opening.jobs())
            what = (f"merkle_open bit-equal; device {ms:.4f} ms, call {call:.4f} ms; "
                    f"{graded(ms, profiling().merkle_open_bound(len(args[2]), leaf, r))}")
        else:
            with _device_work_only():
                ms = device_ms(opening.run)
            what = (f"one-level route (gathers and {opening.rebuild_launches} merkle_level launches): "
                    f"device {ms:.4f} ms")
        print(f"[times] opening of the 2^{log_felts}-felt / {nq}-query proof: {what}; Opening.run "
              f"{wall:.4f} ms", flush=True)
        del opening
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--parts", default="lde,ingest,merkle,open")
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--compare")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args()
    if args.compare or args.ablate or args.plans:
        if args.compare:
            roots, parts = [pathlib.Path(args.compare).resolve(), REPO], args.parts
        else:
            roots = [REPO] + package_copies(REPO / "build" / "kernel_variants",
                                            ABLATIONS if args.ablate else PLANS)
            parts = "lde" if args.ablate else "ingest,merkle"
        if not build_all(roots):
            return 1
        return in_turns(roots, lambda root: [
            sys.executable, __file__, "--root", str(root), "--reps", str(args.reps), "--parts", parts]
            + (["--no-check"] if args.ablate and root != REPO else []))
    parts = args.parts.split(",")
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    if not torch.cuda.is_available():
        print("torch_kernel_times: CUDA is not available", file=sys.stderr)
        return 1
    from frieda_tpu_torch.utils.convert import from_numpy_u32

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    def rand_u32(shape, hi=1 << 32):
        return from_numpy_u32(rng.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32), dev)

    print(f"[times] root {args.root}; card {card()}", flush=True)
    if "lde" in parts:
        time_lde(dev, rng, args.reps, not args.no_check)
        torch.cuda.empty_cache()
    if "ingest" in parts:
        time_ingest(rand_u32)
    if "merkle" in parts:
        time_merkle(rand_u32)
    if "open" in parts:
        time_open(dev)
    if "commit" in parts:
        time_commit(dev)
    if "build" in parts:
        time_build()
    return 0


if __name__ == "__main__":
    sys.exit(main())
