#!/usr/bin/env python3
"""Time the ingest's host copy (`utils/packing.stack_words`) on the card's host.

    python3 tools/torch_copy_times.py [--rounds N] [--out FILE]

What sets `packing.SPLIT_BYTES` and `packing.MAX_COPY_THREADS`, in one
process, the blobs' bytes copied into a reused page-locked buffer as the
main path copies them (two source blobs in turns, as the benchmark's pool
sends them):
- `threads`: a 62,914,560-byte blob (2^24 felts) copied by a
  `packing.RowCopier` of 1, 2, 4, 8 and 16 threads, the counts in turns, a
  round each: median, quartiles and 95th percentile ms, GB/s;
- `sizes`: blobs of 2^16 ... 2^26 bytes copied whole (1 thread) and split
  (each thread count of `--split`), in turns: the median µs of each and the
  smallest size from which every larger one copies faster split;
- `handoff`: one no-op chunk through the pool and back, µs;
- `stack_words`: the module's own copier through `stack_words(..., pin=True)`
  at 2^24 felts, ms, with `copy_counts()` before and after.
Each copy is checked byte for byte against the source. Prints the card, its
power limit, the process's CPUs and torch's version first; `--out` writes
every number as JSON. Needs CUDA for the page-locked buffer and exits
nonzero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

BLOB = 62_914_560  # 2^24 felts of 30 bits
LOG_TOTAL = 24  # its log_total: 2^24 felts
THREADS = (1, 2, 4, 8, 16)


def quartiles(values) -> dict:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    p95 = sorted(values)[min(len(values) - 1, int(0.95 * len(values)))]
    return {"median": q2, "q1": q1, "q3": q3, "p95": p95, "n": len(values)}


def timed(copier, rows, src) -> float:
    t0 = time.perf_counter()
    copier.copy(rows, [src])
    return time.perf_counter() - t0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=40)
    p.add_argument("--split", default="2,4,8", help="thread counts of the size sweep's split copies")
    p.add_argument("--out", default=None)
    args = p.parse_args()

    import torch

    from frieda_tpu_torch.utils import packing

    if not torch.cuda.is_available():
        print("no CUDA card: the page-locked buffer needs one", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    head = {"card": smi, "cpus": len(os.sched_getaffinity(0)), "torch": torch.__version__,
            "numpy": np.__version__}
    print(f"card {smi}; {head['cpus']} CPUs in the affinity; torch {torch.__version__}, numpy {np.__version__}")
    out = {"head": head}

    host = torch.empty((1, packing.words_for(LOG_TOTAL)), dtype=torch.int32, pin_memory=True)
    rows = host.numpy().view(np.uint8)
    rng = np.random.default_rng(20261018)
    srcs = [np.frombuffer(bytearray(rng.bytes(BLOB)), np.uint8) for _ in range(2)]

    def check(src, n):
        if not np.array_equal(rows[0, :n], src[:n]):
            raise SystemExit(f"copy of {n} bytes differs from its source")

    # threads: the 2^24-felt blob, counts in turns
    copiers = {t: packing.RowCopier(0, t) for t in THREADS}
    for t in THREADS:  # warm: the pools' threads, the buffer's pages
        for src in srcs:
            copiers[t].copy(rows, [src])
            check(src, BLOB)
    ms = {t: [] for t in THREADS}
    for r in range(args.rounds):
        for t in THREADS if r % 2 == 0 else THREADS[::-1]:
            ms[t].append(timed(copiers[t], rows, srcs[r % 2]) * 1e3)
    check(srcs[(args.rounds - 1) % 2], BLOB)
    out["threads"] = {}
    for t in THREADS:
        q = quartiles(ms[t])
        out["threads"][t] = q
        print(f"threads {t:2d}: {BLOB} bytes median {q['median']:.3f} ms (q1 {q['q1']:.3f}, q3 {q['q3']:.3f}, "
              f"p95 {q['p95']:.3f}; {q['n']} copies) = {BLOB / q['median'] / 1e6:.2f} GB/s")

    # sizes: whole against split, in turns
    splits = [int(t) for t in args.split.split(",")]
    whole = copiers[1]
    out["sizes"] = {}
    for log_n in range(16, 27):
        n = min(1 << log_n, BLOB)
        parts = [src[:n] for src in srcs]
        us = {t: [] for t in [1] + splits}
        for r in range(args.rounds):
            for t in [1] + splits:
                us[t].append(timed(whole if t == 1 else copiers[t], rows, parts[r % 2]) * 1e6)
        check(parts[(args.rounds - 1) % 2], n)
        med = {t: statistics.median(v) for t, v in us.items()}
        out["sizes"][n] = med
        print(f"size {n:9d} bytes: whole {med[1]:9.1f} us; " + "; ".join(
            f"split over {t} {med[t]:9.1f} us ({med[1] / med[t]:.2f}x)" for t in splits))
    for t in splits:
        sizes = sorted(out["sizes"])
        faster = [n for i, n in enumerate(sizes) if all(out["sizes"][m][t] < out["sizes"][m][1] for m in sizes[i:])]
        print(f"split over {t}: faster than whole from {faster[0] if faster else 'no size'} bytes on")

    # handoff: a no-op chunk through the pool
    pool = copiers[2]._pool
    hand = []
    for _ in range(args.rounds * 10):
        t0 = time.perf_counter()
        pool.submit(lambda: None).result()
        hand.append((time.perf_counter() - t0) * 1e6)
    out["handoff_us"] = quartiles(hand)
    print(f"handoff: a no-op chunk to a worker and back, median {out['handoff_us']['median']:.1f} us "
          f"(q1 {out['handoff_us']['q1']:.1f}, q3 {out['handoff_us']['q3']:.1f})")

    # the module's copier through stack_words
    before = packing.copy_counts()
    got = []
    for r in range(args.rounds):
        blob = srcs[r % 2]
        t0 = time.perf_counter()
        words = packing.stack_words([blob.data], LOG_TOTAL, pin=True)
        got.append((time.perf_counter() - t0) * 1e3)
        if r == 0 and not np.array_equal(words.numpy().view(np.uint8)[0, :BLOB], blob):
            raise SystemExit("stack_words differs from its blob")
        del words
    after = packing.copy_counts()
    q = quartiles(got)
    out["stack_words"] = {**q, "counts_before": before, "counts_after": after,
                          "split_bytes": packing.SPLIT_BYTES, "max_threads": packing.MAX_COPY_THREADS}
    print(f"stack_words 2^24 felts, pin=True (SPLIT_BYTES {packing.SPLIT_BYTES}, MAX_COPY_THREADS "
          f"{packing.MAX_COPY_THREADS}): median {q['median']:.3f} ms (q1 {q['q1']:.3f}, q3 {q['q3']:.3f}, "
          f"p95 {q['p95']:.3f}); copy_counts {before} -> {after}")
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
