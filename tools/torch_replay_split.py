#!/usr/bin/env python3
"""Where the device time of a proof's commit phase goes, kernel by kernel:
the records of its CUDA graph's replay in a torch.profiler trace.

    python3 tools/torch_replay_split.py [--root DIR] [--replays N]
    python3 tools/torch_replay_split.py --compare DIR [--replays N]
    python3 tools/torch_replay_split.py --inline [--replays N]

For the staged proofs of chip_smoke.py phase 9 (2^20 felts / 64 queries and
2^24 felts / 20 queries, pow_bits 20, log_blowup 4, seed 7): three warm
proofs through `fri.dispatch_words`, then N replays (default 7),
each counted in a `torch.profiler` trace of its own (the device's activity
only) behind a warm replay (chip_smoke.py's `traced_run`) and finished
after it. Per cell: the median over the replays of the span from
the first device record to the end of the last, and for each kernel (the
port's by name, PyTorch's as "torch") the median of its records' summed
durations and of the idle gaps after them; then "the channel": the
collapses and the transcript launches with their gaps, where the layers'
Fiat-Shamir steps run. The records are read by chip_smoke.py's
`replay_device_ms`, from this checkout. The first line gives the card's
`nvidia-smi` name and power limit. Exits nonzero without CUDA.

`--root` imports `frieda_tpu_torch` from another checkout (an older commit
unpacked under build/). `--compare DIR` builds both checkouts' kernels at
once, then runs DIR, this checkout, this checkout and DIR, one process each,
on the same card. `--inline` does the same for this checkout and a copy
under build/kernel_variants/ whose channel hash (`csrc/blake2s.cuh`
`hash_after`) is inlined at each call site.
"""

from __future__ import annotations

import argparse
import importlib.util
import pathlib
import statistics
import sys

from torch_harness import REPO, build_all, card, in_turns, package_copies

INLINE = [("inline", [("csrc/blake2s.cuh", "static __device__ __noinline__ void hash_after",
                       "__device__ inline void hash_after")])]


def smoke():
    """This checkout's chip_smoke.py, loaded from its file (its helpers
    import nothing of `frieda_tpu_torch` at import)."""
    spec = importlib.util.spec_from_file_location("frieda_chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def split(root: pathlib.Path, replays: int) -> None:
    import torch

    from frieda_tpu_torch.config import FriConfig, PcsConfig
    from frieda_tpu_torch.core import fri
    from frieda_tpu_torch.utils.convert import from_numpy_u32
    from frieda_tpu_torch.utils.packing import log_total_for, pad_to_words

    cs = smoke()
    dev = torch.device("cuda", 0)
    print(f"[split] root {root}; card {card()}", flush=True)
    for log_felts, nq in ((20, 64), (24, 20)):
        cfg = PcsConfig(pow_bits=20, fri_config=FriConfig(4, 0, nq))
        data = cs.synthetic_data(cs.felt_bytes(log_felts))
        log_total = log_total_for(len(data))
        words = from_numpy_u32(pad_to_words(data, log_total), dev)
        for _ in range(3):
            fri.finish_proof(fri.dispatch_words(words[None], log_total, [7], cfg)[0], log_total, cfg)
        spans, runs = [], []
        for _ in range(replays):
            prof, committed = cs.traced_run(
                lambda: fri.dispatch_words(words[None], log_total, [7], cfg)[0],  # noqa: B023
                lambda c: fri.finish_proof(c, log_total, cfg))  # noqa: B023
            fri.finish_proof(committed, log_total, cfg)
            events = cs.counted_events(prof)
            if not events:
                raise SystemExit("torch_replay_split: the trace of a replay holds no device record")
            first = min(e.start_ns() for e in events)
            spans.append((max(e.start_ns() + e.duration_ns() for e in events) - first) / 1e6)
            port, plain, _, _ = cs.replay_device_ms(prof)
            port["torch"] = [sum(v[i] for v in plain.values()) for i in range(3)]
            runs.append(port)
        print(f"[split] 2^{log_felts} felts / {nq} q: replay span median {statistics.median(spans):.4f} ms of "
              f"{[round(x, 4) for x in spans]}", flush=True)
        for name in sorted(runs[0]):
            n = runs[0][name][0]
            ms = statistics.median(r[name][1] for r in runs)
            gaps = statistics.median(r[name][2] for r in runs)
            print(f"[split]   {name}: {n} records, {ms:.4f} ms, gaps after them {gaps:.4f} ms", flush=True)
        channel = [sum(r.get(k, [0, 0.0, 0.0])[1] + r.get(k, [0, 0.0, 0.0])[2] for k in ("merkle_collapse", "transcript"))
                   for r in runs]
        print(f"[split]   the channel (collapses and transcript launches with their gaps): median "
              f"{statistics.median(channel):.4f} ms", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--replays", type=int, default=7)
    ap.add_argument("--compare")
    ap.add_argument("--inline", action="store_true")
    args = ap.parse_args()
    if args.compare or args.inline:
        roots = ([pathlib.Path(args.compare).resolve(), REPO] if args.compare else
                 [REPO] + package_copies(REPO / "build" / "kernel_variants", INLINE))
        if not build_all(roots):
            return 1
        return in_turns(roots, lambda root: [sys.executable, __file__, "--root", str(root),
                                             "--replays", str(args.replays)])
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("torch_replay_split: CUDA is not available", file=sys.stderr)
        return 1
    split(root, args.replays)
    return 0


if __name__ == "__main__":
    sys.exit(main())
