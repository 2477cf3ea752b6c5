#!/usr/bin/env python3
"""Time the `grind` kernel on one CUDA card and take it apart.

    python3 tools/torch_grind_times.py [--root DIR]
    python3 tools/torch_grind_times.py --ablate [--root DIR]
    python3 tools/torch_grind_times.py --compare DIR

Cases, each nonce checked against the plain sweep (`ops.channel.grind_plain`):
- `one`: chip_smoke phase 3's channel (a fresh state mixed with 20261016 + 20),
  pow_bits 20;
- `batch`: 8 channels (a fresh (8, 9) state mixed with seeded words), pow_bits
  20: one launch over the 8, the 8 one-channel launches in one graph, and each
  channel alone;
- `preset`: the same launches with each blob's best set to its known
  minimum + 1 before the launch instead of 2^64 - 1 (the C entry called
  directly): the same hashes below the minimum, but no thread runs past it
  waiting to learn of a hit. fresh - preset is what finding the hit late
  costs;
- `probe`: pow_bits 128 (no nonce qualifies) with best preset to N: exactly
  the nonces [0, N) of each blob hashed, at N = 2^18 ... 2^23, one blob and 8:
  the hashing rate and the launch's fixed cost, T(N) = a + N / rate.
Device ms are `torch_harness.device_ms` (CUDA events around a replayed graph
of 20 calls, per call); each beside `utils/profiling.grind_bound` and its
share. `nvidia-smi --query-gpu=clocks.sm,power.draw,power.limit,
temperature.gpu` is sampled every 20 ms while a case runs back to back for
~0.4 s. The grind kernel's registers and stack come from the build's
`-Xptxas -v` log; the grid from the plan.

`--ablate --root DIR`, DIR a checkout of the two-body grid-stride kernel
before the redesign, copies DIR's package under build/grind_variants/ with
the edits of PARENT_ABLATIONS (its per-nonce best read hoisted or thinned,
its grid doubled or halved), builds every copy at once and runs the cases
on DIR and on each copy in turns (A B ... B A), one process each. The
copies' results are checked like the original's. The kernel of this
checkout gets the plan sweep instead: SWEEP's blocks an SM and k. `--compare
DIR` runs DIR, this checkout, this checkout, DIR. Exits nonzero without
CUDA.
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

from torch_harness import REPO, build_all, card, clocks_beside, device_ms, in_turns, package_copies, profiling

SEED = 20261016
POW_BITS = 20
M64 = (1 << 64) - 1
PROBE_LOGS = (18, 20, 22, 23)
PARENT_ONE_LOOP = ("    for (unsigned long long nonce = first;; nonce += stride) {\n"
                   "      if (nonce >= *seen) return;")
PARENT_GRID = "cached = sms * (per_sm > 0 ? per_sm : 1);"
# (name, [(file in the package, text, its replacement), ...]) for the
# two-body grid-stride kernel before the redesign (one channel's
# grind_kernel<true>, a batch's grind_kernel<false>).
# "best_read_once" reads best once before the loop (capped at 2^26, so a
# launch ends even with best at 2^64 - 1); it runs in the preset cases only,
# where best starts at the answer + 1 and no later read could change a
# thread's exit.
PARENT_ABLATIONS = (
    ("best_read_once", [("csrc/channel.cu", PARENT_ONE_LOOP,
                         "    const unsigned long long stop = min(*seen, 1ull << 26);\n"
                         "    for (unsigned long long nonce = first;; nonce += stride) {\n"
                         "      if (nonce >= stop) return;")]),
    ("best_read_every_4", [("csrc/channel.cu", PARENT_ONE_LOOP,
                            "    unsigned turn = 0;\n"
                            "    for (unsigned long long nonce = first;; nonce += stride) {\n"
                            "      if ((turn++ & 3u) == 0u && nonce >= *seen) return;")]),
    ("best_read_every_16", [("csrc/channel.cu", PARENT_ONE_LOOP,
                             "    unsigned turn = 0;\n"
                             "    for (unsigned long long nonce = first;; nonce += stride) {\n"
                             "      if ((turn++ & 15u) == 0u && nonce >= *seen) return;")]),
    ("grid_2x", [("csrc/channel.cu", PARENT_GRID, "cached = 2 * sms * (per_sm > 0 ? per_sm : 1);")]),
    ("grid_half", [("csrc/channel.cu", PARENT_GRID, "cached = sms * (per_sm > 1 ? per_sm / 2 : 1);")]),
)
# (blocks an SM, k) of the plan sweep: this checkout's kernel only.
SWEEP = tuple((per_sm, k) for per_sm in (1, 2, 3, 4, 8) for k in (1, 2, 4, 8, 16))
PRESET_ONLY = {"best_read_once"}


def build_registers() -> list:
    """'kernel: registers ...; spills' of each grind kernel in the `-Xptxas -v`
    log of the library that the imported package built, and the grind
    kernels' SASS opcodes, most frequent first."""
    from frieda_tpu_torch.ops import _build

    so = _build.build()
    out, kernel, spills = [], None, ""
    for line in (so.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and kernel and "grind" in kernel:
            out.append(f"{kernel}: {line.split(':', 1)[1].strip()}; {spills}")
    cuobjdump = pathlib.Path("/usr/local/cuda/bin/cuobjdump")
    if cuobjdump.exists():
        sass = subprocess.run([str(cuobjdump), "-sass", str(so)], check=True, capture_output=True, text=True).stdout
        for body in sass.split("Function : ")[1:]:
            if "grind" in body.split("\n", 1)[0]:
                ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*(?:\.[A-Z0-9_]+)*)", body)
                counts = collections.Counter(op.split(".")[0] for op in ops)
                out.append(f"{body.split(chr(10), 1)[0].strip()} SASS: {len(ops)} instructions; "
                           + ", ".join(f"{k} {v}" for k, v in counts.most_common(14)))
    return out


class Launcher:
    """Grind launches of the package imported from --root, either through the
    wrapper (fresh: best at 2^64 - 1) or through the C entry with every
    blob's best preset."""

    def __init__(self):
        from frieda_tpu_torch.ops import _build
        from frieda_tpu_torch.ops import channel as channel_ops

        self.ops, self.build = channel_ops, _build
        self.planned = hasattr(channel_ops, "grind_plan")

    def grid(self, blobs: int) -> str:
        if self.planned:
            return str(self.ops.grind_plan(blobs))
        import ctypes

        blocks = ctypes.c_int()
        self.build.library().frieda_grind_blocks(ctypes.byref(blocks))
        return f"{blocks.value} blocks of 256 threads, grid-stride"

    def fresh(self, state, pow_bits):
        return self.ops.grind(state, pow_bits)

    def preset(self, state, pow_bits, bests):
        """A call that launches with best[b] = bests[b] on entry (a device
        copy from a tensor made here, so a CUDA graph can hold the call) and
        returns the (B,) int64 bests."""
        blobs = len(bests)
        signed = [b - (1 << 64) if b >= 1 << 63 else b for b in bests]
        if self.planned:
            plan = self.ops.grind_plan(blobs)
            src = self.ops.grind_buffer(blobs, state.device)
            src[:blobs] = torch.tensor(signed, dtype=torch.int64)
            buf = torch.empty_like(src)

            def call():
                buf.copy_(src)
                self.ops.grind_launch(state.view(-1, 9), pow_bits, buf, plan)
                return buf[:blobs]
            return call
        src = torch.tensor(signed, dtype=torch.int64, device=state.device)
        buf = torch.empty_like(src)

        def call():
            buf.copy_(src)
            self.build.check_launch(self.build.library().frieda_grind(
                state.data_ptr(), pow_bits, buf.data_ptr(), blobs, self.build.stream_of(state)))
            return buf
        return call


def nonces_of(words: torch.Tensor) -> list:
    """Nonces as ints from (..., 2) int32 words (lo, hi) or int64 values."""
    if words.dtype == torch.int32:
        words = words.reshape(-1, 2).contiguous().view(torch.int64)
    return [int(v) & M64 for v in words.reshape(-1).tolist()]


def graded(ms: float, nonces) -> str:
    b_ms, b_by = profiling().grind_bound(nonces)
    return f"device {ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}), share {b_ms / ms:.3f}"


def sweep_plans(name: str, cases) -> None:
    """Device ms of each (name, state, nonces) case under each plan of SWEEP
    (blocks an SM at most what the card holds), each result checked."""
    from frieda_tpu_torch.ops import channel as channel_ops

    defaults = {channel_ops.grind_plan(1): " (one channel's plan)", channel_ops.grind_plan(8): " (8 and 64's plan)"}
    sms, holds = channel_ops._grind_shape(torch.device("cuda", 0))
    for per_sm, k in SWEEP:
        if per_sm > holds:
            continue
        plan = channel_ops.GrindPlan(sms * per_sm, channel_ops.GRIND_THREADS, k)
        out = []
        for what, st, want in cases:
            rows = st.view(-1, 9)

            def call():
                best = channel_ops.grind_buffer(rows.shape[0], st.device)
                channel_ops.grind_launch(rows, POW_BITS, best, plan)  # noqa: B023
                return best[:-1]
            got = nonces_of(call())
            if got != want:
                raise SystemExit(f"torch_grind_times: {name} plan {plan}: {what}: nonces {got} != plain {want}")
            ms = device_ms(call, reps=5)
            out.append(f"{what} {ms:.4f} ms ({profiling().grind_bound(want)[0] / ms:.3f})")
        print(f"[grind] {name}: plan {plan.blocks} blocks, k {k}, W {plan.width}{defaults.get(plan, '')}: "
              + "; ".join(out),
              flush=True)


def run_cases(name: str, preset_only: bool) -> None:
    from frieda_tpu_torch.ops import channel as channel_ops
    from frieda_tpu_torch.utils.convert import from_numpy_u32

    dev = torch.device("cuda", 0)
    g = Launcher()
    rng = np.random.default_rng(SEED)
    one = channel_ops.new_state(dev)
    channel_ops.transcript(one, mix_u64=SEED + POW_BITS)
    batch = channel_ops.new_state(dev, 8)
    channel_ops.transcript(batch, mix_u64=from_numpy_u32(rng.integers(0, 1 << 32, (8, 2), dtype=np.uint64)
                                                           .astype(np.uint32), dev))
    want_one = nonces_of(channel_ops.grind_plain(one, POW_BITS))
    want = nonces_of(channel_ops.grind_plain(batch, POW_BITS))
    print(f"[grind] {name}: nonces: one {want_one}, batch {want} (sum {sum(want)})", flush=True)
    for line in build_registers():
        print(f"[grind] {name}: {line}", flush=True)
    print(f"[grind] {name}: grid, one blob: {g.grid(1)}; 8 blobs: {g.grid(8)}", flush=True)

    def check(got, expect, what):
        if got != expect:
            raise SystemExit(f"torch_grind_times: {name} {what}: nonces {got} != plain {expect}")

    if not preset_only:
        check(nonces_of(g.fresh(one, POW_BITS)), want_one, "one")
        check(nonces_of(g.fresh(batch, POW_BITS)), want, "batch")
        check([nonces_of(g.fresh(batch[b], POW_BITS))[0] for b in range(8)], want, "batch's singles")
        ms = device_ms(lambda: g.fresh(one, POW_BITS))
        print(f"[grind] {name}: one, fresh: {graded(ms, want_one)}", flush=True)
        ms = device_ms(lambda: g.fresh(batch, POW_BITS), reps=5)
        print(f"[grind] {name}: batch of 8, one launch, fresh: {graded(ms, want)}", flush=True)
        ms = device_ms(lambda: [g.fresh(batch[b], POW_BITS) for b in range(8)], reps=5)
        print(f"[grind] {name}: batch as 8 one-channel launches, fresh: {graded(ms, want)}", flush=True)
        each = [device_ms(lambda: g.fresh(batch[b], POW_BITS)) for b in range(8)]  # noqa: B023
        print(f"[grind] {name}: each channel alone, fresh: " + "; ".join(
            f"{n}: {ms:.4f} ms ({profiling().grind_bound(n)[0] / ms:.3f})" for n, ms in zip(want, each)), flush=True)
        print(f"[grind] {name}: clocks, batch of 8 fresh: {clocks_beside(lambda: g.fresh(batch, POW_BITS))}", flush=True)
        print(f"[grind] {name}: clocks, one fresh: {clocks_beside(lambda: g.fresh(one, POW_BITS))}", flush=True)
    one_p = g.preset(one, POW_BITS, [want_one[0] + 1])
    batch_p = g.preset(batch, POW_BITS, [n + 1 for n in want])
    each_p = [g.preset(batch[b], POW_BITS, [n + 1]) for b, n in enumerate(want)]
    check(nonces_of(one_p()), want_one, "one preset")
    check(nonces_of(batch_p()), want, "batch preset")
    check([nonces_of(f())[0] for f in each_p], want, "batch's singles preset")
    ms = device_ms(one_p)
    print(f"[grind] {name}: one, preset: {graded(ms, want_one)}", flush=True)
    ms = device_ms(batch_p, reps=5)
    print(f"[grind] {name}: batch of 8, one launch, preset: {graded(ms, want)}", flush=True)
    ms = device_ms(lambda: [f() for f in each_p], reps=5)
    print(f"[grind] {name}: batch as 8 one-channel launches, preset: {graded(ms, want)}", flush=True)
    each = [device_ms(f) for f in each_p]
    print(f"[grind] {name}: each channel alone, preset: " + "; ".join(
        f"{n}: {ms:.4f} ms ({profiling().grind_bound(n)[0] / ms:.3f})" for n, ms in zip(want, each)), flush=True)
    if not preset_only:
        many = channel_ops.new_state(dev, 64)
        channel_ops.transcript(many, mix_u64=from_numpy_u32(rng.integers(0, 1 << 32, (64, 2), dtype=np.uint64)
                                                              .astype(np.uint32), dev))
        want64 = nonces_of(channel_ops.grind_plain(many, POW_BITS))
        check(nonces_of(g.fresh(many, POW_BITS)), want64, "64 blobs")
        ms = device_ms(lambda: g.fresh(many, POW_BITS), reps=3)
        print(f"[grind] {name}: 64 blobs (nonces summing to {sum(want64)}, the largest {max(want64)}), one launch, "
              f"fresh: {graded(ms, want64)}", flush=True)
        if g.planned:
            sweep_plans(name, (("one", one, want_one), ("8 blobs", batch, want), ("64 blobs", many, want64)))
    for blobs, st in ((1, one), (8, batch)):
        times = []
        for log_n in PROBE_LOGS:
            n = 1 << log_n
            probe = g.preset(st, 128, [n] * blobs)
            check(nonces_of(probe()), [n] * blobs, f"probe 2^{log_n} x {blobs}")
            times.append(device_ms(probe, reps=5))
        xs = [blobs * (1 << log_n) for log_n in PROBE_LOGS]
        slope, icpt = np.polyfit(xs, times, 1)
        print(f"[grind] {name}: probe, {blobs} blob(s), nonces [0, N) hashed, no hit: " + "; ".join(
            f"N 2^{log_n} {ms:.4f} ms" for log_n, ms in zip(PROBE_LOGS, times))
            + f"; fit {icpt:.4f} ms + {1 / slope / 1e6:.2f} G nonces/s "
            f"({profiling().grind_bound([x - 1 for x in xs[-1:]])[0] / times[-1]:.3f} of the bound at the "
            f"largest N)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--compare")
    ap.add_argument("--name")
    ap.add_argument("--preset-only", action="store_true")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    if args.ablate or args.compare:
        if args.compare:
            roots = [pathlib.Path(args.compare).resolve(), REPO]
        else:
            roots = [root] + package_copies(REPO / "build" / "grind_variants", PARENT_ABLATIONS, checkout=root)
        names = {r: r.name if r not in (REPO, root) or args.compare else "as is" for r in roots}
        if not build_all(roots):
            return 1
        return in_turns(roots, lambda r: [sys.executable, __file__, "--root", str(r), "--name", names[r]]
                        + (["--preset-only"] if r.name in PRESET_ONLY else []))
    sys.path.insert(0, str(root))
    if not torch.cuda.is_available():
        print("torch_grind_times: CUDA is not available", file=sys.stderr)
        return 1
    print(f"[grind] root {root}; card {card()}", flush=True)
    run_cases(args.name or root.name, args.preset_only)
    return 0


if __name__ == "__main__":
    sys.exit(main())
