"""Timers and before/after scaffolding shared by `chip_smoke.py` and
`tools/torch_kernel_times.py`. Imports nothing of `frieda_tpu_torch`, so a
tool can time another checkout's package with the same timers (and grade it
by this checkout's bounds: `profiling`).

- `cuda_ms`: CUDA events around one Python call (call time: the wrapper's
  host work while the card waits is in it);
- `device_ms`: CUDA events around a replayed CUDA graph of the calls (device
  time: the launches alone);
- `host_ms`: the host clock, synchronized at both ends;
- `clocks_beside`: nvidia-smi's SM clock, power and temperature sampled
  while a call runs back to back;
- `device_busy_us`: the device's busy time in a torch.profiler trace;
- `profiling`: this checkout's `frieda_tpu_torch/utils/profiling.py` (the
  kernels' bounds), loaded from its file;
- `package_copies` / `build_all` / `in_turns`: copy the package with its
  sources edited, build every copy's kernels at once, run a command against
  each checkout in turns (A B ... B A), one process each.
"""

from __future__ import annotations

import functools
import importlib.util
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]


def card(fields: str = "name,power.limit") -> str:
    """Card 0's name and power limit (or other `--query-gpu` fields), as
    nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={fields}",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip()


@functools.cache
def profiling():
    """This checkout's `frieda_tpu_torch/utils/profiling.py`, loaded from its
    file, so that a run over another checkout's package (an older commit
    without it) is graded by the same bounds."""
    spec = importlib.util.spec_from_file_location(
        "frieda_profiling", REPO / "frieda_tpu_torch" / "utils" / "profiling.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cuda_ms(fn, reps: int = 5) -> float:
    """Median ms of `reps` runs of fn, CUDA events around each, after a warm-up."""
    import torch

    fn()
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


def device_ms(fn, reps: int = 20) -> float:
    """Device ms of one call of fn: CUDA events around one replay of a CUDA
    graph that holds `reps` calls, divided by `reps`, median of 5 replays
    after a warm-up. The graph holds the launches and not the host's work
    around them (checks, allocations, ctypes); it does hold the gap between
    two of its kernels (chip_smoke phase 3 prints it: the m = 1 collapse)."""
    import torch

    fn()  # outside the capture: the first call loads the library and sets attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    graph.reset()
    return statistics.median(times)


def host_ms(fn, reps: int = 9) -> float:
    """Median ms of `reps` runs of fn on the host clock, synchronized at both ends."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def clocks_beside(fn, seconds: float = 0.4) -> str:
    """Run fn back to back for ~seconds (synchronizing every 10 calls) while
    `nvidia-smi --query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu`
    samples card 0 every 20 ms; returns the samples' min/median/max."""
    import torch

    smi = subprocess.Popen(["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
                            "--format=csv,noheader,nounits", "-lms", "20"], stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.15)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        time.sleep(0.05)
    finally:
        smi.terminate()
    rows = [[float(x) for x in line.split(",")] for line in smi.communicate()[0].splitlines()
            if line.count(",") == 3 and "N/A" not in line]
    if not rows:
        return "no nvidia-smi samples"
    cols = list(zip(*rows))

    def stat(c):
        return f"{min(c):g}/{statistics.median(c):g}/{max(c):g}"

    return (f"{len(rows)} nvidia-smi samples (the first ~0.15 s before the work): clocks.sm MHz min/median/max "
            f"{stat(cols[0])}, power.draw W {stat(cols[1])} of {cols[2][0]:g}, temperature C {stat(cols[3])}")


def device_busy_us(prof) -> tuple:
    """(us, records): the time the device's own records (kernels, copies,
    fills) cover in a finished `torch.profiler.profile`, the union of their
    intervals, and how many records there are, in one pass over the trace
    (`key_averages()` takes tens of seconds over the ~10^5 records of a batch
    of proofs). Overlapping records count once: the records of back-to-back
    kernels of graph replays can overlap, and their summed durations came
    out above the wall of a run that kept the card busy (`prove_many`)."""
    import torch

    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    busy, end = 0, None
    for start, stop in spans:
        if end is None or start >= end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy / 1e3, len(spans)


def proof_collapse_widths(collapse_max: int = 4096) -> list:
    """The level width at which each of the 22 trees of the 2^24-felt proof
    (2^26 ... 2^5 leaves) reaches the collapse: core/merkle.build_pruned
    fuses three levels a launch while the width is above collapse_max."""
    out = []
    for log_leaves in range(26, 4, -1):
        m = 1 << (log_leaves - 3)
        while m > collapse_max:
            m //= 8
        out.append(m)
    return out


def package_copies(out: pathlib.Path, variants, checkout: pathlib.Path = REPO) -> list:
    """Copy the package of `checkout` (this one by default) under
    `out/<name>/` for each (name, [(file in the package, text, replacement),
    ...]) of `variants`, with those edits made. Returns the copies' roots."""
    shutil.rmtree(out, ignore_errors=True)
    roots = []
    for name, edits in variants:
        pkg = out / name / "frieda_tpu_torch"
        shutil.copytree(checkout / "frieda_tpu_torch", pkg, ignore=shutil.ignore_patterns("__pycache__"))
        for rel, old, new in edits:
            src = (pkg / rel).read_text()
            if old not in src:
                raise SystemExit(f"{name}: {old!r} is not in frieda_tpu_torch/{rel}")
            (pkg / rel).write_text(src.replace(old, new))
        roots.append(out / name)
    return roots


def build_all(roots) -> bool:
    """Build the kernels of every checkout in `roots` at once; True if all built."""
    builds = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                                "from frieda_tpu_torch.ops import _build; _build.build()", str(r)])
              for r in roots]
    return not any([b.wait() for b in builds])


def in_turns(roots, command) -> int:
    """Run `command(root)` (an argv list) for each root, then again in the
    reverse order, one process each; nonzero if any run failed."""
    failed = 0
    for root in list(roots) + list(roots)[::-1]:
        failed |= subprocess.run(command(root)).returncode
    return failed
