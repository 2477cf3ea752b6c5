"""A traced run's records, read in one pass over the profiler's events.

The harness profiles a lead-in and then the counted window, a
`record_function` range named `WINDOW`: a trace may lose a varying prefix of
its device records, and the lead-in takes that loss. Only records inside the
window count. Device records are clipped to it; busy time is the union of
their intervals (records of back-to-back replays can overlap).
"""

from __future__ import annotations

import bisect
import collections
import warnings

WINDOW = "portbench/window"
TOP = 10


class Tracer:
    """torch.profiler over the host and, off the CPU, the card."""

    def __init__(self, device: str):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if device != "cpu":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        with warnings.catch_warnings():  # its note that events are kept per cycle: one cycle here
            warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
            return self.prof.__exit__(*exc)

    def read(self, requests: int) -> "Trace":
        import torch

        cpu, dev = [], []
        for e in self.prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((start, start + dur, e.name()))
            elif "/" in e.name():  # the program's and the harness's spans; not the aten ops
                cpu.append((start, start + dur, e.name()))
        # a span also leaves a device-side annotation of its name over its kernels: not an operation
        spans = {name for _, _, name in cpu}
        return Trace(cpu, [d for d in dev if d[2] not in spans], requests)


class Trace:
    def __init__(self, cpu: list, dev: list, requests: int):
        windows = [(s, e) for s, e, name in cpu if name == WINDOW]
        if len(windows) != 1:
            raise RuntimeError(f"expected one {WINDOW} range in the trace, found {len(windows)}")
        self.w0, self.w1 = windows[0]
        self.requests = requests
        self.spans = sorted((s, e, n) for s, e, n in cpu if n != WINDOW and s >= self.w0 and e <= self.w1)
        self.dev = sorted((max(s, self.w0), min(e, self.w1), n) for s, e, n in dev if e > self.w0 and s < self.w1)
        self.busy = self._union()

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def _union(self) -> list:
        out = []
        for s, e, _ in self.dev:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def span_ms(self, name: str) -> list:
        """Host ms of each span called `name` inside the window."""
        return [(e - s) / 1e6 for s, e, n in self.spans if n == name]

    def device_ms(self, *keys: str) -> float:
        """Summed ms of the device records whose names hold any of `keys`."""
        return sum(e - s for s, e, n in self.dev if any(k in n for k in keys)) / 1e6

    def _label(self, t: int, starts: list) -> str:
        """The innermost span that holds time t (the latest begun)."""
        i = bisect.bisect_right(starts, t)
        for s, e, n in reversed(self.spans[max(0, i - 64) : i]):
            if e > t:
                return n
        return "between requests"

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time on
        the device by the span the host was in, each the TOP largest, in
        seconds."""
        ops = collections.Counter()
        for s, e, n in self.dev:
            ops[n] += e - s
        gaps = collections.Counter()
        starts = [s for s, _, _ in self.spans]
        cuts = sorted({x for s, e, _ in self.spans for x in (s, e)})
        edges = [self.w0] + [x for iv in self.busy for x in iv] + [self.w1]
        for g0, g1 in zip(edges[0::2], edges[1::2]):  # each idle gap, split where the host's span changes
            inner = cuts[bisect.bisect_right(cuts, g0) : bisect.bisect_left(cuts, g1)]
            for a, b in zip([g0] + inner, inner + [g1]):
                gaps[self._label(a, starts)] += b - a
        return {"device_ops": [[n, t / 1e9] for n, t in ops.most_common(TOP)],
                "idle_gaps": [[n, t / 1e9] for n, t in gaps.most_common(TOP)]}
