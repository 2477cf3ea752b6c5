"""The benchmark of frieda_tpu_torch: one cell, one run, one result line.

A cell (`workloads` in BENCHMARK.json) names a configuration and a traffic
mix; both are data files, found by name:

  configuration  the file BENCHMARK.json gives: blob size, the
                 protocol's `pcs_config`, the guarantees it states
  mix            `portbench/mixes/<traffic>.json`: the entry a request
                 calls and the blobs a request
  entry          `portbench/entries/<entry>.py`: `PROVES` and
                 `make(cell, device)`, the call of the port's entry point
                 on a request's blobs and seeds, and `release()`
  metric         `portbench/metrics/<name>.py`, a function `read(run)`:
                 the number, or None where the run has nothing to read

A run: the card checked; the blob pool and the seeds made from --seed;
the cell's calls warmed up (set-up ends there; whether this run built the
kernels is reported beside it); a closed loop of requests,
one client, for --seconds (with --trace 1 a profiled stretch behind a
lead-in instead); the metrics; then, with the program's state freed, a
sample of the window's requests drawn from the seed is recomputed by the
plain reference (`portbench/reference`) and compared byte for byte. The
last line of standard output is one JSON object; the numbers compared are
the last lines of standard error too.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
import time

import numpy as np

from . import guard
from . import roofline as rl
from .reference import fri as ref

MIB = float(1 << 20)
STAMP_BYTES = 16
WARM_STAMP = 1 << 63  # warm-up requests stamp indices from here, apart from the window's
SEEDS = 1 << 16  # FRI seeds drawn a run; request k takes seed k mod SEEDS
POOL_REQUESTS = 2  # the pool holds two requests' blobs: back-to-back requests never send one buffer
WARMUP_REQUESTS = 3  # set-up calls at least this many requests ...
WARMUP_SECONDS = 2.0  # ... for at least this long: the rate still climbs for a second or two after the captures
LEAD_IN_REQUESTS = 2  # a traced run's requests before its window: a trace may lose its first records
TRACE_SECONDS = 4.0  # a traced run's window, at most: the trace is read in one pass after it
CHECK_MIB = 4  # the reference checks the fewest of the window's requests that hold this many MiB of blobs
REFERENCE_BLOBS = 16  # the reference computes at most this many blobs in one call


class NoCard(RuntimeError):
    """The run found fewer cards than its cell asks for."""


# ---------------------------------------------------------------------------
# The cell's files
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    entry: object  # the module portbench/entries/<mix's entry>.py
    end_to_end: list  # BENCHMARK.json's metric entries this cell reports
    per_layer: list

    @property
    def blobs(self) -> int:
        """Blobs a request."""
        return int(self.mix["blobs"])

    @property
    def pool(self) -> int:
        return POOL_REQUESTS * self.blobs

    @property
    def request_bytes(self) -> int:
        return self.blobs * int(self.config["blob_bytes"])

    @property
    def check_requests(self) -> int:
        """The requests of the window the reference checks: the fewest that
        hold CHECK_MIB of blob bytes, at least one."""
        return max(1, -(-CHECK_MIB * (1 << 20) // self.request_bytes))

    @property
    def proto(self) -> ref.Protocol:
        pcs = self.config["pcs_config"]
        return ref.Protocol.from_config({**pcs["fri_config"], "pow_bits": pcs["pow_bits"]})

    @property
    def proves(self) -> bool:
        return bool(self.entry.PROVES)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: pathlib.Path, workload: str) -> Cell:
    """The cell `workload` of root/BENCHMARK.json with its configuration, mix
    and metric entries. KeyError for a name it does not hold."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "portbench" / "mixes" / f"{w['traffic']}.json").read_text())
    return Cell(workload, int(w["chips"]), config, mix, _load(root / "portbench" / "entries" / f"{mix['entry']}.py"),
                [m for m in bench["end_to_end"] if _reports(m, workload)],
                [m for m in bench["per_layer"] if _reports(m, workload)])


def _load(path: pathlib.Path):
    """The module of a file of the benchmark, found by its name."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_metric(root: pathlib.Path, name: str):
    """The `read(run)` of portbench/metrics/<name>.py."""
    return _load(root / "portbench" / "metrics" / f"{name}.py").read


# ---------------------------------------------------------------------------
# Data from the seed
# ---------------------------------------------------------------------------

def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), stream]))


class Data:
    """The run's blob pool and FRI seeds, all from --seed. Request k sends
    pool blobs (k * blobs + j) mod pool, j < blobs, each with (k, j) stamped
    into its first 16 bytes, so no two requests send the same blob; it
    proves under seeds[(k * blobs + j) mod SEEDS]."""

    def __init__(self, seed: int, blob_bytes: int, pool: int, blobs: int):
        if blob_bytes < STAMP_BYTES:
            raise ValueError(f"blobs of {blob_bytes} bytes leave no room for the {STAMP_BYTES}-byte stamp")
        rng = _rng(seed, 0)
        self.pool = [bytearray(rng.bytes(blob_bytes)) for _ in range(pool)]
        self.seeds = [int(s) for s in rng.integers(0, 1 << 63, size=SEEDS, dtype=np.uint64)]
        self.blobs = blobs

    def _slots(self, k: int) -> list:
        return [(k * self.blobs + j) % len(self.pool) for j in range(self.blobs)]

    def stamp(self, k: int) -> list:
        """The pool blobs of request k, stamped in place."""
        out = []
        for j, slot in enumerate(self._slots(k)):
            blob = self.pool[slot]
            blob[:STAMP_BYTES] = k.to_bytes(8, "little") + j.to_bytes(8, "little")
            out.append(blob)
        return out

    def blob_copies(self, k: int) -> list:
        """Request k's blobs as bytes, the pool left as it is."""
        return [k.to_bytes(8, "little") + j.to_bytes(8, "little") + bytes(self.pool[slot][STAMP_BYTES:])
                for j, slot in enumerate(self._slots(k))]

    def request_seeds(self, k: int) -> list:
        return [self.seeds[(k * self.blobs + j) % SEEDS] for j in range(self.blobs)]


# ---------------------------------------------------------------------------
# The system under test
# ---------------------------------------------------------------------------

def pcs_config(cell: Cell):
    """The configuration's protocol as the port's PcsConfig (for entries)."""
    from frieda_tpu_torch.config import FriConfig, PcsConfig

    pcs = cell.config["pcs_config"]
    return PcsConfig(pcs["pow_bits"], FriConfig(**pcs["fri_config"]))


class System:
    """The port's entry point that the cell's entry file binds: called on a
    request's blobs and seeds, it gives [(root, proof or None)] a blob."""

    def __init__(self, cell: Cell, device: str):
        self.call, self.entry = cell.entry.make(cell, device), cell.entry

    def __call__(self, blobs: list, seeds: list) -> list:
        return self.call(blobs, seeds)

    def release(self) -> None:
        """Free what the program keeps on the card between calls."""
        self.entry.release()


class Reference:
    """The plain reference in the system's place: the same calls, computed by
    `portbench/reference` under `proto` (the configuration's protocol, or a
    control's)."""

    def __init__(self, cell: Cell, device: str, proto: ref.Protocol | None = None):
        self.proto, self.proves, self.device = proto or cell.proto, cell.proves, device

    def __call__(self, blobs: list, seeds: list) -> list:
        if not self.proves:
            return [(root, None) for root in ref.commit(blobs, self.proto.log_blowup_factor, self.device)]
        return ref.prove(blobs, seeds, self.proto, self.device)

    def release(self) -> None:
        pass


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    index: int
    t0: float
    t1: float
    n_bytes: int

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e3


@dataclasses.dataclass
class Run:
    """What a metric's `read` gets."""

    cell: Cell
    setup_s: float
    requests: list
    window_s: float
    trace: object = None  # trace.Trace of a --trace 1 run
    card: object = None  # roofline.Card of the run's card, None off a card in `roofline.CARDS`

    @property
    def blob_bytes(self) -> int:
        return int(self.cell.config["blob_bytes"])

    def mib_per_s(self) -> float:
        return sum(r.n_bytes for r in self.requests) / MIB / self.window_s

    def shapes(self) -> dict:
        """log_size, n (the domain), n_inner (line folds before the last
        layer) of one blob's proof."""
        p = self.cell.proto
        log_size = ref.log_total_for(self.blob_bytes) - 2
        n = log_size + p.log_blowup_factor
        return {"log_size": log_size, "n": n, "n_inner": n - 1 - p.log_last_layer_degree_bound - p.log_blowup_factor}

    def trace_blobs(self) -> int:
        return self.trace.requests * self.cell.blobs


class Sample:
    """A uniform sample of k of the window's requests and their outputs,
    drawn from the seed as the requests come (reservoir sampling), so a run
    keeps k requests' outputs and not the window's."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept, self.seen = k, _rng(seed, 1), [], 0

    def offer(self, request: Request, out) -> None:
        if len(self.kept) < self.k:
            self.kept.append((request, out))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = (request, out)
        self.seen += 1


def _closed_loop(system, data: Data, seconds: float, sample: Sample) -> tuple:
    """Requests 0, 1, ... back to back until one ends `seconds` after the
    loop opened, each offered to `sample`: ([Request], window seconds,
    failures)."""
    import torch

    requests, failed = [], 0
    t_open = time.perf_counter()
    k = 0
    while True:
        blobs = data.stamp(k)
        seeds = data.request_seeds(k)
        with torch.profiler.record_function("portbench/request"):
            t0 = time.perf_counter()
            try:
                out = system(blobs, seeds)
            except Exception as exc:  # a failed request is counted and the loop goes on
                print(f"request {k} failed: {exc!r}", file=sys.stderr)
                out, failed = None, failed + 1
            t1 = time.perf_counter()
        requests.append(Request(k, t0, t1, sum(len(b) for b in blobs)))
        sample.offer(requests[-1], out)
        k += 1
        if t1 - t_open >= seconds:
            return requests, t1 - t_open, failed


def window_log(requests: list, window_s: float) -> str:
    """One line for the log: the window's requests, their ms, and the rate
    in each quarter of the window (a rise or fall across it is a warm-up or
    a drift inside the window)."""
    ms = sorted(r.ms for r in requests)
    t_open = requests[0].t0
    quarters = [0.0] * 4
    for r in requests:
        quarters[min(3, int(4 * (r.t1 - t_open) / window_s))] += r.n_bytes / MIB
    return (f"window: {len(requests)} requests in {window_s:.3f} s; ms a request min {ms[0]:.3f} median "
            f"{ms[len(ms) // 2]:.3f} max {ms[-1]:.3f}; MiB/s by quarter of the window "
            f"{' '.join(f'{q / (window_s / 4):.1f}' for q in quarters)}")


def _device_info(device: str) -> dict:
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def _sync(device: str) -> None:
    import torch

    if device != "cpu":
        torch.cuda.synchronize()


def check_outputs(cell: Cell, data: Data, kept: list, reference) -> dict:
    """Recompute the kept requests ([(Request, outputs)]) with `reference`,
    REFERENCE_BLOBS blobs a call, and compare: {name: {"value", "limit",
    "of"}}. A blob whose output is missing counts as differing."""
    rows = []  # (blob copy, seed, what the program gave)
    for req, out in sorted(kept, key=lambda x: x[0].index):
        got = out or []
        rows += [(blob, seed, got[j] if j < len(got) else (None, None))
                 for j, (blob, seed) in enumerate(zip(data.blob_copies(req.index), data.request_seeds(req.index)))]
    roots_bad = proofs_bad = 0
    parts = {}
    for i in range(0, len(rows), REFERENCE_BLOBS):
        block = rows[i : i + REFERENCE_BLOBS]
        want = reference([b for b, _, _ in block], [s for _, s, _ in block])
        for (_, _, (g_root, g_proof)), (w_root, w_wire) in zip(block, want):
            roots_bad += g_root != w_root
            if cell.proves:
                g_wire = g_proof if g_proof is None or isinstance(g_proof, bytes) else g_proof.to_bytes()
                if g_wire != w_wire:
                    proofs_bad += 1
                    for part in ref_sections_differing(g_wire, w_wire):
                        parts[part] = parts.get(part, 0) + 1
    checks = {"roots_differing": {"value": roots_bad, "limit": 0, "of": len(rows)}}
    if cell.proves:
        checks["proofs_differing"] = {"value": proofs_bad, "limit": 0, "of": len(rows)}
    if parts:
        print(f"proof sections differing (blobs): {parts}", file=sys.stderr)
    return checks


def ref_sections_differing(got: bytes | None, want: bytes) -> list:
    """The sections of two proofs' wire bytes that differ (for the log)."""
    if got is None:
        return ["missing"]
    try:
        a, b = ref.wire_sections(got), ref.wire_sections(want)
    except (ValueError, IndexError):
        return ["unreadable"]
    return [k for k in b if a.get(k) != b[k]]


def run_cell(root: pathlib.Path, workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", system=None) -> dict:
    """One run of a cell: its result line as a dict. `device` "cuda" requires the
    cell's cards (NoCard otherwise); "cpu" runs the program's plain
    versions, for the tests. `system` replaces the port (the tests' faults,
    the control)."""
    import torch

    stages = [("python, torch and the harness", time.perf_counter())]  # set-up's stages, for the log
    cell = load_cell(root, workload)
    if device != "cpu" and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        raise NoCard(f"{workload} needs {cell.chips} CUDA card(s); found "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    readers = {m["name"]: load_metric(root, m["name"]) for m in (cell.per_layer if trace else cell.end_to_end)}
    libraries = set(_libraries(root))
    data = Data(seed, int(cell.config["blob_bytes"]), cell.pool, cell.blobs)
    stages.append(("the pool", time.perf_counter()))
    system = system or System(cell, device)
    stages.append(("the port's import", time.perf_counter()))
    sample = Sample(cell.check_requests, seed)
    # warm-up (the first calls build or load the kernels, capture graphs and build tables)
    t_warm, w = time.perf_counter(), 0
    while w < WARMUP_REQUESTS or time.perf_counter() - t_warm < WARMUP_SECONDS:
        system(data.stamp(WARM_STAMP + w), data.request_seeds(w))
        _sync(device)
        if w == 0:
            stages.append(("the first request", time.perf_counter()))
        w += 1
    stages.append((f"{w - 1} more warm-up requests", time.perf_counter()))
    built = sorted(str(p.relative_to(root)) for p in set(_libraries(root)) - libraries)
    if trace:
        from . import trace as tr

        tracer = tr.Tracer(device)
        with tracer:
            for w in range(LEAD_IN_REQUESTS):  # a trace may lose its first records
                system(data.stamp(WARM_STAMP + 1000 + w), data.request_seeds(w))
            _sync(device)
            setup_s = time.perf_counter() - t_start
            with torch.profiler.record_function(tr.WINDOW):
                requests, window_s, failed = _closed_loop(
                    system, data, min(seconds, TRACE_SECONDS), sample)
                _sync(device)
        run = Run(cell, setup_s, requests, window_s, tracer.read(len(requests)))
    else:
        setup_s = time.perf_counter() - t_start
        requests, window_s, failed = _closed_loop(system, data, seconds, sample)
        _sync(device)
        run = Run(cell, setup_s, requests, window_s)
    info = _device_info(device)
    if device != "cpu":
        run.card = rl.CARDS.get(info["kind"])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = readers[m["name"]](run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace:
        info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    system.release()
    del system
    _free(device)
    print(window_log(requests, window_s), file=sys.stderr)
    marks = [t_start] + [t for _, t in stages]
    print("set-up by stage: " + "; ".join(f"{name} {b - a:.3f} s" for (name, _), a, b in
                                          zip(stages, marks, marks[1:])), file=sys.stderr)
    print(f"set-up {setup_s:.3f} s; " + (f"it built {', '.join(built)}" if built else "every kernel library was built before this run"),
          file=sys.stderr)
    checks = check_outputs(cell, data, sample.kept, Reference(cell, device))
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": len(requests) * cell.blobs, "failed": failed * cell.blobs,
              "metrics": metrics, "device": info}
    if trace:
        result["breakdown"] = run.trace.breakdown()
    result["setup_built"] = built  # a run whose set-up built kernels: its setup_s is a compiling run's
    result["checks"] = checks  # last: the numbers compared, each with its limit
    return result


def _libraries(root: pathlib.Path) -> list:
    """The shared libraries built under the checkout's build/ directory."""
    build = root / "build"
    return list(build.rglob("*.so")) if build.is_dir() else []


def _free(device: str) -> None:
    import gc

    import torch

    gc.collect()
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def main(argv, t_start: float) -> int:
    import argparse

    p = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = pathlib.Path.cwd()
    found = guard.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded at start: {found}", file=sys.stderr)
        return 3
    try:
        result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    except NoCard as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 2
    found = guard.forbidden_loaded()
    if found:
        print(f"no result: forbidden modules loaded by the run: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name}: {c['value']} (limit {c['limit']}, of {c['of']} blobs compared)", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
