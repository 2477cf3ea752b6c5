"""The per-layer metrics of the block cell (`portbench/metrics/*.block9.py`)
on stand-in runs: a value where the program's span `batch/finish` and
counter `fri.grind_totals` are there, None (and no exception) where they
are not, as on a program without them; and, on the CPU at a tiny size, a
cell under the `block9` mix (the entry `prove_many_sharded` on a
one-device mesh): a request equal to the plain reference, and a traced
call whose finish span the metrics read. Tolerance: the roofline's arithmetic
to 1e-9 relative; CPU times only positive."""

import json
import pathlib
import shutil
import time
import types

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench import roofline  # noqa: E402
from portbench import trace as tr  # noqa: E402

from frieda_tpu_torch.core import fri  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CELL = "frida-4844-r2.block9"
METRICS = ["grind_roofline.block9", "finish_ms.block9", "idle_share.block9"]
H100 = roofline.CARDS["NVIDIA H100 80GB HBM3"]


def metric(name: str):
    return harness.load_metric(ROOT, name)


class StandInTrace:
    """What the metrics read of a `portbench/trace.Trace`."""

    def __init__(self, spans: dict, device: dict, requests: int, window_s: float, busy_s: float):
        self.spans, self.device, self.requests = spans, device, requests
        self.window_s, self.busy_s = window_s, busy_s

    def span_ms(self, name: str) -> list:
        return list(self.spans.get(name, []))

    def device_ms(self, *keys: str) -> float:
        return sum(ms for n, ms in self.device.items() if any(k in n for k in keys))


def stand_in(spans=None, device=None, requests=4, blobs=9, window_s=0.2, busy_s=0.15, card=H100):
    trace = StandInTrace(spans or {}, device or {}, requests, window_s, busy_s)
    return types.SimpleNamespace(trace=trace, card=card, trace_blobs=lambda: requests * blobs)


def test_the_cell_lists_the_three_metrics_and_reports_the_proof_metrics():
    cell = harness.load_cell(ROOT, CELL)
    assert [m["name"] for m in cell.per_layer] == METRICS
    assert [m["name"] for m in cell.end_to_end] == ["prove_mib_s", "prove_p95_ms", "setup_s"]
    assert cell.blobs == 9 and cell.proves and cell.chips == 1
    assert cell.request_bytes * cell.check_requests >= harness.CHECK_MIB << 20


def test_grind_roofline_reads_the_counter(monkeypatch):
    monkeypatch.setattr(fri, "grind_totals", lambda: fri.GrindTotal(proofs=18, nonces=18 * 3_000_000))
    run = stand_in(device={"grind_kernel": 40.0, "merkle_level_kernel": 99.0})
    least = 3_000_000 * 36 * roofline.BLAKE2S_COMPRESS_INSTR / H100.int_instr_s * 1e3
    assert metric("grind_roofline.block9")(run) == pytest.approx(100.0 * least / 40.0, rel=1e-9)


@pytest.mark.parametrize("case", ["no counter", "no proof counted", "no grind record", "no card"])
def test_grind_roofline_reads_nothing_without_its_inputs(monkeypatch, case):
    monkeypatch.setattr(fri, "grind_totals", lambda: fri.GrindTotal(proofs=2, nonces=5))
    run = stand_in(device={"grind_kernel": 1.0})
    if case == "no counter":
        monkeypatch.delattr(fri, "grind_totals")
    elif case == "no proof counted":
        monkeypatch.setattr(fri, "grind_totals", lambda: fri.GrindTotal(proofs=0, nonces=0))
    elif case == "no grind record":
        run = stand_in(device={"merkle_level_kernel": 1.0})
    else:
        run = stand_in(device={"grind_kernel": 1.0}, card=None)
    assert metric("grind_roofline.block9")(run) is None


def test_finish_ms_reads_the_span_a_request():
    run = stand_in(spans={"batch/finish": [30.0, 34.0, 29.0, 31.0], "prove/fetch_packed": [25.0] * 36})
    assert metric("finish_ms.block9")(run) == pytest.approx(31.0)
    assert metric("finish_ms.block9")(stand_in(spans={"prove/assemble": [1.0]})) is None


def test_idle_share_reads_the_trace():
    assert metric("idle_share.block9")(stand_in(window_s=0.2, busy_s=0.15)) == pytest.approx(25.0)
    assert metric("idle_share.block9")(stand_in(window_s=0.0, busy_s=0.0)) is None


# 64-byte blobs (a 2^5 domain at log_blowup 1) and few queries: a traced
# request of nine blobs on the plain versions takes a fraction of a second
TINY = {
    "name": "tiny-block", "source": "a test size", "blob_bytes": 64,
    "pcs_config": {"pow_bits": 2, "fri_config": {"log_blowup_factor": 1, "log_last_layer_degree_bound": 0,
                                                 "n_queries": 5}},
    "assumed": [], "reduced": [],
}


@pytest.fixture(scope="module")
def bench(tmp_path_factory) -> pathlib.Path:
    """A checkout-like root: the benchmark's files, and a cell
    `tiny-block.block9` of the tiny configuration under the `block9` mix,
    listed wherever the block cell is."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "portbench", root / "portbench", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (root / "portbench" / "configs" / "tiny-block.json").write_text(json.dumps(TINY))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-block", "source": "a test size",
                             "file": "portbench/configs/tiny-block.json", "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny-block.block9", "config": "tiny-block", "traffic": "block9",
                               "chips": 1, "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny-block.block9")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_the_entry_proves_a_block_as_the_reference_does(bench):
    cell = harness.load_cell(bench, "tiny-block.block9")
    data = harness.Data(2**33 + 11, cell.config["blob_bytes"], cell.pool, cell.blobs)
    out = harness.System(cell, "cpu")(data.stamp(0), data.request_seeds(0))
    kept = [(harness.Request(0, 0.0, 0.0, cell.request_bytes), out)]
    checks = harness.check_outputs(cell, data, kept, harness.Reference(cell, "cpu"))
    assert checks == {"roots_differing": {"value": 0, "limit": 0, "of": 9},
                      "proofs_differing": {"value": 0, "limit": 0, "of": 9}}


def test_a_trace_of_the_entry_reads_the_finish_span(bench):
    """The entry's call (two blobs, to keep the profiled call short) under
    the harness's tracer: the finish span of each of its two dispatches in
    the window, no device record."""
    cell = harness.load_cell(bench, "tiny-block.block9")
    system = harness.System(cell, "cpu")
    data = harness.Data(2**40 + 3, cell.config["blob_bytes"], cell.pool, 2)
    system(data.stamp(0), data.request_seeds(0))  # tables and the plain paths' first use, untraced
    tracer = tr.Tracer("cpu")
    with tracer:
        with torch.profiler.record_function(tr.WINDOW):
            system(data.stamp(1), data.request_seeds(1))
    run = harness.Run(cell, 0.0, [], 1.0, tracer.read(1))
    assert len(run.trace.span_ms("batch/finish")) == 2
    assert metric("finish_ms.block9")(run) == sum(run.trace.span_ms("batch/finish")) > 0
    assert metric("idle_share.block9")(run) == pytest.approx(100.0)  # no device records on the CPU
    assert metric("grind_roofline.block9")(run) is None  # no card to grade against
