"""The benchmark's metrics that read the port's own spans (`portbench/metrics/`),
on the CPU at a tiny size: a traced run of a cell of a tiny configuration,
written into a BENCHMARK.json of a temporary checkout as
`portbench/tests/test_harness.py` writes its cells, reports the request
metrics read from the traced window (`ingest/pin`, `ingest/copy`,
`assemble/select`) and the set-up metric read from `profiling.span_totals`
(`setup/tables`); the CPU builds no graph, so `setup_graph_s.prove` reports
nothing. Tolerance: exact keys; the values only positive (CPU times)."""

import json
import pathlib
import shutil
import time

import pytest

pytest.importorskip("torch")

from portbench import harness  # noqa: E402

from frieda_tpu_torch.core import fft, fri  # noqa: E402
from frieda_tpu_torch.utils import profiling  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CELL = "frida-2p24.prove"
# 64-byte blobs (a 2^6 domain) and few queries: a traced request of the
# plain versions takes a fraction of a second on the CPU, so the window
# holds the two requests a percentile needs
TINY = {
    "name": "tiny", "source": "a test size", "blob_bytes": 64,
    "pcs_config": {"pow_bits": 2, "fri_config": {"log_blowup_factor": 2, "log_last_layer_degree_bound": 0,
                                                 "n_queries": 3}},
    "assumed": [], "reduced": [],
}
WINDOW_S = 1.0
REQUEST_METRICS = ["ingest_pin_ms.prove", "ingest_copy_ms.prove", "ingest_copy_p95_ms.prove",
                   "assemble_select_ms.prove"]
SETUP_METRICS = ["setup_graph_s.prove", "setup_tables_s.prove"]


@pytest.fixture(scope="module")
def bench(tmp_path_factory) -> pathlib.Path:
    """A checkout-like root: the benchmark's files, and a cell `tiny.prove`
    of the tiny configuration under the `prove` mix, listed wherever
    frida-2p24.prove is."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "portbench", root / "portbench", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (root / "portbench" / "configs" / "tiny.json").write_text(json.dumps(TINY))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a test size", "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny.prove", "config": "tiny", "traffic": "prove", "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny.prove")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_the_cell_lists_the_span_metrics(bench):
    names = [m["name"] for m in harness.load_cell(bench, CELL).per_layer]
    assert set(REQUEST_METRICS + SETUP_METRICS) <= set(names)
    assert names[-6:] == REQUEST_METRICS + SETUP_METRICS  # appended after the accepted metrics


def test_a_traced_run_reads_the_port_s_own_spans(bench):
    fft._stage_twiddles_dev.clear()
    fri._fold_tables.clear()
    profiling.reset_span_totals()
    result = harness.run_cell(bench, "tiny.prove", 2**33 + 7, WINDOW_S, True, time.perf_counter(), device="cpu")
    assert result["correct"]
    metrics = result["metrics"]
    for name in REQUEST_METRICS + ["setup_tables_s.prove"]:
        assert metrics[name]["value"] > 0, name
    assert "setup_graph_s.prove" not in metrics  # the CPU captures no graph
    assert metrics["ingest_copy_p95_ms.prove"]["unit"] == "ms" and metrics["setup_tables_s.prove"]["unit"] == "s"
    # the ingest's steps lie inside `prove/ingest`, the selection inside `prove/assemble`
    assert metrics["ingest_pin_ms.prove"]["value"] + metrics["ingest_copy_ms.prove"]["value"] \
        <= metrics["ingest_ms.prove"]["value"]
    totals = profiling.span_totals()
    assert metrics["setup_tables_s.prove"]["value"] == totals["setup/tables"].seconds
    assert "setup/graph" not in totals


@pytest.mark.parametrize("name", SETUP_METRICS)
def test_a_set_up_metric_reads_nothing_without_the_table(bench, name, monkeypatch):
    """The benchmark's files also run over a program without the table (its
    parent): there the metric reports nothing and raises nothing."""
    read = harness.load_metric(bench, name)
    monkeypatch.delattr(profiling, "span_totals")
    assert read(None) is None
