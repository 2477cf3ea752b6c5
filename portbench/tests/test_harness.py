"""The harness on the CPU at a tiny size: cells found by name from data
files, the result line's keys, the import check, and `correct` false under
each fault a cell can have and under the control."""

import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys
import time

import pytest

from portbench import guard, harness
from portbench.reference import fri as ref

ROOT = pathlib.Path(__file__).resolve().parents[2]
TINY = {
    "name": "tiny", "source": "a test size", "blob_bytes": 960,
    "pcs_config": {"pow_bits": 6, "fri_config": {"log_blowup_factor": 2, "log_last_layer_degree_bound": 0,
                                                 "n_queries": 8}},
    "assumed": [], "reduced": [],
}
MIXES = sorted(p.stem for p in (ROOT / "portbench" / "mixes").glob("*.json"))
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "setup_built", "checks"]
# an entry point no cell of the repo calls, added by a file as a later cell would add it
COMMIT_MANY = '''"""api.commit_many: the request's blobs in one call."""
PROVES = False


def make(cell, device):
    from frieda_tpu_torch import api

    log_blowup = cell.config["pcs_config"]["fri_config"]["log_blowup_factor"]
    return lambda blobs, seeds: [(root, None) for root in api.commit_many(blobs, log_blowup, device=device)]


def release():
    pass
'''


def _bench(tmp_path: pathlib.Path, extra_metrics=()) -> pathlib.Path:
    """A checkout-like root: the benchmark's files, with a cell of the tiny
    configuration added to BENCHMARK.json for each mix, wherever the mix's
    cells of the repo are listed."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (tmp_path / "portbench" / "configs" / "tiny.json").write_text(json.dumps(TINY))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a test size", "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "tests"})
    traffic = {w["name"]: w["traffic"] for w in bench["workloads"]}
    bench["workloads"] += [{"name": f"tiny.{m}", "config": "tiny", "traffic": m, "chips": 1, "why": "tests"}
                           for m in MIXES]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += sorted({f"tiny.{traffic[w]}" for w in m["workloads"]})
    bench["per_layer"] += list(extra_metrics)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return _bench(tmp_path_factory.mktemp("bench"))


def _run(root, cell, trace=False, system=None, seed=2**33 + 5):
    return harness.run_cell(root, cell, seed, 0.3, trace, time.perf_counter(), device="cpu", system=system)


@pytest.mark.parametrize("mix", MIXES)
def test_the_program_is_correct_at_a_tiny_size(bench, mix):
    result = _run(bench, f"tiny.{mix}")
    assert list(result) == RESULT_KEYS
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) >= {"setup_s"}
    assert all(c["value"] == 0 and c["of"] > 0 for c in result["checks"].values())
    assert ("proofs_differing" in result["checks"]) == harness.load_cell(bench, f"tiny.{mix}").proves


def test_a_traced_run_reads_the_spans(bench):
    result = _run(bench, "tiny.prove", trace=True)
    assert list(result) == RESULT_KEYS[:5] + ["breakdown", "setup_built", "checks"]
    assert result["correct"]
    assert result["device"]["window_s"] > 0
    assert set(result["metrics"]) == {"ingest_ms.prove", "enqueue_ms.prove", "idle_share.prove"}  # no roofline off a card
    labels = [name for name, _ in result["breakdown"]["idle_gaps"]]
    assert labels and len(labels) <= 10


def _flip(root: bytes) -> bytes:
    return bytes([root[0] ^ 1]) + root[1:]


@pytest.mark.parametrize("part", ["nonce", "root"])
def test_an_answer_altered_where_it_is_produced_is_not_correct(bench, part, monkeypatch):
    from frieda_tpu_torch.core import fri

    finish = fri.finish_proof

    def altered(*args, **kw):
        root, proof = finish(*args, **kw)
        if part == "nonce":
            proof.proof_of_work += 1
            return root, proof
        return _flip(root), proof

    monkeypatch.setattr(fri, "finish_proof", altered)
    result = _run(bench, "tiny.prove")
    assert not result["correct"]
    assert result["checks"][{"nonce": "proofs_differing", "root": "roots_differing"}[part]]["value"] > 0


@pytest.mark.parametrize("mix", MIXES)
def test_the_control_is_not_correct(bench, mix):
    """The reference one blowup lower (rate 1/2 of the configuration's code,
    the step that would halve the work) in the program's place."""
    cell = harness.load_cell(bench, f"tiny.{mix}")
    low = dataclasses.replace(cell.proto, log_blowup_factor=cell.proto.log_blowup_factor - 1)
    result = _run(bench, f"tiny.{mix}", system=harness.Reference(cell, "cpu", low))
    assert not result["correct"]
    assert all(c["value"] == c["of"] > 0 for c in result["checks"].values())


@pytest.fixture(scope="module")
def new_cell(tmp_path_factory):
    """A configuration, a mix, an entry and a metric dropped in as new files,
    with entries in BENCHMARK.json: no file of the benchmark edited."""
    metric = {"name": "requests_seen.new", "unit": "requests", "better": "higher", "source": "program_counter",
              "layer": "api / host", "moves": "commit_mib_s", "workloads": ["tiny2.commit_pair"]}
    root = _bench(tmp_path_factory.mktemp("new"), [metric])
    pb = root / "portbench"
    (pb / "metrics" / "requests_seen.new.py").write_text("def read(run):\n    return float(run.trace.requests)\n")
    (pb / "metrics" / "commit_mib_s.py").write_text("def read(run):\n    return run.mib_per_s()\n")
    (pb / "entries" / "commit_many.py").write_text(COMMIT_MANY)
    (pb / "configs" / "tiny2.json").write_text(json.dumps({**TINY, "name": "tiny2", "blob_bytes": 2000}))
    (pb / "mixes" / "commit_pair.json").write_text(json.dumps(
        {"entry": "commit_many", "blobs": 2}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny2", "source": "x", "file": "portbench/configs/tiny2.json", "reduced": [],
                             "why": "tests"})
    bench["workloads"].append({"name": "tiny2.commit_pair", "config": "tiny2", "traffic": "commit_pair",
                               "chips": 1, "why": "tests"})
    bench["end_to_end"].append({"name": "commit_mib_s", "unit": "MiB/s", "better": "higher", "bound": 0.25,
                                "source": "host_clock", "workloads": ["tiny2.commit_pair"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_a_new_config_mix_entry_and_metric_are_found_by_name(new_cell):
    result = _run(new_cell, "tiny2.commit_pair")
    assert list(result) == RESULT_KEYS
    assert result["correct"] and set(result["metrics"]) == {"commit_mib_s", "setup_s"}
    checked = min(result["attempted"], 2 * harness.load_cell(new_cell, "tiny2.commit_pair").check_requests)
    assert result["attempted"] % 2 == 0 and result["checks"] == {"roots_differing": {"value": 0, "limit": 0, "of": checked}}
    traced = _run(new_cell, "tiny2.commit_pair", trace=True)
    assert traced["metrics"]["requests_seen.new"]["value"] > 0


def test_half_of_a_batch_left_out_is_not_correct(new_cell, monkeypatch):
    from frieda_tpu_torch.core import merkle

    real_many = merkle.root_bytes_many
    monkeypatch.setattr(merkle, "root_bytes_many", lambda tops: real_many(tops[: tops.shape[0] // 2]))
    result = _run(new_cell, "tiny2.commit_pair")
    assert not result["correct"] and result["checks"]["roots_differing"]["value"] > 0


def test_a_set_up_that_builds_a_library_says_so(bench):
    cell = harness.load_cell(bench, "tiny.prove")
    so = bench / "build" / "kernels" / "abc" / "lib.so"
    program = harness.System(cell, "cpu")
    call = program.call

    def building(blobs, seeds):
        so.parent.mkdir(parents=True, exist_ok=True)
        so.touch()
        return call(blobs, seeds)

    try:
        built = _run(bench, "tiny.prove", system=harness.System(cell, "cpu"))["setup_built"]
        program.call = building
        assert built == [] and _run(bench, "tiny.prove", system=program)["setup_built"] == ["build/kernels/abc/lib.so"]
        assert _run(bench, "tiny.prove")["setup_built"] == []
    finally:
        shutil.rmtree(bench / "build", ignore_errors=True)


def test_the_sample_holds_check_mib_of_blobs():
    cell = harness.Cell("x", 1, {"blob_bytes": 62914560}, {"blobs": 1}, None, [], [])
    assert harness.CHECK_MIB == 4 and cell.check_requests == 1 and cell.pool == 2
    cell.config["blob_bytes"] = 262146
    assert cell.check_requests == 16
    cell.mix["blobs"] = 64
    assert cell.check_requests == 1 and cell.pool == 128


def test_the_import_check_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["frieda_tpu_torch", "frieda_tpu_torch.api", "jaxtyping", "numpy"]) == []
    assert guard.forbidden_loaded(["jax.numpy", "frieda_tpu.core", "flax", "jaxlib"]) == [
        "flax", "frieda_tpu", "jax", "jaxlib"]


def test_the_harness_and_the_reference_load_no_jax():
    code = ("import sys, time, pathlib; sys.path.insert(0, '.'); from portbench import harness, guard, trace; "
            "from portbench.reference import fri; import frieda_tpu_torch.api; "
            "[harness.load_cell(pathlib.Path('.'), w) for w in %r]; print(guard.forbidden_loaded())" % CELLS)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.'); import portbench.reference.fri, portbench.roofline; "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('frieda')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_without_a_card_the_command_fails_and_prints_no_result(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_seeds_and_stamps_make_distinct_blobs():
    data = harness.Data(2**40 + 3, 64, 3, 3)
    blobs = [bytes(b) for k in range(4) for b in data.stamp(k)]
    assert len(set(blobs)) == len(blobs)
    assert data.blob_copies(2) == [bytes(b) for b in data.stamp(2)]
    assert harness.Data(2**40 + 3, 64, 3, 3).pool[0][16:] == data.pool[0][16:]
    assert data.request_seeds(1) != data.request_seeds(2)
    assert ref.log_total_for(62914560) == 24 and ref.log_total_for(262146) == 17


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_own_size(card, cell):
    from portbench import control

    reading = control.control(ROOT, cell, 2**31 + 11, card)
    assert not reading["correct"]
    assert all(c["value"] == c["of"] > 0 for c in reading["checks"].values())
