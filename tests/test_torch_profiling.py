"""Port's `utils/profiling.py` against the JAX package's: the span names and
their order on commit, prove and verify (the JAX package run under
FRIEDA_SPANS=1 for commit and verify; its `span("...")` literals for the
prove, whose first trace costs seconds on the CPU), FRIEDA_SPANS parsing, a
span that never synchronizes, the roofline's counts (the JAX package's
hashes and butterflies) and each kernel bound at the shapes of PERF.md
section 6, on the named H100. Tolerance: exact names and counts; bounds
equal to the table's printed digits."""

import pytest

pytest.importorskip("torch")

import io  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import re  # noqa: E402

import torch  # noqa: E402

from frieda_tpu import api as japi  # noqa: E402
from frieda_tpu.core.proof import Proof as JProof  # noqa: E402
from frieda_tpu.utils import profiling as jprofiling  # noqa: E402
from frieda_tpu_torch import api  # noqa: E402
from frieda_tpu_torch.config import PcsConfig  # noqa: E402
from frieda_tpu_torch.core import fri  # noqa: E402
from frieda_tpu_torch.core.proof import Proof  # noqa: E402
from frieda_tpu_torch.parallel import sharding  # noqa: E402
from frieda_tpu_torch.utils import profiling  # noqa: E402
from frieda_tpu_torch.utils.packing import log_total_for, upload_words, words_for  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CASES = {c["name"]: c for c in json.loads((ROOT / "tests" / "data" / "frozen_proofs.json").read_text())}
H100 = "NVIDIA H100 80GB HBM3"
# The one name of the JAX package's that the port leaves out: it ends the
# tree on the card (ROADMAP C, deliberate differences).
NOT_PORTED = ["commit/host_tree_top"]
STAGES = {"lde_trees", "folds", "transcript", "grind", "decommit_gather", "decommit_assemble"}


def span_names(capsys) -> list:
    """The names of the `[span] name: x ms` lines printed to stderr so far."""
    return re.findall(r"^\[span\] (.+): [0-9.]+ ms$", capsys.readouterr().err, re.M)


def jax_prove_literals() -> list:
    """The JAX prover's and verifier's span names, in file order."""
    return re.findall(r'span\("([^"]+)"\)', (ROOT / "frieda_tpu" / "core" / "fri.py").read_text())


def synthetic(case) -> bytes:
    return bytes((i + case["data_seed_offset"]) % 256 for i in range(case["data_len"]))


@pytest.fixture
def spans_on(monkeypatch):
    monkeypatch.setenv("FRIEDA_SPANS", "1")


def test_commit_and_verify_spans_match_jax(spans_on, capsys):
    data = bytes((i * 31 + 64) % 256 for i in range(64))  # a shape tests/test_commit_jax.py traces
    capsys.readouterr()
    want_root = japi.commit(data, 1)
    jax_names = span_names(capsys)
    assert api.commit(data, 1, device="cpu") == want_root
    names = span_names(capsys)
    assert [n for n in jax_names if n not in names] == NOT_PORTED
    assert names == [n for n in jax_names if n not in NOT_PORTED]

    case = CASES["dryrun_960B"]
    wire = bytes.fromhex(case["wire_hex"])
    assert japi.verify(JProof.from_bytes(wire), case["seed"])
    jax_names = span_names(capsys)
    assert api.verify(Proof.from_bytes(wire), case["seed"])
    assert span_names(capsys) == jax_names == ["verify"]


def test_prove_spans_equal_the_jax_literals(spans_on, capsys):
    case = CASES["tiny_64B_default"]
    cfg, data = PcsConfig.from_dict(case["config"]), synthetic(case)
    literals = jax_prove_literals()
    assert literals[-1] == "verify"
    prove = literals[:-1]
    capsys.readouterr()
    _, proof = api.commit_and_prove(data, case["seed"], cfg, device="cpu")
    assert proof.to_bytes().hex() == case["wire_hex"] and api.verify(proof, case["seed"])
    assert span_names(capsys) == literals

    out = api.prove_many([data, data], [1, 2], cfg, device="cpu")  # both enqueued, then both finished
    assert span_names(capsys) == prove[:2] * 2 + prove[2:] * 2
    mesh = sharding.make_mesh(1, 2, devices=["cpu"] * 2)
    assert sharding.sharded_commit_and_prove(data, 1, cfg, mesh)[1].to_bytes() == out[0][1].to_bytes()
    assert span_names(capsys) == prove


def test_stage_clock_adds_a_span_a_stage(spans_on, capsys):
    case = CASES["dryrun_960B"]
    cfg, data = PcsConfig.from_dict(case["config"]), synthetic(case)
    log_total = log_total_for(len(data))
    words = upload_words([data], log_total, torch.device("cpu"))[1][0]
    stats = {}
    capsys.readouterr()
    fri.prove_words(words, log_total, case["seed"], cfg, stats=stats)
    names = span_names(capsys)
    assert set(names) == STAGES | set(jax_prove_literals()[1:-1]) and set(stats["stage_s"]) == STAGES
    fri.prove_words(words, log_total, case["seed"], cfg)
    assert span_names(capsys) == jax_prove_literals()[1:-1]


@pytest.mark.parametrize("value", [None, "", "0", "1"])
def test_spans_enabled_parses_like_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("FRIEDA_SPANS", raising=False)
    else:
        monkeypatch.setenv("FRIEDA_SPANS", value)
    assert profiling.spans_enabled() == jprofiling.spans_enabled() == (value == "1")


def test_a_span_never_synchronizes(monkeypatch):
    """A span on a CUDA build: an NVTX range and, while a profiler runs, a
    profiler range around its body, its wall printed, and no
    synchronization; the stage clock without `stats` neither synchronizes
    nor adds a span."""
    ranges = []

    def no_sync(*_):
        raise AssertionError("synchronized")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: ranges.append(("push", name)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: ranges.append(("pop",)))
    out = io.StringIO()
    with monkeypatch.context() as m:  # no profiler running: no profiler range either
        m.setattr(torch.profiler, "record_function", no_sync)
        with profiling.span("verify", out=io.StringIO()):
            pass
    ranges.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("prove/assemble", out=out):
            ranges.append(("body",))
        with fri._Clock(torch.device("cuda"), None)("lde_trees"):
            ranges.append(("body",))
    assert ranges == [("push", "prove/assemble"), ("body",), ("pop",), ("body",)]
    assert re.fullmatch(r"\[span\] prove/assemble: [0-9.]+ ms\n", out.getvalue())
    traced = [e.name for e in prof.events()]
    assert "prove/assemble" in traced and "lde_trees" not in traced


def test_ceilings_only_for_a_known_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.card_peaks() is None and profiling.hbm_gbps() is None
    assert profiling.int_instr_per_s() is None and profiling.fri_fold_bound(1 << 10) is None
    assert profiling.card_peaks("NVIDIA A100-SXM4-80GB") is None
    r = profiling.commit_roofline(24, 1e-3)
    assert r["sol_fraction"] is None and r["bound"] is None and r["hashes"] == 2 * (1 << 24) - 1
    assert profiling.hbm_gbps(H100) == 3350.0
    assert profiling.int_instr_per_s(H100) == 132 * 4 * 32 * 1.98e9


@pytest.mark.parametrize("log_domain", [10, 16, 22, 26])
def test_roofline_counts_match_jax(log_domain):
    s = 1.0
    assert profiling.merkle_roofline(log_domain, s)["hashes"] == jprofiling.merkle_roofline(log_domain, s)["hashes"]
    full = profiling.fft_roofline(log_domain, s, 4, log_l=log_domain)
    assert full["butterflies_per_s"] == jprofiling.fft_roofline(log_domain, s, 4, log_l=log_domain)["butterflies_per_s"]
    # the JAX package counts log_domain stages whatever log_l; the port the log_l it runs
    lde = profiling.fft_roofline(log_domain, s, 4)
    jlde = jprofiling.fft_roofline(log_domain, s, 4)
    assert lde["butterflies"] * log_domain == jlde["butterflies_per_s"] * s * (log_domain - 4)
    c = profiling.commit_roofline(log_domain, s)
    assert c["bytes_moved"] == 4 * words_for(log_domain - 2) + 32
    assert (c["butterflies"], c["hashes"]) == (lde["butterflies"], 2 * (1 << log_domain) - 1)


def test_merkle_open_bound_counts_each_read():
    # one value; a stored node (r 0), a node two levels above its stored base
    # (r 2), a node one level above the leaves (leaf, r 1)
    got = profiling.merkle_open_bound(1, [False, False, True], [0, 2, 1], card=H100)
    n_bytes = 8 * (2 + 9) + 32 + (32 + 128 + 32) + 3 * 32
    compressions = 0 + 3 + 3
    assert got == profiling.least_ms(n_bytes, compressions * profiling.BLAKE2S_COMPRESS_INSTR, H100)


def test_collapse_bound_with_the_channel_step():
    """The step adds the channel state read and written, alpha written, and
    2 dependent channel compressions."""
    got = profiling.merkle_collapse_bound(16, (2, 1), card=H100, step=True)
    n_bytes = 32 * (16 + 2 + 1) + 2 * profiling.CHANNEL_STATE_BYTES + 16
    assert got == profiling.least_ms(n_bytes, (15 + 2) * profiling.BLAKE2S_COMPRESS_INSTR, H100)
    assert profiling.merkle_collapse_bound(16, (2, 1), card=H100) == profiling.least_ms(
        32 * 19, 15 * profiling.BLAKE2S_COMPRESS_INSTR, H100)


def _bound(got) -> float:
    return got if isinstance(got, float) else got[0]


# (row of PERF.md section 6, its Bound column, the bound at that row's shape)
PERF_ROWS = [
    ("1", "0.0388", lambda: profiling.ingest_bound(words_for(24), 4 << 22, card=H100)),
    ("1b", "0.0097", lambda: profiling.ingest_bound(64 * words_for(16), 64 * 4 << 14, card=H100)),
    ("2-4", "0.1404", lambda: profiling.fft_pass_bound(4, 20, 24, card=H100)),
    ("2'", "0.0983", lambda: profiling.fft_pass_bound(256, 14, 18, card=H100)),
    ("5", "0.000118", lambda: profiling.merkle_level_bound(1 << 12, True, False, card=H100)),
    ("6", "0.000118", lambda: profiling.merkle_level_bound(1 << 13, False, False, card=H100)),
    ("5-6''", "0.9629", lambda: profiling.merkle_roofline(24, 1.0, top_log=6, store_levels=True,
                                                        card=H100)["min_seconds_at_sol"] * 1e3),
    ("7", "0.9027", lambda: profiling.merkle_level_bound(1 << 24, True, True, card=H100)),
    ("7'", "0.9027", lambda: profiling.merkle_level_bound(1 << 18, True, True, blobs=64, card=H100)),
    ("8", "0.2106", lambda: profiling.merkle_level_bound(1 << 23, False, True, card=H100)),
    ("9", "0.000118", lambda: profiling.merkle_collapse_bound(4096, (512, 64, 8, 1), card=H100)),
    ("9'", "0.0075", lambda: profiling.merkle_collapse_bound(4096, blobs=64, card=H100)),
    ("9s", "0.000118", lambda: profiling.merkle_collapse_bound(4096, (512, 64, 8, 1), card=H100, step=True)),
    ("10", "0.5208", lambda: profiling.fri_fold_bound(1 << 25, card=H100)),
    ("10'", "1.0417", lambda: sum(profiling.fri_fold_bound(1 << (25 - l), card=H100)[0] for l in range(22))),
    ("11", "5.7e-08", lambda: profiling.transcript_bound(32, 16, 2, card=H100)),
    ("12", "0.0426", lambda: profiling.grind_bound(1_484_602, card=H100)),
    ("13", "0.1603", lambda: profiling.fft_exchange_bound(1 << 25, card=H100)),
]


@pytest.mark.parametrize("row,table,bound", PERF_ROWS, ids=[r[0] for r in PERF_ROWS])
def test_kernel_bounds_equal_the_perf_table(row, table, bound):
    ms = _bound(bound())
    if "e" in table:
        assert f"{ms:.1e}" == table
    else:
        assert f"{ms:.{len(table.split('.')[1])}f}" == table
