"""The deployment `frida-4844-r2` (`portbench/configs/frida-4844-r2.json`: an
Ethereum block of blobs, each its own polynomial, proved at log_blowup 1,
last-layer bound 0 and 70 queries, the block in one call) through its path,
`parallel/sharding.prove_many_sharded` on a one-device CPU mesh (one
batched commit phase on every kernel's plain version, then a finish a
blob), at B = 1, 2, 3 and 9 blobs of 960 bytes and 1 and 9 of 4,096: the
roots and wire bytes against the benchmark's plain reference
(`portbench/reference/fri.prove`) and a loop of `api.commit_and_prove`;
`verify`, and a proof with a changed byte rejected; the grind counter
(`fri.grind_totals`) against the proofs' nonces; the span `batch/finish`
once a dispatch. The call's two dispatches (ceil(B/2) and floor(B/2)
blobs) come before its first finish, in the recorded order of
`fri.dispatch_blobs` and `fri.finish_proof` (`fri.prove_block`, the
one-card block pipeline), and `fri.pipeline_counts` counts them; past a
stubbed `safe_batch` the dispatches of half the share, at most two in
flight, still give the reference's bytes.

The proof of work is 8 bits here, not the configuration's 26: a 26-bit
search takes ~2^26 compressions a blob, minutes on the CPU. Every other
field of the protocol is the file's. Inputs are seeded; tolerance: exact
equality of roots, wire bytes and counts."""

import pytest

pytest.importorskip("torch")

import json  # noqa: E402
import pathlib  # noqa: E402

import torch  # noqa: E402

from chip_smoke import synthetic_data  # noqa: E402
from frieda_tpu_torch import api  # noqa: E402
from frieda_tpu_torch.config import FriConfig, PcsConfig  # noqa: E402
from frieda_tpu_torch.core import fri  # noqa: E402
from frieda_tpu_torch.core.proof import Proof  # noqa: E402
from frieda_tpu_torch.parallel import sharding  # noqa: E402
from frieda_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from frieda_tpu_torch.utils import profiling  # noqa: E402
from portbench.reference import fri as ref  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "portbench" / "configs" / "frida-4844-r2.json").read_text())
POW_BITS = 8  # the file's 26 would take minutes a blob on the CPU
FRI = CONFIG["pcs_config"]["fri_config"]
CFG = PcsConfig(POW_BITS, FriConfig(**FRI))
PROTO = ref.Protocol.from_config({**FRI, "pow_bits": POW_BITS})
BLOCK = 9
SIZES = (960, 4096)
# seeds of the full 64-bit range, as the benchmark draws them
SEEDS = [(0x9E3779B97F4A7C15 * (k + 1)) % (1 << 64) for k in range(BLOCK)]
LOOPED = 2  # blobs of each size also proved one by one
ROOT_BYTE = 40  # a byte of layer 0's root in the wire encoding (after the 33-byte header)


def test_the_file_states_the_deployment_s_protocol():
    assert CONFIG["blob_bytes"] == 131072 and CONFIG["reduced"] == []
    assert CONFIG["pcs_config"] == {"pow_bits": 26, "fri_config": {"log_blowup_factor": 1,
                                                                   "log_last_layer_degree_bound": 0,
                                                                   "n_queries": 70}}
    log_size = ref.log_total_for(CONFIG["blob_bytes"]) - 2
    assert CONFIG["shape"] == {"felts": 1 << (log_size + 2), "log_size": log_size,
                               "domain_log_size": log_size + 1, "fri_layers": log_size}


def blobs(size: int) -> list:
    return [synthetic_data(size, 100 + k) for k in range(BLOCK)]


@pytest.fixture(scope="module")
def want() -> dict:
    """{size: (the reference's [(root, wire)] of the block's blobs, a loop of
    commit_and_prove's of the first LOOPED)}."""
    out = {}
    for size in SIZES:
        datas = blobs(size)
        looped = [api.commit_and_prove(d, s, CFG, device="cpu") for d, s in zip(datas[:LOOPED], SEEDS)]
        out[size] = (ref.prove(datas, SEEDS, PROTO, "cpu"), [(r, p.to_bytes()) for r, p in looped])
    return out


def halves(count: int) -> list:
    """The blob counts of a call's dispatches: ceil(count/2), floor(count/2)."""
    return [n for n in ((count + 1) // 2, count // 2) if n]


@pytest.mark.parametrize("size, count", [(960, 1), (960, 2), (960, 3), (960, BLOCK), (4096, 1), (4096, BLOCK)])
def test_a_block_is_one_batch_equal_to_the_reference(want, monkeypatch, size, count):
    calls, inner = [], fri.dispatch_blobs

    def counted(datas, *args, **kwargs):
        calls.append(len(datas))
        return inner(datas, *args, **kwargs)

    monkeypatch.setattr(fri, "dispatch_blobs", counted)
    fri.reset_grind_totals()
    profiling.reset_span_totals()
    out = sharding.prove_many_sharded(blobs(size)[:count], SEEDS[:count], CFG, Mesh(1, 1, ["cpu"]))
    assert calls == halves(count)  # two batched dispatches (one for one blob), not a replay a blob
    got = [(root, proof.to_bytes()) for root, proof in out]
    reference, looped = want[size]
    assert got == reference[:count]
    assert got[:LOOPED] == looped[:count]
    nonces = [proof.proof_of_work for _, proof in out]
    assert fri.grind_totals() == (count, sum(n + 1 for n in nonces))
    assert profiling.span_totals()["batch/finish"].count == len(calls)
    for (root, proof), seed in zip(out, SEEDS):
        assert proof.first_layer_commitment == root and api.verify(proof, seed)
    wire = bytearray(got[-1][1])
    assert wire[33 : 65] == got[-1][0]
    wire[ROOT_BYTE] ^= 1
    assert api.verify(Proof.from_bytes(bytes(wire)), SEEDS[count - 1]) is False


def test_a_batch_past_the_device_s_share_finishes_once_a_dispatch(monkeypatch):
    """Past `safe_batch` (2) a block runs as dispatches of half the share
    (1 blob): one `batch/finish` span each, and the counter counts every
    proof."""
    monkeypatch.setattr(fri, "safe_batch", lambda *args: 2)
    datas = [synthetic_data(64, k) for k in range(3)]
    fri.reset_grind_totals()
    profiling.reset_span_totals()
    out = sharding.prove_many_sharded(datas, SEEDS[:3], CFG, Mesh(1, 1, ["cpu"]))
    assert [(r, p.to_bytes()) for r, p in out] == ref.prove(datas, SEEDS[:3], PROTO, "cpu")
    assert profiling.span_totals()["batch/finish"].count == 3
    assert fri.grind_totals() == (3, sum(p.proof_of_work + 1 for _, p in out))
    fri.reset_grind_totals()
    assert fri.grind_totals() == (0, 0)


def test_a_single_blob_proof_counts_its_grind_without_the_batch_span():
    """`commit_and_prove` (the single-blob path) counts its nonce too, and
    runs no `batch/finish` span."""
    fri.reset_grind_totals()
    profiling.reset_span_totals()
    _, proof = api.commit_and_prove(synthetic_data(64, 1), SEEDS[0], CFG, device="cpu")
    assert fri.grind_totals() == (1, proof.proof_of_work + 1)
    assert "batch/finish" not in profiling.span_totals()


def recorded(monkeypatch) -> list:
    """("dispatch", blobs) of every `fri.dispatch_blobs` and ("finish", row)
    of every `fri.finish_proof` from now on, in call order."""
    events, dispatch, finish = [], fri.dispatch_blobs, fri.finish_proof

    def dispatched(datas, *args, **kwargs):
        events.append(("dispatch", len(datas)))
        return dispatch(datas, *args, **kwargs)

    def finished(committed, *args, **kwargs):
        events.append(("finish", committed.batch[1]))
        return finish(committed, *args, **kwargs)

    monkeypatch.setattr(fri, "dispatch_blobs", dispatched)
    monkeypatch.setattr(fri, "finish_proof", finished)
    return events


@pytest.mark.parametrize("count, counts", [(1, (1, 1, 0)), (2, (1, 2, 1)), (BLOCK, (1, 2, 5))])
def test_both_dispatches_come_before_the_first_finish(want, monkeypatch, count, counts):
    """A call's dispatches (one for one blob; 5 + 4 for a block) are all
    enqueued before its first finish, the finishes follow in row order, and
    `pipeline_counts` counts one call, its dispatches and the first
    dispatch's finishes as overlapped."""
    events = recorded(monkeypatch)
    fri.reset_pipeline_counts()
    out = sharding.prove_many_sharded(blobs(960)[:count], SEEDS[:count], CFG, Mesh(1, 1, ["cpu"]))
    sizes = halves(count)
    assert events == [("dispatch", n) for n in sizes] + [("finish", b) for n in sizes for b in range(n)]
    assert [(r, p.to_bytes()) for r, p in out] == want[960][0][:count]
    assert fri.pipeline_counts() == dict(zip(("calls", "dispatches", "overlapped"), counts))
    fri.reset_pipeline_counts()
    assert fri.pipeline_counts() == {"calls": 0, "dispatches": 0, "overlapped": 0}


@pytest.mark.parametrize("safe", [1, 2, 4])
def test_past_the_device_s_share_at_most_the_share_is_in_flight(monkeypatch, safe):
    """Five blobs past a stubbed `safe_batch`: dispatches of max(1, safe //
    2) blobs, at most two in flight (one at a share of one blob), so the
    blobs dispatched and not yet finished never exceed the share; each
    finish of a dispatch that a later one overlapped is counted; the bytes
    equal the reference's."""
    monkeypatch.setattr(fri, "safe_batch", lambda *args: safe)
    events = recorded(monkeypatch)
    datas = [synthetic_data(64, k) for k in range(5)]
    fri.reset_pipeline_counts()
    out = sharding.prove_many_sharded(datas, SEEDS[:5], CFG, Mesh(1, 1, ["cpu"]))
    assert [(r, p.to_bytes()) for r, p in out] == ref.prove(datas, SEEDS[:5], PROTO, "cpu")
    size = max(1, safe // 2)
    sizes = [n for kind, n in events if kind == "dispatch"]
    assert sizes == [min(size, 5 - i) for i in range(0, 5, size)]
    held = most = 0  # blobs dispatched and not yet finished
    for kind, n in events:
        held += n if kind == "dispatch" else -1
        most = max(most, held)
    assert most <= safe and held == 0
    overlapped = 0 if safe == 1 else 5 - sizes[-1]  # every finish but the last dispatch's, two in flight
    assert fri.pipeline_counts() == {"calls": 1, "dispatches": len(sizes), "overlapped": overlapped}
