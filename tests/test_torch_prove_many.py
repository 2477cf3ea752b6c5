"""Port's pipelined batch prover (`frieda_tpu_torch.api.prove_many`,
device="cpu": every kernel's plain version) against a loop of its
`commit_and_prove` and the frozen wire bytes, its window (the order of
commit phases and decommitments, the clamp), and `verify_many` on its proofs
against loops of both packages' `verify` (tests/test_proof.py:175-244's
shapes: 512-byte blobs, FriConfig(2, 0, 8), pow_bits 4). Tolerance: exact
equality of bytes and verdicts."""

import pytest

pytest.importorskip("torch")

import copy  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402

import torch  # noqa: E402

from chip_smoke import synthetic_data  # noqa: E402
from frieda_tpu import api as japi  # noqa: E402
from frieda_tpu.core.proof import Proof as JProof  # noqa: E402
from frieda_tpu_torch import api  # noqa: E402
from frieda_tpu_torch.config import FriConfig, PcsConfig  # noqa: E402
from frieda_tpu_torch.core import fri  # noqa: E402

torch.set_num_threads(1)

CASES = json.loads((pathlib.Path(__file__).parent / "data" / "frozen_proofs.json").read_text())
BY_NAME = {c["name"]: c for c in CASES}
CFG = PcsConfig(pow_bits=4, fri_config=FriConfig(2, 0, 8))
DATAS = [bytes((i * k + 3) % 256 for i in range(512)) for k in (7, 11, 13)]
SEEDS = [1, 2, None]


@pytest.fixture(scope="module")
def looped():
    return [api.commit_and_prove(d, s, CFG, device="cpu") for d, s in zip(DATAS, SEEDS)]


def wires(batch):
    return [(c, p.to_bytes()) for c, p in batch]


@pytest.mark.parametrize("window", [None, 1, 2, 3])
def test_prove_many_equals_loop(looped, window):
    batch = api.prove_many(DATAS, SEEDS, CFG, max_in_flight=window, device="cpu")
    assert wires(batch) == wires(looped)
    for s, (c, p) in zip(SEEDS, batch):
        assert c == p.first_layer_commitment
        assert japi.verify(JProof.from_bytes(p.to_bytes()), s)


def test_prove_many_reproduces_frozen_wire_bytes():
    case = BY_NAME["dryrun_960B"]
    data = synthetic_data(case["data_len"], case["data_seed_offset"])
    batch = api.prove_many([data, data], [case["seed"]] * 2, PcsConfig.from_dict(case["config"]),
                           max_in_flight=1, device="cpu")
    for c, p in batch:
        assert c.hex() == case["commitment"]
        assert p.to_bytes().hex() == case["wire_hex"]


def test_window_orders_commit_phases_and_decommitments(monkeypatch):
    """With a window of 2, the third blob's commit phase waits for the first
    blob's decommitment (`frieda_tpu/core/fri.py:664-670`)."""
    events = []
    commit, finish = fri.commit_phase, fri.finish_proof

    def commit_rec(*args, **kwargs):
        c = commit(*args, **kwargs)
        events.append(("commit", c.roots[0]))
        return c

    def finish_rec(c, *args, **kwargs):
        events.append(("finish", c.roots[0]))
        return finish(c, *args, **kwargs)

    monkeypatch.setattr(fri, "commit_phase", commit_rec)
    monkeypatch.setattr(fri, "finish_proof", finish_rec)
    batch = api.prove_many(DATAS, SEEDS, CFG, max_in_flight=2, device="cpu")
    r = [c for c, _ in batch]
    assert events == [("commit", r[0]), ("commit", r[1]), ("finish", r[0]), ("commit", r[2]),
                      ("finish", r[1]), ("finish", r[2])]


def test_window_clamps_with_a_warning(monkeypatch, looped):
    """A request above the safe window is clamped, with a warning, and the
    proofs do not change (tests/test_proof.py:175-193 with the budget made
    small enough for 512-byte blobs)."""
    monkeypatch.setattr(fri, "device_memory_bytes", lambda device: 64 << 10)
    assert fri.safe_in_flight(8, CFG.fri_config, torch.device("cpu")) == 1
    with pytest.warns(UserWarning, match="clamping"):
        batch = api.prove_many(DATAS, SEEDS, CFG, max_in_flight=8, device="cpu")
    assert wires(batch) == wires(looped)


def test_safe_window_of_an_80_gib_card(monkeypatch):
    """60% of the card's memory less one proof's peak, over one `Committed`'s
    resident bytes: the default window is min(8, safe)."""
    monkeypatch.setattr(fri, "device_memory_bytes", lambda device: 80 << 30)
    cuda = torch.device("cuda")
    fc = FriConfig(4, 0, 20)
    for log_size, domain in ((20, 1 << 24), (22, 1 << 26), (26, 1 << 30)):
        want = max(1, (int(0.6 * (80 << 30)) - fri.ACTIVE_BYTES_PER_ELEMENT * domain)
                   // (fri.RESIDENT_BYTES_PER_ELEMENT * domain))
        assert fri.safe_in_flight(log_size, fc, cuda) == want
    assert fri.safe_in_flight(20, fc, cuda) > 8
    assert fri.safe_in_flight(26, fc, cuda) == 1  # a 2^30 domain: one proof at a time


def test_prove_many_edge_cases():
    assert api.prove_many([], [], CFG, device="cpu") == []
    with pytest.raises(ValueError, match="seeds"):
        api.prove_many(DATAS, SEEDS[:2], CFG, device="cpu")
    with pytest.raises(ValueError, match="at least 1"):
        api.prove_many(DATAS, SEEDS, CFG, max_in_flight=0, device="cpu")


def test_verify_many_on_prove_many_proofs_equals_loops(looped):
    """tests/test_proof.py:195-226: valid proofs, a proof of another shape, a
    tampered witness and a wrong seed in one batch. verify_many equals a loop
    of the port's verify and of the JAX package's."""
    proofs = [p for _, p in looped]
    data_big = bytes((i * 5 + 1) % 256 for i in range(4096))
    _, p_big = api.commit_and_prove(data_big, 9, CFG, device="cpu")
    p_bad = copy.deepcopy(proofs[1])
    layer = p_bad.proof.inner_layers[0]
    w0 = list(layer.fri_witness[0])
    w0[0] ^= 1
    layer.fri_witness[0] = tuple(w0)
    all_proofs = proofs + [p_big, p_bad, proofs[0]]
    all_seeds = SEEDS + [9, 2, 999]
    got = api.verify_many(all_proofs, all_seeds)
    assert got == [api.verify(p, s) for p, s in zip(all_proofs, all_seeds)]
    assert got == [japi.verify(JProof.from_bytes(p.to_bytes()), s) for p, s in zip(all_proofs, all_seeds)]
    assert got == [True, True, True, True, False, False]


def test_a_wrong_last_fold_is_rejected(monkeypatch):
    """A cheating prover: the fold into the last layer uses another alpha, so
    every tree and opening is honest and the last layer is of low degree, but
    it is not the fold the transcript asks for. Only the verifier's last-layer
    check can see it; both packages reject it, alone and in a batch."""
    fold_l = fri.fold_l
    last = 1 << (CFG.fri_config.log_blowup_factor + CFG.fri_config.log_last_layer_degree_bound)

    def cheating_fold(g, alpha, xs_inv):
        if g.shape[1] == 2 * last:
            alpha = ((alpha[0] + 1) % ((1 << 31) - 1),) + tuple(alpha[1:])
        return fold_l(g, alpha, xs_inv)

    monkeypatch.setattr(fri, "fold_l", cheating_fold)
    cheats = [p for _, p in api.prove_many(DATAS[:2], SEEDS[:2], CFG, device="cpu")]
    monkeypatch.undo()
    assert all(len(p.proof.inner_layers) > 0 for p in cheats)
    assert api.verify_many(cheats, SEEDS[:2]) == [False, False]
    for p, s in zip(cheats, SEEDS):
        assert api.verify(p, s) is False
        assert japi.verify(JProof.from_bytes(p.to_bytes()), s) is False
