"""The plain reference against the frozen proofs' wire bytes and the frozen
numpy commit oracle, on the CPU."""

import json
import pathlib

import numpy as np
import pytest
import torch

from portbench.reference import field, fri
from portbench.reference.channel import Channel
from portbench.tests.frozen_spec import commit as spec_commit

CASES = json.loads((pathlib.Path(__file__).parent / "data" / "frozen_proofs.json").read_text())


def _synth(n: int, offset: int) -> bytes:
    return ((np.arange(n, dtype=np.uint32) + offset) % 256).astype(np.uint8).tobytes()


def _proto(cfg: dict) -> fri.Protocol:
    return fri.Protocol.from_config({**cfg["fri_config"], "pow_bits": cfg["pow_bits"]})


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_frozen_proof_wire_bytes(case):
    data = _synth(case["data_len"], case["data_seed_offset"])
    (root, wire), = fri.prove([data], [case["seed"]], _proto(case["config"]), "cpu")
    assert root.hex() == case["commitment"]
    assert wire.hex() == case["wire_hex"]


@pytest.mark.parametrize("n_bytes,log_blowup", [(0, 1), (1, 4), (64, 2), (960, 4), (4096, 3), (30720, 1)])
def test_commit_equals_the_frozen_oracle(n_bytes, log_blowup):
    data = np.random.default_rng(n_bytes).bytes(n_bytes)
    assert fri.commit([data], log_blowup, "cpu") == [spec_commit.commit(data, log_blowup)]


def test_a_batch_equals_its_blobs_one_by_one():
    rng = np.random.default_rng(5)
    blobs = [rng.bytes(2000) for _ in range(3)]
    seeds = [3, 1 << 62, 77]
    proto = fri.Protocol(2, 1, 9, 4)
    assert fri.prove(blobs, seeds, proto, "cpu") == [fri.prove([b], [s], proto, "cpu")[0] for b, s in zip(blobs, seeds)]
    assert fri.commit(blobs, 2, "cpu") == [fri.commit([b], 2, "cpu")[0] for b in blobs]


def test_grind_finds_the_least_nonce():
    ch = Channel()
    ch.mix_u64(12345)
    nonce = fri.grind([ch.digest], 8, "cpu", chunk=64)[0]
    for k in range(nonce + 1):
        trial = Channel()
        trial.digest = ch.digest
        trial.mix_u64(k)
        assert (trial.trailing_zeros() >= 8) == (k == nonce)


@pytest.mark.parametrize("at,section", [(5, "nonce"), (-1, "evaluations"), (-16 * 12 - 8, "last_layer")])
def test_wire_sections_name_the_part_that_differs(at, section):
    case = CASES[2]  # 7 layers, 4 last-layer coefficients, 12 queries
    wire = bytes.fromhex(case["wire_hex"])
    parts = fri.wire_sections(wire)
    assert parts["layer_roots"][:32].hex() == case["commitment"]
    assert len(parts["layer_roots"]) == 32 * 7
    bad = bytearray(wire)
    bad[at] ^= 1
    other = fri.wire_sections(bytes(bad))
    assert [k for k in parts if parts[k] != other[k]] == [section]


def test_field_inverse():
    torch.manual_seed(0)
    x = torch.randint(1, field.P, (1000,), dtype=torch.int64)
    assert torch.equal(field.mul(x, field.inv(x)), torch.ones_like(x))
