"""Port's prover (`frieda_tpu_torch.api.commit_and_prove`, device="cpu": every
kernel's plain version) vs the JAX package's proofs: the frozen wire bytes,
fresh blobs and seeds at the frozen cases' shapes (the JAX side's compiled
programs are the ones tests/test_frozen_vectors.py builds), the anchors
chip_smoke.py checks on the card, and the JAX verifier's verdict on the
port's proofs. Tolerance: exact equality of the wire bytes."""

import pytest

pytest.importorskip("torch")

import hashlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402

import torch  # noqa: E402

from chip_smoke import PROVE_ANCHORS, plain_route, synthetic_data  # noqa: E402
from frieda_tpu import api as japi  # noqa: E402
from frieda_tpu.config import PcsConfig as JPcsConfig  # noqa: E402
from frieda_tpu.core.proof import Proof as JProof  # noqa: E402
from frieda_tpu_torch import api  # noqa: E402
from frieda_tpu_torch.config import PcsConfig  # noqa: E402
from frieda_tpu_torch.core import fri  # noqa: E402
from frieda_tpu_torch.core.proof import Proof  # noqa: E402
from frieda_tpu_torch.utils.convert import from_numpy_u32  # noqa: E402
from frieda_tpu_torch.utils.packing import log_total_for, pad_to_words  # noqa: E402

torch.set_num_threads(1)

CASES = json.loads((pathlib.Path(__file__).parent / "data" / "frozen_proofs.json").read_text())
BY_NAME = {c["name"]: c for c in CASES}


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_frozen_proof_wire_bytes(case):
    data = synthetic_data(case["data_len"], case["data_seed_offset"])
    cfg = PcsConfig.from_dict(case["config"])
    commitment, proof = api.commit_and_prove(data, case["seed"], cfg, device="cpu")
    wire = proof.to_bytes()
    assert commitment.hex() == case["commitment"]
    assert commitment == proof.first_layer_commitment
    assert len(wire) == case["wire_len"]
    assert hashlib.blake2s(wire).hexdigest() == case["wire_blake"]
    assert wire.hex() == case["wire_hex"]
    assert commitment == api.commit(data, cfg.fri_config.log_blowup_factor, device="cpu")


# (frozen case whose shape is reused, data offset, seed). The fused-tree
# shape is left to its frozen case: the JAX package's first trace of that
# shape takes tens of seconds on CPU.
FRESH = [("tiny_64B_default", 9, 5), ("dryrun_960B", 77, 123456789)]


@pytest.mark.parametrize("shape,offset,seed", FRESH, ids=[f[0] for f in FRESH])
def test_fresh_proof_matches_jax_and_verifies(shape, offset, seed):
    case = BY_NAME[shape]
    data = synthetic_data(case["data_len"], offset)
    jcom, jproof = japi.commit_and_prove(data, seed, JPcsConfig.from_dict(case["config"]))
    com, proof = api.commit_and_prove(data, seed, PcsConfig.from_dict(case["config"]), device="cpu")
    wire = proof.to_bytes()
    assert com == jcom
    assert wire == jproof.to_bytes()
    back = JProof.from_bytes(wire)
    assert japi.verify(back, seed)
    assert not japi.verify(back, seed + 1)


def test_generate_proof_and_staged_entry_give_the_same_proof():
    case = BY_NAME["dryrun_960B"]
    data = synthetic_data(case["data_len"], case["data_seed_offset"])
    cfg = PcsConfig.from_dict(case["config"])
    proof = api.generate_proof(data, case["seed"], cfg, device="cpu")
    log_total = log_total_for(len(data))
    words = from_numpy_u32(pad_to_words(data, log_total), "cpu")
    com, staged = api.commit_and_prove_staged(words, log_total, case["seed"], cfg)
    assert staged.to_bytes() == proof.to_bytes() == bytes.fromhex(case["wire_hex"])
    assert com.hex() == case["commitment"]


def test_plain_route_gives_the_same_proof_and_stage_stats():
    """chip_smoke.py's plain route through the same pipeline (on the card it
    is the yardstick of the kernel route), and the stage timer's keys."""
    case = BY_NAME["mid_4096B_lastlayer2"]
    data = synthetic_data(case["data_len"], case["data_seed_offset"])
    log_total = log_total_for(len(data))
    words = from_numpy_u32(pad_to_words(data, log_total), "cpu")
    stats = {}
    _, proof = fri.prove_words(words, log_total, case["seed"],
                               PcsConfig.from_dict(case["config"]), route=plain_route(), stats=stats)
    assert proof.to_bytes().hex() == case["wire_hex"]
    assert set(stats["stage_s"]) == {"lde_trees", "transcript", "folds", "grind", "decommit_plan",
                                     "decommit_open", "decommit_assemble"}
    assert stats["open_launches"] == 1


def test_proof_bytes_round_trip_through_both_packages():
    case = BY_NAME["mid_4096B_lastlayer2"]
    wire = bytes.fromhex(case["wire_hex"])
    proof = Proof.from_bytes(wire)
    assert proof.to_bytes() == wire
    assert Proof.from_dict(proof.to_dict()).to_bytes() == wire
    assert proof.to_dict() == JProof.from_bytes(wire).to_dict()
    assert PcsConfig.from_dict(JPcsConfig.from_dict(case["config"]).to_dict()) == proof.pcs_config
    with pytest.raises(ValueError):
        Proof.from_bytes(wire + b"\x00")


def test_config_unsatisfiable_raises():
    cfg = PcsConfig.from_dict({"pow_bits": 1, "fri_config": {
        "log_blowup_factor": 1, "log_last_layer_degree_bound": 5, "n_queries": 3}})
    with pytest.raises(ValueError, match="unsatisfiable"):
        api.commit_and_prove(b"abc", 1, cfg, device="cpu")


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.commit_and_prove(b"abc", 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.generate_proof(b"abc", 1)


@pytest.mark.slow
@pytest.mark.parametrize("anchor", PROVE_ANCHORS, ids=lambda a: a[0])
def test_prove_anchor_matches_jax(anchor):
    """The proofs chip_smoke.py matches on the card: pow_bits 20 and domains
    2^19 and 2^22, hence slow."""
    name, n_bytes, seed, cfg, commitment, blake = anchor
    data = synthetic_data(n_bytes)
    jcom, jproof = japi.commit_and_prove(data, seed, JPcsConfig.from_dict(cfg))
    assert jcom.hex() == commitment
    assert hashlib.blake2s(jproof.to_bytes()).hexdigest() == blake
    com, proof = api.commit_and_prove(data, seed, PcsConfig.from_dict(cfg), device="cpu")
    assert com.hex() == commitment
    assert proof.to_bytes() == jproof.to_bytes()
