"""Port's verifier (`frieda_tpu_torch.api.verify` / `verify_many`, host code)
against the JAX package's (`frieda_tpu.api.verify`, numpy and its C++
runtime on CPU): the four frozen proofs read from their wire bytes into both
packages, the mutations of tests/test_proof.py and tests/test_fuzz_verify.py
applied to both, seeded byte mutations and truncations of a wire image, the
two reference faults the port does not copy (ROADMAP C.1, C.2), and the
verifier's helpers (`npfield`, the circle lookups, the native runtime and its
plain version). Tolerance: exact equality of verdicts, bytes and words."""

import pytest

pytest.importorskip("torch")

import copy  # noqa: E402
import ctypes  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from frieda_tpu import api as japi  # noqa: E402
from frieda_tpu.core import circle as jcircle  # noqa: E402
from frieda_tpu.core import fri as jfri  # noqa: E402
from frieda_tpu.core import merkle as jmerkle  # noqa: E402
from frieda_tpu.core import npfield as jnpfield  # noqa: E402
from frieda_tpu.core.proof import Proof as JProof  # noqa: E402
from frieda_tpu_torch import api, native  # noqa: E402
from frieda_tpu_torch.core import circle, fri, merkle, npfield  # noqa: E402
from frieda_tpu_torch.core.proof import Proof  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CASES = json.loads((ROOT / "tests" / "data" / "frozen_proofs.json").read_text())
BY_NAME = {c["name"]: c for c in CASES}
P = (1 << 31) - 1
RNG_SEED = 20261017


def both(case):
    """The case's proof parsed by each package: (port Proof, JAX Proof)."""
    wire = bytes.fromhex(case["wire_hex"])
    return Proof.from_bytes(wire), JProof.from_bytes(wire)


def outcome(verify, proof, seed):
    """verify's verdict, or "IndexError" for the reference's panic."""
    try:
        return verify(proof, seed)
    except IndexError:
        return "IndexError"


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_frozen_proofs_verify_in_both(case):
    proof, jproof = both(case)
    assert api.verify(proof, case["seed"]) is True
    assert japi.verify(jproof, case["seed"]) is True
    assert api.verify_many([proof], [case["seed"]]) == [True]


def _bump(f):
    a, b, c, d = f
    return ((a + 1) % P, b, c, d)


def _evals(fn):
    def mutate(p):
        p.evaluations = fn(list(p.evaluations))
    return mutate


def _swap01(e):
    e[0], e[1] = e[1], e[0]
    return e


def _first_witness(p):
    w = p.proof.first_layer.fri_witness
    w[0] = _bump(w[0])


def _first_hash(p):
    p.proof.first_layer.decommitment.hash_witness[0] = bytes(32)


def _first_hash_extra(p):
    p.proof.first_layer.decommitment.hash_witness.append(bytes(32))


def _inner_commitment(p):
    p.proof.inner_layers[0].commitment = bytes(32)


def _inner_commitment_type(p):
    p.proof.inner_layers[0].commitment = "deadbeef"


def _last_layer(p):
    p.proof.last_layer_poly[0] = _bump(p.proof.last_layer_poly[0])


# The mutations of tests/test_proof.py:58-143 and the structural corruptions
# of tests/test_fuzz_verify.py:78-117, applied alike to both packages' proofs.
MUTATIONS = {
    "pow_plus_1": lambda p: setattr(p, "proof_of_work", p.proof_of_work + 1),
    "evaluation_bumped": _evals(lambda e: [_bump(e[0])] + e[1:]),
    "evaluations_reversed": _evals(lambda e: e[::-1]),
    "evaluations_popped": _evals(lambda e: e[:-1]),  # the reference's panic: IndexError
    "evaluations_swapped": _evals(_swap01),
    "evaluation_extra": _evals(lambda e: e + [(0, 0, 0, 0)]),
    "first_witness_bumped": _first_witness,
    "first_hash_zeroed": _first_hash,
    "first_hash_extra": _first_hash_extra,  # the witness is consumed exactly
    "inner_commitment_zeroed": _inner_commitment,
    "inner_commitment_not_bytes": _inner_commitment_type,
    "first_commitment_31_bytes": lambda p: setattr(p.proof.first_layer, "commitment", b"\x01" * 31),
    "witness_arity_3": lambda p: p.proof.first_layer.fri_witness.append((1, 2, 3)),
    "last_layer_bumped": _last_layer,
    "last_layer_felt_P": lambda p: setattr(p.proof, "last_layer_poly", [(P, 0, 0, 0)] * len(p.proof.last_layer_poly)),
    "log_size_bound_huge": lambda p: setattr(p, "log_size_bound", 10**6),  # ROADMAP C.1
    "pow_negative": lambda p: setattr(p, "proof_of_work", -1),  # ROADMAP C.1
    "blowup_zero": lambda p: setattr(p, "pcs_config", _zero_blowup(p.pcs_config)),
}


def _zero_blowup(cfg):
    """A config with log_blowup_factor 0 (out of bounds), made past the
    dataclass's own check, as a deserializer of another format could."""
    bad = copy.copy(cfg.fri_config)
    object.__setattr__(bad, "log_blowup_factor", 0)
    out = copy.copy(cfg)
    object.__setattr__(out, "fri_config", bad)
    return out


@pytest.mark.parametrize("name", sorted(MUTATIONS))
@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_mutation_verdict_equals_jax(case, name):
    proof, jproof = both(case)
    if name == "first_witness_bumped" and not proof.proof.first_layer.fri_witness:
        pytest.fail("every frozen proof has a lone query in its first layer")
    MUTATIONS[name](proof)
    MUTATIONS[name](jproof)
    got = outcome(api.verify, proof, case["seed"])
    assert got == outcome(japi.verify, jproof, case["seed"])
    assert got == ("IndexError" if name == "evaluations_popped" else False)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_wrong_seeds_equal_jax(case):
    proof, jproof = both(case)
    seed = case["seed"]
    others = [0, 1] if seed is None else [seed + 1, seed - 1, None]
    for s in others:
        assert api.verify(proof, s) is False
        assert japi.verify(jproof, s) is False


def _mutants(wire: bytes, rng_seed: int):
    """100 seeded byte mutations (1-3 bytes xored) and 40 truncations, each
    with and without 3 zero bytes appended (tests/test_fuzz_verify.py:53-75)."""
    rng = np.random.default_rng(rng_seed)
    for _ in range(100):
        buf = bytearray(wire)
        for _ in range(int(rng.integers(1, 4))):
            buf[int(rng.integers(0, len(buf)))] ^= int(rng.integers(1, 256))
        yield bytes(buf)
    for _ in range(20):
        cut = int(rng.integers(0, len(wire)))
        yield wire[:cut]
        yield wire[:cut] + bytes(3)


def _parse_and_verify(parse, verify, blob, seed):
    try:
        proof = parse(blob)
    except ValueError:
        return "parse-rejected"
    return outcome(verify, proof, seed)


@pytest.mark.parametrize("rng_seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["dryrun_960B", "mid_4096B_lastlayer2"])
def test_fuzzed_wire_verdicts_equal_jax(name, rng_seed):
    case = BY_NAME[name]
    wire = bytes.fromhex(case["wire_hex"])
    tags = {}
    for blob in _mutants(wire, rng_seed):
        got = _parse_and_verify(Proof.from_bytes, api.verify, blob, case["seed"])
        assert got == _parse_and_verify(JProof.from_bytes, japi.verify, blob, case["seed"]), blob.hex()
        assert got is not True or blob == wire
        tags[got] = tags.get(got, 0) + 1
    assert tags.get(False, 0) > 0 and tags.get("parse-rejected", 0) > 0


def test_c1_out_of_range_header_is_false_in_verify_many():
    """ROADMAP C.1: the JAX `_replay_and_validate` returns False for an
    out-of-range log_size_bound or proof_of_work, and its verify_many then
    raises TypeError. The port's verify_many returns False for that proof,
    as both packages' `verify` do."""
    proofs, jproofs, seeds = [], [], []
    for case in CASES:
        for mutate in (None, MUTATIONS["log_size_bound_huge"], MUTATIONS["pow_negative"]):
            proof, jproof = both(case)
            if mutate:
                mutate(proof)
                mutate(jproof)
            proofs.append(proof)
            jproofs.append(jproof)
            seeds.append(case["seed"])
    want = [japi.verify(p, s) for p, s in zip(jproofs, seeds)]
    assert want == [True, False, False] * len(CASES)
    assert api.verify_many(proofs, seeds) == want
    assert fri._replay_and_validate(proofs[1], seeds[1]) is None


def test_c2_every_felt_entry_must_be_a_tuple():
    """ROADMAP C.2: the port parses QM31 lists strictly. A witness whose first
    entry is a tuple and a later one a list (same values) is invalid, where
    the JAX package checks only the first entry's type."""
    case = BY_NAME["tiny_64B_default"]
    proof, _ = both(case)
    wit = proof.proof.first_layer.fri_witness
    assert len(wit) >= 2
    assert fri._qm31_array_or_none(wit) is not None
    mixed = list(wit)
    mixed[1] = list(mixed[1])
    assert fri._qm31_array_or_none(mixed) is None
    assert fri._qm31_array_or_none([list(w) for w in wit]) is None
    proof.proof.first_layer.fri_witness = mixed
    assert api.verify(proof, case["seed"]) is False
    assert api.verify_many([proof], [case["seed"]]) == [False]
    proof.proof.first_layer.fri_witness = [tuple(w) for w in mixed]
    assert api.verify(proof, case["seed"]) is True


def test_verify_many_equals_loop_and_takes_the_batched_walk(monkeypatch):
    """Mixed shapes (the four frozen proofs), several proofs of each shape
    (valid, tampered, wrong seed), one alone: verify_many equals a loop of
    verify and the JAX package's verdicts, and every shape with more than
    one proof goes through `_batched_layer_walk`."""
    calls = []
    walk = fri._batched_layer_walk

    def recording(n, n_inner, proofs, ctxs):
        calls.append((n, len(proofs)))
        return walk(n, n_inner, proofs, ctxs)

    monkeypatch.setattr(fri, "_batched_layer_walk", recording)
    proofs, jproofs, seeds = [], [], []

    def add(case, seed, mutate=None):
        proof, jproof = both(case)
        if mutate:
            mutate(proof)
            mutate(jproof)
        proofs.append(proof)
        jproofs.append(jproof)
        seeds.append(seed)

    for case in CASES[:3]:
        s = case["seed"]
        add(case, s)
        add(case, s, MUTATIONS["first_witness_bumped"])
        add(case, 999)
        add(case, s, MUTATIONS["last_layer_bumped"])
        add(case, s, MUTATIONS["first_hash_extra"])
        add(case, s, MUTATIONS["first_hash_zeroed"])
        add(case, s)
    add(CASES[3], CASES[3]["seed"])  # a shape with one proof
    got = api.verify_many(proofs, seeds)
    assert got == [api.verify(p, s) for p, s in zip(proofs, seeds)]
    assert got == [japi.verify(p, s) for p, s in zip(jproofs, seeds)]
    assert got == [True, False, False, False, False, False, True] * 3 + [True]
    # the wrong seed's and the bumped last layer's transcripts fail the
    # proof-of-work check before the layers are walked
    assert sorted(k for _, k in calls) == [5, 5, 5]


def test_verify_many_panics_like_verify():
    case = BY_NAME["dryrun_960B"]
    proof, _ = both(case)
    proof.evaluations.pop()
    with pytest.raises(IndexError):
        api.verify_many([both(case)[0], proof], [case["seed"]] * 2)
    with pytest.raises(ValueError):
        api.verify_many([proof], [])


# ---------------------------------------------------------------------------
# The verifier's helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 8, 12])
def test_circle_lookups_equal_jax(n):
    rng = np.random.default_rng(RNG_SEED + n)
    for layer in range(n - 1):
        size = 1 << (n - 1 - layer)
        js = np.unique(rng.integers(0, size, size=min(16, size)))
        got = circle.line_x_batch(n, layer, js)
        inv = circle.line_x_inv_batch(n, layer, js)
        assert got.dtype == inv.dtype == np.uint64
        assert np.array_equal(got, jcircle.line_x_batch(n, layer, js))
        assert np.array_equal(inv, jcircle.line_x_inv_batch(n, layer, js))
        for j, g in zip(js, got):
            assert int(g) == jfri._line_x_at(n, layer, int(j))
            if layer == 0:  # X_0[j] = x(stored domain point 2j)
                assert int(g) == circle.domain_point_at_stored_index(n, 2 * int(j))[0]
    ks = np.unique(rng.integers(0, 1 << (n - 1), size=16))
    assert np.array_equal(circle.ys_inv_at_stored_pairs(n, ks), jcircle.ys_inv_at_stored_pairs(n, ks))
    for s in rng.integers(0, 1 << n, size=8):
        assert circle.domain_point_at_stored_index(n, int(s)) == jcircle.domain_point_at_stored_index(n, int(s))
        assert circle.natural_point(n, int(s)) == jcircle.natural_point(n, int(s))
        assert circle.bit_reverse_index(int(s), n) == jcircle.bit_reverse_index(int(s), n)
    for bits in (0, 1, n, 17, 26, 32):
        js = rng.integers(0, 1 << bits, size=50) if bits else np.zeros(3, np.int64)
        assert np.array_equal(circle.bitrev_array(js, bits), jcircle._bitrev_arr(js, bits).astype(np.int64))
        assert np.array_equal(npfield.bitrev(js, bits), jnpfield.bitrev(js, bits))


def test_npfield_equals_jax():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.integers(0, P, size=(64, 4), dtype=np.uint64)
    y = rng.integers(0, P, size=(64, 4), dtype=np.uint64)
    s = rng.integers(0, P, size=64, dtype=np.uint64)
    a = rng.integers(1, P, size=100, dtype=np.uint64)
    for name, args in [("qm31_add", (x, y)), ("qm31_sub", (x, y)), ("qm31_mul", (x, y)),
                       ("qm31_mul", (x[:1], y)), ("qm31_mul_m31", (x, s)), ("m31_mul", (s, s)),
                       ("m31_inv", (a,))]:
        assert np.array_equal(getattr(npfield, name)(*args), getattr(jnpfield, name)(*args)), name
    assert np.all(a * npfield.m31_inv(a) % P == 1)
    vals = [tuple(int(v) for v in r) for r in x[:5]]
    assert np.array_equal(npfield.qm31_arr(vals), jnpfield.qm31_arr(vals))


@pytest.mark.parametrize("log_b", [0, 1, 3])
def test_eval_line_poly_batch_equals_jax(log_b):
    rng = np.random.default_rng(RNG_SEED + log_b)
    coeffs = [tuple(int(v) for v in r) for r in rng.integers(0, P, size=(1 << log_b, 4), dtype=np.uint64)]
    xs = rng.integers(0, P, size=9, dtype=np.uint64)
    got = fri._eval_line_poly_batch(coeffs, xs)
    assert np.array_equal(got, jfri._eval_line_poly_batch(coeffs, xs))
    for i, x in enumerate(xs):
        assert tuple(int(v) for v in got[i]) == jfri._eval_line_poly(coeffs, int(x))


def test_compress_rows_host_native_equals_plain_and_jax():
    rng = np.random.default_rng(RNG_SEED)
    for m in (0, 1, 37):
        msgs = rng.integers(0, 1 << 32, size=(m, 16), dtype=np.uint64).astype(np.uint32)
        got = merkle.compress_rows_host(msgs)
        assert got.shape == (m, 8) and got.dtype == np.uint32
        assert np.array_equal(got, merkle.compress_rows_host(msgs, plain=True))
        assert np.array_equal(got, jmerkle.compress_rows_host(msgs))


def _tree(log_n, rng):
    """Every level of a host-built tree in stored order, leaves first."""
    cols = rng.integers(0, P, size=(1 << log_n, 4), dtype=np.uint64).astype(np.uint32)
    msgs = np.zeros((1 << log_n, 16), np.uint32)
    msgs[:, :4] = cols
    levels = [merkle.compress_rows_host(msgs)]
    while levels[-1].shape[0] > 1:
        lv = levels[-1]
        levels.append(merkle.compress_rows_host(np.concatenate([lv[0::2], lv[1::2]], axis=1)))
    return levels


# (log_n, opened leaves): lone, paired, first and last, every leaf
OPENINGS = [(6, [3, 10, 11, 40]), (1, [0]), (4, [0, 15]), (3, list(range(8))), (9, [1, 2, 200, 201, 511])]


@pytest.mark.parametrize("log_n,opened", OPENINGS, ids=[f"{o[0]}-{len(o[1])}" for o in OPENINGS])
def test_verify_openings_rows_native_equals_plain(log_n, opened):
    """tests/test_verifier_fast.py:63-108 on the port's two routes: a real
    opening verifies, and a bad, short, long or malformed witness or a wrong
    root is rejected alike; the JAX package agrees on each."""
    levels = _tree(log_n, np.random.default_rng(RNG_SEED + log_n))
    root = levels[-1][0].tobytes()
    wit = [levels[k][s].tobytes() for k, sibs in enumerate(jfri._merkle_witness_plans(log_n, opened))
           for s in sibs]
    rows = levels[0][opened]
    witnesses = {"good": wit, "extra": wit + [bytes(32)], "not_bytes": wit + [None],
                 "short_entry": wit + [bytes(31)]}
    if wit:
        witnesses.update(bad=[bytes(32)] + wit[1:], short=wit[:-1])
    for name, w in witnesses.items():
        for r in (root, bytes(32)):
            got = merkle.verify_openings_rows(r, log_n, list(opened), rows, w)
            assert got == merkle.verify_openings_rows(r, log_n, list(opened), rows, w, plain=True), name
            assert got == jmerkle.verify_openings_rows(r, log_n, list(opened), rows, w), name
            assert got == (name == "good" and r == root), name
    dec = merkle.MerkleDecommitment(wit)
    leaves = {i: levels[0][i].tobytes() for i in opened}
    assert merkle.verify_openings(root, log_n, leaves, dec)
    assert merkle.verify_openings(root, log_n, leaves, dec, plain=True)


def test_verify_openings_batch_equals_one_by_one():
    rng = np.random.default_rng(RNG_SEED)
    log_n, trees = 5, []
    for opened in ([1, 2, 3], [0, 31], [4]):
        levels = _tree(log_n, rng)
        wit = np.array([levels[k][s] for k, sibs in enumerate(jfri._merkle_witness_plans(log_n, opened))
                        for s in sibs], np.uint32).reshape(-1, 8)
        trees.append((np.array(opened, np.int64), levels[0][opened], wit, levels[-1][0]))
    trees[1] = trees[1][:2] + (trees[1][2][:-1],) + trees[1][3:]  # a short witness
    seg = np.cumsum([0] + [len(t[0]) for t in trees])
    wseg = np.cumsum([0] + [len(t[2]) for t in trees])
    ok, roots = native.verify_openings_batch(log_n, seg, np.concatenate([t[0] for t in trees]),
                                             np.concatenate([t[1] for t in trees]), wseg,
                                             np.concatenate([t[2] for t in trees]))
    assert ok.tolist() == [True, False, True]
    for p in (0, 2):
        assert np.array_equal(roots[p], trees[p][3])
        assert native.verify_openings(log_n, *trees[p][:3]) == (True, trees[p][3].tobytes(), len(trees[p][2]))


def test_native_builds_under_build_native():
    lib = pathlib.Path(native.library()._name).resolve()
    assert lib.name == "libfrieda_native.so"
    assert lib.parent.parent == ROOT / "build" / "native"
    assert (lib.parent / "build.log").exists()


def test_compile_once_compiles_each_source_then_links(tmp_path):
    """Several sources: one object each (compiled together), one link; a
    source that does not compile raises and leaves no library."""
    from frieda_tpu_torch.ops._build import compile_once

    srcs = []
    for k in range(3):
        srcs.append(tmp_path / f"u{k}.cpp")
        srcs[-1].write_text(f'extern "C" int unit{k}() {{ return {k + 40}; }}\n')
    lib = ctypes.CDLL(str(compile_once(tmp_path / "out", "libunits.so", "g++", native.GXX_FLAGS, srcs)))
    assert [getattr(lib, f"unit{k}")() for k in range(3)] == [40, 41, 42]
    log = (tmp_path / "out").glob("*/build.log")
    assert sum(" -c " in line for line in next(log).read_text().splitlines()) == 3
    srcs[1].write_text("this is not C++;\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        compile_once(tmp_path / "bad", "libunits.so", "g++", native.GXX_FLAGS, srcs)
    assert not list((tmp_path / "bad").glob("*/*.so"))


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """No fallback: a runtime that does not compile raises, and `verify`
    raises with it instead of returning a verdict."""
    broken = tmp_path / "frieda_native.cpp"
    broken.write_text(native.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.library()
    proof, _ = both(BY_NAME["dryrun_960B"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        api.verify(proof, 7)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        api.verify_many([proof], [7])
    assert not list((tmp_path / "build").glob("*/*.so"))
