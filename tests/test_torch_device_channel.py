"""Port's device channel (`frieda_tpu_torch.core.device_channel`: the plain
versions of the `transcript` and `grind` kernels, and the `ops.channel`
wrappers that run them on CPU tensors), the fold wrappers and the
device-resident commit phase, against the JAX package's device channel
(`frieda_tpu.core.device_channel`, eager on the CPU as
tests/test_device_channel.py runs it), its commit phase's packed outputs
(`fri.dispatch_commit_phase_staged` at the frozen cases' shapes) and the host
`Blake2sChannel`. Inputs are seeded numpy arrays; tolerance: exact equality
(integer arithmetic and hashes)."""

import pytest

pytest.importorskip("torch")

import json  # noqa: E402
import pathlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import synthetic_data  # noqa: E402
from frieda_tpu.config import PcsConfig as JPcsConfig  # noqa: E402
from frieda_tpu.core import device_channel as jdc  # noqa: E402
from frieda_tpu.core import field as jf  # noqa: E402
from frieda_tpu.core import fri as jfri  # noqa: E402
from frieda_tpu.core.grind import grind_host  # noqa: E402
from frieda_tpu.utils.packing import pad_to_words as jpad_to_words  # noqa: E402
from frieda_tpu_torch import ops  # noqa: E402
from frieda_tpu_torch.config import FriConfig, PcsConfig  # noqa: E402
from frieda_tpu_torch.core import device_channel as dc  # noqa: E402
from frieda_tpu_torch.core import fri  # noqa: E402
from frieda_tpu_torch.core.channel import Blake2sChannel, sample_query_positions  # noqa: E402
from frieda_tpu_torch.core.merkle import root_bytes  # noqa: E402
from frieda_tpu_torch.ops import channel as channel_ops  # noqa: E402
from frieda_tpu_torch.utils.convert import from_numpy_u32, to_numpy_u32, widen  # noqa: E402
from frieda_tpu_torch.utils.packing import log_total_for, pad_to_words  # noqa: E402

torch.set_num_threads(1)

P = (1 << 31) - 1
CASES = {c["name"]: c for c in json.loads(
    (pathlib.Path(__file__).parent / "data" / "frozen_proofs.json").read_text())}


def _u32(rng, shape, hi=1 << 32) -> np.ndarray:
    return rng.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32)


def _t(words: np.ndarray) -> torch.Tensor:
    """int64 u32 values (the plain versions' form)."""
    return widen(from_numpy_u32(words, "cpu"))


def _bytes(words) -> bytes:
    return np.asarray(to_numpy_u32(words) if isinstance(words, torch.Tensor) else words,
                      np.uint32).astype("<u4").tobytes()


def _channels(seed: int):
    """(host channel, port digest, JAX digest, port wrapper state) after
    mix_u64(seed)."""
    host = Blake2sChannel()
    host.mix_u64(seed)
    state = channel_ops.new_state("cpu")
    channel_ops.transcript(state, mix_u64=seed)
    return (host, dc.dc_mix_u64_const(dc.fresh_digest(), seed & ((1 << 64) - 1)),
            jdc.dc_mix_u64_const(jdc.fresh_digest(), seed & ((1 << 64) - 1)), state)


@pytest.mark.parametrize("value", [0, 7, 12345678901234567, (1 << 64) - 1, -5])
def test_mix_u64_matches_jax_and_host(value):
    host, got, want, state = _channels(value)
    assert _bytes(got) == _bytes(np.asarray(want)) == host.digest == _bytes(state[:8])
    # the nonce form: (lo, hi) words on the device
    lo, hi = value & 0xFFFFFFFF, (value >> 32) & 0xFFFFFFFF
    host.mix_u64(value)
    channel_ops.transcript(state, mix_u64=from_numpy_u32(np.array([lo, hi], np.uint32), "cpu"))
    assert _bytes(dc.dc_mix_u64(got, lo, hi)) == host.digest == _bytes(state[:8])
    assert int(state[8]) == 0


def test_mix_digest_matches_jax_and_host():
    rng = np.random.default_rng(1)
    host, got, want, state = _channels(3)
    for _ in range(4):
        root = _u32(rng, 8)
        host.mix_digest(_bytes(root))
        got = dc.dc_mix_digest(got, _t(root))
        want = jdc.dc_mix_digest(want, jnp.asarray(root))
        channel_ops.transcript(state, mix_digest=from_numpy_u32(root, "cpu"))
        assert _bytes(got) == _bytes(np.asarray(want)) == host.digest == _bytes(state[:8])


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_mix_felts_matches_jax_and_host(k):
    """k QM31: 48, 64, 80 and 160 bytes, one to three blocks."""
    felts = _u32(np.random.default_rng(k), (k, 4), P)
    host, got, want, state = _channels(7)
    host.mix_felts([tuple(int(v) for v in row) for row in felts])
    got = dc.dc_mix_felts(got, _t(felts))
    want = jdc.dc_mix_felts(want, jnp.asarray(felts))
    channel_ops.transcript(state, mix_felts=from_numpy_u32(felts, "cpu"))
    assert _bytes(got) == _bytes(np.asarray(want)) == host.digest == _bytes(state[:8])


@pytest.mark.parametrize("seed", [0, 1, 999])
def test_draw_felt_matches_jax_and_host(seed):
    host, got, want, state = _channels(seed)
    n_sent, jn_sent = 0, jnp.uint32(0)
    for _ in range(3):
        expect = host.draw_felt()
        alpha, n_sent = dc.dc_draw_felt(got, n_sent)
        jalpha, jn_sent = jdc.dc_draw_felt(want, jn_sent)
        wrapped, _ = channel_ops.transcript(state, draw_felt=True)
        assert tuple(int(v) for v in alpha) == tuple(int(v) for v in np.asarray(jalpha)) == expect
        assert tuple(int(v) for v in to_numpy_u32(wrapped)) == expect
        assert int(n_sent) == int(jn_sent) == host.n_sent == int(state[8])


def _host_draw_under(host: Blake2sChannel, bound: int):
    """The host channel's draw_felt with the retry bound `bound`."""
    while True:
        raw = host.draw_random_bytes()
        words = [int.from_bytes(raw[4 * i : 4 * i + 4], "little") for i in range(8)]
        if all(w < bound for w in words):
            return tuple(w % P for w in words[:4])


@pytest.mark.parametrize("bound", [1 << 31, 3 << 30])
def test_draw_retry_under_a_lowered_bound(bound, monkeypatch):
    """No natural input retries (~2^-28 a draw); with the bound lowered
    through `device_channel.DRAW_BOUND`, the plain version, the wrapper and
    a host loop under the same bound retry alike."""
    monkeypatch.setattr(dc, "DRAW_BOUND", bound)
    host, digest, _, state = _channels(11)
    n_sent = 0
    for _ in range(2):
        expect = _host_draw_under(host, bound)
        alpha, n_sent = dc.dc_draw_felt(digest, n_sent)
        wrapped, _words = channel_ops.transcript(state, draw_felt=True)
        assert tuple(int(v) for v in alpha) == tuple(int(v) for v in to_numpy_u32(wrapped)) == expect
        assert int(n_sent) == host.n_sent == int(state[8])
    assert host.n_sent > 2  # the retry was taken


def test_trailing_zeros_matches_jax_and_host():
    rng = np.random.default_rng(5)
    cases = [bytes(32), b"\x04" + bytes(31), b"\x00\x01" + b"\xff" * 30, b"\x00\x00\x00\x00\x80" + bytes(27),
             bytes(12) + b"\x10" + bytes(19), bytes(16) + b"\xff" * 16]
    cases += [_bytes(_u32(rng, 8)) for _ in range(8)]
    for digest in cases:
        host = Blake2sChannel()
        host.digest = digest
        words = np.frombuffer(digest, np.uint32)
        got = int(dc.dc_trailing_zeros(_t(words)))
        assert got == int(np.asarray(jdc.dc_trailing_zeros(jnp.asarray(words)))) == host.trailing_zeros()


@pytest.mark.parametrize("pow_bits", [0, 4, 9, 12])
def test_grind_matches_jax_and_host(pow_bits):
    """The minimum nonce: the plain sweep, the wrapper on a CPU state, the
    JAX package's `dc_grind` and `grind_host`."""
    host, got, want, state = _channels(100 + pow_bits)
    expect = grind_host(host.clone(), pow_bits)
    assert dc.dc_grind(got, pow_bits) == expect
    assert dc.dc_grind(got, pow_bits, batch=16) == expect
    assert int(np.asarray(jdc.dc_grind(want, pow_bits, batch=1 << 10))) == expect
    nonce = channel_ops.grind(state, pow_bits)
    assert nonce.dtype == torch.int32 and nonce.shape == (2,)
    assert int(nonce.view(torch.int64)) == expect
    c = host.clone()
    c.mix_u64(expect)
    assert c.trailing_zeros() >= pow_bits
    with pytest.raises(ValueError):
        channel_ops.grind(state, 61)


@pytest.mark.parametrize("n_queries", [1, 8, 20, 64])
def test_sample_query_words_match_jax_and_host(n_queries):
    log_domain = 12
    host, got, want, state = _channels(5)
    raw_host = []
    probe = host.clone()
    while len(raw_host) < n_queries:
        raw = probe.draw_random_bytes()
        raw_host += [int.from_bytes(raw[4 * i : 4 * i + 4], "little") & 0xFFF for i in range(8)]
    words, n_sent = dc.dc_sample_query_words(got, 0, n_queries, log_domain)
    jwords, jn_sent = jdc.dc_sample_query_words(want, jnp.uint32(0), n_queries, log_domain)
    _, wrapped = channel_ops.transcript(state, queries=(n_queries, log_domain))
    assert [int(v) for v in words] == [int(v) for v in np.asarray(jwords)] == raw_host[:n_queries]
    assert [int(v) for v in to_numpy_u32(wrapped)] == raw_host[:n_queries]
    assert sorted(set(raw_host[:n_queries])) == sample_query_positions(host.clone(), log_domain, n_queries)
    assert int(n_sent) == int(jn_sent) == int(state[8]) == -(-n_queries // 8)


def test_transcript_steps_of_one_launch_run_in_order():
    """One call with every step equals the steps one call each."""
    rng = np.random.default_rng(9)
    root = from_numpy_u32(_u32(rng, 8), "cpu")
    felts = from_numpy_u32(_u32(rng, (3, 4), P), "cpu")
    nonce = from_numpy_u32(_u32(rng, 2), "cpu")
    one, many = channel_ops.new_state("cpu"), channel_ops.new_state("cpu")
    alpha, words = channel_ops.transcript(one, mix_u64=nonce, mix_digest=root, mix_felts=felts, draw_felt=True,
                                          queries=(10, 20))
    channel_ops.transcript(many, mix_u64=nonce)
    channel_ops.transcript(many, mix_digest=root)
    channel_ops.transcript(many, mix_felts=felts)
    a2, _ = channel_ops.transcript(many, draw_felt=True)
    _, w2 = channel_ops.transcript(many, queries=(10, 20))
    assert torch.equal(one, many) and torch.equal(alpha, a2) and torch.equal(words, w2)


@pytest.mark.parametrize("bad", ["felts_empty", "felts_shape", "digest_dtype", "digest_shape", "nonce_shape",
                                 "log_domain", "state_shape", "draw_bound"])
def test_transcript_rejects_bad_operands(bad, monkeypatch):
    state = channel_ops.new_state("cpu")
    kwargs = {
        "felts_empty": dict(mix_felts=torch.zeros((0, 4), dtype=torch.int32)),
        "felts_shape": dict(mix_felts=torch.zeros((2, 3), dtype=torch.int32)),
        "digest_dtype": dict(mix_digest=torch.zeros(8, dtype=torch.int64)),
        "digest_shape": dict(mix_digest=torch.zeros(7, dtype=torch.int32)),
        "nonce_shape": dict(mix_u64=torch.zeros(3, dtype=torch.int32)),
        "log_domain": dict(queries=(4, 33)),
        "state_shape": dict(draw_felt=True),
        "draw_bound": dict(draw_felt=True),
    }[bad]
    if bad == "state_shape":
        state = torch.zeros(8, dtype=torch.int32)
    if bad == "draw_bound":
        monkeypatch.setattr(dc, "DRAW_BOUND", 2 * P + 1)
    with pytest.raises((ValueError, TypeError)):
        channel_ops.transcript(state, **kwargs)


@pytest.mark.parametrize("form", ["circle", "line"])
def test_folds_take_alpha_as_tensor_and_tuple(form):
    """fold_c / fold_l against the JAX package's fold arithmetic
    (`_fri_commit_fn`'s fold_c / fold_l: the QM31 ops of frieda_tpu.core.field
    on the halves), alpha as a (4,) tensor, a tuple of ints and a tuple of
    0-d tensors."""
    n = 7
    rng = np.random.default_rng(len(form))
    ys_inv, xs_invs = fri.fold_tables(n, "cpu")
    width, inv = (1 << n, ys_inv) if form == "circle" else (1 << (n - 1), xs_invs[0])
    values = _u32(rng, (4, width), P)
    alpha = _u32(rng, 4, P)
    half = width // 2
    lo = tuple(jnp.asarray(values[i, :half]) for i in range(4))
    hi = tuple(jnp.asarray(values[i, half:]) for i in range(4))
    f1 = jf.qm31_mul_m31(jf.qm31_sub(lo, hi), jnp.asarray(to_numpy_u32(inv)))
    want = np.stack([np.asarray(c) for c in jf.qm31_add(
        jf.qm31_add(lo, hi), jf.qm31_mul(tuple(jnp.uint32(int(a)) for a in alpha), f1))])
    fold = fri.fold_c if form == "circle" else fri.fold_l
    tv = from_numpy_u32(values, "cpu")
    tensor_alpha = from_numpy_u32(alpha, "cpu")
    for a in (tensor_alpha, tuple(int(v) for v in alpha), tuple(tensor_alpha)):
        got = fold(tv, a, inv)
        assert got.dtype == torch.int32 and np.array_equal(to_numpy_u32(got), want)


def _jax_head(case: dict) -> dict:
    """The head of the JAX package's packed commit-phase vector for a frozen
    case: roots, last layer, degree flag, nonce and raw query positions."""
    data = synthetic_data(case["data_len"], case["data_seed_offset"])
    log_total = log_total_for(len(data))
    cfg = JPcsConfig.from_dict(case["config"])
    packed, _, _, n, n_inner = jfri.dispatch_commit_phase_staged(
        jnp.asarray(jpad_to_words(data, log_total)), log_total, case["seed"], cfg)
    nq = cfg.fri_config.n_queries
    off, *_ = jfri._packed_layout(n, n_inner, 1 << cfg.fri_config.log_last_layer_degree_bound, nq)
    vec = np.asarray(packed)
    return {k: vec[o : o + c] for k, (o, c) in off.items()}


@pytest.mark.parametrize("name", ["dryrun_960B", "mid_4096B_lastlayer2"])
def test_commit_phase_outputs_match_jax_and_the_host_transcript(name):
    """`commit_phase` on the CPU: its one fetch gives the JAX package's
    roots, last layer, degree flag, nonce and raw query words, and the host
    channel replayed over its roots gives the same alphas (the layers fold
    with them), nonce and query draws."""
    case = CASES[name]
    cfg = PcsConfig.from_dict(case["config"])
    data = synthetic_data(case["data_len"], case["data_seed_offset"])
    log_total = log_total_for(len(data))
    words = from_numpy_u32(pad_to_words(data, log_total), "cpu")
    committed = fri.commit_phase(words[None], log_total, [case["seed"]], cfg)[0]
    assert committed._host is None  # nothing fetched yet
    head = _jax_head(case)
    packed = to_numpy_u32(committed.packed)
    assert committed.roots == [root_bytes(t.root) for t in committed.trees]
    assert b"".join(committed.roots) == _bytes(head["roots"])
    assert np.array_equal(np.array(committed.last_layer_poly, np.uint32).reshape(-1), head["last"])
    assert head["degree_ok"][0] == 1 and packed[8 * len(committed.trees) + head["last"].size] == 1
    assert committed.nonce == int(head["nonce"][0])
    assert np.array_equal(committed.query_words, head["qpos"])
    assert committed.queries == sorted(set(int(q) for q in head["qpos"]))

    host = Blake2sChannel()
    if case["seed"] is not None:
        host.mix_u64(case["seed"])
    ys_inv, xs_invs = fri.fold_tables(committed.layers[0].shape[1].bit_length() - 1, "cpu")
    for t, root in enumerate(committed.roots):
        host.mix_digest(root)
        alpha = host.draw_felt()
        if t + 1 < len(committed.layers):
            fold = fri.fold_c(committed.layers[0], alpha, ys_inv) if t == 0 else \
                fri.fold_l(committed.layers[t], alpha, xs_invs[t - 1])
            assert torch.equal(fold, committed.layers[t + 1])
    host.mix_felts(committed.last_layer_poly)
    assert committed.nonce == grind_host(host.clone(), cfg.pow_bits)
    host.mix_u64(committed.nonce)
    n = committed.layers[0].shape[1].bit_length() - 1
    assert committed.queries == sample_query_positions(host, n, cfg.fri_config.n_queries)


def test_cpu_proof_counts_no_kernel_launch():
    """On CPU tensors every wrapper, the three new ones included, runs its
    plain version and counts nothing."""
    assert {"fri_fold", "transcript", "grind"} <= set(ops.kernel_wrappers())
    ops.reset_launch_counts()
    case = CASES["dryrun_960B"]
    data = synthetic_data(case["data_len"], case["data_seed_offset"])
    log_total = log_total_for(len(data))
    _, proof = fri.prove_words(from_numpy_u32(pad_to_words(data, log_total), "cpu"), log_total, case["seed"],
                               PcsConfig.from_dict(case["config"]))
    assert proof.to_bytes().hex() == case["wire_hex"]
    assert set(ops.launch_counts().values()) == {0}


def test_a_last_layer_above_its_bound_raises_in_finish_proof(monkeypatch):
    """The degree flag is computed on the device and fetched with the other
    outputs: a last fold that breaks the degree bound raises AssertionError
    in `finish_proof` (and on any read of the fetched outputs), not before."""
    cfg = PcsConfig(pow_bits=2, fri_config=FriConfig(2, 0, 4))
    data = bytes(range(200))
    log_total = log_total_for(len(data))
    last = 1 << 2
    fold_l = fri.fold_l
    rng = np.random.default_rng(3)

    def breaking_fold(g, alpha, xs_inv):  # a batch's (B, 4, M) values
        out = fold_l(g, alpha, xs_inv)
        if out.shape[-1] == last:  # the last layer: not of degree < 1
            out = from_numpy_u32(_u32(rng, tuple(out.shape), P), "cpu")
        return out

    monkeypatch.setattr(fri, "fold_l", breaking_fold)
    words = from_numpy_u32(pad_to_words(data, log_total), "cpu")
    committed = fri.commit_phase(words[None], log_total, [1], cfg)[0]
    with pytest.raises(AssertionError, match="degree bound"):
        fri.finish_proof(committed, log_total, cfg)
    with pytest.raises(AssertionError, match="degree bound"):
        committed.roots  # noqa: B018
