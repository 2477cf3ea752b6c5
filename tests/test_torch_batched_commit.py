"""Port's commit phase over a batch (`core/fri.commit_phase`, the
counterpart of the JAX package's `_fri_commit_fn(..., batched=True)`) and
the blob axis of its kernels' plain versions, on the CPU: proofs against
the JAX package's vmapped commit phase finished by its `_finish_proof`
(B = 1, 2, 3 at two frozen shapes, seeds set, 0 and 2^64 - 1, and None),
the packed rows against a loop of batches of one, every batched wrapper
against a loop of its one-blob calls, `prove_many_sharded`'s route (the
batch on a mesh of one device, per blob otherwise), the memory split, the
lease of a batch's instance and its one fetch, and the errors. Inputs are
seeded; tolerance: exact equality."""

import pytest

pytest.importorskip("torch")

import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import synthetic_data  # noqa: E402
from frieda_tpu.config import PcsConfig as JPcsConfig  # noqa: E402
from frieda_tpu.core import fft as jfft  # noqa: E402
from frieda_tpu.core import fri as jfri  # noqa: E402
from frieda_tpu.parallel import sharding as jsharding  # noqa: E402
from frieda_tpu.utils.packing import polynomial_from_bytes  # noqa: E402
from frieda_tpu_torch.config import FriConfig, PcsConfig  # noqa: E402
from frieda_tpu_torch.core import device_channel as dc  # noqa: E402
from frieda_tpu_torch.core import fri  # noqa: E402
from frieda_tpu_torch.core import merkle as tm  # noqa: E402
from frieda_tpu_torch.ops import channel as channel_ops  # noqa: E402
from frieda_tpu_torch.ops import fri as fri_ops  # noqa: E402
from frieda_tpu_torch.ops import merkle as merkle_ops  # noqa: E402
from frieda_tpu_torch.parallel import sharding  # noqa: E402
from frieda_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from frieda_tpu_torch.utils.convert import from_numpy_u32, narrow, to_numpy_u32, widen  # noqa: E402
from frieda_tpu_torch.utils.packing import log_total_for, upload_words  # noqa: E402

torch.set_num_threads(1)

P = (1 << 31) - 1
M64 = (1 << 64) - 1
CASES = {c["name"]: c for c in json.loads(
    (pathlib.Path(__file__).parent / "data" / "frozen_proofs.json").read_text())}
# Two frozen shapes: one with a seed (blob 0 its frozen proof; blobs 1 and 2
# under the seeds 0 and 2^64 - 1), one without (the last layer of degree 4).
SHAPES = {"dryrun_960B": [7, 0, M64], "mid_4096B_lastlayer2": [None, None, None]}


def blobs_of(name: str) -> tuple:
    """(datas, seeds, cfg, log_total) of a shape's three blobs, blob 0 the
    frozen case's."""
    case = CASES[name]
    datas = [synthetic_data(case["data_len"], case["data_seed_offset"] + k) for k in range(3)]
    return datas, SHAPES[name], PcsConfig.from_dict(case["config"]), log_total_for(case["data_len"])


@pytest.fixture(scope="module")
def jax_batches() -> dict:
    """The JAX package's proofs of each shape's three blobs from ONE call of
    its batched commit phase, built as `frieda_tpu/parallel/sharding.py:
    82-116` builds it (with no mesh) and finished row by row by
    `frieda_tpu.core.fri._finish_proof`: {shape: [wire bytes]}."""
    out = {}
    for name in SHAPES:
        datas, seeds, _, _ = blobs_of(name)
        jcfg = JPcsConfig.from_dict(CASES[name]["config"])
        fc = jcfg.fri_config
        coeffs = [polynomial_from_bytes(d) for d in datas]
        log_size = coeffs[0].shape[1].bit_length() - 1
        n = log_size + fc.log_blowup_factor
        n_inner = n - 1 - fc.log_last_layer_degree_bound - fc.log_blowup_factor
        fn, tables = jfri._fri_commit_fn(log_size, fc.log_blowup_factor, fc.log_last_layer_degree_bound,
                                         fc.n_queries, jcfg.pow_bits, seeds[0] is not None, None, batched=True)
        vals = [0 if s is None else int(s) & M64 for s in seeds]
        outs = fn(jnp.asarray(np.stack(coeffs)), jfft.bitrev_perm_device(log_size),
                  jnp.asarray([v & 0xFFFFFFFF for v in vals], jnp.uint32),
                  jnp.asarray([v >> 32 for v in vals], jnp.uint32), *tables)
        out[name] = [jfri._finish_proof((outs[i], jcfg, log_size, n, n_inner))[1].to_bytes()
                     for i in range(len(datas))]
    return out


def batched_wires(name: str, B: int) -> list:
    datas, seeds, cfg, log_total = blobs_of(name)
    _, words = upload_words(datas[:B], log_total, "cpu")
    committed = fri.commit_phase(words, log_total, seeds[:B], cfg)
    return [fri.finish_proof(c, log_total, cfg)[1].to_bytes() for c in committed]


@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("name", list(SHAPES))
def test_batched_commit_phase_equals_the_jax_batched_commit_phase(jax_batches, name, B):
    """Each row's proof == the JAX package's batched program's row, word for
    word, and row 0 is the frozen proof."""
    wires = batched_wires(name, B)
    assert wires == jax_batches[name][:B]
    assert wires[0].hex() == CASES[name]["wire_hex"]


@pytest.mark.parametrize("name", list(SHAPES))
def test_packed_rows_equal_a_loop_of_single_commit_phases(name):
    """Every row of the batch's packed (B, total) vector == the packed
    vector of that blob's batch of one, and every Committed's layers and
    trees are the single proof's."""
    datas, seeds, cfg, log_total = blobs_of(name)
    _, words = upload_words(datas, log_total, "cpu")
    committed = fri.commit_phase(words, log_total, seeds, cfg)
    packed = committed[0].batch[0].packed
    assert packed.shape == (3, committed[0].layout.total)
    for b, c in enumerate(committed):
        one = fri.commit_phase(words[b : b + 1], log_total, seeds[b : b + 1], cfg)[0]
        assert torch.equal(packed[b], one.packed) and c.packed.data_ptr() == packed[b].data_ptr()
        assert all(torch.equal(x, y) for x, y in zip(c.layers, one.layers))
        assert all(torch.equal(x.flat, y.flat) and x.offsets == y.offsets for x, y in zip(c.trees, one.trees))


def test_seed_words_of_a_batch():
    """(B, 2) seed words == the words (lo, hi) of each seed & (2^64 - 1) and
    `seed_words` row by row (int and tensor seeds), None for all None."""
    seeds = [7, 0, M64, -1, 1 << 63]
    got = fri.batch_seed_words(seeds, 5, "cpu")
    lohi = np.array([[(s & M64) & 0xFFFFFFFF, (s & M64) >> 32] for s in seeds], dtype=np.uint32)
    assert torch.equal(got, torch.from_numpy(lohi.view(np.int32)))
    assert torch.equal(got, torch.stack([fri.seed_words(s, "cpu") for s in seeds]))
    assert fri.batch_seed_words(got, 5, "cpu") is got
    assert fri.batch_seed_words([None] * 5, 5, "cpu") is None and fri.batch_seed_words(None, 5, "cpu") is None


def test_device_ifft_line_of_a_batch():
    rng = np.random.default_rng(5)
    _, xs = fri.fold_tables(6, "cpu")
    vals = torch.from_numpy(rng.integers(0, P, (3, 4, 8)).astype(np.int64))
    got = fri._device_ifft_line(vals, xs, 2)
    assert got.shape == (3, 8, 4)
    assert all(torch.equal(got[b], fri._device_ifft_line(vals[b], xs, 2)) for b in range(3))


# ---------------------------------------------------------------------------
# The kernels' blob axis: each batched wrapper (its plain version on the CPU)
# against a loop of one-blob calls
# ---------------------------------------------------------------------------

def rand(rng, shape, hi=1 << 32) -> torch.Tensor:
    return from_numpy_u32(rng.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32), "cpu")


@pytest.mark.parametrize("form", ["shared table", "a table a blob", "one alpha, a table a row"])
def test_fri_fold_of_a_batch_equals_a_loop(form):
    rng = np.random.default_rng(len(form))
    B, half = 3, 32
    values, alphas = rand(rng, (B, 4, 2 * half), P), rand(rng, (B, 4), P)
    inv = rand(rng, (half,), P) if form == "shared table" else rand(rng, (B, half), P)
    alpha = alphas[0] if form.startswith("one alpha") else alphas
    got = fri_ops.fri_fold(values, alpha, inv)
    out = torch.empty((B, 4, half), dtype=torch.int32)
    assert fri_ops.fri_fold(values, alpha, inv, out=out) is out and torch.equal(out, got)
    for b in range(B):
        a = alpha if alpha.dim() == 1 else alpha[b]
        i = inv if inv.dim() == 1 else inv[b]
        assert torch.equal(got[b], fri_ops.fri_fold(values[b], a, i))
        assert torch.equal(got[b], narrow(fri_ops.fri_fold_plain(widen(values[b]), widen(a), widen(i))))


def test_fri_fold_checks_a_batch():
    rng = np.random.default_rng(1)
    values = rand(rng, (3, 4, 8), P)
    with pytest.raises(ValueError):
        fri_ops.fri_fold(values, rand(rng, (2, 4), P), rand(rng, (4,), P))
    with pytest.raises(ValueError):
        fri_ops.fri_fold(values, rand(rng, (3, 4), P), rand(rng, (2, 4), P))
    with pytest.raises(ValueError):
        fri_ops.fri_fold(values[0], rand(rng, (3, 4), P), rand(rng, (4,), P))


def _states(rng, B: int) -> torch.Tensor:
    st = channel_ops.new_state("cpu", B)
    channel_ops.transcript(st, mix_u64=rand(rng, (B, 2)))
    return st


@pytest.mark.parametrize("B", [1, 3])
def test_transcript_of_a_batch_equals_a_loop(B):
    """Every step form over (B, 9) states == the same steps on each state
    alone, with the results stacked; an int mix_u64 goes into every
    channel."""
    rng = np.random.default_rng(B)
    st = _states(rng, B)
    rows = [row.clone() for row in st]
    steps = (dict(mix_u64=123), dict(mix_u64=rand(rng, (B, 2)), mix_digest=rand(rng, (B, 8)), draw_felt=True),
             dict(mix_felts=rand(rng, (B, 3, 4), P)), dict(mix_u64=rand(rng, (B, 2)), queries=(11, 9)))
    for step in steps:
        got = channel_ops.transcript(st, **step)
        for b in range(B):
            one = channel_ops.transcript(rows[b], **{k: v[b] if isinstance(v, torch.Tensor) else v
                                                     for k, v in step.items()})
            for g, w in zip(got, one):
                assert (g is None) == (w is None) and (g is None or torch.equal(g[b], w))
        assert torch.equal(st, torch.stack(rows))
    assert got[1].shape == (B, 11)


def test_transcript_checks_a_batch():
    st = channel_ops.new_state("cpu", 3)
    with pytest.raises(ValueError):
        channel_ops.transcript(st, mix_digest=torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        channel_ops.transcript(st, mix_felts=torch.zeros((2, 1, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        channel_ops.transcript(channel_ops.new_state("cpu", 0), mix_u64=1)


@pytest.mark.parametrize("pow_bits", [0, 6])
def test_grind_of_a_batch_is_each_blobs_minimum(pow_bits):
    """Each blob's nonce == its one-blob grind, the minimum of a host scan."""
    rng = np.random.default_rng(pow_bits)
    st = _states(rng, 3)
    got = channel_ops.grind(st, pow_bits)
    assert got.shape == (3, 2)
    for b in range(3):
        assert torch.equal(got[b], channel_ops.grind(st[b], pow_bits))
        nonce = int(got[b].view(torch.int64).item())
        digest = widen(st[b, :8])
        assert dc.dc_trailing_zeros(dc.dc_mix_u64_const(digest, nonce)) >= pow_bits
        assert all(dc.dc_trailing_zeros(dc.dc_mix_u64_const(digest, k)) < pow_bits for k in range(nonce))


@pytest.mark.parametrize("m", [2, 16, 64])
@pytest.mark.parametrize("with_seed", [False, True])
def test_collapse_with_a_step_a_blob_equals_a_loop(monkeypatch, m, with_seed):
    """merkle_collapse of (B, 8, m) with a batched step == each blob's
    collapse with its own step, also with the draw's retry (a lowered
    DRAW_BOUND: some blobs retry, others not)."""
    rng = np.random.default_rng(m + with_seed)
    for bound in (dc.DRAW_BOUND, 15 << 28):
        monkeypatch.setattr(dc, "DRAW_BOUND", bound)
        B = 6
        level, states = rand(rng, (B, 8, m)), rand(rng, (B, 9))
        seeds = rand(rng, (B, 2)) if with_seed else None
        step = channel_ops.ChannelStep(states.clone(), seeds, torch.zeros((B, 4), dtype=torch.int32))
        widths = tm.tail_widths(m)
        got = merkle_ops.merkle_collapse(level, widths, step=step)
        for b in range(B):
            one = channel_ops.ChannelStep(states[b].clone(), None if seeds is None else seeds[b],
                                          torch.zeros(4, dtype=torch.int32))
            want = merkle_ops.merkle_collapse(level[b], widths, step=one)
            assert all(torch.equal(g[b], w) for g, w in zip(got, want))
            assert torch.equal(step.state[b], one.state) and torch.equal(step.alpha[b], one.alpha)
    n_sent = step.state[:, 8].tolist()
    assert min(n_sent) == 1 and max(n_sent) > 1


def test_collapse_refuses_a_step_of_another_batch():
    level = torch.zeros((3, 8, 4), dtype=torch.int32)
    one = channel_ops.ChannelStep(channel_ops.new_state("cpu"), None, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="one channel a blob"):
        merkle_ops.merkle_collapse(level, (1,), step=one)
    two = channel_ops.ChannelStep(channel_ops.new_state("cpu", 2), None, torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="one channel a blob"):
        merkle_ops.merkle_collapse(level, (1,), step=two)


@pytest.mark.parametrize("log_n", [2, 3, 5, 13])
def test_build_pruned_many_with_a_step_equals_a_loop(log_n):
    """The batched trees and steps (a collapse's, or for 8 leaves or fewer
    one batched transcript call) == `build_pruned` of each blob with its own
    step."""
    rng = np.random.default_rng(log_n)
    B = 2 if log_n == 13 else 3
    cols, seeds = rand(rng, (B, 4, 1 << log_n), P), rand(rng, (B, 2))
    step = channel_ops.ChannelStep(channel_ops.new_state("cpu", B), seeds, torch.zeros((B, 4), dtype=torch.int32))
    trees, roots = tm.build_pruned_many(cols, step)
    for b in range(B):
        one = channel_ops.ChannelStep(channel_ops.new_state("cpu"), seeds[b], torch.zeros(4, dtype=torch.int32))
        tree = tm.build_pruned(cols[b], step=one)
        assert torch.equal(trees[b].flat, tree.flat) and trees[b].offsets == tree.offsets
        assert torch.equal(roots[b], tree.root.reshape(8))
        assert torch.equal(step.state[b], one.state) and torch.equal(step.alpha[b], one.alpha)


def test_open_queries_of_a_batch_equals_a_loop():
    """merkle_open_queries over (B, 4, 2^L) layers with `build_pruned_many`'s
    trees and (B, nq) words, into the rows of a wider tensor (a batch's
    packed vectors): each row == the one-proof call."""
    rng = np.random.default_rng(3)
    B, n, T, nq = 3, 7, 3, 5
    cols = [rand(rng, (B, 4, 1 << (n - t)), P) for t in range(T)]
    trees = [tm.build_pruned_many(c)[0] for c in cols]
    words = rand(rng, (B, nq), 1 << n)
    words[1, -1] = words[1, 0]  # a repeated draw
    n_words = merkle_ops.open_queries_words([n - t for t in range(T)], nq)
    packed = torch.full((B, 10 + n_words), -1, dtype=torch.int32)
    got = merkle_ops.merkle_open_queries(cols, trees, words, packed[:, 10:])
    assert torch.equal(got, packed[:, 10:]) and (packed[:, :10] == -1).all()
    assert torch.equal(got, narrow(merkle_ops.merkle_open_queries_plain(cols, trees, words)))
    for b in range(B):
        assert torch.equal(got[b], merkle_ops.merkle_open_queries([c[b] for c in cols], [t[b] for t in trees],
                                                                  words[b]))
    work = merkle_ops.open_queries_work(trees, to_numpy_u32(words))
    singles = [merkle_ops.open_queries_work([t[b] for t in trees], to_numpy_u32(words[b])) for b in range(B)]
    assert work == tuple(sum(w) for w in zip(*singles))


def test_open_queries_checks_a_batch():
    """A batch's trees must be the rows of one tensor at one stride, its
    columns (B, 4, 2^L), its words (B, nq), and it reads whole layers
    only."""
    rng = np.random.default_rng(4)
    cols = rand(rng, (3, 4, 1 << 6), P)
    trees, _ = tm.build_pruned_many(cols)
    words = rand(rng, (3, 4), 1 << 6)
    apart = [tm.build_pruned(cols[b]) for b in range(3)]  # three tensors
    with pytest.raises(ValueError, match="rows of one tensor"):
        merkle_ops.merkle_open_queries([cols], [apart], words)
    with pytest.raises(ValueError):
        merkle_ops.merkle_open_queries([cols[:2]], [trees], words)
    with pytest.raises(ValueError):
        merkle_ops.merkle_open_queries([cols], [trees], words[0])
    with pytest.raises(ValueError, match="single layers"):
        merkle_ops.merkle_open_queries([cols, cols[0]], [trees, trees[0]], words)
    with pytest.raises(ValueError):
        merkle_ops.merkle_open_queries([cols], [trees], words, torch.empty((3, 10), dtype=torch.int32))


# ---------------------------------------------------------------------------
# prove_many_sharded's route, the memory split, the lease and the one fetch
# ---------------------------------------------------------------------------

DATAS = [synthetic_data(512, k) for k in range(5)]
SEEDS = [3, 1, 4, 1, 5]
CFG = PcsConfig(pow_bits=2, fri_config=FriConfig(2, 0, 3))


@pytest.fixture(scope="module")
def looped() -> list:
    """commit_and_prove of each blob of DATAS: wire bytes."""
    from frieda_tpu_torch import api

    return [api.commit_and_prove(d, s, CFG, device="cpu")[1].to_bytes() for d, s in zip(DATAS, SEEDS)]


def spy(monkeypatch) -> list:
    """The blob counts of every `commit_phase` call from now on."""
    calls, inner = [], fri.commit_phase

    def counted(words, *args, **kwargs):
        calls.append(words.shape[0])
        return inner(words, *args, **kwargs)

    monkeypatch.setattr(fri, "commit_phase", counted)
    return calls


@pytest.mark.parametrize("shape", [(2, 4), (4, 1), (1, 1)])
def test_prove_many_sharded_on_one_device_is_one_batch(monkeypatch, looped, shape):
    """A mesh whose shards all lie on one device proves the whole batch as
    two batched commit phases (3 + 2 blobs; one for one blob); the proofs
    == a loop of commit_and_prove, and the frozen case's bytes at its
    shape."""
    calls = spy(monkeypatch)
    mesh = sharding.make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    out = sharding.prove_many_sharded(DATAS, SEEDS, CFG, mesh)
    assert [p.to_bytes() for _, p in out] == looped and calls == [3, 2]
    datas, seeds, cfg, _ = blobs_of("dryrun_960B")
    got = sharding.prove_many_sharded(datas[:1], seeds[:1], cfg, mesh)
    assert got[0][1].to_bytes().hex() == CASES["dryrun_960B"]["wire_hex"] and calls == [3, 2, 1]


@pytest.mark.parametrize("shape,devices", [
    ((2, 2), ["cpu", "cpu:0", "cpu", "cpu:0"]),  # each row over two devices: several blocks a row
    ((2, 4), ["cpu"] * 4 + ["cpu:0"] * 4),  # one device a row, as one card a row: one block a row
], ids=["rows_over_two_devices", "one_device_a_row"])
def test_prove_many_sharded_over_several_devices_stays_per_blob(monkeypatch, looped, shape, devices):
    """A mesh over several devices ("cpu" and "cpu:0" stand for two) keeps
    the per-blob element-sharded path (`prove_many_per_blob`): no batched
    commit phase, a `dispatch_blobs` of one blob for each blob, on its row;
    the proofs == the loop of commit_and_prove and the frozen case's
    bytes."""
    calls, rows, dispatch = spy(monkeypatch), [], fri.dispatch_blobs

    def counted(datas, log_total, seeds, pcs_config, device, mesh=None, row=0):
        rows.append((len(datas), row))
        return dispatch(datas, log_total, seeds, pcs_config, device, mesh, row)

    monkeypatch.setattr(fri, "dispatch_blobs", counted)
    mesh = sharding.make_mesh(*shape, devices=devices)
    out = sharding.prove_many_sharded(DATAS, SEEDS, CFG, mesh)
    assert [p.to_bytes() for _, p in out] == looped and calls == [] and rows == [(1, r) for r in (0, 0, 0, 1, 1)]
    datas, seeds, cfg, _ = blobs_of("dryrun_960B")
    got = sharding.prove_many_sharded(datas[:2], seeds[:2], cfg, mesh)
    assert got[0][1].to_bytes().hex() == CASES["dryrun_960B"]["wire_hex"] and calls == []
    assert got[1][1].to_bytes() == fri.commit_and_generate_proof(datas[1], seeds[1], cfg, "cpu")[1].to_bytes()


def test_one_device_names_a_card_once(monkeypatch):
    """`prove_many_sharded` takes the batch where every shard lies on one
    device: "cuda" and "cuda:0" are one card (the current one; the mesh
    names a bare "cuda" with its index), "cpu" and "cpu:0" stay two, and a
    process group is never one device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert sharding._one_device(Mesh(1, 2, ["cuda", "cuda:0"])) == torch.device("cuda", 0)
    assert sharding._one_device(Mesh(1, 2, ["cuda:0", "cuda:1"])) is None
    assert sharding._one_device(Mesh(1, 2, ["cpu", "cpu:0"])) is None
    assert sharding._one_device(Mesh(1, 2, ["cpu", "cpu"])) == torch.device("cpu")
    grouped = Mesh(1, 2, ["cpu", "cpu"])
    grouped.group = object()
    assert sharding._one_device(grouped) is None


def test_a_batch_larger_than_the_budget_runs_in_parts(monkeypatch, looped):
    """With the device's memory made small, `safe_batch` is the largest B
    whose instance and warm-up fit MEMORY_SHARE, and the batch runs as
    consecutive batched commit phases of half that many blobs (two in
    flight hold at most the share); the bytes do not change."""
    domain = 1 << (log_total_for(512) - 2 + 2)
    per_blob = (fri.RESIDENT_BYTES_PER_ELEMENT + fri.ACTIVE_BYTES_PER_ELEMENT) * domain
    monkeypatch.setattr(fri, "device_memory_bytes", lambda device: int(2.5 * per_blob / fri.MEMORY_SHARE) + 1)
    assert fri.safe_batch(log_total_for(512) - 2, CFG.fri_config, torch.device("cpu")) == 2
    calls = spy(monkeypatch)
    mesh = sharding.make_mesh(1, 2, devices=["cpu"] * 2)
    out = sharding.prove_many_sharded(DATAS, SEEDS, CFG, mesh)
    assert [p.to_bytes() for _, p in out] == looped and calls == [1, 1, 1, 1, 1]
    monkeypatch.setattr(fri, "device_memory_bytes", lambda device: 0)
    assert fri.safe_batch(8, CFG.fri_config, torch.device("cpu")) == 1


def test_safe_batch_of_an_80_gib_card(monkeypatch):
    """8 x 2^20 felts at blowup 2^4 fit one batch on an 80 GiB card."""
    monkeypatch.setattr(fri, "device_memory_bytes", lambda device: 80 << 30)
    fc = FriConfig(4, 0, 64)
    want = int(0.6 * (80 << 30)) // ((fri.RESIDENT_BYTES_PER_ELEMENT + fri.ACTIVE_BYTES_PER_ELEMENT) << 24)
    assert fri.safe_batch(20, fc, torch.device("cuda")) == want >= 8


class CpuBatchGraph(fri._Instance):
    """A stand-in for a batch's `fri._CommitGraph` on the CPU: static (B, nw)
    words, and a run that is the eager batched commit phase over them,
    leased as a replay's is (every row)."""

    def __init__(self, log_total: int, pcs_config, batch: int):
        self.log_total, self.pcs_config = log_total, pcs_config
        self.words = torch.zeros((batch, fri.words_for(log_total)), dtype=torch.int32)
        self.runs = 0

    def run(self, seeds):
        self.runs += 1
        out = fri.commit_phase(self.words, self.log_total, seeds, self.pcs_config)
        for c in out:
            self.lend(c)
        return out


def test_a_batch_holds_its_instance_until_its_last_proof(monkeypatch, looped):
    """dispatch_blobs through a cached instance: one instance a batch size,
    leased until every one of its Committeds is finished (or collected);
    the first finish fetches the whole batch in one copy, the others read
    that copy."""
    cache = fri._GraphCache(8)
    monkeypatch.setattr(fri, "_commit_graph", lambda log_total, cfg, has_seed, device, blobs, *mesh: cache.instance(
        (log_total, has_seed, blobs), lambda warm: CpuBatchGraph(log_total, cfg, blobs)))
    fetches, inner = [], fri.to_numpy_u32
    monkeypatch.setattr(fri, "to_numpy_u32", lambda t: fetches.append(tuple(t.shape)) or inner(t))
    log_total = log_total_for(512)
    committed = fri.dispatch_blobs(DATAS[:3], log_total, SEEDS[:3], CFG, "cpu")
    (_, (inst,), _), = cache.keys.values()
    assert not inst.free and inst.runs == 1
    assert fri.finish_proof(committed[1], log_total, CFG)[1].to_bytes() == looped[1]
    assert fetches == [(3, committed[0].layout.total)] and not inst.free
    assert fri.finish_proof(committed[0], log_total, CFG)[1].to_bytes() == looped[0]
    assert not inst.free and len(fetches) == 1
    again = fri.dispatch_blobs(DATAS[:3], log_total, SEEDS[:3], CFG, "cpu")  # a second instance
    assert len(cache.keys[(log_total, True, 3)][1]) == 2
    assert fri.finish_proof(committed[2], log_total, CFG)[1].to_bytes() == looped[2]
    assert inst.free and len(fetches) == 1
    del again
    gc.collect()
    assert all(i.free for i in cache.keys[(log_total, True, 3)][1])
    mesh = sharding.make_mesh(1, 1, devices=["cpu"])
    out = sharding.prove_many_sharded(DATAS[:3] * 2, SEEDS[:3] * 2, CFG, mesh)  # two dispatches of 3 blobs
    insts = cache.keys[(log_total, True, 3)][1]
    assert [p.to_bytes() for _, p in out] == looped[:3] * 2 and inst.runs == 2  # a free instance runs again
    assert len(insts) == 2 and insts[0] is inst and insts[1].runs == 2  # the other dispatch takes the other


def test_batch_errors_equal_the_jax_packages():
    """Seeds mixed None and set, blobs of two padded sizes, and seed counts
    raise ValueError with the JAX package's messages (checked before any
    work on either side)."""
    jmesh = jsharding.make_mesh(1, 1, devices=jax.devices()[:1])
    mesh = sharding.make_mesh(1, 1, devices=["cpu"])
    jcfg = JPcsConfig.from_dict(CASES["dryrun_960B"]["config"])
    cfg = PcsConfig.from_dict(CASES["dryrun_960B"]["config"])
    for datas, seeds in (([b"a" * 100, b"b" * 100], [1, None]), ([b"a" * 100, b"b" * 1000], [1, 2]),
                         ([b"a" * 100], [1, 2])):
        with pytest.raises(ValueError) as jerr:
            jsharding.prove_many_sharded(datas, seeds, jcfg, jmesh)
        with pytest.raises(ValueError) as err:
            sharding.prove_many_sharded(datas, seeds, cfg, mesh)
        assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="all None or all set"):
        fri.commit_phase(torch.zeros((2, fri.words_for(3)), dtype=torch.int32), 3, [1, None], cfg)
    with pytest.raises(ValueError, match="all None or all set"):
        fri.dispatch_blobs([b"a", b"b"], 3, [None, 2], cfg, "cpu")
    with pytest.raises(ValueError, match="3 blobs but 2 seeds"):
        fri.dispatch_blobs([b"a", b"b", b"c"], 3, [1, 2], cfg, "cpu")
