"""The channel step that rides on `merkle_collapse` (`ops.merkle.merkle_collapse(...,
step=ops.channel.ChannelStep(state, seed, alpha))`: mix the seed, mix the root,
draw alpha at the end of the launch that ends a prover's tree), its plain
version on the CPU against a plain collapse followed by `transcript_plain`,
against the JAX package's device channel (`frieda_tpu.core.device_channel`:
dc_mix_u64 -> dc_mix_digest -> dc_draw_felt(digest, 0) on the JAX root, as
`frieda_tpu/core/fri.py`'s commit function runs them) and against the host
channel; the retry of the draw under a lowered `DRAW_BOUND`; the wrapper's
errors; trees that end without a collapse (one `transcript` call); and the
frozen proofs' bytes through the changed commit phase, with its transcript
calls and steps counted. Inputs are seeded numpy arrays; tolerance: exact
equality (hashes and integer arithmetic)."""

import pytest

pytest.importorskip("torch")

import json  # noqa: E402
import pathlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import synthetic_data  # noqa: E402
from frieda_tpu.core import device_channel as jdc  # noqa: E402
from frieda_tpu.core import merkle as jm  # noqa: E402
from frieda_tpu_torch.config import PcsConfig  # noqa: E402
from frieda_tpu_torch.core import device_channel as dc  # noqa: E402
from frieda_tpu_torch.core import fri  # noqa: E402
from frieda_tpu_torch.core import merkle as tm  # noqa: E402
from frieda_tpu_torch.core.channel import Blake2sChannel  # noqa: E402
from frieda_tpu_torch.ops import channel as channel_ops  # noqa: E402
from frieda_tpu_torch.ops import merkle as merkle_ops  # noqa: E402
from frieda_tpu_torch.utils.convert import from_numpy_u32, narrow, to_numpy_u32, widen  # noqa: E402
from frieda_tpu_torch.utils.packing import log_total_for, pad_to_words  # noqa: E402

torch.set_num_threads(1)

P = (1 << 31) - 1
CASES = json.loads((pathlib.Path(__file__).parent / "data" / "frozen_proofs.json").read_text())


def _u32(rng, shape, hi=1 << 32) -> np.ndarray:
    return rng.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32)


def _inputs(m: int, with_seed: bool, seed: int = 0):
    """(level (8, m), state (9,), seed words (2,) or None) as numpy u32: a
    random digest and n_sent, as a channel mid-proof holds."""
    rng = np.random.default_rng(1000 * m + 2 * seed + with_seed)
    state = _u32(rng, 9)
    state[8] = rng.integers(0, 50)
    return _u32(rng, (8, m)), state, _u32(rng, 2) if with_seed else None


def _step(state: np.ndarray, seed) -> channel_ops.ChannelStep:
    return channel_ops.ChannelStep(from_numpy_u32(state, "cpu"),
                                   None if seed is None else from_numpy_u32(seed, "cpu"),
                                   torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("with_seed", [False, True], ids=["root", "seed+root"])
@pytest.mark.parametrize("m", [2, 16, 256, 512, 4096])
def test_collapse_step_matches_collapse_then_transcript_and_jax(m, with_seed):
    """Widths 2 ... 256 collapse in one block, 512 and 4096 in a cluster (2
    and 16 blocks): the step is the same at every plan."""
    assert merkle_ops.collapse_plan(m) == {512: 2, 4096: 16}.get(m, 1)
    level, state, seed = _inputs(m, with_seed)
    widths = tm.tail_widths(m)
    step = _step(state, seed)
    before = (merkle_ops.merkle_collapse.launches, merkle_ops.merkle_collapse.steps,
              channel_ops.transcript.launches)
    outs = merkle_ops.merkle_collapse(from_numpy_u32(level, "cpu"), widths, step=step)
    # the CPU runs the plain version: no launch, no step, no transcript launch counted
    assert before == (merkle_ops.merkle_collapse.launches, merkle_ops.merkle_collapse.steps,
                      channel_ops.transcript.launches)

    plain = [narrow(o) for o in merkle_ops.merkle_collapse_plain(widen(from_numpy_u32(level, "cpu")), widths)]
    assert len(outs) == len(plain) and all(torch.equal(g, w) for g, w in zip(outs, plain))
    want_state = from_numpy_u32(state, "cpu")
    want_alpha, _ = channel_ops.transcript_plain(
        want_state, mix_u64=None if seed is None else from_numpy_u32(seed, "cpu"),
        mix_digest=plain[-1].reshape(8), draw_felt=True)
    assert torch.equal(step.state, want_state) and torch.equal(step.alpha, want_alpha)

    root = jm.host_levels_from(level)[-1][:, 0]
    digest = jnp.asarray(state[:8])
    if seed is not None:
        digest = jdc.dc_mix_u64(digest, jnp.uint32(seed[0]), jnp.uint32(seed[1]))
    digest = jdc.dc_mix_digest(digest, jnp.asarray(root))
    alpha, n_sent = jdc.dc_draw_felt(digest, jnp.uint32(0))
    assert np.array_equal(to_numpy_u32(outs[-1]).reshape(8), root)
    assert np.array_equal(to_numpy_u32(step.alpha), np.asarray(alpha, np.uint32))
    assert np.array_equal(to_numpy_u32(step.state[:8]), np.asarray(digest, np.uint32))
    assert int(step.state[8]) == int(n_sent) == 1


@pytest.mark.parametrize("m", [2, 4096])
def test_collapse_step_retries_under_a_lowered_bound(m, monkeypatch):
    """No natural input retries (~2^-28 a draw); with `DRAW_BOUND` lowered,
    the step draws again, as the host channel under the same bound does."""
    bound = 3 << 30
    monkeypatch.setattr(dc, "DRAW_BOUND", bound)
    level, _, seed = _inputs(m, True, seed=7)
    state = np.zeros(9, np.uint32)  # a fresh channel, as the host's
    step = _step(state, seed)
    outs = merkle_ops.merkle_collapse(from_numpy_u32(level, "cpu"), (1,), step=step)
    host = Blake2sChannel()
    host.mix_u64(int(seed[0]) | int(seed[1]) << 32)
    host.mix_digest(to_numpy_u32(outs[-1]).reshape(8).astype("<u4").tobytes())
    while True:
        raw = host.draw_random_bytes()
        words = [int.from_bytes(raw[4 * i : 4 * i + 4], "little") for i in range(8)]
        if all(w < bound for w in words):
            break
    assert host.n_sent > 1  # the retry was taken
    assert tuple(int(v) for v in to_numpy_u32(step.alpha)) == tuple(w % P for w in words[:4])
    assert to_numpy_u32(step.state[:8]).astype("<u4").tobytes() == host.digest
    assert int(step.state[8]) == host.n_sent


@pytest.mark.parametrize("what", ["batch", "width one", "no root", "int seed", "alpha shape"])
def test_collapse_step_refuses_what_the_kernel_refuses(what):
    level, state, seed = _inputs(16, True)
    x, widths, step = from_numpy_u32(level, "cpu"), (1,), _step(state, seed)
    if what == "batch":
        x = torch.stack([x, x])
    elif what == "width one":
        x = x[:, :1].contiguous()
    elif what == "no root":
        widths = (8, 2)
    elif what == "int seed":
        step = step._replace(seed=7)
    else:
        step = step._replace(alpha=torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        merkle_ops.merkle_collapse(x, widths, step=step)
    assert torch.equal(step.state, from_numpy_u32(state, "cpu"))  # nothing ran


@pytest.mark.parametrize("log_n", [0, 2, 3, 4])
def test_build_pruned_step_with_and_without_a_collapse(log_n, monkeypatch):
    """A tree of 8 leaves or fewer ends at the leaf pass: its step is one
    transcript call; a wider one's rides on its collapse. Both equal a plain
    tree followed by `transcript_plain`."""
    rng = np.random.default_rng(log_n)
    cols = from_numpy_u32(_u32(rng, (4, 1 << log_n), P), "cpu")
    state, seed = _u32(rng, 9), _u32(rng, 2)
    calls = {"transcript": 0, "collapse": 0}
    plain = tm.build_pruned(cols).root
    transcript, collapse = channel_ops.transcript, merkle_ops.merkle_collapse

    def counted_transcript(*args, **kwargs):
        calls["transcript"] += 1
        return transcript(*args, **kwargs)

    def counted_collapse(*args, **kwargs):
        calls["collapse"] += 1
        return collapse(*args, **kwargs)

    monkeypatch.setattr(channel_ops, "transcript", counted_transcript)
    monkeypatch.setattr(merkle_ops, "merkle_collapse", counted_collapse)
    step = _step(state, seed)
    tree = tm.build_pruned(cols, step)
    monkeypatch.undo()
    assert calls == ({"transcript": 0, "collapse": 1} if log_n and log_n != 3 else
                     {"transcript": 1, "collapse": 0})
    assert torch.equal(tree.root, plain)
    want_state = from_numpy_u32(state, "cpu")
    want_alpha, _ = channel_ops.transcript_plain(want_state, mix_u64=from_numpy_u32(seed, "cpu"),
                                                 mix_digest=tree.root.reshape(8), draw_felt=True)
    assert torch.equal(step.state, want_state) and torch.equal(step.alpha, want_alpha)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_frozen_proofs_through_the_commit_phase(case, monkeypatch):
    """The frozen wire bytes through `fri.commit_phase` on the CPU, with 2
    transcript calls a proof plus one a tree of 8 leaves or fewer (the last
    tree of dryrun_960B: blowup 2, last-layer bound 2^0), and every other
    layer's step on its collapse."""
    cfg = PcsConfig.from_dict(case["config"])
    data = synthetic_data(case["data_len"], case["data_seed_offset"])
    log_total = log_total_for(len(data))
    calls = {"transcript": 0, "steps": 0}
    transcript, collapse = channel_ops.transcript, merkle_ops.merkle_collapse

    def counted_transcript(*args, **kwargs):
        calls["transcript"] += 1
        return transcript(*args, **kwargs)

    def counted_collapse(level, widths, step=None):
        calls["steps"] += step is not None
        return collapse(level, widths, step=step)

    monkeypatch.setattr(channel_ops, "transcript", counted_transcript)
    monkeypatch.setattr(merkle_ops, "merkle_collapse", counted_collapse)
    committed = fri.commit_phase(from_numpy_u32(pad_to_words(data, log_total), "cpu")[None], log_total,
                                 [case["seed"]], cfg)[0]
    _, proof = fri.finish_proof(committed, log_total, cfg)
    assert proof.to_bytes().hex() == case["wire_hex"]
    small = sum(tree.log_leaves <= 3 for tree in committed.trees)
    assert small == (case["name"] == "dryrun_960B")
    assert calls == {"transcript": 2 + small, "steps": len(committed.trees) - small}
