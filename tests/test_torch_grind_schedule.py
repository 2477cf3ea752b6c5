"""The `grind` kernel's schedule (`frieda_tpu_torch/csrc/channel.cu`), played
on the CPU: blocks claim items of `ops.channel.grind_plan` in its item order
(`GrindPlan.item`) from one counter, skip an item whose base is at or above
its blob's best when claimed, exit once a skipped round's base is at or above
every blob's best, and hash their k nonces a thread in increasing order,
each thread stopping at its first hit (min into the blob's best). A seeded
random scheduler interleaves the blocks' steps (a claim, an exit check, one
warp's j-th nonces), so that bests fall while other blocks hold items.

This checks the schedule's argument (every nonce below a blob's final best is
hashed, so the best is the blob's minimum), not the CUDA kernel: the kernel
itself is held to `grind_plain` on the card by chip_smoke.py phases 3 and 14.
Each blob's result is held to the plain sweep (`ops.channel.grind_plain`) and
to the JAX package's `dc_grind` (under `jax.vmap`, as its batched commit
phase runs it) for B = 1, 3, 8 and 33 at pow_bits 0-8. The hash is hashlib's
BLAKE2s-256 of digest || nonce_le8, the channel's mix (checked against the
host channel). Tolerance: exact equality (integer search)."""

import hashlib

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from frieda_tpu.core import device_channel as jdc  # noqa: E402
from frieda_tpu_torch.core.channel import Blake2sChannel  # noqa: E402
from frieda_tpu_torch.ops import channel as channel_ops  # noqa: E402
from frieda_tpu_torch.utils.convert import from_numpy_u32, to_numpy_u32  # noqa: E402

torch.set_num_threads(1)

BLOBS = (1, 3, 8, 33)
POW_BITS = tuple(range(9))
WARP = 32
# (blocks, k) of the plans played besides the default plan over 2 SMs that
# hold 4 blocks each (k = GRIND_NONCES): other grids and items.
PLANS = ((2, 1), (6, 2))
ORDERS = 2  # seeded claim orders a (B, pow_bits, plan)


@pytest.fixture(scope="module")
def channels():
    """33 channel states (a fresh batch mixed with seeded words, the CPU
    transcript), their digests as bytes, and each blob's minimum nonce at
    pow_bits 0-8 from the plain sweep (`grind_plain` of the (33, 9) state)
    and from the JAX package's dc_grind under jax.vmap (one jit); the
    smaller batches are the first B of these blobs."""
    rng = np.random.default_rng(16)
    state = channel_ops.new_state("cpu", max(BLOBS))
    channel_ops.transcript(state, mix_u64=from_numpy_u32(
        rng.integers(0, 1 << 32, (max(BLOBS), 2), dtype=np.uint64).astype(np.uint32), "cpu"))
    words = to_numpy_u32(state[:, :8])
    grinds = jax.jit(lambda d: jnp.stack([jax.vmap(lambda x: jdc.dc_grind(x, p, batch=512))(d)
                                          for p in POW_BITS]))
    jax_nonces = np.asarray(grinds(jnp.asarray(words))).astype(np.int64)
    plain = [channel_ops.grind_plain(state, p).view(torch.int64).view(-1).tolist() for p in POW_BITS]
    return [w.astype("<u4").tobytes() for w in words], plain, jax_nonces


class Zeros:
    """Trailing zeros of the first 16 bytes (a u128, little-endian) of
    BLAKE2s-256(digest || nonce_le8) for nonces 0, 1, ..., grown on demand."""

    def __init__(self, digest: bytes):
        self.digest, self.tz = digest, np.zeros(0, np.int64)

    def __call__(self, nonces: np.ndarray) -> np.ndarray:
        top = int(nonces.max()) + 1
        if top > len(self.tz):
            grow = [int.from_bytes(hashlib.blake2s(self.digest + n.to_bytes(8, "little")).digest()[:16], "little")
                    for n in range(len(self.tz), max(top, 2 * len(self.tz)))]
            self.tz = np.concatenate([self.tz, [(h & -h).bit_length() - 1 if h else 128 for h in grow]])
        return self.tz[nonces]


def play(plan: channel_ops.GrindPlan, zeros: list, pow_bits: int, rng) -> tuple:
    """Run the kernel's schedule with plan.blocks blocks under a random
    scheduler; returns (each blob's best, each blob's hashed nonces as a
    mask)."""
    blobs = len(zeros)
    best = [(1 << 64) - 1] * blobs
    counter = [(1 << 64) - 1]
    hashed = [np.zeros(1 << 12, bool) for _ in range(blobs)]

    def block():
        while True:
            counter[0] = (counter[0] + 1) % (1 << 64)  # atomicAdd(counter, 1) + 1
            blob, base = plan.item(counter[0], blobs)
            if base >= best[blob]:  # skipped at the claim
                yield
                if all(base >= b for b in best):  # the exit check, reading every best
                    return
                continue
            # the item: each warp's nonces j = 0 .. k-1 in order, warps interleaved
            stopped = np.zeros(plan.threads, bool)
            turns = [w for w in range(plan.threads // WARP) for _ in range(plan.nonces)]
            rng.shuffle(turns)
            next_j = [0] * (plan.threads // WARP)
            for w in turns:
                yield
                j, next_j[w] = next_j[w], next_j[w] + 1
                lanes = np.arange(w * WARP, (w + 1) * WARP)
                lanes = lanes[~stopped[lanes]]
                if not len(lanes):
                    continue
                nonces = base + j * plan.threads + lanes
                if nonces[-1] >= len(hashed[blob]):
                    hashed[blob] = np.concatenate([hashed[blob], np.zeros(2 * int(nonces[-1]), bool)])
                hashed[blob][nonces] = True
                hit = zeros[blob](nonces) >= pow_bits
                if hit.any():
                    best[blob] = min(best[blob], int(nonces[hit].min()))  # atomicMin, each hit
                    stopped[lanes[hit]] = True

    running = [block() for _ in range(plan.blocks)]
    while running:
        i = int(rng.integers(len(running)))
        try:
            next(running[i])
        except StopIteration:
            running.pop(i)
    return best, hashed


def test_hash_is_the_channel_mix(channels):
    """hashlib's BLAKE2s of digest || nonce_le8 is the host channel's
    mix_u64, and `Zeros` its trailing zeros."""
    digests, _, _ = channels
    for digest, nonce in zip(digests[:4], (0, 5, 1000, (1 << 64) - 1)):
        host = Blake2sChannel()
        host.digest = digest
        host.mix_u64(nonce)
        assert host.digest == hashlib.blake2s(digest + nonce.to_bytes(8, "little")).digest()
        if nonce < 1 << 16:
            assert int(Zeros(digest)(np.array([nonce]))[0]) == host.trailing_zeros()


@pytest.mark.parametrize("blobs", BLOBS)
def test_schedule_finds_each_blobs_minimum(channels, blobs):
    """Every played order gives each blob the plain sweep's and the JAX
    package's minimum, having hashed every nonce below it; pow_bits 0 gives
    nonce 0 to every blob."""
    digests, plain, jax_nonces = channels
    rng = np.random.default_rng(blobs)
    zeros = [Zeros(d) for d in digests[:blobs]]
    for pow_bits in POW_BITS:
        want = plain[pow_bits][:blobs]
        assert want == jax_nonces[pow_bits, :blobs].tolist()
        if pow_bits == 0:
            assert want == [0] * blobs
        plans = [channel_ops.grind_plan(blobs, sms=2, blocks_per_sm=4)]
        plans += [channel_ops.GrindPlan(blocks, channel_ops.GRIND_THREADS, k) for blocks, k in PLANS]
        for plan in plans:
            for _ in range(ORDERS):
                best, hashed = play(plan, zeros, pow_bits, rng)
                assert best == want, (plan, pow_bits)
                assert all(h[:n].all() for n, h in zip(want, hashed)), (plan, pow_bits)


def test_plan_and_item_order():
    """GRIND_BLOCKS_PER_BLOB blocks an SM a channel, at most what an SM
    holds; k = GRIND_NONCES, W = threads x k; items round-major: item i is
    blob i mod B of round i // B."""
    per_blob = channel_ops.GRIND_BLOCKS_PER_BLOB
    assert channel_ops.grind_plan(1, sms=132, blocks_per_sm=64).blocks == 132 * per_blob
    assert channel_ops.grind_plan(2, sms=132, blocks_per_sm=64).blocks == 132 * 2 * per_blob
    plan = channel_ops.grind_plan(3, sms=132, blocks_per_sm=4)
    assert plan == (528, channel_ops.GRIND_THREADS, channel_ops.GRIND_NONCES)
    assert plan.width == channel_ops.GRIND_THREADS * channel_ops.GRIND_NONCES
    w = plan.width
    assert [plan.item(i, 3) for i in range(7)] == [(0, 0), (1, 0), (2, 0), (0, w), (1, w), (2, w), (0, 2 * w)]
    assert plan.item(5, 1) == (0, 5 * w)


@pytest.mark.parametrize("kwargs", [dict(blobs=0), dict(blobs=-1), dict(sms=0), dict(blocks_per_sm=0)])
def test_plan_rejects_bad_arguments(kwargs):
    args = dict(blobs=2, sms=4, blocks_per_sm=2) | kwargs
    with pytest.raises(ValueError):
        channel_ops.grind_plan(**args)


@pytest.mark.parametrize("shape, words", [((2, 9), 2), ((2, 9), 4), ((9,), 2)])
def test_launch_rejects_bad_buffers(shape, words):
    """The launch's (B + 1,) int64 buffer and (B, 9) states, checked before
    any kernel is built or launched."""
    state = torch.zeros(shape, dtype=torch.int32)
    with pytest.raises(ValueError):
        channel_ops.grind_launch(state, 4, channel_ops.grind_buffer(words, "cpu")[:words],
                                 channel_ops.grind_plan(2, sms=1, blocks_per_sm=1))
