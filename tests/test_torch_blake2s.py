"""Port's zero-state raw BLAKE2s compression (plain version) vs the spec
oracle and the JAX package. Tolerance: exact equality.

The JAX side runs `core.blake2s.compress_rows` (a jnp fori-loop), not the
Pallas kernels: interpret mode over the unrolled compression takes XLA-CPU
tens of minutes to compile."""

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from frieda_tpu.core import blake2s as jb  # noqa: E402
from frieda_tpu.spec import blake2s as sb  # noqa: E402
from frieda_tpu_torch.core import blake2s as tb  # noqa: E402
from frieda_tpu_torch.utils.convert import from_numpy_u32, to_numpy_u32, widen  # noqa: E402

torch.set_num_threads(1)

P = (1 << 31) - 1


def _messages(kind: str) -> np.ndarray:
    rng = np.random.default_rng(5)
    if kind == "random":
        return rng.integers(0, 1 << 32, (16, 300), dtype=np.uint64).astype(np.uint32)
    msg = np.zeros((16, 300), np.uint32)  # Merkle leaf: 4 felts + 12 zero words
    msg[:4] = rng.integers(0, P, (4, 300), dtype=np.uint32)
    msg[:4, 0] = 0  # the all-zero leaf
    msg[:4, 1] = P - 1
    return msg


@pytest.mark.parametrize("kind", ["random", "leaf"])
def test_compress_rows_matches_spec_and_jax(kind):
    msg = _messages(kind)
    got = to_numpy_u32(tb.compress_rows(widen(from_numpy_u32(msg, "cpu"))))
    assert np.array_equal(got, sb.compress_batch(msg))
    assert np.array_equal(got, np.asarray(jb.compress_rows(jnp.asarray(msg))))


def test_compress_rows_scalar_oracle():
    msg = _messages("random")[:, :3]
    got = to_numpy_u32(tb.compress_rows(widen(from_numpy_u32(msg, "cpu"))))
    for i in range(3):
        assert list(got[:, i]) == sb.raw_compress([int(w) for w in msg[:, i]])


def test_constants_match_jax():
    assert tb.IV == jb.IV and tb.SIGMA == jb.SIGMA and tb.G_INDICES == jb.G_INDICES
