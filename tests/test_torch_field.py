"""Port's M31 arithmetic (frieda_tpu_torch.core.field) vs the JAX package and
the spec oracle. Tolerance: exact equality (integer arithmetic)."""

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from frieda_tpu.core import field as jf  # noqa: E402
from frieda_tpu.spec import field as sf  # noqa: E402
from frieda_tpu_torch.core import field as tf  # noqa: E402
from frieda_tpu_torch.utils.convert import from_numpy_u32, to_numpy_u32, widen  # noqa: E402

torch.set_num_threads(1)

P = sf.P
BOUNDARY = np.array(
    [0, 1, 2, 3, P - 1, P - 2, (1 << 30) - 2, (1 << 30) - 1, 1 << 30, (1 << 30) + 1,
     (1 << 31) - 3, (1 << 31) - 2, 12345], dtype=np.uint32,
)


def _vectors():
    rng = np.random.default_rng(31)
    a = np.concatenate([BOUNDARY, rng.integers(0, P, 400, dtype=np.uint32)])
    b = np.concatenate([np.flip(BOUNDARY), rng.integers(0, P, 400, dtype=np.uint32)])
    ga, gb = np.meshgrid(BOUNDARY, BOUNDARY)  # every boundary pair
    return np.concatenate([a, ga.ravel()]), np.concatenate([b, gb.ravel()])


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_m31_op_matches_jax_and_spec(op):
    a, b = _vectors()
    got = to_numpy_u32(getattr(tf, f"m31_{op}")(
        widen(from_numpy_u32(a, "cpu")), widen(from_numpy_u32(b, "cpu"))))
    jax_out = np.asarray(getattr(jf, f"m31_{op}")(jnp.asarray(a), jnp.asarray(b)))
    spec_fn = getattr(sf, f"m31_{op}")
    spec_out = np.array([spec_fn(int(x), int(y)) for x, y in zip(a, b)], np.uint32)
    assert np.array_equal(got, jax_out)
    assert np.array_equal(got, spec_out)


def test_convert_round_trips_all_bit_patterns():
    words = np.array([0, 1, P, 1 << 31, (1 << 32) - 1, 0xDEADBEEF], np.uint32)
    t = from_numpy_u32(words, "cpu")
    assert np.array_equal(to_numpy_u32(t), words)
    assert np.array_equal(to_numpy_u32(widen(t)), words)
    assert widen(t).min().item() >= 0
