"""The port stands alone: importing it loads neither jax nor frieda_tpu (the
machine with the card has no jax), and a CUDA request never falls back to
the CPU."""

import pytest

pytest.importorskip("torch")

import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from frieda_tpu_torch import api  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import sys
import frieda_tpu_torch, frieda_tpu_torch.api, frieda_tpu_torch.config
import frieda_tpu_torch.ops, frieda_tpu_torch.ops.fft, frieda_tpu_torch.ops.ingest
import frieda_tpu_torch.ops.merkle, frieda_tpu_torch.ops._build
import frieda_tpu_torch.ops.channel, frieda_tpu_torch.ops.fri, frieda_tpu_torch.core.device_channel
import frieda_tpu_torch.utils.convert, frieda_tpu_torch.utils.profiling, frieda_tpu_torch.core.circle
import frieda_tpu_torch.core.channel, frieda_tpu_torch.core.grind
import frieda_tpu_torch.core.proof, frieda_tpu_torch.core.fri
import frieda_tpu_torch.core.npfield, frieda_tpu_torch.core.merkle, frieda_tpu_torch.native
from frieda_tpu_torch.api import commit_many, commit_with_tree, prove_many, verify, verify_many
from frieda_tpu_torch.core.merkle import CommitTree, build_tree, device_levels, host_levels_from
import frieda_tpu_torch.parallel.mesh, frieda_tpu_torch.parallel.sharding
import frieda_tpu_torch.parallel.fft_sharded, frieda_tpu_torch.parallel.multihost
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "frieda_tpu"))
print(",".join(loaded))
"""


def test_import_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == ""


def test_cuda_commit_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.commit(b"x", 4, device="cuda")


def test_commit_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.commit(b"x", 4)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_cuda_prove_many_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.prove_many([b"x"], [1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.prove_many([b"x"], [1], device="cuda")


def test_cuda_commit_many_and_commit_with_tree_without_cuda_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: api.commit_many([b"x", b"y"], 4), lambda: api.commit_many([], 4),
                 lambda: api.commit_with_tree(b"x", 4, device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_unknown_device_rejected():
    with pytest.raises(ValueError):
        api.commit(b"x", 4, device="meta")
