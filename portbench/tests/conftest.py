"""The benchmark's own tests: run from the checkout's root with

    python -m pytest portbench/tests -q

They import nothing of the JAX package. Tests that need a CUDA card carry the
`card` marker and skip, deciding in the `card` fixture, where there is none."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the comparison runs on the card")
    return "cuda"
