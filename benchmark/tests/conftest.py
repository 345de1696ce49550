"""The benchmark's tests: ``python -m pytest benchmark/tests`` from the repo
root. Tests that need the card carry the ``card`` marker and skip inside
the test when there is none."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import tiny  # noqa: E402

tiny.import_harness()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without "
        "one")


@pytest.fixture
def tiny_root(tmp_path):
    """A tiny copy of the benchmark (``tiny.make_tiny``)."""
    return tiny.make_tiny(str(tmp_path))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
