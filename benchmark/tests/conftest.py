"""Fixtures of the benchmark's own tests.

``gpu`` marks a test that needs a CUDA card; the ``card`` fixture skips it
where there is none (decided when the test runs, never at import). The
``tiny`` fixture gives cells of the benchmark at a size the CPU runs in
seconds (``tree.make_tree``).
"""

from __future__ import annotations

import pytest
import torch

from benchmark import registry
from benchmark.tests.tree import make_tree


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs only on one")
    return torch.device("cuda:0")


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """name -> the tiny cell of that name."""
    root, here, bench = make_tree(str(tmp_path_factory.mktemp("tree")))
    return lambda name: registry.cell(name, root=root, here=here,
                                      bench=bench)
