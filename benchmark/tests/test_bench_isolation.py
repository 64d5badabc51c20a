"""Nothing of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program: top-level module names compared
whole (the port's name begins with the JAX package's)."""

import ast
import glob
import os
import sys

import pytest

from benchmark import registry, run

JAX_SIDE = {"jax", "jaxlib", "flax", "planetmodel_sph_tpu"}
PORT = "planetmodel_sph_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(glob.glob(os.path.join(registry.HERE, "**", "*.py"),
                           recursive=True))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, registry.HERE)
                              for p in SOURCES])
def test_no_jax_import(path):
    assert not set(_imports(path)) & JAX_SIDE


REFERENCE = sorted(glob.glob(os.path.join(registry.HERE, "reference",
                                          "*.py")))


@pytest.mark.parametrize("path", REFERENCE,
                         ids=[os.path.basename(p) for p in REFERENCE])
def test_reference_imports_nothing_of_the_program(path):
    names = set(_imports(path))
    assert PORT not in names and not names & JAX_SIDE
    text = open(path).read()
    assert "benchmark.program" not in text and "from .." not in text


def test_whole_name_comparison(monkeypatch):
    """The port's own name is no match; the JAX package's is."""
    monkeypatch.setitem(sys.modules, PORT, sys.modules[__name__])
    assert run.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & JAX_SIDE)
    assert PORT not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "planetmodel_sph_tpu.config",
                        sys.modules[__name__])
    assert "planetmodel_sph_tpu" in run.forbidden_modules()
