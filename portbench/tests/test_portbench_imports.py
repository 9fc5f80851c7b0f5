"""What the benchmark imports: no module under the folder imports JAX or
the JAX package, and the reference imports nothing of the port. Each
import's top-level name (the part before the first dot) is compared
whole: the port's name begins with the JAX package's."""

import ast
import os

import pytest

from conftest import BASE

FORBIDDEN = {"jax", "jaxlib", "flax", "chromap_tpu"}


def modules():
    for d, _, names in os.walk(BASE):
        if "_data" in d.split(os.sep):
            continue
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, BASE))
def test_no_jax(path):
    assert not set(top_names(path)) & FORBIDDEN


def test_reference_takes_nothing_of_the_port():
    ref = os.path.join(BASE, "reference")
    for n in os.listdir(ref):
        if n.endswith(".py"):
            names = set(top_names(os.path.join(ref, n)))
            assert not names & (FORBIDDEN | {"chromap_tpu_torch",
                                             "portbench", "torch"}), n


def test_top_names_compare_whole():
    assert "chromap_tpu_torch" not in FORBIDDEN
    assert "chromap_tpu_torch".split(".")[0] != "chromap_tpu"
