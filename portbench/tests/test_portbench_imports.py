"""What the benchmark imports: no module under the folder imports JAX or
the JAX package, and neither the reference nor an output check under
`checks/` imports anything of the port (a check may import the
reference). Each import's top-level name (the part before the first dot)
is compared whole: the port's name begins with the JAX package's."""

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


PORT = FORBIDDEN | {"chromap_tpu_torch", "torch"}


def taken_from_port(path):
    """What a check imports of the port, of JAX or of the benchmark other
    than its reference: every name but `portbench.reference` and what is
    under it; a relative import is named by its dots."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield "." * node.level + (node.module or "")
                continue
            names = [node.module] + [node.module + "." + a.name
                                     for a in node.names]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in PORT or (top == "portbench" and name not in (
                    "portbench", "portbench.reference")
                    and not name.startswith("portbench.reference.")):
                yield name


def test_reference_takes_nothing_of_the_port():
    ref = os.path.join(BASE, "reference")
    for n in os.listdir(ref):
        if n.endswith(".py"):
            names = set(top_names(os.path.join(ref, n)))
            assert not names & (PORT | {"portbench"}), n


def test_checks_take_nothing_of_the_port():
    checks = os.path.join(BASE, "checks")
    for n in (os.listdir(checks) if os.path.isdir(checks) else []):
        if n.endswith(".py"):
            assert not list(taken_from_port(os.path.join(checks, n))), n


@pytest.mark.parametrize("line,taken", [
    ("from portbench.reference import check", []),
    ("from portbench.reference.mapper import ReferenceMapper", []),
    ("import portbench.reference.check", []),
    ("import numpy as np", []),
    ("import torch", ["torch"]),
    ("from chromap_tpu_torch.pipeline import MappingPipeline",
     ["chromap_tpu_torch.pipeline",
      "chromap_tpu_torch.pipeline.MappingPipeline"]),
    ("import chromap_tpu", ["chromap_tpu"]),
    ("from portbench.harness import run_cell",
     ["portbench.harness", "portbench.harness.run_cell"]),
    ("from portbench import harness", ["portbench.harness"]),
    ("from ..reference import check", ["..reference"]),
])
def test_the_check_guard_sees_the_port(line, taken, tmp_path):
    path = tmp_path / "c.py"
    path.write_text(line + "\n")
    assert list(taken_from_port(str(path))) == taken


def test_top_names_compare_whole():
    assert "chromap_tpu_torch" not in FORBIDDEN
    assert "chromap_tpu_torch".split(".")[0] != "chromap_tpu"
