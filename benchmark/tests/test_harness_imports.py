"""Nothing under benchmark/ imports JAX or the JAX package, and the plain
reference imports nothing of the program (top-level names compared whole:
``pytorch_yolo_tpu_torch`` begins with ``pytorch_yolo_tpu``)."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "pytorch_yolo_tpu"}


def _sources(root):
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _imports(path):
    with open(path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources(HERE)), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources(os.path.join(HERE, "reference"))),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert "pytorch_yolo_tpu_torch" not in set(_imports(path))
    with open(path, "r", encoding="utf-8") as f:
        assert "pytorch_yolo_tpu" not in f.read()


def test_run_py_checks_modules_by_whole_name(monkeypatch):
    import sys
    import types

    monkeypatch.syspath_prepend(HERE)
    import run

    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "pytorch_yolo_tpu_torch.x", types.ModuleType("x"))
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "pytorch_yolo_tpu", types.ModuleType("x"))
    assert run.loaded_forbidden() == ["jaxlib", "pytorch_yolo_tpu"]
