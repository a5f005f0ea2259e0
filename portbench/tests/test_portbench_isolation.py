"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program."""
import ast
import os

import pytest

from portbench.harness.runner import forbidden_modules
from portbench.tests.tiny import ROOT

BENCH = os.path.join(ROOT, "portbench")


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def _sources(top: str):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources(BENCH)), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "clg_vqa_tpu"}


@pytest.mark.parametrize("path", sorted(_sources(os.path.join(BENCH, "reference"))),
                         ids=os.path.basename)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"clg_vqa_tpu_torch", "clg_vqa_tpu"}
    assert not any(m.startswith("portbench.harness") for m in _imports(path))


def test_the_runtime_check_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "clg_vqa_tpu_torch_x", types.ModuleType("x"))
    assert "clg_vqa_tpu_torch_x" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "clg_vqa_tpu.sub", types.ModuleType("y"))
    assert "clg_vqa_tpu.sub" in forbidden_modules()
