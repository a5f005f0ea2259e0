"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference, each family's with it, imports nothing of the program."""
import ast
import glob
import os

import pytest

from portbench.harness import manifest
from portbench.harness.runner import forbidden_modules
from portbench.tests.tiny import ROOT

BENCH = os.path.join(ROOT, "portbench")
FAMILIES = sorted(os.path.basename(p)[:-3] for p in glob.glob(
    os.path.join(BENCH, "families", "[!_]*.py")))


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


def test_the_families_are_among_the_sources_checked():
    assert FAMILIES and {os.path.join(BENCH, "families", f + ".py")
                         for f in FAMILIES} <= set(_sources(BENCH))


@pytest.mark.parametrize("name", FAMILIES)
def test_each_familys_reference_lies_under_the_reference(name):
    """A family's ``reference`` is a module of portbench/reference/, which
    the next test holds to importing nothing of the program."""
    ref = manifest.family(ROOT, name).reference
    assert os.path.dirname(os.path.abspath(ref.__file__)) == os.path.join(BENCH,
                                                                           "reference")
    assert not _imports(ref.__file__) & {"clg_vqa_tpu_torch", "clg_vqa_tpu"}


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
