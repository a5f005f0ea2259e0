"""The port (clg_vqa_tpu_torch) and chip_smoke.py stand alone: neither
imports JAX nor any module of the JAX package clg_vqa_tpu (the name
clg_vqa_tpu_torch shares its prefix, so the checks match the JAX package's
name only when a dot, a space or the end of the name follows)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "clg_vqa_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = [
    re.compile(r"^\s*import\s+jax\b", re.M),
    re.compile(r"^\s*from\s+jax\b", re.M),
    re.compile(r"\bclg_vqa_tpu\."),
    re.compile(r"\bfrom\s+clg_vqa_tpu\s"),
    re.compile(r"\bimport\s+clg_vqa_tpu\b(?!_)"),
]


def test_sources_found():
    names = {p.name for p in SOURCES}
    assert {"chip_smoke.py", "uc2.py", "attention.py", "bank_gather.py",
            "runner.py", "predictor.py", "loop.py", "optim.py", "pipeline.py",
            "semantic_prior.py", "profile_train.py", "mesh.py",
            "distributed.py", "aux_losses.py", "pretrain_losses.py",
            "mlp.py", "pretrain.py", "embeddings_zoo.py", "gated.py",
            "convert_gated.py", "m3p_gen.py", "lmdb_lite.py", "tdlmdb.py",
            "convert_store.py", "prior.py", "cfs_native.py",
            "profiling.py", "features.py", "cfs.py"} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_import(path):
    text = path.read_text()
    hits = [pat.pattern for pat in FORBIDDEN if pat.search(text)]
    assert not hits, f"{path} matches {hits}"


def test_patterns_catch_the_jax_package_and_spare_the_port():
    bad = ["import jax", "from jax import numpy", "import clg_vqa_tpu",
           "from clg_vqa_tpu import config", "import clg_vqa_tpu.models.uc2"]
    good = ["import clg_vqa_tpu_torch", "from clg_vqa_tpu_torch.ops import x",
            "import clg_vqa_tpu_torch.models.uc2", "# see clg_vqa_tpu/ops"]
    assert all(any(p.search(s) for p in FORBIDDEN) for s in bad)
    assert not any(p.search(s) for p in FORBIDDEN for s in good)


def test_importing_the_port_loads_no_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import clg_vqa_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith("
        "('jax.', 'jaxlib')) or n == 'clg_vqa_tpu' or n.startswith('clg_vqa_tpu.'))\n"
        "print(len([n for n in sys.modules if n.startswith('clg_vqa_tpu_torch')]))\n"
        "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_port, bad = out.stdout.strip().splitlines()
    assert int(n_port) >= 30
    assert bad == "[]"
