"""Model families (portbench/families/): UC2's and M3P's members against
pinned values, and a throwaway family that enters a checkout by new files
alone and runs a tiny finetune cell and a tiny eval cell."""
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys

import pytest

from portbench.harness import manifest
from portbench.tests.tiny import ROOT

# dims, weights (count, parameters, sha256 of [[name, shape, init], ...]) and
# forward FLOPs of the published configurations (PERF.md, section 4)
PINNED = {
    "uc2": ({"model": "uc2", "H": 768, "heads": 12, "layers": 12, "ffn": 3072,
             "eps": 1e-05, "pad": 1, "vocab": 250002, "locs": 7, "feat": 2048,
             "norm": False, "labels": 1842, "text": 40, "regions": 36,
             "max_pos": 514, "type_vocab": 2, "pooler": 768, "clf_hidden": 768},
            215, 281_637_426,
            "14f691aca3a6b03817173f1159c86c2a9056e4f6f6e95600a75efa4e8d93ce62",
            13_241_816_064),
    "m3p": ({"model": "m3p", "H": 768, "heads": 12, "layers": 12, "ffn": 3072,
             "eps": 1e-12, "pad": 1, "vocab": 250002, "locs": 5, "feat": 2048,
             "norm": True, "labels": 1842, "text": 40, "regions": 100,
             "max_pos": 514, "type_vocab": 1, "pooler": 768, "clf_hidden": 1536},
            210, 283_638_066,
            "295275b942eb6c6b315eae52f332ab1cfdda2465c5c9a9849217b06a5633345a",
            24_828_776_448),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_published_families_read_as_pinned(name):
    with open(os.path.join(ROOT, f"portbench/configs/{name}.json")) as f:
        cfg = json.load(f)
    fam = manifest.family(ROOT, name)
    dims, count, params, sha, fwd = PINNED[name]
    d = fam.dims(cfg)
    assert d == dims
    spec = fam.layout(d)
    assert len(spec) == count and len({n for n, _, _ in spec}) == count
    assert sum(math.prod(s) for _, s, _ in spec) == params
    flat = json.dumps([[n, list(s), i] for n, s, i in spec]).encode()
    assert hashlib.sha256(flat).hexdigest() == sha
    assert fam.forward_flops(d) == fwd
    t = fam.dims(fam.tiny(cfg))
    assert t["model"] == name and t["H"] < d["H"] and t["layers"] < d["layers"]


TOY = os.path.join(ROOT, "portbench", "tests", "toy")

DRIVE = """
import json, sys
import torch
from portbench.harness import manifest, runner
root = sys.argv[1]
cells = ("toy-finetune", "toy-eval")
out = {c: runner.run_cell(root, c, 2**31 + 7, 0.5, False, device="cpu")["correct"]
       for c in cells}
fam = manifest.family(root, "toy")
build = fam.model


def unloaded_pooler(*a):
    m = build(*a)
    with torch.no_grad():
        dict(m.named_parameters())["pooler.weight"].zero_()
    return m


fam.model = unloaded_pooler
out.update({c + "/fault": runner.run_cell(root, c, 2**31 + 7, 0.5, False,
                                          device="cpu")["correct"] for c in cells})
print(json.dumps(out))
"""


def _digests(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_new_family_enters_by_added_files_alone(tmp_path):
    """A family module, its reference, a configuration, two traffic mixes,
    two limits files and manifest entries, copied into a checkout: both
    tiny cells are correct, an unloaded pooler in its model is not, and no
    file that the checkout had changed but BENCHMARK.json, which only
    gained entries."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digests(str(root))
    added = []
    src = os.path.join(TOY, "portbench")
    for d, _, files in os.walk(src):
        for f in files:
            rel = os.path.join("portbench", os.path.relpath(os.path.join(d, f), src))
            assert rel not in before, rel
            os.makedirs(os.path.dirname(root / rel), exist_ok=True)
            shutil.copy(os.path.join(d, f), root / rel)
            added.append(rel)
    with open(os.path.join(TOY, "entries.json")) as f:
        entries = json.load(f)
    man = json.loads((root / "BENCHMARK.json").read_text())
    old = json.loads(json.dumps(man))
    man["configs"] += entries["configs"]
    man["workloads"] += entries["workloads"]
    for m in man["end_to_end"]:
        m.get("workloads", []).extend(entries["metric_workloads"].get(m["name"], []))
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), ROOT]))
    got = subprocess.run([sys.executable, "-c", DRIVE, str(root)], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-4000:]
    assert json.loads(got.stdout.strip().splitlines()[-1]) == {
        "toy-finetune": True, "toy-eval": True,
        "toy-finetune/fault": False, "toy-eval/fault": False}
    after = _digests(str(root))
    changed = {p for p, h in before.items() if after.get(p) != h}
    assert changed == {"BENCHMARK.json"}
    assert set(after) - set(before) - {p for p in after if "__pycache__" in p} == set(added)
    new = json.loads((root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        assert new[key][:len(old[key])] == old[key]
    for a, b in zip(old["end_to_end"], new["end_to_end"]):
        assert {k: v for k, v in b.items() if k != "workloads"} == {
            k: v for k, v in a.items() if k != "workloads"}
        assert b.get("workloads", [])[:len(a.get("workloads", []))] == a.get("workloads", [])
