"""BENCHMARK.json against the benchmark's contract, and the harness finding
what the manifest names by name alone."""
import json
import os
import re
import shutil

import pytest

from portbench.harness import manifest
from portbench.tests import tiny
from portbench.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def man():
    return manifest.load(ROOT)


def test_manifest_keys_names_and_units(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= man["run_seconds"] <= 51
    names = [c["name"] for c in man["configs"]] + [w["name"] for w in man["workloads"]]
    metrics = man["end_to_end"] + man["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for n in names + [w["traffic"] for w in man["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                               "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in man["end_to_end"])
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] in {e["name"] for e in man["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and not c["reduced"]
    assert len(json.dumps(man, indent=1)) <= 64 * 1024


HELD = [w["name"] for entries in tiny.held() for w in entries["workloads"]]


@pytest.fixture(scope="module")
def held_root(tmp_path_factory):
    return tiny.checkout(str(tmp_path_factory.mktemp("held")))


@pytest.mark.parametrize("cell", ["uc2-finetune", "m3p-finetune", "uc2-eval",
                                  "m3p-eval", *HELD])
def test_every_cell_has_its_files_and_metrics(cell, man, held_root):
    """A cell held out in portbench/pending/ keeps all its files, so putting
    it back takes manifest entries only."""
    assert (cell in HELD) != (cell in {w["name"] for w in man["workloads"]})
    root = held_root if cell in HELD else ROOT
    c = manifest.cell(root, cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(manifest.reader(root, m["name"]))
    assert set(c.limits) and all(v >= 0 for v in c.limits.values())


def test_every_configuration_names_a_family_that_shrinks_it(man):
    """Each configuration's ``model_name`` finds its family, whose ``tiny``
    (the CPU tests' configurations, tests/tiny.py) keeps the family and
    shrinks the widths and depth."""
    for c in man["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        fam = manifest.family(ROOT, cfg["model_name"])
        d, t = fam.dims(cfg), fam.dims(tiny.tiny_config(cfg))
        assert t["model"] == d["model"] == cfg["model_name"]
        assert t["H"] < d["H"] and t["layers"] < d["layers"] and t["vocab"] < d["vocab"]


def test_a_throwaway_cell_config_traffic_and_metric_are_found(tmp_path):
    """A later PR adds files and manifest entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = manifest.load(ROOT)
    with open(os.path.join(ROOT, "portbench/configs/uc2.json")) as f:
        conf = json.load(f)
    (root / "portbench/configs/uc2-x.json").write_text(json.dumps(conf))
    man["configs"].append({"name": "uc2-x", "source": "https://example.org",
                           "file": "portbench/configs/uc2-x.json", "reduced": [],
                           "why": "a throwaway"})
    t = json.loads((root / "portbench/traffic/gqa_finetune.json").read_text())
    t["fused_attn"] = "proj"
    (root / "portbench/traffic/gqa_finetune_proj.json").write_text(json.dumps(t))
    (root / "portbench/workloads/x-finetune.json").write_text(
        json.dumps({"limits": {"loss": 1.0}}))
    man["workloads"].append({"name": "x-finetune", "config": "uc2-x",
                             "traffic": "gqa_finetune_proj", "chips": 1,
                             "why": "a throwaway"})
    (root / "portbench/metrics/x_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    man["per_layer"].append({"name": "x_metric", "unit": "ms", "better": "lower",
                             "source": "host_clock", "layer": "x",
                             "moves": "train_qa_per_s",
                             "workloads": ["x-finetune"]})
    for m in man["end_to_end"]:
        if m["name"] == "train_qa_per_s":
            m["workloads"].append("x-finetune")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    c = manifest.cell(str(root), "x-finetune")
    assert c.traffic["fused_attn"] == "proj" and c.config["model_name"] == "uc2"
    assert c.limits == {"loss": 1.0}
    assert "x_metric" in {m["name"] for m in c.per_layer}
    assert "train_qa_per_s" in {m["name"] for m in c.end_to_end}
    assert manifest.reader(str(root), "x_metric")(None) == 42.0
