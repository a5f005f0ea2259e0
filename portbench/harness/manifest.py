"""BENCHMARK.json and the files it names.

A cell is found by its name: its configuration's file (``file`` in
``configs``), the configuration's model family in
``portbench/families/<model_name>.py``, its traffic mix in
``portbench/traffic/<traffic>.json``, its limits in
``portbench/workloads/<cell>.json``, and each per-layer metric's reader in
``portbench/metrics/<metric>.py``. Adding a cell, a configuration, a model
family, a traffic mix or a per-layer metric adds files and manifest entries
only."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH = "portbench"      # the benchmark's directory in a checkout
FAMILY_MEMBERS = ("dims", "layout", "model", "forward_flops", "reference", "tiny")
# a family file's path -> its module, loaded once a process, so that the run,
# the FLOP count (flops.forward_flops) and a test's patch see one module
_families: dict = {}


@dataclasses.dataclass
class Cell:
    name: str
    config: dict            # the configuration file's contents
    config_path: str
    traffic: dict
    limits: dict            # number -> limit
    end_to_end: list        # the manifest's end-to-end metrics of this cell
    per_layer: list         # the manifest's per-layer metrics of this cell


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root: str, name: str) -> Cell:
    """The cell ``name`` of the manifest at ``root``; KeyError names what is
    missing."""
    man = load(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    path = os.path.join(root, conf["file"])
    with open(path) as f:
        config = json.load(f)
    with open(os.path.join(root, BENCH, "traffic", entry["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(root, BENCH, "workloads", name + ".json")) as f:
        limits = json.load(f)["limits"]
    e2e = [m for m in man["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if m["moves"] in moved and _reports(m, name)]
    return Cell(name, config, path, traffic, limits, e2e, per_layer)


def _load(path: str, prefix: str, name: str):
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: str, name: str):
    """``read(ctx)`` of the per-layer metric ``name``: its value, or None
    where it finds nothing to read."""
    path = os.path.join(root, BENCH, "metrics", name + ".py")
    return _load(path, "portbench_metric_", name).read


def family(root: str, name: str):
    """The model family ``name`` (a configuration's ``model_name``) of the
    checkout at ``root``: the module portbench/families/<name>.py, loaded
    once a process (portbench/families/__init__.py lists its members)."""
    path = os.path.abspath(os.path.join(root, BENCH, "families", name + ".py"))
    if path not in _families:
        mod = _load(path, "portbench_family_", name)
        missing = [m for m in FAMILY_MEMBERS if not hasattr(mod, m)]
        if missing:
            raise AttributeError(f"family {name!r} ({path}) lacks {missing}")
        _families[path] = mod
    return _families[path]
