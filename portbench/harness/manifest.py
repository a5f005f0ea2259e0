"""BENCHMARK.json and the files it names.

A cell is found by its name: its configuration's file (``file`` in
``configs``), its traffic mix in ``portbench/traffic/<traffic>.json``, its
limits in ``portbench/workloads/<cell>.json``, and each per-layer metric's
reader in ``portbench/metrics/<metric>.py``. Adding a cell, a configuration,
a traffic mix or a per-layer metric adds files and manifest entries only."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH = "portbench"      # the benchmark's directory in a checkout


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


def reader(root: str, name: str):
    """``read(ctx)`` of the per-layer metric ``name``: its value, or None
    where it finds nothing to read."""
    path = os.path.join(root, BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
