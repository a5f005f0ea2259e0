"""A checkout copy with tiny cells beside the real ones, for CPU tests: the
same harness, code paths and limits at a size the CPU runs in seconds."""
from __future__ import annotations

import glob
import json
import os
import shutil

from portbench.harness import manifest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRAFFIC = {"images": 12, "qa": 512, "mbs": 8, "question_words": [10, 10],
           "word_pool": 500, "questions_per_pass": 40, "batch_size": 16,
           "calls": 64, "rate_calls_per_s": 200.0, "warm_calls": 2,
           "check_answers": 256, "check_requests": 256, "trace_calls": 4,
           "warm_passes": 1}


def tiny_config(c: dict) -> dict:
    """The configuration ``c`` shrunk by its family's ``tiny``."""
    return manifest.family(ROOT, c["model_name"]).tiny(c)


def held() -> list[dict]:
    """The manifest entries of the cells that ``portbench/pending/`` holds out
    of BENCHMARK.json, one dict of ``workloads``, ``end_to_end`` and
    ``per_layer`` a file."""
    out = []
    for path in sorted(glob.glob(os.path.join(ROOT, "portbench", "pending", "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def checkout(tmp: str) -> str:
    """A copy of BENCHMARK.json and portbench/ under ``tmp`` holding, for
    each cell X, the held-out ones too, a cell ``X-tiny`` on a tiny
    configuration and traffic with X's limits; the training attention takes
    the flat route (on the CPU its plain version, with the card's keep
    masks)."""
    root = os.path.join(tmp, "checkout")
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    for entries in held():
        for key in ("workloads", "end_to_end", "per_layer"):
            man[key] += entries[key]
    bench = os.path.join(root, "portbench")
    for conf in list(man["configs"]):
        with open(os.path.join(ROOT, conf["file"])) as f:
            c = tiny_config(json.load(f))
        name = conf["name"] + "-tiny"
        path = f"portbench/configs/{name}.json"
        with open(os.path.join(root, path), "w") as f:
            json.dump(c, f)
        man["configs"].append(dict(conf, name=name, file=path))
    for w in list(man["workloads"]):
        with open(os.path.join(bench, "traffic", w["traffic"] + ".json")) as f:
            t = json.load(f)
        t.update({k: v for k, v in TRAFFIC.items() if k in t})
        if t["kind"] == "finetune":
            t["fused_attn"] = "flat"
        t["min_boxes"] = None if t["min_boxes"] is None else 3
        traffic = w["traffic"] + "-tiny"
        with open(os.path.join(bench, "traffic", traffic + ".json"), "w") as f:
            json.dump(t, f)
        name = w["name"] + "-tiny"
        shutil.copy(os.path.join(bench, "workloads", w["name"] + ".json"),
                    os.path.join(bench, "workloads", name + ".json"))
        man["workloads"].append(dict(w, name=name, config=w["config"] + "-tiny",
                                     traffic=traffic))
        for m in man["end_to_end"] + man["per_layer"]:
            if w["name"] in m.get("workloads", ()):
                m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return root
