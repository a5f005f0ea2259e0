"""A checkout copy with tiny cells beside the real ones, for CPU tests: the
same harness, code paths and limits at a size the CPU runs in seconds."""
from __future__ import annotations

import glob
import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY = {"hidden_size": 64, "v_hidden_size": 64, "intermediate_size": 256,
        "vocab_size": 1000, "num_labels": 1842, "max_seq_length": 12,
        "pooler_size": 64}
LAYERS = 2
TRAFFIC = {"images": 12, "qa": 512, "mbs": 8, "question_words": [10, 10],
           "word_pool": 500, "questions_per_pass": 40, "batch_size": 16,
           "calls": 64, "rate_calls_per_s": 200.0, "warm_calls": 2,
           "check_answers": 256, "check_requests": 256, "trace_calls": 4,
           "warm_passes": 1}


def _tiny_config(c: dict) -> dict:
    c = dict(c, **TINY)
    if c["model_name"] == "m3p":
        c.update(n_heads=2, n_layers=LAYERS, max_region_num=16,
                 clf_hidden_size=128)
    else:
        c.update(num_attention_heads=2, max_region_num=6, clf_hidden_size=64)
        for k in ("tt_attn_sublayers", "tv_attn_sublayers", "vt_attn_sublayers",
                  "vv_attn_sublayers"):
            c[k] = list(range(0, 2 * LAYERS, 2))
        for k in ("t_ff_sublayers", "v_ff_sublayers"):
            c[k] = list(range(1, 2 * LAYERS, 2))
        for k in ("shared_sublayers", "single_ln_sublayers"):
            c[k] = list(range(2 * LAYERS))
    return c


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
            c = _tiny_config(json.load(f))
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
