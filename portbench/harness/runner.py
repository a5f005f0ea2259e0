"""One run of one cell: set-up, the measured window, the traced sub-window
(``--trace 1``), the program freed, then the reference's check and the
result line."""
from __future__ import annotations

import dataclasses
import gc
import sys
import tempfile
import time
import types

import torch

from . import checks, evaluate, finetune, flops, host, manifest, peaks, serve
from . import weights as W
from .seeds import sub

KINDS = {"finetune": finetune, "eval": evaluate, "serve": serve}
FORBIDDEN = ("jax", "jaxlib", "flax", "clg_vqa_tpu")


@dataclasses.dataclass
class Run:
    """One run of a cell: the kinds reach the model, its weights and its
    reference only through the family here."""
    cell: manifest.Cell
    family: types.ModuleType        # portbench/families/<model_name>.py
    d: dict                         # family.dims(cell.config)
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    tmp: str = ""

    def weights(self) -> dict:
        """The run's weights, from its seed, on its device."""
        return W.make_weights(self.family.layout(self.d), self.d,
                              sub(self.seed, "weights"), self.device)

    def model(self):
        """The port's model holding the run's weights."""
        return self.family.model(self.cell.config_path, self.d, self.weights(),
                                 self.device)


def new_run(root: str, cell: manifest.Cell, seed: int, seconds: float, trace: bool,
            device: torch.device, tmp: str) -> Run:
    fam = manifest.family(root, cell.config["model_name"])
    return Run(cell, fam, fam.dims(cell.config), int(seed), float(seconds),
               bool(trace), device, tmp)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: the port's name begins with the latter)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None, chips: int = 1) -> dict:
    """The result of one run (the contract's keys, ``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = manifest.cell(root, name)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    kind = KINDS[cell.traffic["kind"]]
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        run = new_run(root, cell, seed, seconds, trace, dev, tmp)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        st = kind.setup(run)
        gc.collect()
        setup_s = time.perf_counter() - t_start
        h0 = host.sample()
        win = kind.window(run, st)
        h1 = host.sample()
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        tr = kind.traced(run, st) if trace else None
        print(host.report(h0, h1), file=sys.stderr)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        kind.release(st)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        readings = kind.judge(run, st)
    correct, compared = checks.verdict(readings, cell.limits)
    metrics = {}
    if not trace:
        values = dict(win["metrics"], setup_s=setup_s,
                      memory_peak_gib=window_peak / 2**30)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = types.SimpleNamespace(cell=name, kind=cell.traffic["kind"], d=run.d,
                                    traffic=cell.traffic, window=win, trace=tr,
                                    flops=flops, peaks=peaks)
        for m in cell.per_layer:
            v = manifest.reader(root, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": chips, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": win["attempted"],
           "failed": win["failed"], "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        out["breakdown"] = tr.breakdown()
    out["checks"] = compared
    return out
