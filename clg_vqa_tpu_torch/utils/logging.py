"""Metrics logging (own copy of clg_vqa_tpu/utils/logging.py) — the
reference's tbLogger (train_utils.py:19-301) rebuilt: per-task train/val
scalar accumulation, periodic console lines, a plain-text log file, a
machine-readable metrics.jsonl and TensorBoard scalars. State is a plain dict
so it can ride inside checkpoints (the reference pickles the logger into
pytorch_ckpt_latest.tar); the records are the JAX package's, field for
field."""
from __future__ import annotations

import json
import os
import time
from typing import Any

import torch


class MetricsLogger:
    def __init__(self, log_dir: str | None = None, task: str = "GQA",
                 tensorboard: bool = True):
        self.task = task
        self.log_dir = log_dir
        self._jsonl = None
        self._txt = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            self._txt = open(os.path.join(log_dir, "out.txt"), "a")
            if tensorboard:
                from .tb_events import EventWriter
                self._tb = EventWriter(log_dir)
        self.reset_train()
        self.reset_val()
        self.global_step = 0
        self.t0 = time.time()

    # -- train ------------------------------------------------------------
    def reset_train(self):
        self._tr = {"loss": 0.0, "score": 0.0, "n": 0}

    def step_train(self, epoch: int, loss: float, score: float, lr: float,
                   qa_per_sec: float | None = None):
        self.global_step += 1
        self._tr["loss"] += loss
        self._tr["score"] += score
        self._tr["n"] += 1
        self._emit({"kind": "train", "epoch": epoch,
                    "step": self.global_step, "loss": loss, "score": score,
                    "lr": lr, **({"qa_per_sec": qa_per_sec}
                                 if qa_per_sec is not None else {})})

    def show_train(self, epoch: int) -> str:
        if self._tr["n"] == 0:      # nothing accumulated since last show
            return ""
        n = self._tr["n"]
        msg = (f"[{self.task}] epoch {epoch} step {self.global_step} "
               f"loss {self._tr['loss']/n:.4f} score {self._tr['score']/n:.4f} "
               f"({time.time()-self.t0:.0f}s)")
        self._print(msg)
        self.reset_train()
        return msg

    # -- val --------------------------------------------------------------
    def reset_val(self):
        self._va = {"loss": 0.0, "correct": 0.0, "n": 0}

    def step_val(self, loss: float, correct: float, count: float):
        self._va["loss"] += loss * count
        self._va["correct"] += correct
        self._va["n"] += count

    def show_val(self, epoch: int) -> float:
        n = max(self._va["n"], 1)
        score = self._va["correct"] / n
        msg = (f"[{self.task}] VAL epoch {epoch} loss {self._va['loss']/n:.4f} "
               f"score {100*score:.2f}")
        self._print(msg)
        self._emit({"kind": "val", "epoch": epoch, "step": self.global_step,
                    "loss": self._va["loss"] / n, "score": score})
        self.reset_val()
        return score

    # -- plumbing ---------------------------------------------------------
    def _emit(self, rec: dict):
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb:
            kind = rec.get("kind", "train")
            scalars = {f"{kind}/{self.task}_{k}": float(rec[k])
                       for k in ("loss", "score", "lr") if k in rec}
            if scalars:
                self._tb.add_scalars(scalars, rec.get("step", 0))

    def _print(self, msg: str):
        print(msg)
        if self._txt:
            self._txt.write(msg + "\n")
            self._txt.flush()

    def state_dict(self) -> dict[str, Any]:
        # full logger state rides checkpoints like the reference's pickled
        # tbLogger: accumulators + elapsed time, so the first post-resume
        # show_train covers pre-preemption steps and the seconds column
        # doesn't restart at 0
        return {"global_step": self.global_step, "tr": dict(self._tr),
                "va": dict(self._va), "elapsed": time.time() - self.t0}

    def load_state_dict(self, d: dict):
        self.global_step = d.get("global_step", 0)
        if "tr" in d:
            self._tr = dict(d["tr"])
        if "va" in d:
            self._va = dict(d["va"])
        if "elapsed" in d:
            self.t0 = time.time() - float(d["elapsed"])

    def close(self):
        for f in (self._jsonl, self._txt, self._tb):
            if f:
                f.close()


def summarize_params(params, print_fn=print) -> int:
    """Parameter table (the reference's summary_parameters,
    train_utils.py:321-348): name, shape, count per parameter + total.
    ``params``: an ``nn.Module`` or a mapping of names to tensors."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    total = 0
    for name in sorted(params):
        shape = tuple(params[name].shape)
        n = 1
        for d in shape:
            n *= int(d)
        total += n
        print_fn(f"{name:60s} {str(shape):>20s} {n:>12,d}")
    print_fn(f"{'TOTAL':60s} {'':>20s} {total:>12,d}")
    return total
