"""Checkpoint save and resume (port of clg_vqa_tpu/train/checkpoints.py) — the
reference's train_utils.py:351-510 flow, stored with ``torch.save``.

Reference artifacts and the port's equivalents (the JAX package's directory
names, so the two read alike on disk):
  pytorch_model_best.bin  -> {dir}/params_best/params.pt      (params only)
  pytorch_ckpt_latest.tar -> {dir}/state_e{E}_s{S}/state.pt + meta.json
        (params, optimizer state, step; meta.json holds epoch, best score,
        the metric logger's state and "state_dir", the pointer to the live
        directory, swapped atomically — see :func:`save_state`)
A ``.pt`` file holds a model state dict ({name: tensor}) and, for a state,
the optimizer state of train/optim.py as a plain dict (``count``, ``mu``,
``nu``); everything loads with ``torch.load(weights_only=True)``. The
interchange with the JAX package and the reference stack is the VOLTA
``.bin`` of :func:`export_torch_bin`.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Mapping

import numpy as np
import torch

from .loop import TrainState
from .optim import fastforward_count

PARAMS_FILE = "params.pt"
STATE_FILE = "state.pt"


def _path(d: str, name: str) -> str:
    return os.path.abspath(os.path.join(d, name))


def _state_dict(params) -> Mapping[str, Any]:
    """The {name: tensor} of an ``nn.Module``, or ``params`` itself."""
    if isinstance(params, torch.nn.Module):
        return params.state_dict()
    return params


def _host(params) -> dict[str, torch.Tensor]:
    """CPU tensors of a module's state dict or a mapping of tensors/arrays."""
    return {k: torch.as_tensor(v).detach().cpu()
            for k, v in _state_dict(params).items()}


def _host_opt(opt_state) -> dict:
    """An optimizer state NamedTuple (count + dicts of tensors) as a plain
    dict with CPU tensors."""
    return {f: (_host(v) if isinstance(v, Mapping) else int(v))
            for f, v in opt_state._asdict().items()}


def _write(obj, path: str, what: str, t0: float, log: list | None) -> dict:
    """torch.save into ``path`` through a temporary file and an atomic
    rename; appends {what, path, bytes, seconds since t0} to ``log``."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    rec = {"what": what, "path": path, "bytes": os.path.getsize(path),
           "seconds": time.perf_counter() - t0}
    if log is not None:
        log.append(rec)
    return rec


def save_params(ckpt_dir: str, name: str, params, *,
                log: list | None = None) -> dict:
    """``params`` (a model or a state dict) into ``{ckpt_dir}/{name}/``."""
    t0 = time.perf_counter()
    d = _path(ckpt_dir, name)
    os.makedirs(d, exist_ok=True)
    return _write(_host(params), os.path.join(d, PARAMS_FILE), "params", t0,
                  log)


def load_params(ckpt_dir: str, name: str, like: torch.nn.Module | None = None):
    """The state dict saved under ``{ckpt_dir}/{name}/`` (CPU tensors), or
    ``like`` with it loaded when a model is given."""
    sd = torch.load(os.path.join(_path(ckpt_dir, name), PARAMS_FILE),
                    map_location="cpu", weights_only=True)
    if like is None:
        return sd
    like.load_state_dict(sd)
    return like


def save_state(ckpt_dir: str, state: TrainState, *, epoch: int,
               best_score: float, extra: dict | None = None,
               params_only: bool = False, log: list | None = None) -> dict:
    """Crash-safe resume checkpoint (clg_vqa_tpu/train/checkpoints.py:71-120):
    the state is written under a FRESH directory name, the meta.json
    pointer is swapped atomically (os.replace), and only then is the
    superseded state deleted, so a kill at any point leaves either the old
    or the new (state, meta) pair intact.

    ``state.model`` is a model or a state dict. params_only=True writes a
    cheap resume point, params + step without the optimizer moments;
    resuming from it restarts the moments with the schedule clock
    fast-forwarded (see :func:`resume_state`)."""
    t0 = time.perf_counter()
    os.makedirs(ckpt_dir, exist_ok=True)
    step = int(state.step)
    tree = {"params": _host(state.model), "step": step}
    if not params_only:
        tree["opt_state"] = _host_opt(state.opt_state)
    meta_path = os.path.join(ckpt_dir, "meta.json")
    prev = None
    if os.path.exists(meta_path):
        try:
            with open(meta_path) as f:
                prev = json.load(f).get("state_dir", "state_latest")
        except (OSError, ValueError):
            prev = None
    name = f"state_e{epoch}_s{step}"
    if prev == name:                  # never rewrite the live pointer target
        name += "b"
    target = _path(ckpt_dir, name)
    if os.path.exists(target):        # stale partial from an earlier crash
        shutil.rmtree(target)
    os.makedirs(target)
    rec = _write(tree, os.path.join(target, STATE_FILE), "state", t0, None)
    meta = {"epoch": epoch, "best_score": best_score, "step": step,
            "state_dir": name,
            **({"params_only": True} if params_only else {}),
            **(extra or {})}
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, meta_path)
    if prev and prev != name:
        shutil.rmtree(_path(ckpt_dir, prev), ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t0
    if log is not None:
        log.append(rec)
    return rec


@torch.no_grad()
def resume_state(ckpt_dir: str, like: TrainState) -> tuple[TrainState, dict]:
    """Restore (state, meta) into ``like``: its model takes the saved
    parameters and its optimizer tensors the saved moments, in place, on
    their devices. Raises FileNotFoundError if no checkpoint exists.

    A params-only checkpoint restores params + step and keeps ``like``'s
    (fresh) moments with the count fast-forwarded to the step, so the lr
    schedule and the bias correction continue instead of rewinding into
    warmup; meta["params_only"] says the resume is not bit-exact."""
    meta_path = os.path.join(ckpt_dir, "meta.json")
    if not os.path.exists(meta_path):
        raise FileNotFoundError(meta_path)
    with open(meta_path) as f:
        meta = json.load(f)
    tree = torch.load(
        os.path.join(_path(ckpt_dir, meta.get("state_dir", "state_latest")),
                     STATE_FILE), map_location="cpu", weights_only=True)
    like.model.load_state_dict(tree["params"])
    step = int(tree["step"])
    if meta.get("params_only"):
        opt_state = fastforward_count(like.opt_state, step)
    else:
        saved = tree["opt_state"]
        for f, v in like.opt_state._asdict().items():
            if isinstance(v, Mapping):
                for k, t in v.items():
                    t.copy_(saved[f][k])
        opt_state = like.opt_state._replace(count=int(saved["count"]))
    return TrainState(like.model, opt_state, step), meta


class AsyncSaver:
    """Background checkpoint writer (clg_vqa_tpu/train/checkpoints.py:154-220):
    keeps the device-to-host copy and the disk write out of the training
    loop.

    A save first SNAPSHOTS its tensors with device clones on the current
    stream, so the next step's in-place update cannot race the writer; a
    thread then waits for the clones, copies them to the host and writes.
    Saves are serialized: a submit waits for the save in flight first. A
    failed save re-raises at the next submit or :meth:`wait`; call wait()
    before a synchronous (preemption) save and before exit. Each finished
    save appends its {what, path, bytes, seconds} record to ``log``."""

    def __init__(self, log: list | None = None):
        self.log = log
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    @staticmethod
    def _snapshot(tensors: Mapping[str, torch.Tensor]) -> dict:
        return {k: v.detach().clone() for k, v in tensors.items()}

    def _submit(self, fn) -> None:
        self.wait()
        ready = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            ready = torch.cuda.Event()
            ready.record()

        def run():
            try:
                if ready is not None:
                    ready.synchronize()
                fn()
            except BaseException as e:          # noqa: BLE001 — re-raised
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def save_state(self, ckpt_dir: str, state: TrainState, *, epoch: int,
                   best_score: float, extra: dict | None = None,
                   params_only: bool = False) -> None:
        opt = None if params_only else state.opt_state._replace(**{
            f: self._snapshot(v) for f, v in state.opt_state._asdict().items()
            if isinstance(v, Mapping)})
        snap = TrainState(self._snapshot(_state_dict(state.model)), opt,
                          state.step)
        self._submit(lambda: save_state(ckpt_dir, snap, epoch=epoch,
                                        best_score=best_score, extra=extra,
                                        params_only=params_only, log=self.log))

    def save_params(self, ckpt_dir: str, name: str, params) -> None:
        snap = self._snapshot(_state_dict(params))
        self._submit(lambda: save_params(ckpt_dir, name, snap, log=self.log))

    def export_torch_bin(self, path: str, params, model: str = "uc2", *,
                         cfg=None) -> None:
        snap = self._snapshot(_state_dict(params))
        self._submit(lambda: export_torch_bin(path, snap, model, cfg=cfg,
                                              log=self.log))

    def wait(self) -> None:
        """Join the save in flight; re-raise its failure if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from e


def export_torch_bin(path: str, params, model: str = "uc2",
                     task_key: str = "TASK15", *, cfg=None,
                     log: list | None = None) -> dict:
    """A torch-loadable ``.bin`` with VOLTA parameter names (the ``v_``
    aliases of shared weights included), so the JAX package
    (cli/common.load_pretrained) and the reference tooling (eval_task.py)
    load the port's fine-tuned weights. ``params``: a UC2, M3P, Gated or
    KimiVL model or its state dict; ``model`` ("uc2", "m3p", "gated" or
    "kimi_vl") names its format (clg_vqa_tpu/train/checkpoints.py:223-230;
    Kimi-VL, which VOLTA has not, keeps the port's own names); ``cfg``, the
    model's config, names a gated model's keys by its wiring."""
    from ..utils.convert import (state_dict_to_volta_m3p,
                                 state_dict_to_volta_uc2)
    from ..utils.convert_gated import state_dict_to_volta_gated
    to_sd = {"uc2": state_dict_to_volta_uc2, "m3p": state_dict_to_volta_m3p,
             "gated": state_dict_to_volta_gated,
             "kimi_vl": lambda p, c, t: {k: v.float().numpy()
                                         for k, v in _host(p).items()}}.get(model)
    if to_sd is None:
        raise ValueError(f"model must be 'uc2', 'm3p', 'gated' or 'kimi_vl', "
                         f"got {model!r}")
    t0 = time.perf_counter()
    sd = to_sd(params, cfg, task_key)
    return _write({k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in sd.items()}, path, "bin", t0, log)
