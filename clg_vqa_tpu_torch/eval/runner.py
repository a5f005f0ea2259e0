"""Zero-shot evaluation runner (port of clg_vqa_tpu/eval/runner.py:19-183)
— the reference's eval_task.py flow (eval_task.py:96-213 +
task_utils.py:716-841, VL-classifier-GQA branch): batched forward, argmax
over the answer space, ``{split}_result.json`` records
{"questionId", "prediction"}; on one device, or as one rank of a (dp, mp)
mesh (:func:`shard_predict_step`).
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Callable

import torch

from ..data.device_bank import DeviceFeatureBank
from ..models.layers import all_reduce, check_fused
from ..parallel.mesh import local_batch
from ..utils.profiling import span


def make_predict_step(model, *, device_bank=None,
                      compute_dtype=torch.bfloat16,
                      fused_attn=False) -> Callable:
    """batch (dict of tensors on the model's device) -> argmax predictions.

    With a device bank the batch carries ``store_idx`` and the features are
    gathered on the device. fused_attn="flat" routes attention through the
    flat eval kernel (ops/attention.fused_attention_flat), True or "hm"
    through the head-blocked one (ops/attention.fused_attention)."""
    check_fused(fused_attn)
    bank = device_bank.tensors() if device_bank is not None else None

    @torch.inference_mode()
    def step(batch: dict) -> torch.Tensor:
        if bank is not None:
            batch = dict(batch)
            f, l, m = DeviceFeatureBank.gather_from(bank, batch.pop("store_idx"))
            batch.update({"features": f, "locs": l, "image_mask": m})
        logits = model(batch, deterministic=True, compute_dtype=compute_dtype,
                       fused_attn=fused_attn)
        return torch.argmax(logits, dim=-1)

    return step


def shard_predict_step(model, mesh, *, device_bank=None,
                       compute_dtype=torch.bfloat16,
                       fused_attn=False) -> Callable:
    """:func:`make_predict_step` as one rank of a (dp, mp) mesh (port of
    clg_vqa_tpu/eval/runner.py:56-98): ``model`` went through
    parallel/mesh.shard_model; the step takes the whole batch, runs this
    rank's dp slice (mp ranks share it) and returns every rank's
    predictions in batch order, on every rank. The bank is replicated.

    fused_attn: False or "flat" (the flat eval kernel on this rank's heads);
    the head-blocked, "proj" and "sm" routes are single-chip opt-ins and
    raise ValueError, as in JAX."""
    if fused_attn and fused_attn != "flat":
        raise ValueError(
            "shard_predict_step supports fused_attn='flat' (this rank's "
            "batch slice and heads) or False; the blocked/hm/proj/sm kernels "
            "are single-chip opt-ins")
    if getattr(model, "mesh", None) is not mesh:
        raise ValueError("shard the model over the mesh first "
                         "(parallel/mesh.shard_model)")
    local = make_predict_step(model, device_bank=device_bank,
                              compute_dtype=compute_dtype,
                              fused_attn=fused_attn)

    @torch.inference_mode()
    def step(batch: dict) -> torch.Tensor:
        pred = local(local_batch(batch, mesh))
        out = pred.new_zeros(pred.shape[0] * mesh.n_dp)
        b = pred.shape[0]
        out[mesh.dp_rank * b:(mesh.dp_rank + 1) * b] = pred
        return all_reduce(out, mesh.dp_group)

    return step


def _to_host_async(t: torch.Tensor):
    """Start copying ``t`` to the host; returns (host tensor, event to wait
    on or None). On CUDA the copy lands in pinned memory behind an event, so
    waiting for one batch's predictions does not wait for later batches."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def run_eval(model, dataset, label2ans: list, *,
             batch_size: int = 256, compute_dtype=torch.bfloat16,
             out_path: str | None = None, split: str = "test",
             log_every: int = 0, device_bank=None, depth: int = 2,
             step: Callable | None = None, fused_attn=None) -> dict:
    """Returns {"results": [...], "n": int, "qa_per_sec": float,
    "accuracy": float | None (if the dataset has labels), "out_path"}.

    Runs on the model's device. device_bank: optional
    data.device_bank.DeviceFeatureBank — batches then carry store indices
    and the features are gathered on the device. step: optional prebuilt
    :func:`make_predict_step` result. split: the split's name, taken for
    the JAX signature (the output path carries it). log_every: print
    "  eval n/N" whenever the count of scored questions passes a multiple
    of it (0: never). fused_attn: None = auto, the JAX
    package's rule — the flat kernel for bf16 at batch >= 512 on the card,
    the plain path otherwise (incl. fp32 parity mode).

    Up to ``depth`` batches stay in flight: kernel launches are
    asynchronous, so host batch assembly overlaps device work and only the
    oldest batch's prediction fetch blocks. Under a profiler the call is the
    span ``eval.pass`` (utils/profiling.span) holding each batch's
    ``eval.assemble``, ``eval.dispatch`` and ``eval.consume``."""
    with span("eval.pass"):
        device = model.device
        if step is None:
            if fused_attn is None:
                fused_attn = ("flat" if (compute_dtype == torch.bfloat16
                                         and batch_size >= 512
                                         and device.type == "cuda") else False)
            step = make_predict_step(model, device_bank=device_bank,
                                     compute_dtype=compute_dtype,
                                     fused_attn=fused_attn)

        results = []
        n_total = n_correct = n_labeled = 0

        def consume(host_qids, valid, has_label, labels, preds_host, ev):
            nonlocal n_total, n_correct, n_labeled
            with span("eval.consume"):
                if ev is not None:
                    ev.synchronize()
                preds = preds_host.numpy()
                keep = valid != 0
                lab = (has_label != 0) & keep
                n_total += int(keep.sum())
                n_labeled += int(lab.sum())
                n_correct += int((labels[lab] == preds[lab]).sum())
                results.extend(
                    {"questionId": str(q), "prediction": label2ans[int(p)]}
                    for q, p in zip(host_qids[keep], preds[keep]))
                if log_every and n_total % log_every < batch_size:
                    print(f"  eval {n_total}/{len(dataset)}")

        t0 = time.time()
        inflight: deque = deque()
        batches = iter(dataset.iter_batches(
            batch_size, with_features=device_bank is None))
        while True:
            with span("eval.assemble"):
                batch = next(batches, None)
                if batch is not None:
                    host = [batch.pop(k) for k in ("question_id", "valid",
                                                   "has_label", "labels")]
                    batch = {k: torch.from_numpy(v).to(device, non_blocking=True)
                             for k, v in batch.items()}
            if batch is None:
                break
            with span("eval.dispatch"):
                inflight.append((*host, *_to_host_async(step(batch))))
            if len(inflight) > depth:
                consume(*inflight.popleft())
        while inflight:
            consume(*inflight.popleft())
        dt = time.time() - t0

        if out_path:
            os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
            with open(out_path, "w") as f:
                json.dump(results, f)
        return {
            "results": results, "n": n_total,
            "qa_per_sec": n_total / dt if dt > 0 else float("inf"),
            "accuracy": (n_correct / n_labeled) if n_labeled else None,
            "out_path": out_path,
        }
