"""Training and eval steps of the GQA fine-tuning recipe (port of
clg_vqa_tpu/train/loop.py:32-416): one device, or one rank of a (dp, mp)
mesh (:func:`shard_train_step`).

Semantics kept from the JAX package (and through it from
volta/train_task.py:313-367 and volta/volta/task_utils.py:308-434):
 - gradient accumulation over the batch's leading axis: each microbatch's
   gradients are divided by the number of microbatches and summed; loss
   and score are averaged the same way;
 - loss ``num_labels * (criterion + lambda * semantic prior)``
   (ops/semantic_prior.py);
 - an optional 0/1 gradient mask multiplies the gradients before the
   clip, and the updates again after the optimizer, so masked entries do
   not move at all (the decoupled decay would otherwise shrink them);
 - clip_by_global_norm(1.0) and pytorch_transformers AdamW (train/optim.py);
 - bf16 products with fp32 master weights and optimizer state.

The model's parameters are the master weights and are updated in place; a
step returns the new optimizer state and step count. Metrics stay on the
device, so a step does not wait for it. The gradients accumulate into one
flat buffer that the step keeps from call to call (ops/multi_tensor.
GradBuffers); on the card the accumulation, the norm and the optimizer's
``apply`` each walk every parameter in one kernel launch. Under a profiler
a step is the span ``train.step`` (utils/profiling.span) holding
``train.accumulate`` (the loss and score sums), then for each microbatch
``train.forward``, ``train.backward`` and ``train.accumulate``, then
``train.clip`` (the global norm) and ``train.optimizer``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

from ..data.device_bank import DeviceFeatureBank
from ..models.layers import all_reduce, check_fused, fold_seed
from ..ops import multi_tensor
from ..ops.attention import shard_seed
from ..ops.semantic_prior import gqa_train_loss
from ..parallel.mesh import pspec, shard_model, shard_state_dict
from ..utils.profiling import span
from .optim import global_norm, masked

# the attention routes that take whole weights or head-major copies: one
# device only under Megatron mp, as in the JAX package
SINGLE_CHIP = (True, "hm", "proj", "sm")


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module      # fp32 master weights, updated in place
    opt_state: Any
    step: int                   # completed optimizer updates


def resolve_fused(fused_attn, compute_dtype, device: torch.device):
    """False, True, "flat", "hm", "proj" and "sm" pass through; "auto" is the
    flat training kernel for bf16 on CUDA and the plain path otherwise (the
    JAX FinetuneRunner's fused_attn="auto" rule, with the TPU read as
    CUDA); anything else raises ValueError."""
    if fused_attn == "auto":
        return ("flat" if compute_dtype == torch.bfloat16
                and device.type == "cuda" else False)
    check_fused(fused_attn)
    return fused_attn


def _with_bank_features(mb: Mapping, bank) -> dict:
    """A microbatch carrying ``store_idx`` gets its features, locs and image
    mask from the device bank (the row-gather kernel for the features)."""
    if bank is None or "store_idx" not in mb:
        return dict(mb)
    out = {k: v for k, v in mb.items() if k != "store_idx"}
    f, l, m = DeviceFeatureBank.gather_from(bank, mb["store_idx"])
    out.update(features=f, locs=l, image_mask=m)
    return out


def make_loss_fn(distance_matrix: torch.Tensor, *, semantic_lambda: float,
                 top_k: int = 10, compute_dtype=torch.bfloat16,
                 fused_attn=False,
                 criterion: str = "CrossEntropyLoss") -> Callable:
    """loss_fn(model, mb, seed, bank=None) -> (loss, score). ``seed`` None
    runs the deterministic forward; an int keys every dropout stream."""

    def loss_fn(model, mb, seed, bank=None):
        mb = _with_bank_features(mb, bank)
        fused = resolve_fused(fused_attn, compute_dtype, model.device)
        logits = model(mb, deterministic=seed is None, seed=seed,
                       compute_dtype=compute_dtype, fused_attn=fused)
        loss = gqa_train_loss(logits, mb["labels"], distance_matrix,
                              semantic_lambda=semantic_lambda, top_k=top_k,
                              num_labels=model.cfg.num_labels,
                              criterion=criterion)
        score = (logits.argmax(-1) == mb["labels"].long()).float().mean()
        return loss, score

    return loss_fn


def make_train_step(optimizer, distance_matrix: torch.Tensor, *,
                    semantic_lambda: float, top_k: int = 10,
                    compute_dtype=torch.bfloat16,
                    grad_mask: Mapping[str, torch.Tensor | None] | None = None,
                    fused_attn=False,
                    criterion: str = "CrossEntropyLoss") -> Callable:
    """train_step(state, batch, seed, bank=None) -> (state, metrics).

    ``optimizer``: :func:`train.optim.make_optimizer`'s chain, whose
    ``apply`` is given the gradients' global norm, computed once a step;
    an optimizer without ``apply`` gets the masked gradients through
    ``update`` (with ``norm`` under mp > 1) and its updates are added. ``batch``
    values are [acc, micro_bs, ...] tensors on the model's device;
    with a device bank (``bank`` = DeviceFeatureBank.tensors()) they carry
    int32 ``store_idx`` instead of features. ``seed`` (a host int) keys the
    step's dropout: microbatch a draws from fold_seed(seed, a). ``grad_mask``
    maps parameter names to 0/1 tensors or None (pass-through).
    fused_attn: False, "flat" (ops/attention.fused_attention_train_flat),
    "sm" (ops/attention.fused_attention_train_smajor), "proj"
    (ops/block_attention.fused_attention_block), True
    (ops/attention.fused_attention_train), "hm" (the True route, see
    models/layers.SelfAttention) or "auto". Metrics:
    ``loss``, ``score`` and ``grad_norm``, the norm of the masked gradients
    before the clip.

    The step runs as one rank of the mesh the model is laid out over
    (``model.mesh``, parallel/mesh.shard_model), if any: see
    :func:`shard_train_step`."""
    loss_fn = make_loss_fn(distance_matrix, semantic_lambda=semantic_lambda,
                           top_k=top_k, compute_dtype=compute_dtype,
                           fused_attn=fused_attn, criterion=criterion)
    masks = {}      # grad_mask cut for each mesh, on its first step there
    buffers = []    # the latest parameter list's GradBuffers

    def train_step(state: TrainState, batch: Mapping, seed: int, bank=None):
        with span("train.step"):
            return _step(state, batch, seed, bank)

    def _step(state: TrainState, batch: Mapping, seed: int, bank):
        model = state.model
        mesh = getattr(model, "mesh", None)
        dp_rank, dp_group = (0, None) if mesh is None else (mesh.dp_rank,
                                                            mesh.dp_group)
        mp = mesh is not None and mesh.n_mp > 1
        if mp and fused_attn in SINGLE_CHIP:
            raise ValueError(f"fused_attn={fused_attn!r} is a single-chip "
                             f"route; under mp > 1 use 'flat', 'auto' or "
                             f"False")
        mask = grad_mask
        if mp and grad_mask is not None:
            if mesh not in masks:
                masks[mesh] = shard_state_dict(grad_mask, mesh)
            mask = masks[mesh]
        params = dict(model.named_parameters())
        names, tensors = list(params), list(params.values())
        acc = next(iter(batch.values())).shape[0]
        with span("train.accumulate"):
            if not buffers or not buffers[0].fits(tensors):
                buffers[:] = [multi_tensor.GradBuffers(tensors)]
            buf = buffers[0]
            loss_sum = torch.zeros((), device=model.device)
            score_sum = torch.zeros((), device=model.device)
        for a in range(acc):
            with span("train.forward"):
                mb = {k: v[a] for k, v in batch.items()}
                loss, score = loss_fn(model, mb, shard_seed(fold_seed(seed, a),
                                                            dp_rank), bank)
            with span("train.backward"):
                gs = torch.autograd.grad(loss, tensors, allow_unused=True)
            with span("train.accumulate"):
                multi_tensor.accumulate(buf, gs, first=a == 0, n=acc)
                loss_sum = loss_sum + loss.detach() / acc
                score_sum = score_sum + score / acc
        if dp_group is not None:
            all_reduce(buf.flat, dp_group).div_(mesh.n_dp)
            loss_sum, score_sum = _dp_mean([loss_sum, score_sum], dp_group,
                                           mesh.n_dp)
        grads = dict(zip(names, buf.views))
        with span("train.clip"):
            # the norm of the masked gradients, once a step; under mp the
            # whole model's (each rank's own gradients hold only its shards)
            norm = global_norm(
                grads.values(),
                None if mask is None else [mask.get(k) for k in names],
                group=mesh.mp_group if mp else None,
                sharded=[pspec(k) is not None for k in names] if mp else None)
        with span("train.optimizer"), torch.no_grad():
            if optimizer.apply is not None:
                opt_state = optimizer.apply(grads, state.opt_state, params,
                                            norm=norm, mask=mask)
            else:
                updates, opt_state = optimizer.update(
                    masked(grads, mask), state.opt_state, params,
                    **({"norm": norm} if mp else {}))
                for k, u in masked(updates, mask).items():
                    params[k].add_(u)
        metrics = {"loss": loss_sum, "score": score_sum, "grad_norm": norm}
        return TrainState(model, opt_state, state.step + 1), metrics

    return train_step


def _dp_mean(tensors: list, group, n_dp: int) -> list:
    """The mean over the dp group of each fp32 tensor, summed in one flat
    buffer (apex's delay_allreduce: once a step, after accumulation)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce(flat, group).div_(n_dp)
    return [f.view_as(t) for f, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def shard_train_step(train_step: Callable, mesh) -> Callable:
    """``train_step`` (from :func:`make_train_step`) as one rank of a
    (dp, mp) mesh (port of clg_vqa_tpu/train/loop.py:332-416).

    The returned step takes this rank's state, whose model went through
    parallel/mesh.shard_model (or :func:`shard_train_state`), and this
    rank's [acc, micro_bs / dp, ...] slice of the batch
    (parallel/mesh.local_batch, or a TrainPipeline with host_id = dp rank
    and num_hosts = dp); the bank is replicated, ``store_idx`` comes with
    the batch. Each rank's dropout seeds are offset by its dp rank (and the
    attention's by its mp rank). The fp32 gradients are averaged over dp
    once a step, after accumulation and before the mask and the clip; the
    clip and ``grad_norm`` see the whole model's norm; ``loss`` and
    ``score`` are dp means. The grad mask is sliced like its parameters.
    As JAX's step runs over GSPMD-sharded inputs, the step is the same
    function: it reads the layout from ``model.mesh``, and the wrapper
    checks that the model is laid out over ``mesh``.

    Under mp > 1 only the flat kernels and the plain path run: True, "hm",
    "proj" and "sm" raise, as in JAX (:341-345)."""
    def step(state: TrainState, batch: Mapping, seed: int, bank=None):
        if getattr(state.model, "mesh", None) is not mesh:
            raise ValueError(f"the model is laid out for "
                             f"{getattr(state.model, 'mesh', None)}, the "
                             f"step for {mesh} (parallel/mesh.shard_model)")
        return train_step(state, batch, seed, bank)

    return step


def shard_train_state(state: TrainState, mesh) -> TrainState:
    """A whole TrainState laid out for this rank: the model through
    parallel/mesh.shard_model, the AdamW or RAdam moments sliced like their
    parameters."""
    shard_model(state.model, mesh)
    opt = state.opt_state
    return TrainState(state.model, opt._replace(
        mu=shard_state_dict(opt.mu, mesh), nu=shard_state_dict(opt.nu, mesh)),
        state.step)


def make_eval_step(*, compute_dtype=torch.bfloat16, fused_attn=False) -> Callable:
    """eval_step(model, batch, bank=None) -> {loss, correct, count, pred}:
    ForwardModelsVal for VL-classifier-GQA (task_utils.py:265-269,
    clg_vqa_tpu/train/loop.py:276-325). loss = num_labels * CE over the
    labeled rows (``valid`` * ``has_label``, both optional), correct = the
    number of labeled rows whose argmax is the label."""

    @torch.no_grad()
    def eval_step(model, batch, bank=None):
        batch = _with_bank_features(batch, bank)
        fused = resolve_fused(fused_attn, compute_dtype, model.device)
        logits = model(batch, deterministic=True, compute_dtype=compute_dtype,
                       fused_attn=fused)
        labels = batch["labels"].long()
        logp = torch.log_softmax(logits.float(), -1)
        ce = -logp.gather(-1, labels[:, None])[:, 0]
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones_like(ce)
        lab = valid.float() * batch.get("has_label", torch.ones_like(valid)).float()
        n = torch.clamp(lab.sum(), min=1.0)
        pred = logits.argmax(-1)
        return {"loss": model.cfg.num_labels * (ce * lab).sum() / n,
                "correct": ((pred == labels).float() * lab).sum(),
                "count": lab.sum(), "pred": pred}

    return eval_step
