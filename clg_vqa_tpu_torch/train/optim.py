"""Optimizer and learning-rate schedules of the reference fine-tuning recipe
(port of clg_vqa_tpu/train/optim.py:38-246).

The reference uses ``pytorch_transformers.AdamW`` with
``WarmupLinearSchedule`` (volta/train_task.py:263-276) and no weight decay on
biases and LayerNorm parameters (train_task.py:249-260). That AdamW differs
from ``torch.optim.AdamW``: eps sits outside the sqrt, the step is
``lr * sqrt(1 - b2^t) / (1 - b1^t)``, and the decoupled decay applies to the
UPDATED parameter, scaled by the raw lr. It is written out here, as the JAX
package writes it, with the same fp32 scalar arithmetic.

An optimizer is a pair of functions over name -> tensor dicts, as in optax:
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``; the caller adds the updates. The moments are updated in place (the
port keeps one copy of each, as PyTorch optimizers do). The step count is a
host integer, so the schedule never waits for the device. The reference
chain (:func:`make_optimizer`) also has ``apply``, which updates the
parameters itself: on the card in one pass over every parameter
(ops/multi_tensor.adamw), on the CPU through ``update``.
"""
from __future__ import annotations

from typing import Callable, Iterable, Mapping, NamedTuple

import numpy as np
import torch

from ..models.layers import all_reduce
from ..ops import multi_tensor

Tensors = Mapping[str, torch.Tensor]


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) -> (updates,
    state)``. A chain that a train step runs under Megatron mp > 1 must also
    take ``norm=``, the gradients' global norm over the whole model
    (:func:`make_optimizer`'s does): no rank can compute it alone.
    ``apply(grads, state, params, *, norm, mask) -> state``, where given,
    does what ``update`` and the caller's masked add of the updates do, in
    place: ``mask`` maps names to 0/1 tensors or None (pass-through) and
    multiplies the gradients before the clip and the updates after it."""
    init: Callable
    update: Callable
    apply: Callable | None = None


class AdamWState(NamedTuple):
    count: int        # completed updates
    mu: dict
    nu: dict


class RAdamState(NamedTuple):
    count: int
    mu: dict
    nu: dict


def _f32(x) -> np.float32:
    return np.float32(x)


def _lr(learning_rate, count: int) -> np.float32:
    return _f32(learning_rate(count) if callable(learning_rate) else learning_rate)


def _zeros(params: Tensors) -> dict:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def _moments(state, grads: Tensors, b1: float, b2: float) -> None:
    for k, g in grads.items():
        m, v = state.mu[k], state.nu[k]
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)


def _adamw_scalars(learning_rate, count: int, b1: float, b2: float,
                   weight_decay: float, correct_bias: bool):
    """(step, decay), the fp32 host scalars of AdamW's update number
    ``count + 1``."""
    lr = _lr(learning_rate, count)
    if correct_bias:
        t = _f32(count + 1)
        step = _f32(lr * np.sqrt(_f32(1) - _f32(b2) ** t)
                    / (_f32(1) - _f32(b1) ** t))
    else:
        step = lr
    return step, _f32(lr * _f32(weight_decay))


def adamw_pt(learning_rate: float | Callable[[int], float], b1: float = 0.9,
             b2: float = 0.999, eps: float = 1e-6, weight_decay: float = 1e-4,
             correct_bias: bool = True,
             decay_mask: Mapping[str, bool] | None = None) -> Optimizer:
    """pytorch_transformers-semantics AdamW (clg_vqa_tpu/train/optim.py:38-79).
    ``learning_rate`` is a constant or a schedule of the count of completed
    updates; ``decay_mask`` maps names to True where decay applies
    (None: everywhere)."""

    def init(params: Tensors) -> AdamWState:
        return AdamWState(0, _zeros(params), _zeros(params))

    def update(grads: Tensors, state: AdamWState, params: Tensors):
        count = state.count + 1
        _moments(state, grads, b1, b2)
        step, decay = _adamw_scalars(learning_rate, state.count, b1, b2,
                                     weight_decay, correct_bias)
        updates = {}
        for k, p in params.items():
            new_p = p - float(step) * state.mu[k] / (state.nu[k].sqrt() + eps)
            if weight_decay > 0 and (decay_mask is None or decay_mask[k]):
                new_p = new_p - float(decay) * new_p
            updates[k] = new_p - p
        return updates, AdamWState(count, state.mu, state.nu)

    return Optimizer(init, update)


def radam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0,
          decay_mask: Mapping[str, bool] | None = None) -> Optimizer:
    """Rectified Adam of volta/volta/optimization.py:9-93 (the reference's
    --optim RAdam; clg_vqa_tpu/train/optim.py:198-246): the SGDM fallback
    while rho <= 5, and decay ``p -= lr * wd * p`` before the step."""
    rho_inf = 2.0 / (1.0 - b2) - 1.0

    def init(params: Tensors) -> RAdamState:
        return RAdamState(0, _zeros(params), _zeros(params))

    def update(grads: Tensors, state: RAdamState, params: Tensors):
        lr = _lr(learning_rate, state.count)
        count = state.count + 1
        t = _f32(count)
        _moments(state, grads, b1, b2)
        beta2_t = _f32(b2) ** t
        rho = _f32(_f32(rho_inf) - _f32(2.0) * t * beta2_t / (_f32(1) - beta2_t))
        adaptive = rho > 5.0
        if adaptive:
            rect = np.sqrt(_f32(((rho - 4) * (rho - 2) * _f32(rho_inf))
                                / max(_f32((rho_inf - 4) * (rho_inf - 2)) * rho,
                                      _f32(1e-12))))
            step = _f32(lr * rect * np.sqrt(_f32(1) - beta2_t)
                        / (_f32(1) - _f32(b1) ** t))
        else:
            step = _f32(lr / (_f32(1) - _f32(b1) ** t))
        decay = _f32(lr * _f32(weight_decay))
        updates = {}
        for k, p in params.items():
            base = p
            if weight_decay > 0 and (decay_mask is None or decay_mask[k]):
                base = p - float(decay) * p
            if adaptive:
                new_p = base - float(step) * state.mu[k] / (
                    state.nu[k].sqrt() + eps)
            else:
                new_p = base - float(step) * state.mu[k]
            updates[k] = new_p - p
        return updates, RAdamState(count, state.mu, state.nu)

    return Optimizer(init, update)


def warmup_linear_schedule(base_lr: float, warmup_steps: int,
                           total_steps: int) -> Callable[[int], float]:
    """WarmupLinearSchedule, indexed by the count of completed updates: the
    first update runs at factor(0) = 0 when warmup > 0, as torch's LambdaLR
    applies it (clg_vqa_tpu/train/optim.py:82-97). fp32 arithmetic."""
    w = _f32(max(1.0, float(warmup_steps)))
    rest = _f32(max(1.0, float(total_steps - warmup_steps)))

    def sched(step: int) -> float:
        s = _f32(step)
        if s < warmup_steps:
            f = s / w
        else:
            f = max(_f32(0), (_f32(total_steps) - s) / rest)
        return float(_f32(base_lr) * f)

    return sched


def warmup_constant_schedule(base_lr: float,
                             warmup_steps: int) -> Callable[[int], float]:
    """Linear warmup to ``base_lr``, then constant (optim.py:100-106)."""
    w = _f32(max(1.0, float(warmup_steps)))

    def sched(step: int) -> float:
        return float(_f32(base_lr) * min(_f32(1), _f32(step) / w))

    return sched


def no_decay_mask(names: Iterable[str]) -> dict[str, bool]:
    """name -> True where weight decay applies. The JAX package's rule
    (optim.py:109-129) on the port's names: no decay for biases and for
    everything under a LayerNorm module (``ln``, ``ln*``, ``*_ln``, and
    ``*_ln_*`` for VL-BERT's visual_ln_text / visual_ln_object), whose JAX
    ``scale``/``bias`` leaves are the port's ``weight``/``bias``."""

    def decays(name: str) -> bool:
        *mods, leaf = name.split(".")
        in_ln = any(m == "ln" or m.endswith("_ln") or m.startswith("ln")
                    or "_ln_" in m for m in mods)
        return not (leaf == "bias" or in_ln)

    return {n: decays(n) for n in names}


def freeze_mask(params: Tensors, fixed_layers: list[str]) -> dict | None:
    """train_utils.freeze_layers (train_utils.py:305-318) as a gradient
    mask (optim.py:172-189): zeros for parameters whose port name contains
    any of the ``fixed_layers`` substrings, None (pass-through) elsewhere;
    None without fixed layers."""
    if not fixed_layers:
        return None
    return {k: (torch.zeros_like(p) if any(f in k for f in fixed_layers)
                else None) for k, p in params.items()}


def global_norm(tensors: Iterable[torch.Tensor], masks=None, *, group=None,
                sharded: Iterable[bool] | None = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, on the device, each
    tensor times its entry of ``masks`` (None, or a list with None for a
    pass-through): ops/multi_tensor.norm.

    Under Megatron mp (``group``, the mp process group) the tensors flagged
    in ``sharded`` are this rank's shards: their sums of squares are summed
    over the group, and every other tensor, replicated over it, counts
    once, so every rank gets the whole model's norm (what GSPMD gives the
    JAX package). The per-tensor sums are added in the tensors' order
    either way."""
    idx = [i for i, s in enumerate(sharded or ()) if s]
    reduce = None
    if group is not None and idx:
        def reduce(sq):
            at = torch.tensor(idx, device=sq.device)
            return sq.index_copy(0, at, all_reduce(sq.index_select(0, at),
                                                   group))
    return multi_tensor.norm(tensors, masks, reduce)


def clip_by_global_norm(grads: Tensors, max_norm: float,
                        norm: torch.Tensor | None = None) -> dict:
    """optax's clip_by_global_norm: ``g / ||g|| * max_norm`` when
    ``||g|| >= max_norm``, else g unchanged. Unlike
    ``torch.nn.utils.clip_grad_norm_`` no epsilon joins the norm. Decided
    on the device, without a host synchronisation. ``norm``: ||g|| when the
    caller has it (a sharded step's :func:`global_norm` over the mp
    group)."""
    if norm is None:
        norm = global_norm(grads.values())
    keep = norm < max_norm
    return {k: torch.where(keep, g, (g / norm) * max_norm)
            for k, g in grads.items()}


def masked(tensors: Tensors, mask) -> dict:
    """``tensors`` times ``mask`` (name -> 0/1 tensor, None or a missing
    name: pass-through; None: no mask)."""
    if mask is None:
        return dict(tensors)
    return {k: t if mask.get(k) is None else t * mask[k]
            for k, t in tensors.items()}


def make_optimizer(names: Iterable[str], schedule, *, b1=0.9, b2=0.999,
                   eps=1e-6, weight_decay=1e-4, correct_bias=True,
                   clip_norm: float = 1.0) -> Optimizer:
    """The reference chain (optim.py:132-146): clip_by_global_norm(1.0),
    then AdamW with pytorch_transformers semantics and no decay on biases
    and LayerNorms. Its ``update`` takes the gradients' global norm as
    ``norm`` where the caller has computed it; its ``apply`` (the train
    step's, train/loop.py) always does. ``apply`` launches
    ops/multi_tensor.adamw on CUDA tensors (fp32 only: it raises on any
    other), and runs ``update`` and the masked ``p.add_`` on CPU tensors;
    the two are bit-equal on the card."""
    decay_mask = no_decay_mask(names)
    adam = adamw_pt(schedule, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                    correct_bias=correct_bias, decay_mask=decay_mask)

    def update(grads, state, params, norm=None):
        return adam.update(clip_by_global_norm(grads, clip_norm, norm), state,
                           params)

    @torch.no_grad()
    def apply(grads, state: AdamWState, params, *, norm, mask=None):
        if next(iter(params.values())).device.type == "cpu":
            updates, state = update(masked(grads, mask), state, params, norm)
            for k, u in masked(updates, mask).items():
                params[k].add_(u)
            return state
        step, decay = _adamw_scalars(schedule, state.count, b1, b2,
                                     weight_decay, correct_bias)
        names = list(params)
        multi_tensor.adamw(
            params.values(), [state.mu[k] for k in names],
            [state.nu[k] for k in names], [grads[k] for k in names],
            None if mask is None else [mask.get(k) for k in names],
            [weight_decay > 0 and decay_mask[k] for k in names], norm=norm,
            b1=b1, b2=b2, eps=eps, step=step, decay=decay, max_norm=clip_norm)
        return AdamWState(state.count + 1, state.mu, state.nu)

    return Optimizer(adam.init, update, apply)


def fastforward_count(opt_state, step: int):
    """The optimizer state with its update count set to ``step``: a
    params-only resume keeps the schedule position and the bias-correction
    clock (optim.py:149-169)."""
    return opt_state._replace(count=int(step))
