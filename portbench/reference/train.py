"""The GQA fine-tuning step of the paper's recipe, in plain float32 torch.

Per step: for each microbatch a the loss ``num_labels * (CE + lambda *
semantic prior)`` with dropout keyed by the step's seed folded with a; the
gradients divided by the number of microbatches and summed; the global
norm clipped to 1.0 (g / ||g|| when ||g|| >= 1); pytorch_transformers'
AdamW (eps outside the square root, the step ``lr * sqrt(1 - b2^t) / (1 -
b1^t)``, the decoupled decay applied to the updated weight and scaled by
the raw lr) on the leaves that the model's ``decays`` names (UC2 and M3P:
not biases and LayerNorms). The semantic prior
(task_utils.py:418-421 of the recipe) is the top-k of the softmax dotted
with the label's row of the distance matrix."""
from __future__ import annotations

import torch

from .precision import FP32, Precision
from .seeds import fold_seed


def gqa_loss(logits, labels, D, *, lam: float, top_k: int, num_labels: int):
    labels = labels.long()
    logp = torch.log_softmax(logits, -1)
    ce = -logp.gather(-1, labels[:, None]).mean()
    p_top, idx = torch.topk(torch.softmax(logits, -1), top_k, dim=-1)
    sem = (p_top * D[labels[:, None], idx]).sum(-1).mean()
    return num_labels * (ce + lam * sem)


def train_steps(model, cfg: dict, w0: dict, steps: list, seeds: list, D, *,
                lr, recipe: dict, prec: Precision = FP32,
                rows: float = 1.0, keep_grad: bool = False) -> dict:
    """Run len(steps) optimizer steps of the reference module ``model``
    (its ``forward`` and ``decays``; e.g. reference/model.py) from the
    weights ``w0``.

    steps[s]: the microbatches of step s (dicts as ``model.forward`` takes,
    with ``labels``); seeds[s]: step s's seed; lr(count): the learning rate
    of the update after ``count`` completed ones. ``rows`` < 1 takes each
    microbatch's leading share of rows only (a planted fault: part of the
    batch left out, the mean over the rest).

    Returns {"loss": [each step's loss], "grad": {name: ||g|| of step 1's
    clipped gradient}, "grad_raw": {name: ||g|| before the clip},
    "change": {name: ||w_S - w_0||}}, and with ``keep_grad`` "g1": {name:
    step 1's clipped gradient}."""
    b1, b2 = recipe["adam_b1"], recipe["adam_b2"]
    eps, wd, clip = recipe["adam_eps"], recipe["weight_decay"], recipe["clip"]
    w = {k: v.detach().clone().requires_grad_() for k, v in w0.items()}
    m = {k: torch.zeros_like(v) for k, v in w0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in w0.items()}
    out = {"loss": []}
    names = list(w)
    for s, (mbs, seed) in enumerate(zip(steps, seeds)):
        grads = {k: torch.zeros_like(v) for k, v in w0.items()}
        total = 0.0
        for a, mb in enumerate(mbs):
            if rows < 1.0:
                n = max(1, int(mb["labels"].shape[0] * rows))
                mb = {k: t[:n] for k, t in mb.items()}
            logits = model.forward(cfg, w, mb, seed=fold_seed(seed, a), prec=prec)
            loss = gqa_loss(logits, mb["labels"], D, lam=recipe["lambda"],
                            top_k=recipe["top_k"],
                            num_labels=logits.shape[-1])
            gs = torch.autograd.grad(loss, [w[k] for k in names],
                                     allow_unused=True)
            for k, g in zip(names, gs):
                if g is not None:
                    grads[k] += g / len(mbs)
            total += loss.item() / len(mbs)
        out["loss"].append(total)
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        if norm >= clip:
            grads = {k: g / norm * clip for k, g in grads.items()}
        if s == 0:
            out["grad"] = {k: g.norm().item() for k, g in grads.items()}
            scale = max(norm.item(), clip) / clip
            out["grad_raw"] = {k: x * scale for k, x in out["grad"].items()}
            if keep_grad:
                out["g1"] = {k: g.clone() for k, g in grads.items()}
        t = s + 1
        rate = lr(s)
        step = rate * (1 - b2 ** t) ** 0.5 / (1 - b1 ** t)
        with torch.no_grad():
            for k in names:
                m[k].mul_(b1).add_(grads[k], alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(grads[k], grads[k], value=1 - b2)
                new = w[k] - step * m[k] / (v2[k].sqrt() + eps)
                if wd > 0 and model.decays(k):
                    new = new - rate * wd * new
                w[k].copy_(new)
        del grads
    out["change"] = {k: (w[k].detach() - w0[k]).norm().item() for k in names}
    return out
