"""Iterative magnitude pruning (IMP) and sparse fine-tuning (SFT) masks (port
of clg_vqa_tpu/train/pruning.py): the lottery-ticket recipe of the paper
(SURVEY.md §2: train_task_prunning.py, train_task_sft.py).

A mask is a dict of the model's parameter names -> a float32 0/1 tensor of
the parameter's shape on its device for a prunable weight, or None for a
pass-through one. The prunable set is every attention q/k/v/o weight, every
FFN weight and the text pooler weight (train_task_prunning.py:45-66; biases
and LayerNorms excluded), in port names ``encoder.{b}.attn.{q,k,v,o}.weight``,
``encoder.{b}.ffn.{w1,w2}.weight`` and ``pooler.weight``; M3P's live path
has the same structure.

Semantics kept from the JAX package:
 - a round prunes ``fraction`` of the currently surviving weights, globally
   over the concatenated |w| of the prunable set, exactly the k smallest
   with k = round(fraction * survivors) counted as an integer; pruned
   slots score +inf (5 rounds of 10% -> 1 - 0.9^5 = 40.95%);
 - the concatenation follows the JAX package's flat order (its leaves in
   sorted path order, each the [L, in, out] stack raveled), and ties at the
   threshold go to the lower flat index (a stable sort), so the CPU and
   the card give the same mask;
 - mask files are the JAX package's: an npz keyed by JAX paths
   (``encoder/attn/q/w``, ..., ``pooler/w``) holding float32 [L, in, out]
   stacks for the encoder and [in, out] for the pooler, so either package
   reads the other's files.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

# prunable leaf paths of the JAX package's pytrees ("/"-joined), the keys
# of a mask file
PRUNABLE_UC2 = (
    "encoder/attn/q/w", "encoder/attn/k/w", "encoder/attn/v/w",
    "encoder/attn/o/w", "encoder/ffn/w1/w", "encoder/ffn/w2/w", "pooler/w",
)
PRUNABLE_M3P = PRUNABLE_UC2   # the same live-path structure

Mask = dict[str, "torch.Tensor | None"]


def _params(params) -> dict[str, torch.Tensor]:
    """{name: tensor} of a model's parameters, or ``params`` itself."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _jax_path(name: str) -> tuple[str, int | None]:
    """(JAX leaf path, block index or None) of a port parameter name; a
    Linear weight's leaf is ``w``."""
    parts = name.split(".")
    block = None
    if parts[0] == "encoder" and len(parts) > 1 and parts[1].isdigit():
        block = int(parts.pop(1))
    parts[-1] = {"weight": "w", "bias": "b"}.get(parts[-1], parts[-1])
    return "/".join(parts), block


def prunable_paths(params, model: str = "uc2") -> set[str]:
    """The port names of ``params``' prunable weights."""
    pats = PRUNABLE_UC2 if model == "uc2" else PRUNABLE_M3P
    return {n for n in _params(params) if _jax_path(n)[0] in pats}


def _flat_order(names) -> list[str]:
    """Prunable names in the JAX package's flat order: leaf paths sorted,
    blocks ascending within a leaf."""
    def key(n):
        path, block = _jax_path(n)
        return path, -1 if block is None else block
    return sorted(names, key=key)


def init_mask(params, model: str = "uc2") -> Mask:
    """All-ones float32 masks for the prunable weights; None elsewhere."""
    pats = prunable_paths(params, model)
    return {n: torch.ones_like(p, dtype=torch.float32) if n in pats else None
            for n, p in _params(params).items()}


@torch.no_grad()
def imp_prune_step(params, mask: Mapping, fraction: float = 0.1) -> Mask:
    """One IMP round: a new mask that also zeroes the ``fraction`` smallest
    |w| among the surviving prunable weights, globally (exactly k of them,
    like torch's topk). Runs on the mask's device: the |w| scores never
    leave it."""
    ps = _params(params)
    names = _flat_order(n for n, m in mask.items() if m is not None)
    # [out, in] weights transposed to the JAX [in, out] layout, so the
    # concatenation is the JAX package's flat vector
    allw = torch.cat([ps[n].detach().float().abs().t().reshape(-1)
                      for n in names])
    allm = torch.cat([mask[n].t().reshape(-1) for n in names])
    # an exact integer count (torch prune counts with numel)
    surviving = int((allm > 0).sum())
    k = int(round(fraction * surviving))
    if k > 0:
        scores = allw.masked_fill_(~(allm > 0), float("inf"))
        kill = torch.argsort(scores, stable=True)[:k]
        allm[kill] = 0.0
    out = dict(mask)
    off = 0
    for n in names:
        shape = mask[n].shape
        out[n] = allm[off:off + mask[n].numel()].reshape(
            shape[1], shape[0]).t().contiguous()
        off += mask[n].numel()
    return out


def sparsity(mask: Mapping) -> float:
    """% zeros over the prunable set (see_weight_rate_uc2 semantics)."""
    tot = zeros = 0
    for m in mask.values():
        if m is None:
            continue
        tot += m.numel()
        zeros += int((m == 0).sum())
    return 100.0 * zeros / max(tot, 1)


@torch.no_grad()
def apply_mask(params, mask: Mapping):
    """params * mask on the prunable weights, in place (the SFT init,
    train_task_sft.py:438-453); returns ``params``."""
    ps = _params(params)
    for n, m in mask.items():
        if m is not None:
            ps[n].mul_(m)
    return params


def grad_mask_tree(mask: Mapping) -> Mask:
    """The mask as train/loop.make_train_step's ``grad_mask``: the 0/1 mask
    where prunable, None (pass-through) elsewhere."""
    return dict(mask)


def save_mask(path: str, mask: Mapping) -> None:
    """The mask as the JAX package's npz: keys are JAX leaf paths, encoder
    leaves [L, in, out] float32 stacks, the pooler [in, out]."""
    leaves: dict[str, dict] = {}
    for n, m in mask.items():
        if m is not None:
            key, block = _jax_path(n)
            leaves.setdefault(key, {})[block] = (
                m.detach().float().t().cpu().numpy())
    flat = {key: blocks[None] if None in blocks
            else np.stack([blocks[b] for b in sorted(blocks)])
            for key, blocks in leaves.items()}
    np.savez_compressed(path, **flat)


def load_mask(path: str, params, model: str = "uc2") -> Mask:
    """A JAX-format mask npz onto ``params``' names and devices. Every key
    must be a prunable path of this model family (a mask saved for another
    family, or with stale keys, must not load wherever names match)."""
    ps = _params(params)
    allowed = {_jax_path(n)[0] for n in prunable_paths(ps, model)}
    with np.load(path) as data:
        unknown = sorted(set(data.files) - allowed)
        if unknown:
            raise ValueError(
                f"mask {path} contains {len(unknown)} key(s) that are not "
                f"prunable paths of model {model!r}: {unknown[:5]}...")
        leaves = {k: data[k] for k in data.files}
    out: Mask = {}
    for n, p in ps.items():
        key, block = _jax_path(n)
        if key not in leaves:
            out[n] = None
            continue
        a = leaves[key] if block is None else leaves[key][block]
        if tuple(a.shape[::-1]) != tuple(p.shape):
            raise ValueError(f"mask {path}: {key} gives {n} the shape "
                             f"{a.shape[::-1]}, not {tuple(p.shape)}")
        out[n] = torch.from_numpy(np.ascontiguousarray(a.T, np.float32)).to(
            p.device)
    return out
