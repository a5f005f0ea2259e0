"""VL pretraining heads and objective over the UC2 encoder (port of
clg_vqa_tpu/models/pretrain.py).

Rebuilds ``BertForVLPreTraining`` (volta/volta/encoders.py:1045-1152, heads
at 700-786):
 - masked LM: transform (dense + gelu + LN) -> a decoder TIED to the word
   embedding matrix (``model.embeddings.word``) + a free bias
   (BertLMPredictionHead, encoders.py:684-698); only the bias is a
   parameter of :class:`PretrainHeads`;
 - image-text matching: Linear(pooled -> itm_dim);
 - masked region modelling: BertImgPredictionHeadTransform + one decoder
   per enabled visual target ("0".."6", ops/pretrain_losses.py).

The fine-tuning path never runs these (CLG-VQA starts from released UC2/M3P
checkpoints); they complete the model family and run the same pretraining
objectives. The encoder runs its plain attention, as the JAX function calls
uc2.encode without a kernel route.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from ..config import UC2Config
from ..ops.pretrain_losses import (PRE_VIS_CRITERIONS, PRE_VIS_TARGETS,
                                   itm_loss, masked_lm_loss)
from . import layers as L


class _Transform(nn.Module):
    """dense -> gelu -> LayerNorm (BertPredictionHeadTransform)."""

    def __init__(self, H: int, eps: float, **kw):
        super().__init__()
        self.transform = L.Linear(H, H, **kw)
        self.ln = L.LayerNorm(H, eps, **kw)

    def head(self, x, compute_dtype=None):
        return self.ln(L.gelu(self.transform(x, compute_dtype)))


class LMHead(_Transform):
    def __init__(self, H: int, V: int, eps: float, **kw):
        super().__init__(H, eps, **kw)
        self.bias = nn.Parameter(torch.zeros(V, **kw))


class ImgHead(_Transform):
    def __init__(self, H: int, eps: float, targets: list[str], **kw):
        super().__init__(H, eps, **kw)
        self.decoders = nn.ModuleDict(
            {ix: L.Linear(H, PRE_VIS_TARGETS[ix], **kw) for ix in targets})


class PretrainHeads(nn.Module):
    """The MLM, ITM and masked-region heads of a UC2 (counterpart of
    init_pretrain_heads, clg_vqa_tpu/models/pretrain.py:31). One decoder for
    each visual target whose weight is > 0. Every Linear starts
    xavier-uniform with a zero bias, the MLM bias at 0."""

    def __init__(self, cfg: UC2Config, *, itm_dim: int = 2,
                 visual_target_weights=None, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        kw = {"device": dev, "dtype": dtype}
        weights = visual_target_weights or {"0": 1.0}
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.lm = LMHead(H, cfg.vocab_size, eps, **kw)
        self.itm = L.Linear(cfg.pooler_size, itm_dim, **kw)
        self.img = ImgHead(H, eps, [ix for ix, w in weights.items() if w > 0],
                           **kw)
        self.init_weights(torch.Generator(dev).manual_seed(seed))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, L.Linear):
                m.init_xavier_(generator)
        self.lm.bias.zero_()


def pretrain_forward(model, heads: PretrainHeads, batch: dict, *,
                     deterministic: bool = True, seed: int | None = None,
                     compute_dtype=None):
    """(text_logits [B, T, V] fp32, itm_logits [B, itm_dim],
    vis_preds {key: [B, R, dim]}) (clg_vqa_tpu/models/pretrain.py:55-81).
    The MLM decoder is the word embedding: the transformed text states are
    taken to fp32 and multiplied by ``model.embeddings.word`` in fp32, as
    JAX's dot of a low-precision and an fp32 operand promotes to fp32."""
    cd = compute_dtype
    seq, pooled = model.encode(batch, deterministic=deterministic, seed=seed,
                               compute_dtype=cd)
    T = batch["input_ids"].shape[1]
    seq_t, seq_v = seq[:, :T], seq[:, T:]
    h = heads.lm.head(seq_t, cd)
    text_logits = (torch.matmul(h.float(), model.embeddings.word.t())
                   + heads.lm.bias)
    itm_logits = heads.itm(pooled, cd)
    hv = heads.img.head(seq_v, cd)
    vis_preds = {ix: dec(hv, cd) for ix, dec in heads.img.decoders.items()}
    return text_logits, itm_logits, vis_preds


def pretrain_loss(model, heads: PretrainHeads, batch: dict, *,
                  visual_target_weights=None, seed: int | None = None,
                  compute_dtype=None, neg_idx: torch.Tensor | None = None
                  ) -> dict:
    """MLM + ITM + the weighted visual criterions (BertForVLPreTraining's
    loss accumulation, encoders.py:1098-1142): a dict of ``masked_lm``,
    ``itm``, ``vis_<key>`` for each of the heads' visual targets, and their
    sum ``total``.

    seed None runs the deterministic forward; an int drops with the
    encoder's streams keyed by fold_seed(seed, 0). nce_2048 ("2") draws its
    negatives from a generator seeded with fold_seed(seed, 1) (0 for the
    deterministic forward), or takes ``neg_idx``."""
    weights = visual_target_weights or {"0": 1.0}
    text_logits, itm_logits, vis_preds = pretrain_forward(
        model, heads, batch, deterministic=seed is None,
        seed=L.fold_seed(seed, 0), compute_dtype=compute_dtype)
    losses = {"masked_lm": masked_lm_loss(text_logits, batch["lm_labels"]),
              "itm": itm_loss(itm_logits, batch["is_match"])}
    nce_gen = torch.Generator(text_logits.device).manual_seed(
        0 if seed is None else L.fold_seed(seed, 1))
    for ix, pred in vis_preds.items():
        losses[f"vis_{ix}"] = weights[ix] * PRE_VIS_CRITERIONS[ix](
            pred.float(), batch["image_label"],
            image_cls=batch.get("image_cls"),
            image_feat=batch.get("features"),
            obj_labels=batch.get("obj_labels"),
            obj_confs=batch.get("obj_confs"),
            attr_labels=batch.get("attr_labels"),
            attr_confs=batch.get("attr_confs"),
            generator=nce_gen, neg_idx=neg_idx)
    losses["total"] = sum(losses.values())
    return losses
