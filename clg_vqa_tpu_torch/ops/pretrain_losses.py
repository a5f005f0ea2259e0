"""Visual pretraining criterions (port of clg_vqa_tpu/ops/pretrain_losses.py,
the rebuild of volta/volta/losses.py:16-147), plus the masked-LM and
image-text-matching losses of BertForVLPreTraining.

Keyed "0".."6" like the reference's ``pre_vis_criterions`` and selected by
``visual_target_weights`` in the model config (uc2_base.json uses {"0": 1.0}:
KL against the detector's 1601-way soft class distribution). Every loss
keeps the positions whose label is 1 (the masked-region indicator) and
divides by their count, as the reference does.

``nce_2048`` draws its negatives from a ``torch.Generator`` (JAX draws them
with jax.random: the distribution is the same, the stream is not), or takes
them as ``neg_idx`` [B, R, K] flat row indices, so that a caller can give it
the indices another run drew.
"""
from __future__ import annotations

import torch

PRE_VIS_TARGETS = {"0": 1601, "1": 2048, "2": 2048, "3": 1600, "4": 400,
                   "5": 2048, "6": 1601}


def _mask01(label: torch.Tensor, dtype) -> torch.Tensor:
    return (label == 1).to(dtype)


def kl_1601(pred, label, *, image_cls=None, **_):
    logp = torch.log_softmax(pred, dim=2)
    loss = image_cls * (torch.log(image_cls.clamp_min(1e-12)) - logp)
    m = _mask01(label, pred.dtype)
    return (loss * m[:, :, None]).sum() / m.sum().clamp_min(1)


def mse_2048(pred, label, *, image_feat=None, **_):
    loss = (pred - image_feat).square()
    m = _mask01(label, pred.dtype)
    return (loss * m[:, :, None]).sum() / (m.sum() * pred.shape[-1]).clamp_min(1)


def huber_2048(pred, label, *, image_feat=None, **_):
    d = pred - image_feat
    ad = d.abs()
    loss = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)
    m = _mask01(label, pred.dtype)
    return (loss * m[:, :, None]).sum() / (m.sum() * pred.shape[-1]).clamp_min(1)


def _xent_hard(pred, label, targets, confs, n_cls):
    logp = torch.log_softmax(pred.reshape(-1, n_cls), dim=-1)
    ce = -logp.gather(-1, targets.reshape(-1, 1).long())[:, 0]
    if confs is not None:
        ce = ce * confs.reshape(-1)
    m = _mask01(label.reshape(-1), pred.dtype)
    return (ce * m).sum() / m.sum().clamp_min(1)


def xent_1600(pred, label, *, obj_labels=None, obj_confs=None, **_):
    return _xent_hard(pred, label, obj_labels, obj_confs, 1600)


def xent_400(pred, label, *, attr_labels=None, attr_confs=None, **_):
    return _xent_hard(pred, label, attr_labels, attr_confs, 400)


def xent_1601(pred, label, *, obj_labels=None, **_):
    return _xent_hard(pred, label, obj_labels, None, 1601)


def nce_negative_indices(B: int, R: int, *, generator: torch.Generator,
                         num_negative: int = 128, device=None) -> torch.Tensor:
    """[B, R, K] flat row indices (b * R + r) of nce_2048's negatives:
    int(0.7 K) from other images of the batch (any region) and int(0.3 K)
    from the same image (another region), as pretrain_losses.py:75-84 draws
    them: a draw that would land on the positive's own image (row) or
    region (column) is remapped to the last one."""
    n_across, n_inside = int(num_negative * 0.7), int(num_negative * 0.3)
    kw = {"generator": generator, "device": device, "dtype": torch.long}
    rows_a = torch.randint(0, B - 1, (B, R, n_across), **kw)
    b = torch.arange(B, device=device)[:, None, None]
    rows_a = torch.where(rows_a == b, B - 1, rows_a)
    cols_a = torch.randint(0, R, (B, R, n_across), **kw)
    cols_i = torch.randint(0, R - 1, (B, R, n_inside), **kw)
    r = torch.arange(R, device=device)[None, :, None]
    cols_i = torch.where(cols_i == r, R - 1, cols_i)
    return torch.cat([rows_a * R + cols_a, b * R + cols_i], dim=2)


def nce_2048(pred, label, *, image_feat=None, generator=None, neg_idx=None,
             num_negative: int = 128, **_):
    """Contrastive feature prediction: the positive is the region's own
    feature, the negatives 70% cross-batch and 30% in-batch regions
    (``neg_idx``, else drawn from ``generator``)."""
    B, R, D = pred.shape
    if neg_idx is None:
        if generator is None:
            raise ValueError("nce_2048 needs a generator or neg_idx")
        neg_idx = nce_negative_indices(B, R, generator=generator,
                                       num_negative=num_negative,
                                       device=pred.device)
    negs = image_feat.reshape(B * R, D)[neg_idx.long()]         # [B, R, K, D]
    samples = torch.cat([image_feat[:, :, None, :], negs], dim=2)
    scores = torch.einsum("brkd,brd->brk", samples, pred)      # [B, R, K+1]
    ce = -torch.log_softmax(scores, dim=-1)[:, :, 0]
    m = _mask01(label, pred.dtype)
    return (ce * m).sum() / m.sum().clamp_min(1)


PRE_VIS_CRITERIONS = {"0": kl_1601, "1": mse_2048, "2": nce_2048,
                      "3": xent_1600, "4": xent_400, "5": huber_2048,
                      "6": xent_1601}


def masked_lm_loss(logits, labels, ignore_index: int = -1):
    """BertForVLPreTraining's text loss: CE with ignore_index -1
    (encoders.py:1051), in fp32."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(-1, safe[..., None])[..., 0]
    return (ce * valid).sum() / valid.sum().clamp_min(1)


def itm_loss(logits, is_match):
    """Image-text matching binary CE (the seq_relationship head)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, is_match.long()[:, None]).mean()
