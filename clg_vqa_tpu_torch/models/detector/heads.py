"""Fast R-CNN box and attribute predictors and the exact-36 NMS sweep (port
of clg_vqa_tpu/models/detector/heads.py:34-130).

- cls_score: 2048 -> 1601 (1600 VG classes + background); bbox_pred: 2048
  -> 1600*4 class-specific deltas, decoded with weights (10, 10, 5, 5);
- attributes: argmax over all 1601 scores -> class embedding (1601 -> 256)
  -> concat [2048 + 256] -> Linear -> ReLU -> Linear -> 401 logits;
- selection: per box the max foreground score and its class's refined
  box; NMS thresholds 0.5, 0.6, 0.7, 0.8, 0.9 tried in order until exactly
  n_keep survive, else the last threshold's result (the reference loop's
  fall-through). All five NMS runs go through one batched loop and the
  first exact hit is picked on the device, so nothing is read back.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ...ops.nms import greedy_nms
from .rpn import clip_boxes, decode_boxes

Params = dict[str, Any]


def _linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def box_predictor(feats: torch.Tensor, params: Params):
    """feats [R, 2048] -> (cls_logits [R, C+1], attr_logits [R, A+1],
    deltas [R, C*4])."""
    scores = _linear(feats, params["cls_score"])
    deltas = _linear(feats, params["bbox_pred"])
    cls_emb = params["cls_embedding"][scores.argmax(-1)]
    x = F.relu(_linear(torch.cat([feats, cls_emb], dim=-1), params["fc_attr"]))
    return scores, _linear(x, params["attr_score"]), deltas


def predict_boxes(proposals: torch.Tensor, deltas: torch.Tensor,
                  weights=(10.0, 10.0, 5.0, 5.0)) -> torch.Tensor:
    """Class-specific decode: proposals [..., R, 4], deltas [..., R, C*4] ->
    [..., R, C, 4]."""
    C = deltas.shape[-1] // 4
    d = deltas.reshape(*deltas.shape[:-1], C, 4)
    return decode_boxes(proposals[..., None, :].expand(d.shape), d, weights=weights)


def select_exactly_n(boxes_per_class: torch.Tensor, probs: torch.Tensor,
                     image_hw, *, n_keep: int = 36,
                     valid: torch.Tensor | None = None,
                     thresholds=(0.5, 0.6, 0.7, 0.8, 0.9)):
    """The reference's NMS sweep (detectron2_proposal_maxnms.py:126-132).

    boxes_per_class [R, C, 4] (foreground classes), probs [R, C+1]
    (background last), image_hw (h, w), valid [R] or None; or each with a
    leading image axis N, image_hw then [N, 2]. Returns (indices [n_keep],
    keep [n_keep], the threshold used), each with the leading N if given."""
    single = probs.dim() == 2
    if single:
        boxes_per_class, probs = boxes_per_class[None], probs[None]
        valid = None if valid is None else valid[None]
    n, R = probs.shape[:2]
    scores_fg = probs[..., :-1]
    max_classes = scores_fg.argmax(-1)                  # first maximum, as JAX
    max_scores = scores_fg.gather(-1, max_classes[..., None])[..., 0]
    sel = boxes_per_class.gather(
        2, max_classes[..., None, None].expand(n, R, 1, 4))[:, :, 0]
    hw = torch.as_tensor(image_hw, device=probs.device).reshape(-1, 2)
    sel = clip_boxes(sel, hw[:, 0, None], hw[:, 1, None])
    if valid is not None:
        max_scores = torch.where(valid, max_scores, float("-inf"))
    T = len(thresholds)
    thr = torch.tensor(thresholds, dtype=torch.float32,
                       device=probs.device).repeat(n)
    idx, keep = greedy_nms(sel.repeat_interleave(T, 0),
                           max_scores.repeat_interleave(T, 0), thr, n_keep,
                           valid=torch.isfinite(max_scores).repeat_interleave(T, 0))
    idx, keep = idx.view(n, T, n_keep), keep.view(n, T, n_keep)
    # the first threshold that keeps exactly n_keep, else the last one
    hit = keep.sum(-1) == n_keep
    hit[:, -1] = True
    first = hit.int().argmax(-1)
    rows = torch.arange(n, device=probs.device)
    out = idx[rows, first], keep[rows, first], thr.view(n, T)[rows, first]
    return tuple(x[0] for x in out) if single else out


def rescale_boxes(boxes: torch.Tensor, scale_x, scale_y, raw_hw) -> torch.Tensor:
    """detector_postprocess: network-input boxes back to the raw image, clipped."""
    out = torch.stack([boxes[:, 0] * scale_x, boxes[:, 1] * scale_y,
                       boxes[:, 2] * scale_x, boxes[:, 3] * scale_y], dim=1)
    return clip_boxes(out, raw_hw[0], raw_hw[1])


def init_box_predictor(gen: torch.Generator, *, in_dim: int = 2048,
                       num_classes: int = 1600, num_attrs: int = 400) -> Params:
    def lin(i, o, std):
        return {"w": torch.randn(i, o, generator=gen) * std, "b": torch.zeros(o)}

    emb_dim = in_dim // 8
    return {
        "cls_score": lin(in_dim, num_classes + 1, 0.01),
        "bbox_pred": lin(in_dim, num_classes * 4, 0.001),
        "cls_embedding": torch.randn(num_classes + 1, emb_dim, generator=gen) * 0.02,
        "fc_attr": lin(in_dim + emb_dim, in_dim // 4,
                       math.sqrt(2.0 / (in_dim + emb_dim))),
        "attr_score": lin(in_dim // 4, num_attrs + 1, 0.01),
    }
