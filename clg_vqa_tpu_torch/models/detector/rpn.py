"""Region Proposal Network, fixed shapes (port of
clg_vqa_tpu/models/detector/rpn.py:28-187).

3x3 conv (1024 -> 512) + ReLU -> 1x1 objectness [A] and deltas [4A];
detectron2 anchors (sizes x ratios at stride 16, area-preserving, zero
offset); decode with weights (1, 1, 1, 1) and the dw/dh clamp log(1000/16);
clip; top 6000 -> NMS 0.7 -> top 300 with a validity mask. ``jax.lax.top_k``
keeps the lower index among equal scores and orders fp32 totally (-0.0
below +0.0), so the top-k here is a stable descending sort of total-order
keys (``torch.topk`` on CUDA promises no order among ties).

The X101 detector uses maskrcnn-benchmark's legacy conventions instead:
caffe anchors (``generate_anchors_caffe``) and the TO_REMOVE=1 box widths
in the decode and the clip (``decode_boxes_legacy``, ``clip_boxes_legacy``).
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.nms import greedy_nms
from .resnet import conv

Params = dict[str, Any]


def _on_grid(cell: np.ndarray, feat_h: int, feat_w: int, stride: int) -> np.ndarray:
    """The cell's anchors [A, 4] shifted to every grid point at stride * i:
    [H*W*A, 4] xyxy, cell-major then anchor."""
    sx = np.arange(feat_w, dtype=np.float32) * stride
    sy = np.arange(feat_h, dtype=np.float32) * stride
    shift_x, shift_y = np.meshgrid(sx, sy)
    shifts = np.stack([shift_x.ravel(), shift_y.ravel(),
                       shift_x.ravel(), shift_y.ravel()], 1)
    return (shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4)


def generate_anchors(feat_h: int, feat_w: int, *, stride: int = 16,
                     sizes=(64, 128, 256, 512),
                     ratios=(0.5, 1.0, 2.0)) -> np.ndarray:
    """[H*W*A, 4] xyxy anchors, cell-major then anchor (detectron2's
    order)."""
    cell = []
    for size in sizes:
        area = float(size) ** 2
        for r in ratios:
            w = math.sqrt(area / r)
            h = w * r
            cell.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    cell = np.asarray(cell, np.float32)
    return _on_grid(cell, feat_h, feat_w, stride)


def generate_anchors_caffe(feat_h: int, feat_w: int, *, stride: int,
                           sizes=(32,), ratios=(0.5, 1.0, 2.0)) -> np.ndarray:
    """Legacy Detectron/caffe anchors, what vqa-maskrcnn-benchmark's
    AnchorGenerator uses (anchor_generator.py:183-232): a base (0, 0,
    stride-1, stride-1) window, rounded w/h in the aspect-ratio enumeration,
    centre (stride-1)/2; grid shifts at stride*i; ratio-major cell order.
    [H*W*A, 4] xyxy, A fastest. numpy, as in the JAX package, so the
    anchors are the same bits."""
    base = np.array([0.0, 0.0, stride - 1.0, stride - 1.0])

    def whctrs(a):
        w = a[2] - a[0] + 1.0
        h = a[3] - a[1] + 1.0
        return w, h, a[0] + 0.5 * (w - 1.0), a[1] + 0.5 * (h - 1.0)

    def mk(ws, hs, xc, yc):
        ws, hs = np.asarray(ws, np.float64), np.asarray(hs, np.float64)
        return np.stack([xc - 0.5 * (ws - 1.0), yc - 0.5 * (hs - 1.0),
                         xc + 0.5 * (ws - 1.0), yc + 0.5 * (hs - 1.0)], 1)

    w, h, xc, yc = whctrs(base)
    size = w * h
    ws = np.round(np.sqrt(size / np.asarray(ratios)))
    hs = np.round(ws * np.asarray(ratios))
    ratio_anchors = mk(ws, hs, xc, yc)
    cells = []
    scales = np.asarray(sizes, np.float64) / stride
    for i in range(ratio_anchors.shape[0]):
        w, h, xc, yc = whctrs(ratio_anchors[i])
        cells.append(mk(w * scales, h * scales, xc, yc))
    cell = np.vstack(cells).astype(np.float32)            # [R*S, 4]
    return _on_grid(cell, feat_h, feat_w, stride)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0),
                 clamp: float = math.log(1000.0 / 16)) -> torch.Tensor:
    """detectron2 Box2BoxTransform.apply_deltas on [..., 4] rows."""
    wx, wy, ww, wh = weights
    widths = anchors[..., 2] - anchors[..., 0]
    heights = anchors[..., 3] - anchors[..., 1]
    ctr_x = anchors[..., 0] + 0.5 * widths
    ctr_y = anchors[..., 1] + 0.5 * heights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=clamp)
    dh = (deltas[..., 3] / wh).clamp(max=clamp)
    pcx = dx * widths + ctr_x
    pcy = dy * heights + ctr_y
    pw = torch.exp(dw) * widths
    ph = torch.exp(dh) * heights
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)


def clip_boxes(boxes: torch.Tensor, h, w) -> torch.Tensor:
    """Clip [..., N, 4] boxes to [0, w] x [0, h]; h and w are numbers or
    tensors broadcastable against [..., N] (one per image)."""
    h = torch.as_tensor(h, dtype=boxes.dtype, device=boxes.device)
    w = torch.as_tensor(w, dtype=boxes.dtype, device=boxes.device)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([torch.clamp(x1, zero, w), torch.clamp(y1, zero, h),
                        torch.clamp(x2, zero, w), torch.clamp(y2, zero, h)], -1)


def decode_boxes_legacy(anchors: torch.Tensor, deltas: torch.Tensor,
                        clamp: float = math.log(1000.0 / 16)) -> torch.Tensor:
    """maskrcnn-benchmark BoxCoder.decode (box_coder.py:52-96) on [..., 4]
    rows: widths x2 - x1 + 1 and x2 = ctr + 0.5 w - 1, the convention the
    released X-101 checkpoint's deltas assume."""
    widths = anchors[..., 2] - anchors[..., 0] + 1.0
    heights = anchors[..., 3] - anchors[..., 1] + 1.0
    ctr_x = anchors[..., 0] + 0.5 * widths
    ctr_y = anchors[..., 1] + 0.5 * heights
    dw = deltas[..., 2].clamp(max=clamp)
    dh = deltas[..., 3].clamp(max=clamp)
    pcx = deltas[..., 0] * widths + ctr_x
    pcy = deltas[..., 1] * heights + ctr_y
    pw = torch.exp(dw) * widths
    ph = torch.exp(dh) * heights
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw - 1.0, pcy + 0.5 * ph - 1.0], dim=-1)


def clip_boxes_legacy(boxes: torch.Tensor, h, w) -> torch.Tensor:
    """BoxList.clip_to_image with TO_REMOVE=1 (bounding_box.py:203-208):
    clamp to [0, size - 1]; h and w as in :func:`clip_boxes`."""
    return clip_boxes(boxes, torch.as_tensor(h) - 1, torch.as_tensor(w) - 1)


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys that order fp32 values as XLA's sort and top_k do: a
    total order in which -0.0 < +0.0 (IEEE comparison calls them equal)."""
    bits = x.float().contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values along the last axis in
    ``jax.lax.top_k``'s order: descending, ties to the lower index, -0.0
    below +0.0 (a stable sort of total-order keys)."""
    return torch.sort(total_order_key(x), dim=-1, descending=True,
                      stable=True).indices[..., :k]


def rpn_head(feat: torch.Tensor, params: Params):
    """feat [N, H, W, C] -> objectness [N, H, W, A], deltas [N, H, W, A, 4]."""
    t = F.relu(conv(feat, params["conv"]))
    obj = conv(t, params["objectness"])
    deltas = conv(t, params["deltas"])
    A = obj.shape[-1]
    return obj, deltas.reshape(*deltas.shape[:-1], A, 4)


def propose(obj: torch.Tensor, deltas: torch.Tensor, anchors: torch.Tensor,
            image_hw, *, pre_nms_topk: int = 6000, post_nms_topk: int = 300,
            nms_thresh: float = 0.7, valid_mask: torch.Tensor | None = None):
    """obj [N, H, W, A] (or one image's [H, W, A]); deltas [..., A, 4];
    anchors [H*W*A, 4]; image_hw: (h, w), or an [N, 2] tensor of each
    image's. Returns (boxes [N, post, 4], scores [N, post], valid
    [N, post]), without the leading N for one image."""
    single = obj.dim() == 3
    if single:
        obj, deltas = obj[None], deltas[None]
        valid_mask = None if valid_mask is None else valid_mask[None]
    n = obj.shape[0]
    logits = obj.reshape(n, -1)
    if valid_mask is not None:
        logits = torch.where(valid_mask.reshape(n, -1), logits, float("-inf"))
    k = min(pre_nms_topk, logits.shape[1])
    top_idx = top_k_indices(logits, k)
    top_scores = logits.gather(1, top_idx)
    top_boxes = decode_boxes(anchors[top_idx],
                             deltas.reshape(n, -1, 4).gather(
                                 1, top_idx[..., None].expand(n, k, 4)))
    hw = torch.as_tensor(image_hw, device=obj.device).reshape(-1, 2)
    top_boxes = clip_boxes(top_boxes, hw[:, 0, None], hw[:, 1, None])
    keep_idx, keep = greedy_nms(top_boxes, top_scores, nms_thresh, post_nms_topk,
                                valid=torch.isfinite(top_scores))
    boxes = top_boxes.gather(1, keep_idx[..., None].expand(n, post_nms_topk, 4))
    scores = top_scores.gather(1, keep_idx)
    if single:
        return boxes[0], scores[0], keep[0]
    return boxes, scores, keep


def init_rpn(gen: torch.Generator, *, in_channels: int = 1024,
             hid_channels: int = 512, num_anchors: int = 12) -> Params:
    def c(k, cin, cout):
        return {"w": torch.randn(cout, cin, k, k, generator=gen) * 0.01,
                "b": torch.zeros(cout)}

    return {"conv": c(3, in_channels, hid_channels),
            "objectness": c(1, hid_channels, num_anchors),
            "deltas": c(1, hid_channels, num_anchors * 4)}
