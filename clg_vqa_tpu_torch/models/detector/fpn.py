"""Feature Pyramid Network and the X101 box head (port of
clg_vqa_tpu/models/detector/fpn.py), the mmf / vqa-maskrcnn-benchmark
feature pipeline.

FPN (maskrcnn-benchmark): 1x1 laterals on C2..C5, top-down nearest 2x
upsampling to each lateral's shape, 3x3 output convs -> P2..P5, and P6 =
P5[:, ::2, ::2] (LastLevelMaxPool, max_pool2d(k=1, s=2)). RoI features:
RoIAlign 7x7 (sampling ratio 2, legacy aligned=False) on the level
level = floor(4 + log2(sqrt(area) / 224 + 1e-6)), clamped to P2..P5; head:
flatten channel-first -> fc6 -> ReLU -> fc7 -> ReLU; the feature served to
M3P is the post-ReLU fc6.

Selection (extract_features_vmb.py:173-226): softmax over 1601 columns;
per-class NMS(0.5) over classes 1..1600 with shared proposal boxes (the
parallel fixpoint of ``ops/nms.py``); max kept confidence per box; a
stable descending sort; the top 100.

Maps are NHWC, as in ``resnet.py``; conv weights OIHW.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ...ops.nms import batched_nms_fixpoint
from ...ops.roi import roi_align, roi_align_flat
from ..layers import matmul_f32
from .resnet import conv
from .rpn import top_k_indices

Params = dict[str, Any]


def _up_to(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Nearest upsampling of NHWC x to like's height and width, on pixel
    centres (``jax.image.resize(..., "nearest")``: "nearest-exact")."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=like.shape[1:3],
                      mode="nearest-exact")
    return y.permute(0, 2, 3, 1)


def fpn(features: tuple, params: Params) -> list:
    """features = (C2, C3, C4, C5) NHWC. Returns [P2, P3, P4, P5, P6]."""
    c2, c3, c4, c5 = features
    l5 = conv(c5, params["lateral"][3])
    l4 = conv(c4, params["lateral"][2])
    l3 = conv(c3, params["lateral"][1])
    l2 = conv(c2, params["lateral"][0])
    t4 = l4 + _up_to(l5, l4)
    t3 = l3 + _up_to(t4, l3)
    t2 = l2 + _up_to(t3, l2)
    p5 = conv(l5, params["output"][3])
    p4 = conv(t4, params["output"][2])
    p3 = conv(t3, params["output"][1])
    p2 = conv(t2, params["output"][0])
    return [p2, p3, p4, p5, p5[:, ::2, ::2, :]]


def assign_levels(boxes: torch.Tensor, *, k_min: int = 2, k_max: int = 5,
                  canonical_scale: float = 224.0, canonical_level: int = 4,
                  legacy: bool = False) -> torch.Tensor:
    """maskrcnn-benchmark LevelMapper: each box's level clamped to
    [k_min, k_max], returned relative to P2 (0..3, int64). legacy=True
    takes the TO_REMOVE=1 area (w = x2 - x1 + 1) the reference's
    LevelMapper receives."""
    t = 1.0 if legacy else 0.0
    w = (boxes[:, 2] - boxes[:, 0] + t).clamp(min=0)
    h = (boxes[:, 3] - boxes[:, 1] + t).clamp(min=0)
    s = torch.sqrt(w * h)
    lvl = torch.floor(canonical_level + torch.log2(s / canonical_scale + 1e-6))
    return (lvl.clamp(k_min, k_max) - k_min).long()


def multilevel_roi_align(pyramid: list, boxes: torch.Tensor, *,
                         output_size=(7, 7), sampling_ratio: int = 2,
                         base_stride: int = 4) -> torch.Tensor:
    """RoIAlign every box on each of P2..P5 ([1, H, W, C] maps), then take
    each box's assigned level. Returns [R, C, PH, PW]."""
    lvls = assign_levels(boxes)
    outs = torch.stack([roi_align(
        pyramid[i][0].permute(2, 0, 1), boxes, output_size=output_size,
        spatial_scale=1.0 / (base_stride * 2 ** i), sampling_ratio=sampling_ratio,
        aligned=False) for i in range(4)])                      # [4, R, C, PH, PW]
    return outs[lvls, torch.arange(boxes.shape[0], device=boxes.device)]


def multilevel_roi_align_flat(pyramid: list, boxes: torch.Tensor, *,
                              output_size=(7, 7), sampling_ratio: int = 2,
                              base_stride: int = 4, legacy_levels: bool = False,
                              box_chunk: int | None = None) -> torch.Tensor:
    """multilevel_roi_align's result in one pass over the flattened P2..P5
    ([1, H, W, C] maps, fp32 or bf16): each box gathers only from its level.
    Returns [R, C, PH, PW] fp32. box_chunk: see ``ops/roi.roi_align_flat``."""
    lvls = assign_levels(boxes, legacy=legacy_levels)
    maps = [p[0] for p in pyramid[:4]]                          # [H, W, C]
    flat = torch.cat([m.reshape(-1, m.shape[-1]) for m in maps])
    return roi_align_flat(
        flat, boxes, lvls, level_shapes=tuple(tuple(m.shape[:2]) for m in maps),
        spatial_scales=tuple(1.0 / (base_stride * 2 ** i) for i in range(4)),
        output_size=output_size, sampling_ratio=sampling_ratio, aligned=False,
        box_chunk=box_chunk)


def box_head_fc(crops: torch.Tensor, params: Params, compute_dtype=None):
    """[R, C, 7, 7] -> (fc6 [R, D], fc7 [R, D]), both after the ReLU and
    fp32. With a compute dtype, fc6 and fc7 take operands in it (fc7 the
    cast of fc6), accumulate in fp32 and add the fp32 bias."""
    x = crops.reshape(crops.shape[0], -1)
    w6, w7 = params["fc6"]["w"], params["fc7"]["w"]
    if compute_dtype is not None:
        x, w6, w7 = x.to(compute_dtype), w6.to(compute_dtype), w7.to(compute_dtype)
    fc6 = F.relu(matmul_f32(x, w6) + params["fc6"]["b"])
    fc7 = F.relu(matmul_f32(fc6.to(x.dtype), w7) + params["fc7"]["b"])
    return fc6, fc7


def select_top_by_class_nms(boxes: torch.Tensor, probs: torch.Tensor, *,
                            num_keep: int = 100, nms_thresh: float = 0.5,
                            conf_thresh: float = 0.0,
                            valid: torch.Tensor | None = None,
                            legacy: bool = False):
    """extract_features_vmb's per-class NMS selection. boxes [N, 4] shared
    by the classes; probs [N, C+1] softmax (column 0 the background,
    skipped); valid [N] or None. Returns (indices [num_keep], max_conf
    [num_keep], objects [num_keep] the foreground argmax). Boxes of equal
    max_conf (the zero-confidence ones among them) keep their index order,
    as ``jnp.argsort``'s stable sort gives."""
    fg = probs[:, 1:]
    keep_c = batched_nms_fixpoint(boxes, fg.t(), nms_thresh, valid=valid,
                                  legacy=legacy)
    kept = torch.where(keep_c & (fg.t() > conf_thresh), fg.t(), 0.0)
    max_conf = kept.amax(0)                                     # [N]
    order = top_k_indices(max_conf, num_keep)
    objects = fg.argmax(1)                                      # first maximum
    return order, max_conf[order], objects[order]


def init_fpn(gen: torch.Generator, *, in_channels=(256, 512, 1024, 2048),
             out_channels: int = 256) -> Params:
    def c(k, cin, cout):
        return {"w": torch.randn(cout, cin, k, k, generator=gen)
                * math.sqrt(2.0 / (k * k * cin)), "b": torch.zeros(cout)}

    return {"lateral": [c(1, cin, out_channels) for cin in in_channels],
            "output": [c(3, out_channels, out_channels) for _ in in_channels]}


def init_box_head_fc(gen: torch.Generator, *, in_dim: int = 256 * 7 * 7,
                     rep_dim: int = 2048) -> Params:
    return {"fc6": {"w": torch.randn(in_dim, rep_dim, generator=gen) * 0.01,
                    "b": torch.zeros(rep_dim)},
            "fc7": {"w": torch.randn(rep_dim, rep_dim, generator=gen) * 0.01,
                    "b": torch.zeros(rep_dim)}}
