"""Quantized RoI max pooling in plain PyTorch: the port of
clg_vqa_tpu/ops/roi.py:roi_pool (:29-75), the plain version of the RoIPool
kernel B6 (``ops/roi_pool.py``, ``csrc/roi_pool.cu``).

Semantics (torchvision RoIPool, as the reference's CUDA ROIPool): roi
corners scaled and rounded in f32 (round half to even, as ``jnp.round``),
exact integer bin boundaries, each bin cut to ``max_bin`` rows and columns
from its start, empty bins give 0. As in JAX, each of the ``max_bin**2``
window offsets is one gather of ``[C, R, PH, PW]`` folded into a running
max, so memory does not grow with the window.
"""
from __future__ import annotations

import torch


def roi_bins(rois: torch.Tensor, PH: int, PW: int, H: int, W: int,
             spatial_scale: float):
    """(hstart, hend [R, PH], wstart, wend [R, PW]) int64 bin bounds, clipped
    to the map (not yet cut to ``max_bin``)."""
    q = torch.round(rois.float() * torch.tensor(spatial_scale, dtype=torch.float32,
                                                device=rois.device)).long()
    x1, y1, x2, y2 = q.unbind(1)
    roi_h = (y2 - y1 + 1).clamp(min=1)
    roi_w = (x2 - x1 + 1).clamp(min=1)
    ph = torch.arange(PH, device=rois.device)
    pw = torch.arange(PW, device=rois.device)
    hs = ((ph[None] * roi_h[:, None]) // PH + y1[:, None]).clamp(0, H)
    he = (((ph[None] + 1) * roi_h[:, None] + PH - 1) // PH + y1[:, None]).clamp(0, H)
    ws = ((pw[None] * roi_w[:, None]) // PW + x1[:, None]).clamp(0, W)
    we = (((pw[None] + 1) * roi_w[:, None] + PW - 1) // PW + x1[:, None]).clamp(0, W)
    return hs, he, ws, we


def roi_pool(features: torch.Tensor, rois: torch.Tensor, *,
             output_size: tuple[int, int], spatial_scale: float,
             max_bin: int = 16) -> torch.Tensor:
    """features [C, H, W]; rois [R, 4] xyxy in input-image coordinates.
    Returns [R, C, PH, PW] in the features' dtype. ``max_bin`` bounds the
    per-bin window (>= ceil(H * scale / PH) + 1); larger bins are cut."""
    C, H, W = features.shape
    PH, PW = output_size
    R = rois.shape[0]
    hs, he, ws, we = roi_bins(rois, PH, PW, H, W, spatial_scale)
    flat = features.reshape(C, H * W)
    neg = torch.tensor(float("-inf"), dtype=features.dtype, device=features.device)
    acc = torch.full((C, R, PH, PW), float("-inf"), dtype=features.dtype,
                     device=features.device)
    for k in range(max_bin * max_bin):
        dy, dx = divmod(k, max_bin)
        Y, X = hs + dy, ws + dx
        valid = (Y < he)[:, :, None] & (X < we)[:, None, :]
        lin = Y.clamp(max=H - 1)[:, :, None] * W + X.clamp(max=W - 1)[:, None, :]
        vals = flat[:, lin.reshape(-1)].reshape(C, R, PH, PW)
        acc = torch.maximum(acc, torch.where(valid[None], vals, neg))
    acc = torch.where(torch.isfinite(acc), acc, torch.zeros((), dtype=acc.dtype,
                                                            device=acc.device))
    return acc.permute(1, 0, 2, 3)
