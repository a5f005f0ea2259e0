"""RoI feature ops in plain PyTorch (port of clg_vqa_tpu/ops/roi.py):
quantized RoI max pooling (``roi_pool``, :29-75), the plain version of the
RoIPool kernel B6 (``ops/roi_pool.py``, ``csrc/roi_pool.cu``), and RoIAlign
(``roi_align``, :79-137; ``roi_align_flat``, :140-246), which the X101
detector runs as torch ops (XLA code in JAX, no Pallas kernel).

RoIPool semantics (torchvision RoIPool, as the reference's CUDA ROIPool): roi
corners scaled and rounded in f32 (round half to even, as ``jnp.round``),
exact integer bin boundaries, each bin cut to ``max_bin`` rows and columns
from its start, empty bins give 0. As in JAX, each of the ``max_bin**2``
window offsets is one gather of ``[C, R, PH, PW]`` folded into a running
max, so memory does not grow with the window.

RoIAlign semantics (detectron2 / torchvision RoIAlign): ``aligned=True``
shifts coordinates by -0.5, ``aligned=False`` (legacy) clamps the roi to at
least 1 x 1; ``sampling_ratio`` x ``sampling_ratio`` points per bin,
averaged; bilinear interpolation with edge clamping, samples outside
[-1, size] give 0. Each sample point is one gather of [R, PH, PW, C] rows
from a channels-last map, its four corner products summed in fp32 in JAX's
order ((a + b) + c) + d and added to the accumulator, so the results are
JAX's to rounding. Outputs are channel-first [R, C, PH, PW], the order in
which the X101 box head's fc6 reads the flattened crop.
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


def _align_samples(flat: torch.Tensor, rois: torch.Tensor, scale: torch.Tensor,
                   Hb: torch.Tensor, Wb: torch.Tensor, off_b: torch.Tensor, *,
                   output_size: tuple[int, int], sampling_ratio: int,
                   aligned: bool) -> torch.Tensor:
    """The RoIAlign of each roi on its own map: flat [L, C] channels-last
    rows of every map; per roi [R] its scale, map height and width (fp32)
    and its map's first row. Returns [R, PH, PW, C] fp32."""
    PH, PW = output_size
    S = sampling_ratio
    if S < 1:
        raise ValueError("adaptive sampling_ratio is not supported; pass an int >= 1")
    R, C = rois.shape[0], flat.shape[1]
    dev = rois.device
    off = 0.5 if aligned else 0.0
    x1 = rois[:, 0] * scale - off
    y1 = rois[:, 1] * scale - off
    rw = rois[:, 2] * scale - off - x1
    rh = rois[:, 3] * scale - off - y1
    if not aligned:                      # legacy: clamp min size 1
        rw = rw.clamp(min=1.0)
        rh = rh.clamp(min=1.0)
    bin_h, bin_w = rh / PH, rw / PW
    ph = torch.arange(PH, dtype=torch.float32, device=dev)
    pw = torch.arange(PW, dtype=torch.float32, device=dev)
    Hc, Wc = Hb[:, None], Wb[:, None]
    Hi, Wi = (Hc - 1).long(), (Wc - 1).long()
    row, stride = off_b[:, None, None], Wb.long()[:, None, None]

    def g(yy, xx):
        lin = row + yy[:, :, None] * stride + xx[:, None, :]
        return flat[lin.reshape(-1)].view(R, PH, PW, C)

    acc = torch.zeros(R, PH, PW, C, dtype=torch.float32, device=dev)
    for k in range(S * S):
        iy, ix = divmod(k, S)
        ys = y1[:, None] + (ph[None] + (iy + 0.5) / S) * bin_h[:, None]
        xs = x1[:, None] + (pw[None] + (ix + 0.5) / S) * bin_w[:, None]
        inside = (((ys >= -1.0) & (ys <= Hc))[:, :, None]
                  & ((xs >= -1.0) & (xs <= Wc))[:, None, :])
        y = torch.minimum(ys.clamp(min=0.0), Hc - 1)
        x = torch.minimum(xs.clamp(min=0.0), Wc - 1)
        y0, x0 = y.floor().long(), x.floor().long()
        y1i, x1i = torch.minimum(y0 + 1, Hi), torch.minimum(x0 + 1, Wi)
        ly = (y - y0)[:, :, None]
        lx = (x - x0)[:, None, :]
        hy, hx = 1.0 - ly, 1.0 - lx
        val = (g(y0, x0) * (hy * hx)[..., None] + g(y0, x1i) * (hy * lx)[..., None]
               + g(y1i, x0) * (ly * hx)[..., None] + g(y1i, x1i) * (ly * lx)[..., None])
        acc = acc + torch.where(inside[..., None], val.float(), 0.0)
    return acc / (S * S)


def roi_align(features: torch.Tensor, rois: torch.Tensor, *,
              output_size: tuple[int, int], spatial_scale: float,
              sampling_ratio: int = 2, aligned: bool = True) -> torch.Tensor:
    """features [C, H, W]; rois [R, 4] xyxy in input-image coordinates.
    Returns [R, C, PH, PW] in the features' dtype."""
    C, H, W = features.shape
    R, dev = rois.shape[0], rois.device
    full = torch.full((R,), 1.0, dtype=torch.float32, device=dev)
    acc = _align_samples(features.reshape(C, H * W).t(), rois.float(),
                         full * spatial_scale, full * H, full * W,
                         torch.zeros(R, dtype=torch.long, device=dev),
                         output_size=output_size, sampling_ratio=sampling_ratio,
                         aligned=aligned)
    return acc.permute(0, 3, 1, 2).to(features.dtype)


def roi_align_flat(flat_features: torch.Tensor, rois: torch.Tensor,
                   levels: torch.Tensor, *, level_shapes: tuple,
                   spatial_scales: tuple, output_size: tuple[int, int],
                   sampling_ratio: int = 2, aligned: bool = True,
                   box_chunk: int | None = None) -> torch.Tensor:
    """RoIAlign over a flattened feature pyramid in one pass, each roi
    sampling only its assigned level.

    flat_features: [sum(H_l * W_l), C], each level's channels-last map
    flattened and the levels concatenated (JAX's is the transpose,
    [C, sum(H_l * W_l)]: rows of C contiguous values gather whole on the
    card); rois [R, 4] xyxy image coordinates; levels [R] integer index into
    ``level_shapes`` / ``spatial_scales``. Returns [R, C, PH, PW] fp32; a
    bf16 pyramid is read as bf16 and accumulated in fp32.

    box_chunk: run the rois in sequential chunks of the largest divisor of
    R not above it (unchunked when that divisor is 1, or for None or <= 0).
    Each roi's arithmetic is its own, so the result is bit-identical to the
    unchunked pass; a chunk bounds the four fp32 corner products, each
    [chunk, PH, PW, C] ([1000, 7, 7, 512], 100 MB an image unchunked)."""
    R = rois.shape[0]
    chunk = R
    if box_chunk is not None and 0 < box_chunk < R:
        chunk = max(c for c in range(1, box_chunk + 1) if R % c == 0)
        chunk = R if chunk == 1 else chunk
    if chunk < R:
        return torch.cat([roi_align_flat(
            flat_features, rois[i:i + chunk], levels[i:i + chunk],
            level_shapes=level_shapes, spatial_scales=spatial_scales,
            output_size=output_size, sampling_ratio=sampling_ratio,
            aligned=aligned) for i in range(0, R, chunk)])
    dev = rois.device
    Hs = torch.tensor([h for h, _ in level_shapes], dtype=torch.float32, device=dev)
    Ws = torch.tensor([w for _, w in level_shapes], dtype=torch.float32, device=dev)
    offs = torch.tensor([0] + [h * w for h, w in level_shapes][:-1],
                        device=dev).cumsum(0)
    scales = torch.tensor(spatial_scales, dtype=torch.float32, device=dev)
    lv = levels.long()
    acc = _align_samples(flat_features, rois.float(), scales[lv], Hs[lv], Ws[lv],
                         offs[lv], output_size=output_size,
                         sampling_ratio=sampling_ratio, aligned=aligned)
    return acc.permute(0, 3, 1, 2)
