"""RoIPool on NHWC features (B6): the CUDA kernel ``csrc/roi_pool.cu`` and
its plain PyTorch version.

Port of clg_vqa_tpu/ops/roi_pallas.py:roi_pool_pallas (:70-124, kernel
body ``_kernel`` :30-67), the C4 extractor's pooler on the TPU
(models/detector/extractor.py:264-269). It computes what
:func:`..ops.roi.roi_pool` computes on the [H, W, C] layout the backbone
emits: [R, PH, PW, C] in the features' dtype. The TPU entry falls back to
the XLA op on maps smaller than its fixed VMEM window (:80-88); the CUDA
kernel takes every map size, so nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .attention import _DTYPES
from .roi import roi_pool

_NAME = "roi_pool"


def roi_pool_nhwc_plain(features: torch.Tensor, rois: torch.Tensor, *,
                        output_size: tuple[int, int], spatial_scale: float,
                        max_bin: int = 8) -> torch.Tensor:
    """The plain version: ``ops/roi.roi_pool`` on the channel-first view,
    moved back to [R, PH, PW, C]."""
    out = roi_pool(features.permute(2, 0, 1), rois, output_size=output_size,
                   spatial_scale=spatial_scale, max_bin=max_bin)
    return out.permute(0, 2, 3, 1).contiguous()


@functools.cache
def _kernel():
    lib = _build.load(_NAME)
    fn = lib.roi_pool_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def roi_pool_nhwc(features: torch.Tensor, rois: torch.Tensor, *,
                  output_size: tuple[int, int], spatial_scale: float,
                  max_bin: int = 8) -> torch.Tensor:
    """Quantized RoI max pooling of features [H, W, C] over rois [R, 4]
    (xyxy, input-image coordinates) into [R, PH, PW, C], features' dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (fp32 or bf16, C a multiple of 16 bytes) or raise. No backward: raises in
    grad mode when the features require grad."""
    if features.dim() != 3 or rois.dim() != 2 or rois.shape[-1] != 4:
        raise ValueError(f"features must be [H, W, C] and rois [R, 4], got "
                         f"{tuple(features.shape)} {tuple(rois.shape)}")
    if torch.is_grad_enabled() and features.requires_grad:
        raise RuntimeError("roi_pool_nhwc has no backward (feature extraction "
                           "is inference); call it under torch.no_grad()")
    if features.device.type == "cpu":
        return roi_pool_nhwc_plain(features, rois, output_size=output_size,
                                   spatial_scale=spatial_scale, max_bin=max_bin)
    if features.device.type != "cuda":
        raise ValueError(f"unsupported device {features.device}")
    H, W, C = features.shape
    PH, PW = output_size
    if features.dtype not in _DTYPES or (C * features.element_size()) % 16:
        raise ValueError(f"the CUDA kernel takes fp32/bf16 features whose "
                         f"channels fill 16-byte vectors; got {features.dtype}, "
                         f"C={C}")
    feats = features.contiguous()
    r = rois.to(device=feats.device, dtype=torch.float32).contiguous()
    if feats.data_ptr() % 16:
        raise ValueError("roi_pool_nhwc's features must start on a 16-byte "
                         "boundary")
    R = r.shape[0]
    out = torch.empty(R, PH, PW, C, dtype=feats.dtype, device=feats.device)
    if R == 0:
        return out
    err = _kernel()(_DTYPES[feats.dtype], feats.data_ptr(), r.data_ptr(),
                    out.data_ptr(), H, W, C, R, PH, PW, spatial_scale, max_bin,
                    torch.cuda.current_stream(feats.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{_NAME} kernel launch failed: CUDA error {err}")
    roi_pool_nhwc.launches += 1
    return out


roi_pool_nhwc.launches = 0
