"""Flat-boundary eval attention: the CUDA kernel ``csrc/flat_attention.cu``
and its plain PyTorch version.

Port of clg_vqa_tpu/ops/attention.py:fused_attention_flat (:549-593, kernel
body ``_flat_fwd_kernel`` :385-410 at keep_t=256). q/k/v keep the
projections' [B, S, H*hd] layout and the kernel loops over heads itself, so
no head split/merge transposes exist around it. Numerics: QK^T post-scaled
by 1/sqrt(hd) in fp32, additive key-side bias, fp32 softmax, fp32 P.V
accumulation, output cast to q's dtype.

The training variants (dropout, backward) belong to the training slice
(ROADMAP.md).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448          # bytes of shared memory one H100 block may use


@functools.cache
def _kernel():
    lib = _build.load("flat_attention")
    fn = lib.flat_attention_fwd
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    smem = lib.flat_attention_smem_bytes
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_longlong
    return fn, smem


def _bias2(bias: torch.Tensor, B: int, S: int) -> torch.Tensor:
    """[B, 1, 1, S]-broadcastable additive bias -> contiguous fp32 [B, S]."""
    return bias.expand(B, 1, 1, S)[:, 0, 0, :].float().contiguous()


def fused_attention_flat_plain(q, k, v, bias, num_heads: int) -> torch.Tensor:
    """The plain PyTorch version: upcast, matmul, fp32 softmax, matmul, cast."""
    B, S, HD = q.shape
    hd = HD // num_heads

    def heads(x):
        return x.float().reshape(B, S, num_heads, hd).transpose(1, 2)

    scores = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * (
        1.0 / math.sqrt(hd))
    scores = scores + _bias2(bias, B, S)[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs, heads(v))
    return out.transpose(1, 2).reshape(B, S, HD).to(q.dtype)


def fused_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, num_heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + bias) v per head on [B, S, H*hd] operands.

    bias: additive key-side, broadcastable to [B, 1, 1, S]. CPU tensors take
    the plain version; CUDA tensors launch the kernel (fp32 or bf16,
    hd in {32, 64, 128}) or raise."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, S, H*hd] shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    B, S, HD = q.shape
    if HD % num_heads:
        raise ValueError(f"H*hd={HD} is not divisible by num_heads={num_heads}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q/k/v must share one dtype")
    if q.device.type == "cpu":
        return fused_attention_flat_plain(q, k, v, bias, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    hd = HD // num_heads
    if q.dtype not in _DTYPES or hd not in (32, 64, 128):
        raise ValueError(f"the CUDA kernel takes fp32/bf16 with hd in "
                         f"(32, 64, 128); got {q.dtype}, hd={hd}")
    fn, smem_bytes = _kernel()
    if smem_bytes(S, hd) > _MAX_SMEM:
        raise ValueError(f"S={S} needs {smem_bytes(S, hd)} bytes of shared "
                         f"memory per block, over the {_MAX_SMEM} limit")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b2 = _bias2(bias.to(q.device), B, S)
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             b2.data_ptr(), out.data_ptr(), B, S, num_heads, hd,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flat_attention kernel launch failed: CUDA error {err}")
    fused_attention_flat.launches += 1
    return out


fused_attention_flat.launches = 0
