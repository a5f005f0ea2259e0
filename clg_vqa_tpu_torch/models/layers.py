"""Shared neural-net primitives, numerics-matched to clg_vqa_tpu/models/layers.py.

Linear weights are stored torch-style **[out, in]**. Numerics kept from the
JAX package (and through it from the reference):
- LayerNorm: TF-style, eps inside the sqrt, computed in fp32 (:25-33).
- GeLU: exact erf form (:36-38).
- ``linear`` with a compute dtype: low-precision operands, fp32
  accumulation, fp32 bias added to the fp32 accumulator, ONE cast (:41-55).
- Masks: additive ``(1 - m) * -10000`` (:127-130), RoBERTa position ids
  (:119-124).
- Unfused attention: QK^T post-scaled in fp32, fp32 softmax, probs cast to
  the compute dtype before P.V (``softmax_lowp``'s forward value, :61-92).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.attention import fused_attention_flat


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """TF-style LayerNorm (eps inside the sqrt), computed in fp32."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GeLU (the reference uses this, not the tanh approximation)."""
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an fp32 result accumulated in fp32, for 2-D operands of
    one dtype. ``torch.matmul`` on bf16 rounds the product to bf16, which
    would round twice around the bias add. On CUDA this asks cuBLAS for an
    fp32 output from bf16 operands (``out_dtype``); the CPU build has no
    kernel for that, so there the operands are upcast (bf16 values are
    exact in fp32)."""
    if a.dtype == torch.float32 or a.device.type != "cuda":
        return torch.mm(a.float(), b.float())
    return torch.mm(a, b, out_dtype=torch.float32)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x @ weight.T + bias. With a compute dtype: operands in that dtype,
    fp32 accumulation, the fp32 bias added to the fp32 accumulator, and the
    result cast to the compute dtype once (clg_vqa_tpu/models/layers.py:41-55)."""
    if compute_dtype is None:
        return torch.nn.functional.linear(x, weight, bias)
    x2 = x.reshape(-1, x.shape[-1]).to(compute_dtype)
    y = matmul_f32(x2, weight.to(compute_dtype).t()) + bias
    return y.to(compute_dtype).reshape(*x.shape[:-1], weight.shape[0])


def create_position_ids_from_input_ids(input_ids: torch.Tensor,
                                       padding_idx: int) -> torch.Tensor:
    """RoBERTa-style positions: padding_idx+1.. for non-pad tokens,
    padding_idx for pads (volta/volta/embeddings.py:160-170)."""
    mask = (input_ids != padding_idx).long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


def additive_mask(mask01: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, S] {0,1} -> [B, 1, 1, S] additive mask, exactly -10000 at pads
    (volta/volta/encoders.py:987-995)."""
    return ((1.0 - mask01.to(dtype)) * -10000.0)[:, None, None, :]


class Linear(nn.Module):
    """Weight [out, in] + bias, applied with :func:`linear`'s epilogue."""

    def __init__(self, d_in: int, d_out: int, *, device, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device,
                                               dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device, dtype=dtype))

    def forward(self, x, compute_dtype=None):
        return linear(x, self.weight, self.bias, compute_dtype)

    @torch.no_grad()
    def init_normal_(self, std: float, generator: torch.Generator):
        self.weight.normal_(0.0, std, generator=generator)
        self.bias.zero_()

    @torch.no_grad()
    def init_xavier_(self, generator: torch.Generator):
        d_out, d_in = self.weight.shape
        limit = math.sqrt(6.0 / (d_in + d_out))
        self.weight.uniform_(-limit, limit, generator=generator)
        self.bias.zero_()


class LayerNorm(nn.Module):
    """TF-style LayerNorm (:func:`layer_norm`), scale 1 and bias 0 at init."""

    def __init__(self, d: int, eps: float, *, device, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


def check_fused(fused) -> None:
    if fused not in (False, "flat"):
        raise NotImplementedError(
            f"fused_attn={fused!r}: only False and 'flat' (eval) are ported; "
            f"the training and head-blocked kernels are queued in ROADMAP.md")


class SelfAttention(nn.Module):
    """Multi-head self-attention with q/k/v/o projections (UC2 post-scales
    QK^T, volta/volta/encoders.py:266)."""

    def __init__(self, d: int, num_heads: int, *, device, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.q = Linear(d, d, device=device, dtype=dtype)
        self.k = Linear(d, d, device=device, dtype=dtype)
        self.v = Linear(d, d, device=device, dtype=dtype)
        self.o = Linear(d, d, device=device, dtype=dtype)

    def forward(self, x, attn_bias, *, compute_dtype=None, fused=False):
        """x [B, S, D], attn_bias additive [B, 1, 1, S].

        fused=False: plain PyTorch core (clg_vqa_tpu/models/layers.py:294-327).
        fused="flat": the flat eval attention kernel
        (ops/attention.fused_attention_flat)."""
        check_fused(fused)
        B, S, D = x.shape
        H = self.num_heads
        hd = D // H
        q = self.q(x, compute_dtype)
        k = self.k(x, compute_dtype)
        v = self.v(x, compute_dtype)
        if fused == "flat":
            return self.o(fused_attention_flat(q, k, v, attn_bias, H),
                          compute_dtype)

        def heads(t):
            return t.float().reshape(B, S, H, hd).transpose(1, 2)

        # products of low-precision values are exact in fp32, so the fp32
        # matmul on upcast operands is the fp32-accumulated product
        scores = torch.matmul(heads(q), heads(k).transpose(-1, -2))
        scores = scores * (1.0 / math.sqrt(hd)) + attn_bias
        probs = torch.softmax(scores, dim=-1)
        if compute_dtype is not None:
            probs = probs.to(compute_dtype)
        ctx = torch.matmul(probs.float(), heads(v))
        return self.o(ctx.transpose(1, 2).reshape(B, S, D), compute_dtype)


class FeedForward(nn.Module):
    """w2(gelu(w1(x))), each linear with the compute-dtype epilogue."""

    def __init__(self, d: int, d_ff: int, *, device, dtype=torch.float32):
        super().__init__()
        self.w1 = Linear(d, d_ff, device=device, dtype=dtype)
        self.w2 = Linear(d_ff, d, device=device, dtype=dtype)

    def forward(self, x, compute_dtype=None):
        return self.w2(gelu(self.w1(x, compute_dtype)), compute_dtype)


class SimpleClassifier(nn.Module):
    """The reference's SimpleClassifier (volta encoders.py:788-815):
    (dropout ->) fc1 -> GeLU -> LN -> fc2 (clg_vqa_tpu/models/layers.py:336-345)."""

    def __init__(self, d_in: int, d_hidden: int, num_labels: int, eps: float,
                 *, device, dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(d_in, d_hidden, device=device, dtype=dtype)
        self.ln = LayerNorm(d_hidden, eps, device=device, dtype=dtype)
        self.fc2 = Linear(d_hidden, num_labels, device=device, dtype=dtype)

    def forward(self, pooled, compute_dtype=None):
        h = self.ln(gelu(self.fc1(pooled, compute_dtype)))
        return self.fc2(h, compute_dtype)
