"""Whole-block training attention (B4, the "proj" route): the q/k/v
projections, the flat attention core with dropout and the output projection
in one CUDA forward and one CUDA backward, and their plain PyTorch version.

Port of clg_vqa_tpu/ops/attention.py:fused_attention_block (:958-973) and
its custom VJP ``_attn_block_core`` (:872-955): ``_proj_fwd_kernel`` (:678),
``_proj_bwda_kernel`` (:726) and ``_linear_bwd_kernel`` (:802), as
``csrc/block_attention_train.cu``. The core is B1's device code
(``csrc/attention_train.cuh``) and B1's dropout: the keep mask is keyed by
(seed, absolute sample, head, query row, key column // 16), so with one seed
"proj" drops the same attention probabilities as "flat". The TPU kernel's
batch tilings and its per-grid-cell PRNG seeding exist for VMEM and the
TPU's generator and have no counterpart here.

Numerics, as the JAX VJP rounds them: every product accumulates in fp32
from x's dtype; q, k, v, ctx and y are x @ W^T + b with the fp32 bias on the
fp32 accumulator and one cast to x's dtype. Backward: dctx = g Wo stays
fp32 and is the core's do; dq, dk, dv come out in x's dtype; each weight
gradient is rounded once to the weights' dtype and each bias gradient is an
fp32 sum; dx = (dxq + dxk) + dxv with each term rounded to x's dtype and
both sums taken in x's dtype, in that order (:940-945); the bias gradient
is summed over heads in order h = 0..H-1.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .attention import (_DTYPES, _bias2, _key_blocked, _train_seed, apply_keep,
                        merge_heads, plain_probs, split_heads)

_NAME = "block_attention_train"


def _check_block(x, weights, biases, num_heads: int) -> tuple[int, int, int]:
    """(B, S, hd) of a block's operands: x [B, S, H*hd], four [H*hd, H*hd]
    weights in x's dtype and four [H*hd] biases."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, H*hd], got {tuple(x.shape)}")
    B, S, HD = x.shape
    if HD % num_heads:
        raise ValueError(f"H*hd={HD} is not divisible by num_heads={num_heads}")
    for w in weights:
        if w.shape != (HD, HD) or w.dtype != x.dtype:
            raise ValueError(f"weights must be [{HD}, {HD}] in x's dtype "
                             f"{x.dtype}, got {tuple(w.shape)} {w.dtype}")
    for b in biases:
        if b.shape != (HD,):
            raise ValueError(f"biases must be [{HD}], got {tuple(b.shape)}")
    return B, S, HD // num_heads


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated in fp32 (fp64 for fp64 operands); low-precision
    operands are upcast, so their products are exact."""
    ct = torch.promote_types(a.dtype, torch.float32)
    return torch.mm(a.to(ct), b.to(ct))


def _proj(x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x2 W^T + b on the fp32 accumulator, cast to x2's dtype once."""
    return (_mm(x2, w.t()) + b).to(x2.dtype)


def _core_backward_plain(q, k, v, b2, dout, num_heads: int, keep_t: int,
                         seed: int | None):
    """B1's backward math written out, in b2's dtype, from a do in that
    dtype: (dq, dk, dv) as [B, S, H*hd] and the bias gradient per head
    [B, H, S]."""
    ct = b2.dtype
    hd = q.shape[-1] // num_heads
    scale = 1.0 / hd ** 0.5
    qh, kh, vh, do = (split_heads(t, num_heads, ct) for t in (q, k, v, dout))
    p, keep = plain_probs(q, k, b2, num_heads, keep_t, seed)
    dv = torch.matmul(apply_keep(p, keep, keep_t).transpose(-1, -2), do)
    dp = apply_keep(torch.matmul(do, vh.transpose(-1, -2)), keep, keep_t)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    return merge_heads(dq), merge_heads(dk), merge_heads(dv), ds.sum(2)


class _BlockPlainFn(torch.autograd.Function):
    """The plain version of B4, with the JAX VJP's roundings as its
    backward (see the module docstring). Operands: x [B, S, HD]; weights
    [HD, HD] in x's dtype; biases [HD]; b2 [B, S] in the compute type."""

    @staticmethod
    def forward(ctx, x, wq, bq, wk, bk, wv, bv, wo, bo, b2, num_heads, keep_t,
                seed):
        B, S, HD = x.shape
        x2 = x.reshape(B * S, HD)
        q, k, v = (_proj(x2, w, b).view(B, S, HD)
                   for w, b in ((wq, bq), (wk, bk), (wv, bv)))
        p, keep = plain_probs(q, k, b2, num_heads, keep_t, seed)
        c = merge_heads(torch.matmul(apply_keep(p, keep, keep_t),
                                     split_heads(v, num_heads, b2.dtype))
                        ).to(x.dtype)
        y = _proj(c.reshape(B * S, HD), wo, bo).view(B, S, HD)
        ctx.save_for_backward(x, q, k, v, c, b2, wq, wk, wv, wo)
        ctx.meta = (num_heads, keep_t, seed, (bq.dtype, bk.dtype, bv.dtype,
                                              bo.dtype))
        return y

    @staticmethod
    def backward(ctx, g):
        x, q, k, v, c, b2, wq, wk, wv, wo = ctx.saved_tensors
        num_heads, keep_t, seed, bdt = ctx.meta
        B, S, HD = x.shape
        N = B * S
        g2 = g.to(x.dtype).reshape(N, HD)
        dctx = _mm(g2, wo)
        grads = _core_backward_plain(q, k, v, b2, dctx.to(b2.dtype).view(B, S, HD),
                                     num_heads, keep_t, seed)
        dq, dk, dv = (t.to(x.dtype).reshape(N, HD) for t in grads[:3])
        dbh = grads[3]
        dbias = dbh[:, 0]
        for h in range(1, num_heads):
            dbias = dbias + dbh[:, h]
        x2, c2 = x.reshape(N, HD), c.reshape(N, HD)
        pairs = ((dq, x2, wq), (dk, x2, wk), (dv, x2, wv), (g2, c2, wo))
        dw = [_mm(dy.t(), a).to(w.dtype) for dy, a, w in pairs]
        db = [dy.to(torch.promote_types(dy.dtype, torch.float32)).sum(0).to(t)
              for (dy, _, _), t in zip(pairs, bdt)]
        dxq, dxk, dxv = (_mm(dy, w).to(x.dtype) for dy, _, w in pairs[:3])
        dx = ((dxq + dxk) + dxv).view(B, S, HD)
        return (dx, dw[0], db[0], dw[1], db[1], dw[2], db[2], dw[3], db[3],
                dbias.to(b2.dtype), None, None, None)


def fused_attention_block_plain(x, wq, bq, wk, bk, wv, bv, wo, bo, bias,
                                num_heads: int, *, dropout_rate: float = 0.0,
                                seed: int | None = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`fused_attention_block`: the bf16
    products accumulated in fp32 (fp64 for fp64 inputs), B1's plain core and
    keep mask, and the JAX VJP's roundings in its backward."""
    B, S, _ = _check_block(x, (wq, wk, wv, wo), (bq, bk, bv, bo), num_heads)
    t, seed = _train_seed(dropout_rate, seed)
    b2 = bias.expand(B, 1, 1, S)[:, 0, 0, :].to(
        torch.promote_types(x.dtype, torch.float32))
    return _BlockPlainFn.apply(x, wq, bq, wk, bk, wv, bv, wo, bo, b2,
                               num_heads, t, seed)


@functools.cache
def _kernels():
    """(forward, backward, smem_bytes, scratch_floats) of
    ``csrc/block_attention_train.cu``."""
    lib = _build.load(_NAME)
    fwd = lib.block_attention_train_fwd
    fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                    + [ctypes.c_float, ctypes.c_uint64, ctypes.c_void_p,
                       ctypes.c_int])
    fwd.restype = ctypes.c_int
    bwd = lib.block_attention_train_bwd
    bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 27 + [ctypes.c_int] * 5
                    + [ctypes.c_float, ctypes.c_uint64, ctypes.c_void_p,
                       ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    smem = lib.block_attention_train_smem_bytes
    smem.argtypes = [ctypes.c_int] * 4
    smem.restype = ctypes.c_longlong
    scratch = lib.block_attention_train_scratch_floats
    scratch.argtypes = [ctypes.c_int]
    scratch.restype = ctypes.c_longlong
    return fwd, bwd, smem, scratch


def _check_cuda(x: torch.Tensor, S: int, hd: int) -> None:
    """Raise unless the CUDA kernels take x's device, dtype and shape."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES or hd not in (32, 64, 128):
        raise ValueError(f"the CUDA kernels take fp32/bf16 with hd in "
                         f"(32, 64, 128); got {x.dtype}, hd={hd}")
    for backward in (0, 1):
        _key_blocked(_kernels()[2], S, hd, backward)


def _ptrs(*ts: torch.Tensor) -> list[int]:
    """Data pointers, each 16-byte aligned as the kernels' loads need."""
    out = [t.data_ptr() for t in ts]
    if any(p % 16 for p in out):
        raise ValueError("B4's operands must start on 16-byte boundaries")
    return out


class _BlockTrainFn(torch.autograd.Function):
    """B4 on the card: the forward entry (q|k|v products, core, output
    product) and the backward entry (dctx, core backward, the four weight
    and bias gradients, dx). ctx, the core's output, is kept from the
    forward for dWo."""

    @staticmethod
    def forward(ctx, x, wq, bq, wk, bk, wv, bv, wo, bo, b2, num_heads, keep_t,
                seed):
        B, S, HD = x.shape
        q, k, v, c, y = (torch.empty_like(x) for _ in range(5))
        fwd, _, smem_bytes, _ = _kernels()
        hd = HD // num_heads
        err = fwd(_DTYPES[x.dtype], *_ptrs(x, wq, wk, wv, wo, bq, bk, bv, bo,
                                           b2, q, k, v, c, y),
                  B, S, num_heads, hd, keep_t, 256.0 / keep_t, seed,
                  torch.cuda.current_stream(x.device).cuda_stream,
                  int(_key_blocked(smem_bytes, S, hd, 0)))
        if err != 0:
            raise RuntimeError(f"{_NAME} forward launch failed: CUDA error {err}")
        fused_attention_block.launches += 1
        ctx.save_for_backward(x, q, k, v, c, b2, wq, wk, wv, wo)
        ctx.meta = (num_heads, keep_t, seed)
        return y

    @staticmethod
    def backward(ctx, g):
        x, q, k, v, c, b2, wq, wk, wv, wo = ctx.saved_tensors
        num_heads, keep_t, seed = ctx.meta
        B, S, HD = x.shape
        g = g.to(x.dtype).contiguous()
        f32 = dict(dtype=torch.float32, device=x.device)
        dctx = torch.empty(B, S, HD, **f32)
        dq, dk, dv, dx = (torch.empty_like(x) for _ in range(4))
        dbh = torch.empty(B, num_heads, S, **f32)
        dbias = torch.empty(B, S, **f32)
        dw = [torch.empty_like(wq) for _ in range(4)]
        db = [torch.empty(HD, **f32) for _ in range(4)]
        _, bwd, smem_bytes, scratch_floats = _kernels()
        hd = HD // num_heads
        scratch = torch.empty(scratch_floats(HD), **f32)
        dq32 = (torch.empty(B, num_heads, S, hd, **f32)
                if _key_blocked(smem_bytes, S, hd, 1) else None)
        err = bwd(_DTYPES[x.dtype], *_ptrs(x, q, k, v, c, b2, g, wq, wk, wv, wo,
                                           dctx, dq, dk, dv, dbh, dbias, dx,
                                           *dw, *db, scratch),
                  B, S, num_heads, hd, keep_t, 256.0 / keep_t, seed,
                  torch.cuda.current_stream(x.device).cuda_stream,
                  None if dq32 is None else dq32.data_ptr())
        if err != 0:
            raise RuntimeError(f"{_NAME} backward launch failed: CUDA error {err}")
        fused_attention_block.backward_launches += 1
        return (dx, dw[0], db[0], dw[1], db[1], dw[2], db[2], dw[3], db[3],
                dbias, None, None, None)


def fused_attention_block(x: torch.Tensor, wq, bq, wk, bk, wv, bv, wo, bo,
                          bias: torch.Tensor, num_heads: int, *,
                          dropout_rate: float = 0.0,
                          seed: int | None = None) -> torch.Tensor:
    """y = (attention(x Wq^T + bq, x Wk^T + bk, x Wv^T + bv) with dropout)
    Wo^T + bo for one block, differentiable in x, every weight and bias, and
    ``bias``.

    x: [B, S, H*hd] (the block input); weights [H*hd, H*hd] in PyTorch's
    [out, in] layout, already cast to x's dtype by the caller; biases [H*hd]
    (added in fp32); bias: additive key-side, broadcastable to [B, 1, 1, S];
    seed as for ops/attention.fused_attention_train_flat. Returns y in x's
    dtype. CPU tensors take the plain version; CUDA tensors launch the
    kernels (fp32 or bf16, hd in {32, 64, 128}) or raise."""
    B, S, hd = _check_block(x, (wq, wk, wv, wo), (bq, bk, bv, bo), num_heads)
    t, seed = _train_seed(dropout_rate, seed)
    if x.device.type == "cpu":
        return fused_attention_block_plain(
            x, wq, bq, wk, bk, wv, bv, wo, bo, bias, num_heads,
            dropout_rate=dropout_rate, seed=seed)
    _check_cuda(x, S, hd)
    if B == 0 or S == 0:
        return torch.zeros_like(x)
    b2 = _bias2(bias.to(x.device), B, S)
    return _BlockTrainFn.apply(
        x.contiguous(), wq.contiguous(), bq.float().contiguous(),
        wk.contiguous(), bk.float().contiguous(), wv.contiguous(),
        bv.float().contiguous(), wo.contiguous(), bo.float().contiguous(), b2,
        num_heads, t, seed)


fused_attention_block.launches = 0
fused_attention_block.backward_launches = 0


@torch.no_grad()
def realized_block_keep_mask(seed: int, B: int, H: int, S: int, hd: int,
                             dropout_rate: float, device) -> torch.Tensor:
    """Bool [B, H, S, S]: the keep mask that :func:`fused_attention_block`
    realizes on ``device``, read back through its forward. With Wq = Wk = 0
    every probability is 1/S; Wv = Wo = I and an x whose row j is one-hot on
    column h*hd + j - j0 in every head h make y[.., i, h*hd + j - j0] the
    dropped probability p_d[h, i, j]; ceil(S/hd) calls cover every key
    column (ops/attention.realized_keep_mask does the same for B1)."""
    D = H * hd
    eye = torch.eye(D, device=device)
    zero, zb = torch.zeros(D, D, device=device), torch.zeros(D, device=device)
    bias = torch.zeros(B, 1, 1, S, device=device)
    mask = torch.empty(B, H, S, S, dtype=torch.bool, device=device)
    for j0 in range(0, S, hd):
        n = min(hd, S - j0)
        x = torch.zeros(B, S, H, hd, device=device)
        cols = torch.arange(n, device=device)
        x[:, j0 + cols, :, cols] = 1.0
        y = fused_attention_block(x.reshape(B, S, D), zero, zb, zero, zb, eye,
                                  zb, eye, zb, bias, H,
                                  dropout_rate=dropout_rate, seed=seed)
        mask[..., j0:j0 + n] = (y.view(B, S, H, hd)[..., :n] != 0).transpose(1, 2)
    return mask
