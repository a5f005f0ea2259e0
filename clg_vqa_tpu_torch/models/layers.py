"""Shared neural-net primitives, numerics-matched to clg_vqa_tpu/models/layers.py.

Linear weights are stored torch-style **[out, in]**. Numerics kept from the
JAX package (and through it from the reference):
- LayerNorm: TF-style, eps inside the sqrt, computed in fp32 (:25-33).
- GeLU: exact erf form (:36-38).
- ``linear`` with a compute dtype: low-precision operands, fp32
  accumulation, fp32 bias added to the fp32 accumulator, ONE cast (:41-55);
  its backward is the JAX VJP of that function (:class:`_LowPrecisionLinear`).
- Masks: additive ``(1 - m) * -10000`` (:127-130) for UC2, -inf for M3P
  (models/m3p.py), RoBERTa position ids (:119-124).
- Unfused attention: QK^T post-scaled in fp32 (UC2) or q pre-scaled in its
  own dtype (M3P), fp32 softmax, probs cast to the compute dtype before
  P.V, and the backward reads those low-precision probs (``softmax_lowp``,
  :61-92).
- Dropout: u8 threshold ``t = round((1-p)*256)``, rescale 256/t in the
  input's dtype (:95-116), bits from an explicit ``torch.Generator``.

Megatron tensor parallelism over an ``mp`` process group
(parallel/mesh.shard_model sets it up): a column-parallel ``linear`` holds
a slice of the output features, a row-parallel one a slice of the input
features. Both keep the one-cast epilogue that GSPMD gives the JAX package:
the row-parallel forward sums the fp32 partial accumulators over the group,
adds the bias once and casts once; the column-parallel backward sums the
fp32 ``dx`` partials before its cast. The word embedding is split over the
vocabulary (:func:`embed`), the classifier's last layer over the labels
(:func:`gather_shards`).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.attention import (fused_attention, fused_attention_flat,
                             fused_attention_train, fused_attention_train_flat,
                             fused_attention_train_smajor, shard_seed)
from ..ops.block_attention import fused_attention_block


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


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over the ranks of ``group`` (a torch.distributed
    process group) and return it; None is no group, and ``t`` is returned
    as it is."""
    if group is not None:
        torch.distributed.all_reduce(t, group=group)
    return t


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce backward: the input of a column-parallel
    layer, replicated over the group, gathers the gradient of every shard."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format),
                          ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce forward, identity backward: the sum of every shard's
    partial result, whose gradient is the same on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


class _LowPrecisionLinear(torch.autograd.Function):
    """x2 [N, in] @ weight.T + bias with low-precision operands, and the JAX
    VJP of clg_vqa_tpu/models/layers.py:linear as its backward:
    the cotangent g (already in the compute dtype) is taken as fp32;
    db = sum of g in fp32; dW = g^T x in fp32, rounded to the compute dtype
    once (the transpose of the weight cast) and returned as fp32 to the fp32
    master weight; dx = g W in fp32, cast to the compute dtype, then to
    x2's dtype. ``torch.mm(..., out_dtype=fp32)`` has no autograd formula,
    so the products run here, outside autograd.

    With a ``group`` the layer is one shard of a Megatron pair: ``row``
    (weight split on its input features) sums the fp32 accumulators over
    the group before the bias and the cast; column (split on its output
    features) sums the fp32 dx partials over the group before dx's cast."""

    @staticmethod
    def forward(ctx, x2, weight, bias, compute_dtype, group, row):
        xc, wc = x2.to(compute_dtype), weight.to(compute_dtype)
        ctx.save_for_backward(xc, wc)
        ctx.dtypes = (x2.dtype, weight.dtype,
                      None if bias is None else bias.dtype, compute_dtype)
        ctx.group = None if row else group
        acc = matmul_f32(xc, wc.t())
        if row:
            all_reduce(acc, group)
        return (acc if bias is None else acc + bias).to(compute_dtype)

    @staticmethod
    def backward(ctx, g):
        xc, wc = ctx.saved_tensors
        x_dtype, w_dtype, b_dtype, cd = ctx.dtypes
        g = g.to(cd)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = all_reduce(matmul_f32(g, wc), ctx.group).to(cd).to(x_dtype)
        if ctx.needs_input_grad[1]:
            dw = matmul_f32(g.t(), xc).to(cd).to(w_dtype)
        if ctx.needs_input_grad[2]:
            db = g.float().sum(0).to(b_dtype)
        return dx, dw, db, None, None, None


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           compute_dtype: torch.dtype | None = None, *, group=None,
           row: bool = False) -> torch.Tensor:
    """x @ weight.T + bias (``bias`` None: no bias). With a compute dtype:
    operands in that dtype, fp32 accumulation, the fp32 bias added to the
    fp32 accumulator, and the result cast to the compute dtype once
    (clg_vqa_tpu/models/layers.py:41-55), differentiated as
    :class:`_LowPrecisionLinear` says.

    ``group``: the mp process group of a Megatron shard, column-parallel
    (``weight`` [out/mp, in], ``bias`` its slice; the output is this rank's
    slice of the features) or ``row``-parallel (``weight`` [out, in/mp], x
    this rank's slice of the input features, ``bias`` whole; the output is
    the whole result on every rank)."""
    if compute_dtype is None:
        if group is None:
            return torch.nn.functional.linear(x, weight, bias)
        if row:
            return reduce_from_group(torch.nn.functional.linear(x, weight),
                                     group) + bias
        return torch.nn.functional.linear(copy_to_group(x, group), weight, bias)
    y = _LowPrecisionLinear.apply(x.reshape(-1, x.shape[-1]), weight, bias,
                                  compute_dtype, group, row)
    return y.reshape(*x.shape[:-1], weight.shape[0])


def embed(table: torch.Tensor, ids: torch.Tensor, mesh=None,
          n: int = 0) -> torch.Tensor:
    """Rows ``ids`` of an embedding table. With a ``mesh``, ``table`` is this
    rank's shard of a vocabulary of ``n`` rows split over its mp group; ids
    outside it give zero rows, and the sum over the group is the lookup."""
    ids = ids.long()
    if mesh is None:
        return table[ids]
    local = ids - mesh.shard_range(n)[0]
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(inside, local, 0)]
    return reduce_from_group(torch.where(inside[..., None], rows, 0.0),
                             mesh.mp_group)


def gather_shards(y: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """The whole last dimension (``n``) of a column-parallel output whose
    ``y`` is this rank's slice over the mesh's mp group: the zero-padded
    slices summed over the group in fp32 (exact: one rank holds each
    value), in y's dtype."""
    lo = mesh.shard_range(n)[0]
    full = torch.nn.functional.pad(y.float(), (lo, n - lo - y.shape[-1]))
    return reduce_from_group(full, mesh.mp_group).to(y.dtype)


class _SoftmaxLowp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scores, out_dtype):
        p = torch.softmax(scores.float(), dim=-1).to(out_dtype)
        ctx.save_for_backward(p)
        ctx.scores_dtype = scores.dtype
        return p

    @staticmethod
    def backward(ctx, dp):
        (p,) = ctx.saved_tensors
        p32, dp32 = p.float(), dp.float()
        ds = p32 * (dp32 - (p32 * dp32).sum(-1, keepdim=True))
        return ds.to(ctx.scores_dtype), None


def softmax_lowp(scores: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """fp32 softmax whose low-precision output is what the backward keeps:
    ds = p * (dp - sum(p * dp)) in fp32 from the ``out_dtype`` probs
    (clg_vqa_tpu/models/layers.py:61-92)."""
    return _SoftmaxLowp.apply(scores, out_dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout from 8-bit random bits (clg_vqa_tpu/models/layers.py:95-116).

    Identity without a generator (deterministic) or at rate 0. Otherwise
    ``t = round((1-rate)*256)``: keep where the u8 bits drawn from
    ``generator`` are below t and rescale by 256/t, rounded to x's dtype
    first as JAX's weakly typed scalar is; zeros when t <= 0, identity when
    t >= 256."""
    if generator is None or rate == 0.0:
        return x
    t = int(round((1.0 - rate) * 256.0))
    if t >= 256:
        return x
    if t <= 0:
        return torch.zeros_like(x)
    bits = torch.randint(0, 256, x.shape, generator=generator,
                         device=x.device, dtype=torch.uint8)
    scale = float(torch.tensor(256.0 / t, dtype=x.dtype))
    return torch.where(bits < t, x * scale, 0.0)


_M64 = 0xFFFFFFFFFFFFFFFF


def fold_seed(seed: int | None, *path: int) -> int | None:
    """The 64-bit seed of one dropout site: ``seed`` folded with each
    integer of ``path`` by a splitmix64 step, the port's counterpart of
    ``jax.random.fold_in``; None (the deterministic forward) stays None.
    Host arithmetic only, so deriving a layer's seed never waits for the
    device."""
    if seed is None:
        return None
    x = seed & _M64
    for p in path:
        z = (x ^ ((p + 1) * 0x9E3779B97F4A7C15)) & _M64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        x = z ^ (z >> 31)
    return x


def generator(seed: int | None, device) -> torch.Generator | None:
    """A generator on ``device`` seeded with ``seed``; None for None."""
    if seed is None:
        return None
    return torch.Generator(device).manual_seed(seed)


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
    """Weight [out, in] + bias, applied with :func:`linear`'s epilogue.
    Under Megatron mp (parallel/mesh.shard_model sets ``mesh``) the weight
    is this rank's shard of the output features, or with ``row`` of the
    input features."""

    def __init__(self, d_in: int, d_out: int, *, device, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device,
                                               dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device, dtype=dtype))
        self.mesh, self.row = None, False

    def forward(self, x, compute_dtype=None):
        group = None if self.mesh is None else self.mesh.mp_group
        return linear(x, self.weight, self.bias, compute_dtype, group=group,
                      row=self.row)

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
    """Raise ValueError for a value that names no attention route."""
    if not (isinstance(fused, bool) or fused in ("flat", "hm", "proj", "sm")):
        raise ValueError(f"fused_attn={fused!r}: the attention routes are "
                         f"False, True, 'flat', 'hm', 'proj' and 'sm'")


class SelfAttention(nn.Module):
    """Multi-head self-attention with q/k/v/o projections (port of
    clg_vqa_tpu/models/layers.py:multi_head_attention, :133-327, for
    self-attention with a key-side bias)."""

    def __init__(self, d: int, num_heads: int, *, device, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads      # this rank's heads under Megatron mp
        self.mesh = None                # set by parallel/mesh.shard_model
        self.q = Linear(d, d, device=device, dtype=dtype)
        self.k = Linear(d, d, device=device, dtype=dtype)
        self.v = Linear(d, d, device=device, dtype=dtype)
        self.o = Linear(d, d, device=device, dtype=dtype)

    def forward(self, x, attn_bias, *, compute_dtype=None, fused=False,
                dropout_rate: float = 0.0, seed: int | None = None,
                scale_query: bool = False):
        """x [B, S, D], attn_bias additive [B, 1, 1, S]. seed None is the
        deterministic (eval) forward; with a seed the attention
        probabilities are dropped at ``dropout_rate``.

        fused=False: plain PyTorch core (:294-327). scale_query=False
        post-scales QK^T in fp32 (UC2, volta encoders.py:266); True
        pre-scales q by 1/sqrt(hd) in q's dtype (M3P,
        m3p_transformer.py:196). The kernel routes post-scale in fp32
        whatever ``scale_query`` says (:160-162).
        fused="flat": the flat eval kernel K1 without a seed, the flat
        training kernel B1 (:246-256) with one.
        fused="sm": the S-major training kernel B5 (:225-245) with a seed.
        fused="proj": with a seed the whole block, projections included,
        goes through B4 with x and the four weights cast to the compute
        dtype (:205-221).
        fused=True: the head-blocked eval kernel B2 without a seed
        (ops/attention.fused_attention), the head-blocked training kernel B3
        (fused_attention_train) with one (:268-282).
        fused="hm" is the True route. JAX projects q/k/v straight into
        head-major [B, H, S, hd] and the output from it (:173-204) to spare
        the TPU's split and merge relayouts; in PyTorch a head-major product
        is the flat product (same dot products, fp32 accumulation, fp32 bias,
        one cast) followed by the split copy that fused_attention_train
        makes, so both values run the same work.
        Without a seed "flat", "sm" and "proj" take K1, True and "hm" take
        B2, as the JAX package routes the deterministic forward (:257-271).

        Under Megatron mp (``self.mesh``) q/k/v hold this rank's heads, o
        sums their contributions over the group, and the attention's dropout
        seed is offset by the mp rank (ops/attention.shard_seed), since the
        keep mask is keyed by the head's index within the call; "proj",
        which takes whole weights, raises."""
        check_fused(fused)
        B, S, _ = x.shape
        H = self.num_heads
        hd = self.q.weight.shape[0] // H
        if self.mesh is not None and self.mesh.n_mp > 1:
            if fused == "proj" and seed is not None:
                raise ValueError("fused_attn='proj' is a single-chip route: "
                                 "it takes whole weights, not mp shards")
            seed = shard_seed(seed, self.mesh.mp_rank)
        if fused == "proj" and seed is not None:
            def c(t):
                return t if compute_dtype is None else t.to(compute_dtype)

            return fused_attention_block(
                c(x), c(self.q.weight), self.q.bias, c(self.k.weight),
                self.k.bias, c(self.v.weight), self.v.bias, c(self.o.weight),
                self.o.bias, attn_bias, H, dropout_rate=dropout_rate, seed=seed)
        q = self.q(x, compute_dtype)
        k = self.k(x, compute_dtype)
        v = self.v(x, compute_dtype)
        if fused is not False:
            blocked = fused is True or fused == "hm"
            if seed is None:
                ctx = (fused_attention if blocked
                       else fused_attention_flat)(q, k, v, attn_bias, H)
            else:
                train = (fused_attention_train if blocked
                         else fused_attention_train_smajor if fused == "sm"
                         else fused_attention_train_flat)
                ctx = train(q, k, v, attn_bias, H, dropout_rate=dropout_rate,
                            seed=seed)
            return self.o(ctx, compute_dtype)

        scale = 1.0 / math.sqrt(hd)
        if scale_query:
            # in q's dtype, the scale rounded to it first, as JAX multiplies
            # by a weakly typed scalar
            q = q * float(torch.tensor(scale, dtype=q.dtype))

        def heads(t):
            return t.float().reshape(B, S, H, hd).transpose(1, 2)

        # products of low-precision values are exact in fp32, so the fp32
        # matmul on upcast operands is the fp32-accumulated product
        scores = torch.matmul(heads(q), heads(k).transpose(-1, -2))
        if not scale_query:
            scores = scores * scale
        scores = scores + attn_bias
        if compute_dtype is not None:
            probs = softmax_lowp(scores, compute_dtype)
        else:
            probs = torch.softmax(scores, dim=-1)
        probs = dropout(probs, dropout_rate, generator(seed, x.device))
        ctx = torch.matmul(probs.float(), heads(v))
        return self.o(ctx.transpose(1, 2).reshape(B, S, H * hd), compute_dtype)


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
        self.num_labels = num_labels
        self.mesh = None        # set when fc2 is a label shard

    def forward(self, pooled, compute_dtype=None, *, dropout_rate: float = 0.0,
                generator: torch.Generator | None = None):
        pooled = dropout(pooled, dropout_rate, generator)
        h = self.ln(gelu(self.fc1(pooled, compute_dtype)))
        logits = self.fc2(h, compute_dtype)
        if self.mesh is not None:       # the loss's top-k needs every label
            logits = gather_shards(logits, self.mesh, self.num_labels)
        return logits
