"""Kimi-VL-A3B's language decoder (moonshotai/Kimi-VL-A3B-Instruct; a
DeepSeek-V3-style decoder: multi-head latent attention and sigmoid-routed
experts with shared experts) as a GQA classifier over region features, on
one expert-parallel rank of a pipeline stage (config.KimiVLConfig).

- Sequence: [regions (R); question (T)], image before question as Kimi-VL's
  chat template puts it, positions 0 .. S-1. A region is
  Linear(GeLU(Linear(LN(feature)))), the published projector's form, plus
  Linear(locations); a token is its embedding row.
- Block (pre-RMSNorm): h = x + MLA(RMSNorm(x)); x' = h + FFN(RMSNorm(h)).
- MLA: q = W_q x splits per head into q_nope (128) and q_pe (64);
  [c, k_pe] = W_kva x (512 + 64), c = RMSNorm(c), W_kvb c splits per head
  into k_nope (128) and v (128). RoPE (theta 800,000, the published
  modeling code's pair order: each pair (2i, 2i+1) de-interleaved into the
  halves, then rotated half against half) on q_pe and on k_pe, which all
  heads share. Scores [q_nope, q_pe].[k_nope, k_pe] / sqrt(192), causal,
  invalid keys (padding regions and tokens) excluded; a query with no valid
  key at or before it (a padding position) attends to itself alone, so no
  row is empty. Output W_o(softmax . v). No biases in the decoder.
- FFN: the first ``first_dense`` layers down(silu(gate x) * up x); the
  others a mixture of experts: sigmoid scores over ``router_experts`` in
  fp32, the top-k of scores + the selection bias (a buffer, frozen), the
  weights 2.446 s_i / sum of the chosen s; the output is the sum over the
  chosen experts held here of w_i E_i(x), plus the shared experts (one
  SiLU MLP of width n_shared x 1408). Every token is routed: none dropped,
  no capacity factor (ops/moe.py).
- Head: the final RMSNorm, the last valid position's state, then the GQA
  classifier as UC2 and M3P build it: dropout 0.1, Linear, GeLU (erf), LN,
  Linear.

Numerics: the residual stream and every norm in fp32; each Linear with the
compute dtype's operands and fp32 accumulation (layers.linear); SiLU and
GeLU products from fp32 values; the router, its top-k and its weights in
fp32; the attention core through scaled_dot_product_attention in the
compute dtype. The decoder has no dropout (as published); the pooled vector
drops at ``clf_dropout_prob`` with the seed folded with 3, as UC2's.

Spans (utils/profiling): ``mla.attend`` (the attention core), and in each
expert layer ``moe.route``, ``moe.dispatch``, ``moe.experts`` and
``moe.combine``; counters ``moe.pairs`` and ``moe.largest_group``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import resolve_device
from ..config import KimiVLConfig
from ..ops import moe
from ..utils.profiling import span
from . import layers as L
from .uc2 import _dropout_seed


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, *, device, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, device=device, dtype=dtype))

    def forward(self, x):
        x = x.float()
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * self.weight


class Proj(nn.Module):
    """A bias-free Linear [out, in] with the compute dtype's epilogue."""

    def __init__(self, d_in: int, d_out: int, *, device, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device,
                                               dtype=dtype))

    def forward(self, x, compute_dtype=None):
        return L.linear(x, self.weight, None, compute_dtype)


def _swiglu(gate, up, compute_dtype):
    y = torch.nn.functional.silu(gate.float()) * up.float()
    return y if compute_dtype is None else y.to(compute_dtype)


def rope_tables(S: int, dim: int, theta: float, device):
    """(cos, sin) [S, dim] of positions 0 .. S-1 (the published rotary
    embedding: inv_freq = theta^(-2i/dim), the frequencies repeated over
    the two halves), in fp32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=device).float() / dim))
    f = torch.outer(torch.arange(S, device=device).float(), inv)
    emb = torch.cat([f, f], -1)
    return emb.cos(), emb.sin()


def apply_rope(x, cos, sin):
    """x [..., S, n, dim] in fp32: pairs de-interleaved into halves, then
    x cos + rotate_half(x) sin."""
    *lead, d = x.shape
    x = x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos[:, None, :] + rot * sin[:, None, :]


class MLA(nn.Module):
    def __init__(self, cfg: KimiVLConfig, *, device, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        H, h = cfg.hidden_size, cfg.num_heads
        self.cfg = cfg
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        self.q = Proj(H, h * qk, **kw)
        self.kva = Proj(H, cfg.kv_lora_rank + cfg.qk_rope_head_dim, **kw)
        self.kv_ln = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps, **kw)
        self.kvb = Proj(cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim), **kw)
        self.o = Proj(h * cfg.v_head_dim, H, **kw)

    def forward(self, x, allowed, cos, sin, compute_dtype=None):
        c = self.cfg
        B, S, _ = x.shape
        h, nope, rope, vd = (c.num_heads, c.qk_nope_head_dim, c.qk_rope_head_dim,
                             c.v_head_dim)
        dt = compute_dtype or torch.float32
        q = self.q(x, compute_dtype).view(B, S, h, nope + rope)
        kv_c, k_pe = self.kva(x, compute_dtype).split([c.kv_lora_rank, rope], -1)
        kv = self.kvb(self.kv_ln(kv_c), compute_dtype).view(B, S, h, nope + vd)
        k_nope, v = kv.split([nope, vd], -1)
        q_nope, q_pe = q.split([nope, rope], -1)
        q_pe = apply_rope(q_pe.float(), cos, sin).to(dt)
        k_pe = apply_rope(k_pe.float()[:, :, None, :], cos, sin).to(dt)
        qh = torch.cat([q_nope.to(dt), q_pe], -1).transpose(1, 2)
        kh = torch.cat([k_nope.to(dt), k_pe.expand(B, S, h, rope)], -1).transpose(1, 2)
        with span("mla.attend"):
            ctx = torch.nn.functional.scaled_dot_product_attention(
                qh, kh, v.to(dt).transpose(1, 2), attn_mask=allowed,
                scale=1.0 / math.sqrt(nope + rope))
        return self.o(ctx.transpose(1, 2).reshape(B, S, h * vd), compute_dtype)


class DenseFFN(nn.Module):
    def __init__(self, d: int, d_ff: int, *, device, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.gate = Proj(d, d_ff, **kw)
        self.up = Proj(d, d_ff, **kw)
        self.down = Proj(d_ff, d, **kw)

    def forward(self, x, compute_dtype=None):
        return self.down(_swiglu(self.gate(x, compute_dtype), self.up(x, compute_dtype),
                                 compute_dtype), compute_dtype)


class Router(nn.Module):
    def __init__(self, cfg: KimiVLConfig, *, device, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cfg.router_experts, cfg.hidden_size,
                                               device=device, dtype=dtype))
        # the noaux_tc selection bias: chooses, does not weigh; frozen here
        self.register_buffer("selection_bias", torch.zeros(cfg.router_experts,
                                                           device=device))


class Experts(nn.Module):
    """This rank's routed experts: w1 [E, 2I, H] (each expert's gate rows,
    then its up rows) and w2 [E, H, I]."""

    def __init__(self, cfg: KimiVLConfig, *, device, dtype=torch.float32):
        super().__init__()
        E, H, I = cfg.held_experts, cfg.hidden_size, cfg.moe_intermediate_size
        self.w1 = nn.Parameter(torch.empty(E, 2 * I, H, device=device, dtype=dtype))
        self.w2 = nn.Parameter(torch.empty(E, H, I, device=device, dtype=dtype))


class MoE(nn.Module):
    def __init__(self, cfg: KimiVLConfig, *, device, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.router = Router(cfg, **kw)
        self.experts = Experts(cfg, **kw)
        self.shared = DenseFFN(cfg.hidden_size,
                               cfg.n_shared_experts * cfg.moe_intermediate_size, **kw)

    def forward(self, x, compute_dtype=None):
        c = self.cfg
        B, S, H = x.shape
        x2 = x.reshape(B * S, H)
        with span("moe.route"):
            logits = torch.nn.functional.linear(x2.float(), self.router.weight.float())
            idx, w = moe.route(logits, self.router.selection_bias,
                               c.experts_per_token, c.routed_scaling_factor)
            d = moe.dispatch(idx, c.first_expert, c.held_experts,
                             expected=c.held_experts / c.router_experts)
        xc = x2 if compute_dtype is None else x2.to(compute_dtype)
        routed = moe.routed_experts(xc, w, self.experts.w1, self.experts.w2, d)
        return (routed + self.shared(x2, compute_dtype).float()).view(B, S, H)


class Block(nn.Module):
    def __init__(self, cfg: KimiVLConfig, dense: bool, *, device, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.ln_attn = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.attn = MLA(cfg, **kw)
        self.ln_ffn = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.ffn = (DenseFFN(cfg.hidden_size, cfg.intermediate_size, **kw) if dense
                    else MoE(cfg, **kw))

    def forward(self, x, allowed, cos, sin, compute_dtype=None):
        x = x + self.attn(self.ln_attn(x), allowed, cos, sin, compute_dtype).float()
        return x + self.ffn(self.ln_ffn(x), compute_dtype).float()


class Embeddings(nn.Module):
    def __init__(self, cfg: KimiVLConfig, *, device, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        H, F, P = cfg.hidden_size, cfg.v_feature_size, cfg.projector_hidden_size
        self.word = nn.Parameter(torch.empty(cfg.vocab_size, H, **kw))
        self.proj_ln = L.LayerNorm(F, cfg.layer_norm_eps, **kw)
        self.proj1 = L.Linear(F, P, **kw)
        self.proj2 = L.Linear(P, H, **kw)
        self.loc = L.Linear(cfg.num_locs, H, **kw)


class KimiVL(nn.Module):
    """The decoder stage + the GQA classifier head; the port's model
    interface (``model(batch, deterministic, seed, compute_dtype,
    fused_attn)`` -> [B, num_labels] logits, ``.device``, ``.cfg``).

    Parameters are created on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``) and initialised from a ``torch.Generator`` seeded with
    ``seed``: normal(0, 0.02) for the embeddings and every weight,
    xavier-uniform for the classifier, zero biases, norm scales 1."""

    def __init__(self, cfg: KimiVLConfig, *, device=None, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        kw = {"device": dev, "dtype": dtype}
        self.cfg = cfg
        self.embeddings = Embeddings(cfg, **kw)
        self.layers = nn.ModuleList(Block(cfg, i < cfg.first_dense, **kw)
                                    for i in range(cfg.num_layers))
        self.ln_f = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.classifier = L.SimpleClassifier(cfg.hidden_size, cfg.clf_hidden_size,
                                             cfg.num_labels, cfg.layer_norm_eps, **kw)
        self.init_weights(torch.Generator(dev).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.ln_f.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02) -> None:
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.dim() >= 2:
                p.normal_(0.0, std, generator=generator)
            elif leaf == "bias":
                p.zero_()
        self.classifier.fc1.init_xavier_(generator)
        self.classifier.fc2.init_xavier_(generator)

    def forward(self, batch: dict, *, deterministic: bool = True,
                seed: int | None = None, compute_dtype=None,
                fused_attn=False) -> torch.Tensor:
        """Logits [B, num_labels]. ``fused_attn`` is checked and has no
        route here: the MLA core (qk 192, v 128) goes through
        scaled_dot_product_attention. deterministic=False needs ``seed``,
        which keys the classifier's dropout (folded with 3)."""
        seed = _dropout_seed(deterministic, seed)
        L.check_fused(fused_attn)
        cfg, e = self.cfg, self.embeddings
        ids = batch["input_ids"].long()
        B, T = ids.shape
        f = e.proj_ln(batch["features"].float())
        img = e.proj2(L.gelu(e.proj1(f, compute_dtype).float()), compute_dtype).float()
        img = img + e.loc(batch["locs"].float(), compute_dtype).float()
        h = torch.cat([img, e.word[ids]], 1)
        S = h.shape[1]
        valid = torch.cat([batch["image_mask"], batch["input_mask"]], 1) != 0
        pos = torch.arange(S, device=h.device)
        causal = pos[None, :] <= pos[:, None]
        allowed = (causal[None] & (valid[:, None, :] | torch.eye(
            S, dtype=torch.bool, device=h.device)[None]))[:, None]
        cos, sin = rope_tables(S, cfg.qk_rope_head_dim, cfg.rope_theta, h.device)
        for layer in self.layers:
            h = layer(h, allowed, cos, sin, compute_dtype)
        h = self.ln_f(h)
        last = S - 1 - valid.flip(1).int().argmax(1)
        pooled = h.gather(1, last[:, None, None].expand(B, 1, h.shape[-1]))[:, 0]
        return self.classifier(
            pooled, compute_dtype, dropout_rate=cfg.clf_dropout_prob,
            generator=L.generator(L.fold_seed(seed, 3), pooled.device))
