"""Kimi-VL-A3B's language decoder as a GQA classifier, in plain float32
torch: the reference of the family ``kimi_vl`` (portbench/families/).

The published model (moonshotai/Kimi-VL-A3B-Instruct, config.json's
text_config; DeepSeek-V3's decoder and modeling code) over the benchmark's
inputs, on one expert-parallel rank: each expert layer routes over all of
the router's experts and adds the part that the experts held here give.

- Sequence [regions; text], positions 0 .. S-1. A region is
  Linear(GeLU(Linear(LN(f)))) + Linear(loc) (the projector's form, with
  biases); a token its embedding row.
- Block: h = x + MLA(RMSNorm(x)); x' = h + FFN(RMSNorm(h)); RMSNorm(x) =
  x / sqrt(mean(x^2) + eps) * w.
- MLA: q = W_q x per head [q_nope 128 | q_pe 64]; [c | k_pe] = W_kva x;
  [k_nope 128 | v 128] per head = W_kvb RMSNorm(c); RoPE on q_pe and the
  shared k_pe (theta from the file; each pair (2i, 2i+1) moved to (i, i +
  32), then x cos + rotate_half(x) sin); scores [q_nope, q_pe].[k_nope,
  k_pe] / sqrt(192); key j open to query i when j <= i and j is valid (or j
  is i); softmax; W_o (p v). No biases.
- FFN: dense layers W_down(silu(W_gate x) * W_up x). Expert layers: s =
  sigmoid(W_router x); the top-k of s + b (b the selection bias); w_i =
  scale s_i / sum of the chosen s; output sum over the chosen experts held
  here of w_i E_i(x) (each expert a SiLU MLP, its gate and up rows stacked
  in ``w1``, its down in ``w2``) plus the shared experts' SiLU MLP.
- Head: RMSNorm, the last valid position, dropout (the step's seed folded
  with 3), Linear, GeLU (erf), LN, Linear.

``prec`` rounds the operands of every product that the program computes in
its compute dtype, and each such product's output (reference/precision.py);
the router, whose logits, top-k and weights the program keeps in fp32, is
computed in fp32 under every precision.

Weights are a dict keyed by the port's checkpoint names
(``layers.3.ffn.experts.w1``, ...); the selection biases, which are buffers
and not trained, are ``batch``-independent zeros unless ``cfg`` names them
under ``selection_bias`` ({layer: [router_experts]})."""
from __future__ import annotations

import math

import torch

from .precision import FP32, Precision
from .seeds import fold_seed, hidden_keep, keep_threshold

CLF_RATE = 0.1


def dims(cfg: dict) -> dict:
    """The numbers the reference needs from a configuration file in the
    published config.json's keys."""
    H = cfg["hidden_size"]
    return dict(
        model=cfg["model_name"], H=H, heads=cfg["num_attention_heads"],
        layers=cfg["num_hidden_layers"], dense=cfg["first_k_dense_replace"],
        kv_rank=cfg["kv_lora_rank"], nope=cfg["qk_nope_head_dim"],
        rope=cfg["qk_rope_head_dim"], vdim=cfg["v_head_dim"],
        ffn=cfg["intermediate_size"], moe_ffn=cfg["moe_intermediate_size"],
        shared=cfg["n_shared_experts"], router=cfg["router_experts"],
        held=cfg["n_routed_experts"], first=cfg["first_held_expert"],
        topk=cfg["num_experts_per_tok"], scale=cfg["routed_scaling_factor"],
        eps=cfg["rms_norm_eps"], theta=float(cfg["rope_theta"]),
        ln_eps=cfg["layer_norm_eps"], pad=cfg["pad_token_id"],
        vocab=cfg["vocab_size"], locs=cfg["num_locs"], feat=cfg["v_feature_size"],
        proj=cfg["projector_hidden_size"], norm=False, labels=cfg["num_labels"],
        text=cfg["max_seq_length"], regions=cfg["max_region_num"],
        max_pos=cfg["max_position_embeddings"], clf_hidden=cfg["clf_hidden_size"])


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def gelu(x):
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def silu(x):
    return x * torch.sigmoid(x)


def mm(x, weight, prec: Precision, bias=None):
    """x W^T (+ bias) with both operands and the output in ``prec``."""
    y = prec.q(x) @ prec.q(weight).t()
    return prec.q(y if bias is None else y + bias)


def rope(x, S: int, theta: float):
    """x [B, S, n, d]: the published rotary embedding at positions 0..S-1."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device).float() / d))
    f = torch.outer(torch.arange(S, device=x.device).float(), inv)
    cos, sin = torch.cat([f, f], -1).cos(), torch.cat([f, f], -1).sin()
    *lead, _ = x.shape
    x = x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos[:, None] + rot * sin[:, None]


def mla(x, open_, w: dict, p: str, d: dict, prec: Precision):
    B, S, _ = x.shape
    h, nope, rp, vd = d["heads"], d["nope"], d["rope"], d["vdim"]
    q = mm(x, w[f"{p}.q.weight"], prec).view(B, S, h, nope + rp)
    kva = mm(x, w[f"{p}.kva.weight"], prec)
    c, k_pe = kva[..., :d["kv_rank"]], kva[..., d["kv_rank"]:]
    kv = mm(rms_norm(c, w[f"{p}.kv_ln.weight"], d["eps"]), w[f"{p}.kvb.weight"],
            prec).view(B, S, h, nope + vd)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], S, d["theta"])], -1)
    k_pe = rope(k_pe[:, :, None, :], S, d["theta"]).expand(B, S, h, rp)
    k = torch.cat([kv[..., :nope], k_pe], -1)
    v = kv[..., nope:]
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scores = (prec.q(q) @ prec.q(k).transpose(-1, -2)) / math.sqrt(nope + rp)
    probs = torch.softmax(scores.masked_fill(~open_, float("-inf")), -1)
    ctx = prec.q(prec.q(probs) @ prec.q(v)).transpose(1, 2).reshape(B, S, h * vd)
    return mm(ctx, w[f"{p}.o.weight"], prec)


def swiglu_mlp(x, gate, up, down, prec: Precision):
    return mm(prec.q(silu(mm(x, gate, prec)) * mm(x, up, prec)), down, prec)


def expert_layer(x, w: dict, p: str, d: dict, bias, prec: Precision):
    """The expert layer's output at x [N, H]: the held experts' part and the
    shared experts."""
    s = torch.sigmoid(x @ w[f"{p}.router.weight"].t())
    idx = torch.topk(s.detach() + bias, d["topk"], dim=-1).indices
    chosen = s.gather(-1, idx)
    wts = d["scale"] * chosen / (chosen.sum(-1, keepdim=True) + 1e-20)
    I = d["moe_ffn"]
    out = torch.zeros_like(x)
    for e in range(d["held"]):
        tok, slot = torch.nonzero(idx == d["first"] + e, as_tuple=True)
        if tok.numel() == 0:
            continue
        w1, w2 = w[f"{p}.experts.w1"][e], w[f"{p}.experts.w2"][e]
        y = swiglu_mlp(x[tok], w1[:I], w1[I:], w2, prec)
        out = out.index_add(0, tok, wts[tok, slot][:, None] * y)
    shared = swiglu_mlp(x, w[f"{p}.shared.gate.weight"], w[f"{p}.shared.up.weight"],
                        w[f"{p}.shared.down.weight"], prec)
    return out + shared


def forward(cfg: dict, w: dict, batch: dict, *, seed: int | None = None,
            prec: Precision = FP32) -> torch.Tensor:
    """Logits [B, num_labels] in float32. ``batch``: input_ids, input_mask
    [B, T]; features [B, R, F], locs [B, R, L], image_mask [B, R]. ``seed``
    None is the deterministic forward; an int keys the classifier's
    dropout."""
    d = dims(cfg)
    biases = cfg.get("selection_bias", {})
    ids = batch["input_ids"].long()
    B = ids.shape[0]
    f = layer_norm(batch["features"].float(), w["embeddings.proj_ln.weight"],
                   w["embeddings.proj_ln.bias"], d["ln_eps"])
    img = mm(gelu(mm(f, w["embeddings.proj1.weight"], prec, w["embeddings.proj1.bias"])),
             w["embeddings.proj2.weight"], prec, w["embeddings.proj2.bias"])
    img = img + mm(batch["locs"].float(), w["embeddings.loc.weight"], prec,
                   w["embeddings.loc.bias"])
    h = torch.cat([img, w["embeddings.word"][ids]], 1)
    S = h.shape[1]
    valid = torch.cat([batch["image_mask"], batch["input_mask"]], 1) != 0
    i = torch.arange(S, device=h.device)
    open_ = ((i[None, :] <= i[:, None])[None]
             & (valid[:, None, :] | (i[None, :] == i[:, None])[None]))[:, None]
    for layer in range(d["layers"]):
        p = f"layers.{layer}"
        h = h + mla(rms_norm(h, w[f"{p}.ln_attn.weight"], d["eps"]), open_, w,
                    f"{p}.attn", d, prec)
        x = rms_norm(h, w[f"{p}.ln_ffn.weight"], d["eps"])
        if layer < d["dense"]:
            h = h + swiglu_mlp(x, w[f"{p}.ffn.gate.weight"], w[f"{p}.ffn.up.weight"],
                               w[f"{p}.ffn.down.weight"], prec)
        else:
            bias = torch.as_tensor(biases.get(str(layer), [0.0] * d["router"]),
                                   dtype=torch.float32, device=h.device)
            H = h.shape[-1]
            h = h + expert_layer(x.reshape(-1, H), w, f"{p}.ffn", d, bias,
                                 prec).view(B, S, H)
    h = rms_norm(h, w["ln_f.weight"], d["eps"])
    last = S - 1 - valid.flip(1).int().argmax(1)
    pooled = h[torch.arange(B, device=h.device), last]
    if seed is not None:
        t = keep_threshold(CLF_RATE)
        pooled = torch.where(
            hidden_keep(fold_seed(seed, 3), pooled.shape, t, pooled.device),
            pooled * (256.0 / t), 0.0)
    c = layer_norm(gelu(mm(pooled, w["classifier.fc1.weight"], prec,
                           w["classifier.fc1.bias"])),
                   w["classifier.ln.weight"], w["classifier.ln.bias"], d["ln_eps"])
    return mm(c, w["classifier.fc2.weight"], prec, w["classifier.fc2.bias"])


def decays(name: str) -> bool:
    """Weight decay applies: not a bias, not under a norm module (``ln``,
    ``ln*``, ``*_ln``)."""
    *mods, leaf = name.split(".")
    in_ln = any(m == "ln" or m.endswith("_ln") or m.startswith("ln") for m in mods)
    return not (leaf == "bias" or in_ln)
