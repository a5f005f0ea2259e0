"""UC2 and M3P with the GQA classifier head, in plain float32 torch: the
reference of the families ``uc2`` and ``m3p`` (portbench/families/).

UC2 (Zhou et al., CVPR 2021; VOLTA's uc2_base.json): XLM-R base run as a
12-block post-LN transformer over [text (40); image regions (36)]. Text
embeddings are word + RoBERTa positions + token type 0, then LN; image
embeddings LN(Linear(features)) + LN(Linear(locs)) + token type 1, then LN.
The key bias is -10000 at padding. The pooler is ReLU(Linear(h[:, 0])).

M3P (Ni et al., CVPR 2021; VOLTA's m3p_base.json): the same widths over
[image regions (100); text (40)], image embeddings LN(Linear(features) +
Linear(locs)), position embeddings over the joint length, LN eps 1e-12
(hard-coded in the published model). A position is valid when it lies
before text length + image length (the published get_masks, a prefix over
the joint sequence); invalid keys are -inf and every block's output is
multiplied by the validity. The pooler is tanh(Linear(h[:, 0])).

Both: the classifier is dropout, Linear, GeLU (erf), LN, Linear. Training
drops at 0.1: the embeddings, each block's attention probabilities, its
attention output and its FFN output, and the pooled vector. Each site's
bits come from the step's seed folded with the site's place, as the
program folds it (reference/seeds.py).

Weights are a dict keyed by the checkpoint names of the port's models
(``embeddings.word``, ``encoder.3.attn.q.weight``, ...), Linear weights
[out, in]."""
from __future__ import annotations

import math

import torch

from .precision import FP32, Precision
from .seeds import attention_keep, fold_seed, hidden_keep, keep_threshold

RATE = 0.1              # every dropout site of both models (VOLTA configs)
CLF_RATE = 0.1          # BertForVLTasks' dropout before the classifier
M3P_EPS = 1e-12         # M3P's LayerNorm eps, hard-coded in its model code


def _shared(cfg: dict) -> dict:
    return dict(
        model=cfg["model_name"], H=cfg["hidden_size"],
        pad=cfg["pad_token_id"], vocab=cfg["vocab_size"],
        locs=cfg["num_locs"], feat=cfg["v_feature_size"],
        norm=bool(cfg.get("norm_embeddings", False)),
        labels=cfg["num_labels"], text=cfg["max_seq_length"],
        regions=cfg["max_region_num"], max_pos=cfg["max_position_embeddings"],
        type_vocab=cfg.get("type_vocab_size", 1), pooler=cfg["pooler_size"],
        clf_hidden=cfg["clf_hidden_size"])


def uc2_dims(cfg: dict) -> dict:
    """The numbers the reference needs, read from a UC2 configuration file
    (VOLTA's sublayer lists: one block a text-text attention sublayer)."""
    return dict(_shared(cfg), heads=cfg["num_attention_heads"],
                layers=len(cfg["tt_attn_sublayers"]),
                ffn=cfg["intermediate_size"], eps=cfg["layer_norm_eps"])


def m3p_dims(cfg: dict) -> dict:
    """The numbers the reference needs, read from an M3P configuration file
    (the FFN is 4 x hidden and the eps fixed, as the published model has
    them)."""
    return dict(_shared(cfg), heads=cfg["n_heads"], layers=cfg["n_layers"],
                ffn=4 * cfg["hidden_size"], eps=M3P_EPS)


def dims(cfg: dict) -> dict:
    """The numbers the reference needs, by the file's ``model_name``."""
    return {"uc2": uc2_dims, "m3p": m3p_dims}[cfg["model_name"]](cfg)


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def gelu(x):
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def linear(x, w: dict, name: str, prec: Precision):
    return prec.q(prec.q(x) @ prec.q(w[name + ".weight"]).t() + w[name + ".bias"])


def ln(x, w: dict, name: str, eps: float):
    return layer_norm(x, w[name + ".weight"], w[name + ".bias"], eps)


def drop(x, seed, prec: Precision = FP32):
    """Hidden dropout at RATE with the site's u8 bits (identity for None).
    ``prec`` is given where the activation is in the compute dtype."""
    if seed is None:
        return x
    t = keep_threshold(RATE)
    return torch.where(hidden_keep(seed, x.shape, t, x.device),
                       x * prec.scale(256.0 / t), 0.0)


def attention(x, bias, w: dict, p: str, heads: int, seed, prec: Precision):
    B, S, D = x.shape
    hd = D // heads

    def split(t):
        return t.reshape(B, S, heads, hd).transpose(1, 2)

    q, k, v = (split(linear(x, w, f"{p}.{n}", prec)) for n in "qkv")
    probs = torch.softmax(prec.q(q) @ prec.q(k).transpose(-1, -2)
                          / math.sqrt(hd) + bias, dim=-1)
    if seed is not None:
        t = keep_threshold(RATE)
        keep = attention_keep(seed, B, heads, S, t, x.device)
        probs = torch.where(keep, probs * (256.0 / t), 0.0)
    ctx = (prec.q(probs) @ prec.q(v)).transpose(1, 2).reshape(B, S, D)
    return linear(ctx, w, f"{p}.o", prec)


def block(h, bias, w: dict, i: int, d: dict, seed, prec: Precision):
    """Post-LN block i; ``seed`` is the block's (None: deterministic)."""
    p = f"encoder.{i}"
    a = attention(h, bias, w, f"{p}.attn", d["heads"], fold_seed(seed, 0), prec)
    h = ln(drop(a, fold_seed(seed, 1), prec) + h, w, f"{p}.ln1", d["eps"])
    f = linear(gelu(linear(h, w, f"{p}.ffn.w1", prec)), w, f"{p}.ffn.w2", prec)
    return ln(drop(f, fold_seed(seed, 2), prec) + h, w, f"{p}.ln2", d["eps"])


def _uc2_pooled(w, batch, d, seed, prec):
    ids = batch["input_ids"].long()
    emb_seed = fold_seed(seed, 0)
    keep = (ids != d["pad"]).long()
    pos = torch.cumsum(keep, 1) * keep + d["pad"]
    tt = w["embeddings.token_type"]
    t = ln(w["embeddings.word"][ids] + w["embeddings.position"][pos] + tt[0],
           w, "embeddings.ln", d["eps"])
    img = ln(linear(batch["features"], w, "embeddings.image", prec), w,
             "embeddings.image_ln", d["eps"])
    loc = ln(linear(batch["locs"], w, "embeddings.loc", prec), w,
             "embeddings.loc_ln", d["eps"])
    v = ln(img + loc + tt[1], w, "embeddings.v_ln", d["eps"])
    h = torch.cat([drop(t, fold_seed(emb_seed, 0)),
                   drop(v, fold_seed(emb_seed, 1))], 1)
    mask = torch.cat([batch["input_mask"], batch["image_mask"]], 1).float()
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :]
    for i in range(d["layers"]):
        h = block(h, bias, w, i, d, fold_seed(seed, 1, i), prec)
    return torch.relu(linear(h[:, 0], w, "pooler", prec))


def _m3p_pooled(w, batch, d, seed, prec):
    ids = batch["input_ids"].long()
    B, T = ids.shape
    R = batch["features"].shape[1]
    S = R + T
    length = batch["input_mask"].sum(1) + batch["image_mask"].sum(1)
    valid = (torch.arange(S, device=ids.device)[None] < length[:, None]).float()
    img = (linear(batch["features"], w, "embeddings.image", prec)
           + linear(batch["locs"], w, "embeddings.loc", prec))
    img = drop(ln(img, w, "embeddings.img_ln", d["eps"]), fold_seed(seed, 10), prec)
    h = torch.cat([img, w["embeddings.word"][ids]], 1)
    h = (h + w["embeddings.position"][:S][None]) * valid[:, :, None]
    h = drop(ln(h, w, "embeddings.ln", d["eps"]), fold_seed(seed, 11))
    bias = torch.zeros(B, 1, 1, S, device=h.device).masked_fill(
        valid[:, None, None, :] == 0, float("-inf"))
    for i in range(d["layers"]):
        h = block(h, bias, w, i, d, fold_seed(seed, 1, i), prec) * valid[:, :, None]
    return torch.tanh(linear(h[:, 0], w, "pooler", prec))


def forward(cfg: dict, w: dict, batch: dict, *, seed: int | None = None,
            prec: Precision = FP32) -> torch.Tensor:
    """Logits [B, num_labels] in float32. ``batch``: input_ids, input_mask
    [B, T]; features [B, R, F], locs [B, R, L], image_mask [B, R]. ``seed``
    None is the deterministic forward; an int keys every dropout site."""
    d = dims(cfg)
    pooled = {"uc2": _uc2_pooled, "m3p": _m3p_pooled}[d["model"]](
        w, batch, d, fold_seed(seed, 2), prec)
    if seed is not None:
        t = keep_threshold(CLF_RATE)
        pooled = torch.where(
            hidden_keep(fold_seed(seed, 3), pooled.shape, t, pooled.device),
            pooled * prec.scale(256.0 / t), 0.0)
    h = ln(gelu(linear(pooled, w, "classifier.fc1", prec)), w, "classifier.ln",
           d["eps"])
    return linear(h, w, "classifier.fc2", prec)


def decays(name: str) -> bool:
    """Weight decay applies: not a bias, not under a LayerNorm module."""
    *mods, leaf = name.split(".")
    in_ln = any(m == "ln" or m.endswith("_ln") or m.startswith("ln")
                for m in mods)
    return not (leaf == "bias" or in_ln)
