"""General VOLTA gated cross-modal encoder (port of clg_vqa_tpu/models/gated.py;
volta/volta/encoders.py:164-601 BertGatedSelfAttention / SelfOutput /
Intermediate / Output + BertEncoder, config.py BertConfig).

Where models/uc2.py implements the COLLAPSED special case (all four gates
on, everything shared, single-LN everywhere -> one joint transformer), this
module implements the general case: per-sublayer tt/tv/vt/vv attention
gates, t/v feed-forward gates, text<->vision weight sharing, single- or
dual-LN, per-sublayer width and head overrides, the ViLBERT/LXMERT dual and
VL-BERT/VisualBERT/UNITER bimodal embeddings (models/embeddings_zoo.py), the
three poolers and the fusion methods. ViLBERT (dual-stream with
co-attention sublayers), LXMERT, VisualBERT, UNITER and VL-BERT are WIRINGS
of this machinery in VOLTA's controlled setup.

The wirings are heterogeneous (sublayers differ in gates and widths), so
the encoder is a ``ModuleList`` of sublayers run in order, and its attention
is plain PyTorch: the JAX model always runs XLA attention (its forward
takes ``fused_attn`` and drops it, clg_vqa_tpu/models/gated.py:474-480), so
no kernel of the port belongs here. Scores and softmax stay fp32 whatever
the compute dtype; the probabilities are cast to it before P.V, whose
product accumulates in fp32.

Parameter names follow the JAX package's pytree (``sublayers.{n}.t.q``,
``sublayers.{n}.t_out.ln``, ...), so utils/convert.jax_params_to_state_dict
maps it by walking it. A shared sublayer holds only its text weights; its
vision stream reads them (VOLTA ties the ``v_*`` modules to the same
parameters).

The training forward (``deterministic=False``) draws each dropout site
from its own stream: the encoder folds 0 and the classifier 1 of the
step's seed; within the encoder the embeddings fold 0 and sublayer n folds
(1, n), whose sites fold 0, 1, ... in the JAX order (attention
probabilities per part, text then vision, then the two output drops).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Mapping

import torch
from torch import nn

from .. import resolve_device
from . import layers as L
from .embeddings_zoo import make_embeddings
from .uc2 import _dropout_seed

DUAL_EMBEDDINGS = ("vilbert", "lxmert")
SHARED_EMBEDDINGS = ("vl-bert", "visualbert", "uniter")


@dataclasses.dataclass
class GatedConfig:
    """volta/volta/config.py BertConfig, the gated-wiring subset (own copy of
    clg_vqa_tpu/models/gated.py:50-160). Defaults mirror the reference's;
    from_json ingests a VOLTA model-config JSON."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    pad_token_id: int = 0
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    model: str = "bert"                    # "bert" | "roberta"
    # vision
    v_feature_size: int = 2048
    v_hidden_size: int = 768
    v_num_attention_heads: int = 12
    v_intermediate_size: int = 3072
    v_hidden_dropout_prob: float = 0.1
    v_attention_probs_dropout_prob: float = 0.1
    num_locs: int = 5
    v_coordinate_embeddings_dim: int = 128   # VL-BERT only
    visual_target_weights: Mapping[str, float] = dataclasses.field(
        default_factory=dict)
    image_embeddings: str = "vilbert"
    # wiring
    tt_attn_sublayers: tuple = ()
    tv_attn_sublayers: tuple = ()
    vt_attn_sublayers: tuple = ()
    vv_attn_sublayers: tuple = ()
    t_ff_sublayers: tuple = ()
    v_ff_sublayers: tuple = ()
    shared_sublayers: tuple = ()
    single_ln_sublayers: tuple = ()
    sublayer2attn_hidden_size: Mapping[str, int] = dataclasses.field(
        default_factory=dict)
    sublayer2num_attention_heads: Mapping[str, int] = dataclasses.field(
        default_factory=dict)
    sublayer2intermediate_size: Mapping[str, int] = dataclasses.field(
        default_factory=dict)
    sublayer2v_attn_hidden_size: Mapping[str, int] = dataclasses.field(
        default_factory=dict)
    sublayer2v_num_attention_heads: Mapping[str, int] = dataclasses.field(
        default_factory=dict)
    sublayer2v_intermediate_size: Mapping[str, int] = dataclasses.field(
        default_factory=dict)
    # head
    pooler_size: int = 768
    v_pooler_size: int = 768
    fusion_method: str = "mul"       # sum | mul | text | vl-bert_vqa | none
    fusion_act: str = "relu"         # relu | tanh
    clf_hidden_size: int = 1536
    num_labels: int = 1842

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "GatedConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in d.items() if k in names}
        return cls(**kw)

    @classmethod
    def from_json(cls, path: str) -> "GatedConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # -- wiring introspection ------------------------------------------

    def _attn(self) -> set:
        return (set(self.tt_attn_sublayers) | set(self.tv_attn_sublayers)
                | set(self.vt_attn_sublayers) | set(self.vv_attn_sublayers))

    @property
    def depth(self) -> int:
        attn = self._attn()
        ff = set(self.t_ff_sublayers) | set(self.v_ff_sublayers)
        subs = attn | ff
        if subs != set(range(len(subs))):
            raise ValueError(f"non-contiguous sublayer numbers: {sorted(subs)}")
        if attn & ff:
            raise ValueError(f"overlapping attn/ff sublayers: {attn & ff}")
        return len(subs)

    def sub_kind(self, n: int) -> str:
        return "attn" if n in self._attn() else "ff"

    def attn_dims(self, n: int):
        """(hidden, heads, v_hidden, v_heads) for attn sublayer n, with
        per-sublayer overrides (encoders.py:168-171)."""
        return (self.sublayer2attn_hidden_size.get(str(n), self.hidden_size),
                self.sublayer2num_attention_heads.get(
                    str(n), self.num_attention_heads),
                self.sublayer2v_attn_hidden_size.get(
                    str(n), self.v_hidden_size),
                self.sublayer2v_num_attention_heads.get(
                    str(n), self.v_num_attention_heads))

    def ff_dims(self, n: int):
        return (self.sublayer2intermediate_size.get(
                    str(n), self.intermediate_size),
                self.sublayer2v_intermediate_size.get(
                    str(n), self.v_intermediate_size))


class _QKV(nn.Module):
    def __init__(self, d_in: int, d: int, **kw):
        super().__init__()
        self.q = L.Linear(d_in, d, **kw)
        self.k = L.Linear(d_in, d, **kw)
        self.v = L.Linear(d_in, d, **kw)


class _Out(nn.Module):
    def __init__(self, d_in: int, d: int, eps: float, **kw):
        super().__init__()
        self.dense = L.Linear(d_in, d, **kw)
        self.ln = L.LayerNorm(d, eps, **kw)


class _FF(nn.Module):
    def __init__(self, d: int, d_ff: int, eps: float, **kw):
        super().__init__()
        self.w1 = L.Linear(d, d_ff, **kw)
        self.w2 = L.Linear(d_ff, d, **kw)
        self.ln = L.LayerNorm(d, eps, **kw)


class _Sites:
    """The dropout sites of one sublayer, in order: site i draws from
    fold_seed(seed, i); None (deterministic) keeps everything."""

    def __init__(self, seed: int | None):
        self.seed, self.i = seed, 0

    def drop(self, x, rate: float):
        g = L.generator(L.fold_seed(self.seed, self.i), x.device)
        self.i += 1
        return L.dropout(x, rate, g)


def _split_heads(x, nh: int):
    B, S, D = x.shape
    return x.reshape(B, S, nh, D // nh).transpose(1, 2)


def _merge_heads(x):
    B, nh, S, hd = x.shape
    return x.transpose(1, 2).reshape(B, S, nh * hd)


class GatedAttention(nn.Module):
    """BertGatedAttention (encoders.py:229-451): gated QK^T with a JOINT
    softmax over the concatenated intra- and inter-stream scores when both
    gates are on (tt / vt first), gated PV, then per stream output dense +
    dropout + residual + LN, or one LN over the concatenated streams
    (single_ln) (clg_vqa_tpu/models/gated.py:252-366)."""

    def __init__(self, cfg: GatedConfig, n: int, **kw):
        super().__init__()
        self.cfg = cfg
        self.has_tt = n in cfg.tt_attn_sublayers
        self.has_tv = n in cfg.tv_attn_sublayers
        self.has_vt = n in cfg.vt_attn_sublayers
        self.has_vv = n in cfg.vv_attn_sublayers
        self.shared = n in cfg.shared_sublayers
        self.single_ln = n in cfg.single_ln_sublayers
        self.has_text = self.has_tt or self.has_tv
        self.has_vision = self.has_vv or self.has_vt
        H, self.nh, V, self.vnh = cfg.attn_dims(n)
        eps = cfg.layer_norm_eps
        self.t = self.t_out = self.v = self.v_out = None
        if self.has_text:
            self.t = _QKV(cfg.hidden_size, H, **kw)
            self.t_out = _Out(H, cfg.hidden_size, eps, **kw)
        if self.has_vision and not (self.has_text and self.shared):
            self.v = _QKV(cfg.v_hidden_size, V, **kw)
            self.v_out = _Out(V, cfg.v_hidden_size, eps, **kw)

    def _vision_weights(self):
        """The vision stream's (qkv, out): the text ones when shared."""
        return ((self.t, self.t_out) if self.v is None
                else (self.v, self.v_out))

    @staticmethod
    def _context(parts, vals, rate, sites: _Sites, cd):
        """softmax over the concatenated fp32 scores, dropout on each part's
        probabilities, sum of the parts' P.V in fp32."""
        probs = torch.softmax(torch.cat(parts, -1) if len(parts) > 1
                              else parts[0], dim=-1)
        ctx, off = 0.0, 0
        for s, val in zip(parts, vals):
            w = s.shape[-1]
            pr = sites.drop(probs[..., off:off + w], rate)
            if cd is not None:
                pr = pr.to(cd)
            ctx = ctx + torch.matmul(pr.float(), val.float())
            off += w
        return _merge_heads(ctx if cd is None else ctx.to(cd))

    def forward(self, t, v, t_mask, v_mask, *, seed=None, compute_dtype=None):
        cfg, cd = self.cfg, compute_dtype
        sites = _Sites(seed)
        vp, vop = self._vision_weights()
        tied = self.has_text and self.shared
        if self.has_text:
            tq, tk, tv_ = (_split_heads(lin(t, cd), self.nh)
                           for lin in (self.t.q, self.t.k, self.t.v))
        if self.has_vision:
            vq, vk, vv_ = (_split_heads(lin(v, cd), self.vnh)
                           for lin in (vp.q, vp.k, vp.v))

        def scores(q, k, mask):
            # fp32 whatever the compute dtype (the products of low-precision
            # values are exact in fp32)
            s = torch.matmul(q.float(), k.float().transpose(-1, -2))
            return s / math.sqrt(q.shape[-1]) + mask

        t_ctx = v_ctx = None
        if self.has_text:
            parts, vals = [], []
            if self.has_tt:                  # tt FIRST in the concat (:293)
                parts.append(scores(tq, tk, t_mask))
                vals.append(tv_)
            if self.has_tv:
                parts.append(scores(tq, vk, v_mask))
                vals.append(vv_)
            t_ctx = self._context(parts, vals, cfg.attention_probs_dropout_prob,
                                  sites, cd)
        if self.has_vision:
            parts, vals = [], []
            if self.has_vt:                  # vt FIRST in the concat (:309)
                parts.append(scores(vq, tk, t_mask))
                vals.append(tv_)
            if self.has_vv:
                parts.append(scores(vq, vk, v_mask))
                vals.append(vv_)
            v_ctx = self._context(
                parts, vals, (cfg.attention_probs_dropout_prob if tied
                              else cfg.v_attention_probs_dropout_prob), sites, cd)

        # BertGatedSelfOutput (encoders.py:368-425)
        t_res = (sites.drop(self.t_out.dense(t_ctx, cd), cfg.hidden_dropout_prob)
                 if self.has_text else 0.0)
        v_res = (sites.drop(vop.dense(v_ctx, cd),
                            cfg.hidden_dropout_prob if tied
                            else cfg.v_hidden_dropout_prob)
                 if self.has_vision else 0.0)
        if self.single_ln:
            joint = self.t_out.ln(torch.cat([t_res + t, v_res + v], dim=1))
            return joint[:, :t.shape[1]], joint[:, t.shape[1]:]
        t = self.t_out.ln(t_res + t) if self.has_text else t
        v = vop.ln(v_res + v) if self.has_vision else v
        return t, v


class GatedFF(nn.Module):
    """BertGatedFeedForward (encoders.py:453-581): per stream
    dense -> GeLU -> dense -> dropout + residual + LN, shared and single-LN
    like the attention output (clg_vqa_tpu/models/gated.py:368-409)."""

    def __init__(self, cfg: GatedConfig, n: int, **kw):
        super().__init__()
        self.cfg = cfg
        self.has_t = n in cfg.t_ff_sublayers
        self.has_v = n in cfg.v_ff_sublayers
        self.shared = n in cfg.shared_sublayers
        self.single_ln = n in cfg.single_ln_sublayers
        F, vF = cfg.ff_dims(n)
        eps = cfg.layer_norm_eps
        self.t = self.v = None
        if self.has_t:
            self.t = _FF(cfg.hidden_size, F, eps, **kw)
        if self.has_v and not (self.has_t and self.shared):
            self.v = _FF(cfg.v_hidden_size, vF, eps, **kw)

    def forward(self, t, v, t_mask=None, v_mask=None, *, seed=None,
                compute_dtype=None):
        cfg, cd = self.cfg, compute_dtype
        sites = _Sites(seed)
        tied = self.has_t and self.shared
        vp = self.t if self.v is None else self.v
        t_res = v_res = 0.0
        if self.has_t:
            h = L.gelu(self.t.w1(t, cd))
            t_res = sites.drop(self.t.w2(h, cd), cfg.hidden_dropout_prob)
        if self.has_v:
            h = L.gelu(vp.w1(v, cd))
            v_rate = cfg.hidden_dropout_prob if tied else cfg.v_hidden_dropout_prob
            v_res = sites.drop(vp.w2(h, cd), v_rate)
        if self.single_ln:
            joint = self.t.ln(torch.cat([t_res + t, v_res + v], dim=1))
            return joint[:, :t.shape[1]], joint[:, t.shape[1]:]
        t = self.t.ln(t_res + t) if self.has_t else t
        v = vp.ln(v_res + v) if self.has_v else v
        return t, v


class Gated(nn.Module):
    """The gated encoder + poolers + the GQA SimpleClassifier head
    (BertForVLTasks, encoders.py:1202-1263), with the call shape of
    models/uc2.UC2, so run_eval, make_train_step, FinetuneRunner and the
    checkpoints take it as they take UC2.

    Parameters are created on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``) and initialized from a ``torch.Generator`` seeded
    with ``seed`` (:meth:`init_weights`), with the JAX package's
    distributions (init_params, clg_vqa_tpu/models/gated.py:162-235)."""

    def __init__(self, cfg: GatedConfig, *, device=None, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        kw = {"device": dev, "dtype": dtype}
        self.cfg = cfg
        self.embeddings = make_embeddings(cfg, **kw)
        self.sublayers = nn.ModuleList(
            (GatedAttention if cfg.sub_kind(n) == "attn" else GatedFF)(cfg, n, **kw)
            for n in range(cfg.depth))
        self.t_pooler = self.v_pooler = None
        if cfg.fusion_method != "none":
            self.t_pooler = L.Linear(cfg.hidden_size, cfg.pooler_size, **kw)
        if cfg.fusion_method not in ("none", "text", "vl-bert_vqa"):
            self.v_pooler = L.Linear(cfg.v_hidden_size, cfg.v_pooler_size, **kw)
        self.classifier = L.SimpleClassifier(
            cfg.pooler_size, cfg.clf_hidden_size, cfg.num_labels,
            cfg.layer_norm_eps, **kw)
        self.init_weights(torch.Generator(dev).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.classifier.fc1.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """normal(0, initializer_range) for the encoder's and poolers'
        Linears, xavier-uniform for the classifier, the embeddings' own
        rules (models/embeddings_zoo.py), LN scale 1 / bias 0."""
        std = self.cfg.initializer_range
        self.embeddings.init_weights(generator)
        for m in (*self.sublayers, self.t_pooler, self.v_pooler):
            for lin in ([] if m is None else m.modules()):
                if isinstance(lin, L.Linear):
                    lin.init_normal_(std, generator)
        self.classifier.fc1.init_xavier_(generator)
        self.classifier.fc2.init_xavier_(generator)

    def encode(self, batch: dict, *, deterministic: bool = True,
               seed: int | None = None, compute_dtype=None):
        """BertModel.forward (encoders.py:958-1021): embeddings -> -10000
        additive masks -> the gated sublayers in order -> poolers
        (clg_vqa_tpu/models/gated.py:411-468). Returns (seq_t, seq_v,
        pooled_t, pooled_v); a pooled output the fusion method has no pooler
        for is None."""
        seed = _dropout_seed(deterministic, seed)
        cfg = self.cfg
        input_ids, features = batch["input_ids"], batch["features"]
        t_m = batch.get("input_mask")
        v_m = batch.get("image_mask")
        if t_m is None:
            t_m = torch.ones_like(input_ids)
        if v_m is None:
            v_m = torch.ones(features.shape[:2], device=features.device)
        token_type_ids = batch.get("segment_ids")
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)

        t, v = self.embeddings(input_ids, features, batch["locs"],
                               token_type_ids, seed=L.fold_seed(seed, 0))
        t_mask, v_mask = L.additive_mask(t_m), L.additive_mask(v_m)
        for n, sub in enumerate(self.sublayers):
            t, v = sub(t, v, t_mask, v_mask, seed=L.fold_seed(seed, 1, n),
                       compute_dtype=compute_dtype)

        act = torch.relu if cfg.fusion_act == "relu" else torch.tanh
        pooled_t = pooled_v = None
        if cfg.fusion_method == "vl-bert_vqa":
            # VLBertTextPooler (encoders.py:611-625): the token at
            # text_end - 2 of each row
            text_end = (input_ids != 0).sum(1)
            at = (text_end - 2) % t.shape[1]
            tok = t[torch.arange(t.shape[0], device=t.device), at]
            pooled_t = act(self.t_pooler(tok))
        elif cfg.fusion_method != "none":
            pooled_t = act(self.t_pooler(t[:, 0]))
        if self.v_pooler is not None:
            pooled_v = act(self.v_pooler(v[:, 0]))
        return t, v, pooled_t, pooled_v

    def forward(self, batch: dict, *, deterministic: bool = True,
                seed: int | None = None, compute_dtype=None,
                fused_attn=False) -> torch.Tensor:
        """Logits [B, num_labels]: the fused pooled output -> dropout ->
        SimpleClassifier (encoders.py:1202-1263,
        clg_vqa_tpu/models/gated.py:471-500). ``fused_attn`` is taken for
        the call shape of UC2 and M3P and ignored, as the JAX forward drops
        it: the gated wiring always runs its plain attention.
        deterministic=False needs ``seed``: the encoder folds 0, the
        classifier's dropout 1."""
        del fused_attn
        seed = _dropout_seed(deterministic, seed)
        _, _, pooled_t, pooled_v = self.encode(
            batch, deterministic=deterministic, seed=L.fold_seed(seed, 0),
            compute_dtype=compute_dtype)
        fm = self.cfg.fusion_method
        if fm == "sum":
            pooled = pooled_t + pooled_v
        elif fm == "mul":
            pooled = pooled_t * pooled_v
        elif fm in ("text", "vl-bert_vqa"):
            pooled = pooled_t
        else:
            raise ValueError(f"fusion_method {fm!r} has no pooled output for "
                             f"VL classification")
        return self.classifier(
            pooled, compute_dtype, dropout_rate=0.1,
            generator=L.generator(L.fold_seed(seed, 1), pooled.device))
