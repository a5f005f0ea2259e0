"""M3P cross-modal encoder (port of clg_vqa_tpu/models/m3p.py:41-170), the
``jointfwd`` path the reference runs for VQA
(volta/volta/m3p_transformer.py:877-964 via M3PForVLTasks).

- image embeddings: Linear(features) + Linear(locs), summed in the compute
  dtype, then LN (eps 1e-12) and dropout (BertImageEmbeddings,
  m3p_transformer.py:231-271);
- the sequence is [image (R regions); text (T tokens)], where bf16 image rows
  and fp32 word rows promote to fp32, with position embeddings shared over
  the joint length;
- **the prefix-length mask quirk**: a position is valid when
  ``pos < txt_len + img_len`` over the concatenated sequence (get_masks,
  m3p_transformer.py:59-79), so an image with fewer than R regions lends
  validity to its padding slots and takes it from trailing text;
- hidden *= mask, LN (eps 1e-12), dropout; the key bias is -inf at invalid
  keys (masked_fill semantics), not -10000;
- 12 post-norm blocks: attention with q pre-scaled by 1/sqrt(hd) in q's
  dtype, residual + LN1, FFN, residual + LN2, then hidden *= mask;
- pooled = tanh(Linear(h[:, 0])), position 0 being the first image region;
- the shared SimpleClassifier head.

Submodules carry the JAX pytree's key paths (``embeddings.{word, position,
ln, image, loc, img_ln}``, ``encoder.<l>.{attn, ln1, ffn, ln2}``,
``pooler``, ``classifier``), so the converters map by path.

Dropout seeds mirror the JAX fold path: the model folds 2 (encoder) and 3
(classifier); the encoder folds 10 (image embeddings), 11 (joint
embeddings) and (1, l) for block l, which folds 0, 1 and 2 for its
attention probabilities, attention output and FFN output.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from ..config import M3PConfig
from . import layers as L
from .uc2 import _dropout_seed


class M3PEmbeddings(nn.Module):
    def __init__(self, cfg: M3PConfig, *, device, dtype=torch.float32):
        super().__init__()
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        kw = {"device": device, "dtype": dtype}
        self.word = nn.Parameter(torch.empty(cfg.vocab_size, H, **kw))
        self.vocab_size = cfg.vocab_size
        self.mesh = None    # set when ``word`` is a vocabulary shard
        self.position = nn.Parameter(
            torch.empty(cfg.max_position_embeddings, H, **kw))
        self.ln = L.LayerNorm(H, eps, **kw)
        self.image = L.Linear(cfg.v_feature_size, H, **kw)
        self.loc = L.Linear(cfg.num_locs, H, **kw)
        self.img_ln = L.LayerNorm(H, eps, **kw)


class M3PBlock(nn.Module):
    """Post-norm block: h = LN1(attn(h) + h); h = LN2(h + ffn(h)); h *= mask."""

    def __init__(self, cfg: M3PConfig, *, device, dtype=torch.float32):
        super().__init__()
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        kw = {"device": device, "dtype": dtype}
        self.attn_dropout = cfg.attention_dropout
        self.hidden_dropout = cfg.dropout
        self.attn = L.SelfAttention(H, cfg.num_heads, **kw)
        self.ln1 = L.LayerNorm(H, eps, **kw)
        self.ffn = L.FeedForward(H, cfg.intermediate_size, **kw)
        self.ln2 = L.LayerNorm(H, eps, **kw)

    def forward(self, h, bias, mask01, *, compute_dtype=None, fused_attn=False,
                seed: int | None = None):
        a = self.attn(h, bias, compute_dtype=compute_dtype, fused=fused_attn,
                      dropout_rate=self.attn_dropout, seed=L.fold_seed(seed, 0),
                      scale_query=True)
        a = L.dropout(a, self.hidden_dropout,
                      L.generator(L.fold_seed(seed, 1), h.device))
        h = self.ln1(a + h)
        f = L.dropout(self.ffn(h, compute_dtype), self.hidden_dropout,
                      L.generator(L.fold_seed(seed, 2), h.device))
        return self.ln2(h + f) * mask01[:, :, None]


class M3P(nn.Module):
    """M3P + the GQA SimpleClassifier head (M3PForVLTasks,
    volta/volta/encoders.py:1315-1352).

    Parameters are created on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``) and initialized from a ``torch.Generator`` on that
    device seeded with ``seed``, with the JAX package's distributions
    (clg_vqa_tpu/models/m3p.py:41-78): normal(0, 0.02) for the embeddings and
    the linears, zero biases, a zero padding row, xavier-uniform for the
    classifier, LN scale 1 / bias 0."""

    def __init__(self, cfg: M3PConfig, *, device=None, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        kw = {"device": dev, "dtype": dtype}
        self.cfg = cfg
        self.embeddings = M3PEmbeddings(cfg, **kw)
        self.encoder = nn.ModuleList(M3PBlock(cfg, **kw)
                                     for _ in range(cfg.num_layers))
        self.pooler = L.Linear(cfg.hidden_size, cfg.pooler_size, **kw)
        self.classifier = L.SimpleClassifier(
            cfg.pooler_size, cfg.clf_hidden_size, cfg.num_labels,
            cfg.layer_norm_eps, **kw)
        self.init_weights(torch.Generator(dev).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.pooler.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02) -> None:
        e = self.embeddings
        for table in (e.word, e.position):
            table.normal_(0.0, std, generator=generator)
        e.word[self.cfg.pad_token_id] = 0.0
        for m in self.modules():
            if isinstance(m, L.Linear):
                m.init_normal_(std, generator)
        self.classifier.fc1.init_xavier_(generator)
        self.classifier.fc2.init_xavier_(generator)

    def encode(self, batch: dict, *, deterministic: bool = True,
               seed: int | None = None, compute_dtype=None, fused_attn=False):
        """jointfwd (m3p_transformer.py:877-964). Returns (sequence
        [B, R+T, H], pooled [B, pooler_size]). deterministic=False drops
        with streams keyed by ``seed`` (required)."""
        seed = _dropout_seed(deterministic, seed)
        L.check_fused(fused_attn)
        e = self.embeddings
        input_ids = batch["input_ids"]
        B, T = input_ids.shape
        R = batch["features"].shape[1]
        S = R + T
        cat_len = (batch["input_mask"].sum(1) + batch["image_mask"].sum(1))
        pos = torch.arange(S, device=input_ids.device)
        mask01 = (pos[None, :] < cat_len[:, None]).float()            # [B, S]

        img = (e.image(batch["features"], compute_dtype)
               + e.loc(batch["locs"], compute_dtype))
        img = L.dropout(e.img_ln(img), self.cfg.dropout,
                        L.generator(L.fold_seed(seed, 10), img.device))
        word = L.embed(e.word, input_ids, e.mesh, e.vocab_size)
        dt = torch.promote_types(img.dtype, word.dtype)
        h = torch.cat([img.to(dt), word.to(dt)], dim=1)
        h = (h + e.position[:S][None]) * mask01[:, :, None]
        h = L.dropout(e.ln(h), self.cfg.dropout,
                      L.generator(L.fold_seed(seed, 11), h.device))
        bias = torch.zeros(B, 1, 1, S, device=h.device).masked_fill(
            mask01[:, None, None, :] == 0, float("-inf"))
        for i, block in enumerate(self.encoder):
            h = block(h, bias, mask01, compute_dtype=compute_dtype,
                      fused_attn=fused_attn, seed=L.fold_seed(seed, 1, i))
        pooled = torch.tanh(self.pooler(h[:, 0], compute_dtype))
        return h, pooled

    def forward(self, batch: dict, *, deterministic: bool = True,
                seed: int | None = None, compute_dtype=None,
                fused_attn=False) -> torch.Tensor:
        """Logits [B, num_labels] for the VL-classifier-GQA head.
        deterministic=False needs ``seed``: the encoder folds 2, the pooled
        dropout before the classifier folds 3 (m3p.py:157-170)."""
        seed = _dropout_seed(deterministic, seed)
        _, pooled = self.encode(batch, deterministic=deterministic,
                                seed=L.fold_seed(seed, 2),
                                compute_dtype=compute_dtype,
                                fused_attn=fused_attn)
        return self.classifier(
            pooled, compute_dtype, dropout_rate=self.cfg.clf_dropout_prob,
            generator=L.generator(L.fold_seed(seed, 3), pooled.device))
