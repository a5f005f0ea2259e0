"""UC2 cross-modal encoder (port of clg_vqa_tpu/models/uc2.py:42-221).

The reference runs UC2 as 24 interleaved gated sublayers
(volta/volta/encoders.py:164-575) whose wiring collapses to a 12-block
post-LN transformer over the joint [text(40); image(36)] sequence with one
shared weight set; this module implements that collapsed form as an
``nn.ModuleList`` of blocks.

Embeddings follow UC2Embeddings (volta/volta/embeddings.py:606-669): text =
word + RoBERTa positions + token type, LN; image = LN(Linear(features)) +
LN(Linear(locs)) + token-type row 1 (the image token-type table is tied to
the text one, embeddings.py:630), LN. Pooling and head follow BertTextPooler
(relu, encoders.py:597-608) and SimpleClassifier (encoders.py:788-815).

The training forward (``deterministic=False``) drops as uc2.py:98-221
does: the text and image embeddings, each block's attention probabilities,
its attention output and its FFN output, and the pooled vector before the
classifier. Every site draws from its own stream, whose seed is the step's
``seed`` folded with the site's place (layers.fold_seed), as the JAX package
folds its key.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from ..config import UC2Config
from . import layers as L


def _dropout_seed(deterministic: bool, seed: int | None) -> int | None:
    """None for the deterministic forward, else ``seed`` (required)."""
    if deterministic:
        return None
    if seed is None:
        raise ValueError("deterministic=False needs a seed for dropout")
    return seed


class UC2Embeddings(nn.Module):
    def __init__(self, cfg: UC2Config, *, device, dtype=torch.float32):
        super().__init__()
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        kw = {"device": device, "dtype": dtype}
        self.pad_token_id = cfg.pad_token_id
        self.word = nn.Parameter(torch.empty(cfg.vocab_size, H, **kw))
        self.vocab_size = cfg.vocab_size
        self.mesh = None    # set when ``word`` is a vocabulary shard
        self.position = nn.Parameter(
            torch.empty(cfg.max_position_embeddings, H, **kw))
        self.token_type = nn.Parameter(torch.empty(cfg.type_vocab_size, H, **kw))
        self.ln = L.LayerNorm(H, eps, **kw)
        self.image = L.Linear(cfg.v_feature_size, H, **kw)
        self.loc = L.Linear(cfg.num_locs, H, **kw)
        self.image_ln = L.LayerNorm(H, eps, **kw)
        self.loc_ln = L.LayerNorm(H, eps, **kw)
        self.v_ln = L.LayerNorm(H, eps, **kw)

    def forward(self, input_ids, features, locs, token_type_ids=None, *,
                compute_dtype=None, dropout_rate: float = 0.0,
                seed: int | None = None):
        """UC2Embeddings.forward (volta/volta/embeddings.py:636-669);
        returns (text [B, T, H], image [B, R, H]), each dropped at
        ``dropout_rate`` when a seed is given."""
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos_ids = L.create_position_ids_from_input_ids(input_ids,
                                                       self.pad_token_id)
        t = (L.embed(self.word, input_ids, self.mesh, self.vocab_size)
             + self.position[pos_ids] + self.token_type[token_type_ids.long()])
        t = self.ln(t)
        img = self.image_ln(self.image(features, compute_dtype))
        loc = self.loc_ln(self.loc(locs, compute_dtype))
        # image token type = row 1 of the text table (tied module)
        v = self.v_ln(img + loc + self.token_type[1][None, None, :])
        t = L.dropout(t, dropout_rate, L.generator(L.fold_seed(seed, 0), t.device))
        v = L.dropout(v, dropout_rate, L.generator(L.fold_seed(seed, 1), v.device))
        return t, v


class UC2Block(nn.Module):
    """Post-LN block: h = LN(attn(h) + h); h = LN(ffn(h) + h)."""

    def __init__(self, cfg: UC2Config, *, device, dtype=torch.float32):
        super().__init__()
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        kw = {"device": device, "dtype": dtype}
        self.attn_dropout = cfg.attention_probs_dropout_prob
        self.hidden_dropout = cfg.hidden_dropout_prob
        self.attn = L.SelfAttention(H, cfg.num_heads, **kw)
        self.ln1 = L.LayerNorm(H, eps, **kw)
        self.ffn = L.FeedForward(H, cfg.intermediate_size, **kw)
        self.ln2 = L.LayerNorm(H, eps, **kw)

    def forward(self, h, bias, *, compute_dtype=None, fused_attn=False,
                seed: int | None = None):
        """seed None: deterministic; else the block's dropout seed, folded
        with 0 (attention probs), 1 (attention output), 2 (FFN output)."""
        a = self.attn(h, bias, compute_dtype=compute_dtype, fused=fused_attn,
                      dropout_rate=self.attn_dropout, seed=L.fold_seed(seed, 0))
        a = L.dropout(a, self.hidden_dropout,
                      L.generator(L.fold_seed(seed, 1), h.device))
        h = self.ln1(a + h)
        f = L.dropout(self.ffn(h, compute_dtype), self.hidden_dropout,
                      L.generator(L.fold_seed(seed, 2), h.device))
        return self.ln2(f + h)


class UC2(nn.Module):
    """UC2 + the GQA SimpleClassifier head (BertForVLTasks,
    volta/volta/encoders.py:1202-1259).

    Parameters are created on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``) and initialized from a ``torch.Generator`` on that
    device seeded with ``seed``, with the reference's distributions:
    normal(0, initializer_range), xavier-uniform for the classifier, zero
    padding row, LN scale 1 / bias 0."""

    def __init__(self, cfg: UC2Config, *, device=None, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        kw = {"device": dev, "dtype": dtype}
        self.cfg = cfg
        self.embeddings = UC2Embeddings(cfg, **kw)
        self.encoder = nn.ModuleList(UC2Block(cfg, **kw)
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
    def init_weights(self, generator: torch.Generator) -> None:
        std = self.cfg.initializer_range
        e = self.embeddings
        for table in (e.word, e.position, e.token_type):
            table.normal_(0.0, std, generator=generator)
        e.word[self.cfg.pad_token_id] = 0.0
        for m in self.modules():
            if isinstance(m, L.Linear):
                m.init_normal_(std, generator)
        self.classifier.fc1.init_xavier_(generator)
        self.classifier.fc2.init_xavier_(generator)

    def embed(self, input_ids, features, locs, token_type_ids=None, *,
              compute_dtype=None, seed: int | None = None):
        return self.embeddings(input_ids, features, locs, token_type_ids,
                               compute_dtype=compute_dtype,
                               dropout_rate=self.cfg.hidden_dropout_prob,
                               seed=seed)

    def encode(self, batch: dict, *, deterministic: bool = True,
               seed: int | None = None, compute_dtype=None, fused_attn=False):
        """Embeddings + the collapsed joint encoder + text pooler.
        Returns (joint_sequence [B, T+R, H], pooled [B, pooler_size]).
        deterministic=False drops with streams keyed by ``seed`` (required):
        the embeddings fold 0, block l folds (1, l)."""
        seed = _dropout_seed(deterministic, seed)
        L.check_fused(fused_attn)
        t_emb, v_emb = self.embed(
            batch["input_ids"], batch["features"], batch["locs"],
            batch.get("token_type_ids"), compute_dtype=compute_dtype,
            seed=L.fold_seed(seed, 0))
        h = torch.cat([t_emb, v_emb], dim=1)
        mask01 = torch.cat([batch["input_mask"], batch["image_mask"]], dim=1)
        bias = L.additive_mask(mask01)
        for i, block in enumerate(self.encoder):
            h = block(h, bias, compute_dtype=compute_dtype,
                      fused_attn=fused_attn,
                      seed=L.fold_seed(seed, 1, i))
        # BertTextPooler on text token 0 == joint position 0
        pooled = self.pooler(h[:, 0], compute_dtype)
        pooled = (torch.relu(pooled) if self.cfg.fusion_act == "relu"
                  else torch.tanh(pooled))
        return h, pooled

    def forward(self, batch: dict, *, deterministic: bool = True,
                seed: int | None = None, compute_dtype=None,
                fused_attn=False) -> torch.Tensor:
        """Logits [B, num_labels] for the VL-classifier-GQA head.
        deterministic=False needs ``seed``: the encoder folds 2, the pooled
        dropout before the classifier folds 3 (uc2.py:206-221)."""
        seed = _dropout_seed(deterministic, seed)
        _, pooled = self.encode(batch, deterministic=deterministic,
                                seed=L.fold_seed(seed, 2),
                                compute_dtype=compute_dtype,
                                fused_attn=fused_attn)
        return self.classifier(
            pooled, compute_dtype, dropout_rate=self.cfg.clf_dropout_prob,
            generator=L.generator(L.fold_seed(seed, 3), pooled.device))
