"""VOLTA embedding zoo (port of clg_vqa_tpu/models/embeddings_zoo.py): the
text, dual and bimodal embedding variants of the general gated encoder
(volta/volta/embeddings.py:39-677), as ``nn.Module``s whose parameter names
follow the JAX package's pytree keys.

Covered (reference classes, file:line):
 - text:    BertEmbeddings (:39-70), RobertaEmbeddings (:73-114; the
            reference adds ONLY the word embeddings, the position and
            token-type adds being commented out at :111, a quirk kept)
 - dual:    ViLBertImageEmbeddings (:201-220), LxmertImageEmbeddings
            (:223-246)
 - bimodal: VLBertEmbeddings (:258-375), VisualBertEmbeddings (:378-472),
            UniterEmbeddings (:475-542)
(UC2's and M3P's embeddings live in models/{uc2,m3p}.py.)

Numerics kept from the JAX package: TF-style LayerNorm (eps inside the
sqrt), padding rows zero at init, the VL-BERT in-place feature and position
surgeries as masked selects. Every module computes in fp32 (the JAX
functions take no compute dtype) and returns (text [B, T, H], image
[B, R, H_v]); with a seed it drops from streams fold_seed(seed, i).
"""
from __future__ import annotations

import torch
from torch import nn

from . import layers as L


def _drop(x, rate: float, seed: int | None):
    return L.dropout(x, rate, L.generator(seed, x.device))


def _table(n: int, d: int, **kw) -> nn.Parameter:
    return nn.Parameter(torch.empty(n, d, **kw))


def _arange_ids(input_ids: torch.Tensor) -> torch.Tensor:
    S = input_ids.shape[1]
    return torch.arange(S, device=input_ids.device).expand_as(input_ids)


class BertTextEmbeddings(nn.Module):
    """BertEmbeddings (cfg.model "bert") / RobertaEmbeddings ("roberta"):
    word (+ position + token type for "bert"), LN, dropout. The RoBERTa
    variant uses only the word embedding (embeddings.py:111); its position
    and token-type tables still exist in the state dict."""

    def __init__(self, cfg, **kw):
        super().__init__()
        H = cfg.hidden_size
        self.cfg = cfg
        self.word = _table(cfg.vocab_size, H, **kw)
        self.position = _table(cfg.max_position_embeddings, H, **kw)
        self.token_type = _table(cfg.type_vocab_size, H, **kw)
        self.ln = L.LayerNorm(H, cfg.layer_norm_eps, **kw)

    @torch.no_grad()
    def init_text(self, generator, pad: int) -> None:
        std = self.cfg.initializer_range
        for t in (self.word, self.position, self.token_type):
            t.normal_(0.0, std, generator=generator)
        self.word[pad] = 0.0

    def init_weights(self, generator) -> None:
        self.init_text(generator,
                       0 if self.cfg.model == "bert" else self.cfg.pad_token_id)

    def text_sum(self, input_ids, token_type_ids, pos_ids=None):
        """word + position + token type (the BERT text sum)."""
        if pos_ids is None:
            pos_ids = _arange_ids(input_ids)
        return (self.word[input_ids.long()] + self.position[pos_ids]
                + self.token_type[token_type_ids.long()])

    def forward(self, input_ids, token_type_ids, *, seed=None):
        if self.cfg.model == "roberta":
            t = self.word[input_ids.long()]
        else:
            t = self.text_sum(input_ids, token_type_ids)
        return _drop(self.ln(t), self.cfg.hidden_dropout_prob, seed)


class DualImageEmbeddings(nn.Module):
    """ViLBERT: LN(image(features) + loc(locs)); LXMERT: the mean of
    LN(image(features)) and LN(loc(locs)) (embeddings.py:213-246)."""

    def __init__(self, cfg, **kw):
        super().__init__()
        V, eps = cfg.v_hidden_size, cfg.layer_norm_eps
        self.cfg = cfg
        self.image = L.Linear(cfg.v_feature_size, V, **kw)
        self.loc = L.Linear(cfg.num_locs, V, **kw)
        if cfg.image_embeddings == "lxmert":
            self.img_ln = L.LayerNorm(V, eps, **kw)
            self.loc_ln = L.LayerNorm(V, eps, **kw)
        else:
            self.ln = L.LayerNorm(V, eps, **kw)

    def init_weights(self, generator) -> None:
        for lin in (self.image, self.loc):
            lin.init_normal_(self.cfg.initializer_range, generator)

    def forward(self, features, locs, *, seed=None):
        img, loc = self.image(features), self.loc(locs)
        if self.cfg.image_embeddings == "lxmert":
            v = (self.img_ln(img) + self.loc_ln(loc)) / 2.0
        else:
            v = self.ln(img + loc)
        return _drop(v, self.cfg.v_hidden_dropout_prob, seed)


class DualEmbeddings(nn.Module):
    """ViLBERT / LXMERT: the text embeddings and the image embeddings, each
    with its own stream (text fold 0, image fold 1)."""

    def __init__(self, cfg, **kw):
        super().__init__()
        self.text = BertTextEmbeddings(cfg, **kw)
        self.image = DualImageEmbeddings(cfg, **kw)

    def init_weights(self, generator) -> None:
        self.text.init_weights(generator)
        self.image.init_weights(generator)

    def forward(self, input_ids, features, locs, token_type_ids, *, seed=None):
        return (self.text(input_ids, token_type_ids, seed=L.fold_seed(seed, 0)),
                self.image(features, locs, seed=L.fold_seed(seed, 1)))


class VisualBertEmbeddings(BertTextEmbeddings):
    """VisualBertEmbeddings.forward (embeddings.py:410-472): text as BERT,
    image = projection + visual position row 0 + visual type row 1, then
    ONE LayerNorm and dropout over the concatenation, split back. The
    visual tables start as copies of the text ones (special_initialize,
    embeddings.py:402-408)."""

    def __init__(self, cfg, **kw):
        super().__init__(cfg, **kw)
        H = cfg.hidden_size
        self.projection = L.Linear(cfg.v_feature_size, H, **kw)
        self.v_token_type = _table(cfg.type_vocab_size, H, **kw)
        self.v_position = _table(cfg.max_position_embeddings, H, **kw)

    @torch.no_grad()
    def init_weights(self, generator) -> None:
        super().init_weights(generator)
        self.projection.init_normal_(self.cfg.initializer_range, generator)
        self.v_token_type.copy_(self.token_type)
        self.v_position.copy_(self.position)

    def forward(self, input_ids, features, locs, token_type_ids, *, seed=None):
        S = input_ids.shape[1]
        t = self.text_sum(input_ids, token_type_ids)
        v = (self.projection(features) + self.v_position[0][None, None, :]
             + self.v_token_type[1][None, None, :])
        joint = self.ln(torch.cat([t, v], dim=1))
        joint = _drop(joint, self.cfg.hidden_dropout_prob, L.fold_seed(seed, 0))
        return joint[:, :S], joint[:, S:]


class UniterEmbeddings(BertTextEmbeddings):
    """UniterEmbeddings.forward (embeddings.py:514-542): model "roberta"
    takes pad-skipping position ids and image type row 0 of a SEPARATE
    image table; "bert" arange positions and row 1 of the text type table.
    v_ln starts as a copy of the text LN (embeddings.py:512-516)."""

    def __init__(self, cfg, **kw):
        super().__init__(cfg, **kw)
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.image = L.Linear(cfg.v_feature_size, cfg.v_hidden_size, **kw)
        self.loc = L.Linear(cfg.num_locs, cfg.v_hidden_size, **kw)
        if cfg.model == "roberta":
            self.image_token_type = _table(cfg.type_vocab_size, H, **kw)
        self.image_ln = L.LayerNorm(H, eps, **kw)
        self.loc_ln = L.LayerNorm(H, eps, **kw)
        self.v_ln = L.LayerNorm(H, eps, **kw)

    @torch.no_grad()
    def init_weights(self, generator) -> None:
        super().init_weights(generator)
        std = self.cfg.initializer_range
        self.image.init_normal_(std, generator)
        self.loc.init_normal_(std, generator)
        if self.cfg.model == "roberta":
            self.image_token_type.normal_(0.0, std, generator=generator)
        self.v_ln.load_state_dict(self.ln.state_dict())

    def forward(self, input_ids, features, locs, token_type_ids, *, seed=None):
        roberta = self.cfg.model == "roberta"
        pos_ids = (L.create_position_ids_from_input_ids(
            input_ids.long(), self.cfg.pad_token_id) if roberta else None)
        t = self.ln(self.text_sum(input_ids, token_type_ids, pos_ids))
        img = self.image_ln(self.image(features))
        loc = self.loc_ln(self.loc(locs))
        type_row = (self.image_token_type[0] if roberta
                    else self.token_type[1])      # embeddings.py:538
        v = self.v_ln(img + loc + type_row[None, None, :])
        rate = self.cfg.hidden_dropout_prob
        return (_drop(t, rate, L.fold_seed(seed, 0)),
                _drop(v, rate, L.fold_seed(seed, 1)))


def coordinate_embeddings(boxes: torch.Tensor, dim: int) -> torch.Tensor:
    """Sin/cos box-geometry embeddings (embeddings.py:179-198):
    boxes [B, K, >=4] xyxy -> [B, K, 4, 2 * dim]."""
    x_c = (boxes[..., 0] + boxes[..., 2]) / 2 * 100
    y_c = (boxes[..., 1] + boxes[..., 3]) / 2 * 100
    w = (boxes[..., 2] - boxes[..., 0]) * 100
    h = (boxes[..., 3] - boxes[..., 1]) * 100
    pos = torch.stack([x_c, y_c, w, h], dim=-1)            # [B, K, 4]
    ar = torch.arange(dim, dtype=boxes.dtype, device=boxes.device)
    dim_mat = torch.pow(torch.tensor(1000.0, dtype=boxes.dtype,
                                     device=boxes.device), ar / float(dim))
    ang = pos[..., None] / dim_mat                         # [B, K, 4, dim]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class VLBertEmbeddings(nn.Module):
    """VLBertEmbeddings.forward (embeddings.py:314-375). The reference's
    in-place surgeries become masked selects:
      - all-zero feature rows are replaced by object_mask_visual (:317-318);
      - the LAST object's linguistic embedding is the end token (:341);
      - text positions at/after text_end shift by num_boxes; objects sit at
        text_end, the last object at text_end + 1 (:357-363).
    Objects take token type row 2, so the config needs type_vocab_size >= 3
    (the reference's lookup raises below that; JAX's clamps to row 1)."""

    def __init__(self, cfg, **kw):
        super().__init__()
        if cfg.type_vocab_size < 3:
            raise ValueError(
                f"image_embeddings='vl-bert' reads token type row 2 for its "
                f"objects: type_vocab_size must be >= 3, got "
                f"{cfg.type_vocab_size}")
        H, V, eps = cfg.hidden_size, cfg.v_hidden_size, cfg.layer_norm_eps
        self.cfg = cfg
        self.word = _table(cfg.vocab_size, H, **kw)
        self.position = _table(cfg.max_position_embeddings, H, **kw)
        self.token_type = _table(cfg.type_vocab_size, H, **kw)
        # obj_downsample: dropout -> linear(2 * v_feat, v_hidden) -> relu
        self.obj_downsample = L.Linear(2 * cfg.v_feature_size, V, **kw)
        self.object_linguistic = _table(1, H, **kw)
        self.object_mask_visual = _table(1, cfg.v_feature_size, **kw)
        self.end = _table(1, H, **kw)
        self.visual_ln_text = L.LayerNorm(H, eps, **kw)
        self.visual_ln_object = L.LayerNorm(H, eps, **kw)
        self.ln = L.LayerNorm(H, eps, **kw)
        if V != H:
            self.visual_1x1_text = L.Linear(V, H, **kw)
            self.visual_1x1_object = L.Linear(V, H, **kw)
        else:
            self.visual_1x1_text = self.visual_1x1_object = None
        self.object_mask_word = (
            _table(1, H, **kw)
            if cfg.visual_target_weights.get("6", 0) > 0 else None)

    @torch.no_grad()
    def init_weights(self, generator) -> None:
        std = self.cfg.initializer_range
        for t in (self.word, self.position, self.token_type):
            t.normal_(0.0, std, generator=generator)
        self.word[0] = 0.0
        self.obj_downsample.init_xavier_(generator)
        for t in (self.object_linguistic, self.end, self.object_mask_word):
            if t is not None:
                t.normal_(0.0, std, generator=generator)
        self.object_mask_visual.zero_()
        # visual_ln_{text,object} scales START at 0 (embeddings.py:311-312)
        for ln in (self.visual_ln_text, self.visual_ln_object):
            ln.weight.zero_()
            ln.bias.zero_()
        for lin in (self.visual_1x1_text, self.visual_1x1_object):
            if lin is not None:
                lin.init_normal_(std, generator)

    def forward(self, input_ids, features, locs, token_type_ids, *, seed=None):
        B, S = input_ids.shape
        R = features.shape[1]
        cfg = self.cfg
        ids = input_ids.long()

        mvrc = (features == 0.0).all(-1)                     # [B, R]
        feats = torch.where(mvrc[..., None], self.object_mask_visual[0],
                            features)
        coord = coordinate_embeddings(locs, cfg.v_coordinate_embeddings_dim)
        cat = torch.cat([coord.reshape(B, R, -1), feats.reshape(B, R, -1)], -1)
        cat = _drop(cat, cfg.v_attention_probs_dropout_prob, L.fold_seed(seed, 0))
        final = torch.relu(self.obj_downsample(cat))         # [B, R, V]

        obj_vis = final
        if self.visual_1x1_object is not None:
            obj_vis = self.visual_1x1_object(obj_vis)
        obj_vis = self.visual_ln_object(obj_vis)
        H = self.object_linguistic.shape[1]
        obj_ling = self.object_linguistic[0].expand(B, R, H)
        if self.object_mask_word is not None:
            obj_ling = torch.where(mvrc[..., None], self.object_mask_word[0],
                                   obj_ling)
        # the last object is the end embedding
        obj_ling = torch.cat([obj_ling[:, :-1], self.end[0].expand(B, 1, H)], 1)
        obj_vl = obj_ling + obj_vis

        text_vis = final[:, -1][:, None, :].expand(B, S, final.shape[-1])
        if self.visual_1x1_text is not None:
            text_vis = self.visual_1x1_text(text_vis)
        text_vl = self.word[ids] + self.visual_ln_text(text_vis)

        text_end = (ids != 0).sum(1, keepdim=True)           # [B, 1]
        t_type = self.token_type[token_type_ids.long()]
        o_type = self.token_type[2][None, None, :]

        # REFERENCE BUG KEPT (embeddings.py:357-361): the in-place
        # `text_position_ids[mask] += num_boxes` runs on an EXPANDED tensor
        # whose batch rows share one storage row, so a column shifts for
        # ALL rows if ANY row's text ends at or before it
        pos1 = torch.arange(S, device=ids.device)
        shift_any = (pos1[None, :] >= text_end).any(0)       # [S]
        pos = torch.where(shift_any, pos1 + R, pos1).expand(B, S)
        last = torch.zeros(R, dtype=torch.long, device=ids.device)
        last[-1] = 1
        obj_pos = text_end + last[None, :]                   # [B, R]

        t = text_vl + self.position[pos] + t_type
        v = obj_vl + self.position[obj_pos] + o_type
        joint = self.ln(torch.cat([t, v], dim=1))
        joint = _drop(joint, cfg.hidden_dropout_prob, L.fold_seed(seed, 1))
        return joint[:, :S], joint[:, S:]


def make_embeddings(cfg, **kw) -> nn.Module:
    """The embeddings module of a gated config's ``image_embeddings``."""
    cls = {"vilbert": DualEmbeddings, "lxmert": DualEmbeddings,
           "visualbert": VisualBertEmbeddings, "uniter": UniterEmbeddings,
           "vl-bert": VLBertEmbeddings}.get(cfg.image_embeddings)
    if cls is None:
        raise ValueError(
            f"image_embeddings={cfg.image_embeddings!r} is not a gated-zoo "
            f"variant (uc2/m3p have their own models/{{uc2,m3p}}.py)")
    return cls(cfg, **kw)
