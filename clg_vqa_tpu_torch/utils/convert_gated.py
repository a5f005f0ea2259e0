"""VOLTA gated-model state dicts <-> the port's Gated (port of
clg_vqa_tpu/utils/convert_gated.py: ``volta_gated_to_pytree`` :102 and
``pytree_to_volta_gated`` :168).

Torch module paths (volta/volta/encoders.py BertForVLTasks):
  bert.embeddings.* / bert.v_embeddings.*        (embeddings zoo)
  bert.encoder.layer.{n}.attention_self.{query,key,value}[.v_*]
  bert.encoder.layer.{n}.attention_output.{dense,LayerNorm}[.v_*]
  bert.encoder.layer.{n}.{intermediate,output}.{dense,...}[.v_*]
  bert.t_pooler.dense / bert.v_pooler.dense
  clfs_dict.{task}.logit_fc.{0,2,3}

The port's Linear weights are [out, in] like torch's, so a VOLTA state dict
and the port's are a renaming of each other. Sharing: when a sublayer
shares its text and vision weights, the reference ASSIGNS the same
parameter to both module paths, so its state dict carries BOTH key
families with equal tensors. The import reads the plain names and checks
that every ``v_*`` alias present equals its plain tensor; the export writes
both, so that reference-side loads are key-complete.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

Row = tuple[str, str, tuple[str, ...]]     # (port, VOLTA, VOLTA aliases)


def _embedding_rows(cfg) -> list[Row]:
    rows: list[Row] = []

    def table(port, volta):
        rows.append((port, f"{volta}.weight", ()))

    def pair(port, volta):
        rows.extend((f"{port}.{s}", f"{volta}.{s}", ()) for s in ("weight", "bias"))

    e = "bert.embeddings"
    kind = cfg.image_embeddings
    text = "embeddings.text" if kind in ("vilbert", "lxmert") else "embeddings"
    table(f"{text}.word", f"{e}.word_embeddings")
    table(f"{text}.position", f"{e}.position_embeddings")
    table(f"{text}.token_type", f"{e}.token_type_embeddings")
    if kind != "vl-bert":
        pair(f"{text}.ln", f"{e}.LayerNorm")
    if kind in ("vilbert", "lxmert"):
        v = "bert.v_embeddings"
        pair("embeddings.image.image", f"{v}.image_embeddings")
        pair("embeddings.image.loc", f"{v}.image_location_embeddings")
        if kind == "lxmert":
            pair("embeddings.image.img_ln", f"{v}.ImgLayerNorm")
            pair("embeddings.image.loc_ln", f"{v}.LocLayerNorm")
        else:
            pair("embeddings.image.ln", f"{v}.LayerNorm")
    elif kind == "visualbert":
        pair("embeddings.projection", f"{e}.projection")
        table("embeddings.v_token_type", f"{e}.token_type_embeddings_visual")
        table("embeddings.v_position", f"{e}.position_embeddings_visual")
    elif kind == "uniter":
        pair("embeddings.image", f"{e}.image_embeddings")
        pair("embeddings.loc", f"{e}.image_location_embeddings")
        if cfg.model == "roberta":
            table("embeddings.image_token_type",
                  f"{e}.image_token_type_embeddings")
        pair("embeddings.image_ln", f"{e}.image_layer_norm")
        pair("embeddings.loc_ln", f"{e}.image_location_layer_norm")
        pair("embeddings.v_ln", f"{e}.v_LayerNorm")
    elif kind == "vl-bert":
        pair("embeddings.obj_downsample", f"{e}.obj_downsample.1")
        table("embeddings.object_linguistic", f"{e}.object_linguistic_embeddings")
        table("embeddings.object_mask_visual", f"{e}.object_mask_visual_embedding")
        table("embeddings.end", f"{e}.end_embedding")
        pair("embeddings.visual_ln_text", f"{e}.visual_ln_text")
        pair("embeddings.visual_ln_object", f"{e}.visual_ln_object")
        pair("embeddings.ln", f"{e}.LayerNorm")
        if cfg.v_hidden_size != cfg.hidden_size:
            pair("embeddings.visual_1x1_text", f"{e}.visual_1x1_text")
            pair("embeddings.visual_1x1_object", f"{e}.visual_1x1_object")
        if cfg.visual_target_weights.get("6", 0) > 0:
            table("embeddings.object_mask_word", f"{e}.object_mask_word_embedding")
    else:
        raise ValueError(f"image_embeddings={kind!r} is not a gated-zoo variant")
    return rows


def _sublayer_rows(cfg, n: int) -> list[Row]:
    """One sublayer's rows. Where its text and vision share weights, the
    vision stream's VOLTA names are aliases of the text rows."""
    lp = f"bert.encoder.layer.{n}"
    sp = f"sublayers.{n}"
    shared = n in cfg.shared_sublayers
    if cfg.sub_kind(n) == "attn":
        has_text = n in cfg.tt_attn_sublayers or n in cfg.tv_attn_sublayers
        has_vision = n in cfg.vt_attn_sublayers or n in cfg.vv_attn_sublayers
        mods = (("q", "attention_self", "query"), ("k", "attention_self", "key"),
                ("v", "attention_self", "value"),
                ("dense", "attention_output", "dense"),
                ("ln", "attention_output", "LayerNorm"))

        def port(stream, m):
            group = stream if m in ("q", "k", "v") else f"{stream}_out"
            return f"{sp}.{group}.{m}"
    else:
        has_text, has_vision = n in cfg.t_ff_sublayers, n in cfg.v_ff_sublayers
        mods = (("w1", "intermediate", "dense"), ("w2", "output", "dense"),
                ("ln", "output", "LayerNorm"))

        def port(stream, m):
            return f"{sp}.{stream}.{m}"
    tied = has_text and has_vision and shared
    rows: list[Row] = []
    for m, group, name in mods:
        for s in ("weight", "bias"):
            if has_text:
                rows.append((f"{port('t', m)}.{s}", f"{lp}.{group}.{name}.{s}",
                             (f"{lp}.{group}.v_{name}.{s}",) if tied else ()))
            if has_vision and not tied:
                rows.append((f"{port('v', m)}.{s}",
                             f"{lp}.{group}.v_{name}.{s}", ()))
    return rows


def _clf_rows(task_key: str) -> list[Row]:
    clf = f"clfs_dict.{task_key}.logit_fc"
    return [(f"classifier.{port}.{s}", f"{clf}.{i}.{s}", ())
            for port, i in (("fc1", 0), ("ln", 2), ("fc2", 3))
            for s in ("weight", "bias")]


def _rows(cfg, task_key: str) -> list[Row]:
    rows = _embedding_rows(cfg)
    for n in range(cfg.depth):
        rows += _sublayer_rows(cfg, n)
    poolers = []
    if cfg.fusion_method != "none":
        poolers.append("t_pooler")
    if cfg.fusion_method not in ("none", "text", "vl-bert_vqa"):
        poolers.append("v_pooler")
    rows += [(f"{p}.{s}", f"bert.{p}.dense.{s}", ())
             for p in poolers for s in ("weight", "bias")]
    return rows + _clf_rows(task_key)


def _task_key(sd: Mapping) -> str | None:
    """The task of the first ``clfs_dict.{task}.logit_fc.0.weight`` key,
    as the JAX importer finds it."""
    for k in sd:
        if k.startswith("clfs_dict.") and k.endswith("logit_fc.0.weight"):
            return k.split(".")[1]
    return None


def volta_gated_to_state_dict(sd: Mapping[str, np.ndarray], cfg,
                              task_key: str | None = None
                              ) -> dict[str, np.ndarray]:
    """A (normalized) VOLTA BertForVLTasks state dict of a gated wiring ->
    the port's Gated state-dict names. The classifier is optional (a
    pretrained body has none); its task is the first ``clfs_dict`` entry
    unless ``task_key`` names one. Every ``v_*`` alias of a shared sublayer
    that is present must equal its plain tensor."""
    task_key = task_key or _task_key(sd) or "TASK15"
    out = {}
    for port, volta, aliases in _rows(cfg, task_key):
        if volta not in sd:
            if port.startswith("classifier."):
                continue
            raise KeyError(f"missing {volta} in the VOLTA state dict")
        for al in aliases:
            if al in sd and not np.array_equal(np.asarray(sd[al]),
                                               np.asarray(sd[volta])):
                raise ValueError(f"shared sublayer: {al} != {volta}")
        out[port] = np.asarray(sd[volta], np.float32)
    return out


def state_dict_to_volta_gated(model, cfg, task_key: str = "TASK15"
                              ) -> dict[str, np.ndarray]:
    """The port's Gated (or its state dict, tensors or arrays) -> VOLTA
    names, the ``v_*`` aliases of shared sublayers included, so reference
    loads are key-complete."""
    if isinstance(model, torch.nn.Module):
        model = model.state_dict()
    own = {k: np.asarray(torch.as_tensor(v).detach().cpu().numpy())
           for k, v in model.items()}
    sd = {}
    for port, volta, aliases in _rows(cfg, task_key):
        if port not in own:
            if port.startswith("classifier."):
                continue
            raise KeyError(f"not a Gated state dict of this config: "
                           f"missing {port}")
        for name in (volta, *aliases):
            sd[name] = np.ascontiguousarray(own[port])
    return sd
