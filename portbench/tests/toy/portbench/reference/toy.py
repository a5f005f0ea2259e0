"""The throwaway family's plain reference: its schema read into VOLTA's
UC2 keys, then reference/model.py's UC2."""
from __future__ import annotations

from portbench.reference import model as volta
from portbench.reference.precision import FP32, Precision

decays = volta.decays


def as_uc2(cfg: dict) -> dict:
    n = cfg["blocks"]
    return {"model_name": "uc2", "hidden_size": cfg["width"],
            "num_attention_heads": cfg["heads"],
            "tt_attn_sublayers": list(range(0, 2 * n, 2)),
            "intermediate_size": cfg["ffn_width"], "layer_norm_eps": cfg["eps"],
            "pad_token_id": 1, "vocab_size": cfg["vocab"],
            "num_locs": cfg["locations"], "v_feature_size": cfg["feature_width"],
            "num_labels": cfg["answers"], "max_seq_length": cfg["tokens"],
            "max_region_num": cfg["regions"],
            "max_position_embeddings": cfg["positions"], "type_vocab_size": 2,
            "pooler_size": cfg["pooled_width"], "clf_hidden_size": cfg["head_width"]}


def forward(cfg: dict, w: dict, batch: dict, *, seed: int | None = None,
            prec: Precision = FP32):
    return volta.forward(as_uc2(cfg), w, batch, seed=seed, prec=prec)
