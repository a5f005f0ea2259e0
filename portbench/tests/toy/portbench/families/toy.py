"""A throwaway family for the tests: UC2's architecture under a
configuration schema of its own, added to a checkout as new files only."""
from __future__ import annotations

from portbench.families import _volta
from portbench.harness import program
from portbench.reference import toy as reference


def dims(cfg: dict) -> dict:
    return dict(model=cfg["model_name"], H=cfg["width"], heads=cfg["heads"],
                layers=cfg["blocks"], ffn=cfg["ffn_width"], eps=cfg["eps"],
                pad=1, vocab=cfg["vocab"], locs=cfg["locations"],
                feat=cfg["feature_width"], norm=False, labels=cfg["answers"],
                text=cfg["tokens"], regions=cfg["regions"],
                max_pos=cfg["positions"], type_vocab=2, pooler=cfg["pooled_width"],
                clf_hidden=cfg["head_width"])


def layout(d: dict) -> list:
    H = d["H"]
    out = [("embeddings.word", (d["vocab"], H), "padded"),
           ("embeddings.position", (d["max_pos"], H), "normal"),
           ("embeddings.token_type", (d["type_vocab"], H), "normal")]
    _volta.ln(out, "embeddings.ln", H)
    _volta.lin(out, "embeddings.image", d["feat"], H)
    _volta.lin(out, "embeddings.loc", d["locs"], H)
    for n in ("image_ln", "loc_ln", "v_ln"):
        _volta.ln(out, f"embeddings.{n}", H)
    return _volta.encoder_and_head(out, d)


def model(cfg_path: str, d: dict, weights: dict, device):
    from clg_vqa_tpu_torch.config import UC2Config
    from clg_vqa_tpu_torch.models.uc2 import UC2
    cfg = UC2Config(vocab_size=d["vocab"], hidden_size=d["H"], num_layers=d["layers"],
                    num_heads=d["heads"], intermediate_size=d["ffn"],
                    max_position_embeddings=d["max_pos"], layer_norm_eps=d["eps"],
                    v_feature_size=d["feat"], num_locs=d["locs"],
                    pooler_size=d["pooler"], clf_hidden_size=d["clf_hidden"],
                    num_labels=d["labels"])
    return program.holding(UC2(cfg, device=device, seed=0), weights)


forward_flops = _volta.forward_flops


def tiny(cfg: dict) -> dict:
    return dict(cfg)
