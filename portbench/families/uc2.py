"""UC2 (Zhou et al., CVPR 2021; VOLTA's uc2_base.json): XLM-R base as a
post-LN transformer over [text; regions], the port's ``models/uc2.UC2``."""
from __future__ import annotations

from portbench.families import _volta
from portbench.harness import program
from portbench.reference import model as reference

dims = reference.uc2_dims
forward_flops = _volta.forward_flops


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
    m = UC2(UC2Config.from_json(cfg_path, num_labels=d["labels"]), device=device,
            seed=0)
    return program.holding(m, weights)


def tiny(cfg: dict) -> dict:
    c = dict(cfg, **_volta.TINY, num_attention_heads=2, max_region_num=6,
             clf_hidden_size=64)
    n = _volta.LAYERS
    for k in ("tt_attn_sublayers", "tv_attn_sublayers", "vt_attn_sublayers",
              "vv_attn_sublayers"):
        c[k] = list(range(0, 2 * n, 2))
    for k in ("t_ff_sublayers", "v_ff_sublayers"):
        c[k] = list(range(1, 2 * n, 2))
    for k in ("shared_sublayers", "single_ln_sublayers"):
        c[k] = list(range(2 * n))
    return c
