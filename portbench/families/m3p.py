"""M3P (Ni et al., CVPR 2021; VOLTA's m3p_base.json): the same widths as
UC2 over [regions; text], prefix validity and -inf keys, the port's
``models/m3p.M3P``."""
from __future__ import annotations

from portbench.families import _volta
from portbench.harness import program
from portbench.reference import model as reference

dims = reference.m3p_dims
forward_flops = _volta.forward_flops


def layout(d: dict) -> list:
    H = d["H"]
    out = [("embeddings.word", (d["vocab"], H), "padded"),
           ("embeddings.position", (d["max_pos"], H), "normal")]
    _volta.ln(out, "embeddings.ln", H)
    _volta.lin(out, "embeddings.image", d["feat"], H)
    _volta.lin(out, "embeddings.loc", d["locs"], H)
    _volta.ln(out, "embeddings.img_ln", H)
    return _volta.encoder_and_head(out, d)


def model(cfg_path: str, d: dict, weights: dict, device):
    from clg_vqa_tpu_torch.config import M3PConfig
    from clg_vqa_tpu_torch.models.m3p import M3P
    m = M3P(M3PConfig.from_json(cfg_path, num_labels=d["labels"]), device=device,
            seed=0)
    return program.holding(m, weights)


def tiny(cfg: dict) -> dict:
    return dict(cfg, **_volta.TINY, n_heads=2, n_layers=_volta.LAYERS,
                max_region_num=16, clf_hidden_size=128)
