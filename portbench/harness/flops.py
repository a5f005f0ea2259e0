"""Operations and bytes of the benchmark's models, from the configuration's
shapes alone."""
from __future__ import annotations


def forward_flops(d: dict) -> float:
    """Matrix and attention products of one sample's forward (2 FLOPs a
    multiply-add): per layer the q, k, v, o and FFN products over S = text +
    regions positions and QK^T and PV; the region and location embeddings;
    the pooler and the classifier. ``d``: reference.model.dims."""
    S, H, I = d["text"] + d["regions"], d["H"], d["ffn"]
    layer = 2 * S * (4 * H * H + 2 * H * I) + 4 * S * S * H
    emb = 2 * d["regions"] * (d["feat"] + d["locs"]) * H
    head = 2 * (H * d["pooler"] + d["pooler"] * d["clf_hidden"]
                + d["clf_hidden"] * d["labels"])
    return d["layers"] * layer + emb + head


def train_flops(d: dict) -> float:
    """A training sample: 3 x the forward (the backward's two products for
    each forward one), no recompute."""
    return 3 * forward_flops(d)


def attention_core(B: int, S: int, H: int, hd: int, elem: int,
                   backward: bool) -> tuple[float, float]:
    """(bytes, FLOPs) of the attention core softmax(q k^T / sqrt(hd) + bias)
    v over [B, S, H * hd] operands of ``elem`` bytes with an fp32 [B, S] key
    bias. Forward: q, k, v and the bias read, the output written; QK^T and
    PV. Backward: q, k, v, the bias and dout read, dq, dk, dv and the bias
    gradient written; QK^T again (p is not an input), dV, dP, dQ and dK."""
    act = B * S * H * hd * elem
    if backward:
        return 7 * act + 2 * B * S * 4, 10 * B * H * S * S * hd
    return 4 * act + B * S * 4, 4 * B * H * S * S * hd
