"""Operations and bytes of the benchmark's models, from the configuration's
shapes alone."""
from __future__ import annotations

import os

from . import manifest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def forward_flops(d: dict) -> float:
    """Matrix and attention products of one sample's forward (2 FLOPs a
    multiply-add), as the family ``d["model"]`` counts them
    (portbench/families/). ``d``: the family's dims."""
    return manifest.family(ROOT, d["model"]).forward_flops(d)


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
