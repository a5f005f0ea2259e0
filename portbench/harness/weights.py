"""The weights and the semantic prior's distance matrix, made on the device
from the run's seed in a few large calls.

Weights follow the published initialisation (BERT's normal(0, 0.02) for
the embeddings, the pooler and the embeddings' Linears, zero biases,
LayerNorm scale 1 and bias 0, a zero padding row, xavier-uniform for the
classifier's two layers), except that the encoder blocks' Linear weights
are drawn at 2.5 times that scale, normal(0, 0.05). At 0.02 the pooled
vector hardly depends on the input (the first position is always the same
token, and near-uniform attention averages the rest away): 1 to 11
distinct answers among 256 questions (seeds 11-18, fp32, my CPU runs), so
no answer of a seed lies near a tie and a change of precision moves none.
At 0.05 attention is selective and answers spread as a trained model's do
(9 to 21 of 256). Weights are keyed by the port's checkpoint names, the
format a user loads; each family's ``layout`` (portbench/families/) lists
them with their init."""
from __future__ import annotations

import math

import torch

STD = 0.02
STD_ENCODER = 0.05


def make_weights(spec: list, d: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} of the family's layout ``spec``
    ([(name, shape, init)] in draw order; ``d``: the family's dims). Inits:
    normal (0.02), padded (normal with row ``d["pad"]`` zero), encoder
    (normal at 0.05, a block's Linear), xavier (uniform), zeros, ones. One
    standard normal draw serves every normal-initialised weight, scaled by
    leaf, and one uniform draw the xavier ones."""
    g = torch.Generator(device).manual_seed(seed)
    drawn = {"normal": ("normal", STD), "padded": ("normal", STD),
             "encoder": ("normal", STD_ENCODER), "xavier": ("uniform", None)}
    numel = {"normal": 0, "uniform": 0}
    for _, s, i in spec:
        if i in drawn:
            numel[drawn[i][0]] += math.prod(s)
    buf = {"normal": torch.empty(numel["normal"], device=device).normal_(generator=g),
           "uniform": torch.empty(numel["uniform"], device=device).uniform_(
               -1.0, 1.0, generator=g)}
    out, at = {}, {"normal": 0, "uniform": 0}
    for name, shape, init in spec:
        n = math.prod(shape)
        if init in drawn:
            kind, std = drawn[init]
            t = buf[kind][at[kind]:at[kind] + n].view(shape)
            at[kind] += n
            t = t * (std if std else math.sqrt(6.0 / sum(shape)))
            if init == "padded":
                t[d["pad"]] = 0.0
        else:
            t = (torch.ones if init == "ones" else torch.zeros)(shape, device=device)
        out[name] = t
    return out


def make_distance(n: int, seed: int, device) -> torch.Tensor:
    """The semantic prior's [n, n] label distances: symmetric, uniform in
    [0, 1), 0 on the diagonal (the recipe's are WordNet or embedding
    distances of the real answers, which a synthetic answer set has not)."""
    g = torch.Generator(device).manual_seed(seed)
    u = torch.rand(n, n, device=device, generator=g)
    D = torch.triu(u, 1)
    return D + D.t()
