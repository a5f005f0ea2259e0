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
format a user loads."""
from __future__ import annotations

import math

import torch

STD = 0.02
STD_ENCODER = 0.05


def layout(d: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, init) of every weight of the model ``d`` describes
    (reference.model.dims); init is normal, encoder (a block's Linear),
    zeros, ones or xavier."""
    H, F, L = d["H"], d["feat"], d["locs"]
    out = [("embeddings.word", (d["vocab"], H), "normal"),
           ("embeddings.position", (d["max_pos"], H), "normal")]

    def lin(name, i, o, init="normal"):
        out.extend([(f"{name}.weight", (o, i), init), (f"{name}.bias", (o,), "zeros")])

    def ln(name, n=H):
        out.extend([(f"{name}.weight", (n,), "ones"), (f"{name}.bias", (n,), "zeros")])

    if d["m3p"]:
        ln("embeddings.ln")
        lin("embeddings.image", F, H)
        lin("embeddings.loc", L, H)
        ln("embeddings.img_ln")
    else:
        out.append(("embeddings.token_type", (d["type_vocab"], H), "normal"))
        ln("embeddings.ln")
        lin("embeddings.image", F, H)
        lin("embeddings.loc", L, H)
        for n in ("image_ln", "loc_ln", "v_ln"):
            ln(f"embeddings.{n}")
    for i in range(d["layers"]):
        p = f"encoder.{i}"
        for n in "qkvo":
            lin(f"{p}.attn.{n}", H, H, "encoder")
        ln(f"{p}.ln1")
        lin(f"{p}.ffn.w1", H, d["ffn"], "encoder")
        lin(f"{p}.ffn.w2", d["ffn"], H, "encoder")
        ln(f"{p}.ln2")
    lin("pooler", H, d["pooler"])
    lin("classifier.fc1", d["pooler"], d["clf_hidden"], "xavier")
    ln("classifier.ln", d["clf_hidden"])
    lin("classifier.fc2", d["clf_hidden"], d["labels"], "xavier")
    return out


def make_weights(d: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``}: one standard normal draw for
    every normal-initialised weight, scaled by leaf, and one uniform draw
    for the xavier ones."""
    spec = layout(d)
    g = torch.Generator(device).manual_seed(seed)
    drawn = {"normal": ("normal", STD), "encoder": ("normal", STD_ENCODER),
             "xavier": ("uniform", None)}
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
        else:
            t = (torch.ones if init == "ones" else torch.zeros)(shape, device=device)
        out[name] = t
    out["embeddings.word"][d["pad"]] = 0.0
    return out


def make_distance(n: int, seed: int, device) -> torch.Tensor:
    """The semantic prior's [n, n] label distances: symmetric, uniform in
    [0, 1), 0 on the diagonal (the recipe's are WordNet or embedding
    distances of the real answers, which a synthetic answer set has not)."""
    g = torch.Generator(device).manual_seed(seed)
    u = torch.rand(n, n, device=device, generator=g)
    D = torch.triu(u, 1)
    return D + D.t()
