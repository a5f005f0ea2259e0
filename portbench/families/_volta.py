"""What UC2 and M3P share: VOLTA's configuration keys and the post-LN BERT
encoder, pooler and GQA classifier that both put after their embeddings."""
from __future__ import annotations

LAYERS = 2          # a tiny configuration's blocks
TINY = {"hidden_size": 64, "v_hidden_size": 64, "intermediate_size": 256,
        "vocab_size": 1000, "num_labels": 1842, "max_seq_length": 12,
        "pooler_size": 64}


def lin(out: list, name: str, i: int, o: int, init: str = "normal") -> None:
    out.extend([(f"{name}.weight", (o, i), init), (f"{name}.bias", (o,), "zeros")])


def ln(out: list, name: str, n: int) -> None:
    out.extend([(f"{name}.weight", (n,), "ones"), (f"{name}.bias", (n,), "zeros")])


def encoder_and_head(out: list, d: dict) -> list:
    """``out`` (the embeddings' layout) followed by the blocks, the pooler
    and the classifier."""
    H = d["H"]
    for i in range(d["layers"]):
        p = f"encoder.{i}"
        for n in "qkvo":
            lin(out, f"{p}.attn.{n}", H, H, "encoder")
        ln(out, f"{p}.ln1", H)
        lin(out, f"{p}.ffn.w1", H, d["ffn"], "encoder")
        lin(out, f"{p}.ffn.w2", d["ffn"], H, "encoder")
        ln(out, f"{p}.ln2", H)
    lin(out, "pooler", H, d["pooler"])
    lin(out, "classifier.fc1", d["pooler"], d["clf_hidden"], "xavier")
    ln(out, "classifier.ln", d["clf_hidden"])
    lin(out, "classifier.fc2", d["clf_hidden"], d["labels"], "xavier")
    return out


def forward_flops(d: dict) -> float:
    """Matrix and attention products of one sample's forward (2 FLOPs a
    multiply-add): per layer the q, k, v, o and FFN products over S = text +
    regions positions and QK^T and PV; the region and location embeddings;
    the pooler and the classifier."""
    S, H, I = d["text"] + d["regions"], d["H"], d["ffn"]
    layer = 2 * S * (4 * H * H + 2 * H * I) + 4 * S * S * H
    emb = 2 * d["regions"] * (d["feat"] + d["locs"]) * H
    head = 2 * (H * d["pooler"] + d["pooler"] * d["clf_hidden"]
                + d["clf_hidden"] * d["labels"])
    return d["layers"] * layer + emb + head
