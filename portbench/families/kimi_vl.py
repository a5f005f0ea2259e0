"""Kimi-VL-A3B (moonshotai/Kimi-VL-A3B-Instruct, 2025): its language
decoder, multi-head latent attention and a sigmoid-routed mixture of
experts, as a GQA classifier over region features, on one rank of an
expert-parallel layer (the port's ``models/kimi_vl.KimiVL``)."""
from __future__ import annotations

from portbench.harness import program
from portbench.reference import kimi_vl as reference

dims = reference.dims
TINY_LAYERS = 3         # a tiny configuration's: one dense, two expert layers


def _w(out: list, name: str, o: int, i: int, init: str = "encoder") -> None:
    out.append((f"{name}.weight", (o, i), init))


def _lin(out: list, name: str, i: int, o: int, init: str = "normal") -> None:
    out.extend([(f"{name}.weight", (o, i), init), (f"{name}.bias", (o,), "zeros")])


def _ln(out: list, name: str, n: int) -> None:
    out.extend([(f"{name}.weight", (n,), "ones"), (f"{name}.bias", (n,), "zeros")])


def layout(d: dict) -> list:
    """The port's parameters: the embeddings and the region projector, each
    block's norms, MLA and FFN (every decoder Linear bias-free, drawn at
    the encoder scale; the router at 0.02), the final norm and the GQA
    classifier."""
    H, h = d["H"], d["heads"]
    out = [("embeddings.word", (d["vocab"], H), "normal")]
    _ln(out, "embeddings.proj_ln", d["feat"])
    _lin(out, "embeddings.proj1", d["feat"], d["proj"])
    _lin(out, "embeddings.proj2", d["proj"], H)
    _lin(out, "embeddings.loc", d["locs"], H)
    for i in range(d["layers"]):
        p = f"layers.{i}"
        out.append((f"{p}.ln_attn.weight", (H,), "ones"))
        _w(out, f"{p}.attn.q", h * (d["nope"] + d["rope"]), H)
        _w(out, f"{p}.attn.kva", d["kv_rank"] + d["rope"], H)
        out.append((f"{p}.attn.kv_ln.weight", (d["kv_rank"],), "ones"))
        _w(out, f"{p}.attn.kvb", h * (d["nope"] + d["vdim"]), d["kv_rank"])
        _w(out, f"{p}.attn.o", H, h * d["vdim"])
        out.append((f"{p}.ln_ffn.weight", (H,), "ones"))
        if i < d["dense"]:
            for n in ("gate", "up"):
                _w(out, f"{p}.ffn.{n}", d["ffn"], H)
            _w(out, f"{p}.ffn.down", H, d["ffn"])
        else:
            I, S = d["moe_ffn"], d["shared"] * d["moe_ffn"]
            _w(out, f"{p}.ffn.router", d["router"], H, "normal")
            out.append((f"{p}.ffn.experts.w1", (d["held"], 2 * I, H), "encoder"))
            out.append((f"{p}.ffn.experts.w2", (d["held"], H, I), "encoder"))
            for n in ("gate", "up"):
                _w(out, f"{p}.ffn.shared.{n}", S, H)
            _w(out, f"{p}.ffn.shared.down", H, S)
    out.append(("ln_f.weight", (H,), "ones"))
    _lin(out, "classifier.fc1", H, d["clf_hidden"], "xavier")
    _ln(out, "classifier.ln", d["clf_hidden"])
    _lin(out, "classifier.fc2", d["clf_hidden"], d["labels"], "xavier")
    return out


def model(cfg_path: str, d: dict, weights: dict, device):
    from clg_vqa_tpu_torch.config import KimiVLConfig
    from clg_vqa_tpu_torch.models.kimi_vl import KimiVL
    m = KimiVL(KimiVLConfig.from_json(cfg_path, num_labels=d["labels"]),
               device=device, seed=0)
    return program.holding(m, weights)


def held_picks(d: dict) -> float:
    """The (token, expert) pairs a token brings to the experts held here, on
    average: k x held / router (0.75 at 6 of 64 with 8 held)."""
    return d["topk"] * d["held"] / d["router"]


def forward_flops(d: dict) -> float:
    """This rank's matrix and attention products of one sample's forward (2
    FLOPs a multiply-add): per layer over S = text + regions positions the
    MLA projections, QK^T and PV over every key pair, and the dense FFN or
    the router, the shared experts and the routed experts at
    :func:`held_picks` pairs a token; the region projector; the
    classifier."""
    S, H, h = d["text"] + d["regions"], d["H"], d["heads"]
    qk, vd = d["nope"] + d["rope"], d["vdim"]
    proj = 2 * S * (H * h * qk + H * (d["kv_rank"] + d["rope"])
                    + d["kv_rank"] * h * (d["nope"] + vd) + h * vd * H)
    core = 2 * S * S * h * (qk + vd)
    dense = 6 * S * H * d["ffn"]
    expert = 6 * H * d["moe_ffn"]
    moe = S * (2 * H * d["router"] + d["shared"] * expert + held_picks(d) * expert)
    layers = d["layers"] * (proj + core) + d["dense"] * dense + (
        d["layers"] - d["dense"]) * moe
    emb = 2 * d["regions"] * (d["feat"] * d["proj"] + d["proj"] * H + d["locs"] * H)
    head = 2 * (H * d["clf_hidden"] + d["clf_hidden"] * d["labels"])
    return layers + emb + head


def grouped_products(d: dict, pairs: int) -> list[tuple[float, float]]:
    """(bytes, FLOPs) of each grouped expert product of one expert layer and
    microbatch over ``pairs`` (token, held expert) rows, bf16 operands:
    forward gate|up with SwiGLU (x read; gate, up and act written) and down;
    backward dact with the SwiGLU gradient (dY and gate|up read, dgate|dup
    written), dX, and the fp32 weight gradients of down and of gate|up.
    Each reads its experts' weights once."""
    H, I, E = d["H"], d["moe_ffn"], d["held"]
    n = float(pairs)
    w1, w2 = 2 * E * 2 * I * H, 2 * E * H * I
    return [
        (2 * n * H + w1 + 2 * n * 3 * I, 2 * n * H * 2 * I),        # gate|up, SwiGLU
        (2 * n * I + w2 + 2 * n * H, 2 * n * I * H),                # down
        (2 * n * H + w2 + 2 * n * 2 * I * 2, 2 * n * H * I),        # dact, dSwiGLU
        (2 * n * (H + I) + 4 * E * H * I, 2 * n * H * I),           # dW2
        (2 * n * 2 * I + w1 + 2 * n * H, 2 * n * 2 * I * H),        # dX
        (2 * n * (2 * I + H) + 4 * E * 2 * I * H, 2 * n * 2 * I * H),  # dW1
    ]


def tiny(cfg: dict) -> dict:
    """Two heads of 16 + 8, a latent of 32, width 64, experts of 128 rows:
    four of eight router experts held, top-3, one dense and two expert
    layers."""
    return dict(cfg, hidden_size=64, num_attention_heads=2, kv_lora_rank=32,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                intermediate_size=96, moe_intermediate_size=128,
                n_shared_experts=1, router_experts=8, n_routed_experts=4,
                first_held_expert=2, num_experts_per_tok=3,
                num_hidden_layers=TINY_LAYERS, vocab_size=1000,
                projector_hidden_size=64, clf_hidden_size=128, max_seq_length=12,
                max_region_num=6)
