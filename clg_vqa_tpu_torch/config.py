"""Typed configurations (own copy of clg_vqa_tpu/config.py:30-285): the UC2
and M3P models, the GQA task and the fine-tuning optimizer; and the port's
own Kimi-VL-A3B decoder (:class:`KimiVLConfig`), which the JAX package has
not.

The UC2 VOLTA JSON config (volta/config/uc2_base.json) describes 24 gated
sublayers; CLG-VQA only uses the wiring in which they collapse to a
12-block joint-sequence post-LN transformer, and ``from_json`` rejects any
other wiring. M3P (volta/config/m3p_base.json) is a flat XLM-style
transformer.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class UC2Config:
    """UC2 encoder config (collapsed joint-sequence transformer).

    Field semantics follow volta/config/uc2_base.json and
    volta/volta/config.py:218-413."""

    vocab_size: int = 250002
    hidden_size: int = 768
    num_layers: int = 12            # 24 interleaved sublayers -> 12 attn+ff blocks
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 2
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    # vision side
    v_feature_size: int = 2048
    num_locs: int = 7
    add_global_imgfeat: str | None = None
    # head
    pooler_size: int = 768
    clf_hidden_size: int = 768
    fusion_method: str = "text"
    fusion_act: str = "relu"        # pooler activation: relu|tanh (encoders.py:602)
    # task
    num_labels: int = 1842
    clf_dropout_prob: float = 0.1   # BertForVLTasks dropout (encoders.py:1158)

    @classmethod
    def from_json(cls, path: str, num_labels: int = 1842) -> "UC2Config":
        """Ingest a VOLTA-style model JSON (e.g. uc2_base.json), validating
        that the sublayer wiring collapses to the joint transformer."""
        with open(path) as f:
            d = json.load(f)
        _validate_collapsed_wiring(d)
        n_sub = len(d["tt_attn_sublayers"]) + len(d["t_ff_sublayers"])
        return cls(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            num_layers=n_sub // 2,
            num_heads=d["num_attention_heads"],
            intermediate_size=d["intermediate_size"],
            max_position_embeddings=d["max_position_embeddings"],
            type_vocab_size=d["type_vocab_size"],
            pad_token_id=d["pad_token_id"],
            layer_norm_eps=d["layer_norm_eps"],
            hidden_dropout_prob=d["hidden_dropout_prob"],
            attention_probs_dropout_prob=d["attention_probs_dropout_prob"],
            initializer_range=d["initializer_range"],
            v_feature_size=d["v_feature_size"],
            num_locs=d["num_locs"],
            add_global_imgfeat=d.get("add_global_imgfeat"),
            pooler_size=d["pooler_size"],
            clf_hidden_size=d["clf_hidden_size"],
            fusion_method=d["fusion_method"],
            fusion_act=d.get("fusion_act", "relu"),
            num_labels=num_labels,
        )


def _validate_collapsed_wiring(d: Mapping[str, Any]) -> None:
    """Reject a VOLTA JSON config that is not the all-shared single-LN joint
    pattern of uc2_base.json: attn sublayers = evens, ff = odds, everything
    shared, single-LN everywhere, no per-sublayer size overrides."""
    attn = d["tt_attn_sublayers"]
    ff = d["t_ff_sublayers"]
    n = len(attn) + len(ff)
    evens, odds = list(range(0, n, 2)), list(range(1, n, 2))
    checks = {
        "tt_attn_sublayers": evens,
        "tv_attn_sublayers": evens,
        "vt_attn_sublayers": evens,
        "vv_attn_sublayers": evens,
        "t_ff_sublayers": odds,
        "v_ff_sublayers": odds,
        "shared_sublayers": list(range(n)),
        "single_ln_sublayers": list(range(n)),
    }
    for key, want in checks.items():
        if sorted(d[key]) != want:
            raise ValueError(
                f"Config does not collapse to a joint-sequence transformer: "
                f"{key}={d[key]} (expected {want}). Only the UC2 wiring of "
                f"uc2_base.json is supported.")
    for key in (
        "sublayer2attn_hidden_size", "sublayer2num_attention_heads",
        "sublayer2intermediate_size", "sublayer2v_attn_hidden_size",
        "sublayer2v_num_attention_heads", "sublayer2v_intermediate_size",
    ):
        if d.get(key):
            raise ValueError(f"Per-sublayer size overrides unsupported: {key}={d[key]}")
    if d["hidden_size"] != d["v_hidden_size"]:
        raise ValueError("hidden_size != v_hidden_size cannot collapse")


@dataclasses.dataclass(frozen=True)
class M3PConfig:
    """M3P flat XLM-style transformer config (volta/config/m3p_base.json,
    volta/volta/config.py:416-609, m3p_transformer.py:609-750)."""

    vocab_size: int = 250002
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072     # hidden_dim = 4*dim (m3p_transformer.py:640)
    max_position_embeddings: int = 514
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-12     # hardcoded in m3p_transformer.py (LN eps)
    dropout: float = 0.1
    attention_dropout: float = 0.1
    gelu_activation: bool = True
    # vision
    v_feature_size: int = 2048
    num_locs: int = 5
    max_boxes: int = 100
    norm_embeddings: bool = True
    # head
    pooler_size: int = 768
    clf_hidden_size: int = 1536
    num_labels: int = 1842
    clf_dropout_prob: float = 0.1

    @classmethod
    def from_json(cls, path: str, num_labels: int = 1842) -> "M3PConfig":
        """Ingest an M3P-style VOLTA JSON. A key the file lacks takes the
        reference's default (norm_embeddings False, volta/config.py:284),
        while the dataclass default is the shipped m3p_base.json's True.
        The reference hardcodes the FFN width to 4*hidden
        (m3p_transformer.py:640), so a file that says otherwise raises."""
        with open(path) as f:
            d = json.load(f)
        inter = d.get("intermediate_size", 4 * d["hidden_size"])
        if inter != 4 * d["hidden_size"]:
            raise ValueError(
                f"M3P FFN width is hardcoded to 4*hidden in the reference "
                f"(m3p_transformer.py:640); config says {inter} != "
                f"{4 * d['hidden_size']}")
        return cls(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            num_layers=d.get("n_layers", 12),
            num_heads=d.get("n_heads", 12),
            intermediate_size=inter,
            max_position_embeddings=d["max_position_embeddings"],
            pad_token_id=d["pad_token_id"],
            dropout=d.get("hidden_dropout_prob", 0.1),
            attention_dropout=d.get("attention_probs_dropout_prob", 0.1),
            v_feature_size=d["v_feature_size"],
            num_locs=d["num_locs"],
            max_boxes=d.get("max_boxes", 100),
            norm_embeddings=d.get("norm_embeddings", False),
            pooler_size=d["pooler_size"],
            clf_hidden_size=d["clf_hidden_size"],
            num_labels=num_labels,
        )


@dataclasses.dataclass(frozen=True)
class KimiVLConfig:
    """Kimi-VL-A3B's language decoder (moonshotai/Kimi-VL-A3B-Instruct,
    config.json's ``text_config``: a DeepSeek-V3-style decoder) as a GQA
    classifier over [regions; question] (models/kimi_vl.py).

    ``num_layers`` counts the layers held here, ``first_dense`` of them
    dense. Each MoE layer routes over ``router_experts`` and holds the
    ``held_experts`` experts ``first_expert`` .. ``first_expert +
    held_experts - 1``: one rank of an expert-parallel layer, which
    computes its own experts' part of the layer's output."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    num_layers: int = 27
    first_dense: int = 1
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 11264          # the dense layers' FFN
    moe_intermediate_size: int = 1408       # one expert's width
    n_shared_experts: int = 2
    router_experts: int = 64
    held_experts: int = 64
    first_expert: int = 0
    experts_per_token: int = 6
    routed_scaling_factor: float = 2.446
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    pad_token_id: int = 1
    # vision side: region features through the projector's form
    v_feature_size: int = 2048
    num_locs: int = 5
    projector_hidden_size: int = 2048
    layer_norm_eps: float = 1e-5            # the projector's and the head's LN
    # head
    clf_hidden_size: int = 4096
    num_labels: int = 1842
    clf_dropout_prob: float = 0.1

    @classmethod
    def from_json(cls, path: str, num_labels: int | None = None) -> "KimiVLConfig":
        """A configuration file in the published config.json's keys
        (``n_routed_experts`` the experts held here, ``router_experts`` the
        router's width, ``first_held_expert`` the first held) plus the
        task's. A key the decoder would need and the port does not
        implement (q LoRA, grouped top-k, a RoPE scaling, biases, a scoring
        function other than sigmoid) raises."""
        with open(path) as f:
            d = json.load(f)
        unsupported = {"q_lora_rank": None, "rope_scaling": None,
                       "attention_bias": False, "scoring_func": "sigmoid",
                       "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
                       "moe_layer_freq": 1, "hidden_act": "silu",
                       "norm_topk_prob": True}
        for k, want in unsupported.items():
            if k in d and d[k] != want:
                raise ValueError(f"Kimi-VL config: {k}={d[k]!r} is not "
                                 f"supported (the port implements {want!r})")
        routed = d.get("router_experts", d["n_routed_experts"])
        return cls(
            vocab_size=d["vocab_size"], hidden_size=d["hidden_size"],
            num_layers=d["num_hidden_layers"],
            first_dense=d["first_k_dense_replace"],
            num_heads=d["num_attention_heads"], kv_lora_rank=d["kv_lora_rank"],
            qk_nope_head_dim=d["qk_nope_head_dim"],
            qk_rope_head_dim=d["qk_rope_head_dim"], v_head_dim=d["v_head_dim"],
            intermediate_size=d["intermediate_size"],
            moe_intermediate_size=d["moe_intermediate_size"],
            n_shared_experts=d["n_shared_experts"], router_experts=routed,
            held_experts=d["n_routed_experts"],
            first_expert=d.get("first_held_expert", 0),
            experts_per_token=d["num_experts_per_tok"],
            routed_scaling_factor=d["routed_scaling_factor"],
            rms_norm_eps=d["rms_norm_eps"], rope_theta=float(d["rope_theta"]),
            pad_token_id=d.get("pad_token_id", 1),
            v_feature_size=d.get("v_feature_size", 2048),
            num_locs=d.get("num_locs", 5),
            projector_hidden_size=d.get("projector_hidden_size", d["hidden_size"]),
            layer_norm_eps=d.get("layer_norm_eps", d["rms_norm_eps"]),
            clf_hidden_size=d.get("clf_hidden_size", 2 * d["hidden_size"]),
            num_labels=d.get("num_labels", 1842) if num_labels is None else num_labels,
            clf_dropout_prob=d.get("clf_dropout_prob", 0.1))


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """GQA/xGQA task config (own copy of clg_vqa_tpu/config.py:203-263;
    volta/config_tasks/iglue_*_tasks_*.dtu.yml TASK15)."""

    name: str = "GQA"
    task_type: str = "VL-classifier-GQA"
    num_labels: int = 1842
    loss: str = "CrossEntropyLoss"
    dataroot: str = ""
    features_path_train: str = ""
    features_path_val: str = ""
    annotations_jsonpath: str = ""
    max_seq_length: int = 40
    max_region_num: int = 36
    batch_size: int = 256
    eval_batch_size: int = 1024
    train_split: str = "train"
    val_split: str = "val"
    lr: float = 4e-5
    num_epoch: int = 5
    # paper knobs
    semantic_lambda: float = 10.0
    semantic_top_k: int = 10
    semantic_dict_path: str = ""
    code_mixing: bool = False
    ratio: float = 1.0        # sentence-level replacement prob
    cross: float = 0.9        # token-level replacement prob
    dictionary_path: str = ""
    # classifier init from answer word embeddings (train_task.py:218-238)
    embed_clf: bool = False

    @classmethod
    def from_yaml(cls, path: str, task_id: str = "15") -> "TaskConfig":
        """The ``TASK{task_id}`` entry of a task YAML. PyYAML is imported
        here only, so the package imports where it is not installed."""
        import yaml
        with open(path) as f:
            raw = yaml.safe_load(f)["TASK" + task_id]
        return cls(
            name=raw.get("name", "GQA"),
            task_type=raw.get("type", "VL-classifier-GQA"),
            num_labels=raw.get("num_labels", 1842),
            loss=raw.get("loss", "CrossEntropyLoss"),
            dataroot=raw.get("dataroot", ""),
            features_path_train=raw.get("features_h5path1", ""),
            features_path_val=raw.get("features_h5path2", ""),
            annotations_jsonpath=raw.get("train_annotations_jsonpath", "") or "",
            max_seq_length=raw.get("max_seq_length", 40),
            max_region_num=raw.get("max_region_num", 36),
            batch_size=raw.get("batch_size", 256),
            eval_batch_size=raw.get("eval_batch_size", 1024),
            train_split=raw.get("train_split", "train"),
            val_split=raw.get("val_split", "val"),
            lr=float(raw.get("lr", 4e-5)),
            num_epoch=raw.get("num_epoch", 5),
            semantic_lambda=float(raw.get("semantic_lambda", 10.0)),
            semantic_dict_path=raw.get("semantic_dict_path", "") or "",
            code_mixing=bool(raw.get("code_mixing", False)),
            ratio=float(raw.get("ratio", 1.0)),
            cross=float(raw.get("cross", 0.9)),
            dictionary_path=raw.get("dictionary_path", "") or "",
            embed_clf=bool(raw.get("embed_clf", False)),
        )


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Fine-tuning optimizer envelope (own copy of clg_vqa_tpu/config.py:266-285;
    experiments/zero_shot/uc2/xgqa/train.dtu.sh, volta/train_task.py:249-276)."""

    lr: float = 4e-5
    adam_betas: tuple[float, float] = (0.9, 0.999)
    adam_epsilon: float = 1e-6
    correct_bias: bool = True
    weight_decay: float = 1e-4
    clip_grad_norm: float = 1.0
    warmup_proportion: float = 0.1
    grad_acc_steps: int = 4
    lr_scheduler: str = "warmup_linear"
    # schedule HORIZON in epochs, independent of num_epoch: the reference
    # sizes WarmupLinearSchedule by --optim_train_epochs (default 20,
    # train_task.py:86,271-274) while training num_epoch (5), so warmup
    # spans 2 epochs and the final lr is ~0.83x base
    optim_train_epochs: int = 20
