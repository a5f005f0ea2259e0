"""Shared CLI construction (port of clg_vqa_tpu/cli/common.py): config
ingest (JSON model config + YAML task config + flag overrides, the
reference's three-tier scheme), and model, dataset and feature-bank
assembly on the ``--device``. ``--is_m3p`` reads the config as M3P's
(M3PConfig.from_json) and builds an M3P; a config whose
``image_embeddings`` is one of the gated zoo's (ViLBERT, LXMERT, VL-BERT,
VisualBERT, UNITER) builds the general gated encoder (models/gated.py);
any other builds a UC2.

Not ported yet, and raising NotImplementedError naming their ROADMAP.md
slice: LMDB or QA-joined td-lmdb feature stores (slice 11); the port reads
CFS stores.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from ..config import M3PConfig, OptimConfig, TaskConfig, UC2Config
from ..models.gated import DUAL_EMBEDDINGS, SHARED_EMBEDDINGS, GatedConfig


def add_common_args(p: argparse.ArgumentParser):
    p.add_argument("--config_file", required=True,
                   help="model JSON (uc2_base.json layout)")
    p.add_argument("--tasks_config_file", required=True,
                   help="task YAML (TASK15 layout)")
    p.add_argument("--task", default="15")
    p.add_argument("--is_m3p", action="store_true")
    p.add_argument("--from_pretrained", default="",
                   help="VOLTA or HF XLM-R torch .bin, or a params dir "
                        "written by this package; empty = random init")
    p.add_argument("--output_dir", default="out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tokenizer", default="hash",
                   help="'hash' or a local HF tokenizer path "
                        "(xlm-roberta-base for production parity)")
    p.add_argument("--features_path", default="",
                   help="override the task config's feature store path "
                        "(.cfs)")
    p.add_argument("--dataroot", default="", help="override dataroot")
    p.add_argument("--train_annotations_jsonpath", default="",
                   help="explicit annotations for train_* / dev_* few-shot "
                        "splits (xGQA)")
    p.add_argument("--val_annotations_jsonpath", default="")
    p.add_argument("--fp32", action="store_true",
                   help="disable bf16 compute (parity mode)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on ('cuda' or 'cpu')")
    return p


def add_train_args(p: argparse.ArgumentParser):
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--num_epoch", type=int, default=None)
    p.add_argument("--grad_acc_steps", type=int, default=4)
    p.add_argument("--warmup_proportion", type=float, default=0.1)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--clip_grad_norm", type=float, default=1.0)
    p.add_argument("--adam_epsilon", type=float, default=1e-6)
    p.add_argument("--adam_betas", type=float, nargs=2, default=(0.9, 0.999))
    # reference parity: default False, the launch scripts pass the flag
    # (train_task.py:131, experiments/.../train.dtu.sh)
    p.add_argument("--adam_correct_bias", action="store_true", default=False)
    p.add_argument("--optim_train_epochs", type=int, default=20,
                   help="lr-schedule horizon in epochs (reference "
                        "train_task.py:86 — decoupled from --num_epoch)")
    p.add_argument("--lr_scheduler", type=str, default="warmup_linear")
    p.add_argument("--code_mixing", action="store_true", default=None)
    p.add_argument("--embed_clf", action="store_true", default=None,
                   help="initialize the classifier output from answer word "
                        "embeddings (train_task.py:218-238)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--save_every", type=int, default=1,
                   help="resume checkpoint cadence in epochs (final epoch "
                        "always saved; 1 = reference parity)")
    p.add_argument("--mid_save", choices=("none", "params"), default="none",
                   help="cheap resume points for epochs --save_every skips: "
                        "'params' saves params+step only (resume restarts "
                        "optimizer moments)")
    p.add_argument("--fused_attn",
                   choices=("auto", "on", "off", "flat", "proj", "sm"),
                   default="auto",
                   help="training attention: 'auto' = the flat kernel for "
                        "bf16 on CUDA, 'on' = the flat kernel, 'off' = plain "
                        "PyTorch, 'flat'/'sm' force the flat or the S-major "
                        "kernel, 'proj' the whole-block kernel (projections "
                        "inside)")
    p.add_argument("--no_train_bank", action="store_true",
                   help="stream features host->device per batch instead of "
                        "keeping the train store on the device")
    p.add_argument("--loss", default="",
                   help="override the task criterion (LossMap name, "
                        "task_utils.py:179-192); empty = task YAML default")
    return p


def build_configs(args):
    """(model config, task config, optimizer config) from the files and the
    flags."""
    task_cfg = TaskConfig.from_yaml(args.tasks_config_file, args.task)
    overrides = {}
    if getattr(args, "lr", None):
        overrides["lr"] = args.lr
    if getattr(args, "num_epoch", None):
        overrides["num_epoch"] = args.num_epoch
    if getattr(args, "code_mixing", None) is not None:
        overrides["code_mixing"] = args.code_mixing
    if getattr(args, "embed_clf", None) is not None:
        overrides["embed_clf"] = args.embed_clf
    if getattr(args, "loss", ""):
        # reference precedence: args.loss or task_cfg[task]["loss"]
        # (task_utils.py:181)
        overrides["loss"] = args.loss
    if getattr(args, "dataroot", ""):
        overrides["dataroot"] = args.dataroot
    if overrides:
        task_cfg = dataclasses.replace(task_cfg, **overrides)

    if args.is_m3p:
        cfg = M3PConfig.from_json(args.config_file,
                                  num_labels=task_cfg.num_labels)
    else:
        with open(args.config_file) as f:
            raw = json.load(f)
        if raw.get("image_embeddings", "uc2") in (
                DUAL_EMBEDDINGS + SHARED_EMBEDDINGS):
            # the general gated wiring (models/gated.py), as
            # clg_vqa_tpu/cli/common.py:113-124 routes these configs
            cfg = GatedConfig.from_dict(
                {**raw, "num_labels": task_cfg.num_labels})
        else:
            cfg = UC2Config.from_json(args.config_file,
                                      num_labels=task_cfg.num_labels)

    optim_cfg = OptimConfig(
        lr=task_cfg.lr,
        adam_betas=tuple(getattr(args, "adam_betas", (0.9, 0.999))),
        adam_epsilon=getattr(args, "adam_epsilon", 1e-6),
        correct_bias=getattr(args, "adam_correct_bias", True),
        weight_decay=getattr(args, "weight_decay", 1e-4),
        clip_grad_norm=getattr(args, "clip_grad_norm", 1.0),
        warmup_proportion=getattr(args, "warmup_proportion", 0.1),
        grad_acc_steps=getattr(args, "grad_acc_steps", 4),
        lr_scheduler=getattr(args, "lr_scheduler", "warmup_linear"),
        optim_train_epochs=getattr(args, "optim_train_epochs", 20),
    )
    return cfg, task_cfg, optim_cfg


def model_name(cfg) -> str:
    """"m3p" for an M3P config, "gated" for a gated-zoo one, else "uc2"
    (the FinetuneRunner's and the ``.bin`` export's name)."""
    if isinstance(cfg, GatedConfig):
        return "gated"
    return "m3p" if isinstance(cfg, M3PConfig) else "uc2"


def build_model(args, cfg):
    """A UC2, an M3P or a Gated (by the config) on ``args.device``: random
    from ``args.seed``, then the ``--from_pretrained`` weights when given (a
    checkpoint without a classifier keeps the fresh one)."""
    from ..utils.convert import load_numpy_state, model_class
    model = model_class(cfg)(cfg, device=args.device, seed=args.seed)
    if args.from_pretrained:
        sd = load_pretrained(args.from_pretrained, cfg)
        load_numpy_state(model, sd, allow_missing=("classifier.",))
    return model


def load_pretrained(path: str, cfg) -> dict[str, np.ndarray]:
    """Port state-dict names -> arrays from a params dir written by
    train/checkpoints.save_params or a torch ``.bin``. For UC2 the ``.bin``
    holds VOLTA names or is a raw HF XLM-R checkpoint (detected by its
    ``.attention.self.`` keys and renumbered through the UC2 sublayer
    collapse like conversions/convert_uc2.py); for M3P it holds VOLTA names
    or is an original microsoft/M3P checkpoint (detected by its
    ``module.attentions.`` keys); for a gated config it holds VOLTA
    BertForVLTasks names (utils/convert_gated.py), as
    clg_vqa_tpu/cli/common.py:158-182 reads them."""
    from ..utils.convert import (hf_xlmr_to_uc2_state_dict,
                                 m3p_original_to_state_dict,
                                 normalize_volta_keys, volta_m3p_to_state_dict,
                                 volta_uc2_to_state_dict)
    from ..utils.convert_gated import volta_gated_to_state_dict
    if os.path.isdir(path):
        from ..train import checkpoints as ckpt
        sd = ckpt.load_params(os.path.dirname(path) or ".",
                              os.path.basename(path))
        return {k: v.numpy() for k, v in sd.items()}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v.float().numpy() for k, v in sd.items()}
    if isinstance(cfg, GatedConfig):
        return volta_gated_to_state_dict(normalize_volta_keys(sd), cfg)
    if isinstance(cfg, M3PConfig):
        if any(k.startswith("module.attentions.") for k in sd):
            return m3p_original_to_state_dict(sd, cfg)
        return volta_m3p_to_state_dict(normalize_volta_keys(sd), cfg)
    if any(".attention.self." in k for k in sd):
        return hf_xlmr_to_uc2_state_dict(sd, cfg)
    return volta_uc2_to_state_dict(normalize_volta_keys(sd), cfg)


def build_tokenizer(args, cfg):
    """The HF tokenizer at ``--tokenizer``, or the hash tokenizer over the
    model's vocabulary. (The JAX CLI's hash tokenizer always spans 250002
    ids and XLA clamps the ones past a smaller table; on the card such an
    index would fault, so here the hash range is the model's.)"""
    from ..data.tokenizer import HashTokenizer, HFTokenizer
    if args.tokenizer == "hash":
        return HashTokenizer(cfg.vocab_size)
    return HFTokenizer(args.tokenizer)


def open_feature_store(path: str, feat_dim: int = 2048):
    """A CFS store (``.cfs``), else a per-image feature LMDB
    (data/features.LmdbFeatureReader) whose records hold ``feat_dim``-wide
    features, as clg_vqa_tpu/cli/common.py:192-197 (which reads 2048 always).
    A QA-joined td-lmdb is ingested into a CFS store first
    (:func:`ingest_tdlmdb`)."""
    from ..data.cfs import CfsReader
    from ..data.features import LmdbFeatureReader
    if path.endswith(".cfs"):
        return CfsReader(path)
    return LmdbFeatureReader(path, feat_dim=feat_dim)


def is_tdlmdb(path: str) -> bool:
    """True when ``path`` is a tensorpack-serialized (QA-joined) LMDB — the
    reference's `format: serialized_lmdb` train artifact — as opposed to a
    per-image feature LMDB (which carries a b'keys' index)."""
    from ..data.lmdb_lite import Reader
    if path.endswith(".cfs") or not os.path.exists(path):
        return False
    try:
        with Reader(path) as r:
            return r.get(b"__keys__") is not None
    except (ValueError, OSError):
        return False


def ingest_tdlmdb(td_path: str, cache_dir: str, tag: str):
    """One-time stream of a td-lmdb into the native inputs: a CFS feature
    store + target-pkl-style entries, cached under ``cache_dir`` by a
    signature of the source (path, size, mtime), so an ingest of another
    td-lmdb in the same directory is never reused
    (clg_vqa_tpu/cli/common.py:214-240). Returns (cfs path, entries)."""
    import hashlib
    import pickle
    from ..data.tdlmdb import tdlmdb_to_cfs
    os.makedirs(cache_dir, exist_ok=True)
    target = td_path
    if os.path.isdir(td_path):
        cand = os.path.join(td_path, "data.mdb")
        if os.path.exists(cand):
            target = cand
    st = os.stat(target)
    sig = hashlib.sha1(
        f"{os.path.abspath(td_path)}:{st.st_size}:{int(st.st_mtime)}"
        .encode()).hexdigest()[:10]
    cfs_path = os.path.join(cache_dir, f"ingest_{tag}_{sig}.cfs")
    entries_pkl = os.path.join(cache_dir, f"ingest_{tag}_{sig}_target.pkl")
    if not (os.path.exists(cfs_path) and os.path.exists(entries_pkl)):
        n_img, n_q = tdlmdb_to_cfs(td_path, cfs_path, entries_pkl)
        print(f"ingested td-lmdb {td_path}: {n_q} QA pairs / "
              f"{n_img} images -> {cfs_path}")
    with open(entries_pkl, "rb") as f:
        items = pickle.load(f)
    return cfs_path, items


def build_distance_matrix(task_cfg, num_labels: int):
    """The semantic-prior distance matrix of the task, or None."""
    from ..ops.semantic_prior import (build_distance_matrix_embedding,
                                      build_distance_matrix_wordnet)
    p = task_cfg.semantic_dict_path
    if not p or not os.path.exists(p):
        return None
    if "wn" in os.path.basename(p) or "semantic_index" in os.path.basename(p):
        return build_distance_matrix_wordnet(p, num_labels)
    return build_distance_matrix_embedding(p, num_labels)


def build_code_mixer(task_cfg, seed: int):
    if not task_cfg.code_mixing:
        return None
    from ..data.code_mix import CodeMixer, load_muse_dicts
    dicts = load_muse_dicts(task_cfg.dictionary_path)
    return CodeMixer(dicts, ratio=task_cfg.ratio, cross=task_cfg.cross,
                     seed=seed)


def build_dataset(args, cfg, task_cfg, split: str, features_path: str,
                  annotations_jsonpath: str = "", code_mixer=None,
                  entry_items: list | None = None):
    """The GQA dataset of ``split`` over the store at ``features_path``;
    ``entry_items`` (a td-lmdb ingest's own QA pairs) replace the split's
    annotations."""
    from ..data.gqa import GQADataset, _entries_from_target_items, load_entries
    if entry_items is not None:
        entries = _entries_from_target_items(
            sorted(entry_items, key=lambda x: x["question_id"]))
    else:
        entries = load_entries(task_cfg.dataroot, split, annotations_jsonpath)
    store = open_feature_store(features_path, cfg.v_feature_size)
    tok = build_tokenizer(args, cfg)
    return GQADataset(
        entries, store, tok, max_seq_length=task_cfg.max_seq_length,
        max_region_num=task_cfg.max_region_num, num_locs=cfg.num_locs,
        num_labels=task_cfg.num_labels,
        add_global_imgfeat=getattr(cfg, "add_global_imgfeat", None),
        norm_embeddings=getattr(cfg, "norm_embeddings", False),
        code_mixer=code_mixer)


@torch.no_grad()
def init_classifier_from_answers(model, tokenizer, ans2label: dict):
    """embed_clf: the classifier's output rows from the mean word embedding
    of each answer's tokens (train_task.py:218-238), in place.

    Quirk reproduced: rows are assigned in sorted(ans2label.items()) order —
    sorted by ANSWER STRING — so row i holds the i-th sorted answer's
    embedding, not label i's (the reference loop at train_task.py:224-233)."""
    word = model.embeddings.word
    fc2 = model.classifier.fc2.weight            # [num_labels, clf_hidden]
    if word.shape[1] != fc2.shape[1]:
        raise ValueError(
            f"embed_clf needs clf_hidden == hidden ({fc2.shape[1]} != "
            f"{word.shape[1]}); the reference only supports this for UC2")
    rows = []
    for answer, _label in sorted(ans2label.items()):
        ids = tokenizer.convert_tokens_to_ids(tokenizer.tokenize(answer))
        if len(ids):
            rows.append(word[torch.as_tensor(ids, device=word.device)].mean(0))
        else:
            unk = tokenizer.convert_tokens_to_ids(tokenizer.tokenize("<unk>"))[0]
            rows.append(word[unk])
    fc2.copy_(torch.stack(rows))
    return model


def maybe_device_bank(ds, cfg, task_cfg, *, budget_bytes: int = 6 << 30,
                      device=None):
    """A DeviceFeatureBank on ``device`` when the processed store fits the
    budget, else None: batches then carry store indices instead of
    features."""
    from ..data.device_bank import DeviceFeatureBank
    per = task_cfg.max_region_num * (cfg.v_feature_size + cfg.num_locs) * 4
    if ds.store.n_records * per > budget_bytes:
        return None
    return DeviceFeatureBank(
        ds.store, max_regions=task_cfg.max_region_num, num_locs=cfg.num_locs,
        norm_embeddings=getattr(cfg, "norm_embeddings", False),
        add_global_imgfeat=getattr(cfg, "add_global_imgfeat", None),
        device=device)
