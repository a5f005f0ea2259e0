"""Semantic-prior label-similarity loss on the device (port of
clg_vqa_tpu/ops/semantic_prior.py:23-97).

The full [num_labels, num_labels] distance matrix ``D`` is built once on the
host and kept on the device; the loss takes the top-10 of the fp32 softmax
and dots it with the target rows of ``D`` (task_utils.py:415-428), so no
per-batch host loop exists. ``D[t, j]`` is the distance of candidate label j
from target t.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch


def build_distance_matrix_embedding(pkl_path: str, num_labels: int) -> np.ndarray:
    """From embedding_distance.pkl: dict {(i, j): 1 - cosine_sim}
    (symmetric, volta/extract_emb_dist.py); diagonal 0
    (gqa_dataset_semantic_code_mix.py:371-381)."""
    with open(pkl_path, "rb") as f:
        dists = pickle.load(f)
    D = np.zeros((num_labels, num_labels), np.float32)
    for (i, j), d in dists.items():
        D[i, j] = d
    np.fill_diagonal(D, 0.0)
    return D


def build_distance_matrix_wordnet(pkl_path: str, num_labels: int,
                                  sim_values=(0.0, 0.8, 0.8, 1.0)) -> np.ndarray:
    """From l2l_semantic_index.pkl: {t: {"syn": [...], "hyp": [...],
    "hpo": [...]}} (volta/extract_wn_rel.py): 0 for the target and its
    synonyms, 0.8 for hypernyms and hyponyms, 1 otherwise
    (gqa_dataset_semantic_code_mix.py:352-369)."""
    with open(pkl_path, "rb") as f:
        rel = pickle.load(f)
    D = np.full((num_labels, num_labels), sim_values[3], np.float32)
    for t in range(num_labels):
        r = rel.get(t, {"syn": [], "hyp": [], "hpo": []})
        D[t, r["syn"]] = sim_values[0]
        D[t, r["hyp"]] = sim_values[1]
        D[t, r["hpo"]] = sim_values[2]
        D[t, t] = sim_values[0]
    return D


def semantic_prior_loss(logits: torch.Tensor, labels: torch.Tensor,
                        distance_matrix: torch.Tensor,
                        top_k: int = 10) -> torch.Tensor:
    """mean_b sum_{k in top-k} softmax(logits)_k * D[label_b, k]
    (task_utils.py:418-421), a scalar. Gradients flow through the top-k
    probabilities."""
    probs = torch.softmax(logits.float(), dim=-1)
    p_top, idx_top = torch.topk(probs, min(top_k, logits.shape[-1]), dim=-1)
    d_top = distance_matrix[labels.long()[:, None], idx_top]
    return (p_top * d_top).sum(-1).mean()


def gqa_train_loss(logits: torch.Tensor, labels: torch.Tensor,
                   distance_matrix: torch.Tensor, *,
                   semantic_lambda: float = 10.0, top_k: int = 10,
                   num_labels: int | None = None,
                   criterion: str = "CrossEntropyLoss") -> torch.Tensor:
    """The VL-classifier-GQA training loss (task_utils.py:413-425):
    ``num_labels * (criterion(logits, label) + lambda * semantic prior)``.
    ``criterion`` is "CrossEntropyLoss" (the recipe's) or "LogitNormLoss"
    (task_utils.py:161-170, 186)."""
    if num_labels is None:
        num_labels = logits.shape[-1]
    x = logits.float()
    if criterion == "LogitNormLoss":
        x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-7) / 0.01
    elif criterion != "CrossEntropyLoss":
        raise ValueError(f"criterion {criterion!r} is not valid for the "
                         "VL-classifier-GQA task type (task_utils.py:423)")
    logp = torch.log_softmax(x, dim=-1)
    ce = -logp.gather(-1, labels.long()[:, None]).mean()
    sem = semantic_prior_loss(logits, labels, distance_matrix, top_k)
    return num_labels * (ce + semantic_lambda * sem)


def vqa_train_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The plain VL-classifier (VQA soft-target) branch, task_utils.py:409-411:
    ``BCEWithLogitsLoss(mean)(logits, target) * target.size(1)``
    (clg_vqa_tpu/ops/semantic_prior.py:100-104)."""
    from .aux_losses import bce_with_logits_loss
    return bce_with_logits_loss(logits, target) * target.shape[-1]
