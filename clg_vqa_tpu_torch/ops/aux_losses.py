"""Auxiliary loss zoo (port of clg_vqa_tpu/ops/aux_losses.py): the
task_utils.py loss classes outside the main GQA recipe (the semantic-prior
CE lives in ops/semantic_prior.py).

Reference (behavior spec): volta/volta/task_utils.py:22-192 —
Custom_CrossEntropy_PSKD (22), loss_kd_regularization / Tf-KD_reg (36),
CosineLoss (62), loss_kd_self / Tf-KD_self (79), mse_loss (115),
cosine_loss (139), LogitNormLoss (161), triplet_loss (176), LossMap (185).
Each is a plain function of tensors that computes in fp32.

Reductions and quirks kept from the JAX package (clg_vqa_tpu/ops/aux_losses.py:10-19):
- PSKD CE reduces ``(-targets * log_probs).mean(0).sum()``: the batch mean
  first, then the class sum.
- ``KLDivLoss(reduction="batchmean")(p_log, q)`` is
  ``sum(q * (log q - p_log)) / B`` with 0 * log 0 = 0 (``xlogy``).
- cosine_teacher_loss SUMS (1 - cos) over the batch (task_utils.py:155).
- Tf-KD_reg multiplies the KL target by ``similarity`` before the log
  (task_utils.py:55), so similarity enters through both q and log q.
"""
from __future__ import annotations

import torch


def _ce_mean(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """F.cross_entropy(logits, labels) with integer labels, mean reduction."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def _kl_batchmean(p_log: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """torch.nn.KLDivLoss(reduction="batchmean")(p_log, q), as xlogy."""
    return (torch.special.xlogy(q, q) - q * p_log).sum() / p_log.shape[0]


def _argmax_labels(target_onehot: torch.Tensor) -> torch.Tensor:
    return target_onehot.float().argmax(1)


def _topk_take(x: torch.Tensor, teacher_logits: torch.Tensor, k: int):
    """(top-k of x, the teacher's logits at the same indices)."""
    top, idx = torch.topk(x, k, dim=-1)
    return top, teacher_logits.float().gather(-1, idx)


def pskd_cross_entropy(logits: torch.Tensor,
                       soft_targets: torch.Tensor) -> torch.Tensor:
    """Custom_CrossEntropy_PSKD (task_utils.py:22-34): soft-target CE,
    ``(-targets * log_softmax(logits)).mean(0).sum()``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return (-soft_targets.float() * logp).mean(0).sum()


def kd_regularization_loss(logits: torch.Tensor, target_onehot: torch.Tensor,
                           similarity: torch.Tensor, *, alpha: float = 0.1,
                           temperature: float = 20.0,
                           correct_prob: float = 0.99) -> torch.Tensor:
    """Tf-KD_reg (task_utils.py:36-59): CE against the argmax labels blended
    with a KL to a hand-made near-uniform teacher, scaled elementwise by
    ``similarity`` (the semantic-prior row)."""
    logits = logits.float()
    labels = _argmax_labels(target_onehot)
    ce = _ce_mean(logits, labels)
    B, K = logits.shape
    teacher = torch.full_like(logits, (1.0 - correct_prob) / (K - 1))
    teacher[torch.arange(B, device=logits.device), labels] = correct_prob
    q = torch.softmax(teacher / temperature, dim=1) * similarity.float()
    regu = _kl_batchmean(torch.log_softmax(logits, dim=1), q)
    return (1.0 - alpha) * ce + alpha * regu


def cosine_rep_loss(logits: torch.Tensor, target_onehot: torch.Tensor,
                    teacher_rep: torch.Tensor, epoch: int, *,
                    multiplier: float = 10.0) -> torch.Tensor:
    """CosineLoss (task_utils.py:62-77): CE, plus after epoch 4 the mean
    (1 - cos) between the student's and the teacher's softmax, x10."""
    logits = logits.float()
    ce = _ce_mean(logits, _argmax_labels(target_onehot))
    if epoch <= 4:
        return ce
    p = torch.softmax(logits, dim=-1)
    q = torch.softmax(teacher_rep.float(), dim=-1)
    cos = (p * q).sum(-1) / (torch.linalg.vector_norm(p, dim=-1)
                             * torch.linalg.vector_norm(q, dim=-1))
    return ce + multiplier * (1.0 - cos).mean()


def kd_self_loss(logits: torch.Tensor, target_onehot: torch.Tensor,
                 teacher_logits: torch.Tensor, epoch: int, *,
                 temperature: float = 20.0, top_k: int = 10,
                 multiplier: float = 1.0) -> torch.Tensor:
    """Tf-KD_self (task_utils.py:79-113): CE plus the T^2-scaled KL between
    the student's top-k log-probs (of logits / T) and the teacher's softmax
    over the same top-k indices."""
    logits = logits.float()
    ce = _ce_mean(logits, _argmax_labels(target_onehot))
    if epoch <= 0:
        return ce
    p_top, t_top = _topk_take(torch.log_softmax(logits / temperature, dim=-1),
                              teacher_logits, top_k)
    q = torch.softmax(t_top / temperature, dim=-1)
    return ce + _kl_batchmean(p_top, q) * temperature ** 2 * multiplier


def mse_teacher_loss(logits: torch.Tensor, target_onehot: torch.Tensor,
                     teacher_logits: torch.Tensor, epoch: int, *,
                     top_k: int = 10, multiplier: float = 10.0) -> torch.Tensor:
    """mse_loss (task_utils.py:115-137): CE plus x10 the MSE between the
    student's top-k softmax probs and the teacher's softmax over the same
    indices."""
    logits = logits.float()
    ce = _ce_mean(logits, _argmax_labels(target_onehot))
    if epoch <= 0:
        return ce
    p_top, t_top = _topk_take(torch.softmax(logits, dim=-1), teacher_logits,
                              top_k)
    q = torch.softmax(t_top, dim=-1)
    return ce + (p_top - q).square().mean() * multiplier


def cosine_teacher_loss(logits: torch.Tensor, target_onehot: torch.Tensor,
                        teacher_logits: torch.Tensor, epoch: int, *,
                        top_k: int = 10, multiplier: float = 10.0
                        ) -> torch.Tensor:
    """cosine_loss (task_utils.py:139-160): CE plus x10 the SUM over the
    batch of (1 - cos) between the student's top-k probs and the teacher's
    softmax over the same indices (the module docstring's quirk)."""
    logits = logits.float()
    ce = _ce_mean(logits, _argmax_labels(target_onehot))
    if epoch <= 0:
        return ce
    p_top, t_top = _topk_take(torch.softmax(logits, dim=-1), teacher_logits,
                              top_k)
    q = torch.softmax(t_top, dim=-1)
    eps = 1e-8                           # nn.CosineSimilarity's default eps
    denom = (torch.linalg.vector_norm(p_top, dim=-1).clamp_min(eps)
             * torch.linalg.vector_norm(q, dim=-1).clamp_min(eps))
    cos = (p_top * q).sum(-1) / denom
    return ce + multiplier * (1.0 - cos).sum()


def logit_norm_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                    t: float = 0.01) -> torch.Tensor:
    """LogitNormLoss (task_utils.py:161-170): CE of L2-normalized logits / t."""
    logits = logits.float()
    norms = torch.linalg.vector_norm(logits, dim=-1, keepdim=True) + 1e-7
    return _ce_mean(logits / norms / t, labels)


def triplet_loss(rank_scores: torch.Tensor, target=None, *,
                 margin: float = 0.2) -> torch.Tensor:
    """triplet_loss (task_utils.py:176-181): sigmoid scores, the hinge of
    (margin + neg - pos) over columns 1.. against column 0, mean."""
    s = torch.sigmoid(rank_scores.float())
    return (margin + s[:, 1:] - s[:, :1]).clamp_min(0.0).mean()


def bce_with_logits_loss(logits: torch.Tensor,
                         targets: torch.Tensor) -> torch.Tensor:
    """nn.BCEWithLogitsLoss(reduction="mean"), the VQA-style LossMap entry
    (task_utils.py:186), in the stable form
    max(z, 0) - z y + log(1 + exp(-|z|))."""
    z, y = logits.float(), targets.float()
    return (z.clamp_min(0) - z * y + torch.log1p(torch.exp(-z.abs()))).mean()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """nn.CrossEntropyLoss() with integer labels (task_utils.py:187)."""
    return _ce_mean(logits, labels)


# task_utils.py:185-189; ForwardModelsTrain calls criterion(prediction,
# argmax(target)) for the GQA "VL-classifier-GQA" type (423) and
# criterion(prediction, target) for the BCE types (409)
LOSS_MAP = {
    "BCEWithLogitLoss": bce_with_logits_loss,
    "CrossEntropyLoss": cross_entropy_loss,
    "TripletLoss": triplet_loss,
}
