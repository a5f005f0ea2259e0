"""Fixed-shape NMS (port of clg_vqa_tpu/ops/nms.py:28-200).

Greedy NMS as select-max-and-suppress: K iterations (K = requested outputs,
300 for the RPN, not N = 6000 candidates), each taking the first maximum of
the remaining scores and suppressing its overlaps. That is sorted greedy
NMS truncated to K outputs, lowest index first among equal scores, with no
[N, N] IoU matrix. The loop runs on the device and never reads a value back
to the host, so its launches queue without a synchronisation. Rows of a
batch (classes, images, thresholds) run through one loop together.

``batched_nms_fixpoint`` is the exact greedy per-class NMS over shared boxes
as a parallel fixpoint; it checks convergence on the host once per
iteration and counts those reads in ``batched_nms_fixpoint.host_syncs``.
Outputs follow torchvision: kept indices in descending-score
order, padded (keep False) past the survivors.
"""
from __future__ import annotations

import torch

NEG = float("-inf")


def _areas(boxes: torch.Tensor, t: float) -> torch.Tensor:
    return ((boxes[..., 2] - boxes[..., 0] + t).clamp(min=0)
            * (boxes[..., 3] - boxes[..., 1] + t).clamp(min=0))


def iou_matrix(boxes: torch.Tensor, *, legacy: bool = False) -> torch.Tensor:
    """Pairwise IoU of boxes [..., N, 4] xyxy -> [..., N, N]. legacy=False:
    torchvision widths x2 - x1; legacy=True: the Detectron/caffe
    x2 - x1 + 1."""
    t = 1.0 if legacy else 0.0
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = _areas(boxes, t)
    lt_x = torch.maximum(x1[..., :, None], x1[..., None, :])
    lt_y = torch.maximum(y1[..., :, None], y1[..., None, :])
    rb_x = torch.minimum(x2[..., :, None], x2[..., None, :])
    rb_y = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (rb_x - lt_x + t).clamp(min=0) * (rb_y - lt_y + t).clamp(min=0)
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold, k: int,
               *, valid: torch.Tensor | None = None, legacy: bool = False):
    """Greedy NMS on every row of a batch: boxes [C, N, 4], scores [C, N],
    valid [C, N] or None; iou_threshold a float or a [C] tensor (one per
    row). Returns (indices [C, k] int64, keep [C, k] bool). Each iteration
    is a fixed set of small device ops (its IoU row is JAX's _iou_row: the
    chosen box's area is the same formula on the same values)."""
    C, n = scores.shape
    t = 1.0 if legacy else 0.0
    dev = scores.device
    areas = _areas(boxes, t)
    lo, hi = boxes[..., :2], boxes[..., 2:]
    live = scores.float()
    if valid is not None:
        live = torch.where(valid, live, NEG)
    thr = torch.as_tensor(iou_threshold, dtype=torch.float32, device=dev)
    thr = thr.reshape(-1, 1) if thr.dim() else thr
    rows = torch.arange(C, device=dev)
    idx, keep = [], []
    for _ in range(k):
        j = live.argmax(1)                              # first maximum wins
        ok = live[rows, j] > NEG
        box = boxes[rows, j][:, None]                   # [C, 1, 4]
        wh = ((torch.minimum(box[..., 2:], hi) - torch.maximum(box[..., :2], lo)
               + t).clamp(min=0))
        inter = wh[..., 0] * wh[..., 1]
        union = areas[rows, j][:, None] + areas - inter
        iou = torch.where(union > 0, inter / union, 0.0)
        live = torch.where(ok[:, None] & (iou > thr), NEG, live)
        live[rows, j] = NEG
        idx.append(torch.where(ok, j, 0))
        keep.append(ok)
    if not k:
        return (torch.zeros(C, 0, dtype=torch.int64, device=dev),
                torch.zeros(C, 0, dtype=torch.bool, device=dev))
    return torch.stack(idx, 1), torch.stack(keep, 1)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, *,
        max_outputs: int | None = None, valid: torch.Tensor | None = None,
        legacy: bool = False):
    """torchvision.ops.nms semantics with static shapes: boxes [N, 4],
    scores [N]. Returns (indices [K], keep_mask [K]), K = max_outputs or N;
    indices in descending-score order, ties to the lower index."""
    k = boxes.shape[0] if max_outputs is None else max_outputs
    idx, keep = greedy_nms(boxes[None], scores[None], iou_threshold, k,
                           valid=None if valid is None else valid[None],
                           legacy=legacy)
    return idx[0], keep[0]


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float, *, max_outputs: int | None = None,
                valid: torch.Tensor | None = None):
    """Per-class NMS, all classes at once. boxes: [C, N, 4] (or [N, 4]
    shared), scores: [C, N], valid: [C, N], [N] or None. Returns
    (indices [C, K], keep [C, K])."""
    C, n = scores.shape
    if boxes.dim() == 2:
        boxes = boxes[None].expand(C, *boxes.shape)
    if valid is not None and valid.dim() == 1:
        valid = valid[None].expand(C, n)
    return greedy_nms(boxes, scores, iou_threshold,
                      n if max_outputs is None else max_outputs, valid=valid)


def _tie_broken(scores: torch.Tensor) -> torch.Tensor:
    """Strict (score desc, index asc) priority as exact ranks: the position
    of each box in a stable descending sort, negated (higher = first)."""
    n = scores.shape[-1]
    order = torch.argsort(-scores.float(), dim=-1, stable=True)
    inv = torch.argsort(order, dim=-1, stable=True)
    return (n - inv).float()


def batched_nms_fixpoint(boxes: torch.Tensor, scores: torch.Tensor,
                         iou_threshold: float, *,
                         valid: torch.Tensor | None = None,
                         class_chunk: int = 128,
                         legacy: bool = False) -> torch.Tensor:
    """Exact greedy per-class NMS as a parallel fixpoint: keep[i] <- valid[i]
    and no kept higher-priority box overlaps i, iterated from all-valid to
    convergence (suppression-chain depth iterations), a chunk of classes at
    a time. boxes [N, 4] shared (or [C, N, 4] per class); scores [C, N].
    Returns keep [C, N] bool."""
    C, N = scores.shape
    dev = scores.device
    over = iou_matrix(boxes, legacy=legacy) > iou_threshold
    over = over.reshape(-1, N, N) & ~torch.eye(N, dtype=torch.bool, device=dev)
    v = (torch.ones(C, N, dtype=torch.bool, device=dev) if valid is None
         else valid.expand(C, N))
    pri = torch.where(v, _tie_broken(scores), NEG)
    keep = []
    for c0 in range(0, C, class_chunk):
        p_c, v_c = pri[c0:c0 + class_chunk], v[c0:c0 + class_chunk]
        o_c = over if over.shape[0] == 1 else over[c0:c0 + class_chunk]

        def f(K, p_c=p_c, v_c=v_c, o_c=o_c):
            cand = torch.where(o_c & K[:, :, None], p_c[:, :, None], NEG)
            return v_c & (cand.amax(1) < p_c)

        K, prev, it = f(v_c), v_c, 0
        while it < N and not _converged(K, prev):
            K, prev, it = f(K), K, it + 1
        keep.append(K)
    return torch.cat(keep)


def _converged(K: torch.Tensor, prev: torch.Tensor) -> bool:
    """The fixpoint's convergence test: one read back to the host."""
    batched_nms_fixpoint.host_syncs += 1
    return torch.equal(K, prev)


batched_nms_fixpoint.host_syncs = 0
