"""Region-feature processing (own copy of clg_vqa_tpu/data/features.py:24-198).

``process_regions`` reproduces the box/feature normalization of every
reference data path (volta/volta/datasets/_image_features_reader.py:141-205
and gqa_dataset_semantic_code_mix.py:575-615): boxes normalized to [0,1],
relative area as the last loc, optional width/height locs (num_locs=7),
optional L2 normalization, optional global mean feature.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RegionRecord:
    """One image's detector output (the h5/LMDB record schema of
    features_extraction/detectron2_proposal_maxnms.py:212-220)."""
    image_id: str
    features: np.ndarray      # [N, feat_dim] float32
    boxes: np.ndarray         # [N, 4] float32 pixel xyxy
    img_w: float
    img_h: float
    obj_id: np.ndarray | None = None
    obj_conf: np.ndarray | None = None
    attr_id: np.ndarray | None = None
    attr_conf: np.ndarray | None = None


def process_regions(features: np.ndarray, boxes: np.ndarray, img_w: float,
                    img_h: float, *, num_locs: int = 5,
                    norm_embeddings: bool = False,
                    add_global_imgfeat: str | None = None):
    """Returns (features [N(+1), D], num_boxes, locs [N(+1), num_locs])."""
    n = boxes.shape[0]
    locs = np.zeros((n, num_locs), np.float32)
    locs[:, :4] = boxes
    if num_locs >= 5:
        locs[:, -1] = ((locs[:, 3] - locs[:, 1]) * (locs[:, 2] - locs[:, 0])
                       / (float(img_w) * float(img_h)))
    locs[:, 0] /= float(img_w)
    locs[:, 1] /= float(img_h)
    locs[:, 2] /= float(img_w)
    locs[:, 3] /= float(img_h)
    if num_locs > 5:
        locs[:, 4] = locs[:, 2] - locs[:, 0]
        locs[:, 5] = locs[:, 3] - locs[:, 1]

    features = np.asarray(features, np.float32)
    if norm_embeddings:
        features = features / np.maximum(
            np.linalg.norm(features, axis=-1, keepdims=True), 1e-12)
        locs = locs / np.linalg.norm(locs, 2, 1, keepdims=True)

    num_boxes = n
    if add_global_imgfeat is not None:
        g_feat = features.sum(0, keepdims=True) / max(n, 1)
        g_loc = np.array([[0, 0, 1, 1] + [1] * (num_locs - 4)], np.float32)
        if add_global_imgfeat == "first":
            features = np.concatenate([g_feat, features], 0)
            locs = np.concatenate([g_loc, locs], 0)
        elif add_global_imgfeat == "last":
            features = np.concatenate([features, g_feat], 0)
            locs = np.concatenate([locs, g_loc], 0)
        num_boxes += 1
    return features, num_boxes, locs


def pad_regions(features: np.ndarray, locs: np.ndarray, num_boxes: int,
                max_regions: int, feat_dim: int = 2048, num_locs: int = 5):
    """Fixed-shape padding (gqa_dataset_semantic_code_mix.py:213-226)."""
    n = min(num_boxes, max_regions)
    f = np.zeros((max_regions, feat_dim), np.float32)
    l = np.zeros((max_regions, num_locs), np.float32)
    m = np.zeros((max_regions,), np.int32)
    f[:n] = features[:n]
    l[:n] = locs[:n]
    m[:n] = 1
    return f, l, m


def gather_records(get_by_index, indices, *, max_regions: int,
                   num_locs: int = 5, norm_embeddings: bool = False,
                   add_global_imgfeat: str | None = None):
    """Process + pad each record to fixed (features [B, R', D],
    locs [B, R', num_locs], mask [B, R']) batch shapes, R' = max_regions
    (+1 with a global feature)."""
    B = len(indices)
    Rp = max_regions + int(add_global_imgfeat is not None)
    fd = None
    feats_out = None
    locs_out = np.zeros((B, Rp, num_locs), np.float32)
    mask_out = np.zeros((B, Rp), np.int32)
    for i, idx in enumerate(indices):
        rec = get_by_index(int(idx))
        if feats_out is None:
            fd = rec.features.shape[1]
            feats_out = np.zeros((B, Rp, fd), np.float32)
        f, n, l = process_regions(
            rec.features, rec.boxes, rec.img_w, rec.img_h,
            num_locs=num_locs, norm_embeddings=norm_embeddings,
            add_global_imgfeat=add_global_imgfeat)
        pf, pl, pm = pad_regions(f, l, n, Rp, feat_dim=fd,
                                 num_locs=num_locs)
        feats_out[i], locs_out[i], mask_out[i] = pf, pl, pm
    return feats_out, locs_out, mask_out
