"""The reference's own inputs from the benchmark's raw data: token ids from
the question text, and padded region features and locations from the raw
detector records, as the published data path (the VOLTA GQA dataset and
its image-features reader) makes them.

- Text: XLM-R's layout with a deterministic hash in place of
  sentencepiece (bos 0, pad 1, eos 2; each whitespace piece is 3 + its
  32-bit FNV-1a hash modulo vocab - 3), truncated to ``[t0] + t[1:-1][:T-2]
  + [t_last]`` and padded at the end.
- Regions: boxes divided by the image's width and height, then (7 locs)
  width and height, and the relative area last; M3P L2-normalises each
  region's features and its locations; padded to the configuration's
  region count with a 0/1 mask."""
from __future__ import annotations

import numpy as np
import torch


def piece_id(piece: str, vocab: int) -> int:
    h = 2166136261
    for ch in piece.encode("utf-8"):
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return 3 + (h % (vocab - 3))


def tokens(text: str, vocab: int, T: int) -> tuple[list[int], list[int]]:
    """(ids, mask), both of length T."""
    ids = [0] + [piece_id(p, vocab) for p in text.strip().split()] + [2]
    ids = [ids[0]] + ids[1:-1][:T - 2] + [ids[-1]]
    n = len(ids)
    return ids + [1] * (T - n), [1] * n + [0] * (T - n)


def regions(feats: np.ndarray, boxes: np.ndarray, w: float, h: float, *,
            num_locs: int, norm: bool, R: int):
    """(features [R, F], locs [R, num_locs], mask [R]) of one image."""
    n = min(len(boxes), R)
    x1, y1, x2, y2 = (boxes[:n, i].astype(np.float64) for i in range(4))
    cols = [x1 / w, y1 / h, x2 / w, y2 / h]
    if num_locs > 5:
        cols += [x2 / w - x1 / w, y2 / h - y1 / h]
    cols.append((y2 - y1) * (x2 - x1) / (w * h))
    loc = np.stack(cols, 1)
    f = feats[:n].astype(np.float64)
    if norm:
        f = f / np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-12)
        loc = loc / np.linalg.norm(loc, axis=1, keepdims=True)
    F = feats.shape[1]
    fo = np.zeros((R, F), np.float32)
    lo = np.zeros((R, num_locs), np.float32)
    mo = np.zeros((R,), np.int64)
    fo[:n], lo[:n], mo[:n] = f, loc, 1
    return fo, lo, mo


def batch(world, rows, d: dict, device) -> dict:
    """The model inputs of QA rows ``rows`` of ``world`` (the benchmark's
    raw data: questions, image_of, labels, and the store's raw records), as
    float32 / int64 tensors on ``device``."""
    ids, tmask, feats, locs, imask, labels = [], [], [], [], [], []
    cache = {}
    for r in rows:
        t, m = tokens(world.questions[r], d["vocab"], d["text"])
        ids.append(t)
        tmask.append(m)
        img = world.image_of[r]
        if img not in cache:
            n = world.n_boxes[img]
            cache[img] = regions(world.features[img, :n], world.boxes[img, :n],
                                 world.img_w, world.img_h, num_locs=d["locs"],
                                 norm=d["norm"], R=d["regions"])
        f, lo, mo = cache[img]
        feats.append(f)
        locs.append(lo)
        imask.append(mo)
        labels.append(world.labels[r] if world.labels is not None else 0)
    t = dict(input_ids=np.array(ids), input_mask=np.array(tmask),
             features=np.stack(feats), locs=np.stack(locs),
             image_mask=np.stack(imask), labels=np.array(labels))
    return {k: torch.from_numpy(v).to(device) for k, v in t.items()}
