"""The traffic generator: the raw data of a run, from its seed and the
traffic mix's parameters (after data/synthetic.py's recipe, which is fixed
to seed 0).

A world is a region store of ``images`` detector records (normal random
2048-wide features; boxes in a 640 x 480 frame; every image with the
configuration's region count, or with ``min_boxes`` an even spread of box
counts from ``min_boxes`` to it) and questions of random words over it.
Every seed draws the same set of sizes (box counts, question lengths,
requests per call) in its own order, so seeds change the values and not
the amount of work. The store is written with the port's CFS writer, as a
user's extractor writes it."""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .seeds import sub


@dataclasses.dataclass
class World:
    features: np.ndarray        # [images, R, F] float32 (rows past n_boxes unused)
    boxes: np.ndarray           # [images, R, 4] float32 pixel xyxy
    n_boxes: np.ndarray         # [images]
    img_w: float
    img_h: float
    questions: list             # question text of each QA row
    image_of: list              # store index of each row's image
    labels: list | None         # each row's answer, or None (test splits)
    store: str = ""             # the CFS file


def spread(lo: int, hi: int, n: int, rng) -> np.ndarray:
    """n sizes spread evenly over [lo, hi], in ``rng``'s order."""
    out = np.round(np.linspace(lo, hi, n)).astype(np.int64)
    rng.shuffle(out)
    return out


def make(d: dict, traffic: dict, seed: int, n_rows: int, *, device,
         labels: bool, words: list[str] | None = None) -> World:
    """The world of a run: ``n_rows`` questions. ``words`` prefixes each
    block of rows' words (one block per language), else one block."""
    rng = np.random.default_rng(sub(seed, "data"))
    N, R, F = traffic["images"], d["regions"], d["feat"]
    n_boxes = (np.full(N, R) if traffic.get("min_boxes") is None
               else spread(traffic["min_boxes"], R, N, rng))
    g = torch.Generator(device).manual_seed(sub(seed, "features"))
    feats = torch.randn(N, R, F, generator=g, device=device).cpu().numpy()
    boxes = (rng.random((N, R, 4)) * 300
             + np.array([0, 0, 50, 50])).astype(np.float32)
    lo, hi = traffic["question_words"]
    lengths = spread(lo, hi, n_rows, rng)
    pool = traffic["word_pool"]
    prefixes = words or [""]
    block = -(-n_rows // len(prefixes))
    ids = rng.integers(pool, size=int(lengths.sum()))
    questions, at = [], 0
    for r, n in enumerate(lengths):
        p = prefixes[r // block]
        questions.append(" ".join(f"{p}w{j}" for j in ids[at:at + n]))
        at += n
    image_of = rng.integers(N, size=n_rows).tolist()
    lab = rng.integers(d["labels"], size=n_rows).tolist() if labels else None
    return World(feats, boxes, n_boxes, traffic["image_w"], traffic["image_h"],
                 questions, image_of, lab)


def write_store(world: World, directory: str) -> str:
    """Write the world's records to ``directory``/feats.cfs with the port's
    CFS writer; image ids are the store indices as strings."""
    from clg_vqa_tpu_torch.data.cfs import CfsWriter
    from clg_vqa_tpu_torch.data.features import RegionRecord
    path = os.path.join(directory, "feats.cfs")
    with CfsWriter(path) as w:
        for i, n in enumerate(world.n_boxes):
            w.add(RegionRecord(image_id=str(i), features=world.features[i, :n],
                               boxes=world.boxes[i, :n], img_w=world.img_w,
                               img_h=world.img_h))
    world.store = path
    return path
