"""Synthetic full-scale data: the recipe of the JAX package's eval bench
(tools/bench_eval.py:47-84) — a CFS store of random region features (UC2:
36 x 2048 with 7 locs; M3P, ``--m3p``: 100 x 2048 with 5 locs and
L2-normalized embeddings) and questions made of 4-11 random words, all from
one seed — and training questions in the envelope of its train bench
(bench.py:80-92, tools/profile_train.py:98-102) over the same store. No
pretrained weights or real images are needed to drive the eval and training
paths at their real shapes."""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .cfs import CfsReader, CfsWriter
from .device_bank import DeviceFeatureBank
from .features import RegionRecord
from .gqa import Entry, GQADataset
from .tokenizer import HashTokenizer

REGIONS, NUM_LOCS, MAX_SEQ = 36, 7, 40
M3P_REGIONS, M3P_NUM_LOCS = 100, 5


def write_store(path: str, r: np.random.RandomState, *, n_images: int = 400,
                regions: int = 36, feat_dim: int = 2048,
                min_regions: int | None = None) -> None:
    """Images "0".."n_images-1", each with ``regions`` boxes in a 640x480
    frame and normal random features; with ``min_regions`` each image has a
    number of boxes drawn uniformly from [min_regions, regions]."""
    with CfsWriter(path) as w:
        for i in range(n_images):
            n = regions if min_regions is None else int(
                r.randint(min_regions, regions + 1))
            w.add(RegionRecord(
                image_id=str(i),
                features=r.randn(n, feat_dim).astype(np.float32),
                boxes=(r.rand(n, 4) * 300
                       + np.array([0, 0, 50, 50])).astype(np.float32),
                img_w=640.0, img_h=480.0))


def make_entries(r: np.random.RandomState, n: int, *, n_images: int = 400,
                 num_labels: int = 1842) -> list[Entry]:
    """``n`` labelled questions over the store's images."""
    words = [f"word{i}" for i in range(3000)]
    return [Entry(question_id=i, image_id=str(r.randint(n_images)),
                  question=" ".join(r.choice(words, r.randint(4, 12))),
                  labels=[int(r.randint(num_labels))], scores=[1.0])
            for i in range(n)]


@dataclass
class EvalWorld:
    reader: CfsReader
    entries: list[Entry]
    tokenizer: HashTokenizer
    dataset: GQADataset
    label2ans: list[str]
    bank: DeviceFeatureBank
    regions: int = REGIONS
    num_locs: int = NUM_LOCS
    norm_embeddings: bool = False


def eval_world(directory: str, n_qa: int, *, num_labels: int = 1842,
               vocab_size: int = 250002, n_images: int = 400,
               device=None, regions: int = REGIONS, num_locs: int = NUM_LOCS,
               norm_embeddings: bool = False,
               min_regions: int | None = None) -> EvalWorld:
    """Everything a full-scale eval needs besides the model, from seed 0:
    the store (written to ``directory``), ``n_qa`` questions over it, the
    dataset, answer names "a0".. and the feature bank on ``device``. The
    defaults are UC2's; :func:`m3p_world` gives M3P's."""
    r = np.random.RandomState(0)
    path = os.path.join(directory, "feats.cfs")
    write_store(path, r, n_images=n_images, regions=regions,
                min_regions=min_regions)
    reader = CfsReader(path)
    entries = make_entries(r, n_qa, n_images=n_images, num_labels=num_labels)
    tok = HashTokenizer(vocab_size)
    ds = GQADataset(entries, reader, tok, max_seq_length=MAX_SEQ,
                    max_region_num=regions, num_locs=num_locs,
                    num_labels=num_labels, norm_embeddings=norm_embeddings)
    bank = DeviceFeatureBank(reader, max_regions=regions, num_locs=num_locs,
                             norm_embeddings=norm_embeddings, device=device)
    return EvalWorld(reader, entries, tok, ds,
                     [f"a{i}" for i in range(num_labels)], bank, regions,
                     num_locs, norm_embeddings)


def m3p_world(directory: str, n_qa: int, *, min_regions: int | None = None,
              **kw) -> EvalWorld:
    """:func:`eval_world` at M3P's recipe (tools/bench_eval.py:47-49,
    cli/common.build_dataset): 100 regions, 5 locs, L2-normalized features
    and locs. ``min_regions`` gives images with fewer boxes, whose padding
    slots trigger the prefix-length mask quirk and the -inf keys."""
    return eval_world(directory, n_qa, regions=M3P_REGIONS,
                      num_locs=M3P_NUM_LOCS, norm_embeddings=True,
                      min_regions=min_regions, **kw)


def train_dataset(world: EvalWorld, n_qa: int, *, seed: int = 1) -> GQADataset:
    """``n_qa`` training questions over ``world``'s store in bench.py:80-92's
    envelope: every question fills all 40 token slots (38 random words
    between bos and eos, so the text mask is all ones), every image brings
    the regions the store holds for it (all of them in the bench recipe),
    and labels are uniform over the answer space."""
    r = np.random.RandomState(seed)
    n_images = world.reader.n_records
    num_labels = len(world.label2ans)
    entries = [Entry(question_id=i, image_id=str(r.randint(n_images)),
                     question=" ".join(f"w{j}" for j in
                                       r.randint(100000, size=MAX_SEQ - 2)),
                     labels=[int(r.randint(num_labels))], scores=[1.0])
               for i in range(n_qa)]
    return GQADataset(entries, world.reader, world.tokenizer,
                      max_seq_length=MAX_SEQ, max_region_num=world.regions,
                      num_locs=world.num_locs, num_labels=num_labels,
                      norm_embeddings=world.norm_embeddings)
