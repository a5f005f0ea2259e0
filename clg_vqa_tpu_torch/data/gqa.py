"""GQA / xGQA annotation loading and the eval dataset (own copy of
clg_vqa_tpu/data/gqa.py:27-215).

Entry loading follows the reference exactly
(gqa_dataset_semantic_code_mix.py:48-95 ``_load_dataset``):

 - train/val:        {split}_target.pkl, sorted by question_id
 - trainval:         trainval_target.pkl sorted, minus the last 3000
 - minval:           the last 3000 of sorted trainval_target.pkl
 - test:             testdev_balanced_questions.json (dict qid -> record)
 - test_{lang}:      explicit json path (xGQA test dict format)
 - train_{n}_{lang} / dev_{lang}: explicit pkl path (xGQA few-shot entries)

Answer vocabulary: trainval_ans2label.pkl / trainval_label2ans.pkl
(1842 answers).
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle

import numpy as np

from .tokenizer import encode_padded


@dataclasses.dataclass
class Entry:
    question_id: int
    image_id: str
    question: str
    labels: list[int] | None = None     # answer label ids
    scores: list[float] | None = None


def load_answer_vocab(dataroot: str) -> tuple[dict, list]:
    with open(os.path.join(dataroot, "trainval_ans2label.pkl"), "rb") as f:
        ans2label = pickle.load(f)
    with open(os.path.join(dataroot, "trainval_label2ans.pkl"), "rb") as f:
        label2ans = pickle.load(f)
    return ans2label, label2ans


def _entries_from_target_items(items: list[dict]) -> list[Entry]:
    return [Entry(question_id=int(it["question_id"]),
                  image_id=str(it["image_id"]), question=it["question"],
                  labels=list(it.get("labels", []) or []),
                  scores=list(it.get("scores", []) or []))
            for it in items]


def _entries_from_test_dict(d: dict) -> list[Entry]:
    return [Entry(question_id=int(qid), image_id=str(it["imageId"]),
                  question=it["question"])
            for qid, it in d.items()]


def load_entries(dataroot: str, split: str,
                 annotations_jsonpath: str = "") -> list[Entry]:
    def load_pkl(path):
        with open(path, "rb") as f:
            return pickle.load(f)

    def by_qid(items):
        return sorted(items, key=lambda x: x["question_id"])

    if split in ("train", "val"):
        return _entries_from_target_items(
            by_qid(load_pkl(os.path.join(dataroot, f"{split}_target.pkl"))))
    if split == "trainval":
        items = by_qid(load_pkl(os.path.join(dataroot, "trainval_target.pkl")))
        return _entries_from_target_items(items[:-3000])
    if split == "minval":
        items = by_qid(load_pkl(os.path.join(dataroot, "trainval_target.pkl")))
        return _entries_from_target_items(items[-3000:])
    if split == "test":
        with open(os.path.join(dataroot,
                               "testdev_balanced_questions.json")) as f:
            return _entries_from_test_dict(json.load(f))
    if split.startswith("test_"):
        with open(annotations_jsonpath) as f:
            return _entries_from_test_dict(json.load(f))
    if split.startswith(("train_", "dev_")):
        return _entries_from_target_items(by_qid(load_pkl(annotations_jsonpath)))
    raise ValueError(f"unrecognized split: {split}")


class GQADataset:
    """Map-style dataset over a feature store + entries (the reference's
    ``format: lmdb`` eval path, gqa_dataset_semantic_code_mix.py:98-245).

    Questions are tokenized once up front unless a ``code_mixer`` rewrites
    them per sample; batches are assembled with the store's gather."""

    def __init__(self, entries: list[Entry], feature_store, tokenizer, *,
                 max_seq_length: int = 40, max_region_num: int = 36,
                 num_locs: int = 5, num_labels: int = 1842,
                 add_global_imgfeat: str | None = None,
                 norm_embeddings: bool = False,
                 code_mixer=None):
        self.entries = entries
        self.store = feature_store
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.max_region_num = max_region_num
        self.num_locs = num_locs
        self.num_labels = num_labels
        self.add_global = add_global_imgfeat
        self.norm_embeddings = norm_embeddings
        self.code_mixer = code_mixer
        self._epoch = 0

        self._tok_cache: dict[int, tuple] = {}
        if code_mixer is None:     # static questions -> pre-tokenize
            for i, e in enumerate(entries):
                self._tok_cache[i] = encode_padded(tokenizer, e.question,
                                                   max_seq_length)

    def __len__(self):
        return len(self.entries)

    def set_epoch(self, epoch: int):
        """Vary the code-mix realization across epochs (the augmentation
        seed folds (question_id, epoch)); no-op without a mixer."""
        self._epoch = int(epoch)

    def _tokens(self, i: int):
        if i in self._tok_cache:
            return self._tok_cache[i]
        e = self.entries[i]
        q = self.code_mixer(e.question, sample_key=(e.question_id, self._epoch))
        return encode_padded(self.tokenizer, q, self.max_seq_length)

    def make_batch(self, indices: list[int], *,
                   with_features: bool = True) -> dict[str, np.ndarray]:
        """Fixed-shape host batch: the model's batch keys plus labels /
        has_label / question_id / valid. with_features=False skips the
        feature assembly and emits 'store_idx' instead (for the device
        feature bank, data/device_bank.py)."""
        B = len(indices)
        T = self.max_seq_length
        ids = np.full((B, T), self.tokenizer.pad_id, np.int32)
        imask = np.zeros((B, T), np.int32)
        labels = np.zeros((B,), np.int32)
        has_label = np.zeros((B,), np.float32)
        qids = np.zeros((B,), np.int64)
        valid = np.ones((B,), np.float32)
        store_idx = np.zeros((B,), np.int64)

        id2idx = self.store.id2idx
        for j, i in enumerate(indices):
            e = self.entries[i]
            t, m, _ = self._tokens(i)
            ids[j], imask[j] = t, m
            qids[j] = e.question_id
            store_idx[j] = id2idx[str(e.image_id)]
            if e.labels:
                # GQA is single-label with scores == [1.0]; take the
                # max-SCORE label (the reference argmaxes target.long(),
                # which differs only for soft scores < 1.0, absent from
                # every shipped GQA/xGQA pkl)
                scores = e.scores if e.scores else [1.0] * len(e.labels)
                labels[j] = e.labels[int(np.argmax(scores))]
                has_label[j] = 1.0
        out = {
            "input_ids": ids, "input_mask": imask,
            "labels": labels, "has_label": has_label,
            "question_id": qids, "valid": valid,
        }
        if with_features:
            feats, locs, mask = self.store.gather(
                store_idx, max_regions=self.max_region_num,
                num_locs=self.num_locs, norm_embeddings=self.norm_embeddings,
                add_global_imgfeat=self.add_global)
            out.update({"features": feats, "locs": locs, "image_mask": mask})
        else:
            out["store_idx"] = store_idx.astype(np.int32)
        return out

    def iter_batches(self, batch_size: int, *, with_features: bool = True):
        """Fixed-size batches in entry order; the tail batch is padded by
        repeating its last entry with ``valid=0`` on the pad rows."""
        n = len(self.entries)
        for s in range(0, n, batch_size):
            chunk = list(range(s, min(s + batch_size, n)))
            n_real = len(chunk)
            chunk += [chunk[-1]] * (batch_size - n_real)
            b = self.make_batch(chunk, with_features=with_features)
            b["valid"][n_real:] = 0.0
            yield b
