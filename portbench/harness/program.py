"""The program under test, as a user builds it: the port's model (built by
its family) with the benchmark's weights loaded by name, its tokenizer, and
its GQA dataset over the store."""
from __future__ import annotations

import torch


def dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def holding(m: torch.nn.Module, weights: dict) -> torch.nn.Module:
    """The port's model ``m`` (a family's, portbench/families/) holding
    ``weights`` (float32, by checkpoint name) in place of its own init."""
    params = dict(m.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError(f"the model's weights differ from the benchmark's: "
                           f"{sorted(set(params) ^ set(weights))[:6]}")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(weights[k])
    return m


def tokenizer(d: dict):
    from clg_vqa_tpu_torch.data.tokenizer import HashTokenizer
    return HashTokenizer(d["vocab"])


def reader(world):
    from clg_vqa_tpu_torch.data.cfs import CfsReader
    return CfsReader(world.store)


def dataset(world, rows, d: dict, store, tok):
    """The port's GQADataset of QA rows ``rows`` (question ids = row
    numbers) over the store."""
    from clg_vqa_tpu_torch.data.gqa import Entry, GQADataset
    entries = [Entry(question_id=r, image_id=str(world.image_of[r]),
                     question=world.questions[r],
                     labels=None if world.labels is None else [world.labels[r]],
                     scores=None if world.labels is None else [1.0])
               for r in rows]
    return GQADataset(entries, store, tok, max_seq_length=d["text"],
                      max_region_num=d["regions"], num_locs=d["locs"],
                      num_labels=d["labels"], norm_embeddings=d["norm"])


def bank(store, d: dict, device):
    from clg_vqa_tpu_torch.data.device_bank import DeviceFeatureBank
    return DeviceFeatureBank(store, max_regions=d["regions"], num_locs=d["locs"],
                             norm_embeddings=d["norm"], device=device)


def label_names(d: dict) -> list[str]:
    return [f"a{i}" for i in range(d["labels"])]
