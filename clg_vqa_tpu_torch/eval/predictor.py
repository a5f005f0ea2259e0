"""Serving-style predictor (port of clg_vqa_tpu/eval/predictor.py:18-81):
question + image id -> answer string and its softmax confidence.

The region store lives on the device (data/device_bank.py); each request is
tokenized on the host and requests are padded to a fixed micro-batch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.device_bank import DeviceFeatureBank
from ..data.tokenizer import encode_padded


class Predictor:
    """Runs on the model's device (a UC2 or an M3P; M3P callers pass
    ``max_region_num=100``); serving-size batches take the plain attention
    path, as in the JAX package."""

    def __init__(self, model, store, tokenizer, label2ans: list, *,
                 max_seq_length: int = 40, max_region_num: int = 36,
                 batch_capacity: int = 8, compute_dtype=torch.bfloat16):
        self.model = model
        self.tok = tokenizer
        self.label2ans = label2ans
        self.T = max_seq_length
        self.cap = batch_capacity
        self.compute_dtype = compute_dtype
        self.device = model.device
        cfg = model.cfg
        self.bank = DeviceFeatureBank(
            store, max_regions=max_region_num, num_locs=cfg.num_locs,
            norm_embeddings=getattr(cfg, "norm_embeddings", False),
            add_global_imgfeat=getattr(cfg, "add_global_imgfeat", None),
            device=self.device)

    @torch.inference_mode()
    def _step(self, ids, mask, sidx):
        f, l, m = DeviceFeatureBank.gather_from(self.bank.tensors(), sidx)
        logits = self.model({"input_ids": ids, "input_mask": mask,
                             "features": f, "locs": l, "image_mask": m},
                            deterministic=True,
                            compute_dtype=self.compute_dtype)
        conf = torch.softmax(logits.float(), dim=-1).max(dim=-1).values
        return torch.argmax(logits, dim=-1), conf

    def predict(self, question: str, image_id: str) -> dict:
        return self.predict_batch([(question, image_id)])[0]

    def predict_batch(self, requests: list[tuple[str, str]]) -> list[dict]:
        # validate up front: a bad id mid-batch must not discard the
        # already-computed chunks
        unknown = [img for _, img in requests
                   if str(img) not in self.bank.id2idx]
        if unknown:
            raise ValueError(
                f"unknown image_id(s) not in the serving feature bank: "
                f"{unknown[:5]}{'...' if len(unknown) > 5 else ''}")
        out = []
        for s in range(0, len(requests), self.cap):
            chunk = requests[s:s + self.cap]
            ids = np.full((self.cap, self.T), self.tok.pad_id, np.int32)
            mask = np.zeros((self.cap, self.T), np.int32)
            sidx = np.zeros((self.cap,), np.int32)
            for j, (q, img) in enumerate(chunk):
                t, m, _ = encode_padded(self.tok, q, self.T)
                ids[j], mask[j] = t, m
                sidx[j] = self.bank.id2idx[str(img)]
            pred, conf = self._step(*(torch.from_numpy(a).to(self.device)
                                      for a in (ids, mask, sidx)))
            pred, conf = pred.cpu().numpy(), conf.cpu().numpy()
            out += [{"answer": self.label2ans[int(pred[j])],
                     "confidence": float(conf[j])} for j in range(len(chunk))]
        return out
