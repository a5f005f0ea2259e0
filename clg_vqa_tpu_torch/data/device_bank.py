"""Device-resident feature bank (port of clg_vqa_tpu/data/device_bank.py:19-72).

The processed region store is uploaded to the device once; each batch then
carries only token ids and int32 store indices, and its [B, R, D] features
are gathered on the device by the bank row-gather kernel
(ops/bank_gather.rows_gather).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops.bank_gather import rows_gather


class DeviceFeatureBank:
    """The whole store on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``): features [N, R, D], locs [N, R, num_locs], image
    mask [N, R] int32."""

    def __init__(self, reader, *, max_regions: int, num_locs: int = 5,
                 norm_embeddings: bool = False,
                 add_global_imgfeat: str | None = None,
                 dtype=torch.float32, device=None):
        dev = resolve_device(device)
        feats, locs, mask = reader.gather(
            np.arange(reader.n_records), max_regions=max_regions,
            num_locs=num_locs, norm_embeddings=norm_embeddings,
            add_global_imgfeat=add_global_imgfeat)
        self.features = torch.from_numpy(feats).to(dev, dtype)
        self.locs = torch.from_numpy(locs).to(dev, dtype)
        self.image_mask = torch.from_numpy(mask).to(dev, torch.int32)
        self.id2idx = dict(reader.id2idx)
        self.nbytes = sum(t.numel() * t.element_size() for t in self.tensors())

    def tensors(self):
        """(features, locs, image_mask)."""
        return (self.features, self.locs, self.image_mask)

    def lookup(self, store_idx):
        """(features, locs, image_mask) of the rows ``store_idx`` [B] (a
        tensor or an array of store indices) on the bank's device."""
        idx = torch.as_tensor(store_idx).to(self.features.device, torch.int32)
        return self.gather_from(self.tensors(), idx)

    def fill_batch(self, batch: dict) -> dict:
        """A copy of ``batch`` with its 'store_idx' field replaced by the
        gathered features, locs and image_mask."""
        f, l, m = self.lookup(batch["store_idx"])
        out = {k: v for k, v in batch.items() if k != "store_idx"}
        out.update({"features": f, "locs": l, "image_mask": m})
        return out

    @staticmethod
    def gather_from(tensors, store_idx: torch.Tensor):
        """Rows ``store_idx`` [B] int32 of the bank tensors. The features go
        through the row-gather kernel (bit-exact with ``bank[idx]``); the
        small locs and mask use plain indexing, as in the JAX package."""
        f, l, m = tensors
        return rows_gather(f, store_idx), l[store_idx], m[store_idx]
