"""Small MLP probe head (port of clg_vqa_tpu/models/mlp.py; volta/volta/mlp.py:6-49:
a Linear -> activation -> dropout stack, off the main CLG-VQA path but part
of the model family)."""
from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from . import layers as L


class MLP(nn.Module):
    """Linears of widths ``dims`` (xavier-uniform, zero bias), each but the
    last followed by ``act`` and, with a seed, u8 dropout whose stream is
    ``fold_seed(seed, i)`` for layer i."""

    def __init__(self, dims: list[int], *, device=None, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.layers = nn.ModuleList(
            L.Linear(dims[i], dims[i + 1], device=dev, dtype=dtype)
            for i in range(len(dims) - 1))
        self.init_weights(torch.Generator(dev).manual_seed(seed))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for lin in self.layers:
            lin.init_xavier_(generator)

    def forward(self, x, *, dropout_prob: float = 0.0, seed: int | None = None,
                compute_dtype=None, act=torch.relu):
        """seed None is the deterministic forward."""
        for i, lin in enumerate(self.layers):
            x = lin(x, compute_dtype)
            if i < len(self.layers) - 1:
                x = L.dropout(act(x), dropout_prob,
                              L.generator(L.fold_seed(seed, i), x.device))
        return x
