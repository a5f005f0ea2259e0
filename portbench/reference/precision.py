"""The precision of the reference's products.

``FP32``: every product in float32 (TF32 off, :func:`fp32_products`).
``FP8``: the control, the program's precision one step down. Where the
program takes bf16 operands and rounds a Linear's output to bf16, the
control rounds each operand of every product, and each Linear's output, to
float8 e4m3 with a per-tensor scale (its absolute maximum onto 448), and
each gradient that flows back through them to e5m2 (onto 57344), the usual
fp8 training recipe; the products accumulate in float32. Where the
program rounds a dropout's rescale 256/t to the dtype of the activation it
scales (bf16 for a Linear's output), the control rounds it to e4m3. It is
the precision below the bf16 compute that the configurations state."""
from __future__ import annotations

import contextlib

import torch

_E4M3_MAX, _E5M2_MAX = 448.0, 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().max().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, _E5M2_MAX)


class Precision:
    def __init__(self, name: str):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product, or a Linear's output, in this precision."""
        return x if self.name == "fp32" else _Fp8.apply(x)


    def scale(self, s: float) -> float:
        """A dropout rescale applied to a compute-dtype activation."""
        if self.name == "fp32":
            return s
        return float(torch.tensor(s).to(torch.float8_e4m3fn).float())


FP32 = Precision("fp32")
FP8 = Precision("fp8")


@contextlib.contextmanager
def fp32_products():
    """Float32 products on the card: TF32 off for the block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
