"""Bank row gather: the CUDA kernel ``csrc/rows_gather.cu`` and its plain
PyTorch version.

Port of clg_vqa_tpu/ops/bank_gather.py:rows_gather (:34-59), which copies
``bank[idx[i]]`` into output row i, one DMA per row. The result is bit-exact
with ``bank[idx]`` for every dtype.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build


@functools.cache
def _kernel():
    fn = _build.load("rows_gather").rows_gather
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rows_gather_plain(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``index_select`` on the leading axis."""
    return torch.index_select(bank, 0, idx)


def rows_gather(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """bank [N, ...], idx [B] int32 -> [B, ...] == bank[idx].

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. The kernel copies 16-byte vectors, so a row must be a multiple
    of 16 bytes. Out-of-range indices trap inside the kernel, which keeps
    the call free of a host synchronisation."""
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be a 1-D int32 tensor, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if bank.dim() < 1 or idx.device != bank.device:
        raise ValueError("bank needs a leading row axis on idx's device")
    if torch.is_grad_enabled() and bank.requires_grad:
        raise RuntimeError("rows_gather has no backward: gather from a bank "
                           "that does not require grad, or under "
                           "torch.no_grad()")
    if bank.device.type == "cpu":
        return rows_gather_plain(bank, idx)
    if bank.device.type != "cuda":
        raise ValueError(f"unsupported device {bank.device}")
    bank = bank.contiguous()
    idx = idx.contiguous()
    n_rows = bank.shape[0]
    row_bytes = bank[0].numel() * bank.element_size() if n_rows else 0
    if row_bytes % 16 or bank.data_ptr() % 16:
        raise ValueError(f"rows of {row_bytes} bytes are not 16-byte vectors")
    out = torch.empty((idx.shape[0],) + tuple(bank.shape[1:]),
                      dtype=bank.dtype, device=bank.device)
    if idx.shape[0] == 0:
        return out
    err = _kernel()(bank.data_ptr(), idx.data_ptr(), out.data_ptr(), n_rows,
                    row_bytes, idx.shape[0],
                    torch.cuda.current_stream(bank.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rows_gather kernel launch failed: CUDA error {err}")
    rows_gather.launches += 1
    return out


rows_gather.launches = 0
