"""The train step's passes over every parameter tensor at once: the CUDA
kernels of ``csrc/multi_tensor.cu`` and their plain PyTorch versions.

 - :func:`accumulate`: a microbatch's gradients divided by the number of
   microbatches and added into :class:`GradBuffers` (the first microbatch
   writes them);
 - :func:`norm`: the global norm of (masked) tensors, from each tensor's
   sum of squares;
 - :func:`adamw`: train/optim.py's clip and pytorch_transformers AdamW over
   every parameter, in place; its plain version is that module's chain
   (``Optimizer.update`` and the masked ``p.add_``).

A kernel takes a table of chunks (tensor, offset) of at most ``CHUNK``
elements, built once per list of tensor sizes, and rows of the tensors'
pointers, built once per list of pointers; both stay on the device. CPU
tensors take the plain versions; CUDA tensors launch the kernels, and
raise on anything but contiguous fp32 tensors of one device. The kernels
round every step as the eager ops they replace do, so on the card they are
bit-equal to the plain versions (the norm's sums of squares excepted,
which are summed in another order).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

CHUNK = 1 << 16          # csrc/multi_tensor.cu kChunk
MAX_SOURCES = 400        # csrc/multi_tensor.cu kMaxSources: tensors a launch
ALIGN = 4                # a GradBuffers view starts on 16 bytes


def chunk_table(numels) -> tuple[np.ndarray, np.ndarray]:
    """(chunks, first): chunks [n_chunks, 2] int64, each (tensor, offset)
    of a run of min(CHUNK, numel - offset) elements, tensor by tensor in
    order; first [n + 1] int64, tensor t's chunks are first[t] ..
    first[t + 1] - 1. An empty tensor has no chunk."""
    counts = np.array([-(-int(n) // CHUNK) for n in numels], np.int64)
    first = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    tensor = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    offset = (np.arange(int(first[-1]), dtype=np.int64)
              - np.repeat(first[:-1], counts)) * CHUNK
    return np.stack([tensor, offset], 1), first


@functools.lru_cache(maxsize=16)
def _layout(numels: tuple, device: torch.device):
    """The chunk table of ``numels`` on ``device``: (chunks, numel, first,
    first on the host)."""
    chunks, first = chunk_table(numels)
    to = functools.partial(torch.tensor, dtype=torch.int64, device=device)
    return (to(chunks), to(list(numels)), to(first), first.tolist())


@functools.lru_cache(maxsize=16)
def _rows(ptrs: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(ptrs, dtype=torch.int64, device=device)


def _fn(name: str, argtypes: list):
    fn = getattr(_build.load("multi_tensor"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.cache
def _kernels():
    return {
        "accumulate": _fn("mt_accumulate", [_P, _P, _P, _P, _I, _I, _L, _I,
                                            _I, _F, _P]),
        "sum_squares": _fn("mt_sum_squares", [_P] * 5 + [_I, _I, _P, _P, _P]),
        "norm": _fn("mt_norm", [_P, _I, _P, _P]),
        "adamw": _fn("mt_adamw", [_P] * 3 + [_I, _I, _P] + [_F] * 8 + [_P]),
    }


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"multi_tensor {what} launch failed: CUDA error {err}")


def _pointers(tensors, numels, device: torch.device, what: str,
              optional: bool = False) -> list:
    """Each tensor's pointer, after checking that the kernel takes it: a
    contiguous fp32 tensor of ``numels[i]`` elements on ``device`` (None
    gives 0 where ``optional``)."""
    out = []
    for i, (t, n) in enumerate(zip(tensors, numels)):
        if t is None and optional:
            out.append(0)
            continue
        if (t is None or t.device != device or t.dtype != torch.float32
                or not t.is_contiguous() or t.numel() != n):
            raise ValueError(
                f"multi_tensor {what}[{i}]: the kernel takes contiguous "
                f"float32 tensors of {n} elements on {device}; got "
                + ("None" if t is None else
                   f"{t.dtype} {tuple(t.shape)} on {t.device}"
                   f"{'' if t.is_contiguous() else ', not contiguous'}"))
        out.append(t.data_ptr())
    return out


def _cuda(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")


def _dense(tensors) -> list:
    """``tensors`` (None kept), a contiguous copy of any that is not: the
    kernels read these, so a copy changes no result."""
    return [t if t is None or t.is_contiguous() else t.contiguous()
            for t in tensors]


class GradBuffers:
    """One flat fp32 buffer with a view per tensor of ``like`` (its shape,
    each view starting on 16 bytes): the gradients a train step
    accumulates, made once and reused by every step. ``flat`` holds every
    view (a dp all-reduce takes it whole); between views it holds zeros."""

    def __init__(self, like):
        like = list(like)
        self.shapes = tuple(t.shape for t in like)
        self.numels = tuple(t.numel() for t in like)
        self.device = like[0].device if like else torch.device("cpu")
        offsets, end = [], 0
        for n in self.numels:
            offsets.append(end)
            end += -(-n // ALIGN) * ALIGN
        self.flat = torch.zeros(end, dtype=torch.float32, device=self.device)
        self.views = [self.flat[o:o + n].view(s) for o, n, s in
                      zip(offsets, self.numels, self.shapes)]
        self._dst = None            # the views' pointer row on the device

    def fits(self, tensors) -> bool:
        """True where ``tensors`` have this buffer's shapes and device."""
        return (len(tensors) == len(self.shapes)
                and all(t.shape == s for t, s in zip(tensors, self.shapes))
                and (not tensors or tensors[0].device == self.device))


def accumulate_plain(dst, grads, *, first: bool, n: int) -> None:
    """dst[i] = (0 if first else dst[i]) + grads[i] / n, as the train step
    has always done it: a zero fill, then ``add_(g / n)``; a None gradient
    (``allow_unused``) adds nothing."""
    for d, g in zip(dst, grads):
        if first:
            d.zero_()
        if g is not None:
            d.add_(g / n)


def accumulate(buffers: GradBuffers, grads, *, first: bool, n: int) -> None:
    """Add one microbatch's ``grads`` (one per view, None for an unused
    parameter) divided by the number of microbatches ``n`` into
    ``buffers``; ``first`` overwrites them instead. One launch per
    ``MAX_SOURCES`` tensors; a non-contiguous gradient is copied first."""
    grads = list(grads)
    if len(grads) != len(buffers.views):
        raise ValueError(f"{len(grads)} gradients for {len(buffers.views)} "
                         f"buffers")
    dev = buffers.device
    if dev.type == "cpu":
        return accumulate_plain(buffers.views, grads, first=first, n=n)
    _cuda(dev)
    grads = _dense(grads)       # held until the launches
    src = _pointers(grads, buffers.numels, dev, "gradient", optional=True)
    chunks, numel, _, first_chunk = _layout(buffers.numels, dev)
    if buffers._dst is None:
        buffers._dst = _rows(tuple(v.data_ptr() for v in buffers.views), dev)
    fn = _kernels()["accumulate"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    inv_n = float(np.float32(1) / np.float32(n))
    for t0 in range(0, len(grads), MAX_SOURCES):
        t1 = min(t0 + MAX_SOURCES, len(grads))
        c0, c1 = first_chunk[t0], first_chunk[t1]
        _launched(fn(chunks.data_ptr(), numel.data_ptr(),
                     buffers._dst.data_ptr(),
                     (ctypes.c_void_p * (t1 - t0))(*src[t0:t1]), t0, t1 - t0,
                     c0, c1 - c0, int(first), inv_n, stream), "accumulate")
        accumulate.launches += 1


accumulate.launches = 0


def norm_plain(tensors, masks=None, reduce=None) -> torch.Tensor:
    """sqrt of the sum, in tensor order, of each tensor's ``(x * x).sum()``
    (x = t, or t * mask); ``reduce`` maps the stacked [n] sums first (an
    all-reduce of the sharded ones)."""
    if masks is not None:
        tensors = [t if m is None else t * m for t, m in zip(tensors, masks)]
    sq = [(t.float() * t.float()).sum() for t in tensors]
    if reduce is not None:
        sq = list(reduce(torch.stack(sq)).unbind())
    return torch.sqrt(sum(sq))


def norm(tensors, masks=None, reduce=None) -> torch.Tensor:
    """The global norm of ``tensors`` (each times its mask, None: none) as a
    0-d fp32 tensor on their device, without a host synchronisation.
    ``reduce`` maps the [n] fp32 sums of squares before they are added (it
    returns a contiguous [n] fp32 tensor). The kernels: one fp64 partial a
    chunk, the per-tensor sums (fixed order), then the ordered total and
    its root. Three launches; no atomics. A non-contiguous tensor or mask
    is copied first."""
    tensors = list(tensors)
    if not tensors:
        raise ValueError("norm of no tensors")
    dev = tensors[0].device
    if dev.type == "cpu":
        return norm_plain(tensors, masks, reduce)
    _cuda(dev)
    numels = tuple(t.numel() for t in tensors)
    tensors = _dense(tensors)   # held until the launches
    masks = None if masks is None else _dense(masks)
    g = _pointers(tensors, numels, dev, "tensor")
    m = (_pointers(masks, numels, dev, "mask", optional=True)
         if masks is not None else [0] * len(tensors))
    chunks, numel, first, first_host = _layout(numels, dev)
    rows = _rows(tuple(g) + tuple(m), dev)
    n = len(tensors)
    partial = torch.empty(first_host[-1], dtype=torch.float64, device=dev)
    sq = torch.empty(n, dtype=torch.float32, device=dev)
    k = _kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _launched(k["sum_squares"](chunks.data_ptr(), numel.data_ptr(),
                               first.data_ptr(), rows.data_ptr(),
                               rows.data_ptr() + 8 * n, n, first_host[-1],
                               partial.data_ptr(), sq.data_ptr(), stream),
              "sum_squares")
    if reduce is not None:
        sq = reduce(sq)
        _pointers([sq], [n], dev, "reduced sums")
    out = torch.empty((), dtype=torch.float32, device=dev)
    _launched(k["norm"](sq.data_ptr(), n, out.data_ptr(), stream), "norm")
    norm.launches += 3
    return out


norm.launches = 0


def adamw(params, mu, nu, grads, masks, decays, *, norm: torch.Tensor,
          b1: float, b2: float, eps: float, step, decay, max_norm: float) -> None:
    """train/optim.py's ``make_optimizer`` chain and the masked ``p.add_``,
    in place over every parameter, in one launch: g = grad (times its mask),
    clipped to ``max_norm`` by the global ``norm`` (a 0-d device tensor),
    the moments mu and nu, pytorch_transformers AdamW with the host fp32
    ``step`` and, where ``decays[i]``, the decoupled ``decay``, then
    p += (new_p - p) (times the mask). ``masks``: None or a list with None
    for a pass-through. CUDA tensors only: the plain version is the chain
    itself (``Optimizer.update`` and the masked add). Parameters and
    moments are updated in place, so they must be contiguous; a
    non-contiguous gradient or mask is copied first."""
    params = list(params)
    if not params:
        return
    dev = params[0].device
    _cuda(dev)
    n = len(params)
    numels = tuple(p.numel() for p in params)
    grads = _dense(grads)           # held until the launch
    masks = None if masks is None else _dense(masks)
    ptrs = (_pointers(params, numels, dev, "param")
            + _pointers(mu, numels, dev, "mu") + _pointers(nu, numels, dev, "nu")
            + _pointers(grads, numels, dev, "grad")
            + (_pointers(masks, numels, dev, "mask", optional=True)
               if masks is not None else [0] * n)
            + [int(bool(d)) for d in decays])
    _pointers([norm], [1], dev, "norm")
    chunks, numel, _, first_host = _layout(numels, dev)
    rows = _rows(tuple(ptrs), dev)
    _launched(_kernels()["adamw"](
        chunks.data_ptr(), numel.data_ptr(), rows.data_ptr(), n,
        first_host[-1], norm.data_ptr(), b1, 1 - b1, b2, 1 - b2, float(step),
        eps, float(decay), max_norm, torch.cuda.current_stream(dev).cuda_stream),
        "adamw")
    adamw.launches += 1


adamw.launches = 0
