"""Profiling and observability (port of clg_vqa_tpu/utils/profiling.py on
``torch.profiler`` and ``torch.cuda``):

 - ``trace(logdir)``: a torch.profiler trace of the enclosed code (the host
   and, when CUDA is available, the card's kernels), written as a Chrome
   trace to ``<logdir>/trace.json``;
 - ``StepTimer``: step timing with warm-up skipping and a percentile
   summary (JAX's keys: n, mean_ms, p50_ms, p95_ms); it synchronises the
   CUDA device when one is in use, so it times the card's work and not the
   launches;
 - ``device_memory_stats()``: per-device bytes in use, peak and limit.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed code; yields the ``torch.profiler.profile``
    (its ``key_averages()`` give the per-kernel times) and writes
    ``<logdir>/trace.json`` when the block ends."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """``with timer:`` around each step; the first ``warmup`` steps are not
    kept. Entering and leaving synchronise the CUDA device when it is in
    use."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: list[float] = []
        self._n = 0
        self._t = None

    def __enter__(self):
        _sync()
        self._t = time.perf_counter()
        return self

    def __exit__(self, *a):
        _sync()
        dt = time.perf_counter() - self._t
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)

    def summary(self) -> dict:
        if not self.times:
            return {"n": 0}
        t = np.asarray(self.times)
        return {"n": len(t), "mean_ms": float(t.mean() * 1e3),
                "p50_ms": float(np.percentile(t, 50) * 1e3),
                "p95_ms": float(np.percentile(t, 95) * 1e3)}


def device_memory_stats() -> list[dict]:
    """One dict per CUDA device: bytes_in_use and peak_bytes_in_use from
    PyTorch's allocator, bytes_limit the device's memory. Without CUDA, one
    entry for the CPU with the device's name only, as JAX's CPU devices
    report no memory stats."""
    if not torch.cuda.is_available():
        return [{"device": "cpu"}]
    return [{"device": f"cuda:{i}",
             "bytes_in_use": torch.cuda.memory_allocated(i),
             "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
             "bytes_limit": torch.cuda.get_device_properties(i).total_memory}
            for i in range(torch.cuda.device_count())]
