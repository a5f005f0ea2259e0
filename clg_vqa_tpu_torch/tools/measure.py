"""Timers, the byte and operation bound, and the C4 rois that
``chip_smoke.py``, ``tools/host_cost.py`` and ``tools/kernel_bits.py``
share. Imports nothing of the package, so a tool that imports another
checkout's package (``sys.path.insert(0, ROOT)``) can import this file from
its own directory as the top-level module ``measure``. Needs a CUDA device.
"""
from __future__ import annotations

import statistics
import time

import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """The least time the card takes to move nbytes and do ops operations
    of dtype, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, n: int = 25) -> float:
    """Median of n CUDA-event timings of fn(), after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_us(fn, n: int = 10) -> dict[str, float]:
    """Device microseconds per call of each kernel fn() launches, from
    torch.profiler over n calls after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = us if us is not None else getattr(e, "self_cuda_time_total", 0)
        if us and str(e.device_type).endswith("CUDA"):
            out[e.key.replace("(anonymous namespace)::", "")[:60]] = us / n
    return out


def host_us(fn, n: int = 50) -> float:
    """Host microseconds per call of fn(): n calls enqueued back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def c4_rois(gen: torch.Generator, n: int = 300) -> torch.Tensor:
    """RoIPool's (B6) rois at the C4 extractor's shape: n - 4 random ones
    over the padded 800 x 1344 image, then one past every edge, a point,
    one with x2 < x1 and one past the bottom-right corner, on gen's device."""
    dev = gen.device
    x1 = torch.rand(n - 4, device=dev, generator=gen) * 1300
    y1 = torch.rand(n - 4, device=dev, generator=gen) * 790
    wh = torch.rand(n - 4, 2, device=dev, generator=gen) * torch.tensor(
        [600.0, 450.0], device=dev)
    return torch.cat([torch.stack([x1, y1, x1 + wh[:, 0], y1 + wh[:, 1]], 1),
                      torch.tensor([[-80.0, -80.0, 1500.0, 900.0],
                                    [200.0, 100.0, 200.0, 100.0],
                                    [400.0, 300.0, 360.0, 250.0],
                                    [1330.0, 790.0, 1800.0, 1200.0]], device=dev)])
