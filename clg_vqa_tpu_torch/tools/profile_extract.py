"""Where the time of the full-width R101-C4 extraction goes on the GPU.

    python3 -m clg_vqa_tpu_torch.tools.profile_extract [--device_batch N]
        [--out PATH]

Builds Extractor36 at full width and depth (R101-C4, pad 800 x 1344, bf16,
random weights from seed 0), makes 8 synthetic 480 x 640 uint8 images (the
chip_smoke.py extraction phase's), warms up on 2, runs all 8 once untraced
(images/s) and 4 under torch.profiler, and prints the host time of each
pipeline stage (the ``extract.*`` ranges: a stage's host span holds its
launches and, for the NMS loops, is where the host sets the pace), device
time by kernel group, the device's busy share of the traced window and the
top kernels. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..models.detector.extractor import (Extractor36, ExtractorConfig,
                                         init_extractor_params)
from .profile_eval import union_us

N_IMAGES, N_TRACED, HW = 8, 4, (480, 640)

GROUPS = (("roi_pool (B6)", ("roi_pool_kernel",)),
          ("conv / GEMM", ("conv", "gemm", "nvjet", "cutlass", "xmma", "sm90_",
                           "cudnn", "implicit", "wgrad", "dgrad", "nhwc")),
          ("sort / top-k", ("sort", "radix", "topk")),
          ("resize (interpolate)", ("upsample", "interp", "aa_")),
          ("reduce / argmax", ("reduce", "argmax", "max_")),
          ("index / gather / scatter", ("index", "gather", "scatter")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other elementwise / copy"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device_batch", type=int, default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_extract: CUDA is not available", file=sys.stderr)
        return 1
    r = np.random.RandomState(0)
    items = [((r.rand(*HW, 3) * 255).astype(np.uint8), f"im{i}")
             for i in range(N_IMAGES)]
    ex = Extractor36(init_extractor_params(torch.Generator().manual_seed(0)),
                     ExtractorConfig(), device="cuda")
    kw = dict(device_batch=args.device_batch)
    list(ex.extract_many(items[:2], **kw))                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    list(ex.extract_many(items, **kw))
    dt = time.perf_counter() - t0
    lines = [f"untraced: {N_IMAGES} images of {HW[0]} x {HW[1]} in {dt:.4f} s -> "
             f"{N_IMAGES / dt:.3f} images/s (R101-C4, pad 800 x 1344, bf16, "
             f"device_batch {args.device_batch}) on {torch.cuda.get_device_name(0)}"]

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        list(ex.extract_many(items[:N_TRACED], **kw))
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0

    events = prof.events()
    # the device timeline also holds each ``extract.*`` range as a user
    # annotation spanning its kernels; those are not kernels
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("extract.")]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    stages: dict[str, float] = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("extract."):
            d = e.time_range.end - e.time_range.start
            stages[e.name] = stages.get(e.name, 0.0) + d
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    busy = union_us(spans)
    by_group: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        by_group[group_of(e.name)] = by_group.get(group_of(e.name), 0.0) + d
        s = by_name.setdefault(e.name, [0, 0.0])
        s[0] += 1
        s[1] += d
    total = sum(by_group.values())
    lines.append(f"traced {N_TRACED} images: host {traced * 1e3:.2f} ms; device "
                 f"window {window / 1e3:.2f} ms, busy {busy / 1e3:.2f} ms "
                 f"({100 * busy / window:.1f}% of the window, idle "
                 f"{100 * (1 - busy / window):.1f}%); {len(kernels)} kernels, "
                 f"{total / 1e3 / N_TRACED:.2f} ms of kernel time per image")
    lines.append("host time per stage, per image (ms):")
    for name, t in sorted(stages.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {name:24s} {t / 1e3 / N_TRACED:10.3f}")
    lines.append("device time by group, per image (ms, share):")
    for g, t in sorted(by_group.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {g:28s} {t / 1e3 / N_TRACED:10.3f}  {100 * t / total:5.1f}%")
    lines.append("top kernels (count, total ms, share):")
    for name, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:20]:
        lines.append(f"  {c:6d} {t / 1e3:9.3f} {100 * t / total:5.1f}%  {name[:110]}")
    text = "\n".join(lines)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
