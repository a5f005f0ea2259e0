"""Where the time of a full-width region-feature extraction goes on the GPU.

    python3 -m clg_vqa_tpu_torch.tools.profile_extract [--detector c4|x101]
        [--device_batch N] [--out PATH]

Builds the extractor at full width and depth (``c4``: Extractor36, R101-C4;
``x101``: ExtractorX101, X-101 64x4d FPN 512, 1000 proposals, 100 boxes;
pad 800 x 1344, bf16, random weights from seed 0), makes 8 synthetic
480 x 640 uint8 images (the chip_smoke.py extraction phase's), warms up,
runs all 8 once untraced (images/s) and 4 under torch.profiler, and prints
the host time of each pipeline stage (the ``extract.*`` ranges: a stage's
host span holds its launches and, for the NMS loops, is where the host sets
the pace), device time by stage (each kernel counted in the innermost
``extract.*`` range its start falls in) and by stage group (convs,
RoIAlign or RoIPool, NMS and top-k, GEMMs), device time by kernel-name
group, the device's busy share of the traced window, the launches an image,
the fixpoint NMS's host reads an image and the top kernels. fp32 convs and
GEMMs run without TF32, as in chip_smoke.py. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..ops.nms import batched_nms_fixpoint
from .profile_eval import union_us

N_IMAGES, N_TRACED, HW = 8, 4, (480, 640)

GROUPS = (("roi_pool (B6)", ("roi_pool_kernel",)),
          ("conv / GEMM", ("conv", "gemm", "nvjet", "cutlass", "xmma", "sm90_",
                           "cudnn", "implicit", "wgrad", "dgrad", "nhwc")),
          ("sort / top-k", ("sort", "radix", "topk")),
          ("resize (interpolate)", ("upsample", "interp", "aa_")),
          ("reduce / argmax", ("reduce", "argmax", "max_")),
          ("index / gather / scatter", ("index", "gather", "scatter")))

STAGE_GROUPS = {"extract.backbone": "convs", "extract.fpn": "convs",
                "extract.rpn_head": "convs", "extract.res5": "convs",
                "extract.roi_align": "RoIAlign", "extract.roi_pool": "RoIPool (B6)",
                "extract.propose": "NMS / top-k", "extract.select": "NMS / top-k",
                "extract.box_head": "GEMMs", "extract.heads": "GEMMs"}
OUTSIDE = "outside the pipeline (preprocessing, copies)"


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other elementwise / copy"


def stage_of(start: float, ranges: list) -> str:
    """The innermost ``extract.*`` device range holding ``start``."""
    best = None
    for name, s, e in ranges:
        if s <= start < e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else OUTSIDE


def build(detector: str):
    if detector == "c4":
        from ..models.detector.extractor import (Extractor36, ExtractorConfig,
                                                 init_extractor_params)
        return (Extractor36(init_extractor_params(torch.Generator().manual_seed(0)),
                            ExtractorConfig(), device="cuda"),
                "R101-C4, pad 800 x 1344, bf16")
    from ..models.detector.extractor_x101 import (ExtractorX101, X101Config,
                                                  init_x101_params)
    return (ExtractorX101(init_x101_params(torch.Generator().manual_seed(0)),
                          X101Config(), device="cuda"),
            "X-101 64x4d FPN 512, 1000 proposals, 100 boxes, pad 800 x 1344, bf16")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--detector", choices=("c4", "x101"), default="c4")
    ap.add_argument("--device_batch", type=int, default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_extract: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = np.random.RandomState(0)
    items = [((r.rand(*HW, 3) * 255).astype(np.uint8), f"im{i}")
             for i in range(N_IMAGES)]
    ex, what = build(args.detector)
    kw = dict(device_batch=args.device_batch)
    list(ex.extract_many(items[:max(2, args.device_batch)], **kw))    # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    list(ex.extract_many(items, **kw))
    dt = time.perf_counter() - t0
    lines = [f"untraced: {N_IMAGES} images of {HW[0]} x {HW[1]} in {dt:.4f} s -> "
             f"{N_IMAGES / dt:.3f} images/s ({what}, device_batch "
             f"{args.device_batch}) on {torch.cuda.get_device_name(0)}"]

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    syncs = batched_nms_fixpoint.host_syncs
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        list(ex.extract_many(items[:N_TRACED], **kw))
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    syncs = batched_nms_fixpoint.host_syncs - syncs

    events = prof.events()
    is_cuda = [e.device_type == torch.autograd.DeviceType.CUDA for e in events]
    # the device timeline also holds each ``extract.*`` range as a user
    # annotation spanning its kernels; those are not kernels
    ranges = [(e.name, e.time_range.start, e.time_range.end)
              for e, c in zip(events, is_cuda) if c and e.name.startswith("extract.")]
    kernels = [e for e, c in zip(events, is_cuda)
               if c and not e.name.startswith("extract.")]
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
    by_stage: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        by_group[group_of(e.name)] = by_group.get(group_of(e.name), 0.0) + d
        st = stage_of(e.time_range.start, ranges)
        by_stage[st] = by_stage.get(st, 0.0) + d
        s = by_name.setdefault(e.name, [0, 0.0])
        s[0] += 1
        s[1] += d
    by_stage_group: dict[str, float] = {}
    for st, d in by_stage.items():
        g = STAGE_GROUPS.get(st, OUTSIDE)
        by_stage_group[g] = by_stage_group.get(g, 0.0) + d
    total = sum(by_group.values())
    lines.append(f"traced {N_TRACED} images: host {traced * 1e3:.2f} ms; device "
                 f"window {window / 1e3:.2f} ms, busy {busy / 1e3:.2f} ms "
                 f"({100 * busy / window:.1f}% of the window, idle "
                 f"{100 * (1 - busy / window):.1f}%); {len(kernels)} kernels "
                 f"({len(kernels) / N_TRACED:.0f} launches an image), "
                 f"{total / 1e3 / N_TRACED:.2f} ms of kernel time per image; "
                 f"fixpoint NMS host reads {syncs / N_TRACED:.1f} an image")
    lines.append("host time per stage, per image (ms):")
    for name, t in sorted(stages.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {name:24s} {t / 1e3 / N_TRACED:10.3f}")
    for title, table in (("device time by stage group", by_stage_group),
                         ("device time by stage", by_stage),
                         ("device time by kernel-name group", by_group)):
        lines.append(f"{title}, per image (ms, share):")
        for g, t in sorted(table.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {g:44s} {t / 1e3 / N_TRACED:10.3f}  {100 * t / total:5.1f}%")
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
