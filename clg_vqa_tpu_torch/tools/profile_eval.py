"""Where the time of one full-width UC2 or M3P eval goes on the GPU.

    python3 -m clg_vqa_tpu_torch.tools.profile_eval [--m3p]
        [--no-fused | --blocked] [--out PATH]

Builds UC2 (M3P with --m3p) at its published width (random weights from
seed 0) and the synthetic eval data and device feature bank of
chip_smoke.py (data/synthetic.eval_world, m3p_world), runs run_eval over 4
batches of 1024 once untraced (QA/s) and once under torch.profiler, and
prints device time by kernel group (GEMM, attention, bank gather, the
rest), the device's busy share of the traced window and the top kernels.
The attention is the flat eval kernel (K1) by default, the head-blocked one
(B2, fused_attn=True) with --blocked, the plain path with --no-fused; in
bf16 both kernels are one device code (csrc/attention_eval.cuh), so the
two routes differ by B2's head split and merge copies.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

from ..config import M3PConfig, UC2Config
from ..data.synthetic import eval_world, m3p_world
from ..eval.runner import make_predict_step, run_eval
from ..models.m3p import M3P
from ..models.uc2 import UC2

BATCHES, BS = 4, 1024

GROUPS = (("eval attention, bf16 (K1/B2)", ("attn_eval",)),
          ("flat_attention, fp32 (K1)", ("flat_attention_kernel",)),
          ("blocked attention, fp32 (B2)", ("fwd_kernel<",)),
          ("rows_gather", ("rows_gather_kernel",)),
          ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "sm90_", "cublas")),
          ("softmax", ("softmax",)),
          ("reduce (LayerNorm means)", ("reduce",)))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other elementwise / copy"


def union_us(intervals) -> float:
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def device_kernels(events) -> list:
    """The profiler's device events that are kernels or copies. Each
    ``record_function`` range (the program's ``train.*`` and ``eval.*``
    spans) also lies on the device's timeline as a user annotation over
    the kernels it launched; those are left out."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def model_and_world(m3p: bool, directory: str, n_qa: int):
    """(config, model on the card from seed 0, synthetic world of n_qa
    questions) at UC2's or M3P's published width."""
    cfg = M3PConfig() if m3p else UC2Config()
    model = (M3P if m3p else UC2)(cfg, device="cuda", seed=0)
    world = (m3p_world if m3p else eval_world)(
        directory, n_qa, num_labels=cfg.num_labels,
        vocab_size=cfg.vocab_size, device="cuda")
    return cfg, model, world


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m3p", action="store_true", help="M3P instead of UC2")
    route = ap.add_mutually_exclusive_group()
    route.add_argument("--no-fused", action="store_true",
                       help="plain attention path instead of the flat kernel")
    route.add_argument("--blocked", action="store_true",
                       help="the head-blocked eval kernel (B2) instead of K1")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_eval: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False

    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        n = BATCHES * BS
        cfg, model, w = model_and_world(args.m3p, tmp, n)
        ds, label2ans = w.dataset, w.label2ans
        fused = False if args.no_fused else True if args.blocked else "flat"
        step = make_predict_step(model, device_bank=w.bank, fused_attn=fused)
        kw = dict(batch_size=BS, device_bank=w.bank, step=step)
        run_eval(model, ds, label2ans, **kw)                      # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_eval(model, ds, label2ans, **kw)
        dt = time.perf_counter() - t0
        lines.append(f"untraced: {'M3P' if args.m3p else 'UC2'}, {n} QA in "
                     f"{dt:.4f} s -> {n / dt:.1f} QA/s "
                     f"(bs {BS}, bf16, fused_attn={fused}) on "
                     f"{torch.cuda.get_device_name(0)}")

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run_eval(model, ds, label2ans, **kw)
            torch.cuda.synchronize()
            traced = time.perf_counter() - t0

    kernels = device_kernels(prof.events())
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
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
    lines.append(f"traced: host {traced * 1e3:.2f} ms; device window "
                 f"{window / 1e3:.2f} ms, busy {busy / 1e3:.2f} ms "
                 f"({100 * busy / window:.1f}% of the window, idle "
                 f"{100 * (1 - busy / window):.1f}%); {len(kernels)} kernels, "
                 f"{total / 1e3 / BATCHES:.2f} ms of kernel time per batch")
    for g, t in sorted(by_group.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {g:28s} {t / 1e3:10.3f} ms  {100 * t / total:5.1f}%")
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
