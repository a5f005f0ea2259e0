"""Where the time of one whole-block attention call (B4) goes on the GPU.

    python3 -m clg_vqa_tpu_torch.tools.profile_block [--out PATH]

Times ops/block_attention.fused_attention_block forward and backward at the
fine-tune step's shapes (x [128, 76, 768] bf16, 12 heads of 64, rate 0.1;
random operands from seed 0) with CUDA events (median of 25 after 3
warm-ups), the same block through the "flat" route (the bf16 linear, B1,
the linear) beside it, then device time per kernel over 5 forward and
backward pairs under torch.profiler. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys

import torch

from ..models.layers import linear
from ..ops.attention import fused_attention_train_flat
from ..ops.block_attention import fused_attention_block

B, S, H, HD, RATE, PAIRS = 128, 76, 12, 768, 0.1, 5


def time_ms(fn, n: int = 25) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def flat_route(x, wq, bq, wk, bk, wv, bv, wo, bo, bias, num_heads, **kw):
    """fused_attention_block's function through the "flat" route: the bf16
    linear (cuBLAS product, fp32 bias pass, cast; F.linear in fp32) for q, k
    and v, B1, the linear for o."""
    cd = None if x.dtype == torch.float32 else x.dtype
    q, k, v = (linear(x, w, b, cd) for w, b in ((wq, bq), (wk, bk), (wv, bv)))
    ctx = fused_attention_train_flat(q, k, v, bias, num_heads, **kw)
    return linear(ctx, wo, bo, cd)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_block: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(0)
    ops = [torch.randn(B, S, HD, device="cuda", generator=g).bfloat16()]
    for _ in range(4):
        ops += [(torch.randn(HD, HD, device="cuda", generator=g) / HD ** 0.5).bfloat16(),
                torch.randn(HD, device="cuda", generator=g) * 0.1]
    ops.append(torch.zeros(B, 1, 1, S, device="cuda"))
    kw = dict(dropout_rate=RATE, seed=1)
    ins = [t.detach().requires_grad_() for t in ops]
    dy = torch.randn(B, S, HD, device="cuda", generator=g).bfloat16()
    lines = [f"B4 at x [{B}, {S}, {HD}] bf16, {H} heads, rate {RATE}, on "
             f"{torch.cuda.get_device_name(0)}"]
    for name, fn in (("B4", fused_attention_block), ("flat route", flat_route)):
        with torch.no_grad():
            fwd = time_ms(lambda: fn(*ops, H, **kw))
        y = fn(*ins, H, **kw)
        bwd = time_ms(lambda: torch.autograd.grad(y, ins, dy, retain_graph=True))
        lines.append(f"{name}: forward {fwd:.4f} ms, backward {bwd:.4f} ms "
                     f"(CUDA events, median of 25)")
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PAIRS):
            y = fused_attention_block(*ins, H, **kw)
            torch.autograd.grad(y, ins, dy)
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / PAIRS
    lines.append(f"B4 device time per forward and backward pair "
                 f"({sum(per.values()):.4f} ms in all):")
    for name, ms in sorted(per.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {ms:8.4f} ms  {name[:110]}")
    text = "\n".join(lines)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
