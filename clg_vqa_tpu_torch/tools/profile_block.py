"""Where the time of one whole-block attention call (B4) goes on the GPU.

    python3 -m clg_vqa_tpu_torch.tools.profile_block [--widths] [--out PATH]

Times ops/block_attention.fused_attention_block forward and backward at the
fine-tune step's shapes (x [128, 76, 768] bf16, 12 heads of 64, rate 0.1;
random operands from seed 0) with CUDA events (median of 25 after 3
warm-ups), the same block through the "flat" route (the bf16 linear, B1,
the linear) beside it, then device time per kernel over 5 forward and
backward pairs under torch.profiler, grouped into the core (the attention
kernels), the products (the wgmma products of csrc/gemm_wgmma.cuh) and the
reductions (the weight-gradient and head sums), each product kernel also at
its rate against the card's 989 TFLOP/s. ``--widths`` also times each of
B4's five products alone at both of gemm_wgmma's tile widths (128 x 128 and
128 x 256; device time a call over 10 calls under torch.profiler) beside
torch.mm's (cuBLAS) device time for the same product, the measurement that
chose each product's width in csrc/block_attention_train.cu. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys

import torch

from ..models.layers import linear
from ..ops.attention import fused_attention_train_flat
from ..ops.block_attention import fused_attention_block, wgmma_product

B, S, H, HD, RATE, PAIRS = 128, 76, 12, 768, 0.1, 5
PEAK = 989e12       # bf16 dense FLOP/s of one H100 SXM
# a product kernel's leading template arguments -> its use
PRODUCTS = {"gemm_kernel<true, true, 0,": "q|k|v and out (bias)",
            "gemm_kernel<true, false, 1,": "dctx (hi/lo)",
            "gemm_kernel<false, false, 2,": "dW, db (wgrad)",
            "gemm_kernel<true, false, 3,": "dx (sum)"}
GROUPS = (("core", ("attn_train_mma", "attn_train")), ("products", ("gemm_kernel", "b4_fp32")),
          ("reductions", ("wgrad_reduce", "head_sum")))


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


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


def device_ms(fn, name: str, n: int = 10) -> float:
    """Device time a call of fn, the kernels whose name holds ``name``
    summed over n calls under torch.profiler (after 3 warm-up calls)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum((e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name) / n


def widths(g) -> list[str]:
    """Each of B4's products alone at both tile widths and torch.mm's."""
    N = B * S
    r = lambda *s: torch.randn(*s, device="cuda", generator=g).bfloat16()  # noqa: E731
    x, w, dy = r(N, HD), [r(HD, HD) for _ in range(4)], [r(N, HD) for _ in range(4)]
    bias = [torch.randn(HD, device="cuda", generator=g) for _ in range(3)]
    uses = (
        ("q|k|v (bias, 3 jobs)", lambda wd: wgmma_product("bias", [x] * 3, w[:3], bias, wide=wd),
         lambda: [torch.mm(x, t.t()) for t in w[:3]], 6 * N * HD * HD),
        ("out (bias)", lambda wd: wgmma_product("bias", [x], w[:1], bias[:1], wide=wd),
         lambda: torch.mm(x, w[0].t()), 2 * N * HD * HD),
        ("dctx (hi/lo)", lambda wd: wgmma_product("hilo", [x], w[:1], wide=wd),
         lambda: torch.mm(x, w[0]), 2 * N * HD * HD),
        ("dW, db (wgrad, 4 jobs)", lambda wd: wgmma_product("wgrad", dy, [x] * 4, ksplit=4,
                                                            wide=wd),
         lambda: [torch.mm(t.t(), x) for t in dy], 8 * N * HD * HD),
        ("dx (sum, 3 jobs)", lambda wd: wgmma_product("sum", dy[:3], w[:3], wide=wd),
         lambda: [torch.mm(t, u) for t, u in zip(dy[:3], w[:3])], 6 * N * HD * HD))
    lines = [f"B4's products alone at [{N}, {HD}] x [{HD}, {HD}], device ms (share of "
             f"{PEAK / 1e12:.0f} TFLOP/s):"]
    for use, fn, lib, flop in uses:
        t1, t2 = device_ms(lambda: fn(False), "gemm_kernel"), device_ms(lambda: fn(True),
                                                                         "gemm_kernel")
        tl = device_ms(lib, "")
        lines.append(f"  {use}: 128 x 128 {t1:.4f} ({flop / t1 / 1e9 / PEAK * 1e12:.1%}), "
                     f"128 x 256 {t2:.4f} ({flop / t2 / 1e9 / PEAK * 1e12:.1%}), torch.mm "
                     f"{tl:.4f} ({flop / tl / 1e9 / PEAK * 1e12:.1%})")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", action="store_true")
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
    per, calls = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / PAIRS
            calls[e.name] = calls.get(e.name, 0) + 1
    lines.append(f"B4 device time per forward and backward pair "
                 f"({sum(per.values()):.4f} ms in all):")
    groups = {}
    for name, ms in per.items():
        groups[group_of(name)] = groups.get(group_of(name), 0.0) + ms
    lines.append("  by part: " + ", ".join(f"{g} {ms:.4f} ms" for g, ms in sorted(
        groups.items(), key=lambda kv: -kv[1])))
    N = B * S
    flop = {"q|k|v and out (bias)": 8 * N * HD * HD, "dctx (hi/lo)": 2 * N * HD * HD,
            "dW, db (wgrad)": 8 * N * HD * HD, "dx (sum)": 6 * N * HD * HD}
    for name, ms in sorted(per.items(), key=lambda kv: -kv[1]):
        use = next((u for k, u in PRODUCTS.items() if k in name), None)
        rate = (f", {flop[use] / (ms * 1e-3) / 1e12:.0f} TFLOP/s = "
                f"{flop[use] / (ms * 1e-3) / PEAK:.1%} of peak ({use})" if use else "")
        lines.append(f"  {ms:8.4f} ms  {calls[name] // PAIRS} a pair  [{group_of(name)}]"
                     f"{rate}  {name[:90]}")
    if args.widths:
        lines += widths(g)
    text = "\n".join(lines)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
