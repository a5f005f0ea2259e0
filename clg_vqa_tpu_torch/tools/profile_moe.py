"""The grouped expert products (csrc/grouped_gemm.cu through ops/moe.py) at
Kimi-VL-A3B's widths, beside their plain versions and the library's.

    python3 -m clg_vqa_tpu_torch.tools.profile_moe [--tokens 9728] [--out PATH]

Routes ``--tokens`` tokens (a microbatch of the fine-tune step: 128 QA x 76
positions) over the router's 64 experts, top-6, with random logits from
seed 0, and dispatches the pairs that experts 0-7 take (about 912 rows an
expert). Over those groups, for each of the six products of an expert
layer (the forward's gate|up with SwiGLU and down; the backward's dact
with the SwiGLU gradient, dX and the fp32 weight gradients of down and of
gate|up) it gives:

- the bound: max(bytes / 3.35 TB/s, FLOPs / 989 TFLOP/s) of the pairs
  routed (not the padding), each operand read once, each output written
  once (portbench/families/kimi_vl.grouped_products counts the same);
- the kernel's device time a call (torch.profiler over 10 calls; 0 if the
  profiler saw none of its launches) and its CUDA-event time (median of 25
  after 3 warm-ups);
- the plain version's CUDA-event time (ops/moe.py's per-expert loop, fp32
  products: it repeats the kernel's arithmetic and is no yardstick of
  speed);
- the library's: ``torch._grouped_mm`` (bf16, cuBLAS's grouped product)
  where this PyTorch has it, else one bf16 ``torch.mm`` an expert, with no
  epilogue (the SwiGLU and its gradient left out);
- the kernel's output against the plain version's (relative norm), and,
  as the yardstick of that number, the plain version with each group's
  weights (for the weight gradients: its output) taken from the next
  expert's against the plain version.

Prints one JSON line a product and, with ``--out``, writes them there.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..ops import moe
from .measure import bound_ms, device_us, time_ms

H, I, ROUTER, HELD, TOPK, SCALE = 2048, 1408, 64, 8, 6, 2.446


def _library(kind: str, a, b, poff, ends):
    """(name, call) of the library's product of one use: torch._grouped_mm
    where this PyTorch has it and takes these operands (offsets are the
    groups' ends), else a bf16 torch.mm a group over the host's offsets."""
    grouped = getattr(torch, "_grouped_mm", None)
    if grouped is not None:
        at = a.t().contiguous().t() if kind == "wgrad" else a
        call = ((lambda: grouped(at.t(), b, offs=ends)) if kind == "wgrad"
                else (lambda: grouped(at, b, offs=ends)))
        try:
            call()
            return "torch._grouped_mm", call
        except (RuntimeError, TypeError, ValueError) as e:
            print(f"torch._grouped_mm refused the {kind} operands: {e}")
    p = poff.tolist()
    spans = list(zip(p[:-1], p[1:]))
    if kind == "wgrad":
        return "torch.mm a group", lambda: [torch.mm(a[s:e].t(), b[s:e]) for s, e in spans]
    return "torch.mm a group", lambda: [torch.mm(a[s:e], b[g])
                                        for g, (s, e) in enumerate(spans)]


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def profile(T: int = 128 * 76, seed: int = 0) -> list[dict]:
    """One row a product (the module's docstring) over the groups of ``T``
    routed tokens drawn from ``seed``; ``out_dtype`` names the output's
    dtype (the weight gradients' is fp32)."""
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(seed)
    idx, w = moe.route(torch.randn(T, ROUTER, device=dev, generator=g),
                       torch.zeros(ROUTER, device=dev), TOPK, SCALE)
    d = moe.dispatch(idx, 0, HELD, expected=HELD / ROUTER)
    counts = d.counts.tolist()
    n = float(sum(counts))
    bf = torch.bfloat16
    xd = moe._rows_buffer(torch.randn(T, H, device=dev, generator=g).to(bf)[d.token], d)
    dyd = moe._rows_buffer(torch.randn(T * TOPK, H, device=dev, generator=g).to(bf), d)
    w1 = (0.05 * torch.randn(HELD, 2 * I, H, device=dev, generator=g)).to(bf)
    w2 = (0.05 * torch.randn(HELD, H, I, device=dev, generator=g)).to(bf)
    gu, act = moe.grouped_swiglu(xd, w1, d.poff, d.tiles)
    dgu = moe.grouped_dswiglu(dyd, w2, gu, d.poff, d.tiles)
    p = d.poff.long()
    # the padded groups' ends, which torch._grouped_mm takes as its offsets
    ends = d.poff[1:].contiguous()
    top = int(p[-1])
    wt = w1.transpose(1, 2).contiguous()          # [E, H, 2I] for the library
    w2t = w2.transpose(1, 2).contiguous()         # [E, I, H]
    E1, E2 = 2 * HELD * 2 * I * H, 2 * HELD * H * I
    uses = [
        ("gate|up + SwiGLU", 2 * n * H + E1 + 2 * n * 3 * I, 2 * n * H * 2 * I,
         lambda: moe.grouped_swiglu(xd, w1, d.poff, d.tiles),
         lambda: moe.swiglu_plain(xd, w1, d.poff),
         lambda: moe.swiglu_plain(xd, w1.roll(1, 0), d.poff), ("rows", xd[:top], wt),
         lambda k, q: _rel(k[1][:top], q[1][:top])),
        ("down", 2 * n * I + E2 + 2 * n * H, 2 * n * I * H,
         lambda: moe.grouped_rows(act, w2, d.poff, d.tiles, True),
         lambda: moe.rows_plain(act, w2, d.poff, True),
         lambda: moe.rows_plain(act, w2.roll(1, 0), d.poff, True), ("rows", act[:top], w2t),
         lambda k, q: _rel(k[:top], q[:top])),
        ("dact + dSwiGLU", 2 * n * H + E2 + 2 * n * 4 * I, 2 * n * H * I,
         lambda: moe.grouped_dswiglu(dyd, w2, gu, d.poff, d.tiles),
         lambda: moe.dswiglu_plain(dyd, w2, gu, d.poff),
         lambda: moe.dswiglu_plain(dyd, w2.roll(1, 0), gu, d.poff), ("rows", dyd[:top], w2),
         lambda k, q: _rel(k[:top], q[:top])),
        ("dX", 2 * n * 2 * I + E1 + 2 * n * H, 2 * n * 2 * I * H,
         lambda: moe.grouped_rows(dgu, w1, d.poff, d.tiles, False),
         lambda: moe.rows_plain(dgu, w1, d.poff, False),
         lambda: moe.rows_plain(dgu, w1.roll(1, 0), d.poff, False), ("rows", dgu[:top], w1),
         lambda k, q: _rel(k[:top], q[:top])),
        ("dW2", 2 * n * (H + I) + 2 * E2, 2 * n * H * I,
         lambda: moe.grouped_wgrad(dyd, act, d.poff),
         lambda: moe.wgrad_plain(dyd, act, d.poff),
         lambda: moe.wgrad_plain(dyd, act, d.poff).roll(1, 0), ("wgrad", dyd[:top], act[:top]),
         _rel),
        ("dW1", 2 * n * (2 * I + H) + 2 * E1, 2 * n * 2 * I * H,
         lambda: moe.grouped_wgrad(dgu, xd, d.poff),
         lambda: moe.wgrad_plain(dgu, xd, d.poff),
         lambda: moe.wgrad_plain(dgu, xd, d.poff).roll(1, 0), ("wgrad", dgu[:top], xd[:top]),
         _rel),
    ]
    name = torch.cuda.get_device_name(0)
    rows = []
    for use, nbytes, flops, kern, plain, wrong, (kind, a, b), err in uses:
        bound, by = bound_ms(nbytes, flops, bf)
        lib_name, lib = _library(kind, a.contiguous(), b, d.poff, ends)
        dev_us = sum(v for k, v in device_us(kern).items() if "grouped_gemm" in k)
        row = {"product": use, "device": name, "tokens": T, "pairs": int(n),
               "rows_an_expert": counts, "bound_ms": bound, "bound_by": by,
               "kernel_device_ms": dev_us * 1e-3, "kernel_ms": time_ms(kern),
               "plain_ms": time_ms(plain, 5), "library": lib_name,
               "library_ms": time_ms(lib), "kernel_vs_plain": err(kern(), plain()),
               "wrong_expert_vs_plain": err(wrong(), plain()),
               "out_dtype": "fp32" if kind == "wgrad" else "bf16"}
        # None where the profiler saw none of the kernel's launches
        row["roofline_pct"] = (100.0 * bound / row["kernel_device_ms"]
                               if dev_us else None)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tokens", type=int, default=128 * 76)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    rows = profile(args.tokens)
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
