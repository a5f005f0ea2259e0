"""Where the time of one full-width UC2 or M3P fine-tune step goes on the GPU.

    python3 -m clg_vqa_tpu_torch.tools.profile_train [--m3p]
        [--no-fused | --sm | --proj | --blocked] [--out PATH]

The train twin of tools/profile_eval.py. Builds UC2 (M3P with --m3p, 100
regions and 140 positions, tools/profile_train.py:98-102 of the JAX
package) at its published width (random weights from seed 0) and
chip_smoke.py's training envelope
(bench.py:54-92: acc 2 x mbs 128, bf16 with fp32 master weights, dropout
0.1, lambda 10, the device feature bank, TrainPipeline over
data/synthetic.train_dataset), runs 2 warm-up steps, 5 untraced steps (ms per
step, QA/s, and the host's ms per step to issue them: the step has no host
synchronisation, so a device that paces the step shows as the final wait)
and 3 steps under torch.profiler, and prints device time per
step by kernel group, the device's busy share of the traced window and the
top kernels. The training attention is the flat kernels (B1) by default,
the S-major ones (B5, with their entry's layout copies) with --sm, the
whole-block ones (B4: the q/k/v/o products and their gradients inside the
kernel entries, around B1's core) with --proj, the head-blocked ones (B3)
with --blocked (fused_attn=True: heads split around the kernel; "hm" is the
same route in the port), the plain path with --no-fused.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..data.pipeline import TrainPipeline
from ..data.synthetic import train_dataset
from ..train.loop import TrainState, make_train_step
from ..train.optim import make_optimizer, warmup_linear_schedule
from .profile_eval import device_kernels, model_and_world, union_us

ACC, MBS, WARMUP, UNTRACED, TRACED = 2, 128, 2, 5, 3

# The attention core: attn_train::fwd_kernel / bwd_kernel (fp32 B1, B5, B3
# and B4's core) and attn_train_mma::fwd_kernel / bwd_kernel (the
# tensor-core kernels of bf16 B1, B5, B3 and B4); the key-blocked twins
# match the same keys. B4's products are gemm_wgmma's kernels (bf16) and
# b4_fp32_kernel, its sums b4_*_kernel. The train step's accumulation, norm
# and AdamW passes are csrc/multi_tensor.cu's multi_tensor::* kernels.
GROUPS = (("multi-tensor passes (accumulate, norm, AdamW)", ("multi_tensor::",)),
          ("attention core forward (B1/B5/B4/B3)", ("fwd_kernel<", "fwd_blocked_kernel<")),
          ("attention core backward (B1/B5/B4/B3)", ("bwd_kernel<", "bwd_blocked_kernel<")),
          ("B4 products and sums", ("b4_", "gemm_wgmma")),
          ("rows_gather", ("rows_gather_kernel",)),
          ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "sm90_", "cublas")),
          ("softmax", ("softmax",)),
          ("reduce", ("reduce",)))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other elementwise / copy"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m3p", action="store_true", help="M3P instead of UC2")
    route = ap.add_mutually_exclusive_group()
    route.add_argument("--no-fused", action="store_true",
                       help="plain attention path instead of the B1 kernels")
    route.add_argument("--sm", action="store_true",
                       help="the S-major training kernels (B5) instead of B1")
    route.add_argument("--proj", action="store_true",
                       help="the whole-block training kernels (B4) instead "
                            "of the projections and B1")
    route.add_argument("--blocked", action="store_true",
                       help="the head-blocked training kernels (B3), "
                            "fused_attn=True")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False

    fused = (False if args.no_fused else "sm" if args.sm
             else "proj" if args.proj else True if args.blocked else "flat")
    lines = []
    n_steps = WARMUP + UNTRACED + TRACED
    with tempfile.TemporaryDirectory() as tmp:
        cfg, model, w = model_and_world(args.m3p, tmp, 8)
        params = dict(model.named_parameters())
        opt = make_optimizer(list(params),
                             warmup_linear_schedule(4e-5, 2000, 20000))
        state = TrainState(model, opt.init(params), 0)
        D = torch.from_numpy(np.random.RandomState(0).rand(
            cfg.num_labels, cfg.num_labels).astype(np.float32)).cuda()
        step = make_train_step(opt, D, semantic_lambda=10.0,
                               compute_dtype=torch.bfloat16, fused_attn=fused)
        pipe = TrainPipeline(train_dataset(w, n_steps * ACC * MBS),
                             micro_batch_size=MBS, grad_acc_steps=ACC,
                             device="cuda", with_features=False)
        bank = w.bank.tensors()
        batches = pipe.epoch(0)
        i = 0

        def run(n):
            """Seconds the host took to issue n steps, before the final
            synchronisation."""
            nonlocal state, i
            t0 = time.perf_counter()
            for _ in range(n):
                state, _ = step(state, next(batches), seed=i, bank=bank)
                i += 1
            issued = time.perf_counter() - t0
            torch.cuda.synchronize()
            return issued

        run(WARMUP)
        t0 = time.perf_counter()
        issued = run(UNTRACED) / UNTRACED
        dt = (time.perf_counter() - t0) / UNTRACED
        lines.append(f"untraced: {'M3P' if args.m3p else 'UC2'}, "
                     f"{dt * 1e3:.2f} ms/step, "
                     f"{ACC * MBS / dt:.1f} QA/s (acc {ACC} x mbs {MBS}, bf16, "
                     f"fused_attn={fused}) on {torch.cuda.get_device_name(0)}; "
                     f"host issued a step in {issued * 1e3:.2f} ms")
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run(TRACED)
            traced = (time.perf_counter() - t0) / TRACED
        batches.close()

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
    lines.append(f"traced: host {traced * 1e3:.2f} ms/step; device window "
                 f"{window / 1e3:.2f} ms, busy {busy / 1e3:.2f} ms "
                 f"({100 * busy / window:.1f}% of the window, idle "
                 f"{100 * (1 - busy / window):.1f}%); {len(kernels)} kernels, "
                 f"{total / 1e3 / TRACED:.2f} ms of kernel time per step")
    for g, t in sorted(by_group.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {g:28s} {t / 1e3 / TRACED:10.3f} ms/step  "
                     f"{100 * t / total:5.1f}%")
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
