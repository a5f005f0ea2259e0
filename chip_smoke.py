#!/usr/bin/env python3
"""Drive the PyTorch port (clg_vqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero without the
final line:
 1. device line: the card's name and power limit (nvidia-smi) and CUDA.
 2. build the three CUDA kernel sources with nvcc (sm_90a) from csrc/, one
    nvcc each, all at once.
 3. each kernel against its plain PyTorch version on the card at the main
    paths' shapes, timed with CUDA events beside its bound, the plain
    version and one library call used only as a yardstick here. The
    training attention (B1) is also held to its dropout semantics: the
    kernels' keep mask is the plain version's, runs are bit-deterministic,
    the keep fraction is t/256, and <dv, v> equals the loss.
 4. the eval path at UC2's full width (12 x 768, vocab 250002, 1842
    answers; random weights from a seed): run_eval at batch 1024 in bf16
    over a synthetic 400-image CFS store and device feature bank, then
    Predictor requests.
 5. eval path parity: fp32 logits of the flat-kernel path against the
    plain path on one full-width batch, and a tiny UC2 on the card against
    the same weights on the CPU.
 6. the training path at full width: the UC2 GQA fine-tune step of
    bench.py:54-92 (acc 2 x mbs 128, bf16 with fp32 master weights, dropout
    0.1, lambda 10, flat training attention, device bank), fed by
    TrainPipeline: 2 warm-up steps, then timed steps.
 7. training parity: a tiny UC2 trained 3 steps on the card (kernels)
    and on the CPU (plain path), and the full-width fp32 gradients of the
    kernel route against the plain route.
Launch counters, set to 0 just before each path's timed run and read just
after, show which kernels each path ran. Then one JSON line listing the
kernels, and as the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from clg_vqa_tpu_torch.config import UC2Config
from clg_vqa_tpu_torch.data.device_bank import DeviceFeatureBank
from clg_vqa_tpu_torch.data.pipeline import TrainPipeline
from clg_vqa_tpu_torch.data.synthetic import (REGIONS as R, eval_world,
                                              train_dataset)
from clg_vqa_tpu_torch.eval.predictor import Predictor
from clg_vqa_tpu_torch.eval.runner import make_predict_step, run_eval
from clg_vqa_tpu_torch.models.uc2 import UC2
from clg_vqa_tpu_torch.ops import _build
from clg_vqa_tpu_torch.ops.attention import (
    dropout_keep_mask, fused_attention_flat, fused_attention_flat_plain,
    fused_attention_train_flat, fused_attention_train_flat_plain,
    keep_threshold, realized_keep_mask)
from clg_vqa_tpu_torch.ops.bank_gather import rows_gather, rows_gather_plain
from clg_vqa_tpu_torch.train.loop import (TrainState, make_loss_fn,
                                          make_train_step)
from clg_vqa_tpu_torch.train.optim import (make_optimizer,
                                           warmup_constant_schedule,
                                           warmup_linear_schedule)
from clg_vqa_tpu_torch.utils.convert import load_numpy_state

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

EVAL_BS = 1024
N_IMAGES, N_QA = 400, 8192
N_REQUESTS = 64
# the training envelope of bench.py:80-92
ACC, MBS, LAMBDA = 2, 128, 10.0
WARMUP_STEPS, TIMED_STEPS = 2, 10
RATE = 0.1                   # UC2Config's dropout; keep threshold t = 230


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


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


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bf16_ulp(x: float) -> float:
    """One bf16 ulp (8 significant bits) at magnitude x."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build(["flat_attention", "flat_attention_train",
                          "rows_gather"])
    for name, (secs, log) in built.items():
        print(f"build {name}: {secs:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}")
    print(f"build total {time.perf_counter() - t0:.1f} s "
          f"({len(built)} compiled, others cached)")


def attention_inputs(B, S, H, hd, dtype, gen):
    q, k, v = (torch.randn(B, S, H * hd, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    lens = torch.randint(S // 2, S + 1, (B,), device="cuda", generator=gen)
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None]).float()
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :]
    return q, k, v, bias


def phase_kernels() -> dict:
    gen = torch.Generator("cuda").manual_seed(0)
    out = {}

    # K1 at odd shapes first: S=13 (tiny), S=140 (shared memory above 48 KB)
    for S in (13, 140):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias = attention_inputs(64, S, 12, 64, dtype, gen)
            got = fused_attention_flat(q, k, v, bias, 12).float()
            ref = fused_attention_flat_plain(q, k, v, bias, 12).float()
            err = (got - ref).abs().max().item()
            tol = 1e-5 if dtype == torch.float32 else bf16_ulp(ref.abs().max().item())
            print(f"K1 S={S} {dtype}: max abs err {err:.3g} (tol {tol:.3g})")
            check(err <= tol, f"flat attention S={S} {dtype} disagrees: {err}")

    B, S, H, hd = EVAL_BS, 76, 12, 64
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias = attention_inputs(B, S, H, hd, dtype, gen)
        got = fused_attention_flat(q, k, v, bias, H)
        ref = fused_attention_flat_plain(q, k, v, bias, H)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = 1e-5 if dtype == torch.float32 else bf16_ulp(scale)
        print(f"K1 B={B} S={S} {dtype}: max abs err {err:.3g} "
              f"(tol {tol:.3g}: {'atol' if dtype == torch.float32 else '1 bf16 ulp of max |out| ' + f'{scale:.3g}'})")
        check(err <= tol, f"flat attention {dtype} disagrees: {err} > {tol}")
        ms = time_ms(lambda: fused_attention_flat(q, k, v, bias, H))
        plain = time_ms(lambda: fused_attention_flat_plain(q, k, v, bias, H))
        qh, kh, vh = (t.view(B, S, H, hd).transpose(1, 2) for t in (q, k, v))
        mask = bias.to(dtype)
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask))
        nbytes = 4 * B * S * H * hd * q.element_size() + B * S * 4
        ops = 4 * B * H * S * S * hd
        bms, by = bound_ms(nbytes, ops, dtype)
        # the kernel does its products on the fp32 CUDA cores whatever the
        # input type: this design's own bound
        fp32_bms, _ = bound_ms(nbytes, ops, torch.float32)
        print(f"K1 {dtype}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"sdpa {lib:.4f} ms, bound {bms:.4f} ms ({by}; "
              f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP); on fp32 CUDA "
              f"cores {fp32_bms:.4f} ms")
        out[f"flat_attention/{dtype}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
            bound_ms=bms, bound_by=by)

    N, C = N_IMAGES, 2048
    bank = torch.randn(N, R, C, device="cuda", generator=gen)
    idx = torch.randint(0, N, (EVAL_BS,), device="cuda", generator=gen,
                        dtype=torch.int32)
    got = rows_gather(bank, idx)
    ref = rows_gather_plain(bank, idx)
    check(torch.equal(got, ref), "rows_gather is not bit-exact")
    ms = time_ms(lambda: rows_gather(bank, idx))
    plain = time_ms(lambda: rows_gather_plain(bank, idx))
    lib = time_ms(lambda: torch.index_select(bank, 0, idx))
    # bytes this call needs: each bank row it touches read once, every
    # output row written once, the indices read once
    n_unique = torch.unique(idx).numel()
    nbytes = (n_unique + EVAL_BS) * R * C * 4 + EVAL_BS * 4
    bms, by = bound_ms(nbytes, 0, torch.float32)
    print(f"K2 [{N},{R},{C}] fp32 x {EVAL_BS} ({n_unique} distinct rows): "
          f"bit-exact; kernel {ms:.4f} ms, plain {plain:.4f} ms, index_select "
          f"{lib:.4f} ms, bound {bms:.4f} ms ({nbytes / 1e6:.1f} MB)")
    out["rows_gather"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                              library_ms=lib, bound_ms=bms, bound_by=by)
    return out


def train_attention(q, k, v, bias, do, *, plain=False, **kw):
    """B1 (or its plain version) forward and backward: (out, dq, dk, dv, db)."""
    fn = fused_attention_train_flat_plain if plain else fused_attention_train_flat
    ins = [t.detach().requires_grad_() for t in (q, k, v, bias)]
    out = fn(*ins, 12, **kw)
    return (out.detach(), *torch.autograd.grad(out, ins, do))


def check_train_attention(q, k, v, bias, do, what: str, **kw) -> dict:
    """B1 against autograd of its plain version on the same inputs and seed.
    Tolerances: forward atol 1e-5 (fp32) or one bf16 ulp of the largest
    output; dq/dk/dv 2e-4 * max|grad| (fp32) or two bf16 ulps of the
    largest grad; dbias 1e-4 * max|dbias|. Both sides compute in fp32 and
    differ in summation order only. Returns the largest errors."""
    got = train_attention(q, k, v, bias, do, **kw)
    want = train_attention(q, k, v, bias, do, plain=True, **kw)
    torch.cuda.synchronize()
    errs = {}
    for i, name in enumerate(("out", "dq", "dk", "dv", "dbias")):
        scale = want[i].float().abs().max().item()
        if name == "dbias":
            tol = 1e-4 * scale
        elif q.dtype == torch.float32:
            tol = 1e-5 if name == "out" else 2e-4 * scale
        else:
            tol = bf16_ulp(scale) * (1 if name == "out" else 2)
        err = (got[i].float() - want[i].float()).abs().max().item()
        check(got[i].dtype == want[i].dtype, f"B1 {what} {name} dtype")
        check(err <= tol, f"B1 {what} {name} disagrees: {err} > {tol}")
        errs[name] = err
    print(f"B1 {what}: max abs err " + ", ".join(
        f"{n} {e:.3g}" for n, e in errs.items()))
    return errs


def phase_train_kernel(gen) -> dict:
    """B1 against its plain version at S=13 and 140 and at the training
    shapes (mbs 128, S 76, 12 x 64), its dropout properties, and its times."""
    t = keep_threshold(RATE)
    for S in (13, 140):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias = attention_inputs(32, S, 12, 64, dtype, gen)
            do = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
            check_train_attention(q, k, v, bias, do, f"S={S} {dtype} rate {RATE}",
                                  dropout_rate=RATE, seed=7)

    B, S, H, hd = MBS, 76, 12, 64
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias = attention_inputs(B, S, H, hd, dtype, gen)
        do = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
        err = {}
        for rate in (0.0, RATE):
            e = check_train_attention(q, k, v, bias, do,
                                      f"B={B} S={S} {dtype} rate {rate}",
                                      dropout_rate=rate, seed=11)
            err = {n: max(err.get(n, 0.0), x) for n, x in e.items()}
        kw = dict(dropout_rate=RATE, seed=11)
        a = train_attention(q, k, v, bias, do, **kw)
        b = train_attention(q, k, v, bias, do, **kw)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"B1 {dtype}: two runs with one seed differ")
        c = train_attention(q, k, v, bias, do, dropout_rate=RATE, seed=12)
        check(not torch.equal(a[0], c[0]), f"B1 {dtype}: another seed, same output")
        print(f"B1 {dtype}: forward and backward bit-equal over two runs; "
              f"another seed changes the output")

        # <dv, v> = loss: the output is linear in v under a fixed mask, so a
        # backward that replayed another mask than the forward breaks it by
        # about the rate times the spread of the terms. Rounding bounds the
        # tolerance: fp32 sums carry ~1e-7 of sum |terms|; in bf16 the output
        # and dv are rounded (2^-9 each), errors of random sign, so a few
        # 2^-8 of the root of the sum of squared terms
        v_ = v.detach().requires_grad_()
        out_v = fused_attention_train_flat(q, k, v_, bias, H, **kw)
        terms = out_v.detach().double() * do.double()
        loss = (out_v.float() * do.float()).sum()
        (dv,) = torch.autograd.grad(loss, v_)
        inner = (dv.double() * v.double()).sum().item()
        total = terms.sum().item()
        tol = (1e-6 * terms.abs().sum().item() if dtype == torch.float32
               else 4 * 2.0 ** -8 * terms.square().sum().sqrt().item())
        print(f"B1 {dtype} v-linearity: <dv, v> {inner:.6g}, loss "
              f"{total:.6g} (tol {tol:.3g})")
        check(abs(inner - total) <= tol, f"B1 {dtype}: <dv, v> != loss")

        # bound: each input read once, each output written once; products
        # of the function (forward 2, backward 5, of 2*S*S*hd per head)
        e = q.element_size()
        fwd_bytes = 4 * B * S * H * hd * e + B * S * 4
        bwd_bytes = 7 * B * S * H * hd * e + 2 * B * S * 4
        fwd_ops, bwd_ops = 4 * B * H * S * S * hd, 10 * B * H * S * S * hd
        qr, kr, vr, br = (x.detach().requires_grad_() for x in (q, k, v, bias))
        o_k = fused_attention_train_flat(qr, kr, vr, br, H, **kw)
        o_p = fused_attention_train_flat_plain(qr, kr, vr, br, H, **kw)
        qh, kh, vh = (x.view(B, S, H, hd).transpose(1, 2)
                      for x in (qr, kr, vr))
        o_s = torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=bias.to(dtype))
        do_s = do.view(B, S, H, hd).transpose(1, 2)
        mask_s = bias.to(dtype)
        with torch.no_grad():
            fwd_ms = time_ms(lambda: fused_attention_train_flat(q, k, v, bias,
                                                                H, **kw))
            fwd_plain = time_ms(lambda: fused_attention_train_flat_plain(
                q, k, v, bias, H, **kw))
            fwd_lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask_s))
        bwd_ms = time_ms(lambda: torch.autograd.grad(
            o_k, (qr, kr, vr, br), do, retain_graph=True))
        bwd_plain = time_ms(lambda: torch.autograd.grad(
            o_p, (qr, kr, vr, br), do, retain_graph=True))
        bwd_lib = time_ms(lambda: torch.autograd.grad(
            o_s, (qr, kr, vr), do_s, retain_graph=True))
        for name, ms, plain, lib, nbytes, ops in (
                ("fwd", fwd_ms, fwd_plain, fwd_lib, fwd_bytes, fwd_ops),
                ("bwd", bwd_ms, bwd_plain, bwd_lib, bwd_bytes, bwd_ops)):
            bms, by = bound_ms(nbytes, ops, dtype)
            fp32_bms, _ = bound_ms(nbytes, ops, torch.float32)
            print(f"B1 {name} {dtype} rate {RATE}: kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, sdpa (rate 0) {lib:.4f} ms, bound "
                  f"{bms:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
                  f"{ops / 1e9:.2f} GFLOP); on fp32 CUDA cores {fp32_bms:.4f} ms")
            out[f"flat_attention_train_{name}/{dtype}"] = dict(
                max_abs_err=(err["out"] if name == "fwd"
                             else max(err["dq"], err["dk"], err["dv"],
                                      err["dbias"])),
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                bound_by=by)

    # the kernels' own keep bits, read back through the forward, are the
    # plain version's, on the card and on the CPU
    got = realized_keep_mask(11, B, H, S, hd, RATE, "cuda")
    want = dropout_keep_mask(11, B, H, S, t, "cuda")
    check(torch.equal(got, want), "B1 keep mask differs from the plain mask")
    check(torch.equal(got[:4].cpu(), dropout_keep_mask(11, 4, H, S, t)),
          "B1 keep mask on the card differs from the CPU's")
    check(not torch.equal(got, realized_keep_mask(12, B, H, S, hd, RATE, "cuda")),
          "B1: another seed gives the same mask")
    frac = got.float().mean().item()
    print(f"B1 keep mask [{B},{H},{S},{S}] = dropout_keep_mask on the card "
          f"and the CPU; keep fraction {frac:.5f} (t/256 = {t / 256:.5f})")
    check(abs(frac - t / 256) <= 0.005, f"B1 keep fraction {frac}")
    return out


def reset_counts() -> None:
    fused_attention_flat.launches = 0
    rows_gather.launches = 0
    fused_attention_train_flat.launches = 0
    fused_attention_train_flat.backward_launches = 0


def read_counts() -> dict:
    return {"flat_attention": fused_attention_flat.launches,
            "rows_gather": rows_gather.launches,
            "flat_attention_train_fwd": fused_attention_train_flat.launches,
            "flat_attention_train_bwd":
                fused_attention_train_flat.backward_launches}


def phase_main_path(tmp: str, cfg: UC2Config, model: UC2) -> dict:
    """Returns each path's launch counts (counters set to 0 just before the
    path's timed run, read just after; warm-ups are not counted)."""
    w = eval_world(tmp, N_QA, num_labels=cfg.num_labels,
                   vocab_size=cfg.vocab_size, device="cuda")
    label2ans = w.label2ans
    print(f"bank: {w.bank.nbytes / 1e6:.0f} MB on the card")

    run_eval(model, w.dataset, label2ans, batch_size=EVAL_BS,
             device_bank=w.bank)                                        # warm-up
    torch.cuda.synchronize()
    n_batches = math.ceil(N_QA / EVAL_BS)
    out_path = os.path.join(tmp, "test_result.json")
    reset_counts()
    t0 = time.perf_counter()
    res = run_eval(model, w.dataset, label2ans, batch_size=EVAL_BS,
                   device_bank=w.bank, out_path=out_path)
    dt = time.perf_counter() - t0
    eval_counts = read_counts()
    print(f"run_eval: {res['n']} QA in {dt:.3f} s -> {res['n'] / dt:.1f} QA/s "
          f"(bs {EVAL_BS}, bf16, bank on, {n_batches} batches) on "
          f"{torch.cuda.get_device_name(0)}; launches {eval_counts}")
    check(eval_counts == {"flat_attention": 12 * n_batches,
                          "rows_gather": n_batches,
                          "flat_attention_train_fwd": 0,
                          "flat_attention_train_bwd": 0},
          f"run_eval launches {eval_counts}, expected 12 x {n_batches} "
          f"flat_attention and {n_batches} rows_gather")
    check(res["n"] == N_QA, f"run_eval scored {res['n']} of {N_QA}")
    with open(out_path) as f:
        recs = json.load(f)
    check(len(recs) == N_QA and all(set(x) == {"questionId", "prediction"}
                                    and x["prediction"] in label2ans
                                    for x in recs), "malformed result json")

    pred = Predictor(model, w.reader, w.tokenizer, label2ans, batch_capacity=8)
    reqs = [(e.question, e.image_id) for e in w.entries[:N_REQUESTS]]
    pred.predict_batch(reqs[:8])                                        # warm-up
    lat = []
    answers = []
    reset_counts()
    for s in range(0, N_REQUESTS, 8):
        t1 = time.perf_counter()
        answers += pred.predict_batch(reqs[s:s + 8])
        lat.append((time.perf_counter() - t1) * 1e3)
    pred_counts = read_counts()
    print(f"Predictor launches {pred_counts}")
    check(pred_counts == {"flat_attention": 0, "rows_gather": N_REQUESTS // 8,
                          "flat_attention_train_fwd": 0,
                          "flat_attention_train_bwd": 0},
          f"Predictor launches {pred_counts}, expected no flat_attention and "
          f"{N_REQUESTS // 8} rows_gather")
    check(len(answers) == N_REQUESTS and all(
        a["answer"] in label2ans and 0.0 <= a["confidence"] <= 1.0
        for a in answers), "Predictor returned a malformed answer")
    print(f"Predictor: {N_REQUESTS} requests in chunks of 8, bf16: per-chunk "
          f"latency median {statistics.median(lat):.2f} ms, max {max(lat):.2f} ms "
          f"({len(lat)} chunks)")

    # the same eval through the plain attention path, for comparison
    plain_step = make_predict_step(model, device_bank=w.bank, fused_attn=False)
    run_eval(model, w.dataset, label2ans, batch_size=EVAL_BS,
             device_bank=w.bank, step=plain_step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_plain = run_eval(model, w.dataset, label2ans, batch_size=EVAL_BS,
                         device_bank=w.bank, step=plain_step)
    dtp = time.perf_counter() - t0
    print(f"run_eval, plain attention path: {res_plain['n'] / dtp:.1f} QA/s")
    return {"launches": {"run_eval": eval_counts, "predictor": pred_counts},
            "world": w, "qa_per_s": res["n"] / dt}


def phase_parity(cfg: UC2Config, model: UC2, ds, bank) -> None:
    batch = ds.make_batch(list(range(EVAL_BS)), with_features=False)
    t = {k: torch.from_numpy(batch[k]).cuda()
         for k in ("input_ids", "input_mask", "store_idx")}
    f, l, m = DeviceFeatureBank.gather_from(bank.tensors(), t.pop("store_idx"))
    t.update(features=f, locs=l, image_mask=m)
    with torch.inference_mode():
        flat = model(t, compute_dtype=None, fused_attn="flat")
        plain = model(t, compute_dtype=None, fused_attn=False)
        err = (flat - plain).abs().max().item()
        print(f"fp32 logits, flat kernel vs plain path (full width, B={EVAL_BS}): "
              f"max abs diff {err:.3g} (tol 1e-4), max |logit| "
              f"{plain.abs().max().item():.3g}")
        check(torch.isfinite(flat).all().item() and flat.shape == (
            EVAL_BS, cfg.num_labels), "bad fp32 logits")
        check(err <= 1e-4, f"flat vs plain fp32 logits differ by {err}")
        a = model(t, compute_dtype=torch.bfloat16, fused_attn="flat").argmax(-1)
        b = model(t, compute_dtype=torch.bfloat16, fused_attn=False).argmax(-1)
        print(f"bf16 argmax agreement flat vs plain: "
              f"{(a == b).float().mean().item() * 100:.2f}%")

    tiny = UC2Config(vocab_size=300, hidden_size=128, num_layers=2, num_heads=2,
                     intermediate_size=256, v_feature_size=64, num_locs=7,
                     pooler_size=128, clf_hidden_size=64, num_labels=40)
    gpu = UC2(tiny, device="cuda", seed=1)
    cpu = load_numpy_state(UC2(tiny, device="cpu"),
                           {k: v.cpu().numpy() for k, v in gpu.state_dict().items()})
    r = np.random.RandomState(2)
    ids = r.randint(3, 300, (6, 11)).astype(np.int32)
    ids[1, 7:] = 1
    host = {"input_ids": ids, "input_mask": (ids != 1).astype(np.int32),
            "features": r.randn(6, 9, 64).astype(np.float32),
            "locs": r.rand(6, 9, 7).astype(np.float32),
            "image_mask": np.ones((6, 9), np.int32)}
    with torch.inference_mode():
        want = cpu({k: torch.from_numpy(v) for k, v in host.items()})
        got = gpu({k: torch.from_numpy(v).cuda() for k, v in host.items()},
                  fused_attn="flat").cpu()
    err = (got - want).abs().max().item()
    print(f"tiny UC2 (hd 64) fp32, card flat path vs CPU plain path: "
          f"max abs diff {err:.3g} (tol 1e-4)")
    check(err <= 1e-4, f"card vs CPU logits differ by {err}")


def phase_train(cfg: UC2Config, model: UC2, world, smi: str) -> dict:
    """The UC2 GQA fine-tune step at full width (bench.py:54-92's envelope),
    fed by TrainPipeline over the eval world's store and device bank.
    Returns the timed steps' launch counts."""
    ds = train_dataset(world, (WARMUP_STEPS + TIMED_STEPS) * ACC * MBS)
    pipe = TrainPipeline(ds, micro_batch_size=MBS, grad_acc_steps=ACC,
                         seed=0, device="cuda", with_features=False)
    D = torch.from_numpy(np.random.RandomState(0).rand(
        cfg.num_labels, cfg.num_labels).astype(np.float32)).cuda()
    params = dict(model.named_parameters())
    opt = make_optimizer(list(params), warmup_linear_schedule(4e-5, 2000, 20000))
    state = TrainState(model, opt.init(params), 0)
    step = make_train_step(opt, D, semantic_lambda=LAMBDA,
                           compute_dtype=torch.bfloat16, fused_attn="flat")
    bank = world.bank.tensors()
    before = {k: p.detach().clone() for k, p in params.items()}
    batches = pipe.epoch(0)
    metrics = []
    for i in range(WARMUP_STEPS):
        state, m = step(state, next(batches), seed=i, bank=bank)
        metrics.append(m)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for i in range(TIMED_STEPS):
        state, m = step(state, next(batches), seed=WARMUP_STEPS + i, bank=bank)
        metrics.append(m)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    batches.close()
    n_blocks = cfg.num_layers * ACC
    print(f"train: {TIMED_STEPS} steps of {ACC} x {MBS} in {dt:.3f} s -> "
          f"{dt / TIMED_STEPS * 1e3:.2f} ms/step, "
          f"{TIMED_STEPS * ACC * MBS / dt:.1f} QA/s (bf16, fp32 master "
          f"weights, dropout {RATE}, lambda {LAMBDA}, flat training attention, "
          f"bank on) on {smi}; launches {counts}")
    check(counts == {"flat_attention": 0, "rows_gather": ACC * TIMED_STEPS,
                     "flat_attention_train_fwd": n_blocks * TIMED_STEPS,
                     "flat_attention_train_bwd": n_blocks * TIMED_STEPS},
          f"train launches {counts}, expected per step {n_blocks} B1 forward, "
          f"{n_blocks} B1 backward and {ACC} rows_gather")
    losses = torch.stack([m["loss"] for m in metrics]).cpu()
    norms = torch.stack([m["grad_norm"] for m in metrics]).cpu()
    print(f"train loss {losses[0]:.4f} -> {losses[-1]:.4f}, grad_norm "
          f"{norms[0]:.4f} -> {norms[-1]:.4f} over {len(metrics)} steps")
    check(bool(torch.isfinite(losses).all() and torch.isfinite(norms).all()),
          "train loss or grad_norm not finite")
    moved = max((p.detach() - before[k]).abs().max().item()
                for k, p in params.items())
    print(f"parameters moved: max |change| {moved:.3g} (lr 4e-5 warming up "
          f"over 2000 steps)")
    check(moved > 0, "the parameters did not move")
    check(state.step == WARMUP_STEPS + TIMED_STEPS, "step count")
    return {"launches": counts, "ms_per_step": dt / TIMED_STEPS * 1e3,
            "qa_per_s": TIMED_STEPS * ACC * MBS / dt}


def _tiny_batch(r: np.random.RandomState, acc: int, mbs: int, T: int, R: int,
                feat: int, vocab: int, num_labels: int) -> dict:
    ids = r.randint(3, vocab, (acc, mbs, T)).astype(np.int32)
    ids[:, 1, T - 3:] = 1
    return {"input_ids": ids, "input_mask": (ids != 1).astype(np.int32),
            "features": r.randn(acc, mbs, R, feat).astype(np.float32),
            "locs": r.rand(acc, mbs, R, 7).astype(np.float32),
            "image_mask": np.ones((acc, mbs, R), np.int32),
            "labels": r.randint(0, num_labels, (acc, mbs)).astype(np.int32)}


def phase_train_parity() -> None:
    """fp32, dropout 0: (a) a tiny UC2 (hd 64) trained 3 steps on the card
    through the kernels and on the CPU through the plain path; (b) at full
    width, the kernel route's loss and gradients against the plain
    route's, then one train step on each. Tolerance 1e-4: relative for
    losses and gradient norms, of the largest gradient for gradients,
    absolute for parameters (lr 1e-5, so no update exceeds ~2e-5)."""
    quiet = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                 clf_dropout_prob=0.0)
    tiny = UC2Config(vocab_size=300, hidden_size=128, num_layers=2, num_heads=2,
                     intermediate_size=256, v_feature_size=64, num_locs=7,
                     pooler_size=128, clf_hidden_size=64, num_labels=40, **quiet)
    r = np.random.RandomState(3)
    batches = [_tiny_batch(r, 2, 4, 11, 9, 64, 300, 40) for _ in range(3)]
    D = r.rand(40, 40).astype(np.float32)
    runs = {}
    gpu = UC2(tiny, device="cuda", seed=4)
    cpu = load_numpy_state(UC2(tiny, device="cpu"),
                           {k: v.cpu().numpy() for k, v in gpu.state_dict().items()})
    for dev, fused, model in (("cuda", "flat", gpu), ("cpu", False, cpu)):
        params = dict(model.named_parameters())
        opt = make_optimizer(list(params), warmup_constant_schedule(1e-5, 0))
        state = TrainState(model, opt.init(params), 0)
        step = make_train_step(opt, torch.from_numpy(D).to(dev),
                               semantic_lambda=LAMBDA, compute_dtype=None,
                               fused_attn=fused)
        ms = []
        for i, b in enumerate(batches):
            state, m = step(state, {k: torch.from_numpy(v).to(dev)
                                    for k, v in b.items()}, seed=i)
            ms.append((m["loss"].item(), m["grad_norm"].item()))
        runs[dev] = ms, {k: p.detach().cpu() for k, p in params.items()}
    (mk, pk), (mp, pp) = runs["cuda"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for x, y in zip(mk, mp) for a, b in zip(x, y))
    perr = max((pk[k] - pp[k]).abs().max().item() for k in pp)
    print(f"train parity, tiny UC2 fp32, 3 steps, card kernels vs CPU plain: "
          f"loss/grad_norm max rel diff {rel:.3g}, params max abs diff "
          f"{perr:.3g} (tol 1e-4)")
    check(rel <= 1e-4 and perr <= 1e-4, "tiny train parity failed")

    cfg = UC2Config(**quiet)
    b = _tiny_batch(r, 1, 32, 40, R, cfg.v_feature_size, cfg.vocab_size,
                    cfg.num_labels)
    batch = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
    D = torch.from_numpy(r.rand(cfg.num_labels, cfg.num_labels)
                         .astype(np.float32)).cuda()
    model = UC2(cfg, device="cuda", seed=5)
    params = dict(model.named_parameters())
    grads = {}
    for fused in ("flat", False):
        loss_fn = make_loss_fn(D, semantic_lambda=LAMBDA, compute_dtype=None,
                               fused_attn=fused)
        loss, _ = loss_fn(model, {k: v[0] for k, v in batch.items()}, seed=0)
        gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads[fused] = (loss.item(), [g for g in gs if g is not None])
    (lk, gk), (lp, gp) = grads["flat"], grads[False]
    gmax = max(g.abs().max().item() for g in gp)
    gerr = max((a - b).abs().max().item() for a, b in zip(gk, gp))
    print(f"train parity, full width fp32 mbs 32: loss {lk:.6f} vs {lp:.6f}; "
          f"grads max abs diff {gerr:.3g} of max |grad| {gmax:.3g} (tol 1e-4 "
          f"of it)")
    check(abs(lk - lp) <= 1e-4 * abs(lp) and gerr <= 1e-4 * gmax,
          "full-width kernel route vs plain route gradients differ")
    del grads, gk, gp
    stepped = {}
    for fused in ("flat", False):
        m2 = UC2(cfg, device="cuda", seed=5)
        p2 = dict(m2.named_parameters())
        opt = make_optimizer(list(p2), warmup_constant_schedule(1e-5, 0))
        state = TrainState(m2, opt.init(p2), 0)
        step = make_train_step(opt, D, semantic_lambda=LAMBDA,
                               compute_dtype=None, fused_attn=fused)
        state, m = step(state, batch, seed=0)
        stepped[fused] = (m["loss"].item(), m["grad_norm"].item(), p2)
        del state, opt, step
    (lk, nk, pk), (lp, np_, pp) = stepped["flat"], stepped[False]
    perr = max((pk[k] - pp[k]).abs().max().item() for k in pp)
    print(f"train parity, one full-width fp32 step: loss {lk:.6f} vs {lp:.6f}, "
          f"grad_norm {nk:.6f} vs {np_:.6f}, params max abs diff {perr:.3g}")
    check(abs(lk - lp) <= 1e-4 * abs(lp) and abs(nk - np_) <= 1e-4 * abs(np_)
          and perr <= 1e-4, "full-width train step: kernel vs plain route")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    kern = phase_kernels()
    kern.update(phase_train_kernel(torch.Generator("cuda").manual_seed(1)))
    cfg = UC2Config()
    model = UC2(cfg, device="cuda", seed=0)
    print(f"UC2 {cfg.num_layers}x{cfg.hidden_size}, vocab {cfg.vocab_size}, "
          f"{cfg.num_labels} labels: "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params")
    with tempfile.TemporaryDirectory() as tmp:
        main_path = phase_main_path(tmp, cfg, model)
        w = main_path["world"]
        phase_parity(cfg, model, w.dataset, w.bank)
        train = phase_train(cfg, model, w, smi)
    del model
    torch.cuda.empty_cache()
    phase_train_parity()
    # `launches`: the count of the kernel's own slice's main path (run_eval
    # for the eval kernels, the train step for B1); `launches_by_path`
    # gives each path's own count
    by_path = dict(main_path["launches"], train=train["launches"])
    bf16 = torch.bfloat16
    kernels = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": by_path[path][name],
         "launches_by_path": {p: c[name] for p, c in by_path.items()},
         **kern[key]}
        for name, path, key, source, replaces in (
            ("flat_attention", "run_eval", f"flat_attention/{bf16}",
             "clg_vqa_tpu_torch/csrc/flat_attention.cu",
             "clg_vqa_tpu/ops/attention.py:385"),
            ("rows_gather", "run_eval", "rows_gather",
             "clg_vqa_tpu_torch/csrc/rows_gather.cu",
             "clg_vqa_tpu/ops/bank_gather.py:34"),
            ("flat_attention_train_fwd", "train",
             f"flat_attention_train_fwd/{bf16}",
             "clg_vqa_tpu_torch/csrc/flat_attention_train.cu",
             "clg_vqa_tpu/ops/attention.py:385"),
            ("flat_attention_train_bwd", "train",
             f"flat_attention_train_bwd/{bf16}",
             "clg_vqa_tpu_torch/csrc/flat_attention_train.cu",
             "clg_vqa_tpu/ops/attention.py:413"))
    ]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
