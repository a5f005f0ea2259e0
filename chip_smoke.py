#!/usr/bin/env python3
"""Drive the PyTorch port (clg_vqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero without the
final line:
 1. device line: the card's name and power limit (nvidia-smi) and CUDA.
 2. build both CUDA kernels with nvcc (sm_90a) from csrc/, all at once.
 3. each kernel against its plain PyTorch version on the card at the main
    path's shapes, timed with CUDA events beside its bound, the plain
    version and one library call used only as a yardstick here.
 4. the main path at UC2's full width (12 x 768, vocab 250002, 1842
    answers; random weights from a seed): run_eval at batch 1024 in bf16
    over a synthetic 400-image CFS store and device feature bank, then
    Predictor requests. Launch counters, reset just before, show both
    kernels ran on this path.
 5. path parity: fp32 logits of the flat-kernel path against the plain
    path on one full-width batch, and a tiny UC2 on the card against the
    same weights on the CPU.
Then one JSON line listing the kernels, and as the last line
{"ok": true, "device": {...}}.
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
from clg_vqa_tpu_torch.data.synthetic import REGIONS as R, eval_world
from clg_vqa_tpu_torch.eval.predictor import Predictor
from clg_vqa_tpu_torch.eval.runner import make_predict_step, run_eval
from clg_vqa_tpu_torch.models.uc2 import UC2
from clg_vqa_tpu_torch.ops import _build
from clg_vqa_tpu_torch.ops.attention import (fused_attention_flat,
                                             fused_attention_flat_plain)
from clg_vqa_tpu_torch.ops.bank_gather import rows_gather, rows_gather_plain
from clg_vqa_tpu_torch.utils.convert import load_numpy_state

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

EVAL_BS = 1024
N_IMAGES, N_QA = 400, 8192
N_REQUESTS = 64


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
    built = _build.build(["flat_attention", "rows_gather"])
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


def reset_counts() -> None:
    fused_attention_flat.launches = 0
    rows_gather.launches = 0


def read_counts() -> dict:
    return {"flat_attention": fused_attention_flat.launches,
            "rows_gather": rows_gather.launches}


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
                          "rows_gather": n_batches},
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
    check(pred_counts == {"flat_attention": 0, "rows_gather": N_REQUESTS // 8},
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
            "ds": w.dataset, "bank": w.bank, "qa_per_s": res["n"] / dt}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    kern = phase_kernels()
    cfg = UC2Config()
    model = UC2(cfg, device="cuda", seed=0)
    print(f"UC2 {cfg.num_layers}x{cfg.hidden_size}, vocab {cfg.vocab_size}, "
          f"{cfg.num_labels} labels: "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params")
    with tempfile.TemporaryDirectory() as tmp:
        main_path = phase_main_path(tmp, cfg, model)
        phase_parity(cfg, model, main_path["ds"], main_path["bank"])
    # `launches`: run_eval's count (the main path); `launches_by_path`
    # gives each path's own count
    by_path = main_path["launches"]
    kernels = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": by_path["run_eval"][name],
         "launches_by_path": {p: c[name] for p, c in by_path.items()},
         **kern[key]}
        for name, key, source, replaces in (
            ("flat_attention", f"flat_attention/{torch.bfloat16}",
             "clg_vqa_tpu_torch/csrc/flat_attention.cu",
             "clg_vqa_tpu/ops/attention.py:385"),
            ("rows_gather", "rows_gather",
             "clg_vqa_tpu_torch/csrc/rows_gather.cu",
             "clg_vqa_tpu/ops/bank_gather.py:34"))
    ]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
