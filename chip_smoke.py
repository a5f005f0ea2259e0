#!/usr/bin/env python3
"""Drive the PyTorch port (clg_vqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero without the
final line:
 1. device line: the card's name and power limit (nvidia-smi) and CUDA.
 2. build the eight CUDA kernel sources with nvcc (sm_90a) from csrc/, one
    nvcc each, all at once.
 3. each kernel against its plain PyTorch version on the card at the main
    paths' shapes, timed with CUDA events beside its bound, the plain
    version and one library call used only as a yardstick here. K1 and B2
    in bf16 run one tensor-core kernel (csrc/attention_eval.cuh) at every
    S; two launches of each on the same inputs are bit-equal. The
    training attention (B1) is also held to its dropout semantics: the
    kernels' keep mask is the plain version's, runs are bit-deterministic,
    the keep fraction is t/256, and <dv, v> equals the loss (in bf16 on the
    tensor-core forward and backward of csrc/attention_train_mma.cuh, the
    backward reading the keep bits the forward stored). The S-major
    training attention (B5) is held to its plain version and to B1, bit
    for bit, and its entry's layout copies are timed. The whole-block
    training attention (B4: projections, core, output projection; in bf16
    the products on wgmma fed by TMA, csrc/gemm_wgmma.cuh, and the core on
    the tensor-core kernels) is held to its plain version (y and every
    gradient, S 13, 76 and 140, fp32 and bf16, rates 0 and 0.1), its y to
    the flat route's (linear, B1, linear) on one seed, its keep mask to
    B1's, and with identity weights and zero biases to B1 bit for bit (y,
    the bias gradient summed over heads in order, dx = (dq + dk) + dv);
    with identity q/k/v weights and a random Wo its core, taking dctx as
    hi + lo bf16 terms, is held to B1's gates against the plain core on the
    fp32 dctx, which hi alone misses; it is bit-deterministic, and timed beside its bound, the plain version,
    multi_head_attention_forward and the flat route. The bank row gather
    (K2) is held bit for bit to its plain version and timed in turns with
    index_select at the eval (x 1024), train (x 128) and serving (x 8) calls
    on UC2's [400, 36, 2048] fp32 bank and at M3P eval's [400, 100, 2048].
 4. the eval path at UC2's full width (12 x 768, vocab 250002, 1842
    answers; random weights from a seed): run_eval at batch 1024 in bf16
    over a synthetic 400-image CFS store and device feature bank, then
    Predictor requests.
 5. eval path parity: fp32 logits of the flat-kernel path against the
    plain path on one full-width batch, and a tiny UC2 on the card against
    the same weights on the CPU.
 6. the training path at full width: the UC2 GQA fine-tune step of
    bench.py:54-92 (acc 2 x mbs 128, bf16 with fp32 master weights, dropout
    0.1, lambda 10, device bank), fed by TrainPipeline: 2 warm-up steps,
    then timed steps, with the flat training attention (B1) and then with
    the whole-block one (fused_attn="proj", B4); then the same step with
    the flat and the S-major training attention timed in turns; then
    `python -m clg_vqa_tpu_torch.cli train --fused_attn proj` at full width
    for a few steps over the same store, in process; then the paper's
    sparse fine-tuning through the CLI in process: `prune` for 2 IMP rounds
    (B1 steps, the 10% prune on the card, the rewind to theta_0, a val pass
    on theta_0 * mask with K1) and `sft --mask_file <prune out>/mask_best.npz`
    for one epoch, with the masks' zero counts held exactly to round(0.1 N)
    and round(0.1 (N - first)) of the model's prunable count N, their files
    to the JAX package's layout, and every pruned weight exactly 0 in the
    SFT export and final state; imp_prune_step timed alone.
 7. training parity: a tiny UC2 trained 3 steps on the card (kernels)
    and on the CPU (plain path), and the full-width fp32 gradients of the
    flat (B1) and whole-block (B4) routes against the plain route.
 8. the fine-tune recipe at full width: FinetuneRunner.finetune with the
    S-major training attention (fused_attn="sm"), bf16, dropout 0.1,
    lambda 10, acc 2 x mbs 128, device bank, one epoch over
    data/synthetic.train_dataset, val over 1,024 questions (K1), the
    best-params and full-state saves and a VOLTA .bin export; the .bin
    reloaded into a fresh model gives the trained model's fp32 logits.
 9. recipe parity at tiny width, for fused_attn "flat", "sm" and "proj": a run
    preempted at step 2 and resumed in a fresh runner ends with the
    uninterrupted run's parameters, bit for bit.
10. M3P at its published width (S = 140) over a world whose images hold
    10-100 boxes (the prefix-length mask quirk and -inf keys occur): run_eval
    with the auto rule (K1) and with fused_attn=True (B2), Predictor
    requests, fp32 logits of K1 and B2 against the plain route; the train
    step with fused_attn "flat" (B1) and True (B3; "hm" is the same route
    in the port) from the same weights, their step-1 losses within 1%;
    `cli train --is_m3p` in process with a .bin export that
    reloads to equal logits; then a tiny M3P on the card against the CPU
    (eval, and 3 train steps through "hm") and full-width fp32 gradients of
    True against the plain route.
    Then the train step at a task length of 60 tokens (S = 160) on the
    auto route, which runs B1's tensor-core backward at its one-chunk limit
    (10 warps at hd 64).
11. the detector: RoIPool (B6) at the C4 extractor's shape ([50, 84, 1024]
    bf16, 300 rois) bit-exact against its plain version, also on a map with
    NaN and infinities, and timed; then
    `python -m clg_vqa_tpu_torch.cli extract --detector c4` in process at
    full width and depth (R101-C4, pad 800 x 1344, bf16, random weights
    from seed 0) over 8 synthetic 480 x 640 images (one B6 launch each),
    the store read back, the extractor timed warm, B6 timed on one image's
    own feature map and proposals, and a full-width UC2
    run_eval over 64 questions on the extracted store (K1, K2). Then
    `python -m clg_vqa_tpu_torch.cli extract --detector x101` in process at
    full width and depth (X101Config(): ResNeXt-101 64x4d, FPN 512, 1000
    proposals a level and after the merged NMS, RoIAlign 7 x 7, fc6/fc7
    2048, 100 boxes, pad 800 x 1344, bf16, random weights from seed 0) over
    the same 8 images (no kernel of the port on that path: convs, GEMMs,
    RoIAlign and the fixpoint NMS are torch ops), the store read back (100
    regions x 2048 finite features, boxes inside the image, the boxes kept
    by the class NMS counted), ExtractorX101.extract_many timed warm at
    device_batch 1 and 4 with its peak memory and the fixpoint NMS's host
    reads, its records held to the CLI's (device_batch 4 to bf16 rounding
    of other conv algorithms), and a full-width M3P run_eval (auto, bf16, 100 regions, 5 locs,
    L2-normalized features) over 1,024 questions on that store (K1 12, K2 1).
Phase 3 also holds the M3P path's kernels to M3P's -inf key bias: K1 and B1
at S 140, B2 (head-blocked eval) and B3 (head-blocked training, both
entries) against their plain versions and equal to B1 bit for bit (bf16:
the tensor-core kernels of csrc/attention_train_mma.cuh), B3's keep mask
B1's whatever the batch size, two runs bit-equal; the bf16 kernels of
B1 (flat), B5 (S-major) and B3 (head-major), one tensor-core device code at
three strides, equal bit for bit (output and every gradient) at
[128, 76, 768] under UC2's -10000 keys and at M3P's S 140 and 160 under
-inf keys, within tolerance of the plain version, with B1's and B5's bf16
keep masks the plain mask; the forward and the backward alone timed in the
three layouts in turns at S 76 and 140, and B1's and B5's at S 140 and 160
beside SDPA; and S past the CUDA-core kernels' shared memory, where fp32
takes their key-blocked variant: B1 at S 159 and 612 (values, gradients,
keep mask; in bf16 the tensor-core kernels) against its plain version, B5
and B3 (both entries) equal to it bit for bit in both dtypes, B4 at S 159
and 612 (fp32 key-blocked, bf16 the tensor-core core), K1 and B2 at S 418
and 612, and B1's bf16 times there.
Launch counters, set to 0 just before each path's timed run and read just
after, show which kernels each path ran. Then one JSON line listing the
kernels, and as the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import os
import pickle
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from clg_vqa_tpu_torch.cli.__main__ import main as cli_main
from clg_vqa_tpu_torch.cli.common import build_model as cli_build_model
from clg_vqa_tpu_torch.cli.common import load_pretrained
from clg_vqa_tpu_torch.config import (M3PConfig, OptimConfig, TaskConfig,
                                      UC2Config)
from clg_vqa_tpu_torch.data.cfs import CfsReader
from clg_vqa_tpu_torch.data.device_bank import DeviceFeatureBank
from clg_vqa_tpu_torch.data.gqa import Entry, GQADataset
from clg_vqa_tpu_torch.data.pipeline import TrainPipeline
from clg_vqa_tpu_torch.data.synthetic import (REGIONS as R, eval_world,
                                              m3p_world, make_entries,
                                              train_dataset, write_store)
from clg_vqa_tpu_torch.data.tokenizer import HashTokenizer
from clg_vqa_tpu_torch.eval.predictor import Predictor
from clg_vqa_tpu_torch.eval.runner import make_predict_step, run_eval
from clg_vqa_tpu_torch.models.detector.extractor import (
    Extractor36, ExtractorConfig, init_extractor_params)
from clg_vqa_tpu_torch.models.detector.extractor_x101 import (
    ExtractorX101, X101Config, init_x101_params)
from clg_vqa_tpu_torch.models.m3p import M3P
from clg_vqa_tpu_torch.models.uc2 import UC2
from clg_vqa_tpu_torch.ops import _build
from clg_vqa_tpu_torch.ops.attention import (
    _FLAT, _HM, _SM, _bias2, _launch_eval, _launch_train_bwd,
    _launch_train_fwd, _train_buffers,
    dropout_keep_mask, fused_attention, fused_attention_flat,
    fused_attention_flat_plain, fused_attention_smajor,
    fused_attention_smajor_plain, fused_attention_train,
    fused_attention_train_flat, fused_attention_train_flat_plain,
    fused_attention_train_hm, fused_attention_train_hm_plain,
    fused_attention_train_smajor,
    fused_attention_train_smajor_plain, keep_threshold, realized_keep_mask,
    smajor_attention_core, smajor_attention_core_plain)
from clg_vqa_tpu_torch.ops.bank_gather import rows_gather, rows_gather_plain
from clg_vqa_tpu_torch.ops.nms import batched_nms_fixpoint
from clg_vqa_tpu_torch.ops.block_attention import (
    _core_backward_plain, fused_attention_block, fused_attention_block_plain,
    realized_block_keep_mask)
from clg_vqa_tpu_torch.ops.roi_pool import roi_pool_nhwc, roi_pool_nhwc_plain
from clg_vqa_tpu_torch.tools.measure import bound_ms, c4_rois, time_ms
from clg_vqa_tpu_torch.tools.profile_block import flat_route
from clg_vqa_tpu_torch.train.checkpoints import export_torch_bin
from clg_vqa_tpu_torch.train.driver import FinetuneRunner
from clg_vqa_tpu_torch.train import pruning as pr
from clg_vqa_tpu_torch.train.loop import (TrainState, make_loss_fn,
                                          make_train_step)
from clg_vqa_tpu_torch.train.optim import (make_optimizer,
                                           warmup_constant_schedule,
                                           warmup_linear_schedule)
from clg_vqa_tpu_torch.utils.convert import load_numpy_state

EVAL_BS = 1024
N_IMAGES, N_QA = 400, 8192
N_REQUESTS = 64
# the training envelope of bench.py:80-92
ACC, MBS, LAMBDA = 2, 128, 10.0
WARMUP_STEPS, TIMED_STEPS = 2, 10
RATE = 0.1                   # UC2Config's dropout; keep threshold t = 230
RECIPE_STEPS, N_VAL = 12, 1024
CLI_STEPS, CLI_VAL = 3, 1024
# ten (flat, sm) pairs of blocks, alternating which route runs first
AB_STEPS, AB_ORDER = 10, ("flat", "sm", "sm", "flat") * 5
# M3P's world: images of 10..100 boxes, as a detector's confidence
# threshold leaves them (X101 features, max_region_num 100)
M3P_MIN_REGIONS = 10
# S = 100 + 60 = 160: B1's bf16 backward at its one-chunk limit (10 warps)
M3P_LONG_SEQ = 60
# the extraction phase: 8 synthetic 480 x 640 images through the C4 detector
# at full width (R101, pad 800 x 1344, bf16), then UC2 eval over the store
N_EXTRACT, EXTRACT_HW, EXTRACT_QA = 8, (480, 640), 64
# M3P eval over the X101 store: one batch of 1024 (auto takes K1 from 512)
X101_QA, X101_BATCHES = 1024, (1, 4)
C4_SHAPE, C4_ROIS = (50, 84, 1024), 300


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def bf16_ulp(x: float) -> float:
    """One bf16 ulp (8 significant bits) at magnitude x."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def core_note(q, nbytes: float, ops: float) -> str:
    """Which device code B1's, B5's and B3's training kernels run in q's
    dtype; for the fp32 CUDA-core code, its bound at the CUDA cores' peak."""
    if q.dtype == torch.bfloat16:
        return "tensor cores (csrc/attention_train_mma.cuh)"
    fp32_bms, _ = bound_ms(nbytes, ops, torch.float32)
    return (f"fp32 CUDA cores (csrc/attention_train.cuh), bound there "
            f"{fp32_bms:.4f} ms")


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
                          "rows_gather", "smajor_attention_train",
                          "block_attention_train", "blocked_attention",
                          "blocked_attention_train", "roi_pool"])
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

    # K1 at odd shapes first: S=13 (tiny), S=140 (two passes of the bf16
    # kernel; the fp32 kernel's shared memory above 48 KB)
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
        check(torch.equal(got, fused_attention_flat(q, k, v, bias, H)),
              f"K1 {dtype}: two launches on the same inputs differ")
        ms = time_ms(lambda: fused_attention_flat(q, k, v, bias, H))
        plain = time_ms(lambda: fused_attention_flat_plain(q, k, v, bias, H))
        qh, kh, vh = (t.view(B, S, H, hd).transpose(1, 2) for t in (q, k, v))
        mask = bias.to(dtype)
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask))
        nbytes = 4 * B * S * H * hd * q.element_size() + B * S * 4
        ops = 4 * B * H * S * S * hd
        bms, by = bound_ms(nbytes, ops, dtype)
        print(f"K1 {dtype}: kernel {ms:.4f} ms ({bms / ms:.1%} of its bound), "
              f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.4f} ms "
              f"({by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP); two "
              f"launches bit-equal")
        out[f"flat_attention/{dtype}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
            bound_ms=bms, bound_by=by)

    out["rows_gather"] = phase_rows_gather(gen)
    return out


def gather_case(bank, idx, label: str) -> dict:
    """K2 at one call's shape: bit-exact against its plain version, then the
    kernel and index_select timed in turns (kernel, library, library,
    kernel) beside the byte bound: each distinct bank row the call touches
    read once, every output row written once, the indices read once."""
    got = rows_gather(bank, idx)
    check(torch.equal(got, rows_gather_plain(bank, idx)), f"K2 {label} is not bit-exact")
    kern = lambda: rows_gather(bank, idx)                  # noqa: E731
    lib = lambda: torch.index_select(bank, 0, idx)         # noqa: E731
    k1, l1, l2, k2 = time_ms(kern), time_ms(lib), time_ms(lib), time_ms(kern)
    n_unique = torch.unique(idx).numel()
    row = bank[0].numel() * bank.element_size()
    nbytes = (n_unique + idx.numel()) * row + idx.numel() * 4
    bms, by = bound_ms(nbytes, 0, torch.float32)
    ms, lib_ms = (k1 + k2) / 2, (l1 + l2) / 2
    print(f"K2 {label}: {list(bank.shape)} {bank.dtype} x {idx.numel()} "
          f"({n_unique} distinct rows): bit-exact; kernel {k1:.4f} / {k2:.4f} ms, "
          f"index_select {l1:.4f} / {l2:.4f} ms (in turns; kernel / library "
          f"{ms / lib_ms:.2f}x), bound {bms:.4f} ms ({by}; {nbytes / 1e6:.1f} MB; "
          f"{bms / ms:.1%} of it)")
    return dict(ms=ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                kernel_ms_in_turns=[k1, k2], library_ms_in_turns=[l1, l2])


def phase_rows_gather(gen) -> dict:
    """K2, the bank row gather (csrc/rows_gather.cu), at the main
    paths' calls: UC2 eval (bank [400, 36, 2048] fp32 x 1024 indices; the
    kernel line's numbers), the train step's (x 128), serving's (x 8) and
    M3P eval's rows ([400, 100, 2048] x 1024); then the eval call's plain
    version alone."""
    N, C = N_IMAGES, 2048
    bank = torch.randn(N, R, C, device="cuda", generator=gen)
    calls, idxs = {}, {}
    for label, B in (("eval", EVAL_BS), ("train", MBS), ("serving", 8)):
        idxs[label] = torch.randint(0, N, (B,), device="cuda", generator=gen,
                                    dtype=torch.int32)
        calls[label] = gather_case(bank, idxs[label], label)
    plain = time_ms(lambda: rows_gather_plain(bank, idxs["eval"]))
    del bank
    m3p = torch.randn(N, 100, C, device="cuda", generator=gen)
    idx = torch.randint(0, N, (EVAL_BS,), device="cuda", generator=gen, dtype=torch.int32)
    calls["m3p_eval"] = gather_case(m3p, idx, "m3p_eval")
    del m3p
    torch.cuda.empty_cache()
    ev = calls["eval"]
    return dict(max_abs_err=0.0, ms=ev["ms"], plain_ms=plain, library_ms=ev["library_ms"],
                bound_ms=ev["bound_ms"], bound_by=ev["bound_by"], calls=calls)


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
        pair = (" (tensor-core forward and backward, one stored mask)"
                if dtype == torch.bfloat16 else "")
        print(f"B1 {dtype} v-linearity{pair}: <dv, v> {inner:.6g}, loss "
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
        fwd_ms, bwd_ms = bare_train_ms(_FLAT, q, k, v, bias, do, B, S, H, **kw)
        with torch.no_grad():
            fwd_entry = time_ms(lambda: fused_attention_train_flat(
                q, k, v, bias, H, **kw))
            fwd_plain = time_ms(lambda: fused_attention_train_flat_plain(
                q, k, v, bias, H, **kw))
            fwd_lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask_s))
        bwd_entry = time_ms(lambda: torch.autograd.grad(
            o_k, (qr, kr, vr, br), do, retain_graph=True))
        bwd_plain = time_ms(lambda: torch.autograd.grad(
            o_p, (qr, kr, vr, br), do, retain_graph=True))
        bwd_lib = time_ms(lambda: torch.autograd.grad(
            o_s, (qr, kr, vr), do_s, retain_graph=True))
        for name, ms, entry, plain, lib, nbytes, ops in (
                ("fwd", fwd_ms, fwd_entry, fwd_plain, fwd_lib, fwd_bytes,
                 fwd_ops),
                ("bwd", bwd_ms, bwd_entry, bwd_plain, bwd_lib, bwd_bytes,
                 bwd_ops)):
            bms, by = bound_ms(nbytes, ops, dtype)
            print(f"B1 {name} {dtype} rate {RATE}: kernel {ms:.4f} ms ({bms / ms:.1%} "
                  f"of its bound; bare launch; through the entry and autograd "
                  f"{entry:.4f} ms), plain {plain:.4f} ms, sdpa (rate 0) "
                  f"{lib:.4f} ms, bound {bms:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
                  f"{ops / 1e9:.2f} GFLOP); {core_note(q, nbytes, ops)}")
            out[f"flat_attention_train_{name}/{dtype}"] = dict(
                max_abs_err=(err["out"] if name == "fwd"
                             else max(err["dq"], err["dk"], err["dv"],
                                      err["dbias"])),
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                bound_by=by, entry_ms=entry)

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
    # the bf16 forward (tensor cores) realizes the same bits, and stores them
    # for the bf16 backward; B5's entry on its strides too
    for name, train in (("B1", fused_attention_train_flat),
                        ("B5", fused_attention_train_smajor)):
        check(torch.equal(realized_keep_mask(11, B, H, S, hd, RATE, "cuda",
                                             train=train, dtype=torch.bfloat16),
                          want), f"{name} bf16 forward's keep mask differs")
    print(f"B1 and B5 bf16 forwards (tensor cores) realize the same keep mask "
          f"[{B},{H},{S},{S}]")
    return out


def value_and_grads(fn, q, k, v, bias, do, H, **kw):
    """fn's output and (dq, dk, dv, dbias) for the cotangent do."""
    ins = [t.detach().requires_grad_() for t in (q, k, v, bias)]
    out = fn(*ins, H, **kw)
    return (out.detach(), *torch.autograd.grad(out, ins, do))


def bare_train_ms(name, q, k, v, bias, do, B, S, H, *, dropout_rate, seed):
    """Median ms of the training kernels of ``csrc/<name>.cu`` on prepared
    contiguous operands of their layout, as B2 is timed: the forward launch
    into preallocated outputs (in bf16 with the row statistics and keep bits
    it writes for its backward), and the backward launch, reading what the
    forward's timed launches left, with its gradients' allocation and the
    head sum of the bias gradient, as the entry takes it. No autograd and no operand
    copies are in the interval."""
    t = keep_threshold(dropout_rate)
    b2 = _bias2(bias, B, S)
    q, k, v, do = (x.detach().contiguous() for x in (q, k, v, do))
    o = torch.empty_like(q)
    saved = _train_buffers(q, B, H, S, t)
    return (time_ms(lambda: _launch_train_fwd(name, q, k, v, b2, o, B, S, H,
                                              t, seed, *saved)),
            time_ms(lambda: _launch_train_bwd(name, q, k, v, b2, do, B, S, H,
                                              t, seed, *saved)[3].sum(1)))


def phase_smajor_kernel(gen) -> dict:
    """B5 at the recipe's shapes (q/k/v [128, 76, 768], bf16 and fp32, rate
    0.1): against its plain version with B1's tolerances, and equal to B1
    bit for bit, forward and backward, on the same inputs and seed. Times:
    the S-major kernels' bare launches (as B1's: bare_train_ms) and the core
    entry with autograd, its plain version on S-major operands, SDPA as a
    yardstick, and the entry's layout copies."""
    B, S, H, hd = MBS, 76, 12, 64
    kw = dict(dropout_rate=RATE, seed=11)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias = attention_inputs(B, S, H, hd, dtype, gen)
        do = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
        c0 = fused_attention_train_smajor.layout_copies
        got = value_and_grads(fused_attention_train_smajor, q, k, v, bias, do,
                              H, **kw)
        copies = fused_attention_train_smajor.layout_copies - c0
        want = value_and_grads(fused_attention_train_smajor_plain, q, k, v,
                               bias, do, H, **kw)
        flat = value_and_grads(fused_attention_train_flat, q, k, v, bias, do,
                               H, **kw)
        torch.cuda.synchronize()
        errs = {}
        for i, name in enumerate(("out", "dq", "dk", "dv", "dbias")):
            scale = want[i].float().abs().max().item()
            if name == "dbias":
                tol = 1e-4 * scale
            elif dtype == torch.float32:
                tol = 1e-5 if name == "out" else 2e-4 * scale
            else:
                tol = bf16_ulp(scale) * (1 if name == "out" else 2)
            err = (got[i].float() - want[i].float()).abs().max().item()
            check(got[i].dtype == want[i].dtype, f"B5 {dtype} {name} dtype")
            check(err <= tol, f"B5 {dtype} {name} disagrees: {err} > {tol}")
            check(torch.equal(got[i], flat[i]),
                  f"B5 {dtype} {name} is not B1's bit for bit")
            errs[name] = err
        check(copies == 8, f"B5 entry made {copies} layout copies, expected 8")
        print(f"B5 B={B} S={S} {dtype} rate {RATE}: max abs err vs plain "
              + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
              + "; out, dq, dk, dv, dbias equal B1's bit for bit; "
              f"{copies} layout copies (4 forward, 4 backward)")
        with torch.no_grad():
            ev = fused_attention_smajor(q, k, v, bias, H)
            ev_err = (ev.float() - fused_attention_smajor_plain(
                q, k, v, bias, H).float()).abs().max().item()
        ev_tol = 1e-5 if dtype == torch.float32 else bf16_ulp(
            ev.float().abs().max().item())
        check(ev_err <= ev_tol, f"B5 eval twin {dtype} disagrees: {ev_err}")
        try:
            fused_attention_smajor(q.detach().requires_grad_(), k, v, bias, H)
            check(False, "B5 eval twin accepted grad mode")
        except RuntimeError as e:
            check("no backward" in str(e), f"B5 eval twin: {e}")
        print(f"B5 eval twin {dtype}: max abs err {ev_err:.3g} (tol "
              f"{ev_tol:.3g}); refuses grad mode")

        qs, ks, vs = (x.transpose(0, 1).contiguous().requires_grad_()
                      for x in (q, k, v))
        br = bias.detach().requires_grad_()
        dos = do.transpose(0, 1).contiguous()
        o_k = smajor_attention_core(qs, ks, vs, br, H, **kw)
        o_p = smajor_attention_core_plain(qs, ks, vs, br, H, **kw)
        qh, kh, vh = (x.detach().view(B, S, H, hd).transpose(1, 2)
                      .requires_grad_() for x in (q, k, v))
        o_s = torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=bias.to(dtype))
        do_s = do.view(B, S, H, hd).transpose(1, 2)
        fwd_ms, bwd_ms = bare_train_ms(_SM, qs, ks, vs, bias, dos, B, S, H, **kw)
        with torch.no_grad():
            fwd_entry = time_ms(lambda: smajor_attention_core(qs, ks, vs, bias, H,
                                                              **kw))
            fwd_plain = time_ms(lambda: smajor_attention_core_plain(
                qs, ks, vs, bias, H, **kw))
            fwd_lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=bias.to(dtype)))
            # the entry's copies: q, k, v to S-major and the output back in
            # the forward; the output's cotangent in and dq, dk, dv back in
            # the backward -- four [B, S, H*hd] swaps each way
            fwd_copy = time_ms(lambda: [x.transpose(0, 1).contiguous()
                                        for x in (q, k, v, q)])
        bwd_entry = time_ms(lambda: torch.autograd.grad(
            o_k, (qs, ks, vs, br), dos, retain_graph=True))
        bwd_plain = time_ms(lambda: torch.autograd.grad(
            o_p, (qs, ks, vs, br), dos, retain_graph=True))
        bwd_lib = time_ms(lambda: torch.autograd.grad(
            o_s, (qh, kh, vh), do_s, retain_graph=True))
        e = q.element_size()
        fwd_bytes = 4 * B * S * H * hd * e + B * S * 4
        bwd_bytes = 7 * B * S * H * hd * e + 2 * B * S * 4
        fwd_ops, bwd_ops = 4 * B * H * S * S * hd, 10 * B * H * S * S * hd
        for name, ms, entry, plain, lib, nbytes, ops in (
                ("fwd", fwd_ms, fwd_entry, fwd_plain, fwd_lib, fwd_bytes, fwd_ops),
                ("bwd", bwd_ms, bwd_entry, bwd_plain, bwd_lib, bwd_bytes, bwd_ops)):
            bms, by = bound_ms(nbytes, ops, dtype)
            print(f"B5 {name} {dtype} rate {RATE}: kernel {ms:.4f} ms ({bms / ms:.1%} "
                  f"of its bound; bare launch on S-major operands; through the "
                  f"core entry and autograd {entry:.4f} ms), plain {plain:.4f} ms, "
                  f"sdpa (rate 0) {lib:.4f} "
                  f"ms, bound {bms:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
                  f"{ops / 1e9:.2f} GFLOP); {core_note(qs, nbytes, ops)}; "
                  f"entry layout copies {fwd_copy:.4f} ms")
            out[f"smajor_attention_train_{name}/{dtype}"] = dict(
                max_abs_err=(errs["out"] if name == "fwd"
                             else max(errs["dq"], errs["dk"], errs["dv"],
                                      errs["dbias"])),
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                bound_by=by, entry_ms=entry, copy_ms=fwd_copy)
    return out


BLOCK_GRADS = ("x", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "bias")


def block_args(B: int, S: int, dtype, gen, H: int = 12, hd: int = 64) -> list:
    """fused_attention_block's operands: x [B, S, H*hd] and four [out, in]
    weights in dtype, four fp32 biases, a key bias with padded keys."""
    D = H * hd
    args = [torch.randn(B, S, D, device="cuda", generator=gen).to(dtype)]
    for _ in range(4):
        args += [(torch.randn(D, D, device="cuda", generator=gen) / D ** 0.5
                  ).to(dtype),
                 torch.randn(D, device="cuda", generator=gen) * 0.1]
    lens = torch.randint(S // 2, S + 1, (B,), device="cuda", generator=gen)
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None]).float()
    return args + [((1.0 - mask) * -10000.0)[:, None, None, :]]


def block_grads(fn, args, dy, **kw) -> list:
    """y and the gradients of <y, dy> in the order of BLOCK_GRADS."""
    ins = [t.detach().requires_grad_() for t in args]
    y = fn(*ins, 12, **kw)
    return [y.detach(), *torch.autograd.grad(y, ins, dy)]


def block_errors(got, want, dtype, what: str) -> dict:
    """Raise unless B4 agrees with want. Tolerances: fp32 y 2e-5 of max|y|,
    each gradient 1e-4 of its scale (summation order only); bf16 y two bf16
    ulps of max|y|, each gradient 1e-2 of its scale (a rounded q, k, v, ctx
    or core gradient may flip by one ulp, 2^-8). A gradient's scale is its
    largest magnitude; the key bias's gradient is zero in exact arithmetic
    and takes the query bias's scale. Returns the largest absolute errors."""
    errs = {}
    scales = [w.float().abs().max().item() for w in want]
    scales[1 + BLOCK_GRADS.index("bk")] = scales[1 + BLOCK_GRADS.index("bq")]
    for i, name in enumerate(("y",) + BLOCK_GRADS):
        if name == "y":
            tol = (2e-5 * scales[0] if dtype == torch.float32
                   else 2 * bf16_ulp(scales[0]))
        else:
            tol = (1e-4 if dtype == torch.float32 else 1e-2) * scales[i]
        err = (got[i].float() - want[i].float()).abs().max().item()
        check(got[i].dtype == want[i].dtype, f"B4 {what} {name} dtype")
        check(err <= tol, f"B4 {what} {name} disagrees: {err} > {tol}")
        errs[name] = err
    return errs


def check_block_identity(B: int, S: int, gen) -> None:
    """bf16 B4 with Wq = Wk = Wv = Wo = I and zero biases is B1 on
    q = k = v = x bit for bit: every product is exact and dctx's lo term is
    zero. y is B1's output; the bias gradient is B1's per-head gradients
    summed in order h = 0..H-1 (its launcher's buffer: B1's entry sums with
    an unordered db_heads.sum(1)); dx is (dq + dk) + dv in bf16, in that
    order. Rates 0 and 0.1; any difference is a fault."""
    H, hd = 12, 64
    D = H * hd
    x, _, _, bias = attention_inputs(B, S, H, hd, torch.bfloat16, gen)
    g = torch.randn(x.shape, device="cuda", generator=gen).bfloat16()
    eye, zb = torch.eye(D, device="cuda").bfloat16(), torch.zeros(D, device="cuda")
    b2 = _bias2(bias, B, S)
    for rate in (0.0, RATE):
        t = keep_threshold(rate)
        ins = [a.detach().clone().requires_grad_() for a in [x] + [eye, zb] * 4 + [bias]]
        y = fused_attention_block(*ins, H, dropout_rate=rate, seed=21)
        grads = torch.autograd.grad(y, ins, g)
        out = torch.empty_like(x)
        stats, words = _train_buffers(x, B, H, S, t)
        _launch_train_fwd(_FLAT, x, x, x, b2, out, B, S, H, t, 21, stats, words)
        dq, dk, dv, dbh = _launch_train_bwd(_FLAT, x, x, x, b2, g, B, S, H, t, 21,
                                            stats, words)
        what = f"B4 identity gate [{B}, {S}, {D}] rate {rate}"
        check(torch.equal(y, out), f"{what}: y is not B1's output")
        check(torch.equal(grads[-1].view(B, S), sum_heads(dbh)),
              f"{what}: the bias gradient is not B1's")
        check(torch.equal(grads[0], (dq + dk) + dv), f"{what}: dx is not (dq + dk) + dv")
    print(f"B4 identity gate [{B}, {S}, {D}] bf16, rates 0 and {RATE}: y, the bias "
          f"gradient and dx equal B1's bit for bit")


def sum_heads(dbh: torch.Tensor) -> torch.Tensor:
    """[B, H, S] summed over heads in order h = 0..H-1, as B4 sums them."""
    db = dbh[:, 0]
    for h in range(1, dbh.shape[1]):
        db = db + dbh[:, h]
    return db


def core_gate_errors(dx, dbias, want, B: int, S: int, D: int) -> tuple:
    """(dx's error over its tolerance, the bias gradient's over its) of a
    bf16 B4 core against the plain core's fp32 (dq, dk, dv, per-head bias
    gradient) ``want`` on q = k = v = x, with B1's gates: the bias gradient
    within 1e-4 of its largest value; dx = (dq + dk) + dv in bf16 within
    two bf16 ulps of each term's largest value plus one ulp of the largest
    partial sum for the two bf16 roundings of the sums."""
    dq, dk, dv = (t.view(B, S, D) for t in want[:3])
    db = sum_heads(want[3])
    tol_x = (2 * sum(bf16_ulp(t.abs().max().item()) for t in (dq, dk, dv))
             + bf16_ulp(max((dq + dk).abs().max().item(), (dq + dk + dv).abs().max().item())))
    err_x = (dx.float() - (dq + dk + dv)).abs().max().item()
    err_b = (dbias.float().view(B, S) - db).abs().max().item()
    return err_x / tol_x, err_b / (1e-4 * db.abs().max().item())


def check_block_core(B: int, S: int, gen) -> None:
    """The core of bf16 B4 with dctx's lo term at work: Wq = Wk = Wv = I and
    zero biases make q = k = v = x exactly, and a random Wo gives
    dctx = g Wo a nonzero lo. B4's bias gradient and dx must hold B1's
    gates (core_gate_errors) against the plain core on x and the fp32 dctx,
    at rates 0 and 0.1. The control, B1's backward on hi = bf16(dctx) alone
    (what B4's kernel computes if it drops the lo products), must miss the
    bias-gradient gate."""
    H, hd = 12, 64
    D = H * hd
    x, _, _, bias = attention_inputs(B, S, H, hd, torch.bfloat16, gen)
    g = torch.randn(x.shape, device="cuda", generator=gen).bfloat16()
    wo = (torch.randn(D, D, device="cuda", generator=gen) / D ** 0.5).bfloat16()
    eye, zb = torch.eye(D, device="cuda").bfloat16(), torch.zeros(D, device="cuda")
    b2 = _bias2(bias, B, S)
    dctx = (g.float().view(B * S, D) @ wo.float()).view(B, S, D)
    for rate in (0.0, RATE):
        t = keep_threshold(rate)
        ins = [a.detach().clone().requires_grad_()
               for a in [x, eye, zb, eye, zb, eye, zb, wo, zb, bias]]
        y = fused_attention_block(*ins, H, dropout_rate=rate, seed=23)
        grads = torch.autograd.grad(y, ins, g)
        want = _core_backward_plain(x, x, x, b2.float(), dctx, H, t, 23)
        rx, rb = core_gate_errors(grads[0], grads[-1], want, B, S, D)
        out = torch.empty_like(x)
        stats, words = _train_buffers(x, B, H, S, t)
        _launch_train_fwd(_FLAT, x, x, x, b2, out, B, S, H, t, 23, stats, words)
        dq, dk, dv, dbh = _launch_train_bwd(_FLAT, x, x, x, b2, dctx.bfloat16(), B, S, H,
                                            t, 23, stats, words)
        cx, cb = core_gate_errors((dq + dk) + dv, sum_heads(dbh), want, B, S, D)
        what = f"B4 core gate [{B}, {S}, {D}] rate {rate}"
        print(f"{what}: error over tolerance, hi + lo (B4): dx {rx:.3g}, bias "
              f"gradient {rb:.3g}; hi alone (control): dx {cx:.3g}, bias gradient {cb:.3g}")
        check(rx <= 1 and rb <= 1, f"{what}: B4's core misses B1's gates")
        check(cb > 1, f"{what}: the hi-only control meets the bias-gradient gate")


def phase_block_kernel(gen) -> dict:
    """B4 against its plain version (y and every gradient) at S 13 and 140
    and at the fine-tune step's shapes ([128, 76, 768], bf16 and fp32, rates
    0 and 0.1); y against the flat route's composition (linear, B1, linear)
    on the same seed; bit-determinism; the identity gate in bf16
    (check_block_identity) and the core gate with its hi-only control
    (check_block_core) at the fine-tune step's shapes and at S 161; the
    realized keep mask against B1's and dropout_keep_mask, and its keep
    fraction. Times (median of 25 CUDA events, rate 0.1, bf16): B4 forward
    and backward beside their bound, the plain version, the flat route as
    the yardstick, and PyTorch's multi_head_attention_forward at rate 0 as
    the library call."""
    kw = dict(dropout_rate=RATE, seed=11)
    for S in (13, 140):
        for dtype in (torch.float32, torch.bfloat16):
            args = block_args(32, S, dtype, gen)
            dy = torch.randn(args[0].shape, device="cuda", generator=gen).to(dtype)
            e = block_errors(block_grads(fused_attention_block, args, dy, **kw),
                             block_grads(fused_attention_block_plain, args, dy,
                                         **kw), dtype, f"S={S} {dtype}")
            print(f"B4 S={S} {dtype} rate {RATE}: max abs err "
                  + ", ".join(f"{n} {x:.3g}" for n, x in e.items()))
    B, S, H, hd = MBS, 76, 12, 64
    N, D = B * S, H * hd
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = block_args(B, S, dtype, gen)
        dy = torch.randn(args[0].shape, device="cuda", generator=gen).to(dtype)
        err = {}
        for rate in (0.0, RATE):
            k2 = dict(dropout_rate=rate, seed=11)
            got = block_grads(fused_attention_block, args, dy, **k2)
            e = block_errors(got, block_grads(fused_attention_block_plain, args,
                                              dy, **k2), dtype,
                             f"B={B} S={S} {dtype} rate {rate}")
            print(f"B4 B={B} S={S} {dtype} rate {rate}: max abs err "
                  + ", ".join(f"{n} {x:.3g}" for n, x in e.items()))
            err = {n: max(err.get(n, 0.0), x) for n, x in e.items()}
            with torch.no_grad():
                fy = flat_route(*args, H, **k2)
            ftol = (2e-5 * fy.float().abs().max().item() if dtype == torch.float32
                    else 2 * bf16_ulp(fy.float().abs().max().item()))
            ferr = (got[0].float() - fy.float()).abs().max().item()
            print(f"B4 {dtype} rate {rate}: y against the flat route (linear, "
                  f"B1, linear) on one seed: max abs diff {ferr:.3g} (tol {ftol:.3g})")
            check(ferr <= ftol, f"B4 y differs from the flat route: {ferr}")
        a = block_grads(fused_attention_block, args, dy, **kw)
        b = block_grads(fused_attention_block, args, dy, **kw)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"B4 {dtype}: two runs with one seed differ")
        check(not torch.equal(a[0], block_grads(fused_attention_block, args, dy,
                                                dropout_rate=RATE, seed=12)[0]),
              f"B4 {dtype}: another seed, same output")
        print(f"B4 {dtype}: y and every gradient bit-equal over two runs; "
              f"another seed changes y")
        if dtype == torch.float32:
            continue
        check_block_identity(B, S, gen)
        check_block_identity(8, 161, gen)
        check_block_core(B, S, gen)
        check_block_core(8, 161, gen)

        ins = [x.detach().requires_grad_() for x in args]
        y_k = fused_attention_block(*ins, H, **kw)
        y_p = fused_attention_block_plain(*ins, H, **kw)
        y_f = flat_route(*ins, H, **kw)
        # the library call: the same block at rate 0, its biases in bf16 (it
        # takes one dtype), on seq-first views
        lw = (torch.cat(ins[1:7:2]), torch.cat(ins[2:7:2]).to(dtype))
        kpm = ins[9].detach()[:, 0, 0, :].to(dtype)

        def library():
            xs = ins[0].transpose(0, 1)
            return torch.nn.functional.multi_head_attention_forward(
                xs, xs, xs, D, H, lw[0], lw[1], None, None, False, 0.0,
                ins[7], ins[8].to(dtype), training=True, key_padding_mask=kpm,
                need_weights=False)[0]

        y_l = library()
        dy_l = dy.transpose(0, 1)
        with torch.no_grad():
            fwd = {name: time_ms(lambda f=f: f(*args, H, **kw))
                   for name, f in (("kernel", fused_attention_block),
                                   ("plain", fused_attention_block_plain),
                                   ("flat", flat_route))}
            fwd["library"] = time_ms(library)
        bwd = {name: time_ms(lambda y=y: torch.autograd.grad(
                   y, ins, dy, retain_graph=True, allow_unused=True))
               for name, y in (("kernel", y_k), ("plain", y_p), ("flat", y_f))}
        bwd["library"] = time_ms(lambda: torch.autograd.grad(
            y_l, ins[:9], dy_l, retain_graph=True, allow_unused=True))
        e = args[0].element_size()
        act, wts = N * D * e, D * D * e
        # forward: x, 4 weights, 4 biases and the key bias in; y and the
        # residuals q, k, v, ctx out. 8 N D^2 for the four projections, 4
        # B H S^2 hd for the core. Backward: x, q, k, v, ctx, g, the weights
        # and the key bias in; dx, dW, db and the key bias's gradient out;
        # 16 N D^2 (dctx, four dW, three dx) and 10 B H S^2 hd for the core
        fwd_bytes = 6 * act + 4 * wts + 4 * D * 4 + B * S * 4
        bwd_bytes = 7 * act + 8 * wts + 4 * D * 4 + 2 * B * S * 4
        core = B * H * S * S * hd
        fwd_ops, bwd_ops = 8 * N * D * D + 4 * core, 16 * N * D * D + 10 * core
        for name, t, nbytes, ops, key in (
                ("fwd", fwd, fwd_bytes, fwd_ops, "y"),
                ("bwd", bwd, bwd_bytes, bwd_ops, None)):
            bms, by = bound_ms(nbytes, ops, dtype)
            print(f"B4 {name} {dtype} rate {RATE}: kernel {t['kernel']:.4f} ms, "
                  f"plain {t['plain']:.4f} ms, flat route (cuBLAS linears + "
                  f"B1) {t['flat']:.4f} ms, multi_head_attention_forward "
                  f"(rate 0) {t['library']:.4f} ms, bound {bms:.4f} ms ({by}; "
                  f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP); "
                  f"{ops / t['kernel'] / 1e9:.1f} TFLOP/s; kernel / library "
                  f"{t['kernel'] / t['library']:.2f}")
            out[f"block_attention_train_{name}/{dtype}"] = dict(
                max_abs_err=(err["y"] if key else max(
                    v for n, v in err.items() if n != "y")),
                ms=t["kernel"], plain_ms=t["plain"], library_ms=t["library"],
                bound_ms=bms, bound_by=by, flat_route_ms=t["flat"])

    # the kernel's own keep bits, read back through its forward, are B1's
    # kernel's and the plain mask's
    t = keep_threshold(RATE)
    got = realized_block_keep_mask(11, B, H, S, hd, RATE, "cuda")
    check(torch.equal(got, dropout_keep_mask(11, B, H, S, t, "cuda")),
          "B4 keep mask differs from the plain mask")
    check(torch.equal(got, realized_keep_mask(11, B, H, S, hd, RATE, "cuda")),
          "B4 keep mask differs from B1's")
    frac = got.float().mean().item()
    print(f"B4 keep mask [{B},{H},{S},{S}] = B1's = dropout_keep_mask; keep "
          f"fraction {frac:.5f} (t/256 = {t / 256:.5f})")
    check(abs(frac - t / 256) <= 0.005, f"B4 keep fraction {frac}")
    return out


def neg_inf_inputs(B, S, H, hd, dtype, gen):
    """q/k/v [B, S, H*hd] and M3P's key bias: 0 on a prefix of S//2..S keys
    and -inf on the trailing ones (models/m3p.py's masked_fill)."""
    q, k, v = (torch.randn(B, S, H * hd, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    lens = torch.randint(S // 2, S + 1, (B,), device="cuda", generator=gen)
    lens[0] = S // 2
    invalid = torch.arange(S, device="cuda")[None, :] >= lens[:, None]
    bias = torch.zeros(B, 1, 1, S, device="cuda").masked_fill(
        invalid[:, None, None, :], float("-inf"))
    return q, k, v, bias


def hm(x: torch.Tensor, H: int = 12) -> torch.Tensor:
    """[B, S, H*hd] -> contiguous [B, H, S, hd]."""
    B, S, D = x.shape
    return x.view(B, S, H, D // H).transpose(1, 2).contiguous()


def train_hm(q, k, v, bias, H, **kw):
    """B3's head-major entry on [B, S, H*hd] operands split outside it, its
    output merged back: autograd reaches the kernels' own gradients."""
    out = fused_attention_train_hm(hm(q, H), hm(k, H), hm(v, H), bias, **kw)
    B, _, S, hd = out.shape
    return out.transpose(1, 2).reshape(B, S, H * hd)


def grad_errors(got, want, dtype, what: str) -> dict:
    """B1's tolerances (check_train_attention) on (out, dq, dk, dv, dbias)."""
    errs = {}
    for i, name in enumerate(("out", "dq", "dk", "dv", "dbias")):
        scale = want[i].float().abs().max().item()
        if name == "dbias":
            tol = 1e-4 * scale
        elif dtype == torch.float32:
            tol = 1e-5 if name == "out" else 2e-4 * scale
        else:
            tol = bf16_ulp(scale) * (1 if name == "out" else 2)
        err = (got[i].float() - want[i].float()).abs().max().item()
        check(got[i].dtype == want[i].dtype, f"{what} {name} dtype")
        check(bool(torch.isfinite(got[i]).all()), f"{what} {name} not finite")
        check(err <= tol, f"{what} {name} disagrees: {err} > {tol}")
        errs[name] = err
    return errs


def b3_bf16(q, k, v, bias, H, **kw):
    """B3's split entry on bf16 operands: the tensor-core kernels."""
    return fused_attention_train(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                 bias, H, **kw)


def check_b3_keep_mask(seed, B, H, S, hd) -> torch.Tensor:
    """B3's realized keep mask at RATE, read through its bf16 (tensor-core)
    and fp32 forwards, against B1's and dropout_keep_mask; returns it."""
    got = realized_keep_mask(seed, B, H, S, hd, RATE, "cuda", train=b3_bf16)
    check(torch.equal(got, dropout_keep_mask(seed, B, H, S, keep_threshold(RATE),
                                             "cuda")),
          f"B3 keep mask S={S} differs from the plain mask")
    check(torch.equal(got, realized_keep_mask(seed, B, H, S, hd, RATE, "cuda")),
          f"B3 keep mask S={S} differs from B1's")
    check(torch.equal(got, realized_keep_mask(seed, B, H, S, hd, RATE, "cuda",
                                              train=fused_attention_train)),
          f"B3 keep mask S={S}: bf16 and fp32 kernels differ")
    return got


def phase_blocked_kernel(gen) -> dict:
    """The M3P path's attention kernels under M3P's -inf key bias with
    trailing keys invalid: K1 and B1 against their plain versions at S 140;
    B2 (head-blocked eval) against its plain version at S 13 and 140 and at
    M3P eval's [1024, 140, 768], fp32 and bf16; B3 (head-blocked training,
    both entries) against its plain version (output and every gradient) and
    equal to B1 bit for bit (one device code a dtype: fp32 CUDA cores, bf16
    tensor cores), S 13 and 140 and M3P training's [128, 140, 768], rates
    0 and 0.1; B3's keep mask, its bit-determinism and keep fraction.
    Times (median of 25 CUDA events):
    B2 at [1024, 140, 768] bf16, B3 forward and backward at
    [128, 140, 768] bf16 rate 0.1 on head-major operands, each beside its
    bound, its plain version and SDPA (B3 at rate 0)."""
    H, hd = 12, 64
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias = neg_inf_inputs(16, 140, H, hd, dtype, gen)
        with torch.no_grad():
            got = fused_attention_flat(q, k, v, bias, H)
            ref = fused_attention_flat_plain(q, k, v, bias, H)
        err = (got.float() - ref.float()).abs().max().item()
        tol = 1e-5 if dtype == torch.float32 else bf16_ulp(ref.float().abs().max().item())
        check(bool(torch.isfinite(got).all()) and err <= tol,
              f"K1 -inf bias {dtype}: {err} > {tol}")
        do = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
        e = check_train_attention(q, k, v, bias, do, f"-inf bias S=140 {dtype}",
                                  dropout_rate=RATE, seed=5)
        print(f"-inf key bias, S=140 {dtype}: K1 max abs err {err:.3g}, B1 "
              f"out {e['out']:.3g}; finite")

    for S in (13, 140):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias = neg_inf_inputs(32, S, H, hd, dtype, gen)
            with torch.no_grad():
                got = fused_attention(q, k, v, bias, H)
            ref = fused_attention_flat_plain(q, k, v, bias, H)
            err = (got.float() - ref.float()).abs().max().item()
            tol = 1e-5 if dtype == torch.float32 else bf16_ulp(ref.float().abs().max().item())
            check(bool(torch.isfinite(got).all()) and err <= tol,
                  f"B2 S={S} {dtype} disagrees: {err} > {tol}")
            do = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
            for rate in (0.0, RATE):
                kw = dict(dropout_rate=rate, seed=9)
                flat = value_and_grads(fused_attention_train_flat, q, k, v,
                                       bias, do, H, **kw)
                for name, fn in (("split", fused_attention_train),
                                 ("hm", train_hm)):
                    b3 = value_and_grads(fn, q, k, v, bias, do, H, **kw)
                    grad_errors(b3, value_and_grads(
                        fused_attention_train_flat_plain, q, k, v, bias, do, H,
                        **kw), dtype, f"B3 {name} S={S} {dtype} rate {rate}")
                    # B1's device codes (fp32: CUDA cores; bf16: tensor cores)
                    check(all(torch.equal(a, b) for a, b in zip(b3, flat)),
                          f"B3 {name} S={S} {dtype} rate {rate} is not B1's "
                          f"bit for bit")
            if dtype == torch.bfloat16:
                check_b3_keep_mask(9, 4, H, S, hd)
            print(f"B2 S={S} {dtype}: max abs err {err:.3g} (tol {tol:.3g}); "
                  f"B3 (split and head-major entries) S={S} {dtype} rates 0 "
                  f"and {RATE}: within tolerance of its plain version, "
                  "equal to B1 bit for bit")
    try:
        fused_attention(q.detach().requires_grad_(), k, v, bias, H)
        check(False, "B2 accepted grad mode")
    except RuntimeError as e:
        check("no backward" in str(e), f"B2: {e}")

    B, S = EVAL_BS, 140
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias = neg_inf_inputs(B, S, H, hd, dtype, gen)
        with torch.no_grad():
            got = fused_attention(q, k, v, bias, H)
            ref = fused_attention_flat_plain(q, k, v, bias, H)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = 1e-5 if dtype == torch.float32 else bf16_ulp(scale)
        print(f"B2 B={B} S={S} {dtype} (-inf bias): max abs err {err:.3g} "
              f"(tol {tol:.3g})")
        check(bool(torch.isfinite(got).all()) and err <= tol,
              f"B2 {dtype} disagrees: {err} > {tol}")
        with torch.no_grad():
            check(torch.equal(got, fused_attention(q, k, v, bias, H)),
                  f"B2 {dtype}: two launches on the same inputs differ")
        if dtype == torch.float32:
            continue
        # one device code in two layouts: the same bits as K1
        with torch.no_grad():
            check(torch.equal(got, fused_attention_flat(q, k, v, bias, H)),
                  "B2 and K1 bf16 differ")
        qh, kh, vh = (hm(x, H) for x in (q, k, v))
        mask = bias.to(dtype)
        with torch.no_grad():
            ms = time_ms(lambda: _launch_eval("blocked_attention", qh, kh, vh,
                                              bias, B, S, H, hd))
            plain = time_ms(lambda: fused_attention_flat_plain(q, k, v, bias, H))
            lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask))
            split = time_ms(lambda: fused_attention(q, k, v, bias, H))
        nbytes = 4 * B * S * H * hd * q.element_size() + B * S * 4
        ops = 4 * B * H * S * S * hd
        bms, by = bound_ms(nbytes, ops, dtype)
        print(f"B2 {dtype}: kernel {ms:.4f} ms ({bms / ms:.1%} of its bound; "
              f"[B, H, S, hd] operands; the entry with its head split and "
              f"merge {split:.4f} ms), plain {plain:.4f} ms, sdpa {lib:.4f} "
              f"ms, bound {bms:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.2f} GFLOP); two launches bit-equal, and equal to K1's")
        out["blocked_attention"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
            bound_ms=bms, bound_by=by, entry_ms=split)

    B = MBS
    t = keep_threshold(RATE)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias = neg_inf_inputs(B, S, H, hd, dtype, gen)
        do = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
        err = {}
        for rate in (0.0, RATE):
            kw = dict(dropout_rate=rate, seed=21)
            b3 = value_and_grads(train_hm, q, k, v, bias, do, H, **kw)
            e = grad_errors(b3, value_and_grads(
                fused_attention_train_flat_plain, q, k, v, bias, do, H, **kw),
                dtype, f"B3 B={B} S={S} {dtype} rate {rate}")
            check(all(torch.equal(a, b) for a, b in zip(b3, value_and_grads(
                fused_attention_train_flat, q, k, v, bias, do, H, **kw))),
                f"B3 B={B} {dtype} rate {rate} is not B1's bit for bit")
            err = {n: max(err.get(n, 0.0), x) for n, x in e.items()}
            print(f"B3 B={B} S={S} {dtype} rate {rate} (-inf bias): max abs "
                  f"err " + ", ".join(f"{n} {x:.3g}" for n, x in e.items())
                  + "; equal to B1 bit for bit")
        kw = dict(dropout_rate=RATE, seed=21)
        a = value_and_grads(train_hm, q, k, v, bias, do, H, **kw)
        check(all(torch.equal(x, y) for x, y in zip(a, value_and_grads(
            train_hm, q, k, v, bias, do, H, **kw))),
            f"B3 {dtype}: two runs with one seed differ")
        check(not torch.equal(a[0], value_and_grads(
            train_hm, q, k, v, bias, do, H, dropout_rate=RATE, seed=22)[0]),
            f"B3 {dtype}: another seed, same output")
        if dtype == torch.float32:
            continue
        qh, kh, vh, dh = (hm(x, H).requires_grad_(x is not do)
                          for x in (q, k, v, do))
        br = bias.detach().requires_grad_()
        o_k = fused_attention_train_hm(qh, kh, vh, br, **kw)
        o_p = fused_attention_train_hm_plain(qh, kh, vh, br, **kw)
        o_s = torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=bias.to(dtype))
        fwd_ms, bwd_ms = bare_train_ms(_HM, qh, kh, vh, bias, dh, B, S, H, **kw)
        with torch.no_grad():
            fwd = [fwd_ms,
                   time_ms(lambda: fused_attention_train_hm(qh, kh, vh, bias, **kw)),
                   time_ms(lambda: fused_attention_train_hm_plain(qh, kh, vh,
                                                                  bias, **kw)),
                   time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                       qh, kh, vh, attn_mask=bias.to(dtype)))]
        bwd = [bwd_ms,
               time_ms(lambda: torch.autograd.grad(o_k, (qh, kh, vh, br), dh,
                                                   retain_graph=True)),
               time_ms(lambda: torch.autograd.grad(o_p, (qh, kh, vh, br), dh,
                                                   retain_graph=True)),
               time_ms(lambda: torch.autograd.grad(o_s, (qh, kh, vh), dh,
                                                   retain_graph=True))]
        e = q.element_size()
        for name, (ms, entry, plain, lib), nbytes, ops in (
                ("fwd", fwd, 4 * B * S * H * hd * e + B * S * 4,
                 4 * B * H * S * S * hd),
                ("bwd", bwd, 7 * B * S * H * hd * e + 2 * B * S * 4,
                 10 * B * H * S * S * hd)):
            bms, by = bound_ms(nbytes, ops, dtype)
            print(f"B3 {name} {dtype} rate {RATE}: kernel {ms:.4f} ms ({bms / ms:.1%} "
                  f"of its bound; bare launch on [B, H, S, hd] operands; "
                  f"through the entry and autograd {entry:.4f} ms), plain "
                  f"{plain:.4f} ms, sdpa (rate 0) {lib:.4f} ms, bound {bms:.4f} "
                  f"ms ({by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP)")
            out[f"blocked_attention_train_{name}"] = dict(
                max_abs_err=(err["out"] if name == "fwd" else max(
                    err["dq"], err["dk"], err["dv"], err["dbias"])),
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                bound_by=by, entry_ms=entry)

    got = check_b3_keep_mask(21, B, H, S, hd)
    # the mask of a sample is its own: the first 5 samples of a batch of 5
    # see the mask they see in the batch of 128
    check(torch.equal(got[:5], realized_keep_mask(
        21, 5, H, S, hd, RATE, "cuda", train=b3_bf16)),
        "B3 keep mask depends on the batch size")
    frac = got.float().mean().item()
    print(f"B3 keep mask [{B},{H},{S},{S}] (bf16 and fp32 kernels) = B1's = "
          f"dropout_keep_mask, the same in a batch of 5; keep fraction "
          f"{frac:.5f} (t/256 = {t / 256:.5f})")
    check(abs(frac - t / 256) <= 0.005, f"B3 keep fraction {frac}")
    return out


def bare_layout_ms(layout: str, q, k, v, bias, do, H, *, dropout_rate, seed):
    """bare_train_ms of the bf16 tensor-core kernels on [B, S, H*hd] values
    laid out flat (B1), S-major (B5) or head-major (B3), the copies made
    before timing: one device code at three strides."""
    B, S, _ = q.shape
    if layout == "flat":
        name, ops = _FLAT, (q, k, v, do)
    elif layout == "smajor":
        name, ops = _SM, [x.transpose(0, 1) for x in (q, k, v, do)]
    else:
        name, ops = _HM, [hm(x, H) for x in (q, k, v, do)]
    return bare_train_ms(name, *ops[:3], bias, ops[3], B, S, H,
                         dropout_rate=dropout_rate, seed=seed)


def phase_mma(gen) -> dict:
    """B1's and B5's bf16 forward and backward, which run B3's tensor-core
    kernels (csrc/attention_train_mma.cuh) on their strides: bf16 B1 (flat),
    B5 (S-major) and B3 (head-major, split outside) give the same bits,
    output and every gradient, on the same values at UC2's [128, 76, 768]
    under its -10000 keys and at M3P's [128, 140, 768] and [128, 160, 768]
    under -inf keys, rates 0 and 0.1, within grad_errors' tolerances of the
    plain version. Times (median of 25 CUDA events, rate 0.1, bare
    launches): the forward and the backward alone in the three layouts, in
    turns, at S 76 and 140 (what the strides cost), and B1's and B5's at
    S 140 and 160 beside the plain version, SDPA at rate 0 (its backward
    through autograd) and the bound."""
    H, hd, B = 12, 64, MBS
    out = {"strides": {}}
    for S, inputs in ((76, attention_inputs), (140, neg_inf_inputs),
                      (160, neg_inf_inputs)):
        q, k, v, bias = inputs(B, S, H, hd, torch.bfloat16, gen)
        do = torch.randn(q.shape, device="cuda", generator=gen).bfloat16()
        for rate in (0.0, RATE):
            kw = dict(dropout_rate=rate, seed=31)
            flat = value_and_grads(fused_attention_train_flat, q, k, v, bias, do,
                                   H, **kw)
            e = grad_errors(flat, value_and_grads(
                fused_attention_train_flat_plain, q, k, v, bias, do, H, **kw),
                torch.bfloat16, f"bf16 B1 S={S} rate {rate}")
            for name, fn in (("B5", fused_attention_train_smajor), ("B3", train_hm)):
                got = value_and_grads(fn, q, k, v, bias, do, H, **kw)
                check(all(torch.equal(a, b) for a, b in zip(got, flat)),
                      f"bf16 {name} S={S} rate {rate}: not B1's bit for bit")
            print(f"bf16 [{B}, {S}, {H * hd}] rate {rate}: B1 (flat), B5 (S-major) "
                  f"and B3 (head-major) equal bit for bit, output and every "
                  f"gradient; B1 against plain: " + ", ".join(
                      f"{n} {x:.3g}" for n, x in e.items()))
        kw = dict(dropout_rate=RATE, seed=31)
        if S in (76, 140):
            t = {}     # in turns, the least of two timings per layout
            for lay in ("flat", "smajor", "head_major", "head_major", "smajor", "flat"):
                ms = bare_layout_ms(lay, q, k, v, bias, do, H, **kw)
                t[lay] = [min(a, b) for a, b in zip(t.get(lay, ms), ms)]
            out["strides"][f"S{S}"] = {f"{lay}_{d}": t[lay][i] for lay in t
                                       for i, d in enumerate(("fwd", "bwd"))}
            for i, d in enumerate(("forward", "backward")):
                print(f"bf16 {d} alone at S={S} rate {RATE} by layout: "
                      + ", ".join(f"{lay} {ms[i]:.4f} ms" for lay, ms in t.items())
                      + " (rows of 128 bytes 1,536 / 196,608 / 128 bytes apart)")
        if S == 76:
            continue
        b1 = bare_layout_ms("flat", q, k, v, bias, do, H, **kw)
        b5 = bare_layout_ms("smajor", q, k, v, bias, do, H, **kw)
        qr, kr, vr, br = (x.detach().requires_grad_() for x in (q, k, v, bias))
        qh, kh, vh = (x.view(B, S, H, hd).transpose(1, 2) for x in (qr, kr, vr))
        do_s = do.view(B, S, H, hd).transpose(1, 2)
        o_p = fused_attention_train_flat_plain(qr, kr, vr, br, H, **kw)
        o_s = torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=bias.to(torch.bfloat16))
        with torch.no_grad():
            fwd_plain = time_ms(lambda: fused_attention_train_flat_plain(
                q, k, v, bias, H, **kw))
            fwd_lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=bias.to(torch.bfloat16)))
        bwd_plain = time_ms(lambda: torch.autograd.grad(
            o_p, (qr, kr, vr, br), do, retain_graph=True))
        bwd_lib = time_ms(lambda: torch.autograd.grad(
            o_s, (qr, kr, vr), do_s, retain_graph=True))
        del o_p, o_s
        e = q.element_size()
        for i, (name, plain, lib, nbytes, ops) in enumerate((
                ("fwd", fwd_plain, fwd_lib, 4 * B * S * H * hd * e + B * S * 4,
                 4 * B * H * S * S * hd),
                ("bwd", bwd_plain, bwd_lib, 7 * B * S * H * hd * e + 2 * B * S * 4,
                 10 * B * H * S * S * hd))):
            bms, by = bound_ms(nbytes, ops, torch.bfloat16)
            print(f"B1 {name} [{B}, {S}, {H * hd}] bf16 rate {RATE} (-inf keys): "
                  f"kernel {b1[i]:.4f} ms ({bms / b1[i]:.1%} of its bound), B5 "
                  f"{b5[i]:.4f} ms, plain {plain:.4f} ms, sdpa (rate 0) "
                  f"{lib:.4f} ms, bound {bms:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
                  f"{ops / 1e9:.2f} GFLOP); tensor cores")
            out[f"S{S}_{name}"] = dict(shape=[B, S, H * hd], ms=b1[i],
                                       smajor_ms=b5[i], plain_ms=plain,
                                       library_ms=lib, bound_ms=bms, bound_by=by)
        torch.cuda.empty_cache()
    return out


def phase_long_s(gen) -> dict:
    """S past the CUDA-core kernels' shared memory, where fp32 takes their
    key-blocked variant (one head's K, V and the backward's [S, S] tile do
    not fit a block) and bf16 the tensor-core kernels, which take every S:
    B1 at S 159 (fp32: its backward key-blocked) and 612 (fp32: both)
    against its plain version, fp32 and bf16, rates 0 and 0.1, under M3P's
    -inf keys; B5 and B3 (both entries) equal to B1 bit for bit there in
    both dtypes, with B1's keep mask; B4 against its plain version at S 159
    and 612 (fp32 key-blocked, bf16 the tensor-core core); K1 and B2 at S
    418 and 612 against the plain version (fp32 key-blocked, bf16 the
    tensor-core kernel); the keep mask at 612. Times
    (median of 25 CUDA events, bf16, rate 0.1): B1's bare launches at
    [128, 159, 768] and [32, 612, 768] beside their bounds and the plain
    version."""
    H, hd = 12, 64
    for S in (159, 612):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias = neg_inf_inputs(8, S, H, hd, dtype, gen)
            do = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
            for rate in (0.0, RATE):
                kw = dict(dropout_rate=rate, seed=13)
                b1 = value_and_grads(fused_attention_train_flat, q, k, v, bias,
                                     do, H, **kw)
                want = value_and_grads(fused_attention_train_flat_plain, q, k, v,
                                       bias, do, H, **kw)
                e = grad_errors(b1, want, dtype, f"B1 S={S} {dtype} rate {rate}")
                for name, fn in (("B5", fused_attention_train_smajor),
                                 ("B3", fused_attention_train), ("B3 hm", train_hm)):
                    got = value_and_grads(fn, q, k, v, bias, do, H, **kw)
                    check(all(torch.equal(a, b) for a, b in zip(got, b1)),
                          f"{name} S={S} {dtype} rate {rate} is not B1's bit for bit")
                print(f"B1 S={S} {dtype} rate {rate} (-inf bias; "
                      + ("forward key-blocked from S 418, backward key-blocked"
                         if dtype == torch.float32 else "tensor-core forward and "
                         "backward, not key-blocked")
                      + "): max abs err " + ", ".join(f"{n} {x:.3g}" for n, x in e.items())
                      + "; B5 and B3 (both entries) equal to it bit for bit")
            if dtype == torch.bfloat16:
                check_b3_keep_mask(13, 2, H, S, hd)
            args = block_args(2, S, dtype, gen)
            dy = torch.randn(args[0].shape, device="cuda", generator=gen).to(dtype)
            kw = dict(dropout_rate=RATE, seed=14)
            e = block_errors(block_grads(fused_attention_block, args, dy, **kw),
                             block_grads(fused_attention_block_plain, args, dy, **kw),
                             dtype, f"key-blocked S={S} {dtype}")
            core = "key-blocked" if dtype == torch.float32 else "tensor-core"
            print(f"B4 S={S} {dtype} rate {RATE} ({core} core): max abs err y "
                  f"{e['y']:.3g}, dx {e['x']:.3g}")
    for S in (418, 612):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias = neg_inf_inputs(8, S, H, hd, dtype, gen)
            with torch.no_grad():
                ref = fused_attention_flat_plain(q, k, v, bias, H).float()
                tol = 1e-5 if dtype == torch.float32 else bf16_ulp(ref.abs().max().item())
                # fp32 past its all-keys kernel; bf16 takes every S
                variant = "key-blocked" if dtype == torch.float32 else "tensor-core"
                for name, fn in (("K1", fused_attention_flat), ("B2", fused_attention)):
                    err = (fn(q, k, v, bias, H).float() - ref).abs().max().item()
                    check(err <= tol, f"{variant} {name} S={S} {dtype}: {err} > {tol}")
                    print(f"{variant} {name} S={S} {dtype} (-inf bias): max abs "
                          f"err {err:.3g} (tol {tol:.3g})")
    t = keep_threshold(RATE)
    check(torch.equal(realized_keep_mask(15, 4, H, 612, hd, RATE, "cuda"),
                      dropout_keep_mask(15, 4, H, 612, t, "cuda")),
          "key-blocked keep mask at S=612 differs from the plain mask")
    print("key-blocked keep mask [4, 12, 612, 612] = dropout_keep_mask")

    out = {}
    for B, S in ((MBS, 159), (32, 612)):
        q, k, v, bias = neg_inf_inputs(B, S, H, hd, torch.bfloat16, gen)
        do = torch.randn(q.shape, device="cuda", generator=gen).bfloat16()
        kw = dict(dropout_rate=RATE, seed=16)
        fwd_ms, bwd_ms = bare_train_ms(_FLAT, q, k, v, bias, do, B, S, H, **kw)
        qr, kr, vr, br = (x.detach().requires_grad_() for x in (q, k, v, bias))
        o_p = fused_attention_train_flat_plain(qr, kr, vr, br, H, **kw)
        with torch.no_grad():
            fwd_plain = time_ms(lambda: fused_attention_train_flat_plain(
                q, k, v, bias, H, **kw), n=5)
        bwd_plain = time_ms(lambda: torch.autograd.grad(
            o_p, (qr, kr, vr, br), do, retain_graph=True), n=5)
        del o_p
        e = q.element_size()
        for name, ms, plain, nbytes, ops in (
                ("fwd", fwd_ms, fwd_plain, 4 * B * S * H * hd * e + B * S * 4,
                 4 * B * H * S * S * hd),
                ("bwd", bwd_ms, bwd_plain, 7 * B * S * H * hd * e + 2 * B * S * 4,
                 10 * B * H * S * S * hd)):
            bms, by = bound_ms(nbytes, ops, torch.bfloat16)
            print(f"B1 {name} [{B}, {S}, {H * hd}] bf16 rate {RATE} (tensor-core): "
                  f"kernel {ms:.4f} ms ({bms / ms:.1%} of its bound), plain "
                  f"{plain:.4f} ms, bound {bms:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
                  f"{ops / 1e9:.2f} GFLOP)")
            out[f"S{S}_{name}"] = dict(shape=[B, S, H * hd], ms=ms, plain_ms=plain,
                                       bound_ms=bms, bound_by=by)
        torch.cuda.empty_cache()
    return out


COUNTERS = {
    "flat_attention": (fused_attention_flat, "launches"),
    "rows_gather": (rows_gather, "launches"),
    "flat_attention_train_fwd": (fused_attention_train_flat, "launches"),
    "flat_attention_train_bwd": (fused_attention_train_flat,
                                 "backward_launches"),
    "smajor_attention_train_fwd": (fused_attention_train_smajor, "launches"),
    "smajor_attention_train_bwd": (fused_attention_train_smajor,
                                   "backward_launches"),
    "block_attention_train_fwd": (fused_attention_block, "launches"),
    "block_attention_train_bwd": (fused_attention_block, "backward_launches"),
    "blocked_attention": (fused_attention, "launches"),
    "blocked_attention_train_fwd": (fused_attention_train, "launches"),
    "blocked_attention_train_bwd": (fused_attention_train, "backward_launches"),
    "roi_pool": (roi_pool_nhwc, "launches"),
}


def reset_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def only(**counts) -> dict:
    """The expected counts of a path: the given ones, every other 0."""
    return {name: counts.get(name, 0) for name in COUNTERS}


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
    check(eval_counts == only(flat_attention=12 * n_batches,
                              rows_gather=n_batches),
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
    check(pred_counts == only(rows_gather=N_REQUESTS // 8),
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


TRAIN_KERNELS = {"flat": "flat_attention_train", "proj": "block_attention_train",
                 True: "blocked_attention_train", "auto": "flat_attention_train"}


def phase_train(cfg, model, world, smi: str, fused="flat", seq: int = 40) -> dict:
    """The GQA fine-tune step of UC2 or M3P at full width (bench.py:54-92's
    envelope, ``seq`` text tokens), fed by TrainPipeline over the eval
    world's store and device bank, with the training attention of ``fused``:
    "flat" (B1), "proj" (B4, the whole block), True (B3 on split heads) or
    "auto" (B1 in bf16 on the card). Returns the timed steps' launch
    counts."""
    ds = train_dataset(world, (WARMUP_STEPS + TIMED_STEPS) * ACC * MBS,
                       max_seq_length=seq)
    pipe = TrainPipeline(ds, micro_batch_size=MBS, grad_acc_steps=ACC,
                         seed=0, device="cuda", with_features=False)
    D = torch.from_numpy(np.random.RandomState(0).rand(
        cfg.num_labels, cfg.num_labels).astype(np.float32)).cuda()
    params = dict(model.named_parameters())
    opt = make_optimizer(list(params), warmup_linear_schedule(4e-5, 2000, 20000))
    state = TrainState(model, opt.init(params), 0)
    step = make_train_step(opt, D, semantic_lambda=LAMBDA,
                           compute_dtype=torch.bfloat16, fused_attn=fused)
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
    kern = TRAIN_KERNELS[fused]
    print(f"train {type(model).__name__} ({fused}): {TIMED_STEPS} steps of "
          f"{ACC} x {MBS} (S = {world.regions + seq}) in "
          f"{dt:.3f} s -> {dt / TIMED_STEPS * 1e3:.2f} ms/step, "
          f"{TIMED_STEPS * ACC * MBS / dt:.1f} QA/s (bf16, fp32 master "
          f"weights, dropout {RATE}, lambda {LAMBDA}, fused_attn={fused!r}, "
          f"bank on) on {smi}; launches {counts}")
    check(counts == only(rows_gather=ACC * TIMED_STEPS,
                         **{f"{kern}_fwd": n_blocks * TIMED_STEPS,
                            f"{kern}_bwd": n_blocks * TIMED_STEPS}),
          f"train launches {counts}, expected per step {n_blocks} {kern} "
          f"forward, {n_blocks} backward, {ACC} rows_gather and nothing else")
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
            "qa_per_s": TIMED_STEPS * ACC * MBS / dt, "loss0": losses[0].item()}


def phase_train_ab(cfg: UC2Config, model: UC2, world, smi: str) -> dict:
    """The phase-6 train step with fused_attn "flat" (B1) and "sm" (B5) in
    turns (AB_ORDER), AB_STEPS timed steps a block after one warm-up step:
    ms per step of each block, the median of each route, the pairs each
    route wins and the spread of the flat blocks (quartile distance), on
    one card in one run."""
    ds = train_dataset(world, len(AB_ORDER) * (1 + AB_STEPS) * ACC * MBS,
                       seed=2)
    pipe = TrainPipeline(ds, micro_batch_size=MBS, grad_acc_steps=ACC,
                         seed=0, device="cuda", with_features=False)
    D = torch.from_numpy(uc2_distance_matrix(cfg)).cuda()
    params = dict(model.named_parameters())
    opt = make_optimizer(list(params), warmup_linear_schedule(4e-5, 2000, 20000))
    state = TrainState(model, opt.init(params), 0)
    bank = world.bank.tensors()
    batches = pipe.epoch(0)
    ms = {"flat": [], "sm": []}
    for fused in AB_ORDER:
        step = make_train_step(opt, D, semantic_lambda=LAMBDA,
                               compute_dtype=torch.bfloat16, fused_attn=fused)
        state, _ = step(state, next(batches), seed=state.step, bank=bank)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(AB_STEPS):
            state, m = step(state, next(batches), seed=state.step, bank=bank)
        torch.cuda.synchronize()
        ms[fused].append((time.perf_counter() - t0) / AB_STEPS * 1e3)
    batches.close()
    out = {k: statistics.median(v) for k, v in ms.items()}
    sm_wins = sum(s < f for f, s in zip(ms["flat"], ms["sm"]))
    q1, _, q3 = statistics.quantiles(ms["flat"], n=4)
    print(f"train step A/B ({len(AB_ORDER) // 2} pairs, {', '.join(AB_ORDER)}; "
          f"{AB_STEPS} steps a block): flat {[round(x, 2) for x in ms['flat']]}"
          f" ms, sm {[round(x, 2) for x in ms['sm']]} ms per step; medians "
          f"flat {out['flat']:.2f} ms, sm {out['sm']:.2f} ms "
          f"({(out['sm'] / out['flat'] - 1) * 100:+.2f}% for sm); sm faster in "
          f"{sm_wins} of {len(ms['sm'])} pairs; flat quartile spread "
          f"{q3 - q1:.2f} ms; on {smi}")
    return out


def write_cli_task(root: str, world) -> str:
    """The CLI's inputs over ``world``'s CFS store, under ``root``: its
    questions as train (CLI_STEPS steps) and val (CLI_VAL) annotation
    pickles, the answer vocabulary, and a TASK15 YAML. Returns the YAML's
    path."""
    data = os.path.join(root, "annotations")
    os.makedirs(data)
    with open(os.path.join(data, "trainval_ans2label.pkl"), "wb") as f:
        pickle.dump({a: i for i, a in enumerate(world.label2ans)}, f)
    with open(os.path.join(data, "trainval_label2ans.pkl"), "wb") as f:
        pickle.dump(world.label2ans, f)
    n_train = CLI_STEPS * ACC * MBS
    for split, es in (("train", world.entries[:n_train]),
                      ("val", world.entries[n_train:n_train + CLI_VAL])):
        with open(os.path.join(data, f"{split}_target.pkl"), "wb") as f:
            pickle.dump([{"question_id": e.question_id, "image_id": e.image_id,
                          "question": e.question, "labels": e.labels,
                          "scores": e.scores} for e in es], f)
    store = world.reader.path
    task = os.path.join(root, "task.yml")
    with open(task, "w") as f:
        f.write(f"TASK15:\n  name: GQA\n  type: VL-classifier-GQA\n"
                f"  num_labels: {len(world.label2ans)}\n"
                f"  loss: CrossEntropyLoss\n  dataroot: {data}\n"
                f"  features_h5path1: {store}\n  features_h5path2: {store}\n"
                f"  max_seq_length: 40\n  max_region_num: {world.regions}\n"
                f"  batch_size: {ACC * MBS}\n  eval_batch_size: {EVAL_BS}\n"
                f"  train_split: train\n  val_split: val\n  lr: 4.0e-5\n"
                f"  num_epoch: 1\n  semantic_lambda: {LAMBDA}\n"
                f"  semantic_dict_path: ''\n")
    return task


def phase_cli(tmp: str, world, smi: str) -> dict:
    """``python -m clg_vqa_tpu_torch.cli train --fused_attn proj`` at UC2's
    full width (configs/uc2_base.json, random weights), run in this process
    so the launch counters see it: CLI_STEPS steps of acc 2 x mbs 128
    (bf16, dropout 0.1, device bank) over the eval world's CFS store, with
    its questions written as train/val annotation pickles, then one val
    pass over CLI_VAL questions and the saves. Returns its launch counts."""
    root = os.path.join(tmp, "cli")
    task = write_cli_task(root, world)
    out = os.path.join(root, "run")
    argv = ["train", "--config_file",
            os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                         "uc2_base.json"),
            "--tasks_config_file", task, "--output_dir", out,
            "--grad_acc_steps", str(ACC), "--fused_attn", "proj"]
    print("cli: python -m clg_vqa_tpu_torch.cli " + " ".join(argv))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    cli_main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    for sig, handler in ((signal.SIGTERM, signal.SIG_DFL),
                         (signal.SIGINT, signal.default_int_handler)):
        signal.signal(sig, handler)
    n_blocks = 12 * ACC
    print(f"cli train --fused_attn proj: {CLI_STEPS} steps of {ACC} x {MBS} "
          f"at full width + val over {CLI_VAL} questions + saves in {dt:.2f} s "
          f"on {smi}; launches {counts}")
    check(counts["block_attention_train_fwd"] == n_blocks * CLI_STEPS
          and counts["block_attention_train_bwd"] == n_blocks * CLI_STEPS
          and counts["flat_attention_train_fwd"] == 0
          and counts["flat_attention_train_bwd"] == 0
          and counts["smajor_attention_train_fwd"] == 0
          and counts["flat_attention"] > 0 and counts["rows_gather"] > 0,
          f"cli launches {counts}, expected {n_blocks} B4 forward and backward "
          f"per step, no B1 or B5, some K1 and K2")
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    recs = [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]
    losses = [r["loss"] for r in recs if r["kind"] == "train"]
    check(meta["step"] == CLI_STEPS and os.path.exists(
        os.path.join(out, "params_best", "params.pt")) and os.path.exists(
        os.path.join(out, meta["state_dir"], "state.pt")), f"cli meta {meta}")
    check(len(losses) == CLI_STEPS and all(map(math.isfinite, losses)),
          f"cli train records {losses}")
    print(f"cli: train losses {[round(x, 4) for x in losses]}; params_best and "
          f"{meta['state_dir']} saved")
    return counts


def phase_prune_sft(tmp: str, world, smi: str) -> dict:
    """The paper's sparse fine-tuning through the CLI at UC2's full width
    (configs/uc2_base.json, random weights from seed 0), in this process so
    the launch counters see it: ``prune`` for 2 IMP rounds of CLI_STEPS
    steps of acc 2 x mbs 128 (bf16, dropout 0.1, device bank, --fused_attn
    auto: B1), each followed by the 10% prune, the rewind to theta_0 and a
    val pass over CLI_VAL questions on theta_0 * mask (K1); then ``sft
    --mask_file <prune out>/mask_best.npz`` for 1 epoch of CLI_STEPS steps.
    Checks the masks' zero counts exactly against the model's prunable
    count N, the mask files' JAX layout, mask_best against the rounds'
    rewound scores, the launches, finite losses and that every weight
    mask_best prunes is exactly 0 in model_best_sft.bin and in the final
    state while the surviving ones moved from theta_0; then times
    imp_prune_step alone on the card. Returns each command's launch
    counts."""
    root = os.path.join(tmp, "cli_prune")
    task = write_cli_task(root, world)
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                          "uc2_base.json")
    cfg = UC2Config.from_json(config, num_labels=len(world.label2ans))
    theta0 = cli_build_model(SimpleNamespace(device="cuda", seed=0,
                                             from_pretrained=""), cfg)
    names = pr.prunable_paths(theta0)
    n = sum(p.numel() for k, p in theta0.named_parameters() if k in names)
    prune_out, sft_out = (os.path.join(root, d) for d in ("prune", "sft"))
    best_file = os.path.join(prune_out, "mask_best.npz")
    common = ["--config_file", config, "--tasks_config_file", task,
              "--grad_acc_steps", str(ACC), "--fused_attn", "auto"]
    counts, secs = {}, {}
    n_blocks = 12 * ACC
    for mode, extra, epochs in (
            ("prune", ["--output_dir", prune_out, "--num_epoch", "2"], 2),
            ("sft", ["--output_dir", sft_out, "--num_epoch", "1",
                     "--mask_file", best_file], 1)):
        argv = [mode, *common, *extra]
        print("cli: python -m clg_vqa_tpu_torch.cli " + " ".join(argv))
        torch.cuda.synchronize()
        reset_counts()
        t_wall, t0 = time.time(), time.perf_counter()
        cli_main(argv)
        torch.cuda.synchronize()
        secs[mode] = time.perf_counter() - t0
        counts[mode] = read_counts()
        for sig, handler in ((signal.SIGTERM, signal.SIG_DFL),
                             (signal.SIGINT, signal.default_int_handler)):
            signal.signal(sig, handler)
        print(f"cli {mode}: {epochs} x {CLI_STEPS} steps of {ACC} x {MBS} at "
              f"full width + {epochs} val passes over {CLI_VAL} questions + "
              f"saves in {secs[mode]:.2f} s on {smi}; launches {counts[mode]}")
        c = counts[mode]
        check(c["flat_attention_train_fwd"] == n_blocks * CLI_STEPS * epochs
              and c["flat_attention_train_bwd"] == n_blocks * CLI_STEPS * epochs
              and c["block_attention_train_fwd"] == 0
              and c["block_attention_train_bwd"] == 0
              and c["smajor_attention_train_fwd"] == 0
              and c["smajor_attention_train_bwd"] == 0
              and c["flat_attention"] > 0 and c["rows_gather"] > 0,
              f"cli {mode} launches {c}, expected {n_blocks} B1 forward and "
              f"backward per step, no B4 or B5, some K1 and K2")
        out = prune_out if mode == "prune" else sft_out
        recs = [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]
        losses = [r["loss"] for r in recs if r["kind"] == "train"]
        check(len(losses) == CLI_STEPS * epochs
              and all(map(math.isfinite, losses)),
              f"cli {mode} train records {losses}")
        print(f"cli {mode}: train losses {[round(x, 4) for x in losses]}")
        if mode == "prune":
            lt = [os.path.join(prune_out, f"mask_lt{r}.npz") for r in range(2)]
            t_lt = [os.path.getmtime(f) for f in lt]
            print(f"cli prune: round 0 wrote its mask {t_lt[0] - t_wall:.2f} s "
                  f"after the command started (set-up included), round 1 "
                  f"{t_lt[1] - t_lt[0]:.2f} s after round 0 (train, prune, "
                  f"rewind, val, mask files) on {smi}")

    # the masks: exact zero counts from the model's N, JAX's layout, and
    # mask_best the round with the higher rewound score
    with open(os.path.join(prune_out, "prune_meta.json")) as f:
        pmeta = json.load(f)
    scores = [h["score"] for h in pmeta["history"]]
    best_round = scores.index(max(scores))
    first = int(round(0.1 * n))
    want_zeros = [first, first + int(round(0.1 * (n - first)))]
    shapes = {pr._jax_path(k)[0]: (tuple(p.shape[::-1]) if k == "pooler.weight"
                                   else (cfg.num_layers, *p.shape[::-1]))
              for k, p in theta0.named_parameters() if k in names}
    files = {}
    for r in range(2):
        with np.load(os.path.join(prune_out, f"mask_lt{r}.npz")) as z:
            files[r] = {k: z[k] for k in z.files}
        zeros = sum(int((a == 0).sum()) for a in files[r].values())
        print(f"mask_lt{r}: {zeros} of N = {n} prunable weights zero "
              f"({100 * zeros / n:.4f}%), want {want_zeros[r]}; rewound val "
              f"score {scores[r]:.4f}")
        check(zeros == want_zeros[r], f"mask_lt{r} zeros {zeros}, expected "
              f"{want_zeros[r]}")
        check({k: (a.shape, a.dtype) for k, a in files[r].items()}
              == {k: (s, np.float32) for k, s in shapes.items()}
              and set(files[r]) == set(pr.PRUNABLE_UC2),
              f"mask_lt{r} keys/shapes {[(k, a.shape) for k, a in files[r].items()]}")
    with np.load(best_file) as z:
        check(set(z.files) == set(files[best_round]) and all(
            np.array_equal(z[k], files[best_round][k]) for k in z.files),
            f"mask_best is not mask_lt{best_round}, the best rewound score")
    print(f"mask_best = mask_lt{best_round} (rewound scores {scores})")

    # SFT: every pruned weight exactly 0 in the export and the final state,
    # the surviving ones moved from theta_0
    mask = pr.load_mask(best_file, theta0)
    exported = load_pretrained(os.path.join(sft_out, "model_best_sft.bin"), cfg)
    with open(os.path.join(sft_out, "meta.json")) as f:
        meta = json.load(f)
    final = torch.load(os.path.join(sft_out, meta["state_dir"], "state.pt"),
                       map_location="cuda", weights_only=True)["params"]
    n_pruned = moved = 0
    for k in names:
        m, w0 = mask[k], theta0.state_dict()[k]
        bad_bin = int((torch.from_numpy(exported[k]).cuda()[m == 0] != 0).sum())
        bad_final = int((final[k][m == 0] != 0).sum())
        check(bad_bin == 0 and bad_final == 0, f"{k}: {bad_bin} pruned weights "
              f"nonzero in model_best_sft.bin, {bad_final} in the final state")
        # one epoch, one val pass: the best export is the final state, so
        # the async export kept the weights of its submit
        check(torch.equal(torch.from_numpy(exported[k]).cuda(), final[k]),
              f"{k}: model_best_sft.bin differs from the final state")
        n_pruned += int((m == 0).sum())
        moved += int((final[k][m == 1] != w0[m == 1]).sum())
    check(meta["step"] == CLI_STEPS and n_pruned == want_zeros[best_round]
          and moved > 0, f"sft meta {meta}, {n_pruned} pruned, {moved} moved")
    print(f"sft: all {n_pruned} pruned weights exactly 0 in "
          f"model_best_sft.bin and in the final state; {moved} of "
          f"{n - n_pruned} surviving weights moved from theta_0")
    del final, exported, mask

    # imp_prune_step alone on the card, over theta_0's 85.5 M magnitudes
    ms, peaks = [], []
    base = torch.cuda.memory_allocated()
    for _ in range(3):
        m0 = pr.init_mask(theta0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m1 = pr.imp_prune_step(theta0, m0, 0.1)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated() - base)
        check(sum(int((v == 0).sum()) for v in m1.values() if v is not None)
              == first, "imp_prune_step zero count")
    del m0
    # a mask file's write and read on the host, as a round pays them
    path = os.path.join(root, "timed_mask.npz")
    t0 = time.perf_counter()
    pr.save_mask(path, m1)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = pr.load_mask(path, theta0)
    t_load = time.perf_counter() - t0
    check(all(torch.equal(back[k], m1[k]) for k in names), "mask file round trip")
    print(f"imp_prune_step on the card (N = {n}, fraction 0.1): "
          f"{[round(x, 2) for x in ms]} ms, peak {max(peaks) / 1e6:.0f} MB "
          f"above the model; save_mask {t_save:.2f} s "
          f"({os.path.getsize(path) / 1e6:.1f} MB), load_mask {t_load:.2f} s; "
          f"on {smi}")
    del m1, back
    del theta0
    torch.cuda.empty_cache()
    return {"launches": counts, "seconds": secs, "prune_step_ms": ms}


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
    for fused in (False, "flat", "proj"):
        loss_fn = make_loss_fn(D, semantic_lambda=LAMBDA, compute_dtype=None,
                               fused_attn=fused)
        loss, _ = loss_fn(model, {k: v[0] for k, v in batch.items()}, seed=0)
        gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads[fused] = (loss.item(), [g for g in gs if g is not None])
    lp, gp = grads[False]
    gmax = max(g.abs().max().item() for g in gp)
    for fused in ("flat", "proj"):
        lk, gk = grads[fused]
        gerr = max((a - b).abs().max().item() for a, b in zip(gk, gp))
        print(f"train parity, full width fp32 mbs 32, {fused!r} route vs plain: "
              f"loss {lk:.6f} vs {lp:.6f}; grads max abs diff {gerr:.3g} of max "
              f"|grad| {gmax:.3g} (tol 1e-4 of it)")
        check(abs(lk - lp) <= 1e-4 * abs(lp) and gerr <= 1e-4 * gmax,
              f"full-width {fused} route vs plain route gradients differ")
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


def m3p_eval_step_counts(model, w, smi: str, fused, label: str) -> dict:
    """run_eval of the M3P world with ``fused`` (None = the auto rule):
    one warm-up run, then the counted and timed run. Returns its counts."""
    step = (None if fused is None else
            make_predict_step(model, device_bank=w.bank, fused_attn=fused))
    kw = dict(batch_size=EVAL_BS, device_bank=w.bank, step=step)
    run_eval(model, w.dataset, w.label2ans, **kw)                     # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = run_eval(model, w.dataset, w.label2ans, **kw)
    dt = time.perf_counter() - t0
    counts = read_counts()
    n_batches = math.ceil(N_QA / EVAL_BS)
    kern = "flat_attention" if fused is None else "blocked_attention"
    print(f"run_eval M3P ({label}): {res['n']} QA in {dt:.3f} s -> "
          f"{res['n'] / dt:.1f} QA/s (bs {EVAL_BS}, bf16, bank on, "
          f"{n_batches} batches) on {smi}; launches {counts}")
    check(res["n"] == N_QA, f"M3P run_eval scored {res['n']} of {N_QA}")
    check(counts == only(rows_gather=n_batches,
                         **{kern: 12 * n_batches}),
          f"M3P run_eval ({label}) launches {counts}, expected 12 x "
          f"{n_batches} {kern} and {n_batches} rows_gather")
    return counts, res["n"] / dt


def phase_m3p_eval(cfg, model, w, smi: str) -> dict:
    """M3P's eval path at full width: run_eval over the M3P world (bs 1024,
    bf16, bank on) with the auto rule (K1) and with fused_attn=True (B2),
    Predictor requests, then the fp32 logits of K1 and B2 against the plain
    route on one batch that holds images with fewer than 100 boxes."""
    eval_counts, qa = m3p_eval_step_counts(model, w, smi, None, "auto: K1")
    blocked_counts, qa_b = m3p_eval_step_counts(model, w, smi, True,
                                                "fused_attn=True: B2")
    pred = Predictor(model, w.reader, w.tokenizer, w.label2ans,
                     batch_capacity=8, max_region_num=w.regions)
    reqs = [(e.question, e.image_id) for e in w.entries[:N_REQUESTS]]
    pred.predict_batch(reqs[:8])                                        # warm-up
    lat, answers = [], []
    reset_counts()
    for i in range(0, N_REQUESTS, 8):
        t1 = time.perf_counter()
        answers += pred.predict_batch(reqs[i:i + 8])
        lat.append((time.perf_counter() - t1) * 1e3)
    pred_counts = read_counts()
    check(pred_counts == only(rows_gather=N_REQUESTS // 8),
          f"M3P Predictor launches {pred_counts}")
    check(len(answers) == N_REQUESTS and all(
        a["answer"] in w.label2ans and 0.0 <= a["confidence"] <= 1.0
        for a in answers), "M3P Predictor returned a malformed answer")
    print(f"Predictor M3P: {N_REQUESTS} requests in chunks of 8, bf16: "
          f"per-chunk latency median {statistics.median(lat):.2f} ms, max "
          f"{max(lat):.2f} ms; launches {pred_counts}")

    batch = w.dataset.make_batch(list(range(EVAL_BS)), with_features=False)
    t = {k: torch.from_numpy(batch[k]).cuda()
         for k in ("input_ids", "input_mask", "store_idx")}
    f, l, m = DeviceFeatureBank.gather_from(w.bank.tensors(), t.pop("store_idx"))
    t.update(features=f, locs=l, image_mask=m)
    n_boxes = m.sum(1)
    check(bool((n_boxes < w.regions).any()), "no image with fewer boxes")
    with torch.inference_mode():
        plain = model(t, compute_dtype=None, fused_attn=False)
        for fused, name in (("flat", "K1"), (True, "B2")):
            got = model(t, compute_dtype=None, fused_attn=fused)
            err = (got - plain).abs().max().item()
            print(f"M3P fp32 logits, {name} vs plain route (full width, "
                  f"B={EVAL_BS}, {int((n_boxes < w.regions).sum())} images "
                  f"with 10-99 boxes): max abs diff {err:.3g} (tol 1e-4), max "
                  f"|logit| {plain.abs().max().item():.3g}")
            check(bool(torch.isfinite(got).all()) and got.shape == (
                EVAL_BS, cfg.num_labels), f"M3P {name}: bad fp32 logits")
            check(err <= 1e-4, f"M3P {name} vs plain fp32 logits differ by {err}")
        a = model(t, compute_dtype=torch.bfloat16, fused_attn=True).argmax(-1)
        b = model(t, compute_dtype=torch.bfloat16, fused_attn="flat").argmax(-1)
        print(f"M3P bf16 argmax agreement B2 vs K1: "
              f"{(a == b).float().mean().item() * 100:.2f}%")
    return {"m3p_eval": eval_counts, "m3p_eval_blocked": blocked_counts,
            "m3p_predictor": pred_counts, "qa_per_s": qa, "qa_per_s_b2": qa_b}


def phase_m3p_cli(tmp: str, w, smi: str) -> dict:
    """``python -m clg_vqa_tpu_torch.cli train --is_m3p`` at M3P's full
    width (configs/m3p_base.json, random weights) in this process, over the
    M3P world's CFS store: CLI_STEPS steps of acc 2 x mbs 128 (bf16, dropout
    0.1, device bank; --fused_attn auto, the flat kernels), one val pass over
    CLI_VAL questions, the saves; then the trained params exported as a
    VOLTA .bin and reloaded the way --from_pretrained reads it, with equal
    fp32 logits. Returns the CLI run's launch counts."""
    root = os.path.join(tmp, "m3p_cli")
    task = write_cli_task(root, w)
    out = os.path.join(root, "run")
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                          "m3p_base.json")
    argv = ["train", "--config_file", config, "--tasks_config_file", task,
            "--output_dir", out, "--grad_acc_steps", str(ACC), "--is_m3p"]
    print("cli: python -m clg_vqa_tpu_torch.cli " + " ".join(argv))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    cli_main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    for sig, handler in ((signal.SIGTERM, signal.SIG_DFL),
                         (signal.SIGINT, signal.default_int_handler)):
        signal.signal(sig, handler)
    n_blocks = 12 * ACC
    print(f"cli train --is_m3p: {CLI_STEPS} steps of {ACC} x {MBS} at full "
          f"width + val over {CLI_VAL} questions + saves in {dt:.2f} s on "
          f"{smi}; launches {counts}")
    check(counts["flat_attention_train_fwd"] == n_blocks * CLI_STEPS
          and counts["flat_attention_train_bwd"] == n_blocks * CLI_STEPS
          and counts["blocked_attention_train_fwd"] == 0
          and counts["block_attention_train_fwd"] == 0
          and counts["flat_attention"] > 0 and counts["rows_gather"] > 0,
          f"M3P cli launches {counts}, expected {n_blocks} B1 forward and "
          f"backward per step, some K1 and K2")
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    recs = [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]
    losses = [r["loss"] for r in recs if r["kind"] == "train"]
    check(meta["step"] == CLI_STEPS and os.path.exists(os.path.join(
        out, meta["state_dir"], "state.pt")), f"M3P cli meta {meta}")
    check(len(losses) == CLI_STEPS and all(map(math.isfinite, losses)),
          f"M3P cli train records {losses}")

    cfg = M3PConfig.from_json(config, num_labels=len(w.label2ans))
    trained = cli_build_model(SimpleNamespace(
        device="cuda", seed=0, from_pretrained=os.path.join(out, "params_best")),
        cfg)
    bin_path = os.path.join(out, "model.bin")
    export_torch_bin(bin_path, trained, "m3p")
    fresh = load_numpy_state(M3P(cfg, device="cuda", seed=1),
                             load_pretrained(bin_path, cfg))
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             w.dataset.make_batch(list(range(256))).items()
             if k in ("input_ids", "input_mask", "features", "locs",
                      "image_mask")}
    with torch.no_grad():
        a = trained(batch, compute_dtype=None, fused_attn="flat")
        b = fresh(batch, compute_dtype=None, fused_attn="flat")
    check(bool(torch.isfinite(a).all()) and torch.equal(a, b),
          "the M3P .bin reloads to other fp32 logits")
    print(f"cli: M3P train losses {[round(x, 4) for x in losses]}; "
          f"params_best and {meta['state_dir']} saved; the .bin export "
          f"reloads to equal fp32 logits [256, {cfg.num_labels}]")
    return counts


M3P_TINY = dict(vocab_size=300, hidden_size=128, num_layers=2, num_heads=2,
                intermediate_size=512, v_feature_size=64, num_locs=5,
                max_boxes=9, pooler_size=128, clf_hidden_size=64,
                num_labels=40, dropout=0.0, attention_dropout=0.0,
                clf_dropout_prob=0.0)


def _m3p_batch(r: np.random.RandomState, lead: tuple, T: int, R: int,
               feat: int, vocab: int, num_labels: int) -> dict:
    """Random M3P batch whose images have 2..R boxes."""
    ids = r.randint(3, vocab, (*lead, T)).astype(np.int32)
    ids[..., 1, T - 3:] = 1
    n = r.randint(2, R + 1, lead)
    imask = (np.arange(R) < n[..., None]).astype(np.int32)
    return {"input_ids": ids, "input_mask": (ids != 1).astype(np.int32),
            "features": r.randn(*lead, R, feat).astype(np.float32),
            "locs": r.rand(*lead, R, 5).astype(np.float32),
            "image_mask": imask,
            "labels": r.randint(0, num_labels, lead).astype(np.int32)}


def phase_m3p_parity() -> None:
    """fp32, dropout 0: (a) a tiny M3P (hd 64, images of 2-9 boxes) on the
    card against the same weights on the CPU: eval logits through K1 and B2
    against the CPU's plain route, and 3 train steps through "hm" (the True
    route, B3) against the CPU's plain route; (b) at full width (mbs 32,
    images of 2-100 boxes) the gradients of the True route (B3) against the
    plain route's. Tolerance 1e-4: of the largest logit or gradient, relative for
    losses and gradient norms, absolute for parameters (lr 1e-5)."""
    tiny = M3PConfig(**M3P_TINY)
    r = np.random.RandomState(7)
    gpu = M3P(tiny, device="cuda", seed=2)
    cpu = load_numpy_state(M3P(tiny, device="cpu"),
                           {k: v.cpu().numpy() for k, v in gpu.state_dict().items()})
    b = _m3p_batch(r, (6,), 11, 9, 64, 300, 40)
    del b["labels"]
    with torch.inference_mode():
        want = cpu({k: torch.from_numpy(v) for k, v in b.items()})
        for fused in ("flat", True):
            got = gpu({k: torch.from_numpy(v).cuda() for k, v in b.items()},
                      fused_attn=fused).cpu()
            err = (got - want).abs().max().item()
            print(f"tiny M3P fp32 eval, card {fused!r} route vs CPU plain: "
                  f"max abs diff {err:.3g} (tol 1e-4)")
            check(err <= 1e-4, f"tiny M3P card vs CPU logits differ by {err}")

    batches = [_m3p_batch(r, (2, 4), 11, 9, 64, 300, 40) for _ in range(3)]
    D = r.rand(40, 40).astype(np.float32)
    runs = {}
    for dev, fused, model in (("cuda", "hm", gpu), ("cpu", False, cpu)):
        params = dict(model.named_parameters())
        opt = make_optimizer(list(params), warmup_constant_schedule(1e-5, 0))
        state = TrainState(model, opt.init(params), 0)
        step = make_train_step(opt, torch.from_numpy(D).to(dev),
                               semantic_lambda=LAMBDA, compute_dtype=None,
                               fused_attn=fused)
        ms = []
        for i, bb in enumerate(batches):
            state, m = step(state, {k: torch.from_numpy(v).to(dev)
                                    for k, v in bb.items()}, seed=i)
            ms.append((m["loss"].item(), m["grad_norm"].item()))
        runs[dev] = ms, {k: p.detach().cpu() for k, p in params.items()}
    (mk, pk), (mp, pp) = runs["cuda"], runs["cpu"]
    rel = max(abs(x - y) / abs(y) for u, v in zip(mk, mp) for x, y in zip(u, v))
    perr = max((pk[k] - pp[k]).abs().max().item() for k in pp)
    print(f"train parity, tiny M3P fp32, 3 steps, card 'hm' (B3) vs CPU plain: "
          f"loss/grad_norm max rel diff {rel:.3g}, params max abs diff "
          f"{perr:.3g} (tol 1e-4)")
    check(rel <= 1e-4 and perr <= 1e-4, "tiny M3P train parity failed")

    cfg = M3PConfig(dropout=0.0, attention_dropout=0.0, clf_dropout_prob=0.0)
    bb = _m3p_batch(r, (32,), 40, 100, cfg.v_feature_size, cfg.vocab_size,
                    cfg.num_labels)
    batch = {k: torch.from_numpy(v).cuda() for k, v in bb.items()}
    D = torch.from_numpy(r.rand(cfg.num_labels, cfg.num_labels)
                         .astype(np.float32)).cuda()
    model = M3P(cfg, device="cuda", seed=5)
    params = list(model.parameters())
    grads = {}
    for fused in (False, True):
        loss_fn = make_loss_fn(D, semantic_lambda=LAMBDA, compute_dtype=None,
                               fused_attn=fused)
        loss, _ = loss_fn(model, batch, seed=0)
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        grads[fused] = (loss.item(), [g for g in gs if g is not None])
    (lp, gp), (lk, gk) = grads[False], grads[True]
    gmax = max(g.abs().max().item() for g in gp)
    gerr = max((x - y).abs().max().item() for x, y in zip(gk, gp))
    print(f"train parity, M3P full width fp32 mbs 32, True route (B3) vs "
          f"plain: loss {lk:.6f} vs {lp:.6f}; grads max abs diff {gerr:.3g} "
          f"of max |grad| {gmax:.3g} (tol 1e-4 of it)")
    check(abs(lk - lp) <= 1e-4 * abs(lp) and gerr <= 1e-4 * gmax,
          "M3P full-width True route vs plain route gradients differ")
    del grads, model
    torch.cuda.empty_cache()


def phase_m3p(smi: str) -> dict:
    """M3P at its published width (M3PConfig(): 12 x 768, 12 heads, FFN
    3072, vocab 250002, 100 regions x 2048 with 5 locs, 40 tokens, S = 140,
    1842 answers; random weights from seed 0) over the M3P world (images of
    M3P_MIN_REGIONS..100 boxes, so padding slots and -inf keys occur): the
    eval path, the train step with "flat" (B1) and True (B3), the CLI; then
    the parity phase. Returns each path's launch counts."""
    cfg = M3PConfig()
    model = M3P(cfg, device="cuda", seed=0)
    print(f"M3P {cfg.num_layers}x{cfg.hidden_size}, vocab {cfg.vocab_size}, "
          f"{cfg.num_labels} labels: "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params")
    with tempfile.TemporaryDirectory() as tmp:
        w = m3p_world(tmp, N_QA, min_regions=M3P_MIN_REGIONS,
                      num_labels=cfg.num_labels, vocab_size=cfg.vocab_size,
                      device="cuda")
        print(f"M3P bank: {w.bank.nbytes / 1e6:.0f} MB on the card")
        ev = phase_m3p_eval(cfg, model, w, smi)
        by_path = {k: ev[k] for k in ("m3p_eval", "m3p_eval_blocked",
                                      "m3p_predictor")}
        trains = {}
        # both routes start from the same weights, so their first steps
        # (one seed, one batch, one keep mask) give the same loss up to bf16
        # rounding: True's bf16 B3 (the tensor-core kernels) against B1
        start = {k: p.detach().clone() for k, p in model.named_parameters()}
        for fused, name in (("flat", "m3p_train_flat"),
                            (True, "m3p_train_blocked")):
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(start[k])
            trains[name] = phase_train(cfg, model, w, smi, fused)
            by_path[name] = trains[name]["launches"]
        del start
        l_flat, l_true = (trains[n]["loss0"] for n in ("m3p_train_flat",
                                                      "m3p_train_blocked"))
        print(f"M3P step-1 loss from one set of weights: True (B3) {l_true:.6f}, "
              f"flat (B1) {l_flat:.6f}, rel diff {abs(l_true - l_flat) / abs(l_flat):.3g} "
              f"(tol 1%)")
        check(abs(l_true - l_flat) <= 0.01 * abs(l_flat),
              "M3P step-1 loss of the True route is not within 1% of flat's")
        # a task length of 60 tokens: S = 160, the most that B1's bf16
        # backward takes in one key chunk (10 warps at hd 64) on the auto route
        trains["m3p_train_s160"] = phase_train(cfg, model, w, smi, "auto",
                                               seq=M3P_LONG_SEQ)
        by_path["m3p_train_s160"] = trains["m3p_train_s160"]["launches"]
        by_path["m3p_cli"] = phase_m3p_cli(tmp, w, smi)
    del model
    torch.cuda.empty_cache()
    phase_m3p_parity()
    return {"launches": by_path, "eval": ev, "train": trains}


def phase_roi_pool(gen) -> dict:
    """B6 at the C4 extractor's shape: features [50, 84, 1024] bf16 (pad
    800 x 1344 at stride 16) and 300 rois (random ones over the padded
    image plus rois past its edges, degenerate ones and one far larger than
    max_bin bins) -> [300, 14, 14, 1024]; bit-exact against the plain
    version, the same bits twice, and bit-exact again on the map with 1% of
    its elements each NaN, +inf and -inf (a bin holding a NaN gives 0, as
    JAX's ops/roi.py gives); the kernel timed before and after the plain
    version (median of 25 CUDA-event timings each) beside the byte bound (no
    library RoIPool: torchvision is absent)."""
    H, W, C = C4_SHAPE
    feat = torch.randn(H, W, C, device="cuda", generator=gen).bfloat16()
    rois = c4_rois(gen, C4_ROIS)
    kw = dict(output_size=(14, 14), spatial_scale=1 / 16, max_bin=8)
    with torch.no_grad():
        got = roi_pool_nhwc(feat, rois, **kw)
        again = roi_pool_nhwc(feat, rois, **kw)
        ref = roi_pool_nhwc_plain(feat, rois, **kw)
        torch.cuda.synchronize()
        check(got.shape == (C4_ROIS, 14, 14, C) and got.dtype == torch.bfloat16,
              f"B6 output {tuple(got.shape)} {got.dtype}")
        check(torch.equal(got, ref), "B6 is not bit-exact against its plain version")
        check(torch.equal(got, again), "B6: two runs differ")
        u = torch.rand(H, W, C, device="cuda", generator=gen)
        odd = feat.masked_fill(u < 0.01, float("nan")).masked_fill(
            (u >= 0.01) & (u < 0.02), float("inf")).masked_fill(
            (u >= 0.02) & (u < 0.03), float("-inf"))
        odd_ref = roi_pool_nhwc_plain(odd, rois, **kw)
        check(torch.equal(roi_pool_nhwc(odd, rois, **kw), odd_ref),
              "B6 on a map with NaN and infinities is not bit-exact")
        n_zero = int((odd_ref == 0).sum())
        k1 = time_ms(lambda: roi_pool_nhwc(feat, rois, **kw))
        plain = time_ms(lambda: roi_pool_nhwc_plain(feat, rois, **kw), n=5)
        k2 = time_ms(lambda: roi_pool_nhwc(feat, rois, **kw))
    ms = (k1 + k2) / 2
    nbytes = feat.numel() * 2 + rois.numel() * 4 + got.numel() * 2
    bms, by = bound_ms(nbytes, 0, torch.bfloat16)
    print(f"B6 roi_pool [{H}, {W}, {C}] bf16 x {C4_ROIS} rois -> [{C4_ROIS}, 14, 14, "
          f"{C}]: bit-exact, deterministic, bit-exact on the NaN/inf map ({n_zero} "
          f"zeros); kernel {k1:.4f} / {k2:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bms:.4f} ms ({by}; {nbytes / 1e6:.1f} MB; {bms / ms:.1%} of it); no "
          f"library RoIPool (torchvision absent)")
    return {"roi_pool": dict(max_abs_err=0.0, ms=ms, plain_ms=plain, library_ms=None,
                             bound_ms=bms, bound_by=by, kernel_ms_in_turns=[k1, k2])}


def phase_extract(tmp: str, smi: str) -> dict:
    """``python -m clg_vqa_tpu_torch.cli extract --detector c4`` in this
    process at full width and depth (R101-C4, pad 800 x 1344, bf16, random
    weights from seed 0) over N_EXTRACT synthetic 480 x 640 uint8 .npy
    images and one file that does not decode: one B6 launch per image;
    the store read back (36 regions x 2048 finite features, boxes inside the
    image). Then the same extractor timed over the images after a warm-up
    (images/s), and a full-width UC2 run_eval over EXTRACT_QA questions on
    the store (K1, K2). Returns the launch counts of both paths."""
    images = os.path.join(tmp, "images")
    r = np.random.RandomState(0)
    raws = write_images(images, r)
    h, w = EXTRACT_HW
    store = os.path.join(tmp, "extracted.cfs")
    argv = ["extract", "--images", images, "--out", store, "--detector", "c4"]
    print("cli: python -m clg_vqa_tpu_torch.cli " + " ".join(argv))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    cli_main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    print(f"cli extract --detector c4: {N_EXTRACT} images of {h} x {w} at full width "
          f"(R101-C4, pad 800 x 1344, bf16) in {dt:.2f} s with the weights' "
          f"init and first-call set-up on {smi}; launches {counts}")
    check(counts == only(roi_pool=N_EXTRACT),
          f"extract launches {counts}, expected {N_EXTRACT} roi_pool and nothing else")
    reader = CfsReader(store)
    ids = sorted(reader.keys())
    check(ids == sorted(f"im{i}" for i in range(N_EXTRACT)),
          f"extracted store holds {ids}")
    for key in ids:
        rec = reader.get(key)
        check(rec.features.shape == (36, 2048) and bool(np.isfinite(rec.features).all()),
              f"record {key}: features {rec.features.shape}")
        check(rec.boxes.shape == (36, 4) and (rec.img_w, rec.img_h) == (w, h)
              and bool((rec.boxes >= 0).all()) and bool((rec.boxes[:, 0::2] <= w).all())
              and bool((rec.boxes[:, 1::2] <= h).all()), f"record {key}: boxes")
    print(f"store: {len(ids)} records of [36, 2048] finite features and 36 boxes "
          f"inside their {w} x {h} image")

    ex = Extractor36(init_extractor_params(torch.Generator().manual_seed(0)),
                     ExtractorConfig(), device="cuda")
    items = [(img, f"im{i}") for i, img in enumerate(raws)]
    list(ex.extract_many(items[:2]))                                    # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recs = list(ex.extract_many(items))
    dt = time.perf_counter() - t0
    first = reader.get("im0")
    check(np.array_equal(recs[0].obj_id, first.obj_id)
          and np.allclose(recs[0].features, first.features, rtol=1e-3,
                          atol=1e-3 * np.abs(first.features).max()),
          "the timed extractor gives other records than the CLI")
    print(f"extract_many, device_batch 1: {N_EXTRACT} images in {dt:.3f} s -> "
          f"{N_EXTRACT / dt:.2f} images/s (warm) on {smi}")
    proposals = time_roi_pool_on_proposals(ex, items[0])
    del ex
    torch.cuda.empty_cache()

    cfg = UC2Config()
    model = UC2(cfg, device="cuda", seed=0)
    words = [f"word{i}" for i in range(3000)]
    entries = [Entry(question_id=i, image_id=f"im{i % N_EXTRACT}",
                     question=" ".join(r.choice(words, r.randint(4, 12))),
                     labels=[int(r.randint(cfg.num_labels))], scores=[1.0])
               for i in range(EXTRACT_QA)]
    ds = GQADataset(entries, reader, HashTokenizer(cfg.vocab_size), max_seq_length=40,
                    max_region_num=36, num_locs=cfg.num_locs, num_labels=cfg.num_labels)
    bank = DeviceFeatureBank(reader, max_regions=36, num_locs=cfg.num_locs,
                             device="cuda")
    label2ans = [f"a{i}" for i in range(cfg.num_labels)]
    kw = dict(batch_size=EXTRACT_QA, device_bank=bank, fused_attn="flat")
    run_eval(model, ds, label2ans, **kw)                                # warm-up
    torch.cuda.synchronize()
    reset_counts()
    res = run_eval(model, ds, label2ans, out_path=os.path.join(tmp, "ext_result.json"),
                   **kw)
    eval_counts = read_counts()
    check(res["n"] == EXTRACT_QA and eval_counts == only(
        flat_attention=cfg.num_layers, rows_gather=1),
        f"eval over the extracted store: {res['n']} QA, launches {eval_counts}")
    print(f"run_eval UC2 full width over the extracted store: {res['n']} questions, "
          f"bf16, K1; launches {eval_counts}")
    del model
    torch.cuda.empty_cache()
    return {"extract_c4": counts, "extract_eval": eval_counts,
            "images_per_s": N_EXTRACT / dt, "proposals": proposals}


def write_images(directory: str, r: np.random.RandomState) -> list:
    """N_EXTRACT synthetic EXTRACT_HW uint8 .npy images im0.. drawn from r
    and one file that does not decode; returns the arrays."""
    os.makedirs(directory)
    h, w = EXTRACT_HW
    raws = [(r.rand(h, w, 3) * 255).astype(np.uint8) for _ in range(N_EXTRACT)]
    for i, img in enumerate(raws):
        np.save(os.path.join(directory, f"im{i}.npy"), img)
    with open(os.path.join(directory, "readme.txt"), "w") as f:
        f.write("not an image")
    return raws


def x101_agreement(rec, cli_rec, db: int) -> tuple:
    """How far a timed record lies from the CLI's (device_batch 1) record
    of the same image: (share of the 100 boxes that agree, largest feature
    difference on those over the largest |feature|). At device_batch 1 the
    two runs are the same computation: every box agrees, features within
    1e-3. At device_batch > 1 cuDNN convolves the batch with other
    algorithms, which round bf16 elsewhere (in fp32 the card test holds
    device_batch 2 to the CPU's device_batch 1 within 1e-3): the boxes the
    class NMS kept must agree with their ids and confidences, at least 80%
    of all boxes (JAX's own device-batch test asks as much), features
    within 3e-2."""
    close_boxes = np.all(np.isclose(rec.boxes, cli_rec.boxes, rtol=1e-3, atol=1e-2),
                         axis=1)
    scale = float(np.abs(cli_rec.features).max())
    fdiff = float(np.abs(rec.features[close_boxes] - cli_rec.features[close_boxes])
                  .max(initial=0.0)) / scale
    n = int((cli_rec.obj_conf > 0).sum())
    kept_same = (bool(close_boxes[:n].all())
                 and np.array_equal(rec.obj_id[:n], cli_rec.obj_id[:n])
                 and np.allclose(rec.obj_conf[:n], cli_rec.obj_conf[:n], rtol=1e-2))
    share, tol = (1.0, 1e-3) if db == 1 else (0.8, 3e-2)
    check(kept_same and close_boxes.mean() >= share and fdiff <= tol,
          f"X101 {rec.image_id} at device_batch {db} against the CLI's record: "
          f"kept boxes the same {kept_same}, boxes agreeing {close_boxes.mean():.2f} "
          f"(>= {share}), features {fdiff:.3g} of the largest (<= {tol})")
    return float(close_boxes.mean()), fdiff


def phase_extract_x101(tmp: str, smi: str) -> dict:
    """``python -m clg_vqa_tpu_torch.cli extract --detector x101`` in this
    process at full width and depth (X101Config(), random weights from seed
    0) over the images of the C4 phase: no kernel of the port launches. The
    store read back; ExtractorX101.extract_many timed at device_batch 1 and
    4 after a warm-up of each, beside its peak memory and the fixpoint
    NMS's host reads an image; then a full-width M3P run_eval on the auto
    rule over X101_QA questions on the store (100 regions, 5 locs,
    L2-normalized features, bf16): K1 12 and K2 1. Returns the launch counts
    of both paths and the throughputs."""
    images = os.path.join(tmp, "images")
    raws = write_images(images, np.random.RandomState(0))
    h, w = EXTRACT_HW
    store = os.path.join(tmp, "x101.cfs")
    argv = ["extract", "--images", images, "--out", store, "--detector", "x101"]
    print("cli: python -m clg_vqa_tpu_torch.cli " + " ".join(argv))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    cli_main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    print(f"cli extract --detector x101: {N_EXTRACT} images of {h} x {w} at full "
          f"width (X-101 64x4d, FPN 512, 1000 proposals, 100 boxes, pad 800 x 1344, "
          f"bf16) in {dt:.2f} s with the weights' init and first-call set-up on "
          f"{smi}; launches {counts}")
    check(counts == only(), f"x101 extract launches {counts}, expected none")
    reader = CfsReader(store)
    ids = sorted(reader.keys())
    check(ids == sorted(f"im{i}" for i in range(N_EXTRACT)),
          f"x101 store holds {ids}")
    n_valid = []
    for key in ids:
        rec = reader.get(key)
        check(rec.features.shape == (100, 2048) and bool(np.isfinite(rec.features).all()),
              f"x101 record {key}: features {rec.features.shape}")
        check(rec.boxes.shape == (100, 4) and (rec.img_w, rec.img_h) == (w, h)
              and bool(np.isfinite(rec.boxes).all()) and bool((rec.boxes >= 0).all())
              and bool((rec.boxes[:, 0::2] <= w).all())
              and bool((rec.boxes[:, 1::2] <= h).all()), f"x101 record {key}: boxes")
        check(bool((rec.obj_conf >= 0).all()) and bool((rec.obj_conf <= 1).all())
              and bool((np.diff(rec.obj_conf) <= 0).all()),
              f"x101 record {key}: confidences not in [0, 1] descending")
        n_valid.append(int((rec.obj_conf > 0).sum()))
    print(f"x101 store: {len(ids)} records of [100, 2048] finite features and 100 "
          f"boxes inside their {w} x {h} image; num_valid (boxes the class NMS "
          f"kept) {n_valid}")

    ex = ExtractorX101(init_x101_params(torch.Generator().manual_seed(0)),
                       X101Config(), device="cuda")
    items = [(img, f"im{i}") for i, img in enumerate(raws)]
    timed = {}
    for db in X101_BATCHES:
        list(ex.extract_many(items[:db], device_batch=db))               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        syncs = batched_nms_fixpoint.host_syncs
        t0 = time.perf_counter()
        recs = list(ex.extract_many(items, device_batch=db))
        dt = time.perf_counter() - t0
        syncs = (batched_nms_fixpoint.host_syncs - syncs) / N_EXTRACT
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        agree = [x101_agreement(rec, reader.get(rec.image_id), db) for rec in recs]
        timed[db] = dict(images_per_s=N_EXTRACT / dt, peak_gib=peak,
                         nms_host_syncs_per_image=syncs,
                         boxes_agreeing=min(a for a, _ in agree),
                         feature_diff=max(f for _, f in agree))
        print(f"ExtractorX101.extract_many, device_batch {db}: {N_EXTRACT} images "
              f"in {dt:.3f} s -> {N_EXTRACT / dt:.3f} images/s (warm), peak "
              f"{peak:.2f} GiB allocated, fixpoint NMS host reads {syncs:.1f} an "
              f"image, on {smi}; against the CLI's records: boxes agreeing >= "
              f"{timed[db]['boxes_agreeing']:.2f}, features of those within "
              f"{timed[db]['feature_diff']:.3g} of the largest")
    del ex
    torch.cuda.empty_cache()

    cfg = M3PConfig()
    model = M3P(cfg, device="cuda", seed=0)
    r = np.random.RandomState(1)
    words = [f"word{i}" for i in range(3000)]
    entries = [Entry(question_id=i, image_id=f"im{i % N_EXTRACT}",
                     question=" ".join(r.choice(words, r.randint(4, 12))),
                     labels=[int(r.randint(cfg.num_labels))], scores=[1.0])
               for i in range(X101_QA)]
    ds = GQADataset(entries, reader, HashTokenizer(cfg.vocab_size), max_seq_length=40,
                    max_region_num=100, num_locs=cfg.num_locs,
                    num_labels=cfg.num_labels, norm_embeddings=True)
    bank = DeviceFeatureBank(reader, max_regions=100, num_locs=cfg.num_locs,
                             norm_embeddings=True, device="cuda")
    # a box at (0, 0, 0, 0) has all-zero locs, which the L2 normalization
    # (data/features.py, as the JAX package's, no epsilon) turns into NaN
    zero_boxes = sum(int((np.abs(reader.get(k).boxes).sum(1) == 0).sum()) for k in ids)
    nan_rows = int(torch.isnan(bank.locs).any(-1).sum())
    print(f"x101 store: {zero_boxes} of {100 * len(ids)} boxes at (0, 0, 0, 0); "
          f"{nan_rows} bank rows with NaN locs after the L2 normalization")
    label2ans = [f"a{i}" for i in range(cfg.num_labels)]
    kw = dict(batch_size=EVAL_BS, device_bank=bank)
    run_eval(model, ds, label2ans, **kw)                                # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = run_eval(model, ds, label2ans, out_path=os.path.join(tmp, "x101_result.json"),
                   **kw)
    dt = time.perf_counter() - t0
    eval_counts = read_counts()
    n_batches = math.ceil(X101_QA / EVAL_BS)
    check(res["n"] == X101_QA and eval_counts == only(
        flat_attention=cfg.num_layers * n_batches, rows_gather=n_batches),
        f"M3P eval over the x101 store: {res['n']} QA, launches {eval_counts}")
    print(f"run_eval M3P full width over the x101 store: {res['n']} questions in "
          f"{dt:.3f} s -> {res['n'] / dt:.1f} QA/s (bs {EVAL_BS}, bf16, auto: K1, "
          f"bank on, {n_batches} batch) on {smi}; launches {eval_counts}")
    del model, bank
    torch.cuda.empty_cache()
    return {"extract_x101": counts, "extract_x101_eval": eval_counts,
            "timed": timed, "n_valid": n_valid, "zero_boxes": zero_boxes}


def time_roi_pool_on_proposals(ex, item) -> dict:
    """B6 on one image's own call: the extractor's feature map and its RPN's
    proposals, caught at the pooler; bit-exact against the plain version,
    the kernel timed beside its byte bound."""
    seen, pool = [], ex._pool

    def catch(feat, boxes, **kw):
        seen.append((feat, boxes, kw))
        return pool(feat, boxes, **kw)

    ex._pool = catch
    list(ex.extract_many([item]))
    ex._pool = pool
    feat, boxes, kw = seen[0]
    with torch.no_grad():
        got = roi_pool_nhwc(feat, boxes, **kw)
        check(torch.equal(got, roi_pool_nhwc_plain(feat, boxes, **kw)),
              "B6 on the extractor's proposals is not bit-exact")
        ms = time_ms(lambda: roi_pool_nhwc(feat, boxes, **kw))
    nbytes = (feat.numel() + got.numel()) * feat.element_size() + boxes.numel() * 4
    bms, by = bound_ms(nbytes, 0, torch.bfloat16)
    print(f"B6 on one image's proposals: map {list(feat.shape)} {feat.dtype}, "
          f"{boxes.shape[0]} boxes: bit-exact; kernel {ms:.4f} ms, bound {bms:.4f} ms "
          f"({by}; {bms / ms:.1%} of it)")
    return dict(ms=ms, bound_ms=bms, bound_by=by, n_boxes=int(boxes.shape[0]))


def uc2_distance_matrix(cfg: UC2Config, seed: int = 0) -> np.ndarray:
    """bench.py:56's semantic-prior distance matrix: uniform from a seed."""
    return np.random.RandomState(seed).rand(
        cfg.num_labels, cfg.num_labels).astype(np.float32)


def phase_recipe(smi: str) -> dict:
    """FinetuneRunner.finetune at UC2's full width with fused_attn="sm":
    one epoch of RECIPE_STEPS steps of acc 2 x mbs 128 (bf16, dropout 0.1,
    lambda 10, device bank) over data/synthetic.train_dataset, then val over
    N_VAL eval_world questions at batch 1024 (K1); the best-params and the
    end-of-epoch full-state saves and a .bin export into a temporary
    directory. Returns the run's launch counts."""
    cfg = UC2Config()
    with tempfile.TemporaryDirectory() as tmp:
        world = eval_world(tmp, N_VAL, num_labels=cfg.num_labels,
                           vocab_size=cfg.vocab_size, device="cuda")
        pipe = TrainPipeline(train_dataset(world, RECIPE_STEPS * ACC * MBS),
                             micro_batch_size=MBS, grad_acc_steps=ACC, seed=0,
                             device="cuda", with_features=False)
        task = TaskConfig(batch_size=ACC * MBS, eval_batch_size=EVAL_BS,
                          num_epoch=1, semantic_lambda=LAMBDA)
        model = UC2(cfg, device="cuda", seed=0)
        out = os.path.join(tmp, "run")
        runner = FinetuneRunner(
            model, pipe, world.dataset, uc2_distance_matrix(cfg),
            task_cfg=task, optim_cfg=OptimConfig(grad_acc_steps=ACC),
            output_dir=out, compute_dtype=torch.bfloat16, seed=0,
            train_bank=world.bank, fused_attn="sm")
        check(runner.train_fused == "sm", f"train route {runner.train_fused}")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        best = runner.finetune()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        runner.export_torch("model.bin")
        runner.flush_saves()
        n_blocks = cfg.num_layers * ACC
        print(f"recipe: FinetuneRunner.finetune, 1 epoch of {RECIPE_STEPS} "
              f"steps of {ACC} x {MBS} (bf16, dropout {RATE}, lambda {LAMBDA}, "
              f"fused_attn='sm', bank on) + val over {N_VAL} questions in "
              f"{dt:.2f} s on {smi}: best val score {best:.4f}, integrated "
              f"{runner.last_epoch_qa_per_sec:.1f} QA/s; launches {counts}")
        check(0.0 <= best <= 1.0, f"best val score {best}")
        check(counts["smajor_attention_train_fwd"] == n_blocks * RECIPE_STEPS
              and counts["smajor_attention_train_bwd"] == n_blocks * RECIPE_STEPS
              and counts["flat_attention_train_fwd"] == 0
              and counts["flat_attention_train_bwd"] == 0
              and counts["flat_attention"] > 0 and counts["rows_gather"] > 0,
              f"recipe launches {counts}, expected {n_blocks} B5 forward and "
              f"backward per step, no B1, some K1 and K2")
        for rec in runner.save_log:
            print(f"save {rec['what']} {os.path.relpath(rec['path'], out)}: "
                  f"{rec['bytes']} bytes in {rec['seconds']:.2f} s")
        check({r["what"] for r in runner.save_log} == {"params", "state", "bin"},
              f"saves {[r['what'] for r in runner.save_log]}")
        with open(os.path.join(out, "meta.json")) as f:
            meta = json.load(f)
        check(meta["epoch"] == 0 and meta["step"] == RECIPE_STEPS
              and os.path.exists(os.path.join(out, meta["state_dir"],
                                              "state.pt")), f"meta {meta}")
        recs = [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]
        losses = [r["loss"] for r in recs if r["kind"] == "train"]
        check(len(losses) == RECIPE_STEPS and all(map(math.isfinite, losses)),
              f"train records {losses}")

        # the exported .bin, loaded into a fresh model the way the CLI's
        # --from_pretrained does, gives the trained model's fp32 logits
        fresh = load_numpy_state(UC2(cfg, device="cuda", seed=1),
                                 load_pretrained(os.path.join(out, "model.bin"),
                                                 cfg))
        batch = {k: torch.from_numpy(v).cuda() for k, v in
                 world.dataset.make_batch(list(range(N_VAL))).items()
                 if k in ("input_ids", "input_mask", "features", "locs",
                          "image_mask")}
        with torch.no_grad():
            a = model(batch, compute_dtype=None, fused_attn="flat")
            b = fresh(batch, compute_dtype=None, fused_attn="flat")
        check(torch.isfinite(a).all().item() and a.shape == (N_VAL, cfg.num_labels),
              "bad trained logits")
        check(torch.equal(a, b), "the reloaded .bin gives other fp32 logits: "
              f"max abs diff {(a - b).abs().max().item()}")
        print(f"recipe: .bin reloaded into a fresh model: fp32 val logits "
              f"[{N_VAL}, {cfg.num_labels}] equal the trained model's")
        qa_per_s = runner.last_epoch_qa_per_sec
        del runner, model, fresh
    torch.cuda.empty_cache()
    return {"launches": counts, "qa_per_s": qa_per_s}


def phase_recipe_parity() -> None:
    """A tiny UC2 (hd 64) fine-tuned 2 epochs of 4 steps on the card, bf16,
    dropout 0.1, for fused_attn "flat", "sm" and "proj": preempted after step 2
    through the _step_callback seam and resumed in a fresh runner, it ends
    with the uninterrupted run's parameters bit for bit."""
    tiny = UC2Config(vocab_size=300, hidden_size=128, num_layers=2, num_heads=2,
                     intermediate_size=256, v_feature_size=64, num_locs=7,
                     pooler_size=128, clf_hidden_size=64, num_labels=40)
    r = np.random.RandomState(6)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tiny.cfs")
        write_store(path, r, n_images=16, regions=9, feat_dim=64)
        reader = CfsReader(path)
        entries = make_entries(r, 64, n_images=16, num_labels=40)

        def dataset(es):
            return GQADataset(es, reader, HashTokenizer(300), max_seq_length=11,
                              max_region_num=9, num_locs=7, num_labels=40)

        train, val = dataset(entries), dataset(entries[:16])
        bank = DeviceFeatureBank(reader, max_regions=9, num_locs=7,
                                 device="cuda")
        D = r.rand(40, 40).astype(np.float32)
        task = TaskConfig(num_labels=40, max_seq_length=11, max_region_num=9,
                          batch_size=16, eval_batch_size=16, lr=5e-3,
                          num_epoch=2, semantic_lambda=LAMBDA)

        def runner(out, fused):
            pipe = TrainPipeline(train, micro_batch_size=8, grad_acc_steps=2,
                                 seed=0, device="cuda", with_features=False)
            return FinetuneRunner(
                UC2(tiny, device="cuda", seed=4), pipe, val, D, task_cfg=task,
                optim_cfg=OptimConfig(lr=5e-3, grad_acc_steps=2),
                output_dir=os.path.join(tmp, out),
                compute_dtype=torch.bfloat16, seed=3, train_bank=bank,
                fused_attn=fused)

        for fused in ("flat", "sm", "proj"):
            a = runner(f"a_{fused}", fused)
            a.finetune()
            b = runner(f"b_{fused}", fused)
            seen = []

            def hook(i, b=b, seen=seen):
                seen.append(i)
                if len(seen) >= 2:
                    b._preempted = True

            b._step_callback = hook
            try:
                b.finetune()
                check(False, "the preempted run did not stop")
            except SystemExit:
                pass
            with open(os.path.join(tmp, f"b_{fused}", "meta.json")) as f:
                check(json.load(f)["mid_epoch_step"] == 2, "preempt meta")
            c = runner(f"b_{fused}", fused)
            c.finetune(resume=True)
            want = dict(a.model.named_parameters())
            diff = [k for k, p in c.model.named_parameters()
                    if not torch.equal(p, want[k])]
            print(f"recipe parity, tiny UC2 bf16 dropout {RATE}, "
                  f"fused_attn={fused!r}: preempted at step 2, resumed; "
                  f"{len(want) - len(diff)} of {len(want)} parameters equal the "
                  f"uninterrupted run's bit for bit")
            check(not diff, f"resumed run differs in {diff[:5]}")
    for sig, handler in ((signal.SIGTERM, signal.SIG_DFL),
                         (signal.SIGINT, signal.default_int_handler)):
        signal.signal(sig, handler)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    kern = phase_kernels()
    kern.update(phase_train_kernel(torch.Generator("cuda").manual_seed(1)))
    kern.update(phase_smajor_kernel(torch.Generator("cuda").manual_seed(2)))
    kern.update(phase_block_kernel(torch.Generator("cuda").manual_seed(3)))
    kern.update(phase_blocked_kernel(torch.Generator("cuda").manual_seed(4)))
    mma = phase_mma(torch.Generator("cuda").manual_seed(7))
    t_phase = time.perf_counter()
    long_s = phase_long_s(torch.Generator("cuda").manual_seed(5))
    print(f"long-S phase {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    kern.update(phase_roi_pool(torch.Generator("cuda").manual_seed(6)))
    with tempfile.TemporaryDirectory() as tmp:
        extract = phase_extract(tmp, smi)
    kern["roi_pool"]["extract_proposals"] = extract["proposals"]
    print(f"detector phase {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        x101 = phase_extract_x101(tmp, smi)
    print(f"X101 phase {time.perf_counter() - t_phase:.1f} s")
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
        train_proj = phase_train(cfg, model, w, smi, fused="proj")
        phase_train_ab(cfg, model, w, smi)
        cli = phase_cli(tmp, w, smi)
        prune_sft = phase_prune_sft(tmp, w, smi)
    del model
    torch.cuda.empty_cache()
    phase_train_parity()
    recipe = phase_recipe(smi)
    phase_recipe_parity()
    m3p = phase_m3p(smi)
    # `launches`: the count of the kernel's own slice's main path (run_eval
    # for the eval kernels, the train step for B1, the fine-tune recipe for
    # B5, the proj train step for B4, M3P's run_eval with fused_attn=True
    # for B2 and its train step with fused_attn=True for B3, cli extract for
    # B6);
    # `launches_by_path` gives each path's own count
    by_path = dict(main_path["launches"], train=train["launches"],
                   train_proj=train_proj["launches"],
                   finetune=recipe["launches"], cli_proj=cli,
                   prune=prune_sft["launches"]["prune"],
                   sft=prune_sft["launches"]["sft"],
                   **m3p["launches"], extract_c4=extract["extract_c4"],
                   extract_eval=extract["extract_eval"],
                   extract_x101=x101["extract_x101"],
                   extract_x101_eval=x101["extract_x101_eval"])
    for name in ("fwd", "bwd"):
        kern[f"flat_attention_train_{name}/{torch.bfloat16}"].update(
            long_s={k: v for k, v in long_s.items() if k.endswith(name)},
            m3p_shapes={k: v for k, v in mma.items() if k.endswith(name)},
            strides_ms={S: {lay: ms for lay, ms in t.items() if lay.endswith(name)}
                        for S, t in mma["strides"].items()})
    bf16 = torch.bfloat16
    # `device_code`: the device code each kernel runs in bf16 on its main path
    csrc = "clg_vqa_tpu_torch/csrc/"
    mma, ev, gemm = (csrc + f for f in ("attention_train_mma.cuh", "attention_eval.cuh",
                                        "gemm_wgmma.cuh"))
    kernels = [
        {"name": name, "route": "cuda", "source": csrc + source, "replaces": replaces,
         "device_code": code, "launches": by_path[path][name],
         "launches_by_path": {p: c[name] for p, c in by_path.items()},
         **kern[key]}
        for name, path, key, source, code, replaces in (
            ("flat_attention", "run_eval", f"flat_attention/{bf16}",
             "flat_attention.cu", ev, "clg_vqa_tpu/ops/attention.py:385"),
            ("rows_gather", "run_eval", "rows_gather", "rows_gather.cu",
             csrc + "rows_gather.cu", "clg_vqa_tpu/ops/bank_gather.py:34"),
            ("flat_attention_train_fwd", "train",
             f"flat_attention_train_fwd/{bf16}", "flat_attention_train.cu", mma,
             "clg_vqa_tpu/ops/attention.py:385"),
            ("flat_attention_train_bwd", "train",
             f"flat_attention_train_bwd/{bf16}", "flat_attention_train.cu", mma,
             "clg_vqa_tpu/ops/attention.py:413"),
            ("smajor_attention_train_fwd", "finetune",
             f"smajor_attention_train_fwd/{bf16}", "smajor_attention_train.cu", mma,
             "clg_vqa_tpu/ops/attention.py:1082"),
            ("smajor_attention_train_bwd", "finetune",
             f"smajor_attention_train_bwd/{bf16}", "smajor_attention_train.cu", mma,
             "clg_vqa_tpu/ops/attention.py:1100"),
            ("block_attention_train_fwd", "train_proj",
             f"block_attention_train_fwd/{bf16}", "block_attention_train.cu",
             f"{csrc}block_attention_train.cu, {gemm} and {mma}",
             "clg_vqa_tpu/ops/attention.py:678"),
            ("block_attention_train_bwd", "train_proj",
             f"block_attention_train_bwd/{bf16}", "block_attention_train.cu",
             f"{csrc}block_attention_train.cu, {gemm} and {mma}",
             "clg_vqa_tpu/ops/attention.py:726"),
            ("blocked_attention", "m3p_eval_blocked", "blocked_attention",
             "blocked_attention.cu", ev, "clg_vqa_tpu/ops/attention.py:117"),
            ("blocked_attention_train_fwd", "m3p_train_blocked",
             "blocked_attention_train_fwd", "blocked_attention_train.cu", mma,
             "clg_vqa_tpu/ops/attention.py:209"),
            ("blocked_attention_train_bwd", "m3p_train_blocked",
             "blocked_attention_train_bwd", "blocked_attention_train.cu", mma,
             "clg_vqa_tpu/ops/attention.py:223"),
            ("roi_pool", "extract_c4", "roi_pool", "roi_pool.cu",
             csrc + "roi_pool.cu", "clg_vqa_tpu/ops/roi_pallas.py:30"))
    ]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
