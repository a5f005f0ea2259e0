"""Host time to issue one bf16 training-attention call, forward and
backward, through B1's and B5's entries at a tiny shape ([8, 13, 768], 12
heads of 64, rate 0.1), where the device work is negligible and the host's
issue time is what a host-paced step pays per call; or, with
``--gather-roi``, the host and device cost of a call of the bank row gather
(K2) and of RoIPool (B6) at their main paths' shapes.

    python3 clg_vqa_tpu_torch/tools/host_cost.py ROOT
    python3 clg_vqa_tpu_torch/tools/host_cost.py --gather-roi ROOT

Imports the ``clg_vqa_tpu_torch`` package of the checkout at ROOT, so two
checkouts (a change and its parent, unpacked with ``git archive``) can be
timed in turns on one card (run P C C P). The attention mode prints, per
entry, the median and least of 5 host-clock timings of 400 calls.
``--gather-roi`` prints one JSON line: K2 on a bank of [400, 36, 2048]
fp32 (UC2) at 1024 (eval), 128 (train) and 8 (serving) indices and on
[400, 100, 2048] fp32 (M3P) at 1024, the kernel and ``index_select`` timed
in turns (kernel, library, library, kernel; median of 25 CUDA events) with
their device time per kernel (``torch.profiler``) and host time per call,
beside the byte bound (each distinct row read once, each output row
written once, the indices read once); B6 at the C4 extractor's shape, bf16
[50, 84, 1024] and 300 rois, likewise, beside the time the card's own
``zero_()`` takes to write the same output. Needs a CUDA device.
"""
import json
import sys
import time

import torch

B, S, H, HD, N = 8, 13, 12, 64, 400


def main(root: str) -> None:
    sys.path.insert(0, root)
    from clg_vqa_tpu_torch.ops import attention as TA
    g = torch.Generator("cuda").manual_seed(0)
    q, k, v, w = (torch.randn(B, S, H * HD, device="cuda", generator=g).bfloat16()
                  for _ in range(4))
    bias = torch.zeros(B, 1, 1, S, device="cuda")
    ins = [t.requires_grad_() for t in (q, k, v)]
    res = {}
    for name, fn in (("flat", TA.fused_attention_train_flat),
                     ("sm", TA.fused_attention_train_smajor)):
        times = []
        for rep in range(5):
            for i in range(20 if rep == 0 else 0):
                torch.autograd.grad(fn(*ins, bias, H, dropout_rate=0.1, seed=i), ins, w)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(N):
                torch.autograd.grad(fn(*ins, bias, H, dropout_rate=0.1, seed=i), ins, w)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            times.append((t1 - t0) / N * 1e6)
        res[name] = sorted(times)
    print(root, {n: f"median {t[2]:.1f} us, min {t[0]:.1f} us" for n, t in res.items()},
          "(host time to issue one forward + backward, bf16 [8, 13, 768])")


def gather_roi(root: str) -> dict:
    sys.path.insert(0, root)
    # this file runs as a script, so its directory is on sys.path and gives
    # this checkout's measure.py, whatever ROOT holds
    from measure import bound_ms, c4_rois, device_us, host_us, time_ms
    from clg_vqa_tpu_torch.ops.bank_gather import rows_gather, rows_gather_plain
    from clg_vqa_tpu_torch.ops.roi_pool import roi_pool_nhwc, roi_pool_nhwc_plain
    gen = torch.Generator("cuda").manual_seed(0)
    res = {"root": root, "device": torch.cuda.get_device_name(0)}

    def cost(kern, lib=None) -> dict:
        c = {"kernel_ms": [time_ms(kern)], "device_us": device_us(kern),
             "host_us": host_us(kern)}
        if lib is not None:
            c["library_ms"] = [time_ms(lib), time_ms(lib)]
            c["kernel_ms"].append(time_ms(kern))
            c["library_device_us"] = device_us(lib)
            c["library_host_us"] = host_us(lib)
        return c

    banks = {R: torch.randn(400, R, 2048, device="cuda", generator=gen) for R in (36, 100)}
    for name, R, B in (("eval", 36, 1024), ("train", 36, 128), ("serving", 36, 8),
                       ("m3p_eval", 100, 1024)):
        bank = banks[R]
        idx = torch.randint(0, 400, (B,), device="cuda", generator=gen, dtype=torch.int32)
        if not torch.equal(rows_gather(bank, idx), rows_gather_plain(bank, idx)):
            raise RuntimeError(f"{root}: K2 {name} is not bit-exact")
        nbytes = (torch.unique(idx).numel() + B) * R * 2048 * 4 + B * 4
        res[f"K2 {name}"] = dict(cost(lambda: rows_gather(bank, idx),
                                      lambda: torch.index_select(bank, 0, idx)),
                                 bound_ms=bound_ms(nbytes, 0, torch.float32)[0])
    del banks
    feat = torch.randn(50, 84, 1024, device="cuda", generator=gen).bfloat16()
    rois = c4_rois(gen)
    kw = dict(output_size=(14, 14), spatial_scale=1 / 16, max_bin=8)
    with torch.no_grad():
        got = roi_pool_nhwc(feat, rois, **kw)
        if not torch.equal(got, roi_pool_nhwc_plain(feat, rois, **kw)):
            raise RuntimeError(f"{root}: B6 is not bit-exact")
        nbytes = feat.numel() * 2 + rois.numel() * 4 + got.numel() * 2
        res["B6 c4"] = dict(cost(lambda: roi_pool_nhwc(feat, rois, **kw)),
                            bound_ms=bound_ms(nbytes, 0, torch.bfloat16)[0],
                            output_zero_ms=time_ms(got.zero_))
    return res


if __name__ == "__main__":
    if sys.argv[1] == "--gather-roi":
        print(json.dumps(gather_roi(sys.argv[2])))
    else:
        main(sys.argv[1])
