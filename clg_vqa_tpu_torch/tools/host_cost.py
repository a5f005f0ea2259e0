"""Host time to issue one bf16 training-attention call, forward and
backward, through B1's and B5's entries at a tiny shape ([8, 13, 768], 12
heads of 64, rate 0.1), where the device work is negligible and the host's
issue time is what a host-paced step pays per call.

    python3 clg_vqa_tpu_torch/tools/host_cost.py ROOT

Imports the ``clg_vqa_tpu_torch`` package of the checkout at ROOT, so two
checkouts (a change and its parent, unpacked with ``git archive``) can be
timed in turns on one card. Prints, per entry, the median and least of 5
host-clock timings of 400 calls. Needs a CUDA device.
"""
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


if __name__ == "__main__":
    main(sys.argv[1])
