"""Hold the kernels of two checkouts of this repository to each other, bit
for bit.

    python3 clg_vqa_tpu_torch/tools/kernel_bits.py run ROOT OUT.pt
    python3 clg_vqa_tpu_torch/tools/kernel_bits.py compare A.pt B.pt

``run`` imports the ``clg_vqa_tpu_torch`` package of the checkout at ROOT
(its kernels build into ROOT/build/torch_kernels), runs every attention
kernel whose bits a change to the shared CUDA headers must keep on fixed
inputs made from seeds, and saves the outputs and gradients: fp32 B1, B5
and B3 (both entries) all-keys and key-blocked, bf16 B3 both ways, the
bf16 forwards of B1, B5 and B3 and B1's and B5's bf16 backwards, B4 in both
dtypes, K1 and B2 in both dtypes; and the bank row gather K2 (UC2's and
M3P's banks, fp32 and bf16, 12293 indices of 16-byte rows) and RoIPool B6
(the C4 shape and a map with NaN and infinities, fp32 and bf16), whose
results are exact. ``compare`` counts the cases whose
tensors are equal and names the others; it exits 1 if any differs (a PR
that redesigns a kernel expects that kernel's cases, and only those, to
differ). To check a change against its parent,
unpack the parent commit (``git archive``) into a gitignored directory and
run both checkouts on one card. Needs a CUDA device.
"""
import sys

import torch


def run(root, out):
    sys.path.insert(0, root)
    from clg_vqa_tpu_torch.ops import attention as TA
    from clg_vqa_tpu_torch.ops import block_attention as TB
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    res = {}

    def inputs(B, S, H, hd, dtype, neg_inf, seed):
        g = torch.Generator(dev).manual_seed(seed)
        q, k, v, w = (torch.randn(B, S, H * hd, device=dev, generator=g).to(dtype)
                      for _ in range(4))
        valid = torch.ones(B, S, dtype=torch.bool, device=dev)
        if S // 3:
            valid[1, -(S // 3):] = False
        fill = float("-inf") if neg_inf else -10000.0
        bias = torch.zeros(B, 1, 1, S, device=dev).masked_fill(~valid[:, None, None, :], fill)
        return q, k, v, bias, w

    def hm_train(q, k, v, bias, H, **kw):
        B, S, D = q.shape
        sp = [t.view(B, S, H, D // H).transpose(1, 2).contiguous() for t in (q, k, v)]
        o = TA.fused_attention_train_hm(*sp, bias, **kw)
        return o.transpose(1, 2).reshape(B, S, D)

    def grads(fn, q, k, v, bias, w, H, **kw):
        ins = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
        o = fn(*ins, H, **kw)
        gs = torch.autograd.grad(o, ins, w)
        return [o.detach().cpu()] + [x.cpu() for x in gs]

    train = {"B1": TA.fused_attention_train_flat, "B5": TA.fused_attention_train_smajor,
             "B3": TA.fused_attention_train, "B3hm": hm_train}
    # fp32 B1, B5, B3: all-keys (S <= 158) and key-blocked (backward from 159,
    # forward from 418), hd 64; S 612 also at hd 32 and 128
    for S, hds in ((13, (64,)), (76, (64,)), (140, (64,)), (159, (64,)), (612, (32, 64, 128))):
        for hd in hds:
            H = 384 // hd if hd != 64 else 12
            for neg_inf in (False, True):
                q, k, v, bias, w = inputs(8, S, H, hd, torch.float32, neg_inf, S + hd)
                for rate in (0.0, 0.1):
                    for name, fn in train.items():
                        res[f"fp32 {name} S{S} hd{hd} inf{int(neg_inf)} r{rate}"] = grads(
                            fn, q, k, v, bias, w, H, dropout_rate=rate, seed=17)
    # bf16 B3 both ways; bf16 B1, B5 both ways and B3's forward
    for S in (13, 76, 140, 160, 161, 612):
        q, k, v, bias, w = inputs(8, S, 12, 64, torch.bfloat16, True, S)
        for rate in (0.0, 0.1):
            kw = dict(dropout_rate=rate, seed=19)
            res[f"bf16 B3hm S{S} r{rate}"] = grads(hm_train, q, k, v, bias, w, 12, **kw)
            for name in ("B1", "B5"):
                res[f"bf16 {name} S{S} r{rate}"] = grads(train[name], q, k, v, bias, w, 12,
                                                         **kw)
            with torch.no_grad():
                for name in ("B1", "B5", "B3"):
                    res[f"bf16 {name} fwd S{S} r{rate}"] = train[name](
                        q, k, v, bias, 12, **kw).cpu()
    # B4 both dtypes, all-keys and key-blocked
    for S in (13, 76, 159):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(dev).manual_seed(S)
            D, H = 768, 12
            x = torch.randn(4, S, D, device=dev, generator=g).to(dtype)
            ws = [(torch.randn(D, D, device=dev, generator=g) / D ** 0.5).to(dtype)
                  for _ in range(4)]
            bs = [torch.randn(D, device=dev, generator=g) * 0.1 for _ in range(4)]
            _, _, _, bias, _ = inputs(4, S, H, 64, dtype, False, S)
            dy = torch.randn(4, S, D, device=dev, generator=g).to(dtype)
            for rate in (0.0, 0.1):
                args = [x] + [t for pair in zip(ws, bs) for t in pair] + [bias]
                ins = [a.detach().clone().requires_grad_() for a in args]
                y = TB.fused_attention_block(*ins, H, dropout_rate=rate, seed=23)
                gs = torch.autograd.grad(y, ins, dy)
                res[f"B4 {dtype} S{S} r{rate}"] = [y.detach().cpu()] + [t.cpu() for t in gs]
    # K1, B2 both dtypes, all-keys and (fp32) key-blocked
    for S in (13, 76, 140, 418, 612):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias, _ = inputs(8, S, 12, 64, dtype, True, S + 1)
            with torch.no_grad():
                res[f"K1 {dtype} S{S}"] = TA.fused_attention_flat(q, k, v, bias, 12).cpu()
                res[f"B2 {dtype} S{S}"] = TA.fused_attention(q, k, v, bias, 12).cpu()
    # K2 and B6; this file runs as a script, so its directory is on sys.path
    # and gives this checkout's measure.py, whatever ROOT holds
    from measure import c4_rois
    from clg_vqa_tpu_torch.ops import bank_gather as TG
    from clg_vqa_tpu_torch.ops import roi_pool as RP
    g = torch.Generator(dev).manual_seed(29)
    for shape, B, dtype in (((400, 36, 2048), 1024, torch.float32),
                            ((400, 36, 2048), 128, torch.bfloat16),
                            ((400, 100, 2048), 1024, torch.float32),
                            ((1000, 4), 12293, torch.float32)):
        bank = torch.randn(*shape, device=dev, generator=g).to(dtype)
        idx = torch.randint(0, shape[0], (B,), device=dev, generator=g, dtype=torch.int32)
        res[f"K2 {dtype} {list(shape)} x{B}"] = TG.rows_gather(bank, idx).cpu()
    feat = torch.randn(50, 84, 1024, device=dev, generator=g)
    u = torch.rand(50, 84, 1024, device=dev, generator=g)
    odd = feat.masked_fill(u < 0.01, float("nan")).masked_fill(u > 0.99, float("inf"))
    rois = c4_rois(g)
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            for name, m in (("randn", feat), ("nan/inf", odd)):
                res[f"B6 {dtype} {name}"] = RP.roi_pool_nhwc(
                    m.to(dtype), rois, output_size=(14, 14), spatial_scale=1 / 16,
                    max_bin=8).cpu()
    torch.save(res, out)
    print(f"{root}: {len(res)} cases")


def compare(a, b):
    A, B = torch.load(a), torch.load(b)
    assert A.keys() == B.keys()
    bad = []
    for key in A:
        x, y = A[key], B[key]
        x = x if isinstance(x, list) else [x]
        y = y if isinstance(y, list) else [y]
        if not all(torch.equal(s, t) for s, t in zip(x, y)):
            bad.append(key)
    print(f"{len(A) - len(bad)} of {len(A)} cases equal bit for bit")
    for key in bad:
        print("DIFFERS:", key)
    return 1 if bad else 0


def main(argv) -> int:
    if argv[0] == "run":
        run(argv[1], argv[2])
        return 0
    return compare(argv[1], argv[2])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
