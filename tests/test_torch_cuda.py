"""Card-only tests of the port's CUDA kernels: each against its plain PyTorch
version on the card. They skip where there is no NVIDIA GPU. The file
imports no JAX, so the machine with the card runs it without the JAX suite:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from clg_vqa_tpu_torch.models import layers as TL
from clg_vqa_tpu_torch.ops import attention as TA
from clg_vqa_tpu_torch.ops import bank_gather as TG
from clg_vqa_tpu_torch.ops import block_attention as TB


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _attention_inputs(dev, B, S, H, hd, dtype):
    g = torch.Generator(dev).manual_seed(S)
    q, k, v = (torch.randn(B, S, H * hd, device=dev, generator=g).to(dtype)
               for _ in range(3))
    mask = torch.ones(B, S, device=dev)
    mask[1, -(S // 3):] = 0
    return q, k, v, ((1.0 - mask) * -10000.0)[:, None, None, :]


@pytest.mark.cuda
@pytest.mark.parametrize("S", [13, 76, 140])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_attention_kernel_matches_plain(cuda, S, dtype):
    """fp32: atol 1e-5 (summation order only); bf16: one bf16 ulp of the
    largest output (both round the same fp32 values once)."""
    q, k, v, bias = _attention_inputs(cuda, 16, S, 12, 64, dtype)
    before = TA.fused_attention_flat.launches
    got = TA.fused_attention_flat(q, k, v, bias, 12)
    torch.cuda.synchronize()
    assert TA.fused_attention_flat.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = TA.fused_attention_flat_plain(q, k, v, bias, 12)
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert err <= tol


@pytest.mark.cuda
def test_flat_attention_kernel_rejects_unsupported_head_dim(cuda):
    q, k, v, bias = _attention_inputs(cuda, 2, 9, 4, 16, torch.float32)
    with pytest.raises(ValueError, match="hd"):
        TA.fused_attention_flat(q, k, v, bias, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_rows_gather_kernel_bit_exact(cuda, dtype):
    g = torch.Generator(cuda).manual_seed(0)
    bank = (torch.randn(50, 36, 64, device=cuda, generator=g) * 100).to(dtype)
    idx = torch.randint(0, 50, (97,), device=cuda, generator=g,
                        dtype=torch.int32)
    before = TG.rows_gather.launches
    got = TG.rows_gather(bank, idx)
    torch.cuda.synchronize()
    assert TG.rows_gather.launches == before + 1
    assert torch.equal(got, TG.rows_gather_plain(bank, idx))


@pytest.mark.cuda
def test_rows_gather_kernel_rejects_unaligned_rows(cuda):
    bank = torch.zeros(4, 3, device=cuda)            # 12-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        TG.rows_gather(bank, torch.tensor([1], dtype=torch.int32, device=cuda))


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _train_grads(fn, q, k, v, bias, w, **kw):
    q, k, v, bias = (t.detach().clone().requires_grad_() for t in (q, k, v, bias))
    out = fn(q, k, v, bias, 12, **kw)
    (out.float() * w).sum().backward()
    return out.detach(), q.grad, k.grad, v.grad, bias.grad


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("S", [13, 76, 140])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_train_kernels_match_plain(cuda, S, dtype, rate):
    """B1 forward and backward against autograd of the plain version, same
    seed. Forward: atol 1e-5 (fp32) or one bf16 ulp of the largest output;
    dq/dk/dv: 2e-4 * max|grad| (fp32) or two bf16 ulps of the largest grad;
    dbias: 1e-4 * max|dbias|. Both sides compute in fp32 from the same
    values and differ in summation order only."""
    q, k, v, bias = _attention_inputs(cuda, 8, S, 12, 64, dtype)
    w = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    kw = dict(dropout_rate=rate, seed=1234)
    f0, b0 = TA.fused_attention_train_flat.launches, TA.fused_attention_train_flat.backward_launches
    got = _train_grads(TA.fused_attention_train_flat, q, k, v, bias, w, **kw)
    torch.cuda.synchronize()
    assert TA.fused_attention_train_flat.launches == f0 + 1
    assert TA.fused_attention_train_flat.backward_launches == b0 + 1
    want = _train_grads(TA.fused_attention_train_flat_plain, q, k, v, bias, w, **kw)
    assert got[0].dtype == dtype and got[1].dtype == dtype
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        scale = want[i].float().abs().max().item()
        if dtype == torch.float32:
            tol = 1e-5 if i == 0 else 2e-4 * scale
        else:
            tol = _bf16_ulp(scale) * (1 if i == 0 else 2)
        err = (got[i].float() - want[i].float()).abs().max().item()
        assert err <= tol, (name, err, tol)
    db_err = (got[4] - want[4]).abs().max().item()
    assert db_err <= 1e-4 * want[4].abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("S", [13, 76, 140])
def test_flat_train_kernel_mask_is_the_plain_mask(cuda, S):
    """The kernel's realized keep bits equal dropout_keep_mask on the card
    and on the CPU; another seed gives another mask."""
    t = TA.keep_threshold(0.1)
    got = TA.realized_keep_mask(99, 4, 12, S, 64, 0.1, cuda)
    assert torch.equal(got, TA.dropout_keep_mask(99, 4, 12, S, t, cuda))
    assert torch.equal(got.cpu(), TA.dropout_keep_mask(99, 4, 12, S, t))
    assert not torch.equal(got, TA.realized_keep_mask(100, 4, 12, S, 64, 0.1, cuda))


@pytest.mark.cuda
def test_flat_train_kernels_are_deterministic(cuda):
    q, k, v, bias = _attention_inputs(cuda, 8, 76, 12, 64, torch.bfloat16)
    w = torch.randn(q.shape, device=cuda)
    a = _train_grads(TA.fused_attention_train_flat, q, k, v, bias, w,
                     dropout_rate=0.1, seed=5)
    b = _train_grads(TA.fused_attention_train_flat, q, k, v, bias, w,
                     dropout_rate=0.1, seed=5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_bf16_linear_function_on_cuda_matches_cpu(cuda):
    """The bf16 linear and its backward on the card (cuBLAS fp32-output
    products) against the same Function on the CPU (upcast operands): one
    bf16 ulp per element of y, dx and dW; db within rtol 1e-6."""
    r = np.random.RandomState(0)
    x = torch.from_numpy(r.randn(64, 96).astype(np.float32))
    w = torch.from_numpy((r.randn(48, 96) * 0.1).astype(np.float32))
    b = torch.from_numpy(r.randn(48).astype(np.float32))
    g = torch.from_numpy(r.randn(64, 48).astype(np.float32)).bfloat16()

    def run(dev):
        xx, ww, bb = (t.to(dev).requires_grad_() for t in (x, w, b))
        y = TL.linear(xx, ww, bb, torch.bfloat16)
        y.backward(g.to(dev))
        return [t.detach().float().cpu() for t in (y, xx.grad, ww.grad, bb.grad)]

    got, want = run(cuda), run("cpu")
    for a, e in zip(got[:3], want[:3]):
        ulp = 2.0 ** (torch.floor(torch.log2(e.abs() + 1e-30)) - 7)
        assert torch.all((a - e).abs() <= ulp)
    torch.testing.assert_close(got[3], want[3], rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("S", [13, 76, 140])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_smajor_train_kernels_match_plain(cuda, S, dtype, rate):
    """B5 forward and backward against autograd of its plain version, same
    seed, with B1's tolerances (test_flat_train_kernels_match_plain); the
    entry makes its eight layout copies."""
    q, k, v, bias = _attention_inputs(cuda, 8, S, 12, 64, dtype)
    w = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    kw = dict(dropout_rate=rate, seed=1234)
    f0 = TA.fused_attention_train_smajor.launches
    b0 = TA.fused_attention_train_smajor.backward_launches
    c0 = TA.fused_attention_train_smajor.layout_copies
    got = _train_grads(TA.fused_attention_train_smajor, q, k, v, bias, w, **kw)
    torch.cuda.synchronize()
    assert TA.fused_attention_train_smajor.launches == f0 + 1
    assert TA.fused_attention_train_smajor.backward_launches == b0 + 1
    assert TA.fused_attention_train_smajor.layout_copies == c0 + 8
    want = _train_grads(TA.fused_attention_train_smajor_plain, q, k, v, bias,
                        w, **kw)
    assert got[0].dtype == dtype and got[1].dtype == dtype
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        scale = want[i].float().abs().max().item()
        if dtype == torch.float32:
            tol = 1e-5 if i == 0 else 2e-4 * scale
        else:
            tol = _bf16_ulp(scale) * (1 if i == 0 else 2)
        err = (got[i].float() - want[i].float()).abs().max().item()
        assert err <= tol, (name, err, tol)
    db_err = (got[4] - want[4]).abs().max().item()
    assert db_err <= 1e-4 * want[4].abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_smajor_kernels_equal_flat_kernels_bit_for_bit(cuda, dtype):
    """B5 and B1 run one device code on two layouts and key dropout alike:
    output and every gradient equal bit for bit."""
    q, k, v, bias = _attention_inputs(cuda, 16, 76, 12, 64, dtype)
    w = torch.randn(q.shape, device=cuda)
    kw = dict(dropout_rate=0.1, seed=77)
    a = _train_grads(TA.fused_attention_train_smajor, q, k, v, bias, w, **kw)
    b = _train_grads(TA.fused_attention_train_flat, q, k, v, bias, w, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_smajor_eval_twin_matches_plain_and_refuses_grad_mode(cuda):
    q, k, v, bias = _attention_inputs(cuda, 8, 76, 12, 64, torch.bfloat16)
    before = TA.fused_attention_smajor.launches
    with torch.no_grad():
        got = TA.fused_attention_smajor(q, k, v, bias, 12)
    torch.cuda.synchronize()
    assert TA.fused_attention_smajor.launches == before + 1
    want = TA.fused_attention_smajor_plain(q, k, v, bias, 12)
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= _bf16_ulp(scale)
    with pytest.raises(RuntimeError, match="no backward"):
        TA.fused_attention_smajor(q.requires_grad_(), k, v, bias, 12)
    with pytest.raises(ValueError, match="batch"):
        TA.fused_attention_smajor(q[:3].detach(), k[:3], v[:3], bias[:3], 12)


# ---------------------------------------------------------------------------
# B4: the whole-block training attention ("proj")
# ---------------------------------------------------------------------------

BLOCK_GRADS = ("x", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "bias")


def _block_inputs(dev, B, S, H, hd, dtype, seed=0):
    """x [B, S, H*hd], four [out, in] weights in dtype, four fp32 biases,
    a key bias with padded keys, and a cotangent weighting."""
    g = torch.Generator(dev).manual_seed(seed)
    D = H * hd
    x = torch.randn(B, S, D, device=dev, generator=g).to(dtype)
    ws = [(torch.randn(D, D, device=dev, generator=g) / D ** 0.5).to(dtype)
          for _ in range(4)]
    bs = [torch.randn(D, device=dev, generator=g) * 0.1 for _ in range(4)]
    mask = torch.ones(B, S, device=dev)
    mask[1, -(S // 3):] = 0
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :]
    w = torch.randn(B, S, D, device=dev, generator=g)
    args = [x]
    for wi, bi in zip(ws, bs):
        args += [wi, bi]
    return args + [bias], w


def _block_grads(fn, args, w, H, **kw):
    """y and the gradients of sum(y * w) in the order of BLOCK_GRADS."""
    ins = [a.detach().clone().requires_grad_() for a in args]
    y = fn(*ins, H, **kw)
    (y.float() * w).sum().backward()
    return y.detach(), [a.grad for a in ins]


def _grad_scales(want):
    """Each gradient's scale: its largest magnitude, except the key bias's,
    whose gradient is zero in exact arithmetic (softmax does not see a shift
    shared by all keys) and is held at the query bias's scale."""
    scales = [g.float().abs().max().item() for g in want]
    scales[BLOCK_GRADS.index("bk")] = scales[BLOCK_GRADS.index("bq")]
    return scales


def _assert_block_close(got, want, dtype):
    """fp32: y within 2e-5 of max|y|, every gradient within 1e-4 of its
    scale (summation order only). bf16: y within two bf16 ulps of max|y|,
    every gradient within 1e-2 of its scale (a rounded q, k, v, ctx or core
    gradient may flip by one bf16 ulp, 2^-8 of its size)."""
    (y, gs), (wy, wgs) = got, want
    assert y.dtype == wy.dtype == dtype
    ymax = wy.float().abs().max().item()
    ytol = 2e-5 * ymax if dtype == torch.float32 else 2 * _bf16_ulp(ymax)
    assert (y.float() - wy.float()).abs().max().item() <= ytol
    rel = 1e-4 if dtype == torch.float32 else 1e-2
    for a, b, scale, name in zip(gs, wgs, _grad_scales(wgs), BLOCK_GRADS):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= rel * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("S", [13, 76, 140])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_kernels_match_plain(cuda, S, dtype, rate):
    """B4 forward and backward (8 x S x 768, 12 heads of 64) against the
    plain version on the same inputs and seed, one launch of each entry."""
    args, w = _block_inputs(cuda, 8, S, 12, 64, dtype)
    kw = dict(dropout_rate=rate, seed=1234)
    f0, b0 = TB.fused_attention_block.launches, TB.fused_attention_block.backward_launches
    got = _block_grads(TB.fused_attention_block, args, w, 12, **kw)
    torch.cuda.synchronize()
    assert TB.fused_attention_block.launches == f0 + 1
    assert TB.fused_attention_block.backward_launches == b0 + 1
    want = _block_grads(TB.fused_attention_block_plain, args, w, 12, **kw)
    _assert_block_close(got, want, dtype)


@pytest.mark.cuda
def test_block_kernels_full_width_bf16_and_deterministic(cuda):
    """At the fine-tune step's shapes (128 x 76 x 768, bf16, rate 0.1) B4
    matches its plain version, and two runs on one seed agree bit for bit
    (no float atomics in any reduction)."""
    args, w = _block_inputs(cuda, 128, 76, 12, 64, torch.bfloat16, seed=3)
    kw = dict(dropout_rate=0.1, seed=99)
    a = _block_grads(TB.fused_attention_block, args, w, 12, **kw)
    b = _block_grads(TB.fused_attention_block, args, w, 12, **kw)
    assert torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    _assert_block_close(a, _block_grads(TB.fused_attention_block_plain, args,
                                        w, 12, **kw), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [13, 76, 140])
def test_block_kernel_mask_is_b1s_mask(cuda, S):
    """B4's realized keep bits equal B1's kernel's and dropout_keep_mask's on
    one seed: "proj" and "flat" drop the same attention probabilities."""
    got = TB.realized_block_keep_mask(42, 4, 12, S, 64, 0.1, cuda)
    assert torch.equal(got, TA.realized_keep_mask(42, 4, 12, S, 64, 0.1, cuda))
    assert torch.equal(got.cpu(), TA.dropout_keep_mask(42, 4, 12, S,
                                                       TA.keep_threshold(0.1)))


@pytest.mark.cuda
def test_block_kernel_rejects_unsupported_operands(cuda):
    args, _ = _block_inputs(cuda, 2, 9, 4, 16, torch.float32)
    with pytest.raises(ValueError, match="hd"):
        TB.fused_attention_block(*args, 4)
    args, _ = _block_inputs(cuda, 2, 9, 2, 32, torch.float64)
    with pytest.raises(ValueError, match="fp32/bf16"):
        TB.fused_attention_block(*args, 2)


PROPERTIES = ("parity_rate0", "determinism", "seed_sensitivity", "keep_rate",
              "kept_entries", "mask_agreement", "dropout_vjp")


@pytest.mark.cuda
@pytest.mark.parametrize("prop", PROPERTIES)
def test_block_on_chip_properties(cuda, prop):
    """The seven on-chip properties tools/check_attention_tpu.py checks for
    the TPU's attention kernels (clg_vqa_tpu/ops/attention.py:53-56), held
    for B4 on the card:
    parity_rate0: fp32 at rate 0 against the unfused block (linears and the
        plain attention of SelfAttention), y and every gradient;
    determinism: one seed gives bit-equal y and gradients twice;
    seed_sensitivity: another seed gives another y, and dropout changes y;
    keep_rate: the realized keep fraction is t/256;
    kept_entries: kept probabilities are p * 256/t, exactly at rate 0.5 in
        bf16 (the rescale by 2 commutes with bf16 rounding);
    mask_agreement: with bv = bo = 0 the block is linear in Wv under a fixed
        mask, so loss == <dWv, Wv> (the forward and the backward realize one
        mask), far below what a mismatched seed gives;
    dropout_vjp: fp32 gradients at rate 0.3 against the plain version in
        fp64 on the CPU, whose mask is the realized one."""
    H, hd = 12, 64
    D = H * hd
    if prop == "parity_rate0":
        args, w = _block_inputs(cuda, 8, 140, H, hd, torch.float32, seed=5)
        got = _block_grads(TB.fused_attention_block, args, w, H, seed=1)
        attn = TL.SelfAttention(D, H, device=cuda)
        with torch.no_grad():
            for i, n in enumerate("qkvo"):
                getattr(attn, n).weight.copy_(args[1 + 2 * i])
                getattr(attn, n).bias.copy_(args[2 + 2 * i])
        x = args[0].clone().requires_grad_()
        bias = args[-1].clone().requires_grad_()
        y = attn(x, bias)
        (y * w).sum().backward()
        want = (y.detach(), [x.grad] + [t for n in "qkvo" for t in (
            getattr(attn, n).weight.grad, getattr(attn, n).bias.grad)] + [bias.grad])
        _assert_block_close(got, want, torch.float32)
        return
    if prop in ("determinism", "seed_sensitivity"):
        args, w = _block_inputs(cuda, 8, 76, H, hd, torch.bfloat16, seed=6)
        a = _block_grads(TB.fused_attention_block, args, w, H, dropout_rate=0.5, seed=7)
        if prop == "determinism":
            b = _block_grads(TB.fused_attention_block, args, w, H, dropout_rate=0.5, seed=7)
            assert torch.equal(a[0], b[0])
            assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
            return
        c = _block_grads(TB.fused_attention_block, args, w, H, dropout_rate=0.5, seed=8)
        d = _block_grads(TB.fused_attention_block, args, w, H, seed=7)
        assert (a[0] - c[0]).abs().max() > 1e-2 and (a[0] - d[0]).abs().max() > 1e-2
        assert (a[1][0] - c[1][0]).abs().max() > 1e-2
        return
    if prop == "keep_rate":
        for rate in (0.1, 0.5):
            t = TA.keep_threshold(rate)
            frac = TB.realized_block_keep_mask(3, 8, H, 76, hd, rate, cuda).float().mean().item()
            assert abs(frac - t / 256) < 0.005, (rate, frac)
        return
    if prop == "kept_entries":
        # x one-hot on column h*hd + j in every head, Wv = Wo = I: y holds the
        # probabilities; random Wq, Wk make them non-uniform
        B, S = 4, 64
        g = torch.Generator(cuda).manual_seed(9)
        x = torch.zeros(B, S, H, hd, device=cuda)
        x[:, torch.arange(S), :, torch.arange(S)] = 1.0
        x = x.reshape(B, S, D).bfloat16()
        wq, wk = (torch.randn(D, D, device=cuda, generator=g).bfloat16()
                  for _ in range(2))
        eye = torch.eye(D, device=cuda).bfloat16()
        zb = torch.zeros(D, device=cuda)
        bias = torch.zeros(B, 1, 1, S, device=cuda)

        def probs(**kw):
            with torch.no_grad():
                y = TB.fused_attention_block(x, wq, zb, wk, zb, eye, zb, eye, zb,
                                             bias, H, **kw)
            return y.view(B, S, H, hd).float()

        p0, pd = probs(seed=4), probs(dropout_rate=0.5, seed=4)
        kept = pd != 0
        assert torch.equal(pd[kept], 2 * p0[kept])
        keep = TA.dropout_keep_mask(4, B, H, S, 128, cuda).transpose(1, 2)
        assert torch.equal(kept, keep)
        return
    if prop == "mask_agreement":
        args, w = _block_inputs(cuda, 8, 76, H, hd, torch.float32, seed=10)
        args[6] = torch.zeros_like(args[6])          # bv
        args[8] = torch.zeros_like(args[8])          # bo

        def loss_and_dwv(seed):
            ins = [a.detach().clone().requires_grad_() for a in args]
            y = TB.fused_attention_block(*ins, H, dropout_rate=0.3, seed=seed)
            loss = (y * w).sum()
            loss.backward()
            return loss.item(), ins[5].grad

        lv, dwv = loss_and_dwv(7)
        inner = (dwv.double() * args[5].double()).sum().item()
        signal = abs(lv - loss_and_dwv(8)[0])
        assert abs(inner - lv) < signal / 100, (inner, lv, signal)
        return
    assert prop == "dropout_vjp"
    args, w = _block_inputs(cuda, 4, 40, H, hd, torch.float32, seed=11)
    kw = dict(dropout_rate=0.3, seed=12)
    assert torch.equal(TB.realized_block_keep_mask(12, 4, H, 40, hd, 0.3, cuda).cpu(),
                       TA.dropout_keep_mask(12, 4, H, 40, TA.keep_threshold(0.3)))
    got = _block_grads(TB.fused_attention_block, args, w, H, **kw)
    want = _block_grads(TB.fused_attention_block_plain,
                        [a.double().cpu() for a in args], w.double().cpu(), H, **kw)
    for a, b, scale, name in zip(got[1], want[1], _grad_scales(want[1]), BLOCK_GRADS):
        err = (a.double().cpu() - b).abs().max().item()
        assert err <= 1e-4 * scale, (name, err, scale)


# ---------------------------------------------------------------------------
# B2 / B3: the head-blocked attention (M3P's fused_attn=True and "hm")
# ---------------------------------------------------------------------------

def _neg_inf_inputs(dev, B, S, H, hd, dtype, seed=0):
    """q/k/v [B, S, H*hd] and M3P's key bias: -inf on the trailing third of
    sample 1's keys, 0 elsewhere."""
    q, k, v, _ = _attention_inputs(dev, B, S, H, hd, dtype)
    valid = torch.ones(B, S, dtype=torch.bool, device=dev)
    valid[1, -(S // 3):] = False
    bias = torch.zeros(B, 1, 1, S, device=dev).masked_fill(
        ~valid[:, None, None, :], float("-inf"))
    return q, k, v, bias


def _hm_train(q, k, v, bias, H, **kw):
    """B3's head-major entry on [B, S, H*hd] operands split outside it."""
    B, S, D = q.shape
    split = [t.view(B, S, H, D // H).transpose(1, 2).contiguous() for t in (q, k, v)]
    out = TA.fused_attention_train_hm(*split, bias, **kw)
    return out.transpose(1, 2).reshape(B, S, D)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [13, 76, 140])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_eval_kernel_matches_plain(cuda, S, dtype):
    """B2 against its plain version under the -inf key bias: fp32 atol 1e-5,
    bf16 one bf16 ulp of the largest output; finite; one launch."""
    q, k, v, bias = _neg_inf_inputs(cuda, 16, S, 12, 64, dtype)
    before = TA.fused_attention.launches
    with torch.no_grad():
        got = TA.fused_attention(q, k, v, bias, 12)
    torch.cuda.synchronize()
    assert TA.fused_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    want = TA.fused_attention_flat_plain(q, k, v, bias, 12)
    scale = want.float().abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else _bf16_ulp(scale)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_blocked_eval_kernel_refuses_grad_mode_and_bad_head_dim(cuda):
    q, k, v, bias = _neg_inf_inputs(cuda, 4, 9, 12, 64, torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        TA.fused_attention(q.requires_grad_(), k, v, bias, 12)
    q, k, v, bias = _neg_inf_inputs(cuda, 4, 9, 4, 16, torch.float32)
    with pytest.raises(ValueError, match="hd"):
        TA.fused_attention(q, k, v, bias, 4)
    with pytest.raises(ValueError, match="hd"):
        TA.fused_attention_train(q, k, v, bias, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("S", [13, 76, 140])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_train_kernels_match_plain_and_b1(cuda, S, dtype, rate):
    """B3 through both entries, forward and backward, under the -inf key
    bias: against autograd of its plain version with B1's tolerances
    (test_flat_train_kernels_match_plain), and equal to B1's kernels bit for
    bit (one device code, one keep mask); one launch of each kernel per
    entry call."""
    q, k, v, bias = _neg_inf_inputs(cuda, 8, S, 12, 64, dtype)
    w = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    kw = dict(dropout_rate=rate, seed=4321)
    flat = _train_grads(TA.fused_attention_train_flat, q, k, v, bias, w, **kw)
    want = _train_grads(TA.fused_attention_train_flat_plain, q, k, v, bias, w, **kw)
    for fn in (TA.fused_attention_train, _hm_train):
        f0 = TA.fused_attention_train.launches
        b0 = TA.fused_attention_train.backward_launches
        got = _train_grads(fn, q, k, v, bias, w, **kw)
        torch.cuda.synchronize()
        assert TA.fused_attention_train.launches == f0 + 1
        assert TA.fused_attention_train.backward_launches == b0 + 1
        assert all(torch.equal(a, b) for a, b in zip(got, flat))
        assert all(torch.isfinite(t).all() for t in got)
        for i in range(4):
            scale = want[i].float().abs().max().item()
            if dtype == torch.float32:
                tol = 1e-5 if i == 0 else 2e-4 * scale
            else:
                tol = _bf16_ulp(scale) * (1 if i == 0 else 2)
            assert (got[i].float() - want[i].float()).abs().max().item() <= tol
        assert (got[4] - want[4]).abs().max().item() <= 1e-4 * want[4].abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("prop", PROPERTIES)
def test_blocked_on_chip_properties(cuda, prop):
    """The seven on-chip properties tools/check_attention_tpu.py checks for
    the TPU's attention kernels (clg_vqa_tpu/ops/attention.py:53-56), held
    for B3 on the card:
    parity_rate0: fp32 at rate 0 against the plain version in fp64 on the
        CPU, output and every gradient;
    determinism: one seed gives bit-equal output and gradients twice;
    seed_sensitivity: another seed gives another output, and dropout changes
        it;
    keep_rate: the realized keep fraction is t/256, the same mask in a batch
        of 3 as in a batch of 8;
    kept_entries: with q = k = 0 every probability is 1/S, and a kept one
        comes out as exactly 2/S at rate 0.5 in bf16 (the rescale by 2
        commutes with bf16 rounding);
    mask_agreement: the output is linear in v under a fixed mask, so
        <dv, v> == loss (the forward and the backward realize one mask), far
        below what a mismatched seed gives;
    dropout_vjp: fp32 gradients at rate 0.3 against the plain version in
        fp64 on the CPU, whose mask is the realized one."""
    H, hd = 12, 64
    if prop in ("parity_rate0", "dropout_vjp"):
        rate = 0.0 if prop == "parity_rate0" else 0.3
        q, k, v, bias = _neg_inf_inputs(cuda, 4, 40, H, hd, torch.float32)
        w = torch.randn(q.shape, device=cuda)
        kw = dict(dropout_rate=rate, seed=12)
        got = _train_grads(TA.fused_attention_train, q, k, v, bias, w, **kw)
        want = _train_grads(TA.fused_attention_train_flat_plain,
                            *(t.double().cpu() for t in (q, k, v, bias, w)), **kw)
        for a, b in zip(got, want):
            scale = b.abs().max().item()
            assert (a.double().cpu() - b).abs().max().item() <= 1e-4 * max(scale, 1e-6)
        return
    if prop in ("determinism", "seed_sensitivity"):
        q, k, v, bias = _neg_inf_inputs(cuda, 8, 140, H, hd, torch.bfloat16)
        w = torch.randn(q.shape, device=cuda)
        a = _train_grads(_hm_train, q, k, v, bias, w, dropout_rate=0.5, seed=7)
        if prop == "determinism":
            b = _train_grads(_hm_train, q, k, v, bias, w, dropout_rate=0.5, seed=7)
            assert all(torch.equal(x, y) for x, y in zip(a, b))
            return
        c = _train_grads(_hm_train, q, k, v, bias, w, dropout_rate=0.5, seed=8)
        d = _train_grads(_hm_train, q, k, v, bias, w, seed=7)
        assert (a[0] - c[0]).float().abs().max() > 1e-2
        assert (a[0] - d[0]).float().abs().max() > 1e-2
        assert (a[1] - c[1]).float().abs().max() > 1e-2
        return
    if prop == "keep_rate":
        for rate in (0.1, 0.5):
            t = TA.keep_threshold(rate)
            m = TA.realized_keep_mask(3, 8, H, 140, hd, rate, cuda,
                                      train=TA.fused_attention_train)
            assert abs(m.float().mean().item() - t / 256) < 0.005, rate
            assert torch.equal(m[:3], TA.realized_keep_mask(
                3, 3, H, 140, hd, rate, cuda, train=TA.fused_attention_train))
            assert torch.equal(m.cpu(), TA.dropout_keep_mask(3, 8, H, 140, t))
        return
    if prop == "kept_entries":
        B, S = 4, 64
        z = torch.zeros(B, S, H * hd, device=cuda, dtype=torch.bfloat16)
        v = torch.zeros(B, S, H, hd, device=cuda)
        v[:, torch.arange(S), :, torch.arange(S)] = 1.0
        with torch.no_grad():
            o = TA.fused_attention_train(z, z, v.reshape(B, S, H * hd).bfloat16(),
                                         torch.zeros(B, 1, 1, S, device=cuda), H,
                                         dropout_rate=0.5, seed=4)
        o = o.view(B, S, H, hd).float()
        kept = o != 0
        assert torch.all(o[kept] == 2.0 / S)
        assert torch.equal(kept, TA.dropout_keep_mask(4, B, H, S, 128, cuda)
                           .transpose(1, 2))
        return
    assert prop == "mask_agreement"
    q, k, v, bias = _neg_inf_inputs(cuda, 8, 76, H, hd, torch.float32)
    w = torch.randn(q.shape, device=cuda)

    def loss_and_dv(seed):
        vv = v.detach().clone().requires_grad_()
        out = TA.fused_attention_train(q, k, vv, bias, H, dropout_rate=0.3,
                                       seed=seed)
        loss = (out * w).sum()
        loss.backward()
        return loss.item(), vv.grad

    lv, dv = loss_and_dv(7)
    inner = (dv.double() * v.double()).sum().item()
    signal = abs(lv - loss_and_dv(8)[0])
    assert abs(inner - lv) < signal / 100, (inner, lv, signal)


# ---------------------------------------------------------------------------
# The key-blocked variant: S past the all-keys kernels' shared memory
# (training kernels from S = 159 at hd 64, K1 from 418, B2 from 412)
# ---------------------------------------------------------------------------

LONG_S = [159, 200, 256, 612]


def _assert_train_close(got, want, dtype):
    """B1's tolerances (test_flat_train_kernels_match_plain)."""
    for i in range(4):
        scale = want[i].float().abs().max().item()
        if dtype == torch.float32:
            tol = 1e-5 if i == 0 else 2e-4 * scale
        else:
            tol = _bf16_ulp(scale) * (1 if i == 0 else 2)
        err = (got[i].float() - want[i].float()).abs().max().item()
        assert err <= tol, (i, err, tol)
    assert (got[4] - want[4]).abs().max().item() <= 1e-4 * want[4].abs().max().item()
    assert all(torch.isfinite(t).all() for t in got)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("S", LONG_S)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_key_blocked_train_kernels_match_plain(cuda, S, dtype, rate):
    """B1 past its all-keys limit against autograd of the plain version with
    B1's tolerances; B5 and B3 (both entries) equal to it bit for bit; one
    launch of each kernel per call."""
    q, k, v, bias = _neg_inf_inputs(cuda, 8, S, 12, 64, dtype)
    w = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    kw = dict(dropout_rate=rate, seed=2468)
    f0, b0 = TA.fused_attention_train_flat.launches, TA.fused_attention_train_flat.backward_launches
    flat = _train_grads(TA.fused_attention_train_flat, q, k, v, bias, w, **kw)
    torch.cuda.synchronize()
    assert TA.fused_attention_train_flat.launches == f0 + 1
    assert TA.fused_attention_train_flat.backward_launches == b0 + 1
    _assert_train_close(flat, _train_grads(TA.fused_attention_train_flat_plain, q, k,
                                           v, bias, w, **kw), dtype)
    for fn in (TA.fused_attention_train_smajor, TA.fused_attention_train, _hm_train):
        got = _train_grads(fn, q, k, v, bias, w, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, flat)), fn


@pytest.mark.cuda
@pytest.mark.parametrize("S", LONG_S)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_key_blocked_block_kernels_match_plain(cuda, S, dtype):
    """B4's core past its all-keys limit: y and every gradient against the
    plain version (test_block_kernels_match_plain's tolerances), rate 0.1."""
    args, w = _block_inputs(cuda, 2, S, 12, 64, dtype, seed=S)
    kw = dict(dropout_rate=0.1, seed=97)
    got = _block_grads(TB.fused_attention_block, args, w, 12, **kw)
    _assert_block_close(got, _block_grads(TB.fused_attention_block_plain, args, w,
                                          12, **kw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 128])
def test_key_blocked_train_kernels_take_every_head_dim(cuda, hd):
    q, k, v, bias = _neg_inf_inputs(cuda, 2, 612, 4, hd, torch.float32)
    w = torch.randn(q.shape, device=cuda)

    def grads(fn):
        ins = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
        out = fn(*ins, 4, dropout_rate=0.1, seed=3)
        (out * w).sum().backward()
        return [out.detach()] + [t.grad for t in ins]

    _assert_train_close(grads(TA.fused_attention_train_flat),
                        grads(TA.fused_attention_train_flat_plain), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [159, 418, 612])
def test_key_blocked_keep_masks_are_the_plain_mask(cuda, S):
    """The key-blocked forward's keep bits equal dropout_keep_mask (B1 at
    S 418 and 612 runs it; at 159 the all-keys forward), and B4's equal
    B1's; the backward replays them (test_..._match_plain's gradients)."""
    t = TA.keep_threshold(0.1)
    got = TA.realized_keep_mask(31, 2, 12, S, 64, 0.1, cuda)
    assert torch.equal(got, TA.dropout_keep_mask(31, 2, 12, S, t, cuda))
    assert torch.equal(TB.realized_block_keep_mask(31, 2, 12, S, 64, 0.1, cuda), got)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [418, 612])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_key_blocked_eval_kernels_match_plain(cuda, S, dtype):
    """K1 and B2 past their all-keys limits, under the -inf key bias: fp32
    atol 1e-5, bf16 one bf16 ulp of the largest output; one launch each."""
    q, k, v, bias = _neg_inf_inputs(cuda, 4, S, 12, 64, dtype)
    want = TA.fused_attention_flat_plain(q, k, v, bias, 12)
    scale = want.float().abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else _bf16_ulp(scale)
    for fn in (TA.fused_attention_flat, TA.fused_attention):
        before = fn.launches
        with torch.no_grad():
            got = fn(q, k, v, bias, 12)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert torch.isfinite(got).all()
        assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_key_blocked_kernels_are_deterministic(cuda):
    q, k, v, bias = _neg_inf_inputs(cuda, 8, 612, 12, 64, torch.bfloat16)
    w = torch.randn(q.shape, device=cuda)
    a = _train_grads(TA.fused_attention_train_flat, q, k, v, bias, w, dropout_rate=0.1, seed=5)
    b = _train_grads(TA.fused_attention_train_flat, q, k, v, bias, w, dropout_rate=0.1, seed=5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_no_shared_attention_kernel_refuses_s_up_to_612(cuda):
    """Every wrapper finds a kernel whose shared memory fits one block, for
    every S the configs allow (text up to 512 tokens plus 100 regions)."""
    for name in ("flat_attention_train", "smajor_attention_train",
                 "blocked_attention_train"):
        smem = TA._train_kernels(name)[2]
        for hd in (32, 64, 128):
            for S in (158, 159, 417, 418, 612):
                for backward in (0, 1):
                    TA._key_blocked(smem, S, hd, backward)
    for name in ("flat_attention", "blocked_attention"):
        smem = TA._eval_kernel(name)[1]
        for hd in (32, 64, 128):
            for S in (417, 418, 612):
                TA._key_blocked(smem, S, hd)
    assert TA._key_blocked(TA._train_kernels()[2], 159, 64, 1)
    assert not TA._key_blocked(TA._train_kernels()[2], 158, 64, 1)


@pytest.mark.cuda
def test_m3p_train_step_at_s160_on_auto(cuda):
    """An M3P task with 60 text tokens gives S = 100 + 60 = 160: the auto
    route (B1 in bf16 on the card) trains, through the key-blocked backward."""
    from clg_vqa_tpu_torch.config import M3PConfig
    from clg_vqa_tpu_torch.models.m3p import M3P
    from clg_vqa_tpu_torch.train.loop import TrainState, make_train_step
    from clg_vqa_tpu_torch.train.optim import make_optimizer, warmup_constant_schedule
    cfg = M3PConfig(vocab_size=300, hidden_size=128, num_layers=2, num_heads=2,
                    intermediate_size=256, v_feature_size=64, pooler_size=128,
                    clf_hidden_size=64, num_labels=40)
    model = M3P(cfg, device=cuda, seed=0)
    r = np.random.RandomState(0)
    T, R = 60, 100
    ids = r.randint(3, 300, (2, 4, T)).astype(np.int32)
    n = r.randint(10, R + 1, (2, 4))
    batch = {"input_ids": ids, "input_mask": np.ones_like(ids),
             "features": r.randn(2, 4, R, 64).astype(np.float32),
             "locs": r.rand(2, 4, R, 5).astype(np.float32),
             "image_mask": (np.arange(R) < n[..., None]).astype(np.int32),
             "labels": r.randint(0, 40, (2, 4)).astype(np.int32)}
    params = dict(model.named_parameters())
    opt = make_optimizer(list(params), warmup_constant_schedule(1e-5, 0))
    state = TrainState(model, opt.init(params), 0)
    step = make_train_step(opt, torch.rand(40, 40, device=cuda), semantic_lambda=1.0,
                           compute_dtype=torch.bfloat16, fused_attn="auto")
    f0, b0 = TA.fused_attention_train_flat.launches, TA.fused_attention_train_flat.backward_launches
    state, m = step(state, {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()},
                    seed=1)
    assert np.isfinite(m["loss"].item()) and np.isfinite(m["grad_norm"].item())
    assert TA.fused_attention_train_flat.launches - f0 == 2 * cfg.num_layers
    assert TA.fused_attention_train_flat.backward_launches - b0 == 2 * cfg.num_layers
    assert TA._key_blocked(TA._train_kernels()[2], T + R, 64, 1)


# ---------------------------------------------------------------------------
# B6: RoIPool
# ---------------------------------------------------------------------------

def _rois(dev, n, H, W, stride, seed=0):
    """n random rois over the map's image extent plus the edge cases: past
    every edge, a point, x2 < x1, half-pixel corners, one far beyond
    max_bin bins."""
    g = torch.Generator(dev).manual_seed(seed)
    x1 = torch.rand(n, device=dev, generator=g) * (W - 1) * stride
    y1 = torch.rand(n, device=dev, generator=g) * (H - 1) * stride
    wh = torch.rand(n, 2, device=dev, generator=g) * torch.tensor(
        [W * stride / 2, H * stride / 2], device=dev)
    special = torch.tensor([
        [-5 * stride, -5 * stride, (W + 5) * stride, (H + 5) * stride],
        [3 * stride, 2 * stride, 3 * stride, 2 * stride],
        [6 * stride, 6 * stride, 2 * stride, 1 * stride],
        [2.5 * stride, 1.5 * stride, 7.5 * stride, 4.5 * stride],
        [(W - 1) * stride, (H - 1) * stride, (W + 30) * stride, (H + 30) * stride],
        [0, 0, 40 * W * stride, 40 * H * stride]], device=dev)
    return torch.cat([torch.stack([x1, y1, x1 + wh[:, 0], y1 + wh[:, 1]], 1), special])


@pytest.mark.cuda
def test_roi_pool_kernel_bit_exact_at_the_c4_shape(cuda):
    """The C4 extractor's call: features [50, 84, 1024] bf16 (pad 800 x 1344,
    stride 16), 300 rois -> [300, 14, 14, 1024]: equal to the plain version,
    the same bits twice, one launch per call."""
    from clg_vqa_tpu_torch.ops import roi_pool as RP
    g = torch.Generator(cuda).manual_seed(0)
    feat = torch.randn(50, 84, 1024, device=cuda, generator=g).bfloat16()
    rois = _rois(cuda, 294, 50, 84, 16)
    kw = dict(output_size=(14, 14), spatial_scale=1 / 16, max_bin=8)
    before = RP.roi_pool_nhwc.launches
    with torch.no_grad():
        a = RP.roi_pool_nhwc(feat, rois, **kw)
        b = RP.roi_pool_nhwc(feat, rois, **kw)
    torch.cuda.synchronize()
    assert RP.roi_pool_nhwc.launches == before + 2
    assert a.shape == (300, 14, 14, 1024) and a.dtype == torch.bfloat16
    assert torch.equal(a, b)
    assert torch.equal(a, RP.roi_pool_nhwc_plain(feat, rois, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,out,stride,max_bin", [
    ((18, 22, 8), (7, 7), 8, 8), ((12, 20, 128), (7, 7), 8, 8),
    ((3, 5, 16), (14, 14), 16, 8), ((12, 20, 32), (3, 5), 4, 2)])
def test_roi_pool_kernel_edge_cases(cuda, dtype, shape, out, stride, max_bin):
    """The CPU tests' cases on the card, including maps smaller than the TPU
    kernel's window (3 x 5) and bins longer than max_bin: bit-exact."""
    from clg_vqa_tpu_torch.ops import roi_pool as RP
    H, W, C = shape
    feat = torch.randn(H, W, C, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(1)).to(dtype)
    rois = _rois(cuda, 20, H, W, stride, seed=2)
    kw = dict(output_size=out, spatial_scale=1 / stride, max_bin=max_bin)
    with torch.no_grad():
        got = RP.roi_pool_nhwc(feat, rois, **kw)
    assert torch.equal(got, RP.roi_pool_nhwc_plain(feat, rois, **kw))
    assert torch.equal(got.cpu(), RP.roi_pool_nhwc_plain(feat.cpu(), rois.cpu(), **kw))


@pytest.mark.cuda
def test_roi_pool_kernel_refuses_what_it_does_not_take(cuda):
    from clg_vqa_tpu_torch.ops import roi_pool as RP
    rois = torch.tensor([[0.0, 0.0, 40.0, 40.0]], device=cuda)
    kw = dict(output_size=(2, 2), spatial_scale=0.25)
    with pytest.raises(RuntimeError, match="no backward"):
        RP.roi_pool_nhwc(torch.zeros(10, 12, 8, device=cuda, requires_grad=True), rois, **kw)
    with pytest.raises(ValueError, match="16-byte"):
        RP.roi_pool_nhwc(torch.zeros(10, 12, 3, device=cuda), rois, **kw)
    with pytest.raises(ValueError, match="fp32/bf16"):
        RP.roi_pool_nhwc(torch.zeros(10, 12, 8, device=cuda, dtype=torch.float64), rois, **kw)
