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
