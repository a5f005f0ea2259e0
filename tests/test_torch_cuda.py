"""Card-only tests of the port's CUDA kernels: each against its plain PyTorch
version on the card. They skip where there is no NVIDIA GPU. The file
imports no JAX, so the machine with the card runs it without the JAX suite:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import subprocess
import sys
from pathlib import Path

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
@pytest.mark.parametrize("case", [
    "B=1", "B=12293", "all the same", "all distinct", "m3p rows fp32",
    "bf16 bank", "16-byte rows", "ragged last block"])
def test_rows_gather_kernel_cases_bit_exact(cuda, case):
    """The kernel at the shapes and index patterns the main paths give it
    and at its edges (one index, twelve thousand 64-byte rows, rows of one
    16-byte vector, rows that are not a multiple of a block's share):
    bit-exact against the plain version, one launch count per call."""
    g = torch.Generator(cuda).manual_seed(len(case))
    shape, B, dtype, pattern = {
        "B=1": ((400, 36, 2048), 1, torch.float32, "uniform"),
        "B=12293": ((400, 4, 4), 12293, torch.float32, "uniform"),
        "all the same": ((400, 36, 2048), 1024, torch.float32, "same"),
        "all distinct": ((3000, 36, 64), 2048, torch.float32, "distinct"),
        "m3p rows fp32": ((400, 100, 2048), 1024, torch.float32, "uniform"),
        "bf16 bank": ((400, 36, 2048), 1024, torch.bfloat16, "uniform"),
        "16-byte rows": ((1000, 4), 5000, torch.float32, "uniform"),
        "ragged last block": ((64, 100, 2040), 300, torch.bfloat16, "uniform"),
    }[case]
    bank = torch.randn(*shape, device=cuda, generator=g).to(dtype)
    n = shape[0]
    if pattern == "same":
        idx = torch.full((B,), n // 2, dtype=torch.int32, device=cuda)
    elif pattern == "distinct":
        idx = torch.randperm(n, device=cuda, generator=g)[:B].to(torch.int32)
    else:
        idx = torch.randint(0, n, (B,), device=cuda, generator=g, dtype=torch.int32)
    if case == "ragged last block":              # a block copies 256 x 4 16-byte vectors
        row_bytes = bank[0].numel() * bank.element_size()
        assert row_bytes % (256 * 4 * 16) and row_bytes > 256 * 4 * 16
    before = TG.rows_gather.launches
    got = TG.rows_gather(bank, idx)
    torch.cuda.synchronize()
    assert TG.rows_gather.launches == before + 1
    assert torch.equal(got, TG.rows_gather_plain(bank, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["-1", "n_rows"])
def test_rows_gather_kernel_traps_out_of_range_indices(cuda, bad):
    """An index outside [0, n_rows) traps in the kernel: the call reads
    nothing outside the bank and the next synchronisation raises. The trap
    poisons the CUDA context, so it runs in a child process."""
    code = (
        "import torch\n"
        "from clg_vqa_tpu_torch.ops.bank_gather import rows_gather\n"
        "bank = torch.randn(10, 36, 64, device='cuda')\n"
        f"idx = torch.tensor([1, 2, {bad.replace('n_rows', '10')}, 3], dtype=torch.int32, "
        "device='cuda')\n"
        "rows_gather(bank, idx)\n"
        "torch.cuda.synchronize()\n"
        "print('no fault')\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300)
    assert run.returncode != 0 and "no fault" not in run.stdout
    assert "CUDA error" in run.stderr or "AcceleratorError" in run.stderr, run.stderr[-2000:]


@pytest.mark.cuda
def test_rows_gather_kernel_rejects_unaligned_rows(cuda):
    bank = torch.zeros(4, 3, device=cuda)            # 12-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        TG.rows_gather(bank, torch.tensor([1], dtype=torch.int32, device=cuda))


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _train_grads(fn, q, k, v, bias, w, H=12, **kw):
    q, k, v, bias = (t.detach().clone().requires_grad_() for t in (q, k, v, bias))
    out = fn(q, k, v, bias, H, **kw)
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
    dbias: 1e-4 * max|dbias|. fp32 runs attention_train.cuh (fp32 CUDA
    cores), which differs from the plain version in summation order only;
    bf16 runs the tensor-core kernels of attention_train_mma.cuh (exact bf16
    products summed in fp32, p_d and ds as hi + lo bf16 terms, D the exact
    sum_j dp p)."""
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
    """The fp32 forward's realized keep bits equal dropout_keep_mask on the
    card and on the CPU; another seed gives another mask (the bf16
    forward's: test_bf16_flat_and_smajor_forward_masks_are_the_plain_mask)."""
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
    seed, with B1's tolerances (test_flat_train_kernels_match_plain; B1's
    device codes, bf16 on the tensor cores); the entry makes its eight
    layout copies."""
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
    """B5 and B1 run the same device codes on two layouts (bf16:
    attention_train_mma.cuh; fp32: attention_train.cuh) and key dropout
    alike: output and every gradient equal bit for bit."""
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


BLOCK_S = [1, 13, 76, 140, 159, 160, 161, 418, 612]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S", BLOCK_S)
def test_bf16_block_kernels_match_plain(cuda, S, hd):
    """bf16 B4 (its products on wgmma, its core the tensor-core kernels
    taking dctx as hi + lo) against the plain version with
    _assert_block_close's bf16 tolerances at rates 0 and 0.1 under each of
    _train_biases (UC2's -10000 padding, -inf keys, a sample's leading keys
    -inf); a second run gives the same bits. The core's own gates (B1's,
    the bias gradient within 1e-4) need the plain version's q, k and v,
    which the kernel's projections may round otherwise by an ulp: the CPU
    emulation (tests/test_torch_b4_mma_numerics.py) holds them, and the
    identity gate below holds the core to B1 bit for bit."""
    H, B = 384 // hd, 4
    args, w = _block_inputs(cuda, B, S, H, hd, torch.bfloat16, seed=S)
    for bias in _train_biases(cuda, B, S, H, hd):
        a = args[:-1] + [bias]
        for rate in (0.0, 0.1):
            kw = dict(dropout_rate=rate, seed=77)
            got = _block_grads(TB.fused_attention_block, a, w, H, **kw)
            again = _block_grads(TB.fused_attention_block, a, w, H, **kw)
            assert torch.equal(got[0], again[0])
            assert all(torch.equal(x, y) for x, y in zip(got[1], again[1]))
            want = _block_grads(TB.fused_attention_block_plain, a, w, H, **kw)
            _assert_block_close(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [13, 76, 161])
def test_bf16_block_with_identity_weights_is_b1_bit_for_bit(cuda, S):
    """With Wq = Wk = Wv = Wo = I and zero biases every product of bf16 B4 is
    exact and dctx's lo term is zero, so B4 is B1 on q = k = v = x: y is
    B1's output, the bias gradient B1's per-head gradients summed in order
    h = 0..H-1 (B1's own entry sums with db_heads.sum(1), whose order is not
    fixed, so its launcher's per-head buffer is summed here), and dx is
    (dq + dk) + dv of B1's bf16 gradients, in bf16 in that order. Bit for
    bit, at rates 0 and 0.1."""
    B, H, hd = 4, 12, 64
    D = H * hd
    x, _, _, bias = _attention_inputs(cuda, B, S, H, hd, torch.bfloat16)
    g = torch.randn(x.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(1)).bfloat16()
    eye, zb = torch.eye(D, device=cuda).bfloat16(), torch.zeros(D, device=cuda)
    b2 = TA._bias2(bias, B, S)
    for rate in (0.0, 0.1):
        t = TA.keep_threshold(rate)
        ins = [a.detach().clone().requires_grad_() for a in [x] + [eye, zb] * 4 + [bias]]
        y = TB.fused_attention_block(*ins, H, dropout_rate=rate, seed=5)
        grads = torch.autograd.grad(y, ins, g)
        out = torch.empty_like(x)
        stats, words = TA._train_buffers(x, B, H, S, t)
        TA._launch_train_fwd(TA._FLAT, x, x, x, b2, out, B, S, H, t, 5, stats, words)
        dq, dk, dv, dbh = TA._launch_train_bwd(TA._FLAT, x, x, x, b2, g, B, S, H, t, 5,
                                               stats, words)
        assert torch.equal(y, out)
        assert torch.equal(grads[-1].view(B, S), _sum_heads(dbh))
        assert torch.equal(grads[0], (dq + dk) + dv)


def _sum_heads(dbh: torch.Tensor) -> torch.Tensor:
    """[B, H, S] summed over heads in order h = 0..H-1, as B4 sums them."""
    db = dbh[:, 0]
    for h in range(1, dbh.shape[1]):
        db = db + dbh[:, h]
    return db


def _core_gate_misses(dx, dbias, want, *, B, S, D):
    """What of B1's gates a bf16 B4 core misses against the plain core's
    fp32 (dq, dk, dv, per-head bias gradient) ``want`` on q = k = v = x:
    the bias gradient within 1e-4 of its largest value, and dx = (dq + dk)
    + dv in bf16 within two bf16 ulps of each term's largest value plus one
    ulp of the largest partial sum for the two bf16 roundings of the sums.
    An empty list when both hold."""
    dq, dk, dv = (t.view(B, S, D) for t in want[:3])
    db = _sum_heads(want[3])
    tol_x = (2 * sum(_bf16_ulp(t.abs().max().item()) for t in (dq, dk, dv))
             + _bf16_ulp(max((dq + dk).abs().max().item(), (dq + dk + dv).abs().max().item())))
    err_x = (dx.float() - (dq + dk + dv)).abs().max().item()
    tol_b = 1e-4 * db.abs().max().item()
    err_b = (dbias.float().view(B, S) - db).abs().max().item()
    misses = []
    if err_x > tol_x:
        misses.append(f"dx {err_x} > {tol_x}")
    if err_b > tol_b:
        misses.append(f"bias gradient {err_b} > {tol_b}")
    return misses


@pytest.mark.cuda
@pytest.mark.parametrize("S", [13, 76, 161])
def test_bf16_block_core_takes_dctx_as_hi_and_lo(cuda, S):
    """The core of bf16 B4 isolated on the card: with Wq = Wk = Wv = I and
    zero biases its q, k and v are x exactly, and a random Wo gives
    dctx = g Wo a nonzero lo term. B4's bias gradient and dx are held to
    the plain core (_core_backward_plain on x, x, x and the fp32 dctx) with
    B1's gates (_core_gate_misses), at rates 0 and 0.1. The control, B1's
    backward on hi = bf16(dctx) alone (what B4's kernel computes if it
    drops the lo products), must miss the bias-gradient gate, so the gate
    sees the lo term."""
    B, H, hd = 4, 12, 64
    D = H * hd
    gen = torch.Generator(cuda).manual_seed(3)
    x, _, _, bias = _attention_inputs(cuda, B, S, H, hd, torch.bfloat16)
    g = torch.randn(x.shape, device=cuda, generator=gen).bfloat16()
    wo = (torch.randn(D, D, device=cuda, generator=gen) / D ** 0.5).bfloat16()
    eye, zb = torch.eye(D, device=cuda).bfloat16(), torch.zeros(D, device=cuda)
    b2 = TA._bias2(bias, B, S)
    dctx = (g.float().view(B * S, D) @ wo.float()).view(B, S, D)
    for rate in (0.0, 0.1):
        t = TA.keep_threshold(rate)
        ins = [a.detach().clone().requires_grad_()
               for a in [x, eye, zb, eye, zb, eye, zb, wo, zb, bias]]
        y = TB.fused_attention_block(*ins, H, dropout_rate=rate, seed=9)
        grads = torch.autograd.grad(y, ins, g)
        want = TB._core_backward_plain(x, x, x, b2.float(), dctx, H, t, 9)
        assert _core_gate_misses(grads[0], grads[-1], want, B=B, S=S, D=D) == []
        out = torch.empty_like(x)
        stats, words = TA._train_buffers(x, B, H, S, t)
        TA._launch_train_fwd(TA._FLAT, x, x, x, b2, out, B, S, H, t, 9, stats, words)
        dq, dk, dv, dbh = TA._launch_train_bwd(TA._FLAT, x, x, x, b2, dctx.bfloat16(), B,
                                               S, H, t, 9, stats, words)
        misses = _core_gate_misses((dq + dk) + dv, _sum_heads(dbh), want, B=B, S=S, D=D)
        assert any(m.startswith("bias gradient") for m in misses), misses


def _dyadic(shape, dev, gen):
    """bf16 values i/8, |i| <= 16: every fp32 sum of their products is
    exact, whatever its order."""
    return (torch.randint(-16, 17, shape, device=dev, generator=gen) / 8).bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("epilogue", TB.EPILOGUES)
def test_wgmma_product_matches_mm(cuda, epilogue, wide):
    """B4's product kernel alone (csrc/gemm_wgmma.cuh) against torch.mm in
    fp32 on the same bf16 operands, at M = 296 and K = 200 (neither a
    multiple of the 128 x 64 tile: TMA's zero fill and the masked stores;
    both multiples of 8, as TMA's 16-byte row strides need), N = 256, in
    each epilogue's layouts: bias (three jobs) within one bf16 ulp of the
    largest output; hi + lo within 2e-5 of the largest product against a
    float64 product (the two terms keep ~16 bits, 2^-17 = 7.6e-6 of a value,
    beside the fp32 accumulator's rounding); the weight-gradient partials
    (four jobs, four K ranges) and column sums summed over the ranges
    within 1e-5 of the largest; the three jobs' bf16 sum bit for bit on
    dyadic operands, whose fp32 sums are exact in any order. Both tile
    widths, 128 x 128 and 128 x 256 (N = 384 there: one and a half tiles)."""
    M, N, K = 296, 384 if wide else 256, 200
    gen = torch.Generator(cuda).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, device=cuda, generator=gen).bfloat16()

    if epilogue == "bias":
        a, b = [rnd(M, K) for _ in range(3)], [rnd(N, K) for _ in range(3)]
        bias = [torch.randn(N, device=cuda, generator=gen) for _ in range(3)]
        for out, aj, bj, cj in zip(TB.wgmma_product("bias", a, b, bias, wide=wide), a, b, bias):
            ref = aj.float() @ bj.float().t() + cj
            assert out.dtype == torch.bfloat16 and out.shape == (M, N)
            assert (out.float() - ref).abs().max().item() <= _bf16_ulp(ref.abs().max().item())
    elif epilogue == "hilo":
        a, b = rnd(M, K), rnd(K, N)
        (out,) = TB.wgmma_product("hilo", [a], [b], wide=wide)
        ref = a.double() @ b.double()
        err = (out[0].double() + out[1].double() - ref).abs().max().item()
        assert out.shape == (2, M, N) and err <= 2e-5 * ref.abs().max().item()
    elif epilogue == "wgrad":
        a, b = [rnd(K, M) for _ in range(4)], [rnd(K, N) for _ in range(4)]
        for (part, cs), aj, bj in zip(TB.wgmma_product("wgrad", a, b, ksplit=4, wide=wide), a, b):
            ref = aj.float().t() @ bj.float()
            assert part.shape == (4, M, N) and cs.shape == (4, M)
            assert (part.sum(0) - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
            cref = aj.float().sum(0)
            assert (cs.sum(0) - cref).abs().max().item() <= 1e-5 * cref.abs().max().item()
    else:
        a, b = [_dyadic((M, K), cuda, gen) for _ in range(3)], [
            _dyadic((K, N), cuda, gen) for _ in range(3)]
        (out,) = TB.wgmma_product("sum", a, b, wide=wide)
        r = [(aj.double() @ bj.double()).bfloat16() for aj, bj in zip(a, b)]
        assert torch.equal(out, (r[0] + r[1]) + r[2])


@pytest.mark.cuda
def test_bf16_block_kernel_refuses_unaligned_operands(cuda):
    """B4's products read their operands by TMA and its core copies 16-byte
    rows: an x or a weight that starts off a 16-byte boundary raises rather
    than faults. A cotangent off one, as autograd may hand it, is copied
    first, so its gradients equal an aligned cotangent's bit for bit.
    Nothing falls back: the bf16 backward without the forward's statistics
    returns cudaErrorInvalidValue (1)."""
    B, S, H, hd = 2, 13, 4, 64
    args, w = _block_inputs(cuda, B, S, H, hd, torch.bfloat16)
    kw = dict(dropout_rate=0.1, seed=3)
    for i in (0, 1, 7):
        bad = list(args)
        bad[i] = _shifted(args[i])
        with pytest.raises(ValueError, match="16-byte"):
            TB.fused_attention_block(*bad, H, **kw)
    grads = []
    dy = w.bfloat16()
    for d in (dy, _shifted(dy)):
        ins = [t.detach().clone().requires_grad_() for t in args]
        grads.append(torch.autograd.grad(TB.fused_attention_block(*ins, H, **kw), ins, d))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    x = args[0]
    f32 = dict(dtype=torch.float32, device=cuda)
    D = H * hd
    q, k, v, c, dq, dk, dv, dx = (torch.empty_like(x) for _ in range(8))
    dctx = torch.empty(2, B, S, D, dtype=x.dtype, device=cuda)
    dw = [torch.empty_like(args[1]) for _ in range(4)]
    db = [torch.empty(D, **f32) for _ in range(4)]
    scratch = torch.empty(TB._entry("scratch_floats")(D), **f32)
    b2 = TA._bias2(args[-1], B, S)
    t = TA.keep_threshold(0.1)
    ptrs = [x, q, k, v, c, b2, dy, *args[1:9:2], dctx, dq, dk, dv,
            torch.empty(B, H, S, **f32), torch.empty(B, S, **f32), dx, *dw, *db, scratch]
    assert len(ptrs) == 27
    err = TB._entry("bwd")(1, *[p.data_ptr() for p in ptrs], None, None, B, S, H, hd, t,
                           256.0 / t, 3, torch.cuda.current_stream().cuda_stream, None)
    assert err == 1


# ---------------------------------------------------------------------------
# B2 / B3: the head-blocked attention (M3P's fused_attn=True and "hm")
# ---------------------------------------------------------------------------

def _neg_inf_inputs(dev, B, S, H, hd, dtype, seed=0):
    """q/k/v [B, S, H*hd] and M3P's key bias: -inf on the trailing third of
    sample 1's keys, 0 elsewhere."""
    q, k, v, _ = _attention_inputs(dev, B, S, H, hd, dtype)
    valid = torch.ones(B, S, dtype=torch.bool, device=dev)
    if S // 3:
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


EVAL_S = [1, 13, 76, 140, 159, 418, 612]


def _leading_neg_inf(bias, S):
    """The bias with sample 2's first 64 + S // 8 keys -inf as well (its
    rows' first 64-key tile wholly masked, later keys valid), or None where
    S leaves no later key."""
    lead = 64 + S // 8
    if lead >= S:
        return None
    out = bias.clone()
    out[2, ..., :lead] = float("-inf")
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S", EVAL_S)
def test_bf16_eval_kernels_match_plain(cuda, S, hd):
    """K1 and B2 in bf16 (one tensor-core kernel at every S) against the
    plain version under M3P's -inf key bias, and with a sample whose
    leading 64 + S // 8 keys are -inf too: one bf16 ulp of the largest
    output; finite; one launch per call; a second launch gives the same
    bits."""
    H = 384 // hd
    q, k, v, bias = _neg_inf_inputs(cuda, 4, S, H, hd, torch.bfloat16)
    biases = [bias, _leading_neg_inf(bias, S)]
    for bias in (b for b in biases if b is not None):
        want = TA.fused_attention_flat_plain(q, k, v, bias, H).float()
        tol = _bf16_ulp(want.abs().max().item())
        for fn in (TA.fused_attention_flat, TA.fused_attention):
            before = fn.launches
            with torch.no_grad():
                got = fn(q, k, v, bias, H)
                again = fn(q, k, v, bias, H)
            torch.cuda.synchronize()
            assert fn.launches == before + 2
            assert got.dtype == torch.bfloat16 and got.shape == q.shape
            assert torch.isfinite(got).all()
            assert (got.float() - want).abs().max().item() <= tol
            assert torch.equal(got, again)


@pytest.mark.cuda
def test_bf16_eval_kernel_refuses_unaligned_operands(cuda):
    """The bf16 kernel copies 16-byte rows: a K1 operand that starts off a
    16-byte boundary raises rather than faults (B2's entry copies its
    operands into fresh head-major tensors)."""
    q, k, v, bias = _neg_inf_inputs(cuda, 2, 9, 4, 64, torch.bfloat16)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    shifted = buf[1:].view(q.shape).copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        with torch.no_grad():
            TA.fused_attention_flat(shifted, k, v, bias, 4)


@pytest.mark.cuda
def test_bf16_eval_kernels_at_full_width_are_deterministic(cuda):
    """The main paths' shapes: K1 at [1024, 76, 768], B2 at [1024, 140,
    768], bf16, -inf keys: one bf16 ulp of the largest output, two
    launches bit-equal, and K1 and B2 (one device code in two layouts)
    bit-equal to each other."""
    for fn, other, S in ((TA.fused_attention_flat, TA.fused_attention, 76),
                         (TA.fused_attention, TA.fused_attention_flat, 140)):
        q, k, v, bias = _neg_inf_inputs(cuda, 1024, S, 12, 64, torch.bfloat16)
        with torch.no_grad():
            got = fn(q, k, v, bias, 12)
            again = fn(q, k, v, bias, 12)
            assert torch.equal(got, other(q, k, v, bias, 12))
        want = TA.fused_attention_flat_plain(q, k, v, bias, 12).float()
        assert (got.float() - want).abs().max().item() <= _bf16_ulp(
            want.abs().max().item())
        assert torch.equal(got, again)


def _assert_b3_mask_is_b1s(dev, S, rate, B=4, H=12, hd=64):
    """B3's realized keep mask (through its forward, in the operands' dtype
    realized_keep_mask uses) equals B1's and dropout_keep_mask; with bf16
    operands B3 takes the tensor-core kernel, whose mask this reads."""
    t = TA.keep_threshold(rate)

    def b3_bf16(q, k, v, bias, H, **kw):
        return TA.fused_attention_train(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                        bias, H, **kw)

    got = TA.realized_keep_mask(4321, B, H, S, hd, rate, dev, train=b3_bf16)
    assert torch.equal(got, TA.realized_keep_mask(4321, B, H, S, hd, rate, dev))
    assert torch.equal(got, TA.dropout_keep_mask(4321, B, H, S, t, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("S", [13, 76, 140])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_train_kernels_match_plain_and_b1(cuda, S, dtype, rate):
    """B3 through both entries, forward and backward, under the -inf key
    bias: against autograd of its plain version with B1's tolerances
    (test_flat_train_kernels_match_plain) and equal to B1's kernels bit for
    bit (one device code a dtype, one keep mask; bf16: the tensor-core
    kernels); one launch of each kernel per entry call."""
    q, k, v, bias = _neg_inf_inputs(cuda, 8, S, 12, 64, dtype)
    w = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    kw = dict(dropout_rate=rate, seed=4321)
    flat = _train_grads(TA.fused_attention_train_flat, q, k, v, bias, w, **kw)
    want = _train_grads(TA.fused_attention_train_flat_plain, q, k, v, bias, w, **kw)
    if dtype == torch.bfloat16 and rate:
        _assert_b3_mask_is_b1s(cuda, S, rate)
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


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S", EVAL_S)
def test_bf16_blocked_train_kernels_match_plain(cuda, S, hd):
    """B3 in bf16 (the tensor-core kernels of csrc/attention_train_mma.cuh,
    one each for every S) through the head-major entry, rates 0 and 0.1,
    under M3P's -inf key bias and with a sample whose leading 64 + S // 8
    keys are -inf too: against autograd of the plain version with B1's bf16
    tolerances (output one bf16 ulp of its largest value, dq/dk/dv two,
    dbias 1e-4 of its largest); finite; one launch of each kernel per call;
    a second run gives the same bits. Shared memory fits one block."""
    H = 384 // hd
    for backward in (0, 1):
        assert TA._train_mma(TA._HM)[2](S, hd, backward) <= TA._MAX_SMEM
    q, k, v, bias = _neg_inf_inputs(cuda, 4, S, H, hd, torch.bfloat16)
    w = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    for bias in (b for b in (bias, _leading_neg_inf(bias, S)) if b is not None):
        for rate in (0.0, 0.1):
            kw = dict(dropout_rate=rate, seed=1357)
            f0 = TA.fused_attention_train.launches
            b0 = TA.fused_attention_train.backward_launches
            got = _train_grads(_hm_train, q, k, v, bias, w, H=H, **kw)
            torch.cuda.synchronize()
            assert TA.fused_attention_train.launches == f0 + 1
            assert TA.fused_attention_train.backward_launches == b0 + 1
            assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.bfloat16
            _assert_train_close(got, _train_grads(TA.fused_attention_train_flat_plain,
                                                  q, k, v, bias, w, H=H, **kw),
                                torch.bfloat16)
            again = _train_grads(_hm_train, q, k, v, bias, w, H=H, **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_bf16_blocked_train_kernel_refuses_unaligned_operands(cuda):
    """B3's bf16 kernels copy 16-byte rows: a head-major operand that starts
    off a 16-byte boundary raises rather than faults; fp32 takes it."""
    q, k, v, bias = _neg_inf_inputs(cuda, 2, 9, 4, 64, torch.bfloat16)
    qh, kh, vh = (t.view(2, 9, 4, 64).transpose(1, 2).contiguous() for t in (q, k, v))
    buf = torch.empty(qh.numel() + 1, dtype=qh.dtype, device=cuda)
    shifted = buf[1:].view(qh.shape).copy_(qh)
    with pytest.raises(ValueError, match="16-byte"):
        TA.fused_attention_train_hm(shifted, kh, vh, bias, dropout_rate=0.1, seed=1)
    buf = torch.empty(qh.numel() + 1, device=cuda)
    shifted = buf[1:].view(qh.shape).copy_(qh.float())
    TA.fused_attention_train_hm(shifted, kh.float(), vh.float(), bias)


# ---------------------------------------------------------------------------
# bf16 B1 and B5: B3's tensor-core kernels on their strides
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("S", [13, 76, 140, 159, 612])
def test_bf16_flat_and_smajor_forwards_equal_b3s_bit_for_bit(cuda, S):
    """One device code (csrc/attention_train_mma.cuh's forward) at three
    strides: bf16 B1 (flat), B5 (S-major) and B3 (head-major, split
    outside) give the same output bits on the same values and seed, rates
    0 and 0.1, under UC2's -10000 keys, M3P's -inf keys and a sample whose
    leading 64 + S // 8 keys are -inf too; finite; one launch each."""
    H = 12
    q, k, v, bias = _attention_inputs(cuda, 8, S, H, 64, torch.bfloat16)
    _, _, _, neg_inf = _neg_inf_inputs(cuda, 8, S, H, 64, torch.bfloat16)
    biases = [bias, neg_inf, _leading_neg_inf(neg_inf, S)]
    for bias in (b for b in biases if b is not None):
        for rate in (0.0, 0.1):
            kw = dict(dropout_rate=rate, seed=2024)
            f0 = TA.fused_attention_train_flat.launches
            s0 = TA.fused_attention_train_smajor.launches
            with torch.no_grad():
                flat = TA.fused_attention_train_flat(q, k, v, bias, H, **kw)
                sm = TA.fused_attention_train_smajor(q, k, v, bias, H, **kw)
                b3 = _hm_train(q, k, v, bias, H, **kw)
            torch.cuda.synchronize()
            assert TA.fused_attention_train_flat.launches == f0 + 1
            assert TA.fused_attention_train_smajor.launches == s0 + 1
            assert torch.isfinite(flat).all()
            assert torch.equal(flat, sm) and torch.equal(flat, b3), (S, rate)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [13, 76, 140, 612])
def test_bf16_flat_and_smajor_forward_masks_are_the_plain_mask(cuda, S):
    """The tensor-core forward's realized keep bits, read through B1's and
    B5's entries with bf16 operands, equal dropout_keep_mask; the forward
    stores them for the backward
    (test_bf16_flat_and_smajor_backward_reads_the_forward_mask)."""
    t = TA.keep_threshold(0.1)
    want = TA.dropout_keep_mask(99, 8, 12, S, t, cuda)
    for train in (TA.fused_attention_train_flat, TA.fused_attention_train_smajor):
        got = TA.realized_keep_mask(99, 8, 12, S, 64, 0.1, cuda, train=train,
                                    dtype=torch.bfloat16)
        assert torch.equal(got, want), train


def _shifted(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x that starts off a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape).copy_(x)
    assert out.data_ptr() % 16
    return out


@pytest.mark.cuda
def test_bf16_flat_and_smajor_forwards_refuse_unaligned_operands(cuda):
    """The tensor-core forward copies 16-byte rows: a bf16 operand of B1's
    entry or of B5's S-major core that starts off a 16-byte boundary raises
    rather than faults, as B3's and K1's do; fp32 takes it, and so does
    B5's [B, S, H*hd] entry, whose layout swap copies."""
    q, k, v, bias = _attention_inputs(cuda, 8, 13, 4, 64, torch.bfloat16)
    kw = dict(dropout_rate=0.1, seed=3)
    with pytest.raises(ValueError, match="16-byte"):
        TA.fused_attention_train_flat(_shifted(q), k, v, bias, 4, **kw)
    qs, ks, vs = (x.transpose(0, 1).contiguous() for x in (q, k, v))
    with pytest.raises(ValueError, match="16-byte"):
        TA.smajor_attention_core(_shifted(qs), ks, vs, bias, 4, **kw)
    TA.fused_attention_train_smajor(_shifted(q), k, v, bias, 4, **kw)
    TA.fused_attention_train_flat(_shifted(q.float()), k.float(), v.float(),
                                  bias, 4, **kw)


# S at and around the backward's key-chunk limits (16 x 10 warps = 160 at
# hd 32 and 64, 16 x 8 = 128 at hd 128), the fp32 kernels' shared-memory
# limits (159, 418) and the longest M3P sequence
BWD_S = [1, 13, 76, 140, 159, 160, 161, 418, 612]


def _train_biases(dev, B, S, H, hd):
    """UC2's -10000 padding (a third of sample 1's keys), M3P's -inf keys
    (the same keys) and the -inf bias with sample 2's leading 64 + S // 8
    keys -inf too, where S leaves a later key."""
    pad = _attention_inputs(dev, B, S, H, hd, torch.bfloat16)[3]
    neg_inf = _neg_inf_inputs(dev, B, S, H, hd, torch.bfloat16)[3]
    return [b for b in (pad, neg_inf, _leading_neg_inf(neg_inf, S)) if b is not None]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S", BWD_S)
def test_bf16_flat_and_smajor_backwards_equal_b3s_bit_for_bit(cuda, S, hd):
    """One device code (csrc/attention_train_mma.cuh) at three strides, both
    ways: bf16 B1 (flat), B5 (S-major) and B3 (head-major, split outside)
    give the same output and gradients (dq, dk, dv, dbias) bit for bit on
    the same values, cotangent and seed, rates 0 and 0.1, under each of
    _train_biases; finite; one launch of each kernel per call; a second
    run gives the same bits. Past one key chunk the backward sums dq in its
    float32 buffer."""
    H, B = 384 // hd, 8
    q, k, v, _ = _attention_inputs(cuda, B, S, H, hd, torch.bfloat16)
    w = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(5))
    flat_fn, sm_fn = TA.fused_attention_train_flat, TA.fused_attention_train_smajor
    for bias in _train_biases(cuda, B, S, H, hd):
        for rate in (0.0, 0.1):
            kw = dict(dropout_rate=rate, seed=2025)
            counts = [flat_fn.launches, flat_fn.backward_launches, sm_fn.launches,
                      sm_fn.backward_launches]
            flat = _train_grads(flat_fn, q, k, v, bias, w, H=H, **kw)
            sm = _train_grads(sm_fn, q, k, v, bias, w, H=H, **kw)
            torch.cuda.synchronize()
            assert [flat_fn.launches, flat_fn.backward_launches, sm_fn.launches,
                    sm_fn.backward_launches] == [c + 1 for c in counts]
            b3 = _train_grads(_hm_train, q, k, v, bias, w, H=H, **kw)
            assert all(torch.isfinite(t).all() for t in flat)
            assert all(torch.equal(a, b) for a, b in zip(flat, sm)), (S, hd, rate)
            assert all(torch.equal(a, b) for a, b in zip(flat, b3)), (S, hd, rate)
            again = _train_grads(flat_fn, q, k, v, bias, w, H=H, **kw)
            assert all(torch.equal(a, b) for a, b in zip(flat, again))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S", BWD_S)
def test_bf16_flat_and_smajor_backwards_match_plain(cuda, S, hd):
    """bf16 B1 and B5, forward and backward, against autograd of the plain
    version (fused_attention_train_flat_plain) on the same seed, with
    chip_smoke.py:grad_errors' tolerances (_assert_train_close: output one
    bf16 ulp of its largest value, dq/dk/dv two, dbias 1e-4 of its
    largest), rates 0 and 0.1, under each of _train_biases."""
    H, B = 384 // hd, 8
    q, k, v, _ = _attention_inputs(cuda, B, S, H, hd, torch.bfloat16)
    w = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(6))
    for bias in _train_biases(cuda, B, S, H, hd):
        for rate in (0.0, 0.1):
            kw = dict(dropout_rate=rate, seed=2026)
            want = _train_grads(TA.fused_attention_train_flat_plain, q, k, v, bias, w,
                                H=H, **kw)
            for fn in (TA.fused_attention_train_flat, TA.fused_attention_train_smajor):
                got = _train_grads(fn, q, k, v, bias, w, H=H, **kw)
                assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.bfloat16
                _assert_train_close(got, want, torch.bfloat16)


@pytest.mark.cuda
def test_bf16_flat_and_smajor_backwards_refuse_unaligned_operands(cuda):
    """The tensor-core backward copies 16-byte rows. Its q/k/v are the
    forward's, which refuses them off a 16-byte boundary
    (test_bf16_flat_and_smajor_forwards_refuse_unaligned_operands); a
    cotangent off one, as autograd may hand it to B1's entry or B5's core,
    is copied first, so its gradients equal an aligned cotangent's bit for
    bit. Nothing falls back to the CUDA-core backward: without the
    forward's statistics the bf16 backward raises, and the fp32 entries
    return cudaErrorInvalidValue (1) for bf16."""
    B, S, H, hd = 8, 13, 4, 64
    q, k, v, bias = _attention_inputs(cuda, B, S, H, hd, torch.bfloat16)
    w = torch.randn(q.shape, device=cuda).bfloat16()
    kw = dict(dropout_rate=0.1, seed=3)
    for fn, ops, dout in ((TA.fused_attention_train_flat, (q, k, v), w),
                          (TA.smajor_attention_core,
                           [x.transpose(0, 1).contiguous() for x in (q, k, v)],
                           w.transpose(0, 1).contiguous())):
        grads = []
        for d in (dout, _shifted(dout)):
            ins = [t.detach().clone().requires_grad_() for t in (*ops, bias)]
            grads.append(torch.autograd.grad(fn(*ins, H, **kw), ins, d))
        assert all(torch.equal(a, b) for a, b in zip(*grads)), fn
    t = TA.keep_threshold(0.1)
    b2 = TA._bias2(bias, B, S)
    with pytest.raises(RuntimeError, match="CUDA error"):
        TA._launch_train_bwd(TA._FLAT, q, k, v, b2, w, B, S, H, t, 3)
    dq = torch.empty_like(q)
    dbh = torch.empty(B, H, S, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for name in (TA._FLAT, TA._SM):
        fwd, bwd, _ = TA._train_kernels(name)
        assert fwd(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), b2.data_ptr(),
                   dq.data_ptr(), B, S, H, hd, t, 256.0 / t, 3, stream, 0) == 1
        assert bwd(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), b2.data_ptr(),
                   w.data_ptr(), dq.data_ptr(), dq.data_ptr(), dq.data_ptr(),
                   dbh.data_ptr(), B, S, H, hd, t, 256.0 / t, 3, stream, None) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("S", [76, 140, 612])
def test_bf16_flat_and_smajor_backward_reads_the_forward_mask(cuda, S):
    """The output is linear in v under a fixed mask, so <dv, v> equals the
    loss <out, w> when the backward uses the mask the forward realized, whose
    keep bits it reads from the forward. The tolerance is chip_smoke.py's
    bf16 one, 4 * 2^-8 of the root of the sum of the squared terms (out and
    dv are rounded to bf16, errors of random sign); the loss of another
    seed's forward misses this dv's inner product by far more."""
    H = 12
    q, k, v, bias = _attention_inputs(cuda, 8, S, H, 64, torch.bfloat16)
    w = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(7))
    w = w.bfloat16()
    for fn in (TA.fused_attention_train_flat, TA.fused_attention_train_smajor):
        def run(seed):
            vv = v.detach().clone().requires_grad_()
            out = fn(q, k, vv, bias, H, dropout_rate=0.1, seed=seed)
            (dv,) = torch.autograd.grad(out, vv, w)
            return out.detach().double() * w.double(), dv

        terms, dv = run(7)
        inner = (dv.double() * v.double()).sum().item()
        tol = 4 * 2.0 ** -8 * terms.square().sum().sqrt().item()
        assert abs(inner - terms.sum().item()) <= tol, (fn, inner, tol)
        other, _ = run(8)
        assert abs(inner - other.sum().item()) > 4 * tol, fn


# ---------------------------------------------------------------------------
# The key-blocked variant: S past the fp32 all-keys kernels' shared memory
# (fp32 training kernels from S = 159 at hd 64, fp32 K1 from 418, B2 from 412)
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
    """B1 past its fp32 all-keys limit against autograd of the plain version
    with B1's tolerances: in fp32 the key-blocked backward, and the
    key-blocked forward from S = 418; in bf16 the tensor-core kernels, which
    take every S. B5 and B3 (both entries) equal to it bit for bit, bf16
    B3's keep mask B1's; one launch of each kernel per call."""
    q, k, v, bias = _neg_inf_inputs(cuda, 8, S, 12, 64, dtype)
    w = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    kw = dict(dropout_rate=rate, seed=2468)
    f0, b0 = TA.fused_attention_train_flat.launches, TA.fused_attention_train_flat.backward_launches
    flat = _train_grads(TA.fused_attention_train_flat, q, k, v, bias, w, **kw)
    torch.cuda.synchronize()
    assert TA.fused_attention_train_flat.launches == f0 + 1
    assert TA.fused_attention_train_flat.backward_launches == b0 + 1
    want = _train_grads(TA.fused_attention_train_flat_plain, q, k, v, bias, w, **kw)
    _assert_train_close(flat, want, dtype)
    for fn in (TA.fused_attention_train_smajor, TA.fused_attention_train, _hm_train):
        got = _train_grads(fn, q, k, v, bias, w, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, flat)), fn
    if dtype == torch.bfloat16 and rate:
        _assert_b3_mask_is_b1s(cuda, S, rate, B=2)


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
    """The key-blocked forward's keep bits equal dropout_keep_mask (fp32 B1
    at S 418 and 612 runs it; at 159 the all-keys forward), and B4's equal
    B1's; the backward replays them (test_..._match_plain's gradients)."""
    t = TA.keep_threshold(0.1)
    got = TA.realized_keep_mask(31, 2, 12, S, 64, 0.1, cuda)
    assert torch.equal(got, TA.dropout_keep_mask(31, 2, 12, S, t, cuda))
    assert torch.equal(TB.realized_block_keep_mask(31, 2, 12, S, 64, 0.1, cuda), got)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [418, 612])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_key_blocked_eval_kernels_match_plain(cuda, S, dtype):
    """K1 and B2 past the fp32 all-keys limit (fp32: the key-blocked
    kernel; bf16: the tensor-core kernel, which takes every S), under the
    -inf key bias: fp32 atol 1e-5, bf16 one bf16 ulp of the largest output;
    one launch each."""
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
    """B1 at S 612: fp32 (the key-blocked kernels) and bf16 (the tensor-core
    kernels, dq summed over key chunks) give the same bits twice."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias = _neg_inf_inputs(cuda, 8, 612, 12, 64, dtype)
        w = torch.randn(q.shape, device=cuda)
        a = _train_grads(TA.fused_attention_train_flat, q, k, v, bias, w,
                         dropout_rate=0.1, seed=5)
        b = _train_grads(TA.fused_attention_train_flat, q, k, v, bias, w,
                         dropout_rate=0.1, seed=5)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), dtype


@pytest.mark.cuda
def test_no_shared_attention_kernel_refuses_s_up_to_612(cuda):
    """Every wrapper finds a kernel whose shared memory fits one block, for
    every S the configs allow (text up to 512 tokens plus 100 regions).
    The eval and training kernels consult the all-keys limit in fp32 only:
    in bf16 one tensor-core kernel a direction takes every S, its shared
    memory growing with S by a few [S] fp32 vectors only (the training
    kernels of B1, B5 and B3, csrc/attention_train_mma.cuh)."""
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
    for name in (TA._FLAT, TA._SM, TA._HM):
        for hd in (32, 64, 128):
            for S in (1, 159, 160, 161, 612):
                for backward in (0, 1):
                    TA._check_mma_smem(name, S, hd, backward)
            TA._check_mma_smem(name, 2048, hd, 0)
    assert TA._key_blocked(TA._train_kernels()[2], 159, 64, 1)
    assert not TA._key_blocked(TA._train_kernels()[2], 158, 64, 1)
    # bf16 eval at hd 128 (its largest shared memory), past S = 612
    q, k, v, bias = _neg_inf_inputs(cuda, 3, 2048, 2, 128, torch.bfloat16)
    want = TA.fused_attention_flat_plain(q, k, v, bias, 2).float()
    for fn in (TA.fused_attention_flat, TA.fused_attention):
        with torch.no_grad():
            got = fn(q, k, v, bias, 2).float()
        assert (got - want).abs().max().item() <= _bf16_ulp(want.abs().max().item())


@pytest.mark.cuda
def test_m3p_train_step_at_s160_on_auto(cuda):
    """An M3P task with 60 text tokens gives S = 100 + 60 = 160: the auto
    route (B1 in bf16 on the card) trains, through the tensor-core backward
    at its one-chunk limit (no float32 dq buffer at 160, one at 161)."""
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
    needs_dq32 = TA._train_mma(TA._FLAT)[3]
    assert not needs_dq32(T + R, 64) and needs_dq32(T + R + 1, 64)


# ---------------------------------------------------------------------------
# IMP and SFT masks (train/pruning.py) on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_imp_prune_step_on_cuda_gives_the_cpu_mask(cuda):
    """Two IMP rounds of 10% on full-width UC2 weights (random, seed 0):
    the card's masks equal the CPU's bit for bit, ties at the threshold
    included (85.5 M fp32 magnitudes hold many), and the zero counts are
    round(0.1 N), then that plus round(0.1 (N - first))."""
    from clg_vqa_tpu_torch.config import UC2Config
    from clg_vqa_tpu_torch.models.uc2 import UC2
    from clg_vqa_tpu_torch.train import pruning as pr
    model = UC2(UC2Config(), device=cuda, seed=0)
    names = pr.prunable_paths(model)
    gpu = {k: p.detach() for k, p in model.named_parameters() if k in names}
    cpu = {k: p.cpu() for k, p in gpu.items()}
    n = sum(p.numel() for p in gpu.values())
    assert n == 12 * 7077888 + 768 * 768
    mg, mc = pr.init_mask(gpu), pr.init_mask(cpu)
    zeros = 0
    for _ in range(2):
        mg, mc = pr.imp_prune_step(gpu, mg, 0.1), pr.imp_prune_step(cpu, mc, 0.1)
        zeros += int(round(0.1 * (n - zeros)))
        for k in names:
            assert mg[k].device.type == "cuda"
            assert torch.equal(mg[k].cpu(), mc[k]), k
        assert sum(int((m == 0).sum()) for m in mg.values()) == zeros
        assert pr.sparsity(mg) == pr.sparsity(mc)
    assert zeros == 16249651


@pytest.mark.cuda
def test_masked_bf16_b1_step_keeps_pruned_weights_zero(cuda):
    """SFT's masked step in bf16 on the auto route (B1's kernels, forward
    and backward) with weight decay: the pruned weights stay exactly 0
    through 3 steps and the surviving ones move."""
    from clg_vqa_tpu_torch.config import UC2Config
    from clg_vqa_tpu_torch.models.uc2 import UC2
    from clg_vqa_tpu_torch.train import pruning as pr
    from clg_vqa_tpu_torch.train.loop import TrainState, make_train_step
    from clg_vqa_tpu_torch.train.optim import make_optimizer
    cfg = UC2Config(vocab_size=300, hidden_size=128, num_layers=2, num_heads=2,
                    intermediate_size=256, v_feature_size=64, pooler_size=128,
                    clf_hidden_size=64, num_labels=40)
    model = UC2(cfg, device=cuda, seed=0)
    mask = pr.imp_prune_step(model, pr.init_mask(model), 0.3)
    pr.apply_mask(model, mask)
    params = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    opt = make_optimizer(list(params), 1e-3, weight_decay=1e-2)
    state = TrainState(model, opt.init(params), 0)
    step = make_train_step(opt, torch.rand(40, 40, device=cuda),
                           semantic_lambda=1.0, compute_dtype=torch.bfloat16,
                           fused_attn="auto", grad_mask=pr.grad_mask_tree(mask))
    r = np.random.RandomState(0)
    batch = {"input_ids": r.randint(3, 300, (2, 8, 11)).astype(np.int32),
             "input_mask": np.ones((2, 8, 11), np.int32),
             "features": r.randn(2, 8, 9, 64).astype(np.float32),
             "locs": r.rand(2, 8, 9, 7).astype(np.float32),
             "image_mask": np.ones((2, 8, 9), np.int32),
             "labels": r.randint(0, 40, (2, 8)).astype(np.int32)}
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    f0 = TA.fused_attention_train_flat.launches
    b0 = TA.fused_attention_train_flat.backward_launches
    for i in range(3):
        state, m = step(state, batch, seed=i)
        assert np.isfinite(m["loss"].item())
    assert TA.fused_attention_train_flat.launches - f0 == 3 * 2 * cfg.num_layers
    assert TA.fused_attention_train_flat.backward_launches - b0 == 3 * 2 * cfg.num_layers
    for k, p in params.items():
        if mask[k] is None:
            continue
        assert bool((p[mask[k] == 0] == 0).all()), k
        assert bool((p[mask[k] == 1] != before[k][mask[k] == 1]).any()), k


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


def _nan_inf_map(dev, H, W, C, dtype, seed):
    """randn with NaN, +inf and -inf: 1% of elements each at random, a whole
    column of NaN in the first half of the channels (inside bins, on their
    shared edges, or between bins cut to max_bin), a whole row of +inf in
    the second half and one position of -inf in every channel."""
    g = torch.Generator(dev).manual_seed(seed)
    feat = torch.randn(H, W, C, device=dev, generator=g)
    u = torch.rand(H, W, C, device=dev, generator=g)
    feat[u < 0.01] = float("nan")
    feat[(u >= 0.01) & (u < 0.02)] = float("inf")
    feat[(u >= 0.02) & (u < 0.03)] = float("-inf")
    feat[:, 5, :C // 2] = float("nan")
    feat[6, :, C // 2:] = float("inf")
    feat[3, W - 6, :] = float("-inf")
    return feat.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,out,stride,max_bin", [
    ((12, 20, 256), (7, 7), 8, 8), ((12, 20, 256), (3, 3), 8, 2),
    ((50, 84, 1024), (14, 14), 16, 8)])
def test_roi_pool_kernel_nan_and_inf_give_the_plain_versions_bits(cuda, dtype, shape, out,
                                                                  stride, max_bin):
    """A bin that holds a NaN gives 0, as the plain version and JAX's
    ops/roi.py give (the max propagates the NaN, then the finite rule); a
    bin holding +inf, or only -inf, gives 0; a NaN between bins cut to
    max_bin changes nothing: bit-exact against the plain version."""
    from clg_vqa_tpu_torch.ops import roi_pool as RP
    H, W, C = shape
    feat = _nan_inf_map(cuda, H, W, C, dtype, seed=H + max_bin)
    rois = torch.cat([_rois(cuda, 40, H, W, stride, seed=3),
                      torch.tensor([[0.0, 0.0, W * stride - 1.0, H * stride - 1.0]],
                                   device=cuda)])
    kw = dict(output_size=out, spatial_scale=1 / stride, max_bin=max_bin)
    with torch.no_grad():
        got = RP.roi_pool_nhwc(feat, rois, **kw)
    want = RP.roi_pool_nhwc_plain(feat, rois, **kw)
    assert torch.isfinite(want).all() and (want == 0).any() and (want != 0).any()
    assert torch.equal(got, want)


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


def _narrow_x101(seed: int = 0):
    """The X101 extractor's narrow config of tests/test_torch_x101.py in
    fp32, and random weights from a seed with the BN scales damped so the
    softmax spreads."""
    from clg_vqa_tpu_torch.models.detector import extractor_x101 as X
    cfg = X.X101Config(groups=4, width_per_group=4, fpn_channels=32, num_boxes=10,
                       pre_nms_topk=64, post_nms_topk=64, pad_h=128, pad_w=128,
                       short=96, max_size=128, bf16=False)
    params = X.init_x101_params(torch.Generator().manual_seed(seed), cfg)

    def damp(tree):
        if isinstance(tree, dict):
            return {k: v * 0.35 if k == "scale" else damp(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [damp(v) for v in tree]
        return tree

    return X, cfg, damp(params)


@pytest.mark.cuda
def test_x101_extractor_on_the_card_gives_the_cpu_records(cuda):
    """The small X101 in fp32 (TF32 off) on the card against the port's CPU
    path from the same weights: object ids and box order equal; features,
    boxes and confidences within rtol 1e-3 and 1e-3 of the largest |value|.
    Two images at device_batch 2, so the RPN's NMS folds both images."""
    X, cfg, params = _narrow_x101()
    r = np.random.RandomState(0)
    items = [((r.rand(h, w, 3) * 255).astype(np.uint8), f"x{i}")
             for i, (h, w) in enumerate([(90, 110), (128, 70)])]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = list(X.ExtractorX101(params, cfg, device="cuda").extract_many(
            items, device_batch=2))
    want = list(X.ExtractorX101(params, cfg, device="cpu").extract_many(items))
    for g, w in zip(got, want):
        assert g.image_id == w.image_id
        np.testing.assert_array_equal(g.obj_id, w.obj_id)
        for f in ("features", "boxes", "obj_conf"):
            y = getattr(w, f)
            np.testing.assert_allclose(getattr(g, f), y, rtol=1e-3,
                                       atol=1e-3 * np.abs(y).max(), err_msg=f)


@pytest.mark.cuda
def test_x101_roi_align_on_the_card_matches_the_cpu(cuda):
    """RoIAlign on a bf16 pyramid on the card against the same op on the
    CPU (fp32 accumulation both): within rtol 1e-5; box chunks bit for bit."""
    from clg_vqa_tpu_torch.models.detector import fpn as F
    g = torch.Generator().manual_seed(1)
    maps = [torch.randn(1, s, s, 64, generator=g).bfloat16() for s in (64, 32, 16, 8)]
    lo = torch.rand(300, 2, generator=g) * 200
    rois = torch.cat([lo, lo + 1 + torch.rand(300, 2, generator=g) * 300], 1)
    want = F.multilevel_roi_align_flat(maps, rois, legacy_levels=True)
    dmaps, drois = [m.to(cuda) for m in maps], rois.to(cuda)
    got = F.multilevel_roi_align_flat(dmaps, drois, legacy_levels=True)
    chunked = F.multilevel_roi_align_flat(dmaps, drois, legacy_levels=True, box_chunk=64)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    assert torch.equal(chunked, got)


# ---------------------------------------------------------------------------
# slice 6: the flat kernels at mp-local head counts, a world of one on NCCL
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("S", [76, 140])
@pytest.mark.parametrize("H", [6, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_kernels_at_mp_local_head_counts(cuda, H, S, dtype):
    """UC2's 12 heads over mp 2 and 4 ([B, S, 384], [B, S, 192]) at UC2's
    and M3P's S: K1, and B1 forward and backward at rate 0.1 with mp rank
    1's seed (ops/attention.shard_seed), against their plain versions with
    test_flat_train_kernels_match_plain's tolerances; the realized keep
    mask is the plain mask of the offset seed, and not rank 0's."""
    q, k, v, bias = _attention_inputs(cuda, 8, S, H, 64, dtype)
    got = TA.fused_attention_flat(q, k, v, bias, H)
    want = TA.fused_attention_flat_plain(q, k, v, bias, H)
    scale = want.float().abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else _bf16_ulp(scale)
    assert (got.float() - want.float()).abs().max().item() <= tol
    seed = TA.shard_seed(1234, 1)
    w = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    kw = dict(dropout_rate=0.1, seed=seed)
    got = _train_grads(TA.fused_attention_train_flat, q, k, v, bias, w, H=H, **kw)
    want = _train_grads(TA.fused_attention_train_flat_plain, q, k, v, bias, w,
                        H=H, **kw)
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        scale = want[i].float().abs().max().item()
        if dtype == torch.float32:
            tol = 1e-5 if i == 0 else 2e-4 * scale
        else:
            tol = _bf16_ulp(scale) * (1 if i == 0 else 2)
        assert (got[i].float() - want[i].float()).abs().max().item() <= tol, name
    assert (got[4] - want[4]).abs().max().item() <= 1e-4 * want[4].abs().max().item()
    t = TA.keep_threshold(0.1)
    mask = TA.realized_keep_mask(seed, 4, H, S, 64, 0.1, cuda, dtype=dtype)
    assert torch.equal(mask, TA.dropout_keep_mask(seed, 4, H, S, t, cuda))
    assert not torch.equal(mask, TA.dropout_keep_mask(1234, 4, H, S, t, cuda))


@pytest.mark.cuda
def test_nccl_world_of_one_is_one_device_bit_for_bit(cuda, tmp_path):
    """A (dp 1, mp 1) world over NCCL: shard_train_step (bf16, dropout 0.1,
    the flat kernels, hd 64) gives make_train_step's parameters and metrics
    bit for bit over two steps, and shard_predict_step("flat")
    make_predict_step's predictions."""
    from clg_vqa_tpu_torch.config import UC2Config
    from clg_vqa_tpu_torch.eval import runner
    from clg_vqa_tpu_torch.models.uc2 import UC2
    from clg_vqa_tpu_torch.parallel import distributed, mesh as pm
    from clg_vqa_tpu_torch.train import loop, optim
    cfg = UC2Config(vocab_size=300, hidden_size=128, num_layers=2, num_heads=2,
                    intermediate_size=256, v_feature_size=64, num_locs=7,
                    pooler_size=128, clf_hidden_size=64, num_labels=40)
    r = np.random.RandomState(3)
    batch = {"input_ids": r.randint(3, 300, (2, 8, 11)).astype(np.int32),
             "input_mask": np.ones((2, 8, 11), np.int32),
             "features": r.randn(2, 8, 9, 64).astype(np.float32),
             "locs": r.rand(2, 8, 9, 7).astype(np.float32),
             "image_mask": np.ones((2, 8, 9), np.int32),
             "labels": r.randint(0, 40, (2, 8)).astype(np.int32)}
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    D = torch.rand(40, 40, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    distributed.initialize(f"file://{tmp_path}/rendezvous", 1, 0, device="cuda:0")
    try:
        mesh = pm.make_mesh()
        assert torch.distributed.get_backend() == "nccl"
        runs = []
        for sharded in (False, True):
            model = UC2(cfg, device=cuda, seed=1)
            opt = optim.make_optimizer([n for n, _ in model.named_parameters()], 1e-3)
            step = loop.make_train_step(opt, D, semantic_lambda=10.0, top_k=4,
                                        fused_attn="flat")
            if sharded:
                pm.shard_model(model, mesh)
                step = loop.shard_train_step(step, mesh)
            state = loop.TrainState(model, opt.init(dict(model.named_parameters())), 0)
            metrics = []
            for i in range(2):
                state, m = step(state, batch, i)
                metrics.append(m)
            predict = (runner.shard_predict_step(model, mesh, fused_attn="flat")
                       if sharded else runner.make_predict_step(model, fused_attn="flat"))
            runs.append((model, metrics, predict({k: v[0] for k, v in batch.items()})))
        (m1, ms1, p1), (m2, ms2, p2) = runs
        assert all(torch.equal(a, b) for a, b in zip(m1.parameters(), m2.parameters()))
        assert all(torch.equal(a[k], b[k]) for a, b in zip(ms1, ms2) for k in a)
        assert torch.equal(p1, p2)
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the gated zoo and the pretraining objective (no kernel of their own)
# ---------------------------------------------------------------------------

def _gated_fixture(name: str):
    import json
    from clg_vqa_tpu_torch.models.gated import GatedConfig
    g = np.load(Path(__file__).parent / "fixtures" / f"gated_golden_{name}.npz")
    cfg = GatedConfig.from_dict({**json.loads(str(g["cfg_json"])),
                                 "num_labels": g["logits"].shape[1]})
    sd = {k[len("sd::"):]: g[k] for k in g.files if k.startswith("sd::")}
    batch = {k: torch.from_numpy(np.asarray(g[k])) for k in
             ("input_ids", "input_mask", "features", "locs", "image_mask")}
    return g, cfg, sd, batch


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lxmert", "uniter", "vilbert", "visualbert",
                                  "vl-bert"])
def test_gated_forward_on_cuda_matches_cpu(cuda, name):
    """The five golden wirings on the card: fp32 logits equal the CPU's and
    the reference's within the golden tolerance (rtol 2e-4, atol 5e-5); bf16
    logits finite."""
    from clg_vqa_tpu_torch.utils.convert import from_volta
    g, cfg, sd, batch = _gated_fixture(name)
    cpu, gpu = from_volta(sd, cfg, device="cpu"), from_volta(sd, cfg, device=cuda)
    with torch.no_grad():
        want = cpu(batch)
        got = gpu({k: v.to(cuda) for k, v in batch.items()})
        bf16 = gpu({k: v.to(cuda) for k, v in batch.items()},
                   compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-4,
                               atol=5e-5)
    np.testing.assert_allclose(got.cpu().numpy(), g["logits"], rtol=2e-4,
                               atol=5e-5)
    assert bool(torch.isfinite(bf16).all())


@pytest.mark.cuda
def test_pretrain_loss_on_cuda_matches_cpu(cuda):
    """UC2's pretraining objective with all seven visual targets, fp32,
    nce_2048 on one draw of negatives: every loss on the card within 1e-4
    relative of the CPU's; its gradients reach the tied word embedding."""
    from clg_vqa_tpu_torch.config import UC2Config
    from clg_vqa_tpu_torch.models.pretrain import PretrainHeads, pretrain_loss
    from clg_vqa_tpu_torch.models.uc2 import UC2
    from clg_vqa_tpu_torch.ops.pretrain_losses import nce_negative_indices
    cfg = UC2Config(vocab_size=300, hidden_size=64, num_layers=2, num_heads=4,
                    intermediate_size=128, num_labels=8)
    targets = {ix: 1.0 for ix in "0123456"}
    r = np.random.RandomState(0)
    B, T, R = 4, 8, 6
    ids = r.randint(3, 300, (B, T))
    cls_ = r.rand(B, R, 1601).astype(np.float32)
    batch = {"input_ids": ids, "input_mask": np.ones((B, T), np.int64),
             "features": r.randn(B, R, 2048).astype(np.float32),
             "locs": r.rand(B, R, 7).astype(np.float32),
             "image_mask": np.ones((B, R), np.int64),
             "lm_labels": np.where(r.rand(B, T) < 0.3, ids, -1),
             "is_match": r.randint(0, 2, (B,)),
             "image_label": (r.rand(B, R) < 0.5).astype(np.int64),
             "image_cls": cls_ / cls_.sum(-1, keepdims=True),
             "obj_labels": r.randint(0, 1600, (B, R)),
             "obj_confs": r.rand(B, R).astype(np.float32),
             "attr_labels": r.randint(0, 400, (B, R)),
             "attr_confs": r.rand(B, R).astype(np.float32)}
    neg = nce_negative_indices(B, R, generator=torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", cuda):
        model = UC2(cfg, device="cpu", seed=0).to(dev)
        heads = PretrainHeads(cfg, visual_target_weights=targets, device="cpu",
                              seed=1).to(dev)
        losses = pretrain_loss(
            model, heads, {k: torch.as_tensor(v).to(dev) for k, v in batch.items()},
            visual_target_weights=targets, neg_idx=neg.to(dev))
        losses["total"].backward()
        out[str(dev)] = ({k: v.item() for k, v in losses.items()},
                         model.embeddings.word.grad.cpu())
    (want, gw), (got, gg) = out["cpu"], out[str(cuda)]
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), k
    assert float(gg.abs().max()) > 0
    np.testing.assert_allclose(gg.numpy(), gw.numpy(), rtol=1e-3, atol=1e-6)


@pytest.mark.cuda
def test_gated_run_eval_launches_the_bank_gather_only(cuda, tmp_path):
    """run_eval of a gated model with the device bank: one K2 launch a
    batch, no attention kernel (the gated wiring runs plain attention
    whatever fused_attn says), predictions equal to the host-feature run."""
    from clg_vqa_tpu_torch.data.synthetic import eval_world
    from clg_vqa_tpu_torch.eval.runner import run_eval
    from clg_vqa_tpu_torch.models.gated import Gated
    _, cfg, _, _ = _gated_fixture("vilbert")
    import dataclasses
    cfg = dataclasses.replace(cfg, v_feature_size=2048, num_labels=16)
    w = eval_world(str(tmp_path), 96, num_labels=16, vocab_size=cfg.vocab_size,
                   n_images=20, num_locs=cfg.num_locs, device=cuda)
    model = Gated(cfg, device=cuda, seed=0)
    before = (TG.rows_gather.launches, TA.fused_attention_flat.launches,
              TA.fused_attention.launches)
    res = run_eval(model, w.dataset, w.label2ans, batch_size=32,
                   device_bank=w.bank, fused_attn="flat")
    torch.cuda.synchronize()
    after = (TG.rows_gather.launches, TA.fused_attention_flat.launches,
             TA.fused_attention.launches)
    assert [a - b for a, b in zip(after, before)] == [3, 0, 0]
    host = run_eval(model, w.dataset, w.label2ans, batch_size=32)
    assert res["n"] == host["n"] == 96
    assert [x["prediction"] for x in res["results"]] == \
        [x["prediction"] for x in host["results"]]


# ---------------------------------------------------------------------------
# M3P generation and the native CFS gather (host code, run on the card's
# machine too)
# ---------------------------------------------------------------------------

GEN_FIXTURE = Path(__file__).resolve().parent / "fixtures" / "m3p_gen_golden.npz"


def _golden_gen(device):
    """The reference's golden generation world through the port's
    converters: (fixture, M3P, M3PGen) on ``device``."""
    from clg_vqa_tpu_torch.config import M3PConfig
    from clg_vqa_tpu_torch.models.m3p import M3P
    from clg_vqa_tpu_torch.models.m3p_gen import M3PGen
    from clg_vqa_tpu_torch.utils import convert as TC
    g = np.load(GEN_FIXTURE)
    sd = {k[len("sd::"):]: np.asarray(g[k]) for k in g.files if k.startswith("sd::")}
    H = sd["embeddings.weight"].shape[1]
    cfg = M3PConfig(vocab_size=sd["embeddings.weight"].shape[0], hidden_size=H,
                    num_layers=int(g["n_layers"]), num_heads=4,
                    intermediate_size=4 * H, num_locs=5, pooler_size=H,
                    clf_hidden_size=2 * H)
    model = TC.load_numpy_state(
        M3P(cfg, device=device),
        TC.volta_m3p_to_state_dict({"bert.encoder." + k: v for k, v in sd.items()},
                                   cfg), allow_missing=("classifier.",))
    rl = int(g["refine_layers"])
    gen = TC.load_numpy_state(M3PGen(cfg, refine_layers=rl, device=device),
                              TC.m3p_gen_components_to_state_dict(sd, cfg,
                                                                  refine_layers=rl))
    return g, model, gen


@pytest.mark.cuda
def test_m3p_gen_golden_decodes_token_exact_on_cuda(cuda):
    """Greedy and beam decoding of the reference's golden world on the card,
    token for token and length for length."""
    from clg_vqa_tpu_torch.models import m3p_gen as tg
    g, model, gen = _golden_gen(cuda)
    src = torch.from_numpy(g["src_enc"]).to(cuda)
    src_len = torch.from_numpy(g["src_len"]).to(cuda)
    out, gen_len = tg.generate_greedy(model, gen, src, src_len, max_len=12)
    ref = np.asarray(g["gen"])
    np.testing.assert_array_equal(out.cpu().numpy()[:ref.shape[0]], ref)
    np.testing.assert_array_equal(gen_len.cpu().numpy(), g["gen_len"])
    dec, tgt_len = tg.generate_beam(model, gen, src, src_len, beam_size=3,
                                    length_penalty=1.0, early_stopping=False,
                                    max_len=12, lang_id=0)
    ref = np.asarray(g["beam"])
    np.testing.assert_array_equal(tgt_len.cpu().numpy(), g["beam_len"])
    np.testing.assert_array_equal(dec.cpu().numpy()[:ref.shape[0]], ref)
    # the stop test on the card: a pinned copy read one step late
    stats = {}
    tg.generate_greedy(model, gen, src, src_len, max_len=12, stats=stats)
    assert stats["host_waits"] == stats["steps"] - 1


@pytest.mark.cuda
def test_generation_refuses_a_sharded_m3p(cuda):
    """A vocabulary shard (mp > 1) is refused, not gathered."""
    from types import SimpleNamespace

    from clg_vqa_tpu_torch.models import m3p_gen as tg
    g, model, gen = _golden_gen(cuda)
    model.embeddings.mesh = SimpleNamespace(n_mp=2)
    src = torch.from_numpy(g["src_enc"]).to(cuda)
    with pytest.raises(ValueError, match="vocabulary shard"):
        tg.generate_greedy(model, gen, src,
                           torch.from_numpy(g["src_len"]).to(cuda), max_len=4)


@pytest.mark.cuda
@pytest.mark.parametrize("norm,glob", [(False, None), (True, None), (True, "first"),
                                       (False, "last")])
def test_native_gather_is_the_python_path_bit_for_bit(cuda, tmp_path, norm, glob):
    """The native CFS gather, built on this machine from the port's source,
    equals the Python path bit for bit, and the device bank built through it
    equals the one built through the Python path."""
    from clg_vqa_tpu_torch.data.cfs import CfsReader
    from clg_vqa_tpu_torch.data.synthetic import write_store
    path = str(tmp_path / "s.cfs")
    write_store(path, np.random.RandomState(0), n_images=40, regions=100,
                min_regions=10)
    rd = CfsReader(path)
    idx = np.random.RandomState(1).randint(0, 40, 64)
    kw = dict(max_regions=100, num_locs=5, norm_embeddings=norm,
              add_global_imgfeat=glob)
    for a, b in zip(rd.gather(idx, **kw), rd.gather(idx, native=False, **kw)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# the train step's multi-tensor passes (csrc/multi_tensor.cu)
# ---------------------------------------------------------------------------

from clg_vqa_tpu_torch.ops import multi_tensor as MT    # noqa: E402
from clg_vqa_tpu_torch.train import optim as TO          # noqa: E402

# 1 element, odd and misaligned lengths, a chunk and one more, and UC2's
# word embedding (250002 x 768, 2,930 chunks)
MT_RAGGED = [("tok.weight", (1,)), ("a.bias", (7,)), ("b.weight", (13, 5)),
             ("ln.weight", (1023,)), ("ln.bias", (4097,)),
             ("c.weight", (65537,)), ("word.weight", (250002, 768)),
             ("d.bias", (3,))]
# more tensors than one accumulation launch takes
MT_MANY = [(f"m{i}.{'bias' if i % 3 == 0 else 'weight'}", (i % 37 + 1, 3))
           for i in range(450)]


@pytest.fixture(scope="module")
def uc2_param_shapes():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from clg_vqa_tpu_torch.config import UC2Config
    from clg_vqa_tpu_torch.models.uc2 import UC2
    model = UC2(UC2Config(), device="cuda", seed=0)
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    del model
    torch.cuda.empty_cache()
    return shapes


def _mt_shapes(kind, request):
    if kind == "uc2":
        return request.getfixturevalue("uc2_param_shapes")
    return {"ragged": MT_RAGGED, "misaligned": MT_RAGGED, "many": MT_MANY}[kind]


def _mt_values(shapes, dev, gen, *, misaligned=False):
    """Random fp32 tensors of ``shapes``, each of its own magnitude; where
    ``misaligned``, views of one buffer starting off 16 bytes."""
    out, offset = [], 1
    flat = (torch.empty(sum(int(np.prod(s)) for _, s in shapes) + 1,
                        device=dev) if misaligned else None)
    for i, (_, s) in enumerate(shapes):
        t = torch.randn(s, device=dev, generator=gen) * 4.0 ** (i % 5 - 2)
        if misaligned:
            n = t.numel()
            t = flat[offset:offset + n].view(s).copy_(t)
            offset += n
        out.append(t)
    return out


def _mt_masks(shapes, dev, gen):
    return [(torch.rand(s, device=dev, generator=gen) > 0.4).float()
            if n.endswith("weight") else None for n, s in shapes]


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ragged", "many", "uc2"])
@pytest.mark.parametrize("acc", [1, 2, 3])
def test_multi_tensor_accumulate_is_eager_bit_for_bit(cuda, request, kind, acc):
    """Over acc microbatches, some gradients None and one microbatch's
    sources off 16 bytes, the buffers equal zeros_like + add_(g / acc) on
    the card bit for bit, whatever the last step left in them."""
    shapes = _mt_shapes(kind, request)
    gen = torch.Generator(cuda).manual_seed(acc)
    buf = MT.GradBuffers([torch.empty(s, device=cuda) for _, s in shapes])
    buf.flat.fill_(7.0)
    want = [torch.zeros_like(v) for v in buf.views]
    for a in range(acc):
        gs = _mt_values(shapes, cuda, gen, misaligned=a == 1)
        gs = [None if (i + a) % 5 == 0 else g for i, g in enumerate(gs)]
        before = MT.accumulate.launches
        MT.accumulate(buf, gs, first=a == 0, n=acc)
        assert MT.accumulate.launches == before + -(-len(shapes) // MT.MAX_SOURCES)
        for w, g in zip(want, gs):
            if g is not None:
                w.add_(g / acc)
        del gs
    torch.cuda.synchronize()
    for (name, _), v, w in zip(shapes, buf.views, want):
        assert torch.equal(_bits(v), _bits(w)), name


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ragged", "misaligned", "many", "uc2"])
@pytest.mark.parametrize("masked", [False, True])
def test_multi_tensor_norm_sums_match_and_repeat(cuda, request, kind, masked):
    """Each tensor's sum of squares within 1e-6 relative of (t * t).sum()
    and of the fp64 sum, the norm the root of their ordered sum, and two
    launches bit-identical (no atomics)."""
    shapes = _mt_shapes(kind, request)
    gen = torch.Generator(cuda).manual_seed(11)
    ts = _mt_values(shapes, cuda, gen, misaligned=kind == "misaligned")
    masks = _mt_masks(shapes, cuda, gen) if masked else None
    runs = []
    for _ in range(2):
        sums = []
        before = MT.norm.launches
        out = MT.norm(ts, masks, reduce=lambda sq: sums.append(sq.clone()) or sq)
        assert MT.norm.launches == before + 3
        runs.append((out, sums[0]))
    torch.cuda.synchronize()
    (out, sq), (out2, sq2) = runs
    assert torch.equal(_bits(out), _bits(out2)) and torch.equal(_bits(sq), _bits(sq2))
    xs = ts if masks is None else [t if m is None else t * m
                                   for t, m in zip(ts, masks)]
    ref32 = torch.stack([(x * x).sum() for x in xs])
    ref64 = torch.stack([(x.double() * x.double()).sum() for x in xs])
    assert ((sq.double() - ref64).abs() <= 1e-6 * ref64).all()
    assert ((sq - ref32).abs() <= 1e-6 * ref32).all()
    assert torch.equal(_bits(out), _bits(torch.sqrt(sum(sq.unbind()))))
    assert torch.equal(out, TO.global_norm(ts, masks))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ragged", "misaligned", "uc2"])
@pytest.mark.parametrize("target", [0.5, 3.0])             # clip idle / engaged
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("correct_bias", [True, False])
def test_multi_tensor_adamw_is_the_plain_chain_bit_for_bit(
        cuda, request, kind, target, masked, correct_bias):
    """make_optimizer's apply on the card equals its update plus the masked
    p.add_ on the card, bit for bit in p, mu and nu, over two steps, given
    the same norm: the clip engaged and idle, with and without a 40% grad
    mask, with and without bias correction, decay off for biases and LN."""
    shapes = _mt_shapes(kind, request)
    names = [n for n, _ in shapes]
    gen = torch.Generator(cuda).manual_seed(3)
    mis = kind == "misaligned"
    p0 = _mt_values(shapes, cuda, gen, misaligned=mis)
    mine = dict(zip(names, p0))
    ref = {k: p.clone() for k, p in mine.items()}
    opt = TO.make_optimizer(names, TO.warmup_linear_schedule(1e-2, 0, 10),
                            weight_decay=0.01, correct_bias=correct_bias)
    st_mine, st_ref = opt.init(mine), opt.init(ref)
    mask = dict(zip(names, _mt_masks(shapes, cuda, gen))) if masked else None
    masks = None if mask is None else list(mask.values())
    for _ in range(2):
        grads = dict(zip(names, _mt_values(shapes, cuda, gen, misaligned=mis)))
        scale = target / TO.global_norm(grads.values(), masks)
        for g in grads.values():
            g.mul_(scale)
        norm = TO.global_norm(grads.values(), masks)
        before = MT.adamw.launches
        st_mine = opt.apply(grads, st_mine, mine, norm=norm, mask=mask)
        assert MT.adamw.launches == before + 1
        masked_g = {k: g if mask is None or mask[k] is None else g * mask[k]
                    for k, g in grads.items()}
        updates, st_ref = opt.update(masked_g, st_ref, ref, norm=norm)
        for k, p in ref.items():
            u = updates[k]
            if mask is not None and mask[k] is not None:
                u = u * mask[k]
            p.add_(u)
        assert bool(norm < 1.0) == (target < 1.0), norm.item()
    torch.cuda.synchronize()
    assert st_mine.count == st_ref.count == 2
    for k in names:
        assert torch.equal(_bits(mine[k]), _bits(ref[k])), k
        assert torch.equal(_bits(st_mine.mu[k]), _bits(st_ref.mu[k])), k
        assert torch.equal(_bits(st_mine.nu[k]), _bits(st_ref.nu[k])), k


@pytest.mark.cuda
def test_multi_tensor_kernels_refuse_what_they_do_not_take(cuda):
    """A CUDA tensor the kernels do not take raises; nothing falls back."""
    names = ["a.weight", "a.bias"]
    opt = TO.make_optimizer(names, 1e-3)
    good = {k: torch.randn(4, 3, device=cuda) for k in names}
    norm = torch.ones((), device=cuda)
    for bad in (good["a.bias"].bfloat16(),
                torch.randn(4, 3, 2, device=cuda)[:, :, 0],
                good["a.bias"].cpu()):
        params = dict(good, **{"a.bias": bad})
        st = opt.init(good)
        with pytest.raises(ValueError):
            opt.apply(good, st, params, norm=norm)
    with pytest.raises(ValueError):
        MT.norm([good["a.weight"].half(), good["a.bias"]])
    buf = MT.GradBuffers(list(good.values()))
    with pytest.raises(ValueError):
        MT.accumulate(buf, [good["a.weight"].bfloat16(), None], first=True, n=2)


@pytest.mark.cuda
def test_train_step_on_the_kernels_is_the_eager_step_bit_for_bit(cuda):
    """A tiny UC2's fp32 step under a 40% grad mask: through apply (one
    adamw launch a step, the norm once) and through update plus the add
    loop, the same metrics and parameters bit for bit over 3 steps."""
    from clg_vqa_tpu_torch.config import UC2Config
    from clg_vqa_tpu_torch.models.uc2 import UC2
    from clg_vqa_tpu_torch.train import loop as TLoop
    cfg = UC2Config(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                    intermediate_size=64, v_feature_size=16, num_locs=7,
                    pooler_size=32, clf_hidden_size=32, num_labels=8)
    r = np.random.RandomState(0)
    batches = [{"input_ids": torch.from_numpy(r.randint(3, 64, (2, 4, 6))),
                "input_mask": torch.ones(2, 4, 6, dtype=torch.int32),
                "features": torch.from_numpy(r.randn(2, 4, 4, 16).astype(np.float32)),
                "locs": torch.from_numpy(r.rand(2, 4, 4, 7).astype(np.float32)),
                "image_mask": torch.ones(2, 4, 4, dtype=torch.int32),
                "labels": torch.from_numpy(r.randint(0, 8, (2, 4)))}
               for _ in range(3)]
    D = torch.from_numpy(r.rand(8, 8).astype(np.float32)).to(cuda)
    runs = []
    for with_apply in (True, False):
        model = UC2(cfg, device=cuda, seed=0)
        params = dict(model.named_parameters())
        gm = torch.Generator(cuda).manual_seed(1)
        mask = {k: (torch.rand(p.shape, device=cuda, generator=gm) > 0.4).float()
                if k.endswith("weight") else None for k, p in params.items()}
        opt = TO.make_optimizer(list(params), 1e-2, weight_decay=0.01)
        if not with_apply:
            opt = opt._replace(apply=None)
        step = TLoop.make_train_step(opt, D, semantic_lambda=10.0, top_k=4,
                                     compute_dtype=None, grad_mask=mask)
        state = TLoop.TrainState(model, opt.init(params), 0)
        counts = (MT.accumulate.launches, MT.norm.launches, MT.adamw.launches)
        metrics = []
        for i, b in enumerate(batches):
            state, m = step(state, {k: v.to(cuda) for k, v in b.items()}, seed=i)
            metrics.append(m)
        counts = [now - was for now, was in zip(
            (MT.accumulate.launches, MT.norm.launches, MT.adamw.launches), counts)]
        runs.append((metrics, {k: p.detach().clone() for k, p in params.items()},
                     counts))
    torch.cuda.synchronize()
    (m1, p1, c1), (m2, p2, c2) = runs
    assert c1 == [2 * 3, 3 * 3, 3] and c2 == [2 * 3, 2 * 3 * 3, 0]
    for a, b in zip(m1, m2):
        assert all(torch.equal(_bits(a[k]), _bits(b[k])) for k in a)
    assert all(torch.equal(_bits(p1[k]), _bits(p2[k])) for k in p1)


# ---------------------------------------------------------------------------
# the grouped expert products (csrc/grouped_gemm.cu, ops/moe.py)
# ---------------------------------------------------------------------------

def _moe_case(dev, case, T=300, k=2, n=8, E=4, first=2):
    """Router picks [T, k] of n experts for an uneven, an empty-group and an
    all-in-one-group case."""
    g = torch.Generator().manual_seed(7)
    idx = torch.stack([torch.randperm(n, generator=g)[:k] for _ in range(T)])
    if case == "empty":
        idx[idx == first + 1] = (first + E) % n     # held expert 1 takes none
    elif case == "one":
        idx[:, 0] = first + 2                       # every token in expert 2
        idx[:, 1] = (first + E) % n                 # and one not held
    return idx.to(dev)


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uneven", "empty", "one"])
@pytest.mark.parametrize("H,I", [(256, 128), (512, 384)])
def test_grouped_products_match_the_per_expert_loop(cuda, case, H, I):
    """Each grouped product against ops/moe's plain per-expert loop on the
    card, from the same padded buffers: bf16 outputs within 2e-3 of the
    loop's (the same fp32 sums in another order, one rounding), the fp32
    weight gradients within 1e-5 (the tensor cores' sums of exact bf16
    products against fp32 ones); an empty group's gradients are 0."""
    from clg_vqa_tpu_torch.ops import moe
    E = 4
    d = moe.dispatch(_moe_case(cuda, case), 2, E)
    g = torch.Generator(cuda).manual_seed(1)
    R = d.rows + 1
    x = torch.randn(300 * 2, H, device=cuda, generator=g).to(torch.bfloat16)
    xd = moe._rows_buffer(x, d)
    w1 = (0.1 * torch.randn(E, 2 * I, H, device=cuda, generator=g)).to(torch.bfloat16)
    w2 = (0.1 * torch.randn(E, H, I, device=cuda, generator=g)).to(torch.bfloat16)
    dy = moe._rows_buffer(torch.randn(600, H, device=cuda, generator=g).to(torch.bfloat16), d)
    n0 = dict(moe.launches)
    # each product's plain version reads the kernel's own inputs, so that
    # the comparison sees one product's arithmetic and not the roundings
    # of the products before it
    gu, act = moe.grouped_swiglu(xd, w1, d.poff, d.tiles)
    pgu, pact = moe.swiglu_plain(xd, w1, d.poff)
    y, py = moe.grouped_rows(act, w2, d.poff, d.tiles, True), moe.rows_plain(act, w2, d.poff, True)
    dgu = moe.grouped_dswiglu(dy, w2, gu, d.poff, d.tiles)
    pdgu = moe.dswiglu_plain(dy, w2, gu, d.poff)
    dx = moe.grouped_rows(dgu, w1, d.poff, d.tiles, False)
    pdx = moe.rows_plain(dgu, w1, d.poff, False)
    dw2, pdw2 = moe.grouped_wgrad(dy, act, d.poff), moe.wgrad_plain(dy, act, d.poff)
    dw1, pdw1 = moe.grouped_wgrad(dgu, xd, d.poff), moe.wgrad_plain(dgu, xd, d.poff)
    torch.cuda.synchronize()
    assert {k: moe.launches[k] - n0[k] for k in n0} == {
        "swiglu": 1, "rows": 2, "dswiglu": 1, "wgrad": 2}
    top = int(d.poff[-1])
    for a, b in ((gu, pgu), (act, pact), (y, py), (dgu, pdgu), (dx, pdx)):
        assert a.shape[0] == R
        assert _rel(a[:top], b[:top]) <= 2e-3
    assert _rel(dw2, pdw2) <= 1e-5 and _rel(dw1, pdw1) <= 1e-5
    assert dw1.dtype == torch.float32 and dw1.shape == (E, 2 * I, H)
    if case == "empty":
        assert dw1[1].abs().sum() == 0 and dw2[1].abs().sum() == 0
    if case == "one":
        assert int(d.counts[2]) == 300 and int(d.counts.sum()) == 300


@pytest.mark.cuda
def test_routed_experts_on_the_kernel_match_the_plain_path(cuda):
    """ops/moe.routed_experts at the benchmark's widths (H 2048, I 1408, 8
    of 64 experts, top-6, 1,024 tokens): forward and every gradient on the
    kernels against the same function with the plain products."""
    from clg_vqa_tpu_torch.ops import moe
    g = torch.Generator(cuda).manual_seed(3)
    T, H, I, E = 1024, 2048, 1408, 8
    logits = torch.randn(T, 64, device=cuda, generator=g)
    idx, w = moe.route(logits, torch.zeros(64, device=cuda), 6, 2.446)
    d = moe.dispatch(idx, 0, E, expected=E / 64)
    x = torch.randn(T, H, device=cuda, generator=g).to(torch.bfloat16)
    w1 = 0.05 * torch.randn(E, 2 * I, H, device=cuda, generator=g)
    w2 = 0.05 * torch.randn(E, H, I, device=cuda, generator=g)
    cot = torch.randn(T, H, device=cuda, generator=g)
    outs = []
    for plain in (False, True):
        leaves = [t.detach().clone().requires_grad_() for t in (x, w, w1, w2)]
        if plain:
            saved = (moe.grouped_swiglu, moe.grouped_rows, moe.grouped_dswiglu,
                     moe.grouped_wgrad)
            moe.grouped_swiglu = lambda a, b, p, t: moe.swiglu_plain(a, b, p)
            moe.grouped_rows = lambda a, b, p, t, km: moe.rows_plain(a, b, p, km)
            moe.grouped_dswiglu = lambda a, b, c, p, t: moe.dswiglu_plain(a, b, c, p)
            moe.grouped_wgrad = moe.wgrad_plain
        try:
            out = moe.routed_experts(leaves[0], leaves[1], leaves[2], leaves[3], d)
            grads = torch.autograd.grad((out * cot).sum(), leaves)
        finally:
            if plain:
                (moe.grouped_swiglu, moe.grouped_rows, moe.grouped_dswiglu,
                 moe.grouped_wgrad) = saved
        outs.append((out, *grads))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert _rel(a, b) <= 3e-3


@pytest.mark.cuda
def test_grouped_kernel_refuses_what_its_tiles_do_not_take(cuda):
    from clg_vqa_tpu_torch.ops import moe
    d = moe.dispatch(_moe_case(cuda, "uneven"), 2, 4)
    xd = torch.zeros(d.rows + 1, 256, device=cuda, dtype=torch.bfloat16)
    w1 = torch.zeros(4, 2 * 96, 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        moe.grouped_swiglu(xd, w1, d.poff, d.tiles)          # I = 96: no 128 tiles
    with pytest.raises(ValueError, match="bf16"):
        moe.grouped_swiglu(xd.float(), w1.float(), d.poff, d.tiles)


@pytest.mark.cuda
def test_kimi_vl_step_issues_without_a_host_sync(cuda):
    """A bf16 train step of a narrow Kimi-VL (two expert layers on the
    grouped kernels) under the profiler: between train.step's open and
    close the host neither synchronises with the card nor copies from it
    into pageable memory; the only device-to-host copies are the counters'
    non-blocking ones into pinned memory. The counters read the pairs
    routed to the held experts, layer by layer and microbatch by
    microbatch."""
    from clg_vqa_tpu_torch.config import KimiVLConfig
    from clg_vqa_tpu_torch.models.kimi_vl import KimiVL
    from clg_vqa_tpu_torch.ops import moe
    from clg_vqa_tpu_torch.train.loop import TrainState, make_train_step
    from clg_vqa_tpu_torch.train.optim import make_optimizer, warmup_constant_schedule
    from clg_vqa_tpu_torch.utils import profiling
    cfg = KimiVLConfig(vocab_size=300, hidden_size=128, num_layers=3, num_heads=2,
                       kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
                       v_head_dim=32, intermediate_size=256, moe_intermediate_size=128,
                       n_shared_experts=1, router_experts=16, held_experts=4,
                       first_expert=4, experts_per_token=4, v_feature_size=64,
                       projector_hidden_size=128, clf_hidden_size=64, num_labels=40)
    model = KimiVL(cfg, device=cuda, seed=0)
    r = np.random.RandomState(0)
    T, R = 12, 6
    ids = r.randint(3, 300, (2, 8, T)).astype(np.int64)
    batch = {"input_ids": ids, "input_mask": np.ones_like(ids),
             "features": r.randn(2, 8, R, 64).astype(np.float32),
             "locs": r.rand(2, 8, R, 5).astype(np.float32),
             "image_mask": np.ones((2, 8, R), np.int64),
             "labels": r.randint(0, 40, (2, 8)).astype(np.int64)}
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    params = dict(model.named_parameters())
    opt = make_optimizer(list(params), warmup_constant_schedule(1e-5, 0))
    state = TrainState(model, opt.init(params), 0)
    step = make_train_step(opt, torch.rand(40, 40, device=cuda), semantic_lambda=1.0,
                           compute_dtype=torch.bfloat16, fused_attn="auto")
    state, _ = step(state, batch, seed=0)        # builds and warms up
    torch.cuda.synchronize()
    n0 = dict(moe.launches)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        state, m = step(state, batch, seed=1)
        torch.cuda.synchronize()
    assert {k: moe.launches[k] - n0[k] for k in n0} == {
        "swiglu": 4, "rows": 8, "dswiglu": 4, "wgrad": 8}
    events = prof.events()
    (s0, s1), = [(e.time_range.start, e.time_range.end) for e in events
                 if e.name == "train.step" and e.device_type == torch.autograd.DeviceType.CPU]
    inside = [e for e in events if s0 <= e.time_range.start < s1]
    syncs = [e.name for e in inside if e.name in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
        "cudaMemcpy")]
    pageable = [e.name for e in inside if "DtoH" in e.name and "Pinned" not in e.name]
    assert not syncs and not pageable, (syncs, pageable)
    pairs = [c for c in profiling.counter_records() if c.name == "moe.pairs"]
    assert len(pairs) == 2 * 2
    assert all(0 < int(c.values) <= 8 * (T + R) * 4 for c in pairs)
    assert np.isfinite(m["loss"].item())
