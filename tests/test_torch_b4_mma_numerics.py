"""The numerics of B4's bf16 kernels (clg_vqa_tpu_torch/csrc/
block_attention_train.cu), emulated on the CPU.

B4's products run on wgmma (csrc/gemm_wgmma.cuh): bf16 operands, exact
products summed in fp32, the epilogues of the plain version (the fp32 bias on
the fp32 accumulator and one cast; each dW rounded once; dx = (dxq + dxk) +
dxv in bf16), so the plain version's products stand for them here. Its core
is B1's tensor-core attention (csrc/attention_train_mma.cuh), whose
arithmetic tests/test_torch_b3_mma_numerics.emulate gives. The core's
backward takes dctx = g Wo, an fp32 product, as two bf16 terms, hi =
bf16(dctx) and lo = bf16(dctx - hi), each product that reads it issued for
both: the emulation feeds it do = hi + lo.

At UC2's pattern (padded keys at the finite -10000; S 40, 4 heads of 64)
the emulated block is held to chip_smoke.py:block_errors' bf16 tolerances (y
within two bf16 ulps of its largest value, every gradient within 1e-2 of
its scale) and its key-bias gradient, the core's, to B1's 1e-4 gate:
- against the value and jax.vjp gradients of JAX's fused_attention_block at
  rate 0, its Pallas kernels in interpret mode as the JAX package's own
  tests run them;
- against the port's plain version at rate 0.1, on the Philox keep mask,
  with the core's dq, dk and dv also within two bf16 ulps of the plain
  core's.
One case records the design's choice: one bf16 rounding of dctx moves the
bias gradient past its gate, and hi + lo keeps it inside."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from clg_vqa_tpu.ops import attention as JA
from clg_vqa_tpu_torch.ops import attention as TA
from clg_vqa_tpu_torch.ops import block_attention as TB
from test_torch_b3_mma_numerics import HD, H, S, _errors, emulate

torch.set_num_threads(1)

B = 4
D = H * HD
RATE = 0.1
NAMES = ("x", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "bias")


def _world(seed):
    """bf16-valued numpy x [B, S, D], weights in PyTorch's [out, in] layout,
    fp32 biases, UC2's key bias [B, S] (0 on a prefix of S//2..S keys,
    -10000 on the padded ones) and a bf16-valued cotangent g [B, S, D]."""
    r = np.random.RandomState(seed)

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()

    x = bf(r.randn(B, S, D))
    ws = [bf(r.randn(D, D) / np.sqrt(D)) for _ in range(4)]
    bs = [(r.randn(D) * 0.1).astype(np.float32) for _ in range(4)]
    lens = r.randint(S // 2, S + 1, B)
    lens[0] = S // 2
    bias = np.where(np.arange(S)[None, :] < lens[:, None], 0.0, -10000.0).astype(np.float32)
    return x, ws, bs, bias, bf(r.randn(B, S, D))


def _hm(t: torch.Tensor) -> np.ndarray:
    """[B, S, D] -> numpy [B, H, S, hd]."""
    return t.double().view(B, S, H, HD).transpose(1, 2).contiguous().numpy()


def _flat(a) -> torch.Tensor:
    """[B, H, S, hd] -> [B*S, D] float64."""
    return torch.as_tensor(a).double().transpose(1, 2).reshape(B * S, D)


def _emulated(x, ws, bs, bias, g, keep=None, keep_t=256, *, hilo=True):
    """The bf16 block as the kernels compute it: y, the gradients in the
    order of NAMES (the key bias's as [B, S]) and the core's (dq, dk, dv,
    dbias)."""
    xb = torch.from_numpy(x).bfloat16()
    wb = [torch.from_numpy(w).bfloat16() for w in ws]
    bt = [torch.from_numpy(b) for b in bs]
    x2 = xb.reshape(B * S, D)
    q, k, v = (TB._proj(x2, w, b) for w, b in zip(wb[:3], bt[:3]))
    g2 = torch.from_numpy(g).bfloat16().reshape(B * S, D)
    dctx = TB._mm(g2, wb[3])                       # fp32, the core's do
    hi = dctx.bfloat16().double()
    do = hi + (dctx.double() - hi).float().bfloat16().double() if hilo else hi
    out, dq, dk, dv, dbias = emulate(
        *(_hm(t.reshape(B, S, D)) for t in (q, k, v, do)), bias, keep, keep_t)
    ctx = _flat(out).bfloat16()
    y = TB._proj(ctx, wb[3], bt[3]).view(B, S, D)
    dq, dk, dv = (_flat(t).bfloat16() for t in (dq, dk, dv))
    pairs = ((dq, x2, wb[0]), (dk, x2, wb[1]), (dv, x2, wb[2]), (g2, ctx, wb[3]))
    dw = [TB._mm(dy.t(), a).bfloat16() for dy, a, _ in pairs]
    db = [dy.float().sum(0) for dy, _, _ in pairs]
    dxq, dxk, dxv = (TB._mm(dy, w).bfloat16() for dy, _, w in pairs[:3])
    dx = ((dxq + dxk) + dxv).view(B, S, D)
    grads = [dx, dw[0], db[0], dw[1], db[1], dw[2], db[2], dw[3], db[3],
             dbias.float()]
    return y, grads, (dq, dk, dv, dbias)


def _jax_rate0(x, ws, bs, bias, g):
    """JAX's fused_attention_block in bf16 at rate 0 and its jax.vjp
    gradients (weights back in [out, in]), in interpret mode."""
    args = [jnp.asarray(x, jnp.bfloat16)]
    for w, b in zip(ws, bs):
        args += [jnp.asarray(w.T, jnp.bfloat16), jnp.asarray(b)]
    args.append(jnp.asarray(bias)[:, None, None, :])
    with pltpu.force_tpu_interpret_mode():
        y, vjp = jax.vjp(lambda *a: JA.fused_attention_block(*a, H), *args)
        grads = vjp(jnp.asarray(g, jnp.bfloat16))
    f = lambda t: torch.from_numpy(np.array(jnp.asarray(t, jnp.float32)))  # noqa: E731
    grads = [f(t).t() if n[0] == "w" else f(t) for t, n in zip(grads, NAMES)]
    grads[-1] = grads[-1][:, 0, 0, :]
    return f(y), grads


def _plain(x, ws, bs, bias, g, **kw):
    """The port's plain version in bf16, differentiated by autograd."""
    args = [torch.from_numpy(x).bfloat16()]
    for w, b in zip(ws, bs):
        args += [torch.from_numpy(w).bfloat16(), torch.from_numpy(b)]
    args.append(torch.from_numpy(bias)[:, None, None, :])
    args = [a.requires_grad_() for a in args]
    y = TB.fused_attention_block_plain(*args, H, **kw)
    grads = list(torch.autograd.grad(y, args, torch.from_numpy(g).bfloat16()))
    grads[-1] = grads[-1][:, 0, 0, :]
    return y.detach(), grads


def _plain_core(x, ws, bs, bias, g, seed):
    """The plain version's core gradients (fp32 do = dctx), as dq, dk, dv
    [B*S, D] and the bias gradient [B, S] summed over heads in order."""
    xb = torch.from_numpy(x).bfloat16().reshape(B * S, D)
    wb = [torch.from_numpy(w).bfloat16() for w in ws]
    q, k, v = (TB._proj(xb, w, torch.from_numpy(b)).view(B, S, D)
               for w, b in zip(wb[:3], bs[:3]))
    dctx = TB._mm(torch.from_numpy(g).bfloat16().reshape(B * S, D), wb[3])
    dq, dk, dv, dbh = TB._core_backward_plain(
        q, k, v, torch.from_numpy(bias), dctx.view(B, S, D), H,
        TA.keep_threshold(RATE), seed)
    db = dbh[:, 0]
    for h in range(1, H):
        db = db + dbh[:, h]
    return [t.reshape(B * S, D) for t in (dq, dk, dv)] + [db]


def _keep(seed):
    t = TA.keep_threshold(RATE)
    return TA.dropout_keep_mask(seed, B, H, S, t), t


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _block_ratios(got, want) -> dict:
    """Each result's largest error over chip_smoke.py:block_errors' bf16
    tolerance; the key-bias gradient also over B1's 1e-4 gate."""
    (y, grads), (wy, wgrads) = got, want
    scales = [t.float().abs().max().item() for t in wgrads]
    scales[NAMES.index("bk")] = scales[NAMES.index("bq")]
    ymax = wy.float().abs().max().item()
    ratios = {"y": (y.double() - wy.double()).abs().max().item() / (2 * _bf16_ulp(ymax))}
    for name, a, w, sc in zip(NAMES, grads, wgrads, scales):
        assert torch.isfinite(a.double()).all(), name
        ratios[name] = (a.double() - w.double()).abs().max().item() / (1e-2 * sc)
    ratios["bias 1e-4"] = ratios["bias"] * 1e-2 / 1e-4
    return ratios


def test_emulated_block_matches_jax_vjp_at_rate0():
    world = _world(0)
    y, grads, _ = _emulated(*world)
    ratios = _block_ratios((y, grads), _jax_rate0(*world))
    assert all(r <= 1.0 for r in ratios.values()), ratios


@pytest.mark.parametrize("seed", [1, 2])
def test_emulated_block_matches_plain_version_with_dropout(seed):
    world = _world(seed)
    keep, t = _keep(seed)
    y, grads, core = _emulated(*world, keep, t)
    ratios = _block_ratios((y, grads), _plain(*world, dropout_rate=RATE, seed=seed))
    assert all(r <= 1.0 for r in ratios.values()), ratios
    # the core's gradients at B1's gates (out stands in: it is not compared)
    want = _plain_core(*world, seed)
    core_ratios = _errors((y.reshape(B * S, D), *core),
                          (y.reshape(B * S, D), *want))
    assert all(r <= 1.0 for r in core_ratios.values()), core_ratios


def test_one_bf16_rounding_of_dctx_misses_the_bias_gradient_gate():
    """Why dctx reaches the core as hi + lo: one bf16 rounding of the fp32
    product moves the core's bias gradient past B1's 1e-4 gate at UC2's
    -10000 padding, while the two terms keep it well inside."""
    world = _world(3)
    keep, t = _keep(3)
    want = _plain_core(*world, 3)
    ratios = {}
    for hilo in (True, False):
        y, _, core = _emulated(*world, keep, t, hilo=hilo)
        ratios[hilo] = _errors((y.reshape(B * S, D), *core), (y.reshape(B * S, D), *want))
    assert ratios[True]["dbias"] <= 0.5 and ratios[False]["dbias"] > 1.0, ratios
