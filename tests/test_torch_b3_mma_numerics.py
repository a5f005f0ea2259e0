"""The numerics of B3's bf16 tensor-core kernels
(clg_vqa_tpu_torch/csrc/attention_train_mma.cuh), emulated on the CPU.

The kernels cannot run here (no nvcc, no card), so this file holds a small
torch emulation of their arithmetic, in float64 with a rounding to float32
wherever the kernels keep a float32 value: bf16 operands; products of bf16
inputs summed exactly, then rounded to fp32 (the tensor cores' products are
exact and their sums fp32); the softmax normalised before dropout; p_d and
ds split into hi = bf16(x) and lo = bf16(x - hi) for the products that take
them as bf16 operands (P.V, dv; dk, dq); D = sum_j dp p exact. It is held
to the gates the card holds the kernels to (chip_smoke.py:grad_errors):
the output within one bf16 ulp of its largest value, dq/dk/dv within two,
the bias gradient within 1e-4 of its largest value:
- against JAX's fused_attention_train_hm at rate 0, run in interpret mode
  as the JAX package's own tests run it on the CPU;
- against the port's plain version at rate 0.1, on the Philox keep mask.
Two cases record the design's choices: D taken as rowsum(dO * O) from the
bf16 output (FlashAttention-2's shortcut) misses the bias-gradient gate,
and the emulation without the hi/lo splits drifts further from the plain
version than with them. The card tests (tests/test_torch_cuda.py) hold the
kernels themselves to the same plain version."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from clg_vqa_tpu.ops import attention as JA
from clg_vqa_tpu_torch.ops import attention as TA

torch.set_num_threads(1)

B, H, S, HD = 4, 4, 40, 64


def _inputs(seed=0):
    """bf16 q, k, v, do [B, H, S, hd] (as numpy float32 holding bf16
    values) and M3P's key bias: 0 on a prefix of S//2..S keys, -inf on the
    trailing ones."""
    r = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(r.randn(B, H, S, HD).astype(np.float32))
                   .bfloat16().float().numpy() for _ in range(4))
    lens = r.randint(S // 2, S + 1, B)
    lens[0] = S // 2
    bias = np.where(np.arange(S)[None, :] < lens[:, None], 0.0, -np.inf)
    return q, k, v, do, bias.astype(np.float32)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float().double()


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().double()


def _split(x: torch.Tensor, hilo: bool) -> torch.Tensor:
    """The bf16 operand the products see: hi + lo, or one bf16."""
    hi = _bf(x)
    return hi + _bf(_f32(x - hi)) if hilo else hi


def emulate(q, k, v, do, bias, keep=None, keep_t=256, *, hilo=True,
            d_from_output=False):
    """The kernels' arithmetic on numpy bf16-valued inputs: (out, dq, dk, dv)
    as float64 tensors holding bf16 values, and the bias gradient [B, S]
    summed over heads in order (fp32 values)."""
    qd, kd, vd, dod = (torch.from_numpy(x).double() for x in (q, k, v, do))
    b = torch.from_numpy(bias).double()[:, None, None, :]
    scale = float(np.float32(1.0 / math.sqrt(HD)))
    r = float(np.float32(256.0 / keep_t))
    kp = None if keep is None else torch.as_tensor(keep)

    def drop(x):
        return x if kp is None else torch.where(kp, _f32(x * r), 0.0)

    s = _f32(_f32(qd @ kd.transpose(-1, -2)) * scale + b)
    m = s.amax(-1, keepdim=True)
    e = _f32(torch.exp(s - m))
    inv_l = _f32(1.0 / _f32(e.sum(-1, keepdim=True)))
    # forward: P.V on the dropped, undivided e, then one division by l
    out = _bf(_f32(_f32(_split(drop(e), hilo) @ vd) * inv_l))
    # backward
    p = _f32(e * inv_l)
    dp = drop(_f32(dod @ vd.transpose(-1, -2)))
    if d_from_output:
        D = _f32((dod * out).sum(-1, keepdim=True))
    else:
        D = _f32((dp * p).sum(-1, keepdim=True))
    ds = _f32(p * _f32(dp - D))
    dv = _bf(_f32(_split(drop(p), hilo).transpose(-1, -2) @ dod))
    dk = _bf(_f32(_f32(_split(ds, hilo).transpose(-1, -2) @ qd) * scale))
    dq = _bf(_f32(_f32(_split(ds, hilo) @ kd) * scale))
    dbh = _f32(ds.sum(-2))                     # [B, H, S]
    db = dbh[:, 0]
    for h in range(1, H):
        db = _f32(db + dbh[:, h])
    return out, dq, dk, dv, db


def _errors(got, want) -> dict:
    """Each result's largest error over its chip_smoke.py tolerance."""
    ratios = {}
    for name, a, w in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        a, w = torch.as_tensor(a).double(), torch.as_tensor(w).double()
        assert torch.isfinite(a).all(), name
        scale = w.abs().max().item()
        if name == "dbias":
            tol = 1e-4 * scale
        else:
            tol = 2.0 ** (math.floor(math.log2(scale)) - 7) * (1 if name == "out" else 2)
        ratios[name] = (a - w).abs().max().item() / tol
    return ratios


def _jax_rate0(q, k, v, do, bias):
    """JAX's fused_attention_train_hm in bf16 at rate 0 and its jax.vjp
    gradients, in interpret mode."""
    jb = jnp.asarray(bias)[:, None, None, :]
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(
            lambda a, b_, c, d: JA.fused_attention_train_hm(a, b_, c, d),
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jb)
        dq, dk, dv, db = vjp(jnp.asarray(do, jnp.bfloat16))
    f = lambda x: np.array(jnp.asarray(x, jnp.float32))  # noqa: E731
    return f(out), f(dq), f(dk), f(dv), f(db)[:, 0, 0, :]


def _plain(q, k, v, do, bias, **kw):
    """The port's plain version of B3 in bf16, differentiated by autograd."""
    ts = [torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v)]
    tb = torch.from_numpy(bias)[:, None, None, :].clone().requires_grad_()
    out = TA.fused_attention_train_hm(*ts, tb, **kw)
    grads = torch.autograd.grad(out, ts + [tb], torch.from_numpy(do).bfloat16())
    return (out.detach(), *grads[:3], grads[3][:, 0, 0, :])


def _keep(seed, rate):
    t = TA.keep_threshold(rate)
    return TA.dropout_keep_mask(seed, B, H, S, t), t


def test_emulation_matches_jax_pallas_at_rate0():
    q, k, v, do, bias = _inputs(0)
    ratios = _errors(emulate(q, k, v, do, bias), _jax_rate0(q, k, v, do, bias))
    assert all(x <= 1.0 for x in ratios.values()), ratios


@pytest.mark.parametrize("seed", [1, 2])
def test_emulation_matches_plain_version_with_dropout(seed):
    q, k, v, do, bias = _inputs(seed)
    keep, t = _keep(seed, 0.1)
    got = emulate(q, k, v, do, bias, keep, t)
    ratios = _errors(got, _plain(q, k, v, do, bias, dropout_rate=0.1, seed=seed))
    assert all(x <= 1.0 for x in ratios.values()), ratios


def test_d_from_the_bf16_output_misses_the_bias_gradient_gate():
    """Why D is the exact sum_j dp p: FlashAttention-2's rowsum(dO * O),
    with O the bf16 output, moves the bias gradient past its 1e-4 gate,
    while the exact D holds it."""
    q, k, v, do, bias = _inputs(3)
    keep, t = _keep(3, 0.1)
    want = _plain(q, k, v, do, bias, dropout_rate=0.1, seed=3)
    exact = _errors(emulate(q, k, v, do, bias, keep, t), want)
    shortcut = _errors(emulate(q, k, v, do, bias, keep, t, d_from_output=True), want)
    assert exact["dbias"] <= 1.0 < shortcut["dbias"], (exact, shortcut)


def test_hi_lo_splits_bring_the_emulation_closer_to_the_plain_version():
    """One bf16 rounding of p_d and ds per product (no lo halves) leaves the
    output and gradients further from the plain version than the split."""
    q, k, v, do, bias = _inputs(4)
    keep, t = _keep(4, 0.1)
    want = _plain(q, k, v, do, bias, dropout_rate=0.1, seed=4)
    split = _errors(emulate(q, k, v, do, bias, keep, t), want)
    single = _errors(emulate(q, k, v, do, bias, keep, t, hilo=False), want)
    assert all(split[n] <= 1.0 for n in split), split
    assert sum(single.values()) > sum(split.values()), (single, split)
