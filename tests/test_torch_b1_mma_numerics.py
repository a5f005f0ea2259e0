"""The numerics of B1's and B5's bf16 training attention on the card, emulated
on the CPU: both directions are B3's tensor-core kernels
(clg_vqa_tpu_torch/csrc/attention_train_mma.cuh) on the flat [B, S, H*hd]
and S-major [S, B, H*hd] strides. The forward saves each row's max and 1/l
and the keep bits; the backward reads them, forms D = sum_j dp p exactly and
takes p_d and ds into its products as hi + lo bf16 terms.

The arithmetic does not depend on the strides (one head's [S, hd] tile), so
tests/test_torch_b3_mma_numerics.emulate gives it: bf16 operands, exact
products summed in fp32, the softmax normalised before dropout. Here it runs
at UC2's pattern (padded keys at the finite -10000, S 40, 4 heads of 64, a
batch of 8 as the S-major route requires) and is held to the gates the card
holds the kernels to (chip_smoke.py:grad_errors): the output within one
bf16 ulp of its largest value, dq/dk/dv within two, the bias gradient within
1e-4 of its largest value:
- against the value and jax.vjp gradients of JAX's fused_attention_train_flat
  and fused_attention_train_smajor at rate 0, run in interpret mode as the
  JAX package's own tests run them;
- against the port's plain versions at rate 0.1, on the Philox keep mask.
One more case keeps the fp32 path's property: <dv, v> = loss within
4 * 2^-8 of the root of the sum of the squared terms (chip_smoke.py's
v-linearity gate), dv from the plain backward, which replays the mask as
the fp32 CUDA-core backward does, and the loss from the emulated forward's
output: the two realize one mask. A forward on another seed's mask misses
it."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from clg_vqa_tpu.ops import attention as JA
from clg_vqa_tpu_torch.ops import attention as TA
from test_torch_b3_mma_numerics import HD, H, S, _errors, emulate

torch.set_num_threads(1)

B = 8
RATE = 0.1
ENTRIES = {
    "flat": (JA.fused_attention_train_flat, TA.fused_attention_train_flat_plain),
    "smajor": (JA.fused_attention_train_smajor,
               TA.fused_attention_train_smajor_plain),
}


def _inputs(seed):
    """bf16 q, k, v, do [B, S, H*hd] (numpy float32 holding bf16 values)
    and UC2's key bias [B, S]: 0 on a prefix of S//2..S keys, -10000 on the
    padded ones."""
    r = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(r.randn(B, S, H * HD).astype(np.float32))
                   .bfloat16().float().numpy() for _ in range(4))
    lens = r.randint(S // 2, S + 1, B)
    lens[0] = S // 2
    bias = np.where(np.arange(S)[None, :] < lens[:, None], 0.0, -10000.0)
    return q, k, v, do, bias.astype(np.float32)


def _hm(x):
    """[B, S, H*hd] -> [B, H, S, hd]."""
    return np.ascontiguousarray(x.reshape(B, S, H, HD).transpose(0, 2, 1, 3))


def _keep(seed):
    t = TA.keep_threshold(RATE)
    return TA.dropout_keep_mask(seed, B, H, S, t), t


def _plain(entry, q, k, v, do, bias, **kw):
    """The port's plain version in bf16, differentiated by autograd: the
    output and (dq, dk, dv, the bias gradient [B, S]) for the cotangent do."""
    ts = [torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v)]
    tb = torch.from_numpy(bias)[:, None, None, :].clone().requires_grad_()
    out = ENTRIES[entry][1](*ts, tb, H, **kw)
    grads = torch.autograd.grad(out, ts + [tb], torch.from_numpy(do).bfloat16())
    return (out.detach(), *grads[:3], grads[3][:, 0, 0, :])


def _emulated(q, k, v, do, bias, keep=None, keep_t=256):
    """The emulated kernels' output and gradients in B1's [B, S, H*hd]
    layout, and the bias gradient [B, S]."""
    got = emulate(*(_hm(x) for x in (q, k, v, do)), bias, keep, keep_t)
    return (*(x.transpose(1, 2).reshape(B, S, H * HD) for x in got[:4]), got[4])


def _jax_rate0(entry, q, k, v, do, bias):
    """JAX's entry in bf16 at rate 0 and its jax.vjp gradients, in
    interpret mode."""
    jb = jnp.asarray(bias)[:, None, None, :]
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda a, b_, c, d: ENTRIES[entry][0](a, b_, c, d, H),
                           *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jb)
        dq, dk, dv, db = vjp(jnp.asarray(do, jnp.bfloat16))
    f = lambda x: np.array(jnp.asarray(x, jnp.float32))  # noqa: E731
    return f(out), f(dq), f(dk), f(dv), f(db)[:, 0, 0, :]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_emulated_kernels_match_jax_vjp_at_rate0(entry):
    q, k, v, do, bias = _inputs(5)
    ratios = _errors(_emulated(q, k, v, do, bias), _jax_rate0(entry, q, k, v, do, bias))
    assert all(x <= 1.0 for x in ratios.values()), ratios


@pytest.mark.parametrize("seed", [6, 7])
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_emulated_kernels_match_plain_version_with_dropout(entry, seed):
    q, k, v, do, bias = _inputs(seed)
    keep, t = _keep(seed)
    want = _plain(entry, q, k, v, do, bias, dropout_rate=RATE, seed=seed)
    ratios = _errors(_emulated(q, k, v, do, bias, keep, t), want)
    assert all(x <= 1.0 for x in ratios.values()), ratios


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_emulated_forward_matches_jax_pallas_at_rate0(entry):
    q, k, v, do, bias = _inputs(0)
    with pltpu.force_tpu_interpret_mode():
        want = ENTRIES[entry][0](*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                 jnp.asarray(bias)[:, None, None, :], H)
    want = np.array(jnp.asarray(want, jnp.float32))
    ratios = _errors((_emulated(q, k, v, do, bias)[0],), (want,))
    assert ratios["out"] <= 1.0, ratios


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_emulated_forward_matches_plain_version_with_dropout(entry, seed):
    q, k, v, do, bias = _inputs(seed)
    keep, t = _keep(seed)
    want = _plain(entry, q, k, v, do, bias, dropout_rate=RATE, seed=seed)[0]
    ratios = _errors((_emulated(q, k, v, do, bias, keep, t)[0],), (want,))
    assert ratios["out"] <= 1.0, ratios


@pytest.mark.parametrize("seed", [3, 4])
def test_mixed_forward_and_backward_keep_one_mask(seed):
    """The output is linear in v under a fixed mask, so <dv, v> equals the
    loss <out, do> when the forward and the backward realize one mask: the
    emulated tensor-core forward and the plain backward, which replays the
    Philox mask as the fp32 CUDA-core backward does. The
    tolerance is chip_smoke.py's bf16 one: the output and dv are rounded to
    bf16 (2^-9 each, errors of random sign). Under another seed's mask the
    forward misses it by far."""
    q, k, v, do, bias = _inputs(seed)
    keep, t = _keep(seed)
    dv = _plain("flat", q, k, v, do, bias, dropout_rate=RATE, seed=seed)[3]
    inner = (dv.double() * torch.from_numpy(v).double()).sum().item()
    dod = torch.from_numpy(do).double()

    def gap(out):
        terms = out * dod
        tol = 4 * 2.0 ** -8 * math.sqrt(terms.square().sum().item())
        return abs(inner - terms.sum().item()), tol

    err, tol = gap(_emulated(q, k, v, do, bias, keep, t)[0])
    assert err <= tol, (err, tol)
    other, _ = _keep(seed + 100)
    err_other, tol_other = gap(_emulated(q, k, v, do, bias, other, t)[0])
    assert err_other > 4 * tol_other, (err_other, tol_other)
