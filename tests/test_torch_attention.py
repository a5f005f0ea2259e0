"""Flat eval attention (clg_vqa_tpu_torch/ops/attention.py) against the JAX
package's Pallas kernel ``fused_attention_flat`` run in interpret mode, and
against the port's own unfused attention core.

On the CPU the wrapper takes its plain version; the CUDA kernel itself is
held against that plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from clg_vqa_tpu.ops import attention as JA
from clg_vqa_tpu_torch.models import layers as TL
from clg_vqa_tpu_torch.ops import attention as TA

torch.set_num_threads(1)


def _inputs(seed, B, S, H, hd):
    r = np.random.RandomState(seed)
    q, k, v = (r.randn(B, S, H * hd).astype(np.float32) for _ in range(3))
    mask = np.ones((B, S), np.float32)
    mask[1, -(S // 3):] = 0
    bias = ((1 - mask) * -10000.0)[:, None, None, :].astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("S", [13, 76])
def test_flat_matches_jax_pallas_fp32(S):
    q, k, v, bias = _inputs(0, 3, S, 4, 32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JA.fused_attention_flat(
            *(jnp.asarray(a) for a in (q, k, v, bias)), 4))
    got = TA.fused_attention_flat(
        *(torch.from_numpy(a) for a in (q, k, v, bias)), 4)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("S", [13, 76])
def test_flat_matches_jax_pallas_bf16(S):
    """bf16 operands: both sides upcast, compute in fp32 and cast the
    output once, so they agree to one bf16 ulp of each element."""
    q, k, v, bias = _inputs(1, 2, S, 4, 32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JA.fused_attention_flat(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
            jnp.asarray(bias), 4).astype(jnp.float32))
    got = TA.fused_attention_flat(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
        torch.from_numpy(bias), 4)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
    assert np.all(np.abs(got.float().numpy() - want) <= ulp)


@pytest.mark.parametrize("S", [13, 76])
def test_flat_matches_unfused_core(S):
    """The flat path and the unfused path of the port's attention block
    compute the same function (fp32, summation order only)."""
    r = np.random.RandomState(2)
    D, H = 64, 4
    attn = TL.SelfAttention(D, H, device="cpu")
    g = torch.Generator().manual_seed(0)
    for n in "qkvo":
        getattr(attn, n).init_normal_(0.2, g)
    x = torch.from_numpy(r.randn(3, S, D).astype(np.float32))
    mask = np.ones((3, S), np.float32)
    mask[2, S // 2:] = 0
    bias = TL.additive_mask(torch.from_numpy(mask))
    with torch.no_grad():
        plain = attn(x, bias, fused=False)
        flat = attn(x, bias, fused="flat")
    np.testing.assert_allclose(flat.numpy(), plain.numpy(), rtol=0, atol=2e-6)


def test_flat_rejects_bad_inputs():
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(3, 2, 9, 4, 8))
    with pytest.raises(ValueError):
        TA.fused_attention_flat(q, k[:, :5], v, bias, 4)
    with pytest.raises(ValueError):
        TA.fused_attention_flat(q, k, v, bias, 5)
    with pytest.raises(ValueError):
        TA.fused_attention_flat(q, k.double(), v, bias, 4)
    # a tensor on neither the CPU nor CUDA never reaches the plain version
    with pytest.raises(ValueError, match="unsupported device"):
        TA.fused_attention_flat(q.to("meta"), k.to("meta"), v.to("meta"),
                                bias.to("meta"), 4)
