"""Port primitives (clg_vqa_tpu_torch/models/layers.py) against the JAX
package's clg_vqa_tpu/models/layers.py on the same numpy inputs.

fp32 tolerance rtol=1e-5, atol=1e-6: both sides compute in fp32 and differ
only in summation order. The bf16 ``linear`` must match bit for bit: both
round once, after the fp32 bias add."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clg_vqa_tpu.models import layers as JL
from clg_vqa_tpu_torch.models import layers as TL

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_layer_norm(eps):
    r = np.random.RandomState(0)
    x = (r.randn(4, 7, 48) * 3 + 1).astype(np.float32)
    w = r.randn(48).astype(np.float32)
    b = r.randn(48).astype(np.float32)
    want = JL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps)
    got = TL.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(b), eps)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def test_layer_norm_keeps_bf16_dtype():
    """A bf16 input is normalized in fp32 and cast back once."""
    r = np.random.RandomState(1)
    x = r.randn(3, 40).astype(np.float32)
    w, b = np.ones(40, np.float32), np.zeros(40, np.float32)
    want = JL.layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                         jnp.asarray(b), 1e-5)
    got = TL.layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                        torch.from_numpy(b), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


def test_gelu():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = JL.gelu(jnp.asarray(x))
    got = TL.gelu(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def _linear_inputs(seed, d_in=40, d_out=24):
    r = np.random.RandomState(seed)
    x = r.randn(5, 7, d_in).astype(np.float32)
    w = (r.randn(d_in, d_out) * 0.2).astype(np.float32)   # JAX [in, out]
    b = r.randn(d_out).astype(np.float32)
    return x, w, b


def test_linear_fp32():
    x, w, b = _linear_inputs(2)
    want = JL.linear(jnp.asarray(x), {"w": jnp.asarray(w), "b": jnp.asarray(b)})
    got = TL.linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                    torch.from_numpy(b))
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [3, 4])
def test_linear_bf16_epilogue_bit_exact(seed):
    """bf16 operands, fp32 accumulation, fp32 bias on the accumulator, one
    cast: bit-equal to the JAX bf16 linear."""
    x, w, b = _linear_inputs(seed)
    want = JL.linear(jnp.asarray(x), {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                     compute_dtype=jnp.bfloat16)
    got = TL.linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                    torch.from_numpy(b), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (5, 7, 24)
    np.testing.assert_array_equal(_np(got), _np(want))
    # rounding the product to bf16 before the bias add is a different result
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    twice = (torch.matmul(xb, wb) + torch.from_numpy(b)).bfloat16()
    assert not torch.equal(twice, got)


def test_position_ids():
    r = np.random.RandomState(5)
    ids = r.randint(3, 50, (4, 12)).astype(np.int32)
    ids[1, 6:] = 1
    ids[3, 2:] = 1
    want = JL.create_position_ids_from_input_ids(jnp.asarray(ids), 1)
    got = TL.create_position_ids_from_input_ids(torch.from_numpy(ids), 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_additive_mask():
    m = np.array([[1, 1, 0, 0], [1, 0, 1, 1]], np.int32)
    want = np.asarray(JL.additive_mask(jnp.asarray(m)))
    got = TL.additive_mask(torch.from_numpy(m)).numpy()
    assert got.shape == (2, 1, 1, 4)
    np.testing.assert_array_equal(got, want)
    assert got.min() == -10000.0


def _mha_world(seed, D=64, H=4, B=3, S=11):
    r = np.random.RandomState(seed)
    x = r.randn(B, S, D).astype(np.float32)
    p = {n: {"w": (r.randn(D, D) * 0.15).astype(np.float32),
             "b": (r.randn(D) * 0.1).astype(np.float32)} for n in "qkvo"}
    mask = np.ones((B, S), np.float32)
    mask[1, -4:] = 0
    attn = TL.SelfAttention(D, H, device="cpu")
    with torch.no_grad():
        for n in "qkvo":
            getattr(attn, n).weight.copy_(torch.from_numpy(p[n]["w"].T.copy()))
            getattr(attn, n).bias.copy_(torch.from_numpy(p[n]["b"]))
    return x, p, mask, attn


def test_multi_head_attention_unfused_fp32():
    x, p, mask, attn = _mha_world(6)
    jp = {n: {k: jnp.asarray(v) for k, v in d.items()} for n, d in p.items()}
    want = JL.multi_head_attention(jnp.asarray(x), jnp.asarray(x), jp, 4,
                                   JL.additive_mask(jnp.asarray(mask)))
    got = attn(torch.from_numpy(x), TL.additive_mask(torch.from_numpy(mask)))
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def test_multi_head_attention_unfused_bf16():
    """bf16 mode keeps softmax_lowp's forward: fp32 softmax, bf16 probs.
    Both sides round the same values, so they agree to one bf16 ulp."""
    x, p, mask, attn = _mha_world(7)
    jp = {n: {k: jnp.asarray(v) for k, v in d.items()} for n, d in p.items()}
    want = _np(JL.multi_head_attention(
        jnp.asarray(x), jnp.asarray(x), jp, 4,
        JL.additive_mask(jnp.asarray(mask)), compute_dtype=jnp.bfloat16))
    got = attn(torch.from_numpy(x), TL.additive_mask(torch.from_numpy(mask)),
               compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
    assert np.all(np.abs(_np(got) - want) <= ulp)


@pytest.mark.parametrize("fused", [True, "hm", "proj", "sm"])
def test_unported_attention_variants_raise(fused):
    """Every attention route is ported now; none falls back to another
    kernel. The S-major kernel ("sm") raises ValueError on shapes its grid
    cannot take (here H*hd = 64 and batch 3), as the JAX route does. The
    whole-block kernel ("proj", B4) with a seed gives the plain whole-block
    function's output. The head-blocked routes (True: B2/B3 on split heads;
    "hm", which is the True route in the port) give, on the CPU, the flat
    route's bits with a seed (B3's plain version is B1's) and without one
    (B2's plain version is K1's)."""
    x, p, mask, attn = _mha_world(8)
    bias = TL.additive_mask(torch.from_numpy(mask))
    if fused == "sm":
        with pytest.raises(ValueError, match="sm kernel needs"):
            attn(torch.from_numpy(x), bias, fused=fused, dropout_rate=0.1,
                 seed=1)
        return
    if fused == "proj":
        from clg_vqa_tpu_torch.ops.block_attention import \
            fused_attention_block_plain
        with torch.no_grad():
            got = attn(torch.from_numpy(x), bias, fused=fused,
                       dropout_rate=0.1, seed=1)
            want = fused_attention_block_plain(
                torch.from_numpy(x), attn.q.weight, attn.q.bias, attn.k.weight,
                attn.k.bias, attn.v.weight, attn.v.bias, attn.o.weight,
                attn.o.bias, bias, attn.num_heads, dropout_rate=0.1, seed=1)
        assert torch.equal(got, want)
        return
    with torch.no_grad():
        for kw in (dict(dropout_rate=0.1, seed=1), {}):
            got = attn(torch.from_numpy(x), bias, fused=fused, **kw)
            want = attn(torch.from_numpy(x), bias, fused="flat", **kw)
            assert torch.equal(got, want)
    with pytest.raises(ValueError, match="attention routes"):
        attn(torch.from_numpy(x), bias, fused="blocked")


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_hm_route_is_the_true_route(dtype):
    """"hm" with a seed runs the True route: the same output and the same
    gradients of x and of every weight and bias, bit for bit, at rate 0.1."""
    x, _, mask, attn = _mha_world(9)
    bias = TL.additive_mask(torch.from_numpy(mask))
    g = torch.from_numpy(np.random.RandomState(10).randn(*x.shape)
                         .astype(np.float32))
    res = []
    for fused in (True, "hm"):
        attn.zero_grad(set_to_none=True)
        tx = torch.from_numpy(x).requires_grad_()
        y = attn(tx, bias, compute_dtype=dtype, fused=fused, dropout_rate=0.1,
                 seed=3)
        y.backward(g.to(y.dtype))
        res.append([y.detach(), tx.grad]
                   + [p.grad for p in attn.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*res))
