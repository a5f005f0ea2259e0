"""B5, the S-major training attention (clg_vqa_tpu_torch/ops/attention.py:
fused_attention_train_smajor and its eval twin fused_attention_smajor), on the
CPU, where the wrappers take their plain versions: against the JAX package's
Pallas kernels in interpret mode at rate 0, bit for bit against B1's plain
version with dropout, and refusing the shapes the JAX route refuses.

Tolerances at rate 0, fp32: the JAX test's own
(tests/test_attention_kernel.py:541-544), value rtol 2e-5, gradients rtol
and atol 2e-4; the eval twin rtol and atol 2e-5 (:554-555); the model's
training route the flat route's (tests/test_torch_train_attention.py), value
rtol 2e-5, gradients rtol 2e-4 atol 2e-5. The CUDA kernels are held against
these plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from clg_vqa_tpu.models import layers as JL
from clg_vqa_tpu.ops import attention as JA
from clg_vqa_tpu_torch.models import layers as TL
from clg_vqa_tpu_torch.ops import attention as TA

torch.set_num_threads(1)


def _inputs(S, B=8, H=4, hd=32, seed=0):
    r = np.random.RandomState(seed)
    q, k, v = (r.randn(B, S, H * hd).astype(np.float32) for _ in range(3))
    mask = np.ones((B, S), np.float32)
    mask[1, -9:] = 0
    bias = ((1 - mask) * -10000.0)[:, None, None, :].astype(np.float32)
    w = r.randn(B, S, H * hd).astype(np.float32)
    return q, k, v, bias, w, H


def _value_and_grads(fn, q, k, v, bias, w, H, **kw):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    out = fn(*ts, H, **kw)
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    return out.detach(), loss.item(), [t.grad for t in ts]


@pytest.mark.parametrize("S", [64, 76])
def test_train_smajor_matches_jax_pallas_rate0(S):
    q, k, v, bias, w, H = _inputs(S)
    jw = jnp.asarray(w)

    def jloss(q, k, v, b):
        return jnp.sum(JA.fused_attention_train_smajor(q, k, v, b, H) * jw)

    with pltpu.force_tpu_interpret_mode():
        jval, jgrads = jax.value_and_grad(jloss, (0, 1, 2, 3))(
            *(jnp.asarray(a) for a in (q, k, v, bias)))
    _, val, grads = _value_and_grads(TA.fused_attention_train_smajor,
                                     q, k, v, bias, w, H)
    np.testing.assert_allclose(val, float(jval), rtol=2e-5)
    for g, jg, name in zip(grads, jgrads, "qkvb"):
        assert tuple(g.shape) == jg.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_eval_twin_matches_jax_pallas():
    q, k, v, bias, _, H = _inputs(76)
    with pltpu.force_tpu_interpret_mode():
        want = JA.fused_attention_smajor(*(jnp.asarray(a)
                                           for a in (q, k, v, bias)), H)
    got = TA.fused_attention_smajor(*(torch.from_numpy(a)
                                      for a in (q, k, v, bias)), H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("rate,seed", [(0.1, 7), (0.5, 2**40 + 3)])
def test_smajor_plain_equals_flat_plain_bit_for_bit(rate, seed):
    """On one seed B5's plain version gives B1's plain version's output and
    gradients bit for bit: the mask is keyed by (seed, sample, head, row,
    column), not by the layout."""
    q, k, v, bias, w, H = _inputs(37, B=16, H=2, hd=64, seed=1)
    kw = dict(dropout_rate=rate, seed=seed)
    a = _value_and_grads(TA.fused_attention_train_smajor, q, k, v, bias, w, H,
                         **kw)
    b = _value_and_grads(TA.fused_attention_train_flat_plain, q, k, v, bias, w,
                         H, **kw)
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[2], b[2]):
        assert torch.equal(x, y)
    c = TA.fused_attention_train_smajor(
        *(torch.from_numpy(x) for x in (q, k, v, bias)), H,
        dropout_rate=rate, seed=seed + 1)
    assert not torch.equal(a[0], c)


@pytest.mark.parametrize("B,H,hd,match", [(3, 4, 32, "batch"),
                                           (8, 2, 48, "hd"),
                                           (8, 1, 64, "HD"),
                                           (8, 2, 256, None)])
def test_smajor_refuses_what_jax_refuses(B, H, hd, match):
    """The shape rules of clg_vqa_tpu/ops/attention.py:_sm_dims, as
    tests/test_attention_kernel.py::test_fused_sm_rejects_bad_batch holds
    them: the same shapes raise ValueError with the same message in both
    packages, for the training entry and the eval twin; nothing falls back
    to the flat kernel. (8, 2, 256) is accepted by both."""
    q, k, v, bias, _, _ = _inputs(12, B=B, H=H, hd=hd)
    jargs = [jnp.asarray(a) for a in (q, k, v, bias)]
    targs = [torch.from_numpy(a) for a in (q, k, v, bias)]
    for jfn, tfn in ((JA.fused_attention_train_smajor,
                      TA.fused_attention_train_smajor),
                     (JA.fused_attention_smajor, TA.fused_attention_smajor)):
        if match is None:
            assert TA.sm_dims(12, B, H * hd, H) == JA._sm_dims(12, B, H * hd, H)
            assert tfn(*targs, H).shape == q.shape
            continue
        with pytest.raises(ValueError, match=match) as je:
            jax.eval_shape(lambda *a: jfn(*a, H), *jargs)
        with pytest.raises(ValueError, match=match) as te:
            tfn(*targs, H)
        assert str(te.value) == str(je.value)


def test_eval_twin_refuses_grad_mode():
    q, k, v, bias, _, H = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                           else a for a in _inputs(9))
    with pytest.raises(RuntimeError, match="no backward"):
        TA.fused_attention_smajor(q.requires_grad_(), k, v, bias, H)
    with torch.no_grad():
        out = TA.fused_attention_smajor(q, k, v, bias, H)
    assert torch.equal(out, TA.fused_attention_smajor_plain(q.detach(), k, v,
                                                            bias, H))


def _mha_world(seed, D=128, H=4, B=8, S=11):
    r = np.random.RandomState(seed)
    x = r.randn(B, S, D).astype(np.float32)
    p = {n: {"w": (r.randn(D, D) * 0.1).astype(np.float32),
             "b": (r.randn(D) * 0.1).astype(np.float32)} for n in "qkvo"}
    mask = np.ones((B, S), np.float32)
    mask[1, -4:] = 0
    attn = TL.SelfAttention(D, H, device="cpu")
    with torch.no_grad():
        for n in "qkvo":
            getattr(attn, n).weight.copy_(torch.from_numpy(p[n]["w"].T.copy()))
            getattr(attn, n).bias.copy_(torch.from_numpy(p[n]["b"]))
    return x, p, mask, attn


def test_model_sm_training_route_matches_jax_rate0():
    """SelfAttention's "sm" training route against JAX multi_head_attention
    (fused="sm", deterministic=False) at rate 0: the value and the gradients
    of x and of every projection."""
    x, p, mask, attn = _mha_world(5)
    w = np.random.RandomState(6).randn(*x.shape).astype(np.float32)
    jbias = JL.additive_mask(jnp.asarray(mask))

    def jloss(xx, pp):
        y = JL.multi_head_attention(xx, xx, pp, 4, jbias, dropout_rate=0.0,
                                    rng=jax.random.key(0), deterministic=False,
                                    fused="sm")
        return jnp.sum(y * w)

    with pltpu.force_tpu_interpret_mode():
        jval, (jgx, jgp) = jax.value_and_grad(jloss, (0, 1))(
            jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    tx = torch.from_numpy(x).requires_grad_()
    y = attn(tx, TL.additive_mask(torch.from_numpy(mask)), fused="sm",
             dropout_rate=0.0, seed=1)
    loss = (y * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=2e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=2e-4,
                               atol=2e-5)
    for n in "qkvo":
        lin = getattr(attn, n)
        np.testing.assert_allclose(lin.weight.grad.numpy().T,
                                   np.asarray(jgp[n]["w"]), rtol=2e-4,
                                   atol=2e-5, err_msg=n)
        np.testing.assert_allclose(lin.bias.grad.numpy(),
                                   np.asarray(jgp[n]["b"]), rtol=2e-4,
                                   atol=2e-5, err_msg=n)


def test_model_sm_route_with_dropout_is_the_flat_route():
    """With dropout the "sm" and "flat" training routes give the same bits
    (one mask, keyed by the seed); without a seed "sm" is the flat eval
    forward, as the JAX package routes the deterministic "sm" to K1."""
    x, _, mask, attn = _mha_world(7)
    tx = torch.from_numpy(x)
    bias = TL.additive_mask(torch.from_numpy(mask))
    with torch.no_grad():
        a = attn(tx, bias, fused="sm", dropout_rate=0.3, seed=4)
        b = attn(tx, bias, fused="flat", dropout_rate=0.3, seed=4)
        c = attn(tx, bias, fused="sm", dropout_rate=0.3, seed=5)
        d = attn(tx, bias, fused="sm")
        e = attn(tx, bias, fused="flat")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(d, e)
