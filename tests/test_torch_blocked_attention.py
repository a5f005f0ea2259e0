"""B2 and B3, the head-blocked attention (clg_vqa_tpu_torch/ops/attention.py:
fused_attention, fused_attention_train, fused_attention_train_hm), on the
CPU, where the wrappers take their plain versions: against the JAX
package's Pallas kernels in interpret mode (B2 at S 13 and 140 under -inf
and -10000 key biases; B3 at rate 0, values and jax.vjp gradients, both
entries), B3's dropout against B1's (bit for bit, and a mask that does not
depend on the batch size), an fp64 gradcheck, the refusals, and the model's
True and "hm" routes against JAX's.

Tolerances. B2 fp32: rtol 1e-5, atol 1e-6 (summation order only); bf16:
one bf16 ulp of the JAX value (both round the same fp32 values once), plus
the fp32 atol for an output that cancels to near zero, where the two fp32
sums differ by more than its ulp. B3
fp32 at rate 0: value rtol 2e-5, gradients rtol and atol 2e-4 (the B1
test's, tests/test_attention_kernel.py:124-127). The "hm" route: fp32
gradients within 1e-4 of the largest, bf16 within 1e-2 (a rounded q, k, v
or ctx may flip by one ulp, 2^-8). The JAX entries pad S to a multiple of 8
with -1e9 keys and the port does not pad: a padded key's probability is
exactly 0 in fp32, so the S = 13 cases hold to the same tolerances. The
CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
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


def _inputs(S, B=3, H=4, hd=32, seed=0, neg_inf=True):
    """q/k/v [B, S, H*hd], a key bias [B, 1, 1, S] that leaves the trailing
    keys of sample 1 invalid (-inf as M3P's, or -10000 as UC2's) and a
    cotangent weighting."""
    r = np.random.RandomState(seed)
    q, k, v, w = (r.randn(B, S, H * hd).astype(np.float32) for _ in range(4))
    valid = np.ones((B, S), bool)
    valid[1, -(S // 2):] = False
    bias = np.where(valid, 0.0, -np.inf if neg_inf else -10000.0)
    return q, k, v, bias[:, None, None, :].astype(np.float32), w, H


def _hm(x, H):
    B, S, D = x.shape
    return np.ascontiguousarray(x.reshape(B, S, H, D // H).transpose(0, 2, 1, 3))


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.abs(x) + 1e-30)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("neg_inf", [True, False])
@pytest.mark.parametrize("S", [13, 140])
def test_b2_matches_jax_pallas(S, neg_inf, dtype):
    q, k, v, bias, _, H = _inputs(S, neg_inf=neg_inf)
    jdt = jnp.dtype(dtype)
    with pltpu.force_tpu_interpret_mode():
        want = JA.fused_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                  jnp.asarray(bias), H)
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        got = TA.fused_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                 torch.from_numpy(bias), H)
    assert got.dtype == tdt and got.shape == q.shape
    got = got.float().numpy()
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want) + 1e-6)


def _jax_train(entry, q, k, v, bias, w, H):
    """loss = sum(out * w) and its gradients in q, k, v and bias through
    the JAX entry in interpret mode at rate 0."""
    jw = jnp.asarray(w)
    if entry == "hm":
        fn = lambda q, k, v, b: JA.fused_attention_train_hm(q, k, v, b)  # noqa: E731
        args = [_hm(a, H) for a in (q, k, v)]
        jw = jnp.asarray(_hm(w, H))
    else:
        fn = lambda q, k, v, b: JA.fused_attention_train(q, k, v, b, H)  # noqa: E731
        args = [q, k, v]

    def loss(*a):
        return jnp.sum(fn(*a) * jw)

    with pltpu.force_tpu_interpret_mode():
        val, grads = jax.value_and_grad(loss, (0, 1, 2, 3))(
            *(jnp.asarray(a) for a in (*args, bias)))
    return float(val), [np.asarray(g) for g in grads]


def _torch_train(entry, q, k, v, bias, w, H, **kw):
    """The port's entry: loss, its gradients in q, k, v and bias (q, k, v in
    the entry's layout), and the output."""
    tb = torch.from_numpy(bias).requires_grad_()
    if entry == "hm":
        ts = [torch.from_numpy(_hm(a, H)).requires_grad_() for a in (q, k, v)]
        tw = torch.from_numpy(_hm(w, H))
        out = TA.fused_attention_train_hm(*ts, tb, **kw)
    else:
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        tw = torch.from_numpy(w)
        out = TA.fused_attention_train(*ts, tb, H, **kw)
    loss = (out * tw).sum()
    grads = torch.autograd.grad(loss, ts + [tb])
    return loss.item(), [g.numpy() for g in grads], out.detach()


@pytest.mark.parametrize("entry", ["split", "hm"])
@pytest.mark.parametrize("S", [13, 140])
def test_b3_matches_jax_pallas_rate0(entry, S):
    """Values and the jax.vjp gradients dq, dk, dv and dbias of both train
    entries at rate 0, under the -inf key bias."""
    q, k, v, bias, w, H = _inputs(S, seed=1)
    jval, jgrads = _jax_train(entry, q, k, v, bias, w, H)
    val, grads, out = _torch_train(entry, q, k, v, bias, w, H)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(val, jval, rtol=2e-5)
    for g, jg, name in zip(grads, jgrads, "qkvb"):
        assert g.shape == jg.shape, name
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, jg, rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("entry", ["split", "hm"])
def test_b3_dropout_equals_b1_bit_for_bit(entry):
    """At rate 0.1 on one seed B3's plain version (either entry) gives B1's
    plain version's output and gradients bit for bit: one keep mask, keyed by
    (seed, sample, head, row, column // 16), and one arithmetic."""
    q, k, v, bias, w, H = _inputs(40, seed=2)
    kw = dict(dropout_rate=0.1, seed=1234)
    _, grads, out = _torch_train(entry, q, k, v, bias, w, H, **kw)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    flat = TA.fused_attention_train_flat(*ts, H, **kw)
    fgrads = torch.autograd.grad((flat * torch.from_numpy(w)).sum(), ts)
    if entry == "hm":
        out = TA.merge_heads(out)
        grads = [TA.merge_heads(torch.from_numpy(g)).numpy() for g in grads[:3]
                 ] + grads[3:]
    assert torch.equal(out, flat.detach())
    for g, fg in zip(grads, fgrads):
        np.testing.assert_array_equal(g, fg.numpy())
    rate0 = TA.fused_attention_train(*(torch.from_numpy(a) for a in (q, k, v, bias)),
                                     H, seed=1234)
    assert (rate0 - flat.detach()).abs().max() > 1e-2


def test_keep_mask_does_not_depend_on_batch_size():
    """A sample's dropout mask is a function of (seed, its index, head, row,
    column), not of the batch it rides in: the first samples of a batch of 5
    get the outputs they get in a batch of 2 and of 3. (The TPU kernel seeds
    per grid cell, seed + 16384 * batch tile + head, so its mask moves with
    the batch tile _bt(B) and thus with the batch size; ROADMAP.md §C.)"""
    q, k, v, bias, _, H = _inputs(24, B=5, seed=3)
    kw = dict(dropout_rate=0.3, seed=99)
    t = [torch.from_numpy(a) for a in (q, k, v, bias)]
    full = TA.fused_attention_train(*t, H, **kw)
    hm_full = TA.fused_attention_train_hm(*(TA.split_heads(x, H, x.dtype)
                                            for x in t[:3]), t[3], **kw)
    for n in (2, 3):
        assert torch.equal(TA.fused_attention_train(*(x[:n] for x in t), H, **kw),
                           full[:n])
        assert torch.equal(TA.fused_attention_train_hm(
            *(TA.split_heads(x[:n], H, x.dtype) for x in t[:3]), t[3][:n], **kw),
            hm_full[:n])
    mask = TA.dropout_keep_mask(99, 5, H, 24, TA.keep_threshold(0.3))
    assert torch.equal(TA.dropout_keep_mask(99, 2, H, 24, TA.keep_threshold(0.3)),
                       mask[:2])


def test_b3_plain_backward_with_dropout_passes_fp64_gradcheck():
    """With a fixed seed the mask does not depend on the inputs, so the
    head-major entry is smooth in q, k, v and bias: autograd against finite
    differences in fp64."""
    r = np.random.RandomState(4)
    ts = [torch.from_numpy(r.randn(2, 2, 9, 4)).requires_grad_() for _ in range(3)]
    b = torch.from_numpy(r.randn(2, 1, 1, 9)).requires_grad_()

    def f(q, k, v, bias):
        return TA.fused_attention_train_hm(q, k, v, bias, dropout_rate=0.3,
                                           seed=11)

    assert torch.autograd.gradcheck(f, (*ts, b))


def test_blocked_entries_refuse_bad_inputs():
    q, k, v, bias, _, H = _inputs(9)
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    qh, kh, vh = (TA.split_heads(x, H, x.dtype) for x in (tq, tk, tv))
    with pytest.raises(ValueError, match=r"\[B, H, S, hd\]"):
        TA.fused_attention_train_hm(qh, kh[:, :, :5], vh, tb)
    with pytest.raises(ValueError, match=r"\[B, H, S, hd\]"):
        TA.fused_attention_train_hm(tq, tk, tv, tb)
    with pytest.raises(ValueError, match="one dtype"):
        TA.fused_attention_train_hm(qh, kh.double(), vh, tb)
    with pytest.raises(ValueError, match="seed"):
        TA.fused_attention_train_hm(qh, kh, vh, tb, dropout_rate=0.1)
    with pytest.raises(ValueError, match="seed"):
        TA.fused_attention_train(tq, tk, tv, tb, H, dropout_rate=0.1)
    with pytest.raises(ValueError, match="divisible"):
        TA.fused_attention_train(tq, tk, tv, tb, 5)
    with pytest.raises(ValueError, match="divisible"):
        TA.fused_attention(tq, tk, tv, tb, 5)
    with pytest.raises(RuntimeError, match="no backward"):
        TA.fused_attention(tq.requires_grad_(), tk, tv, tb, H)


def _mha(S=11, B=4, D=64, H=4, seed=6):
    r = np.random.RandomState(seed)
    x = r.randn(B, S, D).astype(np.float32)
    p = {n: {"w": (r.randn(D, D) * 0.1).astype(np.float32),
             "b": (r.randn(D) * 0.1).astype(np.float32)} for n in "qkvo"}
    valid = np.ones((B, S), bool)
    valid[1, -3:] = False
    bias = np.where(valid, 0.0, -np.inf)[:, None, None, :].astype(np.float32)
    attn = TL.SelfAttention(D, H, device="cpu")
    with torch.no_grad():
        for n in "qkvo":
            getattr(attn, n).weight.copy_(torch.from_numpy(p[n]["w"].T.copy()))
            getattr(attn, n).bias.copy_(torch.from_numpy(p[n]["b"]))
    w = r.randn(B, S, D).astype(np.float32)
    return x, p, bias, attn, w, H


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("fused", [True, "hm"])
def test_self_attention_blocked_routes_match_jax_vjp(fused, dtype):
    """SelfAttention(fused=True / "hm") with a seed at rate 0 against
    jax.vjp of multi_head_attention(fused=True / "hm") in interpret mode
    (scale_query as M3P's, which the kernel routes ignore): the value and
    the gradients of x and of every weight and bias. JAX's "hm" gradient is
    the autodiff of its head-major einsums and casts; the port's "hm" is its
    True route, the flat products around the head split."""
    x, p, bias, attn, w, H = _mha()
    jdt = jnp.bfloat16 if dtype is not None else None
    jp = {n: {k: jnp.asarray(v) for k, v in d.items()} for n, d in p.items()}

    def jfwd(xx, params):
        return JL.multi_head_attention(
            xx, xx, params, H, jnp.asarray(bias), dropout_rate=0.0,
            rng=jax.random.key(0), deterministic=False, compute_dtype=jdt,
            scale_query=True, fused=fused)

    with pltpu.force_tpu_interpret_mode():
        jy, vjp = jax.vjp(jfwd, jnp.asarray(x), jp)
        jgx, jgp = vjp(jnp.asarray(w).astype(jy.dtype))
    tx = torch.from_numpy(x).requires_grad_()
    y = attn(tx, torch.from_numpy(bias), compute_dtype=dtype, fused=fused,
             dropout_rate=0.0, seed=1, scale_query=True)
    y.backward(torch.from_numpy(w).to(y.dtype))
    assert y.dtype == (dtype or torch.float32)
    jy = np.asarray(jy.astype(jnp.float32))
    if dtype is None:
        np.testing.assert_allclose(y.detach().numpy(), jy, rtol=2e-5, atol=2e-5)
    else:
        assert np.all(np.abs(y.detach().float().numpy() - jy) <= 2 * _bf16_ulp(jy))
    want = {"x": np.asarray(jgx, np.float32)}
    got = {"x": tx.grad.numpy()}
    for n in "qkvo":
        lin = getattr(attn, n)
        want[f"{n}.w"] = np.asarray(jgp[n]["w"], np.float32).T
        want[f"{n}.b"] = np.asarray(jgp[n]["b"], np.float32)
        got[f"{n}.w"], got[f"{n}.b"] = lin.weight.grad.numpy(), lin.bias.grad.numpy()
    gmax = max(np.abs(v).max() for v in want.values())
    for k_, v_ in want.items():
        err = np.abs(got[k_] - v_).max()
        assert err <= (1e-4 if dtype is None else 1e-2) * gmax, (k_, err, gmax)


@pytest.mark.parametrize("fused", [True, "hm"])
def test_deterministic_blocked_routes_take_b2(fused):
    """Without a seed True and "hm" run the normal projections and the
    head-blocked eval kernel B2 (clg_vqa_tpu/models/layers.py:268-271),
    matching JAX's deterministic forward of the same route."""
    x, p, bias, attn, _, H = _mha(S=13)
    jp = {n: {k: jnp.asarray(v) for k, v in d.items()} for n, d in p.items()}
    with pltpu.force_tpu_interpret_mode():
        want = JL.multi_head_attention(jnp.asarray(x), jnp.asarray(x), jp, H,
                                       jnp.asarray(bias), scale_query=True,
                                       fused=fused)
    with torch.no_grad():
        got = attn(torch.from_numpy(x), torch.from_numpy(bias), fused=fused,
                   scale_query=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
