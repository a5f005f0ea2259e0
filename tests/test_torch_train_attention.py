"""B1, the flat training attention (clg_vqa_tpu_torch/ops/attention.py:
fused_attention_train_flat), on the CPU, where the wrapper takes its plain
version: against the JAX package's Pallas kernel ``fused_attention_train_flat``
in interpret mode at rate 0, and held to its own dropout semantics at rate > 0
(interpret mode draws all-zero bits, so JAX's masks cannot be matched).

Tolerances at rate 0, fp32: the JAX test's own (tests/test_attention_kernel.py:
124-127), value rtol 2e-5, gradients rtol and atol 2e-4. The CUDA kernels are
held against this plain version on the card by tests/test_torch_cuda.py and
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
from clg_vqa_tpu_torch.ops import bank_gather as TG

torch.set_num_threads(1)


def _inputs(S, B=3, H=4, hd=32, seed=0):
    r = np.random.RandomState(seed)
    q, k, v = (r.randn(B, S, H * hd).astype(np.float32) for _ in range(3))
    mask = np.ones((B, S), np.float32)
    mask[1, -9:] = 0
    bias = ((1 - mask) * -10000.0)[:, None, None, :].astype(np.float32)
    w = r.randn(B, S, H * hd).astype(np.float32)
    return q, k, v, bias, w, H


def _torch_value_and_grads(q, k, v, bias, w, H, **kw):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    out = TA.fused_attention_train_flat(*ts, H, **kw)
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    return loss.item(), [t.grad.numpy() for t in ts], out.detach()


@pytest.mark.parametrize("S", [76, 140, 21])
def test_train_flat_matches_jax_pallas_rate0(S):
    q, k, v, bias, w, H = _inputs(S)
    jw = jnp.asarray(w)

    def jloss(q, k, v, b):
        return jnp.sum(JA.fused_attention_train_flat(q, k, v, b, H) * jw)

    with pltpu.force_tpu_interpret_mode():
        jval, jgrads = jax.value_and_grad(jloss, (0, 1, 2, 3))(
            *(jnp.asarray(a) for a in (q, k, v, bias)))
    val, grads, _ = _torch_value_and_grads(q, k, v, bias, w, H)
    np.testing.assert_allclose(val, float(jval), rtol=2e-5)
    for g, jg, name in zip(grads, jgrads, "qkvb"):
        assert g.shape == jg.shape
        np.testing.assert_allclose(g, np.asarray(jg), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_dropout_kept_entries_and_keep_fraction():
    """With q = k = 0 and no bias every probability is 1/S: kept entries
    equal p * 256/t and the realized keep fraction is within 0.01 of t/256."""
    B, H, S, hd, rate = 4, 12, 76, 8, 0.1
    t = TA.keep_threshold(rate)
    assert t == 230
    z = torch.zeros(B, S, H * hd)
    v = torch.zeros(B, S, H, hd)
    v[:, :, :, 0] = 1.0             # output column 0 = sum_j p_d[i, j]
    v[:, 5, :, 1] = 1.0             # output column 1 = p_d[i, 5]
    out = TA.fused_attention_train_flat(
        z, z, v.reshape(B, S, H * hd), torch.zeros(B, 1, 1, S), H,
        dropout_rate=rate, seed=3).view(B, S, H, hd)
    mask = TA.dropout_keep_mask(3, B, H, S, t)
    kept = np.float32(1.0 / S) * np.float32(256.0 / t)
    want5 = torch.where(mask[..., 5], torch.tensor(kept), 0.0).transpose(1, 2)
    assert torch.equal(out[..., 1], want5)
    np.testing.assert_allclose(
        out[..., 0].numpy(),
        (mask.float().sum(-1) * kept).transpose(1, 2).numpy(), rtol=1e-5)
    assert abs(mask.float().mean().item() - t / 256) < 0.01


def test_dropout_seed_determinism_and_batch_independence():
    q, k, v, bias, w, H = _inputs(40, B=4)
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    kw = dict(dropout_rate=0.3, seed=77)
    a = TA.fused_attention_train_flat(tq, tk, tv, tb, H, **kw)
    b = TA.fused_attention_train_flat(tq, tk, tv, tb, H, **kw)
    assert torch.equal(a, b)
    c = TA.fused_attention_train_flat(tq, tk, tv, tb, H, dropout_rate=0.3,
                                      seed=78)
    assert not torch.equal(a, c)
    # a sample's mask depends on (seed, its index), not on the other
    # samples: change samples 2-3 and cut the batch, samples 0-1 keep theirs
    r = np.random.RandomState(9)
    tq2 = tq.clone()
    tq2[2:] = torch.from_numpy(r.randn(2, 40, tq.shape[-1]).astype(np.float32))
    d = TA.fused_attention_train_flat(tq2, tk, tv, tb, H, **kw)
    e = TA.fused_attention_train_flat(tq[:2], tk[:2], tv[:2], tb[:2], H, **kw)
    assert torch.equal(d[:2], a[:2]) and torch.equal(e, a[:2])
    m = TA.dropout_keep_mask(77, 4, H, 40, TA.keep_threshold(0.3))
    assert torch.equal(TA.dropout_keep_mask(77, 2, H, 40,
                                            TA.keep_threshold(0.3)), m[:2])


def test_dropout_gradcheck_float64():
    """With a fixed seed the mask does not depend on the inputs, so the
    plain version's autograd matches finite differences in float64."""
    r = np.random.RandomState(4)
    ts = [torch.from_numpy(r.randn(2, 9, 8)).requires_grad_() for _ in range(3)]
    b = torch.from_numpy(r.randn(2, 1, 1, 9)).requires_grad_()

    def f(q, k, v, bias):
        return TA.fused_attention_train_flat(q, k, v, bias, 2,
                                             dropout_rate=0.3, seed=11)

    assert f(*ts, b).dtype == torch.float64
    assert torch.autograd.gradcheck(f, (*ts, b))


def test_philox_known_answers():
    """Random123's known-answer vectors for philox4x32_10."""
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((0xffffffff,) * 4, (0xffffffff,) * 2,
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in cases:
        got = TA.philox4x32_10(*(torch.tensor([c], dtype=torch.int64)
                                 for c in ctr), key[0] | (key[1] << 32))
        assert tuple(int(x) for x in got) == want


@pytest.mark.parametrize("rate,t", [(0.0, 256), (0.1, 230), (0.001, 256),
                                    (1.0, 1), (0.5, 128)])
def test_keep_threshold_matches_jax(rate, t):
    rng = jax.random.key(0) if rate > 0 else None
    assert TA.keep_threshold(rate) == JA._dropout_seed(rate, rng)[0] == t


def test_realized_keep_mask_reads_back_the_plain_mask():
    got = TA.realized_keep_mask(7, 3, 2, 37, 16, 0.1, "cpu")
    assert torch.equal(got, TA.dropout_keep_mask(7, 3, 2, 37, 230))


def test_train_flat_rejects_bad_inputs():
    q, k, v, bias, _, H = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                           else a for a in _inputs(9, B=2, H=4, hd=8))
    with pytest.raises(ValueError, match="seed"):
        TA.fused_attention_train_flat(q, k, v, bias, H, dropout_rate=0.1)
    with pytest.raises(ValueError):
        TA.fused_attention_train_flat(q, k[:, :5], v, bias, H)
    with pytest.raises(ValueError):
        TA.fused_attention_train_flat(q, k, v, bias, 5)
    with pytest.raises(ValueError, match="unsupported device"):
        TA.fused_attention_train_flat(q.to("meta"), k.to("meta"),
                                      v.to("meta"), bias.to("meta"), H)


def test_eval_kernels_refuse_to_drop_gradients():
    """K1 and K2 have no backward: in grad mode with an input that requires
    grad they raise instead of returning a result without a grad_fn."""
    q, k, v, bias, _, H = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                           else a for a in _inputs(9, B=2, H=4, hd=8))
    with pytest.raises(RuntimeError, match="no backward"):
        TA.fused_attention_flat(q.requires_grad_(), k, v, bias, H)
    with torch.no_grad():
        TA.fused_attention_flat(q, k, v, bias, H)
    bank = torch.randn(5, 4, requires_grad=True)
    idx = torch.tensor([0, 3], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        TG.rows_gather(bank, idx)
    with torch.no_grad():
        assert torch.equal(TG.rows_gather(bank, idx), bank[[0, 3]])


def _mha_world(seed, D=32, H=4, B=3, S=11):
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


@pytest.mark.parametrize("fused", [False, "flat"])
def test_training_attention_routes_match_jax_rate0(fused):
    """SelfAttention's training routes (plain, and "flat" through B1) at
    rate 0 against JAX multi_head_attention(deterministic=False): value and
    the gradients of x and every projection, fp32 (rtol 2e-4, atol 2e-5)."""
    x, p, mask, attn = _mha_world(5)
    w = np.random.RandomState(6).randn(*x.shape).astype(np.float32)
    jbias = JL.additive_mask(jnp.asarray(mask))

    def jloss(xx, pp):
        y = JL.multi_head_attention(xx, xx, pp, 4, jbias, dropout_rate=0.0,
                                    rng=jax.random.key(0), deterministic=False,
                                    fused=fused)
        return jnp.sum(y * w)

    jp = jax.tree.map(jnp.asarray, p)
    with pltpu.force_tpu_interpret_mode():
        jval, (jgx, jgp) = jax.value_and_grad(jloss, (0, 1))(jnp.asarray(x), jp)
    tx = torch.from_numpy(x).requires_grad_()
    y = attn(tx, TL.additive_mask(torch.from_numpy(mask)), fused=fused,
             dropout_rate=0.0, seed=1)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose((y * torch.from_numpy(w)).sum().item(),
                               float(jval), rtol=2e-5)
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


def test_training_attention_dropout_routes():
    """At rate > 0 both routes drop with a seed-determined mask: the same
    seed repeats the output, another seed changes it, and no seed is the
    deterministic forward."""
    x, p, mask, attn = _mha_world(7)
    tx = torch.from_numpy(x)
    bias = TL.additive_mask(torch.from_numpy(mask))
    for fused in (False, "flat"):
        with torch.no_grad():
            a = attn(tx, bias, fused=fused, dropout_rate=0.3, seed=4)
            b = attn(tx, bias, fused=fused, dropout_rate=0.3, seed=4)
            c = attn(tx, bias, fused=fused, dropout_rate=0.3, seed=5)
            d = attn(tx, bias, fused=fused)
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert not torch.allclose(a, d)
