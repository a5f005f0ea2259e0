"""B4, the whole-block training attention (clg_vqa_tpu_torch/ops/
block_attention.py, the "proj" route), on the CPU, where the wrapper takes
its plain version: against the JAX package's Pallas kernels in interpret
mode at rate 0, its dropout against B1's keep mask and an fp64 gradcheck, and
the model's "proj" route and a train step against JAX's.

Tolerances. fp32, rate 0: y within rtol 2e-5 (the JAX test's value
tolerance, tests/test_attention_kernel.py:408); every gradient within 1e-4
of the largest gradient of the block (both sides accumulate in fp32 and
differ in summation order only). bf16: y within two bf16 ulps of each
element; gradients within 1e-2 of the largest (a rounding flip of one bf16
product in the core moves a gradient by an ulp, 2^-8 of its size). The
train step: loss and grad_norm rtol 1e-5, parameters rtol 5e-4 atol 5e-5,
as tests/test_attention_kernel.py:467-515 holds JAX's own proj step. The
CUDA kernels are held against this plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from clg_vqa_tpu.config import UC2Config as JConfig
from clg_vqa_tpu.models import layers as JL
from clg_vqa_tpu.models import uc2 as juc2
from clg_vqa_tpu.ops import attention as JA
from clg_vqa_tpu.train import loop as jloop
from clg_vqa_tpu.train import optim as jopt
from clg_vqa_tpu_torch.config import UC2Config
from clg_vqa_tpu_torch.models import layers as TL
from clg_vqa_tpu_torch.ops import attention as TA
from clg_vqa_tpu_torch.ops import block_attention as TB
from clg_vqa_tpu_torch.train import loop as tloop
from clg_vqa_tpu_torch.train import optim as topt
from clg_vqa_tpu_torch.utils import convert as TC

torch.set_num_threads(1)

NAMES = ("x", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "bias")


def _world(S, B=3, H=4, hd=8, seed=0):
    """numpy x [B, S, D], JAX-layout weights [in, out], biases, the key
    bias [B, 1, 1, S] and a cotangent weighting."""
    r = np.random.RandomState(seed)
    D = H * hd
    x = r.randn(B, S, D).astype(np.float32)
    ws = [(r.randn(D, D) / np.sqrt(D)).astype(np.float32) for _ in range(4)]
    bs = [(r.randn(D) * 0.1).astype(np.float32) for _ in range(4)]
    mask = np.ones((B, S), np.float32)
    mask[1, -5:] = 0
    bias = ((1 - mask) * -10000.0)[:, None, None, :].astype(np.float32)
    w = r.randn(B, S, D).astype(np.float32)
    return x, ws, bs, bias, w, H


def _jax_block(x, ws, bs, bias, w, H, jdt):
    """JAX fused_attention_block in interpret mode: y and the gradients of
    sum(y * w) in the order of NAMES (weights transposed to [out, in])."""
    jargs = [jnp.asarray(x, jdt)]
    for wi, bi in zip(ws, bs):
        jargs += [jnp.asarray(wi, jdt), jnp.asarray(bi)]
    jargs.append(jnp.asarray(bias))

    def loss(*a):
        y = JA.fused_attention_block(*a, H)
        return jnp.sum(y.astype(jnp.float32) * w), y

    with pltpu.force_tpu_interpret_mode():
        (_, y), g = jax.value_and_grad(loss, argnums=tuple(range(10)),
                                       has_aux=True)(*jargs)
    g = [np.asarray(t.astype(jnp.float32)) for t in g]
    g = [t.T if n.startswith("w") else t for t, n in zip(g, NAMES)]
    return np.asarray(y.astype(jnp.float32)), g


def _torch_args(x, ws, bs, bias, dtype):
    args = [torch.from_numpy(x).to(dtype)]
    for wi, bi in zip(ws, bs):
        args += [torch.from_numpy(wi.T.copy()).to(dtype), torch.from_numpy(bi)]
    args.append(torch.from_numpy(bias))
    return [a.requires_grad_() for a in args]


def _torch_block(fn, x, ws, bs, bias, w, H, dtype, **kw):
    args = _torch_args(x, ws, bs, bias, dtype)
    y = fn(*args, H, **kw)
    (y.float() * torch.from_numpy(w)).sum().backward()
    return y.detach(), [a.grad for a in args]


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.abs(x) + 1e-30)) - 7)


@pytest.mark.parametrize("S", [20, 13])
def test_block_matches_jax_pallas_fp32_rate0(S):
    x, ws, bs, bias, w, H = _world(S)
    jy, jg = _jax_block(x, ws, bs, bias, w, H, jnp.float32)
    y, g = _torch_block(TB.fused_attention_block, x, ws, bs, bias, w, H,
                        torch.float32)
    np.testing.assert_allclose(y.numpy(), jy, rtol=2e-5, atol=2e-5 * np.abs(jy).max())
    gmax = max(np.abs(t).max() for t in jg)
    for got, want, name in zip(g, jg, NAMES):
        assert got.dtype == torch.float32 and got.shape == want.shape, name
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-4 * gmax, (name, err, gmax)


@pytest.mark.parametrize("S", [20, 13])
def test_block_matches_jax_pallas_bf16_rate0(S):
    """bf16: y within two bf16 ulps; x and the weight gradients come back in
    bf16, the bias gradients in fp32, all within 1e-2 of the largest."""
    x, ws, bs, bias, w, H = _world(S, seed=1)
    jy, jg = _jax_block(x, ws, bs, bias, w, H, jnp.bfloat16)
    y, g = _torch_block(TB.fused_attention_block, x, ws, bs, bias, w, H,
                        torch.bfloat16)
    assert y.dtype == torch.bfloat16
    assert np.all(np.abs(y.float().numpy() - jy) <= 2 * _bf16_ulp(jy))
    gmax = max(np.abs(t).max() for t in jg)
    for got, want, name in zip(g, jg, NAMES):
        want_dtype = torch.bfloat16 if name[0] in "xw" else torch.float32
        assert got.dtype == want_dtype, name
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 1e-2 * gmax, (name, err, gmax)


def test_bf16_dx_sums_in_x_dtype_in_order():
    """dx = (dxq + dxk) + dxv with each term rounded to bf16 and both sums
    taken in bf16 (clg_vqa_tpu/ops/attention.py:940-945): rebuilt from the
    core's dq, dk, dv it equals the plain version's dx bit for bit, and the
    other association gives other bits on these inputs."""
    x, ws, bs, bias, w, H = _world(20, seed=2)
    args = _torch_args(x, ws, bs, bias, torch.bfloat16)
    y = TB.fused_attention_block(*args, H)
    g = torch.from_numpy(w).bfloat16()
    y.backward(g)
    xb = args[0].detach()
    B, S, D = xb.shape
    x2 = xb.reshape(-1, D)
    q, k, v = (TB._proj(x2, args[1 + 2 * i].detach(), args[2 + 2 * i].detach())
               .view(B, S, D) for i in range(3))
    b2 = args[-1].detach()[:, 0, 0, :].float()
    dctx = TB._mm(g.reshape(-1, D), args[7].detach()).view(B, S, D)
    dq, dk, dv, _ = TB._core_backward_plain(q, k, v, b2, dctx, H, 256, None)
    dxq, dxk, dxv = (TB._mm(d.bfloat16().reshape(-1, D), args[1 + 2 * i].detach())
                     .bfloat16().view(B, S, D)
                     for i, d in enumerate((dq, dk, dv)))
    assert torch.equal(args[0].grad, (dxq + dxk) + dxv)
    assert not torch.equal(args[0].grad, dxq + (dxk + dxv))


def test_plain_dropout_forward_is_seeded():
    x, ws, bs, bias, w, H = _world(13)
    args = _torch_args(x, ws, bs, bias, torch.float32)
    with torch.no_grad():
        a = TB.fused_attention_block(*args, H, dropout_rate=0.1, seed=5)
        b = TB.fused_attention_block(*args, H, dropout_rate=0.1, seed=5)
        c = TB.fused_attention_block(*args, H, dropout_rate=0.1, seed=6)
        d = TB.fused_attention_block(*args, H)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.allclose(a, d)
    with pytest.raises(ValueError, match="seed"):
        TB.fused_attention_block(*args, H, dropout_rate=0.1)


@pytest.mark.parametrize("S,hd", [(13, 16), (20, 8)])
def test_keep_mask_is_b1s_mask(S, hd):
    """The keep mask B4's plain version realizes (read back through its
    forward) is dropout_keep_mask, and the flat route's (B1's plain
    version) on the same seed."""
    B, H, rate, seed = 3, 2, 0.3, 2**40 + 9
    got = TB.realized_block_keep_mask(seed, B, H, S, hd, rate, "cpu")
    t = TA.keep_threshold(rate)
    assert torch.equal(got, TA.dropout_keep_mask(seed, B, H, S, t))
    assert torch.equal(got, TA.realized_keep_mask(seed, B, H, S, hd, rate, "cpu"))
    assert not torch.equal(got, TB.realized_block_keep_mask(seed + 1, B, H, S,
                                                            hd, rate, "cpu"))


def test_keep_masks_of_heads_past_16_do_not_collide():
    """JAX's B4 seeds each (sample, head) stream with seed + 16 * sample +
    head (clg_vqa_tpu/ops/attention.py:667-675), so past 16 heads sample
    b's head 16 would replay sample b+1's head 0. The port keys Philox by
    (sample, head) itself, so those masks differ (ROADMAP.md §C)."""
    m = TB.realized_block_keep_mask(5, 2, 17, 9, 16, 0.5, "cpu")
    assert not torch.equal(m[0, 16], m[1, 0])
    assert torch.equal(m, TA.dropout_keep_mask(5, 2, 17, 9, 128))


def test_plain_backward_with_dropout_passes_fp64_gradcheck():
    """At rate 0.3 the mask is fixed by the seed, so the block is smooth in
    every input; the plain version's hand-written backward (the JAX VJP's
    structure) against finite differences in fp64."""
    r = np.random.RandomState(4)
    B, S, H, hd = 2, 5, 2, 3
    D = H * hd
    x = torch.from_numpy(r.randn(B, S, D)).requires_grad_()
    params = []
    for _ in range(4):
        params += [torch.from_numpy(r.randn(D, D) / np.sqrt(D)).requires_grad_(),
                   torch.from_numpy(r.randn(D) * 0.1).requires_grad_()]
    mask = np.ones((B, S))
    mask[1, -2:] = 0
    bias = torch.from_numpy(((1 - mask) * -3.0)[:, None, None, :]).requires_grad_()

    def f(x, *rest):
        return TB.fused_attention_block_plain(x, *rest, H, dropout_rate=0.3,
                                              seed=11)

    assert torch.autograd.gradcheck(f, (x, *params, bias))


def _mha(S=11, B=4, D=64, H=4, seed=6):
    r = np.random.RandomState(seed)
    x = r.randn(B, S, D).astype(np.float32)
    p = {n: {"w": (r.randn(D, D) * 0.1).astype(np.float32),
             "b": (r.randn(D) * 0.1).astype(np.float32)} for n in "qkvo"}
    mask = np.ones((B, S), np.float32)
    mask[1, -3:] = 0
    attn = TL.SelfAttention(D, H, device="cpu")
    with torch.no_grad():
        for n in "qkvo":
            getattr(attn, n).weight.copy_(torch.from_numpy(p[n]["w"].T.copy()))
            getattr(attn, n).bias.copy_(torch.from_numpy(p[n]["b"]))
    w = r.randn(B, S, D).astype(np.float32)
    return x, p, mask, attn, w, H


@pytest.fixture
def block_calls(monkeypatch):
    """Counts the model's calls into fused_attention_block and the flat
    kernels, on the CPU where the kernels' counters do not move."""
    calls = {"block": 0, "flat_train": 0, "flat_eval": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(TL, "fused_attention_block",
                        counting("block", TL.fused_attention_block))
    monkeypatch.setattr(TL, "fused_attention_train_flat",
                        counting("flat_train", TL.fused_attention_train_flat))
    monkeypatch.setattr(TL, "fused_attention_flat",
                        counting("flat_eval", TL.fused_attention_flat))
    return calls


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_self_attention_proj_route_matches_jax(dtype, block_calls):
    """SelfAttention(fused="proj") with a seed runs the whole block through
    fused_attention_block (never the flat kernels) and matches JAX's
    multi_head_attention(fused="proj") in interpret mode at rate 0, value
    and the gradients of x and every weight and bias."""
    x, p, mask, attn, w, H = _mha()
    jdt = jnp.bfloat16 if dtype is not None else None
    jp = {n: {k: jnp.asarray(v) for k, v in d.items()} for n, d in p.items()}
    jbias = JL.additive_mask(jnp.asarray(mask))

    def jloss(xx, params):
        y = JL.multi_head_attention(xx, xx, params, H, jbias, dropout_rate=0.0,
                                    rng=jax.random.key(0), deterministic=False,
                                    compute_dtype=jdt, fused="proj")
        return jnp.sum(y.astype(jnp.float32) * w)

    with pltpu.force_tpu_interpret_mode():
        jval, (jgx, jgp) = jax.value_and_grad(jloss, (0, 1))(jnp.asarray(x), jp)
    tx = torch.from_numpy(x).requires_grad_()
    y = attn(tx, TL.additive_mask(torch.from_numpy(mask)), compute_dtype=dtype,
             fused="proj", dropout_rate=0.0, seed=1)
    loss = (y.float() * torch.from_numpy(w)).sum()
    loss.backward()
    assert block_calls == {"block": 1, "flat_train": 0, "flat_eval": 0}
    assert y.dtype == (dtype or torch.float32)
    tol = 2e-5 if dtype is None else 1e-2
    np.testing.assert_allclose(loss.item(), float(jval), rtol=tol)
    want = {"x": np.asarray(jgx)}
    got = {"x": tx.grad.numpy()}
    for n in "qkvo":
        lin = getattr(attn, n)
        want[f"{n}.w"] = np.asarray(jgp[n]["w"]).T
        want[f"{n}.b"] = np.asarray(jgp[n]["b"])
        got[f"{n}.w"], got[f"{n}.b"] = lin.weight.grad.numpy(), lin.bias.grad.numpy()
    gmax = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        err = np.abs(got[k] - v).max()
        assert err <= (1e-4 if dtype is None else 1e-2) * gmax, (k, err, gmax)


def test_deterministic_proj_takes_the_eval_route(block_calls):
    """Without a seed "proj" runs the normal projections and the flat eval
    kernel, as JAX routes it (clg_vqa_tpu/models/layers.py:257-267): the
    output equals the deterministic "flat" forward bit for bit and matches
    JAX's deterministic proj forward."""
    x, p, mask, attn, _, H = _mha()
    bias = TL.additive_mask(torch.from_numpy(mask))
    with torch.no_grad():
        got = attn(torch.from_numpy(x), bias, fused="proj")
        flat = attn(torch.from_numpy(x), bias, fused="flat")
    assert block_calls == {"block": 0, "flat_train": 0, "flat_eval": 2}
    assert torch.equal(got, flat)
    jp = {n: {k: jnp.asarray(v) for k, v in d.items()} for n, d in p.items()}
    with pltpu.force_tpu_interpret_mode():
        want = JL.multi_head_attention(jnp.asarray(x), jnp.asarray(x), jp, H,
                                       JL.additive_mask(jnp.asarray(mask)),
                                       fused="proj")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_proj_and_flat_routes_drop_the_same_probabilities():
    """With one seed the "proj" block and the "flat" route (linear, B1,
    linear) realize one keep mask, so their outputs agree as at rate 0."""
    x, _, mask, attn, _, _ = _mha(S=17)
    bias = TL.additive_mask(torch.from_numpy(mask))
    with torch.no_grad():
        a = attn(torch.from_numpy(x), bias, fused="proj", dropout_rate=0.3,
                 seed=21)
        b = attn(torch.from_numpy(x), bias, fused="flat", dropout_rate=0.3,
                 seed=21)
        c = attn(torch.from_numpy(x), bias, fused="flat", dropout_rate=0.3,
                 seed=22)
    torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
    assert (a - c).abs().max() > 1e-2


TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, v_feature_size=16, num_locs=7,
            pooler_size=32, clf_hidden_size=32, num_labels=8,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            clf_dropout_prob=0.0)


def _batch(seed, acc=2, mbs=4, T=6, R=4):
    r = np.random.RandomState(seed)
    return {"input_ids": r.randint(3, 64, (acc, mbs, T)).astype(np.int32),
            "input_mask": np.ones((acc, mbs, T), np.int32),
            "features": r.randn(acc, mbs, R, 16).astype(np.float32),
            "locs": r.rand(acc, mbs, R, 7).astype(np.float32),
            "image_mask": np.ones((acc, mbs, R), np.int32),
            "labels": r.randint(0, 8, (acc, mbs)).astype(np.int32)}


def test_tiny_uc2_proj_train_step_matches_jax(block_calls):
    """One make_train_step(fused_attn="proj") step of a tiny UC2 (fp32,
    dropouts 0, acc 2 x mbs 4) against JAX's make_train_step(fused_attn=
    "proj") in interpret mode, from the same TrainState."""
    cfg = JConfig(**TINY)
    params = jax.tree.map(np.asarray, juc2.init_params(jax.random.key(0), cfg))
    D = np.random.RandomState(0).rand(8, 8).astype(np.float32)
    sched = jopt.warmup_linear_schedule(1e-3, 2, 40)
    opt = jopt.make_optimizer(params, sched)
    state = jloop.TrainState(jax.tree.map(jnp.asarray, params),
                             opt.init(params), jnp.zeros((), jnp.int32))
    step = jloop.make_train_step(juc2.forward, cfg, opt, jnp.asarray(D),
                                 semantic_lambda=10.0, top_k=4,
                                 compute_dtype=None, fused_attn="proj")
    b = _batch(7)
    tstate, _ = TC.from_jax_train_state(state, UC2Config(**TINY), device="cpu")
    with pltpu.force_tpu_interpret_mode():
        jstate, jm = step(state, jax.tree.map(jnp.asarray, b), jax.random.key(0))
    topt_ = topt.make_optimizer([n for n, _ in tstate.model.named_parameters()],
                                topt.warmup_linear_schedule(1e-3, 2, 40))
    tstep = tloop.make_train_step(topt_, torch.from_numpy(D), semantic_lambda=10.0,
                                  top_k=4, compute_dtype=None, fused_attn="proj")
    tstate, m = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()},
                      seed=0)
    assert block_calls["block"] == 2 * 2 and block_calls["flat_train"] == 0
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=1e-5)
    want = TC.jax_params_to_state_dict(jax.tree.map(np.asarray, jstate.params))
    for k, p in tstate.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=5e-4,
                                   atol=5e-5, err_msg=k)


def test_block_refuses_mismatched_operands():
    x, ws, bs, bias, _, H = _world(9)
    args = _torch_args(x, ws, bs, bias, torch.float32)
    with pytest.raises(ValueError, match="weights"):
        TB.fused_attention_block(args[0], args[1].bfloat16(), *args[2:], H)
    with pytest.raises(ValueError, match="biases"):
        TB.fused_attention_block(*args[:2], args[2][:-1], *args[3:], H)
    with pytest.raises(ValueError, match="divisible"):
        TB.fused_attention_block(*args, 5)
