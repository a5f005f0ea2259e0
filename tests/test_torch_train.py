"""The port's training half (clg_vqa_tpu_torch/models/layers.py training
primitives, ops/semantic_prior.py, train/optim.py, train/loop.py,
utils/convert.from_jax_train_state) against the JAX package on the same numpy
inputs, on the CPU.

Tolerances: the bf16 linear's dx and dW within one bf16 ulp per element and
db within rtol 1e-6 (both round the same fp32 sums once); softmax_lowp's
backward atol 1e-6; losses and logit gradients rtol 1e-5; optimizers and
schedules rtol 1e-6 over 10 steps (the same fp32 arithmetic); the train step
over 20 steps: loss and grad_norm rtol 1e-4, params rtol 1e-3 atol 1e-5
(summation order in fp32 compounds over steps)."""
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from clg_vqa_tpu.config import UC2Config as JConfig
from clg_vqa_tpu.models import layers as JL
from clg_vqa_tpu.models import uc2 as juc2
from clg_vqa_tpu.ops import semantic_prior as JS
from clg_vqa_tpu.train import loop as jloop
from clg_vqa_tpu.train import optim as jopt
from clg_vqa_tpu_torch.config import UC2Config
from clg_vqa_tpu_torch.models import layers as TL
from clg_vqa_tpu_torch.ops import semantic_prior as TS
from clg_vqa_tpu_torch.train import loop as tloop
from clg_vqa_tpu_torch.train import optim as topt
from clg_vqa_tpu_torch.utils import convert as TC

torch.set_num_threads(1)

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, v_feature_size=16, num_locs=7,
            pooler_size=32, clf_hidden_size=32, num_labels=8)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  clf_dropout_prob=0.0)


def _ulp_bf16(x):
    return 2.0 ** (np.floor(np.log2(np.abs(x) + 1e-30)) - 7)


# ---------------------------------------------------------------------------
# layers: bf16 linear VJP, softmax_lowp, dropout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_bf16_linear_backward_matches_jax_vjp(x_dtype):
    r = np.random.RandomState(0)
    x = r.randn(6, 5, 40).astype(np.float32)
    if x_dtype == torch.bfloat16:
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    w = (r.randn(40, 24) * 0.2).astype(np.float32)        # JAX [in, out]
    b = r.randn(24).astype(np.float32)
    g = np.array(jnp.asarray(r.randn(6, 5, 24), jnp.bfloat16)
                 .astype(jnp.float32))
    jx = jnp.asarray(x, jnp.bfloat16 if x_dtype == torch.bfloat16 else jnp.float32)

    def f(xx, ww, bb):
        return JL.linear(xx, {"w": ww, "b": bb}, jnp.bfloat16)

    _, vjp = jax.vjp(f, jx, jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = (np.asarray(t.astype(jnp.float32))
                     for t in vjp(jnp.asarray(g, jnp.bfloat16)))
    tx = torch.from_numpy(x).to(x_dtype).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    y = TL.linear(tx, tw, tb, torch.bfloat16)
    y.backward(torch.from_numpy(g).bfloat16())
    assert tx.grad.dtype == x_dtype and tw.grad.dtype == torch.float32
    dx, dw = tx.grad.float().numpy(), tw.grad.numpy().T
    assert np.all(np.abs(dx - jdx) <= _ulp_bf16(jdx))
    assert np.all(np.abs(dw - jdw) <= _ulp_bf16(jdw))
    np.testing.assert_allclose(tb.grad.numpy(), jdb, rtol=1e-6, atol=1e-7)
    # dW is rounded to bf16 once, then carried in fp32
    assert torch.equal(tw.grad, tw.grad.bfloat16().float())


def test_softmax_lowp_backward_matches_jax():
    r = np.random.RandomState(1)
    s = (r.randn(3, 4, 7, 7) * 3).astype(np.float32)
    dp = r.randn(3, 4, 7, 7).astype(np.float32)
    p, vjp = jax.vjp(lambda x: JL.softmax_lowp(x, jnp.bfloat16), jnp.asarray(s))
    (jds,) = vjp(jnp.asarray(dp, jnp.bfloat16))
    ts = torch.from_numpy(s).requires_grad_()
    tp = TL.softmax_lowp(ts, torch.bfloat16)
    assert tp.dtype == torch.bfloat16
    np.testing.assert_array_equal(tp.float().detach().numpy(),
                                  np.asarray(p.astype(jnp.float32)))
    tp.backward(torch.from_numpy(dp).bfloat16())
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jds), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_u8_threshold_matches_jax(dtype):
    """Where both keep an element the values are bit-equal to JAX's
    (x * 256/t, the scale rounded to x's dtype); the keep fraction is near
    t/256; the same generator seed repeats the mask."""
    r = np.random.RandomState(2)
    x = r.randn(64, 300).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(JL.dropout(jnp.asarray(x, jdt), 0.1, jax.random.key(0),
                                 False).astype(jnp.float32))
    tx = torch.from_numpy(x).to(dtype)
    got = TL.dropout(tx, 0.1, torch.Generator().manual_seed(0))
    assert got.dtype == dtype
    got = got.float().numpy()
    both = (got != 0) & (want != 0)
    assert both.mean() > 0.7
    np.testing.assert_array_equal(got[both], want[both])
    assert abs((got != 0).mean() - 230 / 256) < 0.01
    again = TL.dropout(tx, 0.1, torch.Generator().manual_seed(0))
    assert np.array_equal(again.float().numpy(), got)


def test_dropout_edge_rates():
    x = torch.randn(4, 8)
    g = torch.Generator().manual_seed(0)
    assert TL.dropout(x, 0.1, None) is x            # deterministic
    assert TL.dropout(x, 0.0, g) is x
    assert TL.dropout(x, 0.001, g) is x             # t = 256: keep all
    assert torch.equal(TL.dropout(x, 1.0, g), torch.zeros_like(x))


def test_fold_seed_separates_sites():
    seeds = {TL.fold_seed(7, *p) for p in [(0,), (1,), (0, 0), (0, 1), (1, 0),
                                          (2, 3), (3, 2)]}
    assert len(seeds) == 7
    assert TL.fold_seed(7, 1, 2) == TL.fold_seed(TL.fold_seed(7, 1), 2)
    assert all(0 <= s < 2 ** 64 for s in seeds)


# ---------------------------------------------------------------------------
# semantic prior loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("criterion", ["CrossEntropyLoss", "LogitNormLoss"])
def test_gqa_train_loss_and_logit_grads_match_jax(criterion):
    r = np.random.RandomState(3)
    B, L = 6, 30
    logits = (r.randn(B, L) * 2).astype(np.float32)
    labels = r.randint(0, L, B).astype(np.int32)
    D = r.rand(L, L).astype(np.float32)
    np.fill_diagonal(D, 0)
    kw = dict(semantic_lambda=10.0, top_k=10, criterion=criterion)
    jl, jg = jax.value_and_grad(lambda z: JS.gqa_train_loss(
        z, jnp.asarray(labels), jnp.asarray(D), **kw))(jnp.asarray(logits))
    js, jgs = jax.value_and_grad(lambda z: JS.semantic_prior_loss(
        z, jnp.asarray(labels), jnp.asarray(D), 10))(jnp.asarray(logits))
    tz = torch.from_numpy(logits).requires_grad_()
    tl = TS.gqa_train_loss(tz, torch.from_numpy(labels), torch.from_numpy(D),
                           **kw)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)
    tz2 = torch.from_numpy(logits).requires_grad_()
    ts = TS.semantic_prior_loss(tz2, torch.from_numpy(labels),
                                torch.from_numpy(D), 10)
    ts.backward()
    np.testing.assert_allclose(ts.item(), float(js), rtol=1e-5)
    np.testing.assert_allclose(tz2.grad.numpy(), np.asarray(jgs), rtol=1e-5,
                               atol=1e-8)
    with pytest.raises(ValueError, match="criterion"):
        TS.gqa_train_loss(tz, torch.from_numpy(labels), torch.from_numpy(D),
                          criterion="MSE")


def test_distance_matrix_builders_match_jax(tmp_path):
    r = np.random.RandomState(4)
    n = 12
    emb = {(i, j): float(r.rand()) for i in range(n) for j in range(n)}
    wn = {t: {"syn": [int(x) for x in r.choice(n, 2)],
              "hyp": [int(r.randint(n))], "hpo": [int(r.randint(n))]}
          for t in range(0, n, 2)}
    pe, pw = tmp_path / "emb.pkl", tmp_path / "wn.pkl"
    pe.write_bytes(pickle.dumps(emb))
    pw.write_bytes(pickle.dumps(wn))
    np.testing.assert_array_equal(
        TS.build_distance_matrix_embedding(str(pe), n),
        JS.build_distance_matrix_embedding(str(pe), n))
    np.testing.assert_array_equal(
        TS.build_distance_matrix_wordnet(str(pw), n),
        JS.build_distance_matrix_wordnet(str(pw), n))


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------

def _opt_world(seed=5):
    r = np.random.RandomState(seed)
    params = {"a": {"w": r.randn(5, 3).astype(np.float32),
                    "b": r.randn(3).astype(np.float32)},
              "ln": {"scale": r.randn(3).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: (r.randn(*p.shape) * 0.1).astype(
        np.float32), params) for _ in range(10)]
    return params, grads


def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("which", ["adamw", "adamw_nobias", "radam"])
def test_optimizers_match_jax_over_10_steps(which):
    params, grads = _opt_world()
    sched_j = jopt.warmup_linear_schedule(1e-2, 3, 10)
    sched_t = topt.warmup_linear_schedule(1e-2, 3, 10)
    jmask = {"a": {"w": True, "b": False}, "ln": {"scale": False}}
    tmask = {"a/w": True, "a/b": False, "ln/scale": False}
    if which == "radam":
        jo = jopt.radam(sched_j, weight_decay=0.01, decay_mask=jmask)
        to = topt.radam(sched_t, weight_decay=0.01, decay_mask=tmask)
    else:
        cb = which == "adamw"
        jo = jopt.adamw_pt(sched_j, weight_decay=0.01, correct_bias=cb,
                           decay_mask=jmask)
        to = topt.adamw_pt(sched_t, weight_decay=0.01, correct_bias=cb,
                           decay_mask=tmask)
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in _flat(params).items()}
    ts = to.init(tp)
    for g in grads:
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tu, ts = to.update({k: torch.from_numpy(v) for k, v in _flat(g).items()},
                           ts, tp)
        tp = {k: tp[k] + tu[k] for k in tp}
        for k, v in _flat(jp).items():
            np.testing.assert_allclose(tp[k].numpy(), v, rtol=1e-6, atol=1e-7,
                                       err_msg=k)
    assert ts.count == int(js.count) == 10


def test_schedules_match_jax():
    for total in (10, 40):
        jl = jopt.warmup_linear_schedule(4e-5, 3, total)
        tl = topt.warmup_linear_schedule(4e-5, 3, total)
        jc = jopt.warmup_constant_schedule(4e-5, 3)
        tc = topt.warmup_constant_schedule(4e-5, 3)
        for s in range(total + 3):
            np.testing.assert_allclose(tl(s), float(jl(s)), rtol=1e-6)
            np.testing.assert_allclose(tc(s), float(jc(s)), rtol=1e-6)
    assert topt.warmup_linear_schedule(1.0, 2, 10)(0) == 0.0


@pytest.fixture(scope="module")
def tiny_jax():
    cfg = JConfig(**TINY, **NO_DROPOUT)
    params = jax.tree.map(np.asarray, juc2.init_params(jax.random.key(0), cfg))
    return cfg, params


def test_no_decay_and_freeze_masks_match_jax(tiny_jax):
    _, params = tiny_jax
    jmask = jopt.no_decay_mask(params)
    per_leaf = jax.tree.map(lambda p, m: np.full(p.shape, m, np.float32),
                            params, jmask)
    want = {k: bool(v.flat[0]) for k, v in
            TC.jax_params_to_state_dict(per_leaf).items()}
    model = TC.from_jax_params(params, UC2Config(**TINY), device="cpu")
    got = topt.no_decay_mask(n for n, _ in model.named_parameters())
    assert got == want
    assert not got["encoder.0.ln1.weight"] and got["encoder.0.attn.q.weight"]
    jf = jopt.freeze_mask(params, ["embeddings/word", "pooler"])
    tf = topt.freeze_mask(dict(model.named_parameters()),
                          ["embeddings.word", "pooler"])
    jf_port = TC.jax_mask_to_state_dict(jf, params)
    assert {k for k, v in tf.items() if v is not None} == \
        {k for k, v in jf_port.items() if v is not None} == \
        {"embeddings.word", "pooler.weight", "pooler.bias"}
    assert topt.freeze_mask({}, []) is None


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _batch(seed, acc, mbs, T=6, R=4):
    r = np.random.RandomState(seed)
    return {"input_ids": r.randint(3, 64, (acc, mbs, T)).astype(np.int32),
            "input_mask": np.ones((acc, mbs, T), np.int32),
            "features": r.randn(acc, mbs, R, 16).astype(np.float32),
            "locs": r.rand(acc, mbs, R, 7).astype(np.float32),
            "image_mask": np.ones((acc, mbs, R), np.int32),
            "labels": r.randint(0, 8, (acc, mbs)).astype(np.int32)}


def _jax_run(cfg, params, D, sched, batches, grad_mask=None):
    opt = jopt.make_optimizer(params, sched)
    state = jloop.TrainState(jax.tree.map(jnp.asarray, params),
                             opt.init(params), jnp.zeros((), jnp.int32))
    start = state
    step = jax.jit(jloop.make_train_step(
        juc2.forward, cfg, opt, jnp.asarray(D), semantic_lambda=10.0, top_k=4,
        compute_dtype=None, grad_mask=grad_mask))
    metrics = []
    for i, b in enumerate(batches):
        state, m = step(state, jax.tree.map(jnp.asarray, b), jax.random.key(i))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return start, state, metrics


@pytest.fixture(scope="module")
def jax_trajectory(tiny_jax):
    cfg, params = tiny_jax
    D = np.random.RandomState(0).rand(8, 8).astype(np.float32)
    sched = jopt.warmup_linear_schedule(1e-3, 2, 40)
    batches = [_batch(100 + i, 2, 4) for i in range(20)]
    start, end, metrics = _jax_run(cfg, params, D, sched, batches)
    return D, batches, start, end, metrics


@pytest.mark.parametrize("fused", [False, "flat"])
def test_train_step_matches_jax_over_20_steps(jax_trajectory, fused):
    """A tiny UC2, fp32, dropouts 0, acc 2 x mbs 4, lambda 10, started from
    the JAX TrainState through from_jax_train_state; "flat" runs B1's plain
    version on the CPU."""
    D, batches, start, end, metrics = jax_trajectory
    state, mask = TC.from_jax_train_state(start, UC2Config(**TINY, **NO_DROPOUT),
                                          device="cpu")
    assert mask is None and state.step == 0 and state.opt_state.count == 0
    opt = topt.make_optimizer([n for n, _ in state.model.named_parameters()],
                              topt.warmup_linear_schedule(1e-3, 2, 40))
    step = tloop.make_train_step(opt, torch.from_numpy(D), semantic_lambda=10.0,
                                 top_k=4, compute_dtype=None, fused_attn=fused)
    for i, b in enumerate(batches):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                        seed=i)
        np.testing.assert_allclose(m["loss"].item(), metrics[i][0], rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"].item(), metrics[i][1],
                                   rtol=1e-4)
    assert state.step == 20 and state.opt_state.count == 20
    want = TC.jax_params_to_state_dict(jax.tree.map(np.asarray, end.params))
    for k, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def test_train_step_grad_mask_matches_jax(tiny_jax):
    """A JAX freeze mask carried over by from_jax_train_state: the masked
    parameters stay bit-unchanged and the rest track JAX."""
    cfg, params = tiny_jax
    D = np.random.RandomState(0).rand(8, 8).astype(np.float32)
    sched = jopt.warmup_constant_schedule(1e-3, 0)
    jmask = jopt.freeze_mask(params, ["embeddings/word", "encoder/ffn"])
    batches = [_batch(200 + i, 2, 4) for i in range(3)]
    start, end, metrics = _jax_run(cfg, params, D, sched, batches, jmask)
    state, mask = TC.from_jax_train_state(start, UC2Config(**TINY, **NO_DROPOUT),
                                          grad_mask=jmask, device="cpu")
    frozen = {k for k, v in mask.items() if v is not None}
    assert "embeddings.word" in frozen and "encoder.1.ffn.w2.bias" in frozen
    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    opt = topt.make_optimizer(list(before), topt.warmup_constant_schedule(1e-3, 0))
    step = tloop.make_train_step(opt, torch.from_numpy(D), semantic_lambda=10.0,
                                 top_k=4, compute_dtype=None, grad_mask=mask)
    for i, b in enumerate(batches):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                        seed=i)
        np.testing.assert_allclose(m["loss"].item(), metrics[i][0], rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"].item(), metrics[i][1],
                                   rtol=1e-4)
    want = TC.jax_params_to_state_dict(jax.tree.map(np.asarray, end.params))
    for k, p in state.model.named_parameters():
        if k in frozen:
            assert torch.equal(p, before[k]), k
        else:
            np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=1e-3,
                                       atol=1e-5, err_msg=k)


def test_from_jax_train_state_carries_moments(tiny_jax, jax_trajectory):
    _, _, _, end, _ = jax_trajectory
    state, _ = TC.from_jax_train_state(end, UC2Config(**TINY), device="cpu")
    adam = end.opt_state[1]
    assert state.step == 20 and state.opt_state.count == int(adam.count)
    mu = TC.jax_params_to_state_dict(jax.tree.map(np.asarray, adam.mu))
    for k, t in state.opt_state.mu.items():
        np.testing.assert_array_equal(t.numpy(), mu[k])
    assert set(state.opt_state.nu) == set(mu)
    s2 = topt.fastforward_count(state.opt_state, 7)
    assert s2.count == 7 and s2.mu is state.opt_state.mu


def test_eval_step_matches_jax(tiny_jax):
    cfg, params = tiny_jax
    b = {k: v[0] for k, v in _batch(300, 1, 6).items()}
    b["valid"] = np.array([1, 1, 1, 1, 1, 0], np.float32)
    b["has_label"] = np.array([1, 0, 1, 1, 1, 1], np.float32)
    want = jax.jit(jloop.make_eval_step(juc2.forward, cfg, compute_dtype=None))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, b))
    model = TC.from_jax_params(params, UC2Config(**TINY), device="cpu")
    got = tloop.make_eval_step(compute_dtype=None)(
        model, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-5)
    assert got["correct"].item() == float(want["correct"])
    assert got["count"].item() == float(want["count"]) == 4.0
    np.testing.assert_array_equal(got["pred"].numpy(), np.asarray(want["pred"]))


def test_train_step_with_feature_bank_matches_host_features(tmp_path):
    """Microbatches carrying store_idx gather their features from the
    device bank inside the loss (the row-gather kernel's path) and train
    exactly as the same features given directly."""
    from clg_vqa_tpu_torch.data.cfs import CfsWriter, CfsReader
    from clg_vqa_tpu_torch.data.device_bank import DeviceFeatureBank
    from clg_vqa_tpu_torch.data.features import RegionRecord
    r = np.random.RandomState(0)
    path = str(tmp_path / "b.cfs")
    with CfsWriter(path) as w:
        for i in range(6):
            boxes = np.stack([r.rand(4) * 40, r.rand(4) * 40, 50 + r.rand(4) * 40,
                              50 + r.rand(4) * 40], 1).astype(np.float32)
            w.add(RegionRecord(f"i{i}", r.randn(4, 16).astype(np.float32),
                               boxes, 100.0, 100.0))
    rd = CfsReader(path)
    bank = DeviceFeatureBank(rd, max_regions=4, num_locs=7, device="cpu")
    idx = np.array([[0, 1, 2, 3], [4, 5, 0, 1]], np.int32)
    f, l, m = rd.gather(idx.reshape(-1), max_regions=4, num_locs=7)
    base = {k: torch.from_numpy(v) for k, v in _batch(5, 2, 4).items()
            if k not in ("features", "locs", "image_mask")}
    host = dict(base, features=torch.from_numpy(f.reshape(2, 4, 4, 16)),
                locs=torch.from_numpy(l.reshape(2, 4, 4, 7)),
                image_mask=torch.from_numpy(m.reshape(2, 4, 4)))
    viabank = dict(base, store_idx=torch.from_numpy(idx))
    cfg = UC2Config(**TINY)
    out = []
    for batch, bk in ((host, None), (viabank, bank.tensors())):
        model = UC2Model(cfg)
        opt = topt.make_optimizer([n for n, _ in model.named_parameters()], 1e-3)
        state = tloop.TrainState(model, opt.init(dict(model.named_parameters())), 0)
        step = tloop.make_train_step(opt, torch.rand(8, 8, generator=torch.Generator().manual_seed(0)),
                                     semantic_lambda=1.0, top_k=4,
                                     compute_dtype=None)
        state, mt = step(state, batch, seed=3, bank=bk)
        out.append((mt, state.model.state_dict()))
    assert out[0][0]["loss"].item() == out[1][0]["loss"].item()
    for k, v in out[0][1].items():
        assert torch.equal(v, out[1][1][k]), k


def UC2Model(cfg):
    from clg_vqa_tpu_torch.models.uc2 import UC2
    return UC2(cfg, device="cpu", seed=0)


def test_training_forward_dropout_is_seeded():
    """deterministic=False drops at the config's rates with streams keyed
    by the seed: the same seed repeats the logits, another changes them,
    and rates 0 give the deterministic forward."""
    b = {k: torch.from_numpy(v[0]) for k, v in _batch(400, 1, 5).items()}
    model = UC2Model(UC2Config(**TINY))
    quiet = UC2Model(UC2Config(**TINY, **NO_DROPOUT))
    with torch.no_grad():
        for fused in (False, "flat"):
            a = model(b, deterministic=False, seed=1, fused_attn=fused)
            a2 = model(b, deterministic=False, seed=1, fused_attn=fused)
            c = model(b, deterministic=False, seed=2, fused_attn=fused)
            e = model(b, fused_attn=fused)
            assert torch.equal(a, a2) and not torch.equal(a, c)
            assert not torch.allclose(a, e)
            q = quiet(b, deterministic=False, seed=1, fused_attn=fused)
            torch.testing.assert_close(q, quiet(b), rtol=1e-6, atol=1e-6)


def test_grad_accumulation_equals_one_big_batch():
    """acc 2 x mbs 4 gives the update of acc 1 x mbs 8 (the mean of equal
    microbatch means), without dropout."""
    cfg = UC2Config(**TINY, **NO_DROPOUT)
    b2 = {k: torch.from_numpy(v) for k, v in _batch(500, 2, 4).items()}
    b1 = {k: v.reshape(1, 8, *v.shape[2:]) for k, v in b2.items()}
    out = []
    for b in (b2, b1):
        model = UC2Model(cfg)
        opt = topt.make_optimizer([n for n, _ in model.named_parameters()], 1e-3)
        state = tloop.TrainState(model, opt.init(dict(model.named_parameters())), 0)
        step = tloop.make_train_step(opt, torch.zeros(8, 8), semantic_lambda=0.0,
                                     top_k=4, compute_dtype=None)
        state, m = step(state, b, seed=0)
        out.append((m["loss"].item(), state.model.state_dict()))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5)
    for k, v in out[0][1].items():
        np.testing.assert_allclose(v.numpy(), out[1][1][k].numpy(), rtol=2e-4,
                                   atol=2e-6, err_msg=k)


def test_resolve_fused():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tloop.resolve_fused("auto", torch.bfloat16, cuda) == "flat"
    assert tloop.resolve_fused("auto", None, cuda) is False
    assert tloop.resolve_fused("auto", torch.bfloat16, cpu) is False
    assert tloop.resolve_fused("flat", None, cpu) == "flat"
    assert tloop.resolve_fused("hm", None, cpu) == "hm"
    assert tloop.resolve_fused(True, None, cpu) is True
    with pytest.raises(ValueError):
        tloop.resolve_fused("blocked", None, cpu)
