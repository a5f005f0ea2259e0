"""The port's pretraining objective (clg_vqa_tpu_torch/ops/pretrain_losses.py,
models/pretrain.py, models/mlp.py, utils/convert.from_jax_pretrain) against
the JAX package's on the same numpy inputs, in fp32.

Tolerance: 1e-5 relative and absolute on losses, logits and gradients.
nce_2048 is held to JAX's on the negatives JAX draws, rebuilt here with
jax.random as clg_vqa_tpu/ops/pretrain_losses.py:75-84 draws them and given
to the port as ``neg_idx``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clg_vqa_tpu.config import UC2Config as JConfig
from clg_vqa_tpu.models import mlp as jmlp
from clg_vqa_tpu.models import uc2 as juc2
from clg_vqa_tpu.models.pretrain import (init_pretrain_heads, pretrain_forward,
                                         pretrain_loss)
from clg_vqa_tpu.ops import pretrain_losses as JPL
from clg_vqa_tpu_torch.config import UC2Config
from clg_vqa_tpu_torch.models import pretrain as TP
from clg_vqa_tpu_torch.models.mlp import MLP
from clg_vqa_tpu_torch.ops import pretrain_losses as TPL
from clg_vqa_tpu_torch.utils import convert as TC

torch.set_num_threads(1)

TOL = 1e-5
ALL_TARGETS = {ix: 1.0 for ix in "0123456"}
TINY = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, v_feature_size=2048, num_locs=7,
            pooler_size=32, clf_hidden_size=32, num_labels=8)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol, atol=tol)


def jax_neg_idx(rng, B, R, num_negative=128):
    """nce_2048's negatives as JAX draws them from ``rng``
    (pretrain_losses.py:75-84): [B, R, K] flat row indices."""
    n_across, n_inside = int(num_negative * 0.7), int(num_negative * 0.3)
    r1, r2, r3 = jax.random.split(rng, 3)
    rows_a = jax.random.randint(r1, (B, R, n_across), 0, B - 1)
    rows_a = jnp.where(rows_a == jnp.arange(B)[:, None, None], B - 1, rows_a)
    cols_a = jax.random.randint(r2, (B, R, n_across), 0, R)
    cols_i = jax.random.randint(r3, (B, R, n_inside), 0, R - 1)
    cols_i = jnp.where(cols_i == jnp.arange(R)[None, :, None], R - 1, cols_i)
    idx_i = jnp.arange(B)[:, None, None] * R + cols_i
    return np.array(jnp.concatenate([rows_a * R + cols_a, idx_i], axis=2))


@pytest.fixture(scope="module")
def vis_data():
    """tests/test_pretrain.py's criterion inputs (B 3, R 5)."""
    r = np.random.RandomState(0)
    B, R = 3, 5
    label = (r.rand(B, R) < 0.4).astype(np.int64)
    label[0, 0] = 1
    cls_ = r.rand(B, R, 1601).astype(np.float32)
    cls_ /= cls_.sum(-1, keepdims=True)
    return {
        "label": label,
        "image_cls": cls_,
        "image_feat": r.randn(B, R, 2048).astype(np.float32),
        "obj_labels": r.randint(0, 1600, (B, R)),
        "obj_confs": r.rand(B, R).astype(np.float32),
        "attr_labels": r.randint(0, 400, (B, R)),
        "attr_confs": r.rand(B, R).astype(np.float32),
    }


@pytest.mark.parametrize("key", sorted(JPL.PRE_VIS_CRITERIONS))
def test_vis_criterion_matches_jax(vis_data, key):
    assert TPL.PRE_VIS_TARGETS == JPL.PRE_VIS_TARGETS
    dim = JPL.PRE_VIS_TARGETS[key]
    pred = np.random.RandomState(1).randn(3, 5, dim).astype(np.float32)
    kw = {k: v for k, v in vis_data.items() if k != "label"}
    rng = jax.random.key(0)
    want = JPL.PRE_VIS_CRITERIONS[key](
        jnp.asarray(pred), jnp.asarray(vis_data["label"]),
        rng=rng, **{k: jnp.asarray(v) for k, v in kw.items()})
    x = torch.from_numpy(pred).requires_grad_()
    got = TPL.PRE_VIS_CRITERIONS[key](
        x, torch.from_numpy(vis_data["label"]),
        neg_idx=torch.from_numpy(jax_neg_idx(rng, 3, 5)),
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    close(got.item(), float(want))
    got.backward()
    jgrad = jax.grad(lambda p: JPL.PRE_VIS_CRITERIONS[key](
        p, jnp.asarray(vis_data["label"]), rng=rng,
        **{k: jnp.asarray(v) for k, v in kw.items()}))(jnp.asarray(pred))
    close(x.grad.numpy(), np.asarray(jgrad))


def test_nce_negatives_follow_the_jax_draw_rules():
    """The port's own draw keeps pretrain_losses.py:75-84's rules: 89
    cross-batch negatives from another image, 38 in-batch ones from the same
    image but another region; the same generator seed draws the same
    indices, and nce_2048 without neg_idx uses the generator's draw."""
    B, R = 4, 6
    idx = TPL.nce_negative_indices(
        B, R, generator=torch.Generator().manual_seed(3))
    assert idx.shape == (B, R, 89 + 38)
    rows, cols = idx // R, idx % R
    b = torch.arange(B)[:, None, None]
    r = torch.arange(R)[None, :, None]
    assert bool((rows[..., :89] != b).all())
    assert bool((rows[..., 89:] == b).all() and (cols[..., 89:] != r).all())
    again = TPL.nce_negative_indices(
        B, R, generator=torch.Generator().manual_seed(3))
    assert torch.equal(idx, again)
    g = torch.Generator().manual_seed(0)
    pred, feat = torch.randn(B, R, 16, generator=g), torch.randn(B, R, 16, generator=g)
    label = torch.ones(B, R, dtype=torch.long)
    drawn = TPL.nce_2048(pred, label, image_feat=feat,
                         generator=torch.Generator().manual_seed(3))
    given = TPL.nce_2048(pred, label, image_feat=feat, neg_idx=idx)
    assert torch.equal(drawn, given)
    with pytest.raises(ValueError, match="generator"):
        TPL.nce_2048(pred, label, image_feat=feat)


def test_masked_lm_and_itm_losses_match_jax():
    r = np.random.RandomState(2)
    logits = (r.randn(3, 7, 50) * 2).astype(np.float32)
    labels = np.where(r.rand(3, 7) < 0.3, r.randint(0, 50, (3, 7)), -1)
    labels[0, 0] = 4
    close(TPL.masked_lm_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels)).item(),
          float(JPL.masked_lm_loss(jnp.asarray(logits), jnp.asarray(labels))))
    none = np.full_like(labels, -1)
    assert TPL.masked_lm_loss(torch.from_numpy(logits),
                              torch.from_numpy(none)).item() == 0.0
    itm = r.randn(5, 2).astype(np.float32)
    match = r.randint(0, 2, (5,))
    close(TPL.itm_loss(torch.from_numpy(itm), torch.from_numpy(match)).item(),
          float(JPL.itm_loss(jnp.asarray(itm), jnp.asarray(match))))


def _batch(seed, B=2, T=6, R=4):
    r = np.random.RandomState(seed)
    cls_ = r.rand(B, R, 1601).astype(np.float32)
    cls_ /= cls_.sum(-1, keepdims=True)
    ids = r.randint(3, 100, (B, T)).astype(np.int32)
    ids[1, -2:] = 1                                     # padding
    return {
        "input_ids": ids, "input_mask": (ids != 1).astype(np.int32),
        "features": r.randn(B, R, 2048).astype(np.float32),
        "locs": r.rand(B, R, 7).astype(np.float32),
        "image_mask": np.ones((B, R), np.int32),
        "lm_labels": np.where(r.rand(B, T) < 0.3, r.randint(0, 100, (B, T)),
                              -1).astype(np.int32),
        "is_match": r.randint(0, 2, (B,)).astype(np.int32),
        "image_label": (r.rand(B, R) < 0.5).astype(np.int64),
        "image_cls": cls_,
        "obj_labels": r.randint(0, 1600, (B, R)).astype(np.int32),
        "obj_confs": r.rand(B, R).astype(np.float32),
        "attr_labels": r.randint(0, 400, (B, R)).astype(np.int32),
        "attr_confs": r.rand(B, R).astype(np.float32),
    }


@pytest.fixture(scope="module")
def pretrained():
    jcfg = JConfig(**TINY)
    params = juc2.init_params(jax.random.key(0), jcfg)
    heads = init_pretrain_heads(jax.random.key(1), jcfg,
                                visual_target_weights=ALL_TARGETS)
    np_p, np_h = (jax.tree.map(np.asarray, t) for t in (params, heads))
    model, theads = TC.from_jax_pretrain(np_p, np_h, UC2Config(**TINY),
                                         device="cpu")
    return jcfg, params, heads, model, theads


def test_from_jax_pretrain_maps_every_head_leaf(pretrained):
    """Every leaf of the JAX heads becomes a PretrainHeads parameter; the
    tied decoder has none of its own (only lm.bias)."""
    _, params, heads, model, theads = pretrained
    names = set(dict(theads.named_parameters()))
    assert names == set(TC.jax_params_to_state_dict(
        jax.tree.map(np.asarray, heads)))
    assert "lm.bias" in names and not any("decoder" in n and "lm" in n
                                          for n in names)
    assert sorted(theads.img.decoders) == sorted(ALL_TARGETS)
    np.testing.assert_array_equal(model.embeddings.word.detach().numpy(),
                                  np.asarray(params["embeddings"]["word"]))


def test_pretrain_forward_matches_jax(pretrained):
    jcfg, params, heads, model, theads = pretrained
    batch = _batch(0)
    jt, jitm, jvis = pretrain_forward(params, heads, jcfg,
                                      {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        t, itm, vis = TP.pretrain_forward(
            model, theads, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert t.dtype == torch.float32 and t.shape == (2, 6, 100)
    close(t.numpy(), np.asarray(jt))
    close(itm.numpy(), np.asarray(jitm))
    assert sorted(vis) == sorted(jvis)
    for ix in vis:
        close(vis[ix].numpy(), np.asarray(jvis[ix]))


def _jax_loss(params, heads, jcfg, batch):
    return pretrain_loss(params, heads, jcfg,
                         {k: jnp.asarray(v) for k, v in batch.items()},
                         visual_target_weights=ALL_TARGETS)


def _port_loss(model, theads, batch):
    B, R = batch["image_label"].shape
    return TP.pretrain_loss(
        model, theads, {k: torch.from_numpy(v) for k, v in batch.items()},
        visual_target_weights=ALL_TARGETS,
        neg_idx=torch.from_numpy(jax_neg_idx(jax.random.key(0), B, R)))


def test_pretrain_loss_matches_jax(pretrained):
    """Every loss of the dict, nce_2048 on the negatives JAX draws from its
    deterministic key(0)."""
    jcfg, params, heads, model, theads = pretrained
    batch = _batch(1)
    want = jax.jit(lambda p, h: _jax_loss(p, h, jcfg, batch))(params, heads)
    with torch.no_grad():
        got = _port_loss(model, theads, batch)
    assert set(got) == set(want) == {"masked_lm", "itm", "total",
                                     *(f"vis_{ix}" for ix in ALL_TARGETS)}
    for k in want:
        close(got[k].item(), float(want[k]))


def test_tied_decoder_gradient_matches_jax(pretrained):
    """The MLM decoder is the word embedding: d total / d word (decoder and
    lookup together) and d total / d lm.bias equal jax.grad's."""
    jcfg, params, heads, model, theads = pretrained
    batch = _batch(2)
    gp, gh = jax.jit(jax.grad(
        lambda p, h: _jax_loss(p, h, jcfg, batch)["total"],
        argnums=(0, 1)))(params, heads)
    model.zero_grad()
    theads.zero_grad()
    _port_loss(model, theads, batch)["total"].backward()
    word = model.embeddings.word.grad.numpy()
    close(word, np.asarray(gp["embeddings"]["word"]))
    assert np.abs(word[50:]).max() > 0    # rows no input token reads
    close(theads.lm.bias.grad.numpy(), np.asarray(gh["lm"]["bias"]))
    close(theads.itm.weight.grad.numpy(), np.asarray(gh["itm"]["w"]).T)
    close(theads.img.decoders["2"].weight.grad.numpy(),
          np.asarray(gh["img"]["decoders"]["2"]["w"]).T)


def test_pretrain_loss_trains():
    """A few Adam steps on the encoder and the heads together lower
    ``total`` (tests/test_pretrain.py::test_pretrain_loss_trains), with
    dropout on (seeds 0..7) and nce_2048 drawing its own negatives."""
    cfg = UC2Config(**{**TINY, "v_feature_size": 2048})
    model = TC.model_class(cfg)(cfg, device="cpu", seed=0)
    heads = TP.PretrainHeads(cfg, visual_target_weights=ALL_TARGETS,
                             device="cpu", seed=1)
    batch = {k: torch.from_numpy(v) for k, v in _batch(3, B=4).items()}
    opt = torch.optim.Adam([*model.parameters(), *heads.parameters()], lr=1e-3)
    first = None
    for step in range(8):
        opt.zero_grad()
        losses = TP.pretrain_loss(model, heads, batch,
                                  visual_target_weights=ALL_TARGETS, seed=step)
        losses["total"].backward()
        opt.step()
        assert all(bool(torch.isfinite(v)) for v in losses.values())
        first = losses["total"].item() if first is None else first
    with torch.no_grad():
        last = TP.pretrain_loss(model, heads, batch,
                                visual_target_weights=ALL_TARGETS)["total"]
    assert last.item() < first * 0.9, (first, last.item())


def test_pretrain_heads_init():
    """One decoder per visual target of weight > 0 at its published width;
    xavier-uniform Linears, a zero MLM bias."""
    cfg = UC2Config(**TINY)
    heads = TP.PretrainHeads(cfg, itm_dim=3,
                             visual_target_weights={"0": 1.0, "3": 0.0, "4": 0.5},
                             device="cpu").requires_grad_(False)
    assert sorted(heads.img.decoders) == ["0", "4"]
    assert heads.img.decoders["4"].weight.shape == (400, 32)
    assert heads.itm.weight.shape == (3, 32)
    assert float(heads.lm.bias.abs().max()) == 0.0
    limit = np.sqrt(6.0 / (32 + 1601))
    w = heads.img.decoders["0"].weight
    assert float(w.abs().max()) <= limit and float(w.std()) > limit / 3


def test_mlp_matches_jax():
    """MLP against mlp/init_mlp: the deterministic forward from the same
    weights, and dropout only between layers with a seed."""
    jparams = jmlp.init_mlp(jax.random.key(4), [16, 24, 12, 5])
    x = np.random.RandomState(5).randn(7, 16).astype(np.float32)
    m = MLP([16, 24, 12, 5], device="cpu")
    TC.load_numpy_state(m, TC.jax_params_to_state_dict(
        {"layers": jax.tree.map(np.asarray, jparams)}))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
        close(got.numpy(), np.asarray(jmlp.mlp(jparams, jnp.asarray(x))))
        assert torch.equal(m(torch.from_numpy(x), dropout_prob=0.0, seed=3), got)
        a = m(torch.from_numpy(x), dropout_prob=0.5, seed=3)
        b = m(torch.from_numpy(x), dropout_prob=0.5, seed=3)
        assert torch.equal(a, b) and not torch.equal(a, got)
