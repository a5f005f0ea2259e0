"""The port's M3P (clg_vqa_tpu_torch/models/m3p.py and the M3P half of
utils/convert.py) against the reference's golden outputs
(tests/fixtures/m3p_golden.npz, whose batch holds images with fewer boxes
than slots, so it exercises the prefix-length mask quirk and the -inf keys),
against the JAX package's m3p.forward on the same weights for the attention
routes False, "flat", True and "hm" (JAX's Pallas kernels in interpret
mode), and a tiny train step against JAX's make_train_step.

Tolerances: the golden fixture's (tests/test_m3p_parity.py, rtol 2e-4);
fp32 against JAX rtol 2e-4, atol 5e-5 (tests/test_uc2_parity.py's); bf16
the same argmax on every row; the train step loss and grad_norm rtol 1e-5,
parameters rtol 5e-4 atol 5e-5 (tests/test_attention_kernel.py:467-515)."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from clg_vqa_tpu.config import M3PConfig as JConfig
from clg_vqa_tpu.models import m3p as jm3p
from clg_vqa_tpu.train import loop as jloop
from clg_vqa_tpu.train import optim as jopt
from clg_vqa_tpu.utils import convert as JC
from clg_vqa_tpu_torch.config import M3PConfig
from clg_vqa_tpu_torch.models.m3p import M3P
from clg_vqa_tpu_torch.train import loop as tloop
from clg_vqa_tpu_torch.train import optim as topt
from clg_vqa_tpu_torch.utils import convert as TC

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "m3p_golden.npz")
KEYS = ("input_ids", "input_mask", "features", "locs", "image_mask")
RTOL, ATOL = 2e-4, 5e-5
TINY = dict(vocab_size=120, hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=256, v_feature_size=24, num_locs=5,
            max_boxes=9, pooler_size=64, clf_hidden_size=48, num_labels=12)
QUIET = dict(dropout=0.0, attention_dropout=0.0, clf_dropout_prob=0.0)


@pytest.fixture(scope="module")
def golden():
    g = np.load(FIXTURE)
    cfg = M3PConfig(vocab_size=500, hidden_size=96,
                    num_layers=int(g["n_layers"]), num_heads=4,
                    intermediate_size=384, v_feature_size=2048, num_locs=5,
                    pooler_size=96, clf_hidden_size=192, num_labels=50,
                    max_boxes=8)
    sd = {k[len("sd::"):]: g[k] for k in g.files if k.startswith("sd::")}
    model = TC.from_volta(sd, cfg, device="cpu")
    batch = {k: torch.from_numpy(g[k]) for k in KEYS}
    return g, cfg, sd, model, batch


def test_golden_fixture_has_short_images(golden):
    """The fixture's images have fewer boxes than slots, so its padding
    slots take validity from the trailing text (the quirk)."""
    g = golden[0]
    img = g["image_mask"].sum(1)
    assert (img < g["image_mask"].shape[1]).any()
    assert (img + g["input_mask"].sum(1) < g["image_mask"].shape[1]
            + g["input_ids"].shape[1]).any()


@pytest.mark.parametrize("fused", [False, "flat", True, "hm"])
def test_golden_sequence_pooled_logits(golden, fused):
    g, _, _, model, batch = golden
    with torch.no_grad():
        seq, pooled = model.encode(batch, fused_attn=fused)
        logits = model(batch, fused_attn=fused)
    np.testing.assert_allclose(seq.numpy(), g["sequence"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(pooled.numpy(), g["pooled"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(logits.numpy(), g["logits"], rtol=2e-4, atol=5e-5)


def test_volta_roundtrip_and_jax_names(golden):
    """VOLTA -> port -> VOLTA gives back every tensor, under the JAX
    exporter's names (clg_vqa_tpu/utils/convert.py:pytree_to_volta_m3p)."""
    _, cfg, sd, model, _ = golden
    out = TC.state_dict_to_volta_m3p(model)
    jout = JC.pytree_to_volta_m3p(JC.volta_m3p_to_pytree(sd, cfg))
    assert set(out) == set(jout)
    for k, v in out.items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)
    again = TC.volta_m3p_to_state_dict(out, cfg)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(again[k], v.numpy(), err_msg=k)


def test_original_checkpoint_loader(golden):
    """An original microsoft/M3P checkpoint (``module.*`` body names, no
    classifier): the body maps by the module. -> bert.encoder. prefix and
    gives JAX's m3p_original_to_pytree's weights; the classifier keeps a
    fresh port init."""
    _, cfg, sd, _, batch = golden
    orig = {"module." + k[len("bert.encoder."):]: v for k, v in sd.items()
            if k.startswith("bert.encoder.")}
    orig["module.pred_layer.proj.bias"] = np.zeros(3, np.float32)  # ignored
    got = TC.m3p_original_to_state_dict(orig, cfg, seed=3)
    want = TC.jax_params_to_state_dict(jax.tree.map(
        np.asarray, JC.m3p_original_to_pytree(orig, cfg)))
    assert got.keys() == want.keys()
    fresh = M3P(cfg, device="cpu", seed=3).state_dict()
    for k, v in got.items():
        if k.startswith("classifier."):
            np.testing.assert_array_equal(v, fresh[k].numpy(), err_msg=k)
        else:
            np.testing.assert_array_equal(v, want[k], err_msg=k)


def _batch(seed, B=5, T=7, R=9, feat=24, vocab=120, lead=()):
    """An M3P batch with short texts and short images: row 1's image has 2
    boxes, row 3's none beyond 4, so trailing keys are invalid (-inf)."""
    r = np.random.RandomState(seed)
    shape = (*lead, B)
    ids = r.randint(3, vocab, (*shape, T)).astype(np.int32)
    ids[..., 2, 4:] = 1
    imask = np.ones((*shape, R), np.int32)
    imask[..., 1, 2:] = 0
    imask[..., 3, 4:] = 0
    return {"input_ids": ids, "input_mask": (ids != 1).astype(np.int32),
            "features": r.randn(*shape, R, feat).astype(np.float32),
            "locs": r.rand(*shape, R, 5).astype(np.float32),
            "image_mask": imask}


@pytest.fixture(scope="module")
def tiny():
    jcfg = JConfig(**TINY)
    jparams = jm3p.init_params(jax.random.key(7), jcfg)
    model = TC.from_jax_params(jax.tree.map(np.asarray, jparams),
                               M3PConfig(**TINY), device="cpu")
    return jcfg, jparams, model


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("fused", [False, "flat", True, "hm"])
def test_tiny_matches_jax_forward(tiny, fused, dtype):
    """The port's M3P on from_jax_params weights against JAX m3p.forward,
    deterministic, for each eval route: fp32 allclose (sequence and
    logits), bf16 the same argmax."""
    jcfg, jparams, model = tiny
    b = _batch(0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jdt = None if dtype is None else jnp.bfloat16
    tdt = None if dtype is None else torch.bfloat16
    with pltpu.force_tpu_interpret_mode():
        jseq, _ = jm3p.encode(jparams, jcfg, jb, compute_dtype=jdt,
                              fused_attn=fused)
        jlogits = jm3p.forward(jparams, jcfg, jb, compute_dtype=jdt,
                               fused_attn=fused)
    with torch.no_grad():
        seq, _ = model.encode(tb, compute_dtype=tdt, fused_attn=fused)
        logits = model(tb, compute_dtype=tdt, fused_attn=fused)
    jlogits = np.asarray(jlogits.astype(jnp.float32))
    assert np.isfinite(logits.float().numpy()).all()
    if dtype is None:
        np.testing.assert_allclose(seq.numpy(), np.asarray(jseq), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(logits.numpy(), jlogits, rtol=RTOL,
                                   atol=ATOL)
    else:
        assert seq.dtype == torch.float32      # [image; text] promotes
        np.testing.assert_array_equal(logits.float().numpy().argmax(-1),
                                      jlogits.argmax(-1))


def test_prefix_length_quirk_and_neg_inf_keys(tiny):
    """pos < txt_len + img_len over [image; text]: a short image's padding
    slots stay valid and its trailing text positions do not; invalid
    positions come out zero (h *= mask after the last block)."""
    _, _, model = tiny
    b = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    with torch.no_grad():
        seq, _ = model.encode(b)
    R = b["features"].shape[1]
    for i in range(b["input_ids"].shape[0]):
        n = int(b["input_mask"][i].sum() + b["image_mask"][i].sum())
        assert torch.count_nonzero(seq[i, n:]) == 0
        assert torch.all(seq[i, :n].abs().sum(-1) > 0)
    n1 = int(b["input_mask"][1].sum() + b["image_mask"][1].sum())
    assert int(b["image_mask"][1].sum()) < n1 < R + int(b["input_mask"][1].sum())


def test_training_forward_needs_a_seed_and_is_seeded(tiny):
    cfg = M3PConfig(**TINY)
    model = M3P(cfg, device="cpu", seed=1)
    b = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    with pytest.raises(ValueError, match="seed"):
        model(b, deterministic=False)
    with torch.no_grad():
        a = model(b, deterministic=False, seed=5)
        a2 = model(b, deterministic=False, seed=5)
        c = model(b, deterministic=False, seed=6)
        d = model(b)
    assert torch.equal(a, a2) and not torch.equal(a, c) and not torch.equal(a, d)


@pytest.mark.parametrize("fused", [False, True, "hm"])
def test_tiny_train_step_matches_jax(fused):
    """One make_train_step step of a tiny M3P (fp32, dropouts 0, acc 2 x
    mbs 5) against JAX's make_train_step with the same fused_attn in
    interpret mode, from the same TrainState."""
    cfg = JConfig(**TINY, **QUIET)
    params = jax.tree.map(np.asarray, jm3p.init_params(jax.random.key(0), cfg))
    D = np.random.RandomState(0).rand(12, 12).astype(np.float32)
    opt = jopt.make_optimizer(params, jopt.warmup_linear_schedule(1e-3, 2, 40))
    state = jloop.TrainState(jax.tree.map(jnp.asarray, params),
                             opt.init(params), jnp.zeros((), jnp.int32))
    step = jloop.make_train_step(jm3p.forward, cfg, opt, jnp.asarray(D),
                                 semantic_lambda=10.0, top_k=4,
                                 compute_dtype=None, fused_attn=fused)
    b = _batch(7, lead=(2,))
    b["labels"] = np.random.RandomState(8).randint(0, 12, (2, 5)).astype(np.int32)
    tstate, _ = TC.from_jax_train_state(state, M3PConfig(**TINY, **QUIET),
                                        device="cpu")
    assert type(tstate.model) is M3P
    with pltpu.force_tpu_interpret_mode():
        jstate, jm = step(state, jax.tree.map(jnp.asarray, b), jax.random.key(0))
    topt_ = topt.make_optimizer([n for n, _ in tstate.model.named_parameters()],
                                topt.warmup_linear_schedule(1e-3, 2, 40))
    tstep = tloop.make_train_step(topt_, torch.from_numpy(D), semantic_lambda=10.0,
                                  top_k=4, compute_dtype=None, fused_attn=fused)
    tstate, m = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()},
                      seed=0)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=1e-5)
    want = TC.jax_params_to_state_dict(jax.tree.map(np.asarray, jstate.params))
    for k, p in tstate.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=5e-4,
                                   atol=5e-5, err_msg=k)


def test_config_from_json_defaults_and_ffn_check(tmp_path):
    """The port's M3PConfig.from_json reads configs/m3p_base.json as the
    JAX package's does, takes the reference's defaults for absent keys
    (norm_embeddings False) and refuses an FFN width other than 4*hidden."""
    import dataclasses
    import json
    path = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "m3p_base.json")
    assert dataclasses.asdict(M3PConfig.from_json(path)) == \
        dataclasses.asdict(JConfig.from_json(path))
    assert M3PConfig.from_json(path) == M3PConfig()
    d = json.load(open(path))
    del d["norm_embeddings"]
    json.dump(d, open(tmp_path / "a.json", "w"))
    assert M3PConfig.from_json(str(tmp_path / "a.json")).norm_embeddings is False
    json.dump({**d, "intermediate_size": 1000}, open(tmp_path / "b.json", "w"))
    with pytest.raises(ValueError, match="4\\*hidden"):
        M3PConfig.from_json(str(tmp_path / "b.json"))
