"""The port's UC2 (clg_vqa_tpu_torch/models/uc2.py, utils/convert.py) against
the JAX package's uc2.forward and against the reference's golden logits.

fp32 tolerance rtol=2e-4, atol=5e-5 (tests/test_uc2_parity.py's); bf16
requires the same argmax on every row. JAX's flat Pallas kernel runs in
interpret mode."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from clg_vqa_tpu.config import UC2Config as JConfig
from clg_vqa_tpu.models import uc2 as juc2
from clg_vqa_tpu.utils.convert import pytree_to_volta_uc2
from clg_vqa_tpu_torch.config import UC2Config
from clg_vqa_tpu_torch.models.uc2 import UC2
from clg_vqa_tpu_torch.utils import convert as TC

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "uc2_golden.npz")
RTOL, ATOL = 2e-4, 5e-5
TINY = dict(vocab_size=150, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, v_feature_size=48, num_locs=7,
            pooler_size=64, clf_hidden_size=32, num_labels=16)


def _batch(seed, B=6, T=12, R=9, vocab=150, feat=48):
    r = np.random.RandomState(seed)
    ids = r.randint(3, vocab, (B, T)).astype(np.int32)
    lens = r.randint(3, T + 1, B)
    for i, n in enumerate(lens):
        ids[i, n:] = 1
    imask = np.ones((B, R), np.int32)
    imask[2, 5:] = 0
    return {"input_ids": ids, "input_mask": (ids != 1).astype(np.int32),
            "features": r.randn(B, R, feat).astype(np.float32),
            "locs": r.rand(B, R, 7).astype(np.float32), "image_mask": imask}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def tiny():
    jparams = juc2.init_params(jax.random.key(3), JConfig(**TINY))
    np_params = jax.tree.map(np.asarray, jparams)
    cfg = UC2Config(**TINY)
    return cfg, jparams, TC.from_jax_params(np_params, cfg, device="cpu")


@pytest.mark.parametrize("fused", [False, "flat"])
def test_tiny_fp32_matches_jax(tiny, fused):
    cfg, jparams, model = tiny
    batch = _batch(0)
    jcfg = JConfig(**TINY)
    with pltpu.force_tpu_interpret_mode():
        _, jpooled = juc2.encode(jparams, jcfg, _jax(batch), fused_attn=fused)
        jlogits = juc2.forward(jparams, jcfg, _jax(batch), fused_attn=fused)
    with torch.no_grad():
        _, pooled = model.encode(_torch(batch), fused_attn=fused)
        logits = model(_torch(batch), fused_attn=fused)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fused", [False, "flat"])
def test_tiny_bf16_argmax_matches_jax(tiny, fused):
    cfg, jparams, model = tiny
    batch = _batch(1, B=16)
    with pltpu.force_tpu_interpret_mode():
        jlogits = juc2.forward(jparams, JConfig(**TINY), _jax(batch),
                               compute_dtype=jnp.bfloat16, fused_attn=fused)
    with torch.no_grad():
        logits = model(_torch(batch), compute_dtype=torch.bfloat16,
                       fused_attn=fused)
    assert logits.dtype == torch.bfloat16
    np.testing.assert_array_equal(logits.float().numpy().argmax(-1),
                                  np.asarray(jlogits, np.float32).argmax(-1))


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURE)


@pytest.fixture(scope="module")
def golden_model(golden):
    cfg = UC2Config(vocab_size=1000, hidden_size=96,
                    num_layers=int(golden["n_blocks"]), num_heads=4,
                    intermediate_size=384, v_feature_size=64, num_locs=7,
                    pooler_size=96, clf_hidden_size=96, num_labels=50)
    sd = {k[len("sd::"):]: golden[k] for k in golden.files if k.startswith("sd::")}
    return TC.from_volta(TC.normalize_volta_keys(sd), cfg, device="cpu")


def _golden_batch(golden):
    return {k: torch.from_numpy(np.asarray(golden[k]))
            for k in ("input_ids", "input_mask", "features", "locs",
                      "image_mask")}


@pytest.mark.parametrize("fused", [False, "flat"])
def test_golden_logits_and_pooled(golden, golden_model, fused):
    with torch.no_grad():
        _, pooled = golden_model.encode(_golden_batch(golden), fused_attn=fused)
        logits = golden_model(_golden_batch(golden), fused_attn=fused)
    np.testing.assert_allclose(pooled.numpy(), golden["pooled"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), golden["logits"],
                               rtol=RTOL, atol=ATOL)


def test_volta_export_roundtrip_is_exact(golden, golden_model):
    sd = TC.state_dict_to_volta_uc2(golden_model)
    assert "bert.encoder.layer.0.attention_self.v_query.weight" in sd
    again = TC.from_volta(sd, golden_model.cfg, device="cpu")
    for (k, a), (k2, b) in zip(golden_model.state_dict().items(),
                               again.state_dict().items()):
        assert k == k2 and torch.equal(a, b)
    with torch.no_grad():
        np.testing.assert_array_equal(golden_model(_golden_batch(golden)).numpy(),
                                      again(_golden_batch(golden)).numpy())


def test_volta_export_matches_jax_export(tiny):
    """The port's VOLTA export of converted JAX weights equals the JAX
    package's own export (same keys, aliases included, same arrays)."""
    cfg, jparams, model = tiny
    want = pytree_to_volta_uc2(jax.tree.map(np.asarray, jparams))
    got = TC.state_dict_to_volta_uc2(model)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_volta_import_rejects_unshared_alias(golden, golden_model):
    sd = TC.state_dict_to_volta_uc2(golden_model)
    k = "bert.encoder.layer.0.attention_self.v_key.weight"
    sd[k] = sd[k] + 1.0
    with pytest.raises(ValueError, match="unshared"):
        TC.volta_uc2_to_state_dict(sd, golden_model.cfg)


def test_config_from_json_matches_jax():
    path = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "uc2_base.json")
    import dataclasses
    assert (dataclasses.asdict(UC2Config.from_json(path))
            == dataclasses.asdict(JConfig.from_json(path)))
    assert UC2Config() == UC2Config(**dataclasses.asdict(JConfig()))


def test_init_distributions_and_seed():
    cfg = UC2Config(**TINY)
    a, b = UC2(cfg, device="cpu", seed=5), UC2(cfg, device="cpu", seed=5)
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
    e = a.embeddings
    assert torch.all(e.word[cfg.pad_token_id] == 0)
    assert abs(e.word.std().item() - cfg.initializer_range) < 2e-3
    limit = np.sqrt(6.0 / (cfg.clf_hidden_size + cfg.num_labels))
    assert a.classifier.fc2.weight.abs().max().item() <= limit
    assert torch.all(a.encoder[0].ln1.weight == 1)
    assert len(a.encoder) == cfg.num_layers


def test_training_paths_raise(tiny):
    """The training forward needs a dropout seed. The head-blocked eval
    kernel (fused_attn=True, B2) is ported: it has no backward, so it raises
    in grad mode, and under no_grad it gives the plain route's fp32 logits;
    a value that names no route raises ValueError."""
    cfg, _, model = tiny
    with pytest.raises(ValueError, match="seed"):
        model(_torch(_batch(2)), deterministic=False)
    with pytest.raises(RuntimeError, match="no backward"):
        model(_torch(_batch(2)), fused_attn=True)
    with torch.no_grad():
        got = model(_torch(_batch(2)), fused_attn=True)
        want = model(_torch(_batch(2)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="attention routes"):
        model(_torch(_batch(2)), fused_attn="blocked")


def test_model_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UC2(UC2Config(**TINY))
