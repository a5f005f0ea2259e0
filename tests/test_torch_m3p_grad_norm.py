"""M3P's first-step gradient norm at the published width, port against JAX
(ROADMAP.md §C.2). Marked slow: it trains a 12 x 768 model on the CPU, so
the Tier-1 run leaves it out. Run it with

    JAX_PLATFORMS=cpu python -m pytest -q -s -m slow tests/test_torch_m3p_grad_norm.py

M3PConfig's widths and depth (12 blocks x 768, 12 heads, FFN 3072, 100
regions x 2048 with 5 locs), the vocabulary cut to 1,000 rows to keep the
run small (only the rows of the batch's tokens get a gradient, so the cut
does not change the norm's mechanism). One make_train_step step at acc 1 x
mbs 2, fp32, dropouts 0, from the same weights (``from_jax_train_state``),
on images of 100 and 37 boxes whose padding slots hold zero features and
locs, as the feature bank pads them. Once with the fresh init's zero
embedding biases, once with random ones (std 0.02). Tolerance: loss and
gradient norm rtol 1e-4 (fp32 sums in other orders; the norm is dominated
by a few rows scaled by 1/sqrt(1e-12), where rounding is amplified)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clg_vqa_tpu.config import M3PConfig as JConfig
from clg_vqa_tpu.models import m3p as jm3p
from clg_vqa_tpu.train import loop as jloop
from clg_vqa_tpu.train import optim as jopt
from clg_vqa_tpu_torch.config import M3PConfig
from clg_vqa_tpu_torch.train import loop as tloop
from clg_vqa_tpu_torch.train import optim as topt
from clg_vqa_tpu_torch.utils import convert as TC

QUIET = dict(vocab_size=1000, dropout=0.0, attention_dropout=0.0,
             clf_dropout_prob=0.0)


def _batch(cfg) -> dict:
    r = np.random.RandomState(0)
    T, R = 40, cfg.max_boxes
    ids = r.randint(3, cfg.vocab_size, (1, 2, T)).astype(np.int32)
    n = np.asarray([[R, 37]])
    imask = (np.arange(R) < n[..., None]).astype(np.int32)
    return {"input_ids": ids, "input_mask": np.ones_like(ids),
            "features": (r.randn(1, 2, R, cfg.v_feature_size) * imask[..., None]
                         ).astype(np.float32),
            "locs": (r.rand(1, 2, R, 5) * imask[..., None]).astype(np.float32),
            "image_mask": imask,
            "labels": r.randint(0, cfg.num_labels, (1, 2)).astype(np.int32)}


@pytest.mark.slow
@pytest.mark.parametrize("biases", ["zero", "random"])
def test_m3p_first_step_grad_norm_matches_jax(biases):
    cfg = JConfig(**QUIET)
    params = jax.tree.map(np.asarray, jm3p.init_params(jax.random.key(0), cfg))
    if biases == "random":
        r = np.random.RandomState(1)
        emb = params["embeddings"]
        for name in ("image", "loc"):
            emb[name]["b"] = (r.randn(*emb[name]["b"].shape) * 0.02).astype(np.float32)
    D = np.random.RandomState(2).rand(cfg.num_labels, cfg.num_labels).astype(np.float32)
    opt = jopt.make_optimizer(params, jopt.warmup_linear_schedule(1e-5, 2, 40))
    state = jloop.TrainState(jax.tree.map(jnp.asarray, params), opt.init(params),
                             jnp.zeros((), jnp.int32))
    step = jloop.make_train_step(jm3p.forward, cfg, opt, jnp.asarray(D),
                                 semantic_lambda=10.0, compute_dtype=None,
                                 fused_attn=False)
    b = _batch(cfg)
    _, jm = step(state, jax.tree.map(jnp.asarray, b), jax.random.key(0))
    tstate, _ = TC.from_jax_train_state(state, M3PConfig(**QUIET), device="cpu")
    del state, step, params
    topt_ = topt.make_optimizer([n for n, _ in tstate.model.named_parameters()],
                                topt.warmup_linear_schedule(1e-5, 2, 40))
    tstep = tloop.make_train_step(topt_, torch.from_numpy(D), semantic_lambda=10.0,
                                  compute_dtype=None, fused_attn=False)
    _, m = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()}, seed=0)
    print(f"M3P 12 x 768, vocab 1000, acc 1 x mbs 2, fp32, {biases} embedding "
          f"biases: loss port {m['loss'].item():.6f} JAX {float(jm['loss']):.6f}; "
          f"pre-clip grad norm port {m['grad_norm'].item():.6g} JAX "
          f"{float(jm['grad_norm']):.6g}")
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=1e-4)
