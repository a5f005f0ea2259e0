"""The port's loss zoo (clg_vqa_tpu_torch/ops/aux_losses.py and
ops/semantic_prior.vqa_train_loss) against the JAX package's
(clg_vqa_tpu/ops/aux_losses.py, ops/semantic_prior.py) on the same numpy
inputs as tests/test_aux_losses.py, at its epochs.

Tolerance: 1e-5 relative and absolute on every value and on the gradient
with respect to the logits (jax.grad)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clg_vqa_tpu.ops import aux_losses as JA
from clg_vqa_tpu.ops import semantic_prior as JS
from clg_vqa_tpu_torch.ops import aux_losses as TA
from clg_vqa_tpu_torch.ops import semantic_prior as TS

torch.set_num_threads(1)

TOL = 1e-5
B, K = 6, 37
r = np.random.RandomState(0)
LOGITS = r.randn(B, K).astype(np.float32) * 3
TEACHER = r.randn(B, K).astype(np.float32) * 2
LABELS = r.randint(0, K, (B,)).astype(np.int64)
ONEHOT = np.eye(K, dtype=np.float32)[LABELS]
SIM = r.rand(B, K).astype(np.float32)
SOFT = r.rand(B, K).astype(np.float32)
SOFT /= SOFT.sum(-1, keepdims=True)
TARGETS = r.rand(B, K).astype(np.float32)
RANK = r.randn(B, 5).astype(np.float32)

# name -> (port fn, JAX fn, the inputs after the logits, keyword args);
# the epochs are tests/test_aux_losses.py's
CASES = {
    "pskd": (TA.pskd_cross_entropy, JA.pskd_cross_entropy, (SOFT,), {}),
    "kd_reg": (TA.kd_regularization_loss, JA.kd_regularization_loss,
               (ONEHOT, SIM), {}),
    "cosine_rep_e0": (TA.cosine_rep_loss, JA.cosine_rep_loss,
                      (ONEHOT, TEACHER, 0), {}),
    "cosine_rep_e5": (TA.cosine_rep_loss, JA.cosine_rep_loss,
                      (ONEHOT, TEACHER, 5), {}),
    "kd_self_e0": (TA.kd_self_loss, JA.kd_self_loss, (ONEHOT, TEACHER, 0), {}),
    "kd_self_e1": (TA.kd_self_loss, JA.kd_self_loss, (ONEHOT, TEACHER, 1), {}),
    "mse_e0": (TA.mse_teacher_loss, JA.mse_teacher_loss,
               (ONEHOT, TEACHER, 0), {}),
    "mse_e2": (TA.mse_teacher_loss, JA.mse_teacher_loss,
               (ONEHOT, TEACHER, 2), {}),
    "cos_teacher_e0": (TA.cosine_teacher_loss, JA.cosine_teacher_loss,
                       (ONEHOT, TEACHER, 0), {}),
    "cos_teacher_e2": (TA.cosine_teacher_loss, JA.cosine_teacher_loss,
                       (ONEHOT, TEACHER, 2), {}),
    "logit_norm": (TA.logit_norm_loss, JA.logit_norm_loss, (LABELS,), {}),
    "bce": (TA.bce_with_logits_loss, JA.bce_with_logits_loss, (TARGETS,), {}),
    "cross_entropy": (TA.cross_entropy_loss, JA.cross_entropy_loss,
                      (LABELS,), {}),
    "vqa_train_loss": (TS.vqa_train_loss, JS.vqa_train_loss, (TARGETS,), {}),
}


def _t(x):
    return torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray) else x


def _j(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(name):
    fn, jfn, args, kw = CASES[name]
    got = fn(torch.from_numpy(LOGITS), *map(_t, args), **kw)
    assert got.dtype == torch.float32 and got.shape == ()
    close(got.item(), float(jfn(jnp.asarray(LOGITS), *map(_j, args), **kw)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_gradient_matches_jax(name):
    fn, jfn, args, kw = CASES[name]
    x = torch.from_numpy(LOGITS.copy()).requires_grad_()
    fn(x, *map(_t, args), **kw).backward()
    want = jax.grad(lambda z: jfn(z, *map(_j, args), **kw))(jnp.asarray(LOGITS))
    close(x.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("key", sorted(JA.LOSS_MAP))
def test_loss_map_entries_match_jax(key):
    """Every LossMap entry, called as ForwardModelsTrain calls it: BCE on
    soft targets, CE on integer labels, the triplet loss on rank scores."""
    assert set(TA.LOSS_MAP) == set(JA.LOSS_MAP)
    x, arg = {"BCEWithLogitLoss": (LOGITS, TARGETS),
              "CrossEntropyLoss": (LOGITS, LABELS),
              "TripletLoss": (RANK, None)}[key]
    args = () if arg is None else (arg,)
    got = TA.LOSS_MAP[key](torch.from_numpy(x), *map(_t, args))
    close(got.item(), float(JA.LOSS_MAP[key](jnp.asarray(x),
                                              *map(_j, args))))


def test_losses_compute_in_fp32_from_bf16_logits():
    """A bf16 logits tensor is taken to fp32 first: the value equals the
    loss of the fp32 copy of the same bf16 values."""
    lb = torch.from_numpy(LOGITS).to(torch.bfloat16)
    for name, (fn, _, args, kw) in CASES.items():
        got = fn(lb, *map(_t, args), **kw)
        want = fn(lb.float(), *map(_t, args), **kw)
        assert got.dtype == torch.float32, name
        assert torch.equal(got, want), name
