"""The port's IMP and SFT (clg_vqa_tpu_torch/train/pruning.py and
FinetuneRunner.imp_prune / sft) against the JAX package's, on the CPU.

The mask functions must agree with JAX bit for bit: the prunable names,
``imp_prune_step`` over 5 rounds on the same weights (from_jax_params),
``sparsity``, and the mask files, which each package reads from the other.

The recipes run on the world of tests/test_torch_driver.py (2 epochs of 4
steps, acc 2 x mbs 8, fp32, all dropouts 0, the port's model made from the
JAX params0), with that file's trajectory tolerances: per-step losses rtol
1e-4, final params rtol 1e-3 atol 1e-5, val scores to 1e-6. A round's mask
may differ from JAX's only at weights whose trained |w| lies within that
params tolerance (rtol 1e-3, atol 1e-5) of the round's threshold; the
count of such weights is printed. The rewound weights that imp_prune
evaluates must equal theta_0 * mask exactly. Prune resume (port only,
dropout on) must be bit-identical."""
import json
import os

import numpy as np
import pytest
import torch

import jax

from clg_vqa_tpu.config import M3PConfig as JM3PConfig
from clg_vqa_tpu.config import OptimConfig as JOptim
from clg_vqa_tpu.config import TaskConfig as JTask
from clg_vqa_tpu.config import UC2Config as JConfig
from clg_vqa_tpu.data.cfs import CfsReader as JReader
from clg_vqa_tpu.data.cfs import CfsWriter
from clg_vqa_tpu.data.features import RegionRecord
from clg_vqa_tpu.data.gqa import Entry as JEntry
from clg_vqa_tpu.data.gqa import GQADataset as JDataset
from clg_vqa_tpu.data.pipeline import TrainPipeline as JPipeline
from clg_vqa_tpu.data.tokenizer import HashTokenizer as JTok
from clg_vqa_tpu.models import m3p as jm3p
from clg_vqa_tpu.models import uc2 as juc2
from clg_vqa_tpu.train import checkpoints as jckpt
from clg_vqa_tpu.train import pruning as jpr
from clg_vqa_tpu.train.driver import FinetuneRunner as JRunner
from clg_vqa_tpu_torch.config import (M3PConfig, OptimConfig, TaskConfig,
                                      UC2Config)
from clg_vqa_tpu_torch.data.cfs import CfsReader
from clg_vqa_tpu_torch.data.gqa import Entry, GQADataset
from clg_vqa_tpu_torch.data.pipeline import TrainPipeline
from clg_vqa_tpu_torch.data.tokenizer import HashTokenizer
from clg_vqa_tpu_torch.models.uc2 import UC2
from clg_vqa_tpu_torch.train import checkpoints as ckpt
from clg_vqa_tpu_torch.train import driver as D
from clg_vqa_tpu_torch.train import loop as tloop
from clg_vqa_tpu_torch.train import pruning as pr
from clg_vqa_tpu_torch.train.optim import make_optimizer
from clg_vqa_tpu_torch.utils import convert as TC

torch.set_num_threads(1)

L, N_IMGS, N_Q = 6, 8, 64
TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, v_feature_size=16, num_locs=7,
            pooler_size=32, clf_hidden_size=32, num_labels=L)
QUIET = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             clf_dropout_prob=0.0)
M3P_TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=128, v_feature_size=16, num_locs=5,
                max_boxes=6, pooler_size=32, clf_hidden_size=48, num_labels=L,
                dropout=0.0, attention_dropout=0.0, clf_dropout_prob=0.0)
TASK = dict(num_labels=L, max_seq_length=8, max_region_num=6, batch_size=16,
            eval_batch_size=16, lr=5e-3, num_epoch=2, semantic_lambda=1.0)
OPT = dict(lr=5e-3, grad_acc_steps=2, warmup_proportion=0.1)
RTOL, ATOL = 1e-3, 1e-5           # the trajectory tolerance of final params


def _family(name):
    """(JAX config, JAX model module, port config) of a tiny UC2 or M3P."""
    if name == "uc2":
        return JConfig(**TINY, **QUIET), juc2, UC2Config(**TINY, **QUIET)
    return JM3PConfig(**M3P_TINY), jm3p, M3PConfig(**M3P_TINY)


def _jax_and_port(name, seed=0):
    jcfg, jmod, cfg = _family(name)
    params = jax.tree.map(np.asarray,
                          jmod.init_params(jax.random.key(seed), jcfg))
    return params, TC.from_jax_params(params, cfg, device="cpu")


def _port_mask_of(jmask, params):
    """A JAX mask tree in port names (numpy, None for pass-through)."""
    return TC.jax_mask_to_state_dict(jmask, params)


@pytest.mark.parametrize("family", ["uc2", "m3p"])
def test_prunable_names_are_jaxs_paths_in_port_names(family):
    params, model = _jax_and_port(family)
    want = {k for k, v in _port_mask_of(jpr.init_mask(params, family),
                                        params).items() if v is not None}
    assert pr.prunable_paths(model, family) == want
    L_ = model.cfg.num_layers
    assert len(want) == 6 * L_ + 1
    mask = pr.init_mask(model, family)
    assert mask.keys() == dict(model.named_parameters()).keys()
    assert {k for k, v in mask.items() if v is not None} == want
    assert all(v.dtype == torch.float32 and v.shape == model.state_dict()[k].shape
               and bool((v == 1).all()) for k, v in mask.items() if v is not None)


@pytest.mark.parametrize("family", ["uc2", "m3p"])
def test_imp_prune_step_and_sparsity_match_jax_bit_for_bit(family):
    """Five rounds of 10% on the same weights: JAX's mask bit for bit at
    every round, equal zero counts and sparsities, compounding to
    10 / 19 / 27.1 / 34.39 / 40.95% of the prunable set."""
    params, model = _jax_and_port(family)
    jmask, mask = jpr.init_mask(params, family), pr.init_mask(model, family)
    assert pr.sparsity(mask) == jpr.sparsity(jmask) == 0.0
    for expect in (10.0, 19.0, 27.1, 34.39, 40.95):
        jmask = jpr.imp_prune_step(params, jmask, 0.1)
        mask = pr.imp_prune_step(model, mask, 0.1)
        want = _port_mask_of(jmask, params)
        for k, m in mask.items():
            if m is None:
                assert want[k] is None, k
            else:
                np.testing.assert_array_equal(m.numpy(), want[k], err_msg=k)
        assert pr.sparsity(mask) == jpr.sparsity(jmask)
        assert abs(pr.sparsity(mask) - expect) < 0.15


def test_imp_prune_step_counts_exactly_and_breaks_ties_in_jax_flat_order():
    """k = round(fraction * survivors) weights go, the smallest |w| among
    the survivors; among equal |w| the lower JAX flat index goes first (the
    JAX package's leaves in sorted path order, [L, in, out] raveled)."""
    _, model = _jax_and_port("uc2")
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(0.5)
    mask = pr.imp_prune_step(model, pr.init_mask(model), 0.1)
    n = sum(m.numel() for m in mask.values() if m is not None)
    k = int(round(0.1 * n))
    assert sum(int((m == 0).sum()) for m in mask.values()
               if m is not None) == k
    # sorted JAX paths: encoder/attn/k/w comes first, block 0 then block 1,
    # each [in, out] row-major, i.e. the port's [out, in] weight transposed
    flat = torch.cat([mask[f"encoder.{b}.attn.k.weight"].t().reshape(-1)
                      for b in range(2)])
    assert bool((flat[:k] == 0).all()) and bool((flat[k:] == 1).all())


def test_mask_files_interchange_with_jax(tmp_path):
    """The port writes JAX's npz (keys, [L, in, out] float32 stacks) and
    JAX's load_mask reads it; the port reads JAX's file; a key that is not a
    prunable path raises ValueError in both."""
    params, model = _jax_and_port("uc2")
    mask = pr.imp_prune_step(model, pr.init_mask(model), 0.2)
    jmask = jpr.imp_prune_step(params, jpr.init_mask(params), 0.2)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    pr.save_mask(ours, mask)
    jpr.save_mask(theirs, jmask)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(pr.PRUNABLE_UC2)
        for key in a.files:
            assert a[key].dtype == b[key].dtype == np.float32
            assert a[key].shape == b[key].shape
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert np.load(ours)["encoder/ffn/w1/w"].shape == (2, 32, 64)
    got = _port_mask_of(jpr.load_mask(ours, params), params)
    back = pr.load_mask(theirs, model)
    for k, m in mask.items():
        if m is None:
            assert got[k] is None and back[k] is None, k
        else:
            np.testing.assert_array_equal(got[k], m.numpy(), err_msg=k)
            assert torch.equal(back[k], m), k
    bad = str(tmp_path / "bad.npz")
    with np.load(theirs) as b:
        np.savez(bad, **{k: b[k] for k in b.files},
                 **{"encoder/ln1/scale": np.ones((2, 32), np.float32)})
    with pytest.raises(ValueError, match="not prunable"):
        pr.load_mask(bad, model)
    with pytest.raises(ValueError, match="not prunable"):
        jpr.load_mask(bad, params)


def test_masked_weights_stay_zero_through_port_steps():
    """SFT: the pruned weights start at 0 and stay exactly 0 through 3 port
    train steps with weight decay and dropout (tests/test_pruning_ckpt.py:129
    for the port); the surviving weights move."""
    model = UC2(UC2Config(**TINY), device="cpu", seed=0)
    mask = pr.imp_prune_step(model, pr.init_mask(model), 0.3)
    pr.apply_mask(model, mask)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = make_optimizer(list(before), 1e-3, weight_decay=1e-2)
    state = tloop.TrainState(model, opt.init(dict(model.named_parameters())),
                             0)
    Dm = torch.from_numpy(np.random.RandomState(0).rand(L, L).astype(
        np.float32))
    step = tloop.make_train_step(opt, Dm, semantic_lambda=10.0, top_k=4,
                                 compute_dtype=None,
                                 grad_mask=pr.grad_mask_tree(mask))
    r = np.random.RandomState(0)
    batch = {"input_ids": torch.from_numpy(
                 r.randint(3, 128, (1, 8, 6)).astype(np.int32)),
             "input_mask": torch.ones(1, 8, 6, dtype=torch.int32),
             "features": torch.from_numpy(r.randn(1, 8, 4, 16).astype(
                 np.float32)),
             "locs": torch.from_numpy(r.rand(1, 8, 4, 7).astype(np.float32)),
             "image_mask": torch.ones(1, 8, 4, dtype=torch.int32),
             "labels": torch.from_numpy(
                 r.randint(0, L, (1, 8)).astype(np.int32))}
    for i in range(3):
        state, _ = step(state, batch, seed=i)
    for k, p in model.named_parameters():
        if mask[k] is None:
            continue
        assert bool((p[mask[k] == 0] == 0).all()), k
        assert bool((p[mask[k] == 1] != before[k][mask[k] == 1]).any()), k


def test_async_save_holds_the_weights_of_its_submit_across_a_rewind(tmp_path):
    """The saver snapshots on submit, so rewinding the model in place while
    a best-params save is in flight does not reach the file."""
    model = UC2(UC2Config(**TINY), device="cpu", seed=0)
    theta0 = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    trained = {k: v.clone() for k, v in model.state_dict().items()}
    saver = ckpt.AsyncSaver()
    saver.save_params(str(tmp_path), "params_best", model)
    model.load_state_dict(theta0)                   # the rewind
    saver.wait()
    got = ckpt.load_params(str(tmp_path), "params_best")
    assert all(torch.equal(got[k], trained[k]) for k in trained)


# -- the recipes against the JAX runner ---------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pruning")
    r = np.random.RandomState(0)
    store = str(tmp / "f.cfs")
    with CfsWriter(store) as w:
        for i in range(N_IMGS):
            n = r.randint(3, 8)
            boxes = np.stack([r.rand(n) * 40, r.rand(n) * 40,
                              50 + r.rand(n) * 40, 50 + r.rand(n) * 40],
                             1).astype(np.float32)
            w.add(RegionRecord(f"i{i}", r.randn(n, 16).astype(np.float32),
                               boxes, 100.0, 100.0))
    qs = [dict(question_id=i, image_id=f"i{i % N_IMGS}",
               question=f"marker{i % L} what is it ?", labels=[i % L],
               scores=[1.0]) for i in range(N_Q)]
    Dm = np.random.RandomState(1).rand(L, L).astype(np.float32)
    np.fill_diagonal(Dm, 0)
    return tmp, store, qs, Dm


def _dkw(family):
    kw = dict(max_seq_length=8, max_region_num=6, num_labels=L)
    return (dict(kw, num_locs=7) if family == "uc2"
            else dict(kw, num_locs=5, norm_embeddings=True))


def _port_runner(world, sub, model, family="uc2", **kw):
    tmp, store, qs, Dm = world
    entries = [Entry(**q) for q in qs]
    ds = GQADataset(entries, CfsReader(store), HashTokenizer(128),
                    **_dkw(family))
    val = GQADataset(entries[:16], CfsReader(store), HashTokenizer(128),
                     **_dkw(family))
    pipe = TrainPipeline(ds, micro_batch_size=8, grad_acc_steps=2, seed=0,
                         device="cpu")
    out = str(tmp / sub)
    return D.FinetuneRunner(model, pipe, val, Dm, task_cfg=TaskConfig(**TASK),
                            optim_cfg=OptimConfig(**OPT), output_dir=out,
                            compute_dtype=None, model_name=family, **kw), out


def _jax_runner(world, sub, params0, family="uc2"):
    tmp, store, qs, Dm = world
    jcfg, jmod, _ = _family(family)
    entries = [JEntry(**q) for q in qs]
    ds = JDataset(entries, JReader(store), JTok(128), **_dkw(family))
    val = JDataset(entries[:16], JReader(store), JTok(128), **_dkw(family))
    pipe = JPipeline(ds, micro_batch_size=8, grad_acc_steps=2, seed=0)
    out = str(tmp / sub)
    return JRunner(jmod.forward, jcfg, params0, pipe, val, Dm,
                   task_cfg=JTask(**TASK), optim_cfg=JOptim(**OPT),
                   output_dir=out, compute_dtype=None,
                   model_name=family), out


def _records(out):
    return [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]


def _meta(out):
    with open(os.path.join(out, "meta.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def imp_runs(world, monkeypatch_module):
    """imp_prune for 2 rounds of 10% by each package from the same weights;
    the port's evaluate and imp_prune_step are spied on."""
    params0, model = _jax_and_port("uc2")
    jr, jout = _jax_runner(world, "jax_imp", params0)
    jres = jr.imp_prune(fraction=0.1)
    theta0 = {k: v.clone() for k, v in model.state_dict().items()}
    tr, tout = _port_runner(world, "port_imp", model)
    evaluated, pruned = [], []
    orig_eval, orig_prune = tr.evaluate, pr.imp_prune_step

    def eval_spy(m, epoch):
        evaluated.append({k: v.clone() for k, v in m.state_dict().items()})
        return orig_eval(m, epoch)

    def prune_spy(params, mask, fraction):
        pruned.append(({k: v.detach().clone()
                        for k, v in params.named_parameters()}, dict(mask)))
        return orig_prune(params, mask, fraction)

    tr.evaluate = eval_spy
    monkeypatch_module.setattr(pr, "imp_prune_step", prune_spy)
    tres = tr.imp_prune(fraction=0.1)
    monkeypatch_module.undo()
    return (jres, jout), (tres, tout), theta0, evaluated, pruned, params0


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_imp_prune_history_matches_jax(imp_runs):
    (jres, jout), (tres, tout), *_ = imp_runs
    assert len(tres["history"]) == len(jres["history"]) == 2
    for g, w in zip(tres["history"], jres["history"]):
        assert g["epoch"] == w["epoch"]
        assert g["sparsity"] == w["sparsity"]
        np.testing.assert_allclose(g["score"], w["score"], atol=1e-6)
    assert abs(tres["history"][0]["sparsity"] - 10.0) < 0.1
    assert abs(tres["history"][1]["sparsity"] - 19.0) < 0.1
    assert tres["best_epoch"] == jres["best_epoch"]
    np.testing.assert_allclose(tres["best_score"], jres["best_score"],
                               atol=1e-6)
    want, got = _records(jout), _records(tout)
    assert [(r["kind"], r["epoch"], r["step"]) for r in got] == \
        [(r["kind"], r["epoch"], r["step"]) for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
    assert sorted(f for f in os.listdir(tout) if f.endswith(".npz")) == \
        sorted(f for f in os.listdir(jout) if f.endswith(".npz")) == \
        ["mask_best.npz", "mask_lt0.npz", "mask_lt1.npz"]
    with open(os.path.join(tout, "prune_meta.json")) as f:
        pmeta = json.load(f)
    with open(os.path.join(jout, "prune_meta.json")) as f:
        assert set(pmeta) == set(json.load(f))
    assert pmeta["next_round"] == 2


def test_imp_prune_masks_match_jax_off_the_threshold(imp_runs):
    """Each round's mask is JAX's, except at weights whose trained |w| lies
    within the trajectory tolerance of the round's threshold (those, and
    the weights a differing earlier mask let move, are printed)."""
    (_, jout), (_, tout), _, _, pruned, _ = imp_runs
    _, model = _jax_and_port("uc2")
    excused: dict[str, torch.Tensor] = {}
    for rnd, (weights, mask_in) in enumerate(pruned):
        ours = pr.load_mask(os.path.join(tout, f"mask_lt{rnd}.npz"), model)
        theirs = pr.load_mask(os.path.join(jout, f"mask_lt{rnd}.npz"), model)
        killed = [(weights[k].abs(), (mask_in[k] == 1) & (ours[k] == 0))
                  for k in ours if ours[k] is not None]
        thr = max(float(w[kl].max()) for w, kl in killed if kl.any())
        n_near = n_diff = 0
        for k, m in ours.items():
            if m is None:
                continue
            near = (mask_in[k] == 1) & (
                (weights[k].abs() - thr).abs() <= RTOL * thr + ATOL)
            excused[k] = excused.get(k, torch.zeros_like(near)) | near
            diff = m != theirs[k]
            n_near += int(near.sum())
            n_diff += int(diff.sum())
            assert not bool((diff & ~excused[k]).any()), (rnd, k)
        print(f"round {rnd}: threshold {thr:.6g}; {n_near} weights within "
              f"the tolerance of it, {n_diff} mask elements differ from JAX's")


def test_imp_prune_evaluates_the_rewound_theta0_times_mask(imp_runs):
    """The score that picks mask_best is taken on theta_0 * mask, exactly
    (tests/test_driver.py:93 for the port): surviving weights equal
    theta_0, pruned ones are 0, everything else is theta_0."""
    _, (_, tout), theta0, evaluated, _, _ = imp_runs
    _, model = _jax_and_port("uc2")
    assert len(evaluated) == 2
    for rnd, got in enumerate(evaluated):
        mask = pr.load_mask(os.path.join(tout, f"mask_lt{rnd}.npz"), model)
        for k, v in got.items():
            if mask.get(k) is None:
                assert torch.equal(v, theta0[k]), k
            else:
                assert torch.equal(v, theta0[k] * mask[k]), k
                assert bool((v[mask[k] == 0] == 0).all()), k
        assert any(bool((m == 0).any()) for m in mask.values()
                   if m is not None)


@pytest.mark.parametrize("family", ["uc2", "m3p"])
def test_sft_from_a_jax_mask_matches_jax(world, tmp_path, family):
    """sft from one JAX-written mask_best.npz: per-step losses rtol 1e-4,
    scores to 1e-6, final params rtol 1e-3 atol 1e-5; the exported
    model_best_sft.bin holds exactly 0 at every pruned weight."""
    params0, model = _jax_and_port(family, seed=5)
    mask_path = str(tmp_path / "mask_best.npz")
    jpr.save_mask(mask_path, jpr.imp_prune_step(
        params0, jpr.init_mask(params0, family), 0.3))
    jr, jout = _jax_runner(world, f"jax_sft_{family}", params0, family)
    jbest = jr.sft(mask_path)
    tr, tout = _port_runner(world, f"port_sft_{family}", model, family)
    tbest = tr.sft(mask_path)
    want, got = _records(jout), _records(tout)
    assert [(r["kind"], r["epoch"], r["step"]) for r in got] == \
        [(r["kind"], r["epoch"], r["step"]) for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["score"], w["score"], atol=1e-6)
    np.testing.assert_allclose(tbest, jbest, atol=1e-6)
    jparams = jckpt.load_params(jout, _meta(jout)["state_dir"])["params"]
    want_p = TC.jax_params_to_state_dict(jax.tree.map(np.asarray, jparams))
    for k, p in tr.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    mask = pr.load_mask(mask_path, model, family)
    from clg_vqa_tpu_torch.cli.common import load_pretrained
    cfg = _family(family)[2]
    sd = load_pretrained(os.path.join(tout, "model_best_sft.bin"), cfg)
    n_zero = 0
    for k, m in mask.items():
        if m is not None:
            pruned = m.numpy() == 0
            assert np.all(sd[k][pruned] == 0.0), k
            assert np.all(tr.model.state_dict()[k].numpy()[pruned] == 0.0), k
            n_zero += int(pruned.sum())
    assert n_zero > 0
    assert os.path.isfile(os.path.join(tout, "params_best", "params.pt"))


# -- prune resume (port only, dropout on) -------------------------------------

def _resume_runner(world, sub):
    return _port_runner(world, sub, UC2(UC2Config(**TINY), device="cpu",
                                        seed=0))


def _preempt_after(runner, n_steps):
    count = {"n": 0}

    def hook(i):
        count["n"] += 1
        if count["n"] >= n_steps:
            runner._preempted = True

    runner._step_callback = hook


def _masks(out):
    res = {}
    for f in sorted(os.listdir(out)):
        if f.startswith("mask_") and f.endswith(".npz"):
            with np.load(os.path.join(out, f)) as z:
                res[f] = {k: z[k].copy() for k in z.files}
    return res


def _assert_same_masks(out_a, out_b):
    masks_a, masks_b = _masks(out_a), _masks(out_b)
    assert masks_a.keys() == masks_b.keys()
    for f in masks_a:
        assert masks_a[f].keys() == masks_b[f].keys(), f
        for p in masks_a[f]:
            np.testing.assert_array_equal(masks_a[f][p], masks_b[f][p],
                                          err_msg=f"{f}:{p}")


@pytest.fixture(scope="module")
def uninterrupted(world):
    runner, out = _resume_runner(world, "pr_a")
    assert runner.model.cfg.hidden_dropout_prob == 0.1
    res = runner.imp_prune(fraction=0.25)
    return res, out, {k: v.clone() for k, v in runner.model.state_dict().items()}


# 4 steps a round x 2 rounds: kill mid round 0, at round 0's train boundary
# (trained, not yet pruned), mid round 1
@pytest.mark.parametrize("kill_at", [2, 4, 6])
def test_prune_resume_bit_identical(world, uninterrupted, kill_at):
    want, out_a, final = uninterrupted
    runner_b, out_b = _resume_runner(world, f"pr_b{kill_at}")
    _preempt_after(runner_b, kill_at)
    with pytest.raises(SystemExit):
        runner_b.imp_prune(fraction=0.25)
    meta = _meta(out_b)
    assert meta["prune"]["round"] == (kill_at - 1) // 4
    assert meta["mid_epoch_step"] == ((kill_at - 1) % 4) + 1
    runner_c, _ = _resume_runner(world, f"pr_b{kill_at}")
    got = runner_c.imp_prune(fraction=0.25, resume=True)
    assert got == want
    _assert_same_masks(out_a, out_b)
    for k, v in runner_c.model.state_dict().items():
        assert torch.equal(v, final[k]), k


def test_prune_resume_double_kill_and_completed_run(world, uninterrupted):
    """Two interruptions (mid round 0, then mid round 1 after round 0's
    prune_meta record exists), each resumed: still bit-identical. A resume
    of the completed run ignores the stale mid-round state (its round
    predates prune_meta's next_round) and retrains nothing."""
    want, out_a, _ = uninterrupted
    runner_b, out_b = _resume_runner(world, "pr_dk")
    _preempt_after(runner_b, 2)
    with pytest.raises(SystemExit):
        runner_b.imp_prune(fraction=0.25)
    runner_b2, _ = _resume_runner(world, "pr_dk")
    _preempt_after(runner_b2, 5)       # 2 finish round 0, 3 into round 1
    with pytest.raises(SystemExit):
        runner_b2.imp_prune(fraction=0.25, resume=True)
    with open(os.path.join(out_b, "prune_meta.json")) as f:
        assert json.load(f)["next_round"] == 1
    meta = _meta(out_b)
    assert meta["prune"]["round"] == 1 and meta["mid_epoch_step"] == 3
    runner_c, _ = _resume_runner(world, "pr_dk")
    assert runner_c.imp_prune(fraction=0.25, resume=True) == want
    _assert_same_masks(out_a, out_b)

    runner_d, _ = _resume_runner(world, "pr_dk")

    def never(i):
        raise AssertionError("resuming a completed prune must not retrain")

    runner_d._step_callback = never
    assert runner_d.imp_prune(fraction=0.25, resume=True) == want
