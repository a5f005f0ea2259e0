"""The port's checkpoints (clg_vqa_tpu_torch/train/checkpoints.py) on the CPU:
the full-state round trip, params-only resume points with the count
fast-forwarded (tests/test_params_only_ckpt.py for the port), the atomic
meta.json pointer swap when a save dies midway, AsyncSaver's snapshots and
error re-raise, and the VOLTA .bin export loaded by the JAX package.

Tolerances: round trips are bit-exact; the JAX logits of the exported .bin
against the port's within rtol 1e-5, atol 1e-5 (fp32, two frameworks'
summation orders)."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clg_vqa_tpu.cli import common as jcommon
from clg_vqa_tpu.config import UC2Config as JConfig
from clg_vqa_tpu.models import uc2 as juc2
from clg_vqa_tpu_torch.config import OptimConfig, TaskConfig, UC2Config
from clg_vqa_tpu_torch.models.uc2 import UC2
from clg_vqa_tpu_torch.train import checkpoints as ckpt
from clg_vqa_tpu_torch.train.loop import TrainState, make_train_step
from clg_vqa_tpu_torch.train.optim import make_optimizer
from clg_vqa_tpu_torch.utils import convert as TC

torch.set_num_threads(1)

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, v_feature_size=16, num_locs=7,
            pooler_size=32, clf_hidden_size=32, num_labels=8)


def _batch(seed, acc=2, mbs=4, T=6, R=4):
    r = np.random.RandomState(seed)
    return {"input_ids": torch.from_numpy(r.randint(3, 64, (acc, mbs, T))),
            "input_mask": torch.ones(acc, mbs, T, dtype=torch.int32),
            "features": torch.from_numpy(r.randn(acc, mbs, R, 16).astype(np.float32)),
            "locs": torch.from_numpy(r.rand(acc, mbs, R, 7).astype(np.float32)),
            "image_mask": torch.ones(acc, mbs, R, dtype=torch.int32),
            "labels": torch.from_numpy(r.randint(0, 8, (acc, mbs)))}


def _trained_state(steps=3, seed=0):
    """A tiny UC2 after a few AdamW steps, so every moment is non-zero."""
    model = UC2(UC2Config(**TINY), device="cpu", seed=seed)
    params = dict(model.named_parameters())
    opt = make_optimizer(list(params), 1e-3)
    state = TrainState(model, opt.init(params), 0)
    step = make_train_step(opt, torch.rand(8, 8), semantic_lambda=1.0,
                           top_k=4, compute_dtype=None)
    for i in range(steps):
        state, _ = step(state, _batch(i), seed=i)
    return state, opt


def _fresh(opt, seed=5):
    model = UC2(UC2Config(**TINY), device="cpu", seed=seed)
    return TrainState(model, opt.init(dict(model.named_parameters())), 0)


def _assert_same_state(a: TrainState, b: TrainState):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    pa = dict(a.model.named_parameters())
    for k, p in b.model.named_parameters():
        assert torch.equal(p, pa[k]), k
    for f in ("mu", "nu"):
        ma, mb = getattr(a.opt_state, f), getattr(b.opt_state, f)
        assert set(ma) == set(mb)
        for k in ma:
            assert torch.equal(ma[k], mb[k]), (f, k)


def test_full_state_round_trip(tmp_path):
    state, opt = _trained_state()
    d = str(tmp_path / "ck")
    rec = ckpt.save_state(d, state, epoch=2, best_score=0.41,
                          extra={"logger": {"global_step": 3},
                                 "mid_epoch_step": 1})
    meta = json.load(open(os.path.join(d, "meta.json")))
    assert meta == {"epoch": 2, "best_score": 0.41, "step": 3,
                    "state_dir": "state_e2_s3", "logger": {"global_step": 3},
                    "mid_epoch_step": 1}
    assert rec["bytes"] == os.path.getsize(
        os.path.join(d, "state_e2_s3", "state.pt"))
    like = _fresh(opt)
    mu_before = like.opt_state.mu
    got, gmeta = ckpt.resume_state(d, like)
    assert gmeta == meta
    _assert_same_state(state, got)
    # restored in place: the like state's tensors now hold the values
    assert got.model is like.model and got.opt_state.mu is mu_before
    # the same (epoch, step) again never overwrites the live directory
    ckpt.save_state(d, state, epoch=2, best_score=0.5)
    assert json.load(open(os.path.join(d, "meta.json")))["state_dir"] == \
        "state_e2_s3b"
    assert sorted(os.listdir(d)) == ["meta.json", "state_e2_s3b"]


def test_resume_without_a_checkpoint_raises(tmp_path):
    _, opt = _trained_state(steps=0)
    with pytest.raises(FileNotFoundError):
        ckpt.resume_state(str(tmp_path / "none"), _fresh(opt))


def test_params_only_fastforwards_the_count(tmp_path):
    """Params bit-exact, moments fresh (zero), count fast-forwarded to the
    step; the file holds about a third of a full save."""
    state, opt = _trained_state()
    assert all(m.abs().max() > 0 for m in state.opt_state.mu.values()
               if m.numel() > 1)
    full = ckpt.save_state(str(tmp_path / "full"), state, epoch=0,
                           best_score=0.0)
    d = str(tmp_path / "po")
    po = ckpt.save_state(d, state, epoch=2, best_score=0.41, params_only=True)
    assert po["bytes"] < 0.45 * full["bytes"]
    meta = json.load(open(os.path.join(d, "meta.json")))
    assert meta["params_only"] is True
    got, meta = ckpt.resume_state(d, _fresh(opt))
    assert meta["epoch"] == 2 and got.step == 3 and got.opt_state.count == 3
    pa = dict(state.model.named_parameters())
    for k, p in got.model.named_parameters():
        assert torch.equal(p, pa[k]), k
    assert all(float(m.abs().max()) == 0.0 for m in got.opt_state.mu.values())


def test_a_save_that_dies_midway_leaves_a_readable_pair(tmp_path, monkeypatch):
    """The pointer swap of clg_vqa_tpu/train/checkpoints.py:95-120: a save
    killed while writing its state leaves meta.json on the previous state,
    which still resumes; the next save clears the partial directory."""
    state, opt = _trained_state(steps=2)
    d = str(tmp_path / "ck")
    ckpt.save_state(d, state, epoch=0, best_score=0.1)
    later, _ = _trained_state(steps=3)
    real_save = torch.save

    def dying_save(obj, path, *a, **k):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("disk gone")

    monkeypatch.setattr(torch, "save", dying_save)
    with pytest.raises(OSError):
        ckpt.save_state(d, later, epoch=0, best_score=0.2)
    monkeypatch.setattr(torch, "save", real_save)
    assert json.load(open(os.path.join(d, "meta.json")))["state_dir"] == \
        "state_e0_s2"
    assert os.path.isdir(os.path.join(d, "state_e0_s3"))      # the partial
    got, meta = ckpt.resume_state(d, _fresh(opt))
    _assert_same_state(state, got)
    ckpt.save_state(d, later, epoch=0, best_score=0.2)
    assert sorted(os.listdir(d)) == ["meta.json", "state_e0_s3"]
    _assert_same_state(later, ckpt.resume_state(d, _fresh(opt))[0])


def test_async_saver_snapshots_before_later_updates(tmp_path):
    state, opt = _trained_state()
    log = []
    s = ckpt.AsyncSaver(log)
    d = str(tmp_path / "a")
    want = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    mu = {k: m.clone() for k, m in state.opt_state.mu.items()}
    s.save_state(d, state, epoch=1, best_score=0.2)
    s.save_params(d, "params_best", state.model)
    with torch.no_grad():           # the next step's in-place update
        for p in state.model.parameters():
            p.add_(1.0)
        for m in state.opt_state.mu.values():
            m.add_(1.0)
    s.wait()
    assert [r["what"] for r in log] == ["state", "params"]
    got, _ = ckpt.resume_state(d, _fresh(opt))
    for k, p in got.model.named_parameters():
        assert torch.equal(p, want[k]), k
    for k, m in got.opt_state.mu.items():
        assert torch.equal(m, mu[k]), k
    sd = ckpt.load_params(d, "params_best")
    assert all(torch.equal(sd[k], want[k]) for k in want)
    like = UC2(UC2Config(**TINY), device="cpu", seed=9)
    assert ckpt.load_params(d, "params_best", like) is like
    assert torch.equal(like.pooler.weight, want["pooler.weight"])


def test_async_saver_params_only(tmp_path):
    state, opt = _trained_state()
    s = ckpt.AsyncSaver()
    d = str(tmp_path / "a")
    s.save_state(d, state, epoch=1, best_score=0.2, params_only=True)
    s.wait()
    got, meta = ckpt.resume_state(d, _fresh(opt))
    assert meta["params_only"] and got.step == 3 and got.opt_state.count == 3


def test_async_saver_reraises_a_failed_save(tmp_path):
    state, _ = _trained_state(steps=0)
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    s = ckpt.AsyncSaver()
    s.save_params(str(blocker), "params_best", state.model)
    with pytest.raises(RuntimeError, match="async checkpoint save failed") as e:
        s.wait()
    assert isinstance(e.value.__cause__, OSError)
    s.wait()                       # reported once
    s.save_params(str(blocker), "p", state.model)
    with pytest.raises(RuntimeError):      # re-raised at the next submit
        s.save_params(str(tmp_path / "ok"), "p", state.model)


def test_export_torch_bin_loads_in_jax(tmp_path):
    """The port's .bin, read by the JAX package's cli.common.load_pretrained,
    gives back the JAX params bit for bit and the port's logits."""
    jcfg = JConfig(**TINY)
    params = juc2.init_params(jax.random.key(4), jcfg)
    model = TC.from_jax_params(params, UC2Config(**TINY), device="cpu")
    path = str(tmp_path / "model.bin")
    rec = ckpt.export_torch_bin(path, model)
    assert rec["bytes"] == os.path.getsize(path)
    sd = torch.load(path, weights_only=True)
    assert torch.equal(sd["bert.encoder.layer.0.attention_self.v_query.weight"],
                       sd["bert.encoder.layer.0.attention_self.query.weight"])
    loaded = jcommon.load_pretrained(path, jcfg, False)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(loaded),
            jax.tree_util.tree_leaves_with_path(params)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    b = {k: v[0].numpy() for k, v in _batch(11).items()}
    want = juc2.forward(jax.tree.map(jnp.asarray, loaded), jcfg,
                        jax.tree.map(jnp.asarray, b))
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # M3P export is ported (tests/test_torch_m3p.py); a UC2 is no M3P, and a
    # name that is neither model raises
    with pytest.raises(KeyError, match="not an M3P"):
        ckpt.export_torch_bin(path, model, "m3p")
    with pytest.raises(ValueError, match="uc2"):
        ckpt.export_torch_bin(path, model, "lxmert")


def test_runner_mid_save_params_gap_epochs(tmp_path):
    """With mid_save='params' and save_every past the horizon, the gap
    epoch leaves a params-only resume point; the resumed run continues at
    the next epoch (epoch 0 is not trained again) and ends with a full
    save (tests/test_params_only_ckpt.py for the port)."""
    from clg_vqa_tpu_torch.data.cfs import CfsReader, CfsWriter
    from clg_vqa_tpu_torch.data.features import RegionRecord
    from clg_vqa_tpu_torch.data.gqa import Entry, GQADataset
    from clg_vqa_tpu_torch.data.pipeline import TrainPipeline
    from clg_vqa_tpu_torch.data.tokenizer import HashTokenizer
    from clg_vqa_tpu_torch.train.driver import FinetuneRunner

    r = np.random.RandomState(0)
    L = 6
    store = str(tmp_path / "f.cfs")
    with CfsWriter(store) as w:
        for i in range(8):
            n = r.randint(3, 8)
            boxes = np.stack([r.rand(n) * 40, r.rand(n) * 40,
                              50 + r.rand(n) * 40, 50 + r.rand(n) * 40],
                             1).astype(np.float32)
            w.add(RegionRecord(f"i{i}", r.randn(n, 16).astype(np.float32),
                               boxes, 100.0, 100.0))
    entries = [Entry(question_id=i, image_id=f"i{i % 8}",
                     question=f"marker{i % L} what ?", labels=[i % L],
                     scores=[1.0]) for i in range(32)]
    ds = GQADataset(entries, CfsReader(store), HashTokenizer(128),
                    max_seq_length=8, max_region_num=6, num_locs=7,
                    num_labels=L)
    cfg = UC2Config(**dict(TINY, vocab_size=128, num_labels=L))
    task = TaskConfig(num_labels=L, max_seq_length=8, max_region_num=6,
                      batch_size=16, eval_batch_size=16, lr=5e-3, num_epoch=2,
                      semantic_lambda=1.0)

    def mk(out):
        pipe = TrainPipeline(ds, micro_batch_size=8, grad_acc_steps=2, seed=0,
                             device="cpu")
        return FinetuneRunner(UC2(cfg, device="cpu", seed=0), pipe, None, None,
                              task_cfg=task,
                              optim_cfg=OptimConfig(lr=5e-3, grad_acc_steps=2),
                              output_dir=out, compute_dtype=None,
                              async_ckpt=False, save_every=99,
                              mid_save="params")

    out = str(tmp_path / "run")

    class Stop(Exception):
        pass

    runner = mk(out)
    n = {"d": 0}

    def hook(i):
        n["d"] += 1
        if n["d"] > 2:           # 2 steps an epoch: stop inside epoch 1
            raise Stop()

    runner._step_callback = hook
    with pytest.raises(Stop):
        runner.finetune()
    meta = json.load(open(os.path.join(out, "meta.json")))
    assert meta["params_only"] is True and meta["epoch"] == 0

    resumed = mk(out)
    seen = []
    resumed._step_callback = seen.append
    resumed.finetune(resume=True)
    assert seen == [0, 1]
    meta = json.load(open(os.path.join(out, "meta.json")))
    assert meta["epoch"] == 1 and not meta.get("params_only")
