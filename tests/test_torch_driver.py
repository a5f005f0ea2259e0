"""The port's FinetuneRunner (clg_vqa_tpu_torch/train/driver.py) against the
JAX package's on the world of tests/test_driver.py: the same store,
questions, distance matrix and recipe (2 epochs of 4 steps, acc 2 x mbs 8,
fp32, all dropouts 0), the port's model made from the JAX params0 by
from_jax_params.

Tolerances: the train step's 20-step trajectory tolerances of
tests/test_torch_train.py — per-step losses and val losses rtol 1e-4,
final params rtol 1e-3 atol 1e-5 (fp32 summation order compounds over
steps); lr rtol 1e-6 (the same fp32 schedule arithmetic); val scores and
train scores equal to 1e-6 (counts of argmax hits). Preemption and resume
(port only, dropout on) must be bit-identical."""
import json
import os

import numpy as np
import pytest
import torch

import jax

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
from clg_vqa_tpu.models import uc2 as juc2
from clg_vqa_tpu.train import checkpoints as jckpt
from clg_vqa_tpu.train.driver import FinetuneRunner as JRunner
from clg_vqa_tpu_torch.config import (M3PConfig, OptimConfig, TaskConfig,
                                      UC2Config)
from clg_vqa_tpu_torch.data.cfs import CfsReader
from clg_vqa_tpu_torch.data.gqa import Entry, GQADataset
from clg_vqa_tpu_torch.data.pipeline import TrainPipeline
from clg_vqa_tpu_torch.data.tokenizer import HashTokenizer
from clg_vqa_tpu_torch.models.m3p import M3P
from clg_vqa_tpu_torch.models.uc2 import UC2
from clg_vqa_tpu_torch.train import driver as D
from clg_vqa_tpu_torch.utils import convert as TC

torch.set_num_threads(1)

L, N_IMGS, N_Q = 6, 8, 64
TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, v_feature_size=16, num_locs=7,
            pooler_size=32, clf_hidden_size=32, num_labels=L)
QUIET = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             clf_dropout_prob=0.0)
TASK = dict(num_labels=L, max_seq_length=8, max_region_num=6, batch_size=16,
            eval_batch_size=16, lr=5e-3, num_epoch=2, semantic_lambda=1.0)
OPT = dict(lr=5e-3, grad_acc_steps=2, warmup_proportion=0.1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_driver")
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
    # learnable task: the answer depends on a token of the question
    qs = [dict(question_id=i, image_id=f"i{i % N_IMGS}",
               question=f"marker{i % L} what is it ?", labels=[i % L],
               scores=[1.0]) for i in range(N_Q)]
    params0 = juc2.init_params(jax.random.key(0), JConfig(**TINY, **QUIET))
    Dm = np.random.RandomState(1).rand(L, L).astype(np.float32)
    np.fill_diagonal(Dm, 0)
    return tmp, store, qs, params0, Dm


def _port_datasets(store, qs):
    entries = [Entry(**q) for q in qs]
    kw = dict(max_seq_length=8, max_region_num=6, num_locs=7, num_labels=L)
    return (GQADataset(entries, CfsReader(store), HashTokenizer(128), **kw),
            GQADataset(entries[:16], CfsReader(store), HashTokenizer(128), **kw))


def _port_runner(world, sub, *, cfg=None, quiet=True, model=None, **kw):
    tmp, store, qs, params0, Dm = world
    ds, val = _port_datasets(store, qs)
    pipe = TrainPipeline(ds, micro_batch_size=8, grad_acc_steps=2, seed=0,
                         device="cpu")
    if model is None:
        cfg = cfg or UC2Config(**TINY, **(QUIET if quiet else {}))
        model = UC2(cfg, device="cpu", seed=0)
    out = str(tmp / sub)
    return D.FinetuneRunner(model, pipe, val, Dm, task_cfg=TaskConfig(**TASK),
                            optim_cfg=OptimConfig(**OPT), output_dir=out,
                            compute_dtype=None, **kw), out


def _jax_runner(world, sub, **kw):
    tmp, store, qs, params0, Dm = world
    entries = [JEntry(**q) for q in qs]
    dkw = dict(max_seq_length=8, max_region_num=6, num_locs=7, num_labels=L)
    ds = JDataset(entries, JReader(store), JTok(128), **dkw)
    val = JDataset(entries[:16], JReader(store), JTok(128), **dkw)
    pipe = JPipeline(ds, micro_batch_size=8, grad_acc_steps=2, seed=0)
    out = str(tmp / sub)
    return JRunner(juc2.forward, JConfig(**TINY, **QUIET), params0, pipe, val,
                   Dm, task_cfg=JTask(**TASK), optim_cfg=JOptim(**OPT),
                   output_dir=out, compute_dtype=None, **kw), out


def _records(out):
    return [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]


def _meta(out):
    with open(os.path.join(out, "meta.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def both_runs(world):
    """The recipe run once by each package."""
    jr, jout = _jax_runner(world, "jax_ft")
    jbest = jr.finetune()
    params0 = world[3]
    model = TC.from_jax_params(params0, UC2Config(**TINY, **QUIET),
                               device="cpu")
    tr, tout = _port_runner(world, "port_ft", model=model)
    tbest = tr.finetune()
    return (jbest, jout), (tbest, tout, tr)


def test_finetune_metrics_match_jax(both_runs):
    (jbest, jout), (tbest, tout, _) = both_runs
    want, got = _records(jout), _records(tout)
    assert [(r["kind"], r["epoch"], r["step"]) for r in got] == \
        [(r["kind"], r["epoch"], r["step"]) for r in want]
    assert sum(r["kind"] == "train" for r in got) == 8
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["score"], w["score"], atol=1e-6)
        if g["kind"] == "train":
            np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
    np.testing.assert_allclose(tbest, jbest, atol=1e-6)
    # the tiny task is learnable
    tr = [r for r in got if r["kind"] == "train"]
    assert tr[-1]["loss"] < tr[0]["loss"]


def test_finetune_final_params_match_jax(both_runs):
    (_, jout), (_, tout, runner) = both_runs
    jparams = jckpt.load_params(jout, _meta(jout)["state_dir"])["params"]
    want = TC.jax_params_to_state_dict(jax.tree.map(np.asarray, jparams))
    got = dict(runner.model.named_parameters())
    assert set(got) == set(want)
    for k, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def test_finetune_artifacts_match_jax_layout(both_runs):
    """The same directory names and meta.json keys as the JAX package:
    params_best/, state_e{E}_s{S}/ behind the meta pointer, and the
    logger's state riding in the meta."""
    (_, jout), (_, tout, runner) = both_runs
    jm, tm = _meta(jout), _meta(tout)
    assert set(tm) == set(jm)
    for k in ("epoch", "step", "state_dir"):
        assert tm[k] == jm[k]
    assert tm["state_dir"] == "state_e1_s8"
    assert tm["logger"]["global_step"] == jm["logger"]["global_step"] == 8
    assert os.path.isdir(os.path.join(tout, "params_best"))
    def names(out):       # TensorBoard files are named by time and host
        return sorted("events" if f.startswith("events.out.tfevents") else f
                      for f in os.listdir(out))

    assert names(tout) == names(jout)
    assert {r["what"] for r in runner.save_log} == {"params", "state"}


def test_schedule_horizon_and_lr_match_jax(world):
    jr, _ = _jax_runner(world, "jax_sched")
    tr, _ = _port_runner(world, "port_sched")
    jr._build_opt()
    tr._build_opt()
    assert tr._total_steps() == jr._total_steps() == 4 * 20
    for i in range(0, 12):
        np.testing.assert_allclose(tr._lr_of(i), jr._lr_of(i), rtol=1e-6)
    assert tr._lr_of(0) == 0.0
    assert abs(tr._lr_of(8) - TASK["lr"]) < 1e-9       # the ramp tops out
    assert tr._lr_of(8 * 2) > 0.5 * TASK["lr"]          # never decays to 0


@pytest.mark.parametrize("choice", ["auto", "on", "off", "flat", "sm",
                                    "proj", "yes"])
def test_fused_attn_resolution_matches_jax(world, choice):
    """Each --fused_attn choice resolves to the JAX runner's route on the
    CPU ("proj" to the whole-block kernel B4 in both); an unknown choice
    raises ValueError in both."""
    if choice == "yes":
        with pytest.raises(ValueError):
            _jax_runner(world, "fa_bad_jax", fused_attn=choice)
        with pytest.raises(ValueError):
            _port_runner(world, "fa_bad", fused_attn=choice)
        return
    jr, _ = _jax_runner(world, f"fa_jax_{choice}", fused_attn=choice)
    tr, _ = _port_runner(world, f"fa_{choice}", fused_attn=choice)
    if choice == "proj":
        assert tr.train_fused == jr.train_fused == "proj"
    assert tr.train_fused == jr.train_fused


def test_fused_attn_auto_on_cuda():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert D.resolve_train_fused("auto", torch.bfloat16, cuda) == "flat"
    assert D.resolve_train_fused("auto", None, cuda) is False
    assert D.resolve_train_fused("auto", torch.bfloat16, cpu) is False
    assert D.resolve_train_fused("on", None, cpu) == "flat"
    assert D.resolve_train_fused("sm", torch.bfloat16, cuda) == "sm"


def _preempt_after(runner, n_steps):
    """Set the preemption flag after n_steps steps (the SIGTERM handler
    sets the same flag)."""
    seen = []

    def hook(i):
        seen.append(i)
        if len(seen) >= n_steps:
            runner._preempted = True

    runner._step_callback = hook


SM_CFG = dict(TINY, hidden_size=128, intermediate_size=128, pooler_size=128)


@pytest.mark.parametrize("kill_at", [2, 6])     # epoch 0 step 2, epoch 1 step 2
@pytest.mark.parametrize("fused", ["off", "sm", "proj"])
def test_resume_bit_identical_with_dropout(world, kill_at, fused):
    """Preempted after kill_at steps and resumed in a fresh runner, a run
    with dropout ends with the uninterrupted run's parameters bit for bit
    (tests/test_preemption_resume.py for the port). "sm" and "proj" run
    B5's and B4's plain versions (hidden 128, 2 heads of 64)."""
    cfg = UC2Config(**(SM_CFG if fused in ("sm", "proj") else TINY))
    assert cfg.hidden_dropout_prob == cfg.attention_probs_dropout_prob == 0.1
    a, _ = _port_runner(world, f"res_a_{fused}_{kill_at}", cfg=cfg,
                        fused_attn=fused)
    a.finetune()
    b, out_b = _port_runner(world, f"res_b_{fused}_{kill_at}", cfg=cfg,
                            fused_attn=fused)
    _preempt_after(b, kill_at)
    with pytest.raises(SystemExit):
        b.finetune()
    meta = _meta(out_b)
    assert meta["mid_epoch_step"] == kill_at % 4
    assert meta["epoch"] == kill_at // 4
    c, _ = _port_runner(world, f"res_b_{fused}_{kill_at}", cfg=cfg,
                        fused_attn=fused)
    seen = []
    c._step_callback = seen.append
    c.finetune(resume=True)
    assert seen[0] == kill_at % 4 and len(seen) == 8 - kill_at
    want = dict(a.model.named_parameters())
    for k, p in c.model.named_parameters():
        assert torch.equal(p, want[k]), k
    # the resumed logger carries on the step count
    assert _records(out_b)[-1]["step"] == 8


def test_mid_epoch_eval_saves_best(world):
    """With eval_steps a mid-epoch val pass that improves the best score
    saves params_best (train_task.py:349-356)."""
    r, out = _port_runner(world, "mid_eval", eval_steps=2, async_ckpt=False)
    r.finetune()
    vals = [x for x in _records(out) if x["kind"] == "val"]
    assert len(vals) == 6         # after steps 2 and 4, and at the epoch end
    assert any(rec["what"] == "params" for rec in r.save_log)
    assert os.path.isfile(os.path.join(out, "params_best", "params.pt"))


def test_val_bank_failure_warns_loudly(world, monkeypatch, capsys):
    from clg_vqa_tpu_torch.cli import common as C

    def boom(*a, **k):
        raise MemoryError("no room")

    monkeypatch.setattr(C, "maybe_device_bank", boom)
    r, _ = _port_runner(world, "nobank")
    assert r._val_bank is None
    assert "WARNING: val device bank unavailable (MemoryError: no room)" in \
        capsys.readouterr().err
    assert 0.0 <= r.evaluate(r.model, 0) <= 1.0


def test_runner_defaults_to_the_models_device_and_refuses_m3p(world):
    """The runner runs on its model's device. M3P is ported: model_name
    "m3p" is accepted (test_m3p_finetune_matches_jax runs it); a name that
    is neither model raises."""
    r, _ = _port_runner(world, "dev")
    assert r.device.type == "cpu" and r.D.device.type == "cpu"
    r, _ = _port_runner(world, "m3p", model=M3P(M3PConfig(**M3P_TINY),
                                                device="cpu"),
                        model_name="m3p")
    assert r.model_name == "m3p" and r.device.type == "cpu"
    with pytest.raises(ValueError, match="model_name"):
        _port_runner(world, "lxmert", model_name="lxmert")


M3P_TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=128, v_feature_size=16, num_locs=5,
                max_boxes=6, pooler_size=32, clf_hidden_size=48, num_labels=L,
                dropout=0.0, attention_dropout=0.0, clf_dropout_prob=0.0)


def test_m3p_finetune_matches_jax(world):
    """FinetuneRunner(model_name="m3p") against the JAX runner over the same
    2 tiny epochs (5 locs, L2-normalized features, fp32, dropout 0), the
    port's M3P made from the JAX params0: per-step train and val losses
    rtol 1e-4, scores to 1e-6, final params rtol 1e-3 atol 1e-5, and the
    .bin export reloads into both packages' M3P."""
    from clg_vqa_tpu.config import M3PConfig as JM3PConfig
    from clg_vqa_tpu.models import m3p as jm3p
    from clg_vqa_tpu.cli.common import load_pretrained as jload
    from clg_vqa_tpu_torch.cli.common import load_pretrained
    tmp, store, qs, _, Dm = world
    dkw = dict(max_seq_length=8, max_region_num=6, num_locs=5, num_labels=L,
               norm_embeddings=True)
    jentries = [JEntry(**q) for q in qs]
    jds = JDataset(jentries, JReader(store), JTok(128), **dkw)
    jval = JDataset(jentries[:16], JReader(store), JTok(128), **dkw)
    jcfg = JM3PConfig(**M3P_TINY)
    params0 = jm3p.init_params(jax.random.key(5), jcfg)
    jout = str(tmp / "jax_m3p")
    jr = JRunner(jm3p.forward, jcfg, params0,
                 JPipeline(jds, micro_batch_size=8, grad_acc_steps=2, seed=0),
                 jval, Dm, task_cfg=JTask(**TASK), optim_cfg=JOptim(**OPT),
                 output_dir=jout, compute_dtype=None, model_name="m3p")
    jbest = jr.finetune()

    entries = [Entry(**q) for q in qs]
    ds = GQADataset(entries, CfsReader(store), HashTokenizer(128), **dkw)
    val = GQADataset(entries[:16], CfsReader(store), HashTokenizer(128), **dkw)
    cfg = M3PConfig(**M3P_TINY)
    model = TC.from_jax_params(jax.tree.map(np.asarray, params0), cfg,
                               device="cpu")
    tout = str(tmp / "port_m3p")
    tr = D.FinetuneRunner(
        model, TrainPipeline(ds, micro_batch_size=8, grad_acc_steps=2, seed=0,
                             device="cpu"), val, Dm,
        task_cfg=TaskConfig(**TASK), optim_cfg=OptimConfig(**OPT),
        output_dir=tout, compute_dtype=None, model_name="m3p")
    tbest = tr.finetune()
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
        np.testing.assert_allclose(p.detach().numpy(), want_p[k], rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    tr.export_torch("model.bin")
    tr.flush_saves()
    bin_path = os.path.join(tout, "model.bin")
    sd = load_pretrained(bin_path, cfg)
    for k, p in tr.model.state_dict().items():
        assert np.array_equal(sd[k], p.numpy()), k
    jp = jload(bin_path, jcfg, True)
    assert TC.jax_params_to_state_dict(jax.tree.map(np.asarray, jp)).keys() \
        == sd.keys()


def test_metrics_logger_matches_jax(tmp_path, capsys):
    """The port's MetricsLogger writes the JAX logger's metrics.jsonl
    records and console lines, and its state dict round-trips."""
    from clg_vqa_tpu.utils.logging import MetricsLogger as JLogger
    from clg_vqa_tpu.utils.logging import summarize_params as jsummary
    from clg_vqa_tpu_torch.utils.logging import MetricsLogger, summarize_params
    outs = []
    for cls, sub in ((JLogger, "j"), (MetricsLogger, "t")):
        lg = cls(str(tmp_path / sub), "GQA")
        for i in range(3):
            lg.step_train(0, 1.5 - i * 0.1, 0.25 * i, 1e-4 * i)
        lg.show_train(0)
        lg.step_val(2.0, 3.0, 4.0)
        lg.step_val(1.0, 1.0, 4.0)
        lg.show_val(0)
        lg.step_train(1, 0.5, 0.5, 2e-4)
        st = lg.state_dict()
        lg.close()
        outs.append(([json.loads(x) for x in
                      open(tmp_path / sub / "metrics.jsonl")], st))
        assert any(f.startswith("events.out.tfevents")
                   for f in os.listdir(tmp_path / sub))
    (jrec, jst), (trec, tst) = outs
    assert trec == jrec
    assert {k: v for k, v in tst.items() if k != "elapsed"} == \
        {k: v for k, v in jst.items() if k != "elapsed"}
    again = MetricsLogger(None)
    again.load_state_dict(tst)
    assert again.state_dict()["tr"] == tst["tr"] and again.global_step == 4
    lines = capsys.readouterr().out.splitlines()
    half = len(lines) // 2
    strip = [ln.split(" (")[0] for ln in lines]        # drop elapsed seconds
    assert strip[:half] == strip[half:]
    rows = []
    model = UC2(UC2Config(**TINY), device="cpu", seed=0)
    n = summarize_params(model, print_fn=rows.append)
    m = jsummary(juc2.init_params(jax.random.key(0), JConfig(**TINY)),
                 print_fn=lambda _: None)
    assert n == m == sum(p.numel() for p in model.parameters())
    assert len(rows) == len(dict(model.named_parameters())) + 1
