"""The port's gated VOLTA zoo (clg_vqa_tpu_torch/models/gated.py,
models/embeddings_zoo.py, utils/convert_gated.py, the CLI's dispatch)
against the reference's golden outputs and the JAX package's gated model,
on the five shrunk wirings of tests/fixtures/gated_golden_*.npz (ViLBERT,
LXMERT, VisualBERT, UNITER, VL-BERT; dual-stream, shared single-LN and
unshared single-stream sublayers, the four fusion methods and the three
poolers).

Tolerances: the golden test's (tests/test_gated_parity.py): rtol 2e-4 with
atol 2e-5 on seq_t, seq_v and the pooled outputs, atol 5e-5 on the logits;
against JAX's encode / forward from the same ``sd::`` weights rtol and atol
1e-5; one fp32 train step without dropout against JAX's make_train_step
(loss, grad norm and every parameter after it) rtol 1e-5, atol 1e-6; bf16
logits' argmax agrees with fp32 on at least 2/3 of the rows."""
import dataclasses
import glob
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clg_vqa_tpu.models import gated as jgated
from clg_vqa_tpu.train import loop as jloop
from clg_vqa_tpu.train import optim as jopt
from clg_vqa_tpu.utils.convert_gated import (pytree_to_volta_gated,
                                             volta_gated_to_pytree)
from clg_vqa_tpu_torch.cli import common as C
from clg_vqa_tpu_torch.cli.__main__ import main
from clg_vqa_tpu_torch.config import OptimConfig, TaskConfig
from clg_vqa_tpu_torch.models.gated import Gated, GatedConfig
from clg_vqa_tpu_torch.train import loop as tloop
from clg_vqa_tpu_torch.train import optim as topt
from clg_vqa_tpu_torch.utils import convert as TC
from clg_vqa_tpu_torch.utils.convert_gated import (state_dict_to_volta_gated,
                                                   volta_gated_to_state_dict)

torch.set_num_threads(1)

FIXTURES = sorted(glob.glob(os.path.join(
    os.path.dirname(__file__), "fixtures", "gated_golden_*.npz")))
IDS = [os.path.basename(p)[13:-4] for p in FIXTURES]
JTOL = 1e-5


def _load(path):
    g = np.load(path, allow_pickle=False)
    raw = {**json.loads(str(g["cfg_json"])), "num_labels": g["logits"].shape[1]}
    sd = {k[len("sd::"):]: g[k] for k in g.files if k.startswith("sd::")}
    batch = {"input_ids": np.asarray(g["input_ids"], np.int32),
             "input_mask": np.asarray(g["input_mask"], np.int32),
             "features": np.asarray(g["features"], np.float32),
             "locs": np.asarray(g["locs"], np.float32),
             "image_mask": np.asarray(g["image_mask"], np.int32)}
    return (g, GatedConfig.from_dict(raw), jgated.GatedConfig.from_dict(raw),
            sd, batch)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def close(got, want, rtol=JTOL, atol=JTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_five_fixtures_found():
    assert IDS == ["lxmert", "uniter", "vilbert", "visualbert", "vl-bert"]


@pytest.mark.parametrize("path", FIXTURES, ids=IDS)
def test_golden_matches_reference_and_jax(path):
    g, cfg, jcfg, sd, batch = _load(path)
    model = TC.from_volta(sd, cfg, device="cpu")
    assert isinstance(model, Gated) and model.device.type == "cpu"
    with torch.no_grad():
        seq_t, seq_v, pooled_t, pooled_v = model.encode(_t(batch))
        logits = model(_t(batch))
    for got, key in ((seq_t, "seq_t"), (seq_v, "seq_v"),
                     (pooled_t, "pooled_t"), (pooled_v, "pooled_v")):
        if g[key].size:
            close(got.numpy(), g[key], rtol=2e-4, atol=2e-5)
        else:
            assert got is None, key
    close(logits.numpy(), g["logits"], rtol=2e-4, atol=5e-5)

    params = volta_gated_to_pytree(sd, jcfg)
    jt, jv, jpt, jpv = jgated.encode(params, jcfg, _j(batch))
    close(seq_t.numpy(), jt)
    close(seq_v.numpy(), jv)
    close(pooled_t.numpy(), jpt)
    if jpv is not None:
        close(pooled_v.numpy(), jpv)
    close(logits.numpy(), jgated.forward(params, jcfg, _j(batch)))


@pytest.mark.parametrize("path", FIXTURES, ids=IDS)
def test_jax_pytree_maps_onto_the_port(path):
    """jax_params_to_state_dict walks the gated pytree (its ``sublayers``
    tuple included) onto the port's names, equal to the VOLTA import; a
    fresh JAX init has the port's names and shapes."""
    _, cfg, jcfg, sd, _ = _load(path)
    via_jax = TC.jax_params_to_state_dict(
        jax.tree.map(np.asarray, volta_gated_to_pytree(sd, jcfg)))
    via_volta = volta_gated_to_state_dict(sd, cfg)
    assert sorted(via_jax) == sorted(via_volta)
    for k in via_volta:
        np.testing.assert_array_equal(via_jax[k], via_volta[k], err_msg=k)
    fresh = TC.jax_params_to_state_dict(jax.tree.map(
        np.asarray, jgated.init_params(jax.random.key(0), jcfg)))
    own = Gated(cfg, device="cpu").state_dict()
    assert {k: v.shape for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in own.items()}
    model = TC.from_jax_params(volta_gated_to_pytree(sd, jcfg), cfg,
                               device="cpu")
    assert all(torch.equal(p, torch.from_numpy(via_volta[k]))
               for k, p in model.state_dict().items())


@pytest.mark.parametrize("path", FIXTURES, ids=IDS)
def test_export_round_trip(path):
    """port -> VOLTA names -> port is the identity; the export covers every
    reference key (the shared v_* aliases included) and equals JAX's
    pytree_to_volta_gated key for key."""
    _, cfg, jcfg, sd, batch = _load(path)
    model = TC.from_volta(sd, cfg, device="cpu")
    exported = state_dict_to_volta_gated(model, cfg)
    missing = [k for k in sd if k not in exported and "position_ids" not in k]
    assert not missing, missing
    jexp = pytree_to_volta_gated(volta_gated_to_pytree(sd, jcfg), jcfg)
    assert sorted(exported) == sorted(jexp)
    for k in exported:
        np.testing.assert_array_equal(exported[k], jexp[k], err_msg=k)
    again = TC.from_volta(exported, cfg, device="cpu")
    with torch.no_grad():
        assert torch.equal(model(_t(batch)), again(_t(batch)))


def test_shared_alias_mismatch_raises():
    _, cfg, _, sd, _ = _load(FIXTURES[IDS.index("visualbert")])
    exported = state_dict_to_volta_gated(TC.from_volta(sd, cfg, device="cpu"),
                                         cfg)
    key = "bert.encoder.layer.0.attention_self.v_query.weight"
    assert key in exported
    exported[key] = exported[key] + 1.0
    with pytest.raises(ValueError, match="v_query"):
        volta_gated_to_state_dict(exported, cfg)


def _train_batch(cfg, seed, acc=2, mbs=3, T=10, R=6):
    r = np.random.RandomState(seed)
    ids = r.randint(3, cfg.vocab_size, (acc, mbs, T)).astype(np.int32)
    imask = np.ones((acc, mbs, T), np.int32)
    imask[:, 1, 7:] = 0
    ids[imask == 0] = cfg.pad_token_id
    vmask = np.ones((acc, mbs, R), np.int32)
    vmask[:, 2, 4:] = 0
    return {"input_ids": ids, "input_mask": imask,
            "features": r.randn(acc, mbs, R, cfg.v_feature_size).astype(np.float32),
            "locs": r.rand(acc, mbs, R, cfg.num_locs).astype(np.float32),
            "image_mask": vmask,
            "labels": r.randint(0, cfg.num_labels, (acc, mbs)).astype(np.int32)}


@pytest.mark.parametrize("path", FIXTURES, ids=IDS)
def test_train_step_matches_jax(path):
    """One fp32 step of acc 2 x mbs 3 without dropout (JAX use_dropout=False,
    the port's seed None), lambda 10, lr 1e-3, from the fixture's weights:
    loss, grad norm and every parameter after the step."""
    _, cfg, jcfg, sd, _ = _load(path)
    params = volta_gated_to_pytree(sd, jcfg)
    D = np.random.RandomState(0).rand(cfg.num_labels, cfg.num_labels) \
        .astype(np.float32)
    batch = _train_batch(cfg, 1)
    jo = jopt.make_optimizer(params, jopt.warmup_constant_schedule(1e-3, 0))
    jstate = jloop.TrainState(params, jo.init(params), jnp.zeros((), jnp.int32))
    jstep = jax.jit(jloop.make_train_step(
        jgated.forward, jcfg, jo, jnp.asarray(D), semantic_lambda=10.0,
        top_k=4, compute_dtype=None, use_dropout=False))
    jstate, jm = jstep(jstate, _j(batch), None)

    model = TC.from_volta(sd, cfg, device="cpu")
    named = dict(model.named_parameters())
    opt = topt.make_optimizer(list(named),
                              topt.warmup_constant_schedule(1e-3, 0))
    state = tloop.TrainState(model, opt.init(named), 0)
    step = tloop.make_train_step(opt, torch.from_numpy(D), semantic_lambda=10.0,
                                 top_k=4, compute_dtype=None)
    state, m = step(state, _t(batch), seed=None)
    close(m["loss"].item(), float(jm["loss"]), atol=0)
    close(m["grad_norm"].item(), float(jm["grad_norm"]), atol=0)
    want = TC.jax_params_to_state_dict(jax.tree.map(np.asarray, jstate.params))
    assert state.step == 1 and sorted(want) == sorted(named)
    for k, p in state.model.named_parameters():
        close(p.detach().numpy(), want[k], atol=1e-6)


@pytest.mark.parametrize("path", FIXTURES, ids=IDS)
def test_no_decay_mask_matches_jax(path):
    """The optimizer's weight-decay rule on the port's names equals JAX's
    no_decay_mask on the gated pytree (VL-BERT's visual_ln_text /
    visual_ln_object LayerNorms included)."""
    _, cfg, jcfg, sd, _ = _load(path)
    params = jax.tree.map(np.asarray, volta_gated_to_pytree(sd, jcfg))
    per_leaf = jax.tree.map(lambda p, m: np.full(p.shape, m, np.float32),
                            params, jopt.no_decay_mask(params))
    want = {k: bool(v.flat[0]) for k, v in
            TC.jax_params_to_state_dict(per_leaf).items()}
    got = topt.no_decay_mask(n for n, _ in
                             Gated(cfg, device="cpu").named_parameters())
    assert got == want


@pytest.mark.parametrize("path", FIXTURES, ids=IDS)
def test_bf16_argmax_agrees_with_fp32(path):
    """compute_dtype=bf16 (bf16 products with fp32 accumulation, fp32
    scores, softmax and LN) stays close to fp32: finite logits whose argmax
    agrees on at least 2/3 of the rows (tests/test_gated_parity.py's gate),
    and equals JAX's bf16 argmax."""
    _, cfg, jcfg, sd, batch = _load(path)
    model = TC.from_volta(sd, cfg, device="cpu")
    with torch.no_grad():
        f32 = model(_t(batch)).numpy()
        bf16 = model(_t(batch), compute_dtype=torch.bfloat16).float().numpy()
    assert np.isfinite(bf16).all()
    assert (f32.argmax(-1) == bf16.argmax(-1)).mean() >= 2 / 3
    jb = jgated.forward(volta_gated_to_pytree(sd, jcfg), jcfg, _j(batch),
                        compute_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(bf16.argmax(-1),
                                  np.asarray(jb.astype(jnp.float32)).argmax(-1))


def test_training_forward_dropout_is_seeded():
    """deterministic=False needs a seed; one seed repeats, another differs;
    fused_attn is accepted and ignored."""
    _, cfg, _, sd, batch = _load(FIXTURES[IDS.index("vilbert")])
    model = TC.from_volta(sd, cfg, device="cpu")
    b = _t(batch)
    with torch.no_grad():
        a = model(b, deterministic=False, seed=3)
        assert torch.equal(a, model(b, deterministic=False, seed=3))
        assert not torch.equal(a, model(b, deterministic=False, seed=4))
        assert not torch.equal(a, model(b))
        assert torch.equal(model(b), model(b, fused_attn="flat"))
        with pytest.raises(ValueError, match="seed"):
            model(b, deterministic=False)


@pytest.mark.parametrize("path", FIXTURES, ids=IDS)
def test_fresh_init(path):
    """init_weights follows the JAX init's rules: zero padding rows, the
    classifier xavier-uniform, VisualBERT's visual tables copies of the
    text ones, UNITER's v_ln the text LN, VL-BERT's visual LNs at 0; a seed
    repeats the weights."""
    _, cfg, _, _, _ = _load(path)
    m = Gated(cfg, device="cpu", seed=5).requires_grad_(False)
    e = m.embeddings
    kind = cfg.image_embeddings
    word = e.text.word if kind in ("vilbert", "lxmert") else e.word
    pad = 0 if (cfg.model == "bert" or kind == "vl-bert") else cfg.pad_token_id
    assert float(word[pad].abs().max()) == 0.0 and float(word.std()) > 0.01
    fc2 = m.classifier.fc2.weight
    assert float(fc2.abs().max()) <= np.sqrt(6.0 / sum(fc2.shape))
    if kind == "visualbert":
        assert torch.equal(e.v_position, e.position)
        assert torch.equal(e.v_token_type, e.token_type)
    if kind == "uniter":
        assert torch.equal(e.v_ln.weight, e.ln.weight)
    if kind == "vl-bert":
        assert float(e.visual_ln_text.weight.abs().max()) == 0.0
        assert float(e.visual_ln_object.weight.abs().max()) == 0.0
    again = Gated(cfg, device="cpu", seed=5).state_dict()
    assert all(torch.equal(v, again[k]) for k, v in m.state_dict().items())


def test_vl_bert_needs_three_token_types():
    """VL-BERT's objects read token type row 2: a table of 2 rows raises
    (the reference's lookup raises; JAX's gather clamps to row 1)."""
    _, cfg, _, _, _ = _load(FIXTURES[IDS.index("vl-bert")])
    with pytest.raises(ValueError, match="type_vocab_size"):
        Gated(dataclasses.replace(cfg, type_vocab_size=2), device="cpu")


VILBERT_TINY = dict(
    image_embeddings="vilbert", model="bert", fusion_method="mul",
    vocab_size=128, hidden_size=32, num_attention_heads=2,
    intermediate_size=64, v_feature_size=16, v_hidden_size=32,
    v_num_attention_heads=2, v_intermediate_size=64, num_locs=7,
    pooler_size=32, v_pooler_size=32, clf_hidden_size=32,
    max_position_embeddings=64, layer_norm_eps=1e-12,
    tt_attn_sublayers=[0], t_ff_sublayers=[1, 5],
    vv_attn_sublayers=[2], v_ff_sublayers=[3, 5],
    tv_attn_sublayers=[4], vt_attn_sublayers=[4],
    shared_sublayers=[], single_ln_sublayers=[])


def test_cli_config_dispatch_and_finetune(tmp_path):
    """tests/test_gated_parity.py::test_cli_config_dispatch_and_finetune on
    the port: a ViLBERT-style zoo config routes through the CLI's
    build_configs / build_model to Gated, and FinetuneRunner trains it for
    2 epochs on a tiny world (the loss falls); its VOLTA .bin export reads
    back through the CLI's load_pretrained to the same logits."""
    from clg_vqa_tpu_torch.data.cfs import CfsReader, CfsWriter
    from clg_vqa_tpu_torch.data.features import RegionRecord
    from clg_vqa_tpu_torch.data.gqa import Entry, GQADataset
    from clg_vqa_tpu_torch.data.pipeline import TrainPipeline
    from clg_vqa_tpu_torch.data.tokenizer import HashTokenizer
    from clg_vqa_tpu_torch.train.driver import FinetuneRunner

    L = 6
    cfg_path = tmp_path / "vilbert_tiny.json"
    cfg_path.write_text(json.dumps(VILBERT_TINY))
    task_path = tmp_path / "task.yml"
    task_path.write_text(
        "TASK15:\n  name: GQA\n  type: VL-classifier-GQA\n"
        f"  num_labels: {L}\n  max_seq_length: 8\n  max_region_num: 6\n"
        "  batch_size: 16\n  lr: 0.005\n  num_epoch: 2\n")
    args = types.SimpleNamespace(
        tasks_config_file=str(task_path), task="15",
        config_file=str(cfg_path), is_m3p=False, from_pretrained="",
        seed=0, device="cpu")
    cfg, task, _ = C.build_configs(args)
    model = C.build_model(args, cfg)
    assert isinstance(cfg, GatedConfig) and isinstance(model, Gated)
    assert cfg.num_labels == L and cfg.depth == 6
    assert C.model_name(cfg) == "gated"

    r = np.random.RandomState(0)
    store = str(tmp_path / "f.cfs")
    with CfsWriter(store) as w:
        for i in range(8):
            n = int(r.randint(3, 7))
            boxes = np.stack([r.rand(n) * 40, r.rand(n) * 40,
                              50 + r.rand(n) * 40, 50 + r.rand(n) * 40],
                             1).astype(np.float32)
            w.add(RegionRecord(f"i{i}", r.randn(n, 16).astype(np.float32),
                               boxes, 100.0, 100.0))
    entries = [Entry(question_id=i, image_id=f"i{i % 8}",
                     question=f"marker{i % L} what is it ?",
                     labels=[i % L], scores=[1.0]) for i in range(64)]
    tok = HashTokenizer(128)
    ds = GQADataset(entries, CfsReader(store), tok, max_seq_length=8,
                    max_region_num=6, num_locs=7, num_labels=L)
    val = GQADataset(entries[:16], CfsReader(store), tok, max_seq_length=8,
                     max_region_num=6, num_locs=7, num_labels=L)
    D = np.random.RandomState(1).rand(L, L).astype(np.float32)
    np.fill_diagonal(D, 0)
    pipe = TrainPipeline(ds, micro_batch_size=8, grad_acc_steps=2, seed=0,
                         device="cpu")
    runner = FinetuneRunner(
        model, pipe, val, D,
        task_cfg=TaskConfig(num_labels=L, max_seq_length=8, max_region_num=6,
                            batch_size=16, eval_batch_size=16, lr=5e-3,
                            num_epoch=2, semantic_lambda=1.0),
        optim_cfg=OptimConfig(lr=5e-3, grad_acc_steps=2, warmup_proportion=0.1),
        output_dir=str(tmp_path / "out"), model_name="gated",
        compute_dtype=None)
    assert runner.train_fused is False
    best = runner.finetune()
    assert 0.0 <= best <= 1.0
    lines = [json.loads(x) for x in open(tmp_path / "out" / "metrics.jsonl")]
    tr = [x for x in lines if x["kind"] == "train"]
    assert tr[-1]["loss"] < tr[0]["loss"]
    with pytest.raises(ValueError, match="gated"):
        runner.imp_prune()

    runner.export_torch("model.bin")
    runner.flush_saves()
    sd = C.load_pretrained(str(tmp_path / "out" / "model.bin"), cfg)
    again = TC.load_numpy_state(Gated(cfg, device="cpu", seed=9), sd)
    b = val.make_batch(list(range(16)))
    b = {k: torch.from_numpy(v) for k, v in b.items()
         if k in ("input_ids", "input_mask", "features", "locs", "image_mask")}
    with torch.no_grad():
        assert torch.equal(model(b), again(b))


def test_cli_train_eval_convert_zoo_config(tmp_path):
    """python -m clg_vqa_tpu_torch.cli train / eval / convert on a UNITER
    config (configs/uc2_base.json's wiring, narrow) with --device cpu --fp32;
    the converted params evaluate to the same predictions; and a JAX gated
    model's VOLTA .bin evaluates identically in both CLIs."""
    import pickle

    from clg_vqa_tpu.cli.__main__ import main as jax_main
    from clg_vqa_tpu_torch.data.cfs import CfsWriter
    from clg_vqa_tpu_torch.data.features import RegionRecord

    L = 5
    data = tmp_path / "annotations"
    data.mkdir()
    label2ans = [f"ans{k}" for k in range(L)]
    pickle.dump({a: i for i, a in enumerate(label2ans)},
                open(data / "trainval_ans2label.pkl", "wb"))
    pickle.dump(label2ans, open(data / "trainval_label2ans.pkl", "wb"))
    items = [{"question_id": i, "image_id": f"i{i % 4}",
              "question": f"marker{i % L} thing ?", "labels": [i % L],
              "scores": [1.0]} for i in range(32)]
    pickle.dump(items, open(data / "train_target.pkl", "wb"))
    pickle.dump(items[:8], open(data / "val_target.pkl", "wb"))
    json.dump({str(900 + i): {"imageId": f"i{i % 4}",
                              "question": f"marker{i % L} thing ?",
                              "answer": f"ans{i % L}"} for i in range(8)},
              open(data / "testdev_balanced_questions.json", "w"))
    r = np.random.RandomState(0)
    store = tmp_path / "f.cfs"
    with CfsWriter(str(store)) as w:
        for i in range(4):
            n = r.randint(3, 7)
            boxes = np.stack([r.rand(n) * 40, r.rand(n) * 40,
                              50 + r.rand(n) * 40, 50 + r.rand(n) * 40],
                             1).astype(np.float32)
            w.add(RegionRecord(f"i{i}", r.randn(n, 16).astype(np.float32),
                               boxes, 100.0, 100.0))
    base = json.load(open(os.path.join(os.path.dirname(__file__), "..",
                                       "configs", "uc2_base.json")))
    narrow = dict(hidden_size=32, num_attention_heads=2, intermediate_size=64,
                  v_feature_size=16, v_hidden_size=32, v_num_attention_heads=2,
                  v_intermediate_size=64, pooler_size=32, v_pooler_size=32,
                  clf_hidden_size=32, image_embeddings="uniter",
                  vocab_size=250002)
    depth = {k: [n for n in base[k] if n < 4] for k in base
             if k.endswith("_sublayers")}
    (tmp_path / "uniter.json").write_text(json.dumps({**base, **narrow, **depth}))
    (tmp_path / "task.yml").write_text(
        f"TASK15:\n  name: GQA\n  type: VL-classifier-GQA\n  num_labels: {L}\n"
        f"  loss: CrossEntropyLoss\n  dataroot: {data}\n"
        f"  features_h5path1: {store}\n  features_h5path2: {store}\n"
        "  max_seq_length: 8\n  max_region_num: 6\n  batch_size: 16\n"
        "  eval_batch_size: 8\n  train_split: train\n  val_split: val\n"
        "  lr: 0.005\n  num_epoch: 1\n  semantic_lambda: 1\n"
        "  semantic_dict_path: ''\n")

    def common(out):
        return ["--config_file", str(tmp_path / "uniter.json"),
                "--tasks_config_file", str(tmp_path / "task.yml"),
                "--output_dir", str(tmp_path / out), "--fp32", "--device", "cpu"]

    main(["train", *common("ft"), "--grad_acc_steps", "2"])
    meta = json.load(open(tmp_path / "ft" / "meta.json"))
    assert meta["step"] == 2
    assert (tmp_path / "ft" / "params_best" / "params.pt").exists()
    main(["eval", *common("ev"), "--from_pretrained",
          str(tmp_path / "ft" / "params_best"), "--split", "test"])
    preds = json.load(open(tmp_path / "ev" / "test_result.json"))
    assert len(preds) == 8 and {p["prediction"] for p in preds} <= set(label2ans)
    main(["convert", *common("conv"), "--from_pretrained",
          str(tmp_path / "ft" / "params_best"), "--name", "p"])
    main(["eval", *common("ev2"), "--from_pretrained",
          str(tmp_path / "conv" / "p"), "--split", "test"])
    assert json.load(open(tmp_path / "ev2" / "test_result.json")) == preds

    jcfg = jgated.GatedConfig.from_dict(
        {**base, **narrow, **depth, "num_labels": L})
    sd = pytree_to_volta_gated(jgated.init_params(jax.random.key(3), jcfg), jcfg)
    bin_path = str(tmp_path / "jax_gated.bin")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               bin_path)
    jax_main(["eval", *common("ev_jax")[:-2], "--from_pretrained", bin_path,
              "--split", "test"])
    main(["eval", *common("ev_port"), "--from_pretrained", bin_path,
          "--split", "test"])
    assert json.load(open(tmp_path / "ev_port" / "test_result.json")) == \
        json.load(open(tmp_path / "ev_jax" / "test_result.json"))
