"""The port's CLI (python -m clg_vqa_tpu_torch.cli) on the CPU, on the
miniature on-disk world of tests/test_cli.py (target pkls, answer vocab,
task YAML, CFS store): train -> eval -> score -> convert and prune -> sft
with ``--device cpu --fp32``, and one exported ``.bin`` evaluated by both
CLIs.

Tolerance: the two CLIs' test_result.json files must be identical (argmax
answers of the same fp32 weights on the same questions)."""
import argparse
import json
import os
import pickle
import types

import numpy as np
import pytest
import torch

import jax

from clg_vqa_tpu.cli.__main__ import main as jax_main
from clg_vqa_tpu.config import UC2Config as JConfig
from clg_vqa_tpu.models import uc2 as juc2
from clg_vqa_tpu.train import checkpoints as jckpt
from clg_vqa_tpu_torch.cli import common as C
from clg_vqa_tpu_torch.cli.__main__ import main
from clg_vqa_tpu_torch.data.cfs import CfsWriter
from clg_vqa_tpu_torch.data.features import RegionRecord

torch.set_num_threads(1)

L, N_IMGS, N_Q = 6, 6, 48


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    r = np.random.RandomState(0)
    dataroot = tmp / "annotations"
    dataroot.mkdir()
    label2ans = [f"ans{k}" for k in range(L)]
    ans2label = {a: i for i, a in enumerate(label2ans)}
    pickle.dump(ans2label, open(dataroot / "trainval_ans2label.pkl", "wb"))
    pickle.dump(label2ans, open(dataroot / "trainval_label2ans.pkl", "wb"))

    def items(lo, hi):
        return [{"question_id": i, "image_id": f"i{i % N_IMGS}",
                 "question": f"marker{i % L} thing ?", "labels": [i % L],
                 "scores": [1.0]} for i in range(lo, hi)]

    pickle.dump(items(0, N_Q), open(dataroot / "train_target.pkl", "wb"))
    pickle.dump(items(0, 16), open(dataroot / "val_target.pkl", "wb"))
    test_d = {str(9000 + i): {"imageId": f"i{i % N_IMGS}",
                              "question": f"marker{i % L} thing ?",
                              "answer": f"ans{i % L}"} for i in range(12)}
    json.dump(test_d, open(dataroot / "testdev_balanced_questions.json", "w"))

    store = tmp / "f.cfs"
    with CfsWriter(str(store)) as w:
        for i in range(N_IMGS):
            n = r.randint(3, 8)
            boxes = np.stack([r.rand(n) * 40, r.rand(n) * 40,
                              50 + r.rand(n) * 40, 50 + r.rand(n) * 40],
                             1).astype(np.float32)
            w.add(RegionRecord(f"i{i}", r.randn(n, 16).astype(np.float32),
                               boxes, 100.0, 100.0))

    model_cfg = {
        "attention_probs_dropout_prob": 0.1, "hidden_act": "gelu",
        "hidden_dropout_prob": 0.1, "hidden_size": 32,
        "initializer_range": 0.02, "intermediate_size": 64,
        "max_position_embeddings": 514, "num_attention_heads": 2,
        "pooler_size": 32, "type_vocab_size": 2, "vocab_size": 128,
        "pad_token_id": 1, "num_locs": 7, "add_global_imgfeat": None,
        "image_embeddings": "uc2", "model": "roberta",
        "v_attention_probs_dropout_prob": 0.1, "v_hidden_act": "gelu",
        "v_hidden_dropout_prob": 0.1, "v_feature_size": 16,
        "visual_target_weights": {}, "v_hidden_size": 32,
        "v_initializer_range": 0.02, "v_pooler_size": 32,
        "v_num_attention_heads": 2, "v_intermediate_size": 64,
        "layer_norm_eps": 1e-5, "fusion_method": "text",
        "clf_hidden_size": 32,
        "tt_attn_sublayers": [0, 2], "tv_attn_sublayers": [0, 2],
        "vt_attn_sublayers": [0, 2], "vv_attn_sublayers": [0, 2],
        "t_ff_sublayers": [1, 3], "v_ff_sublayers": [1, 3],
        "shared_sublayers": [0, 1, 2, 3], "single_ln_sublayers": [0, 1, 2, 3],
        "sublayer2attn_hidden_size": {}, "sublayer2num_attention_heads": {},
        "sublayer2intermediate_size": {}, "sublayer2v_attn_hidden_size": {},
        "sublayer2v_num_attention_heads": {},
        "sublayer2v_intermediate_size": {},
        "bert_layer2attn_sublayer": {"0": 0, "1": 2},
        "bert_layer2ff_sublayer": {"0": 1, "1": 3},
    }
    json.dump(model_cfg, open(tmp / "model.json", "w"))
    json.dump({**model_cfg, "image_embeddings": "vilbert"},
              open(tmp / "gated.json", "w"))
    # the hash tokenizer's full range, so both CLIs tokenize alike
    json.dump({**model_cfg, "vocab_size": 250002},
              open(tmp / "full_vocab.json", "w"))
    m3p_cfg = {"hidden_size": 32, "intermediate_size": 128, "n_heads": 2,
               "n_layers": 2, "max_position_embeddings": 514,
               "pad_token_id": 1, "vocab_size": 128, "num_locs": 5,
               "v_feature_size": 16, "norm_embeddings": True,
               "pooler_size": 32, "clf_hidden_size": 48, "max_boxes": 6,
               "hidden_dropout_prob": 0.1,
               "attention_probs_dropout_prob": 0.1}
    json.dump(m3p_cfg, open(tmp / "m3p.json", "w"))
    json.dump({**m3p_cfg, "vocab_size": 250002},
              open(tmp / "m3p_full_vocab.json", "w"))

    yaml_text = f"""TASK15:
  name: GQA
  type: VL-classifier-GQA
  num_labels: {L}
  loss: CrossEntropyLoss
  dataroot: {dataroot}
  features_h5path1: {store}
  features_h5path2: {store}
  max_seq_length: 8
  max_region_num: 6
  batch_size: 16
  eval_batch_size: 16
  train_split: train
  val_split: val
  lr: 0.005
  num_epoch: 1
  semantic_lambda: 1
  semantic_dict_path: ''
"""
    (tmp / "task.yml").write_text(yaml_text)
    return tmp


def _common(tmp, out, config="model.json"):
    return ["--config_file", str(tmp / config),
            "--tasks_config_file", str(tmp / "task.yml"),
            "--output_dir", str(tmp / out), "--fp32", "--device", "cpu"]


def test_cli_train_eval_score_convert(cli_world, capsys):
    tmp = cli_world
    main(["train", *_common(tmp, "ft"), "--grad_acc_steps", "2"])
    assert os.path.isfile(tmp / "ft" / "params_best" / "params.pt")
    meta = json.load(open(tmp / "ft" / "meta.json"))
    assert meta["epoch"] == 0 and meta["step"] == 3
    assert os.path.isfile(tmp / "ft" / meta["state_dir"] / "state.pt")
    recs = [json.loads(x) for x in open(tmp / "ft" / "metrics.jsonl")]
    assert [r["kind"] for r in recs] == ["train"] * 3 + ["val"]
    out = capsys.readouterr().out
    assert "Best validation score" in out

    main(["eval", *_common(tmp, "ev"),
          "--from_pretrained", str(tmp / "ft" / "params_best"),
          "--split", "test"])
    res_file = tmp / "ev" / "test_result.json"
    preds = json.load(open(res_file))
    assert len(preds) == 12 and {p["prediction"] for p in preds} <= {
        f"ans{k}" for k in range(L)}
    assert "wrote" in capsys.readouterr().out

    main(["score", "--preds_file", str(res_file), "--truth_file",
          str(tmp / "annotations" / "testdev_balanced_questions.json")])
    score = capsys.readouterr().out.strip().splitlines()[-1]
    assert 0.0 <= float(score) <= 100.0

    # convert the best params to a params dir and evaluate it again: the
    # same predictions
    main(["convert", *_common(tmp, "conv"), "--from_pretrained",
          str(tmp / "ft" / "params_best"), "--name", "p"])
    main(["eval", *_common(tmp, "ev2"), "--from_pretrained",
          str(tmp / "conv" / "p"), "--split", "test"])
    assert json.load(open(tmp / "ev2" / "test_result.json")) == preds


def test_cli_prune_then_sft(cli_world, capsys):
    """``prune`` for 2 IMP rounds, then ``sft --mask_file <prune
    out>/mask_best.npz``, with JAX's printed lines; the masks are JAX-format
    files at 10% and 19%, and every weight mask_best prunes is exactly 0
    in the exported model_best_sft.bin and in the final state."""
    from clg_vqa_tpu.train import pruning as jpr
    from clg_vqa_tpu_torch.train import pruning as pr
    tmp = cli_world
    main(["prune", *_common(tmp, "imp"), "--grad_acc_steps", "2",
          "--num_epoch", "2"])
    out = capsys.readouterr().out
    assert "IMP best epoch" in out and "history: [{'epoch': 0" in out
    pmeta = json.load(open(tmp / "imp" / "prune_meta.json"))
    assert pmeta["next_round"] == 2
    assert [round(h["sparsity"], 1) for h in pmeta["history"]] == [10.0, 19.0]
    assert sorted(f for f in os.listdir(tmp / "imp") if f.endswith(".npz")) \
        == ["mask_best.npz", "mask_lt0.npz", "mask_lt1.npz"]
    best = str(tmp / "imp" / "mask_best.npz")
    with np.load(best) as a, np.load(
            tmp / "imp" / f"mask_lt{pmeta['best_epoch']}.npz") as b:
        assert sorted(a.files) == sorted(jpr.PRUNABLE_UC2)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)

    main(["sft", *_common(tmp, "sft"), "--grad_acc_steps", "2",
          "--mask_file", best])
    assert "SFT best validation score" in capsys.readouterr().out
    cfg, _, _ = C.build_configs(C.add_common_args(
        argparse.ArgumentParser()).parse_args(_common(tmp, "sft")))
    model = C.build_model(types.SimpleNamespace(device="cpu", seed=0,
                                                from_pretrained=""), cfg)
    mask = pr.load_mask(best, model)
    exported = C.load_pretrained(str(tmp / "sft" / "model_best_sft.bin"), cfg)
    meta = json.load(open(tmp / "sft" / "meta.json"))
    final = torch.load(tmp / "sft" / meta["state_dir"] / "state.pt",
                       weights_only=True)["params"]
    n = 0
    for k, m in mask.items():
        if m is not None:
            pruned = m.numpy() == 0
            assert np.all(exported[k][pruned] == 0.0), k
            assert np.all(final[k].numpy()[pruned] == 0.0), k
            n += int(pruned.sum())
    assert n > 0 and meta["step"] == 3


def test_jax_export_evaluates_identically_in_both_clis(cli_world, capsys):
    """A JAX model exported by the JAX package's export_torch_bin: the JAX
    CLI and the port's CLI write the same test_result.json."""
    tmp = cli_world
    cfg = JConfig.from_json(str(tmp / "full_vocab.json"), num_labels=L)
    params = juc2.init_params(jax.random.key(3), cfg)
    bin_path = str(tmp / "jax_model.bin")
    jckpt.export_torch_bin(bin_path, params)
    jax_main(["eval", *_common(tmp, "ev_jax", "full_vocab.json")[:-2],
              "--from_pretrained", bin_path, "--split", "test"])
    main(["eval", *_common(tmp, "ev_port", "full_vocab.json"),
          "--from_pretrained", bin_path, "--split", "test"])
    want = json.load(open(tmp / "ev_jax" / "test_result.json"))
    got = json.load(open(tmp / "ev_port" / "test_result.json"))
    assert len(got) == 12 and got == want


@pytest.mark.parametrize("case", ["m3p", "gated", "proj"])
def test_cli_ported_configs_train_and_save(cli_world, case):
    """"--is_m3p" (M3P), a gated-zoo config (ViLBERT embeddings on the UC2
    wiring) and "--fused_attn proj" (B4) train and save."""
    tmp = cli_world
    config = {"m3p": "m3p.json", "gated": "gated.json", "proj": "model.json"}
    argv = ["train", *_common(tmp, f"bad_{case}", config[case]),
            "--grad_acc_steps", "2"]
    if case == "m3p":
        argv.append("--is_m3p")
    elif case == "proj":
        argv += ["--fused_attn", "proj"]
    main(argv)
    out = tmp / f"bad_{case}"
    meta = json.load(open(out / "meta.json"))
    assert (out / "params_best" / "params.pt").exists()
    assert (out / meta["state_dir"] / "state.pt").exists()


def test_cli_trains_over_a_feature_lmdb(cli_world):
    """A per-image feature LMDB (written from the CFS store by
    convert-store) trains and saves."""
    tmp = cli_world
    lmdb_path = str(tmp / "feats_lmdb")
    main(["convert-store", str(tmp / "f.cfs"), lmdb_path])
    argv = ["train", *_common(tmp, "lmdb_train"), "--grad_acc_steps", "2",
            "--features_path", lmdb_path]
    main(argv)
    out = tmp / "lmdb_train"
    meta = json.load(open(out / "meta.json"))
    assert meta["step"] == 3
    assert (out / "params_best" / "params.pt").exists()
    assert (out / meta["state_dir"] / "state.pt").exists()


def _file_bytes(path) -> bytes:
    path = os.path.join(path, "data.mdb") if os.path.isdir(path) else path
    with open(path, "rb") as f:
        return f.read()


def test_cli_convert_store_lmdb_and_cfs_round_trip(cli_world):
    """cfs -> lmdb -> cfs through convert-store gives back the CFS bytes,
    and each file equals the JAX CLI's (the command reads 2048-wide LMDB
    features, as the reference's stores hold)."""
    tmp = cli_world
    src = str(tmp / "f2048.cfs")
    r = np.random.RandomState(1)
    with CfsWriter(src) as w:
        for i in range(3):
            n = 2 + i
            w.add(RegionRecord(f"i{i}", r.randn(n, 2048).astype(np.float32),
                               (r.rand(n, 4) * 90).astype(np.float32), 100.0, 90.0))
    for cli, tag in ((main, "t"), (jax_main, "j")):
        cli(["convert-store", src, str(tmp / f"rt_{tag}_lmdb")])
        cli(["convert-store", str(tmp / f"rt_{tag}_lmdb"), str(tmp / f"rt_{tag}.cfs")])
    assert _file_bytes(tmp / "rt_t_lmdb") == _file_bytes(tmp / "rt_j_lmdb")
    assert _file_bytes(tmp / "rt_t.cfs") == _file_bytes(src) == \
        _file_bytes(tmp / "rt_j.cfs")


def test_cli_convert_store_tdlmdb_annotations_and_entries_out(cli_world):
    """--annotations joins a CFS store with a target pkl into a QA td-lmdb;
    td-lmdb -> cfs writes the store and the entries pkl (--entries_out, or
    <dst>_target.pkl); every output equals the JAX CLI's."""
    tmp = cli_world
    ann = str(tmp / "annotations" / "train_target.pkl")
    for cli, tag in ((main, "t"), (jax_main, "j")):
        cli(["convert-store", str(tmp / "f.cfs"), str(tmp / f"qa_{tag}.td"),
             "--annotations", ann])
        cli(["convert-store", str(tmp / f"qa_{tag}.td"), str(tmp / f"qa_{tag}.cfs"),
             "--entries_out", str(tmp / f"qa_{tag}_entries.pkl")])
        cli(["convert-store", str(tmp / f"qa_{tag}.td"), str(tmp / f"qa2_{tag}.cfs")])
    assert _file_bytes(tmp / "qa_t.td") == _file_bytes(tmp / "qa_j.td")
    assert _file_bytes(tmp / "qa_t.cfs") == _file_bytes(tmp / "qa_j.cfs")
    entries = pickle.load(open(tmp / "qa_t_entries.pkl", "rb"))
    assert entries == pickle.load(open(tmp / "qa_j_entries.pkl", "rb"))
    assert entries == pickle.load(open(tmp / "qa2_t_target.pkl", "rb"))
    assert len(entries) == N_Q


def test_cli_trains_over_a_tdlmdb_ingest(cli_world):
    """train --features_path <td-lmdb> ingests the QA-joined store once
    into a CFS store and entries under the output dir, as the JAX CLI's
    ingest_tdlmdb does (same bytes, same entries), and trains on its QA."""
    from clg_vqa_tpu.cli import common as JC
    tmp = cli_world
    td = str(tmp / "ingest.td")
    main(["convert-store", str(tmp / "f.cfs"), td, "--annotations",
          str(tmp / "annotations" / "train_target.pkl")])
    cfs_t, items_t = C.ingest_tdlmdb(td, str(tmp / "ing_t"), "train")
    cfs_j, items_j = JC.ingest_tdlmdb(td, str(tmp / "ing_j"), "train")
    assert os.path.basename(cfs_t) == os.path.basename(cfs_j)
    assert _file_bytes(cfs_t) == _file_bytes(cfs_j) and items_t == items_j
    assert C.is_tdlmdb(td) and not C.is_tdlmdb(str(tmp / "f.cfs"))
    main(["train", *_common(tmp, "td_ft"), "--grad_acc_steps", "2",
          "--features_path", td])
    out = tmp / "td_ft"
    assert any(f.startswith("ingest_train_") for f in os.listdir(out))
    meta = json.load(open(out / "meta.json"))
    assert meta["step"] == 3 and (out / "params_best" / "params.pt").exists()


def test_cli_eval_over_lmdb_equals_eval_over_cfs(cli_world):
    """eval over the per-image LMDB written from the CFS store gives the
    CFS store's predictions."""
    tmp = cli_world
    lmdb_path = str(tmp / "ev_lmdb")
    main(["convert-store", str(tmp / "f.cfs"), lmdb_path])
    preds = []
    for out, feats in (("ev_on_lmdb", lmdb_path), ("ev_on_cfs", str(tmp / "f.cfs"))):
        main(["eval", *_common(tmp, out), "--split", "test",
              "--features_path", feats])
        preds.append(json.load(open(tmp / out / "test_result.json")))
    assert len(preds[0]) == 12 and preds[0] == preds[1]


def test_cli_m3p_train_eval_score_convert(cli_world, capsys):
    """--is_m3p through train -> eval -> score -> convert on the CPU: an M3P
    config JSON (n_layers / n_heads keys, 5 locs, L2-normalized features),
    the model's saves and a .bin export that the convert command reads
    back to the same predictions."""
    tmp = cli_world
    common = _common(tmp, "m3p_ft", "m3p.json") + ["--is_m3p"]
    main(["train", *common, "--grad_acc_steps", "2"])
    meta = json.load(open(tmp / "m3p_ft" / "meta.json"))
    assert meta["epoch"] == 0 and meta["step"] == 3
    assert "Best validation score" in capsys.readouterr().out
    cfg, _, _ = C.build_configs(
        C.add_common_args(argparse.ArgumentParser()).parse_args(common))
    model = C.build_model(types.SimpleNamespace(
        device="cpu", seed=0,
        from_pretrained=str(tmp / "m3p_ft" / "params_best")), cfg)
    assert type(model).__name__ == "M3P" and C.model_name(cfg) == "m3p"
    from clg_vqa_tpu_torch.train import checkpoints as ckpt
    ckpt.export_torch_bin(str(tmp / "m3p.bin"), model, "m3p")

    def ev(out, pretrained):
        main(["eval", *_common(tmp, out, "m3p.json"), "--is_m3p",
              "--from_pretrained", pretrained, "--split", "test"])
        return json.load(open(tmp / out / "test_result.json"))

    preds = ev("m3p_ev", str(tmp / "m3p_ft" / "params_best"))
    assert len(preds) == 12
    main(["score", "--preds_file", str(tmp / "m3p_ev" / "test_result.json"),
          "--truth_file",
          str(tmp / "annotations" / "testdev_balanced_questions.json")])
    assert 0.0 <= float(capsys.readouterr().out.strip().splitlines()[-1]) <= 100
    main(["convert", *_common(tmp, "m3p_conv", "m3p.json"), "--is_m3p",
          "--from_pretrained", str(tmp / "m3p.bin"), "--name", "p"])
    assert ev("m3p_ev2", str(tmp / "m3p_conv" / "p")) == preds
    assert ev("m3p_ev3", str(tmp / "m3p.bin")) == preds


def test_jax_m3p_export_evaluates_identically_in_both_clis(cli_world):
    """A JAX M3P exported by the JAX package's export_torch_bin: the JAX CLI
    and the port's CLI, both with --is_m3p, write the same
    test_result.json; the original microsoft/M3P layout (module.* names, no
    classifier) loads the body into both."""
    from clg_vqa_tpu.config import M3PConfig as JM3PConfig
    from clg_vqa_tpu.models import m3p as jm3p
    from clg_vqa_tpu.utils.convert import pytree_to_volta_m3p
    tmp = cli_world
    cfg = JM3PConfig.from_json(str(tmp / "m3p_full_vocab.json"), num_labels=L)
    params = jm3p.init_params(jax.random.key(4), cfg)
    bin_path = str(tmp / "jax_m3p.bin")
    jckpt.export_torch_bin(bin_path, params, model="m3p")
    args = ["--is_m3p", "--from_pretrained", bin_path, "--split", "test"]
    jax_main(["eval", *_common(tmp, "m3p_jax", "m3p_full_vocab.json")[:-2],
              *args])
    main(["eval", *_common(tmp, "m3p_port", "m3p_full_vocab.json"), *args])
    want = json.load(open(tmp / "m3p_jax" / "test_result.json"))
    got = json.load(open(tmp / "m3p_port" / "test_result.json"))
    assert len(got) == 12 and got == want

    sd = pytree_to_volta_m3p(jax.tree.map(np.asarray, params))
    orig = {"module." + k[len("bert.encoder."):]: torch.from_numpy(v.copy())
            for k, v in sd.items() if k.startswith("bert.encoder.")}
    orig_path = str(tmp / "m3p_original.bin")
    torch.save(orig, orig_path)
    from clg_vqa_tpu_torch.config import M3PConfig
    tcfg = M3PConfig.from_json(str(tmp / "m3p_full_vocab.json"), num_labels=L)
    got_sd = C.load_pretrained(orig_path, tcfg)
    from clg_vqa_tpu.cli.common import load_pretrained as jload
    from clg_vqa_tpu_torch.utils.convert import jax_params_to_state_dict
    want_sd = jax_params_to_state_dict(jax.tree.map(
        np.asarray, jload(orig_path, cfg, True)))
    assert got_sd.keys() == want_sd.keys()
    for k, v in got_sd.items():
        if not k.startswith("classifier."):     # fresh init on each side
            np.testing.assert_array_equal(v, want_sd[k], err_msg=k)


def test_cli_defaults_to_cuda(cli_world, monkeypatch):
    """Without --device the CLI runs on cuda, and raises where CUDA is
    absent instead of running on the CPU."""
    tmp = cli_world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["eval", *_common(tmp, "ev_cuda")[:-2], "--split", "test"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)


def test_load_pretrained_reads_an_hf_xlmr_bin(cli_world):
    """A raw HF XLM-R .bin (roberta.* names, per-layer numbering, no v_
    aliases) loads through the sublayer collapse; absent parts keep the
    fresh init."""
    from clg_vqa_tpu_torch.config import UC2Config
    from clg_vqa_tpu_torch.models.uc2 import UC2
    cfg = UC2Config.from_json(str(cli_world / "model.json"), num_labels=L)
    r = np.random.RandomState(5)
    hf = {"roberta.embeddings.word_embeddings.weight":
          r.randn(128, 32).astype(np.float32),
          "roberta.encoder.layer.1.attention.self.query.weight":
          r.randn(32, 32).astype(np.float32),
          "roberta.encoder.layer.0.output.dense.bias":
          r.randn(32).astype(np.float32)}
    path = str(cli_world / "hf.bin")
    torch.save({k: torch.from_numpy(v) for k, v in hf.items()}, path)
    sd = C.load_pretrained(path, cfg)
    np.testing.assert_array_equal(
        sd["embeddings.word"], hf["roberta.embeddings.word_embeddings.weight"])
    np.testing.assert_array_equal(
        sd["encoder.1.attn.q.weight"],
        hf["roberta.encoder.layer.1.attention.self.query.weight"])
    np.testing.assert_array_equal(
        sd["encoder.0.ffn.w2.bias"], hf["roberta.encoder.layer.0.output.dense.bias"])
    fresh = UC2(cfg, device="cpu", seed=0).state_dict()
    np.testing.assert_array_equal(sd["pooler.weight"],
                                  fresh["pooler.weight"].numpy())


def test_task_config_from_yaml_matches_jax(cli_world):
    """The YAML ingest: the same TASK15 fields, field for field, and the
    optimizer config the flags build."""
    import dataclasses

    from clg_vqa_tpu.cli import common as JC
    from clg_vqa_tpu.config import TaskConfig as JTask
    from clg_vqa_tpu_torch.config import TaskConfig
    path = str(cli_world / "task.yml")
    assert dataclasses.asdict(TaskConfig.from_yaml(path)) == \
        dataclasses.asdict(JTask.from_yaml(path))
    import argparse
    for argv in ([], ["--lr", "0.01", "--num_epoch", "3", "--loss", "BCE",
                      "--adam_correct_bias", "--optim_train_epochs", "7"]):
        jp, tp = argparse.ArgumentParser(), argparse.ArgumentParser()
        JC.add_train_args(JC.add_common_args(jp))
        C.add_train_args(C.add_common_args(tp))
        base = ["--config_file", str(cli_world / "model.json"),
                "--tasks_config_file", path, *argv]
        jcfg, jtask, jopt = JC.build_configs(jp.parse_args(base))
        tcfg, ttask, topt = C.build_configs(tp.parse_args(base))
        assert dataclasses.asdict(ttask) == dataclasses.asdict(jtask)
        assert dataclasses.asdict(topt) == dataclasses.asdict(jopt)
        assert dataclasses.asdict(tcfg) == {
            k: v for k, v in dataclasses.asdict(jcfg).items()}


def test_hf_xlmr_ingest_matches_jax_on_the_carried_keys():
    """tests/test_interop.py's HF-style dict (VOLTA names turned back into
    per-layer HF names, values doubled, v_ aliases carried along): every
    tensor the checkpoint carries lands where the JAX package puts it.
    Without the aliases, as a real HF checkpoint has them, the JAX function
    trips its shared-weight assertion and the port's loads (ROADMAP §C)."""
    from clg_vqa_tpu.utils.convert import (hf_xlmr_to_uc2_pytree,
                                           pytree_to_volta_uc2)
    from clg_vqa_tpu_torch.config import UC2Config
    from clg_vqa_tpu_torch.utils import convert as TC
    kw = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
              intermediate_size=32, v_feature_size=8, num_locs=5,
              pooler_size=16, clf_hidden_size=16, num_labels=4)
    sd = pytree_to_volta_uc2(juc2.init_params(jax.random.key(1), JConfig(**kw)))
    hf = {}
    for k, v in sd.items():
        if ".layer." in k:
            num = int(k.split(".layer.")[-1].split(".")[0])
            if "attention_" in k and num % 2 == 0:
                nk = k.replace(f".layer.{num}.attention_",
                               f".layer.{num // 2}.attention.")
            elif num % 2 == 1 and (".intermediate." in k or ".output." in k):
                nk = k.replace(f".layer.{num}.", f".layer.{num // 2}.")
            else:
                continue
        elif k == "bert.embeddings.word_embeddings.weight":
            nk = k
        else:
            continue
        hf[nk.replace("bert.", "roberta.")] = np.asarray(v) * 2.0
    want = TC.jax_params_to_state_dict(jax.tree.map(
        np.asarray, hf_xlmr_to_uc2_pytree(hf, JConfig(**kw), seed=0)))
    got = TC.hf_xlmr_to_uc2_state_dict(hf, UC2Config(**kw))
    carried = [k for k in got if k.startswith(("encoder.", "embeddings.word"))]
    assert len(carried) == 1 + 2 * 16
    for k in carried:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    no_alias = {k: v for k, v in hf.items() if ".v_" not in k}
    with pytest.raises(AssertionError, match="unshared"):
        hf_xlmr_to_uc2_pytree(no_alias, JConfig(**kw), seed=0)
    got2 = TC.hf_xlmr_to_uc2_state_dict(no_alias, UC2Config(**kw))
    for k in carried:
        np.testing.assert_array_equal(got2[k], want[k], err_msg=k)
