"""The port's own copies of the JAX package's framework-free host modules
(clg_vqa_tpu_torch/data/{features,tokenizer,gqa}.py, eval/scorer.py) give
the same results as the originals on the same inputs."""
import json
import pickle

import numpy as np
import pytest

from clg_vqa_tpu.data import features as jfeat, gqa as jgqa, tokenizer as jtok
from clg_vqa_tpu.eval import scorer as jscore
from clg_vqa_tpu_torch.data import features as tfeat, gqa as tgqa, tokenizer as ttok
from clg_vqa_tpu_torch.eval import scorer as tscore

try:
    # Load the HF stack (transformers imports accelerate) while each worker
    # collects this file. Other test files stub boto3 in sys.modules without
    # a __spec__, and accelerate's boto3 probe raises when accelerate is
    # first imported after them; importing it up front keeps the HF
    # tokenizer tests, here and in the JAX suite, independent of the order
    # in which pytest-xdist hands files to a worker.
    from transformers import AutoTokenizer  # noqa: F401
except ImportError:
    pass


@pytest.mark.parametrize("num_locs", [5, 7])
@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("glob", [None, "first", "last"])
def test_process_and_pad_regions(num_locs, norm, glob):
    r = np.random.RandomState(num_locs)
    feats = r.randn(6, 12).astype(np.float32)
    boxes = np.stack([r.rand(6) * 30, r.rand(6) * 30, 40 + r.rand(6) * 50,
                      40 + r.rand(6) * 50], 1).astype(np.float32)
    kw = dict(num_locs=num_locs, norm_embeddings=norm, add_global_imgfeat=glob)
    got = tfeat.process_regions(feats, boxes, 100.0, 90.0, **kw)
    want = jfeat.process_regions(feats, boxes, 100.0, 90.0, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    for a, b in zip(tfeat.pad_regions(got[0], got[2], got[1], 5, 12, num_locs),
                    jfeat.pad_regions(want[0], want[2], want[1], 5, 12, num_locs)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("text", ["what color is the car ?", "",
                                  " ".join(f"w{i}" for i in range(60))])
def test_hash_tokenizer_and_padding(text):
    t, j = ttok.HashTokenizer(1000), jtok.HashTokenizer(1000)
    assert t.encode(text) == j.encode(text)
    assert ttok.encode_padded(t, text, 40) == jtok.encode_padded(j, text, 40)


def _tiny_hf_tokenizer(path):
    """A miniature XLM-R-layout tokenizer, the recipe of
    tools/make_tiny_tokenizer.py, built offline under ``path``."""
    from tokenizers import (Tokenizer, models, normalizers, pre_tokenizers,
                            processors, trainers)
    corpus = ["what color is the car on the left ?",
              "is there a dog near the red fire hydrant ?",
              "how many people are sitting on the bench ?",
              "the man is wearing a blue shirt and black shoes"] * 3
    tok = Tokenizer(models.Unigram())
    tok.normalizer = normalizers.Sequence([normalizers.NFKC()])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁")
    tok.train_from_iterator(corpus, trainer=trainers.UnigramTrainer(
        vocab_size=120, unk_token="<unk>",
        special_tokens=["<s>", "<pad>", "</s>", "<unk>"]))
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A </s>", special_tokens=[("<s>", 0), ("</s>", 2)])
    tok.save(str(path / "tokenizer.json"))
    specials = {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
                "pad_token": "<pad>"}
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "model_max_length": 512,
         **specials}))
    (path / "special_tokens_map.json").write_text(json.dumps(specials))
    return str(path)


def test_hf_tokenizer_matches_jax(tmp_path):
    pytest.importorskip("transformers")     # HFTokenizer loads through it
    path = _tiny_hf_tokenizer(tmp_path)
    t, j = ttok.HFTokenizer(path), jtok.HFTokenizer(path)
    assert (t.bos_id, t.pad_id, t.eos_id, t.vocab_size) == \
        (j.bos_id, j.pad_id, j.eos_id, j.vocab_size) and t.pad_id == 1
    for text in ("what color is the dog ?", "is the man near the bench ?"):
        assert t.encode(text) == j.encode(text)
        assert t.tokenize(text) == j.tokenize(text)
        assert ttok.encode_padded(t, text, 8) == jtok.encode_padded(j, text, 8)


@pytest.fixture
def dataroot(tmp_path):
    items = [{"question_id": q, "image_id": 10 + q % 4, "question": f"q{q} ?",
              "labels": [q % 5], "scores": [1.0]} for q in (7, 3, 9, 1, 5)]
    for name in ("train_target.pkl", "val_target.pkl", "trainval_target.pkl",
                 "fewshot.pkl"):
        with open(tmp_path / name, "wb") as f:
            pickle.dump(items, f)
    test = {"201": {"imageId": "n5", "question": "a ?"},
            "200": {"imageId": "n6", "question": "b ?"}}
    (tmp_path / "testdev_balanced_questions.json").write_text(json.dumps(test))
    (tmp_path / "test_de.json").write_text(json.dumps(test))
    with open(tmp_path / "trainval_ans2label.pkl", "wb") as f:
        pickle.dump({"yes": 0, "no": 1}, f)
    with open(tmp_path / "trainval_label2ans.pkl", "wb") as f:
        pickle.dump(["yes", "no"], f)
    return tmp_path


@pytest.mark.parametrize("split,ann", [
    ("train", ""), ("val", ""), ("trainval", ""), ("minval", ""), ("test", ""),
    ("test_de", "test_de.json"), ("dev_de", "fewshot.pkl"),
    ("train_1_de", "fewshot.pkl")])
def test_load_entries_matches_jax(dataroot, split, ann):
    ann = str(dataroot / ann) if ann else ""
    got = tgqa.load_entries(str(dataroot), split, ann)
    want = jgqa.load_entries(str(dataroot), split, ann)
    assert [vars(e) for e in got] == [vars(e) for e in want]
    assert tgqa.load_answer_vocab(str(dataroot)) == \
        jgqa.load_answer_vocab(str(dataroot))


def test_load_entries_rejects_unknown_split(dataroot):
    with pytest.raises(ValueError, match="unrecognized split"):
        tgqa.load_entries(str(dataroot), "bogus")


def test_scorer_files_match_jax(tmp_path):
    preds = [{"questionId": str(q), "prediction": "yes" if q % 3 else "no"}
             for q in range(10)]
    truth = {str(q): {"answer": "yes"} for q in range(0, 10, 2)}
    (tmp_path / "p.json").write_text(json.dumps(preds))
    (tmp_path / "t.json").write_text(json.dumps(truth))
    args = (str(tmp_path / "p.json"), str(tmp_path / "t.json"))
    assert tscore.evaluate_files(*args) == jscore.evaluate_files(*args) == 0.6


def test_eval_world_on_cpu(tmp_path):
    """The synthetic eval setup shared by chip_smoke.py and
    tools/profile_eval.py, at a tiny scale on the CPU."""
    import torch
    from clg_vqa_tpu_torch.data.synthetic import eval_world
    w = eval_world(str(tmp_path), 5, num_labels=16, vocab_size=1000,
                   n_images=6, device="cpu")
    assert len(w.dataset) == 5 and len(w.label2ans) == 16
    assert w.bank.features.shape == (6, 36, 2048)
    assert w.bank.locs.shape == (6, 36, 7)
    rows = [0, 1, 2, 3, 4]
    want = w.dataset.make_batch(rows)
    idx = w.dataset.make_batch(rows, with_features=False)["store_idx"]
    feats, _, _ = w.bank.gather_from(w.bank.tensors(), torch.from_numpy(idx))
    np.testing.assert_array_equal(feats.numpy(), want["features"])
