"""The port's eval slice (clg_vqa_tpu_torch/eval/runner.py, predictor.py,
scorer.py) against the JAX package's run_eval / Predictor / scorer on the
same weights, store and questions: fp32 predictions must be identical,
padded tail batch included."""
import json

import numpy as np
import pytest
import torch

import jax

from clg_vqa_tpu.config import UC2Config as JConfig
from clg_vqa_tpu.data.cfs import CfsReader as JReader
from clg_vqa_tpu.data.device_bank import DeviceFeatureBank as JBank
from clg_vqa_tpu.data.gqa import Entry as JEntry, GQADataset as JDataset
from clg_vqa_tpu.data.tokenizer import HashTokenizer as JTok
from clg_vqa_tpu.eval import predictor as jpred, runner as jrun, scorer as jscore
from clg_vqa_tpu.models import uc2 as juc2
from clg_vqa_tpu_torch.config import UC2Config
from clg_vqa_tpu_torch.data.cfs import CfsReader, CfsWriter
from clg_vqa_tpu_torch.data.device_bank import DeviceFeatureBank
from clg_vqa_tpu_torch.data.features import RegionRecord
from clg_vqa_tpu_torch.data.gqa import Entry, GQADataset
from clg_vqa_tpu_torch.data.tokenizer import HashTokenizer
from clg_vqa_tpu_torch.eval import predictor as tpred, runner as trun, scorer
from clg_vqa_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

N_IMGS, N_Q, L, T, R = 10, 37, 12, 10, 8
CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=128, v_feature_size=32, num_locs=7,
           pooler_size=64, clf_hidden_size=32, num_labels=L)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_eval")
    r = np.random.RandomState(0)
    store = str(tmp / "feat.cfs")
    with CfsWriter(store) as w:
        for i in range(N_IMGS):
            n = r.randint(4, 12)
            boxes = np.stack([r.rand(n) * 50, r.rand(n) * 50,
                              50 + r.rand(n) * 50, 50 + r.rand(n) * 50],
                             1).astype(np.float32)
            w.add(RegionRecord(f"img{i}", r.randn(n, 32).astype(np.float32),
                               boxes, 100.0, 100.0))
    qs = [(1000 + i, f"img{(i * 7) % N_IMGS}",
           " ".join(f"w{r.randint(60)}" for _ in range(r.randint(2, 14))),
           int(r.randint(L))) for i in range(N_Q)]
    jparams = juc2.init_params(jax.random.key(0), JConfig(**CFG))
    model = from_jax_params(jax.tree.map(np.asarray, jparams), UC2Config(**CFG),
                            device="cpu")
    kw = dict(max_seq_length=T, max_region_num=R, num_locs=7, num_labels=L)
    tds = GQADataset([Entry(q, img, text, [lab], [1.0])
                      for q, img, text, lab in qs],
                     CfsReader(store), HashTokenizer(512), **kw)
    jds = JDataset([JEntry(q, img, text, [lab], [1.0])
                    for q, img, text, lab in qs],
                   JReader(store), JTok(512), **kw)
    label2ans = [f"ans{k}" for k in range(L)]
    return tmp, store, jparams, model, tds, jds, label2ans


def _by_qid(res):
    return {p["questionId"]: p["prediction"] for p in res["results"]}


@pytest.mark.parametrize("bank", [False, True])
@pytest.mark.parametrize("bs", [16, 8])
def test_run_eval_matches_jax(world, bank, bs):
    tmp, store, jparams, model, tds, jds, label2ans = world
    jbank = JBank(jds.store, max_regions=R, num_locs=7) if bank else None
    tbank = (DeviceFeatureBank(tds.store, max_regions=R, num_locs=7,
                               device="cpu") if bank else None)
    want = jrun.run_eval(juc2.forward, jparams, JConfig(**CFG), jds, label2ans,
                         batch_size=bs, compute_dtype=None, device_bank=jbank)
    got = trun.run_eval(model, tds, label2ans, batch_size=bs,
                        compute_dtype=None, device_bank=tbank)
    assert got["n"] == want["n"] == N_Q            # padded tail rows dropped
    assert [p["questionId"] for p in got["results"]] == \
        [p["questionId"] for p in want["results"]]
    assert _by_qid(got) == _by_qid(want)
    assert got["accuracy"] == want["accuracy"]


def test_run_eval_result_json(world):
    tmp, store, jparams, model, tds, jds, label2ans = world
    out = str(tmp / "test_result.json")
    res = trun.run_eval(model, tds, label2ans, batch_size=16,
                        compute_dtype=None, out_path=out)
    with open(out) as f:
        preds = json.load(f)
    assert preds == res["results"] and len(preds) == N_Q
    assert all(set(p) == {"questionId", "prediction"} for p in preds)
    assert {p["questionId"] for p in preds} == {str(1000 + i) for i in range(N_Q)}
    truth = {p["questionId"]: {"answer": p["prediction"] if i % 2 else "no"}
             for i, p in enumerate(preds)}
    assert scorer.evaluate(preds, truth) == jscore.evaluate(preds, truth)
    with pytest.raises(ValueError):
        scorer.evaluate(preds, {"nope": {"answer": "x"}})


def test_run_eval_flat_step_matches_plain(world):
    """An explicit flat-attention step gives the plain path's predictions
    (fp32; on the CPU the kernel's plain version runs)."""
    tmp, store, jparams, model, tds, jds, label2ans = world
    bank = DeviceFeatureBank(tds.store, max_regions=R, num_locs=7, device="cpu")
    flat = trun.make_predict_step(model, device_bank=bank, compute_dtype=None,
                                  fused_attn="flat")
    a = trun.run_eval(model, tds, label2ans, batch_size=16, device_bank=bank,
                      step=flat)
    b = trun.run_eval(model, tds, label2ans, batch_size=16, device_bank=bank,
                      compute_dtype=None)
    assert _by_qid(a) == _by_qid(b)


def test_predictor_matches_jax(world):
    tmp, store, jparams, model, tds, jds, label2ans = world
    reqs = [(e.question, e.image_id) for e in tds.entries[:11]]
    jp = jpred.Predictor(juc2.forward, jparams, JConfig(**CFG), JReader(store),
                         JTok(512), label2ans, max_seq_length=T,
                         max_region_num=R, batch_capacity=4, compute_dtype=None)
    tp = tpred.Predictor(model, CfsReader(store), HashTokenizer(512), label2ans,
                         max_seq_length=T, max_region_num=R, batch_capacity=4,
                         compute_dtype=None)
    want, got = jp.predict_batch(reqs), tp.predict_batch(reqs)
    assert [g["answer"] for g in got] == [w["answer"] for w in want]
    np.testing.assert_allclose([g["confidence"] for g in got],
                               [w["confidence"] for w in want], rtol=1e-5)
    assert all(0.0 <= g["confidence"] <= 1.0 for g in got)
    assert tp.predict(*reqs[3]) == got[3]
    full = _by_qid(trun.run_eval(model, tds, label2ans, batch_size=16,
                                 compute_dtype=None))
    for e, g in zip(tds.entries[:11], got):
        assert full[str(e.question_id)] == g["answer"]


def test_predictor_rejects_unknown_image_up_front(world):
    tmp, store, jparams, model, tds, jds, label2ans = world
    tp = tpred.Predictor(model, CfsReader(store), HashTokenizer(512), label2ans,
                         max_seq_length=T, max_region_num=R, compute_dtype=None)
    with pytest.raises(ValueError, match="unknown image_id"):
        tp.predict_batch([("what?", "img1"), ("why?", "missing")])


def test_dataset_batches_match_jax(world):
    """Host batches (tokens, masks, labels, store indices, padded tail)
    equal the JAX dataset's."""
    tmp, store, jparams, model, tds, jds, label2ans = world
    for with_features in (False, True):
        tb = list(tds.iter_batches(16, with_features=with_features))
        jb = list(jds.iter_batches(16, with_features=with_features))
        assert len(tb) == len(jb) == 3
        for a, b in zip(tb, jb):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    assert tb[-1]["valid"].sum() == N_Q - 32
