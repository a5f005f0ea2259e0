"""The port's code-mixed augmentation (clg_vqa_tpu_torch/data/code_mix.py)
against the JAX package's (clg_vqa_tpu/data/code_mix.py) on small MUSE
dictionaries written here: the same dictionaries, seed and sample keys give
the same questions, word for word, and the same token batches through the
two packages' GQADatasets. Exact equality throughout (string operations
and integer tokenization)."""
import numpy as np
import pytest

from clg_vqa_tpu.data import code_mix as JM
from clg_vqa_tpu.data.cfs import CfsReader as JReader
from clg_vqa_tpu.data.cfs import CfsWriter
from clg_vqa_tpu.data.features import RegionRecord
from clg_vqa_tpu.data.gqa import Entry as JEntry
from clg_vqa_tpu.data.gqa import GQADataset as JDataset
from clg_vqa_tpu.data.tokenizer import HashTokenizer as JTok
from clg_vqa_tpu_torch.data import code_mix as TM
from clg_vqa_tpu_torch.data.cfs import CfsReader
from clg_vqa_tpu_torch.data.gqa import Entry, GQADataset
from clg_vqa_tpu_torch.data.tokenizer import HashTokenizer

QUESTIONS = ["What color is the car ?", "Is the man on the left ?",
             "Which animal is it ?", "How many dogs are there ?",
             "Is the Table wooden or metal ?", "what ?", ""]


@pytest.fixture(scope="module")
def dict_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("muse")
    (d / "de-en.txt").write_text(
        "what\twas\ncolor\tfarbe\ncar\tauto\ncar\twagen\nman\tmann\n"
        "dog\thund\nthe\tdie\nthe\tder\nis\tist\n\n", encoding="utf8")
    (d / "zh-en.txt").write_text(
        "what 什么\ncolor 颜色\ncar 汽车\nanimal 动物\ntable 桌子\n"
        "badline\nleft 左\n", encoding="utf8")
    (d / "ko-en.txt").write_text("is 이다\nthe 그\nwooden 나무\n",
                                 encoding="utf8")
    return str(d)


def test_load_muse_dicts_matches_jax(dict_dir):
    got, want = TM.load_muse_dicts(dict_dir), JM.load_muse_dicts(dict_dir)
    assert got == want
    assert got["languages"] == ["de", "ko", "zh"]
    assert got["src2tgt"][0]["car"] == ["auto", "wagen"]
    assert "badline" not in got["src2tgt"][2]


@pytest.mark.parametrize("ratio,cross", [(1.0, 0.9), (0.5, 0.5), (0.0, 1.0)])
@pytest.mark.parametrize("reseed", [False, True])
def test_code_mixer_matches_jax(dict_dir, ratio, cross, reseed):
    dicts = TM.load_muse_dicts(dict_dir)
    for seed in (0, 3):
        t = TM.CodeMixer(dicts, ratio=ratio, cross=cross, seed=seed,
                         reference_reseed=reseed)
        j = JM.CodeMixer(JM.load_muse_dicts(dict_dir), ratio=ratio,
                         cross=cross, seed=seed, reference_reseed=reseed)
        outs = []
        for qid, q in enumerate(QUESTIONS):
            for epoch in range(3):
                key = (qid, epoch)
                outs.append(t(q, sample_key=key))
                assert outs[-1] == j(q, sample_key=key)
        if ratio == 1.0 and not reseed:
            # the dictionaries are used, and keys change the realization
            assert any(w in " ".join(outs) for w in ("auto", "汽车", "이다"))
            assert len(set(outs[0:3])) > 1 or len(set(outs[3:6])) > 1


def test_code_mixed_batches_match_jax(dict_dir, tmp_path):
    """A GQADataset with a code mixer tokenizes each sample's mixed question
    per epoch; the port's batches equal the JAX package's."""
    r = np.random.RandomState(0)
    store = str(tmp_path / "f.cfs")
    with CfsWriter(store) as w:
        for i in range(3):
            boxes = (r.rand(4, 4) * 40 + np.array([0, 0, 50, 50])).astype(
                np.float32)
            w.add(RegionRecord(f"i{i}", r.randn(4, 16).astype(np.float32),
                               boxes, 100.0, 100.0))
    qs = [dict(question_id=i, image_id=f"i{i % 3}",
               question=QUESTIONS[i % 5], labels=[i % 4], scores=[1.0])
          for i in range(10)]
    kw = dict(max_seq_length=12, max_region_num=4, num_locs=7, num_labels=4)
    tds = GQADataset([Entry(**q) for q in qs], CfsReader(store),
                     HashTokenizer(500), code_mixer=TM.CodeMixer(
                         TM.load_muse_dicts(dict_dir), seed=1), **kw)
    jds = JDataset([JEntry(**q) for q in qs], JReader(store), JTok(500),
                   code_mixer=JM.CodeMixer(JM.load_muse_dicts(dict_dir),
                                           seed=1), **kw)
    idx = list(range(10))
    seen = []
    for epoch in (0, 1):
        tds.set_epoch(epoch)
        jds.set_epoch(epoch)
        tb, jb = tds.make_batch(idx), jds.make_batch(idx)
        for k in ("input_ids", "input_mask", "labels", "features"):
            np.testing.assert_array_equal(tb[k], np.asarray(jb[k]), err_msg=k)
        seen.append(tb["input_ids"])
    assert not np.array_equal(seen[0], seen[1])
