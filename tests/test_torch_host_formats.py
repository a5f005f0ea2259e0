"""The port's host formats and host-side modules against the JAX package's:
the LMDB codec (data/lmdb_lite.py), the per-image LMDB readers
(data/features.py), the td-lmdb codec and converters (data/tdlmdb.py), the
store converters (data/convert_store.py), the native CFS gather
(native/cfs_gather.cpp through data/cfs.py), the semantic-prior builders
(data/prior.py), the profiling helpers (utils/profiling.py), the device
bank's lookup / fill_batch and run_eval's split / log_every.

Every file and record is compared byte for byte or bit for bit; the native
gather is bit-equal to the Python path on every option."""
import base64
import os
import pickle

import numpy as np
import pytest
import torch

import jax

from clg_vqa_tpu.config import UC2Config as JConfig
from clg_vqa_tpu.data import cfs as jcfs
from clg_vqa_tpu.data import convert_store as jcs
from clg_vqa_tpu.data import features as jfeat
from clg_vqa_tpu.data import lmdb_lite as jlite
from clg_vqa_tpu.data import prior as jprior
from clg_vqa_tpu.data import tdlmdb as jtd
from clg_vqa_tpu.data.device_bank import DeviceFeatureBank as JBank
from clg_vqa_tpu.data.gqa import Entry as JEntry, GQADataset as JDataset
from clg_vqa_tpu.data.tokenizer import HashTokenizer as JTok
from clg_vqa_tpu.eval import runner as jrun
from clg_vqa_tpu.models import uc2 as juc2
from clg_vqa_tpu_torch.config import UC2Config
from clg_vqa_tpu_torch.data import cfs as tcfs
from clg_vqa_tpu_torch.data import convert_store as tcs
from clg_vqa_tpu_torch.data import features as tfeat
from clg_vqa_tpu_torch.data import lmdb_lite as tlite
from clg_vqa_tpu_torch.data import prior as tprior
from clg_vqa_tpu_torch.data import tdlmdb as ttd
from clg_vqa_tpu_torch.data.device_bank import DeviceFeatureBank
from clg_vqa_tpu_torch.data.gqa import Entry, GQADataset
from clg_vqa_tpu_torch.data.tokenizer import HashTokenizer
from clg_vqa_tpu_torch.eval import runner as trun
from clg_vqa_tpu_torch.native import cfs_native
from clg_vqa_tpu_torch.utils import profiling
from clg_vqa_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

N_IMGS, FEAT = 9, 32


def _records(seed: int, det: bool = True):
    r = np.random.RandomState(seed)
    out = []
    for i in range(N_IMGS):
        n = r.randint(3, 12)
        boxes = np.stack([r.rand(n) * 40, r.rand(n) * 40, 40 + r.rand(n) * 60,
                          40 + r.rand(n) * 60], 1).astype(np.float32)
        rec = dict(image_id=f"img{i}", features=r.randn(n, FEAT).astype(np.float32),
                   boxes=boxes, img_w=float(120 + i), img_h=100.0)
        if det and i % 3 == 0:
            rec.update(obj_id=r.randint(0, 90, n).astype(np.int32),
                       obj_conf=r.rand(n).astype(np.float32),
                       attr_id=r.randint(0, 9, n).astype(np.int32),
                       attr_conf=r.rand(n).astype(np.float32))
        out.append(rec)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("host_formats")
    recs = _records(0)
    store = str(tmp / "src.cfs")
    with tcfs.CfsWriter(store) as w:
        for rec in recs:
            w.add(tfeat.RegionRecord(**rec))
    target = [{"question_id": 100 + q, "image_id": f"img{q % N_IMGS}",
               "question": f"what is {q} ?", "labels": [q % 5],
               "scores": [1.0]} for q in range(2 * N_IMGS + 3)]
    target_pkl = str(tmp / "target.pkl")
    with open(target_pkl, "wb") as f:
        pickle.dump(target, f)
    return tmp, recs, store, target, target_pkl


def _bytes(path: str) -> bytes:
    path = os.path.join(path, "data.mdb") if os.path.isdir(path) else path
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# LMDB codec
# ---------------------------------------------------------------------------

def _items(seed: int, n: int):
    r = np.random.RandomState(seed)
    # values from a few bytes to several pages: the big ones go to
    # F_BIGDATA overflow pages (more than (4096 - 16) / 2 bytes)
    sizes = [int(s) for s in r.choice([5, 300, 2000, 2100, 9000, 20000], n)]
    return [(f"key{i:05d}".encode(), r.bytes(s)) for i, s in enumerate(sizes)]


@pytest.mark.parametrize("n", [1, 40, 700])
def test_write_lmdb_bytes_equal_jax(tmp_path, n):
    items = _items(n, n)
    assert any(len(v) > 2040 for _, v in items) or n == 1
    tlite.write_lmdb(str(tmp_path / "t.mdb"), items)
    jlite.write_lmdb(str(tmp_path / "j.mdb"), items)
    assert _bytes(str(tmp_path / "t.mdb")) == _bytes(str(tmp_path / "j.mdb"))
    # each package reads the other's file
    with tlite.Reader(str(tmp_path / "j.mdb")) as rt, \
            jlite.Reader(str(tmp_path / "t.mdb")) as rj:
        assert len(rt) == len(rj) == n
        assert list(rt.items()) == sorted(items) == list(rj.items())
        for k, v in items[:50]:
            assert rt.get(k) == v and rj.get(k) == v
        assert rt.get(b"absent") is None


def test_lmdb_environment_shim_round_trip(tmp_path):
    """The py-lmdb style environment (begin / put / commit / get / cursor)
    writes the same bytes as JAX's and reads them back."""
    items = _items(3, 25)
    for mod, name in ((tlite, "t"), (jlite, "j")):
        env = mod.open_compat(str(tmp_path / name), map_size=1 << 30)
        with env.begin(write=True) as txn:
            for k, v in items:
                txn.put(k, v)
    assert _bytes(str(tmp_path / "t")) == _bytes(str(tmp_path / "j"))
    env = tlite.open_compat(str(tmp_path / "j"), readonly=True)
    with env.begin() as txn:
        assert [kv for kv in txn.cursor()] == sorted(items)


# ---------------------------------------------------------------------------
# td-lmdb
# ---------------------------------------------------------------------------

def _td_item(r, i: int):
    return {"features": r.randn(4, FEAT).astype(np.float32),
            "boxes": r.rand(4, 4).astype(np.float32) * 50,
            "img_w": np.int64(640), "img_h": np.int64(480),
            "obj_id": r.randint(0, 9, 4).astype(np.int64),
            "img_id": f"img{i % 3}", "scalar": np.float32(0.5),
            "entry": {"question_id": i, "image_id": f"img{i % 3}",
                      "question": "q ?", "labels": [1, 2], "scores": [0.5, 1.0]}}


def test_tdlmdb_dumps_and_loads_match_jax():
    r = np.random.RandomState(0)
    for i in range(5):
        item = _td_item(r, i)
        b = ttd.dumps(item)
        assert b == jtd.dumps(item)
        back_t, back_j = ttd.loads(b), jtd.loads(b)
        for k in ("features", "boxes", "obj_id"):
            np.testing.assert_array_equal(back_t[k], item[k])
            assert back_t[k].dtype == back_j[k].dtype
        assert back_t["entry"] == back_j["entry"] == item["entry"]


def test_tdlmdb_writer_and_converters_match_jax(world):
    tmp, recs, store, target, target_pkl = world
    r = np.random.RandomState(1)
    items = [_td_item(r, i) for i in range(7)]
    assert ttd.write_tdlmdb(str(tmp / "t.td"), items) == 7
    jtd.write_tdlmdb(str(tmp / "j.td"), items)
    assert _bytes(str(tmp / "t.td")) == _bytes(str(tmp / "j.td"))
    rd = ttd.TdLmdbReader(str(tmp / "j.td"))
    assert len(rd) == 7 and rd[3]["entry"] == items[3]["entry"]
    # td -> CFS + entries: the same CFS bytes and entries
    nt = ttd.tdlmdb_to_cfs(str(tmp / "t.td"), str(tmp / "t.cfs"), str(tmp / "t.pkl"))
    nj = jtd.tdlmdb_to_cfs(str(tmp / "t.td"), str(tmp / "j.cfs"), str(tmp / "j.pkl"))
    assert nt == nj == (3, 7)
    assert _bytes(str(tmp / "t.cfs")) == _bytes(str(tmp / "j.cfs"))
    assert pickle.load(open(tmp / "t.pkl", "rb")) == pickle.load(open(tmp / "j.pkl", "rb"))
    assert ttd.load_tdlmdb_entries(str(tmp / "t.td")) == \
        jtd.load_tdlmdb_entries(str(tmp / "t.td"))
    # CFS + targets -> td: the same QA-joined store
    assert ttd.cfs_to_tdlmdb(store, target_pkl, str(tmp / "ct.td")) == \
        jtd.cfs_to_tdlmdb(store, target_pkl, str(tmp / "cj.td")) == len(target)
    assert _bytes(str(tmp / "ct.td")) == _bytes(str(tmp / "cj.td"))


def test_tdlmdb_b64_records_read_like_jax():
    """A record whose features / boxes are base64 strings (the reference
    loader takes both forms) gives JAX's arrays."""
    r = np.random.RandomState(2)
    item = _td_item(r, 0)
    item["features"] = base64.b64encode(item["features"].tobytes())
    item["boxes"] = base64.b64encode(item["boxes"].tobytes())
    for a, b in zip(ttd._record_arrays(item, FEAT), jtd._record_arrays(item, FEAT)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# store converters
# ---------------------------------------------------------------------------

def test_cfs_lmdb_round_trip_matches_jax(world):
    tmp, recs, store, *_ = world
    assert tcs.cfs_to_lmdb(store, str(tmp / "t_lmdb")) == N_IMGS
    jcs.cfs_to_lmdb(store, str(tmp / "j_lmdb"))
    assert _bytes(str(tmp / "t_lmdb")) == _bytes(str(tmp / "j_lmdb"))
    assert tcs.lmdb_to_cfs(str(tmp / "t_lmdb"), str(tmp / "back_t.cfs"),
                           feat_dim=FEAT) == N_IMGS
    jcs.lmdb_to_cfs(str(tmp / "t_lmdb"), str(tmp / "back_j.cfs"), feat_dim=FEAT)
    assert _bytes(str(tmp / "back_t.cfs")) == _bytes(str(tmp / "back_j.cfs"))


def test_npy_and_tsv_to_cfs_match_jax(tmp_path):
    r = np.random.RandomState(3)
    d = tmp_path / "npy"
    d.mkdir()
    rows = []
    for i in range(4):
        n = r.randint(2, 6)
        feats = r.randn(n, 2048).astype(np.float32)
        boxes = (r.rand(n, 4) * 90).astype(np.float32)
        np.save(d / f"im{i}.npy", feats)
        np.save(d / f"im{i}_info.npy", {"bbox": boxes, "image_width": 100 + i,
                                        "image_height": 90})
        b64 = [base64.b64encode(a.tobytes()).decode() for a in (
            r.randint(0, 9, n).astype(np.int64), r.rand(n).astype(np.float32),
            r.randint(0, 9, n).astype(np.int64), r.rand(n).astype(np.float32),
            boxes, feats)]
        rows.append("\t".join([f"im{i}", "90", str(100 + i), *b64[:4], str(n),
                               *b64[4:]]))
    (tmp_path / "f.tsv").write_text("\n".join(rows) + "\n")
    for fn, src in (("npy_to_cfs", str(d)), ("tsv_to_cfs", str(tmp_path / "f.tsv"))):
        assert getattr(tcs, fn)(src, str(tmp_path / "t.cfs")) == 4
        getattr(jcs, fn)(src, str(tmp_path / "j.cfs"))
        assert _bytes(str(tmp_path / "t.cfs")) == _bytes(str(tmp_path / "j.cfs")), fn


def test_h5_converters_match_jax(world):
    h5py = pytest.importorskip("h5py")
    tmp, recs, store, target, target_pkl = world
    assert tcs.cfs_to_h5(store, str(tmp / "t.h5")) == N_IMGS
    jcs.cfs_to_h5(store, str(tmp / "j.h5"))
    with h5py.File(tmp / "t.h5") as a, h5py.File(tmp / "j.h5") as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a.keys():
            assert sorted(a[k].keys()) == sorted(b[k].keys())
            for f in a[k].keys():
                np.testing.assert_array_equal(a[k][f][()], b[k][f][()])
    tcs.h5_to_cfs(str(tmp / "t.h5"), str(tmp / "h_t.cfs"))
    jcs.h5_to_cfs(str(tmp / "t.h5"), str(tmp / "h_j.cfs"))
    assert _bytes(str(tmp / "h_t.cfs")) == _bytes(str(tmp / "h_j.cfs"))
    assert ttd.h5_to_tdlmdb(str(tmp / "t.h5"), target_pkl, str(tmp / "h_t.td")) == \
        jtd.h5_to_tdlmdb(str(tmp / "t.h5"), target_pkl, str(tmp / "h_j.td"))
    assert _bytes(str(tmp / "h_t.td")) == _bytes(str(tmp / "h_j.td"))


# ---------------------------------------------------------------------------
# feature readers
# ---------------------------------------------------------------------------

def test_lmdb_feature_reader_matches_jax(world):
    tmp, recs, store, *_ = world
    path = str(tmp / "reader_lmdb")
    tcs.cfs_to_lmdb(store, path)
    t, j = tfeat.LmdbFeatureReader(path, feat_dim=FEAT), \
        jfeat.LmdbFeatureReader(path, feat_dim=FEAT)
    assert t.n_records == j.n_records == N_IMGS and t.id2idx == j.id2idx
    cfs = tcfs.CfsReader(store)
    for i in range(N_IMGS):
        a, b = t.get_by_index(i), j.get_by_index(i)
        # the port names the record by the key's text; JAX's str(bytes)
        assert a.image_id == f"img{i}" and b.image_id == str(f"img{i}".encode())
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.features, cfs.get(f"img{i}").features)
        np.testing.assert_array_equal(a.boxes, b.boxes)
        assert (a.img_w, a.img_h) == (b.img_w, b.img_h)
    idx = np.array([4, 0, 8, 4])
    for norm, glob in ((False, None), (True, "first"), (True, "last")):
        kw = dict(max_regions=6, num_locs=5, norm_embeddings=norm,
                  add_global_imgfeat=glob)
        for a, b, c in zip(t.gather(idx, **kw), j.gather(idx, **kw),
                           cfs.gather(idx, **kw)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("num_locs,glob", [(5, None), (5, "first"), (7, "last")])
def test_all_features_reader_matches_jax(world, num_locs, glob):
    tmp, recs, store, *_ = world
    t = tfeat.AllFeaturesReader(tcfs.CfsReader(store), num_locs=num_locs,
                                add_global_imgfeat=glob)
    j = jfeat.AllFeaturesReader(jcfs.CfsReader(store), num_locs=num_locs,
                                add_global_imgfeat=glob)
    assert len(t) == len(j) == N_IMGS
    for image_id in ("img0", "img1", "img3"):
        for a, b in zip(t[image_id], j[image_id]):
            if a is None or b is None:
                assert a is None and b is None
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the native gather
# ---------------------------------------------------------------------------

GATHER_OPTS = [(36, 7, False, None), (6, 5, False, None), (6, 5, True, None),
               (6, 5, True, "first"), (6, 5, False, "last"), (4, 7, True, "last"),
               (12, 5, True, "first")]


@pytest.mark.parametrize("R,num_locs,norm,glob", GATHER_OPTS)
def test_native_gather_is_the_python_path_bit_for_bit(world, R, num_locs, norm, glob):
    """The port's native gather equals its Python path and JAX's Python path
    bit for bit on every option, L2 norm and global feature included; JAX's
    own native gather agrees on the default path and is close on the
    others (it normalizes in double precision)."""
    tmp, recs, store, *_ = world
    idx = np.array([3, 0, 8, 3, 1, 7, 5])
    kw = dict(max_regions=R, num_locs=num_locs, norm_embeddings=norm,
              add_global_imgfeat=glob)
    rd = tcfs.CfsReader(store)
    native = rd.gather(idx, **kw)
    py = rd.gather(idx, native=False, **kw)
    jpy = jcfs.CfsReader(store).gather(idx, native=False, **kw)
    jnat = jcfs.CfsReader(store).gather(idx, native=True, **kw)
    for a, b, c, d in zip(native, py, jpy, jnat):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
        np.testing.assert_array_equal(a.view(np.uint8), c.view(np.uint8))
        if not norm and glob is None:
            np.testing.assert_array_equal(a, d)
        else:
            np.testing.assert_allclose(a, d, rtol=1e-6, atol=1e-7)


def test_native_gather_builds_into_build_dir_and_raises_on_failure(monkeypatch, tmp_path):
    """The library is the port's own build under build/native (never the
    JAX package's .so); a failed build raises instead of falling back."""
    so = cfs_native.build()
    assert so.parent == cfs_native.BUILD_DIR and so.parent.parent.name == "build"
    assert so.name.startswith("libcfs_gather-") and so.exists()
    assert "clg_vqa_tpu_torch" in str(cfs_native.SRC)
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(cfs_native, "SRC", bad)
    monkeypatch.setattr(cfs_native, "BUILD_DIR", tmp_path / "b")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        cfs_native.build()


def test_native_gather_rejects_a_mixed_store(tmp_path):
    path = str(tmp_path / "mixed.cfs")
    r = np.random.RandomState(4)
    with tcfs.CfsWriter(path) as w:
        for i, fd in enumerate((8, 8, 16)):
            w.add(tfeat.RegionRecord(f"m{i}", r.randn(3, fd).astype(np.float32),
                                     r.rand(3, 4).astype(np.float32) * 9, 10.0, 10.0))
    with pytest.raises(ValueError, match="feature dim"):
        tcfs.CfsReader(path).gather([0, 2], max_regions=4)
    # the C++ reads offsets[index]: an index outside the store raises first
    for bad in ([0, 3], [-1]):
        with pytest.raises(IndexError):
            tcfs.CfsReader(path).gather(bad, max_regions=4)


# ---------------------------------------------------------------------------
# semantic priors
# ---------------------------------------------------------------------------

def test_prior_builders_match_jax(tmp_path):
    r = np.random.RandomState(5)
    words = ["red", "dark", "blue", "car", "tree", "big"]
    vectors = {w: r.randn(6).astype(np.float32) for w in words}
    labels = ["red", "dark blue", "car", "unknown thing", "big tree"]
    for lab in labels:
        np.testing.assert_array_equal(tprior.phrase_vector(lab, vectors, 6),
                                      jprior.phrase_vector(lab, vectors, 6))
    assert tprior.build_embedding_distances(labels, vectors) == \
        jprior.build_embedding_distances(labels, vectors)
    glove = tmp_path / "glove.txt"
    lines = [w + " " + " ".join(f"{x:.5f}" for x in v) for w, v in vectors.items()]
    lines += [". . . 0.1 0.2 0.3 0.4 0.5 0.6", "bad 0.1 x 0.3 0.4 0.5 0.6"]
    glove.write_text("\n".join(lines) + "\n")
    for vocab in (None, {"red", "car", ". . ."}):
        a = tprior.load_glove_vectors(str(glove), vocab=vocab)
        b = jprior.load_glove_vectors(str(glove), vocab=vocab)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    tprior.save_pickle({"x": 1}, str(tmp_path / "p.pkl"))
    assert pickle.load(open(tmp_path / "p.pkl", "rb")) == {"x": 1}


def test_wordnet_relations_gated_like_jax():
    """build_wordnet_relations needs nltk's WordNet corpus: with it both
    packages give the same relations, without it both raise alike."""
    labels = ["dog", "puppy", "animal", "car"]
    try:
        want = jprior.build_wordnet_relations(labels)
    except Exception as e:                        # corpus (or nltk) absent
        with pytest.raises(type(e)):
            tprior.build_wordnet_relations(labels)
        return
    assert tprior.build_wordnet_relations(labels) == want


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_memory_stats_and_trace_on_cpu(tmp_path):
    stats = profiling.device_memory_stats()
    if torch.cuda.is_available():
        assert all({"bytes_in_use", "peak_bytes_in_use", "bytes_limit"} <= set(d)
                   for d in stats)
    else:
        assert stats == [{"device": "cpu"}]
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())


# ---------------------------------------------------------------------------
# the device bank's lookup / fill_batch, run_eval's split / log_every
# ---------------------------------------------------------------------------

UC2_CFG = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=2,
               intermediate_size=64, v_feature_size=FEAT, num_locs=7,
               pooler_size=32, clf_hidden_size=32, num_labels=5)


def test_bank_lookup_and_fill_batch_match_jax(world):
    tmp, recs, store, *_ = world
    kw = dict(max_regions=8, num_locs=7)
    t = DeviceFeatureBank(tcfs.CfsReader(store), device="cpu", **kw)
    j = JBank(jcfs.CfsReader(store), **kw)
    idx = np.array([2, 8, 0, 2], np.int32)
    for a, b in zip(t.lookup(idx), j.lookup(idx)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    batch = {"input_ids": np.ones((4, 3), np.int32), "store_idx": idx}
    got, want = t.fill_batch(batch), j.fill_batch(batch)
    assert set(got) == set(want) == {"input_ids", "features", "locs", "image_mask"}
    for k in ("features", "locs", "image_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_run_eval_split_and_log_every_match_jax(world, capsys):
    tmp, recs, store, target, _ = world
    qs = [(e["question_id"], e["image_id"], e["question"], e["labels"][0])
          for e in target]
    ds_kw = dict(max_seq_length=8, max_region_num=8, num_locs=7, num_labels=5)
    tds = GQADataset([Entry(*q[:3], [q[3]], [1.0]) for q in qs],
                     tcfs.CfsReader(store), HashTokenizer(256), **ds_kw)
    jds = JDataset([JEntry(*q[:3], [q[3]], [1.0]) for q in qs],
                   jcfs.CfsReader(store), JTok(256), **ds_kw)
    jparams = juc2.init_params(jax.random.key(1), JConfig(**UC2_CFG))
    model = from_jax_params(jax.tree.map(np.asarray, jparams),
                            UC2Config(**UC2_CFG), device="cpu")
    label2ans = [f"a{k}" for k in range(5)]
    kw = dict(batch_size=4, compute_dtype=None, split="val", log_every=8)
    capsys.readouterr()
    want = jrun.run_eval(juc2.forward, jparams, JConfig(**UC2_CFG), jds,
                         label2ans, **kw)
    jlog = capsys.readouterr().out
    got = trun.run_eval(model, tds, label2ans, **kw)
    tlog = capsys.readouterr().out
    assert got["results"] == want["results"] and got["n"] == len(target)
    assert tlog == jlog and tlog.count("  eval ") == len(target) // 8
