"""Bank row gather and device feature bank (clg_vqa_tpu_torch/ops/bank_gather.py,
data/device_bank.py, data/cfs.py) against the JAX package: bit-exact
gathers, and CFS stores that each package's writer produces and the other's
reader reads."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from clg_vqa_tpu.data import cfs as jcfs
from clg_vqa_tpu.data.device_bank import DeviceFeatureBank as JBank
from clg_vqa_tpu.data.features import RegionRecord as JRecord
from clg_vqa_tpu.ops.bank_gather import rows_gather as j_rows_gather
from clg_vqa_tpu_torch.data import cfs as tcfs
from clg_vqa_tpu_torch.data.device_bank import DeviceFeatureBank as TBank
from clg_vqa_tpu_torch.data.features import RegionRecord as TRecord
from clg_vqa_tpu_torch.ops import bank_gather as TG

torch.set_num_threads(1)

N_IMGS, FEAT = 7, 16


def _records(seed):
    r = np.random.RandomState(seed)
    out = []
    for i in range(N_IMGS):
        n = r.randint(3, 10)
        boxes = np.stack([r.rand(n) * 40, r.rand(n) * 40, 40 + r.rand(n) * 60,
                          40 + r.rand(n) * 60], 1).astype(np.float32)
        feats = r.randn(n, FEAT).astype(np.float32)
        det = (r.randint(0, 90, n).astype(np.int32), r.rand(n).astype(np.float32)) \
            if i % 3 == 0 else (None, None)
        out.append(dict(image_id=f"img{i}", features=feats, boxes=boxes,
                        img_w=120.0 + i, img_h=100.0, obj_id=det[0],
                        obj_conf=det[1]))
    return out


def _write(path, writer_mod, record_cls, recs):
    with writer_mod.CfsWriter(str(path)) as w:
        for rec in recs:
            w.add(record_cls(**rec))


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bank")
    recs = _records(0)
    t_path, j_path = tmp / "port.cfs", tmp / "jax.cfs"
    _write(t_path, tcfs, TRecord, recs)
    _write(j_path, jcfs, JRecord, recs)
    return recs, t_path, j_path


def test_cfs_writers_write_the_same_bytes(stores):
    _, t_path, j_path = stores
    assert t_path.read_bytes() == j_path.read_bytes()


@pytest.mark.parametrize("direction", ["port_reads_jax", "jax_reads_port"])
def test_cfs_cross_read(stores, direction):
    recs, t_path, j_path = stores
    reader = (tcfs.CfsReader(str(j_path)) if direction == "port_reads_jax"
              else jcfs.CfsReader(str(t_path)))
    assert reader.n_records == N_IMGS
    assert reader.keys() == [r["image_id"] for r in recs]
    for i, rec in enumerate(recs):
        got = reader.get(rec["image_id"])
        np.testing.assert_array_equal(got.features, rec["features"])
        np.testing.assert_array_equal(got.boxes, rec["boxes"])
        assert (got.img_w, got.img_h) == (rec["img_w"], rec["img_h"])
        if rec["obj_id"] is None:
            assert got.obj_id is None
        else:
            np.testing.assert_array_equal(got.obj_id, rec["obj_id"])
            np.testing.assert_array_equal(got.obj_conf, rec["obj_conf"])


@pytest.mark.parametrize("num_locs,norm,glob", [(7, False, None), (5, False, None),
                                                (5, True, "first")])
def test_store_gather_matches_jax(stores, num_locs, norm, glob):
    _, t_path, _ = stores
    idx = np.array([3, 0, 6, 3, 1])
    kw = dict(max_regions=8, num_locs=num_locs, norm_embeddings=norm,
              add_global_imgfeat=glob)
    got = tcfs.CfsReader(str(t_path)).gather(idx, **kw)
    want = jcfs.CfsReader(str(t_path)).gather(idx, native=False, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_rows_gather_matches_jax_pallas_bit_exact():
    r = np.random.RandomState(1)
    bank = r.randn(9, 6, 32).astype(np.float32)
    idx = np.array([4, 0, 8, 4, 2, 2, 7], np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_rows_gather(jnp.asarray(bank), jnp.asarray(idx)))
    got = TG.rows_gather(torch.from_numpy(bank), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


def test_device_bank_gather_from_matches_jax(stores):
    _, t_path, _ = stores
    reader = tcfs.CfsReader(str(t_path))
    tbank = TBank(reader, max_regions=8, num_locs=7, device="cpu")
    jbank = JBank(jcfs.CfsReader(str(t_path)), max_regions=8, num_locs=7)
    assert tbank.id2idx == jbank.id2idx
    assert tbank.nbytes == jbank.nbytes
    idx = np.array([2, 0, 1, 6, 2], np.int32)
    want = JBank.gather_from(jbank.tensors(), jnp.asarray(idx))
    with pltpu.force_tpu_interpret_mode():
        want_pallas = JBank.gather_from(jbank.tensors(), jnp.asarray(idx),
                                        pallas=True)
    got = TBank.gather_from(tbank.tensors(), torch.from_numpy(idx))
    for g, w, wp in zip(got, want, want_pallas):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(wp))
    assert got[2].dtype == torch.int32


def test_rows_gather_rejects_bad_index():
    bank = torch.zeros(4, 2, 4)
    with pytest.raises(ValueError):
        TG.rows_gather(bank, torch.tensor([1, 2]))            # int64
    with pytest.raises(ValueError):
        TG.rows_gather(bank, torch.tensor([[1]], dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        TG.rows_gather(bank.to("meta"), torch.tensor([1], dtype=torch.int32,
                                                     device="meta"))


def test_bank_defaults_to_cuda_and_raises_without_it(stores, monkeypatch):
    _, t_path, _ = stores
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TBank(tcfs.CfsReader(str(t_path)), max_regions=8, num_locs=7)
