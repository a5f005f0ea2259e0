"""tensorpack-serialized ("td") LMDB ingest/export — the reference's PRIMARY
training artifact (own copy of clg_vqa_tpu/data/tdlmdb.py).

The reference's train path streams a QA-joined LMDB produced by tensorpack's
``LMDBSerializer.save`` (features_extraction/datasets/gqa/
gqa_boxes36_h5-to-tdlmdb.py:23-39): one record per QUESTION, keyed
``'{:08}'.format(idx)`` with a ``b'__keys__'`` index entry, each value a
msgpack blob (msgpack_numpy-patched, use_bin_type=True) of the dict

    {<h5 keys: features [36,2048] f32, boxes [36,4] f32, obj_id, obj_conf,
      attr_id, attr_conf, img_w, img_h>, 'img_id': str, 'entry': <target-pkl
      item: question_id, image_id, question, labels, scores>}

consumed by gqa_dataset_semantic_code_mix.py:300-344 (LMDBSerializer.load)
and 564-657 (BertPreprocessBatch: b64-or-raw features, img_w/img_h, entry).

This module provides:
 - msgpack_numpy-compatible ``dumps``/``loads`` (the pypi package is absent
   here; the encoding is the documented {b'nd', b'type', b'kind', b'shape',
   b'data'} dict convention).
 - ``TdLmdbReader``: random-access + streaming reader of td-lmdbs.
 - ``write_tdlmdb``: LMDBSerializer.save-equivalent writer (for tests and for
   handing training stores back to the reference stack).
 - ``tdlmdb_to_cfs``: split the QA-joined records into a CFS feature store +
   an entries list (the framework's native train inputs).
 - ``h5_to_tdlmdb``: the reference converter's equivalent (h5 + target pkl
   -> QA-joined td-lmdb).

LMDB I/O uses py-lmdb when installed, else the in-repo codec
(data/lmdb_lite.py). ``msgpack`` is imported by the functions that
(de)serialize records, not with the module (as ``h5py`` is by the h5
converters), so the package imports where msgpack is not installed.
"""
from __future__ import annotations

import pickle

import numpy as np

from . import lmdb_lite
from .features import RegionRecord


# ---------------------------------------------------------------------------
# msgpack_numpy-compatible serialization (tensorpack.utils.serialize)
# ---------------------------------------------------------------------------

def _mpn_encode(obj):
    if isinstance(obj, np.ndarray):
        if obj.dtype.kind == "V":
            kind, descr = b"V", obj.dtype.descr
        else:
            kind, descr = b"", obj.dtype.str
        return {b"nd": True, b"type": descr, b"kind": kind,
                b"shape": obj.shape,
                b"data": obj.tobytes() if not obj.flags["C_CONTIGUOUS"]
                else obj.data.tobytes()}
    if isinstance(obj, (np.bool_, np.number)):
        return {b"nd": False, b"type": obj.dtype.str, b"data": obj.tobytes()}
    if isinstance(obj, complex):
        return {b"complex": True, b"data": repr(obj)}
    return obj


def _mpn_decode(obj):
    if not isinstance(obj, dict):
        return obj
    try:
        if b"nd" in obj:
            if obj[b"nd"] is True:
                descr = obj[b"type"]
                if obj.get(b"kind") == b"V":
                    descr = [tuple(str(t) for t in d) for d in descr]
                return np.frombuffer(
                    obj[b"data"], dtype=np.dtype(descr)
                ).reshape(obj[b"shape"])
            return np.frombuffer(obj[b"data"],
                                 dtype=np.dtype(obj[b"type"]))[0]
        if b"complex" in obj:
            return complex(obj[b"data"])
    except KeyError:
        pass
    return obj


MAX_MSGPACK_LEN = 1_000_000_000    # tensorpack's limit (gqa_..._code_mix.py:28)


def dumps(obj) -> bytes:
    import msgpack
    return msgpack.packb(obj, use_bin_type=True, default=_mpn_encode)


def loads(buf) -> object:
    import msgpack
    return msgpack.unpackb(
        buf, raw=False, strict_map_key=False, object_hook=_mpn_decode,
        max_bin_len=MAX_MSGPACK_LEN, max_array_len=MAX_MSGPACK_LEN,
        max_map_len=MAX_MSGPACK_LEN, max_str_len=MAX_MSGPACK_LEN)


def _idx_key(i: int) -> bytes:
    return "{:08}".format(i).encode("ascii")     # LMDBSerializer key scheme


# ---------------------------------------------------------------------------
# Reader / writer
# ---------------------------------------------------------------------------

class TdLmdbReader:
    """Streaming + random-access reader of an LMDBSerializer-written store
    (gqa_dataset_semantic_code_mix.py:300: td.LMDBSerializer.load)."""

    def __init__(self, path: str):
        self._env = lmdb_lite.open_compat(path, readonly=True, lock=False,
                                          subdir=False)
        self._txn = self._env.begin(write=False)
        raw = self._txn.get(b"__keys__")
        if raw is not None:
            self.keys = list(loads(raw))
        else:                     # tensorpack also tolerates missing __keys__
            self.keys = [k for k, _ in self._iter_raw() if k != b"__keys__"]

    def _iter_raw(self):
        cur = self._txn.cursor()
        return iter(cur)

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, i: int):
        k = self.keys[i]
        if isinstance(k, str):
            k = k.encode("ascii")
        return loads(self._txn.get(k))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def write_tdlmdb(path: str, datapoints, *, map_size: int = 1 << 40) -> int:
    """LMDBSerializer.save-equivalent: sequential '{:08}' keys + __keys__."""
    items = []
    n = 0
    for i, dp in enumerate(datapoints):
        items.append((_idx_key(i), dumps(dp)))
        n += 1
    keys = [_idx_key(i) for i in range(n)]
    items.append((b"__keys__", dumps(keys)))
    try:
        import lmdb
        env = lmdb.open(path, subdir=False, map_size=map_size)
        with env.begin(write=True) as txn:
            for k, v in items:
                txn.put(k, v)
        env.close()
    except ImportError:
        lmdb_lite.write_lmdb(path, items, map_size=map_size)
    return n


# ---------------------------------------------------------------------------
# Converters
# ---------------------------------------------------------------------------

def _record_arrays(item: dict, feat_dim: int = 2048):
    """features/boxes from a td record — b64 or raw ndarray, both of which
    the reference loader accepts (gqa_..._code_mix.py:577-582)."""
    import base64
    feats, boxes = item["features"], item["boxes"]
    if not isinstance(feats, np.ndarray):
        feats = np.frombuffer(base64.b64decode(feats),
                              np.float32).reshape(-1, feat_dim)
    if not isinstance(boxes, np.ndarray):
        boxes = np.frombuffer(base64.b64decode(boxes),
                              np.float32).reshape(-1, 4)
    if feats.ndim == 1:
        feats = feats.reshape(-1, feat_dim)
    if boxes.ndim == 1:
        boxes = boxes.reshape(-1, 4)
    return np.asarray(feats, np.float32), np.asarray(boxes, np.float32)


def tdlmdb_to_cfs(td_path: str, cfs_path: str, entries_pkl: str | None = None,
                  *, feat_dim: int = 2048) -> tuple[int, int]:
    """QA-joined td-lmdb -> CFS feature store (unique images) + target-pkl
    style entries list. Returns (n_images, n_entries)."""
    from .cfs import CfsWriter
    rd = TdLmdbReader(td_path)
    entries, seen = [], set()
    with CfsWriter(cfs_path) as w:
        for item in rd:
            e = item["entry"]
            entries.append({
                "question_id": int(e["question_id"]),
                "image_id": e["image_id"],
                "question": e["question"],
                "labels": list(e.get("labels", []) or []),
                "scores": list(e.get("scores", []) or []),
            })
            img_id = str(item["img_id"])
            if img_id in seen:
                continue
            seen.add(img_id)
            feats, boxes = _record_arrays(item, feat_dim)
            w.add(RegionRecord(
                image_id=img_id, features=feats, boxes=boxes,
                img_w=float(item["img_w"]), img_h=float(item["img_h"]),
                obj_id=_maybe_arr(item, "obj_id"),
                obj_conf=_maybe_arr(item, "obj_conf"),
                attr_id=_maybe_arr(item, "attr_id"),
                attr_conf=_maybe_arr(item, "attr_conf")))
    if entries_pkl:
        with open(entries_pkl, "wb") as f:
            pickle.dump(entries, f)
    return len(seen), len(entries)


def _maybe_arr(item, key):
    v = item.get(key)
    return np.asarray(v) if isinstance(v, np.ndarray) else None


def h5_to_tdlmdb(h5_path: str, annotation_pkl: str, td_path: str) -> int:
    """The reference's gqa_boxes36_h5-to-tdlmdb.py:8-39 flow: group target
    entries by image, emit one record per question carrying the full h5
    group + img_id + entry."""
    import h5py
    from collections import defaultdict
    with open(annotation_pkl, "rb") as f:
        target = pickle.load(f)
    img2entries = defaultdict(list)
    for e in target:
        img2entries[str(e["image_id"])].append(e)

    def gen():
        with h5py.File(h5_path, "r") as f:
            ids = [i for i in f.keys() if i in img2entries]
            for img_id in ids:
                g = f[img_id]
                base = {k: g[k][()] for k in g.keys()}
                base["img_id"] = img_id
                for e in img2entries[img_id]:
                    item = dict(base)
                    item["entry"] = e
                    yield item

    return write_tdlmdb(td_path, gen())


def cfs_to_tdlmdb(cfs_path: str, annotation_pkl: str, td_path: str) -> int:
    """CFS + target pkl -> QA-joined td-lmdb (hand a training store back to
    the reference stack)."""
    from .cfs import CfsReader
    from collections import defaultdict
    rd = CfsReader(cfs_path)
    with open(annotation_pkl, "rb") as f:
        target = pickle.load(f)
    img2entries = defaultdict(list)
    for e in target:
        img2entries[str(e["image_id"])].append(e)

    def gen():
        for i in range(rd.n_records):
            rec = rd.get_by_index(i)
            if rec.image_id not in img2entries:
                continue
            base = {
                "features": np.asarray(rec.features, np.float32),
                "boxes": np.asarray(rec.boxes, np.float32),
                "img_w": np.int64(rec.img_w), "img_h": np.int64(rec.img_h),
                "img_id": rec.image_id,
            }
            if rec.obj_id is not None:
                base.update(obj_id=rec.obj_id, obj_conf=rec.obj_conf,
                            attr_id=rec.attr_id, attr_conf=rec.attr_conf)
            for e in img2entries[rec.image_id]:
                item = dict(base)
                item["entry"] = e
                yield item

    return write_tdlmdb(td_path, gen())


def load_tdlmdb_entries(td_path: str) -> list[dict]:
    """Entries only (question/answer join), target-pkl item schema."""
    rd = TdLmdbReader(td_path)
    out = []
    for item in rd:
        e = item["entry"]
        out.append({"question_id": int(e["question_id"]),
                    "image_id": e["image_id"], "question": e["question"],
                    "labels": list(e.get("labels", []) or []),
                    "scores": list(e.get("scores", []) or [])})
    return out
