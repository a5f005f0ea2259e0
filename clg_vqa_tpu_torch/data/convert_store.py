"""Feature-store converters (own copy of clg_vqa_tpu/data/convert_store.py)
— the reference's LMDB/h5 conversion zoo
(SURVEY.md §2.4: h5_to_lmdb.py, npy_to_lmdb.py, gqa_boxes36_h5-to-tdlmdb.py)
mapped onto CFS:

  h5  -> cfs    (detectron2_proposal_maxnms.py h5 schema: per-image group
                 with features/boxes/img_w/img_h[/obj_id/obj_conf/...])
  lmdb -> cfs   (pickled+b64 per-image records)
  npy  -> cfs   (mmf extractor {id}.npy + {id}_info.npy pairs)
  cfs  -> lmdb  (for handing features back to the reference stack)

LMDB I/O goes through py-lmdb when installed, else the in-repo codec
(data/lmdb_lite.py). The QA-joined tensorpack train-store converters
(tdlmdb <-> cfs/h5) live in data/tdlmdb.py.
"""
from __future__ import annotations

import base64
import glob
import os
import pickle

import numpy as np

from .cfs import CfsReader, CfsWriter
from .features import RegionRecord


def h5_to_cfs(h5_path: str, cfs_path: str) -> int:
    import h5py
    n = 0
    with h5py.File(h5_path, "r") as f, CfsWriter(cfs_path) as w:
        for image_id in f.keys():
            g = f[image_id]
            w.add(RegionRecord(
                image_id=str(image_id),
                features=np.asarray(g["features"], np.float32),
                boxes=np.asarray(g["boxes"], np.float32),
                img_w=float(np.asarray(g["img_w"])),
                img_h=float(np.asarray(g["img_h"])),
                obj_id=(np.asarray(g["obj_id"]) if "obj_id" in g else None),
                obj_conf=(np.asarray(g["obj_conf"])
                          if "obj_conf" in g else None),
                attr_id=(np.asarray(g["attr_id"]) if "attr_id" in g else None),
                attr_conf=(np.asarray(g["attr_conf"])
                           if "attr_conf" in g else None)))
            n += 1
    return n


def cfs_to_h5(cfs_path: str, h5_path: str) -> int:
    import h5py
    rd = CfsReader(cfs_path)
    with h5py.File(h5_path, "w") as f:
        for i in range(rd.n_records):
            rec = rd.get_by_index(i)
            g = f.create_group(rec.image_id)
            g["features"] = rec.features
            g["boxes"] = rec.boxes
            g["img_w"] = rec.img_w
            g["img_h"] = rec.img_h
            if rec.obj_id is not None:
                # full reference h5 schema (detectron2_proposal_maxnms.py:212-220)
                g["obj_id"] = rec.obj_id
                g["obj_conf"] = rec.obj_conf
                g["attr_id"] = rec.attr_id
                g["attr_conf"] = rec.attr_conf
    return rd.n_records


def lmdb_to_cfs(lmdb_path: str, cfs_path: str, *,
                feat_dim: int = 2048) -> int:
    """Reference per-image LMDB (pickled, b64 features) -> CFS."""
    from .lmdb_lite import open_compat
    env = open_compat(lmdb_path, readonly=True, lock=False)
    n = 0
    with env.begin(write=False) as txn, CfsWriter(cfs_path) as w:
        keys = pickle.loads(txn.get(b"keys"))
        for key in keys:
            item = pickle.loads(txn.get(key))
            try:
                feats = np.frombuffer(base64.b64decode(item["features"]),
                                      np.float32).reshape(-1, feat_dim)
                boxes = np.frombuffer(base64.b64decode(item["boxes"]),
                                      np.float32).reshape(-1, 4)
            except Exception:
                feats = np.asarray(item["features"]).reshape(-1, feat_dim)
                boxes = np.asarray(item["boxes"]).reshape(-1, 4)
            w.add(RegionRecord(
                image_id=key.decode() if isinstance(key, bytes) else str(key),
                features=feats, boxes=boxes,
                img_w=float(item["img_w"]), img_h=float(item["img_h"])))
            n += 1
    return n


def npy_to_cfs(npy_dir: str, cfs_path: str) -> int:
    """mmf extractor output ({id}.npy features + {id}_info.npy with bbox /
    image_width / image_height) -> CFS."""
    n = 0
    with CfsWriter(cfs_path) as w:
        for feat_file in sorted(glob.glob(os.path.join(npy_dir, "*.npy"))):
            if feat_file.endswith("_info.npy"):
                continue
            image_id = os.path.splitext(os.path.basename(feat_file))[0]
            info_file = os.path.join(npy_dir, image_id + "_info.npy")
            feats = np.load(feat_file)
            info = np.load(info_file, allow_pickle=True).item()
            w.add(RegionRecord(
                image_id=image_id, features=np.asarray(feats, np.float32),
                boxes=np.asarray(info["bbox"], np.float32),
                img_w=float(info["image_width"]),
                img_h=float(info["image_height"])))
            n += 1
    return n


def cfs_to_lmdb(cfs_path: str, lmdb_path: str) -> int:
    """CFS -> reference-compatible per-image LMDB (pickled records with b64
    features + a 'keys' entry) so the torch stack can read our features."""
    from .lmdb_lite import open_compat
    rd = CfsReader(cfs_path)
    env = open_compat(lmdb_path, map_size=1 << 40)
    keys = []
    with env.begin(write=True) as txn:
        for i in range(rd.n_records):
            rec = rd.get_by_index(i)
            key = rec.image_id.encode()
            keys.append(key)
            txn.put(key, pickle.dumps({
                "features": base64.b64encode(
                    np.ascontiguousarray(rec.features, np.float32)),
                "boxes": base64.b64encode(
                    np.ascontiguousarray(rec.boxes, np.float32)),
                "img_w": rec.img_w, "img_h": rec.img_h,
                "num_boxes": rec.features.shape[0],
            }))
        txn.put(b"keys", pickle.dumps(keys))
    return rd.n_records


# BUTD TSV schema (features_extraction/tsv_to_h5.py:15-16)
TSV_FIELDNAMES = ["img_id", "img_h", "img_w", "objects_id", "objects_conf",
                  "attrs_id", "attrs_conf", "num_boxes", "boxes", "features"]


def tsv_to_cfs(tsv_path: str, cfs_path: str, *, feat_dim: int = 2048,
               topk: int | None = None) -> int:
    """BUTD TSV feature dump -> CFS (the reference's tsv_to_h5.py /
    convert_vg_gqa_lmdb.py stage). Fields are b64-encoded numpy buffers."""
    import csv
    import sys
    csv.field_size_limit(sys.maxsize)
    n = 0
    with open(tsv_path) as f, CfsWriter(cfs_path) as w:
        reader = csv.DictReader(f, TSV_FIELDNAMES, delimiter="\t")
        for item in reader:
            nb = int(item["num_boxes"])
            boxes = np.frombuffer(base64.b64decode(item["boxes"]),
                                  np.float32).reshape(nb, 4)
            feats = np.frombuffer(base64.b64decode(item["features"]),
                                  np.float32).reshape(nb, feat_dim)
            obj_id = np.frombuffer(base64.b64decode(item["objects_id"]),
                                   np.int64).astype(np.int32)
            obj_conf = np.frombuffer(base64.b64decode(item["objects_conf"]),
                                     np.float32)
            attr_id = np.frombuffer(base64.b64decode(item["attrs_id"]),
                                    np.int64).astype(np.int32)
            attr_conf = np.frombuffer(base64.b64decode(item["attrs_conf"]),
                                      np.float32)
            w.add(RegionRecord(
                image_id=str(item["img_id"]), features=feats, boxes=boxes,
                img_w=float(item["img_w"]), img_h=float(item["img_h"]),
                obj_id=obj_id, obj_conf=obj_conf, attr_id=attr_id,
                attr_conf=attr_conf))
            n += 1
            if topk and n >= topk:
                break
    return n
