"""Region-feature processing and the LMDB readers (own copy of
clg_vqa_tpu/data/features.py).

``process_regions`` reproduces the box/feature normalization of every
reference data path (volta/volta/datasets/_image_features_reader.py:141-205
and gqa_dataset_semantic_code_mix.py:575-615): boxes normalized to [0,1],
relative area as the last loc, optional width/height locs (num_locs=7),
optional L2 normalization, optional global mean feature.

``LmdbFeatureReader`` reads the reference's per-image feature LMDBs (py-lmdb
when installed, else the in-repo codec, data/lmdb_lite.py) with the same
store surface as data/cfs.CfsReader; ``AllFeaturesReader`` returns every
field an extractor wrote for an image.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RegionRecord:
    """One image's detector output (the h5/LMDB record schema of
    features_extraction/detectron2_proposal_maxnms.py:212-220)."""
    image_id: str
    features: np.ndarray      # [N, feat_dim] float32
    boxes: np.ndarray         # [N, 4] float32 pixel xyxy
    img_w: float
    img_h: float
    obj_id: np.ndarray | None = None
    obj_conf: np.ndarray | None = None
    attr_id: np.ndarray | None = None
    attr_conf: np.ndarray | None = None


def process_regions(features: np.ndarray, boxes: np.ndarray, img_w: float,
                    img_h: float, *, num_locs: int = 5,
                    norm_embeddings: bool = False,
                    add_global_imgfeat: str | None = None):
    """Returns (features [N(+1), D], num_boxes, locs [N(+1), num_locs])."""
    n = boxes.shape[0]
    locs = np.zeros((n, num_locs), np.float32)
    locs[:, :4] = boxes
    if num_locs >= 5:
        locs[:, -1] = ((locs[:, 3] - locs[:, 1]) * (locs[:, 2] - locs[:, 0])
                       / (float(img_w) * float(img_h)))
    locs[:, 0] /= float(img_w)
    locs[:, 1] /= float(img_h)
    locs[:, 2] /= float(img_w)
    locs[:, 3] /= float(img_h)
    if num_locs > 5:
        locs[:, 4] = locs[:, 2] - locs[:, 0]
        locs[:, 5] = locs[:, 3] - locs[:, 1]

    features = np.asarray(features, np.float32)
    if norm_embeddings:
        features = features / np.maximum(
            np.linalg.norm(features, axis=-1, keepdims=True), 1e-12)
        locs = locs / np.linalg.norm(locs, 2, 1, keepdims=True)

    num_boxes = n
    if add_global_imgfeat is not None:
        g_feat = features.sum(0, keepdims=True) / max(n, 1)
        g_loc = np.array([[0, 0, 1, 1] + [1] * (num_locs - 4)], np.float32)
        if add_global_imgfeat == "first":
            features = np.concatenate([g_feat, features], 0)
            locs = np.concatenate([g_loc, locs], 0)
        elif add_global_imgfeat == "last":
            features = np.concatenate([features, g_feat], 0)
            locs = np.concatenate([locs, g_loc], 0)
        num_boxes += 1
    return features, num_boxes, locs


def pad_regions(features: np.ndarray, locs: np.ndarray, num_boxes: int,
                max_regions: int, feat_dim: int = 2048, num_locs: int = 5):
    """Fixed-shape padding (gqa_dataset_semantic_code_mix.py:213-226)."""
    n = min(num_boxes, max_regions)
    f = np.zeros((max_regions, feat_dim), np.float32)
    l = np.zeros((max_regions, num_locs), np.float32)
    m = np.zeros((max_regions,), np.int32)
    f[:n] = features[:n]
    l[:n] = locs[:n]
    m[:n] = 1
    return f, l, m


def gather_records(get_by_index, indices, *, max_regions: int,
                   num_locs: int = 5, norm_embeddings: bool = False,
                   add_global_imgfeat: str | None = None):
    """Process + pad each record to fixed (features [B, R', D],
    locs [B, R', num_locs], mask [B, R']) batch shapes, R' = max_regions
    (+1 with a global feature)."""
    B = len(indices)
    Rp = max_regions + int(add_global_imgfeat is not None)
    fd = None
    feats_out = None
    locs_out = np.zeros((B, Rp, num_locs), np.float32)
    mask_out = np.zeros((B, Rp), np.int32)
    for i, idx in enumerate(indices):
        rec = get_by_index(int(idx))
        if feats_out is None:
            fd = rec.features.shape[1]
            feats_out = np.zeros((B, Rp, fd), np.float32)
        f, n, l = process_regions(
            rec.features, rec.boxes, rec.img_w, rec.img_h,
            num_locs=num_locs, norm_embeddings=norm_embeddings,
            add_global_imgfeat=add_global_imgfeat)
        pf, pl, pm = pad_regions(f, l, n, Rp, feat_dim=fd,
                                 num_locs=num_locs)
        feats_out[i], locs_out[i], mask_out[i] = pf, pl, pm
    return feats_out, locs_out, mask_out


class AllFeaturesReader:
    """Full-record reader — the reference's `_all_image_features_reader.py`
    variant (19-146): unlike the padded/normalized training reader it returns
    EVERYTHING the extractor wrote for an image, including the un-normalized
    pixel locations and the detection metadata (class/attribute labels and
    confidences) that pretraining-style consumers need.

    Wraps any store with ``get(image_id) -> RegionRecord`` (LMDB or CFS).
    Reference quirks reproduced exactly:
      - the area column is computed only for num_locs == 5 (the all-reader
        has no 7-loc branch, _all_image_features_reader.py:91-97);
      - ``image_location_ori`` is the pixel-space copy taken BEFORE
        normalization (99-104);
      - obj_confs is reshaped to [-1, num_boxes_without_global] (139);
      - cls_prob / attrs fall back to None when the store lacks them
        (134-138 try/except).
    """

    def __init__(self, reader, *, num_locs: int = 5,
                 add_global_imgfeat: str | None = None):
        self.reader = reader
        self.num_locs = num_locs
        self.add_global_imgfeat = add_global_imgfeat

    def __len__(self):
        return len(self.reader.keys())

    def keys(self):
        return self.reader.keys()

    def __getitem__(self, image_id):
        rec = self.reader.get(image_id)
        feats = np.asarray(rec.features, np.float32)
        boxes = np.asarray(rec.boxes, np.float32)
        w, h = float(rec.img_w), float(rec.img_h)

        loc = np.zeros((boxes.shape[0], self.num_locs), np.float32)
        loc[:, :4] = boxes
        if self.num_locs == 5:
            loc[:, 4] = ((loc[:, 3] - loc[:, 1]) * (loc[:, 2] - loc[:, 0])
                         / (w * h))
        loc_ori = loc.copy()
        loc[:, 0] /= w
        loc[:, 1] /= h
        loc[:, 2] /= w
        loc[:, 3] /= h

        num_boxes = feats.shape[0]
        if self.add_global_imgfeat in ("first", "last"):
            g_feat = feats.sum(0, keepdims=True) / num_boxes
            g_loc = np.array([[0, 0, 1, 1] + [1] * (self.num_locs - 4)],
                             np.float32)
            g_ori = np.array([[0, 0, w, h] + [w * h] * (self.num_locs - 4)],
                             np.float32)
            num_boxes += 1
            if self.add_global_imgfeat == "first":
                feats = np.concatenate([g_feat, feats], 0)
                loc = np.concatenate([g_loc, loc], 0)
                loc_ori = np.concatenate([g_ori, loc_ori], 0)
            else:
                feats = np.concatenate([feats, g_feat], 0)
                loc = np.concatenate([loc, g_loc], 0)
                loc_ori = np.concatenate([loc_ori, g_ori], 0)

        image_cls = getattr(rec, "cls_prob", None)
        image_attrs = None
        obj_labels = np.asarray(rec.obj_id, np.int64) \
            if rec.obj_id is not None else None
        obj_confs = None
        if rec.obj_conf is not None:
            n_no_global = num_boxes - (self.add_global_imgfeat is not None)
            obj_confs = np.asarray(rec.obj_conf, np.float32) \
                .reshape(-1, n_no_global)
        attr_labels = np.asarray(rec.attr_id, np.int64) \
            if rec.attr_id is not None else None
        attr_confs = np.asarray(rec.attr_conf, np.float32) \
            if rec.attr_conf is not None else None

        return (feats, num_boxes, loc, loc_ori, image_cls, obj_labels,
                obj_confs, attr_labels, attr_confs, image_attrs)


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

class LmdbFeatureReader:
    """Random-access reader for reference-produced per-image LMDBs
    (pickled records keyed by image id, 'keys' entry listing ids;
    _image_features_reader.py:19-208). Uses py-lmdb when installed, else the
    in-repo LMDB codec (data/lmdb_lite.py). Uses an O(1) id->index dict
    instead of the reference's linear list scan (line 75)."""

    def __init__(self, path: str, *, feat_dim: int = 2048):
        import pickle
        from .lmdb_lite import open_compat
        self._pickle = pickle
        self.env = open_compat(path, max_readers=16, readonly=True,
                               lock=False, readahead=False, meminit=False)
        with self.env.begin(write=False) as txn:
            self.image_ids = pickle.loads(txn.get(b"keys"))
        self.feat_dim = feat_dim
        self._id2idx: dict[str, int] | None = None

    def keys(self):
        return self.image_ids

    # -- store protocol (what GQADataset / DeviceFeatureBank /
    # -- AllFeaturesReader consume; same surface as CfsReader) ------------

    @property
    def n_records(self) -> int:
        return len(self.image_ids)

    @property
    def id2idx(self) -> dict[str, int]:
        if self._id2idx is None:
            self._id2idx = {
                (k.decode() if isinstance(k, bytes) else str(k)): i
                for i, k in enumerate(self.image_ids)}
        return self._id2idx

    def get_by_index(self, idx: int) -> "RegionRecord":
        return self.get(self.image_ids[int(idx)])

    def gather(self, indices, *, max_regions: int, num_locs: int = 5,
               norm_embeddings: bool = False,
               add_global_imgfeat: str | None = None):
        return gather_records(self.get_by_index, np.asarray(indices),
                              max_regions=max_regions, num_locs=num_locs,
                              norm_embeddings=norm_embeddings,
                              add_global_imgfeat=add_global_imgfeat)

    def get(self, image_id) -> RegionRecord:
        import base64
        key = str(image_id).encode() if not isinstance(image_id, bytes) else image_id
        with self.env.begin(write=False) as txn:
            item = self._pickle.loads(txn.get(key))
        try:
            feats = np.frombuffer(base64.b64decode(item["features"]),
                                  np.float32).reshape(-1, self.feat_dim)
            boxes = np.frombuffer(base64.b64decode(item["boxes"]),
                                  np.float32).reshape(-1, 4)
        except Exception:
            feats = np.asarray(item["features"]).reshape(-1, self.feat_dim)
            boxes = np.asarray(item["boxes"]).reshape(-1, 4)
        # a bytes key (the 'keys' index holds bytes) names the image by its
        # text; the JAX reader keeps str(bytes), "b'...'", there
        name = image_id.decode() if isinstance(image_id, bytes) else str(image_id)
        return RegionRecord(
            image_id=name, features=feats, boxes=boxes,
            img_w=float(item["img_w"]), img_h=float(item["img_h"]))
