"""CFS — the region-feature store (own copy of clg_vqa_tpu/data/cfs.py:45-193).

One flat, mmap-able little-endian file; the JAX package's writer and reader
share this exact layout, so a store written by one is read by the other.

Layout (v2):
  header:  magic b"CFS1" | u32 version | u64 n_records | u64 index_offset
  records: per record —
           u32 id_len | id bytes | u32 n_boxes | u32 feat_dim |
           f32 img_w | f32 img_h |
           f32 features[n_boxes*feat_dim] | f32 boxes[n_boxes*4] |
           u8 flags | (flags&1: i32 obj_id[n] | f32 obj_conf[n] |
                       i32 attr_id[n] | f32 attr_conf[n])
  index:   u64 offsets[n_records]  (each points at a record's id_len)
  (v1 records lack the flags byte; the reader handles both.)

Batch assembly (``CfsReader.gather``) runs the native C++ gather
(native/cfs_gather.cpp through ctypes, threads over the batch, the GIL
released) by default, bit-equal to the Python path (``native=False``,
data/features.gather_records) on every option.
"""
from __future__ import annotations

import mmap
import struct
import threading

import numpy as np

from .features import RegionRecord, gather_records

MAGIC = b"CFS1"
VERSION = 2
_HDR = struct.Struct("<4sIQQ")


class CfsWriter:
    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "wb")
        self.f.write(_HDR.pack(MAGIC, VERSION, 0, 0))
        self.offsets: list[int] = []

    def add(self, rec: RegionRecord) -> None:
        f = self.f
        self.offsets.append(f.tell())
        idb = rec.image_id.encode()
        feats = np.ascontiguousarray(rec.features, np.float32)
        boxes = np.ascontiguousarray(rec.boxes, np.float32)
        n, fd = feats.shape
        if boxes.shape != (n, 4):
            raise ValueError(f"boxes {boxes.shape} do not match {n} regions")
        f.write(struct.pack("<I", len(idb)))
        f.write(idb)
        f.write(struct.pack("<IIff", n, fd, float(rec.img_w), float(rec.img_h)))
        f.write(feats.tobytes())
        f.write(boxes.tobytes())
        # detection block flags: 0 none, 1 obj+attr, 2 obj only
        has_obj = rec.obj_id is not None
        has_attr = has_obj and rec.attr_id is not None
        f.write(struct.pack("<B", 1 if has_attr else (2 if has_obj else 0)))
        if has_obj:
            f.write(np.ascontiguousarray(rec.obj_id, "<i4").tobytes())
            f.write(np.ascontiguousarray(rec.obj_conf, "<f4").tobytes())
        if has_attr:
            f.write(np.ascontiguousarray(rec.attr_id, "<i4").tobytes())
            f.write(np.ascontiguousarray(rec.attr_conf, "<f4").tobytes())

    def close(self) -> None:
        f = self.f
        index_offset = f.tell()
        f.write(np.asarray(self.offsets, "<u8").tobytes())
        f.seek(0)
        f.write(_HDR.pack(MAGIC, VERSION, len(self.offsets), index_offset))
        f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class CfsReader:
    """Zero-copy random access by image id or record index."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        magic, version, n, index_offset = _HDR.unpack_from(self._mm, 0)
        if magic != MAGIC or version not in (1, 2):
            self.close()
            raise ValueError(f"not a CFS file: {path}")
        self.version = version
        self.n_records = n
        self.offsets = np.frombuffer(self._mm, "<u8", count=n,
                                     offset=index_offset)
        self._id2idx: dict[str, int] | None = None
        self._native = None            # the native gather's own mmap handle
        self._native_lock = threading.Lock()

    def _parse_header(self, off: int):
        (id_len,) = struct.unpack_from("<I", self._mm, off)
        ido = off + 4
        image_id = self._mm[ido:ido + id_len].decode()
        n, fd, w, h = struct.unpack_from("<IIff", self._mm, ido + id_len)
        data_off = ido + id_len + 16
        return image_id, n, fd, w, h, data_off

    @property
    def id2idx(self) -> dict[str, int]:
        if self._id2idx is None:
            self._id2idx = {}
            for i in range(self.n_records):
                image_id, *_ = self._parse_header(int(self.offsets[i]))
                self._id2idx[image_id] = i
        return self._id2idx

    def keys(self):
        return list(self.id2idx.keys())

    def get_by_index(self, idx: int) -> RegionRecord:
        image_id, n, fd, w, h, off = self._parse_header(int(self.offsets[idx]))
        feats = np.frombuffer(self._mm, "<f4", count=n * fd,
                              offset=off).reshape(n, fd)
        boff = off + n * fd * 4
        boxes = np.frombuffer(self._mm, "<f4", count=n * 4,
                              offset=boff).reshape(n, 4)
        rec = RegionRecord(image_id=image_id, features=feats, boxes=boxes,
                           img_w=w, img_h=h)
        if self.version >= 2:
            doff = boff + n * 4 * 4
            (flags,) = struct.unpack_from("<B", self._mm, doff)
            if flags in (1, 2):
                doff += 1
                rec.obj_id = np.frombuffer(self._mm, "<i4", count=n,
                                           offset=doff)
                rec.obj_conf = np.frombuffer(self._mm, "<f4", count=n,
                                             offset=doff + 4 * n)
            if flags == 1:          # attr head present (R101-C4 records)
                rec.attr_id = np.frombuffer(self._mm, "<i4", count=n,
                                            offset=doff + 8 * n)
                rec.attr_conf = np.frombuffer(self._mm, "<f4", count=n,
                                              offset=doff + 12 * n)
        return rec

    def get(self, image_id) -> RegionRecord:
        return self.get_by_index(self.id2idx[str(image_id)])

    def close(self):
        if self._native is not None:
            from ..native import cfs_native
            cfs_native.close_handle(self._native)
            self._native = None
        self._mm.close()
        self._file.close()

    def gather(self, indices, *, max_regions: int, num_locs: int = 5,
               norm_embeddings: bool = False,
               add_global_imgfeat: str | None = None, native: bool = True):
        """Assemble a fixed-shape batch: returns
        (features [B, R', D], locs [B, R', num_locs], mask [B, R'])
        where R' = max_regions (+1 with a global feature).

        native=True (the default, as clg_vqa_tpu/data/cfs.py:162-185) runs
        the C++ gather, built on first use; a failed build raises rather
        than falling back. native=False is the Python path. Both give the
        same bits."""
        indices = np.asarray(indices, np.int64)
        if not native:
            return gather_records(self.get_by_index, indices,
                                  max_regions=max_regions, num_locs=num_locs,
                                  norm_embeddings=norm_embeddings,
                                  add_global_imgfeat=add_global_imgfeat)
        from ..native import cfs_native
        if self._native is None:
            with self._native_lock:     # prefetch threads race the first open
                if self._native is None:
                    self._native = cfs_native.open_handle(self.path)
        return cfs_native.gather(self._native, self, indices,
                                 max_regions=max_regions, num_locs=num_locs,
                                 norm_embeddings=norm_embeddings,
                                 add_global_imgfeat=add_global_imgfeat)
