"""ctypes binding and build of the native CFS gather (own copy of
clg_vqa_tpu/native/cfs_native.py over this package's cfs_gather.cpp).

The library is compiled with ``g++`` from ``native/cfs_gather.cpp`` into
``build/native/libcfs_gather-<hash>.so`` at the root of the checkout on
first use; the hash covers the source and the flags, so an edited source is
rebuilt and nothing stale is loaded. A failed build or load raises (the JAX
package warns and falls back to Python); ``CfsReader.gather(native=False)``
is the explicit Python path. Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "cfs_gather.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
         "-ffp-contract=off")
NUM_THREADS = min(16, os.cpu_count() or 4)
_lock = threading.Lock()
_lib = None


def so_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"libcfs_gather-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; raises with the compiler's
    output when g++ fails or is missing."""
    out = so_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"native CFS gather: g++ not found ({e})") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native CFS gather: g++ failed:\n{proc.stderr}")
    os.replace(tmp, out)        # atomic: a concurrent loader sees all or nothing
    return out


def load() -> ctypes.CDLL:
    """The library, built and loaded on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.cfsg_open.restype = ctypes.c_void_p
            lib.cfsg_open.argtypes = [ctypes.c_char_p]
            lib.cfsg_close.argtypes = [ctypes.c_void_p]
            lib.cfsg_gather.restype = ctypes.c_int
            lib.cfsg_gather.argtypes = [
                ctypes.c_void_p,                      # handle
                ctypes.POINTER(ctypes.c_int64),       # offsets
                ctypes.POINTER(ctypes.c_int64),       # indices
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
            ]
            _lib = lib
    return _lib


def open_handle(path: str) -> int:
    """The library's own mmap of the CFS file at ``path``."""
    h = load().cfsg_open(path.encode())
    if not h:
        raise OSError(f"cfsg_open failed: {path}")
    return h


def close_handle(h: int) -> None:
    load().cfsg_close(ctypes.c_void_p(h))


def gather(handle: int, reader, indices: np.ndarray, *, max_regions: int,
           num_locs: int, norm_embeddings: bool,
           add_global_imgfeat: str | None):
    """Parallel native batch assembly over the file ``handle`` maps:
    (features [B, R', D], locs [B, R', num_locs], mask [B, R']), bit-equal
    to data/features.gather_records on ``reader``."""
    lib = load()
    B = len(indices)
    if B and (np.min(indices) < 0 or np.max(indices) >= reader.n_records):
        raise IndexError(f"store indices outside [0, {reader.n_records})")
    Rp = max_regions + int(add_global_imgfeat is not None)
    fd = reader.get_by_index(int(indices[0])).features.shape[1]
    feats = np.zeros((B, Rp, fd), np.float32)
    locs = np.zeros((B, Rp, num_locs), np.float32)
    mask = np.zeros((B, Rp), np.int32)
    offsets = np.ascontiguousarray(reader.offsets, np.int64)
    idx = np.ascontiguousarray(indices, np.int64)
    ag = {None: 0, "first": 1, "last": 2}[add_global_imgfeat]
    ret = lib.cfsg_gather(
        ctypes.c_void_p(handle),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        B, Rp, num_locs, fd, int(norm_embeddings), ag, NUM_THREADS,
        feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        locs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if ret == -2:
        raise ValueError(
            "cfsg_gather: record(s) with a feature dim different from "
            f"{fd} in the requested batch (mixed/corrupt store) — the "
            "python path raises a shape error on the same input")
    if ret != 0:
        raise RuntimeError(f"cfsg_gather returned {ret}")
    return feats, locs, mask
