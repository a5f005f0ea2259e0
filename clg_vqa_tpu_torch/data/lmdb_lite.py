"""Minimal pure-Python LMDB file codec, reader and bulk writer (own copy of
clg_vqa_tpu/data/lmdb_lite.py; the two write the same bytes for the same
items).

The reference's primary data artifacts are LMDB files (tensorpack
``LMDBSerializer`` QA-joined train stores, per-image feature LMDBs written by
features_extraction/h5_to_lmdb.py). This environment ships neither py-lmdb
nor liblmdb, so this module implements the on-disk LMDB data format
(http://www.lmdb.tech/doc; format fixed since liblmdb 0.9) directly:

 - ``Reader``: zero-copy mmap reader — meta-page selection by txnid, B-tree
   descent with binary search, overflow-page (big value) support, sorted
   full iteration. Read-only; ignores the freelist DB.
 - ``write_lmdb``: bottom-up bulk B-tree builder producing files readable by
   real liblmdb: meta pages 0/1, leaf/branch pages with the standard node
   layout, F_BIGDATA overflow chunks for values over the node-size limit
   (same ``(psize-16)/2`` threshold as mdb.c's me_nodemax).
 - ``open``: py-lmdb-compatible environment shim (begin/get/cursor/put) that
   the feature readers and store converters use when the real ``lmdb``
   package is absent.

Scope: single main DB, no dupsort/integerkey, write = bulk rebuild (the
framework's converters always write whole stores; there is no incremental
transaction log). Little-endian 64-bit layout, the only one the reference
data was ever produced on.
"""
from __future__ import annotations

import builtins
import mmap
import os
import struct

PSIZE = 4096
PAGEHDRSZ = 16
P_INVALID = 0xFFFFFFFFFFFFFFFF
MDB_MAGIC = 0xBEEFC0DE
MDB_VERSION = 1

# page flags
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

# node flags
F_BIGDATA = 0x01

NODESIZE = 8
_META_FMT = struct.Struct("<II Q Q")          # magic, version, address, mapsize
_DB_FMT = struct.Struct("<IHH QQQQQ")         # pad, flags, depth, branch, leaf, ovf, entries, root
_PGHDR_FMT = struct.Struct("<QHHHH")          # pgno, pad, flags, lower, upper
_NODE_FMT = struct.Struct("<HHHH")            # lo, hi, flags, ksize


def _data_path(path: str) -> str:
    return os.path.join(path, "data.mdb") if os.path.isdir(path) else path


def _node_max(psize: int) -> int:
    # mdb.c me_nodemax: largest node that stays inline in a leaf page
    return ((psize - PAGEHDRSZ) // 2) & ~1


def _even(n: int) -> int:
    return (n + 1) & ~1


class Reader:
    """Read-only view of an LMDB file's main DB."""

    def __init__(self, path: str):
        self.path = _data_path(path)
        self._f = builtins.open(self.path, "rb")   # module defines open()
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        m = self._mm
        metas = []
        for pg in (0, 1):
            off = pg * PSIZE + PAGEHDRSZ
            magic, version, _addr, _mapsize = _META_FMT.unpack_from(m, off)
            if magic != MDB_MAGIC:
                raise ValueError(f"{path}: not an LMDB file (bad magic)")
            if version != MDB_VERSION:
                raise ValueError(f"{path}: unsupported LMDB version {version}")
            main_off = off + _META_FMT.size + _DB_FMT.size   # skip FREE_DBI
            free = _DB_FMT.unpack_from(m, off + _META_FMT.size)
            main = _DB_FMT.unpack_from(m, main_off)
            last_pg, txnid = struct.unpack_from(
                "<QQ", m, main_off + _DB_FMT.size)
            metas.append((txnid, free[0] or PSIZE, main, last_pg))
        # live meta = larger txnid (mdb_env_pick_meta)
        txnid, psize, main, _ = max(metas, key=lambda t: t[0])
        self.psize = psize
        (_, _, self.depth, _, _, _, self.n_entries, self.root) = main

    # -- internals ----------------------------------------------------------

    def _page(self, pgno: int):
        off = pgno * self.psize
        _pg, _pad, flags, lower, upper = _PGHDR_FMT.unpack_from(self._mm, off)
        return off, flags, lower, upper

    def _nkeys(self, lower: int) -> int:
        return (lower - PAGEHDRSZ) >> 1

    def _node(self, page_off: int, i: int):
        ptr = struct.unpack_from("<H", self._mm,
                                 page_off + PAGEHDRSZ + 2 * i)[0]
        noff = page_off + ptr
        lo, hi, flags, ksize = _NODE_FMT.unpack_from(self._mm, noff)
        key = self._mm[noff + NODESIZE:noff + NODESIZE + ksize]
        return lo, hi, flags, key, noff + NODESIZE + ksize

    def _leaf_value(self, lo, hi, flags, data_off) -> bytes:
        dsize = lo | (hi << 16)
        if flags & F_BIGDATA:
            ovf_pgno = struct.unpack_from("<Q", self._mm, data_off)[0]
            start = ovf_pgno * self.psize + PAGEHDRSZ
            return bytes(self._mm[start:start + dsize])
        return bytes(self._mm[data_off:data_off + dsize])

    def _descend(self, key: bytes) -> tuple[int, int, bool]:
        """-> (leaf page offset, node index, exact-match?)."""
        pgno = self.root
        while True:
            off, flags, lower, _upper = self._page(pgno)
            n = self._nkeys(lower)
            if flags & P_LEAF:
                lo_i, hi_i = 0, n - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) >> 1
                    _, _, _, k, _ = self._node(off, mid)
                    if k == key:
                        return off, mid, True
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return off, lo_i, False
            # branch: last child whose separator <= key (node 0 = -inf)
            lo_i, hi_i, best = 1, n - 1, 0
            while lo_i <= hi_i:
                mid = (lo_i + hi_i) >> 1
                _, _, _, k, _ = self._node(off, mid)
                if k <= key:
                    best = mid
                    lo_i = mid + 1
                else:
                    hi_i = mid - 1
            nlo, nhi, nflags, _, _ = self._node(off, best)
            pgno = nlo | (nhi << 16) | (nflags << 32)

    # -- public -------------------------------------------------------------

    def __len__(self) -> int:
        return self.n_entries

    def get(self, key: bytes, default=None):
        if isinstance(key, str):
            key = key.encode()
        if self.root == P_INVALID:
            return default
        off, i, exact = self._descend(key)
        if not exact:
            return default
        lo, hi, flags, _, doff = self._node(off, i)
        return self._leaf_value(lo, hi, flags, doff)

    def items(self):
        """All (key, value) in sorted key order (left-to-right leaf walk)."""
        if self.root == P_INVALID:
            return
        stack = [(self.root, 0)]
        while stack:
            pgno, i = stack.pop()
            off, flags, lower, _ = self._page(pgno)
            n = self._nkeys(lower)
            if flags & P_LEAF:
                for j in range(n):
                    lo, hi, nf, key, doff = self._node(off, j)
                    yield bytes(key), self._leaf_value(lo, hi, nf, doff)
            else:
                if i + 1 < n:
                    stack.append((pgno, i + 1))
                nlo, nhi, nf, _, _ = self._node(off, i)
                stack.append((nlo | (nhi << 16) | (nf << 32), 0))

    def keys(self):
        for k, _ in self.items():
            yield k

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Bulk writer
# ---------------------------------------------------------------------------

class _PageBuf:
    def __init__(self, psize: int, flags: int):
        self.psize = psize
        self.flags = flags
        self.ptrs: list[int] = []
        self.nodes = bytearray()
        self.upper = psize

    def room_for(self, node_sz: int) -> bool:
        lower = PAGEHDRSZ + 2 * (len(self.ptrs) + 1)
        return self.upper - node_sz >= lower

    def add(self, node: bytes):
        sz = _even(len(node))
        self.upper -= sz
        self.ptrs.append(self.upper)
        self.nodes += node + b"\0" * (sz - len(node))

    def render(self, pgno: int) -> bytes:
        out = bytearray(self.psize)
        lower = PAGEHDRSZ + 2 * len(self.ptrs)
        _PGHDR_FMT.pack_into(out, 0, pgno, 0, self.flags, lower, self.upper)
        struct.pack_into(f"<{len(self.ptrs)}H", out, PAGEHDRSZ, *self.ptrs)
        # nodes were appended top-down; lay them back at their offsets
        off = self.psize
        pos = 0
        for ptr in self.ptrs:
            sz = off - ptr
            out[ptr:ptr + sz] = self.nodes[pos:pos + sz]
            pos += sz
            off = ptr
        return bytes(out)


def write_lmdb(path: str, items, *, psize: int = PSIZE,
               map_size: int | None = None) -> int:
    """Write ``items`` (iterable of (key, value) bytes pairs) as a valid LMDB
    data file. Keys are sorted internally (LMDB stores memcmp order)."""
    pairs = sorted((bytes(k), bytes(v)) for k, v in items)
    node_max = _node_max(psize)

    pages: dict[int, bytes] = {}
    next_pg = 2         # 0, 1 are the meta pages
    n_leaf = n_branch = n_ovf = 0

    def alloc(n=1):
        nonlocal next_pg
        pg = next_pg
        next_pg += n
        return pg

    # ---- leaves (and their overflow chunks) ----
    leaf_first_key: list[bytes] = []
    leaf_pgnos: list[int] = []
    cur: _PageBuf | None = None
    cur_keys: list[bytes] = []
    done_leaves: list[tuple[_PageBuf, bytes]] = []

    def flush_leaf():
        nonlocal cur, n_leaf
        if cur is not None and cur_keys:
            pg = alloc()
            leaf_pgnos.append(pg)
            leaf_first_key.append(cur_keys[0])
            pages[pg] = cur.render(pg)
            n_leaf += 1
        cur = None
        cur_keys.clear()

    for key, val in pairs:
        if len(key) == 0 or len(key) > 511:
            raise ValueError(f"invalid LMDB key length {len(key)}")
        inline_sz = NODESIZE + len(key) + len(val)
        big = inline_sz > node_max
        if big:
            node_sz = NODESIZE + len(key) + 8
        else:
            node_sz = inline_sz
        if cur is None or not cur.room_for(_even(node_sz)):
            flush_leaf()
            cur = _PageBuf(psize, P_LEAF)
        if big:
            n_pages = (PAGEHDRSZ + len(val) + psize - 1) // psize
            ovf_pg = alloc(n_pages)
            chunk = bytearray(n_pages * psize)
            # overflow header: pgno, pad, P_OVERFLOW, pb_pages(u32)
            struct.pack_into("<QHHI", chunk, 0, ovf_pg, 0, P_OVERFLOW, n_pages)
            chunk[PAGEHDRSZ:PAGEHDRSZ + len(val)] = val
            pages[ovf_pg] = bytes(chunk)
            n_ovf += n_pages
            node = _NODE_FMT.pack(len(val) & 0xFFFF, len(val) >> 16,
                                  F_BIGDATA, len(key)) + key + \
                struct.pack("<Q", ovf_pg)
        else:
            node = _NODE_FMT.pack(len(val) & 0xFFFF, len(val) >> 16,
                                  0, len(key)) + key + val
        cur.add(node)
        cur_keys.append(key)
    flush_leaf()

    # ---- branch levels ----
    depth = 1
    level_pgnos, level_keys = leaf_pgnos, leaf_first_key
    while len(level_pgnos) > 1:
        depth += 1
        up_pgnos: list[int] = []
        up_keys: list[bytes] = []
        buf: _PageBuf | None = None
        buf_keys: list[bytes] = []

        def flush_branch():
            nonlocal buf, n_branch
            if buf is not None and buf_keys:
                pg = alloc()
                up_pgnos.append(pg)
                up_keys.append(buf_keys[0])
                pages[pg] = buf.render(pg)
                n_branch += 1
            buf = None
            buf_keys.clear()

        for i, (child, ckey) in enumerate(zip(level_pgnos, level_keys)):
            first_in_page = buf is None
            key = b"" if first_in_page else ckey
            node_sz = _even(NODESIZE + len(key))
            if buf is not None and not buf.room_for(node_sz):
                flush_branch()
                key = b""                       # leftmost node: implicit -inf
                node_sz = _even(NODESIZE)
            if buf is None:
                buf = _PageBuf(psize, P_BRANCH)
            node = _NODE_FMT.pack(child & 0xFFFF, (child >> 16) & 0xFFFF,
                                  (child >> 32) & 0xFFFF, len(key)) + key
            buf.add(node)
            buf_keys.append(ckey)
        flush_branch()
        level_pgnos, level_keys = up_pgnos, up_keys

    root = level_pgnos[0] if level_pgnos else P_INVALID
    if root == P_INVALID:
        depth = 0

    total_pages = next_pg
    file_size = total_pages * psize
    if map_size is None:
        map_size = max(file_size, 1 << 20)

    def meta_page(pgno: int) -> bytes:
        out = bytearray(psize)
        _PGHDR_FMT.pack_into(out, 0, pgno, 0, P_META, 0, 0)
        off = PAGEHDRSZ
        _META_FMT.pack_into(out, off, MDB_MAGIC, MDB_VERSION, 0, map_size)
        off += _META_FMT.size
        # FREE_DBI: md_pad holds the page size; empty freelist
        _DB_FMT.pack_into(out, off, psize, 0x08, 0, 0, 0, 0, 0, P_INVALID)
        off += _DB_FMT.size
        _DB_FMT.pack_into(out, off, 0, 0, depth, n_branch, n_leaf, n_ovf,
                          len(pairs), root)
        off += _DB_FMT.size
        struct.pack_into("<QQ", out, off, total_pages - 1, 1)  # last_pg, txnid
        return bytes(out)

    out_path = _data_path(path) if os.path.isdir(path) else path
    with builtins.open(out_path, "wb") as f:
        f.write(meta_page(0))
        f.write(meta_page(1))
        pg = 2
        while pg < total_pages:
            blob = pages[pg]          # overflow chunks span multiple pgnos
            f.write(blob)
            pg += len(blob) // psize
    return len(pairs)


# ---------------------------------------------------------------------------
# py-lmdb compatible shim (the subset the data layer uses)
# ---------------------------------------------------------------------------

class _ReadTxn:
    def __init__(self, reader: Reader):
        self._r = reader

    def get(self, key, default=None):
        return self._r.get(key, default)

    def cursor(self):
        return iter(self._r.items())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _WriteTxn:
    def __init__(self, env: "Environment"):
        self._env = env
        self._puts: dict[bytes, bytes] = {}

    def get(self, key, default=None):
        """Read-through: pending puts shadow the committed store, but a
        key absent from the pending set must still resolve against disk —
        py-lmdb write transactions see the committed state."""
        key = key.encode() if isinstance(key, str) else bytes(key)
        if key in self._puts:
            return self._puts[key]
        p = _data_path(self._env.path)
        if os.path.exists(p) and os.path.getsize(p) >= 2 * PSIZE:
            with Reader(self._env.path) as r:
                return r.get(key, default)
        return default

    def put(self, key, value):
        key = key.encode() if isinstance(key, str) else bytes(key)
        self._puts[bytes(key)] = bytes(value)
        return True

    def commit(self):
        merged = {}
        if os.path.exists(_data_path(self._env.path)) and \
                os.path.getsize(_data_path(self._env.path)) >= 2 * PSIZE:
            with Reader(self._env.path) as r:
                merged.update(dict(r.items()))
        merged.update(self._puts)
        write_lmdb(self._env.path, merged.items(),
                   map_size=self._env.map_size)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.commit()
        return False


class Environment:
    def __init__(self, path: str, map_size: int | None = None,
                 readonly: bool = False):
        self.path = path
        self.map_size = map_size
        self.readonly = readonly

    def begin(self, write: bool = False, **_kw):
        if write:
            if self.readonly:
                raise PermissionError("read-only environment")
            return _WriteTxn(self)
        return _ReadTxn(Reader(self.path))

    def close(self):
        pass


def open(path: str, *, readonly: bool = False, map_size: int | None = None,
         subdir: bool = True, **_ignored) -> Environment:
    """py-lmdb style opener (same subdir=True default): with subdir, the data
    file is ``<path>/data.mdb``; otherwise ``path`` is the data file."""
    if subdir and os.path.isfile(path):
        subdir = False              # tolerate an existing single-file store
    if subdir and not os.path.isdir(path) and not readonly:
        os.makedirs(path, exist_ok=True)
    return Environment(path, map_size=map_size, readonly=readonly)


def open_compat(path: str, **kw):
    """Prefer the real py-lmdb when installed; fall back to this codec."""
    try:
        import lmdb as _real
        return _real.open(path, **{k: v for k, v in kw.items()
                                   if k in ("readonly", "map_size", "lock",
                                            "max_readers", "readahead",
                                            "meminit", "subdir")})
    except ImportError:
        return open(path, readonly=kw.get("readonly", False),
                    map_size=kw.get("map_size"),
                    subdir=kw.get("subdir", True))
