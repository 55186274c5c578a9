"""Zero-dependency LMDB access for the reference's released NLQ features
(a copy of vilco_tpu/data/lmdb_io.py, which imports nothing of JAX).

The reference stores its NLQ features in LMDB environments
(NLQ/libs/datasets/ego4d_loader.py:94-105 opens them; :225-246 reads
per-qid / per-vid npz payloads). The `lmdb` python binding is not part of
this environment, so this module implements the on-disk format directly:

  - :class:`LmdbReader` — read-only parser of an LMDB data file (memory
    mapped, main DB only, no dupsort): meta page selection by txnid,
    B+tree walk, inline + overflow (BIGDATA) values. This is all the
    reference reader does via `txn.get(key)`.
  - :func:`write_lmdb` — a minimal writer producing a valid single-root
    environment (sorted keys, overflow pages for large values). Used to
    build synthetic fixtures for round-trip tests and to pack features
    back into the reference's format.

Format reference: LMDB file format v1 (mdb.c): 4 KiB+ pages, meta pages 0/1,
page header {pgno u64, pad u16, flags u16, lower u16, upper u16 | pages u32},
nodes {lo u16, hi u16, flags u16, ksize u16, data[]}; the page size lives in
FREE_DBI's md_pad field.
"""

from __future__ import annotations

import io
import mmap
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# page flags
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20
# leaf-node flags
F_BIGDATA = 0x01

MAGIC = 0xBEEFC0DE
DATA_VERSION = 1
P_INVALID = 0xFFFFFFFFFFFFFFFF
PAGEHDRSZ = 16

_META = struct.Struct("<II8xQ")          # magic, version, (address), mapsize
_DB = struct.Struct("<IHHQQQQQ")         # pad, flags, depth, branch, leaf,
                                         # overflow, entries, root
_NODE = struct.Struct("<HHHH")


def _data_path(path: str) -> str:
    return os.path.join(path, "data.mdb") if os.path.isdir(path) else path


class LmdbReader:
    """Read-only LMDB environment (main database).

    >>> with LmdbReader(env_dir) as db:
    ...     buf = db.get(b"some-key")
    ...     for k, v in db.items(): ...
    """

    def __init__(self, path: str):
        self.path = _data_path(path)
        self._f = open(self.path, "rb")
        try:
            self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:
            raise ValueError(f"{self.path}: empty or unmappable lmdb file")
        self._load_meta()
        self._index: Optional[Dict[bytes, Tuple[int, int]]] = None

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- meta --------------------------------------------------------------
    def _read_db(self, off: int):
        (pad, flags, depth, branch, leaf, overflow, entries,
         root) = _DB.unpack_from(self._mm, off)
        return dict(pad=pad, flags=flags, depth=depth, entries=entries,
                    root=root)

    def _load_meta(self):
        best = None
        # try page sizes: meta page 1 sits one page after page 0
        for psize in (4096, 8192, 16384, 32768, 65536):
            metas = []
            for pg in (0, psize):
                if pg + 136 + PAGEHDRSZ > len(self._mm):
                    continue
                base = pg + PAGEHDRSZ
                magic, version, mapsize = _META.unpack_from(self._mm, base)
                if magic != MAGIC or version != DATA_VERSION:
                    continue
                free_db = self._read_db(base + 24)
                main_db = self._read_db(base + 24 + 48)
                txnid = struct.unpack_from("<Q", self._mm, base + 128)[0]
                if free_db["pad"] != psize:     # psize lives in FREE_DBI pad
                    continue
                metas.append((txnid, main_db))
            if metas:
                best = (psize, max(metas, key=lambda m: m[0])[1])
                break
        if best is None:
            raise ValueError(f"{self.path}: no valid lmdb meta page found")
        self.psize, self._main = best

    @property
    def n_entries(self) -> int:
        return self._main["entries"]

    def __len__(self) -> int:
        return self.n_entries

    # -- pages -------------------------------------------------------------
    def _page(self, pgno: int) -> int:
        off = pgno * self.psize
        if off + PAGEHDRSZ > len(self._mm):
            raise ValueError(f"{self.path}: page {pgno} out of range")
        return off

    def _page_flags(self, off: int) -> int:
        return struct.unpack_from("<H", self._mm, off + 10)[0]

    def _numkeys(self, off: int) -> int:
        lower = struct.unpack_from("<H", self._mm, off + 12)[0]
        return (lower - PAGEHDRSZ) >> 1

    def _node(self, off: int, i: int) -> int:
        ptr = struct.unpack_from("<H", self._mm, off + PAGEHDRSZ + 2 * i)[0]
        return off + ptr

    def _leaf_value(self, noff: int) -> Tuple[bytes, int, int, int]:
        """-> (key, value_offset, value_size, node_flags); BIGDATA values
        resolve through their overflow chain."""
        lo, hi, flags, ksize = _NODE.unpack_from(self._mm, noff)
        dsize = lo | (hi << 16)
        key = bytes(self._mm[noff + 8: noff + 8 + ksize])
        if flags & F_BIGDATA:
            ovf = struct.unpack_from("<Q", self._mm, noff + 8 + ksize)[0]
            ooff = self._page(ovf)
            if not self._page_flags(ooff) & P_OVERFLOW:
                raise ValueError(f"{self.path}: bad overflow page {ovf}")
            return key, ooff + PAGEHDRSZ, dsize, flags
        return key, noff + 8 + ksize, dsize, flags

    def _branch_child(self, noff: int) -> int:
        lo, hi, flags, _ = _NODE.unpack_from(self._mm, noff)
        return lo | (hi << 16) | (flags << 32)

    # -- iteration / lookup -------------------------------------------------
    def _walk(self, pgno: int) -> Iterator[Tuple[bytes, int, int]]:
        off = self._page(pgno)
        flags = self._page_flags(off)
        n = self._numkeys(off)
        if flags & P_LEAF:
            for i in range(n):
                key, voff, vsize, _ = self._leaf_value(self._node(off, i))
                yield key, voff, vsize
        elif flags & P_BRANCH:
            for i in range(n):
                yield from self._walk(self._branch_child(self._node(off, i)))
        elif flags & P_LEAF2:
            raise NotImplementedError("LEAF2 (fixed-size dupsort) pages")
        else:
            raise ValueError(f"{self.path}: unexpected page flags {flags:#x}")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        if self._main["root"] == P_INVALID:
            return
        for key, voff, vsize in self._walk(self._main["root"]):
            yield key, bytes(self._mm[voff: voff + vsize])

    def keys(self) -> List[bytes]:
        if self._main["root"] == P_INVALID:
            return []
        return [k for k, _, _ in self._walk(self._main["root"])]

    def _build_index(self):
        # build into a local, publish atomically: concurrent get() calls
        # from loader worker threads must never see a partial index
        index: Dict[bytes, Tuple[int, int]] = {}
        if self._main["root"] != P_INVALID:
            for key, voff, vsize in self._walk(self._main["root"]):
                index[key] = (voff, vsize)
        self._index = index

    def get(self, key: bytes) -> Optional[bytes]:
        if isinstance(key, str):
            key = key.encode()
        if self._index is None:
            self._build_index()
        hit = self._index.get(key)
        if hit is None:
            return None
        voff, vsize = hit
        return bytes(self._mm[voff: voff + vsize])


def read_npz_value(buf: bytes) -> Dict[str, np.ndarray]:
    """Decode one lmdb value: the reference stores npz bytes per key
    (ego4d_loader.py:225-246)."""
    with io.BytesIO(buf) as reader:
        data = np.load(reader, allow_pickle=True)
        return {k: data[k] for k in data.files}


# ----------------------------------------------------------------- writer

def _npz_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def write_lmdb(path: str, entries: Dict[bytes, bytes],
               psize: int = 4096, subdir: bool = True) -> str:
    """Write a minimal valid LMDB environment containing `entries` in the
    main DB. Values larger than an in-page node go to overflow pages, as
    lmdb itself does. Returns the data-file path."""
    if subdir:
        os.makedirs(path, exist_ok=True)
        data_file = os.path.join(path, "data.mdb")
    else:
        data_file = path

    items = sorted((bytes(k) if not isinstance(k, str) else k.encode(), v)
                   for k, v in entries.items())
    max_inline = (psize - 32) // 2      # lmdb's max in-page node data
    pages: Dict[int, bytes] = {}
    next_pg = 2
    n_overflow = 0

    # lay out values, assigning overflow pages first
    nodes = []      # (key, inline_value | None, overflow_pgno, dsize)
    for key, val in items:
        node_sz = 8 + len(key) + len(val)
        if node_sz <= max_inline:
            nodes.append((key, val, None, len(val)))
        else:
            npages = (PAGEHDRSZ + len(val) + psize - 1) // psize
            pg = next_pg
            blob = bytearray(npages * psize)
            struct.pack_into("<QHHI", blob, 0, pg, 0, P_OVERFLOW, npages)
            blob[PAGEHDRSZ: PAGEHDRSZ + len(val)] = val
            for i in range(npages):
                pages[pg + i] = bytes(blob[i * psize: (i + 1) * psize])
            next_pg += npages
            n_overflow += npages
            nodes.append((key, None, pg, len(val)))

    def build_page(pgno: int, flags: int,
                   node_blobs: List[bytes]) -> bytes:
        page = bytearray(psize)
        lower = PAGEHDRSZ + 2 * len(node_blobs)
        upper = psize
        for i, nb in enumerate(node_blobs):
            upper -= len(nb)
            struct.pack_into("<H", page, PAGEHDRSZ + 2 * i, upper)
            page[upper: upper + len(nb)] = nb
        assert lower <= upper, "write_lmdb: page overflow"
        struct.pack_into("<QHHHH", page, 0, pgno, 0, flags, lower, upper)
        return bytes(page)

    def leaf_node(key: bytes, val, ovf_pg, dsize) -> bytes:
        if val is not None:
            return _NODE.pack(dsize & 0xFFFF, dsize >> 16, 0,
                              len(key)) + key + val
        return (_NODE.pack(dsize & 0xFFFF, dsize >> 16, F_BIGDATA, len(key))
                + key + struct.pack("<Q", ovf_pg))

    def pack_level(node_stream, flags):
        """Greedy-pack (first_key, node_bytes) pairs into pages; returns
        [(pgno, first_key)] of the packed pages. Shared by the leaf level
        and every branch level."""
        nonlocal next_pg
        packed: List[Tuple[int, bytes]] = []
        cur: List[bytes] = []
        cur_first: Optional[bytes] = None
        cur_size = PAGEHDRSZ

        def flush():
            nonlocal cur, cur_first, cur_size, next_pg
            if cur:
                pg = next_pg
                next_pg += 1
                pages[pg] = build_page(pg, flags, cur)
                packed.append((pg, cur_first))
                cur, cur_first, cur_size = [], None, PAGEHDRSZ

        for first, nb in node_stream:
            if cur and cur_size + 2 + len(nb) > psize:
                flush()
            if cur_first is None:
                cur_first = first
            cur.append(nb)
            cur_size += 2 + len(nb)
        flush()
        return packed

    def branch_node(pg: int, key: bytes) -> bytes:
        return _NODE.pack(pg & 0xFFFF, (pg >> 16) & 0xFFFF,
                          (pg >> 32) & 0xFFFF, len(key)) + key

    leaf_pages = pack_level(
        ((key, leaf_node(key, val, ovf_pg, dsize))
         for key, val, ovf_pg, dsize in nodes), P_LEAF)

    n_branch = 0
    if not leaf_pages:
        root, depth = P_INVALID, 0
    else:
        # build branch levels bottom-up until one page holds everything
        # (real NLQ text envs with 100k+ queries are depth >= 3).
        # Page-local node 0 carries no key, so the branch node bytes are
        # position-dependent: emit keyed nodes and let build_page receive
        # them as-is — pack_level starts each page at node 0, whose key we
        # strip by re-emitting (the keyed form only wastes the few bytes
        # of its key, which lmdb's own reader ignores for node 0).
        level = leaf_pages
        depth = 1
        while len(level) > 1:
            new_level = pack_level(
                ((first, branch_node(pg, first)) for pg, first in level),
                P_BRANCH)
            n_branch += len(new_level)
            level = new_level
            depth += 1
        root = level[0][0]

    # metas: both written, page 0 carries the live txn
    last_pg = max(pages) if pages else 1
    total = (last_pg + 1) * psize
    blob = bytearray(total)
    for pg, data in pages.items():
        blob[pg * psize: pg * psize + len(data)] = data

    def meta(pgno: int, txnid: int) -> bytes:
        m = bytearray(psize)
        struct.pack_into("<QHHHH", m, 0, pgno, 0, P_META, PAGEHDRSZ, psize)
        base = PAGEHDRSZ
        struct.pack_into("<II", m, base, MAGIC, DATA_VERSION)
        struct.pack_into("<Q", m, base + 16, total)           # mapsize
        # FREE_DBI: psize in md_pad, empty tree
        struct.pack_into("<IHH", m, base + 24, psize, 0, 0)
        struct.pack_into("<Q", m, base + 24 + 40, P_INVALID)
        # MAIN_DBI
        struct.pack_into(
            "<IHHQQQQQ", m, base + 72, 0, 0, depth, n_branch,
            len(leaf_pages), n_overflow, len(items),
            root if root != P_INVALID else P_INVALID)
        struct.pack_into("<QQ", m, base + 120, last_pg, txnid)
        return bytes(m)

    blob[0:psize] = meta(0, 1)
    blob[psize: 2 * psize] = meta(1, 0)
    with open(data_file, "wb") as f:
        f.write(blob)
    return data_file


def write_feature_lmdb(path: str, features: Dict[str, Dict[str, np.ndarray]],
                       **kw) -> str:
    """Pack {key: {array_name: array}} as npz payloads — the reference's
    NLQ feature layout (video: {'features': (Lv, D)}; text:
    {'token_features': (Lq, D), 'features': (D,)})."""
    return write_lmdb(
        path, {k.encode(): _npz_bytes(v) for k, v in features.items()}, **kw)
