"""Native log-structured engine adapter — the `native` / `logdb` engine.

Binds garage_tpu_torch/native/logdb.cpp over ctypes.  Fills the role of
the reference's LMDB default engine (ref db/lmdb_adapter.rs:1-354): a
fast native ordered KV store behind the Db/Tree/Transaction facade.
logdb is a bitcask-style design — append-only CRC'd log with commit
records, in-RAM ordered key index, values pread on demand.  See
logdb.cpp.  Its on-disk format is the JAX package's: a file written by
either package opens in the other.

The library is built by the port's one native recipe, ``ops/native.py``
(the host C++ compiler, into ``build/native/`` at the root of the
checkout, at first use).  ``GARAGE_NATIVE_SUFFIX=.asan`` or ``.tsan``
selects its sanitizer build, as for every native library of the port.
A library that cannot be built or loaded raises DbError: no other
engine, and no plain build of a sanitizer variant, is opened in its
place.

Every call into the library holds the adapter lock and first checks
that the engine is still open: a call after `close` (a crashed node's
straggling worker, say) raises DbError where an unchecked call would
hand the library a freed or NULL handle and take the process down.

Transactions use a Python-side overlay (reads see uncommitted writes,
ordered iteration merges the overlay) applied atomically through one
`ldb_apply` batch — a single commit record, so a crash never exposes a
partial transaction.  Serializability comes from the adapter lock held
for the closure, the same contract as the other engines.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from ..utils.error import DbError
from . import IDb, Transaction, TxAbort

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    from ..ops.native import require_native

    try:
        lib = require_native("logdb")
    except RuntimeError as e:
        raise DbError(f"native logdb unavailable: {e}") from e
    c = ctypes
    lib.ldb_open.restype = c.c_void_p
    lib.ldb_open.argtypes = [c.c_char_p, c.c_int]
    lib.ldb_open_tree.restype = c.c_int
    lib.ldb_open_tree.argtypes = [c.c_void_p, c.c_char_p, c.c_uint32]
    lib.ldb_tree_count.restype = c.c_int
    lib.ldb_tree_count.argtypes = [c.c_void_p]
    lib.ldb_tree_name.restype = c.c_int
    lib.ldb_tree_name.argtypes = [c.c_void_p, c.c_int, c.c_char_p, c.c_uint32]
    lib.ldb_get.restype = c.c_long
    lib.ldb_get.argtypes = [c.c_void_p, c.c_int, c.c_char_p, c.c_uint32,
                            c.c_void_p, c.c_uint32]
    lib.ldb_len.restype = c.c_long
    lib.ldb_len.argtypes = [c.c_void_p, c.c_int]
    lib.ldb_apply.restype = c.c_int
    lib.ldb_apply.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64]
    lib.ldb_iter_new.restype = c.c_void_p
    lib.ldb_iter_new.argtypes = [c.c_void_p, c.c_int, c.c_char_p, c.c_uint32,
                                 c.c_int, c.c_char_p, c.c_uint32, c.c_int,
                                 c.c_int]
    lib.ldb_iter_next.restype = c.c_int
    lib.ldb_iter_next.argtypes = [
        c.c_void_p, c.POINTER(c.POINTER(c.c_uint8)), c.POINTER(c.c_uint32),
        c.POINTER(c.POINTER(c.c_uint8)), c.POINTER(c.c_uint32),
    ]
    lib.ldb_iter_free.argtypes = [c.c_void_p]
    lib.ldb_sync.restype = c.c_int
    lib.ldb_sync.argtypes = [c.c_void_p]
    lib.ldb_compact.restype = c.c_int
    lib.ldb_compact.argtypes = [c.c_void_p]
    lib.ldb_snapshot.restype = c.c_int
    lib.ldb_snapshot.argtypes = [c.c_void_p, c.c_char_p]
    lib.ldb_close.argtypes = [c.c_void_p]
    _lib = lib
    return lib


def _pack_op(op: int, tree: int, key: bytes, value: bytes) -> bytes:
    return struct.pack("<BIII", op, tree, len(key), len(value)) + key + value


class NativeDb(IDb):
    engine = "native"

    def __init__(self, path: str, fsync: bool = False):
        self._lib = _load()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._h = self._lib.ldb_open(path.encode(), 1 if fsync else 0)
        if not self._h:
            raise DbError(f"cannot open native db at {path}")
        self._lock = threading.RLock()
        self._names: Dict[str, int] = {}
        n = self._lib.ldb_tree_count(self._h)
        buf = ctypes.create_string_buffer(4096)
        for i in range(n):
            ln = self._lib.ldb_tree_name(self._h, i, buf, 4096)
            if 0 <= ln <= 4096:
                self._names[buf.raw[:ln].decode()] = i

    def _handle(self):
        """The open engine's handle (call with the lock held)."""
        if not self._h:
            raise DbError("native db is closed")
        return self._h

    # --- engine interface ---

    def open_tree(self, name: str) -> int:
        with self._lock:
            i = self._names.get(name)
            if i is None:
                i = self._lib.ldb_open_tree(self._handle(), name.encode(),
                                            len(name.encode()))
                if i < 0:
                    raise DbError(f"cannot open tree {name!r}")
                self._names[name] = i
            return i

    def list_trees(self) -> List[str]:
        with self._lock:
            return sorted(self._names, key=self._names.get)

    def get(self, tree: int, key: bytes) -> Optional[bytes]:
        with self._lock:
            key = bytes(key)
            n = self._lib.ldb_get(self._handle(), tree, key, len(key), None,
                                  0)
            if n == -1:
                return None
            if n < 0:
                raise DbError("native get failed")
            if n == 0:
                return b""
            buf = ctypes.create_string_buffer(int(n))
            n2 = self._lib.ldb_get(self._h, tree, key, len(key), buf, int(n))
            if n2 != n:
                raise DbError("native get raced")
            return buf.raw

    def len(self, tree: int) -> int:
        with self._lock:
            n = self._lib.ldb_len(self._handle(), tree)
        if n < 0:
            raise DbError("bad tree")
        return int(n)

    def insert(self, tree: int, key: bytes, value: bytes) -> Optional[bytes]:
        with self._lock:
            old = self.get(tree, key)
            self._apply(_pack_op(1, tree, bytes(key), bytes(value)))
            return old

    def remove(self, tree: int, key: bytes) -> Optional[bytes]:
        with self._lock:
            old = self.get(tree, key)
            if old is not None:
                self._apply(_pack_op(2, tree, bytes(key), b""))
            return old

    def clear(self, tree: int) -> None:
        with self._lock:
            self._apply(_pack_op(5, tree, b"", b""))

    def _apply(self, ops: bytes) -> None:
        with self._lock:
            rc = self._lib.ldb_apply(self._handle(), ops, len(ops))
        if rc != 0:
            raise DbError(f"native apply failed rc={rc}")

    def iter_range(
        self,
        tree: int,
        start: Optional[bytes],
        end: Optional[bytes],
        reverse: bool = False,
    ) -> Iterator[Tuple[bytes, bytes]]:
        with self._lock:
            it = self._lib.ldb_iter_new(
                self._handle(), tree,
                start or b"", len(start) if start else 0,
                0 if start is None else 1,
                end or b"", len(end) if end else 0, 0 if end is None else 1,
                1 if reverse else 0,
            )
        if not it:
            raise DbError("bad tree for iteration")
        c = ctypes
        kp = c.POINTER(c.c_uint8)()
        vp = c.POINTER(c.c_uint8)()
        kl = c.c_uint32()
        vl = c.c_uint32()
        try:
            while True:
                # the iterator reads through its engine: step it only
                # while the engine is open
                with self._lock:
                    self._handle()
                    rc = self._lib.ldb_iter_next(
                        it, c.byref(kp), c.byref(kl), c.byref(vp),
                        c.byref(vl))
                    if rc == 0:
                        return
                    if rc < 0:
                        raise DbError("native iteration failed")
                    k = c.string_at(kp, kl.value)
                    v = c.string_at(vp, vl.value)
                yield k, v
        finally:
            self._lib.ldb_iter_free(it)

    def range_scan(
        self,
        tree: int,
        start: Optional[bytes],
        end: Optional[bytes],
        limit: int,
        reverse: bool = False,
    ) -> List[Tuple[bytes, bytes]]:
        # one native iterator, freed after `limit` rows — the in-RAM
        # ordered index seeks once and preads values on demand
        if limit <= 0:
            return []
        out: List[Tuple[bytes, bytes]] = []
        for kv in self.iter_range(tree, start, end, reverse):
            out.append(kv)
            if len(out) >= limit:
                break
        return out

    def transaction(self, fn: Callable[[Transaction], object]):
        with self._lock:
            tx = _NativeTx(self)
            try:
                res = fn(tx)
            except TxAbort as a:
                return a.value
            ops = tx.serialize()
            if ops:
                self._apply(ops)
        for hook in tx._on_commit:
            hook()
        return res

    def snapshot(self, path: str) -> None:
        with self._lock:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            if self._lib.ldb_snapshot(self._handle(), path.encode()) != 0:
                raise DbError("snapshot failed")

    def compact(self) -> None:
        with self._lock:
            if self._lib.ldb_compact(self._handle()) != 0:
                raise DbError("compaction failed")

    def close(self) -> None:
        with self._lock:
            if self._h:
                self._lib.ldb_close(self._h)
                self._h = None


class _NativeTx(Transaction):
    """Overlay transaction: writes buffer in RAM (visible to reads within
    the txn), applied as one atomic ldb_apply batch on commit."""

    def __init__(self, db: NativeDb):
        super().__init__()
        self.db = db
        # tree -> {key: value | None(=delete)}
        self.overlay: Dict[int, Dict[bytes, Optional[bytes]]] = {}

    def _o(self, tree: "Tree") -> Dict[bytes, Optional[bytes]]:
        return self.overlay.setdefault(tree.idx, {})

    def get(self, tree, key: bytes) -> Optional[bytes]:
        key = bytes(key)
        o = self._o(tree)
        if key in o:
            return o[key]
        return self.db.get(tree.idx, key)

    def len(self, tree) -> int:
        base = self.db.len(tree.idx)
        for k, v in self.overlay.get(tree.idx, {}).items():
            existed = self.db.get(tree.idx, k) is not None
            if v is None and existed:
                base -= 1
            elif v is not None and not existed:
                base += 1
        return base

    def insert(self, tree, key: bytes, value: bytes) -> Optional[bytes]:
        key = bytes(key)
        old = self.get(tree, key)
        self._o(tree)[key] = bytes(value)
        return old

    def remove(self, tree, key: bytes) -> Optional[bytes]:
        key = bytes(key)
        old = self.get(tree, key)
        if old is not None:
            self._o(tree)[key] = None
        return old

    def iter_range(self, tree, start=None, end=None, reverse=False):
        o = self.overlay.get(tree.idx, {})
        base = self.db.iter_range(tree.idx, start, end, reverse)
        ov_keys = sorted(
            (k for k in o
             if (start is None or k >= start) and (end is None or k < end)),
            reverse=reverse,
        )
        # ordered merge of the engine iterator and the overlay
        oi = 0
        bnext: Optional[Tuple[bytes, bytes]] = next(base, None)

        def ahead(a: bytes, b: bytes) -> bool:
            return a < b if not reverse else a > b

        while bnext is not None or oi < len(ov_keys):
            if bnext is None:
                take_overlay = True
            elif oi >= len(ov_keys):
                take_overlay = False
            elif ov_keys[oi] == bnext[0]:
                bnext = next(base, None)  # overlay shadows the engine row
                continue
            else:
                take_overlay = ahead(ov_keys[oi], bnext[0])
            if take_overlay:
                k = ov_keys[oi]
                oi += 1
                v = o[k]
                if v is not None:
                    yield k, v
            else:
                k, v = bnext
                bnext = next(base, None)
                if k not in o:  # not shadowed
                    yield k, v

    def serialize(self) -> bytes:
        out = []
        for tree_idx, o in self.overlay.items():
            for k, v in o.items():
                if v is None:
                    out.append(_pack_op(2, tree_idx, k, b""))
                else:
                    out.append(_pack_op(1, tree_idx, k, v))
        return b"".join(out)
