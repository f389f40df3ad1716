"""In-memory DB engine — sorted maps behind one lock, with optional
snapshot + write-ahead-log durability.

Without a path: the test/ephemeral engine.  With a path: the third
DURABLE metadata engine (the slot the reference fills with sled,
ref src/db/sled_adapter.rs:1-274 — an in-RAM-indexed store persisted to
disk).  Design, deliberately different from both sled and logdb:

  - the entire working set lives in RAM (this engine's point: metadata
    reads at dict speed);
  - every committed mutation appends ONE crc-framed redo record to
    `wal.log` (torn tails are detected by length/crc and truncated at
    recovery — a kill -9 mid-append loses nothing acknowledged);
  - when the WAL outgrows max(threshold, 2 x snapshot size) the engine
    writes a full crc-framed snapshot via tmp+fsync+rename and resets
    the WAL — recovery cost stays proportional to the working set, not
    history;
  - tree ids are assigned by open order, so open_tree is itself a
    logged operation (replay reproduces the id assignment).

Conforms to the same suite as sqlite/native (tests/test_db.py) and the
same kill -9 torture harness (tests/test_db_torture.py).
"""

from __future__ import annotations

import bisect
import logging
import os
import struct
import threading
import zlib
from typing import Callable, Iterator, List, Optional, Tuple

from . import DbError, IDb, Transaction, TxAbort

logger = logging.getLogger("garage_tpu_torch.db.memory")

_OP_INSERT = 0
_OP_REMOVE = 1
_OP_CLEAR = 2
_OP_OPEN_TREE = 3

_SNAP_MAGIC = b"GTMSNAP1"
_WAL_MAGIC = b"GTMWAL01"


def _enc_ops(ops) -> bytes:
    parts = [struct.pack("<I", len(ops))]
    for op in ops:
        code = op[0]
        if code == _OP_OPEN_TREE:
            name = op[1].encode()
            parts.append(struct.pack("<BI", code, len(name)))
            parts.append(name)
        elif code == _OP_CLEAR:
            parts.append(struct.pack("<BI", code, op[1]))
        else:
            _c, tree, key, val = op
            parts.append(struct.pack("<BII", code, tree, len(key)))
            parts.append(key)
            if code == _OP_INSERT:
                parts.append(struct.pack("<I", len(val)))
                parts.append(val)
    return b"".join(parts)


def _dec_ops(body: bytes):
    (n,) = struct.unpack_from("<I", body, 0)
    off = 4
    out = []
    for _ in range(n):
        code = body[off]
        if code == _OP_OPEN_TREE:
            (ln,) = struct.unpack_from("<I", body, off + 1)
            off += 5
            out.append((code, body[off:off + ln].decode()))
            off += ln
        elif code == _OP_CLEAR:
            (tree,) = struct.unpack_from("<I", body, off + 1)
            out.append((code, tree))
            off += 5
        else:
            tree, klen = struct.unpack_from("<II", body, off + 1)
            off += 9
            key = body[off:off + klen]
            off += klen
            if code == _OP_INSERT:
                (vlen,) = struct.unpack_from("<I", body, off)
                off += 4
                val = body[off:off + vlen]
                off += vlen
                out.append((code, tree, key, val))
            else:
                out.append((code, tree, key, None))
    return out


class _MemTree:
    __slots__ = ("name", "data", "keys")

    def __init__(self, name: str):
        self.name = name
        self.data = {}
        self.keys: List[bytes] = []  # sorted

    def insert(self, key: bytes, value: bytes) -> Optional[bytes]:
        old = self.data.get(key)
        if old is None:
            bisect.insort(self.keys, key)
        self.data[key] = value
        return old

    def remove(self, key: bytes) -> Optional[bytes]:
        old = self.data.pop(key, None)
        if old is not None:
            i = bisect.bisect_left(self.keys, key)
            del self.keys[i]
        return old

    def range_keys(
        self, start: Optional[bytes], end: Optional[bytes], reverse: bool
    ) -> List[bytes]:
        lo = 0 if start is None else bisect.bisect_left(self.keys, start)
        hi = len(self.keys) if end is None else bisect.bisect_left(self.keys, end)
        ks = self.keys[lo:hi]
        return ks[::-1] if reverse else ks


class MemoryDb(IDb):
    engine = "memory"

    def __init__(self, path: Optional[str] = None, fsync: bool = False,
                 wal_snapshot_bytes: int = 64 << 20):
        self._lock = threading.RLock()
        self._trees: List[_MemTree] = []
        self._by_name = {}
        self._path = path
        self._fsync = fsync
        self._wal_snapshot_bytes = wal_snapshot_bytes
        self._wal = None
        self._wal_bytes = 0
        self._snap_bytes = 0
        if path is not None:
            os.makedirs(path, exist_ok=True)
            self._recover()
            self._open_wal()

    # --- durability machinery (no-ops when path is None) ---

    def _snap_path(self) -> str:
        return os.path.join(self._path, "snap.db")

    def _wal_path(self) -> str:
        return os.path.join(self._path, "wal.log")

    def _open_wal(self) -> None:
        f = open(self._wal_path(), "ab")
        if f.tell() == 0:
            f.write(_WAL_MAGIC)
            f.flush()
            if self._fsync:
                os.fsync(f.fileno())
        self._wal = f
        self._wal_bytes = f.tell()

    def _log(self, ops) -> None:
        """Append one committed mutation group; called under the lock."""
        if self._wal is None or not ops:
            return
        body = _enc_ops(ops)
        self._wal.write(struct.pack("<II", len(body),
                                    zlib.crc32(body)) + body)
        self._wal.flush()
        if self._fsync:
            os.fsync(self._wal.fileno())
        self._wal_bytes += 8 + len(body)
        if self._wal_bytes > max(self._wal_snapshot_bytes,
                                 2 * self._snap_bytes):
            self._write_snapshot()

    def _write_snapshot(self) -> None:
        """Full state to snap.tmp + fsync + rename, then reset the WAL.
        Called under the lock; crash anywhere leaves either the old
        snapshot + full WAL or the new snapshot (+ possibly the stale
        WAL, whose replay is idempotent re-application of state already
        in the snapshot — see _recover)."""
        parts = [struct.pack("<I", len(self._trees))]
        for t in self._trees:
            name = t.name.encode()
            parts.append(struct.pack("<II", len(name), len(t.data)))
            parts.append(name)
            for k in t.keys:
                v = t.data[k]
                parts.append(struct.pack("<II", len(k), len(v)))
                parts.append(k)
                parts.append(v)
        body = b"".join(parts)
        tmp = self._snap_path() + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_SNAP_MAGIC + struct.pack(
                "<IQ", zlib.crc32(body), len(body)) + body)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snap_path())
        dirfd = os.open(self._path, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
        self._snap_bytes = len(body)
        # reset the WAL only after the snapshot is durable
        if self._wal is not None:
            self._wal.close()
        with open(self._wal_path(), "wb") as f:
            f.write(_WAL_MAGIC)
            f.flush()
            os.fsync(f.fileno())
        self._open_wal()

    def _recover(self) -> None:
        snap = self._snap_path()
        if os.path.exists(snap):
            with open(snap, "rb") as f:
                hdr = f.read(len(_SNAP_MAGIC) + 12)
                if hdr[:len(_SNAP_MAGIC)] != _SNAP_MAGIC:
                    raise DbError(f"bad snapshot magic in {snap}")
                crc, blen = struct.unpack_from("<IQ", hdr,
                                               len(_SNAP_MAGIC))
                body = f.read(blen)
            if len(body) != blen or zlib.crc32(body) != crc:
                raise DbError(f"corrupt snapshot {snap}")
            self._load_snapshot(body)
            self._snap_bytes = blen
        wal = self._wal_path()
        if not os.path.exists(wal):
            return
        with open(wal, "rb") as f:
            raw = f.read()
        if raw[:len(_WAL_MAGIC)] != _WAL_MAGIC:
            if raw:
                raise DbError(f"bad WAL magic in {wal}")
            return
        off = len(_WAL_MAGIC)
        good_end = off
        bad_reason = None
        while off + 8 <= len(raw):
            blen, crc = struct.unpack_from("<II", raw, off)
            body = raw[off + 8:off + 8 + blen]
            if len(body) != blen:
                bad_reason = "short_record"  # torn tail: never committed
                break
            if zlib.crc32(body) != crc:
                bad_reason = "crc_mismatch"
                break
            self._replay(_dec_ops(body))
            off += 8 + blen
            good_end = off
        if good_end < len(raw):
            dropped = len(raw) - good_end
            if bad_reason is None:
                bad_reason = "short_header"  # < 8 trailing bytes
            # A short final record/header is the EXPECTED kill -9 shape
            # (the record never committed — losing it loses nothing
            # acknowledged).  A CRC mismatch FOLLOWED by parseable
            # records is a different animal: mid-file corruption eating
            # commits that were acknowledged — scan ahead to tell the
            # two apart and log accordingly (a silent truncate would
            # hide both cases).
            later_records = 0
            if bad_reason == "crc_mismatch":
                scan = off + 8 + struct.unpack_from("<II", raw, off)[0]
                while scan + 8 <= len(raw):
                    blen2, crc2 = struct.unpack_from("<II", raw, scan)
                    body2 = raw[scan + 8:scan + 8 + blen2]
                    if len(body2) != blen2 or zlib.crc32(body2) != crc2:
                        break
                    later_records += 1
                    scan += 8 + blen2
            if later_records:
                logger.error(
                    "WAL %s: mid-file CRC mismatch at offset %d with %d "
                    "parseable record(s) after it — %d bytes of "
                    "ACKNOWLEDGED commits discarded (media corruption, "
                    "not a torn tail)",
                    wal, off, later_records, dropped)
            else:
                logger.warning(
                    "WAL %s: torn tail (%s at offset %d), truncating %d "
                    "uncommitted byte(s)", wal, bad_reason, off, dropped)
            with open(wal, "r+b") as f:
                f.truncate(good_end)

    def _load_snapshot(self, body: bytes) -> None:
        (ntrees,) = struct.unpack_from("<I", body, 0)
        off = 4
        for _ in range(ntrees):
            nlen, nkeys = struct.unpack_from("<II", body, off)
            off += 8
            name = body[off:off + nlen].decode()
            off += nlen
            t = _MemTree(name)
            for _ in range(nkeys):
                klen, vlen = struct.unpack_from("<II", body, off)
                off += 8
                k = body[off:off + klen]
                off += klen
                v = body[off:off + vlen]
                off += vlen
                t.data[k] = v
                t.keys.append(k)
            self._trees.append(t)
            self._by_name[name] = len(self._trees) - 1

    def _replay(self, ops) -> None:
        for op in ops:
            code = op[0]
            if code == _OP_OPEN_TREE:
                name = op[1]
                if name not in self._by_name:
                    self._trees.append(_MemTree(name))
                    self._by_name[name] = len(self._trees) - 1
            elif code == _OP_CLEAR:
                t = self._trees[op[1]]
                t.data.clear()
                t.keys.clear()
            elif code == _OP_INSERT:
                self._trees[op[1]].insert(op[2], op[3])
            else:
                self._trees[op[1]].remove(op[2])

    def snapshot(self, path: str) -> None:
        """Consistent copy for `garage meta snapshot` / convert-db.

        The copied snapshot, the stub WAL and the destination directory
        are all fsynced before returning, mirroring _write_snapshot — a
        snapshot whose caller archives/deletes the source right after
        must not evaporate in a crash."""
        if self._path is None:
            raise DbError("snapshot requires a durable (path) memory db")
        with self._lock:
            self._write_snapshot()
            import shutil

            os.makedirs(path, exist_ok=True)
            dst_snap = os.path.join(path, "snap.db")
            shutil.copy2(self._snap_path(), dst_snap)
            with open(dst_snap, "rb") as f:
                os.fsync(f.fileno())
            with open(os.path.join(path, "wal.log"), "wb") as f:
                f.write(_WAL_MAGIC)
                f.flush()
                os.fsync(f.fileno())
            dirfd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)

    def close(self) -> None:
        with self._lock:
            if self._wal is not None:
                self._wal.close()
                self._wal = None

    def open_tree(self, name: str) -> int:
        with self._lock:
            if name in self._by_name:
                return self._by_name[name]
            self._trees.append(_MemTree(name))
            idx = len(self._trees) - 1
            self._by_name[name] = idx
            self._log([(_OP_OPEN_TREE, name)])
            return idx

    def list_trees(self) -> List[str]:
        with self._lock:
            return [t.name for t in self._trees]

    def get(self, tree: int, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._trees[tree].data.get(key)

    def len(self, tree: int) -> int:
        with self._lock:
            return len(self._trees[tree].data)

    def insert(self, tree: int, key: bytes, value: bytes) -> Optional[bytes]:
        with self._lock:
            old = self._trees[tree].insert(bytes(key), bytes(value))
            self._log([(_OP_INSERT, tree, bytes(key), bytes(value))])
            return old

    def remove(self, tree: int, key: bytes) -> Optional[bytes]:
        with self._lock:
            old = self._trees[tree].remove(bytes(key))
            if old is not None:
                self._log([(_OP_REMOVE, tree, bytes(key), None)])
            return old

    def clear(self, tree: int) -> None:
        with self._lock:
            t = self._trees[tree]
            t.data.clear()
            t.keys.clear()
            self._log([(_OP_CLEAR, tree)])

    def iter_range(
        self,
        tree: int,
        start: Optional[bytes],
        end: Optional[bytes],
        reverse: bool = False,
    ) -> Iterator[Tuple[bytes, bytes]]:
        # Snapshot the key range so concurrent mutation can't corrupt the
        # walk; values are read live (same behavior as a cursor walk).
        with self._lock:
            t = self._trees[tree]
            ks = t.range_keys(start, end, reverse)
        for k in ks:
            with self._lock:
                v = t.data.get(k)
            if v is not None:
                yield k, v

    def range_scan(
        self,
        tree: int,
        start: Optional[bytes],
        end: Optional[bytes],
        limit: int,
        reverse: bool = False,
    ) -> List[Tuple[bytes, bytes]]:
        # one slice + gather under a single lock hold: the per-key
        # lock round-trip of iter_range is what a page-sized scan pays
        # for a consistency it does not need
        if limit <= 0:
            return []
        with self._lock:
            t = self._trees[tree]
            lo = 0 if start is None else bisect.bisect_left(t.keys, start)
            hi = (len(t.keys) if end is None
                  else bisect.bisect_left(t.keys, end))
            if reverse:
                ks = t.keys[max(lo, hi - limit):hi][::-1]
            else:
                ks = t.keys[lo:min(hi, lo + limit)]
            return [(k, t.data[k]) for k in ks]

    def transaction(self, fn: Callable[[Transaction], object]):
        with self._lock:
            tx = _MemTx(self)
            try:
                res = fn(tx)
            except TxAbort as a:
                tx.rollback()
                return a.value
            except BaseException:
                tx.rollback()
                raise
            # ONE redo record for the whole transaction: recovery
            # replays it atomically or (torn tail) not at all
            self._log(tx._redo)
        for hook in tx._on_commit:
            hook()
        return res


class _MemTx(Transaction):
    """Undo-log transaction over the in-memory trees (lock held by caller)."""

    def __init__(self, db: MemoryDb):
        super().__init__()
        self.db = db
        self._undo: List[Tuple[int, bytes, Optional[bytes]]] = []
        self._redo: List[tuple] = []

    def get(self, tree, key):
        return self.db._trees[tree.idx].data.get(bytes(key))

    def len(self, tree):
        return len(self.db._trees[tree.idx].data)

    def insert(self, tree, key, value):
        old = self.db._trees[tree.idx].insert(bytes(key), bytes(value))
        self._undo.append((tree.idx, bytes(key), old))
        self._redo.append((_OP_INSERT, tree.idx, bytes(key), bytes(value)))
        return old

    def remove(self, tree, key):
        old = self.db._trees[tree.idx].remove(bytes(key))
        if old is not None:
            self._undo.append((tree.idx, bytes(key), old))
            self._redo.append((_OP_REMOVE, tree.idx, bytes(key), None))
        return old

    def iter_range(self, tree, start=None, end=None, reverse=False):
        t = self.db._trees[tree.idx]
        for k in t.range_keys(start, end, reverse):
            v = t.data.get(k)
            if v is not None:
                yield k, v

    def rollback(self):
        for tree_idx, key, old in reversed(self._undo):
            t = self.db._trees[tree_idx]
            if old is None:
                t.remove(key)
            else:
                t.insert(key, old)
