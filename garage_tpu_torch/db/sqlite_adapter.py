"""SQLite DB engine — WAL mode, one process-wide write lock.

Equivalent of reference src/db/sqlite_adapter.rs: every tree is one table
`tree_<n>(k BLOB PRIMARY KEY, v BLOB)`; a global mutex serializes access
(the reference notes this is the thread-safety worst case,
ref block/repair.rs:92-101).  BLOB primary keys give us ordered range scans
with memcmp semantics, matching the facade's contract.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Callable, Iterator, List, Optional, Tuple

from ..utils.error import DbError
from . import IDb, Transaction, TxAbort


class SqliteDb(IDb):
    engine = "sqlite"

    def __init__(self, path: str, synchronous: str = "NORMAL"):
        self.path = path
        self._lock = threading.RLock()
        self._conn = sqlite3.connect(path, check_same_thread=False, isolation_level=None)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute(f"PRAGMA synchronous={synchronous}")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS _trees (id INTEGER PRIMARY KEY, name TEXT UNIQUE)"
        )
        self._names: List[str] = []
        self._tree_ids: List[int] = []
        for tid, name in self._conn.execute("SELECT id, name FROM _trees ORDER BY id"):
            self._names.append(name)
            self._tree_ids.append(tid)

    def _table(self, tree: int) -> str:
        return f"tree_{self._tree_ids[tree]}"

    def open_tree(self, name: str) -> int:
        with self._lock:
            if name in self._names:
                return self._names.index(name)
            self._conn.execute(
                "INSERT OR IGNORE INTO _trees(name) VALUES (?)", (name,)
            )
            # lastrowid is stale when the INSERT was ignored; always re-read.
            tid = self._conn.execute(
                "SELECT id FROM _trees WHERE name=?", (name,)
            ).fetchone()[0]
            self._conn.execute(
                f"CREATE TABLE IF NOT EXISTS tree_{tid} "
                "(k BLOB PRIMARY KEY, v BLOB NOT NULL) WITHOUT ROWID"
            )
            self._names.append(name)
            self._tree_ids.append(tid)
            return len(self._names) - 1

    def list_trees(self) -> List[str]:
        with self._lock:
            return list(self._names)

    def get(self, tree: int, key: bytes) -> Optional[bytes]:
        with self._lock:
            row = self._conn.execute(
                f"SELECT v FROM {self._table(tree)} WHERE k=?", (bytes(key),)
            ).fetchone()
            return row[0] if row else None

    def len(self, tree: int) -> int:
        with self._lock:
            return self._conn.execute(
                f"SELECT COUNT(*) FROM {self._table(tree)}"
            ).fetchone()[0]

    def insert(self, tree: int, key: bytes, value: bytes) -> Optional[bytes]:
        with self._lock:
            old = self.get(tree, key)
            self._conn.execute(
                f"INSERT INTO {self._table(tree)}(k,v) VALUES(?,?) "
                "ON CONFLICT(k) DO UPDATE SET v=excluded.v",
                (bytes(key), bytes(value)),
            )
            return old

    def remove(self, tree: int, key: bytes) -> Optional[bytes]:
        with self._lock:
            old = self.get(tree, key)
            if old is not None:
                self._conn.execute(
                    f"DELETE FROM {self._table(tree)} WHERE k=?", (bytes(key),)
                )
            return old

    def clear(self, tree: int) -> None:
        with self._lock:
            self._conn.execute(f"DELETE FROM {self._table(tree)}")

    def iter_range(
        self,
        tree: int,
        start: Optional[bytes],
        end: Optional[bytes],
        reverse: bool = False,
    ) -> Iterator[Tuple[bytes, bytes]]:
        # Chunked cursor walk: re-seek by last key each chunk so concurrent
        # writes between chunks can't invalidate the iteration.
        CHUNK = 256
        cmp, order = ("<", "DESC") if reverse else (">", "ASC")
        lo, hi = start, end
        cursor_excl: Optional[bytes] = None
        while True:
            conds, params = [], []
            if lo is not None:
                conds.append("k >= ?"); params.append(lo)
            if hi is not None:
                conds.append("k < ?"); params.append(hi)
            if cursor_excl is not None:
                conds.append(f"k {cmp} ?"); params.append(cursor_excl)
            where = ("WHERE " + " AND ".join(conds)) if conds else ""
            with self._lock:
                rows = self._conn.execute(
                    f"SELECT k, v FROM {self._table(tree)} {where} "
                    f"ORDER BY k {order} LIMIT {CHUNK}",
                    params,
                ).fetchall()
            if not rows:
                return
            for k, v in rows:
                yield k, v
            cursor_excl = rows[-1][0]

    def range_scan(
        self,
        tree: int,
        start: Optional[bytes],
        end: Optional[bytes],
        limit: int,
        reverse: bool = False,
    ) -> List[Tuple[bytes, bytes]]:
        # ONE indexed LIMIT query per page — the chunked iter_range walk
        # pays a re-seek and a lock round-trip every 256 rows, which at
        # millions of rows is the listing hot path's dominant cost
        if limit <= 0:
            return []
        conds, params = [], []
        if start is not None:
            conds.append("k >= ?"); params.append(start)
        if end is not None:
            conds.append("k < ?"); params.append(end)
        where = ("WHERE " + " AND ".join(conds)) if conds else ""
        order = "DESC" if reverse else "ASC"
        with self._lock:
            return self._conn.execute(
                f"SELECT k, v FROM {self._table(tree)} {where} "
                f"ORDER BY k {order} LIMIT {int(limit)}",
                params,
            ).fetchall()

    def transaction(self, fn: Callable[[Transaction], object]):
        with self._lock:
            self._conn.execute("BEGIN IMMEDIATE")
            tx = _SqliteTx(self)
            try:
                res = fn(tx)
                self._conn.execute("COMMIT")
            except TxAbort as a:
                self._conn.execute("ROLLBACK")
                return a.value
            except BaseException:
                self._conn.execute("ROLLBACK")
                raise
        for hook in tx._on_commit:
            hook()
        return res

    def snapshot(self, path: str) -> None:
        with self._lock:
            dest = sqlite3.connect(path)
            try:
                self._conn.backup(dest)
            finally:
                dest.close()

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class _SqliteTx(Transaction):
    """Runs inside BEGIN IMMEDIATE with the adapter lock held."""

    def __init__(self, db: SqliteDb):
        super().__init__()
        self.db = db

    def get(self, tree, key):
        row = self.db._conn.execute(
            f"SELECT v FROM {self.db._table(tree.idx)} WHERE k=?", (bytes(key),)
        ).fetchone()
        return row[0] if row else None

    def len(self, tree):
        return self.db._conn.execute(
            f"SELECT COUNT(*) FROM {self.db._table(tree.idx)}"
        ).fetchone()[0]

    def insert(self, tree, key, value):
        old = self.get(tree, key)
        self.db._conn.execute(
            f"INSERT INTO {self.db._table(tree.idx)}(k,v) VALUES(?,?) "
            "ON CONFLICT(k) DO UPDATE SET v=excluded.v",
            (bytes(key), bytes(value)),
        )
        return old

    def remove(self, tree, key):
        old = self.get(tree, key)
        if old is not None:
            self.db._conn.execute(
                f"DELETE FROM {self.db._table(tree.idx)} WHERE k=?", (bytes(key),)
            )
        return old

    def iter_range(self, tree, start=None, end=None, reverse=False):
        conds, params = [], []
        if start is not None:
            conds.append("k >= ?"); params.append(start)
        if end is not None:
            conds.append("k < ?"); params.append(end)
        where = ("WHERE " + " AND ".join(conds)) if conds else ""
        order = "DESC" if reverse else "ASC"
        # stream via cursor: the tx holds BEGIN IMMEDIATE + the adapter
        # lock, so a live cursor is consistent and avoids materializing
        # the whole range
        return iter(
            self.db._conn.execute(
                f"SELECT k, v FROM {self.db._table(tree.idx)} {where} "
                f"ORDER BY k {order}",
                params,
            )
        )
