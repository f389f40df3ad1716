"""Metadata DB layer — engine-agnostic Db/Tree/Transaction facade.

Equivalent of reference src/db/lib.rs: a `Db` exposes named ordered
byte-key→byte-value `Tree`s and closure-based serializable transactions
(db/lib.rs:91-127, 175-254, 321-415).  Engines are selected at runtime
(ref model/garage.rs:114-213); here the engines are:

  - "sqlite": stdlib sqlite3 in WAL mode behind one process-wide lock
    (the reference's sqlite adapter likewise serializes through a global
    mutex, db/sqlite_adapter.rs).
  - "memory": in-process sorted maps — for tests and ephemeral nodes.

The shared conformance suite (tests/test_db.py) runs against every engine,
mirroring the reference's db/test.rs pattern.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterator, List, Optional, Tuple, TypeVar

from ..utils.error import DbError

T = TypeVar("T")


class TxAbort(Exception):
    """Raised inside a transaction closure to roll back (ref db/lib.rs
    TxError::Abort).  The `value` is returned to the transaction caller."""

    def __init__(self, value=None):
        self.value = value
        super().__init__("transaction aborted")


class IDb:
    """Engine interface (ref db/lib.rs:321-353 trait IDb).

    Trees are addressed by integer index once opened; keys and values are
    `bytes`.  `range` bounds follow Python slice conventions: start
    inclusive, end exclusive; None = unbounded.
    """

    engine: str = "?"

    def open_tree(self, name: str) -> int:
        raise NotImplementedError

    def list_trees(self) -> List[str]:
        raise NotImplementedError

    def get(self, tree: int, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def len(self, tree: int) -> int:
        raise NotImplementedError

    def insert(self, tree: int, key: bytes, value: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def remove(self, tree: int, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def clear(self, tree: int) -> None:
        raise NotImplementedError

    def iter_range(
        self,
        tree: int,
        start: Optional[bytes],
        end: Optional[bytes],
        reverse: bool = False,
    ) -> Iterator[Tuple[bytes, bytes]]:
        raise NotImplementedError

    def first(self, tree: int) -> Optional[Tuple[bytes, bytes]]:
        for kv in self.iter_range(tree, None, None):
            return kv
        return None

    def range_scan(
        self,
        tree: int,
        start: Optional[bytes],
        end: Optional[bytes],
        limit: int,
        reverse: bool = False,
    ) -> List[Tuple[bytes, bytes]]:
        """One materialized page of at most `limit` rows — the building
        block of paged/parallel scans: engines answer it in a single
        seek + bounded read (sqlite: one LIMIT query; memory: one slice
        under the lock) instead of a chunked cursor walk per row.
        Callers resume with start = last_key + b"\\x00" (forward) or
        end = last_key (reverse)."""
        out: List[Tuple[bytes, bytes]] = []
        if limit <= 0:
            return out
        for kv in self.iter_range(tree, start, end, reverse):
            out.append(kv)
            if len(out) >= limit:
                break
        return out

    def transaction(self, fn: Callable[["Transaction"], T]) -> T:
        raise NotImplementedError

    def snapshot(self, path: str) -> None:
        raise DbError(f"snapshot not supported by engine {self.engine}")

    def close(self) -> None:
        pass


class Transaction:
    """Transactional view handed to the closure (ref db/lib.rs ITx:355-377).

    Engines guarantee serializability by holding the engine write lock for
    the duration of the closure.  `on_commit` hooks run after a successful
    commit, outside the lock (used e.g. to notify merkle/GC workers)."""

    def __init__(self):
        self._on_commit: List[Callable[[], None]] = []

    def get(self, tree: "Tree", key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def len(self, tree: "Tree") -> int:
        raise NotImplementedError

    def insert(self, tree: "Tree", key: bytes, value: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def remove(self, tree: "Tree", key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def iter_range(
        self,
        tree: "Tree",
        start: Optional[bytes] = None,
        end: Optional[bytes] = None,
        reverse: bool = False,
    ) -> Iterator[Tuple[bytes, bytes]]:
        raise NotImplementedError

    def on_commit(self, fn: Callable[[], None]) -> None:
        self._on_commit.append(fn)

    def abort(self, value=None) -> "NoReturn":  # noqa: F821
        raise TxAbort(value)


class Tree:
    """One named ordered keyspace (ref db/lib.rs:175-254)."""

    __slots__ = ("db", "name", "idx")

    def __init__(self, db: "Db", name: str, idx: int):
        self.db, self.name, self.idx = db, name, idx

    def get(self, key: bytes) -> Optional[bytes]:
        return self.db.backend.get(self.idx, key)

    def __len__(self) -> int:
        return self.db.backend.len(self.idx)

    def is_empty(self) -> bool:
        return len(self) == 0

    def insert(self, key: bytes, value: bytes) -> Optional[bytes]:
        return self.db.backend.insert(self.idx, key, value)

    def remove(self, key: bytes) -> Optional[bytes]:
        return self.db.backend.remove(self.idx, key)

    def clear(self) -> None:
        self.db.backend.clear(self.idx)

    def first(self) -> Optional[Tuple[bytes, bytes]]:
        return self.db.backend.first(self.idx)

    def items(
        self, start: Optional[bytes] = None, end: Optional[bytes] = None
    ) -> Iterator[Tuple[bytes, bytes]]:
        return self.db.backend.iter_range(self.idx, start, end)

    def items_rev(
        self, start: Optional[bytes] = None, end: Optional[bytes] = None
    ) -> Iterator[Tuple[bytes, bytes]]:
        return self.db.backend.iter_range(self.idx, start, end, reverse=True)

    def range_scan(
        self,
        start: Optional[bytes] = None,
        end: Optional[bytes] = None,
        limit: int = 1000,
        reverse: bool = False,
    ) -> List[Tuple[bytes, bytes]]:
        """One page of at most `limit` rows (see IDb.range_scan)."""
        return self.db.backend.range_scan(self.idx, start, end, limit, reverse)

    def get_gt(self, key: bytes) -> Optional[Tuple[bytes, bytes]]:
        """First entry with key strictly greater (cursor-style resumable
        iteration — the pattern the table/block workers use so concurrent
        mutation cannot invalidate an iterator)."""
        for kv in self.db.backend.iter_range(self.idx, key + b"\x00", None):
            return kv
        return None


class Db:
    """Engine-agnostic database handle (ref db/lib.rs:27-41)."""

    def __init__(self, backend: IDb):
        self.backend = backend
        self._trees = {}
        self._lock = threading.Lock()

    @property
    def engine(self) -> str:
        return self.backend.engine

    def open_tree(self, name: str) -> Tree:
        with self._lock:
            t = self._trees.get(name)
            if t is None:
                t = Tree(self, name, self.backend.open_tree(name))
                self._trees[name] = t
            return t

    def list_trees(self) -> List[str]:
        return self.backend.list_trees()

    def transaction(self, fn: Callable[[Transaction], T]) -> T:
        """Run `fn(tx)` serializably; commit on return, roll back on TxAbort
        (returning its value) or any exception (re-raised)."""
        return self.backend.transaction(fn)

    def snapshot(self, path: str) -> None:
        self.backend.snapshot(path)

    def close(self) -> None:
        self.backend.close()


def open_db(engine: str, path: Optional[str] = None, **kw) -> Db:
    """Open a metadata DB (ref model/garage.rs:114-213 engine dispatch)."""
    if engine in ("sqlite", "sqlite3"):
        from .sqlite_adapter import SqliteDb

        if path is None:
            raise DbError("sqlite engine requires a path")
        return Db(SqliteDb(path, **kw))
    if engine in ("memory", "mem"):
        from .memory_adapter import MemoryDb

        # with a path: the durable third engine (snapshot + WAL, the
        # reference's sled slot); without: RAM-only (tests/ephemeral)
        return Db(MemoryDb(path=path, **kw))
    if engine in ("native", "logdb"):
        from .native_adapter import NativeDb

        if path is None:
            raise DbError("native engine requires a path")
        return Db(NativeDb(path, **kw))
    raise DbError(f"unknown db engine {engine!r}")
