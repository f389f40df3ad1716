"""Table schema: partition/sort keys, entries, filters.

Equivalent of reference src/table/schema.rs:12-103: `PartitionKey::hash()`
is blake2 for strings and identity for 32-byte values (schema.rs:19-32);
entries are CRDTs with versioned serialization; the schema's `updated()`
hook runs inside the update transaction (schema.rs:88-100).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Type

from ..db import Transaction
from ..utils.crdt import Crdt
from ..utils.data import FixedBytes32, Hash, blake2sum
from ..utils.migrate import Migrated


def hash_partition_key(p: Any) -> Hash:
    """ref schema.rs:19-32: blake2 of strings, identity for FixedBytes32.
    Tuples (e.g. K2V's (bucket_id, partition_key)) hash their blake2-joined
    parts, matching the reference's K2VItemPartition composite key."""
    if isinstance(p, FixedBytes32):
        return p
    if isinstance(p, str):
        return blake2sum(p.encode())
    if isinstance(p, bytes):
        if len(p) == 32:
            return Hash(p)
        return blake2sum(p)
    if isinstance(p, tuple):
        # length-prefix each part so ("a","bc") and ("ab","c") can't collide
        buf = b""
        for x in p:
            part = bytes(x) if isinstance(x, (bytes, FixedBytes32)) else str(x).encode()
            buf += len(part).to_bytes(4, "big") + part
        return blake2sum(buf)
    raise TypeError(f"unsupported partition key type {type(p)!r}")


def sort_key_bytes(s: Any) -> bytes:
    """ref schema.rs:37-52 SortKey::sort_key."""
    if isinstance(s, (bytes, FixedBytes32)):
        return bytes(s)
    if isinstance(s, str):
        return s.encode()
    raise TypeError(f"unsupported sort key type {type(s)!r}")


def tree_key(p: Any, s: Any) -> bytes:
    """DB key of an entry: hash(P) ‖ sort_key (ref table/data.rs:323-329)."""
    return bytes(hash_partition_key(p)) + sort_key_bytes(s)


class Entry(Crdt, Migrated):
    """A table entry: CRDT + versioned serialization + keys
    (ref schema.rs:57-69).  Subclasses define `partition_key`/`sort_key`
    properties and CRDT merge."""

    @property
    def partition_key(self) -> Any:
        raise NotImplementedError

    @property
    def sort_key(self) -> Any:
        raise NotImplementedError

    def is_tombstone(self) -> bool:
        return False

    def tree_key(self) -> bytes:
        return tree_key(self.partition_key, self.sort_key)


class TableSchema:
    """ref schema.rs:72-103.  Subclasses set TABLE_NAME and ENTRY (the
    entry class, used to decode stored bytes) and may override `updated`
    (transactional cross-table hook) and `matches_filter`."""

    TABLE_NAME: str = "?"
    ENTRY: Type[Entry] = Entry

    def decode_entry(self, data: bytes) -> Entry:
        return self.ENTRY.decode(data)  # type: ignore[return-value]

    def updated(
        self,
        tx: Transaction,
        old: Optional[Entry],
        new: Optional[Entry],
    ) -> None:
        """Called inside the update transaction whenever an entry changes
        (ref schema.rs:88-100) — the cross-table coupling point (e.g.
        block_ref → rc incref/decref)."""

    def matches_filter(self, entry: Entry, filter: Any) -> bool:
        """ref schema.rs:102 — default: tombstones don't match."""
        return not entry.is_tombstone()


class DeletedFilter:
    """ref table/util.rs DeletedFilter — Any/Deleted/NotDeleted."""

    ANY = "any"
    DELETED = "deleted"
    NOT_DELETED = "not_deleted"

    @staticmethod
    def matches(filter: str, is_deleted: bool) -> bool:
        if filter == DeletedFilter.ANY:
            return True
        if filter == DeletedFilter.DELETED:
            return is_deleted
        return not is_deleted


EMPTY_SORT_KEY = ""
