"""BlockRc — per-block reference counts with delayed deletion.

Equivalent of reference src/block/rc.rs: the `block_local_rc` tree maps
hash → RcEntry, one of Present{count}, Deletable{at_time} (count fell to
zero: the block may be deleted after BLOCK_GC_DELAY) or Absent
(rc.rs:11-70).  Increments/decrements run inside the metadata update
transaction so the block layer and metadata can't diverge
(ref model/s3/block_ref_table.rs:65-81 calls these from `updated()`).
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..db import Transaction, Tree
from ..utils.crdt import now_msec
from ..utils.data import Hash
from ..utils.migrate import pack, unpack

BLOCK_GC_DELAY_MS = 10 * 60 * 1000  # ref block/manager.rs:54 (10 min)


class RcEntry:
    """Present{count} | Deletable{at_time} | Absent (ref rc.rs:75-178)."""

    __slots__ = ("count", "at_time")

    def __init__(self, count: int = 0, at_time: Optional[int] = None):
        self.count = count
        self.at_time = at_time

    @classmethod
    def parse(cls, v: Optional[bytes]) -> "RcEntry":
        if v is None:
            return cls(0, None)  # Absent
        count, at_time = unpack(v)
        return cls(count, at_time)

    def serialize(self) -> Optional[bytes]:
        if self.count == 0 and self.at_time is None:
            return None  # Absent: entry removed
        return pack([self.count, self.at_time])

    def increment(self) -> "RcEntry":
        return RcEntry(self.count + 1, None)

    def decrement(self) -> "RcEntry":
        c = max(0, self.count - 1)
        if c == 0:
            return RcEntry(0, now_msec() + BLOCK_GC_DELAY_MS)
        return RcEntry(c, None)

    def is_deletable(self) -> bool:
        return self.count == 0 and (
            self.at_time is None or self.at_time < now_msec()
        )

    def is_zero(self) -> bool:
        return self.count == 0

    def is_needed(self) -> bool:
        return self.count > 0


class BlockRc:
    def __init__(self, tree: Tree):
        self.tree = tree

    def block_incref(self, tx: Transaction, h: Hash) -> bool:
        """Returns True if the block became needed (0→1), i.e. the caller
        should trigger a resync to fetch it (ref rc.rs:75-104)."""
        old = RcEntry.parse(tx.get(self.tree, bytes(h)))
        new = old.increment()
        tx.insert(self.tree, bytes(h), new.serialize())
        return old.is_zero()

    def block_decref(self, tx: Transaction, h: Hash) -> bool:
        """Returns True if the count fell to zero (deletion timer armed) —
        the caller should queue a resync at the deletion time
        (ref rc.rs:106-133)."""
        old = RcEntry.parse(tx.get(self.tree, bytes(h)))
        new = old.decrement()
        s = new.serialize()
        if s is None:
            tx.remove(self.tree, bytes(h))
        else:
            tx.insert(self.tree, bytes(h), s)
        return new.is_zero()

    def get(self, h: Hash) -> RcEntry:
        return RcEntry.parse(self.tree.get(bytes(h)))

    def clear_deleted_block_rc(self, h: Hash) -> None:
        """Remove a Deletable entry whose timer expired and whose block was
        deleted (ref rc.rs:135-158)."""

        def txn(tx: Transaction):
            ent = RcEntry.parse(tx.get(self.tree, bytes(h)))
            if ent.is_zero() and ent.at_time is not None and ent.at_time < now_msec():
                tx.remove(self.tree, bytes(h))

        self.tree.db.transaction(txn)

    def clear_stray_rc(self, h: Hash) -> None:
        """Remove a zero-count entry regardless of its timer — migration
        cleanup after drop_stray_copy, where the timer's grace serves no
        purpose (the ring no longer assigns this node the block and every
        owner confirmed possession).  A concurrent incref vetoes."""

        def txn(tx: Transaction):
            ent = RcEntry.parse(tx.get(self.tree, bytes(h)))
            if ent.is_zero():
                tx.remove(self.tree, bytes(h))

        self.tree.db.transaction(txn)

    def rc_len(self) -> int:
        return len(self.tree)

    def items(self, start: Optional[bytes] = None):
        return self.tree.items(start)

    def get_gt(self, key: bytes) -> Optional[Tuple[bytes, bytes]]:
        return self.tree.get_gt(key)
