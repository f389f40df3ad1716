"""CountedTree — a Tree with an O(1) in-RAM length counter.

Equivalent of reference src/db/counted_tree_hack.rs:16-34: sqlite COUNT(*)
is O(n), but the resync queue/error trees and gc_todo need cheap `.len()`
for metrics and scheduling, so the count is kept in an atomic alongside the
tree and initialized from a real count at open.
"""

from __future__ import annotations

import itertools
import threading
from typing import Iterator, Optional, Tuple

from . import Tree


class CountedTree:
    def __init__(self, tree: Tree):
        self.tree = tree
        self._count = len(tree)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return self._count

    def is_empty(self) -> bool:
        return self._count == 0

    def get(self, key: bytes) -> Optional[bytes]:
        return self.tree.get(key)

    def insert(self, key: bytes, value: bytes) -> Optional[bytes]:
        old = self.tree.insert(key, value)
        if old is None:
            with self._lock:
                self._count += 1
        return old

    def remove(self, key: bytes) -> Optional[bytes]:
        old = self.tree.remove(key)
        if old is not None:
            with self._lock:
                self._count -= 1
        return old

    def first(self) -> Optional[Tuple[bytes, bytes]]:
        return self.tree.first()

    def items(self, start=None, end=None) -> Iterator[Tuple[bytes, bytes]]:
        return self.tree.items(start, end)

    def get_gt(self, key: bytes) -> Optional[Tuple[bytes, bytes]]:
        return self.tree.get_gt(key)

    def range_scan(self, start=None, end=None, limit: int = 1000,
                   reverse: bool = False) -> list:
        return self.tree.range_scan(start, end, limit, reverse)

    def reconcile(self) -> int:
        """Re-count from the tree and return the drift the cached
        counter had accumulated (0 = exact).  The metadata-at-millions
        accuracy check: worker gauges and scheduling decisions read the
        cached count, so any drift under delete+reinsert churn is a
        first-class bug — bench/tests assert reconcile() == 0 after
        churn, and a production caller can use it as a self-repair."""
        # length read under the counter lock: every adapter runs
        # on_commit hooks (the only other _lock takers) AFTER releasing
        # its own lock, so this nesting cannot deadlock — and a length
        # read outside the lock could install a stale count, turning the
        # self-repair into the drift it is meant to fix
        with self._lock:
            real = len(self.tree)
            drift = self._count - real
            self._count = real
        return drift

    def _add(self, delta: int) -> None:
        with self._lock:
            self._count += delta

    def tx_insert(self, tx, key: bytes, value: bytes) -> Optional[bytes]:
        """Transactional insert that keeps the counter consistent: the
        count adjustment is applied via on_commit so aborts don't skew it."""
        old = tx.insert(self.tree, key, value)
        if old is None:
            tx.on_commit(lambda: self._add(1))
        return old

    def tx_remove(self, tx, key: bytes) -> Optional[bytes]:
        old = tx.remove(self.tree, key)
        if old is not None:
            tx.on_commit(lambda: self._add(-1))
        return old

    def compare_and_swap(
        self,
        key: bytes,
        expected: Optional[bytes],
        new: Optional[bytes],
    ) -> bool:
        """Atomically set key → new (None = delete) iff current == expected
        (ref db/counted_tree_hack.rs compare_and_swap, used by gc/resync to
        remove a todo entry only if unchanged since it was read)."""
        tree = self.tree

        def txn(tx):
            cur = tx.get(tree, key)
            if cur != expected:
                return False
            if new is None:
                if cur is not None:
                    tx.remove(tree, key)
            else:
                tx.insert(tree, key, new)
            return True

        ok = tree.db.transaction(txn)
        if ok:
            with self._lock:
                if expected is None and new is not None:
                    self._count += 1
                elif expected is not None and new is None:
                    self._count -= 1
        return ok
