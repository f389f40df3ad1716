"""TableData — local storage + CRDT merge engine for one table.

Equivalent of reference src/table/data.rs (SURVEY.md §2.4): trees
`{name}:table`, `:merkle_todo`, `:insert_queue`, `:gc_todo`; the update
transaction decodes → merges → re-encodes and, if changed, writes the
entry + a merkle-todo marker + runs the schema's `updated()` hook, and
enqueues a GC-todo entry when the new value is a tombstone and this node
is the partition leader (data.rs:198-267).
"""

from __future__ import annotations

import logging
import struct
from typing import Any, Callable, List, Optional, Tuple

from ..db import Db, Transaction, Tree
from ..db.counted_tree import CountedTree
from ..rpc.system import System
from ..utils.background import LoopSafeEvent
from ..utils.crdt import now_msec
from ..utils.data import Hash, blake2sum
from .replication import TableReplication
from .schema import Entry, TableSchema, hash_partition_key, sort_key_bytes, tree_key

logger = logging.getLogger("garage_tpu_torch.table.data")


class TableData:
    def __init__(
        self,
        system: System,
        schema: TableSchema,
        replication: TableReplication,
        db: Db,
    ):
        self.system = system
        self.schema = schema
        self.replication = replication
        self.db = db
        name = schema.TABLE_NAME
        self.store: Tree = db.open_tree(f"{name}:table")
        self.merkle_tree: Tree = db.open_tree(f"{name}:merkle_tree")
        # merkle_todo/insert_queue/gc_todo need O(1) len for worker gauges
        # (ref db/counted_tree_hack.rs; sqlite COUNT(*) is O(n))
        self.merkle_todo: CountedTree = CountedTree(db.open_tree(f"{name}:merkle_todo"))
        self.insert_queue: CountedTree = CountedTree(db.open_tree(f"{name}:insert_queue"))
        self.gc_todo: CountedTree = CountedTree(db.open_tree(f"{name}:gc_todo_v2"))
        # notified when merkle_todo / insert_queue gain items —
        # LoopSafeEvent, not asyncio.Event: batched Merkle/queue passes
        # commit from worker threads, and a plain Event set off-loop
        # wakes nobody (the drainer would sleep out a full
        # wait_for_work interval on a refill that landed mid-batch)
        self.merkle_todo_notify = LoopSafeEvent()
        self.insert_queue_notify = LoopSafeEvent()
        # [table] tunables (None outside a full daemon: defaults)
        tcfg = getattr(getattr(system, "config", None), "table", None)
        self.scan_page = int(getattr(tcfg, "scan_page", 1024) or 1024)
        m = getattr(system, "metrics", None)
        if m is not None:
            self._m_scan_pages = m.counter(
                "table_scan_pages_total",
                "range_scan pages served by the local table store, per "
                "table")
            self._m_scan_rows = m.counter(
                "table_scan_rows_total",
                "Rows scanned (before filtering) by local range reads, "
                "per table")
        else:
            self._m_scan_pages = self._m_scan_rows = None

    # --- reads (ref data.rs:92-160) ---

    def tree_key(self, p: Any, s: Any) -> bytes:
        return tree_key(p, s)

    def read_entry(self, p: Any, s: Any) -> Optional[bytes]:
        return self.store.get(self.tree_key(p, s))

    def decode_entry(self, data: bytes) -> Entry:
        return self.schema.decode_entry(data)

    def read_range(
        self,
        partition_hash: Hash,
        start_sort_key: Optional[bytes],
        filter: Any,
        limit: int,
        reverse: bool = False,
        end_sort_key: Optional[bytes] = None,
    ) -> List[bytes]:
        """Encoded entries of one partition from `start_sort_key`,
        filtered (ref data.rs:112-160), bounded above (exclusive) by
        `end_sort_key` — the sub-range contract sharded listings fan out
        over.  Pages through Tree.range_scan: one engine seek + bounded
        read per page instead of a per-row cursor walk."""
        pfx = bytes(partition_hash)
        first = pfx + (start_sort_key or b"")
        # partition keyspace upper bound: hash ‖ 0xff… is not representable,
        # so bound by incrementing the 32-byte prefix
        end = _prefix_upper_bound(pfx)
        if end_sort_key is not None:
            bounded = pfx + end_sort_key
            end = bounded if end is None else min(end, bounded)
        out: List[bytes] = []
        if reverse:
            # descending from the start sort key *inclusive* (ref
            # data.rs range_rev(..=first)); no start key = whole partition
            pos_hi = first + b"\x00" if start_sort_key is not None else end
            lo = pfx
        else:
            pos = first
        while True:
            # floor of 64: a filter-heavy tail must not degenerate into
            # one-row pages (the fetch is cheap; decode stops at limit)
            page_size = max(min(limit - len(out), self.scan_page), 64)
            if reverse:
                page = self.store.range_scan(lo, pos_hi, page_size,
                                             reverse=True)
            else:
                page = self.store.range_scan(pos, end, page_size)
            if self._m_scan_pages is not None and page:
                self._m_scan_pages.inc(table_name=self.schema.TABLE_NAME)
                self._m_scan_rows.inc(
                    len(page), table_name=self.schema.TABLE_NAME)
            for k, v in page:
                if not k.startswith(pfx):
                    return out
                try:
                    ent = self.decode_entry(v)
                except Exception:
                    logger.exception("undecodable entry at %s", k.hex()[:16])
                    continue
                if filter is None or self.schema.matches_filter(ent, filter):
                    out.append(v)
                    if len(out) >= limit:
                        return out
            if len(page) < page_size:
                return out
            if reverse:
                pos_hi = page[-1][0]
            else:
                pos = page[-1][0] + b"\x00"

    # --- mutations (ref data.rs:174-267) ---

    def update_many(self, entries: List[bytes]) -> None:
        for e in entries:
            self.update_entry(e)

    def update_entry(self, update_bytes: bytes) -> Optional[Entry]:
        update = self.decode_entry(update_bytes)

        def merge_fn(tx: Transaction, old: Optional[Entry]) -> Entry:
            if old is not None:
                old.merge(update)
                return old
            return update

        return self.update_entry_with(
            update.partition_key, update.sort_key, merge_fn
        )

    def update_entry_with(
        self,
        p: Any,
        s: Any,
        update_fn: Callable[[Transaction, Optional[Entry]], Entry],
    ) -> Optional[Entry]:
        """The core update transaction (ref data.rs:198-245)."""
        tk = self.tree_key(p, s)

        def txn(tx: Transaction):
            old_bytes = tx.get(self.store, tk)
            old_entry = self.decode_entry(old_bytes) if old_bytes is not None else None
            # old_entry is re-decoded for the hook: update_fn mutates its copy
            hook_old = self.decode_entry(old_bytes) if old_bytes is not None else None
            new_entry = update_fn(tx, old_entry)
            new_bytes = new_entry.encode()
            if new_bytes == old_bytes:
                return None
            new_bytes_hash = blake2sum(new_bytes)
            self.merkle_todo.tx_insert(tx, tk, bytes(new_bytes_hash))
            tx.insert(self.store, tk, new_bytes)
            self.schema.updated(tx, hook_old, new_entry)
            return new_entry, new_bytes_hash

        res = self.db.transaction(txn)
        if res is None:
            return None
        new_entry, new_bytes_hash = res
        self.merkle_todo_notify.set()
        if new_entry.is_tombstone():
            # Only the partition leader (first write node) enqueues GC —
            # avoids GC loops (ref data.rs:246-260).
            pk_hash = Hash(tk[:32])
            nodes = self.replication.write_nodes(pk_hash)
            if nodes and nodes[0] == self.system.id:
                self.gc_todo.insert(
                    gc_todo_key(now_msec(), tk), bytes(new_bytes_hash)
                )
        return new_entry

    def delete_if_equal(self, k: bytes, v: bytes) -> bool:
        """Remove entry only if its current encoding is exactly `v`
        (ref data.rs:269-295)."""

        def txn(tx: Transaction):
            cur = tx.get(self.store, k)
            if cur != v:
                return False
            old_entry = self.decode_entry(v)
            tx.remove(self.store, k)
            self.merkle_todo.tx_insert(tx, k, b"")
            self.schema.updated(tx, old_entry, None)
            return True

        removed = self.db.transaction(txn)
        if removed:
            self.merkle_todo_notify.set()
        return removed

    def delete_if_equal_hash(self, k: bytes, vhash: Hash) -> bool:
        """ref data.rs:297-321."""

        def txn(tx: Transaction):
            cur = tx.get(self.store, k)
            if cur is None or blake2sum(cur) != vhash:
                return None
            old_entry = self.decode_entry(cur)
            tx.remove(self.store, k)
            self.merkle_todo.tx_insert(tx, k, b"")
            self.schema.updated(tx, old_entry, None)
            return cur

        removed = self.db.transaction(txn)
        if removed is not None:
            self.merkle_todo_notify.set()
        return removed is not None

    # --- insert queue (ref data.rs queue_insert) ---

    def queue_insert(self, tx: Transaction, entry: Entry) -> None:
        """Defer an insert from inside another transaction: the entry is
        written to the insert queue and pushed to replicas asynchronously
        by the InsertQueueWorker (ref data.rs:323-341, queue.rs).  Keyed by
        tree_key alone; a second queued update for the same entry is CRDT-
        merged into the pending one, never overwritten."""
        key = entry.tree_key()
        cur = tx.get(self.insert_queue.tree, key)
        if cur is not None:
            pending = self.decode_entry(cur)
            pending.merge(entry)
            entry = pending
        self.insert_queue.tx_insert(tx, key, entry.encode())
        tx.on_commit(self.insert_queue_notify.set)

    # --- counts ---

    def store_len(self) -> int:
        return len(self.store)

    def merkle_todo_len(self) -> int:
        return len(self.merkle_todo)

    def gc_todo_len(self) -> int:
        return len(self.gc_todo)


def gc_todo_key(ts_ms: int, tk: bytes) -> bytes:
    """gc_todo key = 8-byte BE tombstone timestamp ‖ tree key
    (ref gc.rs:340-407)."""
    return struct.pack(">Q", ts_ms) + tk


def parse_gc_todo_key(k: bytes) -> Tuple[int, bytes]:
    return struct.unpack(">Q", k[:8])[0], k[8:]


def _prefix_upper_bound(prefix: bytes) -> Optional[bytes]:
    """Smallest byte string greater than every string with this prefix."""
    b = bytearray(prefix)
    while b:
        if b[-1] != 0xFF:
            b[-1] += 1
            return bytes(b)
        b.pop()
    return None
