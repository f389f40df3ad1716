"""Distributed sharded index counters.

Equivalent of reference src/model/index_counter.rs (SURVEY.md §2.6):
per-bucket statistics (objects / bytes / unfinished uploads, MPU parts…)
are maintained as a transactional local counter tree on each node plus a
replicated `CounterTable` whose rows hold one (timestamp, value) pair per
node, merged max-timestamp per node (index_counter.rs:86-136).  The total
is the sum over nodes.  Propagation to the counter table rides the table
engine's insert queue (the reference uses a dedicated propagator worker,
index_counter.rs:252+ — same semantics, batched async push).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

from ..table.schema import Entry, TableSchema, tree_key
from ..utils.crdt import now_msec
from ..utils.migrate import pack, unpack

logger = logging.getLogger("garage_tpu_torch.model.counter")


class CounterEntry(Entry):
    """P = counted partition (e.g. bucket uuid bytes), S = "".
    values: name → {node_id(bytes) → [ts, value]}."""

    VERSION_MARKER = b"GT01counter"

    def __init__(self, pk: bytes, sk: str, values: Optional[Dict[str, Dict[bytes, List[int]]]] = None):
        self.pk = bytes(pk)
        self.sk = sk
        self.values = values or {}

    @property
    def partition_key(self) -> bytes:
        return self.pk

    @property
    def sort_key(self) -> str:
        return self.sk

    def merge(self, other: "CounterEntry") -> None:
        for name, nodes in other.values.items():
            mine = self.values.setdefault(name, {})
            for node, tv in nodes.items():
                cur = mine.get(node)
                if cur is None or tv[0] > cur[0]:
                    mine[node] = list(tv)

    def totals(self, node_filter: Optional[List[bytes]] = None) -> Dict[str, int]:
        """Max per-node value (every replica counts the same rows — ref
        index_counter.rs:86-111 filtered_values takes max over layout
        nodes, not sum)."""
        out: Dict[str, int] = {}
        for name, nodes in self.values.items():
            vals = [
                v
                for n, (_ts, v) in nodes.items()
                if node_filter is None or n in node_filter
            ]
            if vals:
                out[name] = max(vals)
        return out

    def is_tombstone(self) -> bool:
        return all(
            v == 0 for nodes in self.values.values() for (_ts, v) in nodes.values()
        )

    def fields(self) -> Any:
        return [
            self.pk,
            self.sk,
            [
                [name, sorted([[n, tv[0], tv[1]] for n, tv in nodes.items()])]
                for name, nodes in sorted(self.values.items())
            ],
        ]

    @classmethod
    def from_fields(cls, b: Any) -> "CounterEntry":
        return cls(
            bytes(b[0]),
            b[1],
            {
                name: {bytes(n): [ts, v] for n, ts, v in nodes}
                for name, nodes in b[2]
            },
        )


def counter_table_schema(name: str):
    """Schema factory: one counter table per counted table (ref
    index_counter.rs COUNTER_TABLE_NAME)."""

    class _CounterSchema(TableSchema):
        TABLE_NAME = name
        ENTRY = CounterEntry

        def matches_filter(self, entry, filter):
            return True

    return _CounterSchema()


class IndexCounter:
    """Local accumulation + async propagation (ref index_counter.rs:165-250)."""

    def __init__(self, system, counter_table, db):
        self.system = system
        self.table = counter_table
        name = counter_table.schema.TABLE_NAME
        self.local_counter = db.open_tree(f"{name}:local")

    def count(
        self,
        tx,
        pk: bytes,
        sk: str,
        old_counts: List[Tuple[str, int]],
        new_counts: List[Tuple[str, int]],
    ) -> None:
        """Apply count deltas inside the counted table's update transaction
        (ref index_counter.rs:202-250)."""
        old_d = dict(old_counts)
        new_d = dict(new_counts)
        deltas = {
            n: new_d.get(n, 0) - old_d.get(n, 0)
            for n in set(old_d) | set(new_d)
            if new_d.get(n, 0) - old_d.get(n, 0) != 0
        }
        if not deltas:
            return
        tk = tree_key(pk, sk)
        cur = tx.get(self.local_counter, tk)
        local = _decode_local(cur)
        ts = now_msec()
        for name, delta in deltas.items():
            ent = local.get(name)
            if ent is None:
                local[name] = [ts, delta]
            else:
                local[name] = [max(ts, ent[0] + 1), ent[1] + delta]
        # the value carries (pk, sk) so offline recount can rebuild the
        # CounterEntry from the row alone (ref index_counter.rs
        # LocalCounterEntry { pk, sk, values })
        tx.insert(self.local_counter, tk, pack([pk, sk, local]))
        # propagate this node's totals through the insert queue
        node = bytes(self.system.id)
        ce = CounterEntry(
            pk, sk, {name: {node: list(tv)} for name, tv in local.items()}
        )
        self.table.data.queue_insert(tx, ce)

    async def get_totals(self, pk: bytes, sk: str = "") -> Dict[str, int]:
        ent = await self.table.get(pk, sk)
        if ent is None:
            return {}
        # filter to nodes still in the layout so departed nodes' stale
        # maxima don't inflate counts forever (ref index_counter.rs:86-90)
        current = [bytes(n) for n in self.system.layout.all_nodes()]
        return ent.totals(node_filter=current or None)

    def local_totals(self, pk: bytes, sk: str = "") -> Dict[str, int]:
        cur = self.local_counter.get(tree_key(pk, sk))
        if cur is None:
            return {}
        return {name: tv[1] for name, tv in _decode_local(cur).items()}

    # --- offline repair (ref index_counter.rs:252-377) ---

    def offline_recount_all(self, counted_table, counter_key) -> Tuple[int, int]:
        """Rebuild every local counter from the counted table's local rows.

        Two passes, mirroring the reference: (1) zero every existing local
        counter with a bumped timestamp (so the zero wins the per-node max-
        timestamp merge everywhere), (2) walk the counted table's store and
        re-accumulate each entry's counts.  Both passes queue propagation
        of this node's totals; the insert-queue worker pushes them when the
        daemon next runs.  MUST run offline — concurrent table updates
        between the passes would be double- or un-counted.

        `counter_key(entry) -> (pk, sk)` maps a counted entry to its
        counter row (bucket id for objects/MPUs; (bucket, partition) for
        K2V).  Returns (n_zeroed, n_recounted_entries).
        """
        db = self.local_counter.db
        node = bytes(self.system.id)
        now = now_msec()
        n_zeroed = 0

        # pass 1: zero old counters
        cursor = b""
        while True:
            batch = []
            k = cursor
            while len(batch) < RECOUNT_BATCH:
                nxt = self.local_counter.get_gt(k)
                if nxt is None:
                    break
                batch.append(nxt)
                k = nxt[0]
            if not batch:
                break
            cursor = batch[-1][0]

            def zero_batch(tx, batch=batch):
                for tk, v in batch:
                    pk, sk, local = _decode_local_full(v)
                    for name, tv in local.items():
                        local[name] = [max(tv[0] + 1, now), 0]
                    tx.insert(self.local_counter, tk, pack([pk, sk, local]))
                    if pk is not None:
                        ce = CounterEntry(pk, sk, {
                            name: {node: list(tv)}
                            for name, tv in local.items()
                        })
                        self.table.data.queue_insert(tx, ce)

            db.transaction(zero_batch)
            n_zeroed += len(batch)

        # pass 2: recount from the counted table's rows
        n_entries = 0
        store = counted_table.data.store
        cursor = b""
        while True:
            batch = []
            k = cursor
            while len(batch) < RECOUNT_BATCH:
                nxt = store.get_gt(k)
                if nxt is None:
                    break
                batch.append(nxt)
                k = nxt[0]
            if not batch:
                break
            cursor = batch[-1][0]
            # aggregate within the batch to one write per counter row
            agg: Dict[bytes, Tuple[bytes, str, Dict[str, int]]] = {}
            for _k, raw in batch:
                ent = counted_table.data.decode_entry(raw)
                pk, sk = counter_key(ent)
                tk = tree_key(pk, sk)
                slot = agg.setdefault(tk, (bytes(pk), sk, {}))
                for name, v in ent.counts():
                    slot[2][name] = slot[2].get(name, 0) + v
                n_entries += 1

            def add_batch(tx, agg=agg):
                ts = now_msec()
                for tk, (pk, sk, counts) in agg.items():
                    cur = tx.get(self.local_counter, tk)
                    local = _decode_local(cur)
                    for name, v in counts.items():
                        ent = local.get(name)
                        if ent is None:
                            local[name] = [max(ts, now + 1), v]
                        else:
                            local[name] = [max(ts, ent[0] + 1), ent[1] + v]
                    tx.insert(self.local_counter, tk, pack([pk, sk, local]))
                    ce = CounterEntry(pk, sk, {
                        name: {node: list(tv)} for name, tv in local.items()
                    })
                    self.table.data.queue_insert(tx, ce)

            db.transaction(add_batch)

        logger.info(
            "counter recount (%s): zeroed %d rows, recounted %d entries",
            self.table.schema.TABLE_NAME, n_zeroed, n_entries,
        )
        return n_zeroed, n_entries


RECOUNT_BATCH = 1000  # ref index_counter.rs recount batches


def _decode_local(cur: Optional[bytes]) -> Dict[str, List[int]]:
    """Value → {name: [ts, v]}, accepting the legacy bare-dict format."""
    if cur is None:
        return {}
    v = unpack(cur)
    if isinstance(v, dict):
        return v  # legacy rows without (pk, sk)
    return v[2]


def _decode_local_full(cur: bytes):
    """Value → (pk | None, sk, {name: [ts, v]})."""
    v = unpack(cur)
    if isinstance(v, dict):
        return None, "", v
    return bytes(v[0]), v[1], v[2]
