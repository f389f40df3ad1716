"""K2V item table — DVVS causal multi-value registers.

Equivalent of reference src/model/k2v/item_table.rs:17-223: an item is
keyed P = (bucket uuid, partition key string), S = sort key, and stores a
map writer-node(u64) → DvvsEntry { t_discard, [(ts, value|deleted)] }.
An insert with causal context C discards, per writer, the values C covers
(t ≤ C[writer]) and adds one new (ts, value) under the inserting node; the
CRDT merge keeps the max t_discard and the union of surviving values — so
causally-ordered writes replace, concurrent writes become siblings.
Counters: items / conflicts / values / bytes per bucket partition.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ...table.schema import Entry, TableSchema
from ...utils.data import Uuid
from .causality import CausalContext, node_id64

ENTRIES = "items"
CONFLICTS = "conflicts"
VALUES = "values"
BYTES = "bytes"


class DvvsValue:
    """Value(bytes) | Deleted — encoded as bytes or None."""

    DELETED = None


class DvvsEntry:
    """Per-writer-node state (ref item_table.rs DvvsEntry)."""

    __slots__ = ("t_discard", "values")

    def __init__(self, t_discard: int = 0, values: Optional[List[Tuple[int, Optional[bytes]]]] = None):
        self.t_discard = t_discard
        # [(timestamp, value-bytes | None=deleted)], ts strictly > t_discard
        self.values = values or []

    def max_time(self) -> int:
        return max([self.t_discard] + [t for t, _v in self.values])

    def discard_up_to(self, t: int) -> None:
        if t > self.t_discard:
            self.t_discard = t
            self.values = [(ts, v) for ts, v in self.values if ts > t]

    def merge(self, other: "DvvsEntry") -> None:
        td = max(self.t_discard, other.t_discard)
        merged = {(ts, v if v is None else bytes(v)) for ts, v in self.values}
        merged |= {(ts, v if v is None else bytes(v)) for ts, v in other.values}
        self.t_discard = td
        self.values = sorted(
            [(ts, v) for ts, v in merged if ts > td],
            key=lambda x: (x[0], x[1] is not None, x[1] or b""),
        )

    def pack(self) -> Any:
        return [self.t_discard, [[t, v] for t, v in self.values]]

    @classmethod
    def unpack(cls, b: Any) -> "DvvsEntry":
        return cls(int(b[0]), [(int(t), bytes(v) if v is not None else None) for t, v in b[1]])


class K2VItem(Entry):
    VERSION_MARKER = b"GT01k2vitem"

    def __init__(
        self,
        bucket_id: Uuid,
        partition_key: str,
        sort_key: str,
        items: Optional[Dict[int, DvvsEntry]] = None,
    ):
        self.bucket_id = bucket_id
        self.partition_key_str = partition_key
        self.sort_key_str = sort_key
        self.items: Dict[int, DvvsEntry] = items or {}

    @property
    def partition_key(self) -> tuple:
        # composite partition (ref item_table.rs K2VItemPartition)
        return (bytes(self.bucket_id), self.partition_key_str)

    @property
    def sort_key(self) -> str:
        return self.sort_key_str

    # --- DVVS ops (ref item_table.rs:60-130) ---

    def causal_context(self) -> CausalContext:
        return CausalContext({n: e.max_time() for n, e in self.items.items()})

    def update(
        self,
        this_node: bytes,
        context: Optional[CausalContext],
        value: Optional[bytes],
        ts: Optional[int] = None,
    ) -> int:
        """Apply one insert/delete at this writer node; returns the
        timestamp assigned (ref item_table.rs:75-106)."""
        if context is not None:
            for n, t_seen in context.vector_clock.items():
                e = self.items.get(n)
                if e is not None:
                    e.discard_up_to(t_seen)
        n64 = node_id64(this_node)
        e = self.items.setdefault(n64, DvvsEntry())
        if ts is None:
            ts = e.max_time() + 1
        ts = max(ts, e.max_time() + 1)
        e.values.append((ts, value if value is None else bytes(value)))
        return ts

    def values(self) -> List[Optional[bytes]]:
        """All surviving values (None = delete marker sibling), sorted for
        determinism."""
        out = []
        for _n, e in sorted(self.items.items()):
            out.extend(v for _t, v in e.values)
        return out

    def live_values(self) -> List[bytes]:
        return [v for v in self.values() if v is not None]

    def is_tombstone(self) -> bool:
        # every surviving sibling is a delete marker (ref item_table.rs
        # is_tombstone: all values Deleted)
        return all(v is None for v in self.values())

    def merge(self, other: "K2VItem") -> None:
        for n, e in other.items.items():
            mine = self.items.get(n)
            if mine is None:
                self.items[n] = DvvsEntry(e.t_discard, list(e.values))
            else:
                mine.merge(e)

    def counts(self) -> List[Tuple[str, int]]:
        """ref item_table.rs:480+ counted item."""
        vals = self.values()
        live = [v for v in vals if v is not None]
        ent = 1 if live else 0
        return [
            (ENTRIES, ent),
            (CONFLICTS, 1 if len(vals) > 1 else 0),
            (VALUES, len(live)),
            (BYTES, sum(len(v) for v in live)),
        ]

    def fields(self) -> Any:
        return [
            bytes(self.bucket_id),
            self.partition_key_str,
            self.sort_key_str,
            [[n, e.pack()] for n, e in sorted(self.items.items())],
        ]

    @classmethod
    def from_fields(cls, b: Any) -> "K2VItem":
        return cls(
            Uuid(bytes(b[0])), b[1], b[2],
            {int(n): DvvsEntry.unpack(e) for n, e in b[3]},
        )


class K2VItemTableSchema(TableSchema):
    TABLE_NAME = "k2v_item"
    ENTRY = K2VItem

    def __init__(self, counter=None, subscriptions=None):
        self.counter = counter
        self.subscriptions = subscriptions

    def updated(self, tx, old: Optional[K2VItem], new: Optional[K2VItem]) -> None:
        it = old or new
        if self.counter is not None:
            self.counter.count(
                tx,
                bytes(it.bucket_id),
                it.partition_key_str,
                old.counts() if old is not None else [],
                new.counts() if new is not None else [],
            )
        if self.subscriptions is not None and new is not None:
            # wake long-polls after commit (ref k2v/rpc.rs local_insert →
            # subscription notify)
            tx.on_commit(lambda: self.subscriptions.notify(new))

    def matches_filter(self, entry: K2VItem, filter: Any) -> bool:
        from ...table.schema import DeletedFilter

        has_value = bool(entry.live_values())
        if filter is None:
            return has_value
        if filter == "conflicts_only":
            return len(entry.values()) > 1
        return DeletedFilter.matches(filter, not has_value)
