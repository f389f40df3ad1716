"""Replicated CRDT table engine — the part the block store needs.

Equivalent of reference src/table/ (SURVEY.md §2.4).  The port holds the
replication strategies (which nodes store which partition); the table
engine itself (schema, data, Merkle sync, GC, insert queue) is not
ported yet.
"""

from .replication import (
    TableFullReplication,
    TableReplication,
    TableShardedReplication,
)

__all__ = [
    "TableReplication",
    "TableShardedReplication",
    "TableFullReplication",
]
