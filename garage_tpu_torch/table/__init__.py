"""Replicated CRDT table engine.

Equivalent of reference src/table/ (SURVEY.md §2.4): a generic table of
CRDT entries addressed by (partition key, sort key), replicated over the
cluster with quorum reads/writes, Merkle-tree anti-entropy, distributed
tombstone GC and an async insert queue.  Entry encodings, tree names and
Merkle node bytes are the reference package's, so a row written by one
package decodes in the other.
"""

from .schema import Entry, TableSchema, hash_partition_key, tree_key
from .replication import (
    TableFullReplication,
    TableReplication,
    TableShardedReplication,
)
from .data import TableData
from .table import Table
from .merkle import MerkleUpdater, MerkleWorker
from .sync import TableSyncer
from .gc import TableGc
from .queue import InsertQueueWorker

__all__ = [
    "Entry",
    "TableSchema",
    "hash_partition_key",
    "tree_key",
    "TableReplication",
    "TableShardedReplication",
    "TableFullReplication",
    "TableData",
    "Table",
    "MerkleUpdater",
    "MerkleWorker",
    "TableSyncer",
    "TableGc",
    "InsertQueueWorker",
]
