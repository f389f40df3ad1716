"""Table replication strategies — which nodes store which partition.

Equivalent of reference src/table/replication/ (SURVEY.md §2.4): the
`TableReplication` interface (parameters.rs:1-33) with the sharded
strategy (ring-based, sharded.rs:16-53) and the full-copy strategy
(all nodes, epidemic writes, local reads, fullcopy.rs:14-50).

These are the storage-domain analogue of an ML stack's parallelism
strategies: they decide data placement and the quorum collective pattern.
"""

from __future__ import annotations

from typing import List, Tuple

from ..rpc.ring import N_PARTITIONS, partition_range
from ..rpc.system import System
from ..utils.data import FixedBytes32, Hash

ALL_ZEROS = Hash(b"\x00" * 32)


class TableReplication:
    """ref table/replication/parameters.rs:1-33."""

    def read_nodes(self, h: Hash) -> List[FixedBytes32]:
        raise NotImplementedError

    def read_quorum(self) -> int:
        raise NotImplementedError

    def write_nodes(self, h: Hash) -> List[FixedBytes32]:
        raise NotImplementedError

    def write_quorum(self) -> int:
        raise NotImplementedError

    def max_write_errors(self) -> int:
        raise NotImplementedError

    def partition_of(self, h: Hash) -> int:
        raise NotImplementedError

    def partitions(self) -> List[Tuple[int, Hash]]:
        """All (partition, first_hash) pairs of the keyspace."""
        raise NotImplementedError


class TableShardedReplication(TableReplication):
    """Partitioned replication over the ring (ref sharded.rs:16-53)."""

    def __init__(
        self,
        system: System,
        replication_factor: int,
        read_quorum: int,
        write_quorum: int,
    ):
        self.system = system
        self.replication_factor = replication_factor
        self._read_quorum = read_quorum
        self._write_quorum = write_quorum

    def read_nodes(self, h: Hash) -> List[FixedBytes32]:
        return self.system.ring.get_nodes(bytes(h), self.replication_factor)

    def read_quorum(self) -> int:
        return self._read_quorum

    def write_nodes(self, h: Hash) -> List[FixedBytes32]:
        return self.system.ring.get_nodes(bytes(h), self.replication_factor)

    def write_quorum(self) -> int:
        return self._write_quorum

    def max_write_errors(self) -> int:
        return self.replication_factor - self._write_quorum

    def partition_of(self, h: Hash) -> int:
        return self.system.ring.partition_of(bytes(h))

    def partitions(self) -> List[Tuple[int, Hash]]:
        return self.system.ring.partitions()


class TableFullReplication(TableReplication):
    """All nodes store everything; reads are local; writes go everywhere
    tolerating `max_faults` failures (ref fullcopy.rs:14-50)."""

    def __init__(self, system: System, max_faults: int = 0):
        self.system = system
        self.max_faults = max_faults

    def _all_nodes(self) -> List[FixedBytes32]:
        nodes = [FixedBytes32(n) for n in self.system.layout.all_nodes()]
        if not nodes:
            nodes = [self.system.id]
        return nodes

    def read_nodes(self, h: Hash) -> List[FixedBytes32]:
        return [self.system.id]

    def read_quorum(self) -> int:
        return 1

    def write_nodes(self, h: Hash) -> List[FixedBytes32]:
        return self._all_nodes()

    def write_quorum(self) -> int:
        n = len(self._all_nodes())
        return n - self.max_faults if n > self.max_faults else 1

    def max_write_errors(self) -> int:
        return self.max_faults

    def partition_of(self, h: Hash) -> int:
        return 0

    def partitions(self) -> List[Tuple[int, Hash]]:
        return [(0, ALL_ZEROS)]


__all__ = [
    "TableReplication",
    "TableShardedReplication",
    "TableFullReplication",
    "N_PARTITIONS",
    "partition_range",
]
