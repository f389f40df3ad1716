"""Ring — the partition table derived from the cluster layout.

Equivalent of reference src/rpc/ring.rs: 2^8 partitions keyed by the top
bits of the 256-bit item hash (PARTITION_BITS=8, ring.rs:20); each ring
entry lists the nodes of that partition (ring.rs:53-61); `get_nodes(hash,
n)` returns the first n replicas (ring.rs:131-153).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..utils.data import FixedBytes32, Hash
from .layout import N_PARTITIONS, ClusterLayout

PARTITION_BITS = 8
assert N_PARTITIONS == 1 << PARTITION_BITS


def partition_of(h: bytes) -> int:
    """Top PARTITION_BITS bits of the hash → partition index."""
    return h[0]


def partition_prefix(partition: int) -> bytes:
    """First bytes of the hash range covered by this partition — used as
    the boundary key for per-partition Merkle trees and sync ranges."""
    return bytes([partition])


def partition_range(partition: int) -> Tuple[Hash, Optional[Hash]]:
    """[first_hash, last_hash) of the partition (ref ring.rs partition
    boundaries); end is None for the last partition."""
    first = Hash(bytes([partition]) + b"\x00" * 31)
    if partition == N_PARTITIONS - 1:
        return first, None
    return first, Hash(bytes([partition + 1]) + b"\x00" * 31)


# (index, first hash) of every partition: immutable values, shared
_ALL_PARTITIONS = tuple((p, partition_range(p)[0])
                        for p in range(N_PARTITIONS))


class Ring:
    """Immutable view: layout version → partition → replica nodes
    (ref ring.rs:64-97)."""

    def __init__(self, layout: ClusterLayout):
        self.layout = layout
        self.replication_factor = layout.replication_factor
        f = layout.replication_factor
        self._partitions: List[List[bytes]] = []
        if (
            layout.ring_assignment_data
            and len(layout.ring_assignment_data) == N_PARTITIONS * f
        ):
            for p in range(N_PARTITIONS):
                nodes = layout.partition_nodes(p)
                # Rotate each partition's replica list by the partition
                # index: the optimizer balances the replica SETS but not
                # their order, and with full-factor writes order never
                # mattered — every set member stores a copy.  Under
                # data_replication_mode with a smaller data factor the
                # FIRST entries are load-bearing (they are the only
                # storage nodes), and unrotated lists concentrated every
                # primary on a couple of nodes (measured: 3 equal nodes →
                # 256/256 primaries on one).  The rotation is a pure
                # function of (partition, set) so every node agrees.
                if nodes:
                    r = p % len(nodes)
                    nodes = nodes[r:] + nodes[:r]
                self._partitions.append(nodes)
        else:
            self._partitions = [[] for _ in range(N_PARTITIONS)]

    def digest(self) -> bytes:
        """16-byte digest of the effective partition assignment — stable
        across re-decodes of the same layout, changed by any assignment
        change.  Used by the layout-sweep marker (block/repair.py) to
        detect ring changes a node missed while down."""
        import hashlib

        h = hashlib.blake2s(digest_size=16)
        for nodes in self._partitions:
            for n in nodes:
                h.update(bytes(n))
            h.update(b"|")
        return h.digest()

    @property
    def ready(self) -> bool:
        return bool(self._partitions[0])

    def partition_of(self, position: bytes) -> int:
        return partition_of(position)

    def get_nodes(self, position: bytes, n: int) -> List[FixedBytes32]:
        """Replica nodes for the item at `position` (ref ring.rs:131-153)."""
        nodes = self._partitions[partition_of(position)]
        if not nodes:
            return []
        if n > len(nodes):
            n = len(nodes)
        return [FixedBytes32(x) for x in nodes[:n]]

    def partitions(self) -> List[Tuple[int, Hash]]:
        """All (partition index, first hash) pairs (ref ring.rs partitions).
        A copy of one prebuilt table: after a layout change every table's
        syncer asks for it once per partition it offloads, so building
        256 hashes per call cost whole seconds of the event loop on a
        24-node in-process cluster."""
        return list(_ALL_PARTITIONS)

    def partition_nodes(self, partition: int) -> List[FixedBytes32]:
        return [FixedBytes32(x) for x in self._partitions[partition]]
