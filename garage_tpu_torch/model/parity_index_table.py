"""Cross-node parity index — the lookup that makes RS survive NODE loss.

The reference's only durability axis is replication
(ref src/rpc/replication_mode.rs:41-56: 3× storage tolerates 2 node
losses).  Local parity sidecars (block/parity.py) already survive
corruption, but a node that dies takes its blocks AND their sidecars
down together.  Distributed parity closes that hole the cheap way:

  - each RS(k, m) parity shard is stored as an ordinary refcounted BLOCK
    (content-hashed, placed by the ring on OTHER nodes, fetched with
    rpc_get_block, scrubbed/resynced like any block — zero new storage
    machinery);
  - this table maps every MEMBER block hash → its codeword: the entry is
    sharded by member hash, so the nodes that would store block h also
    hold the h → codeword record.  A node repairing h reads the entry,
    fetches ≥ k surviving pieces (members + parity blocks) from across
    the cluster, and decodes just the missing row.

Economics vs the reference: replication "none" + RS(8,4) distributed
parity stores 1.5× the data and tolerates the loss of any m = 4 of the
codeword's nodes; the reference's mode "3" stores 3× and tolerates 2.

Entry CRDT: LWW by (timestamp, parity hashes) with an or-merged deleted
flag — a codeword is immutable once encoded (its gid hashes the member
set and geometry), so conflicting writes only ever race identical
content or a newer re-encode of the same member.
"""

from __future__ import annotations

from typing import Any, List, Optional

from ..table.schema import Entry, TableSchema
from ..utils.crdt import CrdtBool
from ..utils.data import Hash


class ParityIndexEntry(Entry):
    VERSION_MARKER = b"GT01parityidx"

    def __init__(self, member: Hash, gid: Hash, timestamp: int,
                 k: int, m: int, member_index: int,
                 members: List[bytes], lengths: List[int],
                 parity_hashes: List[bytes], deleted: bool = False):
        self.member = member
        self.gid = gid
        self.timestamp = timestamp
        self.k = k
        self.m = m
        self.member_index = member_index
        self.members = [bytes(x) for x in members]
        self.lengths = [int(n) for n in lengths]
        self.parity_hashes = [bytes(x) for x in parity_hashes]
        self.deleted = CrdtBool(deleted)

    @property
    def partition_key(self) -> Hash:
        return self.member

    @property
    def sort_key(self) -> bytes:
        return bytes(self.gid)

    def is_tombstone(self) -> bool:
        return self.deleted.value

    def merge(self, other: "ParityIndexEntry") -> None:
        # newer encode of the same (member, gid) wins; content is
        # deterministic from the gid so ties are identical
        if (other.timestamp, other.parity_hashes) > (
                self.timestamp, self.parity_hashes):
            self.timestamp = other.timestamp
            self.k, self.m = other.k, other.m
            self.member_index = other.member_index
            self.members = other.members
            self.lengths = other.lengths
            self.parity_hashes = other.parity_hashes
        self.deleted.merge(other.deleted)

    def fields(self) -> Any:
        return [bytes(self.member), bytes(self.gid), self.timestamp,
                self.k, self.m, self.member_index, self.members,
                self.lengths, self.parity_hashes, self.deleted.value]

    @classmethod
    def from_fields(cls, b: Any) -> "ParityIndexEntry":
        return cls(Hash(bytes(b[0])), Hash(bytes(b[1])), int(b[2]),
                   int(b[3]), int(b[4]), int(b[5]),
                   [bytes(x) for x in b[6]], [int(n) for n in b[7]],
                   [bytes(x) for x in b[8]], bool(b[9]))


PARITY_REF_MARK = b"GTPC"


def parity_ref_version(gid: Hash) -> bytes:
    """The synthetic 'version' uuid under which a codeword's parity
    blocks are BlockRef'd: recognizably marked so version-existence
    repair scans know these refs answer to the parity index, not the
    version table."""
    return PARITY_REF_MARK + bytes(gid)[4:]


def is_parity_ref(version: bytes) -> bool:
    return bytes(version)[:4] == PARITY_REF_MARK


class ParityIndexTableSchema(TableSchema):
    TABLE_NAME = "parity_index"
    ENTRY = ParityIndexEntry

    def __init__(self, block_ref_table=None):
        self.block_ref_table = block_ref_table

    def updated(self, tx, old: Optional[ParityIndexEntry],
                new: Optional[ParityIndexEntry]) -> None:
        """Parity blocks are refcounted through the ordinary BlockRef
        table (block = parity hash, version = marked gid), exactly like
        version rows drive data-block refs (ref version_table.rs
        pattern).  BlockRef partitions by the PARITY hash, so rc lands on
        the nodes whose data ring actually stores the shard — the
        local-rc invariant the block GC/resync/offload machinery assumes.
        (An earlier design increfed from this hook directly, which put rc
        on the INDEX partition's nodes — sharded by MEMBER hash — where
        no shard lives.)  Only the member-0 row drives refs, or each
        parity block would be ref'd k times per codeword."""
        if self.block_ref_table is None:
            return
        from ..utils.data import Uuid
        from .s3.block_ref_table import BlockRef

        ent = old or new
        if ent.member_index != 0:
            return
        was = old is not None and not old.deleted.value
        now = new is not None and not new.deleted.value
        refv = Uuid(parity_ref_version(ent.gid))
        if now and not was:
            for ph in (new.parity_hashes or []):
                self.block_ref_table.data.queue_insert(
                    tx, BlockRef(Hash(ph), refv))
        elif was and not now and new is not None:
            # Decref ONLY on a logical tombstone (new row with
            # deleted=True).  new=None is PHYSICAL removal — partition
            # offload after a layout change (table/sync.py
            # delete_if_equal) or tombstone GC — and says nothing about
            # cluster-wide liveness.  The deleted BlockRefs queued here
            # are sticky or-merged tombstones that propagate everywhere;
            # firing them on offload would decref and GC live parity
            # blocks cluster-wide, permanently stripping erasure
            # coverage (same hazard block_ref_table.py:74-81 guards).
            for ph in (old.parity_hashes or []):
                self.block_ref_table.data.queue_insert(
                    tx, BlockRef(Hash(ph), refv, deleted=True))
