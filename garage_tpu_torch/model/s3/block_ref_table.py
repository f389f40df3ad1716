"""Block reference table — the metadata→block-layer coupling point.

Equivalent of reference src/model/s3/block_ref_table.rs:12-86: P = block
hash, S = version uuid, with an or-merged deleted flag; the `updated()`
hook calls `block_incref`/`block_decref` on the block manager inside the
same transaction, so block refcounts exactly track live references.
"""

from __future__ import annotations

from typing import Any, Optional

from ...table.schema import Entry, TableSchema
from ...utils.crdt import CrdtBool
from ...utils.data import Hash, Uuid


class BlockRef(Entry):
    VERSION_MARKER = b"GT01blockref"

    def __init__(self, block: Hash, version: Uuid, deleted: bool = False):
        self.block = block
        self.version = version
        self.deleted = CrdtBool(deleted)

    @property
    def partition_key(self) -> Hash:
        return self.block

    @property
    def sort_key(self) -> bytes:
        return bytes(self.version)

    def is_tombstone(self) -> bool:
        return self.deleted.value

    def merge(self, other: "BlockRef") -> None:
        self.deleted.merge(other.deleted)

    def fields(self) -> Any:
        return [bytes(self.block), bytes(self.version), self.deleted.value]

    @classmethod
    def from_fields(cls, b: Any) -> "BlockRef":
        return cls(Hash(bytes(b[0])), Uuid(bytes(b[1])), bool(b[2]))


class BlockRefTableSchema(TableSchema):
    TABLE_NAME = "block_ref"
    ENTRY = BlockRef

    def __init__(self, block_manager=None):
        self.block_manager = block_manager
        # set by Garage when distributed parity is on: fired (post-commit)
        # with the block hash when a LIVE version-ref transitions to dead —
        # the receiver checks whether any live version-ref remains and
        # tombstones the block's parity-index rows if not.  This is the
        # GLOBAL deletion signal; a node deleting its local copy during
        # migration/offload must never GC cluster-wide parity state.
        self.on_ref_dropped = None

    def updated(self, tx, old: Optional[BlockRef], new: Optional[BlockRef]) -> None:
        """ref block_ref_table.rs:65-81."""
        if self.block_manager is None:
            return
        ent = old or new
        block = ent.block
        was = old is not None and not old.deleted.value
        now = new is not None and not new.deleted.value
        if now and not was:
            self.block_manager.block_incref(tx, block)
        if was and not now:
            self.block_manager.block_decref(tx, block)
            # Global-deletion signal: only a LOGICAL tombstone (new row
            # with deleted=True) means the reference is gone cluster-wide.
            # new=None is PHYSICAL removal — partition offload after a
            # layout change, or tombstone GC — and says nothing about
            # liveness; firing there tombstoned (stickily) the parity
            # index of blocks that were merely migrating.
            if (self.on_ref_dropped is not None and new is not None
                    and new.deleted.value):
                from ..parity_index_table import is_parity_ref

                if not is_parity_ref(ent.version):
                    cb, h = self.on_ref_dropped, block
                    tx.on_commit(lambda: cb(h))

    def matches_filter(self, entry: BlockRef, filter: Any) -> bool:
        from ...table.schema import DeletedFilter

        if filter is None:
            return not entry.deleted.value
        return DeletedFilter.matches(filter, entry.deleted.value)
