"""Version table — block lists of object versions.

Equivalent of reference src/model/s3/version_table.rs (SURVEY.md §2.6):
P = version uuid; the row maps (part_number, offset) → (block hash, size)
plus per-part etags, with a deletion flag that clears the maps on merge
(version_table.rs:14-160).  The `updated()` hook marks every referenced
block's BlockRef deleted when the version is deleted (version_table.rs:259+)
— the step that eventually drops block refcounts.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ...table.schema import Entry, TableSchema
from ...utils.crdt import CrdtBool
from ...utils.data import Hash, Uuid


class VersionBlockKey:
    """(part_number, offset) — ordering = block order in the object."""

    @staticmethod
    def key(part_number: int, offset: int) -> Tuple[int, int]:
        return (part_number, offset)


class VersionBlock:
    """{hash, size} (ref version_table.rs:60-68). Tuple carrier (hash, size)."""

    @staticmethod
    def new(hash32: bytes, size: int) -> Tuple[bytes, int]:
        return (bytes(hash32), size)


class Version(Entry):
    """ref version_table.rs:14-160."""

    VERSION_MARKER = b"GT01version"

    def __init__(
        self,
        uuid: Uuid,
        bucket_id: bytes,
        key: str,
        deleted: bool = False,
        blocks: Optional[Dict[Tuple[int, int], Tuple[bytes, int]]] = None,
        parts_etags: Optional[Dict[int, str]] = None,
        mpu_upload_id: Optional[bytes] = None,
    ):
        self.uuid = uuid
        # backlink (ref VersionBacklink): object (bucket,key) or the MPU id
        self.bucket_id = bytes(bucket_id)
        self.key = key
        self.mpu_upload_id = mpu_upload_id
        self.deleted = CrdtBool(deleted)
        # (part_number, offset) → (hash, size); grow-only until deleted
        self.blocks: Dict[Tuple[int, int], Tuple[bytes, int]] = blocks or {}
        self.parts_etags: Dict[int, str] = parts_etags or {}
        if deleted:
            self.blocks, self.parts_etags = {}, {}

    @classmethod
    def new(cls, uuid: Uuid, bucket_id: bytes, key: str, deleted: bool = False) -> "Version":
        return cls(uuid, bucket_id, key, deleted=deleted)

    @property
    def partition_key(self) -> Uuid:
        return self.uuid

    @property
    def sort_key(self) -> str:
        return ""

    def is_tombstone(self) -> bool:
        return self.deleted.value

    def sorted_blocks(self) -> List[Tuple[Tuple[int, int], Tuple[bytes, int]]]:
        return sorted(self.blocks.items())

    def total_size(self) -> int:
        return sum(sz for (_h, sz) in self.blocks.values())

    def add_block(self, part_number: int, offset: int, hash32: bytes, size: int) -> None:
        if not self.deleted.value:
            self.blocks[(part_number, offset)] = (bytes(hash32), size)

    def merge(self, other: "Version") -> None:
        self.deleted.merge(other.deleted)
        if self.deleted.value:
            self.blocks, self.parts_etags = {}, {}
            return
        for k, v in other.blocks.items():
            mine = self.blocks.get(k)
            # values are deterministic for a given key; max-merge breaks ties
            self.blocks[k] = v if mine is None or v > mine else mine
        for p, e in other.parts_etags.items():
            mine_e = self.parts_etags.get(p)
            self.parts_etags[p] = e if mine_e is None or e > mine_e else mine_e

    def fields(self) -> Any:
        return [
            bytes(self.uuid),
            self.bucket_id,
            self.key,
            self.deleted.value,
            [[list(k), [v[0], v[1]]] for k, v in self.sorted_blocks()],
            sorted(self.parts_etags.items()),
            self.mpu_upload_id,
        ]

    @classmethod
    def from_fields(cls, b: Any) -> "Version":
        return cls(
            Uuid(bytes(b[0])),
            bytes(b[1]),
            b[2],
            deleted=bool(b[3]),
            blocks={(int(k[0]), int(k[1])): (bytes(v[0]), int(v[1])) for k, v in b[4]},
            parts_etags={int(p): e for p, e in b[5]},
            mpu_upload_id=bytes(b[6]) if b[6] is not None else None,
        )


class VersionTableSchema(TableSchema):
    TABLE_NAME = "version"
    ENTRY = Version

    def __init__(self, block_ref_table=None):
        self.block_ref_table = block_ref_table

    def updated(self, tx, old: Optional[Version], new: Optional[Version]) -> None:
        """ref version_table.rs updated(): deleting a version deletes all
        its block refs; blocks added to a live version insert live refs."""
        from .block_ref_table import BlockRef

        if self.block_ref_table is None:
            return
        if old is not None and new is not None and new.deleted.value and not old.deleted.value:
            for (_k, (h, _sz)) in old.sorted_blocks():
                self.block_ref_table.data.queue_insert(
                    tx, BlockRef(Hash(h), old.uuid, deleted=True)
                )
        elif new is not None and not new.deleted.value:
            old_blocks = set(h for (h, _s) in (old.blocks.values() if old else []))
            for (h, _sz) in new.blocks.values():
                if h not in old_blocks:
                    self.block_ref_table.data.queue_insert(
                        tx, BlockRef(Hash(h), new.uuid, deleted=False)
                    )

    def matches_filter(self, entry: Version, filter: Any) -> bool:
        from ...table.schema import DeletedFilter

        if filter is None:
            return not entry.deleted.value
        return DeletedFilter.matches(filter, entry.deleted.value)
