"""Multipart upload table.

Equivalent of reference src/model/s3/mpu_table.rs (SURVEY.md §2.6):
P = upload uuid; parts are a grow-only map (part_number, timestamp) →
{version uuid, etag, size}, where each part's data lives in its own
Version row.  Deleting the upload clears parts and the `updated()` hook
tombstones every part version (mpu_table.rs parts → version deletions).
Counted per-bucket: uploads / parts / bytes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ...table.schema import Entry, TableSchema
from ...utils.crdt import CrdtBool
from ...utils.data import Uuid

UPLOADS = "uploads"
PARTS = "parts"
BYTES_MPU = "bytes"


class MpuPart:
    """{version, etag, size} — dict carrier (ref mpu_table.rs MpuPart)."""

    @staticmethod
    def new(version: bytes, etag: Optional[str], size: Optional[int]) -> Dict:
        return {"version": bytes(version), "etag": etag, "size": size}


def _merge_part(a: Dict, b: Dict) -> Dict:
    # parts are atomic {version, etag, size}; prefer a completed part
    # (etag set), then a deterministic max tie-break so concurrent
    # same-key registrations converge on every replica (commutative,
    # like the reference's AutoCrdt max-merge on MpuPart)
    a_done = a.get("etag") is not None
    b_done = b.get("etag") is not None
    if a_done != b_done:
        return dict(a) if a_done else dict(b)
    ka = (bytes(a["version"]), a.get("etag") or "", a.get("size") or 0)
    kb = (bytes(b["version"]), b.get("etag") or "", b.get("size") or 0)
    return dict(a) if ka >= kb else dict(b)


class MultipartUpload(Entry):
    VERSION_MARKER = b"GT01mpu"

    def __init__(
        self,
        upload_id: Uuid,
        timestamp: int,
        bucket_id: bytes,
        key: str,
        deleted: bool = False,
        parts: Optional[Dict[Tuple[int, int], Dict]] = None,
    ):
        self.upload_id = upload_id
        self.timestamp = timestamp
        self.bucket_id = bytes(bucket_id)
        self.key = key
        self.deleted = CrdtBool(deleted)
        # (part_number, timestamp) → MpuPart
        self.parts: Dict[Tuple[int, int], Dict] = parts or {}
        if deleted:
            self.parts = {}

    @property
    def partition_key(self) -> Uuid:
        return self.upload_id

    @property
    def sort_key(self) -> str:
        return ""

    def is_tombstone(self) -> bool:
        return self.deleted.value

    def sorted_parts(self) -> List[Tuple[Tuple[int, int], Dict]]:
        return sorted(self.parts.items())

    def part_for(self, part_number: int) -> Optional[Dict]:
        """Latest registered part for this part number (re-uploads of the
        same part number supersede by timestamp)."""
        best = None
        for (pn, ts), p in self.parts.items():
            if pn == part_number and (best is None or ts > best[0]):
                best = (ts, p)
        return best[1] if best else None

    def merge(self, other: "MultipartUpload") -> None:
        self.deleted.merge(other.deleted)
        if self.deleted.value:
            self.parts = {}
            return
        for k, v in other.parts.items():
            mine = self.parts.get(k)
            self.parts[k] = v if mine is None else _merge_part(mine, v)

    def counts(self) -> List[Tuple[str, int]]:
        if self.deleted.value:
            return [(UPLOADS, 0), (PARTS, 0), (BYTES_MPU, 0)]
        return [
            (UPLOADS, 1),
            (PARTS, len(self.parts)),
            (BYTES_MPU, sum(p["size"] or 0 for p in self.parts.values())),
        ]

    def fields(self) -> Any:
        return [
            bytes(self.upload_id),
            self.timestamp,
            self.bucket_id,
            self.key,
            self.deleted.value,
            [[list(k), [v["version"], v["etag"], v["size"]]] for k, v in self.sorted_parts()],
        ]

    @classmethod
    def from_fields(cls, b: Any) -> "MultipartUpload":
        return cls(
            Uuid(bytes(b[0])),
            int(b[1]),
            bytes(b[2]),
            b[3],
            deleted=bool(b[4]),
            parts={
                (int(k[0]), int(k[1])): {"version": bytes(v[0]), "etag": v[1], "size": v[2]}
                for k, v in b[5]
            },
        )


class MpuTableSchema(TableSchema):
    TABLE_NAME = "multipart_upload"
    ENTRY = MultipartUpload

    def __init__(self, version_table=None, counter=None):
        self.version_table = version_table
        self.counter = counter

    def updated(self, tx, old: Optional[MultipartUpload], new: Optional[MultipartUpload]) -> None:
        from .version_table import Version

        if self.counter is not None:
            self.counter.count(
                tx,
                bytes((old or new).bucket_id),
                "",
                old.counts() if old is not None else [],
                new.counts() if new is not None else [],
            )
        if (
            self.version_table is not None
            and old is not None
            and new is not None
            and new.deleted.value
            and not old.deleted.value
        ):
            # tombstone every part version (ref mpu_table.rs updated)
            for (_k, part) in old.sorted_parts():
                vdel = Version(
                    Uuid(part["version"]),
                    old.bucket_id,
                    old.key,
                    deleted=True,
                    mpu_upload_id=bytes(old.upload_id),
                )
                self.version_table.data.queue_insert(tx, vdel)

    def matches_filter(self, entry: MultipartUpload, filter: Any) -> bool:
        from ...table.schema import DeletedFilter

        if filter is None:
            return not entry.deleted.value
        return DeletedFilter.matches(filter, entry.deleted.value)
