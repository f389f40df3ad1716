"""Object table — the S3 object metadata rows.

Equivalent of reference src/model/s3/object_table.rs (SURVEY.md §2.6):
an object row (P = bucket uuid, S = object key) holds a list of versions
sorted by (timestamp, uuid); each version's state machine is
Uploading{multipart, headers} → Complete(Inline | FirstBlock) | Aborted
(object_table.rs:20-213).  The CRDT merge unions version lists, merges
states pointwise (Aborted wins; Complete wins over Uploading), then prunes
every version strictly older than the most recent Complete one
(object_table.rs:324-355).  The transactional `updated()` hook propagates
disappearing/aborted versions as Version-table tombstones and feeds the
bucket object counters (object_table.rs:357-518).
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, List, Optional, Tuple

from ...table.schema import Entry, TableSchema
from ...utils.data import Uuid

# counter names (ref object_table.rs:480-518)
OBJECTS = "objects"
UNFINISHED_UPLOADS = "unfinished_uploads"
BYTES = "bytes"


class ObjectVersionHeaders:
    """Headers stored with a version: content-type + other meta headers
    (ref object_table.rs ObjectVersionHeaders). Plain dict carrier."""

    @staticmethod
    def new(content_type: str = "application/octet-stream", other: Optional[Dict[str, str]] = None) -> Dict:
        return {"content_type": content_type, "other": other or {}}


class ObjectVersionMeta:
    """{headers, size, etag} (ref object_table.rs:106-115). Dict carrier."""

    @staticmethod
    def new(headers: Dict, size: int, etag: str) -> Dict:
        return {"headers": headers, "size": size, "etag": etag}


class ObjectVersionData:
    """DeleteMarker | Inline(meta, bytes) | FirstBlock(meta, hash)
    (object_table.rs:117-131)."""

    @staticmethod
    def inline(meta: Dict, data: bytes) -> List:
        return ["inline", meta, data]

    @staticmethod
    def first_block(meta: Dict, hash32: bytes) -> List:
        return ["first_block", meta, bytes(hash32)]

    @staticmethod
    def delete_marker() -> List:
        return ["delete_marker"]


class ObjectVersion:
    """One version of an object (ref object_table.rs:85-213)."""

    __slots__ = ("uuid", "timestamp", "state")

    def __init__(self, uuid: Uuid, timestamp: int, state: List):
        self.uuid = uuid
        self.timestamp = timestamp
        # state: ["uploading", multipart(bool), headers(dict)]
        #      | ["complete", data]   | ["aborted"]
        self.state = state

    @staticmethod
    def uploading(uuid: Uuid, timestamp: int, multipart: bool, headers: Dict) -> "ObjectVersion":
        return ObjectVersion(uuid, timestamp, ["uploading", multipart, headers])

    def sort_key_tuple(self) -> Tuple[int, bytes]:
        # versions are ordered by (timestamp, uuid) (ref object_table.rs:189-198)
        return (self.timestamp, bytes(self.uuid))

    def is_uploading(self, check_multipart: Optional[bool] = None) -> bool:
        return self.state[0] == "uploading" and (
            check_multipart is None or bool(self.state[1]) == check_multipart
        )

    def is_aborted(self) -> bool:
        return self.state[0] == "aborted"

    def is_complete(self) -> bool:
        return self.state[0] == "complete"

    def is_data(self) -> bool:
        """Has actual stored data (complete and not a delete marker)."""
        return self.is_complete() and self.state[1][0] != "delete_marker"

    def data(self) -> Optional[List]:
        return self.state[1] if self.is_complete() else None

    def meta(self) -> Optional[Dict]:
        d = self.data()
        return d[1] if d is not None and d[0] != "delete_marker" else None

    def size(self) -> int:
        m = self.meta()
        return int(m["size"]) if m else 0

    def etag(self) -> str:
        m = self.meta()
        return str(m["etag"]) if m else ""

    def merge_state(self, other: "ObjectVersion") -> None:
        """ref object_table.rs:133-160 ObjectVersionState::merge."""
        a, b = self.state, other.state
        if a[0] == "aborted":
            return
        if b[0] == "aborted":
            self.state = ["aborted"]
        elif b[0] == "complete" and a[0] == "uploading":
            self.state = b
        # complete+complete / uploading+uploading: deterministic content, keep

    def pack(self) -> List:
        return [bytes(self.uuid), self.timestamp, self.state]

    @classmethod
    def unpack(cls, v: List) -> "ObjectVersion":
        st = list(v[2])
        if st[0] == "complete":
            d = list(st[1])
            if d[0] == "delete_marker":
                st[1] = ["delete_marker"]
            elif d[0] == "inline":
                st[1] = ["inline", dict(d[1]), bytes(d[2])]
            else:
                st[1] = ["first_block", dict(d[1]), bytes(d[2])]
        return cls(Uuid(bytes(v[0])), int(v[1]), st)


class Object(Entry):
    """ref object_table.rs:20-83: P = bucket uuid, S = key."""

    VERSION_MARKER = b"GT01object"

    def __init__(self, bucket_id: Uuid, key: str, versions: Optional[List[ObjectVersion]] = None):
        self.bucket_id = bucket_id
        self.key = key
        self._versions: List[ObjectVersion] = versions or []
        self._versions.sort(key=lambda v: v.sort_key_tuple())

    @property
    def partition_key(self) -> Uuid:
        return self.bucket_id

    @property
    def sort_key(self) -> str:
        return self.key

    def versions(self) -> List[ObjectVersion]:
        return self._versions

    def add_version(self, v: ObjectVersion) -> None:
        """Insert preserving (timestamp, uuid) order; merge state if the
        same uuid already exists (ref object_table.rs:60-77)."""
        for mine in self._versions:
            if mine.uuid == v.uuid:
                mine.merge_state(v)
                return
        keys = [x.sort_key_tuple() for x in self._versions]
        self._versions.insert(bisect.bisect_left(keys, v.sort_key_tuple()), v)

    def last_complete_version(self) -> Optional[ObjectVersion]:
        for v in reversed(self._versions):
            if v.is_complete():
                return v
        return None

    def is_tombstone(self) -> bool:
        # a row whose only remaining version is a delete marker carries no
        # data and is GC-able (ref object_table.rs is_tombstone)
        return len(self._versions) == 0 or (
            len(self._versions) == 1
            and self._versions[0].is_complete()
            and not self._versions[0].is_data()
        )

    def merge(self, other: "Object") -> None:
        """ref object_table.rs:324-355."""
        for v in other._versions:
            self.add_version(v)
        # prune: drop everything strictly older than the last complete
        last_complete_i = None
        for i in range(len(self._versions) - 1, -1, -1):
            if self._versions[i].is_complete():
                last_complete_i = i
                break
        if last_complete_i is not None:
            self._versions = self._versions[last_complete_i:]
        # aborted versions are kept only while nothing newer is complete
        # (they still need to propagate); merge of two aborted-only lists
        # keeps them all, which is fine — they carry no data

    def last_data_version(self) -> Optional[ObjectVersion]:
        """Newest complete version that is real data (not a delete marker)."""
        last = self.last_complete_version()
        return last if last is not None and last.is_data() else None

    def counts(self) -> List[Tuple[str, int]]:
        """Counter contributions of this row (ref object_table.rs:480-518)."""
        last = self.last_data_version()
        objects = 1 if last is not None else 0
        nbytes = last.size() if last is not None else 0
        unfinished = sum(1 for v in self._versions if v.is_uploading())
        return [(OBJECTS, objects), (BYTES, nbytes), (UNFINISHED_UPLOADS, unfinished)]

    def fields(self) -> Any:
        return [bytes(self.bucket_id), self.key, [v.pack() for v in self._versions]]

    @classmethod
    def from_fields(cls, b: Any) -> "Object":
        return cls(
            Uuid(bytes(b[0])), b[1], [ObjectVersion.unpack(v) for v in b[2]]
        )


class ObjectTableSchema(TableSchema):
    """ref object_table.rs:357-478 — the updated() hook chain start."""

    TABLE_NAME = "object"
    ENTRY = Object

    def __init__(self, version_table=None, mpu_table=None, counter=None):
        # set post-construction by Garage (circular wiring)
        self.version_table = version_table
        self.mpu_table = mpu_table
        self.counter = counter

    def updated(self, tx, old: Optional[Object], new: Optional[Object]) -> None:
        from .version_table import Version

        if self.counter is not None:
            # counters aggregate per bucket (CP = bucket id, CS = empty —
            # ref object_table.rs CountedItem impl)
            self.counter.count(
                tx,
                bytes((old or new).bucket_id),
                "",
                old.counts() if old is not None else [],
                new.counts() if new is not None else [],
            )
        # Deletion propagation requires BOTH old and new rows (ref
        # object_table.rs:398 `if let (Some(old_v), Some(new_v))`):
        # new=None means a raw LOCAL deletion — partition offload after a
        # layout change (sync.rs offload_partition → delete_if_equal) or
        # GC — where the data still exists on the real replicas.  Treating
        # it as "all versions deleted" would enqueue version tombstones
        # that REPLICATE to the version table's replica set and cascade
        # (version → block_ref → rc → block GC) into cluster-wide data
        # loss on every layout change.
        if old is None or new is None:
            return
        new_by_uuid = {bytes(v.uuid): v for v in new.versions()}
        for ov in old.versions():
            nv = new_by_uuid.get(bytes(ov.uuid))
            # a version that was active and is now gone or aborted must be
            # deleted from the version table (object_table.rs:398-429);
            # for multipart uploads ov.uuid doubles as the upload id and
            # the *final* version uuid, so this also reaps the final
            # version when a completed MPU object is later deleted
            became_deleted = (nv is None and not ov.is_aborted()) or (
                nv is not None and nv.is_aborted() and not ov.is_aborted()
            )
            if became_deleted and self.version_table is not None:
                vdel = Version.new(ov.uuid, bytes(old.bucket_id), old.key, deleted=True)
                self.version_table.data.queue_insert(tx, vdel)
            # independently: once a multipart upload stops Uploading
            # (aborted, completed, or pruned), its MPU row is tombstoned,
            # cascading to all part versions (object_table.rs:431-460);
            # after completion the final version carries its own refs
            if ov.is_uploading(check_multipart=True) and self.mpu_table is not None:
                mpu_done = nv is None or not nv.is_uploading()
                if mpu_done:
                    from .mpu_table import MultipartUpload

                    mdel = MultipartUpload(
                        ov.uuid, ov.timestamp, bytes(old.bucket_id),
                        old.key, deleted=True,
                    )
                    self.mpu_table.data.queue_insert(tx, mdel)

    def matches_filter(self, entry: Object, filter: Any) -> bool:
        if filter is None:
            return entry.last_data_version() is not None
        if filter == "uploading":
            # node-side (ref ObjectFilter::IsUploading): rows without an
            # in-progress upload never leave the replica — a cleanup scan
            # must not ship a bucket's inline object bytes over RPC
            return any(v.is_uploading() for v in entry.versions())
        return True


async def abort_uploads(object_table, obj: Object, predicate) -> int:
    """Abort every in-progress upload version of `obj` that matches
    `predicate(version)`.  Inserting the aborted versions rides the
    updated() hook cascade: MPU rows tombstone, part versions and their
    block refs drop.  Shared by the lifecycle worker's
    abort-incomplete-multipart-upload rule and the admin
    `bucket cleanup-incomplete-uploads` command — the CRDT state literal
    and the cascade contract live in exactly one place."""
    aborted = [
        ObjectVersion(v.uuid, v.timestamp, ["aborted"])
        for v in obj.versions()
        if v.is_uploading() and predicate(v)
    ]
    if aborted:
        await object_table.insert(Object(obj.bucket_id, obj.key, aborted))
    return len(aborted)
