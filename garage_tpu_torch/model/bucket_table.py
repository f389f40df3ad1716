"""Bucket table — bucket parameters as CRDTs, fully replicated.

Equivalent of reference src/model/bucket_table.rs (SURVEY.md §2.6):
bucket rows are `Deletable<BucketParams>` where every field is its own
CRDT (authorized keys, alias back-pointers, website/CORS/lifecycle/quota
configs), so concurrent admin operations converge (bucket_table.rs:50-190).
Stored with full-copy replication (every node has all buckets).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..table.schema import Entry, TableSchema
from ..utils.crdt import Crdt, Deletable, Lww, LwwMap, now_msec
from ..utils.data import FixedBytes32, Uuid
from .permission import BucketKeyPerm

EMPTY_SK = ""


class BucketQuotas:
    """ref bucket_table.rs BucketQuotas (max_size/max_objects, both optional)."""

    @staticmethod
    def default() -> Dict[str, Optional[int]]:
        return {"max_size": None, "max_objects": None}


class BucketParams(Crdt):
    """Parameters of an existing bucket (ref bucket_table.rs:68-190)."""

    __slots__ = (
        "creation_date",
        "authorized_keys",
        "aliases",
        "local_aliases",
        "website_config",
        "cors_config",
        "lifecycle_config",
        "quotas",
    )

    def __init__(
        self,
        creation_date: Optional[int] = None,
        authorized_keys: Optional[LwwMap] = None,
        aliases: Optional[LwwMap] = None,
        local_aliases: Optional[LwwMap] = None,
        website_config: Optional[Lww] = None,
        cors_config: Optional[Lww] = None,
        lifecycle_config: Optional[Lww] = None,
        quotas: Optional[Lww] = None,
    ):
        self.creation_date = now_msec() if creation_date is None else creation_date
        # key_id(str) → BucketKeyPerm
        self.authorized_keys = authorized_keys or LwwMap()
        # global alias name(str) → bool (alias points here)
        self.aliases = aliases or LwwMap()
        # (key_id, alias_name) → bool
        self.local_aliases = local_aliases or LwwMap()
        # website: None | {"index_document": str, "error_document": str|None}
        self.website_config = website_config or Lww(None, ts=0)
        # cors: None | [rule dicts]  (see api/s3/cors.py)
        self.cors_config = cors_config or Lww(None, ts=0)
        # lifecycle: None | [rule dicts] (see api/s3/lifecycle.py)
        self.lifecycle_config = lifecycle_config or Lww(None, ts=0)
        self.quotas = quotas or Lww(BucketQuotas.default(), ts=0)

    def merge(self, other: "BucketParams") -> None:
        self.creation_date = min(self.creation_date, other.creation_date)
        self.authorized_keys.merge(other.authorized_keys)
        self.aliases.merge(other.aliases)
        self.local_aliases.merge(other.local_aliases)
        self.website_config.merge(other.website_config)
        self.cors_config.merge(other.cors_config)
        self.lifecycle_config.merge(other.lifecycle_config)
        self.quotas.merge(other.quotas)

    def pack(self) -> Any:
        return [
            self.creation_date,
            [[k, [e.ts, e.value.pack()]] for k, e in self.authorized_keys.sorted_items()],
            self.aliases.pack(),
            [[list(k), e.pack()] for k, e in self.local_aliases.sorted_items()],
            self.website_config.pack(),
            self.cors_config.pack(),
            self.lifecycle_config.pack(),
            self.quotas.pack(),
        ]

    @classmethod
    def unpack(cls, v: Any) -> "BucketParams":
        auth = LwwMap({
            k: Lww(BucketKeyPerm.unpack(val), ts=ts) for k, (ts, val) in v[1]
        })
        local = LwwMap({tuple(k): Lww.unpack(e) for k, e in v[3]})
        return cls(
            creation_date=v[0],
            authorized_keys=auth,
            aliases=LwwMap.unpack(v[2]),
            local_aliases=local,
            website_config=Lww.unpack(v[4]),
            cors_config=Lww.unpack(v[5]),
            lifecycle_config=Lww.unpack(v[6]),
            quotas=Lww.unpack(v[7]),
        )

    def __eq__(self, other: object) -> bool:
        return isinstance(other, BucketParams) and self.pack() == other.pack()


class Bucket(Entry):
    """ref bucket_table.rs:20-66 — P = bucket id (uuid), S = empty."""

    VERSION_MARKER = b"GT01bucket"

    def __init__(self, id: Uuid, state: Optional[Deletable] = None):
        self.id = id
        self.state: Deletable = state or Deletable.present(BucketParams())

    @classmethod
    def new(cls, id: Optional[Uuid] = None) -> "Bucket":
        from ..utils.data import gen_uuid

        return cls(id or gen_uuid())

    @property
    def partition_key(self) -> Uuid:
        return self.id

    @property
    def sort_key(self) -> str:
        return EMPTY_SK

    def is_tombstone(self) -> bool:
        return self.state.is_deleted()

    def is_deleted(self) -> bool:
        return self.state.is_deleted()

    def params(self) -> Optional[BucketParams]:
        return self.state.get()

    def merge(self, other: "Bucket") -> None:
        self.state.merge(other.state)

    def fields(self) -> Any:
        return [bytes(self.id), None if self.state.is_deleted() else self.state.value.pack()]

    @classmethod
    def from_fields(cls, b: Any) -> "Bucket":
        state = (
            Deletable.delete()
            if b[1] is None
            else Deletable.present(BucketParams.unpack(b[1]))
        )
        return cls(Uuid(bytes(b[0])), state)


class BucketTableSchema(TableSchema):
    TABLE_NAME = "bucket_v2"
    ENTRY = Bucket

    def matches_filter(self, entry: Bucket, filter: Any) -> bool:
        from ..table.schema import DeletedFilter

        if filter is None:
            return not entry.is_deleted()
        return DeletedFilter.matches(filter, entry.is_deleted())
