"""API key table.

Equivalent of reference src/model/key_table.rs (SURVEY.md §2.6): keys are
`Deletable<KeyParams>` with an immutable secret, LWW name/allow-create
flags, per-bucket permission map, and per-key local bucket aliases.
Fully replicated (control data).
"""

from __future__ import annotations

import secrets
from typing import Any, Optional

from ..table.schema import Entry, TableSchema
from ..utils.crdt import Crdt, Deletable, Lww, LwwMap
from ..utils.data import Uuid
from .permission import BucketKeyPerm


def generate_key_id() -> str:
    """ref key_table.rs:180-186 — 'GK' + 12 hex bytes."""
    return "GK" + secrets.token_hex(12)


def generate_secret_key() -> str:
    return secrets.token_hex(32)


class KeyParams(Crdt):
    """ref key_table.rs:23-90."""

    __slots__ = ("secret_key", "name", "allow_create_bucket", "authorized_buckets", "local_aliases")

    def __init__(
        self,
        secret_key: str,
        name: Optional[Lww] = None,
        allow_create_bucket: Optional[Lww] = None,
        authorized_buckets: Optional[LwwMap] = None,
        local_aliases: Optional[LwwMap] = None,
    ):
        self.secret_key = secret_key            # immutable once created
        self.name = name or Lww("")
        self.allow_create_bucket = allow_create_bucket or Lww(False, ts=0)
        # bucket_id(bytes32) → BucketKeyPerm
        self.authorized_buckets = authorized_buckets or LwwMap()
        # alias(str) → Optional[bucket_id bytes]
        self.local_aliases = local_aliases or LwwMap()

    def merge(self, other: "KeyParams") -> None:
        self.name.merge(other.name)
        self.allow_create_bucket.merge(other.allow_create_bucket)
        self.authorized_buckets.merge(other.authorized_buckets)
        self.local_aliases.merge(other.local_aliases)

    def pack(self) -> Any:
        return [
            self.secret_key,
            self.name.pack(),
            self.allow_create_bucket.pack(),
            [[k, [e.ts, e.value.pack()]] for k, e in self.authorized_buckets.sorted_items()],
            self.local_aliases.pack(),
        ]

    @classmethod
    def unpack(cls, v: Any) -> "KeyParams":
        auth = LwwMap({
            bytes(k): Lww(BucketKeyPerm.unpack(val), ts=ts) for k, (ts, val) in v[3]
        })
        return cls(
            secret_key=v[0],
            name=Lww.unpack(v[1]),
            allow_create_bucket=Lww.unpack(v[2]),
            authorized_buckets=auth,
            local_aliases=LwwMap.unpack(v[4]),
        )

    def __eq__(self, other: object) -> bool:
        return isinstance(other, KeyParams) and self.pack() == other.pack()


class Key(Entry):
    """P = key_id, S = empty (ref key_table.rs:92-178)."""

    VERSION_MARKER = b"GT01key"

    def __init__(self, key_id: str, state: Optional[Deletable] = None):
        self.key_id = key_id
        self.state: Deletable = state or Deletable.delete()

    @classmethod
    def new(cls, name: str = "unnamed") -> "Key":
        k = cls(generate_key_id(), Deletable.present(KeyParams(generate_secret_key())))
        k.params().name.update(name)
        return k

    @classmethod
    def import_key(cls, key_id: str, secret_key: str, name: str) -> "Key":
        k = cls(key_id, Deletable.present(KeyParams(secret_key)))
        k.params().name.update(name)
        return k

    @property
    def partition_key(self) -> str:
        return self.key_id

    @property
    def sort_key(self) -> str:
        return ""

    def is_tombstone(self) -> bool:
        return self.state.is_deleted()

    def is_deleted(self) -> bool:
        return self.state.is_deleted()

    def params(self) -> Optional[KeyParams]:
        return self.state.get()

    # --- permission checks (ref key_table.rs:128-151) ---

    def allow_read(self, bucket_id: Uuid) -> bool:
        p = self.bucket_permissions(bucket_id)
        return p.allow_read or p.allow_owner

    def allow_write(self, bucket_id: Uuid) -> bool:
        p = self.bucket_permissions(bucket_id)
        return p.allow_write or p.allow_owner

    def allow_owner(self, bucket_id: Uuid) -> bool:
        return self.bucket_permissions(bucket_id).allow_owner

    def bucket_permissions(self, bucket_id: Uuid) -> BucketKeyPerm:
        params = self.params()
        if params is None:
            return BucketKeyPerm.NO_PERMISSIONS
        perm = params.authorized_buckets.get(bytes(bucket_id))
        return perm if perm is not None else BucketKeyPerm.NO_PERMISSIONS

    def merge(self, other: "Key") -> None:
        self.state.merge(other.state)

    def fields(self) -> Any:
        return [
            self.key_id,
            None if self.state.is_deleted() else self.state.value.pack(),
        ]

    @classmethod
    def from_fields(cls, b: Any) -> "Key":
        state = (
            Deletable.delete()
            if b[1] is None
            else Deletable.present(KeyParams.unpack(b[1]))
        )
        return cls(b[0], state)


class KeyTableSchema(TableSchema):
    TABLE_NAME = "key"
    ENTRY = Key

    def matches_filter(self, entry: Key, filter: Any) -> bool:
        from ..table.schema import DeletedFilter

        if filter is None:
            return not entry.is_deleted()
        if isinstance(filter, str) and filter in ("any", "deleted", "not_deleted"):
            return DeletedFilter.matches(filter, entry.is_deleted())
        # pattern filter: match key_id prefix or name substring (ref
        # key_table.rs KeyFilter::MatchesAndNotDeleted)
        if entry.is_deleted():
            return False
        pat = str(filter).lower()
        return entry.key_id.lower().startswith(pat) or (
            pat in entry.params().name.value.lower()
        )
