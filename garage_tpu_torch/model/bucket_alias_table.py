"""Global bucket aliases: name → bucket id.

Equivalent of reference src/model/bucket_alias_table.rs: an LWW pointer
from a DNS-compatible bucket name to a bucket uuid (None = alias deleted),
fully replicated.
"""

from __future__ import annotations

import re
from typing import Any, Optional

from ..table.schema import Entry, TableSchema
from ..utils.crdt import Lww
from ..utils.data import Uuid


def is_valid_bucket_name(n: str) -> bool:
    """AWS S3 bucket naming rules subset (ref bucket_alias_table.rs:60-77)."""
    return (
        3 <= len(n) <= 63
        and re.fullmatch(r"[a-z0-9][a-z0-9\-\.]*[a-z0-9]", n) is not None
        and not re.fullmatch(r"\d+\.\d+\.\d+\.\d+", n)
    )


class BucketAlias(Entry):
    """P = alias name, S = empty; state = Lww[Optional[bucket uuid]]."""

    VERSION_MARKER = b"GT01bktalias"

    def __init__(self, name: str, state: Optional[Lww] = None):
        self._name = name
        self.state: Lww = state if state is not None else Lww(None, ts=0)

    @classmethod
    def new(cls, name: str, bucket_id: Uuid, ts: Optional[int] = None) -> "BucketAlias":
        if not is_valid_bucket_name(name):
            raise ValueError(f"invalid bucket name {name!r}")
        return cls(name, Lww(bytes(bucket_id), ts=ts))

    @property
    def name(self) -> str:
        return self._name

    @property
    def partition_key(self) -> str:
        return self._name

    @property
    def sort_key(self) -> str:
        return ""

    def is_tombstone(self) -> bool:
        return self.state.value is None

    def bucket_id(self) -> Optional[Uuid]:
        v = self.state.value
        return Uuid(v) if v is not None else None

    def merge(self, other: "BucketAlias") -> None:
        self.state.merge(other.state)

    def fields(self) -> Any:
        return [self._name, self.state.pack()]

    @classmethod
    def from_fields(cls, b: Any) -> "BucketAlias":
        return cls(b[0], Lww.unpack(b[1]))


class BucketAliasTableSchema(TableSchema):
    TABLE_NAME = "bucket_alias"
    ENTRY = BucketAlias

    def matches_filter(self, entry: BucketAlias, filter: Any) -> bool:
        return entry.state.value is not None
