"""Bucket↔key permission flags.

Equivalent of reference src/model/permission.rs:1-64: a timestamped
(allow_read, allow_write, allow_owner) triple merged LWW on the timestamp
with bitwise-or tie-break at equal timestamps.
"""

from __future__ import annotations

from typing import Any, Dict

from ..utils.crdt import Crdt, now_msec


class BucketKeyPerm(Crdt):
    """ref permission.rs BucketKeyPerm."""

    __slots__ = ("timestamp", "allow_read", "allow_write", "allow_owner")

    NO_PERMISSIONS: "BucketKeyPerm"
    ALL_PERMISSIONS: "BucketKeyPerm"

    def __init__(
        self,
        allow_read: bool = False,
        allow_write: bool = False,
        allow_owner: bool = False,
        timestamp: int = None,
    ):
        self.timestamp = now_msec() if timestamp is None else timestamp
        self.allow_read = allow_read
        self.allow_write = allow_write
        self.allow_owner = allow_owner

    def is_any(self) -> bool:
        return self.allow_read or self.allow_write or self.allow_owner

    def merge(self, other: "BucketKeyPerm") -> None:
        # ref permission.rs:37-56: newer timestamp wins outright; equal
        # timestamps or-merge each flag (permissive on true ties)
        if other.timestamp > self.timestamp:
            self.timestamp = other.timestamp
            self.allow_read = other.allow_read
            self.allow_write = other.allow_write
            self.allow_owner = other.allow_owner
        elif other.timestamp == self.timestamp:
            self.allow_read = self.allow_read or other.allow_read
            self.allow_write = self.allow_write or other.allow_write
            self.allow_owner = self.allow_owner or other.allow_owner

    def pack(self) -> Any:
        return [self.timestamp, self.allow_read, self.allow_write, self.allow_owner]

    @classmethod
    def unpack(cls, v: Any) -> "BucketKeyPerm":
        return cls(bool(v[1]), bool(v[2]), bool(v[3]), timestamp=int(v[0]))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, BucketKeyPerm) and self.pack() == other.pack()

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"BucketKeyPerm(r={self.allow_read}, w={self.allow_write}, "
            f"o={self.allow_owner})"
        )


BucketKeyPerm.NO_PERMISSIONS = BucketKeyPerm(timestamp=0)
BucketKeyPerm.ALL_PERMISSIONS = BucketKeyPerm(True, True, True, timestamp=0)
