"""Versioned on-disk/on-wire serialization.

Equivalent of reference src/util/migrate.rs:4-37: every persisted value is
encoded as ``VERSION_MARKER + msgpack(body)``.  Decoding tries the current
version's marker first; on mismatch it decodes as the previous version and
migrates forward recursively, so any historical byte string remains readable
(`Migrate::decode`, migrate.rs:22-33).

Usage::

    class ThingV1(Migrated):
        VERSION_MARKER = b"G1thing"
        @classmethod
        def from_fields(cls, d): ...
        def fields(self): ...

    class ThingV2(Migrated):
        VERSION_MARKER = b"G2thing"
        PREVIOUS = ThingV1
        @classmethod
        def migrate(cls, old: ThingV1) -> "ThingV2": ...
"""

from __future__ import annotations

from typing import Any, ClassVar, Optional, Type

import msgpack


def pack(obj: Any) -> bytes:
    """msgpack encode (ref util/encode.rs nonversioned_encode)."""
    return msgpack.packb(obj, use_bin_type=True)


def unpack(data: bytes) -> Any:
    return msgpack.unpackb(data, raw=False, strict_map_key=False)


class DecodeError(Exception):
    pass


class Migrated:
    """A value with a versioned serialized form (ref util/migrate.rs:4-43)."""

    VERSION_MARKER: ClassVar[bytes] = b""
    PREVIOUS: ClassVar[Optional[Type["Migrated"]]] = None

    # --- subclass interface ---
    def fields(self) -> Any:
        """Return msgpack-encodable body."""
        raise NotImplementedError

    @classmethod
    def from_fields(cls, body: Any) -> "Migrated":
        raise NotImplementedError

    @classmethod
    def migrate(cls, old: "Migrated") -> "Migrated":
        """Convert an instance of PREVIOUS into this version."""
        raise NotImplementedError

    # --- engine (ref migrate.rs:22-37) ---
    def encode(self) -> bytes:
        assert self.VERSION_MARKER, f"{type(self).__name__} has no VERSION_MARKER"
        return self.VERSION_MARKER + pack(self.fields())

    @classmethod
    def decode(cls, data: bytes) -> "Migrated":
        if cls.VERSION_MARKER and data.startswith(cls.VERSION_MARKER):
            try:
                return cls.from_fields(unpack(data[len(cls.VERSION_MARKER):]))
            except Exception as e:
                raise DecodeError(
                    f"{cls.__name__}: marker matched but body undecodable: {e}"
                ) from e
        if cls.PREVIOUS is not None:
            old = cls.PREVIOUS.decode(data)
            return cls.migrate(old)
        raise DecodeError(
            f"{cls.__name__}: unrecognized version marker {data[:16]!r}"
        )
