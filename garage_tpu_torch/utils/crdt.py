"""Conflict-free replicated data types.

Equivalent of reference src/util/crdt/*: the `Crdt` merge trait
(crdt/crdt.rs:19-27) and its instances — `Lww` (lww.rs:41-44), `LwwMap`
(lww_map.rs), `Map` (map.rs), `Bool` (bool.rs, or-merge), `Deletable`
(deletable.rs), and `AutoCrdt` max-merge for totally ordered values
(crdt.rs:43-58).

Merge must be commutative, associative and idempotent; all replicated
metadata in the framework is a CRDT so replicas converge without
coordination.  Values are kept as plain Python data (msgpack-encodable);
each CRDT knows how to (de)serialize itself to primitive structures.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Generic, List, Optional, Tuple, TypeVar

T = TypeVar("T")


def now_msec() -> int:
    """Wall-clock ms — LWW timestamps (ref util/time.rs:4-16)."""
    return int(time.time() * 1000)


def _value_order_key(v: Any) -> bytes:
    """Deterministic total order over arbitrary msgpack-able values, used to
    tie-break LWW merges at equal timestamps.  Python's `>` is partial (dicts
    aren't orderable), so we compare canonical msgpack encodings — stable
    across replicas, which is all convergence needs."""
    import msgpack

    try:
        return msgpack.packb(v, use_bin_type=True)
    except Exception:
        return repr(v).encode()


def _tie_break_gt(a: Any, b: Any) -> bool:
    """a > b under a total order that never raises."""
    try:
        return bool(a > b)
    except TypeError:
        return _value_order_key(a) > _value_order_key(b)


class Crdt:
    """Base merge trait (ref util/crdt/crdt.rs:19-27)."""

    def merge(self, other: "Crdt") -> None:
        raise NotImplementedError

    # --- serialization to msgpack-friendly primitives ---
    def pack(self) -> Any:
        raise NotImplementedError

    @classmethod
    def unpack(cls, v: Any) -> "Crdt":
        raise NotImplementedError


def merge_auto(a: T, b: T) -> T:
    """AutoCrdt: max-merge for totally ordered values (ref crdt.rs:43-58)."""
    return b if b > a else a


class Lww(Crdt, Generic[T]):
    """Last-writer-wins register (ref util/crdt/lww.rs).

    Timestamp is wall-clock ms; `update` bumps to max(now, ts+1) so a node
    always supersedes its own previous value (lww.rs:75-80).  Ties merge the
    payload if it is itself a CRDT, else take the larger value (lww.rs:41-44
    merges payloads on equal ts).
    """

    __slots__ = ("ts", "value")

    def __init__(self, value: T, ts: Optional[int] = None):
        self.ts = now_msec() if ts is None else ts
        self.value = value

    def update(self, value: T) -> None:
        self.ts = max(now_msec(), self.ts + 1)
        self.value = value

    def merge(self, other: "Lww[T]") -> None:
        if other.ts > self.ts:
            self.ts = other.ts
            self.value = other.value
        elif other.ts == self.ts and other.value != self.value:
            if isinstance(self.value, Crdt):
                self.value.merge(other.value)  # type: ignore[arg-type]
            elif other.value is not None and (
                self.value is None or _tie_break_gt(other.value, self.value)
            ):
                self.value = other.value

    def pack(self) -> Any:
        return [self.ts, self.value.pack() if isinstance(self.value, Crdt) else self.value]

    @classmethod
    def unpack(cls, v: Any, value_unpack: Optional[Callable[[Any], Any]] = None) -> "Lww":
        ts, val = v
        if value_unpack is not None:
            val = value_unpack(val)
        return cls(val, ts=ts)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Lww) and (self.ts, self.value) == (other.ts, other.value)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Lww(ts={self.ts}, value={self.value!r})"


class LwwMap(Crdt, Generic[T]):
    """Map of independently-LWW values keyed by hashable keys
    (ref util/crdt/lww_map.rs; reference stores a sorted Vec, we use dict —
    iteration is sorted on demand)."""

    __slots__ = ("items",)

    def __init__(self, items: Optional[Dict[Any, Lww[T]]] = None):
        self.items: Dict[Any, Lww[T]] = items or {}

    def get(self, k: Any) -> Optional[T]:
        e = self.items.get(k)
        return e.value if e is not None else None

    def get_ts(self, k: Any) -> int:
        e = self.items.get(k)
        return e.ts if e is not None else 0

    def update(self, k: Any, v: T) -> None:
        e = self.items.get(k)
        if e is None:
            self.items[k] = Lww(v)
        else:
            e.update(v)

    def update_in_place(self, k: Any, v: T, ts: int) -> None:
        self.items[k] = Lww(v, ts=ts)

    def merge(self, other: "LwwMap[T]") -> None:
        for k, lww in other.items.items():
            mine = self.items.get(k)
            if mine is None:
                self.items[k] = Lww(lww.value, ts=lww.ts)
            else:
                mine.merge(lww)

    def sorted_items(self) -> List[Tuple[Any, Lww[T]]]:
        return sorted(self.items.items(), key=lambda kv: kv[0])

    def pack(self) -> Any:
        return [[k, e.pack()] for k, e in self.sorted_items()]

    @classmethod
    def unpack(cls, v: Any, value_unpack: Optional[Callable[[Any], Any]] = None) -> "LwwMap":
        return cls({k: Lww.unpack(e, value_unpack) for k, e in v})

    def __eq__(self, other: object) -> bool:
        return isinstance(other, LwwMap) and self.items == other.items

    def __len__(self) -> int:
        return len(self.items)


class CrdtMap(Crdt):
    """Map whose values are themselves CRDTs, merged pointwise
    (ref util/crdt/map.rs)."""

    __slots__ = ("items",)

    def __init__(self, items: Optional[Dict[Any, Crdt]] = None):
        self.items: Dict[Any, Crdt] = items or {}

    def put(self, k: Any, v: Crdt) -> None:
        mine = self.items.get(k)
        if mine is None:
            self.items[k] = v
        else:
            mine.merge(v)

    def merge(self, other: "CrdtMap") -> None:
        for k, v in other.items.items():
            self.put(k, v)

    def pack(self) -> Any:
        return [[k, e.pack()] for k, e in sorted(self.items.items(), key=lambda kv: kv[0])]

    def __eq__(self, other: object) -> bool:
        return isinstance(other, CrdtMap) and self.items == other.items


class CrdtBool(Crdt):
    """Or-merge boolean: once true, always true (ref util/crdt/bool.rs)."""

    __slots__ = ("value",)

    def __init__(self, value: bool = False):
        self.value = value

    def set(self) -> None:
        self.value = True

    def merge(self, other: "CrdtBool") -> None:
        self.value = self.value or other.value

    def pack(self) -> Any:
        return self.value

    @classmethod
    def unpack(cls, v: Any) -> "CrdtBool":
        return cls(bool(v))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, CrdtBool) and self.value == other.value


class Deletable(Crdt, Generic[T]):
    """Present(value) | Deleted — deletion wins over any concurrent value
    (ref util/crdt/deletable.rs)."""

    __slots__ = ("value", "deleted")

    def __init__(self, value: Optional[T] = None, deleted: bool = False):
        self.value = value
        self.deleted = deleted

    @classmethod
    def present(cls, value: T) -> "Deletable[T]":
        return cls(value=value)

    @classmethod
    def delete(cls) -> "Deletable[T]":
        return cls(deleted=True)

    def is_deleted(self) -> bool:
        return self.deleted

    def get(self) -> Optional[T]:
        return None if self.deleted else self.value

    def merge(self, other: "Deletable[T]") -> None:
        if other.deleted:
            self.deleted, self.value = True, None
        elif not self.deleted:
            if isinstance(self.value, Crdt) and other.value is not None:
                self.value.merge(other.value)  # type: ignore[arg-type]
            elif other.value is not None and (
                self.value is None or _tie_break_gt(other.value, self.value)
            ):
                self.value = other.value

    def pack(self) -> Any:
        if self.deleted:
            return None
        return [self.value.pack() if isinstance(self.value, Crdt) else self.value]

    @classmethod
    def unpack(cls, v: Any, value_unpack: Optional[Callable[[Any], Any]] = None) -> "Deletable":
        if v is None:
            return cls.delete()
        val = v[0]
        if value_unpack is not None:
            val = value_unpack(val)
        return cls.present(val)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Deletable)
            and (self.deleted, self.value) == (other.deleted, other.value)
        )
