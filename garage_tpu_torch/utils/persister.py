"""Atomic single-value persistence to a metadata file.

Equivalent of reference src/util/persister.rs:10-120: `Persister` saves one
versioned (`Migrated`) value via write-tmp + fsync + rename, and
`PersisterShared` adds an in-RAM cache.  Used for cluster layout, peer lists,
scrub checkpoints and lifecycle progress (ref rpc/system.rs:88-89,
block/repair.rs:185-229).
"""

from __future__ import annotations

import os
import threading
from typing import Generic, Optional, Type, TypeVar

from .migrate import Migrated

T = TypeVar("T", bound=Migrated)


class Persister(Generic[T]):
    def __init__(self, directory: str, name: str, typ: Type[T]):
        self.path = os.path.join(directory, name)
        self.typ = typ
        os.makedirs(directory, exist_ok=True)

    def load(self) -> Optional[T]:
        try:
            with open(self.path, "rb") as f:
                return self.typ.decode(f.read())  # type: ignore[return-value]
        except FileNotFoundError:
            return None

    def save(self, value: T) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(value.encode())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        # fsync the directory so the rename is durable (ref persister.rs:60-76)
        dfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)


class PersisterShared(Persister[T]):
    """Persister + RwLock'd in-memory copy (ref persister.rs:88-120)."""

    def __init__(self, directory: str, name: str, typ: Type[T], default: T):
        super().__init__(directory, name, typ)
        self._lock = threading.Lock()
        loaded = self.load()
        self._value: T = loaded if loaded is not None else default

    def get(self) -> T:
        with self._lock:
            return self._value

    def set(self, value: T) -> None:
        with self._lock:
            self._value = value
            self.save(value)
