"""Replication modes → (factor, read quorum, write quorum).

Equivalent of reference src/rpc/replication_mode.rs:1-57.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.error import GarageError


@dataclass(frozen=True)
class ReplicationMode:
    name: str
    replication_factor: int
    read_quorum: int
    write_quorum: int

    @property
    def is_read_after_write_consistent(self) -> bool:
        return self.read_quorum + self.write_quorum > self.replication_factor


_MODES = {
    "none": ReplicationMode("none", 1, 1, 1),
    "1": ReplicationMode("1", 1, 1, 1),
    "2": ReplicationMode("2", 2, 1, 2),
    "2-dangerous": ReplicationMode("2-dangerous", 2, 1, 1),
    "3": ReplicationMode("3", 3, 2, 2),
    "3-degraded": ReplicationMode("3-degraded", 3, 1, 2),
    "3-dangerous": ReplicationMode("3-dangerous", 3, 1, 1),
}


def parse_replication_mode(s: str) -> ReplicationMode:
    mode = _MODES.get(str(s))
    if mode is None:
        raise GarageError(
            f"invalid replication_mode {s!r}; one of {sorted(_MODES)}"
        )
    return mode
