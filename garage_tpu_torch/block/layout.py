"""DataLayout — multi-drive placement of data blocks.

Equivalent of reference src/block/layout.rs: 1024 drive-partitions
(DRIVE_NPART layout.rs:12) mapped to data dirs proportionally to capacity;
hash bytes (2,3) pick the partition (HASH_DRIVE_BYTES layout.rs:14); each
partition has one *primary* dir (where blocks are written) and possibly
*secondary* dirs (older locations still checked on read, drained by the
rebalance worker, layout.rs:41-175).

Block file path: <dir>/<hex byte 0>/<hex byte 1>/<full hash hex>[.zst]
(ref block/manager.rs block_path / block_dir).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional

from ..utils.data import Hash
from ..utils.error import GarageError
from ..utils.migrate import Migrated

DRIVE_NPART = 1024          # ref layout.rs:12
HASH_DRIVE_BYTES = (2, 3)   # ref layout.rs:14


def drive_partition(h: Hash) -> int:
    b0, b1 = HASH_DRIVE_BYTES
    return ((h[b0] << 8) | h[b1]) % DRIVE_NPART


@dataclasses.dataclass
class DataDir:
    path: str
    capacity: Optional[int] = None   # None = read_only (no new writes)
    read_only: bool = False

    def pack(self):
        return [self.path, self.capacity, self.read_only]

    @classmethod
    def unpack(cls, v):
        return cls(path=v[0], capacity=v[1], read_only=bool(v[2]))


class DataLayout(Migrated):
    """ref layout.rs:17-27; persisted in the metadata dir so partition→dir
    assignment survives restarts and only moves minimally on change."""

    VERSION_MARKER = b"GT01datalayout"

    def __init__(
        self,
        data_dirs: Optional[List[DataDir]] = None,
        part_prim: Optional[List[int]] = None,
        part_sec: Optional[List[List[int]]] = None,
    ):
        self.data_dirs: List[DataDir] = data_dirs or []
        self.part_prim: List[int] = part_prim or []
        self.part_sec: List[List[int]] = part_sec or []

    # --- construction (ref layout.rs:41-81 initialize / :84-175 update) ---

    @classmethod
    def initialize(cls, dirs_cfg: List[Dict]) -> "DataLayout":
        dirs = _parse_dirs(dirs_cfg)
        writable = [i for i, d in enumerate(dirs) if not d.read_only]
        if not writable:
            raise GarageError("no writable data directory")
        lay = cls(data_dirs=dirs)
        lay.part_prim = _assign_partitions(dirs, writable)
        lay.part_sec = [[] for _ in range(DRIVE_NPART)]
        return lay

    def update(self, dirs_cfg: List[Dict]) -> "DataLayout":
        """New layout for a config change: keep blocks where they are when
        possible (old primary becomes secondary if the partition moved)."""
        dirs = _parse_dirs(dirs_cfg)
        writable = [i for i, d in enumerate(dirs) if not d.read_only]
        if not writable:
            raise GarageError("no writable data directory")
        new = DataLayout(data_dirs=dirs)
        new.part_prim = _assign_partitions(dirs, writable)
        new.part_sec = [[] for _ in range(DRIVE_NPART)]
        # map old dir indices to new by path
        path_to_new = {d.path: i for i, d in enumerate(dirs)}
        for p in range(DRIVE_NPART):
            olds = []
            if p < len(self.part_prim):
                olds.append(self.part_prim[p])
            if p < len(self.part_sec):
                olds.extend(self.part_sec[p])
            for oi in olds:
                if oi >= len(self.data_dirs):
                    continue
                ni = path_to_new.get(self.data_dirs[oi].path)
                if ni is not None and ni != new.part_prim[p] and ni not in new.part_sec[p]:
                    new.part_sec[p].append(ni)
        return new

    # --- lookup (ref layout.rs primary_block_dir / secondary_block_dirs) ---

    def primary_dir(self, h: Hash) -> str:
        p = drive_partition(h)
        return self.data_dirs[self.part_prim[p]].path

    def secondary_dirs(self, h: Hash) -> List[str]:
        p = drive_partition(h)
        return [self.data_dirs[i].path for i in self.part_sec[p]]

    def all_dirs(self, h: Hash) -> List[str]:
        return [self.primary_dir(h)] + self.secondary_dirs(h)

    def config_changed(self, dirs_cfg: List[Dict]) -> bool:
        return _parse_dirs(dirs_cfg) != self.data_dirs

    # --- serialization ---

    def fields(self):
        return {
            "data_dirs": [d.pack() for d in self.data_dirs],
            "part_prim": list(self.part_prim),
            "part_sec": [list(s) for s in self.part_sec],
        }

    @classmethod
    def from_fields(cls, d):
        return cls(
            data_dirs=[DataDir.unpack(v) for v in d["data_dirs"]],
            part_prim=list(d["part_prim"]),
            part_sec=[list(s) for s in d["part_sec"]],
        )


def _parse_dirs(dirs_cfg: List[Dict]) -> List[DataDir]:
    out = []
    for d in dirs_cfg:
        out.append(
            DataDir(
                path=d["path"],
                capacity=d.get("capacity"),
                read_only=bool(d.get("read_only", False)),
            )
        )
    return out


def _assign_partitions(dirs: List[DataDir], writable: List[int]) -> List[int]:
    """Distribute the 1024 partitions over writable dirs proportionally to
    capacity (equal weights when no capacities are given), deterministically
    (seeded shuffle so all nodes with the same config agree)."""
    weights = []
    for i in writable:
        cap = dirs[i].capacity
        weights.append(cap if cap else 1)
    total = sum(weights)
    counts = [w * DRIVE_NPART // total for w in weights]
    while sum(counts) < DRIVE_NPART:
        counts[counts.index(min(counts))] += 1
    assignment = []
    for idx, c in zip(writable, counts):
        assignment.extend([idx] * c)
    rng = random.Random(0x6172616765)  # fixed seed: deterministic layout
    rng.shuffle(assignment)
    return assignment[:DRIVE_NPART]
