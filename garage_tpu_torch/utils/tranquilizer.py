"""Adaptive worker throttling.

Equivalent of reference src/util/tranquilizer.rs:21-77: after each unit of
work taking `t` seconds, sleep `tranquility × avg(last 30 observations)` so a
worker consumes ~1/(1+tranquility) of one core / one disk.  Used by scrub and
resync workers (ref block/repair.rs:466-468, block/resync.rs:526-553).
"""

from __future__ import annotations

import asyncio
import time
from collections import deque

from .background import WorkerState

MAX_OBSERVATIONS = 30  # ref util/tranquilizer.rs:30


class Tranquilizer:
    def __init__(self) -> None:
        self._obs: deque = deque(maxlen=MAX_OBSERVATIONS)
        self._last_start: float = time.monotonic()

    def reset(self) -> None:
        self._last_start = time.monotonic()

    def observe(self) -> float:
        dt = time.monotonic() - self._last_start
        self._obs.append(dt)
        return sum(self._obs) / len(self._obs)

    async def tranquilize(self, tranquility: int) -> None:
        avg = self.observe()
        if tranquility > 0:
            await asyncio.sleep(avg * tranquility)
        self.reset()

    async def tranquilize_worker(self, tranquility: int) -> WorkerState:
        """Sleep then report Busy/Throttled (ref tranquilizer.rs:60-69)."""
        await self.tranquilize(tranquility)
        return WorkerState.THROTTLED if tranquility > 0 else WorkerState.BUSY
