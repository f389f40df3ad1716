"""An open-loop load generator.

Arrivals are a Poisson process conditioned on its count: ``round(rate x
seconds)`` due times drawn uniformly over the window and sorted, so every
seed offers the same number of requests, at other times.  Each request
is sent at its due time whether or not earlier ones have been answered,
and its latency runs from its due time, so a stall of the system or of
the generator shows in every request it delays.
"""

from __future__ import annotations

import asyncio
import math
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable, List, Optional

import numpy as np


def due_times(rng: np.random.Generator, rate: float, seconds: float) -> np.ndarray:
    n = int(round(rate * seconds))
    return np.sort(rng.uniform(0.0, seconds, n))


@dataclass
class Record:
    index: int
    due: float                 # perf_counter seconds
    sent: float = math.nan
    done: float = math.nan
    ok: bool = False
    detail: dict = field(default_factory=dict)

    @property
    def latency(self) -> float:
        return self.done - self.due


async def run(dues: np.ndarray, send: Callable[[int, Record], Awaitable[bool]],
              t0: Optional[float] = None) -> List[Record]:
    """Send request ``i`` at ``t0 + dues[i]`` by awaiting ``send(i, rec)``
    in a task of its own; ``send`` returns whether the request succeeded
    and may add to ``rec.detail``.  Returns every record once every
    request has ended."""
    t0 = time.perf_counter() if t0 is None else t0
    recs = [Record(i, t0 + float(d)) for i, d in enumerate(dues)]

    async def one(rec: Record) -> None:
        rec.sent = time.perf_counter()
        try:
            rec.ok = bool(await send(rec.index, rec))
        except Exception as e:  # a failed request counts as failed
            rec.ok = False
            rec.detail.setdefault("error", f"{type(e).__name__}: {e}")
        rec.done = time.perf_counter()

    tasks = []
    for rec in recs:
        wait = rec.due - time.perf_counter()
        if wait > 0:
            await asyncio.sleep(wait)
        tasks.append(asyncio.create_task(one(rec)))
    await asyncio.gather(*tasks)
    return recs


def tail_ms(latencies_s: List[float], q: float = 0.95) -> float:
    """The ``q`` quantile by nearest rank, in ms, over every request; a
    failed request counts as infinitely late (pass ``math.inf``)."""
    xs = sorted(latencies_s)
    if not xs:
        return math.nan
    return xs[max(0, math.ceil(q * len(xs)) - 1)] * 1e3


def lateness(recs: List[Record]) -> dict:
    """How late the generator sent: p50, p95 and max of sent - due, ms."""
    xs = sorted((r.sent - r.due) * 1e3 for r in recs)
    if not xs:
        return {}
    return {"p50_ms": xs[len(xs) // 2],
            "p95_ms": xs[max(0, math.ceil(0.95 * len(xs)) - 1)],
            "max_ms": xs[-1]}
