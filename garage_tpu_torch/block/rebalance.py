"""RebalanceMover — rate-bounded data motion for layout changes.

When the committed layout changes (a zone added, a zone drained, a node
swapped), the partitions whose replica set changed need their blocks
moved: new owners must FETCH what they gained, old owners must PUSH what
they lost — and the old copies must never be dropped before the new set
acks (the resync migration branch's confirm-before-delete invariant,
block/resync.py).

The generic safety net for this already exists: the refs-only layout
sweep re-enqueues EVERY referenced hash to the persistent resync queue.
This mover is the foreground, observable, rate-bounded flavor on top:

  - it walks ONLY the partitions whose node set changed (diffed by the
    model layer against the previous ring), in partition order, so a
    one-zone drain touches the drained data and nothing else;
  - each block is moved through the SAME convergence step a queued
    resync runs (BlockResyncManager.rebalance_hash → resync_block),
    sharing the busy-set so mover and queue workers never double-process
    a hash and failed moves fall back onto the persistent queue;
  - motion is paced against `rebalance_rate_mib` (config) so a drain
    under live client load cannot starve the foreground data path;
  - progress is first-class: rebalance_partitions_done / _total gauges
    and the rebalance_bytes_total counter say exactly how far a drain
    has gotten and how much data it streamed — `rebalance done == total`
    is the drill's completion criterion (docs/ROBUSTNESS.md).

One long-lived worker per node, idle until the model layer feeds it
changed partitions (enqueue); layout changes arriving mid-run merge into
the current run instead of stacking workers.
"""

from __future__ import annotations

import asyncio
import logging
from typing import List, Optional

from ..utils.background import Worker, WorkerState
from ..utils.data import Hash

logger = logging.getLogger("garage_tpu_torch.block.rebalance")

# blocks moved per work() slice: bounds event-loop occupancy between
# scheduler yields, NOT throughput (pacing below does that)
MOVE_BATCH = 8


class RebalanceMover(Worker):
    def __init__(self, manager, resync, rate_mib_s: float = 64.0,
                 metrics=None, governor=None):
        self.manager = manager
        self.resync = resync
        self.rate_bytes = max(float(rate_mib_s), 0.001) * (1 << 20)
        # load governor (utils/overload.py): scales the effective pacing
        # rate by the background throttle ratio, so a drain under client
        # overload cedes bandwidth beyond the static rate ceiling and
        # speeds back up when foreground pressure clears
        self.governor = governor
        self._pending: List[int] = []   # partitions left, walk order
        self._queued = set()
        self._cursor: Optional[bytes] = None  # rc-tree key inside head
        self._notify = asyncio.Event()
        self.partitions_total = 0
        self.partitions_done = 0
        self.bytes_moved = 0
        self.blocks_moved = 0
        self.runs = 0
        if metrics is not None:
            self.m_done = metrics.gauge(
                "rebalance_partitions_done",
                "Partitions fully walked by the current/last layout "
                "rebalance run")
            self.m_total = metrics.gauge(
                "rebalance_partitions_total",
                "Partitions whose replica set changed in the "
                "current/last layout rebalance run")
            self.m_bytes = metrics.counter(
                "rebalance_bytes_total",
                "Data-plane bytes streamed by the layout rebalance "
                "mover (pushes to new owners + fetches of gained "
                "blocks)")
            self.m_done.set(0.0)
            self.m_total.set(0.0)
        else:
            self.m_done = self.m_total = self.m_bytes = None

    def name(self) -> str:
        return "Layout rebalance mover"

    # --- feeding (model layer, on ring change) ---

    def enqueue(self, partitions: List[int]) -> None:
        """Add changed partitions to the walk.  A partition already
        pending stays where it is; a COMPLETED run starting anew resets
        the done/total progress pair (one run = one layout-change
        episode, possibly merged from several ring deltas)."""
        fresh = [p for p in partitions if p not in self._queued]
        if not fresh:
            return
        if not self._pending:
            # new episode
            self.partitions_total = 0
            self.partitions_done = 0
            self.runs += 1
        self._pending.extend(fresh)
        self._queued.update(fresh)
        self.partitions_total += len(fresh)
        self._observe()
        self._notify.set()
        logger.info("rebalance: %d changed partition(s) enqueued "
                    "(%d pending)", len(fresh), len(self._pending))

    def _observe(self) -> None:
        if self.m_done is not None:
            self.m_done.set(float(self.partitions_done))
            self.m_total.set(float(self.partitions_total))

    def idle(self) -> bool:
        return not self._pending

    # --- the walk ---

    def _next_entries(self, partition: int, n: int):
        """Up to n (key, _) rc entries of `partition` after the cursor —
        partition == first hash byte (ring.partition_of)."""
        rc = self.manager.rc
        out = []
        cursor = self._cursor
        while len(out) < n:
            if cursor is None:
                # strictly-greater probe from the partition's floor: the
                # max key of partition-1 (first byte IS the partition,
                # ring.partition_of)
                nxt = rc.get_gt(bytes([partition - 1]) + b"\xff" * 31) \
                    if partition else rc.tree.first()
            else:
                nxt = rc.get_gt(cursor)
            if nxt is None or nxt[0][0] != partition:
                return out, True
            out.append(nxt[0])
            cursor = nxt[0]
            self._cursor = cursor
        return out, False

    async def work(self) -> WorkerState:
        if not self._pending:
            return WorkerState.IDLE
        p = self._pending[0]
        # on-loop on purpose: a handful of point lookups, and the rc
        # tree's other writers (table hooks, resync) run on the loop —
        # an off-thread scan would race them on the memory engine
        keys, part_done = self._next_entries(p, MOVE_BATCH)
        moved = 0
        for key in keys:
            moved += await self.resync.rebalance_hash(Hash(key))
            self.blocks_moved += 1
        if moved:
            self.bytes_moved += moved
            if self.m_bytes is not None:
                self.m_bytes.inc(moved)
        if part_done:
            self._pending.pop(0)
            self._queued.discard(p)
            self._cursor = None
            self.partitions_done += 1
            self._observe()
            if not self._pending:
                logger.info(
                    "rebalance run complete: %d/%d partitions, %d blocks "
                    "examined, %d bytes moved", self.partitions_done,
                    self.partitions_total, self.blocks_moved,
                    self.bytes_moved)
        st = self.status()
        st.progress = (
            f"{self.partitions_done}/{self.partitions_total} partitions")
        st.queue_length = len(self._pending)
        if moved:
            # pacing: sleep the time this slice's bytes "cost" at the
            # configured rate, so a drain shares the wire with clients;
            # the governor's throttle ratio shrinks the effective rate
            # further while foreground pressure is high
            rate = self.rate_bytes
            if self.governor is not None:
                rate *= max(self.governor.ratio(), 1e-3)
            await asyncio.sleep(min(moved / rate, 5.0))
        return WorkerState.BUSY

    async def wait_for_work(self) -> None:
        self._notify.clear()
        if self._pending:
            return
        try:
            await asyncio.wait_for(self._notify.wait(), timeout=10.0)
        except asyncio.TimeoutError:
            pass
