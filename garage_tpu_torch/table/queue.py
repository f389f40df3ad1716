"""InsertQueueWorker — drains the transactional insert queue.

Equivalent of reference src/table/queue.rs:15-77: entries written to the
insert queue from inside other tables' update transactions (via
`TableData.queue_insert`) are re-inserted through the normal distributed
path in batches of ≤1024, then removed if unchanged.
"""

from __future__ import annotations

import logging
from typing import List, Tuple

from ..utils.background import Worker, WorkerState

logger = logging.getLogger("garage_tpu_torch.table.queue")

BATCH_SIZE = 1024  # ref queue.rs:12


class InsertQueueWorker(Worker):
    def __init__(self, table):
        self.table = table

    def name(self) -> str:
        return f"{self.table.schema.TABLE_NAME} queue"

    async def work(self) -> WorkerState:
        data = self.table.data
        batch: List[Tuple[bytes, bytes]] = []
        for k, v in data.insert_queue.items():
            batch.append((k, v))
            if len(batch) >= BATCH_SIZE:
                break
        self.status().queue_length = len(data.insert_queue)
        if not batch:
            return WorkerState.IDLE
        entries = []
        for _k, v in batch:
            try:
                entries.append(data.decode_entry(v))
            except Exception:
                logger.exception("undecodable queued insert, dropping")
        if entries:
            await self.table.insert_many(entries)
        # remove only what we processed, and only if unchanged
        def txn(tx):
            for k, v in batch:
                if tx.get(data.insert_queue.tree, k) == v:
                    data.insert_queue.tx_remove(tx, k)

        data.db.transaction(txn)
        self.status().queue_length = len(data.insert_queue)
        return WorkerState.BUSY

    # wait_for_work's len re-check plus the LoopSafeEvent notify
    # (table/data.py) close the mid-batch-refill idle gap: an insert
    # queued from a worker thread while a batch was in flight wakes the
    # drainer instead of waiting out a full notify interval

    async def wait_for_work(self) -> None:
        data = self.table.data
        data.insert_queue_notify.clear()
        if len(data.insert_queue) > 0:
            return
        await data.insert_queue_notify.wait()
