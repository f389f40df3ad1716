"""TableGc — distributed tombstone garbage collection.

Equivalent of reference src/table/gc.rs (SURVEY.md §2.4): tombstones can
only be dropped once *every* replica has them, otherwise anti-entropy
would resurrect the deleted item.  The partition leader queues tombstones
in gc_todo at write time (data.py); after TABLE_GC_DELAY (24 h) the GC
worker runs the 3-phase protocol in batches of ≤1024 (gc.rs:27-32,72-275):

  1. send the tombstone to all replicas (`Update`) so everyone has it,
  2. ask everyone (incl. self) to `DeleteIfEqualHash(key, vhash)`,
  3. drop the gc_todo entry if its value hash is unchanged.

If any replica is unreachable the batch aborts and retries later — GC is
suspended rather than unsafe.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import time
from typing import Dict, List, Tuple

from ..net.frame import PRIO_BACKGROUND
from ..rpc.rpc_helper import RequestStrategy
from ..utils.background import Worker, WorkerState
from ..utils.crdt import now_msec
from ..utils.data import Hash, blake2sum
from ..utils.error import GarageError
from .data import TableData, gc_todo_key, parse_gc_todo_key

logger = logging.getLogger("garage_tpu_torch.table.gc")

TABLE_GC_BATCH_SIZE = 1024          # ref gc.rs:27
TABLE_GC_DELAY_MS = 24 * 3600 * 1000  # ref gc.rs:32 (24h)


class TableGc:
    def __init__(self, system, data: TableData):
        self.system = system
        self.data = data
        self.endpoint = system.netapp.endpoint(
            f"garage/table_gc/{data.schema.TABLE_NAME}"
        )
        self.endpoint.set_handler(self._handle)
        # test hook: shrink the delay in integration tests
        self.gc_delay_ms = TABLE_GC_DELAY_MS

    def make_worker(self) -> "GcWorker":
        return GcWorker(self)

    # --- one GC pass (ref gc.rs:72-191) ---

    async def gc_loop_iter(self) -> bool:
        """Process one batch of due entries; returns True if any work done."""
        now = now_msec()
        entries: List[Tuple[bytes, bytes, bytes]] = []  # (todo_key, tk, vhash)
        excluded: List[Tuple[bytes, bytes]] = []
        for k, v in self.data.gc_todo.items():
            ts, tk = parse_gc_todo_key(k)
            if ts + self.gc_delay_ms > now:
                break  # keys are time-ordered: nothing further is due
            cur = self.data.store.get(tk)
            if cur is None or bytes(blake2sum(cur)) != bytes(v):
                # item changed since the tombstone was queued: drop todo
                excluded.append((k, v))
                continue
            entries.append((k, tk, bytes(v)))
            if len(entries) >= TABLE_GC_BATCH_SIZE:
                break
        for k, v in excluded:
            self.data.gc_todo.compare_and_swap(k, v, None)
        if not entries:
            return False

        # group by replica set (ref gc.rs:124-155)
        by_nodes: Dict[tuple, List[Tuple[bytes, bytes, bytes]]] = {}
        for item in entries:
            _k, tk, _vh = item
            nodes = tuple(
                bytes(n) for n in self.data.replication.write_nodes(Hash(tk[:32]))
            )
            by_nodes.setdefault(nodes, []).append(item)

        for nodes, items in by_nodes.items():
            await self._try_send_and_delete(
                [Hash(n) for n in nodes], items
            )
        return True

    async def _try_send_and_delete(self, nodes, items) -> None:
        """ref gc.rs:193-240: phase 1 Update to others, phase 2
        DeleteIfEqualHash everywhere; quorum = all nodes for both."""
        values = []
        deletes = []
        for _k, tk, vh in items:
            v = self.data.store.get(tk)
            if v is None:
                continue
            values.append(v)
            deletes.append([tk, vh])
        if not deletes:
            return
        others = [n for n in nodes if n != self.system.id]
        if others:
            await self.system.rpc.try_call_many(
                self.endpoint,
                others,
                {"t": "update", "vs": values},
                RequestStrategy(
                    rs_quorum=len(others), rs_priority=PRIO_BACKGROUND
                ),
            )
        # everyone (incl. self) deletes-if-unchanged
        await self.system.rpc.try_call_many(
            self.endpoint,
            list(nodes),
            {"t": "delete_if_equal_hash", "items": deletes},
            RequestStrategy(rs_quorum=len(nodes), rs_priority=PRIO_BACKGROUND),
        )
        logger.debug(
            "%s: GC'd %d tombstones", self.data.schema.TABLE_NAME, len(deletes)
        )
        for k, _tk, vh in items:
            self.data.gc_todo.compare_and_swap(k, vh, None)

    # --- server side (ref gc.rs GcRpc) ---

    async def _handle(self, remote, msg, body):
        t = msg.get("t")
        if t == "update":
            self.data.update_many([bytes(v) for v in msg["vs"]])
            return {"ok": True}, None
        if t == "delete_if_equal_hash":
            for tk, vh in msg["items"]:
                self.data.delete_if_equal_hash(bytes(tk), Hash(bytes(vh)))
            return {"ok": True}, None
        raise GarageError(f"unknown gc rpc {t!r}")


class GcWorker(Worker):
    """ref gc.rs:242-275."""

    def __init__(self, gc: TableGc):
        self.gc = gc

    def name(self) -> str:
        return f"{self.gc.data.schema.TABLE_NAME} GC"

    async def work(self) -> WorkerState:
        st = self.status()
        st.queue_length = self.gc.data.gc_todo_len()
        did = await self.gc.gc_loop_iter()
        return WorkerState.BUSY if did else WorkerState.IDLE

    async def wait_for_work(self) -> None:
        await asyncio.sleep(10.0)
