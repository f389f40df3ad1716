"""K2V RPC — insert routing and long-poll.

Equivalent of reference src/model/k2v/rpc.rs:42-571: writes are NOT
applied at the gateway — they are routed to one of the partition's storage
nodes, which assigns the timestamp inside a local transaction (from the
`k2v_local_timestamp` tree) and applies the DVVS update; this keeps vector
clocks to one entry per *storage* node rather than per gateway.  The
storage node then relies on the normal table quorum insert to spread the
result.  PollItem long-polls on a SubscriptionManager (k2v/sub.rs) woken
by the item table's updated() hook.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import time
from typing import Dict, List, Optional, Tuple

from ...net.frame import PRIO_NORMAL
from ...rpc.rpc_helper import RequestStrategy
from ...table.schema import hash_partition_key
from ...utils.crdt import now_msec
from ...utils.data import Uuid
from ...utils.error import GarageError
from .causality import CausalContext
from .item_table import K2VItem

logger = logging.getLogger("garage_tpu_torch.k2v.rpc")

TIMEOUT = 30.0


class SubscriptionManager:
    """Waiters on item updates (ref k2v/sub.rs:110): key → asyncio.Event
    fan-out; range waiters match on (bucket, partition) prefix."""

    def __init__(self):
        self._item_waiters: Dict[tuple, List[asyncio.Queue]] = {}
        self._range_waiters: Dict[tuple, List[asyncio.Queue]] = {}

    def subscribe_item(self, bucket_id, pk: str, sk: str) -> asyncio.Queue:
        q = asyncio.Queue()
        self._item_waiters.setdefault((bytes(bucket_id), pk, sk), []).append(q)
        return q

    def unsubscribe_item(self, bucket_id, pk: str, sk: str, q) -> None:
        ws = self._item_waiters.get((bytes(bucket_id), pk, sk), [])
        if q in ws:
            ws.remove(q)

    def subscribe_range(self, bucket_id, pk: str) -> asyncio.Queue:
        q = asyncio.Queue()
        self._range_waiters.setdefault((bytes(bucket_id), pk), []).append(q)
        return q

    def unsubscribe_range(self, bucket_id, pk: str, q) -> None:
        ws = self._range_waiters.get((bytes(bucket_id), pk), [])
        if q in ws:
            ws.remove(q)

    def notify(self, item: K2VItem) -> None:
        for q in self._item_waiters.get(
            (bytes(item.bucket_id), item.partition_key_str, item.sort_key_str), []
        ):
            q.put_nowait(item)
        for q in self._range_waiters.get(
            (bytes(item.bucket_id), item.partition_key_str), []
        ):
            q.put_nowait(item)


class K2VRpcHandler:
    def __init__(self, system, item_table, db, subscriptions: SubscriptionManager):
        self.system = system
        self.item_table = item_table
        self.subscriptions = subscriptions
        # per-partition monotonic timestamp source (ref rpc.rs:114+
        # k2v_local_timestamp tree)
        self.local_timestamp = db.open_tree("k2v_local_timestamp")
        self.endpoint = system.netapp.endpoint("garage/k2v")
        self.endpoint.set_handler(self._handle)

    # --- client side -------------------------------------------------------

    async def insert(
        self,
        bucket_id: Uuid,
        partition_key: str,
        sort_key: str,
        causal_context: Optional[CausalContext],
        value: Optional[bytes],
    ) -> None:
        """Route the write to a storage node of the partition
        (ref rpc.rs:75-110 insert)."""
        h = hash_partition_key((bytes(bucket_id), partition_key))
        who = self.system.rpc.request_order(
            self.item_table.replication.write_nodes(h)
        )
        msg = {
            "t": "insert",
            "b": bytes(bucket_id),
            "pk": partition_key,
            "sk": sort_key,
            "ct": causal_context.serialize() if causal_context else None,
            "v": value,
        }
        errs = []
        for node in who:
            try:
                await self.endpoint.call(node, msg, prio=PRIO_NORMAL, timeout=TIMEOUT)
                return
            except Exception as e:
                errs.append(str(e))
        raise GarageError(f"k2v insert failed on all nodes: {errs}")

    async def insert_many(
        self,
        bucket_id: Uuid,
        items: List[Tuple[str, str, Optional[CausalContext], Optional[bytes]]],
    ) -> None:
        """Batch insert grouped by routed node (ref rpc.rs insert_many)."""
        per_node: Dict[bytes, List] = {}
        for pk, sk, ct, v in items:
            h = hash_partition_key((bytes(bucket_id), pk))
            who = self.system.rpc.request_order(
                self.item_table.replication.write_nodes(h)
            )
            per_node.setdefault(bytes(who[0]), []).append(
                [pk, sk, ct.serialize() if ct else None, v]
            )

        async def send(node_b, batch):
            from ...utils.data import FixedBytes32

            await self.endpoint.call(
                FixedBytes32(node_b),
                {"t": "insert_many", "b": bytes(bucket_id), "items": batch},
                timeout=TIMEOUT,
            )

        results = await asyncio.gather(
            *[send(n, b) for n, b in per_node.items()], return_exceptions=True
        )
        # a node's whole batch failing (routed node down) falls back to
        # per-item inserts, which walk the remaining replicas — one dead
        # primary must not fail the batch
        retry = []
        for (node, batch), res in zip(per_node.items(), results):
            if isinstance(res, Exception):
                retry.extend(batch)
        if retry:
            errs = []
            for pk, sk, ct_ser, v in retry:
                try:
                    await self.insert(
                        bucket_id, pk, sk,
                        CausalContext.parse(ct_ser) if ct_ser else None, v,
                    )
                except Exception as e:  # noqa: BLE001 — collected below
                    errs.append(str(e))
            if errs:
                raise GarageError(f"k2v insert_many partial failure: {errs}")

    async def poll_item(
        self,
        bucket_id: Uuid,
        partition_key: str,
        sort_key: str,
        causal_context: CausalContext,
        timeout: float,
    ) -> Optional[K2VItem]:
        """Wait until the item advances past the given causality token
        (ref rpc.rs poll_item + k2v/sub.rs); polls replicas concurrently
        and returns the first advanced version, None on timeout."""
        h = hash_partition_key((bytes(bucket_id), partition_key))
        who = self.item_table.replication.read_nodes(h)
        msg = {
            "t": "poll_item",
            "b": bytes(bucket_id),
            "pk": partition_key,
            "sk": sort_key,
            "ct": causal_context.serialize(),
            "timeout": timeout,
        }

        async def ask(node):
            resp = await self.endpoint.call(
                node, msg, prio=PRIO_NORMAL, timeout=timeout + 10.0
            )
            if resp.get("item") is None:
                raise asyncio.TimeoutError()
            return self.item_table.data.decode_entry(bytes(resp["item"]))

        tasks = [asyncio.ensure_future(ask(n)) for n in who]
        try:
            done, pending = await asyncio.wait(
                tasks, timeout=timeout + 5.0,
                return_when=asyncio.FIRST_COMPLETED,
            )
            for t in done:
                if t.exception() is None:
                    return t.result()
            return None
        finally:
            for t in tasks:
                if not t.done():
                    t.cancel()

    # --- server side -------------------------------------------------------

    def _assign_timestamp(self, tx, pk_hash: bytes, proposed: int) -> int:
        """Monotonic per-partition timestamp (ref rpc.rs local timestamp
        tree): max(now, last+1)."""
        cur = tx.get(self.local_timestamp, pk_hash)
        last = struct.unpack(">Q", cur)[0] if cur is not None else 0
        ts = max(proposed, last + 1)
        tx.insert(self.local_timestamp, pk_hash, struct.pack(">Q", ts))
        return ts

    def _local_insert(self, bucket_id: bytes, pk: str, sk: str,
                      ct: Optional[str], value: Optional[bytes]) -> K2VItem:
        """Apply one write locally with a fresh timestamp, inside the item
        table's update transaction (ref rpc.rs handle_insert)."""
        context = CausalContext.parse(ct) if ct else None
        data = self.item_table.data
        h = hash_partition_key((bucket_id, pk))

        def update_fn(tx, old: Optional[K2VItem]) -> K2VItem:
            item = old if old is not None else K2VItem(Uuid(bucket_id), pk, sk)
            ts = self._assign_timestamp(tx, bytes(h), now_msec())
            item.update(bytes(self.system.id), context, value, ts=ts)
            return item

        new_item = data.update_entry_with((bucket_id, pk), sk, update_fn)
        if new_item is None:
            # no change (idempotent re-apply); read current
            raw = data.read_entry((bucket_id, pk), sk)
            new_item = data.decode_entry(raw)
        return new_item

    async def _handle(self, remote, msg, body):
        t = msg.get("t")
        if t == "insert":
            item = self._local_insert(
                bytes(msg["b"]), msg["pk"], msg["sk"], msg.get("ct"),
                bytes(msg["v"]) if msg.get("v") is not None else None,
            )
            # spread to the other replicas via the table quorum path
            await self.item_table.insert(item)
            return {"ok": True}, None
        if t == "insert_many":
            b = bytes(msg["b"])
            items = []
            for pk, sk, ct, v in msg["items"]:
                items.append(self._local_insert(
                    b, pk, sk, ct, bytes(v) if v is not None else None
                ))
            await self.item_table.insert_many(items)
            return {"ok": True}, None
        if t == "poll_item":
            item = await self._handle_poll(
                bytes(msg["b"]), msg["pk"], msg["sk"], msg["ct"],
                float(msg["timeout"]),
            )
            return {"item": item.encode() if item is not None else None}, None
        raise GarageError(f"unknown k2v rpc {t!r}")

    async def _handle_poll(self, bucket_id, pk, sk, ct, timeout) -> Optional[K2VItem]:
        context = CausalContext.parse(ct)
        data = self.item_table.data
        # subscribe FIRST to avoid a notify/check race (ref sub.rs)
        q = self.subscriptions.subscribe_item(bucket_id, pk, sk)
        try:
            raw = data.read_entry((bucket_id, pk), sk)
            if raw is not None:
                item = data.decode_entry(raw)
                if item.causal_context().is_newer_than(context):
                    return item
            deadline = time.monotonic() + timeout
            while True:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    return None
                try:
                    item = await asyncio.wait_for(q.get(), timeout=remain)
                except asyncio.TimeoutError:
                    return None
                if item.sort_key_str == sk and item.causal_context().is_newer_than(context):
                    return item
        finally:
            self.subscriptions.unsubscribe_item(bucket_id, pk, sk, q)
