"""TableSyncer — Merkle anti-entropy between replicas.

Equivalent of reference src/table/sync.rs (SURVEY.md §2.4): every
ANTI_ENTROPY_INTERVAL (10 min), on ring change and on demand, each stored
partition's Merkle root hash is compared with the other replicas'; on
mismatch the tries are descended in parallel and differing items are
pushed in ≤256-item batches (sync.rs:286-415).  Partitions this node no
longer stores are offloaded: sent whole to the current replicas, then
deleted locally (sync.rs:170-269).

Sync is push-only and symmetric: each replica pushes what the other lacks
in its own sync round, so convergence needs no pull protocol.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import List, Optional

from ..net.frame import PRIO_BACKGROUND
from ..rpc.rpc_helper import RequestStrategy
from ..utils.background import Worker, WorkerState
from ..utils.data import FixedBytes32, Hash
from ..utils.error import GarageError
from .merkle import (
    EMPTY,
    EMPTY_HASH,
    MerkleUpdater,
    _encode_node,
    _is_int,
    _is_leaf,
    int_children,
    node_hash,
    node_key,
)

logger = logging.getLogger("garage_tpu_torch.table.sync")

ANTI_ENTROPY_INTERVAL = 600.0  # ref sync.rs:30 (10 min)
BATCH_SIZE = 256               # ref sync.rs push batches
OFFLOAD_BATCH = 1024
SYNC_NODE_RPC_MAX = 65536      # server-side sanity cap on one get_nodes


class TableSyncer:
    def __init__(self, system, data, merkle: MerkleUpdater):
        self.system = system
        self.data = data
        self.merkle = merkle
        self.endpoint = system.netapp.endpoint(
            f"garage/table_sync/{data.schema.TABLE_NAME}"
        )
        self.endpoint.set_handler(self._handle)
        self.worker: Optional[SyncWorker] = None
        # [table] sync_batch_nodes: Merkle nodes shipped per descent RPC
        # round (<= 1 restores the legacy one-node-per-round walk)
        tcfg = getattr(getattr(system, "config", None), "table", None)
        self.sync_batch_nodes = int(
            getattr(tcfg, "sync_batch_nodes", 512) or 512)
        # peers that answered `get_nodes` with unknown-rpc: mixed-version
        # fallback to the per-node descent until the process restarts
        self._peer_pernode: dict = {}
        # cumulative descent RPC rounds (bench A/B evidence)
        self.node_rpcs = 0
        # sync item counters (ref table/metrics.rs sync_items_sent/received)
        # — families shared across tables via registry name-dedup
        m = getattr(system, "metrics", None)
        if m is not None:
            self._m = {
                "sent": m.counter(
                    "table_sync_items_sent",
                    "Items sent to other nodes during anti-entropy"),
                "recv": m.counter(
                    "table_sync_items_received",
                    "Items received from other nodes during anti-entropy"),
                # Merkle sync convergence signal for the metadata arc: a
                # cold-joining node's catch-up is `synced` rounds turning
                # into `in_sync`; persistent `error` rounds mean a
                # partition that cannot converge
                "rounds": m.counter(
                    "table_merkle_sync_rounds_total",
                    "Per-peer-partition anti-entropy rounds by outcome "
                    "(in_sync = roots matched, synced = diffs pushed, "
                    "offload = partition handed to its new replicas, "
                    "error = round failed)"),
            }
            self._m["node_rpcs"] = m.counter(
                "table_sync_node_rpc_total",
                "Merkle descent RPC rounds by mode (batched = whole "
                "frontier per round, pernode = legacy one node per "
                "round); the batched/pernode ratio is the convergence "
                "win at cold-node join")
        else:
            self._m = None

    def _node_rpc(self, mode: str) -> None:
        self.node_rpcs += 1
        if self._m is not None:
            self._m["node_rpcs"].inc(
                mode=mode, table_name=self.data.schema.TABLE_NAME)

    def _round(self, result: str) -> None:
        if self._m is not None:
            self._m["rounds"].inc(
                result=result, table_name=self.data.schema.TABLE_NAME)

    def _count(self, which: str, n: int) -> None:
        if self._m is not None and n:
            self._m[which].inc(n, table_name=self.data.schema.TABLE_NAME)

    def make_worker(self) -> "SyncWorker":
        self.worker = SyncWorker(self)
        self.system.on_ring_change(lambda _ring: self.worker.add_full_sync())
        return self.worker

    def add_full_sync(self):
        if self.worker is not None:
            self.worker.add_full_sync()

    # --- one partition (ref sync.rs:110-168) ---

    async def sync_partition(self, partition: int, first_hash: Hash) -> None:
        nodes = self.data.replication.write_nodes(first_hash)
        if self.system.id in nodes:
            others = [n for n in nodes if n != self.system.id]
            await asyncio.gather(
                *[self._do_sync_with(partition, n) for n in others],
                return_exceptions=False,
            )
        elif nodes:
            await self._offload_partition(partition, nodes)

    # --- push sync (ref sync.rs:286-415) ---

    async def _do_sync_with(self, partition: int, who: FixedBytes32) -> None:
        try:
            await self._do_sync_with_inner(partition, who)
        except Exception:
            # Exception, NOT BaseException: a CancelledError from
            # worker shutdown is routine, and counting it as an `error`
            # round would grow the "partition cannot converge" signal on
            # every restart across the fleet
            self._round("error")
            raise

    async def _do_sync_with_inner(self, partition: int,
                                  who: FixedBytes32) -> None:
        root_nk = node_key(partition, b"")
        local_root = self.merkle.read_node(None, root_nk)
        local_hash = node_hash(local_root)
        resp = await self.endpoint.call(
            who,
            {"t": "root_ck", "p": partition},
            prio=PRIO_BACKGROUND,
        )
        remote_hash = bytes(resp["ck"])
        if bytes(local_hash) == remote_hash:
            self._round("in_sync")
            return
        bn = self.sync_batch_nodes
        if bn <= 1 or self._peer_pernode.get(bytes(who)):
            await self._descend_pernode(partition, who, root_nk)
        else:
            try:
                await self._descend_batched(partition, who, root_nk, bn)
            except GarageError as e:
                if "unknown sync rpc" not in str(e):
                    raise
                # a pre-batching peer: remember it and walk per-node
                self._peer_pernode[bytes(who)] = True
                logger.info(
                    "%s: peer lacks get_nodes; falling back to per-node "
                    "descent", self.data.schema.TABLE_NAME)
                await self._descend_pernode(partition, who, root_nk)
        self._round("synced")

    async def _descend_batched(self, partition: int, who: FixedBytes32,
                               root_nk: bytes, batch_nodes: int) -> None:
        """Breadth-wise batched descent: the whole differing frontier
        ships in ≤ `batch_nodes` node sets per RPC round, so a cold
        node's catch-up costs O(depth) round-trips instead of O(nodes).
        Pushes the same item set as the per-node walk: the per-level
        child-hash comparison is identical, only the fetch granularity
        changes.  Leaf verification hashes ride the Merkle updater's
        batched hash path (codec feeder, bg class)."""
        frontier: List[bytes] = [root_nk]
        to_send: List[bytes] = []
        while frontier:
            chunk, frontier = frontier[:batch_nodes], frontier[batch_nodes:]
            lmap = {nk: self.merkle.read_node(None, nk) for nk in chunk}
            # local EMPTY: remote has extra data; its own round pushes
            ask = [nk for nk in chunk if lmap[nk] is not EMPTY]
            if not ask:
                continue
            r = await self.endpoint.call(
                who, {"t": "get_nodes", "nks": ask}, prio=PRIO_BACKGROUND
            )
            self._node_rpc("batched")
            rnodes = r.get("nodes")
            if not isinstance(rnodes, list) or len(rnodes) != len(ask):
                raise GarageError(
                    f"get_nodes answered {len(rnodes or [])} nodes "
                    f"for {len(ask)}")
            # batched sync-time node verification: every leaf pair's
            # hashes in ONE ragged feeder batch (the serial walk hashes
            # one node per round-trip)
            pairs = [(nk, rn) for nk, rn in zip(ask, rnodes)
                     if _is_leaf(lmap[nk])]
            enc: List[bytes] = []
            for nk, rn in pairs:
                enc.append(_encode_node(lmap[nk]))
                if rn is not None:
                    enc.append(_encode_node(rn))
            # off-loop: hash_many blocks on the feeder future — parking
            # the event loop would stall every foreground request for
            # the duration of each descent round
            digs = iter(await asyncio.to_thread(self.merkle.hash_many,
                                                enc) if enc else ())
            leaf_diff: dict = {}
            for nk, rn in pairs:
                lh = bytes(next(digs))
                rh = bytes(next(digs)) if rn is not None else bytes(EMPTY_HASH)
                leaf_diff[nk] = lh != rh
            for nk, rnode in zip(ask, rnodes):
                node = lmap[nk]
                if _is_leaf(node):
                    if leaf_diff[nk]:
                        to_send.append(bytes(node[1]))
                else:
                    rchildren = (
                        dict(int_children(rnode))
                        if rnode is not None and _is_int(rnode)
                        else {}
                    )
                    for b, h in int_children(node):
                        if rchildren.get(b) != h:
                            frontier.append(nk + bytes([b]))
                while len(to_send) >= BATCH_SIZE:
                    await self._send_items(who, to_send[:BATCH_SIZE])
                    to_send = to_send[BATCH_SIZE:]
        if to_send:
            await self._send_items(who, to_send)

    async def _descend_pernode(self, partition: int, who: FixedBytes32,
                               root_nk: bytes) -> None:
        """Legacy descent (ref sync.rs:286-415): one node per RPC round
        — kept as the mixed-version fallback and the bench's paired-A/B
        baseline."""
        todo: List[bytes] = [root_nk]
        to_send: List[bytes] = []
        while todo:
            nk = todo.pop()
            node = self.merkle.read_node(None, nk)
            if node is EMPTY:
                continue  # remote has extra data; its own round pushes to us
            r = await self.endpoint.call(
                who, {"t": "get_node", "nk": nk}, prio=PRIO_BACKGROUND
            )
            self._node_rpc("pernode")
            rnode = r.get("node")
            if _is_leaf(node):
                rh = node_hash(rnode) if rnode is not None else EMPTY_HASH
                if bytes(node_hash(node)) != bytes(rh):
                    to_send.append(bytes(node[1]))
            else:
                # local intermediate: diff children against remote's child map
                rchildren = (
                    dict(int_children(rnode))
                    if rnode is not None and _is_int(rnode)
                    else {}
                )
                for b, h in int_children(node):
                    if rchildren.get(b) != h:
                        todo.append(nk + bytes([b]))
            if len(to_send) >= BATCH_SIZE:
                await self._send_items(who, to_send)
                to_send = []
        if to_send:
            await self._send_items(who, to_send)

    async def _send_items(self, who: FixedBytes32, keys: List[bytes]) -> None:
        values = []
        for k in keys:
            v = self.data.store.get(k)
            if v is not None:
                values.append(v)
        if not values:
            return
        await self.endpoint.call(
            who, {"t": "items", "vs": values}, prio=PRIO_BACKGROUND
        )
        self._count("sent", len(values))

    # --- offload (ref sync.rs:170-269) ---

    async def _offload_partition(
        self, partition: int, nodes: List[FixedBytes32]
    ) -> None:
        """We hold data for a partition that is no longer ours: send all of
        it to the real replicas (quorum = all), then delete locally."""
        if len(self.data.replication.partitions()) == 1:
            # single-partition replication (full-copy): the whole keyspace
            begin, end = None, None
        else:
            begin = bytes([partition])
            end = bytes([partition + 1]) if partition < 255 else None
        while True:
            batch = []
            for k, v in self.data.store.items(begin, end):
                batch.append((k, v))
                if len(batch) >= OFFLOAD_BATCH:
                    break
            if not batch:
                break
            values = [v for _k, v in batch]
            await self.system.rpc.try_call_many(
                self.endpoint,
                nodes,
                {"t": "items", "vs": values},
                RequestStrategy(rs_quorum=len(nodes), rs_priority=PRIO_BACKGROUND),
            )
            self._count("sent", len(values))
            for k, v in batch:
                self.data.delete_if_equal(k, v)
            logger.info(
                "%s: offloaded %d items of partition %d",
                self.data.schema.TABLE_NAME, len(batch), partition,
            )
        self._round("offload")

    # --- server side (ref sync.rs SyncRpc) ---

    async def _handle(self, remote, msg, body):
        t = msg.get("t")
        if t == "root_ck":
            ck = self.merkle.partition_root_hash(int(msg["p"]))
            return {"ck": bytes(ck)}, None
        if t == "get_node":
            node = self.merkle.read_node(None, bytes(msg["nk"]))
            return {"node": node}, None
        if t == "get_nodes":
            nks = [bytes(nk) for nk in msg["nks"]]
            if len(nks) > SYNC_NODE_RPC_MAX:
                raise GarageError(
                    f"get_nodes batch of {len(nks)} exceeds "
                    f"{SYNC_NODE_RPC_MAX}")
            return {"nodes": [self.merkle.read_node(None, nk)
                              for nk in nks]}, None
        if t == "items":
            self.data.update_many([bytes(v) for v in msg["vs"]])
            self._count("recv", len(msg["vs"]))
            return {"ok": True}, None
        raise GarageError(f"unknown sync rpc {t!r}")


class SyncWorker(Worker):
    """ref sync.rs:493-614: queue of partitions to sync, refilled by the
    anti-entropy timer, ring changes and manual full-sync requests."""

    def __init__(self, syncer: TableSyncer):
        self.syncer = syncer
        self.todo: List = []
        self.next_full_sync = time.monotonic() + random.uniform(0.0, 30.0)
        self._notify = asyncio.Event()
        self._fail_streak = 0

    def name(self) -> str:
        return f"{self.syncer.data.schema.TABLE_NAME} sync"

    def add_full_sync(self):
        self.todo = list(self.syncer.data.replication.partitions())
        self.next_full_sync = time.monotonic() + anti_entropy_interval()
        self._notify.set()

    async def work(self) -> WorkerState:
        st = self.status()
        if time.monotonic() >= self.next_full_sync:
            self.add_full_sync()
        st.queue_length = len(self.todo)
        if not self.todo:
            return WorkerState.IDLE
        partition, first_hash = self.todo.pop(0)
        st.queue_length = len(self.todo)
        st.progress = f"partition {partition}"
        try:
            await self.syncer.sync_partition(partition, first_hash)
            self._fail_streak = 0
        except Exception as e:
            # A failed partition goes to the BACK of the queue and the
            # worker keeps going — raising here fed the runner's global
            # exponential backoff, so a ~30 s peer outage during a
            # 256-partition pass racked up enough consecutive errors to
            # freeze sync for the better part of an hour AFTER the peer
            # came back (observed during node-loss recovery).  Only when
            # a whole sweep makes no progress do we pause briefly.
            logger.debug(
                "%s: sync of partition %d failed (requeued): %s",
                self.syncer.data.schema.TABLE_NAME, partition, e,
            )
            st.errors += 1
            st.last_error = f"{type(e).__name__}: {e}"
            st.last_error_time = time.time()
            self.todo.append((partition, first_hash))
            self._fail_streak += 1
            if self._fail_streak >= max(8, len(self.todo)):
                self._fail_streak = 0
                await asyncio.sleep(10.0)
        return WorkerState.BUSY

    async def wait_for_work(self) -> None:
        self._notify.clear()
        delay = max(0.1, self.next_full_sync - time.monotonic())
        try:
            await asyncio.wait_for(self._notify.wait(), timeout=delay)
        except asyncio.TimeoutError:
            pass


def anti_entropy_interval() -> float:
    """Test hook: module-level override point."""
    return ANTI_ENTROPY_INTERVAL
