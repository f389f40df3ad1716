"""Table — the distributed front: quorum insert/get/range with read-repair.

Equivalent of reference src/table/table.rs (SURVEY.md §2.4): writes go to
the partition's replica set via `try_call_many` with the write quorum
(table.rs:104-137); reads use interrupt-after-quorum with latency ordering
and, on divergent replies, merge and asynchronously push the merged value
back to all replicas — read repair (table.rs:228-284); `insert_many`
batches entries per destination node (table.rs:139-206).

RPC messages (ref TableRpc enum, table.rs:46-66) are msgpack dicts:
  {"t":"update", "entries":[bytes]}           → ok
  {"t":"read_entry", "tk": bytes}             → {"v": bytes|None}
  {"t":"read_range", ...}                     → {"vs": [bytes]}
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Dict, List, Optional

from ..net.frame import PRIO_NORMAL
from ..rpc.rpc_helper import RequestStrategy
from ..rpc.system import System
from ..utils.data import FixedBytes32, Hash
from ..utils.error import GarageError
from ..utils.metrics import maybe_time
from .data import TableData
from .merkle import MerkleUpdater
from .replication import TableReplication
from .schema import Entry, TableSchema, hash_partition_key, sort_key_bytes

logger = logging.getLogger("garage_tpu_torch.table")

TABLE_RPC_TIMEOUT = 30.0


class Table:
    def __init__(
        self,
        system: System,
        schema: TableSchema,
        replication: TableReplication,
        db,
    ):
        self.system = system
        self.schema = schema
        self.replication = replication
        self.data = TableData(system, schema, replication, db)
        self.merkle = MerkleUpdater(self.data)
        self.endpoint = system.netapp.endpoint(
            f"garage/table/{schema.TABLE_NAME}"
        )
        self.endpoint.set_handler(self._handle)
        # attached by Garage.spawn_workers: syncer/gc refs for admin RPC
        self.syncer = None
        self.gc = None
        self._repair_tasks: set = set()  # strong refs: loop holds tasks weakly

        # per-table request metrics (ref table/metrics.rs): metric families
        # are shared across tables (registry dedups by name); each table
        # records with its own table_name label
        m = getattr(system, "metrics", None)
        self._tname = schema.TABLE_NAME
        if m is not None:
            self._m = {
                "gets": m.counter(
                    "table_get_request_counter", "Table get/get_range requests"),
                "puts": m.counter(
                    "table_put_request_counter", "Table insert requests"),
                "get_dur": m.histogram(
                    "table_get_request_duration_seconds", "Table read latency"),
                "put_dur": m.histogram(
                    "table_put_request_duration_seconds", "Table write latency"),
                "size": m.gauge("table_size", "Number of items in table"),
                "merkle_todo": m.gauge(
                    "table_merkle_updater_todo_queue_length",
                    "Merkle updater backlog"),
                "gc_todo": m.gauge(
                    "table_gc_todo_queue_length", "Tombstone GC backlog"),
                # the metadata-at-millions depth trio (short canonical
                # names, `table` label): the queues whose growth is the
                # first sign the table engine is behind its writers —
                # Merkle digestion, batched inserts, tombstone GC.  The
                # two legacy *_queue_length families above stay for
                # dashboard compat.
                "merkle_todo2": m.gauge(
                    "table_merkle_todo",
                    "Rows awaiting Merkle-tree digestion, per table"),
                "insert_queue": m.gauge(
                    "table_insert_queue",
                    "Entries queued in the batched insert queue, per "
                    "table"),
                "gc_todo2": m.gauge(
                    "table_gc_todo",
                    "Tombstones awaiting GC, per table"),
            }
        else:
            self._m = None

    def observe_gauges(self) -> None:
        """Refresh this table's size/backlog gauges (called at scrape)."""
        if self._m is None:
            return
        self._m["size"].set(self.data.store_len(), table_name=self._tname)
        merkle = self.data.merkle_todo_len()
        gc = self.data.gc_todo_len()
        self._m["merkle_todo"].set(merkle, table_name=self._tname)
        self._m["gc_todo"].set(gc, table_name=self._tname)
        self._m["merkle_todo2"].set(merkle, table=self._tname)
        self._m["insert_queue"].set(
            len(self.data.insert_queue), table=self._tname)
        self._m["gc_todo2"].set(gc, table=self._tname)

    # --- client operations ---

    async def insert(self, entry: Entry) -> None:
        """ref table.rs:104-137."""
        if self._m is not None:
            self._m["puts"].inc(table_name=self._tname)
        with self._span("insert"), \
                maybe_time(self._m and self._m["put_dur"],
                           table_name=self._tname):
            await self._insert_inner(entry)

    async def _insert_inner(self, entry: Entry) -> None:
        h = hash_partition_key(entry.partition_key)
        who = self.replication.write_nodes(h)
        e_enc = entry.encode()
        await self.system.rpc.try_call_many(
            self.endpoint,
            who,
            {"t": "update", "entries": [e_enc]},
            RequestStrategy(
                rs_quorum=self.replication.write_quorum(),
                rs_timeout=TABLE_RPC_TIMEOUT,
                # hard integer zone_redundancy: the acked set must span
                # the layout's failure domains (0 = availability-first)
                rs_required_zones=self.system.write_zone_requirement(who),
            ),
        )

    async def insert_many(self, entries: List[Entry]) -> None:
        """Batch insert grouped per destination node (ref table.rs:139-206);
        fails if any entry missed its write quorum."""
        per_node: Dict[FixedBytes32, List[bytes]] = {}
        per_node_keys: Dict[FixedBytes32, List[int]] = {}
        candidates: List[List[FixedBytes32]] = []
        for i, entry in enumerate(entries):
            h = hash_partition_key(entry.partition_key)
            e_enc = entry.encode()
            who = self.replication.write_nodes(h)
            candidates.append(who)
            for n in who:
                per_node.setdefault(n, []).append(e_enc)
                per_node_keys.setdefault(n, []).append(i)

        async def send(node, batch):
            await self.endpoint.call(
                node,
                {"t": "update", "entries": batch},
                timeout=TABLE_RPC_TIMEOUT,
            )

        results = await asyncio.gather(
            *[send(n, b) for n, b in per_node.items()], return_exceptions=True
        )
        ok_count = [0] * len(entries)
        ok_zones = [set() for _ in entries]
        for (node, _), res in zip(per_node.items(), results):
            if not isinstance(res, Exception):
                z = self.system.zone_of(node)
                for i in per_node_keys[node]:
                    ok_count[i] += 1
                    if z is not None:
                        ok_zones[i].add(z)
        quorum = self.replication.write_quorum()
        failed = sum(1 for c in ok_count if c < quorum)
        if failed:
            raise GarageError(
                f"insert_many: {failed}/{len(entries)} entries below write quorum"
            )
        # all sends are already in (gather, no early return), so the
        # per-entry zone check costs nothing extra: an entry that met
        # its numeric quorum inside ONE dark-zone-complement still fails
        # typed when the layout demands spread
        zone_failed = sum(
            1 for i in range(len(entries))
            if (req := self.system.write_zone_requirement(candidates[i])) > 1
            and len(ok_zones[i]) < req
        )
        if zone_failed:
            from ..utils.error import ZoneQuorumError

            # same observable as the rpc_helper write path: the Grafana
            # panel / playbook signal must see batched failures too
            if self.system.rpc.m_zone_errors is not None:
                self.system.rpc.m_zone_errors.inc(
                    endpoint=self.endpoint.path)
            raise ZoneQuorumError(
                f"insert_many: {zone_failed}/{len(entries)} entries acked "
                f"in fewer zones than the layout requires"
            )

    def _span(self, op: str):
        """Per-table-op tracing span (ref table/table.rs:105-110);
        Tracer.span is a shared no-op when tracing is off."""
        return self.system.tracer.span(
            f"Table {self._tname} {op}", table=self._tname, op=op
        )

    def _read_timer(self):
        if self._m is not None:
            self._m["gets"].inc(table_name=self._tname)
        return maybe_time(self._m and self._m["get_dur"],
                          table_name=self._tname)

    async def get(self, p: Any, s: Any) -> Optional[Entry]:
        """Quorum read with read-repair (ref table.rs:228-284)."""
        with self._span("get"), self._read_timer():
            return await self._get_inner(p, s)

    async def _get_inner(self, p: Any, s: Any) -> Optional[Entry]:
        h = hash_partition_key(p)
        who = self.replication.read_nodes(h)
        tk = self.data.tree_key(p, s)
        resps = await self.system.rpc.try_call_many(
            self.endpoint,
            who,
            {"t": "read_entry", "tk": tk},
            RequestStrategy(
                rs_quorum=self.replication.read_quorum(),
                rs_interrupt_after_quorum=True,
                rs_timeout=TABLE_RPC_TIMEOUT,
                rs_idempotent=True,  # pure read: retry/hedge freely
            ),
        )
        ret: Optional[Entry] = None
        ret_enc: Optional[bytes] = None
        not_all_same = False
        for r in resps:
            v = r.get("v")
            if v is None:
                if ret is not None:
                    not_all_same = True
                continue
            ent = self.data.decode_entry(bytes(v))
            if ret is None:
                ret, ret_enc = ent, bytes(v)
            else:
                # any reply that differs from the accumulated value means a
                # replica is stale — even if the merge absorbs it (ref
                # table.rs:252-265 flags whenever x != ret)
                if bytes(v) != ret_enc:
                    not_all_same = True
                ret.merge(ent)
                ret_enc = ret.encode()
        if ret is not None and not_all_same:
            self._spawn_repair(ret, who)
        return ret

    async def get_range(
        self,
        p: Any,
        start_sort_key: Optional[Any] = None,
        filter: Any = None,
        limit: int = 100,
        reverse: bool = False,
        end_sort_key: Optional[Any] = None,
    ) -> List[Entry]:
        """Quorum range read, merged per key, with read-repair of divergent
        items (ref table.rs:314-407).  `end_sort_key` (exclusive) bounds
        the scan — the sub-range contract sharded listings fan out over."""
        with self._span("get_range"), self._read_timer():
            return await self._get_range_inner(
                p, start_sort_key, filter, limit, reverse, end_sort_key
            )

    async def _get_range_inner(
        self, p, start_sort_key=None, filter=None, limit=100, reverse=False,
        end_sort_key=None,
    ) -> List[Entry]:
        h = hash_partition_key(p)
        who = self.replication.read_nodes(h)
        msg = {
            "t": "read_range",
            "ph": bytes(h),
            "sk": sort_key_bytes(start_sort_key) if start_sort_key is not None else None,
            "filter": filter,
            "limit": limit,
            "rev": reverse,
        }
        if end_sort_key is not None:
            msg["ek"] = sort_key_bytes(end_sort_key)
        resps = await self.system.rpc.try_call_many(
            self.endpoint,
            who,
            msg,
            RequestStrategy(
                rs_quorum=self.replication.read_quorum(),
                rs_interrupt_after_quorum=True,
                rs_timeout=TABLE_RPC_TIMEOUT,
                rs_idempotent=True,  # pure read: retry/hedge freely
            ),
        )
        # merge per tree-key (ref table.rs:353-407)
        merged: Dict[bytes, Entry] = {}
        seen_count: Dict[bytes, int] = {}
        diverged: set = set()
        # a key missing from one response only proves divergence if it lies
        # inside that response's returned window — otherwise it may simply
        # have been truncated by `limit` (window = everything if untruncated)
        windows: List[Optional[bytes]] = []  # per-response window edge, None=∞
        for r in resps:
            vs = r.get("vs", [])
            edge = None
            for v in vs:
                ent = self.data.decode_entry(bytes(v))
                tk = ent.tree_key()
                # the truncation edge is the *last* key in iteration order:
                # max for forward reads, min for reverse reads
                if edge is None or (tk < edge if reverse else tk > edge):
                    edge = tk
                seen_count[tk] = seen_count.get(tk, 0) + 1
                if tk in merged:
                    before = merged[tk].encode()
                    merged[tk].merge(ent)
                    if merged[tk].encode() != before or before != bytes(v):
                        diverged.add(tk)
                else:
                    merged[tk] = ent
            windows.append(edge if len(vs) >= limit else None)
        if len(resps) > 1:
            for tk, c in seen_count.items():
                covered = all(
                    w is None or (tk >= w if reverse else tk <= w)
                    for w in windows
                )
                if c < len(resps) and covered:
                    diverged.add(tk)
        for tk in diverged:
            self._spawn_repair(merged[tk], who)
        out = sorted(merged.items(), key=lambda kv: kv[0], reverse=reverse)
        ents = [
            e for _tk, e in out
            if filter is None or self.schema.matches_filter(e, filter)
        ]
        return ents[:limit]

    def _spawn_repair(self, entry: Entry, who: List[FixedBytes32]) -> None:
        """Asynchronously push the merged value back to all replicas
        (ref table.rs:271-283 repair_on_read)."""

        async def repair():
            try:
                await self.system.rpc.try_call_many(
                    self.endpoint,
                    who,
                    {"t": "update", "entries": [entry.encode()]},
                    RequestStrategy(rs_quorum=len(who), rs_timeout=TABLE_RPC_TIMEOUT),
                )
            except Exception as e:
                logger.debug(
                    "%s: read repair failed: %s", self.schema.TABLE_NAME, e
                )

        task = asyncio.get_running_loop().create_task(repair())
        self._repair_tasks.add(task)
        task.add_done_callback(self._repair_tasks.discard)

    # --- server side (ref table.rs:426-461) ---

    async def _handle(self, remote, msg, body):
        t = msg.get("t")
        if t == "update":
            self.data.update_many([bytes(e) for e in msg["entries"]])
            return {"ok": True}, None
        if t == "read_entry":
            v = self.data.store.get(bytes(msg["tk"]))
            return {"v": v}, None
        if t == "read_range":
            vs = self.data.read_range(
                Hash(bytes(msg["ph"])),
                bytes(msg["sk"]) if msg.get("sk") is not None else None,
                msg.get("filter"),
                int(msg.get("limit", 100)),
                bool(msg.get("rev", False)),
                bytes(msg["ek"]) if msg.get("ek") is not None else None,
            )
            return {"vs": vs}, None
        raise GarageError(f"unknown table rpc {t!r}")
