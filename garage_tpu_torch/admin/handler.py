"""AdminRpcHandler — cluster administration over the RPC fabric.

Equivalent of reference src/garage/admin/mod.rs:37-99 + bucket.rs +
key.rs + block.rs (SURVEY.md §2.9): status, layout staging/apply, bucket
and key CRUD with permission grants, worker introspection and runtime
variables, repair launchers, and node statistics.  Commands arrive as
msgpack dicts {"cmd": ..., ...} on the "garage/admin" endpoint.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, List, Optional

from ..model.permission import BucketKeyPerm
from ..rpc.layout import LayoutParameters, NodeRole
from ..utils.crdt import now_msec
from ..utils.data import Hash, Uuid
from ..utils.error import GarageError

logger = logging.getLogger("garage_tpu_torch.admin")

_DURATION_UNITS = {"s": 1, "m": 60, "h": 3600, "d": 86400, "w": 7 * 86400}


def _parse_duration(v) -> float:
    """'30s' / '15m' / '2h' / '1d' / '1w' or plain seconds (ref uses the
    parse_duration crate for --older-than).  Must be finite and ≥ 0 — a
    negative duration would put the cutoff in the future and abort
    in-flight uploads."""
    import math

    s = str(v).strip()
    out = None
    try:
        out = float(s)
    except ValueError:
        unit = _DURATION_UNITS.get(s[-1:])
        if unit is not None:
            try:
                out = float(s[:-1]) * unit
            except ValueError:
                pass
    if out is None or not math.isfinite(out) or out < 0:
        raise GarageError(
            f"invalid duration {v!r} (use e.g. 30s, 15m, 2h, 1d)")
    return out


class AdminRpcHandler:
    def __init__(self, garage, register_endpoint: bool = True):
        """register_endpoint=False: embed the command set without claiming
        the netapp endpoint (the HTTP admin API reuses these handlers; the
        daemon's CLI-facing instance owns the endpoint)."""
        self.garage = garage
        self.helper = garage.helper()
        if register_endpoint:
            self.endpoint = garage.system.netapp.endpoint("garage/admin")
            self.endpoint.set_handler(self._handle)

    async def _handle(self, remote, msg, body):
        cmd = msg.get("cmd")
        fn = getattr(self, f"_cmd_{cmd}", None)
        if fn is None:
            return {"err": f"unknown admin command {cmd!r}"}, None
        try:
            return {"ok": await fn(msg)}, None
        except GarageError as e:
            return {"err": str(e)}, None
        except Exception as e:  # noqa: BLE001 — report to CLI
            logger.exception("admin command %s failed", cmd)
            return {"err": f"{type(e).__name__}: {e}"}, None

    # --- status / layout ---------------------------------------------------

    async def _cmd_status(self, msg) -> Dict:
        sys = self.garage.system
        h = sys.health()
        return {
            "node_id": bytes(sys.id).hex(),
            "hostname": sys._local_status().hostname,
            "known_nodes": sys.get_known_nodes(),
            "layout_version": sys.layout.version,
            "roles": {
                nid.hex(): [r.zone, r.capacity, r.tags]
                for nid, r in sys.layout.node_roles().items()
            },
            "staged": {
                nid.hex(): ([r.zone, r.capacity, r.tags] if r else None)
                for nid, r in sys.layout.staged_roles().items()
            },
            "parameters": {
                "zone_redundancy": sys.layout.parameters.zone_redundancy,
            },
            # only a GENUINE pending change (staging resets to the active
            # parameters on apply/revert; echoing it back always would
            # make every `layout show` look like a change is pending)
            "staged_parameters": (
                {"zone_redundancy": staged_zr}
                if (staged_zr := LayoutParameters.unpack(
                    sys.layout.staging_parameters.value
                ).zone_redundancy) != sys.layout.parameters.zone_redundancy
                else None
            ),
            "health": {
                "status": h.status,
                "known_nodes": h.known_nodes,
                "connected_nodes": h.connected_nodes,
                "storage_nodes": h.storage_nodes,
                "storage_nodes_ok": h.storage_nodes_ok,
                "partitions": h.partitions,
                "partitions_quorum": h.partitions_quorum,
                "partitions_all_ok": h.partitions_all_ok,
            },
        }

    async def _cmd_connect(self, msg) -> str:
        from ..utils.data import Uuid

        addr = msg["addr"]
        # Uuid, not raw bytes: netapp's id-mismatch diagnostics call
        # hex_short() on it (a raw-bytes expected_id turned a clean
        # "peer is X, expected Y" error into an AttributeError)
        expected = Uuid(bytes.fromhex(msg["node_id"])) if msg.get("node_id") else None
        await self.garage.system.netapp.connect(addr, expected_id=expected)
        self.garage.system.peering.add_peer(addr, expected)
        return "connected"

    async def _cmd_layout_assign(self, msg) -> str:
        sys = self.garage.system
        node_hex = msg["node"]
        nid = self._resolve_node(node_hex)
        if msg.get("remove"):
            sys.layout.stage_role(nid, None)
        else:
            role = NodeRole(
                zone=msg["zone"],
                capacity=msg.get("capacity"),
                tags=list(msg.get("tags", [])),
            )
            sys.layout.stage_role(nid, role)
        sys.save_layout()
        return "staged"

    async def _cmd_layout_config(self, msg) -> str:
        """Stage layout parameters (ref cli/layout.rs LayoutConfig:
        currently zone redundancy — 'maximum' or an integer ≥ 1)."""
        zr = msg.get("zone_redundancy")
        if zr is None:
            raise GarageError("nothing to configure (need zone-redundancy)")
        if zr != "maximum":
            try:
                zr = int(zr)
            except (TypeError, ValueError):
                raise GarageError(
                    f"zone-redundancy must be 'maximum' or an integer, "
                    f"got {zr!r}")
            factor = self.garage.replication_mode.replication_factor
            if not 1 <= zr <= factor:
                # ref cli/layout.rs rejects out-of-range values at config
                # time; accepting them would silently clamp at apply
                raise GarageError(
                    f"zone-redundancy must be in [1, {factor}] "
                    f"(the replication factor), or 'maximum'")
        sys = self.garage.system
        sys.layout.stage_parameters(LayoutParameters(zone_redundancy=zr))
        sys.save_layout()
        return f"staged zone-redundancy = {zr}"

    async def _cmd_layout_apply(self, msg) -> List[str]:
        sys = self.garage.system
        version = msg.get("version")
        messages = sys.layout.apply_staged_changes(version)
        sys.save_layout()
        sys._rebuild_ring()
        await sys.broadcast_layout()
        return messages

    async def _cmd_layout_revert(self, msg) -> str:
        sys = self.garage.system
        sys.layout.revert_staged_changes(msg.get("version"))
        sys.save_layout()
        return "reverted"

    def _resolve_node(self, node_hex: str) -> bytes:
        """Accept unambiguous hex prefixes of known node ids."""
        sys = self.garage.system
        candidates = {bytes(sys.id)}
        candidates.update(bytes(n) for n in sys.peering.connected_nodes())
        candidates.update(sys.layout.node_roles().keys())
        matches = [n for n in candidates if n.hex().startswith(node_hex.lower())]
        if len(matches) != 1:
            raise GarageError(
                f"node id prefix {node_hex!r} matches {len(matches)} nodes"
            )
        return matches[0]

    # --- buckets -----------------------------------------------------------

    async def _cmd_bucket_list(self, msg) -> List[Dict]:
        out = []
        for b in await self.helper.list_buckets():
            p = b.params()
            out.append({
                "id": bytes(b.id).hex(),
                "aliases": [n for n, l in p.aliases.items.items() if l.value],
                "keys": len([1 for _k, l in p.authorized_keys.items.items() if l.value.is_any()]),
            })
        return out

    async def _cmd_bucket_info(self, msg) -> Dict:
        bid = await self._bucket_id(msg["bucket"])
        b = await self.helper.get_existing_bucket(bid)
        p = b.params()
        counters = await self.garage.object_counter.get_totals(bytes(bid))
        mpu_counters = await self.garage.mpu_counter.get_totals(bytes(bid))
        return {
            "id": bytes(bid).hex(),
            "aliases": [n for n, l in p.aliases.items.items() if l.value],
            "website": p.website_config.value,
            "quotas": p.quotas.value,
            "keys": {
                k: [l.value.allow_read, l.value.allow_write, l.value.allow_owner]
                for k, l in p.authorized_keys.items.items()
                if l.value.is_any()
            },
            "objects": counters.get("objects", 0),
            "bytes": counters.get("bytes", 0),
            "unfinished_uploads": counters.get("unfinished_uploads", 0),
            "mpu_uploads": mpu_counters.get("uploads", 0),
        }

    async def _cmd_bucket_create(self, msg) -> str:
        b = await self.helper.create_bucket(msg["name"])
        return bytes(b.id).hex()

    async def _cmd_bucket_delete(self, msg) -> str:
        bid = await self._bucket_id(msg["bucket"])
        await self.helper.delete_bucket(bid)
        return "deleted"

    async def _cmd_bucket_alias(self, msg) -> str:
        from ..model.bucket_alias_table import BucketAlias

        bid = await self._bucket_id(msg["bucket"])
        name = msg["alias"]
        existing = await self.helper.resolve_global_bucket_name(name)
        if existing is not None:
            raise GarageError(f"alias {name!r} already in use")
        b = await self.helper.get_existing_bucket(bid)
        b.params().aliases.update(name, True)
        await self.garage.bucket_table.insert(b)
        await self.garage.bucket_alias_table.insert(BucketAlias.new(name, bid))
        return "aliased"

    async def _cmd_bucket_unalias(self, msg) -> str:
        name = msg["alias"]
        alias = await self.garage.bucket_alias_table.get(name, "")
        if alias is None or alias.bucket_id() is None:
            raise GarageError(f"no such alias {name!r}")
        bid = alias.bucket_id()
        b = await self.helper.get_existing_bucket(bid)
        if self.helper.bucket_name_count(b) <= 1:
            raise GarageError("cannot remove the last alias of a bucket")
        b.params().aliases.update(name, False)
        alias.state.update(None)
        await self.garage.bucket_table.insert(b)
        await self.garage.bucket_alias_table.insert(alias)
        return "unaliased"

    async def _cmd_bucket_allow(self, msg) -> str:
        bid = await self._bucket_id(msg["bucket"])
        key = await self._find_key(msg["key"])
        cur = key.bucket_permissions(bid)
        perm = BucketKeyPerm(
            cur.allow_read or bool(msg.get("read")),
            cur.allow_write or bool(msg.get("write")),
            cur.allow_owner or bool(msg.get("owner")),
        )
        await self.helper.set_bucket_key_permissions(bid, key.key_id, perm)
        return "allowed"

    async def _cmd_bucket_deny(self, msg) -> str:
        bid = await self._bucket_id(msg["bucket"])
        key = await self._find_key(msg["key"])
        cur = key.bucket_permissions(bid)
        perm = BucketKeyPerm(
            cur.allow_read and not msg.get("read"),
            cur.allow_write and not msg.get("write"),
            cur.allow_owner and not msg.get("owner"),
        )
        await self.helper.set_bucket_key_permissions(bid, key.key_id, perm)
        return "denied"

    async def _cmd_bucket_website(self, msg) -> str:
        bid = await self._bucket_id(msg["bucket"])
        b = await self.helper.get_existing_bucket(bid)
        if msg.get("allow"):
            b.params().website_config.update({
                "index_document": msg.get("index_document", "index.html"),
                "error_document": msg.get("error_document"),
            })
        else:
            b.params().website_config.update(None)
        await self.garage.bucket_table.insert(b)
        return "updated"

    async def _cmd_bucket_set_quotas(self, msg) -> str:
        bid = await self._bucket_id(msg["bucket"])
        b = await self.helper.get_existing_bucket(bid)
        b.params().quotas.update({
            "max_size": msg.get("max_size"),
            "max_objects": msg.get("max_objects"),
        })
        await self.garage.bucket_table.insert(b)
        return "updated"

    async def _bucket_id(self, name_or_id: str) -> Uuid:
        return await self.helper.resolve_bucket(name_or_id)

    # --- keys --------------------------------------------------------------

    async def _find_key(self, pattern: str):
        """key id or unambiguous prefix or name (ref cli key search)."""
        k = await self.garage.key_table.get(pattern, "")
        if k is not None and not k.is_deleted():
            return k
        matches = [
            k for k in await self.helper.list_keys()
            if k.key_id.startswith(pattern) or k.params().name.value == pattern
        ]
        if len(matches) != 1:
            raise GarageError(f"key {pattern!r} matches {len(matches)} keys")
        return matches[0]

    async def _cmd_key_list(self, msg) -> List[Dict]:
        return [
            {"id": k.key_id, "name": k.params().name.value}
            for k in await self.helper.list_keys()
        ]

    async def _cmd_key_info(self, msg) -> Dict:
        k = await self._find_key(msg["key"])
        p = k.params()
        return {
            "id": k.key_id,
            "name": p.name.value,
            "secret": p.secret_key if msg.get("show_secret") else None,
            "allow_create_bucket": p.allow_create_bucket.value,
            "buckets": {
                bid.hex(): [l.value.allow_read, l.value.allow_write, l.value.allow_owner]
                for bid, l in p.authorized_buckets.items.items()
                if l.value.is_any()
            },
        }

    async def _cmd_key_create(self, msg) -> Dict:
        k = await self.helper.create_key(msg.get("name", "unnamed"))
        return {"id": k.key_id, "secret": k.params().secret_key}

    async def _cmd_key_delete(self, msg) -> str:
        k = await self._find_key(msg["key"])
        await self.helper.delete_key(k)
        return "deleted"

    async def _cmd_key_import(self, msg) -> str:
        from ..model.key_table import Key

        existing = await self.garage.key_table.get(msg["id"], "")
        if existing is not None and not existing.is_deleted():
            raise GarageError("key id already exists")
        k = Key.import_key(msg["id"], msg["secret"], msg.get("name", "imported"))
        await self.garage.key_table.insert(k)
        return "imported"

    async def _cmd_key_set(self, msg) -> str:
        k = await self._find_key(msg["key"])
        if "allow_create_bucket" in msg:
            k.params().allow_create_bucket.update(bool(msg["allow_create_bucket"]))
        if msg.get("name"):
            k.params().name.update(msg["name"])
        await self.garage.key_table.insert(k)
        return "updated"

    # --- cluster network health (no reference equivalent: the per-peer
    #     RPC-fabric view `garage node` ops keep asking for) ---------------

    async def _cmd_cluster_stats(self, msg) -> Dict:
        """Per-peer network health: RTT EWMA, liveness, failure streaks,
        reconnect churn, and live per-priority traffic split — the
        straggler-attribution view (a quorum PUT stalling on ONE slow
        peer shows up here as that peer's RTT/backlog, not as generic
        API latency)."""
        sys = self.garage.system
        now = time.monotonic()
        peers = []
        for nid, st in sys.peering.peers.items():
            conn = sys.netapp.conns.get(nid)
            status = sys.node_status.get(nid)
            # the shared health core (zone/up/rtt/breaker/pressure/
            # health_score/fail_slow/disk/version — same truth the
            # flight-recorder `peers` section snapshots), plus the
            # connection-level detail only this view renders
            row = sys.peer_core_row(nid, st)
            row.update({
                "hostname": status.hostname if status else None,
                "addr": st.addr,
                "connected": conn is not None and not conn._closed,
                "consecutive_failures": st.failures,
                "reconnects": st.reconnects,
                "ping_failures": st.ping_failures,
                "last_seen_secs_ago": (
                    round(now - st.last_seen, 1)
                    if st.last_seen is not None else None),
                "traffic": conn.traffic_stats() if conn is not None else None,
            })
            peers.append(row)
        # zone grouping: peers sort by zone so a zone outage reads as one
        # contiguous block, and the rollup makes it one line
        peers.sort(key=lambda p: (p["zone"] or "~", not p["up"], p["id"]))
        disk_rank = {"ok": 0, "degraded": 1, "failed": 2}
        zones: Dict[str, Dict] = {}
        for nid_b, role in sys.layout.node_roles().items():
            if role.capacity is None:
                continue  # gateways store nothing — not a zone's health
            from ..utils.data import FixedBytes32

            nid = FixedBytes32(nid_b)
            z = zones.setdefault(role.zone, {
                "nodes": 0, "up": 0, "breaker_open": 0,
                "worst_disk": "ok",
            })
            z["nodes"] += 1
            if nid == sys.id:
                z["up"] += 1
                ds = self.garage.block_manager.health.worst_state()
            else:
                if sys.peering.is_up(nid):
                    z["up"] += 1
                if sys.peering.breaker_state(nid) == "open":
                    z["breaker_open"] += 1
                status = sys.node_status.get(nid)
                ds = status.disk_state if status else None
            if ds and disk_rank.get(ds, 0) > disk_rank[z["worst_disk"]]:
                z["worst_disk"] = ds
        # local disk health: the per-root state machine + quarantine
        # counters (block/health.py) — the node-side truth behind the
        # gossiped disk_state peers see above
        mgr = self.garage.block_manager
        disk = {
            "state": mgr.health.worst_state(),
            "roots": [
                {
                    "path": r,
                    "state": s,
                    "free_bytes": mgr.health.free_bytes(r),
                }
                for r, s in mgr.health.states().items()
            ],
            "error_counts": {
                # snapshot first: note_error inserts new (op, kind) keys
                # from worker threads while this comprehension runs
                f"{op}:{kind}": n
                for (op, kind), n in dict(mgr.health.error_counts).items()
            },
            "quarantined": mgr.quarantined,
            "quarantine_errors": mgr.quarantine_errors,
        }
        return {
            "node_id": bytes(sys.id).hex(),
            "zone": sys.our_zone(),
            "version": sys.version,
            "disk": disk,
            "zones": zones,
            "peers": peers,
        }

    # --- workers / repair / stats -----------------------------------------

    async def _cmd_worker_list(self, msg) -> List[Dict]:
        out = []
        for wid, w in self.garage.bg.workers.items():
            st = w.status()
            out.append({"id": wid, "name": w.name(), **st.to_dict()})
        return out

    async def _cmd_worker_info(self, msg) -> Dict:
        """Single-worker drill-down (ref src/garage/admin/mod.rs:47-66
        WorkerInfo + cli worker info): full status incl. last error with
        its timestamp, queue depth, progress, and the runtime-tunable
        values that apply to this worker."""
        wid = int(msg["id"])
        w = self.garage.bg.workers.get(wid)
        if w is None:
            raise GarageError(f"no worker with id {wid}")
        st = w.status()
        task = self.garage.bg.tasks.get(wid)
        vars_all = self.garage.bg_vars.all()
        name_l = w.name().lower()
        # tunables whose name shares a DISTINCTIVE word with the
        # worker's name (e.g. scrub-tranquility for the scrub worker) —
        # the reference shows the worker's parameter set in `worker
        # info`.  Generic tokens are excluded: 'worker' appears in
        # every worker's name and would attach e.g.
        # resync-worker-count to all of them.
        generic = {"worker", "workers", "count", "n", "max", "min"}
        related = {
            k: v for k, v in vars_all.items()
            if any(part and part not in generic and part in name_l
                   for part in k.split("-"))
        }
        return {
            "id": wid,
            "name": w.name(),
            "alive": task is not None and not task.done(),
            **st.to_dict(),
            "last_error_time": st.last_error_time or None,
            "last_error_ago_s": (
                round(time.time() - st.last_error_time, 1)
                if st.last_error_time else None),
            "tunables": related,
        }

    async def _cmd_worker_get_var(self, msg) -> Dict:
        if msg.get("var"):
            return {msg["var"]: self.garage.bg_vars.get(msg["var"])}
        return self.garage.bg_vars.all()

    async def _cmd_worker_set_var(self, msg) -> str:
        self.garage.bg_vars.set(msg["var"], msg["value"])
        return "set"

    # --- block operations (ref garage/admin/block.rs) -----------------------

    def _parse_block_hash(self, hx: str) -> Hash:
        try:
            b = bytes.fromhex(hx)
        except ValueError:
            raise GarageError(f"invalid block hash {hx!r}")
        if len(b) != 32:
            raise GarageError(f"invalid block hash {hx!r}")
        return Hash(b)

    async def _cmd_block_list_errors(self, msg) -> List[Dict]:
        """Blocks currently in resync error backoff (ref block.rs:14-25)."""
        from ..block.resync import ErrorCounter

        resync = self.garage.block_manager.resync
        out = []
        k = b""
        while True:
            nxt = resync.errors.tree.get_gt(k)
            if nxt is None:
                break
            k, v = nxt
            ec = ErrorCounter.parse(v)
            out.append({
                "hash": k.hex(),
                "errors": ec.errors,
                "last_try_secs_ago": max(
                    0, (now_msec() - ec.last_try) // 1000),
                "next_try_in_secs": max(
                    0, (ec.next_try() - now_msec()) // 1000),
            })
        return out

    async def _cmd_block_info(self, msg) -> Dict:
        """Refcount + referencing versions/objects/uploads of one block
        (ref block.rs:27-61)."""
        g = self.garage
        h = self._parse_block_hash(msg["hash"])
        rc = g.block_manager.rc.get(h)
        found = g.block_manager.find_block(h)
        refs = await g.block_ref_table.get_range(h, limit=10000)
        versions = []
        for br in refs:
            v = await g.version_table.get(br.version, "")
            if v is None:
                versions.append({"version": bytes(br.version).hex(),
                                 "deleted": br.deleted.value})
                continue
            ent = {
                "version": bytes(br.version).hex(),
                "deleted": v.deleted.value,
                "bucket_id": bytes(v.bucket_id).hex() if v.bucket_id else None,
                "key": v.key,
            }
            if v.mpu_upload_id:
                ent["upload_id"] = bytes(v.mpu_upload_id).hex()
            versions.append(ent)
        return {
            "hash": bytes(h).hex(),
            "refcount": rc.count,
            "deletable": rc.is_deletable(),
            "present": found is not None,
            "path": found[0] if found else None,
            "versions": versions,
        }

    async def _cmd_block_retry_now(self, msg) -> str:
        """Clear backoff + requeue errored blocks (ref block.rs:63-93)."""
        resync = self.garage.block_manager.resync
        if msg.get("all"):
            if msg.get("blocks"):
                raise GarageError("--all cannot be combined with hashes")
            hashes = [e["hash"] for e in await self._cmd_block_list_errors({})]
        else:
            hashes = msg.get("blocks") or []
        for hx in hashes:
            h = self._parse_block_hash(hx)
            resync.clear_backoff(h)
            resync.put_to_resync(h, 0.0, source="admin_retry")
        return f"{len(hashes)} blocks returned in queue for a retry now"

    async def _cmd_block_purge(self, msg) -> str:
        """Drop every version/object/upload referencing the given blocks —
        LOSES DATA; the last resort for an unrecoverable block
        (ref block.rs:95-193)."""
        if not msg.get("yes"):
            raise GarageError("pass --yes to confirm the purge operation")
        from ..model.s3.object_table import (
            Object,
            ObjectVersion,
            ObjectVersionData,
        )
        from ..model.s3.version_table import Version
        from ..utils.data import gen_uuid

        g = self.garage
        obj_dels = ver_dels = mpu_dels = 0
        for hx in msg.get("blocks") or []:
            h = self._parse_block_hash(hx)
            refs = await g.block_ref_table.get_range(h, limit=10000)
            for br in refs:
                v = await g.version_table.get(br.version, "")
                if v is None:
                    continue
                bucket_id, key, ov_id = v.bucket_id, v.key, v.uuid
                if v.mpu_upload_id:
                    mpu = await g.mpu_table.get(v.mpu_upload_id, "")
                    if mpu is not None:
                        if not mpu.deleted.value:
                            mpu.deleted.set()
                            mpu.parts = {}
                            await g.mpu_table.insert(mpu)
                            mpu_dels += 1
                        bucket_id, key, ov_id = (
                            mpu.bucket_id, mpu.key, mpu.upload_id)
                    else:
                        # MPU row lost (the inconsistency purge exists to
                        # clean up): no object to delete-mark, but the
                        # version tombstone below MUST still happen or the
                        # block_ref survives (ref block.rs:115-135)
                        bucket_id = None
                obj = (await g.object_table.get(bucket_id, key)
                       if bucket_id is not None else None)
                if obj is not None:
                    complete = [ov for ov in obj.versions()
                                if ov.is_complete()]
                    if complete and complete[-1].uuid == ov_id:
                        # newest complete version holds the bad block:
                        # supersede it with a delete marker
                        dv = ObjectVersion(
                            gen_uuid(), complete[-1].timestamp + 1,
                            ["complete", ObjectVersionData.delete_marker()],
                        )
                        await g.object_table.insert(
                            Object(bucket_id, key, [dv]))
                        obj_dels += 1
                if not v.deleted.value:
                    await g.version_table.insert(
                        Version.new(v.uuid, v.bucket_id or b"", v.key,
                                    deleted=True)
                        if not v.mpu_upload_id else
                        Version(v.uuid, v.bucket_id, v.key, deleted=True,
                                mpu_upload_id=v.mpu_upload_id)
                    )
                    ver_dels += 1
        return (f"purged {len(msg.get('blocks') or [])} blocks: "
                f"{ver_dels} versions, {obj_dels} objects, "
                f"{mpu_dels} uploads deleted")

    # --- codec observability (the dataplane's "why is tpu_frac 0.0"
    #     commands; no reference equivalent — the ops/ layer is ours) ---

    async def _cmd_codec_info(self, msg) -> Dict:
        """Backend, effective params, gate state, byte split and
        per-stage attribution of the block manager's codec."""
        out = self.garage.block_manager.codec.info()
        out["heals"] = dict(self.garage.block_manager.heal_counts)
        feeder = self.garage.block_manager.feeder
        out["feeder"] = feeder.stats() if feeder is not None else None
        resync = self.garage.block_manager.resync
        if resync is not None:
            out["resync_enqueues"] = dict(resync.enqueue_counts)
        return out

    async def _cmd_codec_events(self, msg) -> List[Dict]:
        """The bounded gate-decision event ring: every probe result,
        gate open/hold, ramp step, fused-kernel demotion and sync
        failure with a reason label, most recent last."""
        limit = msg.get("limit")
        return self.garage.block_manager.codec.obs.events_list(
            int(limit) if limit else None
        )

    async def _cmd_codec_profile(self, msg) -> Dict:
        """Controlled link sweep on the live DeviceTransport: sizes x
        batch shapes x kinds, each cell decomposed into the exact-sum
        stage breakdown (ops/link_profiler.py run_sweep).  Serial and
        synchronous by design — bounded cells, run off-loop."""
        from ..ops.link_profiler import run_sweep

        codec = self.garage.block_manager.codec
        tr = getattr(codec, "transport", None)
        if tr is None or not tr.alive:
            raise GarageError("no live device transport to profile")
        sizes = msg.get("sizes_mib") or (1.0, 4.0, 16.0)
        shapes = msg.get("shapes") or (1, 16)
        kinds = msg.get("kinds") or ("hash", "encode", "decode")
        rounds = int(msg.get("rounds") or 1)
        if len(sizes) * len(shapes) * len(kinds) * rounds > 256:
            raise GarageError("sweep too large (>256 cells)")
        return await asyncio.to_thread(
            run_sweep, tr,
            sizes_mib=tuple(float(s) for s in sizes),
            shapes=tuple(int(s) for s in shapes),
            kinds=tuple(kinds),
            rounds=rounds,
        )

    async def _cmd_cpu_profile(self, msg) -> Dict:
        """The continuous CPU profiler's readout (utils/cpuprof.py):
        folded stacks covering roughly the last `seconds`, joined to
        thread roles and span segments, plus the windowed busy ratios
        and the sampler's measured self-cost.  Served from the always-on
        sampler's history — no re-sampling wait."""
        prof = getattr(self.garage, "cpuprof", None)
        if prof is None or not prof.running:
            raise GarageError("cpu profiler is not running on this node")
        seconds = float(msg.get("seconds") or 10.0)
        if not 0.0 < seconds <= 3600.0:
            raise GarageError("seconds must be in (0, 3600]")
        top = msg.get("top")
        top_k = int(top) if top else 40
        if not 0 < top_k <= 512:
            raise GarageError("top must be in (0, 512]")
        return prof.profile(seconds=seconds, top_k=top_k)

    async def _cmd_slow_ops(self, msg) -> List[Dict]:
        """Top-N slowest spans retained by the always-on slow-op log
        (works with no trace_sink configured), slowest first."""
        limit = msg.get("limit")
        return self.garage.system.tracer.slow.snapshot(
            int(limit) if limit else None
        )

    # --- critical-path attribution (docs/OBSERVABILITY.md "Critical
    #     path & saturation"; utils/waterfall.py) ----------------------

    async def _cmd_trace_spans(self, msg) -> List[Dict]:
        """Every span record THIS node holds for one trace id — the
        per-peer fetch the waterfall merge fans out (a request's remote
        handler/table/disk spans live on the nodes that ran them)."""
        wf = getattr(self.garage.system.tracer, "waterfall", None)
        if wf is None:
            return []
        return wf.spans_for_trace(str(msg["trace"]))

    async def _cmd_request_waterfall(self, msg) -> Dict:
        """The request-waterfall surface.  Without a selector: the
        per-endpoint summary + retained slowest exemplars.  With
        `trace` (an x-amz-request-id) or `endpoint`: ONE request's full
        span tree, merged across every layout node that contributed
        spans, with the critical-path segment breakdown recomputed over
        the merged tree."""
        wf = getattr(self.garage.system.tracer, "waterfall", None)
        if wf is None:
            raise GarageError("no waterfall recorder on this node")
        trace = msg.get("trace")
        endpoint = msg.get("endpoint")
        if trace is None and endpoint is None and not msg.get("pick"):
            return {
                "endpoints": wf.endpoints(),
                "retained": wf.entries(),
                "sampled": wf.sampled,
            }
        entry = wf.entry_for(trace_id=trace, endpoint=endpoint)
        if entry is None:
            raise GarageError(
                f"no retained waterfall for "
                f"{'trace ' + trace if trace else 'endpoint ' + str(endpoint)}"
            )
        return await self._merged_waterfall(entry)

    async def _merged_waterfall(self, entry: Dict) -> Dict:
        from ..utils.waterfall import (
            build_tree,
            dominant_segment,
            segment_breakdown,
        )

        tid = entry["trace_id"]
        spans = {r["span"]: dict(r) for r in entry["local_spans"]}
        nodes_contributing = 1
        endpoint_rpc = getattr(self, "endpoint", None)
        if endpoint_rpc is not None:
            import asyncio

            from ..net.frame import PRIO_NORMAL

            sys = self.garage.system
            peers = [nid for nid in sys.layout.node_roles().keys()
                     if bytes(nid) != bytes(sys.id)]

            async def fetch(nid):
                try:
                    resp = await endpoint_rpc.call(
                        nid, {"cmd": "trace_spans", "trace": tid},
                        prio=PRIO_NORMAL, timeout=5.0)
                    return resp.get("ok") or []
                except Exception:  # noqa: BLE001 — best-effort merge
                    return []

            for remote in await asyncio.gather(*[fetch(n) for n in peers]):
                if remote:
                    nodes_contributing += 1
                for r in remote:
                    spans.setdefault(r["span"], dict(r))
        records = list(spans.values())
        root = next((r for r in records if r.get("parent") is None
                     and (r.get("attrs") or {}).get("api")), None)
        if root is None:
            root = max(records,
                       key=lambda r: r["end_ns"] - r["start_ns"])
        segments = segment_breakdown(records, root)
        dom, _s = dominant_segment(segments)
        return {
            "trace_id": tid,
            "endpoint": entry["endpoint"],
            "seconds": entry["seconds"],
            "ts": entry["ts"],
            "segments": {k: round(v, 6) for k, v in sorted(
                segments.items(), key=lambda kv: -kv[1])},
            "dominant": dom,
            "span_count": len(records),
            "nodes_contributing": nodes_contributing,
            "tree": build_tree(records, root),
        }

    async def _cmd_device_timeline(self, msg) -> Dict:
        """The device/transport pipeline timeline as Chrome-trace
        (catapult) JSON — load into chrome://tracing or Perfetto; the
        per-slot tracks show staging overlapping compute (or not)."""
        limit = msg.get("limit")
        tl = self.garage.block_manager.codec.obs.timeline
        return tl.chrome_trace(int(limit) if limit else None)

    async def _cmd_exemplars(self, msg) -> List[Dict]:
        """Current-window histogram exemplars: for each exemplar-enabled
        family and label set, the max observation and the trace id that
        produced it — the bridge from a p99 bucket to `request
        waterfall --trace`."""
        from ..utils.metrics import Histogram

        out = []
        for m in self.garage.system.metrics._metrics:
            if isinstance(m, Histogram) and m.exemplars:
                for ex in m.exemplar_snapshot():
                    out.append({"family": m.name, **ex})
        return out

    # --- fleet health & SLOs (docs/OBSERVABILITY.md "Fleet health &
    #     SLOs"; utils/slo.py + utils/flightrec.py) --------------------

    async def _cmd_slo_status(self, msg) -> Dict:
        """Per-(endpoint, objective) budget table: targets, window
        event counts, fast/slow burn rates, budget remaining — the CLI
        `slo status` payload."""
        slo = getattr(self.garage, "slo", None)
        if slo is None:
            raise GarageError("no SLO tracker on this node")
        return {
            "node_id": bytes(self.garage.system.id).hex(),
            "windows": {"fast_s": slo.tun.fast_window_s,
                        "slow_s": slo.tun.slow_window_s},
            "fast_burn_threshold": slo.tun.fast_burn_threshold,
            "fast_burn_breaches": slo.fast_burn_breaches,
            "rows": slo.status(),
        }

    async def _cmd_incident_capture(self, msg) -> Dict:
        """Manual flight-recorder capture (skips the auto debounce —
        an operator asking for a snapshot always gets one).  Collectors
        run here on the loop (race-free reads of loop-owned state, at
        Prometheus-scrape cost); the expensive serialize + disk write
        runs off it — manual captures happen exactly when the node is
        degraded, and writing a large bundle inline would stall every
        in-flight request (same split as the auto path in
        utils/flightrec.py)."""
        import asyncio

        fr = getattr(self.garage, "flightrec", None)
        if fr is None:
            raise GarageError("no flight recorder on this node")
        bundle = fr.collect(msg.get("reason") or "manual",
                            trigger="manual")
        path = await asyncio.to_thread(fr.write, bundle)
        return {"path": path, "captures": fr.captures,
                "suppressed": fr.suppressed}

    async def _cmd_incident_list(self, msg) -> List[Dict]:
        """Retained incident bundles, oldest first (headers only)."""
        fr = getattr(self.garage, "flightrec", None)
        if fr is None:
            raise GarageError("no flight recorder on this node")
        return fr.bundles()

    async def _cmd_launch_repair(self, msg) -> str:
        what = msg.get("what", "tables")
        g = self.garage
        if what == "tables":
            for t in g.tables:
                if t.syncer is not None:
                    t.syncer.add_full_sync()
            return "table full sync launched"
        if what == "blocks":
            from ..block.repair import RepairWorker

            g.bg.spawn(RepairWorker(g.block_manager))
            return "block repair launched"
        if what == "scrub":
            cmd = msg.get("scrub_cmd", "start")
            if g.scrub_worker is not None:
                g.scrub_worker.send_command(cmd)
                return f"scrub {cmd} ok"
            return "no scrub worker"
        if what == "rebalance":
            from ..block.repair import RebalanceWorker

            g.bg.spawn(RebalanceWorker(g.block_manager))
            return "rebalance launched"
        if what == "versions":
            n = await self._repair_versions()
            return f"version repair: {n} orphans reaped"
        if what == "block_refs":
            n = await self._repair_block_refs()
            return f"block_ref repair: {n} orphans reaped"
        if what == "mpu":
            n = await self._repair_mpu()
            return f"mpu repair: {n} orphans reaped"
        raise GarageError(f"unknown repair {what!r}")

    async def _repair_versions(self) -> int:
        """Tombstone versions whose object no longer references them
        (ref repair/online.rs repair_versions)."""
        from ..model.s3.version_table import Version
        from ..utils.data import Hash, Uuid

        g = self.garage
        n = 0
        data = g.version_table.data
        for _k, raw in list(data.store.items(b"", None)):
            v = data.decode_entry(raw)
            if v.deleted.value:
                continue
            if v.mpu_upload_id is not None:
                mpu = await g.mpu_table.get(Uuid(v.mpu_upload_id), "")
                ok = mpu is not None and not mpu.deleted.value
            else:
                obj = await g.object_table.get(Uuid(bytes(v.bucket_id)), v.key)
                ok = obj is not None and any(
                    bytes(ov.uuid) == bytes(v.uuid)
                    and (ov.is_complete() or ov.is_uploading())
                    for ov in obj.versions()
                )
            if not ok:
                vdel = Version(
                    v.uuid, v.bucket_id, v.key, deleted=True,
                    mpu_upload_id=v.mpu_upload_id,
                )
                await g.version_table.insert(vdel)
                n += 1
        return n

    async def _repair_block_refs(self) -> int:
        """Delete block refs whose version is gone (ref online.rs)."""
        from ..model.s3.block_ref_table import BlockRef

        g = self.garage
        n = 0
        data = g.block_ref_table.data
        from ..model.parity_index_table import is_parity_ref

        for _k, raw in list(data.store.items(b"", None)):
            br = data.decode_entry(raw)
            if br.deleted.value:
                continue
            if is_parity_ref(br.version):
                # distributed-parity refs answer to the parity index
                # (tombstoned by its hook on codeword death), not to the
                # version table — reaping them here would orphan live
                # parity shards
                continue
            v = await g.version_table.get(br.version, "")
            if v is None or v.deleted.value:
                await g.block_ref_table.insert(
                    BlockRef(br.block, br.version, deleted=True)
                )
                n += 1
        return n

    async def _cmd_bucket_cleanup_uploads(self, msg) -> str:
        """Abort multipart uploads older than a duration in the given
        buckets (ref cli structs.rs CleanupIncompleteUploadsOpt +
        admin/bucket.rs handle_bucket_cleanup_incomplete_uploads).
        Aborting the object's Uploading version cascades through the
        hooks: MPU row tombstones, part versions delete, refs drop."""
        from ..model.s3.object_table import abort_uploads

        names = msg.get("buckets") or []
        if not names:
            raise GarageError("no buckets given")
        older = _parse_duration(msg.get("older_than", "1d"))
        cutoff = now_msec() - int(older * 1000)
        g = self.garage
        # resolve EVERY name before mutating anything (ref admin/bucket.rs
        # does the same): a typo in a later name must not leave earlier
        # buckets half-cleaned with no report
        resolved = []
        for name in names:
            bid = await self.helper.resolve_global_bucket_name(name)
            if bid is None:
                raise GarageError(f"bucket not found: {name}")
            resolved.append((name, bid))
        lines = []
        for name, bid in resolved:
            count = 0
            pos = ""
            while True:
                # node-side "uploading" filter: only rows with an
                # in-progress upload leave the replicas (a bucket of
                # inline objects must not cross the wire to abort 3 MPUs)
                batch = await g.object_table.get_range(
                    bid, pos, filter="uploading", limit=1000
                )
                for obj in batch:
                    count += await abort_uploads(
                        g.object_table, obj,
                        lambda v: v.timestamp < cutoff,
                    )
                if len(batch) >= 1000:
                    pos = batch[-1].key + "\x00"
                    continue
                # Short/empty filtered page is AMBIGUOUS: the coordinator
                # re-filters after the quorum merge, so matches may have
                # been dropped mid-range and an empty page has no cursor
                # to advance.  One unfiltered probe page answers "is the
                # range exhausted?" and supplies the cursor if not.
                probe = await g.object_table.get_range(
                    bid, pos, filter="any", limit=1000
                )
                if len(probe) < 1000:
                    break
                pos = probe[-1].key + "\x00"
            lines.append(f"{name}: {count} incomplete uploads aborted")
        return "\n".join(lines)

    async def _repair_mpu(self) -> int:
        """Tombstone multipart uploads whose object row no longer carries
        the matching Uploading{multipart} version — repropagates object
        deletions to the MPU table (ref repair/online.rs RepairMpu)."""
        from ..model.s3.mpu_table import MultipartUpload
        from ..utils.data import Uuid

        g = self.garage
        n = 0
        data = g.mpu_table.data
        for _k, raw in list(data.store.items(b"", None)):
            mpu = data.decode_entry(raw)
            if mpu.deleted.value:
                continue
            obj = await g.object_table.get(Uuid(mpu.bucket_id), mpu.key)
            ok = obj is not None and any(
                bytes(ov.uuid) == bytes(mpu.upload_id)
                and ov.is_uploading(check_multipart=True)
                for ov in obj.versions()
            )
            if not ok:
                await g.mpu_table.insert(MultipartUpload(
                    mpu.upload_id, mpu.timestamp, mpu.bucket_id, mpu.key,
                    deleted=True,
                ))
                n += 1
        return n

    async def _cmd_stats(self, msg) -> Dict:
        g = self.garage
        if msg.get("all"):
            # gather from every layout node, server-side fan-out (ref
            # garage/admin/mod.rs handle_stats with all_nodes=true)
            from ..net.frame import PRIO_NORMAL

            endpoint = getattr(self, "endpoint", None)
            if endpoint is None:
                raise GarageError("stats --all needs the RPC endpoint")
            import asyncio

            async def one(nid):
                if bytes(nid) == bytes(g.system.id):
                    return nid.hex(), await self._cmd_stats({})
                try:
                    resp = await endpoint.call(
                        nid, {"cmd": "stats"}, prio=PRIO_NORMAL, timeout=10.0
                    )
                    return nid.hex(), (
                        resp["ok"] if "ok" in resp
                        else {"err": resp.get("err")}
                    )
                except Exception as e:  # noqa: BLE001 — per-node report
                    return nid.hex(), {"err": f"{type(e).__name__}: {e}"}

            pairs = await asyncio.gather(
                *[one(nid) for nid in g.system.layout.node_roles().keys()]
            )
            return {"nodes": dict(pairs)}
        table_stats = {}
        for t in g.tables:
            table_stats[t.schema.TABLE_NAME] = {
                "merkle_todo": t.data.merkle_todo_len(),
                "gc_todo": t.data.gc_todo_len(),
                "insert_queue": len(t.data.insert_queue),
            }
        from .. import FEATURES, __version__

        return {
            "node_id": bytes(g.system.id).hex(),
            "garage_version": __version__,
            "features": FEATURES,
            "tables": table_stats,
            "block": {
                "rc_entries": g.block_manager.rc_len(),
                "resync_queue": g.block_resync.queue_len(),
                "resync_errors": g.block_resync.errors_len(),
                "bytes_read": g.block_manager.bytes_read,
                "bytes_written": g.block_manager.bytes_written,
                "corruptions": g.block_manager.corruptions,
                "parity_indexed": (
                    g.block_manager.parity_store.stats()["indexed_blocks"]
                    if g.block_manager.parity_store else 0
                ),
                "local_reconstructions":
                    g.block_manager.blocks_reconstructed,
                "heals": dict(g.block_manager.heal_counts),
                "resync_enqueues": dict(g.block_resync.enqueue_counts),
            },
            "codec": {
                "backend": type(g.block_manager.codec).__name__,
                "bytes": dict(g.block_manager.codec.obs.bytes_total),
                "tpu_frac": round(
                    g.block_manager.codec.obs.tpu_frac(), 4),
                "gate": getattr(g.block_manager.codec, "last_gate", None),
                "link_gibs": getattr(
                    g.block_manager.codec, "last_link_gibs", None),
            },
        }
