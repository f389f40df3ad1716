"""Command-line interface.

Equivalent of reference src/garage/main.rs + cli/ (SURVEY.md §2.9):
`server` runs the daemon; every other command connects to a running node
over the RPC fabric with a temporary keypair + the rpc secret from the
config file (main.rs:194-263) and drives the AdminRpcHandler.

Usage:  python -m garage_tpu_torch <command> [args]  (-c/--config garage.toml)

`server` and `offline-repair-counters` build the node's codec on the GPU
(torch is imported only there).  The admin commands talk RPC and import
only `net/` and `utils/config`, so they start without torch and never
touch the card.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import sys
from typing import Any, Dict, Optional

from .utils.format_table import format_table


def _build_parser() -> argparse.ArgumentParser:
    from . import FEATURES, __version__

    p = argparse.ArgumentParser(prog="garage_tpu_torch")
    p.add_argument(
        "-V", "--version", action="version",
        version=f"garage_tpu_torch {__version__} [features: {', '.join(FEATURES)}]",
    )
    p.add_argument("-c", "--config", default=os.environ.get(
        "GARAGE_TPU_CONFIG", "./garage.toml"
    ))
    p.add_argument("--rpc-host", default=None,
                   help="node RPC address (default: rpc_bind_addr from config)")
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("server", help="run the storage daemon")
    sub.add_parser("node-id", help="print this node's id")

    cdb = sub.add_parser(
        "convert-db",
        help="offline copy of metadata between db engines "
             "(ref cli/convert_db.rs)",
    )
    cdb.add_argument("-i", dest="input_path", required=True)
    cdb.add_argument("-a", dest="input_engine", required=True,
                     help="sqlite | native | memory")
    cdb.add_argument("-o", dest="output_path", required=True)
    cdb.add_argument("-b", dest="output_engine", required=True)

    sub.add_parser(
        "offline-repair-counters",
        help="rebuild index counters from local table rows; daemon must be "
             "stopped (ref repair/offline.rs:11-47 + index_counter.rs:252+)",
    )
    sub.add_parser("status", help="cluster status")
    pst = sub.add_parser("stats", help="node statistics")
    pst.add_argument("-a", "--all-nodes", action="store_true",
                     help="gather statistics from all cluster nodes")

    pc = sub.add_parser("connect", help="connect to a peer (id@host:port)")
    pc.add_argument("peer")

    pcl = sub.add_parser(
        "cluster",
        help="cluster-level network observability (per-peer health)")
    cls_ = pcl.add_subparsers(dest="cluster_cmd", required=True)
    cst = cls_.add_parser(
        "stats",
        help="per-peer RTT / liveness / reconnect churn / per-priority "
             "traffic split")
    cst.add_argument("--json", action="store_true",
                     help="raw JSON instead of the table rendering")

    pl = sub.add_parser("layout", help="cluster layout operations")
    ls = pl.add_subparsers(dest="layout_cmd", required=True)
    la = ls.add_parser("assign")
    la.add_argument("node")
    la.add_argument("-z", "--zone", required=True)
    la.add_argument("-c", "--capacity", default=None,
                    help="storage capacity (e.g. 10G); omit for gateway")
    la.add_argument("-t", "--tags", default="")
    lr = ls.add_parser("remove")
    lr.add_argument("node")
    ls.add_parser("show")
    lcf = ls.add_parser("config", help="stage layout parameters")
    lcf.add_argument("-z", "--zone-redundancy", default=None,
                     help="'maximum' or an integer >= 1")
    lap = ls.add_parser("apply")
    lap.add_argument("--version", type=int, default=None)
    lrv = ls.add_parser("revert")
    lrv.add_argument("--version", type=int, default=None)

    pb = sub.add_parser("bucket", help="bucket operations")
    bs = pb.add_subparsers(dest="bucket_cmd", required=True)
    bs.add_parser("list")
    for name, extra in [
        ("info", []), ("create", []), ("delete", []),
    ]:
        x = bs.add_parser(name)
        x.add_argument("bucket")
    ba = bs.add_parser("alias")
    ba.add_argument("bucket")
    ba.add_argument("alias")
    bu = bs.add_parser("unalias")
    bu.add_argument("alias")
    for name in ("allow", "deny"):
        x = bs.add_parser(name)
        x.add_argument("bucket")
        x.add_argument("--key", required=True)
        x.add_argument("--read", action="store_true")
        x.add_argument("--write", action="store_true")
        x.add_argument("--owner", action="store_true")
    bw = bs.add_parser("website")
    bw.add_argument("bucket")
    bw.add_argument("--allow", action="store_true")
    bw.add_argument("--deny", action="store_true")
    bw.add_argument("--index-document", default="index.html")
    bw.add_argument("--error-document", default=None)
    bq = bs.add_parser("set-quotas")
    bq.add_argument("bucket")
    bq.add_argument("--max-size", default=None)
    bq.add_argument("--max-objects", type=int, default=None)
    bcu = bs.add_parser(
        "cleanup-incomplete-uploads",
        help="abort multipart uploads older than --older-than",
    )
    bcu.add_argument("buckets", nargs="+")
    bcu.add_argument("--older-than", default="1d",
                     help="e.g. 30s, 15m, 2h, 1d, 1w (default 1d)")

    pk = sub.add_parser("key", help="API key operations")
    ks = pk.add_subparsers(dest="key_cmd", required=True)
    ks.add_parser("list")
    ki = ks.add_parser("info")
    ki.add_argument("key")
    ki.add_argument("--show-secret", action="store_true")
    kc = ks.add_parser("create")
    kc.add_argument("name", nargs="?", default="unnamed")
    kd = ks.add_parser("delete")
    kd.add_argument("key")
    km = ks.add_parser("import")
    km.add_argument("id")
    km.add_argument("secret")
    km.add_argument("--name", default="imported")
    kset = ks.add_parser("set")
    kset.add_argument("key")
    kset.add_argument("--allow-create-bucket", dest="acb", action="store_true")
    kset.add_argument("--deny-create-bucket", dest="dcb", action="store_true")
    kset.add_argument("--name", default=None)

    pr = sub.add_parser("repair", help="launch repair operations")
    pr.add_argument("what", choices=[
        "tables", "blocks", "versions", "block_refs", "mpu", "rebalance",
        "scrub",
    ])
    pr.add_argument("--cmd", default="start",
                    choices=["start", "pause", "resume", "cancel"])

    pw = sub.add_parser("worker", help="background worker operations")
    ws = pw.add_subparsers(dest="worker_cmd", required=True)
    ws.add_parser("list")
    wi = ws.add_parser("info", help="single-worker drill-down")
    wi.add_argument("id", type=int)
    wg = ws.add_parser("get")
    wg.add_argument("var", nargs="?", default=None)
    wst = ws.add_parser("set")
    wst.add_argument("var")
    wst.add_argument("value")

    pb = sub.add_parser(
        "block", help="block-level operations (ref garage/admin/block.rs)")
    bls = pb.add_subparsers(dest="block_cmd", required=True)
    bls.add_parser("list-errors", help="blocks in resync error backoff")
    bi = bls.add_parser("info", help="refcount + referencing versions")
    bi.add_argument("hash")
    brt = bls.add_parser("retry-now", help="clear backoff and requeue")
    brt.add_argument("hashes", nargs="*")
    brt.add_argument("--all", action="store_true",
                     help="retry every errored block")
    bp = bls.add_parser(
        "purge",
        help="DELETE every object/version referencing these blocks "
             "(unrecoverable-block last resort)")
    bp.add_argument("hashes", nargs="+")
    bp.add_argument("--yes", action="store_true")

    pcx = sub.add_parser(
        "codec",
        help="dataplane codec observability (gate decisions, stage "
             "attribution, heal sources)")
    cxs = pcx.add_subparsers(dest="codec_cmd", required=True)
    cxs.add_parser("info", help="backend, gate state, bytes-by-side, "
                                "per-stage attribution, heal counters")
    cev = cxs.add_parser(
        "events",
        help="the gate-decision event ring: why the device side did or "
             "did not take work (probe rates, gate holds, demotions)")
    cev.add_argument("-n", "--limit", type=int, default=50)
    cpr = cxs.add_parser(
        "profile",
        help="controlled link sweep on the LIVE transport: sizes x "
             "batch shapes x kinds, each cell decomposed into "
             "stage_copy/adopt/compile/dispatch/compute/collect "
             "(exact-sum attribution; ops/link_profiler.py)")
    cpr.add_argument("--sizes-mib", type=float, nargs="+",
                     default=[1.0, 4.0, 16.0],
                     help="payload sizes per cell (MiB)")
    cpr.add_argument("--shapes", type=int, nargs="+", default=[1, 16],
                     help="blocks per batch (the batch shapes axis)")
    cpr.add_argument("--kinds", nargs="+",
                     default=["hash", "encode", "decode"],
                     choices=["hash", "encode", "decode", "scrub"])
    cpr.add_argument("--rounds", type=int, default=1)
    cpr.add_argument("--json", action="store_true",
                     help="emit the machine-readable block instead of "
                          "the table")

    pcpu = sub.add_parser(
        "cpu",
        help="continuous CPU profiler (always-on thread-stack sampling "
             "joined to roles + waterfall segments; utils/cpuprof.py)")
    cus = pcpu.add_subparsers(dest="cpu_cmd", required=True)
    cup = cus.add_parser(
        "profile",
        help="folded stacks from roughly the last --seconds, hottest "
             "first, with per-role busy ratios and the sampler's "
             "measured self-cost (<2%% budget)")
    cup.add_argument("--seconds", type=float, default=10.0,
                     help="history window to fold (served instantly "
                          "from the always-on sampler)")
    cup.add_argument("--top", type=int, default=40,
                     help="top-K stacks to return")
    cup.add_argument("--fold", action="store_true",
                     help="emit raw collapsed-stack lines "
                          "(flamegraph.pl-compatible)")
    cup.add_argument("--json", action="store_true",
                     help="emit the machine-readable profile block")

    pso = sub.add_parser(
        "slow-ops",
        help="top-N slowest operations retained by the always-on "
             "slow-op log (no trace_sink needed)")
    pso.add_argument("-n", "--limit", type=int, default=20)

    prq = sub.add_parser(
        "request",
        help="per-request critical-path attribution (waterfalls)")
    rqs = prq.add_subparsers(dest="request_cmd", required=True)
    rw = rqs.add_parser(
        "waterfall",
        help="retained slowest request span trees per endpoint; with "
             "--trace/--endpoint, one request's cross-node waterfall "
             "with its critical-path segment breakdown")
    rw.add_argument("--trace", default=None,
                    help="an x-amz-request-id (== trace id)")
    rw.add_argument("--endpoint", default=None,
                    help="e.g. PutObject: show its slowest retained "
                         "request")
    rw.add_argument("--json", action="store_true")
    rqs.add_parser(
        "exemplars",
        help="current-window histogram exemplars: the trace id behind "
             "each family's max observation")

    psl = sub.add_parser(
        "slo",
        help="per-endpoint SLO budgets & burn rates (utils/slo.py)")
    sls = psl.add_subparsers(dest="slo_cmd", required=True)
    slst = sls.add_parser(
        "status",
        help="budget table: per-endpoint availability + latency "
             "objectives, fast/slow burn rates, budget remaining")
    slst.add_argument("--json", action="store_true")

    pin = sub.add_parser(
        "incident",
        help="incident flight recorder (one-call diagnostic bundles)")
    ins = pin.add_subparsers(dest="incident_cmd", required=True)
    icap = ins.add_parser(
        "capture",
        help="write a bundle NOW (metrics, waterfalls, timeline, "
             "breaker/disk/governor/peer state, event rings)")
    icap.add_argument("--reason", default="manual")
    ins.add_parser("list", help="retained bundles on the node")

    ptl = sub.add_parser(
        "timeline",
        help="device/transport pipeline timeline as Chrome-trace JSON "
             "(load into chrome://tracing or Perfetto)")
    ptl.add_argument("-o", "--out", default=None,
                     help="write the catapult JSON here (default: "
                          "stdout)")
    ptl.add_argument("-n", "--limit", type=int, default=None,
                     help="most recent N events only")
    return p


class AdminClient:
    """CLI-side RPC client: temp keypair + rpc secret (ref main.rs:194-263)."""

    def __init__(self, config_path: str, rpc_host: Optional[str]):
        from .utils.config import read_config

        self.config = read_config(config_path)
        addr = rpc_host or self.config.rpc_bind_addr
        host, port = addr.rsplit(":", 1)
        if host in ("0.0.0.0", "::"):
            host = "127.0.0.1"
        self.addr = f"{host}:{port}"

    async def call(self, msg: Dict[str, Any]) -> Any:
        from .net import NetApp
        from .net.netapp import gen_node_key

        netapp = NetApp(gen_node_key(), self.config.rpc_secret)
        endpoint = netapp.endpoint("garage/admin")
        try:
            conn = await netapp.connect(self.addr)
            resp = await endpoint.call(conn.remote_id, msg, timeout=60.0)
            if resp.get("err"):
                print(f"error: {resp['err']}", file=sys.stderr)
                sys.exit(1)
            return resp.get("ok")
        finally:
            await netapp.shutdown()


def _perm_str(p) -> str:
    return "".join(c if f else "-" for c, f in zip("RWO", p))


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}TiB"


async def _amain(args) -> None:
    if args.command == "server":
        from .server import run_server

        await run_server(args.config)
        return

    if args.command == "convert-db":
        from .db import open_db

        src = open_db(args.input_engine, args.input_path)
        dst = open_db(args.output_engine, args.output_path)
        n_trees = n_rows = 0
        for name in src.list_trees():
            st = src.open_tree(name)
            dt = dst.open_tree(name)
            if not dt.is_empty():
                print(f"error: output tree {name!r} is not empty", file=sys.stderr)
                sys.exit(1)
            # batch rows per commit: one insert per row would pay a full
            # commit (and read-old-value) each (ref cli/convert_db.rs uses
            # the engines' bulk import)
            batch = []
            for kv in st.items():
                batch.append(kv)
                if len(batch) >= 2000:
                    rows = batch
                    dst.transaction(lambda tx, rows=rows: [
                        tx.insert(dt, k, v) for k, v in rows
                    ])
                    n_rows += len(batch)
                    batch = []
            if batch:
                rows = batch
                dst.transaction(lambda tx, rows=rows: [
                    tx.insert(dt, k, v) for k, v in rows
                ])
                n_rows += len(batch)
            n_trees += 1
        src.close()
        dst.close()
        print(f"converted {n_trees} trees / {n_rows} rows "
              f"({args.input_engine} -> {args.output_engine})")
        return

    if args.command == "offline-repair-counters":
        from .model import Garage
        from .utils.config import read_config

        g = Garage(read_config(args.config))  # no listen: offline
        jobs = [
            (g.object_counter, g.object_table,
             lambda e: (bytes(e.bucket_id), "")),
            (g.mpu_counter, g.mpu_table,
             lambda e: (bytes(e.bucket_id), "")),
            (g.k2v_counter, g.k2v_item_table,
             lambda e: (bytes(e.bucket_id), e.partition_key_str)),
        ]
        for counter, table, key_fn in jobs:
            z, n = counter.offline_recount_all(table, key_fn)
            print(f"{counter.table.schema.TABLE_NAME}: zeroed {z}, "
                  f"recounted {n} entries")
        await g.shutdown()
        return

    if args.command == "node-id":
        from .utils.config import read_config
        from .net.netapp import load_or_gen_node_key, node_id_of

        cfg = read_config(args.config)
        key = load_or_gen_node_key(os.path.join(cfg.metadata_dir, "node_key"))
        nid = node_id_of(key).hex()
        addr = cfg.rpc_public_addr or cfg.rpc_bind_addr
        print(f"{nid}@{addr}")
        return

    client = AdminClient(args.config, args.rpc_host)

    if args.command == "status":
        st = await client.call({"cmd": "status"})
        h = st["health"]
        print(f"==== Node: {st['node_id'][:16]}… ({st['hostname']}) ====")
        print(f"Cluster health: {h['status']}  "
              f"(nodes {h['connected_nodes']}/{h['known_nodes']} connected, "
              f"partitions {h['partitions_all_ok']}/{h['partitions']} all-ok, "
              f"{h['partitions_quorum']}/{h['partitions']} quorum)")
        print(f"Layout version: {st['layout_version']}")
        rows = ["ID\tZONE\tCAPACITY\tTAGS\tSTATUS"]
        known = {n["id"]: n for n in st["known_nodes"]}
        for nid, (zone, cap, tags) in sorted(st["roles"].items()):
            k = known.get(nid, {})
            up = "up" if k.get("is_up") else "down"
            cap_s = str(cap) if cap is not None else "gateway"
            rows.append(f"{nid[:16]}…\t{zone}\t{cap_s}\t{','.join(tags)}\t{up}")
        print(format_table(rows))
        if any(v is not None for v in st["staged"].values()) or st["staged"]:
            staged = {k: v for k, v in st["staged"].items()}
            if staged:
                print("\n==== Staged changes ====")
                for nid, r in staged.items():
                    print(f"  {nid[:16]}… → {r}")
                print("Use `layout apply` to activate.")
        return

    if args.command == "stats":
        msg = {"cmd": "stats"}
        if getattr(args, "all_nodes", False):
            msg["all"] = True
        print(json.dumps(await client.call(msg), indent=2))
        return

    if args.command == "connect":
        if "@" in args.peer:
            nid, addr = args.peer.split("@", 1)
        else:
            nid, addr = None, args.peer
        print(await client.call({"cmd": "connect", "addr": addr, "node_id": nid}))
        return

    if args.command == "cluster":
        if args.cluster_cmd == "stats":
            st = await client.call({"cmd": "cluster_stats"})
            if args.json:
                print(json.dumps(st, indent=2))
                return
            me = (f" zone={st['zone']}" if st.get("zone") else "") + (
                f" v{st['version']}" if st.get("version") else "")
            print(f"==== Node: {st['node_id'][:16]}…{me} — peer health "
                  f"(grouped by zone) ====")
            rows = ["ZONE\tPEER\tADDR\tUP\tBRK\tHEALTH\tDISK\tVER\tRTT"
                    "\tFAILS\tRECONN\tTX\tRX\tBG TX%"]
            for p in st["peers"]:
                tr = p.get("traffic") or {}
                tx = sum(v["tx_bytes"] for v in tr.values())
                rx = sum(v["rx_bytes"] for v in tr.values())
                bg = tr.get("background", {}).get("tx_bytes", 0)
                rtt = p["rtt_ewma_ms"]
                brk = p.get("breaker")
                hs = p.get("health_score")
                # the fail-slow column: a peer can be up with its
                # breaker closed and still be SLOW! — the gray-failure
                # case the comparative scorer exists for
                health = ("SLOW!" if p.get("fail_slow")
                          else f"{hs:.1f}x" if hs is not None else "-")
                rows.append("\t".join([
                    p.get("zone") or "-",
                    f"{p['id'][:16]}…",
                    p["addr"] or "-",
                    "up" if p["up"] else "DOWN",
                    {"closed": "-", "half_open": "half",
                     "open": "OPEN"}.get(brk, brk or "-"),
                    health,
                    p.get("disk_state") or "-",
                    p.get("version") or "-",
                    f"{rtt}ms" if rtt is not None else "-",
                    str(p["consecutive_failures"]),
                    str(p["reconnects"]),
                    _fmt_bytes(tx) if tr else "-",
                    _fmt_bytes(rx) if tr else "-",
                    f"{100.0 * bg / tx:.0f}%" if tx else "-",
                ]))
            print(format_table(rows))
            zones = st.get("zones") or {}
            if zones:
                # one line per failure domain: a zone outage is legible
                # at a glance (nodes down + breakers open + sick disks
                # all concentrate on one row)
                print("\n==== Zones ====")
                for zname in sorted(zones):
                    z = zones[zname]
                    print(f"  {zname}: {z['up']}/{z['nodes']} up, "
                          f"worst disk {z['worst_disk']}, "
                          f"{z['breaker_open']} breaker(s) open")
            disk = st.get("disk")
            if disk:
                print(f"\n==== Local disk health: {disk['state']} "
                      f"(quarantined {disk['quarantined']}, "
                      f"quarantine errors {disk['quarantine_errors']}) ====")
                drows = ["ROOT\tSTATE\tFREE"]
                for r in disk["roots"]:
                    free = r["free_bytes"]
                    drows.append("\t".join([
                        r["path"], r["state"],
                        _fmt_bytes(free) if free is not None else "?",
                    ]))
                print(format_table(drows))
                if disk["error_counts"]:
                    print("disk errors: " + ", ".join(
                        f"{k}={v}" for k, v in
                        sorted(disk["error_counts"].items())))
        return

    if args.command == "layout":
        lc = args.layout_cmd
        if lc == "assign":
            from .utils.config import parse_capacity

            cap = parse_capacity(args.capacity) if args.capacity else None
            tags = [t for t in args.tags.split(",") if t]
            print(await client.call({
                "cmd": "layout_assign", "node": args.node,
                "zone": args.zone, "capacity": cap, "tags": tags,
            }))
        elif lc == "remove":
            print(await client.call({
                "cmd": "layout_assign", "node": args.node, "remove": True,
            }))
        elif lc == "config":
            print(await client.call({
                "cmd": "layout_config",
                "zone_redundancy": args.zone_redundancy,
            }))
        elif lc == "show":
            st = await client.call({"cmd": "status"})
            print(json.dumps({
                "roles": st["roles"], "staged": st["staged"],
                "version": st["layout_version"],
                "parameters": st.get("parameters"),
                "staged_parameters": st.get("staged_parameters"),
            }, indent=2))
        elif lc == "apply":
            for m in await client.call({"cmd": "layout_apply", "version": args.version}):
                print(m)
        elif lc == "revert":
            print(await client.call({"cmd": "layout_revert", "version": args.version}))
        return

    if args.command == "bucket":
        bc = args.bucket_cmd
        if bc == "list":
            rows = ["ID\tALIASES\tKEYS"]
            for b in await client.call({"cmd": "bucket_list"}):
                rows.append(f"{b['id'][:16]}…\t{','.join(b['aliases'])}\t{b['keys']}")
            print(format_table(rows))
        elif bc == "info":
            print(json.dumps(await client.call(
                {"cmd": "bucket_info", "bucket": args.bucket}), indent=2))
        elif bc == "create":
            print(await client.call({"cmd": "bucket_create", "name": args.bucket}))
        elif bc == "delete":
            print(await client.call({"cmd": "bucket_delete", "bucket": args.bucket}))
        elif bc == "alias":
            print(await client.call({
                "cmd": "bucket_alias", "bucket": args.bucket, "alias": args.alias,
            }))
        elif bc == "unalias":
            print(await client.call({"cmd": "bucket_unalias", "alias": args.alias}))
        elif bc in ("allow", "deny"):
            print(await client.call({
                "cmd": f"bucket_{bc}", "bucket": args.bucket, "key": args.key,
                "read": args.read, "write": args.write, "owner": args.owner,
            }))
        elif bc == "website":
            print(await client.call({
                "cmd": "bucket_website", "bucket": args.bucket,
                "allow": args.allow and not args.deny,
                "index_document": args.index_document,
                "error_document": args.error_document,
            }))
        elif bc == "set-quotas":
            from .utils.config import parse_capacity

            print(await client.call({
                "cmd": "bucket_set_quotas", "bucket": args.bucket,
                "max_size": parse_capacity(args.max_size) if args.max_size else None,
                "max_objects": args.max_objects,
            }))
        elif bc == "cleanup-incomplete-uploads":
            print(await client.call({
                "cmd": "bucket_cleanup_uploads", "buckets": args.buckets,
                "older_than": args.older_than,
            }))
        return

    if args.command == "key":
        kc = args.key_cmd
        if kc == "list":
            rows = ["ID\tNAME"]
            for k in await client.call({"cmd": "key_list"}):
                rows.append(f"{k['id']}\t{k['name']}")
            print(format_table(rows))
        elif kc == "info":
            print(json.dumps(await client.call({
                "cmd": "key_info", "key": args.key,
                "show_secret": args.show_secret,
            }), indent=2))
        elif kc == "create":
            k = await client.call({"cmd": "key_create", "name": args.name})
            print(f"Key ID:     {k['id']}\nSecret key: {k['secret']}")
        elif kc == "delete":
            print(await client.call({"cmd": "key_delete", "key": args.key}))
        elif kc == "import":
            print(await client.call({
                "cmd": "key_import", "id": args.id, "secret": args.secret,
                "name": args.name,
            }))
        elif kc == "set":
            msg = {"cmd": "key_set", "key": args.key}
            if args.acb:
                msg["allow_create_bucket"] = True
            if args.dcb:
                msg["allow_create_bucket"] = False
            if args.name:
                msg["name"] = args.name
            print(await client.call(msg))
        return

    if args.command == "repair":
        print(await client.call({
            "cmd": "launch_repair", "what": args.what, "scrub_cmd": args.cmd,
        }))
        return

    if args.command == "worker":
        wc = args.worker_cmd
        if wc == "list":
            rows = ["ID\tNAME\tSTATE\tERRORS\tQUEUE\tPROGRESS"]
            for w in await client.call({"cmd": "worker_list"}):
                rows.append(
                    f"{w['id']}\t{w['name']}\t{w['state']}\t{w['errors']}"
                    f"\t{w['queue_length'] if w['queue_length'] is not None else '-'}"
                    f"\t{w['progress'] or '-'}"
                )
            print(format_table(rows))
        elif wc == "info":
            w = await client.call({"cmd": "worker_info", "id": args.id})
            rows = ["FIELD\tVALUE"]
            order = ["id", "name", "alive", "state", "errors",
                     "consecutive_errors", "last_error",
                     "last_error_ago_s", "tranquility", "progress",
                     "queue_length", "persistent_errors"]
            for k in order:
                v = w.get(k)
                rows.append(f"{k}\t{v if v is not None else '-'}")
            for line in w.get("freeform") or []:
                rows.append(f"note\t{line}")
            for k, v in (w.get("tunables") or {}).items():
                rows.append(f"tunable:{k}\t{v}")
            print(format_table(rows))
        elif wc == "get":
            print(json.dumps(await client.call(
                {"cmd": "worker_get_var", "var": args.var}), indent=2))
        elif wc == "set":
            v: Any = args.value
            try:
                v = int(args.value)
            except ValueError:
                pass
            print(await client.call({
                "cmd": "worker_set_var", "var": args.var, "value": v,
            }))
        return

    if args.command == "block":
        bc = args.block_cmd
        if bc == "list-errors":
            rows = ["HASH\tERRORS\tLAST TRY\tNEXT TRY"]
            for e in await client.call({"cmd": "block_list_errors"}):
                # full hash: this listing feeds retry-now/purge arguments
                rows.append(
                    f"{e['hash']}\t{e['errors']}"
                    f"\t{e['last_try_secs_ago']}s ago"
                    f"\tin {e['next_try_in_secs']}s"
                )
            print(format_table(rows))
        elif bc == "info":
            print(json.dumps(await client.call(
                {"cmd": "block_info", "hash": args.hash}), indent=2))
        elif bc == "retry-now":
            print(await client.call({
                "cmd": "block_retry_now", "all": args.all,
                "blocks": args.hashes,
            }))
        elif bc == "purge":
            print(await client.call({
                "cmd": "block_purge", "yes": args.yes,
                "blocks": args.hashes,
            }))
        return

    if args.command == "codec":
        if args.codec_cmd == "info":
            print(json.dumps(await client.call({"cmd": "codec_info"}),
                             indent=2))
        elif args.codec_cmd == "events":
            rows = ["SEQ\tKIND\tREASON\tDETAIL"]
            for e in await client.call(
                {"cmd": "codec_events", "limit": args.limit}
            ):
                detail = ", ".join(
                    f"{k}={v}" for k, v in e.items()
                    if k not in ("seq", "ts", "kind", "reason")
                )
                rows.append(f"{e['seq']}\t{e['kind']}\t"
                            f"{e.get('reason') or '-'}\t{detail or '-'}")
            print(format_table(rows))
        elif args.codec_cmd == "profile":
            block = await client.call({
                "cmd": "codec_profile",
                "sizes_mib": args.sizes_mib,
                "shapes": args.shapes,
                "kinds": args.kinds,
                "rounds": args.rounds,
            })
            if args.json:
                print(json.dumps(block, indent=2))
            else:
                from .ops.link_profiler import format_sweep
                print(format_sweep(block))
        return

    if args.command == "cpu":
        prof = await client.call({
            "cmd": "cpu_profile",
            "seconds": args.seconds,
            "top": args.top,
        })
        if args.json:
            print(json.dumps(prof, indent=2))
        elif args.fold:
            # raw collapsed-stack lines — pipe straight into
            # flamegraph.pl / speedscope
            for rec in prof["top"]:
                print(f"{rec['stack']} {rec['count']}")
        else:
            busy = " ".join(f"{r}={v:.0%}" for r, v in
                            prof.get("busy_ratio", {}).items())
            print(f"==== CPU profile (last ~{prof['seconds']}s, "
                  f"{prof['samples']} samples @ {prof['hz']}Hz, "
                  f"sampler overhead "
                  f"{prof['overhead_ratio'] * 100:.2f}%) ====")
            if busy:
                print(f"busy: {busy}")
            rows = ["SHARE\tROLE\tSEGMENT\tHOTTEST FRAME\tSTACK"]
            for rec in prof["top"]:
                stack = rec["stack"].split(";", 2)[-1]
                if len(stack) > 72:
                    stack = "…" + stack[-71:]
                rows.append(f"{rec['share'] * 100:5.1f}%\t{rec['role']}"
                            f"\t{rec['segment']}\t{rec['leaf']}\t{stack}")
            print(format_table(rows))
        return

    if args.command == "slow-ops":
        rows = ["SECONDS\tOP\tTRACE\tATTRS"]
        for o in await client.call({"cmd": "slow_ops",
                                    "limit": args.limit}):
            attrs = ", ".join(f"{k}={v}" for k, v in
                              (o.get("attrs") or {}).items())
            # the trace id keys straight into `request waterfall --trace`
            trace = o.get("trace")
            rows.append(f"{o['seconds']:.3f}\t{o['name']}"
                        f"\t{trace[:16] + '…' if trace else '-'}"
                        f"\t{attrs or '-'}")
        print(format_table(rows))
        return

    if args.command == "request":
        if args.request_cmd == "exemplars":
            rows = ["FAMILY\tLABELS\tSECONDS\tTRACE"]
            for e in await client.call({"cmd": "exemplars"}):
                labels = ",".join(f"{k}={v}" for k, v in
                                  (e.get("labels") or {}).items())
                rows.append(f"{e['family']}\t{labels or '-'}"
                            f"\t{e['value']:.4f}\t{e['trace_id']}")
            print(format_table(rows))
            return
        msg = {"cmd": "request_waterfall"}
        if args.trace:
            msg["trace"] = args.trace
        if args.endpoint:
            msg["endpoint"] = args.endpoint
        wf = await client.call(msg)
        if args.json:
            print(json.dumps(wf, indent=2))
            return
        if "tree" not in wf:
            print("==== Sampled endpoints ====")
            rows = ["ENDPOINT\tSAMPLED\tMEAN\tDOMINANT\tRETAINED"]
            for e in wf["endpoints"]:
                rows.append(f"{e['endpoint']}\t{e['sampled']}"
                            f"\t{e['mean_ms']:.1f}ms\t{e['dominant']}"
                            f"\t{e['retained']}")
            print(format_table(rows))
            print("\n==== Retained waterfalls (slowest first; "
                  "`request waterfall --trace <id>` for the tree) ====")
            rows = ["ENDPOINT\tSECONDS\tDOMINANT\tTRACE\tSEGMENTS"]
            for e in wf["retained"]:
                segs = " ".join(
                    f"{k}={v * 1000:.1f}ms"
                    for k, v in list(e["segments"].items())[:4])
                rows.append(f"{e['endpoint']}\t{e['seconds']:.4f}"
                            f"\t{e['dominant']}\t{e['trace_id']}\t{segs}")
            print(format_table(rows))
            return
        total_ms = wf["seconds"] * 1000.0
        print(f"==== {wf['endpoint']} — trace {wf['trace_id']} — "
              f"{total_ms:.1f} ms across {wf['nodes_contributing']} "
              f"node(s), {wf['span_count']} spans ====")
        print("critical path: " + ", ".join(
            f"{k} {v * 1000:.1f}ms ({v / wf['seconds'] * 100:.0f}%)"
            for k, v in wf["segments"].items())
            + f"  → dominant: {wf['dominant']}")
        t0 = wf["tree"]["start_ns"]

        def render(node, depth):
            off = (node["start_ns"] - t0) / 1e6
            dur = node["seconds"] * 1000.0
            bar_w = 32
            lo = (0 if total_ms <= 0
                  else int(bar_w * off / total_ms))
            hi = (bar_w if total_ms <= 0 else
                  max(lo + 1, int(bar_w * (off + dur) / total_ms)))
            bar = " " * lo + "█" * min(bar_w - lo, hi - lo)
            print(f"  {off:8.1f}ms {dur:8.1f}ms |{bar:<{bar_w}}| "
                  f"{'  ' * depth}{node['name']} [{node['segment']}]")
            for c in node["children"]:
                render(c, depth + 1)

        render(wf["tree"], 0)
        return

    if args.command == "slo":
        st = await client.call({"cmd": "slo_status"})
        if args.json:
            print(json.dumps(st, indent=2))
            return
        w = st["windows"]
        print(f"==== SLO budgets — node {st['node_id'][:16]}… "
              f"(fast {w['fast_s']:.0f}s / slow {w['slow_s']:.0f}s; "
              f"fast-burn threshold {st['fast_burn_threshold']}x, "
              f"{st['fast_burn_breaches']} breach(es)) ====")
        rows = ["ENDPOINT\tSLO\tTARGET\tEVENTS\tBAD\tBURN fast\t"
                "BURN slow\tBUDGET LEFT"]
        for r in st["rows"]:
            rows.append("\t".join([
                r["endpoint"], r["slo"], r["target"],
                str(r["events"]), str(r["bad"]),
                f"{r['burn_fast']:.2f}x", f"{r['burn_slow']:.2f}x",
                f"{r['budget_remaining'] * 100:.1f}%",
            ]))
        print(format_table(rows))
        return

    if args.command == "incident":
        if args.incident_cmd == "capture":
            out = await client.call({"cmd": "incident_capture",
                                     "reason": args.reason})
            print(f"bundle written: {out['path']}")
        else:
            rows = ["CAPTURED\tTRIGGER\tREASON\tSECTIONS\tPATH"]
            for b in await client.call({"cmd": "incident_list"}):
                ts = b.get("captured_at")
                rows.append("\t".join([
                    f"{ts:.0f}" if ts else "-",
                    b.get("trigger") or "-",
                    b.get("reason") or "-",
                    str(len(b.get("sections") or [])),
                    b["path"],
                ]))
            print(format_table(rows))
        return

    if args.command == "timeline":
        msg = {"cmd": "device_timeline"}
        if args.limit:
            msg["limit"] = args.limit
        chrome = await client.call(msg)
        body = json.dumps(chrome)
        if args.out:
            with open(args.out, "w") as f:
                f.write(body)
            n = sum(1 for e in chrome["traceEvents"]
                    if e.get("ph") != "M")
            print(f"wrote {n} events to {args.out} "
                  f"(open in chrome://tracing or https://ui.perfetto.dev)")
        else:
            print(body)
        return


def main() -> None:
    # log↔trace correlation: every record emitted inside a request
    # scope carries the request's trace id (== x-amz-request-id), so
    # flight-recorder bundles and `request waterfall --trace` key
    # straight into the log stream; "-" outside any request
    from .utils.tracing import install_log_trace_ids

    install_log_trace_ids()
    logging.basicConfig(
        level=os.environ.get("GARAGE_TPU_LOG", "INFO"),
        format="%(asctime)s %(levelname).1s %(name)s [%(trace_id)s]: "
               "%(message)s",
    )
    args = _build_parser().parse_args()
    try:
        asyncio.run(_amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
