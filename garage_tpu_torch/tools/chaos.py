"""Reproducible degraded-mode chaos drive.

    python -m garage_tpu_torch.tools.chaos [--quick] [--device cuda|cpu]
        [--phases latency,partition,disk] [--secs 8] [--nodes N --zones Z]

The port's ``scripts/chaos.py``, on the port's ``testing/`` rig and its
cluster builder (``testing/cluster.mk_cluster``).  Every node's codec runs
on ``--device``: ``cuda`` (the default) builds each node's codec on the
card (``backend = "cuda"``, ``Garage(config, device="cuda")``; without a
GPU the tool exits non-zero and prints no result); ``cpu`` keeps the
reference's CPU codec (``backend = "cpu"``), as the tests run it.

Builds a 3-node in-process cluster in a temp dir, interposes the
FaultInjector's network FaultyLinks on every RPC path, then runs S3
PUT/GET traffic through a sequence of network-fault phases:

  baseline    clean links (sanity + latency floor)
  latency     one peer at ~10× RTT with jitter (tail-latency regime)
  fail_slow   one node slow-but-UP (latency only: no resets, pings
              succeed, breaker stays closed) — the comparative scorer
              must flag it (`peer_fail_slow`) within a bounded number
              of status exchanges, reads keep flowing with zero client
              errors while ranking demotes it, and the flag clears
              after heal (the fleet-health acceptance)
  flaky       10% connection resets on one link
  oneway      one-way partition gateway→replica (requests vanish,
              replies flow)
  partition   hard two-way partition between the two replicas
  blackhole   one replica accepts and never responds (the case only
              adaptive timeouts catch) — breaker open/recover asserted
  disk        one replica with a flaky disk (30% EIO reads) AND a full
              filesystem (ENOSPC watermark): writes route around the
              typed StorageFull rejections, reads fail over — the
              degraded root is asserted visible (disk_root_state ≥ 1)
              during the fault and back to ok after the heal

Zone-scale phases run on a SEPARATE SimCluster —
``--nodes N --zones Z`` in-process nodes plus a gateway (default 24/4,
the acceptance shape; use --nodes 6 --zones 3 for a quick drive) — via
the shared drill drivers in testing/sim_cluster.py (the same code
tests/test_torch_sim.py and chip_smoke.py's chaos phase drive):

  zone_blackhole  one full zone dark: reads served local-zone-first
                  from survivors, boundary breakers open then recover,
                  zero client errors
  zone_drain      layout change drains a zone under live PUT/GET load:
                  rebalance mover finishes (partitions done == total),
                  every acked object bit-identical EVEN with the
                  drained zone subsequently partitioned away
  rolling         rolling upgrade: restart nodes one zone at a time
                  with a bumped version tag under live traffic; mixed
                  versions visible in the handshake-learned peer map
  compound        zone blackhole + flaky disk (read EIO) at ONCE —
                  zero client errors through the compound fault, full
                  recovery (breakers closed, disk ok, bit-identical)

Overload phase runs on its own small SimCluster with a tiny
admission watermark:

  overload        offered load at 1× then 4× the gateway's admission
                  capacity: rejects all typed SlowDown/DeadlineExceeded
                  (no hangs, no untyped 500s), admitted p99 within 3×
                  the at-capacity baseline, background_throttle_ratio
                  drops then recovers, zero acked-data loss

Production-shaped survival phases, each on its own cluster:

  wan             the 3-zone geo-WAN RTT matrix (20/80/150 ms boundary
                  links): local-zone GETs hold p50 near the local RTT,
                  cross-zone reads and write re-quorums pay exactly the
                  matrix, and the zone-aware fail-slow baseline never
                  flags a healthy-but-distant zone
  gateway_failover  2 gateways behind the health-checked GatewayPool:
                  one killed mid-PUT-body and mid-streaming-GET (zero
                  acked loss, Range resume), then gracefully drained —
                  typed sheds, gossiped drain state, bounded window

Every phase must complete with ZERO client-visible errors; the exit
code says so, and a JSON summary (per-phase op counts + p50/p99/max
latency + breaker/disk/rebalance states) goes to stdout for bench
comparisons; on the card it also carries the process's kernel launches
(``launches``).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import sys
import tempfile
import time

PHASES = ("baseline", "latency", "fail_slow", "flaky", "oneway",
          "partition", "blackhole", "disk")
# canonical run order: the drain REMOVES a zone from the layout, so it
# must come last — a rolling zone restart after a drain would take out
# 2 of 3 replicas on layouts that can no longer spread wider.  compound
# (zone blackhole + flaky disk at once) runs after the plain blackhole
# and heals everything it injects before the rolling restart.
ZONE_PHASES = ("zone_blackhole", "compound", "rolling", "zone_drain")
# node-kill repair storm on its own EC cluster: heal must
# complete with zero client errors AND the planned repair path must move
# no more bytes per repaired byte than the whole-shard exact-k baseline
STORM_PHASES = ("repair_storm",)
# the overload drill: its own SimCluster with a tiny admission
# watermark so "4× past capacity" is reachable from one client process —
# every reject typed SlowDown/DeadlineExceeded, admitted p99 within 3×
# the at-capacity baseline, background_throttle_ratio cedes + recovers,
# zero acked-data loss
OVERLOAD_PHASES = ("overload",)
# the multi-tenant QoS drill: one abusive tenant saturates the
# gateway — well-behaved tenants see ZERO errors and their p99 holds,
# the abuser's excess sheds typed per-tenant, and a gossiped-hot storage
# node triggers a remote_pressure shed at a locally-idle gateway
QOS_PHASES = ("noisy_neighbor",)
# the geo-WAN drill: the 3-zone RTT matrix (20/80/150 ms) on its
# own 6-node/3-zone SimCluster — local-zone GET p50 holds near the
# local RTT, cross-zone reads/write-re-quorums pay exactly the matrix,
# and the zone-aware fail-slow baseline never flags a healthy-but-
# distant zone (while a genuinely slow far peer still flags)
WAN_PHASES = ("wan",)
# the gateway-pool drill: 2 gateways behind the health-checked
# GatewayPool client; one is killed mid-PUT-body and mid-streaming-GET
# (zero acked loss, Range resume) and then gracefully drained under an
# in-flight slow GET (typed sheds, gossiped drain state, bounded window)
GATEWAY_PHASES = ("gateway_failover",)
# the full-node-loss drill: a storage node of an EC SimCluster is
# crashed AND dropped from the layout under live PUT/GET traffic — zero
# client errors, zero acked-data loss, every survivor's fleet rebuild
# scheduler walks its lost partitions to done == total paced under the
# governor, and repair ingress stays partial-product attributed
# (tree/ppr modes — never whole-block over-fetch)
REBUILD_PHASES = ("node_rebuild",)


def codec_backend(device: str) -> str:
    """The nodes' codec backend: the card's kernels on "cuda", the
    reference's CPU codec on "cpu"."""
    return "cuda" if device == "cuda" else "cpu"


def sim_codec(device: str) -> dict:
    """SimCluster's extra_cfg for its nodes' codec: its own default
    (replication only, no RS) on `device`'s backend."""
    return {"codec": {"rs_data": 0, "rs_parity": 0,
                      "backend": codec_backend(device)}}


def _apply(inj, phase):
    if phase == "latency":
        inj.slow_peer(2, 0.02, jitter=0.005)
    elif phase == "fail_slow":
        # slow-but-up: latency well above the siblings' (the scorer's
        # factor is 3x the cluster median) but no resets and far below
        # the breaker's absolute RTT floor (breaker_rtt_min 1 s), so
        # pings succeed and the breaker STAYS CLOSED — the gray-failure
        # regime only comparative scoring catches
        inj.slow_peer(2, 0.03, jitter=0.005)
    elif phase == "flaky":
        inj.flaky_link(0, 1, 0.10)
    elif phase == "oneway":
        inj.partition_one_way(0, 1)
    elif phase == "partition":
        inj.partition(1, 2)
    elif phase == "blackhole":
        inj.blackhole_node(2)
    elif phase == "disk":
        # the disk acceptance fault: one node's disk both dying
        # (probabilistic EIO) and full (statvfs under the watermark)
        inj.flaky_disk(2, prob=0.3)
        inj.fill_disk(2)


async def run(phases, secs, device):
    import aiohttp
    import numpy as np

    from ..block.health import DISK_STATE_VALUES
    from ..testing.cluster import mk_cluster
    from ..testing.faults import (
        FAST_CHAOS_HEALTH,
        FAST_CHAOS_RPC,
        FaultInjector,
    )
    from ..testing.s3_client import S3Client

    rng = random.Random(1031)
    nprng = np.random.default_rng(57)
    summary = {"phases": {}, "ok": True}
    with tempfile.TemporaryDirectory(prefix="garage_chaos_") as tmp:
        from pathlib import Path

        garages, server, port, kid, secret = await mk_cluster(
            Path(tmp), n=3, repl="3", db="memory",
            codec_cfg={"rs_data": 0, "rs_parity": 0,
                       "backend": codec_backend(device)},
            rpc_cfg=FAST_CHAOS_RPC, health_cfg=FAST_CHAOS_HEALTH,
            device=device)
        inj = FaultInjector(garages, device=device)
        await inj.add_network_faults(rng=random.Random(7))
        try:
            async with aiohttp.ClientSession() as session:
                s3 = S3Client(session, port, kid, secret)
                st, _b, _h = await s3.req("PUT", "/chaos")
                assert st == 200, f"bucket create: {st}"
                for phase in phases:
                    _apply(inj, phase)
                    disk_worst = 0.0
                    victim_health = garages[2].block_manager.health
                    if phase == "disk":
                        # fast-twitch disk breaker so one phase observes
                        # degrade AND recover (default cooldown is 30 s)
                        victim_health._tun.breaker_open_secs = 1.0
                    stats = {"puts": 0, "gets": 0, "errors": 0}
                    lats = []
                    acked = {}
                    deadline = time.monotonic() + secs
                    i = 0
                    while time.monotonic() < deadline:
                        i += 1
                        name = f"{phase}-{i:04d}"
                        body = nprng.integers(
                            0, 256, rng.randrange(4 << 10, 256 << 10),
                            dtype=np.uint8).tobytes()
                        t0 = time.perf_counter()
                        st, _b, _h = await s3.req(
                            "PUT", f"/chaos/{name}", body)
                        lats.append(time.perf_counter() - t0)
                        if st == 200:
                            acked[name] = body
                            stats["puts"] += 1
                        else:
                            stats["errors"] += 1
                        if acked:
                            probe = rng.choice(sorted(acked))
                            t0 = time.perf_counter()
                            st, got, _h = await s3.req(
                                "GET", f"/chaos/{probe}")
                            lats.append(time.perf_counter() - t0)
                            if st == 200 and got == acked[probe]:
                                stats["gets"] += 1
                            else:
                                stats["errors"] += 1
                        if i % 5 == 0:
                            for g in garages:
                                await g.system.peering._tick()
                            if phase == "fail_slow":
                                # status-gossip rounds on the drill's
                                # clock, not the 10 s daemon interval:
                                # the flag bound below counts EXCHANGES
                                for g in garages:
                                    await g.system.advertise_status()
                        if phase == "disk":
                            disk_worst = max(disk_worst, max(
                                DISK_STATE_VALUES[s]
                                for s in victim_health.states().values()))
                    if phase == "fail_slow":
                        # the fail-slow acceptance: the slow-but-up node is
                        # flagged by the COMPARATIVE scorer within a
                        # bounded number of status exchanges, while its
                        # breaker stays closed (pings succeed — nothing
                        # absolute is wrong with it)
                        g0 = garages[0]
                        n2 = garages[2].system.id
                        exchanges = 0
                        for _ in range(12):
                            if g0.system.peer_fail_slow(n2):
                                break
                            exchanges += 1
                            st, _b, _h = await s3.req(
                                "GET", f"/chaos/{rng.choice(sorted(acked))}")
                            if st != 200:
                                stats["errors"] += 1
                            for g in garages:
                                await g.system.peering._tick()
                                await g.system.advertise_status()
                            await asyncio.sleep(0.15)
                        stats["fail_slow_flagged"] = (
                            g0.system.peer_fail_slow(n2))
                        stats["flag_extra_exchanges"] = exchanges
                        stats["health_score"] = (
                            g0.system.peer_health_score(n2))
                        stats["breaker_during"] = (
                            g0.system.peering.breaker_state(n2))
                        summary["ok"] &= stats["fail_slow_flagged"]
                        summary["ok"] &= stats["breaker_during"] == "closed"
                        # demoted in read/repair ranking: band 3 — after
                        # breaker-open (4), before RTT within the band
                        rank = g0.system.rpc.peer_rank(n2)
                        stats["rank_band"] = rank[0]
                        summary["ok"] &= rank[0] == 3
                        # the metric families the dashboard map reads
                        body = g0.system.metrics.render()
                        summary["ok"] &= "peer_fail_slow" in body
                        summary["ok"] &= "peer_health_score" in body
                    if phase == "blackhole":
                        # the breaker must have opened on the blackholed
                        # peer (fast-fail) — observable, not inferred
                        g0 = garages[0]
                        n2 = garages[2].system.id
                        stats["breaker"] = g0.system.peering.breaker_state(n2)
                        summary["ok"] &= stats["breaker"] in (
                            "open", "half_open")
                    if phase == "disk":
                        # the degraded (read-only) root was OBSERVED —
                        # same truth /metrics disk_root_state renders
                        stats["disk_state_worst"] = disk_worst
                        summary["ok"] &= disk_worst >= 1.0
                        body = garages[2].system.metrics.render()
                        summary["ok"] &= "disk_root_state" in body
                        inj.heal_disk(2)
                        await asyncio.sleep(1.2)  # disk breaker cooldown
                        state = None
                        recover = time.monotonic() + 8.0
                        while time.monotonic() < recover:
                            # replication pushes admit the half-open
                            # probe write that closes the disk breaker
                            st, _b, _h = await s3.req(
                                "PUT", f"/chaos/heal-{time.monotonic():.3f}",
                                b"x" * 4096)
                            if st != 200:
                                stats["errors"] += 1
                            state = victim_health.worst_state()
                            if state == "ok":
                                break
                            await asyncio.sleep(0.3)
                        stats["disk_state_after_heal"] = state
                        summary["ok"] &= state == "ok"
                    inj.heal_network()
                    await inj.reconnect()
                    if phase == "fail_slow":
                        # …and the flag must CLEAR after heal: fresh
                        # fast samples pull the peer's digests back
                        # under clear_factor x the median, sustained
                        # for the hysteresis window — organic recovery,
                        # no operator reset
                        g0 = garages[0]
                        n2 = garages[2].system.id
                        cleared = False
                        recover = time.monotonic() + 25.0
                        while time.monotonic() < recover:
                            st, _b, _h = await s3.req(
                                "PUT",
                                f"/chaos/heal-{time.monotonic():.3f}",
                                b"y" * 8192)
                            if st != 200:
                                stats["errors"] += 1
                            probe = rng.choice(sorted(acked))
                            st, _b, _h = await s3.req(
                                "GET", f"/chaos/{probe}")
                            if st != 200:
                                stats["errors"] += 1
                            for g in garages:
                                await g.system.peering._tick()
                                await g.system.advertise_status()
                            if not g0.system.peer_fail_slow(n2):
                                cleared = True
                                break
                        stats["fail_slow_after_heal"] = (
                            g0.system.peer_fail_slow(n2))
                        summary["ok"] &= cleared
                    if phase == "blackhole":
                        # …and recover: cooldown, then one probe call
                        await asyncio.sleep(FAST_CHAOS_RPC["breaker_open_secs"] + 0.2)
                        g0 = garages[0]
                        n2 = garages[2].system.id
                        try:
                            await g0.system.rpc.call(
                                g0.block_manager.endpoint, n2,
                                {"t": "need_block", "h": bytes(32)},
                                timeout=5.0, idempotent=True)
                        except Exception as e:  # noqa: BLE001
                            print(f"probe after heal failed: {e}",
                                  file=sys.stderr)
                        stats["breaker_after_heal"] = (
                            g0.system.peering.breaker_state(n2))
                        summary["ok"] &= (
                            stats["breaker_after_heal"] == "closed")
                    lats.sort()
                    stats["ops"] = len(lats)
                    if lats:
                        stats["p50_ms"] = round(
                            lats[len(lats) // 2] * 1000, 2)
                        stats["p99_ms"] = round(
                            lats[min(len(lats) - 1,
                                     int(len(lats) * 0.99))] * 1000, 2)
                        stats["max_ms"] = round(lats[-1] * 1000, 2)
                    summary["phases"][phase] = stats
                    summary["ok"] &= stats["errors"] == 0
                    print(f"phase {phase}: {stats}", file=sys.stderr)
        finally:
            await server.stop()
            await inj.stop_network()
            for g in garages:
                await g.shutdown()
    return summary


async def run_repair_storm(secs, device):
    """The repair-storm drill: one node of a 6-node RS(2,2) EC cluster (meta
    "3", data "none", write-time distributed parity) is crashed and
    dropped from the layout while client PUT/GET traffic keeps running.
    Asserts: the storm stays CLIENT-INVISIBLE (zero errors — degraded
    reads decode through the repair planner), every acked object heals
    bit-identically, and the planned path's repair bytes-per-byte stays
    at or under the whole-shard exact-k baseline of k."""
    import aiohttp
    import numpy as np

    from ..testing.cluster import mk_cluster
    from ..testing.faults import (
        FAST_CHAOS_RPC,
        FaultInjector,
        crash_heaviest_and_drop,
    )
    from ..testing.s3_client import S3Client

    rng = random.Random(808)
    nprng = np.random.default_rng(88)
    summary = {"phases": {}, "ok": True}
    stats = {"puts": 0, "gets": 0, "errors": 0}
    with tempfile.TemporaryDirectory(prefix="garage_storm_") as tmp:
        from pathlib import Path

        garages, server, port, kid, secret = await mk_cluster(
            Path(tmp), n=6, repl="3", data_repl="none", db="memory",
            codec_cfg={"rs_data": 2, "rs_parity": 2,
                       "store_parity": True, "parity_on_write": True,
                       "parity_distribute": True,
                       "backend": codec_backend(device)},
            rpc_cfg=FAST_CHAOS_RPC, device=device)
        inj = FaultInjector(garages, device=device)
        try:
            async with aiohttp.ClientSession() as session:
                s3 = S3Client(session, port, kid, secret)
                st, _b, _h = await s3.req("PUT", "/storm")
                assert st == 200, f"bucket create: {st}"
                acked = {}
                for i in range(10):
                    body = nprng.integers(
                        0, 256, rng.randrange(256 << 10, 1 << 20),
                        dtype=np.uint8).tobytes()
                    st, _b, _h = await s3.req(
                        "PUT", f"/storm/seed-{i:03d}", body)
                    if st == 200:
                        acked[f"seed-{i:03d}"] = body
                        stats["puts"] += 1
                    else:
                        stats["errors"] += 1
                for g in garages:
                    if g.block_manager.ec_accumulator is not None:
                        await g.block_manager.ec_accumulator.drain()
                await asyncio.sleep(1.5)  # distributor indexing

                # kill the heaviest non-gateway data holder, drop it
                # from the layout — the product's own heal path runs
                _victim, _lost, survivors = await crash_heaviest_and_drop(
                    inj, resync_workers=2)

                def fetched():
                    return sum(
                        sum(g.block_manager.repair_fetch_bytes.values())
                        for g in survivors)

                def repaired_bytes():
                    return sum(g.block_manager.repair_repaired_bytes
                               for g in survivors)

                f0, r0 = fetched(), repaired_bytes()
                # live traffic THROUGH the storm
                lats = []
                deadline = time.monotonic() + secs
                i = 0
                while time.monotonic() < deadline:
                    i += 1
                    body = nprng.integers(
                        0, 256, rng.randrange(64 << 10, 256 << 10),
                        dtype=np.uint8).tobytes()
                    t0 = time.perf_counter()
                    st, _b, _h = await s3.req(
                        "PUT", f"/storm/live-{i:04d}", body)
                    lats.append(time.perf_counter() - t0)
                    if st == 200:
                        acked[f"live-{i:04d}"] = body
                        stats["puts"] += 1
                    else:
                        stats["errors"] += 1
                    probe = rng.choice(sorted(acked))
                    t0 = time.perf_counter()
                    st, got, _h = await s3.req("GET", f"/storm/{probe}")
                    lats.append(time.perf_counter() - t0)
                    if st == 200 and got == acked[probe]:
                        stats["gets"] += 1
                    else:
                        stats["errors"] += 1
                # heal completion: every acked object bit-identical
                pending = dict(acked)
                heal_deadline = time.monotonic() + 120
                while pending and time.monotonic() < heal_deadline:
                    for name in list(pending):
                        try:
                            st, got, _h = await asyncio.wait_for(
                                s3.req("GET", f"/storm/{name}"), 30)
                        except Exception:
                            stats["errors"] += 1
                            continue
                        if st == 200 and got == pending[name]:
                            del pending[name]
                        else:
                            stats["errors"] += 1
                    if pending:
                        await asyncio.sleep(1.0)
                stats["unhealed"] = len(pending)
                summary["ok"] &= len(pending) == 0
                moved = fetched() - f0
                repaired = repaired_bytes() - r0
                k = garages[0].config.codec.rs_data
                stats["repaired_bytes"] = repaired
                stats["repair_bytes_per_byte"] = round(
                    moved / max(1, repaired), 3)
                stats["repair_ppr_fallbacks"] = sum(
                    g.block_manager.repair_ppr_fallbacks
                    for g in survivors)
                stats["repair_overfetch_bytes"] = sum(
                    g.block_manager.repair_overfetch_bytes
                    for g in survivors)
                # planned path ≤ whole-shard exact-k baseline (k fetched
                # bytes per repaired byte; small slack for wire headers)
                summary["ok"] &= repaired > 0
                summary["ok"] &= (
                    stats["repair_bytes_per_byte"] <= k + 0.25)
                lats.sort()
                stats["ops"] = len(lats)
                if lats:
                    stats["p50_ms"] = round(
                        lats[len(lats) // 2] * 1000, 2)
                    stats["p99_ms"] = round(
                        lats[min(len(lats) - 1,
                                 int(len(lats) * 0.99))] * 1000, 2)
                summary["phases"]["repair_storm"] = stats
                summary["ok"] &= stats["errors"] == 0
                print(f"phase repair_storm: {stats}", file=sys.stderr)
        finally:
            await server.stop()
            for i, g in enumerate(inj.garages):
                if i not in inj.dead:
                    await g.shutdown()
    return summary


async def run_node_rebuild(secs, device, n_storage=6, n_zones=3):
    """The full-node-loss drill (quick: 6 nodes / 3 zones; the
    acceptance shape is 24 / 4).  The cluster stores data EC-only
    (RS(2,2), no whole-block replicas), so a full node loss can ONLY
    heal through codeword decode — the tree/chain repair planner and
    the fleet rebuild scheduler, not replica copies."""
    import aiohttp

    from ..testing.sim_cluster import (
        SimCluster,
        TrafficDriver,
        node_rebuild_drill,
    )

    summary = {"phases": {}, "ok": True,
               "cluster": {"storage_nodes": n_storage, "zones": n_zones}}
    ec_cfg = {
        "data_replication_mode": "none",
        "codec": {"rs_data": 2, "rs_parity": 2, "store_parity": True,
                  "parity_on_write": True, "parity_distribute": True,
                  "backend": codec_backend(device)},
    }
    with tempfile.TemporaryDirectory(prefix="garage_rebuild_") as tmp:
        cluster = SimCluster(tmp, n_storage=n_storage, n_zones=n_zones,
                             extra_cfg=ec_cfg, device=device)
        await cluster.start()
        try:
            async with aiohttp.ClientSession() as session:
                traffic = TrafficDriver(cluster, session,
                                        bucket="drill-node-rebuild")
                await traffic.make_bucket()
                st = await node_rebuild_drill(
                    cluster, traffic, secs,
                    seed_objects=max(24, 2 * n_storage))
                summary["phases"]["node_rebuild"] = st
                summary["ok"] &= bool(st.get("rebuild_complete"))
                summary["ok"] &= st.get("blocks_healed", 0) > 0
                summary["ok"] &= st.get("paced_sleeps", 0) > 0
                summary["ok"] &= st.get("verify_mismatches") == 0
                summary["ok"] &= st.get("errors") == 0
                print(f"phase node_rebuild: {st}", file=sys.stderr)
        finally:
            await cluster.stop()
    return summary


async def run_overload(secs, device, n_storage=3, n_zones=3):
    """The overload acceptance: a SimCluster whose gateway admits at most 2
    concurrent requests is driven at 1× then 4× offered load; the
    overload_drill asserts typed sheds only, bounded admitted p99,
    background ceding + recovery, and bit-identical read-back."""
    import aiohttp

    from ..testing.sim_cluster import SimCluster, overload_drill

    summary = {"phases": {}, "ok": True}
    with tempfile.TemporaryDirectory(prefix="garage_overload_") as tmp:
        cluster = SimCluster(
            tmp, n_storage=n_storage, n_zones=n_zones,
            extra_cfg={"api": {"max_inflight": 2,
                               "governor_tau": 0.5},
                       **sim_codec(device)}, device=device)
        await cluster.start()
        try:
            async with aiohttp.ClientSession() as session:
                st = await overload_drill(cluster, session, secs)
                summary["phases"]["overload"] = st
                for key in ("p99_within_3x", "sheds_observed",
                            "throttle_dropped", "throttle_recovered",
                            "admission_metric_seen",
                            "throttle_metric_seen"):
                    summary["ok"] &= bool(st.get(key))
                summary["ok"] &= st.get("errors") == 0
                summary["ok"] &= st.get("verify_mismatches") == 0
                print(f"phase overload: {st}", file=sys.stderr)
        finally:
            await cluster.stop()
    return summary


async def run_noisy(secs, device, n_storage=3, n_zones=3):
    """The multi-tenant acceptance: a SimCluster whose gateway admits at most 6
    concurrent requests hosts one abusive tenant at 2× that concurrency
    against 4 gently-paced well-behaved tenants.  The noisy_neighbor
    drill asserts per-tenant shed isolation (zero well-behaved sheds or
    errors, abuser shed typed), a bounded well-behaved p99, at least one
    remote_pressure shed at a locally-under-watermark gateway, and the
    new metric families passing the strict lint."""
    import aiohttp

    from ..testing.sim_cluster import (
        SimCluster,
        noisy_neighbor_drill,
    )

    summary = {"phases": {}, "ok": True}
    with tempfile.TemporaryDirectory(prefix="garage_noisy_") as tmp:
        cluster = SimCluster(
            tmp, n_storage=n_storage, n_zones=n_zones,
            extra_cfg={"api": {"max_inflight": 6,
                               "governor_tau": 0.5,
                               "tenant_queue_wait": 2.0},
                       **sim_codec(device)}, device=device)
        await cluster.start()
        try:
            async with aiohttp.ClientSession() as session:
                st = await noisy_neighbor_drill(cluster, session, secs)
                summary["phases"]["noisy_neighbor"] = st
                for key in ("abuser_shed_typed",
                            "remote_shed_observed", "admitted_after_heal"):
                    summary["ok"] &= bool(st.get(key))
                summary["ok"] &= st.get("well_sheds") == 0
                summary["ok"] &= st.get("errors") == 0
                summary["ok"] &= st.get("verify_mismatches") == 0
                summary["ok"] &= st.get("metric_families_missing") == []
                summary["ok"] &= st.get("promlint_errors") == []
                print(f"phase noisy_neighbor: {st}", file=sys.stderr)
        finally:
            await cluster.stop()
    return summary


async def run_wan(secs, device, n_storage=6, n_zones=3):
    """The WAN acceptance: a 6-node/3-zone SimCluster under the
    symmetric WAN_3ZONE_RTT matrix (z1-z2 20 ms, z1-z3 80 ms, z2-z3
    150 ms on boundary links only).  The wan_drill asserts local-zone
    GET p50 near the local RTT, zero fail-slow flags on healthy distant
    zones (plus a genuinely slow far peer still flagging), and
    cross-zone reads / write re-quorums paying exactly the matrix."""
    import aiohttp

    from ..testing.faults import FAST_CHAOS_HEALTH
    from ..testing.sim_cluster import SimCluster, wan_drill

    summary = {"phases": {}, "ok": True}
    with tempfile.TemporaryDirectory(prefix="garage_wan_") as tmp:
        cluster = SimCluster(
            tmp, n_storage=n_storage, n_zones=n_zones,
            extra_cfg={"health": dict(FAST_CHAOS_HEALTH),
                       **sim_codec(device)}, device=device)
        await cluster.start()
        try:
            async with aiohttp.ClientSession() as session:
                st = await wan_drill(cluster, session, secs)
                summary["phases"]["wan"] = st
                for key in ("local_p50_ok", "no_wan_false_positives",
                            "genuine_slow_flagged", "cross_pays_matrix",
                            "cross_vs_local_3x", "requorum_pays_matrix"):
                    summary["ok"] &= bool(st.get(key))
                summary["ok"] &= st.get("errors") == 0
                summary["ok"] &= st.get("verify_mismatches") == 0
                print(f"phase wan: {st}", file=sys.stderr)
        finally:
            await cluster.stop()
    return summary


async def run_gateway_failover(secs, device, n_storage=6, n_zones=3):
    """The gateway-failover acceptance: 2 gateways in front of a 6-node/3-zone
    SimCluster, traffic through the health-checked GatewayPool.  The
    drill kills g1 mid-PUT-body and mid-streaming-GET (zero acked-data
    loss: sibling retry + Range resume, everything bit-identical), then
    drains it gracefully under an in-flight slow GET — new requests
    shed typed SlowDown, the draining/drained state rides NodeStatus
    gossip, and the in-flight GET completes inside the bounded
    window.  The new metric families must lint and be documented."""
    import aiohttp

    from ..testing.sim_cluster import (
        SimCluster,
        gateway_failover_drill,
    )

    summary = {"phases": {}, "ok": True}
    with tempfile.TemporaryDirectory(prefix="garage_gwpool_") as tmp:
        cluster = SimCluster(
            tmp, n_storage=n_storage, n_zones=n_zones, n_gateways=2,
            extra_cfg=sim_codec(device), device=device)
        await cluster.start()
        try:
            async with aiohttp.ClientSession() as session:
                st = await gateway_failover_drill(cluster, session, secs)
                summary["phases"]["gateway_failover"] = st
                for key in ("mid_put_killed", "mid_put_recovered",
                            "mid_put_bit_identical",
                            "get_resumed_via_range",
                            "get_resume_bit_identical",
                            "drain_shed_typed", "drain_gossiped",
                            "drain_bounded", "drain_inflight_completed",
                            "drained_gossiped", "drain_socket_closed",
                            "failover_exercised", "resume_exercised"):
                    summary["ok"] &= bool(st.get(key))
                summary["ok"] &= st.get("errors") == 0
                summary["ok"] &= st.get("verify_mismatches") == 0
                summary["ok"] &= st.get("promlint_errors") == []
                summary["ok"] &= st.get("metricsdoc_missing") == []
                print(f"phase gateway_failover: {st}", file=sys.stderr)
        finally:
            await cluster.stop()
    return summary


async def run_zone(phases, secs, n_storage, n_zones, device):
    """The zone-scale drills on one SimCluster (built once, phases run
    in order — blackhole heals before drain, drain precedes rolling)."""
    import aiohttp

    from ..testing.sim_cluster import (
        SimCluster,
        TrafficDriver,
        compound_drill,
        rolling_restart_drill,
        zone_blackhole_drill,
        zone_drain_drill,
    )

    summary = {"phases": {}, "ok": True,
               "cluster": {"storage_nodes": n_storage, "zones": n_zones}}
    with tempfile.TemporaryDirectory(prefix="garage_zone_chaos_") as tmp:
        cluster = SimCluster(tmp, n_storage=n_storage, n_zones=n_zones,
                             extra_cfg=sim_codec(device), device=device)
        await cluster.start()
        try:
            async with aiohttp.ClientSession() as session:
                # ZONE_PHASES order is semantic (drain last), not the
                # user's flag order
                for phase in [p for p in ZONE_PHASES if p in phases]:
                    traffic = TrafficDriver(
                        cluster, session,
                        bucket="drill-" + phase.replace("_", "-"))
                    await traffic.make_bucket()
                    if phase == "zone_blackhole":
                        st = await zone_blackhole_drill(
                            cluster, traffic, secs, zone="z2")
                        summary["ok"] &= bool(st.get("breaker_opened"))
                        summary["ok"] &= st.get(
                            "breaker_states_after") == ["closed"]
                    elif phase == "compound":
                        st = await compound_drill(
                            cluster, traffic, secs, zone="z2")
                        summary["ok"] &= bool(st.get("disk_errors_injected"))
                        summary["ok"] &= st.get(
                            "breaker_states_after") == ["closed"]
                        summary["ok"] &= st.get("disk_state_after") == "ok"
                        summary["ok"] &= st.get("verify_mismatches") == 0
                    elif phase == "zone_drain":
                        st = await zone_drain_drill(
                            cluster, traffic, secs,
                            zone=f"z{n_zones}")
                        summary["ok"] &= bool(st.get("rebalance_complete"))
                        summary["ok"] &= st.get(
                            "verify_mismatches_zone_dark") == 0
                    elif phase == "rolling":
                        st = await rolling_restart_drill(
                            cluster, traffic, secs)
                        summary["ok"] &= bool(st.get("mixed_versions_seen"))
                        summary["ok"] &= st.get("verify_mismatches") == 0
                    summary["phases"][phase] = st
                    summary["ok"] &= st.get("errors") == 0
                    print(f"phase {phase}: {st}", file=sys.stderr)
        finally:
            await cluster.stop()
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    all_phases = (PHASES + ZONE_PHASES + STORM_PHASES + OVERLOAD_PHASES
                  + QOS_PHASES + WAN_PHASES + GATEWAY_PHASES
                  + REBUILD_PHASES)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(all_phases))
    ap.add_argument("--secs", type=float, default=8.0,
                    help="traffic seconds per phase")
    ap.add_argument("--quick", action="store_true",
                    help="3 s per phase (smoke mode)")
    ap.add_argument("--nodes", type=int, default=24,
                    help="storage nodes for the zone_* phases "
                         "(plus one gateway)")
    ap.add_argument("--zones", type=int, default=4,
                    help="zones for the zone_* phases")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where every node's codec runs: the card, or the "
                         "reference's CPU codec")
    args = ap.parse_args(argv)
    phases = [p.strip() for p in args.phases.split(",") if p.strip()]
    bad = [p for p in phases if p not in all_phases]
    if bad:
        ap.error(f"unknown phases: {bad}")
    secs = 3.0 if args.quick else args.secs
    node_phases = [p for p in phases if p in PHASES]
    zone_phases = [p for p in phases if p in ZONE_PHASES]
    storm_phases = [p for p in phases if p in STORM_PHASES]
    overload_phases = [p for p in phases if p in OVERLOAD_PHASES]
    qos_phases = [p for p in phases if p in QOS_PHASES]
    wan_phases = [p for p in phases if p in WAN_PHASES]
    gateway_phases = [p for p in phases if p in GATEWAY_PHASES]
    rebuild_phases = [p for p in phases if p in REBUILD_PHASES]
    if zone_phases:
        # the drills name zones z2/z{n} and a rolling restart only stays
        # client-invisible when every partition keeps ≥2 live zones
        # (factor-3 placement spreads over min(3, zones)), so fewer than
        # 3 zones is an argument error, not a mid-drill assertion
        if args.zones < 3:
            ap.error("zone phases need --zones >= 3")
        if args.nodes < args.zones:
            ap.error("--nodes must be >= --zones (every zone needs a node)")
    device = args.device
    if device == "cuda":
        from .common import require_card, reset_launches

        require_card()
        reset_launches()
    summary = {"phases": {}, "ok": True}
    if node_phases:
        s = asyncio.run(run(node_phases, secs, device))
        summary["phases"].update(s["phases"])
        summary["ok"] &= s["ok"]
    if zone_phases:
        s = asyncio.run(run_zone(zone_phases, secs, args.nodes, args.zones,
                                 device))
        summary["phases"].update(s["phases"])
        summary["cluster"] = s.get("cluster")
        summary["ok"] &= s["ok"]
    if storm_phases:
        s = asyncio.run(run_repair_storm(secs, device))
        summary["phases"].update(s["phases"])
        summary["ok"] &= s["ok"]
    if overload_phases:
        s = asyncio.run(run_overload(secs, device))
        summary["phases"].update(s["phases"])
        summary["ok"] &= s["ok"]
    if qos_phases:
        s = asyncio.run(run_noisy(secs, device))
        summary["phases"].update(s["phases"])
        summary["ok"] &= s["ok"]
    if wan_phases:
        # fixed acceptance shape (6 nodes / 3 zones — the matrix names
        # z1..z3), like the overload/QoS drills run their own clusters
        s = asyncio.run(run_wan(secs, device))
        summary["phases"].update(s["phases"])
        summary["ok"] &= s["ok"]
    if gateway_phases:
        s = asyncio.run(run_gateway_failover(secs, device))
        summary["phases"].update(s["phases"])
        summary["ok"] &= s["ok"]
    if rebuild_phases:
        # acceptance shape 24/4 (the --nodes/--zones defaults); --quick
        # shrinks to 6/3 so the smoke lane finishes in CI time
        rn, rz = (6, 3) if args.quick else (args.nodes, args.zones)
        s = asyncio.run(run_node_rebuild(secs, device, rn, rz))
        summary["phases"].update(s["phases"])
        summary["ok"] &= s["ok"]
    if device == "cuda":
        from .common import launch_counts

        summary["launches"] = launch_counts()
    print("CHAOS " + json.dumps(summary))
    if not summary["ok"]:
        return 1
    print("CHAOS OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
