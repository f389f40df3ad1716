"""SimCluster — a 20–30 node, 3–5 zone in-process cluster harness.

Scales the 3-node chaos scaffolding (an in-process cluster +
FaultInjector) to cluster-sized drills: per-node config generation
(memory db, CPU codec, fast-twitch [rpc] tunables; ``extra_cfg``
overrides any of it, e.g. a ``cuda`` codec and the native db), each
node's codec built on ``device`` (the GPU by default, as every entry
point of the port), bounded concurrent startup, a
zone-aware applied layout, one S3 gateway, and optional FaultyLink
interposition on every directed dial path so whole zones can be
partitioned/blackholed/slowed/killed live (FaultInjector zone verbs).

The drills live here so the tests (tests/test_torch_sim.py) and the
card's run (chip_smoke.py's chaos phase) drive exactly the same code;
the three cluster-scale zone drills:

  zone_blackhole_drill  one full zone dark under PUT/GET traffic —
                        reads served local-zone-first from survivors,
                        zero client-visible errors, boundary breakers
                        open and recover after heal
  zone_drain_drill      a layout change drains a whole zone while
                        clients keep writing — rebalance mover walks the
                        changed partitions (rebalance_partitions_done ==
                        total), every acked object bit-identical after
                        the drained nodes are gone
  rolling_restart_drill nodes restart one zone at a time with a bumped
                        version tag (handshake + gossip skew visible)
                        under live traffic, zero client errors

Invariants throughout are the chaos-soak ones: bit-identical read-back
of every acked object, deletes stay deleted, zero client-visible errors.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import time
from pathlib import Path
from typing import Dict, List, Optional

from .faults import FAST_CHAOS_RPC, FaultInjector
from .s3_client import S3Client

logger = logging.getLogger("garage_tpu_torch.testing.sim_cluster")

DEFAULT_ZONES = ("z1", "z2", "z3", "z4")


def p99(lats: List[float]) -> float:
    """Nearest-rank p99 over raw latency samples (0.0 when empty) —
    shared by the drills and bench phases so every quantile claim uses
    the same arithmetic."""
    ls = sorted(lats)
    return ls[min(len(ls) - 1, int(len(ls) * 0.99))] if ls else 0.0


async def make_tenant_client(garage, session, port: int, name: str,
                             bucket: str):
    """One QoS tenant: a fresh access key plus its own bucket, returned
    as a signing S3 client — shared by the noisy-neighbor drill and the
    Zipf bench phase so both harnesses mint tenants identically."""
    helper = garage.helper()
    key = await helper.create_key(name)
    key.params().allow_create_bucket.update(True)
    await garage.key_table.insert(key)
    s3 = S3Client(session, port, key.key_id, key.params().secret_key)
    st, _b, _h = await s3.req("PUT", f"/{bucket}")
    assert st == 200, f"bucket {bucket}: {st}"
    return s3


def check_typed_shed(body: bytes, headers,
                     codes=("SlowDown", "DeadlineExceeded")):
    """The typed-shed contract on a 503, encoded ONCE for every
    harness: S3 error XML with an allowed Code, a RequestId matching
    the x-amz-request-id header, and a positive integer Retry-After.
    Returns None when valid, else a short violation note."""
    import xml.etree.ElementTree as ET

    try:
        root = ET.fromstring(body)
        code, rid = root.findtext("Code"), root.findtext("RequestId")
    except ET.ParseError:
        return "503 body is not S3 error XML"
    if code not in codes:
        return f"503 code={code!r}"
    if not rid:
        return "503 missing RequestId"
    hdr_rid = headers.get("x-amz-request-id")
    if hdr_rid is not None and hdr_rid != rid:
        return "503 RequestId != x-amz-request-id header"
    ra = headers.get("Retry-After")
    try:
        if ra is None or int(ra) < 1:
            return f"503 Retry-After={ra!r}"
    except ValueError:
        return f"503 Retry-After={ra!r}"
    return None


def _zone_plan(n_nodes: int, n_zones: int) -> List[str]:
    """Round-robin zone assignment for `n_nodes` storage nodes."""
    zones = [f"z{i + 1}" for i in range(n_zones)]
    return [zones[i % n_zones] for i in range(n_nodes)]


class SimCluster:
    """n_storage nodes spread over n_zones, plus n_gateways gateway
    nodes (capacity None) that front the S3 API — so storage zones can
    be killed/restarted without taking the client's endpoint down, and
    (with n_gateways > 1) a GatewayPool client can fail requests over
    between siblings when one gateway dies or drains."""

    def __init__(self, tmp, n_storage: int = 24, n_zones: int = 4,
                 repl: str = "3", zone_redundancy="maximum",
                 db: str = "memory", rpc_cfg: Optional[dict] = None,
                 rebalance_rate_mib: float = 512.0,
                 extra_cfg: Optional[dict] = None,
                 n_gateways: int = 1, device="cuda"):
        self.tmp = Path(tmp)
        # where every node's codec runs (Garage(config, device=...)):
        # the card; "cpu" runs the kernels' plain versions (the tests)
        self.device = device
        self.n_storage = n_storage
        self.n_zones = n_zones
        self.n_gateways = n_gateways
        self.repl = repl
        self.zone_redundancy = zone_redundancy
        self.db = db
        self.rpc_cfg = dict(rpc_cfg if rpc_cfg is not None
                            else FAST_CHAOS_RPC)
        self.rebalance_rate_mib = rebalance_rate_mib
        # extra top-level config keys merged into EVERY node's config
        # (e.g. {"api": {"max_inflight": 2}} for the overload drill)
        self.extra_cfg = dict(extra_cfg or {})
        # index 0 = first gateway; storage nodes are 1..n_storage; extra
        # gateways ride at the tail (n_storage+1..) so every existing
        # storage_indices()/zone-drill invariant keeps holding.  Gateway
        # zone entries are None ON PURPOSE: zone-kill/rolling drills
        # enumerate zones through the injector and must never crash the
        # client's endpoint (their layout role still names a zone).
        self.zones: List[Optional[str]] = ([None] + _zone_plan(
            n_storage, n_zones) + [None] * (n_gateways - 1))
        self.garages: List = []
        self.injector: Optional[FaultInjector] = None
        self.servers: List = []   # one S3ApiServer per gateway
        self.ports: List[int] = []
        self.server = None        # first gateway's server (compat)
        self.port = self.key_id = self.secret = None

    # --- construction ---------------------------------------------------

    def _node_config(self, i: int) -> dict:
        cfg = {
            "metadata_dir": str(self.tmp / f"n{i}" / "meta"),
            "data_dir": str(self.tmp / f"n{i}" / "data"),
            "replication_mode": self.repl,
            "rpc_bind_addr": "127.0.0.1:0",
            "rpc_secret": "simcluster",
            "db_engine": self.db,
            "bootstrap_peers": [],
            "rebalance_rate_mib": self.rebalance_rate_mib,
            "codec": {"rs_data": 0, "rs_parity": 0, "backend": "cpu"},
            "rpc": dict(self.rpc_cfg),
        }
        cfg.update(self.extra_cfg)
        return cfg

    async def start(self, faults: bool = True,
                    startup_timeout: float = 120.0) -> None:
        from ..api.s3.api_server import S3ApiServer
        from ..model import Garage
        from ..rpc.layout import ClusterLayout, LayoutParameters, NodeRole
        from ..utils.config import config_from_dict

        t0 = time.monotonic()
        n = self.n_storage + self.n_gateways
        self.garages = [
            Garage(config_from_dict(self._node_config(i)),
                   device=self.device) for i in range(n)
        ]
        for g in self.garages:
            await g.system.netapp.listen("127.0.0.1:0")
        ports = [g.system.netapp._server.sockets[0].getsockname()[1]
                 for g in self.garages]
        for i, g in enumerate(self.garages):
            g.system.config.rpc_public_addr = f"127.0.0.1:{ports[i]}"

        # full-mesh dial, bounded + concurrent (i<j so each pair dials
        # once); sequential dialing would dominate startup at 24+ nodes
        async def dial(i, j):
            await self.garages[i].system.netapp.connect(
                f"127.0.0.1:{ports[j]}",
                expected_id=self.garages[j].system.id)

        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        for lo in range(0, len(pairs), 64):
            await asyncio.wait_for(
                asyncio.gather(*[dial(i, j)
                                 for i, j in pairs[lo:lo + 64]]),
                timeout=max(5.0, startup_timeout - (time.monotonic() - t0)))

        # zone-aware layout: gateways (capacity None) + storage roles
        lay = self.garages[0].system.layout
        lay.stage_parameters(LayoutParameters(self.zone_redundancy))
        for gi in self.gateway_indices():
            lay.stage_role(bytes(self.garages[gi].system.id),
                           NodeRole(self.zones[1] or "z1", None,
                                    ["gateway"]))
        for i in self.storage_indices():
            lay.stage_role(bytes(self.garages[i].system.id),
                           NodeRole(self.zones[i], 1000))
        lay.apply_staged_changes()
        enc = lay.encode()
        for g in self.garages:
            g.system.layout = ClusterLayout.decode(enc)
            g.system._rebuild_ring()
            g.system.save_layout()
            g.spawn_workers()

        # make the peers known to each other's peer books (reconnects,
        # revives and the fault-link migration all read from them)
        for i, a in enumerate(self.garages):
            for j, b in enumerate(self.garages):
                if i != j:
                    a.system.peering.add_peer(
                        f"127.0.0.1:{ports[j]}", b.system.id)

        self.injector = FaultInjector(self.garages, zones=self.zones,
                                      device=self.device)
        # share the injector's list so a revive()'s replacement Garage is
        # visible here too (drills read movers/metrics through it)
        self.garages = self.injector.garages
        if faults:
            await self.injector.add_network_faults(
                rng=random.Random(1009))
            ok = await self.injector.reconnect(rounds=10)
            if not ok:
                logger.warning("mesh not fully re-established through "
                               "fault links within the round budget")
        else:
            await self.tick()

        helper = self.garages[0].helper()
        key = await helper.create_key("sim")
        key.params().allow_create_bucket.update(True)
        await self.garages[0].key_table.insert(key)
        self.servers, self.ports = [], []
        for gi in self.gateway_indices():
            srv = S3ApiServer(self.garages[gi])
            await srv.start("127.0.0.1:0")
            self.servers.append(srv)
            self.ports.append(srv.port)
        self.server, self.port = self.servers[0], self.ports[0]
        self.key_id = key.key_id
        self.secret = key.params().secret_key
        logger.info("SimCluster up: %d nodes / %d zones / %d gateways "
                    "in %.1fs", n, self.n_zones, self.n_gateways,
                    time.monotonic() - t0)

    async def tick(self, rounds: int = 2) -> None:
        """Drive every live node's peering tick (pings → RTT EWMAs,
        breaker probes) — SimCluster never starts the 15 s loops, so
        drills control time themselves."""
        dead = self.injector.dead if self.injector else set()
        for _ in range(rounds):
            await asyncio.gather(*[
                g.system.peering._tick()
                for i, g in enumerate(self.garages) if i not in dead
            ], return_exceptions=True)
            await asyncio.sleep(0.05)

    async def stop(self) -> None:
        for srv in (self.servers or
                    ([self.server] if self.server else [])):
            await srv.stop()  # idempotent: killed gateways are no-ops
        if self.injector is not None:
            await self.injector.stop_network()
        for i, g in enumerate(self.garages):
            if self.injector is not None and i in self.injector.dead:
                continue
            try:
                await g.shutdown()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                logger.exception("node %d shutdown failed", i)

    # --- helpers used by the drills ------------------------------------

    def storage_indices(self) -> List[int]:
        return list(range(1, self.n_storage + 1))

    def zone_names(self) -> List[str]:
        return [f"z{i + 1}" for i in range(self.n_zones)]

    def metrics_value(self, i: int, needle: str) -> bool:
        return needle in self.garages[i].system.metrics.render()

    async def precompute_layout_change(self, mutate) -> bytes:
        """Stage `mutate` on a decoded copy of the current layout, run
        the assignment solve, and return the committed layout encoded
        — WITHOUT delivering it.  The solve is pure CPU and can hold
        the GIL for tens of seconds on a big change; real deployments
        run it on the operator's machine and the cluster only ever
        sees the finished result.  Drills that sample latency across a
        layout change must split the same way: solve while idle, then
        `apply_encoded_layout` instantly — a mid-traffic solve stalls
        every node in this single-process sim, RPC timeouts fire in a
        burst, breakers trip, and the movers' first pushes all fail
        before the measurement even starts."""
        from ..rpc.layout import ClusterLayout

        lay = ClusterLayout.decode(self.garages[0].system.layout.encode())
        mutate(lay)
        await asyncio.to_thread(lay.apply_staged_changes)
        return lay.encode()

    async def apply_encoded_layout(self, enc: bytes) -> None:
        """Deliver an already-solved layout to every live node (the
        CRDT merge path a CLI `layout apply` takes) — broadcast-timing
        independent, so drills never race the gossip."""
        from ..rpc.layout import ClusterLayout

        dead = self.injector.dead if self.injector else set()
        for i, g in enumerate(self.garages):
            if i not in dead:
                await g.system.update_cluster_layout(
                    ClusterLayout.decode(enc))

    async def apply_layout_change(self, mutate) -> None:
        """Stage + solve + deliver in one call, for drills that do not
        sample during the solve."""
        await self.apply_encoded_layout(
            await self.precompute_layout_change(mutate))

    # --- gateway pool helpers -------------------------------------------

    def gateway_indices(self) -> List[int]:
        return [0] + list(range(self.n_storage + 1,
                                self.n_storage + self.n_gateways))

    def gateway_endpoints(self) -> List:
        """[(name, port), ...] for a GatewayPool client."""
        return [(f"g{p}", self.ports[p]) for p in range(len(self.ports))]

    def apply_wan(self, matrix=None, jitter: float = 0.0) -> None:
        """Stretch the mesh into the 3-zone geography (WAN_3ZONE_RTT by
        default).  Gateways sit in the FIRST zone for WAN purposes:
        their injector zone entry stays None (zone-kill drills must
        never crash them) but their boundary links stretch like any z1
        resident's — matching their layout role's zone."""
        from .faults import WAN_3ZONE_RTT

        zones = list(self.zones)
        for gi in self.gateway_indices():
            zones[gi] = self.zones[1] or "z1"
        self.injector.apply_wan_matrix(
            WAN_3ZONE_RTT if matrix is None else matrix,
            zones=zones, jitter=jitter)

    async def kill_gateway(self, pos: int) -> None:
        """Abrupt gateway death (pool position `pos`): every live HTTP
        connection is aborted mid-byte — clients see resets, exactly
        like a kill -9 — then the listener closes.  The node's Garage
        stays up (it holds no data; the RPC mesh is untouched)."""
        srv = self.servers[pos]
        runner = getattr(srv, "_runner", None)
        if runner is not None and runner.server is not None:
            for proto in list(runner.server.connections):
                tr = getattr(proto, "transport", None)
                if tr is not None:
                    tr.abort()
        await srv.stop()

    async def restart_gateway(self, pos: int) -> int:
        """Bring a killed/drained gateway back on a fresh port; returns
        the new port (callers re-point their GatewayPool member)."""
        from ..api.s3.api_server import S3ApiServer

        g = self.garages[self.gateway_indices()[pos]]
        g.system.drain_state = None
        srv = S3ApiServer(g)
        await srv.start("127.0.0.1:0")
        self.servers[pos] = srv
        self.ports[pos] = srv.port
        if pos == 0:
            self.server, self.port = srv, srv.port
        return srv.port


class TrafficStats:
    def __init__(self):
        self.puts = 0
        self.gets = 0
        self.deletes = 0
        self.errors = 0
        self.error_notes: List[str] = []
        self.lats: List[float] = []

    def note_error(self, what: str) -> None:
        self.errors += 1
        if len(self.error_notes) < 8:
            self.error_notes.append(what)

    def summary(self) -> dict:
        lats = sorted(self.lats)
        out = {
            "puts": self.puts, "gets": self.gets, "deletes": self.deletes,
            "errors": self.errors, "ops": len(lats),
        }
        if self.error_notes:
            out["error_notes"] = list(self.error_notes)
        if lats:
            out["p50_ms"] = round(lats[len(lats) // 2] * 1000, 2)
            out["p99_ms"] = round(
                lats[min(len(lats) - 1, int(len(lats) * 0.99))] * 1000, 2)
            out["max_ms"] = round(lats[-1] * 1000, 2)
        return out


class TrafficDriver:
    """Sustained S3 PUT/GET/DELETE load against a SimCluster gateway,
    verifying the chaos-soak invariants inline: every GET of an acked
    object must be bit-identical, deleted objects must stay deleted."""

    def __init__(self, cluster: SimCluster, session, bucket: str = "drill",
                 seed: int = 4242):
        self.cluster = cluster
        # honor (clamped) Retry-After on 503s: the drills' sustained
        # traffic is production-shaped, not a shed-hammering loop
        self.s3 = S3Client(session, cluster.port, cluster.key_id,
                            cluster.secret, honor_retry_after=True,
                            retry_after_cap=0.5)
        self.bucket = bucket
        self.rng = random.Random(seed)
        self.acked: Dict[str, bytes] = {}
        self.deleted: set = set()
        self.stats = TrafficStats()
        self._seq = 0

    async def make_bucket(self) -> None:
        st, _b, _h = await self.s3.req("PUT", f"/{self.bucket}")
        assert st == 200, f"bucket create failed: {st}"

    def _body(self) -> bytes:
        n = self.rng.randrange(4 << 10, 128 << 10)
        # cheap deterministic filler (numpy-free: the drills run with
        # dozens of nodes in one interpreter — keep the client light)
        seed = self.rng.randrange(256)
        return bytes((seed + i) & 0xFF for i in range(0, n, 7)) * 7

    async def step(self, tag: str = "t") -> None:
        """One traffic step: PUT a fresh object, GET-verify a random
        acked one, occasionally DELETE (and verify 404 stays 404)."""
        self._seq += 1
        name = f"{tag}-{self._seq:05d}"
        body = self._body()
        t0 = time.perf_counter()
        try:
            st, _b, _h = await self.s3.req(
                "PUT", f"/{self.bucket}/{name}", body)
        except Exception as e:  # noqa: BLE001 — client sees a failure
            self.stats.note_error(f"PUT {name}: {e!r}")
            st = 0
        self.stats.lats.append(time.perf_counter() - t0)
        if st == 200:
            self.acked[name] = body
            self.stats.puts += 1
        elif st:
            self.stats.note_error(f"PUT {name}: HTTP {st}")
        if self.acked:
            probe = self.rng.choice(sorted(self.acked))
            t0 = time.perf_counter()
            try:
                st, got, _h = await self.s3.req(
                    "GET", f"/{self.bucket}/{probe}")
            except Exception as e:  # noqa: BLE001
                self.stats.note_error(f"GET {probe}: {e!r}")
                st, got = 0, b""
            self.stats.lats.append(time.perf_counter() - t0)
            if st == 200 and got == self.acked[probe]:
                self.stats.gets += 1
            elif st:
                self.stats.note_error(
                    f"GET {probe}: HTTP {st} "
                    f"({'bad body' if st == 200 else 'error'})")
        if self.deleted and self.rng.random() < 0.2:
            probe = self.rng.choice(sorted(self.deleted))
            st, _b, _h = await self.s3.req("GET", f"/{self.bucket}/{probe}")
            if st != 404:
                self.stats.note_error(
                    f"GET deleted {probe}: HTTP {st} (expected 404)")
        if len(self.acked) > 4 and self.rng.random() < 0.1:
            victim = self.rng.choice(sorted(self.acked))
            st, _b, _h = await self.s3.req(
                "DELETE", f"/{self.bucket}/{victim}")
            if st in (200, 204):
                del self.acked[victim]
                self.deleted.add(victim)
                self.stats.deletes += 1
            else:
                self.stats.note_error(f"DELETE {victim}: HTTP {st}")

    async def run_for(self, secs: float, tag: str,
                      tick_every: int = 5) -> None:
        deadline = time.monotonic() + secs
        i = 0
        while time.monotonic() < deadline:
            i += 1
            await self.step(tag)
            if i % tick_every == 0:
                await self.cluster.tick(rounds=1)

    async def verify_all(self) -> int:
        """Read back EVERY acked object; returns mismatches (also
        counted into stats.errors)."""
        bad = 0
        for name, body in sorted(self.acked.items()):
            st, got, _h = await self.s3.req("GET", f"/{self.bucket}/{name}")
            if st != 200 or got != body:
                bad += 1
                self.stats.note_error(f"verify {name}: HTTP {st}")
        for name in sorted(self.deleted):
            st, _b, _h = await self.s3.req("GET", f"/{self.bucket}/{name}")
            if st != 404:
                bad += 1
                self.stats.note_error(
                    f"verify deleted {name}: HTTP {st} (expected 404)")
        return bad


# --- the three cluster-scale drills -----------------------------------


async def zone_blackhole_drill(cluster: SimCluster, traffic: TrafficDriver,
                               secs: float, zone: str = "z2") -> dict:
    """One full zone dark: traffic must see ZERO errors (replication
    spans zones by placement; reads fall back across the boundary), the
    gateway must order local-zone read candidates first, and the
    boundary breakers must open during the fault and close after heal +
    reconnect."""
    inj = cluster.injector
    g0 = cluster.garages[0]
    out: dict = {"zone": zone}

    # zone-aware routing is live on the gateway: for a partition with a
    # local-zone replica, that replica orders before every cross-zone one
    lz = g0.system.our_zone()
    zone_first = checked = 0
    for p in range(0, 256, 7):
        nodes = g0.system.ring.partition_nodes(p)
        order = g0.system.rpc.request_order(nodes)
        zs = [g0.system.zone_of(nx) for nx in order]
        if lz in zs:
            checked += 1
            if zs[0] == lz:
                zone_first += 1
    out["local_zone_first"] = f"{zone_first}/{checked}"
    assert checked == 0 or zone_first == checked, out

    inj.blackhole_zone(zone)
    await traffic.run_for(secs, f"bh-{zone}")
    # the dark zone must be visible in the gateway's breakers: at least
    # one zone member's breaker left "closed" while the zone was dark.
    # The evidence can trail the traffic window by a full ping/handshake
    # timeout cycle (~10 s — a blackholed peer fails SLOWLY by nature),
    # so wait for the verdict bounded, with the zone still dark.
    dark = [cluster.garages[i].system.id for i in inj.nodes_in_zone(zone)]
    wait_by = time.monotonic() + 15.0
    while (all(g0.system.peering.breaker_state(nid) == "closed"
               for nid in dark) and time.monotonic() < wait_by):
        await cluster.tick(rounds=1)
        await asyncio.sleep(0.3)
    states = [g0.system.peering.breaker_state(nid) for nid in dark]
    out["breaker_states_during"] = sorted(set(states))
    out["breaker_opened"] = any(s != "closed" for s in states)

    inj.heal_zone(zone)
    await inj.reconnect(rounds=8)
    open_secs = cluster.rpc_cfg.get("breaker_open_secs", 1.0)
    await asyncio.sleep(open_secs + 0.2)
    await traffic.run_for(max(secs / 2, 1.0), f"heal-{zone}")
    await cluster.tick()
    states = [g0.system.peering.breaker_state(nid) for nid in dark]
    out["breaker_states_after"] = sorted(set(states))
    out.update(traffic.stats.summary())
    return out


async def zone_drain_drill(cluster: SimCluster, traffic: TrafficDriver,
                           secs: float, zone: str = "z3",
                           settle_secs: float = 30.0) -> dict:
    """Drain a whole zone via a layout change while clients keep
    writing: the remaining zones must absorb the drained partitions
    (rebalance mover: partitions done == total on every node), and every
    object acked before OR during the drain must read back bit-identical
    afterwards — including after the drained nodes are gone dark."""
    from ..rpc.layout import NodeRole

    inj = cluster.injector
    drained = inj.nodes_in_zone(zone)
    out: dict = {"zone": zone, "drained_nodes": len(drained)}

    # seed some pre-drain data
    await traffic.run_for(max(secs / 2, 1.0), "pre-drain")

    async def change():
        def mutate(lay):
            for i in drained:
                lay.stage_role(
                    bytes(cluster.garages[i].system.id), None)
            # zone count shrinks: "maximum" recomputes, an int must
            # still fit — callers pick a legal zone_redundancy
        await cluster.apply_layout_change(mutate)

    # drain concurrently with live writes
    load = asyncio.ensure_future(traffic.run_for(secs, "during-drain"))
    await change()
    await load

    # wait until every live node's mover finished its run
    deadline = time.monotonic() + settle_secs
    movers = [g.rebalance_mover
              for i, g in enumerate(cluster.garages) if i not in inj.dead]
    while time.monotonic() < deadline:
        busy = [m for m in movers if not m.idle()]
        if not busy:
            break
        await traffic.step("drain-settle")
        await asyncio.sleep(0.1)
    out["rebalance"] = [
        {"done": m.partitions_done, "total": m.partitions_total,
         "bytes": m.bytes_moved}
        for m in movers if m.partitions_total
    ]
    out["rebalance_complete"] = all(
        m.idle() and m.partitions_done == m.partitions_total
        for m in movers)
    # give the confirm-before-drop offloads a moment to finish their
    # resync pushes, then take the drained zone completely dark and
    # verify every acked object still reads bit-identical
    for _ in range(10):
        if all(cluster.garages[i].block_resync.queue_len() == 0
               for i in range(len(cluster.garages)) if i not in inj.dead):
            break
        await asyncio.sleep(0.3)
    out["drained_metric_seen"] = cluster.metrics_value(
        1, "rebalance_partitions_done")
    inj.partition_zone(zone)
    bad = await traffic.verify_all()
    out["verify_mismatches_zone_dark"] = bad
    inj.heal_zone(zone)
    out.update(traffic.stats.summary())
    return out


def data_block_bytes(inj: FaultInjector, i: int) -> int:
    """Bytes of node i's data blocks on disk: its block files less the
    distributed parity shards it holds.  A lost parity shard is no row
    the rebuild decodes (it parks a dead word's parity), and the drills'
    compressible bodies leave data blocks a tenth the size of the parity
    shards over them: counted in, they would pick a victim holding only
    parity, whose loss no rebuild heals."""
    mgr = inj.garages[i].block_manager
    total = 0
    for path in inj._block_files(i):
        name = os.path.basename(path).split(".")[0]
        try:
            h = bytes.fromhex(name)
        except ValueError:
            continue
        if not mgr.is_parity_block(h):
            total += os.path.getsize(path)
    return total


async def node_rebuild_drill(cluster: SimCluster, traffic: TrafficDriver,
                             secs: float,
                             settle_secs: float = 90.0,
                             seed_objects: int = 24) -> dict:
    """The full-node-loss drill: FULL storage-node loss.  Crash the
    storage node holding the most data-block bytes (data_block_bytes)
    and drop it from the committed layout while clients keep reading and
    writing.  Proves:

      - the storm stays client-invisible (zero errors; degraded reads
        decode through the repair planner — GET p99 reported),
      - every new owner's fleet rebuild scheduler walks its lost
        partitions to done == total, paced under the governor
        (paced_sleeps > 0 shows the throttle engaged, never a free-run),
      - zero acked-data loss: every object acked before or during the
        storm reads back bit-identical after the rebuild settles,
      - repair ingress is partial-product attributed ("tree"/"ppr"
        modes in repair_fetch_bytes), not whole-block over-fetch."""
    inj = cluster.injector
    out: dict = {}

    # seed a FIXED object count, so the victim holds data worth
    # rebuilding regardless of host speed (a wall-clock window on a
    # slow/oversubscribed host seeds a couple of objects and the
    # schedulers legitimately find nothing to heal)
    for _ in range(seed_objects):
        await traffic.step("pre-loss")
    for g in cluster.garages:
        if g.block_manager.ec_accumulator is not None:
            await g.block_manager.ec_accumulator.drain()
    gateways = set(cluster.gateway_indices())
    sizes = []
    for i in cluster.storage_indices():
        if i in inj.dead or i in gateways:
            continue
        sizes.append((data_block_bytes(inj, i), i))
    lost_bytes, victim = max(sizes)
    victim_id = bytes(cluster.garages[victim].system.id)
    out["victim"], out["lost_bytes"] = victim, lost_bytes

    # solve the post-loss layout while idle (see precompute_layout_change
    # for why a mid-traffic solve would poison the latency sample)
    enc = await cluster.precompute_layout_change(
        lambda lay: lay.stage_role(victim_id, None))
    await inj.crash(victim)
    # storm: live traffic THROUGH the loss, the layout drop, and the
    # rebuild ramp-up — the ring change fires every survivor's
    # _feed_rebuild hook, so schedulers start under this load
    load = asyncio.ensure_future(traffic.run_for(secs, "rebuild-storm"))
    await cluster.apply_encoded_layout(enc)
    await load

    # settle: every live storage node's rebuild scheduler finishes its run
    live = [g for i, g in enumerate(cluster.garages)
            if i not in inj.dead and i not in gateways]
    scheds = [g.rebuild_scheduler for g in live]
    deadline = time.monotonic() + settle_secs
    stable_since = None
    while time.monotonic() < deadline:
        if all(s.idle() for s in scheds):
            # idle must HOLD: table sync still delivering migrated refs
            # re-arms a walk (note_ref), flipping idle back off
            if stable_since is None:
                stable_since = time.monotonic()
            elif time.monotonic() - stable_since >= 5.0:
                break
        else:
            stable_since = None
        await traffic.step("rebuild-settle")
        await asyncio.sleep(0.1)
    episodes = [s for s in scheds if s.partitions_total]
    out["rebuild"] = [
        {"done": s.partitions_done, "total": s.partitions_total,
         "blocks": s.blocks_healed, "bytes": s.bytes_healed,
         "paced": s.paced_sleeps, "rearms": s.rearms}
        for s in episodes]
    out["rebuild_complete"] = bool(episodes) and all(
        s.idle() and s.partitions_done == s.partitions_total
        for s in episodes)
    out["blocks_healed"] = sum(s.blocks_healed for s in episodes)
    out["paced_sleeps"] = sum(s.paced_sleeps for s in episodes)
    out["rearms"] = sum(s.rearms for s in episodes)
    # parked stragglers flow scheduler → resync (source="rebuild");
    # give that handoff a bounded moment to drain
    for _ in range(20):
        if all(g.block_resync.queue_len() == 0 for g in live):
            break
        await asyncio.sleep(0.3)
    out["resync_rebuild_skips"] = sum(
        g.block_resync.rebuild_skips for g in live)
    fetch: Dict[str, int] = {}
    for g in live:
        for mode, nbytes in g.block_manager.repair_fetch_bytes.items():
            fetch[mode] = fetch.get(mode, 0) + int(nbytes)
    out["repair_fetch_bytes"] = fetch
    out["verify_mismatches"] = await traffic.verify_all()
    out.update(traffic.stats.summary())
    return out


async def overload_drill(cluster: SimCluster, session, secs: float,
                         bucket: str = "drill-overload") -> dict:
    """The overload drill: drive the gateway 4× past its
    admission capacity and prove defined past-saturation behavior —

      - every rejected request is a TYPED 503 (S3 XML Code SlowDown or
        DeadlineExceeded, Retry-After present); no hangs, no untyped 500s
      - admitted-request p99 at 4× offered load stays within 3× the
        1×-offered (at-capacity) p99: admission keeps the in-service
        concurrency constant no matter the offered load
      - background_throttle_ratio observably drops while the gate is hot
        and recovers to ~1 afterwards (background bytes/s ceding)
      - zero acked-data loss: every 200-acked PUT reads back bit-identical

    The cluster must be built with a small ``[api] max_inflight`` (via
    SimCluster extra_cfg) so "4× capacity" is reachable from one client
    process."""
    import xml.etree.ElementTree as ET

    g0 = cluster.garages[0]
    gate = g0.admission
    cap = max(gate.tun.max_inflight, 1)
    s3 = S3Client(session, cluster.port, cluster.key_id, cluster.secret)
    st, _b, _h = await s3.req("PUT", f"/{bucket}")
    assert st == 200, f"bucket create: {st}"
    out: dict = {"capacity": cap, "errors": 0, "error_notes": []}
    acked: Dict[str, bytes] = {}
    seq = [0]

    def body_for(i: int) -> bytes:
        seed = (i * 131) & 0xFF
        return bytes(((seed + j) & 0xFF for j in range(4096))) * 8

    async def one_op(tag: str, lats, shed, i: int) -> str:
        name = f"{tag}-{i:06d}"
        body = body_for(i)
        t0 = time.monotonic()
        try:
            st, rb, hdrs = await asyncio.wait_for(
                s3.req("PUT", f"/{bucket}/{name}", body), 30.0)
        except asyncio.TimeoutError:
            out["errors"] += 1
            out["error_notes"].append(f"PUT {name}: HANG (client timeout)")
            return "error"
        except Exception as e:  # noqa: BLE001
            out["errors"] += 1
            out["error_notes"].append(f"PUT {name}: {e!r}")
            return "error"
        took = time.monotonic() - t0
        if st == 200:
            lats.append(took)
            acked[name] = body
        elif st == 503:
            # typed shed: the XML Code must be one of the two defined
            # overload answers and Retry-After must ride the response
            try:
                code = ET.fromstring(rb).findtext("Code")
                rid = ET.fromstring(rb).findtext("RequestId")
            except ET.ParseError:
                code = rid = None
            if code not in ("SlowDown", "DeadlineExceeded"):
                out["errors"] += 1
                out["error_notes"].append(f"PUT {name}: 503 code={code!r}")
                return "error"
            if "Retry-After" not in hdrs or not rid:
                out["errors"] += 1
                out["error_notes"].append(
                    f"PUT {name}: 503 missing Retry-After/RequestId")
                return "error"
            shed.append(name)
            return "shed"
        else:
            out["errors"] += 1
            out["error_notes"].append(f"PUT {name}: HTTP {st} (untyped)")
            return "error"
        return "ok"

    async def drive(concurrency: int, run_secs: float, tag: str,
                    lats: list, shed: list, ratio_min: list) -> None:
        deadline = time.monotonic() + run_secs

        async def worker() -> None:
            while time.monotonic() < deadline:
                seq[0] += 1
                verdict = await one_op(tag, lats, shed, seq[0])
                ratio_min[0] = min(ratio_min[0], g0.governor.ratio())
                if verdict == "shed":
                    # a minimally-behaved client pauses after a 503
                    # (far below the Retry-After hint): offered load
                    # stays 4× capacity, but the in-process client's
                    # closed-loop shed spin must not starve the server
                    # core and masquerade as admitted-latency inflation
                    await asyncio.sleep(0.02)

        await asyncio.gather(*[worker() for _ in range(concurrency)])

    # 1× offered = at capacity, no shedding expected — the honest
    # baseline for "what does an ADMITTED request cost"
    base_lats: list = []
    base_shed: list = []
    rmin = [1.0]
    await drive(cap, max(secs / 2, 2.0), "base", base_lats, base_shed, rmin)
    out["baseline_p99_ms"] = round(p99(base_lats) * 1000, 2)
    out["baseline_ops"] = len(base_lats)

    # 4× offered: the gate must shed the excess typed while admitted
    # work stays fast and the governor parks background load
    over_lats: list = []
    over_shed: list = []
    rmin = [g0.governor.ratio()]
    await drive(4 * cap, secs, "over", over_lats, over_shed, rmin)
    out["overload_p99_ms"] = round(p99(over_lats) * 1000, 2)
    out["overload_ops"] = len(over_lats)
    out["shed"] = len(over_shed) + len(base_shed)
    out["shed_rate"] = round(
        len(over_shed) / max(len(over_lats) + len(over_shed), 1), 3)
    out["throttle_ratio_min"] = round(rmin[0], 3)
    out["throttle_dropped"] = rmin[0] < 0.9
    out["p99_within_3x"] = (
        out["overload_p99_ms"] <= 3 * max(out["baseline_p99_ms"], 1.0))
    out["sheds_observed"] = len(over_shed) > 0
    out["admission_metric_seen"] = cluster.metrics_value(
        0, "api_admission_total")
    out["throttle_metric_seen"] = cluster.metrics_value(
        0, "background_throttle_ratio")

    # recovery: pressure gone → background rate restored
    recover_by = time.monotonic() + 30.0
    ratio = g0.governor.ratio()
    while ratio < 0.9 and time.monotonic() < recover_by:
        await asyncio.sleep(0.25)
        ratio = g0.governor.ratio()
    out["throttle_ratio_after"] = round(ratio, 3)
    out["throttle_recovered"] = ratio >= 0.9

    # zero acked-data loss, bit-identical
    bad = 0
    for name, body in sorted(acked.items()):
        st, got, _h = await s3.req("GET", f"/{bucket}/{name}")
        if st != 200 or got != body:
            bad += 1
            out["error_notes"].append(f"verify {name}: HTTP {st}")
    out["verify_mismatches"] = bad
    out["acked"] = len(acked)
    out["error_notes"] = out["error_notes"][:8]
    if not out["error_notes"]:
        del out["error_notes"]
    return out


async def noisy_neighbor_drill(cluster: SimCluster, session, secs: float,
                               n_well: int = 4,
                               hot_pressure: float = 2.0) -> dict:
    """The noisy-neighbor drill: one abusive tenant saturates the
    gateway while well-behaved tenants keep a gentle pace — the WDRR
    admission gate must isolate the abuse:

      - ZERO client errors (untyped or shed) for well-behaved tenants;
        their p99 holds within a small multiple of the no-abuser
        baseline measured first
      - the abuser's excess is shed TYPED (503, S3 XML Code SlowDown,
        Retry-After, RequestId), per-tenant, never gate-wide
      - cluster-aware admission: with a storage node's gossiped
        governor_pressure pinned hot, a request whose bucket lives on
        that node is shed `remote_pressure` at the gateway while the
        gateway's own gate is UNDER its watermark — and admitted again
        once the pressure heals
      - the new api_tenant_* / admission metric families render and
        pass the strict exposition lint

    The cluster must be built with a small ``[api] max_inflight`` (via
    SimCluster extra_cfg) so saturation is reachable from one client."""
    import xml.etree.ElementTree as ET

    g0 = cluster.garages[0]
    gate = g0.admission
    cap = max(gate.tun.max_inflight, 1)
    out: dict = {"capacity": cap, "errors": 0, "error_notes": [],
                 "well_tenants": n_well}

    well = [await make_tenant_client(g0, session, cluster.port,
                                     f"well{i}", f"nb-well{i}")
            for i in range(n_well)]
    abuser = await make_tenant_client(g0, session, cluster.port,
                                      "abuser", "nb-abuser")

    def body_for(i: int, size: int) -> bytes:
        seed = (i * 37) & 0xFF
        return bytes(((seed + j) & 0xFF for j in range(256))) * (size // 256)

    acked: Dict[str, tuple] = {}

    async def well_loop(idx: int, s3, lats: list, sheds: list,
                        deadline: float) -> None:
        i = 0
        while time.monotonic() < deadline:
            i += 1
            name, body = f"w{idx}-{i:05d}", body_for(i, 8 << 10)
            t0 = time.monotonic()
            try:
                st, _b, _h = await asyncio.wait_for(
                    s3.req("PUT", f"/nb-well{idx}/{name}", body), 30.0)
            except Exception as e:  # noqa: BLE001
                out["errors"] += 1
                out["error_notes"].append(f"well{idx} PUT {name}: {e!r}")
                continue
            lats.append(time.monotonic() - t0)
            if st == 200:
                acked[f"well{idx}/{name}"] = (s3, f"/nb-well{idx}/{name}",
                                              body)
            elif st == 503:
                sheds.append(name)     # acceptance: must stay EMPTY
            else:
                out["errors"] += 1
                out["error_notes"].append(f"well{idx} PUT {name}: HTTP {st}")
            await asyncio.sleep(0.005)  # gentle, well under fair share

    async def abuse_loop(conc: int, shed: list, deadline: float) -> None:
        seq = [0]

        async def worker() -> None:
            while time.monotonic() < deadline:
                seq[0] += 1
                name = f"a-{seq[0]:06d}"
                try:
                    st, rb, hdrs = await asyncio.wait_for(
                        abuser.req("PUT", f"/nb-abuser/{name}",
                                   body_for(seq[0], 16 << 10)), 30.0)
                except Exception as e:  # noqa: BLE001
                    out["errors"] += 1
                    out["error_notes"].append(f"abuser PUT {name}: {e!r}")
                    continue
                if st == 503:
                    bad = check_typed_shed(rb, hdrs)
                    if bad is not None:
                        out["errors"] += 1
                        out["error_notes"].append(
                            f"abuser {name}: untyped {bad}")
                    else:
                        shed.append(name)
                    # minimally-behaved backoff (well below the
                    # Retry-After hint): offered load stays saturating
                    # but the in-process client's closed-loop shed spin
                    # must not burn the single shared core and read as
                    # well-tenant latency
                    await asyncio.sleep(0.02)
                elif st != 200:
                    out["errors"] += 1
                    out["error_notes"].append(f"abuser {name}: HTTP {st}")

        await asyncio.gather(*[worker() for _ in range(conc)])

    # --- phase 1: no abuser — the honest baseline ---
    base_lats: list = []
    base_sheds: list = []
    deadline = time.monotonic() + max(secs / 2, 2.0)
    await asyncio.gather(*[
        well_loop(i, s3, base_lats, base_sheds, deadline)
        for i, s3 in enumerate(well)])
    out["well_p99_base_ms"] = round(p99(base_lats) * 1000, 2)
    out["well_ops_base"] = len(base_lats)

    # --- phase 2: the abuser saturates (>= 4x its fair share offered) ---
    abuse_lats: list = []
    abuse_sheds_well: list = []
    abuser_shed: list = []
    deadline = time.monotonic() + secs
    await asyncio.gather(
        abuse_loop(2 * cap, abuser_shed, deadline),
        *[well_loop(i, s3, abuse_lats, abuse_sheds_well, deadline)
          for i, s3 in enumerate(well)])
    out["well_p99_abuse_ms"] = round(p99(abuse_lats) * 1000, 2)
    out["well_ops_abuse"] = len(abuse_lats)
    out["well_sheds"] = len(base_sheds) + len(abuse_sheds_well)
    out["abuser_sheds"] = len(abuser_shed)
    out["abuser_shed_typed"] = len(abuser_shed) > 0
    # informational here: everything (clients + 4 server nodes) shares
    # one interpreter, so admitted-abuser CPU inflates this ratio with noise
    # fairness can't remove; the Zipf BENCH phase owns the hard 2x bound
    out["well_p99_ratio"] = round(
        out["well_p99_abuse_ms"] / max(out["well_p99_base_ms"], 1.0), 2)
    out["tenant_stats"] = gate.tenant_stats()

    # --- phase 3: cluster-aware admission (remote_pressure shed) ---
    # pin a storage node that hosts well0's bucket hot, gossip it, and
    # prove the gateway sheds on its behalf while locally idle
    probe = g0.admission_probe
    bid = probe._ids.get("nb-well0")
    assert bid is not None, "probe never learned the bucket placement"
    nodes = g0.system.ring.get_nodes(
        bid, g0.system.replication_mode.replication_factor)
    victim_idx = next(
        i for i, g in enumerate(cluster.garages)
        if any(bytes(g.system.id) == bytes(n) for n in nodes) and i != 0)
    victim = cluster.garages[victim_idx]
    victim.governor.add_signal("noisy_drill", lambda: hot_pressure)
    await victim.system.advertise_status()
    before = gate.m_admission.get(verdict="remote_pressure")
    out["gateway_inflight_at_probe"] = gate.inflight
    st, rb, hdrs = await well[0].req(
        "PUT", "/nb-well0/remote-probe", body_for(1, 4 << 10))
    out["remote_pressure_status"] = st
    out["remote_pressure_sheds"] = (
        gate.m_admission.get(verdict="remote_pressure") - before)
    out["remote_shed_observed"] = (
        st == 503 and out["remote_pressure_sheds"] >= 1
        and gate.inflight < gate.limit)
    if st == 503:
        try:
            out["remote_pressure_code"] = ET.fromstring(rb).findtext("Code")
        except ET.ParseError:
            out["remote_pressure_code"] = None
    # heal: pressure gone -> admitted again
    victim.governor.remove_signal("noisy_drill")
    await victim.system.advertise_status()
    st, _b, _h = await well[0].req(
        "PUT", "/nb-well0/remote-heal", body_for(2, 4 << 10))
    out["admitted_after_heal"] = st == 200

    # --- the new families render and pass the strict lint ---
    from ..utils.promlint import lint_exposition

    body = g0.system.metrics.render()
    missing = [fam for fam in (
        "api_admission_total", "api_admission_limit",
        "api_admission_queue_depth", "api_admission_queue_wait_seconds",
        "api_tenant_inflight", "api_tenant_shed_total",
        "api_longpoll_parked", "cluster_peer_pressure",
    ) if fam not in body]
    out["metric_families_missing"] = missing
    out["promlint_errors"] = lint_exposition(body)[:4]

    # zero acked-data loss, bit-identical
    bad = 0
    for _k, (s3, path, bodyb) in sorted(acked.items()):
        st, got, _h = await s3.req("GET", path)
        if st != 200 or got != bodyb:
            bad += 1
    out["verify_mismatches"] = bad
    out["acked"] = len(acked)
    out["error_notes"] = out["error_notes"][:8]
    if not out["error_notes"]:
        del out["error_notes"]
    return out


async def compound_drill(cluster: SimCluster, traffic: TrafficDriver,
                         secs: float, zone: str = "z2",
                         disk_prob: float = 0.25) -> dict:
    """Compound failure from ROADMAP's scenario list: one whole zone
    blackholed AND a flaky disk (probabilistic read EIO) on a node in a
    surviving zone, at the same time, under live PUT/GET/DELETE traffic.
    Asserts zero client-visible errors through the compound fault (reads
    fail over across both the dark zone and the dying disk; writes stay
    clean — the disk fault is read-side so write quorums are untouched)
    and full recovery after heal: boundary breakers closed, disk errors
    stopped, every acked object bit-identical."""
    import errno as _errno

    inj = cluster.injector
    g0 = cluster.garages[0]
    out: dict = {"zone": zone}

    # flaky READ disk on a storage node OUTSIDE the blackholed zone: the
    # compound must be survivable by construction (replication still has
    # one clean replica per partition), the point is that BOTH degraded
    # paths run concurrently
    victim = next(i for i in cluster.storage_indices()
                  if cluster.zones[i] != zone)
    out["disk_victim"] = victim
    fd = inj.add_disk_faults(victim)
    fd.read_errno = _errno.EIO
    fd.read_error_prob = disk_prob

    inj.blackhole_zone(zone)
    await traffic.run_for(secs, f"compound-{zone}")
    # the drill must PROVE the disk fault was exercised, not just armed:
    # replica placement decides which surviving node serves each probe
    # (and step-traffic slows under the dark zone), so sweep GETs over
    # every acked object — deterministically touching every surviving
    # replica — until the victim's disk has actually thrown.  The read
    # errors stay client-invisible: the failover ladder serves from
    # another replica, which is exactly what the sweep asserts.
    extra_by = time.monotonic() + max(2 * secs, 10.0)
    while fd.injected["read"] == 0 and time.monotonic() < extra_by:
        for name in sorted(traffic.acked):
            st, got, _h = await traffic.s3.req(
                "GET", f"/{traffic.bucket}/{name}")
            if st != 200 or got != traffic.acked[name]:
                traffic.stats.note_error(
                    f"compound sweep GET {name}: HTTP {st}")
            else:
                traffic.stats.gets += 1
            if fd.injected["read"]:
                break
        if not traffic.acked:
            break

    dark = [cluster.garages[i].system.id for i in inj.nodes_in_zone(zone)]
    out["breaker_opened"] = any(
        g0.system.peering.breaker_state(nid) != "closed" for nid in dark)
    mgr = cluster.garages[victim].block_manager
    out["disk_errors_injected"] = fd.injected["read"] > 0

    # heal both faults, then prove recovery under fresh traffic
    inj.heal_disk(victim)
    inj.heal_zone(zone)
    await inj.reconnect(rounds=8)
    open_secs = cluster.rpc_cfg.get("breaker_open_secs", 1.0)
    await asyncio.sleep(open_secs + 0.2)
    await traffic.run_for(max(secs / 2, 1.0), f"heal-{zone}")
    await cluster.tick()
    out["breaker_states_after"] = sorted({
        g0.system.peering.breaker_state(nid) for nid in dark})
    out["disk_state_after"] = mgr.health.worst_state()
    out["verify_mismatches"] = await traffic.verify_all()
    out.update(traffic.stats.summary())
    return out


async def rolling_restart_drill(cluster: SimCluster,
                                traffic: TrafficDriver, secs: float,
                                new_version: str = "0.9.1-next") -> dict:
    """Rolling upgrade: one zone at a time, crash every node of the
    zone, bump its version tag, revive, wait for the mesh to converge —
    all under live traffic with zero client-visible errors.  Mid-roll,
    the gateway must see BOTH versions in its handshake-learned
    peer_versions (the mixed-version regime the wire format must
    survive)."""
    inj = cluster.injector
    g0 = cluster.garages[0]
    out: dict = {"zones": [], "mixed_versions_seen": False,
                 "new_version": new_version}
    per_zone = max(secs / max(cluster.n_zones, 1), 1.0)
    for zone in cluster.zone_names():
        members = inj.nodes_in_zone(zone)
        load = asyncio.ensure_future(
            traffic.run_for(per_zone, f"roll-{zone}"))
        for i in members:
            inj.configs[i].node_version = new_version
        await inj.kill_zone(zone)
        await asyncio.sleep(0.3)
        await inj.revive_zone(zone, wait_secs=15.0)
        await load
        await cluster.tick()
        vs = {v for v in g0.system.netapp.peer_versions.values() if v}
        if len(vs) > 1:
            out["mixed_versions_seen"] = True
        out["zones"].append({"zone": zone, "restarted": len(members),
                             "versions_seen": sorted(vs)})
    bad = await traffic.verify_all()
    out["verify_mismatches"] = bad
    out.update(traffic.stats.summary())
    return out


async def wan_drill(cluster: SimCluster, session, secs: float,
                    bucket: str = "wan-drill") -> dict:
    """The geo-WAN drill, on a 6-node/3-zone
    cluster with the WAN_3ZONE_RTT matrix applied:

      - local-zone-first GETs hold: gateway (a z1 resident) serves
        GET p50 near the LOCAL quorum cost (z1@0 + z2@20ms), nowhere
        near the cross-country z3 RTT
      - fail-slow scoring does NOT flag healthy-but-distant zones (the
        zone-aware baseline: a z3 peer is judged against z3 siblings,
        not against loopback neighbors) — and a GENUINELY slow peer
        still flags through the same scorer
      - cross-zone reads pay exactly the matrix: with the gateway cut
        off from z1 storage, GET quorum needs z2+z3 → p50 ≥ ~z1z3 RTT
        and ≥ 3× the local p50; write re-quorums pay the same toll

    Bodies are 2 KiB (< INLINE_THRESHOLD) so a GET is a pure metadata
    quorum read — latency IS the RPC geography, no streaming noise."""
    inj = cluster.injector
    g0 = cluster.garages[0]
    out: dict = {"errors": 0, "error_notes": [],
                 "matrix_ms": {f"{a}-{b}": rtt * 1000 for (a, b), rtt
                               in (inj.wan_matrix or {}).items()}}

    cluster.apply_wan()
    out["matrix_ms"] = {f"{a}-{b}": rtt * 1000
                        for (a, b), rtt in inj.wan_matrix.items()}
    # prime the RTT EWMAs under WAN delays (adaptive timeouts must
    # learn the new geography before anything is measured against it)
    await cluster.tick(rounds=3)

    s3 = S3Client(session, cluster.port, cluster.key_id, cluster.secret)
    st, _b, _h = await s3.req("PUT", f"/{bucket}")
    assert st == 200, f"bucket create: {st}"

    def body_for(i: int) -> bytes:
        return bytes(((i * 53 + j) & 0xFF) for j in range(256)) * 8  # 2 KiB

    # --- phase 1: local-zone traffic under the WAN matrix ---
    n_ops = max(8, min(16, int(4 * secs)))
    put_lats, get_lats = [], []
    acked: Dict[str, bytes] = {}
    for i in range(n_ops):
        name, body = f"wan-{i:04d}", body_for(i)
        t0 = time.perf_counter()
        st, _b, _h = await s3.req("PUT", f"/{bucket}/{name}", body)
        put_lats.append(time.perf_counter() - t0)
        if st != 200:
            out["errors"] += 1
            out["error_notes"].append(f"PUT {name}: HTTP {st}")
            continue
        acked[name] = body
        t0 = time.perf_counter()
        st, got, _h = await s3.req("GET", f"/{bucket}/{name}")
        get_lats.append(time.perf_counter() - t0)
        if st != 200 or got != body:
            out["errors"] += 1
            out["error_notes"].append(f"GET {name}: HTTP {st}")
    local_rtt = min(v for (a, b), v in inj.wan_matrix.items()
                    if "z1" in (a, b))
    local_p50 = sorted(get_lats)[len(get_lats) // 2]
    out["local_get_p50_ms"] = round(local_p50 * 1000, 2)
    out["local_put_p50_ms"] = round(
        sorted(put_lats)[len(put_lats) // 2] * 1000, 2)
    # local quorum = z1 (free) + metro z2: the GET must cost ~one metro
    # RTT per metadata read, generous slack for the in-process sim
    out["local_p50_ok"] = local_p50 <= local_rtt + 0.075

    # --- phase 2: healthy-but-distant zones must NOT read fail-slow ---
    # feed the scorers (peering pings pay the WAN tolls now), spanning
    # more than the sustained-flag window
    for _ in range(6):
        await cluster.tick(rounds=1)
        await asyncio.sleep(0.12)
    flagged = []
    scored_peers = 0
    for i, g in enumerate(cluster.garages):
        if inj and i in inj.dead:
            continue
        sc = g.system.health_scorer.scores()
        scored_peers += len(sc)
        flagged += [f"node{i}->{p}" for p, v in sc.items()
                    if v["fail_slow"]]
    out["wan_false_positives"] = flagged[:8]
    out["wan_scored_peers"] = scored_peers
    out["no_wan_false_positives"] = scored_peers > 0 and not flagged

    # ...and a GENUINELY slow peer (in the far zone, judged against its
    # own sibling) must still flag through the very same scorer
    victim = inj.nodes_in_zone("z3")[0]
    victim_hex = bytes(cluster.garages[victim].system.id).hex()[:16]
    inj.slow_peer(victim, 0.35)
    flag_by = time.monotonic() + 12.0
    genuine = False
    while not genuine and time.monotonic() < flag_by:
        await cluster.tick(rounds=1)
        await asyncio.sleep(0.1)
        for i, g in enumerate(cluster.garages):
            if i == victim:
                continue
            v = g.system.health_scorer.scores().get(victim_hex)
            if v is not None and v["fail_slow"]:
                genuine = True
                break
    out["genuine_slow_flagged"] = genuine
    # slow_peer overwrote the victim's WAN delays too: rebuild the
    # geography from scratch rather than guessing what it clobbered
    inj.clear_wan_matrix()
    cluster.apply_wan()

    # --- phase 3: cross-zone reads + write re-quorum pay the matrix ---
    # cut the gateway off from its OWN zone's storage (gateway-only
    # partition: the storage mesh keeps its full quorums) so every
    # metadata read must assemble quorum from z2 (metro) + z3 (far)
    z1_members = inj.nodes_in_zone("z1")
    for i in z1_members:
        inj.partition(0, i)
    for _ in range(3):  # open the gateway's z1 breakers (fail fast)
        await cluster.tick(rounds=1)
    for name in list(acked)[:2]:  # warm: absorb breaker-opening costs
        await s3.req("GET", f"/{bucket}/{name}")
    cross_get, cross_put = [], []
    probe_names = sorted(acked)[:8]
    for name in probe_names:
        t0 = time.perf_counter()
        st, got, _h = await s3.req("GET", f"/{bucket}/{name}")
        cross_get.append(time.perf_counter() - t0)
        if st != 200 or got != acked[name]:
            out["errors"] += 1
            out["error_notes"].append(f"cross GET {name}: HTTP {st}")
    for i in range(6):
        name, body = f"requorum-{i:03d}", body_for(100 + i)
        t0 = time.perf_counter()
        st, _b, _h = await s3.req("PUT", f"/{bucket}/{name}", body)
        cross_put.append(time.perf_counter() - t0)
        if st == 200:
            acked[name] = body
        else:
            out["errors"] += 1
            out["error_notes"].append(f"requorum PUT {name}: HTTP {st}")
    far_rtt = max(v for (a, b), v in inj.wan_matrix.items()
                  if "z1" in (a, b))
    cross_p50 = sorted(cross_get)[len(cross_get) // 2]
    out["cross_get_p50_ms"] = round(cross_p50 * 1000, 2)
    out["requorum_put_p50_ms"] = round(
        sorted(cross_put)[len(cross_put) // 2] * 1000, 2)
    # quorum 2-of-{z2@20, z3@80} waits on the far zone: the drill's
    # teeth — cross-zone pays the MATRIX, not some flat timeout
    out["cross_pays_matrix"] = cross_p50 >= 0.8 * far_rtt
    out["cross_vs_local_3x"] = cross_p50 >= 3.0 * max(local_p50, 1e-4)
    out["requorum_pays_matrix"] = (
        sorted(cross_put)[len(cross_put) // 2] >= 0.8 * far_rtt)

    # --- heal: flat mesh again, everything still bit-identical ---
    for i in z1_members:
        inj.heal_link(0, i)
    inj.clear_wan_matrix()
    await inj.reconnect(rounds=8)
    bad = 0
    for name, body in sorted(acked.items()):
        st, got, _h = await s3.req("GET", f"/{bucket}/{name}")
        if st != 200 or got != body:
            bad += 1
    out["verify_mismatches"] = bad
    out["acked"] = len(acked)
    out["error_notes"] = out["error_notes"][:8]
    if not out["error_notes"]:
        del out["error_notes"]
    return out


async def gateway_failover_drill(cluster: SimCluster, session,
                                 secs: float,
                                 bucket: str = "pool-drill") -> dict:
    """The zero-loss gateway failover drill (needs a cluster
    built with n_gateways >= 2):

      - a GatewayPool client drives live PUT/GET traffic across both
        gateways while g1 is killed mid-PUT-body and mid-streaming-GET:
        zero acked-data loss (bit-identical reads via the sibling),
        the interrupted unacked PUT retried to success on g0, the
        interrupted GET RESUMED on g0 via Range (no refetch)
      - graceful drain: a SIGTERM'd gateway sheds new requests typed
        (503 SlowDown + RequestId + Retry-After), finishes its
        in-flight streaming GET inside the bounded drain window, and
        its draining/drained state rides NodeStatus gossip
      - the new gateway_pool_* / gateway_drain_state families render,
        pass promlint, and are documented in docs/OBSERVABILITY.md"""
    from pathlib import Path as _Path

    from ..utils.metricsdoc import undocumented_families
    from ..utils.promlint import lint_exposition
    from .gateway_pool import GatewayPool

    assert cluster.n_gateways >= 2, "drill needs a gateway sibling"
    out: dict = {"errors": 0, "error_notes": [],
                 "gateways": cluster.n_gateways}
    pool = GatewayPool(session, cluster.gateway_endpoints(),
                       cluster.key_id, cluster.secret,
                       metrics=cluster.garages[0].system.metrics)
    st, _b, _h = await pool.request("PUT", f"/{bucket}")
    assert st == 200, f"bucket create: {st}"
    out["probe_initial"] = await pool.probe()

    # --- live background traffic through the pool, for the whole run ---
    acked: Dict[str, bytes] = {}
    stop_bg = asyncio.Event()

    async def bg_loop() -> None:
        i = 0
        rng = random.Random(77)
        while not stop_bg.is_set():
            i += 1
            name = f"bg-{i:05d}"
            body = bytes(((i * 31 + j) & 0xFF) for j in range(512)) * 4
            try:
                st, rb, hdrs = await pool.request(
                    "PUT", f"/{bucket}/{name}", body, prefer=i % 2)
            except Exception as e:  # noqa: BLE001
                out["errors"] += 1
                out["error_notes"].append(f"bg PUT {name}: {e!r}")
                continue
            if st == 200:
                acked[name] = body
            elif st == 503:
                bad = check_typed_shed(rb, hdrs)
                if bad is not None:
                    out["errors"] += 1
                    out["error_notes"].append(f"bg PUT {name}: {bad}")
            else:
                out["errors"] += 1
                out["error_notes"].append(f"bg PUT {name}: HTTP {st}")
            if acked and rng.random() < 0.5:
                probe = rng.choice(sorted(acked))
                try:
                    st, got, _h = await pool.request(
                        "GET", f"/{bucket}/{probe}")
                except Exception as e:  # noqa: BLE001
                    out["errors"] += 1
                    out["error_notes"].append(f"bg GET {probe}: {e!r}")
                    continue
                if st != 200 or got != acked[probe]:
                    out["errors"] += 1
                    out["error_notes"].append(
                        f"bg GET {probe}: HTTP {st}"
                        + (" bad body" if st == 200 else ""))
            await asyncio.sleep(0.01)

    bg = asyncio.ensure_future(bg_loop())
    pattern = bytes(range(256)) * (4 << 10)  # 1 MiB

    # --- scenario A: gateway dies mid-PUT-body ---
    big1 = pattern * 3
    killed = asyncio.Event()

    def trickle():
        async def gen():
            chunk = 64 << 10
            for off in range(0, len(big1), chunk):
                if off >= len(big1) // 2 and not killed.is_set():
                    killed.set()
                    await cluster.kill_gateway(1)
                yield big1[off:off + chunk]
        return gen()

    st, _b, _h = await pool.request(
        "PUT", f"/{bucket}/big-1", big1, prefer=1, body_factory=trickle)
    out["mid_put_status"] = st
    out["mid_put_killed"] = killed.is_set()
    out["mid_put_recovered"] = st == 200
    if st == 200:
        acked["big-1"] = big1
    st, got, _h = await pool.request("GET", f"/{bucket}/big-1")
    out["mid_put_bit_identical"] = st == 200 and got == big1

    # --- scenario B: gateway dies mid-streaming-GET → Range resume ---
    pool.set_port("g1", await cluster.restart_gateway(1))
    big2 = bytes(reversed(pattern)) * 8
    st, _b, _h = await pool.request(
        "PUT", f"/{bucket}/big-2", big2, prefer=0)
    assert st == 200, f"PUT big-2: {st}"
    acked["big-2"] = big2
    killed2 = [False]

    async def on_chunk(total: int) -> None:
        if total >= (256 << 10) and not killed2[0]:
            killed2[0] = True
            await cluster.kill_gateway(1)

    st, got, resumed = await pool.get_resumable(
        f"/{bucket}/big-2", prefer=1, on_chunk=on_chunk)
    out["get_resume_status"] = st
    out["get_resumed_via_range"] = resumed
    out["get_resume_bit_identical"] = got == big2

    stop_bg.set()
    await bg

    # --- scenario C: graceful drain under in-flight traffic ---
    pool.set_port("g1", await cluster.restart_gateway(1))
    g1i = cluster.gateway_indices()[1]
    g1_id = bytes(cluster.garages[g1i].system.id)
    got_slow = bytearray()

    async def slow_consumer() -> None:
        # client-paced DOWNLOAD: the handler may finish long before the
        # client (loopback kernel buffers swallow the body) — the bytes
        # must still arrive bit-identical across the drain close
        async with pool.stream_request(1, "GET", f"/{bucket}/big-2") as r:
            out["drain_slow_get_status"] = r.status
            async for chunk in r.content.iter_chunked(512 << 10):
                got_slow.extend(chunk)
                await asyncio.sleep(0.05)

    # ...while a client-paced UPLOAD holds a handler genuinely in
    # flight for the whole window (the server cannot finish reading
    # bytes the client hasn't sent): the drain MUST wait this one out
    slow_body = bytes(((j * 7) & 0xFF) for j in range(256 << 10)) * 8

    def drip():
        async def gen():
            chunk = 256 << 10
            for off in range(0, len(slow_body), chunk):
                yield slow_body[off:off + chunk]
                await asyncio.sleep(0.12)
        return gen()

    slow_task = asyncio.ensure_future(slow_consumer())
    put_task = asyncio.ensure_future(pool.raw(
        1, "PUT", f"/{bucket}/drain-slow", slow_body, body_factory=drip))
    await asyncio.sleep(0.25)  # both are in flight on g1
    drain_task = asyncio.ensure_future(
        cluster.servers[1].drain(timeout=8.0))
    await asyncio.sleep(0.05)
    # while draining: a NEW request to g1 sheds typed, never hangs —
    # and the listener must still be UP (the in-flight PUT pins the
    # window open), so a refused connection here is a drain bug
    try:
        st, rb, hdrs = await pool.raw(1, "GET", f"/{bucket}/big-2")
        out["drain_shed_status"] = st
        out["drain_shed_typed"] = (
            st == 503
            and check_typed_shed(rb, hdrs, codes=("SlowDown",)) is None)
    except Exception as e:  # noqa: BLE001 — evidence, not a stack trace
        out["drain_shed_status"] = f"unreachable: {e!r}"
        out["drain_shed_typed"] = False
    await asyncio.sleep(0.1)  # let the "draining" advertisement land
    # ...and the draining state is visible in a STORAGE node's gossip
    def _gossiped_drain() -> Optional[str]:
        sys1 = cluster.garages[1].system
        row = next((s for nid, s in sys1.node_status.items()
                    if bytes(nid) == g1_id), None)
        return getattr(row, "drain", None)

    out["drain_gossiped"] = _gossiped_drain() == "draining"
    window = await drain_task
    await slow_task
    st_put, _b, _h = await put_task
    if st_put == 200:
        acked["drain-slow"] = slow_body
    out["drain_window_s"] = round(window, 2)
    out["drain_bounded"] = window < 8.0
    out["drain_inflight_completed"] = (st_put == 200
                                       and bytes(got_slow) == big2)
    out["drained_gossiped"] = _gossiped_drain() == "drained"
    try:  # post-drain the socket is CLOSED, not wedged
        await pool.raw(1, "GET", "/")
        out["drain_socket_closed"] = False
    except Exception:  # noqa: BLE001 — refused/reset is the pass
        out["drain_socket_closed"] = True

    # --- zero acked-data loss, bit-identical, via the surviving pool ---
    bad = 0
    for name, body in sorted(acked.items()):
        st, got, _h = await pool.request("GET", f"/{bucket}/{name}")
        if st != 200 or got != body:
            bad += 1
            out["error_notes"].append(f"verify {name}: HTTP {st}")
    out["verify_mismatches"] = bad
    out["acked"] = len(acked)
    out["pool_counters"] = dict(pool.counters)
    out["failover_exercised"] = pool.counters["failovers"] >= 2
    out["resume_exercised"] = pool.counters["resumes"] >= 1

    # --- the new families render, lint clean, and are documented ---
    expo0 = cluster.garages[0].system.metrics.render()
    expo1 = cluster.garages[g1i].system.metrics.render()
    out["drain_gauge_rendered"] = "gateway_drain_state" in expo1
    out["pool_counters_rendered"] = "gateway_pool_failover_total" in expo0
    out["promlint_errors"] = (lint_exposition(expo0)
                              + lint_exposition(expo1))[:4]
    doc = (_Path(__file__).resolve().parents[2]
           / "docs" / "OBSERVABILITY.md").read_text()
    out["metricsdoc_missing"] = sorted(
        undocumented_families(expo0 + "\n" + expo1, doc))[:8]
    out["error_notes"] = out["error_notes"][:8]
    if not out["error_notes"]:
        del out["error_notes"]
    return out
