"""System — cluster membership manager.

Equivalent of reference src/rpc/system.rs: persisted node key + cluster
layout + peer list, status gossip every STATUS_EXCHANGE_INTERVAL, discovery
loop every DISCOVERY_INTERVAL (bootstrap peers + persisted peers), layout
push/pull & CRDT merge (system.rs:652-701), and `ClusterHealth` computed by
partition quorum counting (system.rs:468-527).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import os
import socket
import time
from typing import Callable, Dict, List, Optional

from ..net import FullMeshPeering, NetApp
from ..net.frame import PRIO_HIGH
from ..net.netapp import load_or_gen_node_key
from ..utils.config import Config
from ..utils.data import FixedBytes32
from ..utils.migrate import Migrated
from ..utils.persister import Persister
from .layout import N_PARTITIONS, ClusterLayout
from .replication_mode import ReplicationMode, parse_replication_mode
from .ring import Ring
from .rpc_helper import RpcHelper

logger = logging.getLogger("garage_tpu_torch.rpc.system")

STATUS_EXCHANGE_INTERVAL = 10.0   # ref system.rs:44-50
DISCOVERY_INTERVAL = 60.0

SYSTEM_ENDPOINT = "garage/system"


class PersistedPeers(Migrated):
    """[(node_id, addr)] remembered across restarts (ref system.rs:88-89)."""

    VERSION_MARKER = b"GT01peers"

    def __init__(self, peers: Optional[List[List]] = None):
        self.peers = peers or []  # [ [id_bytes, addr_str], ... ]

    def fields(self):
        return self.peers

    @classmethod
    def from_fields(cls, body):
        return cls([[bytes(i), str(a)] for i, a in body])


@dataclasses.dataclass
class NodeStatus:
    """Gossiped per-node status (ref system.rs NodeStatus)."""

    hostname: str = "?"
    replication_factor: int = 0
    layout_version: int = 0
    layout_staging_hash: bytes = b""
    data_avail: Optional[int] = None   # bytes free on data disk
    data_total: Optional[int] = None
    meta_avail: Optional[int] = None
    meta_total: Optional[int] = None
    # worst per-root disk health ("ok"/"degraded"/"failed"; None = peer
    # predates the field): peers learn a node went read-only from gossip,
    # not from their next rejected rpc_put_block (block/health.py)
    disk_state: Optional[str] = None
    # software version the node runs (also exchanged in the transport
    # handshake): the rolling-upgrade drill's skew signal — `cluster
    # stats` shows which zones still run the old build.  None = peer
    # predates the field
    version: Optional[str] = None
    # current load-governor pressure (utils/overload.py; 0 idle, >= 1
    # saturated, clamped to 2).  Gateways fold the max pressure of the
    # layout nodes a request must touch into ADMISSION (shed at the
    # front door on behalf of the hot node — docs/ROBUSTNESS.md
    # "Multi-tenant fairness & noisy neighbors").  None = peer predates
    # the field / governor unwired
    governor_pressure: Optional[float] = None
    # this node's comparative fail-slow view of ITS peers (utils/
    # health_score.py): {peer hex16 prefix: score} plus the flagged
    # subset.  Riding gossip means every node learns about a straggler
    # from the nodes that actually call it — a gateway that never
    # talks to a storage node directly still demotes it in repair /
    # read ranking.  None = peer predates the fields / scorer dark
    health_scores: Optional[Dict[str, float]] = None
    fail_slow: Optional[List[str]] = None
    # graceful-drain state of the node's API front door ("draining"
    # while a SIGTERM'd gateway sheds new requests and finishes its
    # in-flight set, "drained" once it stopped serving).  Riding gossip
    # means sibling gateways and pool clients learn to absorb the load
    # BEFORE the socket closes.  None = not draining / peer predates
    # the field
    drain: Optional[str] = None

    def pack(self):
        return dataclasses.asdict(self)

    @classmethod
    def unpack(cls, d):
        return cls(**{k: d.get(k) for k in (
            "hostname", "replication_factor", "layout_version",
            "layout_staging_hash", "data_avail", "data_total",
            "meta_avail", "meta_total", "disk_state", "version",
            "governor_pressure", "health_scores", "fail_slow",
            "drain",
        )})


@dataclasses.dataclass
class ClusterHealth:
    """(ref system.rs:468-527)"""

    status: str                 # healthy | degraded | unavailable
    known_nodes: int
    connected_nodes: int
    storage_nodes: int
    storage_nodes_ok: int
    partitions: int
    partitions_quorum: int
    partitions_all_ok: int


class System:
    """Membership + layout + ring + rpc helper — the node's cluster brain
    (ref rpc/system.rs:84-123)."""

    def __init__(self, config: Config, replication_mode: Optional[ReplicationMode] = None):
        self.config = config
        self.replication_mode = replication_mode or parse_replication_mode(
            config.replication_mode
        )
        os.makedirs(config.metadata_dir, exist_ok=True)
        self.node_key = load_or_gen_node_key(
            os.path.join(config.metadata_dir, "node_key")
        )
        # the version advertised in the transport handshake and status
        # gossip; node_version overrides for mixed-version drills
        from .. import __version__ as _pkg_version

        self.version = getattr(config, "node_version", None) or _pkg_version
        self.netapp = NetApp(self.node_key, config.rpc_secret,
                             version=self.version)
        self.id = self.netapp.id
        # per-node metrics registry: every layer records into it and the
        # admin /metrics endpoint renders it (ref util/metrics.rs + the
        # per-layer metric structs).  Built BEFORE peering/netapp wiring
        # so the transport's per-peer instruments register into it.
        from ..utils.metrics import MetricsRegistry
        from ..utils.tracing import init_tracing

        self.metrics = MetricsRegistry()
        self.netapp.set_metrics(self.metrics)
        # [rpc] resilience tunables drive the per-peer circuit breakers
        # (peering) and adaptive timeouts / retries / hedging (RpcHelper)
        self.peering = FullMeshPeering(self.netapp, metrics=self.metrics,
                                       tunables=config.rpc)
        # per-peer metric series only for peers with a dialable address;
        # throwaway CLI connections aggregate under peer="transient"
        # (unbounded label growth otherwise)
        self.netapp.peer_durable_fn = lambda nid: (
            (st := self.peering.peers.get(nid)) is not None
            and st.addr is not None
        )
        # tracer next to the metrics registry: spans export to
        # admin.trace_sink when configured, no-op otherwise (ref
        # garage/tracing_setup.rs:13-37)
        self.tracer = init_tracing(
            getattr(config, "admin_trace_sink", None), bytes(self.id)
        )
        # the transport parents incoming-request handler spans on the
        # caller's propagated context (cross-node traces)
        self.netapp.tracer = self.tracer
        # request-waterfall recorder (utils/waterfall.py): every
        # finished span lands in its bounded ring; request roots are
        # sampled into per-endpoint critical-path breakdowns + retained
        # slowest trees (admin `request waterfall`), and
        # request_critical_path_seconds{endpoint,segment} derives here
        from ..utils.waterfall import WaterfallRecorder

        self.tracer.waterfall = WaterfallRecorder(metrics=self.metrics)
        # tracer self-observability: exporter health + the always-on
        # slow-op log's high-water mark are scrapeable, so "is tracing
        # even working" never needs a collector to answer
        self.metrics.gauge(
            "tracer_spans_exported_total", "Spans delivered to the "
            "OTLP collector", fn=lambda: float(self.tracer.exported))
        self.metrics.gauge(
            "tracer_spans_dropped_total", "Spans dropped (no/slow "
            "collector)", fn=lambda: float(self.tracer.dropped))
        self.metrics.gauge(
            "tracer_slow_op_max_seconds", "Slowest operation retained "
            "in the slow-op log", fn=lambda: self.tracer.slow.max_seconds())
        self.rpc = RpcHelper(self.netapp, self.peering, metrics=self.metrics,
                             tracer=self.tracer, tunables=config.rpc)

        # --- fleet health: comparative fail-slow scorer (utils/
        # health_score.py).  Fed per-peer service times by RpcHelper's
        # call path and the peering ping loop; its verdicts ride
        # NodeStatus gossip, demote flagged peers in peer_rank, and
        # trigger the incident flight recorder (model/garage.py hooks
        # on_change) ---
        from ..utils.health_score import FailSlowScorer, HealthTunables

        self.health_scorer = FailSlowScorer(
            getattr(config, "health", None) or HealthTunables())
        self.rpc.set_health_source(
            self.peer_pressure, self.peer_fail_slow,
            note=self._health_note)
        self.peering.rtt_note = (
            lambda nid, rtt: self._health_note(nid, "ping", rtt))
        # merged (local + fresh gossip) health view, cached briefly:
        # peer_rank consults it per candidate, so a rank must be a dict
        # lookup, not a gossip-table scan
        self._health_view_cache: tuple = (-1e9, {})
        self.metrics.gauge(
            "peer_health_score",
            "Comparative fail-slow score per peer (worst ratio of the "
            "peer's per-endpoint-class service time to the cluster "
            "lower-median; local + fresh gossiped views merged, max "
            "wins)",
            labeled_fn=lambda: [
                ({"peer": p}, v[0])
                for p, v in sorted(self._health_view().items())
            ],
        )
        self.metrics.gauge(
            "peer_fail_slow",
            "1 while the peer is flagged fail-slow (up, pings fine, "
            "breaker closed — but a sustained factor slower than its "
            "siblings; demoted in read/repair ranking)",
            labeled_fn=lambda: [
                ({"peer": p}, 1.0 if v[1] else 0.0)
                for p, v in sorted(self._health_view().items())
            ],
        )
        # hooks run once per status-gossip round (and whenever a drill
        # pushes a round by hand): the flight recorder's disk/cluster
        # degradation watches live here (model/garage.py registers them)
        self.status_tick_hooks: List[Callable[[], None]] = []

        # node disk gauges, observed at scrape time (ref
        # rpc/system_metrics.rs:77 statvfs-fed data/meta avail gauges);
        # one statvfs sweep serves all four gauges per scrape, and an
        # UNKNOWN value raises so the sample is omitted (Gauge.render
        # swallows observer errors) rather than read as a full disk
        self._disk_cache: tuple = (0.0, {})

        def _disk(key):
            def observe():
                return float(self._disk_stats()[key])  # KeyError → omitted
            return observe

        self.metrics.gauge("cluster_local_data_avail_bytes",
                           "Free bytes on the data disk", fn=_disk("data_avail"))
        self.metrics.gauge("cluster_local_data_total_bytes",
                           "Size of the data disk", fn=_disk("data_total"))
        self.metrics.gauge("cluster_local_meta_avail_bytes",
                           "Free bytes on the metadata disk",
                           fn=_disk("meta_avail"))
        self.metrics.gauge("cluster_local_meta_total_bytes",
                           "Size of the metadata disk", fn=_disk("meta_total"))

        self._layout_persister: Persister = Persister(
            config.metadata_dir, "cluster_layout", ClusterLayout
        )
        loaded = self._layout_persister.load()
        self.layout: ClusterLayout = (
            loaded if loaded is not None
            else ClusterLayout(self.replication_mode.replication_factor)
        )
        self.ring = Ring(self.layout)
        self._ring_callbacks: List[Callable[[Ring], None]] = []
        # committed-layout topology cache, rebuilt with the ring: feeds
        # zone-aware request ordering and the write-quorum zone check
        self._zone_map: Dict[bytes, str] = self.layout.zone_map()
        self.rpc.set_zone_source(self.zone_of, self.our_zone)
        # zone-aware fail-slow baseline: a peer is judged against its
        # same-zone siblings when enough exist, so WAN distance (a
        # healthy zone two hops away) never reads as gray failure
        self.health_scorer.zone_of = lambda p: self._zone_map.get(bytes(p))
        # info-style join metric: peer → zone per the committed layout
        # (value always 1), so Grafana can aggregate peer_up /
        # peer_breaker_state by failure domain.  labeled_fn renders the
        # LIVE map — members removed from the layout drop out with it.
        self.metrics.gauge(
            "peer_zone_info",
            "Committed-layout zone per cluster member (constant 1; "
            "join key for per-zone aggregations)",
            labeled_fn=lambda: [
                ({"peer": bytes(nid).hex()[:16], "zone": z}, 1.0)
                for nid, z in self._zone_map.items()
            ],
        )

        self._peers_persister: Persister = Persister(
            config.metadata_dir, "peer_list", PersistedPeers
        )
        saved = self._peers_persister.load()
        if saved:
            for nid, addr in saved.peers:
                self.peering.add_peer(addr, FixedBytes32(nid))

        # set by BlockManager: () -> "ok"|"degraded"|"failed" (worst
        # data-root health, gossiped in NodeStatus so peers' `cluster
        # stats` show a remote node going read-only)
        self.disk_state_fn: Optional[Callable[[], str]] = None
        # set by Garage: () -> load-governor pressure in [0, 2], gossiped
        # in NodeStatus so gateways can shed at the front door on behalf
        # of a saturated storage node (cluster-aware admission)
        self.governor_pressure_fn: Optional[Callable[[], float]] = None
        # set by the API front door while gracefully draining:
        # None (serving) -> "draining" (shedding new, finishing
        # in-flight) -> "drained" (stopped).  Gossiped in NodeStatus so
        # sibling gateways absorb load before this node's socket closes
        self.drain_state: Optional[str] = None
        self.metrics.gauge(
            "gateway_drain_state",
            "Graceful-drain state of this node's API front door "
            "(0 serving, 1 draining, 2 drained)",
            fn=lambda: {None: 0.0, "draining": 1.0,
                        "drained": 2.0}.get(self.drain_state, 0.0))

        self.node_status: Dict[FixedBytes32, NodeStatus] = {}
        # when each peer's status last arrived (monotonic): gossiped
        # pressure EXPIRES — a node that advertised hot and then died
        # must not keep gateways shedding its buckets forever
        self._status_at: Dict[FixedBytes32, float] = {}
        # the gossiped pressure map, scrapeable at any node: which peers
        # currently advertise foreground saturation (feeds the Grafana
        # "gossiped pressure map" panel and the noisy-neighbor drill)
        self.metrics.gauge(
            "cluster_peer_pressure",
            "Last load-governor pressure each peer gossiped in its "
            "NodeStatus (0 idle, >= 1 saturated; stale gossip reads 0)",
            labeled_fn=lambda: [
                ({"peer": bytes(nid).hex()[:16]},
                 self.peer_pressure(nid))
                for nid, st in self.node_status.items()
                if st.governor_pressure is not None
            ],
        )
        self._discovery = None  # external (consul/k8s) backends, built lazily
        self._tasks: List[asyncio.Task] = []
        self._stopped = asyncio.Event()

        self.endpoint = self.netapp.endpoint(SYSTEM_ENDPOINT)
        self.endpoint.set_handler(self._handle)

    # --- ring watching ---

    def on_ring_change(self, cb: Callable[[Ring], None]):
        self._ring_callbacks.append(cb)

    def _rebuild_ring(self):
        old_members = set(self._zone_map)
        self.ring = Ring(self.layout)
        self._zone_map = self.layout.zone_map()
        # when partitions last moved (monotonic): repair paths use this
        # to decide whether an empty quorum read may be BLIND (new
        # replicas not yet synced) and worth a cluster sweep — see
        # model/parity_repair._sweep_index_entries
        self.ring_changed_at = time.monotonic()
        # peers REMOVED from the committed layout are gone for good:
        # drop their peer-book entries, breaker state and per-peer
        # metric series, or `peer_up`/`peer_rtt_ewma_seconds`/
        # `peer_breaker_state` keep reporting a node that no longer
        # exists (and its breaker would greet a re-added node with
        # stale failure history)
        for nid in old_members - set(self._zone_map):
            fb = FixedBytes32(nid)
            if fb == self.id:
                continue
            self.peering.forget_peer(fb)
            self.netapp.forget_peer_series(fb)
            self.node_status.pop(fb, None)
            self._status_at.pop(fb, None)
            # scorer digests + fail-slow verdict go with the peer (a
            # re-added node inherits no slowness history), and the
            # merged view drops its series on the next rebuild
            self.health_scorer.forget(nid)
            self._health_view_cache = (-1e9, {})
        for cb in self._ring_callbacks:
            try:
                cb(self.ring)
            except Exception:
                logger.exception("ring-change callback failed")

    # --- topology (zone failure domains; docs/ROBUSTNESS.md) ---

    def zone_of(self, node) -> Optional[str]:
        """Zone of a node per the COMMITTED layout (None when the node
        carries no role — e.g. a pure gateway client)."""
        return self._zone_map.get(bytes(node))

    def our_zone(self) -> Optional[str]:
        return self._zone_map.get(bytes(self.id))

    def write_zone_requirement(self, nodes) -> int:
        """How many distinct zones a write to `nodes` must span: the
        layout's HARD (integer) zone_redundancy, capped at the zones the
        candidate set can actually reach — so the check can always be
        satisfied when every candidate acks, and a dark zone surfaces as
        the typed ZoneQuorumError instead of an impossible bar.  0 under
        "maximum" (availability-first) or when topology is unknown."""
        hard = self.layout.hard_zone_redundancy()
        if not hard or hard <= 1:
            return 0
        zones = {self._zone_map[bytes(n)] for n in nodes
                 if bytes(n) in self._zone_map}
        if not zones:
            return 0
        return min(hard, len(zones))

    # --- layout operations ---

    async def update_cluster_layout(self, other: ClusterLayout):
        """CRDT-merge a layout received from a peer or the CLI; on change,
        persist, rebuild ring, and push to peers
        (ref system.rs:652-701 handle_advertise_cluster_layout)."""
        changed = self.layout.merge(other)
        if changed:
            self._layout_persister.save(self.layout)
            self._rebuild_ring()
            await self._push_layout()

    async def _push_layout(self):
        msg = {"t": "advertise_layout", "layout": self.layout.encode()}
        await self.rpc.broadcast(self.endpoint, msg, prio=PRIO_HIGH, timeout=10.0)

    def save_layout(self):
        """Persist the current (possibly staged) layout (admin path)."""
        self._layout_persister.save(self.layout)

    async def broadcast_layout(self):
        await self._push_layout()

    # --- status gossip ---

    def _local_status(self) -> NodeStatus:
        st = NodeStatus(
            hostname=socket.gethostname(),
            replication_factor=self.replication_mode.replication_factor,
            layout_version=self.layout.version,
            layout_staging_hash=bytes(self.layout.staging_hash()),
            version=self.version,
        )
        disk = self._disk_stats()
        st.meta_avail = disk.get("meta_avail")
        st.meta_total = disk.get("meta_total")
        st.data_avail = disk.get("data_avail")
        st.data_total = disk.get("data_total")
        if self.disk_state_fn is not None:
            try:
                st.disk_state = self.disk_state_fn()
            except Exception:  # noqa: BLE001 — gossip must never break
                logger.exception("disk_state_fn failed")
        if self.governor_pressure_fn is not None:
            try:
                st.governor_pressure = round(
                    float(self.governor_pressure_fn()), 4)
            except Exception:  # noqa: BLE001 — gossip must never break
                logger.exception("governor_pressure_fn failed")
        try:
            scores = self.health_scorer.scores()
            if scores:
                st.health_scores = {
                    p: v["score"] for p, v in scores.items()
                    if v["score"] is not None
                }
                st.fail_slow = [
                    p for p, v in scores.items() if v["fail_slow"]
                ]
        except Exception:  # noqa: BLE001 — gossip must never break
            logger.exception("health scorer snapshot failed")
        st.drain = self.drain_state
        return st

    def _disk_stats(self) -> dict:
        """statvfs snapshot shared by the Prometheus gauges AND the
        gossiped NodeStatus (one implementation — they must not diverge),
        cached briefly so one scrape's four gauges do a single sweep.
        Multi-data-dir nodes sum avail/total across DISTINCT filesystems
        (ref rpc/system.rs update_disk_usage dedups by fsid).  Missing
        keys mean 'unknown' — gauge observers let the KeyError propagate
        so the sample is omitted."""
        now = time.monotonic()
        ts, vals = self._disk_cache
        if vals and now - ts < 1.0:
            return vals
        vals = {}
        try:
            sv = os.statvfs(self.config.metadata_dir)
            vals["meta_avail"] = sv.f_bavail * sv.f_frsize
            vals["meta_total"] = sv.f_blocks * sv.f_frsize
        except OSError:
            pass
        if self.config.data_dir:
            avail = total = 0
            seen_fs = set()
            ok = False
            for d in self.config.data_dir:
                try:
                    sv = os.statvfs(d["path"])
                except OSError:
                    continue
                ok = True
                if sv.f_fsid in seen_fs:
                    continue  # same filesystem mounted twice: count once
                seen_fs.add(sv.f_fsid)
                avail += sv.f_bavail * sv.f_frsize
                total += sv.f_blocks * sv.f_frsize
            if ok:
                vals["data_avail"] = avail
                vals["data_total"] = total
        self._disk_cache = (now, vals)
        return vals

    def _peer_book(self) -> list:
        """[(id, addr)] of every dialable peer this node knows, plus
        itself — the payload of peer-list gossip."""
        out = []
        my_addr = self.config.rpc_public_addr
        if my_addr:
            out.append([bytes(self.id), my_addr])
        for nid, (addr, _up, _lat) in self.peering.peer_info().items():
            if addr:
                out.append([bytes(nid), addr])
        return out

    async def advertise_status(self):
        """One status-gossip round: broadcast our NodeStatus (disk
        health, governor pressure, layout version) plus the peer book.
        The exchange loop calls this on its interval; drills/tests call
        it directly to push fresh pressure without waiting 10 s."""
        # Peer-list gossip rides the status broadcast: an operator
        # who runs `connect` against ONE node (the star bootstrap
        # every real deployment starts as) must converge to a full
        # mesh — without address exchange, nodes only ever know
        # the peers someone explicitly dialed for them, and a
        # partition heals only by operator action (observed: star
        # survivors couldn't reach table quorums after node loss).
        # ref: netapp's FullMeshPeeringStrategy PeerList exchange.
        # Status-tick hooks first (flight-recorder degradation watches,
        # registered by model/garage.py): they observe state transitions
        # on the gossip cadence, and a drill pushing a round by hand
        # evaluates them immediately
        for hook in self.status_tick_hooks:
            try:
                hook()
            except Exception:  # noqa: BLE001 — watches never break gossip
                logger.exception("status tick hook failed")
        msg = {
            "t": "advertise_status",
            "status": self._local_status().pack(),
            "peers": self._peer_book(),
        }
        await self.rpc.broadcast(self.endpoint, msg, prio=PRIO_HIGH,
                                 timeout=10.0)

    async def _status_exchange_loop(self):
        while not self._stopped.is_set():
            try:
                await self.advertise_status()
            except Exception as e:
                logger.debug("status exchange failed: %s", e)
            await asyncio.sleep(STATUS_EXCHANGE_INTERVAL)

    def _external_discovery(self):
        """Lazily construct the configured external discovery backends
        (ref system.rs:336-360: consul/kubernetes are optional features)."""
        if self._discovery is None:
            self._discovery = []
            if self.config.consul_discovery is not None:
                from .discovery import ConsulDiscovery

                self._discovery.append(
                    ConsulDiscovery(self.config.consul_discovery)
                )
            if self.config.kubernetes_discovery is not None:
                try:
                    from .discovery import KubernetesDiscovery

                    k8s = KubernetesDiscovery(
                        self.config.kubernetes_discovery
                    )
                    self._k8s_crd_pending = not (
                        self.config.kubernetes_discovery.skip_crd
                    )
                    self._discovery.append(k8s)
                except Exception as e:  # not in a pod: log once, disable
                    logger.warning("kubernetes discovery disabled: %s", e)
        return self._discovery

    async def _external_discovery_tick(self):
        """Publish ourselves + learn peers from Consul/Kubernetes (ref
        system.rs:726-808: runs every discovery tick, errors only warn)."""
        public = self.config.rpc_public_addr
        for d in self._external_discovery():
            # publish and query fail independently (ref system.rs:726-808):
            # a node with a read-only catalog token must still learn peers
            try:
                if getattr(self, "_k8s_crd_pending", False) and hasattr(
                    d, "ensure_crd"
                ):
                    await d.ensure_crd()
                    self._k8s_crd_pending = False
                if public:
                    await d.publish(
                        bytes(self.id), socket.gethostname(), public
                    )
            except Exception as e:
                logger.warning("discovery publish via %s failed: %s",
                               type(d).__name__, e)
            try:
                for node_id, addr in await d.get_nodes():
                    if node_id != bytes(self.id):
                        self.peering.add_peer(addr, FixedBytes32(node_id))
            except Exception as e:
                logger.warning("discovery query via %s failed: %s",
                               type(d).__name__, e)

    async def _discovery_loop(self):
        while not self._stopped.is_set():
            for addr in self.config.bootstrap_peers:
                self.peering.add_peer(addr)
            await self._external_discovery_tick()
            await self.peering._tick()
            # persist known peers for next restart
            peers = [
                [bytes(nid), st.addr]
                for nid, st in self.peering.peers.items()
                if st.addr
            ]
            try:
                self._peers_persister.save(PersistedPeers(peers))
            except OSError as e:
                logger.debug("peer list save failed: %s", e)
            # pull layout from a peer if ours is older than advertised
            await asyncio.sleep(DISCOVERY_INTERVAL)

    # --- rpc handler ---

    async def _handle(self, remote, msg, body):
        t = msg.get("t")
        if t == "pull_layout":
            return {"layout": self.layout.encode()}, None
        if t == "advertise_layout":
            other = ClusterLayout.decode(bytes(msg["layout"]))
            await self.update_cluster_layout(other)
            return {"ok": True}, None
        if t == "advertise_status":
            st = NodeStatus.unpack(msg["status"])
            prev = self.node_status.get(FixedBytes32(remote))
            self.node_status[FixedBytes32(remote)] = st
            self._status_at[FixedBytes32(remote)] = time.monotonic()
            # fresh gossip may carry new fail-slow verdicts: rebuild
            # the merged health view on the next read (drills assert
            # flag propagation within a bounded number of exchanges).
            # Only when the health fields actually CHANGED — at fleet
            # scale every node receives N-1 statuses per interval, and
            # unconditionally nuking the ~1 s cache would make
            # peer_rank re-score per gossip message
            if (prev is None
                    or prev.health_scores != st.health_scores
                    or prev.fail_slow != st.fail_slow):
                self._health_view_cache = (-1e9, {})
            # a peer with a newer layout triggers a pull
            if st.layout_version > self.layout.version:
                asyncio.get_running_loop().create_task(self._pull_layout(remote))
            # peer-list gossip: learn every (id, addr) the sender knows;
            # the peering tick dials the ones we aren't connected to
            for pair in msg.get("peers", []) or []:
                try:
                    nid, addr = bytes(pair[0]), str(pair[1])
                    if len(nid) == 32 and nid != bytes(self.id):
                        self.peering.add_peer(addr, FixedBytes32(nid))
                except Exception:  # noqa: BLE001 — gossip is best-effort
                    continue
            return {"ok": True}, None
        if t == "ping":
            return {"pong": True, "id": bytes(self.id)}, None
        raise ValueError(f"unknown system message {t!r}")

    async def _pull_layout(self, node):
        try:
            resp = await self.endpoint.call(
                FixedBytes32(node), {"t": "pull_layout"}, prio=PRIO_HIGH, timeout=10.0
            )
            await self.update_cluster_layout(
                ClusterLayout.decode(bytes(resp["layout"]))
            )
        except Exception as e:
            logger.debug("layout pull from %s failed: %s", bytes(node).hex()[:8], e)

    # --- health (ref system.rs:468-527) ---

    def health(self) -> ClusterHealth:
        roles = self.layout.node_roles()
        storage_nodes = [
            nid for nid, r in roles.items() if r.capacity is not None
        ]
        storage_ok = [n for n in storage_nodes if self.peering.is_up(FixedBytes32(n))]
        partitions = N_PARTITIONS if self.ring.ready else 0
        quorum = self.replication_mode.write_quorum
        p_quorum = p_all = 0
        for p in range(partitions):
            nodes = self.ring.partition_nodes(p)
            up = sum(1 for n in nodes if self.peering.is_up(n))
            if up == len(nodes):
                p_all += 1
            if up >= quorum:
                p_quorum += 1
        if partitions and p_quorum == partitions and len(storage_ok) == len(storage_nodes):
            status = "healthy"
        elif partitions and p_quorum == partitions:
            status = "degraded"
        else:
            status = "unavailable"
        return ClusterHealth(
            status=status,
            known_nodes=len(self.peering.peers) + 1,
            connected_nodes=len(self.peering.connected_nodes()) + 1,
            storage_nodes=len(storage_nodes),
            storage_nodes_ok=len(storage_ok),
            partitions=partitions,
            partitions_quorum=p_quorum,
            partitions_all_ok=p_all,
        )

    def peer_version(self, nid) -> Optional[str]:
        """Software version `nid` last gossiped (status exchange), ours
        for self, None when unknown — the capability gate mixed-version
        rollouts key on (e.g. block/repair_plan.py sends the `ppr`
        partial-product RPC only to peers new enough to answer it, and
        falls back to whole-shard fetch otherwise)."""
        if bytes(nid) == bytes(self.id):
            return self.version
        st = self.node_status.get(FixedBytes32(bytes(nid)))
        return st.version if st is not None else None

    # gossiped pressure older than this reads as 0: a hot node that
    # crashed (or partitioned away) must stop shedding its buckets at
    # every gateway within a few missed exchange rounds
    PRESSURE_TTL = 3 * STATUS_EXCHANGE_INTERVAL

    def peer_pressure(self, nid) -> float:
        """Load-governor pressure `nid` last gossiped (0.0 when unknown
        or STALE — a silent peer is not presumed hot, and a dead one
        must not stay hot forever).  Cluster-aware admission folds the
        max over a request's placement nodes into the admit decision
        (api/admission.py RemotePressureProbe); the degraded-read
        planner can rank survivors by the same signal."""
        if bytes(nid) == bytes(self.id):
            if self.governor_pressure_fn is not None:
                try:
                    return float(self.governor_pressure_fn())
                except Exception:  # noqa: BLE001
                    return 0.0
            return 0.0
        fb = FixedBytes32(bytes(nid))
        st = self.node_status.get(fb)
        if st is None or st.governor_pressure is None:
            return 0.0
        at = self._status_at.get(fb)
        if at is None or time.monotonic() - at > self.PRESSURE_TTL:
            return 0.0
        return float(st.governor_pressure)

    def peer_status_due_in(self, nid) -> float:
        """Seconds until `nid`'s next status exchange is due, the soonest
        its gossiped pressure can change; 0 when unknown or overdue."""
        at = self._status_at.get(FixedBytes32(bytes(nid)))
        if at is None:
            return 0.0
        return max(0.0, at + STATUS_EXCHANGE_INTERVAL - time.monotonic())

    # --- fleet health (fail-slow detection; utils/health_score.py) ---

    def _health_note(self, node, cls: str, seconds: float) -> None:
        """Per-peer service-time tap (RpcHelper call outcomes + peering
        ping RTTs).  DURABLE peers only: a throwaway CLI connection must
        not grow scorer digests or `peer_health_score` series."""
        st = self.peering.peers.get(FixedBytes32(bytes(node)))
        if st is None or st.addr is None:
            return
        try:
            self.health_scorer.note(bytes(node), cls, seconds)
        except Exception:  # noqa: BLE001 — scoring never breaks calls
            logger.debug("health note failed", exc_info=True)

    def _health_view(self) -> Dict[str, list]:
        """{peer hex16: [score, flagged]} — the LOCAL scorer's verdicts
        merged with every fresh gossiped report (max score wins; any
        fresh reporter's flag flags).  Gossip staleness uses the same
        TTL as pressure: a reporter that died must not keep a peer
        demoted forever.  Cached ~1 s — peer_rank consults this per
        candidate."""
        now = time.monotonic()
        ts, view = self._health_view_cache
        if now - ts < 1.0:
            return view
        view = {}
        try:
            for p, v in self.health_scorer.scores().items():
                view[p] = [v["score"] if v["score"] is not None else 0.0,
                           bool(v["fail_slow"])]
        except Exception:  # noqa: BLE001
            logger.debug("health scorer read failed", exc_info=True)
        me = bytes(self.id).hex()[:16]
        for nid, st in self.node_status.items():
            at = self._status_at.get(nid)
            if at is None or now - at > self.PRESSURE_TTL:
                continue
            for p, s in (st.health_scores or {}).items():
                if p == me:
                    continue  # peers' view of US never demotes a third
                cur = view.setdefault(p, [0.0, False])
                if s is not None and float(s) > cur[0]:
                    cur[0] = float(s)
            for p in (st.fail_slow or []):
                if p == me:
                    continue
                view.setdefault(p, [0.0, False])[1] = True
        self._health_view_cache = (now, view)
        return view

    def peer_core_row(self, nid, st) -> dict:
        """The shared per-peer health core — admin ``cluster stats``
        rows and the flight recorder's ``peers`` section both build on
        it, so a new gossiped field lands in both views at once.
        ``st`` is the peering PeerState for ``nid``."""
        status = self.node_status.get(nid)
        return {
            "id": bytes(nid).hex(),
            "zone": self.zone_of(nid),
            "up": st.is_up,
            "rtt_ewma_ms": (round(st.latency * 1000.0, 3)
                            if st.latency is not None else None),
            "breaker": self.peering.breaker_state(nid),
            "pressure": self.peer_pressure(nid),
            "health_score": self.peer_health_score(nid),
            "fail_slow": self.peer_fail_slow(nid),
            "disk_state": status.disk_state if status else None,
            "version": (self.netapp.peer_versions.get(nid)
                        or (status.version if status else None)),
            "drain": status.drain if status else None,
        }

    def peer_health_score(self, nid) -> Optional[float]:
        """Merged comparative health score for `nid` (None = nobody can
        judge it yet)."""
        v = self._health_view().get(bytes(nid).hex()[:16])
        return v[0] if v is not None else None

    def peer_fail_slow(self, nid) -> bool:
        """Is `nid` fail-slow, per the local scorer OR any fresh
        gossiped reporter?  Consumed by RpcHelper.peer_rank (read
        ordering) and through it by RepairPlanner survivor ranking —
        demotion only, never exclusion: a flagged peer still serves
        when the healthy candidates are exhausted."""
        if bytes(nid) == bytes(self.id):
            return False
        v = self._health_view().get(bytes(nid).hex()[:16])
        return bool(v is not None and v[1])

    def get_known_nodes(self) -> List[dict]:
        """Peer list for status displays (ids as hex, JSON-safe)."""
        out = [{
            "id": bytes(self.id).hex(),
            "addr": self.config.rpc_public_addr or self.config.rpc_bind_addr,
            "is_up": True,
            "last_seen_secs_ago": 0,
            "hostname": self._local_status().hostname,
        }]
        now = time.monotonic()
        for nid, st in self.peering.peers.items():
            status = self.node_status.get(nid)
            out.append({
                "id": bytes(nid).hex(),
                "addr": st.addr,
                "is_up": st.is_up,
                "last_seen_secs_ago": (
                    int(now - st.last_seen) if st.last_seen else None
                ),
                "hostname": status.hostname if status else None,
            })
        return out

    # --- lifecycle (ref system.rs:391-400) ---

    async def run(self):
        await self.netapp.listen(self.config.rpc_bind_addr)
        self.peering.start()
        self.tracer.start()  # flush loop; no-op unless trace_sink configured
        loop = asyncio.get_running_loop()
        self._tasks = [
            loop.create_task(self._status_exchange_loop()),
            loop.create_task(self._discovery_loop()),
        ]

    async def shutdown(self):
        self._stopped.set()
        # drain quorum-write stragglers / cancelled read losers while the
        # transport is still alive (they are talking through it)
        await self.rpc.shutdown(timeout=5.0)
        for t in self._tasks:
            t.cancel()
        for d in (self._discovery or []):
            try:
                await d.close()
            except Exception:
                pass
        await self.peering.stop()
        await self.netapp.shutdown()
