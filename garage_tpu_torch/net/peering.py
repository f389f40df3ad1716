"""Full-mesh peering: keep a connection to every known peer, ping for
latency, expose liveness.

Equivalent of netapp's FullMeshPeeringStrategy (ref rpc/system.rs:329-332):
the latency estimates feed RpcHelper's request ordering
(ref rpc/rpc_helper.rs:392-435) and the ping liveness feeds `is_up`
(ref rpc/system.rs:405-426).
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Set, Tuple

from .netapp import NetApp, NodeID
from .resilience import BREAKER_STATE_VALUES, CircuitBreaker, ResilienceTunables

logger = logging.getLogger("garage_tpu_torch.net.peering")

PING_INTERVAL = 15.0
RECONNECT_BASE = 2.0
RECONNECT_MAX = 60.0
EWMA_ALPHA = 0.3


@dataclass
class PeerState:
    addr: Optional[str] = None
    latency: Optional[float] = None       # EWMA RTT seconds
    last_seen: Optional[float] = None     # monotonic, last successful ping
    failures: int = 0                     # consecutive connect/ping failures
    reconnects: int = 0                   # successful re-establishments
    ping_failures: int = 0                # lifetime failed pings/dials
    addrs_tried: Set[str] = field(default_factory=set)

    @property
    def is_up(self) -> bool:
        return self.last_seen is not None and (
            time.monotonic() - self.last_seen < 2.5 * PING_INTERVAL
        )


class FullMeshPeering:
    """Dial every known peer, keep latency estimates fresh.

    `known_peers` accumulates from bootstrap config, the persisted peer
    list, and layout gossip (the rpc System layer feeds those in via
    `add_peer`)."""

    def __init__(self, netapp: NetApp, metrics=None,
                 tunables: Optional[ResilienceTunables] = None):
        self.netapp = netapp
        self.tunables = tunables or ResilienceTunables()
        # per-peer circuit breakers (closed → open on failure streak /
        # RTT blowup → half-open probe on timer).  Fed by the ping loop
        # here AND by data-plane call outcomes via RpcHelper; consulted
        # by request_order (broken peers sort last) and by every call
        # gate (fast-fail instead of burning a timeout).
        self.breakers: Dict[NodeID, CircuitBreaker] = {}
        self.peers: Dict[NodeID, PeerState] = {}
        self._addr_only: Set[str] = set()   # peers known only by address
        self._task: Optional[asyncio.Task] = None
        self._stopped = asyncio.Event()
        # optional per-ping RTT tap (set by System): successful ping
        # RTTs feed the fail-slow scorer's "ping" endpoint class, so a
        # peer with NO data-plane traffic toward us is still judgeable
        # against its siblings (utils/health_score.py)
        self.rtt_note: Optional[Callable[[NodeID, float], None]] = None
        netapp.on_connected = self._on_connected
        netapp.on_disconnected = self._on_disconnected
        # per-peer health instruments: RTT EWMA / liveness / failure
        # streak are mirrored into gauges at scrape (observe_gauges);
        # reconnects and ping failures are counted at event time
        if metrics is not None:
            self._m = {
                "rtt": metrics.gauge(
                    "peer_rtt_ewma_seconds",
                    "Smoothed ping round-trip time per peer"),
                "up": metrics.gauge(
                    "peer_up", "1 when the peer answers pings"),
                "failures": metrics.gauge(
                    "peer_consecutive_failures",
                    "Consecutive failed dials/pings per peer"),
                "reconnect": metrics.counter(
                    "peer_reconnect_total",
                    "Connection re-establishments per peer"),
                "ping_fail": metrics.counter(
                    "peer_ping_failure_total",
                    "Failed pings/dials per peer"),
                "breaker": metrics.gauge(
                    "peer_breaker_state",
                    "Circuit breaker state per peer "
                    "(0=closed, 1=half_open, 2=open)"),
            }
        else:
            self._m = None

    @staticmethod
    def _label(node: NodeID) -> str:
        return bytes(node).hex()[:16]

    def observe_gauges(self) -> None:
        """Refresh the per-peer gauges from PeerState (called at scrape
        time by the admin /metrics handler).  Clear-then-set so forgotten
        peers drop out instead of freezing at their last value."""
        if self._m is None:
            return
        for g in ("rtt", "up", "failures", "breaker"):
            self._m[g].clear()
        for nid, st in self.peers.items():
            lbl = self._label(nid)
            if st.latency is not None:
                self._m["rtt"].set(st.latency, peer=lbl)
            self._m["up"].set(1.0 if st.is_up else 0.0, peer=lbl)
            self._m["failures"].set(float(st.failures), peer=lbl)
            self._m["breaker"].set(
                BREAKER_STATE_VALUES[self.breaker_state(nid)], peer=lbl)

    # --- peer book ---

    def add_peer(self, addr: str, node_id: Optional[NodeID] = None):
        if node_id is None:
            self._addr_only.add(addr)
            return
        if node_id == self.netapp.id:
            return
        st = self.peers.setdefault(node_id, PeerState())
        if addr:
            st.addr = addr

    def latency(self, node: NodeID) -> Optional[float]:
        st = self.peers.get(node)
        return st.latency if st else None

    def forget_peer(self, node: NodeID) -> None:
        """Drop a peer removed from the committed layout: peer-book
        entry (so the scrape-time gauge refresh stops emitting its
        series), breaker state (a re-added node must not inherit stale
        failure history), and the event-time counter series.  The live
        connection, if any, is left to die naturally — the peer may
        still be draining its own goodbye traffic."""
        self.peers.pop(node, None)
        self.breakers.pop(node, None)
        if self._m is not None:
            lbl = self._label(node)
            self._m["reconnect"].drop_label("peer", lbl)
            self._m["ping_fail"].drop_label("peer", lbl)

    # --- circuit breaker surface (consulted by RpcHelper) ---

    def breaker(self, node: NodeID) -> CircuitBreaker:
        br = self.breakers.get(node)
        if br is None:
            br = self.breakers[node] = CircuitBreaker(self.tunables)
        return br

    def breaker_state(self, node: NodeID) -> str:
        br = self.breakers.get(node)
        return br.state_now() if br is not None else "closed"

    def breaker_allows(self, node: NodeID) -> bool:
        """Request gate: may a call be dispatched to this peer right now?
        Consumes the half-open probe slot when it grants one — report the
        outcome via record_rpc_success/record_rpc_failure (or
        breaker_release if abandoned)."""
        return self.breaker(node).allow()

    def breaker_release(self, node: NodeID) -> None:
        br = self.breakers.get(node)
        if br is not None:
            br.release_probe()

    def record_rpc_success(self, node: NodeID) -> None:
        self.breaker(node).on_success()

    def record_rpc_failure(self, node: NodeID) -> None:
        self.breaker(node).on_failure()

    def is_up(self, node: NodeID) -> bool:
        if node == self.netapp.id:
            return True
        st = self.peers.get(node)
        return bool(st and st.is_up)

    def connected_nodes(self) -> Set[NodeID]:
        return set(self.netapp.conns.keys())

    def peer_info(self) -> Dict[NodeID, Tuple[Optional[str], bool, Optional[float]]]:
        return {
            nid: (st.addr, st.is_up, st.latency) for nid, st in self.peers.items()
        }

    # --- lifecycle ---

    def start(self):
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self):
        self._stopped.set()
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    def _on_connected(self, node: NodeID, is_dialer: bool):
        # a completed handshake is bidirectional proof of life: an open
        # breaker (peer crashed / was partitioned) closes immediately
        # instead of waiting out its half-open probe timer
        self.breaker(node).on_success()
        st = self.peers.setdefault(node, PeerState())
        if st.last_seen is not None:
            # not the first contact: this is a RE-connection — the churn
            # counter operators alert on (flapping link, crash-looping
            # peer)
            st.reconnects += 1
            if self._m is not None:
                self._m["reconnect"].inc(peer=self._label(node))
        st.failures = 0
        st.last_seen = time.monotonic()
        logger.debug("connected to %s", node.hex_short())

    def _on_disconnected(self, node: NodeID):
        logger.debug("disconnected from %s", node.hex_short())
        # an inbound peer we know no address for (e.g. a CLI client with a
        # temp keypair) can never be redialed — forget it so transient
        # connections don't accumulate in the peer book / health counts
        st = self.peers.get(node)
        if st is not None and st.addr is None:
            del self.peers[node]
            self.breakers.pop(node, None)

    async def _run(self):
        """Main loop: every PING_INTERVAL, (re)dial missing peers and ping
        connected ones.  Reconnect backoff is per-peer exponential."""
        while not self._stopped.is_set():
            await self._tick()
            await asyncio.sleep(PING_INTERVAL * random.uniform(0.8, 1.2))

    async def _tick(self):
        # resolve addr-only bootstrap peers by dialing them once
        for addr in list(self._addr_only):
            try:
                conn = await self.netapp.connect(addr)
                self._addr_only.discard(addr)
                self.add_peer(addr, conn.remote_id)
            except Exception as e:
                logger.debug("bootstrap dial %s failed: %s", addr, e)

        tasks = []
        for nid, st in list(self.peers.items()):
            conn = self.netapp.conns.get(nid)
            if conn is None or conn._closed:
                if st.addr and self._should_retry(st):
                    tasks.append(self._dial(nid, st))
            else:
                tasks.append(self._ping(nid, st, conn))
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)

    def _should_retry(self, st: PeerState) -> bool:
        if st.failures == 0 or st.last_seen is None:
            return True
        backoff = min(RECONNECT_BASE * (2 ** min(st.failures, 6)), RECONNECT_MAX)
        return time.monotonic() - st.last_seen > backoff

    async def _dial(self, nid: NodeID, st: PeerState):
        try:
            await self.netapp.connect(st.addr, expected_id=nid)
            st.failures = 0
        except Exception as e:
            st.failures += 1
            st.ping_failures += 1
            self.breaker(nid).on_failure()
            if self._m is not None:
                self._m["ping_fail"].inc(peer=self._label(nid))
            logger.debug("dial %s (%s) failed: %s", nid.hex_short(), st.addr, e)

    async def _ping(self, nid: NodeID, st: PeerState, conn):
        try:
            rtt = await conn.ping()
            st.last_seen = time.monotonic()
            if self.rtt_note is not None:
                try:
                    self.rtt_note(nid, rtt)
                except Exception:  # noqa: BLE001 — scoring never breaks pings
                    pass
            # breaker judges the fresh RTT against the PRE-ping EWMA: a
            # 10× blowup on an established baseline counts as a failure
            # even though the ping came back
            self.breaker(nid).on_rtt(rtt, st.latency)
            st.latency = (
                rtt if st.latency is None
                else EWMA_ALPHA * rtt + (1 - EWMA_ALPHA) * st.latency
            )
            st.failures = 0
        except Exception as e:
            st.failures += 1
            st.ping_failures += 1
            self.breaker(nid).on_failure()
            if self._m is not None:
                self._m["ping_fail"].inc(peer=self._label(nid))
            logger.debug("ping %s failed: %s", nid.hex_short(), e)
