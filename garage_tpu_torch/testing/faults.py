"""Reusable fault injector (SURVEY §5 aux subsystem).

The reference validates durability claims with cluster benchmarks under
"2 simulated node failures" (ref doc/book/design/benchmarks) but ships
no reusable rig; here the rig is in-tree: one object that can crash and
revive nodes of an in-process cluster and drop/corrupt chosen blocks on
disk, used by tests (generalizing the ad-hoc node kills in
tests/test_integration.py) and by bench.py's degraded-mode phase.

Crash semantics: `crash()` is abrupt — transport closed and workers
cancelled with NO graceful drains (a dying node doesn't flush its
write-time parity accumulator).  `revive()` rebuilds a Garage from the
same config/dirs, the crash-consistency path real restarts take —
meaningful only for persistent db engines (sqlite/native), not
"memory".

Network faults (the degraded-mode chaos rig; docs/ROBUSTNESS.md):
`add_network_faults()` interposes a ``FaultyLink`` — a LatencyProxy
subclass with mutable fault state — on every directed dial path i→j, so
a running cluster's links can then be degraded live:

  - latency spikes + jitter          set_latency / slow_peer
  - probabilistic connection resets  flaky_link
  - one-way partitions               partition_one_way (requests vanish,
                                     replies still flow — the asymmetric
                                     case gossip alone never detects)
  - hard partitions                  partition (refuse + kill)
  - blackholes                       blackhole_node (accept, never
                                     respond — only ADAPTIVE timeouts
                                     catch this; a static 60 s timeout
                                     burns in full per call)

Link (i, j) carries connections DIALED by i toward j; which link of a
pair serves the one shared TCP connection depends on who won the dial
race, so symmetric faults (latency, resets) are applied to both links of
the pair by the helpers.
"""

from __future__ import annotations

import asyncio
import errno
import logging
import os
import random
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

from ..block.health import DiskIo
from ..net.latency_proxy import LatencyProxy
from ..utils.data import Hash

logger = logging.getLogger("garage_tpu_torch.testing.faults")

# Fast-twitch [rpc] tunables for chaos drives: sub-second adaptive
# timeouts against loopback RTTs, quick retries, a 1 s breaker cooldown.
# SHARED by tests/test_net_faults.py and scripts/chaos.py so the pytest
# acceptance proof and the standalone script exercise the same regime —
# tune it here, both rigs follow.
FAST_CHAOS_RPC = {
    "adaptive_timeout_base": 1.0,
    "adaptive_timeout_min": 0.4,
    "retry_backoff_base": 0.02,
    "retry_backoff_max": 0.2,
    "breaker_failure_threshold": 3,
    "breaker_open_secs": 1.0,
    "block_rpc_timeout": 20.0,
}

# Fast-twitch [health] tunables for the fail_slow drill (and any test
# that wants flag transitions inside seconds instead of the production
# 30 s sustained window): factor/hysteresis are the PRODUCTION values —
# only the time constants and sample floors shrink, so the drill proves
# the same comparative logic the fleet runs.
FAST_CHAOS_HEALTH = {
    "fail_slow_factor": 3.0,
    "clear_factor": 1.5,
    "window_s": 0.4,
    "min_samples": 4,
    "min_baseline_peers": 1,
    "sample_ttl_s": 60.0,
}

# The canonical geo-WAN profile: a symmetric 3-zone RTT
# matrix — z1↔z2 a metro pair, z1↔z3 cross-country, z2↔z3 the long
# diagonal.  Values are full round trips in SECONDS; the injector
# applies rtt/2 one-way per boundary link.  SHARED by the wan chaos
# phase, bench --replay-phase, and the WAN-matrix unit tests.
WAN_3ZONE_RTT = {
    ("z1", "z2"): 0.020,
    ("z1", "z3"): 0.080,
    ("z2", "z3"): 0.150,
}


class FaultyLink(LatencyProxy):
    """One directed network path with live-tunable faults.  All knobs are
    plain attributes read per-chunk/per-accept, so tests flip them while
    traffic is flowing."""

    def __init__(self, target_host: str, target_port: int,
                 rng: Optional[random.Random] = None):
        super().__init__(target_host, target_port, 0.0, 0.0)
        self.refuse = False           # hard partition: refuse new conns
        self.blackhole = False        # accept, forward nothing either way
        self.drop: set = set()        # {'tx','rx'} silently dropped
        self.reset_prob = 0.0         # P(connection aborted after accept)
        self.reset_delay = (0.02, 0.3)
        # go dark MID-TRANSFER: after this many total forwarded bytes the
        # link turns into a blackhole (the case a response-header timeout
        # cannot catch — only per-chunk inactivity deadlines do)
        self.blackhole_after_bytes: Optional[int] = None
        self._forwarded = 0
        self._rng = rng or random.Random()

    def clear(self) -> None:
        """Back to a clean, zero-latency link."""
        self.refuse = False
        self.blackhole = False
        self.drop = set()
        self.reset_prob = 0.0
        self.blackhole_after_bytes = None
        self._forwarded = 0
        self.delay = 0.0
        self.jitter = 0.0

    def _on_accept(self, reader, writer) -> bool:
        if self.refuse:
            return False
        if self.reset_prob and self._rng.random() < self.reset_prob:
            # accepted, then reset shortly after — the classic flaky
            # middlebox; in-flight RPCs on the conn fail all at once
            asyncio.get_running_loop().call_later(
                self._rng.uniform(*self.reset_delay), writer.close)
        return True

    def _filter(self, direction: str, data: bytes) -> Optional[bytes]:
        if self.blackhole_after_bytes is not None:
            self._forwarded += len(data)
            if self._forwarded > self.blackhole_after_bytes:
                self.blackhole = True
        if self.blackhole or direction in self.drop:
            return None
        return data


class SimulatedCrash(RuntimeError):
    """The process 'died' mid-write: NOT an OSError, so the write path
    neither converts it to a typed StorageError nor feeds the disk
    breaker — exactly like a real kill, the call just never returns.
    The on-disk state at raise time (torn tmp, unrenamed tmp) is what
    the startup janitor must clean up."""


class FaultyDisk(DiskIo):
    """Storage faults at BlockManager's filesystem boundary.  Wraps a
    manager's ``DiskIo`` (``mgr.disk = FaultyDisk(mgr.disk)``) so faults
    inject at exactly the seam the real kernel would error through — no
    os.* monkeypatching, per-node scoping for free.  All knobs are plain
    attributes read per-op, so tests flip them while traffic flows:

      - ``read_errno`` / ``write_errno`` (+ ``*_error_prob``): EIO on
        read, ENOSPC/EIO on write
      - ``fsync_errno``: the write lands, durability doesn't
      - ``crash_stage`` ∈ {tmp, rename, fsync}: SimulatedCrash at that
        write stage, leaving the torn on-disk state a real kill would
        (``torn_fraction`` of the tmp bytes for stage "tmp")
      - ``bitrot_prob``: silent single-byte corruption on read (the
        verify/scrub path must catch it by content hash)
      - ``latency``: per-op sleep (a dying disk is slow before it is
        dead); applied in the worker thread, never on the event loop
      - ``statvfs_free``: synthetic free-bytes override — drives the
        watermark state machine without actually filling a filesystem

    ``path_prefix`` scopes every fault to one data root (multi-root
    nodes degrade per root, not per node)."""

    def __init__(self, inner: Optional[DiskIo] = None,
                 rng: Optional[random.Random] = None,
                 path_prefix: Optional[str] = None):
        self.inner = inner or DiskIo()
        self._rng = rng or random.Random()
        self.path_prefix = path_prefix
        self.clear()

    def clear(self) -> None:
        """Back to a clean pass-through disk."""
        self.read_errno: Optional[int] = None
        self.read_error_prob = 1.0
        self.write_errno: Optional[int] = None
        self.write_error_prob = 1.0
        self.fsync_errno: Optional[int] = None
        self.bitrot_prob = 0.0
        self.latency = 0.0
        self.crash_stage: Optional[str] = None
        self.torn_fraction = 0.5
        self.statvfs_free: Optional[int] = None
        self.injected = {"read": 0, "write": 0, "fsync": 0,
                         "bitrot": 0, "crash": 0}

    def _applies(self, path: str) -> bool:
        return self.path_prefix is None or path.startswith(self.path_prefix)

    def _err(self, kind: str, eno: int, path: str) -> OSError:
        self.injected[kind] += 1
        return OSError(eno, os.strerror(eno), path)

    def read_file(self, path: str) -> bytes:
        return self._faulted_read(path, self.inner.read_file)

    def read_file_direct(self, path: str) -> bytes:
        # the scrub worker's O_DIRECT flavor: same fault surface as
        # read_file — a dying disk errors scrubs and GETs alike
        return self._faulted_read(path, self.inner.read_file_direct)

    def _faulted_read(self, path: str, read) -> bytes:
        if self._applies(path):
            if self.latency:
                time.sleep(self.latency)
            if (self.read_errno is not None
                    and self._rng.random() < self.read_error_prob):
                raise self._err("read", self.read_errno, path)
        data = read(path)
        if (self._applies(path) and data
                and self._rng.random() < self.bitrot_prob):
            i = self._rng.randrange(len(data))
            data = data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]
            self.injected["bitrot"] += 1
        return data

    def write_file(self, path: str, data: bytes, fsync: bool = False) -> None:
        if self._applies(path):
            if self.latency:
                time.sleep(self.latency)
            if self.crash_stage == "tmp":
                # torn write: a prefix reaches the media, then the
                # "process" dies before finishing — never acknowledged
                self.injected["crash"] += 1
                with open(path, "wb") as f:
                    f.write(data[:int(len(data) * self.torn_fraction)])
                raise SimulatedCrash(f"kill mid tmp-write of {path}")
            if (self.write_errno is not None
                    and self._rng.random() < self.write_error_prob):
                raise self._err("write", self.write_errno, path)
            if fsync and self.fsync_errno is not None:
                # the data write succeeded; only durability failed —
                # the kernel reports that exactly once, at fsync
                self.inner.write_file(path, data, fsync=False)
                raise self._err("fsync", self.fsync_errno, path)
        return self.inner.write_file(path, data, fsync=fsync)

    def replace(self, src: str, dst: str) -> None:
        if self._applies(dst) and self.crash_stage == "rename":
            # died between tmp write and rename: a COMPLETE tmp file
            # orphaned next to a missing final — still unacknowledged
            self.injected["crash"] += 1
            raise SimulatedCrash(f"kill before rename {src} -> {dst}")
        return self.inner.replace(src, dst)

    def remove(self, path: str) -> None:
        return self.inner.remove(path)

    def fsync_dir(self, path: str) -> None:
        if self._applies(path):
            if self.crash_stage == "fsync":
                # died at the directory fsync: write + rename landed, the
                # PUT was NOT acked — the surviving block is a harmless
                # duplicate-to-be, never a loss
                self.injected["crash"] += 1
                raise SimulatedCrash(f"kill at dir fsync of {path}")
            if self.fsync_errno is not None:
                raise self._err("fsync", self.fsync_errno, path)
        return self.inner.fsync_dir(path)

    def statvfs(self, path: str):
        sv = self.inner.statvfs(path)
        if self._applies(path) and self.statvfs_free is not None:
            return SimpleNamespace(
                f_bavail=max(0, int(self.statvfs_free) // sv.f_frsize),
                f_frsize=sv.f_frsize,
                f_blocks=sv.f_blocks,
                f_fsid=getattr(sv, "f_fsid", 0),
            )
        return sv


class FaultInjector:
    """Faults over a list of in-process Garage nodes.  `device` is
    where `revive` builds a node's codec: the card by default, and a
    node whose codec cannot reach it raises."""

    def __init__(self, garages: List, configs: Optional[List] = None,
                 zones: Optional[List[str]] = None, device="cuda"):
        self.garages = list(garages)
        # where a revived node's codec runs (Garage(config, device=...)):
        # the card; "cpu" runs the kernels' plain versions (the tests)
        self.device = device
        self.configs = list(configs) if configs else [
            g.config for g in garages]
        self.dead: set = set()
        self.links: Dict[Tuple[int, int], FaultyLink] = {}
        self.disks: Dict[int, FaultyDisk] = {}
        # the RTT matrix currently applied (apply_wan_matrix), or None
        self.wan_matrix: Optional[Dict[Tuple[str, str], float]] = None
        # node index -> zone (for the zone-grained fault helpers); when
        # not given, read from the committed layout
        self._zones = list(zones) if zones else None

    # --- zone topology -------------------------------------------------

    def zone_of_index(self, i: int) -> Optional[str]:
        if self._zones is not None:
            return self._zones[i]
        g = self.garages[i]
        return g.system.zone_of(g.system.id)

    def nodes_in_zone(self, zone: str) -> List[int]:
        return [i for i in range(len(self.garages))
                if self.zone_of_index(i) == zone]

    def _zone_members(self, zone: str) -> set:
        members = set(self.nodes_in_zone(zone))
        assert members, f"no nodes in zone {zone!r}"
        return members

    # --- network faults ---

    async def add_network_faults(
        self, rng: Optional[random.Random] = None
    ) -> None:
        """Interpose a FaultyLink on every directed dial path and migrate
        the cluster's connections through them: peer-book addresses are
        rewritten to the link ports, direct connections are closed, and
        the peering loop re-dials through the links."""
        assert not self.links, "network faults already installed"
        for i, gi in enumerate(self.garages):
            for j, gj in enumerate(self.garages):
                if i == j:
                    continue
                port = int(gj.config.rpc_public_addr.rsplit(":", 1)[1])
                link = FaultyLink("127.0.0.1", port, rng=rng)
                lport = await link.start()
                self.links[(i, j)] = link
                gi.system.peering.add_peer(f"127.0.0.1:{lport}", gj.system.id)
        for g in self.garages:
            for conn in list(g.system.netapp.conns.values()):
                await conn.close()
        await self.reconnect()

    async def reconnect(self, rounds: int = 5) -> bool:
        """Drive the live nodes' peering ticks until the mesh is whole
        (or `rounds` exhausted) — chaos tests must not race the 15 s
        reconnect loop."""
        live = [g for i, g in enumerate(self.garages) if i not in self.dead]
        for _ in range(rounds):
            for g in live:
                await g.system.peering._tick()
            await asyncio.sleep(0.05)
            if all(len(g.system.netapp.conns) >= len(live) - 1
                   for g in live):
                # one extra tick so freshly-dialed conns get PINGED: the
                # RTT EWMAs must exist or the adaptive-timeout layer falls
                # back to static timeouts for every peer
                for g in live:
                    await g.system.peering._tick()
                return True
        return False

    def _pair(self, i: int, j: int) -> List[FaultyLink]:
        return [self.links[(i, j)], self.links[(j, i)]]

    def set_latency(self, i: int, j: int, delay: float,
                    jitter: float = 0.0) -> None:
        """One-way `delay` (±jitter) on both links of the pair (i, j)."""
        for link in self._pair(i, j):
            link.delay, link.jitter = delay, jitter

    def slow_peer(self, k: int, delay: float, jitter: float = 0.0) -> None:
        """Latency spike on every link touching node k (a straggling
        datacenter, not a single bad cable)."""
        for (a, b), link in self.links.items():
            if k in (a, b):
                link.delay, link.jitter = delay, jitter

    def flaky_link(self, i: int, j: int, reset_prob: float) -> None:
        for link in self._pair(i, j):
            link.reset_prob = reset_prob

    def partition_one_way(self, src: int, dst: int) -> None:
        """Bytes from src never reach dst; dst's bytes still reach src
        (asymmetric routing failure).  Requests die, replies flow."""
        self.links[(src, dst)].drop.add("tx")
        self.links[(dst, src)].drop.add("rx")

    def partition(self, i: int, j: int) -> None:
        """Hard two-way partition: refuse new connections, kill live
        ones (both sides see resets, dials fail fast)."""
        for link in self._pair(i, j):
            link.refuse = True
            link.kill_connections()

    def blackhole_node(self, k: int) -> None:
        """Every link touching k accepts but never delivers — in-flight
        RPCs hang until (only) the adaptive timeout fires."""
        for (a, b), link in self.links.items():
            if k in (a, b):
                link.blackhole = True

    def heal_link(self, i: int, j: int) -> None:
        for link in self._pair(i, j):
            link.clear()

    def heal_network(self) -> None:
        for link in self.links.values():
            link.clear()

    # --- zone-grained faults (zone = the production failure domain;
    #     docs/ROBUSTNESS.md "Zone failures & rebalance").  Built on the
    #     FaultyLink primitives above: a zone fault degrades every link
    #     CROSSING the zone boundary and leaves intra-zone links alone —
    #     nodes inside a dark zone still see each other, exactly like a
    #     DC that lost its WAN uplink. ---

    def _boundary_links(self, zone: str):
        members = self._zone_members(zone)
        for (a, b), link in self.links.items():
            if (a in members) != (b in members):
                yield link

    def partition_zone(self, zone: str) -> None:
        """Hard-partition a whole zone: every boundary link refuses new
        connections and kills live ones (both sides fail fast)."""
        for link in self._boundary_links(zone):
            link.refuse = True
            link.kill_connections()

    def blackhole_zone(self, zone: str) -> None:
        """Every boundary link accepts and delivers nothing — in-flight
        cross-zone RPCs hang until the adaptive timeout fires (the
        fault class only breakers + adaptive timeouts catch)."""
        for link in self._boundary_links(zone):
            link.blackhole = True

    def slow_zone(self, zone: str, delay: float, jitter: float = 0.0) -> None:
        """WAN brown-out: one-way `delay` (±jitter) on every boundary
        link (a remote DC turning distant, not broken)."""
        for link in self._boundary_links(zone):
            link.delay, link.jitter = delay, jitter

    def heal_zone(self, zone: str) -> None:
        """Clear every fault on the zone's boundary links."""
        for link in self._boundary_links(zone):
            link.clear()

    # --- geo-WAN latency domains ----------------------------------------

    def apply_wan_matrix(self, matrix: Dict[Tuple[str, str], float],
                         zones: Optional[List[Optional[str]]] = None,
                         jitter: float = 0.0) -> None:
        """Turn the flat loopback mesh into a geography: `matrix` maps an
        (orderless) zone pair to its full RTT in seconds, and every link
        CROSSING that pair's boundary gets rtt/2 one-way delay.  Links
        inside a zone stay untouched — a DC's LAN does not pay WAN tolls.

        `zones` overrides the per-index zone lookup (same length as the
        node list); pass it when some indices — gateways — carry no
        layout role but still live somewhere: the injector's own zone
        table deliberately reports None for them so zone-kill drills
        never crash a gateway, yet their WAN links must still stretch.
        Pairs absent from the matrix keep their current delay."""

        def _zone(i: int) -> Optional[str]:
            if zones is not None and zones[i] is not None:
                return zones[i]
            return self.zone_of_index(i)

        for (a, b), link in self.links.items():
            za, zb = _zone(a), _zone(b)
            if za is None or zb is None or za == zb:
                continue
            rtt = matrix.get((za, zb), matrix.get((zb, za)))
            if rtt is None:
                continue
            link.delay = rtt / 2.0
            link.jitter = jitter / 2.0
        self.wan_matrix = dict(matrix)

    def clear_wan_matrix(self) -> None:
        """Back to a flat zero-RTT mesh (only latency/jitter are reset —
        other live faults on the links are left alone)."""
        for link in self.links.values():
            link.delay = 0.0
            link.jitter = 0.0
        self.wan_matrix = None

    async def kill_zone(self, zone: str) -> None:
        """Abruptly crash every node in the zone (correlated failure —
        the regime zone_redundancy placement exists for)."""
        for i in self.nodes_in_zone(zone):
            if i not in self.dead:
                await self.crash(i)

    async def revive_zone(self, zone: str, wait_secs: float = 10.0) -> List:
        """Restart every dead node of the zone from its on-disk state."""
        out = []
        for i in self.nodes_in_zone(zone):
            if i in self.dead:
                out.append(await self.revive(i, wait_secs=wait_secs))
        return out

    async def stop_network(self) -> None:
        for link in self.links.values():
            await link.stop()
        self.links.clear()

    # --- disk faults (docs/ROBUSTNESS.md "Disk faults & degraded mode") ---

    def add_disk_faults(self, i: int, root: Optional[str] = None,
                        rng: Optional[random.Random] = None) -> FaultyDisk:
        """Interpose a FaultyDisk on node i's filesystem boundary (all
        roots, or just `root`).  Idempotent per node; returns the disk
        so the caller can flip knobs directly.  The health monitor's
        statvfs closure is late-bound through mgr.disk, so the synthetic
        free-space override is honored immediately."""
        fd = self.disks.get(i)
        if fd is None:
            mgr = self.garages[i].block_manager
            fd = FaultyDisk(mgr.disk, rng=rng, path_prefix=root)
            mgr.disk = fd
            self.disks[i] = fd
        return fd

    def flaky_disk(self, i: int, prob: float = 0.5,
                   eno: int = errno.EIO) -> FaultyDisk:
        """Probabilistic EIO on node i's reads AND writes — the dying-
        disk regime the self-healing read path and the error-streak
        breaker exist for."""
        fd = self.add_disk_faults(i)
        fd.read_errno = fd.write_errno = eno
        fd.read_error_prob = fd.write_error_prob = prob
        return fd

    def fill_disk(self, i: int, free_bytes: int = 0) -> FaultyDisk:
        """Synthetic ENOSPC: statvfs on node i reports `free_bytes`
        free, so the watermark preflight flips its roots read-only
        (StorageFull) without writing a single real byte."""
        fd = self.add_disk_faults(i)
        fd.statvfs_free = free_bytes
        return fd

    def bitrot_disk(self, i: int, prob: float) -> FaultyDisk:
        fd = self.add_disk_faults(i)
        fd.bitrot_prob = prob
        return fd

    def heal_disk(self, i: int) -> None:
        """Clear every injected fault on node i's disk (the wrapper
        stays installed — faults can be re-applied live)."""
        fd = self.disks.get(i)
        if fd is not None:
            fd.clear()

    # --- node faults ---

    async def crash(self, i: int) -> None:
        """Abrupt node death: close the transport and cancel workers,
        skipping every graceful-drain step of Garage.shutdown()."""
        g = self.garages[i]
        await g.bg.shutdown(timeout=0.5)
        await g.system.shutdown()
        if g._owns_db:
            g.db.close()
        self.dead.add(i)

    async def revive(self, i: int, peers: Optional[List[str]] = None,
                     wait_secs: float = 10.0):
        """Restart node i from its on-disk state; returns the new Garage.
        `peers` = "host:port" addresses to reconnect to (defaults to the
        rpc_public_addr — or fault-link port — of every live node).
        Dial failures are LOGGED (the peering loop keeps retrying them),
        and the call waits up to `wait_secs` for the peer handshakes so
        chaos tests don't race the reconnect loop."""
        from ..model import Garage

        assert i in self.dead, f"node {i} is not dead"
        g = Garage(self.configs[i], device=self.device)
        await g.system.netapp.listen(self.configs[i].rpc_bind_addr)
        port = g.system.netapp._server.sockets[0].getsockname()[1]
        g.config.rpc_public_addr = f"127.0.0.1:{port}"
        live = [j for j in range(len(self.garages))
                if j != i and j not in self.dead]
        if self.links:
            # the revived node listens on a fresh port: EVERY link
            # pointing at it must retarget — including links from
            # currently-dead nodes, or a later revive of those nodes
            # dials this node's stale port forever (failing ticks that
            # wrongly feed its breaker)
            for (a, b), link in self.links.items():
                if b == i:
                    link.retarget(port)

        def _addr_of(j: int) -> str:
            if self.links:
                return f"127.0.0.1:{self.links[(i, j)].port}"
            return self.garages[j].config.rpc_public_addr

        if peers is None:
            peers = [_addr_of(j) for j in live]
        for addr in peers:
            try:
                await g.system.netapp.connect(addr)
            except Exception as e:
                # not silent: a chaos run must be able to tell "revive
                # raced the reconnect loop" from "revive couldn't reach
                # anything" in its logs
                logger.warning(
                    "revive(%d): dial %s failed (%s); peering loop will "
                    "keep retrying", i, addr, e)
        for j in live:
            other = self.garages[j]
            other_addr = (f"127.0.0.1:{self.links[(j, i)].port}"
                          if self.links else g.config.rpc_public_addr)
            other.system.peering.add_peer(other_addr, g.system.id)
            g.system.peering.add_peer(_addr_of(j), other.system.id)
        # adopt the cluster's layout from any live node
        for j, other in enumerate(self.garages):
            if j != i and j not in self.dead:
                from ..rpc.layout import ClusterLayout

                g.system.layout = ClusterLayout.decode(
                    other.system.layout.encode())
                g.system._rebuild_ring()
                break
        g.spawn_workers()
        g.system.peering.start()
        self.garages[i] = g
        self.dead.discard(i)
        # the revived manager owns a fresh DiskIo: drop the stale fault
        # wrapper (re-install via add_disk_faults to fault the new disk)
        self.disks.pop(i, None)
        # bounded convergence wait: drive peering ticks (both sides —
        # the live nodes' 15 s loops would otherwise win every race)
        # until every live peer's handshake landed or the budget is out
        expected = {self.garages[j].system.id for j in live}
        deadline = time.monotonic() + wait_secs

        def _missing():
            return [n for n in expected if n not in g.system.netapp.conns]

        while _missing() and time.monotonic() < deadline:
            await g.system.peering._tick()
            for j in live:
                if j not in self.dead:
                    await self.garages[j].system.peering._tick()
            await asyncio.sleep(0.1)
        still = _missing()
        if still:
            logger.warning(
                "revive(%d): %d/%d peer handshakes still missing after "
                "%.1fs", i, len(still), len(expected), wait_secs)
        return g

    # --- block faults ---

    def _block_files(self, i: int) -> List[str]:
        dd = self.configs[i].data_dir  # [{"path": ..., ...}, ...]
        roots = [d["path"] if isinstance(d, dict) else str(d) for d in dd] \
            if isinstance(dd, list) else [str(dd)]
        out = []
        for root in roots:
            for dirpath, _dirs, files in os.walk(root):
                if "parity" in dirpath.split(os.sep):
                    continue
                for f in files:
                    if not f.endswith((".par", ".tmp", ".corrupted")):
                        out.append(os.path.join(dirpath, f))
        return out

    def list_blocks(self, i: int) -> List[Hash]:
        out = []
        for p in self._block_files(i):
            name = os.path.basename(p).split(".")[0]
            try:
                out.append(Hash(bytes.fromhex(name)))
            except ValueError:
                continue
        return out

    def _find(self, i: int, h: Hash) -> Optional[str]:
        want = bytes(h).hex()
        for p in self._block_files(i):
            if os.path.basename(p).startswith(want):
                return p
        return None

    def drop_block(self, i: int, h: Hash) -> bool:
        """Silently delete a block file (disk losing data without the
        node noticing — the scrub/resync machinery must detect it)."""
        p = self._find(i, h)
        if p is None:
            return False
        os.remove(p)
        return True

    def corrupt_block(self, i: int, h: Hash, at: int = 100) -> bool:
        """Flip one byte of a stored block (silent bitrot; scrub must
        catch it by content hash, never serve it)."""
        p = self._find(i, h)
        if p is None:
            return False
        with open(p, "r+b") as f:
            f.seek(at)
            b = f.read(1)
            f.seek(at)
            f.write(bytes([(b[0] if b else 0) ^ 0xFF]))
        return True


async def crash_heaviest_and_drop(inj: FaultInjector, skip=(0,),
                                  resync_workers: int = 4):
    """Shared repair-storm opener (bench --repair-storm-phase and
    scripts/chaos.py repair_storm): crash the heaviest data holder not
    in `skip` (typically the gateway), drop it from the committed
    layout, hand every survivor the new ring and a raised resync worker
    count.  Returns (victim_index, lost_bytes, survivors) — the heal
    itself is the product's own layout-sweep/resync path, which the
    callers then observe in their own ways."""
    from ..rpc.layout import ClusterLayout

    garages = inj.garages
    sizes = []
    for i in range(len(garages)):
        if i in skip or i in inj.dead:
            continue
        n = sum(os.path.getsize(p) for p in inj._block_files(i))
        sizes.append((n, i))
    lost, victim = max(sizes)
    await inj.crash(victim)
    # inj.dead includes the new victim AND any earlier casualties — a
    # second storm on the same injector must not touch closed nodes
    src = next(g for i, g in enumerate(garages) if i not in inj.dead)
    lay = ClusterLayout.decode(src.system.layout.encode())
    lay.stage_role(bytes(garages[victim].system.id), None)
    lay.apply_staged_changes()
    enc = lay.encode()
    survivors = []
    for i, g in enumerate(garages):
        if i in inj.dead:
            continue
        g.system.layout = ClusterLayout.decode(enc)
        g.system._rebuild_ring()
        g.block_resync.set_n_workers(resync_workers)
        survivors.append(g)
    return victim, lost, survivors
