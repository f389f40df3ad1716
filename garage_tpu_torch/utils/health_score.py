"""Fail-slow peer detection — comparative per-peer health scoring.

A node that is *down* is easy: pings fail, the circuit breaker opens,
request_order sorts it last.  A node that is *up but slow* — NIC
negotiated 100 Mb/s, a dying disk dragging every RPC handler, one VM on
a noisy host — passes every liveness check while silently dragging each
quorum it sits in (the "gray failure" / fail-slow literature; the
degraded-reads paper's least-loaded-survivor scheduling is the same
observation from the repair side).  Nothing absolute can catch it: its
latency may be perfectly "normal" for a WAN peer.  What gives it away
is COMPARISON — the same endpoint class, served by its siblings, is a
factor cheaper.

This module holds the pure scorer:

  - every completed RPC feeds a per-(peer, endpoint-class) service-time
    EWMA digest (``note``) — the plumbing is the RpcHelper call path
    that already times ``rpc_duration_seconds``, plus the peering ping
    loop that feeds ``peer_rtt_ewma_seconds`` (class ``ping``);
  - a peer's **health score** is the worst ratio, across classes, of
    its digest to the *lower median* of the OTHER peers' digests for
    the same class (lower median biases toward flagging when half the
    comparison set is itself sick, and a peer judged against only its
    own traffic can never be flagged);
  - a peer is flagged **fail-slow** when its score sits at or above
    ``fail_slow_factor`` continuously for ``window_s`` seconds, and
    unflagged when it sits at or below ``clear_factor`` for the same
    window (hysteresis: the band between the two factors changes
    nothing, so a peer oscillating around the threshold does not flap).

Consumers: the score and flag ride ``NodeStatus`` gossip
(rpc/system.py), render as ``peer_health_score{peer}`` /
``peer_fail_slow{peer}``, demote flagged peers in
``RpcHelper.peer_rank`` (after breaker-open, before RTT), and feed
``RepairPlanner`` survivor ranking.  Flag transitions trigger the
incident flight recorder (utils/flightrec.py).

Deliberately dependency-free with an injectable clock, like the
CircuitBreaker next door in net/resilience.py: every transition
unit-tests without sleeping.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["HealthTunables", "FailSlowScorer"]

# EWMA step per observation; ~10 samples to cross most of a step change,
# small enough that one straggling call does not flag a healthy peer
EWMA_ALPHA = 0.2

# medians below this floor (seconds) are clamped before the ratio: at
# loopback microsecond medians, scheduler jitter alone is a 10x "blowup"
MEDIAN_FLOOR_S = 1e-4


@dataclass
class HealthTunables:
    """``[health]`` — fail-slow detection knobs
    (docs/OBSERVABILITY.md "Fleet health & SLOs")."""

    # score at/above this, sustained for window_s, flags the peer
    fail_slow_factor: float = 3.0
    # score at/below this, sustained for window_s, clears the flag
    # (the band between the factors is hysteresis: no transitions)
    clear_factor: float = 1.5
    # how long a verdict must hold continuously before it takes effect
    window_s: float = 30.0
    # per-(peer, class) observations needed before the digest is judged
    min_samples: int = 8
    # OTHER peers with a judgeable digest in the same class needed
    # before a comparison is trusted (1 = compare against a single
    # sibling — small clusters; raise it where one bad baseline peer
    # could mis-flag a healthy one)
    min_baseline_peers: int = 1
    # digests idle longer than this drop out of the comparison set (a
    # peer we stopped calling must neither flag nor anchor the median)
    sample_ttl_s: float = 300.0


class _Digest:
    """Per-(peer, class) service-time EWMA."""

    __slots__ = ("ewma", "count", "last_at")

    def __init__(self):
        self.ewma = 0.0
        self.count = 0
        self.last_at = 0.0

    def note(self, seconds: float, now: float) -> None:
        self.count += 1
        self.last_at = now
        if self.count == 1:
            self.ewma = seconds
        else:
            self.ewma += EWMA_ALPHA * (seconds - self.ewma)


class _PeerVerdict:
    """Flag state machine for one peer (sustained-window hysteresis)."""

    __slots__ = ("score", "flagged", "above_since", "below_since",
                 "flagged_at")

    def __init__(self):
        self.score: Optional[float] = None
        self.flagged = False
        self.above_since: Optional[float] = None
        self.below_since: Optional[float] = None
        self.flagged_at: Optional[float] = None


def _lower_median(vals: List[float]) -> float:
    """Median biased LOW on even counts: when half the comparison set is
    itself slow, the baseline stays anchored to the healthy half."""
    s = sorted(vals)
    return s[(len(s) - 1) // 2]


class FailSlowScorer:
    """Comparative fail-slow scorer for one node's view of its peers.

    ``note`` is called from the RPC hot path (dict lookup + float math);
    the flag evaluation (``update``) runs on the status-gossip cadence
    and on demand from the metric observers.  ``on_change(peer_hex,
    flagged, score)`` fires on every flag transition — the incident
    flight recorder's trigger."""

    def __init__(self, tun: Optional[HealthTunables] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_change: Optional[Callable[[str, bool, float], None]] = None):
        self.tun = tun or HealthTunables()
        self.clock = clock
        self.on_change = on_change
        # zone lookup (peer_bytes -> zone name or None), wired by the
        # owning System from the cluster layout.  On a geo-distributed
        # cluster a healthy peer two WAN hops away is a FACTOR slower
        # than a loopback sibling on every class — that is distance, not
        # gray failure.  When the peer's zone holds enough baseline
        # peers, comparison is restricted to same-zone siblings (who pay
        # the same RTTs); otherwise it falls back to the full set.
        self.zone_of: Optional[Callable[[bytes], Optional[str]]] = None
        # (peer_bytes, class) -> digest
        self._digests: Dict[Tuple[bytes, str], _Digest] = {}
        self._verdicts: Dict[bytes, _PeerVerdict] = {}
        self.transitions = 0  # lifetime flag flips (debug/metrics)
        # the scorer is read from flight-recorder capture threads (the
        # metrics collector renders the health gauges off-loop) while
        # the event loop keeps feeding note()/update(): every state
        # mutation or multi-item read holds this.  Reentrant because
        # update() -> on_change -> (an inline, loop-less capture) can
        # come back through scores() on the same thread
        self._lock = threading.RLock()

    @staticmethod
    def _label(peer: bytes) -> str:
        return bytes(peer).hex()[:16]

    # --- ingest ----------------------------------------------------------

    def note(self, peer: bytes, cls: str, seconds: float) -> None:
        """One completed call to `peer` on endpoint-class `cls`."""
        peer = bytes(peer)
        key = (peer, cls)
        with self._lock:
            d = self._digests.get(key)
            if d is None:
                d = self._digests[key] = _Digest()
            d.note(float(seconds), self.clock())

    def forget(self, peer: bytes) -> None:
        """Drop a peer removed from the layout (same contract as
        peering.forget_peer: a re-added node inherits no history)."""
        peer = bytes(peer)
        with self._lock:
            for key in [k for k in self._digests if k[0] == peer]:
                del self._digests[key]
            self._verdicts.pop(peer, None)

    # --- scoring ---------------------------------------------------------

    def _fresh_digests(self, now: float) -> Dict[Tuple[bytes, str], _Digest]:
        ttl = self.tun.sample_ttl_s
        gone = [k for k, d in self._digests.items()
                if now - d.last_at > ttl]
        for k in gone:
            del self._digests[k]
        return self._digests

    def score(self, peer: bytes) -> Optional[float]:
        """The peer's current comparative score (worst class ratio), or
        None when no class has enough data to judge."""
        with self._lock:
            return self._score(bytes(peer),
                               self._fresh_digests(self.clock()))

    def _score(self, peer: bytes,
               digests: Dict[Tuple[bytes, str], _Digest]) -> Optional[float]:
        tun = self.tun
        worst: Optional[float] = None
        by_class: Dict[str, List[Tuple[bytes, float]]] = {}
        for (p, cls), d in digests.items():
            if d.count >= tun.min_samples:
                by_class.setdefault(cls, []).append((p, d.ewma))
        zone = self.zone_of(peer) if self.zone_of is not None else None
        for cls, rows in by_class.items():
            mine = next((e for p, e in rows if p == peer), None)
            if mine is None:
                continue
            others = [e for p, e in rows if p != peer]
            if zone is not None:
                # prefer same-zone siblings as the baseline: a WAN-far
                # zone must not look fail-slow against loopback peers
                same_zone = [e for p, e in rows
                             if p != peer and self.zone_of(p) == zone]
                if len(same_zone) >= tun.min_baseline_peers:
                    others = same_zone
            if len(others) < tun.min_baseline_peers:
                continue
            ratio = mine / max(_lower_median(others), MEDIAN_FLOOR_S)
            if worst is None or ratio > worst:
                worst = ratio
        return worst

    # --- verdicts (sustained-window hysteresis) --------------------------

    def update(self, now: Optional[float] = None) -> None:
        """Re-evaluate every peer's flag.  Called on the status-exchange
        cadence (rpc/system.py) and before any scores() read."""
        now = self.clock() if now is None else now
        with self._lock:
            self._update_locked(now)

    def _update_locked(self, now: float) -> None:
        digests = self._fresh_digests(now)
        peers = {p for p, _cls in digests}
        tun = self.tun
        for peer in peers:
            v = self._verdicts.get(peer)
            if v is None:
                v = self._verdicts[peer] = _PeerVerdict()
            v.score = self._score(peer, digests)
            if v.score is None:
                # not judgeable: clear timers, keep the current flag
                # (a flagged peer we stopped calling ages out via the
                # digest TTL sweep below, not via an absent verdict)
                v.above_since = v.below_since = None
                continue
            if v.score >= tun.fail_slow_factor:
                v.below_since = None
                if v.above_since is None:
                    v.above_since = now
                if not v.flagged and now - v.above_since >= tun.window_s:
                    v.flagged = True
                    v.flagged_at = now
                    self.transitions += 1
                    self._emit(peer, True, v.score)
            elif v.score <= tun.clear_factor:
                v.above_since = None
                if v.below_since is None:
                    v.below_since = now
                if v.flagged and now - v.below_since >= tun.window_s:
                    v.flagged = False
                    v.flagged_at = None
                    self.transitions += 1
                    self._emit(peer, False, v.score)
            else:
                # hysteresis band: neither timer runs
                v.above_since = v.below_since = None
        # peers whose every digest aged out: clear a stale flag (the
        # peer is not being called at all — unreachable is the
        # breaker's business, not ours)
        for peer in [p for p in self._verdicts if p not in peers]:
            v = self._verdicts.pop(peer)
            if v.flagged:
                self.transitions += 1
                self._emit(peer, False, v.score or 0.0)

    def _emit(self, peer: bytes, flagged: bool, score: float) -> None:
        if self.on_change is None:
            return
        try:
            self.on_change(self._label(peer), flagged, round(score, 3))
        except Exception:  # noqa: BLE001 — observers must never break scoring
            pass

    # --- read side -------------------------------------------------------

    def fail_slow(self, peer: bytes) -> bool:
        v = self._verdicts.get(bytes(peer))
        return bool(v is not None and v.flagged)

    def scores(self, update: bool = True) -> Dict[str, dict]:
        """{peer_hex16: {"score": float, "fail_slow": bool}} for every
        currently judgeable peer — the gossip payload and the metric
        observer's source."""
        with self._lock:
            if update:
                self.update()
            out: Dict[str, dict] = {}
            for peer, v in self._verdicts.items():
                if v.score is None and not v.flagged:
                    continue
                out[self._label(peer)] = {
                    "score": (round(v.score, 3)
                              if v.score is not None else None),
                    "fail_slow": v.flagged,
                }
            return out
