"""Degraded-mode RPC resilience primitives.

The quorum engine's value proposition (1 RTT in the common case, quorum
survives stragglers — PAPER.md) only holds while every peer is healthy:
with one fixed timeout, no retries and no hedging, a single slow or
blackholed peer drags every read that latency-orders it into the first
quorum wave into a full timeout.  This module holds the pure mechanisms
the RPC layer composes to act on the health data the metrics make visible
(peer RTT EWMA, failure streaks, per-endpoint latency histograms):

  - ``ResilienceTunables`` — the ``[rpc]`` config section, threaded into
    ``FullMeshPeering`` (breaker) and ``RpcHelper`` (timeouts / retries /
    hedging).
  - ``adaptive_timeout`` — clamped ``base + k·rtt`` per-peer timeout; the
    static strategy timeout remains both the fallback for unknown peers
    and the ceiling.
  - ``full_jitter_backoff`` — the AWS full-jitter schedule for bounded
    retries of idempotent calls (retry storms synchronize without the
    jitter; see PAPERS.md tail-at-scale discussion).
  - ``CircuitBreaker`` — per-peer closed → open → half-open machine with
    an injectable clock so state transitions unit-test without sleeping.

Everything here is deliberately dependency-free (stdlib only): the net
layer must not import config/ops, and tests drive it with fake clocks.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass
from typing import Callable, Optional

__all__ = [
    "ResilienceTunables",
    "adaptive_timeout",
    "full_jitter_backoff",
    "is_transport_error",
    "CircuitBreaker",
    "BREAKER_STATE_VALUES",
]


@dataclass
class ResilienceTunables:
    """``[rpc]`` tunables (defaults chosen for WAN RTTs ≤ ~300 ms).

    Adaptive timeout: ``clamp(base + k·rtt_ewma, floor, static)`` where
    ``static`` is the caller's RequestStrategy timeout — adaptive tuning
    may only ever SHRINK a timeout, never extend past what the caller
    budgeted."""

    # adaptive per-peer timeouts
    adaptive_timeout_base: float = 5.0      # seconds added on top of k·rtt
    adaptive_timeout_rtt_factor: float = 20.0
    adaptive_timeout_min: float = 0.5       # floor: never time out faster
    # bounded retries (idempotent calls only)
    retry_max: int = 2                      # extra attempts per node call
    retry_backoff_base: float = 0.05        # full-jitter base (seconds)
    retry_backoff_max: float = 2.0          # per-sleep cap
    # read hedging
    hedge_quantile: float = 0.9             # of rpc_duration_seconds{endpoint}
    hedge_min_samples: int = 20             # no hedging before this many obs
    # per-peer circuit breaker
    breaker_failure_threshold: int = 5      # consecutive failures to open
    breaker_open_secs: float = 10.0         # cooldown before half-open probe
    breaker_rtt_blowup: float = 10.0        # ping > blowup×EWMA counts as fail
    breaker_rtt_min: float = 1.0            # …but only above this floor
    breaker_failure_window: float = 0.25    # dedupe burst failures (one conn
    #                                         loss fails N in-flight RPCs at
    #                                         once; that is ONE event)
    # block transfer static timeout (the adaptive layer's fallback for
    # put_block/get_block/need_block — used to be hardcoded 60.0 in
    # block/resync.py and block/manager.py)
    block_rpc_timeout: float = 60.0
    # --- end-to-end deadline propagation (docs/ROBUSTNESS.md "Overload
    # & brownout"): the API front door stamps each client request with
    # deadline_default seconds of budget; every RPC hop carries the
    # REMAINING budget and clamps its timeout to it; a hop whose
    # remaining budget is at or under deadline_floor fast-fails typed
    # (DeadlineExceeded) instead of dispatching work whose client is
    # gone.  deadline_default <= 0 disables request deadlines entirely.
    deadline_default: float = 30.0
    deadline_floor: float = 0.01


def adaptive_timeout(
    rtt: Optional[float],
    static: Optional[float],
    tun: ResilienceTunables,
) -> Optional[float]:
    """Per-peer timeout from the ping RTT EWMA: ``base + k·rtt``, floored
    at ``adaptive_timeout_min`` and ceilinged at the static timeout.
    Unknown peers (no EWMA yet) and untimed calls (static None) fall back
    to the static value unchanged."""
    if rtt is None or static is None:
        return static
    t = tun.adaptive_timeout_base + tun.adaptive_timeout_rtt_factor * rtt
    return min(static, max(tun.adaptive_timeout_min, t))


def full_jitter_backoff(
    attempt: int,
    tun: ResilienceTunables,
    rng: random.Random = random,  # type: ignore[assignment]
) -> float:
    """AWS full-jitter: uniform over [0, min(cap, base·2^attempt)].
    ``attempt`` is 0-based (first retry = attempt 0)."""
    ceiling = min(tun.retry_backoff_max,
                  tun.retry_backoff_base * (2 ** attempt))
    return rng.uniform(0.0, ceiling)


def is_transport_error(e: BaseException) -> bool:
    """True for failures that indict the PATH to the peer, not the peer's
    answer: timeouts, connection loss/refusal, and local RpcErrors.  An
    error reconstructed from a K_ERR/K_RESP wire code (``remote_code``
    set) proves the peer answered — the transport is fine, so it neither
    feeds the breaker nor earns a retry to the same node.  Likewise a
    DeadlineExceeded indicts the CALLER's budget, not the path: no
    breaker feed, no retry (the budget is gone either way)."""
    from ..utils.error import DeadlineExceeded, RpcError

    if getattr(e, "remote_code", None):
        return False
    if isinstance(e, DeadlineExceeded):
        return False
    if isinstance(e, (TimeoutError, asyncio.TimeoutError)):
        return True
    if isinstance(e, (ConnectionError, OSError)):
        return True
    return isinstance(e, RpcError)


# peer_breaker_state gauge encoding (docs/ROBUSTNESS.md + dashboard
# mappings rely on these values)
BREAKER_STATE_VALUES = {"closed": 0.0, "half_open": 1.0, "open": 2.0}


class CircuitBreaker:
    """Per-peer circuit breaker: closed → open on a consecutive-failure
    streak (or ping-RTT blowup), half-open probe after a cooldown, closed
    again on probe success.

    Listed behaviors the RPC layer depends on:
      - ``allow()`` is the request gate: True in closed state, True for
        exactly ONE in-flight probe once the open cooldown elapses, False
        otherwise (callers fast-fail instead of burning a timeout).
      - Failures within ``failure_window`` seconds of the previous one
        count as a single event: one TCP connection dying fails every
        in-flight RPC on it simultaneously, and that must not trip a
        threshold-5 breaker on its own.
      - A failure while OPEN does NOT re-arm the cooldown (pings keep
        failing against a dead peer; the half-open probe must still get
        its turn).  A failure while HALF_OPEN re-opens with a fresh
        cooldown.
      - Success from ANY source (ping or data plane) closes immediately.

    ``clock`` is injectable so every transition is unit-testable without
    real sleeps."""

    __slots__ = ("tun", "clock", "state", "failures", "opened_at",
                 "probe_in_flight", "probe_at", "last_failure_at", "trips")

    def __init__(self, tun: Optional[ResilienceTunables] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.tun = tun or ResilienceTunables()
        self.clock = clock
        self.state = "closed"
        self.failures = 0
        self.opened_at = 0.0
        self.probe_in_flight = False
        self.probe_at = 0.0
        self.last_failure_at: Optional[float] = None
        self.trips = 0  # lifetime open transitions (metrics/debugging)

    # --- state queries (non-mutating) ---

    def state_now(self) -> str:
        """Current state accounting for elapsed cooldown, without
        consuming the half-open probe slot (safe for request_order and
        metric scrapes)."""
        if self.state == "open" and (
            self.clock() - self.opened_at >= self.tun.breaker_open_secs
        ):
            return "half_open"
        return self.state

    # --- the request gate ---

    def allow(self) -> bool:
        now = self.clock()
        if self.state == "open":
            if now - self.opened_at < self.tun.breaker_open_secs:
                return False
            self.state = "half_open"
            self.probe_in_flight = False
        if self.state == "half_open":
            # one probe at a time; a probe whose caller vanished (task
            # cancelled before reporting) expires after a cooldown so the
            # peer is not stuck un-probeable forever
            if self.probe_in_flight and (
                now - self.probe_at < self.tun.breaker_open_secs
            ):
                return False
            self.probe_in_flight = True
            self.probe_at = now
            return True
        return True

    def release_probe(self) -> None:
        """The in-flight probe was abandoned without a verdict (caller
        cancelled, e.g. a hedged read losing the race)."""
        self.probe_in_flight = False

    # --- outcome reporting ---

    def on_success(self) -> None:
        self.failures = 0
        self.last_failure_at = None
        self.probe_in_flight = False
        self.state = "closed"

    def on_failure(self) -> None:
        now = self.clock()
        if self.state == "half_open":
            # failed probe: back to open with a fresh cooldown.  Checked
            # BEFORE the burst dedupe — a probe verdict arriving within
            # the window of an earlier failure must never be swallowed,
            # or the breaker wedges half-open (probe slot consumed, gauge
            # reads 1, request_order does not demote) until the next
            # failure outside the window
            self.state = "open"
            self.opened_at = now
            self.probe_in_flight = False
            self.last_failure_at = now
            self.trips += 1
            return
        if (self.last_failure_at is not None
                and now - self.last_failure_at < self.tun.breaker_failure_window):
            return  # burst: same event as the previous failure
        self.last_failure_at = now
        if self.state == "open":
            return  # cooldown keeps running; do not starve the probe
        self.failures += 1
        if self.failures >= self.tun.breaker_failure_threshold:
            self.state = "open"
            self.opened_at = now
            self.trips += 1

    def on_rtt(self, rtt: float, baseline: Optional[float]) -> None:
        """Ping outcome: a blown-up RTT (>'blowup'× the pre-ping EWMA and
        above the absolute floor) counts as a failure even though the ping
        technically succeeded — a peer 10× slower than its own history is
        degraded for quorum purposes."""
        if baseline is not None and rtt > max(
            self.tun.breaker_rtt_min, self.tun.breaker_rtt_blowup * baseline
        ):
            self.on_failure()
        else:
            self.on_success()
