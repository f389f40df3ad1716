"""Overload protection — admission tunables + the background load governor.

The cluster has well-defined behavior up to saturation (quorums, retries,
breakers, disk routing) but historically none PAST it: the S3 front door
accepted unbounded concurrent work and background producers (resync,
rebalance, scrub, repair storms) competed with foreground PUT/GET at
static wire priorities only.  The metastable-failure literature (see
PAPERS.md discussion in docs/ROBUSTNESS.md "Overload & brownout") says
the difference between a latency blip and a cluster-wide collapse is
shedding doomed work EARLY and letting background load cede capacity
while the foreground is hot.  This module holds the two pure pieces:

  - ``OverloadTunables`` — the ``[api]`` config section: admission-gate
    watermarks (max in-flight requests / body bytes) and the governor's
    thresholds.  Dependency-free so net/, api/ and block/ can all import
    it.
  - ``LoadGovernor`` — one per node.  It aggregates live pressure
    signals the node already produces (admission-gate occupancy, codec
    feeder depth, the netapp queue-wait EWMA, disk health) into a single
    smoothed ``background_throttle_ratio`` in [min_ratio, 1.0]:
    1.0 = background runs at full rate, min_ratio = background nearly
    parked.  Consumers: BackgroundRunner (duty-cycles worker
    iterations), RebalanceMover (scales rebalance_rate_mib), and the
    RepairPlanner (clamps repair-storm fetch concurrency).

The governor is deliberately memory-light: pressure is recomputed from
the signal callbacks on demand and smoothed with a time-constant EWMA
(injectable clock, so transitions unit-test without sleeping).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

__all__ = ["OverloadTunables", "LoadGovernor"]


@dataclass
class OverloadTunables:
    """``[api]`` tunables (docs/ROBUSTNESS.md "Overload & brownout").

    Admission gate: a request is shed (503 SlowDown + Retry-After)
    when the node already has ``max_inflight`` requests in flight or
    ``max_inflight_bytes`` of declared request-body bytes committed —
    never queued: queueing past saturation only converts overload into
    timeout storms.  0 disables the corresponding watermark."""

    # admission gate watermarks
    max_inflight: int = 256
    max_inflight_bytes: int = 1 << 30          # 1 GiB of declared bodies
    # base client back-off seconds on a shed; the Retry-After actually
    # sent is DERIVED from live load (governor pressure / queue depth,
    # AdmissionGate.retry_after_hint) between retry_after and
    # retry_after_max
    retry_after: int = 1
    retry_after_max: int = 30
    # --- multi-tenant fair queueing (WDRR; docs/ROBUSTNESS.md
    # "Multi-tenant fairness & noisy neighbors") ---
    # bound on each tenant's admission queue (requests waiting for a
    # slot); past it that tenant sheds — never the whole gate
    tenant_queue_len: int = 32
    # max seconds a request may wait queued before shedding typed
    tenant_queue_wait: float = 1.0
    # WDRR byte deficit added per scheduling visit, and the per-request
    # base cost (so byte-free GETs still consume deficit)
    wdrr_quantum_bytes: int = 256 * 1024
    wdrr_request_cost: int = 64 * 1024
    # cap on distinct tenants tracked (metric-cardinality bound; the
    # overflow shares one "~overflow" bucket)
    max_tracked_tenants: int = 1024
    # --- cluster-aware admission ---
    # gossiped governor_pressure of a layout node the request must touch
    # at/above this sheds at the front door (verdict remote_pressure);
    # 0 disables.  Pressure is clamped to [0, 2]; 1 means saturated.
    remote_pressure_shed: float = 1.5
    # --- CoDel-style adaptive watermark ---
    # admitted-request sojourn target (seconds): latency persistently
    # above it for codel_interval tightens the effective in-flight
    # limit; persistently below relaxes back toward max_inflight.
    # 0 disables (static watermark).
    codel_target: float = 0.5
    codel_interval: float = 2.0
    # --- byte accounting for Content-Length-less (chunked) bodies ---
    # conservative bytes charged at admission for a streaming body with
    # no declared length, reconciled to actual bytes as it streams
    streaming_body_estimate: int = 16 * 1024 * 1024
    # bound on the separate long-poll pool (parked K2V polls).  Past it
    # a poll keeps holding its admission slot instead of parking, so
    # total poll concurrency stays bounded by the gate as before this
    # pool existed.  0 = derive 4 x max_inflight.
    longpoll_max_parked: int = 0
    # --- graceful drain (docs/ROBUSTNESS.md "Geo-WAN & gateway
    # failover") ---
    # max seconds a SIGTERM'd API server waits for its in-flight set
    # to finish while shedding new requests typed, before closing the
    # socket regardless
    drain_timeout: float = 10.0
    # --- load governor ---
    # pressure <= governor_low → background at full rate (ratio 1.0);
    # pressure >= governor_high → background at governor_min_ratio;
    # linear in between.  Pressure is the max over the live signals,
    # each normalized to [0, 1+].
    governor_low: float = 0.45
    governor_high: float = 0.85
    governor_min_ratio: float = 0.05
    # EWMA time constant (seconds) smoothing the ratio so one bursty
    # scrape or a single slow frame does not whipsaw the workers
    governor_tau: float = 2.0
    # queue-wait seconds that count as pressure 1.0 (the HOL-blocking
    # signal net_queue_wait_seconds measures; 50 ms of frames waiting
    # for the wire means the node is badly backed up)
    governor_queue_wait_full: float = 0.05
    # codec feeder depth (pending submissions) that counts as pressure
    # 1.0 — the foreground data path is saturated past this backlog
    governor_feeder_depth_full: int = 64


class LoadGovernor:
    """Aggregates pressure signals → one smoothed background throttle
    ratio.  Signals are callables returning pressure in [0, 1+] (values
    above 1 are clamped); registration order is only cosmetic."""

    def __init__(self, tun: Optional[OverloadTunables] = None,
                 metrics=None, clock: Callable[[], float] = time.monotonic):
        self.tun = tun or OverloadTunables()
        self.clock = clock
        self._signals: List[Tuple[str, Callable[[], float]]] = []
        # netapp queue-wait EWMA (fed by the connection write loops via
        # note_queue_wait; decays on read so a past burst ages out even
        # with no new frames flowing)
        self._qwait_ewma = 0.0
        self._qwait_at = clock()
        self._ratio = 1.0
        self._ratio_at = clock()
        if metrics is not None:
            metrics.gauge(
                "background_throttle_ratio",
                "Background work rate multiplier chosen by the load "
                "governor (1 = full rate, near 0 = foreground pressure "
                "has background work parked)",
                fn=self.ratio)
            metrics.gauge(
                "governor_pressure",
                "Current max foreground-pressure signal feeding the "
                "load governor (0 idle, >= 1 saturated)",
                fn=self.pressure)

    # --- signal wiring ---------------------------------------------------

    def add_signal(self, name: str, fn: Callable[[], float]) -> None:
        self._signals.append((name, fn))

    def remove_signal(self, name: str) -> None:
        """Drop a signal by name (chaos drills inject synthetic pressure
        and must be able to heal it)."""
        self._signals = [(n, f) for n, f in self._signals if n != name]

    def note_queue_wait(self, seconds: float) -> None:
        """Fed by netapp's write loop with each frame's queue wait; a
        cheap EWMA (alpha keyed to governor_tau via inter-sample time)."""
        now = self.clock()
        dt = max(now - self._qwait_at, 1e-6)
        self._qwait_at = now
        alpha = 1.0 - math.exp(-dt / max(self.tun.governor_tau, 1e-3))
        self._qwait_ewma += alpha * (seconds - self._qwait_ewma)

    def _qwait_pressure(self) -> float:
        # decay toward zero while no frames flow (no samples ≠ pressure)
        idle = self.clock() - self._qwait_at
        decay = math.exp(-idle / max(self.tun.governor_tau, 1e-3))
        full = max(self.tun.governor_queue_wait_full, 1e-6)
        return (self._qwait_ewma * decay) / full

    # --- outputs ---------------------------------------------------------

    def pressure(self) -> float:
        """Max over the live signals, clamped to [0, 2] (values above 1
        all mean 'saturated'; the cap keeps a broken signal from feeding
        absurd numbers into the smoothing)."""
        p = self._qwait_pressure()
        for _name, fn in self._signals:
            try:
                p = max(p, float(fn()))
            except Exception:  # noqa: BLE001 — a dead signal is 0, not a crash
                continue
        return min(max(p, 0.0), 2.0)

    def signals(self) -> dict:
        """Per-signal snapshot for the admin API / debugging."""
        out = {"queue_wait": round(self._qwait_pressure(), 4)}
        for name, fn in self._signals:
            try:
                out[name] = round(float(fn()), 4)
            except Exception:  # noqa: BLE001
                out[name] = None
        return out

    def _target(self, p: float) -> float:
        lo, hi = self.tun.governor_low, self.tun.governor_high
        if p <= lo:
            return 1.0
        if p >= hi:
            return self.tun.governor_min_ratio
        frac = (p - lo) / max(hi - lo, 1e-6)
        return 1.0 - frac * (1.0 - self.tun.governor_min_ratio)

    def ratio(self) -> float:
        """The smoothed background rate multiplier in
        [governor_min_ratio, 1.0].  Reading advances the smoothing
        toward the instantaneous target with time constant
        governor_tau — callers (workers between iterations, the metrics
        scrape) sample often enough that no separate tick loop is
        needed."""
        now = self.clock()
        dt = max(now - self._ratio_at, 0.0)
        self._ratio_at = now
        target = self._target(self.pressure())
        alpha = 1.0 - math.exp(-dt / max(self.tun.governor_tau, 1e-3))
        self._ratio += alpha * (target - self._ratio)
        # snap when close so "recovered" is an exact 1.0, not 0.9999…
        if abs(self._ratio - target) < 1e-3:
            self._ratio = target
        return self._ratio

    def bg_pause(self, worked_s: float, cap: float = 2.0) -> float:
        """How long a background worker should sleep after a work slice
        that took `worked_s`: duty-cycle control — at ratio r the worker
        runs r of the time (sleep = worked · (1-r)/r), capped so a long
        slice cannot park a worker for minutes.  0 at full rate."""
        r = self.ratio()
        if r >= 0.999:
            return 0.0
        r = max(r, self.tun.governor_min_ratio, 1e-3)
        return min(worked_s * (1.0 - r) / r, cap)
