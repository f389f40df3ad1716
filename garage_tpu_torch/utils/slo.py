"""SLO engine — declarative per-endpoint objectives, multi-window burn
rates, error budgets.

Every robustness and performance claim this repo makes ("zero client
errors through the drill", "p99 held within 3x") has so far been judged
ad hoc, per script.  This module gives the judgement a standing
definition: a per-endpoint **availability** objective (fraction of
requests that must not fail server-side — 5xx, sheds, deadline
expiries) and a **latency-threshold** objective (fraction of successful
requests that must finish under a bound), both tracked as *burn rates*
over a fast and a slow window (the multi-window multi-burn-rate
alerting shape from the SRE literature):

    burn = (bad fraction observed in window) / (1 - target)

burn 1.0 means the error budget is being spent exactly at the rate
that exhausts it over the budget window; burn >= ``fast_burn_threshold``
over the fast window is a page-now signal — and here, the trigger that
snapshots an incident flight-recorder bundle (utils/flightrec.py)
while the evidence still exists.

The tracker is fed directly by the API front doors (S3 + K2V) at
request completion — sheds included, so admission verdicts burn the
availability budget like any other server-side failure — and keeps its
own time-bucketed ring per endpoint (cumulative Prometheus histograms
cannot answer "what happened in the last 5 minutes" process-side
without snapshot diffing).  Injectable clock; everything bounded
(buckets per endpoint, endpoints tracked).

Exported: ``slo_error_budget_remaining{endpoint,slo}`` and
``slo_burn_rate{endpoint,slo,window}``; read side is admin
``slo_status`` / CLI ``slo status`` and the per-phase ``slo_report``
block bench.py embeds.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

__all__ = ["SloTunables", "SloTracker"]


@dataclass
class SloTunables:
    """``[slo]`` — objectives + windows
    (docs/OBSERVABILITY.md "Fleet health & SLOs")."""

    # burn-rate windows: fast (page-now) and slow (budget) — the slow
    # window doubles as the budget-remaining horizon
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    # ring bucket width; ring length = slow_window_s / bucket_s
    bucket_s: float = 10.0
    # fast-window burn at/above this triggers the incident capture
    # (14 ~ the classic "2% of a 30d budget in 1h" page threshold)
    fast_burn_threshold: float = 14.0
    # events needed in the fast window before a breach verdict (one
    # failed request in an idle second must not page)
    min_events: int = 10
    # objectives applied to every endpoint not explicitly listed
    default_availability: float = 0.999
    default_latency_ms: float = 2000.0
    # per-endpoint overrides: [{endpoint, availability?, latency_ms?}]
    # (TOML: [[slo.objective]] tables)
    objectives: List[dict] = field(default_factory=list)
    # distinct endpoints tracked (cardinality bound; extras share one
    # "~overflow" series like the tenant tracker)
    max_endpoints: int = 64


class _Ring:
    """Per-endpoint time-bucketed counters:
    [bucket_start, total, err, slow]."""

    __slots__ = ("buckets",)

    def __init__(self, maxlen: int):
        self.buckets: deque = deque(maxlen=maxlen)

    def add(self, start: float, err: bool, slow: bool) -> None:
        b = self.buckets[-1] if self.buckets else None
        if b is None or b[0] != start:
            b = [start, 0, 0, 0]
            self.buckets.append(b)
        b[1] += 1
        b[2] += 1 if err else 0
        b[3] += 1 if slow else 0

    def window(self, now: float, window_s: float) -> tuple:
        """(total, err, slow) over buckets younger than window_s."""
        cut = now - window_s
        total = err = slow = 0
        for start, t, e, s in self.buckets:
            if start > cut:
                total += t
                err += e
                slow += s
        return total, err, slow


class SloTracker:
    """One per node.  ``note(endpoint, seconds, ok)`` at every request
    completion; reads are burn rates / budgets per (endpoint, slo)."""

    def __init__(self, tun: Optional[SloTunables] = None, metrics=None,
                 clock: Callable[[], float] = time.monotonic,
                 on_fast_burn: Optional[Callable[[str, str, float], None]] = None):
        self.tun = tun or SloTunables()
        self.clock = clock
        self.on_fast_burn = on_fast_burn
        self._rings: Dict[str, _Ring] = {}
        self._maxlen = max(2, int(self.tun.slow_window_s
                                  / max(self.tun.bucket_s, 0.001)) + 2)
        # per-endpoint objectives resolved once (config is immutable);
        # _resolved memoizes the {availability, latency_s} dicts so the
        # per-request note() path allocates nothing (bounded: callers
        # pass ring keys, capped at max_endpoints, plus the overrides)
        self._overrides = {
            str(o.get("endpoint")): o for o in self.tun.objectives
            if o.get("endpoint")
        }
        self._resolved: Dict[str, dict] = {}
        # last breach-check bucket per endpoint (one check per bucket,
        # not per request) and last breach signalled (re-arms when the
        # burn drops back under the threshold)
        self._checked_bucket: Dict[str, float] = {}
        self._breached: Dict[str, set] = {}
        self.fast_burn_breaches = 0
        if metrics is not None:
            metrics.gauge(
                "slo_error_budget_remaining",
                "Fraction of the slow-window error budget left per "
                "endpoint and objective (1 = untouched, <= 0 = spent)",
                labeled_fn=self._budget_samples)
            metrics.gauge(
                "slo_burn_rate",
                "Error-budget burn rate per endpoint, objective and "
                "window (1 = spending exactly the budget; >> 1 = "
                "budget-exhausting incident)",
                labeled_fn=self._burn_samples)

    # --- objectives ------------------------------------------------------

    def objective(self, endpoint: str) -> dict:
        obj = self._resolved.get(endpoint)
        if obj is None:
            o = self._overrides.get(endpoint, {})
            obj = self._resolved[endpoint] = {
                "availability": float(
                    o.get("availability", self.tun.default_availability)),
                "latency_s": float(
                    o.get("latency_ms",
                          self.tun.default_latency_ms)) / 1000.0,
            }
        return obj

    # --- ingest ----------------------------------------------------------

    def note(self, endpoint: str, seconds: float, ok: bool,
             client_paced: bool = False) -> None:
        """One finished request: `ok` False = server-side failure (5xx,
        shed, deadline) burning availability; a SLOW success (duration
        past the endpoint's latency threshold) burns the latency SLO.
        `client_paced` requests (long-polls, streamed transfers whose
        duration is the client's drain pace — the front doors derive it
        from the admission token's CoDel exclusion) still count toward
        availability but never mark slow: a healthy big-object or
        long-poll workload must not burn the latency budget."""
        ring = self._rings.get(endpoint)
        if ring is None:
            if len(self._rings) >= self.tun.max_endpoints:
                endpoint = "~overflow"
                ring = self._rings.get(endpoint)
            if ring is None:
                ring = self._rings[endpoint] = _Ring(self._maxlen)
        now = self.clock()
        start = now - (now % max(self.tun.bucket_s, 0.001))
        slow = (ok and not client_paced
                and seconds > self.objective(endpoint)["latency_s"])
        ring.add(start, err=not ok, slow=slow)
        self._maybe_breach(endpoint, ring, now, start,
                           bad_avail=not ok, bad_slow=slow)

    def _maybe_breach(self, endpoint: str, ring: _Ring, now: float,
                      bucket: float, bad_avail: bool = False,
                      bad_slow: bool = False) -> None:
        """Healthy traffic re-evaluates once per bucket (the window scan
        must not run per request), but a BAD event whose OWN objective
        is not yet latched re-evaluates immediately: an error burst
        confined to a single bucket — then silence — must still fire
        the breach (and its incident capture) at the moment the budget
        burns, not if and when a later bucket's first event happens to
        look back.  Once the burning objective is latched, its bad
        events fall back to the per-bucket cadence (the scan is O(ring)
        and errors are the common case mid-incident — an availability
        storm must not pay the scan per failure for its whole
        duration)."""
        if self.on_fast_burn is None:
            return
        latched = self._breached.get(endpoint, ())
        recheck = ((bad_avail and "availability" not in latched)
                   or (bad_slow and "latency" not in latched))
        if self._checked_bucket.get(endpoint) == bucket and not recheck:
            return
        self._checked_bucket[endpoint] = bucket
        total, err, slow = ring.window(now, self.tun.fast_window_s)
        if total < self.tun.min_events:
            return
        obj = self.objective(endpoint)
        breached = self._breached.setdefault(endpoint, set())
        for slo, n_bad, target in (("availability", err,
                                    obj["availability"]),
                                   ("latency", slow,
                                    obj["availability"])):
            budget = max(1.0 - target, 1e-9)
            burn = (n_bad / total) / budget
            if burn >= self.tun.fast_burn_threshold:
                if slo not in breached:
                    breached.add(slo)
                    self.fast_burn_breaches += 1
                    try:
                        self.on_fast_burn(endpoint, slo, burn)
                    except Exception:  # noqa: BLE001 — never break serving
                        pass
            else:
                breached.discard(slo)  # re-arm once the burn subsides

    # --- read side -------------------------------------------------------

    def burn_rate(self, endpoint: str, slo: str, window_s: float) -> float:
        ring = self._rings.get(endpoint)
        if ring is None:
            return 0.0
        total, err, slow = ring.window(self.clock(), window_s)
        if total == 0:
            return 0.0
        obj = self.objective(endpoint)
        bad = err if slo == "availability" else slow
        return (bad / total) / max(1.0 - obj["availability"], 1e-9)

    def budget_remaining(self, endpoint: str, slo: str) -> float:
        """1 - (bad events / allowed bad events) over the slow window;
        1.0 with no traffic, negative when the budget is overspent."""
        ring = self._rings.get(endpoint)
        if ring is None:
            return 1.0
        total, err, slow = ring.window(self.clock(), self.tun.slow_window_s)
        if total == 0:
            return 1.0
        obj = self.objective(endpoint)
        allowed = total * max(1.0 - obj["availability"], 1e-9)
        bad = err if slo == "availability" else slow
        return round(1.0 - bad / allowed, 6)

    def _budget_samples(self):
        return [
            ({"endpoint": ep, "slo": slo},
             self.budget_remaining(ep, slo))
            for ep in sorted(self._rings)
            for slo in ("availability", "latency")
        ]

    def _burn_samples(self):
        out = []
        for ep in sorted(self._rings):
            for slo in ("availability", "latency"):
                out.append((
                    {"endpoint": ep, "slo": slo, "window": "fast"},
                    round(self.burn_rate(ep, slo, self.tun.fast_window_s), 6)))
                out.append((
                    {"endpoint": ep, "slo": slo, "window": "slow"},
                    round(self.burn_rate(ep, slo, self.tun.slow_window_s), 6)))
        return out

    def report(self) -> Dict[str, dict]:
        """Raw per-endpoint window counts — bench.py aggregates these
        across cluster nodes into its per-phase ``slo_report`` (burn
        rates must be recomputed over the MERGED counts, not averaged)."""
        now = self.clock()
        out: Dict[str, dict] = {}
        for ep, ring in self._rings.items():
            obj = self.objective(ep)
            ft, fe, fs = ring.window(now, self.tun.fast_window_s)
            st, se, ss = ring.window(now, self.tun.slow_window_s)
            out[ep] = {
                "availability_target": obj["availability"],
                "latency_target_ms": round(obj["latency_s"] * 1000.0, 1),
                "fast": {"total": ft, "err": fe, "slow": fs},
                "slow": {"total": st, "err": se, "slow": ss},
            }
        return out

    def status(self) -> List[dict]:
        """Budget-table rows for admin ``slo_status`` / CLI
        ``slo status`` — one row per (endpoint, objective)."""
        rows = []
        for ep in sorted(self._rings):
            obj = self.objective(ep)
            ring = self._rings[ep]
            total, err, slow = ring.window(self.clock(),
                                           self.tun.slow_window_s)
            for slo, bad, target_str in (
                    ("availability", err, f"{obj['availability']:.4f}"),
                    ("latency", slow,
                     f"p<{obj['latency_s'] * 1000:.0f}ms")):
                fast = self.burn_rate(ep, slo, self.tun.fast_window_s)
                slow_b = self.burn_rate(ep, slo, self.tun.slow_window_s)
                rows.append({
                    "endpoint": ep,
                    "slo": slo,
                    "target": target_str,
                    "events": total,
                    "bad": bad,
                    "burn_fast": round(fast, 3),
                    "burn_slow": round(slow_b, 3),
                    "budget_remaining": self.budget_remaining(ep, slo),
                    "worst_window": ("fast" if fast >= slow_b else "slow"),
                })
        return rows
