"""AdmissionGate — bounded, tenant-fair in-flight work at the API front door.

Past saturation a storage node has exactly two choices per new request:
queue it (converting overload into a timeout storm — every queued
request ages toward its client's deadline while making every other
request slower) or shed it immediately with a typed, retryable answer.
Garage answers 503 SlowDown; so do we, at the earliest possible point —
before signature verification, before the request trace, before a byte
of body is read — with correct S3 error XML, a RequestId (minted here,
since the shed happens before request_trace runs) and a Retry-After
hint derived from live load, not a constant.

On top of the inflight/bytes watermarks the gate is now a multi-tenant QoS layer
(docs/ROBUSTNESS.md "Multi-tenant fairness & noisy neighbors"):

  - requests are CLASSIFIED by access key (fallback: bucket, then
    "anon") into per-tenant accounting.  While the gate is contended, a
    tenant already holding at least its fair share (limit / active
    tenants) is shed typed — per-tenant, never gate-wide — so one
    abusive tenant can exhaust only its own share.
  - under-share tenants whose request finds the gate full wait in a
    BOUNDED per-tenant queue and are dispatched by weighted deficit
    round-robin with byte-sized deficits (cost = declared body bytes +
    a per-request base cost): released capacity interleaves tenants
    fairly instead of draining whoever queued first.  The wait itself
    is bounded (`tenant_queue_wait`); a waiter whose turn never comes
    sheds typed rather than aging toward its client's timeout.
  - CLUSTER-AWARE admission: the caller folds the max gossiped
    `governor_pressure` of the layout nodes the request must touch
    (RemotePressureProbe below) into the admit decision, so a gateway
    sheds at the front door on behalf of a saturated storage node
    instead of forwarding doomed work three hops (verdict
    `remote_pressure`).
  - CoDel-style ADAPTIVE watermark: the effective in-flight limit is
    derived from admitted-latency drift — sojourn above `codel_target`
    for a full `codel_interval` tightens the limit, sustained sojourn
    below it relaxes back toward the configured `max_inflight` ceiling.
  - requests with no Content-Length (chunked/streaming PUTs) are
    admitted against a conservative `streaming_body_estimate` claim and
    RECONCILED to actual bytes as the body streams (AdmissionToken
    note_body_bytes/body_done), so they no longer bypass the bytes
    watermark.
  - K2V long-polls park their slot while waiting (token.park/unpark →
    a separate long-poll pool, `api_longpoll_parked`), so N pollers
    cannot brown out PUT/GET admission for their full poll window.

Admission is still checked ONCE at intake: an admitted request is never
shed mid-flight, so streaming bodies always run to completion; the
token is released when the handler finishes, transfer included.

Single-threaded by construction (the aiohttp handlers run on one event
loop), so the counters need no locks.
"""

from __future__ import annotations

import asyncio
import math
import re
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple

from ..utils.overload import OverloadTunables

__all__ = ["AdmissionGate", "AdmissionToken", "RemotePressureProbe",
           "classify_tenant"]


# access key id out of a SigV4 Authorization header / presigned query —
# a cheap string parse, NO verification: classification only picks which
# queue a request waits in, so a forged key id merely moves the forger
# into a different (empty) queue.  Auth still happens after admission.
_CRED_RE = re.compile(r"Credential=([A-Za-z0-9._-]{1,64})/")


def classify_tenant(request, bucket: Optional[str] = None) -> str:
    """Tenant id for QoS accounting: the access key id from the
    Authorization header (or presigned X-Amz-Credential), falling back
    to the bucket for unsigned requests, then "anon".  `bucket` is the
    caller's already-parsed bucket (vhost-aware — for a vhost-style
    request the first PATH segment is the object key, not the bucket);
    without it the first path segment is used.  Pure string work — runs
    before signature verification."""
    auth = request.headers.get("Authorization", "")
    m = _CRED_RE.search(auth)
    if m:
        return m.group(1)
    try:
        cred = request.query.get("X-Amz-Credential")
    except Exception:  # noqa: BLE001 — fake requests without .query
        cred = None
    if cred:
        return cred.split("/", 1)[0][:64]
    if bucket:
        return "bucket:" + bucket[:64]
    path = getattr(request, "path", "") or ""
    seg = path.lstrip("/").split("/", 1)[0]
    if seg:
        return "bucket:" + seg[:64]
    return "anon"


class _Tenant:
    """Per-tenant accounting + the WDRR queue."""

    __slots__ = ("name", "inflight", "inflight_bytes", "deficit",
                 "queue", "parked", "admitted_total", "shed_total")

    def __init__(self, name: str):
        self.name = name
        self.inflight = 0
        self.inflight_bytes = 0
        self.deficit = 0          # WDRR byte deficit
        self.queue: deque = deque()
        self.parked = 0           # long-polls parked outside the watermark
        self.admitted_total = 0
        self.shed_total = 0

    def idle(self) -> bool:
        # a parked long-poll is LIVE state: evicting its tenant at the
        # cardinality cap would split accounting across two objects
        return self.inflight == 0 and self.parked == 0 and not self.queue


class _Waiter:
    __slots__ = ("future", "nbytes", "cost", "estimated", "t0")

    def __init__(self, future, nbytes: int, cost: int, estimated: bool,
                 t0: float):
        self.future = future
        self.nbytes = nbytes
        self.cost = cost
        self.estimated = estimated
        self.t0 = t0


# uploads bigger than this are excluded from the CoDel control law:
# their duration is dominated by the client-paced body transfer, the
# same "client-chosen duration" class as long-polls — feeding it in
# would let a healthy large-object workload strangle the limit
_CODEL_MAX_BYTES = 1 << 20


class AdmissionToken:
    """One admitted request's claim on the gate; release exactly once
    (idempotent — a finally block racing an explicit release is fine)."""

    __slots__ = ("_gate", "_tenant", "nbytes", "_released", "_parked",
                 "_estimated", "_observed", "_sojourn_excluded", "_t0",
                 "_t_body")

    def __init__(self, gate: "AdmissionGate", tenant: _Tenant, nbytes: int,
                 estimated: bool = False):
        self._gate = gate
        self._tenant = tenant
        self.nbytes = nbytes          # bytes currently accounted
        self._released = False
        self._parked = False
        self._estimated = estimated
        self._observed = 0
        self._sojourn_excluded = False
        self._t0 = gate.clock()
        self._t_body: Optional[float] = None

    def exclude_sojourn(self) -> None:
        """Keep this request out of the CoDel law: its duration is
        client-paced (streamed GET response, long-poll), not service
        latency.  Called by the streaming handlers."""
        self._sojourn_excluded = True

    def service_latency(self) -> Optional[float]:
        """Server-side service seconds so far, for the latency SLO
        (utils/slo.py) — None when this request's duration is
        client-paced (streamed response / long-poll: the client's drain
        pace must not burn the latency budget, exactly the CoDel
        exclusion).  Uploads anchor at body completion (`body_done`),
        like the CoDel sojourn, so a trickled body measures only its
        post-body service time."""
        if self._sojourn_excluded:
            return None
        start = self._t_body if self._t_body is not None else self._t0
        return self._gate.clock() - start

    def body_anchored(self) -> bool:
        """True once ``body_done`` stamped the post-body anchor — the
        only case where ``service_latency`` is a BETTER latency-SLO
        measurement than intake-to-completion (it subtracts the
        client-paced body transfer).  For everything else the intake
        anchor wins: it includes the admission queue wait, which is
        server-side latency and must burn the budget."""
        return self._t_body is not None

    # --- byte reconciliation (Content-Length-less bodies) ---------------

    def note_body_bytes(self, n: int) -> None:
        """Body bytes observed streaming in: an estimate-admitted
        request that turns out BIGGER than its claim grows its
        accounting live, so a storm of undeclared huge uploads cannot
        hide from the bytes watermark behind one conservative guess."""
        if not self._estimated or self._released:
            return
        self._observed += n
        if self._observed > self.nbytes and not self._parked:
            delta = self._observed - self.nbytes
            self._gate._inflight_bytes += delta
            self._tenant.inflight_bytes += delta
            self.nbytes = self._observed

    def body_done(self) -> None:
        """Body fully streamed.  Marks the sojourn anchor — CoDel then
        measures admit->release MINUS the body transfer, i.e. the
        server-side service latency, so a client trickling a small body
        over many seconds cannot feed its own pace into the adaptive
        watermark.  Also reconciles an estimate-admitted claim DOWN to
        the actual size so the unused claim stops blocking admits."""
        if self._released:
            return
        self._t_body = self._gate.clock()
        if not self._estimated:
            return
        self._estimated = False
        if self._observed < self.nbytes and not self._parked:
            delta = self.nbytes - self._observed
            self._gate._inflight_bytes -= delta
            self._tenant.inflight_bytes -= delta
            self.nbytes = self._observed
            self._gate._dispatch()

    # --- long-poll parking ----------------------------------------------

    def park(self) -> None:
        """Release this request's slot while it sits in a long poll: the
        parked request moves to a separate BOUNDED pool
        (`api_longpoll_parked`) so pollers do not starve the in-flight
        watermark for up to their whole poll window.  When the pool is
        full the poll simply KEEPS its admission slot — total poll
        concurrency stays bounded by the gate either way; an uncapped
        pool would let one tenant hold unbounded 600 s polls."""
        if self._released or self._parked:
            return
        g = self._gate
        cap = g._longpoll_cap()
        if cap and g._parked >= cap:
            self._sojourn_excluded = True
            return
        self._parked = True
        self._sojourn_excluded = True
        g._inflight -= 1
        g._inflight_bytes -= self.nbytes
        g._parked += 1
        self._tenant.inflight -= 1
        self._tenant.inflight_bytes -= self.nbytes
        self._tenant.parked += 1
        g._dispatch()

    def unpark(self) -> None:
        """Re-acquire after the poll wakes.  Deliberately unconditional:
        an admitted request is never shed mid-flight, so re-entry may
        transiently exceed the watermark while the (cheap) response is
        written — the alternative is a parked poller that can never
        answer on a hot gate."""
        if self._released or not self._parked:
            return
        self._parked = False
        g = self._gate
        g._parked -= 1
        g._inflight += 1
        g._inflight_bytes += self.nbytes
        self._tenant.inflight += 1
        self._tenant.inflight_bytes += self.nbytes
        self._tenant.parked -= 1

    # --- release ---------------------------------------------------------

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        g = self._gate
        if self._parked:
            self._parked = False
            g._parked -= 1
            self._tenant.parked -= 1
        else:
            g._inflight -= 1
            g._inflight_bytes -= self.nbytes
            self._tenant.inflight -= 1
            self._tenant.inflight_bytes -= self.nbytes
        # admitted-latency drift feeds the adaptive watermark — but a
        # long-poll's (or streamed transfer's) sojourn is the CLIENT's
        # chosen duration, not service latency; folding those in would
        # let a healthy slow-client workload strangle the limit.  For
        # uploads the anchor is body completion (body_done), so a
        # trickled body measures only its post-body service time.
        if not self._sojourn_excluded and self.nbytes <= _CODEL_MAX_BYTES:
            start = self._t_body if self._t_body is not None else self._t0
            g._note_sojourn(g.clock() - start)
        g._gc_tenant(self._tenant)
        g._dispatch()


class AdmissionGate:
    def __init__(self, tun: Optional[OverloadTunables] = None, metrics=None,
                 clock: Callable[[], float] = time.monotonic):
        self.tun = tun or OverloadTunables()
        self.clock = clock
        self._inflight = 0
        self._inflight_bytes = 0
        self._parked = 0
        self._waiters_total = 0
        self.admitted_total = 0
        self.shed_total = 0
        self._tenants: Dict[str, _Tenant] = {}
        self._shed_series: set = set()  # tenant labels minted in metrics
        self._rr = 0                  # WDRR round-robin start offset
        # CoDel adaptive watermark state
        self._limit = self.tun.max_inflight
        self._above_since: Optional[float] = None
        self._last_relax = clock()
        # optional live-load input for the Retry-After hint (wired to
        # LoadGovernor.pressure by model/garage.py)
        self.pressure_fn: Optional[Callable[[], float]] = None
        if metrics is not None:
            metrics.gauge(
                "api_inflight_requests",
                "Client requests currently admitted and in flight "
                "(admission-gate occupancy numerator)",
                fn=lambda: float(self._inflight))
            self.m_admission = metrics.counter(
                "api_admission_total",
                "Admission-gate verdicts at the API front door (verdict = "
                "admit | shed | over_share | queue_full | queue_timeout | "
                "remote_pressure)")
            metrics.gauge(
                "api_admission_limit",
                "Effective in-flight request limit (CoDel-adaptive, "
                "bounded by the configured max_inflight ceiling; 0 = "
                "unlimited)",
                fn=lambda: float(self.limit))
            metrics.gauge(
                "api_admission_queue_depth",
                "Requests parked in per-tenant WDRR admission queues",
                fn=lambda: float(self._waiters_total))
            metrics.gauge(
                "api_longpoll_parked",
                "Admitted long-poll requests currently parked outside "
                "the in-flight watermark",
                fn=lambda: float(self._parked))
            metrics.gauge(
                "api_tenant_inflight",
                "Admitted in-flight requests per tenant (access key or "
                "bucket fallback)",
                labeled_fn=lambda: [
                    ({"tenant": te.name}, float(te.inflight))
                    for te in self._tenants.values() if te.inflight
                ])
            self.m_tenant_shed = metrics.counter(
                "api_tenant_shed_total",
                "Requests shed per tenant at the admission gate (all "
                "shed verdicts)")
            self.m_queue_wait = metrics.histogram(
                "api_admission_queue_wait_seconds",
                "Time requests waited in the WDRR admission queue "
                "(outcome = admitted | timeout)")
        else:
            self.m_admission = None
            self.m_tenant_shed = None
            self.m_queue_wait = None

    # --- tenant bookkeeping ----------------------------------------------

    def _tenant(self, name: str) -> _Tenant:
        te = self._tenants.get(name)
        if te is None:
            # metric-cardinality bound: tenant ids come from
            # client-controlled headers, so past the cap newcomers share
            # one overflow bucket instead of minting unbounded series
            if len(self._tenants) >= max(self.tun.max_tracked_tenants, 1):
                for cand, known in list(self._tenants.items()):
                    if known.idle():
                        del self._tenants[cand]
                        break
                else:
                    return self._tenants.setdefault(
                        "~overflow", _Tenant("~overflow"))
            te = _Tenant(name)
            self._tenants[name] = te
        return te

    def _gc_tenant(self, te: _Tenant) -> None:
        # drop idle tenants so the dict (and the labelled gauge) tracks
        # the live population, not every key ever seen
        if te.idle() and self._tenants.get(te.name) is te:
            del self._tenants[te.name]

    def _active_tenants(self) -> int:
        return sum(1 for te in self._tenants.values() if not te.idle())

    def _fair_share(self, te: _Tenant) -> int:
        """This tenant's fair slice of the in-flight limit while the
        gate is contended: limit / active tenants (the requester counts
        as active even before its first admit), at least 1."""
        limit = self.limit
        if not limit:
            return 1 << 30
        active = self._active_tenants()
        if te.idle():
            active += 1
        return max(1, math.ceil(limit / max(active, 1)))

    # --- CoDel adaptive watermark ----------------------------------------

    @property
    def limit(self) -> int:
        """Effective in-flight limit: the configured ceiling, tightened
        by admitted-latency drift when CoDel is enabled.  0 = unlimited."""
        ceiling = self.tun.max_inflight
        if not ceiling or self.tun.codel_target <= 0:
            return ceiling
        return min(self._limit, ceiling)

    def _codel_floor(self) -> int:
        return max(1, self.tun.max_inflight // 8)

    def _longpoll_cap(self) -> int:
        """Parked-pool bound: configured, else 4x the inflight ceiling
        (0 only when both are unlimited)."""
        if self.tun.longpoll_max_parked:
            return self.tun.longpoll_max_parked
        return 4 * self.tun.max_inflight

    def _note_sojourn(self, sojourn: float) -> None:
        """CoDel control law on admitted-request latency: persistently
        above target for an interval → tighten the limit; persistently
        below → relax back toward the configured ceiling."""
        tun = self.tun
        if tun.codel_target <= 0 or not tun.max_inflight:
            return
        now = self.clock()
        self._limit = min(self._limit, tun.max_inflight)
        if sojourn > tun.codel_target:
            if self._above_since is None:
                self._above_since = now
            elif now - self._above_since >= tun.codel_interval:
                self._limit = max(self._codel_floor(),
                                  min(self._limit - 1,
                                      int(self._limit * 0.9)))
                self._above_since = now
                self._last_relax = now
        else:
            self._above_since = None
            if (self._limit < tun.max_inflight
                    and now - self._last_relax >= tun.codel_interval):
                self._limit = min(tun.max_inflight,
                                  self._limit
                                  + max(1, tun.max_inflight // 10))
                self._last_relax = now

    # --- the gate ---------------------------------------------------------

    def _capacity_free(self, nbytes: int) -> bool:
        limit = self.limit
        if limit and self._inflight >= limit:
            return False
        t = self.tun
        if (t.max_inflight_bytes and self._inflight > 0
                and self._inflight_bytes + nbytes > t.max_inflight_bytes):
            return False
        return True

    def _admit_now(self, te: _Tenant, nbytes: int,
                   estimated: bool = False) -> AdmissionToken:
        self._inflight += 1
        self._inflight_bytes += nbytes
        te.inflight += 1
        te.inflight_bytes += nbytes
        te.admitted_total += 1
        self.admitted_total += 1
        if self.m_admission is not None:
            self.m_admission.inc(verdict="admit")
        return AdmissionToken(self, te, nbytes, estimated=estimated)

    def _shed(self, te: Optional[_Tenant], verdict: str) -> None:
        self.shed_total += 1
        if te is not None:
            te.shed_total += 1
            if self.m_tenant_shed is not None:
                # counter series are immortal, so the cardinality bound
                # must hold over every tenant name EVER shed, not just
                # the live dict (which GCs idle tenants immediately):
                # forged rotating key ids collapse into ~overflow
                label = te.name
                if label not in self._shed_series:
                    if (len(self._shed_series)
                            >= max(self.tun.max_tracked_tenants, 1)):
                        label = "~overflow"
                    else:
                        self._shed_series.add(label)
                self.m_tenant_shed.inc(tenant=label)
            self._gc_tenant(te)
        if self.m_admission is not None:
            self.m_admission.inc(verdict=verdict)

    def try_admit(self, nbytes: int = 0,
                  tenant: str = "anon") -> Optional[AdmissionToken]:
        """Synchronous fast path (the plain watermark semantics): admit when the
        watermarks allow and nobody is queued, shed otherwise.  Watermark
        0 = unlimited.  The bytes watermark never sheds when the gate is
        empty — one over-sized request must degrade to "admitted alone",
        not to a permanently unservable request class."""
        te = self._tenant(tenant)
        if self._waiters_total == 0 and self._capacity_free(nbytes):
            return self._admit_now(te, nbytes)
        self._shed(te, "shed")
        return None

    async def admit(self, nbytes: int = 0, tenant: str = "anon",
                    remote_pressure: float = 0.0,
                    estimated: bool = False,
                    ) -> Tuple[Optional[AdmissionToken], str]:
        """Full tenant-fair admission → (token, verdict).  token None
        means shed; verdict names why (`remote_pressure`, `over_share`,
        `queue_full`, `queue_timeout`).  An under-share tenant that
        finds the gate contended waits in its bounded queue and is
        dispatched by WDRR as capacity frees."""
        tun = self.tun
        # cluster-aware shed BEFORE any local accounting: the layout
        # nodes this request must touch are saturated, so forwarding is
        # doomed work — shed on their behalf at the front door
        if (tun.remote_pressure_shed > 0
                and remote_pressure >= tun.remote_pressure_shed):
            self._shed(self._tenant(tenant), "remote_pressure")
            return None, "remote_pressure"
        te = self._tenant(tenant)
        if self._waiters_total == 0 and self._capacity_free(nbytes):
            return self._admit_now(te, nbytes, estimated=estimated), "admit"
        # contended: a tenant at/over its fair share is shed typed — the
        # per-tenant isolation invariant (never gate-wide).  Parked
        # long-polls count as usage here: a tenant hogging the parked
        # pool must not ALSO claim fresh slots while others queue.
        if self.limit and te.inflight + te.parked >= self._fair_share(te):
            self._shed(te, "over_share")
            return None, "over_share"
        if len(te.queue) >= max(tun.tenant_queue_len, 1):
            self._shed(te, "queue_full")
            return None, "queue_full"
        fut = asyncio.get_running_loop().create_future()
        w = _Waiter(fut, nbytes,
                    nbytes + max(tun.wdrr_request_cost, 1),
                    estimated, self.clock())
        te.queue.append(w)
        self._waiters_total += 1
        self._dispatch()
        # the queue wait SPENDS the request's deadline budget (armed by
        # the API servers before admission): a 0.5 s budget must bound
        # the whole server-side latency, queueing included — never add
        # tenant_queue_wait on top of it
        from ..utils.tracing import remaining_budget

        wait = max(tun.tenant_queue_wait, 0.001)
        rem = remaining_budget()
        if rem is not None:
            wait = min(wait, max(rem, 0.001))
        try:
            if not fut.done():
                await asyncio.wait({fut}, timeout=wait)
        except asyncio.CancelledError:
            # the client gave up while we were queued — but _dispatch may
            # have fulfilled the future in the same window: that token
            # already holds a slot and nobody else will release it
            if fut.done() and not fut.cancelled():
                fut.result().release()
            else:
                self._discard_waiter(te, w)
            raise
        if fut.done() and not fut.cancelled():
            if self.m_queue_wait is not None:
                self.m_queue_wait.observe(self.clock() - w.t0,
                                          outcome="admitted")
            return fut.result(), "admit"
        # our turn never came within the bounded wait: shed typed
        # instead of aging toward the client's timeout
        self._discard_waiter(te, w)
        if self.m_queue_wait is not None:
            self.m_queue_wait.observe(self.clock() - w.t0, outcome="timeout")
        self._shed(te, "queue_timeout")
        return None, "queue_timeout"

    def _discard_waiter(self, te: _Tenant, w: _Waiter) -> None:
        try:
            te.queue.remove(w)
            self._waiters_total -= 1
        except ValueError:
            pass                      # already dispatched
        w.future.cancel()

    def _dispatch(self) -> None:
        """WDRR over the tenants with queued waiters: each visited
        tenant's deficit grows by the quantum (clamped so an idle wait
        cannot bank unbounded credit) and its queue head is served while
        the deficit covers the request's byte cost and capacity is free.
        Serving order rotates so no tenant owns the first visit."""
        if not self._waiters_total:
            return
        quantum = max(self.tun.wdrr_quantum_bytes, 1)
        while True:
            served = False
            starved: list = []        # (tenant, head) blocked on deficit only
            names = [n for n, te in self._tenants.items() if te.queue]
            if not names:
                break
            r = self._rr % len(names)
            for name in names[r:] + names[:r]:
                te = self._tenants.get(name)
                if te is None:
                    continue
                # drop waiters whose clients already gave up
                while te.queue and (te.queue[0].future.cancelled()
                                    or te.queue[0].future.done()):
                    te.queue.popleft()
                    self._waiters_total -= 1
                if not te.queue:
                    te.deficit = 0
                    continue
                # the deficit grows only on a genuine SERVICE OPPORTUNITY
                # (capacity available for this head): a full gate must
                # not bank credit for whoever enqueued first, or byte
                # weighting degenerates into FIFO
                if not self._capacity_free(te.queue[0].nbytes):
                    continue
                te.deficit = min(te.deficit + quantum,
                                 te.queue[0].cost + quantum)
                while te.queue:
                    w = te.queue[0]
                    if w.future.cancelled() or w.future.done():
                        te.queue.popleft()
                        self._waiters_total -= 1
                        continue
                    if w.cost > te.deficit or not self._capacity_free(
                            w.nbytes):
                        break
                    te.queue.popleft()
                    self._waiters_total -= 1
                    te.deficit -= w.cost
                    w.future.set_result(self._admit_now(
                        te, w.nbytes, estimated=w.estimated))
                    served = True
                if not te.queue:
                    te.deficit = 0
                elif self._capacity_free(te.queue[0].nbytes):
                    # capacity is free but this head still lacks deficit:
                    # more WDRR rounds will grow it — stopping here would
                    # strand a big request behind free capacity forever
                    starved.append((te, te.queue[0]))
            self._rr += 1
            if not served:
                if not starved:
                    break
                # every remaining eligible head is blocked on deficit
                # alone, and nothing changes between such rounds — so
                # fast-forward the k identical rounds it would take the
                # closest head to afford service, in one step (crediting
                # k quanta to EVERY starved tenant keeps the round-by-
                # round ordering exactly), instead of spinning
                # O(cost/quantum) synchronous loop iterations on the
                # event loop for one large body
                k = max(1, min(
                    -(-(h.cost - te.deficit) // quantum)
                    for te, h in starved))
                for te, h in starved:
                    te.deficit = min(te.deficit + k * quantum,
                                     h.cost + quantum)

    # --- shed backoff hint -----------------------------------------------

    def retry_after_hint(self) -> int:
        """Retry-After seconds derived from live load — governor
        pressure (when wired) or gate occupancy, plus queued depth — so
        client backoff tracks actual saturation instead of a constant;
        clamped to [retry_after, retry_after_max]."""
        base = max(int(self.tun.retry_after), 1)
        load = self.occupancy()
        if self.pressure_fn is not None:
            try:
                load = max(load, float(self.pressure_fn()))
            except Exception:  # noqa: BLE001 — a dead signal is no signal
                pass
        limit = self.limit or 64
        hint = base + int(base * 2 * min(load, 2.0)) \
            + self._waiters_total // max(limit, 1)
        return max(base, min(hint, max(self.tun.retry_after_max, base)))

    # --- introspection (governor signal + admin API) ----------------------

    @property
    def inflight(self) -> int:
        return self._inflight

    @property
    def inflight_bytes(self) -> int:
        return self._inflight_bytes

    @property
    def longpoll_parked(self) -> int:
        return self._parked

    def occupancy(self) -> float:
        """Gate fullness in [0, 1] — the load governor's primary
        foreground-pressure signal.  Max of the two watermark ratios
        (against the EFFECTIVE, CoDel-adjusted limit); 0 when both
        watermarks are disabled."""
        t = self.tun
        occ = 0.0
        limit = self.limit
        if limit:
            occ = self._inflight / limit
        if t.max_inflight_bytes:
            occ = max(occ, self._inflight_bytes / t.max_inflight_bytes)
        return occ

    def tenant_stats(self) -> dict:
        return {
            te.name: {
                "inflight": te.inflight,
                "inflight_bytes": te.inflight_bytes,
                "queued": len(te.queue),
                "admitted_total": te.admitted_total,
                "shed_total": te.shed_total,
            }
            for te in self._tenants.values()
        }

    def stats(self) -> dict:
        return {
            "inflight": self._inflight,
            "inflight_bytes": self._inflight_bytes,
            "admitted_total": self.admitted_total,
            "shed_total": self.shed_total,
            "max_inflight": self.tun.max_inflight,
            "max_inflight_bytes": self.tun.max_inflight_bytes,
            "effective_limit": self.limit,
            "queued": self._waiters_total,
            "longpoll_parked": self._parked,
            "tenants": self._active_tenants(),
        }


class RemotePressureProbe:
    """Bucket name → the max gossiped `governor_pressure` of the layout
    nodes that bucket's metadata partition lives on.

    The gateway cannot know a bucket's id before authentication resolves
    it, so the probe keeps a small name → id cache populated by the
    dispatch path after each successful resolve; the FIRST request for a
    bucket pays no remote check, every later one folds the gossiped
    pressure of its placement nodes into admission — cheap (a dict get
    plus a ring lookup), before any signature/body work."""

    def __init__(self, system, cache_max: int = 4096):
        self.system = system
        self.cache_max = cache_max
        self._ids: Dict[str, bytes] = {}

    def note_bucket(self, name: str, bucket_id) -> None:
        bid = bytes(bucket_id)
        if self._ids.get(name) == bid:
            return
        # overwrite on a changed id: a bucket deleted and recreated
        # under the same name moves to a new placement — keeping the
        # stale mapping would shed for the wrong nodes forever
        if name not in self._ids and len(self._ids) >= self.cache_max:
            self._ids.pop(next(iter(self._ids)))
        self._ids[name] = bid

    def pressure(self, bucket_name: Optional[str]) -> Tuple[float, str]:
        """→ (max remote pressure, hex id of the hottest node); (0, "")
        when the bucket is unknown or no peer has gossiped pressure."""
        if not bucket_name:
            return 0.0, ""
        bid = self._ids.get(bucket_name)
        if bid is None:
            return 0.0, ""
        sys_ = self.system
        try:
            nodes = sys_.ring.get_nodes(
                bid, sys_.replication_mode.replication_factor)
        except Exception:  # noqa: BLE001 — ring not ready yet
            return 0.0, ""
        worst, who = 0.0, ""
        for n in nodes:
            if bytes(n) == bytes(sys_.id):
                continue              # local pressure is the local gate's job
            p = sys_.peer_pressure(n)
            if p > worst:
                worst, who = p, bytes(n).hex()[:16]
        return worst, who
