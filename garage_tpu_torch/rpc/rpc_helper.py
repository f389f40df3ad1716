"""RpcHelper — the quorum fan-out engine.

Equivalent of reference src/rpc/rpc_helper.rs:37-435: `try_call_many` has
two modes (rpc_helper.rs:263-390):

  - **reads** (interrupt_after_quorum): requests go out in *latency order*
    (self first, then lowest ping EWMA) with only `quorum` requests in
    flight; a failure launches the next candidate; outstanding requests are
    cancelled the moment quorum is reached — 1 network RTT in the common
    case, no wasted traffic.
  - **writes** (all-sent): requests go to every replica at once; the call
    returns at quorum; stragglers keep running in a background drain task
    so all replicas converge without delaying the caller.

Degraded-mode resilience (this repo's addition; docs/ROBUSTNESS.md): every
per-node dispatch runs through one policy gate that layers

  1. **adaptive per-peer timeouts** — clamped ``base + k·rtt`` from the
     peering RTT EWMA, static strategy timeout as fallback and ceiling, so
     a blackholed peer (accepts, never responds) costs ~2 s, not 30;
  2. **bounded retries with full-jitter backoff** for idempotent calls
     (``rs_idempotent``), transport errors only, under a per-fan-out
     budget — a node yields exactly ONE outcome no matter how many
     attempts, so quorum math never double-counts;
  3. **read hedging** — when a quorum-read wave is slower than the
     endpoint's observed latency quantile (reuse rpc_duration_seconds),
     the next latency-ordered candidate launches speculatively and the
     loser is cancelled at quorum;
  4. the **per-peer circuit breaker** (net/peering.py) — open peers sort
     last in request_order and fast-fail (PeerUnavailable) instead of
     burning a timeout; call outcomes feed the breaker back.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

from ..utils.data import FixedBytes32
from ..utils.error import (
    DeadlineExceeded,
    PeerUnavailable,
    QuorumError,
    RpcError,
    ZoneQuorumError,
    error_code,
)
from ..utils.tracing import clamp_to_budget, deadline_expired, remaining_budget
from ..net.frame import PRIO_NORMAL
from ..net.netapp import Endpoint, NetApp
from ..net.peering import FullMeshPeering
from ..net.resilience import (
    ResilienceTunables,
    adaptive_timeout,
    full_jitter_backoff,
    is_transport_error,
)

logger = logging.getLogger("garage_tpu_torch.rpc.helper")

NodeID = FixedBytes32


@dataclass
class RequestStrategy:
    """(ref rpc_helper.rs:37-53, extended with the resilience knobs)"""

    rs_quorum: int = 1
    rs_interrupt_after_quorum: bool = False  # reads: stop once quorum is in
    rs_priority: int = PRIO_NORMAL
    rs_timeout: Optional[float] = 30.0       # static fallback + ceiling
    # resilience (defaults resolve against the helper's tunables):
    rs_idempotent: bool = False         # safe to retry (reads/probes only)
    rs_retries: Optional[int] = None    # None → tunables.retry_max if idempotent
    rs_adaptive_timeout: bool = True    # per-peer base + k·rtt clamp
    rs_hedge: bool = True               # speculative next-candidate on slow wave
    rs_hedge_delay: Optional[float] = None  # None → latency-quantile derived
    # writes only: the acked replica set must span at least this many
    # distinct zones (0/1 = availability-first, no topology check).
    # Callers resolve it via System.write_zone_requirement so it is
    # never larger than the candidate set can actually span.
    rs_required_zones: int = 0


class _RetryBudget:
    """Caps TOTAL retries across one logical fan-out: per-node retry
    loops stay bounded even when every replica flaps at once (N nodes ×
    retry_max would otherwise multiply tail latency under correlated
    failure — the regime retries exist to escape, not amplify)."""

    __slots__ = ("left",)

    def __init__(self, total: int):
        self.left = total

    def take(self) -> bool:
        if self.left <= 0:
            return False
        self.left -= 1
        return True


class RpcHelper:
    def __init__(self, netapp: NetApp, peering: FullMeshPeering, metrics=None,
                 tracer=None, tunables: Optional[ResilienceTunables] = None):
        self.netapp = netapp
        self.peering = peering
        self.our_id = netapp.id
        self.tunables = tunables or peering.tunables
        self._drain_tasks: set = set()
        self._rng = random.Random()
        self.tracer = tracer
        # topology source (set by System once the layout is known): zone
        # of a peer / of this node, from the COMMITTED layout.  Defaults
        # answer None, which keeps every zone feature inert — bare
        # RpcHelper uses (tests, CLI clients) behave exactly as before.
        self.zone_of: Callable[[NodeID], Optional[str]] = lambda _n: None
        self.local_zone: Callable[[], Optional[str]] = lambda: None
        # fleet-health sources (set by System once built): gossiped
        # load-governor pressure and the fail-slow verdict per peer.
        # Defaults keep every health feature inert — bare RpcHelper uses
        # (tests, CLI clients) rank exactly as before.
        self.pressure_of: Callable[[NodeID], float] = lambda _n: 0.0
        self.fail_slow_of: Callable[[NodeID], bool] = lambda _n: False
        # per-peer service-time feed for the fail-slow scorer
        # (utils/health_score.py): called with (node, endpoint, seconds)
        # for every COMPLETED call — the same timings that land in
        # rpc_duration_seconds, with the peer dimension the histogram
        # lacks
        self.health_note: Optional[
            Callable[[NodeID, str, float], None]] = None
        # per-RPC counters + latency histogram (ref rpc/metrics.rs:38)
        if metrics is not None:
            self.m_requests = metrics.counter(
                "rpc_request_counter", "Number of RPC requests emitted")
            self.m_errors = metrics.counter(
                "rpc_error_counter", "Number of failed RPC requests")
            self.m_timeouts = metrics.counter(
                "rpc_timeout_counter", "Number of RPC timeouts")
            self.m_duration = metrics.histogram(
                "rpc_duration_seconds", "Duration of RPCs")
            self.m_retries = metrics.counter(
                "rpc_retry_total",
                "RPC attempts retried after a retryable failure")
            self.m_hedges = metrics.counter(
                "rpc_hedge_total",
                "Speculative (hedged) quorum-read requests launched")
            self.m_adaptive = metrics.histogram(
                "rpc_adaptive_timeout_seconds",
                "Adaptive per-peer timeout chosen for outgoing RPCs")
            self.m_zone_requorum = metrics.counter(
                "rpc_zone_requorum_total",
                "Quorum writes that waited past their numeric quorum "
                "for acks to span the required zones")
            self.m_zone_errors = metrics.counter(
                "rpc_zone_quorum_error_total",
                "Quorum writes failed because the acked replica set "
                "never spanned the required zones (ZoneQuorumError)")
            self.m_deadline = metrics.counter(
                "rpc_deadline_exceeded_total",
                "RPC dispatches shed or aborted because the request's "
                "end-to-end deadline budget ran out")
        else:
            self.m_requests = self.m_errors = None
            self.m_timeouts = self.m_duration = None
            self.m_retries = self.m_hedges = self.m_adaptive = None
            self.m_zone_requorum = self.m_zone_errors = None
            self.m_deadline = None

    def set_zone_source(self, zone_of: Callable[[NodeID], Optional[str]],
                        local_zone: Callable[[], Optional[str]]) -> None:
        """Thread the committed layout's topology in (System calls this
        once at construction; the callables read live state, so a layout
        change needs no re-wiring)."""
        self.zone_of = zone_of
        self.local_zone = local_zone

    def set_health_source(
        self,
        pressure_of: Callable[[NodeID], float],
        fail_slow_of: Callable[[NodeID], bool],
        note: Optional[Callable[[NodeID, str, float], None]] = None,
    ) -> None:
        """Thread the fleet-health plane in (System wires this next to
        the zone source): gossiped pressure + fail-slow verdicts feed
        peer_rank, and every completed call's service time feeds the
        comparative scorer via `note`."""
        self.pressure_of = pressure_of
        self.fail_slow_of = fail_slow_of
        self.health_note = note

    def _feed_health(self, node: NodeID, endpoint_path: str,
                     seconds: float) -> None:
        if self.health_note is None or node == self.our_id:
            return
        try:
            self.health_note(node, endpoint_path, seconds)
        except Exception:  # noqa: BLE001 — scoring must never break calls
            pass

    def _instrument(self, endpoint_path: str, coro_fn):
        """Wrap one RPC attempt with counters + duration (the reference's
        RecordDuration + per-call metrics, rpc_helper.rs:238-260)."""
        if self.m_requests is None:
            return coro_fn

        async def timed(*a, **kw):
            import time as _time

            self.m_requests.inc(endpoint=endpoint_path)
            t0 = _time.perf_counter()
            try:
                return await coro_fn(*a, **kw)
            except Exception as e:
                # the error label is the structured wire code (satellite:
                # K_ERR/K_RESP carry a code, so remote domain errors keep
                # their type here instead of collapsing into one bucket).
                # Timeout flavor matched by CODE, not class: the netapp
                # layer raises the typed TimeoutError_ (an RpcError), which
                # a bare `except asyncio.TimeoutError` would never see
                code = error_code(e)
                if code == "Timeout":
                    self.m_timeouts.inc(endpoint=endpoint_path)
                elif code == "DeadlineExceeded" and self.m_deadline is not None:
                    self.m_deadline.inc(endpoint=endpoint_path)
                self.m_errors.inc(endpoint=endpoint_path, error=code)
                raise
            finally:
                self.m_duration.observe(
                    _time.perf_counter() - t0, endpoint=endpoint_path
                )

        return timed

    # --- resilience primitives (shared with block/manager.py streaming) ---

    def timeout_for(self, node: NodeID, static: Optional[float],
                    adaptive: bool = True) -> Optional[float]:
        """Per-peer timeout: clamped base + k·rtt from the ping EWMA,
        static fallback for self/unknown peers, static as the ceiling."""
        if not adaptive or node == self.our_id:
            return static
        t = adaptive_timeout(self.peering.latency(node), static, self.tunables)
        if t is not None and t != static and self.m_adaptive is not None:
            self.m_adaptive.observe(t)
        return t

    def peer_allows(self, node: NodeID) -> bool:
        """Circuit-breaker gate (self-calls always pass).  A True answer
        may consume the half-open probe slot — report the call's outcome
        via note_result."""
        if node == self.our_id:
            return True
        return self.peering.breaker_allows(node)

    def note_result(self, node: NodeID, err: Optional[BaseException]) -> None:
        """Feed a call outcome back to the peer's breaker.  Only transport
        errors count against the peer; a domain error (NoSuchBlock from a
        live handler) proves the path works."""
        if node == self.our_id:
            return
        if err is None:
            self.peering.record_rpc_success(node)
        elif isinstance(err, (asyncio.CancelledError, DeadlineExceeded)):
            # no verdict about the peer: a cancelled call never finished,
            # and a deadline expiry indicts the caller's budget — either
            # way, only release a consumed half-open probe slot
            self.peering.breaker_release(node)
        elif is_transport_error(err):
            self.peering.record_rpc_failure(node)
        else:
            self.peering.record_rpc_success(node)

    def _hedge_delay(self, endpoint_path: str,
                     strategy: RequestStrategy) -> Optional[float]:
        """How long a quorum-read wave may run before the next candidate
        launches speculatively: the endpoint's observed latency quantile
        (needs hedge_min_samples history), or the caller's explicit
        rs_hedge_delay.  None disables hedging for this call."""
        if not strategy.rs_hedge:
            return None
        if strategy.rs_hedge_delay is not None:
            return max(strategy.rs_hedge_delay, 0.001)
        if self.m_duration is None:
            return None
        d = self.m_duration.quantile(
            self.tunables.hedge_quantile,
            min_count=self.tunables.hedge_min_samples,
            endpoint=endpoint_path,
        )
        return max(d, 0.001) if d is not None else None

    async def _call_policied(
        self,
        endpoint_path: str,
        node: NodeID,
        raw_call: Callable[[Optional[float]], Any],
        strategy: RequestStrategy,
        budget: Optional[_RetryBudget] = None,
    ) -> Any:
        """ONE logical call to one node: breaker gate → adaptive timeout →
        instrumented attempt → bounded full-jitter retries (idempotent +
        transport errors only).  Exactly one outcome per node regardless
        of attempts, so quorum accounting upstream stays per-node."""
        retries = strategy.rs_retries
        if retries is None:
            retries = self.tunables.retry_max if strategy.rs_idempotent else 0
        attempt = 0
        while True:
            # deadline gate FIRST (before peer_allows, which may consume
            # the breaker's half-open probe slot): work whose client has
            # already timed out is shed here, before any bytes move
            rem = remaining_budget()
            if rem is not None and rem <= self.tunables.deadline_floor:
                if self.m_deadline is not None:
                    self.m_deadline.inc(endpoint=endpoint_path)
                raise DeadlineExceeded(
                    f"budget exhausted ({rem * 1000:.1f} ms left) before "
                    f"dispatch of {endpoint_path}")
            if not self.peer_allows(node):
                # fast-fail: no timeout burned, next candidate launches now
                raise PeerUnavailable(
                    f"breaker open for {bytes(node).hex()[:8]}")
            timeout = self.timeout_for(
                node, strategy.rs_timeout, strategy.rs_adaptive_timeout)
            # per-hop timeout clamped to the remaining request budget: a
            # hop may finish early or fail early, never outlive its client
            clamped = clamp_to_budget(timeout)
            budget_bound = clamped is not None and (
                timeout is None or clamped < timeout)

            async def attempt_once(_t=clamped, _bb=budget_bound):
                try:
                    return await raw_call(_t)
                except (TimeoutError, asyncio.TimeoutError, RpcError) as e:
                    # a timeout caused by the BUDGET clamp (not the peer
                    # being slow relative to its own allowance) is the
                    # request's deadline expiring: reclassify typed so it
                    # neither feeds the breaker nor earns a retry, and the
                    # API layer renders 503 instead of 500
                    if (_bb and deadline_expired()
                            and error_code(e) == "Timeout"):
                        raise DeadlineExceeded(
                            f"request budget expired during "
                            f"{endpoint_path}") from e
                    raise

            fn = self._instrument(endpoint_path, attempt_once)
            t_attempt = time.perf_counter()
            try:
                result = await fn()
            except asyncio.CancelledError:
                self.note_result(node, asyncio.CancelledError())
                raise
            except Exception as e:
                self.note_result(node, e)
                # a COMPLETED answer (domain error: the peer served the
                # call, we just disliked the verdict) still measures the
                # peer's service time; transport failures and budget
                # expiries measure nothing about the peer
                if (not is_transport_error(e)
                        and not isinstance(e, DeadlineExceeded)):
                    self._feed_health(node, endpoint_path,
                                      time.perf_counter() - t_attempt)
                retryable = (
                    attempt < retries
                    and not isinstance(e, PeerUnavailable)
                    and is_transport_error(e)
                    and (budget is None or budget.take())
                )
                if not retryable:
                    raise
                if self.m_retries is not None:
                    self.m_retries.inc(
                        endpoint=endpoint_path, reason=error_code(e))
                await asyncio.sleep(
                    full_jitter_backoff(attempt, self.tunables, self._rng))
                attempt += 1
                continue
            else:
                self.note_result(node, None)
                self._feed_health(node, endpoint_path,
                                  time.perf_counter() - t_attempt)
                return result

    # --- ordering (ref rpc_helper.rs:392-435) ---

    def request_order(self, nodes: Sequence[NodeID]) -> List[NodeID]:
        """Self first, then LOCAL-ZONE peers, then cross-zone peers —
        each zone band ordered by ascending ping latency with
        unknown-latency peers after measured ones — and open-breaker
        peers last (they fast-fail, but a candidate that will not answer
        should never order into the first quorum wave).

        The zone band implements the survivor-selection policy from the
        degraded-read literature (PAPERS.md "Boosting the Performance of
        Degraded Reads"): serve from the nearest/healthiest survivors —
        here, the local failure domain — and only cross a zone boundary
        when the local copies are dark (breaker-open/timeout walks the
        ordered list into the next zone).  Peers with no known zone (no
        committed layout, gateway-only tests) rank with the local band,
        which reproduces the pre-zone ordering exactly."""
        return sorted(nodes, key=self.peer_rank)

    def pressure_bucket(self, n: NodeID) -> int:
        """Gossiped load-governor pressure quantized into coarse bands
        (0 = < 0.5 relaxed, 1 = < 1.0 warm, 2 = saturated): ranking on
        the raw float would reorder candidates on every gossip tick,
        defeating RTT ordering within a band — the bucket only demotes
        peers that are MEANINGFULLY hotter."""
        try:
            p = float(self.pressure_of(n))
        except Exception:  # noqa: BLE001 — a dead source is pressure 0
            return 0
        return 0 if p < 0.5 else (1 if p < 1.0 else 2)

    def peer_rank(self, n: NodeID) -> tuple:
        """The candidate-ordering key request_order sorts by — exposed
        so planners can rank non-node resources by their best holder
        (block/repair_plan.py ranks codeword pieces with it).  The key
        is (breaker/fail-slow/zone band, [zone within fail-slow,]
        pressure bucket, measured-latency flag, RTT):

          band 0 = self, 1 = local/unknown zone, 2 = cross-zone,
          3 = FAIL-SLOW (up, pings fine, breaker closed — but a
          sustained factor slower than its siblings for the same
          endpoint class; utils/health_score.py), 4 = breaker open.

        Fail-slow demotes after breaker-open and before RTT, per the
        degraded-reads paper's healthy-survivor-first rule; within the
        fail-slow band, zone then pressure then RTT still order the
        flagged peers (if every candidate is flagged, the least-bad one
        serves).  The pressure bucket is the load-aware half of the
        same paper: a pressured-but-reachable peer yields to an idle
        sibling in the same zone band, but never to a farther zone.
        With no health source wired every bucket is 0 and the ordering
        is exactly the pre-fleet-health (zone, RTT) one."""
        if n == self.our_id:
            return (0, 0, 0, 0.0)
        if self.peering.breaker_state(n) == "open":
            return (4, 0, 0, 0.0)
        lz = self.local_zone()
        nz = self.zone_of(n)
        zband = 1 if (lz is None or nz is None or nz == lz) else 2
        pbucket = self.pressure_bucket(n)
        lat = self.peering.latency(n)
        measured = 1 if lat is None else 0
        try:
            flagged = bool(self.fail_slow_of(n))
        except Exception:  # noqa: BLE001 — a dead source is healthy
            flagged = False
        if flagged:
            return (3, zband, pbucket, measured, lat or 0.0)
        return (zband, pbucket, measured, lat or 0.0)

    # --- single + many (ref rpc_helper.rs:121-172) ---

    async def call(
        self,
        endpoint: Endpoint,
        node: NodeID,
        msg: Any,
        prio: int = PRIO_NORMAL,
        timeout: Optional[float] = 30.0,
        body: Any = None,
        idempotent: bool = False,
    ) -> Any:
        """One-node call through the full resilience gate (adaptive
        timeout, breaker fast-fail, retries when idempotent).  Calls
        carrying a streaming body never retry (the iterator is consumed
        by the first attempt) and keep the STATIC timeout: the timeout
        covers the whole body transfer, which is bandwidth-bound — an
        RTT-derived clamp would false-fail big transfers on slow links
        and feed those timeouts into the breaker."""
        strategy = RequestStrategy(
            rs_priority=prio,
            rs_timeout=timeout,
            rs_idempotent=idempotent and body is None,
            rs_adaptive_timeout=body is None,
        )
        return await self._call_policied(
            endpoint.path,
            node,
            lambda t: endpoint.call(node, msg, prio=prio, timeout=t,
                                    body=body),
            strategy,
        )

    async def call_many(
        self,
        endpoint: Endpoint,
        nodes: Sequence[NodeID],
        msg: Any,
        prio: int = PRIO_NORMAL,
        timeout: Optional[float] = 30.0,
    ) -> List[Tuple[NodeID, Any]]:
        """Call all nodes; per-node result or exception (never raises)."""

        async def one(n):
            try:
                return n, await self.call(endpoint, n, msg, prio, timeout)
            except Exception as e:
                return n, e

        return list(await asyncio.gather(*[one(n) for n in nodes]))

    async def broadcast(
        self,
        endpoint: Endpoint,
        msg: Any,
        prio: int = PRIO_NORMAL,
        timeout: Optional[float] = 30.0,
    ) -> List[Tuple[NodeID, Any]]:
        nodes = list(self.peering.connected_nodes())
        return await self.call_many(endpoint, nodes, msg, prio, timeout)

    # --- quorum calls (ref rpc_helper.rs:223-390) ---

    async def try_call_many(
        self,
        endpoint: Endpoint,
        nodes: Sequence[NodeID],
        msg: Any,
        strategy: RequestStrategy,
        make_call: Optional[Callable[[NodeID, Optional[float]], Any]] = None,
    ) -> List[Any]:
        """Returns the first `quorum` successful responses, or raises
        QuorumError with the collected errors.  ``make_call(node,
        timeout)`` overrides the default dispatch; the resolved adaptive
        timeout is handed in so custom senders inherit it."""
        quorum = strategy.rs_quorum
        nodes = list(nodes)
        if len(nodes) < quorum:
            raise QuorumError(quorum, 0, [f"only {len(nodes)} candidate nodes"])

        budget = _RetryBudget(self.tunables.retry_max * max(quorum, 1))

        def _raw(n: NodeID, t: Optional[float]):
            if make_call is not None:
                return make_call(n, t)
            return endpoint.call(n, msg, prio=strategy.rs_priority, timeout=t)

        def call_node(n: NodeID):
            return self._call_policied(
                endpoint.path, n, lambda t, _n=n: _raw(_n, t), strategy,
                budget=budget,
            )

        # quorum-call span with the reference's attributes
        # (rpc/rpc_helper.rs:238-260: to, quorum, strategy) — created
        # whether or not an exporter is configured: the request
        # waterfall's `rpc` segment comes from exactly this span
        tr = self.tracer
        span = tr.span(
            f"RPC {endpoint.path}",
            to=",".join(bytes(n).hex()[:8] for n in nodes),
            quorum=quorum,
            strategy=("interrupt_after_quorum"
                      if strategy.rs_interrupt_after_quorum else "all_sent"),
        ) if tr is not None else nullcontext()
        with span:
            if strategy.rs_interrupt_after_quorum:
                return await self._quorum_read(
                    nodes, call_node, quorum,
                    self._hedge_delay(endpoint.path, strategy), endpoint.path)
            return await self._quorum_write(
                nodes, call_node, quorum,
                required_zones=strategy.rs_required_zones,
                endpoint_path=endpoint.path)

    @staticmethod
    def _quorum_fail(quorum: int, successes: int, errors: list):
        """The no-quorum exception: typed DeadlineExceeded when the
        request's budget is what killed it (every per-node failure was a
        budget expiry, or the budget is gone outright) — the API layer
        then answers the defined 503 + Retry-After instead of an
        anonymous 500 QuorumError, and the client backs off instead of
        instantly re-queueing against a saturated cluster."""
        if deadline_expired() or (
                errors and all(isinstance(e, DeadlineExceeded)
                               for e in errors)):
            raise DeadlineExceeded(
                f"request budget exhausted before quorum "
                f"({successes}/{quorum} ok)")
        raise QuorumError(quorum, successes, errors)

    async def _quorum_read(self, nodes, call_node, quorum,
                           hedge_delay=None, endpoint_path="") -> List[Any]:
        ordered = self.request_order(nodes)
        in_flight: dict = {}
        responded: set = set()   # nodes whose outcome already counted
        successes: List[Any] = []
        errors: List[Any] = []
        next_i = 0
        try:
            while len(successes) < quorum:
                # keep exactly enough requests in flight to reach quorum
                # (hedges may temporarily exceed this)
                want = quorum - len(successes)
                while len(in_flight) < want and next_i < len(ordered):
                    n = ordered[next_i]
                    next_i += 1
                    in_flight[asyncio.ensure_future(call_node(n))] = n
                if not in_flight:
                    self._quorum_fail(quorum, len(successes), errors)
                # hedging: if the wave is slower than the endpoint's
                # latency quantile AND an unsent candidate remains, launch
                # it speculatively instead of waiting for a failure
                can_hedge = hedge_delay is not None and next_i < len(ordered)
                done, _ = await asyncio.wait(
                    in_flight.keys(),
                    return_when=asyncio.FIRST_COMPLETED,
                    timeout=hedge_delay if can_hedge else None,
                )
                if not done:
                    n = ordered[next_i]
                    next_i += 1
                    in_flight[asyncio.ensure_future(call_node(n))] = n
                    if self.m_hedges is not None:
                        self.m_hedges.inc(endpoint=endpoint_path)
                    continue
                for fut in done:
                    node = in_flight.pop(fut)
                    if bytes(node) in responded:
                        # a node contributes at most ONE outcome to quorum
                        # math.  Hedge/retry can't double-launch a node by
                        # construction (next_i is monotonic; retries stay
                        # inside one future) — this guards CALLERS passing
                        # duplicate candidates, where two futures for one
                        # node would otherwise both count.  Retrieve the
                        # discarded outcome so it never logs as an
                        # unretrieved task exception
                        try:
                            fut.exception()
                        except asyncio.CancelledError:
                            pass
                        continue
                    responded.add(bytes(node))
                    try:
                        successes.append(fut.result())
                    except Exception as e:
                        errors.append(e)
            return successes
        finally:
            if in_flight:
                # cancel losers AND await them in the background so their
                # CancelledError/late results are consumed ("Task
                # exception was never retrieved" leak otherwise); awaited
                # at shutdown via RpcHelper.shutdown
                for fut in in_flight:
                    fut.cancel()
                self._spawn_drain(list(in_flight.keys()))

    async def _quorum_write(self, nodes, call_node, quorum,
                            required_zones: int = 0,
                            endpoint_path: str = "") -> List[Any]:
        futs = {asyncio.ensure_future(call_node(n)): n for n in nodes}
        pending = set(futs.keys())
        successes: List[Any] = []
        errors: List[Any] = []
        ok_nodes: List[NodeID] = []

        def acked_zones() -> set:
            return {z for z in (self.zone_of(n) for n in ok_nodes)
                    if z is not None}

        def zones_ok() -> bool:
            # 0/1 required zones: any ack spans them (and a candidate
            # set with UNKNOWN zones can never prove a violation)
            return required_zones <= 1 or len(acked_zones()) >= required_zones

        requorumed = False
        while pending and (len(successes) < quorum or not zones_ok()):
            if len(successes) >= quorum and not requorumed:
                # numeric quorum is in but the acked copies sit in too
                # few failure domains: keep waiting on the stragglers
                # instead of acking a write that would not survive the
                # zones it landed in
                requorumed = True
                if self.m_zone_requorum is not None:
                    self.m_zone_requorum.inc(endpoint=endpoint_path)
            done, pending = await asyncio.wait(
                pending, return_when=asyncio.FIRST_COMPLETED
            )
            for fut in done:
                try:
                    successes.append(fut.result())
                    ok_nodes.append(futs[fut])
                except Exception as e:
                    errors.append(e)
        if len(successes) < quorum:
            self._quorum_fail(quorum, len(successes), errors)
        if not zones_ok():
            # every candidate has answered; the acks never left
            # len(acked_zones()) zones — a whole zone is dark and the
            # layout demands more (hard integer zone_redundancy)
            if self.m_zone_errors is not None:
                self.m_zone_errors.inc(endpoint=endpoint_path)
            zs = ", ".join(sorted(acked_zones())) or "none"
            raise ZoneQuorumError(
                f"write acked by {len(successes)} nodes but only "
                f"{len(acked_zones())} zone(s) [{zs}]; layout requires "
                f"{required_zones} — a failure domain is unreachable"
            )
        if pending:
            # drain stragglers in the background (ref rpc_helper.rs:348-382)
            self._spawn_drain(pending)
        return successes

    def _spawn_drain(self, pending) -> None:
        drain = asyncio.ensure_future(self._drain(pending))
        self._drain_tasks.add(drain)
        drain.add_done_callback(self._drain_tasks.discard)

    async def shutdown(self, timeout: float = 5.0) -> None:
        """Await background drains (write stragglers, cancelled read
        losers) so no task outlives the transport it talks through; after
        `timeout`, survivors are cancelled and awaited."""
        tasks = [t for t in self._drain_tasks if not t.done()]
        if not tasks:
            return
        _done, pending = await asyncio.wait(tasks, timeout=timeout)
        for t in pending:
            t.cancel()
        if pending:
            await asyncio.gather(*pending, return_exceptions=True)

    @staticmethod
    async def _drain(pending):
        results = await asyncio.gather(*pending, return_exceptions=True)
        for r in results:
            if isinstance(r, Exception):
                logger.debug("background straggler failed: %s", r)
