"""GatewayPool — a health-checked multi-gateway S3 client.

Production object stores put N stateless gateways behind a client (or
LB) that health-checks them, backs off the ones that shed, and fails a
request over to a sibling when one dies mid-flight.  This module is
that client for the in-process harness: the gateway_failover drill,
bench --replay-phase, and the workload replayer all drive their
traffic through it, so "a gateway died mid-PUT" exercises the same
retry/resume ladder everywhere.

Failover policy, by request class:

  - idempotent requests (every S3 verb this harness issues — PUT with
    the full body in hand, GET, HEAD, DELETE, bucket ops) retry
    verbatim against a sibling on a transport error;
  - typed 503 sheds back the gateway off for the response's
    Retry-After (clamped to ``retry_after_cap`` — the satellite fix:
    the designed backoff, not client hammering) and fail over to a
    sibling immediately if one is available;
  - streaming GETs interrupted mid-body resume on a sibling with a
    ``Range: bytes=<got>-`` request (206) instead of refetching, so a
    gateway kill never re-pays the bytes already drained.

Counters ride an optional MetricsRegistry (``gateway_pool_*``
families, documented in docs/OBSERVABILITY.md) so drills can promlint
and metricsdoc them like any server-side family.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger("garage_tpu_torch.testing.gateway_pool")

# transport-level failures that mean "this gateway, this connection" —
# retryable against a sibling, never surfaced to the caller directly
def _is_transport_error(e: BaseException) -> bool:
    import aiohttp

    return isinstance(e, (
        ConnectionError,                 # incl. ConnectionResetError
        aiohttp.ClientConnectionError,   # incl. ServerDisconnectedError
        aiohttp.ClientPayloadError,      # body truncated mid-stream
        asyncio.TimeoutError,
        OSError,
    ))


class _Gateway:
    """One pool member: address + live health/backoff state."""

    __slots__ = ("name", "port", "healthy", "backoff_until")

    def __init__(self, name: str, port: int):
        self.name = name
        self.port = port
        self.healthy = True
        self.backoff_until = 0.0


class GatewayPool:
    """N gateways, one client.  ``endpoints`` is ``[(name, port), ...]``
    on 127.0.0.1 (the SimCluster shape); ``metrics`` (optional) is a
    MetricsRegistry the pool's counters register into."""

    def __init__(self, session, endpoints: Sequence[Tuple[str, int]],
                 key_id: str, secret: str, region: str = "garage",
                 metrics=None, retry_after_cap: float = 2.0,
                 max_attempts: int = 6):
        self.session = session
        self.gateways: List[_Gateway] = [
            _Gateway(n, p) for n, p in endpoints]
        self.key_id, self.secret, self.region = key_id, secret, region
        self.retry_after_cap = retry_after_cap
        self.max_attempts = max_attempts
        self.counters: Dict[str, int] = {
            "failovers": 0, "retries": 0, "sheds": 0,
            "probes": 0, "probe_failures": 0, "resumes": 0,
        }
        self._rr = 0  # round-robin cursor over equally-ranked members
        self._m = None
        if metrics is not None:
            self._m = {
                "failover": metrics.counter(
                    "gateway_pool_failover_total",
                    "Requests moved to a sibling gateway after a "
                    "transport error"),
                "retry": metrics.counter(
                    "gateway_pool_retry_total",
                    "Request attempts beyond the first (failovers + "
                    "shed-driven retries)"),
                "shed": metrics.counter(
                    "gateway_pool_shed_total",
                    "Typed 503 sheds observed by the pool client"),
                "probe": metrics.counter(
                    "gateway_pool_probe_total",
                    "Gateway health probes sent", ),
                "resume": metrics.counter(
                    "gateway_pool_resume_total",
                    "Streaming GETs resumed on a sibling via Range "
                    "after a mid-body gateway loss"),
            }

    def _count(self, key: str, metric: Optional[str] = None) -> None:
        self.counters[key] += 1
        if self._m is not None and metric in self._m:
            self._m[metric].inc()

    # --- member state -------------------------------------------------

    def set_port(self, name: str, port: int) -> None:
        """Re-point a member after a gateway restart (fresh socket)."""
        gw = next(g for g in self.gateways if g.name == name)
        gw.port, gw.healthy, gw.backoff_until = port, True, 0.0

    def _candidates(self, prefer: Optional[int] = None) -> List[_Gateway]:
        """Attempt order: preferred member first (if given), then
        healthy-and-not-backing-off, then backing-off, then unhealthy —
        never empty, so a fully-dark pool still surfaces a real error
        instead of an index crash.  Equally-ranked healthy members
        rotate round-robin (the LB half of "N stateless gateways"): a
        stable sort would pin every un-preferred request to member 0
        and a sibling's death would never intersect live traffic."""
        now = time.monotonic()

        def rank(g: _Gateway) -> tuple:
            return (not g.healthy, max(0.0, g.backoff_until - now))

        ordered = sorted(self.gateways, key=rank)
        top = rank(ordered[0])
        head = [g for g in ordered if rank(g) == top]
        self._rr = (self._rr + 1) % len(head)
        ordered = head[self._rr:] + head[:self._rr] + ordered[len(head):]
        if prefer is not None:
            p = self.gateways[prefer]
            ordered = [p] + [g for g in ordered if g is not p]
        return ordered

    # --- signing + raw send -------------------------------------------

    async def raw(self, idx: int, method: str, path: str, body: bytes = b"",
                  query: Sequence[Tuple[str, str]] = (),
                  extra_headers: Optional[Dict[str, str]] = None,
                  body_factory: Optional[Callable[[], object]] = None):
        """One signed request to ONE member, no failover — the drills'
        'talk to this specific gateway' primitive.  Returns
        ``(status, body_bytes, headers)``.  ``body_factory`` (when
        given) supplies the wire payload — e.g. a trickling async
        generator — while ``body`` is what gets SIGNED (and therefore
        what the factory must eventually yield)."""
        import yarl

        from ..api.signature import sign_request, uri_encode

        gw = self.gateways[idx]
        headers = {"host": f"127.0.0.1:{gw.port}"}
        if extra_headers:
            headers.update({k.lower(): v for k, v in extra_headers.items()})
        headers.update(sign_request(
            self.key_id, self.secret, self.region, method, path,
            list(query), headers, body, path_is_raw=True))
        qs = "&".join(f"{uri_encode(k)}={uri_encode(v)}" for k, v in query)
        url = yarl.URL(
            f"http://127.0.0.1:{gw.port}{path}" + (f"?{qs}" if qs else ""),
            encoded=True)
        payload = body_factory() if body_factory is not None else body
        if body_factory is not None:
            # generator bodies go chunked; the signed sha256 still
            # covers the full payload, which the server verifies
            headers["content-length"] = str(len(body))
        async with self.session.request(
                method, url, data=payload, headers=headers) as r:
            return r.status, await r.read(), r.headers

    def stream_request(self, idx: int, method: str, path: str,
                       extra_headers: Optional[Dict[str, str]] = None):
        """A signed streaming request context to one member (caller
        iterates ``resp.content`` itself — the slow-consumer drills)."""
        import yarl

        from ..api.signature import sign_request

        gw = self.gateways[idx]
        headers = {"host": f"127.0.0.1:{gw.port}"}
        if extra_headers:
            headers.update({k.lower(): v for k, v in extra_headers.items()})
        headers.update(sign_request(
            self.key_id, self.secret, self.region, method, path, [],
            headers, b"", path_is_raw=True))
        url = yarl.URL(f"http://127.0.0.1:{gw.port}{path}", encoded=True)
        return self.session.request(method, url, headers=headers)

    # --- health probes -------------------------------------------------

    async def probe(self) -> Dict[str, bool]:
        """One health-probe round: a signed ListBuckets per member.
        2xx/4xx = serving; 503 = backing off per Retry-After; transport
        error = unhealthy (next failover skips it)."""
        out: Dict[str, bool] = {}
        for i, gw in enumerate(self.gateways):
            self._count("probes", "probe")
            try:
                st, _b, hdrs = await asyncio.wait_for(
                    self.raw(i, "GET", "/"), 10.0)
            except BaseException as e:  # noqa: BLE001 — verdict, not crash
                if not _is_transport_error(e):
                    raise
                gw.healthy = False
                self._count("probe_failures")
                out[gw.name] = False
                continue
            gw.healthy = st < 500 or st == 503
            if st == 503:
                self._note_shed(gw, hdrs)
            out[gw.name] = gw.healthy and st != 503
        return out

    def _note_shed(self, gw: _Gateway, hdrs) -> None:
        self._count("sheds", "shed")
        try:
            ra = float(hdrs.get("Retry-After", 1))
        except (TypeError, ValueError):
            ra = 1.0
        gw.backoff_until = time.monotonic() + min(
            max(ra, 0.0), self.retry_after_cap)

    # --- the failover request path -------------------------------------

    async def request(self, method: str, path: str, body: bytes = b"",
                      query: Sequence[Tuple[str, str]] = (),
                      idempotent: bool = True,
                      prefer: Optional[int] = None,
                      extra_headers: Optional[Dict[str, str]] = None,
                      body_factory: Optional[Callable[[], object]] = None):
        """Send with health-aware member selection, typed-503 backoff,
        and sibling failover.  Returns ``(status, body, headers)`` of
        the final attempt; transport errors surface only when EVERY
        attempt (bounded by ``max_attempts``) died."""
        last_exc: Optional[BaseException] = None
        last_resp = None
        attempts = 0
        while attempts < self.max_attempts:
            for gw in self._candidates(prefer):
                if attempts >= self.max_attempts:
                    break
                attempts += 1
                if attempts > 1:
                    self._count("retries", "retry")
                wait = gw.backoff_until - time.monotonic()
                if wait > 0:
                    # every sibling is backing off too (sorted order):
                    # honor the clamped Retry-After instead of hammering
                    await asyncio.sleep(min(wait, self.retry_after_cap))
                idx = self.gateways.index(gw)
                try:
                    st, rb, hdrs = await self.raw(
                        idx, method, path, body, query,
                        extra_headers=extra_headers,
                        body_factory=body_factory)
                except BaseException as e:  # noqa: BLE001
                    if not _is_transport_error(e):
                        raise
                    gw.healthy = False
                    last_exc = e
                    if not idempotent:
                        raise
                    self._count("failovers", "failover")
                    prefer = None
                    continue
                gw.healthy = True
                if st == 503:
                    self._note_shed(gw, hdrs)
                    last_resp = (st, rb, hdrs)
                    prefer = None
                    continue  # sibling may have room right now
                return st, rb, hdrs
        if last_resp is not None:
            return last_resp
        assert last_exc is not None
        raise last_exc

    async def get_resumable(self, path: str, prefer: Optional[int] = None,
                            on_chunk=None):
        """Streaming GET with mid-body failover: bytes already drained
        are kept and the remainder is fetched from a sibling with
        ``Range: bytes=<got>-`` (206).  Returns ``(status, body,
        resumed)``.  ``on_chunk(total_bytes)`` fires per chunk — the
        drills use it to kill the serving gateway mid-stream."""
        buf = bytearray()
        resumed = False
        for attempt in range(self.max_attempts):
            order = self._candidates(prefer if attempt == 0 else None)
            gw = order[0]
            idx = self.gateways.index(gw)
            hdrs = {"range": f"bytes={len(buf)}-"} if buf else None
            try:
                async with self.stream_request(
                        idx, "GET", path, extra_headers=hdrs) as r:
                    if r.status not in (200, 206):
                        return r.status, bytes(buf), resumed
                    async for chunk in r.content.iter_any():
                        buf.extend(chunk)
                        if on_chunk is not None:
                            await on_chunk(len(buf))
                return (206 if resumed else 200), bytes(buf), resumed
            except BaseException as e:  # noqa: BLE001
                if not _is_transport_error(e):
                    raise
                gw.healthy = False
                self._count("failovers", "failover")
                if buf:
                    resumed = True
                    self._count("resumes", "resume")
        raise ConnectionError(
            f"get_resumable: every gateway died ({len(buf)} bytes in)")
