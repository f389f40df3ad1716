"""S3 API server — request routing, auth, and dispatch.

Equivalent of reference src/api/s3/api_server.rs + generic_server.rs
(SURVEY.md §2.7): an aiohttp server (the hyper analogue) that parses
vhost- or path-style bucket addressing, verifies the SigV4 signature
against the key table, resolves the bucket and checks the endpoint's
required permission level, then dispatches to the per-endpoint handler.
Errors render as S3 XML bodies (generic_server.rs:165-266).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from aiohttp import web

from ...model.helper import (
    BucketAlreadyExists,
    BucketNotEmpty,
    NoSuchBucket,
    NoSuchKey,
)
from ...utils.metrics import maybe_time
from ...utils.tracing import deadline_scope
from ..common import (
    AccessDeniedError,
    ApiError,
    BadRequestError,
    BucketAlreadyExistsError,
    BucketNotEmptyError,
    NoSuchBucketError,
    SlowDownError,
    admit_request,
    client_deadline_budget,
    error_response,
    host_to_bucket,
    parse_bucket_key,
    request_deadline_budget,
    request_trace,
    slo_service_latency,
    start_site,
)
from ..signature import (
    AuthError,
    GarageError,
    InvalidRequest,
    check_signature,
    raw_query_pairs,
)
from .router import NONE, OWNER, READ, WRITE, parse_endpoint

logger = logging.getLogger("garage_tpu_torch.api.s3")


class S3ApiServer:
    def __init__(self, garage):
        self.garage = garage
        self.helper = garage.helper()
        self.region = garage.config.s3_region
        self.root_domain = garage.config.root_domain
        # overload protection (docs/ROBUSTNESS.md "Overload & brownout"):
        # the node-wide admission gate (shared with the K2V server — one
        # node, one capacity), the cluster-aware pressure probe (shed at
        # the front door on behalf of a gossiped-hot storage node) and
        # the per-request deadline budget
        self.gate = getattr(garage, "admission", None)
        self.probe = getattr(garage, "admission_probe", None)
        # SLO burn-rate tracker (utils/slo.py): every finished request —
        # sheds included — lands in it, so admission verdicts burn the
        # availability budget like any other server-side failure
        self.slo = getattr(garage, "slo", None)
        self.deadline_s = request_deadline_budget(garage.config)
        self._runner: Optional[web.AppRunner] = None
        # graceful drain (docs/ROBUSTNESS.md "Geo-WAN & gateway
        # failover"): once draining, NEW requests are shed with a typed
        # 503 while the in-flight set runs to completion inside a
        # bounded window; the state rides NodeStatus gossip
        # (system.drain_state) so sibling gateways absorb load before
        # this socket closes
        self._draining = False
        self._inflight = 0
        self._idle = asyncio.Event()
        self._idle.set()
        # metrics (ref generic_server.rs:63-95)
        self.request_counter = 0
        self.error_counter = 0
        m = getattr(garage.system, "metrics", None)
        if m is not None:
            # families shared across API servers via registry name-dedup;
            # each server records with its own api= label
            self._m = {
                "requests": m.counter(
                    "api_request_counter", "API requests received"),
                "errors": m.counter(
                    "api_error_counter", "API requests answered with an error"),
                "duration": m.histogram(
                    "api_request_duration_seconds", "API request latency",
                    exemplars=True),
            }
        else:
            self._m = None

    # --- server lifecycle ---

    async def start(self, bind_addr: str) -> None:
        app = web.Application(client_max_size=1024**4)
        app.router.add_route("*", "/{tail:.*}", self.handle_request)
        # short shutdown_timeout: drain() already waited for the
        # in-flight set, so cleanup only has idle keep-alives (and an
        # abrupt kill_gateway must not hang 60 s on aborted conns)
        self._runner = web.AppRunner(app, access_log=None,
                                     shutdown_timeout=1.0)
        await self._runner.setup()
        self._site = await start_site(self._runner, bind_addr)
        logger.info("S3 API listening on %s", bind_addr)

    @property
    def port(self) -> int:
        return self._site._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._runner is not None:
            runner, self._runner = self._runner, None  # drain() then
            # Server.stop() may both come through here — clean up once
            await runner.cleanup()

    async def drain(self, timeout: Optional[float] = None) -> float:
        """Graceful drain: stop admitting (typed 503 shed), publish
        "draining" via NodeStatus gossip, wait up to `timeout` for the
        in-flight set to finish, then close the socket and publish
        "drained".  Returns the observed drain window in seconds.  The
        SIGTERM path (server.py) and the gateway_failover drill both
        come through here."""
        import time as _time

        if timeout is None:
            timeout = self.garage.config.api.drain_timeout
        t0 = _time.monotonic()
        self._draining = True
        system = self.garage.system
        system.drain_state = "draining"
        try:
            # push the state to siblings NOW — the whole point is that
            # they learn before the socket goes away
            await system.advertise_status()
        except Exception:  # noqa: BLE001 — drain must finish regardless
            logger.exception("drain: status advertisement failed")
        try:
            await asyncio.wait_for(self._idle.wait(), timeout)
        except asyncio.TimeoutError:
            logger.warning(
                "drain: %d requests still in flight after %.1fs window; "
                "closing anyway", self._inflight, timeout)
        # handlers are done, but a client-paced download's final bytes
        # may still sit in user-space transport buffers (the handler
        # returns as soon as the kernel accepts the writes): closing
        # now would truncate an already-acked response.  Flush inside
        # the same window — kernel-buffered bytes survive the graceful
        # close (FIN sequences after data), user-space ones do not.
        runner = self._runner
        if runner is not None and runner.server is not None:
            deadline = t0 + timeout
            while _time.monotonic() < deadline:
                if not any(c.transport is not None
                           and c.transport.get_write_buffer_size() > 0
                           for c in runner.server.connections):
                    break
                await asyncio.sleep(0.05)
        await self.stop()
        system.drain_state = "drained"
        try:
            await system.advertise_status()
        except Exception:  # noqa: BLE001
            logger.exception("drain: final status advertisement failed")
        return _time.monotonic() - t0

    # --- request handling (ref generic_server.rs:165-266) ---

    async def handle_request(self, request: web.Request) -> web.StreamResponse:
        if self._draining:
            # typed shed, same surface as an admission reject: XML 503
            # SlowDown with RequestId + Retry-After, so pool clients
            # back off and fail over without special-casing drain
            self.request_counter += 1
            self.error_counter += 1
            if self._m is not None:
                self._m["requests"].inc(api="s3")
                self._m["errors"].inc(api="s3", status="503")
            return error_response(
                SlowDownError("gateway is draining; retry against a "
                              "sibling", retry_after=1),
                request.path)
        self._inflight += 1
        self._idle.clear()
        try:
            return await self._serve(request)
        finally:
            self._inflight -= 1
            if self._inflight == 0:
                self._idle.set()

    async def _serve(self, request: web.Request) -> web.StreamResponse:
        self.request_counter += 1
        if self._m is not None:
            self._m["requests"].inc(api="s3")
        # admission control BEFORE any per-request work (signature, trace,
        # body): past the watermarks the request is shed with a typed
        # 503 SlowDown + Retry-After instead of queueing toward its
        # client's timeout.  Requests classify into per-tenant WDRR
        # queues (by access key, fallback bucket), and the gossiped
        # pressure of the bucket's placement nodes is folded in so a
        # saturated storage node sheds HERE, not three hops later.
        # Admission is decided once — an admitted request (streaming
        # bodies included) is never shed mid-transfer.
        remote_p, remote_due = 0.0, 0.0
        vb = host_to_bucket(
            request.headers.get("Host", ""), self.root_domain)
        bname, key = parse_bucket_key(request.rel_url.raw_path, vb)
        # routing (_handle) reuses THIS parse: classification and
        # dispatch must never disagree about which bucket a request is
        request["s3_bucket_key"] = (bname, key)
        if self.probe is not None:
            remote_p, _hot, remote_due = self.probe.pressure(bname)
        # the deadline scope arms the request's end-to-end budget —
        # tightened (never extended) by a client-supplied
        # X-Request-Timeout — BEFORE admission, so time queued in the
        # WDRR gate spends the budget instead of stacking on top of it;
        # every nested RPC hop carries what is left and sheds typed
        # once it runs out.
        budget = client_deadline_budget(self.deadline_s, request)
        import time as _time

        t_intake_ns = _time.time_ns()
        with deadline_scope(budget):
            token, shed = await admit_request(
                self.gate, request, remote_pressure=remote_p, bucket=bname,
                remote_due_s=remote_due)
            t_admitted_ns = _time.time_ns()
            if shed is not None:
                self.error_counter += 1
                if self._m is not None:
                    self._m["errors"].inc(api="s3", status="503")
                if self.slo is not None:
                    # the shed verdict burns the ENDPOINT's availability
                    # budget, not a generic bucket: classify the request
                    # the same way routing would have
                    self.slo.note(
                        self._slo_endpoint(request, bname, key),
                        (_time.time_ns() - t_intake_ns) / 1e9, ok=False)
                return shed
            if token is not None:
                # streaming handlers reconcile Content-Length-less bodies
                # against the token (RequestContext.body_stream)
                request["admission_token"] = token
            try:
                # fresh trace per request (ref generic_server.rs:187-200);
                # child spans (table ops, quorum RPCs, block IO — on
                # EVERY node the request touches, via the propagated
                # context) parent under it.  The request id returned to
                # the client IS the trace id, so a quoted
                # x-amz-request-id is the trace lookup key.  The root is
                # backdated to intake and the admission wait recorded as
                # a child, so the waterfall's segments cover the whole
                # client-observed duration.
                tracer = self.garage.system.tracer
                trace, rid = request_trace(
                    tracer, "S3", "s3", request, start_ns=t_intake_ns)
                if t_admitted_ns > t_intake_ns:
                    tracer.record_span(
                        "admission", trace.trace_id, trace.span_id,
                        t_intake_ns, t_admitted_ns)
                with trace, maybe_time(
                        self._m and self._m["duration"], api="s3"):
                    resp = await self._handle_with_errors(request, rid)
                    trace.set_attr("status", resp.status)
                    ep = request.get("s3_endpoint")
                    if ep is not None:
                        # the waterfall groups by this (PutObject,
                        # GetObject, …), not by raw method
                        trace.set_attr("endpoint", ep)
                    if self.slo is not None:
                        # 5xx burns availability; 4xx is the client's
                        # problem; a SLOW success burns the latency SLO
                        # (client-paced exclusion + body-completion
                        # anchor shared with K2V in slo_service_latency)
                        lat_s, paced = slo_service_latency(
                            request, token, t_intake_ns)
                        self.slo.note(
                            ep or self._slo_endpoint(request, bname, key),
                            lat_s, ok=resp.status < 500,
                            client_paced=paced)
                    if not resp.prepared:
                        resp.headers["x-amz-request-id"] = rid
                    return resp
            finally:
                if token is not None:
                    token.release()

    def _slo_endpoint(self, request, bname, key) -> str:
        """Endpoint classification for requests that never reached the
        router (sheds): the same parse routing uses, degraded to
        'Unknown' on malformed input — classification must stay cheap
        and must never raise on a request we are rejecting anyway."""
        try:
            ep = parse_endpoint(
                request.method, bname, key,
                [(k, v) for k, v in request.query.items()],
                {k.lower(): v for k, v in request.headers.items()})
            return ep.name
        except Exception:  # noqa: BLE001
            return "Unknown"

    async def _handle_with_errors(self, request, rid: str) -> web.StreamResponse:
        try:
            return await self._handle(request)
        except ConnectionError as e:  # incl. ConnectionResetError
            # the CLIENT hung up mid-response (aborted download, closed
            # tab) — normal operation, not a server error; nothing can
            # be written back on a dead transport anyway
            logger.debug("client disconnected mid-request: %s", e)
            raise
        except (ApiError, GarageError, NoSuchBucket, NoSuchKey) as e:
            self.error_counter += 1
            status = getattr(e, "status", 500)
            if self._m is not None:
                self._m["errors"].inc(api="s3", status=str(status))
            if status >= 500 and status != 503:
                logger.exception("S3 API internal error")
            else:
                # 503s (deadline expiry, overload shed) are the defined
                # past-saturation behavior, not an internal fault — a
                # stack trace per shed would melt the log under exactly
                # the load the gate exists to survive
                logger.debug("S3 API error %s: %s", status, e)
            return error_response(e, request.path, rid)
        except Exception as e:  # noqa: BLE001 — uniform 500 rendering
            self.error_counter += 1
            if self._m is not None:
                self._m["errors"].inc(api="s3", status="500")
            logger.exception("S3 API unexpected error")
            return error_response(e, request.path, rid)

    async def _handle(self, request: web.Request) -> web.StreamResponse:
        headers = {k.lower(): v for k, v in request.headers.items()}
        # bucket/key come from the RAW (still-encoded) path, decoded
        # exactly once in parse_bucket_key (request.path is already
        # decoded and would double-decode keys containing %XX); normally
        # handle_request already parsed for admission — reuse it so
        # classification and routing can never disagree
        parsed = request.get("s3_bucket_key")
        if parsed is not None:
            bucket_name, key_name = parsed
        else:
            vhost_bucket = host_to_bucket(
                headers.get("host", ""), self.root_domain)
            bucket_name, key_name = parse_bucket_key(
                request.rel_url.raw_path, vhost_bucket
            )
        query = [(k, v) for k, v in request.query.items()]
        endpoint = parse_endpoint(
            request.method, bucket_name, key_name, query, headers
        )
        # the per-endpoint label the request root (and the waterfall
        # recorder keyed on it) carries
        request["s3_endpoint"] = endpoint.name

        # PostObject authenticates via the signed policy document inside
        # the form, not an Authorization header (ref post_object.rs:1-507)
        if endpoint.name == "PostObject":
            from .post_object import handle_post_object

            return await handle_post_object(self, request, bucket_name)

        # CORS preflight is unauthenticated too (ref api_server.rs:119-121)
        if endpoint.name == "Options":
            from .bucket_config import handle_options_s3api

            return await handle_options_s3api(self, request, bucket_name)

        # authentication (ref api_server.rs:105-130 + signature/)
        async def get_key(key_id: str):
            k = await self.garage.key_table.get(key_id, "")
            if k is None or k.is_deleted():
                return None
            return k

        with self.garage.system.tracer.span("signature verify"):
            verified = await check_signature(
                get_key, self.region, request.method, request.path, query,
                headers,
                raw_path=request.rel_url.raw_path,
                raw_query=raw_query_pairs(request.rel_url.raw_query_string),
            )
        api_key = verified.key

        ctx = RequestContext(
            self, request, verified, endpoint, bucket_name, key_name
        )

        try:
            return await self._dispatch(ctx, endpoint, bucket_name, api_key)
        except BucketAlreadyExists as e:
            raise BucketAlreadyExistsError(str(e))
        except BucketNotEmpty as e:
            raise BucketNotEmptyError(str(e))
        except NoSuchBucket as e:
            raise NoSuchBucketError(str(e))

    async def _dispatch(self, ctx, endpoint, bucket_name, api_key):
        handlers = _handlers()
        if endpoint.name == "ListBuckets":
            return await handlers["ListBuckets"](ctx)
        if endpoint.name == "CreateBucket":
            return await handlers["CreateBucket"](ctx)

        # all other endpoints address an existing bucket
        bucket_id = await self.helper.resolve_bucket(bucket_name, api_key)
        bucket = await self.helper.get_existing_bucket(bucket_id)
        ctx.bucket_id, ctx.bucket = bucket_id, bucket
        if self.probe is not None and bucket_name:
            # teach the admission probe this bucket's placement so the
            # NEXT request can fold the gossiped pressure of its layout
            # nodes into the admit decision
            self.probe.note_bucket(bucket_name, bytes(bucket_id))

        allowed = {
            READ: api_key.allow_read(bucket_id),
            WRITE: api_key.allow_write(bucket_id),
            OWNER: api_key.allow_owner(bucket_id),
            NONE: True,
        }[endpoint.authorization]
        if not allowed:
            raise AccessDeniedError(
                f"key {api_key.key_id} lacks {endpoint.authorization} on bucket"
            )

        h = handlers.get(endpoint.name)
        if h is None:
            # recognized S3 endpoint with no implementation → 501, the
            # reference's catch-all (api_server.rs Err(NotImplemented))
            from ..common import NotImplementedError_

            raise NotImplementedError_(
                f"endpoint {endpoint.name} is not implemented")
        # cross-origin browser callers need the bucket's CORS rule echoed
        # on the actual response too, not just the preflight (ref
        # api_server.rs:170,379-381).  Matched BEFORE the handler runs:
        # streaming handlers (GetObject) send headers on prepare(), after
        # which they are immutable — they merge ctx.cors_headers early.
        origin = ctx.request.headers.get("Origin")
        if origin is not None:
            from .bucket_config import (
                add_cors_headers,
                cors_request_headers,
                find_matching_cors_rule,
            )

            req_headers = cors_request_headers(ctx.request)
            rule = find_matching_cors_rule(
                ctx.bucket.params().cors_config.value,
                ctx.request.method, origin, req_headers,
            )
            if rule is not None:
                add_cors_headers(ctx.cors_headers, rule, origin)

        resp = await h(ctx)
        if ctx.cors_headers and not resp.prepared:
            for k, v in ctx.cors_headers.items():
                resp.headers[k] = v
        return resp


_HANDLERS = None


def _handlers():
    """Endpoint-name → handler table, built once on first request (the
    handler modules import api_server, so module-level would cycle)."""
    global _HANDLERS
    if _HANDLERS is None:
        from . import bucket as b
        from . import bucket_config
        from . import copy as c
        from . import delete as d
        from . import get as g
        from . import list as l
        from . import multipart as m
        from . import put as p

        _HANDLERS = {
            "ListBuckets": b.handle_list_buckets,
            "CreateBucket": b.handle_create_bucket,
            "HeadBucket": b.handle_head_bucket,
            "DeleteBucket": b.handle_delete_bucket,
            "GetBucketLocation": b.handle_get_location,
            "GetBucketVersioning": b.handle_get_versioning,
            "GetBucketAcl": b.handle_get_acl,
            "ListObjects": l.handle_list_objects,
            "ListObjectsV2": l.handle_list_objects_v2,
            "ListMultipartUploads": l.handle_list_multipart_uploads,
            "ListParts": l.handle_list_parts,
            "PutObject": p.handle_put_object,
            "GetObject": g.handle_get_object,
            "HeadObject": g.handle_head_object,
            "DeleteObject": d.handle_delete_object,
            "DeleteObjects": d.handle_delete_objects,
            "CreateMultipartUpload": m.handle_create_mpu,
            "UploadPart": m.handle_upload_part,
            "CompleteMultipartUpload": m.handle_complete_mpu,
            "AbortMultipartUpload": m.handle_abort_mpu,
            "CopyObject": c.handle_copy_object,
            "UploadPartCopy": c.handle_upload_part_copy,
            **bucket_config.HANDLERS,
        }
    return _HANDLERS


class RequestContext:
    """Per-request state handed to endpoint handlers."""

    __slots__ = (
        "server", "request", "verified", "endpoint",
        "bucket_name", "key_name", "bucket_id", "bucket", "cors_headers",
    )

    def __init__(self, server, request, verified, endpoint, bucket_name, key_name):
        self.server = server
        self.request = request
        self.verified = verified
        self.endpoint = endpoint
        self.bucket_name = bucket_name
        self.key_name = key_name
        self.bucket_id = None
        self.bucket = None
        # CORS headers matched for this request (merged into the response
        # by _dispatch, or by streaming handlers before prepare())
        self.cors_headers = {}

    @property
    def garage(self):
        return self.server.garage

    @property
    def api_key(self):
        return self.verified.key

    async def read_body_verified(self) -> bytes:
        """Read the whole body and check it against the signed
        x-amz-content-sha256 (ref signature verify_signed_content) —
        required for XML-body endpoints so a tampered body can't ride a
        valid header signature."""
        import hashlib

        body = await self.request.read()
        sha = self.verified.content_sha256
        if sha not in (None, "STREAMING"):
            if hashlib.sha256(body).hexdigest() != sha:
                from ..common import ApiError

                raise ApiError(
                    "body does not match signed x-amz-content-sha256",
                    status=403, code="SignatureDoesNotMatch",
                )
        return body

    def body_stream(self):
        """The (possibly chunk-signed) request body as an async byte
        iterator (ref signature/streaming.rs wrapping).  Bodies admitted
        against the Content-Length-less ESTIMATE reconcile the admission
        gate's byte accounting to the actual bytes as they stream."""
        from ..signature import decode_streaming_body

        token = self.request.get("admission_token")

        async def raw():
            async for chunk in self.request.content.iter_any():
                if token is not None:
                    token.note_body_bytes(len(chunk))
                yield chunk
            if token is not None:
                token.body_done()

        if self.verified.content_sha256 == "STREAMING":
            return decode_streaming_body(
                raw(),
                self.api_key.params().secret_key,
                self.verified.credential,
                self.verified.signature,
                self.verified.timestamp,
            )
        return raw()
