"""Shared API error model + helpers.

Equivalent of reference src/api/common_error.rs + helpers.rs + encoding.rs
(SURVEY.md §2.7): a typed error enum rendered uniformly to S3-style XML
error bodies, host→bucket parsing for vhost-style requests, and URI
encoding helpers.
"""

from __future__ import annotations

import math
import os
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Dict, Optional, Tuple

from ..utils.error import GarageError


class ApiError(GarageError):
    status = 500
    code = "InternalError"

    def __init__(self, message: str = "", status: Optional[int] = None,
                 code: Optional[str] = None):
        super().__init__(message)
        if status is not None:
            self.status = status
        if code is not None:
            self.code = code
        self.message = message


class NoSuchBucketError(ApiError):
    status = 404
    code = "NoSuchBucket"


class NoSuchKeyError(ApiError):
    status = 404
    code = "NoSuchKey"


class NoSuchUploadError(ApiError):
    status = 404
    code = "NoSuchUpload"


class BucketNotEmptyError(ApiError):
    status = 409
    code = "BucketNotEmpty"


class BucketAlreadyExistsError(ApiError):
    status = 409
    code = "BucketAlreadyExists"


class AccessDeniedError(ApiError):
    status = 403
    code = "AccessDenied"


class BadRequestError(ApiError):
    status = 400
    code = "InvalidRequest"


class EntityTooSmallError(ApiError):
    status = 400
    code = "EntityTooSmall"


class InvalidPartError(ApiError):
    status = 400
    code = "InvalidPart"


class PreconditionFailedError(ApiError):
    status = 412
    code = "PreconditionFailed"


class InvalidRangeError(ApiError):
    status = 416
    code = "InvalidRange"


class NotImplementedError_(ApiError):
    status = 501
    code = "NotImplemented"


class SlowDownError(ApiError):
    """Node past its admission watermarks: the request was shed at
    intake, unserved (S3's throttle answer — clients back off and
    retry).  `retry_after` rides the Retry-After header via
    error_response."""

    status = 503
    code = "SlowDown"

    def __init__(self, message: str = "service is overloaded; slow down",
                 retry_after: int = 1):
        super().__init__(message)
        self.retry_after = retry_after


def error_xml(err: Exception, resource: str = "", request_id: str = "") -> bytes:
    """S3 error body (ref common_error.rs rendering)."""
    code = getattr(err, "code", "InternalError")
    root = ET.Element("Error")
    ET.SubElement(root, "Code").text = code
    ET.SubElement(root, "Message").text = str(err)
    ET.SubElement(root, "Resource").text = resource
    ET.SubElement(root, "RequestId").text = request_id
    return b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root)


def body_claim(tun, request):
    """→ (bytes to admit against, estimated?).  Declared Content-Length
    when present; a chunked/streaming body with NO declared length is
    admitted against the conservative ``streaming_body_estimate`` (and
    reconciled to actual bytes as it streams — AdmissionToken
    note_body_bytes/body_done) instead of bypassing the bytes watermark
    entirely.  Body-less requests claim nothing."""
    cl = request.headers.get("Content-Length")
    if cl is not None:
        try:
            return max(int(cl), 0), False
        except ValueError:
            return 0, False
    te = request.headers.get("Transfer-Encoding", "")
    if "chunked" in te.lower():
        return max(getattr(tun, "streaming_body_estimate", 0), 0), True
    return 0, False


_SHED_MESSAGES = {
    "over_share": "tenant is past its fair share of the admission gate; "
                  "retry with backoff",
    "queue_full": "tenant admission queue is full; retry with backoff",
    "queue_timeout": "no admission slot freed within the queueing bound; "
                     "retry with backoff",
    "remote_pressure": "a storage node this request must touch is "
                       "saturated; shed at the gateway on its behalf",
}


async def admit_request(gate, request, tenant: Optional[str] = None,
                        remote_pressure: float = 0.0,
                        bucket: Optional[str] = None,
                        remote_due_s: float = 0.0):
    """Admission-gate intake shared by the S3 and K2V servers →
    ``(token, None)`` when admitted (release the token when the request
    FULLY finishes, streaming included) or ``(None, response)`` when
    shed — the ready-to-return 503 SlowDown with a load-derived
    Retry-After and a minted RequestId.  Requests are classified into
    per-tenant WDRR queues by access key (fallback: bucket); sheds are
    per-tenant, never gate-wide.  Gate None (overload protection
    unwired, e.g. bare test servers) admits everything.  A
    `remote_pressure` shed asks the client to wait at least
    `remote_due_s`, the time until the hot node's next status exchange:
    the gossiped reading that shed it cannot change sooner."""
    if gate is None:
        return None, None
    from .admission import classify_tenant

    nbytes, estimated = body_claim(gate.tun, request)
    token, verdict = await gate.admit(
        nbytes, tenant=tenant or classify_tenant(request, bucket),
        remote_pressure=remote_pressure, estimated=estimated)
    if token is not None:
        return token, None
    msg = _SHED_MESSAGES.get(
        verdict, "node is past its admission watermarks; retry with backoff")
    retry_after = gate.retry_after_hint()
    if verdict == "remote_pressure":
        retry_after = max(retry_after, min(math.ceil(remote_due_s),
                                           gate.tun.retry_after_max))
    return None, error_response(
        SlowDownError(msg, retry_after=retry_after), request.path)


def slo_service_latency(request, token, t_intake_ns: int
                        ) -> Tuple[float, bool]:
    """``(seconds, client_paced)`` for the latency SLO (utils/slo.py),
    shared by the S3 and K2V middlewares at request completion.
    Client-paced durations (streamed GET responses, long-polls — the
    admission token's CoDel sojourn exclusion, or the request-level
    ``slo_client_paced`` flag the streaming/poll handlers set so the
    exclusion holds with admission disabled) count toward availability
    but must never mark slow.  Uploads anchor at body completion, like
    the adaptive watermark (subtracting the client-paced body
    transfer); everything else keeps the INTAKE anchor — it includes
    the admission (WDRR) queue wait, which is server-side latency the
    client observes and must burn the budget."""
    import time

    lat_s = (time.time_ns() - t_intake_ns) / 1e9
    paced = bool(request.get("slo_client_paced"))
    if token is not None and not paced:
        sl = token.service_latency()
        if sl is None:
            paced = True
        elif token.body_anchored():
            lat_s = sl
    return lat_s, paced


def request_deadline_budget(config) -> Optional[float]:
    """The per-request deadline budget the API servers arm, from
    ``[rpc] deadline_default``; None = deadlines disabled."""
    rpc_tun = getattr(config, "rpc", None)
    if rpc_tun is not None and rpc_tun.deadline_default > 0:
        return rpc_tun.deadline_default
    return None


def client_deadline_budget(default_s: Optional[float],
                           request) -> Optional[float]:
    """Fold a client-supplied ``X-Request-Timeout`` (seconds) into the
    request's deadline budget: it may TIGHTEN the default, never extend
    it — and when deadlines are disabled a client may still arm its own.
    Malformed / non-finite / non-positive values are ignored (header
    values are client-controlled fuzz targets; a bad one must not
    disable or poison the budget)."""
    raw = request.headers.get("X-Request-Timeout")
    if raw is None:
        return default_s
    try:
        t = float(raw)
    except (TypeError, ValueError):
        return default_s
    if not (t == t) or t == float("inf") or t <= 0:
        return default_s
    return t if default_s is None else min(default_s, t)


def gen_request_id() -> str:
    """A fresh x-amz-request-id.  request_trace mints one per traced
    request; error paths that answer BEFORE a trace exists (the
    admission gate's shed) mint one here so every response — even a
    rejection — carries a RequestId a support ticket can quote."""
    return os.urandom(16).hex()


def error_response(err: Exception, resource: str = "",
                   request_id: str = ""):
    """The ONE way an API server renders an error to the client: S3
    error XML body + the `x-amz-request-id` header (always — error
    responses are never prepared streaming responses, so the header can
    always be set here instead of relying on each caller's post-hoc
    header pass) + `Retry-After` on every 503 (SlowDown sheds, deadline
    expiries) so well-behaved clients back off instead of hammering an
    overloaded node."""
    from aiohttp import web

    status = int(getattr(err, "status", 500))
    rid = request_id or gen_request_id()
    headers = {"x-amz-request-id": rid}
    if status == 503:
        headers["Retry-After"] = str(int(getattr(err, "retry_after", 1)))
    return web.Response(
        status=status,
        body=error_xml(err, resource, rid),
        content_type="application/xml",
        headers=headers,
    )


def xml_to_bytes(root: ET.Element) -> bytes:
    return b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root)


S3_XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"


def s3_xml_root(tag: str) -> ET.Element:
    return ET.Element(tag, {"xmlns": S3_XMLNS})


def iso_timestamp(ts_ms: int) -> str:
    """ms epoch → S3-style ISO8601 (shared by list/bucket/copy XML)."""
    import datetime

    return datetime.datetime.fromtimestamp(
        ts_ms / 1000, tz=datetime.timezone.utc
    ).strftime("%Y-%m-%dT%H:%M:%S.000Z")


def int_param(value, name: str, default: Optional[int] = None) -> Optional[int]:
    """Parse an integer query parameter; malformed → 400 InvalidArgument
    (not a 500) — S3 clients fuzz these freely."""
    if value is None:
        return default
    try:
        return int(value)
    except (TypeError, ValueError):
        raise ApiError(
            f"invalid integer for {name}: {value!r}",
            status=400, code="InvalidArgument",
        )


async def start_site(runner, bind_addr: str, unix_mode: int = 0o222):
    """Bind an aiohttp runner to `bind_addr` — "host:port" for TCP, an
    absolute path or "unix:/path" for a unix domain socket (ref
    util/socket_address.rs UnixOrTCPSocketAddress; every API server in
    the reference accepts both).  Returns the started site.

    Unix sockets are chmod'd to `unix_mode` after bind (ref
    api/generic_server.rs:150-152, default 0o222): connecting requires
    write permission, and the daemon's umask would otherwise leave the
    socket unreachable for clients running as other users."""
    from aiohttp import web

    is_unix = bind_addr.startswith("unix:")
    if is_unix:
        bind_addr = bind_addr[len("unix:"):]
    if is_unix or bind_addr.startswith("/"):
        # a previous run's socket file survives shutdown and would make
        # bind fail EADDRINUSE; only ever unlink an actual socket
        import os
        import stat

        try:
            if stat.S_ISSOCK(os.stat(bind_addr).st_mode):
                os.unlink(bind_addr)
        except FileNotFoundError:
            pass
        site = web.UnixSite(runner, bind_addr)
        await site.start()
        try:
            os.chmod(bind_addr, unix_mode)
        except OSError:
            import logging

            logging.getLogger("garage_tpu_torch.api").warning(
                "cannot chmod unix socket %s to %s — clients running as "
                "other users will get EACCES", bind_addr, oct(unix_mode),
                exc_info=True,
            )
        return site
    host, port = bind_addr.rsplit(":", 1)
    site = web.TCPSite(runner, host, int(port))
    await site.start()
    return site


def client_addr(request) -> str:
    """Advertised client address for logs/spans (ref
    util/forwarded_headers.rs handle_forwarded_for_headers +
    generic_server.rs:172-177): when X-Forwarded-For holds exactly one
    valid IP literal it is used, like the reference does; anything else
    (absent, hostname, list) falls back to the TCP peer address.  The
    header is client-controlled, so spans record the TCP peer TOO
    (request_trace below) — a spoofed header can't erase the real peer
    from the audit trail."""
    import ipaddress

    xff = request.headers.get("X-Forwarded-For")
    if xff is not None:
        try:
            return str(ipaddress.ip_address(xff.strip()))
        except ValueError:
            pass
    return request.remote or ""


def request_trace(tracer, title: str, api: str, request,
                  start_ns: Optional[int] = None):
    """Per-request trace root shared by the S3/K2V/Web servers (ref
    api/generic_server.rs:187-200 creates one span per request with a
    fresh trace id).  Records method/path, the TCP peer, and the
    forwarded client address when it differs.

    → (span, request_id).  The request id IS the trace id (it seeds the
    root span), so the `x-amz-request-id` a client quotes in a support
    ticket is the exact key to look the distributed trace up by.  The
    id exists even with tracing off — clients always get one.

    `start_ns` backdates the root to request INTAKE: admission runs
    before the trace can be minted (sheds must stay cheap), but its
    time belongs to the request — the waterfall's segments then sum to
    the duration the client actually saw."""
    rid = os.urandom(16).hex()
    attrs = {
        "api": api,
        "method": request.method,
        "path": request.path,
        "peer": request.remote or "",
    }
    fwd = client_addr(request)
    if fwd != attrs["peer"]:
        attrs["forwarded_for"] = fwd
    return tracer.new_trace(
        f"{title} {request.method}", trace_id=rid, start_ns=start_ns,
        **attrs
    ), rid


def host_to_bucket(host: str, root_domain: Optional[str]) -> Optional[str]:
    """vhost-style bucket extraction (ref helpers.rs host_to_bucket):
    `bucket.root_domain` → bucket; bare root_domain or unrelated host →
    None (path-style)."""
    if root_domain is None:
        return None
    host = host.split(":")[0].lower()
    rd = root_domain.lstrip(".").lower()
    if host == rd:
        return None
    suffix = "." + rd
    if host.endswith(suffix):
        return host[: -len(suffix)]
    return None


def parse_bucket_key(path: str, vhost_bucket: Optional[str]) -> Tuple[Optional[str], Optional[str]]:
    """(bucket, key) from the URI path (ref api_server.rs:79-103).
    Key of "" (trailing slash) is a valid S3 key distinct from None."""
    path = urllib.parse.unquote(path)
    if not path.startswith("/"):
        path = "/" + path
    if vhost_bucket is not None:
        key = path[1:]
        return vhost_bucket, (key if key != "" else None)
    parts = path[1:].split("/", 1)
    bucket = parts[0] if parts[0] != "" else None
    key = parts[1] if len(parts) > 1 else None
    return bucket, key
