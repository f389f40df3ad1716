"""Static website server.

Equivalent of reference src/web/web_server.rs (SURVEY.md §2.8): the Host
header maps to a bucket via `web_root_domain` (or is used verbatim as a
bucket name); objects are served through the same GetObject path with the
bucket's index/error documents and CORS rules applied
(web_server.rs:70-75+).
"""

from __future__ import annotations

import logging
from typing import Optional

from aiohttp import web

from ..api.common import host_to_bucket, request_trace, start_site
from ..api.s3.bucket_config import (
    apply_cors_headers,
    cors_request_headers,
    find_matching_cors_rule,
)
from ..utils.metrics import maybe_time

logger = logging.getLogger("garage_tpu_torch.web")


class WebServer:
    def __init__(self, garage):
        self.garage = garage
        self.helper = garage.helper()
        self.root_domain = garage.config.web_root_domain
        self._runner: Optional[web.AppRunner] = None
        self.request_counter = 0
        self.error_counter = 0
        # own metric family slice (ref web/web_server.rs:43-67): rides the
        # shared api_* families with api="web" labels
        m = getattr(garage.system, "metrics", None)
        if m is not None:
            self._m_requests = m.counter(
                "api_request_counter", "API requests received")
            self._m_errors = m.counter(
                "api_error_counter", "API requests answered with an error")
            self._m_duration = m.histogram(
                "api_request_duration_seconds", "API request latency",
                exemplars=True)
        else:
            self._m_requests = self._m_errors = self._m_duration = None

    async def start(self, bind_addr: str) -> None:
        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", self.handle_request)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        self._site = await start_site(self._runner, bind_addr)
        logger.info("web server listening on %s", bind_addr)

    @property
    def port(self) -> int:
        return self._site._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()

    async def handle_request(self, request: web.Request) -> web.StreamResponse:
        self.request_counter += 1
        if self._m_requests is not None:
            self._m_requests.inc(api="web")
        host = request.headers.get("Host", "")
        bucket_name = host_to_bucket(host, self.root_domain) or host.split(":")[0]
        trace, _rid = request_trace(
            self.garage.system.tracer, "Web", "web", request)
        with trace, maybe_time(self._m_duration, api="web"):
            try:
                resp = await self._serve(request, bucket_name)
            except web.HTTPException:
                raise
            except ConnectionError as e:  # incl. ConnectionResetError
                logger.debug("client disconnected mid-request: %s", e)
                raise
            except Exception:
                logger.exception("web request failed")
                resp = web.Response(status=500, text="internal error")
            # EVERY error response counts, with its status (ref
            # web/web_server.rs:43-67 error_counter by status_code) — a
            # 100%-404 outage must be visible on the dashboard
            if resp.status >= 400:
                self.error_counter += 1
                if self._m_errors is not None:
                    self._m_errors.inc(api="web", status=str(resp.status))
            trace.set_attr("status", resp.status)
            return resp

    async def _serve(self, request, bucket_name: str) -> web.StreamResponse:
        bid = await self.helper.resolve_global_bucket_name(bucket_name)
        if bid is None:
            return web.Response(status=404, text="no such website")
        bucket = await self.helper.get_existing_bucket(bid)
        wc = bucket.params().website_config.value
        if wc is None:
            return web.Response(status=404, text="website not enabled on this bucket")

        index = wc.get("index_document", "index.html")
        key = request.path.lstrip("/")
        # directory-style keys resolve to the index document; a path
        # WITHOUT the trailing slash serves the object if present, else
        # 302-redirects to path/ when path/index exists — AWS website
        # semantics (ref web_server.rs:389-416 path_to_keys +
        # ImplicitRedirect)
        implicit_redirect = None
        if key == "" or key.endswith("/"):
            key = key + index
        else:
            # Location keeps the query string (the reference drops it —
            # web_server.rs:410 formats the path only — but clients lose
            # their parameters on the re-request; AWS preserves them)
            qs = request.rel_url.raw_query_string
            implicit_redirect = (
                f"{key}/{index}",
                request.rel_url.raw_path + "/" + (f"?{qs}" if qs else ""),
            )

        cors_rules = bucket.params().cors_config.value
        origin = request.headers.get("Origin")

        if request.method == "OPTIONS":
            req_method = request.headers.get(
                "Access-Control-Request-Method", "GET"
            )
            rule = find_matching_cors_rule(
                cors_rules, req_method, origin, cors_request_headers(request))
            if rule is None:
                return web.Response(status=403, text="CORS forbidden")
            hdrs = {
                "Access-Control-Allow-Methods": ", ".join(rule["allow_methods"]),
                "Access-Control-Allow-Headers": ", ".join(rule.get("allow_headers", [])) or "*",
            }
            if rule.get("max_age_seconds"):
                hdrs["Access-Control-Max-Age"] = str(rule["max_age_seconds"])
            apply_cors_headers(hdrs, rule, origin)
            return web.Response(status=200, headers=hdrs)

        if request.method not in ("GET", "HEAD"):
            return web.Response(status=405, text="method not allowed")

        # matched CORS headers must reach STREAMED responses before
        # prepare() seals them — computed here, merged by _get_object
        cors_headers: dict = {}
        if origin is not None and cors_rules:
            rule = find_matching_cors_rule(
                cors_rules, request.method, origin,
                cors_request_headers(request))
            if rule is not None:
                apply_cors_headers(cors_headers, rule, origin)

        def with_cors(r):
            if cors_headers and not r.prepared:
                for k, v in cors_headers.items():
                    r.headers[k] = v
            return r

        resp = await self._get_object(request, bid, key, cors_headers)
        if resp.status == 404 and implicit_redirect is not None:
            redir_key, redir_url = implicit_redirect
            if await self._key_exists(bid, redir_key):
                return with_cors(web.Response(
                    status=302, headers={"Location": redir_url}))
        if resp.status == 404:
            # error document, still with 404 status (web_server.rs)
            err_key = wc.get("error_document")
            if err_key:
                err_resp = await self._get_object(
                    request, bid, err_key, cors_headers)
                if err_resp.status == 200:
                    err_resp.set_status(404)
                    return with_cors(err_resp)
        return with_cors(resp)

    async def _key_exists(self, bucket_id, key: str) -> bool:
        """ref web_server.rs:212-221 check_key_exists."""
        obj = await self.garage.object_table.get(bucket_id, key)
        return obj is not None and obj.last_data_version() is not None

    async def _get_object(self, request, bucket_id, key: str,
                          cors_headers: Optional[dict] = None
                          ) -> web.StreamResponse:
        """Serve one object via the S3 read internals (no auth — websites
        are public reads, ref web_server.rs serve_file)."""
        from ..api.common import ApiError
        from ..api.s3 import get as get_ops

        class _Ctx:
            garage = self.garage
            key_name = key

            def __init__(self):
                self.request = request
                self.bucket_id = bucket_id
                # merged into streamed responses before prepare()
                self.cors_headers = cors_headers or {}

        ctx = _Ctx()
        try:
            if request.method == "HEAD":
                return await get_ops.handle_head_object(ctx)
            return await get_ops.handle_get_object(ctx)
        except ApiError as e:
            if e.status == 404:
                return web.Response(status=404, text="not found")
            return web.Response(status=e.status, text=str(e))
