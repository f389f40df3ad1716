"""Admin HTTP API — health, metrics, cluster/bucket/key REST.

Equivalent of reference src/api/admin/ (SURVEY.md §2.7): `/health` (no
auth), `/metrics` (Prometheus text format, guarded by the metrics token),
and the v1 REST endpoints for status/layout/buckets/keys guarded by the
admin token (api_server.rs:32-60,271-335).
"""

from __future__ import annotations

import hmac
import json
import logging
import time
from typing import Optional

from aiohttp import web

from .common import start_site

logger = logging.getLogger("garage_tpu_torch.api.admin")


def metrics_body(garage, openmetrics: bool = False) -> str:
    """The full Prometheus exposition for one node: the ad-hoc cluster
    gauges + the refreshed registry.  Module-level so the metrics-docs
    lint (tests + smoke) checks exactly what /metrics serves."""
    lines = []

    def gauge(name, value, help_=""):
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {value}")

    h = garage.system.health()
    gauge("cluster_healthy", 1 if h.status == "healthy" else 0)
    gauge("cluster_available", 1 if h.status != "unavailable" else 0)
    gauge("cluster_connected_nodes", h.connected_nodes)
    gauge("cluster_known_nodes", h.known_nodes)
    # refresh scrape-time observed gauges (per-table backlogs, the
    # per-worker status registry, per-peer health), then render the
    # registry that the rpc/table/block/api layers record into.
    # Each subsystem's sweep is timed (metrics_gauge_sweep_seconds):
    # the ROADMAP 128-node wall is exactly these sweeps growing with
    # the fleet, so the scrape's self-cost must be a datapoint.
    reg = garage.system.metrics
    sweep_g = reg.gauge(
        "metrics_gauge_sweep_seconds",
        "Scrape-time gauge sweep cost per subsystem (last scrape)")
    render_g = reg.gauge(
        "metrics_render_seconds",
        "Wall time of the previous /metrics registry render")

    def timed_sweep(subsystem, fn):
        t0 = time.perf_counter()
        try:
            fn()
        finally:
            sweep_g.set(time.perf_counter() - t0, subsystem=subsystem)

    timed_sweep("tables", lambda: [t.observe_gauges()
                                   for t in garage.tables])
    timed_sweep("workers", lambda: garage.bg.observe_gauges(reg))
    timed_sweep("peering",
                lambda: garage.system.peering.observe_gauges())
    # the render gauge necessarily reports the PREVIOUS scrape's render
    # cost: its own value must land inside the body it measures
    t0 = time.perf_counter()
    body = reg.render(openmetrics=openmetrics)
    render_g.set(time.perf_counter() - t0)
    return "\n".join(lines) + "\n" + body


class AdminApiServer:
    def __init__(self, garage):
        self.garage = garage
        self.helper = garage.helper()
        self._runner: Optional[web.AppRunner] = None
        # v1 endpoints share their implementations with the CLI's admin
        # RPC handler (one semantics for both operator surfaces)
        from ..admin.handler import AdminRpcHandler

        self._rpc = AdminRpcHandler(garage, register_endpoint=False)

    async def start(self, bind_addr: str) -> None:
        @web.middleware
        async def bad_request_guard(request, handler):
            """Malformed admin requests (missing required query params,
            invalid JSON bodies) render as 400 JSON, not bare 500s."""
            from ..utils.error import GarageError

            try:
                return await handler(request)
            except web.HTTPException:
                raise
            except (KeyError, ValueError) as e:  # incl. JSONDecodeError
                return web.json_response(
                    {"error": f"bad request: {e!r}"}, status=400
                )
            except GarageError as e:
                # domain errors raised by handlers that bypass _rpc_json
                # (e.g. NoSuchBucket from a direct helper call) must
                # render as JSON 400s like every other admin error
                return web.json_response({"error": str(e)}, status=400)

        app = web.Application(middlewares=[bad_request_guard])
        app.router.add_get("/health", self.handle_health)
        app.router.add_get("/metrics", self.handle_metrics)
        app.router.add_get("/v1/status", self.handle_status)
        app.router.add_get("/v1/health", self.handle_health_detailed)
        app.router.add_post("/v1/connect", self.handle_connect)
        app.router.add_post("/v1/layout", self.handle_layout_update)
        app.router.add_get("/v1/layout", self.handle_layout_get)
        app.router.add_post("/v1/layout/apply", self.handle_layout_apply)
        app.router.add_post("/v1/layout/revert", self.handle_layout_revert)
        app.router.add_get("/v1/bucket", self.handle_bucket_get)
        app.router.add_post("/v1/bucket", self.handle_bucket_create)
        app.router.add_delete("/v1/bucket", self.handle_bucket_delete)
        app.router.add_put("/v1/bucket", self.handle_bucket_update)
        app.router.add_post("/v1/bucket/allow", self.handle_bucket_allow)
        app.router.add_post("/v1/bucket/deny", self.handle_bucket_deny)
        app.router.add_put("/v1/bucket/alias/global", self.handle_alias_global)
        app.router.add_delete(
            "/v1/bucket/alias/global", self.handle_unalias_global)
        app.router.add_get("/v1/key", self.handle_key_get)
        app.router.add_post("/v1/key", self.handle_key_post)
        app.router.add_post("/v1/key/import", self.handle_key_import)
        app.router.add_delete("/v1/key", self.handle_key_delete)
        app.router.add_put("/v1/bucket/alias/local", self.handle_alias_local)
        app.router.add_delete(
            "/v1/bucket/alias/local", self.handle_unalias_local)
        app.router.add_get("/check", self.handle_check_domain)
        app.router.add_get("/v1/timeline", self.handle_timeline)
        # v0 compat surface (ref api/admin/router_v0.rs:88-122): thin
        # aliases onto the v1 handlers — upstream v0 and v1 share their
        # request/response shapes for these routes (key.rs serves both);
        # the one behavioral difference is GetKeyInfo's secret default
        # (v0 always returned it; handle_key_get_v0 restores that).
        app.router.add_get("/v0/status", self.handle_status)
        app.router.add_get("/v0/health", self.handle_health_detailed)
        app.router.add_post("/v0/connect", self.handle_connect)
        app.router.add_get("/v0/layout", self.handle_layout_get)
        app.router.add_post("/v0/layout", self.handle_layout_update)
        app.router.add_post("/v0/layout/apply", self.handle_layout_apply)
        app.router.add_post("/v0/layout/revert", self.handle_layout_revert)
        app.router.add_get("/v0/bucket", self.handle_bucket_get)
        app.router.add_post("/v0/bucket", self.handle_bucket_create)
        app.router.add_delete("/v0/bucket", self.handle_bucket_delete)
        app.router.add_put("/v0/bucket", self.handle_bucket_update)
        app.router.add_post("/v0/bucket/allow", self.handle_bucket_allow)
        app.router.add_post("/v0/bucket/deny", self.handle_bucket_deny)
        app.router.add_put("/v0/bucket/alias/global", self.handle_alias_global)
        app.router.add_delete(
            "/v0/bucket/alias/global", self.handle_unalias_global)
        app.router.add_put("/v0/bucket/alias/local", self.handle_alias_local)
        app.router.add_delete(
            "/v0/bucket/alias/local", self.handle_unalias_local)
        app.router.add_get("/v0/key", self.handle_key_get_v0)
        app.router.add_post("/v0/key", self.handle_key_post)
        app.router.add_post("/v0/key/import", self.handle_key_import)
        app.router.add_delete("/v0/key", self.handle_key_delete)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        self._site = await start_site(self._runner, bind_addr)
        logger.info("Admin API listening on %s", bind_addr)

    @property
    def port(self) -> int:
        return self._site._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()

    # --- auth ---

    def _check_token(self, request: web.Request, token: Optional[str]) -> None:
        if token is None:
            raise web.HTTPForbidden(text="admin token not configured")
        auth = request.headers.get("Authorization", "")
        # compare bytes: compare_digest raises TypeError on non-ASCII str
        if not hmac.compare_digest(
            auth.encode("utf-8", "surrogateescape"),
            f"Bearer {token}".encode("utf-8", "surrogateescape"),
        ):
            raise web.HTTPForbidden(text="invalid bearer token")

    def _admin(self, request) -> None:
        self._check_token(request, self.garage.config.admin_token)

    # --- handlers ---

    async def handle_health(self, request) -> web.Response:
        """Quick liveness: 200 if we can serve quorum ops (ref
        api_server.rs /health)."""
        h = self.garage.system.health()
        status = 200 if h.status in ("healthy", "degraded") else 503
        return web.Response(status=status, text=h.status)

    async def handle_health_detailed(self, request) -> web.Response:
        self._admin(request)
        h = self.garage.system.health()
        return web.json_response({
            "status": h.status,
            "knownNodes": h.known_nodes,
            "connectedNodes": h.connected_nodes,
            "storageNodes": h.storage_nodes,
            "storageNodesOk": h.storage_nodes_ok,
            "partitions": h.partitions,
            "partitionsQuorum": h.partitions_quorum,
            "partitionsAllOk": h.partitions_all_ok,
        })

    async def handle_metrics(self, request) -> web.Response:
        """Prometheus exposition of every layer's metrics (ref
        api/admin/api_server.rs:271-335 + rpc/table/block/api metric
        structs).  `?exemplars=1` appends histogram exemplars — trace
        ids on max buckets — in the OpenMetrics suffix syntax.  This is
        an EXPLICIT opt-in only, never Accept-header sniffing: a stock
        Prometheus server advertises openmetrics-text on every scrape
        but selects its parser by the response Content-Type, and an
        exemplar suffix under text/plain would fail the whole scrape."""
        tok = self.garage.config.admin_metrics_token
        if tok is not None:
            self._check_token(request, tok)
        om = request.query.get("exemplars") == "1"
        body = metrics_body(self.garage, openmetrics=om)
        return web.Response(text=body, content_type="text/plain")

    async def handle_timeline(self, request) -> web.Response:
        """Chrome-trace (catapult) JSON of the device/transport
        pipeline timeline — load into chrome://tracing / Perfetto."""
        self._admin(request)
        limit = request.query.get("limit")
        tl = self.garage.block_manager.codec.obs.timeline
        return web.json_response(
            tl.chrome_trace(int(limit) if limit else None))

    async def handle_status(self, request) -> web.Response:
        self._admin(request)
        sys = self.garage.system
        return web.json_response({
            "node": bytes(sys.id).hex(),
            "garageVersion": "garage-tpu-0.1",
            "layoutVersion": sys.layout.version,
            "knownNodes": sys.get_known_nodes(),
            "roles": {
                nid.hex(): {"zone": r.zone, "capacity": r.capacity, "tags": r.tags}
                for nid, r in sys.layout.node_roles().items()
            },
        })

    async def handle_layout_get(self, request) -> web.Response:
        self._admin(request)
        sys = self.garage.system
        return web.json_response({
            "version": sys.layout.version,
            "roles": {
                nid.hex(): {"zone": r.zone, "capacity": r.capacity, "tags": r.tags}
                for nid, r in sys.layout.node_roles().items()
            },
            "stagedRoleChanges": {
                nid.hex(): (
                    {"zone": r.zone, "capacity": r.capacity, "tags": r.tags}
                    if r is not None else None
                )
                for nid, r in sys.layout.staged_roles().items()
            },
        })

    async def handle_layout_update(self, request) -> web.Response:
        self._admin(request)
        from ..rpc.layout import NodeRole

        body = json.loads(await request.read())
        sys = self.garage.system
        for nid_hex, role in body.get("roles", {}).items():
            nid = bytes.fromhex(nid_hex)
            if role is None:
                sys.layout.stage_role(nid, None)
            else:
                sys.layout.stage_role(nid, NodeRole(
                    zone=role["zone"], capacity=role.get("capacity"),
                    tags=role.get("tags", []),
                ))
        sys.save_layout()
        return web.json_response({"ok": True})

    async def handle_layout_apply(self, request) -> web.Response:
        self._admin(request)
        body = json.loads(await request.read() or b"{}")
        sys = self.garage.system
        msgs = sys.layout.apply_staged_changes(body.get("version"))
        sys.save_layout()
        sys._rebuild_ring()
        await sys.broadcast_layout()
        return web.json_response({"messages": msgs})

    async def handle_bucket_list(self, request) -> web.Response:
        self._admin(request)
        return await self._rpc_json(self._rpc._cmd_bucket_list, {})

    async def handle_bucket_create(self, request) -> web.Response:
        self._admin(request)
        body = json.loads(await request.read())
        b = await self.helper.create_bucket(body["globalAlias"])
        return web.json_response({"id": bytes(b.id).hex()})

    async def handle_key_list(self, request) -> web.Response:
        self._admin(request)
        return await self._rpc_json(self._rpc._cmd_key_list, {})

    async def handle_key_create(self, request) -> web.Response:
        self._admin(request)
        body = json.loads(await request.read() or b"{}")
        k = await self.helper.create_key(body.get("name", "unnamed"))
        return web.json_response({
            "accessKeyId": k.key_id,
            "secretAccessKey": k.params().secret_key,
        })

    # --- v1 endpoints delegating to the shared admin command set
    #     (ref api/admin/router_v1.rs:95-131) ---

    async def _rpc_json(self, fn, msg) -> web.Response:
        """Run one AdminRpcHandler command, render errors as 400 JSON."""
        try:
            return web.json_response(await fn(msg))
        except Exception as e:  # noqa: BLE001 — admin surface: report, 400
            logger.debug("admin v1 op failed: %s", e)
            return web.json_response({"error": str(e)}, status=400)

    async def handle_connect(self, request) -> web.Response:
        self._admin(request)
        body = json.loads(await request.read())
        # body = ["<id>@<addr>", ...] (ref ConnectClusterNodes)
        out = []
        for spec in body:
            nid, _, addr = spec.partition("@")
            try:
                await self._rpc._cmd_connect({"addr": addr, "node_id": nid})
                out.append({"success": True, "error": None})
            except Exception as e:  # noqa: BLE001
                out.append({"success": False, "error": str(e)})
        return web.json_response(out)

    async def handle_layout_revert(self, request) -> web.Response:
        self._admin(request)
        body = json.loads(await request.read() or b"{}")
        return await self._rpc_json(
            self._rpc._cmd_layout_revert, {"version": body.get("version")}
        )

    async def handle_bucket_get(self, request) -> web.Response:
        self._admin(request)
        bid = request.query.get("id")
        alias = request.query.get("globalAlias")
        if bid is None and alias is None:
            return await self.handle_bucket_list(request)
        return await self._rpc_json(
            self._rpc._cmd_bucket_info, {"bucket": bid or alias}
        )

    async def handle_bucket_delete(self, request) -> web.Response:
        self._admin(request)
        return await self._rpc_json(
            self._rpc._cmd_bucket_delete, {"bucket": request.query["id"]}
        )

    async def handle_bucket_update(self, request) -> web.Response:
        """UpdateBucket: websiteAccess and/or quotas (ref router_v1 PUT
        /v1/bucket?id=)."""
        self._admin(request)
        bid = request.query["id"]
        body = json.loads(await request.read() or b"{}")
        if "websiteAccess" in body:
            wa = body["websiteAccess"] or {}
            r = await self._rpc_json(self._rpc._cmd_bucket_website, {
                "bucket": bid,
                "allow": bool(wa.get("enabled")),
                "index_document": wa.get("indexDocument", "index.html"),
                "error_document": wa.get("errorDocument"),
            })
            if r.status != 200:
                return r
        if "quotas" in body:
            q = body["quotas"] or {}
            r = await self._rpc_json(self._rpc._cmd_bucket_set_quotas, {
                "bucket": bid,
                "max_size": q.get("maxSize"),
                "max_objects": q.get("maxObjects"),
            })
            if r.status != 200:
                return r
        return await self._rpc_json(self._rpc._cmd_bucket_info,
                                    {"bucket": bid})

    async def _bucket_perm(self, request, op: str) -> web.Response:
        self._admin(request)
        body = json.loads(await request.read())
        perms = body.get("permissions", {})
        return await self._rpc_json(
            getattr(self._rpc, f"_cmd_bucket_{op}"), {
                "bucket": body["bucketId"],
                "key": body["accessKeyId"],
                "read": perms.get("read"),
                "write": perms.get("write"),
                "owner": perms.get("owner"),
            }
        )

    async def handle_bucket_allow(self, request) -> web.Response:
        return await self._bucket_perm(request, "allow")

    async def handle_bucket_deny(self, request) -> web.Response:
        return await self._bucket_perm(request, "deny")

    async def handle_alias_global(self, request) -> web.Response:
        self._admin(request)
        return await self._rpc_json(self._rpc._cmd_bucket_alias, {
            "bucket": request.query["id"], "alias": request.query["alias"],
        })

    async def handle_unalias_global(self, request) -> web.Response:
        self._admin(request)
        return await self._rpc_json(self._rpc._cmd_bucket_unalias, {
            "alias": request.query["alias"],
        })

    async def handle_alias_local(self, request) -> web.Response:
        """PUT /v{0,1}/bucket/alias/local?id&accessKeyId&alias — a bucket
        name visible only through one access key (ref router_v0.rs:121,
        bucket_alias semantics in the bucket/key tables)."""
        self._admin(request)
        from ..utils.data import Uuid

        bid = bytes.fromhex(request.query["id"])
        kid = request.query["accessKeyId"]
        alias = request.query["alias"]
        helper = self.garage.helper()
        b = await helper.get_existing_bucket(Uuid(bid))
        key = await self.garage.key_table.get(kid, "")
        if key is None or key.is_deleted():
            return web.json_response(
                {"error": f"no such key {kid!r}"}, status=404)
        # refuse to repoint an in-use alias (mirror of the global-alias
        # guard): silently moving it would strand the old bucket's
        # local_aliases entry, inflating its name count past the
        # last-alias guard and making the stale entry undeletable
        cur = key.params().local_aliases.get(alias)
        if cur is not None and bytes(cur) != bytes(b.id):
            return web.json_response(
                {"error": f"alias {alias!r} already in use by this key "
                          "for another bucket"}, status=400)
        key.params().local_aliases.update(alias, bytes(b.id))
        b.params().local_aliases.update((kid, alias), True)
        await self.garage.key_table.insert(key)
        await self.garage.bucket_table.insert(b)
        return web.json_response({"ok": True})

    async def handle_unalias_local(self, request) -> web.Response:
        self._admin(request)
        from ..utils.data import Uuid

        bid = bytes.fromhex(request.query["id"])
        kid = request.query["accessKeyId"]
        alias = request.query["alias"]
        helper = self.garage.helper()
        b = await helper.get_existing_bucket(Uuid(bid))
        key = await self.garage.key_table.get(kid, "")
        if key is None or key.is_deleted():
            return web.json_response(
                {"error": f"no such key {kid!r}"}, status=404)
        cur = key.params().local_aliases.get(alias)
        if cur is None or bytes(cur) != bytes(b.id):
            return web.json_response(
                {"error": f"key has no local alias {alias!r} for this "
                          "bucket"}, status=400)
        # refuse to strip the bucket's last name (same rule as global
        # unalias: an unreachable bucket is an operator trap)
        if helper.bucket_name_count(b) <= 1:
            return web.json_response(
                {"error": "cannot remove the last alias of a bucket"},
                status=400)
        key.params().local_aliases.update(alias, None)
        b.params().local_aliases.update((kid, alias), False)
        await self.garage.key_table.insert(key)
        await self.garage.bucket_table.insert(b)
        return web.json_response({"ok": True})

    async def handle_key_get_v0(self, request) -> web.Response:
        """v0 GetKeyInfo always returned the secret key (v1 gates it
        behind showSecretKey=true; ref router_v0.rs:101-102)."""
        self._admin(request)
        kid = request.query.get("id")
        search = request.query.get("search")
        if kid is None and search is None:
            return await self.handle_key_list(request)
        return await self._rpc_json(self._rpc._cmd_key_info, {
            "key": kid or search, "show_secret": True,
        })

    async def handle_key_get(self, request) -> web.Response:
        self._admin(request)
        kid = request.query.get("id")
        search = request.query.get("search")
        if kid is None and search is None:
            return await self.handle_key_list(request)
        show_secret = request.query.get("showSecretKey") == "true"
        return await self._rpc_json(self._rpc._cmd_key_info, {
            "key": kid or search, "show_secret": show_secret,
        })

    async def handle_key_post(self, request) -> web.Response:
        """POST /v1/key?id= = UpdateKey; POST /v1/key = CreateKey."""
        kid = request.query.get("id")
        if kid is None:
            return await self.handle_key_create(request)
        self._admin(request)
        body = json.loads(await request.read() or b"{}")
        msg = {"key": kid, "name": body.get("name")}
        # allow/deny translate to the single tri-state handler field; an
        # absent directive must leave the flag untouched
        if (body.get("allow") or {}).get("createBucket"):
            msg["allow_create_bucket"] = True
        elif (body.get("deny") or {}).get("createBucket"):
            msg["allow_create_bucket"] = False
        return await self._rpc_json(self._rpc._cmd_key_set, msg)

    async def handle_key_import(self, request) -> web.Response:
        self._admin(request)
        body = json.loads(await request.read())
        return await self._rpc_json(self._rpc._cmd_key_import, {
            "id": body["accessKeyId"],
            "secret": body["secretAccessKey"],
            "name": body.get("name", "imported"),
        })

    async def handle_key_delete(self, request) -> web.Response:
        self._admin(request)
        return await self._rpc_json(self._rpc._cmd_key_delete, {
            "key": request.query["id"],
        })

    async def handle_check_domain(self, request) -> web.Response:
        """/check?domain= — used by reverse proxies to validate website
        domains (ref api_server.rs handle_check_website)."""
        domain = request.query.get("domain", "")
        from .common import host_to_bucket

        bucket_name = host_to_bucket(domain, self.garage.config.web_root_domain) or domain
        bid = await self.helper.resolve_global_bucket_name(bucket_name)
        if bid is None:
            return web.Response(status=404, text="no such bucket")
        b = await self.helper.get_existing_bucket(bid)
        if b.params().website_config.value is None:
            return web.Response(status=404, text="website not enabled")
        return web.Response(status=200, text="ok")
