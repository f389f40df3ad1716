"""K2V HTTP API.

Equivalent of reference src/api/k2v/ (SURVEY.md §2.7, ≈2100 LoC):
  - item ops (item.rs): GET/PUT/DELETE /{bucket}/{partition}/{sort}; reads
    return the causality token in X-Garage-Causality-Token and either a
    single raw value (octet-stream; 409 on conflict) or a JSON array of
    base64 values / null tombstones; writes take the token to supersede.
  - PollItem (long-poll) via ?causality_token=…&timeout=… on GET.
  - ReadIndex (index.rs): GET /{bucket}?start&end&limit over the partition
    counter table.
  - batch ops (batch.rs): POST /{bucket} = InsertBatch, ?search =
    ReadBatch, ?delete = DeleteBatch.
SigV4-authenticated like the S3 API, same key/bucket permission model.
"""

from __future__ import annotations

import base64
import json
import logging
from typing import Optional

from aiohttp import web

from ..model.helper import NoSuchBucket, NoSuchKey
from ..model.k2v.causality import CausalContext
from ..utils.error import GarageError
from ..utils.tracing import deadline_scope
from .common import (
    AccessDeniedError,
    ApiError,
    BadRequestError,
    NoSuchBucketError,
    NoSuchKeyError,
    admit_request,
    client_deadline_budget,
    error_response,
    int_param,
    request_deadline_budget,
    request_trace,
    slo_service_latency,
    start_site,
)
from .signature import check_signature, raw_query_pairs

logger = logging.getLogger("garage_tpu_torch.api.k2v")

CAUSALITY_HEADER = "X-Garage-Causality-Token"


def parse_poll_timeout(raw) -> float:
    """Client long-poll window → seconds in (0, 600].  The value is
    client-controlled: non-numeric raises a typed 400 (not a 500 out of
    float()), and NaN/non-positive are rejected too — nan would poison
    every downstream deadline comparison and the event loop's timer
    heap (same invariant as the budget-extension parse above)."""
    try:
        t = float(raw)
    except (TypeError, ValueError):
        raise BadRequestError(f"invalid poll timeout: {raw!r}")
    if not (t == t) or t <= 0:
        raise BadRequestError(f"invalid poll timeout: {raw!r}")
    return min(t, 600.0)


class K2VApiServer:
    def __init__(self, garage):
        self.garage = garage
        self.helper = garage.helper()
        self.region = garage.config.s3_region
        # node-wide admission gate + request deadline budget, shared with
        # the S3 server (docs/ROBUSTNESS.md "Overload & brownout")
        self.gate = getattr(garage, "admission", None)
        # SLO burn-rate tracker (utils/slo.py): K2V requests classify
        # by method ("K2V:GET", …) — sheds included
        self.slo = getattr(garage, "slo", None)
        self.deadline_s = request_deadline_budget(garage.config)
        self._runner: Optional[web.AppRunner] = None

    async def start(self, bind_addr: str) -> None:
        app = web.Application(client_max_size=64 * 1024 * 1024)
        app.router.add_route("*", "/{tail:.*}", self.handle_request)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        self._site = await start_site(self._runner, bind_addr)
        logger.info("K2V API listening on %s", bind_addr)

    @property
    def port(self) -> int:
        return self._site._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()

    async def handle_request(self, request: web.Request) -> web.StreamResponse:
        # admission first, before signature/trace/body — shed typed
        # (503 SlowDown + Retry-After + RequestId) instead of queueing.
        # Tenant-classified (access key, fallback bucket) with the
        # gossiped pressure of the bucket's placement nodes folded in,
        # exactly like the S3 front door.
        remote_p, remote_due = 0.0, 0.0
        probe = getattr(self.garage, "admission_probe", None)
        seg = request.rel_url.raw_path.lstrip("/").split("/", 1)[0]
        import urllib.parse as _up

        bname = _up.unquote(seg) if seg else None
        if probe is not None:
            remote_p, _hot, remote_due = probe.pressure(bname)
        # long polls legitimately outlive the default request budget:
        # give them their requested window on top of it.  The value is
        # client-controlled: only FINITE values in [0, 600] extend —
        # nan would poison every downstream deadline comparison and
        # the event loop's timer heap, and a negative value must not
        # silently shrink the budget
        budget = self.deadline_s
        if budget is not None and "timeout" in request.query:
            try:
                t = float(request.query["timeout"])
            except ValueError:
                t = 0.0
            if t == t and t > 0:
                budget += min(t, 600.0)
        # a client-supplied X-Request-Timeout tightens the final budget
        # (never extends — even a long poll honors an explicit tighter
        # client bound); armed BEFORE admission so WDRR queue time
        # spends the budget instead of stacking on top of it
        budget = client_deadline_budget(budget, request)
        import time as _time

        t_intake_ns = _time.time_ns()
        with deadline_scope(budget):
            token, shed = await admit_request(
                self.gate, request, remote_pressure=remote_p, bucket=bname,
                remote_due_s=remote_due)
            t_admitted_ns = _time.time_ns()
            if shed is not None:
                if self.slo is not None:
                    self.slo.note(f"K2V:{request.method}",
                                  (_time.time_ns() - t_intake_ns) / 1e9,
                                  ok=False)
                return shed
            if token is not None:
                # the long-poll handlers park this token while waiting so
                # pollers don't starve the in-flight watermark
                request["admission_token"] = token
            try:
                tracer = self.garage.system.tracer
                trace, rid = request_trace(
                    tracer, "K2V", "k2v", request, start_ns=t_intake_ns)
                if t_admitted_ns > t_intake_ns:
                    # the waterfall's `admission` segment (root is
                    # backdated to intake, so this lands inside it)
                    tracer.record_span(
                        "admission", trace.trace_id, trace.span_id,
                        t_intake_ns, t_admitted_ns)
                with trace:
                    resp = await self._handle_with_errors(request, rid)
                    trace.set_attr("status", resp.status)
                    if self.slo is not None:
                        # long-polls (PollItem/PollRange) wait out the
                        # CLIENT's chosen window — excluded from the
                        # latency SLO by the shared helper
                        lat_s, paced = slo_service_latency(
                            request, token, t_intake_ns)
                        self.slo.note(
                            f"K2V:{request.method}", lat_s,
                            ok=resp.status < 500, client_paced=paced)
                    if not resp.prepared:
                        resp.headers["x-amz-request-id"] = rid
                    return resp
            finally:
                if token is not None:
                    token.release()

    async def _handle_with_errors(self, request, rid: str) -> web.StreamResponse:
        try:
            return await self._handle(request)
        except (ApiError, NoSuchBucket, NoSuchKey, GarageError) as e:
            status = getattr(e, "status", 500)
            if status >= 500 and status != 503:
                logger.exception("K2V API internal error")
            else:
                logger.debug("K2V API error %s: %s", status, e)
            return error_response(e, request.path, rid)
        except ConnectionError as e:  # incl. ConnectionResetError
            logger.debug("client disconnected mid-request: %s", e)
            raise
        except Exception as e:  # noqa: BLE001
            logger.exception("K2V API error")
            return error_response(e, request.path, rid)

    async def _handle(self, request: web.Request) -> web.StreamResponse:
        headers = {k.lower(): v for k, v in request.headers.items()}

        async def get_key(key_id: str):
            k = await self.garage.key_table.get(key_id, "")
            if k is None or k.is_deleted():
                return None
            return k

        query = [(k, v) for k, v in request.query.items()]
        verified = await check_signature(
            get_key, self.region, request.method, request.path, query, headers,
            raw_path=request.rel_url.raw_path,
            raw_query=raw_query_pairs(request.rel_url.raw_query_string),
        )
        api_key = verified.key

        import urllib.parse

        parts = [
            urllib.parse.unquote(p)
            for p in request.rel_url.raw_path.lstrip("/").split("/")
        ]
        if not parts or parts[0] == "":
            raise BadRequestError("missing bucket in path")
        bucket_name = parts[0]
        pk = parts[1] if len(parts) > 1 and parts[1] != "" else None
        sk = parts[2] if len(parts) > 2 else None

        bucket_id = await self.helper.resolve_bucket(bucket_name, api_key)
        probe = getattr(self.garage, "admission_probe", None)
        if probe is not None:
            probe.note_bucket(bucket_name, bytes(bucket_id))
        m = request.method
        # Classify the endpoint BEFORE the permission check (ref
        # src/api/k2v/router.rs authorization_type): ReadBatch (POST
        # ?search) and PollRange are reads even though they are POSTs;
        # everything else follows the method (GET=read, PUT/POST/DELETE
        # mutations=write).
        qk = request.query
        if m == "GET":
            needs = "read"
        elif m == "POST" and (
            (pk is None and "search" in qk)
            or (pk is not None and sk is None and "poll_range" in qk)
        ):
            needs = "read"
        else:
            needs = "write"
        allowed = (
            api_key.allow_read(bucket_id) if needs == "read"
            else api_key.allow_write(bucket_id)
        )
        if not allowed:
            raise AccessDeniedError(f"no {needs} permission on {bucket_name}")

        q = request.query
        if pk is None:
            if m == "GET":
                return await self.read_index(bucket_id, q)
            if m == "POST":
                if "search" in q:
                    return await self.read_batch(bucket_id, request)
                if "delete" in q:
                    return await self.delete_batch(bucket_id, request)
                return await self.insert_batch(bucket_id, request)
            raise BadRequestError(f"no such K2V endpoint: {m} /bucket")
        if sk is None and "poll_range" in q:
            # POST only (ref router.rs); the permission classification
            # above treats only the POST form as a read
            if m != "POST":
                raise BadRequestError("PollRange is POST")
            return await self.poll_range(bucket_id, pk, request)
        if sk is None:
            raise BadRequestError("missing sort key")
        if m == "GET":
            if "causality_token" in q and "timeout" in q:
                return await self.poll_item(bucket_id, pk, sk, q, headers,
                                            request)
            return await self.read_item(bucket_id, pk, sk, headers)
        if m == "PUT":
            return await self.insert_item(bucket_id, pk, sk, request, headers)
        if m == "DELETE":
            return await self.delete_item(bucket_id, pk, sk, headers)
        raise BadRequestError(f"no such K2V endpoint: {m} on item")

    # --- item ops (ref api/k2v/item.rs) ---

    async def _get_item(self, bucket_id, pk, sk):
        return await self.garage.k2v_item_table.get((bytes(bucket_id), pk), sk)

    def _item_response(self, item, headers) -> web.Response:
        token = item.causal_context().serialize()
        vals = item.values()
        accept = headers.get("accept", "*/*")
        wants_json = "application/json" in accept
        wants_raw = "application/octet-stream" in accept
        live = [v for v in vals if v is not None]
        if not live:
            raise NoSuchKeyError("item is deleted")
        if wants_raw or (not wants_json and len(live) == 1 and len(vals) == 1):
            if len(vals) > 1:
                raise ApiError(
                    "multiple concurrent values; use Accept: application/json",
                    status=409, code="Conflict",
                )
            return web.Response(
                status=200, body=live[0],
                headers={CAUSALITY_HEADER: token},
                content_type="application/octet-stream",
            )
        body = json.dumps([
            base64.b64encode(v).decode() if v is not None else None
            for v in vals
        ])
        return web.Response(
            status=200, body=body.encode(),
            headers={CAUSALITY_HEADER: token},
            content_type="application/json",
        )

    async def read_item(self, bucket_id, pk, sk, headers) -> web.Response:
        item = await self._get_item(bucket_id, pk, sk)
        if item is None:
            raise NoSuchKeyError(f"no such K2V item: {pk}/{sk}")
        return self._item_response(item, headers)

    async def insert_item(self, bucket_id, pk, sk, request, headers) -> web.Response:
        value = await request.read()
        ct = headers.get(CAUSALITY_HEADER.lower())
        context = CausalContext.parse(ct) if ct else None
        await self.garage.k2v_rpc.insert(bucket_id, pk, sk, context, value)
        return web.Response(status=204)

    async def delete_item(self, bucket_id, pk, sk, headers) -> web.Response:
        ct = headers.get(CAUSALITY_HEADER.lower())
        context = CausalContext.parse(ct) if ct else None
        await self.garage.k2v_rpc.insert(bucket_id, pk, sk, context, None)
        return web.Response(status=204)

    async def poll_item(self, bucket_id, pk, sk, q, headers,
                        request=None) -> web.Response:
        context = CausalContext.parse(q["causality_token"])
        timeout = parse_poll_timeout(q.get("timeout", "300"))
        # park the admission slot for the poll window: a long poll holds
        # no node resources while waiting, and N pollers must not brown
        # out PUT/GET admission for up to 600 s each
        token = request.get("admission_token") if request is not None else None
        if request is not None:
            # poll duration is the client's chosen window, not service
            # latency: keep it out of the latency SLO even when no
            # admission token exists to carry the CoDel exclusion
            request["slo_client_paced"] = True
        if token is not None:
            token.park()
        try:
            item = await self.garage.k2v_rpc.poll_item(
                bucket_id, pk, sk, context, timeout
            )
        finally:
            if token is not None:
                token.unpark()
        if item is None:
            return web.Response(status=304)  # not modified within timeout
        return self._item_response(item, headers)

    # --- index (ref api/k2v/index.rs) ---

    async def read_index(self, bucket_id, q) -> web.Response:
        start = q.get("start")
        end = q.get("end")
        prefix = q.get("prefix")
        limit = min(int_param(q.get("limit"), "limit", 1000), 1000)
        ent = await self.garage.k2v_counter_table.get_range(
            bytes(bucket_id), start, filter=None, limit=limit + 1,
        )
        partitions = []
        for ce in ent:
            pk = ce.sk
            if prefix and not pk.startswith(prefix):
                continue
            if end is not None and pk >= end:
                break
            t = ce.totals()
            if t.get("items", 0) <= 0:
                continue
            partitions.append({
                "pk": pk,
                "entries": t.get("items", 0),
                "conflicts": t.get("conflicts", 0),
                "values": t.get("values", 0),
                "bytes": t.get("bytes", 0),
            })
        truncated = len(partitions) > limit
        partitions = partitions[:limit]
        return web.json_response({
            "prefix": prefix,
            "start": start,
            "end": end,
            "limit": limit,
            "partitionKeys": partitions,
            "more": truncated,
            "nextStart": partitions[-1]["pk"] if truncated else None,
        })

    # --- batch ops (ref api/k2v/batch.rs) ---

    async def insert_batch(self, bucket_id, request) -> web.Response:
        try:
            body = json.loads(await request.read())
            items = [
                (
                    it["pk"], it["sk"],
                    CausalContext.parse(it["ct"]) if it.get("ct") else None,
                    base64.b64decode(it["v"]) if it.get("v") is not None else None,
                )
                for it in body
            ]
        except (ValueError, KeyError, TypeError) as e:
            raise BadRequestError(f"malformed InsertBatch body: {e}")
        await self.garage.k2v_rpc.insert_many(bucket_id, items)
        return web.Response(status=204)

    async def read_batch(self, bucket_id, request) -> web.Response:
        try:
            queries = json.loads(await request.read())
            assert isinstance(queries, list)
        except (ValueError, AssertionError) as e:
            raise BadRequestError(f"malformed ReadBatch body: {e}")
        out = []
        for sq in queries:
            out.append(await self._search(bucket_id, sq))
        return web.json_response(out)

    async def _search(self, bucket_id, sq) -> dict:
        pk = sq.get("partitionKey")
        if pk is None:
            raise BadRequestError("search missing partitionKey")
        limit = max(1, min(int(sq.get("limit") or 1000), 1000))
        start = sq.get("start")
        end = sq.get("end")
        prefix = sq.get("prefix")
        if start is None and prefix is not None:
            # seed the scan at the prefix (ref batch.rs start.unwrap_or
            # (prefix)): scanning from the partition head and post-
            # filtering would return an empty not-truncated page when the
            # first window holds no matching keys
            start = prefix
        single = sq.get("singleItem", False)
        conflicts_only = sq.get("conflictsOnly", False)
        tombstones = sq.get("tombstones", False)

        if single:
            item = await self._get_item(bucket_id, pk, start or "")
            items = [item] if item is not None else []
        else:
            # ALWAYS range-read with filter="any" and filter AFTER the
            # quorum merge: a liveness filter pushed to the replicas makes
            # a node that already holds a tombstone return nothing while a
            # lagging node returns the stale live value — the merge then
            # RESURRECTS deleted items (the reference's ItemFilter is
            # applied post-merge for the same reason, k2v/batch.rs:171).
            # Pagination stays raw-entry-based (nextStart may be a
            # tombstone), so pages can carry fewer visible items; clients
            # follow `more`/nextStart as usual.
            raw = await self.garage.k2v_item_table.get_range(
                (bytes(bucket_id), pk), start, filter="any", limit=limit + 1,
            )
            if prefix:
                raw = [i for i in raw if i.sort_key_str.startswith(prefix)]
            if end is not None:
                raw = [i for i in raw if i.sort_key_str < end]
            # pagination over RAW entries (a tombstone-heavy page must
            # still report more/nextStart or clients stop early)
            truncated = len(raw) > limit
            raw = raw[:limit]
            if conflicts_only:
                items = [i for i in raw if len(i.values()) > 1]
            elif tombstones:
                items = raw
            else:
                items = [i for i in raw if i.live_values()]
            return self._search_result(pk, prefix, start, end, limit,
                                       single, items, truncated,
                                       raw[-1].sort_key_str if truncated
                                       else None)
        return self._search_result(pk, prefix, start, end, limit, single,
                                   items, False, None)

    @staticmethod
    def _search_result(pk, prefix, start, end, limit, single, items, more,
                       next_start) -> dict:
        return {
            "partitionKey": pk,
            "prefix": prefix,
            "start": start,
            "end": end,
            "limit": limit,
            "singleItem": single,
            "items": [
                {
                    "sk": i.sort_key_str,
                    "ct": i.causal_context().serialize(),
                    "v": [
                        base64.b64encode(v).decode() if v is not None else None
                        for v in i.values()
                    ],
                }
                for i in items
            ],
            "more": more,
            "nextStart": next_start,
        }

    async def delete_batch(self, bucket_id, request) -> web.Response:
        try:
            queries = json.loads(await request.read())
            assert isinstance(queries, list)
        except (ValueError, AssertionError) as e:
            raise BadRequestError(f"malformed DeleteBatch body: {e}")
        out = []
        for dq in queries:
            pk = dq.get("partitionKey")
            if pk is None:
                raise BadRequestError("delete missing partitionKey")
            if dq.get("singleItem"):
                sk = dq.get("start") or ""
                item = await self._get_item(bucket_id, pk, sk)
                n = 0
                if item is not None and item.live_values():
                    await self.garage.k2v_rpc.insert(
                        bucket_id, pk, sk, item.causal_context(), None
                    )
                    n = 1
                out.append({"partitionKey": pk, "singleItem": True, "deletedItems": n})
            else:
                # Walk the WHOLE range (the reference reads it unbounded,
                # batch.rs:209-220) in raw pages: filter="any" + post-merge
                # liveness so a lagging replica can't resurrect deleted
                # items (see _search), and only LIVE items are tombstoned —
                # re-killing tombstones would make deletedItems never
                # converge to zero.  Each page's kills go out as ONE
                # batched insert (a sequential per-item quorum insert makes
                # a 1000-item range delete take minutes).
                end = dq.get("end")
                prefix = dq.get("prefix")
                start = dq.get("start")
                n = 0
                while True:
                    items = await self.garage.k2v_item_table.get_range(
                        (bytes(bucket_id), pk), start, filter="any",
                        limit=1000,
                    )
                    doomed = [
                        (pk, i.sort_key_str, i.causal_context(), None)
                        for i in items
                        if i.live_values()
                        and not (prefix
                                 and not i.sort_key_str.startswith(prefix))
                        and not (end is not None and i.sort_key_str >= end)
                    ]
                    if doomed:
                        await self.garage.k2v_rpc.insert_many(
                            bucket_id, doomed)
                        n += len(doomed)
                    if len(items) < 1000:
                        break
                    last = items[-1].sort_key_str
                    if end is not None and last >= end:
                        break
                    start = last + "\x00"
                out.append({"partitionKey": pk, "singleItem": False,
                            "deletedItems": n})
        return web.json_response(out)

    # --- poll range (ref api/k2v/range.rs + k2v/seen.rs) ---

    async def poll_range(self, bucket_id, pk, request) -> web.Response:
        try:
            body = json.loads(await request.read() or b"{}")
        except ValueError as e:
            raise BadRequestError(f"malformed PollRange body: {e}")
        timeout = parse_poll_timeout(body.get("timeout", 300))
        prefix = body.get("prefix")
        start = body.get("start")
        end = body.get("end")
        seen = body.get("seenMarker")
        # seen marker = {sort_key: causality token} of what the client saw
        seen_map = {}
        if seen:
            try:
                seen_map = {
                    k: CausalContext.parse(v)
                    for k, v in json.loads(
                        base64.urlsafe_b64decode(seen.encode()).decode()
                    ).items()
                }
            except Exception:
                raise BadRequestError("invalid seenMarker")

        def matches(i):
            if prefix and not i.sort_key_str.startswith(prefix):
                return False
            if start is not None and i.sort_key_str < start:
                return False
            if end is not None and i.sort_key_str >= end:
                return False
            return True

        def is_new(i):
            old = seen_map.get(i.sort_key_str)
            return old is None or i.causal_context().is_newer_than(old)

        subs = self.garage.k2v_subscriptions
        q = subs.subscribe_range(bucket_id, pk)
        try:
            items = await self.garage.k2v_item_table.get_range(
                (bytes(bucket_id), pk), start, filter="any", limit=1000,
            )
            fresh = [i for i in items if matches(i) and is_new(i)]
            if not fresh:
                import time as _time

                # park the admission slot for the wait (same rationale as
                # poll_item: a parked poller must not starve the gate)
                request["slo_client_paced"] = True
                token = request.get("admission_token")
                if token is not None:
                    token.park()
                try:
                    deadline = _time.monotonic() + timeout
                    while not fresh:
                        remain = deadline - _time.monotonic()
                        if remain <= 0:
                            return web.Response(status=304)
                        try:
                            import asyncio as _asyncio

                            cand = await _asyncio.wait_for(
                                q.get(), timeout=remain)
                        except Exception:
                            return web.Response(status=304)
                        if matches(cand) and is_new(cand):
                            fresh = [cand]
                finally:
                    if token is not None:
                        token.unpark()
            for i in fresh:
                seen_map[i.sort_key_str] = i.causal_context()
            marker = base64.urlsafe_b64encode(json.dumps({
                k: v.serialize() for k, v in seen_map.items()
            }).encode()).decode()
            return web.json_response({
                "items": [
                    {
                        "sk": i.sort_key_str,
                        "ct": i.causal_context().serialize(),
                        "v": [
                            base64.b64encode(v).decode() if v is not None else None
                            for v in i.values()
                        ],
                    }
                    for i in fresh
                ],
                "seenMarker": marker,
            })
        finally:
            subs.unsubscribe_range(bucket_id, pk, q)
