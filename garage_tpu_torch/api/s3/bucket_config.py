"""Bucket configuration endpoints: website, CORS, lifecycle.

Equivalent of reference src/api/s3/website.rs + cors.rs + lifecycle.rs
(SURVEY.md §2.7): XML get/put/delete of per-bucket configs stored as LWW
CRDTs in the bucket params, plus `find_matching_cors_rule` used by both
the S3 server and the static web server.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Any, Dict, List, Optional

from aiohttp import web

from ..common import ApiError, BadRequestError, s3_xml_root, xml_to_bytes


def _ns(root) -> str:
    return root.tag[: root.tag.index("}") + 1] if root.tag.startswith("{") else ""


async def _update_bucket(ctx, mutate) -> None:
    bucket = await ctx.server.helper.get_existing_bucket(ctx.bucket_id)
    mutate(bucket.params())
    await ctx.garage.bucket_table.insert(bucket)


# --- website ---------------------------------------------------------------


async def handle_get_website(ctx) -> web.Response:
    wc = ctx.bucket.params().website_config.value
    if wc is None:
        raise ApiError(
            "no website configuration", status=404,
            code="NoSuchWebsiteConfiguration",
        )
    out = s3_xml_root("WebsiteConfiguration")
    idx = ET.SubElement(out, "IndexDocument")
    ET.SubElement(idx, "Suffix").text = wc.get("index_document", "index.html")
    if wc.get("error_document"):
        err = ET.SubElement(out, "ErrorDocument")
        ET.SubElement(err, "Key").text = wc["error_document"]
    return web.Response(status=200, body=xml_to_bytes(out), content_type="application/xml")


async def handle_put_website(ctx) -> web.Response:
    body = await ctx.read_body_verified()
    try:
        root = ET.fromstring(body.decode())
    except ET.ParseError as e:
        raise BadRequestError(f"malformed WebsiteConfiguration: {e}")
    ns = _ns(root)
    suffix = root.findtext(f"{ns}IndexDocument/{ns}Suffix")
    if suffix is None:
        raise BadRequestError("IndexDocument.Suffix is required")
    error_doc = root.findtext(f"{ns}ErrorDocument/{ns}Key")
    wc = {"index_document": suffix, "error_document": error_doc}
    await _update_bucket(ctx, lambda p: p.website_config.update(wc))
    return web.Response(status=200)


async def handle_delete_website(ctx) -> web.Response:
    await _update_bucket(ctx, lambda p: p.website_config.update(None))
    return web.Response(status=204)


# --- CORS ------------------------------------------------------------------


async def handle_get_cors(ctx) -> web.Response:
    rules = ctx.bucket.params().cors_config.value
    if rules is None:
        raise ApiError(
            "no CORS configuration", status=404, code="NoSuchCORSConfiguration"
        )
    out = s3_xml_root("CORSConfiguration")
    for r in rules:
        el = ET.SubElement(out, "CORSRule")
        if r.get("id"):
            ET.SubElement(el, "ID").text = r["id"]
        for o in r.get("allow_origins", []):
            ET.SubElement(el, "AllowedOrigin").text = o
        for m in r.get("allow_methods", []):
            ET.SubElement(el, "AllowedMethod").text = m
        for hh in r.get("allow_headers", []):
            ET.SubElement(el, "AllowedHeader").text = hh
        for e in r.get("expose_headers", []):
            ET.SubElement(el, "ExposeHeader").text = e
        if r.get("max_age_seconds") is not None:
            ET.SubElement(el, "MaxAgeSeconds").text = str(r["max_age_seconds"])
    return web.Response(status=200, body=xml_to_bytes(out), content_type="application/xml")


async def handle_put_cors(ctx) -> web.Response:
    body = await ctx.read_body_verified()
    try:
        root = ET.fromstring(body.decode())
    except ET.ParseError as e:
        raise BadRequestError(f"malformed CORSConfiguration: {e}")
    ns = _ns(root)
    rules = []
    for el in root.findall(f"{ns}CORSRule"):
        rule = {
            "id": el.findtext(f"{ns}ID"),
            "allow_origins": [x.text or "" for x in el.findall(f"{ns}AllowedOrigin")],
            "allow_methods": [x.text or "" for x in el.findall(f"{ns}AllowedMethod")],
            "allow_headers": [x.text or "" for x in el.findall(f"{ns}AllowedHeader")],
            "expose_headers": [x.text or "" for x in el.findall(f"{ns}ExposeHeader")],
        }
        ma = el.findtext(f"{ns}MaxAgeSeconds")
        rule["max_age_seconds"] = int(ma) if ma is not None else None
        rules.append(rule)
    await _update_bucket(ctx, lambda p: p.cors_config.update(rules))
    return web.Response(status=200)


async def handle_delete_cors(ctx) -> web.Response:
    await _update_bucket(ctx, lambda p: p.cors_config.update(None))
    return web.Response(status=204)


def cors_request_headers(request) -> List[str]:
    """Parse Access-Control-Request-Headers into a list (ref cors.rs
    split(',')+trim) — shared by the S3 dispatch, preflight, and web
    server so the parsing can't diverge."""
    return [
        h.strip()
        for h in request.headers.get(
            "Access-Control-Request-Headers", "").split(",")
        if h.strip()
    ]


def find_matching_cors_rule(
    rules: Optional[List[Dict]], method: str, origin: Optional[str],
    request_headers: List[str],
) -> Optional[Dict]:
    """ref cors.rs find_matching_cors_rule."""
    if not rules or origin is None:
        return None
    for r in rules:
        if method not in r.get("allow_methods", []) and "*" not in r.get("allow_methods", []):
            continue
        origins = r.get("allow_origins", [])
        ok = any(
            o == "*" or o == origin
            or (o.count("*") == 1 and _glob_match(o, origin))
            for o in origins
        )
        if not ok:
            continue
        allowed = [h.lower() for h in r.get("allow_headers", [])]
        if "*" not in allowed and any(h.lower() not in allowed for h in request_headers):
            continue
        return r
    return None


def _glob_match(pattern: str, s: str) -> bool:
    pre, _, post = pattern.partition("*")
    return s.startswith(pre) and s.endswith(post) and len(s) >= len(pre) + len(post)


def apply_cors_headers(resp_headers: Dict[str, str], rule: Dict, origin: str) -> None:
    resp_headers["Access-Control-Allow-Origin"] = (
        "*" if "*" in rule.get("allow_origins", []) else origin
    )
    if rule.get("expose_headers"):
        resp_headers["Access-Control-Expose-Headers"] = ", ".join(rule["expose_headers"])


def add_cors_headers(resp_headers: Dict[str, str], rule: Dict,
                     origin: str) -> None:
    """Full CORS header set on a matched rule.  Allow-Origin must be ONE
    origin or '*' (browsers reject lists — the reference comma-joins the
    configured origins, cors.rs add_cors_headers, which no browser
    accepts for multi-origin rules); we echo the matched request origin
    like apply_cors_headers does."""
    resp_headers["Access-Control-Allow-Origin"] = (
        "*" if "*" in rule.get("allow_origins", []) else origin
    )
    resp_headers["Access-Control-Allow-Methods"] = ", ".join(
        rule.get("allow_methods", []))
    resp_headers["Access-Control-Allow-Headers"] = ", ".join(
        rule.get("allow_headers", []))
    resp_headers["Access-Control-Expose-Headers"] = ", ".join(
        rule.get("expose_headers", []))


async def handle_options_s3api(server, request, bucket_name) -> web.Response:
    """Unauthenticated CORS preflight (ref cors.rs:90-136
    handle_options_s3api): a global bucket's CORS rules apply; an
    unresolvable name gets the permissive response (could be a local
    alias — preflights can't authenticate); no bucket = ListBuckets,
    open to GET from anywhere."""
    if bucket_name is not None:
        bid = await server.helper.resolve_global_bucket_name(bucket_name)
        if bid is not None:
            bucket = await server.helper.get_existing_bucket(bid)
            return handle_options_for_bucket(request, bucket)
        return web.Response(status=200, headers={
            "Access-Control-Allow-Origin": "*",
            "Access-Control-Allow-Methods": "*",
        })
    return web.Response(status=200, headers={
        "Access-Control-Allow-Origin": "*",
        "Access-Control-Allow-Methods": "GET",
    })


def handle_options_for_bucket(request, bucket) -> web.Response:
    """ref cors.rs:138-170 handle_options_for_bucket."""
    origin = request.headers.get("Origin")
    if origin is None:
        raise BadRequestError("Missing Origin header")
    req_method = request.headers.get("Access-Control-Request-Method")
    if req_method is None:
        raise BadRequestError("Missing Access-Control-Request-Method header")
    req_headers = cors_request_headers(request)
    rules = bucket.params().cors_config.value
    rule = find_matching_cors_rule(rules, req_method, origin, req_headers)
    if rule is not None:
        headers: Dict[str, str] = {}
        add_cors_headers(headers, rule, origin)
        return web.Response(status=200, headers=headers)
    raise ApiError("This CORS request is not allowed.", status=403,
                   code="AccessDenied")


# --- lifecycle -------------------------------------------------------------


async def handle_get_lifecycle(ctx) -> web.Response:
    rules = ctx.bucket.params().lifecycle_config.value
    if rules is None:
        raise ApiError(
            "no lifecycle configuration", status=404,
            code="NoSuchLifecycleConfiguration",
        )
    out = s3_xml_root("LifecycleConfiguration")
    for r in rules:
        el = ET.SubElement(out, "Rule")
        if r.get("id"):
            ET.SubElement(el, "ID").text = r["id"]
        ET.SubElement(el, "Status").text = "Enabled" if r.get("enabled", True) else "Disabled"
        f = ET.SubElement(el, "Filter")
        preds = [
            (tag, r[k])
            for tag, k in (
                ("Prefix", "prefix"),
                ("ObjectSizeGreaterThan", "size_gt"),
                ("ObjectSizeLessThan", "size_lt"),
            )
            if r.get(k) not in (None, "")
        ]
        # AWS XML: 2+ predicates must be wrapped in <And>
        parent = ET.SubElement(f, "And") if len(preds) > 1 else f
        for tag, v in preds:
            ET.SubElement(parent, tag).text = str(v)
        if r.get("expiration_days") is not None or r.get("expiration_date"):
            ex = ET.SubElement(el, "Expiration")
            if r.get("expiration_days") is not None:
                ET.SubElement(ex, "Days").text = str(r["expiration_days"])
            if r.get("expiration_date"):
                ET.SubElement(ex, "Date").text = r["expiration_date"]
        if r.get("abort_incomplete_days") is not None:
            ab = ET.SubElement(el, "AbortIncompleteMultipartUpload")
            ET.SubElement(ab, "DaysAfterInitiation").text = str(r["abort_incomplete_days"])
    return web.Response(status=200, body=xml_to_bytes(out), content_type="application/xml")


async def handle_put_lifecycle(ctx) -> web.Response:
    body = await ctx.read_body_verified()
    try:
        root = ET.fromstring(body.decode())
    except ET.ParseError as e:
        raise BadRequestError(f"malformed LifecycleConfiguration: {e}")
    ns = _ns(root)
    rules = []
    for el in root.findall(f"{ns}Rule"):
        status = el.findtext(f"{ns}Status") or "Enabled"
        # AWS wraps multiple Filter predicates in <And>; single predicates
        # sit directly under <Filter>; Prefix may also be legacy top-level
        prefix = (
            el.findtext(f"{ns}Filter/{ns}And/{ns}Prefix")
            or el.findtext(f"{ns}Filter/{ns}Prefix")
            or el.findtext(f"{ns}Prefix")  # legacy top-level form
            or ""
        )
        days = el.findtext(f"{ns}Expiration/{ns}Days")
        date = el.findtext(f"{ns}Expiration/{ns}Date")
        abort_days = el.findtext(
            f"{ns}AbortIncompleteMultipartUpload/{ns}DaysAfterInitiation"
        )
        size_gt = (
            el.findtext(f"{ns}Filter/{ns}And/{ns}ObjectSizeGreaterThan")
            or el.findtext(f"{ns}Filter/{ns}ObjectSizeGreaterThan")
        )
        size_lt = (
            el.findtext(f"{ns}Filter/{ns}And/{ns}ObjectSizeLessThan")
            or el.findtext(f"{ns}Filter/{ns}ObjectSizeLessThan")
        )

        def _int(v, what):
            if v is None:
                return None
            try:
                return int(v)
            except ValueError:
                raise BadRequestError(f"{what} must be an integer, got {v!r}")

        days = _int(days, "Expiration Days")
        if days is not None and days <= 0:
            raise BadRequestError("Expiration Days must be positive")
        rules.append({
            "id": el.findtext(f"{ns}ID"),
            "enabled": status == "Enabled",
            "prefix": prefix,
            "size_gt": _int(size_gt, "ObjectSizeGreaterThan"),
            "size_lt": _int(size_lt, "ObjectSizeLessThan"),
            "expiration_days": days,
            "expiration_date": date,
            "abort_incomplete_days": _int(abort_days, "DaysAfterInitiation"),
        })
    await _update_bucket(ctx, lambda p: p.lifecycle_config.update(rules))
    return web.Response(status=200)


async def handle_delete_lifecycle(ctx) -> web.Response:
    await _update_bucket(ctx, lambda p: p.lifecycle_config.update(None))
    return web.Response(status=204)


HANDLERS = {
    "GetBucketWebsite": handle_get_website,
    "PutBucketWebsite": handle_put_website,
    "DeleteBucketWebsite": handle_delete_website,
    "GetBucketCors": handle_get_cors,
    "PutBucketCors": handle_put_cors,
    "DeleteBucketCors": handle_delete_cors,
    "GetBucketLifecycle": handle_get_lifecycle,
    "PutBucketLifecycle": handle_put_lifecycle,
    "DeleteBucketLifecycle": handle_delete_lifecycle,
}
