"""PostObject — browser form uploads (multipart/form-data).

Equivalent of reference src/api/s3/post_object.rs:1-507: parse the
multipart form (fields before the `file` part), verify the POST policy
document — signature = hex(HMAC-SHA256(SigV4 signing key, base64 policy))
(ref signature/payload.rs:322-359 verify_v4) — check its expiration and
match every provided form field against the policy's eq / starts-with /
content-length-range conditions, then stream the file through the same
save_stream path as PutObject.  Responds per success_action_redirect /
success_action_status (204 default / 200 / 201-with-XML / 303 redirect).
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import json
import urllib.parse
import xml.etree.ElementTree as ET
from typing import AsyncIterator, Dict, Optional, Tuple

from aiohttp import web

from ...model.s3.object_table import ObjectVersionHeaders
from ..common import (
    AccessDeniedError,
    ApiError,
    BadRequestError,
    s3_xml_root,
    xml_to_bytes,
)
from ..signature import AuthError, Credential, signing_key
from .put import request_scope, save_stream

FIELD_LIMIT = 16 * 1024          # per-field size (ref post_object.rs:37-41)
FILE_LIMIT = 5 * 1024**3         # max file part

# fields the policy never needs to cover (ref post_object.rs:158-160)
ALWAYS_ALLOWED = {"policy", "x-amz-signature"}


class _PolicyConditions:
    """Parsed policy conditions (ref post_object.rs Policy::into_conditions):
    params: lowercased field -> [("eq"|"starts-with", value)];
    content_length: inclusive (min, max)."""

    def __init__(self, raw: list):
        self.params: Dict[str, list] = {}
        lo, hi = 0, (1 << 63)
        for cond in raw:
            if isinstance(cond, dict):
                if len(cond) != 1:
                    raise BadRequestError("invalid policy item")
                (k, v), = cond.items()
                self.params.setdefault(k.lower(), []).append(("eq", str(v)))
            elif isinstance(cond, list) and len(cond) == 3 and \
                    cond[0] == "content-length-range":
                lo = max(lo, int(cond[1]))
                hi = min(hi, int(cond[2]))
            elif isinstance(cond, list) and len(cond) == 3:
                op, key, value = cond
                if not isinstance(key, str) or not key.startswith("$"):
                    raise BadRequestError("invalid policy item")
                if op not in ("eq", "starts-with"):
                    raise BadRequestError("invalid policy item")
                self.params.setdefault(key[1:].lower(), []).append(
                    (op, str(value))
                )
            else:
                raise BadRequestError("invalid policy item")
        self.content_length = (lo, hi)

    def check(self, field: str, value: str, override_value: Optional[str] = None):
        """Consume and verify the conditions for one provided field
        (ref post_object.rs:154-220)."""
        if field in ALWAYS_ALLOWED:
            return
        if field.startswith("x-ignore-"):
            # AWS quirk: x-ignore-* fields skip checking but their policy
            # entries are NOT consumed (so they fail the required-check)
            return
        conds = self.params.pop(field, None)
        if conds is None:
            raise BadRequestError(f"key {field!r} is not allowed in policy")
        v = override_value if override_value is not None else value
        for op, s in conds:
            if op == "eq":
                ok = s == v
            elif field == "content-type":
                ok = all(part.startswith(s) for part in v.split(","))
            else:
                ok = v.startswith(s)
            if not ok:
                raise BadRequestError(
                    f"key {field!r} has value not allowed in policy"
                )


async def handle_post_object(server, request: web.Request,
                             bucket_name: str) -> web.Response:
    garage = server.garage
    try:
        reader = await request.multipart()
    except (ValueError, AssertionError) as e:
        raise BadRequestError(f"could not parse multipart body: {e}")

    params: Dict[str, str] = {}
    file_part = None
    async for part in reader:
        name = (part.name or "").lower()
        if name == "file":
            file_part = part
            break
        text = (await part.read_chunk(FIELD_LIMIT + 1)).decode(
            "utf-8", "replace"
        )
        if len(text) > FIELD_LIMIT:
            raise BadRequestError(f"field {name!r} too large")
        if name == "tag":
            continue  # tags unsupported, match reference behavior
        if name == "acl":
            name = "x-amz-acl"
        if name in params:
            raise BadRequestError(f"field {name!r} provided more than once")
        params[name] = text
    if file_part is None:
        raise BadRequestError("request did not contain a file")

    key = params.get("key")
    if key is None:
        raise BadRequestError("no key was provided")
    credential = params.get("x-amz-credential")
    if credential is None:
        raise AccessDeniedError("anonymous access is not supported")
    policy_b64 = params.get("policy")
    if policy_b64 is None:
        raise BadRequestError("no policy was provided")
    signature = params.get("x-amz-signature")
    if signature is None:
        raise BadRequestError("no signature was provided")
    if "x-amz-date" not in params:
        raise BadRequestError("no date was provided")

    if "${filename}" in key and file_part.filename:
        key = key.replace("${filename}", file_part.filename)

    # --- verify the policy signature (ref payload.rs:322-359) ---
    cred = Credential(credential)
    if cred.region not in (server.region, ""):
        raise AuthError(f"scope region {cred.region!r} mismatch")
    api_key = await garage.key_table.get(cred.key_id, "")
    if api_key is None or api_key.is_deleted():
        raise AuthError(f"no such key: {cred.key_id}")
    sk = signing_key(
        api_key.params().secret_key, cred.date, cred.region, cred.service
    )
    expected = hmac.new(sk, policy_b64.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(expected, signature):
        raise AuthError("invalid policy signature")

    bucket_id = await server.helper.resolve_bucket(bucket_name, api_key)
    if not api_key.allow_write(bucket_id):
        raise AccessDeniedError("no write permission on bucket")
    bucket = await server.helper.get_existing_bucket(bucket_id)

    # --- decode + check the policy document ---
    try:
        policy = json.loads(base64.b64decode(policy_b64))
        expiration = policy["expiration"]
        if not isinstance(expiration, str):
            raise TypeError("expiration must be a string")
        conditions = _PolicyConditions(policy["conditions"])
    except (ValueError, KeyError, TypeError) as e:
        raise BadRequestError(f"invalid policy: {e}")
    try:
        exp = datetime.datetime.fromisoformat(expiration.replace("Z", "+00:00"))
    except ValueError:
        raise BadRequestError("invalid expiration date")
    if exp.tzinfo is None:
        exp = exp.replace(tzinfo=datetime.timezone.utc)
    if datetime.datetime.now(datetime.timezone.utc) > exp:
        raise BadRequestError("policy expired")

    for field, value in params.items():
        # the `key` condition checks the post-${filename} substitution
        conditions.check(field, value, override_value=key if field == "key" else None)
    if conditions.params:
        missing = next(iter(conditions.params))
        raise BadRequestError(
            f"key {missing!r} is required in policy but no value was provided"
        )

    headers = _headers_from_params(params)
    lo, hi = conditions.content_length
    hi = min(hi, FILE_LIMIT)  # 5 GiB single-part cap regardless of policy

    class _Ctx:
        """Minimal RequestContext stand-in for save_stream."""
        pass

    ctx = _Ctx()
    ctx.garage = garage
    ctx.request = request
    ctx.bucket_id = bucket_id
    ctx.bucket = bucket

    # size violations raise from inside the stream (over-max early,
    # under-min at EOF) so save_stream's cleanup aborts the version
    with request_scope(garage):
        etag, _size = await save_stream(
            ctx, _limited_stream(file_part, lo, hi), headers, key
        )

    etag_q = f'"{etag}"'
    redirect = params.get("success_action_redirect")
    if redirect is not None:
        u = urllib.parse.urlparse(redirect)
        if u.scheme in ("http", "https"):
            sep = "&" if u.query else "?"
            target = (
                redirect + sep + urllib.parse.urlencode(
                    {"bucket": bucket_name, "key": key, "etag": etag_q}
                )
            )
            return web.Response(
                status=303, headers={"Location": target, "ETag": etag_q},
                body=target.encode(),
            )

    host = request.headers.get("Host", "")
    base_path = request.path.rstrip("/") + "/"
    key_part = urllib.parse.quote(key)
    location = f"https://{host}{base_path}{key_part}" \
        if host else base_path + key_part
    action = params.get("success_action_status", "204")
    if action == "200":
        return web.Response(
            status=200, headers={"Location": location, "ETag": etag_q}
        )
    if action == "201":
        out = s3_xml_root("PostResponse")
        ET.SubElement(out, "Location").text = location
        ET.SubElement(out, "Bucket").text = bucket_name
        ET.SubElement(out, "Key").text = key
        ET.SubElement(out, "ETag").text = etag_q
        return web.Response(
            status=201, headers={"Location": location, "ETag": etag_q},
            body=xml_to_bytes(out), content_type="application/xml",
        )
    return web.Response(status=204, headers={"Location": location, "ETag": etag_q})


def _headers_from_params(params: Dict[str, str]) -> Dict:
    """Stored headers from the form fields (ref put.rs get_headers over the
    collected param HeaderMap)."""
    other = {}
    for h in (
        "cache-control", "content-disposition", "content-encoding",
        "content-language", "expires",
    ):
        if h in params:
            other[h] = params[h]
    for k, v in params.items():
        if k.startswith("x-amz-meta-"):
            other[k] = v
    return ObjectVersionHeaders.new(
        params.get("content-type", "application/octet-stream"), other
    )


async def _limited_stream(part, lo: int, hi: int) -> AsyncIterator[bytes]:
    """Stream the file part, failing early once the max length is exceeded
    (ref post_object.rs StreamLimiter)."""
    read = 0
    while True:
        chunk = await part.read_chunk(64 * 1024)
        if not chunk:
            if read < lo:
                raise BadRequestError("file size does not match policy")
            break
        read += len(chunk)
        if read > hi:
            raise BadRequestError("file size does not match policy")
        yield chunk
