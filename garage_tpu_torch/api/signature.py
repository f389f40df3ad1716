"""AWS Signature Version 4 verification.

Equivalent of reference src/api/signature/ (SURVEY.md §2.7):
  - header authentication: `Authorization: AWS4-HMAC-SHA256 Credential=…,
    SignedHeaders=…, Signature=…` (payload.rs:20-100+): rebuild the
    canonical request from the raw request, derive the signing key from
    the API key's secret, compare signatures, check scope (date/region/
    service).
  - presigned query authentication: `X-Amz-Algorithm=…&X-Amz-Credential=…`
    with expiry check (payload.rs presigned branch).
  - streaming payload signatures: `STREAMING-AWS4-HMAC-SHA256-PAYLOAD`
    bodies arrive as `<hex-size>;chunk-signature=<sig>\\r\\n<data>\\r\\n`
    chunks, each signed over the previous signature (streaming.rs:17-60+),
    exposed here as an async stream transformer.

Secret lookup goes through the key table; the caller passes an async
`get_key(key_id) -> Optional[Key]`.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse
from typing import AsyncIterator, Dict, List, Optional, Tuple

from ..utils.error import GarageError

ALGORITHM = "AWS4-HMAC-SHA256"
UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
SERVICE = "s3"


class AuthError(GarageError):
    """403 Forbidden (ref common_error.rs Forbidden)."""

    status = 403
    code = "AccessDenied"


class InvalidRequest(GarageError):
    status = 400
    code = "InvalidRequest"


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret: str, date: str, region: str, service: str = SERVICE) -> bytes:
    """AWS4 key derivation chain."""
    k = _hmac(b"AWS4" + secret.encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def uri_encode(s: str, encode_slash: bool = True) -> str:
    """AWS canonical URI encoding (ref encoding.rs)."""
    safe = "-_.~" if encode_slash else "-_.~/"
    return urllib.parse.quote(s, safe=safe)


def canonical_query_string(query: List[Tuple[str, str]], skip_sig: bool = False) -> str:
    items = [
        (uri_encode(k), uri_encode(v))
        for k, v in query
        if not (skip_sig and k == "X-Amz-Signature")
    ]
    items.sort()
    return "&".join(f"{k}={v}" for k, v in items)


def canonical_query_string_raw(
    raw_query: List[Tuple[str, str]], skip_sig: bool = False
) -> str:
    """Canonical query from the RAW (still percent-encoded, as sent) pairs:
    sort and join without re-encoding, so the signature covers exactly the
    client's wire encoding (the reference signs the raw query, payload.rs).
    X-Amz-Signature is unreserved-only so the raw name matches literally."""
    items = sorted(
        p for p in raw_query if not (skip_sig and p[0] == "X-Amz-Signature")
    )
    return "&".join(f"{k}={v}" for k, v in items)


def canonical_request(
    method: str,
    path: str,
    query: List[Tuple[str, str]],
    headers: Dict[str, str],
    signed_headers: List[str],
    payload_hash: str,
    skip_sig_param: bool = False,
    raw_path: Optional[str] = None,
    raw_query: Optional[List[Tuple[str, str]]] = None,
) -> str:
    # Sign over the URI exactly as the client sent it (raw_path) when the
    # server can supply it; clients whose wire encoding differs from our
    # re-encoding of the decoded path (literal %2F in keys, '+' in values)
    # would otherwise get spurious SignatureDoesNotMatch.  The re-encoding
    # branch remains for client-side signing, where `path` is logical.
    canon_uri = raw_path if raw_path is not None else uri_encode(
        path, encode_slash=False
    )
    if raw_query is not None:
        canon_query = canonical_query_string_raw(raw_query, skip_sig=skip_sig_param)
    else:
        canon_query = canonical_query_string(query, skip_sig=skip_sig_param)
    canon_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n" for h in signed_headers
    )
    return "\n".join([
        method.upper(),
        canon_uri,
        canon_query,
        canon_headers,
        ";".join(signed_headers),
        payload_hash,
    ])


def string_to_sign(timestamp: str, scope: str, canon_req: str) -> str:
    return "\n".join([
        ALGORITHM,
        timestamp,
        scope,
        hashlib.sha256(canon_req.encode()).hexdigest(),
    ])


class Credential:
    __slots__ = ("key_id", "date", "region", "service")

    def __init__(self, raw: str):
        parts = raw.split("/")
        if len(parts) != 5 or parts[4] != "aws4_request":
            raise InvalidRequest(f"invalid credential {raw!r}")
        self.key_id, self.date, self.region, self.service = parts[:4]

    @property
    def scope(self) -> str:
        return f"{self.date}/{self.region}/{self.service}/aws4_request"


class VerifiedRequest:
    """Result of signature verification."""

    __slots__ = ("key", "content_sha256", "signature", "credential", "timestamp")

    def __init__(self, key, content_sha256: Optional[str], signature: str,
                 credential: Credential, timestamp: str):
        self.key = key                      # model Key entry (None = anonymous)
        self.content_sha256 = content_sha256  # None=unsigned, "STREAMING"=chunked
        self.signature = signature
        self.credential = credential
        self.timestamp = timestamp


def _parse_auth_header(auth: str) -> Dict[str, str]:
    if not auth.startswith(ALGORITHM):
        raise InvalidRequest("unsupported authorization algorithm")
    out = {}
    for item in auth[len(ALGORITHM):].split(","):
        item = item.strip()
        if "=" in item:
            k, v = item.split("=", 1)
            out[k.strip()] = v.strip()
    for req in ("Credential", "SignedHeaders", "Signature"):
        if req not in out:
            raise InvalidRequest(f"missing {req} in Authorization")
    return out


def raw_query_pairs(raw_query_string: str) -> List[Tuple[str, str]]:
    """Split a raw (still-encoded) query string into (name, value) pairs
    without decoding, preserving the client's exact wire encoding."""
    out: List[Tuple[str, str]] = []
    for part in raw_query_string.split("&"):
        if not part:
            continue
        if "=" in part:
            k, v = part.split("=", 1)
            out.append((k, v))
        else:
            out.append((part, ""))
    return out


async def check_signature(
    get_key,
    region: str,
    method: str,
    path: str,
    query: List[Tuple[str, str]],
    headers: Dict[str, str],
    raw_path: Optional[str] = None,
    raw_query: Optional[List[Tuple[str, str]]] = None,
) -> VerifiedRequest:
    """Verify header or presigned-query SigV4 (ref payload.rs:20-100+).
    `headers` keys must be lowercase.  `raw_path`/`raw_query` are the
    still-encoded wire forms; when given, the canonical request is built
    from them (decoded `path`/`query` stay for parameter lookups)."""
    qdict = dict(query)
    if "Authorization" in headers or "authorization" in headers:
        return await _check_header_signature(
            get_key, region, method, path, query, headers, raw_path, raw_query
        )
    if qdict.get("X-Amz-Algorithm") == ALGORITHM:
        return await _check_presigned_signature(
            get_key, region, method, path, query, headers, raw_path, raw_query
        )
    raise AuthError("no signature: anonymous access denied")


async def _lookup(get_key, cred: Credential, region: str):
    if cred.region != region and cred.region != "":
        raise AuthError(
            f"scope region {cred.region!r} does not match {region!r}"
        )
    key = await get_key(cred.key_id)
    if key is None:
        raise AuthError(f"no such key: {cred.key_id}")
    return key


async def _check_header_signature(
    get_key, region, method, path, query, headers,
    raw_path=None, raw_query=None,
) -> VerifiedRequest:
    auth = _parse_auth_header(headers.get("authorization", headers.get("Authorization", "")))
    cred = Credential(auth["Credential"])
    signed_headers = auth["SignedHeaders"].split(";")
    if "host" not in signed_headers:
        raise InvalidRequest("host must be a signed header")
    timestamp = headers.get("x-amz-date")
    if not timestamp:
        raise InvalidRequest("missing x-amz-date")
    if timestamp[:8] != cred.date:
        raise AuthError("x-amz-date does not match credential scope date")
    content_sha256 = headers.get("x-amz-content-sha256")
    if content_sha256 is None:
        raise InvalidRequest("missing x-amz-content-sha256")

    key = await _lookup(get_key, cred, region)
    canon = canonical_request(
        method, path, query, headers, signed_headers, content_sha256,
        raw_path=raw_path, raw_query=raw_query,
    )
    sts = string_to_sign(timestamp, cred.scope, canon)
    sk = signing_key(key.params().secret_key, cred.date, cred.region, cred.service)
    expected = hmac.new(sk, sts.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(expected, auth["Signature"]):
        raise AuthError("signature mismatch")

    if content_sha256 == UNSIGNED_PAYLOAD:
        sha = None
    elif content_sha256 == STREAMING_PAYLOAD:
        sha = "STREAMING"
    else:
        sha = content_sha256
    return VerifiedRequest(key, sha, auth["Signature"], cred, timestamp)


async def _check_presigned_signature(
    get_key, region, method, path, query, headers,
    raw_path=None, raw_query=None,
) -> VerifiedRequest:
    q = dict(query)
    cred = Credential(q.get("X-Amz-Credential", ""))
    timestamp = q.get("X-Amz-Date", "")
    if not timestamp:
        raise InvalidRequest("missing X-Amz-Date")
    try:
        t0 = datetime.datetime.strptime(timestamp, "%Y%m%dT%H%M%SZ").replace(
            tzinfo=datetime.timezone.utc
        )
    except ValueError:
        raise InvalidRequest("bad X-Amz-Date")
    try:
        expires = int(q.get("X-Amz-Expires", "86400"))
    except ValueError:
        raise InvalidRequest("bad X-Amz-Expires")
    if not 1 <= expires <= 7 * 86400:
        # AWS caps presigned validity at 7 days
        raise InvalidRequest("X-Amz-Expires out of range")
    now = datetime.datetime.now(datetime.timezone.utc)
    if now > t0 + datetime.timedelta(seconds=expires):
        raise AuthError("presigned URL expired")
    signed_headers = q.get("X-Amz-SignedHeaders", "host").split(";")
    signature = q.get("X-Amz-Signature", "")

    key = await _lookup(get_key, cred, region)
    canon = canonical_request(
        method, path, query, headers, signed_headers, UNSIGNED_PAYLOAD,
        skip_sig_param=True, raw_path=raw_path, raw_query=raw_query,
    )
    sts = string_to_sign(timestamp, cred.scope, canon)
    sk = signing_key(key.params().secret_key, cred.date, cred.region, cred.service)
    expected = hmac.new(sk, sts.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(expected, signature):
        raise AuthError("presigned signature mismatch")
    return VerifiedRequest(key, None, signature, cred, timestamp)


# --- streaming chunked payloads (ref signature/streaming.rs) ---------------


class StreamingPayloadError(GarageError):
    status = 403
    code = "SignatureDoesNotMatch"


async def decode_streaming_body(
    body: AsyncIterator[bytes],
    secret: str,
    cred: Credential,
    seed_signature: str,
    timestamp: str,
) -> AsyncIterator[bytes]:
    """Decode `aws-chunked` content, verifying each chunk signature
    (ref streaming.rs:17-60+).  Chunk string-to-sign:
    AWS4-HMAC-SHA256-PAYLOAD \\n ts \\n scope \\n prev_sig \\n
    sha256("") \\n sha256(chunk)."""
    sk = signing_key(secret, cred.date, cred.region, cred.service)
    prev_sig = seed_signature
    empty_sha = hashlib.sha256(b"").hexdigest()

    buf = bytearray()
    it = body.__aiter__()
    eof = False

    async def fill(n: int) -> None:
        nonlocal eof
        while len(buf) < n and not eof:
            try:
                buf.extend(await it.__anext__())
            except StopAsyncIteration:
                eof = True

    async def read_line() -> bytes:
        while True:
            i = buf.find(b"\r\n")
            if i >= 0:
                line = bytes(buf[:i])
                del buf[: i + 2]
                return line
            if eof:
                raise StreamingPayloadError("truncated chunk stream")
            await fill(len(buf) + 1)

    while True:
        header = await read_line()
        if b";" in header:
            size_hex, rest = header.split(b";", 1)
            if not rest.startswith(b"chunk-signature="):
                raise StreamingPayloadError("missing chunk-signature")
            chunk_sig = rest[len(b"chunk-signature="):].decode()
        else:
            raise StreamingPayloadError("malformed chunk header")
        try:
            size = int(size_hex, 16)
        except ValueError:
            raise StreamingPayloadError(f"bad chunk size {size_hex!r}")
        await fill(size + 2)
        if len(buf) < size + 2:
            raise StreamingPayloadError("truncated chunk data")
        data = bytes(buf[:size])
        if bytes(buf[size : size + 2]) != b"\r\n":
            raise StreamingPayloadError("missing chunk trailer CRLF")
        del buf[: size + 2]

        sts = "\n".join([
            "AWS4-HMAC-SHA256-PAYLOAD",
            timestamp,
            cred.scope,
            prev_sig,
            empty_sha,
            hashlib.sha256(data).hexdigest(),
        ])
        expected = hmac.new(sk, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(expected, chunk_sig):
            raise StreamingPayloadError("chunk signature mismatch")
        prev_sig = expected
        if size == 0:
            return
        yield data


# --- client-side signing (for tests, CLI and the web/k2v clients) ----------


def sign_request(
    key_id: str,
    secret: str,
    region: str,
    method: str,
    path: str,
    query: List[Tuple[str, str]],
    headers: Dict[str, str],
    payload: bytes = b"",
    timestamp: Optional[str] = None,
    path_is_raw: bool = False,
) -> Dict[str, str]:
    """Produce the headers for a header-authenticated request (the
    reference keeps an equivalent in tests/common/custom_requester.rs).
    Returns headers to add; input `headers` must include host.
    With `path_is_raw`, `path` is the exact wire form (already
    percent-encoded) and is signed verbatim — required for keys whose
    decoded form re-encodes differently (literal %2F), since the server
    verifies against the raw wire path."""
    now = timestamp or datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y%m%dT%H%M%SZ"
    )
    date = now[:8]
    payload_hash = hashlib.sha256(payload).hexdigest()
    hdrs = {k.lower(): v for k, v in headers.items()}
    hdrs["x-amz-date"] = now
    hdrs["x-amz-content-sha256"] = payload_hash
    signed = sorted(set(list(hdrs.keys()) + ["host"]))
    cred = Credential(f"{key_id}/{date}/{region}/{SERVICE}/aws4_request")
    canon = canonical_request(
        method, path, query, hdrs, signed, payload_hash,
        raw_path=path if path_is_raw else None,
    )
    sts = string_to_sign(now, cred.scope, canon)
    sk = signing_key(secret, date, region)
    sig = hmac.new(sk, sts.encode(), hashlib.sha256).hexdigest()
    return {
        "x-amz-date": now,
        "x-amz-content-sha256": payload_hash,
        "Authorization": (
            f"{ALGORITHM} Credential={cred.key_id}/{cred.scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}"
        ),
    }
