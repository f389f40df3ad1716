"""S3 endpoint router.

Equivalent of reference src/api/s3/router.rs (SURVEY.md §2.7): maps
(method, bucket?, key?, query params, headers) to a named endpoint with
its required authorization level (Read / Write / Owner).  The reference
implements ~60 endpoints via the router_match! macro; here the dispatch
table is explicit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..common import BadRequestError, NotImplementedError_

READ, WRITE, OWNER, NONE = "read", "write", "owner", "none"


@dataclass
class Endpoint:
    name: str
    authorization: str
    bucket: Optional[str] = None
    key: Optional[str] = None
    query: Dict[str, str] = field(default_factory=dict)


# bucket-level subresources: query param → (GET endpoint, PUT, DELETE)
_BUCKET_SUBRESOURCES = {
    "website": ("GetBucketWebsite", "PutBucketWebsite", "DeleteBucketWebsite", OWNER),
    "cors": ("GetBucketCors", "PutBucketCors", "DeleteBucketCors", OWNER),
    "lifecycle": ("GetBucketLifecycle", "PutBucketLifecycle", "DeleteBucketLifecycle", OWNER),
    "versioning": ("GetBucketVersioning", None, None, READ),
    "location": ("GetBucketLocation", None, None, READ),
    "acl": ("GetBucketAcl", None, None, READ),
    "policy": ("GetBucketPolicy", None, None, OWNER),
}

# recognized-but-unimplemented subresources (ref router.rs parses all of
# these into named endpoints; the dispatch answers 501 NotImplemented).
# Without this table `GET /bucket?tagging` would silently route to
# ListObjects — a misroute, not a NotImplemented.
_BUCKET_SUBRESOURCES_UNIMPL = {
    "accelerate": "BucketAccelerateConfiguration",
    "analytics": "BucketAnalyticsConfiguration",
    "encryption": "BucketEncryption",
    "intelligent-tiering": "BucketIntelligentTieringConfiguration",
    "inventory": "BucketInventoryConfiguration",
    "logging": "BucketLogging",
    "metrics": "BucketMetricsConfiguration",
    "notification": "BucketNotificationConfiguration",
    "object-lock": "ObjectLockConfiguration",
    "ownershipControls": "BucketOwnershipControls",
    "policyStatus": "BucketPolicyStatus",
    "publicAccessBlock": "PublicAccessBlock",
    "replication": "BucketReplication",
    "requestPayment": "BucketRequestPayment",
    "tagging": "BucketTagging",
    "versions": "ListObjectVersions",
}

_OBJECT_SUBRESOURCES_UNIMPL = {
    "acl": "ObjectAcl",
    "legal-hold": "ObjectLegalHold",
    "retention": "ObjectRetention",
    "tagging": "ObjectTagging",
    "torrent": "ObjectTorrent",
    "restore": "RestoreObject",
    "select": "SelectObjectContent",
}


def parse_endpoint(
    method: str,
    bucket: Optional[str],
    key: Optional[str],
    query: List[Tuple[str, str]],
    headers: Dict[str, str],
) -> Endpoint:
    """ref router.rs Endpoint::from_request."""
    q = {k: v for k, v in query}
    m = method.upper()

    # CORS preflight: unauthenticated, handled before signature checks
    # (ref api_server.rs Endpoint::Options + cors.rs handle_options_s3api)
    if m == "OPTIONS":
        return Endpoint("Options", NONE, bucket, key, q)

    if bucket is None:
        if m == "GET":
            return Endpoint("ListBuckets", NONE)
        raise BadRequestError(f"no such API endpoint: {m} /")

    if key is None:
        return _bucket_endpoint(m, bucket, q, headers)
    return _object_endpoint(m, bucket, key, q, headers)


def _bucket_endpoint(m: str, bucket: str, q: Dict[str, str], headers) -> Endpoint:
    for sub, (get_ep, put_ep, del_ep, auth) in _BUCKET_SUBRESOURCES.items():
        if sub in q:
            if m == "GET" and get_ep:
                return Endpoint(get_ep, auth, bucket, query=q)
            if m == "PUT" and put_ep:
                return Endpoint(put_ep, OWNER, bucket, query=q)
            if m == "DELETE" and del_ep:
                return Endpoint(del_ep, OWNER, bucket, query=q)
            raise NotImplementedError_(f"{m} ?{sub} not supported")
    for sub, name in _BUCKET_SUBRESOURCES_UNIMPL.items():
        if sub in q:
            # All of these 501 at the catch-all, but verb/auth must still
            # match per-method intent: the List special-case (?versions)
            # applies to GET only — a PUT/DELETE on ?versions is a
            # mutation and keeps OWNER auth, not ListObjectVersions/READ.
            verb = {"GET": "Get", "PUT": "Put", "DELETE": "Delete"}.get(m, m)
            auth = READ if m == "GET" else OWNER
            if m == "GET" and name.startswith("List"):
                verb = ""
            return Endpoint(verb + name, auth, bucket, query=q)
    if m == "GET":
        if "uploads" in q:
            return Endpoint("ListMultipartUploads", READ, bucket, query=q)
        if q.get("list-type") == "2":
            return Endpoint("ListObjectsV2", READ, bucket, query=q)
        return Endpoint("ListObjects", READ, bucket, query=q)
    if m == "HEAD":
        return Endpoint("HeadBucket", READ, bucket)
    if m == "PUT":
        return Endpoint("CreateBucket", NONE, bucket)
    if m == "DELETE":
        return Endpoint("DeleteBucket", OWNER, bucket)
    if m == "POST":
        if "delete" in q:
            return Endpoint("DeleteObjects", WRITE, bucket, query=q)
        return Endpoint("PostObject", NONE, bucket)
    raise BadRequestError(f"no such API endpoint: {m} on bucket")


def _object_endpoint(m: str, bucket: str, key: str, q: Dict[str, str], headers) -> Endpoint:
    copy_source = headers.get("x-amz-copy-source")
    for sub, name in _OBJECT_SUBRESOURCES_UNIMPL.items():
        if sub in q:
            if name in ("RestoreObject", "SelectObjectContent"):
                return Endpoint(name, WRITE if name == "RestoreObject" else READ,
                                bucket, key, q)
            verb = {"GET": "Get", "PUT": "Put", "DELETE": "Delete"}.get(m, m)
            return Endpoint(verb + name, READ if m == "GET" else WRITE,
                            bucket, key, q)
    if m == "GET":
        if "uploadId" in q:
            return Endpoint("ListParts", READ, bucket, key, q)
        return Endpoint("GetObject", READ, bucket, key, q)
    if m == "HEAD":
        return Endpoint("HeadObject", READ, bucket, key, q)
    if m == "PUT":
        if "partNumber" in q and "uploadId" in q:
            if copy_source is not None:
                return Endpoint("UploadPartCopy", WRITE, bucket, key, q)
            return Endpoint("UploadPart", WRITE, bucket, key, q)
        if copy_source is not None:
            return Endpoint("CopyObject", WRITE, bucket, key, q)
        return Endpoint("PutObject", WRITE, bucket, key, q)
    if m == "POST":
        if "uploads" in q:
            return Endpoint("CreateMultipartUpload", WRITE, bucket, key, q)
        if "uploadId" in q:
            return Endpoint("CompleteMultipartUpload", WRITE, bucket, key, q)
    if m == "DELETE":
        if "uploadId" in q:
            return Endpoint("AbortMultipartUpload", WRITE, bucket, key, q)
        return Endpoint("DeleteObject", WRITE, bucket, key, q)
    raise BadRequestError(f"no such API endpoint: {m} on object")
