"""Bucket-level endpoints: ListBuckets, Create/Delete/HeadBucket,
location/versioning/acl stubs.

Equivalent of reference src/api/s3/bucket.rs (356 LoC): bucket creation
applies the key's permissions immediately; deletion requires emptiness
(delegated to the model helper).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

from aiohttp import web

from ...model.permission import BucketKeyPerm
from ..common import (
    AccessDeniedError,
    iso_timestamp as _iso,
    s3_xml_root,
    xml_to_bytes,
)


async def handle_list_buckets(ctx) -> web.Response:
    """ListBuckets: all buckets this key may read (ref bucket.rs:40-100)."""
    key = ctx.api_key
    helper = ctx.server.helper
    out = s3_xml_root("ListAllMyBucketsResult")
    owner = ET.SubElement(out, "Owner")
    ET.SubElement(owner, "ID").text = key.key_id
    ET.SubElement(owner, "DisplayName").text = key.params().name.value
    buckets_el = ET.SubElement(out, "Buckets")

    seen = set()
    params = key.params()
    ids = [bid for bid in params.authorized_buckets.items.keys()
           if key.allow_read(bid)]
    for bid in ids:
        try:
            bucket = await helper.get_existing_bucket(bid)
        except Exception:
            continue
        bp = bucket.params()
        names = [n for n, lww in bp.aliases.items.items() if lww.value]
        for alias, lww in params.local_aliases.items.items():
            if lww.value == bytes(bid):
                names.append(alias)
        for name in sorted(set(names)):
            if name in seen:
                continue
            seen.add(name)
            b = ET.SubElement(buckets_el, "Bucket")
            ET.SubElement(b, "Name").text = name
            ET.SubElement(b, "CreationDate").text = _iso(bp.creation_date)
    return web.Response(
        status=200, body=xml_to_bytes(out), content_type="application/xml"
    )


async def handle_create_bucket(ctx) -> web.Response:
    """ref bucket.rs create: needs allow_create_bucket or existing perms."""
    key = ctx.api_key
    helper = ctx.server.helper
    name = ctx.bucket_name
    existing = await helper.resolve_global_bucket_name(name)
    if existing is not None:
        if key.allow_owner(existing) or key.allow_write(existing):
            # idempotent re-create of own bucket (S3 returns 200 outside
            # us-east-1 semantics; garage accepts)
            return web.Response(status=200, headers={"Location": f"/{name}"})
        raise AccessDeniedError("bucket exists and is not yours")
    if not key.params().allow_create_bucket.value:
        raise AccessDeniedError(
            f"key {key.key_id} is not allowed to create buckets"
        )
    bucket = await helper.create_bucket(name)
    await helper.set_bucket_key_permissions(
        bucket.id, key.key_id, BucketKeyPerm(True, True, True)
    )
    return web.Response(status=200, headers={"Location": f"/{name}"})


async def handle_delete_bucket(ctx) -> web.Response:
    await ctx.server.helper.delete_bucket(ctx.bucket_id)
    return web.Response(status=204)


async def handle_head_bucket(ctx) -> web.Response:
    return web.Response(status=200)


async def handle_get_location(ctx) -> web.Response:
    out = s3_xml_root("LocationConstraint")
    out.text = ctx.server.region
    return web.Response(
        status=200, body=xml_to_bytes(out), content_type="application/xml"
    )


async def handle_get_versioning(ctx) -> web.Response:
    # versioning is not supported (ref bucket.rs handle_get_versioning)
    out = s3_xml_root("VersioningConfiguration")
    return web.Response(
        status=200, body=xml_to_bytes(out), content_type="application/xml"
    )


async def handle_get_acl(ctx) -> web.Response:
    key = ctx.api_key
    out = s3_xml_root("AccessControlPolicy")
    owner = ET.SubElement(out, "Owner")
    ET.SubElement(owner, "ID").text = key.key_id
    acl = ET.SubElement(out, "AccessControlList")
    grant = ET.SubElement(acl, "Grant")
    grantee = ET.SubElement(grant, "Grantee")
    ET.SubElement(grantee, "ID").text = key.key_id
    ET.SubElement(grant, "Permission").text = "FULL_CONTROL"
    return web.Response(
        status=200, body=xml_to_bytes(out), content_type="application/xml"
    )
