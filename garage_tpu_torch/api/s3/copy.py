"""CopyObject / UploadPartCopy — server-side copies.

Equivalent of reference src/api/s3/copy.rs (693 LoC, SURVEY.md §2.7):
CopyObject duplicates metadata and re-references the source blocks in a
new version (no data movement — refcounts do the sharing); UploadPartCopy
splices a byte range of the source into an upload part, re-referencing
whole blocks where aligned and re-writing only the cut edges.
"""

from __future__ import annotations

import hashlib
import urllib.parse
import xml.etree.ElementTree as ET

from aiohttp import web

from ...model.s3.mpu_table import MpuPart
from ...model.s3.object_table import (
    Object,
    ObjectVersion,
    ObjectVersionData,
    ObjectVersionMeta,
)
from ...model.s3.version_table import Version
from ...utils.crdt import now_msec
from ...utils.data import Hash, Uuid, block_hash, gen_uuid
from ..common import (
    iso_timestamp as _iso,
    AccessDeniedError,
    BadRequestError,
    NoSuchKeyError,
    s3_xml_root,
    xml_to_bytes,
)
from .get import parse_range
from .multipart import decode_upload_id, get_upload


def _parse_http_date(value: str, header: str) -> float:
    """HTTP-date → epoch seconds; malformed → 400 (ref copy.rs parse).
    Timezone-less forms (asctime, -0000) are UTC per RFC 9110."""
    import datetime
    from email.utils import parsedate_to_datetime

    try:
        dt = parsedate_to_datetime(value)
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=datetime.timezone.utc)
        return dt.timestamp()
    except (TypeError, ValueError):
        raise BadRequestError(f"Invalid date in {header}")


def _etag_list(value: str):
    return [m.strip().strip('"') for m in value.split(",")]


def check_copy_preconditions(ctx, src_version) -> None:
    """x-amz-copy-source-if-{match,none-match,modified-since,
    unmodified-since} (ref copy.rs:496-585 CopyPreconditionHeaders).
    Combination rules follow the reference: if-match overrides
    if-unmodified-since; if-none-match AND if-modified-since must both
    hold; other mixes are rejected as 400."""
    h = ctx.request.headers
    im = h.get("x-amz-copy-source-if-match")
    inm = h.get("x-amz-copy-source-if-none-match")
    ims = h.get("x-amz-copy-source-if-modified-since")
    ius = h.get("x-amz-copy-source-if-unmodified-since")
    if im is None and inm is None and ims is None and ius is None:
        return
    etag = src_version.etag()
    # second granularity: clients echo Last-Modified (whole seconds) back
    # into these headers; sub-second remainder must not flip the outcome
    v_date = src_version.timestamp // 1000
    ims_t = (_parse_http_date(ims, "x-amz-copy-source-if-modified-since")
             if ims is not None else None)
    ius_t = (_parse_http_date(ius, "x-amz-copy-source-if-unmodified-since")
             if ius is not None else None)

    if im is not None and inm is None and ims is None:
        ok = any(x == etag or x == "*" for x in _etag_list(im))
    elif ius is not None and im is None and inm is None and ims is None:
        ok = v_date <= ius_t
    elif inm is not None and im is None and ius is None:
        ok = not any(x == etag or x == "*" for x in _etag_list(inm))
        if ims is not None:
            ok = ok and v_date > ims_t
    elif ims is not None and im is None and inm is None and ius is None:
        ok = v_date > ims_t
    else:
        raise BadRequestError(
            "Invalid combination of x-amz-copy-source-if-xxxxx headers"
        )
    if not ok:
        from ..common import PreconditionFailedError

        raise PreconditionFailedError("copy source precondition failed")


async def _resolve_copy_source(ctx):
    """x-amz-copy-source → (bucket_id, key, object, data version)."""
    src = ctx.request.headers.get("x-amz-copy-source", "")
    src = urllib.parse.unquote(src)
    if src.startswith("/"):
        src = src[1:]
    if "/" not in src:
        raise BadRequestError(f"bad x-amz-copy-source {src!r}")
    src_bucket_name, src_key = src.split("/", 1)
    helper = ctx.server.helper
    src_bucket_id = await helper.resolve_bucket(src_bucket_name, ctx.api_key)
    if not ctx.api_key.allow_read(src_bucket_id):
        raise AccessDeniedError("no read permission on copy source bucket")
    obj = await ctx.garage.object_table.get(src_bucket_id, src_key)
    if obj is None:
        raise NoSuchKeyError(f"no such key: {src_key}")
    version = obj.last_data_version()
    if version is None:
        raise NoSuchKeyError(f"no such key: {src_key}")
    check_copy_preconditions(ctx, version)
    return src_bucket_id, src_key, obj, version


async def handle_copy_object(ctx) -> web.Response:
    garage = ctx.garage
    _sb, _sk, _sobj, src_version = await _resolve_copy_source(ctx)
    dest_key = ctx.key_name
    meta = src_version.meta()
    data = src_version.data()
    new_uuid = gen_uuid()
    ts = now_msec()

    # x-amz-metadata-directive=REPLACE takes the new object's headers from
    # the request instead of the source (ref copy.rs:52); default is COPY
    directive = ctx.request.headers.get(
        "x-amz-metadata-directive", "COPY"
    ).upper()
    if directive == "REPLACE":
        from .put import headers_from_request

        stored_headers = headers_from_request(ctx)
    elif directive == "COPY":
        stored_headers = meta["headers"]
    else:
        raise BadRequestError(
            f"bad x-amz-metadata-directive {directive!r} (COPY or REPLACE)"
        )

    if data[0] == "inline":
        new_meta = ObjectVersionMeta.new(stored_headers, meta["size"], meta["etag"])
        ov = ObjectVersion(
            new_uuid, ts, ["complete", ObjectVersionData.inline(new_meta, bytes(data[2]))]
        )
        await garage.object_table.insert(Object(ctx.bucket_id, dest_key, [ov]))
    else:
        src_ver_row = await garage.version_table.get(src_version.uuid, "")
        if src_ver_row is None:
            raise NoSuchKeyError("source version metadata missing")
        # re-reference all source blocks under a fresh version uuid
        # (copy.rs: no payload bytes move; the version hook increfs)
        new_version = Version(new_uuid, bytes(ctx.bucket_id), dest_key)
        for (pk, (h, sz)) in src_ver_row.sorted_blocks():
            new_version.blocks[pk] = (h, sz)
        new_version.parts_etags = dict(src_ver_row.parts_etags)
        await garage.version_table.insert(new_version)
        new_meta = ObjectVersionMeta.new(stored_headers, meta["size"], meta["etag"])
        ov = ObjectVersion(
            new_uuid, ts,
            ["complete", ObjectVersionData.first_block(new_meta, bytes(data[2]))],
        )
        await garage.object_table.insert(Object(ctx.bucket_id, dest_key, [ov]))

    out = s3_xml_root("CopyObjectResult")
    ET.SubElement(out, "LastModified").text = _iso(ts)
    ET.SubElement(out, "ETag").text = f'"{meta["etag"]}"'
    return web.Response(
        status=200, body=xml_to_bytes(out), content_type="application/xml"
    )


async def handle_upload_part_copy(ctx) -> web.Response:
    garage = ctx.garage
    from ..common import int_param

    q = ctx.request.query
    part_number = int_param(q.get("partNumber"), "partNumber")
    if part_number is None or not 1 <= part_number <= 10000:
        raise BadRequestError("partNumber must be in [1, 10000]")
    upload_id = decode_upload_id(q["uploadId"])
    _ov, mpu = await get_upload(ctx, ctx.key_name, upload_id)

    _sb, _sk, _sobj, src_version = await _resolve_copy_source(ctx)
    meta = src_version.meta()
    data = src_version.data()
    size = meta["size"]

    rng_header = ctx.request.headers.get("x-amz-copy-source-range")
    if rng_header is not None:
        r = parse_range(rng_header, size, clamp=False)
        if r is None:
            raise BadRequestError(f"bad x-amz-copy-source-range {rng_header!r}")
        begin, end = r
    else:
        begin, end = 0, size

    ts = now_msec()
    part_version_uuid = gen_uuid()
    mpu.parts[(part_number, ts)] = MpuPart.new(bytes(part_version_uuid), None, None)
    await garage.mpu_table.insert(mpu)
    version = Version(
        part_version_uuid, bytes(ctx.bucket_id), ctx.key_name,
        mpu_upload_id=bytes(upload_id),
    )

    md5 = hashlib.md5()
    algo = garage.block_manager.hash_algo

    if data[0] == "inline":
        piece = bytes(data[2])[begin:end]
        md5.update(piece)
        if piece:
            h = block_hash(piece, algo)
            await garage.block_manager.rpc_put_block(h, piece)
            version.add_block(part_number, 0, bytes(h), len(piece))
        await garage.version_table.insert(version)
    else:
        src_ver_row = await garage.version_table.get(src_version.uuid, "")
        if src_ver_row is None:
            raise NoSuchKeyError("source version metadata missing")
        # whole blocks inside [begin,end) are re-referenced; cut edges are
        # re-read, sliced, re-hashed and re-written (copy.rs block splice)
        abs_off = 0
        out_off = 0
        for (_pk, (h, sz)) in src_ver_row.sorted_blocks():
            b0, b1 = abs_off, abs_off + sz
            abs_off = b1
            if b1 <= begin or b0 >= end:
                continue
            if b0 >= begin and b1 <= end:
                version.add_block(part_number, out_off, h, sz)
                chunk = await garage.block_manager.rpc_get_block(Hash(h))
                md5.update(chunk)
                out_off += sz
            else:
                chunk = await garage.block_manager.rpc_get_block(Hash(h))
                piece = chunk[max(0, begin - b0): min(sz, end - b0)]
                md5.update(piece)
                nh = block_hash(piece, algo)
                await garage.block_manager.rpc_put_block(nh, piece)
                version.add_block(part_number, out_off, bytes(nh), len(piece))
                out_off += len(piece)
        # single metadata write with the complete block map (a per-block
        # insert would quorum-write the whole growing map O(n²) times)
        await garage.version_table.insert(version)

    etag = md5.hexdigest()
    mpu.parts[(part_number, ts)] = MpuPart.new(
        bytes(part_version_uuid), etag, end - begin
    )
    await garage.mpu_table.insert(mpu)

    out = s3_xml_root("CopyPartResult")
    ET.SubElement(out, "LastModified").text = _iso(ts)
    ET.SubElement(out, "ETag").text = f'"{etag}"'
    return web.Response(
        status=200, body=xml_to_bytes(out), content_type="application/xml"
    )
