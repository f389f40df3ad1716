"""Multipart upload endpoints.

Equivalent of reference src/api/s3/multipart.rs (SURVEY.md §2.7):
create (object Uploading version + MPU row), upload-part (own Version row
per part, streamed through the same block pipeline as PutObject),
complete (renumber listed parts 1..N, splice their blocks into the final
Version keyed by the upload id, etag = md5-of-part-md5s "-N"), abort
(aborted object version → MPU tombstone cascade via hooks).
"""

from __future__ import annotations

import hashlib
import xml.etree.ElementTree as ET

from aiohttp import web

from ...model.s3.mpu_table import MpuPart, MultipartUpload
from ...model.s3.object_table import (
    Object,
    ObjectVersion,
    ObjectVersionData,
    ObjectVersionMeta,
)
from ...model.s3.version_table import Version
from ...ops.codec import mhash_stream
from ...utils.crdt import now_msec
from ...utils.data import Uuid, gen_uuid
from ..common import (
    ApiError,
    BadRequestError,
    EntityTooSmallError,
    InvalidPartError,
    NoSuchUploadError,
    s3_xml_root,
    xml_to_bytes,
)
from .put import (
    Chunker,
    check_quotas,
    headers_from_request,
    read_and_put_blocks,
    request_scope,
)


def decode_upload_id(s: str) -> Uuid:
    try:
        b = bytes.fromhex(s)
        if len(b) != 32:
            raise ValueError
        return Uuid(b)
    except ValueError:
        raise NoSuchUploadError(f"invalid upload id {s!r}")


async def get_upload(ctx, key: str, upload_id: Uuid):
    """(object_version, mpu) for an ongoing upload (ref multipart.rs
    get_upload)."""
    garage = ctx.garage
    obj = await garage.object_table.get(ctx.bucket_id, key)
    ov = None
    if obj is not None:
        for v in obj.versions():
            if bytes(v.uuid) == bytes(upload_id) and v.is_uploading(True):
                ov = v
                break
    mpu = await garage.mpu_table.get(upload_id, "")
    if ov is None or mpu is None or mpu.deleted.value:
        raise NoSuchUploadError("no such ongoing multipart upload")
    return ov, mpu


async def get_existing_mpu(ctx, upload_id_str: str) -> MultipartUpload:
    upload_id = decode_upload_id(upload_id_str)
    mpu = await ctx.garage.mpu_table.get(upload_id, "")
    if mpu is None or mpu.deleted.value:
        raise NoSuchUploadError("no such multipart upload")
    return mpu


async def handle_create_mpu(ctx) -> web.Response:
    garage = ctx.garage
    key = ctx.key_name
    upload_id = gen_uuid()
    ts = now_msec()
    headers = headers_from_request(ctx)

    ov = ObjectVersion.uploading(upload_id, ts, True, headers)
    await garage.object_table.insert(Object(ctx.bucket_id, key, [ov]))
    mpu = MultipartUpload(upload_id, ts, bytes(ctx.bucket_id), key)
    await garage.mpu_table.insert(mpu)

    out = s3_xml_root("InitiateMultipartUploadResult")
    ET.SubElement(out, "Bucket").text = ctx.bucket_name
    ET.SubElement(out, "Key").text = key
    ET.SubElement(out, "UploadId").text = bytes(upload_id).hex()
    return web.Response(
        status=200, body=xml_to_bytes(out), content_type="application/xml"
    )


async def handle_upload_part(ctx) -> web.Response:
    garage = ctx.garage
    key = ctx.key_name
    from ..common import int_param

    q = ctx.request.query
    part_number = int_param(q.get("partNumber"), "partNumber")
    if part_number is None or not 1 <= part_number <= 10000:
        raise BadRequestError("partNumber must be in [1, 10000]")
    upload_id = decode_upload_id(q["uploadId"])
    _ov, mpu = await get_upload(ctx, key, upload_id)

    # register the part (ref multipart.rs:69-120)
    ts = now_msec()
    part_version_uuid = gen_uuid()
    mpu.parts[(part_number, ts)] = MpuPart.new(bytes(part_version_uuid), None, None)
    await garage.mpu_table.insert(mpu)

    version = Version(
        part_version_uuid, bytes(ctx.bucket_id), key,
        mpu_upload_id=bytes(upload_id),
    )
    await garage.version_table.insert(version)

    md5 = hashlib.md5()
    sha256 = hashlib.sha256()
    # incremental BLAKE2b-256 over THIS part's bytes, advanced in the
    # same off-loop digest hop as md5/sha256 (put.py
    # update_stream_digests): a 1 GiB part is hashed exactly once, while
    # it streams — completing the upload never rereads or rehashes the
    # assembled object
    mhash = mhash_stream()
    # on error the part is left unfinished; abort/lifecycle reaps it
    with request_scope(garage):
        chunker = Chunker(ctx.body_stream(), garage.config.block_size)
        first = await chunker.next() or b""
        total_size, _fh = await read_and_put_blocks(
            ctx, version, part_number, first, chunker, md5, sha256,
            mhash=mhash,
        )
    etag = md5.hexdigest()
    content_sha256 = ctx.verified.content_sha256
    if content_sha256 not in (None, "STREAMING") and \
            content_sha256 != sha256.hexdigest():
        raise ApiError("x-amz-content-sha256 mismatch", status=400, code="BadDigest")

    mpu.parts[(part_number, ts)] = MpuPart.new(bytes(part_version_uuid), etag, total_size)
    await garage.mpu_table.insert(mpu)
    return web.Response(status=200, headers={
        "ETag": f'"{etag}"',
        "x-garage-part-blake2b": mhash.hexdigest(),
    })


def _parse_complete_body(body: bytes):
    try:
        root = ET.fromstring(body.decode())
    except ET.ParseError as e:
        raise BadRequestError(f"malformed CompleteMultipartUpload XML: {e}")
    ns = root.tag[: root.tag.index("}") + 1] if root.tag.startswith("{") else ""
    parts = []
    for p in root.findall(f"{ns}Part"):
        pn = p.findtext(f"{ns}PartNumber")
        etag = (p.findtext(f"{ns}ETag") or "").strip().strip('"')
        if pn is None:
            raise BadRequestError("Part missing PartNumber")
        parts.append((int(pn), etag))
    return parts


async def handle_complete_mpu(ctx) -> web.Response:
    garage = ctx.garage
    key = ctx.key_name
    upload_id = decode_upload_id(ctx.request.query["uploadId"])
    body = await ctx.read_body_verified()
    listed = _parse_complete_body(body)
    if not listed:
        raise EntityTooSmallError("no parts listed")
    if any(a >= b for (a, _), (b, _) in zip(listed, listed[1:])):
        raise ApiError("part order invalid", status=400, code="InvalidPartOrder")

    ov, mpu = await get_upload(ctx, key, upload_id)
    if not mpu.parts:
        raise BadRequestError("no data was uploaded")

    # match listed parts against stored ones (multipart.rs:261-275)
    have = {}
    for (pn, ts), p in mpu.sorted_parts():
        if p.get("etag") is not None:
            have[pn] = p
    chosen = []
    for pn, etag in listed:
        p = have.get(pn)
        if p is None or p["etag"] != etag or p["size"] is None:
            raise InvalidPartError(f"part {pn} not found or etag mismatch")
        chosen.append((pn, p))

    total_size = sum(p["size"] for _pn, p in chosen)
    # quota check FIRST, before any final-version metadata exists: on
    # failure the upload stays intact and retryable (the reference aborts
    # the whole upload here, destroying all parts — deliberately kinder)
    await check_quotas(ctx, total_size, key)

    # splice part blocks into the final version, renumbered 1..N
    # (multipart.rs:286-309)
    final_version = Version(upload_id, bytes(ctx.bucket_id), key)
    for i, (_pn, p) in enumerate(chosen):
        pv = await garage.version_table.get(Uuid(p["version"]), "")
        if pv is None or pv.deleted.value:
            raise InvalidPartError("part version missing")
        for (pk, (h, sz)) in pv.sorted_blocks():
            final_version.blocks[(i + 1, pk[1])] = (h, sz)
        final_version.parts_etags[i + 1] = p["etag"]
    await garage.version_table.insert(final_version)

    # aws multipart etag = md5 of the concatenated BINARY part digests
    # (multipart.rs:319-329 hex-decodes each part etag first)
    md5 = hashlib.md5()
    for _pn, p in chosen:
        try:
            md5.update(bytes.fromhex(p["etag"]))
        except ValueError:
            md5.update(p["etag"].encode())
    etag = f"{md5.hexdigest()}-{len(chosen)}"

    blocks = final_version.sorted_blocks()
    meta = ObjectVersionMeta.new(ov.state[2], total_size, etag)
    first_hash = blocks[0][1][0] if blocks else b"\x00" * 32
    ov_done = ObjectVersion(
        upload_id, ov.timestamp,
        ["complete", ObjectVersionData.first_block(meta, first_hash)],
    )
    await garage.object_table.insert(Object(ctx.bucket_id, key, [ov_done]))

    out = s3_xml_root("CompleteMultipartUploadResult")
    ET.SubElement(out, "Bucket").text = ctx.bucket_name
    ET.SubElement(out, "Key").text = key
    ET.SubElement(out, "ETag").text = f'"{etag}"'
    return web.Response(
        status=200, body=xml_to_bytes(out), content_type="application/xml"
    )


async def handle_abort_mpu(ctx) -> web.Response:
    garage = ctx.garage
    key = ctx.key_name
    upload_id = decode_upload_id(ctx.request.query["uploadId"])
    ov, _mpu = await get_upload(ctx, key, upload_id)
    ov_abort = ObjectVersion(upload_id, ov.timestamp, ["aborted"])
    await garage.object_table.insert(Object(ctx.bucket_id, key, [ov_abort]))
    return web.Response(status=204)
