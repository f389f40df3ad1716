"""DeleteObject(s).

Equivalent of reference src/api/s3/delete.rs: deletion inserts a new
complete version holding a DeleteMarker; the object merge prunes all
older versions, cascading through the version table hook to block-ref
deletion (delete.rs:20-80).  DeleteObjects handles the XML batch form
(delete.rs:82-169).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

from aiohttp import web

from ...model.s3.object_table import Object, ObjectVersion, ObjectVersionData
from ...utils.crdt import now_msec
from ...utils.data import gen_uuid
from ..common import BadRequestError, s3_xml_root, xml_to_bytes


async def delete_object_inner(ctx, key: str):
    """Returns (deleted_something, delete_marker_uuid) (ref delete.rs:20-60)."""
    garage = ctx.garage
    obj = await garage.object_table.get(ctx.bucket_id, key)
    if obj is None or obj.last_data_version() is None:
        return False, None
    del_uuid = gen_uuid()
    ov = ObjectVersion(
        del_uuid, now_msec(), ["complete", ObjectVersionData.delete_marker()]
    )
    await garage.object_table.insert(Object(ctx.bucket_id, key, [ov]))
    return True, del_uuid


async def handle_delete_object(ctx) -> web.Response:
    await delete_object_inner(ctx, ctx.key_name)
    # S3 returns 204 regardless of prior existence
    return web.Response(status=204)


async def handle_delete_objects(ctx) -> web.Response:
    """POST /?delete with <Delete><Object><Key>…</Key></Object>…</Delete>."""
    body = await ctx.read_body_verified()
    try:
        root = ET.fromstring(body.decode())
    except ET.ParseError as e:
        raise BadRequestError(f"malformed Delete XML: {e}")
    ns = ""
    if root.tag.startswith("{"):
        ns = root.tag[: root.tag.index("}") + 1]
    quiet = (root.findtext(f"{ns}Quiet") or "").lower() == "true"

    out = s3_xml_root("DeleteResult")
    for obj_el in root.findall(f"{ns}Object"):
        key = obj_el.findtext(f"{ns}Key")
        if key is None:
            continue
        try:
            deleted, _uuid = await delete_object_inner(ctx, key)
            if not quiet:
                d = ET.SubElement(out, "Deleted")
                ET.SubElement(d, "Key").text = key
        except Exception as e:  # noqa: BLE001 — per-key error entries
            err = ET.SubElement(out, "Error")
            ET.SubElement(err, "Key").text = key
            ET.SubElement(err, "Code").text = getattr(e, "code", "InternalError")
            ET.SubElement(err, "Message").text = str(e)
    return web.Response(
        status=200, body=xml_to_bytes(out), content_type="application/xml"
    )
