"""List endpoints: ListObjects v1/v2, ListMultipartUploads, ListParts.

Equivalent of reference src/api/s3/list.rs (1286 LoC, SURVEY.md §2.7):
iterative quorum range-reads over the object table with prefix/delimiter
aggregation into common prefixes (jumping past a completed common prefix
instead of scanning its contents), marker/continuation-token pagination.
Multipart uploads are listed from uploading object versions; parts come
from the MPU row.
"""

from __future__ import annotations

import asyncio
import base64
import xml.etree.ElementTree as ET
from typing import List, Optional, Tuple

from aiohttp import web

from ..common import (
    BadRequestError,
    int_param,
    iso_timestamp as _iso,
    s3_xml_root,
    xml_to_bytes,
)
from ..signature import uri_encode

PAGE = 1000


def _encoder(q) -> "tuple":
    """encoding-type=url support (ref list.rs:881-887 uriencode_maybe +
    router.rs encoding_type): returns (enc_fn, encoding_type|None).  Keys,
    prefixes, delimiters and markers in the RESPONSE are uri-encoded
    (slash included, uri_encode(s, true)) when the client asked for it —
    how AWS SDKs transport keys with control characters safely."""
    et = q.get("encoding-type")
    if et is None:
        return (lambda v: v), None
    if et != "url":
        raise BadRequestError(f"invalid encoding-type: {et!r}")
    return (lambda v: uri_encode(v, encode_slash=True)), "url"


def _after_prefix(p: str) -> str:
    """Smallest string greater than every string with prefix p (valid in
    both str and utf-8 byte order: increment the last code point)."""
    for i in range(len(p) - 1, -1, -1):
        c = ord(p[i])
        if c < 0x10FFFF:
            return p[:i] + chr(c + 1)
    return p + "\x00"


class _ShardScanner:
    """Bucket-sharded listing driver ([table] list_shards).

    Serves ordered pages of a bucket enumeration.  The first page is the
    serial walk (a listing that fits one page pays zero extra RPCs); once
    it comes back full, the remaining keyspace fans out across disjoint
    sub-ranges whose first pages fetch CONCURRENTLY — each sub-range is
    its own quorum read with its own continuation cursor, so a deep
    enumeration pipelines its round-trips instead of paying one at a
    time.  Pages are consumed strictly in boundary order (shard i only
    serves after shards < i exhausted), so emission order and
    continuation semantics are identical to the serial walk; skewed key
    distributions only lose the prefetch win, never correctness."""

    def __init__(self, ctx, prefix: str):
        g = ctx.garage
        self.table = g.object_table
        self.bucket_id = ctx.bucket_id
        self.prefix = prefix
        tcfg = getattr(getattr(g, "config", None), "table", None)
        self.n = max(1, int(getattr(tcfg, "list_shards", 1) or 1))
        self.shards = None  # lazy fan-out after the first full page
        self.pages = 0
        self.fanned_out = False
        # adaptive speculation: sequential consumers keep the next page
        # in flight; a walk whose jumps outrun whole pages (delimiter
        # strides wider than PAGE keys) turns it off and seeks straight
        # to each requested position instead of paying a mostly-missed
        # page per jump
        self._prefetch_on = True
        m = getattr(g.system, "metrics", None)
        if m is not None:
            self._m_pages = m.histogram(
                "api_list_pages",
                "Table range pages fetched per ListObjects-family "
                "enumeration",
                buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0))
            self._m_fanout = m.counter(
                "api_list_fanout_total",
                "Listings that fanned out across sharded sub-range "
                "scans (vs served by the serial first page)")
        else:
            self._m_pages = self._m_fanout = None

    async def _fetch(self, pos: str, end=None):
        self.pages += 1
        return await self.table.get_range(
            self.bucket_id, pos, filter="any", limit=PAGE,
            end_sort_key=end)

    def _fan_out(self, batch, fetch_pos: str) -> None:
        # split points on the first code point after the user prefix,
        # evenly spaced over printable ASCII — correctness never depends
        # on balance (the last shard is unbounded above, the first
        # starts at the serial cursor), only the prefetch win does
        start_pos = batch[-1].key + "\x00"
        lo, hi = 0x21, 0x7F
        bounds = sorted({
            self.prefix + chr(lo + (hi - lo) * i // self.n)
            for i in range(1, self.n)
        })
        bounds = [b for b in bounds if b > start_pos]
        ends = bounds + [None]
        # the serial first page becomes the first shard's buffer: a
        # delimiter jump back into its discarded tail is served from it,
        # never skipped past
        self.shards = [
            {
                "start": fetch_pos,
                "end": ends[0],
                "buf": batch,            # last completed page, servable
                "buf_start": fetch_pos,  # position it was fetched from
                "task_start": start_pos,
                "task": asyncio.ensure_future(
                    self._fetch(start_pos, ends[0])),
            }
        ] + [
            {
                "start": s,
                "end": e,
                "buf": None,
                "buf_start": None,
                "task_start": s,
                "task": asyncio.ensure_future(self._fetch(s, e)),
            }
            for s, e in zip(bounds, ends[1:])
        ]
        # everything below this key is proven fully enumerated (chained
        # through exhausted shards) — what makes a boundary-anchored
        # speculative page safe to serve at a shard handoff
        self._covered_to = fetch_pos
        self.fanned_out = True
        if self._m_fanout is not None:
            self._m_fanout.inc()

    def _usable_from(self, sh, pos: str, at) -> bool:
        # a page fetched from `at` serves `pos` when it starts at or
        # before it (anything it skipped is < pos, which the caller
        # already consumed), or at this shard's boundary with everything
        # below the boundary proven enumerated — anything else would
        # silently skip every key in [pos, at)
        return at is not None and (
            at <= pos
            or (at == sh["start"] and self._covered_to == sh["start"]))

    async def page(self, pos: str):
        """(objects with key >= pos in key order, done) — `done` means
        the enumeration is complete after this (possibly empty) page."""
        if self.shards is None:
            batch = await self._fetch(pos)
            if len(batch) < PAGE or self.n <= 1:
                return batch, len(batch) < PAGE
            self._fan_out(batch, pos)
            return batch, False
        # The caller may re-request from ANY pos after the one it last
        # asked for (a delimiter jump discards the tail of the returned
        # batch and resumes after the common prefix — possibly BEHIND
        # keys it was already handed).  So each shard KEEPS its last
        # fetched page: re-requests into the tail are served from the
        # buffer instead of paying a fresh quorum fetch per jump, and a
        # shard only retires once its buffered tail proves there is no
        # key at or after pos — never while a jump could still land in
        # it.
        while self.shards:
            sh = self.shards[0]
            if sh["end"] is not None and pos >= sh["end"]:
                # the jump moved past this whole shard
                self._cancel(sh)
                self.shards.pop(0)
                continue
            buf = sh["buf"]
            if buf is not None:
                if not self._usable_from(sh, pos, sh["buf_start"]):
                    # pos regressed behind the buffer — start over at pos
                    sh["buf"] = sh["buf_start"] = None
                    self._cancel(sh)
                    continue
                out = [o for o in buf if o.key >= pos]
                if out:
                    return out, False
                if len(buf) < PAGE:
                    # bounded partial page: no key in [pos, end) at all
                    self._cancel(sh)
                    if sh["end"] is None:
                        return [], True
                    self._covered_to = sh["end"]
                    self.shards.pop(0)
                    continue
                # pos is past the full buffered page
                if pos == buf[-1].key + "\x00":
                    # pure sequential continuation: speculation pays
                    self._prefetch_on = True
                else:
                    # long jump: the next sequential page mostly misses
                    # — stop speculating and seek straight to pos,
                    # unless a speculative page already finished (then
                    # trying it is free)
                    self._prefetch_on = False
                    t0 = sh["task"]
                    if t0 is not None and not t0.done():
                        self._cancel(sh)
            t = sh["task"]
            if t is not None and not self._usable_from(
                    sh, pos, sh["task_start"]):
                self._cancel(sh)
                t = None
            if t is None:
                sh["task_start"] = pos
                sh["task"] = asyncio.ensure_future(
                    self._fetch(pos, sh["end"]))
            fetched_from = sh["task_start"]
            page = await sh["task"]
            sh["task"] = None
            sh["buf"], sh["buf_start"] = page, fetched_from
            if len(page) == PAGE and self._prefetch_on:
                # prefetch the next page while the caller consumes this
                # one — jumps within the buffer don't invalidate it, and
                # a short jump past it lands inside the prefetched
                # page's range, so speculation is almost always consumed
                nxt = page[-1].key + "\x00"
                sh["task_start"] = nxt
                sh["task"] = asyncio.ensure_future(
                    self._fetch(nxt, sh["end"]))
            # loop: the buffer branch serves (or retires) from the new
            # page
        return [], True

    @staticmethod
    def _cancel(sh) -> None:
        t = sh.get("task")
        if t is not None and not t.done():
            t.cancel()
        sh["task"] = None

    def close(self) -> None:
        if self._m_pages is not None and self.pages:
            self._m_pages.observe(float(self.pages))
        for sh in self.shards or ():
            self._cancel(sh)


async def _collect(
    ctx,
    prefix: str,
    delimiter: Optional[str],
    pos: Optional[str],
    max_keys: int,
    marker: Optional[str] = None,
    uploads: bool = False,
    upload_id_marker: Optional[str] = None,
):
    """Enumeration core (ref list.rs).  `pos` = inclusive resume position
    (None → start of prefix); `marker` = last key/prefix already returned
    to the client (v1 semantics — suppresses a re-emitted common prefix).
    Returns (entries, prefixes, truncated, last_returned) where entries =
    [(key, version…)] in key order."""
    entries: List[Tuple[str, object]] = []
    prefixes: List[str] = []
    last_returned: Optional[str] = None
    if pos is None:
        pos = prefix

    scanner = _ShardScanner(ctx, prefix)
    try:
        return await _collect_inner(
            scanner, prefix, delimiter, pos, max_keys, marker,
            uploads, upload_id_marker, entries, prefixes, last_returned,
        )
    finally:
        scanner.close()


async def _collect_inner(
    scanner, prefix, delimiter, pos, max_keys, marker, uploads,
    upload_id_marker, entries, prefixes, last_returned,
):
    while True:
        batch, done = await scanner.page(pos)
        jumped = False
        for obj in batch:
            k = obj.key
            if k < pos:
                continue
            if not k.startswith(prefix):
                if k > prefix:
                    return entries, prefixes, False, last_returned
                continue
            if uploads:
                # uuid order, NOT timestamp order: upload-id-marker
                # pagination resumes by uuid, so emission order must match
                relevant = sorted(
                    (v for v in obj.versions() if v.is_uploading(True)),
                    key=lambda v: bytes(v.uuid),
                )
                if upload_id_marker is not None and k == marker:
                    # resume INSIDE the marker key: only uploads after the
                    # one last returned (filtered BEFORE capacity counting,
                    # or a page could come back empty yet truncated)
                    relevant = [
                        v for v in relevant
                        if bytes(v.uuid).hex() > upload_id_marker
                    ]
            else:
                lv = obj.last_data_version()
                relevant = [lv] if lv is not None else []
            if not relevant:
                continue
            if delimiter:
                rest = k[len(prefix):]
                di = rest.find(delimiter)
                if di >= 0:
                    cp = prefix + rest[: di + len(delimiter)]
                    if marker is not None and cp <= marker:
                        # already returned on a previous page — skip it
                        pos, jumped = _after_prefix(cp), True
                        break
                    if len(entries) + len(prefixes) >= max_keys:
                        return entries, prefixes, True, last_returned
                    prefixes.append(cp)
                    last_returned = ("cp", cp)
                    pos, jumped = _after_prefix(cp), True
                    break
            for v in relevant:
                # capacity check PER VERSION: a key with many concurrent
                # uploads must truncate mid-key (resumed via
                # upload-id-marker), not blow past max_keys
                if len(entries) + len(prefixes) >= max_keys:
                    return entries, prefixes, True, last_returned
                entries.append((k, v))
                last_returned = ("key", k)
        if jumped:
            continue
        if done:
            return entries, prefixes, False, last_returned
        pos = batch[-1].key + "\x00"


async def handle_list_objects(ctx) -> web.Response:
    q = ctx.request.query
    enc, enc_type = _encoder(q)
    prefix = q.get("prefix", "")
    delimiter = q.get("delimiter") or None
    marker = q.get("marker") or None
    max_keys = max(0, min(int_param(q.get("max-keys"), "max-keys", 1000), 1000))
    pos = (marker + "\x00") if marker is not None else None

    entries, prefixes, truncated, last = await _collect(
        ctx, prefix, delimiter, pos, max_keys, marker=marker
    )
    out = s3_xml_root("ListBucketResult")
    ET.SubElement(out, "Name").text = ctx.bucket_name
    ET.SubElement(out, "Prefix").text = enc(prefix)
    if marker is not None:
        ET.SubElement(out, "Marker").text = enc(marker)
    if delimiter:
        ET.SubElement(out, "Delimiter").text = enc(delimiter)
    if enc_type:
        ET.SubElement(out, "EncodingType").text = enc_type
    ET.SubElement(out, "MaxKeys").text = str(max_keys)
    ET.SubElement(out, "IsTruncated").text = "true" if truncated else "false"
    if truncated and last is not None:
        ET.SubElement(out, "NextMarker").text = enc(last[1])
    _append_contents(out, entries, prefixes, enc)
    return web.Response(
        status=200, body=xml_to_bytes(out), content_type="application/xml"
    )


async def handle_list_objects_v2(ctx) -> web.Response:
    q = ctx.request.query
    enc, enc_type = _encoder(q)
    prefix = q.get("prefix", "")
    delimiter = q.get("delimiter") or None
    max_keys = max(0, min(int_param(q.get("max-keys"), "max-keys", 1000), 1000))
    token = q.get("continuation-token")
    start_after = q.get("start-after")
    marker = None
    if token is not None:
        try:
            decoded = base64.urlsafe_b64decode(token.encode()).decode()
            kind, sep, marker = decoded.partition(":")
            if kind not in ("key", "cp") or not sep:
                raise ValueError(decoded)
        except Exception:
            raise BadRequestError("bad continuation-token")
        # resume exclusively after the last returned item: past the whole
        # prefix if it was a common prefix, just after the key otherwise
        pos = _after_prefix(marker) if kind == "cp" else marker + "\x00"
    elif start_after is not None:
        marker = start_after
        pos = start_after + "\x00"
    else:
        pos = None

    entries, prefixes, truncated, last = await _collect(
        ctx, prefix, delimiter, pos, max_keys, marker=marker
    )
    out = s3_xml_root("ListBucketResult")
    ET.SubElement(out, "Name").text = ctx.bucket_name
    ET.SubElement(out, "Prefix").text = enc(prefix)
    if delimiter:
        ET.SubElement(out, "Delimiter").text = enc(delimiter)
    if enc_type:
        ET.SubElement(out, "EncodingType").text = enc_type
    ET.SubElement(out, "MaxKeys").text = str(max_keys)
    ET.SubElement(out, "KeyCount").text = str(len(entries) + len(prefixes))
    ET.SubElement(out, "IsTruncated").text = "true" if truncated else "false"
    if token is not None:
        ET.SubElement(out, "ContinuationToken").text = token
    if start_after is not None:
        ET.SubElement(out, "StartAfter").text = enc(start_after)
    if truncated and last is not None:
        # the token records WHAT the last item was (key vs common prefix)
        # so resumption can't conflate a key that merely ends with the
        # delimiter with a completed prefix
        kind, value = last
        ET.SubElement(out, "NextContinuationToken").text = (
            base64.urlsafe_b64encode(f"{kind}:{value}".encode()).decode()
        )
    _append_contents(out, entries, prefixes, enc)
    return web.Response(
        status=200, body=xml_to_bytes(out), content_type="application/xml"
    )


def _append_contents(out, entries, prefixes, enc=lambda v: v):
    for key, v in entries:
        c = ET.SubElement(out, "Contents")
        ET.SubElement(c, "Key").text = enc(key)
        ET.SubElement(c, "LastModified").text = _iso(v.timestamp)
        ET.SubElement(c, "ETag").text = f'"{v.etag()}"'
        ET.SubElement(c, "Size").text = str(v.size())
        ET.SubElement(c, "StorageClass").text = "STANDARD"
    for cp in prefixes:
        p = ET.SubElement(out, "CommonPrefixes")
        ET.SubElement(p, "Prefix").text = enc(cp)


async def handle_list_multipart_uploads(ctx) -> web.Response:
    q = ctx.request.query
    enc, enc_type = _encoder(q)
    prefix = q.get("prefix", "")
    delimiter = q.get("delimiter") or None
    max_uploads = max(0, min(int_param(q.get("max-uploads"), "max-uploads", 1000), 1000))
    key_marker = q.get("key-marker") or None
    upload_id_marker = q.get("upload-id-marker") or None

    # upload-id-marker refines key-marker (ref list.rs:49,208-236): resume
    # INSIDE the marker key, after the given upload id — without it, two
    # pages could never split a key with many concurrent uploads
    if key_marker is not None and upload_id_marker is not None:
        pos = key_marker  # re-scan the marker key, filter below
    elif key_marker is not None:
        pos = key_marker + "\x00"
    else:
        pos = None

    entries, prefixes, truncated, last = await _collect(
        ctx, prefix, delimiter, pos, max_uploads, marker=key_marker,
        uploads=True,
        upload_id_marker=(upload_id_marker if key_marker is not None
                          else None),
    )
    out = s3_xml_root("ListMultipartUploadsResult")
    ET.SubElement(out, "Bucket").text = ctx.bucket_name
    ET.SubElement(out, "Prefix").text = enc(prefix)
    if key_marker is not None:
        ET.SubElement(out, "KeyMarker").text = enc(key_marker)
    if upload_id_marker is not None:
        ET.SubElement(out, "UploadIdMarker").text = upload_id_marker
    if delimiter:
        ET.SubElement(out, "Delimiter").text = enc(delimiter)
    if enc_type:
        ET.SubElement(out, "EncodingType").text = enc_type
    ET.SubElement(out, "MaxUploads").text = str(max_uploads)
    ET.SubElement(out, "IsTruncated").text = "true" if truncated else "false"
    if truncated and last is not None:
        ET.SubElement(out, "NextKeyMarker").text = enc(last[1])
        if entries and last[0] == "key" and entries[-1][0] == last[1]:
            ET.SubElement(out, "NextUploadIdMarker").text = (
                bytes(entries[-1][1].uuid).hex()
            )
    for key, v in entries:
        u = ET.SubElement(out, "Upload")
        ET.SubElement(u, "Key").text = enc(key)
        ET.SubElement(u, "UploadId").text = bytes(v.uuid).hex()
        ET.SubElement(u, "Initiated").text = _iso(v.timestamp)
        ET.SubElement(u, "StorageClass").text = "STANDARD"
    for cp in prefixes:
        p = ET.SubElement(out, "CommonPrefixes")
        ET.SubElement(p, "Prefix").text = enc(cp)
    return web.Response(
        status=200, body=xml_to_bytes(out), content_type="application/xml"
    )


async def handle_list_parts(ctx) -> web.Response:
    from .multipart import get_existing_mpu

    q = ctx.request.query
    upload_id = q.get("uploadId", "")
    max_parts = max(0, min(int_param(q.get("max-parts"), "max-parts", 1000), 1000))
    pmarker = int_param(q.get("part-number-marker"), "part-number-marker", 0)

    mpu = await get_existing_mpu(ctx, upload_id)
    out = s3_xml_root("ListPartsResult")
    ET.SubElement(out, "Bucket").text = ctx.bucket_name
    ET.SubElement(out, "Key").text = ctx.key_name
    ET.SubElement(out, "UploadId").text = upload_id
    ET.SubElement(out, "MaxParts").text = str(max_parts)
    if pmarker:
        ET.SubElement(out, "PartNumberMarker").text = str(pmarker)

    # newest registration per part number, completed parts only
    per_part = {}
    for (pn, ts), p in mpu.sorted_parts():
        if p.get("etag") is not None:
            per_part[pn] = (ts, p)
    items = sorted((pn, tp) for pn, tp in per_part.items() if pn > pmarker)
    truncated = len(items) > max_parts
    items = items[:max_parts]
    ET.SubElement(out, "IsTruncated").text = "true" if truncated else "false"
    if truncated:
        ET.SubElement(out, "NextPartNumberMarker").text = str(items[-1][0])
    for pn, (ts, p) in items:
        el = ET.SubElement(out, "Part")
        ET.SubElement(el, "PartNumber").text = str(pn)
        ET.SubElement(el, "ETag").text = f'"{p["etag"]}"'
        ET.SubElement(el, "Size").text = str(p["size"] or 0)
        ET.SubElement(el, "LastModified").text = _iso(ts)
    return web.Response(
        status=200, body=xml_to_bytes(out), content_type="application/xml"
    )
