"""GetObject / HeadObject — the S3 read path.

Equivalent of reference src/api/s3/get.rs (SURVEY.md §3.3): quorum read
of the object row, conditional headers (If-None-Match / If-Modified-Since
→ 304, get.rs:27-89), range and partNumber reads touching only the
intersecting blocks (get.rs:432-512), and a streaming body assembled from
per-block RPC streams with order tags and prefetch of the next block.
"""

from __future__ import annotations

import asyncio
import email.utils
import logging
from typing import Dict, List, Optional, Tuple

from aiohttp import web

from ...utils.data import Hash, Uuid
from ...utils.tracing import refresh_deadline
from ..common import (
    ApiError,
    BadRequestError,
    InvalidRangeError,
    NoSuchKeyError,
    PreconditionFailedError,
)

PREFETCH = 2  # buffered(2) block prefetch (ref get.rs:458-466)

logger = logging.getLogger("garage_tpu_torch.api.s3")


async def get_object_version(ctx, key: str):
    """Object row → newest complete data version, else NoSuchKey."""
    obj = await ctx.garage.object_table.get(ctx.bucket_id, key)
    last = obj.last_data_version() if obj is not None else None
    if last is None:
        raise NoSuchKeyError(f"no such key: {key}")
    return obj, last


def object_headers(version, meta: Dict) -> Dict[str, str]:
    """Response headers from stored meta (ref get.rs:60-90)."""
    hdrs = {
        "Content-Type": meta["headers"].get("content_type", "application/octet-stream"),
        "ETag": f'"{meta["etag"]}"',
        "Last-Modified": email.utils.formatdate(version.timestamp / 1000, usegmt=True),
        "Accept-Ranges": "bytes",
        "x-amz-version-id": bytes(version.uuid).hex(),
    }
    for k, v in meta["headers"].get("other", {}).items():
        hdrs[k] = v
    return hdrs


def check_conditions(ctx, version, meta) -> Optional[int]:
    """Conditional request handling; returns an HTTP status to short-
    circuit with, or None (ref get.rs:27-58 try_answer_cached)."""
    req = ctx.request
    etag = f'"{meta["etag"]}"'
    inm = req.headers.get("If-None-Match")
    if inm is not None:
        tags = [t.strip() for t in inm.split(",")]
        if etag in tags or "*" in tags:
            return 304
    ims = req.headers.get("If-Modified-Since")
    if ims is not None and inm is None:
        t = email.utils.parsedate_to_datetime(ims)
        if t is not None and version.timestamp / 1000 <= t.timestamp():
            return 304
    im = req.headers.get("If-Match")
    if im is not None:
        tags = [t.strip() for t in im.split(",")]
        if etag not in tags and "*" not in tags:
            raise PreconditionFailedError("If-Match failed")
    ius = req.headers.get("If-Unmodified-Since")
    if ius is not None:
        t = email.utils.parsedate_to_datetime(ius)
        if t is not None and version.timestamp / 1000 > t.timestamp():
            raise PreconditionFailedError("If-Unmodified-Since failed")
    return None


def parse_range(header: str, size: int,
                clamp: bool = True) -> Optional[Tuple[int, int]]:
    """'bytes=a-b' → (begin, end_exclusive).  Returns None for a
    syntactically malformed header (S3 ignores those and serves the full
    object); raises InvalidRangeError (416) for unsatisfiable ranges.

    clamp=True (the GET path): RFC 7233 §2.1 — an end past the object
    clamps to the last byte, and only a start beyond the object (or an
    inverted range) is unsatisfiable; "bytes=50-200" on a 62-byte object
    serves bytes 50-61, not 416 (caught porting ref objects.rs's range
    matrix).  clamp=False (UploadPartCopy's x-amz-copy-source-range):
    AWS REJECTS out-of-bounds copy ranges — silently truncating would
    hand the client a short part and a wrong multipart object."""
    if not header.startswith("bytes="):
        return None
    spec = header[len("bytes="):]
    if "," in spec:
        return None
    a, _, b = spec.partition("-")
    try:
        if a == "":
            # suffix range: last N bytes
            n = int(b)
            if n < 0:
                return None  # "bytes=--5": malformed, serve full object
            if n == 0:
                raise InvalidRangeError("zero suffix range")
            begin, end = max(0, size - n), size
        else:
            begin = int(a)
            end = int(b) + 1 if b != "" else size
            if clamp:
                end = min(end, size)
            elif end > size:
                raise InvalidRangeError(
                    f"range {header} out of bounds for size {size}")
    except ValueError:
        return None
    # common validation — the suffix branch flows through too, so a
    # suffix on an empty object is 416, never a (0, 0) degenerate range
    if begin >= size or begin >= end:
        raise InvalidRangeError(f"range {header} out of bounds for size {size}")
    return begin, end


async def handle_head_object(ctx) -> web.Response:
    _obj, version = await get_object_version(ctx, ctx.key_name)
    meta = version.meta()
    status = check_conditions(ctx, version, meta)
    if status is not None:
        return web.Response(status=status)
    hdrs = object_headers(version, meta)

    from ..common import int_param

    part_number = int_param(ctx.request.query.get("partNumber"), "partNumber")
    if part_number is not None and version.data()[0] == "inline":
        if part_number != 1:
            raise BadRequestError(f"no such part {part_number}")
        hdrs["Content-Length"] = str(meta["size"])
        hdrs["x-amz-mp-parts-count"] = "1"
        return web.Response(status=206, headers=hdrs)
    if part_number is not None and version.data()[0] == "first_block":
        ver_row = await ctx.garage.version_table.get(version.uuid, "")
        if ver_row is None:
            raise NoSuchKeyError("version metadata missing")
        blocks = [(k, v) for k, v in ver_row.sorted_blocks() if k[0] == part_number]
        if not blocks:
            raise BadRequestError(f"no such part {part_number}")
        psize = sum(sz for (_k, (_h, sz)) in blocks)
        nparts = len({k[0] for k, _ in ver_row.sorted_blocks()})
        hdrs["Content-Length"] = str(psize)
        hdrs["x-amz-mp-parts-count"] = str(nparts)
        return web.Response(status=206, headers=hdrs)
    hdrs["Content-Length"] = str(meta["size"])
    return web.Response(status=200, headers=hdrs)


async def handle_get_object(ctx) -> web.StreamResponse:
    garage = ctx.garage
    _obj, version = await get_object_version(ctx, ctx.key_name)
    meta = version.meta()
    status = check_conditions(ctx, version, meta)
    if status is not None:
        return web.Response(status=status)
    hdrs = object_headers(version, meta)
    size = meta["size"]
    data = version.data()

    # range / partNumber selection
    from ..common import int_param

    rng = ctx.request.headers.get("Range")
    part_number = int_param(ctx.request.query.get("partNumber"), "partNumber")
    if rng is not None and part_number is not None:
        raise BadRequestError("cannot combine Range and partNumber")

    if data[0] == "inline":
        body = bytes(data[2])
        if part_number is not None:
            # inline objects behave as a single part
            if part_number != 1:
                raise BadRequestError(f"no such part {part_number}")
            hdrs["Content-Range"] = f"bytes 0-{max(0, len(body)-1)}/{len(body)}"
            hdrs["x-amz-mp-parts-count"] = "1"
            return web.Response(status=206, headers=hdrs, body=body)
        if rng is not None:
            r = parse_range(rng, len(body))
            if r is not None:
                begin, end = r
                hdrs["Content-Range"] = f"bytes {begin}-{end-1}/{len(body)}"
                return web.Response(status=206, headers=hdrs, body=body[begin:end])
        return web.Response(status=200, headers=hdrs, body=body)

    ver_row = await garage.version_table.get(version.uuid, "")
    if ver_row is None:
        raise NoSuchKeyError("version metadata missing")
    blocks = ver_row.sorted_blocks()  # [((part, off), (hash, size))]

    if part_number is not None:
        pblocks = [(k, v) for k, v in blocks if k[0] == part_number]
        if not pblocks:
            raise BadRequestError(f"no such part {part_number}")
        begin = _part_offset(blocks, part_number)
        plen = sum(sz for (_k, (_h, sz)) in pblocks)
        end = begin + plen
        hdrs["Content-Range"] = f"bytes {begin}-{end-1}/{size}"
        hdrs["x-amz-mp-parts-count"] = str(len({k[0] for k, _ in blocks}))
        return await _stream_blocks_range(ctx, hdrs, 206, blocks, begin, end)

    if rng is not None:
        r = parse_range(rng, size)
        if r is not None:
            begin, end = r
            hdrs["Content-Range"] = f"bytes {begin}-{end-1}/{size}"
            return await _stream_blocks_range(ctx, hdrs, 206, blocks, begin, end)

    return await _stream_blocks_range(ctx, hdrs, 200, blocks, 0, size)


def _part_offset(blocks, pn: int) -> int:
    off = 0
    for (p, _o), (_h, sz) in blocks:
        if p < pn:
            off += sz
    return off


class _BlockPump:
    """Prefetch pump for one block: streams its decompressed chunks into a
    bounded queue (constant memory) while earlier blocks are still being
    written to the client — the buffered(PREFETCH) pipeline of
    ref get.rs:458-466, minus the whole-block buffering."""

    QUEUE_CHUNKS = 16  # ≈ 16 × 16 KiB transport chunks per in-flight block

    def __init__(self, garage, h: Hash, order_tag: int):
        self.q: asyncio.Queue = asyncio.Queue(maxsize=self.QUEUE_CHUNKS)
        self.task = asyncio.ensure_future(self._run(garage, h, order_tag))

    async def _run(self, garage, h: Hash, order_tag: int) -> None:
        gen = garage.block_manager.rpc_get_block_streaming(h, order_tag)
        try:
            async for chunk in gen:
                await self.q.put(chunk)
            await self.q.put(None)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # propagated to the writer loop
            await self.q.put(e)
        finally:
            # explicit close (not GC finalizers): the generator's cleanup
            # cancels the block stream so the serving node stops pumping
            await gen.aclose()


async def _stream_blocks_range(
    ctx, hdrs: Dict[str, str], status: int, blocks, begin: int, end: int
) -> web.StreamResponse:
    """Stream the [begin, end) byte range assembled from its intersecting
    blocks (ref get.rs:432-512 body_from_blocks_range): each block is
    streamed chunk-by-chunk from the replica (with mid-transfer node
    failover inside rpc_get_block_streaming), with the next PREFETCH
    blocks' streams already being pumped."""
    garage = ctx.garage
    hdrs["Content-Length"] = str(end - begin)
    hdrs.update(ctx.cors_headers)  # immutable after prepare()
    # a streamed download's duration is the CLIENT's drain pace — keep
    # it out of the CoDel admitted-latency law (api/admission.py) and
    # out of the latency SLO (api_server middleware reads the flag)
    ctx.request["slo_client_paced"] = True
    token = ctx.request.get("admission_token")
    if token is not None:
        token.exclude_sojourn()
    resp = web.StreamResponse(status=status, headers=hdrs)
    await resp.prepare(ctx.request)

    # compute absolute offsets + the intersecting slice per block
    todo: List[Tuple[Hash, int, int]] = []  # (hash, slice_begin, slice_end)
    abs_off = 0
    for (_pk, (h, sz)) in blocks:
        b0, b1 = abs_off, abs_off + sz
        abs_off = b1
        if b1 <= begin or b0 >= end:
            continue
        todo.append((Hash(h), max(0, begin - b0), min(sz, end - b0)))

    n = len(todo)
    pumps: Dict[int, _BlockPump] = {}
    all_pumps: List[_BlockPump] = []

    def spawn(idx: int) -> None:
        pumps[idx] = p = _BlockPump(garage, todo[idx][0], idx)
        all_pumps.append(p)

    try:
        for i in range(min(PREFETCH + 1, n)):
            spawn(i)
        for i in range(n):
            pump = pumps.pop(i)
            nxt = i + PREFETCH + 1
            if nxt < n:
                spawn(nxt)
            s0, s1 = todo[i][1], todo[i][2]
            pos = 0
            while True:
                item = await pump.q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                c0, c1 = pos, pos + len(item)
                pos = c1
                lo, hi = max(c0, s0), min(c1, s1)
                if hi > lo:
                    await resp.write(item[lo - c0 : hi - c0])
                    # the client drained bytes: it is demonstrably alive,
                    # so the request deadline renews — the budget bounds
                    # time-since-progress, never total transfer time
                    # (a multi-GiB download must not be shed at the 30 s
                    # mark).  Pumps spawned from here on inherit it.
                    refresh_deadline(garage.config.rpc.deadline_default)
        await resp.write_eof()
    except ConnectionError as e:
        # the client hung up mid-download — normal operation (aborted
        # transfer, closed tab); stop the block pumps and return the
        # partially-written response so aiohttp closes out quietly
        logger.debug("client disconnected mid-download: %s", e)
    finally:
        # runs on clean EOF, client ConnectionError, AND the
        # CancelledError aiohttp raises into the handler when the
        # transport dies abruptly (client killed mid-stream, gateway
        # failover): upstream block pumps stop pumping now, and the
        # admission slot frees the moment the stream stops — it must
        # not linger behind a dead connection until outer cleanup
        # (release is idempotent; api_server's finally releases again)
        for p in all_pumps:
            if not p.task.done():
                p.task.cancel()
        if token is not None:
            token.release()
    return resp
