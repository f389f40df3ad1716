"""PutObject — the S3 write path.

Equivalent of reference src/api/s3/put.rs (SURVEY.md §3.2): the body is
chunked into `block_size` blocks (put.rs:392-426); payloads under the
inline threshold are stored directly in the object row (put.rs:84-119);
larger objects create an Uploading version + Version row, then per block
pipeline {put-block RPC, version-meta insert, next-chunk read} with
running md5/sha256 hashing (put.rs:286-360), finishing with the
Complete{FirstBlock} object row.  Block refs are created by the version
table's updated() hook.  On failure the version is aborted and a cleanup
tombstone inserted (put.rs:436-466).
"""

from __future__ import annotations

import asyncio
import binascii
import contextlib
import hashlib
from typing import AsyncIterator, Dict, Optional, Tuple

from aiohttp import web

from ...block.manager import INLINE_THRESHOLD
from ...ops.codec import mhash_stream
from ...model.s3.object_table import (
    Object,
    ObjectVersion,
    ObjectVersionData,
    ObjectVersionHeaders,
    ObjectVersionMeta,
)
from ...model.s3.version_table import Version
from ...utils.crdt import now_msec
from ...utils.data import Hash, block_hash, gen_uuid
from ...utils.tracing import refresh_deadline
from ..common import ApiError, BadRequestError


def request_scope(garage):
    """Bracket one client WRITE request for the codec feeder's in-flight
    count (ops/feeder.py).  Entered at request INTAKE — before quota
    checks, metadata inserts and body streaming — so that by the time
    any request's first hash window is submitted, every concurrent
    writer is already counted and the submit's `peers` hint tells the
    dispatcher how many submissions it may expect to coalesce.  A no-op
    context manager when the feeder is disabled or draining."""
    feeder = getattr(garage.block_manager, "feeder", None)
    if feeder is None or feeder.closed:
        return contextlib.nullcontext()
    return feeder.request_scope()


class Chunker:
    """Re-chunk an async byte stream into fixed-size blocks
    (ref put.rs:392-426 StreamChunker)."""

    def __init__(self, stream: AsyncIterator[bytes], block_size: int):
        self.stream = stream.__aiter__()
        self.block_size = block_size
        self.buf = bytearray()
        self.eof = False

    async def next(self) -> Optional[bytes]:
        while not self.eof and len(self.buf) < self.block_size:
            try:
                self.buf.extend(await self.stream.__anext__())
            except StopAsyncIteration:
                self.eof = True
        if not self.buf:
            return None
        out = bytes(self.buf[: self.block_size])
        del self.buf[: self.block_size]
        return out


def headers_from_request(ctx) -> Dict:
    """Collect stored headers (ref put.rs get_headers)."""
    req = ctx.request
    other = {}
    for h in (
        "cache-control", "content-disposition", "content-encoding",
        "content-language", "expires",
    ):
        if h in req.headers:
            other[h] = req.headers[h]
    for k, v in req.headers.items():
        if k.lower().startswith("x-amz-meta-"):
            other[k.lower()] = v
    return ObjectVersionHeaders.new(
        req.headers.get("Content-Type", "application/octet-stream"), other
    )


async def check_quotas(ctx, add_size: int, key: Optional[str] = None) -> None:
    """ref put.rs check_quotas: max_size/max_objects from bucket params,
    crediting back the object being overwritten."""
    quotas = ctx.bucket.params().quotas.value or {}
    if not (quotas.get("max_size") or quotas.get("max_objects")):
        return
    counters = await ctx.garage.object_counter.get_totals(bytes(ctx.bucket_id))
    prev_objects, prev_size = 0, 0
    if key is not None:
        cur = await ctx.garage.object_table.get(ctx.bucket_id, key)
        lv = cur.last_data_version() if cur is not None else None
        if lv is not None:
            prev_objects, prev_size = 1, lv.size()
    if quotas.get("max_objects") is not None:
        if counters.get("objects", 0) - prev_objects + 1 > quotas["max_objects"]:
            raise ApiError("object quota exceeded", status=403, code="QuotaExceeded")
    if quotas.get("max_size") is not None:
        if counters.get("bytes", 0) - prev_size + add_size > quotas["max_size"]:
            raise ApiError("size quota exceeded", status=403, code="QuotaExceeded")


async def save_stream(
    ctx,
    stream: AsyncIterator[bytes],
    headers: Dict,
    key: str,
    content_md5: Optional[str] = None,
    content_sha256: Optional[str] = None,
    mhash=None,
) -> Tuple[str, int]:
    """Store a full object body; returns (etag, size) (ref put.rs:66-199).

    `mhash` is an optional IncrementalHash (ops/codec.py mhash_stream):
    when provided it advances over the body bytes IN THE SAME off-loop
    hop as md5/sha256, so the whole-object BLAKE2b-256 digest exists at
    stream end without ever rehashing the assembled object — O(1) extra
    state per request, zero extra passes over the data."""
    garage = ctx.garage
    bucket_id = ctx.bucket_id
    chunker = Chunker(stream, garage.config.block_size)
    first = await chunker.next() or b""

    md5 = hashlib.md5()
    sha256 = hashlib.sha256()

    # small payload: store inline in the object row (put.rs:84-119)
    if len(first) < INLINE_THRESHOLD and chunker.eof and not chunker.buf:
        md5.update(first)
        sha256.update(first)
        if mhash is not None:
            mhash.update(first)
        etag = md5.hexdigest()
        _check_digests(etag, sha256.hexdigest(), content_md5, content_sha256)
        await check_quotas(ctx, len(first), key)
        meta = ObjectVersionMeta.new(headers, len(first), etag)
        ov = ObjectVersion(
            gen_uuid(), now_msec(), ["complete", ObjectVersionData.inline(meta, first)]
        )
        await garage.object_table.insert(Object(bucket_id, key, [ov]))
        return etag, len(first)

    # large payload: streaming multi-block write (put.rs:120-199)
    # Pre-check quotas against the declared Content-Length so an over-quota
    # upload is rejected before consuming bandwidth and disk churn (the
    # reference pre-checks with the announced size, put.rs:76-82); the
    # post-stream check below still covers chunked bodies with no length.
    declared = ctx.request.headers.get(
        "x-amz-decoded-content-length",  # payload size under aws-chunked
        ctx.request.headers.get("Content-Length"),
    )
    if declared is not None:
        try:
            declared_n = int(declared)
        except ValueError:
            declared_n = None
        if declared_n is not None:
            await check_quotas(ctx, declared_n, key)
    version_uuid = gen_uuid()
    ts = now_msec()
    ov = ObjectVersion.uploading(version_uuid, ts, False, headers)
    await garage.object_table.insert(Object(bucket_id, key, [ov]))
    version = Version.new(version_uuid, bytes(bucket_id), key)
    await garage.version_table.insert(version)

    try:
        total_size, first_hash = await read_and_put_blocks(
            ctx, version, 0, first, chunker, md5, sha256, mhash=mhash
        )
        etag = md5.hexdigest()
        _check_digests(etag, sha256.hexdigest(), content_md5, content_sha256)
        await check_quotas(ctx, total_size, key)
        meta = ObjectVersionMeta.new(headers, total_size, etag)
        ov_done = ObjectVersion(
            version_uuid, ts,
            ["complete", ObjectVersionData.first_block(meta, first_hash)],
        )
        await garage.object_table.insert(Object(bucket_id, key, [ov_done]))
        return etag, total_size
    except BaseException:
        # cleanup: mark the version aborted (put.rs:436-466); the object
        # hook will tombstone the version row → drop block refs
        try:
            ov_abort = ObjectVersion(version_uuid, ts, ["aborted"])
            await garage.object_table.insert(
                Object(bucket_id, key, [ov_abort])
            )
        except Exception:
            pass
        raise


# Streaming write batching knobs.  HASH_WINDOW: blocks hashed per worker
# hop — ≥4 engages the 8-way SIMD BLAKE2s kernel (4.6× hashlib), and one
# to_thread hop amortizes over the window.  META_BATCH: the version row
# (whole-row CRDT re-insert whose hook creates block refs) lands every
# N blocks instead of every block — ~9 metadata commits/block measured
# down to ~1/block.  Cost: a crash mid-upload can orphan up to
# META_BATCH written-but-unreferenced blocks (the reference's concurrent
# block/meta writes have the same window at 1 block); `repair blocks`
# reclaims them, and the final insert still precedes the Complete row.
HASH_WINDOW = 8
META_BATCH = 8


async def read_and_put_blocks(
    ctx, version: Version, part_number: int, first_block: bytes,
    chunker: Chunker, md5, sha256, mhash=None,
) -> Tuple[int, Hash]:
    """Windowed streaming loop (ref put.rs:286-360 is strictly per-block):
    read up to HASH_WINDOW blocks ahead, hash the window in one worker
    hop (SIMD multi-buffer BLAKE2s; md5/sha256 advance sequentially in
    the same hop), pipeline the per-block quorum writes, and batch the
    version-meta inserts.  Returns (total_size, first_block_hash)."""
    garage = ctx.garage
    algo = garage.block_manager.hash_algo
    codec = garage.block_manager.codec
    # continuous-batching feeder (ops/feeder.py): BLAKE2s block-id
    # hashing SUBMITS here instead of running inline, so K concurrent
    # puts coalesce into one ragged SIMD/device batch while each
    # request's md5/sha256 (stream-sequential, unbatchable) advance in
    # parallel with the feeder wait — the deadline is effectively free
    # whenever the stream digests take longer than the SLO.
    feeder = getattr(garage.block_manager, "feeder", None)
    if feeder is not None and feeder.closed:
        feeder = None
    offset = 0
    first_hash: Optional[Hash] = None
    put_task: Optional[asyncio.Task] = None
    unflushed = 0

    async def put_one(h: Hash, data: bytes, off: int, flush_meta: bool,
                      started: asyncio.Event):
        # add_block runs HERE, not in the dispatch loop: a concurrent
        # flush insert must never encode a version row referencing a
        # block whose quorum write has not started (crash would leave
        # replicas holding rc for a hash no node stores).  Inside the
        # task, the row only ever includes blocks whose write is at
        # least concurrent with the insert — the reference's window.
        version.add_block(part_number, off, bytes(h), len(data))
        started.set()
        if flush_meta:
            # version row (hook creates the block refs) in parallel with
            # the block quorum write (put.rs:362-390)
            await asyncio.gather(
                garage.block_manager.rpc_put_block(h, data),
                garage.version_table.insert(version),
            )
        else:
            await garage.block_manager.rpc_put_block(h, data)

    def update_stream_digests(window):
        # one sequential pass shared by every stream digest: md5/sha256
        # for S3 semantics, plus the optional incremental BLAKE2b state
        # (satellite channel — the content digest is finished the moment
        # the last body byte arrives, no second pass over a 1 GiB body)
        for b in window:
            md5.update(b)
            sha256.update(b)
            if mhash is not None:
                mhash.update(b)

    def hash_window(window):
        update_stream_digests(window)
        if len(window) >= 4:
            return codec.batch_hash(window)
        return [block_hash(b, algo) for b in window]

    try:
        block = first_block
        while block:
            window = [block]
            while len(window) < HASH_WINDOW:
                nb = await chunker.next()
                if nb is None:
                    break
                window.append(nb)
            # the client delivered another window of body bytes: it is
            # demonstrably alive, so the request deadline renews — the
            # budget bounds time-since-progress, never total upload time
            # (a multi-GiB PUT must not be shed at the 30 s mark).  The
            # per-block put_one tasks spawned below inherit the renewed
            # budget at creation.
            refresh_deadline(garage.config.rpc.deadline_default)
            fut = _try_submit(feeder, window)
            if fut is not None:
                # feeder path: the block-id hash is already submitted —
                # run the stream digests OFF the loop and await both.
                # Keeping md5/sha256 off-loop matters beyond latency:
                # an inline digest would hold the event loop for ~4 ms
                # per put, serializing concurrent puts' submissions past
                # each other's SLO window so no batch ever formed; with
                # the hop, K in-flight puts all submit within the
                # deadline and coalesce into one ragged SIMD/device
                # dispatch.  The feeder wait overlaps the digest work.
                await asyncio.to_thread(update_stream_digests, window)
                hashes = list(await asyncio.wrap_future(fut))
            elif (offset == 0 and len(window) == 1 and chunker.eof
                    and not chunker.buf and len(window[0]) <= (1 << 20)):
                # no feeder, truly single-block body (the p50 latency
                # case): hash inline — nothing follows to overlap with,
                # and ≤1 MiB bounds the loop stall to less than an
                # executor hop
                hashes = [hash_window(window)[0]]
            else:
                hashes = await asyncio.to_thread(hash_window, window)
            for b, h in zip(window, hashes):
                if first_hash is None:
                    first_hash = h
                unflushed += 1
                if put_task is not None:
                    await put_task
                flush = unflushed >= META_BATCH
                if flush:
                    unflushed = 0
                started = asyncio.Event()
                put_task = asyncio.ensure_future(
                    put_one(h, b, offset, flush, started))
                offset += len(b)
            block = await chunker.next()
        # the version row must hold every block before the caller lands
        # the Complete object row (a racing GET could miss the tail);
        # gathering with the final block write keeps the small-object
        # overlap the per-block path always had
        if put_task is not None and unflushed:
            # the explicit event (set right after add_block) guarantees
            # the row encodes the tail block regardless of event-loop
            # scheduling policy
            await started.wait()
            await asyncio.gather(
                put_task, garage.version_table.insert(version))
        elif put_task is not None:
            await put_task
    except BaseException:
        if put_task is not None:
            put_task.cancel()
            try:
                await put_task
            except (asyncio.CancelledError, Exception):
                pass
        raise
    return offset, first_hash if first_hash is not None else Hash(b"\x00" * 32)


def _try_submit(feeder, window):
    """Submit a hash window to the codec feeder with the current
    in-flight write-request count (request_scope brackets at the
    handlers) as the `peers` hint; an unbracketed caller reads 0 and
    passes None = unknown, which the dispatcher treats as "wait out the
    SLO".  Returns None when the feeder is absent or closing (shutdown
    race) — the caller hashes inline, exactly the pre-feeder
    behavior."""
    if feeder is None:
        return None
    from ...ops.feeder import FeederClosed

    try:
        return feeder.submit_hash(window,
                                  peers=feeder.inflight_requests or None)
    except FeederClosed:
        return None


def _hash_block(md5, sha256, block: bytes, algo: str) -> Hash:
    md5.update(block)
    sha256.update(block)
    return block_hash(block, algo)


def _check_digests(md5_hex, sha256_hex, content_md5, content_sha256):
    """ref put.rs:200-240 ensure_checksum_matches."""
    if content_md5 is not None:
        expected = binascii.hexlify(binascii.a2b_base64(content_md5)).decode()
        if expected != md5_hex:
            raise ApiError("Content-MD5 mismatch", status=400, code="BadDigest")
    if content_sha256 is not None and content_sha256 != sha256_hex:
        raise ApiError("x-amz-content-sha256 mismatch", status=400, code="BadDigest")


async def handle_put_object(ctx) -> web.Response:
    key = ctx.key_name
    headers = headers_from_request(ctx)
    content_md5 = ctx.request.headers.get("Content-MD5")
    content_sha256 = ctx.verified.content_sha256
    if content_sha256 in (None, "STREAMING"):
        content_sha256 = None
    # incremental whole-object BLAKE2b-256 (utils.data.blake2sum family,
    # the metadata/merkle digest): advanced alongside md5/sha256 during
    # streaming so the digest is free at stream end — surfaced to the
    # client as a response header (schema-safe: no table changes)
    mhash = mhash_stream()
    with request_scope(ctx.garage):
        etag, _size = await save_stream(
            ctx, ctx.body_stream(), headers, key, content_md5, content_sha256,
            mhash=mhash,
        )
    return web.Response(status=200, headers={
        "ETag": f'"{etag}"',
        "x-garage-content-blake2b": mhash.hexdigest(),
    })
