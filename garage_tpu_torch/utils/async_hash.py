"""Off-thread hashing for streaming request bodies.

Equivalent of reference src/util/async_hash.rs: one-shot helpers that
push a CPU-heavy hash onto a worker thread (async_blake2sum /
async_sha256sum, async_hash.rs:12-25), and a streaming `AsyncHasher`
fed chunk by chunk through a bounded channel whose consumer runs on a
dedicated thread (async_hash.rs:29-56).

Why it matters even on one core: hashlib releases the GIL for large
buffers, but calling `update()` inline still parks the *event loop
thread* for milliseconds per block — every other request on the node
stalls behind it.  Off-thread, the loop keeps multiplexing while the
hash runs.  The bounded feed queue (capacity 1, like the reference's
mpsc::channel(1)) backpressures the producer so a slow hasher can't
buffer the whole body in RAM.

Usage note: the S3 put path intentionally does NOT use AsyncHasher —
the dedicated thread pair costs thread spawns on every request, so
`read_and_put_blocks` advances md5+sha256+content
hash in one combined `asyncio.to_thread` hop per block (first block
inline: single-block objects are the p50 latency case).  AsyncHasher
remains for callers that need true streaming overlap of several
digests over one pass.
"""

from __future__ import annotations

import asyncio
import queue
import threading
from typing import Optional

from .data import BLOCK_HASH_ALGOS, Hash


async def async_block_hash(data: bytes, algo: str = "blake2s") -> Hash:
    """One-shot block hash on a worker thread (ref async_hash.rs:21-25)."""
    return await asyncio.to_thread(BLOCK_HASH_ALGOS[algo], data)


class AsyncHasher:
    """Streaming hasher whose digest state advances on its own thread.

    usage:
        h = AsyncHasher(hashlib.md5())
        try:
            await h.update(chunk)          # backpressured hand-off
            digest = await h.hexdigest()   # joins the thread
        finally:
            await h.aclose()               # no-op if finalized; releases
                                           # the thread on error paths

    The worker thread starts LAZILY on the first large update: small
    bodies (inline objects) hash directly on the caller — sub-threshold
    updates cost less inline than a thread hand-off would.
    """

    # below this, updating inline is cheaper than the thread hand-off
    INLINE_THRESHOLD = 128 * 1024

    def __init__(self, hasher, feed_capacity: int = 1):
        self._h = hasher
        self._capacity = feed_capacity
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._finished = False

    def _run(self) -> None:
        from .cpuprof import register_thread, unregister_thread
        register_thread("merkle")
        try:
            while True:
                blk = self._q.get()
                if blk is None:
                    return
                self._h.update(blk)
        finally:
            unregister_thread()

    async def update(self, data: bytes) -> None:
        if self._finished:
            raise RuntimeError("AsyncHasher already finalized")
        if self._thread is None:
            if len(data) < self.INLINE_THRESHOLD:
                self._h.update(data)
                return
            self._q = queue.Queue(maxsize=self._capacity)
            self._thread = threading.Thread(
                target=self._run, name="async-hasher", daemon=True
            )
            self._thread.start()
        # q.put blocks when the hasher lags → run it off-loop so the event
        # loop never parks; that block IS the backpressure
        await asyncio.to_thread(self._q.put, data)

    async def _finalize(self) -> None:
        if not self._finished:
            self._finished = True
            if self._thread is not None:
                await asyncio.to_thread(self._q.put, None)
                await asyncio.to_thread(self._thread.join)
                self._thread = None

    async def aclose(self) -> None:
        """Release the worker thread; safe to call any time, including
        after digest().  MUST run on error paths or every aborted request
        leaks a thread parked on the feed queue."""
        await self._finalize()

    async def digest(self) -> bytes:
        await self._finalize()
        return self._h.digest()

    async def hexdigest(self) -> str:
        await self._finalize()
        return self._h.hexdigest()
