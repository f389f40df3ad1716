"""WAN emulation harness — a TCP relay that adds propagation delay.

The reference's headline S3 benchmark runs on a simulated WAN (mknet
topologies with 100 ms RTT and 20 ms jitter between zones —
ref doc/book/design/benchmarks/index.md:20-62); its claim is that reads
and writes complete in ≈1 RTT because the quorum machinery contacts the
fastest replicas first.  This module is the in-tree equivalent of that
rig for an environment without tc/netem privileges: an asyncio TCP
proxy inserted between nodes that delays every chunk by a configurable
one-way latency (propagation-delay model: order-preserving, unbounded
bandwidth, optional jitter), so a 3-node loopback cluster behaves like
three datacenters.

Used by tests/test_wan_latency.py (1-RTT assertions + latency-ordered
candidate selection), bench.py's WAN phase, and — via the subclass hooks
`_on_accept` / `_filter` — by testing/faults.py's FaultyLink, which
composes partitions, resets and blackholes on top of the delay line.
Pure harness: the product stack (net/netapp.py, rpc/rpc_helper.py) is
measured through it, never modified by it.
"""

from __future__ import annotations

import asyncio
import random
from typing import Optional

__all__ = ["LatencyProxy"]


class LatencyProxy:
    """Relay 127.0.0.1:<port> → target, adding one-way delay each way.

    Each direction is an order-preserving delay line: a reader task
    stamps every chunk with `now + delay` and a writer task releases
    chunks at their deadlines, so concurrent chunks pipeline (as real
    propagation delay does) instead of serializing (as a sleep between
    read and write would)."""

    def __init__(self, target_host: str, target_port: int,
                 one_way_delay: float, jitter: float = 0.0):
        self.target = (target_host, target_port)
        self.delay = one_way_delay      # mutable: read per-chunk
        self.jitter = jitter
        self._server: Optional[asyncio.AbstractServer] = None
        self._tasks: set = set()
        self._conn_writers: set = set()  # live writers, for kill_connections

    async def start(self, port: int = 0) -> int:
        self._server = await asyncio.start_server(
            self._accept, "127.0.0.1", port)
        return self._server.sockets[0].getsockname()[1]

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    def retarget(self, port: int, host: Optional[str] = None) -> None:
        """Point the relay at a new upstream (a revived node listens on a
        fresh port); existing connections keep their old upstream."""
        self.target = (host or self.target[0], port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        # cancel relays BEFORE wait_closed: in 3.12+ wait_closed waits
        # for every accepted connection, and the pipes hold them open
        for t in list(self._tasks):
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()

    def _spawn(self, coro) -> None:
        t = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    def kill_connections(self) -> None:
        """Abort every relayed connection (both sides see a reset-like
        close).  The listener keeps running."""
        for w in list(self._conn_writers):
            try:
                w.close()
            except Exception:
                pass
        self._conn_writers.clear()

    # --- subclass hooks (fault injection) ---

    def _on_accept(self, reader, writer) -> bool:
        """Return False to refuse the connection (hard partition)."""
        return True

    def _filter(self, direction: str, data: bytes) -> Optional[bytes]:
        """Per-chunk hook; direction is 'tx' (client→target) or 'rx'.
        Return None to silently drop the chunk (one-way partition /
        blackhole); EOF still propagates."""
        return data

    async def _accept(self, reader, writer):
        if not self._on_accept(reader, writer):
            writer.close()
            return
        try:
            up_r, up_w = await asyncio.open_connection(*self.target)
        except OSError:
            writer.close()
            return
        self._conn_writers.add(writer)
        self._conn_writers.add(up_w)
        self._spawn(self._pipe(reader, up_w, "tx"))
        self._spawn(self._pipe(up_r, writer, "rx"))

    async def _pipe(self, reader, writer, direction: str = "tx"):
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()

        async def release():
            try:
                while True:
                    deadline, data = await queue.get()
                    dt = deadline - loop.time()
                    if dt > 0:
                        await asyncio.sleep(dt)
                    if data is None:
                        break
                    writer.write(data)
                    await writer.drain()
            except (ConnectionError, asyncio.CancelledError):
                pass
            finally:
                self._conn_writers.discard(writer)
                try:
                    writer.close()
                except Exception:
                    pass

        self._spawn(release())
        try:
            while True:
                data = await reader.read(64 * 1024)
                if data:
                    data = self._filter(direction, data)
                    if data is None:
                        continue  # dropped: read on, deliver nothing
                d = self.delay
                if self.jitter:
                    d += random.uniform(-self.jitter, self.jitter)
                    d = max(0.0, d)
                await queue.put((loop.time() + d, data or None))
                if not data:
                    break
        except (ConnectionError, asyncio.CancelledError):
            await queue.put((0.0, None))
