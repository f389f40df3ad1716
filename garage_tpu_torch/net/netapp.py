"""NetApp — authenticated, multiplexed, priority-scheduled RPC transport.

Equivalent of the reference's netapp crate (SURVEY.md §2.3): TCP transport
with an ed25519 handshake (node ID = public key; a cluster-wide shared
secret gates membership, ref rpc/system.rs:22-23,185-242), typed endpoints,
multiplexed request streams with 4 priorities, and streaming bodies.

Design notes (asyncio-native, not a port):
  - One reader task and one writer task per connection.  Outgoing frames sit
    in four bounded per-priority deques; the writer always drains the most
    urgent non-empty level, so PRIO_BACKGROUND bulk (resync/scrub) yields to
    PRIO_HIGH gossip at 16 KiB granularity.
  - A request = msgpack header + opaque payload + optional byte stream.
    Responses mirror that.  Stream frames of one stream are FIFO, which
    gives the reference's OrderTag ordering for free within a stream.
  - Handshake: both sides exchange pubkey+nonce, then prove (a) possession
    of the cluster secret (HMAC-SHA256 over the transcript) and (b) their
    node identity (ed25519 signature over the transcript).  The channel is
    authenticated, not encrypted — same trust model as deployments of the
    reference that run RPC on a private network.

Flow control: per-stream credit windows.  A sender may have at
most STREAM_WINDOW chunks of one stream in flight; the receiver grants
more credit (K_WIN frames at PRIO_HIGH) as the consumer drains the
stream.  A slow consumer therefore stalls only its own stream's sender —
the connection reader never blocks on a full stream buffer, so unrelated
RPCs on the same connection keep flowing (the reference's netapp has the
same property via per-stream channels).
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import logging
import os
import struct
import time
from collections import deque
from contextlib import nullcontext
from typing import Any, AsyncIterator, Awaitable, Callable, Dict, Optional, Tuple

import msgpack

from .ed25519_compat import Ed25519PrivateKey, Ed25519PublicKey, serialization

from ..utils.data import FixedBytes32
from ..utils.error import RpcError, error_code, remote_error
from ..utils.tracing import (
    TraceContext,
    arm_deadline,
    current_trace_context,
    deadline_expired,
    disarm_deadline,
    inherited_priority,
    remaining_budget,
    reset_remote_context,
    set_remote_context,
)
from .frame import (
    CHUNK,
    HDR_SIZE,
    K_CANCEL,
    K_DATA,
    K_EOS,
    K_ERR,
    K_GOODBYE,
    K_PING,
    K_PONG,
    K_REQ,
    K_RESP,
    K_WIN,
    MAX_FRAME,
    N_PRIO,
    PRIO_HIGH,
    PRIO_NORMAL,
    PRIO_NAMES,
    Frame,
    decode_header,
)

logger = logging.getLogger("garage_tpu_torch.net")

NodeID = FixedBytes32

_NULL_CTX = nullcontext()

# Protocol v2: a length-prefixed version frame follows the auth proof
# (NetApp.version exchange).  The magic is BUMPED with the wire change
# so a v1 peer fails the handshake cleanly ("bad protocol magic")
# instead of desyncing on the frame it does not expect — version skew
# WITHIN v2 (the rolling-upgrade drill) is what the frame itself
# carries.
MAGIC = b"GTPU/2\n"
_OUT_QUEUE_LIMIT = 16       # frames buffered per priority level
_IN_STREAM_LIMIT = 128      # legacy bound (loopback streams only)
STREAM_WINDOW = 64          # flow-control window per stream (64 × 16 KiB = 1 MiB)


def gen_node_key() -> Ed25519PrivateKey:
    return Ed25519PrivateKey.generate()


def key_to_bytes(key: Ed25519PrivateKey) -> bytes:
    return key.private_bytes(
        serialization.Encoding.Raw,
        serialization.PrivateFormat.Raw,
        serialization.NoEncryption(),
    )


def key_from_bytes(raw: bytes) -> Ed25519PrivateKey:
    return Ed25519PrivateKey.from_private_bytes(raw)


def node_id_of(key: Ed25519PrivateKey) -> NodeID:
    return NodeID(
        key.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw
        )
    )


def load_or_gen_node_key(path: str) -> Ed25519PrivateKey:
    """Persisted node identity, file mode 0600 (ref rpc/system.rs:201-242)."""
    if os.path.exists(path):
        with open(path, "rb") as f:
            return key_from_bytes(f.read())
    key = gen_node_key()
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
    with os.fdopen(fd, "wb") as f:
        f.write(key_to_bytes(key))
    return key


class ByteStream:
    """Incoming streaming body: async-iterate 16 KiB chunks.

    The queue is BOUNDED (STREAM_WINDOW + 2 chunks ≈ 2 MiB): connection-fed
    streams stay within it because the remote sender respects the credit
    window (`on_consumed` grants credit back as the consumer drains; a
    sender that violates the window fails the stream instead of growing the
    buffer), and loopback streams get real backpressure because the local
    producer awaits `_push` on the full queue.

    A consumer that stops early MUST call `aclose()` — it tells the sender
    to stop pumping (K_CANCEL for connection streams, producer-task cancel
    for loopback); abandoning the object without it parks the remote pump
    in its credit window until the connection closes."""

    def __init__(self, on_consumed=None, on_cancel=None,
                 maxsize: int = STREAM_WINDOW + 2):
        self._q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)
        self._err: Optional[str] = None
        self._err_code: Optional[str] = None  # structured K_ERR code
        self._on_consumed = on_consumed
        self._on_cancel = on_cancel
        self._consumed = 0
        self._done = False

    async def _push(self, chunk: Optional[bytes]):
        await self._q.put(chunk)

    def _push_nowait(self, chunk: Optional[bytes]):
        try:
            self._q.put_nowait(chunk)
        except asyncio.QueueFull:
            # only a sender ignoring the credit window can get here
            self._fail("flow-control window violated by sender")

    def _fail(self, err: str, code: Optional[str] = None):
        self._err = err
        self._err_code = code
        try:
            self._q.put_nowait(None)
        except asyncio.QueueFull:
            pass  # consumer drains the queue, then sees _err

    def _raise_err(self):
        """Stream failure as an exception: typed when the sender shipped
        a structured code in its K_ERR frame, plain RpcError otherwise."""
        if self._err_code is not None:
            raise remote_error(self._err_code, f"stream error: {self._err}")
        raise RpcError(f"stream error: {self._err}")

    def __aiter__(self):
        return self

    async def __anext__(self) -> bytes:
        if self._err is not None and self._q.empty():
            self._done = True
            self._raise_err()
        chunk = await self._q.get()
        if chunk is None:
            self._done = True
            if self._err is not None:
                self._raise_err()
            raise StopAsyncIteration
        if self._on_consumed is not None:
            self._consumed += 1
            if self._consumed >= STREAM_WINDOW // 2:
                n, self._consumed = self._consumed, 0
                try:
                    await self._on_consumed(n)
                except Exception:  # conn gone: the stream will fail anyway
                    pass
        return chunk

    async def aclose(self) -> None:
        """Abandon the stream: the sender stops pumping and both sides drop
        their per-stream state.  No-op after full consumption."""
        if self._done:
            return
        self._done = True
        self._err = "cancelled by receiver"
        if self._on_cancel is not None:
            try:
                await self._on_cancel()
            except Exception:
                pass

    async def read_all(self) -> bytes:
        return b"".join([c async for c in self])


# handler(remote_node, msg, body) -> (resp_msg, resp_body | None)
Handler = Callable[
    [NodeID, Any, Optional[ByteStream]],
    Awaitable[Tuple[Any, Optional[AsyncIterator[bytes]]]],
]


class Endpoint:
    """A typed RPC endpoint (ref netapp endpoint registration, e.g.
    table/table.rs:72-74).  Register a handler server-side; call remotely."""

    def __init__(self, netapp: "NetApp", path: str):
        self.netapp = netapp
        self.path = path
        self.handler: Optional[Handler] = None

    def set_handler(self, handler: Handler) -> "Endpoint":
        self.handler = handler
        return self

    async def call(
        self,
        node: NodeID,
        msg: Any,
        prio: int = PRIO_NORMAL,
        timeout: Optional[float] = 30.0,
        body: Optional[AsyncIterator[bytes]] = None,
    ) -> Any:
        resp, stream = await self.call_streaming(node, msg, prio, timeout, body)
        if stream is not None:
            await stream.read_all()  # drain ignored body
        return resp

    async def call_streaming(
        self,
        node: NodeID,
        msg: Any,
        prio: int = PRIO_NORMAL,
        timeout: Optional[float] = 30.0,
        body: Optional[AsyncIterator[bytes]] = None,
    ) -> Tuple[Any, Optional[ByteStream]]:
        return await self.netapp.call_streaming(node, self.path, msg, prio, timeout, body)


class _OutMux:
    """Bounded per-priority outgoing frame queues + strict-priority pop.

    Entries carry their enqueue timestamp so the writer can report how
    long each frame waited for the wire — the direct measure of
    priority-queue head-of-line blocking (a PRIO_HIGH gossip frame stuck
    behind bulk shows up as queue-wait, not as mystery RPC latency)."""

    def __init__(self):
        self.queues = [deque() for _ in range(N_PRIO)]
        self.cv = asyncio.Condition()
        self.closed = False
        # request frames dropped in-queue because their deadline passed
        # before they reached the wire (docs/ROBUSTNESS.md "Overload &
        # brownout"): under head-of-line pressure the doomed work is shed
        # HERE instead of burning wire bytes + a remote handler on it
        self.expired_drops = 0

    async def put(self, frame: Frame, deadline: Optional[float] = None,
                  on_drop=None):
        """`deadline` (absolute time.monotonic) marks a frame droppable
        once expired; `on_drop` (sync, no await) is invoked if the writer
        discards it — K_REQ senders fail their response future there so
        the caller sees a typed DeadlineExceeded immediately."""
        async with self.cv:
            while (
                len(self.queues[frame.prio]) >= _OUT_QUEUE_LIMIT and not self.closed
            ):
                await self.cv.wait()
            if self.closed:
                raise RpcError("connection closed")
            self.queues[frame.prio].append(
                (frame, time.perf_counter(), deadline, on_drop))
            self.cv.notify_all()

    async def pop(self) -> Optional[Tuple[Frame, float]]:
        """→ (frame, enqueue_perf_counter) or None when closed+drained.
        Queued frames whose deadline already passed are discarded (their
        on_drop hook runs) instead of being written — the client is gone;
        the wire slot goes to a frame someone still waits for."""
        async with self.cv:
            while True:
                popped = False
                for q in self.queues:
                    while q:
                        frame, t_enq, deadline, on_drop = q.popleft()
                        popped = True
                        if (deadline is not None
                                and time.monotonic() >= deadline):
                            self.expired_drops += 1
                            if on_drop is not None:
                                try:
                                    on_drop()
                                except Exception:  # noqa: BLE001
                                    pass
                            continue
                        self.cv.notify_all()
                        return frame, t_enq
                if popped:
                    # dropped expired entries freed queue slots: writers
                    # blocked in put() must recheck before we sleep
                    self.cv.notify_all()
                if self.closed:
                    return None
                await self.cv.wait()

    async def close(self):
        async with self.cv:
            self.closed = True
            self.cv.notify_all()


class _StreamCancelled(Exception):
    """Receiver abandoned the stream (K_CANCEL) — stop pumping, silently."""


async def _cancel_task(task: Optional[asyncio.Task]) -> None:
    """Loopback streams' on_cancel hook: stop the local producer task."""
    if task is not None and not task.done():
        task.cancel()


class _Credit:
    """Sender-side flow-control window for one outgoing stream."""

    __slots__ = ("n", "_ev", "_failed", "_cancelled")

    def __init__(self, n: int):
        self.n = n
        self._ev = asyncio.Event()
        self._failed = False
        self._cancelled = False

    async def take(self) -> None:
        while self.n <= 0:
            self._check()
            self._ev.clear()
            await self._ev.wait()
        self._check()
        self.n -= 1

    def _check(self) -> None:
        if self._cancelled:
            raise _StreamCancelled()
        if self._failed:
            raise RpcError("connection lost (flow control)")

    def grant(self, n: int) -> None:
        self.n += n
        self._ev.set()

    def fail(self) -> None:
        self._failed = True
        self._ev.set()

    def cancel(self) -> None:
        self._cancelled = True
        self._ev.set()


class Connection:
    """One authenticated, multiplexed peer connection."""

    def __init__(
        self,
        netapp: "NetApp",
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        remote_id: NodeID,
        is_dialer: bool,
    ):
        self.netapp = netapp
        self.reader = reader
        self.writer = writer
        self.remote_id = remote_id
        self.is_dialer = is_dialer
        self._next_stream = 1 if is_dialer else 2  # odd/even split
        self._out = _OutMux()
        self._pending: Dict[int, asyncio.Future] = {}   # stream -> resp future
        self._in_streams: Dict[int, ByteStream] = {}
        self._send_credit: Dict[int, "_Credit"] = {}    # outgoing stream windows
        self._pings: Dict[bytes, asyncio.Future] = {}
        self._tasks: list = []
        self._closed = False
        self.last_seen = time.monotonic()
        # per-peer per-priority traffic accounting, read by the Prometheus
        # counters below and by the `cluster stats` admin command
        self.tx_bytes = [0] * N_PRIO
        self.tx_frames = [0] * N_PRIO
        self.rx_bytes = [0] * N_PRIO
        self.rx_frames = [0] * N_PRIO
        self._peer_id_hex = bytes(remote_id).hex()[:16]
        self._peer_durable = False

    @property
    def _peer_label(self) -> str:
        """Metric label for this peer.  Connections from peers the node
        cannot redial (CLI clients with throwaway keypairs) aggregate
        under 'transient' — every `garage status` otherwise mints a new
        immortal counter series, unbounded over a daemon's lifetime.
        Once a peer proves durable (a dialable address is known) the
        real label sticks."""
        if self._peer_durable:
            return self._peer_id_hex
        fn = self.netapp.peer_durable_fn
        if fn is None or fn(self.remote_id):
            self._peer_durable = True
            return self._peer_id_hex
        return "transient"

    def traffic_stats(self) -> Dict[str, Dict[str, int]]:
        """{prio_name: {tx_bytes, tx_frames, rx_bytes, rx_frames}}."""
        return {
            PRIO_NAMES[p]: {
                "tx_bytes": self.tx_bytes[p],
                "tx_frames": self.tx_frames[p],
                "rx_bytes": self.rx_bytes[p],
                "rx_frames": self.rx_frames[p],
            }
            for p in range(N_PRIO)
        }

    def start(self):
        loop = asyncio.get_running_loop()
        self._tasks = [
            loop.create_task(self._read_loop()),
            loop.create_task(self._write_loop()),
        ]

    # --- outgoing ---

    def _alloc_stream(self) -> int:
        sid = self._next_stream
        self._next_stream += 2
        return sid

    async def request(
        self,
        path: str,
        msg_bytes: bytes,
        prio: int,
        timeout: Optional[float],
        body: Optional[AsyncIterator[bytes]],
    ) -> Tuple[bytes, Optional[ByteStream]]:
        if self._closed:
            raise RpcError(f"connection to {self.remote_id.hex_short()} closed")
        sid = self._alloc_stream()
        hdr_obj: Dict[str, Any] = {"p": path, "b": body is not None}
        # cross-node trace propagation: the caller's span identity rides
        # the request header, so the remote handler's spans join THIS
        # trace instead of starting an orphan one
        ctx = current_trace_context()
        if ctx is not None:
            hdr_obj["tc"] = TraceContext(
                ctx.trace_id, ctx.span_id, prio
            ).pack()
        # end-to-end deadline propagation: the REMAINING request budget
        # (relative seconds — peer clocks are not comparable) rides next
        # to the trace context; the serving node re-arms its task-local
        # deadline from it so further hops inherit an ever-shrinking
        # budget instead of a fresh 30 s per hop
        budget = remaining_budget()
        expires_at: Optional[float] = None
        if budget is not None:
            hdr_obj["dl"] = round(budget, 4)
            expires_at = time.monotonic() + budget
        header = msgpack.packb(hdr_obj, use_bin_type=True)
        fut = asyncio.get_running_loop().create_future()
        self._pending[sid] = fut

        def _expired_in_queue():
            # the writer dropped our K_REQ before it hit the wire: fail
            # the caller immediately with the typed budget error instead
            # of letting it burn its (already tiny) timeout
            if not fut.done():
                from ..utils.error import DeadlineExceeded

                fut.set_exception(DeadlineExceeded(
                    f"request {path} to {self.remote_id.hex_short()} "
                    f"expired in the outgoing queue"))

        try:
            await self._out.put(
                Frame(K_REQ, prio, sid, struct.pack(">I", len(header)) + header + msg_bytes),
                deadline=expires_at,
                on_drop=_expired_in_queue,
            )
            pump = None
            if body is not None:
                pump = asyncio.get_running_loop().create_task(
                    self._pump_body(sid, prio, body)
                )
            try:
                resp_payload, stream = await (
                    asyncio.wait_for(fut, timeout) if timeout else fut
                )
            finally:
                if pump is not None and not pump.done():
                    pump.cancel()
            hlen = struct.unpack(">I", resp_payload[:4])[0]
            rheader = msgpack.unpackb(resp_payload[4 : 4 + hlen], raw=False)
            rbody = resp_payload[4 + hlen :]
            if not rheader.get("ok", False):
                raise remote_error(
                    rheader.get("code"), rheader.get("err", "remote error")
                )
            return rbody, stream
        except asyncio.TimeoutError:
            # typed so the resilience layer can classify it (retryable,
            # breaker-feeding) without string matching
            from ..utils.error import TimeoutError_

            raise TimeoutError_(
                f"rpc timeout after {timeout}s calling {path} on "
                f"{self.remote_id.hex_short()}"
            )
        finally:
            self._pending.pop(sid, None)

    async def _pump_body(self, sid: int, prio: int, body: AsyncIterator[bytes]):
        credit = _Credit(STREAM_WINDOW)
        self._send_credit[sid] = credit
        try:
            async for chunk in body:
                for i in range(0, len(chunk), CHUNK):
                    # flow control: at most STREAM_WINDOW chunks of this
                    # stream in flight; the receiver grants more (K_WIN)
                    # as its consumer drains
                    await credit.take()
                    await self._out.put(Frame(K_DATA, prio, sid, bytes(chunk[i : i + CHUNK])))
            await self._out.put(Frame(K_EOS, prio, sid, b""))
        except asyncio.CancelledError:
            raise
        except _StreamCancelled:
            pass  # receiver already dropped its end; nothing to tell it
        except Exception as e:
            logger.debug("body pump error on stream %d: %s", sid, e)
            try:
                # structured abort: code + message, so the receiver can
                # re-raise the domain error type and label its metrics
                payload = msgpack.packb(
                    {"c": error_code(e), "m": str(e)}, use_bin_type=True
                )
                await self._out.put(Frame(K_ERR, prio, sid, payload))
            except RpcError:
                pass
        finally:
            self._send_credit.pop(sid, None)
            # release upstream resources (file handles, generators) promptly
            # — `async for` does not close a broken-out-of async generator
            aclose = getattr(body, "aclose", None)
            if aclose is not None:
                try:
                    await aclose()
                except Exception:
                    pass

    async def ping(self, timeout: float = 10.0) -> float:
        token = os.urandom(8)
        fut = asyncio.get_running_loop().create_future()
        self._pings[token] = fut
        t0 = time.monotonic()
        try:
            await self._out.put(Frame(K_PING, PRIO_HIGH, 0, token))
            await asyncio.wait_for(fut, timeout)
            return time.monotonic() - t0
        finally:
            self._pings.pop(token, None)

    # --- loops ---

    async def _write_loop(self):
        nm = self.netapp._net_metrics
        try:
            while True:
                entry = await self._out.pop()
                if entry is None:
                    break
                frame, t_enq = entry
                self.tx_frames[frame.prio] += 1
                self.tx_bytes[frame.prio] += HDR_SIZE + len(frame.payload)
                waited = time.perf_counter() - t_enq
                hook = self.netapp.queue_wait_hook
                if hook is not None:
                    try:
                        hook(waited)
                    except Exception:  # noqa: BLE001 — governor must not kill IO
                        pass
                if nm is not None:
                    prio_name = PRIO_NAMES[frame.prio]
                    nm["queue_wait"].observe(waited, prio=prio_name)
                    nm["tx_frames"].inc(peer=self._peer_label, prio=prio_name)
                    nm["tx_bytes"].inc(
                        HDR_SIZE + len(frame.payload),
                        peer=self._peer_label, prio=prio_name,
                    )
                self.writer.write(frame.encode())
                await self.writer.drain()
        except (ConnectionError, asyncio.CancelledError, OSError):
            pass
        finally:
            await self._shutdown()

    async def _read_loop(self):
        nm = self.netapp._net_metrics
        try:
            while True:
                hdr = await self.reader.readexactly(HDR_SIZE)
                kind, prio, sid, length = decode_header(hdr)
                if length > MAX_FRAME:
                    raise RpcError(f"oversized frame: {length}")
                payload = await self.reader.readexactly(length) if length else b""
                self.last_seen = time.monotonic()
                if prio < N_PRIO:
                    self.rx_frames[prio] += 1
                    self.rx_bytes[prio] += HDR_SIZE + length
                    if nm is not None:
                        nm["rx_frames"].inc(
                            peer=self._peer_label, prio=PRIO_NAMES[prio])
                        nm["rx_bytes"].inc(
                            HDR_SIZE + length,
                            peer=self._peer_label, prio=PRIO_NAMES[prio])
                await self._dispatch(kind, prio, sid, payload)
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            asyncio.CancelledError,
            OSError,
            RpcError,
        ):
            pass
        finally:
            await self._shutdown()

    def _make_in_stream(self, sid: int) -> ByteStream:
        """Flow-controlled incoming stream: grants window credit back to the
        sender as the consumer drains (K_WIN at PRIO_HIGH so grants are
        never stuck behind bulk data)."""

        async def grant(n: int, _sid=sid):
            await self._out.put(
                Frame(K_WIN, PRIO_HIGH, _sid, struct.pack(">I", n))
            )

        async def cancel(_sid=sid):
            # drop local state first so in-flight K_DATA frames are ignored,
            # then tell the sender to stop pumping
            self._in_streams.pop(_sid, None)
            try:
                await self._out.put(Frame(K_CANCEL, PRIO_HIGH, _sid, b""))
            except RpcError:
                pass  # connection gone — sender state died with it

        return ByteStream(on_consumed=grant, on_cancel=cancel)

    async def _dispatch(self, kind: int, prio: int, sid: int, payload: bytes):
        if kind == K_REQ:
            hlen = struct.unpack(">I", payload[:4])[0]
            header = msgpack.unpackb(payload[4 : 4 + hlen], raw=False)
            msg = payload[4 + hlen :]
            body = None
            if header.get("b"):
                body = self._make_in_stream(sid)
                self._in_streams[sid] = body
            asyncio.get_running_loop().create_task(
                self._handle_request(sid, prio, header, msg, body)
            )
        elif kind == K_RESP:
            # register the body stream before resolving the future, and hand
            # the stream object to the future directly — it may be fully
            # received (and deregistered) before the caller wakes up
            hlen = struct.unpack(">I", payload[:4])[0]
            rheader = msgpack.unpackb(payload[4 : 4 + hlen], raw=False)
            stream = None
            if rheader.get("b"):
                stream = self._make_in_stream(sid)
                self._in_streams[sid] = stream
            fut = self._pending.get(sid)
            if fut is not None and not fut.done():
                fut.set_result((payload, stream))
        elif kind == K_DATA:
            stream = self._in_streams.get(sid)
            if stream is not None:
                # never blocks: the sender respects the credit window, so
                # the queue holds at most ~STREAM_WINDOW chunks
                stream._push_nowait(payload)
        elif kind == K_WIN:
            credit = self._send_credit.get(sid)
            if credit is not None:
                credit.grant(struct.unpack(">I", payload[:4])[0])
        elif kind == K_CANCEL:
            credit = self._send_credit.get(sid)
            if credit is not None:
                credit.cancel()
        elif kind == K_EOS:
            stream = self._in_streams.pop(sid, None)
            if stream is not None:
                await stream._push(None)
        elif kind == K_ERR:
            stream = self._in_streams.pop(sid, None)
            if stream is not None:
                try:
                    err = msgpack.unpackb(payload, raw=False)
                    stream._fail(str(err.get("m", "remote error")),
                                 code=err.get("c"))
                except Exception:
                    # pre-structured peers sent bare utf-8 text
                    stream._fail(payload.decode("utf-8", "replace"))
        elif kind == K_PING:
            await self._out.put(Frame(K_PONG, PRIO_HIGH, 0, payload))
        elif kind == K_PONG:
            fut = self._pings.get(bytes(payload))
            if fut is not None and not fut.done():
                fut.set_result(True)
        elif kind == K_GOODBYE:
            raise RpcError("peer said goodbye")

    async def _handle_request(
        self, sid: int, prio: int, header: dict, msg: bytes,
        body: Optional[ByteStream],
    ):
        path = header["p"]
        # cross-node trace propagation, server side: extract the caller's
        # context and (a) wrap the handler in a span parented on it, so
        # every node an RPC touches contributes spans to ONE trace, and
        # (b) install it task-locally so deeper spans and further hops
        # inherit it.  This task is freshly created per request, so the
        # contextvar never leaks across requests.
        tctx = TraceContext.unpack(header.get("tc")) if header.get("tc") else None
        token = set_remote_context(tctx) if tctx is not None else None
        # deadline propagation, server side: re-arm the caller's remaining
        # budget task-locally so this handler's own work and further hops
        # clamp to it.  Malformed values from a hostile peer are ignored
        # (like a bad tc) — they must never break dispatch.
        dl = header.get("dl")
        dtoken = None
        if isinstance(dl, (int, float)) and not isinstance(dl, bool):
            budget = float(dl)
            if budget == budget and -1.0 <= budget <= 86400.0:  # finite, sane
                dtoken = arm_deadline(budget)
        tracer = self.netapp.tracer
        if tracer is not None and tctx is not None:
            span = tracer.span_from_context(
                f"RPC handler {path}", tctx,
                **{"from": self._peer_label, "prio": PRIO_NAMES[prio]
                   if prio < N_PRIO else prio},
            )
        else:
            span = _NULL_CTX
        try:
            with span:
                await self._handle_request_inner(sid, prio, path, msg, body)
        finally:
            if dtoken is not None:
                disarm_deadline(dtoken)
            if token is not None:
                reset_remote_context(token)

    async def _handle_request_inner(
        self, sid: int, prio: int, path: str, msg: bytes,
        body: Optional[ByteStream],
    ):
        ep = self.netapp.endpoints.get(path)
        try:
            if ep is None or ep.handler is None:
                raise RpcError(f"no handler for endpoint {path!r}")
            if deadline_expired():
                # the caller's budget ran out while this request sat in
                # queues: answer the typed error without running the
                # handler — the client is gone, the work would be waste
                from ..utils.error import DeadlineExceeded

                raise DeadlineExceeded(
                    f"budget exhausted before handler {path}")
            msg_obj = msgpack.unpackb(msg, raw=False)
            resp_obj, resp_body = await ep.handler(self.remote_id, msg_obj, body)
            resp = msgpack.packb(resp_obj, use_bin_type=True)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            logger.debug("handler %s error: %s", path, e)
            header = msgpack.packb(
                {"ok": False, "err": str(e), "code": error_code(e)},
                use_bin_type=True,
            )
            try:
                await self._out.put(
                    Frame(K_RESP, prio, sid, struct.pack(">I", len(header)) + header)
                )
            except RpcError:
                pass
            return
        header = msgpack.packb({"ok": True, "b": resp_body is not None}, use_bin_type=True)
        try:
            await self._out.put(
                Frame(K_RESP, prio, sid, struct.pack(">I", len(header)) + header + resp)
            )
            if resp_body is not None:
                await self._pump_body(sid, prio, resp_body)
        except RpcError:
            pass

    async def _shutdown(self):
        if self._closed:
            return
        self._closed = True
        await self._out.close()
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(RpcError("connection lost"))
        for stream in self._in_streams.values():
            stream._fail("connection lost")
        self._in_streams.clear()
        for credit in self._send_credit.values():
            credit.fail()  # release pumps blocked on flow control
        self._send_credit.clear()
        try:
            self.writer.close()
        except Exception:
            pass
        self.netapp._conn_lost(self)

    async def close(self):
        try:
            await self._out.put(Frame(K_GOODBYE, PRIO_HIGH, 0, b""))
        except RpcError:
            pass
        await asyncio.sleep(0)
        await self._shutdown()
        for t in self._tasks:
            t.cancel()


class NetApp:
    """The node's RPC stack: listener, dialer, endpoint registry, conn map."""

    def __init__(self, privkey: Ed25519PrivateKey, secret: Optional[str] = None,
                 version: Optional[str] = None):
        self.privkey = privkey
        self.id: NodeID = node_id_of(privkey)
        self.secret = (secret or "").encode()
        # advertised in the post-auth handshake frame; peers record it as
        # Connection.remote_version / NetApp.peer_versions (the rolling-
        # upgrade drill's transport-level skew signal)
        self.version = version or ""
        self.peer_versions: Dict[NodeID, str] = {}
        self.endpoints: Dict[str, Endpoint] = {}
        self.conns: Dict[NodeID, Connection] = {}
        self.on_connected: Optional[Callable[[NodeID, bool], None]] = None
        self.on_disconnected: Optional[Callable[[NodeID], None]] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._dial_locks: Dict[str, asyncio.Lock] = {}
        self._addr_ids: Dict[str, NodeID] = {}  # addr -> last node seen there
        # set by System: server-side handler spans parent on the caller's
        # propagated trace context
        self.tracer = None
        self._net_metrics: Optional[Dict[str, Any]] = None
        # set by System: NodeID -> bool, True when the peer has a known
        # dialable address (metric series worth keeping per-peer)
        self.peer_durable_fn: Optional[Callable[[NodeID], bool]] = None
        # set by the model layer: per-frame queue-wait seconds feed the
        # load governor's HOL-pressure signal (utils/overload.py)
        self.queue_wait_hook: Optional[Callable[[float], None]] = None

    def set_metrics(self, registry) -> None:
        """Attach per-peer traffic + queue-wait instruments (called by
        System; bare NetApps — tests, the CLI's throwaway client — stay
        uninstrumented)."""
        self._net_metrics = {
            "tx_bytes": registry.counter(
                "net_peer_tx_bytes_total",
                "Frame bytes written per peer and priority"),
            "tx_frames": registry.counter(
                "net_peer_tx_frames_total",
                "Frames written per peer and priority"),
            "rx_bytes": registry.counter(
                "net_peer_rx_bytes_total",
                "Frame bytes read per peer and priority"),
            "rx_frames": registry.counter(
                "net_peer_rx_frames_total",
                "Frames read per peer and priority"),
            "queue_wait": registry.histogram(
                "net_queue_wait_seconds",
                "Time outgoing frames waited in the priority queues "
                "before hitting the wire (head-of-line blocking signal)"),
        }

    def endpoint(self, path: str) -> Endpoint:
        ep = self.endpoints.get(path)
        if ep is None:
            ep = Endpoint(self, path)
            self.endpoints[path] = ep
        return ep

    def forget_peer_series(self, node: NodeID) -> None:
        """Drop the per-peer traffic counter series of a peer removed
        from the committed layout (System calls this alongside
        FullMeshPeering.forget_peer): a removed node's tx/rx totals
        would otherwise scrape forever as frozen lines.  The live
        connection's durable-label latch resets too, so goodbye traffic
        (the node learning the layout that removed it, its final block
        offloads) aggregates under peer="transient" instead of
        re-minting the dropped series."""
        self.peer_versions.pop(node, None)
        conn = self.conns.get(node)
        if conn is not None:
            conn._peer_durable = False
        if self._net_metrics is None:
            return
        lbl = bytes(node).hex()[:16]
        for key in ("tx_bytes", "tx_frames", "rx_bytes", "rx_frames"):
            self._net_metrics[key].drop_label("peer", lbl)

    # --- handshake ---

    def _transcript_mac(self, transcript: bytes, label: bytes) -> bytes:
        return hmac.new(self.secret, transcript + label, hashlib.sha256).digest()

    async def _handshake(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter, is_dialer: bool
    ) -> NodeID:
        my_pub = bytes(self.id)
        my_nonce = os.urandom(32)
        writer.write(MAGIC + my_pub + my_nonce)
        await writer.drain()
        hello = await asyncio.wait_for(reader.readexactly(len(MAGIC) + 64), 10.0)
        if hello[: len(MAGIC)] != MAGIC:
            raise RpcError("bad protocol magic")
        their_pub = hello[len(MAGIC) : len(MAGIC) + 32]
        their_nonce = hello[len(MAGIC) + 32 :]
        if is_dialer:
            transcript = MAGIC + my_pub + my_nonce + their_pub + their_nonce
            my_label, their_label = b"dialer", b"listener"
        else:
            transcript = MAGIC + their_pub + their_nonce + my_pub + my_nonce
            my_label, their_label = b"listener", b"dialer"
        sig = self.privkey.sign(transcript + my_label)
        mac = self._transcript_mac(transcript, my_label)
        writer.write(sig + mac)
        await writer.drain()
        proof = await asyncio.wait_for(reader.readexactly(64 + 32), 10.0)
        their_sig, their_mac = proof[:64], proof[64:]
        if not hmac.compare_digest(
            their_mac, self._transcript_mac(transcript, their_label)
        ):
            raise RpcError("peer does not know the cluster secret")
        Ed25519PublicKey.from_public_bytes(their_pub).verify(
            their_sig, transcript + their_label
        )
        # post-auth version advertisement: one length-prefixed frame each
        # way, so a mixed-version cluster (rolling upgrade in flight)
        # knows exactly which build sits on the other end of every
        # connection.  Exchanged AFTER authentication so an unauthorized
        # dialer learns nothing.
        vb = self.version.encode()[:255]
        writer.write(bytes([len(vb)]) + vb)
        await writer.drain()
        vlen = (await asyncio.wait_for(reader.readexactly(1), 10.0))[0]
        their_version = (
            await asyncio.wait_for(reader.readexactly(vlen), 10.0)
            if vlen else b""
        ).decode("utf-8", "replace")
        nid = NodeID(their_pub)
        self.peer_versions[nid] = their_version
        return nid

    # --- connection management ---

    def _register_conn(self, conn: Connection) -> bool:
        """Keep one connection per peer.  On a simultaneous-dial race the
        connection dialed by the lower node ID wins deterministically."""
        old = self.conns.get(conn.remote_id)
        if old is not None and not old._closed:
            new_dialer = self.id if conn.is_dialer else conn.remote_id
            old_dialer = self.id if old.is_dialer else old.remote_id
            if old_dialer == new_dialer:
                # same dialer re-dialed (e.g. reconnect we haven't noticed):
                # the newest connection is the live one — replace old
                asyncio.get_running_loop().create_task(old.close())
            elif old_dialer <= new_dialer:
                # simultaneous cross-dial: both sides deterministically keep
                # the connection dialed by the smaller node id
                return False
            else:
                asyncio.get_running_loop().create_task(old.close())
        self.conns[conn.remote_id] = conn
        if self.on_connected:
            self.on_connected(conn.remote_id, conn.is_dialer)
        return True

    def _conn_lost(self, conn: Connection):
        cur = self.conns.get(conn.remote_id)
        if cur is conn:
            del self.conns[conn.remote_id]
            # bound peer_versions to live + durable peers: throwaway CLI
            # connections would otherwise grow the map forever (same
            # rationale as the 'transient' metric label); cluster peers
            # re-advertise on reconnect and stay visible via gossip
            fn = self.peer_durable_fn
            if fn is not None and not fn(conn.remote_id):
                self.peer_versions.pop(conn.remote_id, None)
            if self.on_disconnected:
                self.on_disconnected(conn.remote_id)

    async def listen(self, bind_addr: str):
        host, port = bind_addr.rsplit(":", 1)
        self._server = await asyncio.start_server(
            self._accept, host or "0.0.0.0", int(port)
        )

    async def _accept(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            remote = await self._handshake(reader, writer, is_dialer=False)
        except Exception as e:
            logger.debug("handshake failed (accept): %s", e)
            writer.close()
            return
        conn = Connection(self, reader, writer, remote, is_dialer=False)
        if self._register_conn(conn):
            conn.start()
        else:
            writer.close()

    async def connect(self, addr: str, expected_id: Optional[NodeID] = None) -> Connection:
        """Dial a peer.  Dials to one address are serialized and live
        connections reused, so concurrent discovery/peering dials can't
        create duplicate connections that then kill each other."""
        lock = self._dial_locks.setdefault(addr, asyncio.Lock())
        async with lock:
            known = expected_id or self._addr_ids.get(addr)
            if known is not None:
                existing = self.conns.get(known)
                if existing is not None and not existing._closed:
                    return existing
            host, port = addr.rsplit(":", 1)
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, int(port)), 10.0
            )
            try:
                remote = await self._handshake(reader, writer, is_dialer=True)
            except Exception:
                writer.close()
                raise
            if expected_id is not None and remote != expected_id:
                writer.close()
                raise RpcError(
                    f"peer at {addr} is {remote.hex_short()}, expected "
                    f"{expected_id.hex_short()}"
                )
            if remote == self.id:
                writer.close()
                raise RpcError("connected to self")
            self._addr_ids[addr] = remote
            conn = Connection(self, reader, writer, remote, is_dialer=True)
            if not self._register_conn(conn):
                writer.close()
                return self.conns[remote]
            conn.start()
            return conn

    # --- calls ---

    async def call_streaming(
        self,
        node: NodeID,
        path: str,
        msg: Any,
        prio: int = PRIO_NORMAL,
        timeout: Optional[float] = 30.0,
        body: Optional[AsyncIterator[bytes]] = None,
    ) -> Tuple[Any, Optional[ByteStream]]:
        # priority inheritance (demote-only): work spawned while serving
        # a background-priority request never jumps ahead of it — a
        # resync-triggered nested fetch must not compete with user
        # traffic just because its call site asked for PRIO_NORMAL
        inherited = inherited_priority()
        if inherited is not None and inherited > prio:
            prio = inherited
        msg_bytes = msgpack.packb(msg, use_bin_type=True)
        if node == self.id:
            return await self._local_call(path, msg_bytes, body)
        conn = self.conns.get(node)
        if conn is None or conn._closed:
            raise RpcError(f"not connected to {node.hex_short()}")
        resp_bytes, stream = await conn.request(path, msg_bytes, prio, timeout, body)
        return msgpack.unpackb(resp_bytes, raw=False), stream

    async def _local_call(self, path, msg_bytes, body):
        """Self-calls short-circuit the network (the reference does the same
        via its own entry in the node list)."""
        ep = self.endpoints.get(path)
        if ep is None or ep.handler is None:
            raise RpcError(f"no handler for endpoint {path!r}")
        in_stream: Optional[ByteStream] = None
        pump = None
        if body is not None:
            in_stream = ByteStream(on_cancel=lambda: _cancel_task(pump))

            async def _feed():
                try:
                    async for chunk in body:
                        await in_stream._push(bytes(chunk))
                    await in_stream._push(None)
                except Exception as e:
                    in_stream._fail(str(e))
                finally:
                    aclose = getattr(body, "aclose", None)
                    if aclose is not None:
                        try:
                            await aclose()
                        except Exception:
                            pass

            pump = asyncio.get_running_loop().create_task(_feed())
        try:
            resp, resp_body = await ep.handler(
                self.id, msgpack.unpackb(msg_bytes, raw=False), in_stream
            )
        finally:
            if pump is not None and not pump.done():
                pump.cancel()
        out_stream = None
        if resp_body is not None:
            out_pump = None
            out_stream = ByteStream(on_cancel=lambda: _cancel_task(out_pump))

            async def _feed_out():
                try:
                    async for chunk in resp_body:
                        # backpressure: blocks on the bounded queue until
                        # the consumer drains (or cancels the task)
                        await out_stream._push(bytes(chunk))
                    await out_stream._push(None)
                except Exception as e:
                    out_stream._fail(str(e))
                finally:
                    aclose = getattr(resp_body, "aclose", None)
                    if aclose is not None:
                        try:
                            await aclose()
                        except Exception:
                            pass

            out_pump = asyncio.get_running_loop().create_task(_feed_out())
        return resp, out_stream

    async def shutdown(self):
        # stop accepting first, then close conns; only then wait_closed —
        # py3.12 Server.wait_closed blocks until every accepted transport
        # is closed, so the order matters
        if self._server is not None:
            self._server.close()
        for conn in list(self.conns.values()):
            await conn.close()
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5.0)
            except asyncio.TimeoutError:
                logger.debug("server wait_closed timed out")
