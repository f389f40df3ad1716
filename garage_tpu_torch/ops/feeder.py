"""CodecFeeder — continuous ragged batching for the foreground data path.

Without this module the codec's batch entry points are fed only by the
background producers (scrub/resync read-ahead): the CLIENT-FACING hot
path — PUT block-id hashing, write-time RS encodes, degraded-read RS
decodes — called the codec one request at a time, so K concurrent users
paid K serial codec passes (docs/PUT_LATENCY.md: a put is ~88% CPU and
conc8 p50 ≈ 8 × CPU-per-put).  This module closes the gap with the
batching idiom of Ragged Paged Attention (PAPERS.md): in-flight requests
SUBMIT individually and a dispatcher coalesces them into ragged batches
(variable block counts and sizes per submission) dispatched when either
the batch fills (``max_batch_blocks``) or an SLO deadline (``slo_ms``,
armed by the OLDEST pending submission) expires — a lone put never waits
for a full batch: the deadline bounds its wait, and when the submitter
can PROVE it is alone (the ``peers`` hint from the S3 layer's in-flight
put count) the dispatch is immediate, so solo latency pays only the
thread handoff.  Conversely, when peers are expected the wait ends early
as soon as that many submissions have arrived — under K-concurrent load
the batch forms without ever sleeping the full SLO.

Why this wins even on CPU: the ragged entry points it feeds
(BlockCodec.hash_ragged / rs_encode_ragged / rs_reconstruct_ragged) run
ONE fused pass over the concatenation of every submission — the 8-way
SIMD multi-buffer BLAKE2s engages across requests (a single 1 MiB block
per request leaves 7 of 8 lanes idle), the pointer-gather GF kernel
amortizes its per-call setup, and decode submissions sharing a survivor
pattern share one cached RS schedule ("Accelerating XOR-based Erasure
Coding", PAPERS.md).  On a device-armed node the hybrid codec routes the
whole batch to the accelerator when the (cached) link probe clears the
gate, so foreground traffic inherits the scrub path's device pipeline.

Threading contract: submissions may come from the event loop or any
worker thread; each returns a concurrent.futures.Future resolved by the
dispatcher thread.  ``shutdown()`` refuses new submissions and DRAINS
everything already accepted — acked work is never dropped — and the
``*_or_direct`` conveniences fall back to an inline codec call when the
feeder is closed, so shutdown races degrade to the pre-feeder behavior
instead of erroring.
"""

from __future__ import annotations

import collections
import concurrent.futures
import logging
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from ..utils.cpuprof import register_thread, unregister_thread

logger = logging.getLogger("garage_tpu_torch.ops.feeder")

KINDS = ("hash", "encode", "decode", "scrub", "mhash")

# histogram edges tuned to the objects being measured: waits are bounded
# by slo_ms (default 2 ms), batch sizes by max_batch_blocks
WAIT_BUCKETS = (0.0002, 0.0005, 0.001, 0.002, 0.004, 0.008, 0.016,
                0.05, 0.25)
SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                512.0, 1024.0)


class FeederClosed(RuntimeError):
    """Raised by submit_* after shutdown() — callers either drained
    already (the normal case) or fall back to a direct codec call."""


class _Item:
    __slots__ = ("kind", "payload", "blocks", "nbytes", "future", "ts",
                 "peers", "deadline", "cls", "want_parity", "tctx",
                 "span_id", "t_ns", "t_mono_ns", "t_dispatch_ns")

    def __init__(self, kind, payload, blocks, nbytes, peers=None,
                 cls="fg", want_parity=True):
        self.kind = kind
        self.payload = payload
        self.blocks = blocks
        self.nbytes = nbytes
        # scheduling class for the device transport's single queue:
        # "fg" = client-facing (PUT/GET verify, write-time encode,
        # degraded-read decode), "bg" = scrub/resync producers, demoted
        # behind foreground under governor pressure (ops/transport.py)
        self.cls = cls if cls in ("fg", "bg") else "fg"
        self.want_parity = want_parity
        # end-to-end request deadline (absolute time.monotonic), captured
        # from the submitter's task-local budget (utils/tracing): an
        # expired submission is failed typed at dispatch instead of
        # spending codec time on a request whose client already gave up
        from ..utils.tracing import current_deadline, current_trace_context

        self.deadline = current_deadline()
        # the submitter's trace identity: the dispatcher/transport run on
        # their own threads where the contextvars are gone, so the item
        # carries what they need to attribute feeder wait and device
        # compute back to the REQUEST's waterfall (utils/waterfall.py).
        # span_id is pre-allocated so transport-side child spans can
        # parent on the feeder span before it is recorded.
        self.tctx = current_trace_context()
        if self.tctx is not None:
            import os

            self.span_id = os.urandom(8).hex()
            self.t_ns = time.time_ns()
        else:
            self.span_id = None
            self.t_ns = 0
        # always-on monotonic submit stamp (t_ns is wall and traced-only):
        # the transport's enqueue timeline event diffs it to show feeder
        # wait next to the LinkProfiler's in-transport stages
        self.t_mono_ns = time.monotonic_ns()
        self.t_dispatch_ns = 0
        # how many concurrent submitters the CALLER can see (e.g. the
        # S3 layer's in-flight put count).  Three regimes: an explicit
        # peers <= 1 means PROVABLY alone — dispatch immediately, the
        # deadline would be pure added solo latency; peers > 1 means the
        # dispatcher stops waiting as soon as that many submissions have
        # arrived (the batch forms without sleeping the full SLO); None
        # means unknown concurrency (background encode/decode callers) —
        # wait out the SLO so a repair storm's submissions coalesce.
        self.peers = peers
        self.future: "concurrent.futures.Future" = concurrent.futures.Future()
        self.ts = time.perf_counter()


class CodecFeeder:
    """Deadline-bounded continuous batcher in front of one BlockCodec."""

    def __init__(self, codec, slo_ms: float = 2.0,
                 max_batch_blocks: int = 256, metrics=None, observer=None):
        self.codec = codec
        self.obs = observer if observer is not None else codec.obs
        self.slo = max(0.0, float(slo_ms)) / 1000.0
        self.max_batch_blocks = max(1, int(max_batch_blocks))
        self._cond = threading.Condition()
        self._pending: "collections.deque[_Item]" = collections.deque()
        self._pending_blocks = 0
        self._closed = False
        self._inflight = 0
        self._thread: Optional[threading.Thread] = None
        # lazy daemon worker for INLINE (CPU-side) scrub batches: a
        # multi-MiB fused verify+encode must not run on the lone
        # dispatcher thread, where it would head-of-line block every
        # foreground hash/encode/decode dispatch (pre-feeder, scrub
        # compute ran on its own asyncio.to_thread worker).  A daemon
        # thread + queue rather than a ThreadPoolExecutor: executor
        # threads are non-daemon and have no bounded join, so one
        # wedged codec call would hang both shutdown() and interpreter
        # exit.
        self._scrub_q: Optional[collections.deque] = None
        self._scrub_cond = threading.Condition()
        self._scrub_thread: Optional[threading.Thread] = None
        self._last_side: Optional[str] = None
        # always-on counters (admin `codec info` + bench self-attribution)
        self.submits = 0
        self.dispatches = 0
        self.dispatched_blocks = 0
        self.dispatch_reasons: dict = {}
        # kind → side → dispatches / bytes: tells block hashing from the
        # Merkle trie's metadata hashing (mhash), which is CPU-side
        self.routes: dict = {}
        self.max_depth_seen = 0
        self.expired = 0  # submissions shed: deadline passed pre-dispatch
        if metrics is not None:
            self.m_depth = metrics.gauge(
                "codec_feeder_depth",
                "Submissions waiting in the codec feeder",
                fn=lambda: float(len(self._pending)))
            self.m_wait = metrics.histogram(
                "codec_batch_wait_seconds",
                "Submit-to-dispatch wait in the codec feeder, by kind",
                buckets=WAIT_BUCKETS)
            self.m_size = metrics.histogram(
                "codec_batch_size",
                "Blocks per dispatched feeder batch, by kind",
                buckets=SIZE_BUCKETS)
            self.m_dispatch = metrics.counter(
                "codec_batch_dispatch_total",
                "Feeder batch dispatches by kind and trigger "
                "(full = batch filled, deadline = SLO expired, "
                "peers = all expected submitters arrived, "
                "lone = no peers expected so no wait, "
                "drain = shutdown flush)")
            self.m_submit = metrics.counter(
                "codec_batch_submit_total",
                "Feeder submissions by kind")
            # USE saturation: pending blocks vs one dispatch's capacity
            # (> 1 = the dispatcher cannot drain a full batch per window;
            # docs/OBSERVABILITY.md "Critical path & saturation")
            metrics.gauge(
                "feeder_queue_saturation",
                "Pending feeder blocks / max_batch_blocks (USE "
                "saturation; > 1 means the dispatcher is the bottleneck)",
                fn=lambda: self._pending_blocks / self.max_batch_blocks)
        else:
            self.m_depth = self.m_wait = self.m_size = None
            self.m_dispatch = self.m_submit = None

    # --- submission side ---------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    # In-flight foreground request tracking: the S3 put path brackets
    # each request with request_scope(), and submits carry the count as
    # the `peers` hint — that is how the dispatcher distinguishes "a
    # serial client whose submissions merely arrive back-to-back" (never
    # wait) from "K concurrent requests whose submissions will coalesce
    # if given one SLO window" (wait, but stop as soon as K arrive).

    def request_scope(self) -> "_RequestScope":
        return _RequestScope(self)

    @property
    def inflight_requests(self) -> int:
        return self._inflight

    def _submit(self, item: _Item) -> "concurrent.futures.Future":
        with self._cond:
            if self._closed:
                raise FeederClosed("codec feeder is shut down")
            self._pending.append(item)
            self._pending_blocks += item.blocks
            self.submits += 1
            if len(self._pending) > self.max_depth_seen:
                self.max_depth_seen = len(self._pending)
            if self._thread is None:
                # lazy start: bare-library users who never submit pay no
                # thread; daemon=True so a wedged codec call can't block
                # interpreter exit
                self._thread = threading.Thread(
                    target=self._run, name="codec-feeder", daemon=True)
                self._thread.start()
            self._cond.notify_all()
        if self.m_submit is not None:
            self.m_submit.inc(kind=item.kind)
        if item.tctx is not None and self.obs.tracer is not None:
            # the "Feeder <kind>" span covers submit→result on the
            # request's trace, with queue_s marking the wait portion
            # (the queue-wait/service-time split): recorded when the
            # future resolves, whichever thread does it, so both the
            # inline-CPU and transport routes attribute identically
            item.future.add_done_callback(self._emit_item_span(item))
        return item.future

    def _emit_item_span(self, item: _Item):
        def emit(_fut) -> None:
            tr = self.obs.tracer
            if tr is None:
                return
            try:
                attrs = {"kind": item.kind, "blocks": item.blocks}
                if item.t_dispatch_ns:
                    attrs["queue_s"] = round(
                        (item.t_dispatch_ns - item.t_ns) / 1e9, 6)
                tr.record_span(
                    f"Feeder {item.kind}", item.tctx.trace_id,
                    item.tctx.span_id, item.t_ns, time.time_ns(),
                    span_id=item.span_id, **attrs)
            except Exception:  # noqa: BLE001 — attribution must not fail work
                logger.debug("feeder span emit failed", exc_info=True)
        return emit

    def submit_hash(self, blocks: Sequence[bytes],
                    peers: Optional[int] = None, cls: str = "fg"):
        """BLAKE2s block-id hashing for one request's window of blocks.
        Future resolves to List[Hash] in submission order.  `peers` =
        concurrent submitters the caller can see (see _Item.peers)."""
        blocks = list(blocks)
        return self._submit(_Item(
            "hash", blocks, len(blocks), sum(len(b) for b in blocks),
            peers=peers, cls=cls))

    def submit_encode(self, blocks: Sequence[bytes],
                      peers: Optional[int] = None, cls: str = "fg"):
        """RS parity for one request's blocks (own codeword group,
        zero-padded to whole codewords — rs_encode_blocks semantics).
        Future resolves to (ceil(B/k), m, maxlen) uint8 parity."""
        blocks = list(blocks)
        return self._submit(_Item(
            "encode", blocks, len(blocks), sum(len(b) for b in blocks),
            peers=peers, cls=cls))

    def submit_decode(self, shards: np.ndarray, present: Sequence[int],
                      rows: Optional[Sequence[int]] = None,
                      peers: Optional[int] = None, cls: str = "fg"):
        """One degraded-read RS decode (rs_reconstruct semantics).
        Future resolves to the decoded (B, len(rows) or k, S) array."""
        return self._submit(_Item(
            "decode", (shards, list(present),
                       list(rows) if rows is not None else None),
            max(1, int(shards.shape[0])), int(shards.nbytes), peers=peers,
            cls=cls))

    def submit_mhash(self, bufs: Sequence[bytes],
                     peers: Optional[int] = None, cls: str = "bg"):
        """Metadata (Merkle node/key) BLAKE2b hashing for the table
        engine — the trie updater and the sync descent submit whole node
        batches here instead of hashing one node at a time.  Always
        dispatched on the CPU side (the trie hash is BLAKE2b; the device
        kernel is BLAKE2s — see BlockCodec.mhash_batch), class bg so a
        Merkle backlog drain never preempts foreground codec batches.
        Future resolves to List[Hash] in submission order."""
        bufs = list(bufs)
        return self._submit(_Item(
            "mhash", bufs, len(bufs), sum(len(b) for b in bufs),
            peers=peers, cls=cls))

    def submit_scrub(self, blocks: Sequence[bytes], hashes: Sequence,
                     want_parity: bool = True, cls: str = "bg"):
        """One scrub/resync batch (scrub_encode_batch semantics: fused
        verify + per-codeword RS parity).  Future resolves to
        (ok (B,), parity | None).  This is how the background producers
        ride the SAME feeder queue as foreground verifies — the scrub
        worker no longer talks to the device behind the feeder's back —
        entering the device transport as class "bg" (demoted behind
        foreground under governor pressure)."""
        blocks = list(blocks)
        return self._submit(_Item(
            "scrub", (blocks, list(hashes)), len(blocks),
            sum(len(b) for b in blocks), cls=cls,
            want_parity=want_parity))

    def prefetch_scrub(self, blocks: Sequence[bytes],
                       hashes: Sequence) -> int:
        """Hint the upcoming scrub range to the device pool
        (DevicePool prefetch): non-resident blocks stage as
        background-class transport work while the current batch
        computes, so the next scrub batch pool-hits.  A no-op (0)
        without an armed transport+pool — the hint is advisory and
        never an error."""
        tr = getattr(self.codec, "transport", None)
        pf = getattr(tr, "prefetch", None)
        if tr is None or pf is None or not tr.alive:
            return 0
        try:
            return int(pf(list(blocks), list(hashes)))
        except Exception:  # noqa: BLE001 — a lost hint is not an error
            logger.warning("pool prefetch hint failed", exc_info=True)
            return 0

    # sync conveniences with a closed-feeder fallback: shutdown races
    # degrade to the inline (pre-feeder) codec call, never to an error
    def hash_or_direct(self, blocks: Sequence[bytes]):
        try:
            return self.submit_hash(blocks).result()
        except FeederClosed:
            return self.codec.batch_hash(list(blocks))

    def encode_or_direct(self, blocks: Sequence[bytes]) -> np.ndarray:
        try:
            return self.submit_encode(blocks).result()
        except FeederClosed:
            return self.codec.rs_encode_blocks(list(blocks))

    def decode_or_direct(self, shards: np.ndarray, present: Sequence[int],
                         rows: Optional[Sequence[int]] = None,
                         cls: str = "fg") -> np.ndarray:
        try:
            return self.submit_decode(shards, present, rows,
                                      cls=cls).result()
        except FeederClosed:
            return self.codec.rs_reconstruct(shards, present, rows)

    async def scrub_async(self, blocks: Sequence[bytes], hashes: Sequence,
                          want_parity: bool = True):
        import asyncio

        try:
            fut = self.submit_scrub(blocks, hashes, want_parity)
        except FeederClosed:
            return await asyncio.to_thread(
                self.codec.scrub_encode_batch, list(blocks), list(hashes),
                want_parity)
        return await asyncio.wrap_future(fut)

    async def hash_async(self, blocks: Sequence[bytes],
                         peers: Optional[int] = None):
        import asyncio

        try:
            fut = self.submit_hash(blocks, peers=peers)
        except FeederClosed:
            return await asyncio.to_thread(
                self.codec.batch_hash, list(blocks))
        return await asyncio.wrap_future(fut)

    async def decode_async(self, shards: np.ndarray,
                           present: Sequence[int],
                           rows: Optional[Sequence[int]] = None,
                           cls: str = "fg"):
        """`cls="bg"` puts the decode behind foreground work in the
        queue — the repair planner submits rebuild-storm decodes there
        so a full-node heal coalesces into ragged batches without
        cutting ahead of client reads."""
        import asyncio

        try:
            fut = self.submit_decode(shards, present, rows, cls=cls)
        except FeederClosed:
            return await asyncio.to_thread(
                self.codec.rs_reconstruct, shards, present, rows)
        return await asyncio.wrap_future(fut)

    # --- dispatcher --------------------------------------------------------

    def _drain_locked(self) -> List[_Item]:
        """Pop submissions up to max_batch_blocks (at least one — a
        single oversized submission dispatches alone rather than
        deadlocking); remainder stays queued for the next batch."""
        batch: List[_Item] = []
        blocks = 0
        while self._pending and (not batch
                                 or blocks + self._pending[0].blocks
                                 <= self.max_batch_blocks):
            it = self._pending.popleft()
            self._pending_blocks -= it.blocks
            blocks += it.blocks
            batch.append(it)
        return batch

    def _run(self) -> None:
        register_thread("feeder-dispatch")
        try:
            self._run_inner()
        finally:
            unregister_thread()

    def _run_inner(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if not self._pending:
                    return  # closed and fully drained
                # Deadline armed by the OLDEST pending submission: work
                # that queued while the previous batch dispatched has
                # already aged past it and goes out immediately.  The
                # peers hint (the S3 layer's in-flight put count) trims
                # the wait from both ends: a PROVABLY lone submit
                # (explicit peers <= 1) dispatches at once — the
                # deadline would be pure added solo latency — and when
                # every pending submitter carries a hint, the wait ends
                # early once as many submissions as the largest peer
                # expectation have arrived.  Unhinted (peers=None)
                # submissions wait out the SLO: concurrency is unknown,
                # so the window is what coalesces a repair storm.
                deadline = self._pending[0].ts + self.slo
                reason = "deadline"
                while not self._closed:
                    if self._pending_blocks >= self.max_batch_blocks:
                        reason = "full"
                        break
                    # the peers short-circuit considers FOREGROUND
                    # submissions only: a co-pending background scrub
                    # (peers=None by design — it coalesces over the full
                    # SLO) must not force the foreground window to wait
                    # the deadline out when all its expected peers have
                    # already arrived
                    fg = [it for it in self._pending if it.cls == "fg"]
                    # a PURELY background window where every submitter
                    # hinted (the Merkle updater's mhash batches pass
                    # peers=1) may short-circuit on its own hints — the
                    # updater blocks on each batch, so sleeping the SLO
                    # out per batch is pure added drain latency.  Scrub
                    # deliberately never hints (peers=None coalesces a
                    # repair storm over the full window), so any
                    # co-pending scrub still holds the deadline.
                    pool = fg if fg else list(self._pending)
                    hints = [it.peers for it in pool]
                    if hints and None not in hints:
                        want = max(hints)
                        if want <= 1:
                            reason = "lone"
                            break
                        if len(pool) >= want:
                            reason = "peers"
                            break
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        break
                    self._cond.wait(timeout=left)
                    if not self._pending:
                        break  # spurious wake after a racing drain
                if not self._pending:
                    continue
                if self._closed:
                    reason = "drain"
                batch = self._drain_locked()
            try:
                self._dispatch(batch, reason)
            except BaseException as e:  # noqa: BLE001
                # belt and braces: _dispatch already routes per-kind
                # errors into futures; anything escaping must not kill
                # the dispatcher while submissions are queued.  Futures
                # already claimed RUNNING cannot be cancel()ed — they
                # must be failed explicitly or their waiters hang.
                logger.exception("feeder dispatch loop error")
                for it in batch:
                    if not it.future.done() and not it.future.cancel():
                        it.future.set_exception(e)

    def _dispatch(self, batch: List[_Item], reason: str) -> None:
        now = time.perf_counter()
        mono = time.monotonic()
        now_ns = time.time_ns()
        by_kind: dict = {}
        for it in batch:
            # claim the future first: a caller-cancelled submission is
            # excluded from the computation entirely
            if not it.future.set_running_or_notify_cancel():
                continue
            it.t_dispatch_ns = now_ns
            if it.deadline is not None and mono >= it.deadline:
                # the submitter's request budget ran out while this sat
                # in the feeder: shed it typed instead of burning codec
                # time on an answer nobody is waiting for
                from ..utils.error import DeadlineExceeded

                self.expired += 1
                it.future.set_exception(DeadlineExceeded(
                    f"codec {it.kind} submission expired in the feeder"))
                continue
            by_kind.setdefault(it.kind, []).append(it)
            if self.m_wait is not None:
                self.m_wait.observe(now - it.ts, kind=it.kind)
        side = getattr(self.codec, "ragged_side", lambda: "cpu")()
        all_items = [it for its in by_kind.values() for it in its]
        if (side == "cpu" and all_items
                and all(it.cls == "bg" for it in all_items)
                and any(it.kind != "mhash" for it in all_items)):
            # a PURELY background batch against a closed/unprobed gate
            # pays the (TTL-cached) link probe — the old stealing feeder
            # probed every scrub pass; with scrub riding this queue the
            # probe rides along, and a healthy link re-opens the device
            # route for THIS batch.  A batch carrying any foreground
            # item never pays it: the probe can cost a full link
            # round-trip and this is the lone dispatcher thread.
            # ...unless the device pool would serve the whole batch:
            # a fully-resident scrub batch moves ZERO link bytes, so
            # probing the link first is a pure 16 MiB cold-probe tax —
            # route it to the device regardless of gate state instead
            tr = getattr(self.codec, "transport", None)
            covers = getattr(tr, "pool_covers", None)
            scrubs = [it for it in all_items if it.kind != "mhash"]
            if (tr is not None and tr.alive and tr.supports("scrub")
                    and covers is not None and covers(scrubs)):
                side = "tpu"
                self.obs.event("feeder_route", reason="pool_resident",
                               blocks=sum(it.blocks for it in scrubs))
            else:
                refresh = getattr(self.codec, "refresh_gate", None)
                if refresh is not None:
                    refresh()
                    side = self.codec.ragged_side()
        if side != self._last_side:
            # route changes are gate decisions: they land in the same
            # event ring as the scrub feeder's probe/gate events
            self.obs.event("feeder_route", reason=side,
                           prev=self._last_side or "none")
            self._last_side = side
        for kind, items in by_kind.items():
            nblocks = sum(it.blocks for it in items)
            self.dispatches += 1
            self.dispatched_blocks += nblocks
            self.dispatch_reasons[reason] = (
                self.dispatch_reasons.get(reason, 0) + 1)
            if self.m_size is not None:
                self.m_size.observe(float(nblocks), kind=kind)
            if self.m_dispatch is not None:
                self.m_dispatch.inc(kind=kind, reason=reason)
            # Device side: hand the whole ragged batch to the zero-copy
            # transport (ops/transport.py) — the feeder is the single
            # producer of its deadline-aware queue, and the transport
            # resolves the items' futures (and counts their bytes) at
            # collect.  A closed/absent transport, or one the device
            # codec cannot serve for this kind, dispatches inline below.
            if side == "tpu" and kind != "mhash":
                # mhash (Merkle BLAKE2b) is CPU-only by contract — the
                # device kernel hashes BLAKE2s and must never route a
                # trie batch (see BlockCodec.mhash_batch)
                tr = getattr(self.codec, "transport", None)
                if tr is not None and tr.alive and tr.supports(kind):
                    try:
                        tr.submit_items(kind, items)
                        self._count_route(kind, "tpu", items)
                        self.obs.timeline.event(
                            f"handoff {kind}", "feeder",
                            time.monotonic_ns(), cat="feeder",
                            blocks=nblocks, reason=reason)
                        continue
                    except Exception:  # noqa: BLE001 — degrade inline
                        if getattr(tr, "on_card", False) and tr.alive:
                            raise  # a card's failure is its callers'
                        logger.warning(
                            "transport submit failed; dispatching "
                            "ragged %s batch inline", kind, exc_info=True)
            if kind == "scrub":
                # inline scrub compute runs off the dispatcher thread
                with self._scrub_cond:
                    if self._scrub_q is None:
                        self._scrub_q = collections.deque()
                        self._scrub_thread = threading.Thread(
                            target=self._scrub_worker,
                            name="codec-feeder-scrub", daemon=True)
                        self._scrub_thread.start()
                    self._scrub_q.append((items, side))
                    self._scrub_cond.notify_all()
                self._count_route(kind, side, items)
                continue
            t_disp_mono = time.monotonic_ns()
            t_disp_ns = time.time_ns()
            # metadata hashing is CPU-side even when the gate is open —
            # its bytes must not count as device traffic
            kside = "cpu" if kind == "mhash" else side
            self._count_route(kind, kside, items)
            try:
                with self.obs.stage("feeder_dispatch", kside):
                    if kind == "hash":
                        results = self.codec.hash_ragged(
                            [it.payload for it in items])
                    elif kind == "mhash":
                        results = self.codec.mhash_ragged(
                            [it.payload for it in items])
                    elif kind == "encode":
                        results = self.codec.rs_encode_ragged(
                            [it.payload for it in items])
                    else:
                        results = self.codec.rs_reconstruct_ragged(
                            [it.payload for it in items])
                self.obs.add_bytes(kside, sum(it.nbytes for it in items))
            except BaseException as e:  # noqa: BLE001 — fan the error out
                for it in items:
                    if not it.future.done():
                        it.future.set_exception(e)
                continue
            end_ns = time.time_ns()
            self.obs.timeline.event(
                f"dispatch {kind}", "feeder", t_disp_mono,
                time.monotonic_ns(), cat="feeder", blocks=nblocks,
                reason=reason, side=kside)
            tracer = self.obs.tracer
            if tracer is not None:
                # the inline compute is a CHILD of each item's feeder
                # span: the waterfall then splits the feeder envelope
                # into queue wait (queue_s) and codec compute
                for it in items:
                    if it.tctx is not None:
                        tracer.record_span(
                            f"Codec {kind}", it.tctx.trace_id,
                            it.span_id, t_disp_ns, end_ns, side=kside,
                            blocks=nblocks)
            for it, res in zip(items, results):
                if not it.future.done():
                    it.future.set_result(res)
            if len(results) < len(items):
                # a codec returning short must not strand the tail's
                # waiters behind a silently-truncating zip
                err = RuntimeError(
                    f"ragged {kind} returned {len(results)} results "
                    f"for {len(items)} submissions")
                for it in items[len(results):]:
                    if not it.future.done():
                        it.future.set_exception(err)

    def _count_route(self, kind: str, side: str, items) -> None:
        with self._cond:
            r = self.routes.setdefault(kind, {})
            d, b = r.get(side, (0, 0))
            r[side] = (d + 1, b + sum(it.nbytes for it in items))

    def _scrub_worker(self) -> None:
        register_thread("feeder-scrub")
        try:
            while True:
                with self._scrub_cond:
                    while not self._scrub_q:
                        self._scrub_cond.wait()
                    job = self._scrub_q.popleft()
                if job is None:
                    return
                self._dispatch_scrub_inline(*job)
        finally:
            unregister_thread()

    def _dispatch_scrub_inline(self, batch: List[_Item],
                               side: str) -> None:
        """Run one inline (non-transport) scrub batch and resolve its
        futures — on the dedicated scrub thread, so the dispatcher stays
        free for foreground batches."""
        try:
            with self.obs.stage("feeder_dispatch", side):
                results = self.codec.scrub_ragged(
                    [(it.payload[0], it.payload[1], it.want_parity)
                     for it in batch])
            self.obs.add_bytes(side, sum(it.nbytes for it in batch))
        except BaseException as e:  # noqa: BLE001 — fan the error out
            for it in batch:
                if not it.future.done():
                    it.future.set_exception(e)
            return
        for it, res in zip(batch, results):
            if not it.future.done():
                it.future.set_result(res)
        if len(results) < len(batch):
            err = RuntimeError(
                f"ragged scrub returned {len(results)} results "
                f"for {len(batch)} submissions")
            for it in batch[len(results):]:
                if not it.future.done():
                    it.future.set_exception(err)

    # --- lifecycle / introspection -----------------------------------------

    def shutdown(self, timeout: float = 15.0) -> None:
        """Refuse new submissions and drain everything already accepted.
        Idempotent; safe without a thread (nothing was ever submitted)."""
        with self._cond:
            already = self._closed
            self._closed = True
            pending = len(self._pending)
            t = self._thread
            self._cond.notify_all()
        if not already:
            self.obs.event("feeder_drain", reason="shutdown",
                           pending=pending)
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                logger.warning(
                    "codec feeder drain did not finish within %.1fs", timeout)
        st = self._scrub_thread
        if st is not None:
            # the dispatcher has drained: any inline scrub jobs are
            # already queued — drain them BOUNDED (a wedged codec call
            # must not hang node shutdown; unresolved futures then fall
            # to the callers' *_or_direct/async fallbacks)
            with self._scrub_cond:
                self._scrub_q.append(None)  # sentinel: exit after drain
                self._scrub_cond.notify_all()
            st.join(timeout)
            if st.is_alive():
                logger.warning(
                    "codec feeder scrub drain did not finish within "
                    "%.1fs", timeout)

    def stats(self) -> dict:
        with self._cond:
            return {
                "depth": len(self._pending),
                "max_depth_seen": self.max_depth_seen,
                "inflight_requests": self._inflight,
                "submits": self.submits,
                "expired": self.expired,
                "dispatches": self.dispatches,
                "dispatched_blocks": self.dispatched_blocks,
                "dispatch_reasons": dict(self.dispatch_reasons),
                "routes": {kind: {side: {"dispatches": d, "bytes": b}
                                  for side, (d, b) in r.items()}
                           for kind, r in self.routes.items()},
                "slo_ms": self.slo * 1000.0,
                "max_batch_blocks": self.max_batch_blocks,
                "closed": self._closed,
            }


class _RequestScope:
    """Brackets one foreground request (`with feeder.request_scope():`)
    so the feeder's in-flight count stays honest — that count is the
    `peers` hint submitters pass, i.e. how many submissions the
    dispatcher may expect to coalesce before the SLO deadline.  Entry
    and exit are a counter bump under the feeder lock; safe across
    await points (the count, not the scope, is thread-affine-free)."""

    __slots__ = ("feeder",)

    def __init__(self, feeder: CodecFeeder):
        self.feeder = feeder

    def __enter__(self) -> CodecFeeder:
        with self.feeder._cond:
            self.feeder._inflight += 1
        return self.feeder

    def __exit__(self, *exc) -> bool:
        with self.feeder._cond:
            self.feeder._inflight -= 1
        return False
