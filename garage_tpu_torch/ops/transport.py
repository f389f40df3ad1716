"""DeviceTransport — the host↔device submission queue with pinned staging.

Why this exists.  A device codec fed one submission at a time pays, for
every batch, a fresh pad-and-copy of the blocks into a new host array, a
pageable H2D copy and an unpipelined sync — on the H100 those host-side
steps take most of the scrub's wall time while the kernels sit idle.
This module is the Ragged Paged Attention move (PAPERS.md) applied to
the storage dataplane: keep the work device-resident, feed it from ONE
queue, and hand the already-concatenated ragged buffers over with no
intermediate serialization.

One DeviceTransport per device codec owns ALL host↔device movement:

  - **Zero-copy submission.**  Blocks are written once into a reusable
    per-slot staging buffer (the single host copy — counted:
    ``transport_staged_bytes_total{copies="1"}`` and a per-block copy
    counter tests assert ≤ 1 against).  When the device codec asks for
    it (``pin_memory``, a CUDA device) the slot buffers are page-locked
    torch tensors and the codec copies them to the card with an
    asynchronous H2D DMA; the slot rule below keeps that safe.  No bytes
    join, no msgpack, no second pad pass.
  - **Double-buffered staging** bounded by ``max_device_staging_mib``:
    ``transport_staging_slots`` (default 2) slots, so batch N+1 stages
    and submits while batch N computes.  The slot rule: a slot is never
    rewritten until its batch is collected, so an H2D copy still in
    flight from a slot always reads the bytes it was given.  Oversized
    submissions are split
    at codeword-aligned boundaries into chunks that fit the budget
    (the staging-bound clamp), and the partial results are reassembled
    bit-identically.
  - **A single deadline-aware queue.**  The CodecFeeder is the only
    producer; foreground PUT/GET verify batches and background
    scrub/resync batches land in one earliest-deadline-first heap.
    Foreground submissions run at their request deadline (arrival time
    when none), background ones carry a slack that GROWS as the load
    governor's background_throttle_ratio drops (utils/overload.py) —
    the same demotion discipline the wire and disk layers already
    apply, now at the device door.  At equal deadlines foreground wins
    the tie.
  - **Self-measuring.**  ``probe_link`` times a real ragged submission
    through the full stage→submit→collect path, so the hybrid gate
    decides on the rate this transport actually delivers instead of
    the retired serialize+copy path's.
  - **Device-resident pool.**  When a DevicePool is attached
    (ops/device_pool.py), scrub staging consults it first: resident
    blocks ship as device page references and move ZERO link bytes
    (``pool_hit_bytes_total``), misses stage through the slot path and
    their verified lanes are adopted into the pool at collect
    (``pool_miss_bytes_total``); ``prefetch`` stages the scrub
    worker's next range ahead of need as background-class work.

Failure containment depends on where the device codec runs.  On a
CUDA card a device failure fails the affected batch's callers with its
error (``transport_error`` event): nothing is recomputed on the CPU and
the transport never closes itself.  Any other device (the CPU device, the
synthetic link) keeps the reference's zero-client-error rule: the batch
is recomputed inline on the CPU fallback codec (``transport_fallback``
event) and ``_MAX_DEVICE_FAILS`` consecutive failures close the transport
so the feeder routes around it.

The device side is duck-typed ("transport device API"): ``hash_submit/
hash_collect``, ``scrub_encode_submit/scrub_collect``, ``encode_submit``,
``decode_submit`` + ``staging_geometry`` — implemented by CudaCodec and
the synthetic-link test backend; scripted fakes without the API simply
never get a transport (the legacy ragged routing still works).
"""

from __future__ import annotations

import heapq
import logging
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..utils.cpuprof import register_thread, unregister_thread
from ..utils.data import Hash
from ..utils.timeline import current_src, src_ids

logger = logging.getLogger("garage_tpu_torch.ops.transport")

KINDS = ("hash", "scrub", "encode", "decode")
CLASSES = ("fg", "bg")

# consecutive device-side failures (submit or collect) that close the
# transport: past this the device is not flaky, it is gone, and every
# further batch would pay a stage + fallback for nothing
_MAX_DEVICE_FAILS = 3

_EMPTY_DIGEST: Optional[np.ndarray] = None


def _empty_digest_words() -> np.ndarray:
    """blake2s-256(b"") as the (8,) uint32 expectation pad lanes carry so
    they verify clean and never inflate a corruption count."""
    global _EMPTY_DIGEST
    if _EMPTY_DIGEST is None:
        import hashlib

        _EMPTY_DIGEST = np.frombuffer(
            hashlib.blake2s(b"", digest_size=32).digest(), dtype="<u4"
        ).copy()
    return _EMPTY_DIGEST


def on_card(device) -> bool:
    """True when the device codec runs on a CUDA card (its ``device`` is
    a CUDA torch.device).  There a device failure raises to the caller;
    no batch is rerouted to the CPU."""
    dev = getattr(device, "device", None)
    return isinstance(dev, torch.device) and dev.type == "cuda"


class TransportClosed(RuntimeError):
    """submit_items after shutdown()/device-down — the feeder falls back
    to the inline (CPU) dispatch path."""


def _swallow_result(future: Future) -> None:
    """Prefetch futures exist only to drive adoption; a failed
    prefetch is a lost optimization, not an error (the real scrub
    batch will stage the blocks itself)."""
    try:
        future.exception()
    except Exception:  # noqa: BLE001 — cancelled futures included
        pass


class TransportItem:
    """One submission as the transport sees it — the CodecFeeder's _Item
    satisfies this protocol (payload/blocks/nbytes/future/cls/deadline);
    direct users (tests, the probe) build TransportItems."""

    __slots__ = ("kind", "payload", "blocks", "nbytes", "future", "cls",
                 "deadline", "want_parity", "prefetch", "src")

    def __init__(self, kind: str, payload, blocks: int, nbytes: int,
                 cls: str = "fg", deadline: Optional[float] = None,
                 want_parity: bool = True, prefetch: bool = False,
                 src: Optional[int] = None):
        self.kind = kind
        self.payload = payload
        self.blocks = blocks
        self.nbytes = nbytes
        self.cls = cls
        self.deadline = deadline
        self.want_parity = want_parity
        # pool warm-up submission (DevicePool prefetch): results are
        # discarded, staging is attributed to pool_prefetch_bytes_total
        self.prefetch = prefetch
        # the submitter's batch id (utils/timeline.Src), carried as
        # ``src`` by the slot events of the batches made from this item
        self.src = src
        self.future: Future = Future()


class _Part:
    """A k-aligned slice of one item, small enough for the staging
    budget.  Items that fit whole have a single part."""

    __slots__ = ("item", "lo", "hi", "index", "total", "sink")

    def __init__(self, item, lo: int, hi: int, index: int, total: int,
                 sink: "_Assembler"):
        self.item = item
        self.lo = lo        # block/row offset into the item's payload
        self.hi = hi
        self.index = index  # part ordinal within the item
        self.total = total
        self.sink = sink


class _Assembler:
    """Collects one item's part results in order and resolves the future
    when the last part lands (bit-identical reassembly: parts split at
    codeword boundaries, parity columns zero-extend exactly)."""

    def __init__(self, item, total: int):
        self.item = item
        self.parts: List = [None] * total
        self.done = 0
        self.lock = threading.Lock()

    def deliver(self, index: int, result) -> None:
        item = self.item
        with self.lock:
            self.parts[index] = result
            self.done += 1
            if self.done < len(self.parts):
                return
        if item.future.done():
            return
        try:
            item.future.set_result(self._combine())
        except BaseException as e:  # noqa: BLE001 — assembly must not wedge waiters
            item.future.set_exception(e)

    def fail(self, e: BaseException) -> None:
        if not self.item.future.done():
            self.item.future.set_exception(e)

    def _combine(self):
        kind, parts = self.item.kind, self.parts
        if len(parts) == 1:
            return parts[0]
        if kind == "hash":
            return [h for p in parts for h in p]
        if kind == "decode":
            return np.concatenate(parts, axis=0)
        if kind == "encode":
            return _cat_parity(parts, self.item)
        # scrub: (ok, parity|None) per part
        ok = np.concatenate([p[0] for p in parts])
        if any(p[1] is None for p in parts):
            return ok, None
        return ok, _cat_parity([p[1] for p in parts], self.item)


def _cat_parity(rows: Sequence[np.ndarray], item) -> np.ndarray:
    """Concatenate per-part parity rows, zero-extending columns to the
    item-global maxlen (a block zero-extends to maxlen, and zero data
    columns produce zero parity columns — GF-linear, so the pad is the
    exact value the unsplit encode would have produced)."""
    blocks = item.payload if item.kind == "encode" else item.payload[0]
    maxlen = max(len(b) for b in blocks)
    out = []
    for p in rows:
        if p.shape[-1] < maxlen:
            p = np.pad(p, [(0, 0), (0, 0), (0, maxlen - p.shape[-1])])
        out.append(p[..., :maxlen])
    return np.concatenate(out, axis=0)


class _Batch:
    """One staged device dispatch: parts (possibly from several items)
    of a single kind, within the staging budget."""

    __slots__ = ("kind", "parts", "nbytes", "blocks", "eff_deadline",
                 "cls", "want_parity", "ts", "staged_est",
                 "t_enq", "t_pop", "t_stage0", "t_stage1", "t_adopt1",
                 "t_submit1", "t_ready", "compiled",
                 "pool_resident", "pool_adopt", "staged_payload",
                 "prefetch", "src", "t_pool0", "t_pool1")

    def __init__(self, kind: str, cls: str):
        self.kind = kind
        self.cls = cls
        self.parts: List[_Part] = []
        self.nbytes = 0        # payload bytes (obs accounting)
        self.blocks = 0
        self.eff_deadline = 0.0
        self.want_parity = False
        self.ts = 0.0
        self.staged_est = 0    # bucketed staging-buffer bytes (admission)
        # monotonic_ns stage boundary stamps feeding the device timeline
        # (obs.timeline), the per-request transport/device spans and the
        # LinkProfiler's exact-sum stage breakdown: t_stage0 ≤ t_stage1
        # (stage_copy) ≤ t_adopt1 (adopt) ≤ t_submit1 (dispatch/compile)
        # ≤ t_ready (compute) ≤ collect end.  t_adopt1/t_ready come from
        # the device codec's own stamps, clamped into the enclosing
        # transport interval
        self.t_enq = 0
        self.t_pop = 0
        self.t_stage0 = 0
        self.t_stage1 = 0
        self.t_adopt1 = 0
        self.t_submit1 = 0
        self.t_ready = 0
        self.compiled = False  # first dispatch of its (kind, shape)
        # DevicePool bookkeeping (None = staged the legacy, pool-less
        # way): resident lanes composed device-side, miss lanes to
        # adopt at collect, and the bytes that actually crossed the
        # link (what transport_staged_bytes_total must count — pool
        # hits move zero)
        self.pool_resident: Optional[list] = None
        self.pool_adopt: Optional[list] = None
        self.staged_payload: Optional[int] = None
        self.prefetch = False
        # the submitters' batch ids of its items (timeline ``src``) and
        # the pool adoption inside collect
        self.src: List[int] = []
        self.t_pool0 = 0
        self.t_pool1 = 0


class DeviceTransport:
    """One deadline-aware, double-buffered submission queue in front of
    one device codec.  See the module docstring for the design."""

    REQUIRED = {
        "hash": "hash_submit",
        "scrub": "scrub_encode_submit",
        "encode": "encode_submit",
        "decode": "decode_submit",
    }

    _PROBE_LANE_BYTES = 128 << 10  # probe splits into 128 KiB lanes

    def __init__(self, device, params, fallback=None, observer=None,
                 metrics=None, clock: Callable[[], float] = time.monotonic,
                 pool=None):
        """device: the array-level device codec (CudaCodec / synthetic).
        params: CodecParams (staging budget + transport tunables).
        fallback: a CPU BlockCodec absorbing failed batches inline.
        pool: an ops.device_pool.DevicePool consulted while staging
        scrub batches (None = legacy staging, byte-identical to the
        pre-pool transport)."""
        self.device = device
        self.params = params
        self.fallback = fallback
        self.pool = pool
        self.clock = clock
        if observer is None:
            from .observer import CodecObserver

            observer = CodecObserver(metrics=metrics)
        self.obs = observer
        self.slots = max(1, int(getattr(params, "transport_staging_slots",
                                        2)))
        budget = int(getattr(params, "max_device_staging_mib", 4096)) << 20
        # per-chunk staging bound: `slots` staged batches must fit the
        # budget together, so each chunk gets budget/slots (floored at
        # one codeword of the configured block size so tiny budgets
        # still make progress, matching the hybrid clamp's floor)
        k = max(1, params.rs_data)
        self.budget_bytes = max(budget, k * max(1, params.block_size))
        self.chunk_bytes = max(self.budget_bytes // self.slots,
                               k * max(1, params.block_size))
        self.bg_slack_s = max(
            0.0, float(getattr(params, "transport_bg_slack_ms", 50.0))
        ) / 1000.0
        # governor hook: model/garage.py points this at
        # LoadGovernor.ratio so background batches demote under
        # foreground pressure; None = no governor (ratio 1.0)
        self.governor_ratio: Optional[Callable[[], float]] = None

        self._cond = threading.Condition()
        self._heap: list = []
        self._seq = 0
        self._closed = False
        self._device_down = False
        self._thread: Optional[threading.Thread] = None
        self._inflight: list = []        # (batch, handle, variant) FIFO
        self._inflight_bytes = 0
        self._device_fails = 0
        # pinned staging: decided by the device codec (a CUDA device asks
        # for page-locked slots; the CPU device and the synthetic link
        # stage into plain numpy memory)
        self.pinned = bool(getattr(device, "pin_memory", False))
        # on a card a failed batch fails its callers (no CPU absorption,
        # no down latch)
        self.on_card = on_card(device)
        self._slot_bufs: List[Optional[np.ndarray]] = [None] * self.slots
        # the page-locked tensor behind each slot's numpy view (pinned only)
        self._slot_tensors: List[Optional[torch.Tensor]] = [None] * self.slots
        self._slot_free: List[int] = list(range(self.slots))
        self._probe_buf: Optional[np.ndarray] = None
        self._probe_staging: Optional[np.ndarray] = None
        self._probe_tensor: Optional[torch.Tensor] = None
        self._probe_warmed = False
        self._probe_lock = threading.Lock()

        # always-on accounting (admin `codec info` transport block +
        # bench attribution): the copy counter is the zero-copy claim's
        # proof — staged_copies is exactly one per staged block
        self.staged_bytes = 0
        self.staged_blocks = 0
        self.staged_copies = 0
        self.dispatches = 0
        self.chunks_split = 0
        self.fallbacks = 0
        self.device_errors = 0   # failed device batches, never reset
        self.max_staged_bytes_seen = 0
        self._depth = {"fg": 0, "bg": 0}
        # USE-method utilization accounting: device busy = wall time with
        # ≥ 1 batch staged-or-computing (the U of the device); link busy
        # = host-side stage/submit/collect work (the U of the host↔device
        # path).  Saturation = staged bytes queued + in flight vs the
        # budget.  Cumulative seconds; the *_ratio gauges window them at
        # render time.
        self.device_busy_seconds = 0.0
        self.link_busy_seconds = 0.0
        self._busy_since: Optional[float] = None
        self._queued_est = 0  # staged_est bytes still in the EDF heap
        # stage-level link attribution: every batch and every
        # probe round trip decomposed into stage_copy/adopt/compile/
        # dispatch/compute/collect with an exact-sum guarantee.  Hung off
        # the observer too so bench/admin reach it without holding a
        # transport reference across re-arms.
        from .link_profiler import LinkProfiler

        self.profiler = LinkProfiler(metrics=metrics)
        self.obs.link_profiler = self.profiler
        self.last_probe_stages: Optional[dict] = None

        if metrics is not None:
            self.m_staged = metrics.counter(
                "transport_staged_bytes_total",
                "Block bytes staged for the device by the transport, "
                "labelled with the host copies each byte paid "
                "(the zero-copy path stages exactly one)")
            self.m_depth = metrics.gauge(
                "transport_queue_depth",
                "Batches waiting in the device transport queue, by class",
                labeled_fn=lambda: [({"class": c}, float(n))
                                    for c, n in self._depth.items()])
            self.m_inflight = metrics.gauge(
                "transport_inflight_batches",
                "Device batches staged or computing (double-buffer "
                "occupancy)",
                fn=lambda: float(len(self._inflight)))
            # USE gauges (docs/OBSERVABILITY.md "Critical path &
            # saturation"): cumulative busy seconds for Grafana rate()
            # plus self-windowed busy fractions for at-a-glance reads
            metrics.gauge(
                "transport_device_busy_seconds",
                "Cumulative wall seconds the device had >= 1 batch "
                "staged or computing (USE utilization; rate() = busy "
                "fraction)", fn=self.device_busy_now)
            metrics.gauge(
                "transport_link_busy_seconds",
                "Cumulative host-side seconds spent staging, submitting "
                "and collecting device batches (USE utilization of the "
                "host<->device path)",
                fn=lambda: self.link_busy_seconds)
            dev_win = [time.monotonic(), 0.0]
            link_win = [time.monotonic(), 0.0]
            metrics.gauge(
                "transport_device_busy_ratio",
                "Device busy fraction over the last scrape window "
                "(0 idle, 1 saturated)",
                fn=lambda: self._window_ratio(self.device_busy_now,
                                              dev_win))
            metrics.gauge(
                "transport_link_busy_ratio",
                "Host<->device link busy fraction over the last scrape "
                "window",
                fn=lambda: self._window_ratio(
                    lambda: self.link_busy_seconds, link_win))
            metrics.gauge(
                "transport_queue_saturation",
                "Staged bytes queued + in flight vs the staging budget "
                "(USE saturation; > 1 means work is waiting on the "
                "double buffer)",
                fn=lambda: ((self._queued_est + self._inflight_bytes)
                            / self.budget_bytes))
        else:
            self.m_staged = self.m_depth = self.m_inflight = None

    def device_busy_now(self) -> float:
        """Cumulative device-busy seconds including the open interval."""
        busy, since = self.device_busy_seconds, self._busy_since
        if since is not None:
            busy += max(0.0, time.monotonic() - since)
        return busy

    @staticmethod
    def _window_ratio(getter, state: list) -> float:
        """Busy fraction since the previous render of the same gauge."""
        now = time.monotonic()
        busy = getter()
        t0, b0 = state
        state[0], state[1] = now, busy
        dt = now - t0
        if dt <= 0:
            return 0.0
        return min(max((busy - b0) / dt, 0.0), 1.0)

    # --- capability probing -------------------------------------------------

    @classmethod
    def supports_device(cls, device) -> bool:
        """The device implements enough of the transport API to be worth
        pumping (the fused scrub path at minimum)."""
        return (hasattr(device, "scrub_encode_submit")
                and hasattr(device, "staging_geometry"))

    def supports(self, kind: str) -> bool:
        return hasattr(self.device, self.REQUIRED[kind])

    @property
    def alive(self) -> bool:
        return not self._closed

    # --- submission ---------------------------------------------------------

    def submit_items(self, kind: str, items: Sequence, *,
                     want_parity: bool = True) -> None:
        """Enqueue a ragged batch of submissions (the feeder's dispatch
        unit).  Items' futures are resolved by the transport worker;
        raises TransportClosed without touching any future when the
        transport is shut down (the caller then dispatches inline)."""
        if kind not in KINDS:
            raise ValueError(f"unknown transport kind {kind!r}")
        if not self.supports(kind):
            raise TransportClosed(f"device lacks {self.REQUIRED[kind]}")
        batches = self._plan(kind, items, want_parity)
        now = self.clock()
        t_ns = time.monotonic_ns()
        with self._cond:
            if self._closed:
                raise TransportClosed("device transport is shut down")
            for b in batches:
                b.src = src_ids(p.item for p in b.parts)
                b.ts = time.perf_counter()
                b.t_enq = t_ns
                b.eff_deadline = self._effective_deadline(b, now)
                self._seq += 1
                heapq.heappush(
                    self._heap,
                    (b.eff_deadline, 0 if b.cls == "fg" else 1,
                     self._seq, b))
                self._depth[b.cls] = self._depth.get(b.cls, 0) + 1
                self._queued_est += b.staged_est
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="codec-transport", daemon=True)
                self._thread.start()
            self._cond.notify_all()
        tl = self.obs.timeline
        # host-side latency BEFORE the transport ever saw the work: the
        # oldest contributing item's feeder submit stamp → this enqueue
        # (pairs with the LinkProfiler's in-transport stages so the full
        # host journey is attributable from one trace)
        oldest = min((getattr(p.item, "t_mono_ns", 0)
                      for b in batches for p in b.parts
                      if getattr(p.item, "t_mono_ns", 0)), default=0)
        tl.event(f"enqueue {kind}", "edf", t_ns, cat="transport",
                 cls=batches[0].cls if batches else "fg",
                 batches=len(batches),
                 nbytes=sum(b.nbytes for b in batches),
                 feeder_ms=round((t_ns - oldest) / 1e6, 3) if oldest
                 else None,
                 src=sorted({i for b in batches for i in b.src}))
        tl.counter("transport_queue", t_ns,
                   fg=self._depth.get("fg", 0), bg=self._depth.get("bg", 0))

    def _effective_deadline(self, batch: _Batch, now: float) -> float:
        """EDF key.  Foreground: arrival time — a request's expiry
        deadline is a shedding bound, not a scheduling priority, so
        foreground stays FIFO and always ahead of contemporaneous
        background.  Background: arrival + a slack that STRETCHES as
        the governor's throttle ratio drops — at ratio 1 background
        trails foreground by bg_slack, near min_ratio it queues behind
        every foreground batch of the next seconds (the same demotion
        discipline the wire and disk layers apply).  An explicit
        background deadline is honored as an upper bound: it can move
        the batch earlier, but the class rank still breaks an exact tie
        in foreground's favor."""
        if batch.cls == "fg":
            return now
        ratio = 1.0
        if self.governor_ratio is not None:
            try:
                ratio = min(max(float(self.governor_ratio()), 0.01), 1.0)
            except Exception:  # noqa: BLE001 — a dead governor is full rate
                ratio = 1.0
        demoted = now + self.bg_slack_s / ratio
        dls = [p.item.deadline for p in batch.parts
               if p.item.deadline is not None]
        return min(demoted, *dls) if dls else demoted

    # --- batch planning (the staging-bound clamp) ---------------------------

    def _plan(self, kind: str, items: Sequence,
              want_parity: bool) -> List[_Batch]:
        """Split items into staged batches of ≤ chunk_bytes.  Oversized
        items are cut at codeword-aligned boundaries and reassembled by
        their _Assembler; co-submitted items coalesce into one dispatch
        while they fit."""
        k = max(1, self.params.rs_data)
        batches: List[_Batch] = []
        cur: Optional[_Batch] = None

        def flush():
            nonlocal cur
            if cur is not None and cur.parts:
                batches.append(cur)
            cur = None

        lanes_ml = [0, 0]  # combined (entry-padded lanes, max len) of cur

        def est_with(pl: int, ml: int) -> int:
            if kind == "decode":
                return 0  # decode parts carry their own dense est
            return self._staged_est(
                kind, lanes_ml[0] + pl, max(lanes_ml[1], ml), k)

        for it in items:
            cls = getattr(it, "cls", "fg") or "fg"
            pf = bool(getattr(it, "prefetch", False))
            wp = bool(getattr(it, "want_parity", want_parity))
            pieces = self._cut_points(kind, it, k)
            sink = _Assembler(it, len(pieces))
            if len(pieces) > 1:
                self.chunks_split += len(pieces) - 1
                self.obs.event("transport_chunk", reason="staging_bound",
                               work=kind, parts=len(pieces),
                               nbytes=it.nbytes)
            for idx, (lo, hi, nb, blk, ml) in enumerate(pieces):
                pl = (blk + ((-blk) % k)
                      if kind in ("scrub", "encode") else blk)
                est = est_with(pl, ml) if kind != "decode" else nb
                if cur is not None and (
                        cur.cls != cls
                        # a prefetch item must not coalesce with real
                        # scrub work: the batch-level flag routes byte
                        # attribution (pool_prefetch_bytes vs hit/miss),
                        # and a mixed batch would misattribute one side
                        or cur.prefetch != pf
                        or (kind == "decode"
                            and cur.staged_est + est > self.chunk_bytes)
                        or (kind != "decode"
                            and cur.parts and est > self.chunk_bytes)):
                    flush()
                    lanes_ml[0] = lanes_ml[1] = 0
                    est = est_with(pl, ml) if kind != "decode" else nb
                if cur is None:
                    cur = _Batch(kind, cls)
                    cur.prefetch = pf
                cur.parts.append(
                    _Part(it, lo, hi, idx, len(pieces), sink))
                cur.nbytes += nb
                cur.blocks += blk
                lanes_ml[0] += pl
                lanes_ml[1] = max(lanes_ml[1], ml)
                cur.staged_est = (cur.staged_est + est if kind == "decode"
                                  else est)
                cur.want_parity = cur.want_parity or wp
        flush()
        return batches

    def _staged_est(self, kind: str, nlanes: int, maxlen: int,
                    k: int) -> int:
        """Bucketed staging-buffer bytes a slice will actually occupy —
        the budget must bound REAL host memory, not payload bytes: the
        device's staging geometry rounds lanes and row width up (power-
        of-two bucketing for retrace avoidance), which can near-4x a
        payload sized just past a bucket edge."""
        if kind in ("scrub", "encode"):
            nlanes += (-nlanes) % k
        lanes, cols = self._geometry(nlanes, maxlen, kind)
        return lanes * cols

    def _cut_points(self, kind: str, it, k: int):
        """[(lo, hi, nbytes, blocks, maxlen)] covering the item, each
        within chunk_bytes of BUCKETED staging bytes (the budget bounds
        real host memory, not payload bytes — the device geometry
        rounds lanes and row width up); scrub/encode cut only at
        multiples of k so no RS codeword straddles a chunk
        (item-relative: the codec groups k consecutive blocks from the
        item's start)."""
        if kind == "decode":
            shards, _present, _rows = it.payload
            pcount = min(int(shards.shape[-2]), max(1, k))
            s4 = int(shards.shape[-1])
            s4 += (-s4) % 4  # staged at the device's 4-aligned width
            per_row = int(pcount * s4)
            step = max(1, self.chunk_bytes // max(per_row, 1))
            n = int(shards.shape[0])
            return [(lo, min(lo + step, n),
                     (min(lo + step, n) - lo) * per_row,
                     min(lo + step, n) - lo, int(shards.shape[-1]))
                    for lo in range(0, n, step)]
        blocks = it.payload if kind != "scrub" else it.payload[0]
        n = len(blocks)
        whole_ml = max((len(b) for b in blocks), default=0)
        if self._staged_est(kind, n, whole_ml, k) <= self.chunk_bytes:
            return [(0, n, it.nbytes, n, whole_ml)]
        align = k if kind in ("scrub", "encode") else 1
        out = []
        lo = nb = i = 0
        ml = 0
        while i < n:
            j = min(i + align, n)
            unit = sum(len(b) for b in blocks[i:j])
            unit_ml = max((len(b) for b in blocks[i:j]), default=0)
            if i > lo and self._staged_est(
                    kind, j - lo, max(ml, unit_ml),
                    k) > self.chunk_bytes:
                out.append((lo, i, nb, i - lo, ml))
                lo, nb, ml = i, 0, 0
            nb += unit
            ml = max(ml, unit_ml)
            i = j
        out.append((lo, n, nb, n - lo, ml))
        return out

    # --- the worker ---------------------------------------------------------

    def _admit_locked(self, batch: _Batch) -> bool:
        if len(self._inflight) >= self.slots or not self._slot_free:
            return False
        if not self._inflight:
            return True  # a lone oversized batch must not deadlock
        return (self._inflight_bytes + batch.staged_est
                <= self.budget_bytes)

    def _run(self) -> None:
        register_thread("transport-stage")
        try:
            self._run_inner()
        finally:
            unregister_thread()

    def _run_inner(self) -> None:
        while True:
            batch = None
            with self._cond:
                while True:
                    if self._heap and self._admit_locked(self._heap[0][3]):
                        batch = heapq.heappop(self._heap)[3]
                        self._depth[batch.cls] -= 1
                        self._queued_est -= batch.staged_est
                        slot = self._slot_free.pop()
                        batch.t_pop = time.monotonic_ns()
                        self.obs.observe_stage(
                            "transport_wait", "tpu",
                            time.perf_counter() - batch.ts)
                        break
                    if self._inflight:
                        break  # collect to free a slot / the budget
                    if self._closed and not self._heap:
                        return
                    self._cond.wait()
            if batch is not None:
                self.obs.timeline.event(
                    f"edf_pop {batch.kind}", "edf", batch.t_pop,
                    cat="transport", cls=batch.cls,
                    wait_ms=round((batch.t_pop - batch.t_enq) / 1e6, 3),
                    deadline=round(batch.eff_deadline, 6), src=batch.src)
                if self._device_down:
                    # the down latch means every device submit is doomed:
                    # queued batches skip straight to the CPU fallback
                    # instead of paying a stage + dead submit each
                    with self._cond:
                        self._slot_free.append(slot)
                        self._cond.notify_all()
                    self._absorb_on_cpu(batch, RuntimeError(
                        "device transport latched down"))
                    continue
                self._stage_and_submit(batch, slot)
                with self._cond:
                    can_pipeline = (len(self._inflight) < self.slots
                                    and self._slot_free)
                if can_pipeline:
                    continue  # double-buffer: stage N+1 while N computes
            self._collect_oldest()

    def _clear_device_stamps(self) -> None:
        """Reset the device codec's per-submit profiler stamps (adopt
        boundary, ready boundary, compile flag) so a device that stamps
        only some paths never leaks a stale boundary into the next
        batch's attribution.  Devices without the attributes (scripted
        fakes) are left untouched — their time folds into the enclosing
        stage."""
        dev = self.device
        for name, v in (("last_adopt_ns", 0), ("last_ready_ns", 0),
                        ("last_submit_compiled", False)):
            if hasattr(dev, name):
                try:
                    setattr(dev, name, v)
                except Exception:  # noqa: BLE001 — read-only fakes
                    pass

    @staticmethod
    def _clamp_stamp(raw: int, lo: int, hi: int) -> int:
        """Device-provided boundary stamp forced into its enclosing
        transport interval (0/garbage → the interval's start, so the
        whole span attributes to the outer stage)."""
        return min(max(raw or lo, lo), hi)

    def _stage_and_submit(self, batch: _Batch, slot: int) -> None:
        staged = None
        try:
            batch.t_stage0 = time.monotonic_ns()
            with self.obs.stage("host_staging", "tpu"):
                staged = self._stage(batch, slot)
            batch.t_stage1 = time.monotonic_ns()
            self._clear_device_stamps()
            with self.obs.stage("device_submit", "tpu"):
                handle = self._submit(batch, staged, slot)
            batch.t_submit1 = time.monotonic_ns()
            dev = self.device
            batch.t_adopt1 = self._clamp_stamp(
                getattr(dev, "last_adopt_ns", 0),
                batch.t_stage1, batch.t_submit1)
            batch.compiled = bool(getattr(dev, "last_submit_compiled",
                                          False))
            self.link_busy_seconds += (batch.t_submit1
                                       - batch.t_stage0) / 1e9
            tl = self.obs.timeline
            track = f"slot{slot}"
            tl.event(f"stage {batch.kind}", track, batch.t_stage0,
                     batch.t_stage1, cat="transport", cls=batch.cls,
                     blocks=batch.blocks, staged_est=batch.staged_est,
                     prefetch=batch.prefetch,
                     pool_hits=(len(batch.pool_resident)
                                if batch.pool_resident is not None
                                else None), src=batch.src)
            tl.event(f"adopt {batch.kind}", track, batch.t_stage1,
                     batch.t_adopt1, cat="transport", src=batch.src)
            tl.event(f"submit {batch.kind}", track, batch.t_adopt1,
                     batch.t_submit1, cat="transport",
                     compiled=batch.compiled, src=batch.src)
            variant = getattr(self.device, "last_submit_variant", None)
            with self._cond:
                if not self._inflight and self._busy_since is None:
                    self._busy_since = time.monotonic()
                self._inflight.append((batch, handle, variant, slot))
                self._inflight_bytes += batch.staged_est
                if self._inflight_bytes > self.max_staged_bytes_seen:
                    self.max_staged_bytes_seen = self._inflight_bytes
                self._cond.notify_all()
            tl.counter("transport_inflight", batch.t_submit1,
                       batches=len(self._inflight))
            self.dispatches += 1
            if self.m_staged is not None:
                # pool-aware staging reports the bytes that actually
                # crossed the link (miss lanes only) — a full pool hit
                # keeps transport_staged_bytes_total flat by contract
                self.m_staged.inc(
                    batch.nbytes if batch.staged_payload is None
                    else batch.staged_payload, copies="1")
        except BaseException as e:  # noqa: BLE001 — device down ≠ caller down
            self._device_failed("submit", e)
            # absorb BEFORE releasing the slot: the hash fallback reads
            # the staged rows in place, and the worker thread only
            # reuses a slot buffer after this returns
            self._absorb_on_cpu(batch, e, staged=staged)
            # an H2D copy enqueued before the failure may still read the
            # slot: drain the device before the slot can be rewritten
            self._quiesce()
            with self._cond:
                self._slot_free.append(slot)
                self._cond.notify_all()

    def _collect_oldest(self) -> None:
        with self._cond:
            if not self._inflight:
                return
            batch, handle, variant, slot = self._inflight[0]
        t_c0 = time.monotonic_ns()
        try:
            with self.obs.stage("sync_collect", "tpu"):
                results = self._collect(batch, handle)
        except BaseException as e:  # noqa: BLE001
            self._quiesce()
            self._release(batch, slot)
            note = getattr(self.device, "note_sync_failure", None)
            if note is not None and batch.kind == "scrub":
                try:
                    note(e, variant)
                except Exception:
                    logger.warning("note_sync_failure hook failed",
                                   exc_info=True)
            self._device_failed("collect", e)
            self._absorb_on_cpu(batch, e)
            return
        t_c1 = time.monotonic_ns()
        batch.t_ready = self._clamp_stamp(
            getattr(self.device, "last_ready_ns", 0),
            max(t_c0, batch.t_submit1 or t_c0), t_c1)
        self.link_busy_seconds += (t_c1 - t_c0) / 1e9
        self._release(batch, slot)
        self._device_fails = 0
        note = getattr(self.device, "note_sync_success", None)
        if note is not None and batch.kind == "scrub":
            try:
                note(variant)
            except Exception:
                logger.warning("note_sync_success hook failed",
                               exc_info=True)
        self.obs.add_bytes("tpu", batch.nbytes)
        tl = self.obs.timeline
        track = f"slot{slot}"
        if batch.t_submit1 and batch.t_ready > batch.t_submit1:
            # device-busy window: dispatch return → results ready (the
            # CUDA event wait, observed inside _collect)
            tl.event(f"compute {batch.kind}", track, batch.t_submit1,
                     batch.t_ready, cat="transport",
                     prefetch=batch.prefetch, src=batch.src)
        tl.event(f"collect {batch.kind}", track, batch.t_ready or t_c0,
                 t_c1, cat="transport", blocks=batch.blocks, src=batch.src)
        if batch.t_pool1:
            tl.event(f"pool_adopt {batch.kind}", track, batch.t_pool0,
                     batch.t_pool1, cat="transport",
                     blocks=len(batch.pool_adopt), src=batch.src)
        if batch.t_stage0:
            self.profiler.record(
                batch.kind, batch.nbytes, batch.t_stage0,
                [("stage_copy", batch.t_stage1),
                 ("adopt", batch.t_adopt1),
                 ("compile" if batch.compiled else "dispatch",
                  batch.t_submit1),
                 ("compute", batch.t_ready),
                 ("collect", t_c1)],
                want_breakdown=False)
        self._emit_request_spans(batch, t_c1)
        for part, res in zip(batch.parts, results):
            part.sink.deliver(part.index, res)

    def _emit_request_spans(self, batch: _Batch, t_end_mono: int) -> None:
        """Attribute this batch's queue wait and device round to each
        contributing REQUEST's trace (the feeder item carries its
        submitter's TraceContext + a pre-allocated parent span id) — the
        waterfall's `transport` and `device` segments come from here."""
        tracer = self.obs.tracer
        if tracer is None:
            return
        off = None
        seen = set()
        for part in batch.parts:
            it = part.item
            tctx = getattr(it, "tctx", None)
            if tctx is None or id(it) in seen:
                continue
            seen.add(id(it))
            parent = getattr(it, "span_id", None) or tctx.span_id
            if off is None:
                a = self.obs.timeline.anchor()
                off = a["wall_ns"] - a["mono_ns"]
            try:
                tracer.record_span(
                    f"Transport wait {batch.kind}", tctx.trace_id,
                    parent, batch.t_enq + off, batch.t_pop + off,
                    cls=batch.cls)
                tracer.record_span(
                    f"Device {batch.kind}", tctx.trace_id, parent,
                    batch.t_stage0 + off, t_end_mono + off,
                    blocks=batch.blocks)
            except Exception:  # noqa: BLE001 — attribution must not fail work
                logger.debug("transport span emit failed", exc_info=True)

    def _quiesce(self) -> None:
        """Wait until the device has finished everything enqueued on it,
        so no asynchronous copy still reads a slot that is about to be
        freed after a failure.  Pinned staging only: the other devices
        copy (or compute) synchronously inside submit."""
        if not self.pinned:
            return
        try:
            self.device.synchronize()
        except Exception:  # noqa: BLE001 — a dead device has nothing in flight
            logger.warning("device synchronize after a failure failed",
                           exc_info=True)

    def _release(self, batch: _Batch, slot: int) -> None:
        with self._cond:
            self._inflight.pop(0)
            self._inflight_bytes -= batch.staged_est
            self._slot_free.append(slot)
            if not self._inflight and self._busy_since is not None:
                self.device_busy_seconds += max(
                    0.0, time.monotonic() - self._busy_since)
                self._busy_since = None
            self._cond.notify_all()
        self.obs.timeline.counter(
            "transport_inflight", time.monotonic_ns(),
            batches=len(self._inflight))

    def _device_failed(self, where: str, e: BaseException) -> None:
        self._device_fails += 1
        self.device_errors += 1
        self.obs.event("transport_error", reason=where,
                       error=f"{type(e).__name__}: {e}"[:200],
                       fails=self._device_fails)
        logger.warning("device transport %s failed (%d in a row): %r",
                       where, self._device_fails, e)
        if (not self.on_card and self._device_fails >= _MAX_DEVICE_FAILS
                and not self._closed):
            self.obs.event("transport_down", reason="device_failures",
                           fails=self._device_fails)
            with self._cond:
                self._closed = True
                self._device_down = True
                self._cond.notify_all()

    # --- staging (the single host copy) -------------------------------------

    def _slot_view(self, slot: int, rows: int, cols: int) -> np.ndarray:
        """A (rows, cols) uint8 view of the slot's reusable flat staging
        buffer — grown, never shrunk, so steady-state staging allocates
        nothing.  With pinned staging the buffer is a page-locked torch
        tensor and this is a numpy view of its memory."""
        need = rows * cols
        buf = self._slot_bufs[slot]
        if buf is None or buf.size < need:
            # exact growth, not power-of-two: the staging budget bounds
            # real allocation, and the geometry is already bucketed
            if self.pinned:
                t = torch.empty((need,), dtype=torch.uint8, pin_memory=True)
                self._slot_tensors[slot] = t
                buf = t.numpy()
            else:
                buf = np.empty((need,), dtype=np.uint8)
            self._slot_bufs[slot] = buf
        return buf[:need].reshape(rows, cols)

    def pinned_bytes(self) -> int:
        """Page-locked host bytes this transport holds: its staging slots
        and the probe's staging buffer."""
        held = [t for t in self._slot_tensors if t is not None]
        if self._probe_tensor is not None:
            held.append(self._probe_tensor)
        return sum(t.numel() for t in held)

    def _device_input(self, slot: int, arr: np.ndarray):
        """What the device codec copies a staged array from: with pinned
        staging, the page-locked slot tensor itself in `arr`'s shape (so
        the codec's H2D copy is asynchronous, from memory the allocator
        knows is pinned); otherwise the numpy view."""
        if not self.pinned:
            return arr
        t = self._slot_tensors[slot]
        if arr.size and arr.ctypes.data != t.data_ptr():
            raise RuntimeError("staged array is not a prefix of its slot")
        return t[:arr.size].view(arr.shape)

    def _write_blocks(self, arr: np.ndarray, lengths: np.ndarray,
                      rows: Sequence[int], blocks: Sequence[bytes]) -> None:
        """THE host copy: each block lands once in its staging row (pad
        tail zeroed in place, no full-buffer memset).  One copy per
        block, counted."""
        cols = arr.shape[1]
        for r, b in zip(rows, blocks):
            n = len(b)
            if n:
                arr[r, :n] = np.frombuffer(b, dtype=np.uint8)
            if n < cols:
                arr[r, n:] = 0
            lengths[r] = n
        self.staged_copies += len(blocks)
        self.staged_blocks += len(blocks)
        self.staged_bytes += int(sum(len(b) for b in blocks))

    @staticmethod
    def _zero_gap_rows(arr: np.ndarray, written: Sequence[int],
                       lanes: int) -> None:
        """Zero only the staging rows NOT written this batch (entry
        lane-padding gaps + geometry pad lanes) — a reused slot buffer
        holds the previous batch's bytes, but a full memset would tax
        every staged byte with a second write pass."""
        written_set = set(written)
        lo = None
        for r in range(lanes):
            if r in written_set:
                if lo is not None:
                    arr[lo:r] = 0
                    lo = None
            elif lo is None:
                lo = r
        if lo is not None:
            arr[lo:lanes] = 0

    # SIMD-friendly staging layout (the ROADMAP CPU-floor item): hash
    # rows are placed at strides that are a multiple of this, so the
    # multi-buffer CPU hash (ops/native.py get_native_blake2s_rows) can
    # consume a staged batch IN PLACE — lane pointers into the buffer,
    # no per-row bytes materialization — when a device failure absorbs
    # the batch on the CPU.  64 B = one AVX-512 vector / cache line.
    HASH_ROW_ALIGN = 64

    def _geometry(self, nlanes: int, maxlen: int, kind: str):
        geom = getattr(self.device, "staging_geometry", None)
        lanes, cols = (geom(nlanes, maxlen, kind) if geom is not None
                       else (nlanes, maxlen))
        if kind == "hash":
            # applied INSIDE _geometry so the budget estimator and the
            # actual staging agree on the bucketed row width (device
            # power-of-two widths >= 64 are already aligned: no-op)
            cols += (-cols) % self.HASH_ROW_ALIGN
        return lanes, cols

    def _stage(self, batch: _Batch, slot: int):
        kind = batch.kind
        k = max(1, self.params.rs_data)
        if kind == "hash":
            flat: List[bytes] = []
            spans = []
            for p in batch.parts:
                blocks = p.item.payload[p.lo:p.hi]
                spans.append((len(flat), len(blocks)))
                flat.extend(blocks)
            maxlen = max((len(b) for b in flat), default=0)
            lanes, cols = self._geometry(len(flat), maxlen, kind)
            arr = self._slot_view(slot, lanes, cols)
            lengths = np.zeros((lanes,), dtype=np.int32)
            self._write_blocks(arr, lengths, range(len(flat)), flat)
            if lanes > len(flat):
                arr[len(flat):] = 0
            return arr, lengths, spans
        if kind == "scrub" and self.pool is not None:
            return self._stage_scrub_pooled(batch, slot, k)
        if kind in ("scrub", "encode"):
            # entries lane-pad to k so every part starts a fresh
            # codeword (pad lanes: zero data — and, for scrub, the
            # empty-digest expectation so they verify clean)
            rows = []
            flat = []
            hashes: List[Hash] = []
            lane = 0
            spans = []
            for p in batch.parts:
                if kind == "scrub":
                    b, h = p.item.payload
                    hashes.extend(h[p.lo:p.hi])
                    b = b[p.lo:p.hi]
                else:
                    b = p.item.payload[p.lo:p.hi]
                spans.append((lane, len(b)))
                rows.extend(range(lane, lane + len(b)))
                flat.extend(b)
                lane += len(b) + ((-len(b)) % k)
            maxlen = max((len(b) for b in flat), default=0)
            lanes, cols = self._geometry(lane, maxlen, kind)
            arr = self._slot_view(slot, lanes, cols)
            lengths = np.zeros((lanes,), dtype=np.int32)
            self._write_blocks(arr, lengths, rows, flat)
            self._zero_gap_rows(arr, rows, lanes)
            if kind == "encode":
                return arr.reshape(lanes // k, k, cols), spans
            expected = np.broadcast_to(
                _empty_digest_words(), (lanes, 8)).astype(np.uint32)
            for r, h in zip(rows, hashes):
                expected[r] = np.frombuffer(bytes(h), dtype="<u4")
            return arr, lengths, expected, spans
        # decode: shards are already arrays; staging packs the batch's
        # schedule groups contiguously (one copy per codeword row).
        # Only the first k survivor rows are staged — rs_reconstruct
        # semantics use exactly k — so the device-side slice is a view,
        # not a second copy.
        groups: dict = {}
        for pi, p in enumerate(batch.parts):
            shards, present, rws = p.item.payload
            key = (tuple(present[:k]),
                   tuple(rws) if rws is not None else None,
                   min(int(shards.shape[-2]), k))
            groups.setdefault(key, []).append(
                (pi, shards[p.lo:p.hi, :k, :]))
        plans = []
        for (present, rws, pcount), members in groups.items():
            max_s = max(sh.shape[-1] for _pi, sh in members)
            # stage at a 4-aligned width so the device's uint32 view
            # needs NO second pad copy (zero columns decode to zero
            # columns, GF-linear; per-part spans trim back at collect)
            max_s += (-max_s) % 4
            total = sum(sh.shape[0] for _pi, sh in members)
            stacked = np.zeros((total, pcount, max_s), dtype=np.uint8)
            off = 0
            spans = []
            for pi, sh in members:
                stacked[off:off + sh.shape[0], :, :sh.shape[-1]] = sh
                spans.append((pi, off, sh.shape[0], sh.shape[-1]))
                off += sh.shape[0]
                self.staged_copies += sh.shape[0]
                self.staged_blocks += sh.shape[0]
                self.staged_bytes += int(sh.nbytes)
            plans.append((stacked, list(present),
                          list(rws) if rws is not None else None, spans))
        return plans

    def _stage_scrub_pooled(self, batch: _Batch, slot: int, k: int):
        """Pool-aware scrub staging: the batch keeps its FULL lane
        geometry (k-aligned parts, lane-indexed spans/lengths/expected
        — so parity grouping and collect-side slicing are unchanged),
        but only MISS lanes pay the host copy, written compactly into
        the slot's first rows; resident lanes ship as device page
        references (zero link bytes).  Returns
        (miss_arr, miss_rows, lengths, expected, spans) for
        scrub_encode_submit_resident."""
        pool = self.pool
        lane = 0
        spans = []
        entries = []  # (lane, block, hash) in batch order
        for p in batch.parts:
            b, h = p.item.payload
            hs = h[p.lo:p.hi]
            bs = b[p.lo:p.hi]
            spans.append((lane, len(bs)))
            for i in range(len(bs)):
                entries.append((lane + i, bs[i], hs[i]))
            lane += len(bs) + ((-len(bs)) % k)
        maxlen = max((len(b) for _r, b, _h in entries), default=0)
        lanes, cols = self._geometry(lane, maxlen, "scrub")
        arr = self._slot_view(slot, lanes, cols)
        lengths = np.zeros((lanes,), dtype=np.int32)
        expected = np.broadcast_to(
            _empty_digest_words(), (lanes, 8)).astype(np.uint32)
        resident: list = []   # (lane, pages, length) composed on device
        adopt: list = []      # (lane, key, length) adopted at collect
        miss_rows: List[int] = []
        hit_bytes = miss_bytes = 0
        ci = 0
        for r, blk, hh in entries:
            n = len(blk)
            lengths[r] = n
            expected[r] = np.frombuffer(bytes(hh), dtype="<u4")
            entry = pool.lookup(bytes(hh), n)
            if entry is not None:
                resident.append((r, entry.pages, n))
                hit_bytes += n
                continue
            # THE host copy, miss lanes only (tail zeroed: the slot
            # buffer is reused and the device pads pages from it)
            if n:
                arr[ci, :n] = np.frombuffer(blk, dtype=np.uint8)
            if n < cols:
                arr[ci, n:] = 0
            miss_rows.append(r)
            adopt.append((r, bytes(hh), n))
            miss_bytes += n
            ci += 1
        self.staged_copies += ci
        self.staged_blocks += ci
        self.staged_bytes += miss_bytes
        # byte attribution: every scrubbed byte is a hit or a miss; a
        # prefetch batch's staging lands in its own family so the
        # hit+miss sum stays exactly the bytes the scrub asked for
        if not batch.prefetch:
            if hit_bytes:
                pool.note_hit(hit_bytes)
            if miss_bytes:
                pool.note_miss(miss_bytes)
        elif miss_bytes:
            pool.note_miss(miss_bytes, prefetch=True)
        batch.pool_resident = resident
        batch.pool_adopt = adopt
        batch.staged_payload = miss_bytes
        return arr[:ci], miss_rows, lengths, expected, spans

    # --- device dispatch / collect ------------------------------------------

    def _submit(self, batch: _Batch, staged, slot: int):
        kind = batch.kind
        dev = self.device
        if kind == "hash":
            arr, lengths, spans = staged
            return dev.hash_submit(self._device_input(slot, arr),
                                   lengths), spans
        if kind == "scrub":
            if batch.pool_adopt is not None:
                miss_arr, miss_rows, lengths, expected, spans = staged
                return dev.scrub_encode_submit_resident(
                    self._device_input(slot, miss_arr), miss_rows, lengths,
                    expected, batch.pool_resident), spans
            arr, lengths, expected, spans = staged
            return dev.scrub_encode_submit(self._device_input(slot, arr),
                                           lengths, expected), spans
        if kind == "encode":
            groups, spans = staged
            return dev.encode_submit(self._device_input(slot, groups)), spans
        return [(dev.decode_submit(st, present, rws), spans)
                for st, present, rws, spans in staged]

    def _collect(self, batch: _Batch, handle) -> List:
        kind = batch.kind
        dev = self.device
        if kind == "hash":
            out, spans = handle
            total = spans[-1][0] + spans[-1][1] if spans else 0
            digs = dev.hash_collect(out, total)
            return [digs[o:o + n] for o, n in spans]
        if kind == "scrub":
            out, spans = handle
            input_ref = None
            if batch.pool_adopt is not None:
                # resident submissions return (handle, composed device
                # input) — the input ref is the adoption source
                out, input_ref = out
            ok, parity = dev.scrub_collect(out, batch.want_parity)
            pool = self.pool
            if (pool is not None and batch.pool_adopt
                    and input_ref is not None):
                # adopt VERIFIED miss lanes only: a lane that failed
                # its hash check must never become a servable page
                page = pool.page_bytes
                batch.t_pool0 = time.monotonic_ns()
                with self.obs.stage("pool_adopt", "tpu"):
                    for r, key, n in batch.pool_adopt:
                        if not bool(ok[r]):
                            continue
                        try:
                            pages = dev.pool_adopt(input_ref, r, n, page)
                        except Exception:  # noqa: BLE001 — best-effort
                            logger.warning("pool adoption failed",
                                           exc_info=True)
                            break
                        pool.adopt(key, pages, n)
                batch.t_pool1 = time.monotonic_ns()
            k = max(1, self.params.rs_data)
            results = []
            for part, (o, n) in zip(batch.parts, spans):
                p_slice = None
                if (parity is not None
                        and getattr(part.item, "want_parity", True)
                        and self.params.rs_data > 0 and n):
                    blocks = part.item.payload[0][part.lo:part.hi]
                    ml = max(len(b) for b in blocks)
                    r0, nr = o // k, (n + k - 1) // k
                    p_slice = np.ascontiguousarray(
                        parity[r0:r0 + nr, :, :ml])
                results.append((ok[o:o + n], p_slice))
            return results
        if kind == "encode":
            out, spans = handle
            parity = np.asarray(dev.encode_collect(out)
                                if hasattr(dev, "encode_collect") else out)
            k = max(1, self.params.rs_data)
            results = []
            for part, (o, n) in zip(batch.parts, spans):
                blocks = part.item.payload[part.lo:part.hi]
                ml = max(len(b) for b in blocks)
                r0, nr = o // k, (n + k - 1) // k
                results.append(np.ascontiguousarray(
                    parity[r0:r0 + nr, :, :ml]))
            return results
        # decode
        results: List = [None] * len(batch.parts)
        dcoll = getattr(dev, "decode_collect", None)
        for out, spans in handle:
            dec = np.asarray(dcoll(out) if dcoll is not None else out)
            for pi, off, nrows, s in spans:
                results[pi] = np.ascontiguousarray(
                    dec[off:off + nrows, ..., :s])
        return results

    # --- CPU absorption of device failures ----------------------------------

    def _absorb_on_cpu(self, batch: _Batch, cause: BaseException,
                       staged=None) -> None:
        """A failed device batch degrades to an inline CPU computation —
        zero caller-visible errors — unless no fallback codec exists or
        the device is a CUDA card: then every part fails with `cause`.
        A hash batch that already reached staging is consumed IN PLACE
        (`staged`): the rows sit at lane-aligned strides, so the
        multi-buffer CPU hash runs straight over the staging buffer
        instead of re-reading the original payloads."""
        cpu = self.fallback
        if cpu is None or self.on_card:
            for part in batch.parts:
                part.sink.fail(cause)
            return
        self.fallbacks += 1
        self.obs.event("transport_fallback", reason=batch.kind,
                       blocks=batch.blocks)
        if batch.kind == "hash" and staged is not None:
            if self._absorb_hash_staged(batch, staged):
                return
        for part in batch.parts:
            it = part.item
            try:
                if batch.kind == "hash":
                    blocks = it.payload[part.lo:part.hi]
                    res = cpu.batch_hash(blocks)
                    nbytes = sum(len(b) for b in blocks)
                elif batch.kind == "scrub":
                    b, h = it.payload
                    blocks = b[part.lo:part.hi]
                    res = cpu.scrub_encode_batch(
                        blocks, h[part.lo:part.hi],
                        getattr(it, "want_parity", True))
                    nbytes = sum(len(x) for x in blocks)
                elif batch.kind == "encode":
                    blocks = it.payload[part.lo:part.hi]
                    res = cpu.rs_encode_blocks(blocks)
                    nbytes = sum(len(b) for b in blocks)
                else:
                    shards, present, rws = it.payload
                    sub = shards[part.lo:part.hi]
                    res = cpu.rs_reconstruct(sub, present, rws)
                    nbytes = int(sub.nbytes)
                self.obs.add_bytes("cpu", nbytes)
                part.sink.deliver(part.index, res)
            except BaseException as e:  # noqa: BLE001
                part.sink.fail(e)

    def _absorb_hash_staged(self, batch: _Batch, staged) -> bool:
        """Hash a staged batch's rows in place (SIMD-friendly staging
        layout: lane-aligned strides, zero re-copies).  Returns False on
        any surprise so the caller's payload-based fallback runs."""
        try:
            arr, lengths, spans = staged
            total = spans[-1][0] + spans[-1][1] if spans else 0
            from .native import get_native_blake2s_rows

            rows_fn = get_native_blake2s_rows()
            if rows_fn is not None:
                raw = rows_fn(arr, lengths, total)
            else:
                import hashlib

                # row views of a C-contiguous matrix are zero-copy too —
                # just one lane at a time instead of 8/16
                raw = [
                    hashlib.blake2s(arr[r, :int(lengths[r])],
                                    digest_size=32).digest()
                    for r in range(total)
                ]
            digs = [Hash(d) for d in raw]
            for part, (o, n) in zip(batch.parts, spans):
                self.obs.add_bytes(
                    "cpu", int(sum(int(x) for x in lengths[o:o + n])))
                part.sink.deliver(part.index, digs[o:o + n])
            return True
        except BaseException:  # noqa: BLE001 — fall back to payloads
            logger.warning("in-place staged hash fallback failed",
                           exc_info=True)
            return False

    # --- pool prefetch / residency ------------------------------------------

    def prefetch(self, blocks: Sequence[bytes],
                 hashes: Sequence[Hash]) -> int:
        """Stage the upcoming scrub range into the device pool as
        BACKGROUND-class work: the scrub worker hints the next read-
        ahead batch and its non-resident blocks ride the staging
        double buffer (under the governor's demotion slack) while the
        current batch computes — so by the time the real scrub batch
        arrives, its lanes are pool hits.  Results are discarded; the
        staging is attributed to pool_prefetch_bytes_total.  Returns
        the bytes enqueued (0 = already resident / pool or prefetch
        disabled / transport closed)."""
        pool = self.pool
        if (pool is None or not pool.prefetch_enabled or self._closed
                or not self.supports("scrub")):
            return 0
        todo_b: List[bytes] = []
        todo_h: List[Hash] = []
        for b, h in zip(blocks, hashes):
            if not pool.contains(bytes(h)):
                todo_b.append(b)
                todo_h.append(h)
        if not todo_b:
            return 0
        nbytes = int(sum(len(b) for b in todo_b))
        src = current_src()
        it = TransportItem("scrub", (todo_b, todo_h), len(todo_b),
                           nbytes, cls="bg", want_parity=False,
                           prefetch=True,
                           src=src.id if src is not None else None)
        it.future.add_done_callback(_swallow_result)
        try:
            self.submit_items("scrub", [it], want_parity=False)
        except TransportClosed:
            return 0
        self.obs.timeline.event(
            "pool_prefetch", "edf", time.monotonic_ns(),
            cat="transport", blocks=len(todo_b), nbytes=nbytes,
            src=[it.src] if it.src is not None else [])
        return nbytes

    def pool_covers(self, items: Sequence) -> bool:
        """Would the pool serve every block of these scrub items with
        zero link bytes?  The feeder's gate-refresh short-circuit: a
        fully-resident background batch needs no link probe because it
        will not touch the link."""
        pool = self.pool
        if pool is None:
            return False
        keys: List[bytes] = []
        for it in items:
            if getattr(it, "kind", None) != "scrub":
                return False
            _b, hs = it.payload
            keys.extend(bytes(h) for h in hs)
        return pool.contains_all(keys)

    # --- the gate's probe ---------------------------------------------------

    def probe_link(self, nbytes: int) -> float:
        """Measured round-trip rate (GiB/s) of THIS path: `nbytes`
        staged (the single host copy) and adopted/transferred through
        the device's probe op — a trivial reduction whose scalar result
        DEPENDS on the upload, so the measurement is transfer-bound
        like the retired serialize+copy probe but priced on the new
        staging path.  The first call warms the probe executable
        outside the timed region.  Raises when the device lacks
        probe_submit (the hybrid then falls back to its own probe)."""
        dev = self.device
        if not hasattr(dev, "probe_submit"):
            raise TransportClosed("device lacks probe_submit")
        with self._probe_lock:
            if self._probe_buf is None or self._probe_buf.size < nbytes:
                self._probe_buf = np.random.default_rng(0).integers(
                    0, 256, (nbytes,), dtype=np.uint8)
            src = self._probe_buf[:nbytes]
            if (self._probe_staging is None
                    or self._probe_staging.size < nbytes):
                if self.pinned:
                    self._probe_tensor = torch.empty(
                        (nbytes,), dtype=torch.uint8, pin_memory=True)
                    self._probe_staging = self._probe_tensor.numpy()
                else:
                    self._probe_staging = np.empty((nbytes,), dtype=np.uint8)
            staging = self._probe_staging[:nbytes]
            # the probe prices the same path a batch takes: pinned
            # staging hands the device the page-locked tensor
            probe_in = (self._probe_tensor[:nbytes] if self.pinned
                        else staging)

            def roundtrip():
                """One probed round trip, decomposed with the same
                stage taxonomy (and exact-sum guarantee) as a real
                batch: the staging-buffer refill is priced — and now
                VISIBLE — as stage_copy bytes instead of folding into
                adopt time."""
                self._clear_device_stamps()
                t0 = time.monotonic_ns()
                staging[:] = src          # the one host copy, priced in
                t_copy = time.monotonic_ns()
                handle = dev.probe_submit(probe_in)
                t_sub = time.monotonic_ns()
                collect = getattr(dev, "probe_collect",
                                  lambda h: int(np.asarray(h)))
                collect(handle)
                t_end = time.monotonic_ns()
                t_adopt = self._clamp_stamp(
                    getattr(dev, "last_adopt_ns", 0), t_copy, t_sub)
                t_ready = self._clamp_stamp(
                    getattr(dev, "last_ready_ns", 0), t_sub, t_end)
                compiled = bool(getattr(dev, "last_submit_compiled",
                                        False))
                stages = self.profiler.record(
                    "probe", nbytes, t0,
                    [("stage_copy", t_copy), ("adopt", t_adopt),
                     ("compile" if compiled else "dispatch", t_sub),
                     ("compute", t_ready), ("collect", t_end)])
                return (t_end - t0) / 1e9, stages

            if not self._probe_warmed:
                # warm round: the probe executable's compile lands here,
                # recorded (as `compile`) but excluded from the rate
                roundtrip()
                self._probe_warmed = True
            dt, stages = roundtrip()
            rate = nbytes / dt / 2**30 if dt > 0 else 0.0
            self.last_probe_stages = {k: round(v, 6)
                                      for k, v in stages.items()}
            from .link_profiler import dominant_stage

            self.obs.event("transport_probe", reason="ok",
                           gibs=round(rate, 4),
                           dominant_stage=dominant_stage(stages),
                           stage_copy_bytes=nbytes,
                           stages=self.last_probe_stages)
            return rate

    # --- lifecycle / introspection ------------------------------------------

    def copies_per_block(self) -> float:
        return (self.staged_copies / self.staged_blocks
                if self.staged_blocks else 0.0)

    def stats(self) -> dict:
        with self._cond:
            return {
                "alive": not self._closed,
                "queue_depth": dict(self._depth),
                "inflight": len(self._inflight),
                "inflight_bytes": self._inflight_bytes,
                "staged_bytes": self.staged_bytes,
                "staged_blocks": self.staged_blocks,
                "staged_copies": self.staged_copies,
                "copies_per_block": round(self.copies_per_block(), 4),
                "dispatches": self.dispatches,
                "chunks_split": self.chunks_split,
                "fallbacks": self.fallbacks,
                "device_errors": self.device_errors,
                "max_staged_bytes_seen": self.max_staged_bytes_seen,
                "staging_slots": self.slots,
                "pinned": self.pinned,
                "pinned_bytes": self.pinned_bytes(),
                "on_card": self.on_card,
                "chunk_bytes": self.chunk_bytes,
                "budget_bytes": self.budget_bytes,
                "device_busy_seconds": round(self.device_busy_now(), 6),
                "link_busy_seconds": round(self.link_busy_seconds, 6),
                "queue_saturation": round(
                    (self._queued_est + self._inflight_bytes)
                    / self.budget_bytes, 6),
                "stages": self.profiler.summary(),
                "probe_stages": self.last_probe_stages,
                "pool": (self.pool.stats() if self.pool is not None
                         else None),
            }

    def shutdown(self, timeout: float = 15.0) -> None:
        """Refuse new submissions, drain everything already queued (the
        feeder's drain contract: accepted work is never dropped)."""
        with self._cond:
            already = self._closed
            self._closed = True
            t = self._thread
            self._cond.notify_all()
        if not already:
            self.obs.event("transport_drain", reason="shutdown")
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                logger.warning(
                    "device transport drain did not finish within %.1fs",
                    timeout)
