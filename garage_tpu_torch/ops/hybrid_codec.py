"""Hybrid BlockCodec — adaptive host+device scrub with work stealing.

Why this exists.  A device codec's throughput is capped by the
host→device link: the sustained transfer rate can drop to the same
order as — or below — one CPU core's hashing rate, and it varies over
time (shared hosts, other tenants of the link).  Statically routing all scrub
work to either backend therefore leaves throughput on the floor.  The
hybrid codec runs BOTH: the caller's thread drives the CPU codec (the
guaranteed floor — hashlib + the native GF kernel), while a feeder thread
streams groups to the device codec, keeping a bounded in-flight window.
Work distribution is a classic stealing deque — CPU pulls groups from the
left, the device from the right — so the split adapts to whatever rate
each side actually sustains, with no rate model to mistune:

  total throughput ≈ cpu_rate + min(link_rate, device_rate)

and the device is never on the critical path: at the tail of a pass the
CPU *hedges* — after a short grace period it recomputes the groups the
device still holds in flight, first writer wins, and the feeder thread is
left to drain its transfers in the background rather than joined.  A
stalled link therefore costs at most one grace period, not a sync.

Upstream Garage has no equivalent — its scrub is a strictly sequential
per-block CPU loop (ref src/block/repair.rs:438-490, block.rs:66-78
verify).

The device side is a CudaCodec on the GPU ("cuda", the default; a
failure to build it raises) or on the CPU ("cpu", the kernels' plain
versions, for tests).  The CodecFeeder's batches reach it through the
DeviceTransport (pinned, double-buffered staging) and the DevicePool.
On a CUDA card a device failure — kernel build, warm-up, link probe,
submit or collect — raises to the caller: the CPU side never absorbs the
device's work, and the tail hedge never races a failed device.

Semantics are those of BlockCodec: results are bit-identical whichever
backend processed a group (tests/test_torch_hybrid.py).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.data import Hash
from .codec import BlockCodec, CodecParams
from .cpu_codec import CpuCodec
from .sharded import to_host
from .transport import on_card

logger = logging.getLogger("garage_tpu_torch.ops.hybrid")

# Feeders are daemon threads (a stalled device link must never wedge
# process exit), but exiting the interpreter while one is blocked inside a
# device transfer can abort the process from C++ (the CUDA runtime is torn
# down under it).  Track live feeders and give them a bounded drain at
# exit.
_LIVE_FEEDERS: "collections.deque[threading.Thread]" = collections.deque()
_FEEDER_EXIT_GRACE_S = 15.0


def _drain_feeders_at_exit() -> None:
    deadline = time.monotonic() + _FEEDER_EXIT_GRACE_S
    while _LIVE_FEEDERS:
        t = _LIVE_FEEDERS.popleft()
        t.join(timeout=max(0.0, deadline - time.monotonic()))


import atexit  # noqa: E402  (registration belongs right next to the state)

atexit.register(_drain_feeders_at_exit)


def _to_host(x) -> np.ndarray:
    """A device result as a numpy array: a CudaCodec result, its shards'
    torch tensors, is copied to the host in lane order, which waits for
    the kernels that produce it; anything else (the synthetic link's lazy
    handles) through np.asarray."""
    if isinstance(x, list):
        return to_host(x)
    return np.asarray(x)


class HybridCodec(BlockCodec):
    """CPU floor + opportunistic device offload, per-group work stealing."""

    def __init__(self, params: CodecParams,
                 device_codec: Optional[BlockCodec] = None,
                 build_device: bool = True, device="cuda", devices=None,
                 metrics=None, tracer=None):
        """build_device: True builds a CudaCodec on `device` now ("cuda",
        the default, raises without a GPU; "cpu" runs the kernels' plain
        versions), split over `devices` when ``params.shard_mesh > 1``
        (CudaCodec's rule); False never builds one — the pure CPU floor.
        A given `device_codec` (a test backend) is used as it is.

        metrics/tracer: the System-owned MetricsRegistry/Tracer — stage
        histograms, bytes-by-side counters, and the gate-decision event
        ring become node-visible (/metrics + admin `codec info`)."""
        super().__init__(params, metrics=metrics, tracer=tracer)
        # the inner CPU codec gets NO observer plumbing: the hybrid does
        # all byte/stage accounting itself (first-writer-wins makes the
        # inner codec's view double-count hedged groups)
        self.cpu = CpuCodec(params)
        self.tpu = device_codec
        self.device = device
        self.devices = devices
        # group = the stealing quantum; must be k-aligned so each group's
        # parity layout is self-contained (k=0: replication-only config, no
        # RS — groups need no alignment and scrub is verify-only)
        k = max(1, params.rs_data)
        g = max(params.hybrid_group_blocks, k)
        self.group_blocks = g - (g % k)
        self.window = max(1, params.hybrid_window)
        # Device submission width: the feeder MERGES consecutive deque
        # groups up to this many blocks per scrub_submit.  The device
        # BLAKE2s runs one thread per block, so its rate is a strong
        # function of batch width — submitting the CPU-cache-sized
        # 16-block stealing quantum directly would leave most of the
        # card idle.  Decoupled from batch_blocks (host staging
        # granularity).
        self.device_batch_blocks = max(self.group_blocks,
                                       params.device_batch_blocks)
        # Staging-claim clamp: (window+1) merged
        # submissions × device_batch_blocks × block_size is host RAM +
        # device HBM held at once — 2 GiB at the defaults.  Clamp the
        # submission width so the bound never exceeds
        # max_device_staging_mib at the CONFIGURED block size (the
        # daemon plumbs config.block_size in; 1 MiB default); the event
        # makes a silently narrower device pipeline attributable.
        blk = max(1, params.block_size)
        cap = max(
            self.group_blocks,
            (params.max_device_staging_mib << 20)
            // ((self.window + 1) * blk),
        )
        if self.device_batch_blocks > cap:
            logger.warning(
                "clamping device_batch_blocks %d -> %d: "
                "(hybrid_window+1)=%d in-flight submissions of %d-byte "
                "blocks would stage %d MiB (> max_device_staging_mib=%d)",
                self.device_batch_blocks, cap, self.window + 1, blk,
                (self.window + 1) * self.device_batch_blocks * blk >> 20,
                params.max_device_staging_mib,
            )
            self.obs.event(
                "staging_clamp", reason="max_device_staging_mib",
                requested=self.device_batch_blocks, clamped=cap,
                window=self.window, block_size=blk,
            )
            self.device_batch_blocks = cap
        # CPU-side merged span while the device is actively stealing;
        # unbounded (whole contiguous segments) when the device is gated
        # or absent — the pass then degenerates to exactly the wide
        # fused CPU codec calls (a held gate must cost nothing vs the
        # plain CPU path).
        self.cpu_span_blocks = max(self.group_blocks,
                                   params.hybrid_cpu_span_blocks)
        # link-health probe cache (see _probe_link)
        self._link_rate: Optional[float] = None
        self._link_ts = 0.0
        self._link_failed = False
        self._link_ttl = self._LINK_PROBE_TTL_S
        self._fail_ttl = self._LINK_PROBE_FAIL_TTL_S
        self._probe_buf: Optional[np.ndarray] = None
        self._probe_warmed = False
        self._probe_lock = threading.Lock()
        # the zero-copy device transport (ops/transport.py): armed when
        # the device codec speaks the array-level transport API; the
        # CodecFeeder routes device-side ragged batches through it, and
        # the gate probe measures IT instead of the retired
        # serialize+copy path
        self.transport = None
        # the device-resident block pool behind the transport (built by
        # _arm_transport when budgeted); BlockManager's invalidation
        # hooks and the scrub worker's cycle tick reach it here
        self.pool = None
        self._metrics = metrics
        self._governor_ratio = None
        # accounting (read by bench.py and the admin worker registry)
        self.bytes_cpu = 0
        self.bytes_tpu = 0
        # gate telemetry for the last pass: bench.py records the probe
        # rate and the gate decision next to tpu_frac so a 0.0 frac is
        # attributable
        self.last_link_gibs: Optional[float] = None
        self.last_gate: Optional[str] = None
        # per-stage breakdown of the last successful probe ({stage:
        # seconds}): attached to every probe/gate event so a
        # verdict — including a gate-shut one — names WHERE the
        # round-trip went, not just how slow it was
        self._link_stages: Optional[dict] = None
        self._stats_lock = threading.Lock()
        # NOTE: the codec-level gauges (codec_device_attached,
        # codec_link_gibs, codec_tpu_frac) are registered by
        # BlockManager against self.codec — per-instance fn= observers
        # here would pin this instance in the registry forever and go
        # stale on a codec swap (Gauge dedup keeps the FIRST observer).
        if self.tpu is None and build_device:
            self._build_device()
        elif self.tpu is not None:
            self._arm_transport()

    def _arm_transport(self) -> None:
        """Build the DeviceTransport over the attached device codec when
        enabled and the device speaks the array-level transport API
        (scripted test fakes without it keep the legacy ragged
        routing)."""
        if not getattr(self.params, "transport", True) or self.tpu is None:
            return
        from .transport import DeviceTransport

        if not DeviceTransport.supports_device(self.tpu):
            return
        # device-resident block pool (ops/device_pool.py): armed when
        # budgeted and the device speaks the pool API; pool_mib=0 or a
        # pool-less device keeps staging byte-identical to the legacy
        # transport
        from .device_pool import DevicePool

        pool = None
        pool_mib = int(getattr(self.params, "pool_mib", 0))
        if pool_mib > 0 and DevicePool.supports_device(self.tpu):
            pool = DevicePool(
                self.tpu,
                pool_bytes=pool_mib << 20,
                page_bytes=int(getattr(self.params, "pool_page_kib",
                                       256)) << 10,
                prefetch=bool(getattr(self.params, "pool_prefetch",
                                      True)),
                metrics=self._metrics, observer=self.obs)
        self.pool = pool
        tr = DeviceTransport(self.tpu, self.params, fallback=self.cpu,
                             observer=self.obs, metrics=self._metrics,
                             pool=pool)
        tr.governor_ratio = self._governor_ratio
        self.transport = tr  # atomic attach (feeder reads it racily)
        self.obs.event("transport_up", reason=type(self.tpu).__name__,
                       slots=tr.slots,
                       pool_mib=pool_mib if pool is not None else 0)

    def set_governor(self, ratio_fn) -> None:
        """Wire the load governor's background_throttle_ratio into the
        transport's background demotion (model/garage.py); survives a
        late async device attach."""
        self._governor_ratio = ratio_fn
        if self.transport is not None:
            self.transport.governor_ratio = ratio_fn

    def _build_device(self) -> None:
        """Build the CudaCodec on self.device, build its kernels and arm
        the transport.  A failure is recorded in the event ring and
        raised: the caller asked for the device, and a silent CPU-only
        hybrid would hide it."""
        from .cuda_codec import CudaCodec

        try:
            # the device codec SHARES this hybrid's observer: its
            # sync failures land in the same event ring as gate decisions
            dev = CudaCodec(self.params, device=self.device,
                            devices=self.devices, observer=self.obs)
            # CudaCodec builds its kernels lazily; build them here so a
            # failing nvcc raises now, not as a gate that never opens
            dev.warm_scrub(1, self.params.block_size)
            self.tpu = dev
        except Exception as e:
            self.obs.event("device_attach", reason="failed",
                           error=f"{type(e).__name__}: {e}"[:200])
            raise
        self.obs.event("device_attach", reason="ok")
        self._arm_transport()

    def info(self) -> dict:
        d = super().info()
        with self._stats_lock:
            d.update({
                "device_attached": self.tpu is not None,
                "device_backend": (type(self.tpu).__name__
                                   if self.tpu is not None else None),
                "gate": self.last_gate,
                "link_gibs": self.last_link_gibs,
                "link_stages": (dict(self._link_stages)
                                if self._link_stages else None),
                "group_blocks": self.group_blocks,
                "device_batch_blocks": self.device_batch_blocks,
                "window": self.window,
            })
        if self.tpu is not None and hasattr(self.tpu, "device_info"):
            d.update(self.tpu.device_info())
        if self.transport is not None:
            d["transport"] = self.transport.stats()
        if self.pool is not None:
            d["pool"] = self.pool.stats()
        return d

    def close(self) -> None:
        """Drain the device transport (shutdown path; idempotent)."""
        if self.transport is not None:
            self.transport.shutdown()
        if self.pool is not None:
            self.pool.clear()

    def pop_stats(self) -> Tuple[int, int]:
        with self._stats_lock:
            s = (self.bytes_cpu, self.bytes_tpu)
            self.bytes_cpu = self.bytes_tpu = 0
        return s

    def warm(self, nbytes: int) -> None:
        """Build the device kernels before the first pass for
        `nbytes`-sized blocks, without spending link bandwidth."""
        if self.tpu is not None and hasattr(self.tpu, "warm_scrub"):
            try:
                # every POWER-OF-TWO lane bucket from the smallest batch
                # (width 1 pads into it) up to device_batch_blocks:
                # shallow-deque and pass-tail merges dispatch at any
                # intermediate bucket, not just the ramp widths.  Dedupe
                # on the device's own padded batch size.
                seen = set()
                w = 1
                while True:
                    key = (self.tpu._batch_size(w)
                           if hasattr(self.tpu, "_batch_size") else w)
                    if key not in seen:
                        seen.add(key)
                        self.tpu.warm_scrub(w, nbytes)
                    if w >= self.device_batch_blocks:
                        break
                    w = min(w * 2, self.device_batch_blocks)
            except Exception:
                if on_card(self.tpu):
                    raise
                logger.warning("device warmup failed", exc_info=True)

    _LINK_PROBE_TTL_S = 15.0
    _LINK_PROBE_FAIL_TTL_S = 2.0
    _LINK_PROBE_TTL_MAX_S = 120.0
    _LINK_PROBE_BYTES = 16 << 20

    def _probe_once(self) -> Tuple[float, bool]:
        """(rate GiB/s, failed?) from one real round-trip without a
        transport: the device codec's probe_submit uploads a 16 MiB
        buffer and reduces it to a scalar, and probe_collect fetches that
        scalar — a value that DEPENDS on every uploaded byte, so the
        measurement cannot finish before the transfer has."""
        try:
            dev = self.tpu
            if self._probe_buf is None:
                self._probe_buf = np.random.default_rng(0).integers(
                    0, 256, (self._LINK_PROBE_BYTES,), dtype=np.uint8)

            def roundtrip() -> int:
                return dev.probe_collect(dev.probe_submit(self._probe_buf))

            if not self._probe_warmed:
                # the first call builds the kernels' libraries and warms
                # the allocator — keep that out of the timed region or a
                # healthy link reads as gated for the whole first TTL
                roundtrip()
                self._probe_warmed = True
            t0 = time.monotonic()
            roundtrip()
            dt = time.monotonic() - t0
            return (self._LINK_PROBE_BYTES / dt / 2**30 if dt > 0 else 0.0,
                    False)
        except Exception:
            if on_card(self.tpu):
                raise
            logger.warning("device link probe failed", exc_info=True)
            return 0.0, True

    def _probe_link(self) -> float:
        """Measured host→device round-trip rate (GiB/s), cached.

        With a transport armed, the probe measures the NEW path — one
        ragged submission through stage→submit→collect
        (DeviceTransport.probe_link) — not the retired serialize+copy
        round-trip, so the gate decides on the rate the feeder's
        batches will actually see.  A device codec's own `probe_link`
        hook still wins (the synthetic-link backend keeps gate
        decisions deterministic); real codecs are marked by warm_scrub;
        anything else (scripted test fakes) is treated as healthy.

        Cache policy: a FAILED probe is retried once immediately and,
        if still failing, re-probed on a doubling ladder
        (_LINK_PROBE_FAIL_TTL_S → _LINK_PROBE_TTL_MAX_S) — a
        durably-dead backend isn't hammered every pass.  A probe that
        SUCCEEDS — even below the gate threshold — caches for exactly
        _LINK_PROBE_TTL_S and resets the failure ladder, so a
        once-failed or once-slow link that recovers is re-probed (and
        the gate re-opened) within one healthy TTL.  The old policy
        doubled the TTL on below-threshold measurements too, which left
        a recovered link gated for up to _LINK_PROBE_TTL_MAX_S.  The
        flat healthy cadence costs nothing when probing is cheap (a
        transport probe or a device hook); only the LEGACY
        _probe_once path — a full 16 MiB round-trip over a possibly
        metered link — keeps the below-threshold backoff ladder."""
        hook = getattr(self.tpu, "probe_link", None)
        hook_owner = self.tpu if hook is not None else None
        tr = self.transport
        if hook is None and tr is not None and tr.alive:
            hook = tr.probe_link
            hook_owner = tr
        legacy = hook is None
        if legacy and not hasattr(self.tpu, "warm_scrub"):
            return float("inf")
        with self._probe_lock:
            now = time.monotonic()
            if self._link_rate is not None:
                ttl = (self._fail_ttl if self._link_failed
                       else self._link_ttl)
                if now - self._link_ts < ttl:
                    return self._link_rate
            if hook is not None:
                try:
                    rate, failed = float(hook(self._LINK_PROBE_BYTES)), False
                    stages = getattr(hook_owner, "last_probe_stages",
                                     None)
                    if stages:
                        self._link_stages = dict(stages)
                except Exception:
                    if on_card(self.tpu):
                        raise
                    logger.warning("probe_link hook failed", exc_info=True)
                    rate, failed = 0.0, True
                    self._link_stages = None
            else:
                rate, failed = self._probe_once()
                if failed:
                    rate, failed = self._probe_once()
            if failed:
                self._fail_ttl = min(self._fail_ttl * 2,
                                     self._LINK_PROBE_TTL_MAX_S)
            elif legacy and rate < self.params.hybrid_min_link_gibs:
                # the probe itself spends metered link quota here:
                # back a below-threshold verdict off as before
                self._fail_ttl = self._LINK_PROBE_FAIL_TTL_S
                self._link_ttl = min(self._link_ttl * 2,
                                     self._LINK_PROBE_TTL_MAX_S)
            else:
                self._fail_ttl = self._LINK_PROBE_FAIL_TTL_S
                self._link_ttl = self._LINK_PROBE_TTL_S
            self._link_failed = failed
            self._link_rate, self._link_ts = rate, now
            return rate

    def probe_stages(self) -> Optional[dict]:
        """{stage: seconds} of the last successful probe (None when no
        decomposed probe has run — the legacy serialize+copy probe and
        scripted fakes don't stamp stages).  A CACHED verdict reuses the
        breakdown of the measurement that produced it."""
        with self._probe_lock:
            return dict(self._link_stages) if self._link_stages else None

    @staticmethod
    def _stage_detail(stages: Optional[dict]) -> dict:
        """Event-detail kwargs for a probe breakdown: the {stage:
        seconds} map plus its dominant stage (empty when unknown)."""
        if not stages:
            return {}
        from .link_profiler import dominant_stage

        return {"stages": {k: round(v, 6) for k, v in stages.items()},
                "dominant_stage": dominant_stage(stages)}

    def _ramp_widths(self) -> List[int]:
        """Device submission widths the feeder ramps through: start small
        (claims are cheap to hedge while the link's latency is unproven),
        double per successful collect up to device_batch_blocks."""
        w = max(self.group_blocks, min(64, self.device_batch_blocks))
        out = [w]
        while w < self.device_batch_blocks:
            w = min(w * 2, self.device_batch_blocks)
            out.append(w)
        return out

    # --- the hybrid engine ---

    def _run_groups(self, blocks: Sequence[bytes], hashes: Sequence[Hash],
                    compute_parity: bool, fetch_parity: bool,
                    cuts: Optional[Sequence[int]] = None):
        """Split into k-aligned groups, process them on both backends via a
        stealing deque, return per-group (ok, parity|None) in order.

        compute_parity: whether the CPU side runs the RS encode at all (the
        device kernel is fused and always encodes — one executable for both
        the verify-only and scrub paths).  fetch_parity: whether device-side
        parity is copied back to host RAM (skipping the copy spares
        device→host bandwidth for callers that discard parity).  cuts:
        extra boundaries (block indices) no group may straddle — scrub_many
        passes its batch edges so no RS codeword ever mixes two batches."""
        n = len(blocks)
        g = self.group_blocks
        starts: List[int] = []
        edges = sorted(set([0, n] + list(cuts or [])))
        for lo, hi in zip(edges, edges[1:]):
            starts.extend(range(lo, hi, g))
        groups = [
            (i, blocks[i:j], hashes[i:j])
            for i, j in zip(starts, starts[1:] + [n])
        ]
        if self.params.rs_data == 0:
            compute_parity = False  # replication-only config: verify-only
            fetch_parity = False
        results: List[Optional[Tuple[np.ndarray, Optional[np.ndarray]]]] = (
            [None] * len(groups)
        )
        # rs_data == 0 routes to CPU: the device path is the fused
        # verify+encode executable, which needs the RS matrix
        use_device = (self.tpu is not None and len(groups) > 1
                      and self.params.rs_data > 0)
        with self._stats_lock:
            self.last_gate = None if use_device else (
                "no-device" if self.tpu is None else "cpu-only")
            if not use_device:
                self.last_link_gibs = None
        if not use_device:
            self.obs.event("gate", reason=self.last_gate,
                           groups=len(groups))

        dq = collections.deque(range(len(groups)))
        lock = threading.Lock()
        done = threading.Event()
        # set when the feeder will take no (more) work — probe gate held,
        # feeder failed/ceded, or feeder finished; the CPU side then
        # merges UNBOUNDED spans (one fused call per contiguous run),
        # making a gated pass cost the same as the plain CPU codec
        gate_hold = threading.Event()
        if not use_device:
            gate_hold.set()
        remaining = [len(groups)]

        def set_result(gi, val, side, nbytes) -> bool:
            """First writer wins (the tail is hedged: CPU may redo a group
            the device still has in flight).  Byte accounting happens under
            the same lock as the winning write, so pop_stats() called right
            after the pass always sees cpu+tpu == total."""
            with lock:
                if results[gi] is not None:
                    return False
                results[gi] = val
                with self._stats_lock:
                    if side == "cpu":
                        self.bytes_cpu += nbytes
                    else:
                        self.bytes_tpu += nbytes
                self.obs.add_bytes(side, nbytes)
                remaining[0] -= 1
                if remaining[0] == 0:
                    done.set()
                return True

        cpu_t0 = time.monotonic()
        cpu_bytes_this_call = [0]
        # a card's failure is the caller's: collected here, raised once
        # the device thread has ended (never absorbed by the CPU side)
        card = use_device and on_card(self.tpu)
        dev_err: List[BaseException] = []

        k_align = max(1, self.params.rs_data)

        def feeder():
            # Device side: pop from the RIGHT and MERGE consecutive
            # groups into one wide submission (device_batch_blocks lanes
            # — the hash kernel's rate scales with lane count).  Because
            # only the ends of the deque are ever popped, the remaining
            # indices form one contiguous range, so right-side pops are
            # strictly descending adjacent groups; prepending each keeps
            # the merged list ascending and block-contiguous.  Parity
            # grouping is preserved iff every merged group except the
            # LAST is k-aligned (group starts then stay multiples of k),
            # so a non-aligned group — only ever a batch-segment tail —
            # is carried over to START the next merged list, where it
            # again sits last.  Keep ≤ window submissions in flight; sync
            # oldest before submitting past the window.
            inflight: collections.deque = collections.deque()
            ramp = self._ramp_widths()
            ramp_i = 0
            carry: Optional[int] = None
            try:
                # Gate on measured link health BEFORE claiming any work:
                # a sub-threshold link costs more in staging + tail-hedge
                # redo than it contributes (and learning that from the
                # first real collect can take tens of seconds).
                with self.obs.stage("probe", "tpu"):
                    rate = self._probe_link()
                stage_detail = self._stage_detail(self.probe_stages())
                with self._stats_lock:
                    self.last_link_gibs = (
                        None if rate == float("inf") else round(rate, 4))
                self.obs.event(
                    "probe",
                    reason="unmetered" if rate == float("inf") else "ok",
                    gibs=None if rate == float("inf") else round(rate, 4),
                    threshold=self.params.hybrid_min_link_gibs,
                    **stage_detail)
                if rate < self.params.hybrid_min_link_gibs:
                    with self._stats_lock:
                        self.last_gate = "hold"
                    self.obs.event(
                        "gate", reason="hold", gibs=round(rate, 4),
                        threshold=self.params.hybrid_min_link_gibs,
                        **stage_detail)
                    logger.info(
                        "hybrid feeder: link probe %.3f GiB/s below "
                        "threshold %.3f — CPU-only this pass "
                        "(dominant stage: %s)",
                        rate, self.params.hybrid_min_link_gibs,
                        stage_detail.get("dominant_stage", "unknown"))
                    return
                with self._stats_lock:
                    self.last_gate = "open"
                self.obs.event(
                    "gate", reason="open",
                    gibs=None if rate == float("inf") else round(rate, 4),
                    **stage_detail)
                while True:
                    # width ramp: early submissions are small (cheap for
                    # the tail hedge to redo if the link turns out slow);
                    # each successful collect doubles the width up to
                    # device_batch_blocks, where the device hash kernel
                    # has full lane utilization
                    target = ramp[min(ramp_i, len(ramp) - 1)]
                    merged: List[int] = []
                    nblk = 0
                    if carry is not None:
                        merged = [carry]
                        nblk = len(groups[carry][1])
                        carry = None
                    # steal at most HALF the remaining groups per
                    # submission (bounded by the device batch width):
                    # merging must not let the feeder claim the whole
                    # deque in one gulp — the CPU side would sit idle
                    # while the device serializes everything
                    t_claim = time.perf_counter()
                    with lock:
                        take_n = max(1, (len(dq) + 1) // 2)
                    while nblk < target and take_n > 0:
                        with lock:
                            if not dq:
                                break
                            gi = dq.pop()
                        take_n -= 1
                        cgi = len(groups[gi][1])
                        if merged and (cgi % k_align != 0
                                       or nblk + cgi > target):
                            carry = gi
                            break
                        merged.insert(0, gi)
                        nblk += cgi
                    self.obs.observe_stage(
                        "feeder_wait", "tpu",
                        time.perf_counter() - t_claim)
                    if not merged:
                        break
                    with self.obs.stage("host_staging", "tpu"):
                        gb: List[bytes] = []
                        gh: List[Hash] = []
                        for gi in merged:
                            _idx, b, h = groups[gi]
                            gb.extend(b)
                            gh.extend(h)
                    sub_bytes = sum(len(x) for x in gb)
                    try:
                        # whole-submit envelope; an instrumented CudaCodec
                        # additionally refines it into host_staging /
                        # h2d_transfer / kernel_dispatch internally
                        with self.obs.stage("device_submit", "tpu"):
                            ok_dev, parity_dev, _cnt = self.tpu.scrub_submit(
                                gb, gh)
                        variant = getattr(
                            self.tpu, "last_submit_variant", None)
                    except BaseException:
                        # none of `merged` was submitted: hand the whole
                        # claim back — carry (popped after merged's
                        # lowest index, so it is the SMALLEST outstanding
                        # index) must go back FIRST to keep the deque's
                        # contiguous-ascending invariant
                        with lock:
                            if carry is not None:
                                dq.append(carry)
                            carry = None
                            dq.extend(merged)
                        raise
                    inflight.append(
                        (merged, sub_bytes, ok_dev, parity_dev, variant)
                    )
                    if len(inflight) > self.window:
                        t_c = time.monotonic()
                        item = inflight.popleft()
                        self._tpu_collect(item, groups, set_result,
                                          fetch_parity)
                        ramp_i += 1
                        new_target = ramp[min(ramp_i, len(ramp) - 1)]
                        if new_target != target:
                            self.obs.event("ramp", reason="widen",
                                           blocks=new_target)
                        # Give up on a pathologically slow link: feeding it
                        # costs host CPU (transfer staging ≈ one memcpy per
                        # group, a few % of a CPU verify) that the verifier
                        # could spend directly.  Staging costs ~3% of a
                        # CPU group, so ANY device rate above ~5% of the
                        # CPU's is net-positive — only below that does
                        # ceding to the CPU win.  (A 2× threshold here once
                        # dropped a link running at 18% of CPU rate, wasting
                        # its entire contribution.)
                        collect_dt = time.monotonic() - t_c
                        cpu_dt = time.monotonic() - cpu_t0
                        cpu_rate = (cpu_bytes_this_call[0] / cpu_dt
                                    if cpu_dt > 0 else 0.0)
                        item_bytes = item[1]
                        if cpu_rate > 0 and \
                                collect_dt > 20 * item_bytes / cpu_rate:
                            logger.info(
                                "hybrid feeder: link too slow (%.0f KiB/s), "
                                "ceding remaining groups to CPU",
                                item_bytes / max(collect_dt, 1e-9) / 1024,
                            )
                            self.obs.event(
                                "cede", reason="slow_collect",
                                kibs=round(item_bytes
                                           / max(collect_dt, 1e-9) / 1024),
                            )
                            break
                while inflight:
                    self._tpu_collect(inflight.popleft(), groups,
                                      set_result, fetch_parity)
            except BaseException as e:
                if card:
                    dev_err.append(e)
                # Off the card a device failure must never fail a scrub:
                # groups without a result are hedge-verified on CPU below.
                logger.warning(
                    "device feeder failed: %r", e)
                self.obs.event("feeder_error", reason=type(e).__name__,
                               error=f"{e}"[:200])
            finally:
                # A popped-but-unsubmitted carry group must not strand:
                # on ANY exit (slow-link cede, submit failure, normal end
                # with an over-target carry) hand it back to the deque so
                # the CPU loop — not the tail hedge's grace timeout —
                # picks it up.  gate_hold tells the CPU side the feeder
                # will steal no more: remaining spans go unbounded.
                if carry is not None:
                    with lock:
                        dq.append(carry)
                gate_hold.set()

        def feeder_thread():
            from ..utils.cpuprof import register_thread, unregister_thread
            register_thread("hybrid-feeder")
            try:
                feeder()
            finally:
                unregister_thread()

        if use_device:
            t = threading.Thread(target=feeder_thread,
                                 name="codec-hybrid-feeder", daemon=True)
            _LIVE_FEEDERS.append(t)
            while len(_LIVE_FEEDERS) > 8:  # drop long-finished entries
                old = _LIVE_FEEDERS.popleft()
                if old.is_alive():
                    _LIVE_FEEDERS.append(old)
                    break
            t.start()

        # CPU side: pop contiguous runs of groups from the LEFT and
        # process each run with ONE wide fused call (native multi-buffer
        # hash + pointer-gather RS amortize per-call overhead).  While
        # the device may still steal, spans are bounded at
        # cpu_span_blocks so stealing stays balanced; once the gate
        # holds (or there is no device) spans are unbounded and the pass
        # is byte-identical in call pattern to the plain CPU codec.
        while True:
            target = (self.cpu_span_blocks
                      if not gate_hold.is_set() else None)
            with lock:
                if not dq:
                    break
                span = [dq.popleft()]
                nblk = len(groups[span[-1]][1])
                while dq and (target is None or nblk < target):
                    prev_idx, prev_b, _ph = groups[span[-1]]
                    # a non-k-aligned group (a segment tail) must stay
                    # LAST in any merged run so parity-row starts remain
                    # multiples of k; block-index contiguity is a
                    # defensive invariant check
                    if (len(prev_b) % k_align != 0 or
                            groups[dq[0]][0] != prev_idx + len(prev_b)):
                        break
                    span.append(dq.popleft())
                    nblk += len(groups[span[-1]][1])
            gb: List[bytes] = []
            gh: List[Hash] = []
            for gi in span:
                gb.extend(groups[gi][1])
                gh.extend(groups[gi][2])
            with self.obs.stage("cpu_span", "cpu"):
                ok = self.cpu.batch_verify(gb, gh)
                parity_arr = None
                if compute_parity:
                    parity_arr = self.cpu.rs_encode_blocks(gb)
            self._split_merged(
                span, groups, ok,
                parity_arr if fetch_parity else None,
                set_result, "cpu")
            cpu_bytes_this_call[0] += sum(len(b) for b in gb)

        if card:
            # a local card is no stalled link: wait for its in-flight
            # groups, and raise its failure instead of hedging around it
            t.join()
            if dev_err:
                raise dev_err[0]

        # Tail: the device still holds in-flight groups.  Waiting for a
        # metered/stalled link can dwarf the whole pass, so hedge: give the
        # device a quarter of the time the CPU would need to redo the
        # stragglers, then recompute them on CPU — first writer wins, the
        # device's late results are discarded.  The feeder thread is NOT
        # joined: it syncs its remaining transfers in the background.
        with lock:
            pending = [gi for gi, r in enumerate(results) if r is None]
        if pending:
            cpu_dt = time.monotonic() - cpu_t0
            cpu_rate = cpu_bytes_this_call[0] / cpu_dt if cpu_dt > 0 else 0.0
            pend_bytes = sum(
                len(b) for gi in pending for b in groups[gi][1]
            )
            grace = 0.25 * pend_bytes / cpu_rate if cpu_rate > 0 else 1.0
            with self.obs.stage("tail_wait", "tpu"):
                done.wait(timeout=grace)
            hedged = 0
            for gi in pending:
                with lock:
                    if results[gi] is not None:
                        continue
                _idx, gb, gh = groups[gi]
                with self.obs.stage("hedge", "cpu"):
                    val = self._cpu_group(gb, gh, compute_parity,
                                          fetch_parity)
                if set_result(gi, val, "cpu", sum(len(b) for b in gb)):
                    hedged += 1
            if hedged:
                # the hedge redoing device-claimed groups is silent work
                # unless recorded — make it an attributable event
                self.obs.event("tail_hedge", reason="grace_expired",
                               groups=hedged)
            done.wait()  # every slot now has a writer; returns immediately
        return results

    def _cpu_group(self, gb, gh, compute_parity, fetch_parity):
        """Verify (+ optionally encode) one group on the CPU codec.  Byte
        accounting is the caller's job (only winning writes count)."""
        ok = self.cpu.batch_verify(gb, gh)
        parity = None
        if compute_parity:
            parity = self.cpu.rs_encode_blocks(gb)
            if not fetch_parity:
                parity = None
        return ok, parity

    def _split_merged(self, merged, groups, ok_arr, parity_arr,
                      set_result, side):
        """Split one merged run's results back into per-group results —
        shared by the device collect and the CPU span path so both sides
        produce identical shapes.  Group starts within the run are
        multiples of k (every merged group but the last is k-aligned),
        so each group's parity rows are exactly [start//k, start//k +
        ceil(len/k)), trimmed to the group's own max block length (pad
        rows/columns are zero blocks → zero parity, GF-linear).
        parity_arr None = caller discards parity."""
        k = max(1, self.params.rs_data)
        off = 0
        for gi in merged:
            _idx, b, _h = groups[gi]
            ln = len(b)
            parity = None
            if parity_arr is not None:
                ml = max(len(x) for x in b)
                r0 = off // k
                nrows = (ln + k - 1) // k
                parity = parity_arr[r0:r0 + nrows, :, :ml]
            set_result(gi, (ok_arr[off:off + ln], parity), side,
                       sum(len(x) for x in b))
            off += ln

    def _tpu_collect(self, item, groups, set_result, fetch_parity):
        """Sync one merged device submission and split it per-group.

        The host copy here is where an async backend's kernel failures
        actually surface — long after scrub_submit returned clean — so
        the outcome is reported back to the device codec's hooks
        (note_sync_failure/_success)."""
        merged, _sub_bytes, ok_dev, parity_dev, variant = item
        try:
            with self.obs.stage("sync_collect", "tpu"):
                ok = _to_host(ok_dev)
                parity_np = _to_host(parity_dev) if fetch_parity else None
        except BaseException as e:
            self.obs.event("sync_failure", reason=type(e).__name__,
                           error=f"{e}"[:200])
            note = getattr(self.tpu, "note_sync_failure", None)
            if note is not None:
                try:
                    note(e, variant)
                except Exception:
                    logger.warning("note_sync_failure hook failed",
                                   exc_info=True)
            raise
        note = getattr(self.tpu, "note_sync_success", None)
        if note is not None:
            try:
                note(variant)
            except Exception:
                logger.warning("note_sync_success hook failed",
                               exc_info=True)
        self._split_merged(merged, groups, ok, parity_np, set_result,
                           "tpu")

    # --- ragged batch routing (the CodecFeeder's foreground path) ---

    def ragged_side(self) -> str:
        """Route for feeder ragged batches: the device only when it is
        attached AND the link probe's CACHED verdict clears the gate.
        The foreground path must never pay a cold 16 MiB probe
        round-trip — an unprobed or stale link routes to the CPU floor
        and the next scrub pass's probe re-opens the gate.  An
        unmetered backend (no probe_link hook, no warm_scrub marker —
        scripted fakes, local device) is treated as healthy, exactly
        as _probe_link does; that verdict never enters the cache, so
        it is re-derived here rather than read from _link_rate."""
        if self.tpu is None:
            return "cpu"
        if self.transport is not None and not self.transport.alive:
            # the transport latched down (repeated device failures or
            # drain): the device path is gone for ragged batches even
            # if the cached link verdict was healthy
            return "cpu"
        if (getattr(self.tpu, "probe_link", None) is None
                and not hasattr(self.tpu, "warm_scrub")):
            return "tpu"
        with self._probe_lock:
            rate, ts, failed = self._link_rate, self._link_ts, \
                self._link_failed
        if rate is None:
            return "cpu"
        if rate == float("inf"):
            return "tpu"
        if failed or time.monotonic() - ts > self._LINK_PROBE_TTL_MAX_S:
            return "cpu"
        return ("tpu" if rate >= self.params.hybrid_min_link_gibs
                else "cpu")

    def _ragged_target(self) -> BlockCodec:
        return self.tpu if self.ragged_side() == "tpu" else self.cpu

    def refresh_gate(self) -> None:
        """Run the (TTL-cached) link probe so the cached gate verdict
        exists/stays fresh.  Called by the feeder before dispatching a
        BACKGROUND batch to a still-closed gate: scrub is where the
        gate historically got its measurements (the stealing feeder
        probed every pass), and with scrub riding the feeder queue the
        probe must ride with it — background work can afford it,
        foreground never pays it cold."""
        if self.tpu is not None:
            try:
                self._probe_link()
            except Exception:  # noqa: BLE001 — a dead probe = gate stays shut
                if on_card(self.tpu):
                    raise
                logger.warning("gate refresh probe failed", exc_info=True)

    def scrub_ragged(self, items):
        """Feeder `scrub` kind when no transport took the batch: the CPU
        floor runs the fused serial path; a device route without the
        array API (scripted fakes) degrades to one hybrid-engine pass
        per item."""
        if self.ragged_side() == "tpu":
            t = self.tpu
            if hasattr(t, "scrub_ragged"):
                return t.scrub_ragged(items)
            return [self.scrub_encode_batch(b, h, fp) for b, h, fp in items]
        return self.cpu.scrub_ragged(items)

    def hash_ragged(self, groups):
        return self._ragged_target().hash_ragged(groups)

    def rs_encode_ragged(self, groups):
        return self._ragged_target().rs_encode_ragged(groups)

    def rs_reconstruct_ragged(self, items):
        return self._ragged_target().rs_reconstruct_ragged(items)

    # --- BlockCodec interface ---

    def batch_hash(self, blocks: Sequence[bytes]) -> List[Hash]:
        # hashing without expectations: no corruption checks to fuse, so the
        # CPU pool is already optimal for small batches; large batches split.
        return self.cpu.batch_hash(blocks)

    def batch_verify(self, blocks: Sequence[bytes], hashes: Sequence[Hash]) -> np.ndarray:
        if len(blocks) != len(hashes):
            raise ValueError(f"{len(blocks)} blocks vs {len(hashes)} hashes")
        if not blocks:
            return np.zeros((0,), dtype=bool)
        results = self._run_groups(blocks, hashes, compute_parity=False,
                                   fetch_parity=False)
        return np.concatenate([r[0] for r in results])

    @staticmethod
    def _assemble_parity(parities, maxlen: int) -> Optional[np.ndarray]:
        """Concatenate per-group parity into the canonical (ceil(B/k), m,
        maxlen) array (contract of scrub_encode_batch, shared with
        CudaCodec).  Groups are k-aligned and consecutive, so their codeword
        rows concatenate exactly as a whole-batch reshape would; shorter
        groups are zero-padded to maxlen columns (zero data → zero parity,
        GF-linear)."""
        rows = []
        for p in parities:
            if p is None:
                return None
            if p.shape[-1] < maxlen:
                p = np.pad(p, [(0, 0), (0, 0), (0, maxlen - p.shape[-1])])
            rows.append(p)
        return np.concatenate(rows, axis=0)

    def scrub_encode_batch(self, blocks: Sequence[bytes], hashes: Sequence[Hash],
                           fetch_parity: bool = True):
        """Fused verify + RS(k,m) parity across both backends.

        Same contract as CudaCodec.scrub_encode_batch: (ok (B,), parity
        (ceil(B/k), m, maxlen) | None).  With fetch_parity=False (or
        rs_data=0), parity is None — device-side parity stays on the device
        (callers that discard parity avoid paying device→host bandwidth);
        CPU-side parity is still computed, the work is identical.
        """
        if not blocks:
            return np.zeros((0,), dtype=bool), None
        results = self._run_groups(blocks, hashes, compute_parity=True,
                                   fetch_parity=fetch_parity)
        ok = np.concatenate([r[0] for r in results])
        parity = None
        if fetch_parity and self.params.rs_data > 0:
            parity = self._assemble_parity(
                [r[1] for r in results], max(len(b) for b in blocks)
            )
        return ok, parity

    def scrub_many(self, batches, fetch_parity: bool = False):
        """Fused verify+encode over MANY batches through ONE stealing deque.

        batches: sequence of (blocks, hashes) pairs (the scrub worker's
        read-ahead).  Processing all batches in one pass amortizes the
        device pipeline across batch boundaries — there is a single hedged
        tail for the whole stream instead of one per batch, which matters
        when the device link carries seconds of in-flight data.  Returns a
        list of (ok, parity|None) per input batch, parity in the canonical
        scrub_encode_batch shape computed from that batch's blocks only.
        """
        all_blocks: List[bytes] = []
        all_hashes: List[Hash] = []
        counts = []
        for blocks, hashes in batches:
            if len(blocks) != len(hashes):
                raise ValueError(f"{len(blocks)} blocks vs {len(hashes)} hashes")
            all_blocks.extend(blocks)
            all_hashes.extend(hashes)
            counts.append(len(blocks))
        if not all_blocks:
            return [(np.zeros((0,), dtype=bool), None) for _ in counts]
        # batch edges are hard cuts: no group (= RS codeword span) straddles
        # two batches, so each batch's parity is computed from its own
        # blocks only
        edges = list(np.cumsum(counts)[:-1])
        results = self._run_groups(all_blocks, all_hashes,
                                   compute_parity=True,
                                   fetch_parity=fetch_parity,
                                   cuts=[int(e) for e in edges])
        ok = np.concatenate([r[0] for r in results])
        out = []
        pos = 0
        gi = 0
        g = self.group_blocks
        for cnt in counts:
            parity = None
            ngroups = (cnt + g - 1) // g
            if fetch_parity and cnt and self.params.rs_data > 0:
                parity = self._assemble_parity(
                    [results[i][1] for i in range(gi, gi + ngroups)],
                    max(len(b) for b in all_blocks[pos:pos + cnt]),
                )
            gi += ngroups
            out.append((ok[pos:pos + cnt], parity))
            pos += cnt
        return out

    def verify_one(self, block: bytes, hash: Hash) -> bool:
        return self.cpu.verify_one(block, hash)

    def rs_encode(self, data: np.ndarray) -> np.ndarray:
        return self.cpu.rs_encode(data)

    def rs_reconstruct(self, shards: np.ndarray, present: Sequence[int],
                       rows: Optional[Sequence[int]] = None) -> np.ndarray:
        return self.cpu.rs_reconstruct(shards, present, rows)
