"""BlockManager — content-addressed block storage + streaming block RPC.

Equivalent of reference src/block/manager.rs (SURVEY.md §2.5):
  - local storage: write_block (tmp file + rename + optional fsync incl.
    dir fsync, dedupe against existing copy, manager.rs:689-784), read_block
    with verify (corruption → rename `.corrupted` + immediate resync
    requeue, manager.rs:528-590), find_block across dirs and compression
    states (manager.rs:608-643).
  - RPC: rpc_get_block(_streaming) tries replicas in latency order with a
    per-node timeout then moves on (manager.rs:231-317); rpc_put_block
    compresses then quorum-writes via try_call_many (manager.rs:356-377).
  - 256-way sharded mutation locks (manager.rs:115) serialize writes to the
    same block without a global lock.

TPU-first: read-path verify goes through `codec.verify_one` — defined by
default in terms of the same batch_verify the scrub path uses (the TPU
codec overrides it with a bit-identical host hash so single reads never
pay a device roundtrip; batched scrub/resync still run on device).
"""

from __future__ import annotations

import asyncio
import errno as _errno
import logging
import os
from typing import AsyncIterator, List, Optional, Tuple

from ..db import Db
from ..net.frame import PRIO_BACKGROUND, PRIO_NORMAL
from ..rpc.system import System
from ..utils.crdt import now_msec
from ..utils.data import FixedBytes32, Hash, block_hash
from ..utils.error import (
    CorruptData,
    GarageError,
    NoSuchBlock,
    StorageError,
    StorageFull,
)
from ..utils.metrics import maybe_time
from ..utils.persister import Persister
from .block import DataBlock, DataBlockHeader
from .health import (DISK_STATE_VALUES, DiskHealthMonitor, DiskIo,
                     is_media_error, janitor_pass)
from .layout import DataLayout
from .rc import BlockRc

logger = logging.getLogger("garage_tpu_torch.block.manager")

INLINE_THRESHOLD = 3072       # ref manager.rs:49
BLOCK_RW_TIMEOUT = 60.0
MUTEX_SHARDS = 256            # ref manager.rs:115
STREAM_CHUNK = 256 * 1024


class BlockManager:
    def __init__(
        self,
        config,
        db: Db,
        system: System,
        replication,            # TableShardedReplication for data partitions
        codec=None,
    ):
        self.config = config
        self.db = db
        self.system = system
        self.replication = replication
        # the codec gets the System's registry/tracer: per-stage
        # histograms, bytes-by-side counters and the gate-decision ring
        # become node-visible (/metrics, admin codec info/events)
        self.codec = codec or config.codec.make(
            config.compression_level,
            metrics=getattr(system, "metrics", None),
            tracer=getattr(system, "tracer", None),
            block_size=config.block_size,
        )
        self.hash_algo = config.codec.hash_algo
        self.compression_level = config.compression_level
        self.data_fsync = config.data_fsync
        # continuous-batching feeder for the FOREGROUND data path: PUT
        # block-id hashing (api/s3/put.py), write-time RS encodes
        # (block/parity.py WriteParityAccumulator) and degraded-read RS
        # decodes (ParityStore / model/parity_repair.py) submit here and
        # coalesce into ragged codec batches — K concurrent puts pay ~one
        # batched dispatch instead of K serial codec passes (ops/feeder.py)
        self.feeder = None
        if getattr(config.codec, "feeder", True):
            from ..ops.feeder import CodecFeeder

            self.feeder = CodecFeeder(
                self.codec,
                slo_ms=getattr(config.codec, "feeder_slo_ms", 2.0),
                max_batch_blocks=getattr(
                    config.codec, "feeder_max_batch_blocks", 256),
                metrics=getattr(system, "metrics", None),
                observer=self.codec.obs,
            )
        # static block-transfer timeout ([rpc].block_rpc_timeout): the
        # ceiling/fallback the adaptive per-peer layer clamps against
        # (used to be the hardcoded BLOCK_RW_TIMEOUT literal everywhere)
        rpc_cfg = getattr(config, "rpc", None)
        self.block_rpc_timeout = (
            rpc_cfg.block_rpc_timeout if rpc_cfg is not None
            else BLOCK_RW_TIMEOUT
        )

        # multi-drive layout, persisted (ref manager.rs:122-160)
        self._layout_persister = Persister(
            config.metadata_dir, "data_layout", DataLayout
        )
        saved = self._layout_persister.load()
        if saved is None:
            self.data_layout = DataLayout.initialize(config.data_dir)
            self._layout_persister.save(self.data_layout)
        elif saved.config_changed(config.data_dir):
            self.data_layout = saved.update(config.data_dir)
            self._layout_persister.save(self.data_layout)
        else:
            self.data_layout = saved
        for d in self.data_layout.data_dirs:
            os.makedirs(d.path, exist_ok=True)

        # the filesystem boundary: every byte this manager moves to or
        # from disk goes through self.disk, so storage faults inject at
        # exactly one seam (testing/faults.py FaultyDisk wraps it)
        self.disk = DiskIo()
        # per-root busy-seconds attribution (USE utilization): DiskIo
        # accumulates I/O wall time keyed by the root this hook maps
        # each path to
        self.disk.root_of = self._root_of
        # per-hash local-read error backoff (a bad sector must not be
        # re-hit by every read of a hot block while peers can serve it);
        # reuses the resync ErrorCounter schedule
        self._disk_errors: dict = {}
        m0 = getattr(system, "metrics", None)
        # per-data-root ok → degraded(read-only) → failed state machine:
        # free-space watermark preflight + disk-error streaks through
        # the RPC layer's CircuitBreaker (block/health.py).  statvfs is
        # routed through self.disk via a late-bound closure so a fault
        # wrapper installed later is honored.
        self.health = DiskHealthMonitor(
            [d.path for d in self.data_layout.data_dirs],
            watermark=getattr(config, "data_free_space_watermark", 128 << 20),
            error_threshold=getattr(config, "disk_error_threshold", 8),
            cooldown=getattr(config, "disk_error_cooldown", 30.0),
            statvfs=lambda p: self.disk.statvfs(p),
            counter=(m0.counter(
                "disk_error_total",
                "Disk I/O errors at the block store boundary, by "
                "operation and errno kind") if m0 is not None else None),
        )
        # gossiped next to the statvfs numbers so peers' `cluster stats`
        # show a remote node going read-only (rpc/system.py NodeStatus)
        system.disk_state_fn = self.health.worst_state
        self.quarantined = 0          # copies moved aside as .corrupted
        self.quarantine_errors = 0    # quarantine renames that failed

        self.rc = BlockRc(db.open_tree("block_local_rc"))
        # node-local record of which stored blocks are distributed-parity
        # shards: the is_parity RPC flag is transient, but resync
        # refetches and offload transfers must not feed parity back into
        # the accumulators (parity-of-parity cascade)
        self._parity_marks = db.open_tree("block_parity_marks")
        self._locks = [asyncio.Lock() for _ in range(MUTEX_SHARDS)]

        self.endpoint = system.netapp.endpoint("garage/block")
        self.endpoint.set_handler(self._handle)

        # attached after construction (circular dep): BlockResyncManager
        self.resync = None
        self._heal_tasks: set = set()       # post-decode write-backs
        self._heal_in_flight: set = set()   # hashes with a heal running
        self._heals_closed = False          # set by drain_heals()
        # attached by Garage when RS parity sidecars are enabled
        self.parity_store = None
        # attached by Garage when codec.parity_on_write is also enabled:
        # locally-stored blocks join write-time codewords → LOCAL sidecars
        self.write_parity = None
        # attached by Garage when codec.parity_distribute is enabled:
        # blocks THIS node writes into the cluster join distinct-node
        # codewords whose parity is distributed cross-node
        self.ec_accumulator = None
        # async h -> plain bytes | None, decoding from cross-node pieces
        self.parity_reconstructor = None
        self.blocks_reconstructed = 0
        # degraded-read decodes of a codeword whose geometry differs from
        # the live codec's: they run on a throwaway CpuCodec (a codec
        # config change since the codeword was written), never on the card
        self.geometry_cpu_decodes = 0
        # bandwidth-minimal degraded-read fetch planner (exact-k survivor
        # selection + partial-parallel repair, block/repair_plan.py);
        # None keeps the legacy sweep-everything gather
        self.repair_planner = None
        if (getattr(config.codec, "repair_planner", True)
                and config.codec.rs_data > 0):
            from .repair_plan import RepairPlanner

            hedge_ms = getattr(config.codec, "repair_hedge_ms", 0.0) or 0.0
            self.repair_planner = RepairPlanner(
                self,
                use_ppr=getattr(config.codec, "repair_ppr", True),
                hedge_delay=(hedge_ms / 1000.0) if hedge_ms > 0 else None,
                use_tree=getattr(config.codec, "repair_tree", True),
                tree_fanout=getattr(config.codec, "repair_tree_fanout", 4),
            )

        # metrics counters (ref block/metrics.rs:7-127)
        self.bytes_read = 0
        self.bytes_written = 0
        self.corruptions = 0
        # heal attribution (a heal speedup can come from a fallback
        # kick rather than the claimed path — which heal path actually
        # fired must be a counter, not an inference):
        # source ∈ {writeback, resync_fetch, peer_sweep,
        # distributed_decode, local_sidecar}
        self.heal_counts: dict = {}
        # repair-bandwidth accounting (block/repair_plan.py + the legacy
        # gather in model/parity_repair.py): wire bytes fetched per
        # reconstruction mode, bytes of repaired rows produced, fetched
        # bytes that ended up unused, hedged replacement fetches, and
        # PPR requests that fell back to whole-shard (mixed-version /
        # missing-piece peers).  Plain attributes so bench/chaos read
        # them without a metrics registry.
        self.repair_fetch_bytes: dict = {
            "ppr": 0, "shard": 0, "gather": 0, "tree": 0}
        self.repair_repaired_bytes = 0
        self.repair_overfetch_bytes = 0
        self.repair_hedges = 0
        self.repair_ppr_fallbacks = 0
        # re-plans by reason (survivor_died / mid_tree / version_demote /
        # tree_abort) and the depth of the last aggregation tree served
        # or planned here — chaos/bench read the plain attrs.
        self.repair_replans: dict = {}
        self.repair_tree_depth_last = 0
        m = getattr(system, "metrics", None)
        if m is not None:
            m.gauge("block_compression_level", "Configured zstd level",
                    fn=lambda: self.compression_level or 0)
            m.gauge("block_rc_entries", "Refcounted block entries",
                    fn=self.rc_len)
            m.gauge("block_resync_queue_length", "Blocks awaiting resync",
                    fn=lambda: self.resync.queue_len() if self.resync else 0)
            m.gauge("block_resync_errored_blocks",
                    "Blocks in resync error backoff",
                    fn=lambda: self.resync.errors_len() if self.resync else 0)
            m.gauge("block_bytes_read_total", "Block payload bytes read",
                    fn=lambda: self.bytes_read)
            m.gauge("block_bytes_written_total", "Block payload bytes written",
                    fn=lambda: self.bytes_written)
            m.gauge("block_corruptions_total", "Corrupted blocks detected",
                    fn=lambda: self.corruptions)
            m.gauge("block_parity_indexed", "Blocks covered by RS parity sidecars",
                    fn=lambda: (self.parity_store.stats()["indexed_blocks"]
                                if self.parity_store else 0))
            m.gauge("block_local_reconstructions_total",
                    "Blocks rebuilt locally from RS parity",
                    fn=lambda: self.blocks_reconstructed)
            self.m_read_dur = m.histogram(
                "block_read_duration_seconds", "Local block read+verify")
            self.m_write_dur = m.histogram(
                "block_write_duration_seconds", "Local block write")
            # labeled render-time observers: any render() (admin
            # /metrics, tests, chaos scripts) sees CURRENT per-root
            # health with no scrape-side refresh hook to forget
            m.gauge(
                "disk_root_state",
                "Data-root health: 0 ok, 1 degraded (read-only), 2 failed",
                labeled_fn=lambda: [
                    ({"root": r}, DISK_STATE_VALUES[s])
                    for r, s in self.health.states().items()])
            m.gauge(
                "disk_free_bytes",
                "Free bytes per data root (statvfs, cached)",
                labeled_fn=lambda: [
                    ({"root": r}, float(self.health.free_bytes(r) or 0))
                    for r in self.health.roots()])
            m.gauge(
                "disk_busy_seconds",
                "Cumulative wall seconds spent in block-store I/O per "
                "data root (USE utilization; rate() = per-root busy "
                "fraction).  root=\"\" aggregates unmapped paths",
                labeled_fn=lambda: [
                    ({"root": r}, float(s))
                    for r, s in sorted(self._disk_busy().items())])
            self.m_quarantine = m.counter(
                "block_quarantine_total",
                "Block copies moved aside as .corrupted (read-path "
                "verify failures, unreadable files, scrub)")
            self.m_quarantine_err = m.counter(
                "block_quarantine_error_total",
                "Quarantine renames that failed (bad copy deleted "
                "instead so resync can refetch)")
            self.m_repair_fetch = m.counter(
                "repair_fetch_bytes_total",
                "Bytes fetched for degraded reads / reconstruction, by "
                "mode (ppr = partial-sum products, shard = whole-shard "
                "exact-k — both wire bytes; tree = coordinator ingress "
                "of the aggregated repair-tree root stream, flat in k; "
                "gather = legacy sweep-everything fallback, counted as "
                "verified plain bytes, an upper bound on its wire cost)")
            self.m_repair_repaired = m.counter(
                "repair_repaired_bytes_total",
                "Bytes of reconstructed codeword rows produced by "
                "degraded reads / repair")
            self.m_repair_overfetch = m.counter(
                "repair_overfetch_bytes_total",
                "Repair bytes fetched but discarded unused (hedge losers, "
                "pieces beyond the k the decode needed)")
            self.m_repair_hedge = m.counter(
                "repair_hedge_total",
                "Hedged replacement fetches launched by the repair "
                "planner on stalled piece fetches")
            self.m_repair_ppr_fb = m.counter(
                "repair_ppr_fallback_total",
                "PPR partial-product requests that fell back to a "
                "whole-shard fetch (old-version or piece-less peers)")
            self.m_repair_replan = m.counter(
                "repair_replan_total",
                "Repair plans re-planned mid-flight, by reason "
                "(survivor_died = survivor failed after acking the plan; "
                "mid_tree = subtree loss re-fetched flat under the same "
                "survivor set; version_demote = tree edge demoted to "
                "flat PPR for a mixed-version peer; tree_abort = "
                "aggregation tree abandoned for the flat planner)")
            m.gauge(
                "repair_tree_depth",
                "Depth of the most recent PPR aggregation tree planned "
                "or served by this node (0 = no tree yet)",
                fn=lambda: float(self.repair_tree_depth_last))
            self.m_heal = m.counter(
                "block_heal_total",
                "Blocks re-materialized, by heal source (writeback = "
                "read-path post-decode write-back; resync_fetch / "
                "peer_sweep / distributed_decode = resync chain; "
                "local_sidecar = local RS parity rebuild; rebuild = "
                "fleet rebuild scheduler after a full-node loss)")
            # gate-state gauges read THROUGH self.codec so a codec swap
            # (tests, future runtime rebuild) keeps /metrics truthful —
            # fn= observers on the codec itself would both pin the old
            # instance and keep reporting it after a swap (Gauge dedup
            # keeps the first registration's observer)
            m.gauge(
                "codec_device_attached",
                "1 when the codec's device side is attached "
                "(hybrid/tpu backends)",
                fn=lambda: 1.0 if getattr(self.codec, "tpu", None)
                is not None else 0.0)
            m.gauge(
                "codec_link_gibs",
                "Last measured host→device link rate (GiB/s; 0 = "
                "unprobed or failed)",
                fn=lambda: float(
                    getattr(self.codec, "last_link_gibs", None) or 0.0))
            m.gauge(
                "codec_tpu_frac",
                "Cumulative fraction of codec bytes processed "
                "device-side", fn=lambda: self.codec.obs.tpu_frac())
        else:
            self.m_read_dur = self.m_write_dur = None
            self.m_heal = None
            self.m_quarantine = self.m_quarantine_err = None
            self.m_repair_fetch = self.m_repair_repaired = None
            self.m_repair_overfetch = None
            self.m_repair_hedge = self.m_repair_ppr_fb = None
            self.m_repair_replan = None

    # --- paths ---

    def _block_dir(self, root: str, h: Hash) -> str:
        hx = bytes(h).hex()
        return os.path.join(root, hx[:2], hx[2:4])

    def block_path(self, root: str, h: Hash, compressed: bool) -> str:
        return os.path.join(
            self._block_dir(root, h), bytes(h).hex() + (".zst" if compressed else "")
        )

    def find_block(self, h: Hash) -> Optional[Tuple[str, bool]]:
        """Locate an existing copy: (path, compressed), preferring the
        primary dir then secondaries, compressed then plain
        (ref manager.rs:608-643)."""
        for root in self.data_layout.all_dirs(h):
            for compressed in (True, False):
                p = self.block_path(root, h, compressed)
                if os.path.exists(p):
                    return p, compressed
        return None

    def is_block_present(self, h: Hash) -> bool:
        return self.find_block(h) is not None

    def _disk_busy(self) -> dict:
        """Per-root cumulative I/O busy seconds — read through a fault
        wrapper's inner DiskIo when one is installed (FaultyDisk
        delegates the actual I/O, so the inner instance holds the
        truth).  Snapshot-copied: worker threads insert concurrently."""
        disk = self.disk
        busy = getattr(disk, "busy_seconds", None)
        if busy is None:
            inner = getattr(disk, "inner", None)
            busy = getattr(inner, "busy_seconds", None)
        return dict(busy) if busy else {}

    def _root_of(self, path: str) -> str:
        """Which data root a block file lives under (longest prefix
        match; falls back to the file's dirname for out-of-layout paths
        so health accounting never KeyErrors)."""
        best = ""
        for d in self.data_layout.data_dirs:
            r = d.path.rstrip(os.sep)
            if (path == r or path.startswith(r + os.sep)) and len(r) > len(best):
                best = r
        return best or os.path.dirname(path)

    def pool_invalidate(self, h: Hash, reason: str) -> None:
        """Strict device-pool invalidation (ops/device_pool.py): evict
        `h`'s device-resident pages SYNCHRONOUSLY, before the calling
        operation acks — block delete, quarantine, rebalance-drop and
        overwrite all come through here, so the pool can never serve a
        page for a block the store no longer holds.  Thread-safe and
        cheap (a dict op under the pool's lock), callable from worker
        threads and the event loop alike; a pool-less codec is a
        no-op."""
        pool = getattr(self.codec, "pool", None)
        if pool is None:
            return
        try:
            pool.invalidate(bytes(h), reason=reason)
        except Exception:  # noqa: BLE001 — invalidation must not fail the op
            logger.warning("device pool invalidation failed",
                           exc_info=True)

    def quarantine_path(self, path: str) -> None:
        """Move a bad copy aside as `.corrupted` for later forensics.
        A failing rename is NOT swallowed (the old `_move_corrupted`
        silently did, leaving a corrupt copy live and re-servable): it
        is logged with path+errno, counted, and the bad copy is deleted
        instead so resync refetches a clean one.  Runs in worker
        threads — keep it sync."""
        try:
            self.disk.replace(path, path + ".corrupted")
            self.quarantined += 1
            if self.m_quarantine is not None:
                self.m_quarantine.inc()
        except FileNotFoundError:
            # lost the race: a concurrent reader of the same bad copy
            # (or a delete) already quarantined/removed it — that IS the
            # desired end state, not a quarantine failure, and it must
            # not count errors or feed the root's streak
            return
        except OSError as e:
            self.quarantine_errors += 1
            if self.m_quarantine_err is not None:
                self.m_quarantine_err.inc()
            logger.error(
                "quarantine rename of %s failed (errno %s: %s); deleting "
                "the bad copy so resync can refetch", path, e.errno, e)
            try:
                self.disk.remove(path)
            except FileNotFoundError:
                pass
            except OSError as e2:
                logger.error("deleting bad copy %s also failed "
                             "(errno %s: %s)", path, e2.errno, e2)
                self.health.note_error(self._root_of(path), "quarantine", e2)

    def _note_disk_error(self, h: Hash) -> None:
        """Arm/extend the per-hash local-read backoff (ErrorCounter
        schedule: 60 s × 2^n).  While armed, read_block skips the local
        file immediately so reads fail over to peers instead of
        re-hitting a bad sector; a successful local write or read
        clears it."""
        from .resync import ErrorCounter

        hb = bytes(h)
        prev = self._disk_errors.get(hb)
        self._disk_errors[hb] = ErrorCounter(
            (prev.errors if prev is not None else 0) + 1, now_msec())
        if len(self._disk_errors) > 4096:
            # bounded: drop the oldest-armed entries (retrying a stale
            # hash locally once is harmless)
            for k in sorted(self._disk_errors,
                            key=lambda k: self._disk_errors[k].last_try
                            )[:1024]:
                del self._disk_errors[k]

    def startup_janitor(self) -> dict:
        """Boot-time crash-consistency pass (block/health.py
        janitor_pass): purge orphaned `.tmp` files (torn writes — never
        acknowledged), bound the `.corrupted` quarantine, and re-enqueue
        every surviving quarantined hash for resync so holes left by a
        crash between quarantine and enqueue are refilled.  Called by
        Garage right after the resync manager is attached."""
        roots = [d.path for d in self.data_layout.data_dirs]
        summary = janitor_pass(
            roots,
            max_quarantine_files=getattr(
                self.config, "quarantine_max_files", 128),
            max_quarantine_bytes=getattr(
                self.config, "quarantine_max_bytes", 256 << 20),
        )
        requeue = summary.get("requeue", [])
        if self.resync is not None:
            for hb in requeue:
                self.resync.put_to_resync(Hash(hb), 1.0, source="janitor")
        if summary["tmp_purged"] or summary["quarantine_purged"] or requeue:
            logger.info(
                "startup janitor: purged %d orphaned .tmp, pruned %d "
                "quarantined files (kept %d), requeued %d hashes for "
                "resync", summary["tmp_purged"],
                summary["quarantine_purged"], summary["quarantine_kept"],
                len(requeue))
        return summary

    def _lock_for(self, h: Hash) -> asyncio.Lock:
        return self._locks[h[0] % MUTEX_SHARDS]

    # --- local read/write (ref manager.rs:478-590,689-784) ---

    def _span(self, op: str, h: Hash):
        """Per-block-op tracing span (ref block/manager.rs:492-501);
        without a trace_sink this is a timing-only lite span feeding the
        always-on slow-op log."""
        return self.system.tracer.span(
            f"Block {op}", block=bytes(h).hex()[:16], op=op
        )

    def note_heal(self, source: str) -> None:
        """Record one completed block heal.  Called from every path that
        re-materializes a lost/corrupt copy; the per-source split is
        what makes 'which mechanism actually healed it' a
        measurement."""
        self.heal_counts[source] = self.heal_counts.get(source, 0) + 1
        if self.m_heal is not None:
            self.m_heal.inc(source=source)

    # --- repair-bandwidth accounting (planner + legacy gather) ---

    def note_repair_fetch(self, mode: str, n: int) -> None:
        """`n` wire bytes fetched for reconstruction under `mode`
        (ppr | shard | gather)."""
        self.repair_fetch_bytes[mode] = (
            self.repair_fetch_bytes.get(mode, 0) + n)
        if self.m_repair_fetch is not None:
            self.m_repair_fetch.inc(n, mode=mode)

    def note_repair_done(self, n: int) -> None:
        self.repair_repaired_bytes += n
        if self.m_repair_repaired is not None:
            self.m_repair_repaired.inc(n)

    def note_repair_overfetch(self, n: int) -> None:
        self.repair_overfetch_bytes += n
        if self.m_repair_overfetch is not None:
            self.m_repair_overfetch.inc(n)

    def note_repair_hedge(self) -> None:
        self.repair_hedges += 1
        if self.m_repair_hedge is not None:
            self.m_repair_hedge.inc()

    def note_repair_ppr_fallback(self) -> None:
        self.repair_ppr_fallbacks += 1
        if self.m_repair_ppr_fb is not None:
            self.m_repair_ppr_fb.inc()

    def note_repair_replan(self, reason: str) -> None:
        self.repair_replans[reason] = self.repair_replans.get(reason, 0) + 1
        if self.m_repair_replan is not None:
            self.m_repair_replan.inc(reason=reason)

    def note_repair_tree(self, depth: int) -> None:
        self.repair_tree_depth_last = int(depth)

    def is_parity_block(self, h: Hash) -> bool:
        """Was this hash ever stored here as a distributed-parity shard?"""
        return self._parity_marks.get(bytes(h)) is not None

    def is_assigned(self, h: Hash) -> bool:
        """Is this node in the block's data replica set?  (With
        data_replication_mode < replication_mode, the block_ref/rc
        partition holds rc on nodes the data ring does NOT assign.)"""
        return any(bytes(n) == bytes(self.system.id)
                   for n in self.replication.write_nodes(h))

    async def write_block(self, h: Hash, data: DataBlock,
                          is_parity: bool = False) -> None:
        with self._span("write", h), maybe_time(self.m_write_dur):
            if is_parity and not self.is_parity_block(h):
                self._parity_marks.insert(bytes(h), b"1")
            with_parity = is_parity or self.is_parity_block(h)
            async with self._lock_for(h):
                wrote = await asyncio.to_thread(
                    self._write_block_sync, h, data
                )
            if wrote and self.write_parity is not None and not with_parity:
                # write-time RS: the block joins an in-progress codeword;
                # encoding happens off this path (see WriteParityAccumulator).
                # Parity blocks themselves are excluded — wrapping parity
                # into further codewords would cascade encode rounds
                # across the cluster for no durability the decode can use.
                self.write_parity.add(h, data)

    def _write_block_sync(self, h: Hash, data: DataBlock) -> bool:
        root = self.data_layout.primary_dir(h)
        final = self.block_path(root, h, data.compressed)
        existing = self.find_block(h)
        if existing is not None:
            path, compressed = existing
            if compressed or not data.compressed:
                # an equal-or-better copy exists (compressed preferred):
                # keep it (ref manager.rs:717-735 dedupe).  Checked
                # BEFORE the health preflight — a degraded node that
                # already holds the block should acknowledge the PUT,
                # not reject data it has.
                return False
        # preflight: free-space watermark + error-streak breaker; raises
        # the typed StorageFull/StorageError the write quorum routes
        # around.  May consume the half-open probe slot — the outcome
        # below MUST be reported back (note_ok / note_error).
        self.health.check_writable(root, len(data.inner))
        try:
            d = os.path.dirname(final)
            os.makedirs(d, exist_ok=True)
            tmp = final + ".tmp"
            # O_DIRECT (buffered fallback inside): ~4x less CPU than the
            # page-cache copy and immune to dirty-page throttling, so
            # concurrent puts overlap their writes on a 1-core host; the
            # bulk of the block is on media at return even with
            # data_fsync=false (see utils/direct_io.py)
            self.disk.write_file(tmp, data.inner, fsync=self.data_fsync)
            self.disk.replace(tmp, final)
            if self.data_fsync:
                # fsync the directory so the rename is durable
                # (manager.rs:760-775)
                self.disk.fsync_dir(d)
        except OSError as e:
            # a failed write's tmp is deliberately LEFT BEHIND, exactly
            # as a crash would leave it: the path is deterministic (one
            # stale tmp per block at most, reclaimed by the next write's
            # truncate or the startup janitor), and cleanup attempts on
            # a disk that just errored tend to error too
            self.health.note_error(root, "write", e)
            cls = StorageFull if e.errno == _errno.ENOSPC else StorageError
            raise cls(f"block write failed on {root}: {e}") from e
        self.health.note_ok(root, "write")
        # a freshly-written good copy clears the hash's read backoff
        self._disk_errors.pop(bytes(h), None)
        if existing is not None and existing[0] != final:
            # plain copy superseded by compressed one
            try:
                self.disk.remove(existing[0])
            except OSError:
                pass
        self.bytes_written += len(data.inner)
        # overwrite: the on-disk form changed (fresh copy / compressed
        # upgrade) — drop any device pages so the pool re-adopts from
        # the new copy rather than trusting a page for a superseded one
        self.pool_invalidate(h, "overwrite")
        return True

    async def read_block(self, h: Hash) -> DataBlock:
        """Read + verify; on corruption move the file aside and requeue a
        resync so a good copy is re-fetched (ref manager.rs:528-590)."""
        with self._span("read", h), maybe_time(self.m_read_dur):
            return await self._read_block_inner(h)

    async def _read_block_inner(self, h: Hash) -> DataBlock:
        hb = bytes(h)
        ec = self._disk_errors.get(hb)
        if ec is not None and ec.next_try() > now_msec():
            # the local copy recently EIO'd and is in backoff: fail over
            # to peers immediately instead of re-hitting the bad sector
            raise NoSuchBlock(
                f"block {hb.hex()[:16]} local copy in disk-error backoff")
        found = self.find_block(h)
        if found is None:
            raise NoSuchBlock(f"block {hb.hex()[:16]} not found locally")
        path, compressed = found
        try:
            raw = await asyncio.to_thread(self.disk.read_file, path)
        except FileNotFoundError:
            # NOT a disk fault: the file vanished between find_block and
            # the read — a benign race with delete_if_unneeded / stray
            # cleanup.  Plain miss, no health/quarantine side effects
            # (8 such races must never flip a healthy root read-only).
            raise NoSuchBlock(
                f"block {hb.hex()[:16]} removed concurrently")
        except OSError as e:
            if not is_media_error(e):
                # process-level resource pressure (EMFILE/ENOMEM/…): the
                # bytes on disk are fine — fail over to a replica but
                # destroy nothing and keep the root's streak clean, or a
                # busy node would mass-quarantine its own healthy data
                logger.warning("transient read error on block %s at %s "
                               "(errno %s: %s)", hb.hex()[:16], path,
                               e.errno, e)
                raise NoSuchBlock(
                    f"block {hb.hex()[:16]} local read failed "
                    f"transiently: {e}") from e
            # read-time disk error (EIO, remount-ro, truncated dir):
            # quarantine the unreadable copy, arm the per-hash backoff,
            # enqueue a refetch, and surface NoSuchBlock so every caller
            # — the get_block RPC handler, the streaming failover loop —
            # transparently moves to the next replica instead of handing
            # the client an OSError
            root = self._root_of(path)
            self.health.note_error(root, "read", e)
            self._note_disk_error(h)
            logger.error("disk read error on block %s at %s "
                         "(errno %s: %s)", hb.hex()[:16], path, e.errno, e)
            self.pool_invalidate(h, "quarantine")
            await asyncio.to_thread(self.quarantine_path, path)
            if self.resync is not None:
                self.resync.put_to_resync(h, 0.0, source="disk_error")
            raise NoSuchBlock(
                f"block {hb.hex()[:16]} local copy unreadable: {e}") from e
        block = DataBlock(raw, compressed)
        try:
            await self._verify_block(h, block)
        except CorruptData:
            self.corruptions += 1
            logger.error("corrupted block %s at %s", hb.hex()[:16], path)
            self.pool_invalidate(h, "quarantine")
            await asyncio.to_thread(self.quarantine_path, path)
            if self.resync is not None:
                self.resync.put_to_resync(h, 0.0, source="corrupt_read")
            raise
        self.health.note_ok(self._root_of(path), "read")
        self._disk_errors.pop(hb, None)
        self.bytes_read += len(raw)
        return block

    async def _verify_block(self, h: Hash, block: DataBlock) -> None:
        """Read-path verify.  Plain blocks route their content hash
        through the codec feeder when one is armed (the ROADMAP feeder
        follow-through: until now only PUT hash / parity encode /
        degraded decode rode it): K concurrent GET verifies coalesce
        into one ragged multi-buffer hash pass, while the in-flight
        request hint keeps a lone read dispatching immediately — no SLO
        tax on solo p50.  Compressed blocks keep the inline zstd
        frame-checksum check, and a closed/absent feeder degrades to the
        pre-feeder inline verify."""
        if self.feeder is not None and not block.compressed:
            with self.feeder.request_scope() as feeder:
                got = await feeder.hash_async(
                    [block.inner], peers=feeder.inflight_requests or None)
            if bytes(got[0]) != bytes(h):
                raise CorruptData(
                    f"hash mismatch for block {bytes(h).hex()[:16]}")
            return
        block.verify(h, self.hash_algo, codec=self.codec)

    async def delete_if_unneeded(self, h: Hash) -> None:
        """Delete the local copy if rc says it's deletable (resync path,
        ref resync.rs:431-455).  Deliberately NO cluster-wide side
        effects here: local deletion also happens during migration and
        offload, which says nothing about the block's global liveness
        (the distributed-parity GC listens to the block_ref table's
        global deletion signal instead)."""
        async with self._lock_for(h):
            if not self.rc.get(h).is_deletable():
                return
            # strict pool invalidation BEFORE the copy disappears: a
            # deleted block must not survive as a servable device page
            self.pool_invalidate(h, "delete")
            while True:
                found = self.find_block(h)
                if found is None:
                    break
                await asyncio.to_thread(self.disk.remove, found[0])
            self.rc.clear_deleted_block_rc(h)

    # --- refcounting entry points (called from table updated() hooks) ---

    def block_incref(self, tx, h: Hash) -> None:
        if self.rc.block_incref(tx, h):
            # 0→1: we might not have the block yet — check after commit
            if self.resync is not None:
                def _after_commit():
                    # a ref landing after a node loss (table sync lags
                    # the ring change) re-arms the rebuild walk for its
                    # partition, so the planned flow — not a one-off
                    # resync — heals it
                    rb = getattr(self.resync, "rebuild", None)
                    if rb is not None:
                        rb.note_ref(h)
                    self.resync.put_to_resync(h, 2.0, source="incref")
                tx.on_commit(_after_commit)

    def block_decref(self, tx, h: Hash) -> None:
        if self.rc.block_decref(tx, h):
            # reached zero: schedule deletion check after the GC delay —
            # unless this node is no longer ring-assigned the block (a
            # layout change moved it away; the decref is the block_ref
            # partition offloading).  Waiting the full delay there left
            # sole-copy blocks (data replication "none") unreadable for
            # 10 minutes after a node left the layout; the prompt resync
            # offers the block to its new owners and only deletes once
            # they all confirm possession (resync migration branch).
            if self.resync is not None:
                from .rc import BLOCK_GC_DELAY_MS

                delay = BLOCK_GC_DELAY_MS / 1000.0
                if not self.is_assigned(h):
                    delay = 2.0
                tx.on_commit(lambda: self.resync.put_to_resync(
                    h, delay, source="decref"))

    # --- RPC client side ---

    async def _heal_after_decode(self, h: Hash, data: bytes) -> None:
        """Write a decode-recovered block back to its replica set (the
        read-path RS fallback's repair half).  skip_ec: the block
        PROVABLY has parity coverage — the decode that produced `data`
        just consumed it — so re-wrapping it into a fresh codeword
        would leak duplicate parity on every degraded read."""
        try:
            with self.system.tracer.span(
                "Block heal", block=bytes(h).hex()[:16], source="writeback"
            ):
                await self.rpc_put_block(h, data, skip_ec=True)
            self.note_heal("writeback")
        except Exception:  # noqa: BLE001 — repair is best-effort
            logger.warning("post-decode heal of %s failed",
                           bytes(h).hex()[:16], exc_info=True)

    def drain_heals(self) -> None:
        """Cancel in-flight post-decode heals and refuse new ones
        (shutdown path: the RPC layer is about to close under them; the
        resync entry queued alongside each heal is persistent and
        finishes the job on the next boot).  The refusal flag closes
        the window where a GET suspended inside the decode fallback
        resumes AFTER this drain and would spawn a fresh heal against
        the closing transport."""
        self._heals_closed = True
        for t in list(self._heal_tasks):
            t.cancel()
        self._heal_tasks.clear()

    async def rpc_put_block(self, h: Hash, data: bytes,
                            is_parity: bool = False,
                            skip_ec: bool = False) -> None:
        """Compress + quorum-write to the block's replica set
        (ref manager.rs:356-377).  is_parity marks distributed-parity
        shards so receiving nodes don't wrap them into codewords of
        their own."""
        who = self.replication.write_nodes(h)
        # re-sends of a shard this node stored as parity (resync offload,
        # repair re-push) must carry the flag even when the caller
        # doesn't know the provenance
        is_parity = is_parity or self.is_parity_block(h)
        block = await asyncio.to_thread(
            DataBlock.from_buffer, data, self.compression_level
        )
        from ..rpc.rpc_helper import RequestStrategy

        async def send(node, timeout):
            msg = {"t": "put_block", "h": bytes(h),
                   "hdr": block.header().pack()}
            if is_parity:
                msg["parity"] = True
            await self.endpoint.call(
                node,
                msg,
                prio=PRIO_NORMAL,
                timeout=timeout,
                body=_chunks(block.inner),
            )
            return node

        await self.system.rpc.try_call_many(
            self.endpoint,
            who,
            None,
            RequestStrategy(
                rs_quorum=self.replication.write_quorum(),
                rs_timeout=self.block_rpc_timeout,
                # the timeout covers the whole (bandwidth-bound) body
                # transfer — an RTT-derived clamp would false-fail large
                # blocks on slow links and feed the breaker; blackhole
                # detection on this path comes from the breaker's other
                # feeders (pings, probe-shaped calls)
                rs_adaptive_timeout=False,
                # hard zone_redundancy: block copies must land in enough
                # distinct failure domains before the PUT acks
                rs_required_zones=self.system.write_zone_requirement(who),
            ),
            make_call=send,
        )
        if (self.ec_accumulator is not None and not is_parity
                and not skip_ec
                and not self.ec_accumulator.recently_added(h)):
            # writer-side distributed codewords: grouping HERE (not on the
            # storing node) is what spreads a codeword's members across
            # distinct nodes — see WriteParityAccumulator's invariant note.
            # recently_added dedups re-PUTs of identical content, which
            # would otherwise mint a fresh codeword (new gid, new parity
            # blocks, new index rows) for an unchanged block every upload.
            self.ec_accumulator.add(h, block)

    async def rpc_get_block(self, h: Hash, order_tag: Optional[int] = None) -> bytes:
        """Fetch + decompress a block, trying replicas one at a time in
        latency order (ref manager.rs:231-317)."""
        chunks = []
        async for c in self.rpc_get_block_streaming(h, order_tag):
            chunks.append(c)
        return b"".join(chunks)

    async def rpc_get_raw_block(
        self, h: Hash, order_tag: Optional[int] = None,
        for_storage: bool = False, idempotent: bool = False,
    ) -> DataBlock:
        """Fetch one block as a storable DataBlock.  Rides the SAME
        streaming failover path as the GET plane — mid-transfer node
        death resumes from the next replica at the delivered offset
        (raw offsets are not comparable across replicas, which may hold
        different encodings, so failover happens in the decompressed
        domain).  With for_storage, the result is re-compressed so a
        resynced/repaired copy keeps the storage economics of the
        original."""
        meta: dict = {}
        chunks = []
        # a copy for storage (resync) skips the read path's last-resort
        # decode: resync's own ladder runs after a failed fetch — the
        # migration-aware peer sweep (one copy) before the codeword
        # decode (k pieces) — and a row that merely moved to this node
        # must be copied from the live node that holds it, not decoded
        async for c in self.rpc_get_block_streaming(h, order_tag,
                                                    meta_out=meta,
                                                    idempotent=idempotent,
                                                    decode=not for_storage):
            chunks.append(c)
        data = b"".join(chunks)
        if for_storage:
            raw = meta.get("raw_chunks")
            if raw is not None:
                # whole block arrived from one replica: store the wire
                # bytes as received — zero codec work (re-compressing
                # every resynced block would tax whole-node rebuilds)
                return DataBlock(b"".join(raw),
                                 compressed=bool(meta.get("compressed")),
                                 parity=bool(meta.get("parity")))
            block = await asyncio.to_thread(
                DataBlock.from_buffer, data, self.compression_level
            )
            return DataBlock(block.inner, block.compressed,
                             parity=bool(meta.get("parity")))
        return DataBlock(data, compressed=False,
                         parity=bool(meta.get("parity")))

    async def rpc_get_block_streaming(
        self, h: Hash, order_tag: Optional[int] = None,
        meta_out: Optional[dict] = None, idempotent: bool = False,
        decode: bool = True,
    ) -> AsyncIterator[bytes]:
        """Async-iterate a block's DECOMPRESSED bytes with mid-transfer
        node failover: if the serving node dies mid-stream, the read
        resumes from the next replica, skipping the bytes already
        delivered (ref manager.rs:231-345 + the get-path streaming of
        get.rs:432-512).  Memory stays bounded by the transport chunk
        size — the block is never buffered whole.

        ``idempotent`` grants the whole fan-out ONE shared budget of
        ``retry_max`` full-jitter retries on TRANSPORT errors (same
        shared-budget semantics as RpcHelper: per-node budgets would
        multiply load during a correlated network failure), spent on
        same-node retries before failing over — safe for pure fetches:
        resync refetch, repair.  A GET already delivering a body to a
        client keeps single-attempt-per-node failover semantics, since
        the delivered-offset skip makes a same-node retry redundant with
        just trying the next replica."""
        from ..net.resilience import full_jitter_backoff, is_transport_error

        rpc = self.system.rpc
        who = rpc.request_order(self.replication.read_nodes(h))
        delivered = 0
        errors = []
        attempts_left = rpc.tunables.retry_max if idempotent else 0
        for node in who:
            # the streaming failover loop IS this path's retry/hedge
            # mechanism; it still consults the resilience layer so an
            # open-breaker replica fast-fails to the next copy and a
            # known-RTT replica gets the clamped adaptive timeout
            attempt = 0
            while True:
                if not rpc.peer_allows(node):
                    errors.append(f"{bytes(node).hex()[:8]}: breaker open")
                    break
                try:
                    # the transport timeout covers only time-to-response-
                    # header; the same (adaptive) budget is reused below
                    # as a PER-CHUNK inactivity deadline, because a peer
                    # that blackholes mid-stream keeps the connection
                    # "up" while bytes stop — without a chunk deadline
                    # the read hangs forever and the per-replica failover
                    # never runs
                    node_timeout = rpc.timeout_for(node,
                                                   self.block_rpc_timeout)
                    resp, stream = await self.endpoint.call_streaming(
                        node,
                        {"t": "get_block", "h": bytes(h), "order": order_tag},
                        prio=PRIO_NORMAL,
                        timeout=node_timeout,
                    )
                    if resp.get("err"):
                        raise NoSuchBlock(resp["err"])
                    compressed = DataBlockHeader.unpack(
                        resp["hdr"]).compressed
                    if meta_out is not None:
                        meta_out["parity"] = bool(resp.get("parity"))
                        meta_out["compressed"] = compressed
                        # wire frames as received: valid for storage as
                        # long as no failover stitched two replicas'
                        # (possibly differently-encoded) streams together
                        meta_out["raw_chunks"] = \
                            [] if delivered == 0 else None
                    decomp = None
                    if compressed:
                        from ..utils.zstd_compat import zstandard

                        decomp = zstandard.ZstdDecompressor().decompressobj()
                    skip = delivered
                    try:
                        if stream is not None:
                            it = stream.__aiter__()
                            while True:
                                try:
                                    chunk = await asyncio.wait_for(
                                        it.__anext__(), node_timeout)
                                except StopAsyncIteration:
                                    break
                                if (meta_out is not None
                                        and meta_out.get("raw_chunks")
                                        is not None):
                                    meta_out["raw_chunks"].append(
                                        bytes(chunk))
                                out = (decomp.decompress(chunk)
                                       if decomp else chunk)
                                if not out:
                                    continue
                                if skip:
                                    if len(out) <= skip:
                                        skip -= len(out)
                                        continue
                                    out = out[skip:]
                                    skip = 0
                                delivered += len(out)
                                self.bytes_read += len(out)
                                yield out
                    finally:
                        # abandoning mid-stream (consumer closed this
                        # generator, node failover, decompress error)
                        # must cancel the sender's pump, or it parks in
                        # its credit window until the connection dies;
                        # no-op after full consumption
                        if stream is not None:
                            await stream.aclose()
                    rpc.note_result(node, None)
                    return
                except (asyncio.CancelledError, GeneratorExit):
                    # consumer went away mid-fetch (client disconnect,
                    # task cancel): release the breaker's half-open probe
                    # slot if peer_allows granted it — no verdict on the
                    # peer, and a leaked slot would fast-fail the peer
                    # for a full cooldown
                    rpc.note_result(node, asyncio.CancelledError())
                    raise
                except Exception as e:
                    # ANY per-replica failure fails over to the next
                    # replica — a malformed header (version skew) or a
                    # corrupt zstd frame from one node must not mask a
                    # healthy copy one hop away (ref manager.rs:231-317
                    # tries each in turn)
                    rpc.note_result(node, e)
                    errors.append(f"{bytes(node).hex()[:8]}: {e}")
                    if meta_out is not None and delivered > 0:
                        meta_out["raw_chunks"] = None  # stitched frames
                    if attempts_left > 0 and is_transport_error(e):
                        attempts_left -= 1
                        if rpc.m_retries is not None:
                            from ..utils.error import error_code

                            rpc.m_retries.inc(endpoint=self.endpoint.path,
                                              reason=error_code(e))
                        await asyncio.sleep(full_jitter_backoff(
                            attempt, rpc.tunables, rpc._rng))
                        attempt += 1
                        continue
                    break
        # LAST RESORT, only from a clean start (stitching decoded bytes
        # after a partial replica stream would need offset bookkeeping
        # for no real case): every replica failed — decode the block
        # from the distributed RS parity RIGHT NOW so the client's read
        # succeeds, and requeue a resync so the copy is re-materialized
        # (the reference's only answer here is "another replica",
        # ref manager.rs:231-317; erasure coverage is this framework's
        # addition).  `decode=False` leaves the caller to its own ladder.
        if delivered == 0 and decode:
            data = None
            if self.parity_reconstructor is not None:
                try:
                    data = await self.parity_reconstructor(h)
                except Exception as e:  # noqa: BLE001 — degraded decode
                    errors.append(f"parity-decode: {e}")
                    data = None
                if data is not None:
                    logger.info("served block %s via distributed RS decode "
                                "(all replicas failed)", bytes(h).hex()[:16])
            if data is None and self.parity_store is not None:
                # final rung of the degraded-read ladder: the LOCAL RS
                # parity sidecar.  Reachable when the local copy EIO'd
                # (read failover quarantined it) and every replica is
                # down — the sidecar decode needs only surviving local
                # codeword members, zero network.
                try:
                    data = await asyncio.to_thread(
                        self.parity_store.try_reconstruct, h)
                except Exception as e:  # noqa: BLE001 — degraded decode
                    errors.append(f"local-sidecar: {e}")
                    data = None
                if data is not None:
                    logger.info("served block %s via LOCAL RS sidecar "
                                "(all replicas failed)", bytes(h).hex()[:16])
            if data is not None:
                self.blocks_reconstructed += 1
                if meta_out is not None:
                    meta_out["parity"] = False
                    meta_out["compressed"] = False
                    meta_out["raw_chunks"] = None
                if self.resync is not None:
                    self.resync.put_to_resync(h, 0.0,
                                              source="degraded_read")
                # re-materialize the lost copy THROUGH THE WRITE PATH in
                # the background: config-agnostic (in split meta/data
                # rings the data holder may carry no rc row, so a
                # resync-side heal has no local signal to act on), and
                # the normal dedupe makes it idempotent.  One heal per
                # hash at a time: N concurrent degraded reads of a hot
                # lost block must not spawn N identical quorum writes.
                if (bytes(h) not in self._heal_in_flight
                        and not self._heals_closed):
                    self._heal_in_flight.add(bytes(h))
                    task = asyncio.get_running_loop().create_task(
                        self._heal_after_decode(h, data))
                    self._heal_tasks.add(task)

                    def _done(t, hb=bytes(h)):
                        self._heal_tasks.discard(t)
                        self._heal_in_flight.discard(hb)

                    task.add_done_callback(_done)
                self.bytes_read += len(data)
                for i in range(0, len(data), STREAM_CHUNK):
                    yield data[i:i + STREAM_CHUNK]
                return
        raise GarageError(
            f"could not stream block {bytes(h).hex()[:16]} from any node "
            f"(delivered {delivered} bytes): {errors}"
        )

    async def need_block(self, h: Hash, drain: bool = False) -> bool:
        """Do we need a copy of this block? (ring-assigned + rc>0 but no
        local file; the assignment check keeps rc holders outside the
        data ring — possible when data_replication_mode differs — from
        accumulating copies).  A read-only/failed primary root answers
        False: soliciting a block offer the subsequent put would reject
        with StorageFull only wastes the offerer's bandwidth.  A root
        whose breaker cooldown has elapsed (half-open) answers True —
        the solicited push doubles as the probe write that walks the
        root back to ok.

        ``drain``: the prober is a freshly un-assigned holder whose OWN
        rc is still live — right after a layout change our refs are as
        stale as its assignment, so accept on ring assignment alone
        (the prober's refs vouch for the block; ours arrive with table
        sync, and a push that outlives its object is ordinary stray GC).
        Without this, a zone drain's data motion waits on metadata
        migration instead of riding the paced rebalance mover."""
        return ((self.rc.get(h).is_needed() or drain)
                and not self.is_block_present(h)
                and self.is_assigned(h)
                and self.health.writable(self.data_layout.primary_dir(h)))

    async def sweep_get_block(self, h: Hash,
                              try_ring: bool = True) -> Optional[bytes]:
        """Migration-aware block fetch: own store → ring placement →
        EVERY other alive peer.  Returns verified plain bytes or None.

        After an abrupt layout change the sole copy of a block (data
        replication "none") can sit on a node the NEW ring no longer
        lists for it, while the holder's rc is still positive (its
        block_ref partition hasn't offloaded yet) so the holder won't
        push either — the ring fetch alone would deadlock availability
        until the metadata migration completes.  The reference sidesteps
        this by draining removed nodes before they leave; here layout
        changes are instant and the PULLER does the finding.  O(cluster)
        worst case — callers are repair paths, where completeness beats
        elegance.  Liveness ORDERS the sweep (likely-up peers first) but
        never vetoes it: is_up is a stale hint, and skipping a reachable
        holder turns recoverable data into loss."""
        from ..utils.data import block_hash

        raw = None
        if self.is_block_present(h):
            try:
                block = await self.read_block(h)
                raw = await asyncio.to_thread(block.decompressed)
            except Exception:
                raw = None
        if raw is not None and bytes(
                block_hash(raw, self.hash_algo)) == bytes(h):
            return raw
        raw, parity = None, False
        try:
            if not try_ring:
                # caller just failed a full ring fetch (resync fallback);
                # re-paying that timeout chain per missing block would
                # double degraded-repair latency
                raise GarageError("ring fetch skipped by caller")
            raw = await self.rpc_get_block(h)
        except Exception as ring_err:
            ring_nodes = {bytes(x) for x in self.replication.read_nodes(h)}
            tried = []
            peers = sorted(
                self.system.peering.peers.items(),
                key=lambda kv: not kv[1].is_up,
            )
            for nid, _st in peers:
                if bytes(nid) in ring_nodes:
                    continue
                try:
                    # adaptive per-peer timeout keeps the O(cluster) walk
                    # cheap past slow peers; no breaker veto (see above —
                    # a stale "broken" verdict must not hide the only copy)
                    resp, stream = await self.endpoint.call_streaming(
                        nid, {"t": "get_block", "h": bytes(h)},
                        timeout=self.system.rpc.timeout_for(
                            nid, self.block_rpc_timeout),
                    )
                    if resp.get("err") or stream is None:
                        tried.append(f"{bytes(nid).hex()[:8]}:miss")
                        continue
                    from .block import DataBlock, DataBlockHeader

                    hdr = DataBlockHeader.unpack(resp["hdr"])
                    # whole-body deadline: a peer blackholing mid-stream
                    # must cost one timeout, not hang the sweep forever
                    try:
                        body = await asyncio.wait_for(
                            stream.read_all(), self.block_rpc_timeout)
                    except BaseException:
                        await stream.aclose()  # stop the sender's pump
                        raise
                    raw = DataBlock(body, hdr.compressed).decompressed()
                    parity = bool(resp.get("parity"))
                    break
                except Exception as e:
                    tried.append(f"{bytes(nid).hex()[:8]}:{type(e).__name__}")
                    continue
            if raw is None:
                logger.info(
                    "sweep fetch of %s failed everywhere: ring=%s; "
                    "sweep=%s", bytes(h).hex()[:12], ring_err, tried)
        if raw is None:
            return None
        if bytes(block_hash(raw, self.hash_algo)) != bytes(h):
            logger.warning("sweep fetch of %s: hash mismatch",
                           bytes(h).hex()[:12])
            return None
        if parity and not self.is_parity_block(h):
            # the holder stored it as a distributed-parity shard: a copy
            # resync writes from these bytes must stay out of the
            # codeword accumulators and the scrub's coverage refresh too
            self._parity_marks.insert(bytes(h), b"1")
        return raw

    async def drop_stray_copy(self, h: Hash) -> None:
        """Physically delete a local copy this node is NOT assigned —
        migration cleanup, called by resync only after every assigned
        node confirmed possession.  Unlike delete_if_unneeded this does
        not wait out the rc GC delay: the copies exist where the ring
        wants them, so the stray is redundant regardless of timers.  A
        freshly-arrived local ref (rc>0 again) vetoes, to be safe."""
        async with self._lock_for(h):
            if self.rc.get(h).is_needed() or self.is_assigned(h):
                return
            # rebalance-drop: evict the device pages before the copy
            # goes (strict pool invalidation, synchronous pre-ack)
            self.pool_invalidate(h, "rebalance")
            while True:
                found = self.find_block(h)
                if found is None:
                    break
                await asyncio.to_thread(self.disk.remove, found[0])
            # also drop the Deletable{at_time} rc row: nothing would
            # ever clear it for a departed block (clear_deleted_block_rc
            # only fires from delete_if_unneeded after the timer), and a
            # phantom row inflates rc_len and re-enqueues a no-op resync
            # on every `repair blocks` pass forever
            self.rc.clear_stray_rc(h)

    # --- RPC server side (ref manager.rs:671-687) ---

    async def _handle(self, remote, msg, body):
        t = msg.get("t")
        if t == "put_block":
            h = Hash(bytes(msg["h"]))
            hdr = DataBlockHeader.unpack(msg["hdr"])
            raw = await body.read_all() if body is not None else b""
            await self.write_block(h, DataBlock(raw, hdr.compressed),
                                   is_parity=bool(msg.get("parity")))
            return {"ok": True}, None
        if t == "get_block":
            h = Hash(bytes(msg["h"]))
            try:
                block = await self.read_block(h)
            except (NoSuchBlock, CorruptData) as e:
                # a serving miss is a REPAIR SIGNAL: if this node is
                # assigned the block and its refs say it should exist, a
                # silently-vanished file (disk mishap — nothing walked
                # it since the scrub walker only sees files that exist)
                # would otherwise stay lost until the next offline
                # repair; the resync chain (replica fetch → peer sweep →
                # RS decode) knows how to rebuild it
                if (self.resync is not None
                        and self.rc.get(h).is_needed()
                        and self.is_assigned(h)
                        and not self.is_block_present(h)):
                    self.resync.put_to_resync(h, 0.0, source="serve_miss")
                return {"err": str(e)}, None
            hdr = {"hdr": block.header().pack()}
            if self.is_parity_block(h):
                hdr["parity"] = True
            return hdr, _chunks(block.inner)
        if t == "need_block":
            h = Hash(bytes(msg["h"]))
            # "present" lets a departing holder learn when every assigned
            # node has a copy, unlocking prompt stray deletion (see
            # resync._resync_block_inner migration branch)
            return {"needed": await self.need_block(
                        h, drain=bool(msg.get("drain"))),
                    "present": self.is_block_present(h)}, None
        if t == "ppr":
            # partial-parallel repair: multiply the LOCAL shard by the
            # decode coefficient in GF(256) and ship the partial product
            # truncated to the target row's length — one sub-shard-sized
            # result per survivor link instead of the whole piece, and
            # the coordinator only XOR-accumulates (block/repair_plan.py;
            # docs/ROBUSTNESS.md "Repair bandwidth")
            h = Hash(bytes(msg["h"]))
            try:
                block = await self.read_block(h)
            except (NoSuchBlock, CorruptData) as e:
                # same serve-miss repair signal as get_block: a vanished
                # assigned piece re-enters the resync chain
                if (self.resync is not None
                        and self.rc.get(h).is_needed()
                        and self.is_assigned(h)
                        and not self.is_block_present(h)):
                    self.resync.put_to_resync(h, 0.0, source="serve_miss")
                return {"err": str(e)}, None
            coeff = int(msg["coeff"]) & 0xFF
            want = max(0, int(msg["len"]))
            is_par = bool(msg.get("parity"))

            def _partial():
                raw = block.decompressed()
                if is_par:
                    from .parity import unpack_parity_shard

                    shard = unpack_parity_shard(raw)
                    if shard is None:
                        return None
                else:
                    shard = raw
                # coefficient-multiply through the codec's GF kernel
                # (native GFNI when built, numpy log/exp tables else)
                return self.codec.gf_scale(coeff, shard, want)

            part = await asyncio.to_thread(_partial)
            if part is None:
                return {"err": "not a parity shard"}, None
            return {"n": len(part)}, _chunks(part)
        if t == "ppr_tree":
            # tree-aggregated PPR: serve OWN pieces as GF(256) partial
            # products, recursively collect the children's aggregated
            # streams, XOR everything into one accumulator per target
            # row, and forward a single stream upward — so the
            # coordinator's ingress stays flat in k (repair_plan.py
            # `_run_tree`; docs/ROBUSTNESS.md "Full-node rebuild")
            wants = [max(0, int(w)) for w in msg.get("want") or []]
            plan = msg.get("plan") or {}
            if not wants:
                return {"err": "empty want list"}, None
            self.note_repair_tree(_tree_depth(plan))
            buf, got, miss = await self._serve_ppr_tree(plan, wants)
            return {"n": len(buf), "got": got, "miss": miss}, _chunks(buf)
        raise GarageError(f"unknown block rpc {t!r}")

    async def _serve_ppr_tree(self, plan: dict, wants: list):
        """One level of the repair aggregation tree.  Returns
        (concatenated per-target accumulator rows, contributed piece
        indexes, missing piece indexes).  A dead child is NOT fatal:
        its whole subtree lands on the miss list and the coordinator
        re-fetches those pieces flat (subtree re-plan, never a
        codeword abort)."""
        import numpy as np

        accs = [np.zeros(w, dtype=np.uint8) for w in wants]
        got: list = []
        miss: list = []

        def _xor(payload: bytes, coeffs) -> None:
            for a, w, c in zip(accs, wants, coeffs):
                c = int(c) & 0xFF
                if not c or not w:
                    continue
                data = self.codec.gf_scale(c, payload, w)
                if data:
                    arr = np.frombuffer(data, dtype=np.uint8)
                    a[: len(arr)] ^= arr

        for ent in plan.get("p") or []:
            hb, is_par, coeffs, idx = ent[0], ent[1], ent[2], int(ent[3])
            h = Hash(bytes(hb))
            try:
                block = await self.read_block(h)
            except (NoSuchBlock, CorruptData):
                # same serve-miss repair signal as get_block/ppr
                if (self.resync is not None
                        and self.rc.get(h).is_needed()
                        and self.is_assigned(h)
                        and not self.is_block_present(h)):
                    self.resync.put_to_resync(h, 0.0, source="serve_miss")
                miss.append(idx)
                continue

            def _shard(block=block, is_par=is_par):
                raw = block.decompressed()
                if is_par:
                    from .parity import unpack_parity_shard

                    return unpack_parity_shard(raw)
                return raw

            shard = await asyncio.to_thread(_shard)
            if shard is None:
                miss.append(idx)
                continue
            await asyncio.to_thread(_xor, shard, coeffs)
            got.append(idx)

        async def _child(cnode, sub):
            node = FixedBytes32(bytes(cnode))
            depth = _tree_depth(sub)
            try:
                resp, stream = await self.endpoint.call_streaming(
                    node, {"t": "ppr_tree", "plan": sub,
                           "want": [int(w) for w in wants]},
                    prio=PRIO_NORMAL,
                    timeout=self.block_rpc_timeout * max(1, depth))
                if resp.get("err") or stream is None:
                    raise GarageError(
                        resp.get("err") or "empty ppr_tree answer")
                try:
                    body = await asyncio.wait_for(
                        stream.read_all(),
                        self.block_rpc_timeout * max(1, depth))
                except BaseException:
                    await stream.aclose()
                    raise
                if len(body) != sum(wants):
                    raise GarageError("short ppr_tree aggregate")
                return (list(resp.get("got") or []),
                        list(resp.get("miss") or []), body)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — subtree → miss list
                logger.debug("ppr_tree child %s failed: %s",
                             bytes(cnode).hex()[:8], e)
                return None

        children = plan.get("c") or []
        if children:
            answers = await asyncio.gather(
                *[_child(cnode, sub) for cnode, sub in children])
            for (cnode, sub), ans in zip(children, answers):
                if ans is None:
                    miss.extend(_tree_piece_indexes(sub))
                    continue
                cgot, cmiss, body = ans
                # relay ingress: counted as ppr on THIS node, so the
                # cluster-wide wire total still sums to ≈ k partials
                # while the coordinator's "tree" ingress stays one
                # stream
                self.note_repair_fetch("ppr", len(body))
                off = 0
                for a, w in zip(accs, wants):
                    if w:
                        a ^= np.frombuffer(body[off:off + w],
                                           dtype=np.uint8)
                    off += w
                got.extend(int(i) for i in cgot)
                miss.extend(int(i) for i in cmiss)
        buf = b"".join(a.tobytes() for a in accs)
        return buf, got, miss

    # --- introspection ---

    def rc_len(self) -> int:
        return self.rc.rc_len()


def _tree_piece_indexes(plan: dict) -> list:
    """Every piece index carried anywhere in a (sub)tree plan — the
    miss set when a whole child subtree is unreachable."""
    out = [int(p[3]) for p in plan.get("p") or []]
    for _cnode, sub in plan.get("c") or []:
        out.extend(_tree_piece_indexes(sub))
    return out


def _tree_depth(plan: dict) -> int:
    kids = plan.get("c") or []
    return 1 + max((_tree_depth(s) for _n, s in kids), default=0)


async def _chunks(data: bytes) -> AsyncIterator[bytes]:
    for i in range(0, len(data), STREAM_CHUNK):
        yield data[i : i + STREAM_CHUNK]
    if not data:
        return
