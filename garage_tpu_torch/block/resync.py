"""BlockResyncManager — the persistent resync queue and its workers.

Equivalent of reference src/block/resync.rs (SURVEY.md §2.5): a persistent
queue keyed `timestamp(8B BE ms) ‖ hash(32B)` of blocks to re-examine, an
error tree with exponential backoff (60 s × 2^n, capped at 2^6 ≈ 1 h,
resync.rs:38-41), up to MAX_RESYNC_WORKERS concurrent workers throttled by
a Tranquilizer and deduplicated through a shared busy-set (resync.rs:80-86).

resync_block (resync.rs:361-471) is the convergence step:
  - rc = 0 and block on disk  → offer it to replicas that need it
    (NeedBlockQuery), upload to all needy nodes, then delete locally.
  - rc > 0 and block missing  → fetch from a replica and store it.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import time
from typing import Optional, Set

from ..db import Db
from ..db.counted_tree import CountedTree
from ..net.frame import PRIO_BACKGROUND
from ..utils.background import Worker, WorkerState
from ..utils.crdt import now_msec
from ..utils.data import Hash
from ..utils.error import GarageError
from ..utils.migrate import Migrated, pack, unpack
from ..utils.persister import Persister
from ..utils.tranquilizer import Tranquilizer

logger = logging.getLogger("garage_tpu_torch.block.resync")

RESYNC_RETRY_DELAY = 60.0       # ref resync.rs:38
RESYNC_RETRY_MAX_EXP = 6        # ref resync.rs:41 (max 60s * 2^6)
MAX_RESYNC_WORKERS = 8          # ref resync.rs:44
DEFAULT_RESYNC_TRANQUILITY = 2  # ref resync.rs:47


class ErrorCounter:
    """ref resync.rs ErrorCounter: (errors, last_try) with backoff."""

    __slots__ = ("errors", "last_try")

    def __init__(self, errors: int = 0, last_try: int = 0):
        self.errors = errors
        self.last_try = last_try

    @classmethod
    def parse(cls, v: bytes) -> "ErrorCounter":
        e, lt = unpack(v)
        return cls(e, lt)

    def serialize(self) -> bytes:
        return pack([self.errors, self.last_try])

    def delay_ms(self) -> int:
        return int(
            RESYNC_RETRY_DELAY * 1000 * (1 << min(self.errors - 1, RESYNC_RETRY_MAX_EXP))
        )

    def next_try(self) -> int:
        return self.last_try + self.delay_ms()


class ResyncPersistedConfig(Migrated):
    """Persisted resync tunables (ref resync.rs:143-173): survive restarts,
    settable at runtime via `worker set resync-worker-count / -tranquility`."""

    VERSION_MARKER = b"GT01rscfg"

    def __init__(self, n_workers: int = 1,
                 tranquility: int = DEFAULT_RESYNC_TRANQUILITY):
        self.n_workers = n_workers
        self.tranquility = tranquility

    def fields(self):
        return [self.n_workers, self.tranquility]

    @classmethod
    def from_fields(cls, b):
        return cls(*b)


class BlockResyncManager:
    def __init__(self, manager, db: Db,
                 persister: Optional[Persister] = None):
        self.manager = manager
        self.queue = CountedTree(db.open_tree("block_local_resync_queue"))
        self.errors = CountedTree(db.open_tree("block_local_resync_errors"))
        self.busy_set: Set[bytes] = set()
        self.notify = asyncio.Event()
        self.persister = persister
        # fleet rebuild scheduler (block/rebuild.py), wired by the model
        # layer: hashes whose codewords it currently OWNS are skipped by
        # the queue workers and the rebalance mover so a full-node-loss
        # storm never repairs the same block twice (the double-fetch
        # used to surface as overfetch)
        self.rebuild = None
        self.rebuild_skips = 0
        # enqueue attribution: WHO put work on the resync queue.  The
        # blind spot this closes: the
        # bench's fallback kick (a refs-only RepairWorker, source
        # "layout_sweep") was doing the healing attributed to the decode
        # path.  Counting at the enqueue seam makes that one scrape.
        self.enqueue_counts: dict = {}
        m = getattr(manager.system, "metrics", None)
        self.m_enqueue = (m.counter(
            "block_resync_enqueue_total",
            "Resync queue insertions by originating path",
        ) if m is not None else None)
        cfg = (persister.load() if persister is not None else None) \
            or ResyncPersistedConfig()
        self.n_workers = cfg.n_workers
        self.tranquility = cfg.tranquility

    def _persist_config(self) -> None:
        if self.persister is not None:
            self.persister.save(
                ResyncPersistedConfig(self.n_workers, self.tranquility)
            )

    def set_n_workers(self, n: int) -> None:
        n = int(n)
        if not 1 <= n <= MAX_RESYNC_WORKERS:
            raise ValueError(
                f"resync-worker-count must be in [1, {MAX_RESYNC_WORKERS}]"
            )
        self.n_workers = n
        self._persist_config()
        self.notify.set()

    def set_tranquility(self, t: int) -> None:
        t = int(t)
        if t < 0:
            raise ValueError("resync-tranquility must be >= 0")
        self.tranquility = t
        self._persist_config()

    # --- queue management (ref resync.rs:88-260) ---

    def put_to_resync(self, h: Hash, delay_secs: float,
                      source: str = "other") -> None:
        """`source` labels the originating path (incref, corrupt_read,
        degraded_read, serve_miss, scrub_corrupt, layout_sweep,
        disk_error = read-path EIO failover, janitor = boot-time
        quarantine requeue, rebuild = hashes the fleet rebuild
        scheduler parked after exhausting its own attempts, …) for the
        enqueue-attribution counter;
        internal requeues/backoffs use put_to_resync_at directly and are
        deliberately not counted."""
        self.enqueue_counts[source] = self.enqueue_counts.get(source, 0) + 1
        if self.m_enqueue is not None:
            self.m_enqueue.inc(source=source)
        when = now_msec() + int(delay_secs * 1000)
        self.put_to_resync_at(h, when)

    def put_to_resync_at(self, h: Hash, when_ms: int) -> None:
        key = struct.pack(">Q", when_ms) + bytes(h)
        self.queue.insert(key, b"")
        self.notify.set()

    def clear_backoff(self, h: Hash) -> None:
        if self.errors.get(bytes(h)) is not None:
            self.errors.remove(bytes(h))

    def queue_len(self) -> int:
        return len(self.queue)

    def errors_len(self) -> int:
        return len(self.errors)

    # --- iteration (ref resync.rs:262-359) ---

    async def resync_iter(self) -> WorkerState:
        """Process (at most) the first due queue entry; returns the worker
        state to report."""
        first = self.queue.first()
        if first is None:
            return WorkerState.IDLE
        key, _v = first
        when = struct.unpack(">Q", key[:8])[0]
        now = now_msec()
        if when > now:
            return WorkerState.IDLE  # head not due yet
        h = Hash(key[8:])
        hb = bytes(h)
        if hb in self.busy_set:
            # another worker is on it; drop this queue entry (it will be
            # requeued if needed)
            self.queue.remove(key)
            return WorkerState.BUSY
        if self.rebuild is not None and self.rebuild.owns(hb):
            # the rebuild scheduler will reach this hash in its own
            # partition walk — drop the queue entry instead of paying a
            # duplicate k-fetch (the scheduler re-parks anything it
            # ultimately fails onto this queue)
            self.queue.remove(key)
            self.rebuild_skips += 1
            return WorkerState.BUSY
        # error backoff check (ref resync.rs:317-343)
        ev = self.errors.get(hb)
        if ev is not None:
            ec = ErrorCounter.parse(ev)
            if ec.next_try() > now:
                # not yet: move the queue entry to the retry time
                self.queue.remove(key)
                self.put_to_resync_at(h, ec.next_try())
                return WorkerState.BUSY
        self.busy_set.add(hb)
        try:
            await self.resync_block(h)
        except Exception as e:
            logger.warning("resync of %s failed: %s", hb.hex()[:16], e)
            ec = ErrorCounter.parse(ev) if ev is not None else ErrorCounter()
            ec = ErrorCounter(ec.errors + 1, now)
            self.errors.insert(hb, ec.serialize())
            self.queue.remove(key)
            self.put_to_resync_at(h, ec.next_try())
            return WorkerState.BUSY
        finally:
            self.busy_set.discard(hb)
        self.clear_backoff(h)
        self.queue.remove(key)
        return WorkerState.BUSY

    # --- the convergence step (ref resync.rs:361-471) ---

    async def resync_block(self, h: Hash) -> int:
        """One convergence step; returns the data-plane bytes it moved
        (pushed to peers + fetched/reconstructed locally) so callers
        driving motion deliberately — the layout-rebalance mover — can
        attribute traffic without a second accounting seam."""
        # per-resync tracing span (ref block/resync.rs:286-303)
        with self.manager.system.tracer.span(
            "Block resync", block=bytes(h).hex()[:16]
        ):
            return await self._resync_block_inner(h)

    async def rebalance_hash(self, h: Hash) -> int:
        """Foreground convergence step driven by the rebalance mover:
        the same logic as a queued resync, sharing the busy-set so a
        queue worker and the mover never double-process a hash.  A
        failed move parks the hash on the persistent queue
        (source="rebalance") instead of raising — the mover keeps
        walking and the retry inherits resync's backoff machinery."""
        hb = bytes(h)
        if hb in self.busy_set:
            return 0
        if self.rebuild is not None and self.rebuild.owns(hb):
            # rebalance_hash bypasses resync_iter, so the scheduler
            # dedupe must sit here too
            self.rebuild_skips += 1
            return 0
        self.busy_set.add(hb)
        try:
            moved = await self.resync_block(h)
        except Exception as e:
            logger.warning("rebalance move of %s failed: %s",
                           hb.hex()[:16], e)
            self.put_to_resync(h, 5.0, source="rebalance")
            return 0
        finally:
            self.busy_set.discard(hb)
        return moved

    async def _resync_block_inner(self, h: Hash) -> int:
        mgr = self.manager
        rc = mgr.rc.get(h)
        present = mgr.is_block_present(h)
        moved = 0  # data-plane bytes pushed/fetched by this step

        unassigned = not mgr.is_assigned(h)
        migrating = rc.is_zero() and present and unassigned
        # draining: a layout change un-assigned us but our refs have NOT
        # migrated off yet (rc still nonzero).  Waiting for the refs
        # means the drain's data motion rides table-sync timing instead
        # of the paced mover — push proactively NOW; the local copy
        # stays until the refs migrate (the migrating/deletable branches
        # handle deletion later).
        draining = rc.is_needed() and present and unassigned
        if (rc.is_deletable() and present) or migrating or draining:
            # we hold a block nobody references: offer to under-replicated
            # peers, then delete (ref resync.rs:376-455).  The migrating
            # case (rc just hit zero because a layout change moved the
            # block's refs away) runs the same offer/push immediately —
            # with data replication "none" this node may hold the ONLY
            # copy, and its new owner cannot serve reads until it lands.
            who = [n for n in mgr.replication.write_nodes(h) if n != mgr.system.id]
            probe = {"t": "need_block", "h": bytes(h)}
            if draining:
                # the new owner's refs are as stale as ours — it would
                # answer "not needed" on rc alone.  Our live rc vouches
                # for the block, so the probe asks it to accept on ring
                # assignment instead.
                probe["drain"] = True
            needy, remote_present = [], 0
            for node in who:
                # need_block is a pure probe (idempotent): route it
                # through the resilience gate so it retries transient
                # resets with backoff, gets the adaptive per-peer
                # timeout, and fast-fails open-breaker peers instead of
                # stalling the resync worker a full static timeout
                resp = await mgr.system.rpc.call(
                    mgr.endpoint,
                    node,
                    probe,
                    prio=PRIO_BACKGROUND,
                    timeout=mgr.block_rpc_timeout,
                    idempotent=True,
                )
                if resp.get("needed"):
                    needy.append(node)
                elif resp.get("present"):
                    remote_present += 1
            if needy:
                block = await mgr.read_block(h)
                from .manager import _chunks

                msg = {
                    "t": "put_block",
                    "h": bytes(h),
                    "hdr": block.header().pack(),
                }
                if mgr.is_parity_block(h):
                    msg["parity"] = True
                for node in needy:
                    # push carries a streaming body → never retried; it
                    # still gains the adaptive timeout + breaker gate
                    await mgr.system.rpc.call(
                        mgr.endpoint,
                        node,
                        msg,
                        prio=PRIO_BACKGROUND,
                        timeout=mgr.block_rpc_timeout,
                        body=_chunks(block.inner),
                    )
                    moved += len(block.inner)
                logger.info(
                    "offloaded block %s to %d nodes", bytes(h).hex()[:16], len(needy)
                )
            confirmed = bool(who) and remote_present + len(needy) >= len(who)
            if draining:
                # bytes are safe on the new owners, but local refs are
                # still live: keep the copy until they migrate (rc hits
                # zero → the migrating branch finishes the job).  Only
                # requeue if an owner could not take its copy yet.
                if not confirmed:
                    self.put_to_resync(h, 30.0, source="migration_retry")
            elif unassigned and not confirmed:
                # owners' refs (rc) haven't migrated yet, so they
                # answered neither needed nor present.  Hold the only
                # copy and retry soon — NEVER delete unconfirmed, even
                # after the GC timer expires (a backlogged meta sync must
                # not turn into data loss; the timer's promise is only
                # valid where the ring still assigns us the block).
                self.put_to_resync(h, 30.0, source="migration_retry")
            elif rc.is_deletable():
                # both drop paths invalidate the device pool BEFORE the
                # file goes (manager.pool_invalidate inside each helper):
                # a rebalance-dropped block must not keep serving scrub
                # hits from device pages after its local copy is gone
                await mgr.delete_if_unneeded(h)
            else:
                # unassigned, every owner confirmed, timer still running:
                # the stray is redundant, drop it without waiting
                await mgr.drop_stray_copy(h)

        elif rc.is_needed() and not present and mgr.is_assigned(h):
            # we are ring-ASSIGNED this block but don't have it: rebuild
            # locally from the RS parity sidecar when possible (zero
            # network — works with every replica down), else fetch from a
            # replica (ref resync.rs:457-468).  is_assigned matters when
            # data_replication_mode < replication_mode: the block_ref
            # partition (meta factor) then holds rc on nodes the data
            # ring does NOT assign the block to, and without the check
            # every rc holder would pull its own copy.
            if mgr.parity_store is not None:
                data = await asyncio.to_thread(
                    mgr.parity_store.try_reconstruct, h
                )
                if data is not None:
                    from .block import DataBlock

                    await mgr.write_block(h, DataBlock.plain(data))
                    mgr.blocks_reconstructed += 1
                    mgr.note_heal("local_sidecar")
                    return len(data)
            try:
                # a pure refetch is idempotent: a bounded retry budget
                # (shared across the replica fan-out) on transport
                # errors, like the need_block probe above (satellite:
                # read-path disk_error entries land here and must not
                # give up on one connection reset)
                block = await mgr.rpc_get_raw_block(h, for_storage=True,
                                                    idempotent=True)
            except Exception:
                # Replicas unreachable or damaged.  Next: the
                # migration-aware peer sweep — after an abrupt layout
                # change the sole copy can sit on a node outside the new
                # ring whose rc hasn't migrated yet (so it won't push,
                # and the ring fetch above can't see it); the puller
                # must find it (sweep_get_block docstring).  Last line:
                # DISTRIBUTED parity — fetch ≥ k surviving codeword
                # pieces cluster-wide and decode the missing row
                # (survives whole-node loss, which neither fetch can;
                # the reference's only answer here is replication,
                # resync.rs:457-468).
                data = await mgr.sweep_get_block(h, try_ring=False)
                swept = data is not None
                if data is None:
                    if mgr.parity_reconstructor is None:
                        raise
                    data = await mgr.parity_reconstructor(h)
                if data is None:
                    raise
                from .block import DataBlock

                await mgr.write_block(h, DataBlock.plain(data))
                if swept:
                    mgr.note_heal("peer_sweep")
                    logger.info("fetched displaced block %s via peer "
                                "sweep", bytes(h).hex()[:16])
                else:
                    mgr.blocks_reconstructed += 1
                    mgr.note_heal("distributed_decode")
                    logger.info("reconstructed block %s from DISTRIBUTED "
                                "parity", bytes(h).hex()[:16])
                return len(data)
            await mgr.write_block(h, block, is_parity=block.parity)
            mgr.note_heal("resync_fetch")
            logger.info("resynced missing block %s", bytes(h).hex()[:16])
            moved += len(block.inner)
        return moved

    async def next_due_in(self) -> float:
        first = self.queue.first()
        if first is None:
            return 10.0
        when = struct.unpack(">Q", first[0][:8])[0]
        return max(0.05, min((when - now_msec()) / 1000.0, 10.0))


class ResyncWorker(Worker):
    """ref resync.rs:481-567; spawn `n_workers` of these."""

    def __init__(self, resync: BlockResyncManager, index: int = 0):
        self.resync = resync
        self.index = index
        self.tranquilizer = Tranquilizer()

    def name(self) -> str:
        return f"Block resync worker #{self.index + 1}"

    async def work(self) -> WorkerState:
        if self.index >= self.resync.n_workers:
            await asyncio.sleep(1.0)
            return WorkerState.IDLE
        st = self.status()
        st.queue_length = self.resync.queue_len()
        st.persistent_errors = self.resync.errors_len()
        st.tranquility = self.resync.tranquility
        self.tranquilizer.reset()
        state = await self.resync.resync_iter()
        if state == WorkerState.BUSY:
            return await self.tranquilizer.tranquilize_worker(
                self.resync.tranquility
            )
        return state

    async def wait_for_work(self) -> None:
        self.resync.notify.clear()
        delay = await self.resync.next_due_in()
        try:
            await asyncio.wait_for(self.resync.notify.wait(), timeout=delay)
        except asyncio.TimeoutError:
            pass
