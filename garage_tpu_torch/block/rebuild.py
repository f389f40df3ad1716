"""RebuildScheduler — a full-node loss healed as ONE planned flow.

Losing a whole storage node used to heal as thousands of independent
greedy per-codeword repairs: the layout sweep dumps every referenced
hash onto the resync queue, each queue worker fetches its own k pieces,
and nobody paces the storm as a whole.  This worker plans the rebuild
globally instead:

  - it walks ONLY the partitions whose replica set lost a node (diffed
    by the model layer, like the rebalance mover), in partition order,
    over this node's rc tree — every missing block this node is now
    responsible for is found exactly once;
  - each lost block resolves to its CODEWORD: all of the codeword's
    lost rows are decoded from ONE shared fetch (chain repair,
    repair_plan.reconstruct_group) and the sibling rows this node is
    not assigned are pushed straight to their needy owners — a
    codeword never pays k fetches per lost row;
  - repair trees are rooted round-robin per survivor-set group
    (`rotate`), so one well-placed peer does not become the
    aggregation root — and the fan-in hotspot — of every tree;
  - motion is paced against `rebuild_rate_mib` (config) scaled by the
    LoadGovernor throttle ratio, so the storm cedes bandwidth to
    foreground traffic under pressure and speeds back up when it
    clears;
  - progress checkpoints (partition cursor + pending set) persist via
    the standard Persister, so a coordinator restart RESUMES the walk
    where it stopped instead of restarting from partition zero.

Dedupe contract with resync (block/resync.py): while a partition is
pending here, queue workers and the rebalance mover skip its hashes
(`owns`); anything this worker ultimately fails to rebuild is parked
back onto the persistent queue with source="rebuild" once its
partition completes — so the two subsystems never double-repair a
block, and nothing is ever dropped on the floor.

Every piece a rebuild reads comes from a block file (the planner's
local read, peers' `get_block`/`sweep_get_block`), never from the device
pool: only the scrub's staging consults the pool, and the scrub drops a
block's pages as it reads the file (block/repair.py `_forget_pool`), so
no resident page can stand in for a file that rotted.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Dict, List, Optional

from ..net.frame import PRIO_BACKGROUND
from ..utils.background import Worker, WorkerState
from ..utils.data import Hash
from ..utils.migrate import Migrated

logger = logging.getLogger("garage_tpu_torch.block.rebuild")

# blocks examined per work() slice — event-loop occupancy, not
# throughput (pacing below does that)
REBUILD_BATCH = 8
# checkpoint cadence: a restart re-examines at most this many codewords
# (re-examining a healed block is a cheap is_block_present hit)
CHECKPOINT_EVERY = 32
# bound on the per-survivor-set root-rotation table
MAX_ROTATION_GROUPS = 1024
# After a node loss, refs for the lost partitions keep arriving by table
# sync for a while (the new owner gains the block_ref partition WITH the
# block assignment, and sync lags the ring change — at fleet scale by
# minutes).  A ref that lands AFTER the walk passed its partition
# re-queues that partition (note_ref) for this long, so late arrivals
# heal through the planned flow instead of leaking to one-off resyncs.
REARM_WINDOW_S = 600.0


class RebuildCheckpoint(Migrated):
    """Persistent rebuild progress: the pending partition walk, the
    cursor inside the head partition, and the parked-failure list."""

    VERSION_MARKER = b"GT01rbld"

    def __init__(self, active: bool = False, ring_digest: bytes = b"",
                 pending: Optional[List[int]] = None,
                 cursor: bytes = b"", partitions_done: int = 0,
                 partitions_total: int = 0, codewords: int = 0,
                 blocks: int = 0, bytes_healed: int = 0,
                 parked: Optional[List[bytes]] = None):
        self.active = active
        self.ring_digest = ring_digest
        self.pending = list(pending or [])
        self.cursor = cursor
        self.partitions_done = partitions_done
        self.partitions_total = partitions_total
        self.codewords = codewords
        self.blocks = blocks
        self.bytes_healed = bytes_healed
        self.parked = list(parked or [])

    def fields(self):
        return [self.active, self.ring_digest, self.pending, self.cursor,
                self.partitions_done, self.partitions_total,
                self.codewords, self.blocks, self.bytes_healed,
                self.parked]

    @classmethod
    def from_fields(cls, body):
        return cls(bool(body[0]), bytes(body[1]),
                   [int(p) for p in body[2]], bytes(body[3]),
                   int(body[4]), int(body[5]), int(body[6]),
                   int(body[7]), int(body[8]),
                   [bytes(b) for b in body[9]])


class RebuildScheduler(Worker):
    def __init__(self, manager, resync, rate_mib_s: float = 256.0,
                 persister=None, metrics=None, governor=None,
                 lookup=None, decode_fallback=None,
                 probe_siblings: bool = True):
        self.manager = manager
        self.resync = resync
        self.rate_bytes = max(float(rate_mib_s), 0.001) * (1 << 20)
        self.persister = persister
        self.governor = governor
        # model-layer bindings (parity_repair): codeword lookup for a
        # member hash, and the decode-ladder fallback for codewords the
        # planner cannot serve
        self.lookup = lookup
        self.decode_fallback = decode_fallback
        self.probe_siblings = probe_siblings
        self._pending: List[int] = []   # partitions left, walk order
        self._queued = set()
        self._cursor: Optional[bytes] = None  # rc-tree key inside head
        self._parked: List[bytes] = []  # failures, flushed per partition
        self._rotation: Dict[frozenset, int] = {}
        # late-ref re-arm state (see REARM_WINDOW_S / note_ref)
        self._rearm_parts: set = set()
        self._rearm_until = 0.0
        self._rewalk: set = set()
        self.rearms = 0
        self._notify = asyncio.Event()
        self.ring_digest = b""
        self.partitions_total = 0
        self.partitions_done = 0
        self.codewords_rebuilt = 0
        self.blocks_healed = 0
        # walked rows left to resync because a live node still holds them
        self.moved_rows = 0
        self.bytes_healed = 0
        self.runs = 0
        self._since_checkpoint = 0
        # checkpoint writes, one at a time and never an older one over a
        # newer one: the worker's go through a thread (_checkpoint_async)
        self._save_lock = threading.Lock()
        self._taken_seq = 0
        self._saved_seq = 0
        # governor-coexistence evidence for the chaos drill: how often
        # the walk paused to pace, and the lowest throttle ratio seen
        self.paced_sleeps = 0
        self.governor_ratio_min = 1.0
        if metrics is not None:
            self.m_done = metrics.gauge(
                "rebuild_partitions_done",
                "Partitions fully walked by the current/last full-node "
                "rebuild run")
            self.m_total = metrics.gauge(
                "rebuild_partitions_total",
                "Partitions that lost a replica in the current/last "
                "full-node rebuild run")
            self.m_bytes = metrics.counter(
                "rebuild_bytes_total",
                "Bytes of lost rows decoded and re-materialized by the "
                "fleet rebuild scheduler")
            self.m_rearm = metrics.counter(
                "rebuild_rearm_total",
                "Lost partitions re-queued because a block ref arrived "
                "(table sync) after the rebuild walk had passed them")
            self.m_done.set(0.0)
            self.m_total.set(0.0)
        else:
            self.m_done = self.m_total = self.m_bytes = None
            self.m_rearm = None

    def name(self) -> str:
        return "Fleet rebuild scheduler"

    # --- feeding (model layer, on ring change) ---

    def node_lost(self, partitions: List[int], ring_digest: bytes) -> None:
        """Partitions whose replica set lost a node.  Merging semantics
        match the rebalance mover: a completed run starting anew resets
        the progress pair; partitions already pending stay put."""
        fresh = [p for p in partitions if p not in self._queued]
        self.ring_digest = bytes(ring_digest)
        self._rearm_parts = set(partitions)
        self._rearm_until = time.monotonic() + REARM_WINDOW_S
        if not fresh:
            self._checkpoint(force=True)
            return
        if not self._pending:
            # new episode
            self.partitions_total = 0
            self.partitions_done = 0
            self.runs += 1
        self._pending.extend(fresh)
        self._queued.update(fresh)
        self.partitions_total += len(fresh)
        self._observe()
        self._checkpoint(force=True)
        self._notify.set()
        logger.info("rebuild: %d lost partition(s) enqueued (%d pending)",
                    len(fresh), len(self._pending))

    def maybe_resume(self, ring_digest: bytes) -> bool:
        """Boot-time: restore an interrupted rebuild if the ring still
        matches the checkpoint (a further layout change means the lost
        set changed — the fresh ring diff re-feeds us instead)."""
        if self.persister is None:
            return False
        chk = self.persister.load()
        if chk is None or not chk.active:
            return False
        if bytes(chk.ring_digest) != bytes(ring_digest):
            logger.info("rebuild checkpoint is for another ring: discarded")
            self._checkpoint(force=True)  # persist the inactive state
            return False
        self.ring_digest = bytes(chk.ring_digest)
        self._pending = list(chk.pending)
        self._queued = set(chk.pending)
        self._cursor = chk.cursor or None
        self._parked = list(chk.parked)
        self.partitions_done = chk.partitions_done
        self.partitions_total = chk.partitions_total
        self.codewords_rebuilt = chk.codewords
        self.blocks_healed = chk.blocks
        self.bytes_healed = chk.bytes_healed
        self.runs += 1
        self._observe()
        self._notify.set()
        logger.info(
            "rebuild resumed from checkpoint: %d/%d partitions done, "
            "%d pending", self.partitions_done, self.partitions_total,
            len(self._pending))
        return True

    def _take_checkpoint(self, force: bool) -> Optional[tuple]:
        """Count one checkpoint opportunity; (sequence number, the
        checkpoint of the state now) when one is due, else None."""
        self._since_checkpoint += 1
        if not force and self._since_checkpoint < CHECKPOINT_EVERY:
            return None
        self._since_checkpoint = 0
        if self.persister is None:
            return None
        self._taken_seq += 1
        return self._taken_seq, RebuildCheckpoint(
            active=bool(self._pending), ring_digest=self.ring_digest,
            pending=list(self._pending), cursor=self._cursor or b"",
            partitions_done=self.partitions_done,
            partitions_total=self.partitions_total,
            codewords=self.codewords_rebuilt, blocks=self.blocks_healed,
            bytes_healed=self.bytes_healed, parked=list(self._parked))

    def _save(self, seq: int, chk: RebuildCheckpoint) -> None:
        with self._save_lock:
            if seq > self._saved_seq:
                self.persister.save(chk)
                self._saved_seq = seq

    def _checkpoint(self, force: bool = False) -> None:
        taken = self._take_checkpoint(force)
        if taken is not None:
            self._save(*taken)

    async def _checkpoint_async(self, force: bool = False) -> None:
        """_checkpoint for the worker: the state is taken on the event
        loop and written (temporary file, fsync, rename, fsync of the
        directory) in a thread.  On a busy disk those fsyncs take most of
        a second (PERF.md: 0.47-0.78 s on the H100 host's disk), and on
        the loop they stall every node that shares it past the drills'
        RPC timeouts."""
        taken = self._take_checkpoint(force)
        if taken is not None:
            await asyncio.to_thread(self._save, *taken)

    def _observe(self) -> None:
        if self.m_done is not None:
            self.m_done.set(float(self.partitions_done))
            self.m_total.set(float(self.partitions_total))

    def idle(self) -> bool:
        return not self._pending

    # --- resync dedupe seam ---

    def owns(self, hb: bytes) -> bool:
        """True while this scheduler will (still) reach `hb` in its own
        walk — resync workers and the rebalance mover skip such hashes.
        A hash at or behind the head partition's cursor was already
        examined (and parked if it failed), so it is NOT claimed."""
        if not self._pending or hb[0] not in self._queued:
            return False
        if (hb[0] == self._pending[0] and self._cursor is not None
                and bytes(hb) <= self._cursor):
            return False
        return True

    def note_ref(self, h: Hash) -> bool:
        """A block ref just landed (incref 0→1, usually table sync
        delivering a migrated partition).  If it belongs to a partition
        of the recent node loss that the walk has already passed,
        re-queue the partition — table sync lags the ring change, and a
        walk that raced ahead of it would otherwise declare the rebuild
        complete while the refs it is responsible for are still in
        flight.  Returns True when the scheduler will (re)visit the
        hash.  Bounded: only within REARM_WINDOW_S of the loss, only
        for its partitions, one queue entry per partition at a time."""
        hb = bytes(h)
        p = hb[0]
        if p not in self._rearm_parts or time.monotonic() > self._rearm_until:
            return False
        if p in self._queued:
            if (self._pending and p == self._pending[0]
                    and self._cursor is not None and hb <= self._cursor):
                # head partition, walk already past this key: finish the
                # pass, then walk the partition once more
                self._rewalk.add(p)
            return True
        self._pending.append(p)
        self._queued.add(p)
        self.partitions_total += 1
        self.rearms += 1
        if self.m_rearm is not None:
            self.m_rearm.inc()
        self._observe()
        self._notify.set()
        logger.info("rebuild: partition %d re-queued (late ref %s)",
                    p, hb.hex()[:16])
        return True

    # --- the walk ---

    def _next_entries(self, partition: int, n: int):
        """Up to n rc keys of `partition` after the cursor — partition
        == first hash byte (ring.partition_of), like the mover's walk."""
        rc = self.manager.rc
        out = []
        cursor = self._cursor
        while len(out) < n:
            if cursor is None:
                nxt = rc.get_gt(bytes([partition - 1]) + b"\xff" * 31) \
                    if partition else rc.tree.first()
            else:
                nxt = rc.get_gt(cursor)
            if nxt is None or nxt[0][0] != partition:
                return out, True
            out.append(nxt[0])
            cursor = nxt[0]
            self._cursor = cursor
        return out, False

    async def work(self) -> WorkerState:
        if not self._pending:
            return WorkerState.IDLE
        p = self._pending[0]
        keys, part_done = self._next_entries(p, REBUILD_BATCH)
        healed = 0
        for key in keys:
            try:
                healed += await self._rebuild_hash(Hash(key))
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — park, keep walking
                logger.warning("rebuild of %s failed: %s",
                               key.hex()[:16], e)
                self._parked.append(bytes(key))
        if healed:
            self.bytes_healed += healed
            if self.m_bytes is not None:
                self.m_bytes.inc(healed)
        if part_done:
            self._pending.pop(0)
            self._cursor = None
            self.partitions_done += 1
            if p in self._rewalk:
                # a ref landed behind the cursor mid-walk: keep the
                # partition queued and walk it again from the top
                self._rewalk.discard(p)
                self._pending.append(p)
                self.partitions_total += 1
                self.rearms += 1
                if self.m_rearm is not None:
                    self.m_rearm.inc()
            else:
                self._queued.discard(p)
            self._observe()
            parked, self._parked = self._parked, []
            if p in self._queued:
                # partition re-queued for a rewalk: the next pass
                # re-examines (and re-parks) these, don't flush yet
                parked = []
            # flush failures AFTER the partition leaves the owned set,
            # so owns() no longer claims them and resync takes over
            for hb in parked:
                self.resync.put_to_resync(Hash(hb), 30.0, source="rebuild")
            await self._checkpoint_async(force=True)
            if not self._pending:
                logger.info(
                    "rebuild run complete: %d/%d partitions, %d codewords, "
                    "%d blocks healed, %d bytes", self.partitions_done,
                    self.partitions_total, self.codewords_rebuilt,
                    self.blocks_healed, self.bytes_healed)
        else:
            await self._checkpoint_async()
        st = self.status()
        st.progress = (
            f"{self.partitions_done}/{self.partitions_total} partitions")
        st.queue_length = len(self._pending)
        if healed:
            rate = self.rate_bytes
            if self.governor is not None:
                ratio = max(self.governor.ratio(), 1e-3)
                self.governor_ratio_min = min(
                    self.governor_ratio_min, ratio)
                rate *= ratio
            self.paced_sleeps += 1
            await asyncio.sleep(min(healed / rate, 5.0))
        return WorkerState.BUSY

    async def wait_for_work(self) -> None:
        self._notify.clear()
        if self._pending:
            return
        try:
            await asyncio.wait_for(self._notify.wait(), timeout=10.0)
        except asyncio.TimeoutError:
            pass

    # --- one lost block → its whole codeword ---

    async def _rebuild_hash(self, h: Hash) -> int:
        mgr = self.manager
        hb = bytes(h)
        if hb in self.resync.busy_set:
            return 0  # a queue worker beat us to it
        if mgr.is_block_present(h):
            return 0
        if not (mgr.rc.get(h).is_needed() and mgr.is_assigned(h)):
            return 0  # not this node's row to re-materialize
        self.resync.busy_set.add(hb)
        try:
            ent = None
            if self.lookup is not None:
                for cand in await self.lookup(h):
                    if (cand.member_index < len(cand.members)
                            and bytes(cand.members[cand.member_index])
                            == hb):
                        ent = cand
                        break
            if ent is None:
                # no codeword coverage (pre-EC data, parity of a dead
                # word): the resync ladder's replica fetch / sweep is
                # the only option — park it
                self._parked.append(hb)
                return 0
            healed = await self._rebuild_codeword(h, ent)
            if healed == 0 and not mgr.is_block_present(h):
                self._parked.append(hb)
            return healed
        finally:
            self.resync.busy_set.discard(hb)

    async def _rebuild_codeword(self, h: Hash, ent) -> int:
        """Decode EVERY lost row of `h`'s codeword from one shared
        fetch set (chain repair) and deliver each row to its owner —
        locally written when this node is assigned, pushed via
        put_block when a sibling's owner probes as needy."""
        mgr = self.manager
        targets = [int(ent.member_index)]
        push_to: Dict[int, object] = {}
        for i, mh in enumerate(ent.members):
            if i == int(ent.member_index):
                continue
            sib = Hash(bytes(mh))
            if mgr.is_block_present(sib):
                continue
            if mgr.is_assigned(sib):
                if mgr.rc.get(sib).is_needed():
                    targets.append(i)
                continue
            if not self.probe_siblings:
                continue
            node = await self._probe_needy(sib)
            if node is not None:
                targets.append(i)
                push_to[i] = node
        # a row that merely moved (its partition's new owner lacks it
        # while a live node still holds it) is resync's to copy — decoding
        # it would fetch k pieces for one block's bytes and report a
        # block no loss took as reconstructed
        targets = [t for t in sorted(set(targets)) if not
                   await self._held_elsewhere(Hash(bytes(ent.members[t])))]
        if int(ent.member_index) not in targets:
            self.moved_rows += 1
            return 0  # parked by the caller: resync copies it
        rotate = self._next_rotation(ent)
        rows: Dict[int, Optional[bytes]] = {}
        planner = getattr(mgr, "repair_planner", None)
        if planner is not None:
            rows = await planner.reconstruct_group(ent, targets,
                                                   rotate=rotate)
        want = int(ent.member_index)
        if rows.get(want) is None and self.decode_fallback is not None:
            data = await self.decode_fallback(h, ent)
            if data is not None:
                rows[want] = data
        healed = 0
        from .block import DataBlock

        for t in targets:
            data = rows.get(t)
            if data is None:
                continue
            mh = Hash(bytes(ent.members[t]))
            if mgr.is_assigned(mh):
                if mgr.is_block_present(mh):
                    continue  # another writer landed it during the decode
                await mgr.write_block(mh, DataBlock.plain(data))
                mgr.blocks_reconstructed += 1
                mgr.note_heal("rebuild")
                self.blocks_healed += 1
                healed += len(data)
            elif t in push_to:
                if await self._push_row(mh, data, push_to[t]):
                    self.blocks_healed += 1
                    healed += len(data)
        if healed:
            self.codewords_rebuilt += 1
        return healed

    def _next_rotation(self, ent) -> int:
        """Round-robin tree-root rotation per survivor-set group: the
        group key is the set of primary holders of the codeword's
        pieces (pure ring math — no RPC), so codewords sharing a
        survivor set spread their aggregation roots instead of all
        rooting at the same best-ranked peer."""
        mgr = self.manager
        holders = []
        for mh in list(ent.members) + list(ent.parity_hashes):
            nodes = mgr.replication.read_nodes(Hash(bytes(mh)))
            if nodes:
                holders.append(bytes(nodes[0]))
        sig = frozenset(holders)
        if len(self._rotation) > MAX_ROTATION_GROUPS:
            self._rotation.clear()
        r = self._rotation.get(sig, 0)
        self._rotation[sig] = r + 1
        return r

    async def _held_elsewhere(self, h: Hash) -> bool:
        """Does another node of the current layout hold a copy of `h`?
        One idempotent need_block probe per node (its "present" flag);
        a node that does not answer holds nothing we can count on."""
        mgr = self.manager
        me = bytes(mgr.system.id)
        for node in mgr.system.layout.all_nodes():
            if bytes(node) == me:
                continue
            try:
                resp = await mgr.system.rpc.call(
                    mgr.endpoint, node, {"t": "need_block", "h": bytes(h)},
                    prio=PRIO_BACKGROUND, timeout=mgr.block_rpc_timeout,
                    idempotent=True)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — next node
                continue
            if resp.get("present"):
                return True
        return False

    async def _probe_needy(self, h: Hash):
        """First assigned node that needs (and lacks) `h` — an
        idempotent need_block probe, same as the resync offer path."""
        mgr = self.manager
        for node in mgr.replication.write_nodes(h):
            if node == mgr.system.id:
                continue
            try:
                resp = await mgr.system.rpc.call(
                    mgr.endpoint, node, {"t": "need_block", "h": bytes(h)},
                    prio=PRIO_BACKGROUND, timeout=mgr.block_rpc_timeout,
                    idempotent=True)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — next candidate
                continue
            if resp.get("needed") and not resp.get("present"):
                return node
            if resp.get("present"):
                return None
        return None

    async def _push_row(self, h: Hash, data: bytes, node) -> bool:
        from .block import DataBlock
        from .manager import _chunks

        mgr = self.manager
        block = DataBlock.plain(data)
        try:
            await mgr.system.rpc.call(
                mgr.endpoint, node,
                {"t": "put_block", "h": bytes(h),
                 "hdr": block.header().pack()},
                prio=PRIO_BACKGROUND, timeout=mgr.block_rpc_timeout,
                body=_chunks(block.inner))
            return True
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — its owner's resync retries
            logger.info("rebuilt row push of %s failed: %s",
                        bytes(h).hex()[:16], e)
            return False
