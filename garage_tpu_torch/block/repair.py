"""Scrub / repair / rebalance workers — batch-first.

Equivalent of reference src/block/repair.rs (SURVEY.md §2.5):
  - ScrubWorker: full-datastore integrity pass every 25-35 days
    (randomized, repair.rs:24,244-254), resumable via a persisted iterator
    checkpoint (60 s cadence), Start/Pause/Resume/Cancel commands,
    tranquilizer-throttled, corruption counter.
  - RepairWorker: one-shot: re-enqueue every referenced hash to resync,
    then walk the disk and enqueue every found block (repair.rs:35-155).
  - RebalanceWorker: move blocks to their primary dir after a data-layout
    change (repair.rs:531-626).
  - BlockStoreIterator: resumable hash-ordered walk of the block store
    with fixed-point progress (repair.rs:634-764).

Difference from the reference (the north-star design, BASELINE.md): the
reference scrubs strictly one block at a time — read, blake2, next
(repair.rs:438-490).  Here the iterator feeds *batches* to the BlockCodec:
one codec dispatch per 2-level hash prefix directory (`xx/yy`), i.e. every
block under that prefix (plus, with parity sidecars, the < k verified
blocks carried over to fill a codeword).  With 65,536 prefixes a store
of fewer than ~65k blocks hands the codec about one block per dispatch;
`batch_blocks` does not bound or widen these batches.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import time
from typing import List, Optional, Tuple

import numpy as np

from ..utils.background import Worker, WorkerState
from ..utils.crdt import now_msec
from ..utils.data import Hash
from ..utils.migrate import Migrated
from ..utils.persister import Persister
from ..utils.tranquilizer import Tranquilizer

logger = logging.getLogger("garage_tpu_torch.block.repair")

SCRUB_INTERVAL_MIN = 25 * 86400   # ref repair.rs:24 (randomized 25-35 days)
SCRUB_INTERVAL_MAX = 35 * 86400
DEFAULT_SCRUB_TRANQUILITY = 4     # ref repair.rs:27
CHECKPOINT_INTERVAL = 60.0        # ref repair.rs:460-464
REPAIR_BATCH = 1000               # ref repair.rs:92-101 (sqlite-safe batches)


class BlockStoreIterator:
    """Hash-ordered walk over every block file across all data dirs,
    resumable from a serialized position (ref repair.rs:634-764).

    Position = last fully-processed 2-level prefix (0..65536); progress is
    prefix/65536 — equivalent to the reference's fixed-point fraction."""

    def __init__(self, roots: List[str], position: int = 0):
        self.roots = roots
        self.position = position  # next 2-byte prefix to scan
        self._prefixes: Optional[List[int]] = None  # existing dirs, sorted

    def progress(self) -> float:
        return self.position / 65536.0

    def is_done(self) -> bool:
        return self.position >= 65536

    def _scan_prefixes(self) -> List[int]:
        """Enumerate existing 2-level prefix dirs (≤256 listdir calls per
        root instead of probing all 65536 combinations)."""
        pref = set()
        for root in self.roots:
            try:
                level1 = os.listdir(root)
            except FileNotFoundError:
                continue
            for a in level1:
                if len(a) != 2:
                    continue
                try:
                    ai = int(a, 16)
                    level2 = os.listdir(os.path.join(root, a))
                except (ValueError, OSError):
                    continue
                for b in level2:
                    if len(b) == 2:
                        try:
                            pref.add((ai << 8) | int(b, 16))
                        except ValueError:
                            pass
        return sorted(pref)

    def next_prefix(self) -> Optional[List[Tuple[Hash, str, bool]]]:
        """All blocks under the next existing prefix dir:
        [(hash, path, compressed)]; None when the walk is complete."""
        if self._prefixes is None:
            self._prefixes = self._scan_prefixes()
        import bisect

        i = bisect.bisect_left(self._prefixes, self.position)
        if i >= len(self._prefixes) or self.is_done():
            self.position = 65536
            return None
        p = self._prefixes[i]
        self.position = p + 1
        d1, d2 = f"{p >> 8:02x}", f"{p & 0xFF:02x}"
        seen = {}
        for root in self.roots:
            d = os.path.join(root, d1, d2)
            try:
                names = os.listdir(d)
            except FileNotFoundError:
                continue
            for name in names:
                base = name[:-4] if name.endswith(".zst") else name
                if len(base) != 64 or name.endswith((".tmp", ".corrupted")):
                    continue
                try:
                    h = Hash(bytes.fromhex(base))
                except ValueError:
                    continue
                # prefer the compressed copy, first root wins (primary first)
                if bytes(h) not in seen or name.endswith(".zst"):
                    seen[bytes(h)] = (h, os.path.join(d, name), name.endswith(".zst"))
        return sorted(seen.values(), key=lambda t: bytes(t[0]))


class ScrubWorkerState(Migrated):
    """Persisted scrub state (ref repair.rs:165-232)."""

    VERSION_MARKER = b"GT01scrub"

    def __init__(
        self,
        position: int = 0,
        running: bool = False,
        paused: bool = False,
        time_next_run: int = 0,
        tranquility: int = DEFAULT_SCRUB_TRANQUILITY,
        corruptions: int = 0,
        time_last_complete: int = 0,
        time_last_start: int = 0,
    ):
        self.position = position
        self.running = running
        self.paused = paused
        self.time_next_run = time_next_run
        self.tranquility = tranquility
        self.corruptions = corruptions
        self.time_last_complete = time_last_complete
        self.time_last_start = time_last_start

    def fields(self):
        return [
            self.position, self.running, self.paused, self.time_next_run,
            self.tranquility, self.corruptions, self.time_last_complete,
            self.time_last_start,
        ]

    @classmethod
    def from_fields(cls, b):
        return cls(*b)


def randomize_next_scrub() -> int:
    return now_msec() + random.randint(
        SCRUB_INTERVAL_MIN * 1000, SCRUB_INTERVAL_MAX * 1000
    )


class ScrubWorker(Worker):
    """Batch-first scrub: BlockStoreIterator prefixes → codec.batch_verify
    (one device dispatch per batch) → corrupted blocks moved aside +
    requeued for resync."""

    def __init__(self, manager, persister: Optional[Persister] = None):
        self.manager = manager
        self.persister = persister
        st = persister.load() if persister is not None else None
        self.state: ScrubWorkerState = st or ScrubWorkerState(
            time_next_run=randomize_next_scrub()
        )
        self.iterator: Optional[BlockStoreIterator] = None
        if self.state.running:
            self.iterator = BlockStoreIterator(
                self._roots(), self.state.position
            )
        self.tranquilizer = Tranquilizer()
        self.coverage_refreshed = 0  # blocks re-fed to the EC accumulator
        self._last_checkpoint = time.monotonic()
        self._cmd: asyncio.Queue = asyncio.Queue()
        self._wake = asyncio.Event()
        # read-ahead: next prefix's file contents load while the current
        # one verifies; checkpoints record the VERIFIED position, not the
        # iterator's (which runs one prefix ahead)
        self._ra_task: Optional[asyncio.Task] = None
        self._verified_pos = self.state.position
        # verified plain blocks carried between batches until a full RS
        # codeword (k blocks) accumulates for the parity sidecar store
        self._parity_carry: Tuple[list, list] = ([], [])
        self._prev_pass_start = 0.0  # resumed pass: purge nothing extra

    def _roots(self) -> List[str]:
        return [d.path for d in self.manager.data_layout.data_dirs]

    def name(self) -> str:
        return "Block scrub worker"

    # --- operator commands (ref repair.rs Start/Pause/Resume/Cancel) ---

    def send_command(self, cmd: str) -> None:
        self._cmd.put_nowait(cmd)
        self._wake.set()

    def set_tranquility(self, t: int) -> None:
        t = int(t)
        if t < 0:
            raise ValueError("scrub-tranquility must be >= 0")
        self.state.tranquility = t
        self._checkpoint(force=True)

    def _apply_command(self, cmd: str) -> None:
        st = self.state
        if cmd == "start":
            if self.iterator is None:
                self.iterator = BlockStoreIterator(self._roots())
                st.running, st.paused, st.position, st.corruptions = True, False, 0, 0
                self._verified_pos = 0
                self._drop_read_ahead()
                self._drop_parity_carry()
                # purge grace is ONE pass: remember the previous start
                # before overwriting it (a sidecar skipped this pass —
                # its row held the corruption being repaired — must
                # survive until the NEXT pass refreshes it)
                self._prev_pass_start = st.time_last_start / 1000.0
                st.time_last_start = now_msec()
                # one full scrub pass == one device-pool clock tick: the
                # pool's LRU ages in scrub CYCLES, not wall time, so an
                # idle cluster never evicts its warm working set while
                # nothing else competes for pages (ops/device_pool.py)
                pool = getattr(self.manager.codec, "pool", None)
                if pool is not None:
                    pool.tick()
        elif cmd == "pause":
            st.paused = True
        elif cmd == "resume":
            st.paused = False
        elif cmd == "cancel":
            self.iterator = None
            st.running, st.paused, st.position = False, False, 0
            self._verified_pos = 0
            self._drop_read_ahead()
        self._checkpoint(force=True)

    def _drop_parity_carry(self) -> None:
        self._parity_carry = ([], [])

    def _drop_read_ahead(self) -> None:
        if self._ra_task is not None:
            self._ra_task.cancel()
            self._ra_task = None

    def _checkpoint(self, force: bool = False) -> None:
        if self.persister is None:
            return
        if force or time.monotonic() - self._last_checkpoint > CHECKPOINT_INTERVAL:
            # resume must re-verify anything not actually verified yet, so
            # the persisted position trails the (read-ahead) iterator
            self.state.position = self._verified_pos if self.iterator else 0
            self.persister.save(self.state)
            self._last_checkpoint = time.monotonic()

    # --- the batch scrub step ---

    async def work(self) -> WorkerState:
        while not self._cmd.empty():
            self._apply_command(self._cmd.get_nowait())
        st = self.state
        status = self.status()
        status.tranquility = st.tranquility
        if self.iterator is None:
            # waiting for the next scheduled run
            if now_msec() >= st.time_next_run:
                self._apply_command("start")
                return WorkerState.BUSY
            return WorkerState.IDLE
        if st.paused:
            return WorkerState.IDLE
        self.tranquilizer.reset()
        task = self._ra_task or asyncio.ensure_future(self._read_ahead())
        # clear BEFORE awaiting: if the read fails, the next work() cycle
        # must retry a fresh read, not re-await the cached exception
        self._ra_task = None
        item = await task
        if item is None:
            # complete
            st.time_last_complete = now_msec()
            st.time_next_run = randomize_next_scrub()
            st.running = False
            self.iterator = None
            self._drop_parity_carry()  # <k leftover: next pass retries
            if self.manager.parity_store is not None:
                # codeword membership shifts with churn: drop sidecars
                # refreshed by NEITHER this pass nor the previous one,
                # else orphans accumulate forever (one-pass grace keeps
                # coverage for rows that failed verify this pass)
                await asyncio.to_thread(
                    self.manager.parity_store.purge_stale,
                    self._prev_pass_start,
                )
            self._checkpoint(force=True)
            logger.info("scrub complete, %d corruptions found", st.corruptions)
            return WorkerState.BUSY
        batch, reads, pos_after = item
        # prefetch the NEXT prefix while this one verifies: disk reads
        # overlap the codec dispatch (read→batch→device, SURVEY.md §3.4)
        self._ra_task = asyncio.ensure_future(self._read_ahead())
        status.progress = f"{self.iterator.progress() * 100:.2f}%"
        if batch:
            await self.scrub_batch(batch, reads)
        self._verified_pos = pos_after
        self._checkpoint()
        return await self.tranquilizer.tranquilize_worker(st.tranquility)

    async def _read_ahead(self):
        """Next prefix's batch + file contents, read off-thread.  Returns
        (batch, reads, iterator_position_after) or None at end-of-store."""
        it = self.iterator
        if it is None:
            return None
        batch = await asyncio.to_thread(it.next_prefix)
        if batch is None:
            return None
        reads = await asyncio.gather(
            *[asyncio.to_thread(_try_read, self.manager, path)
              for _h, path, _c in batch]
        )
        self._forget_pool(batch)
        # hint the device pool about the upcoming prefix: the transport
        # stages these blocks as background-class work WHILE the current
        # batch computes (riding the transport's double buffer), so the next
        # batch's H2D cost hides under compute and its scrub becomes a
        # pool hit.  Plain blocks only — compressed copies are verified
        # on their decompressed content, which we don't have yet.
        feeder = self.manager.feeder
        if feeder is not None:
            p_blocks, p_hashes = [], []
            for (h, _path, compressed), raw in zip(batch, reads):
                if not compressed and isinstance(raw, bytes):
                    p_blocks.append(raw)
                    p_hashes.append(h)
            if p_blocks:
                feeder.prefetch_scrub(p_blocks, p_hashes)
        return batch, list(reads), it.position

    def _forget_pool(self, batch: List[Tuple[Hash, str, bool]]) -> None:
        """Drop the device-pool pages of blocks just read from disk.  A
        page holds the bytes an earlier pass verified, not what the disk
        holds now: a scrub lane served from it would hash the clean page
        and pass a rotted file.  Dropped here, the lane hashes the bytes
        just read (or the page the prefetch stages from them)."""
        for h, _path, _c in batch:
            self.manager.pool_invalidate(h, "scrub_read")

    async def scrub_batch(self, batch: List[Tuple[Hash, str, bool]],
                          reads: Optional[List[Optional[bytes]]] = None) -> None:
        """Verify one batch through the codec; quarantine corrupt blocks.

        Plain blocks go through codec.batch_verify (the device dispatch);
        compressed blocks validate their zstd frame checksum on CPU, as in
        the reference (block.rs:66-78)."""
        mgr = self.manager
        plain_idx, plain_blocks, plain_hashes = [], [], []
        if reads is None:
            reads = await asyncio.gather(
                *[asyncio.to_thread(_try_read, mgr, path)
                  for _h, path, _c in batch]
            )
            self._forget_pool(batch)
        for i, ((h, path, compressed), raw) in enumerate(zip(batch, reads)):
            if raw is None:
                continue
            if raw is _READ_ERROR:
                # unreadable on media: the copy is as lost as a content
                # mismatch — quarantine it and let the sidecar/resync
                # ladder re-materialize a clean one
                await self._quarantine(h, path)
                continue
            if compressed:
                # decompress so the codec verifies the CONTENT hash (a
                # stronger check than the reference's zstd-checksum-only
                # verify, block.rs:66-78) and the block joins a parity
                # codeword — compressed blocks must be locally repairable
                # too, not just the plain ones
                data = await asyncio.to_thread(_try_decompress, raw)
                if data is None:
                    await self._quarantine(h, path)
                    continue
                plain_idx.append(i)
                plain_blocks.append(data)
                plain_hashes.append(h)
            else:
                plain_idx.append(i)
                plain_blocks.append(raw)
                plain_hashes.append(h)
        if plain_blocks:
            store = mgr.parity_store
            want_parity = (
                store is not None and mgr.codec.params.rs_data > 0
            )
            # prepend the carry (already-verified blocks from previous
            # batches) so RS codewords align to k across batch boundaries
            # — a per-prefix batch rarely holds k blocks by itself.  The
            # ≤ k-1 carry blocks are re-hashed by the fused dispatch and
            # the trailing partial row's parity is recomputed next batch:
            # bounded waste (< k blocks per batch) accepted to keep the
            # verify+encode a single codec call
            carry_b, carry_h = self._parity_carry if want_parity else ([], [])
            nc = len(carry_b)
            all_b = carry_b + plain_blocks
            all_h = carry_h + plain_hashes
            # span per fused dispatch: a slow batch (gated link, mid-pass
            # XLA compile, CPU steal) shows up in the slow-op log even on
            # nodes with no trace_sink configured
            with mgr.system.tracer.span(
                "Scrub batch", blocks=len(all_b),
                bytes=sum(len(b) for b in all_b),
            ):
                # through the codec feeder when armed: scrub batches are
                # background-class submissions in the SAME queue as the
                # foreground verifies, so on a device-armed node they
                # enter the zero-copy transport deadline-ordered behind
                # live traffic instead of talking to the device behind
                # the feeder's back (ops/transport.py); a closed/absent
                # feeder keeps the pre-transport direct call
                if mgr.feeder is not None:
                    ok, parity = await mgr.feeder.scrub_async(
                        all_b, all_h, want_parity)
                else:
                    ok, parity = await asyncio.to_thread(
                        mgr.codec.scrub_encode_batch, all_b, all_h,
                        want_parity,
                    )
            for j, good in enumerate(ok[nc:]):
                if not good:
                    h, path, _ = batch[plain_idx[j]]
                    await self._quarantine(h, path)
            # Coverage refresh: verified blocks with NO live distributed
            # codeword (distribution failed at write time, coverage was
            # wrongly tombstoned, or the data predates EC) re-enter the
            # write-side accumulator — scrub makes erasure coverage
            # convergent, mirroring how it refreshes local sidecars.
            #
            # Because every refreshed block is stored on THIS node, the
            # accumulator's distinct-primary invariant flushes per block
            # and the refresh emits 1-member partial codewords.  That is
            # the intended SAFE shape for a single-node stream: the k−1
            # implicit zero shards are always-available pieces, so the
            # member survives the loss of up to m of its parity nodes —
            # full m-loss tolerance at m×(block size) overhead, paid only
            # for refreshed blocks (rewritten objects regroup at k).
            acc = mgr.ec_accumulator
            if acc is not None and acc.distributor is not None:
                from .block import DataBlock

                cand = []
                for j, good in enumerate(ok[nc:]):
                    h = all_h[nc + j]
                    # NOT gated on acc.recently_added: that LRU remembers
                    # the WRITE-time add, which is exactly the add whose
                    # coverage may have been lost — locally_covered is
                    # the authoritative duplicate guard, and a rare
                    # double codeword (add raced an in-flight flush) is
                    # benign extra parity, reclaimed by normal GC
                    if good and not mgr.is_parity_block(h):
                        cand.append((h, all_b[nc + j]))

                def _uncovered():
                    # one off-loop hop for the whole batch: the per-hash
                    # index probes are synchronous DB iteration
                    d = acc.distributor
                    return [
                        (h, b) for h, b in cand
                        if d.holds_index_for(h) and not d.locally_covered(h)
                    ]

                for h, b in await asyncio.to_thread(_uncovered):
                    self.coverage_refreshed += 1
                    acc.add(h, DataBlock.plain(b))
            if want_parity and parity is not None:
                # persist RS sidecars for every COMPLETE codeword whose
                # members all verified — this is what makes a later
                # corruption locally repairable with zero network
                # (the BlockCodec north star's decode-repair half)
                k = mgr.codec.params.rs_data
                nrows = len(all_b) // k
                for row in range(nrows):
                    lo = row * k
                    if not all(ok[lo:lo + k]):
                        continue
                    # trim to the row's own width: pad columns beyond the
                    # longest member are zero parity (GF-linear) and would
                    # bloat the sidecar to the batch-global maxlen
                    row_max = max(len(b) for b in all_b[lo:lo + k])
                    await asyncio.to_thread(
                        store.put_codeword,
                        all_h[lo:lo + k],
                        [len(b) for b in all_b[lo:lo + k]],
                        np.asarray(parity[row])[:, :row_max],
                    )
                rest = nrows * k
                self._parity_carry = (
                    [b for b, good in zip(all_b[rest:], ok[rest:]) if good],
                    [h for h, good in zip(all_h[rest:],
                                          ok[rest:]) if good],
                )

    async def _quarantine(self, h: Hash, path: str) -> None:
        self.state.corruptions += 1
        self.manager.corruptions += 1
        logger.error("scrub: corrupted block %s at %s", bytes(h).hex()[:16], path)
        # manager.quarantine_path: counted (block_quarantine_total), and
        # a failing rename deletes the bad copy instead of silently
        # leaving it servable (the old _move_aside swallowed OSError)
        self.manager.pool_invalidate(h, "quarantine")
        await asyncio.to_thread(self.manager.quarantine_path, path)
        # first line of defense: rebuild locally from the RS parity
        # sidecar — with every replica down this is the ONLY repair;
        # network resync stays as the fallback
        store = self.manager.parity_store
        if store is not None:
            data = await asyncio.to_thread(store.try_reconstruct, h)
            if data is not None:
                from .block import DataBlock

                await self.manager.write_block(h, DataBlock.plain(data))
                self.manager.blocks_reconstructed += 1
                self.manager.note_heal("local_sidecar")
                return
        if self.manager.resync is not None:
            self.manager.resync.put_to_resync(h, 0.0,
                                              source="scrub_corrupt")

    async def wait_for_work(self) -> None:
        self._wake.clear()
        delay = max(1.0, (self.state.time_next_run - now_msec()) / 1000.0)
        try:
            await asyncio.wait_for(self._wake.wait(), timeout=min(delay, 10.0))
        except asyncio.TimeoutError:
            pass


class LayoutSweepMarker(Migrated):
    """Ring-assignment digest persisted AFTER a layout sweep completes: a
    node that crashed mid-sweep (or was down for the layout change
    entirely) finds a stale digest at startup and re-sweeps — without
    this, gained assignments would hold holes until the next unrelated
    ring change."""

    VERSION_MARKER = b"GT01lsweep"

    def __init__(self, digest: bytes = b""):
        self.digest = digest

    def fields(self):
        return [self.digest]

    @classmethod
    def from_fields(cls, body):
        return cls(bytes(body[0]))


class RepairWorker(Worker):
    """One-shot consistency repair (ref repair.rs:35-155): phase 1 enqueues
    every referenced hash to resync; phase 2 walks the disk and enqueues
    every found block (catches rc=0 leftovers).

    refs_only=True runs phase 1 alone — the shape used by the automatic
    layout-change sweep (spawned on every ring change): a ring change by
    itself fires no table hook, so a node that GAINED the assignment for
    an already-referenced block (rc>0, no 0→1 incref) would otherwise
    hold a hole until an operator ran `repair blocks`.  The reference
    leaves this to the operator; the sweep makes post-failure healing
    self-driven.  restart() rewinds a still-running sweep instead of
    stacking a second one (ring changes arrive in bursts as a layout
    propagates); on_done fires once when the sweep completes (the model
    layer persists the swept ring digest there)."""

    def __init__(self, manager, refs_only: bool = False, on_done=None):
        self.manager = manager
        self.refs_only = refs_only
        self.on_done = on_done
        self.phase = 1
        self.cursor: Optional[bytes] = b""
        self.iterator: Optional[BlockStoreIterator] = None
        self.finished = False

    def restart(self) -> None:
        self.phase = 1
        self.cursor = b""
        self.iterator = None

    def _done(self) -> WorkerState:
        self.finished = True
        if self.on_done is not None:
            try:
                self.on_done()
            except Exception:
                # e.g. marker persistence hitting disk-full: the sweep
                # itself succeeded, but the node will re-sweep at next
                # boot — say so instead of hiding the degradation
                logger.warning("repair worker on_done callback failed",
                               exc_info=True)
        return WorkerState.DONE

    def name(self) -> str:
        return "Block layout sweep" if self.refs_only else "Block repair worker"

    async def work(self) -> WorkerState:
        mgr = self.manager
        if self.phase == 1:
            # phase 1 is pure CPU (db iteration) and the worker runner
            # re-invokes BUSY workers back-to-back: yield the event loop
            # once per batch or a large rc table freezes RPC/S3 handling
            # for the whole scan — worst exactly when a layout change
            # just made the cluster fragile
            await asyncio.sleep(0)
            batch = 0
            while batch < REPAIR_BATCH:
                nxt = (
                    mgr.rc.tree.first()
                    if self.cursor == b""
                    else mgr.rc.get_gt(self.cursor)
                )
                if nxt is None:
                    if self.refs_only:
                        return self._done()
                    self.phase = 2
                    self.iterator = BlockStoreIterator(
                        [d.path for d in mgr.data_layout.data_dirs]
                    )
                    return WorkerState.BUSY
                key, _v = nxt
                mgr.resync.put_to_resync(
                    Hash(key), 0.0,
                    source="layout_sweep" if self.refs_only
                    else "repair_sweep")
                self.cursor = key
                batch += 1
            self.status().progress = "phase 1"
            # the backlog this sweep is generating: resync drains it, so
            # `worker list` shows sweep progress AND the induced queue
            self.status().queue_length = mgr.resync.queue_len()
            return WorkerState.BUSY
        batch = await asyncio.to_thread(self.iterator.next_prefix)
        if batch is None:
            return self._done()
        for h, _path, _c in batch:
            mgr.resync.put_to_resync(h, 0.0, source="repair_sweep")
        self.status().progress = f"phase 2: {self.iterator.progress() * 100:.1f}%"
        return WorkerState.BUSY


class RebalanceWorker(Worker):
    """One-shot: move blocks into their primary dir after a layout change,
    dropping secondary copies (ref repair.rs:531-626)."""

    def __init__(self, manager):
        self.manager = manager
        self.iterator = BlockStoreIterator(
            [d.path for d in manager.data_layout.data_dirs]
        )
        self.moved = 0

    def name(self) -> str:
        return "Block rebalance worker"

    async def work(self) -> WorkerState:
        mgr = self.manager
        batch = await asyncio.to_thread(self.iterator.next_prefix)
        if batch is None:
            logger.info("rebalance done, moved %d blocks", self.moved)
            return WorkerState.DONE
        for h, path, compressed in batch:
            primary = mgr.block_path(mgr.data_layout.primary_dir(h), h, compressed)
            if os.path.abspath(path) == os.path.abspath(primary):
                continue
            await asyncio.to_thread(_move_into_place, mgr, path, primary)
            self.moved += 1
        self.status().progress = f"{self.iterator.progress() * 100:.1f}%"
        return WorkerState.BUSY


# sentinel distinguishing "file unreadable, disk implicated" from a
# benign concurrent deletion (None): scrub_batch quarantines the former
_READ_ERROR = object()


def _try_read(mgr, path: str):
    """Scrub read through the manager's disk seam (DiskIo.
    read_file_direct: O_DIRECT with buffered fallback — the buffered
    path is kernel-CPU-bound on 1-core hosts and scrubbing through the
    page cache evicts the GET path's working set, see
    utils/direct_io.py).  Returns the bytes; None for a vanished file
    (deleted concurrently) or a transient resource error (EMFILE-class
    — skip this pass, the copy is fine); ``_READ_ERROR`` for a media
    error, after feeding the root's health accounting so a scrub
    churning through an EIO-ing disk shows up in disk_error_total and
    the root's breaker instead of staying silently 'ok'.

    A SUCCESSFUL read reports note_ok: the streak is *consecutive*
    errors, and on an archival node with no client GETs the scrub is
    the only reader — without the reset, isolated bad sectors spread
    over weeks of passes would accumulate into a streak and flip a
    fundamentally healthy root read-only."""
    from .health import is_media_error

    try:
        raw = mgr.disk.read_file_direct(path)
    except FileNotFoundError:
        return None
    except OSError as e:
        if not is_media_error(e):
            logger.warning("scrub: transient read error on %s "
                           "(errno %s: %s)", path, e.errno, e)
            return None
        logger.error("scrub: read of %s failed (errno %s: %s)",
                     path, e.errno, e)
        mgr.health.note_error(mgr._root_of(path), "scrub", e)
        return _READ_ERROR
    mgr.health.note_ok(mgr._root_of(path), "scrub")
    return raw


def _try_decompress(raw: bytes) -> Optional[bytes]:
    from ..utils.zstd_compat import zstandard

    try:
        return zstandard.ZstdDecompressor().decompress(raw)
    except zstandard.ZstdError:
        return None


def _move_into_place(mgr, src: str, dst: str) -> None:
    """Rebalance move through the manager's disk seam so FaultyDisk can
    inject into it and a media error feeds the destination root's
    health accounting before surfacing to the worker error handler."""
    from .health import is_media_error

    try:
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if os.path.exists(dst):
            mgr.disk.remove(src)
        else:
            mgr.disk.replace(src, dst)
    except OSError as e:
        if is_media_error(e):
            mgr.health.note_error(mgr._root_of(dst), "rebalance", e)
        raise
