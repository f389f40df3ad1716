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
(repair.rs:438-490).  Here the read-ahead lists successive `xx/yy`
prefix directories, whole, into a *window* until it holds at least the
codec's `batch_blocks` blocks or the pass ends, and the window goes to
the codec as one dispatch (plus, with parity sidecars, the < k verified
blocks carried over to fill a codeword).  A store of fewer than ~65k
blocks spreads about one block over each of its prefixes, so without
the window the codec would see about one block per dispatch.  Each
`work()` still settles one prefix (its quarantines, its sidecars, its
checkpoint position), so the persisted and resumed positions are the
reference's, prefix by prefix.
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
from ..utils.timeline import Src, current_src, submitting
from ..utils.tranquilizer import Tranquilizer

logger = logging.getLogger("garage_tpu_torch.block.repair")

SCRUB_INTERVAL_MIN = 25 * 86400   # ref repair.rs:24 (randomized 25-35 days)
SCRUB_INTERVAL_MAX = 35 * 86400
DEFAULT_SCRUB_TRANQUILITY = 4     # ref repair.rs:27
CHECKPOINT_INTERVAL = 60.0        # ref repair.rs:460-464
REPAIR_BATCH = 1000               # ref repair.rs:92-101 (sqlite-safe batches)
# threads reading a scrub window's files, each a contiguous run of it: a
# thread per file (the default executor's up to 32) read no faster on
# the card's host and doubled the event loop's stalls on the GIL
SCRUB_READ_THREADS = 8


class BlockStoreIterator:
    """Hash-ordered walk over every block file across all data dirs,
    resumable from a serialized position (ref repair.rs:634-764).

    Position = last fully-processed 2-level prefix (0..65536); progress is
    prefix/65536 — equivalent to the reference's fixed-point fraction."""

    def __init__(self, roots: List[str], position: int = 0,
                 walk: Optional["BlockStoreIterator"] = None):
        self.roots = roots
        self.position = position  # next 2-byte prefix to scan
        self._prefixes: Optional[List[int]] = None  # existing dirs, sorted
        # a look-ahead cursor shares its walk's prefix scan
        self._walk = walk

    def look_ahead(self, position: int) -> "BlockStoreIterator":
        """A second cursor over this walk, from ``position``: the two
        share one scan of the prefix dirs."""
        return BlockStoreIterator(self.roots, position, walk=self)

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

    def advance(self) -> Optional[int]:
        """Move past the next existing prefix dir without listing it and
        return it; None when the walk is complete."""
        import bisect

        walk = self._walk or self
        if walk._prefixes is None:
            walk._prefixes = walk._scan_prefixes()
        i = bisect.bisect_left(walk._prefixes, self.position)
        if i >= len(walk._prefixes) or self.is_done():
            self.position = 65536
            return None
        p = walk._prefixes[i]
        self.position = p + 1
        return p

    def next_prefix(self) -> Optional[List[Tuple[Hash, str, bool]]]:
        """All blocks under the next existing prefix dir:
        [(hash, path, compressed)]; None when the walk is complete."""
        p = self.advance()
        if p is None:
            return None
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


class _Window:
    """Successive prefixes read ahead together and verified in one codec
    dispatch: ``groups`` holds (the walk's position after the prefix,
    its entries in ``batch``) in walk order, and ``work()`` settles one
    group at a time from ``judged``."""

    __slots__ = ("groups", "batch", "reads", "src", "ready_ns", "judged",
                 "settled")

    def __init__(self, groups, batch, reads, src: Src, ready_ns: int):
        self.groups: List[Tuple[int, int]] = groups
        self.batch: List[Tuple[Hash, str, bool]] = batch
        self.reads: List = reads
        self.src = src
        self.ready_ns = ready_ns
        self.judged: Optional[_Judged] = None
        self.settled = 0  # batch entries of the groups settled so far


class _Judged:
    """What one dispatch found about a batch, for settling it: the
    entries set aside before the dispatch (unreadable media, a frame
    that does not decompress) with their bytes, each verified entry's
    index in the dispatched stream (the parity carry first), the
    stream's verdicts and parity, and the parity carry as indices into
    the stream."""

    __slots__ = ("aside", "at", "blocks", "hashes", "ok", "parity",
                 "want_parity", "carry")

    def __init__(self, aside, at, blocks, hashes, ok, parity,
                 want_parity: bool, nc: int):
        self.aside: dict = aside
        self.at: dict = at
        self.blocks: List[bytes] = blocks
        self.hashes: List[Hash] = hashes
        self.ok = ok
        self.parity = parity
        self.want_parity = want_parity
        self.carry: List[int] = list(range(nc))


class ScrubWorker(Worker):
    """Batch-first scrub: BlockStoreIterator prefixes, coalesced into
    windows of ``batch_blocks`` blocks → one codec dispatch per window →
    corrupted blocks moved aside + requeued for resync, one prefix per
    ``work()``."""

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
        # read-ahead: the next window's file contents load while the
        # current one verifies, listed by a look-ahead cursor of its own;
        # ``iterator`` stays where a one-prefix read-ahead would have
        # moved it, and checkpoints record the VERIFIED position
        self._ra_task: Optional[asyncio.Task] = None
        self._cursor: Optional[BlockStoreIterator] = None
        self._window: Optional[_Window] = None  # dispatched, not settled
        self._verified_pos = self.state.position
        # verified plain blocks carried between batches until a full RS
        # codeword (k blocks) accumulates for the parity sidecar store
        self._parity_carry: Tuple[list, list] = ([], [])
        self._prev_pass_start = 0.0  # resumed pass: purge nothing extra
        # numbers the batches on the node's timeline (the ``scrub``
        # track; the feeder and transport events carry it as ``src``)
        self._batch_seq = 0
        self._last_src = Src(0)  # the batch work() last took

    def _roots(self) -> List[str]:
        return [d.path for d in self.manager.data_layout.data_dirs]

    def _new_src(self) -> Src:
        self._batch_seq += 1
        return Src(self._batch_seq)

    def _span(self, name: str, t0: int, src: Src, blocks: int,
              nbytes: int, t1: Optional[int] = None, **args) -> None:
        """One event of the ``scrub`` track, [t0, t1 or now] (monotonic
        ns)."""
        self.manager.codec.obs.timeline.event(
            name, "scrub", t0, t1 or time.monotonic_ns(), cat="scrub",
            batch=src.id, blocks=blocks, bytes=nbytes, **args)

    def throttled(self, since_ns: int) -> None:
        """The load governor's pause after a batch (utils/background.py),
        with the signal that pressed hardest."""
        gov = getattr(self.manager, "governor", None)
        sig = gov.signals() if gov is not None else {}
        self._span("scrub throttle", since_ns, self._last_src, 0, 0,
                   signal=max(sig, key=lambda k: sig[k] or 0.0, default=""))

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
        self._cursor = None
        self._window = None

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
        win = self._window
        if win is None:
            task = self._ra_task or asyncio.ensure_future(self._read_ahead())
            # clear BEFORE awaiting: if the read fails, the next work()
            # cycle must retry a fresh read, not re-await the cached
            # exception
            self._ra_task = None
            t_await = time.monotonic_ns()
            win = await task
            if win is None:
                # complete
                st.time_last_complete = now_msec()
                st.time_next_run = randomize_next_scrub()
                st.running = False
                self.iterator = None
                self._cursor = None
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
                logger.info("scrub complete, %d corruptions found",
                            st.corruptions)
                return WorkerState.BUSY
            self._last_src = win.src
            # the read the previous window's verify did not hide ends at
            # ready_ns; from there to now the worker waited on the loop
            self._span("scrub await_read", t_await, win.src, len(win.batch),
                       _nbytes(win.reads), ready_ns=win.ready_ns)
            # read the NEXT window while this one verifies: disk reads
            # overlap the codec dispatch (read→batch→device, SURVEY.md §3.4)
            self._ra_task = asyncio.ensure_future(self._read_ahead())
            if win.batch:
                with submitting(win.src):
                    win.judged = await self.scrub_batch(win.batch, win.reads)
            self._window = win
        # settle the window's next prefix, from the verdicts the dispatch
        # already holds
        src = win.src
        pos_after, n = win.groups.pop(0)
        lo = win.settled
        win.settled += n
        if not win.groups:
            self._window = None
        # where the reference's one-prefix read-ahead has moved the walk
        self.iterator.position = pos_after
        self.iterator.advance()
        status.progress = f"{self.iterator.progress() * 100:.2f}%"
        if win.judged is not None and n:
            with submitting(src):
                await self._settle(win.judged, win.batch[lo:lo + n], lo, src)
        self._verified_pos = pos_after
        self._checkpoint()
        if st.tranquility <= 0:
            return await self.tranquilizer.tranquilize_worker(st.tranquility)
        t0 = time.monotonic_ns()
        state = await self.tranquilizer.tranquilize_worker(st.tranquility)
        self._span("scrub tranquilize", t0, src, n, 0)
        return state

    async def _read_ahead(self) -> Optional[_Window]:
        """The next window, read off-thread: successive prefixes, whole,
        until it holds the codec's ``batch_blocks`` blocks or the walk
        ends (a prefix that fills it alone makes a window by itself),
        with their file contents; None at end-of-store."""
        it = self.iterator
        if it is None:
            return None
        if self._cursor is None:
            self._cursor = it.look_ahead(self._verified_pos)
        cur = self._cursor
        want = max(1, int(self.manager.codec.params.batch_blocks))
        src = self._new_src()

        def listing():
            t0 = time.monotonic_ns()
            groups, batch = [], []
            while len(batch) < want:
                found = cur.next_prefix()
                if found is None:
                    break
                groups.append((cur.position, len(found)))
                batch.extend(found)
            self._span("scrub list", t0, src, len(batch), 0,
                       prefixes=len(groups))
            return groups, batch

        groups, batch = await asyncio.to_thread(listing)
        if not groups:
            return None

        def read_run(run):
            return [_read_stamped(self.manager, path) for _h, path, _c in run]

        step = max(1, -(-len(batch) // SCRUB_READ_THREADS))
        runs = await asyncio.gather(
            *[asyncio.to_thread(read_run, batch[i:i + step])
              for i in range(0, len(batch), step)])
        stamped = [r for run in runs for r in run]
        reads = [raw for _t0, raw, _t1 in stamped]
        if stamped:
            self._span("scrub read", min(t0 for t0, _r, _t1 in stamped),
                       src, len(batch), _nbytes(reads),
                       t1=max(t1 for _t0, _r, t1 in stamped),
                       prefixes=_prefixes(batch))
        self._forget_pool(batch)
        # hint the device pool about the upcoming window: the transport
        # stages these blocks as background-class work WHILE the current
        # window computes (riding the transport's double buffer), so the
        # next window's H2D cost hides under compute and its scrub becomes
        # a pool hit.  Plain blocks only — compressed copies are verified
        # on their decompressed content, which we don't have yet.
        feeder = self.manager.feeder
        if feeder is not None:
            p_blocks, p_hashes = [], []
            for (h, _path, compressed), raw in zip(batch, reads):
                if not compressed and isinstance(raw, bytes):
                    p_blocks.append(raw)
                    p_hashes.append(h)
            if p_blocks:
                with submitting(src):
                    feeder.prefetch_scrub(p_blocks, p_hashes)
        return _Window(groups, batch, reads, src, time.monotonic_ns())

    def _forget_pool(self, batch: List[Tuple[Hash, str, bool]]) -> None:
        """Drop the device-pool pages of blocks just read from disk.  A
        page holds the bytes an earlier pass verified, not what the disk
        holds now: a scrub lane served from it would hash the clean page
        and pass a rotted file.  Dropped here, the lane hashes the bytes
        just read (or the page the prefetch stages from them)."""
        for h, _path, _c in batch:
            self.manager.pool_invalidate(h, "scrub_read")

    async def scrub_batch(self, batch: List[Tuple[Hash, str, bool]],
                          reads: Optional[List[Optional[bytes]]] = None
                          ) -> _Judged:
        """Verify one batch through the codec in one dispatch and return
        what it found; ``_settle`` sets aside the corrupt blocks and
        writes the sidecars, one prefix at a time.

        Plain blocks go through the codec's fused verify (the device
        dispatch); compressed blocks join it decompressed, verified on
        their CONTENT hash (a stronger check than the reference's
        zstd-checksum-only verify, block.rs:66-78), so that they join a
        parity codeword too — compressed blocks must be locally
        repairable, not just the plain ones."""
        mgr = self.manager
        # the batch on the node's timeline: the one work() is running,
        # or a new one for a direct call
        src = current_src() or self._new_src()
        if reads is None:
            reads = await asyncio.gather(
                *[asyncio.to_thread(_try_read, mgr, path)
                  for _h, path, _c in batch]
            )
            self._forget_pool(batch)
        # judged before the dispatch, set aside when their prefix
        # settles: a copy unreadable on media is as lost as a content
        # mismatch (the sidecar/resync ladder re-materializes a clean
        # one), and so is a compressed frame that does not decompress
        aside, plain, packed = {}, {}, []
        for i, ((_h, _path, compressed), raw) in enumerate(zip(batch, reads)):
            if raw is None:
                continue
            if raw is _READ_ERROR:
                aside[i] = 0
            elif compressed:
                packed.append(i)
            else:
                plain[i] = raw
        datas = await asyncio.gather(
            *[asyncio.to_thread(_try_decompress, reads[i]) for i in packed])
        for i, data in zip(packed, datas):
            if data is None:
                aside[i] = len(reads[i])
            else:
                plain[i] = data
        order = sorted(plain)
        store = mgr.parity_store
        want_parity = store is not None and mgr.codec.params.rs_data > 0
        # prepend the carry (already-verified blocks from previous
        # batches) so RS codewords align to k across batch boundaries.
        # The ≤ k-1 carry blocks are re-hashed by the fused dispatch:
        # bounded waste (< k blocks per batch) accepted to keep the
        # verify+encode a single codec call
        carry_b, carry_h = self._parity_carry if want_parity else ([], [])
        nc = len(carry_b)
        all_b = carry_b + [plain[i] for i in order]
        all_h = carry_h + [batch[i][0] for i in order]
        at = {i: nc + n for n, i in enumerate(order)}
        ok, parity = [], None
        if order:
            # span per fused dispatch: a slow batch (gated link, mid-pass
            # compile, CPU steal) shows up in the slow-op log even on
            # nodes with no trace_sink configured
            nbytes = sum(len(b) for b in all_b)
            src.delivered_ns = 0
            t_submit = time.monotonic_ns()
            with mgr.system.tracer.span(
                "Scrub batch", blocks=len(all_b), bytes=nbytes,
            ), submitting(src):
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
                    def direct():
                        try:
                            return mgr.codec.scrub_encode_batch(
                                all_b, all_h, want_parity)
                        finally:
                            src.delivered()
                    ok, parity = await asyncio.to_thread(direct)
            # delivered_ns: the moment the feeder or transport resolved
            # the batch; from there to now the worker waited on the loop
            self._span("scrub verify", t_submit, src, len(all_b), nbytes,
                       delivered_ns=src.delivered_ns,
                       prefixes=_prefixes(batch[i] for i in order))
        return _Judged(aside, at, all_b, all_h, ok, parity, want_parity, nc)

    async def _settle(self, judged: _Judged,
                      entries: List[Tuple[Hash, str, bool]], lo: int,
                      src: Src) -> None:
        """Settle one prefix of a verified batch (its ``entries`` start at
        ``lo``): set aside what failed, refresh erasure coverage, write
        the sidecars of the codewords it completes."""
        mgr = self.manager
        for i, (h, path, _c) in enumerate(entries, lo):
            if i in judged.aside:
                await self._quarantine(h, path, src, judged.aside[i])
        idx = [judged.at[i] for i in range(lo, lo + len(entries))
               if i in judged.at]
        if not idx:
            return
        ok, blocks = judged.ok, judged.blocks
        for i, (h, path, _c) in enumerate(entries, lo):
            s = judged.at.get(i)
            if s is not None and not ok[s]:
                await self._quarantine(h, path, src, len(blocks[s]))
        acc = mgr.ec_accumulator
        sidecars = judged.want_parity and judged.parity is not None
        posts = acc is not None and acc.distributor is not None or sidecars
        t_post = time.monotonic_ns()
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
        if acc is not None and acc.distributor is not None:
            from .block import DataBlock

            # NOT gated on acc.recently_added: that LRU remembers the
            # WRITE-time add, which is exactly the add whose coverage
            # may have been lost — locally_covered is the authoritative
            # duplicate guard, and a rare double codeword (add raced an
            # in-flight flush) is benign extra parity, reclaimed by
            # normal GC
            cand = [(judged.hashes[s], blocks[s]) for s in idx
                    if ok[s] and not mgr.is_parity_block(judged.hashes[s])]

            def _uncovered():
                # one off-loop hop for the whole prefix: the per-hash
                # index probes are synchronous DB iteration
                d = acc.distributor
                return [
                    (h, b) for h, b in cand
                    if d.holds_index_for(h) and not d.locally_covered(h)
                ]

            for h, b in await asyncio.to_thread(_uncovered):
                self.coverage_refreshed += 1
                acc.add(h, DataBlock.plain(b))
        if sidecars:
            await self._post_sidecars(judged, idx)
        if posts:
            self._span("scrub post", t_post, src, len(idx),
                       sum(len(blocks[s]) for s in idx))

    async def _post_sidecars(self, judged: _Judged, idx: List[int]) -> None:
        """Persist RS sidecars for every COMPLETE codeword whose members
        all verified — this is what makes a later corruption locally
        repairable with zero network (the BlockCodec north star's
        decode-repair half).

        Rows form as a one-prefix batch forms them: the carry, then the
        prefix's blocks (``idx``, stream indices), k at a time; the
        trailing partial row's verified blocks carry on.  A row that is
        also a row of the dispatch (k aligned stream entries) takes the
        dispatch's parity.  A block that fails in a trailing partial row
        drops out of the carry and shifts every later row against the
        dispatch's: their parity is computed again."""
        store = self.manager.parity_store
        k = self.manager.codec.params.rs_data
        ok, blocks, hashes = judged.ok, judged.blocks, judged.hashes
        stream = judged.carry + idx
        nrows = len(stream) // k
        rows = [m for m in (stream[r * k:(r + 1) * k] for r in range(nrows))
                if all(ok[s] for s in m)]
        shifted = [m for m in rows if m[0] % k or m[-1] - m[0] != k - 1]
        fresh = {}
        if shifted:
            par = await self._encode([blocks[s] for m in shifted for s in m])
            fresh = {m[0]: par[r] for r, m in enumerate(shifted)}
        for m in rows:
            parity = fresh[m[0]] if m[0] in fresh else judged.parity[m[0] // k]
            # trim to the row's own width: pad columns beyond the
            # longest member are zero parity (GF-linear) and would
            # bloat the sidecar to the batch-global maxlen
            row_max = max(len(blocks[s]) for s in m)
            await asyncio.to_thread(
                store.put_codeword,
                [hashes[s] for s in m],
                [len(blocks[s]) for s in m],
                np.asarray(parity)[:, :row_max],
            )
        judged.carry = [s for s in stream[nrows * k:] if ok[s]]
        self._parity_carry = ([blocks[s] for s in judged.carry],
                              [hashes[s] for s in judged.carry])

    async def _encode(self, blocks: List[bytes]) -> np.ndarray:
        """RS parity of whole codewords, through the feeder when armed."""
        from ..ops.feeder import FeederClosed

        feeder = self.manager.feeder
        if feeder is not None:
            try:
                return await asyncio.wrap_future(
                    feeder.submit_encode(blocks, cls="bg"))
            except FeederClosed:
                pass
        return await asyncio.to_thread(self.manager.codec.rs_encode_blocks,
                                       blocks)

    async def _quarantine(self, h: Hash, path: str, src: Src,
                          nbytes: int = 0) -> None:
        t0 = time.monotonic_ns()
        try:
            await self._set_aside(h, path)
        finally:
            self._span("scrub quarantine", t0, src, 1, nbytes)

    async def _set_aside(self, h: Hash, path: str) -> None:
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


def _nbytes(reads) -> int:
    return sum(len(r) for r in reads if r is not None and r is not _READ_ERROR)


def _prefixes(entries) -> int:
    """How many ``xx/yy`` prefixes the (hash, path, compressed) entries
    come from."""
    return len({bytes(h)[:2] for h, _path, _c in entries})


def _read_stamped(mgr, path: str):
    """``_try_read`` between two monotonic ns stamps: (t0, raw, t1)."""
    t0 = time.monotonic_ns()
    raw = _try_read(mgr, path)
    return t0, raw, time.monotonic_ns()


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
