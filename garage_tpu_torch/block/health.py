"""Disk-fault robustness: the manager's filesystem boundary, the
per-root health state machine, and the crash-consistency janitor.

The reference trusts the local disk blindly — `write_block` has no
ENOSPC story and a read-time EIO surfaces as an unhandled error
(ref src/block/manager.rs:478-590).  Its durability loop (scrub →
quarantine → resync refetch, repair.rs/resync.rs) only covers *content*
corruption.  This module gives the storage layer the same degraded-mode
treatment the circuit breakers give the RPC layer:

  - ``DiskIo`` — every byte BlockManager moves to or from disk goes
    through one of these methods, so a test (``testing/faults.py``
    FaultyDisk) can inject EIO / ENOSPC / fsync failure / torn writes /
    bit-rot / latency at exactly the boundary the real kernel would.
  - ``DiskHealthMonitor`` — per-data-root ``ok → degraded(read-only) →
    failed`` state machine, driven by a free-space watermark (statvfs
    preflight before every block write) and by disk-error streaks via
    the same ``CircuitBreaker`` the RPC layer uses per peer
    (net/resilience.py).  A degraded root rejects writes with a typed
    ``StorageFull``/``StorageError`` wire code so write quorums route
    around the node while reads keep flowing.
  - ``janitor_pass`` — boot-time crash-consistency sweep: purge
    orphaned ``.tmp`` files (a torn write whose rename never happened —
    by construction unacknowledged), bound the ``.corrupted``
    quarantine (oldest-first purge over a files/bytes budget), and
    report quarantined hashes so the caller re-enqueues them for
    resync.

Everything here is synchronous and dependency-light; BlockManager calls
it from threads (to_thread) on hot paths and inline at boot.
"""

from __future__ import annotations

import errno
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..net.resilience import CircuitBreaker, ResilienceTunables
from ..utils.direct_io import write_file_direct
from ..utils.error import StorageError, StorageFull

logger = logging.getLogger("garage_tpu_torch.block.health")

# disk_root_state gauge encoding (docs/ROBUSTNESS.md + dashboard
# mappings rely on these values, mirroring BREAKER_STATE_VALUES)
DISK_STATE_VALUES = {"ok": 0.0, "degraded": 1.0, "failed": 2.0}

# a root whose consecutive-error streak reaches threshold × this factor
# is FAILED: even the half-open write probe is refused, only successful
# reads (or operator intervention) walk it back
DISK_FAILED_FACTOR = 4

# quarantine purge policy defaults (config quarantine_max_files/_bytes)
QUARANTINE_MAX_FILES = 128
QUARANTINE_MAX_BYTES = 256 << 20


class DiskIo:
    """The manager's filesystem boundary.  One instance per
    BlockManager (``manager.disk``); FaultyDisk wraps it to inject
    faults per data root without monkeypatching os.*  Methods raise
    plain OSError — classification into StorageFull/StorageError
    happens at the manager, where the root is known.

    Every call also accumulates per-root busy seconds (``busy_seconds``,
    keyed by the root the path maps to via the manager-installed
    ``root_of`` hook) — the per-root U of the USE method, scraped as
    ``disk_busy_seconds{root=}``.  Two clock reads per I/O call,
    negligible next to the syscall."""

    def __init__(self):
        # set by BlockManager: path -> data-root; unmapped paths (meta
        # dir fsyncs, tests) accumulate under ""
        self.root_of = None
        self.busy_seconds: dict = {}
        # concurrent executor threads finish I/O on the same root: the
        # read-modify-write below would lose increments without a lock —
        # exactly under the load the gauge exists to diagnose
        self._busy_lock = threading.Lock()

    def _note(self, path: str, t0: float) -> None:
        dt = time.perf_counter() - t0
        fn = self.root_of
        try:
            root = fn(path) if fn is not None else ""
        except Exception:  # noqa: BLE001 — accounting must never raise
            root = ""
        root = root or ""
        with self._busy_lock:
            self.busy_seconds[root] = self.busy_seconds.get(root, 0.0) + dt

    def read_file(self, path: str) -> bytes:
        t0 = time.perf_counter()
        try:
            with open(path, "rb") as f:
                return f.read()
        finally:
            self._note(path, t0)

    def read_file_direct(self, path: str) -> bytes:
        """O_DIRECT read (buffered fallback inside) — the scrub path's
        flavor: it must not evict the GET path's page-cache working set
        (see utils/direct_io.py)."""
        from ..utils.direct_io import read_file_direct
        t0 = time.perf_counter()
        try:
            return read_file_direct(path)
        finally:
            self._note(path, t0)

    def write_file(self, path: str, data: bytes, fsync: bool = False) -> None:
        t0 = time.perf_counter()
        try:
            write_file_direct(path, data, fsync=fsync)
        finally:
            self._note(path, t0)

    def replace(self, src: str, dst: str) -> None:
        t0 = time.perf_counter()
        try:
            os.replace(src, dst)
        finally:
            self._note(dst, t0)

    def remove(self, path: str) -> None:
        os.remove(path)

    def fsync_dir(self, path: str) -> None:
        t0 = time.perf_counter()
        dirfd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
            self._note(path, t0)

    def statvfs(self, path: str):
        return os.statvfs(path)


def _error_kind(e: BaseException) -> str:
    """Bounded-cardinality label for a disk error: the errno mnemonic
    (EIO, ENOSPC, …) when there is one, the class name otherwise."""
    eno = getattr(e, "errno", None)
    if eno is not None:
        return errno.errorcode.get(eno, f"E{eno}")
    return type(e).__name__


# OSError kinds that blame the PROCESS, not the disk: fd exhaustion,
# memory pressure, interrupted syscalls.  They clear the moment load
# drops, so they must never quarantine a healthy copy or feed a root's
# error streak (32 EMFILE reads would otherwise latch the root FAILED
# and mass-evict good data).  Everything else — EIO, EROFS, EISDIR,
# ENOTDIR, unknown errnos — implicates the media or the on-disk layout.
_TRANSIENT_ERRNOS = frozenset(
    getattr(errno, n) for n in
    ("EMFILE", "ENFILE", "ENOMEM", "EAGAIN", "EWOULDBLOCK", "EINTR",
     "EDEADLK")
    if hasattr(errno, n))


def is_media_error(e: BaseException) -> bool:
    """Does this OSError justify destructive handling (quarantine the
    copy, feed the root's health streak), or is it transient process
    resource pressure where the bytes on disk are fine?"""
    return getattr(e, "errno", None) not in _TRANSIENT_ERRNOS


class DiskHealthMonitor:
    """Per-data-root health: ``ok → degraded(read-only) → failed``.

    Two independent drivers, matching how disks actually die:

      - **space**: a cached statvfs preflight before every write; free
        bytes below ``watermark`` flips the root read-only
        (``StorageFull``) until space recovers — no error streak needed,
        full is not broken.
      - **errors**: read/write OSErrors feed a per-root CircuitBreaker
        (reused from net/resilience.py, injectable clock): a streak of
        ``error_threshold`` opens it → degraded (writes rejected with
        ``StorageError``, reads keep flowing and failing over per-hash);
        after ``cooldown`` one half-open probe write is admitted, and a
        success closes it.  A streak of ``error_threshold ×
        DISK_FAILED_FACTOR`` latches FAILED: no probe writes at all;
        only a successful operation (reads still run) resets the streak
        and walks the root back through the breaker.

    Any successful op on the root clears the streak — a disk serving
    reads fine while a write blips is flaky, not dead; the watermark
    covers the common write-only failure (disk full) regardless."""

    def __init__(
        self,
        roots: List[str],
        watermark: int = 128 << 20,
        error_threshold: int = 8,
        cooldown: float = 30.0,
        statvfs: Optional[Callable[[str], object]] = None,
        clock: Callable[[], float] = time.monotonic,
        counter=None,          # disk_error_total{op,kind} (optional)
    ):
        self.watermark = int(watermark)
        self.error_threshold = max(1, int(error_threshold))
        self.cooldown = float(cooldown)
        self._statvfs = statvfs or (lambda p: os.statvfs(p))
        self._clock = clock
        self._counter = counter
        self._tun = ResilienceTunables(
            breaker_failure_threshold=self.error_threshold,
            breaker_open_secs=self.cooldown,
            # every disk error is its own event: the burst dedupe exists
            # for one TCP conn failing N RPCs at once, which has no disk
            # analogue, and tests need deterministic streak counting
            breaker_failure_window=0.0,
        )
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._streak: Dict[str, int] = {}
        self._space_low: Dict[str, bool] = {}
        # root -> (checked_at, free_bytes|None); statvfs is cheap but a
        # hot write path must not syscall per block
        self._space_cache: Dict[str, Tuple[float, Optional[int]]] = {}
        self.cache_ttl = 0.5
        self.error_counts: Dict[Tuple[str, str], int] = {}
        for r in roots:
            self._ensure(r)

    @staticmethod
    def _norm(root: str) -> str:
        """One accounting key per root regardless of trailing slashes:
        a data_dir configured as '/data/' must not split its health
        between '/data/' (registered) and '/data' (what the manager's
        longest-prefix _root_of derives from block paths)."""
        return root.rstrip(os.sep) or os.sep

    def _ensure(self, root: str) -> CircuitBreaker:
        root = self._norm(root)
        br = self._breakers.get(root)
        if br is None:
            br = CircuitBreaker(self._tun, clock=self._clock)
            self._breakers[root] = br
            self._streak[root] = 0
            self._space_low[root] = False
        return br

    def roots(self) -> List[str]:
        return list(self._breakers)

    # --- space watermark ---

    def free_bytes(self, root: str, fresh: bool = False) -> Optional[int]:
        """Cached statvfs free bytes; None when statvfs itself fails
        (the root's filesystem is gone — treated as space-low)."""
        root = self._norm(root)
        now = self._clock()
        cached = self._space_cache.get(root)
        if cached is not None and not fresh and now - cached[0] < self.cache_ttl:
            return cached[1]
        try:
            sv = self._statvfs(root)
            free: Optional[int] = sv.f_bavail * sv.f_frsize
        except OSError as e:
            logger.warning("statvfs on %s failed: %s", root, e)
            free = None
        self._space_cache[root] = (now, free)
        self._space_low[root] = free is None or free < self.watermark
        return free

    # --- state machine ---

    def state(self, root: str) -> str:
        root = self._norm(root)
        self._ensure(root)
        self.free_bytes(root)   # refresh space_low through the cache
        if self._streak[root] >= self.error_threshold * DISK_FAILED_FACTOR:
            return "failed"
        if self._space_low[root]:
            return "degraded"
        if self._breakers[root].state_now() != "closed":
            return "degraded"
        return "ok"

    def states(self) -> Dict[str, str]:
        # snapshot: note_error in a worker thread may _ensure a root
        # while a scrape-time render iterates
        return {r: self.state(r) for r in list(self._breakers)}

    def worst_state(self) -> str:
        worst = "ok"
        for s in self.states().values():
            if DISK_STATE_VALUES[s] > DISK_STATE_VALUES[worst]:
                worst = s
        return worst

    def writable(self, root: str) -> bool:
        """Non-consuming writability hint (used by the need_block gate:
        a read-only root must not solicit block offers it would then
        reject).  Unlike check_writable this never takes the half-open
        probe slot.  A half-open root answers True: the resync push a
        need_block=True solicits is exactly the probe write that walks
        the root back to ok — answering False on a node with no direct
        PUT traffic would starve it of both recovery and its missing
        blocks (circular wait)."""
        root = self._norm(root)
        self._ensure(root)
        if self._streak[root] >= self.error_threshold * DISK_FAILED_FACTOR:
            return False
        self.free_bytes(root)   # refresh space_low through the cache
        if self._space_low[root]:
            return False
        return self._breakers[root].state_now() in ("closed", "half_open")

    def check_writable(self, root: str, need_bytes: int = 0) -> None:
        """Write preflight: raises StorageFull (space) or StorageError
        (error streak / failed) when the root is read-only.  A True-ish
        return path may consume the breaker's half-open probe slot —
        the caller MUST report the write's outcome via note_ok /
        note_error, exactly like the RPC breaker contract."""
        root = self._norm(root)
        self._ensure(root)
        if self._streak[root] >= self.error_threshold * DISK_FAILED_FACTOR:
            raise StorageError(
                f"data root {root} FAILED "
                f"({self._streak[root]} consecutive disk errors)")
        free = self.free_bytes(root)
        if free is None or free - need_bytes < self.watermark:
            raise StorageFull(
                f"data root {root} read-only: free space "
                f"{free if free is not None else 'unknown'} below "
                f"watermark {self.watermark}")
        if not self._breakers[root].allow():
            raise StorageError(
                f"data root {root} degraded (read-only): disk error "
                f"streak, retry after cooldown")

    # --- outcome reporting ---

    def note_error(self, root: str, op: str, e: BaseException) -> None:
        root = self._norm(root)
        self._ensure(root)
        kind = _error_kind(e)
        key = (op, kind)
        self.error_counts[key] = self.error_counts.get(key, 0) + 1
        if self._counter is not None:
            self._counter.inc(op=op, kind=kind)
        if getattr(e, "errno", None) == errno.ENOSPC:
            # full is not broken: a write-time ENOSPC the watermark
            # missed (quota, reserved blocks — statvfs can't see either)
            # flips the root space-low for one cache TTL, after which
            # the next preflight re-probes statvfs — but it never feeds
            # the streak/breaker, which would otherwise walk a merely
            # full disk to a latched FAILED within minutes on an
            # ingest-heavy node
            self._space_low[root] = True
            self._space_cache[root] = (self._clock(), None)
            # the failed write may have been the half-open probe
            # (check_writable consumed the slot): ENOSPC is a verdict
            # about space, not the streak — free the slot, or the root
            # stays un-probeable for a full extra cooldown after space
            # recovers
            self._breakers[root].release_probe()
            return
        self._streak[root] += 1
        self._breakers[root].on_failure()

    def note_ok(self, root: str, op: str = "read") -> None:
        root = self._norm(root)
        self._ensure(root)
        self._streak[root] = 0
        self._breakers[root].on_success()


# --- crash-consistent startup --------------------------------------------


def janitor_pass(
    roots: List[str],
    max_quarantine_files: int = QUARANTINE_MAX_FILES,
    max_quarantine_bytes: int = QUARANTINE_MAX_BYTES,
) -> Dict[str, object]:
    """One boot-time sweep over every data root:

      1. delete orphaned ``*.tmp`` files — a write that never reached
         its rename, so by the write path's construction it was never
         acknowledged; leaving it would shadow disk space forever (the
         tmp path is deterministic, so at most one per block, but a
         crashed bulk ingest leaves many);
      2. bound the ``.corrupted`` quarantine: oldest-first deletion
         until both the file-count and byte budgets hold (quarantined
         copies exist only as forensic evidence; resync re-fetches the
         content, so purging old ones loses nothing durable);
      3. collect the hashes of every surviving quarantined file so the
         caller re-enqueues them for resync — a node that crashed
         between quarantine and the resync enqueue must not leave the
         hole unfilled until the next scrub.

    The parity sidecar subtree is skipped — its files belong to
    ParityStore, which has its own refresh/purge cycle.  Returns a
    summary dict (counts + requeue hash list) for logging/tests."""
    tmp_purged = 0
    quarantined: List[Tuple[float, int, str]] = []  # (mtime, size, path)
    for root in roots:
        for dirpath, dirnames, files in os.walk(root):
            if "parity" in dirnames:
                dirnames.remove("parity")
            for name in files:
                p = os.path.join(dirpath, name)
                if name.endswith(".tmp"):
                    try:
                        os.remove(p)
                        tmp_purged += 1
                    except OSError as e:
                        logger.warning("janitor: purge of %s failed: %s",
                                       p, e)
                elif name.endswith(".corrupted"):
                    try:
                        st = os.stat(p)
                        quarantined.append((st.st_mtime, st.st_size, p))
                    except OSError:
                        continue
    quarantined.sort()  # oldest first
    q_purged = 0
    total = sum(sz for _m, sz, _p in quarantined)
    unpurgeable: List[Tuple[float, int, str]] = []
    while quarantined and (len(quarantined) > max_quarantine_files
                          or total > max_quarantine_bytes):
        entry = quarantined.pop(0)
        _m, sz, p = entry
        # the byte budget drops either way so the loop always advances,
        # but a FAILED purge is not a purge: the file survives on disk,
        # so it must stay counted as kept and its hash must still reach
        # the requeue scan below (a read-only root at boot must not make
        # the janitor silently forget quarantined holes)
        total -= sz
        try:
            os.remove(p)
        except OSError as e:
            logger.warning("janitor: quarantine purge of %s failed: %s", p, e)
            unpurgeable.append(entry)
            continue
        q_purged += 1
    quarantined = unpurgeable + quarantined
    requeue: List[bytes] = []
    seen = set()
    for _m, _sz, p in quarantined:
        base = os.path.basename(p)[: -len(".corrupted")]
        if base.endswith(".zst"):
            base = base[:-4]
        try:
            hb = bytes.fromhex(base)
        except ValueError:
            continue
        if len(hb) == 32 and hb not in seen:
            seen.add(hb)
            requeue.append(hb)
    return {
        "tmp_purged": tmp_purged,
        "quarantine_purged": q_purged,
        "quarantine_kept": len(quarantined),
        "requeue": requeue,
    }
