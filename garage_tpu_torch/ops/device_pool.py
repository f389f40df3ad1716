"""DevicePool — device-resident block pages under the DeviceTransport.

Why this exists.  Without a pool every device touch stages host→device
and DISCARDS: scrub, resync verify, and degraded decode of the same
hot blocks re-pay the link on every pass, so the scrub runs at the
host staging and link rate while the device kernels are idle most of
the time.  The link, not the ALU, is the warm-path bound — so this module treats the
device as a MEMORY: a bounded set of fixed-size device pages (the
Ragged Paged Attention layout, PAPERS.md — fixed page size, ragged
occupancy, in-place reuse) keyed by block hash, budgeted by
``[codec] pool_mib`` SEPARATELY from the staging budget
(``max_device_staging_mib`` bounds bytes in flight; the pool bounds
bytes at rest).

Layout.  A block of ``length`` bytes spans ``ceil(length / page)``
pages; the tail page is partially filled and zero-padded (ragged
occupancy — the budget charges whole pages, so ``bytes_for(length)``
is the page-rounded claim).  Pages are opaque device handles produced
by the device codec's pool API (``pool_adopt`` slices them out of an
already-submitted device batch — a device-side copy, ZERO link bytes)
and composed back into batch lanes by
``scrub_encode_submit_resident`` (again device-side).

Integration (ops/transport.py).  The transport consults the pool
while STAGING a scrub batch: a resident block's lane skips the host
copy and the H2D transfer entirely (``transport_staged_bytes_total``
stays flat; ``pool_hit_bytes_total`` takes the bytes), a miss stages
through the normal slot path and its verified lanes are adopted at
collect (``pool_miss_bytes_total``).  Every pool read still runs
through the device scrub kernel's hash verify — a corrupt page can
never return clean — but strict invalidation keeps hits USEFUL:
block delete, quarantine, rebalance-drop and overwrite all call
``invalidate`` synchronously before the operation acks
(block/manager.py), so the pool never serves a page for a block the
store no longer holds.

Eviction clock.  LRU in SCRUB-CYCLE time, not wall time: ``tick()``
advances once per scrub pass (block/repair.py), and entries untouched
for the most cycles evict first.  Wall-clock LRU would evict the
whole working set during any long idle period even though the next
pass needs exactly the same blocks; cycle LRU keeps "the blocks the
last pass touched" resident however long the pass interval is.

Thread-safety: one lock.  ``lookup``/``adopt`` run on the transport
worker thread, ``invalidate`` on event-loop and disk worker threads,
``tick`` on the scrub worker — all synchronous, all cheap (dict ops;
page frees are reference drops, the device runtime reclaims
asynchronously).
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from typing import List, Optional

logger = logging.getLogger("garage_tpu_torch.ops.device_pool")


class _PoolEntry:
    """One resident block: its device pages plus the bookkeeping the
    eviction clock needs."""

    __slots__ = ("key", "length", "pages", "tick", "page_bytes")

    def __init__(self, key: bytes, length: int, pages: List,
                 tick: int, page_bytes: int):
        self.key = key
        self.length = length
        self.pages = pages
        self.tick = tick  # scrub cycle of the last touch
        self.page_bytes = page_bytes

    @property
    def charged_bytes(self) -> int:
        return len(self.pages) * self.page_bytes


class DevicePool:
    """Bounded pool of device-resident block pages, hash-keyed."""

    def __init__(self, device, pool_bytes: int, page_bytes: int,
                 prefetch: bool = True, metrics=None, observer=None):
        self.device = device
        self.pool_bytes = max(0, int(pool_bytes))
        self.page_bytes = max(1, int(page_bytes))
        self.prefetch_enabled = bool(prefetch)
        self.obs = observer
        self._lock = threading.Lock()
        # insertion/touch order IS the eviction order: lookup moves an
        # entry to the back, so the front is always the least-recently-
        # used entry of the oldest cycle (cycle order within = touch
        # order — exactly what the scrub walk produces)
        self._entries: "OrderedDict[bytes, _PoolEntry]" = OrderedDict()
        self._resident_bytes = 0  # page-rounded (the budget currency)
        self._tick = 0
        # always-on accounting (admin `codec info` pool block + bench)
        self.hits = 0
        self.misses = 0
        self.hit_bytes = 0
        self.miss_bytes = 0
        self.prefetch_bytes = 0
        self.adopted = 0
        self.evicted_lru = 0
        self.invalidated = 0
        if metrics is not None:
            self.m_hit = metrics.counter(
                "pool_hit_bytes_total",
                "Block bytes served from device-resident pool pages "
                "(zero link bytes moved; with pool_miss_bytes_total "
                "this attributes every scrubbed byte)")
            self.m_miss = metrics.counter(
                "pool_miss_bytes_total",
                "Block bytes staged over the host-device link because "
                "no pool page held them (adopted into the pool after "
                "the batch verifies)")
            self.m_prefetch = metrics.counter(
                "pool_prefetch_bytes_total",
                "Block bytes staged ahead of need by the scrub "
                "worker's next-range prefetch hint (background-class "
                "link work overlapping the current batch's compute)")
            self.m_evict = metrics.counter(
                "pool_evict_total",
                "Pool pages released, by reason (lru = scrub-cycle "
                "eviction under the pool_mib budget, invalidate = "
                "synchronous delete/quarantine/rebalance/overwrite "
                "eviction, replace = re-adoption of a resident hash)")
            metrics.gauge(
                "pool_resident_bytes",
                "Page-rounded bytes currently held in device-resident "
                "pool pages (bounded by [codec] pool_mib)",
                fn=lambda: float(self._resident_bytes))
            metrics.gauge(
                "pool_pages",
                "Device pages currently held by the block pool",
                fn=lambda: float(self._resident_bytes // self.page_bytes))
        else:
            self.m_hit = self.m_miss = None
            self.m_prefetch = self.m_evict = None

    # --- capability probing -------------------------------------------------

    @classmethod
    def supports_device(cls, device) -> bool:
        """The device implements the pool API: resident-lane scrub
        submission plus device-side page extraction/readback."""
        return (hasattr(device, "scrub_encode_submit_resident")
                and hasattr(device, "pool_adopt")
                and hasattr(device, "pool_read"))

    # --- geometry -----------------------------------------------------------

    def pages_for(self, length: int) -> int:
        """Pages a block of `length` bytes spans (ragged occupancy: the
        tail page is partially filled)."""
        return max(1, -(-int(length) // self.page_bytes))

    def bytes_for(self, length: int) -> int:
        """Page-rounded budget charge for a block of `length` bytes."""
        return self.pages_for(length) * self.page_bytes

    # --- the scrub-cycle clock ----------------------------------------------

    def tick(self) -> int:
        """Advance the eviction clock by one scrub cycle (called at
        every scrub pass start, block/repair.py)."""
        with self._lock:
            self._tick += 1
            return self._tick

    # --- lookup / adopt -----------------------------------------------------

    def lookup(self, key: bytes, length: int) -> Optional[_PoolEntry]:
        """The entry for `key` if resident with a matching length,
        bumping it to most-recently-used in the current cycle.  A
        length mismatch (impossible for content-addressed blocks
        unless something rewrote the store behind the pool's back) is
        treated as a miss AND evicts the suspect entry — serving it
        would at best fail the device verify, at worst mask a bug."""
        key = bytes(key)
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            if e.length != int(length):
                self._drop_locked(key, "invalidate")
                logger.warning(
                    "pool entry %s length %d != looked-up %d: evicted",
                    key.hex()[:16], e.length, length)
                return None
            e.tick = self._tick
            self._entries.move_to_end(key)
            return e

    def contains(self, key: bytes) -> bool:
        """Residency check with NO LRU side effect (the feeder's
        gate-refresh short-circuit and the prefetch filter)."""
        with self._lock:
            return bytes(key) in self._entries

    def contains_all(self, keys) -> bool:
        """True when every key is resident (and there is at least one):
        a batch a pool hit would fully satisfy."""
        with self._lock:
            if not self._entries:
                return False
            got_any = False
            for k in keys:
                got_any = True
                if bytes(k) not in self._entries:
                    return False
            return got_any

    def adopt(self, key: bytes, pages: List, length: int) -> bool:
        """Admit one block's device pages, evicting LRU entries until
        the budget fits.  A block bigger than the whole budget is
        refused (dropping the page refs frees them).  Re-adopting a
        resident hash replaces the old pages — the overwrite shape of
        strict invalidation."""
        key = bytes(key)
        need = len(pages) * self.page_bytes
        if need > self.pool_bytes:
            if self.obs is not None:
                self.obs.event("pool_refuse", reason="over_budget",
                               nbytes=need)
            return False
        with self._lock:
            if key in self._entries:
                self._drop_locked(key, "replace")
            while (self._resident_bytes + need > self.pool_bytes
                   and self._entries):
                old_key = next(iter(self._entries))
                self._drop_locked(old_key, "lru")
                self.evicted_lru += 1
            e = _PoolEntry(key, int(length), list(pages), self._tick,
                           self.page_bytes)
            self._entries[key] = e
            self._resident_bytes += need
            self.adopted += 1
        return True

    def _drop_locked(self, key: bytes, reason: str) -> None:
        e = self._entries.pop(key, None)
        if e is None:
            return
        self._resident_bytes -= e.charged_bytes
        e.pages = []  # the reference drop IS the device-side free
        if self.m_evict is not None:
            self.m_evict.inc(reason=reason)

    # --- strict invalidation ------------------------------------------------

    def invalidate(self, key: bytes, reason: str = "invalidate") -> bool:
        """Synchronously evict `key` — called BEFORE the store acks a
        delete/quarantine/rebalance-drop/overwrite (block/manager.py),
        so the pool can never serve a page for a block the store no
        longer holds.  Returns whether anything was resident."""
        with self._lock:
            present = bytes(key) in self._entries
            if present:
                self._drop_locked(bytes(key), "invalidate")
                self.invalidated += 1
        if present and self.obs is not None:
            self.obs.event("pool_invalidate", reason=reason,
                           hash=bytes(key).hex()[:16])
        return present

    def clear(self) -> None:
        with self._lock:
            for key in list(self._entries):
                self._drop_locked(key, "invalidate")

    # --- byte attribution (the transport's staging loop calls these) --------

    def note_hit(self, nbytes: int) -> None:
        self.hits += 1
        self.hit_bytes += int(nbytes)
        if self.m_hit is not None:
            self.m_hit.inc(int(nbytes))

    def note_miss(self, nbytes: int, prefetch: bool = False) -> None:
        """Miss accounting: a PREFETCH batch's staging is attributed to
        its own family, so pool_hit + pool_miss still equals exactly
        the bytes the scrub itself asked for."""
        if prefetch:
            self.prefetch_bytes += int(nbytes)
            if self.m_prefetch is not None:
                self.m_prefetch.inc(int(nbytes))
            return
        self.misses += 1
        self.miss_bytes += int(nbytes)
        if self.m_miss is not None:
            self.m_miss.inc(int(nbytes))

    # --- readback (tests / smoke: bit-identity proof) -----------------------

    def read(self, key: bytes) -> Optional[bytes]:
        """The resident block's bytes fetched back from its device
        pages (D2H — test/debug surface, not a data path), trimmed to
        the ragged tail.  None when not resident."""
        with self._lock:
            e = self._entries.get(bytes(key))
            if e is None:
                return None
            pages, length = list(e.pages), e.length
        return self.device.pool_read(pages, length)

    # --- introspection ------------------------------------------------------

    @property
    def resident_bytes(self) -> int:
        return self._resident_bytes

    def stats(self) -> dict:
        with self._lock:
            return {
                "pool_bytes": self.pool_bytes,
                "page_bytes": self.page_bytes,
                "resident_bytes": self._resident_bytes,
                "resident_blocks": len(self._entries),
                "resident_pages": self._resident_bytes // self.page_bytes,
                "tick": self._tick,
                "hits": self.hits,
                "misses": self.misses,
                "hit_bytes": self.hit_bytes,
                "miss_bytes": self.miss_bytes,
                "prefetch_bytes": self.prefetch_bytes,
                "adopted": self.adopted,
                "evicted_lru": self.evicted_lru,
                "invalidated": self.invalidated,
                "prefetch": self.prefetch_enabled,
            }
