"""Cross-node RS decode-repair — rebuild a block no replica can serve.

The last line of the resync fallback chain (local sidecar → replicas →
THIS): look the lost block up in the replicated parity index
(model/parity_index_table.py), fetch ≥ k surviving codeword pieces from
across the cluster — member blocks and parity blocks alike are ordinary
ring-placed blocks — and decode exactly the missing row.  Every fetched
piece is verified by content hash before use and the rebuilt block must
hash to the requested id, so damaged or stale pieces can only cause a
fallback, never wrong data.

The reference has no equivalent: its resync gives up when every replica
is gone (ref src/block/resync.rs:457-468).  Here, with data replication
"none" + RS(8,4) distribution, the cluster stores 1.5× the data and any
block survives the loss of up to m = 4 of its codeword's nodes — versus
the reference's 3× storage tolerating 2.
"""

from __future__ import annotations

import asyncio
import contextvars
import logging
import time
from typing import Optional

import numpy as np

from ..utils.background import Worker
from ..utils.data import Hash, block_hash

# True while the current task context is inside a distributed RS decode
# — piece fetches must not recurse into another decode (see
# make_parity_reconstructor)
IN_PARITY_DECODE: contextvars.ContextVar = contextvars.ContextVar(
    "garage_tpu_torch_in_parity_decode", default=False)

logger = logging.getLogger("garage_tpu_torch.model.parity_repair")


# How many index rows to consider per member during GC/repair: a block
# can belong to several codewords over its life (re-groupings); tombstones
# keep occupying slots, so the scan must look well past the live ones.
INDEX_SCAN_LIMIT = 64

# How long after a ring change an empty index quorum read is treated as
# possibly BLIND (new replicas not yet synced) and worth a peer sweep;
# table sync converges well inside this on any healthy cluster.
INDEX_SWEEP_WINDOW_S = 15 * 60.0
# Negative-cache TTL for members whose sweep came back empty — retry
# storms pay one O(peers) sweep per TTL, not one per attempt.
SWEEP_EMPTY_TTL_S = 60.0

# Delay between "looks dead" and the irreversible index tombstone: long
# enough for every node's insert queue to drain a just-queued live ref
# (the worker pushes batches immediately; seconds covers a busy node).
# Tests shrink this.
PARITY_GC_GRACE_S = 5.0


async def has_live_ref(garage, h: Hash) -> bool:
    """Any live non-parity BlockRef for `h`, looking progressively
    further: applied local store → local insert queue → paginated quorum
    read (a dedup'd block can carry any number of refs, and one live ref
    past the page edge must still veto the GC)."""
    from ..table.schema import DeletedFilter, hash_partition_key
    from .parity_index_table import is_parity_ref
    from .s3.block_ref_table import BlockRef  # noqa: F401 — decode type

    data = garage.block_ref_table.data
    prefix = bytes(hash_partition_key(bytes(h)))
    for k, raw in data.store.items(prefix, None):
        if k[:32] != prefix:
            break
        br = data.decode_entry(raw)
        if not br.deleted.value and not is_parity_ref(br.version):
            return True  # still referenced somewhere: keep coverage
    # A live ref from a concurrent PUT may still sit in the local
    # insert queue (queue_insert keys by tree_key = partition prefix +
    # sort key) without having reached the store yet — the index
    # tombstone is sticky, so looking only at the applied store would
    # permanently strip coverage for a block that is very much alive.
    for k, raw in data.insert_queue.items(prefix, None):
        if k[:32] != prefix:
            break
        br = data.decode_entry(raw)
        if not br.deleted.value and not is_parity_ref(br.version):
            return True
    # Local rows can lag the cluster (this node may have missed the
    # PUT's quorum); confirm against a quorum read before tombstoning.
    cursor = None
    while True:
        remote = await garage.block_ref_table.get_range(
            bytes(h), cursor, filter=DeletedFilter.NOT_DELETED,
            limit=INDEX_SCAN_LIMIT)
        for br in remote:
            if not br.deleted.value and not is_parity_ref(br.version):
                return True
        if len(remote) < INDEX_SCAN_LIMIT:
            break
        cursor = bytes(remote[-1].sort_key) + b"\x00"
    return False


async def gc_if_dead(garage, h: Hash, grace: Optional[float] = None,
                     *, pre_checked: bool = False) -> bool:
    """Tombstone `h`'s parity-index rows if no live ref remains anywhere.
    Returns True if rows were tombstoned.  Raises on read/insert failure
    (callers decide whether to retry; keeping coverage is always safe).
    pre_checked: the caller already ran has_live_ref AND served the grace
    (the drain path batches both); only the final re-check runs here."""
    if not pre_checked:
        if await has_live_ref(garage, h):
            return False
        # Grace re-check: a live ref for a deduplicated block may sit in
        # a REMOTE node's insert queue (a version-partition node's hook
        # queued it; its InsertQueueWorker hasn't pushed yet) — invisible
        # to both the local scans and the quorum read.  The queues drain
        # in seconds; waiting out one drain cycle before the irreversible
        # or-merged tombstone closes the practical window.
        await asyncio.sleep(PARITY_GC_GRACE_S if grace is None else grace)
    if await has_live_ref(garage, h):
        return False
    entries = await garage.parity_index_table.get_range(
        bytes(h), None, limit=INDEX_SCAN_LIMIT)
    dead = [e for e in entries if not e.is_tombstone()]
    for e in dead:
        e.deleted.set()
    if dead:
        await garage.parity_index_table.insert_many(dead)
    return bool(dead)


def make_parity_gc(garage):
    """Bind the GC trigger: fired (post-commit, on the block_ref
    partition's nodes) when a live version-ref for a member block is
    tombstoned.  If NO live version-ref remains, the block is globally
    dead and its parity-index rows tombstone — which, via the member-0
    row, decrefs the codeword's parity blocks so their storage is
    reclaimed by normal block GC.

    The trigger is deliberately NOT physical deletion: a node deleting
    its local copy during migration/offload says nothing about the
    block's global liveness, and GC'ing coverage there would strip
    erasure protection from a block that still exists (with an or-merged
    sticky tombstone, unrecoverably).  The block_ref and parity_index
    tables shard by the same hash, so the first-line check reads only
    local rows.

    Dropped hashes accumulate in a pending SET drained by one task —
    a bulk delete tombstoning refs for 100k blocks costs one set of
    hashes and one serialized read loop, not 100k concurrent 5-second
    tasks each firing quorum reads.  The grace sleep is amortized per
    drain batch, not paid per hash.  Best-effort: anything left pending
    at a crash is reclaimed by the ParityGcSweeper's next pass."""

    pending: set = set()
    state = {"drainer": None}

    def on_ref_dropped(h: Hash) -> None:
        pending.add(bytes(h))
        if state["drainer"] is None or state["drainer"].done():
            state["drainer"] = asyncio.get_running_loop().create_task(
                _drain())

    async def _drain() -> None:
        while pending:
            batch = [pending.pop()
                     for _ in range(min(len(pending), GC_DRAIN_BATCH))]
            try:
                looks_dead = []
                for hb in batch:
                    if not await has_live_ref(garage, Hash(hb)):
                        looks_dead.append(hb)
                if looks_dead:
                    # one grace sleep for the whole batch: remote insert
                    # queues drain while we wait, then each candidate is
                    # re-checked by gc_if_dead's first has_live_ref
                    await asyncio.sleep(PARITY_GC_GRACE_S)
                for hb in looks_dead:
                    try:
                        await gc_if_dead(garage, Hash(hb), pre_checked=True)
                    except Exception:
                        logger.debug(
                            "parity GC for %s failed (sweeper will retry)",
                            hb.hex()[:16], exc_info=True)
            except Exception:
                logger.debug("parity GC drain batch failed (sweeper will "
                             "retry)", exc_info=True)

    return on_ref_dropped


GC_DRAIN_BATCH = 256


class ParityGcSweeper(Worker):
    """Convergent backstop for the one-shot ref-drop GC trigger: slowly
    walks this node's LOCAL parity_index rows and re-runs the liveness
    check for each live member row.  Any codeword whose ref-drop event
    was lost — trigger crashed mid-grace, quorum read failed during the
    check, node was down when the delete happened — is reclaimed on a
    later pass, backing the "GC will retry" promise with convergence
    rather than hope."""

    SWEEP_BATCH = 64
    SWEEP_INTERVAL_S = 3600.0  # full-pass cadence
    # inter-batch throttle: every live row costs a (mostly local, but up
    # to quorum) read — "slowly walks" must be enforced, not promised;
    # with 64-row batches this caps the sweep at ~64 rows/s per node
    SWEEP_BATCH_PAUSE_S = 1.0
    # never judge a codeword younger than this: a fresh distribution's
    # FIRST version-ref may still be in flight through remote insert
    # queues, and the sweep's liveness check would see a dead block
    MIN_AGE_MS = 10 * 60 * 1000

    def __init__(self, garage):
        self.garage = garage
        self.cursor: bytes = b""
        self._next_pass = 0.0
        self.swept = 0  # current-pass counters, snapshot at pass end
        self.reclaimed = 0

    def name(self) -> str:
        return "parity GC sweeper"

    async def work(self):
        from ..utils.background import WorkerState
        from ..utils.crdt import now_msec

        if self.cursor == b"" and time.monotonic() < self._next_pass:
            return WorkerState.IDLE
        data = self.garage.parity_index_table.data
        batch = []
        for k, raw in data.store.items(self.cursor, None):
            if k == self.cursor:
                continue
            batch.append((k, raw))
            if len(batch) >= self.SWEEP_BATCH:
                break
        if not batch:
            self.cursor = b""
            self._next_pass = time.monotonic() + self.SWEEP_INTERVAL_S
            self.status().progress = (
                f"last pass: {self.swept} checked, "
                f"{self.reclaimed} reclaimed")
            self.swept = self.reclaimed = 0
            return WorkerState.IDLE
        now = now_msec()
        for k, raw in batch:
            self.cursor = k
            try:
                ent = data.decode_entry(raw)
            except Exception:
                continue
            if (ent.is_tombstone()
                    or now - ent.timestamp < self.MIN_AGE_MS):
                continue
            # Evidence-of-death gate: after a layout change, the
            # block_ref partition for this member may reach this node
            # LATER than the parity_index partition (independent table
            # syncers), and a quorum read interrupted after the two
            # fastest — equally freshly-synced — replicas can also come
            # back empty.  An absent partition is indistinguishable from
            # a dead block by liveness checks alone, so the sweep only
            # judges members whose local block_ref rows exist (a dead
            # block leaves tombstoned refs; a lagging sync leaves
            # nothing).  A fully tombstone-GC'd partition is skipped too
            # — the previous passes had hours to act before that.
            if not self._local_ref_evidence(ent.member):
                continue
            try:
                # EVERY member's row is checked (not only member-0): each
                # member has its own partition's rows, and the lost-event
                # leak applies to each independently.  gc_if_dead(h)
                # tombstones all of member h's rows; the member-0 row's
                # hook is what decrefs the parity blocks.  Full grace
                # applies — the sweep races fresh dedup PUTs exactly like
                # the trigger does, and only sleeps when a row looks dead.
                if await gc_if_dead(self.garage, ent.member):
                    self.reclaimed += 1
            except Exception:
                logger.debug("sweep GC for %s failed (next pass retries)",
                             bytes(ent.member).hex()[:16], exc_info=True)
            self.swept += 1
        await asyncio.sleep(self.SWEEP_BATCH_PAUSE_S)
        return WorkerState.BUSY

    def _local_ref_evidence(self, member: Hash) -> bool:
        """Any block_ref row (live or tombstoned) for the member in the
        LOCAL store — proof the ref partition has actually synced here."""
        from ..table.schema import hash_partition_key

        data = self.garage.block_ref_table.data
        prefix = bytes(hash_partition_key(bytes(member)))
        for k, _raw in data.store.items(prefix, None):
            return k[:32] == prefix
        return False

    async def wait_for_work(self) -> None:
        delay = max(1.0, self._next_pass - time.monotonic())
        await asyncio.sleep(min(delay, 30.0))


def make_parity_reconstructor(garage):
    """Bind a `async h -> plain bytes | None` reconstructor over the
    garage's parity index table + block manager (attached to the block
    manager as `parity_reconstructor`)."""

    async def reconstruct(h: Hash) -> Optional[bytes]:
        # Reentrancy guard: fetching codeword PIECES goes through the
        # same block-read paths that fall back to THIS reconstructor
        # when all replicas fail (block/manager.py streaming read).
        # Without the guard a cluster missing several pieces recurses
        # decode→fetch→decode→… until RecursionError (caught by the
        # chaos soak at ~640 frames).  contextvars propagate into tasks
        # spawned by the decode's gathers, so the ENTIRE fetch subtree
        # of one decode skips further decode attempts; sibling decodes
        # in other request contexts are unaffected.
        if IN_PARITY_DECODE.get():
            return None
        token = IN_PARITY_DECODE.set(True)
        try:
            return await _reconstruct_inner(h)
        finally:
            IN_PARITY_DECODE.reset(token)

    # The index sweep is O(peers) with per-peer timeouts — it must not
    # fire for every genuinely-uncovered block (pre-EC data, parity
    # shards themselves) a resync storm walks.  Two gates: the sweep
    # only runs while a recent ring change makes a blind quorum read
    # PLAUSIBLE (partitions moved, table sync may lag), and a member
    # that just swept empty is negative-cached so retry storms pay one
    # sweep per TTL, not one per attempt.
    sweep_empty: dict = {}

    def _sweep_worthwhile(hb: bytes) -> bool:
        changed = getattr(garage.system, "ring_changed_at", None)
        if (changed is None
                or time.monotonic() - changed > INDEX_SWEEP_WINDOW_S):
            return False
        ts = sweep_empty.get(hb)
        if ts is not None and time.monotonic() - ts < SWEEP_EMPTY_TTL_S:
            return False
        if len(sweep_empty) > 4096:  # bounded: drop the oldest entries
            for k in sorted(sweep_empty, key=sweep_empty.get)[:1024]:
                del sweep_empty[k]
        return True

    async def _reconstruct_inner(h: Hash) -> Optional[bytes]:
        try:
            entries = await garage.parity_index_table.get_range(
                bytes(h), None, limit=INDEX_SCAN_LIMIT)
        except Exception:
            logger.warning("parity index unreachable for %s",
                           bytes(h).hex()[:16], exc_info=True)
            entries = []
        live = [e for e in entries if not e.is_tombstone()]
        # tombstone-only answers are NOT blind — a returned row proves
        # table sync already copied the partition here; only a
        # zero-row (or failed) quorum read can be hiding synced rows
        # on the old replicas
        if not entries and _sweep_worthwhile(bytes(h)):
            # The quorum read is honest but can be BLIND right after a
            # layout change: the member's index partition was reassigned
            # and the NEW replicas answer "no rows" until table sync
            # copies the partition over — while the rows still sit on
            # the old replicas.  A recoverable block would stay
            # unrecovered for a full sync cycle (observed: the degraded
            # bench healed on its 60 s fallback kick, not the decode
            # ladder).  Sweep alive peers for the rows instead — same
            # philosophy as sweep_get_block: on repair paths,
            # completeness beats elegance.
            live = await _sweep_index_entries(garage, h)
            if not live:
                sweep_empty[bytes(h)] = time.monotonic()
        for ent in live:
            data = await try_codeword(garage, h, ent)
            if data is not None:
                return data
        return None

    return reconstruct


async def lookup_index_entries(garage, h: Hash, *, sweep: bool = False
                               ) -> list:
    """Live parity-index rows for member `h` — the quorum read the
    decode ladder and the fleet rebuild scheduler (block/rebuild.py)
    share.  sweep=True falls back to the alive-peer sweep when the read
    returns zero rows (a full-node loss IS a recent ring change, so the
    blind-read window applies)."""
    try:
        entries = await garage.parity_index_table.get_range(
            bytes(h), None, limit=INDEX_SCAN_LIMIT)
    except Exception:
        logger.warning("parity index unreachable for %s",
                       bytes(h).hex()[:16], exc_info=True)
        entries = []
    live = [e for e in entries if not e.is_tombstone()]
    if not entries and sweep:
        live = await _sweep_index_entries(garage, h)
    return live


async def _sweep_index_entries(garage, h: Hash) -> list:
    """Live parity-index rows for member `h` from ANY alive peer: local
    store first (free), then every peer ordered likely-up-first, first
    non-empty answer wins (rows for one member are written together, so
    any holder has the full set; CRDT-merged across duplicates)."""
    from ..table.schema import hash_partition_key

    table = garage.parity_index_table
    ph = hash_partition_key(bytes(h))

    def decode_live(raws) -> dict:
        out: dict = {}
        for v in raws:
            try:
                ent = table.data.decode_entry(bytes(v))
            except Exception:  # noqa: BLE001 — skip undecodable rows
                continue
            key = bytes(ent.sort_key)
            if key in out:
                out[key].merge(ent)
            else:
                out[key] = ent
        return {k: e for k, e in out.items() if not e.is_tombstone()}

    local = decode_live(table.data.read_range(
        Hash(bytes(ph)), None, None, INDEX_SCAN_LIMIT, False))
    if local:
        return list(local.values())
    msg = {"t": "read_range", "ph": bytes(ph), "sk": None, "filter": None,
           "limit": INDEX_SCAN_LIMIT, "rev": False}
    rpc = garage.system.rpc
    peers = sorted(garage.system.peering.peers.items(),
                   key=lambda kv: not kv[1].is_up)
    tried = []
    for nid, _st in peers:
        try:
            resp = await rpc.call(
                table.endpoint, nid, msg, timeout=10.0, idempotent=True)
            rows = decode_live(resp.get("vs", []))
            if rows:
                return list(rows.values())
            tried.append(f"{bytes(nid).hex()[:8]}:empty")
        except Exception as e:  # noqa: BLE001 — next peer
            tried.append(f"{bytes(nid).hex()[:8]}:{type(e).__name__}")
    if tried:
        logger.info("index sweep for %s found nothing: %s",
                    bytes(h).hex()[:12], tried)
    return []


async def _fetch_verified(garage, mh: bytes) -> Optional[bytes]:
    """A codeword piece (member or parity block), verified against its
    content hash — own store → ring placement → every alive peer (the
    migration-aware sweep lives on the block manager, shared with the
    resync fallback chain: block/manager.py sweep_get_block)."""
    return await garage.block_manager.sweep_get_block(Hash(mh))


async def try_codeword(garage, h: Hash, ent) -> Optional[bytes]:
    """Decode member `h` of codeword `ent`: planner (tree/chain/flat
    PPR) first, legacy sweep-everything gather as the completeness
    backstop.  Shared by the resync decode ladder and the rebuild
    scheduler's per-codeword fallback."""
    k, m = ent.k, ent.m
    target_i = ent.member_index
    lengths = ent.lengths
    maxlen = max(lengths) if lengths else 0
    if maxlen == 0 or target_i >= len(ent.members):
        return None

    mgr = garage.block_manager
    # planned, bandwidth-minimal path first (block/repair_plan.py):
    # exact-k fetches ranked by RTT/breaker/zone, partial-sum (PPR)
    # reconstruction when peers support it.  A planner miss falls
    # through to the legacy gather below — its sweep-everything fetch
    # is the completeness backstop (pieces stranded on non-ring nodes
    # after layout churn), so a plan that comes up empty must not cost
    # recoverability the old path had.
    planner = getattr(mgr, "repair_planner", None)
    if planner is not None:
        data = await planner.reconstruct(h, ent)
        if data is not None:
            return data

    pieces, present = [], []

    def pad(raw: bytes) -> np.ndarray:
        shard = np.zeros(maxlen, dtype=np.uint8)
        shard[: len(raw)] = np.frombuffer(raw, dtype=np.uint8)
        return shard

    # surviving data members (fetched concurrently — they live on
    # different nodes, and a dead node costs a full timeout serially)
    others = [i for i in range(len(ent.members)) if i != target_i]
    was_local = [mgr.is_block_present(Hash(ent.members[i])) for i in others]
    fetched = await asyncio.gather(
        *[_fetch_verified(garage, ent.members[i]) for i in others])
    for i, raw, loc in zip(others, fetched, was_local):
        if raw is None:
            continue
        if not loc:
            mgr.note_repair_fetch("gather", len(raw))
        if len(present) >= k:
            if not loc:  # only WIRE bytes count as overfetch waste
                mgr.note_repair_overfetch(len(raw))
            continue
        pieces.append(pad(raw))
        present.append(i)
    # implicit zero shards of a partial codeword
    for i in range(len(ent.members), k):
        if len(present) >= k:
            break
        pieces.append(np.zeros(maxlen, dtype=np.uint8))
        present.append(i)
    # parity blocks LAZILY, exactly the gap left by dead members — the
    # old gather fetched all m unconditionally, moving (and discarding)
    # up to (m-1) extra shards per degraded read.  Anything fetched
    # beyond k still lands in repair_overfetch_bytes_total so residual
    # waste is measured, not assumed away.  (`repair_gather_everything`
    # restores the fetch-everything behavior — the bench's baseline
    # emulation knob, never set in production.)
    if len(present) < k:
        from ..block.parity import unpack_parity_shard

        pqueue = list(enumerate(ent.parity_hashes))
        everything = bool(getattr(mgr, "repair_gather_everything", False))
        while len(present) < k and pqueue:
            need = len(pqueue) if everything else k - len(present)
            batch, pqueue = pqueue[:need], pqueue[need:]
            plocal = [mgr.is_block_present(Hash(ph)) for _j, ph in batch]
            pfetched = await asyncio.gather(
                *[_fetch_verified(garage, ph) for _j, ph in batch])
            for (j, _ph), raw, loc in zip(batch, pfetched, plocal):
                if raw is None:
                    continue
                if not loc:
                    mgr.note_repair_fetch("gather", len(raw))
                if len(present) >= k:
                    if not loc:  # only WIRE bytes count as overfetch
                        mgr.note_repair_overfetch(len(raw))
                    continue
                shard = unpack_parity_shard(raw)
                if shard is None:
                    if not loc:
                        mgr.note_repair_overfetch(len(raw))
                    continue
                pieces.append(pad(shard))
                present.append(k + j)
    if len(present) < k:
        logger.info(
            "codeword for %s unrecoverable: %d of %d pieces survive",
            bytes(h).hex()[:16], len(present), k)
        return None

    # decode with the ENTRY's geometry (it may predate a codec config
    # change); only the missing row is computed.  When the entry's
    # geometry matches the live codec, the decode runs on it — through
    # the manager's codec feeder when there is one (a repair storm's
    # concurrent decodes share one cached RS schedule and one ragged
    # dispatch, ops/feeder.py).  A geometry mismatch decodes through a
    # throwaway CPU codec, counted in `geometry_cpu_decodes`.  A failed
    # decode raises: the live codec's failure is its caller's.
    shards = np.stack(pieces)[None, :, :]
    feeder = getattr(mgr, "feeder", None)
    live = mgr.codec.params
    if live.rs_data == k and live.rs_parity == m:
        if feeder is not None:
            row = await feeder.decode_async(shards, present, [target_i])
        else:
            row = await asyncio.to_thread(
                mgr.codec.rs_reconstruct, shards, present, [target_i])
    else:
        from ..ops.codec import CodecParams
        from ..ops.cpu_codec import CpuCodec

        mgr.geometry_cpu_decodes += 1
        codec = CpuCodec(CodecParams(rs_data=k, rs_parity=m))
        row = await asyncio.to_thread(
            codec.rs_reconstruct, shards, present, [target_i])
    out = row[0, 0].tobytes()[: lengths[target_i]]
    if bytes(block_hash(out, garage.block_manager.hash_algo)) != bytes(h):
        logger.warning("distributed decode of %s produced wrong hash",
                       bytes(h).hex()[:16])
        return None
    mgr.note_repair_done(len(out))
    return out
