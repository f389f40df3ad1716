"""ParityStore — local Reed-Solomon sidecars for scrub-time self-repair.

The reference repairs a corrupted block only by refetching it from a
replica (ref src/block/resync.rs:457-468); if every replica is
unreachable or equally damaged, the data is gone.  Here the scrub
worker's fused verify+encode pass (the BlockCodec north star) already
computes RS(k, m) parity over each codeword of k blocks — this module
persists that parity as a local sidecar so a corrupted or lost block can
be **reconstructed on this node alone**, with zero network, as long as
≥ k of the codeword's k+m pieces survive.  Network resync remains the
fallback; the sidecar is a best-effort cache refreshed on every scrub
pass.

Layout: one msgpack manifest per codeword under
`<data_dir>/parity/xx/<group_id>.par` (group_id = blake2s over the
member hashes), plus a small db tree mapping block hash → group file so
repair can find a block's codeword in O(1).  Data shards are the member
blocks themselves (zero-padded to the codeword width), read back from
the block store and re-verified by content hash at reconstruction time;
parity shards carry their own checksums.  Any mismatch disqualifies the
piece — reconstruction either produces a block whose hash matches, or
fails loudly and the caller falls back to the network.
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import List, Optional, Sequence

import msgpack
import numpy as np

from ..utils.data import Hash, blake2s_sum, block_hash
from .block import DataBlock

logger = logging.getLogger("garage_tpu_torch.block.parity")

MANIFEST_VERSION = 1


class ParityStore:
    def __init__(self, manager, db, codec):
        from ..db.counted_tree import CountedTree

        self.manager = manager
        self.codec = codec
        # CountedTree: the coverage gauge reads len() per metrics scrape,
        # and sqlite COUNT(*) is O(n)
        self.index = CountedTree(db.open_tree("block_parity_index"))
        # new sidecars go to the first WRITABLE data dir (a drained
        # read_only drive must not keep accumulating them); lookups and
        # the purge walk EVERY dir so sidecars written before a drain or
        # layout change stay reachable and collectable
        dirs = manager.data_layout.data_dirs
        root = next(
            (d.path for d in dirs if not d.read_only), dirs[0].path
        )
        self.dir = os.path.join(root, "parity")
        self.all_dirs = [os.path.join(d.path, "parity") for d in dirs]

    # --- write path (scrub) ------------------------------------------------

    @staticmethod
    def _gid(k: int, m: int, hashes: Sequence[Hash]) -> Hash:
        """Group id over (manifest version, k, m, member hashes).  The
        codec geometry is part of the identity: with member-hashes-only
        gids, an rs_parity config change made put_codeword mtime-touch the
        old-geometry file forever (so purge never removed it) while
        _load_manifest rejected it on its (k, m) check — silently and
        permanently losing local-repair coverage for the codeword."""
        import struct

        head = struct.pack("<III", MANIFEST_VERSION, k, m)
        return blake2s_sum(head + b"".join(bytes(h) for h in hashes))

    def _group_path(self, gid: bytes) -> str:
        """Write location for a group (the writable dir)."""
        hx = gid.hex()
        return os.path.join(self.dir, hx[:2], hx + ".par")

    def _find_group_path(self, gid: bytes) -> Optional[str]:
        """Read location: search every data dir's parity tree."""
        hx = gid.hex()
        for base in self.all_dirs:
            p = os.path.join(base, hx[:2], hx + ".par")
            if os.path.exists(p):
                return p
        return None

    def put_codeword(
        self,
        hashes: Sequence[Hash],
        lengths: Sequence[int],
        parity: np.ndarray,
    ) -> None:
        """Persist one codeword's parity: `hashes`/`lengths` are the j ≤ k
        member blocks in codeword order, `parity` is (m, maxlen) uint8
        encoded at the codec's (k, m) geometry.  j < k means a PARTIAL
        codeword (write-time encoding flushes one before k blocks
        accumulate): members j..k-1 are implicit all-zero shards —
        GF-linear, so the parity is identical to a k-member codeword
        whose tail members are zero, and reconstruction counts the zero
        shards as always-available pieces.  Called by the scrub worker
        (full rows whose members all verified) and the write-path
        accumulator (possibly partial)."""
        k = self.codec.params.rs_data
        assert 0 < len(hashes) <= k, (len(hashes), k)
        gid = self._gid(k, int(parity.shape[0]), hashes)
        existing = self._find_group_path(bytes(gid))
        if existing is not None:
            # gid hashes the member set AND the (version, k, m) geometry,
            # so an existing file has identical content: a fresh mtime
            # (what the purge keys on) is all a stable codeword needs —
            # skip rewriting ~m/k of the dataset every scrub pass
            try:
                os.utime(existing)
            except OSError:
                existing = None
        if existing is None:
            # manifest built only on the miss path: in steady state most
            # codewords take the touch shortcut, and serializing + hashing
            # ~m rows of parity per codeword per pass would dominate it
            manifest = {
                "v": MANIFEST_VERSION,
                "k": k,
                "m": int(parity.shape[0]),
                "maxlen": int(parity.shape[1]),
                "hashes": [bytes(h) for h in hashes],
                "lengths": [int(n) for n in lengths],
                "parity": [parity[i].tobytes() for i in range(parity.shape[0])],
                "parity_sums": [
                    bytes(blake2s_sum(parity[i].tobytes()))
                    for i in range(parity.shape[0])
                ],
            }
            path = self._group_path(bytes(gid))
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(msgpack.packb(manifest, use_bin_type=True))
            os.replace(tmp, path)
        for h in hashes:
            self.index.insert(bytes(h), bytes(gid))

    # --- repair path -------------------------------------------------------

    def _load_manifest(self, h: Hash) -> Optional[dict]:
        gid = self.index.get(bytes(h))
        if gid is None:
            return None
        path = self._find_group_path(bytes(gid))
        if path is None:
            return None
        try:
            with open(path, "rb") as f:
                man = msgpack.unpackb(f.read(), raw=False)
        except Exception:  # noqa: BLE001 — any bad sidecar = no coverage
            return None
        if man.get("v") != MANIFEST_VERSION or bytes(h) not in man["hashes"]:
            return None
        man["_path"] = path  # saves re-resolving for the mtime touch
        # a sidecar from an older (k, m) config cannot be decoded by the
        # current codec; the next scrub pass rewrites it
        if (man["k"] != self.codec.params.rs_data
                or man["m"] != self.codec.params.rs_parity):
            return None
        if len(man["hashes"]) > man["k"]:
            return None  # malformed
        return man

    def coverage(self, h: Hash) -> bool:
        """Is this block covered by a (possibly stale) parity sidecar?"""
        return self._load_manifest(h) is not None

    def try_reconstruct(self, h: Hash) -> Optional[bytes]:
        """Rebuild block `h` from its codeword's surviving pieces.

        Every candidate piece is verified before use (data shards by
        content hash, parity shards by stored checksum); the rebuilt
        block is verified against `h` before being returned.  Returns
        the plain block bytes, or None if fewer than k trustworthy
        pieces survive."""
        man = self._load_manifest(h)
        if man is None:
            return None
        k, m, maxlen = man["k"], man["m"], man["maxlen"]
        hashes = [Hash(x) for x in man["hashes"]]
        target_i = man["hashes"].index(bytes(h))

        pieces: List[np.ndarray] = []
        present: List[int] = []
        # data shards: re-read surviving member blocks from the store
        for i, mh in enumerate(hashes):
            if i == target_i:
                continue
            raw = self._read_verified_member(mh)
            if raw is None:
                continue
            shard = np.zeros(maxlen, dtype=np.uint8)
            shard[: len(raw)] = np.frombuffer(raw, dtype=np.uint8)
            pieces.append(shard)
            present.append(i)
            if len(present) >= k:
                break
        # implicit zero shards of a partial codeword: members j..k-1 are
        # all-zero by construction, always "present" at no cost
        if len(present) < k:
            for i in range(len(hashes), k):
                pieces.append(np.zeros(maxlen, dtype=np.uint8))
                present.append(i)
                if len(present) >= k:
                    break
        # parity shards as needed
        if len(present) < k:
            for j in range(m):
                p = np.frombuffer(man["parity"][j], dtype=np.uint8)
                if bytes(blake2s_sum(man["parity"][j])) != bytes(
                        man["parity_sums"][j]):
                    continue
                pieces.append(p)
                present.append(k + j)
                if len(present) >= k:
                    break
        if len(present) < k:
            return None

        shards = np.stack(pieces)[None, :, :]  # (1, p, maxlen)
        try:
            # rows=[target_i]: a single-block repair pays for ONE decoded
            # row, not all k (k× GF work saving).  Routed through the
            # manager's codec feeder when present: concurrent degraded
            # reads of the same loss pattern share one cached RS
            # schedule and one ragged dispatch (ops/feeder.py); a
            # closed/absent feeder decodes inline.  Guarded on identity:
            # the feeder fronts the MANAGER's codec, and this store may
            # run a different one (geometry change mid-flight, tests
            # swapping codecs) — a mismatched (k, m) must decode direct.
            feeder = getattr(self.manager, "feeder", None)
            if feeder is not None and feeder.codec is self.codec:
                # cls="bg": sidecar rebuilds run from the scrub/resync
                # heal paths — in the device transport's single queue
                # they yield to live foreground verifies/decodes
                data = feeder.decode_or_direct(
                    shards, present, rows=[target_i], cls="bg")[0]
            else:
                data = self.codec.rs_reconstruct(
                    shards, present, rows=[target_i])[0]  # (1, maxlen)
        except Exception:
            logger.exception("parity reconstruction failed for %s",
                             bytes(h).hex()[:16])
            return None
        out = data[0].tobytes()[: man["lengths"][target_i]]
        if bytes(block_hash(out, self.manager.hash_algo)) != bytes(h):
            logger.warning(
                "parity reconstruction of %s produced wrong hash "
                "(stale codeword?)", bytes(h).hex()[:16],
            )
            return None
        logger.info("locally reconstructed block %s from RS parity",
                    bytes(h).hex()[:16])
        # refresh the sidecar's mtime: its row failed verify this scrub
        # pass (that is why we are here), so the pass will not rewrite
        # it — without the touch the purge could drop it
        try:
            os.utime(man["_path"])
        except OSError:
            pass
        return out

    def _read_verified_member(self, h: Hash) -> Optional[bytes]:
        """A member block's plain bytes, only if present and intact."""
        found = self.manager.find_block(h)
        if found is None:
            return None
        path, compressed = found
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return None
        try:
            block = DataBlock(raw, compressed)
            data = block.decompressed()
        except Exception:
            return None
        if bytes(block_hash(data, self.manager.hash_algo)) != bytes(h):
            return None
        return data

    def purge_stale(self, older_than: float) -> int:
        """Delete sidecars not refreshed since `older_than` (unix time)
        and prune index entries pointing at missing files.  Codeword
        membership shifts with block churn, so every completed scrub
        pass calls this with its own start time — without it, orphaned
        .par files would accumulate on every pass."""
        removed = 0
        for base in self.all_dirs:
            if not os.path.isdir(base):
                continue
            for sub in os.listdir(base):
                d = os.path.join(base, sub)
                try:
                    names = os.listdir(d)
                except OSError:
                    continue
                for name in names:
                    p = os.path.join(d, name)
                    try:
                        if os.stat(p).st_mtime < older_than:
                            os.remove(p)
                            removed += 1
                    except OSError:
                        pass
        # prune index entries whose group file is gone
        dead = [
            k for k, gid in list(self.index.items(None, None))
            if self._find_group_path(bytes(gid)) is None
        ]
        for k in dead:
            self.index.remove(k)
        if removed or dead:
            logger.info("parity purge: %d stale sidecars, %d index entries",
                        removed, len(dead))
        return removed

    def stats(self) -> dict:
        return {"indexed_blocks": len(self.index)}


# Distributed parity shards carry an 8-byte header {magic, salt}: the
# salt is searched so the shard's CONTENT HASH — which is its identity
# and therefore its ring placement — lands on a node carrying no other
# piece of the codeword.  Without it, hash-random placement can stack
# several pieces on one node and a single node loss can exceed m.  With
# it (and the accumulator's distinct-member-node invariant), a codeword
# of k+m pieces occupies k+m distinct nodes whenever the cluster has
# that many — deterministic m-node-loss tolerance, not probabilistic.
PARITY_SHARD_MAGIC = b"GTPS"
PARITY_SHARD_HEADER = 8
_SALT_TRIES = 32


def pack_parity_shard(shard: bytes, salt: int) -> bytes:
    import struct

    return PARITY_SHARD_MAGIC + struct.pack("<I", salt) + shard


def unpack_parity_shard(blob: bytes) -> Optional[bytes]:
    if blob[:4] != PARITY_SHARD_MAGIC:
        return None
    return blob[PARITY_SHARD_HEADER:]


class ParityDistributor:
    """Cross-node half of write-time parity: stores each parity shard as
    an ordinary refcounted BLOCK (ring-placed on the cluster, fetched via
    rpc_get_block, scrubbed like any block) and records the codeword in
    the replicated parity index table, sharded by member hash.  See
    model/parity_index_table.py for the durability economics vs the
    reference's replication-only model."""

    def __init__(self, manager, parity_index_table):
        self.manager = manager
        self.table = parity_index_table
        self.codewords_distributed = 0

    def holds_index_for(self, h: Hash) -> bool:
        """Is this node an index replica for member `h`?  locally_covered
        is only authoritative on such nodes — with data factor > meta
        factor a storing node may NOT hold the index partition, and a
        local miss there means nothing (refreshing from it would mint a
        fresh codeword every scrub pass, forever)."""
        from ..table.schema import hash_partition_key

        me = bytes(self.manager.system.id)
        ph = hash_partition_key(bytes(h))
        return any(bytes(n) == me
                   for n in self.table.replication.read_nodes(ph))

    def locally_covered(self, h: Hash) -> bool:
        """Any live parity-index row for member `h` in the LOCAL store.
        The index is sharded by member hash with the same ring walk as
        block placement, so (when data factor ≤ meta factor) a node
        storing the block also holds its index rows — a local read is
        authoritative once table sync has converged.  Used by the scrub
        worker's coverage refresh: blocks that lost distributed coverage
        (failed distribution, a wrongly-tombstoned codeword, pre-EC
        data) are re-fed to the write accumulator, making coverage
        CONVERGENT instead of write-time-or-never.  Callers must gate on
        holds_index_for (see its docstring) and run this off-loop for
        batches (synchronous DB iteration)."""
        from ..table.schema import hash_partition_key

        data = self.table.data
        prefix = bytes(hash_partition_key(bytes(h)))
        for k, raw in data.store.items(prefix, None):
            if k[:32] != prefix:
                break
            try:
                ent = data.decode_entry(raw)
            except Exception:
                continue
            if not ent.is_tombstone():
                return True
        return False

    def _salted(self, shard: bytes, taken: set) -> tuple:
        """(blob, hash) for the first salt whose placement avoids nodes
        already carrying a piece of this codeword; best-effort after
        _SALT_TRIES (small clusters can't always avoid overlap)."""
        best = None
        for salt in range(_SALT_TRIES):
            blob = pack_parity_shard(shard, salt)
            ph = block_hash(blob, self.manager.hash_algo)
            nodes = self.manager.replication.write_nodes(ph)
            node = bytes(nodes[0]) if nodes else b""
            if node not in taken:
                taken.add(node)
                return blob, ph
            if best is None:
                best = (blob, ph, node)
        blob, ph, node = best
        taken.add(node)
        return blob, ph

    async def distribute(self, hashes: Sequence[Hash],
                         lengths: Sequence[int],
                         parity: np.ndarray) -> None:
        from ..model.parity_index_table import ParityIndexEntry
        from ..utils.crdt import now_msec

        m = int(parity.shape[0])
        k = self.manager.codec.params.rs_data
        # Salted gid: DISTRIBUTED codeword ids must be unique per encode,
        # not deterministic — a revert after a failed index insert leaves
        # a sticky or-merged tombstone under the gid, and a deterministic
        # id would make any later re-encode of the same member set merge
        # into that tombstone and silently yield zero coverage.  (The
        # LOCAL sidecar store keeps the deterministic _gid: its files are
        # refreshed in place each scrub pass and carry no CRDT.)  Cost:
        # two writers racing the same group create two independent
        # codewords — double parity until GC, never wrong coverage.
        gid = blake2s_sum(
            bytes(ParityStore._gid(k, m, hashes)) + os.urandom(8))
        taken = set()
        for h in hashes:
            nodes = self.manager.replication.write_nodes(Hash(h))
            if nodes:
                taken.add(bytes(nodes[0]))
        blobs, phashes = [], []
        for j in range(m):
            blob, ph = self._salted(parity[j].tobytes(), taken)
            blobs.append(blob)
            phashes.append(ph)
        # parity blocks first, index second: the index's member-0 entry
        # refs the parity hashes, and a ref to a not-yet-written block
        # would trigger spurious resync fetches
        for ph, b in zip(phashes, blobs):
            await self.manager.rpc_put_block(ph, b, is_parity=True)
        ts = now_msec()
        entries = [
            ParityIndexEntry(
                member=Hash(h), gid=gid, timestamp=ts, k=k, m=m,
                member_index=i,
                members=[bytes(x) for x in hashes],
                lengths=[int(n) for n in lengths],
                parity_hashes=[bytes(p) for p in phashes],
            )
            for i, h in enumerate(hashes)
        ]
        # The shards are on disk cluster-wide but carry rc only once the
        # index's member-0 row lands (parity_index_table.updated).  If
        # the insert is lost the shards are orphans nothing reclaims, so
        # retry, then on terminal failure mark them Deletable through
        # the ordinary ref machinery (incref+decref → GC delay → reclaim).
        for attempt in range(3):
            try:
                await self.table.insert_many(entries)
                break
            except Exception:
                if attempt == 2:
                    logger.exception(
                        "parity index insert failed for gid %s; "
                        "tombstoning the codeword", bytes(gid).hex()[:16])
                    await self._revert_codeword(entries)
                    return
                await asyncio.sleep(0.5 * (attempt + 1))
        self.codewords_distributed += 1

    async def _revert_codeword(self, entries) -> None:
        """Best-effort revert after a terminal index-insert failure.

        Tombstone the INDEX rows, not the parity block-refs: a quorum
        failure can be a partial success, and a minority node that
        applied a live member-0 row would anti-entropy it cluster-wide
        later.  The or-merged tombstone neutralizes any such row (its
        updated() hook then performs the decref that reclaims the
        shards); if no row was applied anywhere, the shards simply have
        rc = 0 and phase 2 of `repair blocks` hands them to resync,
        which deletes unreferenced local blocks."""
        for e in entries:
            e.deleted.set()
        try:
            await self.table.insert_many(entries)
        except Exception:
            logger.warning(
                "codeword revert insert also failed; shards are rc-less "
                "orphans until the next `repair blocks` pass")


class WriteParityAccumulator:
    """Write-time RS encoding: parity exists from first write, not from
    the first scrub pass 25 days later.

    The reference's put path offers no erasure protection at all — a
    freshly-PUT block is guarded only by replication
    (ref src/api/s3/put.rs:286-360 writes, src/rpc/replication_mode.rs
    durability) — and the scrub-generated sidecars above leave a window
    between write and first scrub.  This accumulator closes the window:
    blocks join an in-progress codeword; when k members accumulate (or
    `flush_after` seconds pass — partial codewords encode against
    implicit zero shards) the parity is encoded OFF the write path (one
    to_thread hop through the codec's gather kernel).  PutObject latency
    is unaffected: the put path only appends bytes it already holds.

    Two deployments with DIFFERENT grouping invariants:
      - storing-node side (`store` set): every block this node stores
        joins a codeword persisted as a LOCAL sidecar — co-location is
        the point (zero-network local repair).
      - writer side (`distributor` set, hooked into rpc_put_block):
        codewords group blocks bound for DISTINCT nodes — add() flushes
        early rather than admit two members placed on the same node, so
        RS(k, m) deterministically survives m member-node losses.
        Grouping on the storing side instead would co-locate all k
        members on the dying node, reducing node-loss tolerance to
        codewords with ≤ m members.

    All mutation happens on the event loop; the encode runs on a
    snapshot in a worker thread.  Blocks deleted before their codeword's
    other members merely cost decode head-room (the sidecar holds m
    parity shards), and the next scrub pass re-groups survivors."""

    def __init__(self, store: Optional[ParityStore], codec,
                 flush_after: float = 5.0,
                 distributor: Optional[ParityDistributor] = None,
                 manager=None):
        self.store = store
        self.codec = codec
        self.flush_after = flush_after
        self.distributor = distributor
        self.manager = manager if manager is not None else (
            store.manager if store is not None else None)
        self._pending: List[tuple] = []  # (hash, DataBlock)
        self._pending_nodes: set = set()  # primary data node per member
        self._timer: Optional[object] = None  # asyncio.TimerHandle
        self._tasks: set = set()
        # writer-side re-PUT dedup: an OrderedDict-as-LRU of hashes this
        # writer recently wrapped into codewords (bounded; cross-writer
        # repeats still duplicate, which the ref-driven GC cleans up)
        from collections import OrderedDict

        self._recent: "OrderedDict[bytes, None]" = OrderedDict()
        self._recent_cap = 4096
        self.codewords_encoded = 0

    def recently_added(self, h: Hash) -> bool:
        return bytes(h) in self._recent

    def add(self, h: Hash, block: "DataBlock") -> None:
        """Register a freshly-written block.  Event loop only; the block
        is held as stored (possibly compressed) and decompressed on the
        encode thread, so the write path pays nothing."""
        k = self.codec.params.rs_data
        if k <= 0:
            return
        if self.distributor is not None and self.manager is not None:
            self._recent[bytes(h)] = None
            self._recent.move_to_end(bytes(h))
            while len(self._recent) > self._recent_cap:
                self._recent.popitem(last=False)
            # distinct-node invariant for distributed codewords
            nodes = self.manager.replication.write_nodes(h)
            node = bytes(nodes[0]) if nodes else b""
            if node in self._pending_nodes:
                self._flush()
            self._pending_nodes.add(node)
        self._pending.append((h, block))
        if len(self._pending) >= k:
            self._flush()
        elif self._timer is None:
            loop = asyncio.get_running_loop()
            self._timer = loop.call_later(self.flush_after, self._flush)

    def _flush(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if not self._pending:
            return
        group, self._pending = self._pending, []
        self._pending_nodes = set()
        task = asyncio.get_running_loop().create_task(
            self._encode_and_store(group)
        )
        # keep a strong ref (create_task results are weakly held)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _encode_and_store(self, group: List[tuple]) -> None:
        try:
            hashes = [h for h, _ in group]

            def encode_and_store():
                blocks = [b.decompressed() for _, b in group]
                # rs_encode_blocks zero-pads the member count to a whole
                # codeword — exactly the partial-codeword zero-shard
                # semantics.  Via the codec feeder when the manager has
                # one: concurrent write-time codewords (every in-flight
                # PUT under parity_on_write) coalesce into one ragged
                # pointer-gather/device pass instead of one GF call each.
                feeder = getattr(self.manager, "feeder", None) \
                    if self.manager is not None else None
                if feeder is not None and feeder.codec is self.codec:
                    parity = feeder.encode_or_direct(blocks)
                else:
                    parity = self.codec.rs_encode_blocks(blocks)
                if self.store is not None:
                    self.store.put_codeword(
                        hashes, [len(b) for b in blocks], parity[0])
                return parity[0], [len(b) for b in blocks]

            parity_row, lengths = await asyncio.to_thread(encode_and_store)
            self.codewords_encoded += 1
            if self.distributor is not None:
                await self.distributor.distribute(hashes, lengths, parity_row)
        except Exception:  # noqa: BLE001 — write-path parity is best-effort
            logger.exception("write-time parity encode failed")

    async def drain(self) -> None:
        """Flush the partial codeword and wait for in-flight encodes
        (shutdown path — a clean stop must not lose the tail)."""
        self._flush()
        while self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)
