"""MerkleUpdater — incremental per-partition Merkle trees over table items.

Equivalent of reference src/table/merkle.rs (SURVEY.md §2.4): one Merkle
trie per ring partition; the trie descends on the bytes of **blake2(tree
key)** (so no key is a prefix of another); node kinds are Empty,
Intermediate([(next_byte, child_hash)]) and Leaf(item_key, value_hash)
(merkle.rs:45-67).  A todo-queue written transactionally by TableData
drives the updater (merkle.rs:92-253); node hash = blake2 of the node's
canonical serialization; an intermediate left with a single leaf child
collapses back into that leaf (merkle.rs:163-182).

Node db key = 1 byte partition ‖ khash prefix (the framework uses
PARTITION_BITS=8 partitions, ring.py; the reference packs a u16).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, List, Optional, Tuple

from ..db import Transaction
from ..utils.background import Worker, WorkerState
from ..utils.data import Hash, blake2sum
from ..utils.migrate import pack, unpack
from .data import TableData

logger = logging.getLogger("garage_tpu_torch.table.merkle")

EMPTY = None
_UNCHANGED = object()  # "subtree not modified" — distinct from EMPTY (ref
                       # merkle.rs models this as Option<MerkleNode>)
EMPTY_HASH = Hash(b"\x00" * 32)


def _encode_node(node: Any) -> bytes:
    return pack(node)


def _decode_node(data: Optional[bytes]) -> Any:
    if data is None or data == b"":
        return EMPTY
    return unpack(data)


def node_hash(node: Any) -> Hash:
    """Hash of a node; the empty node hashes to all-zeros (ref merkle.rs
    empty_node_hash)."""
    if node is EMPTY:
        return EMPTY_HASH
    return blake2sum(_encode_node(node))


def _is_leaf(node: Any) -> bool:
    return isinstance(node, (list, tuple)) and len(node) == 3 and node[0] == "l"


def _is_int(node: Any) -> bool:
    return isinstance(node, (list, tuple)) and len(node) == 2 and node[0] == "i"


def leaf(key: bytes, vhash: bytes) -> list:
    return ["l", key, bytes(vhash)]


def intermediate(children: List[Tuple[int, bytes]]) -> list:
    return ["i", [[b, bytes(h)] for b, h in sorted(children)]]


def int_children(node: Any) -> List[Tuple[int, bytes]]:
    return [(b, bytes(h)) for b, h in node[1]]


def node_key(partition: int, prefix: bytes) -> bytes:
    return bytes([partition]) + prefix


class MerkleUpdater:
    def __init__(self, data: TableData):
        self.data = data
        # codec feeder (ops/feeder.py), attached by Garage.spawn_workers:
        # node/key hash batches ride it as ragged `mhash` submissions
        # (class bg) so a Merkle backlog drain shares the batching engine
        # the data plane already has.  None (bare-library/tests) =
        # serial blake2sum — bit-identical either way.
        self.feeder = None
        m = getattr(data.system, "metrics", None)
        if m is not None:
            # families shared across tables via registry name-dedup
            self._m_items = m.histogram(
                "merkle_batch_items",
                "Todo items per batched Merkle pass",
                buckets=(1.0, 4.0, 16.0, 64.0, 128.0, 256.0, 512.0,
                         1024.0))
            self._m_nodes = m.counter(
                "merkle_batch_nodes_total",
                "Trie nodes rewritten by the batched Merkle updater "
                "(shared path nodes count once per batch, not once per "
                "item)")
            self._m_hashes = m.counter(
                "merkle_batch_hash_total",
                "Node/key hashes computed through batched Merkle "
                "passes, by route (feeder = ragged codec-feeder batch, "
                "serial = inline blake2sum)")
        else:
            self._m_items = self._m_nodes = self._m_hashes = None

    # --- batched hashing -----------------------------------------------------

    def hash_many(self, bufs: List[bytes]) -> List[Hash]:
        """Hash a batch of byte strings with the table engine's
        blake2sum, riding the codec feeder's ragged mhash path when one
        is attached (one dispatch for the whole batch) and falling back
        to the serial loop otherwise — bit-identical by construction."""
        if not bufs:
            return []
        f = self.feeder
        if f is not None and not f.closed and len(bufs) > 1:
            try:
                # peers=1: the updater blocks on each batch, so the
                # dispatcher must not sleep an SLO window out per batch;
                # concurrent tables' submissions still coalesce because
                # the dispatcher drains everything pending at dispatch
                digs = f.submit_mhash(bufs, peers=1).result()
                if self._m_hashes is not None:
                    self._m_hashes.inc(len(bufs), route="feeder")
                return digs
            except Exception:  # noqa: BLE001 — hashing must never fail
                logger.debug("feeder mhash failed; hashing inline",
                             exc_info=True)
        if self._m_hashes is not None:
            self._m_hashes.inc(len(bufs), route="serial")
        return [blake2sum(b) for b in bufs]

    # --- tree access (ref merkle.rs:255-301) ---

    def read_node(self, tx: Optional[Transaction], nk: bytes) -> Any:
        if tx is not None:
            return _decode_node(tx.get(self.data.merkle_tree, nk))
        return _decode_node(self.data.merkle_tree.get(nk))

    def _put_node(self, tx: Transaction, nk: bytes, node: Any) -> Hash:
        if node is EMPTY:
            tx.remove(self.data.merkle_tree, nk)
        else:
            tx.insert(self.data.merkle_tree, nk, _encode_node(node))
        return node_hash(node)

    def partition_root_hash(self, partition: int) -> Hash:
        """Root hash of one partition's subtree — what sync compares."""
        return node_hash(self.read_node(None, node_key(partition, b"")))

    # --- the update algorithm (ref merkle.rs:92-253) ---

    def update_item(self, k: bytes) -> None:
        """Apply one todo entry for item key `k`.  The todo value is the new
        value hash (b'' = item deleted); it is removed only if unchanged
        after the tree transaction (ref merkle.rs:113-128)."""
        todo_val = self.data.merkle_todo.get(k)
        if todo_val is None:
            return
        new_vhash = None if todo_val == b"" else Hash(todo_val)
        khash = blake2sum(k)
        partition = self.data.replication.partition_of(Hash(k[:32]))

        def txn(tx: Transaction):
            self._update_rec(tx, k, khash, partition, b"", new_vhash)
            cur = tx.get(self.data.merkle_todo.tree, k)
            if cur == todo_val:
                self.data.merkle_todo.tx_remove(tx, k)

        self.data.db.transaction(txn)

    def _update_rec(
        self,
        tx: Transaction,
        k: bytes,
        khash: Hash,
        partition: int,
        prefix: bytes,
        new_vhash: Optional[Hash],
    ) -> Optional[Hash]:
        """Returns the node's new hash, or None if the subtree is unchanged
        (ref merkle.rs:131-253 update_item_rec)."""
        i = len(prefix)
        nk = node_key(partition, prefix)
        node = self.read_node(tx, nk)
        mutate = _UNCHANGED

        if node is EMPTY:
            if new_vhash is not None:
                mutate = leaf(k, bytes(new_vhash))

        elif _is_int(node):
            children = int_children(node)
            next_prefix = prefix + khash[i : i + 1]
            subhash = self._update_rec(tx, k, khash, partition, next_prefix, new_vhash)
            if subhash is not None:
                nb = khash[i]
                children = [(b, h) for b, h in children if b != nb]
                if subhash != EMPTY_HASH:
                    children.append((nb, bytes(subhash)))
                if not children:
                    logger.warning("intermediate collapsed to empty (unexpected)")
                    mutate = EMPTY
                elif len(children) == 1:
                    sub_nk = node_key(partition, prefix + bytes([children[0][0]]))
                    subnode = self.read_node(tx, sub_nk)
                    if _is_leaf(subnode):
                        # hoist the single remaining leaf up one level
                        tx.remove(self.data.merkle_tree, sub_nk)
                        mutate = subnode
                    else:
                        mutate = intermediate(children)
                else:
                    mutate = intermediate(children)

        else:  # leaf
            exlf_k, exlf_vhash = bytes(node[1]), bytes(node[2])
            if exlf_k == k:
                if new_vhash is not None and bytes(new_vhash) != exlf_vhash:
                    mutate = leaf(k, bytes(new_vhash))
                elif new_vhash is None:
                    mutate = EMPTY
            elif new_vhash is not None:
                # split: push the existing leaf down by its own khash byte,
                # then insert our key (ref merkle.rs:196-238)
                exlf_khash = blake2sum(exlf_k)
                assert exlf_khash[:i] == khash[:i]
                children = []
                sub1 = self._update_rec(
                    tx, exlf_k, exlf_khash, partition,
                    prefix + exlf_khash[i : i + 1], Hash(exlf_vhash),
                )
                children.append((exlf_khash[i], bytes(sub1)))
                sub2 = self._update_rec(
                    tx, k, khash, partition, prefix + khash[i : i + 1], new_vhash
                )
                children = [(b, h) for b, h in children if b != khash[i]]
                children.append((khash[i], bytes(sub2)))
                mutate = intermediate(children)

        if mutate is _UNCHANGED:
            return None
        return self._put_node(tx, nk, mutate)

    # --- batched updates (the metadata-at-millions path) --------------------
    #
    # update_item is exact but pays one transaction and a re-hash of the
    # whole root-to-leaf path PER ITEM: a bulk insert of B items sharing
    # trie prefixes rewrites (and blake2s) the shared upper nodes B
    # times.  update_batch applies a whole todo batch structurally first
    # (hashes deferred), then re-hashes each dirty node exactly ONCE,
    # level-batched through hash_many, and commits everything — node
    # writes, removals and todo acknowledgments — in one transaction.
    # The final tree (keys, node encodings, root hash) is bit-identical
    # to applying the same items serially: structure never depends on a
    # hash value (emptiness and the single-leaf collapse are structural
    # tests), and the hash of a node is a pure function of its final
    # structure.  Safe outside a transaction because this worker is the
    # only merkle_tree writer; concurrent item updates only append todo
    # entries, and an entry that changes mid-batch is simply left in the
    # todo queue (same contract as update_item's compare-and-remove).

    def update_batch(self, items: List[Tuple[bytes, Optional[bytes]]]) -> int:
        """Apply todo entries [(key, todo_val)] in one batched pass.
        Returns the number of items applied."""
        items = [(k, tv) for k, tv in items if tv is not None]
        if not items:
            return 0
        khashes = self.hash_many([k for k, _tv in items])
        by_part: dict = {}
        for (k, tv), kh in zip(items, khashes):
            p = self.data.replication.partition_of(Hash(k[:32]))
            by_part.setdefault(p, []).append((k, kh, tv))
        writes: List[Tuple[bytes, Optional[bytes]]] = []  # (nk, enc|None)
        for partition, part_items in by_part.items():
            ctx = _BatchCtx(self, partition)
            for k, kh, tv in part_items:
                new_vhash = None if tv == b"" else Hash(tv)
                self._upd_structural(ctx, k, kh, b"", new_vhash)
            writes.extend(self._finalize(ctx))

        def txn(tx: Transaction):
            for nk, enc in writes:
                if enc is None:
                    tx.remove(self.data.merkle_tree, nk)
                else:
                    tx.insert(self.data.merkle_tree, nk, enc)
            for k, tv in items:
                cur = tx.get(self.data.merkle_todo.tree, k)
                if cur == tv:
                    self.data.merkle_todo.tx_remove(tx, k)

        self.data.db.transaction(txn)
        if self._m_items is not None:
            self._m_items.observe(float(len(items)))
            self._m_nodes.inc(len(writes))
        return len(items)

    def _upd_structural(self, ctx: "_BatchCtx", k: bytes, khash: Hash,
                        prefix: bytes, new_vhash: Optional[Hash]) -> bool:
        """Structural twin of _update_rec: same mutations, hashes
        deferred (dirty intermediates carry None placeholders resolved
        by _finalize).  Returns True iff the subtree changed."""
        i = len(prefix)
        node = ctx.read(prefix)

        if node is EMPTY:
            if new_vhash is None:
                return False
            ctx.write(prefix, leaf(k, bytes(new_vhash)))
            return True

        if _w_is_int(node):
            children = _w_children(node)
            nb = khash[i]
            sub_prefix = prefix + khash[i:i + 1]
            if not self._upd_structural(ctx, k, khash, sub_prefix,
                                        new_vhash):
                return False
            if ctx.read(sub_prefix) is EMPTY:
                children.pop(nb, None)
            else:
                children[nb] = None  # re-hashed by _finalize
            if not children:
                logger.warning("intermediate collapsed to empty (unexpected)")
                ctx.write(prefix, EMPTY)
            elif len(children) == 1:
                (b2,) = children
                sub2 = prefix + bytes([b2])
                subnode = ctx.read(sub2)
                if _is_leaf(subnode):
                    # hoist the single remaining leaf up one level
                    ctx.write(sub2, EMPTY)
                    ctx.write(prefix, subnode)
                else:
                    ctx.write(prefix, _working_int(children))
            else:
                ctx.write(prefix, _working_int(children))
            return True

        # leaf
        exlf_k, exlf_vhash = bytes(node[1]), bytes(node[2])
        if exlf_k == k:
            if new_vhash is not None and bytes(new_vhash) != exlf_vhash:
                ctx.write(prefix, leaf(k, bytes(new_vhash)))
                return True
            if new_vhash is None:
                ctx.write(prefix, EMPTY)
                return True
            return False
        if new_vhash is None:
            return False
        # split: push the existing leaf down by its own khash byte, then
        # insert our key (both recursions may land in the same child)
        exlf_khash = blake2sum(exlf_k)
        assert exlf_khash[:i] == khash[:i]
        children: dict = {}
        self._upd_structural(ctx, exlf_k, exlf_khash,
                             prefix + exlf_khash[i:i + 1], Hash(exlf_vhash))
        children[exlf_khash[i]] = None
        self._upd_structural(ctx, k, khash, prefix + khash[i:i + 1],
                             new_vhash)
        children[khash[i]] = None
        ctx.write(prefix, _working_int(children))
        return True

    def _finalize(self, ctx: "_BatchCtx") -> List[Tuple[bytes, Optional[bytes]]]:
        """Resolve placeholder child hashes bottom-up — every dirty
        level's node encodings hashed in ONE hash_many batch — and
        return the final (node_key, encoding|None) write set."""
        hashes: dict = {}
        writes: List[Tuple[bytes, Optional[bytes]]] = []
        for depth in sorted({len(p) for p in ctx.dirty}, reverse=True):
            prefixes, encodings = [], []
            for p in sorted(ctx.dirty):
                if len(p) != depth:
                    continue
                node = ctx.nodes[p]
                if node is EMPTY:
                    writes.append((node_key(ctx.partition, p), None))
                    continue
                if _is_working_int(node):
                    node = intermediate([
                        (b, bytes(hashes[p + bytes([b])]) if h is None
                         else h)
                        for b, h in node[1].items()
                    ])
                    ctx.nodes[p] = node
                enc = _encode_node(node)
                prefixes.append(p)
                encodings.append(enc)
                writes.append((node_key(ctx.partition, p), enc))
            for p, d in zip(prefixes, self.hash_many(encodings)):
                hashes[p] = d
        return writes

    # --- subtree walks (used by sync) ---

    def collect_leaves(self, partition: int, prefix: bytes) -> List[Tuple[bytes, bytes]]:
        """All (item_key, value_hash) leaves under a node."""
        out: List[Tuple[bytes, bytes]] = []
        self._collect(partition, prefix, out)
        return out

    def _collect(self, partition: int, prefix: bytes, out):
        node = self.read_node(None, node_key(partition, prefix))
        if node is EMPTY:
            return
        if _is_leaf(node):
            out.append((bytes(node[1]), bytes(node[2])))
            return
        for b, _h in int_children(node):
            self._collect(partition, prefix + bytes([b]), out)


class _BatchCtx:
    """One batch's structural overlay over one partition's subtree."""

    __slots__ = ("u", "partition", "nodes", "dirty")

    def __init__(self, updater: MerkleUpdater, partition: int):
        self.u = updater
        self.partition = partition
        self.nodes: dict = {}   # prefix -> node (working forms allowed)
        self.dirty: set = set()

    def read(self, prefix: bytes) -> Any:
        if prefix in self.nodes:
            return self.nodes[prefix]
        node = self.u.read_node(None, node_key(self.partition, prefix))
        self.nodes[prefix] = node
        return node

    def write(self, prefix: bytes, node: Any) -> None:
        self.nodes[prefix] = node
        self.dirty.add(prefix)


def _working_int(children: dict) -> list:
    """Overlay intermediate: {next_byte: hash | None placeholder}."""
    return ["wi", children]


def _is_working_int(node: Any) -> bool:
    return isinstance(node, list) and len(node) == 2 and node[0] == "wi"


def _w_is_int(node: Any) -> bool:
    return _is_int(node) or _is_working_int(node)


def _w_children(node: Any) -> dict:
    if _is_working_int(node):
        return node[1]
    return {b: bytes(h) for b, h in node[1]}


class MerkleWorker(Worker):
    """Drains the merkle_todo queue (ref merkle.rs:303-340): batched
    passes through MerkleUpdater.update_batch ([table] merkle_batch), or
    the legacy one-transaction-per-item path when merkle_batch <= 1."""

    BATCH = 100  # legacy per-item batch bound (merkle_batch <= 1)

    def __init__(self, updater: MerkleUpdater):
        self.updater = updater
        self.data = updater.data
        cfg = getattr(getattr(self.data.system, "config", None), "table",
                      None)
        self.batch = int(getattr(cfg, "merkle_batch", 256) or 256)

    def name(self) -> str:
        return f"{self.data.schema.TABLE_NAME} Merkle"

    async def work(self) -> WorkerState:
        st = self.status()
        # The whole batch runs OFF the event loop (ref merkle.rs:303-340
        # uses spawn_blocking for the same reason): after a bulk insert the
        # todo backlog is thousands of items and the runner re-calls work()
        # continuously while BUSY — hashing them on the loop thread starves
        # every foreground request on a small host for the duration.
        processed = await asyncio.to_thread(self._work_batch)
        remaining = self.data.merkle_todo_len()
        st.queue_length = remaining
        # re-check the todo queue after the batch: items that landed
        # mid-batch behind the cursor (bulk-insert churn) must drain NOW,
        # not after a wait_for_work interval whose notify may already
        # have been consumed
        return (WorkerState.BUSY if processed or remaining
                else WorkerState.IDLE)

    def _collect_todo(self, limit: int) -> List[Tuple[bytes, bytes]]:
        # ONE range_scan page, not a get_gt cursor walk per item: on the
        # native engine each get_gt is a fresh iterator (measured 0.4 ms
        # — it dominated the whole batched drain)
        return self.data.merkle_todo.range_scan(limit=limit)

    def _work_batch(self) -> int:
        if self.batch > 1:
            items = self._collect_todo(self.batch)
            if not items:
                return 0
            try:
                return self.updater.update_batch(items)
            except Exception:
                # belt and braces: a batched-path bug must degrade to
                # the exact serial algorithm, never wedge the table
                logger.exception(
                    "%s: batched Merkle pass failed; falling back to "
                    "per-item updates", self.data.schema.TABLE_NAME)
                for k, _tv in items:
                    self.updater.update_item(k)
                return len(items)
        processed = 0
        cursor = b""
        while processed < self.BATCH:
            nxt = (
                self.data.merkle_todo.first()
                if cursor == b""
                else self.data.merkle_todo.get_gt(cursor)
            )
            if nxt is None:
                break
            key, _val = nxt
            self.updater.update_item(key)
            cursor = key
            processed += 1
        return processed

    async def wait_for_work(self) -> None:
        self.data.merkle_todo_notify.clear()
        if self.data.merkle_todo_len() > 0:
            return
        await self.data.merkle_todo_notify.wait()
