"""RepairPlanner — repair-bandwidth-optimal degraded reads.

The decode ladder's original gather (model/parity_repair.py) fetched
every surviving data member AND every parity shard of a codeword even
though a decode needs exactly k pieces, so one degraded read could move
(k+m−1)/k× the necessary bytes — and every fetch walked the full
sweep/timeout chain, dead nodes included.  This module turns every
degraded read / reconstruction into a *planned* fetch, per the two
PAPERS.md schemes the ROADMAP names:

  1. **Exact-k survivor selection** ("Boosting the Performance of
     Degraded Reads in RS-coded Distributed Storage Systems"): candidate
     pieces are ranked by their best holder's `RpcHelper.peer_rank` —
     the per-peer RTT EWMA, circuit-breaker state, zone locality,
     gossiped load-governor pressure and fail-slow verdict (the
     least-loaded / healthiest-survivor half of the same paper;
     utils/health_score.py) — with data members before
     parity (parity only fills the gap left by dead members) and
     pieces whose every holder is breaker-open last.  Exactly k fetches
     go out; a *ranked replacement* launches only when a fetch fails, or
     hedges in when the wave stalls past the hedge delay.  Fetched bytes
     that end up unused are counted in repair_overfetch_bytes_total.

  2. **Partial-parallel repair / PPR** (+ the sub-shard idea of "Fast
     Product-Matrix Regenerating Codes"): instead of shipping whole
     shards, each survivor multiplies its local shard by the decode
     coefficient in GF(256) — the `ppr` block RPC, served through
     ops/gf256 / the native kernel in ops/cpu_codec — and ships the
     partial product *truncated to the target row's length*, so a
     reconstruction moves at most one target-row-sized partial sum per
     survivor link and the coordinator only XOR-accumulates.  The GF
     work parallelizes across the survivors' CPUs; min(shard, target)
     truncation makes PPR ≤ whole-shard byte-wise.  Peers that predate
     the endpoint (version gossip) or answer it with "unknown
     rpc" fall back to whole-shard fetch for that piece — mixed-version
     clusters reconstruct bit-identically, just less cheaply.

Replacement algebra: a survivor's partial c_old ⊗ shard is rescaled
locally to any later coefficient via (c_new ⊗ c_old⁻¹) ⊗ partial, so a
failed fetch that changes the survivor set never invalidates partials
already in hand — the coordinator re-plans, rescales, and fetches only
the replacement.  Re-plans are first-class: every survivor that dies
mid-plan (flat replacement, mid-tree subtree loss, version demotion,
tree abort) lands in repair_replan_total{reason}.

Two extensions finish the regenerating-codes program:

  3. **Tree-aggregated PPR** (`ppr_tree` block RPC): survivors forward
     their GF(256)-scaled partials along a repair tree shaped from the
     gossiped peer-rank map (breaker / fail-slow / zone / pressure /
     RTT) — interior nodes XOR-accumulate their children's aggregates
     into their own partials before forwarding, so the COORDINATOR
     ingests ONE row-set-sized stream regardless of k.  A mid-tree node
     failure surfaces as that subtree's pieces in the response's `miss`
     list; since the missing pieces are re-fetched (same survivor set,
     same decode row), the aggregate stays valid and the coordinator
     completes the sum with flat neutral-coefficient fetches — only a
     piece that is UNFETCHABLE anywhere aborts the tree back to the
     flat planner (the aggregate cannot be per-piece rescaled after a
     set change).  Mixed-version holders (pre-`ppr_tree` gossip, or an
     "unknown block rpc" answer) demote that edge to flat PPR.

  4. **Chain repair** (`reconstruct_group`): a codeword that lost
     m′ > 1 rows decodes ALL m′ targets from ONE set of k fetched /
     aggregated partials — the tree carries m′ coefficients per piece
     and m′ accumulator rows per stream; the flat path fetches
     neutral-coefficient raw sub-shards once and rescales locally per
     target row.  m′ repairs cost ≤ k fetches total, not m′·k.

Safety is unchanged from the gather path: whole-shard pieces are
verified by content hash before use, partial products cannot be (they
are not content-addressed), but the rebuilt block must hash to the
requested id before it is returned — a corrupt partial costs a fallback,
never wrong data.
"""

from __future__ import annotations

import asyncio
import logging
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..net.frame import PRIO_NORMAL
from ..ops import gf256
from ..utils.data import Hash, block_hash
from ..utils.error import GarageError

logger = logging.getLogger("garage_tpu_torch.block.repair_plan")

# Gossiped software version from which peers answer the `ppr` block RPC;
# older peers are never sent a partial-product request.  Unknown or
# unparseable versions are tried optimistically — an "unknown block rpc"
# answer demotes the peer to whole-shard for the rest of the process.
PPR_MIN_VERSION = (0, 9, 0)

# Gossiped software version from which peers serve the `ppr_tree`
# aggregation RPC; older (but PPR-capable) peers get their edge demoted
# to flat PPR instead of a tree role.
PPR_TREE_MIN_VERSION = (0, 9, 5)

# c_applied sentinel: the payload is the raw (unscaled) shard bytes —
# whole-shard fetches and PPR fallbacks land here; the coordinator
# scales by the final coefficient itself.
RAW = -1

_VER_RE = re.compile(r"^(\d+)\.(\d+)(?:\.(\d+))?")


def parse_version(v: Optional[str]) -> Optional[tuple]:
    """Leading numeric (major, minor, patch) of a gossiped version tag;
    None when absent/unparseable (suffixes like '-dev' are ignored)."""
    if not v:
        return None
    m = _VER_RE.match(str(v))
    if m is None:
        return None
    return (int(m.group(1)), int(m.group(2)), int(m.group(3) or 0))


class _Piece:
    """One fetchable codeword piece: a surviving data member or a parity
    shard (implicit zero shards of a partial codeword are free and never
    fetched)."""

    __slots__ = ("index", "hash", "kind")

    def __init__(self, index: int, hash_: bytes, kind: str):
        self.index = index          # position in the extended codeword
        self.hash = bytes(hash_)    # content hash == ring placement
        self.kind = kind            # "data" | "parity"

    def __repr__(self) -> str:  # debug/log friendliness
        return f"<piece {self.index} {self.kind} {self.hash.hex()[:8]}>"


class RepairPlanner:
    """Plans and executes bandwidth-minimal reconstruction of one
    codeword row.  Owned by the BlockManager; model/parity_repair.py
    routes every distributed decode through it (falling back to the
    legacy sweep-everything gather only if the plan comes up empty)."""

    def __init__(self, manager, use_ppr: bool = True,
                 hedge_delay: Optional[float] = None,
                 use_tree: bool = True, tree_fanout: int = 4):
        self.manager = manager
        self.use_ppr = use_ppr
        # tree-aggregated PPR: survivors forward partials along a repair
        # tree so the coordinator ingests one stream regardless of k
        self.use_tree = use_tree
        self.tree_fanout = max(1, int(tree_fanout))
        # None → derive from the block endpoint's observed latency
        # quantile (same source as read hedging), 1 s static until
        # enough samples exist
        self.hedge_delay = hedge_delay
        self._no_ppr: set = set()     # peers observed not to answer `ppr`
        self._no_tree: set = set()    # peers observed not to answer `ppr_tree`
        self._row_cache: dict = {}    # (k, m, present, target) -> row
        self.plans = 0
        self.hedges = 0
        self.ppr_fallbacks = 0
        self.tree_plans = 0           # reconstructions served by a tree
        self.tree_demotions = 0       # edges demoted to flat (version)
        self.replans: dict = {}       # reason -> count (mirror of the
        #                               manager's repair_replan_total)

    # --- ranking ------------------------------------------------------------

    def rank_pieces(self, pieces: Sequence[_Piece]) -> List[_Piece]:
        """Fetch order: data members before parity (parity only fills
        the gap left by dead members), each band ordered by the piece's
        BEST holder under RpcHelper.peer_rank — the (breaker,
        fail-slow, zone, pressure-bucket, RTT) survivor key: self <
        local-zone < cross-zone < FAIL-SLOW < breaker-open, and within
        a zone band lightly-loaded holders (gossiped governor pressure,
        System.peer_pressure) before pressured ones — the load-aware
        survivor scheduling of the degraded-reads paper.  Pieces whose
        every holder is breaker-open rank dead-last — even behind
        healthy parity, since their fetches can only burn timeouts that
        healthy pieces avoid."""
        rpc = self.manager.system.rpc

        def key(p: _Piece):
            nodes = self.manager.replication.read_nodes(Hash(p.hash))
            best = min((rpc.peer_rank(n) for n in nodes),
                       default=(9, 9, 0.0))
            dead = 1 if best[0] >= 4 else 0
            kind = 0 if p.kind == "data" else 1
            return (dead, kind, best, p.index)

        return sorted(pieces, key=key)

    def _holder_order(self, h: Hash) -> List:
        rpc = self.manager.system.rpc
        return rpc.request_order(self.manager.replication.read_nodes(h))

    def _hedge_after(self) -> float:
        if self.hedge_delay is not None:
            return self.hedge_delay
        rpc = self.manager.system.rpc
        d = None
        if rpc.m_duration is not None:
            d = rpc.m_duration.quantile(
                rpc.tunables.hedge_quantile,
                min_count=rpc.tunables.hedge_min_samples,
                endpoint=self.manager.endpoint.path,
            )
        return max(d, 0.05) if d is not None else 1.0

    # --- PPR capability gate ------------------------------------------------

    def _peer_ppr_ok(self, node) -> bool:
        if bytes(node) in self._no_ppr:
            return False
        ver = parse_version(self.manager.system.peer_version(node))
        if ver is not None and ver < PPR_MIN_VERSION:
            return False
        return True  # unknown version: try it, demote on "unknown rpc"

    def _peer_tree_ok(self, node) -> bool:
        """May `node` take a tree role (root / interior / leaf) in a
        `ppr_tree` plan?  A PPR-capable but pre-tree peer demotes that
        edge to flat PPR; unknown versions are tried optimistically and
        demoted on the first "unknown block rpc" answer."""
        if bytes(node) in self._no_tree or not self._peer_ppr_ok(node):
            return False
        ver = parse_version(self.manager.system.peer_version(node))
        if ver is not None and ver < PPR_TREE_MIN_VERSION:
            return False
        return True

    @staticmethod
    def _is_unknown_rpc(e: BaseException) -> bool:
        return isinstance(e, GarageError) and "unknown block rpc" in str(e)

    def _note_replan(self, reason: str) -> None:
        """One re-plan event: a survivor died mid-plan (survivor_died),
        a tree subtree was lost and its pieces re-fetched flat
        (mid_tree), a mixed-version holder's edge was demoted at plan
        time (version_demote), or a whole tree was abandoned for the
        flat planner (tree_abort)."""
        self.replans[reason] = self.replans.get(reason, 0) + 1
        note = getattr(self.manager, "note_repair_replan", None)
        if note is not None:
            note(reason)

    # --- decode coefficients ------------------------------------------------

    def _decode_row(self, k: int, m: int, present: tuple,
                    target: int) -> np.ndarray:
        """Coefficients c_j with data[target] = Σ_j c_j ⊗
        shards[present[j]].  Shares the codec's cached decode schedule
        (ops/cpu_codec.py) when the live geometry matches the entry's;
        a small local cache covers old-geometry entries."""
        key = (k, m, present, target)
        row = self._row_cache.get(key)
        if row is not None:
            return row
        codec = self.manager.codec
        if (getattr(codec, "decode_matrix", None) is not None
                and codec.params.rs_data == k
                and codec.params.rs_parity == m):
            row = codec.decode_matrix(list(present), rows=[target])[0]
        else:
            row = gf256.rs_decode_row(k, m, list(present), target)
        if len(self._row_cache) >= 512:
            self._row_cache.clear()
        self._row_cache[key] = row
        return row

    # --- fetch primitives ---------------------------------------------------

    async def _read_local(self, piece: _Piece) -> Optional[bytes]:
        """This node's own verified copy of a piece (unpacked if parity);
        zero wire bytes."""
        mgr = self.manager
        h = Hash(piece.hash)
        if not mgr.is_block_present(h):
            return None
        try:
            block = await mgr.read_block(h)
            raw = await asyncio.to_thread(block.decompressed)
        except Exception:  # noqa: BLE001 — any local failure → fetch remote
            return None
        # read_block already content-verified a PLAIN block; only a
        # compressed copy (frame-checksum-verified) needs the content
        # hash re-checked over the decompressed bytes — off-loop and
        # feeder-batched like every other planner verify
        if block.compressed and not await self._verify(raw, piece.hash):
            return None
        if piece.kind == "parity":
            from .parity import unpack_parity_shard

            return unpack_parity_shard(raw)
        return raw

    async def _fetch_whole(self, piece: _Piece) -> Tuple[bytes, int, int]:
        """One piece's verified shard bytes: local copy → ranked ring
        holders → the O(cluster) sweep as the completeness backstop.
        Returns (shard, c_applied=RAW, wire_bytes_moved)."""
        payload, moved = await self._fetch_whole_inner(piece)
        return payload, RAW, moved

    async def _fetch_whole_inner(self, piece: _Piece) -> Tuple[bytes, int]:
        # Deliberately NOT rpc_get_block_streaming: that path serves
        # whole blocks to clients (decompressed iteration, bytes_read
        # accounting, heal/decode fallbacks that would recurse into
        # reconstruction); a piece fetch wants raw wire frames, its own
        # byte accounting, and the parity unpack.  The resilience
        # primitives (peer_allows fast-fail, adaptive timeout,
        # note_result) are shared.
        from .block import DataBlock, DataBlockHeader

        mgr = self.manager
        rpc = mgr.system.rpc
        h = Hash(piece.hash)
        local = await self._read_local(piece)
        if local is not None:
            return local, 0
        our_id = mgr.system.id
        for node in self._holder_order(h):
            if bytes(node) == bytes(our_id):
                continue  # local copy already tried
            if not rpc.peer_allows(node):
                # breaker open: fast-fail to the next holder — the
                # sweep backstop below still tries everyone, so a stale
                # verdict can delay but never hide the only copy
                continue
            try:
                timeout = rpc.timeout_for(node, mgr.block_rpc_timeout)
                resp, stream = await mgr.endpoint.call_streaming(
                    node, {"t": "get_block", "h": piece.hash},
                    prio=PRIO_NORMAL, timeout=timeout,
                )
                if resp.get("err") or stream is None:
                    rpc.note_result(node, None)  # live handler: path works
                    continue
                hdr = DataBlockHeader.unpack(resp["hdr"])
                try:
                    body = await asyncio.wait_for(
                        stream.read_all(), mgr.block_rpc_timeout)
                except BaseException:
                    await stream.aclose()  # stop the sender's pump
                    raise
                rpc.note_result(node, None)
                raw = await asyncio.to_thread(
                    DataBlock(body, hdr.compressed).decompressed)
                if not await self._verify(raw, piece.hash):
                    continue
                if piece.kind == "parity":
                    from .parity import unpack_parity_shard

                    shard = unpack_parity_shard(raw)
                    if shard is None:
                        continue
                    return shard, len(body)
                return raw, len(body)
            except asyncio.CancelledError:
                rpc.note_result(node, asyncio.CancelledError())
                raise
            except Exception as e:  # noqa: BLE001 — next holder
                rpc.note_result(node, e)
                continue
        # completeness backstop: after a layout change the only copy may
        # sit on a node the ring no longer lists (sweep_get_block's
        # raison d'être); ring holders were already tried above
        raw = await mgr.sweep_get_block(h, try_ring=False)
        if raw is None:
            raise GarageError(f"piece {piece.hash.hex()[:12]} unavailable")
        if piece.kind == "parity":
            from .parity import unpack_parity_shard

            shard = unpack_parity_shard(raw)
            if shard is None:
                raise GarageError(
                    f"piece {piece.hash.hex()[:12]} not a parity shard")
            return shard, len(raw)
        return raw, len(raw)

    async def _fetch_ppr(self, piece: _Piece, coeff: int,
                         want: int) -> Tuple[bytes, int, int]:
        """coeff ⊗ shard truncated to `want` bytes, computed survivor-
        side when a PPR-capable holder has the piece; local copies scale
        locally (zero wire bytes) and holder exhaustion falls back to a
        whole-shard fetch.  Returns (payload, c_applied, wire_bytes)."""
        mgr = self.manager
        rpc = mgr.system.rpc
        h = Hash(piece.hash)
        local = await self._read_local(piece)
        if local is not None:
            return local, RAW, 0
        msg = {"t": "ppr", "h": piece.hash, "coeff": int(coeff),
               "len": int(want)}
        if piece.kind == "parity":
            msg["parity"] = True
        our_id = mgr.system.id
        for node in self._holder_order(h):
            if bytes(node) == bytes(our_id):
                continue
            if not self._peer_ppr_ok(node) or not rpc.peer_allows(node):
                continue  # old version / open breaker: next holder
            try:
                timeout = rpc.timeout_for(node, mgr.block_rpc_timeout)
                resp, stream = await mgr.endpoint.call_streaming(
                    node, msg, prio=PRIO_NORMAL, timeout=timeout)
                if resp.get("err") or stream is None:
                    # err-less but body-less answers are a MISS like the
                    # whole-shard path treats them — XOR-accumulating a
                    # phantom zero partial would corrupt the row and
                    # waste the whole planned fetch on the hash check
                    rpc.note_result(node, None)
                    continue
                try:
                    body = await asyncio.wait_for(
                        stream.read_all(), mgr.block_rpc_timeout)
                except BaseException:
                    await stream.aclose()
                    raise
                rpc.note_result(node, None)
                if not body:
                    continue  # empty partial: same phantom-zero hazard
                return body, int(coeff), len(body)
            except asyncio.CancelledError:
                rpc.note_result(node, asyncio.CancelledError())
                raise
            except Exception as e:  # noqa: BLE001
                if self._is_unknown_rpc(e):
                    # peer predates the endpoint: remember, and never
                    # count a version miss against its breaker
                    self._no_ppr.add(bytes(node))
                    rpc.note_result(node, None)
                else:
                    rpc.note_result(node, e)
                continue
        # no PPR-capable holder answered — whole-shard for this piece
        self.ppr_fallbacks += 1
        mgr.note_repair_ppr_fallback()
        payload, moved = await self._fetch_whole_inner(piece)
        return payload, RAW, moved

    async def _verify(self, raw: bytes, want_hash: bytes) -> bool:
        """Content-hash check for a fetched whole piece, batched through
        the codec feeder when one is armed so a repair storm's many
        concurrent piece verifies coalesce into one ragged hash pass."""
        mgr = self.manager
        feeder = getattr(mgr, "feeder", None)
        if feeder is not None:
            got = (await feeder.hash_async([raw]))[0]
        else:
            got = await asyncio.to_thread(block_hash, raw, mgr.hash_algo)
        return bytes(got) == bytes(want_hash)

    async def _hash_many(self, raws: Sequence[bytes]) -> List[bytes]:
        """Content hashes of several buffers in ONE feeder ragged pass
        (chain repair verifies all m′ rebuilt rows together)."""
        mgr = self.manager
        feeder = getattr(mgr, "feeder", None)
        if feeder is not None:
            return [bytes(x) for x in await feeder.hash_async(list(raws))]
        return [bytes(await asyncio.to_thread(block_hash, r, mgr.hash_algo))
                for r in raws]

    # --- the planned reconstruction ----------------------------------------

    async def reconstruct(self, h: Hash, ent) -> Optional[bytes]:
        """Rebuild the codeword row whose content hash is `h` with a
        planned, exactly-k fetch.  The row index comes from locating `h`
        in `ent.members` (index entries fetched for a sibling carry that
        sibling's `member_index`, not ours).  Returns verified plain
        bytes or None (callers fall back to the legacy gather)."""
        target = int(ent.member_index)
        hb = bytes(h)
        for i, mh in enumerate(ent.members):
            if bytes(mh) == hb:
                target = i
                break
        out = await self.reconstruct_group(ent, [target])
        return out.get(target)

    async def reconstruct_group(self, ent, targets: Sequence[int],
                                rotate: int = 0) -> Dict[int, Optional[bytes]]:
        """Chain repair: rebuild ALL of `targets` (lost member indexes of
        ONE codeword) from a single set of k fetched / tree-aggregated
        partials — the fetch is shared and coefficients rescale locally
        per target row, so m′ lost rows cost ≤ k fetches, not m′·k.
        `rotate` rotates which survivor roots the aggregation tree (the
        rebuild scheduler spreads tree roots across a codeword group's
        shared survivor set).  Returns {member_index: verified bytes or
        None}; callers fall back per-target."""
        k, m = int(ent.k), int(ent.m)
        targets = sorted({int(t) for t in targets})
        out: Dict[int, Optional[bytes]] = {t: None for t in targets}
        lengths = list(ent.lengths)
        if (not targets or not lengths or k <= 0
                or any(t >= len(ent.members) for t in targets)):
            return out
        maxlen = max(lengths)
        wants = [int(lengths[t]) for t in targets]
        if maxlen == 0 or any(w == 0 for w in wants):
            return out
        tset = set(targets)
        zeros = list(range(len(ent.members), k))
        cands = [
            _Piece(i, ent.members[i], "data")
            for i in range(len(ent.members)) if i not in tset
        ] + [
            _Piece(k + j, ph, "parity")
            for j, ph in enumerate(ent.parity_hashes)
        ]
        needed = k - len(zeros)
        if len(cands) < needed:
            return out
        self.plans += 1
        mgr = self.manager
        ranked = self.rank_pieces(cands)
        rows: Optional[Dict[int, bytes]] = None
        if self.use_ppr and self.use_tree and needed >= 2:
            try:
                rows = await self._run_tree(ranked, zeros, k, m, targets,
                                            wants, needed, rotate)
            except Exception:  # noqa: BLE001 — tree failure = flat
                logger.exception("tree-aggregated repair failed, flat "
                                 "fallback")
                self._note_replan("tree_abort")
                rows = None
        if rows is None:
            try:
                if len(targets) == 1:
                    one = await self._run(ranked, zeros, k, m, targets[0],
                                          wants[0], maxlen, needed)
                    rows = None if one is None else {targets[0]: one}
                else:
                    rows = await self._run_chain(ranked, zeros, k, m,
                                                 targets, wants, maxlen,
                                                 needed)
            except Exception:  # noqa: BLE001 — planner failure = fallback
                logger.exception("planned reconstruction of %s failed",
                                 bytes(ent.members[targets[0]]).hex()[:16])
                return out
        if rows is None:
            return out
        # one feeder-batched ragged hash pass verifies every target row
        bufs = [rows.get(t) for t in targets]
        got = await self._hash_many([b or b"" for b in bufs])
        for t, buf, gh in zip(targets, bufs, got):
            if buf is not None and bytes(gh) == bytes(ent.members[t]):
                out[t] = buf
                mgr.note_repair_done(len(buf))
            elif buf is not None:
                logger.warning("planned reconstruction of row %d (%s) "
                               "produced wrong hash", t,
                               bytes(ent.members[t]).hex()[:16])
        return out

    # --- tree-aggregated PPR ------------------------------------------------

    async def _run_tree(self, ranked: List[_Piece], zeros: List[int],
                        k: int, m: int, targets: List[int],
                        wants: List[int], needed: int,
                        rotate: int = 0) -> Optional[Dict[int, bytes]]:
        """One `ppr_tree` root request serves every remote piece of the
        plan: interior survivors XOR-accumulate their children before
        forwarding, so coordinator ingress is one row-set regardless of
        k.  Local pieces scale locally (zero wire); holders that are
        not tree-capable get their edge demoted to flat PPR; a lost
        subtree's pieces are re-fetched flat with the NEUTRAL
        coefficient (same survivor set → the aggregate stays valid).
        Returns {target: row bytes} or None → flat planner."""
        mgr = self.manager
        rpc = mgr.system.rpc
        our_id = bytes(mgr.system.id)
        chosen = ranked[:needed]
        present = tuple(sorted([p.index for p in chosen] + zeros))
        rows = [self._decode_row(k, m, present, t) for t in targets]
        pos = {idx: j for j, idx in enumerate(present)}
        coeff = {p.index: [int(r[pos[p.index]]) for r in rows]
                 for p in chosen}
        locals_: List[_Piece] = []
        flat: List[_Piece] = []
        by_node: Dict[bytes, list] = {}
        node_of: Dict[bytes, object] = {}
        for p in chosen:
            if not any(coeff[p.index]):
                continue  # zero coefficient for every target row
            if mgr.is_block_present(Hash(p.hash)):
                locals_.append(p)
                continue
            best = None
            for n in self._holder_order(Hash(p.hash)):
                if bytes(n) == our_id:
                    continue
                if rpc.peer_allows(n):
                    best = n
                    break
            if best is None:
                flat.append(p)  # no live holder: flat path sweeps
            elif self._peer_tree_ok(best):
                by_node.setdefault(bytes(best), []).append(p)
                node_of[bytes(best)] = best
            else:
                # mixed-version holder: this edge serves flat PPR
                self.tree_demotions += 1
                self._note_replan("version_demote")
                flat.append(p)
        if sum(len(v) for v in by_node.values()) < 2:
            return None  # a tree of one remote partial IS flat PPR
        nodes = sorted(by_node, key=lambda nb: rpc.peer_rank(node_of[nb]))
        if rotate:
            r = rotate % len(nodes)
            nodes = nodes[r:] + nodes[:r]
        fanout = self.tree_fanout

        def build(i: int) -> dict:
            sub = {"p": [[p.hash, 1 if p.kind == "parity" else 0,
                          coeff[p.index], p.index]
                         for p in by_node[nodes[i]]],
                   "c": []}
            for j in range(fanout * i + 1,
                           min(fanout * i + 1 + fanout, len(nodes))):
                sub["c"].append([nodes[j], build(j)])
            return sub

        plan = build(0)
        depth, covered, span = 1, 1, 1
        while covered < len(nodes):
            span *= fanout
            covered += span
            depth += 1
        self.tree_plans += 1
        note_tree = getattr(mgr, "note_repair_tree", None)
        if note_tree is not None:
            note_tree(depth)
        msg = {"t": "ppr_tree", "plan": plan,
               "want": [int(w) for w in wants]}
        try:
            got, _miss, body = await self._call_tree(
                node_of[nodes[0]], msg, depth)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — root died: flat re-plan
            logger.debug("ppr_tree root %s failed: %s",
                         nodes[0].hex()[:8], e)
            self._note_replan("tree_abort")
            return None
        if len(body) != sum(wants):
            self._note_replan("tree_abort")
            return None
        accs = [np.zeros(w, dtype=np.uint8) for w in wants]
        off = 0
        for a, w in zip(accs, wants):
            if w:
                a ^= np.frombuffer(body[off:off + w], dtype=np.uint8)
            off += w
        # coordinator ingress: ONE aggregated stream for the whole tree
        mgr.note_repair_fetch("tree", len(body))
        # our own diff of planned-vs-contributed beats the reported miss
        # list (a buggy/partial answer must not double-XOR a piece)
        got_set = {int(i) for i in got}
        planned = [p for nb in nodes for p in by_node[nb]]
        missing = [p for p in planned if p.index not in got_set]
        for _ in missing:
            # subtree re-plan, NOT codeword abort: the missing pieces
            # are re-fetched below under the SAME survivor set, so the
            # aggregate's coefficients stay exact
            self._note_replan("mid_tree")
        scale = getattr(mgr.codec, "gf_scale", gf256.gf_scale_bytes)
        maxwant = max(wants)

        def xor_raw(payload: bytes, cs: List[int]) -> None:
            for a, w, c in zip(accs, wants, cs):
                if not c:
                    continue
                data = scale(c, payload, w)
                if data:
                    arr = np.frombuffer(data, dtype=np.uint8)
                    a[:len(arr)] ^= arr

        for p in locals_:
            raw = await self._read_local(p)
            if raw is None:
                missing.append(p)  # local copy vanished mid-plan
                continue
            xor_raw(raw, coeff[p.index])

        async def fetch_flat(p: _Piece):
            # NEUTRAL coefficient: a raw sub-shard the coordinator
            # rescales per target row — chain repair shares this one
            # fetch across all m′ targets
            payload, c_app, nbytes = await self._fetch_ppr(p, 1, maxwant)
            if nbytes:
                mgr.note_repair_fetch(
                    "shard" if c_app == RAW else "ppr", nbytes)
            return p, payload

        flat_all = flat + missing
        if flat_all:
            try:
                fetched = await asyncio.gather(
                    *[fetch_flat(p) for p in flat_all])
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                # a piece with NO live copy anywhere: the survivor set
                # must change, which invalidates the aggregate — only
                # the flat planner can re-plan from scratch
                logger.debug("tree completion fetch failed: %s", e)
                self._note_replan("tree_abort")
                return None
            for p, payload in fetched:
                xor_raw(payload, coeff[p.index])
        return {t: a.tobytes() for t, a in zip(targets, accs)}

    async def _call_tree(self, node, msg: dict,
                         depth: int) -> Tuple[list, list, bytes]:
        """Send the recursive plan to the tree root and read back ONE
        aggregated stream + the contributed/missing piece lists."""
        mgr = self.manager
        rpc = mgr.system.rpc
        try:
            timeout = rpc.timeout_for(node, mgr.block_rpc_timeout) \
                * max(1, depth)
            resp, stream = await mgr.endpoint.call_streaming(
                node, msg, prio=PRIO_NORMAL, timeout=timeout)
            if resp.get("err") or stream is None:
                rpc.note_result(node, None)
                raise GarageError(resp.get("err") or "empty ppr_tree answer")
            try:
                body = await asyncio.wait_for(
                    stream.read_all(), mgr.block_rpc_timeout * max(1, depth))
            except BaseException:
                await stream.aclose()
                raise
            rpc.note_result(node, None)
            return (list(resp.get("got") or []),
                    list(resp.get("miss") or []), body)
        except asyncio.CancelledError:
            rpc.note_result(node, asyncio.CancelledError())
            raise
        except Exception as e:  # noqa: BLE001
            if self._is_unknown_rpc(e):
                # peer predates ppr_tree: demote its edges from now on
                self._no_tree.add(bytes(node))
                rpc.note_result(node, None)
            else:
                rpc.note_result(node, e)
            raise

    # --- chain repair, flat transport ---------------------------------------

    async def _run_chain(self, ranked: List[_Piece], zeros: List[int],
                         k: int, m: int, targets: List[int],
                         wants: List[int], maxlen: int,
                         needed: int) -> Optional[Dict[int, bytes]]:
        """Multiple lost rows, ONE shared fetch set: PPR mode pulls
        neutral-coefficient raw sub-shards (truncated to the longest
        target row) and rescales locally per target; shard mode pulls
        whole pieces and decodes every target row in one feeder pass.
        Failed fetches re-plan with the next-ranked replacement."""
        mgr = self.manager
        mode = "ppr" if self.use_ppr else "shard"
        pieces: Dict[int, _Piece] = {p.index: p for p in ranked}
        order = [p.index for p in ranked]
        failed: set = set()
        results: Dict[int, Tuple[Optional[bytes], int]] = {}
        moved: Dict[int, int] = {}
        active: Dict[asyncio.Task, int] = {}
        maxwant = max(wants)
        final: List[int] = []
        try:
            while True:
                w = [i for i in order if i not in failed][:needed]
                if len(w) < needed:
                    return None  # candidates exhausted
                sat = [i for i in w if i in results]
                if len(sat) >= needed:
                    final = sat[:needed]
                    break
                limit = needed
                gov = getattr(mgr, "governor", None)
                if gov is not None:
                    limit = max(1, int(needed * gov.ratio() + 0.9999))
                inflight = set(active.values())
                for i in w:
                    if len(active) >= limit:
                        break
                    if i not in results and i not in inflight:
                        p = pieces[i]
                        if mode == "ppr":
                            t = asyncio.ensure_future(
                                self._fetch_ppr(p, 1, maxwant))
                        else:
                            t = asyncio.ensure_future(self._fetch_whole(p))
                        active[t] = i
                        inflight.add(i)
                if not active:
                    continue
                done, _ = await asyncio.wait(
                    active.keys(), return_when=asyncio.FIRST_COMPLETED)
                for tk in done:
                    i = active.pop(tk)
                    try:
                        payload, c_app, nbytes = tk.result()
                    except asyncio.CancelledError:
                        raise
                    except Exception as e:  # noqa: BLE001
                        logger.debug("chain piece %s fetch failed: %s",
                                     pieces[i], e)
                        failed.add(i)
                        self._note_replan("survivor_died")
                        continue
                    results[i] = (payload, c_app)
                    moved[i] = nbytes
                    fmode = "shard" if (mode == "shard" or c_app == RAW) \
                        else "ppr"
                    if nbytes:
                        mgr.note_repair_fetch(fmode, nbytes)
        finally:
            for tk in list(active):
                tk.cancel()
            if active:
                await asyncio.gather(*active, return_exceptions=True)
        for i in results:
            if i not in final and moved.get(i):
                mgr.note_repair_overfetch(moved[i])
        if mode == "ppr":
            return {t: self._finish_ppr(final, zeros, k, m, t, wt, results)
                    for t, wt in zip(targets, wants)}
        rows = await self._finish_shard(final, zeros, k, m, targets,
                                        wants, maxlen, results)
        return None if rows is None else dict(zip(targets, rows))

    async def _run(self, ranked: List[_Piece], zeros: List[int], k: int,
                   m: int, target: int, want: int, maxlen: int,
                   needed: int) -> Optional[bytes]:
        mgr = self.manager
        mode = "ppr" if self.use_ppr else "shard"
        pieces: Dict[int, _Piece] = {p.index: p for p in ranked}
        order = [p.index for p in ranked]
        failed: set = set()
        trivial: set = set()                     # zero-coeff, nothing fetched
        no_trivial: set = set()  # rejected at finalize: must really fetch
        results: Dict[int, Tuple[Optional[bytes], int]] = {}
        moved: Dict[int, int] = {}
        active: Dict[asyncio.Task, int] = {}
        hedge = self._hedge_after()

        def working_set() -> List[int]:
            return [i for i in order if i not in failed][:needed]

        def coeffs(w: List[int]) -> Dict[int, int]:
            present = tuple(sorted(w + zeros))
            row = self._decode_row(k, m, present, target)
            return {idx: int(row[j]) for j, idx in enumerate(present)}

        def launch(i: int, cmap: Dict[int, int]) -> None:
            p = pieces[i]
            if mode == "ppr":
                c = cmap.get(i)
                if c == 0 and i not in no_trivial:
                    # zero coefficient under the current set: the piece
                    # contributes nothing — trivially satisfied, revisited
                    # if a replacement changes the set
                    results[i] = (None, 0)
                    trivial.add(i)
                    return
                # a piece finalize rejected (zero here, nonzero in the
                # final set) fetches with the neutral coefficient 1 — a
                # raw sub-shard the finish pass rescales — so the
                # trivial/required oscillation can never loop
                t = asyncio.ensure_future(
                    self._fetch_ppr(p, c or 1, want))
            else:
                t = asyncio.ensure_future(self._fetch_whole(p))
            active[t] = i

        try:
            while True:
                w = working_set()
                if len(w) < needed:
                    return None  # candidates exhausted
                cmap = coeffs(w) if mode == "ppr" else {}
                if mode == "ppr":
                    # a replacement may have made a previously-zero
                    # coefficient live: the piece must really be fetched
                    for i in list(trivial):
                        if cmap.get(i, 0) != 0:
                            trivial.discard(i)
                            results.pop(i, None)
                sat = [i for i in order
                       if i in results and i not in failed]
                if len(sat) >= needed:
                    final = sat[:needed]
                    if mode == "ppr":
                        present = tuple(sorted(final + zeros))
                        row = self._decode_row(k, m, present, target)
                        cfin = {idx: int(row[j])
                                for j, idx in enumerate(present)}
                        bad = [i for i in final
                               if results[i][0] is None and cfin[i] != 0]
                        if bad:
                            no_trivial.update(bad)
                            for i in bad:
                                trivial.discard(i)
                                results.pop(i, None)
                            continue
                    break
                inflight = set(active.values())
                # dynamic background yielding: under foreground pressure
                # the load governor shrinks how many of the exact-k
                # fetches run CONCURRENTLY (never below 1 — repairs still
                # finish, just serialized), so a repair storm's fan-out
                # cedes wire/CPU to client traffic and widens back out
                # when pressure clears
                limit = needed
                gov = getattr(mgr, "governor", None)
                if gov is not None:
                    limit = max(1, int(needed * gov.ratio() + 0.9999))
                for i in w:
                    if len(active) >= limit:
                        break
                    if i not in results and i not in inflight:
                        launch(i, cmap)
                        inflight.add(i)
                if not active:
                    continue  # launches were all trivial: re-evaluate
                can_hedge = any(
                    i not in failed and i not in inflight
                    and i not in results
                    for i in order if i not in set(w))
                done, _ = await asyncio.wait(
                    active.keys(),
                    return_when=asyncio.FIRST_COMPLETED,
                    timeout=hedge if can_hedge else None,
                )
                if not done:
                    # stalled wave: hedge the next-ranked replacement —
                    # whichever answers first forms the final set, the
                    # loser's bytes land in the overfetch counter
                    nxt = next(
                        (i for i in order
                         if i not in failed and i not in inflight
                         and i not in results and i not in set(w)), None)
                    if nxt is None:
                        continue
                    self.hedges += 1
                    mgr.note_repair_hedge()
                    hyp = (w[:-1] + [nxt]) if w else [nxt]
                    launch(nxt, coeffs(hyp) if mode == "ppr" else {})
                    continue
                for t in done:
                    i = active.pop(t)
                    try:
                        payload, c_app, nbytes = t.result()
                    except asyncio.CancelledError:
                        raise
                    except Exception as e:  # noqa: BLE001
                        logger.debug("piece %s fetch failed: %s",
                                     pieces[i], e)
                        failed.add(i)
                        # survivor died mid-PPR (post-ack, pre-partial):
                        # re-plan with the next-ranked replacement and
                        # rescale — never a codeword abort
                        self._note_replan("survivor_died")
                        continue
                    results[i] = (payload, c_app)
                    moved[i] = nbytes
                    fmode = "shard" if (mode == "shard" or c_app == RAW) \
                        else "ppr"
                    if nbytes:
                        mgr.note_repair_fetch(fmode, nbytes)
        finally:
            for t in list(active):
                t.cancel()
            if active:
                await asyncio.gather(*active, return_exceptions=True)

        # satisfied-but-unused pieces (hedge losers that completed) are
        # pure overfetch
        for i in results:
            if i not in final and moved.get(i):
                mgr.note_repair_overfetch(moved[i])

        if mode == "ppr":
            return self._finish_ppr(final, zeros, k, m, target, want,
                                    results)
        rows = await self._finish_shard(final, zeros, k, m, [target],
                                        [want], maxlen, results)
        return None if rows is None else rows[0]

    def _finish_ppr(self, final: List[int], zeros: List[int], k: int,
                    m: int, target: int, want: int,
                    results: Dict[int, Tuple[Optional[bytes], int]]
                    ) -> bytes:
        """XOR-accumulate the partial sums, rescaling any partial whose
        applied coefficient differs from the final decode row (set
        changes, whole-shard fallbacks) via c_new ⊗ c_old⁻¹."""
        mgr = self.manager
        present = tuple(sorted(final + zeros))
        row = self._decode_row(k, m, present, target)
        cfin = {idx: int(row[j]) for j, idx in enumerate(present)}
        acc = np.zeros(want, dtype=np.uint8)
        scale = getattr(mgr.codec, "gf_scale", gf256.gf_scale_bytes)
        for i in final:
            payload, c_app = results[i]
            c_need = cfin[i]
            if c_need == 0 or payload is None:
                continue
            if c_app == RAW:
                data = scale(c_need, payload, want)
            elif c_app == c_need:
                data = payload[:want]
            else:
                data = scale(gf256.gf_mul(c_need, gf256.gf_inv(c_app)),
                             payload, want)
            if data:
                arr = np.frombuffer(data, dtype=np.uint8)
                acc[:len(arr)] ^= arr
        return acc.tobytes()

    async def _finish_shard(self, final: List[int], zeros: List[int],
                            k: int, m: int, targets: List[int],
                            wants: List[int], maxlen: int,
                            results: Dict[int, Tuple[Optional[bytes], int]]
                            ) -> Optional[List[bytes]]:
        """Whole-shard decode of exactly the k chosen pieces — batched
        through the manager's codec feeder when the entry's geometry
        matches the live codec (a repair storm's concurrent decodes
        share one cached RS schedule and one ragged dispatch).  Chain
        repair passes ALL m′ target rows through one decode submission,
        riding the feeder's background class so storm decodes coalesce
        behind foreground work."""
        mgr = self.manager
        present = sorted(final + zeros)
        zset = set(zeros)
        arrs = []
        for idx in present:
            a = np.zeros(maxlen, dtype=np.uint8)
            if idx not in zset:
                payload = results[idx][0] or b""
                b = payload[:maxlen]
                a[:len(b)] = np.frombuffer(b, dtype=np.uint8)
            arrs.append(a)
        shards = np.stack(arrs)[None, :, :]
        feeder = getattr(mgr, "feeder", None)
        live = mgr.codec.params
        if live.rs_data == k and live.rs_parity == m:
            if feeder is not None:
                out = await feeder.decode_async(shards, present,
                                                list(targets), cls="bg")
            else:
                out = await asyncio.to_thread(
                    mgr.codec.rs_reconstruct, shards, present,
                    list(targets))
        else:
            # the codeword predates a codec config change: its geometry
            # is not the live codec's (counted, see BlockManager)
            from ..ops.codec import CodecParams
            from ..ops.cpu_codec import CpuCodec

            mgr.geometry_cpu_decodes += 1
            codec = CpuCodec(CodecParams(rs_data=k, rs_parity=m))
            out = await asyncio.to_thread(
                codec.rs_reconstruct, shards, present, list(targets))
        return [out[0, j].tobytes()[:w] for j, w in enumerate(wants)]
