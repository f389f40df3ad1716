"""BlockCodec — the batch device-op interface of the block layer.

This is the seam identified in SURVEY.md §2.5 (ref src/block/block.rs:10-115
`DataBlock`): verify/hash/compress become *batchable* operations so the
scrub/resync workers (ref block/repair.rs:438-490, block/resync.rs:361-471)
can stream thousands of blocks per step through one device dispatch instead
of hashing one block at a time.

Semantics contract (both backends must agree bit-for-bit):
  - batch_hash(blocks)   == [hash_algo(b) for b in blocks]
  - batch_verify(b, h)   == elementwise batch_hash(b) == h
  - rs_encode(data)      : (B, k, S) uint8 → (B, m, S) parity, systematic
                           Cauchy-RS over GF(2^8)/0x11D (gf256.py)
  - rs_reconstruct(shards, present): any k of the k+m shards → original data
  - compress/decompress  : zstd framing with content checksum, mirroring the
                           reference's `DataBlock::Compressed`
                           (ref block/block.rs:49-91): compress returns None
                           when compression does not shrink the block.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.data import Hash


@dataclasses.dataclass
class CodecParams:
    hash_algo: str = "blake2s"
    rs_data: int = 8          # k
    rs_parity: int = 4        # m
    compression_level: Optional[int] = 1
    batch_blocks: int = 256
    shard_mesh: int = 1       # devices to split codec batches over (cuda)
    # Work-stealing quantum (hybrid backend): 16 blocks = 2 RS codewords.
    # Measured on the 1-core host + metered TPU link: small groups keep the
    # CPU side's working set cache-resident (hash + GF encode reuse the
    # same bytes) — 64-block groups ran ~35% slower end-to-end — while
    # staying coarse enough that per-group device transfer overhead stays
    # negligible.
    hybrid_group_blocks: int = 16
    # Device in-flight MERGED SUBMISSIONS (hybrid backend): each may span
    # up to device_batch_blocks blocks (the feeder merges deque groups
    # into wide submissions), so window+1 bounds in-flight claim at
    # (window+1)×device_batch_blocks blocks of host staging + device HBM.
    hybrid_window: int = 1
    # Device submission width (blocks).  DECOUPLED from batch_blocks (the
    # host staging / scrub read-batch granularity): the device blake2s
    # kernel hashes one block per VPU lane, so its rate is a strong
    # function of lane count (measured v5e XLA scan: 0.18 / 1.5 / 3.8
    # GiB/s at 16 / 256 / 1024 lanes) — quoting or submitting at the
    # 256-block staging width left most of the chip idle.
    # 1024 lanes = 8 full (8, 128) vregs per state word, the Pallas
    # blake2s kernel's native tile.
    #
    # MEMORY IMPLICATION: with the hybrid backend,
    # up to (hybrid_window + 1) merged submissions are in flight at
    # once, each spanning up to device_batch_blocks blocks — so host
    # staging AND device HBM claim peak at
    #   (hybrid_window + 1) × device_batch_blocks × block_size
    # = 2 GiB at the defaults (window 1, 1024 blocks, 1 MiB blocks).
    # HybridCodec clamps the width at construction so this bound never
    # exceeds max_device_staging_mib (assuming the 1 MiB default
    # block_size; raise the cap when running bigger blocks on a box
    # with the RAM/HBM for it).
    device_batch_blocks: int = 1024
    # Upper bound (MiB) on the in-flight staging claim formula above;
    # the hybrid backend clamps device_batch_blocks to honor it and
    # logs a gate event when it does.
    max_device_staging_mib: int = 4096
    # The block size the staging clamp assumes (bytes).  BlockManager
    # plumbs the daemon's configured block_size through make(); bare
    # codecs default to the daemon default (1 MiB) — without this, a
    # 4 MiB-block config would stage 4× the promised bound unclamped.
    block_size: int = 1 << 20
    # CPU-side span width (blocks) while the device is actively claiming
    # work: the CPU merges this many deque groups per fused call (wide
    # native multi-buffer hash + pointer-gather RS amortize per-call
    # overhead) while staying fine-grained enough for work stealing to
    # balance.  When the device is gated or absent the CPU span is
    # UNBOUNDED — one fused call per contiguous segment, byte-identical
    # in cost to the plain CPU codec path.
    hybrid_cpu_span_blocks: int = 128
    # --- DeviceTransport (ops/transport.py): the zero-copy colocated
    # submission queue between the CodecFeeder and the device codec.
    # transport=False restores the legacy per-call serialize+copy
    # routing (hybrid ragged batches through the device codec's
    # bytes-level API).
    transport: bool = True
    # Staging slots (double buffering): batch N+1 stages and submits
    # while batch N computes.  The per-chunk staging bound is
    # max_device_staging_mib / transport_staging_slots, so all slots
    # together never exceed the configured budget.
    transport_staging_slots: int = 2
    # Background demotion slack (ms): a background (scrub/resync) batch
    # sorts behind foreground batches arriving within this window; the
    # slack stretches by 1/background_throttle_ratio when the load
    # governor reports foreground pressure.
    transport_bg_slack_ms: float = 50.0
    # Minimum measured host→device round-trip rate for the hybrid feeder
    # to claim any work.  Staging a submission costs ~3-5% of a CPU
    # verify for the same bytes, and a claimed-but-undelivered group is
    # redone by the tail hedge — so a link below ~5% of the CPU floor
    # (~1.4 GiB/s on the 1-core host) is strictly net-negative.  The
    # probe forces a real transfer round-trip, so it is immune to the
    # enqueue-time "completion" some remote backends report.
    hybrid_min_link_gibs: float = 0.07
    # --- DevicePool (ops/device_pool.py): bounded device-resident block
    # pages under the transport.  Budgeted SEPARATELY from
    # max_device_staging_mib: the staging budget bounds bytes in
    # FLIGHT (slot buffers, reclaimed at collect), the pool budget
    # bounds bytes at REST (pages that survive across scrub passes so
    # a warm re-scrub moves zero link bytes).  0 disables the pool —
    # staging then behaves byte-identically to the pre-pool transport.
    pool_mib: int = 256
    # Fixed device page size (KiB).  A block spans ceil(len/page)
    # pages with the tail page partially filled (ragged occupancy), so
    # smaller pages waste less tail but cost more per-page handles;
    # 256 KiB ≈ 4 pages per default 1 MiB block keeps handle counts
    # trivial while bounding tail waste at < 25% for blocks ≥ 768 KiB.
    pool_page_kib: int = 256
    # Next-range prefetch: the scrub worker hints the upcoming hash
    # range and the transport stages the non-resident blocks as
    # background-class work while the current batch computes (riding
    # the staging double buffer under the governor).
    pool_prefetch: bool = True


class IncrementalHash:
    """O(1) running hash state — the update/finalize form of the
    codec's one-shot digests (the portable O(1) autoregressive-caching
    shape from PAPERS.md applied to streamed writes).

    A streamed PUT or multipart part arrives window by window; hashing
    the assembled object at the end would re-read every byte.  This
    state absorbs each window as it passes (``update``) and emits the
    digest at the end (``digest``) — BIT-IDENTICAL to the one-shot
    hash of the concatenation, for ANY chunk boundaries, because
    BLAKE2 is a sequential sponge: state after absorbing b1+b2 equals
    state after absorbing b1 then b2.  tests/test_device_pool.py
    proves the identity against blake2sum / blake2s_sum.

    The state is O(1) in stream length (one BLAKE2 block buffer plus
    the chaining value), so a 1 GiB multipart costs one pass of
    hashing total and constant memory per in-flight part."""

    __slots__ = ("_h", "nbytes")

    def __init__(self, h):
        self._h = h
        self.nbytes = 0

    def update(self, buf) -> "IncrementalHash":
        self._h.update(buf)
        self.nbytes += len(buf)
        return self

    def digest(self) -> Hash:
        """Finalize (non-destructively: hashlib copies internally) —
        the digest of everything absorbed so far."""
        return Hash(self._h.digest())

    def hexdigest(self) -> str:
        return self._h.hexdigest()

    def copy(self) -> "IncrementalHash":
        c = IncrementalHash(self._h.copy())
        c.nbytes = self.nbytes
        return c


def hash_stream() -> IncrementalHash:
    """Incremental form of the block content hash (BLAKE2s-256,
    utils.data.blake2s_sum)."""
    import hashlib

    return IncrementalHash(hashlib.blake2s(digest_size=32))


def mhash_stream() -> IncrementalHash:
    """Incremental form of the metadata hash (BLAKE2b-256,
    utils.data.blake2sum) — the streamed-PUT/multipart content digest
    (api/s3/put.py, api/s3/multipart.py)."""
    import hashlib

    return IncrementalHash(hashlib.blake2b(digest_size=32))


class BlockCodec:
    """Batch codec interface; see module docstring for the contract.

    Every codec carries a CodecObserver (`self.obs`): the gate-decision
    event ring and per-stage accumulators are always on; Prometheus
    instruments are created when the daemon plumbs its MetricsRegistry
    in (make_codec(..., metrics=system.metrics, tracer=system.tracer))."""

    def __init__(self, params: CodecParams, metrics=None, tracer=None,
                 observer=None):
        self.params = params
        if observer is None:
            from .observer import CodecObserver

            observer = CodecObserver(metrics=metrics, tracer=tracer)
        self.obs = observer

    def info(self) -> dict:
        """Operator-facing snapshot (admin `codec info`): backend,
        effective params, byte accounting, and per-stage attribution.
        JSON-safe by construction."""
        return {
            "backend": type(self).__name__,
            "params": dataclasses.asdict(self.params),
            "bytes": dict(self.obs.bytes_total),
            "tpu_frac": round(self.obs.tpu_frac(), 4),
            "stages": self.obs.stage_stats(),
            "events_recorded": len(self.obs.events),
        }

    # --- hashing ---
    def batch_hash(self, blocks: Sequence[bytes]) -> List[Hash]:
        raise NotImplementedError

    def batch_verify(self, blocks: Sequence[bytes], hashes: Sequence[Hash]) -> np.ndarray:
        if len(blocks) != len(hashes):
            raise ValueError(f"{len(blocks)} blocks vs {len(hashes)} hashes")
        got = self.batch_hash(blocks)
        return np.array([bytes(a) == bytes(b) for a, b in zip(got, hashes)], dtype=bool)

    def verify_one(self, block: bytes, hash: Hash) -> bool:
        """Single-block verify — the get/read path (ref block.rs:66-78).
        Default routes through batch_verify so both backends share one
        semantics definition; device backends override to avoid paying a
        device roundtrip for one block (their batch paths still run on
        device — the scrub/resync producers batch)."""
        return bool(self.batch_verify([block], [hash])[0])

    def gf_scale(self, coeff: int, buf: bytes,
                 limit: Optional[int] = None) -> bytes:
        """coeff ⊗ buf over GF(2^8), truncated to `limit` — the
        partial-parallel-repair kernel (survivor-side partial product and
        coordinator-side rescale, block/repair_plan.py).  CpuCodec
        overrides with the native GFNI kernel when built."""
        from . import gf256

        return gf256.gf_scale_bytes(coeff, buf, limit)

    def rs_encode_blocks(self, blocks: Sequence[bytes]) -> np.ndarray:
        """RS parity straight from a list of block buffers:
        (ceil(B/k), m, maxlen), blocks zero-extended to maxlen, the batch
        zero-padded to a whole codeword (zero data → zero parity,
        GF-linear).  This default packs into one (B, k, S) array and calls
        rs_encode; CpuCodec overrides with a pointer-gather kernel that
        skips the packing pass."""
        k = self.params.rs_data
        assert k > 0 and blocks
        pad = (-len(blocks)) % k
        maxlen = max(len(b) for b in blocks)
        arr = np.zeros((len(blocks) + pad, maxlen), dtype=np.uint8)
        for i, b in enumerate(blocks):
            arr[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        return self.rs_encode(arr.reshape(-1, k, maxlen))

    # --- ragged batch entry points (the CodecFeeder's dispatch surface) ---
    #
    # Each takes MANY independent submissions (variable block counts and
    # sizes — "ragged" in the Ragged Paged Attention sense, PAPERS.md)
    # and runs them as ONE fused pass, returning per-submission results.
    # The base implementations amortize on the CPU backends (one
    # multi-buffer hash / one pointer-gather encode over the
    # concatenation, decode schedules shared per survivor pattern);
    # HybridCodec overrides to route whole batches to the device when
    # the gate is open.

    def ragged_side(self) -> str:
        """Which side a ragged batch dispatched NOW would run on —
        metric/event attribution for the feeder.  Backends that can
        route (hybrid) override."""
        return "cpu"

    def hash_ragged(self, groups: Sequence[Sequence[bytes]]
                    ) -> List[List[Hash]]:
        """Hash many submissions' blocks in one batch_hash pass:
        returns per-submission digest lists.  Coalescing across
        submissions is what engages the 8-way SIMD multi-buffer kernel
        for single-block foreground requests."""
        flat: List[bytes] = [b for g in groups for b in g]
        if not flat:
            return [[] for _ in groups]
        digs = self.batch_hash(flat)
        out: List[List[Hash]] = []
        i = 0
        for g in groups:
            out.append(digs[i:i + len(g)])
            i += len(g)
        return out

    def mhash_batch(self, bufs: Sequence[bytes]) -> List[Hash]:
        """Metadata (Merkle trie node/key) hashing: BLAKE2b-256, the
        table engine's `blake2sum` — bit-identical to the serial
        per-node path by construction.  Kept separate from batch_hash
        because block content hashes are BLAKE2s (the device kernel's
        algorithm) while the Merkle trie is BLAKE2b: mixing them in one
        device batch would either change the trie hash (a rolling-
        upgrade divergence: mixed-version replicas could never agree on
        node hashes for identical data) or silently fall back.  The
        hashing itself is hashlib per buffer; the feeder route buys one
        dispatch + one observability record per batch and is the single
        seam a future multi-buffer BLAKE2b kernel drops into."""
        from ..utils.data import blake2sum

        return [blake2sum(b) for b in bufs]

    def hash_stream(self) -> IncrementalHash:
        """Update/finalize form of the block content hash: absorb
        windows as they stream, finalize bit-identical to
        batch_hash([concatenation])[0]."""
        return hash_stream()

    def mhash_stream(self) -> IncrementalHash:
        """Update/finalize form of the metadata hash (blake2sum) — the
        streamed-write content digest carried per part by the S3 PUT
        and multipart handlers so a 1 GiB upload is hashed in one pass
        total, never by rehashing the assembled object."""
        return mhash_stream()

    def mhash_ragged(self, groups: Sequence[Sequence[bytes]]
                     ) -> List[List[Hash]]:
        """Per-submission metadata-hash lists in one mhash_batch pass
        (the Merkle updater/syncer's feeder entry point)."""
        flat: List[bytes] = [b for g in groups for b in g]
        if not flat:
            return [[] for _ in groups]
        digs = self.mhash_batch(flat)
        out: List[List[Hash]] = []
        i = 0
        for g in groups:
            out.append(digs[i:i + len(g)])
            i += len(g)
        return out

    def rs_encode_ragged(self, groups: Sequence[Sequence[bytes]]
                         ) -> List[np.ndarray]:
        """RS parity for many submissions in ONE pass over the
        concatenated buffers.  Each group is padded to whole codewords
        with empty blocks BEFORE concatenation so its parity rows stay
        self-contained (zero data → zero parity, GF-linear), then the
        single rs_encode_blocks call amortizes the kernel's per-call
        setup; per-group rows are split back out and column-trimmed to
        the group's own longest block.  Per-group result is identical to
        rs_encode_blocks(group)."""
        k = self.params.rs_data
        assert k > 0 and groups
        padded: List[bytes] = []
        rows_per: List[int] = []
        for g in groups:
            assert g, "empty encode submission"
            pad = (-len(g)) % k
            padded.extend(list(g))
            padded.extend([b""] * pad)
            rows_per.append((len(g) + pad) // k)
        parity = self.rs_encode_blocks(padded)
        out: List[np.ndarray] = []
        r = 0
        for g, nr in zip(groups, rows_per):
            ml = max(len(b) for b in g)
            out.append(np.ascontiguousarray(parity[r:r + nr, :, :ml]))
            r += nr
        return out

    def rs_reconstruct_ragged(self, items: Sequence[tuple]
                              ) -> List[np.ndarray]:
        """Many rs_reconstruct submissions, batched per RS SCHEDULE:
        items are (shards (B, p, S), present, rows|None) tuples;
        submissions sharing a survivor pattern (present, rows) decode
        through one matrix application (the schedule-caching idea of
        "Accelerating XOR-based Erasure Coding", PAPERS.md — a repair
        storm after a node loss repeats one loss pattern).  Shards are
        zero-padded to the key group's widest S (zero columns decode to
        zero columns, GF-linear) and results trimmed back."""
        out: List[Optional[np.ndarray]] = [None] * len(items)
        keyed: dict = {}
        for i, (shards, present, rows) in enumerate(items):
            key = (tuple(present[: self.params.rs_data]),
                   tuple(rows) if rows is not None else None,
                   int(shards.shape[1]))
            keyed.setdefault(key, []).append(i)
        for (pres, rows, p), idxs in keyed.items():
            if len(idxs) == 1:
                i = idxs[0]
                shards, present, rws = items[i]
                out[i] = self.rs_reconstruct(shards, present, rws)
                continue
            max_s = max(items[i][0].shape[-1] for i in idxs)
            total_b = sum(items[i][0].shape[0] for i in idxs)
            stacked = np.zeros((total_b, p, max_s), dtype=np.uint8)
            off = 0
            for i in idxs:
                sh = items[i][0]
                stacked[off:off + sh.shape[0], :, : sh.shape[-1]] = sh
                off += sh.shape[0]
            dec = self.rs_reconstruct(
                stacked, list(pres), list(rows) if rows is not None else None)
            off = 0
            for i in idxs:
                sh = items[i][0]
                out[i] = np.ascontiguousarray(
                    dec[off:off + sh.shape[0], :, : sh.shape[-1]])
                off += sh.shape[0]
        return out  # type: ignore[return-value]

    def scrub_ragged(self, items: Sequence[tuple]) -> List[tuple]:
        """Many scrub_encode_batch submissions (the CodecFeeder's `scrub`
        kind): items are (blocks, hashes, fetch_parity) tuples, result
        is per-item (ok, parity|None).  The base implementation runs
        them serially; HybridCodec routes the batch to one side, and a
        device-armed feeder bypasses this entirely through the
        DeviceTransport."""
        return [self.scrub_encode_batch(b, h, fp) for b, h, fp in items]

    def scrub_encode_batch(self, blocks: Sequence[bytes],
                           hashes: Sequence[Hash],
                           fetch_parity: bool = True):
        """Fused scrub step: verify + RS(k, m) parity per codeword of k
        consecutive blocks.  Returns (ok (B,), parity
        (ceil(B/k), m, maxlen) | None); short blocks zero-pad to maxlen
        (zero data → zero parity, GF-linear).  Device backends override
        with a single fused dispatch; this default serves the CPU path."""
        ok = self.batch_verify(blocks, hashes)
        parity = None
        if fetch_parity and self.params.rs_data > 0 and blocks:
            parity = self.rs_encode_blocks(blocks)
        return ok, parity

    # --- Reed-Solomon ---
    def rs_encode(self, data: np.ndarray) -> np.ndarray:
        """(B, k, S) uint8 → (B, m, S) parity shards."""
        raise NotImplementedError

    def rs_reconstruct(self, shards: np.ndarray, present: Sequence[int],
                       rows: Optional[Sequence[int]] = None) -> np.ndarray:
        """shards (B, p, S) = the surviving shards, in the order listed by
        `present` (indices into the k+m codeword, p ≥ k) → (B, k, S) data.

        `rows` restricts decoding to those data-row indices, returning
        (B, len(rows), S) — a repair that lost j of k members only pays
        for the j missing rows instead of re-deriving all k (a k/j GF
        work saving, 8× for the common single-block repair)."""
        raise NotImplementedError

    # --- compression (CPU-side on both backends) ---
    def compress(self, data: bytes) -> Optional[bytes]:
        if self.params.compression_level is None:
            return None
        from ..utils.zstd_compat import zstandard
        c = zstandard.ZstdCompressor(
            level=self.params.compression_level,
            write_checksum=True,   # ref block/block.rs:66-78 verifies via zstd checksum
            write_content_size=True,
        )
        out = c.compress(data)
        return out if len(out) < len(data) else None

    def decompress(self, data: bytes) -> bytes:
        from ..utils.zstd_compat import zstandard
        return zstandard.ZstdDecompressor().decompress(data)

    # --- sharding helpers (shape plumbing, backend-independent) ---
    def shard_block(self, block: bytes) -> Tuple[np.ndarray, int]:
        """Split one block into (k, S) zero-padded shards; returns original
        length for exact reassembly."""
        k = self.params.rs_data
        n = len(block)
        s = (n + k - 1) // k
        buf = np.zeros(k * s, dtype=np.uint8)
        buf[:n] = np.frombuffer(block, dtype=np.uint8)
        return buf.reshape(k, s), n

    def unshard_block(self, data: np.ndarray, length: int) -> bytes:
        return data.reshape(-1).tobytes()[:length]
