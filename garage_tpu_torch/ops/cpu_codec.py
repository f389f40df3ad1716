"""CPU BlockCodec — the correctness and performance baseline.

Hashing uses hashlib (C-speed; releases the GIL for large buffers) fanned out
over a thread pool, matching the reference's multi-core scrub capability
(ref src/util/async_hash.rs offloads hashing to blocking threads).

Reed-Solomon runs through the optional C++ native kernel
(native/gf256.cpp, loaded via ctypes) when built, else vectorized numpy
log/exp-table math (gf256.gf_matmul_blocks).  Both satisfy the same contract
as the device backend (ops/cuda_codec.py).
"""

from __future__ import annotations

import collections
import concurrent.futures
import os
import threading
from typing import List, Optional, Sequence

import numpy as np

from ..utils.data import BLOCK_HASH_ALGOS, Hash
from . import gf256
from .codec import BlockCodec, CodecParams
from .native import (
    get_native_blake2s_multi,
    get_native_gf_matmul_blocks,
    get_native_gf_matmul_ptrs,
)


_SHARED_POOL = None
_SHARED_POOL_LOCK = threading.Lock()


def _hash_pool() -> concurrent.futures.ThreadPoolExecutor:
    """One process-wide hashing pool shared by every CpuCodec instance
    (codecs are constructed transiently; per-instance pools would leak)."""
    global _SHARED_POOL
    with _SHARED_POOL_LOCK:
        if _SHARED_POOL is None:
            from ..utils.cpuprof import register_thread
            _SHARED_POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=min(32, os.cpu_count() or 4),
                thread_name_prefix="codec-hash",
                initializer=lambda: register_thread("codec-hash"),
            )
        return _SHARED_POOL


class CpuCodec(BlockCodec):
    def __init__(self, params: CodecParams, metrics=None, tracer=None,
                 observer=None):
        super().__init__(params, metrics=metrics, tracer=tracer,
                         observer=observer)
        self._hash_fn = BLOCK_HASH_ALGOS[params.hash_algo]
        self._pool = _hash_pool()
        self._native = get_native_gf_matmul_blocks()
        # Multi-buffer SIMD hashing: 8 blocks per instruction stream.  On
        # the 1-core hosts this targets, the thread pool cannot parallelise
        # hashing at all — the SIMD lanes are the only parallelism there is.
        self._native_hash = (
            get_native_blake2s_multi() if params.hash_algo == "blake2s" else None
        )
        self._native_ptrs = get_native_gf_matmul_ptrs()
        if params.rs_data > 0:
            self._parity_mat = gf256.rs_parity_matrix(params.rs_data, params.rs_parity)
        # encode-schedule cache, keyed by (k, m, geometry): a partial
        # codeword of j < k members only needs the generator's first j
        # columns — the remaining k-j operands are implicit zeros, and
        # multiplying them is pure waste ("Accelerating XOR-based
        # Erasure Coding": drop zero operands from the schedule, cache
        # the schedule, re-run the apply).  Decode carries the
        # equivalent cache; without this one, encode paid full-width
        # work for every lone-put partial codeword.  Bounded LRU (tiny:
        # geometries are 1..k-1, but the bound holds if k grows).
        self._enc_cache: "collections.OrderedDict" = collections.OrderedDict()
        self._enc_cache_lock = threading.Lock()
        # decode-schedule cache, keyed by survivor pattern: building the
        # recovery matrix (generator submatrix + GF inversion) costs more
        # than applying it to a single small decode, and degraded reads /
        # repair storms repeat one loss pattern for every affected
        # codeword ("Accelerating XOR-based Erasure Coding": cache the
        # schedule, re-run the apply).  CudaCodec carries the same
        # cache; without it the CPU path paid the inversion per call.
        self._dec_cache: dict = {}

    def batch_hash(self, blocks: Sequence[bytes]) -> List[Hash]:
        # Below 4 blocks the 8-lane kernel wastes over half its lanes and
        # hashlib's C loop wins; at and above, the SIMD batch wins.
        if self._native_hash is not None and len(blocks) >= 4:
            return [Hash(d) for d in self._native_hash(blocks)]
        if len(blocks) <= 1:
            return [self._hash_fn(b) for b in blocks]
        return list(self._pool.map(self._hash_fn, blocks))

    def _apply(self, mat: np.ndarray, shards: np.ndarray) -> np.ndarray:
        if self._native is not None:
            return self._native(mat, shards)
        return gf256.gf_matmul_blocks(mat, shards)

    def rs_encode(self, data: np.ndarray) -> np.ndarray:
        assert data.shape[-2] == self.params.rs_data, data.shape
        return self._apply(self._parity_mat, np.ascontiguousarray(data, dtype=np.uint8))

    _ENC_CACHE_MAX = 64

    def encode_matrix(self, ncols: int) -> np.ndarray:
        """Cached encode schedule for a partial codeword of `ncols`
        members: the parity generator's first ncols columns (the other
        k-ncols operands are implicit zero shards — zero contributes
        zero over GF(2^8), so dropping the columns is exact).  Keyed by
        (k, m, geometry), bounded LRU — the encode-side twin of
        decode_matrix."""
        k, m = self.params.rs_data, self.params.rs_parity
        ncols = min(ncols, k)
        if ncols == k:
            return self._parity_mat
        key = (k, m, ncols)
        with self._enc_cache_lock:
            mat = self._enc_cache.get(key)
            if mat is not None:
                self._enc_cache.move_to_end(key)
                return mat
        mat = np.ascontiguousarray(self._parity_mat[:, :ncols])
        with self._enc_cache_lock:
            self._enc_cache[key] = mat
            while len(self._enc_cache) > self._ENC_CACHE_MAX:
                self._enc_cache.popitem(last=False)
        return mat

    def _encode_codewords(self, bufs: Sequence[bytes], mat: np.ndarray,
                          s: int) -> np.ndarray:
        """One schedule application: len(bufs)/ncols codewords of ncols
        members each, zero-extended to width s → (B, m, s) parity.
        Pointer-gather kernel when built (no packing pass), else pack +
        the blocks kernel."""
        r, ncols = mat.shape
        assert len(bufs) % ncols == 0, (len(bufs), ncols)
        if self._native_ptrs is not None:
            return self._native_ptrs(mat, list(bufs), s)
        arr = np.zeros((len(bufs), s), dtype=np.uint8)
        for i, b in enumerate(bufs):
            arr[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        return self._apply(mat, arr.reshape(-1, ncols, s))

    def rs_encode_blocks(self, blocks: Sequence[bytes]) -> np.ndarray:
        """Schedule-aware override: full codewords run the full
        generator; a trailing partial codeword runs the cached
        column-sliced schedule instead of multiplying zero pads —
        bit-identical output (zero shards encode to zero parity), and a
        lone single-block put pays 1/k of the GF work."""
        k = self.params.rs_data
        assert k > 0 and blocks
        blocks = list(blocks)
        maxlen = max(len(b) for b in blocks)
        nfull = (len(blocks) // k) * k
        parts = []
        if nfull:
            parts.append(self._encode_codewords(
                blocks[:nfull], self._parity_mat, maxlen))
        tail = blocks[nfull:]
        if tail:
            parts.append(self._encode_codewords(
                tail, self.encode_matrix(len(tail)), maxlen))
        return parts[0] if len(parts) == 1 else np.concatenate(parts,
                                                               axis=0)

    def rs_encode_ragged(self, groups: Sequence[Sequence[bytes]]
                         ) -> List[np.ndarray]:
        """Fused ragged encode with schedule sharing: every group's full
        codewords join ONE generator application, and partial tails are
        batched per geometry through the cached sliced schedules (the
        XOR-schedule fusion of "Accelerating XOR-based Erasure Coding"
        — no zero pad blocks are materialized or multiplied at all).
        Per-group results are bit-identical to rs_encode_blocks(group)."""
        k = self.params.rs_data
        assert k > 0 and groups
        maxlen = max(len(b) for g in groups for b in g)
        full_bufs: List[bytes] = []
        tails: dict = {}
        for gi, g in enumerate(groups):
            assert g, "empty encode submission"
            nfull = (len(g) // k) * k
            full_bufs.extend(g[:nfull])
            if len(g) > nfull:
                tails.setdefault(len(g) - nfull, []).append(gi)
        full_par = (self._encode_codewords(full_bufs, self._parity_mat,
                                           maxlen)
                    if full_bufs else None)
        tail_par: dict = {}
        for ncols, gis in tails.items():
            bufs = [b for gi in gis
                    for b in groups[gi][(len(groups[gi]) // k) * k:]]
            par = self._encode_codewords(
                bufs, self.encode_matrix(ncols), maxlen)
            for j, gi in enumerate(gis):
                tail_par[gi] = par[j:j + 1]
        out: List[np.ndarray] = []
        r = 0
        for gi, g in enumerate(groups):
            nrows = len(g) // k
            ml = max(len(b) for b in g)
            rows = []
            if nrows:
                rows.append(full_par[r:r + nrows])
                r += nrows
            if gi in tail_par:
                rows.append(tail_par[gi])
            par = rows[0] if len(rows) == 1 else np.concatenate(rows,
                                                                axis=0)
            out.append(np.ascontiguousarray(par[:, :, :ml]))
        return out

    def gf_scale(self, coeff: int, buf: bytes,
                 limit: Optional[int] = None) -> bytes:
        b = buf[:limit] if limit is not None else buf
        if coeff == 0 or not b:
            return b""
        if coeff == 1:
            return bytes(b)
        if self._native is not None:
            mat = np.array([[coeff]], dtype=np.uint8)
            arr = np.ascontiguousarray(
                np.frombuffer(b, dtype=np.uint8)).reshape(1, -1)
            return self._native(mat, arr)[0].tobytes()
        return gf256.gf_scale_bytes(coeff, b)

    def decode_matrix(self, present: Sequence[int],
                      rows: Optional[Sequence[int]] = None) -> np.ndarray:
        """Cached recovery matrix for one survivor pattern (optionally
        sliced to `rows`) — the decode schedule shared by rs_reconstruct
        and the repair planner's partial-sum coefficient rows
        (block/repair_plan.py needs the row without running a decode)."""
        k, m = self.params.rs_data, self.params.rs_parity
        key = (tuple(present[:k]), tuple(rows) if rows is not None else None)
        dec = self._dec_cache.get(key)
        if dec is None:
            dec = gf256.rs_decode_matrix(k, m, present)
            if rows is not None:
                dec = np.ascontiguousarray(dec[list(rows)])
            if len(self._dec_cache) >= 512:  # bounded: loss patterns are few
                self._dec_cache.clear()
            self._dec_cache[key] = dec
        return dec

    def rs_reconstruct(self, shards: np.ndarray, present: Sequence[int],
                       rows: Optional[Sequence[int]] = None) -> np.ndarray:
        k = self.params.rs_data
        dec = self.decode_matrix(present, rows)
        return self._apply(dec, np.ascontiguousarray(shards[..., :k, :], dtype=np.uint8))
