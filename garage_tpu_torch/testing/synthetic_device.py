"""Synthetic-link device codec — the hybrid crossover test backend.

A device's link rate decides whether the hybrid gate opens, and a
real card's rate cannot be set at will.  To prove the hybrid's claimed
steady-state model

    total ≈ cpu_rate + min(link_rate, device_rate)

and the gate behavior on BOTH sides of the threshold, this backend
stands in for CudaCodec with a CONFIGURABLE link: transfers are modeled
as sleeps (which release the GIL exactly like a real DMA leaves the CPU
free for the verify thread), and the probe hook reports the configured
rate so the gate decision is deterministic.

Two modes:
  - compute_real=False (timing mode): verification results are
    synthesized (the caller's hashes are trusted), so the backend
    consumes NO host CPU — the sleep is the entire cost, making the
    throughput model measurable on a 1-core host.  Only valid for
    fetch_parity=False flows.
  - compute_real=True (identity mode): results come from a real
    CpuCodec, so bit-identity of the hybrid merge/split machinery can
    be asserted through the probe/gate path.  Costs host CPU; timing
    is not meaningful on a 1-core host.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from ..ops.codec import CodecParams
from ..ops.cpu_codec import CpuCodec
from ..utils.data import Hash


def _wait_until(ready: float) -> None:
    dt = ready - time.monotonic()
    if dt > 0:
        time.sleep(dt)


class _Lazy:
    """Async-device result handle: np.asarray() blocks until the modeled
    link has delivered the submission (CudaCodec's device tensors behave
    the same way — sync happens at materialization)."""

    __slots__ = ("value", "ready")

    def __init__(self, value, ready: float):
        self.value = value
        self.ready = ready

    def __array__(self, dtype=None, copy=None):
        _wait_until(self.ready)
        out = np.asarray(self.value)
        return out.astype(dtype) if dtype is not None else out


class SyntheticLinkCodec:
    """CudaCodec stand-in with a modeled host→device link."""

    def __init__(self, params: CodecParams, link_gibs: float,
                 device_gibs: float = float("inf"),
                 fixed_latency_s: float = 0.0,
                 compute_real: bool = False,
                 compile_s: float = 0.0):
        self.params = params
        self.link_gibs = link_gibs
        self.device_gibs = device_gibs
        self.fixed_latency_s = fixed_latency_s
        self.compute_real = compute_real
        # modeled first-dispatch compile: the FIRST array-level submission of each
        # (kind, shape) sleeps this long between adoption and dispatch
        # return, so the LinkProfiler's cold-call `compile` vs
        # steady-state `dispatch` split is deterministically testable
        self.compile_s = compile_s
        # LinkProfiler boundary stamps — the same contract CudaCodec
        # publishes (ops/link_profiler.py): the transport clears these
        # before submit/collect and reads them after
        self.last_adopt_ns = 0
        self.last_ready_ns = 0
        self.last_submit_compiled = False
        self._dispatched_shapes = set()
        self.last_probe_stages = None
        self.cpu: Optional[CpuCodec] = (
            CpuCodec(params) if compute_real else None)
        self.submissions = 0
        self.bytes_submitted = 0
        # transport A/B attribution: the bytes-level path (scrub_submit)
        # models the retired serialize+copy link — each block pays a
        # pack copy plus a transfer-serialize copy, exactly what the
        # retired bytes-level device path did; array-level submissions
        # arrive pre-staged (the transport's single copy is counted on
        # the transport's own meter, not here)
        self.host_copies = 0
        self.blocks_submitted = 0
        self.array_submissions = 0

    def _codec(self) -> CpuCodec:
        """identity-mode math on demand: the array-level transport API
        always computes real results (the transport's bit-identity is
        the thing under test), even when the bytes-level path runs in
        timing mode."""
        if self.cpu is None:
            self.cpu = CpuCodec(self.params)
        return self.cpu

    def _link_sleep(self, nbytes: int) -> None:
        # the link is ONE serial resource: concurrent callers reserve
        # windows on it and wait their own out, so two threads pushing
        # bytes cost the sum of their transfers, not the max — without
        # this, any caller-side threading would fake link bandwidth
        _wait_until(self._link_ready_at(nbytes))

    # --- hooks the hybrid engine looks for ---

    def probe_link(self, nbytes: int) -> float:
        """The hybrid probe hook: the measured link rate, with the
        probe's own transfer time modeled.  Publishes a per-stage
        breakdown (`last_probe_stages`) summing to the measured probe
        wall exactly — the modeled transfer is all device-busy time, so
        it lands in `compute` — which HybridCodec attaches to its gate
        probe events."""
        t0 = time.monotonic()
        time.sleep(min(nbytes / (self.link_gibs * 2**30), 0.05))
        dt = time.monotonic() - t0
        self.last_probe_stages = {
            "stage_copy": 0.0, "adopt": 0.0, "dispatch": 0.0,
            "compute": round(dt, 9), "collect": 0.0}
        return self.link_gibs

    def warm_scrub(self, nblocks: int, nbytes: int) -> None:
        pass  # nothing to compile

    def _batch_size(self, n: int) -> int:
        return max(n, 1)

    # --- submission ---

    def scrub_submit(self, blocks: Sequence[bytes],
                     hashes: Sequence[Hash]):
        nbytes = sum(len(b) for b in blocks)
        self.submissions += 1
        self.bytes_submitted += nbytes
        self.blocks_submitted += len(blocks)
        self.host_copies += 2 * len(blocks)  # pack + transfer-serialize
        self._link_sleep(nbytes)
        if self.compute_real:
            ok = self.cpu.batch_verify(blocks, hashes)
            parity = self.cpu.rs_encode_blocks(blocks)
            return ok, parity, len(blocks)
        # timing mode: the caller's hashes are trusted correct-by-
        # construction; parity is None (fetch_parity=False flows only)
        return np.ones((len(blocks),), dtype=bool), None, len(blocks)

    # --- bytes-level ragged API (the LEGACY serialize+copy path) ---
    #
    # What HybridCodec routed feeder batches through before the
    # DeviceTransport: every block repacked (pack copy) and pushed over
    # the modeled link (transfer-serialize copy).  Kept as the "old"
    # side of the transport A/B (bench --transport-phase).

    def _bytes_level(self, nblocks: int, nbytes: int) -> None:
        self.submissions += 1
        self.bytes_submitted += nbytes
        self.blocks_submitted += nblocks
        self.host_copies += 2 * nblocks   # pack + transfer-serialize
        self._link_sleep(nbytes)

    def hash_ragged(self, groups):
        flat = [b for g in groups for b in g]
        self._bytes_level(len(flat), sum(len(b) for b in flat))
        return self._codec().hash_ragged(groups)

    def rs_encode_ragged(self, groups):
        flat = [b for g in groups for b in g]
        self._bytes_level(len(flat), sum(len(b) for b in flat))
        return self._codec().rs_encode_ragged(groups)

    def rs_reconstruct_ragged(self, items):
        rows = sum(int(sh.shape[0]) for sh, _p, _r in items)
        self._bytes_level(rows, sum(int(sh.nbytes)
                                    for sh, _p, _r in items))
        return self._codec().rs_reconstruct_ragged(items)

    def scrub_ragged(self, items):
        out = []
        for blocks, hashes, fetch_parity in items:
            ok, parity, _n = self.scrub_submit(blocks, hashes)
            out.append((ok, parity if fetch_parity else None))
        return out

    # --- the transport device API (ops/transport.py) ---
    #
    # Array-level entry points consuming the transport's staged buffers
    # directly.  Unlike the bytes-level path, these model an ASYNC
    # device: submit computes the result (real CpuCodec math, so the
    # transport's merge/split machinery is bit-identity-testable) and
    # returns a LAZY handle whose materialization blocks until the
    # modeled link — a serial resource, like a real DMA engine — has
    # "delivered" the bytes.  That is what lets the transport's double
    # buffering show its overlap: batch N+1 stages and submits while
    # batch N's transfer window elapses.

    def _link_ready_at(self, nbytes: int) -> float:
        dt = self.fixed_latency_s + nbytes / (self.link_gibs * 2**30)
        if self.device_gibs != float("inf"):
            dt += nbytes / (self.device_gibs * 2**30)
        now = time.monotonic()
        start = max(now, getattr(self, "_link_busy_until", 0.0))
        self._link_busy_until = start + dt
        return self._link_busy_until

    def staging_geometry(self, nlanes: int, maxlen: int, kind: str):
        k = max(1, self.params.rs_data)
        if kind in ("scrub", "encode"):
            nlanes += (-nlanes) % k
        return max(nlanes, 1), max(maxlen, 1)

    def _rows_bytes(self, arr: np.ndarray, lengths: np.ndarray):
        return [arr[i, :n].tobytes() for i, n in enumerate(lengths)]

    def _mark_adopt(self, kind: str, shape) -> None:
        """LinkProfiler stamp: adoption boundary + compile-vs-dispatch
        verdict, with the modeled compile (cold (kind, shape)) slept
        AFTER the adopt stamp so it attributes to `compile`."""
        self.last_adopt_ns = time.monotonic_ns()
        key = (kind, tuple(shape))
        self.last_submit_compiled = key not in self._dispatched_shapes
        self._dispatched_shapes.add(key)
        if self.last_submit_compiled and self.compile_s > 0:
            time.sleep(self.compile_s)

    def _mark_ready(self, ready: float) -> None:
        _wait_until(ready)
        self.last_ready_ns = time.monotonic_ns()

    def probe_submit(self, arr: np.ndarray):
        # async like the real device: the modeled transfer elapses
        # between submit-return and collect, so the transport probe's
        # stage breakdown attributes it to `compute`, not `dispatch`
        self._mark_adopt("probe", arr.shape)
        dt = min(arr.nbytes / (self.link_gibs * 2**30), 0.05)
        return _Lazy(int(arr.sum(dtype=np.uint32)),
                     time.monotonic() + dt)

    def probe_collect(self, handle) -> int:
        self._mark_ready(handle.ready)
        return int(np.asarray(handle))

    def hash_submit(self, arr: np.ndarray, lengths: np.ndarray):
        self.array_submissions += 1
        self.bytes_submitted += int(lengths.sum())
        self._mark_adopt("hash", arr.shape)
        ready = self._link_ready_at(int(lengths.sum()))
        return ready, self._codec().batch_hash(
            self._rows_bytes(arr, lengths))

    def hash_collect(self, handle, n: int):
        ready, digs = handle
        self._mark_ready(ready)
        return digs[:n]

    def _scrub_math(self, arr: np.ndarray, lengths: np.ndarray,
                    expected: np.ndarray, ready: float):
        """The fused scrub kernel body (real CpuCodec math): verify
        EVERY lane against its expected digest — pool-served lanes
        included, which is what makes every pool read hash-verified —
        plus RS parity per k-lane codeword."""
        codec = self._codec()
        digs = codec.batch_hash(self._rows_bytes(arr, lengths))
        ok = np.array(
            [bytes(d) == np.asarray(e, dtype="<u4").tobytes()
             for d, e in zip(digs, np.asarray(expected))], dtype=bool)
        k = self.params.rs_data
        parity = None
        if k > 0:
            groups = np.ascontiguousarray(arr).reshape(
                arr.shape[0] // k, k, arr.shape[1])
            parity = codec.rs_encode(groups)
        return None, _Lazy(ok, ready), int((~ok).sum()), \
            (_Lazy(parity, ready) if parity is not None else None)

    def scrub_encode_submit(self, arr: np.ndarray, lengths: np.ndarray,
                            expected: np.ndarray):
        self.array_submissions += 1
        self.bytes_submitted += int(lengths.sum())
        self._mark_adopt("scrub", arr.shape)
        ready = self._link_ready_at(int(lengths.sum()))
        return self._scrub_math(arr, lengths, expected, ready)

    def scrub_collect(self, out, fetch_parity: bool):
        _h, ok, _bad, parity = out
        self._mark_ready(ok.ready)
        return np.asarray(ok), (np.asarray(parity) if fetch_parity
                                and parity is not None else None)

    # --- the DevicePool API (ops/device_pool.py) ---
    #
    # Pool-aware scrub: only MISS lanes cross the modeled link (the
    # link sleep charges their lengths alone — a warm batch of all
    # hits pays zero link time, which is exactly the speedup the A/B
    # bench measures); resident lanes are composed from pool pages
    # device-side.  The full composed batch then runs the SAME fused
    # kernel as the plain path, so pool-served lanes are re-verified
    # against their expected digests on every read.

    def scrub_encode_submit_resident(self, miss_arr: np.ndarray,
                                     miss_rows, lengths: np.ndarray,
                                     expected: np.ndarray, resident):
        lanes = int(lengths.shape[0])
        cols = int(miss_arr.shape[1])
        miss_bytes = int(sum(int(lengths[r]) for r in miss_rows))
        self.array_submissions += 1
        self.bytes_submitted += miss_bytes
        self._mark_adopt("scrub", (lanes, cols))
        ready = self._link_ready_at(miss_bytes)
        # device-side composition: zeros (gap/pad lanes verify against
        # the empty digest), scattered miss uploads, pool-page lanes
        full = np.zeros((lanes, cols), dtype=np.uint8)
        for ci, r in enumerate(miss_rows):
            full[r] = miss_arr[ci]
        for r, pages, length in resident:
            row = np.concatenate([np.asarray(p) for p in pages])[:length]
            full[int(r), :int(length)] = row
        return self._scrub_math(full, lengths, expected, ready), full

    def pool_adopt(self, input_ref, lane: int, length: int,
                   page_bytes: int):
        """Slice one verified lane of a resident-submitted batch into
        fixed-size device pages (tail zero-padded) — a device-side
        copy, ZERO link bytes, so adoption never shows up on the
        transport's staging meter."""
        full = input_ref
        assert full is not None, "adoption needs a resident-path input"
        npages = max(1, -(-int(length) // int(page_bytes)))
        buf = np.zeros((npages * int(page_bytes),), dtype=np.uint8)
        buf[:int(length)] = full[int(lane), :int(length)]
        return [buf[i * int(page_bytes):(i + 1) * int(page_bytes)].copy()
                for i in range(npages)]

    def pool_read(self, pages, length: int) -> bytes:
        """D2H readback of a pooled block (tests/smoke only — the data
        path never reads pages back to the host), trimmed to the
        ragged tail."""
        return np.concatenate(
            [np.asarray(p) for p in pages])[:int(length)].tobytes()

    def encode_submit(self, groups: np.ndarray):
        self.array_submissions += 1
        self.bytes_submitted += int(groups.nbytes)
        self._mark_adopt("encode", groups.shape)
        ready = self._link_ready_at(int(groups.nbytes))
        return _Lazy(self._codec().rs_encode(
            np.ascontiguousarray(groups)), ready)

    def encode_collect(self, handle) -> np.ndarray:
        self._mark_ready(handle.ready)
        return np.asarray(handle)

    def decode_submit(self, shards: np.ndarray, present,
                      rows=None):
        self.array_submissions += 1
        self.bytes_submitted += int(shards.nbytes)
        self._mark_adopt("decode", shards.shape)
        ready = self._link_ready_at(int(shards.nbytes))
        return _Lazy(self._codec().rs_reconstruct(shards, present, rows),
                     ready)

    def decode_collect(self, handle) -> np.ndarray:
        self._mark_ready(handle.ready)
        return np.asarray(handle)
