"""CudaCodec — the BlockCodec's batch operations on an NVIDIA GPU.

Counterpart of ``garage_tpu/ops/tpu_codec.py`` (``TpuCodec``):

  - BLAKE2s-256 integrity hashing, one thread per block
    (``ops/cuda_blake2s.py`` over ``csrc/blake2s.cu``);
  - Reed-Solomon GF(2^8) encode and reconstruct as one matrix-apply
    kernel over codeword slabs (``ops/cuda_gf.py`` over
    ``csrc/gf_apply.cu``);
  - the fused scrub step (``scrub_encode_submit``): the hash kernel and
    then the GF kernel on the current CUDA stream over the same device
    buffer, with the digest compare and corrupt count as tensor ops in
    between and no host synchronisation until ``scrub_collect``.

Shapes follow the reference so the same staged batches fit: rows are
bucketed to power-of-two multiples of 64 bytes (``_bucket``), lanes to
power-of-two multiples of 8 (``_batch_size``) and aligned to whole
codewords (``_lane_align``); pad lanes expect the empty-message digest
(``_pad_group``) so they verify clean.  The TPU's ``B % 128`` lane rule
is gone.

The codec runs on ``device``: "cuda" (the default) launches the kernels
and raises when there is no GPU; "cpu" runs the kernels' plain versions
and exists for the tests.  There is no fallback from one to the other,
and no latch that switches a kernel off: a kernel that fails raises.

Host input reaches the card in one of two ways.  A page-locked torch
tensor (the transport's pinned staging slots, ops/transport.py) is
copied with ``non_blocking=True``: the copy is queued on the stream and
the caller keeps the memory unchanged until the batch is collected.  A
numpy array or pageable tensor is a pageable copy.  Results come back
through one reusable page-locked buffer (``_fetch``): the D2H copy is
queued behind the kernels, then copied out into arrays the caller owns.
Every launch and copy goes to the current stream of the device, one
stream for all threads, so freeing a tensor (a pool page) can never
race a kernel still reading it.

The pool API (``scrub_encode_submit_resident``, ``pool_adopt``,
``pool_read``) serves ops/device_pool.py: resident blocks live on the
card as 1-D uint8 page tensors, each with its own storage.

The observer stages ``h2d_transfer``, ``kernel_dispatch`` and
``sync_collect`` stay separate, as in the reference, and collect is
split further into ``collect_wait`` (the event), ``collect_d2h`` and
``collect_copy_out``; the accelerator side keeps the observer's "tpu"
label.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.data import Hash
from . import gf256
from .blake2s import blake2s_batch_plain, digests_to_bytes
from .codec import BlockCodec, CodecParams
from .cuda_blake2s import blake2s_batch
from .cuda_gf import consts_from_numpy, gf_apply, gf_apply_plain

# launches of the fused scrub dispatch (hash kernel + GF kernel) on a GPU
fused_launches = 0
_count_lock = threading.Lock()

_EMPTY_DIGEST = np.frombuffer(
    hashlib.blake2s(b"", digest_size=32).digest(), dtype="<u4")


def reset_launches() -> None:
    global fused_launches
    with _count_lock:
        fused_launches = 0


def launch_counts() -> dict:
    """This process's kernel launches so far: the hash kernel
    (``blake2s``), the GF kernel (``gf_apply``, and by body), and the
    fused scrub dispatch (``fused_scrub``).  Process-wide: every codec of
    the process adds to the same counts."""
    from . import cuda_blake2s, cuda_gf

    with _count_lock:
        fused = fused_launches
    with cuda_gf._count_lock:
        gf, gf_by = cuda_gf.launches, dict(cuda_gf.launches_by)
    return {"blake2s": cuda_blake2s.launches, "gf_apply": gf,
            "gf_apply_by": gf_by, "fused_scrub": fused}


def scrub_composition(data, lengths, expected, consts, k, hash_fn, gf_fn):
    """The fused scrub's composition: hash every lane, compare with the
    expected digests, count mismatches, and apply the GF(2^8) constants
    to each group of k lanes viewed as (B/k, k, S/4) int32 words."""
    h = hash_fn(data, lengths)
    ok = (h == expected).all(dim=1)
    bad = (~ok).sum(dtype=torch.int32)
    parity = None
    if k > 0:
        lanes, cols = data.shape
        words = data.view(torch.int32).view(lanes // k, k, cols // 4)
        parity = gf_fn(words, consts).view(torch.uint8).view(
            lanes // k, consts.shape[0], cols)
    return h, ok, bad, parity


def fused_scrub_plain(data: torch.Tensor, lengths: torch.Tensor,
                      expected: torch.Tensor, consts: torch.Tensor, k: int):
    """Plain PyTorch version of the fused scrub on the same inputs as
    CudaCodec.fused_scrub (with its encode constants and k): the plain
    hash, the compare and count, and the plain GF apply → (digests, ok,
    bad, parity)."""
    return scrub_composition(data, lengths, expected, consts, k,
                             blake2s_batch_plain, gf_apply_plain)


class ScrubOut(NamedTuple):
    """Device results of one fused scrub dispatch and the event recorded
    after it: digests (B, 8) int32, ok (B,) bool, bad () int32, parity
    (B/k, m, S) uint8 or None."""
    digests: torch.Tensor
    ok: torch.Tensor
    bad: torch.Tensor
    parity: Optional[torch.Tensor]
    event: Optional[torch.cuda.Event]


class DeviceOut(NamedTuple):
    """One device result tensor and the event recorded after it."""
    value: torch.Tensor
    event: Optional[torch.cuda.Event]


class CudaCodec(BlockCodec):
    def __init__(self, params: CodecParams, device="cuda", metrics=None,
                 tracer=None, observer=None):
        super().__init__(params, metrics=metrics, tracer=tracer,
                         observer=observer)
        if params.hash_algo != "blake2s":
            raise ValueError(
                "CudaCodec offloads blake2s only; set codec.hash_algo="
                f"'blake2s' (got {params.hash_algo!r})")
        if params.shard_mesh > 1:
            raise ValueError("multi-GPU split not ported yet")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CudaCodec(device='cuda') needs a CUDA device and none "
                    "is available; pass device='cpu' for the plain versions")
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        self._enc_mat = None
        self._K_enc = None
        if params.rs_data > 0:
            self._set_encode_matrix(
                gf256.rs_parity_matrix(params.rs_data, params.rs_parity))
        # (present[:k], rows) → device constants of that decode matrix
        self._decode_cache = {}
        # which implementation produced the last submission: "cuda" (the
        # kernels) or "plain" (CPU device); threaded back by callers into
        # note_sync_{success,failure}
        self.last_submit_variant = "cuda" if self._on_gpu else "plain"
        # LinkProfiler boundary stamps: adopt (host array now a device
        # tensor), ready (after the dispatch's CUDA event synchronised),
        # and a first-dispatch-per-(kind, shape) flag
        self.last_adopt_ns = 0
        self.last_ready_ns = 0
        self.last_submit_compiled = False
        self._dispatched_shapes = set()
        # the transport stages into page-locked slots when this is set
        self.pin_memory = self._on_gpu
        # one reusable page-locked D2H buffer, grown on demand; the lock
        # covers its fill and copy-out (collects run on several threads)
        self._fetch_lock = threading.Lock()
        self._pinned_out: Optional[torch.Tensor] = None

    @property
    def _on_gpu(self) -> bool:
        return self.device.type == "cuda"

    def device_info(self) -> dict:
        """The device side of `info()`: where the kernels run, this
        process's launch counts, and on a GPU the caching allocator's
        bytes and the page-locked D2H buffer's size."""
        d = {"device": str(self.device), "launches": launch_counts()}
        if self._on_gpu:
            out = self._pinned_out
            d["cuda_memory"] = {
                "allocated": torch.cuda.memory_allocated(self.device),
                "reserved": torch.cuda.memory_reserved(self.device),
                "pinned_out_bytes": out.numel() if out is not None else 0,
            }
        return d

    def info(self) -> dict:
        d = super().info()
        d.update(self.device_info())
        return d

    def ragged_side(self) -> str:
        """Feeder attribution: a bare device codec runs every ragged
        batch on the accelerator ("tpu" is the observer's label for that
        side)."""
        return "tpu"

    # --- matrices ---

    def _set_encode_matrix(self, mat: np.ndarray) -> None:
        self._enc_mat = np.asarray(mat, dtype=np.uint8)
        self._K_enc = consts_from_numpy(self._enc_mat, self.device)

    def load_reference_matrices(self, enc_mat: Optional[np.ndarray],
                                decode_cache=None) -> None:
        """Adopt GF(2^8) matrices computed elsewhere (e.g. by the JAX
        codec): `enc_mat` is the (m, k) parity matrix; `decode_cache`
        maps (present[:k], rows|None) to a decode matrix, to its (r, k, 8)
        constants, or to a (constants, matrix) pair as the reference
        codec caches them.  Constants go to the device through
        cuda_gf.consts_from_numpy."""
        if enc_mat is not None:
            self._set_encode_matrix(enc_mat)
        for key, val in (decode_cache or {}).items():
            consts = val[0] if isinstance(val, tuple) else val
            self._decode_cache[key] = consts_from_numpy(np.asarray(consts),
                                                        self.device)

    def _decode_consts(self, present: Sequence[int],
                       rows: Optional[Sequence[int]]):
        k, m = self.params.rs_data, self.params.rs_parity
        key = (tuple(present[:k]), tuple(rows) if rows is not None else None)
        K = self._decode_cache.get(key)
        if K is None:
            dec = gf256.rs_decode_matrix(k, m, present)
            if rows is not None:
                dec = np.ascontiguousarray(dec[list(rows)])
            K = self._decode_cache[key] = consts_from_numpy(dec, self.device)
        return key, K

    # --- device plumbing ---

    def _to_device(self, arr) -> torch.Tensor:
        """A host array or tensor as a device tensor.  On the GPU a
        page-locked tensor is copied asynchronously (the caller must not
        rewrite it before the batch is collected) and anything else is a
        pageable copy; on the CPU device it is the same memory."""
        if isinstance(arr, torch.Tensor):
            t = arr.contiguous()
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        if not self._on_gpu:
            return t
        return t.to(self.device, non_blocking=t.is_pinned())

    def synchronize(self) -> None:
        """Wait for everything queued on the codec's stream."""
        if self._on_gpu:
            torch.cuda.current_stream(self.device).synchronize()

    def _fetch(self, *tensors: torch.Tensor) -> List[np.ndarray]:
        """Device results as host arrays the caller owns.  On the GPU the
        D2H copies go into one reusable page-locked buffer, queued on the
        stream behind the kernels, and are then copied out; the two steps
        are timed as collect_d2h and collect_copy_out.  On the CPU device
        the tensors' own memory."""
        if not self._on_gpu:
            return [t.numpy() for t in tensors]
        sizes = [t.numel() * t.element_size() for t in tensors]
        offs, total = [], 0
        for n in sizes:
            offs.append(total)
            total += n + (-n) % 64  # keep every view aligned
        with self._fetch_lock:
            buf = self._pinned_out
            if buf is None or buf.numel() < total:
                buf = self._pinned_out = torch.empty(
                    (total,), dtype=torch.uint8, pin_memory=True)
            t0 = time.perf_counter()
            views = []
            for t, o, n in zip(tensors, offs, sizes):
                v = buf[o:o + n].view(t.dtype).view(t.shape)
                v.copy_(t, non_blocking=True)
                views.append(v)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            ev.synchronize()
            t1 = time.perf_counter()
            out = [v.numpy().copy() for v in views]
            t2 = time.perf_counter()
        self.obs.observe_stage("collect_d2h", "tpu", t1 - t0)
        self.obs.observe_stage("collect_copy_out", "tpu", t2 - t1)
        return out

    def _record(self) -> Optional[torch.cuda.Event]:
        if not self._on_gpu:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _mark_adopt(self, kind: str, shape) -> None:
        self.last_adopt_ns = time.monotonic_ns()
        key = (kind, tuple(shape))
        self.last_submit_compiled = key not in self._dispatched_shapes
        self._dispatched_shapes.add(key)

    def _mark_ready(self, event: Optional[torch.cuda.Event]) -> None:
        """Wait for the dispatch's event, then stamp the ready boundary:
        what follows in a collect is device→host copy and reassembly."""
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        self.last_ready_ns = time.monotonic_ns()
        self.obs.observe_stage("collect_wait", "tpu", time.perf_counter() - t0)

    def _gf(self, u8: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
        """(B, k, S) uint8 device slabs, S % 4 == 0 → (B, r, S) uint8."""
        b, k, s = u8.shape
        u32 = u8.reshape(b, k * s).view(torch.int32).view(b, k, s // 4)
        out = gf_apply(u32, K)
        return out.view(torch.uint8).view(b, out.shape[1], s)

    # --- the transport device API ---

    def staging_geometry(self, nlanes: int, maxlen: int,
                         kind: str) -> Tuple[int, int]:
        """(lanes, row_bytes) to stage for `nlanes` blocks of up to
        `maxlen` bytes: power-of-two bucketing, and lanes aligned to
        whole codewords for the fused scrub's parity."""
        cols = self._bucket(max(maxlen, 1))
        lanes = self._batch_size(max(nlanes, 1))
        if kind in ("scrub", "encode"):
            lanes += (-lanes) % self._lane_align()
        return lanes, cols

    def probe_submit(self, arr) -> DeviceOut:
        """Upload a staged buffer and reduce it to a device scalar that
        depends on every byte (the link probe's round trip)."""
        da = self._to_device(arr)
        self._mark_adopt("probe", arr.shape)
        s = da.reshape(-1).sum(dtype=torch.int64)
        return DeviceOut(s, self._record())

    def probe_collect(self, handle: DeviceOut) -> int:
        self._mark_ready(handle.event)
        return int(handle.value.item())

    def hash_submit(self, arr, lengths: np.ndarray) -> DeviceOut:
        """Enqueue a staged (lanes, row_bytes) hash batch (numpy or a
        host tensor) without synchronising."""
        with self.obs.stage("h2d_transfer", "tpu"):
            da = self._to_device(arr)
            dl = self._to_device(np.asarray(lengths, dtype=np.int32))
        self._mark_adopt("hash", arr.shape)
        with self.obs.stage("kernel_dispatch", "tpu"):
            h = blake2s_batch(da, dl)
            return DeviceOut(h, self._record())

    def hash_collect(self, handle: DeviceOut, n: int) -> List[Hash]:
        self._mark_ready(handle.event)
        h, = self._fetch(handle.value[:n])
        return [Hash(d) for d in digests_to_bytes(h)]

    def encode_submit(self, groups) -> DeviceOut:
        """Enqueue RS parity for staged (B, k, S) codeword groups (S a
        multiple of 4, as staging_geometry's bucketing guarantees)."""
        if groups.shape[-1] % 4:
            raise ValueError(f"row bytes must be a multiple of 4: {groups.shape}")
        with self.obs.stage("h2d_transfer", "tpu"):
            d = self._to_device(
                groups.reshape(-1, groups.shape[-2], groups.shape[-1]))
        self._mark_adopt("encode", groups.shape)
        with self.obs.stage("kernel_dispatch", "tpu"):
            return DeviceOut(self._gf(d, self._K_enc), self._record())

    def encode_collect(self, handle: DeviceOut) -> np.ndarray:
        self._mark_ready(handle.event)
        return self._fetch(handle.value)[0]

    def decode_submit(self, shards: np.ndarray, present: Sequence[int],
                      rows: Optional[Sequence[int]] = None) -> DeviceOut:
        """Enqueue one survivor-pattern decode over staged (B, p, S)
        shards without synchronising."""
        k = self.params.rs_data
        key, K = self._decode_consts(present, rows)
        sub = shards[..., :k, :]
        s = sub.shape[-1]
        pad = (-s) % 4
        if pad:
            sub = np.pad(sub, [(0, 0)] * (sub.ndim - 1) + [(0, pad)])
        with self.obs.stage("h2d_transfer", "tpu"):
            d = self._to_device(sub.reshape(-1, k, sub.shape[-1]))
        self._mark_adopt("decode", (*sub.shape, *key[0]))
        with self.obs.stage("kernel_dispatch", "tpu"):
            out = self._gf(d, K)[..., :s]
            out = out.reshape(sub.shape[:-2] + out.shape[-2:])
            return DeviceOut(out, self._record())

    def decode_collect(self, handle: DeviceOut) -> np.ndarray:
        self._mark_ready(handle.event)
        return self._fetch(handle.value)[0]

    # --- hashing ---

    @staticmethod
    def _bucket(n: int, quantum: int = 64) -> int:
        """Round up to a power-of-two multiple of `quantum`: a bounded
        set of staged shapes (and whole 64-byte hash chunks)."""
        n = max(n, quantum)
        b = quantum
        while b < n:
            b <<= 1
        return b

    def _lane_align(self) -> int:
        """Lane-count divisor: whole codewords (k)."""
        return max(1, self.params.rs_data)

    def _batch_size(self, n: int) -> int:
        return self._bucket(n, 8)

    def _pad_batch(self, blocks: Sequence[bytes]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        maxlen = max((len(b) for b in blocks), default=0)
        arr = np.zeros((self._batch_size(len(blocks)), self._bucket(maxlen)),
                       dtype=np.uint8)
        lengths = np.zeros((arr.shape[0],), dtype=np.int32)
        for i, b in enumerate(blocks):
            arr[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
            lengths[i] = len(b)
        return arr, lengths

    @staticmethod
    def _expected(nlanes: int, hashes: Sequence[Hash]) -> np.ndarray:
        """(nlanes, 8) uint32 expected digests; pad lanes expect the
        empty-message digest so they verify clean."""
        expected = np.broadcast_to(_EMPTY_DIGEST, (nlanes, 8)).copy()
        if len(hashes):
            expected[: len(hashes)] = np.stack(
                [np.frombuffer(bytes(h), dtype="<u4") for h in hashes])
        return expected

    def batch_hash(self, blocks: Sequence[bytes]) -> List[Hash]:
        if not blocks:
            return []
        arr, lengths = self._pad_batch(blocks)
        return self.hash_collect(self.hash_submit(arr, lengths), len(blocks))

    def verify_one(self, block: bytes, hash: Hash) -> bool:
        """Single-block verify stays on the host: one block cannot
        amortise a device dispatch, and hashlib.blake2s is bit-identical
        to the kernel."""
        return hashlib.blake2s(block, digest_size=32).digest() == bytes(hash)

    def batch_verify(self, blocks: Sequence[bytes],
                     hashes: Sequence[Hash]) -> np.ndarray:
        if len(blocks) != len(hashes):
            raise ValueError(f"{len(blocks)} blocks vs {len(hashes)} hashes")
        if not blocks:
            return np.zeros((0,), dtype=bool)
        arr, lengths = self._pad_batch(blocks)
        expected = self._expected(arr.shape[0], hashes)
        with self.obs.stage("h2d_transfer", "tpu"):
            da = self._to_device(arr)
            dl = self._to_device(lengths)
            de = self._to_device(expected.view(np.int32))
        with self.obs.stage("kernel_dispatch", "tpu"):
            ok = (blake2s_batch(da, dl) == de).all(dim=1)
            ev = self._record()
        self._mark_ready(ev)
        return ok.cpu().numpy()[: len(blocks)]

    # --- Reed-Solomon ---

    def _gf_host(self, flat: np.ndarray, K: torch.Tensor) -> np.ndarray:
        """(N, k, S) uint8 host slabs through the GF kernel; S padded to a
        multiple of 4 for the uint32 view, the result trimmed back."""
        s = flat.shape[-1]
        pad = (-s) % 4
        if pad:
            flat = np.pad(flat, [(0, 0)] * (flat.ndim - 1) + [(0, pad)])
        out = self._gf(self._to_device(flat), K)
        return out.cpu().numpy()[..., :s]

    def rs_encode(self, data: np.ndarray) -> np.ndarray:
        if data.shape[-2] != self.params.rs_data:
            raise ValueError(f"expected k={self.params.rs_data} data shards, "
                             f"got {data.shape}")
        lead = data.shape[:-2]
        flat = np.asarray(data, dtype=np.uint8).reshape((-1,) + data.shape[-2:])
        out = self._gf_host(flat, self._K_enc)
        return out.reshape(lead + out.shape[-2:])

    def rs_reconstruct(self, shards: np.ndarray, present: Sequence[int],
                       rows: Optional[Sequence[int]] = None) -> np.ndarray:
        k = self.params.rs_data
        _key, K = self._decode_consts(present, rows)
        lead = shards.shape[:-2]
        flat = np.asarray(shards[..., :k, :], dtype=np.uint8).reshape(
            (-1, k, shards.shape[-1]))
        out = self._gf_host(flat, K)
        return out.reshape(lead + out.shape[-2:])

    # --- the fused scrub ---

    def _pad_group(self, blocks: Sequence[bytes], hashes: Sequence[Hash]):
        """Pad a block group to the staged lane/byte shape: (arr, lengths,
        expected), lanes aligned to whole codewords, pad lanes carrying
        the empty-message digest."""
        arr, lengths = self._pad_batch(blocks)
        pad_lanes = (-arr.shape[0]) % self._lane_align()
        if pad_lanes:
            arr = np.pad(arr, [(0, pad_lanes), (0, 0)])
            lengths = np.pad(lengths, (0, pad_lanes))
        return arr, lengths, self._expected(arr.shape[0], hashes)

    def fused_scrub(self, data: torch.Tensor, lengths: torch.Tensor,
                    expected: torch.Tensor):
        """The fused scrub on device tensors: data (B, S) uint8, lengths
        (B,) int32, expected (B, 8) int32 → (digests, ok, bad, parity).
        The hash kernel, the compare and count, then the GF kernel over
        the same buffer, all on the current stream with no host sync."""
        out = scrub_composition(data, lengths, expected, self._K_enc,
                                self.params.rs_data, blake2s_batch, gf_apply)
        if self._on_gpu:
            global fused_launches
            with _count_lock:
                fused_launches += 1
        return out

    def scrub_encode_submit(self, arr, lengths: np.ndarray,
                            expected: np.ndarray) -> ScrubOut:
        """One fused dispatch for a staged batch: hash every lane,
        compare with `expected`, count corrupt lanes, and compute RS(k, m)
        parity for each group of k lanes.  Returns device results without
        synchronising; scrub_collect waits on the recorded event."""
        k = self.params.rs_data
        if (k and arr.shape[0] % k) or arr.shape[1] % 4:
            raise ValueError(f"staged batch {arr.shape} needs lanes in whole "
                             f"codewords of {k} and rows a multiple of 4")
        with self.obs.stage("h2d_transfer", "tpu"):
            da = self._to_device(arr)
            dl = self._to_device(np.asarray(lengths, dtype=np.int32))
            de = self._to_device(
                np.ascontiguousarray(expected, dtype=np.uint32).view(np.int32))
        self._mark_adopt("scrub", arr.shape)
        with self.obs.stage("kernel_dispatch", "tpu"):
            out = ScrubOut(*self.fused_scrub(da, dl, de), self._record())
        self.last_submit_variant = "cuda" if self._on_gpu else "plain"
        return out

    def scrub_collect(self, out: ScrubOut, fetch_parity: bool):
        """Materialise one scrub_encode_submit result: (ok full-lane bool
        array, parity full array | None)."""
        self._mark_ready(out.event)
        if fetch_parity and out.parity is not None:
            return tuple(self._fetch(out.ok, out.parity))
        return self._fetch(out.ok)[0], None

    # --- the DevicePool API (ops/device_pool.py) ---
    #
    # Pool-aware scrub: only MISS lanes cross the link (one compact H2D
    # upload scattered into a zeroed device batch); resident lanes are
    # composed from pool pages, which already live on the card.  The
    # composed batch runs the same fused scrub as the plain path, so
    # pool-served lanes are re-verified against their expected digests
    # on every read.

    def scrub_encode_submit_resident(self, miss_arr, miss_rows,
                                     lengths: np.ndarray,
                                     expected: np.ndarray, resident):
        """Returns (ScrubOut, composed device batch): the batch is what
        pool_adopt cuts verified miss lanes out of.  miss_arr holds the
        miss lanes in order (numpy or a host tensor), miss_rows their
        lanes in the batch, resident (lane, pages, length) triples."""
        lanes = int(lengths.shape[0])
        cols = int(miss_arr.shape[1])
        k = self.params.rs_data
        if (k and lanes % k) or cols % 4:
            raise ValueError(f"staged batch ({lanes}, {cols}) needs lanes in "
                             f"whole codewords of {k} and rows a multiple of 4")
        with self.obs.stage("h2d_transfer", "tpu"):
            full = torch.zeros((lanes, cols), dtype=torch.uint8,
                               device=self.device)
            if len(miss_rows):
                dm = self._to_device(miss_arr[:len(miss_rows)])
                idx = self._to_device(np.asarray(miss_rows, dtype=np.int64))
                full.index_copy_(0, idx, dm)
            dl = self._to_device(np.asarray(lengths, dtype=np.int32))
            de = self._to_device(
                np.ascontiguousarray(expected, dtype=np.uint32).view(np.int32))
        if resident:
            self._compose_resident(full, resident)
        self._mark_adopt("scrub", (lanes, cols))
        with self.obs.stage("kernel_dispatch", "tpu"):
            out = ScrubOut(*self.fused_scrub(full, dl, de), self._record())
        self.last_submit_variant = "cuda" if self._on_gpu else "plain"
        return out, full

    def _compose_resident(self, full: torch.Tensor, resident) -> None:
        """Write pool-resident lanes into the device batch from their
        pages, on the device.  When rows are whole pages, every page of
        the batch lands with one stack and one indexed write."""
        lanes, cols = full.shape
        pb = int(resident[0][1][0].numel())
        if cols % pb == 0:
            rows, cols_at, pages = [], [], []
            for r, pgs, _n in resident:
                for j, pg in enumerate(pgs):
                    rows.append(int(r))
                    cols_at.append(j)
                    pages.append(pg)
            ri = torch.tensor(rows, dtype=torch.int64, device=full.device)
            ci = torch.tensor(cols_at, dtype=torch.int64, device=full.device)
            full.view(lanes, cols // pb, pb)[ri, ci] = torch.stack(pages)
            return
        for r, pgs, _n in resident:
            row = torch.cat(list(pgs))[:cols]
            full[int(r), :row.numel()] = row

    def pool_adopt(self, input_ref: torch.Tensor, lane: int, length: int,
                   page_bytes: int) -> List[torch.Tensor]:
        """Cut one verified lane of a composed batch into fixed-size
        device pages, the tail page zero-padded past the row.  Each page
        is a device-to-device copy with its own storage: a view would
        keep the whole batch alive behind one page, and the pool's byte
        budget would no longer bound its device memory."""
        pb = int(page_bytes)
        npages = max(1, -(-int(length) // pb))
        row = input_ref[int(lane)]
        cols = row.numel()
        pages = []
        for i in range(npages):
            lo, hi = i * pb, min((i + 1) * pb, cols)
            if hi - lo == pb:
                pages.append(row[lo:hi].clone())
            else:
                pg = torch.zeros((pb,), dtype=torch.uint8, device=row.device)
                if hi > lo:
                    pg[:hi - lo].copy_(row[lo:hi])
                pages.append(pg)
        return pages

    def pool_read(self, pages, length: int) -> bytes:
        """D2H readback of a pooled block (tests and checks only), trimmed
        to the ragged tail."""
        row = torch.cat(list(pages))[:int(length)]
        return row.cpu().numpy().tobytes()

    def note_sync_failure(self, e: BaseException,
                          variant: Optional[str] = None) -> None:
        """Record a failure that surfaced when a submission was
        collected.  The caller re-raises; nothing is switched off."""
        self.obs.event("sync_failure", reason=type(e).__name__,
                       variant=variant or self.last_submit_variant,
                       error=f"{type(e).__name__}: {e}"[:200])

    def note_sync_success(self, variant: Optional[str] = None) -> None:
        """A submission was collected; nothing to reset (no latch)."""

    def scrub_submit(self, blocks: Sequence[bytes], hashes: Sequence[Hash]):
        """Enqueue one group's fused verify + encode without
        synchronising.  Returns (ok, parity, n): device tensors (a `.cpu()`
        waits for them) and the true block count."""
        with self.obs.stage("host_staging", "tpu"):
            arr, lengths, expected = self._pad_group(blocks, hashes)
        out = self.scrub_encode_submit(arr, lengths, expected)
        return out.ok, out.parity, len(blocks)

    def warm_scrub(self, nblocks: int, nbytes: int) -> None:
        """Build (or load) the kernels before the first scrub, so no
        dispatch pays nvcc.  No data moves; the kernels take any shape."""
        if self._on_gpu:
            from ._build import build_all

            build_all()

    def scrub_encode_batch(self, blocks: Sequence[bytes],
                           hashes: Sequence[Hash],
                           fetch_parity: bool = True):
        """Synchronous fused verify + encode: (ok (B,), parity
        (ceil(B/k), m, maxlen) | None), parity trimmed of lane and column
        padding (pad rows and columns are zero blocks, hence zero
        parity)."""
        if len(blocks) != len(hashes):
            raise ValueError(f"{len(blocks)} blocks vs {len(hashes)} hashes")
        if not blocks:
            return np.zeros((0,), dtype=bool), None
        with self.obs.stage("host_staging", "tpu"):
            arr, lengths, expected = self._pad_group(blocks, hashes)
        out = self.scrub_encode_submit(arr, lengths, expected)
        variant = self.last_submit_variant
        try:
            with self.obs.stage("sync_collect", "tpu"):
                ok, parity = self.scrub_collect(out, fetch_parity)
        except Exception as e:
            self.note_sync_failure(e, variant)
            raise
        self.note_sync_success(variant)
        n = len(blocks)
        if parity is None:
            return ok[:n], None
        k = self.params.rs_data
        maxlen = max(len(b) for b in blocks)
        return ok[:n], parity[: (n + k - 1) // k, :, :maxlen]
