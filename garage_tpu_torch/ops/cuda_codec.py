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

The multi-device split (``codec.shard_mesh = n > 1``, the counterpart
of the reference's device mesh): every batch is cut into n contiguous
lane slices of whole codewords (``ops/sharded.py`` ``shard_slices``), one
per device of ``shards``; each slice is copied to its device, its kernels
launch on that device's current stream and one event is recorded per
slice; collect waits on every event and joins digests, ``ok`` and parity
in lane order, and the corrupt count is the sum of the slices' counts
(the reference's psum).  Lanes align to k x n and batches to n, as the
reference aligns them to its mesh, so the staged shapes are the
reference's.  A device may appear more than once: its slices then run
one after another on its one stream, the rule the pool pages' lifetime
rests on.  A pool page lives on the device of the slice that verified
it; composing it into a slice on another device copies it there.  With
one shard (the default) every path is the unsplit one.

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
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.data import Hash
from . import gf256
from .blake2s import blake2s_batch_plain, digests_to_bytes
from .codec import BlockCodec, CodecParams
from .cuda_blake2s import blake2s_batch
from .cuda_gf import consts_from_numpy, gf_apply, gf_apply_plain
from .sharded import shard_slices, to_host

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
    """Device results of one fused scrub dispatch, each result as its
    shards' tensors in lane order: digests (B, 8) int32, ok (B,) bool,
    parity (B/k, m, S) uint8 or None; bad, the summed corrupt count, a
    () int32 tensor on the first shard's device; and the event recorded
    after each shard's launch."""
    digests: List[torch.Tensor]
    ok: List[torch.Tensor]
    bad: torch.Tensor
    parity: Optional[List[torch.Tensor]]
    events: List[Optional[torch.cuda.Event]]


class DeviceOut(NamedTuple):
    """One device result as its shards' tensors in lane order, the event
    recorded after each, and the leading shape the joined rows take
    (None: as they are)."""
    value: List[torch.Tensor]
    events: List[Optional[torch.cuda.Event]]
    lead: Optional[tuple] = None


class CudaCodec(BlockCodec):
    def __init__(self, params: CodecParams, device="cuda", devices=None,
                 metrics=None, tracer=None, observer=None):
        """`device`: "cuda" (the default) or "cpu" (the kernels' plain
        versions).  With ``params.shard_mesh = n > 1`` every batch splits
        over n devices: the first n of `devices` when given (repeats
        allowed), else cuda:0 .. cuda:n-1 on "cuda" (ValueError when
        there are fewer GPUs), else n times "cpu"."""
        super().__init__(params, metrics=metrics, tracer=tracer,
                         observer=observer)
        if params.hash_algo != "blake2s":
            raise ValueError(
                "CudaCodec offloads blake2s only; set codec.hash_algo="
                f"'blake2s' (got {params.hash_algo!r})")
        self.shards = self._shard_devices(torch.device(device), devices,
                                          max(1, params.shard_mesh))
        self.device = self.shards[0]
        # the distinct devices, in shard order
        self._devices = list(dict.fromkeys(self.shards))
        self._enc_mat = None
        self._K_enc = None
        self._K_enc_on: Dict[torch.device, torch.Tensor] = {}
        if params.rs_data > 0:
            self._set_encode_matrix(
                gf256.rs_parity_matrix(params.rs_data, params.rs_parity))
        # (present[:k], rows) → {device: constants of that decode matrix}
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

    @staticmethod
    def _shard_devices(device: torch.device, devices,
                       n: int) -> List[torch.device]:
        if devices is not None:
            devs = [torch.device(d) for d in devices][:n]
            if len(devs) < n:
                raise ValueError(f"codec.shard_mesh={n} but {len(devs)} "
                                 f"devices were given")
        elif n > 1 and device.type == "cuda":
            count = torch.cuda.device_count()
            if count < n:
                raise ValueError(
                    f"codec.shard_mesh={n} needs {n} CUDA devices, and "
                    f"torch.cuda.device_count() is {count}")
            devs = [torch.device("cuda", i) for i in range(n)]
        else:
            devs = [device] * n
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"shards mix device types: {devs}")
        if devs[0].type == "cpu":
            return devs
        if devs[0].type != "cuda":
            raise ValueError(f"unsupported device {devs[0]}")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CudaCodec(device='cuda') needs a CUDA device and none "
                "is available; pass device='cpu' for the plain versions")
        # tensors report their device's index, and constants are looked
        # up by it: "cuda" is the current device
        return [torch.device("cuda", torch.cuda.current_device())
                if d.index is None else d for d in devs]

    @property
    def _on_gpu(self) -> bool:
        return self.device.type == "cuda"

    def device_info(self) -> dict:
        """The device side of `info()`: where the kernels run (the first
        shard's device and every shard's), this process's launch counts,
        and on a GPU the caching allocator's bytes on the first device and
        on each distinct one, and the page-locked D2H buffer's size."""
        d = {"device": str(self.device),
             "shards": [str(s) for s in self.shards],
             "launches": launch_counts()}
        if self._on_gpu:
            out = self._pinned_out
            d["cuda_memory"] = {
                "allocated": torch.cuda.memory_allocated(self.device),
                "reserved": torch.cuda.memory_reserved(self.device),
                "pinned_out_bytes": out.numel() if out is not None else 0,
            }
            d["cuda_memory_by_device"] = {
                str(dv): {"allocated": torch.cuda.memory_allocated(dv),
                          "reserved": torch.cuda.memory_reserved(dv)}
                for dv in self._devices}
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

    def _consts_on_devices(self, K: np.ndarray) -> Dict[torch.device,
                                                        torch.Tensor]:
        """GF constants (cuda_gf.consts_from_numpy) on every device of
        the shards."""
        first = consts_from_numpy(K, self._devices[0])
        return {d: first if d == self._devices[0] else first.to(d)
                for d in self._devices}

    def _set_encode_matrix(self, mat: np.ndarray) -> None:
        self._enc_mat = np.asarray(mat, dtype=np.uint8)
        self._K_enc_on = self._consts_on_devices(self._enc_mat)
        self._K_enc = self._K_enc_on[self.device]

    def load_reference_matrices(self, enc_mat: Optional[np.ndarray],
                                decode_cache=None) -> None:
        """Adopt GF(2^8) matrices computed elsewhere (e.g. by the JAX
        codec): `enc_mat` is the (m, k) parity matrix; `decode_cache`
        maps (present[:k], rows|None) to a decode matrix, to its (r, k, 8)
        constants, or to a (constants, matrix) pair as the reference
        codec caches them.  Constants go to the devices through
        cuda_gf.consts_from_numpy."""
        if enc_mat is not None:
            self._set_encode_matrix(enc_mat)
        for key, val in (decode_cache or {}).items():
            consts = val[0] if isinstance(val, tuple) else val
            self._decode_cache[key] = self._consts_on_devices(
                np.asarray(consts))

    def _decode_consts(self, present: Sequence[int],
                       rows: Optional[Sequence[int]]):
        k, m = self.params.rs_data, self.params.rs_parity
        key = (tuple(present[:k]), tuple(rows) if rows is not None else None)
        K = self._decode_cache.get(key)
        if K is None:
            dec = gf256.rs_decode_matrix(k, m, present)
            if rows is not None:
                dec = np.ascontiguousarray(dec[list(rows)])
            K = self._decode_cache[key] = self._consts_on_devices(dec)
        return key, K

    # --- device plumbing ---

    def _split(self, rows: int, unit: int = 1):
        """[(device, lo, hi)]: each shard's contiguous slice of `rows`
        batch rows, whole units of `unit` rows (sharded.shard_slices)."""
        return [(self.shards[i], lo, hi) for i, (lo, hi) in
                enumerate(shard_slices(rows, len(self.shards), unit))]

    def _to_device(self, arr, device=None) -> torch.Tensor:
        """A host array or tensor as a tensor on `device` (the first
        shard's by default).  On the GPU a page-locked tensor is copied
        asynchronously (the caller must not rewrite it before the batch
        is collected) and anything else is a pageable copy; on the CPU
        device it is the same memory."""
        if isinstance(arr, torch.Tensor):
            t = arr.contiguous()
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        if not self._on_gpu:
            return t
        return t.to(self.device if device is None else device,
                    non_blocking=t.is_pinned())

    def synchronize(self) -> None:
        """Wait for everything queued on the codec's streams."""
        if self._on_gpu:
            for d in self._devices:
                torch.cuda.current_stream(d).synchronize()

    @staticmethod
    def _head(parts: List[torch.Tensor], rows: int) -> List[torch.Tensor]:
        """The first `rows` rows of a result's shard tensors."""
        out, r0 = [], 0
        for t in parts:
            out.append(t[:max(0, min(t.shape[0], rows - r0))])
            r0 += t.shape[0]
        return out

    def _fetch(self, *values: List[torch.Tensor],
               rows: Optional[int] = None) -> List[np.ndarray]:
        """Device results as host arrays the caller owns, each value's
        shard tensors joined in lane order (its first `rows` rows when
        given).  On the GPU the D2H copies go into one reusable
        page-locked buffer, queued on each device's stream behind the
        kernels, and are then copied out; the two steps are timed as
        collect_d2h and collect_copy_out.  On the CPU device the tensors'
        own memory (joined when there are several)."""
        if rows is not None:
            values = tuple(self._head(v, rows) for v in values)
        if not self._on_gpu:
            return [v[0].numpy() if len(v) == 1 else torch.cat(v).numpy()
                    for v in values]
        shapes = [(sum(t.shape[0] for t in v),) + tuple(v[0].shape[1:])
                  for v in values]
        sizes = [int(np.prod(s)) * v[0].element_size()
                 for s, v in zip(shapes, values)]
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
            views, devs = [], {}
            for v, shape, o, n in zip(values, shapes, offs, sizes):
                view = buf[o:o + n].view(v[0].dtype).view(shape)
                r0 = 0
                for t in v:
                    view[r0:r0 + t.shape[0]].copy_(t, non_blocking=True)
                    r0 += t.shape[0]
                    devs[t.device] = None
                views.append(view)
            events = []
            for d in devs:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(d))
                events.append(ev)
            for ev in events:
                ev.synchronize()
            t1 = time.perf_counter()
            out = [v.numpy().copy() for v in views]
            t2 = time.perf_counter()
        self.obs.observe_stage("collect_d2h", "tpu", t1 - t0)
        self.obs.observe_stage("collect_copy_out", "tpu", t2 - t1)
        return out

    def _record(self, device) -> Optional[torch.cuda.Event]:
        """An event recorded on `device`'s current stream (None off the
        GPU)."""
        if not self._on_gpu:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        return ev

    def _mark_adopt(self, kind: str, shape) -> None:
        self.last_adopt_ns = time.monotonic_ns()
        key = (kind, tuple(shape))
        self.last_submit_compiled = key not in self._dispatched_shapes
        self._dispatched_shapes.add(key)

    def _mark_ready(self, events) -> None:
        """Wait for every shard's event of the dispatch, then stamp the
        ready boundary: what follows in a collect is device→host copy and
        reassembly."""
        t0 = time.perf_counter()
        for event in events:
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

    def _gf_shards(self, parts, K_on, cols: Optional[int] = None) -> DeviceOut:
        """The GF apply of each shard's (b, k, S) slab with the constants
        on its device, an event recorded after each; rows trimmed to
        `cols` bytes when given."""
        outs, events = [], []
        for d in parts:
            out = self._gf(d, K_on[d.device])
            outs.append(out if cols is None else out[..., :cols])
            events.append(self._record(d.device))
        return DeviceOut(outs, events)

    # --- the transport device API ---

    def staging_geometry(self, nlanes: int, maxlen: int,
                         kind: str) -> Tuple[int, int]:
        """(lanes, row_bytes) to stage for `nlanes` blocks of up to
        `maxlen` bytes: power-of-two bucketing, lanes a multiple of the
        shard count and, for scrub and encode, of whole codewords per
        shard."""
        cols = self._bucket(max(maxlen, 1))
        lanes = self._batch_size(max(nlanes, 1))
        if kind in ("scrub", "encode"):
            lanes += (-lanes) % self._lane_align()
        return lanes, cols

    def probe_submit(self, arr) -> DeviceOut:
        """Upload a staged buffer and reduce it to device scalars, one per
        shard, that depend on every byte (the link probe's round trip)."""
        parts = [self._to_device(arr[lo:hi], d)
                 for d, lo, hi in self._split(arr.shape[0])]
        self._mark_adopt("probe", arr.shape)
        sums, events = [], []
        for p in parts:
            sums.append(p.reshape(-1).sum(dtype=torch.int64))
            events.append(self._record(p.device))
        return DeviceOut(sums, events)

    def probe_collect(self, handle: DeviceOut) -> int:
        self._mark_ready(handle.events)
        return sum(int(s.item()) for s in handle.value)

    def hash_submit(self, arr, lengths: np.ndarray) -> DeviceOut:
        """Enqueue a staged (lanes, row_bytes) hash batch (numpy or a
        host tensor) without synchronising."""
        lengths = np.asarray(lengths, dtype=np.int32)
        with self.obs.stage("h2d_transfer", "tpu"):
            parts = [(self._to_device(arr[lo:hi], d),
                      self._to_device(lengths[lo:hi], d))
                     for d, lo, hi in self._split(arr.shape[0])]
        self._mark_adopt("hash", arr.shape)
        with self.obs.stage("kernel_dispatch", "tpu"):
            digests, events = [], []
            for da, dl in parts:
                digests.append(blake2s_batch(da, dl))
                events.append(self._record(da.device))
            return DeviceOut(digests, events)

    def hash_collect(self, handle: DeviceOut, n: int) -> List[Hash]:
        self._mark_ready(handle.events)
        h, = self._fetch(handle.value, rows=n)
        return [Hash(d) for d in digests_to_bytes(h)]

    def encode_submit(self, groups) -> DeviceOut:
        """Enqueue RS parity for staged (B, k, S) codeword groups (S a
        multiple of 4, as staging_geometry's bucketing guarantees)."""
        if groups.shape[-1] % 4:
            raise ValueError(f"row bytes must be a multiple of 4: {groups.shape}")
        flat = groups.reshape(-1, groups.shape[-2], groups.shape[-1])
        with self.obs.stage("h2d_transfer", "tpu"):
            parts = [self._to_device(flat[lo:hi], d)
                     for d, lo, hi in self._split(flat.shape[0])]
        self._mark_adopt("encode", groups.shape)
        with self.obs.stage("kernel_dispatch", "tpu"):
            return self._gf_shards(parts, self._K_enc_on)

    def encode_collect(self, handle: DeviceOut) -> np.ndarray:
        self._mark_ready(handle.events)
        return self._fetch(handle.value)[0]

    def decode_submit(self, shards: np.ndarray, present: Sequence[int],
                      rows: Optional[Sequence[int]] = None) -> DeviceOut:
        """Enqueue one survivor-pattern decode over staged (B, p, S)
        shards without synchronising."""
        k = self.params.rs_data
        key, K_on = self._decode_consts(present, rows)
        sub = shards[..., :k, :]
        s = sub.shape[-1]
        pad = (-s) % 4
        if pad:
            sub = np.pad(sub, [(0, 0)] * (sub.ndim - 1) + [(0, pad)])
        flat = sub.reshape(-1, k, sub.shape[-1])
        with self.obs.stage("h2d_transfer", "tpu"):
            parts = [self._to_device(flat[lo:hi], d)
                     for d, lo, hi in self._split(flat.shape[0])]
        self._mark_adopt("decode", (*sub.shape, *key[0]))
        with self.obs.stage("kernel_dispatch", "tpu"):
            out = self._gf_shards(parts, K_on, cols=s)
        return out._replace(lead=tuple(sub.shape[:-2]))

    def decode_collect(self, handle: DeviceOut) -> np.ndarray:
        self._mark_ready(handle.events)
        out = self._fetch(handle.value)[0]
        return out.reshape(handle.lead + out.shape[-2:])

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
        """Lane-count divisor: whole codewords (k) on every shard (k x
        the shard count), as the reference aligns to k x its mesh."""
        return max(1, self.params.rs_data) * len(self.shards)

    def _batch_size(self, n: int) -> int:
        bsz = self._bucket(n, 8)
        return bsz + (-bsz) % len(self.shards)

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
        expected = self._expected(arr.shape[0], hashes).view(np.int32)
        with self.obs.stage("h2d_transfer", "tpu"):
            parts = [(self._to_device(arr[lo:hi], d),
                      self._to_device(lengths[lo:hi], d),
                      self._to_device(expected[lo:hi], d))
                     for d, lo, hi in self._split(arr.shape[0])]
        with self.obs.stage("kernel_dispatch", "tpu"):
            oks, events = [], []
            for da, dl, de in parts:
                oks.append((blake2s_batch(da, dl) == de).all(dim=1))
                events.append(self._record(da.device))
        self._mark_ready(events)
        return to_host(oks)[: len(blocks)]

    # --- Reed-Solomon ---

    def _flat_padded(self, arr: np.ndarray) -> Tuple[np.ndarray, int]:
        """Leading dims flattened to one batch axis, padded with zero
        codewords to a split batch (_batch_size) when there are several
        shards, as the reference pads for its mesh; and the true count."""
        flat = np.asarray(arr, dtype=np.uint8).reshape((-1,) + arr.shape[-2:])
        n = flat.shape[0]
        if len(self.shards) > 1 and self._batch_size(n) != n:
            flat = np.concatenate([flat, np.zeros(
                (self._batch_size(n) - n,) + flat.shape[1:], np.uint8)])
        return flat, n

    def _gf_host(self, flat: np.ndarray, K_on) -> np.ndarray:
        """(N, k, S) uint8 host slabs through the GF kernel, split over
        the shards; S padded to a multiple of 4 for the uint32 view, the
        result trimmed back."""
        s = flat.shape[-1]
        pad = (-s) % 4
        if pad:
            flat = np.pad(flat, [(0, 0)] * (flat.ndim - 1) + [(0, pad)])
        parts = [self._to_device(flat[lo:hi], d)
                 for d, lo, hi in self._split(flat.shape[0])]
        return to_host(self._gf_shards(parts, K_on).value)[..., :s]

    def rs_encode(self, data: np.ndarray) -> np.ndarray:
        if data.shape[-2] != self.params.rs_data:
            raise ValueError(f"expected k={self.params.rs_data} data shards, "
                             f"got {data.shape}")
        lead = data.shape[:-2]
        flat, n = self._flat_padded(data)
        out = self._gf_host(flat, self._K_enc_on)[:n]
        return out.reshape(lead + out.shape[-2:])

    def rs_reconstruct(self, shards: np.ndarray, present: Sequence[int],
                       rows: Optional[Sequence[int]] = None) -> np.ndarray:
        k = self.params.rs_data
        _key, K_on = self._decode_consts(present, rows)
        lead = shards.shape[:-2]
        flat, n = self._flat_padded(shards[..., :k, :])
        out = self._gf_host(flat, K_on)[:n]
        return out.reshape(lead + out.shape[-2:])

    # --- the fused scrub ---

    def _pad_group(self, blocks: Sequence[bytes], hashes: Sequence[Hash]):
        """Pad a block group to the staged lane/byte shape: (arr, lengths,
        expected), lanes aligned to whole codewords on every shard, pad
        lanes carrying the empty-message digest."""
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
        the same buffer, all on the current stream of data's device with
        no host sync."""
        K = self._K_enc_on[data.device] if self._enc_mat is not None else None
        out = scrub_composition(data, lengths, expected, K,
                                self.params.rs_data, blake2s_batch, gf_apply)
        if self._on_gpu:
            global fused_launches
            with _count_lock:
                fused_launches += 1
        return out

    def _fused_shards(self, parts) -> ScrubOut:
        """The fused scrub of each shard's (data, lengths, expected) on
        its device, an event recorded after each; the corrupt count
        summed on the first shard's device."""
        results, events = [], []
        for da, dl, de in parts:
            results.append(self.fused_scrub(da, dl, de))
            events.append(self._record(da.device))
        digests, ok, bad, parity = (list(x) for x in zip(*results))
        total = bad[0] if len(bad) == 1 else torch.stack(
            [b.to(self.device) for b in bad]).sum(dtype=torch.int32)
        return ScrubOut(digests, ok, total,
                        None if parity[0] is None else parity, events)

    def scrub_encode_submit(self, arr, lengths: np.ndarray,
                            expected: np.ndarray) -> ScrubOut:
        """One fused dispatch per shard for a staged batch: hash every
        lane, compare with `expected`, count corrupt lanes, and compute
        RS(k, m) parity for each group of k lanes.  Returns device results
        without synchronising; scrub_collect waits on the events."""
        k = self.params.rs_data
        if (k and arr.shape[0] % k) or arr.shape[1] % 4:
            raise ValueError(f"staged batch {arr.shape} needs lanes in whole "
                             f"codewords of {k} and rows a multiple of 4")
        lengths = np.asarray(lengths, dtype=np.int32)
        expected = np.ascontiguousarray(expected, dtype=np.uint32).view(
            np.int32)
        with self.obs.stage("h2d_transfer", "tpu"):
            parts = [(self._to_device(arr[lo:hi], d),
                      self._to_device(lengths[lo:hi], d),
                      self._to_device(expected[lo:hi], d))
                     for d, lo, hi in self._split(arr.shape[0], max(1, k))]
        self._mark_adopt("scrub", arr.shape)
        with self.obs.stage("kernel_dispatch", "tpu"):
            out = self._fused_shards(parts)
        self.last_submit_variant = "cuda" if self._on_gpu else "plain"
        return out

    def scrub_collect(self, out: ScrubOut, fetch_parity: bool):
        """Materialise one scrub_encode_submit result: (ok full-lane bool
        array, parity full array | None)."""
        self._mark_ready(out.events)
        if fetch_parity and out.parity is not None:
            return tuple(self._fetch(out.ok, out.parity))
        return self._fetch(out.ok)[0], None

    # --- the DevicePool API (ops/device_pool.py) ---
    #
    # Pool-aware scrub: only MISS lanes cross the link (one compact H2D
    # upload per shard scattered into a zeroed device slice); resident
    # lanes are composed from pool pages, which already live on a card.
    # The composed batch runs the same fused scrub as the plain path, so
    # pool-served lanes are re-verified against their expected digests
    # on every read.

    def scrub_encode_submit_resident(self, miss_arr, miss_rows,
                                     lengths: np.ndarray,
                                     expected: np.ndarray, resident):
        """Returns (ScrubOut, composed device batch): the batch is what
        pool_adopt cuts verified miss lanes out of, one tensor, or with
        several shards the list of their slices.  miss_arr holds the miss
        lanes in order (numpy or a host tensor), miss_rows their lanes in
        the batch, increasing, resident (lane, pages, length) triples."""
        lanes = int(lengths.shape[0])
        cols = int(miss_arr.shape[1])
        k = self.params.rs_data
        if (k and lanes % k) or cols % 4:
            raise ValueError(f"staged batch ({lanes}, {cols}) needs lanes in "
                             f"whole codewords of {k} and rows a multiple of 4")
        rows = np.asarray(miss_rows, dtype=np.int64)
        if (np.diff(rows) <= 0).any():
            raise ValueError("miss_rows must increase")
        lengths = np.asarray(lengths, dtype=np.int32)
        expected = np.ascontiguousarray(expected, dtype=np.uint32).view(
            np.int32)
        parts = []
        with self.obs.stage("h2d_transfer", "tpu"):
            for d, lo, hi in self._split(lanes, max(1, k)):
                full = torch.zeros((hi - lo, cols), dtype=torch.uint8,
                                   device=d)
                a, b = np.searchsorted(rows, (lo, hi))
                if b > a:
                    dm = self._to_device(miss_arr[a:b], d)
                    idx = self._to_device(rows[a:b] - lo, d)
                    full.index_copy_(0, idx, dm)
                parts.append((full, self._to_device(lengths[lo:hi], d),
                              self._to_device(expected[lo:hi], d)))
        fulls = [p[0] for p in parts]
        if resident:
            per = fulls[0].shape[0]
            by_shard = {}
            for r, pgs, n in resident:
                by_shard.setdefault(int(r) // per, []).append(
                    (int(r) % per, pgs, n))
            for i, res in by_shard.items():
                self._compose_resident(fulls[i], res)
        self._mark_adopt("scrub", (lanes, cols))
        with self.obs.stage("kernel_dispatch", "tpu"):
            out = self._fused_shards(parts)
        self.last_submit_variant = "cuda" if self._on_gpu else "plain"
        return out, fulls[0] if len(fulls) == 1 else fulls

    def _compose_resident(self, full: torch.Tensor, resident) -> None:
        """Write pool-resident lanes into one shard's device slice from
        their pages (copied device to device when a page lives on another
        device).  When rows are whole pages, every page of the slice
        lands with one stack and one indexed write."""
        lanes, cols = full.shape
        pb = int(resident[0][1][0].numel())
        move = len(self._devices) > 1
        if cols % pb == 0:
            rows, cols_at, pages = [], [], []
            for r, pgs, _n in resident:
                for j, pg in enumerate(pgs):
                    rows.append(int(r))
                    cols_at.append(j)
                    pages.append(pg.to(full.device) if move else pg)
            ri = torch.tensor(rows, dtype=torch.int64, device=full.device)
            ci = torch.tensor(cols_at, dtype=torch.int64, device=full.device)
            full.view(lanes, cols // pb, pb)[ri, ci] = torch.stack(pages)
            return
        for r, pgs, _n in resident:
            row = torch.cat([pg.to(full.device) if move else pg
                             for pg in pgs])[:cols]
            full[int(r), :row.numel()] = row

    def pool_adopt(self, input_ref, lane: int, length: int,
                   page_bytes: int) -> List[torch.Tensor]:
        """Cut one verified lane of a composed batch (a tensor, or the
        list of shard slices) into fixed-size device pages on the lane's
        device, the tail page zero-padded past the row.  Each page is a
        device-to-device copy with its own storage: a view would keep
        the whole batch alive behind one page, and the pool's byte budget
        would no longer bound its device memory."""
        parts = input_ref if isinstance(input_ref, list) else [input_ref]
        per = parts[0].shape[0]
        row = parts[int(lane) // per][int(lane) % per]
        pb = int(page_bytes)
        npages = max(1, -(-int(length) // pb))
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
        synchronising.  Returns (ok, parity, n): each result as its
        shards' device tensors in lane order (sharded.to_host joins them,
        waiting for the kernels) and the true block count."""
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
