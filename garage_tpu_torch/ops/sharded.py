"""The batch split over several devices, and the GF(2) bit-matrix apply.

Counterpart of ``garage_tpu/ops/tpu_codec.py``'s multi-device pieces:

  - ``unpack_bits`` / ``pack_bits`` / ``gf_bitmatmul`` (``:41-68``): a
    GF(2) bit-matrix applied to (B, k, S) byte shards as an int8 x int8
    → int32 product, parity = count & 1.  ``w_bits`` may be any 0/1
    matrix (k·8, r·8), not only the bit-matrix of a GF(2^8) matrix, so
    this is a matrix product and not the GF kernel (K2).  In the
    reference it is a plain ``dot_general`` outside any Pallas kernel;
    here the card runs it as one ``torch._int_mm`` (int8 tensor cores,
    exact int32 sums) between tensor-op unpack and pack, and the CPU
    runs ``gf_bitmatmul_plain``, an int32 ``torch.matmul``.  It moves
    far more than its bytes bound: the unpacked bits are 8x the shards
    and the int32 sums 32x the parity.
  - ``verify_kernel`` (``:141``): the batched BLAKE2s (K1), the digest
    compare and the corrupt count.
  - ``sharded_fns(devices)`` (``:937-968``): ``verify`` and ``rs_encode``
    with the batch axis cut into one contiguous slice per device; the
    corrupt count is the sum of the slices' counts on ``devices[0]``
    (the reference's psum).  A batch the device count does not divide
    is refused, as the reference's jit refuses it.

``shard_slices`` is the one rule by which a batch is cut (CudaCodec's
split uses it too), and ``to_host`` brings per-slice results back as
one host array in lane order.

A device list may repeat a device: several slices then run one after
another on that device's current stream.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .cuda_blake2s import blake2s_batch

# torch._int_mm takes more than 16 rows
_INT_MM_MIN_ROWS = 17

# gf_bitmatmul products on a CUDA device
launches = 0
_count_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def shard_slices(rows: int, n: int, unit: int = 1) -> List[Tuple[int, int]]:
    """[(lo, hi)] of shard i = 0..n-1: `rows` cut into contiguous slices
    of ``per`` rows, ``per`` the least multiple of `unit` with n * per >=
    rows, so every slice is whole units and all but the last are equal.
    Slices past the end are dropped, except the first (an empty batch
    still has one, empty, slice)."""
    per = unit * -(-rows // (unit * n)) if rows else 0
    return [(i * per, min((i + 1) * per, rows)) for i in range(n)
            if i == 0 or i * per < rows]


def to_host(parts: Sequence[torch.Tensor]) -> np.ndarray:
    """Per-slice result tensors as one host array in lane order (a
    pageable copy, which waits for the work that produces them)."""
    if len(parts) == 1:
        return parts[0].cpu().numpy()
    return np.concatenate([p.cpu().numpy() for p in parts])


def unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """uint8 (..., n) → int8 (..., n*8) bits, LSB-first."""
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    bits = (x.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(x.shape[:-1] + (-1,)).to(torch.int8)


def pack_bits(b: torch.Tensor) -> torch.Tensor:
    """0/1 bits (..., n*8) of any integer type → uint8 (..., n),
    LSB-first."""
    g = b.reshape(b.shape[:-1] + (-1, 8)).to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=b.device)
    return (g * weights).sum(dim=-1, dtype=torch.int32).to(torch.uint8)


def _check_bitmatmul(shards: torch.Tensor, w_bits: torch.Tensor) -> None:
    if shards.dtype != torch.uint8 or shards.dim() != 3:
        raise ValueError(f"shards must be (B, k, S) uint8, got {shards.dtype} "
                         f"{tuple(shards.shape)}")
    k = shards.shape[1]
    if (w_bits.dtype != torch.int8 or w_bits.dim() != 2
            or w_bits.shape[0] != k * 8 or w_bits.shape[1] % 8
            or w_bits.device != shards.device):
        raise ValueError(f"w_bits must be int8 ({k * 8}, r*8) on "
                         f"{shards.device}, got {w_bits.dtype} "
                         f"{tuple(w_bits.shape)} on {w_bits.device}")


def _bitmatmul(shards: torch.Tensor, w_bits: torch.Tensor,
               product: Callable) -> torch.Tensor:
    """The reference's three steps with `product` (int8 (M, k*8), int8
    (k*8, r*8)) → int32 (M, r*8) as the contraction."""
    b, k, s = shards.shape
    r = w_bits.shape[1] // 8
    bits = unpack_bits(shards.transpose(1, 2)).reshape(b * s, k * 8)
    acc = product(bits, w_bits)
    out = pack_bits(acc & 1).view(b, s, r)
    return out.transpose(1, 2).contiguous()


def _int32_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.to(torch.int32), w.to(torch.int32))


def _int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 tensor-core product with int32 sums, `w` passed column-major:
    on an H100 (torch 2.11) cuBLASLt refuses a row-major (64, 32) `w`
    at small row counts (CUBLAS_STATUS_NOT_SUPPORTED) and takes the
    column-major one; rows zero-padded to the 17 it needs."""
    m = a.shape[0]
    if m < _INT_MM_MIN_ROWS:
        a = torch.cat([a, a.new_zeros((_INT_MM_MIN_ROWS - m, a.shape[1]))])
    return torch._int_mm(a, w.t().contiguous().t())[:m]


def gf_bitmatmul_plain(shards: torch.Tensor,
                       w_bits: torch.Tensor) -> torch.Tensor:
    """Plain version: shards (B, k, S) uint8, w_bits (k*8, r*8) int8 →
    (B, r, S) uint8, the contraction an int32 torch.matmul."""
    _check_bitmatmul(shards, w_bits)
    return _bitmatmul(shards, w_bits, _int32_matmul)


def gf_bitmatmul(shards: torch.Tensor, w_bits: torch.Tensor) -> torch.Tensor:
    """Apply a GF(2) bit-matrix to byte shards: (B, k, S) uint8 and
    (k*8, r*8) int8 on one device → (B, r, S) uint8.  On the CPU the
    plain version; on a CUDA device torch._int_mm, or it raises."""
    if shards.device.type == "cpu":
        return gf_bitmatmul_plain(shards, w_bits)
    if shards.device.type != "cuda":
        raise ValueError(f"unsupported device {shards.device}")
    _check_bitmatmul(shards, w_bits)
    out = _bitmatmul(shards, w_bits, _int_mm)
    global launches
    with _count_lock:
        launches += 1
    return out


def verify_kernel(data: torch.Tensor, lengths: torch.Tensor,
                  expected: torch.Tensor):
    """Batched hash + compare on one device: data (B, C*64) uint8,
    lengths (B,) int32, expected (B, 8) int32 (the uint32 digest words)
    → (digests (B, 8) int32, ok (B,) bool, corrupt count () int32)."""
    h = blake2s_batch(data, lengths)
    ok = (h == expected).all(dim=1)
    return h, ok, (~ok).sum(dtype=torch.int32)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(x)


def sharded_fns(devices: Sequence) -> Dict[str, Callable]:
    """{"verify", "rs_encode"} over `devices` (torch devices or their
    names; repeats allowed), each taking host arrays or tensors:

      verify(data, lengths, expected) → (digests, ok, bad): digests and
        ok as per-device tensors in lane order, bad the summed corrupt
        count, a () int32 tensor on devices[0];
      rs_encode(shards, w_bits) → per-device (B/n, r, S) uint8 parity
        tensors in codeword order.

    ``to_host`` joins per-device results.  The batch axis must divide by
    the device count."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("sharded_fns needs at least one device")
    n = len(devs)

    def split(rows: int):
        if rows % n:
            raise ValueError(f"batch of {rows} does not divide over "
                             f"{n} devices")
        return [(d, lo, hi) for d, (lo, hi) in
                zip(devs, shard_slices(rows, n))]

    def verify(data, lengths, expected):
        data, lengths = _as_tensor(data), _as_tensor(lengths)
        expected = _as_tensor(expected)
        digests, oks, bads = [], [], []
        for d, lo, hi in split(data.shape[0]):
            h, ok, bad = verify_kernel(data[lo:hi].to(d), lengths[lo:hi].to(d),
                                       expected[lo:hi].to(d))
            digests.append(h)
            oks.append(ok)
            bads.append(bad.to(devs[0]))
        return digests, oks, torch.stack(bads).sum(dtype=torch.int32)

    def rs_encode(shards, w_bits):
        shards, w_bits = _as_tensor(shards), _as_tensor(w_bits)
        w_on = {}
        out = []
        for d, lo, hi in split(shards.shape[0]):
            if d not in w_on:
                w_on[d] = w_bits.to(d)
            out.append(gf_bitmatmul(shards[lo:hi].to(d), w_on[d]))
        return out

    return {"verify": verify, "rs_encode": rs_encode}
