"""GF(2^8) matrix apply on the card: the wrapper of ``csrc/gf_apply.cu``.

Counterpart of ``garage_tpu/ops/pallas_gf.py``.  ``CudaGf`` keeps
``PallasGf``'s contract, (B, k, S4) uint32 slabs in, (B, r, S4) out (here
int32 tensors holding the uint32 bits), and one CUDA kernel serves both
of the Pallas dispatch regimes (``_apply_batched`` for wide shards,
``_apply_flat`` for narrow ones): it indexes (codeword, column) directly.

Math, bit-identical to ``reference_apply`` (numpy, byte domain):
  out[c, p] = XOR_{i<k, b<8} ((x[c, i] >> b) & 0x01010101) * K[p, i, b]
with K[p, i, b] = gfmul(M[p, i], 2^b) from ``gf_scalar_consts``.  The
kernel computes the same sum as mask(x, b) & (K * 0x01010101), mask
holding 0xFF in each byte whose bit b is set (see its source note).

The kernel is compiled for each (k, r) in ``INSTANTIATIONS`` (the port's
encode, degraded-read and full-decode shapes at RS(8,4) and RS(4,2), read
from the kernel's source, which holds the one list of them); any
other (k, r), or ``runtime=True``, takes its runtime-(k, r) body
(``instantiation`` names the choice).  A tensor on the CPU takes the
plain version (``gf_apply_plain``); a tensor on a CUDA device launches
the kernel on the current stream, or raises.  ``launches`` counts kernel
launches, ``launches_by`` counts them per instantiation.
"""

from __future__ import annotations

import ctypes
import re
import threading
from typing import Dict

import numpy as np
import torch

from . import _build, gf256
from .blake2s import i32_to_u32, u32_to_i32

def _instantiations() -> tuple:
    """The (k, r) compiled with both fixed, as the kernel's source lists
    them in its GF_APPLY_INSTANTIATIONS macro (the one list of them)."""
    text = (_build.CSRC / "gf_apply.cu").read_text()
    body = re.search(r"#define GF_APPLY_INSTANTIATIONS\(X\)\s*\\\s*\n(.*)\n",
                     text)
    if body is None:
        raise RuntimeError("csrc/gf_apply.cu defines no GF_APPLY_INSTANTIATIONS")
    return tuple((int(k), int(r)) for k, r in
                 re.findall(r"X\((\d+),\s*(\d+)\)", body.group(1)))


# encode at RS(8,4) and RS(4,2), degraded-read decode of 1..m rows and the
# full decode (r = k) at k = 8 and k = 4
INSTANTIATIONS = _instantiations()
RUNTIME = "runtime"
ALIGN = 16          # bytes: the kernel reads and writes 16-byte columns

launches = 0
launches_by: Dict[str, int] = {}
_count_lock = threading.Lock()
_configured = False


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0
        launches_by.clear()


def instantiation(k: int, r: int, runtime: bool = False) -> str:
    """Which body of the kernel a (k, r) apply launches: "k{k}r{r}" for
    an instantiated pair, else (or when `runtime`) "runtime"."""
    if runtime or (k, r) not in INSTANTIATIONS:
        return RUNTIME
    return f"k{k}r{r}"


def gf_scalar_consts(mat: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix (r, k) → (r, k, 8) uint32 scalar constants
    gfmul(mat[p, i], 2^b) for the multiply-form kernel."""
    r, k = mat.shape
    K = np.zeros((r, k, 8), np.uint32)
    for p in range(r):
        for i in range(k):
            for b in range(8):
                K[p, i, b] = gf256.gf_mul(int(mat[p, i]), 1 << b)
    return K


def consts_from_numpy(K: np.ndarray, device) -> torch.Tensor:
    """The device constants for the kernel from a numpy array: an (r, k)
    GF(2^8) matrix (parity or decode matrix), the (r, k, 8) scalar
    constants of ``gf_scalar_consts``, or the byte-replicated (r, k, 8)
    mask constants of the XLA formulation (c * 0x01010101).  Returns an
    (r, k, 8) int32 tensor on `device`."""
    K = np.asarray(K)
    if K.ndim == 2:
        K = gf_scalar_consts(K.astype(np.uint8))
    if K.ndim != 3 or K.shape[-1] != 8:
        raise ValueError(f"expected an (r, k) matrix or (r, k, 8) constants, "
                         f"got shape {K.shape}")
    K = K.astype(np.uint32)
    low = K & np.uint32(0xFF)
    if (K >= 256).any():
        if not (K == low * np.uint32(0x01010101)).all():
            raise ValueError("constants are neither scalar (< 256) nor "
                             "byte-replicated")
        K = low
    return torch.from_numpy(K.astype(np.int32)).to(device).contiguous()


def gf_apply_plain(x: torch.Tensor, consts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x (B, k, S4) int32, consts (r, k, 8) int32
    → (B, r, S4) int32.  Same loop as the kernel, vectorised over
    codewords, output rows and columns; int64 inside (uint32 values)."""
    b, k, s4 = x.shape
    r = consts.shape[0]
    xu = i32_to_u32(x)
    cu = i32_to_u32(consts.to(x.device))
    acc = torch.zeros((b, r, s4), dtype=torch.int64, device=x.device)
    for i in range(k):
        xi = xu[:, i]
        for bit in range(8):
            m1 = ((xi >> bit) & 0x01010101)[:, None, :]
            acc ^= m1 * cu[:, i, bit][None, :, None]
    return u32_to_i32(acc)


def _lib() -> ctypes.CDLL:
    global _configured
    lib = _build.load("gf_apply")
    if not _configured:
        lib.gf_apply_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.gf_apply_launch.restype = ctypes.c_int
        _configured = True
    return lib


def check_args(x: torch.Tensor, consts: torch.Tensor) -> None:
    """Raise ValueError unless the kernel takes these arguments: x
    (B, k, S4) int32, contiguous and 16-byte aligned, consts (r, k, 8)
    int32 contiguous on x's device."""
    if x.dtype != torch.int32 or x.dim() != 3:
        raise ValueError(f"x must be 3-D int32, got {x.dtype} {tuple(x.shape)}")
    k = x.shape[1]
    if (consts.dtype != torch.int32 or consts.dim() != 3
            or consts.shape[1] != k or consts.shape[2] != 8
            or consts.device != x.device):
        raise ValueError(f"consts must be int32 (r, {k}, 8) on {x.device}, got "
                         f"{consts.dtype} {tuple(consts.shape)} on "
                         f"{consts.device}")
    if not (x.is_contiguous() and consts.is_contiguous()):
        raise ValueError("x and consts must be contiguous")
    if x.data_ptr() % ALIGN:
        raise ValueError(f"x must be {ALIGN}-byte aligned")


def gf_apply(x: torch.Tensor, consts: torch.Tensor,
             runtime: bool = False) -> torch.Tensor:
    """x (B, k, S4) int32 contiguous, consts (r, k, 8) int32 contiguous
    on the same device → (B, r, S4) int32.  On the card, the (k, r)
    instantiation or, for any other pair or with `runtime`, the
    runtime-(k, r) body."""
    if x.device.type == "cpu":
        return gf_apply_plain(x, consts)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    check_args(x, consts)
    b, k, s4 = x.shape
    r = consts.shape[0]
    out = torch.empty((b, r, s4), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    body = instantiation(k, r, runtime)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_apply_launch(x.data_ptr(), consts.data_ptr(),
                                 out.data_ptr(), b, s4, k, r,
                                 int(body == RUNTIME), stream)
    if rc != 0:
        raise RuntimeError(f"gf_apply_kernel ({body}) launch failed: "
                           f"cudaError {rc}")
    global launches
    with _count_lock:
        launches += 1
        launches_by[body] = launches_by.get(body, 0) + 1
    return out


class CudaGf:
    """Callable (B, k, S4) int32 → (B, r, S4) int32 for one GF(2^8)
    matrix (r, k), with its constants resident on `device`."""

    def __init__(self, mat: np.ndarray, device="cuda"):
        self.r, self.k = mat.shape
        self.mat = np.asarray(mat, dtype=np.uint8)
        self.consts = consts_from_numpy(self.mat, device)

    def __call__(self, shards_u32: torch.Tensor) -> torch.Tensor:
        if shards_u32.shape[1] != self.k:
            raise ValueError(f"expected k={self.k} rows, got "
                             f"{tuple(shards_u32.shape)}")
        return gf_apply(shards_u32, self.consts)


def reference_apply(mat: np.ndarray, shards_u32: np.ndarray) -> np.ndarray:
    """numpy oracle in the uint32 domain (via the byte-domain gf256
    reference)."""
    b, k, s4 = shards_u32.shape
    as_bytes = shards_u32.view("<u4").astype("<u4").tobytes()
    arr = np.frombuffer(as_bytes, dtype=np.uint8).reshape(b, k, s4 * 4)
    out = gf256.gf_matmul_blocks(mat, arr)
    return np.frombuffer(out.tobytes(), dtype="<u4").reshape(
        b, mat.shape[0], s4)
