"""Batched BLAKE2s-256 on the card: the wrapper of ``csrc/blake2s.cu``.

Counterpart of ``garage_tpu/ops/pallas_blake2s.py`` (``blake2s_batch_pallas``
over the Pallas kernel ``_kernel``).  Same contract: (B, C*64) uint8
zero-padded messages and (B,) byte lengths in, (B, 8) digests out, here
as int32 tensors holding the uint32 words.  The TPU wrapper's
``B % 128 == 0`` rule was a lane-tile rule and is gone: any B works.

A tensor on the CPU takes the plain version (``ops/blake2s.py``); a
tensor on a CUDA device launches the kernel on the current stream, or
raises.  ``launches`` counts kernel launches.  ``g_chain_cycles`` measures
the dependent-issue latency behind the kernel's dependency bound.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from .blake2s import blake2s_batch_plain

launches = 0
_count_lock = threading.Lock()
_configured = False


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def _lib() -> ctypes.CDLL:
    global _configured
    lib = _build.load("blake2s")
    if not _configured:
        lib.blake2s_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        lib.blake2s_launch.restype = ctypes.c_int
        lib.blake2s_chain_probe_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p]
        lib.blake2s_chain_probe_launch.restype = ctypes.c_int
        _configured = True
    return lib


# the chain probe's two lengths in G: their difference cancels the fixed
# cost of a launch and of reading the clock
PROBE_G = (1024, 1024 + 65536)


def g_chain_cycles(device) -> float:
    """SM clock cycles per G of the kernel's G when each G waits on the
    one before (12 dependent instructions: two three-input adds, four
    xors, four rotates, two adds), measured on `device` by the source's
    chain probe: one warp, at the two lengths of PROBE_G, the difference
    of their cycles over the difference of the lengths.  Not a kernel of
    the codec's path: its launches are not counted.  Needs a CUDA
    device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the chain probe runs on a CUDA device, not {device}")
    gen = torch.Generator().manual_seed(5)
    seed = torch.randint(-2**31, 2**31, (32, 6), dtype=torch.int32,
                         generator=gen).to(device)
    out = torch.empty(32, dtype=torch.int32, device=device)
    lib = _lib()
    cycles = []
    with torch.cuda.device(device):
        for n in PROBE_G:
            cyc = torch.zeros(1, dtype=torch.int64, device=device)
            rc = lib.blake2s_chain_probe_launch(
                seed.data_ptr(), out.data_ptr(), cyc.data_ptr(), n,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"chain_probe_kernel launch failed: "
                                   f"cudaError {rc}")
            cycles.append(int(cyc.item()))
    return (cycles[1] - cycles[0]) / (PROBE_G[1] - PROBE_G[0])


def _threads(nmsg: int) -> int:
    # one warp per block spreads a small batch's warps over as many SMs
    # as possible (each message is one sequential thread); wide batches
    # take bigger blocks
    return 32 if nmsg <= 132 * 32 else 128


def blake2s_batch(data_u8: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """data_u8 (B, C*64) uint8 contiguous, lengths (B,) int32 contiguous
    on the same device → (B, 8) int32 digests (uint32 bits)."""
    if data_u8.device.type == "cpu":
        return blake2s_batch_plain(data_u8, lengths)
    if data_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {data_u8.device}")
    if data_u8.dtype != torch.uint8 or data_u8.dim() != 2:
        raise ValueError(f"data must be 2-D uint8, got {data_u8.dtype} "
                         f"{tuple(data_u8.shape)}")
    bsz, total = data_u8.shape
    if total == 0 or total % 64:
        raise ValueError(f"row bytes {total} must be a positive multiple of 64")
    if (lengths.dtype != torch.int32 or tuple(lengths.shape) != (bsz,)
            or lengths.device != data_u8.device):
        raise ValueError(f"lengths must be int32 ({bsz},) on {data_u8.device}, "
                         f"got {lengths.dtype} {tuple(lengths.shape)} on "
                         f"{lengths.device}")
    if not (data_u8.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("data and lengths must be contiguous")
    if data_u8.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned")
    out = torch.empty((bsz, 8), dtype=torch.int32, device=data_u8.device)
    if bsz == 0:
        return out
    lib = _lib()
    with torch.cuda.device(data_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.blake2s_launch(data_u8.data_ptr(), lengths.data_ptr(),
                                out.data_ptr(), bsz, total, _threads(bsz),
                                stream)
    if rc != 0:
        raise RuntimeError(f"blake2s_kernel launch failed: cudaError {rc}")
    global launches
    with _count_lock:
        launches += 1
    return out
