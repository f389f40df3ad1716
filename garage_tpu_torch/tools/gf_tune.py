"""GF(2^8) kernel-variant tuning sweep on the card.

    python -m garage_tpu_torch.tools.gf_tune [--reps N] [--out FILE]

Counterpart of the reference's ``scripts/pallas_tune.py``: one group of
32 blocks of 1 MiB — 4 RS(8,4) codewords — is staged on the card folded
flat as x (k, n) = (8, 2^20) uint32, as the reference folds it
(``pallas_tune.py:184-194``), and each loop-order variant of the GF apply
(``csrc/gf_tune.cu``: orig, acc, accs) runs at each tile (the columns one
unit of the grid owns, as in the Pallas grid: 4096, 8192, 16384 words).
A tile is split over blocks of 1024 words, so every tile launches the
same 1024 blocks and fills the card (``launch_shape``).  Every launch is
checked bit for bit against the numpy GF(2^8) oracle first, then timed
with CUDA events over many launches after a warm-up, each launch after a
read of a 64 MiB scratch buffer so the 32 MiB the function reads come
from HBM, not from the 50 MB L2, and its window running on until the
16 MiB it writes are back in HBM (``tools/timing.py`` ``queued_ms``).
The production kernel (``csrc/gf_apply.cu`` through
``ops/cuda_gf.gf_apply``) runs on the same codewords as the yardstick.

Prints one JSON line: the card's name and power limit (nvidia-smi), and
for every cell its milliseconds and GiB/s (data bytes read, k x n x 4,
per second, as the reference reported), its launch shape (grid, block,
and cluster 1: no thread-block cluster), the least time its variant's
instructions need on the SMs (``issue_bound_ms``, from the SASS census
per thread under ``census``) and the ALU lanes it issued per SM per
clock at 1.98 GHz; gf_apply's time, the least time the card could take
(bytes moved over 3.35 TB/s) and the fastest cell.  Needs a CUDA
device: without one it exits non-zero and prints no result.

``gf_tune`` is the kernel's wrapper and ``gf_tune_plain`` its plain
PyTorch version, which follows each variant's loop order; a tensor on
the CPU takes the plain version, a CUDA tensor launches the kernel or
raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import _build, gf256
from ..ops.blake2s import i32_to_u32, u32_to_i32
from ..ops.cuda_gf import consts_from_numpy, gf_apply, gf_scalar_consts
from .sass import census_classes, sass_census
from .timing import (FLUSH_BYTES, HBM_BYTES_PER_S, SM_CLOCK_HZ, SMS, ops_ms,
                     queued_ms)

VARIANTS = ("orig", "acc", "accs")
TILES = (4096, 8192, 16384)
# the tiles the kernel is launched at (128 serves small test shapes)
KERNEL_TILES = (128,) + TILES
SHAPES = ((8, 4), (4, 2))       # (k, r) the kernel is built for
K, M = 8, 4
BLOCK = 1 << 20
NBLOCKS = 32                    # one group of 4 codewords, as the reference
# the launch: a tile is split over blocks of BLOCK_WORDS consecutive words
# (a smaller tile is one block), one 16-byte column (WORDS words) per
# thread, at most MAX_THREADS threads (csrc/gf_tune.cu kMaxThreads)
BLOCK_WORDS = 1024
WORDS = 4
MAX_THREADS = 256
ALIGN = 16                      # bytes: a 16-byte column of x and out

launches = 0
_count_lock = threading.Lock()
_configured = False


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def mask_consts(mat: np.ndarray) -> np.ndarray:
    """(r, k) GF(2^8) matrix → (r, k, 8) uint32 byte-replicated mask
    constants gfmul(mat[p, i], 2^b) * 0x01010101, the form the Pallas
    sweep's kernels AND with their 0xFF-per-byte masks."""
    return gf_scalar_consts(mat) * np.uint32(0x01010101)


def fold(u32: np.ndarray) -> np.ndarray:
    """(ncw, k, s4) codewords → (k, ncw * s4): row i holds data shard i
    of every codeword side by side (``pallas_tune.py:193``)."""
    return np.ascontiguousarray(np.swapaxes(u32, 0, 1).reshape(u32.shape[1], -1))


def unfold(out: np.ndarray, ncw: int) -> np.ndarray:
    """(r, ncw * s4) → (ncw, r, s4), the inverse of ``fold`` for parity."""
    r = out.shape[0]
    return np.ascontiguousarray(np.swapaxes(out.reshape(r, ncw, -1), 0, 1))


def gf_tune_plain(x: torch.Tensor, consts: torch.Tensor,
                  variant: str) -> torch.Tensor:
    """Plain PyTorch version: x (k, n) int32 and consts (r, k, 8) int32
    holding uint32 bits → (r, n) int32, in `variant`'s loop order (int64
    inside, masked to the uint32 values)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    k, n = x.shape
    r = consts.shape[0]
    xu = i32_to_u32(x)
    cu = i32_to_u32(consts.to(x.device))
    one = 0x01010101
    if variant == "orig":
        masks = [[((xu[i] >> b) & one) * 0xFF for b in range(8)]
                 for i in range(k)]
        rows = []
        for p in range(r):
            acc = torch.zeros(n, dtype=torch.int64, device=x.device)
            for i in range(k):
                for b in range(8):
                    acc ^= masks[i][b] & cu[p, i, b]
            rows.append(acc)
        return u32_to_i32(torch.stack(rows))
    accs = [torch.zeros(n, dtype=torch.int64, device=x.device)
            for _ in range(r)]
    for i in range(k):
        for b in range(8):
            m1 = (xu[i] >> b) & one
            m = m1 * 0xFF if variant == "acc" else (m1 << 8) - m1
            for p in range(r):
                accs[p] ^= m & cu[p, i, b]
    return u32_to_i32(torch.stack(accs))


def launch_shape(tile: int, n: int) -> Dict[str, int]:
    """The kernel's launch at `tile` over n words: the tile split over
    blocks of BLOCK_WORDS words (one block for a smaller tile), each
    walking its 16-byte columns with `block` threads."""
    if tile not in KERNEL_TILES or n % tile:
        raise ValueError(f"tile {tile} must be one of {KERNEL_TILES} and "
                         f"divide n = {n}")
    block_words = min(tile, BLOCK_WORDS)
    return {"grid": n // block_words,
            "block": min(MAX_THREADS, block_words // WORDS),
            "block_words": block_words}


def check_args(x: torch.Tensor, consts: torch.Tensor, variant: str,
               tile: int) -> None:
    """Raise ValueError unless the kernel takes these arguments: x (k, n)
    int32, contiguous, 16-byte aligned, consts (r, k, 8) int32 contiguous
    on x's device, (k, r) one of SHAPES, a known variant, and a tile of
    KERNEL_TILES that divides n."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if x.dtype != torch.int32 or x.dim() != 2:
        raise ValueError(f"x must be 2-D int32, got {x.dtype} {tuple(x.shape)}")
    k, n = x.shape
    if (consts.dtype != torch.int32 or consts.dim() != 3
            or consts.shape[1] != k or consts.shape[2] != 8
            or consts.device != x.device):
        raise ValueError(f"consts must be int32 (r, {k}, 8) on {x.device}, got "
                         f"{consts.dtype} {tuple(consts.shape)} on "
                         f"{consts.device}")
    r = consts.shape[0]
    if (k, r) not in SHAPES:
        raise ValueError(f"(k, r) = ({k}, {r}) must be one of {SHAPES}")
    launch_shape(tile, n)
    if not (x.is_contiguous() and consts.is_contiguous()):
        raise ValueError("x and consts must be contiguous")
    if x.data_ptr() % ALIGN:
        raise ValueError(f"x must be {ALIGN}-byte aligned")


def _lib() -> ctypes.CDLL:
    global _configured
    lib = _build.load("gf_tune")
    if not _configured:
        lib.gf_tune_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.gf_tune_launch.restype = ctypes.c_int
        _configured = True
    return lib


def _launch(x: torch.Tensor, consts: torch.Tensor, out: torch.Tensor,
            variant: str, shape: Dict[str, int]) -> None:
    """Launch the kernel with `shape` on the current stream; raise
    RuntimeError if the launch is refused."""
    k, n = x.shape
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_tune_launch(x.data_ptr(), consts.data_ptr(),
                                out.data_ptr(), n, k, consts.shape[0],
                                VARIANTS.index(variant), shape["grid"],
                                shape["block"], shape["block_words"], stream)
    if rc != 0:
        raise RuntimeError(f"gf_tune_kernel ({variant}, {shape}) launch "
                           f"failed: cudaError {rc}")
    global launches
    with _count_lock:
        launches += 1


def _run(x: torch.Tensor, consts: torch.Tensor, variant: str,
         shape: Dict[str, int]) -> torch.Tensor:
    out = torch.empty((consts.shape[0], x.shape[1]), dtype=torch.int32,
                      device=x.device)
    if x.shape[1]:
        _launch(x, consts, out, variant, shape)
    return out


def gf_tune(x: torch.Tensor, consts: torch.Tensor, variant: str,
            tile: int) -> torch.Tensor:
    """x (k, n) int32 contiguous and consts (r, k, 8) int32 contiguous on
    the same device → (r, n) int32, through `variant` at `tile` (the
    plain version on the CPU)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if x.device.type == "cpu":
        return gf_tune_plain(x, consts, variant)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    check_args(x, consts, variant, tile)
    return _run(x, consts, variant, launch_shape(tile, x.shape[1]))


# --- the sweep ------------------------------------------------------------


def staged_group(device, k: int = K, r: int = M, seed: int = 7,
                 nblocks: int = NBLOCKS, block: int = BLOCK):
    """The sweep's input on `device`, one group of `nblocks` blocks as
    RS(k, r) codewords: (u32 codewords (ncw, k, s4) numpy, xflat (k, n)
    int32, codewords (ncw, k, s4) int32, mask consts (r, k, 8) int32,
    scalar consts for gf_apply, parity matrix)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (nblocks, block), dtype=np.uint8)
    u32 = np.ascontiguousarray(data.reshape(nblocks // k, k, block)).view(
        "<u4").reshape(nblocks // k, k, -1)
    mat = gf256.rs_parity_matrix(k, r)
    xflat = torch.from_numpy(fold(u32).view(np.int32)).to(device)
    cw = torch.from_numpy(u32.view(np.int32)).to(device)
    masks = torch.from_numpy(mask_consts(mat).view(np.int32)).to(device)
    scalar = consts_from_numpy(mat, device)
    return u32, xflat, cw, masks, scalar, mat


def bound(k: int, r: int, n: int) -> Dict[str, float]:
    """The least time the card could take: each input word read once,
    each output word written once, over the HBM rate (the operations, r*k
    multiply-accumulates per column, take far less)."""
    nbytes = 4 * n * (k + r) + 4 * r * k * 8
    return {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes}


def census(variant: str, k: int = K, r: int = M) -> Optional[dict]:
    """The variant's SASS census per thread, which owns one 16-byte
    column (WORDS words), by opcode and by pipe class, and per word the
    ALU-pipe, LDS and IMAD instructions; None without cuobjdump."""
    sym = f"gf_tune_kernelILi{VARIANTS.index(variant)}ELi{k}ELi{r}EE"
    counts = sass_census(_build._lib_path("gf_tune"), sym)
    if counts is None:
        return None
    cls = census_classes(counts)
    return {"ops": counts, "classes": cls, "per_word": {
        "alu": cls["alu"] / WORDS, "lds": counts.get("LDS", 0) / WORDS,
        "imad": counts.get("IMAD", 0) / WORDS}}


def issue(cls: Optional[dict], n: int, ms: float) -> dict:
    """From a census's classes: the least time of these instructions over
    the n / WORDS threads of a launch (``timing.ops_ms``), and the ALU and
    all lanes they issued per SM per clock in `ms` at 1.98 GHz."""
    if cls is None:
        return {"issue_bound_ms": None, "alu_lanes_per_sm_clock": None,
                "lanes_per_sm_clock": None}
    threads = n // WORDS
    issued = cls["total"] - cls["uniform"]
    clocks = ms / 1e3 * SMS * SM_CLOCK_HZ
    return {"issue_bound_ms": ops_ms(threads * cls["alu"], threads * issued),
            "alu_lanes_per_sm_clock": threads * cls["alu"] / clocks,
            "lanes_per_sm_clock": threads * issued / clocks}


def sweep(device, reps: int = 50, variants=VARIANTS, tiles=TILES,
          oracle=None) -> dict:
    """Check and time every variant x tile cell, launched as
    ``launch_shape`` gives it, and gf_apply, on one staged group.
    `oracle(mat, u8 codewords)` → parity bytes; default
    gf256.gf_matmul_blocks.  Raises on any mismatch or refused launch."""
    u32, xflat, cw, masks, scalar, mat = staged_group(device)
    ncw, k, s4 = u32.shape
    n = xflat.shape[1]
    oracle = oracle or gf256.gf_matmul_blocks
    want = np.asarray(oracle(mat, u32.view(np.uint8).reshape(ncw, k, 4 * s4)))
    want_u32 = want.view("<u4").reshape(ncw, M, s4)
    flush = torch.empty((FLUSH_BYTES,), dtype=torch.uint8, device=device)
    data_bytes = 4 * k * n
    b = bound(k, M, n)
    censuses = {v: census(v) for v in variants}

    cells = {}
    for variant in variants:
        cls = censuses[variant] and censuses[variant]["classes"]
        for tile in tiles:
            tag = f"{variant}/t{tile}"
            fn = functools.partial(gf_tune, xflat, masks, variant, tile)
            if not np.array_equal(unfold(fn().cpu().numpy().view("<u4"), ncw),
                                  want_u32):
                raise RuntimeError(f"gf_tune {tag}: wrong result")
            ms = queued_ms(fn, reps, flush)
            cells[tag] = {
                "ms": ms, "gibs": data_bytes / (ms / 1e3) / 2**30,
                "share": b["bound_ms"] / ms, **launch_shape(tile, n),
                "cluster": 1, **issue(cls, n, ms)}
    got = gf_apply(cw, scalar).cpu().numpy()
    if not np.array_equal(got.view("<u4"), want_u32):
        raise RuntimeError("gf_apply: wrong result")
    ms = queued_ms(lambda: gf_apply(cw, scalar), reps, flush)
    best = min(cells, key=lambda t: cells[t]["ms"])
    return {"shape": [k, n], "codewords": ncw, "reps": reps,
            "cells": cells, "census": censuses,
            "gf_apply": {"ms": ms, "gibs": data_bytes / (ms / 1e3) / 2**30,
                         "share": b["bound_ms"] / ms},
            "best": {"tag": best, **cells[best]}, **b}


def nvidia_smi_line() -> Optional[str]:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200,
                    help="timed launches per cell (default 200)")
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gf_tune: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    _build.build_all(("gf_tune", "gf_apply"))
    rec = {"card": nvidia_smi_line(), "kind": torch.cuda.get_device_name(0),
           **sweep(device, reps=args.reps)}
    for tag, cell in sorted(rec["cells"].items()):
        print(f"# {tag}: {cell['ms']:.4f} ms, {cell['gibs']:.1f} GiB/s, grid "
              f"{cell['grid']} x {cell['block']}", file=sys.stderr)
    line = json.dumps(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
