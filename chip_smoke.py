#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (garage_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--quick] [--out FILE]

Phases, each fatal on any mismatch or exception:

  1. build      — nvcc compiles every kernel of csrc/ for sm_90a, one
                  process per source, all started together; prints the
                  seconds taken and ptxas's register/spill report.
  2. kernels    — each kernel's wrapper on the card against its plain
                  PyTorch version on the same inputs, bit-exact (integer
                  work, so the tolerance is 0), and against hashlib / the
                  numpy GF(2^8) oracle: BLAKE2s at the scrub's shape (256
                  lanes x 1 MiB) with edge lengths, and at an odd lane
                  count; the GF apply for every (k, r) it is compiled for
                  (encode, degraded-read rows and full decode at RS(8,4)
                  and RS(4,2)) and for two it is not, each through its
                  instantiation and its runtime-(k, r) body, in both of
                  the reference's regimes (padded S4 < 2048 and >= 2048)
                  and at odd S4; the fused scrub at the
                  scrub's shape against one run of its plain version, whose
                  digests also hold K1's result at that shape; every
                  variant of the GF tuning kernel (T1) at every tile and
                  both (k, r) it is built for, on 1 MiB blocks as its
                  sweep stages them, and two launches it must refuse (a
                  misaligned x, a (k, r) it is not built for).
  3. main       — the codec path of the first slice: make_codec("cuda",
                  rs_data=8, rs_parity=4) behind a CodecFeeder; 4 scrub
                  batches of 256 x 1 MiB blocks (1 GiB, the last block of
                  each 700,001 B, 3 planted corruptions) through
                  scrub_async; 64 concurrent 1 MiB hash_async PUTs plus 32
                  write-time encodes; decode_async of 32 codewords with 2
                  of 12 shards lost; one 1024-lane scrub_encode_batch.
  4. production — the stack users run: make_codec("hybrid") at the
                  reference defaults (device_batch_blocks 1024,
                  hybrid_window 1, 2 pinned staging slots, pool_mib 256 of
                  256 KiB pages, max_device_staging_mib 4096) behind a
                  CodecFeeder: a warm-up batch (the gate probe), the main
                  phase's scrub cold, a warm pass over its last batch (a
                  working set the pool holds), then the PUT hashes,
                  encodes and degraded decodes.  Checks bits against
                  hashlib / numpy, a live transport with no fallback or
                  failure event, every scrub byte on the device, at most
                  one host copy per block, pool hit + miss = scrubbed
                  bytes and a warm pass that stages nothing.  Prints bytes
                  by side, stage seconds, cold and warm GiB/s, the pinned
                  H2D rate of one slot and collect's split.
  5. store      — one block store node's paths (slice 3a): three port
                  Systems on loopback (replication 3, sqlite, the
                  reference defaults), each with a BlockManager whose
                  codec its Config builds on the card: hybrid, cuda,
                  and hybrid with a ParityStore.  512 blocks of 1 MiB
                  (the last of every 256 700,001 B, 1 in 16 stored
                  compressed) hashed by node 0's feeder and written with
                  rpc_put_block; 128 GETs on node 1 verified on the card,
                  8 more served by peers; 3 planted corruptions each on
                  nodes 0 and 1 found by one ScrubWorker pass
                  (tranquility 0), quarantined, resynced from peers
                  bit-equal, and a clean second pass; node 2's sidecars
                  against the numpy oracle and one block rebuilt from its
                  sidecar through the GF kernel's decode body.  Prints
                  per node and pass the wall time, GiB/s, blocks per
                  scrub dispatch, bytes by side and launches, and a
                  reckoning of three codecs' memory beside the measured
                  peak.
  6. garage     — the metadata plane and the node object (slice 3b): six
                  port Garage nodes built from Config on loopback (meta
                  replication 3, data "none", sqlite, RS(8,4) at 1 MiB
                  blocks with store_parity, parity_on_write and
                  parity_distribute, repair_ppr off; node 1 hybrid, the
                  rest cuda): 512 blocks in objects of 1-64 MiB written
                  through node 0 (feeder hash, rpc_put_block, Version and
                  Object rows), every block's parity-index row and every
                  codeword's parity against the numpy oracle; 8 degraded
                  GETs of blocks whose sole copy was deleted (resync
                  stubbed) decoded on node 0's card; two nodes killed and
                  dropped from the layout, every block predicted
                  recoverable healed bit-exact and decoded exactly once;
                  a scrub pass of node 0's own ScrubWorker.  Each node's
                  GF launches are attributed through its codec and must
                  add up to the kernel's counter.
  7. tune       — T1's path: tools/gf_tune.py's sweep of the GF kernel's
                  loop orders x tiles, each cell checked and timed, with
                  each variant's SASS census and the issue bound it
                  implies, beside the production GF kernel on the same
                  codewords.
  8. times      — each kernel's time (CUDA events, after a warm-up,
                  launches queued behind a sleep kernel: tools/timing.py)
                  beside its bound (the larger of bytes over 3.35 TB/s,
                  the fewest 32-bit integer instructions over the SMs'
                  ALU and issue rates, and, for K1 and K4, the longest
                  message's dependent chain at the latency the chain probe
                  measures and its instructions at one per clock) and its
                  plain version's time; the GF
                  kernel's instantiated and runtime bodies at the scrub
                  and narrow shapes with a cold L2, its SASS census and
                  the ALU rate it implies; K1 at 8, 256 and 4,224 lanes
                  with the SM clock; the pageable H2D copy of one batch.

Launch counts are zeroed just before each path (main's scrub / put /
decode / 1024-lane scrub, production's cold / warm / put / decode,
store's put / get / each scrub pass, garage's write / degraded GET /
heal / scrub, tune)
and read just after it; each path must have launched every kernel it
runs, and the GF kernel only the body each path needs (GF_BODIES).
The sizes are the reference configuration's defaults: 1 MiB
blocks, RS(8,4), 256-block scrub batches, 1024-lane device submissions.
Data and corruptions come from a fixed seed.  Exits non-zero without a
result line when no CUDA device is present or the package is not beside
this file.  Prints the kernels JSON line and the card's name and power
limit before the last line, which is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

SEED = 20261016
MIB = 1 << 20
CODEC_KERNELS = ("blake2s", "gf_apply", "fused_scrub")
KERNELS = CODEC_KERNELS + ("gf_tune",)
# Operations bounds: the larger of a kernel's ALU-only integer
# instructions over the SMs' 64 ALU lanes and all of them over the 128
# lanes the schedulers issue, x 132 SMs x 1.98 GHz (tools/timing.py
# ``ops_ms``, which says where the rates come from).  phase_times checks
# the ALU rate on the card: the SASS census of the GF kernel's RS(8,4) and
# RS(8,8) bodies, whose ALU work outweighs their bytes, over their
# measured times gives the ALU lanes issued per SM per clock; on an H100
# at 700 W both came to ~57 (PERF.md), below 64.
# BLAKE2s per 64-byte chunk, in the fewest 32-bit instructions: a G is 4
# three-input adds (a + b + m is one IADD3), 4 xors and 4 rotates (one
# funnel shift each), 12 in all; 80 G, the counter and flag words (an xor
# and a select), and the 8 three-input xors of the feed-forward.  All but
# the adds are ALU-only.
B2S_OPS_PER_CHUNK = 80 * 12 + 2 + 8
B2S_ALU_OPS_PER_CHUNK = 80 * 8 + 2 + 8
# ... and its dependent chain (csrc/blake2s.cu:42-94): in a G each step
# needs the one before (IADD3, then LOP3 xor and SHF rotate of d, IADD3
# of c, LOP3 and SHF of b, and again: 12); the 4 column G of a round are
# independent of each other but the 4 diagonal G read their outputs, so a
# round is 2 G deep; 10 rounds and the feed-forward's one three-input xor
# (h ^= v[i] ^ v[i + 8]), on which the next chunk's first G waits: 20 G
# and one instruction, 241 dependent instructions per chunk.  Each costs
# the latency the chain probe measures on the card (g_chain_cycles / 12).
B2S_G_DEPTH = 12
B2S_CHAIN_G_PER_CHUNK = 10 * 2


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# --- oracles and inputs ------------------------------------------------------


def hashlib_digest(buf) -> bytes:
    return hashlib.blake2s(buf, digest_size=32).digest()


class GfOracle:
    """numpy GF(2^8) matrix apply through a 256 x 256 product table built
    from the port's gf256.gf_mul (same field as gf256.gf_matmul_blocks,
    which it is checked against on a small input)."""

    def __init__(self, gf256):
        self.table = np.array([[gf256.gf_mul(a, b) for b in range(256)]
                               for a in range(256)], dtype=np.uint8)

    def apply(self, mat: np.ndarray, shards: np.ndarray) -> np.ndarray:
        r, k = mat.shape
        out = np.zeros(shards.shape[:-2] + (r, shards.shape[-1]), np.uint8)
        for p in range(r):
            for i in range(k):
                out[..., p, :] ^= self.table[mat[p, i]][shards[..., i, :]]
        return out


def max_abs_err(a: np.ndarray, b: np.ndarray) -> int:
    """Largest |a - b| over two integer arrays of one shape."""
    if a.shape != b.shape:
        fail(f"shape {a.shape} != {b.shape}")
    if a.size == 0:
        return 0
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def random_rows(rng, lengths, cols) -> np.ndarray:
    """(len(lengths), cols) uint8, row i random up to lengths[i], zero
    after (messages are zero-padded)."""
    arr = np.frombuffer(rng.bytes(len(lengths) * cols), np.uint8).reshape(
        len(lengths), cols).copy()
    for i, n in enumerate(lengths):
        arr[i, n:] = 0
    return arr


# --- timing --------------------------------------------------------------------


def time_host(torch, fn):
    """(result, milliseconds) of one fn() call ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def stage_delta(before: dict, after: dict) -> dict:
    """Seconds each observer stage gained between two snapshots."""
    return {k: round(v - before.get(k, 0.0), 6) for k, v in after.items()
            if v - before.get(k, 0.0) > 0}


def bound_ms(nbytes: float, alu_ops: float, ops: float, dep_ms: float = 0.0):
    """(bound in ms, "bytes" or "operations"): the larger of the bytes
    over the HBM rate and the operations' least time, itself the larger of
    their issue (ops_ms) and their longest dependent chain (`dep_ms`)."""
    from garage_tpu_torch.tools.timing import HBM_BYTES_PER_S, ops_ms

    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = max(ops_ms(alu_ops, ops), dep_ms)
    return (tb, "bytes") if tb >= to else (to, "operations")


def b2s_work(lengths: np.ndarray, cols: int):
    """(bytes, ALU-only instructions, instructions) BLAKE2s must do for
    these lanes: each lane's chunks up to its own end, read once, and its
    32-byte digest written."""
    nch = np.minimum(np.maximum((lengths.astype(np.int64) + 63) // 64, 1),
                     cols // 64)
    chunks = int(nch.sum())
    return (chunks * 64 + lengths.size * (4 + 32),
            chunks * B2S_ALU_OPS_PER_CHUNK, chunks * B2S_OPS_PER_CHUNK)


def b2s_message_ms(lengths: np.ndarray, cols: int, g_cycles: float,
                   clock_hz: float):
    """(chain ms, issue ms): two least times of the longest message, which
    one thread hashes alone, so no parallel lane can shorten them.  Its
    chunks, each a dependent chain of B2S_CHAIN_G_PER_CHUNK G and one xor
    at `g_cycles` per G (the chain probe's measure); and its chunks'
    B2S_OPS_PER_CHUNK instructions, which its warp issues at one per
    clock at most.  At the SM clock `clock_hz`."""
    chain = int(min(max((int(lengths.max()) + 63) // 64, 1), cols // 64))
    per_chunk = (B2S_CHAIN_G_PER_CHUNK + 1 / B2S_G_DEPTH) * g_cycles
    return (chain * per_chunk / clock_hz * 1e3,
            chain * B2S_OPS_PER_CHUNK / clock_hz * 1e3)


def time_kernel_clocked(torch, fn, flush=None):
    """(mean ms of fn() on the card, median SM clock in MHz): queued_ms
    over enough calls for 400 ms of kernel time, with nvidia-smi sampling
    clocks.sm every 20 ms beside it."""
    from garage_tpu_torch.tools.timing import queued_ms

    est = queued_ms(fn, 2, flush)
    reps = max(3, int(400.0 / max(est, 1e-3)) + 1)
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                            "--format=csv,noheader,nounits", "-lms", "20"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                           text=True)
    try:
        ms = queued_ms(fn, reps, flush)
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=60)
    samples = [float(x) for x in out.split() if x.replace(".", "").isdigit()]
    check(bool(samples), "nvidia-smi gave no clocks.sm sample")
    return ms, float(np.median(samples))


# (regime, codewords, S4): the reference's two dispatch regimes, each at a
# row of whole 16-byte columns and at an odd S4
GF_CHECK_SHAPES = (("narrow", 37, 300), ("narrow odd", 37, 301),
                   ("wide", 5, 2500), ("wide odd", 5, 2501))


def gf_check_matrices(gf256) -> dict:
    """The GF(2^8) matrices the kernel check runs: every (k, r) the port
    launches (encode, degraded-read rows 1..m, full decode, at RS(8,4)
    and RS(4,2)) and two the kernel has no instantiation for."""
    dec8 = gf256.rs_decode_matrix(8, 4, [0, 1, 3, 4, 7, 8, 10, 11])
    dec4 = gf256.rs_decode_matrix(4, 2, [0, 2, 4, 5])

    def rows(d, sel):
        return np.ascontiguousarray(d[sel])

    return {
        "encode RS(8,4)": gf256.rs_parity_matrix(8, 4),
        "decode RS(8,4) rows [2]": rows(dec8, [2]),
        "decode RS(8,4) rows [2,5]": rows(dec8, [2, 5]),
        "decode RS(8,4) rows [2,5,6]": rows(dec8, [2, 5, 6]),
        "decode RS(8,4)": dec8,
        "encode RS(4,2)": gf256.rs_parity_matrix(4, 2),
        "decode RS(4,2) rows [1]": rows(dec4, [1]),
        "decode RS(4,2)": dec4,
        "encode RS(6,3)": gf256.rs_parity_matrix(6, 3),
        "encode RS(10,4)": gf256.rs_parity_matrix(10, 4),
    }


def gf_work(b: int, k: int, r: int, s4: int):
    """(bytes, ALU-only instructions, instructions) of one GF apply: k
    rows read and r rows written per codeword, and the constants; r x k
    GF(2^8) multiply-accumulates per 4-byte column, one xor-based (ALU)
    instruction each at best.  The bytes bound it; the kernel's own
    instruction count (its SASS census, gf_times) is what bounds the
    kernel, as its source note says."""
    nbytes = 4 * b * s4 * (k + r) + 4 * r * k * 8
    ops = b * s4 * k * r
    return nbytes, ops, ops


# --- phases --------------------------------------------------------------------


def phase_build(ctx) -> None:
    from garage_tpu_torch.ops import _build

    secs = _build.build_all()
    log(f"[build] nvcc {', '.join(_build.SOURCES)} for sm_90a: {secs:.2f} s")
    for name, text in sorted(_build.build_logs.items()):
        # one line per distinct report: a templated source repeats it for
        # every instantiation
        seen = set()
        for line in text.splitlines():
            line = line.strip()
            if ("registers" in line or "spill" in line) and line not in seen:
                seen.add(line)
                log(f"[build] {name}: {line}")
    ctx["build_s"] = secs


def phase_kernels(ctx) -> None:
    torch = ctx["torch"]
    dev = ctx["device"]
    from garage_tpu_torch.ops import gf256
    from garage_tpu_torch.ops.blake2s import blake2s_batch_plain
    from garage_tpu_torch.ops.codec import CodecParams
    from garage_tpu_torch.ops.cuda_blake2s import blake2s_batch
    from garage_tpu_torch.ops.cuda_codec import CudaCodec, scrub_composition
    from garage_tpu_torch.ops.cuda_gf import (consts_from_numpy, gf_apply,
                                              gf_apply_plain)

    rng = np.random.default_rng(SEED)
    oracle = ctx["oracle"]
    blk = ctx["block"]

    # oracle vs the port's byte-domain reference on a small input
    mat = gf256.rs_parity_matrix(8, 4)
    small = rng.integers(0, 256, (3, 8, 333), dtype=np.uint8)
    check((oracle.apply(mat, small) == gf256.gf_matmul_blocks(mat, small)).all(),
          "GF table oracle disagrees with gf256.gf_matmul_blocks")

    def b2s_check(label, arr, lengths, got, plain):
        """K1's digests against its plain version's and hashlib's."""
        g = got.cpu().numpy().view(np.uint32)
        err = max_abs_err(g, plain.cpu().numpy().view(np.uint32))
        check(err == 0, f"blake2s kernel != plain version ({label})")
        for i, n in enumerate(lengths):
            check(g[i].astype("<u4").tobytes() == hashlib_digest(arr[i, :n]),
                  f"blake2s kernel != hashlib at lane {i}, length {n} ({label})")
        return err

    # K1, K2 and K4 at the scrub's shape: 256 lanes x 1 MiB rows, edge
    # lengths first, expected digests from hashlib with two lanes planted
    # wrong
    lanes = ctx["scrub_lanes"]
    edge = [0, 1, 63, 64, 65, 1000, 16001, 700001 * blk // MIB]
    lens = np.asarray(edge + [blk] * (lanes - len(edge)), np.int32)
    arr = random_rows(rng, lens, blk)
    da = torch.from_numpy(arr).to(dev)
    dl = torch.from_numpy(lens).to(dev)
    expected = np.stack([np.frombuffer(hashlib_digest(arr[i, :n]), "<u4")
                         for i, n in enumerate(lens)]).astype(np.uint32)
    planted = [3, lanes - 2]
    expected[planted] ^= np.uint32(1)
    de = torch.from_numpy(expected.view(np.int32)).to(dev)
    K_enc = consts_from_numpy(mat, dev)

    # the fused scrub's plain version, run once on these inputs: its
    # digests are K1's plain result too, and its hash step is timed for
    # K1's plain time (fused_scrub_plain's composition, hash step timed)
    hash_ms = []

    def timed_plain_hash(d, l):
        out, ms = time_host(torch, lambda: blake2s_batch_plain(d, l))
        hash_ms.append(ms)
        return out

    (p_h, p_ok, p_bad, p_par), fused_plain_ms = time_host(
        torch, lambda: scrub_composition(da, dl, de, K_enc, 8,
                                         timed_plain_hash, gf_apply_plain))
    b2s_plain_ms = hash_ms[0]
    b2s_err = b2s_check("scrub shape", arr, lens, blake2s_batch(da, dl), p_h)
    log(f"[kernels] blake2s scrub shape: B={lanes} row={blk} B bit-exact vs "
        f"plain version and hashlib (plain {b2s_plain_ms:.1f} ms)")
    # K1 at a lane count that is not a multiple of 128 (and of 32)
    odd = np.asarray([0, 1, 63, 64, 65, 1000, 16001] + list(
        rng.integers(0, 16002, 131 - 7)), np.int32)
    oarr = random_rows(rng, odd, 16384)
    oda, odl = torch.from_numpy(oarr).to(dev), torch.from_numpy(odd).to(dev)
    oplain, oplain_ms = time_host(torch, lambda: blake2s_batch_plain(oda, odl))
    b2s_check("odd lanes", oarr, odd, blake2s_batch(oda, odl), oplain)
    log(f"[kernels] blake2s odd lanes: B={len(odd)} row=16384 B bit-exact vs "
        f"plain version and hashlib (plain {oplain_ms:.1f} ms)")

    # K2/K3: every instantiated (k, r) of the GF kernel and its runtime-
    # (k, r) body, in both regimes of the reference dispatch (padded S4 <
    # 2048 and >= 2048) and at odd S4 (the kernel's guarded tail), against
    # the plain version and the numpy oracle
    from garage_tpu_torch.ops.cuda_gf import INSTANTIATIONS, instantiation

    gf_mats = gf_check_matrices(gf256)
    covered = {instantiation(m.shape[1], m.shape[0]) for m in gf_mats.values()}
    check(covered >= {f"k{k}r{r}" for k, r in INSTANTIATIONS},
          f"the GF check misses instantiations: {sorted(covered)}")
    for label, m in gf_mats.items():
        r, k = m.shape
        bodies = [instantiation(k, r), instantiation(k, r, runtime=True)]
        for regime, b, s4 in GF_CHECK_SHAPES:
            x = rng.integers(0, 2**32, (b, k, s4), dtype=np.uint32)
            dx = torch.from_numpy(x.view(np.int32)).to(dev)
            K = consts_from_numpy(m, dev)
            plain = gf_apply_plain(dx, K).cpu().numpy().view(np.uint32)
            want = oracle.apply(m, x.view(np.uint8).reshape(b, k, 4 * s4))
            check(np.array_equal(plain.view(np.uint8).reshape(want.shape),
                                 want),
                  f"gf plain version != numpy GF(2^8) ({label}, {regime})")
            for body in bodies:
                got = gf_apply(dx, K, runtime=body == "runtime")
                got = got.cpu().numpy().view(np.uint32)
                check(np.array_equal(got, plain),
                      f"gf kernel {body} != plain version ({label}, {regime})")
            if label == "decode RS(8,4)" and regime == "wide":
                check(np.array_equal(got, np.asarray(
                    gf256.gf_matmul_blocks(m, x.view(np.uint8).reshape(
                        b, k, 4 * s4))).view(np.uint32).reshape(got.shape)),
                      "gf kernel != gf256.gf_matmul_blocks")
        log(f"[kernels] gf_apply {label}: bodies {' and '.join(bodies)} "
            f"bit-exact vs plain version and numpy GF(2^8) at "
            f"{', '.join(f'B={b} S4={s4}' for _, b, s4 in GF_CHECK_SHAPES)}")

    # K2 at the scrub's shape: the batch above as (B/8, 8, S4) codewords
    groups = da.view(torch.int32).view(lanes // 8, 8, blk // 4)
    gf_got = gf_apply(groups, K_enc)
    gf_plain, gf_plain_ms = time_host(
        torch, lambda: gf_apply_plain(groups, K_enc))
    gf_err = max_abs_err(gf_got.cpu().numpy().view(np.uint32),
                         gf_plain.cpu().numpy().view(np.uint32))
    check(gf_err == 0, "gf kernel != plain version (scrub shape)")
    par = gf_got.cpu().numpy().view(np.uint8).reshape(lanes // 8, 4, blk)
    want = oracle.apply(mat, arr.reshape(lanes // 8, 8, blk))
    check(np.array_equal(par, want), "gf kernel != numpy GF(2^8) (scrub shape)")
    log(f"[kernels] gf_apply encode RS(8,4) scrub shape ({lanes // 8}, 8, "
        f"{blk // 4}) bit-exact (plain {gf_plain_ms:.1f} ms)")

    # K4: the fused scrub over the same batch against its plain version's
    # four outputs, and against hashlib's verdicts and the numpy parity
    codec = CudaCodec(CodecParams(rs_data=8, rs_parity=4), device=dev)
    h, ok, bad, parity = codec.fused_scrub(da, dl, de)
    fused_err = max(
        max_abs_err(h.cpu().numpy().view(np.uint32),
                    p_h.cpu().numpy().view(np.uint32)),
        max_abs_err(ok.cpu().numpy(), p_ok.cpu().numpy()),
        abs(int(bad.item()) - int(p_bad.item())),
        max_abs_err(parity.cpu().numpy(), p_par.cpu().numpy()))
    check(fused_err == 0, "fused scrub != its plain version")
    want_ok = np.ones(lanes, bool)
    want_ok[planted] = False
    check(np.array_equal(ok.cpu().numpy(), want_ok)
          and int(bad.item()) == len(planted), "fused scrub ok/count wrong")
    check(np.array_equal(parity.cpu().numpy(), want), "fused scrub parity wrong")
    log(f"[kernels] fused scrub ({lanes} x {blk} B, {len(planted)} planted "
        "mismatches) bit-exact vs its plain version (digests, ok, count, "
        f"parity), hashlib and numpy GF(2^8) (plain {fused_plain_ms:.1f} ms)")

    # T1: every variant of the sweep's kernel at every tile, at both (k, r)
    # it is built for, on 1 MiB blocks folded flat as the sweep stages
    # them, against its plain version (the variant's loop order) and the
    # numpy oracle; then the launches it must refuse
    from garage_tpu_torch.tools import gf_tune

    tune_err, tune_plain_ms = 0, {}
    for k, r in gf_tune.SHAPES:
        u32, xflat, _cw, masks, _scalar, tmat = gf_tune.staged_group(dev, k, r)
        ncw = u32.shape[0]
        t_want = oracle.apply(tmat, u32.view(np.uint8).reshape(
            ncw, k, -1)).view("<u4").reshape(ncw, r, -1)
        for variant in gf_tune.VARIANTS:
            plain, ms = time_host(
                torch, lambda: gf_tune.gf_tune_plain(xflat, masks, variant))
            if (k, r) == (gf_tune.K, gf_tune.M):
                tune_plain_ms[variant] = ms
            plain = plain.cpu().numpy().view(np.uint32)
            check(np.array_equal(gf_tune.unfold(plain.view("<u4"), ncw), t_want),
                  f"gf_tune plain {variant} k{k}r{r} != numpy GF(2^8)")
            for tile in gf_tune.KERNEL_TILES:
                got = gf_tune.gf_tune(xflat, masks, variant, tile)
                err = max_abs_err(got.cpu().numpy().view(np.uint32), plain)
                check(err == 0, f"gf_tune {variant} k{k}r{r} t{tile} != its "
                      "plain version")
                tune_err = max(tune_err, err)
            log(f"[kernels] gf_tune {variant} k{k}r{r} at {tuple(xflat.shape)}, "
                f"tiles {', '.join(map(str, gf_tune.KERNEL_TILES))}: bit-exact "
                f"vs plain version and numpy GF(2^8) (plain {ms:.1f} ms)")
    n = xflat.shape[1] - 128          # still a multiple of every tile
    misaligned = xflat.view(-1)[1:1 + k * n].view(k, n)
    refused = {      # (what must raise, a word of its text)
        "misaligned x": (misaligned, masks, "aligned"),
        f"(k, r) = ({k}, 1)": (xflat, masks[:1], "(k, r)"),
    }
    launched = gf_tune.launches
    for label, (x, c, word) in refused.items():
        try:
            gf_tune.gf_tune(x, c, "acc", 128)
        except ValueError as e:
            check(word in str(e), f"gf_tune {label}: unexpected error {e}")
            log(f"[kernels] gf_tune {label}: raises ValueError ({e})")
        else:
            fail(f"gf_tune launched with {label}")
    check(gf_tune.launches == launched, "a refused gf_tune launch was counted")
    check(torch.equal(gf_tune.gf_tune(xflat, masks, "acc", 4096),
                      gf_tune.gf_tune_plain(xflat, masks, "acc")),
          "gf_tune after a refused launch != its plain version")
    del xflat, masks, _cw, misaligned

    ctx["k1_inputs"] = (da, dl, lens)
    ctx["k4_inputs"] = (codec, da, dl, de)
    ctx["gf_inputs"] = (groups, K_enc)
    ctx["max_err"] = {"blake2s": b2s_err, "gf_apply": gf_err,
                      "fused_scrub": fused_err, "gf_tune": tune_err}
    ctx["plain_ms"] = {"blake2s": b2s_plain_ms, "gf_apply": gf_plain_ms,
                       "fused_scrub": fused_plain_ms}
    ctx["tune_plain_ms"] = tune_plain_ms


def phase_main(ctx) -> dict:
    torch = ctx["torch"]
    from garage_tpu_torch.ops import cuda_blake2s, cuda_codec, cuda_gf, gf256
    from garage_tpu_torch.ops import make_codec
    from garage_tpu_torch.ops.feeder import CodecFeeder
    from garage_tpu_torch.utils.data import Hash

    rng = np.random.default_rng(SEED + 1)
    oracle = ctx["oracle"]
    blk, lanes, nbatch = ctx["block"], ctx["scrub_lanes"], ctx["batches"]
    k, m = 8, 4
    mat = gf256.rs_parity_matrix(k, m)

    codec = make_codec("cuda", rs_data=k, rs_parity=m, device=ctx["device"])
    codec.warm_scrub(lanes, blk)
    feeder = CodecFeeder(codec)

    # scrub input: nbatch x lanes blocks, the last of each batch short
    short = 700001 * blk // MIB
    batches, hashes = [], []
    for _ in range(nbatch):
        lens = [blk] * (lanes - 1) + [short]
        rows = random_rows(rng, lens, blk)
        batches.append([rows[i, :n].tobytes() for i, n in enumerate(lens)])
        hashes.append([Hash(hashlib_digest(b)) for b in batches[-1]])
    want_ok = [np.ones(lanes, bool) for _ in range(nbatch)]
    for bi, li in ((0, 5), (nbatch // 2, lanes - 1),
                   (nbatch - 1, lanes * 3 // 4)):
        blocks = batches[bi]
        buf = bytearray(blocks[li])
        buf[len(buf) // 2] ^= 0x40
        blocks[li] = bytes(buf)
        want_ok[bi][li] = False
    # PUT / degraded-read input: 32 codewords of 8 x 1 MiB blocks
    ncw = 32
    data = np.frombuffer(rng.bytes(ncw * k * blk), np.uint8).reshape(ncw, k, blk)
    put_blocks = [data[i // k, i % k].tobytes() for i in range(64)]
    present = [0, 1, 3, 4, 6, 7, 8, 9, 10, 11]
    lost = [2, 5]

    async def scrub():
        return await asyncio.gather(*[feeder.scrub_async(b, h)
                                      for b, h in zip(batches, hashes)])

    async def put():
        hs = asyncio.gather(*[feeder.hash_async([b], peers=64)
                              for b in put_blocks])
        encs = [asyncio.wrap_future(feeder.submit_encode(
            [data[c, i].tobytes() for i in range(k)], peers=ncw))
            for c in range(ncw)]
        return await hs, await asyncio.gather(*encs)

    async def degraded(parity):
        full = np.concatenate([data, parity], axis=1)
        surv = full[:, present]
        return await asyncio.gather(*[
            feeder.decode_async(surv[c:c + 1], present, lost)
            for c in range(ncw)])

    def stages():
        return {k: v["seconds"] for k, v in codec.obs.stage_stats().items()}

    # every path is driven with the launch counts set to 0 just before it
    # and read just after; each must launch the kernels it runs
    by_path = {}
    path_needs = {"scrub": CODEC_KERNELS, "put": ("blake2s", "gf_apply"),
                  "decode": ("gf_apply",), "scrub_1024": CODEC_KERNELS}

    def start_path():
        torch.cuda.synchronize()
        for mod in (cuda_blake2s, cuda_gf, cuda_codec):
            mod.reset_launches()

    def end_path(path):
        torch.cuda.synchronize()
        by_path[path] = {"blake2s": cuda_blake2s.launches,
                         "gf_apply": cuda_gf.launches,
                         "fused_scrub": cuda_codec.fused_launches,
                         "gf_apply_by": dict(cuda_gf.launches_by)}
        for name in path_needs[path]:
            check(by_path[path][name] > 0,
                  f"kernel {name} was not launched on the {path} path")
        check_gf_bodies(path, by_path[path]["gf_apply_by"])

    start_path()
    scrub_runs = []
    for _ in range(ctx["scrub_runs"]):
        before = stages()
        t0 = time.perf_counter()
        scrub_out = asyncio.run(scrub())
        scrub_runs.append(time.perf_counter() - t0)
        scrub_stages = stage_delta(before, stages())
    end_path("scrub")
    start_path()
    t1 = time.perf_counter()
    put_digests, put_parity = asyncio.run(put())
    put_s = time.perf_counter() - t1
    end_path("put")
    parity = np.concatenate(put_parity)
    start_path()
    t2 = time.perf_counter()
    decoded = asyncio.run(degraded(parity))
    decode_s = time.perf_counter() - t2
    end_path("decode")
    all_blocks = [b for bs in batches for b in bs]
    all_hashes = [h for hs in hashes for h in hs]
    before = stages()
    start_path()
    t3 = time.perf_counter()
    ok_wide, par_wide = codec.scrub_encode_batch(all_blocks, all_hashes)
    wide_s = time.perf_counter() - t3
    end_path("scrub_1024")
    wide_stages = stage_delta(before, stages())
    launches = {name: sum(c[name] for c in by_path.values())
                for name in CODEC_KERNELS}
    feeder.shutdown()

    # checks
    scrub_bytes = sum(len(b) for b in all_blocks)
    want_par = []
    for bi, (ok, par) in enumerate(scrub_out):
        check(np.array_equal(ok, want_ok[bi]), f"scrub batch {bi}: ok vector wrong")
        rows = np.zeros((lanes, blk), np.uint8)
        for i, b in enumerate(batches[bi]):
            rows[i, :len(b)] = np.frombuffer(b, np.uint8)
        want = oracle.apply(mat, rows.reshape(lanes // k, k, blk))
        want_par.append(want)
        check(par.shape == want.shape and np.array_equal(par, want),
              f"scrub batch {bi}: parity != numpy GF(2^8)")
        check(np.array_equal(par_wide[bi * lanes // k:(bi + 1) * lanes // k],
                             want), f"1024-lane scrub parity wrong (batch {bi})")
    check(np.array_equal(ok_wide, np.concatenate(want_ok)),
          "1024-lane scrub ok vector wrong")
    scrub_s = float(np.median(scrub_runs))
    log(f"[main] scrub_async {nbatch} x {lanes} x {blk} B: ok exact "
        f"({sum(int((~o).sum()) for o in want_ok)} corrupt found), parity == "
        f"numpy GF(2^8); {len(scrub_runs)} runs "
        f"{', '.join(f'{t * 1e3:.1f}' for t in scrub_runs)} ms, median "
        f"{scrub_bytes / scrub_s / 2**30:.3f} GiB/s end to end")
    log(f"[main] scrub stages (last run, s): {json.dumps(scrub_stages)}")
    for b, d in zip(put_blocks, put_digests):
        check(bytes(d[0]) == hashlib_digest(b), "PUT hash_async digest wrong")
    check(np.array_equal(parity, oracle.apply(mat, data)),
          "write-time encode parity != numpy GF(2^8)")
    log(f"[main] 64 concurrent hash_async + {ncw} encodes: digests == hashlib, "
        f"parity == numpy GF(2^8); {put_s * 1e3:.1f} ms")
    for c, d in enumerate(decoded):
        check(np.array_equal(d[0], data[c, lost]),
              f"degraded read codeword {c}: blocks not reconstructed")
    log(f"[main] decode_async {ncw} codewords, shards {lost} of 12 lost: "
        f"bit-identical; {decode_s * 1e3:.1f} ms")
    log(f"[main] scrub_encode_batch {len(all_blocks)} lanes: ok exact, parity "
        f"== numpy GF(2^8); {wide_s * 1e3:.1f} ms, "
        f"{scrub_bytes / wide_s / 2**30:.3f} GiB/s")
    log(f"[main] 1024-lane stages (s): {json.dumps(wide_stages)}")
    for path, counts in by_path.items():
        log(f"[main] launches on the {path} path: {json.dumps(counts)}")
    log(f"[main] launches over the main path: {json.dumps(launches)}; "
        f"feeder {json.dumps(feeder.stats()['dispatch_reasons'])}")
    # the production phase drives the same inputs through the hybrid stack
    ctx["scrub_input"] = (batches, hashes, want_ok, want_par)
    ctx["put_input"] = (data, put_blocks, parity)
    return {"launches": launches, "launches_by_path": by_path,
            "scrub_runs_s": scrub_runs,
            "scrub_s": scrub_s, "scrub_bytes": scrub_bytes,
            "scrub_stages": scrub_stages, "wide_s": wide_s,
            "wide_stages": wide_stages, "put_s": put_s, "decode_s": decode_s}


def oracle_parity(oracle, mat, blocks, blk) -> np.ndarray:
    """numpy GF(2^8) parity of blocks zero-padded to blk bytes, k per
    codeword, the last codeword zero-padded to k blocks."""
    k = mat.shape[1]
    rows = np.zeros((len(blocks) + (-len(blocks)) % k, blk), np.uint8)
    for i, b in enumerate(blocks):
        rows[i, :len(b)] = np.frombuffer(b, np.uint8)
    return oracle.apply(mat, rows.reshape(-1, k, blk))


def counts_now(mods) -> dict:
    """The launch counter of every kernel's wrapper."""
    cuda_blake2s, cuda_gf, cuda_codec, gf_tune = mods
    return {"blake2s": cuda_blake2s.launches, "gf_apply": cuda_gf.launches,
            "fused_scrub": cuda_codec.fused_launches,
            "gf_tune": gf_tune.launches,
            "gf_apply_by": dict(cuda_gf.launches_by)}


# the GF kernel body each path must run, and nothing else: the RS(8,4)
# instantiation for scrub, PUT hashing + encode; the two-row decode (rows
# [2, 5] of a codeword missing shards 2 and 5) for the degraded reads; the
# one-row decode beside the scrub's for the store's sidecar repair; the
# runtime-(k, r) body nowhere
GF_BODIES = {"scrub": {"k8r4"}, "put": {"k8r4"}, "decode": {"k8r2"},
             "scrub_1024": {"k8r4"}, "prod_scrub_cold": {"k8r4"},
             "prod_scrub_warm": {"k8r4"}, "prod_put": {"k8r4"},
             "prod_decode": {"k8r2"}, "store_scrub_n1": {"k8r4"},
             "store_rescrub_n1": {"k8r4"},
             "store_repair_n2": {"k8r4", "k8r1"}}


def check_gf_bodies(path: str, by_body: dict) -> None:
    ran = {body for body, n in by_body.items() if n}
    check(ran == GF_BODIES[path], f"the {path} path ran GF bodies "
          f"{sorted(ran)}, expected {sorted(GF_BODIES[path])}")


def reset_counts(torch, mods) -> None:
    torch.cuda.synchronize()
    for mod in mods:
        mod.reset_launches()


def phase_production(ctx) -> dict:
    """The production codec stack at the reference's defaults:
    make_codec("hybrid") → CodecFeeder → DeviceTransport (pinned,
    double-buffered staging) → DevicePool → CudaCodec, on the main
    phase's inputs."""
    torch = ctx["torch"]
    from garage_tpu_torch.ops import cuda_blake2s, cuda_codec, cuda_gf, gf256
    from garage_tpu_torch.ops import make_codec
    from garage_tpu_torch.ops.feeder import CodecFeeder
    from garage_tpu_torch.tools import gf_tune
    from garage_tpu_torch.utils.data import Hash

    mods = (cuda_blake2s, cuda_gf, cuda_codec, gf_tune)
    blk, lanes = ctx["block"], ctx["scrub_lanes"]
    k, m = 8, 4
    batches, hashes, want_ok, want_par = ctx["scrub_input"]
    data, put_blocks, put_parity = ctx["put_input"]
    oracle = ctx["oracle"]
    t_build = time.perf_counter()
    hy = make_codec("hybrid", rs_data=k, rs_parity=m, device=ctx["device"],
                    block_size=blk, device_batch_blocks=1024, hybrid_window=1,
                    transport_staging_slots=2, pool_mib=256,
                    pool_page_kib=256, max_device_staging_mib=4096)
    hy.warm(blk)
    build_s = time.perf_counter() - t_build
    tr, pool = hy.transport, hy.pool
    check(tr is not None and tr.pinned and pool is not None,
          "hybrid did not arm a pinned transport with a pool")
    feeder = CodecFeeder(hy)
    obs = hy.obs

    def stages():
        return {k: v["seconds"] for k, v in obs.stage_stats().items()}

    def snap():
        return {"stages": stages(), "bytes": dict(obs.bytes_total),
                "staged": tr.staged_bytes, "pool": pool.stats(),
                "dispatches": tr.dispatches}

    # warm-up: one small background batch of other blocks, so the gate
    # probe has run before anything is measured
    rng = np.random.default_rng(SEED + 3)
    wb = [rng.bytes(blk) for _ in range(2 * k)]
    wh = [Hash(hashlib_digest(b)) for b in wb]
    wok, _ = asyncio.run(feeder.scrub_async(wb, wh))
    check(wok.all(), "warm-up scrub batch did not verify")
    check(hy.ragged_side() == "tpu", "the gate did not open after the "
          f"warm-up batch (link {hy._link_rate} GiB/s)")

    by_path = {}
    path_needs = {"prod_scrub_cold": CODEC_KERNELS,
                  "prod_scrub_warm": CODEC_KERNELS,
                  "prod_put": ("blake2s", "gf_apply"),
                  "prod_decode": ("gf_apply",)}

    def end_path(path):
        torch.cuda.synchronize()
        by_path[path] = counts_now(mods)
        for name in path_needs[path]:
            check(by_path[path][name] > 0,
                  f"kernel {name} was not launched on the {path} path")
        check_gf_bodies(path, by_path[path]["gf_apply_by"])

    def scrub_pass(path, bs, hs):
        before = snap()
        reset_counts(torch, mods)
        t0 = time.perf_counter()
        out = asyncio.run(_gather_scrubs(feeder, bs, hs))
        wall = time.perf_counter() - t0
        end_path(path)
        after = snap()
        nbytes = sum(len(x) for b in bs for x in b)
        delta = {
            "wall_s": wall, "bytes": nbytes,
            "gibs": nbytes / wall / 2**30,
            "stages": stage_delta(before["stages"], after["stages"]),
            "side_bytes": {s: after["bytes"].get(s, 0) - before["bytes"].get(s, 0)
                           for s in ("cpu", "tpu")},
            "staged": after["staged"] - before["staged"],
            "hit": after["pool"]["hit_bytes"] - before["pool"]["hit_bytes"],
            "miss": after["pool"]["miss_bytes"] - before["pool"]["miss_bytes"],
            "dispatches": after["dispatches"] - before["dispatches"],
        }
        check(delta["side_bytes"]["cpu"] == 0,
              f"{path}: {delta['side_bytes']['cpu']} scrub bytes ran on the CPU")
        check(delta["side_bytes"]["tpu"] == nbytes,
              f"{path}: device bytes {delta['side_bytes']['tpu']} != {nbytes}")
        check(delta["hit"] + delta["miss"] == nbytes,
              f"{path}: pool hit {delta['hit']} + miss {delta['miss']} != "
              f"{nbytes} scrubbed")
        return out, delta

    # cold: the main phase's 4 x 256 x 1 MiB scrub with its corruptions
    cold_out, cold = scrub_pass("prod_scrub_cold", batches, hashes)
    for bi, (ok, par) in enumerate(cold_out):
        check(np.array_equal(ok, want_ok[bi]),
              f"production scrub batch {bi}: ok vector wrong")
        check(np.array_equal(par, want_par[bi]),
              f"production scrub batch {bi}: parity != numpy GF(2^8)")
    # warm: the last batch's verified blocks, a working set that fits the
    # 256 MiB pool and is resident after the cold pass
    last = len(batches) - 1
    keep = [i for i in range(lanes) if want_ok[last][i]]
    wset = [[batches[last][i] for i in keep]]
    whash = [[hashes[last][i] for i in keep]]
    warm_out, warm = scrub_pass("prod_scrub_warm", wset, whash)
    check(warm_out[0][0].all(), "warm pass: ok vector wrong")
    check(np.array_equal(warm_out[0][1], oracle_parity(
        oracle, gf256.rs_parity_matrix(k, m), wset[0], blk)),
          "warm pass: parity != numpy GF(2^8)")
    check(warm["hit"] == warm["bytes"],
          f"warm pass: pool hit {warm['hit']} B != {warm['bytes']} B scrubbed")
    check(warm["staged"] == 0, f"warm pass staged {warm['staged']} B")

    # foreground: 64 concurrent PUT hashes, 32 write-time encodes, then
    # 32 degraded decodes with shards 2 and 5 of 12 lost
    ncw = data.shape[0]
    present = [0, 1, 3, 4, 6, 7, 8, 9, 10, 11]
    lost = [2, 5]

    async def put():
        hs = asyncio.gather(*[feeder.hash_async([b], peers=len(put_blocks))
                              for b in put_blocks])
        encs = [asyncio.wrap_future(feeder.submit_encode(
            [data[c, i].tobytes() for i in range(k)], peers=ncw))
            for c in range(ncw)]
        return await hs, await asyncio.gather(*encs)

    async def degraded():
        full = np.concatenate([data, put_parity], axis=1)
        surv = full[:, present]
        return await asyncio.gather(*[
            feeder.decode_async(surv[c:c + 1], present, lost)
            for c in range(ncw)])

    side0 = dict(obs.bytes_total)
    reset_counts(torch, mods)
    t1 = time.perf_counter()
    put_digests, enc_parity = asyncio.run(put())
    put_s = time.perf_counter() - t1
    end_path("prod_put")
    reset_counts(torch, mods)
    t2 = time.perf_counter()
    decoded = asyncio.run(degraded())
    decode_s = time.perf_counter() - t2
    end_path("prod_decode")
    fg_cpu = obs.bytes_total.get("cpu", 0) - side0.get("cpu", 0)
    for b, d in zip(put_blocks, put_digests):
        check(bytes(d[0]) == hashlib_digest(b), "production PUT digest wrong")
    check(np.array_equal(np.concatenate(enc_parity), put_parity),
          "production write-time encode parity wrong")
    for c, d in enumerate(decoded):
        check(np.array_equal(d[0], data[c, lost]),
              f"production degraded read codeword {c} wrong")
    feeder.shutdown()

    # the stack's health: no fallback, no failure event of any kind, from
    # the transport or from the hybrid codec's own engine
    st = tr.stats()
    bad_events = [e for e in obs.events_list() if bad_event(e)]
    check(tr.alive, "transport is down")
    check(st["fallbacks"] == 0, f"transport fallbacks: {st['fallbacks']}")
    check(st["device_errors"] == 0,
          f"failed device batches: {st['device_errors']}")
    check(not bad_events, f"transport/device failure events: {bad_events}")
    check(st["copies_per_block"] <= 1.0,
          f"copies_per_block {st['copies_per_block']} > 1")
    check(fg_cpu == 0, f"{fg_cpu} foreground bytes ran on the CPU")

    # pinned H2D of one 256 MiB staging slot, beside phase_times' pageable
    slot = tr._slot_tensors[0]
    check(slot is not None and slot.is_pinned(), "slot 0 is not pinned")
    _, pinned_ms = time_host(
        torch, lambda: slot.to(ctx["device"], non_blocking=True))
    slot_bytes = slot.numel()
    launches = {name: sum(c[name] for c in by_path.values())
                for name in KERNELS}
    pool_st = pool.stats()
    hy.close()

    def per_batch(d, key):
        return d["stages"].get(key, 0.0) / max(1, d["dispatches"])

    for label, d in (("cold", cold), ("warm", warm)):
        log(f"[production] scrub {label}: {d['bytes'] / 2**20:.0f} MiB in "
            f"{d['wall_s'] * 1e3:.1f} ms = {d['gibs']:.3f} GiB/s end to end; "
            f"bytes by side {json.dumps(d['side_bytes'])}; staged "
            f"{d['staged']} B; pool hit {d['hit']} B, miss {d['miss']} B; "
            f"{d['dispatches']} device batches")
        log(f"[production] {label} stages (s): {json.dumps(d['stages'])}")
    log(f"[production] cold collect per batch: event wait "
        f"{per_batch(cold, 'collect_wait/tpu') * 1e3:.2f} ms, D2H "
        f"{per_batch(cold, 'collect_d2h/tpu') * 1e3:.2f} ms, host copy-out "
        f"{per_batch(cold, 'collect_copy_out/tpu') * 1e3:.2f} ms, pool adoption "
        f"{per_batch(cold, 'pool_adopt/tpu') * 1e3:.2f} ms (sync_collect "
        f"{per_batch(cold, 'sync_collect/tpu') * 1e3:.2f} ms)")
    log(f"[production] pinned H2D of one {slot_bytes / 2**20:.0f} MiB slot: "
        f"{pinned_ms:.2f} ms ({slot_bytes / pinned_ms / 1e6:.2f} GB/s)")
    log(f"[production] 64 PUT hashes + {ncw} encodes {put_s * 1e3:.1f} ms, "
        f"{ncw} degraded decodes {decode_s * 1e3:.1f} ms: digests == hashlib, "
        "parity and decodes bit-identical; foreground CPU bytes 0")
    log(f"[production] transport: alive, fallbacks 0, copies_per_block "
        f"{st['copies_per_block']}, pinned {st['pinned']}, dispatches "
        f"{st['dispatches']}, max staged {st['max_staged_bytes_seen']} B; "
        f"pool {json.dumps({k: v for k, v in pool_st.items() if k in ('resident_blocks', 'resident_bytes', 'adopted', 'evicted_lru')})}; "
        f"hybrid built and warmed in {build_s:.2f} s")
    for path, counts in by_path.items():
        log(f"[production] launches on the {path} path: {json.dumps(counts)}")
    return {"launches": launches, "launches_by_path": by_path,
            "cold": cold, "warm": warm, "pinned_h2d_ms": pinned_ms,
            "slot_bytes": slot_bytes, "put_s": put_s, "decode_s": decode_s,
            "transport": {k: v for k, v in st.items() if k != "stages"}}


# events that mean work failed on the device, left it, or was redone
# elsewhere: any of them fails the production phase
FAILURE_EVENTS = ("transport_error", "transport_fallback", "transport_down",
                  "feeder_error", "sync_failure", "tail_hedge", "cede")


def bad_event(e) -> bool:
    kind, reason = e["kind"], e.get("reason")
    return (kind in FAILURE_EVENTS
            or (kind == "device_attach" and reason != "ok")
            or (kind in ("probe", "transport_probe")
                and reason not in ("ok", "unmetered"))
            or (kind == "gate" and reason != "open"))


async def _gather_scrubs(feeder, bs, hs):
    return await asyncio.gather(*[feeder.scrub_async(b, h)
                                  for b, h in zip(bs, hs)])


# --- the block store node: Config → System → BlockManager → ScrubWorker ---

# node i's [codec] section; everything else is the reference default
# (1 MiB blocks, RS(8,4), compression_level 1, the sqlite engine)
STORE_NODES = ({"backend": "hybrid"}, {"backend": "cuda"},
               {"backend": "hybrid", "store_parity": True})
# what each store path must launch where its device route is fixed:
# node 1's cuda codec, and node 2's sidecar repair, whose background
# decode rides a probed link (GF_BODIES holds their GF bodies); node 0's
# hybrid gate decides its own route and is reported as measured
STORE_NEEDS = {"store_get": ("blake2s",), "store_scrub_n1": CODEC_KERNELS,
               "store_rescrub_n1": CODEC_KERNELS,
               "store_repair_n2": CODEC_KERNELS}


def store_memory_reckoning(blk: int, backends=None) -> dict:
    """Upper bounds of what one node's codec holds, at the reference
    defaults (ops/codec.py CodecParams) and the staging clamp of
    ops/hybrid_codec.py: a hybrid node stages at most (hybrid_window + 1)
    device submissions of device_batch_blocks blocks, in pinned slots of
    at most max_device_staging_mib / transport_staging_slots each, and
    holds their parity (m/k of the data) and pool_mib of pool pages on
    the card; a cuda node holds one feeder batch (feeder_max_batch_blocks
    blocks) and its parity on the card and pins nothing.  `backends`
    lists the nodes' backends (default: the store phase's three)."""
    from garage_tpu_torch.ops.codec import CodecParams
    from garage_tpu_torch.utils.config import CodecConfig

    p, c = CodecParams(block_size=blk), CodecConfig()
    window = max(1, p.hybrid_window)
    sub = min(p.device_batch_blocks,
              max(p.hybrid_group_blocks,
                  (p.max_device_staging_mib << 20) // ((window + 1) * blk)))
    slot = min(sub * blk,
               (p.max_device_staging_mib << 20) // p.transport_staging_slots)
    grow = 1 + p.rs_parity / p.rs_data
    hybrid = {"pinned_host": p.transport_staging_slots * slot,
              "device_staging": int((window + 1) * sub * blk * grow),
              "device_pool": p.pool_mib << 20}
    cuda = {"pinned_host": 0,
            "device_staging": int(c.feeder_max_batch_blocks * blk * grow),
            "device_pool": 0}
    if backends is None:
        backends = [n["backend"] for n in STORE_NODES]
    nodes = [cuda if b == "cuda" else hybrid for b in backends]
    return {"per_node": nodes,
            "pinned_host": sum(n["pinned_host"] for n in nodes),
            "device": sum(n["device_staging"] + n["device_pool"]
                          for n in nodes)}


async def store_nodes(root: Path, blk: int) -> list:
    """Three port Systems meshed on loopback with an applied layout
    (replication 3), each with a sqlite db, a BlockManager whose codec
    its Config builds (config.codec.make(), on the card), and a resync
    manager, wired as the daemon wires them; node 2 gets a ParityStore."""
    from garage_tpu_torch.block import BlockManager, BlockResyncManager
    from garage_tpu_torch.block.parity import ParityStore
    from garage_tpu_torch.block.resync import ResyncPersistedConfig
    from garage_tpu_torch.db import open_db
    from garage_tpu_torch.rpc.layout import ClusterLayout, NodeRole
    from garage_tpu_torch.rpc.system import System
    from garage_tpu_torch.table import TableShardedReplication
    from garage_tpu_torch.utils.config import config_from_dict
    from garage_tpu_torch.utils.persister import Persister

    systems = []
    for i, codec in enumerate(STORE_NODES):
        s = System(config_from_dict({
            "metadata_dir": str(root / f"n{i}" / "meta"),
            "data_dir": str(root / f"n{i}" / "data"),
            "replication_mode": "3", "block_size": blk,
            "rpc_bind_addr": "127.0.0.1:0", "rpc_secret": "chip-smoke",
            "bootstrap_peers": [], "codec": dict(codec)}))
        await s.netapp.listen("127.0.0.1:0")
        systems.append(s)
    ports = [s.netapp._server.sockets[0].getsockname()[1] for s in systems]
    for i, a in enumerate(systems):
        for j in range(i + 1, len(systems)):
            await a.netapp.connect(f"127.0.0.1:{ports[j]}",
                                   expected_id=systems[j].id)
        a.config.rpc_public_addr = f"127.0.0.1:{ports[i]}"
    lay = systems[0].layout
    for s in systems:
        lay.stage_role(bytes(s.id), NodeRole("dc1", 1000))
    lay.apply_staged_changes()
    enc = lay.encode()
    nodes = []
    for s in systems:
        s.layout = ClusterLayout.decode(enc)
        s._rebuild_ring()
        check(s.ring.ready, "store: ring not ready after the layout")
        cfg, mode = s.config, s.replication_mode
        db = open_db(cfg.db_engine,
                     path=os.path.join(cfg.metadata_dir, "db.sqlite"))
        m = BlockManager(cfg, db, s, TableShardedReplication(
            s, mode.replication_factor, 1, mode.write_quorum))
        m.resync = BlockResyncManager(m, db, persister=Persister(
            cfg.metadata_dir, "resync_cfg", ResyncPersistedConfig))
        m.startup_janitor()
        if cfg.codec.store_parity:
            m.parity_store = ParityStore(m, db, m.codec)
        nodes.append(m)
    return nodes


def store_blocks(n: int, blk: int, rng) -> tuple:
    """(blocks, indices of the compressible ones): n blocks of blk bytes,
    the last of every 256 700,001 B (at 1 MiB blocks), one in 16 a
    512-byte pattern repeated, which compression_level 1 stores
    compressed; the rest random."""
    period = min(256, n)
    short = 700001 * blk // MIB
    blocks, compressible = [], []
    for i in range(n):
        size = short if i % period == period - 1 else blk
        if i % 16 == 7:
            blocks.append((rng.bytes(512) * (size // 512 + 1))[:size])
            compressible.append(i)
        else:
            blocks.append(rng.bytes(size))
    return blocks, compressible


def flip_byte(path: str, off: int) -> None:
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


def sidecar_parity_checked(store, blocks_by_hash, oracle, mat) -> int:
    """Every sidecar manifest under `store`'s parity dirs: its parity
    rows against the numpy GF(2^8) oracle over its member blocks, zero
    padded to the manifest's width.  Returns the number of codewords."""
    import msgpack

    n = 0
    for base in store.all_dirs:
        for dirpath, _dirs, files in os.walk(base):
            for name in files:
                with open(os.path.join(dirpath, name), "rb") as f:
                    man = msgpack.unpackb(f.read(), raw=False)
                k, maxlen = man["k"], man["maxlen"]
                rows = np.zeros((k, maxlen), np.uint8)
                for i, h in enumerate(man["hashes"]):
                    b = blocks_by_hash[bytes(h)]
                    rows[i, :len(b)] = np.frombuffer(b, np.uint8)
                want = oracle.apply(mat, rows[None])[0]
                got = np.stack([np.frombuffer(p, np.uint8)
                                for p in man["parity"]])
                check(np.array_equal(got, want),
                      f"sidecar {name}: parity != numpy GF(2^8)")
                n += 1
    return n


def phase_store(ctx) -> dict:
    """One block store node's paths on the card: three nodes' PUT, GET
    verify, scrub, quarantine, resync and sidecar repair, every byte
    checked against hashlib and the numpy oracle."""
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_store_"))
    try:
        return asyncio.run(_store(ctx, root))
    finally:
        shutil.rmtree(root, ignore_errors=True)


async def _store(ctx, root: Path) -> dict:
    torch = ctx["torch"]
    from garage_tpu_torch.block.repair import ScrubWorker, ScrubWorkerState
    from garage_tpu_torch.block.resync import ResyncWorker
    from garage_tpu_torch.ops import cuda_blake2s, cuda_codec, cuda_gf, gf256
    from garage_tpu_torch.tools import gf_tune
    from garage_tpu_torch.utils.data import Hash
    from garage_tpu_torch.utils.persister import Persister
    from garage_tpu_torch.utils.zstd_compat import HAVE_ZSTD

    mods = (cuda_blake2s, cuda_gf, cuda_codec, gf_tune)
    blk, n = ctx["block"], ctx["store_blocks"]
    k, m = 8, 4
    oracle, mat = ctx["oracle"], gf256.rs_parity_matrix(k, m)
    reck = store_memory_reckoning(blk)
    log(f"[store] memory reckoning at the reference defaults, upper bounds "
        f"per node (hybrid, cuda, hybrid): "
        f"{json.dumps(reck['per_node'])}; three nodes: pinned host "
        f"{reck['pinned_host'] / 2**30:.2f} GiB, device "
        f"{reck['device'] / 2**30:.2f} GiB of the card's "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t_build = time.perf_counter()
    nodes = await store_nodes(root, blk)
    build_s = time.perf_counter() - t_build
    for i, node in enumerate(nodes):
        codec = node.codec
        dev = getattr(codec, "device", None)
        check(str(dev).startswith("cuda"), f"store node {i}: codec "
              f"{type(codec).__name__} is on {dev}, not the card")
    log(f"[store] on {ctx['card']}: 3 nodes on loopback (replication 3, "
        f"sqlite, {blk} B blocks, RS({k},{m}), compression_level 1; zstd wheel "
        f"HAVE_ZSTD={HAVE_ZSTD}): codecs "
        f"{[type(x.codec).__name__ for x in nodes]} built from Config in "
        f"{build_s:.2f} s")

    by_path, out = {}, {"build_s": build_s, "memory_reckoning": reck}

    def end_path(path):
        torch.cuda.synchronize()
        by_path[path] = counts_now(mods)
        for name in STORE_NEEDS.get(path, ()):
            check(by_path[path][name] > 0,
                  f"kernel {name} was not launched on the {path} path")
        if path in GF_BODIES:
            check_gf_bodies(path, by_path[path]["gf_apply_by"])

    async def bounded(coros, width=16):
        sem = asyncio.Semaphore(width)

        async def one(c):
            async with sem:
                return await c
        return await asyncio.gather(*[one(c) for c in coros])

    # 1. PUT: node 0's feeder hashes (the S3 PUT path's call), node 0
    # writes to the block's three replicas
    rng = np.random.default_rng(SEED + 5)
    blocks, compressible = store_blocks(n, blk, rng)
    total = sum(len(b) for b in blocks)
    reset_counts(torch, mods)
    t0 = time.perf_counter()
    digs = await asyncio.gather(*[nodes[0].feeder.hash_async([b], peers=n)
                                  for b in blocks])
    hash_s = time.perf_counter() - t0
    hashes = []
    for b, d in zip(blocks, digs):
        check(bytes(d[0]) == hashlib_digest(b), "store PUT digest != hashlib")
        hashes.append(Hash(bytes(d[0])))
    by_hash = {bytes(h): b for h, b in zip(hashes, blocks)}
    t1 = time.perf_counter()
    await bounded([nodes[0].rpc_put_block(h, b)
                   for h, b in zip(hashes, blocks)])
    put_s = time.perf_counter() - t1
    end_path("store_put")
    deadline = time.monotonic() + 120
    while not all(x.is_block_present(h) for x in nodes for h in hashes):
        check(time.monotonic() < deadline,
              "store: not every block reached all three nodes in 120 s")
        await asyncio.sleep(0.05)
    stored_compressed = {i for i, h in enumerate(hashes)
                         if nodes[0].find_block(h)[1]}
    check(stored_compressed == set(compressible),
          f"store: {len(stored_compressed)} blocks stored compressed, "
          f"expected the {len(compressible)} compressible ones")
    # the references an object table would hold
    for x in nodes:
        x.db.transaction(lambda tx, x=x: [x.rc.block_incref(tx, h)
                                          for h in hashes])
    log(f"[store] PUT {n} blocks ({total / 2**30:.3f} GiB, "
        f"{len(compressible)} stored compressed): node 0 hash_async "
        f"{hash_s:.3f} s (digests == hashlib), rpc_put_block x {n} "
        f"{put_s:.3f} s ({total / put_s / 2**30:.3f} GiB/s), on all 3 "
        f"nodes; bytes by side node 0 {json.dumps(nodes[0].codec.obs.bytes_total)}")
    out.update(put_hash_s=hash_s, put_s=put_s, put_bytes=total)

    # 2. GET on node 1: local copies verified through its feeder on the
    # card; then 8 local copies deleted, read from peers
    g = np.random.default_rng(SEED + 6)
    order = [int(i) for i in g.permutation(n)]
    n_get = min(256, n // 4)
    get_idx, gone_idx = order[:n_get], order[n_get:n_get + 8]
    reset_counts(torch, mods)
    t2 = time.perf_counter()
    got = await bounded([nodes[1].rpc_get_block(hashes[i]) for i in get_idx])
    get_s = time.perf_counter() - t2
    for i, b in zip(get_idx, got):
        check(b == blocks[i], f"store GET block {i} differs")
    for i in gone_idx:
        os.remove(nodes[1].find_block(hashes[i])[0])
    t3 = time.perf_counter()
    got = await bounded([nodes[1].rpc_get_block(hashes[i]) for i in gone_idx])
    peer_s = time.perf_counter() - t3
    end_path("store_get")
    for i, b in zip(gone_idx, got):
        check(b == blocks[i] and not nodes[1].is_block_present(hashes[i]),
              f"store GET of block {i} from a peer differs")
    log(f"[store] GET on node 1: {n_get} local blocks {get_s:.3f} s, "
        f"{len(gone_idx)} with the local copy deleted, from peers, "
        f"{peer_s:.3f} s: bytes equal")
    out.update(get_s=get_s, get_blocks=n_get, peer_get_s=peer_s)

    # 3. scrub with 3 planted corruptions on nodes 0 and 1
    gone = set(gone_idx)
    plain = [i for i in range(n) if i not in compressible and i not in gone]
    victims = [int(i) for i in g.choice(plain, 7, replace=False)]
    planted = {0: victims[:3], 1: victims[3:6], 2: victims[6:]}
    workers = {}

    async def scrub_pass(ni, path):
        node = nodes[ni]
        w = workers.get(ni)
        if w is None:
            w = workers[ni] = ScrubWorker(node, persister=Persister(
                node.config.metadata_dir, "scrub_info", ScrubWorkerState))
            w.set_tranquility(0)
        obs, fd = node.codec.obs, node.feeder
        tr = getattr(node.codec, "transport", None)
        side0, fs0 = dict(obs.bytes_total), fd.stats()
        st0 = {k: v["seconds"] for k, v in obs.stage_stats().items()}
        tr0 = tr.stats() if tr is not None else None
        nbytes = sum(len(blocks[i]) for i, h in enumerate(hashes)
                     if node.is_block_present(h))
        reset_counts(torch, mods)
        t = time.perf_counter()
        w.send_command("start")
        while (await w.work()).name in ("BUSY", "THROTTLED"):
            pass
        wall = time.perf_counter() - t
        end_path(path)
        fs = fd.stats()
        disp = fs["dispatches"] - fs0["dispatches"]
        res = {"node": ni, "wall_s": wall, "bytes": nbytes,
               "gibs": nbytes / wall / 2**30,
               "corruptions": w.state.corruptions,
               "feeder_dispatches": disp,
               "blocks_per_dispatch": (fs["dispatched_blocks"]
                                       - fs0["dispatched_blocks"]) / max(1, disp),
               "side_bytes": {s: obs.bytes_total.get(s, 0) - side0.get(s, 0)
                              for s in ("cpu", "tpu")},
               "stages": stage_delta(st0, {k: v["seconds"] for k, v
                                           in obs.stage_stats().items()}),
               "launches": by_path[path]}
        if tr is not None:
            st = tr.stats()
            res.update(device_batches=st["dispatches"] - tr0["dispatches"],
                       copies_per_block=st["copies_per_block"],
                       staged_bytes=st["staged_bytes"] - tr0["staged_bytes"])
        log(f"[store] {path}: node {ni} ({STORE_NODES[ni]['backend']}) "
            f"{nbytes / 2**20:.0f} MiB in {wall:.3f} s = {res['gibs']:.4f} "
            f"GiB/s, {res['corruptions']} corruptions, {disp} feeder "
            f"dispatches, {res['blocks_per_dispatch']:.2f} blocks per "
            f"dispatch; bytes by side {json.dumps(res['side_bytes'])}"
            + (f"; {res['device_batches']} device batches, staged "
               f"{res['staged_bytes']} B, copies_per_block "
               f"{res['copies_per_block']}" if tr is not None else "")
            + f"; launches {json.dumps(res['launches'])}")
        log(f"[store] {path} codec stages (s): {json.dumps(res['stages'])}")
        return res

    log("[store] scrub tranquility 0: the operator's `repair scrub "
        "set-tranquility 0`; the default 4 (block/repair.py) sleeps 4x "
        "the work time between batches")
    bad_paths = {}
    for ni in (0, 1):
        for i in planted[ni]:
            path = bad_paths[ni, i] = nodes[ni].find_block(hashes[i])[0]
            flip_byte(path, int(g.integers(0, len(blocks[i]))))
    # node 1's reads of its 8 deleted copies queued their refetch
    # (source "serve_miss"); the scrub adds the quarantined copies
    refetch = {0: list(planted[0]), 1: planted[1] + gone_idx}
    passes = []
    for ni in (0, 1):
        res = await scrub_pass(ni, f"store_scrub_n{ni}")
        passes.append(res)
        node = nodes[ni]
        check(res["corruptions"] == len(planted[ni]),
              f"store node {ni}: scrub found {res['corruptions']} "
              f"corruptions, {len(planted[ni])} planted")
        for i in planted[ni]:
            check(not node.is_block_present(hashes[i])
                  and os.path.exists(bad_paths[ni, i] + ".corrupted"),
                  f"store node {ni}: corrupt block {i} not quarantined")
        check(node.resync.enqueue_counts.get("scrub_corrupt") ==
              len(planted[ni]), f"store node {ni}: scrub queued "
              f"{node.resync.enqueue_counts.get('scrub_corrupt')} resyncs")
        queued = sorted(bytes(key[8:]) for key, _v in
                        node.resync.queue.items(None, None))
        check(queued == sorted(bytes(hashes[i]) for i in refetch[ni]),
              f"store node {ni}: resync queue holds {len(queued)} "
              f"blocks, expected the {len(refetch[ni])} to refetch")
        log(f"[store] node {ni}: {len(planted[ni])} corrupt copies "
            f"quarantined (.corrupted), resync queue {len(queued)} "
            f"({json.dumps(node.resync.enqueue_counts)})")
    check(passes[1]["side_bytes"]["cpu"] == 0,
          f"store node 1 (cuda): {passes[1]['side_bytes']['cpu']} scrub "
          "bytes on the CPU")

    # 4. resync: each quarantined copy comes back from a peer; a second
    # pass finds nothing
    for ni in (0, 1):
        node = nodes[ni]
        rw = ResyncWorker(node.resync)
        t = time.perf_counter()
        deadline = time.monotonic() + 120
        while node.resync.queue_len():
            check(time.monotonic() < deadline,
                  f"store node {ni}: resync did not drain in 120 s")
            if (await rw.work()).name == "IDLE":
                await rw.wait_for_work()
        resync_s = time.perf_counter() - t
        for i in refetch[ni]:
            blk_back = await node.read_block(hashes[i])
            check(blk_back.decompressed() == blocks[i],
                  f"store node {ni}: resynced block {i} differs")
        log(f"[store] resync node {ni}: {len(refetch[ni])} blocks back "
            f"from peers, bit-equal, in {resync_s:.3f} s")
        out[f"resync_n{ni}_s"] = resync_s
    for ni in (0, 1):
        res = await scrub_pass(ni, f"store_rescrub_n{ni}")
        passes.append(res)
        check(res["corruptions"] == 0,
              f"store node {ni}: second pass found {res['corruptions']}")

    # 5. sidecar repair on node 2
    node = nodes[2]
    res = await scrub_pass(2, "store_scrub_n2")
    passes.append(res)
    check(res["corruptions"] == 0, "store node 2: first pass found "
          f"{res['corruptions']} corruptions")
    t = time.perf_counter()
    ncw = sidecar_parity_checked(node.parity_store, by_hash, oracle, mat)
    oracle_s = time.perf_counter() - t
    check(ncw == n // k, f"store node 2: {ncw} sidecars, expected {n // k}")
    log(f"[store] node 2: {ncw} sidecar codewords, parity == numpy GF(2^8) "
        f"({oracle_s:.1f} s of numpy)")
    vi = planted[2][0]
    flip_byte(node.find_block(hashes[vi])[0],
              int(g.integers(0, len(blocks[vi]))))
    node.blocks_reconstructed = 0
    res = await scrub_pass(2, "store_repair_n2")
    passes.append(res)
    check(res["corruptions"] == 1 and node.blocks_reconstructed == 1,
          f"store node 2: {res['corruptions']} corruptions, "
          f"{node.blocks_reconstructed} reconstructed (1 and 1 expected)")
    check(node.resync.queue_len() == 0,
          "store node 2: the sidecar repair queued a network resync")
    check((await node.read_block(hashes[vi])).decompressed() == blocks[vi],
          "store node 2: the rebuilt block differs")
    log(f"[store] node 2: corrupt block rebuilt from its sidecar on the "
        f"card (decode body k8r1 launched "
        f"{res['launches']['gf_apply_by'].get('k8r1', 0)} times), "
        f"bytes equal, resync queue 0; pass {res['wall_s']:.3f} s")

    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - mem0
    pinned = sum(t.numel() for x in nodes
                 for t in getattr(getattr(x.codec, "transport", None),
                                  "_slot_tensors", []) if t is not None)
    log(f"[store] measured: peak device allocation {peak / 2**30:.3f} GiB "
        f"over the phase, pinned staging slots {pinned / 2**20:.0f} MiB")
    for x in nodes:
        x.feeder.shutdown()
        close = getattr(x.codec, "close", None)
        if close is not None:
            close()
        await x.system.netapp.shutdown()
        x.db.close()
    launches = {name: sum(c[name] for c in by_path.values())
                for name in KERNELS}
    for path, counts in by_path.items():
        log(f"[store] launches on the {path} path: {json.dumps(counts)}")
    out.update(passes=passes, launches=launches, launches_by_path=by_path,
               peak_device_bytes=peak, pinned_slot_bytes=pinned,
               sidecar_codewords=ncw, have_zstd=HAVE_ZSTD)
    return out


# --- the Garage node: table/ and model/ over the block store (slice 3b) ---

# node i's codec backend: the writer (node 0) and nodes 2-5 put every
# device call on the card, so no gate can route round it; node 1 runs
# the hybrid stack users run (its launches are printed, not required)
GARAGE_BACKENDS = ("cuda", "hybrid", "cuda", "cuda", "cuda", "cuda")
# the erasure-coded storage class of tests/test_model.py make_ec_cluster
# (meta "3", data "none", write-time distributed parity) at the codec's
# default geometry.  repair_ppr off: with partial-parallel repair (the
# default) each survivor scales its piece on the host (gf_scale, numpy in
# both packages) and no decode reaches the GF kernel; whole-shard repair
# decodes every codeword through the reader's feeder (K3)
GARAGE_CODEC = {"rs_data": 8, "rs_parity": 4, "store_parity": True,
                "parity_on_write": True, "parity_distribute": True,
                "repair_ppr": False}
GARAGE_NEEDS = {"garage_write": ("blake2s", "gf_apply"),
                "garage_degraded_get": ("gf_apply",),
                "garage_heal": ("gf_apply",),
                "garage_scrub": ("fused_scrub",)}
# the GF bodies a path may run: encodes (k8r4) beside the decodes of one
# lost row (k8r1) or two (k8r2: a codeword's members sit on distinct
# nodes, so two dead nodes take at most two of them, and the chain repair
# decodes both when one survivor owns both); a heal writes blocks that
# join local sidecar codewords
GARAGE_BODIES = {"garage_write": {"k8r4"},
                 "garage_degraded_get": {"k8r1", "k8r4"},
                 "garage_heal": {"k8r1", "k8r2", "k8r4"}}


class NodeTally:
    """What one node's codec did, counted at its seams: each call of its
    CudaCodec's `_gf` (one GF kernel launch on the card; the fused scrub
    calls the kernel itself and is not counted here) by body, with the
    codewords it carried (its batch dimension); on a hybrid node, the
    RS encodes and decodes its CPU floor ran; and the feeder's inline
    encode and decode dispatches into the codec (`rs_encode_ragged`,
    `rs_reconstruct_ragged`; a hybrid node's transport dispatches reach
    `_gf` without them).  The kernel wrappers' launch counters are
    process-wide and six nodes share this process: the tallies attribute
    launches to nodes, and each path checks that they add up to the
    counter."""

    SEAMS = ("gf", "cpu_encode", "cpu_decode", "feeder_encode",
             "feeder_decode")

    def __init__(self, codec, k: int):
        from garage_tpu_torch.ops.cuda_gf import instantiation

        self.lock = threading.Lock()
        self.reset()
        dev = getattr(codec, "tpu", codec)
        check(dev is not None, "a hybrid node has no device codec")

        def wrap(obj, name, seam, key_fn, codewords_fn):
            inner = getattr(obj, name)

            def counted(*a):
                out = inner(*a)
                self._add(seam, key_fn(*a), codewords_fn(*a))
                return out
            setattr(obj, name, counted)

        wrap(dev, "_gf", "gf",
             lambda u8, c: instantiation(int(u8.shape[1]), int(c.shape[0])),
             lambda u8, c: int(u8.shape[0]))
        cpu = getattr(codec, "cpu", None)
        if cpu is not None:
            wrap(cpu, "rs_encode_blocks", "cpu_encode", lambda b: "all",
                 lambda b: -(-len(b) // k))
            wrap(cpu, "rs_reconstruct", "cpu_decode", lambda s, *a: "all",
                 lambda s, *a: int(np.prod(s.shape[:-2])))
        wrap(codec, "rs_encode_ragged", "feeder_encode", lambda g: "all",
             lambda g: sum(-(-len(x) // k) for x in g))
        wrap(codec, "rs_reconstruct_ragged", "feeder_decode",
             lambda items: "all",
             lambda items: sum(int(it[0].shape[0]) for it in items))

    def reset(self) -> None:
        with self.lock:
            self.calls = {s: {} for s in self.SEAMS}
            self.codewords = {s: {} for s in self.SEAMS}

    def _add(self, seam: str, key: str, codewords: int) -> None:
        with self.lock:
            c, w = self.calls[seam], self.codewords[seam]
            c[key] = c.get(key, 0) + 1
            w[key] = w.get(key, 0) + codewords

    def gf_calls(self) -> int:
        return sum(self.calls["gf"].values())

    def snapshot(self) -> dict:
        with self.lock:
            out = {"gf_launches": dict(self.calls["gf"]),
                   "gf_codewords": dict(self.codewords["gf"])}
            for seam in self.SEAMS[1:]:
                out[f"{seam}_calls"] = self.calls[seam].get("all", 0)
                out[f"{seam}_codewords"] = self.codewords[seam].get("all", 0)
            return out


async def garage_nodes(root: Path, blk: int) -> list:
    """Six port Garage nodes on loopback, each built from its Config
    (Garage(config): the codec on the card), meshed with every peer's
    address recorded both ways, the peering loop running, one applied
    layout (zone dc1, equal capacity) and the workers spawned, as
    tests/test_model.py make_ec_cluster wires them."""
    from garage_tpu_torch.model import Garage
    from garage_tpu_torch.rpc.layout import ClusterLayout, NodeRole
    from garage_tpu_torch.utils.config import config_from_dict

    gs = []
    for i, backend in enumerate(GARAGE_BACKENDS):
        gs.append(Garage(config_from_dict({
            "metadata_dir": str(root / f"n{i}" / "meta"),
            "data_dir": str(root / f"n{i}" / "data"),
            "replication_mode": "3", "data_replication_mode": "none",
            "block_size": blk, "db_engine": "sqlite",
            "rpc_bind_addr": "127.0.0.1:0", "rpc_secret": "chip-smoke-ec",
            "bootstrap_peers": [],
            "codec": {"backend": backend, **GARAGE_CODEC}})))
    for g in gs:
        await g.system.netapp.listen("127.0.0.1:0")
    ports = [g.system.netapp._server.sockets[0].getsockname()[1] for g in gs]
    for i, a in enumerate(gs):
        for j, b in enumerate(gs):
            if i < j:
                await a.system.netapp.connect(f"127.0.0.1:{ports[j]}",
                                              expected_id=b.system.id)
            if i != j:
                a.system.peering.add_peer(f"127.0.0.1:{ports[j]}",
                                          b.system.id)
        a.config.rpc_public_addr = f"127.0.0.1:{ports[i]}"
        a.system.peering.start()
    lay = gs[0].system.layout
    for g in gs:
        lay.stage_role(bytes(g.system.id), NodeRole("dc1", 1000))
    lay.apply_staged_changes()
    enc = lay.encode()
    for g in gs:
        g.system.layout = ClusterLayout.decode(enc)
        g.system._rebuild_ring()
        check(g.system.ring.ready, "garage: ring not ready after the layout")
        g.spawn_workers()
    return gs


def garage_objects(rng, nblocks: int, blk: int) -> list:
    """Object sizes in bytes, 1 to 64 blocks each (a partial last block
    where the size says so), drawn until they hold `nblocks` blocks; the
    last object is cut to fit."""
    sizes, left = [], nblocks
    while left:
        size = int(rng.integers(blk, 64 * blk + 1))
        size = min(size, left * blk)
        sizes.append(size)
        left -= -(-size // blk)
    return sizes


def recoverable_after(entries, dead: set, node_of, index_nodes) -> tuple:
    """(by pieces, by pieces and index quorum) for one lost member: a
    live codeword keeps >= k pieces (surviving members, implicit zero
    shards, surviving parity), and (the second) at most one of the
    member's three parity-index replicas died."""
    pieces = quorum = False
    for ent in entries:
        live = sum(1 for mh in ent.members if node_of(mh) not in dead)
        live += ent.k - len(ent.members)
        live += sum(1 for ph in ent.parity_hashes if node_of(ph) not in dead)
        if live >= ent.k:
            pieces = True
            quorum = quorum or sum(1 for x in index_nodes(ent.member)
                                   if x in dead) <= 1
    return pieces, quorum


def phase_garage(ctx) -> dict:
    """The metadata plane and the Garage node on the card: write-time RS
    encode, degraded-read decode and the two-node-loss rebuild through
    six Garage nodes, every byte checked against hashlib and the numpy
    oracle."""
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_garage_"))
    try:
        return asyncio.run(_garage(ctx, root))
    finally:
        shutil.rmtree(root, ignore_errors=True)


async def _garage(ctx, root: Path) -> dict:
    torch = ctx["torch"]
    from garage_tpu_torch.block.parity import unpack_parity_shard
    from garage_tpu_torch.model.s3.object_table import (
        Object, ObjectVersion, ObjectVersionData, ObjectVersionHeaders,
        ObjectVersionMeta)
    from garage_tpu_torch.model.s3.version_table import Version
    from garage_tpu_torch.ops import cuda_blake2s, cuda_codec, cuda_gf, gf256
    from garage_tpu_torch.rpc.layout import ClusterLayout
    from garage_tpu_torch.table.merkle import EMPTY_HASH
    from garage_tpu_torch.table.schema import hash_partition_key
    from garage_tpu_torch.tools import gf_tune
    from garage_tpu_torch.utils.crdt import now_msec
    from garage_tpu_torch.utils.data import Hash, gen_uuid

    mods = (cuda_blake2s, cuda_gf, cuda_codec, gf_tune)
    blk, nblocks = ctx["block"], ctx["garage_blocks"]
    k, m = GARAGE_CODEC["rs_data"], GARAGE_CODEC["rs_parity"]
    oracle, mat = ctx["oracle"], gf256.rs_parity_matrix(k, m)
    reck = store_memory_reckoning(blk, GARAGE_BACKENDS)
    log(f"[garage] memory reckoning at the reference defaults, upper bounds "
        f"per node ({', '.join(GARAGE_BACKENDS)}): "
        f"{json.dumps(reck['per_node'])}; six nodes: pinned host "
        f"{reck['pinned_host'] / 2**30:.2f} GiB, device "
        f"{reck['device'] / 2**30:.2f} GiB of the card's "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t_build = time.perf_counter()
    gs = await garage_nodes(root, blk)
    build_s = time.perf_counter() - t_build
    for i, g in enumerate(gs):
        codec = g.block_manager.codec
        dev = getattr(codec, "device", None)
        check(str(dev).startswith("cuda"), f"garage node {i}: codec "
              f"{type(codec).__name__} is on {dev}, not the card")
    hy = gs[1].block_manager.codec
    check(getattr(hy, "_governor_ratio", None) == gs[1].governor.ratio,
          "garage node 1: the hybrid codec has not the node's governor "
          "(set_governor)")
    tallies = [NodeTally(g.block_manager.codec, k) for g in gs]
    ids = [bytes(g.system.id) for g in gs]
    log(f"[garage] on {ctx['card']}: 6 Garage nodes on loopback (meta "
        f"replication 3, data 'none', sqlite, {blk} B blocks, RS({k},{m}) "
        f"store_parity + parity_on_write + parity_distribute, repair_ppr "
        f"off): codecs {[type(g.block_manager.codec).__name__ for g in gs]} "
        f"built from Config in {build_s:.2f} s; node 1's hybrid codec "
        f"carries its governor's ratio ({gs[1].governor.ratio():.3f})")

    by_path, out = {}, {"build_s": build_s, "memory_reckoning": reck}

    def start_path():
        reset_counts(torch, mods)
        for t in tallies:
            t.reset()

    def end_path(path, nodes=None):
        torch.cuda.synchronize()
        counts = counts_now(mods)
        counts["by_node"] = {i: tallies[i].snapshot()
                             for i in (nodes or range(len(gs)))}
        by_path[path] = counts
        for name in GARAGE_NEEDS.get(path, ()):
            check(counts[name] > 0,
                  f"kernel {name} was not launched on the {path} path")
        ran = {b for b, n in counts["gf_apply_by"].items() if n}
        if path in GARAGE_BODIES:
            check(ran <= GARAGE_BODIES[path], f"the {path} path ran GF "
                  f"bodies {sorted(ran)}, not within "
                  f"{sorted(GARAGE_BODIES[path])}")
            # every GF launch of the path came through some node's codec
            tallied = sum(tallies[i].gf_calls() for i in
                          (nodes or range(len(gs))))
            check(tallied == counts["gf_apply"], f"the {path} path: "
                  f"{counts['gf_apply']} GF launches, {tallied} through "
                  "the nodes' codecs")
        log(f"[garage] launches on the {path} path: "
            f"{json.dumps({n: counts[n] for n in KERNELS})}, GF by body "
            f"{json.dumps(counts['gf_apply_by'])}; by node "
            f"{json.dumps(counts['by_node'])}")
        return counts

    async def bounded(coros, width=16):
        sem = asyncio.Semaphore(width)

        async def one(c):
            async with sem:
                return await c
        return await asyncio.gather(*[one(c) for c in coros])

    # 1. write (BASELINE config #3): objects of 1-64 blocks through node
    # 0: each block hashed by its feeder (the PUT path's call) and
    # written with rpc_put_block, then the Version and Object rows
    rng = np.random.default_rng(ctx["seed"])
    sizes = garage_objects(rng, nblocks, blk)
    objects = []
    for size in sizes:
        objects.append([rng.bytes(min(blk, size - off))
                        for off in range(0, size, blk)])
    total = sum(sizes)
    n0 = gs[0]
    bm0 = n0.block_manager
    bucket = gen_uuid()
    hashes, by_hash = [], {}
    sem = asyncio.Semaphore(16)

    lat = {"hash": [], "put": []}

    async def put_block(b):
        async with sem:
            t = time.perf_counter()
            d = (await bm0.feeder.hash_async([b], peers=16))[0]
            t1 = time.perf_counter()
            check(bytes(d) == hashlib_digest(b), "garage PUT digest != hashlib")
            h = Hash(bytes(d))
            await bm0.rpc_put_block(h, b)
            lat["hash"].append(t1 - t)
            lat["put"].append(time.perf_counter() - t1)
            return h

    async def put_object(oi, blocks):
        hs = await asyncio.gather(*[put_block(b) for b in blocks])
        vu = gen_uuid()
        ver = Version.new(vu, bytes(bucket), f"obj{oi:04d}")
        off = 0
        for h, b in zip(hs, blocks):
            ver.add_block(0, off, bytes(h), len(b))
            off += len(b)
            by_hash[bytes(h)] = b
        await n0.version_table.insert(ver)
        meta = ObjectVersionMeta.new(ObjectVersionHeaders.new(), off,
                                     f"etag{oi}")
        await n0.object_table.insert(Object(bucket, f"obj{oi:04d}", [
            ObjectVersion(vu, now_msec(), [
                "complete", ObjectVersionData.first_block(meta,
                                                          bytes(hs[0]))])]))
        return hs

    start_path()
    t0 = time.perf_counter()
    for hs in await asyncio.gather(*[put_object(oi, b)
                                     for oi, b in enumerate(objects)]):
        hashes.extend(hs)
    put_s = time.perf_counter() - t0
    await bm0.ec_accumulator.drain()
    for g in gs:
        await g.block_manager.write_parity.drain()
    write_s = time.perf_counter() - t0
    write = end_path("garage_write")
    check(len(by_hash) == nblocks, f"garage: {len(by_hash)} distinct blocks "
          f"of {nblocks}")
    ec0, wp0 = bm0.ec_accumulator, bm0.write_parity
    t0n = write["by_node"][0]
    cw0 = ec0.codewords_encoded + wp0.codewords_encoded
    check(t0n["feeder_encode_codewords"] == cw0, f"garage node 0: {cw0} "
          f"codewords encoded, {t0n['feeder_encode_codewords']} through its "
          "feeder")
    check(t0n["gf_launches"].get("k8r4", 0) == t0n["feeder_encode_calls"]
          and t0n["gf_codewords"].get("k8r4", 0) == cw0,
          f"garage node 0: {t0n['gf_launches']} K2 launches carrying "
          f"{t0n['gf_codewords']} codewords for {t0n['feeder_encode_calls']} "
          f"feeder encode dispatches of {cw0} codewords")
    log(f"[garage] write: {len(sizes)} objects, {nblocks} blocks "
        f"({total / 2**30:.3f} GiB): PUT {put_s:.3f} s, then the parity "
        f"drain, {write_s:.3f} s in all = {total / write_s / 2**20:.1f} "
        f"MiB/s; node 0 encoded {ec0.codewords_encoded} distributed "
        f"codewords ({ec0.distributor.codewords_distributed} distributed, "
        f"{nblocks / max(1, ec0.codewords_encoded):.2f} members each) and "
        f"{wp0.codewords_encoded} local sidecar codewords in "
        f"{t0n['feeder_encode_calls']} feeder dispatches = "
        f"{t0n['gf_launches'].get('k8r4', 0)} K2 launches; local sidecar "
        f"codewords per node "
        f"{[g.block_manager.write_parity.codewords_encoded for g in gs]}")
    q = {k: np.percentile(v, [50, 90]) * 1e3 for k, v in lat.items()}
    log(f"[garage] write: per block, 16 in flight: feeder hash_async "
        f"p50/p90 {q['hash'][0]:.1f}/{q['hash'][1]:.1f} ms, rpc_put_block "
        f"{q['put'][0]:.1f}/{q['put'][1]:.1f} ms")
    out.update(objects=len(sizes), write_bytes=total, put_s=put_s,
               put_block_ms_p50=q["put"][0], hash_ms_p50=q["hash"][0],
               write_s=write_s, write_mibs=total / write_s / 2**20,
               distributed_codewords=ec0.codewords_encoded,
               sidecar_codewords_n0=wp0.codewords_encoded)

    # every block gains a live parity-index row; every codeword's parity
    # shards, fetched back and unpacked, equal the numpy oracle
    t1 = time.perf_counter()

    async def live_rows(h):
        ents = await n0.parity_index_table.get_range(bytes(h), None)
        return [e for e in ents if not e.is_tombstone()]

    rows = await bounded([live_rows(h) for h in hashes], 32)
    entries = {bytes(h): r for h, r in zip(hashes, rows)}
    bare = [h for h, r in entries.items() if not r]
    check(not bare, f"garage: {len(bare)} of {nblocks} blocks have no live "
          "parity-index row")
    codewords = {}
    for r in rows:
        for e in r:
            codewords.setdefault(bytes(e.gid), e)

    node_index = {x: i for i, x in enumerate(ids)}

    def holder(h):
        return node_index[bytes(bm0.replication.write_nodes(Hash(h))[0])]

    async def parity_of(e):
        # each shard read back from the node the ring places it on
        blobs = [await gs[holder(bytes(ph))].block_manager.read_block(
            Hash(bytes(ph))) for ph in e.parity_hashes]
        return [unpack_parity_shard(b.decompressed()) for b in blobs]

    got = await bounded([parity_of(e) for e in codewords.values()], 8)
    for e, shards in zip(codewords.values(), got):
        width = max(e.lengths)
        nm = len(e.members)
        data = np.zeros((nm, width), np.uint8)
        for i, mh in enumerate(e.members):
            b = by_hash[bytes(mh)]
            data[i, :len(b)] = np.frombuffer(b, np.uint8)
        want = oracle.apply(mat[:, :nm], data[None])[0]
        check(all(s is not None for s in shards)
              and np.array_equal(np.stack([np.frombuffer(s, np.uint8)
                                           for s in shards]), want),
              f"garage: codeword {bytes(e.gid).hex()[:12]}'s parity != "
              "numpy GF(2^8)")
    log(f"[garage] every block has a live parity-index row; "
        f"{len(codewords)} codewords' {m} parity shards, read back from "
        f"the nodes the ring places them on and unpacked, equal numpy "
        f"GF(2^8) over their zero-padded members "
        f"({time.perf_counter() - t1:.1f} s)")
    out.update(codewords=len(codewords))

    # 2. degraded GET: 8 covered blocks lose their sole copy, resync is
    # stubbed out (tests/test_model.py:1370), node 0 reads them
    cand = [h for h in hashes if holder(h) != 0]
    pick = [cand[int(i)] for i in rng.choice(len(cand), 8, replace=False)]
    for g in gs:
        g.block_resync.put_to_resync = lambda *a, **kw: None
    for h in pick:
        bmh = gs[holder(h)].block_manager
        found = bmh.find_block(h)
        check(found is not None, "garage: a picked block is not on its holder")
        os.remove(found[0])
    wb0 = bm0.heal_counts.get("writeback", 0)
    start_path()
    lat = []
    for h in pick:
        t = time.perf_counter()
        b = await bm0.rpc_get_block(h)
        lat.append(time.perf_counter() - t)
        check(b == by_hash[bytes(h)], "garage: a degraded GET returned "
              "other bytes")
    deg = end_path("garage_degraded_get")
    deadline = time.monotonic() + 60
    while not all(gs[holder(h)].block_manager.is_block_present(h)
                  for h in pick):
        check(time.monotonic() < deadline, "garage: the degraded GETs' "
              "write-back did not restore every copy in 60 s")
        await asyncio.sleep(0.05)
    for h in pick:
        back = await gs[holder(h)].block_manager.read_block(h)
        check(back.decompressed() == by_hash[bytes(h)],
              "garage: a written-back copy differs")
    for g in gs:
        del g.block_resync.put_to_resync
    wb = bm0.heal_counts.get("writeback", 0) - wb0
    k3 = deg["by_node"][0]
    check(k3["gf_launches"].get("k8r1", 0) >= len(pick),
          f"garage: {k3['gf_launches']} GF launches on the reading node for "
          f"{len(pick)} degraded GETs")
    check(wb >= len(pick), f"garage: {wb} write-back heals on the reading "
          f"node for {len(pick)} degraded GETs")
    log(f"[garage] degraded GET on node 0 of {len(pick)} blocks whose sole "
        f"copy was deleted (resync stubbed): bytes exact, latency ms "
        f"{[round(x * 1e3, 3) for x in lat]} (median "
        f"{sorted(lat)[len(lat) // 2] * 1e3:.3f}); K3 k8r1 launches on node "
        f"0: {k3['gf_launches'].get('k8r1', 0)}; write-back heals {wb}, "
        f"every copy back on its holder, bit-exact")
    out.update(degraded_get_ms=[x * 1e3 for x in lat], writeback=wb)

    # 3. two-node loss (BASELINE config #4): predict, kill, drop from the
    # layout on the survivors, wait for the heal
    dead_i = sorted(int(i) for i in rng.choice(range(1, len(gs)), 2,
                                               replace=False))
    dead = {ids[i] for i in dead_i}

    def node_of(h):
        return bytes(bm0.replication.write_nodes(Hash(bytes(h)))[0])

    def index_nodes(h):
        return {bytes(x) for x in n0.parity_index_table.replication.read_nodes(
            hash_partition_key(bytes(h)))}

    lost = [h for h in hashes if node_of(h) in dead]
    predicted, quorum_only = [], 0
    for h in lost:
        pieces, quorum = recoverable_after(entries[bytes(h)], dead, node_of,
                                           index_nodes)
        if pieces:
            predicted.append(h)
            quorum_only += not quorum
    healed_cw = {bytes(e.gid) for h in predicted for e in entries[bytes(h)]}
    log(f"[garage] two-node loss: nodes {dead_i} hold {len(lost)} of the "
        f"{nblocks} blocks; predicted recoverable (>= {k} live pieces, "
        f"implicit zero shards counted): {len(predicted)} in "
        f"{len(healed_cw)} codewords, of them {quorum_only} whose index "
        f"partition loses two of its three replicas (table sync carries "
        f"the rows from the third)")
    for g in gs:
        g.block_manager.blocks_reconstructed = 0
    for i in dead_i:
        await gs[i].shutdown()
    survivors = [i for i in range(len(gs)) if i not in dead_i]
    start_path()
    t_lay = time.perf_counter()
    slay = gs[survivors[0]].system.layout
    for x in dead:
        slay.stage_role(x, None)
    slay.apply_staged_changes()
    senc = slay.encode()
    for i in survivors:
        gs[i].system.layout = ClusterLayout.decode(senc)
        gs[i].system._rebuild_ring()
    bs = gs[survivors[0]].block_manager

    def primary(h):
        return gs[node_index[bytes(bs.replication.write_nodes(h)[0])]]

    waiting = set(range(len(predicted)))
    heal_s, curve = None, []  # (seconds after the layout change, healed)
    ratios = []  # the survivors' governor ratio (background throttle)
    deadline = time.monotonic() + ctx["heal_timeout_s"]
    while waiting:
        check(time.monotonic() < deadline, f"garage: {len(waiting)} of "
              f"{len(predicted)} recoverable blocks not healed in "
              f"{ctx['heal_timeout_s']} s")
        left = {j for j in waiting if not primary(
            predicted[j]).block_manager.is_block_present(predicted[j])}
        heal_s = time.perf_counter() - t_lay
        if len(left) < len(waiting):
            curve.append((round(heal_s, 2), len(predicted) - len(left)))
        waiting = left
        ratios.append(min(gs[i].governor.ratio() for i in survivors))
        await asyncio.sleep(0.1)
    # let the schedulers finish their walks before the counts are read
    deadline = time.monotonic() + 120
    while not all(gs[i].rebuild_scheduler.idle() for i in survivors):
        check(time.monotonic() < deadline, "garage: the rebuild schedulers "
              "did not go idle in 120 s")
        await asyncio.sleep(0.1)
    await asyncio.sleep(1.0)
    heal = end_path("garage_heal", survivors)
    pset = {bytes(h) for h in predicted}
    extra = [h for h in lost if bytes(h) not in pset and any(
        gs[i].block_manager.is_block_present(h) for i in survivors)]
    recon = {i: gs[i].block_manager.blocks_reconstructed for i in survivors}
    # codewords decoded: on the card (K3) and on the hybrid's CPU floor
    dec_cw = sum(n for i in survivors for b, n in
                 heal["by_node"][i]["gf_codewords"].items() if b != "k8r4")
    dec_cw += sum(heal["by_node"][i]["cpu_decode_codewords"]
                  for i in survivors)
    k3_launches = sum(heal["by_node"][i]["gf_launches"].get(b, 0)
                      for i in survivors for b in ("k8r1", "k8r2", "k8r3"))
    geo = {i: gs[i].block_manager.geometry_cpu_decodes for i in range(len(gs))}
    rb = {i: {"healed": gs[i].rebuild_scheduler.blocks_healed,
              "codewords": gs[i].rebuild_scheduler.codewords_rebuilt,
              "moved_left_to_resync": gs[i].rebuild_scheduler.moved_rows}
          for i in survivors}
    log(f"[garage] heal: the {len(predicted)} predicted blocks on their new "
        f"primaries {heal_s:.3f} s after the layout change; "
        f"{len(extra)} of the other {len(lost) - len(predicted)} lost "
        f"blocks present; blocks_reconstructed by survivor {recon}; "
        f"rebuild schedulers {json.dumps(rb)}; "
        f"{dec_cw} codewords decoded ({k3_launches} K3 launches; node 1's "
        f"CPU floor {heal['by_node'].get(1, {}).get('cpu_decode_codewords')})"
        f" for {len(healed_cw)} codewords to heal; "
        f"geometry-mismatch CPU decodes {sum(geo.values())}; heal sources "
        f"{json.dumps({i: dict(gs[i].block_manager.heal_counts) for i in survivors})}")
    for h in predicted:
        b = await primary(h).block_manager.read_block(h)
        check(b.decompressed() == by_hash[bytes(h)],
              "garage: a healed block differs")
    check(not extra, f"garage: {len(extra)} blocks predicted lost are "
          "present again")
    check(sum(recon.values()) == len(predicted), f"garage: survivors "
          f"report {recon} blocks reconstructed, {len(predicted)} predicted")
    check(dec_cw >= len(healed_cw), f"garage: {dec_cw} codewords decoded "
          f"on the survivors, {len(healed_cw)} to heal")
    for i in survivors:
        t = heal["by_node"][i]
        k3_cw = sum(n for b, n in t["gf_codewords"].items() if b != "k8r4")
        if GARAGE_BACKENDS[i] == "cuda":
            check(k3_cw == t["feeder_decode_codewords"], f"garage node "
                  f"{i}: {t['feeder_decode_codewords']} codewords decoded "
                  f"through its feeder, {k3_cw} through K3")
    check(not any(geo.values()), f"garage: geometry-mismatch CPU decodes "
          f"{geo}")
    marks = sorted({min(len(curve) - 1, int(q * len(curve)))
                    for q in (0, 0.1, 0.25, 0.5, 0.75, 0.9, 1)}) if curve else []
    log(f"[garage] heal curve (s after the layout change, blocks healed): "
        f"{[curve[i] for i in marks]}; the survivors' lowest governor "
        f"ratio over the heal: median {np.median(ratios):.3f}, min "
        f"{min(ratios):.3f}; rebuild paced sleeps "
        f"{[gs[i].rebuild_scheduler.paced_sleeps for i in survivors]}")
    out.update(heal_curve=curve)
    out.update(dead=dead_i, lost=len(lost), predicted=len(predicted),
               predicted_codewords=len(healed_cw),
               predicted_without_index_quorum=quorum_only, heal_s=heal_s,
               decoded_codewords=dec_cw, k3_heal_launches=k3_launches)

    # 4. one pass of node 0's own ScrubWorker, once the parity index has
    # converged on the survivors (the coverage refresh reads the local
    # index rows: a partition the layout change moved to node 0 holds
    # its rows there only after table sync copied them, from a replica
    # or from an old holder offloading it)
    def index_converged():
        for i in survivors:
            if gs[i].parity_index_table.data.merkle_todo_len():
                return False
        rep = n0.parity_index_table.replication
        for p, first in rep.partitions():
            owners = {bytes(x) for x in rep.write_nodes(first)}
            roots = {}
            for i in survivors:
                root = bytes(gs[i].parity_index_table.merkle
                             .partition_root_hash(p))
                if ids[i] in owners:
                    roots[root] = True
                elif root != bytes(EMPTY_HASH):
                    return False  # an old holder still offloading
            if len(roots) != 1:
                return False
        return True

    t = time.perf_counter()
    deadline = time.monotonic() + 120
    while not index_converged():
        check(time.monotonic() < deadline, "garage: the parity index did "
              "not converge on the survivors in 120 s")
        await asyncio.sleep(0.25)
    log(f"[garage] parity index converged on the survivors (every "
        f"partition's Merkle root equal on its replicas, empty elsewhere) "
        f"{time.perf_counter() - t:.3f} s after the heal")
    w = n0.scrub_worker
    w.set_tranquility(0)
    # the blocks the refresh re-feeds: those its local index probe finds
    # uncovered (ParityDistributor.locally_covered, asked only where this
    # node holds the member's index partition)
    refed = []
    dist = n0.block_manager.ec_accumulator.distributor
    covered_here = dist.locally_covered

    def noted_covered(h):
        hit = covered_here(h)
        if not hit:
            refed.append(h)
        return hit

    dist.locally_covered = noted_covered
    done0, refreshed0 = w.state.time_last_complete, w.coverage_refreshed
    start_path()
    t, scrub_ms = time.perf_counter(), now_msec()
    w.send_command("start")
    deadline = time.monotonic() + 600
    while w.state.running or w.state.time_last_complete == done0:
        check(time.monotonic() < deadline, "garage: node 0's scrub pass did "
              "not finish in 600 s")
        await asyncio.sleep(0.05)
    scrub_s = time.perf_counter() - t
    end_path("garage_scrub", survivors)
    del dist.locally_covered
    check(len(refed) == w.coverage_refreshed - refreshed0, f"garage: the "
          f"refresh re-fed {w.coverage_refreshed - refreshed0} blocks, "
          f"{len(refed)} found uncovered")
    check(w.state.corruptions == 0, f"garage: node 0's scrub found "
          f"{w.state.corruptions} corruptions")
    # a row the refresh wrote itself is younger than the pass
    covered = [h for h, r in zip(refed, await bounded(
        [live_rows(h) for h in refed], 32))
        if any(e.timestamp < scrub_ms for e in r)]
    check(not covered, f"garage: the scrub's coverage refresh re-fed "
          f"{len(covered)} blocks that held live coverage")
    log(f"[garage] node 0's ScrubWorker pass: {scrub_s:.3f} s, 0 "
        f"corruptions, coverage refresh re-fed "
        f"{w.coverage_refreshed - refreshed0} blocks, none with a live "
        f"parity-index row")
    out.update(scrub_s=scrub_s,
               coverage_refreshed=w.coverage_refreshed - refreshed0)

    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - mem0
    log(f"[garage] measured: peak device allocation {peak / 2**30:.3f} GiB "
        f"over the phase (reckoning {reck['device'] / 2**30:.2f} GiB)")
    for i in survivors:
        await gs[i].shutdown()
    launches = {name: sum(c[name] for c in by_path.values())
                for name in KERNELS}
    out.update(launches=launches, launches_by_path=by_path,
               peak_device_bytes=peak)
    return out


def phase_tune(ctx) -> dict:
    """T1's path: the GF variant sweep of tools/gf_tune.py on one staged
    group, each cell checked against the numpy oracle and timed."""
    torch = ctx["torch"]
    from garage_tpu_torch.tools import gf_tune

    gf_tune.reset_launches()
    torch.cuda.synchronize()
    res = gf_tune.sweep(ctx["device"], reps=ctx["tune_reps"],
                        oracle=ctx["oracle"].apply)
    torch.cuda.synchronize()
    res["launches"] = gf_tune.launches
    check(res["launches"] > 0, "kernel gf_tune was not launched on its path")
    for variant, cen in res["census"].items():
        if cen is None:
            log(f"[tune] SASS census of {variant}: not available (cuobjdump)")
            continue
        top = sorted(cen["ops"].items(), key=lambda kv: -kv[1])[:8]
        log(f"[tune] SASS {variant} per thread (one 16-byte column): "
            f"{json.dumps(cen['classes'])}; per word {json.dumps(cen['per_word'])}"
            f"; top {json.dumps(dict(top))}")
    for tag, cell in sorted(res["cells"].items()):
        lanes = cell["alu_lanes_per_sm_clock"]
        log(f"[tune] {tag}: {cell['ms']:.4f} ms, {cell['gibs']:.1f} GiB/s of "
            f"data, {res['bound_ms'] / cell['ms']:.1%} of the bytes bound, "
            + (f"{cell['issue_bound_ms'] / cell['ms']:.1%} of the issue bound "
               f"{cell['issue_bound_ms']:.4f} ms, {lanes:.1f} ALU lanes per SM "
               "per clock, " if lanes else "")
            + f"grid {cell['grid']} x {cell['block']}, bit-exact vs numpy "
            "GF(2^8)")
    log(f"[tune] gf_apply on the same codewords: {res['gf_apply']['ms']:.4f} ms "
        f"({res['gf_apply']['gibs']:.1f} GiB/s); best {res['best']['tag']}; "
        f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}); "
        f"{res['launches']} launches")
    return res


def k1_chain_times(ctx, g_cycles: float) -> dict:
    """K1 against its lane count: every message a full row (so the
    longest chain is the same), at 8 lanes, at the scrub's lanes and at
    one warp on each of the 132 SMs; each timed with the SM clock sampled
    while it runs, beside one message's bound (b2s_message_ms) at
    `g_cycles` per G."""
    torch = ctx["torch"]
    from garage_tpu_torch.ops.cuda_blake2s import blake2s_batch
    from garage_tpu_torch.tools.timing import SMS

    da = ctx["k1_inputs"][0]
    lanes, cols = da.shape
    out = {}
    for n in (8, lanes, SMS * 32):
        data = da[:n] if n <= lanes else da.repeat(-(-n // lanes), 1)[:n]
        ln = torch.full((n,), cols, dtype=torch.int32, device=da.device)
        t, mhz = time_kernel_clocked(torch, lambda: blake2s_batch(data, ln))
        dep = max(b2s_message_ms(np.full(n, cols), cols, g_cycles, mhz * 1e6))
        out[n] = {"ms": t, "sm_clock_mhz": mhz, "message_bound_ms": dep}
        log(f"[times] blake2s at {n} lanes x {cols} B (every row full): "
            f"{t:.3f} ms, SM clock {mhz:.0f} MHz, one message's bound "
            f"{dep:.3f} ms ({t and dep / t:.0%} of it)")
        del data
    return out


def gf_times(ctx, reps: int) -> dict:
    """The GF kernel's bodies timed with a cold L2 (each launch after a
    read of a buffer larger than the L2, so every shape reads its inputs
    from HBM, and timed until its output is written back:
    tools/timing.py ``queued_ms``) at the scrub shape (RS(8,4) encode)
    and the narrow shape (1024 codewords of 4 KiB shards, decode rows
    [2,5]), each beside the
    runtime-(k, r) body and its own warm-L2 time, with the SM clock; the
    RS(8,8) full decode at the scrub shape; and the SASS census of the
    instantiations that these ran, which turns a time into the ALU lanes
    issued per SM per clock."""
    torch = ctx["torch"]
    dev = ctx["device"]
    from garage_tpu_torch.ops import _build, gf256
    from garage_tpu_torch.ops.cuda_gf import (consts_from_numpy, gf_apply,
                                              gf_apply_plain)
    from garage_tpu_torch.tools.sass import census_classes, sass_census
    from garage_tpu_torch.tools.timing import (ALU_LANES_PER_SM_CLOCK,
                                               FLUSH_BYTES,
                                               ISSUE_LANES_PER_SM_CLOCK, SMS,
                                               ops_ms, queued_ms)

    groups, K_enc = ctx["gf_inputs"]
    res = {}
    dec = gf256.rs_decode_matrix(8, 4, [0, 1, 3, 4, 6, 7, 8, 9])
    nrng = np.random.default_rng(SEED + 2)
    nx = torch.from_numpy(nrng.integers(0, 2**32, (1024, 8, 1024),
                                        dtype=np.uint32).view(np.int32)).to(dev)
    nK = consts_from_numpy(np.ascontiguousarray(dec[[2, 5]]), dev)
    nplain, res["narrow_plain_ms"] = time_host(
        torch, lambda: gf_apply_plain(nx, nK))
    check(torch.equal(gf_apply(nx, nK), nplain),
          "gf kernel != plain version (narrow regime)")
    K8 = consts_from_numpy(dec, dev)
    flush = torch.empty((FLUSH_BYTES,), dtype=torch.uint8, device=dev)
    cases = {"scrub": (groups, K_enc, "k8r4"), "narrow": (nx, nK, "k8r2"),
             "full_decode": (groups, K8, "k8r8")}
    for label, (x, K, body) in cases.items():
        b, k, s4 = x.shape
        r = K.shape[0]
        t, mhz = time_kernel_clocked(torch, lambda: gf_apply(x, K), flush)
        rt = queued_ms(lambda: gf_apply(x, K, runtime=True), 4 * reps, flush)
        warm = queued_ms(lambda: gf_apply(x, K), 4 * reps)
        bound = bound_ms(*gf_work(b, k, r, s4))
        census = sass_census(_build._lib_path("gf_apply"),
                             f"gf_apply_kernelILi{k}ELi{r}ELb1E")
        row = {"shape": [b, k, s4], "r": r, "body": body, "ms": t,
               "runtime_ms": rt, "warm_ms": warm, "sm_clock_mhz": mhz,
               "bound_ms": bound[0], "bound_by": bound[1],
               "share": bound[0] / t, "census": census}
        threads = b * s4 // 4          # one 16-byte column each
        if census:
            cls = census_classes(census)
            issued = cls["total"] - cls["uniform"]
            row["per_thread"] = cls
            secs_clocks = t / 1e3 * SMS * mhz * 1e6
            row["alu_lanes_per_sm_clock"] = threads * cls["alu"] / secs_clocks
            row["lanes_per_sm_clock"] = threads * issued / secs_clocks
            row["issue_bound_ms"] = ops_ms(threads * cls["alu"],
                                           threads * issued)
        res[label] = row
        log(f"[times] gf_apply {label} ({b}, {k}, {s4}) r={r}, cold L2: {body} "
            f"{t:.4f} ms, runtime body {rt:.4f} ms, bound {bound[0]:.4f} ms "
            f"({bound[1]}; {bound[0] / t:.0%} of it), SM clock {mhz:.0f} MHz; "
            f"warm L2 {warm:.4f} ms")
        if census:
            top = sorted(census.items(), key=lambda kv: -kv[1])[:8]
            log(f"[times]   SASS {body} per thread (4 columns): "
                f"{json.dumps(row['per_thread'])}; top {json.dumps(dict(top))}; "
                f"ALU lanes issued {row['alu_lanes_per_sm_clock']:.1f} and all "
                f"lanes {row['lanes_per_sm_clock']:.1f} per SM per clock; issue "
                f"bound of these instructions ({ALU_LANES_PER_SM_CLOCK} ALU / "
                f"{ISSUE_LANES_PER_SM_CLOCK} issued lanes) "
                f"{row['issue_bound_ms']:.4f} ms")
        else:
            log("[times]   SASS census: not available (cuobjdump)")
    del nx, flush
    return res


def phase_times(ctx, main: dict, prod: dict, store: dict, garage: dict,
                tune: dict) -> list:
    torch = ctx["torch"]
    from garage_tpu_torch.ops.cuda_blake2s import blake2s_batch, g_chain_cycles
    from garage_tpu_torch.tools.timing import queued_ms

    da, dl, lens = ctx["k1_inputs"]
    codec, _, _, de = ctx["k4_inputs"]
    groups, K_enc = ctx["gf_inputs"]
    lanes, cols = da.shape
    reps = ctx["reps"]
    gf = gf_times(ctx, reps)
    g_cycles = g_chain_cycles(ctx["device"])
    log(f"[times] blake2s chain probe: {g_cycles:.3f} SM cycles per dependent "
        f"G, {g_cycles / B2S_G_DEPTH:.3f} per dependent instruction")
    b2s_ms, b2s_mhz = time_kernel_clocked(torch, lambda: blake2s_batch(da, dl))
    ms = {
        "blake2s": b2s_ms,
        "gf_apply": gf["scrub"]["ms"],
        "fused_scrub": queued_ms(lambda: codec.fused_scrub(da, dl, de), reps),
    }
    chain = k1_chain_times(ctx, g_cycles)
    host = da.cpu().numpy()
    _, h2d_ms = time_host(torch, lambda: torch.from_numpy(host).to(ctx["device"]))
    parity = codec.fused_scrub(da, dl, de)[3]
    _, d2h_ms = time_host(torch, lambda: parity.cpu())
    # the 1024-lane device submission: the same batch four times over
    wda, wdl, wde = da.repeat(4, 1), dl.repeat(4), de.repeat(4, 1)
    wide_ms = {
        "blake2s": queued_ms(lambda: blake2s_batch(wda, wdl), reps),
        "fused_scrub": queued_ms(lambda: codec.fused_scrub(wda, wdl, wde),
                                 reps),
    }
    del wda, wdl, wde
    b_bytes, b_alu, b_ops = b2s_work(lens, cols)
    b2s_chain, b2s_issue = b2s_message_ms(lens, cols, g_cycles, b2s_mhz * 1e6)
    b2s_dep = max(b2s_chain, b2s_issue)
    b, k, s4 = groups.shape
    r = K_enc.shape[0]
    g_bytes, g_alu, g_ops = gf_work(b, k, r, s4)
    # the fused function reads every data byte once (the GF apply reads
    # all columns), the lengths and expected digests, and writes digests,
    # ok flags and parity; it runs K1, whose longest message bounds it too
    fused_bytes = lanes * cols + lanes * (4 + 32 + 32 + 1) + 4 * b * r * s4
    work = {"blake2s": (b_bytes, b_alu, b_ops),
            "gf_apply": (g_bytes, g_alu, g_ops),
            "fused_scrub": (fused_bytes, b_alu + g_alu + lanes * 8,
                            b_ops + g_ops + lanes * 8)}
    dep = {"blake2s": b2s_dep, "gf_apply": 0.0, "fused_scrub": b2s_dep}
    meta = {
        "blake2s": ("garage_tpu_torch/csrc/blake2s.cu",
                    "garage_tpu/ops/pallas_blake2s.py:124"),
        "gf_apply": ("garage_tpu_torch/csrc/gf_apply.cu",
                     "garage_tpu/ops/pallas_gf.py:135 and :98"),
        "fused_scrub": ("garage_tpu_torch/ops/cuda_codec.py",
                        "garage_tpu/ops/tpu_codec.py:678"),
    }
    extra = {
        "blake2s": {"sm_clock_mhz": b2s_mhz, "g_chain_cycles": g_cycles,
                    "ms_by_lanes": {str(n): c["ms"] for n, c in chain.items()}},
        "gf_apply": {"runtime_ms": gf["scrub"]["runtime_ms"],
                     "narrow_ms": gf["narrow"]["ms"],
                     "narrow_runtime_ms": gf["narrow"]["runtime_ms"],
                     "full_decode_ms": gf["full_decode"]["ms"],
                     "launches_by_body": gf_bodies_launched(
                         main, prod, store, garage)},
        "fused_scrub": {},
    }
    rows, bounds = [], {}
    by_path = {**main["launches_by_path"], **prod["launches_by_path"],
               **store["launches_by_path"], **garage["launches_by_path"]}
    for name in CODEC_KERNELS:
        bms, by = bound_ms(*work[name], dep[name])
        roof, roof_by = bound_ms(*work[name])
        bounds[name] = {"roofline_ms": roof, "roofline_by": roof_by,
                        "message_ms": dep[name]}
        rows.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": (main["launches"][name] + prod["launches"][name]
                         + store["launches"][name]
                         + garage["launches"][name]),
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": ctx["max_err"][name], "ms": ms[name],
            "plain_ms": ctx["plain_ms"][name], "bound_ms": bms,
            "bound_by": by, "library_ms": None, "share": bms / ms[name],
            **extra[name],
        })
        log(f"[times] {name}: {ms[name]:.3f} ms on the card, bound "
            f"{bms:.3f} ms ({by}; roofline {roof:.3f} ms by {roof_by}, "
            f"{work[name][0] / 2**20:.1f} MiB, {work[name][2] / 1e9:.2f} G "
            f"instructions of which {work[name][1] / 1e9:.2f} G ALU-only"
            + (f"; longest message {dep[name]:.3f} ms" if dep[name] else "")
            + f"; {bms / ms[name]:.1%} of the bound), plain version "
            f"{ctx['plain_ms'][name]:.1f} ms, library call: none")
    log(f"[times] blake2s longest message at {b2s_mhz:.0f} MHz: dependent "
        f"chain {cols // 64} chunks x ({B2S_CHAIN_G_PER_CHUNK} G + 1 xor) at "
        f"{g_cycles:.3f} cycles per G (measured) = {b2s_chain:.3f} ms; issue "
        f"{cols // 64} chunks x {B2S_OPS_PER_CHUNK} instructions at one per "
        f"clock = {b2s_issue:.3f} ms; the kernel runs at "
        f"{b2s_dep / ms['blake2s']:.0%} of the larger")
    # T1: the fastest cell of the sweep, its variant's plain time at the
    # sweep's shape, the bytes bound, the launches of the sweep's path
    best = tune["best"]
    variant = best["tag"].split("/")[0]
    rows.append({
        "name": "gf_tune", "route": "cuda",
        "source": "garage_tpu_torch/csrc/gf_tune.cu",
        "replaces": "scripts/pallas_tune.py:96",
        "launches": tune["launches"], "launches_by_path": {
            "tune": tune["launches"]},
        "max_abs_err": ctx["max_err"]["gf_tune"], "ms": best["ms"],
        "plain_ms": ctx["tune_plain_ms"][variant],
        "bound_ms": tune["bound_ms"], "bound_by": tune["bound_by"],
        "library_ms": None, "cell": best["tag"],
        "cells_ms": {t: c["ms"] for t, c in tune["cells"].items()},
        "gf_apply_ms_same_data": tune["gf_apply"]["ms"],
    })
    log(f"[times] gf_tune: best {best['tag']} {best['ms']:.4f} ms on the card, "
        f"bound {tune['bound_ms']:.4f} ms ({tune['bound_by']}), census issue "
        f"bound {best['issue_bound_ms'] or float('nan'):.4f} ms, plain version "
        f"({variant}) {ctx['tune_plain_ms'][variant]:.1f} ms, library call: none; "
        f"gf_apply on the same data {tune['gf_apply']['ms']:.4f} ms")
    batch_bytes = host.nbytes
    log(f"[times] pageable H2D of one {lanes} x {cols} B batch: {h2d_ms:.2f} ms "
        f"({batch_bytes / h2d_ms / 1e6:.2f} GB/s); pageable D2H of its parity "
        f"({parity.numel() / 2**20:.0f} MiB): {d2h_ms:.2f} ms; fused dispatch "
        f"{ms['fused_scrub']:.2f} ms")
    log(f"[times] at {4 * lanes} lanes: blake2s {wide_ms['blake2s']:.3f} ms, "
        f"fused scrub {wide_ms['fused_scrub']:.3f} ms "
        f"({4 * batch_bytes / wide_ms['fused_scrub'] / 1e6:.1f} GB/s)")
    log(f"[times] gf_apply narrow plain version {gf['narrow_plain_ms']:.1f} ms")
    ctx["summary"] = {"ms": ms, "wide_ms": wide_ms, "h2d_ms": h2d_ms,
                      "gf": gf, "k1_by_lanes": chain, "g_chain_cycles": g_cycles,
                      "bounds": bounds, "k1_chain_ms": b2s_chain,
                      "k1_issue_ms": b2s_issue, "d2h_parity_ms": d2h_ms,
                      "batch_bytes": batch_bytes, "work": work}
    return rows


def gf_bodies_launched(main: dict, prod: dict, store: dict,
                       garage: dict) -> dict:
    """GF kernel launches by body over the main, production, store and
    garage paths."""
    total = {}
    for paths in (main["launches_by_path"], prod["launches_by_path"],
                  store["launches_by_path"], garage["launches_by_path"]):
        for counts in paths.values():
            for body, n in counts.get("gf_apply_by", {}).items():
                total[body] = total.get(body, 0) + n
    return total


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="small shapes (64 KiB blocks, 64-block batches): a "
                         "first build-and-check of new kernels")
    ap.add_argument("--out", help="also write the measurements as JSON here")
    ap.add_argument("--seed", type=int, default=SEED,
                    help="seeds the garage phase's object sizes, data, "
                         "degraded reads and the two nodes it kills")
    args = ap.parse_args()

    repo = Path(__file__).resolve().parent
    if not (repo / "garage_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: garage_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    from garage_tpu_torch.ops import gf256

    ctx = {"torch": torch, "device": torch.device("cuda", 0),
           "oracle": GfOracle(gf256),
           "block": 64 * 1024 if args.quick else MIB,
           "scrub_lanes": 64 if args.quick else 256,
           "batches": 2 if args.quick else 4,
           "reps": 3 if args.quick else 5, "scrub_runs": 3,
           "store_blocks": 128 if args.quick else 512,
           "garage_blocks": 128 if args.quick else 512,
           "heal_timeout_s": 300, "seed": args.seed,
           "tune_reps": 10 if args.quick else 100}
    card = ctx["card"] = nvidia_smi_line()
    log(f"[card] {torch.cuda.get_device_name(0)} ({card}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    phase_build(ctx)
    phase_kernels(ctx)
    main_out = phase_main(ctx)
    for name, n in main_out["launches"].items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    prod_out = phase_production(ctx)
    for name in CODEC_KERNELS:
        check(prod_out["launches"][name] > 0,
              f"kernel {name} was not launched on the production path")
    store_out = phase_store(ctx)
    for name in CODEC_KERNELS:
        check(store_out["launches"][name] > 0,
              f"kernel {name} was not launched on the store path")
    garage_out = phase_garage(ctx)
    for name in CODEC_KERNELS:
        check(garage_out["launches"][name] > 0,
              f"kernel {name} was not launched on the garage path")
    tune_out = phase_tune(ctx)
    rows = phase_times(ctx, main_out, prod_out, store_out, garage_out,
                       tune_out)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "card": card, "kernels": rows, "build_s": ctx["build_s"],
            "main": {k: v for k, v in main_out.items()},
            "production": prod_out, "store": store_out,
            "garage": garage_out, "tune": tune_out,
            "summary": ctx["summary"], "quick": args.quick}, indent=1,
            default=float))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
