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
  4b. split     — the multi-device split (codec.shard_mesh = n) on the
                  main phase's inputs, over every visible GPU when there
                  are two or more, else over the one card four times (its
                  shards then run one after another on its stream): the
                  split CudaCodec at RS(8,4) against the unsplit one (ok,
                  digests, parity bit-equal; the summed corrupt count;
                  one fused launch per shard), the numpy oracle, PUT
                  hashes, encodes and degraded decodes through a
                  CodecFeeder, an odd 5-block batch and one 1024-lane
                  scrub_encode_batch; sharded_fns (verify at 256 lanes,
                  rs_encode) and gf_bitmatmul against the oracle and its
                  plain version, timed beside the GF kernel on the same
                  codewords; make_codec("hybrid") split behind a
                  CodecFeeder, one batch cold and a warm pass that stages
                  nothing; a block store node whose split RS(4,2) codec
                  scrubs 128 blocks (3 planted corruptions found, sidecars
                  against the oracle, one block rebuilt from its sidecar);
                  entry()'s step and dryrun_multichip(n).  Prints each
                  dispatch's time split and unsplit.
  5. store      — one block store node's paths (slice 3a): three port
                  Systems on loopback (replication 3, sqlite, the
                  reference defaults), each with a BlockManager whose
                  codec its Config builds on the card: hybrid, cuda,
                  and hybrid with a ParityStore.  256 blocks of 1 MiB
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
                  rest cuda): 256 blocks in objects of 1-64 MiB written
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
  7. daemon     — the daemon (slice 3c): three `python -m garage_tpu_torch
                  -c nodeN.toml server` processes on localhost
                  (BASELINE #1's dev cluster: replication 3, sqlite, RS(8,4)
                  codec defaults; node 0 cuda, nodes 1-2 hybrid),
                  configured through the port's CLI; 256 PutObjects of
                  1 MiB, 16 in flight, and a 256 MiB multipart upload (16
                  parts, 4 in flight, out of order) through node 0 with an
                  S3 client of this script's own (http.client and its own
                  SigV4); every object read back bit-exact through nodes
                  0 and 1, a ranged GET across a block boundary, a K2V
                  insert/read, the admin REST status, a /metrics scrape and
                  a website GET; every block file on every node named by
                  its hashlib BLAKE2s; node 0's block hashes all on the
                  device; a byte flipped on node 2 found by the CLI's
                  scrub on all three nodes, quarantined and resynced; the
                  daemon pids in nvidia-smi's compute-apps; node 2 stopped
                  by SIGTERM (exit 0 inside the worker deadline), every
                  object read through node 0 meanwhile, node 2 restarted
                  serving a GET.  Launch counts come from each daemon's
                  `codec info`.
  8. chaos      — the drill rig (slice 4), every node a port Garage in
                  this process with its codec a CudaCodec on the card and
                  the native metadata engine: (a) the full-node-loss drill
                  at the reference's acceptance shape (scripts/chaos.py
                  node_rebuild: 24 storage nodes in 4 zones and a
                  gateway, EC only RS(2,2) with write-time distributed
                  parity, the reference's defaults otherwise; direct
                  links, no FaultyLink): seeded PUT/GET/DELETE traffic,
                  the node with the most data-block bytes crashed and
                  dropped from the layout under traffic (a 30 s storm,
                  not the acceptance run's 8 s, with 16 more GET loops
                  over 48 objects of their own from the crash to its
                  end), every survivor's rebuild scheduler walked to
                  the end, paced, every acked object read back bit-exact,
                  zero client errors; prints the heal time, GET p50 and
                  p99 in the storm (the p99 over 200 GETs or more, else
                  their maximum), the lost node's data blocks and parity
                  shards that a live node holds again, repair bytes by
                  mode and each node's K1 / K2 / K4 launches and feeder
                  bytes by side (PUT hashes and write-time encodes all on
                  the card).  (b) bench.py's
                  replay shape: 6 storage nodes in 3 zones, 2 gateways,
                  replication 3, the WAN matrix through FaultyLinks: a
                  seeded trace (the same signature on two generations)
                  replayed through a GatewayPool with one gateway killed
                  mid-window, zero client errors and every acked object
                  bit-exact; then a byte flipped on one replica found once
                  by that node's scrub (K4), quarantined and resynced; a
                  storage node crashed and revived from its native db,
                  every acked object read back and an S3 GET served by
                  the revived node; a K2V insert/read through the port's
                  k2v_client; promlint over a gateway's /metrics.
                  --quick runs (a) at the reference's quick shape, 6
                  storage nodes in 3 zones.  The phase runs in a child
                  interpreter (this script with --chaos-child), which
                  returns its measurements and launch counts.
  8b. tools     — the operator and device tools (slice 6), each its own
                  `python -m garage_tpu_torch.tools.<name>` process on the
                  card, a non-zero exit failing the phase: (a) blake2s_tune,
                  K1 at 256, 1024 and 2048 lanes of 1 MiB, every lane
                  against the host's native BLAKE2s; (b) device_capture at
                  full width (the link rates, K4 on its rungs, K2,
                  gf_bitmatmul and K3 at RS(8,4), the 2 GiB hybrid window);
                  (c) transport_smoke, pool_smoke and link_profile with the
                  reference's invariants; (d) tools/dev_cluster.sh and
                  dev_configure.sh under a temporary GARAGE_TPU_DEV_DIR
                  (three hybrid daemons on the reference's ports
                  3900-3924), then smoke, metadata_smoke (5,000 objects),
                  cpu_profile, a scrub on every node, device_timeline (the
                  feeder's and the transport's events) and incident_dump;
                  every node's `codec info` shows K1 and K4 launches, and
                  SIGTERM ends each daemon with exit code 0; (e) tools/
                  chaos.py --quick --phases partition,disk, every codec on
                  the card, zero client errors.
  9. tune       — T1's path: tools/gf_tune.py's sweep of the GF kernel's
                  loop orders x tiles, each cell checked and timed, with
                  each variant's SASS census and the issue bound it
                  implies, beside the production GF kernel on the same
                  codewords.
 10. times      — each kernel's time (CUDA events, after a warm-up,
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
split's scrub / put / decode / odd / 1024-lane / sharded_fns / cold /
warm / node scrub / node rebuild / entry, store's put / get / each scrub pass, garage's write / degraded GET /
heal / scrub, tune); each daemon process starts with its counts at 0
and reports them through `codec info` (daemon_n0-n2, and node 2's
restarted process); chaos's rebuild / replay / scrub / revive, whose
launches are also attributed to nodes through their codecs;
the tools' own processes (blake2s_tune, device_capture, the three
smokes, each dev node's `codec info`, chaos), each counting from 0;
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
import concurrent.futures
import hashlib
import hmac
import http.client
import json
import os
import random
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

SEED = 20261016
MIB = 1 << 20
CODEC_KERNELS = ("blake2s", "gf_apply", "fused_scrub")
HOST_OPS = 20000  # one-element ops timed for the host's dispatch cost
KERNELS = CODEC_KERNELS + ("gf_tune",)


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

    # the host's cost of one small op on the card: the plain versions
    # are chains of such ops, so their time follows the host, not the card
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    _, ops_ms = time_host(torch, lambda: [one.add_(1)
                                          for _ in range(HOST_OPS)])
    ctx["host_op_us"] = ops_ms * 1e3 / HOST_OPS
    log(f"[kernels] host dispatch: {HOST_OPS} one-element ops on the card "
        f"in {ops_ms:.1f} ms, {ctx['host_op_us']:.2f} us each")

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
# scrub's alone in each replication-3 daemon; the runtime-(k, r) body
# nowhere
GF_BODIES = {"scrub": {"k8r4"}, "put": {"k8r4"}, "decode": {"k8r2"},
             "scrub_1024": {"k8r4"}, "prod_scrub_cold": {"k8r4"},
             "prod_scrub_warm": {"k8r4"}, "prod_put": {"k8r4"},
             "prod_decode": {"k8r2"}, "store_scrub_n1": {"k8r4"},
             "store_rescrub_n1": {"k8r4"},
             "store_repair_n2": {"k8r4", "k8r1"}, "daemon_n0": {"k8r4"},
             "daemon_n1": {"k8r4"}, "daemon_n2": {"k8r4"},
             "split_scrub": {"k8r4"}, "split_put": {"k8r4"},
             "split_decode": {"k8r2"}, "split_odd": {"k8r4"},
             "split_1024": {"k8r4"}, "split_prod_cold": {"k8r4"},
             "split_prod_warm": {"k8r4"}}


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


# --- the multi-device split: CudaCodec over a device list -----------------------

# the kernels each path of the split phase must launch
SPLIT_NEEDS = {"split_scrub": CODEC_KERNELS,
               "split_put": ("blake2s", "gf_apply"),
               "split_decode": ("gf_apply",), "split_odd": CODEC_KERNELS,
               "split_1024": CODEC_KERNELS, "split_sharded": ("blake2s",),
               "split_prod_cold": CODEC_KERNELS,
               "split_prod_warm": CODEC_KERNELS,
               "split_node_scrub": CODEC_KERNELS,
               "split_node_rebuild": ("gf_apply",),
               "split_entry": CODEC_KERNELS}


def split_devices(torch) -> list:
    """The split phase's shards: every visible GPU when there are two or
    more, else the one card four times over (its shards then run one
    after another on its stream)."""
    count = torch.cuda.device_count()
    if count >= 2:
        return [torch.device("cuda", i) for i in range(count)]
    return [torch.device("cuda", 0)] * 4


def split_ms(torch, devices, fn, reps: int) -> tuple:
    """(ms of fn(), how it was timed): CUDA events behind a sleep kernel
    (tools/timing.py queued_ms) when every shard is on one card; across
    cards, the host clock around reps calls ending in a synchronize of
    each card."""
    from garage_tpu_torch.tools.timing import queued_ms

    if len(set(devices)) == 1:
        return queued_ms(fn, reps), "CUDA events"
    fn()
    for d in set(devices):
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    for d in set(devices):
        torch.cuda.synchronize(d)
    return (time.perf_counter() - t0) / reps * 1e3, "host clock"


def phase_split(ctx) -> dict:
    """The multi-device split (codec.shard_mesh = n) on the main phase's
    inputs: the split CudaCodec against the unsplit one and the oracle,
    sharded_fns and gf_bitmatmul, a split hybrid stack cold and warm, a
    block store node's scrub and sidecar rebuild, and the entry's step
    and dryrun_multichip."""
    torch = ctx["torch"]
    from garage_tpu_torch import entry as port_entry
    from garage_tpu_torch.ops import cuda_blake2s, cuda_codec, cuda_gf, gf256
    from garage_tpu_torch.ops import make_codec, sharded
    from garage_tpu_torch.ops.cuda_gf import gf_apply
    from garage_tpu_torch.ops.feeder import CodecFeeder
    from garage_tpu_torch.tools import gf_tune
    from garage_tpu_torch.tools.timing import HBM_BYTES_PER_S, queued_ms
    from garage_tpu_torch.utils.data import Hash

    mods = (cuda_blake2s, cuda_gf, cuda_codec, gf_tune)
    card, reps = ctx["card"], ctx["reps"]
    devices = split_devices(torch)
    n = len(devices)
    log(f"[split] {n} shards on {', '.join(str(d) for d in devices)}: "
        f"{torch.cuda.device_count()} visible GPU(s), "
        f"{torch.cuda.get_device_name(0)} ({card})")
    blk, lanes = ctx["block"], ctx["scrub_lanes"]
    k, m = 8, 4
    mat = gf256.rs_parity_matrix(k, m)
    batches, hashes, want_ok, want_par = ctx["scrub_input"]
    data, put_blocks, put_parity = ctx["put_input"]
    by_path, out = {}, {"devices": [str(d) for d in devices]}
    t_phase = time.perf_counter()

    def end_path(path):
        torch.cuda.synchronize()
        by_path[path] = counts_now(mods)
        for name in SPLIT_NEEDS[path]:
            check(by_path[path][name] > 0,
                  f"kernel {name} was not launched on the {path} path")
        if path in GF_BODIES:
            check_gf_bodies(path, by_path[path]["gf_apply_by"])

    # (a) the split codec at the main phase's size, against the unsplit
    split = make_codec("cuda", rs_data=k, rs_parity=m, device=devices[0],
                       shard_mesh=n, devices=devices)
    one = make_codec("cuda", rs_data=k, rs_parity=m, device=ctx["device"])
    split.warm_scrub(lanes, blk)
    check(split.shards == devices and split.info()["shards"] ==
          [str(d) for d in devices], f"split codec shards {split.shards}")
    per_dispatch, host_s, bad = [], {"split": [], "unsplit": []}, 0

    def scrub_batches(codec, label):
        """Each main-phase batch staged as the split codec stages it,
        through `codec`: [(ok, parity, digests)], one dispatch each."""
        got = []
        for bs, hs in zip(batches, hashes):
            arr, lengths, expected = split._pad_group(bs, hs)
            f0 = cuda_codec.fused_launches
            t0 = time.perf_counter()
            res = codec.scrub_encode_submit(arr, lengths, expected)
            ok, par = codec.scrub_collect(res, True)
            host_s[label].append(time.perf_counter() - t0)
            if codec is split:
                per_dispatch.append(cuda_codec.fused_launches - f0)
                nonlocal bad
                bad += int(res.bad)
            got.append((ok, par, codec._fetch(res.digests)[0]))
        return got

    reset_counts(torch, mods)
    split_res = scrub_batches(split, "split")
    end_path("split_scrub")
    for bi, (a, b) in enumerate(zip(split_res, scrub_batches(one, "unsplit"))):
        ok, par, _dig = a
        check(all(np.array_equal(x, y) for x, y in zip(a, b)),
              f"split scrub batch {bi}: not bit-equal to the unsplit codec")
        check(np.array_equal(ok[:len(batches[bi])], want_ok[bi]),
              f"split scrub batch {bi}: ok vector wrong")
        check(np.array_equal(par[:lanes // k, :, :blk], want_par[bi]),
              f"split scrub batch {bi}: parity != numpy GF(2^8)")
    planted = sum(int((~o).sum()) for o in want_ok)
    check(bad == planted, f"split scrub counted {bad} corrupt, planted "
          f"{planted}")
    check(all(p == n for p in per_dispatch),
          f"fused launches per split dispatch {per_dispatch}, expected {n}")
    # device time of one dispatch, the last batch already on the card
    arr, lengths, expected = split._pad_group(batches[-1], hashes[-1])
    da = torch.from_numpy(arr).to(ctx["device"])
    dl = torch.from_numpy(lengths).to(ctx["device"])
    de = torch.from_numpy(expected.view(np.int32)).to(ctx["device"])
    parts = [(da[lo:hi].to(d), dl[lo:hi].to(d), de[lo:hi].to(d))
             for d, lo, hi in split._split(arr.shape[0], k)]
    ms_split, how = split_ms(torch, devices,
                             lambda: split._fused_shards(parts), reps)
    ms_one = queued_ms(lambda: one.fused_scrub(da, dl, de), reps)
    del parts, da, dl, de
    nbytes = sum(map(len, batches[-1]))
    out["dispatch"] = {"split_ms": ms_split, "unsplit_ms": ms_one,
                       "timed_by": how, "bytes": nbytes,
                       "split_gibs": nbytes / ms_split * 1e3 / 2**30,
                       "unsplit_gibs": nbytes / ms_one * 1e3 / 2**30,
                       "host_s": host_s}
    log(f"[split] scrub {len(batches)} x {lanes} x {blk} B, {n} shards: ok, "
        f"digests and parity == unsplit codec, parity == numpy GF(2^8), "
        f"bad {bad} == {planted} planted; fused launches per dispatch "
        f"{per_dispatch} ({n} per dispatch, 1 per shard)")
    log(f"[split] one dispatch of {arr.shape[0]} lanes ({nbytes / 2**20:.1f} "
        f"MiB) on the card ({how}): split {ms_split:.3f} ms "
        f"({out['dispatch']['split_gibs']:.2f} GiB/s), unsplit {ms_one:.3f} "
        f"ms ({out['dispatch']['unsplit_gibs']:.2f} GiB/s), "
        f"{ms_split / ms_one:.2f}x; submit + collect on the host "
        f"{np.median(host_s['split']) * 1e3:.1f} ms split, "
        f"{np.median(host_s['unsplit']) * 1e3:.1f} ms unsplit; {card}")

    feeder = CodecFeeder(split)
    present = [0, 1, 3, 4, 6, 7, 8, 9, 10, 11]
    lost = [2, 5]
    ncw = data.shape[0]

    async def put():
        hs = asyncio.gather(*[feeder.hash_async([b], peers=len(put_blocks))
                              for b in put_blocks])
        encs = [asyncio.wrap_future(feeder.submit_encode(
            [data[c, i].tobytes() for i in range(k)], peers=ncw))
            for c in range(ncw)]
        return await hs, await asyncio.gather(*encs)

    async def degraded():
        surv = np.concatenate([data, put_parity], axis=1)[:, present]
        return await asyncio.gather(*[
            feeder.decode_async(surv[c:c + 1], present, lost)
            for c in range(ncw)])

    reset_counts(torch, mods)
    put_digests, enc_parity = asyncio.run(put())
    end_path("split_put")
    reset_counts(torch, mods)
    decoded = asyncio.run(degraded())
    end_path("split_decode")
    feeder.shutdown()
    for b, d in zip(put_blocks, put_digests):
        check(bytes(d[0]) == hashlib_digest(b), "split PUT digest wrong")
    check(np.array_equal(np.concatenate(enc_parity), put_parity),
          "split write-time encode != the unsplit codec's parity")
    for c, d in enumerate(decoded):
        check(np.array_equal(d[0], data[c, lost]),
              f"split degraded read codeword {c} wrong")
    odd_b, odd_h = batches[0][:5], hashes[0][:5]
    reset_counts(torch, mods)
    got = split.scrub_encode_batch(odd_b, odd_h)
    end_path("split_odd")
    want = one.scrub_encode_batch(odd_b, odd_h)
    check(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
          and np.array_equal(got[0], want_ok[0][:5]),
          "split 5-block batch != the unsplit codec")
    all_blocks = [b for bs in batches for b in bs]
    all_hashes = [h for hs in hashes for h in hs]
    reset_counts(torch, mods)
    t0 = time.perf_counter()
    ok_w, par_w = split.scrub_encode_batch(all_blocks, all_hashes)
    wide_s = time.perf_counter() - t0
    end_path("split_1024")
    check(np.array_equal(ok_w, np.concatenate(want_ok))
          and np.array_equal(par_w, np.concatenate(want_par)),
          f"split {len(all_blocks)}-lane scrub_encode_batch wrong")
    out["wide_s"] = wide_s
    log(f"[split] {len(put_blocks)} PUT hashes, {ncw} encodes, {ncw} decodes "
        f"({lost} of 12 lost) through a CodecFeeder: == hashlib, the unsplit "
        f"parity and the lost shards; 5-block batch == unsplit; "
        f"{len(all_blocks)}-lane scrub_encode_batch exact in "
        f"{wide_s * 1e3:.1f} ms")

    # (b) sharded_fns and gf_bitmatmul
    fns = sharded.sharded_fns(devices)
    arr0, len0, exp0 = split._pad_group(batches[0], hashes[0])
    dig0 = split_res[0][2]
    b0 = sharded.launches
    reset_counts(torch, mods)
    h, ok, vbad = fns["verify"](arr0, len0, exp0)
    check(np.array_equal(sharded.to_host(h), dig0)
          and np.array_equal(sharded.to_host(ok)[:lanes], want_ok[0])
          and int(vbad) == int((~want_ok[0]).sum())
          and vbad.device == devices[0],
          "sharded_fns verify != the unsplit codec")
    w = np.asarray(gf256.bitmatrix_of_gf_matrix(mat), dtype=np.int8)
    cw = np.ascontiguousarray(data[:, :, :blk // 8])
    enc = sharded.to_host(fns["rs_encode"](cw, w))
    end_path("split_sharded")
    check(np.array_equal(enc, put_parity[:, :, :blk // 8])
          and np.array_equal(enc, one.rs_encode(cw)),
          "sharded_fns rs_encode != the oracle / the unsplit codec")
    rng = np.random.default_rng(SEED + 9)
    xs = torch.from_numpy(rng.integers(0, 256, (3, k, 77), dtype=np.uint8))
    ws = torch.from_numpy(rng.integers(0, 2, (k * 8, m * 8), dtype=np.int8))
    small = sharded.gf_bitmatmul(xs.to(ctx["device"]), ws.to(ctx["device"]))
    check(torch.equal(small.cpu(), sharded.gf_bitmatmul_plain(xs, ws)),
          "gf_bitmatmul on the card != its plain version")
    x = torch.from_numpy(data).to(ctx["device"])
    wd = torch.from_numpy(w).to(ctx["device"])
    check(np.array_equal(sharded.gf_bitmatmul(x, wd).cpu().numpy(),
                         put_parity),
          f"gf_bitmatmul at {tuple(x.shape)} != numpy GF(2^8)")
    bm_ms = queued_ms(lambda: sharded.gf_bitmatmul(x, wd), reps)
    x32 = x.view(torch.int32).view(ncw, k, blk // 4)
    k2_ms = queued_ms(lambda: gf_apply(x32, one._K_enc), reps)
    del x, x32
    bm_bytes = ncw * (k + m) * blk + w.size
    bm_bound = bm_bytes / HBM_BYTES_PER_S * 1e3
    out["gf_bitmatmul"] = {"shape": [ncw, k, blk], "ms": bm_ms,
                           "k2_ms": k2_ms, "bound_ms": bm_bound,
                           "bound_by": "bytes",
                           "launches": sharded.launches - b0}
    log(f"[split] sharded_fns over {n} shards: verify (256 lanes) digests "
        f"and ok == the unsplit codec, bad {int(vbad)} on {vbad.device}; "
        f"rs_encode {tuple(cw.shape)} == numpy GF(2^8) and the unsplit "
        "codec; gf_bitmatmul == its plain version (3, 8, 77) and numpy "
        f"GF(2^8) at {tuple(data.shape)}")
    log(f"[split] gf_bitmatmul (torch._int_mm) at ({ncw}, {k}, {blk} B = "
        f"{blk // 4} words): {bm_ms:.3f} ms (CUDA events), K2 gf_apply on "
        f"the same codewords {k2_ms:.4f} ms, bytes bound {bm_bound:.4f} ms "
        f"({bm_bound / bm_ms:.1%} of it); {card}")

    # (c) the production stack split: make_codec("hybrid") behind a feeder
    hy = make_codec("hybrid", rs_data=k, rs_parity=m, device=devices[0],
                    devices=devices, shard_mesh=n, block_size=blk,
                    device_batch_blocks=1024, hybrid_window=1,
                    transport_staging_slots=2, pool_mib=256,
                    pool_page_kib=256, max_device_staging_mib=4096)
    hy.warm(blk)
    tr, pool, obs = hy.transport, hy.pool, hy.obs
    check(hy.tpu.shards == devices and tr is not None and tr.pinned
          and pool is not None, "split hybrid without its pinned transport")
    feeder = CodecFeeder(hy)
    wb = [rng.bytes(blk) for _ in range(2 * k)]
    wok, _ = asyncio.run(feeder.scrub_async(
        wb, [Hash(hashlib_digest(b)) for b in wb]))
    check(wok.all() and hy.ragged_side() == "tpu",
          "split hybrid: warm-up batch failed or the gate stayed shut")
    last = len(batches) - 1
    keep = [i for i in range(lanes) if want_ok[last][i]]
    passes = {}
    for path, bs, hs in (
            ("split_prod_cold", batches[last], hashes[last]),
            ("split_prod_warm", [batches[last][i] for i in keep],
             [hashes[last][i] for i in keep])):
        side0, staged0 = dict(obs.bytes_total), tr.staged_bytes
        pool0 = pool.stats()
        reset_counts(torch, mods)
        t0 = time.perf_counter()
        ok, par = asyncio.run(feeder.scrub_async(bs, hs))
        wall = time.perf_counter() - t0
        end_path(path)
        pst = pool.stats()
        nb = sum(map(len, bs))
        d = {"wall_s": wall, "bytes": nb, "gibs": nb / wall / 2**30,
             "cpu": obs.bytes_total.get("cpu", 0) - side0.get("cpu", 0),
             "tpu": obs.bytes_total.get("tpu", 0) - side0.get("tpu", 0),
             "staged": tr.staged_bytes - staged0,
             "hit": pst["hit_bytes"] - pool0["hit_bytes"],
             "miss": pst["miss_bytes"] - pool0["miss_bytes"]}
        passes[path] = d
        check(d["cpu"] == 0 and d["tpu"] == nb,
              f"{path}: bytes by side cpu {d['cpu']}, device {d['tpu']}")
        check(d["hit"] + d["miss"] == nb,
              f"{path}: pool hit {d['hit']} + miss {d['miss']} != {nb}")
        if path == "split_prod_cold":
            check(np.array_equal(ok, want_ok[last])
                  and np.array_equal(par, want_par[last]),
                  f"{path}: ok or parity != numpy GF(2^8)")
        else:
            wok, wpar = one.scrub_encode_batch(bs, hs)
            check(ok.all() and np.array_equal(ok, wok)
                  and np.array_equal(par, wpar),
                  f"{path}: not bit-equal to the unsplit codec")
            check(d["staged"] == 0 and d["hit"] == nb,
                  f"{path}: staged {d['staged']} B, hit {d['hit']} of {nb}")
    feeder.shutdown()
    st = tr.stats()
    bad_events = [e for e in obs.events_list() if bad_event(e)]
    check(tr.alive and st["fallbacks"] == 0 and st["device_errors"] == 0
          and not bad_events, f"split hybrid: fallbacks {st['fallbacks']}, "
          f"errors {st['device_errors']}, events {bad_events}")
    hy.close()
    out["production"] = passes
    for path, d in passes.items():
        log(f"[split] {path}: {d['bytes'] / 2**20:.0f} MiB in "
            f"{d['wall_s'] * 1e3:.1f} ms = {d['gibs']:.3f} GiB/s; device "
            f"bytes {d['tpu']}, CPU 0; staged {d['staged']} B; pool hit "
            f"{d['hit']} B, miss {d['miss']} B")

    # (d) a block store node whose codec is split: scrub and sidecars
    out["node"] = asyncio.run(split_node(ctx, devices, end_path))

    # (e) the entry: the one-device step and dryrun_multichip
    b0 = sharded.launches
    reset_counts(torch, mods)
    fn, args = port_entry.entry(devices[0])
    digests, ok, nbad, parity = fn(*args)
    port_entry.dryrun_multichip(n, devices)
    end_path("split_entry")
    a_data, a_shards = args[0].cpu().numpy(), args[3].cpu().numpy()
    check(bool(ok.all()) and int(nbad) == 0 and [
        bytes(x) for x in digests.cpu().numpy().view("<u4")] == [
        hashlib_digest(r.tobytes()) for r in a_data],
        "entry(): verify wrong")
    check(np.array_equal(parity.cpu().numpy(), gf256.gf_matmul_blocks(
        mat, a_shards)), "entry(): parity != numpy GF(2^8)")
    log(f"[split] entry(): step on {devices[0]} exact; dryrun_multichip({n}) "
        f"passed; gf_bitmatmul launches {sharded.launches - b0}")

    for path, counts in by_path.items():
        log(f"[split] launches on the {path} path: {json.dumps(counts)}")
    launches = {name: sum(c[name] for c in by_path.values())
                for name in CODEC_KERNELS}
    out.update(launches=launches, launches_by_path=by_path,
               fused_per_dispatch=per_dispatch,
               seconds=time.perf_counter() - t_phase)
    log(f"[split] launches over the split phase: {json.dumps(launches)}; "
        f"K4 {n} per scrub dispatch, 1 per shard; phase "
        f"{out['seconds']:.1f} s")
    return out


async def split_node(ctx, devices, end_path) -> dict:
    """A block store node (Config, System, BlockManager with a
    ParityStore, RS(4, 2)) whose codec is CudaCodec split over
    `devices`: 128 blocks written, 3 files corrupted, one ScrubWorker
    pass, the sidecars against the numpy oracle, one lost block rebuilt
    from its sidecar."""
    torch = ctx["torch"]
    from garage_tpu_torch.block import BlockManager, ScrubWorker
    from garage_tpu_torch.block.block import DataBlock
    from garage_tpu_torch.block.parity import ParityStore
    from garage_tpu_torch.db import open_db
    from garage_tpu_torch.ops import cuda_blake2s, cuda_codec, cuda_gf, gf256
    from garage_tpu_torch.ops import make_codec
    from garage_tpu_torch.rpc.system import System
    from garage_tpu_torch.table import TableShardedReplication
    from garage_tpu_torch.tools import gf_tune
    from garage_tpu_torch.utils.config import config_from_dict
    from garage_tpu_torch.utils.data import Hash

    mods = (cuda_blake2s, cuda_gf, cuda_codec, gf_tune)
    blk, n = ctx["block"], len(devices)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_split_"))
    try:
        cfg = config_from_dict({
            "metadata_dir": str(root / "meta"),
            "data_dir": str(root / "data"), "replication_mode": "1",
            "block_size": blk, "rpc_secret": "chip-smoke-split",
            "codec": {"backend": "cuda", "rs_data": 4, "rs_parity": 2,
                      "store_parity": True, "shard_mesh": n}})
        s = System(cfg)
        codec = make_codec("cuda", rs_data=4, rs_parity=2, device=devices[0],
                           devices=devices, shard_mesh=n, block_size=blk)
        db = open_db("memory")
        mode = s.replication_mode
        node = BlockManager(cfg, db, s, TableShardedReplication(
            s, mode.replication_factor, 1, mode.write_quorum), codec=codec)
        node.parity_store = store = ParityStore(node, db, node.codec)
        rng = np.random.default_rng(SEED + 11)
        blocks = [rng.bytes(blk) for _ in range(128)]
        hashes = [Hash(hashlib_digest(b)) for b in blocks]
        t0 = time.perf_counter()
        for h, b in zip(hashes, blocks):
            await node.write_block(h, DataBlock.plain(b))
        write_s = time.perf_counter() - t0
        planted = [int(i) for i in rng.choice(len(blocks), 3, replace=False)]
        for i in planted:
            flip_byte(node.find_block(hashes[i])[0], blk // 2)
        w = ScrubWorker(node)
        w.set_tranquility(0)
        reset_counts(torch, mods)
        t0 = time.perf_counter()
        w.send_command("start")
        while (await w.work()).name in ("BUSY", "THROTTLED"):
            pass
        scrub_s = time.perf_counter() - t0
        end_path("split_node_scrub")
        check(w.state.corruptions == 3, f"split node scrub found "
              f"{w.state.corruptions} of 3 planted corruptions")
        by_hash = {bytes(h): b for h, b in zip(hashes, blocks)}
        sidecars = sidecar_parity_checked(store, by_hash, ctx["oracle"],
                                          gf256.rs_parity_matrix(4, 2))
        check(sidecars > 0, "split node scrub wrote no sidecar")
        victim = None
        for i, h in enumerate(hashes):
            if i in planted or not store.coverage(h):
                continue
            man = store._load_manifest(h)
            if all(store._read_verified_member(Hash(bytes(x))) is not None
                   for x in man["hashes"] if bytes(x) != bytes(h)):
                victim = i
                break
        check(victim is not None, "split node: no block to rebuild")
        os.remove(node.find_block(hashes[victim])[0])
        reset_counts(torch, mods)
        rec = await asyncio.to_thread(store.try_reconstruct, hashes[victim])
        end_path("split_node_rebuild")
        check(rec == blocks[victim], "split node: sidecar rebuild not exact")
        node.feeder.shutdown()
        res = {"blocks": len(blocks), "write_s": write_s, "scrub_s": scrub_s,
               "scrub_mibs": len(blocks) * blk / scrub_s / 2**20,
               "corruptions": w.state.corruptions, "sidecars": sidecars}
        log(f"[split] node: {len(blocks)} x {blk} B written in {write_s:.2f} "
            f"s; ScrubWorker pass {scrub_s:.2f} s ({res['scrub_mibs']:.1f} "
            f"MiB/s), 3 of 3 corruptions found; {sidecars} sidecars == numpy "
            f"GF(2^8); block {victim} rebuilt from its sidecar bit-exact")
        return res
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
    codewords it carried (its batch dimension); each BLAKE2s launch of
    its hash and verify dispatches (`hash_submit`, a non-empty
    `batch_verify`: one K1 each) and each fused scrub (`fused_scrub`: one
    K4, which runs K1 too), with the lanes they carried; on a hybrid
    node, the RS encodes and decodes its CPU floor ran; and the feeder's
    inline encode and decode dispatches into the codec
    (`rs_encode_ragged`, `rs_reconstruct_ragged`; a hybrid node's
    transport dispatches reach `_gf` without them).  The kernel wrappers'
    launch counters are process-wide and many nodes share this process:
    the tallies attribute launches to nodes, and each path checks that
    they add up to the counter."""

    SEAMS = ("gf", "cpu_encode", "cpu_decode", "feeder_encode",
             "feeder_decode", "k1", "k4")

    def __init__(self, codec, k: int):
        from garage_tpu_torch.ops.cuda_gf import instantiation

        self.k = k
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
        wrap(dev, "hash_submit", "k1", lambda arr, lengths: "all",
             lambda arr, lengths: int(arr.shape[0]))
        wrap(dev, "batch_verify", "k1",
             lambda blocks, hashes: "all" if len(blocks) else "empty",
             lambda blocks, hashes: len(blocks))
        wrap(dev, "fused_scrub", "k4", lambda d, *a: "all",
             lambda d, *a: int(d.shape[0]))

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

    def launches(self) -> dict:
        """This node's launches of each kernel, as counts_now names them:
        a fused scrub runs the hash kernel and, with parity (k > 0), the
        GF kernel."""
        with self.lock:
            k4 = self.calls["k4"].get("all", 0)
            return {"blake2s": self.calls["k1"].get("all", 0) + k4,
                    "gf_apply": sum(self.calls["gf"].values())
                    + (k4 if self.k else 0),
                    "fused_scrub": k4}


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


# --- the daemon: three server processes serving S3 (slice 3c) ---------------

# node i's codec backend: node 0, the S3 entry point, puts every PUT hash
# on the card; nodes 1 and 2 run the hybrid stack users run
DAEMON_BACKENDS = ("cuda", "hybrid", "hybrid")
DAEMON_PORTS = ("rpc", "s3", "admin", "web", "k2v")
DAEMON_TOKEN = "chip-smoke-admin-token"
DAEMON_BUCKET, DAEMON_SITE = "chip-smoke", "chip-site"
WEB_ROOT = ".web.garage.localhost"
# the reference's worker deadline at shutdown (server.py stop order:
# S3 drain, servers, workers with their 8 s deadline, RPC, db) and a
# margin for the interpreter's exit
DAEMON_STOP_S = 8 + 7


def free_ports(n: int) -> list:
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def http_call(port: int, method: str, target: str, body: bytes = b"",
              headers=None, timeout: float = 600.0):
    """(status, lower-cased headers, body) of one HTTP/1.1 request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, target, body=body, headers=headers or {})
        r = conn.getresponse()
        data = r.read()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, data
    finally:
        conn.close()


def _q(s: str, slash: bool = False) -> str:
    return urllib.parse.quote(s, safe="-_.~" + ("/" if slash else ""))


class SigV4Client:
    """An S3 client on http.client that signs each request with AWS
    Signature Version 4 (header auth) as the AWS specification writes it,
    the way tests/independent_s3_client.py does.  It uses nothing of the
    port, so a request the daemon accepts is two implementations of the
    signature agreeing.  Like the AWS SDKs it retries a 503 (SlowDown,
    DeadlineExceeded) after the Retry-After the daemon sends, at most
    `retries` times, and counts each retry by its error code."""

    def __init__(self, port: int, key_id: str, secret: str,
                 region: str = "garage", retries: int = 3):
        self.port, self.key_id = port, key_id
        self.secret, self.region = secret, region
        self.retries = retries
        self.retried: dict = {}
        self._lock = threading.Lock()

    def request(self, method: str, path: str, query=(), body: bytes = b"",
                headers=None, timeout: float = 600.0):
        for attempt in range(self.retries + 1):
            st, h, data = self._request(method, path, query, body, headers,
                                        timeout)
            if st != 503 or attempt == self.retries:
                return st, h, data
            code = re.search(rb"<Code>([^<]*)</Code>", data)
            code = code.group(1).decode() if code else "?"
            with self._lock:
                self.retried[code] = self.retried.get(code, 0) + 1
            time.sleep(min(5.0, float(h.get("retry-after", 1))))

    def _signing_key(self, date: str) -> bytes:
        k = b"AWS4" + self.secret.encode()
        for part in (date, self.region, "s3", "aws4_request"):
            k = hmac.new(k, part.encode(), hashlib.sha256).digest()
        return k

    def _request(self, method, path, query, body, headers, timeout):
        amzdate = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        payload = hashlib.sha256(body).hexdigest()
        hdrs = {"host": f"127.0.0.1:{self.port}", "x-amz-date": amzdate,
                "x-amz-content-sha256": payload}
        hdrs.update({k.lower(): v for k, v in (headers or {}).items()})
        qs = "&".join(f"{_q(k)}={_q(v)}" for k, v in sorted(query))
        signed = ";".join(sorted(hdrs))
        canonical = "\n".join([
            method, _q(path, slash=True), qs,
            "".join(f"{h}:{hdrs[h].strip()}\n" for h in sorted(hdrs)),
            signed, payload])
        scope = f"{amzdate[:8]}/{self.region}/s3/aws4_request"
        sts = "\n".join(["AWS4-HMAC-SHA256", amzdate, scope,
                         hashlib.sha256(canonical.encode()).hexdigest()])
        sig = hmac.new(self._signing_key(amzdate[:8]), sts.encode(),
                       hashlib.sha256).hexdigest()
        hdrs["authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.key_id}/{scope}, "
            f"SignedHeaders={signed}, Signature={sig}")
        target = _q(path, slash=True) + (f"?{qs}" if qs else "")
        return http_call(self.port, method, target, body, hdrs, timeout)


class Daemon:
    """One `python -m garage_tpu_torch -c nodeN.toml server` process: its
    config (BASELINE #1's dev cluster: replication 3, sqlite, the given
    block size and codec backend), ports, log files and Popen handle."""

    def __init__(self, root: Path, i: int, ports: list, peers: list,
                 backend: str, blk: int):
        self.i, self.backend = i, backend
        self.dir = root / f"node{i}"
        for sub in ("meta", "data"):
            (self.dir / sub).mkdir(parents=True)
        self.ports = dict(zip(DAEMON_PORTS, ports))
        p = self.ports
        self.config = self.dir / "garage.toml"
        self.config.write_text(f'''
metadata_dir = "{self.dir / 'meta'}"
data_dir = "{self.dir / 'data'}"
db_engine = "sqlite"
replication_mode = "3"
block_size = {blk}
rpc_bind_addr = "127.0.0.1:{p['rpc']}"
rpc_public_addr = "127.0.0.1:{p['rpc']}"
rpc_secret = "chip-smoke-daemon-secret"
bootstrap_peers = [{", ".join(f'"127.0.0.1:{x}"' for x in peers)}]

[codec]
backend = "{backend}"

[s3_api]
s3_region = "garage"
api_bind_addr = "127.0.0.1:{p['s3']}"

[k2v_api]
api_bind_addr = "127.0.0.1:{p['k2v']}"

[s3_web]
bind_addr = "127.0.0.1:{p['web']}"
root_domain = "{WEB_ROOT}"

[admin]
api_bind_addr = "127.0.0.1:{p['admin']}"
admin_token = "{DAEMON_TOKEN}"
''')
        self.proc = None
        self.logs: list = []
        self.t_spawn = 0.0

    @property
    def data_dir(self) -> Path:
        return self.dir / "data"

    def start(self, repo: Path, env: dict) -> None:
        log_path = self.dir / f"daemon{len(self.logs)}.log"
        self.logs.append(log_path)
        with open(log_path, "wb") as f:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "garage_tpu_torch", "-c",
                 str(self.config), "server"],
                cwd=str(repo), env=env, stdout=f, stderr=subprocess.STDOUT)
        self.t_spawn = time.perf_counter()

    def log_text(self) -> str:
        return self.logs[-1].read_text(errors="replace")

    def tail(self, n: int = 40) -> str:
        return "\n".join(self.log_text().splitlines()[-n:])

    def check_alive(self) -> None:
        rc = self.proc.poll()
        check(rc is None, f"daemon {self.i} ({self.backend}) died with "
              f"code {rc}; its log ends:\n{self.tail()}")

    def stop(self, timeout: float) -> tuple:
        """SIGTERM, then (exit code, seconds to exit); kills the process
        and fails if it outlives `timeout`."""
        t = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            fail(f"daemon {self.i} did not exit within {timeout} s of "
                 f"SIGTERM; its log ends:\n{self.tail()}")
        return rc, time.perf_counter() - t

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def daemon_cli(repo: Path, env: dict, d: Daemon, *args, timeout=120) -> str:
    """One command of the port's CLI against daemon `d` (its config)."""
    r = subprocess.run(
        [sys.executable, "-m", "garage_tpu_torch", "-c", str(d.config),
         *args], cwd=str(repo), env=env, capture_output=True, text=True,
        timeout=timeout)
    check(r.returncode == 0, f"CLI {' '.join(args)} on node {d.i} exited "
          f"{r.returncode}: {r.stdout[-1500:]}{r.stderr[-1500:]}")
    return r.stdout


def compute_apps() -> list:
    """(pid, device MiB) of every context on the card, as nvidia-smi
    lists them."""
    return [tuple(int(float(x)) for x in line.split(","))
            for line in nvidia_smi("--query-compute-apps=pid,used_memory",
                                   "--format=csv,noheader,nounits")]


def gpu_memory_used_mib() -> int:
    return int(nvidia_smi("--query-gpu=memory.used",
                          "--format=csv,noheader,nounits")[0])


def check_daemon_contexts(apps0: list, apps1: list, pids: list) -> str:
    """The daemons hold contexts on the card: nvidia-smi lists each pid,
    or, where its process namespace hides them (a container with its own
    pid namespace may list every context as one pid), exactly one new
    context per daemon."""
    seen = [p for p, _m in apps1]
    if any(p in pids for p in seen):
        check(all(p in seen for p in pids), f"nvidia-smi compute-apps "
              f"lists {seen}, not every daemon pid {pids}")
        return f"compute-apps lists every daemon pid {pids}"
    check(len(apps1) - len(apps0) == len(pids), f"nvidia-smi compute-apps "
          f"lists {len(apps1)} contexts ({apps1}), {len(apps0)} before the "
          f"daemons started; expected one more per daemon {pids}")
    return (f"compute-apps lists {len(apps1) - len(apps0)} new contexts, one "
            f"per daemon (its namespace shows pids {sorted(set(seen))}, not "
            f"the daemons' {pids}, and each row's memory as the whole "
            f"card's)")


def block_files(data_dir: Path) -> dict:
    """Every file under a node's data_dir by kind: blocks (64 hex digits,
    optionally .zst) and quarantined copies (.corrupted); anything else
    fails the phase."""
    from garage_tpu_torch.block.block import DataBlock

    found = {"blocks": {}, "corrupted": []}
    for dirpath, _dirs, files in os.walk(data_dir):
        for name in files:
            path = Path(dirpath) / name
            stem, _, ext = name.partition(".")
            check(len(stem) == 64 and set(stem) <= set("0123456789abcdef"),
                  f"unexpected file {path} in a data_dir")
            if ext == "corrupted":
                found["corrupted"].append(path)
                continue
            check(ext in ("", "zst"), f"unexpected file {path}")
            raw = path.read_bytes()
            data = (DataBlock(raw, compressed=True).decompressed()
                    if ext == "zst" else raw)
            found["blocks"][stem] = hashlib_digest(data).hex()
    return found


def daemon_info(repo: Path, env: dict, d: Daemon) -> dict:
    """The daemon's own account of its codec (admin `codec info`)."""
    return json.loads(daemon_cli(repo, env, d, "codec", "info"))


def check_node0_hashing(info: dict, put_bytes: int) -> None:
    """Node 0 (cuda) hashed every PUT byte on the card: its feeder routed
    every block hash to the device, and the codec's bytes by side are
    those hashes on the device and the Merkle trie's metadata hashing
    (mhash, CPU-side by contract) on the CPU."""
    routes = info["feeder"]["routes"]
    hashed = routes.get("hash", {})
    check(set(hashed) == {"tpu"} and hashed["tpu"]["bytes"] == put_bytes,
          f"daemon 0: block hashes by side {json.dumps(hashed)}, expected "
          f"{put_bytes} B on the device and none on the CPU")
    mhash = routes.get("mhash", {}).get("cpu", {}).get("bytes", 0)
    check(info["bytes"] == {"cpu": mhash, "tpu": put_bytes},
          f"daemon 0: codec bytes by side {json.dumps(info['bytes'])}, "
          f"expected {put_bytes} B on the device and the {mhash} B of "
          "metadata hashing on the CPU")


def pctl(xs: list, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q))


def tail_ms(xs: list) -> dict:
    """The median and p99 of sorted latencies in ms, the p99 only where
    there are CHAOS_MIN_GETS of them; their maximum and count."""
    return {"n": len(xs), "p50_ms": pctl(xs, 50) * 1e3 if xs else None,
            "p99_ms": pctl(xs, 99) * 1e3 if len(xs) >= CHAOS_MIN_GETS
            else None, "max_ms": xs[-1] * 1e3 if xs else None}


def describe_tail(t: dict) -> str:
    if not t["n"]:
        return "none"
    p99 = (f"p99 {t['p99_ms']:.1f} ms" if t["p99_ms"] is not None
           else "too few for a p99")
    return (f"p50 {t['p50_ms']:.1f} ms, {p99}, max {t['max_ms']:.1f} ms "
            f"over {t['n']}")


def phase_daemon(ctx) -> dict:
    """Three `python -m garage_tpu_torch server` processes serving S3
    from the card, configured through the port's CLI and driven over
    HTTP by a client of this script's own."""
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_daemon_"))
    daemons: list = []
    try:
        return _daemon(ctx, root, daemons)
    except BaseException:
        for d in daemons:
            if d.logs:
                log(f"[daemon] node {d.i}'s log ends:\n{d.tail(60)}")
        raise
    finally:
        for d in daemons:
            d.kill()
        shutil.rmtree(root, ignore_errors=True)


def _daemon(ctx, root: Path, daemons: list) -> dict:
    torch = ctx["torch"]
    from concurrent.futures import ThreadPoolExecutor

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    repo, card, blk = ctx["repo"], ctx["card"], ctx["block"]
    n_obj, n_parts = ctx["daemon_objects"], 16
    part = 16 * blk
    env = dict(os.environ, PYTHONPATH=str(repo))
    reck = store_memory_reckoning(blk, DAEMON_BACKENDS)
    log(f"[daemon] memory reckoning at the reference defaults, upper bounds "
        f"per daemon {json.dumps(reck['per_node'])}: a hybrid daemon pins "
        f"at most (hybrid_window + 1) x device_batch_blocks x block_size = "
        f"{reck['per_node'][1]['pinned_host'] / 2**30:.2f} GiB of host "
        f"staging; three daemons: pinned host "
        f"{reck['pinned_host'] / 2**30:.2f} GiB, device "
        f"{reck['device'] / 2**30:.2f} GiB plus a CUDA context each")
    ports = free_ports(len(DAEMON_PORTS) * len(DAEMON_BACKENDS))
    ports = [ports[i::len(DAEMON_BACKENDS)] for i in range(len(DAEMON_BACKENDS))]
    peers = [p[0] for p in ports]
    for i, backend in enumerate(DAEMON_BACKENDS):
        daemons.append(Daemon(root, i, ports[i], peers, backend, blk))
    out = {"backends": list(DAEMON_BACKENDS), "memory_reckoning": reck}

    def alive():
        for d in daemons:
            if d.proc is not None:
                d.check_alive()

    def wait_for(cond, what: str, timeout: float = 120.0, dt: float = 0.2):
        deadline = time.monotonic() + timeout
        while True:
            alive()
            v = cond()
            if v:
                return v
            check(time.monotonic() < deadline, f"daemon: {what} within "
                  f"{timeout} s")
            time.sleep(dt)

    def answers(port: int) -> bool:
        try:
            http_call(port, "GET", "/", timeout=2)
            return True
        except OSError:
            return False

    def lists(client) -> bool:
        try:
            return client.request("GET", "/", timeout=30)[0] == 200
        except OSError:
            return False

    # 1. spawn; each daemon's S3 port answers (the client is not a key yet)
    apps0, used0 = compute_apps(), gpu_memory_used_mib()
    for d in daemons:
        d.start(repo, env)
    listen_s = {}
    for d in daemons:
        wait_for(lambda: answers(d.ports["s3"]), f"node {d.i}'s S3 port "
                 "answering", timeout=180)
        listen_s[d.i] = time.perf_counter() - d.t_spawn
    log(f"[daemon] on {card}: 3 daemons spawned ({', '.join(DAEMON_BACKENDS)}; "
        f"replication 3, sqlite, {blk} B blocks); spawn to S3 port answering "
        + ", ".join(f"node {i} {s:.2f} s" for i, s in listen_s.items()))

    # 2. the cluster, through the port's CLI (tests/test_integration.py's
    # recipe): node ids, layout, a key, two buckets, scrub tranquility 0
    cli_s = []

    def cli(d, *args):
        t = time.perf_counter()
        r = daemon_cli(repo, env, d, *args)
        cli_s.append(time.perf_counter() - t)
        return r

    def each(*args):
        with ThreadPoolExecutor(len(daemons)) as ex:
            return list(ex.map(lambda d: cli(d, *args), daemons))

    ids = [x.strip().split("@")[0] for x in each("node-id")]
    for nid in ids:
        cli(daemons[0], "layout", "assign", nid, "-z", "dc1", "-c", "10G")
    cli(daemons[0], "layout", "apply", "--version", "1")
    wait_for(lambda: "healthy" in cli(daemons[0], "status"),
             "the cluster healthy after the layout", dt=0.5)
    made = cli(daemons[0], "key", "create", "chip-smoke-key")
    key_id = next(l for l in made.splitlines() if "Key ID" in l).split()[-1]
    secret = next(l for l in made.splitlines() if "Secret" in l).split()[-1]
    for b in (DAEMON_BUCKET, DAEMON_SITE):
        cli(daemons[0], "bucket", "create", b)
        cli(daemons[0], "bucket", "allow", b, "--key", key_id, "--read",
            "--write", "--owner")
    cli(daemons[0], "bucket", "website", DAEMON_SITE, "--allow")
    each("worker", "set", "scrub-tranquility", "0")
    s3 = [SigV4Client(d.ports["s3"], key_id, secret) for d in daemons]
    first_200 = {}
    for d in daemons:
        wait_for(lambda: lists(s3[d.i]),
                 f"node {d.i}'s first S3 200 (signed ListBuckets)")
        first_200[d.i] = time.perf_counter() - d.t_spawn
    log(f"[daemon] configured through the CLI ({len(cli_s)} commands, "
        f"{np.mean(cli_s):.2f} s each on average, none importing torch); "
        f"spawn to first S3 200 "
        + ", ".join(f"node {i} {s:.2f} s" for i, s in first_200.items()))
    out.update(listen_s=listen_s, first_200_s=first_200,
               cli_mean_s=float(np.mean(cli_s)), cli_calls=len(cli_s))

    # 3. PUT: n 1-block objects, 16 in flight, and one multipart object of
    # 16 parts of 16 blocks, 4 in flight, out of order; all through node 0
    rng = np.random.default_rng([ctx["seed"], 7])
    objs = {f"obj/{j:05d}": rng.bytes(blk) for j in range(n_obj)}
    parts = [rng.bytes(part) for _ in range(n_parts)]
    big_key = "multipart/big.bin"
    sha = {k: hashlib.sha256(v).hexdigest() for k, v in objs.items()}
    sha[big_key] = hashlib.sha256(b"".join(parts)).hexdigest()
    sizes = {**{k: len(v) for k, v in objs.items()},
             big_key: n_parts * part}
    put_bytes = sum(sizes.values())

    def put_one(key):
        t = time.perf_counter()
        st, _h, body = s3[0].request("PUT", f"/{DAEMON_BUCKET}/{key}",
                                     body=objs[key])
        check(st == 200, f"PutObject {key}: {st} {body[:300]!r}")
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(16) as ex:
        put_lat = list(ex.map(put_one, objs))
    put_wall = time.perf_counter() - t0
    alive()
    small = sum(len(v) for v in objs.values())
    st, _h, body = s3[0].request("POST", f"/{DAEMON_BUCKET}/{big_key}",
                                 query=[("uploads", "")])
    check(st == 200, f"CreateMultipartUpload: {st} {body[:300]!r}")
    upload_id = ET.fromstring(body).find(
        "{http://s3.amazonaws.com/doc/2006-03-01/}UploadId").text
    order = [int(x) for x in rng.permutation(n_parts)]

    def put_part(j):
        st, h, body = s3[0].request(
            "PUT", f"/{DAEMON_BUCKET}/{big_key}", body=parts[j],
            query=[("partNumber", str(j + 1)), ("uploadId", upload_id)])
        check(st == 200, f"UploadPart {j + 1}: {st} {body[:300]!r}")
        return j, h["etag"]

    t1 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        etags = dict(ex.map(put_part, order))
    done = ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{j + 1}</PartNumber><ETag>{etags[j]}</ETag></Part>"
        for j in range(n_parts)) + "</CompleteMultipartUpload>").encode()
    st, _h, body = s3[0].request("POST", f"/{DAEMON_BUCKET}/{big_key}",
                                 query=[("uploadId", upload_id)], body=done)
    check(st == 200 and b"CompleteMultipartUploadResult" in body,
          f"CompleteMultipartUpload: {st} {body[:300]!r}")
    mpu_wall = time.perf_counter() - t1
    alive()
    info0 = daemon_info(repo, env, daemons[0])
    check_node0_hashing(info0, put_bytes)
    log(f"[daemon] on {card}: PUT {n_obj} objects of {blk} B through node 0, "
        f"16 in flight: p50 {pctl(put_lat, 50) * 1e3:.1f} ms, p99 "
        f"{pctl(put_lat, 99) * 1e3:.1f} ms, {small / put_wall / 2**20:.2f} "
        f"MiB/s; multipart {n_parts} x {part} B parts, 4 in flight, out of "
        f"order: {n_parts * part / mpu_wall / 2**20:.2f} MiB/s; node 0 "
        f"hashed all {put_bytes} B on the device "
        f"(block hashes by side {json.dumps(info0['feeder']['routes']['hash'])}"
        f"); 503 retries {json.dumps(s3[0].retried)}")
    out.update(put_p50_ms=pctl(put_lat, 50) * 1e3,
               put_p99_ms=pctl(put_lat, 99) * 1e3,
               put_mibs=small / put_wall / 2**20,
               multipart_mibs=n_parts * part / mpu_wall / 2**20,
               put_bytes=put_bytes)

    # 4. GET every object, half through node 0 and half through node 1
    # (the multipart object through node 1), and a ranged GET across the
    # multipart object's first block boundary
    keys = sorted(sizes)
    via = {k: (1 if k == big_key else j % 2) for j, k in enumerate(keys)}

    def get_one(key, node=None):
        ni = via[key] if node is None else node
        t = time.perf_counter()
        st, _h, body = s3[ni].request("GET", f"/{DAEMON_BUCKET}/{key}")
        dt = time.perf_counter() - t
        check(st == 200 and hashlib.sha256(body).hexdigest() == sha[key],
              f"GetObject {key} through node {ni}: {st} "
              f"{body[:300] if st != 200 else 'sha256 differs'}")
        return ni, len(body), dt

    t2 = time.perf_counter()
    with ThreadPoolExecutor(16) as ex:
        got = list(ex.map(get_one, keys))
    get_wall = time.perf_counter() - t2
    alive()
    by_node = {ni: sum(n for x, n, _ in got if x == ni) for ni in (0, 1)}
    get_lat = [dt for _x, n, dt in got if n == blk]
    lo = blk - 100
    st, h, body = s3[0].request("GET", f"/{DAEMON_BUCKET}/{big_key}",
                                headers={"range": f"bytes={lo}-{blk + 99}"})
    whole = b"".join(parts)
    check(st == 206 and body == whole[lo:blk + 100]
          and h.get("content-range") == f"bytes {lo}-{blk + 99}/{len(whole)}",
          f"ranged GET across a block boundary: {st} {h.get('content-range')}")
    log(f"[daemon] on {card}: GET {len(keys)} objects ({put_bytes} B) "
        f"bit-exact (sha256), 16 in flight: p50 {pctl(get_lat, 50) * 1e3:.1f} "
        f"ms per {blk} B object, {put_bytes / get_wall / 2**20:.2f} MiB/s in "
        f"all, node 0 served {by_node[0]} B, node 1 {by_node[1]} B; ranged "
        f"GET bytes={lo}-{blk + 99} across a block boundary: 206, exact; "
        f"503 retries node 0 {json.dumps(s3[0].retried)}, node 1 "
        f"{json.dumps(s3[1].retried)}")
    out.update(get_p50_ms=pctl(get_lat, 50) * 1e3,
               get_mibs=put_bytes / get_wall / 2**20, get_bytes_by_node=by_node)

    # 5. every other front door: K2V, admin REST, /metrics, the website
    k2v = SigV4Client(daemons[0].ports["k2v"], key_id, secret)
    val = rng.bytes(64)
    st, _h, body = k2v.request("PUT", f"/{DAEMON_BUCKET}/pk/sk", body=val)
    check(st in (200, 204), f"K2V InsertItem: {st} {body[:200]!r}")
    st, _h, body = k2v.request("GET", f"/{DAEMON_BUCKET}/pk/sk",
                               headers={"accept": "application/octet-stream"})
    check(st == 200 and body == val, f"K2V ReadItem: {st}")
    st, _h, body = http_call(daemons[0].ports["admin"], "GET", "/v1/status",
                             headers={"authorization":
                                      f"Bearer {DAEMON_TOKEN}"})
    status = json.loads(body)
    check(st == 200 and len(status.get("roles", {})) == 3,
          f"admin /v1/status: {st} {body[:300]!r}")
    st, _h, metrics = http_call(daemons[0].ports["admin"], "GET", "/metrics")
    families = {line.split()[2] for line in metrics.decode().splitlines()
                if line.startswith("# TYPE ")}
    check(st == 200 and "codec_bytes_total" in families,
          f"/metrics: {st}, no codec_bytes_total family")
    page = b"<html><body>chip smoke</body></html>"
    st, _h, _b = s3[0].request("PUT", f"/{DAEMON_SITE}/index.html", body=page,
                               headers={"content-type": "text/html"})
    check(st == 200, f"PutObject index.html: {st}")
    st, _h, body = http_call(daemons[1].ports["web"], "GET", "/", headers={
        "host": f"{DAEMON_SITE}{WEB_ROOT}"})
    check(st == 200 and body == page, f"website GET: {st} {body[:200]!r}")
    log(f"[daemon] K2V insert/read, admin /v1/status (3 roles), /metrics "
        f"({len(families)} families) and the website's index.html (through "
        f"node 1) all served")

    # 6. every block file on every node hashes to its own name
    nblocks = n_obj + n_parts * (part // blk)
    for d in daemons:
        files = block_files(d.data_dir)
        bad = [n for n, h in files["blocks"].items() if n != h]
        check(not bad and len(files["blocks"]) == nblocks,
              f"node {d.i}: {len(files['blocks'])} block files, {len(bad)} "
              f"not named by their BLAKE2s; expected {nblocks}")
    log(f"[daemon] {nblocks} block files on each node, each named by its "
        f"hashlib BLAKE2s")

    # 7. a byte flipped in one block file on node 2; a scrub on every node
    # through the CLI, concurrently; node 2 finds it, quarantines it and
    # resyncs it from a peer
    victim_key = f"obj/{int(rng.integers(0, n_obj)):05d}"
    victim = hashlib.blake2s(objs[victim_key], digest_size=32).hexdigest()
    vpath = next(Path(dp) / f for dp, _d, fs in os.walk(daemons[2].data_dir)
                 for f in fs if f == victim)
    flip_byte(str(vpath), int(rng.integers(0, blk)))
    before = [daemon_info(repo, env, d) for d in daemons]
    marks = [len(d.log_text()) for d in daemons]
    scrub_bytes = {d.i: sum(f.stat().st_size for f in d.data_dir.rglob("*")
                            if f.is_file()) for d in daemons}
    t3 = time.perf_counter()
    each("repair", "scrub", "--cmd", "start")
    scrub_s, found = {}, {}
    pattern = re.compile(r"scrub complete, (\d+) corruptions found")
    while len(scrub_s) < len(daemons):
        alive()
        for d in daemons:
            if d.i in scrub_s:
                continue
            m = pattern.search(d.log_text()[marks[d.i]:])
            if m:
                scrub_s[d.i] = time.perf_counter() - t3
                found[d.i] = int(m.group(1))
        check(time.perf_counter() - t3 < 600, "daemon: scrubs did not "
              "finish within 600 s")
        time.sleep(0.1)
    check(found == {0: 0, 1: 0, 2: 1}, f"scrub corruptions by node {found}, "
          "expected exactly the one planted on node 2")
    check(Path(str(vpath) + ".corrupted").exists(),
          "node 2: the corrupt block was not quarantined")
    wait_for(lambda: vpath.exists() and hashlib_digest(
        vpath.read_bytes()).hex() == victim, "node 2's resync of the "
        "quarantined block from a peer", timeout=120)
    get_one(victim_key, node=2)
    after = [daemon_info(repo, env, d) for d in daemons]
    scrubs = []
    for d, b, a in zip(daemons, before, after):
        k4 = a["launches"]["fused_scrub"] - b["launches"]["fused_scrub"]
        r0 = b["feeder"]["routes"].get("scrub", {})
        by_side = {side: v["dispatches"] - r0.get(side, {}).get(
            "dispatches", 0) for side, v in
            a["feeder"]["routes"].get("scrub", {}).items()}
        disp = sum(by_side.values())
        check(disp > 0 and k4 >= disp, f"node {d.i}: {k4} fused scrub "
              f"launches for {disp} scrub dispatches")
        scrubs.append({"node": d.i, "s": scrub_s[d.i],
                       "bytes": scrub_bytes[d.i], "k4": k4,
                       "dispatches": disp, "dispatches_by_side": by_side,
                       "corruptions": found[d.i],
                       "mibs": scrub_bytes[d.i] / scrub_s[d.i] / 2**20})
        # a hybrid node's gate picks the side of each scrub dispatch; its
        # pool prefetch runs K4 on the card either way
        log(f"[daemon] on {card}: scrub node {d.i} ({d.backend}): "
            f"{scrub_bytes[d.i]} B in {scrub_s[d.i]:.2f} s = "
            f"{scrubs[-1]['mibs']:.2f} MiB/s (three nodes at once), "
            f"{found[d.i]} corruptions, {disp} scrub dispatches (by side "
            f"{json.dumps(by_side)}), {k4} fused scrub launches")
    log("[daemon] node 2: the planted corruption quarantined (.corrupted), "
        "resynced from a peer bit-exact, and its object read back through "
        "node 2")
    out["scrub"] = scrubs

    # 8. the card did the work, in each daemon's own words
    ctx_note = check_daemon_contexts(apps0, compute_apps(),
                                     [d.proc.pid for d in daemons])
    used = gpu_memory_used_mib() - used0
    log(f"[daemon] on {card}: {ctx_note}; the card's memory.used rose "
        f"{used} MiB with the three daemons up")
    out.update(device_mib_three_daemons=used)
    per_node = []
    for d, inf in zip(daemons, after):
        la = inf["launches"]
        check(la["blake2s"] > 0 and la["fused_scrub"] > 0,
              f"daemon {d.i}: launches {json.dumps(la)}")
        check_gf_bodies(f"daemon_n{d.i}", la["gf_apply_by"])
        tr = inf.get("transport") or {}
        mem = inf.get("cuda_memory") or {}
        pinned = tr.get("pinned_bytes", 0) + mem.get("pinned_out_bytes", 0)
        rec = {"node": d.i, "backend": d.backend, "pid": d.proc.pid,
               "tpu_frac": inf["tpu_frac"], "bytes": inf["bytes"],
               "launches": la, "pinned_bytes": pinned, "cuda_memory": mem}
        per_node.append(rec)
        log(f"[daemon] on {card}: node {d.i} ({d.backend}, pid "
            f"{d.proc.pid}): tpu_frac {inf['tpu_frac']}, bytes by side "
            f"{json.dumps(inf['bytes'])}, launches {json.dumps(la)}; device "
            f"allocator {json.dumps(mem)}, pinned host staging {pinned} B")
    out["nodes"] = per_node

    # 9. SIGTERM node 2: a clean exit inside the deadline; every object
    # still reads back through node 0; node 2 restarts and serves a GET
    rc, stop_s = daemons[2].stop(DAEMON_STOP_S)
    check(rc == 0, f"daemon 2 exited {rc} on SIGTERM; its log ends:\n"
          f"{daemons[2].tail()}")
    t4 = time.perf_counter()
    with ThreadPoolExecutor(16) as ex:
        list(ex.map(lambda k: get_one(k, node=0), keys))
    down_s = time.perf_counter() - t4
    daemons[2].start(repo, env)
    wait_for(lambda: lists(s3[2]), "node 2's first S3 200 after its "
             "restart", timeout=180)
    rejoin_s = time.perf_counter() - daemons[2].t_spawn
    for k in keys[:4]:
        get_one(k, node=2)
    restart_info = daemon_info(repo, env, daemons[2])
    log(f"[daemon] node 2 SIGTERM: exit code 0 in {stop_s:.2f} s (limit "
        f"{DAEMON_STOP_S} s); {len(keys)} objects read back through node 0 "
        f"with node 2 down in {down_s:.2f} s; node 2 restarted, first S3 200 "
        f"{rejoin_s:.2f} s after spawn, served 4 GETs bit-exact")
    out.update(stop_s=stop_s, down_get_s=down_s, rejoin_s=rejoin_s,
               retried_503={d.i: s3[d.i].retried for d in daemons})

    # 10. every daemon stops cleanly
    for d in daemons:
        rc, s = d.stop(DAEMON_STOP_S)
        check(rc == 0, f"daemon {d.i} exited {rc} on SIGTERM; its log "
              f"ends:\n{d.tail()}")
    by_path = {f"daemon_n{r['node']}": dict(r["launches"]) for r in per_node}
    by_path["daemon_n2_restart"] = dict(restart_info["launches"])
    for path, counts in by_path.items():
        log(f"[daemon] launches on the {path} path: {json.dumps(counts)}")
    launches = {name: sum(c.get(name, 0) for c in by_path.values())
                for name in KERNELS}
    out.update(launches=launches, launches_by_path=by_path,
               phase_s=time.perf_counter() - t_phase)
    log(f"[daemon] phase: {out['phase_s']:.1f} s, every daemon stopped with "
        "exit code 0")
    return out


# --- the drill rig on the card: full-node loss, faults, replay (slice 4) -----

# (a) scripts/chaos.py run_node_rebuild at its acceptance shape (24
# storage nodes in 4 zones plus a gateway; --quick: its quick shape, 6 in
# 3): EC only, RS(2,2) with write-time distributed parity, so a lost node
# heals only through codeword decodes; otherwise the reference's defaults
# (1 MiB blocks, repair_ppr on, FAST_CHAOS_RPC, SimCluster's node
# config).  Only the backend changes, "cpu" to "cuda", and the metadata
# engine is the native one
CHAOS_EC = {"data_replication_mode": "none",
            "codec": {"rs_data": 2, "rs_parity": 2, "store_parity": True,
                      "parity_on_write": True, "parity_distribute": True,
                      "backend": "cuda"}}
# the storm: the drill's traffic through the loss and the layout change
# (the acceptance run's --secs is 8, in which the drill's one serial
# loop lands 5-14 GETs on the card's host), long enough to hold the
# whole rebuild
CHAOS_STORM_S = 30.0
# GET loops beside the drill's, from the crash to the storm's end, over
# objects of their own (the drill's body sizes)
CHAOS_READERS = 16
CHAOS_READER_OBJECTS = 48
# a GET latency percentile is printed as one where the storm holds this
# many GETs, and as their maximum where it holds fewer
CHAOS_MIN_GETS = 200
CHAOS_CHILD_TIMEOUT_S = 600
# (b) bench.py's replay phase: 6 storage nodes in 3 zones, 2 gateways,
# replication 3, FAST_CHAOS_HEALTH, the WAN matrix; SimCluster's node
# config, whose codec has no RS geometry, with the backend on the card
CHAOS_REPLAY_CODEC = {"rs_data": 0, "rs_parity": 0, "backend": "cuda"}
CHAOS_NEEDS = {"chaos_rebuild": ("blake2s", "gf_apply"),
               "chaos_replay": ("blake2s",),
               "chaos_scrub": ("fused_scrub",)}
# RS(2,2) is not among the GF kernel's instantiations: its write-time
# encodes and any decode reaching the card run the runtime-(k, r) body
CHAOS_BODIES = {"chaos_rebuild": {"runtime"}, "chaos_replay": set(),
                "chaos_scrub": set(), "chaos_revive": set()}


class ClusterTallies:
    """A NodeTally on every node of a SimCluster, and on each node a
    revive brings back (a revived node has a new codec); the tallies of a
    node index add up over its lives."""

    def __init__(self, cluster, k: int):
        self.cluster, self.k = cluster, k
        self.lives: list = []  # (index, garage, tally)
        self.refresh()

    def refresh(self) -> None:
        known = {id(g) for _i, g, _t in self.lives}
        for i, g in enumerate(self.cluster.garages):
            if id(g) not in known:
                self.lives.append((i, g, NodeTally(g.block_manager.codec,
                                                   self.k)))

    def reset(self) -> None:
        for _i, _g, t in self.lives:
            t.reset()

    def by_node(self) -> dict:
        out = {}
        for i, _g, t in self.lives:
            snap, lau = t.snapshot(), t.launches()
            o = out.setdefault(i, {"blake2s": 0, "gf_apply": 0,
                                   "fused_scrub": 0, "gf_by": {},
                                   "feeder_encode_calls": 0,
                                   "feeder_decode_calls": 0})
            for name, n in lau.items():
                o[name] += n
            for body, n in snap["gf_launches"].items():
                o["gf_by"][body] = o["gf_by"].get(body, 0) + n
            o["feeder_encode_calls"] += snap["feeder_encode_calls"]
            o["feeder_decode_calls"] += snap["feeder_decode_calls"]
        return out


def feeder_sides(g) -> dict:
    """A node's feeder bytes by kind and side since it started."""
    routes = g.block_manager.feeder.stats()["routes"]
    return {kind: {side: r["bytes"] for side, r in sides.items()}
            for kind, sides in routes.items()}


def timed_requests(client, log: list) -> None:
    """Record (start, method, seconds, status) of every request the
    drill's S3 client makes."""
    inner = client.req

    async def req(method, path, body=b"", query=()):
        t0 = time.monotonic()
        res = await inner(method, path, body, query)
        log.append((t0, method, time.monotonic() - t0, res[0]))
        return res
    client.req = req


def phase_chaos(ctx) -> dict:
    """The drill rig on the card: (a) a full-node loss healed through
    codeword decodes at the reference's acceptance shape, (b) a seeded
    trace replayed through a gateway pool over the WAN matrix with a
    gateway killed, then a corrupted block found by the card's fused
    scrub, a crash and revive from the native metadata engine, a K2V
    round trip and the exposition lint.

    It runs in a child interpreter of its own (this script with
    --chaos-child), as the reference's scripts/chaos.py runs in a process
    of its own: the drill's nodes share one event loop, FAST_CHAOS_RPC's
    sub-second timeouts turn a pause of that loop into a client error,
    and a full collection of the heap the earlier phases leave in this
    process is such a pause.  The child zeroes and reads the launch
    counts of its own paths and writes them back with its measurements."""
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_chaos_"))
    try:
        out = root / "chaos.json"
        cmd = [sys.executable, str(ctx["repo"] / "chip_smoke.py"),
               "--chaos-child", str(out), "--seed", str(ctx["seed"])]
        if ctx["quick"]:
            cmd.append("--quick")
        try:
            r = subprocess.run(cmd, cwd=str(ctx["repo"]),
                               timeout=CHAOS_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"chaos: the child did not finish in "
                 f"{CHAOS_CHILD_TIMEOUT_S} s")
        check(r.returncode == 0, f"chaos: the child exited with code "
              f"{r.returncode}")
        return json.loads(out.read_text())
    finally:
        shutil.rmtree(root, ignore_errors=True)


def chaos_child(ctx, out_path: Path) -> int:
    """The chaos phase's child: both drills, the result as JSON."""
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_chaos_"))
    pauses = GcPauses()
    try:
        out = asyncio.run(_chaos(ctx, root, pauses))
    finally:
        pauses.close()
        log(f"[chaos] full collections: {pauses.summary()}")
        shutil.rmtree(root, ignore_errors=True)
    out["gc_pauses"] = pauses.by_label()
    out_path.write_text(json.dumps(out, default=float))
    return 0


class GcPauses:
    """The seconds of every full collection, under the label of the drill
    running: the event loop every node of a drill shares waits while the
    collector walks the heap.  `settle`, called once a drill's cluster is
    up, collects and freezes what lives then (the interpreter, torch, the
    nodes, the last drill's leftovers), so the drill's full collections
    walk only what it makes (without it, (b)'s took 1.5-1.9 s on the
    card's host: PERF.md run M2)."""

    def __init__(self):
        import gc

        self.gc, self.label, self.t0 = gc, "start", 0.0
        self.pauses: list = []  # (label, seconds)
        gc.callbacks.append(self._timed)

    def _timed(self, phase: str, info: dict) -> None:
        if info["generation"] != 2:
            return
        if phase == "start":
            self.t0 = time.perf_counter()
        else:
            self.pauses.append((self.label, time.perf_counter() - self.t0))

    def settle(self, label: str) -> None:
        self.gc.unfreeze()
        self.gc.collect()
        self.gc.freeze()
        self.label = label

    def close(self) -> None:
        self.gc.callbacks.remove(self._timed)
        self.gc.unfreeze()

    def by_label(self) -> dict:
        out = {}
        for label, secs in self.pauses:
            o = out.setdefault(label, {"n": 0, "longest_s": 0.0})
            o["n"] += 1
            o["longest_s"] = max(o["longest_s"], secs)
        return out

    def summary(self) -> str:
        return "; ".join(f"{label}: {o['n']}, longest "
                         f"{o['longest_s'] * 1e3:.0f} ms"
                         for label, o in self.by_label().items()) or "none"


async def _chaos(ctx, root: Path, pauses: GcPauses) -> dict:
    torch = ctx["torch"]
    from garage_tpu_torch.ops import cuda_blake2s, cuda_codec, cuda_gf
    from garage_tpu_torch.tools import gf_tune

    mods = (cuda_blake2s, cuda_gf, cuda_codec, gf_tune)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    out, by_path = {}, {}

    def path_counter(tallies_of):
        """start/end of a path: the kernel counters zeroed, then read and
        held against the nodes' tallies."""
        def start():
            reset_counts(torch, mods)
            tallies_of().reset()

        def end(path: str) -> dict:
            torch.cuda.synchronize()
            counts = counts_now(mods)
            per = tallies_of().by_node()
            for name in CODEC_KERNELS:
                tallied = sum(o[name] for o in per.values())
                check(tallied == counts[name], f"the {path} path: "
                      f"{counts[name]} {name} launches, {tallied} through "
                      "the nodes' codecs")
            for name in CHAOS_NEEDS.get(path, ()):
                check(counts[name] > 0,
                      f"kernel {name} was not launched on the {path} path")
            ran = {b for b, n in counts["gf_apply_by"].items() if n}
            check(ran <= CHAOS_BODIES[path], f"the {path} path ran GF "
                  f"bodies {sorted(ran)}, not within "
                  f"{sorted(CHAOS_BODIES[path])}")
            counts["by_node"] = {i: o for i, o in per.items()
                                 if o["blake2s"] or o["gf_apply"]}
            by_path[path] = counts
            log(f"[chaos] launches on the {path} path: "
                f"{json.dumps({n: counts[n] for n in KERNELS})}, GF by body "
                f"{json.dumps(counts['gf_apply_by'])}; by node "
                f"{json.dumps(counts['by_node'])}")
            return counts
        return start, end

    out["rebuild"] = await _chaos_rebuild(ctx, root / "rebuild",
                                          path_counter, pauses)
    out["replay"] = await _chaos_replay(ctx, root / "replay", path_counter,
                                        pauses)
    launches = {name: sum(c[name] for c in by_path.values())
                for name in KERNELS}
    out.update(launches=launches, launches_by_path=by_path,
               phase_s=time.perf_counter() - t_phase)
    log(f"[chaos] phase: {out['phase_s']:.1f} s")
    return out


async def _chaos_rebuild(ctx, root: Path, path_counter, pauses) -> dict:
    import aiohttp

    from garage_tpu_torch.ops.cuda_codec import CudaCodec
    from garage_tpu_torch.testing.sim_cluster import (
        SimCluster, TrafficDriver, node_rebuild_drill)
    from garage_tpu_torch.utils.data import Hash

    n, z = ctx["chaos_nodes"], ctx["chaos_zones"]
    t = time.perf_counter()
    cluster = SimCluster(root, n_storage=n, n_zones=z, db="native",
                         extra_cfg=CHAOS_EC)
    # no FaultyLinks: the drill injects no link fault, and their relays
    # would put every RPC's bytes through the nodes' one event loop
    # twice more
    await cluster.start(faults=False)
    try:
        build_s = time.perf_counter() - t
        pauses.settle("(a)")
        for i, g in enumerate(cluster.garages):
            codec = g.block_manager.codec
            check(isinstance(codec, CudaCodec)
                  and str(codec.device).startswith("cuda"),
                  f"chaos node {i}: codec {type(codec).__name__} on "
                  f"{getattr(codec, 'device', None)}, not the card")
            check(g.db.engine == "native", f"chaos node {i}: db engine "
                  f"{g.db.engine}, not native")
        inj = cluster.injector
        log(f"[chaos] (a) on {ctx['card']}: {n} storage nodes in {z} "
            f"zones + 1 gateway "
            f"(SimCluster, direct links), EC only RS(2,2) "
            f"store_parity + parity_on_write + parity_distribute, "
            f"repair_ppr on, db native, every codec CudaCodec on the card: "
            f"up in {build_s:.2f} s")
        tallies = ClusterTallies(cluster, 2)
        start, end = path_counter(lambda: tallies)
        storage = set(cluster.storage_indices())
        samples = []  # (t, layout version on a survivor, blocks healed)
        storm_end = [None]  # monotonic end of the storm, once it began

        async def monitor():
            while True:
                live = [g for i, g in enumerate(cluster.garages)
                        if i in storage and i not in inj.dead]
                samples.append((time.monotonic(),
                                max(g.system.layout.version for g in live),
                                sum(g.rebuild_scheduler.blocks_healed
                                    for g in live)))
                if storm_end[0] is None and samples[-1][1] > v0:
                    storm_end[0] = samples[-1][0] + CHAOS_STORM_S
                await asyncio.sleep(0.1)

        reqs, solve = [], []
        inner_solve = cluster.precompute_layout_change

        async def timed_solve(mutate):
            t0 = time.perf_counter()
            enc = await inner_solve(mutate)
            solve.append(time.perf_counter() - t0)
            return enc
        cluster.precompute_layout_change = timed_solve
        lost, crashed = {}, asyncio.Event()
        inner_crash = inj.crash

        async def crash(i):
            # the victim's blocks by kind, read before its metadata closes
            mgr = cluster.garages[i].block_manager
            for h in inj.list_blocks(i):
                kind = "parity" if mgr.is_parity_block(h) else "data"
                lost.setdefault(kind, []).append(bytes(h))
            await inner_crash(i)
            crashed.set()
        inj.crash = crash
        reader_errors, objects = [], {}

        async def reader(rng):
            """GETs of the readers' own objects from the crash to the
            storm's end, each checked bit-exact.  The drill's objects are
            left to its own traffic: a GET of a lost block has it
            resynced, which would take the rebuild's work."""
            await crashed.wait()
            names = sorted(objects)
            while storm_end[0] is None or time.monotonic() < storm_end[0]:
                name = rng.choice(names)
                try:
                    code, got, _h = await rd.s3.req(
                        "GET", f"/{rd.bucket}/{name}")
                except Exception as e:  # noqa: BLE001 — a client error
                    reader_errors.append(f"GET {name}: {e!r}")
                    continue
                if code != 200 or got != objects[name]:
                    reader_errors.append(f"GET {name}: HTTP {code}")

        async with aiohttp.ClientSession() as session:
            traffic = TrafficDriver(cluster, session,
                                    bucket="drill-node-rebuild")
            # the readers' objects: the drill's traffic steps (PUT, GET,
            # now and then a DELETE) in a bucket of their own, from 8
            # drivers at once (one driver's steps must not overlap)
            seeders = [TrafficDriver(cluster, session, bucket="drill-readers",
                                     seed=SEED + j) for j in range(8)]
            rd = seeders[0]
            await traffic.make_bucket()
            await rd.make_bucket()
            timed_requests(traffic.s3, reqs)
            timed_requests(rd.s3, reqs)
            v0 = cluster.garages[1].system.layout.version
            start()
            t = time.perf_counter()

            async def seed(j: int, d) -> None:
                for _ in range(CHAOS_READER_OBJECTS // len(seeders)):
                    await d.step(f"r{j}")
            await asyncio.gather(*(seed(j, d) for j, d in enumerate(seeders)))
            for d in seeders:
                check(d.stats.errors == 0, f"chaos (a): the readers' "
                      f"objects: {d.stats.error_notes[:4]}")
                objects.update(d.acked)
            mon = asyncio.ensure_future(monitor())
            readers = [asyncio.ensure_future(reader(random.Random(SEED + j)))
                       for j in range(CHAOS_READERS)]
            try:
                st = await node_rebuild_drill(
                    cluster, traffic, CHAOS_STORM_S,
                    seed_objects=max(24, 2 * n))
            finally:
                storm_end[0] = storm_end[0] or 0.0
                mon.cancel()
                await asyncio.gather(*readers, return_exceptions=True)
            drill_s = time.perf_counter() - t
            counts = end("chaos_rebuild")
        t_lay = next((ts for ts, v, _h in samples if v > v0), None)
        check(t_lay is not None, "chaos (a): the survivors never saw the "
              "layout without the lost node")
        check(not reader_errors, f"chaos (a): {len(reader_errors)} storm "
              f"GETs failed: {reader_errors[:4]}")
        # the heal time: the layout change to the last block healed
        healed = st.get("blocks_healed", 0)
        t_heal = next((ts for ts, _v, h in samples if h >= healed),
                      samples[-1][0]) if healed else t_lay
        storm = [(m, s, code) for t0, m, s, code in reqs
                 if t_lay <= t0 <= t_lay + CHAOS_STORM_S]
        gets = sorted(s for m, s, _c in storm if m == "GET")
        puts = sorted(s for m, s, _c in storm if m == "PUT")
        # the lost node's blocks that a live node holds again
        live = [g for i, g in enumerate(cluster.garages) if i not in inj.dead]
        again = {kind: sum(1 for h in hs if any(
            g.block_manager.is_block_present(Hash(h)) for g in live))
            for kind, hs in lost.items()}
        res = {"build_s": build_s, "drill_s": drill_s,
               "heal_s": t_heal - t_lay, "layout_solve_s": solve[0],
               "storm_get": tail_ms(gets), "storm_put": tail_ms(puts),
               "lost_blocks": {k: len(v) for k, v in lost.items()},
               "lost_blocks_held_again": again,
               **{k: st.get(k) for k in (
                   "victim", "lost_bytes", "rebuild_complete",
                   "blocks_healed", "paced_sleeps", "rearms",
                   "verify_mismatches", "errors", "puts", "gets", "deletes",
                   "repair_fetch_bytes", "resync_rebuild_skips", "p99_ms")}}
        log(f"[chaos] (a) drill: {json.dumps(st, default=str)}")
        sides = {i: feeder_sides(g) for i, g in enumerate(cluster.garages)}
        k3 = sum(o["feeder_decode_calls"] for o in counts["by_node"].values())
        log(f"[chaos] (a) node {st.get('victim')} lost ({st.get('lost_bytes')} "
            f"B of blocks) and dropped from the layout under traffic: "
            f"{st.get('blocks_healed')} blocks healed "
            f"{res['heal_s']:.2f} s after the survivors took the new layout "
            f"(solved in {solve[0]:.2f} s); drill {drill_s:.1f} s; in the "
            f"{CHAOS_STORM_S:.0f} s storm ({CHAOS_READERS} GET loops beside "
            f"the drill's traffic) GET {describe_tail(res['storm_get'])}, "
            f"PUT {describe_tail(res['storm_put'])}; of the lost node's "
            f"blocks, held again by a live node: "
            + ", ".join(f"{kind} {again.get(kind, 0)} of {len(hs)}"
                        for kind, hs in sorted(lost.items()))
            + f"; repair_fetch_bytes by mode "
            f"{json.dumps(st.get('repair_fetch_bytes'))}; decodes that "
            f"reached the card (K3, feeder decode dispatches): {k3}")
        for i in sorted(sides):
            o = counts["by_node"].get(i, {})
            log(f"[chaos] (a) node {i}{' (gateway)' if i == 0 else ''}"
                f"{' (lost)' if i == st.get('victim') else ''}: K1 "
                f"{o.get('blake2s', 0)}, K2/K3 {o.get('gf_apply', 0)} "
                f"{json.dumps(o.get('gf_by', {}))}, K4 "
                f"{o.get('fused_scrub', 0)}; feeder bytes by kind and side "
                f"{json.dumps(sides[i])}")
        for i, sd in sides.items():
            for kind in ("hash", "encode"):
                cpu = sd.get(kind, {}).get("cpu")
                check(not cpu, f"chaos (a) node {i}: {cpu} B of {kind} on "
                      "the CPU side")
        check(sum(sd.get("hash", {}).get("tpu", 0) for sd in sides.values())
              > 0, "chaos (a): no PUT hash reached the card")
        check(sum(sd.get("encode", {}).get("tpu", 0)
                  for sd in sides.values()) > 0,
              "chaos (a): no write-time encode reached the card")
        for key, ok in (("rebuild_complete", st.get("rebuild_complete")),
                        ("blocks_healed > 0", st.get("blocks_healed", 0) > 0),
                        ("paced_sleeps > 0", st.get("paced_sleeps", 0) > 0),
                        ("verify_mismatches == 0",
                         st.get("verify_mismatches") == 0),
                        ("errors == 0", st.get("errors") == 0)):
            check(bool(ok), f"chaos (a): {key} failed: "
                  f"{json.dumps(st, default=str)}")
        res["k3_decodes"] = k3
        res["feeder_sides"] = sides
        return res
    finally:
        t = time.perf_counter()
        await cluster.stop()
        log(f"[chaos] (a) cluster stopped in {time.perf_counter() - t:.1f} s")


async def _chaos_replay(ctx, root: Path, path_counter, pauses) -> dict:
    import aiohttp

    from garage_tpu_torch.api.k2v_server import K2VApiServer
    from garage_tpu_torch.api.s3.api_server import S3ApiServer
    from garage_tpu_torch.k2v_client import K2VClient
    from garage_tpu_torch.testing.faults import FAST_CHAOS_HEALTH
    from garage_tpu_torch.testing.gateway_pool import GatewayPool
    from garage_tpu_torch.testing.replay import (
        ReplayConfig, Replayer, generate_ops, trace_signature)
    from garage_tpu_torch.testing.s3_client import S3Client
    from garage_tpu_torch.testing.sim_cluster import SimCluster
    from garage_tpu_torch.utils.promlint import lint_exposition

    t = time.perf_counter()
    cluster = SimCluster(root, n_storage=6, n_zones=3, repl="3",
                         zone_redundancy="maximum", n_gateways=2,
                         db="native",
                         extra_cfg={"health": dict(FAST_CHAOS_HEALTH),
                                    "codec": dict(CHAOS_REPLAY_CODEC)})
    await cluster.start()
    try:
        cluster.apply_wan()
        await cluster.tick(rounds=3)
        inj = cluster.injector
        build_s = time.perf_counter() - t
        pauses.settle("(b)")
        log(f"[chaos] (b) 6 storage nodes in 3 zones + 2 gateways, "
            f"replication 3, db native, codec cuda, WAN matrix "
            f"{json.dumps({f'{a}-{b}': r for (a, b), r in inj.wan_matrix.items()})}"
            f" s RTT: up in {build_s:.2f} s")
        tallies = ClusterTallies(cluster, 0)
        start, end = path_counter(lambda: tallies)
        cfg = ReplayConfig(seed=19, n_keys=64, base_ops_per_s=12.0,
                           duration_s=12.0, size_preset="small")
        sig = trace_signature(generate_ops(cfg))
        check(sig == trace_signature(generate_ops(cfg)),
              "chaos (b): two generations of one seed differ")
        res = {"build_s": build_s, "trace_signature": sig}
        async with aiohttp.ClientSession() as session:
            pool = GatewayPool(session, cluster.gateway_endpoints(),
                               cluster.key_id, cluster.secret,
                               metrics=cluster.garages[0].system.metrics)
            st, _b, _h = await pool.request("PUT", f"/{cfg.bucket}")
            check(st == 200, f"chaos (b): bucket create {st}")
            rp = Replayer(cfg, pool)
            kill_at = len(rp.ops) // 2
            killed = [False]

            async def on_op(i: int, _at: float) -> None:
                if i == kill_at and not killed[0]:
                    killed[0] = True
                    await cluster.kill_gateway(1)

            start()
            t = time.perf_counter()
            stats = await rp.run(on_op=on_op)
            replay_s = time.perf_counter() - t
            bad = await rp.verify_all()
            end("chaos_replay")
            summ = stats.summary()
            log(f"[chaos] (b) replay of {len(rp.ops)} ops (signature {sig}, "
                f"the same on a second generation) in {replay_s:.1f} s, "
                f"gateway 1 killed at op {kill_at}: {json.dumps(summ)}; pool "
                f"{json.dumps(dict(pool.counters))}; {len(rp.acked)} acked "
                f"keys read back, {bad} mismatches")
            check(killed[0], "chaos (b): the mid-window kill never fired")
            check(pool.counters["failovers"] >= 1, "chaos (b): no failover "
                  f"through the kill: {dict(pool.counters)}")
            check(stats.errors == 0, f"chaos (b): client errors "
                  f"{stats.error_notes}")
            check(bad == 0, f"chaos (b): {bad} acked objects differ")
            res.update(ops=len(rp.ops), replay_s=replay_s, stats=summ,
                       pool=dict(pool.counters), acked=len(rp.acked))

            # a flipped byte on one replica of a block an object still
            # references: one scrub pass of that node (tranquility 0)
            # finds it once on the card, quarantines it and resync
            # fetches it back (a block only overwritten versions held
            # would be left to the GC)
            vi = cluster.storage_indices()[1]
            g = cluster.garages[vi]
            w, mgr = g.scrub_worker, g.block_manager
            blocks = sorted(bytes(h) for h in inj.list_blocks(vi)
                            if mgr.rc.get(h).is_needed())
            check(bool(blocks), f"chaos (b): node {vi} holds no live block")
            h = blocks[len(blocks) // 2]
            check(inj.corrupt_block(vi, h), "chaos (b): corrupt_block found "
                  "no file")
            w.set_tranquility(0)
            done0, q0 = w.state.time_last_complete, mgr.quarantined
            start()
            t = time.perf_counter()
            w.send_command("start")
            deadline = time.monotonic() + 300
            while w.state.running or w.state.time_last_complete == done0:
                check(time.monotonic() < deadline, "chaos (b): the scrub "
                      "pass did not finish in 300 s")
                await asyncio.sleep(0.05)
            scrub_s = time.perf_counter() - t
            sc = end("chaos_scrub")
            k4 = sc["by_node"].get(vi, {}).get("fused_scrub", 0)
            check(w.state.corruptions == 1, f"chaos (b): the scrub found "
                  f"{w.state.corruptions} corruptions, not 1")
            check(mgr.quarantined - q0 == 1, f"chaos (b): "
                  f"{mgr.quarantined - q0} copies quarantined")
            check(k4 == sc["fused_scrub"] and k4 > 0, "chaos (b): the "
                  f"scrub's K4 launches are not node {vi}'s ({k4})")
            deadline = time.monotonic() + 120
            while not mgr.is_block_present(h):
                check(time.monotonic() < deadline, "chaos (b): the "
                      "corrupted block was not resynced in 120 s")
                await asyncio.sleep(0.05)
            back = (await mgr.read_block(h)).decompressed()
            check(hashlib_digest(back) == h, "chaos (b): the resynced "
                  "block does not hash to its name")
            log(f"[chaos] (b) a byte flipped in block {h.hex()[:12]} on node "
                f"{vi} ({len(blocks)} blocks): its scrub pass "
                f"({scrub_s:.2f} s, {k4} K4 launches) found 1 corruption, "
                "quarantined the copy, resync fetched it back bit-exact")

            # crash and revive a storage node from its native db
            vj = cluster.storage_indices()[3]
            start()
            t = time.perf_counter()
            await inj.crash(vj)
            g2 = await inj.revive(vj)
            revive_s = time.perf_counter() - t
            tallies.refresh()
            check(g2.db.engine == "native" and str(
                g2.block_manager.codec.device).startswith("cuda"),
                f"chaos (b): revived node {vj}: db {g2.db.engine}, codec on "
                f"{g2.block_manager.codec.device}")
            bad2 = await rp.verify_all()
            check(bad2 == 0, f"chaos (b): {bad2} acked objects differ after "
                  "the revive")
            srv = S3ApiServer(g2)
            await srv.start("127.0.0.1:0")
            try:
                key = next(iter(sorted(rp.acked)))
                s3 = S3Client(session, srv.port, cluster.key_id,
                              cluster.secret)
                st, got, _h = await s3.req(
                    "GET", f"/{cfg.bucket}/{rp._key_name(key)}")
            finally:
                await srv.stop()
            check(st == 200 and got == rp.acked[key][1], f"chaos (b): the "
                  f"revived node's GET: HTTP {st}")
            end("chaos_revive")
            log(f"[chaos] (b) node {vj} crashed (no drains) and revived from "
                f"its native db in {revive_s:.2f} s; all {len(rp.acked)} "
                f"acked keys read back through the pool, and the revived "
                f"node served an S3 GET of {rp._key_name(key)} "
                f"({len(got)} B) bit-exact")

            # one K2V round trip through the port's client
            k2v = K2VApiServer(cluster.garages[0])
            await k2v.start("127.0.0.1:0")
            try:
                kc = K2VClient(f"http://127.0.0.1:{k2v.port}", cfg.bucket,
                               cluster.key_id, cluster.secret)
                await kc.insert_item("chaos", "k", b"chip-smoke")
                item = await kc.read_item("chaos", "k")
            finally:
                await k2v.stop()
            check(item is not None and item.value == b"chip-smoke",
                  f"chaos (b): K2V read back {item and item.values}")
            errors = lint_exposition(cluster.garages[0].system.metrics.render())
            check(not errors, f"chaos (b): promlint over gateway 0's "
                  f"/metrics: {errors[:4]}")
            log("[chaos] (b) K2V insert/read through k2v_client: exact, token "
                f"{str(item.token)[:16]}...; promlint over gateway 0's "
                "/metrics: no error")
        res.update(scrub_s=scrub_s, scrub_k4=k4, revive_s=revive_s,
                   block_count_node=len(blocks))
        return res
    finally:
        t = time.perf_counter()
        await cluster.stop()
        log(f"[chaos] (b) cluster stopped in {time.perf_counter() - t:.1f} s")


# --- tools ---------------------------------------------------------------------

# the launch counts of a tool that reports only K1's (blake2s_tune)
NO_LAUNCHES = {"blake2s": 0, "gf_apply": 0, "gf_apply_by": {},
               "fused_scrub": 0}
TOOLS_NEEDS = {"tools_b2s_tune": ("blake2s",),
               "tools_capture": CODEC_KERNELS,
               "tools_transport": ("blake2s", "fused_scrub"),
               "tools_pool": ("fused_scrub",),
               "tools_link": ("blake2s", "gf_apply"),
               "tools_dev_n0": ("blake2s", "fused_scrub"),
               "tools_dev_n1": ("blake2s", "fused_scrub"),
               "tools_dev_n2": ("blake2s", "fused_scrub"),
               "tools_chaos": ("blake2s",)}
TOOL_TIMEOUT_S = 300
DEV_NODES = 3


def run_tool(ctx, name: str, *args, env=None, timeout=TOOL_TIMEOUT_S,
             log_to=None) -> str:
    """`python -m garage_tpu_torch.tools.<name> *args` from the checkout's
    root; its stdout.  Fails when it exits non-zero."""
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, "-m",
                            f"garage_tpu_torch.tools.{name}", *args],
                           cwd=str(ctx["repo"]), env=env or tool_env(ctx),
                           capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        fail(f"tools: {name} did not finish in {timeout} s")
    secs = time.perf_counter() - t0
    ctx.setdefault("tool_s", {})[log_to or name] = secs
    check(r.returncode == 0, f"tools: {name} {' '.join(args)} exited "
          f"{r.returncode}: {r.stdout[-2000:]}{r.stderr[-3000:]}")
    log(f"[tools] {name} {' '.join(args)}: rc 0 in {secs:.1f} s")
    return r.stdout


def tool_json(out: str, prefix: str = "") -> dict:
    """The tool's result: its last stdout line that is a JSON object
    (after `prefix`, for chaos's "CHAOS {...}")."""
    for line in reversed(out.splitlines()):
        line = line.strip()
        if line.startswith(prefix + "{"):
            return json.loads(line[len(prefix):])
    fail(f"tools: no JSON result line in {out[-1000:]}")


def tool_env(ctx, **extra) -> dict:
    return dict(os.environ, PYTHONPATH=str(ctx["repo"]), **extra)


def dev_cli_all(ctx, env: dict, base: Path, *args) -> list:
    """`python -m garage_tpu_torch -c nodeI/garage.toml *args` on every dev
    node at once (the CLI imports no torch); their stdouts by node."""
    def one(i):
        return subprocess.run(
            [sys.executable, "-m", "garage_tpu_torch", "-c",
             str(base / f"node{i}" / "garage.toml"), *args],
            cwd=str(ctx["repo"]), env=env, capture_output=True, text=True,
            timeout=120)

    with concurrent.futures.ThreadPoolExecutor(DEV_NODES) as pool:
        runs = list(pool.map(one, range(DEV_NODES)))
    for i, r in enumerate(runs):
        check(r.returncode == 0, f"tools: CLI {' '.join(args)} on dev node "
              f"{i} exited {r.returncode}: {r.stdout[-1500:]}"
              f"{r.stderr[-1500:]}")
    return [r.stdout for r in runs]


def phase_tools(ctx) -> dict:
    """The operator and device tools of the port, each its own process on
    the card: (a) the K1 lane sweep, (b) the device capture, (c) the
    transport, pool and link smokes, (d) the dev cluster through its
    scripts and smokes, a scrub on every node, (e) the chaos drill's
    partition and disk phases."""
    torch = ctx["torch"]
    card = ctx["card"]
    out, by_path = {}, {}
    # (a) K1 at 256, 1024 and 2048 lanes of 1 MiB, every lane against the
    # host's BLAKE2s
    lanes = "64,128" if ctx["quick"] else "256,1024,2048"
    tune = tool_json(run_tool(ctx, "blake2s_tune", "--lanes", lanes))
    for cell in tune["cells"]:
        check(cell["lanes_checked"] == cell["lanes"],
              f"blake2s_tune: {cell['lanes_checked']} of {cell['lanes']} "
              "lanes checked")
        log(f"[tools] on {card}: blake2s_tune {cell['lanes']} x 1 MiB: "
            f"{cell['ms']:.3f} ms, {cell['gibs']:.1f} GiB/s, "
            f"{cell['blocks']} blocks of {cell['threads']} threads, "
            f"SM clock {cell['sm_clock_mhz']:.0f} MHz, chain "
            f"{cell['chain_ms']:.3f} ms, bound {cell['bound_ms']:.3f} ms "
            f"({cell['bound_by']}; {cell['share_of_bound']:.0%} of it), "
            f"every lane = host BLAKE2s")
    out["b2s_tune"] = tune
    by_path["tools_b2s_tune"] = dict(NO_LAUNCHES, blake2s=tune["launches"])
    # (b) the capture at full width: 256 x 1 MiB batches, RS(8,4), 2 GiB
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_tools_"))
    cap = tool_json(run_tool(ctx, "device_capture", "--out",
                             str(root / "capture.json")))
    log(f"[tools] on {card}: device_capture: dispatch "
        f"{cap['dispatch_rtt_ms']:.3f} ms, H2D {cap['link_h2d_reported_gibs']:.2f}"
        f" GiB/s, round trip {cap['link_roundtrip_gibs']:.2f} GiB/s; fused "
        f"scrub {cap['fused_scrub_gibs']:.2f} GiB/s at {cap['fused_scrub_lanes']}"
        f" x {cap['fused_scrub_block']} B ("
        + ", ".join(f"{r['lanes']} x {r['block']} B {r['gibs']:.2f}"
                    for r in cap["fused_scrub_rungs"])
        + f"); gf_apply {cap['gf_apply_gibs']:.1f}, gf_bitmatmul "
        f"{cap['gf_bitmatmul_gibs']:.2f}, decode {cap['gf_decode_gibs']:.1f} "
        f"GiB/s; hybrid window {cap['hybrid_window_gib']:.0f} GiB at "
        f"{cap['hybrid_window_gibs']:.2f} GiB/s, device share "
        f"{cap['hybrid_window_device_frac']:.3f} (gate "
        f"{cap['hybrid_window_gate']}, link {cap['hybrid_window_link_gibs']})")
    out["capture"] = cap
    by_path["tools_capture"] = cap["launches"]
    # (c) the transport, pool and link smokes on the card
    for name, path in (("transport_smoke", "tools_transport"),
                       ("pool_smoke", "tools_pool"),
                       ("link_profile", "tools_link")):
        res = tool_json(run_tool(ctx, name))
        check(not res["synthetic"], f"{name} ran the synthetic link")
        out[name] = res
        by_path[path] = res["launches"]
    t = out["transport_smoke"]
    log(f"[tools] on {card}: transport_smoke: link {t['link_gibs']:.2f} GiB/s,"
        f" device share {t['tpu_frac']:.2f}, {t['copies_per_block']:.2f} copies"
        f" per block, {t['dispatches']} dispatches, {t['slot_overlaps']} "
        "overlapping slot pairs, bytes-level calls "
        f"{t['bytes_level_submissions']}")
    p = out["pool_smoke"]
    log(f"[tools] on {card}: pool_smoke: warm pass staged "
        f"{p['warm_link_bytes']} B, hit {p['final']['hit_bytes']} + miss "
        f"{p['final']['miss_bytes']} B, hit ratio {p['hit_ratio']:.2f}")
    lp = out["link_profile"]
    log(f"[tools] on {card}: link_profile: {len(lp['sweep']['cells'])} cells, "
        f"sum_ok {lp['sweep']['sum_ok']}, probe {lp['link_gibs']:.2f} GiB/s, "
        f"stages {json.dumps(lp['probe_stages'])}")
    # (d) the dev cluster
    try:
        out["dev"] = tools_dev_cluster(ctx, root, by_path)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # (e) the chaos drill's partition and disk phases, every codec on the card
    chaos = tool_json(run_tool(ctx, "chaos", "--quick", "--phases",
                               "partition,disk", timeout=600), "CHAOS ")
    check(chaos["ok"], f"tools: chaos failed: {json.dumps(chaos)[:2000]}")
    for ph, st in chaos["phases"].items():
        check(st["errors"] == 0, f"tools: chaos {ph}: {st['errors']} errors")
        log(f"[tools] on {card}: chaos {ph}: {st['puts']} PUTs, {st['gets']} "
            f"GETs, 0 errors, p50 {st.get('p50_ms')} ms, p99 "
            f"{st.get('p99_ms')} ms")
    out["chaos"] = chaos
    by_path["tools_chaos"] = chaos["launches"]
    torch.cuda.synchronize()
    for path, counts in by_path.items():
        log(f"[tools] launches on the {path} path: {json.dumps(counts)}")
        for name in TOOLS_NEEDS[path]:
            check(counts[name] > 0,
                  f"kernel {name} was not launched on the {path} path")
    out["launches_by_path"] = by_path
    out["launches"] = {name: sum(c[name] for c in by_path.values())
                       for name in CODEC_KERNELS}
    out["seconds"] = dict(ctx["tool_s"])
    return out


def tools_dev_cluster(ctx, root: Path, by_path: dict) -> dict:
    """tools/dev_cluster.sh and dev_configure.sh under a temporary
    GARAGE_TPU_DEV_DIR, then smoke, metadata_smoke and cpu_profile, a
    scrub on every node, device_timeline and incident_dump; each node's
    `codec info` must show K1 and K4 launches; SIGTERM exits 0."""
    card = ctx["card"]
    base = root / "dev"
    env = tool_env(ctx, GARAGE_TPU_DEV_DIR=str(base))
    tools = ctx["repo"] / "garage_tpu_torch" / "tools"
    log_path = root / "dev_cluster.log"
    res = {}
    t0 = time.perf_counter()
    with open(log_path, "wb") as f:
        script = subprocess.Popen(["bash", str(tools / "dev_cluster.sh")],
                                  cwd=str(ctx["repo"]), env=env, stdout=f,
                                  stderr=subprocess.STDOUT,
                                  start_new_session=True)
    try:
        pids = {}
        deadline = time.perf_counter() + 120
        while len(pids) < DEV_NODES:
            check(script.poll() is None, "tools: dev_cluster.sh exited: "
                  + log_path.read_text(errors="replace")[-3000:])
            check(time.perf_counter() < deadline, "tools: no daemon pids")
            pids = {int(m.group(1)): int(m.group(2)) for m in re.finditer(
                r"^node(\d) pid (\d+)$", log_path.read_text(errors="replace"),
                re.M)}
            time.sleep(0.2)
        from garage_tpu_torch.tools.dev import DevCluster

        dev = DevCluster(base)
        for port in dev.s3_ports:
            while True:
                check(script.poll() is None, "tools: a daemon died: "
                      + log_path.read_text(errors="replace")[-3000:])
                check(time.perf_counter() < deadline,
                      f"tools: S3 port {port} did not answer")
                try:
                    socket.create_connection(("127.0.0.1", port), 1).close()
                    break
                except OSError:
                    time.sleep(0.2)
        res["up_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        r = subprocess.run(["bash", str(tools / "dev_configure.sh")],
                           cwd=str(ctx["repo"]), env=env, capture_output=True,
                           text=True, timeout=300)
        check(r.returncode == 0, f"tools: dev_configure.sh exited "
              f"{r.returncode}: {r.stdout[-2000:]}{r.stderr[-2000:]}")
        res["configure_s"] = time.perf_counter() - t1
        res["smoke"] = tool_json(run_tool(ctx, "smoke", env=env))
        res["metadata_smoke"] = tool_json(run_tool(ctx, "metadata_smoke",
                                                   env=env))
        res["cpu_profile"] = tool_json(run_tool(ctx, "cpu_profile", env=env))
        # a scrub on every node, tranquility 0, to its end
        dev_cli_all(ctx, env, base, "worker", "set", "scrub-tranquility", "0")
        before = log_path.read_text(errors="replace").count("scrub complete")
        t2 = time.perf_counter()
        dev_cli_all(ctx, env, base, "repair", "scrub", "--cmd", "start")
        while (log_path.read_text(errors="replace").count("scrub complete")
               < before + DEV_NODES):
            check(script.poll() is None, "tools: a daemon died in the scrub")
            check(time.perf_counter() - t2 < 300, "tools: the dev cluster's "
                  "scrubs did not complete in 300 s")
            time.sleep(0.2)
        res["scrub_s"] = time.perf_counter() - t2
        tl_path = root / "timeline.json"
        tl = tool_json(run_tool(ctx, "device_timeline", "-o", str(tl_path),
                                env=env))
        check(tl["events"] > 0 and tl["by_cat"].get("feeder", 0) > 0
              and tl["by_cat"].get("transport", 0) > 0,
              f"tools: node 0's timeline lacks the feeder's or the "
              f"transport's events: {tl['by_cat']}")
        res["timeline"] = tl
        run_tool(ctx, "incident_dump", "--reason", "chip-smoke", env=env)
        for i, text in enumerate(dev_cli_all(ctx, env, base, "codec",
                                             "info")):
            info = json.loads(text)
            la = info["launches"]
            check(la["blake2s"] > 0 and la["fused_scrub"] > 0,
                  f"tools: dev node {i}: launches {json.dumps(la)}")
            by_path[f"tools_dev_n{i}"] = la
            res[f"n{i}"] = {"launches": la, "bytes": info["bytes"],
                            "routes": info["feeder"]["routes"]}
            log(f"[tools] on {card}: dev node {i} (hybrid): bytes by side "
                f"{json.dumps(info['bytes'])}, launches {json.dumps(la)}")
        for i, pid in sorted(pids.items()):
            os.kill(pid, signal.SIGTERM)
        try:
            rc = script.wait(DAEMON_STOP_S + 15)
        except subprocess.TimeoutExpired:
            fail("tools: the dev cluster's daemons did not exit after "
                 "SIGTERM")
        text = log_path.read_text(errors="replace")
        codes = {int(m.group(1)): int(m.group(2)) for m in re.finditer(
            r"^node(\d) exited (\d+)$", text, re.M)}
        check(rc == 0 and codes == {i: 0 for i in range(DEV_NODES)},
              f"tools: dev daemons exited {codes} (script {rc}): "
              f"{text[-3000:]}")
        res["exit_codes"] = codes
        log(f"[tools] on {card}: dev cluster up {res['up_s']:.1f} s, "
            f"configured {res['configure_s']:.1f} s, smoke "
            f"{res['smoke']['total_s']:.1f} s, metadata_smoke "
            f"{res['metadata_smoke']['objects']} objects loaded in "
            f"{res['metadata_smoke']['load_s']:.1f} s, cpu profile overhead "
            f"{res['cpu_profile']['overhead_ratio']:.4f}, scrub of 3 nodes "
            f"{res['scrub_s']:.1f} s, timeline {tl['events']} events "
            f"{json.dumps(tl['by_cat'])}, SIGTERM exit codes {codes}")
    finally:
        if script.poll() is None:
            os.killpg(script.pid, signal.SIGKILL)
            script.wait()
    return res


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
    from garage_tpu_torch.tools.timing import (SMS, b2s_message_ms,
                                               time_kernel_clocked)

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
                                               bound_ms, ops_ms, queued_ms,
                                               time_kernel_clocked)

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


def phase_times(ctx, main: dict, prod: dict, split: dict, store: dict,
                garage: dict, daemon: dict, chaos: dict, tools: dict,
                tune: dict) -> list:
    torch = ctx["torch"]
    from garage_tpu_torch.ops.cuda_blake2s import blake2s_batch, g_chain_cycles
    from garage_tpu_torch.tools.timing import (B2S_CHAIN_G_PER_CHUNK,
                                               B2S_G_DEPTH, B2S_OPS_PER_CHUNK,
                                               b2s_message_ms, b2s_work,
                                               bound_ms, queued_ms,
                                               time_kernel_clocked)

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
                    "ms_by_lanes": {str(n): c["ms"] for n, c in chain.items()},
                    "tune_ms_by_lanes": {
                        str(c["lanes"]): c["ms"]
                        for c in tools["b2s_tune"]["cells"]}},
        "gf_apply": {"runtime_ms": gf["scrub"]["runtime_ms"],
                     "narrow_ms": gf["narrow"]["ms"],
                     "narrow_runtime_ms": gf["narrow"]["runtime_ms"],
                     "full_decode_ms": gf["full_decode"]["ms"],
                     "launches_by_body": gf_bodies_launched(
                         main, prod, split, store, garage, daemon, chaos,
                         tools)},
        "fused_scrub": {},
    }
    rows, bounds = [], {}
    paths = (main, prod, split, store, garage, daemon, chaos, tools)
    by_path = {p: c for path in paths
               for p, c in path["launches_by_path"].items()}
    for name in CODEC_KERNELS:
        bms, by = bound_ms(*work[name], dep[name])
        roof, roof_by = bound_ms(*work[name])
        bounds[name] = {"roofline_ms": roof, "roofline_by": roof_by,
                        "message_ms": dep[name]}
        rows.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": sum(path["launches"][name] for path in paths),
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


def gf_bodies_launched(*phases: dict) -> dict:
    """GF kernel launches by body over the paths of the given phases."""
    total = {}
    for paths in (ph["launches_by_path"] for ph in phases):
        for counts in paths.values():
            for body, n in counts.get("gf_apply_by", {}).items():
                total[body] = total.get(body, 0) + n
    return total


def nvidia_smi(*args) -> list:
    """The lines `nvidia-smi *args` prints."""
    out = subprocess.run(["nvidia-smi", *args], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()


def nvidia_smi_line() -> str:
    return nvidia_smi("--query-gpu=name,power.limit",
                      "--format=csv,noheader")[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="small shapes (64 KiB blocks, 64-block batches): a "
                         "first build-and-check of new kernels")
    ap.add_argument("--out", help="also write the measurements as JSON here")
    ap.add_argument("--seed", type=int, default=SEED,
                    help="seeds the garage phase's object sizes, data, "
                         "degraded reads and the two nodes it kills, and "
                         "the daemon phase's objects and planted byte")
    ap.add_argument("--chaos-child", metavar="FILE", help=argparse.SUPPRESS)
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
           # store and garage at 256 MiB per node: the depth cut that
           # keeps the whole script near 900 s of its 1200 s limit
           "store_blocks": 128 if args.quick else 256,
           "garage_blocks": 128 if args.quick else 256,
           "daemon_objects": 32 if args.quick else 256, "repo": repo,
           "chaos_nodes": 6 if args.quick else 24,
           "chaos_zones": 3 if args.quick else 4,
           "heal_timeout_s": 300, "seed": args.seed, "quick": args.quick,
           "tune_reps": 10 if args.quick else 100}
    card = ctx["card"] = nvidia_smi_line()
    if args.chaos_child:
        return chaos_child(ctx, Path(args.chaos_child))
    log(f"[card] {torch.cuda.get_device_name(0)} ({card}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    phase_s = ctx["phase_s"] = {}

    def run(name, phase, needs=()):
        """phase(ctx), timed; every kernel in `needs` launched on its path."""
        t = time.perf_counter()
        out = phase(ctx)
        phase_s[name] = time.perf_counter() - t
        log(f"[phase] {name}: {phase_s[name]:.1f} s")
        for kname in needs:
            check(out["launches"][kname] > 0,
                  f"kernel {kname} was not launched on the {name} path")
        return out

    run("build", phase_build)
    run("kernels", phase_kernels)
    main_out = run("main", phase_main)
    for name, n in main_out["launches"].items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    prod_out = run("production", phase_production, CODEC_KERNELS)
    split_out = run("split", phase_split, CODEC_KERNELS)
    store_out = run("store", phase_store, CODEC_KERNELS)
    garage_out = run("garage", phase_garage, CODEC_KERNELS)
    daemon_out = run("daemon", phase_daemon, CODEC_KERNELS)
    chaos_out = run("chaos", phase_chaos, CODEC_KERNELS)
    tools_out = run("tools", phase_tools, CODEC_KERNELS)
    tune_out = run("tune", phase_tune)
    rows = phase_times(ctx, main_out, prod_out, split_out, store_out,
                       garage_out, daemon_out, chaos_out, tools_out, tune_out)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s; by "
        f"phase {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "card": card, "kernels": rows, "build_s": ctx["build_s"],
            "main": {k: v for k, v in main_out.items()},
            "production": prod_out, "split": split_out, "store": store_out,
            "garage": garage_out, "daemon": daemon_out, "chaos": chaos_out,
            "tools": tools_out, "tune": tune_out, "phase_s": phase_s,
            "host_op_us": ctx["host_op_us"],
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
