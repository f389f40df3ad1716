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
                  count; the GF apply in both of the reference's regimes
                  (padded S4 < 2048 and >= 2048) for RS(4,2) and RS(8,4)
                  encode and an RS(8,4) decode; the fused scrub at the
                  scrub's shape against one run of its plain version, whose
                  digests also hold K1's result at that shape; every
                  variant of the GF tuning kernel (T1) at its sweep's shape.
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
  5. tune       — T1's path: tools/gf_tune.py's sweep of the GF kernel's
                  loop orders x tiles, each cell checked and timed, beside
                  the production GF kernel on the same codewords.
  6. times      — each kernel's time (CUDA events, after a warm-up) beside
                  its bound (the larger of bytes over 3.35 TB/s and the
                  fewest 32-bit instructions over the SMs' issue rate) and
                  its plain version's time; the pageable H2D copy of one
                  scrub batch; end-to-end scrub GiB/s.

Launch counts are zeroed just before each path (main's scrub / put /
decode / 1024-lane scrub, production's cold / warm / put / decode, tune)
and read just after it; each path must have launched every kernel it
runs.  The sizes are the reference configuration's defaults: 1 MiB
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
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 20261016
MIB = 1 << 20
CODEC_KERNELS = ("blake2s", "gf_apply", "fused_scrub")
KERNELS = CODEC_KERNELS + ("gf_tune",)
# H100 SXM peaks (NVIDIA's data sheet): 3.35 TB/s HBM; 67 TFLOP/s float32
# outside the tensor cores is 128 lanes x 132 SMs x 1.98 GHz x 2 (FMA).
# 128 lanes per SM per clock is also the most 32-bit instructions an SM
# can issue (one warp instruction per clock on each of its 4
# schedulers), whichever pipe runs them: the least time for integer work
# is its instruction count at that rate.
HBM_BYTES_PER_S = 3.35e12
ISSUE_OPS_PER_S = 67e12 / 2
# BLAKE2s per 64-byte chunk, in the fewest 32-bit instructions: a G is 4
# three-input adds (a + b + m is one IADD3), 4 xors and 4 rotates (one
# funnel shift each), 12 in all; 80 G, the counter and flag words, and
# the 8 three-input xors of the feed-forward
B2S_OPS_PER_CHUNK = 80 * 12 + 2 + 8


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


def time_kernel(torch, fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card: one warm-up call, then
    `reps` calls between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


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


def bound_ms(nbytes: float, ops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / ISSUE_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def b2s_work(lengths: np.ndarray, cols: int):
    """(bytes, operations) BLAKE2s must do for these lanes: each lane's
    chunks up to its own end, read once, and its 32-byte digest written."""
    nch = np.minimum(np.maximum((lengths.astype(np.int64) + 63) // 64, 1),
                     cols // 64)
    chunks = int(nch.sum())
    return chunks * 64 + lengths.size * (4 + 32), chunks * B2S_OPS_PER_CHUNK


def gf_work(b: int, k: int, r: int, s4: int):
    """(bytes, operations) of one GF apply: k rows read and r rows written
    per codeword, and the constants; r x k GF(2^8) multiply-accumulates
    per 4-byte column, one instruction each at best.  The bytes bound it:
    the apply is memory-bound, as the kernel's source note says."""
    nbytes = 4 * b * s4 * (k + r) + 4 * r * k * 8
    ops = b * s4 * k * r
    return nbytes, ops


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

    # K2/K3: both regimes of the reference dispatch, encode and decode
    present = [0, 1, 3, 4, 6, 7, 8, 9, 10, 11]   # shards 2 and 5 lost
    dec = gf256.rs_decode_matrix(8, 4, present)
    mats = {
        "encode RS(4,2)": gf256.rs_parity_matrix(4, 2),
        "encode RS(8,4)": mat,
        "decode RS(8,4)": dec,
        "decode RS(8,4) rows [2,5]": np.ascontiguousarray(dec[[2, 5]]),
    }
    for regime, (b, s4) in (("narrow S4<2048", (37, 300)),
                            ("wide S4>=2048", (5, 2500))):
        for label, m in mats.items():
            k = m.shape[1]
            x = rng.integers(0, 2**32, (b, k, s4), dtype=np.uint32)
            dx = torch.from_numpy(x.view(np.int32)).to(dev)
            K = consts_from_numpy(m, dev)
            got = gf_apply(dx, K).cpu().numpy().view(np.uint32)
            plain = gf_apply_plain(dx, K).cpu().numpy().view(np.uint32)
            want = oracle.apply(m, x.view(np.uint8).reshape(b, k, 4 * s4))
            check(np.array_equal(got, plain),
                  f"gf kernel != plain version ({label}, {regime})")
            check(np.array_equal(got.view(np.uint8).reshape(want.shape), want),
                  f"gf kernel != numpy GF(2^8) ({label}, {regime})")
            if label == "decode RS(8,4)" and regime.startswith("wide"):
                check(np.array_equal(got, np.asarray(
                    gf256.gf_matmul_blocks(m, x.view(np.uint8).reshape(
                        b, k, 4 * s4))).view(np.uint32).reshape(got.shape)),
                      "gf kernel != gf256.gf_matmul_blocks")
            log(f"[kernels] gf_apply {label}, {regime}: B={b} k={k} S4={s4} "
                f"bit-exact vs plain version and numpy GF(2^8)")

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

    # T1: every variant of the sweep's kernel at T1's shape, (8, 2^20)
    # words of 4 codewords folded flat, at one tile, against its plain
    # version (the variant's loop order) and the numpy oracle
    from garage_tpu_torch.tools import gf_tune

    u32, xflat, _cw, masks, _scalar, tmat = gf_tune.staged_group(dev)
    ncw = u32.shape[0]
    t_want = oracle.apply(tmat, u32.view(np.uint8).reshape(
        ncw, 8, -1)).view("<u4").reshape(ncw, 4, -1)
    tune_err, tune_plain_ms = 0, {}
    for variant in gf_tune.VARIANTS:
        got = gf_tune.gf_tune(xflat, masks, variant, 4096)
        plain, tune_plain_ms[variant] = time_host(
            torch, lambda: gf_tune.gf_tune_plain(xflat, masks, variant))
        err = max_abs_err(got.cpu().numpy().view(np.uint32),
                          plain.cpu().numpy().view(np.uint32))
        check(err == 0, f"gf_tune {variant} != its plain version")
        check(np.array_equal(gf_tune.unfold(got.cpu().numpy().view("<u4"), ncw),
                             t_want), f"gf_tune {variant} != numpy GF(2^8)")
        tune_err = max(tune_err, err)
        log(f"[kernels] gf_tune {variant} tile 4096 at {tuple(xflat.shape)}: "
            f"bit-exact vs plain version and numpy GF(2^8) (plain "
            f"{tune_plain_ms[variant]:.1f} ms)")
    del xflat, masks, _cw

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
                         "fused_scrub": cuda_codec.fused_launches}
        for name in path_needs[path]:
            check(by_path[path][name] > 0,
                  f"kernel {name} was not launched on the {path} path")

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
            "gf_tune": gf_tune.launches}


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
    for tag, cell in sorted(res["cells"].items()):
        log(f"[tune] {tag}: {cell['ms']:.4f} ms, {cell['gibs']:.1f} GiB/s of "
            "data, bit-exact vs numpy GF(2^8)")
    log(f"[tune] gf_apply on the same codewords: {res['gf_apply']['ms']:.4f} ms "
        f"({res['gf_apply']['gibs']:.1f} GiB/s); best {res['best']['tag']}; "
        f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}); "
        f"{res['launches']} launches")
    return res


def phase_times(ctx, main: dict, prod: dict, tune: dict) -> list:
    torch = ctx["torch"]
    from garage_tpu_torch.ops.cuda_blake2s import blake2s_batch
    from garage_tpu_torch.ops.cuda_gf import gf_apply

    da, dl, lens = ctx["k1_inputs"]
    codec, _, _, de = ctx["k4_inputs"]
    groups, K_enc = ctx["gf_inputs"]
    lanes, cols = da.shape
    reps = ctx["reps"]
    ms = {
        "blake2s": time_kernel(torch, lambda: blake2s_batch(da, dl), reps),
        "gf_apply": time_kernel(torch, lambda: gf_apply(groups, K_enc), 4 * reps),
        "fused_scrub": time_kernel(
            torch, lambda: codec.fused_scrub(da, dl, de), reps),
    }
    host = da.cpu().numpy()
    _, h2d_ms = time_host(torch, lambda: torch.from_numpy(host).to(ctx["device"]))
    parity = codec.fused_scrub(da, dl, de)[3]
    _, d2h_ms = time_host(torch, lambda: parity.cpu())
    # the 1024-lane device submission: the same batch four times over
    wda, wdl, wde = da.repeat(4, 1), dl.repeat(4), de.repeat(4, 1)
    wide_ms = {
        "blake2s": time_kernel(torch, lambda: blake2s_batch(wda, wdl), reps),
        "fused_scrub": time_kernel(
            torch, lambda: codec.fused_scrub(wda, wdl, wde), reps),
    }
    del wda, wdl, wde
    # the narrow regime (the reference's batch-folded K3 path, padded
    # S4 < 2048): a repair storm of 4 KiB blocks, 1024 codewords each
    # losing shards 2 and 5
    from garage_tpu_torch.ops import gf256
    from garage_tpu_torch.ops.cuda_gf import consts_from_numpy, gf_apply_plain

    dec = gf256.rs_decode_matrix(8, 4, [0, 1, 3, 4, 6, 7, 8, 9])[[2, 5]]
    nrng = np.random.default_rng(SEED + 2)
    nx = torch.from_numpy(nrng.integers(0, 2**32, (1024, 8, 1024),
                                        dtype=np.uint32).view(np.int32)
                          ).to(ctx["device"])
    nK = consts_from_numpy(np.ascontiguousarray(dec), ctx["device"])
    narrow_ms = time_kernel(torch, lambda: gf_apply(nx, nK), 4 * reps)
    nplain, narrow_plain_ms = time_host(torch, lambda: gf_apply_plain(nx, nK))
    check(torch.equal(gf_apply(nx, nK), nplain),
          "gf kernel != plain version (narrow regime)")
    narrow_bound = bound_ms(*gf_work(1024, 8, 2, 1024))
    b_bytes, b_ops = b2s_work(lens, cols)
    b, k, s4 = groups.shape
    g_bytes, g_ops = gf_work(b, k, K_enc.shape[0], s4)
    # the fused function reads every data byte once (the GF apply reads
    # all columns), the lengths and expected digests, and writes digests,
    # ok flags and parity
    r = K_enc.shape[0]
    fused_bytes = lanes * cols + lanes * (4 + 32 + 32 + 1) + 4 * b * r * s4
    work = {"blake2s": (b_bytes, b_ops), "gf_apply": (g_bytes, g_ops),
            "fused_scrub": (fused_bytes, b_ops + g_ops + lanes * 8)}
    meta = {
        "blake2s": ("garage_tpu_torch/csrc/blake2s.cu",
                    "garage_tpu/ops/pallas_blake2s.py:124"),
        "gf_apply": ("garage_tpu_torch/csrc/gf_apply.cu",
                     "garage_tpu/ops/pallas_gf.py:135 and :98"),
        "fused_scrub": ("garage_tpu_torch/ops/cuda_codec.py",
                        "garage_tpu/ops/tpu_codec.py:678"),
    }
    rows = []
    by_path = {**main["launches_by_path"], **prod["launches_by_path"]}
    for name in CODEC_KERNELS:
        bms, by = bound_ms(*work[name])
        rows.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": main["launches"][name] + prod["launches"][name],
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": ctx["max_err"][name], "ms": ms[name],
            "plain_ms": ctx["plain_ms"][name], "bound_ms": bms,
            "bound_by": by, "library_ms": None,
        })
        log(f"[times] {name}: {ms[name]:.3f} ms on the card, bound "
            f"{bms:.3f} ms ({by}; {work[name][0] / 2**20:.1f} MiB, "
            f"{work[name][1] / 1e9:.2f} G instructions), plain version "
            f"{ctx['plain_ms'][name]:.1f} ms, library call: none")
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
        f"bound {tune['bound_ms']:.4f} ms ({tune['bound_by']}), plain version "
        f"({variant}) {ctx['tune_plain_ms'][variant]:.1f} ms, library call: none")
    batch_bytes = host.nbytes
    log(f"[times] pageable H2D of one {lanes} x {cols} B batch: {h2d_ms:.2f} ms "
        f"({batch_bytes / h2d_ms / 1e6:.2f} GB/s); pageable D2H of its parity "
        f"({parity.numel() / 2**20:.0f} MiB): {d2h_ms:.2f} ms; fused dispatch "
        f"{ms['fused_scrub']:.2f} ms")
    log(f"[times] at {4 * lanes} lanes: blake2s {wide_ms['blake2s']:.3f} ms, "
        f"fused scrub {wide_ms['fused_scrub']:.3f} ms "
        f"({4 * batch_bytes / wide_ms['fused_scrub'] / 1e6:.1f} GB/s)")
    log(f"[times] gf_apply narrow regime (1024, 8, 1024) decode rows [2,5]: "
        f"{narrow_ms:.3f} ms on the card, bound {narrow_bound[0]:.3f} ms "
        f"({narrow_bound[1]}), plain version {narrow_plain_ms:.1f} ms")
    ctx["summary"] = {"ms": ms, "wide_ms": wide_ms, "h2d_ms": h2d_ms,
                      "narrow_ms": narrow_ms, "narrow_plain_ms": narrow_plain_ms,
                      "narrow_bound_ms": narrow_bound[0],
                      "d2h_parity_ms": d2h_ms, "batch_bytes": batch_bytes,
                      "work": work}
    return rows


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
           "tune_reps": 10 if args.quick else 100}
    card = nvidia_smi_line()
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
    tune_out = phase_tune(ctx)
    rows = phase_times(ctx, main_out, prod_out, tune_out)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "card": card, "kernels": rows, "build_s": ctx["build_s"],
            "main": {k: v for k, v in main_out.items()},
            "production": prod_out, "tune": tune_out,
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
