"""One capture of the card's rates under the codec: link, kernels, hybrid.

    python -m garage_tpu_torch.tools.device_capture [--out FILE]

The port's ``scripts/device_capture.py`` with the parts of ``bench.py``
it needs (``make_batches`` ``:164``, the constants ``:73-77``,
``bench_device_resident`` ``:227`` and ``_device_phase`` ``:268-470``).
On cuda:0 it records:

  - ``dispatch_rtt_ms``: one tiny kernel and a synchronize, the mean of 5;
  - ``link_h2d_reported_gibs``: 64 MiB of pageable host memory copied to
    the card, copy + synchronize;
  - ``link_roundtrip_gibs``: the forced round trip of 16 MiB, an upload and
    a reduction fetched back to the host (after one untimed warm-up);
  - the device-resident rates, the batch already on the card
    (``bench_device_resident``): the fused scrub (K4,
    ``CudaCodec.fused_scrub``) on the reference's ladder of rungs up to the
    codec's device lanes (``device_batch_blocks``) of 1 MiB blocks; the
    GF(2^8) kernel (K2, ``gf_apply``) encoding RS(8,4) over 32 blocks of 1
    MiB, beside ``gf_bitmatmul`` (the JAX package's non-hand bit-matrix
    form, a library int8 matmul) on the same codewords; and the decode
    rows of two lost shards (K3) from the 8 survivors.  Each result is
    checked (digests against hashlib, parity against the numpy GF(2^8)
    oracle, decoded rows against the data) before it is timed with CUDA
    events (``tools/timing.queued_ms``; the GF forms with a cold L2, as
    their 32 MiB slab would otherwise sit in the 50 MB L2);
  - the 2 GiB hybrid window: ``N_BATCHES`` x 256 x 1 MiB through
    ``HybridCodec.scrub_many`` (two distinct host batches, referenced in
    turn, never copied), its GiB/s and the share of its bytes the device
    took.

Rates are GiB/s of data read.  Writes one JSON line to ``--out`` (default
``build/device_capture.json`` under the checkout; the root's
``DEVICE_CAPTURE.json`` is the reference's record and is never written)
and prints it.  Needs a CUDA device: without one it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from .common import (check, emit, launch_counts, nvidia_smi_line,
                     require_card, reset_launches)

BLOCK = 1 << 20          # 1 MiB, the reference's default block size
K, M = 8, 4
BATCH = 256              # blocks per device batch (256 MiB)
N_DISTINCT = 2           # distinct host batches cycled (host RAM bound)
N_BATCHES = 8            # total batches per timed run (2 GiB)
GF_BLOCKS = 32           # the GF rates' slab: 4 RS(8,4) codewords
LOST = (2, 5)            # the decode's lost data shards
REPS = 10
OUT = Path(__file__).resolve().parents[2] / "build" / "device_capture.json"


def make_batches(rng):
    """N_DISTINCT batches of (blocks list, hashes list) — the form the
    scrub worker feeds the codec (bytes read from disk)."""
    from ..utils.data import Hash

    batches = []
    for _ in range(N_DISTINCT):
        arr = rng.integers(0, 256, (BATCH, BLOCK), dtype=np.uint8)
        blocks = [arr[i].tobytes() for i in range(BATCH)]
        hashes = [
            Hash(hashlib.blake2s(b, digest_size=32).digest()) for b in blocks
        ]
        batches.append((blocks, hashes))
    return batches


def _time_ms(fn, reps: int, device: torch.device,
             cold: bool = False) -> float:
    """Milliseconds per fn(): CUDA events on a card (queued_ms; `cold`:
    each call after a read larger than the L2, timed until its output is
    back in HBM), the host clock over `reps` calls for the CPU (the plain
    versions, in tests)."""
    if device.type == "cuda":
        from .timing import FLUSH_BYTES, queued_ms

        flush = (torch.empty((FLUSH_BYTES,), dtype=torch.uint8,
                             device=device) if cold else None)
        return queued_ms(fn, reps, flush)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _random(shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=device,
                         generator=gen)


def _oracle_parity(mat: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """(ncw, k, S) uint8 → (ncw, r, S) through the numpy GF(2^8) oracle."""
    from ..ops import gf256

    return gf256.gf_matmul_blocks(mat, shards)


def fused_rung(codec, lanes: int, blk: int, reps: int, seed: int) -> dict:
    """K4 at `lanes` x `blk`: digests of lanes 0 and lanes-1 against
    hashlib, a clean re-verify (no corrupt lane), the first codeword's
    parity against the numpy oracle, then the timed rate."""
    from ..ops import gf256

    dev = codec.device
    da = _random((lanes, blk), seed, dev)
    dl = torch.full((lanes,), blk, dtype=torch.int32, device=dev)
    de = codec.fused_scrub(da, dl, torch.zeros((lanes, 8), dtype=torch.int32,
                                               device=dev))[0]
    host = da[[0, lanes - 1]].cpu().numpy()
    for row, lane in zip(host, (0, lanes - 1)):
        got = de[lane].cpu().numpy().astype("<u4").tobytes()
        check(got == hashlib.blake2s(row.tobytes(), digest_size=32).digest(),
              f"fused scrub digest of lane {lane} != hashlib at "
              f"{lanes} x {blk}")
    _h, ok, bad, parity = codec.fused_scrub(da, dl, de)
    check(int(bad) == 0 and bool(ok.all()),
          f"fused scrub re-verify found {int(bad)} corrupt lanes")
    k = codec.params.rs_data
    want = _oracle_parity(gf256.rs_parity_matrix(k, codec.params.rs_parity),
                          da[:k].cpu().numpy()[None])
    check(np.array_equal(parity[:1].cpu().numpy(), want),
          f"fused scrub parity != numpy GF(2^8) at {lanes} x {blk}")
    ms = _time_ms(lambda: codec.fused_scrub(da, dl, de), reps, dev)
    return {"lanes": lanes, "block": blk, "ms": ms,
            "gibs": lanes * blk / (ms / 1e3) / 2**30}


def gf_rates(codec, blk: int, nblocks: int, reps: int, seed: int) -> dict:
    """K2 (RS encode), gf_bitmatmul on the same codewords and K3 (the
    decode rows of LOST from the survivors), each checked, then timed."""
    from ..ops import gf256
    from ..ops.cuda_gf import consts_from_numpy, gf_apply
    from ..ops.sharded import gf_bitmatmul

    dev = codec.device
    k, m = codec.params.rs_data, codec.params.rs_parity
    ncw = nblocks // k
    data = _random((ncw, k, blk), seed, dev)
    x32 = data.view(torch.int32).view(ncw, k, blk // 4)
    enc = gf256.rs_parity_matrix(k, m)
    K_enc = consts_from_numpy(enc, dev)
    parity = gf_apply(x32, K_enc).view(torch.uint8).view(ncw, m, blk)
    check(np.array_equal(parity.cpu().numpy(),
                         _oracle_parity(enc, data.cpu().numpy())),
          "gf_apply parity != numpy GF(2^8)")
    w = torch.from_numpy(np.asarray(gf256.bitmatrix_of_gf_matrix(enc),
                                    dtype=np.int8)).to(dev)
    check(torch.equal(gf_bitmatmul(data, w), parity),
          "gf_bitmatmul != gf_apply on the same codewords")
    present = [i for i in range(k + m) if i not in LOST][:k]
    rows = gf256.rs_decode_matrix(k, m, present)[list(LOST)]
    K_dec = consts_from_numpy(np.ascontiguousarray(rows), dev)
    full = torch.cat([data, parity], dim=1)
    surv = full[:, present].contiguous()
    s32 = surv.view(torch.int32).view(ncw, k, blk // 4)
    rebuilt = gf_apply(s32, K_dec).view(torch.uint8).view(ncw, len(LOST), blk)
    check(torch.equal(rebuilt, data[:, list(LOST)]),
          f"decoded rows {LOST} != the lost data")
    nbytes = ncw * k * blk
    # the slab (32 MiB) fits the 50 MB L2: time each call with a cold L2,
    # as a scrub that streams blocks through the card meets it
    ms = {"gf_apply": _time_ms(lambda: gf_apply(x32, K_enc), reps, dev,
                               cold=True),
          "gf_bitmatmul": _time_ms(lambda: gf_bitmatmul(data, w), reps, dev,
                                   cold=True),
          "gf_decode": _time_ms(lambda: gf_apply(s32, K_dec), reps, dev,
                                cold=True)}
    out = {"gf_shape": [ncw, k, blk], "gf_lost": list(LOST)}
    for name, t in ms.items():
        out[f"{name}_ms"] = t
        out[f"{name}_gibs"] = nbytes / (t / 1e3) / 2**30
    return out


def bench_device_resident(codec, device_lanes: int, block: int = BLOCK,
                          gf_blocks: int = GF_BLOCKS, reps: int = REPS,
                          seed: int = 7) -> dict:
    """Device-only rates with the batch already resident on the card: the
    fused scrub on the reference's ladder of rungs, (128 lanes, block/16),
    (min(device_lanes, 1024), block/4), (device_lanes, block), smallest
    first, the last rung's rate as ``fused_scrub_gibs``; then gf_rates."""
    out = {"fused_scrub_rungs": []}
    done = set()
    for n, blk in ((128, block // 16), (min(device_lanes, 1024), block // 4),
                   (device_lanes, block)):
        if (n, blk) in done:
            continue
        done.add((n, blk))
        rung = fused_rung(codec, n, blk, reps, seed + len(done))
        out["fused_scrub_rungs"].append(rung)
    last = out["fused_scrub_rungs"][-1]
    out.update(fused_scrub_gibs=last["gibs"], fused_scrub_ms=last["ms"],
               fused_scrub_lanes=last["lanes"],
               fused_scrub_block=last["block"])
    out.update(gf_rates(codec, block, gf_blocks, reps, seed + 11))
    return out


def link_rates(dev: torch.device) -> dict:
    """The dispatch round trip and the two link rates of the reference's
    capture (the numbers its hybrid gate depends on)."""
    x = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    (x + 1).sum().item()
    t0 = time.perf_counter()
    for _ in range(5):
        x.add(1)
        torch.cuda.synchronize()
    rec = {"dispatch_rtt_ms": (time.perf_counter() - t0) / 5 * 1e3}
    arr = np.random.default_rng(9).integers(0, 256, (64 << 20,),
                                            dtype=np.uint8)
    src = torch.from_numpy(arr)
    t0 = time.perf_counter()
    d = src.to(dev)
    torch.cuda.synchronize()
    rec["link_h2d_reported_gibs"] = arr.nbytes / (
        time.perf_counter() - t0) / 2**30
    del d
    src16 = src[: 16 << 20]
    int(src16.to(dev).sum(dtype=torch.int64))    # warm-up, untimed
    t0 = time.perf_counter()
    int(src16.to(dev).sum(dtype=torch.int64))
    rec["link_roundtrip_gibs"] = src16.numel() / (
        time.perf_counter() - t0) / 2**30
    return rec


def hybrid_window(codec) -> dict:
    """N_BATCHES x BATCH x BLOCK through scrub_many: every block verified,
    the window's GiB/s and the share of its bytes on the device."""
    batches = make_batches(np.random.default_rng(0))
    stream = [batches[i % N_DISTINCT] for i in range(N_BATCHES)]
    codec.pop_stats()
    t0 = time.perf_counter()
    out = codec.scrub_many(stream, fetch_parity=False)
    dt = time.perf_counter() - t0
    check(all(ok.all() for ok, _p in out), "hybrid window: a block did not "
          "verify")
    cpu_b, dev_b = codec.pop_stats()
    total = cpu_b + dev_b
    nbytes = N_BATCHES * BATCH * BLOCK
    return {"hybrid_window_gib": nbytes / 2**30,
            "hybrid_window_gibs": nbytes / dt / 2**30,
            "hybrid_window_s": dt,
            "hybrid_window_device_frac": dev_b / total if total else 0.0,
            "hybrid_window_link_gibs": codec.last_link_gibs,
            "hybrid_window_gate": codec.last_gate}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(OUT),
                    help="where to write the JSON line")
    args = ap.parse_args(argv)
    t_start = time.time()
    require_card()
    from ..ops.codec import CodecParams
    from ..ops.hybrid_codec import HybridCodec

    dev = torch.device("cuda", 0)
    rec = {"captured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
           "platform": "gpu", "device": torch.cuda.get_device_name(0),
           "card": nvidia_smi_line()}
    rec.update(link_rates(dev))
    params = CodecParams(rs_data=K, rs_parity=M, batch_blocks=BATCH)
    codec = HybridCodec(params, device="cuda:0")
    codec.warm(BLOCK)
    reset_launches()
    rec.update(bench_device_resident(codec.tpu, codec.device_batch_blocks))
    rec.update(hybrid_window(codec))
    torch.cuda.synchronize()
    rec["launches"] = launch_counts()
    codec.close()
    rec["capture_wall_s"] = time.time() - t_start
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, default=float) + "\n")
    emit(rec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
