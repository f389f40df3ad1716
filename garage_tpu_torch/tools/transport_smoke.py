"""Transport smoke: drive the zero-copy device transport end to end.

    python -m garage_tpu_torch.tools.transport_smoke [--synthetic]

The port's ``scripts/transport_smoke.py``.  A HybridCodec over a CudaCodec
on cuda:0 (``--synthetic``: the reference's synthetic in-process link on
the CPU, ``testing/synthetic_device.SyntheticLinkCodec``) takes a
foreground hash and a background scrub of the same eight blocks through
one CodecFeeder, and the reference's acceptance invariants must hold:

  - the hybrid gate OPENS through the transport's link probe (device-side
    bytes > 0);
  - the staging copy counter shows <= 1 host copy per block;
  - background scrub and foreground hash ride ONE feeder queue: the
    device's bytes-level API is never called;
  - results are bit-identical to the serial CPU path;
  - the live transport_* metric families pass the strict Prometheus lint;
  - the chrome-trace timeline export of the window shows >= 1 pair of
    OVERLAPPING staging slots (the double buffer at work).

Prints one JSON line: the digests, the parity's sha256, the gate's link
rate, device share, copies per block, dispatches, slot overlaps and, on
the card, the kernel launches of the drive.  Without a GPU (and without
``--synthetic``) it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import hashlib

import numpy as np

from ..ops.codec import CodecParams
from ..ops.cpu_codec import CpuCodec
from ..ops.feeder import CodecFeeder
from ..ops.hybrid_codec import HybridCodec
from ..utils.data import Hash
from ..utils.metrics import MetricsRegistry
from ..utils.promlint import lint_exposition
from ..utils.timeline import overlapping_slot_windows
from .common import (BytesLevel, check, device_codec, emit,
                     launch_counts, reset_launches)

K, M = 4, 2
SEED = 3
SIZES = (65536, 4096, 65536, 512, 65536, 65536, 777, 65536)


def run(synthetic: bool) -> dict:
    params = CodecParams(rs_data=K, rs_parity=M, block_size=1 << 16)
    reg = MetricsRegistry()
    dev = device_codec(params, synthetic, link_gibs=50.0, compute_real=True)
    bytes_level = None if synthetic else BytesLevel(dev)
    reset_launches()
    hy = HybridCodec(params, device_codec=dev, metrics=reg)
    check(hy.transport is not None, "transport did not arm")
    link = hy._probe_link()
    check(hy.ragged_side() == "tpu",
          f"gate held against the link (probe {link} GiB/s, threshold "
          f"{params.hybrid_min_link_gibs})")
    feeder = CodecFeeder(hy, slo_ms=1.0, max_batch_blocks=256, metrics=reg)
    cpu = CpuCodec(params)

    rng = np.random.default_rng(SEED)
    blocks = [rng.integers(0, 256, (n,), dtype=np.uint8).tobytes()
              for n in SIZES]
    hashes = [Hash(hashlib.blake2s(b, digest_size=32).digest())
              for b in blocks]

    # foreground hash + background scrub through ONE queue, submitted
    # back to back so the two batches pipeline through both staging slots
    fut_fg = feeder.submit_hash(blocks, peers=1)
    fut_bg = feeder.submit_scrub(blocks, hashes, want_parity=True)
    got = fut_fg.result(timeout=120)
    check([bytes(g) for g in got] == [bytes(h) for h in hashes],
          "hash mismatch through the transport")
    ok, parity = fut_bg.result(timeout=120)
    rok, rpar = cpu.scrub_encode_batch(blocks, hashes, True)
    check(ok.all() and ok.shape == rok.shape, "scrub did not verify")
    check(parity.shape == rpar.shape and (parity == rpar).all(),
          "scrub parity not bit-identical to the serial CPU path")

    tr = hy.transport
    submissions = (dev if synthetic else bytes_level).submissions
    check(submissions == 0, f"{submissions} submissions reached the device "
          "outside the transport queue")
    check(tr.copies_per_block() <= 1.0, f"copies per block: {tr.stats()}")
    frac = hy.obs.tpu_frac()
    check(frac > 0.0, "sustained_tpu_frac did not open through transport")

    body = reg.render()
    problems = lint_exposition(body)
    check(not problems, f"live transport metrics fail lint: {problems}")
    for fam in ("transport_staged_bytes_total", "transport_queue_depth",
                "transport_inflight_batches", "codec_batch_dispatch_total"):
        check(fam in body, f"family {fam} missing from live metrics")

    # the timeline: non-empty, with >= 1 pair of overlapping staging-slot
    # windows.  When the first two batches ran one after the other (the
    # lone hash dispatches at once, the scrub waits out the feeder's SLO),
    # more traffic: an unhinted hash and a scrub, which one feeder window
    # hands to the transport as two batches back to back
    chrome = hy.obs.timeline.chrome_trace()
    check(any(e.get("ph") in ("X", "i") for e in chrome["traceEvents"]),
          "timeline export is empty")
    overlaps = overlapping_slot_windows(chrome)
    tries = 0
    while overlaps < 1 and tries < 5:
        tries += 1
        futs = [feeder.submit_hash(blocks, peers=None),
                feeder.submit_scrub(blocks, hashes, want_parity=False)]
        for f in futs:
            f.result(timeout=120)
        chrome = hy.obs.timeline.chrome_trace()
        overlaps = overlapping_slot_windows(chrome)
    check(overlaps >= 1, "no overlapping staging slots in the chrome-trace "
          "export")

    feeder.shutdown()
    hy.close()
    out = {"tool": "transport_smoke", "synthetic": synthetic,
           "digests": [bytes(g).hex() for g in got],
           "ok": ok.tolist(),
           "parity_sha256": hashlib.sha256(
               np.ascontiguousarray(parity).tobytes()).hexdigest(),
           "parity_shape": list(parity.shape), "link_gibs": link,
           "tpu_frac": frac, "copies_per_block": tr.copies_per_block(),
           "dispatches": tr.dispatches, "slot_overlaps": overlaps,
           "bytes_level_submissions": submissions}
    if not synthetic:
        import torch

        torch.cuda.synchronize()
        out["launches"] = launch_counts()
        out["device"] = torch.cuda.get_device_name(0)
    print(f"transport smoke ok (tpu_frac={frac:.2f}, "
          f"copies/block={tr.copies_per_block():.2f}, "
          f"dispatches={tr.dispatches}, slot_overlaps={overlaps})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--synthetic", action="store_true",
                    help="drive the reference's synthetic link on the CPU "
                         "instead of the card")
    args = ap.parse_args(argv)
    emit(run(args.synthetic))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
