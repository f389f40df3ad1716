"""Device-pool smoke: scrub the same blocks twice through the pool.

    python -m garage_tpu_torch.tools.pool_smoke [--synthetic]

The port's ``scripts/pool_smoke.py``.  The same eight blocks are scrubbed
twice through a HybridCodec's CodecFeeder, DeviceTransport and DevicePool
over a CudaCodec on cuda:0 (``--synthetic``: the reference's synthetic
in-process link on the CPU), and the reference's warm-path invariants must
hold:

  - the second pass moves zero link bytes: the
    ``transport_staged_bytes_total`` delta across the warm pass is 0;
  - ``pool_hit_bytes_total`` > 0 and, with ``pool_miss_bytes_total``,
    attributes EVERY byte the two passes asked for;
  - warm results stay bit-identical to the serial CPU path (every pool
    read re-verified by the device's scrub);
  - invalidation is strict: a dropped hash misses on the next pass;
  - the live pool_* metric families pass the strict Prometheus lint.

Prints one JSON line: the pool's byte counts per pass, the warm pass's
staged bytes, its parity's sha256 and, on the card, the kernel launches.
Without a GPU (and without ``--synthetic``) it exits non-zero and prints
no result.
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
from .common import (check, device_codec, emit, launch_counts,
                     reset_launches)

K, M = 4, 2
SEED = 18
SIZES = (65536, 4096, 65536, 512, 65536, 65536, 777, 65536)


def run(synthetic: bool) -> dict:
    params = CodecParams(rs_data=K, rs_parity=M, block_size=1 << 16,
                         pool_mib=64, pool_page_kib=64)
    reg = MetricsRegistry()
    dev = device_codec(params, synthetic, link_gibs=50.0, compute_real=True)
    reset_launches()
    hy = HybridCodec(params, device_codec=dev, metrics=reg)
    link = hy._probe_link()
    check(hy.transport is not None, "transport did not arm")
    check(hy.pool is not None, "device pool did not arm")
    feeder = CodecFeeder(hy, slo_ms=1.0, max_batch_blocks=256, metrics=reg)
    cpu = CpuCodec(params)

    rng = np.random.default_rng(SEED)
    blocks = [rng.integers(0, 256, (n,), dtype=np.uint8).tobytes()
              for n in SIZES]
    hashes = [Hash(hashlib.blake2s(b, digest_size=32).digest())
              for b in blocks]
    total = sum(map(len, blocks))
    tr, pool = hy.transport, hy.pool

    # cold pass: every byte crosses the link, verified lanes adopted
    ok, _parity = feeder.submit_scrub(
        blocks, hashes, want_parity=True).result(timeout=120)
    check(ok.all(), "cold scrub failed verification")
    cold_staged = tr.staged_bytes
    cold = pool.stats()
    check(cold["miss_bytes"] == total and cold["hit_bytes"] == 0,
          f"cold pass pool stats {cold}")
    check(cold["resident_blocks"] == len(blocks), f"cold pass {cold}")

    # warm pass: the SAME range — device pages serve it, the link idles
    ok2, parity2 = feeder.submit_scrub(
        blocks, hashes, want_parity=True).result(timeout=120)
    check(ok2.all(), "warm scrub failed verification")
    warm_delta = tr.staged_bytes - cold_staged
    warm = pool.stats()
    check(warm_delta == 0, f"warm pass staged {warm_delta} link bytes "
          "(want 0)")
    check(warm["hit_bytes"] == total, f"warm pass pool stats {warm}")
    # the attribution identity the dashboards divide by
    check(warm["hit_bytes"] + warm["miss_bytes"] == 2 * total,
          f"hit + miss over two passes: {warm}")
    rok, rpar = cpu.scrub_encode_batch(blocks, hashes, True)
    check(ok2.shape == rok.shape and ok2.all() == rok.all(),
          "warm ok vector differs from the CPU path")
    check(parity2.shape == rpar.shape and (parity2 == rpar).all(),
          "warm scrub parity not bit-identical to the serial CPU path")

    # strict invalidation: a dropped hash is a miss on the next pass
    pool.invalidate(bytes(hashes[0]), reason="delete")
    ok3, _ = feeder.submit_scrub(
        blocks, hashes, want_parity=False).result(timeout=120)
    check(ok3.all(), "scrub after invalidation failed verification")
    st = pool.stats()
    check(st["miss_bytes"] == total + len(blocks[0]),
          f"after invalidation: {st}")
    check(st["invalidated"] == 1, f"after invalidation: {st}")

    body = reg.render()
    problems = lint_exposition(body)
    check(not problems, f"live pool metrics fail lint: {problems}")
    for fam in ("pool_hit_bytes_total", "pool_miss_bytes_total",
                "pool_evict_total", "pool_resident_bytes", "pool_pages"):
        check(fam in body, f"family {fam} missing from live metrics")

    hit_ratio = st["hit_bytes"] / (st["hit_bytes"] + st["miss_bytes"])
    feeder.shutdown()
    hy.close()
    out = {"tool": "pool_smoke", "synthetic": synthetic, "link_gibs": link,
           "total_bytes": total, "cold_staged": cold_staged,
           "warm_link_bytes": warm_delta,
           "cold": {k: cold[k] for k in ("hit_bytes", "miss_bytes")},
           "warm": {k: warm[k] for k in ("hit_bytes", "miss_bytes")},
           "final": {k: st[k] for k in ("hit_bytes", "miss_bytes",
                                        "invalidated", "resident_pages",
                                        "adopted")},
           "hit_ratio": hit_ratio,
           "warm_parity_sha256": hashlib.sha256(
               np.ascontiguousarray(parity2).tobytes()).hexdigest()}
    if not synthetic:
        import torch

        torch.cuda.synchronize()
        out["launches"] = launch_counts()
        out["device"] = torch.cuda.get_device_name(0)
    print(f"pool smoke ok (warm_link_bytes={warm_delta}, "
          f"hit_ratio={hit_ratio:.2f}, "
          f"resident_pages={st['resident_pages']}, "
          f"adopted={st['adopted']})")
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
