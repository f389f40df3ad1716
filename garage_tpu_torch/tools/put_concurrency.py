"""Concurrent PutObject attribution.

    python -m garage_tpu_torch.tools.put_concurrency

The port's ``scripts/put_concurrency.py``.  Measures, on in-process
clusters of the reference harness's shape (``testing/cluster.mk_cluster``,
the CPU codec: this measures the host path):
  A. solo serial p50          (1 node,  1 in-flight)  — the floor
  B. replica serial p50       (3 nodes, 1 in-flight)  — bench put_p50's
                               actual shape: ONE core executes all 3
                               replicas' writes + RPC framing
  C. concurrent p50/p99       (1 node,  8 in-flight)
  D. concurrent p50/p99       (3 nodes, 8 in-flight)
plus per-put process-CPU cost (rusage) and throughput, which is the
queueing attribution: if each put costs ~C ms of CPU on a 1-core host,
K in-flight CPU-bound puts must see ≈ K x C latency while throughput stays
flat — latency under concurrency is then arrival queueing, not an
engine defect.  Prints one JSON line.
"""

import asyncio
import json
import resource
import time

import numpy as np

from ..testing.cluster import mk_cluster
from ..testing.s3_client import S3Client

BLOCK = 1 << 20
N_SERIAL = 48
N_CONC = 64
INFLIGHT = 8


def pct(xs, p):
    xs = sorted(xs)
    return round(xs[min(len(xs) - 1, int(len(xs) * p))], 2)


async def drive(n_nodes, repl, label, out):
    import pathlib
    import shutil
    import tempfile

    import aiohttp

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="putconc_"))
    try:
        garages, server, port, kid, secret = await mk_cluster(
            tmp, n=n_nodes, repl=repl, codec_cfg={"backend": "cpu"})
        rng = np.random.default_rng(2)
        async with aiohttp.ClientSession() as session:
            s3 = S3Client(session, port, kid, secret)
            st, _b, _h = await s3.req("PUT", "/bkt")
            assert st == 200
            await s3.req("PUT", "/bkt/warm",
                         rng.integers(0, 256, BLOCK,
                                      dtype=np.uint8).tobytes())

            # serial
            lat = []
            ru0 = resource.getrusage(resource.RUSAGE_SELF)
            t_s0 = time.perf_counter()
            for i in range(N_SERIAL):
                payload = rng.integers(0, 256, BLOCK,
                                       dtype=np.uint8).tobytes()
                t0 = time.perf_counter()
                st, _b, _h = await s3.req("PUT", f"/bkt/s{i:04d}", payload)
                assert st == 200
                lat.append((time.perf_counter() - t0) * 1000)
            dt_serial = time.perf_counter() - t_s0
            ru1 = resource.getrusage(resource.RUSAGE_SELF)
            cpu_ms = ((ru1.ru_utime - ru0.ru_utime)
                      + (ru1.ru_stime - ru0.ru_stime)) / N_SERIAL * 1000
            out[f"{label}_serial_p50_ms"] = pct(lat, 0.5)
            out[f"{label}_serial_cpu_ms_per_put"] = round(cpu_ms, 2)
            out[f"{label}_serial_puts_per_s"] = round(
                N_SERIAL / dt_serial, 1)

            # concurrent (INFLIGHT in flight, windowed)
            payloads = [rng.integers(0, 256, BLOCK,
                                     dtype=np.uint8).tobytes()
                        for _ in range(N_CONC)]
            lat = []

            async def one(i):
                t0 = time.perf_counter()
                st, _b, _h = await s3.req("PUT", f"/bkt/c{i:04d}",
                                          payloads[i])
                assert st == 200
                lat.append((time.perf_counter() - t0) * 1000)

            t_c0 = time.perf_counter()
            sem = asyncio.Semaphore(INFLIGHT)

            async def gated(i):
                async with sem:
                    await one(i)

            await asyncio.gather(*[gated(i) for i in range(N_CONC)])
            dt_conc = time.perf_counter() - t_c0
            out[f"{label}_conc{INFLIGHT}_p50_ms"] = pct(lat, 0.5)
            out[f"{label}_conc{INFLIGHT}_p99_ms"] = pct(lat, 0.99)
            out[f"{label}_conc{INFLIGHT}_puts_per_s"] = round(
                N_CONC / dt_conc, 1)
        await server.stop()
        for g in garages:
            await g.shutdown()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


async def main():
    out = {}
    await drive(1, "none", "solo", out)
    await drive(3, "3", "repl3", out)
    print(json.dumps(out))


if __name__ == "__main__":
    asyncio.run(main())
