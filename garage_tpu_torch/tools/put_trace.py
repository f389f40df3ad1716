"""Per-stage PutObject latency breakdown via the in-tree tracer.

    python -m garage_tpu_torch.tools.put_trace

The port's ``scripts/put_trace.py`` (see docs/PUT_LATENCY.md): a 1-node
cluster of the reference harness's shape (``testing/cluster.mk_cluster``:
native db, the CPU codec, since this measures the host path); tracer
enabled with NO exporter, spans collected straight from the buffer,
grouped per trace, and printed as a timeline for the median PUT."""
import asyncio
import time
from collections import defaultdict

import numpy as np

from ..testing.cluster import mk_cluster
from ..testing.s3_client import S3Client

N = 60
BLOCK = 1 << 20


async def main():
    import pathlib
    import shutil
    import tempfile

    import aiohttp

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="put_trace_"))
    try:
        garages, server, port, kid, secret = await mk_cluster(
            tmp, n=1, repl="none", codec_cfg={"backend": "cpu"})
        g = garages[0]
        tracer = g.system.tracer
        tracer.enabled = True  # buffer spans; no exporter/export loop

        rng = np.random.default_rng(1)
        lat = []
        async with aiohttp.ClientSession() as session:
            s3 = S3Client(session, port, kid, secret)
            st, _b, _h = await s3.req("PUT", "/bkt")
            assert st == 200
            await s3.req("PUT", "/bkt/warmup",
                         rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes())
            tracer._buf.clear()
            for i in range(N):
                payload = rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes()
                t0 = time.perf_counter()
                st, _b, _h = await s3.req("PUT", f"/bkt/obj-{i:03d}", payload)
                lat.append(((time.perf_counter() - t0) * 1000, i))
                assert st == 200

        lat.sort()
        p50_ms, p50_i = lat[len(lat) // 2]
        print(f"solo put p50 = {p50_ms:.2f} ms  (n={N})")

        # group spans per trace; find traces that are S3 PUT requests
        traces = defaultdict(list)
        for sp in tracer._buf:
            traces[sp.trace_id].append(sp)
        put_traces = []
        for tid, spans in traces.items():
            root = next((s for s in spans if s.parent_id is None), None)
            if root is not None and root.name.startswith("S3 PUT"):
                put_traces.append((root, spans))
        put_traces.sort(key=lambda rs: rs[0].end_ns - rs[0].start_ns)
        root, spans = put_traces[len(put_traces) // 2]
        total = (root.end_ns - root.start_ns) / 1e6
        print(f"\nmedian-trace breakdown ({root.name}, total {total:.2f} ms):")
        spans.sort(key=lambda s: s.start_ns)
        for s in spans:
            dur = (s.end_ns - s.start_ns) / 1e6
            off = (s.start_ns - root.start_ns) / 1e6
            depth = 0
            pid = s.parent_id
            ids = {x.span_id: x for x in spans}
            while pid is not None and pid in ids:
                depth += 1
                pid = ids[pid].parent_id
            print(f"  {off:7.2f} +{dur:7.2f} ms  {'  ' * depth}{s.name}"
                  f" {dict(list(s.attrs.items())[:2])}")

        # aggregate: average time per span name across all puts
        agg = defaultdict(float)
        cnt = defaultdict(int)
        for _root, spans in put_traces:
            for s in spans:
                agg[s.name] += (s.end_ns - s.start_ns) / 1e6
                cnt[s.name] += 1
        print("\nper-stage mean over all puts:")
        for name in sorted(agg, key=agg.get, reverse=True):
            print(f"  {agg[name] / len(put_traces):7.2f} ms  "
                  f"(x{cnt[name] / len(put_traces):.1f}/put)  {name}")

        await server.stop()
        await g.shutdown()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    asyncio.run(main())
