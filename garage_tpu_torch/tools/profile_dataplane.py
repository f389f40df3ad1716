"""Python data-plane profile.

    python -m garage_tpu_torch.tools.profile_dataplane

The port's ``scripts/profile_dataplane.py`` (SURVEY §2.11 items 5-10).
Runs the streaming multipart path — the framework's highest-byte-rate
surface: HTTP body → SigV4 streaming verify → chunker → block RPC over
the netapp transport → digests → disk — on an in-process 2-node
cluster (so every block crosses the REAL frame pump once), under
cProfile, and attributes cumulative CPU to subsystems:

  pump     net/netapp.py + net/frame.py (the asyncio transport pump)
  chunker  api/s3/put.py + api/signature.py (body walk + SigV4)
  digests  hashlib / native blake2s (via ops/)
  disk     direct_io + os-level write/read
  meta     db/ + table/ (metadata quorum work)
  asyncio  stdlib asyncio machinery
  other    everything else (http parse, numpy, ...)

Answers: is the Python frame pump the throughput cap?  Prints one JSON
line with the shares + the measured MiB/s; the conclusion lives in
docs/DATAPLANE_PROFILE.md.
"""

import asyncio
import cProfile
import io
import json
import pstats
import time

import numpy as np

from ..testing.cluster import mk_cluster
from ..testing.s3_client import S3Client

BLOCK = 1 << 20
PART = 32 << 20
N_PARTS = 24   # 768 MiB through the full stack


async def drive() -> float:
    import pathlib
    import shutil
    import tempfile

    import aiohttp

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="profile_dp_"))
    try:
        # 2 nodes, 2 replicas: every block leaves the gateway through
        # the netapp frame pump to the peer (plus a local write)
        garages, server, port, kid, secret = await mk_cluster(
            tmp, n=2, repl="2", codec_cfg={"backend": "cpu"})
        rng = np.random.default_rng(9)
        base = rng.integers(0, 256, PART, dtype=np.uint8)
        async with aiohttp.ClientSession() as session:
            s3 = S3Client(session, port, kid, secret)
            st, _b, _h = await s3.req("PUT", "/pbkt")
            assert st == 200
            st, body, _h = await s3.req("POST", "/pbkt/big",
                                        query=[("uploads", "")])
            assert st == 200
            uid = body.split(b"<UploadId>")[1].split(
                b"</UploadId>")[0].decode()
            etags = []
            t0 = time.perf_counter()
            for pn in range(1, N_PARTS + 1):
                base[::BLOCK] = pn & 0xFF
                base[1::BLOCK] = (pn >> 8) & 0xFF
                st, _b, hdrs = await s3.req(
                    "PUT", "/pbkt/big", base.tobytes(),
                    query=[("partNumber", str(pn)), ("uploadId", uid)])
                assert st == 200, st
                etags.append(hdrs.get("ETag"))
            dt = time.perf_counter() - t0
            xml = "<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{i + 1}</PartNumber>"
                f"<ETag>{e}</ETag></Part>"
                for i, e in enumerate(etags)) + \
                "</CompleteMultipartUpload>"
            st, _b, _h = await s3.req(
                "POST", "/pbkt/big", xml.encode(),
                query=[("uploadId", uid)])
            assert st == 200
        await server.stop()
        for g in garages:
            await g.shutdown()
        return N_PARTS * PART / dt / 2**20
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


GROUPS = {
    "pump": ("net/netapp.py", "net/frame.py", "net/latency_proxy.py"),
    "chunker+sigv4": ("api/s3/put.py", "api/signature.py",
                      "api/common.py"),
    "digests": ("hashlib", "ops/native.py", "ops/cpu_codec.py",
                "utils/data.py", "utils/async_hash.py"),
    "disk": ("utils/direct_io.py", "block/manager.py", "block/layout.py"),
    "meta": ("db/", "table/", "model/"),
    "asyncio": ("asyncio/", "selectors.py", "concurrent/futures"),
    "http": ("aiohttp", "api/s3/router.py", "api/admin_server.py",
             "web/"),
}


def main():
    prof = cProfile.Profile()
    prof.enable()
    mibs = asyncio.run(drive())
    prof.disable()

    st = pstats.Stats(prof, stream=io.StringIO())
    total_tt = 0.0
    shares = {k: 0.0 for k in GROUPS}
    shares["other"] = 0.0
    for (fname, _line, _fn), (cc, nc, tt, ct, callers) in \
            st.stats.items():
        total_tt += tt
        for group, pats in GROUPS.items():
            if any(p in fname for p in pats):
                shares[group] += tt
                break
        else:
            shares["other"] += tt
    out = {"mp_profile_mibs": round(mibs, 1),
           "profiled_cpu_s": round(total_tt, 2)}
    for k, v in shares.items():
        out[f"share_{k}"] = round(v / total_tt, 4) if total_tt else 0.0
    print(json.dumps(out))

    # top offenders for the doc
    st2 = pstats.Stats(prof)
    st2.sort_stats("tottime")
    st2.print_stats(22)


if __name__ == "__main__":
    main()
