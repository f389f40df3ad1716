"""Export a node's device/transport pipeline timeline as Chrome-trace JSON.

    python -m garage_tpu_torch.tools.device_timeline [-c CONFIG]
        [-o OUT.json] [-n LIMIT] [--drive N]

The port's ``scripts/device_timeline.py``: pulls the bounded timeline ring
(``utils/timeline.py``, fed by the codec feeder and the device transport)
from a running node over the admin RPC (``cli.AdminClient``) and writes
catapult JSON for chrome://tracing or https://ui.perfetto.dev.  The
config defaults to node 0 of the dev cluster (``tools/dev_cluster.sh``).

``--drive N`` first performs N concurrent 1 MiB S3 PUTs against the node
so the exported window is non-empty (needs GARAGE_TPU_KEY_ID and
GARAGE_TPU_SECRET of a key allowed to create a bucket).  Prints one JSON
line: the events written, by category; exits non-zero when the window
is empty.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys

from ..testing.s3_client import S3Client
from .dev import base_dir


async def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config",
                    default=str(base_dir() / "node0" / "garage.toml"))
    ap.add_argument("-o", "--out", default="device_timeline.json")
    ap.add_argument("-n", "--limit", type=int, default=None)
    ap.add_argument("--drive", type=int, default=0,
                    help="run N concurrent 1 MiB PUTs first so the "
                         "window is non-empty")
    args = ap.parse_args(argv)

    if args.drive:
        kid = os.environ.get("GARAGE_TPU_KEY_ID")
        sec = os.environ.get("GARAGE_TPU_SECRET")
        if not (kid and sec):
            print("--drive needs GARAGE_TPU_KEY_ID/GARAGE_TPU_SECRET",
                  file=sys.stderr)
            return 2
        import aiohttp

        from ..utils.config import read_config

        port = int(read_config(args.config).s3_api_bind_addr.rsplit(":", 1)[1])
        sem = asyncio.Semaphore(8)

        async def put(c, i):
            async with sem:
                st, _b, _h = await c.req(
                    "PUT", f"/timelinebkt/obj-{i}", body=os.urandom(1 << 20))
                assert st == 200, st

        async with aiohttp.ClientSession() as session:
            c = S3Client(session, port, kid, sec)
            await c.req("PUT", "/timelinebkt")
            await asyncio.gather(*[put(c, i) for i in range(args.drive)])

    from ..cli import AdminClient

    client = AdminClient(args.config, None)
    msg = {"cmd": "device_timeline"}
    if args.limit:
        msg["limit"] = args.limit
    chrome = await client.call(msg)
    events = [e for e in chrome["traceEvents"] if e.get("ph") != "M"]
    with open(args.out, "w") as f:
        json.dump(chrome, f)
    by_cat = {}
    for e in events:
        by_cat[e.get("cat", "")] = by_cat.get(e.get("cat", ""), 0) + 1
    print(f"wrote {len(events)} events to {args.out} "
          f"(open in chrome://tracing or https://ui.perfetto.dev)",
          file=sys.stderr)
    print(json.dumps({"tool": "device_timeline", "out": args.out,
                      "events": len(events), "by_cat": by_cat}))
    return 0 if events else 1


if __name__ == "__main__":
    sys.exit(asyncio.run(main()))
