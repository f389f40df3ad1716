"""Capture (or list) incident flight-recorder bundles on a running node.

    python -m garage_tpu_torch.tools.incident_dump [-c CONFIG]
        [--rpc-host HOST:PORT] [--reason WHY] [--list] [-o bundle.json]

The port's ``scripts/incident_dump.py``.  One call snapshots everything an
incident post-mortem needs while the evidence still exists: metrics,
retained waterfalls, the device timeline, breaker/disk/governor/peer
state, recent gate events, SLO budgets (``utils/flightrec.py``), through
the admin RPC (``cli.AdminClient``).  The daemon also captures on its
own, debounced, on fast-burn SLO breaches, fail-slow flag transitions and
disk/cluster degradation; this is the operator's manual trigger and the
way to pull the listing.  The config defaults to node 0 of the dev
cluster (``tools/dev_cluster.sh``).  Exits non-zero when a section's
collector failed.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import shutil
import sys

from .dev import base_dir


async def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config",
                    default=str(base_dir() / "node0" / "garage.toml"))
    ap.add_argument("--rpc-host", default=None)
    ap.add_argument("--reason", default="operator")
    ap.add_argument("--list", action="store_true",
                    help="list retained bundles instead of capturing")
    ap.add_argument("-o", "--out", default=None,
                    help="copy the captured bundle to this path")
    args = ap.parse_args(argv)

    from ..cli import AdminClient

    client = AdminClient(args.config, args.rpc_host)
    if args.list:
        bundles = await client.call({"cmd": "incident_list"})
        for b in bundles:
            print(f"{b.get('captured_at')}\t{b.get('trigger')}\t"
                  f"{b.get('reason')}\t{b['path']}")
        print(f"{len(bundles)} bundle(s) retained")
        return 0
    out = await client.call({"cmd": "incident_capture",
                             "reason": args.reason})
    path = out["path"]
    with open(path) as f:
        bundle = json.load(f)
    sections = bundle.get("sections", {})
    broken = [k for k, v in sections.items()
              if isinstance(v, dict) and "error" in v]
    print(f"bundle written: {path}")
    print(f"sections: {', '.join(sorted(sections))}")
    if broken:
        print(f"collector errors: {broken}", file=sys.stderr)
    if args.out:
        shutil.copyfile(path, args.out)
        print(f"copied to {args.out}")
    return 1 if broken else 0


if __name__ == "__main__":
    sys.exit(asyncio.run(main()))
