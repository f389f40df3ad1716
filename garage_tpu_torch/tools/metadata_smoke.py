"""Metadata-plane smoke against the running dev cluster.

    python -m garage_tpu_torch.tools.metadata_smoke

The port's ``scripts/metadata_smoke.py``, run by ``tools/test_smoke.sh``
after ``tools/smoke.py`` against the cluster ``tools/dev_cluster.sh``
starts (ports from its node configs, ``tools/dev.py``): load 5,000
objects live through the three gateways at 16-way concurrency, every
node's listing of the bucket agrees (order-identical, sharded fan-out
on), ``table_merkle_todo`` drains to 0 on all nodes (the batched Merkle
updater keeping up), and the metadata families render promlint-clean.
Prints one JSON line with the load's and the drain's seconds; any failed
check exits non-zero.
"""

from __future__ import annotations

import asyncio
import json
import time
import xml.etree.ElementTree as ET

from ..utils.promlint import lint_exposition
from .dev import DevCluster

N_OBJECTS = 5000
CONCURRENCY = 16

NEW_FAMILIES = (
    "merkle_batch_items", "merkle_batch_nodes_total",
    "merkle_batch_hash_total", "table_scan_pages_total",
    "table_scan_rows_total", "api_list_pages",
)


def _metric_values(body: str, family: str) -> list:
    out = []
    for line in body.splitlines():
        if line.startswith(family) and not line.startswith("#"):
            out.append(float(line.rsplit(None, 1)[-1]))
    return out


async def main() -> dict:
    import aiohttp

    async with aiohttp.ClientSession() as session:
        return await run(session)


async def run(session) -> dict:
    import aiohttp

    dev = DevCluster()
    cli = dev.cli
    ADMIN_PORTS = dev.admin_ports
    kid, sec = dev.create_key("metasmoke-key")
    cli("bucket", "create", "metasmoke")
    cli("bucket", "allow", "metasmoke", "--key", kid,
        "--read", "--write", "--owner")
    nodes = [dev.s3(i, kid, sec, session)
             for i in range(len(dev.s3_ports))]

    # 1. load 5k tiny objects live, spread across the 3 gateways
    t0 = time.time()
    sem = asyncio.Semaphore(CONCURRENCY)
    errors = []

    async def put(i):
        async with sem:
            key = f"d{i % 40:02d}/obj{i:05d}"
            st, body, _h = await nodes[i % 3].req(
                "PUT", f"/metasmoke/{key}", body=b"m" * 32)
            if st != 200:
                errors.append((key, st, body[:200]))

    await asyncio.gather(*[put(i) for i in range(N_OBJECTS)])
    assert not errors, errors[:3]
    load_s = time.time() - t0
    print(f"smoke-meta: loaded {N_OBJECTS} objects in {load_s:.1f}s")

    # 2. listing against all 3 nodes agrees, walked to completion
    async def list_all(node):
        keys, token = [], None
        while True:
            q = [("list-type", "2"), ("max-keys", "1000")]
            if token is not None:
                q.append(("continuation-token", token))
            st, body, _h = await node.req("GET", "/metasmoke", query=q)
            assert st == 200, body[:300]
            root = ET.fromstring(body)
            ns = root.tag.split("}")[0] + "}" if "}" in root.tag else ""
            keys += [c.findtext(f"{ns}Key")
                     for c in root.findall(f"{ns}Contents")]
            token = root.findtext(f"{ns}NextContinuationToken")
            if root.findtext(f"{ns}IsTruncated") != "true":
                return keys

    t1 = time.time()
    listings = await asyncio.gather(*[list_all(n) for n in nodes])
    assert listings[0] == listings[1] == listings[2], (
        "listings disagree across nodes",
        [len(l) for l in listings])
    assert len(listings[0]) == N_OBJECTS
    assert listings[0] == sorted(listings[0])
    list_s = time.time() - t1
    print(f"smoke-meta: listing agrees on all 3 nodes "
          f"({len(listings[0])} keys, ordered)")
    t2 = time.time()

    # 3. table_merkle_todo drains to 0 everywhere; new families linted
    async with aiohttp.ClientSession() as s:
        deadline = time.time() + 120
        while True:
            bodies = {}
            for port in ADMIN_PORTS:
                async with s.get(
                        f"http://127.0.0.1:{port}/metrics") as r:
                    assert r.status == 200, (port, r.status)
                    bodies[port] = await r.text()
            todo = {p: sum(_metric_values(b, "table_merkle_todo{"))
                    for p, b in bodies.items()}
            if all(v == 0 for v in todo.values()):
                break
            assert time.time() < deadline, (
                f"table_merkle_todo did not drain: {todo}")
            await asyncio.sleep(0.5)
        drain_s = time.time() - t2
        print("smoke-meta: table_merkle_todo drained to 0 on all nodes")
        for port, body in bodies.items():
            problems = lint_exposition(body)
            assert not problems, (port, problems)
        # batched paths actually ran on the gateway that served listings
        gw = bodies[ADMIN_PORTS[0]]
        for fam in NEW_FAMILIES:
            assert fam in gw, f"family {fam} missing on :{ADMIN_PORTS[0]}"
        assert sum(_metric_values(gw, "merkle_batch_nodes_total")) > 0
    print("smoke-meta: new metadata families present + promlint clean")
    print("METADATA SMOKE OK")
    return {"tool": "metadata_smoke", "ok": True, "objects": N_OBJECTS,
            "load_s": load_s, "list_s": list_s, "merkle_drain_s": drain_s}


if __name__ == "__main__":
    print(json.dumps(asyncio.run(main())))
