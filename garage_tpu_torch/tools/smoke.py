"""S3 smoke flows against the running dev cluster.

    python -m garage_tpu_torch.tools.smoke

The port's ``scripts/smoke.py`` (the equivalent of the upstream
script/test-smoke.sh, which drives aws-cli/s3cmd/mc through
upload/download/diff, multipart with out-of-order + skipped part numbers,
and website checks), run by ``tools/test_smoke.sh`` against the cluster
``tools/dev_cluster.sh`` starts; the ports come from its node configs
(``tools/dev.py``).  Writes go to one node and reads to another, so every
flow crosses the quorum/replication path, not just local state.  Nine
steps: put/get/diff at six sizes, multipart, list pagination, website,
deletes, the exposition lint on every node, the codec feeder under
concurrent PUTs, a live request waterfall with the metrics-docs lint, and
the SLO status with an incident bundle from every node.  Prints one JSON
line with each step's seconds; any failed check exits non-zero.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import os
import time
import xml.etree.ElementTree as ET

from ..utils.metricsdoc import undocumented_families
from ..utils.promlint import lint_exposition
from ..utils.waterfall import SEGMENTS
from .dev import REPO, DevCluster


async def main() -> dict:
    import aiohttp

    async with aiohttp.ClientSession() as session:
        return await run(session)


async def run(session) -> dict:
    import aiohttp

    dev = DevCluster()
    cli = dev.cli
    S3_PORTS, ADMIN_PORTS = dev.s3_ports, dev.admin_ports
    WEB_PORT = dev.web_ports[0]
    steps = {}
    t_step = time.perf_counter()

    def done(step: str) -> None:
        nonlocal t_step
        now = time.perf_counter()
        steps[step] = now - t_step
        t_step = now

    kid, sec = dev.create_key("smoke-key")
    cli("bucket", "create", "smoke")
    cli("bucket", "allow", "smoke", "--key", kid,
        "--read", "--write", "--owner")
    cli("bucket", "website", "smoke", "--allow")
    nodes = [dev.s3(i, kid, sec, session) for i in range(len(S3_PORTS))]
    done("configure")

    # 1. put/get/diff across nodes, several sizes (incl. inline + multi-block)
    for i, size in enumerate([1, 1024, 3071, 3072, 1 << 20, (5 << 20) + 17]):
        data = os.urandom(size)
        put_node, get_node = nodes[i % 3], nodes[(i + 1) % 3]
        st, _, _ = await put_node.req("PUT", f"/smoke/size-{size}", body=data)
        assert st == 200, (size, st)
        st, got, _ = await get_node.req("GET", f"/smoke/size-{size}")
        assert st == 200 and got == data, f"diff mismatch at size {size}"
    print("put/get/diff ok (6 sizes × cross-node)")
    done("put_get")

    # 2. multipart: out-of-order upload + skipped part numbers (the
    # reference smoke's signature case)
    c = nodes[0]
    st, body, _ = await c.req("POST", "/smoke/mpu.bin",
                              query=[("uploads", "")])
    assert st == 200, st
    upload_id = body.decode().split("<UploadId>")[1].split("</UploadId>")[0]
    parts = {1: os.urandom(5 << 20), 4: os.urandom(5 << 20),
             7: os.urandom(123)}   # skipped + out-of-order part numbers
    etags = {}
    for pn in (4, 1, 7):  # upload out of order
        st, _, hdrs = await nodes[pn % 3].req(
            "PUT", "/smoke/mpu.bin",
            query=[("partNumber", str(pn)), ("uploadId", upload_id)],
            body=parts[pn])
        assert st == 200, (pn, st)
        etags[pn] = hdrs["ETag"]
    complete = "<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{pn}</PartNumber><ETag>{etags[pn]}</ETag></Part>"
        for pn in sorted(parts)) + "</CompleteMultipartUpload>"
    st, _, _ = await c.req("POST", "/smoke/mpu.bin",
                           query=[("uploadId", upload_id)],
                           body=complete.encode())
    assert st == 200, st
    want = parts[1] + parts[4] + parts[7]
    st, got, _ = await nodes[2].req("GET", "/smoke/mpu.bin")
    assert st == 200 and got == want, "multipart content mismatch"
    # ranged read across a part boundary
    st, got, _ = await c.req(
        "GET", "/smoke/mpu.bin",
        headers={"range": f"bytes={(5 << 20) - 100}-{(5 << 20) + 99}"})
    assert st == 206 and got == want[(5 << 20) - 100:(5 << 20) + 100]
    print("multipart out-of-order + skipped parts + ranged read ok")
    done("multipart")

    # 3. list with prefix/delimiter pagination
    for i in range(12):
        st, _, _ = await c.req("PUT", f"/smoke/dir{i % 3}/f{i}", body=b"x")
        assert st == 200
    st, body, _ = await c.req("GET", "/smoke", query=[
        ("delimiter", "/"), ("max-keys", "2")])
    root = ET.fromstring(body)
    ns = root.tag[:root.tag.index("}") + 1]
    assert root.findtext(f"{ns}IsTruncated") == "true"
    print("list pagination ok")
    done("list")

    # 4. website through the web port
    st, _, _ = await c.req("PUT", "/smoke/index.html", body=b"<h1>smoke</h1>")
    assert st == 200
    async with aiohttp.ClientSession() as s:
        async with s.get(f"http://127.0.0.1:{WEB_PORT}/",
                         headers={"Host": "smoke.web.garage.localhost"}) as r:
            assert r.status == 200
            assert await r.read() == b"<h1>smoke</h1>"
    print("website ok")
    done("website")

    # 5. delete + verify 404, then DeleteObjects batch
    st, _, _ = await c.req("DELETE", "/smoke/size-1")
    assert st == 204, st
    st, _, _ = await nodes[1].req("GET", "/smoke/size-1")
    assert st == 404
    dx = ("<Delete>" + "".join(
        f"<Object><Key>dir{i % 3}/f{i}</Key></Object>" for i in range(12))
        + "</Delete>")
    body_b = dx.encode()
    md5 = hashlib.md5(body_b).digest()
    st, _, _ = await c.req("POST", "/smoke", query=[("delete", "")],
                           body=body_b,
                           headers={"content-md5":
                                    base64.b64encode(md5).decode()})
    assert st == 200, st
    print("delete + batch delete ok")
    done("delete")

    # 6. strict Prometheus exposition lint on every node's live /metrics
    # (the registry IS the exporter — a malformed scrape body takes the
    # whole node's telemetry dark at ingest), plus presence checks for
    # the control-plane families this smoke run must have populated
    async with aiohttp.ClientSession() as s:
        for port in ADMIN_PORTS:
            async with s.get(f"http://127.0.0.1:{port}/metrics") as r:
                assert r.status == 200, (port, r.status)
                body = await r.text()
            problems = lint_exposition(body)
            assert not problems, f"/metrics on :{port} fails lint: {problems}"
            for fam in ("net_peer_tx_bytes_total", "worker_state",
                        "peer_rtt_ewma_seconds", "rpc_request_counter",
                        "peer_breaker_state", "rpc_retry_total",
                        "rpc_hedge_total", "disk_root_state",
                        "disk_free_bytes", "disk_error_total",
                        "block_quarantine_total"):
                assert fam in body, f"family {fam} missing on :{port}"
    print("metrics exposition lint ok (3 nodes)")
    done("metrics_lint")

    # 7. codec feeder smoke: 16 puts at 8 in flight through
    # one live gateway must ride the continuous-batching feeder — zero
    # client errors, and that node's /metrics afterwards shows nonzero
    # codec_batch_* activity and still passes the strict lint
    payloads = [os.urandom(1 << 20) for _ in range(16)]
    sem = asyncio.Semaphore(8)
    errors = 0

    async def feeder_put(i):
        nonlocal errors
        async with sem:
            st, _, _ = await c.req("PUT", f"/smoke/feeder-{i}",
                                   body=payloads[i])
            if st != 200:
                errors += 1

    await asyncio.gather(*[feeder_put(i) for i in range(len(payloads))])
    assert errors == 0, f"{errors} client errors through the feeder"
    async with aiohttp.ClientSession() as s:
        async with s.get(f"http://127.0.0.1:{ADMIN_PORTS[0]}/metrics") as r:
            assert r.status == 200
            body = await r.text()
    problems = lint_exposition(body)
    assert not problems, f"feeder metrics fail lint: {problems}"
    for fam in ("codec_feeder_depth", "codec_batch_wait_seconds",
                "codec_batch_size", "codec_batch_dispatch_total",
                "codec_batch_submit_total"):
        assert fam in body, f"feeder family {fam} missing on gateway"
    dispatches = sum(
        float(line.rsplit(" ", 1)[1])
        for line in body.splitlines()
        if line.startswith("codec_batch_dispatch_total{"))
    assert dispatches > 0, "feeder never dispatched on the gateway node"
    print(f"feeder smoke ok (16 puts @8 conc, "
          f"{int(dispatches)} ragged dispatches)")
    done("feeder")

    # 8. critical-path attribution smoke: the concurrent PUTs
    # above were sampled by the gateway's waterfall recorder — pull a
    # live waterfall through the CLI, assert the dominant segment is a
    # known taxonomy value and the segments sum to the request duration
    # (within 10%), export a non-empty chrome trace, and check every
    # live family has a docs/OBSERVABILITY.md row
    _json = json
    listing = _json.loads(cli("request", "waterfall", "--json"))
    puts = [e for e in listing["retained"] if e["endpoint"] == "PutObject"]
    assert puts, f"no retained PutObject waterfall: {listing['endpoints']}"
    wf = _json.loads(cli("request", "waterfall", "--trace",
                         puts[0]["trace_id"], "--json"))
    assert wf["dominant"] in SEGMENTS, wf["dominant"]
    seg_sum = sum(wf["segments"].values())
    assert abs(seg_sum - wf["seconds"]) <= 0.1 * wf["seconds"], \
        (seg_sum, wf["seconds"])
    assert wf["span_count"] >= 3, wf
    chrome = _json.loads(cli("timeline"))
    n_events = sum(1 for e in chrome["traceEvents"] if e.get("ph") != "M")
    assert n_events > 0, "empty chrome-trace export on the gateway"
    doc = (REPO / "docs" / "OBSERVABILITY.md").read_text()
    bodies = {}
    async with aiohttp.ClientSession() as s:
        for port in ADMIN_PORTS:
            async with s.get(f"http://127.0.0.1:{port}/metrics") as r:
                assert r.status == 200
                bodies[port] = await r.text()
            assert not lint_exposition(bodies[port]), port
            missing = undocumented_families(bodies[port], doc)
            assert not missing, f":{port} undocumented families: {missing}"
    assert "request_critical_path_seconds" in bodies[ADMIN_PORTS[0]]
    print(f"critical-path smoke ok (PutObject dominant={wf['dominant']}, "
          f"{wf['span_count']} spans, segments sum "
          f"{seg_sum * 1000:.1f}ms of {wf['seconds'] * 1000:.1f}ms, "
          f"{n_events} timeline events, docs lint clean on 3 nodes)")
    done("waterfall")

    # 9. fleet health & SLOs: the traffic above must have
    # populated the gateway's SLO tracker — `slo status` shows a
    # PutObject budget row with its budget intact — and a manual
    # incident capture on ALL 3 live nodes must produce a
    # schema-checked bundle whose core sections collected cleanly
    slo = _json.loads(cli("slo", "status", "--json"))
    eps = {r["endpoint"] for r in slo["rows"]}
    assert "PutObject" in eps and "GetObject" in eps, eps
    put_av = next(r for r in slo["rows"]
                  if r["endpoint"] == "PutObject"
                  and r["slo"] == "availability")
    assert put_av["events"] > 0, put_av
    assert put_av["budget_remaining"] > 0.5, \
        f"smoke burned the PutObject budget: {put_av}"
    rpc_hosts = (None, *dev.rpc_addrs[1:])
    core = {"metrics", "slo", "peers", "governor", "disk",
            "waterfalls", "device_timeline", "cluster_health"}
    for host in rpc_hosts:
        host_args = () if host is None else ("--rpc-host", host)
        out = cli(*host_args, "incident", "capture",
                  "--reason", "smoke-step9")
        path = out.split("bundle written:")[1].strip()
        with open(path) as f:
            bundle = _json.load(f)
        assert bundle["schema"] == "garage_tpu.incident/1", bundle["schema"]
        assert bundle["trigger"] == "manual" and bundle["reason"] == \
            "smoke-step9", (bundle["trigger"], bundle["reason"])
        missing = core - set(bundle["sections"])
        assert not missing, f"bundle on {host or 'node0'} missing {missing}"
        broken = {k for k in core
                  if isinstance(bundle["sections"][k], dict)
                  and "error" in bundle["sections"][k]}
        assert not broken, f"collectors failed on {host or 'node0'}: " \
            f"{ {k: bundle['sections'][k] for k in broken} }"
    listing = cli("incident", "list")
    assert "smoke-step9" in listing, listing
    print(f"fleet-health smoke ok (slo rows={len(slo['rows'])}, "
          f"PutObject budget {put_av['budget_remaining'] * 100:.1f}% left, "
          f"incident bundles schema-clean on 3 nodes)")
    done("fleet_health")

    print("SMOKE OK")
    return {"tool": "smoke", "ok": True, "steps_s": steps,
            "total_s": sum(steps.values())}


if __name__ == "__main__":
    print(json.dumps(asyncio.run(main())))
