"""The port's Consul and Kubernetes peer discovery (garage_tpu_torch.rpc.
discovery) against the reference's, on the fake APIs of
tests/test_discovery.py.

Each fake records every request it serves: method, path, query, the
auth headers and the JSON body.  The same publish / query sequence
through both packages' backends must leave equal transcripts and return
equal node lists.  Then two port `System`s with no bootstrap peers find
and connect to each other through one fake Consul catalog, and a
`System` accepts a Kubernetes discovery config.
"""

import asyncio
import os
import sys

import pytest
from aiohttp import web

import garage_tpu.rpc.discovery as r_disc
import garage_tpu.utils.config as r_config
import garage_tpu_torch.rpc.discovery as p_disc
import garage_tpu_torch.utils.config as p_config

sys.path.insert(0, os.path.dirname(__file__))
from test_discovery import FakeConsul, FakeK8s, _serve  # noqa: E402

pytestmark = pytest.mark.asyncio

PKGS = {"ref": (r_disc, r_config), "port": (p_disc, p_config)}
NODES = [(bytes(range(i, i + 32)), f"host-{i}", f"10.0.{i}.5:{3901 + i}")
         for i in range(3)]


def _recorded(app):
    """Wrap a fake's app so that it logs every request it answers."""
    log = []

    @web.middleware
    async def record(request, handler):
        body = await request.read()
        log.append((request.method, request.path,
                    sorted(request.query.items()),
                    request.headers.get("x-consul-token"),
                    request.headers.get("Authorization"),
                    body.decode() if body else None))
        return await handler(request)

    app.middlewares.append(record)
    return app, log


async def consul_session(pkg, api: str) -> tuple:
    disc, config = PKGS[pkg]
    consul = FakeConsul()
    app, log = _recorded(consul.app())
    runner, port = await _serve(app)
    d = disc.ConsulDiscovery(config.ConsulDiscoveryConfig(
        consul_http_addr=f"http://127.0.0.1:{port}",
        service_name="garage-rpc", tags=["t1"], meta={"x": "y"}, api=api,
        token="tkn" if api == "agent" else None))
    seen = []
    try:
        for nid, host, addr in NODES:
            await d.publish(nid, host, addr)
            seen.append(await d.get_nodes())
        # an invalid entry is skipped by both
        consul.services["bad"] = {"ServiceName": "garage-rpc", "Address": "z",
                                  "ServicePort": 1, "ServiceMeta": {}}
        seen.append(await d.get_nodes())
    finally:
        await d.close()
        await runner.cleanup()
    return log, seen, consul.services


@pytest.mark.parametrize("api", ["catalog", "agent"])
async def test_consul_transcripts_equal_reference(api):
    ref = await consul_session("ref", api)
    port = await consul_session("port", api)
    assert port == ref
    log, seen, _services = port
    assert len(seen[-1]) == len(NODES)
    assert {n for n, _a in seen[-1]} == {nid for nid, _h, _a in NODES}
    assert [m for m, *_ in log].count("PUT") == len(NODES)


async def k8s_session(pkg) -> tuple:
    disc, config = PKGS[pkg]
    k8s = FakeK8s()
    app, log = _recorded(k8s.app())
    runner, port = await _serve(app)
    d = disc.KubernetesDiscovery(
        config.KubernetesDiscoveryConfig(namespace="storage",
                                         service_name="garage-rpc"),
        api_base=f"http://127.0.0.1:{port}", token="sa-token")
    seen = []
    try:
        await d.ensure_crd()
        for nid, host, addr in NODES:
            await d.publish(nid, host, addr)
        # republish replaces (resourceVersion round trip)
        nid, host, _addr = NODES[0]
        await d.publish(nid, host, "10.1.0.8:3901")
        seen.append(sorted(await d.get_nodes()))
        k8s.nodes["ff" * 32] = {
            "metadata": {"name": "ff" * 32,
                         "labels": {"garage.deuxfleurs.fr/service": "other"}},
            "spec": {"address": "10.9.9.9", "port": 1}}
        seen.append(sorted(await d.get_nodes()))
    finally:
        await d.close()
        await runner.cleanup()
    return log, seen, k8s.nodes, k8s.crd_created


async def test_kubernetes_transcripts_equal_reference():
    ref = await k8s_session("ref")
    port = await k8s_session("port")
    assert port == ref
    _log, seen, nodes, crd = port
    assert crd and len(nodes) == len(NODES) + 1
    assert seen[0] == seen[1] and len(seen[1]) == len(NODES)
    assert (NODES[0][0], "10.1.0.8:3901") in seen[1]


def _system_cfg(tmp_path, name, extra):
    return p_config.config_from_dict({
        "metadata_dir": str(tmp_path / name),
        "data_dir": str(tmp_path / f"{name}-data"),
        "replication_mode": "2", "rpc_bind_addr": "127.0.0.1:0",
        "rpc_secret": "disco", "bootstrap_peers": [], **extra})


async def test_two_port_systems_find_each_other_through_consul(tmp_path):
    from garage_tpu_torch.rpc.system import System

    consul = FakeConsul()
    runner, port = await _serve(consul.app())
    systems = []
    for name in ("a", "b"):
        s = System(_system_cfg(tmp_path, name, {"consul_discovery": {
            "consul_http_addr": f"http://127.0.0.1:{port}",
            "service_name": "garage-rpc"}}))
        await s.netapp.listen("127.0.0.1:0")
        s.config.rpc_public_addr = (
            f"127.0.0.1:{s.netapp._server.sockets[0].getsockname()[1]}")
        systems.append(s)
    a, b = systems
    try:
        await a._external_discovery_tick()   # a registers
        await b._external_discovery_tick()   # b registers + learns a
        await b.peering._tick()
        for _ in range(100):
            if (bytes(a.id) in {bytes(k) for k in b.peering.peers}
                    and bytes(b.id) in {bytes(k) for k in a.peering.peers}):
                break
            await asyncio.sleep(0.05)
        assert bytes(a.id) in {bytes(k) for k in b.peering.peers}
        assert bytes(b.id) in {bytes(k) for k in a.peering.peers}
        conn = b.netapp.conns.get(a.id)
        assert conn is not None and not conn._closed
        assert len(consul.services) == 2
    finally:
        for s in systems:
            for d in s._external_discovery():
                await d.close()
            await s.shutdown()
        await runner.cleanup()


async def test_system_accepts_kubernetes_discovery(tmp_path, monkeypatch):
    """A Kubernetes config builds its backend inside a pod (the service
    host from the environment; skip_crd and no call at construction),
    where the port used to refuse it."""
    from garage_tpu_torch.rpc.system import System

    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "127.0.0.1")
    s = System(_system_cfg(tmp_path, "k", {"kubernetes_discovery": {
        "namespace": "ns", "service_name": "garage-rpc", "skip_crd": True}}))
    try:
        ds = s._external_discovery()
        assert [type(d).__name__ for d in ds] == ["KubernetesDiscovery"]
    finally:
        for d in s._external_discovery():
            await d.close()
        await s.shutdown()
