"""In-process Garage clusters for the operator tools.

The port's copy of the reference harness's cluster builder
(``bench._mk_cluster``): n ``Garage`` nodes in this process, dialled to
each other on loopback, with an applied layout and one S3 server on node
0.  ``tools/chaos.py``, ``tools/put_trace.py``, ``tools/put_concurrency.py``
and ``tools/profile_dataplane.py`` run on it.  Each node's codec is built
on ``device``: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from pathlib import Path


async def mk_cluster(tmp, n=1, repl="none", codec_cfg=None, quotas=None,
                     data_repl=None, db="native", wan_delay=None,
                     proxies_out=None, rpc_cfg=None, api_cfg=None,
                     health_cfg=None, device="cuda"):
    """n in-process Garage daemons with an applied layout + one S3 server
    on node 0; returns (garages, server, port, key_id, secret).

    `quotas` is accepted for the reference's signature and unused, as
    there.  With `wan_delay` every peer link runs through a LatencyProxy
    (appended to `proxies_out` when given)."""
    from ..api.s3.api_server import S3ApiServer
    from ..model import Garage
    from ..rpc.layout import ClusterLayout, NodeRole
    from ..utils.config import config_from_dict

    tmp = Path(tmp)
    garages = []
    for i in range(n):
        cfg = {
            "metadata_dir": str(tmp / f"n{i}" / "meta"),
            "data_dir": str(tmp / f"n{i}" / "data"),
            "replication_mode": repl,
            "rpc_bind_addr": "127.0.0.1:0",
            "rpc_secret": "bench",
            "db_engine": db,
            "bootstrap_peers": [],
        }
        if data_repl is not None:
            cfg["data_replication_mode"] = data_repl
        if codec_cfg:
            cfg["codec"] = dict(codec_cfg)
        if rpc_cfg:
            cfg["rpc"] = dict(rpc_cfg)
        if api_cfg:
            cfg["api"] = dict(api_cfg)
        if health_cfg:
            cfg["health"] = dict(health_cfg)
        garages.append(Garage(config_from_dict(cfg), device=device))
    for g in garages:
        await g.system.netapp.listen("127.0.0.1:0")
    ports = [g.system.netapp._server.sockets[0].getsockname()[1]
             for g in garages]
    for i, a in enumerate(garages):
        for j, b in enumerate(garages):
            if i == j:
                continue
            target = ports[j]
            if wan_delay:
                from ..net.latency_proxy import LatencyProxy

                proxy = LatencyProxy("127.0.0.1", ports[j], wan_delay)
                target = await proxy.start()
                if proxies_out is not None:
                    proxies_out.append(proxy)
                # reconnects must keep the latency: remember proxy addrs
                a.system.peering.add_peer(
                    f"127.0.0.1:{target}", b.system.id)
            if i < j:
                await a.system.netapp.connect(
                    f"127.0.0.1:{target}", expected_id=b.system.id)
        a.system.config.rpc_public_addr = f"127.0.0.1:{ports[i]}"
    lay = garages[0].system.layout
    for g in garages:
        lay.stage_role(bytes(g.system.id), NodeRole("dc1", 1000))
    lay.apply_staged_changes()
    enc = lay.encode()
    for g in garages:
        g.system.layout = ClusterLayout.decode(enc)
        g.system._rebuild_ring()
        # persist as the product update path would: a restarted node
        # must find the applied layout on disk, not come up ringless
        g.system.save_layout()
        g.spawn_workers()

    helper = garages[0].helper()
    key = await helper.create_key("bench")
    key.params().allow_create_bucket.update(True)
    await garages[0].key_table.insert(key)
    server = S3ApiServer(garages[0])
    await server.start("127.0.0.1:0")
    return garages, server, server.port, key.key_id, key.params().secret_key
