"""A deployment's nodes as ``Garage`` objects in this process.

Each node is the object the daemon builds (``Garage(config)``), from the
configuration file's keys plus its own directories, dialled to the
others on loopback, with the layout applied and its background workers
running, as the daemon's start-up leaves it.
"""

from __future__ import annotations

from pathlib import Path
from typing import List


def node_config(cfg: dict, root: Path, i: int) -> dict:
    d = dict(cfg["garage"])
    d.update(metadata_dir=str(root / f"n{i}" / "meta"),
             data_dir=str(root / f"n{i}" / "data"),
             rpc_bind_addr="127.0.0.1:0", rpc_secret="benchmark",
             bootstrap_peers=[])
    return d


async def start(cfg: dict, root: Path, device: str = "cuda") -> List:
    from garage_tpu_torch.model import Garage
    from garage_tpu_torch.rpc.layout import ClusterLayout, NodeRole
    from garage_tpu_torch.utils.config import config_from_dict

    n = int(cfg["nodes"])
    nodes = [Garage(config_from_dict(node_config(cfg, root, i)), device=device)
             for i in range(n)]
    for g in nodes:
        await g.system.netapp.listen("127.0.0.1:0")
    ports = [g.system.netapp._server.sockets[0].getsockname()[1] for g in nodes]
    for i, a in enumerate(nodes):
        for j, b in enumerate(nodes):
            if i < j:
                await a.system.netapp.connect(f"127.0.0.1:{ports[j]}",
                                              expected_id=b.system.id)
        a.system.config.rpc_public_addr = f"127.0.0.1:{ports[i]}"
    lay = nodes[0].system.layout
    for g in nodes:
        lay.stage_role(bytes(g.system.id), NodeRole("dc1", 1000))
    lay.apply_staged_changes()
    enc = lay.encode()
    for g in nodes:
        g.system.layout = ClusterLayout.decode(enc)
        g.system._rebuild_ring()
        g.system.save_layout()
        g.spawn_workers()
    return nodes


async def stop(nodes: List) -> None:
    for g in nodes:
        await g.shutdown()
